// K7: assignment by the auction algorithm, one thread block per image.
//
// Replaces JAX's on-device matcher psalm_tpu/train/auction.py
// (auction_assign, :24): persons (targets) bid for objects (queries) under an
// eps-scaled price war in a lax.while_loop of at most num_iters rounds whose
// stop condition is over the whole batch (no Pallas kernel: a lax loop; in
// eager PyTorch each round would be a dozen launches and a host sync), then
// a greedy finish for persons left unassigned (:100-113).
//
// What bounds it: the rounds, each a few block-wide steps, not bytes or
// operations. So one launch runs every round of every image:
//   * the block stages value = -guard(cost) transposed to persons x objects
//     (NEG on padding persons) in shared memory, with the image's spread and
//     eps = spread x (eps_scale / (N + 1)) (the f32 constant that XLA folds
//     JAX's eps_scale * spread / (N + 1) into), padding rows included;
//   * a round: the owners give the assigned persons; each unassigned valid
//     person's warp finds its best and second-best net value over Q (lanes
//     over the objects, a butterfly of shuffles, ties to the lower object)
//     and bids (prices[best_j] + (best - second)) + eps; each object goes
//     to its highest bid, ties to the lower person id, in two shared-memory
//     passes: an atomic max of the bid as an ordered int, then an atomic min
//     of the id among the persons whose bid equals it (auction.py:60-73);
//   * a block stops at its own done or num_iters: JAX stops the batch at
//     once, but a finished image's rounds change nothing;
//   * the greedy finish runs in the same launch, on one warp.
// Sums are rounded as JAX's are (__fadd_rn and friends: nothing contracts).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace psalm {
namespace {

constexpr int kAuctionThreads = 256;
constexpr int kAuctionWarps = kAuctionThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;

// torch.nan_to_num(nan=1e8, posinf=1e8, neginf=-1e8), as train/lap.py reads
// the cost
__device__ __forceinline__ float guard(float x) {
  if (isnan(x)) return 1e8f;
  if (isinf(x)) return x > 0.f ? 1e8f : -1e8f;
  return x;
}

// A float as an int that orders as the float does (for atomicMax), and back.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Bytes of dynamic shared memory a block takes (ops:
// train/auction.py::smem_bytes).
size_t smem_layout(int N, int Q) {
  return 4 * (static_cast<size_t>(N) * Q + 4 * Q + 4 * N);
}

// cost [B, Q, N] f32; n_valid [B] int32; src [B, N] int64 (0 where not
// valid); valid [B, N] bool; steps [B] int32 or null: each image's rounds.
__global__ void __launch_bounds__(kAuctionThreads)
auction_kernel(const float* __restrict__ cost, const int* __restrict__ n_valid,
               long long* __restrict__ src_out, bool* __restrict__ valid_out,
               int* __restrict__ steps, int Q, int N, int num_iters,
               float eps_scale) {
  extern __shared__ float smem[];
  float* val = smem;  // [N][Q] persons x objects
  float* prices = val + static_cast<size_t>(N) * Q;
  int* key = reinterpret_cast<int*>(prices + Q);  // a round's best bid; taken
  int* owner = key + Q;
  int* winner = owner + Q;
  float* bid = reinterpret_cast<float*>(winner + Q);
  int* bj = reinterpret_cast<int*>(bid + N);
  int* assigned = bj + N;
  int* src = assigned + N;
  __shared__ float wmax[kAuctionWarps], wmin[kAuctionWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nv = n_valid[b];
  const float* cb = cost + static_cast<long long>(b) * Q * N;

  float vmax = -CUDART_INF_F;
  float vmin = CUDART_INF_F;
  for (int e = tid; e < Q * N; e += kAuctionThreads) {
    const int q = e / N;
    const int n = e - q * N;
    const float x = n < nv ? -guard(cb[e]) : kNeg;
    val[n * Q + q] = x;
    vmax = fmaxf(vmax, x);
    vmin = fminf(vmin, x);
  }
  for (int j = tid; j < Q; j += kAuctionThreads) {
    prices[j] = 0.f;
    owner[j] = -1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    vmax = fmaxf(vmax, __shfl_xor_sync(kFull, vmax, off));
    vmin = fminf(vmin, __shfl_xor_sync(kFull, vmin, off));
  }
  if (lane == 0) {
    wmax[warp] = vmax;
    wmin[warp] = vmin;
  }
  __syncthreads();
  for (int w = 0; w < kAuctionWarps; ++w) {
    vmax = fmaxf(vmax, wmax[w]);
    vmin = fminf(vmin, wmin[w]);
  }
  const float spread =
      fmaxf(__fsub_rn(vmax, fmaxf(vmin, kNeg * 0.5f)), 1.0f);
  const float eps =
      __fmul_rn(spread, __fdiv_rn(eps_scale, static_cast<float>(N + 1)));

  int rounds = 0;
  for (int it = 0; it < num_iters; ++it) {
    for (int r = tid; r < N; r += kAuctionThreads) assigned[r] = 0;
    __syncthreads();
    for (int j = tid; j < Q; j += kAuctionThreads) {
      const int o = owner[j];
      if (o >= 0) assigned[min(o, N - 1)] = 1;
    }
    __syncthreads();
    int open = 0;
    for (int r = tid; r < N; r += kAuctionThreads) {
      open |= r < nv && !assigned[r];
    }
    if (!__syncthreads_or(open)) break;  // every valid person holds an object
    ++rounds;
    for (int j = tid; j < Q; j += kAuctionThreads) {
      key[j] = ordered(kNeg);
      winner[j] = N;
    }
    // bids: a warp per unassigned valid person
    for (int p = warp; p < N; p += kAuctionWarps) {
      if (!(p < nv && !assigned[p])) {
        if (lane == 0) bj[p] = -1;
        continue;
      }
      const float* row = val + static_cast<size_t>(p) * Q;
      float b1 = -CUDART_INF_F;
      float s1 = -CUDART_INF_F;
      int i1 = INT_MAX;
      for (int j = lane; j < Q; j += 32) {
        const float n = __fsub_rn(row[j], prices[j]);
        if (n > b1) {
          s1 = b1;
          b1 = n;
          i1 = j;
        } else if (n > s1) {
          s1 = n;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, b1, off);
        const float os = __shfl_xor_sync(kFull, s1, off);
        const int oi = __shfl_xor_sync(kFull, i1, off);
        if (ob > b1 || (ob == b1 && oi < i1)) {
          s1 = fmaxf(os, b1);
          b1 = ob;
          i1 = oi;
        } else {
          s1 = fmaxf(s1, ob);
        }
      }
      if (lane == 0) {
        const float second = fmaxf(s1, kNeg);  // net2[best_j] = NEG
        bid[p] = __fadd_rn(__fadd_rn(prices[i1], __fsub_rn(b1, second)), eps);
        bj[p] = i1;
      }
    }
    __syncthreads();
    for (int p = tid; p < N; p += kAuctionThreads) {
      if (bj[p] >= 0) atomicMax(&key[bj[p]], ordered(bid[p]));
    }
    __syncthreads();
    for (int p = tid; p < N; p += kAuctionThreads) {
      const int j = bj[p];
      if (j >= 0) {
        const float top = unordered(key[j]);
        if (top > kNeg && bid[p] >= top) atomicMin(&winner[j], p);
      }
    }
    __syncthreads();
    for (int j = tid; j < Q; j += kAuctionThreads) {
      if (winner[j] < N) {
        owner[j] = winner[j];
        prices[j] = unordered(key[j]);
      }
    }
    __syncthreads();
  }

  // invert owner -> src, then the queries taken
  for (int r = tid; r < N; r += kAuctionThreads) src[r] = -1;
  for (int j = tid; j < Q; j += kAuctionThreads) key[j] = 0;
  __syncthreads();
  for (int j = tid; j < Q; j += kAuctionThreads) {
    const int o = owner[j];
    if (o >= 0) atomicMax(&src[min(o, N - 1)], j);
  }
  __syncthreads();
  for (int r = tid; r < N; r += kAuctionThreads) {
    const int s = src[r];
    if (s >= 0) key[min(s, Q - 1)] = 1;
  }
  __syncthreads();
  // greedy cleanup (auction.py:100-113): persons in order take their best
  // still-free query, ties to the lower query
  if (warp == 0 && Q > 0) {
    for (int i = 0; i < N; ++i) {
      if (!(src[i] < 0 && i < nv)) continue;
      const float* row = val + static_cast<size_t>(i) * Q;
      float best = -CUDART_INF_F;
      int bi = INT_MAX;
      for (int j = lane; j < Q; j += 32) {
        const float x = key[j] ? kNeg : row[j];
        if (x > best || bi == INT_MAX) {
          best = x;
          bi = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      __syncwarp();
      if (lane == 0) {
        src[i] = bi;
        key[bi] = 1;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const long long base = static_cast<long long>(b) * N;
  for (int r = tid; r < N; r += kAuctionThreads) {
    const int s = src[r];
    const bool ok = r < nv && s >= 0;
    src_out[base + r] = ok ? s : 0;
    valid_out[base + r] = ok;
  }
  if (steps != nullptr && tid == 0) steps[b] = rounds;
}

}  // namespace
}  // namespace psalm

// cost [B, Q, N] f32, contiguous; n_valid [B] int32; src [B, N] int64;
// valid [B, N] bool; steps [B] int32 or null. One block per image. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an image without queries or
// one that does not fit a block's shared memory.
extern "C" int psalm_auction_assign(const void* cost, const void* n_valid,
                                    void* src, void* valid, void* steps,
                                    int B, int Q, int N, int num_iters,
                                    float eps_scale, void* stream) {
  using namespace psalm;
  if (Q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const size_t bytes = smem_layout(N, Q);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(cudaErrorInvalidValue);
  }
  auction_kernel<<<B, kAuctionThreads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_valid),
      static_cast<long long*>(src), static_cast<bool*>(valid),
      static_cast<int*>(steps), Q, N, num_iters, eps_scale);
  return static_cast<int>(cudaGetLastError());
}
