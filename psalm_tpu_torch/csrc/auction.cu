// K7: assignment by the auction algorithm, one thread block per image.
//
// Replaces JAX's on-device matcher psalm_tpu/train/auction.py
// (auction_assign, :24): persons (targets) bid for objects (queries) under an
// eps-scaled price war in a lax.while_loop of at most num_iters rounds whose
// stop condition is over the whole batch (no Pallas kernel: a lax loop; in
// eager PyTorch each round would be a dozen launches and a host sync), then
// a greedy finish for persons left unassigned (:100-113).
//
// What bounds it: the rounds, a chain of up to num_iters sequential steps,
// not bytes or operations. So one launch runs every round of every image,
// and a round is made to wait as little as it can:
//   * the block, 32 x min(N, 32) threads (a warp a person up to 32
//     persons), stages value = -guard(cost), 4 loads in flight a thread,
//     transposed to persons x objects (NEG on padding persons) in shared
//     memory, with the image's spread and eps = spread x (eps_scale /
//     (N + 1)) (the f32 constant that XLA folds JAX's eps_scale * spread /
//     (N + 1) into), padding rows included;
//   * a round has two block-wide barriers. Bids: each unassigned valid
//     person's warp takes its best and second-best net value over Q (lane l
//     over the objects l, l + 32, ..., C of them in registers: the kernel
//     is instantiated for C = 1, 2, 4, ..., 512, its loops unrolled up to
//     C = 32; then three redux.sync on ordered-int keys: the maximum, the
//     lowest object that holds it, the maximum of the rest); the lane of
//     best_j bids (prices[best_j] + (best - second)) + eps and, if the bid
//     is above NEG, sends one 64-bit atomicMax of the key (ordered bid << 32 |
//     N - 1 - p) to the object: the largest key is the highest bid, ties to
//     the lower person id (auction.py:60-73). Barrier. Update: each object
//     with a bid takes its winner and price from the key, clears its old
//     owner's `assigned` and sets the winner's (no two writes meet: a person
//     owns at most one object, and an assigned person never bids), resets
//     the key; the barrier that ends the pass (__syncthreads_count) counts
//     the persons newly placed, and the block stops when none is open;
//   * a block stops at its own done or num_iters: JAX stops the batch at
//     once, but a finished image's rounds change nothing;
//   * the greedy finish runs in the same launch, on one warp, each argmax
//     by two redux.sync.
// Keys are taken of x + 0.0f, so -0.0 and +0.0, equal as floats, have one
// key, as they are one value to the plain version's max and argmax. Sums are
// rounded as JAX's are (__fadd_rn and friends: nothing contracts).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace psalm {
namespace {

constexpr int kAuctionMaxWarps = 32;
constexpr int kAuctionMaxColumns = 512;  // objects a lane: Q <= 16384
constexpr int kStageLoads = 4;  // loads in flight a thread while staging
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;

// torch.nan_to_num(nan=1e8, posinf=1e8, neginf=-1e8), as train/lap.py reads
// the cost
__device__ __forceinline__ float guard(float x) {
  if (isnan(x)) return 1e8f;
  if (isinf(x)) return x > 0.f ? 1e8f : -1e8f;
  return x;
}

// A float as an int that orders as the float does, and back.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}
// The key of a float for a max or min: -0.0 taken as +0.0 first
__device__ __forceinline__ int key_of(float f) {
  return ordered(__fadd_rn(f, 0.f));
}

// A bid of person p of N as one unsigned 64-bit key: the bid's order in the
// high word, N - 1 - p in the low one. 0 is below every key: no bid.
__device__ __forceinline__ unsigned long long bid_key(float bid, int p, int N) {
  const unsigned hi = static_cast<unsigned>(key_of(bid)) ^ 0x80000000u;
  return (static_cast<unsigned long long>(hi) << 32) |
         static_cast<unsigned>(N - 1 - p);
}
__device__ __forceinline__ float bid_of(unsigned long long key) {
  return unordered(static_cast<int>(static_cast<unsigned>(key >> 32) ^
                                    0x80000000u));
}
__device__ __forceinline__ int bidder_of(unsigned long long key, int N) {
  return N - 1 - static_cast<int>(static_cast<unsigned>(key));
}

// Threads of a block for N persons: a warp a person, up to 32 warps.
int auction_threads(int N) { return 32 * (N < kAuctionMaxWarps ? N : 32); }

// Bytes of dynamic shared memory a block takes (ops:
// train/auction.py::smem_bytes): the keys (8-byte aligned, first), values,
// prices, owners, assigned, src.
size_t smem_layout(int N, int Q) {
  return 8 * static_cast<size_t>(Q) +
         4 * (static_cast<size_t>(N) * Q + 2 * Q + 2 * N);
}

// cost [B, Q, N] f32; n_valid [B] int32; src [B, N] int64 (0 where not
// valid); valid [B, N] bool; steps [B] int32 or null: each image's rounds.
// C: objects a lane in a bid, Q <= 32 C.
template <int C>
__global__ void __launch_bounds__(32 * kAuctionMaxWarps)
auction_kernel(const float* __restrict__ cost, const int* __restrict__ n_valid,
               long long* __restrict__ src_out, bool* __restrict__ valid_out,
               int* __restrict__ steps, int Q, int N, int num_iters,
               float eps_scale) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;  // [Q] a round's top bid, or 0
  float* val = reinterpret_cast<float*>(key + Q);  // [N][Q] persons x objects
  float* prices = val + static_cast<size_t>(N) * Q;
  int* owner = reinterpret_cast<int*>(prices + Q);  // later: taken if >= 0
  int* assigned = owner + Q;
  int* src = assigned + N;
  __shared__ float wmax[kAuctionMaxWarps], wmin[kAuctionMaxWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nv = n_valid[b];
  const float* cb = cost + static_cast<long long>(b) * Q * N;

  float vmax = -CUDART_INF_F;
  float vmin = CUDART_INF_F;
  const int QN = Q * N;
  for (int e0 = tid; e0 < QN; e0 += kStageLoads * threads) {
    float x[kStageLoads];
#pragma unroll
    for (int t = 0; t < kStageLoads; ++t) {
      const int e = e0 + t * threads;
      x[t] = e < QN ? __ldg(cb + e) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kStageLoads; ++t) {
      const int e = e0 + t * threads;
      if (e < QN) {
        const int q = e / N;
        const int n = e - q * N;
        const float y = n < nv ? -guard(x[t]) : kNeg;
        val[n * Q + q] = y;
        vmax = fmaxf(vmax, y);
        vmin = fminf(vmin, y);
      }
    }
  }
  for (int j = tid; j < Q; j += threads) {
    key[j] = 0ull;
    prices[j] = 0.f;
    owner[j] = -1;
  }
  for (int r = tid; r < N; r += threads) assigned[r] = 0;
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
  for (int w = 0; w < warps; ++w) {
    vmax = fmaxf(vmax, wmax[w]);
    vmin = fminf(vmin, wmin[w]);
  }
  const float spread =
      fmaxf(__fsub_rn(vmax, fmaxf(vmin, kNeg * 0.5f)), 1.0f);
  const float eps =
      __fmul_rn(spread, __fdiv_rn(eps_scale, static_cast<float>(N + 1)));

  int n_open = min(max(nv, 0), N);  // valid persons without an object
  int rounds = 0;
  for (int it = 0; it < num_iters && n_open > 0; ++it) {
    ++rounds;
    // bids: a warp per unassigned valid person
    for (int p = warp; p < nv && p < N; p += warps) {
      if (assigned[p]) continue;
      const float* row = val + static_cast<size_t>(p) * Q;
      float pr[C], net[C];  // every load first; -INF past Q is never taken
#pragma unroll (C <= 32 ? C : 1)
      for (int k = 0; k < C; ++k) {
        const int j = min(lane + 32 * k, Q - 1);
        pr[k] = prices[j];
        net[k] = __fsub_rn(row[j], pr[k]);
      }
      float b1 = -CUDART_INF_F;
      float s1 = -CUDART_INF_F;
      float p1 = 0.f;  // the price of i1
      int i1 = INT_MAX;
#pragma unroll (C <= 32 ? C : 1)
      for (int k = 0; k < C; ++k) {
        const float n = lane + 32 * k < Q ? net[k] : -CUDART_INF_F;
        const bool first = n > b1;
        s1 = first ? b1 : fmaxf(s1, n);
        b1 = first ? n : b1;
        p1 = first ? pr[k] : p1;
        i1 = first ? lane + 32 * k : i1;
      }
      const int top = __reduce_max_sync(kFull, key_of(b1));
      const int best_j =
          __reduce_min_sync(kFull, key_of(b1) == top ? i1 : INT_MAX);
      // net2[best_j] = NEG: the lane of best_j offers its second best
      const float second = fmaxf(
          unordered(__reduce_max_sync(kFull, key_of(i1 == best_j ? s1 : b1))),
          kNeg);
      if (i1 == best_j) {  // the lane of best_j holds its price
        const float bid =
            __fadd_rn(__fadd_rn(p1, __fsub_rn(unordered(top), second)), eps);
        if (bid > kNeg) atomicMax(&key[best_j], bid_key(bid, p, N));
      }
    }
    __syncthreads();
    // each object to its top bid; the keys back to 0. A thread takes one
    // object a barrier, which counts the persons newly placed (one barrier
    // while Q <= threads).
    for (int j0 = 0; j0 < Q; j0 += threads) {
      const int j = j0 + tid;
      bool placed = false;
      if (j < Q) {
        const unsigned long long k = key[j];
        const int o = owner[j];
        if (k != 0ull) {
          const int p = bidder_of(k, N);
          if (o >= 0) assigned[o] = 0;
          placed = o < 0;
          assigned[p] = 1;
          owner[j] = p;
          prices[j] = bid_of(k);
          key[j] = 0ull;
        }
      }
      n_open -= __syncthreads_count(placed);
    }
  }

  // invert owner -> src (a person owns at most one object); an owned object
  // is taken
  for (int r = tid; r < N; r += threads) src[r] = -1;
  __syncthreads();
  for (int j = tid; j < Q; j += threads) {
    const int o = owner[j];
    if (o >= 0) src[o] = j;
  }
  __syncthreads();
  // greedy cleanup (auction.py:100-113): persons in order take their best
  // still-free query, ties to the lower query
  if (warp == 0) {
    for (int i = 0; i < N && i < nv; ++i) {
      if (src[i] >= 0) continue;
      const float* row = val + static_cast<size_t>(i) * Q;
      int best = INT_MIN;  // below every float's key: a lane without columns
      int bi = INT_MAX;
      for (int j = lane; j < Q; j += 32) {
        const int k = key_of(owner[j] >= 0 ? kNeg : row[j]);
        if (k > best) {
          best = k;
          bi = j;
        }
      }
      const int top = __reduce_max_sync(kFull, best);
      bi = __reduce_min_sync(kFull, best == top ? bi : INT_MAX);
      if (lane == 0) {
        src[i] = bi;
        owner[bi] = i;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const long long base = static_cast<long long>(b) * N;
  for (int r = tid; r < N; r += threads) {
    const int s = src[r];
    const bool ok = r < nv && s >= 0;
    src_out[base + r] = ok ? s : 0;
    valid_out[base + r] = ok;
  }
  if (steps != nullptr && tid == 0) steps[b] = rounds;
}

template <int C>
int launch(const void* cost, const void* n_valid, void* src, void* valid,
           void* steps, int B, int Q, int N, int num_iters, float eps_scale,
           void* stream) {
  if constexpr (C < kAuctionMaxColumns) {
    if (Q > 32 * C) {
      return launch<2 * C>(cost, n_valid, src, valid, steps, B, Q, N,
                           num_iters, eps_scale, stream);
    }
  }
  const size_t bytes = smem_layout(N, Q);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(cudaErrorInvalidValue);
  }
  auction_kernel<C><<<B, auction_threads(N), bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_valid),
      static_cast<long long*>(src), static_cast<bool*>(valid),
      static_cast<int*>(steps), Q, N, num_iters, eps_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace psalm

// cost [B, Q, N] f32, contiguous; n_valid [B] int32; src [B, N] int64;
// valid [B, N] bool; steps [B] int32 or null. One block per image. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an image without queries,
// with more than the widest instantiation takes, or that does not fit a
// block's shared memory.
extern "C" int psalm_auction_assign(const void* cost, const void* n_valid,
                                    void* src, void* valid, void* steps,
                                    int B, int Q, int N, int num_iters,
                                    float eps_scale, void* stream) {
  using namespace psalm;
  if (Q <= 0 || Q > 32 * kAuctionMaxColumns) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  return launch<1>(cost, n_valid, src, valid, steps, B, Q, N, num_iters,
                   eps_scale, stream);
}
