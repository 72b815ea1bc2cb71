// K6: exact linear assignment, one thread block per cost matrix.
//
// Replaces JAX's on-device solver psalm_tpu/train/lap.py (lap_assign, :118;
// _solve_single, :28): the Jonker-Volgenant shortest augmenting path of
// scipy's _lsap.c, row by row, each Dijkstra pop a relaxation over the Q
// columns and an argmin. JAX runs it under counted lax.fori_loops (N rows x
// N pops x N augment steps) with a done-freeze, which is no Pallas kernel
// but a lax loop; in eager PyTorch each pop would be a dozen launches.
//
// What bounds it: the chain of sequential steps, not bytes or operations.
// A matrix needs one pop per column its searches scan (a few per row on
// random costs, up to i + 1 at row i), each pop a relaxation of Q columns
// and a reduction over them, then an O(N + Q) dual update and an augmenting
// walk per row. So the design keeps a pop's latency short:
//   * the block's 128 threads stage the guarded matrix, transposed to
//     rows = targets, into shared memory; then one warp solves it, its lanes
//     over the columns (lane l owns columns l, l + 32, ...), with __syncwarp
//     alone between the steps of a pop;
//   * u[N], v[Q], spc[Q], path[Q], sc[Q], sr[N], col4row[N] and row4col[Q]
//     live in shared memory;
//   * a pop's argmin is a butterfly of warp shuffles on (value, index), ties
//     to the lower index, INF included (jnp.argmin's first index), so every
//     lane holds the popped column without another step;
//   * the search stops at the sink (the first free column popped): JAX's
//     counted loop freezes there, so the result is the same.
// The arithmetic is JAX's, in its order and rounded as it rounds (no
// contraction can apply: there is no product): red = ((minval + cost[cur])
// - u[cur]) - v, then u[i] + minval, u[r] + (minval - spc[col4row[r]]) on
// the scanned rows (+ 0 elsewhere) and v + (spc - minval) on the scanned
// columns (+ 0 elsewhere), as at lap.py:78-83.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace psalm {
namespace {

constexpr int kLapThreads = 128;  // stage the matrix; warp 0 then solves
constexpr unsigned kFull = 0xffffffffu;

// torch.nan_to_num(nan=1e8, posinf=1e8, neginf=-1e8), as JAX's lap_assign
__device__ __forceinline__ float guard(float x) {
  if (isnan(x)) return 1e8f;
  if (isinf(x)) return x > 0.f ? 1e8f : -1e8f;
  return x;
}

// Bytes of dynamic shared memory a block takes (ops: train/lap.py::smem_bytes).
size_t smem_layout(int N, int Q) {
  return 4 * (static_cast<size_t>(N) * Q + 2 * N + 4 * Q) + N + Q;
}

// cost [B, Q, N] f32 (queries x targets); n_valid [B] int32; src [B, N]
// int64 (0 where not valid); valid [B, N] bool; steps [B] int32 or null:
// the Dijkstra pops of each matrix.
__global__ void __launch_bounds__(kLapThreads)
lap_kernel(const float* __restrict__ cost, const int* __restrict__ n_valid,
           long long* __restrict__ src, bool* __restrict__ valid,
           int* __restrict__ steps, int Q, int N) {
  extern __shared__ float smem[];
  float* c = smem;  // [N][Q], rows = targets
  float* u = c + static_cast<size_t>(N) * Q;
  float* v = u + N;
  float* spc = v + Q;
  int* path = reinterpret_cast<int*>(spc + Q);
  int* row4col = path + Q;
  int* col4row = row4col + Q;
  unsigned char* sc = reinterpret_cast<unsigned char*>(col4row + N);
  unsigned char* sr = sc + Q;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* cb = cost + static_cast<long long>(b) * Q * N;
  for (int e = tid; e < Q * N; e += kLapThreads) {
    const int q = e / N;
    const int n = e - q * N;
    c[n * Q + q] = guard(cb[e]);
  }
  for (int r = tid; r < N; r += kLapThreads) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  for (int j = tid; j < Q; j += kLapThreads) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  __syncthreads();
  if (tid >= 32) return;

  const int lane = tid;
  const int nv = n_valid[b];
  const int rows = Q > 0 ? min(max(nv, 0), N) : 0;
  int pops = 0;
  for (int i = 0; i < rows; ++i) {
    for (int j = lane; j < Q; j += 32) {
      spc[j] = CUDART_INF_F;
      path[j] = -1;
      sc[j] = 0;
    }
    for (int r = lane; r < N; r += 32) sr[r] = 0;
    __syncwarp();

    // Dijkstra from row i over the columns; JAX's bound of N pops
    int cur = i;
    int sink = -1;
    float minval = 0.f;
    for (int it = 0; it < N && sink < 0; ++it) {
      ++pops;
      if (lane == 0) sr[cur] = 1;
      const float ucur = u[cur];
      const float* crow = c + cur * Q;
      float best = CUDART_INF_F;
      int bidx = INT_MAX;
      for (int j = lane; j < Q; j += 32) {
        float val = CUDART_INF_F;  // a scanned column reads as INF
        if (!sc[j]) {
          const float red =
              __fsub_rn(__fsub_rn(__fadd_rn(minval, crow[j]), ucur), v[j]);
          float s = spc[j];
          if (red < s) {
            s = red;
            spc[j] = red;
            path[j] = cur;
          }
          val = s;
        }
        if (val < best || bidx == INT_MAX) {  // a lane's first column seeds it
          best = val;
          bidx = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, bidx, off);
        if (ob < best || (ob == best && oi < bidx)) {
          best = ob;
          bidx = oi;
        }
      }
      __syncwarp();  // spc[j] was written by its own lane
      const int j = bidx;
      const float mv = spc[j];
      const int owner = row4col[j];
      __syncwarp();
      if (lane == (j & 31)) sc[j] = 1;
      if (owner < 0) {
        sink = j;
      } else {
        cur = owner;
      }
      minval = mv;
      __syncwarp();
    }

    // dual updates (lap.py:78-83)
    if (lane == 0) u[i] = __fadd_rn(u[i], minval);
    __syncwarp();
    for (int r = lane; r < N; r += 32) {
      float extra = 0.f;
      if (sr[r] && r != i) {
        const int col = min(max(col4row[r], 0), Q - 1);
        extra = __fsub_rn(minval, spc[col]);
      }
      u[r] = __fadd_rn(u[r], extra);
    }
    for (int j = lane; j < Q; j += 32) {
      v[j] = __fadd_rn(v[j], sc[j] ? __fsub_rn(spc[j], minval) : 0.f);
    }
    __syncwarp();

    // augment along the alternating path back from the sink (N > Q leaves
    // a row without one: it stays unassigned)
    if (lane == 0 && sink >= 0) {
      int j = sink;
      for (int k = 0; k < N; ++k) {
        const int ip = path[j];
        row4col[j] = ip;
        const int jn = col4row[ip];
        col4row[ip] = j;
        if (ip == i) break;
        j = jn;
      }
    }
    __syncwarp();
  }

  const long long base = static_cast<long long>(b) * N;
  for (int r = lane; r < N; r += 32) {
    const bool ok = r < nv;
    src[base + r] = ok ? col4row[r] : 0;
    valid[base + r] = ok;
  }
  if (steps != nullptr && lane == 0) steps[b] = pops;
}

}  // namespace
}  // namespace psalm

// cost [B, Q, N] f32, contiguous; n_valid [B] int32; src [B, N] int64;
// valid [B, N] bool; steps [B] int32 or null. One block per matrix. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a matrix without columns or
// one that does not fit a block's shared memory.
extern "C" int psalm_lap_assign(const void* cost, const void* n_valid,
                                void* src, void* valid, void* steps, int B,
                                int Q, int N, void* stream) {
  using namespace psalm;
  if (Q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const size_t bytes = smem_layout(N, Q);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(cudaErrorInvalidValue);
  }
  lap_kernel<<<B, kLapThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_valid),
      static_cast<long long*>(src), static_cast<bool*>(valid),
      static_cast<int*>(steps), Q, N);
  return static_cast<int>(cudaGetLastError());
}
