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
// walk per row. So the design keeps a pop a short chain:
//   * the block's threads (512, or 128 from 64 columns a lane) stage the
//     guarded matrix, 4 loads in flight each, transposed to rows = targets,
//     into shared memory (a pop's lanes then read one row at consecutive
//     addresses); then one warp solves it;
//   * lane l owns columns l, l + 32, ...: their duals v, and a row search's
//     spc, path, scanned flags and owners (row4col), live in the lane's
//     registers, in arrays of a compile-time size C (columns a lane: the
//     kernel is instantiated for C = 1, 2, 4, ..., 512, Q <= 32 C) indexed
//     only by loops unrolled up to C = 32 (Q <= 1024; wider, the arrays
//     are in local memory). Shared memory holds the matrix, u, col4row,
//     row4col, the scanned rows' flags, and path once a row, written after
//     its search for the augmenting walk;
//   * a pop: the relaxation of the lane's columns (their loads first, then
//     no branch), each lane's first minimum by float compares, then two
//     redux.sync on its key: the least ordered-int key, then the
//     lowest column among the lanes that hold it (ties to the lower index,
//     INF included: jnp.argmin's first index); the popped column's spc and
//     owner come from its lane in one 64-bit __shfl_sync. No shared memory
//     is written on the chain but the scanned row's flag;
//   * the search stops at the sink (the first free column popped): JAX's
//     counted loop freezes there, so the result is the same;
//   * the dual update runs by the columns, each lane on its own: v in
//     registers, and u[r] of a scanned row by the lane of the column r
//     owns, with no pass over the rows.
// Keys are taken of x + 0.0f, so -0.0 and +0.0 (a reduced cost of exactly
// 0 is common), equal as floats, have one key.
// The arithmetic is JAX's, in its order and rounded as it rounds (no
// contraction can apply: there is no product): red = ((minval + cost[cur])
// - u[cur]) - v, then u[i] + minval, u[r] + (minval - spc[col4row[r]]) on
// the scanned rows (+ 0 elsewhere: the same value) and v + (spc - minval)
// on the scanned columns (+ 0 elsewhere), as at lap.py:78-83.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace psalm {
namespace {

constexpr int kLapMaxColumns = 512;  // columns a lane: Q <= 16384
constexpr int kStageLoads = 4;  // loads in flight a thread while staging
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoColumn = INT_MAX;  // above every float's key

// torch.nan_to_num(nan=1e8, posinf=1e8, neginf=-1e8), as JAX's lap_assign
__device__ __forceinline__ float guard(float x) {
  if (isnan(x)) return 1e8f;
  if (isinf(x)) return x > 0.f ? 1e8f : -1e8f;
  return x;
}

// The key of a float for an integer min: -0.0 taken as +0.0, then the bits
// ordered as the float orders.
__device__ __forceinline__ int key_of(float f) {
  const int i = __float_as_int(__fadd_rn(f, 0.f));
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// Threads of a block at C columns a lane: they stage the matrix, then warp 0
// solves it. Up to C = 16 a thread may hold 128 registers at 512 threads.
__host__ __device__ constexpr int lap_threads(int C) {
  return C <= 16 ? 512 : 128;
}

// Bytes of dynamic shared memory a block takes (ops: train/lap.py::smem_bytes):
// the matrix, u, path, row4col, col4row, the scanned rows' flags.
size_t smem_layout(int N, int Q) {
  return 4 * (static_cast<size_t>(N) * Q + 2 * N + 2 * Q) + N;
}

// cost [B, Q, N] f32 (queries x targets); n_valid [B] int32; src [B, N]
// int64 (0 where not valid); valid [B, N] bool; steps [B] int32 or null:
// the Dijkstra pops of each matrix. C: columns a lane, Q <= 32 C.
template <int C>
__global__ void __launch_bounds__(lap_threads(C))
lap_kernel(const float* __restrict__ cost, const int* __restrict__ n_valid,
           long long* __restrict__ src, bool* __restrict__ valid,
           int* __restrict__ steps, int Q, int N) {
  constexpr int W = (C + 31) / 32;  // words of scanned flags
  extern __shared__ float smem[];
  float* c = smem;  // [N][Q], rows = targets
  float* u = c + static_cast<size_t>(N) * Q;
  int* path_row = reinterpret_cast<int*>(u + N);  // a row's, after its search
  int* row4col = path_row + Q;
  int* col4row = row4col + Q;
  unsigned char* sr = reinterpret_cast<unsigned char*>(col4row + N);

  constexpr int kThreads = lap_threads(C);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int QN = Q * N;
  const float* cb = cost + static_cast<long long>(b) * QN;
  for (int e0 = tid; e0 < QN; e0 += kStageLoads * kThreads) {
    float x[kStageLoads];
#pragma unroll
    for (int t = 0; t < kStageLoads; ++t) {
      const int e = e0 + t * kThreads;
      x[t] = e < QN ? __ldg(cb + e) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kStageLoads; ++t) {
      const int e = e0 + t * kThreads;
      if (e < QN) {
        const int q = e / N;
        c[(e - q * N) * Q + q] = guard(x[t]);
      }
    }
  }
  for (int r = tid; r < N; r += kThreads) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  for (int j = tid; j < Q; j += kThreads) row4col[j] = -1;
  __syncthreads();
  if (tid >= 32) return;

  const int lane = tid;
  const int nv = n_valid[b];
  const int rows = min(max(nv, 0), N);
  // v = -INF past Q: such a column's reduced cost is +INF, it is never
  // relaxed and never taken but at INF ties, where a lower column wins
  float v[C];
  int own[C];  // row4col of the lane's columns
  int col[C];  // the lane's columns, clamped to Q - 1 for their loads
#pragma unroll (C <= 32 ? C : 1)
  for (int k = 0; k < C; ++k) {
    v[k] = lane + 32 * k < Q ? 0.f : -CUDART_INF_F;
    own[k] = -1;
    col[k] = min(lane + 32 * k, Q - 1);
  }
  int pops = 0;
  for (int i = 0; i < rows; ++i) {
    float spc[C];
    int path[C];
    unsigned scanned[W];
#pragma unroll (C <= 32 ? C : 1)
    for (int k = 0; k < C; ++k) {
      spc[k] = CUDART_INF_F;
      path[k] = -1;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) scanned[w] = 0u;
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
      float cc[C];  // every load of the row first, then no branch
#pragma unroll (C <= 32 ? C : 1)
      for (int k = 0; k < C; ++k) cc[k] = crow[col[k]];
      float low = CUDART_INF_F;  // the lane's first minimum, by float
      int bidx = INT_MAX;        // compares (-0.0 == +0.0), then one key
      float bspc = CUDART_INF_F;
      int bown = -1;
#pragma unroll (C <= 32 ? C : 1)
      for (int k = 0; k < C; ++k) {
        const int j = lane + 32 * k;
        const bool open = !((scanned[k >> 5] >> (k & 31)) & 1u);
        const float red =
            __fsub_rn(__fsub_rn(__fadd_rn(minval, cc[k]), ucur), v[k]);
        const bool better = open && red < spc[k];
        spc[k] = better ? red : spc[k];
        path[k] = better ? cur : path[k];
        const float val = open ? spc[k] : CUDART_INF_F;  // scanned: INF
        // the lane's first column seeds it; a later one takes it if less
        const bool first = k == 0 ? j < Q : val < low;
        low = first ? val : low;
        bidx = first ? j : bidx;
        bspc = first ? spc[k] : bspc;
        bown = first ? own[k] : bown;
      }
      const int best = bidx == INT_MAX ? kNoColumn : key_of(low);
      const int top = __reduce_min_sync(kFull, best);
      const int j = __reduce_min_sync(kFull, best == top ? bidx : INT_MAX);
      const int from = j & 31;
      const unsigned long long got = __shfl_sync(
          kFull,
          (static_cast<unsigned long long>(__float_as_uint(bspc)) << 32) |
              static_cast<unsigned>(bown),
          from);
      if (lane == from) {
        const int k = j >> 5;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (w == (k >> 5)) scanned[w] |= 1u << (k & 31);
        }
      }
      const int owner = static_cast<int>(static_cast<unsigned>(got));
      minval = __uint_as_float(static_cast<unsigned>(got >> 32));
      if (owner < 0) {
        sink = j;
      } else {
        cur = owner;
      }
    }

    // dual updates (lap.py:78-83), by the columns: v in registers; a
    // scanned row r != i was reached through the column it owns, whose lane
    // adds minval - spc to u[r] (a row owns one column: no two writes
    // meet); u[i] + minval. The + 0 of every other row leaves it as it is:
    // u is never -0.0, as a sum is -0.0 only of two -0.0.
    __syncwarp();  // sr, written by lane 0
    if (lane == 0) u[i] = __fadd_rn(u[i], minval);
#pragma unroll (C <= 32 ? C : 1)
    for (int k = 0; k < C; ++k) {
      const int j = lane + 32 * k;
      if (j < Q) {
        const bool sc = (scanned[k >> 5] >> (k & 31)) & 1u;
        const int r = own[k];
        if (sc && r >= 0 && sr[r]) {
          u[r] = __fadd_rn(u[r], __fsub_rn(minval, spc[k]));
        }
        v[k] = __fadd_rn(v[k], sc ? __fsub_rn(spc[k], minval) : 0.f);
        path_row[j] = path[k];
      }
    }
    __syncwarp();

    // augment along the alternating path back from the sink (N > Q leaves
    // a row without one: it stays unassigned)
    if (lane == 0 && sink >= 0) {
      int j = sink;
      for (int k = 0; k < N; ++k) {
        const int ip = path_row[j];
        row4col[j] = ip;
        const int jn = col4row[ip];
        col4row[ip] = j;
        if (ip == i) break;
        j = jn;
      }
    }
    __syncwarp();
#pragma unroll (C <= 32 ? C : 1)
    for (int k = 0; k < C; ++k) {
      const int j = lane + 32 * k;
      if (j < Q) own[k] = row4col[j];
    }
  }

  const long long base = static_cast<long long>(b) * N;
  for (int r = lane; r < N; r += 32) {
    const bool ok = r < nv;
    src[base + r] = ok ? col4row[r] : 0;
    valid[base + r] = ok;
  }
  if (steps != nullptr && lane == 0) steps[b] = pops;
}

template <int C>
int launch(const void* cost, const void* n_valid, void* src, void* valid,
           void* steps, int B, int Q, int N, void* stream) {
  if constexpr (C < kLapMaxColumns) {
    if (Q > 32 * C) {
      return launch<2 * C>(cost, n_valid, src, valid, steps, B, Q, N, stream);
    }
  }
  const size_t bytes = smem_layout(N, Q);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lap_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(cudaErrorInvalidValue);
  }
  lap_kernel<C><<<B, lap_threads(C), bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_valid),
      static_cast<long long*>(src), static_cast<bool*>(valid),
      static_cast<int*>(steps), Q, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace psalm

// cost [B, Q, N] f32, contiguous; n_valid [B] int32; src [B, N] int64;
// valid [B, N] bool; steps [B] int32 or null. One block per matrix. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a matrix without columns,
// with more columns than the widest instantiation, or that does not fit a
// block's shared memory.
extern "C" int psalm_lap_assign(const void* cost, const void* n_valid,
                                void* src, void* valid, void* steps, int B,
                                int Q, int N, void* stream) {
  using namespace psalm;
  if (Q <= 0 || Q > 32 * kLapMaxColumns) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  return launch<1>(cost, n_valid, src, valid, steps, B, Q, N, stream);
}
