// K5 backward: the gradient of softmax attention (flash_attention.cu),
// causal or not, without the [L, L] probabilities.
//
// Replaces the backward of the stock TPU kernel jax.experimental.pallas.ops
// .tpu.flash_attention, the two pl.pallas_calls of its _flash_attention_bwd:
// _flash_attention_bwd_dkv (flash_attention.py:941, kernel :796) and
// _flash_attention_bwd_dq (:1287, kernel :1146), which JAX runs when it
// differentiates the pixel decoder's dense mode (psalm_tpu/models/
// pixel_decoder.py, DenseSelfAttention) or Phi's use_flash branch. It is the
// FA2 recurrence, with P recomputed from q, k and the forward's log-sum-exp:
//   D_i   = sum_d dO_i,d O_i,d                           (rowdot kernel)
//   P_ij  = exp(q_i k_j^T * sm_scale - lse_i)   (0 above the causal diagonal)
//   dP_ij = dO_i v_j^T,   dS_ij = P_ij (dP_ij - D_i)
//   dV_j  = sum_i P_ij dO_i,          dK_j = sm_scale sum_i dS_ij q_i
//   dQ_i  = sm_scale sum_j dS_ij k_j
// with exponentials and accumulators in f32 and the outputs in the inputs'
// type. The exponentials are exp2 of log2-scaled logits, as in the forward.
// Two kernels after the rowdot: dK/dV per tile of keys, dQ per tile of
// query rows. Nothing is written twice, so no atomics are needed and the
// result is deterministic; the price is that each recomputes P and dP (14
// S^2 h hd FLOP as executed, against 10 S^2 h hd needed).
//
// What bounds it on the H100: operations. At the dense training shape (2
// heads of 128 over S = 21504) one backward needs five [S, S] products (the
// logits again, dP, dV, dK, dQ), 10 S^2 h hd = 1.2e12 FLOP, against 11 MB
// of bf16 inputs and outputs: 1.2 ms at the bf16 tensor-core peak.
//
// bf16 (flash_bwd_*_tc_kernel): every product on the tensor cores (mma.sync
// m16n8k16, tensor_core.cuh), 4 warps a block, 16 keys or rows a warp. The
// dK/dV kernel works transposed, keys as rows: S^T = k q^T and dP^T = v
// dO^T take k and v from shared memory as A operands and the staged q and
// dO rows as B; P^T and dS^T then stay in registers as the A operands of
// dV += P^T dO and dK += dS^T q, with q and dO read transposed by
// ldmatrix.trans. The dQ kernel keeps q and dO in registers, stages k and v,
// and feeds dS from registers into dQ += dS k. The walked tiles (q, dO and
// their lse and D entries, or k and v) arrive by cp.async two deep. P is
// rounded to bf16 before dV's product and dS before dK's and dQ's, where
// the stock kernel rounds them (flash_attention.py:900, :918, :1251-1258).
// At hd = 128 a step walks 32 rows or keys, else 64: dK and dV of a 16-key
// warp tile hold 128 f32 registers a thread at hd = 128.
//
// f32 (flash_bwd_dkv_kernel, flash_bwd_dq_kernel): the products on the f32
// CUDA cores, exact to f32. The forward's f32 layout twice: a key row (or
// query row) belongs to HD/32 neighbouring threads of one warp, each holding
// 32 channels of its operands and accumulators in registers; the walked
// tiles are staged as f32 with each 32-channel slice at a stride of 33
// floats, and partial dot products are summed with warp shuffles.

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace psalm {

constexpr int kTile = 64;            // keys per dK/dV block, rows per dQ block
constexpr int kBwdSlice = 32;        // channels per thread
constexpr int kBwdSliceStride = 33;  // floats between slices in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// D_i = sum_d dO_i,d O_i,d in f32: one warp per row.
template <typename T>
__global__ void flash_bwd_rowdot_kernel(const T* __restrict__ out,
                                        const T* __restrict__ dout,
                                        float* __restrict__ delta,
                                        long long rows, int HD) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;  // whole warps leave together
  float s = 0.f;
  for (int d = lane; d < HD; d += 32) {
    s += to_f32(out[warp * HD + d]) * to_f32(dout[warp * HD + d]);
  }
  s = warp_sum(s);
  if (lane == 0) delta[warp] = s;
}

// Stages rows [r0, r0 + n) of a and b ([L, HD] each) into shared memory as
// f32, each 32-channel slice at a stride of 33 floats.

// ---- bf16, tensor cores ----------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcTile = 16 * kTcWarps;  // keys per dK/dV block, rows per dQ

// rows (dK/dV) or keys (dQ) walked per step
template <int HD>
constexpr int kTcStep = HD == 128 ? 32 : 64;

// k and v tiles, two (q, dO) step tiles, two (lse, D) step vectors
template <int HD>
constexpr size_t dkv_tc_smem() {
  return sizeof(__nv_bfloat16) * (HD + kPad) * (2 * kTcTile + 4 * kTcStep<HD>) +
         sizeof(float) * 4 * kTcStep<HD>;
}

// q and dO tiles, two (k, v) step tiles
template <int HD>
constexpr size_t dq_tc_smem() {
  return sizeof(__nv_bfloat16) * (HD + kPad) * (2 * kTcTile + 4 * kTcStep<HD>);
}

// Rows `row` and `row + 8` of a [L, HD] bf16 output from a warp's C
// fragments over HD / 8 column blocks, times `mul`; rows >= L are dropped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[HD / 8][4],
                                           int row, int L, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= L) continue;
    __nv_bfloat16* out = dst + static_cast<long long>(row + 8 * r) * HD + 2 * t;
#pragma unroll
    for (int b = 0; b < HD / 8; ++b) {
      *reinterpret_cast<__nv_bfloat162*>(out + b * 8) = __floats2bfloat162_rn(
          acc[b][2 * r] * mul, acc[b][2 * r + 1] * mul);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int L, float scale,
                            int causal) {
  constexpr int kStep = kTcStep<HD>;
  constexpr int kStride = HD + kPad;
  constexpr int kDepth = HD / 16;
  constexpr int kSBlocks = kStep / 8;  // 8-row column blocks of S^T, dP^T
  constexpr int kDBlocks = HD / 8;     // 8-channel column blocks of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [tile, stride]
  __nv_bfloat16* vs = ks + kTcTile * kStride;             // [tile, stride]
  __nv_bfloat16* qs = vs + kTcTile * kStride;             // [2][step, stride]
  __nv_bfloat16* dos = qs + 2 * kStep * kStride;          // [2][step, stride]
  // [2][step] each
  auto* lses = reinterpret_cast<float*>(dos + 2 * kStep * kStride);
  float* deltas = lses + 2 * kStep;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = blockIdx.y;
  const int k0 = blockIdx.x * kTcTile;
  const long long off = head * L * HD;
  const float scale_log2 = scale * kLog2e;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  auto stage = [&](int i0, int buf) {
    load_rows_async<HD, kStep, kTcThreads>(qs + buf * kStep * kStride, q + off,
                                           i0, L);
    load_rows_async<HD, kStep, kTcThreads>(dos + buf * kStep * kStride,
                                           dout + off, i0, L);
    load_vec_async(lses + buf * kStep, lse + head * L, i0, kStep, L);
    load_vec_async(deltas + buf * kStep, delta + head * L, i0, kStep, L);
  };
  const int first = causal ? k0 : 0;  // rows before k0 see none of the keys
  const int steps = (L - first + kStep - 1) / kStep;
  load_rows_async<HD, kTcTile, kTcThreads>(ks, k + off, k0, L);
  load_rows_async<HD, kTcTile, kTcThreads>(vs, v + off, k0, L);
  stage(first, 0);
  cp_async_commit();

  float dka[kDBlocks][4], dva[kDBlocks][4];
  zero<kDBlocks>(dka);
  zero<kDBlocks>(dva);
  for (int j = 0; j < steps; ++j) {
    const int i0 = first + j * kStep;
    const int buf = j & 1;
    if (j + 1 < steps) {  // the next rows' copies fly during this step
      stage(i0 + kStep, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = qs + buf * kStep * kStride;
    const __nv_bfloat16* dot = dos + buf * kStep * kStride;
    const float* lt = lses + buf * kStep;
    const float* dt = deltas + buf * kStep;

    // S^T = k q^T and dP^T = v dO^T: 16 keys x kStep rows per warp
    float s[kSBlocks][4], dp[kSBlocks][4];
    zero<kSBlocks>(s);
    zero<kSBlocks>(dp);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      uint32_t ka[4], va[4];
      load_a(ka, ks, kStride, warp * 16, d * 16);
      load_a(va, vs, kStride, warp * 16, d * 16);
#pragma unroll
      for (int b = 0; b < kSBlocks; b += 2) {
        uint32_t qb[4], ob[4];
        load_b_rows(qb, qt, kStride, b * 8, d * 16);
        mma_bf16(s[b], ka, qb[0], qb[1]);
        mma_bf16(s[b + 1], ka, qb[2], qb[3]);
        load_b_rows(ob, dot, kStride, b * 8, d * 16);
        mma_bf16(dp[b], va, ob[0], ob[1]);
        mma_bf16(dp[b + 1], va, ob[2], ob[3]);
      }
    }
    // P^T and dS^T in place; 0 for rows past L and above the diagonal
    const bool edge = i0 + kStep > L || (causal && i0 < k0 + kTcTile);
#pragma unroll
    for (int b = 0; b < kSBlocks; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = b * 8 + 2 * t + (e & 1);
        const int row = i0 + col, key = key0 + (e >> 1) * 8;
        float p = exp2f(fmaf(s[b][e], scale_log2, -lt[col] * kLog2e));
        float ds = p * (dp[b][e] - dt[col]);
        if (edge && (row >= L || (causal && key > row))) p = ds = 0.f;
        s[b][e] = p;
        dp[b][e] = ds;
      }
    }
    // dV += P^T dO and dK += dS^T q, P^T and dS^T rounded to bf16
#pragma unroll
    for (int c = 0; c < kStep / 16; ++c) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, s[2 * c], s[2 * c + 1]);
      c_to_a(sa, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
      for (int b = 0; b < kDBlocks; b += 2) {
        uint32_t ob[4], qb[4];
        load_b_cols(ob, dot, kStride, b * 8, c * 16);
        mma_bf16(dva[b], pa, ob[0], ob[1]);
        mma_bf16(dva[b + 1], pa, ob[2], ob[3]);
        load_b_cols(qb, qt, kStride, b * 8, c * 16);
        mma_bf16(dka[b], sa, qb[0], qb[1]);
        mma_bf16(dka[b + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // this step's buffers are free for the copy after next
  }
  store_rows<HD>(dk + off, dka, key0, L, scale);
  store_rows<HD>(dv + off, dva, key0, L, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int L, float scale,
                           int causal) {
  constexpr int kStep = kTcStep<HD>;
  constexpr int kStride = HD + kPad;
  constexpr int kDepth = HD / 16;
  constexpr int kSBlocks = kStep / 8;  // 8-key column blocks of S, dP
  constexpr int kDBlocks = HD / 8;     // 8-channel column blocks of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [tile, stride]
  __nv_bfloat16* dos = qs + kTcTile * kStride;            // [tile, stride]
  __nv_bfloat16* ks = dos + kTcTile * kStride;            // [2][step, stride]
  __nv_bfloat16* vs = ks + 2 * kStep * kStride;           // [2][step, stride]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = blockIdx.y;
  const int q0 = blockIdx.x * kTcTile;
  const long long off = head * L * HD;
  const float scale_log2 = scale * kLog2e;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const int kv_end = causal ? min(L, q0 + kTcTile) : L;
  const int steps = (kv_end + kStep - 1) / kStep;
  load_rows_async<HD, kTcTile, kTcThreads>(qs, q + off, q0, L);
  load_rows_async<HD, kTcTile, kTcThreads>(dos, dout + off, q0, L);
  load_rows_async<HD, kStep, kTcThreads>(ks, k + off, 0, L);
  load_rows_async<HD, kStep, kTcThreads>(vs, v + off, 0, L);
  cp_async_commit();
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = row0 + 8 * r < L;
    lse2[r] = live ? lse[head * L + row0 + 8 * r] * kLog2e : 0.f;
    di[r] = live ? delta[head * L + row0 + 8 * r] : 0.f;
  }

  uint32_t qf[kDepth][4], df[kDepth][4];
  float dqa[kDBlocks][4];
  zero<kDBlocks>(dqa);
  for (int j = 0; j < steps; ++j) {
    const int j0 = j * kStep;
    const int buf = j & 1;
    if (j + 1 < steps) {  // the next keys' copies fly during this step
      const int nxt = (buf ^ 1) * kStep * kStride;
      load_rows_async<HD, kStep, kTcThreads>(ks + nxt, k + off, j0 + kStep, L);
      load_rows_async<HD, kStep, kTcThreads>(vs + nxt, v + off, j0 + kStep, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        load_a(qf[d], qs, kStride, warp * 16, d * 16);
        load_a(df[d], dos, kStride, warp * 16, d * 16);
      }
    }
    const __nv_bfloat16* kt = ks + buf * kStep * kStride;
    const __nv_bfloat16* vt = vs + buf * kStep * kStride;

    // S = q k^T and dP = dO v^T: 16 rows x kStep keys per warp
    float s[kSBlocks][4], dp[kSBlocks][4];
    zero<kSBlocks>(s);
    zero<kSBlocks>(dp);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
#pragma unroll
      for (int b = 0; b < kSBlocks; b += 2) {
        uint32_t kb[4], vb[4];
        load_b_rows(kb, kt, kStride, b * 8, d * 16);
        mma_bf16(s[b], qf[d], kb[0], kb[1]);
        mma_bf16(s[b + 1], qf[d], kb[2], kb[3]);
        load_b_rows(vb, vt, kStride, b * 8, d * 16);
        mma_bf16(dp[b], df[d], vb[0], vb[1]);
        mma_bf16(dp[b + 1], df[d], vb[2], vb[3]);
      }
    }
    // dS in place; 0 for keys past L and above the diagonal
    const bool edge = j0 + kStep > L || (causal && j0 + kStep > q0);
#pragma unroll
    for (int b = 0; b < kSBlocks; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + b * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float p = exp2f(fmaf(s[b][e], scale_log2, -lse2[r]));
        const bool masked =
            edge && (key >= L || (causal && key > row0 + 8 * r));
        dp[b][e] = masked ? 0.f : p * (dp[b][e] - di[r]);
      }
    }
    // dQ += dS k, dS rounded to bf16
#pragma unroll
    for (int c = 0; c < kStep / 16; ++c) {
      uint32_t sa[4];
      c_to_a(sa, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
      for (int b = 0; b < kDBlocks; b += 2) {
        uint32_t kb[4];
        load_b_cols(kb, kt, kStride, b * 8, c * 16);
        mma_bf16(dqa[b], sa, kb[0], kb[1]);
        mma_bf16(dqa[b + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // this step's buffers are free for the copy after next
  }
  store_rows<HD>(dq + off, dqa, row0, L, scale);
}

// ---- f32, CUDA cores -------------------------------------------------------

template <int HD>
__device__ __forceinline__ void stage_rows(const float* __restrict__ a,
                                           const float* __restrict__ b, int r0,
                                           int n, float* as, float* bs) {
  constexpr int kRowStride = (HD / kBwdSlice) * kBwdSliceStride;
  for (int e = threadIdx.x; e < n * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD;
    const int at = r * kRowStride + (c / kBwdSlice) * kBwdSliceStride +
                   c % kBwdSlice;
    const long long src = static_cast<long long>(r0 + r) * HD + c;
    as[at] = a[src];
    bs[at] = b[src];
  }
}

// Sum of v over the HD/32 neighbouring threads that own one row.
template <int kParts>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < kParts; off <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int HD>
__global__ void flash_bwd_dkv_kernel(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     float* __restrict__ dk,
                                     float* __restrict__ dv,
                                     int L, float scale, int causal) {
  constexpr int kParts = HD / kBwdSlice;  // threads per key row
  constexpr int kRowStride = kParts * kBwdSliceStride;
  extern __shared__ float smem[];
  float* qs = smem;                          // [kTile, kRowStride]
  float* dos = qs + kTile * kRowStride;      // [kTile, kRowStride]
  float* lse2s = dos + kTile * kRowStride;   // [kTile], log2 units
  float* deltas = lse2s + kTile;             // [kTile]

  const long long head = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int key = k0 + threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const bool live = key < L;
  const long long off = head * L * HD;
  const float scale_log2 = scale * kLog2e;

  float kr[kBwdSlice], vr[kBwdSlice], dka[kBwdSlice], dva[kBwdSlice];
#pragma unroll
  for (int d = 0; d < kBwdSlice; ++d) {
    const long long at = off + static_cast<long long>(key) * HD +
                         part * kBwdSlice + d;
    kr[d] = live ? k[at] * scale_log2 : 0.f;
    vr[d] = live ? v[at] : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  // causal: rows before k0 see none of this tile's keys
  for (int i0 = causal ? k0 : 0; i0 < L; i0 += kTile) {
    const int n = min(kTile, L - i0);
    __syncthreads();  // the previous tile is no longer read
    stage_rows<HD>(q + off, dout + off, i0, n, qs, dos);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      lse2s[e] = lse[head * L + i0 + e] * kLog2e;
      deltas[e] = delta[head * L + i0 + e];
    }
    __syncthreads();

    for (int ii = 0; ii < n; ++ii) {  // uniform across the block
      const float* qrow = qs + ii * kRowStride + part * kBwdSliceStride;
      const float* drow = dos + ii * kRowStride + part * kBwdSliceStride;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kBwdSlice; ++d) {
        s += kr[d] * qrow[d];
        dp += vr[d] * drow[d];
      }
      s = row_sum<kParts>(s);
      dp = row_sum<kParts>(dp);
      const float p = causal && key > i0 + ii ? 0.f : exp2f(s - lse2s[ii]);
      const float ds = p * (dp - deltas[ii]);
#pragma unroll
      for (int d = 0; d < kBwdSlice; ++d) {
        dva[d] += p * drow[d];
        dka[d] += ds * qrow[d];
      }
    }
  }

  if (live) {
    const long long at = off + static_cast<long long>(key) * HD +
                         part * kBwdSlice;
#pragma unroll
    for (int d = 0; d < kBwdSlice; ++d) {
      dk[at + d] = dka[d] * scale;
      dv[at + d] = dva[d];
    }
  }
}

template <int HD>
__global__ void flash_bwd_dq_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    float* __restrict__ dq, int L, float scale,
                                    int causal) {
  constexpr int kParts = HD / kBwdSlice;  // threads per query row
  constexpr int kRowStride = kParts * kBwdSliceStride;
  extern __shared__ float smem[];
  float* ks = smem;                      // [kTile, kRowStride]
  float* vs = ks + kTile * kRowStride;   // [kTile, kRowStride]

  const long long head = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int row = q0 + threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const bool live = row < L;
  const long long off = head * L * HD;
  const float scale_log2 = scale * kLog2e;

  float qr[kBwdSlice], dor[kBwdSlice], acc[kBwdSlice];
#pragma unroll
  for (int d = 0; d < kBwdSlice; ++d) {
    const long long at = off + static_cast<long long>(row) * HD +
                         part * kBwdSlice + d;
    qr[d] = live ? q[at] * scale_log2 : 0.f;
    dor[d] = live ? dout[at] : 0.f;
    acc[d] = 0.f;
  }
  const float lse2 = live ? lse[head * L + row] * kLog2e : 0.f;
  const float di = live ? delta[head * L + row] : 0.f;

  const int kv_end = causal ? min(L, q0 + kTile) : L;
  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    const int n = min(kTile, kv_end - j0);
    __syncthreads();  // the previous tile is no longer read
    stage_rows<HD>(k + off, v + off, j0, n, ks, vs);
    __syncthreads();

    for (int jj = 0; jj < n; ++jj) {  // uniform across the block
      const float* krow = ks + jj * kRowStride + part * kBwdSliceStride;
      const float* vrow = vs + jj * kRowStride + part * kBwdSliceStride;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kBwdSlice; ++d) {
        s += qr[d] * krow[d];
        dp += dor[d] * vrow[d];
      }
      s = row_sum<kParts>(s);
      dp = row_sum<kParts>(dp);
      const float p = causal && j0 + jj > row ? 0.f : exp2f(s - lse2);
      const float ds = p * (dp - di);
#pragma unroll
      for (int d = 0; d < kBwdSlice; ++d) acc[d] += ds * krow[d];
    }
  }

  if (live) {
    const long long at = off + static_cast<long long>(row) * HD +
                         part * kBwdSlice;
#pragma unroll
    for (int d = 0; d < kBwdSlice; ++d) dq[at + d] = acc[d] * scale;
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int HD>
cudaError_t launch_bwd_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const __nv_bfloat16* dout,
                          const float* lse, const float* delta,
                          __nv_bfloat16* dq, __nv_bfloat16* dk,
                          __nv_bfloat16* dv, int BH, int L, int causal,
                          float scale, cudaStream_t stream) {
  auto dkv = flash_bwd_dkv_tc_kernel<HD>;
  auto dqk = flash_bwd_dq_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkv_tc_smem<HD>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_tc_smem<HD>()));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTcTile - 1) / kTcTile, BH);
  dkv<<<grid, kTcThreads, dkv_tc_smem<HD>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, L, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<grid, kTcThreads, dq_tc_smem<HD>(), stream>>>(q, k, v, dout, lse,
                                                       delta, dq, L, scale,
                                                       causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v,
                           const float* dout, const float* lse,
                           const float* delta, float* dq, float* dk, float* dv,
                           int BH, int L, int causal, float scale,
                           cudaStream_t stream) {
  constexpr int kParts = HD / kBwdSlice;
  const size_t tiles = 2ull * kTile * kParts * kBwdSliceStride * sizeof(float);
  const size_t smem_dkv = tiles + 2ull * kTile * sizeof(float);
  auto dkv = flash_bwd_dkv_kernel<HD>;
  auto dqk = flash_bwd_dq_kernel<HD>;
  cudaError_t err = allow_shared(dkv, smem_dkv);
  if (err != cudaSuccess) return err;
  err = allow_shared(dqk, tiles);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, BH);
  dkv<<<grid, kTile * kParts, smem_dkv, stream>>>(q, k, v, dout, lse, delta,
                                                  dk, dv, L, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<grid, kTile * kParts, tiles, stream>>>(q, k, v, dout, lse, delta, dq,
                                               L, scale, causal);
  return cudaGetLastError();
}

// D = rowsum(dO O), then bf16 to the tensor-core kernels and f32 to the
// CUDA-core ones.
template <typename T, int HD>
cudaError_t launch_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int BH, int L, int causal,
                             float scale, cudaStream_t stream) {
  if (BH == 0 || L == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidConfiguration;
  const long long rows = static_cast<long long>(BH) * L;
  constexpr int kRowdotThreads = 256;  // 8 rows per block
  const long long rowdot_blocks = (rows * 32 + kRowdotThreads - 1) / kRowdotThreads;
  if (rowdot_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bwd_rowdot_kernel<T><<<static_cast<unsigned>(rowdot_blocks),
                               kRowdotThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows,
      HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* qt = static_cast<const T*>(q);
  auto* kt = static_cast<const T*>(k);
  auto* vt = static_cast<const T*>(v);
  auto* dot = static_cast<const T*>(dout);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_bwd_tc<HD>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq),
                             static_cast<T*>(dk), static_cast<T*>(dv), BH, L,
                             causal, scale, stream);
  } else {
    return launch_bwd_f32<HD>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq),
                              static_cast<T*>(dk), static_cast<T*>(dv), BH, L,
                              causal, scale, stream);
  }
}

template <typename T>
cudaError_t dispatch_bwd_head_dim(int hd, const void* q, const void* k,
                                  const void* v, const void* out,
                                  const void* dout, const float* lse,
                                  float* delta, void* dq, void* dk, void* dv,
                                  int BH, int L, int causal, float scale,
                                  cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_flash_bwd<T, 32>(q, k, v, out, dout, lse, delta, dq, dk,
                                     dv, BH, L, causal, scale, stream);
    case 64:
      return launch_flash_bwd<T, 64>(q, k, v, out, dout, lse, delta, dq, dk,
                                     dv, BH, L, causal, scale, stream);
    case 128:
      return launch_flash_bwd<T, 128>(q, k, v, out, dout, lse, delta, dq, dk,
                                      dv, BH, L, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace psalm

// q, k, v, out (the forward's output), dout, dq, dk and dv [BH, L, hd]
// contiguous in `dtype`, 16-byte aligned; hd 32, 64 or 128. lse [BH, L] f32
// from the forward; delta [BH, L] f32 scratch, written here. Returns
// cudaGetLastError().
extern "C" int psalm_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* out,
                                         const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk,
                                         void* dv, int dtype, int BH, int L,
                                         int hd, int causal, float scale,
                                         void* stream) {
  using namespace psalm;
  if (BH < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = dispatch_bwd_head_dim<float>(hd, q, k, v, out, dout, l, dl, dq, dk,
                                       dv, BH, L, causal, scale, st);
  } else if (dtype == kBFloat16) {
    err = dispatch_bwd_head_dim<__nv_bfloat16>(hd, q, k, v, out, dout, l, dl,
                                               dq, dk, dv, BH, L, causal,
                                               scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
