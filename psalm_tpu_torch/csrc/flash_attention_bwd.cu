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
// with every product, exponential and accumulator in f32 and the outputs in
// the inputs' type. The exponentials are exp2 of log2-scaled logits, as in
// the forward.
//
// What bounds it on the H100: operations. At the dense training shape (2
// heads of 128 over S = 21504) one backward needs five [S, S] products (the
// logits again, dP, dV, dK, dQ), 10 S^2 h hd = 1.2e12 FLOP, against 11 MB
// of bf16 inputs and outputs: 1.2 ms at the bf16 tensor-core peak. This
// first version runs them on the f32 CUDA cores (67 TFLOP/s peak), and
// recomputes the logits and dP in both kernels (14 S^2 h hd as executed).
//
// What the design does about it: the forward's layout, twice. The dK/dV
// kernel takes one block per (b*h, tile of kTile keys): a key row belongs to
// HD/32 neighbouring threads of one warp, each holding 32 channels of k
// (pre-scaled by sm_scale * log2 e), v, dK and dV in registers; the block
// walks the query tiles, staging q and dO in shared memory as f32 with each
// 32-channel slice at a stride of 33 floats, and a causal block starts at
// its own diagonal. The dQ kernel takes one block per (b*h, tile of kTile
// query rows), holding q, dO and dQ in registers and walking the key tiles
// up to the diagonal. The logits and dP_ij are partial dot products summed
// across a row's threads with warp shuffles. Nothing is written twice, so no
// atomics are needed; the price is that each kernel recomputes P.

#include "common.cuh"

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
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ a,
                                           const T* __restrict__ b, int r0,
                                           int n, float* as, float* bs) {
  constexpr int kRowStride = (HD / kBwdSlice) * kBwdSliceStride;
  for (int e = threadIdx.x; e < n * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD;
    const int at = r * kRowStride + (c / kBwdSlice) * kBwdSliceStride +
                   c % kBwdSlice;
    const long long src = static_cast<long long>(r0 + r) * HD + c;
    as[at] = to_f32(a[src]);
    bs[at] = to_f32(b[src]);
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

template <typename T, int HD>
__global__ void flash_bwd_dkv_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const T* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     T* __restrict__ dk, T* __restrict__ dv,
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
    kr[d] = live ? to_f32(k[at]) * scale_log2 : 0.f;
    vr[d] = live ? to_f32(v[at]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  // causal: rows before k0 see none of this tile's keys
  for (int i0 = causal ? k0 : 0; i0 < L; i0 += kTile) {
    const int n = min(kTile, L - i0);
    __syncthreads();  // the previous tile is no longer read
    stage_rows<T, HD>(q + off, dout + off, i0, n, qs, dos);
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
      dk[at + d] = from_f32<T>(dka[d] * scale);
      dv[at + d] = from_f32<T>(dva[d]);
    }
  }
}

template <typename T, int HD>
__global__ void flash_bwd_dq_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const T* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    T* __restrict__ dq, int L, float scale,
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
    qr[d] = live ? to_f32(q[at]) * scale_log2 : 0.f;
    dor[d] = live ? to_f32(dout[at]) : 0.f;
    acc[d] = 0.f;
  }
  const float lse2 = live ? lse[head * L + row] * kLog2e : 0.f;
  const float di = live ? delta[head * L + row] : 0.f;

  const int kv_end = causal ? min(L, q0 + kTile) : L;
  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    const int n = min(kTile, kv_end - j0);
    __syncthreads();  // the previous tile is no longer read
    stage_rows<T, HD>(k + off, v + off, j0, n, ks, vs);
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
    for (int d = 0; d < kBwdSlice; ++d) dq[at + d] = from_f32<T>(acc[d] * scale);
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int HD>
cudaError_t launch_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int BH, int L, int causal,
                             float scale, cudaStream_t stream) {
  constexpr int kParts = HD / kBwdSlice;
  const size_t tiles = 2ull * kTile * kParts * kBwdSliceStride * sizeof(float);
  const size_t smem_dkv = tiles + 2ull * kTile * sizeof(float);
  auto dkv = flash_bwd_dkv_kernel<T, HD>;
  auto dqk = flash_bwd_dq_kernel<T, HD>;
  cudaError_t err = allow_shared(dkv, smem_dkv);
  if (err != cudaSuccess) return err;
  err = allow_shared(dqk, tiles);
  if (err != cudaSuccess) return err;
  if (BH == 0 || L == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidConfiguration;
  auto* qt = static_cast<const T*>(q);
  auto* kt = static_cast<const T*>(k);
  auto* vt = static_cast<const T*>(v);
  auto* dot = static_cast<const T*>(dout);

  const long long rows = static_cast<long long>(BH) * L;
  constexpr int kRowdotThreads = 256;  // 8 rows per block
  const long long rowdot_blocks = (rows * 32 + kRowdotThreads - 1) / kRowdotThreads;
  if (rowdot_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bwd_rowdot_kernel<T><<<static_cast<unsigned>(rowdot_blocks),
                               kRowdotThreads, 0, stream>>>(
      static_cast<const T*>(out), dot, delta, rows, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((L + kTile - 1) / kTile, BH);
  dkv<<<grid, kTile * kParts, smem_dkv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      L, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<grid, kTile * kParts, tiles, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), L, scale, causal);
  return cudaGetLastError();
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
// contiguous in `dtype`; hd 32, 64 or 128. lse [BH, L] f32 from the forward;
// delta [BH, L] f32 scratch, written here. Returns cudaGetLastError().
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
