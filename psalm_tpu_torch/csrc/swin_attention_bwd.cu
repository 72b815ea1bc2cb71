// K3 backward: the gradient of the Swin window-attention core.
//
// Replaces the backward of the TPU kernel psalm_tpu/ops/swin_attention_pallas.py
// (_op_bwd / _op_nomask_bwd, the custom VJP of fused_window_attention), which
// recomputes the core through _xla_reference and differentiates it. Per
// window w and head h, with q, k, v split out of the packed [N, 3C] rows and
// dO the output's gradient:
//   P  = softmax(q scale k^T + bias[h] (+ mask[w % nW]))   (f32, recomputed)
//   dV = P^T dO                dP = dO V^T
//   dS = P o (dP - rowsum(P o dP))
//   dq = scale dS K            dK = dS^T (q scale)
//   d bias[h] = sum over windows of dS                    (f32)
// There is no gradient for the shift mask, a constant.
//
// Rounding: in bf16 the kernel rounds where autograd through the plain twin
// (ops/swin_attention.py::window_attention_ref) rounds: q scale and P to
// bf16 (the forward's roundings), dP = dO V^T to bf16 (a bf16 product),
// dS K and dS^T (q scale) to bf16 (the casts back from the twin's f32
// products), then dq = bf16(bf16(dS K) scale) (the backward of q * scale in
// bf16), and P^T dO to bf16. Every sum runs in f32; only its order differs
// from the twin's, so its per-element limit is
// swin_attention.window_attention_bwd_limit.
//
// What bounds it on the H100: the bytes that must move are qkv, dO, d qkv,
// bias, mask and d bias once each (about 125 MB at stage 0 of a 1024^2 image
// in bf16, 0.037 ms), the operations 10 N^2 hd a (window, head) (about 13
// GFLOP at stage 0, 0.013 ms on the tensor cores). This first kernel is
// neither: it runs on the f32 CUDA cores and recomputes S and dP three
// times, so it is bound by those cores' rate. One block per (window, head);
// q scale, k, v and dO of the head are staged in shared memory as f32
// (4 x 18 KB at N = 144, head dim 32). Pass 1, a thread per query row i
// holding q_i and dO_i in registers (keys read as warp-wide broadcasts):
// the row's max and denominator, then D_i = rowsum(P o dP), then dq_i.
// Pass 2, a thread per key j holding k_j and v_j: dK_j and dV_j over every
// query row, and d bias[h][i][j] += dS_ij by an f32 atomic add (a warp adds
// 32 neighbouring floats of one row). The atomics make d bias's sum order
// change from run to run. Tensor cores, TMA and a d bias reduction over the
// windows of a head in one block are later work.

#include "common.cuh"

namespace psalm {

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int HD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s += a[d] * b[d];
  return s;
}

template <typename T, int HD>
__global__ void window_attention_bwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, const T* __restrict__ dout,
    T* __restrict__ dqkv, float* __restrict__ dbias, int N, int C, int nheads,
    int nW, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [N, HD] q scale, rounded to T
  float* ks = qs + N * HD;       // [N, HD]
  float* vs = ks + N * HD;       // [N, HD]
  float* dos = vs + N * HD;      // [N, HD]
  float* row_max = dos + N * HD; // [N]
  float* row_inv = row_max + N;  // [N] 1 / the softmax denominator
  float* row_dot = row_inv + N;  // [N] rowsum(P o dP)

  const int w = blockIdx.x / nheads;
  const int h = blockIdx.x % nheads;
  const long long row_stride = 3LL * C;
  const T* rows = qkv + static_cast<long long>(w) * N * row_stride + h * HD;
  const T* grad = dout + static_cast<long long>(w) * N * C + h * HD;
  T* drows = dqkv + static_cast<long long>(w) * N * row_stride + h * HD;

  for (int e = threadIdx.x; e < N * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    const T* row = rows + r * row_stride + d;
    qs[e] = round_to<T>(to_f32(row[0]) * scale);
    ks[e] = to_f32(row[C]);
    vs[e] = to_f32(row[2 * C]);
    dos[e] = to_f32(grad[static_cast<long long>(r) * C + d]);
  }
  __syncthreads();

  const float* bh = bias + static_cast<long long>(h) * N * N;
  const float* mw =
      mask ? mask + static_cast<long long>(w % nW) * N * N : nullptr;

  // pass 1: a thread per query row
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float q[HD], o[HD], acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] = qs[i * HD + d];
      o[d] = dos[i * HD + d];
      acc[d] = 0.f;
    }
    const float* brow = bh + static_cast<long long>(i) * N;
    const float* mrow = mw ? mw + static_cast<long long>(i) * N : nullptr;
    float mx = -INFINITY, den = 0.f;
    for (int j = 0; j < N; ++j) {
      float s = dot<HD>(q, ks + j * HD) + brow[j];
      if (mrow) s += mrow[j];
      if (s > mx) {
        den = den * expf(mx - s) + 1.f;
        mx = s;
      } else {
        den += expf(s - mx);
      }
    }
    const float inv = 1.f / den;
    float dsum = 0.f;
    for (int j = 0; j < N; ++j) {
      float s = dot<HD>(q, ks + j * HD) + brow[j];
      if (mrow) s += mrow[j];
      const float p = expf(s - mx) * inv;
      dsum += p * round_to<T>(dot<HD>(o, vs + j * HD));
    }
    for (int j = 0; j < N; ++j) {
      float s = dot<HD>(q, ks + j * HD) + brow[j];
      if (mrow) s += mrow[j];
      const float p = expf(s - mx) * inv;
      const float dp = round_to<T>(dot<HD>(o, vs + j * HD));
      const float ds = p * (dp - dsum);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += ds * ks[j * HD + d];
    }
    T* dq = drows + i * row_stride;
#pragma unroll
    for (int d = 0; d < HD; ++d) dq[d] = from_f32<T>(round_to<T>(acc[d]) * scale);
    row_max[i] = mx;
    row_inv[i] = inv;
    row_dot[i] = dsum;
  }
  __syncthreads();

  // pass 2: a thread per key
  float* dbh = dbias + static_cast<long long>(h) * N * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float k[HD], v[HD], dk[HD], dv[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      k[d] = ks[j * HD + d];
      v[d] = vs[j * HD + d];
      dk[d] = 0.f;
      dv[d] = 0.f;
    }
    for (int i = 0; i < N; ++i) {
      const long long at = static_cast<long long>(i) * N + j;
      float s = dot<HD>(qs + i * HD, k) + bh[at];
      if (mw) s += mw[at];
      const float p = expf(s - row_max[i]) * row_inv[i];
      const float dp = round_to<T>(dot<HD>(dos + i * HD, v));
      const float ds = p * (dp - row_dot[i]);
      const float pb = round_to<T>(p);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dk[d] += ds * qs[i * HD + d];
        dv[d] += pb * dos[i * HD + d];
      }
      atomicAdd(dbh + at, ds);
    }
    T* drow = drows + j * row_stride;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      drow[C + d] = from_f32<T>(dk[d]);
      drow[2 * C + d] = from_f32<T>(dv[d]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_window_attention_bwd(const void* qkv, const void* bias,
                                        const void* mask, const void* dout,
                                        void* dqkv, float* dbias, int Bn,
                                        int N, int C, int nheads, int nW,
                                        float scale, cudaStream_t stream) {
  const size_t smem = (4ull * N * HD + 3ull * N) * sizeof(float);
  auto kernel = window_attention_bwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = static_cast<long long>(Bn) * nheads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int threads = ((N < 256 ? N : 256) + 31) / 32 * 32;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), dbias, N, C, nheads, nW, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_by_type(int dtype, const void* qkv, const void* bias,
                               const void* mask, const void* dout, void* dqkv,
                               float* dbias, int Bn, int N, int C, int nheads,
                               int nW, float scale, cudaStream_t stream) {
  if (dtype == kBFloat16)
    return launch_window_attention_bwd<__nv_bfloat16, HD>(
        qkv, bias, mask, dout, dqkv, dbias, Bn, N, C, nheads, nW, scale,
        stream);
  if (dtype == kFloat32)
    return launch_window_attention_bwd<float, HD>(qkv, bias, mask, dout, dqkv,
                                                  dbias, Bn, N, C, nheads, nW,
                                                  scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace psalm

// qkv [Bn, N, 3C], dout [Bn, N, C] and dqkv [Bn, N, 3C] in `dtype`; bias
// [nheads, N, N] f32; mask [nW, N, N] f32 or null (window w reads
// mask[w % nW]); dbias [nheads, N, N] f32, zeroed by the caller (the kernel
// adds every window's dS into it). Returns cudaGetLastError().
extern "C" int psalm_window_attention_bwd(const void* qkv, const void* bias,
                                          const void* mask, const void* dout,
                                          void* dqkv, void* dbias, int dtype,
                                          int Bn, int N, int C, int nheads,
                                          int nW, float scale, void* stream) {
  using namespace psalm;
  if (nheads < 1 || C % nheads != 0 || nW < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* db = static_cast<float*>(dbias);
  switch (C / nheads) {
    case 16:
      return static_cast<int>(launch_bwd_by_type<16>(
          dtype, qkv, bias, mask, dout, dqkv, db, Bn, N, C, nheads, nW, scale,
          st));
    case 32:
      return static_cast<int>(launch_bwd_by_type<32>(
          dtype, qkv, bias, mask, dout, dqkv, db, Bn, N, C, nheads, nW, scale,
          st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
