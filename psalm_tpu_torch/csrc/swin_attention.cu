// K3: Swin window-attention core, forward.
//
// Replaces the TPU kernel psalm_tpu/ops/swin_attention_pallas.py
// (_forward / _kernel / _kernel_nomask, entry fused_window_attention): per
// window w and head h, split q, k, v out of the packed [N, 3C] rows, take
// softmax(q k^T * scale + bias[h] (+ mask[w % nW])) in f32, multiply by v,
// and write the head's columns of the [Bn, N, C] output.
//
// What bounds it on the H100: at Swin-B's shapes (N = 144 tokens per 12x12
// window, head dim 32) one (window, head) is 144 x 144 x 32 x 2 multiply-adds
// per product, about 2.7 MFLOP in all, against 27 KB of bf16 q/k/v and the
// 83 KB f32 slices of bias[h] and mask[w % nW], which every window of a head
// (and every head of a window) shares: L2 holds them, and the bytes that
// must come from device memory (q/k/v, the output, one copy of bias and
// mask) bound a stage at 0.03 ms. The work is small per block and plentiful
// across blocks (1936 (window, head) pairs at stage 0 of a 1024^2 image).
//
// Two kernels, chosen by the input's type (a fixed dispatch, not a
// fallback):
//
// bf16: window_attention_tc_kernel, both products on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators; tensor_core.cuh).
// One block per (window, head), window-major, so the heads of a window run
// together and share its mask slice in L2; one warp per 16 query rows (9 at
// N = 144). q, k and v of the head are copied into padded shared rows by
// cp.async, 16 bytes a copy; q * scale is rounded to bf16 there, as the
// twin (q * scale in q's type) and JAX's reference round it. Each warp
// takes its rows of S = q k^T over every key of the window at once (N
// padded to 16: 18 column blocks of 8 at N = 144, 72 f32 a thread), adds
// bias and mask from global memory in f32 in the accumulator layout
// (float2 per pair), and takes the softmax over the whole row in registers
// (a row lies in one quad: shuffles, no online rescaling). P is normalised
// before it is rounded to bf16, so the kernel rounds the values the twin
// and the Pallas kernel round; it is then the A operand of O = P v (v by
// ldmatrix.trans). The output goes through the warp's own shared rows for
// 16-byte stores of the head's columns. Keys past N are -inf and rows past
// N are zero-filled; N up to kTcMaxN = 192 (at 256, S's 128 f32 a thread
// spilled: 512 threads hold at most 128 registers each), instantiated for
// windows padded to 16, 64, 144 and 192 tokens.
//
// f32: window_attention_kernel, on the f32 CUDA cores, exact to f32 (the
// tiny-config checks hold the card to the CPU at 1e-5): one block per
// (window, head), k and v staged in shared memory as f32 and read as
// warp-wide broadcasts, one thread per query row with a chunked online
// softmax (16 scores per chunk).

#include "common.cuh"
#include "tensor_core.cuh"

namespace psalm {

// ---- bf16, tensor cores ----------------------------------------------------


constexpr int kTcMaxN = 192;  // tokens a window: S's accumulators in registers

template <int HD>
__host__ __device__ constexpr int tc_stride() { return HD + kPad; }

// One block per (window, head), window-major; ceil(N / 16) warps, warp i
// owns query rows [16 i, 16 i + 16). NB column blocks of 8 keys (N padded to
// 8 NB) live in each thread's S accumulators. Up to 144 tokens two blocks
// share an SM (at most 113 registers a thread; 96 and a 160-byte spill at
// N = 144, 1.3-1.5x faster than one block of 141 registers without).
template <int HD, int NB>
__global__ void __launch_bounds__(16 * NB, NB <= 18 ? 2 : 1)
    window_attention_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const float* __restrict__ bias,
                               const float* __restrict__ mask,
                               __nv_bfloat16* __restrict__ out, int N, int C,
                               int nheads, int nW, float scale) {
  constexpr int kStride = tc_stride<HD>();
  constexpr int kChunks = HD / 8;  // 16-byte pieces of a head's row
  constexpr int kNP = NB * 8;      // rows of each tile: N padded to 16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kNP, stride]
  __nv_bfloat16* ks = qs + kNP * kStride;
  __nv_bfloat16* vs = ks + kNP * kStride;

  const int w = blockIdx.x / nheads;
  const int h = blockIdx.x % nheads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row_stride = 3LL * C;
  const __nv_bfloat16* rows =
      qkv + static_cast<long long>(w) * N * row_stride + h * HD;

  // q, k and v of the head, 16 bytes a copy; rows past N zero-filled
  for (int c = threadIdx.x; c < 3 * kNP * kChunks; c += blockDim.x) {
    const int which = c / (kNP * kChunks);  // 0 q, 1 k, 2 v
    const int r = (c / kChunks) % kNP, col = (c % kChunks) * 8;
    const bool valid = r < N;
    cp_async_16(qs + (which * kNP + r) * kStride + col,
                rows + (valid ? r : 0) * row_stride + which * C + col, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // q * scale, rounded to bf16 as the twin rounds it (q * scale in q's type)
  for (int c = threadIdx.x; c < kNP * HD / 2; c += blockDim.x) {
    const int r = c / (HD / 2), col = (c % (HD / 2)) * 2;
    auto* p = reinterpret_cast<__nv_bfloat162*>(qs + r * kStride + col);
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
  __syncthreads();

  // S = (q scale) k^T over every key of the window, in f32
  float s[NB][4];
  zero<NB>(s);
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) {
    uint32_t qa[4];
    load_a(qa, qs, kStride, warp * 16, d * 16);
#pragma unroll
    for (int b = 0; b < NB; b += 2) {
      uint32_t kb[4];
      load_b_rows(kb, ks, kStride, b * 8, d * 16);
      mma_bf16(s[b], qa, kb[0], kb[1]);
      mma_bf16(s[b + 1], qa, kb[2], kb[3]);
    }
  }

  // + bias[h] (+ mask[w % nW]) in f32, keys past N to -inf; rows past N
  // take 0 (finite, never written)
  const float* bh = bias + static_cast<long long>(h) * N * N;
  const float* mw =
      mask ? mask + static_cast<long long>(w % nW) * N * N : nullptr;
  const bool pairs = (N & 1) == 0;  // float2 loads stay aligned
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const bool live = row < N;
    const long long at = static_cast<long long>(live ? row : 0) * N;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int col = b * 8 + 2 * t;
      float2 add = make_float2(0.f, 0.f);
      if (live && pairs && col < N) {
        add = __ldg(reinterpret_cast<const float2*>(bh + at + col));
        if (mw) {
          const float2 m = __ldg(reinterpret_cast<const float2*>(mw + at + col));
          add.x += m.x;
          add.y += m.y;
        }
      } else if (live) {
        if (col < N) add.x = __ldg(bh + at + col) + (mw ? __ldg(mw + at + col) : 0.f);
        if (col + 1 < N)
          add.y = __ldg(bh + at + col + 1) + (mw ? __ldg(mw + at + col + 1) : 0.f);
      }
      s[b][2 * r] = col < N ? s[b][2 * r] + add.x : -INFINITY;
      s[b][2 * r + 1] = col + 1 < N ? s[b][2 * r + 1] + add.y : -INFINITY;
    }
  }

  // softmax over the whole row (a row spans the 4 lanes of a quad),
  // normalised in f32 before P is rounded to bf16, as the twin rounds it
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int b = 0; b < NB; ++b)
      mx = fmaxf(mx, fmaxf(s[b][2 * r], s[b][2 * r + 1]));
    mx = quad_max(mx);
    float den = 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[b][e] = exp2f((s[b][e] - mx) * kLog2e);  // 0 where masked
        den += s[b][e];
      }
    }
    const float inv = 1.f / quad_sum(den);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      s[b][2 * r] *= inv;
      s[b][2 * r + 1] *= inv;
    }
  }

  // O = P v: P's C fragments, rounded to bf16, are the A operand
  float o[HD / 8][4];
  zero<HD / 8>(o);
#pragma unroll
  for (int c = 0; c < NB / 2; ++c) {
    uint32_t pa[4];
    c_to_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
    for (int b = 0; b < HD / 8; b += 2) {
      uint32_t vb[4];
      load_b_cols(vb, vs, kStride, b * 8, c * 16);
      mma_bf16(o[b], pa, vb[0], vb[1]);
      mma_bf16(o[b + 1], pa, vb[2], vb[3]);
    }
  }

  // the warp's 16 rows through its own rows of qs (no other warp reads
  // them), then 16-byte stores of the head's columns
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* srow = qs + (warp * 16 + g + 8 * r) * kStride + 2 * t;
#pragma unroll
    for (int b = 0; b < HD / 8; ++b)
      *reinterpret_cast<__nv_bfloat162*>(srow + b * 8) =
          __floats2bfloat162_rn(o[b][2 * r], o[b][2 * r + 1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int row = warp * 16 + c / kChunks, col = (c % kChunks) * 8;
    if (row < N) {
      *reinterpret_cast<uint4*>(
          out + (static_cast<long long>(w) * N + row) * C + h * HD + col) =
          *reinterpret_cast<const uint4*>(qs + row * kStride + col);
    }
  }
}

// ---- f32, CUDA cores -------------------------------------------------------

constexpr int kKeyChunk = 16;

template <int HD>
__global__ void window_attention_kernel(const float* __restrict__ qkv,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask,
                                        float* __restrict__ out, int N, int C,
                                        int nheads, int nW, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;           // [N, HD]
  float* vs = smem + N * HD;  // [N, HD]
  const int w = blockIdx.x / nheads;
  const int h = blockIdx.x % nheads;
  const long long row_stride = 3LL * C;
  const float* rows = qkv + static_cast<long long>(w) * N * row_stride;

  for (int e = threadIdx.x; e < N * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    ks[e] = rows[r * row_stride + C + h * HD + d];
    vs[e] = rows[r * row_stride + 2 * C + h * HD + d];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float q[HD], acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] = rows[i * row_stride + h * HD + d] * scale;
      acc[d] = 0.f;
    }
    const float* brow = bias + (static_cast<long long>(h) * N + i) * N;
    const float* mrow =
        mask ? mask + (static_cast<long long>(w % nW) * N + i) * N : nullptr;
    float mx = -INFINITY, denom = 0.f;
    for (int j0 = 0; j0 < N; j0 += kKeyChunk) {
      float s[kKeyChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeyChunk; ++c) {
        const int j = j0 + c;
        if (j < N) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot += q[d] * ks[j * HD + d];
          dot += brow[j];
          if (mrow) dot += mrow[j];
          s[c] = dot;
          cmax = fmaxf(cmax, dot);
        } else {
          s[c] = -INFINITY;
        }
      }
      const float mnew = fmaxf(mx, cmax);
      const float corr = expf(mx - mnew);  // 0 on the first chunk
      denom *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kKeyChunk; ++c) {
        const int j = j0 + c;
        if (j < N) {
          const float p = expf(s[c] - mnew);
          denom += p;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] += p * vs[j * HD + d];
        }
      }
      mx = mnew;
    }
    const float inv = 1.f / denom;
    float* orow = out + (static_cast<long long>(w) * N + i) * C + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d] = acc[d] * inv;
  }
}

template <int HD>
cudaError_t launch_window_attention(const void* qkv, const void* bias,
                                    const void* mask, void* out, int Bn, int N,
                                    int C, int nheads, int nW, float scale,
                                    cudaStream_t stream) {
  const size_t smem = 2ull * N * HD * sizeof(float);
  auto kernel = window_attention_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = ((N < 1024 ? N : 1024) + 31) / 32 * 32;
  const long long blocks = static_cast<long long>(Bn) * nheads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(out), N, C, nheads,
      nW, scale);
  return cudaGetLastError();
}

template <int HD, int NB>
cudaError_t launch_window_attention_tc(const void* qkv, const void* bias,
                                       const void* mask, void* out, int Bn,
                                       int N, int C, int nheads, int nW,
                                       float scale, cudaStream_t stream) {
  constexpr size_t smem =
      3 * sizeof(__nv_bfloat16) * NB * 8 * tc_stride<HD>();  // q, k, v
  auto kernel = window_attention_tc_kernel<HD, NB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(Bn) * nheads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int threads = (N + 15) / 16 * 32;  // a warp per 16 query rows
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), N, C,
      nheads, nW, scale);
  return cudaGetLastError();
}

// The smallest instantiation whose padded window holds N tokens.
template <int HD>
cudaError_t dispatch_tc(const void* qkv, const void* bias, const void* mask,
                        void* out, int Bn, int N, int C, int nheads, int nW,
                        float scale, cudaStream_t stream) {
#define PSALM_SWIN_CASE(NP)                                                 \
  if (N <= NP)                                                              \
    return launch_window_attention_tc<HD, NP / 8>(qkv, bias, mask, out, Bn, \
                                                  N, C, nheads, nW, scale,  \
                                                  stream);
  PSALM_SWIN_CASE(16)   // the tiny config's 4x4 windows
  PSALM_SWIN_CASE(64)   // 7x7 and 8x8 windows
  PSALM_SWIN_CASE(144)  // Swin-B's 12x12
  PSALM_SWIN_CASE(kTcMaxN)
#undef PSALM_SWIN_CASE
  return cudaErrorInvalidValue;
}

// bf16 to the tensor-core kernel, f32 to the CUDA-core one.
template <int HD>
cudaError_t launch_by_type(int dtype, const void* qkv, const void* bias,
                           const void* mask, void* out, int Bn, int N, int C,
                           int nheads, int nW, float scale,
                           cudaStream_t stream) {
  if (dtype == kBFloat16)
    return dispatch_tc<HD>(qkv, bias, mask, out, Bn, N, C, nheads, nW, scale,
                           stream);
  if (dtype == kFloat32)
    return launch_window_attention<HD>(qkv, bias, mask, out, Bn, N, C, nheads,
                                       nW, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace psalm

// qkv [Bn, N, 3C] and out [Bn, N, C] in `dtype` (bf16: 16-byte aligned, N
// <= 192); bias [nheads, N, N] f32; mask [nW, N, N] f32 or null (window w
// reads mask[w % nW]). Returns cudaGetLastError().
extern "C" int psalm_window_attention_fwd(const void* qkv, const void* bias,
                                          const void* mask, void* out,
                                          int dtype, int Bn, int N, int C,
                                          int nheads, int nW, float scale,
                                          void* stream) {
  using namespace psalm;
  if (nheads < 1 || C % nheads != 0 || nW < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (C / nheads) {
    case 16:
      return static_cast<int>(launch_by_type<16>(dtype, qkv, bias, mask, out,
                                                 Bn, N, C, nheads, nW, scale,
                                                 st));
    case 32:
      return static_cast<int>(launch_by_type<32>(dtype, qkv, bias, mask, out,
                                                 Bn, N, C, nheads, nW, scale,
                                                 st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
