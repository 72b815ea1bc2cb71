// K3: Swin window-attention core, forward.
//
// Replaces the TPU kernel psalm_tpu/ops/swin_attention_pallas.py
// (_forward / _kernel / _kernel_nomask, entry fused_window_attention): per
// window w and head h, split q, k, v out of the packed [N, 3C] rows, take
// softmax(q k^T * scale + bias[h] (+ mask[w % nW])) in f32, multiply by v,
// and write the head's columns of the [Bn, N, C] output.
//
// What bounds it on the H100: at Swin-B's shapes (N = 144 tokens per 12x12
// window, head dim 32) one (window, head) is 144 x 144 x 32 x 2 multiply-adds,
// about 1.3 MFLOP, against 27 KB of bf16 q/k/v and an 83 KB f32 bias slice
// that every window of a head shares (L2-resident). The work is small per
// block and plentiful across blocks (1936 blocks at stage 0 of a 1024^2
// image); this first version does it on the f32 CUDA cores, so it is bound by
// FP32 issue rate rather than by memory.
//
// What the design does about it: one block per (window, head), so the
// [N, N] attention matrix lives only in registers and never reaches device
// memory (the plain PyTorch version writes and re-reads it in f32). k and v
// of the head are staged once in shared memory as f32 and read by every
// query row as warp-wide broadcasts (no bank conflicts). One thread owns one
// query row and runs a chunked online softmax over the keys (16 scores per
// chunk, one rescale of the accumulator per chunk). Moving the two products
// onto the tensor cores (mma/wgmma) is later work.

#include "common.cuh"

namespace psalm {

constexpr int kKeyChunk = 16;

template <typename T, int HD>
__global__ void window_attention_kernel(const T* __restrict__ qkv,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask,
                                        T* __restrict__ out, int N, int C,
                                        int nheads, int nW, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;           // [N, HD]
  float* vs = smem + N * HD;  // [N, HD]
  const int w = blockIdx.x / nheads;
  const int h = blockIdx.x % nheads;
  const long long row_stride = 3LL * C;
  const T* rows = qkv + static_cast<long long>(w) * N * row_stride;

  for (int e = threadIdx.x; e < N * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    ks[e] = to_f32(rows[r * row_stride + C + h * HD + d]);
    vs[e] = to_f32(rows[r * row_stride + 2 * C + h * HD + d]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float q[HD], acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] = to_f32(rows[i * row_stride + h * HD + d]) * scale;
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
    T* orow = out + (static_cast<long long>(w) * N + i) * C + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_window_attention(const void* qkv, const void* bias,
                                    const void* mask, void* out, int Bn, int N,
                                    int C, int nheads, int nW, float scale,
                                    cudaStream_t stream) {
  const size_t smem = 2ull * N * HD * sizeof(float);
  auto kernel = window_attention_kernel<T, HD>;
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
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), N, C, nheads, nW,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int hd, const void* qkv, const void* bias,
                              const void* mask, void* out, int Bn, int N,
                              int C, int nheads, int nW, float scale,
                              cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_window_attention<T, 16>(qkv, bias, mask, out, Bn, N, C,
                                            nheads, nW, scale, stream);
    case 32:
      return launch_window_attention<T, 32>(qkv, bias, mask, out, Bn, N, C,
                                            nheads, nW, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace psalm

// qkv [Bn, N, 3C] and out [Bn, N, C] in `dtype`; bias [nheads, N, N] f32;
// mask [nW, N, N] f32 or null (window w reads mask[w % nW]).
// Returns cudaGetLastError().
extern "C" int psalm_window_attention_fwd(const void* qkv, const void* bias,
                                          const void* mask, void* out,
                                          int dtype, int Bn, int N, int C,
                                          int nheads, int nW, float scale,
                                          void* stream) {
  using namespace psalm;
  if (nheads < 1 || C % nheads != 0 || nW < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hd = C / nheads;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = dispatch_head_dim<float>(hd, qkv, bias, mask, out, Bn, N, C, nheads,
                                   nW, scale, st);
  } else if (dtype == kBFloat16) {
    err = dispatch_head_dim<__nv_bfloat16>(hd, qkv, bias, mask, out, Bn, N, C,
                                           nheads, nW, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
