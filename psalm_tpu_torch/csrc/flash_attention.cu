// K5: softmax attention, causal or not, forward, without the [L, L] logits.
//
// Replaces the stock TPU kernel jax.experimental.pallas.ops.tpu
// .flash_attention as psalm_tpu calls it: causal over Phi's full sequence
// (psalm_tpu/models/phi.py, PhiAttention's use_flash branch; B=1, 32 heads
// of 64, L = 640 on the eval batch) and non-causal over the pixel decoder's
// S = 21504 encoder tokens (psalm_tpu/models/pixel_decoder.py,
// DenseSelfAttention; 8 heads of 32, or 2 of 128). Per (batch, head):
// out = softmax(q k^T * sm_scale (+ causal mask)) v, with logits, softmax
// and the accumulator in f32 and the output in the input's type.
//
// What bounds it on the H100: at S = 21504 one call is 4 S^2 h hd = 4.7e11
// FLOP against 5.5 MB of bf16 q/k/v/out, so it is bound by operations (0.48
// ms at the bf16 tensor-core peak); Phi's L = 640 call is 1.7 GFLOP against
// 10.5 MB, bound by bytes (3.1 us). This first version does the products on
// the f32 CUDA cores (67 TFLOP/s peak), so it sits well above both bounds.
//
// What the design does about it: one block per (b*h, tile of kRows query
// rows). The block walks the key/value tiles of kCols keys, staging each in
// shared memory as f32, and keeps an online softmax per query row (running
// max, running denominator, rescaled accumulator), so the logits never reach
// device memory. With `causal`, the block stops at its last query row's
// diagonal, skipping every tile above it. A query row is owned by HD/32
// neighbouring threads of one warp, each holding 32 channels of q and of the
// accumulator in registers; a logit's partial dot products are summed across
// them with warp shuffles. Each 32-channel slice of a staged row sits at a
// stride of 33 floats, so the HD/32 slices that one warp reads at once lie
// in different banks. Tensor cores (mma/wgmma) and TMA are later work.

#include "common.cuh"

namespace psalm {

constexpr int kRows = 64;       // query rows per block
constexpr int kCols = 64;       // keys per staged tile
constexpr int kChunk = 16;      // logits per online-softmax step
constexpr int kSlice = 32;      // channels per thread
constexpr int kSliceStride = 33;  // floats between slices in shared memory

template <typename T, int HD>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int L,
                                       float scale_log2, int causal) {
  constexpr int kParts = HD / kSlice;  // threads per query row
  constexpr int kRowStride = kParts * kSliceStride;
  extern __shared__ float smem[];
  float* ks = smem;                     // [kCols, kRowStride]
  float* vs = smem + kCols * kRowStride;  // [kCols, kRowStride]

  const long long head = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int row = q0 + threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const T* qh = q + head * L * HD;
  const T* kh = k + head * L * HD;
  const T* vh = v + head * L * HD;

  // q pre-scaled by sm_scale * log2(e): the softmax runs on exp2
  float qr[kSlice], acc[kSlice];
  const bool live = row < L;
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    qr[d] = live ? to_f32(qh[static_cast<long long>(row) * HD + part * kSlice + d])
                       * scale_log2
                 : 0.f;
    acc[d] = 0.f;
  }
  float mx = -INFINITY, denom = 0.f;

  const int kv_end = causal ? min(L, q0 + kRows) : L;
  for (int j0 = 0; j0 < kv_end; j0 += kCols) {
    const int n = min(kCols, kv_end - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < n * HD; e += blockDim.x) {
      const int r = e / HD, c = e % HD;
      const int at = r * kRowStride + (c / kSlice) * kSliceStride + c % kSlice;
      const long long src = static_cast<long long>(j0 + r) * HD + c;
      ks[at] = to_f32(kh[src]);
      vs[at] = to_f32(vh[src]);
    }
    __syncthreads();

    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int jj = c0 + c;
        float dot = 0.f;
        if (jj < n) {  // uniform across the block
          const float* kr = ks + jj * kRowStride + part * kSliceStride;
#pragma unroll
          for (int d = 0; d < kSlice; ++d) dot += qr[d] * kr[d];
        }
#pragma unroll
        for (int off = 1; off < kParts; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int j = j0 + jj;
        const bool masked = jj >= n || (causal && j > row);
        s[c] = masked ? -INFINITY : dot;
        cmax = fmaxf(cmax, s[c]);
      }
      const float mnew = fmaxf(mx, cmax);
      // -inf while the row has met no key yet: then every p and corr is 0
      const float base = mnew == -INFINITY ? 0.f : mnew;
      const float corr = exp2f(mx - base);  // 0 on the row's first keys
      denom *= corr;
#pragma unroll
      for (int d = 0; d < kSlice; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = exp2f(s[c] - base);  // 0 where masked
        denom += p;
        if (c0 + c < n) {
          const float* vr = vs + (c0 + c) * kRowStride + part * kSliceStride;
#pragma unroll
          for (int d = 0; d < kSlice; ++d) acc[d] += p * vr[d];
        }
      }
      mx = mnew;
    }
  }

  if (live) {
    const float inv = 1.f / denom;
    T* orow = out + (head * L + row) * HD + part * kSlice;
#pragma unroll
    for (int d = 0; d < kSlice; ++d) orow[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int BH, int L, int causal,
                                   float scale, cudaStream_t stream) {
  constexpr int kParts = HD / kSlice;
  const size_t smem = 2ull * kCols * kParts * kSliceStride * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (BH == 0 || L == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((L + kRows - 1) / kRows, BH);
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, kRows * kParts, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), L, scale * log2e,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int hd, const void* q, const void* k,
                              const void* v, void* out, int BH, int L,
                              int causal, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_flash_attention<T, 32>(q, k, v, out, BH, L, causal, scale,
                                           stream);
    case 64:
      return launch_flash_attention<T, 64>(q, k, v, out, BH, L, causal, scale,
                                           stream);
    case 128:
      return launch_flash_attention<T, 128>(q, k, v, out, BH, L, causal, scale,
                                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace psalm

// q, k, v and out [BH, L, hd] contiguous in `dtype`; hd 32, 64 or 128.
// Returns cudaGetLastError().
extern "C" int psalm_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, int dtype,
                                         int BH, int L, int hd, int causal,
                                         float scale, void* stream) {
  using namespace psalm;
  if (BH < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = dispatch_head_dim<float>(hd, q, k, v, out, BH, L, causal, scale, st);
  } else if (dtype == kBFloat16) {
    err = dispatch_head_dim<__nv_bfloat16>(hd, q, k, v, out, BH, L, causal,
                                           scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
