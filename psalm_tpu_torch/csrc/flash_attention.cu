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
// 10.5 MB, bound by bytes (3.1 us). At 8 heads of 32 the S^2 h = 3.7e9
// exponentials (one per logit, about 1 ms of the SFUs) weigh as much as the
// products.
//
// Two kernels, chosen by the input's type (a fixed dispatch, not a
// fallback):
//
// bf16: flash_attention_tc_kernel, the products on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators; tensor_core.cuh).
// One block of 4 warps per (b*h, tile of 64 query rows), 16 rows a warp;
// the block walks the key/value tiles of 64 keys, copied into shared
// memory by cp.async two tiles deep, so the next tile arrives while this
// one is multiplied. q's fragments stay in registers for the whole walk.
// S = q k^T lands in f32 registers; the online softmax (running max and
// denominator per row, exp2 of log2 e-scaled logits) runs there; P is
// rounded to bf16 in registers and is the A operand of O += P v, exactly
// where the stock kernel rounds it (p.astype(v.dtype) before its dot,
// flash_attention.py:471). Tiles above the causal diagonal are skipped;
// the diagonal tile and the ragged last tile are masked to -inf (rows and
// keys past L are zero-filled by the copies). TMA and wgmma (the card's
// asynchronous warpgroup products) are later work: mma.sync's register
// layouts carry P from one product to the next without shared memory.
//
// f32: flash_attention_kernel, the products on the f32 CUDA cores, exact to
// f32 (the tiny-config checks hold the card to the CPU at 1e-5). A query
// row is owned by HD/32 neighbouring threads of one warp, each holding 32
// channels of q and of the accumulator in registers; a logit's partial dot
// products are summed across them with warp shuffles; each 32-channel slice
// of a staged key row sits at a stride of 33 floats (no bank conflicts).
//
// For training, both also write each row's log-sum-exp, lse =
// log sum_j exp(q k_j^T * sm_scale) in f32 [B*h, L], which the backward
// (flash_attention_bwd.cu) recomputes the probabilities from, as the stock
// kernel saves its l and m for its backward.

#include "common.cuh"
#include "tensor_core.cuh"

namespace psalm {

// ---- bf16, tensor cores ----------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block
constexpr int kTcKeys = 64;             // keys per staged tile
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
constexpr size_t tc_smem_bytes() {  // q, then two (k, v) tiles
  return sizeof(__nv_bfloat16) * (HD + kPad) * (kTcRows + 4 * kTcKeys);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ lse, int L,
                              float scale_log2, int causal) {
  constexpr int kStride = HD + kPad;
  constexpr int kDepth = HD / 16;       // k-steps of q k^T
  constexpr int kSBlocks = kTcKeys / 8;  // 8-key column blocks of S
  constexpr int kOBlocks = HD / 8;       // 8-channel column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [rows, stride]
  __nv_bfloat16* ks = qs + kTcRows * kStride;  // [2][keys, stride]
  __nv_bfloat16* vs = ks + 2 * kTcKeys * kStride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = blockIdx.y;
  const int q0 = blockIdx.x * kTcRows;
  const __nv_bfloat16* kh = k + head * L * HD;
  const __nv_bfloat16* vh = v + head * L * HD;

  const int kv_end = causal ? min(L, q0 + kTcRows) : L;
  const int tiles = (kv_end + kTcKeys - 1) / kTcKeys;
  load_rows_async<HD, kTcRows, kTcThreads>(qs, q + head * L * HD, q0, L);
  load_rows_async<HD, kTcKeys, kTcThreads>(ks, kh, 0, L);
  load_rows_async<HD, kTcKeys, kTcThreads>(vs, vh, 0, L);
  cp_async_commit();

  uint32_t qf[kDepth][4];
  float o[kOBlocks][4];
  zero<kOBlocks>(o);
  // per thread, rows g and g + 8 of the warp's 16; mx in log2 units
  float mx[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;

  for (int j = 0; j < tiles; ++j) {
    const int j0 = j * kTcKeys;
    const int buf = j & 1;
    if (j + 1 < tiles) {  // the next tile's copies fly during this tile
      const int nxt = (buf ^ 1) * kTcKeys * kStride;
      load_rows_async<HD, kTcKeys, kTcThreads>(ks + nxt, kh, j0 + kTcKeys, L);
      load_rows_async<HD, kTcKeys, kTcThreads>(vs + nxt, vh, j0 + kTcKeys, L);
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
      }
    }
    const __nv_bfloat16* kt = ks + buf * kTcKeys * kStride;
    const __nv_bfloat16* vt = vs + buf * kTcKeys * kStride;

    float s[kSBlocks][4];
    zero<kSBlocks>(s);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
#pragma unroll
      for (int b = 0; b < kSBlocks; b += 2) {
        uint32_t kb[4];
        load_b_rows(kb, kt, kStride, b * 8, d * 16);
        mma_bf16(s[b], qf[d], kb[0], kb[1]);
        mma_bf16(s[b + 1], qf[d], kb[2], kb[3]);
      }
    }
    // keys past L, and past the row on the causal diagonal, to -inf
    if (j0 + kTcKeys > L || (causal && j0 + kTcKeys > q0)) {
#pragma unroll
      for (int b = 0; b < kSBlocks; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + b * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= L || (causal && key > row)) s[b][e] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int b = 0; b < kSBlocks; ++b)
        tmax = fmaxf(tmax, fmaxf(s[b][2 * r], s[b][2 * r + 1]));
      const float mnew = fmaxf(mx[r], quad_max(tmax) * scale_log2);
      // -inf while the row has met no key yet: then every p and corr is 0
      const float base = mnew == -INFINITY ? 0.f : mnew;
      const float corr = exp2f(mx[r] - base);
      mx[r] = mnew;
      den[r] *= corr;
#pragma unroll
      for (int b = 0; b < kOBlocks; ++b) {
        o[b][2 * r] *= corr;
        o[b][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int b = 0; b < kSBlocks; ++b) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[b][e] = exp2f(fmaf(s[b][e], scale_log2, -base));  // 0 where masked
          den[r] += s[b][e];
        }
      }
    }
    // O += P v: P's C fragments, rounded to bf16, are the A operand
#pragma unroll
    for (int c = 0; c < kTcKeys / 16; ++c) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int b = 0; b < kOBlocks; b += 2) {
        uint32_t vb[4];
        load_b_cols(vb, vt, kStride, b * 8, c * 16);
        mma_bf16(o[b], pa, vb[0], vb[1]);
        mma_bf16(o[b + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this tile's buffers are free for the copy after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = quad_sum(den[r]);  // each lane summed its columns
    const int row = row0 + r * 8;
    if (row < L) {
      const float inv = 1.f / total;
      __nv_bfloat16* orow = out + (head * L + row) * HD + 2 * t;
#pragma unroll
      for (int b = 0; b < kOBlocks; ++b) {
        *reinterpret_cast<__nv_bfloat162*>(orow + b * 8) =
            __floats2bfloat162_rn(o[b][2 * r] * inv, o[b][2 * r + 1] * inv);
      }
      if (lse != nullptr && t == 0) {
        lse[head * L + row] = (mx[r] + log2f(total)) * kLn2;
      }
    }
  }
}

template <int HD>
cudaError_t launch_flash_attention_tc(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int BH, int L, int causal, float scale,
                                      cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  auto kernel = flash_attention_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (BH == 0 || L == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((L + kTcRows - 1) / kTcRows, BH);
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, L, scale * log2e, causal);
  return cudaGetLastError();
}

// ---- f32, CUDA cores -------------------------------------------------------

constexpr int kRows = 64;       // query rows per block
constexpr int kCols = 64;       // keys per staged tile
constexpr int kChunk = 16;      // logits per online-softmax step
constexpr int kSlice = 32;      // channels per thread
constexpr int kSliceStride = 33;  // floats between slices in shared memory

template <int HD>
__global__ void flash_attention_kernel(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       float* __restrict__ out,
                                       float* __restrict__ lse, int L,
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
  const float* qh = q + head * L * HD;
  const float* kh = k + head * L * HD;
  const float* vh = v + head * L * HD;

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
      ks[at] = kh[src];
      vs[at] = vh[src];
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
    float* orow = out + (head * L + row) * HD + part * kSlice;
#pragma unroll
    for (int d = 0; d < kSlice; ++d) orow[d] = acc[d] * inv;
    // mx and the logits are in log2 units (q pre-scaled by log2 e)
    if (lse != nullptr && part == 0) {
      lse[head * L + row] = (mx + log2f(denom)) * 0.6931471805599453f;
    }
  }
}

template <int HD>
cudaError_t launch_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, float* lse, int BH, int L,
                                   int causal, float scale,
                                   cudaStream_t stream) {
  constexpr int kParts = HD / kSlice;
  const size_t smem = 2ull * kCols * kParts * kSliceStride * sizeof(float);
  auto kernel = flash_attention_kernel<HD>;
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
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, L,
      scale * log2e, causal);
  return cudaGetLastError();
}

// bf16 to the tensor-core kernel, f32 to the CUDA-core one.
template <int HD>
cudaError_t launch_by_type(int dtype, const void* q, const void* k,
                           const void* v, void* out, float* lse, int BH, int L,
                           int causal, float scale, cudaStream_t stream) {
  if (dtype == kBFloat16) {
    return launch_flash_attention_tc<HD>(q, k, v, out, lse, BH, L, causal,
                                         scale, stream);
  }
  if (dtype == kFloat32) {
    return launch_flash_attention<HD>(q, k, v, out, lse, BH, L, causal, scale,
                                      stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace psalm

// q, k, v and out [BH, L, hd] contiguous in `dtype`, 16-byte aligned; hd 32,
// 64 or 128. lse [BH, L] f32, or null when the caller needs no backward.
// Returns cudaGetLastError().
extern "C" int psalm_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int dtype, int BH, int L, int hd,
                                         int causal, float scale,
                                         void* stream) {
  using namespace psalm;
  if (BH < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  switch (hd) {
    case 32:
      err = launch_by_type<32>(dtype, q, k, v, out, l, BH, L, causal, scale,
                               st);
      break;
    case 64:
      err = launch_by_type<64>(dtype, q, k, v, out, l, BH, L, causal, scale,
                               st);
      break;
    case 128:
      err = launch_by_type<128>(dtype, q, k, v, out, l, BH, L, causal, scale,
                                st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
