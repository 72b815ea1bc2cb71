// K1: multi-scale deformable-attention sampler, forward.
//
// Replaces the TPU kernels psalm_tpu/ops/msdeform_window_pallas2.py
// (_sample_packed / _fwd_kernel) and psalm_tpu/ops/msdeform_window_pallas3.py
// (ms_deform_attn_window_pallas3 / _level_kernel), and computes the exact,
// unclamped function of psalm_tpu/ops/msdeform.py::ms_deform_attn_xla when no
// radius is given.
//
// For each (batch b, query q, head m) and each of the L*P samples (level l,
// point p): map loc to level-l pixel coordinates (x = loc_x * W_l - 0.5),
// optionally clamp the offset from the query's reference point to +-radius
// target-level pixels (c = ref + clip(coord - ref, -r, r), exactly as
// _axis_taps in psalm_tpu/ops/msdeform_window.py), take the bilinear 2x2 tap
// with zero weight for off-image corners, scale by the attention weight and
// sum. Output [B, Q, M*D] in the value dtype; accumulation in f32.
//
// What bounds it on the H100: memory latency of the gathers. At the 1024^2
// encoder shapes (S = Q = 21504, M = 8, D = 32, L = 3, P = 4) one call reads
// 172k * 12 * 4 corner rows of 64 bytes (bf16), ~0.5 GB of gathered traffic,
// against an 11 MB value tensor that stays resident in the 50 MB L2. So the
// kernel is bound by L2 gather throughput, not by HBM bandwidth or FLOPs.
//
// What the design does about it: one warp per (b, q, m) and one lane per
// channel, so each corner row is one coalesced 64-byte (bf16) or 128-byte
// (f32) read, and the 4 corners of a sample are independent loads in flight
// together. The TPU kernels' window slabs, separable one-hot matmuls and lane
// packing existed only because TPU gathers are loop-bound; a GPU gathers
// natively, so the kernel needs no window and is exact for any offset.
// Coordinate arithmetic uses the _rn intrinsics so that no multiply-add is
// contracted into an FMA: the clamp and floor then round exactly as the f32
// reference does.

#include "common.cuh"

namespace psalm {

constexpr int kMaxLevels = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <typename T, bool kClamp>
__global__ void msdeform_fwd_kernel(const T* __restrict__ value,
                                    const float* __restrict__ loc,
                                    const T* __restrict__ attn,
                                    const float* __restrict__ ref,
                                    T* __restrict__ out, int B, int S, int Q,
                                    int M, int D, int L, int P, Levels lv,
                                    float radius) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(B) * Q * M) return;
  const int m = static_cast<int>(warp % M);
  const int q = static_cast<int>((warp / M) % Q);
  const int b = static_cast<int>(warp / (static_cast<long long>(M) * Q));

  const float* loc_w = loc + warp * L * P * 2;
  const T* attn_w = attn + warp * L * P;
  const T* value_b = value + static_cast<long long>(b) * S * M * D;

  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int H = lv.h[l], W = lv.w[l];
      const T* value_l = value_b + static_cast<long long>(lv.start[l]) * M * D;
      float rx = 0.f, ry = 0.f;
      if (kClamp) {
        rx = ref[(static_cast<long long>(q) * L + l) * 2 + 0];
        ry = ref[(static_cast<long long>(q) * L + l) * 2 + 1];
      }
      for (int p = 0; p < P; ++p) {
        float x = __fsub_rn(__fmul_rn(loc_w[(l * P + p) * 2 + 0], (float)W), 0.5f);
        float y = __fsub_rn(__fmul_rn(loc_w[(l * P + p) * 2 + 1], (float)H), 0.5f);
        if (kClamp) {
          x = __fadd_rn(rx, fminf(fmaxf(__fsub_rn(x, rx), -radius), radius));
          y = __fadd_rn(ry, fminf(fmaxf(__fsub_rn(y, ry), -radius), radius));
        }
        const float x0 = floorf(x), y0 = floorf(y);
        const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
        const float gx = 1.f - fx, gy = 1.f - fy;
        // corner validity from float coordinates: no int overflow for any loc
        const bool vx0 = x0 >= 0.f && x0 < (float)W;
        const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f < (float)W;
        const bool vy0 = y0 >= 0.f && y0 < (float)H;
        const bool vy1 = y0 + 1.f >= 0.f && y0 + 1.f < (float)H;
        const int xi = vx0 || vx1 ? static_cast<int>(x0) : 0;
        const int yi = vy0 || vy1 ? static_cast<int>(y0) : 0;
        float s = 0.f;
        auto tap = [&](bool ok, int yy, int xx, float wt) {
          if (ok) {
            s += wt * to_f32(value_l[(static_cast<long long>(yy) * W + xx) * M * D +
                                     static_cast<long long>(m) * D + d]);
          }
        };
        tap(vy0 && vx0, yi, xi, gy * gx);
        tap(vy0 && vx1, yi, xi + 1, gy * fx);
        tap(vy1 && vx0, yi + 1, xi, fy * gx);
        tap(vy1 && vx1, yi + 1, xi + 1, fy * fx);
        acc += to_f32(attn_w[l * P + p]) * s;
      }
    }
    out[warp * D + d] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   const void* ref, void* out, int B, int S, int Q, int M,
                   int D, int L, int P, const Levels& lv, float radius,
                   int clamp, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps, one (b, q, m) each
  const long long warps = static_cast<long long>(B) * Q * M;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  auto* v = static_cast<const T*>(value);
  auto* lo = static_cast<const float*>(loc);
  auto* a = static_cast<const T*>(attn);
  auto* r = static_cast<const float*>(ref);
  auto* o = static_cast<T*>(out);
  if (clamp) {
    msdeform_fwd_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        v, lo, a, r, o, B, S, Q, M, D, L, P, lv, radius);
  } else {
    msdeform_fwd_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        v, lo, a, r, o, B, S, Q, M, D, L, P, lv, radius);
  }
  return cudaGetLastError();
}

}  // namespace psalm

// value [B,S,M,D] and attn [B,Q,M,L,P] in `dtype`; loc [B,Q,M,L,P,2] f32;
// ref [Q,L,2] f32 (read only when clamp != 0); out [B,Q,M*D] in `dtype`.
// shapes: host array of L (H, W) pairs. Returns cudaGetLastError().
extern "C" int psalm_msdeform_fwd(const void* value, const void* loc,
                                  const void* attn, const void* ref, void* out,
                                  int dtype, int B, int S, int Q, int M, int D,
                                  int L, int P, const void* shapes, float radius,
                                  int clamp, void* stream) {
  using namespace psalm;
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  const int* hw = static_cast<const int*>(shapes);
  Levels lv{};
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch<float>(value, loc, attn, ref, out, B, S, Q, M, D, L, P, lv,
                        radius, clamp, st);
  } else if (dtype == kBFloat16) {
    err = launch<__nv_bfloat16>(value, loc, attn, ref, out, B, S, Q, M, D, L,
                                P, lv, radius, clamp, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* psalm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
