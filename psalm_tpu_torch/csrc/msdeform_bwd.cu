// K2: multi-scale deformable-attention sampler, backward.
//
// The gradient of K1 (msdeform.cu). It computes what AD of
// psalm_tpu/ops/msdeform.py::ms_deform_attn_xla computes and, with a clamp
// radius, the VJP of psalm_tpu/ops/msdeform_window.py::ms_deform_attn_window
// (_group_sample_cvjp.f_bwd, whose Pallas op psalm_tpu/ops/
// msdeform_window_pallas2.py::_op_bwd takes it as its own backward). For
// each (batch b, query q, head m) and sample (level l, point p), with the
// upstream gradient g = d out[b, q, m, :], the attention weight a and the
// bilinear tap of sample_taps (msdeform_common.cuh, shared with K1):
//   d value[corner, m, :] += g * a * w_corner      (each corner on the image)
//   d attn                 = sum_d g_d * sample_d
//   d loc_x = W * a * sum_d g_d * (gy (v01 - v00) + fy (v11 - v10))
//   d loc_y = H * a * sum_d g_d * (gx (v10 - v00) + fx (v11 - v01))
// where off-image corners read as zero, so they give nothing to any
// gradient; with a radius, d loc is zero on an axis whose offset the clamp
// clipped (the dcl gate). d value is accumulated in an f32 buffer [B, S, M,
// D] that the caller zeroes and rounds to the value's type once; d loc is
// f32 and d attn in the value's type.
//
// What bounds it on the H100: the scatter. At the 1024^2 encoder shapes (Q =
// S = 21504, M = 8, D = 32, L = 3, P = 4) a call makes Q*M*L*P*4*D = 264 M
// f32 atomic adds into a 22 MB buffer that stays in the 50 MB L2, against
// about 75-115 MB of inputs and outputs (0.02-0.03 ms at 3.35 TB/s); the
// atomics' throughput in L2, not the bytes, sets its time.
//
// What the design does about it: K1's layout, one warp per (b, q, m) and one
// lane per channel, so each corner's 32 atomic adds go to 32 neighbouring
// floats (one coalesced red.global per corner) and the four corners' reads
// of value are independent loads in flight together. The three per-sample
// sums over channels (d attn and the two d loc) are warp shuffles. The
// order of the atomic adds varies from run to run, so d value agrees with a
// plain version to f32 rounding of its sums, not bit for bit.

#include "msdeform_common.cuh"

namespace psalm {

template <typename T, bool kClamp>
__global__ void msdeform_bwd_kernel(const T* __restrict__ value,
                                    const float* __restrict__ loc,
                                    const T* __restrict__ attn,
                                    const float* __restrict__ ref,
                                    const T* __restrict__ grad_out,
                                    float* __restrict__ grad_value,
                                    float* __restrict__ grad_loc,
                                    T* __restrict__ grad_attn, int B, int S,
                                    int Q, int M, int D, int L, int P,
                                    Levels lv, float radius) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // a whole warp leaves together (blocks are whole warps), so the shuffles
  // below always see 32 lanes
  if (warp >= static_cast<long long>(B) * Q * M) return;
  const int m = static_cast<int>(warp % M);
  const int q = static_cast<int>((warp / M) % Q);
  const int b = static_cast<int>(warp / (static_cast<long long>(M) * Q));

  const float* loc_w = loc + warp * L * P * 2;
  const T* attn_w = attn + warp * L * P;
  const T* g_w = grad_out + warp * D;
  float* gloc_w = grad_loc + warp * L * P * 2;
  T* gattn_w = grad_attn + warp * L * P;
  const long long row = static_cast<long long>(M) * D;  // one pixel's stride

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const long long level =
        (static_cast<long long>(b) * S + lv.start[l]) * row +
        static_cast<long long>(m) * D;
    float rx = 0.f, ry = 0.f;
    if (kClamp) {
      rx = ref[(static_cast<long long>(q) * L + l) * 2 + 0];
      ry = ref[(static_cast<long long>(q) * L + l) * 2 + 1];
    }
    for (int p = 0; p < P; ++p) {
      const Taps t = sample_taps<kClamp>(loc_w[(l * P + p) * 2 + 0],
                                         loc_w[(l * P + p) * 2 + 1], H, W, rx,
                                         ry, radius);
      const float fx = t.fx, fy = t.fy;
      const float gx = 1.f - fx, gy = 1.f - fy;
      const bool ok00 = t.vy0 && t.vx0, ok01 = t.vy0 && t.vx1;
      const bool ok10 = t.vy1 && t.vx0, ok11 = t.vy1 && t.vx1;
      // each offset is read or written only when its corner is on the image
      const long long r00 =
          level + (static_cast<long long>(t.yi) * W + t.xi) * row;
      const long long r01 = r00 + row;
      const long long r10 = r00 + static_cast<long long>(W) * row;
      const long long r11 = r10 + row;
      const float a = to_f32(attn_w[l * P + p]);
      const float w00 = gy * gx, w01 = gy * fx, w10 = fy * gx, w11 = fy * fx;
      float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float g = to_f32(g_w[d]);
        const float v00 = ok00 ? to_f32(value[r00 + d]) : 0.f;
        const float v01 = ok01 ? to_f32(value[r01 + d]) : 0.f;
        const float v10 = ok10 ? to_f32(value[r10 + d]) : 0.f;
        const float v11 = ok11 ? to_f32(value[r11 + d]) : 0.f;
        s_attn += g * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
        s_x += g * (gy * (v01 - v00) + fy * (v11 - v10));
        s_y += g * (gx * (v10 - v00) + fx * (v11 - v01));
        const float ga = g * a;
        if (ok00) atomicAdd(grad_value + r00 + d, ga * w00);
        if (ok01) atomicAdd(grad_value + r01 + d, ga * w01);
        if (ok10) atomicAdd(grad_value + r10 + d, ga * w10);
        if (ok11) atomicAdd(grad_value + r11 + d, ga * w11);
      }
      s_attn = warp_sum(s_attn);
      s_x = warp_sum(s_x);
      s_y = warp_sum(s_y);
      if (lane == 0) {
        gattn_w[l * P + p] = from_f32<T>(s_attn);
        gloc_w[(l * P + p) * 2 + 0] = t.pass_x ? a * s_x * (float)W : 0.f;
        gloc_w[(l * P + p) * 2 + 1] = t.pass_y ? a * s_y * (float)H : 0.f;
      }
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* value, const void* loc, const void* attn,
                       const void* ref, const void* grad_out, void* grad_value,
                       void* grad_loc, void* grad_attn, int B, int S, int Q,
                       int M, int D, int L, int P, const Levels& lv,
                       float radius, int clamp, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps, one (b, q, m) each
  const long long warps = static_cast<long long>(B) * Q * M;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  auto* v = static_cast<const T*>(value);
  auto* lo = static_cast<const float*>(loc);
  auto* a = static_cast<const T*>(attn);
  auto* r = static_cast<const float*>(ref);
  auto* g = static_cast<const T*>(grad_out);
  auto* gv = static_cast<float*>(grad_value);
  auto* gl = static_cast<float*>(grad_loc);
  auto* ga = static_cast<T*>(grad_attn);
  if (clamp) {
    msdeform_bwd_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        v, lo, a, r, g, gv, gl, ga, B, S, Q, M, D, L, P, lv, radius);
  } else {
    msdeform_bwd_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        v, lo, a, r, g, gv, gl, ga, B, S, Q, M, D, L, P, lv, radius);
  }
  return cudaGetLastError();
}

}  // namespace psalm

// value [B,S,M,D], attn [B,Q,M,L,P] and grad_out [B,Q,M*D] in `dtype`; loc
// [B,Q,M,L,P,2] f32; ref [Q,L,2] f32 (read only when clamp != 0).
// grad_value [B,S,M,D] f32, zeroed by the caller (accumulated with atomics);
// grad_loc [B,Q,M,L,P,2] f32 and grad_attn [B,Q,M,L,P] in `dtype`, each
// element written once. shapes: host array of L (H, W) pairs. Returns
// cudaGetLastError().
extern "C" int psalm_msdeform_bwd(const void* value, const void* loc,
                                  const void* attn, const void* ref,
                                  const void* grad_out, void* grad_value,
                                  void* grad_loc, void* grad_attn, int dtype,
                                  int B, int S, int Q, int M, int D, int L,
                                  int P, const void* shapes, float radius,
                                  int clamp, void* stream) {
  using namespace psalm;
  Levels lv{};
  if (!make_levels(shapes, L, S, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch_bwd<float>(value, loc, attn, ref, grad_out, grad_value,
                            grad_loc, grad_attn, B, S, Q, M, D, L, P, lv,
                            radius, clamp, st);
  } else if (dtype == kBFloat16) {
    err = launch_bwd<__nv_bfloat16>(value, loc, attn, ref, grad_out,
                                    grad_value, grad_loc, grad_attn, B, S, Q,
                                    M, D, L, P, lv, radius, clamp, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
