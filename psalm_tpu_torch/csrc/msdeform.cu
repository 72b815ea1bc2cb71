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
// sum. Output [B, Q, M*D] in the value dtype; accumulation in f32, rounded
// once.
//
// What bounds it on the H100: the gathers' latency and L2 traffic. At the
// 1024^2 encoder shapes (S = Q = 21504, M = 8, D = 32, L = 3, P = 4) one
// call reads 172k * 12 * 4 corner rows of 64 bytes (bf16), 528 MB of sectors
// from an 11 MB value tensor that stays in the 50 MB L2, against 24 MB of
// bytes that must move through HBM. So L2 and the latency of dependent
// gathers set its pace, not HBM bandwidth or FLOPs.
//
// What the design does about it: a thread per (b, q, m, 16-byte channel
// vector): 4 threads a head in bf16 (8 channels each), and a warp the 8
// heads of one query, so each corner read is one 16-byte ld.global.nc and
// the warp's output one contiguous 512-byte run of 16-byte stores. The
// kernel is templated on L and P, with an instantiation for the model's
// L = 3, P = 4 whose sample loop unrolls: a level's loc (two float4) and
// attention weights (one vector) are read once per thread, its four taps
// computed first and then its 16 corner loads issued together, so they
// are in flight at once (a level at a time keeps the registers low enough
// for several blocks an SM, with no spills). Queries go in S order,
// so neighbouring warps of a block sample neighbouring pixels and share
// corners in L1. Any other L <= 8 and P run the generic instantiation of
// the same kernel (runtime loops, a sample's four loads at a time), and a
// D * elt that is no multiple of 16 bytes, or an unaligned pointer, the
// single-channel one. The coordinates, clamp and corner validity come from
// sample_taps (msdeform_common.cuh), which the backward K2 shares.

#include "msdeform_common.cuh"

namespace psalm {

// One level's samples for one thread: acc += a * w_corner * value[corner]
// over the level's points, with kP of them known at compile time (their
// loads issued together) or, for kP == 0, P at run time.
template <typename T, int kV, int kP, bool kClamp>
__device__ __forceinline__ void sample_level(
    const T* vl, int MD, int H, int W, const float* loc_l, const T* attn_l,
    int P, float rx, float ry, float radius, bool active, float (&acc)[kV]) {
  using V = Vec<T, kV>;
  if constexpr (kP > 0) {
    float lc[2 * kP], a[kP];
    if (active) {
      load_loc<kP>(loc_l, lc);
      load_attn<T, kP>(attn_l, a);
    } else {
#pragma unroll
      for (int i = 0; i < kP; ++i) lc[2 * i] = lc[2 * i + 1] = a[i] = 0.f;
    }
    Corners c[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      c[p] = corners_of(sample_taps<kClamp>(lc[2 * p], lc[2 * p + 1], H, W,
                                            rx, ry, radius), W, a[p]);
    }
    typename V::Raw raw[kP][4];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        raw[p][k] = active && c[p].ok[k] ? V::load(vl + c[p].pix[k] * MD)
                                         : typename V::Raw{};
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float f[kV];
        V::unpack(raw[p][k], f);
#pragma unroll
        for (int e = 0; e < kV; ++e) acc[e] = fmaf(c[p].w[k], f[e], acc[e]);
      }
    }
  } else {
    if (!active) return;
    for (int p = 0; p < P; ++p) {
      const Corners c = corners_of(
          sample_taps<kClamp>(loc_l[2 * p], loc_l[2 * p + 1], H, W, rx, ry,
                              radius), W, to_f32(attn_l[p]));
      typename V::Raw raw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        raw[k] = c.ok[k] ? V::load(vl + c.pix[k] * MD) : typename V::Raw{};
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float f[kV];
        V::unpack(raw[k], f);
#pragma unroll
        for (int e = 0; e < kV; ++e) acc[e] = fmaf(c.w[k], f[e], acc[e]);
      }
    }
  }
}

// kL, kP: the model's 3 and 4, or 0 for run-time L and P.
template <typename T, int kV, int kL, int kP, bool kClamp>
__global__ void __launch_bounds__(256) msdeform_fwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const T* __restrict__ attn, const float* __restrict__ ref,
    T* __restrict__ out, long long threads, int S, int Q, int M, int D, int L,
    int P, int tph_shift, Levels lv, float radius) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long head = t >> tph_shift;  // (b * Q + q) * M + m
  const int d0 = static_cast<int>(t & ((1 << tph_shift) - 1)) * kV;
  const bool active = t < threads && d0 < D;
  const int m = static_cast<int>(head % M);
  const long long bq = head / M;
  const int q = static_cast<int>(bq % Q);
  const long long b = bq / Q;
  const int MD = M * D;
  const int nL = kL > 0 ? kL : L, nP = kP > 0 ? kP : P;
  const float* loc_h = loc + head * nL * nP * 2;
  const T* attn_h = attn + head * nL * nP;
  const T* value_b = value + b * S * MD + m * D + d0;

  float acc[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) acc[e] = 0.f;
  const auto run_level = [&](int l) {
    float rx = 0.f, ry = 0.f;
    if (kClamp && active) {
      rx = __ldg(ref + (q * nL + l) * 2);
      ry = __ldg(ref + (q * nL + l) * 2 + 1);
    }
    sample_level<T, kV, kP, kClamp>(value_b + lv.start[l] * MD, MD, lv.h[l],
                                    lv.w[l], loc_h + l * nP * 2,
                                    attn_h + l * nP, nP, rx, ry, radius,
                                    active, acc);
  };
  if constexpr (kL > 0) {
#pragma unroll
    for (int l = 0; l < kL; ++l) run_level(l);
  } else {
#pragma unroll 1
    for (int l = 0; l < L; ++l) run_level(l);
  }
  if (active) Vec<T, kV>::store(out + head * D + d0, acc);
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   const void* ref, void* out, int B, int S, int Q, int M,
                   int D, int L, int P, const Levels& lv, float radius,
                   int clamp, cudaStream_t stream) {
  Layout lay;
  const auto addr = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p);
  };
  if (!choose_layout(D, sizeof(T), S, M, addr(value) | addr(out), &lay)) {
    return cudaErrorInvalidValue;
  }
  constexpr int kThreads = 256;
  const long long threads = (static_cast<long long>(B) * Q * M) << lay.tph_shift;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  with_instantiation<T>(lay, L, P, loc, attn, clamp,
                        [&](auto v, auto l, auto p, auto c) {
    msdeform_fwd_kernel<T, decltype(v)::value, decltype(l)::value,
                        decltype(p)::value, decltype(c)::value>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const T*>(value), static_cast<const float*>(loc),
            static_cast<const T*>(attn), static_cast<const float*>(ref),
            static_cast<T*>(out), threads, S, Q, M, D, L, P, lay.tph_shift,
            lv, radius);
  });
  return cudaGetLastError();
}

}  // namespace psalm

// value [B,S,M,D] and attn [B,Q,M,L,P] in `dtype`; loc [B,Q,M,L,P,2] f32;
// ref [Q,L,2] f32 (read only when clamp != 0); out [B,Q,M*D] in `dtype`.
// shapes: host array of L (H, W) pairs. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes the kernel does not take (a head wider
// than 32 threads, a batch of more than INT_MAX value elements).
extern "C" int psalm_msdeform_fwd(const void* value, const void* loc,
                                  const void* attn, const void* ref, void* out,
                                  int dtype, int B, int S, int Q, int M, int D,
                                  int L, int P, const void* shapes, float radius,
                                  int clamp, void* stream) {
  using namespace psalm;
  Levels lv{};
  if (!make_levels(shapes, L, S, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
