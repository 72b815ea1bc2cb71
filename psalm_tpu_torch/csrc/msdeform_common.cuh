// What the deformable sampler's forward (K1, msdeform.cu) and backward (K2,
// msdeform_bwd.cu) share: the level table, one sample's bilinear taps (so
// that the two kernels round every coordinate the same way), the thread
// layout and its choice, and the channel vectors a thread loads.
#pragma once

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace psalm {

constexpr int kMaxLevels = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// The level table from L host (H, W) pairs; false when L is out of range or
// the levels do not add up to S.
inline bool make_levels(const void* shapes, int L, int S, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return false;
  const int* hw = static_cast<const int*>(shapes);
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = hw[2 * l];
    lv->w[l] = hw[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start == S;
}

// The clamp radius of each sampling point, passed by value among the
// kernel's parameters (no device buffer, no copy a call): point p's offset
// from its reference point is clipped to +-r[p] on each axis, as
// psalm_tpu/ops/msdeform_window.py takes a length-P radius (:351-361). A
// flat radius is the same vector filled with one value.
constexpr int kMaxPoints = 32;

struct Radii {
  float r[kMaxPoints];
};

// The P radii from a host array; an unclamped launch passes none (nullptr)
// and its kernels never read them. False when P is out of range.
inline bool make_radii(const void* radii, int P, Radii* rd) {
  if (radii == nullptr) return true;
  if (P < 1 || P > kMaxPoints) return false;
  const float* r = static_cast<const float*>(radii);
  for (int p = 0; p < P; ++p) rd->r[p] = r[p];
  return true;
}

// One sample's 2x2 tap in level pixels.
struct Taps {
  float fx, fy;              // fractions past the top-left corner
  int xi, yi;                // top-left corner (0 on an axis with no corner on the image)
  bool vx0, vx1, vy0, vy1;   // corner columns / rows on the image
  bool pass_x, pass_y;       // the clamp passed the coordinate (it carries a gradient)
};

// x = loc_x * W - 0.5 (and y likewise); with kClamp the offset from the
// reference point (rx, ry) is clipped to +-radius, point p's radius
// radii.r[p], first, exactly as
// psalm_tpu/ops/msdeform_window.py::_axis_taps does: c = ref + clip(coord -
// ref, -r, r), floor, corner validity from global coordinates, and
// pass = |coord - ref| <= r (its gradient gate dcl). The _rn intrinsics keep
// any multiply-add from being contracted into an FMA, so the clamp and the
// floor round exactly as the f32 reference does. Validity is taken from the
// float coordinates: no int overflow for any loc.
template <bool kClamp>
__device__ __forceinline__ Taps sample_taps(float loc_x, float loc_y, int H,
                                            int W, float rx, float ry,
                                            const Radii& radii, int p) {
  float x = __fsub_rn(__fmul_rn(loc_x, (float)W), 0.5f);
  float y = __fsub_rn(__fmul_rn(loc_y, (float)H), 0.5f);
  Taps t;
  t.pass_x = t.pass_y = true;
  if (kClamp) {
    const float radius = radii.r[p];
    const float dx = __fsub_rn(x, rx), dy = __fsub_rn(y, ry);
    t.pass_x = dx >= -radius && dx <= radius;
    t.pass_y = dy >= -radius && dy <= radius;
    x = __fadd_rn(rx, fminf(fmaxf(dx, -radius), radius));
    y = __fadd_rn(ry, fminf(fmaxf(dy, -radius), radius));
  }
  const float x0 = floorf(x), y0 = floorf(y);
  t.fx = __fsub_rn(x, x0);
  t.fy = __fsub_rn(y, y0);
  t.vx0 = x0 >= 0.f && x0 < (float)W;
  t.vx1 = x0 + 1.f >= 0.f && x0 + 1.f < (float)W;
  t.vy0 = y0 >= 0.f && y0 < (float)H;
  t.vy1 = y0 + 1.f >= 0.f && y0 + 1.f < (float)H;
  t.xi = t.vx0 || t.vx1 ? static_cast<int>(x0) : 0;
  t.yi = t.vy0 || t.vy1 ? static_cast<int>(y0) : 0;
  return t;
}

// A sample's four corners in the order (0, 0), (0, 1), (1, 0), (1, 1) as
// (dy, dx): pixel offsets in the level (valid only where ok) and bilinear
// weights, each weight times `scale`.
struct Corners {
  int pix[4];
  bool ok[4];
  float w[4];
};

__device__ __forceinline__ Corners corners_of(const Taps& t, int W,
                                              float scale) {
  Corners c;
  const float gx = 1.f - t.fx, gy = 1.f - t.fy;
  c.pix[0] = t.yi * W + t.xi;
  c.pix[1] = c.pix[0] + 1;
  c.pix[2] = c.pix[0] + W;
  c.pix[3] = c.pix[2] + 1;
  c.ok[0] = t.vy0 && t.vx0;
  c.ok[1] = t.vy0 && t.vx1;
  c.ok[2] = t.vy1 && t.vx0;
  c.ok[3] = t.vy1 && t.vx1;
  c.w[0] = scale * (gy * gx);
  c.w[1] = scale * (gy * t.fx);
  c.w[2] = scale * (t.fy * gx);
  c.w[3] = scale * (t.fy * t.fx);
  return c;
}

// kV channels of T that a thread loads at once: one 16-byte ld.global.nc
// where kV * sizeof(T) == 16 (8 bf16 or 4 f32), else one element (kV == 1).
template <typename T, int kV> struct Vec;

template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <> struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename T> struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    f[0] = to_f32(r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) {
    *p = from_f32<T>(f[0]);
  }
};

// The thread layout of K1 and K2: a thread per (b, q, m, channel vector),
// heads in (b, q, m) order so that a warp's lanes cover neighbouring heads
// and neighbouring queries (the encoder's queries are its pixels, in S
// order). 2^tph_shift threads a head (a power of two, at most 32, so a
// head's threads sit in one warp); the last ones idle where kV channels a
// thread leave some over.
struct Layout {
  int kv;         // channels a thread: 16 / sizeof(T), or 1
  int tph_shift;  // log2 of the threads a head
};

// kv: 16-byte vectors where D * elt is a multiple of 16 and every pointer
// read or written by vector is 16-byte aligned (aligned = the OR of those
// pointers), else single channels. False when a head needs more than 32
// threads or the offsets in a batch overflow an int.
inline bool choose_layout(int D, int elt, int S, int M,
                          unsigned long long aligned, Layout* lay) {
  lay->kv = (D * elt) % 16 == 0 && aligned % 16 == 0 ? 16 / elt : 1;
  const int threads = (D + lay->kv - 1) / lay->kv;
  lay->tph_shift = 0;
  while ((1 << lay->tph_shift) < threads) ++lay->tph_shift;
  return D >= 1 && lay->tph_shift <= 5 &&
         static_cast<long long>(S) * M * D <= INT_MAX;
}

template <int v> using Int = std::integral_constant<int, v>;

// Calls f(Int<kV>, Int<kL>, Int<kP>, std::bool_constant<kClamp>) with the
// instantiation that takes these shapes: kV = lay.kv channels a thread, and
// the model's L = 3, P = 4 (its loc and attn rows read as vectors, so they
// must be 16-byte aligned) or (0, 0) for run-time L and P.
template <typename T, typename F>
void with_instantiation(const Layout& lay, int L, int P, const void* loc,
                        const void* attn, int clamp, F&& f) {
  constexpr int kVec = 16 / sizeof(T);
  const bool model = L == 3 && P == 4 &&
                     reinterpret_cast<unsigned long long>(loc) % 16 == 0 &&
                     reinterpret_cast<unsigned long long>(attn) % 16 == 0;
  const auto with_clamp = [&](auto v, auto l, auto p) {
    if (clamp) {
      f(v, l, p, std::true_type{});
    } else {
      f(v, l, p, std::false_type{});
    }
  };
  if (lay.kv == kVec && model) {
    with_clamp(Int<kVec>{}, Int<3>{}, Int<4>{});
  } else if (lay.kv == kVec) {
    with_clamp(Int<kVec>{}, Int<0>{}, Int<0>{});
  } else if (model) {
    with_clamp(Int<1>{}, Int<3>{}, Int<4>{});
  } else {
    with_clamp(Int<1>{}, Int<0>{}, Int<0>{});
  }
}

// The kP attention weights of one level from `a` (kP = 4: one 8-byte load
// in bf16, one 16-byte load in f32), in f32.
template <typename T, int kP>
__device__ __forceinline__ void load_attn(const T* a, float (&out)[kP]);

template <>
__device__ __forceinline__ void load_attn<__nv_bfloat16, 4>(
    const __nv_bfloat16* a, float (&out)[4]) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(a));
  out[0] = __uint_as_float(r.x << 16);
  out[1] = __uint_as_float(r.x & 0xffff0000u);
  out[2] = __uint_as_float(r.y << 16);
  out[3] = __uint_as_float(r.y & 0xffff0000u);
}

template <>
__device__ __forceinline__ void load_attn<float, 4>(const float* a,
                                                    float (&out)[4]) {
  const float4 r = __ldg(reinterpret_cast<const float4*>(a));
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

// The 2 * kP loc floats of one level (kP = 4: two 16-byte loads).
template <int kP>
__device__ __forceinline__ void load_loc(const float* p, float (&out)[2 * kP]) {
#pragma unroll
  for (int i = 0; i < kP / 2; ++i) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p) + i);
    out[4 * i] = r.x; out[4 * i + 1] = r.y;
    out[4 * i + 2] = r.z; out[4 * i + 3] = r.w;
  }
}

}  // namespace psalm
