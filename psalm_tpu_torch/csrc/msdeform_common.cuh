// What the deformable sampler's forward (K1, msdeform.cu) and backward (K2,
// msdeform_bwd.cu) share: the level table and one sample's bilinear taps,
// so that the two kernels round every coordinate the same way.
#pragma once

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

// One sample's 2x2 tap in level pixels.
struct Taps {
  float fx, fy;              // fractions past the top-left corner
  int xi, yi;                // top-left corner (0 on an axis with no corner on the image)
  bool vx0, vx1, vy0, vy1;   // corner columns / rows on the image
  bool pass_x, pass_y;       // the clamp passed the coordinate (it carries a gradient)
};

// x = loc_x * W - 0.5 (and y likewise); with kClamp the offset from the
// reference point (rx, ry) is clipped to +-radius first, exactly as
// psalm_tpu/ops/msdeform_window.py::_axis_taps does: c = ref + clip(coord -
// ref, -r, r), floor, corner validity from global coordinates, and
// pass = |coord - ref| <= r (its gradient gate dcl). The _rn intrinsics keep
// any multiply-add from being contracted into an FMA, so the clamp and the
// floor round exactly as the f32 reference does. Validity is taken from the
// float coordinates: no int overflow for any loc.
template <bool kClamp>
__device__ __forceinline__ Taps sample_taps(float loc_x, float loc_y, int H,
                                            int W, float rx, float ry,
                                            float radius) {
  float x = __fsub_rn(__fmul_rn(loc_x, (float)W), 0.5f);
  float y = __fsub_rn(__fmul_rn(loc_y, (float)H), 0.5f);
  Taps t;
  t.pass_x = t.pass_y = true;
  if (kClamp) {
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

}  // namespace psalm
