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
// gradient; with clamp radii (one a point, K1's), d loc is zero on an axis
// whose offset the clamp clipped (the dcl gate). d value is summed in an
// f32 accumulator [B, S, M, D] that the launcher zeroes and, for a bf16
// value, rounds to bf16 once (msdeform_bwd_finish_kernel); d loc is f32 and
// d attn in the value's type.
//
// What bounds it on the H100: the scatter. At the 1024^2 encoder shapes (Q =
// S = 21504, M = 8, D = 32, L = 3, P = 4) a call adds Q*M*L*P*4*D = 264 M f32
// terms into a 22 MB accumulator that stays in the 50 MB L2, against about
// 75-115 MB of inputs and outputs (0.02-0.03 ms at 3.35 TB/s); the
// reductions' throughput in L2, not the bytes, sets its time.
//
// What the design does about it: K1's layout, a thread per (b, q, m,
// 16-byte channel vector) (4 threads a head in bf16, 8 in f32), with the
// head's grad_out vector loaded into registers once. For the model's L = 3,
// P = 4 the sample loop unrolls and a level's 16 corner loads are issued
// together, as in K1. Per sample each thread sums its channels' terms of d
// attn, d loc_x and d loc_y; then log2(threads a head) __shfl_xor_sync steps
// (2 in bf16) give every thread of the head the three sums, and thread p
// mod (threads a head) writes sample p's d loc (a float2) and d attn, so a
// head's writes are spread over its threads. d value goes out through
// red.global.add.v4.f32, the vector reduction sm_90 has, where D * 4 is a
// multiple of 16 bytes: two a corner a thread in bf16 (one in f32) in place
// of eight scalar atomics, the head's threads covering its 128-byte row. L2
// takes a reduction per 32-byte sector that a warp instruction touches, so
// in bf16 a thread's two 4-channel chunks do not go to its own channels 8c
// and 8c + 4 (each instruction would then cover half of every sector, and
// every sector take two reductions) but to 4c and D/2 + 4c of the
// accumulator's row: each instruction covers whole sectors, and the finish
// kernel, which rounds to bf16 anyway, puts the channels back. Other shapes
// take K1's generic and single-channel instantiations (scalar atomicAdd for
// the latter).
//
// Order: the reductions into d value land in an order that changes from
// run to run, so d value agrees with a plain version to the f32 rounding
// of its sums, not bit for bit (held to msdeform.ms_deform_attn_bwd_limit);
// d loc and d attn sum in a fixed order, their own.

#include "msdeform_common.cuh"

namespace psalm {

// d value's accumulator += v: kV f32 lanes in chunks of 4, chunk j at p +
// j * stride, each one 16-byte vector reduction; or one scalar atomic for
// kV == 1.
template <int kV>
__device__ __forceinline__ void reduce_add(float* p, int stride,
                                           const float (&v)[kV]) {
  if constexpr (kV == 1) {
    atomicAdd(p, v[0]);
  } else {
    static_assert(kV % 4 == 0, "vector reductions take 4 floats");
#pragma unroll
    for (int i = 0; i < kV; i += 4) {
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                   :: "l"(__cvta_generic_to_global(p + i / 4 * stride)),
                      "f"(v[i]), "f"(v[i + 1]), "f"(v[i + 2]), "f"(v[i + 3])
                   : "memory");
    }
  }
}

// One sample's three sums over the thread's channels and its d value
// reductions. f are the four corners' channels, g the output gradient's.
template <int kV>
__device__ __forceinline__ void sample_grads(
    const float (&g)[kV], const float (&f)[4][kV], const Corners& c,
    const Taps& t, float a, float* gv, int stride, int MD, bool active,
    float* sums) {
  const float gx = 1.f - t.fx, gy = 1.f - t.fy;
  float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    const float v00 = f[0][e], v01 = f[1][e], v10 = f[2][e], v11 = f[3][e];
    s_attn += g[e] * (c.w[0] * v00 + c.w[1] * v01 + c.w[2] * v10 + c.w[3] * v11);
    s_x += g[e] * (gy * (v01 - v00) + t.fy * (v11 - v10));
    s_y += g[e] * (gx * (v10 - v00) + t.fx * (v11 - v01));
  }
  sums[0] = s_attn;
  sums[1] = s_x;
  sums[2] = s_y;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (active && c.ok[k]) {
      float d[kV];
      const float aw = a * c.w[k];
#pragma unroll
      for (int e = 0; e < kV; ++e) d[e] = g[e] * aw;
      reduce_add<kV>(gv + c.pix[k] * MD, stride, d);
    }
  }
}

// Sum each of n values over the head's 2^tph_shift threads (an xor
// butterfly: every thread ends with the sums). The whole warp takes part.
template <int n>
__device__ __forceinline__ void head_sum(float (&s)[n], int tph_shift) {
  for (int off = (1 << tph_shift) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
  }
}

// Sample (l, p)'s d loc and d attn from its summed (attn, x, y).
template <typename T>
__device__ __forceinline__ void write_sample(const float* s, const Taps& t,
                                             float a, int H, int W,
                                             float* gloc, T* gattn) {
  gattn[0] = from_f32<T>(s[0]);
  *reinterpret_cast<float2*>(gloc) =
      make_float2(t.pass_x ? a * s[1] * (float)W : 0.f,
                  t.pass_y ? a * s[2] * (float)H : 0.f);
}

// One level of one thread: the kP (or run-time P) samples' gradients.
template <typename T, int kV, int kP, bool kClamp>
__device__ __forceinline__ void level_grads(
    const T* vl, float* gvl, int stride, int MD, int H, int W,
    const float* loc_l,
    const T* attn_l, float* gloc_l, T* gattn_l, int P, float rx, float ry,
    const Radii& radii, bool in_range, bool active, int lane_in_head,
    int tph_shift, const float (&g)[kV]) {
  using V = Vec<T, kV>;
  if constexpr (kP > 0) {
    float lc[2 * kP], a[kP];
    if (in_range) {
      load_loc<kP>(loc_l, lc);
      load_attn<T, kP>(attn_l, a);
    } else {
#pragma unroll
      for (int i = 0; i < kP; ++i) lc[2 * i] = lc[2 * i + 1] = a[i] = 0.f;
    }
    Taps t[kP];
    Corners c[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      t[p] = sample_taps<kClamp>(lc[2 * p], lc[2 * p + 1], H, W, rx, ry, radii,
                                 p);
      c[p] = corners_of(t[p], W, 1.f);
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
    float s[3 * kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      float f[4][kV];
#pragma unroll
      for (int k = 0; k < 4; ++k) V::unpack(raw[p][k], f[k]);
      sample_grads<kV>(g, f, c[p], t[p], a[p], gvl, stride, MD, active,
                       s + 3 * p);
    }
    head_sum<3 * kP>(s, tph_shift);
    const int tph_mask = (1 << tph_shift) - 1;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (in_range && (p & tph_mask) == lane_in_head) {
        write_sample<T>(s + 3 * p, t[p], a[p], H, W, gloc_l + 2 * p,
                        gattn_l + p);
      }
    }
  } else {
    // run-time P: a sample at a time; every lane runs the loop (the
    // shuffles need the whole warp), reading and writing only in range
    for (int p = 0; p < P; ++p) {
      const float lx = in_range ? loc_l[2 * p] : 0.f;
      const float ly = in_range ? loc_l[2 * p + 1] : 0.f;
      const float a = in_range ? to_f32(attn_l[p]) : 0.f;
      const Taps t = sample_taps<kClamp>(lx, ly, H, W, rx, ry, radii, p);
      const Corners c = corners_of(t, W, 1.f);
      float f[4][kV];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        V::unpack(active && c.ok[k] ? V::load(vl + c.pix[k] * MD)
                                    : typename V::Raw{}, f[k]);
      }
      float s[3];
      sample_grads<kV>(g, f, c, t, a, gvl, stride, MD, active, s);
      head_sum<3>(s, tph_shift);
      if (in_range && lane_in_head == 0) {
        write_sample<T>(s, t, a, H, W, gloc_l + 2 * p, gattn_l + p);
      }
    }
  }
}

// kL, kP: the model's 3 and 4, or 0 for run-time L and P. Every thread of
// a launched warp runs to the end (the shuffles take the whole warp):
// in_range threads read their head's loc and attn and write its d loc and
// d attn; active ones, whose channel vector lies in the head, also read
// value and reduce into d value.
template <typename T, int kV, int kL, int kP, bool kClamp>
__global__ void __launch_bounds__(256) msdeform_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const T* __restrict__ attn, const float* __restrict__ ref,
    const T* __restrict__ grad_out, float* __restrict__ grad_value_acc,
    float* __restrict__ grad_loc, T* __restrict__ grad_attn,
    long long threads, int S, int Q, int M, int D, int L, int P,
    int tph_shift, Levels lv, Radii radii) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long head = t >> tph_shift;  // (b * Q + q) * M + m
  const int lane_in_head = static_cast<int>(t & ((1 << tph_shift) - 1));
  const int d0 = lane_in_head * kV;
  const bool in_range = t < threads;
  const bool active = in_range && d0 < D;
  const int m = static_cast<int>(head % M);
  const long long bq = head / M;
  const int q = static_cast<int>(bq % Q);
  const long long b = bq / Q;
  const int MD = M * D;
  const int nL = kL > 0 ? kL : L, nP = kP > 0 ? kP : P;
  const long long row = head * nL * nP;  // the head's first sample
  const long long base = b * S * MD + m * D;
  // where the thread's d value chunks go in the accumulator's row: its own
  // channels, except in 8-channel (bf16) vectors, where chunk h of thread c
  // goes to h * D / 2 + 4 c, so that each warp-wide reduction covers whole
  // 32-byte sectors (msdeform_bwd_finish_kernel puts the channels back)
  const int acc_off = kV == 8 ? 4 * lane_in_head : d0, acc_stride = D / 2;

  float g[kV];
  {
    typename Vec<T, kV>::Raw raw{};
    if (active) raw = Vec<T, kV>::load(grad_out + head * D + d0);
    Vec<T, kV>::unpack(raw, g);
  }
  const auto run_level = [&](int l) {
    float rx = 0.f, ry = 0.f;
    if (kClamp && in_range) {
      rx = __ldg(ref + (q * nL + l) * 2);
      ry = __ldg(ref + (q * nL + l) * 2 + 1);
    }
    const long long level = base + static_cast<long long>(lv.start[l]) * MD;
    level_grads<T, kV, kP, kClamp>(
        value + level + d0, grad_value_acc + level + acc_off, acc_stride, MD,
        lv.h[l], lv.w[l],
        loc + (row + l * nP) * 2, attn + row + l * nP,
        grad_loc + (row + l * nP) * 2, grad_attn + row + l * nP, nP, rx, ry,
        radii, in_range, active, lane_in_head, tph_shift, g);
  };
  if constexpr (kL > 0) {
#pragma unroll
    for (int l = 0; l < kL; ++l) run_level(l);
  } else {
#pragma unroll 1
    for (int l = 0; l < L; ++l) run_level(l);
  }
}

// d value from its f32 accumulator, rounded once to T. With 8-channel
// vectors (kV == 8) a thread takes one of a row's D / 8 vectors: the
// accumulator's chunks h * D / 2 + 4 c (h = 0, 1) become channels 8 c ..
// 8 c + 7; else a thread per element.
template <typename T, int kV>
__global__ void __launch_bounds__(256) msdeform_bwd_finish_kernel(
    const float* __restrict__ acc, T* __restrict__ out, long long n, int D) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if constexpr (kV == 8) {
    const int nvec = D / 8;
    const long long row = i / nvec;
    const int c = static_cast<int>(i % nvec);
    const float* a = acc + row * D + 4 * c;
    const float4 lo = *reinterpret_cast<const float4*>(a);
    const float4 hi = *reinterpret_cast<const float4*>(a + D / 2);
    const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    Vec<T, 8>::store(out + row * D + 8 * c, f);
  } else {
    out[i] = from_f32<T>(acc[i]);
  }
}

// Zero the accumulator, run K2, and for a bf16 value round d value from the
// accumulator (for f32 the accumulator is d value itself).
template <typename T>
cudaError_t launch_bwd(const void* value, const void* loc, const void* attn,
                       const void* ref, const void* grad_out, void* grad_value,
                       void* grad_value_acc, void* grad_loc, void* grad_attn,
                       int B, int S, int Q, int M, int D, int L, int P,
                       const Levels& lv, const Radii& radii, int clamp,
                       cudaStream_t stream) {
  Layout lay;
  const auto addr = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p);
  };
  // the f32 vector reductions need D * 4 % 16 == 0, which D * elt % 16 == 0
  // implies for bf16 and f32
  if (!choose_layout(D, sizeof(T), S, M,
                     addr(value) | addr(grad_out) | addr(grad_value) |
                         addr(grad_value_acc), &lay)) {
    return cudaErrorInvalidValue;
  }
  constexpr int kThreads = 256;
  const long long threads = (static_cast<long long>(B) * Q * M) << lay.tph_shift;
  const long long n = static_cast<long long>(B) * S * M * D;
  const long long finish = lay.kv == 8 ? n / 8 : n;
  if ((threads + kThreads - 1) / kThreads > 0x7fffffffLL ||
      (finish + 255) / 256 > 0x7fffffffLL) {
    return cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaMemsetAsync(grad_value_acc, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if (threads > 0) {
    with_instantiation<T>(lay, L, P, loc, attn, clamp,
                          [&](auto v, auto l, auto p, auto c) {
      msdeform_bwd_kernel<T, decltype(v)::value, decltype(l)::value,
                          decltype(p)::value, decltype(c)::value>
          <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
             kThreads, 0, stream>>>(
              static_cast<const T*>(value), static_cast<const float*>(loc),
              static_cast<const T*>(attn), static_cast<const float*>(ref),
              static_cast<const T*>(grad_out),
              static_cast<float*>(grad_value_acc),
              static_cast<float*>(grad_loc), static_cast<T*>(grad_attn),
              threads, S, Q, M, D, L, P, lay.tph_shift, lv, radii);
    });
  }
  if constexpr (!std::is_same_v<T, float>) {
    const unsigned blocks = static_cast<unsigned>((finish + 255) / 256);
    auto* acc = static_cast<const float*>(grad_value_acc);
    auto* out = static_cast<T*>(grad_value);
    if (blocks > 0 && lay.kv == 8) {
      msdeform_bwd_finish_kernel<T, 8><<<blocks, 256, 0, stream>>>(acc, out,
                                                                  finish, D);
    } else if (blocks > 0) {
      msdeform_bwd_finish_kernel<T, 1><<<blocks, 256, 0, stream>>>(acc, out,
                                                                  finish, D);
    }
  }
  return cudaGetLastError();
}

}  // namespace psalm

// value [B,S,M,D], attn [B,Q,M,L,P] and grad_out [B,Q,M*D] in `dtype`; loc
// [B,Q,M,L,P,2] f32; ref [Q,L,2] f32 (read only with radii).
// grad_value [B,S,M,D] in `dtype`; grad_value_acc [B,S,M,D] f32 scratch,
// zeroed here and summed into with reductions (for f32 it may be
// grad_value itself); grad_loc [B,Q,M,L,P,2] f32 (8-byte aligned) and
// grad_attn [B,Q,M,L,P] in `dtype`, each element written once. shapes: host
// array of L (H, W) pairs; radii: host array of the P clamp radii, or null
// (as K1). Returns cudaGetLastError(), or cudaErrorInvalidValue for shapes
// the kernel does not take (as K1).
extern "C" int psalm_msdeform_bwd(const void* value, const void* loc,
                                  const void* attn, const void* ref,
                                  const void* grad_out, void* grad_value,
                                  void* grad_value_acc, void* grad_loc,
                                  void* grad_attn, int dtype, int B, int S,
                                  int Q, int M, int D, int L, int P,
                                  const void* shapes, const void* radii,
                                  void* stream) {
  using namespace psalm;
  Levels lv{};
  Radii rd{};
  if (!make_levels(shapes, L, S, &lv) || !make_radii(radii, P, &rd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int clamp = radii != nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch_bwd<float>(value, loc, attn, ref, grad_out, grad_value,
                            grad_value_acc, grad_loc, grad_attn, B, S, Q, M, D,
                            L, P, lv, rd, clamp, st);
  } else if (dtype == kBFloat16) {
    err = launch_bwd<__nv_bfloat16>(value, loc, attn, ref, grad_out,
                                    grad_value, grad_value_acc, grad_loc,
                                    grad_attn, B, S, Q, M, D, L, P, lv, rd,
                                    clamp, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
