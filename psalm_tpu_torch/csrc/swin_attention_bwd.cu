// K3 backward: the gradient of the Swin window-attention core.
//
// Replaces the backward of the TPU kernel psalm_tpu/ops/swin_attention_pallas.py
// (_op_bwd / _op_nomask_bwd, the custom VJP of fused_window_attention), which
// recomputes the core through _xla_reference and differentiates it. Per
// window w and head h, with q, k, v split out of the packed [N, 3C] rows and
// dO the output's gradient:
//   P  = softmax(q scale k^T + bias[h] (+ mask[w % nW]))   (f32, recomputed)
//   dV = P^T dO                dP = dO V^T
//   dS = P o (dP - rowsum(P o dP))
//   dq = scale dS K            dK = dS^T (q scale)
//   d bias[h] = sum over windows of dS                    (f32)
// There is no gradient for the shift mask, a constant.
//
// Rounding: in bf16 the kernel rounds where autograd through the plain twin
// (ops/swin_attention.py::window_attention_ref) rounds: q scale and P to
// bf16 (the forward's roundings), dP = dO V^T to bf16 (a bf16 product),
// dS K and dS^T (q scale) to bf16 (the casts back from the twin's f32
// products), then dq = bf16(bf16(dS K) scale) (the backward of q * scale in
// bf16), and P^T dO to bf16. Every sum runs in f32; only its order differs
// from the twin's, so its per-element limit is
// swin_attention.window_attention_bwd_limit.
//
// What bounds it on the H100: the bytes that must move are qkv, dO, d qkv,
// bias, mask and d bias once each (about 125 MB at stage 0 of a 1024^2 image
// in bf16, 0.037 ms), the operations 10 N^2 hd a (window, head) (about 13
// GFLOP at stage 0, 0.013 ms on the tensor cores). Bias and mask are read
// once per (window, head), from L2.
//
// Two kernels, chosen by the input's type (a fixed dispatch, as the
// forward's, not a fallback):
//
// bf16: window_attention_bwd_tc_kernel, the five products on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 accumulators;
// tensor_core.cuh). A block takes one head and a contiguous group of
// windows (the launcher picks the number of groups so that the grid fills
// the SMs), with one warp per 16 query rows (9 at N = 144). q, k, v and dO
// of the next window of the group arrive by 16-byte cp.async while the
// current one computes (two buffers). Per window each warp computes its rows
// of S = (q scale) k^T over every key once, in registers, adds bias and mask
// in f32 in the accumulator layout, takes the row softmax by quad shuffles
// into f32 P and writes P (bf16) to a shared tile; computes dP = dO v^T
// sixteen keys at a time, rounded to bf16 as the twin rounds it, for D_i =
// sum_j P o dP (quad sums). After a __syncthreads each warp owns 16 keys and
// takes dV = P^T dO, P^T read by ldmatrix.trans. After another, each warp
// computes dP once more (S and P fill the registers, so dP is not kept: 9
// warps an SM leave 168 registers a thread), forms dS = P (dP - D) in f32,
// adds it into the group's d bias sum (f32 in shared memory, each element
// owned by one thread) and writes dS (bf16) over P in the tile; past a
// third, dq = dS k over its rows and dK = dS^T (q scale) over its keys, from
// the tile. dV waits in the dead dO tile, and d q, k, v leave through the
// warp's own rows of the buffer in 16-byte stores. S is computed once, dP
// twice. Rounding dS to bf16 as the operand of dq and dK is the one rounding
// the twin does not make: it moves dS by at most 2^-9 |dS| <= 2^-9 M dS,
// half the 2^-8 M that the limit allows. At N = 144 the shared memory holds
// two buffers (92 KB at head dim 32), the P / dS tile (44 KB) and the d bias
// sum (88 KB); windows of 145 to 192 tokens keep the sum in registers
// instead (and spill).
//
// d bias without atomics: each block sums its group's windows in order and
// writes the sum to scratch [h, G, N, N]; window_bias_grad_sum_kernel adds
// each head's G partials in group order. Two calls on the same inputs give
// the same bits.
//
// f32: window_attention_bwd_kernel, on the f32 CUDA cores, for the tiny
// checks (1e-5): one block per (window, head), q scale, k, v and dO staged
// in shared memory as f32; a thread per query row (max, denominator,
// rowsum(P o dP), dq), then a thread per key (dK, dV, and d bias by f32
// atomics into the zeroed d bias, in an order that changes from run to
// run).

#include "common.cuh"
#include "tensor_core.cuh"

namespace psalm {

// ---- f32, CUDA cores -------------------------------------------------------

template <int HD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s += a[d] * b[d];
  return s;
}

template <int HD>
__global__ void window_attention_bwd_kernel(
    const float* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, const float* __restrict__ dout,
    float* __restrict__ dqkv, float* __restrict__ dbias, int N, int C, int nheads,
    int nW, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [N, HD] q scale
  float* ks = qs + N * HD;       // [N, HD]
  float* vs = ks + N * HD;       // [N, HD]
  float* dos = vs + N * HD;      // [N, HD]
  float* row_max = dos + N * HD; // [N]
  float* row_inv = row_max + N;  // [N] 1 / the softmax denominator
  float* row_dot = row_inv + N;  // [N] rowsum(P o dP)

  const int w = blockIdx.x / nheads;
  const int h = blockIdx.x % nheads;
  const long long row_stride = 3LL * C;
  const float* rows = qkv + static_cast<long long>(w) * N * row_stride + h * HD;
  const float* grad = dout + static_cast<long long>(w) * N * C + h * HD;
  float* drows = dqkv + static_cast<long long>(w) * N * row_stride + h * HD;

  for (int e = threadIdx.x; e < N * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    const float* row = rows + r * row_stride + d;
    qs[e] = row[0] * scale;
    ks[e] = row[C];
    vs[e] = row[2 * C];
    dos[e] = grad[static_cast<long long>(r) * C + d];
  }
  __syncthreads();

  const float* bh = bias + static_cast<long long>(h) * N * N;
  const float* mw =
      mask ? mask + static_cast<long long>(w % nW) * N * N : nullptr;

  // pass 1: a thread per query row
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float q[HD], o[HD], acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] = qs[i * HD + d];
      o[d] = dos[i * HD + d];
      acc[d] = 0.f;
    }
    const float* brow = bh + static_cast<long long>(i) * N;
    const float* mrow = mw ? mw + static_cast<long long>(i) * N : nullptr;
    float mx = -INFINITY, den = 0.f;
    for (int j = 0; j < N; ++j) {
      float s = dot<HD>(q, ks + j * HD) + brow[j];
      if (mrow) s += mrow[j];
      if (s > mx) {
        den = den * expf(mx - s) + 1.f;
        mx = s;
      } else {
        den += expf(s - mx);
      }
    }
    const float inv = 1.f / den;
    float dsum = 0.f;
    for (int j = 0; j < N; ++j) {
      float s = dot<HD>(q, ks + j * HD) + brow[j];
      if (mrow) s += mrow[j];
      const float p = expf(s - mx) * inv;
      dsum += p * dot<HD>(o, vs + j * HD);
    }
    for (int j = 0; j < N; ++j) {
      float s = dot<HD>(q, ks + j * HD) + brow[j];
      if (mrow) s += mrow[j];
      const float p = expf(s - mx) * inv;
      const float dp = dot<HD>(o, vs + j * HD);
      const float ds = p * (dp - dsum);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += ds * ks[j * HD + d];
    }
    float* dq = drows + i * row_stride;
#pragma unroll
    for (int d = 0; d < HD; ++d) dq[d] = acc[d] * scale;
    row_max[i] = mx;
    row_inv[i] = inv;
    row_dot[i] = dsum;
  }
  __syncthreads();

  // pass 2: a thread per key
  float* dbh = dbias + static_cast<long long>(h) * N * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float k[HD], v[HD], dk[HD], dv[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      k[d] = ks[j * HD + d];
      v[d] = vs[j * HD + d];
      dk[d] = 0.f;
      dv[d] = 0.f;
    }
    for (int i = 0; i < N; ++i) {
      const long long at = static_cast<long long>(i) * N + j;
      float s = dot<HD>(qs + i * HD, k) + bh[at];
      if (mw) s += mw[at];
      const float p = expf(s - row_max[i]) * row_inv[i];
      const float dp = dot<HD>(dos + i * HD, v);
      const float ds = p * (dp - row_dot[i]);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dk[d] += ds * qs[i * HD + d];
        dv[d] += p * dos[i * HD + d];
      }
      atomicAdd(dbh + at, ds);
    }
    float* drow = drows + j * row_stride;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      drow[C + d] = dk[d];
      drow[2 * C + d] = dv[d];
    }
  }
}

// ---- bf16, tensor cores ----------------------------------------------------

constexpr int kBwdMaxN = 192;            // as the forward's kTcMaxN
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a block

// Shared memory of the bf16 kernel, N padded to NP: q, k, v and dO of a
// window as bf16 rows of HD + kPad in each of two buffers; the P tile,
// which then holds dS (bf16 rows of NP + kPad); the group's d bias sum (f32
// rows of NP + kPad) where it fits, else in registers (NP = 192).
template <int HD, int NP>
__host__ __device__ constexpr size_t bwd_tiles_bytes() {
  return sizeof(__nv_bfloat16) * 4 * NP * (HD + kPad);
}
template <int NP>
__host__ __device__ constexpr size_t bwd_pd_bytes() {
  return sizeof(__nv_bfloat16) * NP * (NP + kPad);
}
template <int NP>
__host__ __device__ constexpr size_t bwd_sum_bytes() {
  return sizeof(float) * NP * (NP + kPad);
}
template <int HD, int NP>
__host__ __device__ constexpr bool bwd_sum_in_smem() {
  return 2 * bwd_tiles_bytes<HD, NP>() + bwd_pd_bytes<NP>() +
             bwd_sum_bytes<NP>() <=
         kMaxSmem;
}
template <int HD, int NP>
__host__ __device__ constexpr size_t bwd_smem() {
  return 2 * bwd_tiles_bytes<HD, NP>() + bwd_pd_bytes<NP>() +
         (bwd_sum_in_smem<HD, NP>() ? bwd_sum_bytes<NP>() : 0);
}

// One block per (group of windows, head), group-major; NB / 2 warps, warp i
// owns query rows [16 i, 16 i + 16) and, for dK and dV, keys [16 i, 16 i +
// 16). NB column blocks of 8 keys (N padded to NP = 8 NB) live in each
// thread's S accumulators. Windows [w0, w1) of the group are the balanced
// split of Bn into `groups` (every group has one or more windows); the
// group's d bias sum goes to partial[h][group] ([N, N] f32).
template <int HD, int NB>
__global__ void __launch_bounds__(16 * NB, 1)
    window_attention_bwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ mask,
                                   const __nv_bfloat16* __restrict__ dout,
                                   __nv_bfloat16* __restrict__ dqkv,
                                   float* __restrict__ partial, int Bn, int N,
                                   int C, int nheads, int nW, int groups,
                                   float scale) {
  constexpr int kNP = NB * 8;           // rows of each tile
  constexpr int kStride = HD + kPad;    // q, k, v, dO rows
  constexpr int kPStride = kNP + kPad;  // P / dS and d bias rows
  constexpr int kChunks = HD / 8;       // 16-byte pieces of a head's row
  constexpr int kThreads = 16 * NB;
  constexpr bool kSmemSum = bwd_sum_in_smem<HD, kNP>();
  constexpr int kTile = kNP * kStride;
  static_assert(bwd_smem<HD, kNP>() <= kMaxSmem, "shared memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][4]
  __nv_bfloat16* pds = tiles + 2 * 4 * kTile;                // [NP, PStride]
  auto* sums = reinterpret_cast<float*>(pds + kNP * kPStride);  // kSmemSum

  const int h = blockIdx.x % nheads;
  const int group = blockIdx.x / nheads;
  const int w0 = static_cast<int>(static_cast<long long>(group) * Bn / groups);
  const int w1 =
      static_cast<int>(static_cast<long long>(group + 1) * Bn / groups);
  const long long row_stride = 3LL * C;
  const bool pairs = (N & 1) == 0;  // float2 loads and stores stay aligned

  // q, k, v and dO of window w into buffer buf, 16 bytes a copy (thread
  // tid's share); rows past N zero-filled
  auto load = [&](int w, int buf, int tid) {
    __nv_bfloat16* dst = tiles + buf * 4 * kTile;
    const __nv_bfloat16* rows =
        qkv + static_cast<long long>(w) * N * row_stride + h * HD;
    const __nv_bfloat16* grad =
        dout + static_cast<long long>(w) * N * C + h * HD;
#pragma unroll
    for (int i = 0; i < 4 * kNP * kChunks / kThreads; ++i) {
      const int c = i * kThreads + tid;
      const int which = c / (kNP * kChunks);  // 0 q, 1 k, 2 v, 3 dO
      const int r = (c / kChunks) % kNP, col = (c % kChunks) * 8;
      const bool valid = r < N;
      const int rr = valid ? r : 0;
      const __nv_bfloat16* src =
          which < 3 ? rows + rr * row_stride + which * C + col
                    : grad + static_cast<long long>(rr) * C + col;
      cp_async_16(dst + (which * kNP + r) * kStride + col, src, valid);
    }
  };

  // the group's d bias sum, f32: in shared memory, or in registers (this
  // thread's elements of S) where it does not fit
  float db[NB][4];
  if constexpr (kSmemSum) {
    for (int e = threadIdx.x; e < kNP * kPStride; e += kThreads) sums[e] = 0.f;
  } else {
    zero<NB>(db);
  }
  if (w0 < w1) {
    load(w0, 0, threadIdx.x);
    cp_async_commit();
  }
  for (int w = w0; w < w1; ++w) {
    // every per-thread address is derived anew each window from opaque
    // copies of threadIdx.x and the pointers: held across the loop, the
    // copies' sources and the bias rows' addresses pass the 168 registers
    // that 9 warps an SM leave a thread, and spill
    int tid = threadIdx.x;
    const float* bh = bias;
    asm volatile("" : "+r"(tid), "+l"(bh), "+l"(qkv), "+l"(dout), "+l"(dqkv),
                 "+l"(mask));
    bh += static_cast<long long>(h) * N * N;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int buf = (w - w0) & 1;
    if (w + 1 < w1) {  // the next window's copies fly meanwhile
      load(w + 1, buf ^ 1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    __nv_bfloat16* qs = tiles + buf * 4 * kTile;
    __nv_bfloat16* ks = qs + kTile;
    __nv_bfloat16* vs = ks + kTile;
    __nv_bfloat16* dos = vs + kTile;

    // q * scale in the warp's own rows, rounded to bf16 as the twin rounds
    // it (q * scale in q's type); the other warps read them after a
    // __syncthreads, for dK
    for (int c = lane; c < 16 * HD / 2; c += 32) {
      const int r = warp * 16 + c / (HD / 2), col = (c % (HD / 2)) * 2;
      auto* p = reinterpret_cast<__nv_bfloat162*>(qs + r * kStride + col);
      const float2 f = __bfloat1622float2(*p);
      *p = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    __syncwarp();

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

    // + bias[h] (+ mask[w % nW]) in f32, keys past N to -inf
    const float* mw =
        mask ? mask + static_cast<long long>(w % nW) * N * N : nullptr;
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
            const float2 m =
                __ldg(reinterpret_cast<const float2*>(mw + at + col));
            add.x += m.x;
            add.y += m.y;
          }
        } else if (live) {
          if (col < N)
            add.x = __ldg(bh + at + col) + (mw ? __ldg(mw + at + col) : 0.f);
          if (col + 1 < N)
            add.y = __ldg(bh + at + col + 1) +
                    (mw ? __ldg(mw + at + col + 1) : 0.f);
        }
        s[b][2 * r] = col < N ? s[b][2 * r] + add.x : -INFINITY;
        s[b][2 * r + 1] = col + 1 < N ? s[b][2 * r + 1] + add.y : -INFINITY;
      }
    }

    // P = softmax over the whole row (a row spans the 4 lanes of a quad) in
    // f32, rows past N 0; P (bf16) into the P / dS tile's own rows
    constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
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
      den = quad_sum(den);  // every lane: a shuffle of the whole warp
      const float inv = row < N ? 1.f / den : 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        s[b][2 * r] *= inv;
        s[b][2 * r + 1] *= inv;
        *reinterpret_cast<__nv_bfloat162*>(pds + row * kPStride + b * 8 +
                                           2 * t) =
            __floats2bfloat162_rn(s[b][2 * r], s[b][2 * r + 1]);
      }
    }

    // dP = dO v^T for 16 keys at a time, rounded to bf16 as the twin's bf16
    // product is (computed here for D = rowsum(P o dP), and once more for
    // dS: registers hold S, not dP as well)
    uint32_t oa[HD / 16][4];
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      load_a(oa[d], dos, kStride, warp * 16, d * 16);
    auto dp_pair = [&](int b, float (&dp)[2][4]) {
      zero<2>(dp);
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        uint32_t vb[4];
        load_b_rows(vb, vs, kStride, b * 8, d * 16);
        mma_bf16(dp[0], oa[d], vb[0], vb[1]);
        mma_bf16(dp[1], oa[d], vb[2], vb[3]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float2 f = __bfloat1622float2(
              __floats2bfloat162_rn(dp[c][e], dp[c][e + 1]));
          dp[c][e] = f.x;
          dp[c][e + 1] = f.y;
        }
      }
    };
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int b = 0; b < NB; b += 2) {
      float dp[2][4];
      dp_pair(b, dp);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          dsum[r] += s[b + c][2 * r] * dp[c][2 * r] +
                     s[b + c][2 * r + 1] * dp[c][2 * r + 1];
      }
    }
    dsum[0] = quad_sum(dsum[0]);
    dsum[1] = quad_sum(dsum[1]);
    __syncthreads();  // P whole

    // dV = P^T dO over the warp's 16 keys, over every query row
    float dv[HD / 8][4];
    zero<HD / 8>(dv);
#pragma unroll
    for (int c = 0; c < NB / 2; ++c) {
      uint32_t pa[4];
      load_a_trans(pa, pds, kPStride, warp * 16, c * 16);
#pragma unroll
      for (int b = 0; b < HD / 8; b += 2) {
        uint32_t ob[4];
        load_b_cols(ob, dos, kStride, b * 8, c * 16);
        mma_bf16(dv[b], pa, ob[0], ob[1]);
        mma_bf16(dv[b + 1], pa, ob[2], ob[3]);
      }
    }
    __syncthreads();  // every warp is done with P and the dO tile
    // dV (bf16, rounded once) into the warp's own rows of the dO tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int b = 0; b < HD / 8; ++b)
        *reinterpret_cast<__nv_bfloat162*>(
            dos + (warp * 16 + g + 8 * r) * kStride + b * 8 + 2 * t) =
            __floats2bfloat162_rn(dv[b][2 * r], dv[b][2 * r + 1]);
    }

    // dS = P (dP - D) in f32 in place of P, added into the group's d bias
    // sum; dS (bf16) over P in the tile
#pragma unroll
    for (int b = 0; b < NB; b += 2) {
      float dp[2][4];
      dp_pair(b, dp);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r, col = (b + c) * 8 + 2 * t;
          const float x = s[b + c][2 * r] * (dp[c][2 * r] - dsum[r]);
          const float y = s[b + c][2 * r + 1] * (dp[c][2 * r + 1] - dsum[r]);
          s[b + c][2 * r] = x;
          s[b + c][2 * r + 1] = y;
          *reinterpret_cast<__nv_bfloat162*>(pds + row * kPStride + col) =
              __floats2bfloat162_rn(x, y);
          if constexpr (kSmemSum) {
            auto* at = reinterpret_cast<float2*>(sums + row * kPStride + col);
            const float2 acc = *at;
            *at = make_float2(acc.x + x, acc.y + y);
          } else {
            db[b + c][2 * r] += x;
            db[b + c][2 * r + 1] += y;
          }
        }
      }
    }
    __syncthreads();  // dS whole, every row of q scale in place

    // dq = dS k over the warp's 16 query rows and dK = dS^T (q scale) over
    // its 16 keys, both from the dS tile
    float dq[HD / 8][4], dk[HD / 8][4];
    zero<HD / 8>(dq);
    zero<HD / 8>(dk);
#pragma unroll
    for (int c = 0; c < NB / 2; ++c) {
      uint32_t sa[4], sta[4];
      load_a(sa, pds, kPStride, warp * 16, c * 16);
      load_a_trans(sta, pds, kPStride, warp * 16, c * 16);
#pragma unroll
      for (int b = 0; b < HD / 8; b += 2) {
        uint32_t kb[4], qb[4];
        load_b_cols(kb, ks, kStride, b * 8, c * 16);
        mma_bf16(dq[b], sa, kb[0], kb[1]);
        mma_bf16(dq[b + 1], sa, kb[2], kb[3]);
        load_b_cols(qb, qs, kStride, b * 8, c * 16);
        mma_bf16(dk[b], sta, qb[0], qb[1]);
        mma_bf16(dk[b + 1], sta, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done reading this window's tiles

    // dq = bf16(bf16(dS k) scale) and dK (rounded once) through the warp's
    // own rows of the q and k tiles, dV already in the dO tile's
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (warp * 16 + g + 8 * r) * kStride + 2 * t;
#pragma unroll
      for (int b = 0; b < HD / 8; ++b) {
        const float2 q2 = __bfloat1622float2(
            __floats2bfloat162_rn(dq[b][2 * r], dq[b][2 * r + 1]));
        *reinterpret_cast<__nv_bfloat162*>(qs + row + b * 8) =
            __floats2bfloat162_rn(q2.x * scale, q2.y * scale);
        *reinterpret_cast<__nv_bfloat162*>(ks + row + b * 8) =
            __floats2bfloat162_rn(dk[b][2 * r], dk[b][2 * r + 1]);
      }
    }
    __syncwarp();
    __nv_bfloat16* drows =
        dqkv + static_cast<long long>(w) * N * row_stride + h * HD;
    for (int c = lane; c < 3 * 16 * kChunks; c += 32) {
      const int which = c / (16 * kChunks);  // 0 dq, 1 dk, 2 dv
      const int row = warp * 16 + (c / kChunks) % 16;
      const int col = (c % kChunks) * 8;
      const int tile = which == 2 ? 3 : which;  // q, k, dO tile
      if (row < N) {
        *reinterpret_cast<uint4*>(drows + row * row_stride + which * C + col) =
            *reinterpret_cast<const uint4*>(qs + tile * kTile +
                                            row * kStride + col);
      }
    }
    __syncthreads();  // this buffer is free for the copy after next
  }

  // the group's d bias sum into its partial
  float* part = partial + (static_cast<long long>(h) * groups + group) * N * N;
  if constexpr (kSmemSum) {
    __syncthreads();
    for (int e = threadIdx.x; e < N * N; e += kThreads) {
      const int i = e / N;
      part[e] = sums[i * kPStride + e - i * N];
    }
  } else {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      if (row >= N) continue;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int col = b * 8 + 2 * t;
        float* at = part + static_cast<long long>(row) * N + col;
        if (pairs && col < N) {
          *reinterpret_cast<float2*>(at) =
              make_float2(db[b][2 * r], db[b][2 * r + 1]);
        } else {
          if (col < N) at[0] = db[b][2 * r];
          if (col + 1 < N) at[1] = db[b][2 * r + 1];
        }
      }
    }
  }
}

// d bias[h] = the sum of head h's `groups` partials, in group order: the
// same bits on every call.
__global__ void window_bias_grad_sum_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dbias,
                                            int groups, long long nn,
                                            long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= total) return;
  const long long h = e / nn;
  const float* p = partial + h * groups * nn + (e - h * nn);
  float sum = 0.f;
  for (int i = 0; i < groups; ++i) sum += p[i * nn];
  dbias[e] = sum;
}

template <int HD, int NB>
cudaError_t bwd_tc_attributes() {
  return cudaFuncSetAttribute(window_attention_bwd_tc_kernel<HD, NB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bwd_smem<HD, NB * 8>()));
}

// The number of window groups per head: the grid (groups x heads blocks)
// that finishes first when each SM runs as many blocks at once as fit, a
// block taking the ceiling of Bn / groups windows plus one for its first
// copy and its partial; the fewest groups among equals.
template <int HD, int NB>
cudaError_t plan_groups(int Bn, int nheads, int* groups) {
  cudaError_t err = bwd_tc_attributes<HD, NB>();
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, window_attention_bwd_tc_kernel<HD, NB>, 16 * NB,
      bwd_smem<HD, NB * 8>());
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long slots = static_cast<long long>(sms) * per_sm;
  long long best = -1;
  for (int G = 1; G <= Bn; ++G) {
    const long long waves = (static_cast<long long>(G) * nheads + slots - 1) /
                            slots;
    const long long cost = waves * ((Bn + G - 1) / G + 1);
    if (best < 0 || cost < best) {
      best = cost;
      *groups = G;
    }
  }
  return cudaSuccess;
}

template <int HD, int NB>
cudaError_t launch_window_attention_bwd_tc(
    const void* qkv, const void* bias, const void* mask, const void* dout,
    void* dqkv, float* dbias, float* partial, int Bn, int N, int C,
    int nheads, int nW, int groups, float scale, cudaStream_t stream) {
  const long long nn = static_cast<long long>(N) * N;
  const long long total = nn * nheads;
  if (Bn == 0)  // no window: d bias is 0
    return cudaMemsetAsync(dbias, 0, total * sizeof(float), stream);
  cudaError_t err = bwd_tc_attributes<HD, NB>();
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(groups) * nheads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  window_attention_bwd_tc_kernel<HD, NB>
      <<<static_cast<unsigned>(blocks), 16 * NB, bwd_smem<HD, NB * 8>(),
         stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                   static_cast<const float*>(bias),
                   static_cast<const float*>(mask),
                   static_cast<const __nv_bfloat16*>(dout),
                   static_cast<__nv_bfloat16*>(dqkv), partial, Bn, N, C,
                   nheads, nW, groups, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  window_bias_grad_sum_kernel<<<static_cast<unsigned>((total + 255) / 256),
                                256, 0, stream>>>(partial, dbias, groups, nn,
                                                  total);
  return cudaGetLastError();
}

// The smallest instantiation whose padded window holds N tokens: (plan)
// the number of groups, or (launch) the kernel and its d bias sum.
template <int HD>
cudaError_t dispatch_bwd_tc(bool plan, const void* qkv, const void* bias,
                            const void* mask, const void* dout, void* dqkv,
                            float* dbias, float* partial, int Bn, int N,
                            int C, int nheads, int nW, int* groups,
                            float scale, cudaStream_t stream) {
#define PSALM_SWIN_BWD_CASE(NP)                                             \
  if (N <= NP)                                                              \
    return plan ? plan_groups<HD, NP / 8>(Bn, nheads, groups)               \
                : launch_window_attention_bwd_tc<HD, NP / 8>(               \
                      qkv, bias, mask, dout, dqkv, dbias, partial, Bn, N,   \
                      C, nheads, nW, *groups, scale, stream);
  PSALM_SWIN_BWD_CASE(16)   // the tiny config's 4x4 windows
  PSALM_SWIN_BWD_CASE(64)   // 7x7 and 8x8 windows
  PSALM_SWIN_BWD_CASE(144)  // Swin-B's 12x12
  PSALM_SWIN_BWD_CASE(kBwdMaxN)
#undef PSALM_SWIN_BWD_CASE
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_window_attention_bwd(const void* qkv, const void* bias,
                                        const void* mask, const void* dout,
                                        void* dqkv, float* dbias, int Bn,
                                        int N, int C, int nheads, int nW,
                                        float scale, cudaStream_t stream) {
  const size_t smem = (4ull * N * HD + 3ull * N) * sizeof(float);
  auto kernel = window_attention_bwd_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = static_cast<long long>(Bn) * nheads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int threads = ((N < 256 ? N : 256) + 31) / 32 * 32;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(dout),
      static_cast<float*>(dqkv), dbias, N, C, nheads, nW, scale);
  return cudaGetLastError();
}

// bf16 to the tensor-core kernel, f32 to the CUDA-core one.
template <int HD>
cudaError_t launch_bwd_by_type(int dtype, const void* qkv, const void* bias,
                               const void* mask, const void* dout, void* dqkv,
                               float* dbias, float* partial, int Bn, int N,
                               int C, int nheads, int nW, int groups,
                               float scale, cudaStream_t stream) {
  if (dtype == kBFloat16)
    return dispatch_bwd_tc<HD>(false, qkv, bias, mask, dout, dqkv, dbias,
                               partial, Bn, N, C, nheads, nW, &groups, scale,
                               stream);
  if (dtype == kFloat32)
    return launch_window_attention_bwd<HD>(qkv, bias, mask, dout, dqkv, dbias,
                                           Bn, N, C, nheads, nW, scale,
                                           stream);
  return cudaErrorInvalidValue;
}

}  // namespace psalm

// The number of window groups G per head of the bf16 kernel for these
// shapes on the current device, into *groups (f32 takes no groups).
// Returns a CUDA error code.
extern "C" int psalm_window_attention_bwd_groups(int Bn, int N, int C,
                                                 int nheads, int* groups) {
  using namespace psalm;
  *groups = 1;
  if (nheads < 1 || C % nheads != 0 || N < 1 || Bn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C / nheads) {
    case 16:
      return static_cast<int>(dispatch_bwd_tc<16>(
          true, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          Bn, N, C, nheads, 1, groups, 1.f, nullptr));
    case 32:
      return static_cast<int>(dispatch_bwd_tc<32>(
          true, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          Bn, N, C, nheads, 1, groups, 1.f, nullptr));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// qkv [Bn, N, 3C], dout [Bn, N, C] and dqkv [Bn, N, 3C] in `dtype` (bf16:
// 16-byte aligned, N <= 192); bias [nheads, N, N] f32; mask [nW, N, N] f32
// or null (window w reads mask[w % nW]); dbias [nheads, N, N] f32. bf16:
// partial [nheads, groups, N, N] f32 scratch, groups from
// psalm_window_attention_bwd_groups; every element of dbias is written.
// f32: partial unused, dbias zeroed by the caller (the kernel adds every
// window's dS into it). Returns cudaGetLastError().
extern "C" int psalm_window_attention_bwd(const void* qkv, const void* bias,
                                          const void* mask, const void* dout,
                                          void* dqkv, void* dbias,
                                          void* partial, int dtype, int Bn,
                                          int N, int C, int nheads, int nW,
                                          int groups, float scale,
                                          void* stream) {
  using namespace psalm;
  if (nheads < 1 || C % nheads != 0 || nW < 1 || N < 1 || groups < 1 ||
      groups > (Bn > 0 ? Bn : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* db = static_cast<float*>(dbias);
  auto* part = static_cast<float*>(partial);
  switch (C / nheads) {
    case 16:
      return static_cast<int>(launch_bwd_by_type<16>(
          dtype, qkv, bias, mask, dout, dqkv, db, part, Bn, N, C, nheads, nW,
          groups, scale, st));
    case 32:
      return static_cast<int>(launch_bwd_by_type<32>(
          dtype, qkv, bias, mask, dout, dqkv, db, part, Bn, N, C, nheads, nW,
          groups, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
