// K4: int4 matvec for the serving decode step, in one launch.
//
// Replaces the TPU kernel psalm_tpu/ops/int4_matvec.py (_kernel, entry
// int4_matvec), which models/quant.py::Quant4Dense calls with storage
// "pallas" for calls of at most 16 rows: y[b, n] = sum_k x[b, k] q[k, n]
// s[k / g, n] in f32, on the half-split int4 packing (packed byte (i, n) holds
// q[i, n] in its low nibble and q[K/2 + i, n] in its high nibble).
//
// What bounds it on the H100: memory. Each packed byte is read once and
// feeds 2 multiply-adds per row of x, so at B <= 4 (the serving worker's
// batch) the f32 arithmetic is far below what the bytes allow; the packed
// weights (K N / 2 bytes) and the group scales (K N / 16 bytes at g = 64) are
// the work. At Phi-1.5's widths one call moves 2.25 MiB (q/k/v/dense) or 9
// MiB (fc1/fc2): 0.7 or 2.8 us at 3.35 TB/s. The bound is reached only with
// most of the matrix in flight at once (3.35 TB/s times the memory latency
// is about 2 MB), so the design is about bytes in flight.
//
// What the design does:
//   * One thread owns 16 adjacent columns and a piece of 8 packed rows
//     inside one group (of 1 row where 8 does not divide the group): it
//     issues the piece's 8 16-byte loads (ld.global.nc) and the 2 x 4
//     16-byte loads of its low and high group scales before it touches
//     anything else, so a launch has (nearly) the whole matrix in flight.
//   * The nibbles are unpacked in registers, 8 per 32-bit word: one LOP3
//     (and a shift for the high nibbles) moves 4 biased nibbles (q + 8) into
//     the low bits of 4 bytes, a PRMT places each byte under the exponent of
//     2^23, and one FADD of -(2^23 + 8) gives q as an exact f32.
//   * The piece's rows of x (low and high) are loaded into registers as
//     f32 right behind the weights, so they are in flight together.
//   * Per piece and row of x, f32 partial dots of the low and of the high
//     nibbles, each times its group scale into the accumulator. Threads that
//     hold the same columns are summed by warp shuffles in a fixed tree,
//     then the block's warps in order in shared memory.
//   * The packed rows K/2 are cut across the blocks of a thread-block
//     cluster (at most 8, the portable size), a whole number of groups each.
//     Each block leaves its f32 partial [rows, columns] in its own shared
//     memory; after cluster.sync() every rank sums a share of the columns
//     over the ranks, in rank order, through distributed shared memory, and
//     writes y. One launch, no partial buffer in device memory and no float
//     atomics: the result does not depend on block scheduling, so greedy
//     tokens repeat from run to run.
//   * Registers cap the rows of x a thread takes at once at 2 (4 rows took
//     255 registers and spilled): more rows are taken in slices of 2, one
//     after the other, over the same weights in registers (a thread with one
//     piece loads them once and unpacks them again per slice).
// Tensor cores for 16 rows are later work.

#include "common.cuh"

#include <cooperative_groups.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace psalm {

constexpr int kCols = 16;        // columns per thread: one 16-byte load a row
constexpr int kRows = 8;         // packed rows per piece where 8 | group
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kSliceRows = 2;    // rows of x a thread takes at a time

// 4 signed nibbles, biased to q + 8 in the low 4 bits of each byte of
// `biased`, as 4 exact f32.
__device__ __forceinline__ void nibbles_to_f32(uint32_t biased, float (&f)[4]) {
  constexpr float kMagic = 8388616.f;  // 2^23 + 8
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j of biased under the exponent bits of 2^23 (0x4B000000)
    const uint32_t bits = __byte_perm(biased, 0x4B000000u, 0x7440u | j);
    f[j] = __uint_as_float(bits) - kMagic;
  }
}

// Partial dots of one piece's nibbles (low or high, `kHigh`) with BS rows
// of x: p[b][c] = sum_i xv[b][i] q[i, c].
template <int BS, int RPT, bool kHigh>
__device__ __forceinline__ void piece_dots(const uint4 (&w)[RPT],
                                           const float (&xv)[BS][RPT],
                                           float (&p)[BS][kCols]) {
#pragma unroll
  for (int b = 0; b < BS; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) p[b][c] = 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const uint32_t words[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t src = kHigh ? words[q] >> 4 : words[q];
      float f[4];
      nibbles_to_f32((src & 0x0F0F0F0Fu) ^ 0x08080808u, f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < BS; ++b) p[b][4 * q + j] += xv[b][i] * f[j];
    }
  }
}

template <int BS>
__device__ __forceinline__ void scale_into(float (&acc)[BS][kCols],
                                           const float (&p)[BS][kCols],
                                           const float4 (&s)[kCols / 4]) {
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) {
    const float sv[4] = {s[q].x, s[q].y, s[q].z, s[q].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < BS; ++b) acc[b][4 * q + j] += p[b][4 * q + j] * sv[j];
  }
}

// Grid (N / (16 tc), cluster), cluster (1, cluster, 1), 128 threads;
// thread (tr, tc): columns 16 tc.. of the block's, pieces tr, tr + 128 / tc,
// ... of its rank's packed rows, for each slice of BS rows of x in turn.
template <typename T, int BS, int RPT>
__global__ void __launch_bounds__(kThreads)
    int4_matvec_kernel(const T* __restrict__ x,
                       const uint8_t* __restrict__ packed,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int B, int K, int N, int group,
                       int tc_count, int rows_per_rank) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int half = K / 2;
  const int r0 = rank * rows_per_rank;
  const int rows = max(0, min(rows_per_rank, half - r0));
  const int slices = (B + BS - 1) / BS;
  const int cols = kCols * tc_count;  // the block's columns
  // shared memory: warp partials [slices BS][4][cols] | the block's
  // partial [B][cols]
  float* wpart = smem;
  float* part = wpart + slices * BS * kWarps * cols;

  const int tc = threadIdx.x % tc_count, tr = threadIdx.x / tc_count;
  const int tr_count = kThreads / tc_count;
  const int n0 = blockIdx.x * cols + kCols * tc;  // this thread's columns
  const int pieces = rows / RPT;

  // a piece's weights, group scales and rows of x, all loads issued before
  // any is used
  uint4 w[RPT];
  float4 sl[kCols / 4], sh[kCols / 4];
  float xl[BS][RPT], xh[BS][RPT];
  int loaded = -1;
  auto issue = [&](int piece) {
    const int r = r0 + piece * RPT;
    const uint8_t* src = packed + static_cast<long long>(r) * N + n0;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      w[i] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<long long>(i) * N));
    const float* slo = scale + static_cast<long long>(r / group) * N + n0;
    const float* shi = scale + static_cast<long long>((half + r) / group) * N + n0;
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q) {
      sl[q] = __ldg(reinterpret_cast<const float4*>(slo) + q);
      sh[q] = __ldg(reinterpret_cast<const float4*>(shi) + q);
    }
    loaded = piece;
  };
  auto load_x = [&](int s, int piece) {
    const int r = r0 + piece * RPT;
#pragma unroll
    for (int b = 0; b < BS; ++b) {
      // rows past B read row B - 1; their sums are never written
      const T* xb = x + static_cast<long long>(min(s * BS + b, B - 1)) * K;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        xl[b][i] = to_f32(__ldg(xb + r + i));
        xh[b][i] = to_f32(__ldg(xb + half + r + i));
      }
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = 0; s < slices; ++s) {
    float acc[BS][kCols];
#pragma unroll
    for (int b = 0; b < BS; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;
    for (int piece = tr; piece < pieces; piece += tr_count) {
      if (piece != loaded) issue(piece);
      load_x(s, piece);
      float p[BS][kCols];
      piece_dots<BS, RPT, false>(w, xl, p);
      scale_into<BS>(acc, p, sl);
      piece_dots<BS, RPT, true>(w, xh, p);
      scale_into<BS>(acc, p, sh);
    }
    // threads with the same columns (lanes tc, tc + tc_count, ...) in a
    // fixed tree, then each warp's sums to shared memory
#pragma unroll
    for (int b = 0; b < BS; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float v = acc[b][c];
        for (int off = tc_count; off < 32; off <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[b][c] = v;
      }
    if (lane < tc_count) {
#pragma unroll
      for (int b = 0; b < BS; ++b) {
        float* dst = wpart + ((s * BS + b) * kWarps + warp) * cols + kCols * tc;
#pragma unroll
        for (int c = 0; c < kCols; ++c) dst[c] = acc[b][c];
      }
    }
  }
  __syncthreads();
  // the block's partial: its warps summed in order
  for (int e = threadIdx.x; e < B * cols; e += kThreads) {
    const float* src = wpart + (e / cols) * kWarps * cols + e % cols;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += src[wi * cols];
    part[e] = v;
  }
  cluster.sync();
  // every rank sums a share of the elements over the ranks, in rank order
  const int count = B * cols;
  const int share = (count + ranks - 1) / ranks;
  const int e_end = min(count, (rank + 1) * share);
  for (int e = rank * share + static_cast<int>(threadIdx.x); e < e_end;
       e += kThreads) {
    float v = 0.f;
    for (int r = 0; r < ranks; ++r) v += cluster.map_shared_rank(part, r)[e];
    out[static_cast<long long>(e / cols) * N + blockIdx.x * cols + e % cols] = v;
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// Shared memory of a launch, in bytes (the layout above).
inline size_t smem_bytes(int B, int BS, int tc_count) {
  const int Bp = (B + BS - 1) / BS * BS;
  return sizeof(float) * static_cast<size_t>(Bp * kWarps + B) * kCols *
         tc_count;
}

template <typename T, int BS, int RPT>
cudaError_t launch_int4_matvec(const void* x, const void* packed,
                               const void* scale, void* out, int B, int K,
                               int N, int group, int cluster, int tc_count,
                               int rows_per_rank, cudaStream_t stream) {
  auto kernel = int4_matvec_kernel<T, BS, RPT>;
  const size_t smem = smem_bytes(B, BS, tc_count);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(N / (kCols * tc_count), cluster, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(x),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      static_cast<float*>(out), B, K, N, group, tc_count, rows_per_rank);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int RPT>
cudaError_t dispatch_rows(const void* x, const void* packed, const void* scale,
                          void* out, int B, int K, int N, int group,
                          int cluster, int tc_count, int rows_per_rank,
                          cudaStream_t stream) {
#define PSALM_INT4_CASE(BS)                                                  \
  return launch_int4_matvec<T, BS, RPT>(x, packed, scale, out, B, K, N,    \
                                        group, cluster, tc_count,          \
                                        rows_per_rank, stream)
  if (B == 1) PSALM_INT4_CASE(1);
  PSALM_INT4_CASE(kSliceRows);
#undef PSALM_INT4_CASE
}

// Pieces of 8 packed rows where 8 divides the group (Phi's 64), else of one.
template <typename T>
cudaError_t dispatch_piece(const void* x, const void* packed,
                           const void* scale, void* out, int B, int K, int N,
                           int group, int cluster, int tc_count,
                           int rows_per_rank, cudaStream_t stream) {
  if (group % kRows == 0)
    return dispatch_rows<T, kRows>(x, packed, scale, out, B, K, N, group,
                                   cluster, tc_count, rows_per_rank, stream);
  return dispatch_rows<T, 1>(x, packed, scale, out, B, K, N, group, cluster,
                             tc_count, rows_per_rank, stream);
}

}  // namespace psalm

// x [B, K] in `dtype`; packed int8 [K/2, N] and scale f32 [K/group, N],
// 16-byte aligned; out f32 [B, N]. The launch: `cluster` blocks (1..8) cut
// the K/2 packed rows into ranks of rows_per_rank (a multiple of group, the
// last rank takes the rest), tc_count threads (1..32, a power of two) cut
// the block's 16 tc_count columns (psalm_tpu_torch/ops/int4_matvec.py::plan).
// Returns the launch's error.
extern "C" int psalm_int4_matvec(const void* x, const void* packed,
                                 const void* scale, void* out, int dtype,
                                 int B, int K, int N, int group, int cluster,
                                 int tc_count, int rows_per_rank,
                                 void* stream) {
  using namespace psalm;
  const int half = K / 2;
  const int cols = kCols * tc_count;
  if (B < 1 || B > 16 || K < 2 || K % 2 || N < 1 || group < 1 ||
      half % group || tc_count < 1 || tc_count > 32 ||
      (tc_count & (tc_count - 1)) || N % cols || cluster < 1 ||
      cluster > kMaxCluster || rows_per_rank < group ||
      rows_per_rank % group ||
      static_cast<long long>(rows_per_rank) * (cluster - 1) >= half ||
      static_cast<long long>(rows_per_rank) * cluster < half ||
      (reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(scale)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = dispatch_piece<float>(x, packed, scale, out, B, K, N, group, cluster,
                               tc_count, rows_per_rank, st);
  } else if (dtype == kBFloat16) {
    err = dispatch_piece<__nv_bfloat16>(x, packed, scale, out, B, K, N, group,
                                       cluster, tc_count, rows_per_rank, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
