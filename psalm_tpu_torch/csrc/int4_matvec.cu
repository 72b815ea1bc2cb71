// K4: int4 matvec for the serving decode step.
//
// Replaces the TPU kernel psalm_tpu/ops/int4_matvec.py (_kernel, entry
// int4_matvec), which models/quant.py::Quant4Dense calls with storage
// "pallas" for calls of at most 16 rows: y[b, n] = sum_k x[b, k] q[k, n]
// s[k / g, n] in f32, on the half-split int4 packing (packed byte (i, n) holds
// q[i, n] in its low nibble and q[K/2 + i, n] in its high nibble).
//
// What bounds it on the H100: memory. Each packed byte is read once and
// feeds 2 multiply-adds per row of x, so at B <= 16 the f32 arithmetic is two
// orders of magnitude below what the bytes allow; the packed weights (K N / 2
// bytes) and the group scales (K N / 16 bytes at g = 64) are the work. At
// Phi-1.5's widths one call moves 2.25 MiB (q/k/v/dense) or 9 MiB (fc1/fc2):
// 0.7 or 2.8 us at 3.35 TB/s, so a launch also sits near launch latency.
//
// What the design does: one thread owns 2 adjacent columns (a 2-byte load per
// packed row, 64 contiguous bytes per warp), a block of 64 threads owns 128
// columns, and the K/2 packed rows are cut into splits of whole groups along
// blockIdx.y, so that even N = 2048 launches about 256 blocks. The block's x
// values (its rows of the low and of the high half) are staged in shared
// memory as f32. Per group, each thread keeps f32 partial dots of the low and
// of the high nibbles with each row of x (at most 16 rows: the template BT),
// then scales them by the two group scales into its accumulators; the
// nibbles are unpacked with integer ops in registers and never reach memory
// as weights. A second pass sums the splits' partials in a fixed order, so
// the result does not depend on block scheduling and greedy tokens repeat
// from run to run. Vector loads, prmt-based unpack and tensor cores are later
// work.

#include "common.cuh"

#include <cstdint>

namespace psalm {

constexpr int kMatvecThreads = 64;
constexpr int kMatvecCols = 2;
constexpr int kMatvecColsPerBlock = kMatvecThreads * kMatvecCols;  // 128

template <typename T, int BT>
__global__ void __launch_bounds__(kMatvecThreads)
    int4_matvec_kernel(const T* __restrict__ x,
                       const int8_t* __restrict__ packed,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int B, int K, int N, int group,
                       int rows_per_split) {
  extern __shared__ float xs[];  // [BT][2][R]: row b, low/high half, row i
  const int R = rows_per_split;
  const int half = K / 2;
  const int r0 = blockIdx.y * R;
  const int rows = min(R, half - r0);
  for (int e = threadIdx.x; e < BT * 2 * R; e += blockDim.x) {
    const int b = e / (2 * R);
    const int hi = (e / R) & 1;
    const int i = e % R;
    float v = 0.f;
    if (b < B && i < rows)
      v = to_f32(x[static_cast<long long>(b) * K + hi * half + r0 + i]);
    xs[e] = v;
  }
  __syncthreads();

  const int n = (blockIdx.x * kMatvecThreads + threadIdx.x) * kMatvecCols;
  if (n >= N) return;

  float acc[BT][kMatvecCols];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b][0] = acc[b][1] = 0.f;

  const int8_t* prow = packed + static_cast<long long>(r0) * N + n;
  for (int g0 = 0; g0 < rows; g0 += group) {
    float plo[BT][kMatvecCols], phi[BT][kMatvecCols];
#pragma unroll
    for (int b = 0; b < BT; ++b) plo[b][0] = plo[b][1] = phi[b][0] = phi[b][1] = 0.f;
    for (int i = g0; i < g0 + group; ++i) {
      const char2 w =
          *reinterpret_cast<const char2*>(prow + static_cast<long long>(i) * N);
      // low nibble: the 4 low bits, sign-extended; high nibble: an arithmetic
      // shift of the signed byte
      const float lo0 = static_cast<float>(((w.x & 0xF) ^ 8) - 8);
      const float lo1 = static_cast<float>(((w.y & 0xF) ^ 8) - 8);
      const float hi0 = static_cast<float>(w.x >> 4);
      const float hi1 = static_cast<float>(w.y >> 4);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float xl = xs[(2 * b) * R + i];
        const float xh = xs[(2 * b + 1) * R + i];
        plo[b][0] += xl * lo0;
        plo[b][1] += xl * lo1;
        phi[b][0] += xh * hi0;
        phi[b][1] += xh * hi1;
      }
    }
    const int gl = (r0 + g0) / group;
    const int gh = (half + r0 + g0) / group;
    const float2 sl =
        *reinterpret_cast<const float2*>(scale + static_cast<long long>(gl) * N + n);
    const float2 sh =
        *reinterpret_cast<const float2*>(scale + static_cast<long long>(gh) * N + n);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      acc[b][0] += plo[b][0] * sl.x + phi[b][0] * sh.x;
      acc[b][1] += plo[b][1] * sl.y + phi[b][1] * sh.y;
    }
  }

  float* o = out + static_cast<long long>(blockIdx.y) * B * N + n;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b < B) {
      o[static_cast<long long>(b) * N] = acc[b][0];
      o[static_cast<long long>(b) * N + 1] = acc[b][1];
    }
  }
}

// out[j] = sum over s of partial[s, j], s in order.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int splits,
                                  int count) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[static_cast<long long>(k) * count + j];
  out[j] = s;
}

template <typename T, int BT>
cudaError_t launch_int4_matvec(const void* x, const void* packed,
                               const void* scale, void* partial, void* out,
                               int B, int K, int N, int group,
                               int rows_per_split, int splits,
                               cudaStream_t stream) {
  auto kernel = int4_matvec_kernel<T, BT>;
  const size_t smem = static_cast<size_t>(BT) * 2 * rows_per_split * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kMatvecColsPerBlock - 1) / kMatvecColsPerBlock, splits);
  float* target = static_cast<float*>(splits > 1 ? partial : out);
  kernel<<<grid, kMatvecThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), target, B, K, N, group,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int count = B * N;
  sum_splits_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), splits,
      count);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* x, const void* packed, const void* scale,
                          void* partial, void* out, int B, int K, int N,
                          int group, int rows_per_split, int splits,
                          cudaStream_t stream) {
#define PSALM_INT4_CASE(BT)                                                   \
  if (B <= BT)                                                                \
    return launch_int4_matvec<T, BT>(x, packed, scale, partial, out, B, K, N, \
                                     group, rows_per_split, splits, stream);
  PSALM_INT4_CASE(1)
  PSALM_INT4_CASE(2)
  PSALM_INT4_CASE(4)
  PSALM_INT4_CASE(8)
  PSALM_INT4_CASE(16)
#undef PSALM_INT4_CASE
  return cudaErrorInvalidValue;
}

}  // namespace psalm

// x [B, K] in `dtype`; packed int8 [K/2, N]; scale f32 [K/group, N];
// out f32 [B, N]; partial f32 [splits, B, N] (null when splits == 1).
// rows_per_split is a multiple of group and splits = ceil(K/2 /
// rows_per_split) (psalm_tpu_torch/ops/int4_matvec.py::plan).
// Returns cudaGetLastError().
extern "C" int psalm_int4_matvec(const void* x, const void* packed,
                                 const void* scale, void* partial, void* out,
                                 int dtype, int B, int K, int N, int group,
                                 int rows_per_split, int splits,
                                 void* stream) {
  using namespace psalm;
  const int half = K / 2;
  if (B < 1 || B > 16 || K < 2 || K % 2 || N < 1 || N % kMatvecCols ||
      group < 1 || half % group || rows_per_split < group ||
      rows_per_split % group || splits < 1 || splits > 65535 ||
      splits != (half + rows_per_split - 1) / rows_per_split ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = dispatch_rows<float>(x, packed, scale, partial, out, B, K, N, group,
                               rows_per_split, splits, st);
  } else if (dtype == kBFloat16) {
    err = dispatch_rows<__nv_bfloat16>(x, packed, scale, partial, out, B, K, N,
                                       group, rows_per_split, splits, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
