// Fast COCO RLE codec — native host component.
//
// The reference's only native code is its CUDA MSDeformAttn op (our analog is
// the TPU Pallas/XLA kernel); on the host side it leans on pycocotools' C
// extension for RLE masks. pycocotools is not a dependency here, so this
// library provides the hot host-side mask ops: column-major run-length
// encode/decode, the LEB-style char codec, and batched mask IoU — called from
// psalm_tpu_torch/data/coco_rle.py via ctypes (psalm_tpu_torch/native/__init__.py
// builds it at first use; the numpy codec beside it is the reference).
//
// Build: make -C psalm_tpu_torch/native OUT=/path/to/librle.so

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Column-major RLE encode. mask: row-major [h, w] uint8. counts_out must hold
// at least h*w+1 entries. Returns the number of counts written.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   uint32_t* counts_out) {
  int64_t n = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (int64_t x = 0; x < w; ++x) {
    const uint8_t* col = mask + x;
    for (int64_t y = 0; y < h; ++y) {
      uint8_t v = col[y * w] ? 1 : 0;
      if (v == prev) {
        ++run;
      } else {
        counts_out[n++] = run;
        run = 1;
        prev = v;
      }
    }
  }
  counts_out[n++] = run;
  return n;
}

// Column-major RLE decode into row-major [h, w] uint8 (caller zeroes out).
void rle_decode(const uint32_t* counts, int64_t n, uint8_t* out, int64_t h,
                int64_t w) {
  int64_t pos = 0;
  uint8_t v = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t run = counts[i];
    if (v) {
      for (uint32_t k = 0; k < run; ++k) {
        int64_t p = pos + k;
        int64_t y = p % h;
        int64_t x = p / h;
        out[y * w + x] = 1;
      }
    }
    pos += run;
    v ^= 1;
  }
}

// pycocotools rleToString: delta-coded signed base-6-bit chars.
int64_t rle_to_string(const uint32_t* counts, int64_t n, char* out) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = (int64_t)counts[i];
    if (i > 2) x -= (int64_t)counts[i - 2];
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      out[m++] = (char)(c + 48);
    }
  }
  return m;
}

int64_t rle_from_string(const char* s, int64_t len, uint32_t* counts_out) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < len) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      int64_t c = (int64_t)s[i] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      if (!more && (c & 0x10)) x |= ~((int64_t)0) << (5 * k + 5);
      ++k;
    }
    if (n > 2) x += (int64_t)counts_out[n - 2];
    counts_out[n++] = (uint32_t)x;
  }
  return n;
}

// Batched boolean mask IoU: a [P, HW], b [G, HW] uint8 -> iou [P, G] double.
// crowd[g] nonzero switches to intersection-over-pred-area (COCOeval rule).
void mask_iou_matrix(const uint8_t* a, int64_t P, const uint8_t* b, int64_t G,
                     int64_t hw, const uint8_t* crowd, double* out) {
  std::vector<int64_t> area_a(P, 0), area_b(G, 0);
  for (int64_t p = 0; p < P; ++p) {
    const uint8_t* ap = a + p * hw;
    int64_t s = 0;
    for (int64_t i = 0; i < hw; ++i) s += ap[i] != 0;
    area_a[p] = s;
  }
  for (int64_t g = 0; g < G; ++g) {
    const uint8_t* bg = b + g * hw;
    int64_t s = 0;
    for (int64_t i = 0; i < hw; ++i) s += bg[i] != 0;
    area_b[g] = s;
  }
  for (int64_t p = 0; p < P; ++p) {
    const uint8_t* ap = a + p * hw;
    for (int64_t g = 0; g < G; ++g) {
      const uint8_t* bg = b + g * hw;
      int64_t inter = 0;
      for (int64_t i = 0; i < hw; ++i) inter += (ap[i] && bg[i]);
      double denom = crowd && crowd[g]
                         ? (double)area_a[p]
                         : (double)(area_a[p] + area_b[g] - inter);
      out[p * G + g] = denom > 0 ? (double)inter / denom : 0.0;
    }
  }
}

}  // extern "C"
