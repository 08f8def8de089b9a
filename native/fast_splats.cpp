// Native host services for the gaussian-splatting framework.
//
// The reference leans on native code for its host-side hot paths: miniply for
// PLY parsing (3rdparty/miniply, driven by ply_loader_async.cpp:357-445) and
// the vrdx radix sort for depth ordering (3rdparty/vrdx). This file provides
// the framework's equivalents as a small C-ABI library consumed via ctypes:
//
//  - fast_ply_extract: multithreaded strided gather from a binary
//    little-endian PLY payload into caller-allocated column arrays (the
//    miniply extract_properties analog). The Python side parses the header;
//    this does the heavy row-major -> column-major float traffic.
//  - radix_argsort_f32: 4x8-bit LSD radix argsort over order-preserving
//    uint32 keys (dist.comp.slang:33-38 encodeMinMaxFp32 + vrdx pass
//    structure, vk_radix_sort.cc) for the host sorting path.
//
// Build: c++ -O3 -march=native -std=c++17 -shared -fPIC -pthread
//        (vk_gaussian_splatting_tpu/native.py does this on demand).

#include <atomic>
#include <cstdint>
#include <functional>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

void parallel_rows(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  int nt = hardware_threads();
  if (n < (1 << 16) || nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Gather `n_cols` float32 properties out of `n_rows` records of `stride`
// bytes. offsets[i] = byte offset of property i inside a record; out[i] =
// destination array of n_rows floats. Assumes little-endian f32 properties
// (the 3DGS PLY layout).
void fast_ply_extract(const uint8_t* payload, int64_t n_rows, int64_t stride,
                      const int64_t* offsets, int32_t n_cols, float** out) {
  parallel_rows(n_rows, [&](int64_t lo, int64_t hi) {
    for (int32_t c = 0; c < n_cols; ++c) {
      const uint8_t* src = payload + offsets[c];
      float* dst = out[c];
      for (int64_t r = lo; r < hi; ++r) {
        std::memcpy(&dst[r], src + r * stride, sizeof(float));
      }
    }
  });
}

// Interleaved variant: gathers n_cols consecutive f32 properties starting at
// base_offset into one (n_rows, n_cols) row-major array (for f_rest blocks).
void fast_ply_extract_block(const uint8_t* payload, int64_t n_rows,
                            int64_t stride, int64_t base_offset,
                            int32_t n_cols, float* out) {
  parallel_rows(n_rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      std::memcpy(out + r * n_cols, payload + base_offset + r * stride,
                  sizeof(float) * n_cols);
    }
  });
}

// Order-preserving key transform (dist.comp.slang:33-38).
static inline uint32_t encode_minmax_f32(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  bits ^= (static_cast<uint32_t>(static_cast<int32_t>(bits) >> 31)) | 0x80000000u;
  return bits;
}

// Stable LSD radix argsort of float32 values: writes the permutation into
// `order` (int32). Ascending; NaNs sort last by their encoded keys.
void radix_argsort_f32(const float* values, int64_t n, int32_t* order) {
  std::vector<uint32_t> keys(n);
  std::vector<int32_t> idx_a(n), idx_b(n);
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      keys[i] = encode_minmax_f32(values[i]);
      idx_a[i] = static_cast<int32_t>(i);
    }
  });

  std::vector<uint32_t> scratch_keys(n);
  uint32_t* k_in = keys.data();
  uint32_t* k_out = scratch_keys.data();
  int32_t* i_in = idx_a.data();
  int32_t* i_out = idx_b.data();

  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 8;
    int64_t hist[256] = {0};
    for (int64_t i = 0; i < n; ++i) hist[(k_in[i] >> shift) & 0xFF]++;
    int64_t sum = 0;
    for (int b = 0; b < 256; ++b) {
      int64_t c = hist[b];
      hist[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      const int b = (k_in[i] >> shift) & 0xFF;
      const int64_t dst = hist[b]++;
      k_out[dst] = k_in[i];
      i_out[dst] = i_in[i];
    }
    std::swap(k_in, k_out);
    std::swap(i_in, i_out);
  }
  std::memcpy(order, i_in, sizeof(int32_t) * n);
}

// One-pass 3DGS extraction: walks the payload once per thread-chunk and
// writes every output array, including the channel-major -> coefficient-major
// SH repack (ply_loader_async layout -> SplatSet layout), so Python does no
// further transposes. offsets: [x,y,z, fdc0..2, opacity, s0..2, r0..3,
// f_rest_0] byte offsets (-1 = absent). m = SH coeffs per channel.
void fast_ply_extract_3dgs(const uint8_t* payload, int64_t n, int64_t stride,
                           const int64_t* off, int64_t m,
                           float* means, float* sh_dc, float* opacity,
                           float* scales, float* quats, float* sh_rest) {
  const int64_t o_x = off[0], o_fdc = off[3], o_op = off[6], o_s = off[7],
                o_r = off[10], o_rest = off[14];
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* rec = payload + r * stride;
      std::memcpy(means + r * 3, rec + o_x, 12);
      if (o_fdc >= 0) std::memcpy(sh_dc + r * 3, rec + o_fdc, 12);
      if (o_op >= 0) std::memcpy(opacity + r, rec + o_op, 4);
      if (o_s >= 0) std::memcpy(scales + r * 3, rec + o_s, 12);
      if (o_r >= 0) std::memcpy(quats + r * 4, rec + o_r, 16);
      if (o_rest >= 0 && m > 0) {
        const float* src = reinterpret_cast<const float*>(rec + o_rest);
        float* dst = sh_rest + r * m * 3;
        for (int64_t j = 0; j < m; ++j) {
          dst[j * 3 + 0] = src[j];          // R channel, coeff j
          dst[j * 3 + 1] = src[m + j];      // G
          dst[j * 3 + 2] = src[2 * m + j];  // B
        }
      }
    }
  });
}

}  // extern "C"
