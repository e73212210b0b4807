// The packed plane layout (format v3) on the device: where a K row's bits sit
// in each plane, and how scales load.  Shared by every kernel that reads a
// packed weight (qgemv.cu, dequant.cu, qgemv_a8.cu).
//
// A b-bit value is the sum of its planes' values shifted by the widths of the
// planes before them.  Within a K-tile of tile_k rows, for a slot plane of
// width pb (ratio = 32/pb, wt = tile_k/ratio) local row kl sits in slot
// j = kl/wt (bits pb*j) of word row t*wt + kl%wt; for the PAIRED 4-bit plane,
// kl = j*(tile_k/4) + 2r + h sits at bit 4j + 16h of word row t*(tile_k/8) + r.
#pragma once
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xb {

constexpr int kMaxPlanes = 3;

struct Planes {
  const uint32_t* ptr[kMaxPlanes];
  int pb[kMaxPlanes];
  int n;
  int paired;
};

inline Planes make_planes(const void* p0, const void* p1, const void* p2, int pb0, int pb1,
                          int pb2, int paired) {
  Planes pl;
  pl.ptr[0] = static_cast<const uint32_t*>(p0);
  pl.ptr[1] = static_cast<const uint32_t*>(p1);
  pl.ptr[2] = static_cast<const uint32_t*>(p2);
  pl.pb[0] = pb0;
  pl.pb[1] = pb1;
  pl.pb[2] = pb2;
  pl.n = p2 ? 3 : (p1 ? 2 : 1);
  pl.paired = paired;
  return pl;
}

// Word row and bit shift of K row `k` in plane `p`.
__device__ __forceinline__ void plane_slot(const Planes& pl, int p, int tile_k, int k, int& row,
                                           int& shift) {
  const int t = k / tile_k, kl = k - t * tile_k;
  if (p == 0 && pl.paired) {
    const int ph = tile_k >> 2;
    const int j = kl / ph, rem = kl - j * ph;
    row = t * (tile_k >> 3) + (rem >> 1);
    shift = 4 * j + 16 * (rem & 1);
  } else {
    const int wt = tile_k * pl.pb[p] / 32;
    const int j = kl / wt;
    row = t * wt + (kl - j * wt);
    shift = pl.pb[p] * j;
  }
}

// Bit offset of plane `p` inside the value.
__device__ __forceinline__ int plane_offset(const Planes& pl, int p) {
  int off = 0;
  for (int q = 0; q < p; ++q) off += pl.pb[q];
  return off;
}

__device__ __forceinline__ float load_scale(const void* p, size_t i, int f16) {
  return f16 ? __half2float(static_cast<const __half*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// The CPL words of a plane at word row `row`, columns [nc, nc + CPL).
template <int CPL>
__device__ __forceinline__ void load_words(const uint32_t* plane, int row, int N, int nc,
                                           uint32_t (&w)[CPL]) {
  const uint32_t* p = plane + static_cast<size_t>(row) * N + nc;
  if constexpr (CPL == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c) w[c] = __ldg(p + c);
  }
}

}  // namespace xb
