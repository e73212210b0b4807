// Dequantize packed planes to a dense matrix: out[K, N] = wq * s - sz per
// scale group, in bf16, fp16 or f32.
//
// Replaces the Pallas kernel xbitops_tpu/kernels/dequant_kernel.py:_kernel
// (entry dequant_kernel, dequant_kernel.py:54).  The card stores fp16, so
// the TPU op's f32 detour for fp16 outputs is gone.
//
// What bounds it on an H100: bytes.  It reads bits/8 bytes a weight (and a
// sliver of scales) and writes 2 or 4: nothing is reused, so the least time
// is (packed + dense) bytes over the memory rate.
//
// Design: a thread owns one word of the FIRST plane (the widest, so the one
// with the fewest rows a word) at CPL adjacent columns, and emits every K row
// that word holds: 32/pb rows of CPL values.  The first plane is so read
// exactly once, 16 bytes a lane, a warp's lanes on adjacent columns; a row's
// bits in the narrower planes of a multi-plane width come through the cache
// (their words hold more rows and are few).  A warp writes one row of
// 32*CPL adjacent values at a time: 256 contiguous bytes in bf16/fp16, 512
// in f32.  The arithmetic is wq*s then -sz in f32 with no fused
// multiply-add and one rounding to the output type, so the result has the
// bits of the plain version (formats.dequant_qtensor_reference).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "planes.cuh"

namespace {

using xb::load_scale;
using xb::load_words;
using xb::Planes;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

enum OutType { kBF16 = 0, kF16 = 1, kF32 = 2 };

template <int OUT, int CPL>
__device__ __forceinline__ void store_row(void* out, size_t idx, const float (&v)[CPL]) {
  if constexpr (OUT == kF32) {
    float* o = static_cast<float*>(out) + idx;
    if constexpr (CPL == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c) o[c] = v[c];
    }
  } else if constexpr (OUT == kBF16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + idx;
    if constexpr (CPL == 4) {
      const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
      const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o) = u;
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c) o[c] = __float2bfloat16_rn(v[c]);
    }
  } else {
    __half* o = static_cast<__half*>(out) + idx;
    if constexpr (CPL == 4) {
      const __half2 lo = __halves2half2(__float2half_rn(v[0]), __float2half_rn(v[1]));
      const __half2 hi = __halves2half2(__float2half_rn(v[2]), __float2half_rn(v[3]));
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o) = u;
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c) o[c] = __float2half_rn(v[c]);
    }
  }
}

// Grid: x over column tiles of 32*CPL, y over groups of kWarps word rows of
// the first plane.
template <int OUT, int CPL>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(int K, int N, Planes pl, const void* __restrict__ s, const void* __restrict__ sz,
               int s_f16, int tile_k, int gt, int gt_pad, void* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * 32 + lane) * CPL;
  const int pb0 = pl.pb[0];
  const int ratio0 = 32 / pb0;          // K rows a word of the first plane holds
  const int wt0 = tile_k / ratio0;      // its word rows a K-tile
  const int wrow = blockIdx.y * kWarps + warp;  // global word row of the first plane
  if (n0 >= N || wrow >= K / ratio0) return;
  const int t = wrow / wt0, r = wrow - t * wt0;
  const int g_tile = tile_k / gt;  // K rows per scale row
  const uint32_t mask0 = (1u << pb0) - 1u;

  uint32_t w0[CPL];
  load_words<CPL>(pl.ptr[0], wrow, N, n0, w0);

  for (int i = 0; i < ratio0; ++i) {
    // the i-th value of the word: its local row and bit shift
    int kl, sh;
    if (pl.paired) {
      const int j = i >> 1, h = i & 1;
      kl = j * (tile_k >> 2) + 2 * r + h;
      sh = 4 * j + 16 * h;
    } else {
      kl = i * wt0 + r;
      sh = pb0 * i;
    }
    const int k = t * tile_k + kl;
    uint32_t wq[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) wq[c] = (w0[c] >> sh) & mask0;
    int off = pb0;
    for (int p = 1; p < pl.n; ++p) {
      int row, shp;
      xb::plane_slot(pl, p, tile_k, k, row, shp);
      uint32_t w[CPL];
      load_words<CPL>(pl.ptr[p], row, N, n0, w);
      const uint32_t mask = (1u << pl.pb[p]) - 1u;
#pragma unroll
      for (int c = 0; c < CPL; ++c) wq[c] |= ((w[c] >> shp) & mask) << off;
      off += pl.pb[p];
    }
    const size_t si = (static_cast<size_t>(t) * gt_pad + kl / g_tile) * N + n0;
    float v[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const float sv = load_scale(s, si + c, s_f16);
      const float szv = load_scale(sz, si + c, s_f16);
      v[c] = __fsub_rn(__fmul_rn(static_cast<float>(wq[c]), sv), szv);
    }
    store_row<OUT, CPL>(out, static_cast<size_t>(k) * N + n0, v);
  }
}

template <int OUT>
void launch(cudaStream_t st, int K, int N, const Planes& pl, const void* s, const void* sz,
            int s_f16, int tile_k, int gt, int gt_pad, void* out) {
  const int wrows = K / (32 / pl.pb[0]);
  if (N % 4 == 0) {
    dim3 grid((N / 4 + 31) / 32, (wrows + kWarps - 1) / kWarps);
    dequant_kernel<OUT, 4><<<grid, kThreads, 0, st>>>(K, N, pl, s, sz, s_f16, tile_k, gt, gt_pad,
                                                      out);
  } else {
    dim3 grid((N + 31) / 32, (wrows + kWarps - 1) / kWarps);
    dequant_kernel<OUT, 1><<<grid, kThreads, 0, st>>>(K, N, pl, s, sz, s_f16, tile_k, gt, gt_pad,
                                                      out);
  }
}

}  // namespace

// out_type: 0 bf16, 1 fp16, 2 f32.  `out` is [K, N] contiguous; K is a
// multiple of tile_k.
extern "C" int xb_dequant(int K, int N, const void* p0, const void* p1, const void* p2, int pb0,
                          int pb1, int pb2, int paired, const void* s, const void* sz, int s_f16,
                          int tile_k, int gt, int gt_pad, void* out, int out_type, void* stream) {
  if (K % tile_k || out_type < 0 || out_type > 2) return static_cast<int>(cudaErrorInvalidValue);
  const Planes pl = xb::make_planes(p0, p1, p2, pb0, pb1, pb2, paired);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_type == kBF16)
    launch<kBF16>(st, K, N, pl, s, sz, s_f16, tile_k, gt, gt_pad, out);
  else if (out_type == kF16)
    launch<kF16>(st, K, N, pl, s, sz, s_f16, tile_k, gt, gt_pad, out);
  else
    launch<kF32>(st, K, N, pl, s, sz, s_f16, tile_k, gt, gt_pad, out);
  return static_cast<int>(cudaGetLastError());
}
