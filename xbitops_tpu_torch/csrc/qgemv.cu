// Fused dequantize + matmul: out[M, N] = a[M, K] @ dequant(qt)[K, N], on the
// CUDA cores in f32.
//
// The first form of the port of the Pallas kernel
// xbitops_tpu/kernels/qgemv_kernel.py:_kernel (entry qmatmul_kernel,
// qgemv_kernel.py:335).  With bf16 activations qgemv_word.cu and
// qgemv_word_planes.cu (a few rows: every width at default packed storage)
// and qgemv_mma.cu (the tensor-core tile) have taken its place wherever they
// decode the layout; this one keeps f32 activations (`precise`: bf16 products
// cannot hold rel 1e-5) and, at M <= 8, the layouts the few-rows form turns
// away: scale groups that cut a run of 16 K rows (not a multiple of 16; a
// 4-bit weight then keeps the slot layout), K-tiles that are not whole units
// of the walk, f32 scales or N not a multiple of 8 at widths 1-3 and 5-7; and
// at any M scale groups that are not multiples of 8 rows.
//
// What bounds it on an H100: at M <= 8 the packed weight stream is the only
// large read, so the bound is device-memory bandwidth; it reaches 4-9% of it
// at widths 1-7 (chip_smoke.py, H100 80GB HBM3, 700 W: the five 7B shapes at
// M=8 sum to 0.43 ms at width 1, 0.92 at 3, 1.62 at 7, 2.7-4.7x the few-rows
// form's planes kernel), held back by an integer decode per weight from
// shared tables and by fetching a word again for each K row it holds.  Above
// that the f32 multiply-adds bound it (67 TFLOP/s at most).
//
// Design:
// - a block covers TM rows of M and 32*CPL columns of N: lane l owns CPL
//   adjacent columns, so a warp reads a row of a plane in one coalesced
//   access (16 bytes a lane at decode, CPL = 4);
// - the K rows split into `splits` ranges, one per blockIdx.z, so that small
//   M still puts enough blocks (and loads in flight) on the card; with more
//   than one split, each writes f32 partial sums and a second kernel adds
//   them in split order (deterministic);
// - a block walks its K range in 256-row chunks: the chunk's activations are
//   staged once in shared memory (f32, [row][m]) and the eight warps split
//   its rows; per row a lane decodes its CPL weights from the plane words
//   (word row and shift per row come from shared tables) and accumulates
//   dot += a*wq and asum += a;
// - at each scale-group boundary: acc += s_g*dot - sz_g*asum in f32, the
//   same algebra as the TPU kernel without its +128 bias trick;
// - the eight warps' partial sums reduce through shared memory at the end.
// Every width 1-8 decodes through the same generic path; planes.cuh has the
// layout of a plane's words.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "planes.cuh"
#include "splitk.cuh"

namespace {

using xb::kMaxPlanes;
using xb::load_scale;
using xb::load_words;
using xb::Planes;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;  // == kThreads: one staged row per thread

template <int TM, int CPL>
__global__ void __launch_bounds__(kThreads)
qgemv_kernel(const void* __restrict__ a, int a_f32, int M, int K, int N, Planes pl,
             const void* __restrict__ s, const void* __restrict__ sz, int s_f16,
             int tile_k, int gt, int gt_pad, int k_per_split,
             float* __restrict__ part, void* __restrict__ out, int out_f32) {
  static_assert(kChunk == kThreads, "one staged activation row per thread");
  __shared__ __align__(16) float a_s[kChunk * TM];  // [row][m]; reused to reduce
  __shared__ int w_row[kMaxPlanes][kChunk];
  __shared__ int w_shift[kMaxPlanes][kChunk];

  constexpr int kTileN = 32 * CPL;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kTileN + lane * CPL;
  const int nc = min(n0, N - CPL);  // loads stay in bounds; stores check the column
  const int m0 = blockIdx.y * TM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int g_tile = tile_k / gt;  // K rows per scale row
  const uint32_t mask0 = (1u << pl.pb[0]) - 1u;
  const uint32_t mask1 = pl.n > 1 ? (1u << pl.pb[1]) - 1u : 0u;
  const uint32_t mask2 = pl.n > 2 ? (1u << pl.pb[2]) - 1u : 0u;
  const int off1 = pl.pb[0];
  const int off2 = pl.pb[0] + (pl.n > 1 ? pl.pb[1] : 0);

  float acc[TM][CPL];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    const int kc = min(kChunk, k_end - k0);
    __syncthreads();  // the previous chunk is consumed
    {
      // thread r stages activation row k0 + r for every m (for each m the
      // block's loads are contiguous in K) and that row's plane tables
      const int r = threadIdx.x;
      float v[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        v[m] = 0.f;
        if (r < kc && m0 + m < M) {
          const size_t idx = static_cast<size_t>(m0 + m) * K + k0 + r;
          v[m] = a_f32 ? static_cast<const float*>(a)[idx]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(a)[idx]);
        }
      }
#pragma unroll
      for (int q = 0; q < TM / 4; ++q)
        reinterpret_cast<float4*>(a_s + r * TM)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      if (r < kc) {
        for (int p = 0; p < pl.n; ++p)
          xb::plane_slot(pl, p, tile_k, k0 + r, w_row[p][r], w_shift[p][r]);
      }
    }
    __syncthreads();

    const int rpw = (kc + kWarps - 1) / kWarps;
    int r = warp * rpw;
    const int r_end = min(kc, r + rpw);
    while (r < r_end) {
      const int u = (k0 + r) / g_tile;  // global scale row: tile u/gt, row u%gt
      const int seg_end = min(r_end, (u + 1) * g_tile - k0);
      float dot[TM][CPL], asum[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        asum[m] = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) dot[m][c] = 0.f;
      }
#pragma unroll 4
      for (; r < seg_end; ++r) {
        uint32_t w[CPL], wq[CPL];
        load_words<CPL>(pl.ptr[0], w_row[0][r], N, nc, w);
#pragma unroll
        for (int c = 0; c < CPL; ++c) wq[c] = (w[c] >> w_shift[0][r]) & mask0;
        if (pl.n > 1) {
          load_words<CPL>(pl.ptr[1], w_row[1][r], N, nc, w);
#pragma unroll
          for (int c = 0; c < CPL; ++c) wq[c] |= ((w[c] >> w_shift[1][r]) & mask1) << off1;
        }
        if (pl.n > 2) {
          load_words<CPL>(pl.ptr[2], w_row[2][r], N, nc, w);
#pragma unroll
          for (int c = 0; c < CPL; ++c) wq[c] |= ((w[c] >> w_shift[2][r]) & mask2) << off2;
        }
        float wf[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) wf[c] = static_cast<float>(wq[c]);
        const float4* av = reinterpret_cast<const float4*>(a_s + r * TM);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 x4 = av[q];
          const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            asum[4 * q + i] += xs[i];
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              dot[4 * q + i][c] = fmaf(xs[i], wf[c], dot[4 * q + i][c]);
          }
        }
      }
      const int t = u / gt, gi = u - t * gt;
      const size_t si = (static_cast<size_t>(t) * gt_pad + gi) * N + nc;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float sv = load_scale(s, si + c, s_f16);
        const float szv = load_scale(sz, si + c, s_f16);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          acc[m][c] = fmaf(sv, dot[m][c], acc[m][c]);
          acc[m][c] = fmaf(-szv, asum[m], acc[m][c]);
        }
      }
    }
  }

  float* red = a_s;  // kWarps * TM * 32 floats == kChunk * TM: one column at a time
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    __syncthreads();
#pragma unroll
    for (int m = 0; m < TM; ++m) red[(warp * TM + m) * 32 + lane] = acc[m][c];
    __syncthreads();
    for (int i = threadIdx.x; i < TM * 32; i += kThreads) {
      const int m = i / 32, l = i % 32;
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += red[(w * TM + m) * 32 + l];
      const int nn = blockIdx.x * kTileN + l * CPL + c, mm = m0 + m;
      if (nn < N && mm < M) {
        const size_t o = static_cast<size_t>(mm) * N + nn;
        if (part)
          part[static_cast<size_t>(blockIdx.z) * M * N + o] = v;
        else if (out_f32)
          static_cast<float*>(out)[o] = v;
        else
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
      }
    }
  }
}

template <int TM, int CPL>
void launch(const dim3& grid, cudaStream_t st, const void* a, int a_f32, int M, int K, int N,
            const Planes& pl, const void* s, const void* sz, int s_f16, int tile_k, int gt,
            int gt_pad, int k_per_split, float* part, void* out, int out_f32) {
  qgemv_kernel<TM, CPL><<<grid, kThreads, 0, st>>>(a, a_f32, M, K, N, pl, s, sz, s_f16, tile_k,
                                                   gt, gt_pad, k_per_split, part, out, out_f32);
}

}  // namespace

// Grid: x = N / (32 * CPL), with CPL = 4 when M <= 8 and N % 4 == 0, else 1;
// y = M / TM, with TM = 8 when M <= 8, else 32; z = `splits` ranges of K of
// `k_per_split` rows each (a multiple of 256).  With splits > 1, `part` is an
// f32 workspace of splits * M * N values.
extern "C" int xb_qgemv(const void* a, int a_f32, int M, int K, int N,
                        const void* p0, const void* p1, const void* p2,
                        int pb0, int pb1, int pb2, int paired,
                        const void* s, const void* sz, int s_f16,
                        int tile_k, int gt, int gt_pad, int splits, int k_per_split,
                        void* part, void* out, int out_f32, void* stream) {
  if (k_per_split % kChunk || splits < 1 || (splits > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes pl = xb::make_planes(p0, p1, p2, pb0, pb1, pb2, paired);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = splits > 1 ? static_cast<float*>(part) : nullptr;
  if (M <= 8 && N % 4 == 0) {
    launch<8, 4>(dim3((N + 127) / 128, 1, splits), st, a, a_f32, M, K, N, pl, s, sz, s_f16,
                 tile_k, gt, gt_pad, k_per_split, pt, out, out_f32);
  } else if (M <= 8) {
    launch<8, 1>(dim3((N + 31) / 32, 1, splits), st, a, a_f32, M, K, N, pl, s, sz, s_f16,
                 tile_k, gt, gt_pad, k_per_split, pt, out, out_f32);
  } else {
    launch<32, 1>(dim3((N + 31) / 32, (M + 31) / 32, splits), st, a, a_f32, M, K, N, pl, s,
                  sz, s_f16, tile_k, gt, gt_pad, k_per_split, pt, out, out_f32);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return xb::add_splits(pt, splits, M, N, out, out_f32, st);
}
