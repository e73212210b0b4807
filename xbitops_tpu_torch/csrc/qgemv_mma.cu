// Fused dequantize + matmul on the tensor cores, for M above a handful of
// rows: out[M, N] = a[M, K] (bf16) @ dequant(qt)[K, N], f32 sums.
//
// The second form of the port of the Pallas kernel
// xbitops_tpu/kernels/qgemv_kernel.py:_kernel (entry qmatmul_kernel,
// qgemv_kernel.py:335); qgemv.cu holds the CUDA-core form (f32 activations,
// `precise`) and qgemv_word.cu the form for a few rows.
//
// What bounds it on an H100: operations, from M of a few hundred on (the
// packed weight is read once for a whole M tile); below that the packed
// stream, and split-K fills the card.
//
// Design:
// - the algebra is the TPU kernel's: per scale group an f32 dot = a . wq over
//   the INTEGER weight values and asum = sum(a), folded in f32 as
//   acc += s_g * dot - sz_g * asum.  wq is exact in bf16 for every width 1-8,
//   so nothing is rounded before the product;
// - a block owns 64*MI x 64 outputs (MI = 1 or 2), eight warps as 4 (M) x 2
//   (N), a warp 16*MI x 32, and walks K in sub-chunks of 64 K rows that lie
//   inside one scale group; products are mma.sync.m16n8k16 bf16 with the
//   activations through ldmatrix;
// - asum comes from the same instruction: one more product a sub-chunk step
//   against a B fragment of ones puts the row sums into an accumulator
//   fragment, in the layout the fold needs;
// - PAIRED (the 4-bit paired plane, the main path): K is walked BY WORD ROWS.
//   A word of row r of a K-tile holds the eight K rows j*(tile_k/4) + 2r + h
//   (bit 4j + 16h), so 32 word rows are four sub-chunks (j = 0..3) of 64
//   consecutive K rows, tile_k/4 apart.  The raw words go to shared memory
//   once (cp.async) and serve all four: (w >> 4j) & 0x000F000F is already the
//   B fragment's pair (K rows 2r, 2r + 1 in the low and high half), and one
//   OR and one bf16x2 subtraction make it bf16 (mma.cuh).  Every bit of every
//   word loaded is used; a contiguous K chunk would use a quarter;
// - every other layout (slot planes, several planes, odd tiles): sub-chunks
//   are contiguous K rows; the block decodes them row by row into the same
//   pair words (values up to 255 in each half) and the product loop is the
//   same, with the byte decode;
// - three stages of activations (cp.async) and two of words are in flight
//   while a sub-chunk multiplies; one __syncthreads a sub-chunk;
// - split-K over blockIdx.z in whole sub-chunks (chunks of four when PAIRED)
//   with f32 partial sums and the ordered second pass (splitk.cuh);
// - ragged M, N and a group's tail are masked: rows past M and columns past N
//   load zeros, K rows past a short sub-chunk decode to zero and drop out of
//   the ones fragment.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "planes.cuh"
#include "splitk.cuh"

namespace {

using xb::load_scale;
using xb::Planes;

constexpr int kThreads = 256;
constexpr int BN = 64;        // columns a block
constexpr int KS = 64;        // K rows a sub-chunk
constexpr int kAStride = KS + 8;  // bf16 a row of the activation tile: conflict-free ldmatrix
constexpr int kWStride = BN + 8;  // words a row of the weight tile: conflict-free fragments
constexpr int kWRows = KS / 2;    // pair rows (PAIRED: word rows) a weight tile
constexpr int kStages = 3;

template <int MI, bool PAIRED>
struct Smem {
  static constexpr int BM = 64 * MI;
  static constexpr int kWBufs = PAIRED ? 2 : kStages;
  static constexpr int kScaleRows = PAIRED ? 4 : 1;  // sub-chunks a weight tile serves
  __nv_bfloat16 a[kStages][BM][kAStride];
  uint32_t w[kWBufs][kWRows][kWStride];
  float sc[kWBufs][kScaleRows][2][BN];  // [..][0]: s, [..][1]: sz
};

struct Args {
  const __nv_bfloat16* a;
  int M, Ka, N;  // Ka: columns of a; packed rows from Ka on meet zeros
  Planes pl;
  const void* s;
  const void* sz;
  int s_f16, tile_k, gt, gt_pad;
  int n_sub, per;  // sub-chunks in all, and a split
  float* part;
  void* out;
  int out_f32;
};

template <int MI, bool PAIRED>
__global__ void __launch_bounds__(kThreads, 2)
qgemv_mma_kernel(const Args p) {
  using SM = Smem<MI, PAIRED>;
  constexpr int BM = SM::BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m_warp = (warp & 3) * 16 * MI, n_warp = (warp >> 2) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, tile_k = p.tile_k;
  const int g_tile = tile_k / p.gt;           // K rows a scale row
  const int cpg = (g_tile + KS - 1) / KS;     // sub-chunks a group (not PAIRED)
  const bool n_vec = (N % 4) == 0;
  const bool wide = p.pl.n > 1 ? true : p.pl.pb[0] > 4;  // values need more than a nibble
  const int i_begin = blockIdx.z * p.per;
  const int i_end = min(p.n_sub, i_begin + p.per);

  // Sub-chunk i: its first K row and its length.  PAIRED: chunk i / 4 is 32
  // word rows of one K-tile and i % 4 is the nibble j.
  auto first_row = [&](int i, int& kc) -> int {
    if (PAIRED) {
      const int c = i >> 2, j = i & 3, cpt = tile_k >> 8;
      const int t = c / cpt, rb = c - t * cpt;
      kc = KS;
      return t * tile_k + j * (tile_k >> 2) + rb * KS;
    }
    const int u = i / cpg, part = i - u * cpg;
    kc = min(KS, g_tile - part * KS);
    return u * g_tile + part * KS;
  };
  auto scale_index = [&](int k0, int col) -> size_t {
    const int t = k0 / tile_k, gi = (k0 - t * tile_k) / g_tile;
    return (static_cast<size_t>(t) * p.gt_pad + gi) * N + min(n0 + col, N - 1);
  };

  // Queue the loads of sub-chunk i into stage `slot` (no commit).
  auto load = [&](int i, int slot) {
    int kc;
    const int k0 = first_row(i, kc);
    for (int idx = tid; idx < BM * (KS / 8); idx += kThreads) {
      const int m = idx >> 3, q = idx & 7;
      const int col = k0 + q * 8;
      const bool valid = m0 + m < M && col < p.Ka;
      const __nv_bfloat16* src = p.a + (valid ? static_cast<size_t>(m0 + m) * p.Ka + col : 0);
      xb::cp_async_16(&sm.a[slot][m][q * 8], src, valid);
    }
    if constexpr (PAIRED) {
      if ((i & 3) != 0) return;  // the chunk's words came with its first sub-chunk
      const int c = i >> 2, cpt = tile_k >> 8;
      const int t = c / cpt, rb = c - t * cpt;
      const int wb = ((i - i_begin) >> 2) & 1;
      const uint32_t* rows = p.pl.ptr[0] + static_cast<size_t>(t * (tile_k >> 3) + rb * kWRows) * N;
      if (n_vec) {
        for (int idx = tid; idx < kWRows * (BN / 4); idx += kThreads) {
          const int r = idx / (BN / 4), c4 = idx - r * (BN / 4);
          const int n = n0 + c4 * 4;
          const bool valid = n < N;
          xb::cp_async_16(&sm.w[wb][r][c4 * 4], rows + static_cast<size_t>(r) * N + (valid ? n : 0),
                          valid);
        }
      } else {
        for (int idx = tid; idx < kWRows * BN; idx += kThreads) {
          const int r = idx / BN, cc = idx - r * BN;
          const int n = n0 + cc;
          const bool valid = n < N;
          xb::cp_async_4(&sm.w[wb][r][cc], rows + static_cast<size_t>(r) * N + (valid ? n : 0),
                         valid);
        }
      }
      {
        // the four sub-chunks' scale rows: one value a thread
        const int jj = tid >> 6, col = tid & 63;
        const int kj = t * tile_k + jj * (tile_k >> 2) + rb * KS;
        const size_t si = scale_index(kj, col);
        sm.sc[wb][jj][0][col] = load_scale(p.s, si, p.s_f16);
        sm.sc[wb][jj][1][col] = load_scale(p.sz, si, p.s_f16);
      }
    } else {
      // decode row by row into pair words: K rows 2r and 2r + 1 of the
      // sub-chunk in the low and the high half, zero past its end
      for (int item = tid; item < kWRows * (BN / 4); item += kThreads) {
        const int r = item / (BN / 4), n4 = item - r * (BN / 4);
        const int n = n0 + n4 * 4;
        uint32_t pw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kr = 2 * r + h;
          if (kr >= kc || n >= N) continue;
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          int off = 0;
          for (int pi = 0; pi < p.pl.n; ++pi) {
            int row, shift;
            xb::plane_slot(p.pl, pi, tile_k, k0 + kr, row, shift);
            const uint32_t mask = (1u << p.pl.pb[pi]) - 1u;
            uint32_t w[4];
            if (n_vec) {
              xb::load_words<4>(p.pl.ptr[pi], row, N, n, w);
            } else {
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
                w[cc] = n + cc < N ? __ldg(p.pl.ptr[pi] + static_cast<size_t>(row) * N + n + cc)
                                   : 0u;
            }
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) v[cc] |= ((w[cc] >> shift) & mask) << off;
            off += p.pl.pb[pi];
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) pw[cc] |= v[cc] << (16 * h);
        }
        *reinterpret_cast<uint4*>(&sm.w[slot][r][n4 * 4]) = make_uint4(pw[0], pw[1], pw[2], pw[3]);
      }
      if (tid < BN) {
        const size_t si = scale_index(k0, tid);
        sm.sc[slot][0][0][tid] = load_scale(p.s, si, p.s_f16);
        sm.sc[slot][0][1][tid] = load_scale(p.sz, si, p.s_f16);
      }
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (i_begin < i_end) load(i_begin, 0);
  xb::cp_async_commit();
  if (i_begin + 1 < i_end) load(i_begin + 1, 1);
  xb::cp_async_commit();

  for (int i = i_begin; i < i_end; ++i) {
    const int rel = i - i_begin;
    const int slot = rel % kStages;
    xb::cp_async_wait<1>();  // this thread's copies of sub-chunk i have landed
    __syncthreads();         // everyone's have, and sub-chunk i - 1 is consumed
    if (i + 2 < i_end) load(i + 2, (rel + 2) % kStages);
    xb::cp_async_commit();

    int kc = KS;
    if (!PAIRED) first_row(i, kc);
    const int wb = PAIRED ? (rel >> 2) & 1 : slot;
    const int j = PAIRED ? (i & 3) : 0;
    const uint32_t(*wt)[kWStride] = sm.w[wb];
    const float* s_row = sm.sc[wb][j][0];
    const float* sz_row = sm.sc[wb][j][1];

    float dot[MI][4][4], asum[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) asum[mi][e] = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) dot[mi][ni][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      if (!PAIRED && ks * 16 >= kc) break;
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        xb::ldmatrix_x4(af[mi],
                        &sm.a[slot][m_warp + mi * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
      uint32_t ones0 = xb::kBf16x2_1, ones1 = xb::kBf16x2_1;
      if (!PAIRED) {
        const int k = ks * 16 + 2 * t4;
        ones0 = (k < kc ? 0x3F80u : 0u) | (k + 1 < kc ? 0x3F800000u : 0u);
        ones1 = (k + 8 < kc ? 0x3F80u : 0u) | (k + 9 < kc ? 0x3F800000u : 0u);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t w0 = wt[ks * 8 + t4][n_warp + ni * 8 + g];
        const uint32_t w1 = wt[ks * 8 + t4 + 4][n_warp + ni * 8 + g];
        uint32_t b0, b1;
        if (PAIRED) {
          b0 = xb::nibbles_to_bf162(w0 >> (4 * j));
          b1 = xb::nibbles_to_bf162(w1 >> (4 * j));
        } else if (wide) {
          b0 = xb::bytes_to_bf162(w0);
          b1 = xb::bytes_to_bf162(w1);
        } else {
          b0 = xb::nibbles_to_bf162(w0);
          b1 = xb::nibbles_to_bf162(w1);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) xb::mma_bf16(dot[mi][ni], af[mi], b0, b1);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) xb::mma_bf16(asum[mi], af[mi], ones0, ones1);
    }
    // fold the sub-chunk with its group's scales
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n_warp + ni * 8 + 2 * t4;
      const float2 sv = *reinterpret_cast<const float2*>(s_row + col);
      const float2 zv = *reinterpret_cast<const float2*>(sz_row + col);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        acc[mi][ni][0] = fmaf(-zv.x, asum[mi][0], fmaf(sv.x, dot[mi][ni][0], acc[mi][ni][0]));
        acc[mi][ni][1] = fmaf(-zv.y, asum[mi][0], fmaf(sv.y, dot[mi][ni][1], acc[mi][ni][1]));
        acc[mi][ni][2] = fmaf(-zv.x, asum[mi][2], fmaf(sv.x, dot[mi][ni][2], acc[mi][ni][2]));
        acc[mi][ni][3] = fmaf(-zv.y, asum[mi][2], fmaf(sv.y, dot[mi][ni][3], acc[mi][ni][3]));
      }
    }
  }
  xb::cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + m_warp + mi * 16 + g + ((e & 2) ? 8 : 0);
        const int n = n0 + n_warp + ni * 8 + 2 * t4 + (e & 1);
        if (m >= M || n >= N) continue;
        const size_t o = static_cast<size_t>(m) * N + n;
        const float v = acc[mi][ni][e];
        if (p.part)
          p.part[static_cast<size_t>(blockIdx.z) * M * N + o] = v;
        else if (p.out_f32)
          static_cast<float*>(p.out)[o] = v;
        else
          static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16(v);
      }
}

template <int MI, bool PAIRED>
int launch(const Args& args, int splits, cudaStream_t st) {
  using SM = Smem<MI, PAIRED>;
  auto kernel = qgemv_mma_kernel<MI, PAIRED>;
  // above 48 KB shared memory is dynamic and has to be asked for
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(SM)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((args.N + BN - 1) / BN, (args.M + SM::BM - 1) / SM::BM, splits);
  kernel<<<grid, kThreads, sizeof(SM), st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: bf16 [M, Ka] contiguous and 16-byte aligned; K the packed row count and
// Ka <= K a multiple of 8 (the packed rows from Ka on meet zeros: K padding).
// Grid: x = N / 64, y = M / 128 (M / 64 when M <= 64), z = `splits` ranges of
// `per` sub-chunks of 64 K rows (PAIRED: a multiple of 4; otherwise a group of
// g_tile rows is ceil(g_tile / 64) sub-chunks).  With splits > 1, `part` is
// an f32 workspace of splits * M * N values.  Returns cudaErrorInvalidValue
// (1) for a layout it does not take (a scale group that is not a multiple of
// 8 rows).
extern "C" int xb_qgemv_mma(const void* a, int M, int K, int Ka, int N, const void* p0,
                            const void* p1,
                            const void* p2, int pb0, int pb1, int pb2, int paired, const void* s,
                            const void* sz, int s_f16, int tile_k, int gt, int gt_pad, int splits,
                            int per, void* part, void* out, int out_f32, void* stream) {
  if (gt < 1 || tile_k % gt || K % tile_k || splits < 1 || per < 1 || (splits > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g_tile = tile_k / gt;
  if (g_tile % 8 || Ka > K || Ka % 8 || reinterpret_cast<uintptr_t>(a) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.a = static_cast<const __nv_bfloat16*>(a);
  args.M = M;
  args.Ka = Ka;
  args.N = N;
  args.pl = xb::make_planes(p0, p1, p2, pb0, pb1, pb2, paired);
  args.s = s;
  args.sz = sz;
  args.s_f16 = s_f16;
  args.tile_k = tile_k;
  args.gt = gt;
  args.gt_pad = gt_pad;
  const bool whole_words = args.pl.n == 1 && paired && tile_k % 256 == 0 && g_tile % KS == 0;
  args.n_sub = whole_words ? K / KS : (K / g_tile) * ((g_tile + KS - 1) / KS);
  args.per = per;
  if (whole_words && per % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(splits) * per < args.n_sub)
    return static_cast<int>(cudaErrorInvalidValue);
  args.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  args.out = out;
  args.out_f32 = out_f32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (M <= 64)
    err = whole_words ? launch<1, true>(args, splits, st) : launch<1, false>(args, splits, st);
  else
    err = whole_words ? launch<2, true>(args, splits, st) : launch<2, false>(args, splits, st);
  if (err != 0 || splits == 1) return err;
  return xb::add_splits(args.part, splits, M, N, out, out_f32, st);
}
