// Fused dequantize + matmul for a few rows (decode: M <= 16), reading every
// packed word once: out[M, N] = a[M, K] (bf16) @ dequant(qt)[K, N], f32 sums,
// for the paired 4-bit plane and the 8-bit plane.
//
// The third form of the port of the Pallas kernel
// xbitops_tpu/kernels/qgemv_kernel.py:_kernel (entry qmatmul_kernel,
// qgemv_kernel.py:335); qgemv.cu holds the CUDA-core form (f32 activations,
// every other width) and qgemv_mma.cu the tile for large M.
//
// What bounds it on an H100: bytes.  The packed weight stream is the only
// large read, so the card's memory rate is the limit; what keeps a kernel
// from it is instructions a byte (decode, fold), launches, and too little in
// flight.
//
// Design:
// - K splits BY WORD ROWS.  A word is loaded by one lane of one block, once,
//   and every K row in it is consumed there: the eight of a paired 4-bit word
//   (K rows j*(tile_k/4) + 2r + h at bit 4j + 16h) or the four of an 8-bit
//   word (K rows j*(tile_k/4) + r at bit 8j).  A block takes `per` slabs of
//   16 word rows of 256 columns and stages, four slabs at a time, just the
//   activations those words meet: for each j a run of 32 (8-bit: 16)
//   consecutive K rows a slab;
// - the products run on the tensor cores, TRANSPOSED: out^T = W^T a^T, so the
//   weights are the 16-row A operand of mma.sync.m16n8k16 and the M <= 8
//   activation rows are the 8 columns of B (M <= 16: two B tiles); no row of
//   the instruction is wasted.  A lane's 16-byte load (word row r, columns
//   4g..4g+3 of the warp's 32) is, after a shift and a mask, A-fragment
//   registers of two 16-column tiles (tile ti holds the warp's columns
//   4c + 2ti and 4c + 2ti + 1 as its rows c and c + 8), so the weights never
//   pass shared memory and the decode is one OR and one bf16x2 subtraction
//   for two weights (mma.cuh).  A lane ends with 4 adjacent columns of 2 rows;
// - the TPU kernel's algebra: per scale group dot = a . wq over the integer
//   values and asum = sum(a) (one more product, a fragment of ones against
//   the same B), folded in f32 as acc += s_g * dot - sz_g * asum.  LAZY: where
//   the four slabs staged together lie, for each j, in one scale group (group
//   of 128 rows, K-tile of 512 or more), dot and asum run through all four
//   and fold once: run per slab, the fold was the largest single part of the
//   kernel's time;
// - nothing is asked for when it is needed: the next slab's four 16-byte
//   loads a thread, the next stage's activations (through registers) and the
//   fold's scales are all asked for a slab or a stage ahead.  A block lives for
//   a few slabs only, so every load that waits for another is a share of its
//   whole time (a block of one slab would pay three memory latencies in a row);
// - split-K over blockIdx.z in whole slabs with f32 partial sums, and NO
//   second launch: a block writes its partial sums, takes a ticket from its
//   column tile's counter, and the block that takes the last one adds the
//   partial sums in split order (so the result does not depend on who came
//   last) and sets the counter back to 0 for the next call.
//
// M = 9-16 on the paired 4-bit plane (every decode step of 16 slots) takes
// its own instance, qgemv_word_kernel16, where a scale group holds each
// nibble's run of four slabs (groups of a multiple of 128 rows, K-tiles of a
// multiple of 512: the served layouts).  At 16 rows the design above ran at
// a fifth of the memory rate: one slab of loads in flight a block, blocks of
// 4-16 slabs, the fold after every slab (two B tiles leave no registers for
// four sets of lazy sums) and a third of the products spent on asum.  So:
// - one resident block an SM (512 threads, 8 column groups of 32 x 2 pairs
//   of nibbles) walks a long run of slabs (its own split plan,
//   kernels/qgemv_kernel.py, ~one block an SM);
// - a ring of 6 slab slots in shared memory filled by cp.async 4 slabs
//   ahead (~64 KB in flight an SM, where Little's law asks ~25 KB): the
//   words, the slab's activations, and at a window's last slab the scales
//   of its fold;
// - each warp keeps the lazy sums of its two nibbles only (the other pair
//   of warps of its column group takes the other two), so the fold runs
//   once a window of four slabs (a scale group a nibble) with no spill; the
//   two pairs' sums join in shared memory at the end;
// - asum comes from the staged activations on the CUDA cores, once a block
//   and slab (a thread a nibble, row and 4 K rows, summed in a fixed order),
//   not from products against ones;
// - a split may start or end inside a window: the fold also runs at a
//   split's last slab.  Split-K as above (both instances: the last block's
//   loads of the partial sums go out a batch at a time).
// What bounds it now (H100, M = 16, the served shapes): the products.  Its
// 256 mma.sync a slab an SM are what keeps it from the speed of its copies
// alone (built without them it runs at 68-71% of the memory rate at gate|up
// and lm_head, with them at 45-47%).  Tried and dropped: wgmma m64n16k16 (A
// from registers; ptxas serializes it, 10% slower) and TMA bulk copies of a
// slab's 1 KB row segments (20% slower than cp.async).
// The 8-bit plane and the other layouts keep the first instance at M > 8.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "planes.cuh"

namespace {

using xb::load_scale;

constexpr int kThreads = 256;
constexpr int kCols = 256;     // columns a block: 32 a warp
constexpr int kSlabRows = 16;  // word rows a slab
constexpr int kStage = 4;      // slabs staged at a time

struct Args {
  const __nv_bfloat16* a;
  int M, Ka, N;  // Ka: columns of a; packed rows from Ka on meet zeros
  const uint32_t* plane;
  const void* s;
  const void* sz;
  int s_f16, tile_k, gt, gt_pad;
  int n_slabs, per, splits;
  float* part;
  int* counters;
  void* out;
  int out_f32;
};

// Rows 8mt + 2t4 + e and columns col..col + 3 of acc (acc[mt][ti][2h + e]:
// column col + 2ti + h) into dst_f32 or dst_bf16 ([M, N] row-major); `vec`:
// N % 4 == 0 and col < N (16-byte accesses).
template <int MT>
__device__ __forceinline__ void store_rows(const float (&acc)[MT][2][4], int M, int N, int col,
                                           int t4, bool vec, float* dst_f32,
                                           __nv_bfloat16* dst_bf16) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * mt + 2 * t4 + e;
      if (m >= M || col >= N) continue;
      const float o[4] = {acc[mt][0][e], acc[mt][0][2 + e], acc[mt][1][e], acc[mt][1][2 + e]};
      const size_t at = static_cast<size_t>(m) * N + col;
      if (dst_f32) {
        if (vec) {
          *reinterpret_cast<float4*>(dst_f32 + at) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (col + c < N) dst_f32[at + c] = o[c];
        }
      } else if (vec) {
        __align__(8) __nv_bfloat162 h[2] = {__floats2bfloat162_rn(o[0], o[1]),
                                            __floats2bfloat162_rn(o[2], o[3])};
        *reinterpret_cast<uint2*>(dst_bf16 + at) = *reinterpret_cast<const uint2*>(h);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < N) dst_bf16[at + c] = __float2bfloat16(o[c]);
      }
    }
}

// The last block of a column tile: the partial sums of every split, in split
// order, into acc (the lane's rows and columns as store_rows has them).  The
// loads of 4 / MT splits go out together (each an L2 round trip); the sums
// run in split order all the same.
template <int MT>
__device__ __forceinline__ void sum_splits(float (&acc)[MT][2][4], const Args& p, int col, int t4,
                                           bool vec) {
  constexpr int kBatch = 4 / MT;
  const size_t MN = static_cast<size_t>(p.M) * p.N;
  float o[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[mt][e][c] = 0.f;
  for (int z0 = 0; z0 < p.splits; z0 += kBatch) {
    float v[kBatch][MT][2][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * mt + 2 * t4 + e;
          const bool live = z0 + u < p.splits && m < p.M && col < p.N;
          const float* src = p.part + (z0 + u) * MN + static_cast<size_t>(m) * p.N + col;
          if (live && vec) {
            const float4 x = __ldcg(reinterpret_cast<const float4*>(src));
            v[u][mt][e][0] = x.x, v[u][mt][e][1] = x.y, v[u][mt][e][2] = x.z, v[u][mt][e][3] = x.w;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              v[u][mt][e][c] = live && col + c < p.N ? __ldcg(src + c) : 0.f;
          }
        }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (z0 + u < p.splits)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c) o[mt][e][c] += v[u][mt][e][c];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      acc[mt][0][e] = o[mt][e][0], acc[mt][0][2 + e] = o[mt][e][1], acc[mt][1][e] = o[mt][e][2],
      acc[mt][1][2 + e] = o[mt][e][3];
}

// BITS: 4 (paired plane) or 8.  MT: B tiles of 8 activation rows (M <= 8 MT).
// LAZY: fold once a stage of four slabs (the host checked that it may).
template <int BITS, int MT, bool LAZY>
__global__ void __launch_bounds__(kThreads, 2)
qgemv_word_kernel(const Args p) {
  constexpr int RJ = BITS == 4 ? 32 : 16;  // K rows a (slab, j)
  constexpr int kRows = 8 * MT;
  constexpr int kStride = kStage * 4 * RJ + 8;  // bf16 a staged row: conflict-free fragments
  constexpr int JD = LAZY ? 4 : 1;              // sets of running sums
  __shared__ __align__(16) __nv_bfloat16 a_s[kRows][kStride];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int M = p.M, N = p.N, tile_k = p.tile_k;
  const int g_tile = tile_k / p.gt;
  const int spt = tile_k / (BITS == 4 ? 8 : 4) / kSlabRows;  // slabs a K-tile
  const int col = blockIdx.x * kCols + warp * 32 + 4 * g;    // the lane's 4 columns
  const bool vec = (N % 4) == 0 && col < N;                  // 16-byte accesses
  const int sl_begin = blockIdx.z * p.per;
  const int sl_end = min(p.n_slabs, sl_begin + p.per);

  // first K row of (slab, j)
  auto first_row = [&](int sl, int j) -> int {
    const int t = sl / spt, sr = sl - t * spt;
    return t * tile_k + j * (tile_k >> 2) + RJ * sr;
  };
  // the lane's four 16-byte loads of a slab.  4-bit: word rows 8s + t4 + 4h
  // at [2s + h]; 8-bit: word rows 2t4 + 8h + e at [2h + e].
  auto load_slab = [&](int sl, uint32_t (&wv)[4][4]) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = BITS == 4 ? 8 * (x >> 1) + t4 + 4 * (x & 1) : 2 * t4 + 8 * (x >> 1) + (x & 1);
      const uint32_t* src = p.plane + static_cast<size_t>(sl * kSlabRows + r) * N;
      if (vec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + col));
        wv[x][0] = v.x;
        wv[x][1] = v.y;
        wv[x][2] = v.z;
        wv[x][3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) wv[x][c] = col + c < N ? __ldg(src + col + c) : 0u;
      }
    }
  };

  // acc[mt][ti][2h + e]: row 8mt + 2t4 + e, column col + 2ti + h
  float acc[MT][2][4], dot[JD][MT][2][4], asum[JD][MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][ti][e] = 0.f;

  uint32_t wn[4][4];
  if (sl_begin < sl_end) load_slab(sl_begin, wn);

  // The activations of a stage of four slabs, 16 bytes an item: (row m, slab
  // qq, nibble j, eight K rows).  They are fetched into registers a slab
  // ahead of the stage and stored when it begins.
  constexpr int kPer = RJ / 8;
  constexpr int kItems = kRows * kStage * 4 * kPer / kThreads;
  static_assert(kItems * kThreads == kRows * kStage * 4 * kPer, "whole items a thread");
  uint4 pa[kItems];
  auto fetch_a = [&](int sl0) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = tid + it * kThreads;
      const int i8 = idx % kPer, j = (idx / kPer) & 3, qq = (idx / (kPer * 4)) % kStage;
      const int m = idx / (kPer * 4 * kStage);
      pa[it] = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && sl0 + qq < sl_end) {
        const int k = first_row(sl0 + qq, j) + i8 * 8;
        if (k < p.Ka)
          pa[it] = __ldg(reinterpret_cast<const uint4*>(p.a + static_cast<size_t>(m) * p.Ka + k));
      }
    }
  };
  auto store_a = [&]() {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = tid + it * kThreads;
      const int i8 = idx % kPer, j = (idx / kPer) & 3, qq = (idx / (kPer * 4)) % kStage;
      const int m = idx / (kPer * 4 * kStage);
      *reinterpret_cast<uint4*>(&a_s[m][(qq * 4 + j) * RJ + i8 * 8]) = pa[it];
    }
  };
  if (sl_begin < sl_end) fetch_a(sl_begin);

  // the scales of a fold, as they are stored, asked for before the products
  // they scale: columns col..col + 3 of (slab, j)'s group
  const bool s_vec = vec && p.s_f16;
  uint2 sx[JD], sy[JD];
  auto scale_at = [&](int sl, int j) -> size_t {
    const int k0 = first_row(sl, j);
    const int t = k0 / tile_k, gi = (k0 - t * tile_k) / g_tile;
    return (static_cast<size_t>(t) * p.gt_pad + gi) * N;
  };
  auto fetch_scales = [&](int sl, int j, int jd) {
    if (!s_vec) return;
    const size_t at = scale_at(sl, j) + col;
    sx[jd] = __ldg(reinterpret_cast<const uint2*>(static_cast<const __half*>(p.s) + at));
    sy[jd] = __ldg(reinterpret_cast<const uint2*>(static_cast<const __half*>(p.sz) + at));
  };

  for (int sl = sl_begin; sl < sl_end; ++sl) {
    const int q = (sl - sl_begin) & (kStage - 1);
    if (q == 0) {
      __syncthreads();  // the slabs staged before are consumed
      store_a();
      __syncthreads();
      if constexpr (LAZY) {
#pragma unroll
        for (int j = 0; j < 4; ++j) fetch_scales(sl, j, j);
      }
    }
    if (q == kStage - 1 && sl + 1 < sl_end) fetch_a(sl + 1);
    uint32_t wv[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[x][c] = wn[x][c];
    if (sl + 1 < sl_end) load_slab(sl + 1, wn);
    const bool fold_now = !LAZY || q == kStage - 1 || sl + 1 == sl_end;

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jd = LAZY ? j : 0;
      if (!LAZY) fetch_scales(sl, j, 0);
      if (!LAZY || q == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            asum[jd][mt][e] = 0.f;
            dot[jd][mt][0][e] = 0.f;
            dot[jd][mt][1][e] = 0.f;
          }
      }
#pragma unroll
      for (int s = 0; s < RJ / 16; ++s) {
        // the weights as A fragments: tile ti, rows c and c + 8 are columns
        // col + 2ti and col + 2ti + 1; k pairs t4 and t4 + 4
        uint32_t wa[2][4];
#pragma unroll
        for (int ti = 0; ti < 2; ++ti)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int c = 2 * ti + (x & 1), h = x >> 1;
            if (BITS == 4) {
              wa[ti][x] = xb::nibbles_to_bf162(wv[2 * s + h][c] >> (4 * j));
            } else {
              // byte j of two consecutive word rows: K rows 2i and 2i + 1
              const uint32_t sel = j | ((4 + j) << 8);
              wa[ti][x] = xb::bytes_to_bf162(
                  __byte_perm(wv[2 * h][c], wv[2 * h + 1][c], sel) & 0x00FF00FFu);
            }
          }
        const uint32_t ones[4] = {xb::kBf16x2_1, xb::kBf16x2_1, xb::kBf16x2_1, xb::kBf16x2_1};
        const int k = (q * 4 + j) * RJ + 16 * s + 2 * t4;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // the activations as B: column g of the tile is row 8mt + g
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&a_s[8 * mt + g][k]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&a_s[8 * mt + g][k + 8]);
          xb::mma_bf16(dot[jd][mt][0], wa[0], b0, b1);
          xb::mma_bf16(dot[jd][mt][1], wa[1], b0, b1);
          xb::mma_bf16(asum[jd][mt], ones, b0, b1);
        }
      }
      if (!fold_now) continue;
      // fold with the group's scales, columns col..col + 3
      float sv[4], zv[4];
      if (s_vec) {
        const float2 x0 = __half22float2(*reinterpret_cast<const __half2*>(&sx[jd].x));
        const float2 x1 = __half22float2(*reinterpret_cast<const __half2*>(&sx[jd].y));
        const float2 y0 = __half22float2(*reinterpret_cast<const __half2*>(&sy[jd].x));
        const float2 y1 = __half22float2(*reinterpret_cast<const __half2*>(&sy[jd].y));
        sv[0] = x0.x, sv[1] = x0.y, sv[2] = x1.x, sv[3] = x1.y;
        zv[0] = y0.x, zv[1] = y0.y, zv[2] = y1.x, zv[3] = y1.y;
      } else {
        const size_t si = scale_at(sl, j);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const size_t at = si + min(col + c, N - 1);
          sv[c] = load_scale(p.s, at, p.s_f16);
          zv[c] = load_scale(p.sz, at, p.s_f16);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ti = 0; ti < 2; ++ti)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * ti + (e >> 1);
            acc[mt][ti][e] = fmaf(-zv[c], asum[jd][mt][e & 1],
                                  fmaf(sv[c], dot[jd][mt][ti][e], acc[mt][ti][e]));
          }
    }
  }

  const size_t MN = static_cast<size_t>(M) * N;
  float* out_f32 = p.out_f32 ? static_cast<float*>(p.out) : nullptr;
  __nv_bfloat16* out_bf16 = p.out_f32 ? nullptr : static_cast<__nv_bfloat16*>(p.out);
  if (p.splits == 1) {
    store_rows<MT>(acc, M, N, col, t4, vec, out_f32, out_bf16);
    return;
  }
  store_rows<MT>(acc, M, N, col, t4, vec, p.part + blockIdx.z * MN, nullptr);
  __threadfence();  // the partial sums are visible before the ticket is taken
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counters[blockIdx.x], 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block of the column tile: all partial sums, in split order
  sum_splits<MT>(acc, p, col, t4, vec);
  store_rows<MT>(acc, M, N, col, t4, vec, out_f32, out_bf16);
  if (tid == 0) p.counters[blockIdx.x] = 0;  // ready for the next call
}

// ---- M = 9-16, the paired 4-bit plane: qgemv_word_kernel16 ----

constexpr int kThreads16 = 512;      // 16 warps: column group warp & 7, nibbles 2 (warp >> 3) + 0, 1
constexpr int kRing = 6;             // slab slots (4 and 8 read within 2%)
constexpr int kAhead = kRing - 2;    // slabs asked for ahead of the one consumed
constexpr int kWStride = kCols + 8;  // words a staged row: 32 bytes of pad, conflict-free 16-byte reads
constexpr int kAStride = 4 * 32 + 8; // bf16 a staged activation row: conflict-free ldmatrix

// One slab as it lands: its 16 word rows of the block's 256 columns; for
// each row m < 16 and nibble j the 32 K rows it meets; at a window's last
// slab the fold's scales and zeros of the 4 nibbles' groups (fp16 scales).
struct Slot16 {
  uint32_t w[kSlabRows][kWStride];
  __nv_bfloat16 a[16][kAStride];
  __half sc[2][4][kCols];
};

struct Smem16 {
  Slot16 slot[kRing];
  float asum[2][4][16];  // a window's (parity) sum of a over its rows, by nibble and row
  int last;
};
static_assert(sizeof(float) * 16 * (kCols + 4) <= sizeof(Slot16::w), "the exchange fits a slot");

// The lane's 16 words of a staged slab (word rows 8s + t4 + 4h at [2s + h],
// columns cl..cl + 3) through nibbles J0 and J0 + 1 into dot[jj][mt][ti].
template <int J0>
__device__ __forceinline__ void slab16(const Slot16& s, int cl, int lane,
                                       float (&dot)[2][2][2][4]) {
  const int t4 = lane & 3;
  uint32_t wv[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const uint4 v = *reinterpret_cast<const uint4*>(&s.w[8 * (x >> 1) + t4 + 4 * (x & 1)][cl]);
    wv[x][0] = v.x, wv[x][1] = v.y, wv[x][2] = v.z, wv[x][3] = v.w;
  }
  // ldmatrix rows: matrix lane >> 3 is (row tile lane >> 4, K half (lane >> 3) & 1)
  const __nv_bfloat16* arow = &s.a[8 * (lane >> 4) + (lane & 7)][8 * ((lane >> 3) & 1)];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      uint32_t b[4];  // B of row tiles 0 and 1: K rows 2t4.. and 2t4 + 8..
      xb::ldmatrix_x4(b, arow + 32 * (J0 + jj) + 16 * st);
      uint32_t wa[2][4];
#pragma unroll
      for (int ti = 0; ti < 2; ++ti)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          wa[ti][x] = xb::nibbles_to_bf162(wv[2 * st + (x >> 1)][2 * ti + (x & 1)] >> (4 * (J0 + jj)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        xb::mma_bf16(dot[jj][mt][0], wa[0], b[2 * mt], b[2 * mt + 1]);
        xb::mma_bf16(dot[jj][mt][1], wa[1], b[2 * mt], b[2 * mt + 1]);
      }
    }
}

__global__ void __launch_bounds__(kThreads16, 1) qgemv_word_kernel16(const Args p) {
  extern __shared__ __align__(16) unsigned char smem16[];
  Smem16& sm = *reinterpret_cast<Smem16*>(smem16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int jh = warp >> 3, t4 = lane & 3;
  const int M = p.M, N = p.N, tile_k = p.tile_k;
  const int g_tile = tile_k / p.gt, spt = tile_k / (4 * 32);  // slabs a K-tile
  const int col0 = blockIdx.x * kCols;
  const int cl = (warp & 7) * 32 + 4 * (lane >> 2);  // the lane's 4 columns in the tile
  const int col = col0 + cl;
  const bool vec = (N % 4) == 0;               // 16-byte words
  const bool s_stage = p.s_f16 && N % 8 == 0;  // 16-byte scale copies
  const int sl_begin = blockIdx.z * p.per;
  const int sl_end = min(p.n_slabs, sl_begin + p.per);

  auto first_row = [&](int sl, int j) -> int {
    const int t = sl / spt, sr = sl - t * spt;
    return t * tile_k + j * (tile_k >> 2) + 32 * sr;
  };
  auto scale_at = [&](int sl, int j) -> size_t {
    const int k0 = first_row(sl, j);
    const int t = k0 / tile_k, gi = (k0 - t * tile_k) / g_tile;
    return (static_cast<size_t>(t) * p.gt_pad + gi) * N;
  };
  // a window: four slabs, for each nibble 128 K rows in one scale group
  auto folds = [&](int sl) { return (sl & 3) == 3 || sl + 1 == sl_end; };
  auto slot = [&](int sl) -> Slot16& { return sm.slot[(sl - sl_begin) % kRing]; };

  // this thread's pieces of a slab: words (rows wr, wr + 8, columns wc..wc +
  // 3), activations (row am, nibble aj, K rows 8 a8..), and at a fold slab
  // scales (array sz_, nibble sj, columns sc8..sc8 + 7).  The copies walk
  // the slabs in order: `wsrc` and the K-tile `it`, slab `isr` in it, advance
  // by one slab a call.
  const int wr = tid >> 6, wc = 4 * (tid & 63);
  const int a8 = tid & 3, aj = (tid >> 2) & 3, am = tid >> 4;
  const int sc8 = 8 * (tid & 31), sj = (tid >> 5) & 3, sz_ = (tid >> 7) & 1;
  const bool w_ok = col0 + wc < N, s_ok = col0 + sc8 < N;
  const uint32_t* wsrc = p.plane + static_cast<size_t>(sl_begin * kSlabRows + wr) * N + col0 + wc;
  const __nv_bfloat16* asrc = p.a + static_cast<size_t>(am) * p.Ka + aj * (tile_k >> 2) + 8 * a8;
  const __half* ssrc = static_cast<const __half*>(sz_ ? p.sz : p.s) + col0 + sc8;
  int it = sl_begin / spt, isr = sl_begin - it * spt;
  int islot = 0;

  // One cp.async group a slab (empty past the split's end, to keep the count).
  auto fetch_slab = [&](int sl) {
    if (sl < sl_end) {
      Slot16& s = sm.slot[islot];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // 16 rows x 256 columns: 1,024 pieces of 4 words
        const int r = wr + 8 * i;
        const uint32_t* src = wsrc + static_cast<size_t>(8 * i) * N;
        if (vec) {
          xb::cp_async_16(&s.w[r][wc], w_ok ? src : p.plane, w_ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xb::cp_async_4(&s.w[r][wc + e], col0 + wc + e < N ? src + e : p.plane,
                           col0 + wc + e < N);
        }
      }
      if (tid < 256) {  // 16 rows x 4 nibbles x 32 K rows: 256 pieces of 8
        const int k = it * tile_k + 32 * isr;  // + aj * tile_k / 4 + 8 a8 in asrc
        const bool ok = am < M && k + aj * (tile_k >> 2) + 8 * a8 < p.Ka;
        xb::cp_async_16(&s.a[am][32 * aj + 8 * a8], ok ? asrc + k : p.a, ok);
      } else if (s_stage && folds(sl)) {  // scales, zeros x 4 nibbles x 256 columns: 256 of 8
        xb::cp_async_16(&s.sc[sz_][sj][sc8], s_ok ? ssrc + scale_at(sl, sj) : ssrc, s_ok);
      }
      wsrc += static_cast<size_t>(kSlabRows) * N;
      if (++isr == spt) isr = 0, ++it;
      if (++islot == kRing) islot = 0;
    }
    xb::cp_async_commit();
  };

  // acc[mt][ti][2h + e]: row 8mt + 2t4 + e, column col + 2ti + h, nibbles of this pair
  float acc[2][2][4], dot[2][2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][ti][e] = 0.f;
        dot[0][mt][ti][e] = dot[1][mt][ti][e] = 0.f;
      }

  // The fold of the window that ends at slab fs: acc += s * dot - sz * asum,
  // once a scale group and nibble.
  auto fold = [&](int fs) {
    const Slot16& s = slot(fs);
    const float(&as)[4][16] = sm.asum[(fs >> 2) & 1];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * jh + jj;
      float sv[4], zv[4];
      if (s_stage) {
        const uint2 x = *reinterpret_cast<const uint2*>(&s.sc[0][j][cl]);
        const uint2 y = *reinterpret_cast<const uint2*>(&s.sc[1][j][cl]);
        const float2 x0 = __half22float2(*reinterpret_cast<const __half2*>(&x.x));
        const float2 x1 = __half22float2(*reinterpret_cast<const __half2*>(&x.y));
        const float2 y0 = __half22float2(*reinterpret_cast<const __half2*>(&y.x));
        const float2 y1 = __half22float2(*reinterpret_cast<const __half2*>(&y.y));
        sv[0] = x0.x, sv[1] = x0.y, sv[2] = x1.x, sv[3] = x1.y;
        zv[0] = y0.x, zv[1] = y0.y, zv[2] = y1.x, zv[3] = y1.y;
      } else {
        const size_t si = scale_at(fs, j);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const size_t at = si + min(col + c, N - 1);
          sv[c] = load_scale(p.s, at, p.s_f16);
          zv[c] = load_scale(p.sz, at, p.s_f16);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float2 a2 = *reinterpret_cast<const float2*>(&as[j][8 * mt + 2 * t4]);
#pragma unroll
        for (int ti = 0; ti < 2; ++ti)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * ti + (e >> 1);
            acc[mt][ti][e] = fmaf(-zv[c], (e & 1) ? a2.y : a2.x,
                                  fmaf(sv[c], dot[jj][mt][ti][e], acc[mt][ti][e]));
            dot[jj][mt][ti][e] = 0.f;
          }
      }
    }
  };

  for (int i = 0; i < kAhead; ++i) fetch_slab(sl_begin + i);
  // asum: this thread sums nibble uj, row um, K rows 4up..4up + 3 of each slab
  const int uj = tid >> 7, um = (tid >> 3) & 15, up = tid & 7;
  float arun = 0.f;
  for (int sl = sl_begin; sl < sl_end; ++sl) {
    xb::cp_async_wait<kAhead - 1>();
    __syncthreads();  // slab sl landed; slab sl - 2's slot is consumed
    if (sl > sl_begin && folds(sl - 1)) fold(sl - 1);
    fetch_slab(sl + kAhead);
    const Slot16& s = slot(sl);
    const uint2 av = *reinterpret_cast<const uint2*>(&s.a[um][32 * uj + 4 * up]);
    arun += (__uint_as_float(av.x << 16) + __uint_as_float(av.x & 0xffff0000u)) +
            (__uint_as_float(av.y << 16) + __uint_as_float(av.y & 0xffff0000u));
    if (jh)
      slab16<2>(s, cl, lane, dot);
    else
      slab16<0>(s, cl, lane, dot);
    if (folds(sl)) {  // the window's asum, for the fold after the next barrier
      arun += __shfl_xor_sync(0xffffffffu, arun, 1);
      arun += __shfl_xor_sync(0xffffffffu, arun, 2);
      arun += __shfl_xor_sync(0xffffffffu, arun, 4);
      if (up == 0) sm.asum[(sl >> 2) & 1][uj][um] = arun;
      arun = 0.f;
    }
  }
  xb::cp_async_wait<0>();
  __syncthreads();
  if (sl_begin < sl_end) fold(sl_end - 1);

  // nibbles 2 and 3 join 0 and 1: warps 8-15 hand their sums to warps 0-7
  // through the first slot's words (every slab is consumed; the fold reads
  // only scales and asum)
  float(*xs)[kCols + 4] = reinterpret_cast<float(*)[kCols + 4]>(&sm.slot[0].w[0][0]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = xs[8 * mt + 2 * t4 + (e & 1)][cl + 2 * ti + (e >> 1)];
        if (jh) x = acc[mt][ti][e];
      }
  __syncthreads();
  if (!jh) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ti = 0; ti < 2; ++ti)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][ti][e] += xs[8 * mt + 2 * t4 + (e & 1)][cl + 2 * ti + (e >> 1)];
  }

  const bool vout = vec && col < N;
  const size_t MN = static_cast<size_t>(M) * N;
  float* out_f32 = p.out_f32 ? static_cast<float*>(p.out) : nullptr;
  __nv_bfloat16* out_bf16 = p.out_f32 ? nullptr : static_cast<__nv_bfloat16*>(p.out);
  if (p.splits == 1) {
    if (!jh) store_rows<2>(acc, M, N, col, t4, vout, out_f32, out_bf16);
    return;
  }
  if (!jh) store_rows<2>(acc, M, N, col, t4, vout, p.part + blockIdx.z * MN, nullptr);
  __threadfence();  // the partial sums are visible before the ticket is taken
  __syncthreads();
  if (tid == 0) sm.last = atomicAdd(&p.counters[blockIdx.x], 1) == p.splits - 1;
  __syncthreads();
  if (!sm.last || jh) return;
  __threadfence();
  sum_splits<2>(acc, p, col, t4, vout);
  store_rows<2>(acc, M, N, col, t4, vout, out_f32, out_bf16);
  if (tid == 0) p.counters[blockIdx.x] = 0;  // ready for the next call
}

int launch16(const Args& args, cudaStream_t st) {
  constexpr int bytes = static_cast<int>(sizeof(Smem16));
  // above 48 KB shared memory is dynamic and has to be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      qgemv_word_kernel16, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((args.N + kCols - 1) / kCols, 1, args.splits);
  qgemv_word_kernel16<<<grid, kThreads16, bytes, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, int MT, bool LAZY>
int launch(const Args& args, cudaStream_t st) {
  const dim3 grid((args.N + kCols - 1) / kCols, 1, args.splits);
  qgemv_word_kernel<BITS, MT, LAZY><<<grid, kThreads, 0, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int dispatch(const Args& args, bool lazy, bool windows, cudaStream_t st) {
  if (args.M > 8) return BITS == 4 && windows ? launch16(args, st) : launch<BITS, 2, false>(args, st);
  return lazy ? launch<BITS, 1, true>(args, st) : launch<BITS, 1, false>(args, st);
}

}  // namespace

// a: bf16 [M, Ka] contiguous and 16-byte aligned, M <= 16, Ka <= K a multiple
// of 8 (the packed rows from Ka on meet zeros: K padding); `plane` the one
// packed plane: paired 4-bit words [K/8, N] (bits == 4) or 8-bit words
// [K/4, N] (bits == 8).  Grid: x = N / 256, z = `splits` ranges of `per`
// slabs of 16 word rows.  With splits > 1, `part` is an f32 workspace of
// splits * M * N values and `counters` holds one int per column tile, all 0
// at the call and all 0 again when the kernel has run (calls that share the
// counters must be ordered, as launches on one stream are).  At M > 8, the
// paired 4-bit plane with groups of a multiple of 128 rows and K-tiles of a
// multiple of 512 takes qgemv_word_kernel16 (its grid the same, ~one block an
// SM by the caller's splits; 152 KB of dynamic shared memory).  Returns
// cudaErrorInvalidValue (1) for a layout it does not take: a K-tile that is
// not whole slabs, or a scale group that cuts a slab's run of 32 (8-bit: 16)
// K rows.
extern "C" int xb_qgemv_word(const void* a, int M, int K, int Ka, int N, const void* plane,
                             int bits,
                             const void* s, const void* sz, int s_f16, int tile_k, int gt,
                             int gt_pad, int splits, int per, void* part, void* counters,
                             void* out, int out_f32, void* stream) {
  if (M < 1 || M > 16 || (bits != 4 && bits != 8) || gt < 1 || tile_k % gt || K % tile_k ||
      splits < 1 || per < 1 || (splits > 1 && (!part || !counters)) || Ka > K || Ka % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g_tile = tile_k / gt;
  const int rj = bits == 4 ? 32 : 16;
  if (tile_k % (4 * rj) || g_tile % rj) return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.a = static_cast<const __nv_bfloat16*>(a);
  args.M = M;
  args.Ka = Ka;
  args.N = N;
  args.plane = static_cast<const uint32_t*>(plane);
  args.s = s;
  args.sz = sz;
  args.s_f16 = s_f16;
  args.tile_k = tile_k;
  args.gt = gt;
  args.gt_pad = gt_pad;
  args.n_slabs = K / (4 * rj);
  args.per = per;
  args.splits = splits;
  if (static_cast<long long>(splits) * per < args.n_slabs)
    return static_cast<int>(cudaErrorInvalidValue);
  args.part = static_cast<float*>(part);
  args.counters = static_cast<int*>(counters);
  args.out = out;
  args.out_f32 = out_f32;
  // Four slabs staged together share, for each j, one scale group when a
  // group holds their 4 * rj rows, the splits start on a stage and a K-tile
  // is whole stages.
  const bool lazy = g_tile % (kStage * rj) == 0 && (splits == 1 || per % kStage == 0) &&
                    tile_k % (kStage * 4 * rj) == 0;
  // qgemv_word_kernel16's windows: a nibble's run of four slabs in one scale
  // group (its splits may start anywhere)
  const bool windows = g_tile % (kStage * rj) == 0 && tile_k % (kStage * 4 * rj) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bits == 4 ? dispatch<4>(args, lazy, windows, st) : dispatch<8>(args, lazy, windows, st);
}
