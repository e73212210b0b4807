// W4A8-style matmul on packed weights: out[M, N] (f32) from int8 activations
// aq[M, K] and the integer weight values of a packed QTensor, with the scales
// applied to INTEGER dot products:
//   grouped:     out = sum_g  s_g * (aq_g . wq_g) - (sum aq_g) * sz_g
//   per channel: out = s * (aq . wq) - (sum aq) * sz      (one group over all K)
// The caller quantized the activations per row and applies their scale to
// this output.
//
// Replaces the Pallas kernels xbitops_tpu/kernels/qgemv_kernel.py:_kernel_a8
// (grouped scales) and :_kernel_a8_perchannel (entry qmatmul_kernel(a8=True),
// qgemv_kernel.py:335).
//
// What bounds it on an H100: operations by the card's rates (the packed
// weight is read once for a whole 128-row tile of M), but the kernel runs far
// under them.  Builds that left one part out, timed against the whole kernel
// (4096x22016, M=2560; PERF.md, PR 7): without the fold the grouped form
// takes half the time (1.01 against 2.04-2.16 ms), without the global loads
// two thirds (1.38; per channel 0.89 against 1.60), without the weight decode
// 96-98%.  So the grouped form is held by each group's fold (a conversion
// and two FMAs an output, every 128 K rows, on one 8-warp block an SM that
// holds 64 int32 sums and 64 f32 accumulators a thread), and both forms by
// the loads that feed an mma.sync tile, not by the decode.
//
// Design:
// - a block owns a 128 x 128 output tile; eight warps as 2 (M) x 4 (N), a
//   warp 64 x 32; products are mma.sync.m16n8k32 on int8 (s8 x s8, or s8 x
//   u8 for the 8-bit per-channel plane) with int32 sums, so every dot is an
//   exact integer; activations reach the A registers by ldmatrix.  M tiles
//   vary fastest in the grid;
// - K is walked in steps of 128 K rows.  The activations and the RAW packed
//   words (never decoded copies) come through a cp.async ring of four
//   stages, one __syncthreads a step, the next loads queued after the first
//   k-step; each warp decodes its B registers from the raw words in shared
//   memory inside the product loop;
// - route PAIRED (the paired 4-bit plane, the main path): a word row r of a
//   K-tile holds K rows j*(tile_k/4) + 2r + h at bit 4j + 16h.  A block of
//   64*C word rows stays in shared memory for the four nibbles j (C steps of
//   128 consecutive K rows each), so every bit of every word loaded is used;
//   the B register of K rows 2r..2r+3 of nibble j is one byte permute of the
//   words r and r + 1 that gathers the two bytes holding nibble j, a shift by
//   4 for odd j and one mask.  A step lies inside one scale group and a
//   group's steps come one after the other, so each group folds once;
// - route BYTES (the 8-bit plane of requantize_a8, per channel): a word row r
//   holds K rows r + j*(tile_k/4) in byte j.  A step is 32 word rows; its
//   activation stage holds the four runs of 32 K rows in natural order, and a
//   4 x 4 byte transpose of four word rows (eight byte permutes) gives the B
//   registers of all four runs.  The transpose, not a permute of the
//   activations, because a warp's tile is 64 x 32: a B register serves four
//   row tiles, an A register four column tiles, and a warp holds half as many
//   B registers as A registers a k-step.  Bytes enter as u8 (0..255), so the
//   per-channel sum needs no 128 * asum correction;
// - route ROWS (every other layout: slot planes, widths of several planes,
//   K-tiles that are not a multiple of 512 (PAIRED) or 128 (BYTES), scale
//   groups such as 40 rows): a step is up to 128 contiguous K rows inside one
//   group, decoded row by row into int8 quads by the threads that queue the
//   loads, three steps ahead, into the ring's weight stage; width 8 is
//   stored minus 128 (s8) and, per channel, 128 * asum added back as an
//   integer;
// - asum (the activations' row sums) comes exact from dp4a on the staged
//   activation tile, two threads a row a step (one more mma against ones
//   measured 2% slower), into shared memory at the end of a group;
// - grouped: the int32 sums of a group fold in f32 once, at the top of the
//   step after the group's last: acc = fma(d, s, acc); acc = fma(-asum,
//   sz - 128 s [width 8], acc).  The scale rows have a ring of their own, one
//   entry longer than the stages.  Per channel: one int32 sum over K (|sum|
//   <= 127 * 255 * K < 2^31 for K < 66k) and one rescale at the store, with
//   no fused multiply-add, so the output has the bits of the plain version;
// - split-K over blockIdx.z in whole groups (PAIRED: whole word blocks) where
//   the grid is short: grouped f32 partials added in split order by the
//   second pass of splitk.cuh; per channel int32 partials of the sums and of
//   asum, added exactly before the one rescale by a8_perchannel_finish.
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
constexpr int TM = 128, TN = 128;  // block tile
constexpr int KA = 128;            // K rows a step
constexpr int kAStride = KA + 16;  // bytes a row of an activation stage: conflict-free ldmatrix
constexpr int kDStride = TN + 8;   // words a row of a decoded (ROWS) tile: conflict-free
constexpr int kStages = 4;
// Scale rows ring: one entry more than the stages, so the loads queued
// during step i (of step i + 3) do not overwrite the scales step i folds.
constexpr int kScRing = kStages + 1;
constexpr uint32_t kOnes = 0x01010101u;

enum Route { PAIRED = 0, BYTES = 1, ROWS = 2 };

// Shared memory of one block.  The raw word tiles are [row][TN] with the
// 16-byte chunks of a row XOR-swizzled by 2 * (bits 1-2 of row / (PAIRED ? 2
// : 4)), which leaves the B-register reads of both raw routes conflict-free.
template <int ROUTE, int C>
struct Smem {
  static constexpr int kWBufs = ROUTE == PAIRED ? 2 : kStages;
  static constexpr int kWRows = ROUTE == PAIRED ? 64 * C : (ROUTE == BYTES ? 32 : KA / 4);
  static constexpr int kWStride = ROUTE == ROWS ? kDStride : TN;
  int8_t a[kStages][TM][kAStride];
  uint32_t w[kWBufs][kWRows][kWStride];
  unsigned char sc[kScRing][2][TN * 4];  // scales of the group a step ends: s, sz (fp16 or f32)
  int asum[2][TM];                       // row sums of the last two groups
};

struct Args {
  const int8_t* a;
  int M, K, N;
  Planes pl;
  const void* s;
  const void* sz;
  int s_f16, tile_k, gt, gt_pad;
  int n_steps, per;  // steps in all, and a split
  int n_vec;         // words load 16 bytes at a time (N % 4 == 0)
  int a_vec;         // ROWS: activation rows load 16 bytes at a time
  int sc_vec;        // scale rows load 16 bytes at a time
  void* part;        // split-K partials: f32 [splits, M, N] grouped; per channel
                     // int32 [splits, M, N] then int32 [splits, M] of asum
  float* out;
};

template <bool U8>
__device__ __forceinline__ void mma_i8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (U8)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float scale_at(const unsigned char* row, int c, int f16) {
  return f16 ? __half2float(reinterpret_cast<const __half*>(row)[c])
             : reinterpret_cast<const float*>(row)[c];
}

template <bool PERCHANNEL, int ROUTE, int C>
__global__ void __launch_bounds__(kThreads, 1) qgemv_a8_kernel(const Args p) {
  using SM = Smem<ROUTE, C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  // M tiles vary fastest: the blocks in flight share a few column tiles of
  // the weight (read from memory about once) and the activations stay in L2
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int M = p.M, N = p.N, K = p.K, tile_k = p.tile_k;
  const int g_tile = tile_k / p.gt;  // K rows a scale row
  const int P = tile_k >> 2;         // K rows between the fields of a word
  const bool bits8 = p.pl.n == 1 && p.pl.pb[0] == 8;
  // steps a K-tile (PAIRED, BYTES) or a scale group (ROWS)
  const int spt = ROUTE == PAIRED ? tile_k / KA : (ROUTE == BYTES ? P / 32 : (g_tile + KA - 1) / KA);
  const int i_begin = blockIdx.z * p.per;
  const int i_end = min(p.n_steps, i_begin + p.per);

  // Step i: its first K row, its valid rows (ROWS) and whether its group ends
  // with it.  PAIRED: x = 4C b + C j + part (word block b, nibble j); BYTES:
  // the first row of the run of byte 0; ROWS: t is the group, x the part.
  auto step_k0 = [&](int i, int& kc, bool& ends) -> int {
    const int t = i / spt, x = i - t * spt;
    kc = KA;
    if constexpr (ROUTE == PAIRED) {
      const int b = x / (4 * C), r = x - b * 4 * C, j = r / C, part = r - j * C;
      const int kl = j * P + b * (KA * C) + part * KA;
      ends = (kl + KA) % g_tile == 0;
      return t * tile_k + kl;
    } else if constexpr (ROUTE == BYTES) {
      ends = x == spt - 1;
      return t * tile_k + x * 32;
    } else {
      kc = min(KA, g_tile - x * KA);
      ends = x == spt - 1;
      return t * g_tile + x * KA;
    }
  };

  // Raw words: R rows from `rows` (a row is N words), columns n0.., into a
  // swizzled tile.
  auto load_words = [&](uint32_t (*dst)[TN], const uint32_t* rows, int R, int sh) {
    for (int idx = tid; idx < R * (TN / 4); idx += kThreads) {
      const int r = idx >> 5, c = idx & 31;
      const int pc = (c ^ (((r >> sh) & 3) << 1)) << 2;
      const int n = n0 + c * 4;
      const uint32_t* src = rows + static_cast<size_t>(r) * N;
      if (p.n_vec) {
        const bool valid = n < N;
        xb::cp_async_16(&dst[r][pc], src + (valid ? n : 0), valid);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = n + e < N;
          xb::cp_async_4(&dst[r][pc + e], src + (valid ? n + e : 0), valid);
        }
      }
    }
  };

  // Queue the loads of step i into stage `slot` (no commit).  ROWS decodes
  // its weights here, synchronously, into the stage.
  auto load = [&](int i, int slot) {
    int kc;
    bool ends;
    const int k0 = step_k0(i, kc, ends);
    const int rel = i - i_begin;
    // activations: 128 rows x 8 chunks of 16 bytes
    if (ROUTE != ROWS || p.a_vec) {
      for (int idx = tid; idx < TM * 8; idx += kThreads) {
        const int m = idx >> 3, c = idx & 7;
        // BYTES: chunk c is half c & 1 of the run of byte j = c >> 1
        const int col = ROUTE == BYTES ? k0 + (c >> 1) * P + (c & 1) * 16 : k0 + c * 16;
        const bool valid = m0 + m < M && (ROUTE != ROWS || c * 16 < kc);
        xb::cp_async_16(&sm.a[slot][m][c * 16],
                        p.a + (valid ? static_cast<size_t>(m0 + m) * K + col : 0), valid);
      }
    } else {
      // a ragged run: byte loads, zero past it and past M
      for (int idx = tid; idx < TM * (KA / 4); idx += kThreads) {
        const int m = idx >> 5, q = idx & 31;
        uint32_t v = 0u;
        if (m0 + m < M) {
          const int8_t* src = p.a + static_cast<size_t>(m0 + m) * K + k0 + q * 4;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (q * 4 + b < kc) v |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * b);
        }
        *reinterpret_cast<uint32_t*>(&sm.a[slot][m][q * 4]) = v;
      }
    }
    // the scales of the group this step ends
    if (!PERCHANNEL && ends) {
      const int t = k0 / tile_k, gi = (k0 - t * tile_k) / g_tile;
      const size_t row = (static_cast<size_t>(t) * p.gt_pad + gi) * N;
      const int esz = p.s_f16 ? 2 : 4;
      if (p.sc_vec) {
        const int nch = TN * esz / 16;  // 16-byte chunks a row
        for (int idx = tid; idx < 2 * nch; idx += kThreads) {
          const int which = idx / nch, c = idx - which * nch;
          const int n = n0 + c * (16 / esz);
          const bool valid = n < N;
          const unsigned char* src = static_cast<const unsigned char*>(which ? p.sz : p.s);
          xb::cp_async_16(&sm.sc[rel % kScRing][which][c * 16], src + (row + (valid ? n : 0)) * esz,
                          valid);
        }
      } else if (tid < TN) {
        const int n = min(n0 + tid, N - 1);
        if (p.s_f16) {
          reinterpret_cast<__half*>(sm.sc[rel % kScRing][0])[tid] = static_cast<const __half*>(p.s)[row + n];
          reinterpret_cast<__half*>(sm.sc[rel % kScRing][1])[tid] = static_cast<const __half*>(p.sz)[row + n];
        } else {
          reinterpret_cast<float*>(sm.sc[rel % kScRing][0])[tid] = static_cast<const float*>(p.s)[row + n];
          reinterpret_cast<float*>(sm.sc[rel % kScRing][1])[tid] = static_cast<const float*>(p.sz)[row + n];
        }
      }
    }
    // weights
    if constexpr (ROUTE == PAIRED) {
      if (rel % (4 * C) == 0) {  // the first step of its word block
        const int t = i / spt, b = (i - t * spt) / (4 * C);
        load_words(sm.w[(rel / (4 * C)) & 1],
                   p.pl.ptr[0] + static_cast<size_t>(t * (tile_k >> 3) + b * 64 * C) * N,
                   64 * C, 1);
      }
    } else if constexpr (ROUTE == BYTES) {
      const int t = i / spt, x = i - t * spt;
      load_words(sm.w[slot], p.pl.ptr[0] + static_cast<size_t>(t * P + x * 32) * N, 32, 2);
    } else {
      // item: 4 consecutive K rows x 4 adjacent columns -> one int8 quad a column
      const int fast = p.pl.n != 1 ? 0 : (p.pl.paired ? 1 : (bits8 ? 2 : 0));
      for (int item = tid; item < (KA / 4) * (TN / 4); item += kThreads) {
        const int k4 = item >> 5, n4 = item & 31;
        const int n = n0 + n4 * 4;
        const int r0 = k4 * 4;
        uint32_t word[4] = {0u, 0u, 0u, 0u};
        if (r0 < kc && n < N) {
          int row0, sh0;
          xb::plane_slot(p.pl, 0, tile_k, k0 + r0, row0, sh0);
          bool done = false;
          if (p.n_vec && r0 + 3 < kc && fast == 1) {
            // paired 4-bit plane: rows 2r and 2r + 1 of a pair slot sit 16
            // bits apart, so two word rows give the four K rows
            int row2, sh2;
            xb::plane_slot(p.pl, 0, tile_k, k0 + r0 + 2, row2, sh2);
            if (sh0 < 16 && row2 == row0 + 1 && sh2 == sh0) {
              uint32_t w0[4], w1[4];
              xb::load_words<4>(p.pl.ptr[0], row0, N, n, w0);
              xb::load_words<4>(p.pl.ptr[0], row0 + 1, N, n, w1);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                word[c] = __byte_perm((w0[c] >> sh0) & 0x000F000Fu, (w1[c] >> sh0) & 0x000F000Fu,
                                      0x6420);
              done = true;
            }
          } else if (p.n_vec && r0 + 3 < kc && fast == 2) {
            // 8-bit plane: byte j of four consecutive word rows, minus 128
            int row3, sh3;
            xb::plane_slot(p.pl, 0, tile_k, k0 + r0 + 3, row3, sh3);
            if (row3 == row0 + 3 && sh3 == sh0) {
              const uint32_t j = static_cast<uint32_t>(sh0) >> 3;
              const uint32_t sel = j | ((4u + j) << 4);
              uint32_t w[4][4];
#pragma unroll
              for (int b = 0; b < 4; ++b) xb::load_words<4>(p.pl.ptr[0], row0 + b, N, n, w[b]);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                word[c] = __byte_perm(__byte_perm(w[0][c], w[1][c], sel),
                                      __byte_perm(w[2][c], w[3][c], sel), 0x5410) ^ 0x80808080u;
              done = true;
            }
          }
          if (!done) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int r = r0 + b;
              if (r >= kc) break;
              uint32_t v[4] = {0u, 0u, 0u, 0u};
              int off = 0;
              for (int pi = 0; pi < p.pl.n; ++pi) {
                int row, shift;
                xb::plane_slot(p.pl, pi, tile_k, k0 + r, row, shift);
                const uint32_t mask = (1u << p.pl.pb[pi]) - 1u;
                uint32_t w[4];
                if (p.n_vec) {
                  xb::load_words<4>(p.pl.ptr[pi], row, N, n, w);
                } else {
#pragma unroll
                  for (int c = 0; c < 4; ++c)
                    w[c] = n + c < N ? __ldg(p.pl.ptr[pi] + static_cast<size_t>(row) * N + n + c)
                                     : 0u;
                }
#pragma unroll
                for (int c = 0; c < 4; ++c) v[c] |= ((w[c] >> shift) & mask) << off;
                off += p.pl.pb[pi];
              }
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int val = static_cast<int>(v[c]) - (bits8 ? 128 : 0);
                word[c] |= (static_cast<uint32_t>(val) & 0xffu) << (8 * b);
              }
            }
          }
        }
        *reinterpret_cast<uint4*>(&sm.w[slot][k4][n4 * 4]) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
  };

  // the B column of lane g in column tile ni, in the swizzled raw tiles
  int pcol[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
    pcol[ni] = (((((wn + ni * 8) >> 2) + (g >> 2)) ^ (2 * t4)) << 2) | (g & 3);

  int d[4][4][4];      // exact integer sums: of the current group, or of all K
  float acc[4][4][4];  // grouped: the folded groups
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[mi][ni][e] = 0;
        acc[mi][ni][e] = 0.f;
      }

  // Fold the group whose scales are in ring entry `fsc` and row sums in
  // sm.asum[gb]: acc = fma(d, s, acc); acc = fma(-asum, sz [- 128 s], acc).
  auto fold = [&](int fsc, int gb) {
    float as[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      as[mi][0] = static_cast<float>(sm.asum[gb][wm + mi * 16 + g]);
      as[mi][1] = static_cast<float>(sm.asum[gb][wm + mi * 16 + g + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn + ni * 8 + 2 * t4;
      float sv[2], zv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sv[h] = scale_at(sm.sc[fsc][0], c + h, p.s_f16);
        zv[h] = scale_at(sm.sc[fsc][1], c + h, p.s_f16) - (bits8 ? 128.f * sv[h] : 0.f);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& o = acc[mi][ni][e];
          o = fmaf(static_cast<float>(d[mi][ni][e]), sv[e & 1], o);
          o = fmaf(-as[mi][e >> 1], zv[e & 1], o);
          d[mi][ni][e] = 0;
        }
    }
  };

  // The products of step i from stage `slot`.  `issue` queues the loads
  // three steps ahead; it runs after the first k-step, between products.
  auto compute = [&](int i, int slot, auto&& issue) {
    int kc;
    bool ends;
    step_k0(i, kc, ends);
    const int8_t(*at)[kAStride] = sm.a[slot];
    auto load_a = [&](uint32_t (&af)[4][4], int ks) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        xb::ldmatrix_x4(af[mi], &at[wm + mi * 16 + (lane & 15)][ks * 32 + (lane >> 4) * 16]);
    };
    if constexpr (ROUTE == PAIRED) {
      const int rel = i - i_begin, x = (i % spt) % (4 * C);
      const int j = x / C, part = x - j * C;
      const uint32_t sel = 0x6420u + static_cast<uint32_t>(j >> 1) * 0x1111u;
      const int sh = (j & 1) * 4;
      const uint32_t(*wt)[TN] = sm.w[(rel / (4 * C)) & 1] + part * 64;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t af[4][4];
        load_a(af, ks);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          // b0: K rows 32 ks + 4 t4 + 0..3, the halves of word rows
          // 16 ks + 2 t4 and + 1; b1: 16 rows on
          const uint32_t* w = &wt[16 * ks + 2 * t4][pcol[ni]];
          const uint32_t b0 = (__byte_perm(w[0], w[TN], sel) >> sh) & 0x0F0F0F0Fu;
          const uint32_t b1 = (__byte_perm(w[8 * TN], w[9 * TN], sel) >> sh) & 0x0F0F0F0Fu;
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_i8<false>(d[mi][ni], af[mi], b0, b1);
        }
        if (ks == 0) issue();
      }
    } else if constexpr (ROUTE == BYTES) {
      // run j of the stage is k-step j; the per-channel form takes all four
      // runs' B registers at once, the grouped one (which also holds acc)
      // two at a time
      constexpr int JN = PERCHANNEL ? 4 : 2;
      const uint32_t(*wt)[TN] = sm.w[slot];
#pragma unroll
      for (int j0 = 0; j0 < 4; j0 += JN) {
        uint32_t bq[4][2][JN];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // word rows 16 h + 4 t4 + 0..3: byte j of each is K row
            // 16 h + 4 t4 + 0..3 of run j
            const uint32_t* w = &wt[16 * h + 4 * t4][pcol[ni]];
            const uint32_t x0 = w[0], x1 = w[TN], x2 = w[2 * TN], x3 = w[3 * TN];
            const uint32_t f = PERCHANNEL ? 0u : 0x80808080u;  // grouped: s8, minus 128
#pragma unroll
            for (int q = 0; q < JN; q += 2) {
              const int jj = j0 + q;  // 0 or 2: low or high byte pairs
              const uint32_t s01 = jj == 0 ? 0x5140u : 0x7362u;
              const uint32_t l01 = __byte_perm(x0, x1, s01), l23 = __byte_perm(x2, x3, s01);
              bq[ni][h][q] = __byte_perm(l01, l23, 0x5410) ^ f;
              bq[ni][h][q + 1] = __byte_perm(l01, l23, 0x7632) ^ f;
            }
          }
#pragma unroll
        for (int q = 0; q < JN; ++q) {
          uint32_t af[4][4];
          load_a(af, j0 + q);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
              mma_i8<PERCHANNEL>(d[mi][ni], af[mi], bq[ni][0][q], bq[ni][1][q]);
          if (j0 == 0 && q == 0) issue();
        }
      }
    } else {
      const uint32_t(*wd)[kDStride] = sm.w[slot];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks * 32 >= kc) break;
        uint32_t af[4][4];
        load_a(af, ks);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn + ni * 8 + g;
          const uint32_t b0 = wd[ks * 8 + t4][col], b1 = wd[ks * 8 + 4 + t4][col];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_i8<false>(d[mi][ni], af[mi], b0, b1);
        }
        if (ks == 0) issue();
      }
    }
  };

  // the activations' row sums: two threads a row, 64 bytes each a step
  const int am = tid >> 1, ahalf = tid & 1;
  int asum_run = 0;
  auto row_sum = [&](int slot) {
    const uint4* row = reinterpret_cast<const uint4*>(&sm.a[slot][am][ahalf * 64]);
    int s = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = row[q];
      s = __dp4a(static_cast<int>(v.x), static_cast<int>(kOnes), s);
      s = __dp4a(static_cast<int>(v.y), static_cast<int>(kOnes), s);
      s = __dp4a(static_cast<int>(v.z), static_cast<int>(kOnes), s);
      s = __dp4a(static_cast<int>(v.w), static_cast<int>(kOnes), s);
    }
    asum_run += s;
  };

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (i_begin + s < i_end) load(i_begin + s, s);
    xb::cp_async_commit();
  }
  // the group waiting for its fold: the scale ring entry and row-sum buffer
  int pend_sc = -1, pend_gb = 0, gb = 0;
#pragma unroll 1
  for (int i = i_begin; i < i_end; ++i) {
    const int rel = i - i_begin, slot = rel % kStages;
    xb::cp_async_wait<kStages - 2>();  // this thread's copies of step i have landed
    __syncthreads();                   // everyone's have, and step i - 1 is consumed
    if (!PERCHANNEL && pend_sc >= 0) {
      fold(pend_sc, pend_gb);
      pend_sc = -1;
    }
    compute(i, slot, [&] {
      if (i + kStages - 1 < i_end) load(i + kStages - 1, (rel + kStages - 1) % kStages);
      xb::cp_async_commit();
    });
    row_sum(slot);
    int kc;
    bool ends;
    step_k0(i, kc, ends);
    if (!PERCHANNEL && ends) {
      const int tot = asum_run + __shfl_xor_sync(0xffffffffu, asum_run, 1);
      if (ahalf == 0) sm.asum[gb][am] = tot;
      asum_run = 0;
      pend_sc = rel % kScRing;
      pend_gb = gb;
      gb ^= 1;
    }
  }
  xb::cp_async_wait<0>();
  if (PERCHANNEL) {
    const int tot = asum_run + __shfl_xor_sync(0xffffffffu, asum_run, 1);
    if (ahalf == 0) sm.asum[0][am] = tot;
  }
  __syncthreads();
  if (!PERCHANNEL && pend_sc >= 0) fold(pend_sc, pend_gb);

  const bool split = gridDim.z > 1;
  const size_t MN = static_cast<size_t>(M) * N;
  // per channel, 8-bit decoded row by row enters the dot minus 128
  const bool add128 = PERCHANNEL && ROUTE == ROWS && bits8;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ml = wm + mi * 16 + g + ((e & 2) ? 8 : 0);
        const int m = m0 + ml;
        const int n = n0 + wn + ni * 8 + 2 * t4 + (e & 1);
        if (m >= M || n >= N) continue;
        const size_t o = static_cast<size_t>(m) * N + n;
        if (!PERCHANNEL) {
          const float v = acc[mi][ni][e];
          if (split)
            static_cast<float*>(p.part)[blockIdx.z * MN + o] = v;
          else
            p.out[o] = v;
        } else if (split) {
          static_cast<int*>(p.part)[blockIdx.z * MN + o] = d[mi][ni][e];
        } else {
          // one scale row over all of K: row 0 of tile 0
          const int asum = sm.asum[0][ml];
          const int dd = d[mi][ni][e] + (add128 ? 128 * asum : 0);
          p.out[o] = __fsub_rn(__fmul_rn(static_cast<float>(dd), load_scale(p.s, n, p.s_f16)),
                               __fmul_rn(static_cast<float>(asum), load_scale(p.sz, n, p.s_f16)));
        }
      }
  if (PERCHANNEL && split && n0 == 0 && tid < TM && m0 + tid < M)
    static_cast<int*>(p.part)[gridDim.z * MN + blockIdx.z * static_cast<size_t>(M) + m0 + tid] =
        sm.asum[0][tid];
}

// Per channel with split K: the int32 partials of the sums and of asum added
// exactly (any order gives the same integers), then the one rescale.
__global__ void a8_perchannel_finish(const int* __restrict__ part, int splits, int M, int N,
                                     const void* __restrict__ s, const void* __restrict__ sz,
                                     int s_f16, int add128, float* __restrict__ out) {
  const size_t MN = static_cast<size_t>(M) * N;
  const int* asum_part = part + splits * MN;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < MN;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int m = static_cast<int>(i / N), n = static_cast<int>(i - static_cast<size_t>(m) * N);
    int dsum = 0, asum = 0;
    for (int z = 0; z < splits; ++z) {
      dsum += part[z * MN + i];
      asum += asum_part[static_cast<size_t>(z) * M + m];
    }
    const int dd = dsum + (add128 ? 128 * asum : 0);
    out[i] = __fsub_rn(__fmul_rn(static_cast<float>(dd), load_scale(s, n, s_f16)),
                       __fmul_rn(static_cast<float>(asum), load_scale(sz, n, s_f16)));
  }
}

template <bool PERCHANNEL, int ROUTE, int C>
int launch(const Args& args, int splits, cudaStream_t st) {
  using SM = Smem<ROUTE, C>;
  auto kernel = qgemv_a8_kernel<PERCHANNEL, ROUTE, C>;
  // above 48 KB shared memory is dynamic and has to be asked for
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(SM)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((args.M + TM - 1) / TM, (args.N + TN - 1) / TN, splits);
  kernel<<<grid, kThreads, sizeof(SM), st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// aq: int8 [M, K] contiguous and 16-byte aligned, K the packed row count; out:
// f32 [M, N].  perchannel != 0 takes one scale row (tile 0, row 0) for all of
// K.  route: 0 PAIRED, 1 BYTES, 2 ROWS (kernels/qgemv_kernel.a8_route); C:
// PAIRED steps of 128 K rows a nibble and word block (1 or 2).  Grid: x = M /
// 128, y = N / 128 (both rounded up), z = `splits` ranges of `per` steps
// (whole word blocks, and grouped whole groups).  With splits > 1, `part` is
// a workspace of splits * M * N f32 (grouped) or splits * (M * N + M) int32
// (per channel).  Returns cudaErrorInvalidValue (1) for a layout the route
// does not take.
extern "C" int xb_qgemv_a8(const void* aq, int M, int K, int N, const void* p0, const void* p1,
                           const void* p2, int pb0, int pb1, int pb2, int paired, const void* s,
                           const void* sz, int s_f16, int tile_k, int gt, int gt_pad,
                           int perchannel, int route, int C, int splits, int per, void* part,
                           void* out, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (gt < 1 || tile_k % gt || K % tile_k || splits < 1 || per < 1 || (splits > 1 && !part) ||
      reinterpret_cast<uintptr_t>(aq) % 16)
    return bad;
  Args args;
  args.a = static_cast<const int8_t*>(aq);
  args.M = M;
  args.K = K;
  args.N = N;
  args.pl = xb::make_planes(p0, p1, p2, pb0, pb1, pb2, paired);
  args.s = s;
  args.sz = sz;
  args.s_f16 = s_f16;
  args.tile_k = tile_k;
  args.gt = gt;
  args.gt_pad = gt_pad;
  const int g_tile = tile_k / gt, P = tile_k / 4;
  const bool one = args.pl.n == 1;
  int align = 1;
  if (route == PAIRED) {
    const int m = perchannel ? 128 : (g_tile < P ? g_tile : P);
    if (!one || !paired || pb0 != 4 || tile_k % 512 || (C != 1 && C != 2) || m != 128 * C ||
        (g_tile <= P ? P % g_tile : g_tile % P))
      return bad;
    args.n_steps = K / KA;
    align = 4 * C;
  } else if (route == BYTES) {
    if (!one || pb0 != 8 || tile_k % 128 || C != 1 || !(perchannel || g_tile == tile_k))
      return bad;
    args.n_steps = K / 32 / 4;
    align = perchannel ? 1 : P / 32;
  } else if (route == ROWS && C == 1) {
    const int cpg = (g_tile + KA - 1) / KA;
    args.n_steps = (K / g_tile) * cpg;
    align = perchannel ? 1 : cpg;
  } else {
    return bad;
  }
  if (per % align || static_cast<long long>(splits) * per < args.n_steps) return bad;
  args.per = per;
  args.n_vec = N % 4 == 0;
  for (int i = 0; i < args.pl.n; ++i)
    if (reinterpret_cast<uintptr_t>(args.pl.ptr[i]) % 16) args.n_vec = 0;
  args.a_vec = K % 16 == 0 && g_tile % 16 == 0;
  const int esz = s_f16 ? 2 : 4;
  args.sc_vec = (static_cast<size_t>(N) * esz) % 16 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(sz) % 16 == 0;
  args.part = splits > 1 ? part : nullptr;
  args.out = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (perchannel) {
    err = route == PAIRED  ? launch<true, PAIRED, 1>(args, splits, st)
          : route == BYTES ? launch<true, BYTES, 1>(args, splits, st)
                           : launch<true, ROWS, 1>(args, splits, st);
  } else {
    err = route == PAIRED  ? (C == 1 ? launch<false, PAIRED, 1>(args, splits, st)
                                     : launch<false, PAIRED, 2>(args, splits, st))
          : route == BYTES ? launch<false, BYTES, 1>(args, splits, st)
                           : launch<false, ROWS, 1>(args, splits, st);
  }
  if (err != 0 || splits == 1) return err;
  if (!perchannel) return xb::add_splits(static_cast<const float*>(part), splits, M, N, out, 1, st);
  const size_t MN = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  const bool add128 = route == ROWS && args.pl.n == 1 && pb0 == 8;
  a8_perchannel_finish<<<blocks, 256, 0, st>>>(static_cast<const int*>(part), splits, M, N, s, sz,
                                               s_f16, add128, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
