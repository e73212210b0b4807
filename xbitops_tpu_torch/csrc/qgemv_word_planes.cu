// Fused dequantize + matmul for a few rows (decode: M <= 16) at every width
// that is not the paired 4-bit plane or the 8-bit plane, reading every packed
// word once: out[M, N] = a[M, K] (bf16) @ dequant(qt)[K, N], f32 sums.  The
// layouts: one slot plane of 1 or 2 bits (widths 1, 2), two slot planes
// 2 + 1 (width 3), and the paired 4-bit plane with slot planes of 1, 2, or
// 2 + 1 bits (widths 5, 6, 7).
//
// The fourth form of the port of the Pallas kernel
// xbitops_tpu/kernels/qgemv_kernel.py:_kernel (entry qmatmul_kernel,
// qgemv_kernel.py:335), beside qgemv_word.cu (the paired 4-bit and the 8-bit
// plane), qgemv_mma.cu (the tile for large M) and qgemv.cu (the CUDA cores).
//
// What bounds it on an H100: bytes.  The packed planes are the only large
// read (3 bits a weight at width 3), so the card's memory rate is the limit;
// what keeps this kernel from it is instructions and tensor-core work a
// byte: at the 7B layouts every 16 K rows are a scale group of their own,
// so each run of 16 K rows takes a decode, a product of the M = 8 tile and
// a fold, however few bits it holds.
//
// Design:
// - the TPU kernel's algebra: out = sum_g s_g * (a_g . wq_g) - sz_g * asum_g
//   with wq = sum_p v_p << off_p, folded in f32 (acc += s * dot - sz * asum);
// - a UNIT is 16 word rows of the narrowest plane (F = 32 / its width fields
//   a word): the K rows t * tile_k + i * wt + r0 + [0, 16) for the F runs i,
//   wt = tile_k / F.  Every plane's words over those K rows are whole words:
//   a slot plane of width pb (32 / pb fields, word row r holding K rows
//   j * tile_k * pb / 32 + r) meets them in c = F * pb / 32 runs of 16 word
//   rows, run i = j * c + q sitting in field j of word run q; the paired
//   4-bit plane (K rows j * tile_k / 4 + 2r + h at bit 4j + 16h) in F / 4
//   runs of 8 word rows, run i = j * F / 4 + q in nibble j;
// - planes 1 and 2 of a unit (F / 2 + F / 4 of its word rows at width 7)
//   stay in registers while plane 0 streams, so that for every run each
//   plane's field is at hand: they are joined, by shifts and masks, into
//   the weight's integer value (below 128) in each half of a register, which
//   one OR into the mantissa of 128.0 and one bf16x2 subtraction make an
//   exact A-fragment register of mma.sync.m16n8k16 (two weights, two K
//   rows).  One product and one fold a run, whatever the width: walked plane
//   by plane with the planes' products added before the fold, the tensor
//   cores did a product of the M = 8 tile for every plane;
// - every word is read once, by one lane; slot planes first pass a byte
//   permute that puts word rows 2r and 2r + 1 side by side;
// - the products run TRANSPOSED as in qgemv_word.cu: out^T = W^T a^T, the
//   weights the 16-row A operand (a lane's 16-byte load holds 4 adjacent
//   columns, tiles ti of columns 4c + 2ti and 4c + 2ti + 1), the M <= 8
//   activation rows the 8 columns of B (M <= 16: two B tiles); asum is one
//   more product, a fragment of ones against the same B;
// - a unit's activations (16 K rows of each of its F runs) and each run's
//   scale row (fp16 s and sz of the block's 256 columns) are staged in
//   shared memory, so that the products and the folds read them there;
// - the words travel to shared memory by cp.async, each thread's own 64
//   bytes a piece (a slot plane's run of 16 word rows, or two of the paired
//   plane's runs of 8), into a ring of kDepth pieces: kDepth - 1 pieces are
//   in flight while one is decoded (and the other block of the SM runs),
//   and only the thread that copied a word reads it, so the ring needs no
//   barrier; the unit's activations and scales ride with its first piece,
//   and one barrier a unit makes them visible;
// - split-K over blockIdx.z in whole units with f32 partial sums, summed in
//   split order by the block that takes a column tile's last ticket, which
//   sets the counter back to 0 (the scheme of qgemv_word.cu).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 256;  // columns a block: 32 a warp
constexpr int kRun = 16;    // K rows a run: one k-step of the product
// Pieces in the ring.  Two, with two blocks an SM at M <= 8 (under 113 KB of
// shared memory a block), read 5-9% faster on the large shapes than four
// with one block (H100 80GB HBM3, 700 W; utils/variant_sweep.py).
constexpr int kDepth = 2;

struct Args {
  const __nv_bfloat16* a;
  int M, Ka, N;  // Ka: columns of a; packed rows from Ka on meet zeros
  const uint32_t* plane[3];
  const __half* s;
  const __half* sz;
  int tile_k, gt_pad, g_tile;
  int n_units, per, splits;
  float* part;
  int* counters;
  void* out;
  int out_f32;
};

// Word runs a unit of F runs meets in a plane of width pb (the paired 4-bit
// plane: F / 4), and pieces (one run; two of the paired plane's).
__host__ __device__ constexpr int runs_of(int F, int pb, bool paired) {
  return paired ? F / 4 : F * pb / 32;
}
__host__ __device__ constexpr int pieces_of(int F, int pb, bool paired) {
  return paired ? F / 8 : F * pb / 32;
}

// A layout: plane widths PB0 > PB1 > PB2 (0: no plane), plane 0 paired.
template <int PB0, int PB1, int PB2, bool PAIRED>
struct Layout {
  static constexpr int NP = PB2 ? 3 : (PB1 ? 2 : 1);
  static constexpr int F = 32 / (PB2 ? PB2 : (PB1 ? PB1 : PB0));  // runs a unit
  static constexpr int P0 = pieces_of(F, PB0, PAIRED);
  static constexpr int P1 = PB1 ? pieces_of(F, PB1, false) : 0;
  static constexpr int NPC = P0 + P1 + (PB2 ? pieces_of(F, PB2, false) : 0);  // pieces a unit
  static constexpr int NR = NPC - P0;  // pieces of planes 1 and 2, held in registers a unit
  // unit slots (activations and scales): the units whose pieces can be in
  // the ring together
  static constexpr int AS = (NPC + kDepth - 2) / NPC + 1;
  __host__ __device__ static constexpr int pb(int p) {
    return p == 0 ? PB0 : (p == 1 ? PB1 : PB2);
  }
  __host__ __device__ static constexpr bool paired(int p) { return PAIRED && p == 0; }
  // fields of a word that lie in different runs (a paired nibble: 2 K rows)
  __host__ __device__ static constexpr int fields(int p) { return paired(p) ? 4 : 32 / pb(p); }
  __host__ __device__ static constexpr int runs(int p) { return runs_of(F, pb(p), paired(p)); }
  __host__ __device__ static constexpr int off(int p) {
    return p == 0 ? 0 : (p == 1 ? PB0 : PB0 + PB1);
  }
};

template <class L, int MT>
struct Smem {
  static constexpr int kRows = 8 * MT;
  static constexpr int kStride = L::F * kRun + 8;  // bf16 a staged row: conflict-free fragments
  uint4 w[kDepth][4][kThreads];                    // the ring: a thread's 64 bytes a piece
  __nv_bfloat16 a[L::AS][kRows][kStride];          // a unit's activations, run by run
  __half sc[L::AS][L::F][2][kCols];                // each run's scale row: s, sz of the columns
};

template <class L, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
qgemv_planes_kernel(const Args p) {
  using SM = Smem<L, MT>;
  constexpr int F = L::F, NPC = L::NPC, AS = L::AS, kRows = SM::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int M = p.M, N = p.N, tile_k = p.tile_k;
  const int wt = tile_k / F;                   // K rows between two runs of a unit
  const int upt = wt / kRun;                   // units a K-tile
  const int col0 = blockIdx.x * kCols;
  const int wcol = warp * 32 + 4 * g;          // the lane's 4 columns in the block
  const int col = col0 + wcol;
  const bool live = col < N;                   // N % 8 == 0: 4 columns all in or all out
  const int u_begin = blockIdx.z * p.per;
  const int u_end = min(p.n_units, u_begin + p.per);

  // the copies of piece pc of unit u into ring slot `slot`: a thread's four
  // 16-byte word loads (slot plane: word rows 2 t4 + 8h + e of the run at
  // [2h + e]; paired plane: rows t4 + 4h of its run 2sq + s at [2s + h]);
  // with the unit's first piece its activations and scale rows, into unit
  // slot `aslot`
  auto issue = [&](int u, int pc, int slot, int aslot) {
    const int t = u / upt, r0 = (u - t * upt) * kRun;
    // a unit's pieces: planes 1 and 2 first (held in registers), then plane 0
    const int pl = pc >= L::NR ? 0 : (pc < L::P1 ? 1 : 2);
    const int sq = pc - (pl == 0 ? L::NR : (pl == 1 ? 0 : L::P1));
    const uint32_t* plane = pl == 0 ? p.plane[0] : (pl == 1 ? p.plane[1] : p.plane[2]);
    const int pbw = pl == 0 ? L::pb(0) : (pl == 1 ? L::pb(1) : L::pb(2));
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      int r;
      if (L::paired(0) && pl == 0)
        r = t * (tile_k >> 3) + ((2 * sq + (x >> 1)) * wt + r0) / 2 + t4 + 4 * (x & 1);
      else
        r = t * (tile_k * pbw / 32) + sq * wt + r0 + 2 * t4 + 8 * (x >> 1) + (x & 1);
      xb::cp_async_16(&sm.w[slot][x][tid],
                      live ? plane + static_cast<size_t>(r) * N + col : plane, live);
    }
    if (pc != 0) return;
    for (int idx = tid; idx < kRows * F * 2; idx += kThreads) {
      const int m = idx / (2 * F), i = (idx >> 1) % F, hf = idx & 1;
      const int k = t * tile_k + i * wt + r0 + 8 * hf;
      const bool ok = m < M && k < p.Ka;
      xb::cp_async_16(&sm.a[aslot][m][i * kRun + 8 * hf],
                      ok ? p.a + static_cast<size_t>(m) * p.Ka + k : p.a, ok);
    }
    // the scale row of each run i, 8 columns a copy
    for (int idx = tid; idx < F * 2 * (kCols / 8); idx += kThreads) {
      const int i = idx / (2 * (kCols / 8)), z = (idx / (kCols / 8)) & 1, c8 = 8 * (idx & 31);
      const bool ok = col0 + c8 < N;
      const __half* src = z ? p.sz : p.s;
      const int row = t * p.gt_pad + (i * wt + r0) / p.g_tile;
      xb::cp_async_16(&sm.sc[aslot][i][z][c8],
                      ok ? src + static_cast<size_t>(row) * N + col0 + c8 : src, ok);
    }
  };

  // acc[mt][ti][2h + e]: row 8mt + 2t4 + e, column col + 2ti + h
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][0][e] = acc[mt][1][e] = 0.f;

  // the ring's first kDepth - 1 pieces
#pragma unroll
  for (int pa = 0; pa < kDepth - 1; ++pa) {
    const int u2 = u_begin + pa / NPC;
    if (u2 < u_end) issue(u2, pa % NPC, pa, (pa / NPC) % AS);
    xb::cp_async_commit();
  }

  int n = 0;  // pieces consumed
  for (int u = u_begin; u < u_end; ++u) {
    const int aslot = (u - u_begin) % AS;

    // piece pc of the unit out of the ring, the next one asked for
    auto next_piece = [&](int pc, uint32_t (&wv)[4][4]) {
      xb::cp_async_wait<kDepth - 2>();  // this thread's copies of piece n are in
      if (pc == 0) __syncthreads();     // everyone's copies of unit u are in
      const int pa = pc + kDepth - 1;   // the piece kDepth - 1 ahead
      const int u2 = u + pa / NPC;
      if (u2 < u_end) issue(u2, pa % NPC, (n + kDepth - 1) % kDepth, (u2 - u_begin) % AS);
      xb::cp_async_commit();
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const uint4 v = sm.w[n % kDepth][x][tid];
        wv[x][0] = v.x, wv[x][1] = v.y, wv[x][2] = v.z, wv[x][3] = v.w;
      }
      ++n;
    };
    // slot planes: word rows 2i and 2i + 1 side by side, low and high halves
    auto pairs = [](const uint32_t (&wv)[4][4], uint32_t (&pr)[2][2][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pr[0][h][c] = __byte_perm(wv[2 * h][c], wv[2 * h + 1][c], 0x5410);
          pr[1][h][c] = __byte_perm(wv[2 * h][c], wv[2 * h + 1][c], 0x7632);
        }
    };

    // planes 1 and 2, every word of the unit, as pairs
    uint32_t res[L::NR > 0 ? L::NR : 1][2][2][4];
#pragma unroll
    for (int rp = 0; rp < L::NR; ++rp) {
      uint32_t wv[4][4];
      next_piece(rp, wv);
      pairs(wv, res[rp]);
    }

    // plane 0, piece by piece; each run's fields of every plane make one
    // integer (the weight's value, below 128) in each half of an A register
    constexpr bool PAIR = L::paired(0);
    constexpr int FJ = L::fields(0), C = L::runs(0), SR = PAIR ? 2 : 1, PB = L::pb(0);
    constexpr uint32_t MASK = PAIR ? 0x000F000Fu : ((1u << PB) - 1u) * 0x00010001u;
#pragma unroll
    for (int sq = 0; sq < L::P0; ++sq) {
      uint32_t wv[4][4], pr[2][2][4];
      next_piece(L::NR + sq, wv);
      if constexpr (!PAIR) pairs(wv, pr);
#pragma unroll
      for (int j = 0; j < FJ; ++j)
#pragma unroll
        for (int s = 0; s < SR; ++s) {
          const int i = j * C + SR * sq + s;  // the run
          // the weights as A fragments: tile ti, rows c and c + 8 are
          // columns col + 2ti and col + 2ti + 1; k pairs 2t4 and 2t4 + 8
          uint32_t wa[2][4];
#pragma unroll
          for (int ti = 0; ti < 2; ++ti)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int c = 2 * ti + (x & 1), h = x >> 1;
              uint32_t v;
              if constexpr (PAIR) {
                v = (wv[2 * s + h][c] >> (4 * j)) & MASK;
              } else {
                v = (pr[(PB * j) >> 4][h][c] >> ((PB * j) & 15)) & MASK;
              }
              // plane p's field of run i, moved to bit off_p of each half
              auto add_plane = [&](auto P_) {
                constexpr int P = decltype(P_)::value;
                constexpr int PBP = L::pb(P), CP = L::runs(P), OFF = L::off(P);
                const int rp = (P == 1 ? 0 : L::P1) + i % CP;  // constants once unrolled
                const int sh = PBP * (i / CP), d = (sh & 15) - OFF;
                constexpr uint32_t M = ((1u << PBP) - 1u) * 0x00010001u << OFF;
                const uint32_t w = res[rp][sh >> 4][h][c];
                v |= (d >= 0 ? w >> d : w << -d) & M;
              };
              if constexpr (L::NP > 1) add_plane(std::integral_constant<int, 1>{});
              if constexpr (L::NP > 2) add_plane(std::integral_constant<int, 2>{});
              wa[ti][x] = xb::bf162_sub(v | xb::kBf16x2_128, xb::kBf16x2_128);
            }
          const uint32_t ones[4] = {xb::kBf16x2_1, xb::kBf16x2_1, xb::kBf16x2_1,
                                    xb::kBf16x2_1};
          const int k = i * kRun + 2 * t4;
          float dot[MT][2][4] = {}, asum[MT][4] = {};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // the activations as B: column g of the tile is row 8mt + g
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sm.a[aslot][8 * mt + g][k]);
            const uint32_t b1 =
                *reinterpret_cast<const uint32_t*>(&sm.a[aslot][8 * mt + g][k + 8]);
            xb::mma_bf16(dot[mt][0], wa[0], b0, b1);
            xb::mma_bf16(dot[mt][1], wa[1], b0, b1);
            xb::mma_bf16(asum[mt], ones, b0, b1);
          }
          // fold with the run's scale row, columns col..col + 3
          const uint2 sx = *reinterpret_cast<const uint2*>(&sm.sc[aslot][i][0][wcol]);
          const uint2 sy = *reinterpret_cast<const uint2*>(&sm.sc[aslot][i][1][wcol]);
          const float2 x0 = __half22float2(*reinterpret_cast<const __half2*>(&sx.x));
          const float2 x1 = __half22float2(*reinterpret_cast<const __half2*>(&sx.y));
          const float2 y0 = __half22float2(*reinterpret_cast<const __half2*>(&sy.x));
          const float2 y1 = __half22float2(*reinterpret_cast<const __half2*>(&sy.y));
          const float sv[4] = {x0.x, x0.y, x1.x, x1.y}, zv[4] = {y0.x, y0.y, y1.x, y1.y};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int ti = 0; ti < 2; ++ti)
#pragma unroll
              for (int e4 = 0; e4 < 4; ++e4) {
                const int c = 2 * ti + (e4 >> 1);
                acc[mt][ti][e4] = fmaf(-zv[c], asum[mt][e4 & 1],
                                       fmaf(sv[c], dot[mt][ti][e4], acc[mt][ti][e4]));
              }
        }
    }
  }
  xb::cp_async_wait<0>();  // no copy outlives the block

  // rows 8mt + 2t4 + e, 4 adjacent columns a lane
  const size_t MN = static_cast<size_t>(M) * N;
  auto store_rows = [&](float* dst_f32, __nv_bfloat16* dst_bf16) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * mt + 2 * t4 + e;
        if (m >= M || !live) continue;
        const float o[4] = {acc[mt][0][e], acc[mt][0][2 + e], acc[mt][1][e], acc[mt][1][2 + e]};
        const size_t at = static_cast<size_t>(m) * N + col;
        if (dst_f32) {
          *reinterpret_cast<float4*>(dst_f32 + at) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
          __align__(8) __nv_bfloat162 h[2] = {__floats2bfloat162_rn(o[0], o[1]),
                                              __floats2bfloat162_rn(o[2], o[3])};
          *reinterpret_cast<uint2*>(dst_bf16 + at) = *reinterpret_cast<const uint2*>(h);
        }
      }
  };
  float* out_f32 = p.out_f32 ? static_cast<float*>(p.out) : nullptr;
  __nv_bfloat16* out_bf16 = p.out_f32 ? nullptr : static_cast<__nv_bfloat16*>(p.out);
  if (p.splits == 1) {
    store_rows(out_f32, out_bf16);
    return;
  }
  store_rows(p.part + blockIdx.z * MN, nullptr);
  __threadfence();  // the partial sums are visible before the ticket is taken
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counters[blockIdx.x], 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block of the column tile: all partial sums, in split order
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * mt + 2 * t4 + e;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      if (m < M && live) {
        const float* src = p.part + static_cast<size_t>(m) * N + col;
        for (int z = 0; z < p.splits; ++z) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(src + z * MN));
          o[0] += v.x, o[1] += v.y, o[2] += v.z, o[3] += v.w;
        }
      }
      acc[mt][0][e] = o[0], acc[mt][0][2 + e] = o[1];
      acc[mt][1][e] = o[2], acc[mt][1][2 + e] = o[3];
    }
  store_rows(out_f32, out_bf16);
  if (tid == 0) p.counters[blockIdx.x] = 0;  // ready for the next call
}

template <class L, int MT>
int launch(const Args& args, cudaStream_t st) {
  auto kernel = qgemv_planes_kernel<L, MT>;
  constexpr int bytes = static_cast<int>(sizeof(Smem<L, MT>));
  // above 48 KB shared memory is dynamic and has to be asked for
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((args.N + kCols - 1) / kCols, 1, args.splits);
  kernel<<<grid, kThreads, bytes, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <class L>
int dispatch(const Args& args, cudaStream_t st) {
  return args.M > 8 ? launch<L, 2>(args, st) : launch<L, 1>(args, st);
}

}  // namespace

// a: bf16 [M, Ka] contiguous and 16-byte aligned, M <= 16, Ka <= K a multiple
// of 8 (the packed rows from Ka on meet zeros: K padding); p0..p2 the planes
// of widths pb0..pb2 (0: none) as kernels/common.qtensor_args gives them:
// widths 1, 2, 3 (2 + 1), 5 (4 + 1), 6 (4 + 2) and 7 (4 + 2 + 1), the 4-bit
// plane paired; s, sz fp16 [K / tile_k, gt_pad, N], N a multiple of 8.  Grid:
// x = N / 256, z = `splits` ranges of `per` units of 16 word rows of the
// narrowest plane.  With splits > 1, `part` is an f32 workspace of splits * M
// * N values and `counters` holds one int per column tile, all 0 at the call
// and all 0 again when the kernel has run (calls that share the counters
// must be ordered, as launches on one stream are).  Returns
// cudaErrorInvalidValue (1) for a layout it does not take: f32 scales, N not
// a multiple of 8, K-tiles that are not whole units, or scale groups that cut
// a run of 16 K rows.
extern "C" int xb_qgemv_word_planes(const void* a, int M, int K, int Ka, int N, const void* p0,
                                    const void* p1, const void* p2, int pb0, int pb1, int pb2,
                                    int paired, const void* s, const void* sz, int s_f16,
                                    int tile_k, int gt, int gt_pad, int splits, int per,
                                    void* part, void* counters, void* out, int out_f32,
                                    void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || M > 16 || !s_f16 || N % 8 || gt < 1 || tile_k % gt || K % tile_k ||
      splits < 1 || per < 1 || (splits > 1 && (!part || !counters)) || Ka > K || Ka % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16)
    return invalid;
  const int np = p2 ? 3 : (p1 ? 2 : 1);
  const int minpb = np == 3 ? pb2 : (np == 2 ? pb1 : pb0);
  if (minpb < 1 || 32 % minpb) return invalid;
  const int F = 32 / minpb, g_tile = tile_k / gt;
  if (tile_k % (kRun * F) || g_tile % kRun) return invalid;
  Args args;
  args.a = static_cast<const __nv_bfloat16*>(a);
  args.M = M;
  args.Ka = Ka;
  args.N = N;
  args.plane[0] = static_cast<const uint32_t*>(p0);
  args.plane[1] = static_cast<const uint32_t*>(p1);
  args.plane[2] = static_cast<const uint32_t*>(p2);
  args.s = static_cast<const __half*>(s);
  args.sz = static_cast<const __half*>(sz);
  args.tile_k = tile_k;
  args.gt_pad = gt_pad;
  args.g_tile = g_tile;
  args.n_units = K / (kRun * F);
  args.per = per;
  args.splits = splits;
  if (static_cast<long long>(splits) * per < args.n_units) return invalid;
  args.part = static_cast<float*>(part);
  args.counters = static_cast<int*>(counters);
  args.out = out;
  args.out_f32 = out_f32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = pb0 * 100 + pb1 * 10 + pb2;
  if (paired && pb0 == 4) {
    switch (key) {
      case 410: return dispatch<Layout<4, 1, 0, true>>(args, st);
      case 420: return dispatch<Layout<4, 2, 0, true>>(args, st);
      case 421: return dispatch<Layout<4, 2, 1, true>>(args, st);
    }
  } else if (!paired) {
    switch (key) {
      case 100: return dispatch<Layout<1, 0, 0, false>>(args, st);
      case 200: return dispatch<Layout<2, 0, 0, false>>(args, st);
      case 210: return dispatch<Layout<2, 1, 0, false>>(args, st);
    }
  }
  return invalid;
}
