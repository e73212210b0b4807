// Chunked-prefill attention: a [N, T, H, D] chunk of queries against the
// cache rows of slots slot_ids[n] of one layer, causal by global position;
// out [N, T, H, D].  The cache is dense rows k/v [B, Hkv, S, D] of bf16, fp16
// or f32, or the packed int8 cache, words [B, Hkv, S/4, D] int32 (byte j of
// word w = position 4w + j, stored as value + 128) with bf16 scales
// [B, 4, Hkv, S/4].
//
// Replaces the Pallas kernels xbitops_tpu/kernels/prefill_attention.py
// _kernel_v2 (prefill_attention.py:188) and _kernel_v1
// (prefill_attention.py:152, body _body_shared :52), entry prefill_attention
// (prefill_attention.py:251).  The TPU's two forms (a grid over kv blocks for
// the interpreter, a pipelined program per q-tile on the chip, both walking
// the q-tiles in sequence with the softmax state in scratch) become this one
// kernel.
//
// What bounds it on an H100: operations.  A chunk does 4 * D flops for every
// (query, visible key, head) and reads each visible cache row once per
// q-tile from L2, so it sits far above the memory line, and both products
// run on the tensor cores (mma.sync.m16n8k16 bf16, f32 sums; mma.cuh):
// - one block per (q-tile of 64 queries, query head, chunk row): blocks are
//   independent, so nothing is carried across the grid, and a block loops
//   over the key tiles of [window_lo, max position of its tile] only.  Query
//   head h reads kv head h / rep; the rep blocks of a kv head find its rows
//   in L2;
// - each of the four warps owns 16 queries.  The q-tile goes to shared memory
//   once and from there, through ldmatrix, into A fragments that stay in
//   registers for D <= 128 (D = 256 reads them again each key tile: q, the
//   output and the scores together would spill);
// - a key tile of 64 positions sits in shared memory as bf16, k and v, in two
//   buffers: the next tile loads while this one multiplies.  bf16 cache rows
//   come by cp.async (16 bytes a copy); int8 words
//   are fetched into registers before the products and unpacked after them,
//   to byte - 128, which bf16 holds exactly (two bytes with one byte permute,
//   two logic operations and one bf16x2 subtraction);
// - s = q k^T with the k rows as the column operand (ldmatrix), the online
//   softmax on the accumulator fragments in registers (a row's maximum and
//   sum live in a quad of lanes: two shuffles), p rounded to bf16 in
//   registers, where the score fragment IS the A fragment of p v, and v
//   through ldmatrix.trans.  No probability passes shared memory;
// - the scales never touch the tile: the score is (q . (byte - 128)) * scale
//   * ks per key, and the v scale is folded into p before it is rounded.  The
//   TPU kernel's 128 * sum(q) correction and 2^(-8j) field scaling avoided
//   shifts on its vector unit and are not copied;
// - p is rounded to bf16 before p v in both cache forms (the TPU kernel did so
//   on the dense path); the row sum uses the unrounded f32 values.  The plain
//   version keeps f32 probabilities: the difference is inside abs 2e-2;
// - the output tile returns through the q-tile's shared memory, so a row is
//   written in 16-byte pieces.
// Every query is masked by its own position: a key s is visible to a query at
// p when s <= p and, with a window w > 0, s > p - w.  A query whose position
// lies outside [0, S) is padding: it sees nothing and its output is exactly
// 0.  A tile of nothing but padding reads no cache row.  T need not be a
// multiple of the q-tile.
//
// The paged form (entry xb_prefill_attention_paged): k/v are page pools
// [n_pages, Hkv, psz, D] (int8: words [n_pages, Hkv, psz/4, D], scales
// [n_pages, 4, Hkv, psz/4]) and position p of slot b lies in pool page
// table[b, p / psz] at row p % psz.  The JAX package has no such kernel: with
// a table it gathers a slot's pages into one context per layer and attends
// eagerly.  Here the lookup is in the tile load: a key tile of 64 positions
// may cross pages (page_size 16), so each thread finds the page of the row
// (int8: of the word, which never crosses a page) it loads, one division and
// one table read per 16-byte load (a shift when the page size is a power of
// two, as the usual 16 to 256 are; finding the page once a tile where pages
// hold whole tiles was tried and moved nothing).  The rest of the kernel sees
// the same shared-memory tile.  The linear cache is the case of one page of S rows per
// slot.  A table entry is clamped into [0, n_pages) before use: rows of a page
// that was never given are never visible to a live query, and nothing faults.
//
// The fp16 and f32 caches (q and the output stay bf16), as in
// csrc/decode_attention.cu.  fp16: the q-tile is converted to fp16 on its way
// to shared memory, the key tiles come by cp.async as they are, and both
// products run on the fp16 tensor cores with p rounded to fp16.  f32: k and v
// must not be rounded to bf16, so each f32 operand is split in registers into
// a bf16 high and low part: q k^T = q k_hi + q k_lo, and p v = p_hi v_hi +
// p_hi v_lo + p_lo v_hi (the dropped term is below 2^-17 of the result).
// The f32 tiles are read by plain loads in the fragments' order (k rows D + 8
// floats apart, v rows D + 4: no bank conflicts) in place of ldmatrix, and
// take twice the shared memory: two buffers of k and v at D <= 128 (156 KB at
// D = 128), one at D = 256, whose key tile then loads after the previous one
// is consumed.  The split costs 2 products for q k^T and 3 for p v where the
// 16-bit forms take one each, on a kernel that is bound by its operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kvtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;            // queries per warp: one mma row tile
constexpr int kTQ = kWarps * kRows;  // queries per block
constexpr int kBK = 64;              // keys per tile
constexpr float kNegInf = -1e30f;

// T: the key tiles' element (bf16, also for the int8 cache, fp16 or f32);
// NBUF key tiles of k and of v.  16-bit rows lie 16 bytes apart in the banks:
// conflict-free ldmatrix; f32 rows: k D + 8 floats apart, v D + 4 (see
// csrc/decode_attention.cu).
template <int D, typename T, int NBUF>
struct alignas(16) Smem {
  uint16_t q[kTQ][D + 8];  // bf16 values, or fp16 for the fp16 cache; then the output
  T k[NBUF][kBK][D + 8];
  T v[NBUF][kBK][D + (sizeof(T) == 4 ? 4 : 8)];
  float ksc[2][kBK];  // int8, per key: softmax scale times the k scale
  float vsc[2][kBK];  // int8, per key: the v scale
  int pos[kTQ];       // per query: its position, -1 for padding
  int hi, lo;         // largest and smallest live position of the tile
};

using xb::pack_bf16;
using xb::unpack_pair;

// The block of `rows` rows that holds row `r` of a slot, and the row inside
// it.  Linear: the slot's own block.  Paged: page table_row[r / rows], clamped;
// shift >= 0 says rows == 1 << shift.
template <bool PAGED>
__device__ __forceinline__ size_t find_block(int r, int slot, int rows, int shift,
                                             const int* __restrict__ table_row, int n_pages,
                                             int* in_block) {
  if constexpr (PAGED) {
    const int pi = shift >= 0 ? r >> shift : r / rows;
    *in_block = r - pi * rows;
    return static_cast<size_t>(min(max(table_row[pi], 0), n_pages - 1));
  } else {
    *in_block = r;
    return static_cast<size_t>(slot);
  }
}

template <int KV, int D>
struct Tiles {
  static constexpr int kBufs = KV == xb::kKvF32 && D > 128 ? 1 : 2;
  using T = typename xb::KvElem<KV>::T;
  using Layout = Smem<D, T, kBufs>;
};

// DPL: D / 32.  KV: the cache form (xb::KvForm).  INT8: k/v are packed words
// and ks/vs their scales; otherwise k/v are dense rows and ks/vs are unused.
// PAGED: k/v (and ks/vs) are pools of pages of psz positions found through
// table [B, S / psz]; otherwise psz == S.
template <int DPL, int KV, bool PAGED>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const void* __restrict__ k_raw, const void* __restrict__ v_raw,
                         const __nv_bfloat16* __restrict__ ks,
                         const __nv_bfloat16* __restrict__ vs,
                         const int* __restrict__ positions,
                         const int* __restrict__ slot_ids, const int* __restrict__ table,
                         __nv_bfloat16* __restrict__ out, int T, int H, int Hkv, int B,
                         int S, int psz, int n_pages, int window, float scale) {
  // log2 of the page size where it is a power of two (int8: of 4 or more), else -1
  const int psz_shift = PAGED && (psz & (psz - 1)) == 0 ? __ffs(psz) - 1 : -1;
  constexpr int D = DPL * 32;
  constexpr bool INT8 = KV == xb::kKvInt8, F16 = KV == xb::kKvF16, F32 = KV == xb::kKvF32;
  using E = typename Tiles<KV, D>::T;  // a key tile's element (T is the chunk's length)
  constexpr int NBUF = Tiles<KV, D>::kBufs;
  constexpr int EPC = 16 / sizeof(E);  // dense values in 16 bytes
  constexpr int KSTEPS = D / 16;     // k16 steps of q k^T; pairs of 8-wide output tiles of p v
  constexpr bool QREG = D <= 128;    // the q fragments stay in registers
  constexpr int ITEMS = D / 32;      // int8: (word row, four columns) items a thread a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<typename Tiles<KV, D>::Layout*>(smem_raw);

  const int t0 = blockIdx.x * kTQ, h = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hk = h / (H / Hkv);
  const int slot = min(max(slot_ids[n], 0), B - 1);
  const int* table_row = PAGED ? table + static_cast<size_t>(slot) * (S / psz) : nullptr;

  if (tid == 0) {
    sm.hi = -1;
    sm.lo = S;
  }
  __syncthreads();
  if (tid < kTQ) {
    const int t = t0 + tid;
    int p = t < T ? positions[static_cast<size_t>(n) * T + t] : -1;
    if (p < 0 || p >= S) p = -1;
    sm.pos[tid] = p;
    if (p >= 0) {
      atomicMax(&sm.hi, p);
      atomicMin(&sm.lo, p);
    }
  }
  // the q tile; rows past T are zero
  for (int idx = tid; idx < kTQ * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8), c = idx - r * (D / 8);
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T)
      w = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(n) * T + t0 + r) * H + h) * D + c * 8);
    if constexpr (F16) {  // the fp16 products take q as fp16
      w.x = xb::bf162_to_f162(w.x);
      w.y = xb::bf162_to_f162(w.y);
      w.z = xb::bf162_to_f162(w.z);
      w.w = xb::bf162_to_f162(w.w);
    }
    *reinterpret_cast<uint4*>(&sm.q[r][c * 8]) = w;
  }
  __syncthreads();

  const int hi = sm.hi;
  const int lo = window > 0 ? max(sm.lo - (window - 1), 0) : 0;
  // lane 4g + t4 holds rows g and g + 8 of its warp's 16 queries
  const int pos_r[2] = {sm.pos[warp * kRows + g], sm.pos[warp * kRows + g + 8]};
  int warp_hi = -1;
  for (int r = 0; r < kRows; ++r) warp_hi = max(warp_hi, sm.pos[warp * kRows + r]);

  const uint16_t* q_lane = &sm.q[warp * kRows + (lane & 15)][(lane >> 4) * 8];
  uint32_t qf[QREG ? KSTEPS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) xb::ldmatrix_x4(qf[s], q_lane + s * 16);
  }

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float o[2 * KSTEPS][4];
#pragma unroll
  for (int dt = 0; dt < 2 * KSTEPS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  const int Sw = S / 4, pszw = psz / 4;

  // dense cache: queue the copies of the 64 rows from kb on into buffer `buf`
  auto queue_tile = [&](int kb, int buf) {
    const E* kp = static_cast<const E*>(k_raw);
    const E* vp = static_cast<const E*>(v_raw);
    for (int idx = tid; idx < kBK * (D / EPC); idx += kThreads) {
      const int r = idx / (D / EPC), c = idx - r * (D / EPC);
      const bool valid = kb + r < S;  // beyond the cache: zeros
      size_t at = 0;
      if (valid) {
        int ri;
        const size_t blk = find_block<PAGED>(kb + r, slot, psz, psz_shift, table_row, n_pages, &ri);
        at = ((blk * Hkv + hk) * psz + ri) * D + c * EPC;
      }
      xb::cp_async_16(&sm.k[buf][r][c * EPC], kp + at, valid);
      xb::cp_async_16(&sm.v[buf][r][c * EPC], vp + at, valid);
    }
    xb::cp_async_commit();
  };
  // int8 cache: the tile's words and scales into registers ...
  uint4 kw_r[ITEMS], vw_r[ITEMS];
  float ks_r = 0.f, vs_r = 0.f;
  auto fetch_tile = [&](int kb) {
    const uint32_t* kw = static_cast<const uint32_t*>(k_raw);
    const uint32_t* vw = static_cast<const uint32_t*>(v_raw);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int idx = tid + it * kThreads;
      const int wr = idx / (D / 4), c = idx - wr * (D / 4);
      const int w = kb / 4 + wr;
      // beyond the cache: byte 128, the value 0
      kw_r[it] = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
      vw_r[it] = kw_r[it];
      if (w < Sw) {
        int wi;
        const size_t blk = find_block<PAGED>(w, slot, pszw, psz_shift - 2, table_row, n_pages, &wi);
        const size_t at = ((blk * Hkv + hk) * pszw + wi) * D + c * 4;
        kw_r[it] = *reinterpret_cast<const uint4*>(kw + at);
        vw_r[it] = *reinterpret_cast<const uint4*>(vw + at);
      }
    }
    if (tid < kBK) {
      const int s = kb + tid;
      ks_r = vs_r = 0.f;
      if (s < S) {
        // scales[blk, j, h, w] of position 4w + j of the block
        int si;
        const size_t blk = find_block<PAGED>(s, slot, psz, psz_shift, table_row, n_pages, &si);
        const size_t at = ((blk * 4 + (si & 3)) * Hkv + hk) * pszw + (si >> 2);
        ks_r = __bfloat162float(ks[at]);
        vs_r = __bfloat162float(vs[at]);
      }
    }
  };
  // ... and from the registers into buffer `buf` as bf16 (byte - 128)
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int idx = tid + it * kThreads;
      const int wr = idx / (D / 4), c = idx - wr * (D / 4);
      const uint4 a = kw_r[it], b = vw_r[it];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        *reinterpret_cast<uint2*>(&sm.k[buf][4 * wr + jj][c * 4]) =
            make_uint2(unpack_pair(a.x, a.y, jj), unpack_pair(a.z, a.w, jj));
        *reinterpret_cast<uint2*>(&sm.v[buf][4 * wr + jj][c * 4]) =
            make_uint2(unpack_pair(b.x, b.y, jj), unpack_pair(b.z, b.w, jj));
      }
    }
    if (tid < kBK) {
      sm.ksc[buf][tid] = ks_r * scale;
      sm.vsc[buf][tid] = vs_r;
    }
  };

  const int kb0 = hi >= 0 ? (lo / kBK) * kBK : 0;
  const int n_tiles = hi >= 0 ? (hi - kb0) / kBK + 1 : 0;
  if (n_tiles > 0) {
    if constexpr (INT8) {
      fetch_tile(kb0);
      store_tile(0);
    } else {
      queue_tile(kb0, 0);
    }
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int kb = kb0 + it * kBK, buf = NBUF == 2 ? it & 1 : 0;
    const bool more = it + 1 < n_tiles;
    // the next tile is on its way while this one multiplies (one buffer: it
    // loads after this one is consumed, below)
    if constexpr (INT8) {
      if (more) fetch_tile(kb + kBK);
    } else if constexpr (NBUF == 2) {
      if (more) {
        queue_tile(kb + kBK, buf ^ 1);
        xb::cp_async_wait<1>();
      } else {
        xb::cp_async_wait<0>();
      }
    } else {
      xb::cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory

    if (kb <= warp_hi) {  // else no query of this warp sees the tile (warp-uniform)
      // scores: 16 queries x 64 keys a warp, 8 tiles of 8 keys
      float sc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        uint32_t af[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) af[e] = qf[s][e];
        } else {
          xb::ldmatrix_x4(af, q_lane + s * 16);
        }
        if constexpr (F32) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            // key 8nt + g, dims 2t4 (+ 8) as ldmatrix would give them, split
            const float* r = &sm.k[buf][nt * 8 + g][s * 16 + 2 * t4];
            const float2 x0 = *reinterpret_cast<const float2*>(r);
            const float2 x1 = *reinterpret_cast<const float2*>(r + 8);
            uint32_t h0, l0, h1, l1;
            xb::split_bf16(x0.x, x0.y, h0, l0);
            xb::split_bf16(x1.x, x1.y, h1, l1);
            xb::mma_bf16(sc[nt], af, h0, h1);
            xb::mma_bf16(sc[nt], af, l0, l1);
          }
        } else {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            // keys 16np.. : (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7), (8-15, 8-15)
            uint32_t bk[4];
            xb::ldmatrix_x4(bk, &sm.k[buf][np * 16 + ((lane >> 4) << 3) + (lane & 7)]
                                         [s * 16 + ((lane >> 3) & 1) * 8]);
            if constexpr (F16) {
              xb::mma_f16(sc[2 * np], af, bk[0], bk[1]);
              xb::mma_f16(sc[2 * np + 1], af, bk[2], bk[3]);
            } else {
              xb::mma_bf16(sc[2 * np], af, bk[0], bk[1]);
              xb::mma_bf16(sc[2 * np + 1], af, bk[2], bk[3]);
            }
          }
        }
      }

      // mask by position and online softmax, on the fragments: c0, c1 are row
      // g and c2, c3 row g + 8, keys 8nt + 2t4 and + 1
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = pos_r[half];
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kl = nt * 8 + 2 * t4 + e, s = kb + kl;
            const bool live = s <= p && (window <= 0 || s > p - window);
            const float x = live ? sc[nt][2 * half + e] * (INT8 ? sm.ksc[buf][kl] : scale)
                                 : kNegInf;
            sc[nt][2 * half + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[half], mx);
        const float alpha = __expf(m_r[half] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = sc[nt][2 * half + e];
            const float pe = x > 0.5f * kNegInf ? __expf(x - m_new) : 0.f;
            sum += pe;
            sc[nt][2 * half + e] = INT8 ? pe * sm.vsc[buf][nt * 8 + 2 * t4 + e] : pe;
          }
        l_r[half] = l_r[half] * alpha + sum;  // this lane's keys; summed over the quad at the end
        m_r[half] = m_new;
#pragma unroll
        for (int dt = 0; dt < 2 * KSTEPS; ++dt) {
          o[dt][2 * half] *= alpha;
          o[dt][2 * half + 1] *= alpha;
        }
      }

      // o += p v: the score fragments of keys 16kk.. are the A fragment of step kk
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t pa[4], pl[4];  // p (f32: its high part) and, f32, its low part
        if constexpr (F32) {
          xb::split_bf16(sc[2 * kk][0], sc[2 * kk][1], pa[0], pl[0]);
          xb::split_bf16(sc[2 * kk][2], sc[2 * kk][3], pa[1], pl[1]);
          xb::split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pa[2], pl[2]);
          xb::split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pa[3], pl[3]);
        } else if constexpr (F16) {
          pa[0] = xb::pack_f16(sc[2 * kk][0], sc[2 * kk][1]);
          pa[1] = xb::pack_f16(sc[2 * kk][2], sc[2 * kk][3]);
          pa[2] = xb::pack_f16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          pa[3] = xb::pack_f16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        } else {
          pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < KSTEPS; ++dp) {
          if constexpr (F32) {
            // keys 2t4, 2t4 + 1 (+ 8) of dim g of each 8-wide output tile, split
            constexpr int VS = D + 4;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float* c0 = &sm.v[buf][kk * 16 + 2 * t4][dp * 16 + 8 * j + g];
              uint32_t h0, l0, h1, l1;
              xb::split_bf16(c0[0], c0[VS], h0, l0);
              xb::split_bf16(c0[8 * VS], c0[9 * VS], h1, l1);
              xb::mma_bf16(o[2 * dp + j], pa, h0, h1);
              xb::mma_bf16(o[2 * dp + j], pa, l0, l1);
              xb::mma_bf16(o[2 * dp + j], pl, h0, h1);
            }
          } else {
            // d 16dp.. : (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7, d 8-15), (8-15, 8-15)
            uint32_t bv[4];
            xb::ldmatrix_x4_trans(bv, &sm.v[buf][kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)]
                                               [dp * 16 + ((lane >> 4) << 3)]);
            if constexpr (F16) {
              xb::mma_f16(o[2 * dp], pa, bv[0], bv[1]);
              xb::mma_f16(o[2 * dp + 1], pa, bv[2], bv[3]);
            } else {
              xb::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
              xb::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // tile `it` is consumed: its buffer's other half may be written
    if constexpr (INT8) {
      if (more) store_tile(buf ^ 1);
    } else if constexpr (NBUF == 1) {
      if (more) queue_tile(kb + kBK, 0);
    }
  }

  // 1 / sum per query; a query that saw nothing (padding) gets 0.  The tile
  // returns through the warp's own rows of sm.q.
  __syncwarp();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_r[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int dt = 0; dt < 2 * KSTEPS; ++dt)
      *reinterpret_cast<uint32_t*>(&sm.q[warp * kRows + g + 8 * half][dt * 8 + 2 * t4]) =
          pack_bf16(o[dt][2 * half] * inv, o[dt][2 * half + 1] * inv);
  }
  __syncwarp();
  for (int idx = lane; idx < kRows * (D / 8); idx += 32) {
    const int r = idx / (D / 8), c = idx - r * (D / 8);
    const int t = t0 + warp * kRows + r;
    if (t < T)
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(n) * T + t) * H + h) * D + c * 8) =
          *reinterpret_cast<const uint4*>(&sm.q[warp * kRows + r][c * 8]);
  }
}

template <int DPL, int KV, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* positions, const void* slot_ids, const void* table, void* out, int N,
           int T, int H, int Hkv, int B, int S, int psz, int n_pages, int window, float scale,
           cudaStream_t st) {
  constexpr int D = DPL * 32;
  constexpr int smem = static_cast<int>(sizeof(typename Tiles<KV, D>::Layout));
  auto kernel = prefill_attention_kernel<DPL, KV, PAGED>;
  // above 48 KB shared memory is dynamic and has to be asked for
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTQ - 1) / kTQ, H, N);
  kernel<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(positions),
      static_cast<const int*>(slot_ids), static_cast<const int*>(table),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, B, S, psz, n_pages, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int KV, bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* positions, const void* slot_ids, const void* table, void* out, int N,
             int T, int H, int Hkv, int B, int S, int psz, int n_pages, int D, int window,
             float scale, void* stream) {
  constexpr bool INT8 = KV == xb::kKvInt8;
  if (N == 0 || T == 0) return 0;
  if (H % Hkv || (INT8 && S % 4)) return static_cast<int>(cudaErrorInvalidValue);
  if (PAGED && (psz <= 0 || n_pages <= 0 || S % psz || (INT8 && psz % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<2, KV, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T, H,
                                    Hkv, B, S, psz, n_pages, window, scale, st);
    case 128:
      return launch<4, KV, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T, H,
                                    Hkv, B, S, psz, n_pages, window, scale, st);
    case 256:
      return launch<8, KV, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T, H,
                                    Hkv, B, S, psz, n_pages, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

template <bool PAGED>
int by_form(int dtype, const void* q, const void* k, const void* v, const void* ks,
            const void* vs, const void* positions, const void* slot_ids, const void* table,
            void* out, int N, int T, int H, int Hkv, int B, int S, int psz, int n_pages, int D,
            int window, float scale, void* stream) {
  const int form = ks != nullptr ? xb::kKvInt8 : dtype;
  switch (form) {
    case xb::kKvInt8:
      return dispatch<xb::kKvInt8, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N,
                                          T, H, Hkv, B, S, psz, n_pages, D, window, scale, stream);
    case xb::kKvBf16:
      return dispatch<xb::kKvBf16, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N,
                                          T, H, Hkv, B, S, psz, n_pages, D, window, scale, stream);
    case xb::kKvF16:
      return dispatch<xb::kKvF16, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T,
                                         H, Hkv, B, S, psz, n_pages, D, window, scale, stream);
    case xb::kKvF32:
      return dispatch<xb::kKvF32, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T,
                                         H, Hkv, B, S, psz, n_pages, D, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, out [N, T, H, D] bf16; k/v of one layer; positions int [N, T]; slot_ids
// int [N]; window 0 = none.  Returns cudaErrorInvalidValue (1) for a shape it
// does not take.  With ks == nullptr the cache is rows [B, Hkv, S, D] of
// dtype 0 (bf16), 1 (fp16) or 2 (f32); otherwise int8 words [B, Hkv, S/4, D]
// with scales ks/vs [B, 4, Hkv, S/4] (dtype ignored).
extern "C" int xb_prefill_attention(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* positions,
                                    const void* slot_ids, void* out, int N, int T, int H,
                                    int Hkv, int B, int S, int D, int window, int dtype,
                                    float scale, void* stream) {
  return by_form<false>(dtype, q, k, v, ks, vs, positions, slot_ids, nullptr, out, N, T, H, Hkv,
                        B, S, S, B, D, window, scale, stream);
}

// The paged form: k/v are pools [n_pages, Hkv, psz, D] of rows of dtype, or
// with ks/vs word pools [n_pages, Hkv, psz/4, D] and scale pools
// [n_pages, 4, Hkv, psz/4]; table int [B, P], slot_ids choose its rows; a slot
// holds P * psz positions.
extern "C" int xb_prefill_attention_paged(const void* q, const void* k, const void* v,
                                          const void* ks, const void* vs,
                                          const void* positions, const void* slot_ids,
                                          const void* table, void* out, int N, int T, int H,
                                          int Hkv, int B, int P, int psz, int n_pages, int D,
                                          int window, int dtype, float scale, void* stream) {
  return by_form<true>(dtype, q, k, v, ks, vs, positions, slot_ids, table, out, N, T, H, Hkv, B,
                       P * psz, psz, n_pages, D, window, scale, stream);
}
