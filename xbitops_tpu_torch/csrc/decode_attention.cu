// Decode attention with the KV append fused in: one query token per slot
// against the head-major cache of one layer, out [B, H, D], after the slot's
// new k/v row has been written at positions[b].  One launch a layer does all
// of it: the write, the attention and the combine of the splits.
//
// Replaces the Pallas kernel xbitops_tpu/kernels/decode_attention.py
// _kernel_v2 (decode_attention.py:176, wrapper _decode_attention_v2 :728)
// with kv_new, which writes the new row into the aliased cache inside the
// same kernel, and _kernel (:80), entry decode_attention (:925).  The
// append kernels (csrc/kv_append.cu) stay for the one-row writes of a step
// that attends eagerly, as the TPU package keeps its kv_append kernels as
// the fallback.
//
// Cache forms: dense rows k/v [B, Hkv, S, D] of bf16, fp16 or f32; the
// packed int8 cache, words [B, Hkv, S/4, D] int32 (byte j of word w =
// position 4w + j, stored as value + 128) with bf16 scales [B, 4, Hkv, S/4];
// and the paged form of each,
// pools [n_pages, Hkv, psz(/4), D] (scales [n_pages, 4, Hkv, psz/4]) where
// position p of slot b lies in pool page table[b, p / psz] at row p % psz
// (the linear cache is the case of one page of S rows a slot).
//
// What it computes, for each slot b:
// 1. the append: with k_new, row positions[b] gets k_new[b], v_new[b] (int8:
//    byte pos % 4 of each (head, dim) word of word row pos / 4, the other
//    three bytes kept, and the position's two scales, rounded to bf16).  A
//    position outside [0, S), or one whose table entry is not a page of the
//    pool, writes nothing;
// 2. softmax(q k^T / sqrt(D)) v over positions [max(0, len - window), len),
//    len = lengths[b] clamped to [0, S], window 0 = none; query head h*rep + r
//    reads kv head h (rep <= 8); a slot with len 0 gets zeros.
//
// What bounds it on an H100: the bytes of the live rows (B * Hkv * len * D *
// 2 for bf16, about half for int8), far below the tensor-core line.  The
// design keeps enough of them in flight:
// - split-KV: grid (splits, Hkv, B), a block takes one kv head of one slot
//   over split_len (256) positions, in tiles of 64 positions;
// - a tile of k and v (bf16: 16 KB each at D = 128) streams into shared
//   memory through a ring of 3 stages (int8: 4 stages of 8 KB each) by
//   cp.async, 16 bytes a copy, so up to ~200 KB are in flight an SM.  The
//   paged form looks the page up once a tile where pages hold whole tiles,
//   else once a row;
// - each of the four warps scores its 16 positions of a tile at once on the
//   tensor cores, transposed: the k rows are the 16-row A operand and the
//   rep query heads the 8 columns of B (mma.sync.m16n8k16, f32 sums), then
//   takes one maximum and one rescale for the 16 rows, not two expf and a
//   shuffle tree a row.  p v runs transposed too: v^T (ldmatrix.trans) times
//   p^T, whose fragment movmatrix makes from the score fragment in registers;
// - int8: the words go to shared memory as they are and unpack in registers,
//   byte - 128 exact in bf16; the k scale multiplies the score and the v
//   scale is folded into p before it is rounded, so no dequantized row is
//   ever formed.  A scale comes in by a 4-byte cp.async of the word that
//   holds it;
// - the four warps' (max, sum, output) merge through shared memory; then the
//   block writes its split's partial result to a workspace, takes a ticket
//   from the (slot, kv head)'s counter, and the block that takes the last
//   ticket combines the live splits in split order (the result does not
//   depend on which block finished first) and sets the counter back to 0.
//   A slot with one live split writes its output directly.
// p is rounded to bf16 before p v (the plain version keeps f32 p; abs 2e-2).
//
// The fp16 and f32 caches (the JAX package's KVCache.init(dtype=); q and the
// output stay bf16, as the model's activations are).  fp16: the same kernel
// on the fp16 tensor cores (mma.sync ...f16.f16, f32 sums): q is converted to
// fp16, exactly within fp16's range, and p is rounded to fp16.  f32: the form
// must not round k or v to bf16 (that alone would cost ~1e-2), and TF32
// would keep 11 bits.  Each f32 operand is split in registers into a bf16
// high part and a bf16 low part (hi + lo holds 16 significant bits), and the
// bf16 tensor cores take the pieces: q k^T = q (k_hi + k_lo), two products
// (q is bf16, exact), and p v = p_hi v_hi + p_hi v_lo + p_lo v_hi, three,
// the dropped p_lo v_lo below 2^-17 of the result.  The f32 tiles are read
// from shared memory by plain loads in the fragments' order (k rows D + 8
// floats apart, v rows D + 4, so that neither load meets a bank conflict) in
// place of ldmatrix.  A tile of k and v takes twice the bytes (34 KB each at
// D = 128): the ring keeps 3 stages at D <= 128 (201 KB, one block an SM,
// the same ~137 KB in flight as two bf16 blocks) and one at D = 256, whose
// stage alone is 131 KB.  The block that writes a new row converts it from
// bf16 (or takes it in the cache's type) as it stores it, and its tile takes
// the converted row by a plain store to shared memory in place of cp.async.
//
// The append, inside: the block whose split holds positions[b] writes the
// row.  bf16: it stores the new row at the start, and its tile takes that row
// from k_new/v_new, not from the cache.  int8: the tile pass reads the word
// row anyway; it merges the new byte into it on the way to shared memory and
// stores the merged words, and the tile takes the new scale likewise.  A
// split holds whole words (split_len % 4 == 0), so no other block of the slot
// reads a word that this launch writes.  Where the new position is not
// attended (outside [lo, len)), the block writes it alone at the start.
//
// Which outputs are defined: a slot whose attended positions all lie in
// pages of its own.  A table entry is an address: it is clamped into
// [0, n_pages) before a read, so an inactive slot (a row of -1, length S)
// reads page 0 and faults nothing; but page 0 may belong to another slot,
// whose block may be writing its new row there in the same launch, so that
// slot's output depends on the order of the two and is not defined (it is
// never used).  The cache bytes written are always defined.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kvtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;                   // positions a tile
constexpr int kRowsW = kBK / kWarps;      // positions a warp a tile: one m16 tile
constexpr float kNegInf = -1e30f;
constexpr int kLen64 = 1, kPos64 = 2, kNewScaleF32 = 4;  // Args::flags
static_assert(kThreads == 2 * kBK, "an int8 tile's scales: one a thread");

struct Args {
  const __nv_bfloat16* q;  // [B, H, D]
  void* k;                 // bf16, fp16 or f32 rows, or int32 words, of one layer
  void* v;
  __nv_bfloat16* ks;       // int8: scales of one layer; else null
  __nv_bfloat16* vs;
  const void* lengths;     // int32 or int64 [B]
  const void* positions;   // int32 or int64 [B]; null without an append
  const int* table;        // [B, S / psz], or null: the linear cache
  const void* k_new;       // [B, Hkv, D] bf16 (int8: int32 biased bytes); null: no
                           // append
  const void* v_new;
  const void* ks_new;      // int8: f32 or bf16 [B, Hkv]
  const void* vs_new;
  float* part;             // workspace: [B, Hkv, n_split, rep, D] outputs, then max, sum
  int* counters;           // [B, Hkv], all 0 at the call and after it
  __nv_bfloat16* out;      // [B, H, D]
  int B, H, Hkv, rep, S, psz, n_pages, n_split, split_len, window, flags;
  float scale;
};

// Dense rows of type T.  16-bit rows lie 16 bytes apart in the banks:
// conflict-free ldmatrix.  f32: k rows D + 8 floats apart (the 8-byte loads of
// a half-warp, rows g and columns 2t4, cover 32 banks once) and v rows D + 4
// (the 4-byte loads of a warp, rows 2t4 and columns g, likewise).
template <int D, typename T>
struct alignas(16) StageDense {
  T k[kBK][D + 8];
  T v[kBK][D + (sizeof(T) == 4 ? 4 : 8)];
};

template <int D>
struct alignas(16) StageInt8 {
  uint32_t k[kBK / 4][D + 8];  // word rows: four positions each
  uint32_t v[kBK / 4][D + 8];
  uint32_t sc[2][kBK];         // k, v scale of each position: the 4-byte word that holds it
  uint8_t hi[2][kBK];          // 1: the scale is that word's upper half
};

template <int D, int KV>
struct Ring {
  static constexpr int kStages = KV == xb::kKvInt8  ? (D <= 128 ? 4 : 3)
                                 : KV == xb::kKvF32 ? (D <= 128 ? 3 : 1)
                                                    : (D <= 128 ? 3 : 2);
  using Stage = typename std::conditional<KV == xb::kKvInt8, StageInt8<D>,
                                          StageDense<D, typename xb::KvElem<KV>::T>>::type;
};

// The ring, and after the tiles the four warps' states, which reuse it.
template <int D, int REP, int KV>
union Smem {
  typename Ring<D, KV>::Stage st[Ring<D, KV>::kStages];
  struct {
    float o[kWarps][REP][D];
    float m[kWarps][REP];
    float l[kWarps][REP];
  } mg;
};

__device__ __forceinline__ long long load_index(const void* p, int i, bool is64) {
  return is64 ? static_cast<const long long*>(p)[i] : static_cast<const int*>(p)[i];
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint16_t new_scale_bits(const void* p, size_t i, bool f32) {
  const __nv_bfloat16 s = f32 ? __float2bfloat16(static_cast<const float*>(p)[i])
                              : static_cast<const __nv_bfloat16*>(p)[i];
  return *reinterpret_cast<const uint16_t*>(&s);
}

// Byte j of each of the four words `w` replaced by the low byte of `n`.
__device__ __forceinline__ uint4 merge_byte(uint4 w, int4 n, int j) {
  const int sh = 8 * j;
  const uint32_t keep = ~(0xffu << sh);
  w.x = (w.x & keep) | ((static_cast<uint32_t>(n.x) & 0xffu) << sh);
  w.y = (w.y & keep) | ((static_cast<uint32_t>(n.y) & 0xffu) << sh);
  w.z = (w.z & keep) | ((static_cast<uint32_t>(n.z) & 0xffu) << sh);
  w.w = (w.w & keep) | ((static_cast<uint32_t>(n.w) & 0xffu) << sh);
  return w;
}

// D: head_dim.  REP: the largest GQA ratio the build takes (1, 2, 4, 8); the
// call's rep <= REP.  KV: the cache form (xb::KvForm): dense rows of bf16, fp16
// or f32, or packed words with scales.  PAGED: k/v are page pools found
// through the table.
template <int D, int REP, int KV, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  constexpr bool INT8 = KV == xb::kKvInt8, F16 = KV == xb::kKvF16, F32 = KV == xb::kKvF32;
  using T = typename xb::KvElem<KV>::T;  // a dense row's element
  constexpr int EPC = 16 / sizeof(T);    // dense values in 16 bytes
  constexpr int KS = D / 16;  // k16 steps of q k^T, and m16 tiles of the output
  constexpr int ST = Ring<D, KV>::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D, REP, KV>& sm = *reinterpret_cast<Smem<D, REP, KV>*>(smem_raw);
  __shared__ int s_last;

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int S = a.S, psz = a.psz, rep = a.rep, Hkv = a.Hkv;
  const int len = static_cast<int>(
      min(max(load_index(a.lengths, b, a.flags & kLen64), 0LL), static_cast<long long>(S)));
  const int lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int split0 = sp * a.split_len;
  const int s0 = max(split0, lo), s1 = min(split0 + a.split_len, len);
  const int* table_row = PAGED ? a.table + static_cast<size_t>(b) * (S / psz) : nullptr;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;

  // (block of psz rows, row in it) of position p: a page of the pool, clamped,
  // or the slot itself
  auto locate = [&](int p, size_t* blk, int* row) {
    if constexpr (PAGED) {
      const int pi = p / psz;
      *blk = static_cast<size_t>(min(max(table_row[pi], 0), a.n_pages - 1));
      *row = p - pi * psz;
    } else {
      *blk = static_cast<size_t>(b);
      *row = p;
    }
  };

  // The append: pos >= 0 when this block writes row pos at (pos_blk, pos_row).
  int pos = -1, pos_row = 0;
  size_t pos_blk = 0;
  if (a.k_new != nullptr) {
    const long long p = load_index(a.positions, b, a.flags & kPos64);
    if (p >= split0 && p < split0 + a.split_len && p < S) {
      if constexpr (PAGED) {
        const int e = table_row[p / psz];
        if (e >= 0 && e < a.n_pages) {
          pos = static_cast<int>(p);
          pos_blk = static_cast<size_t>(e);
          pos_row = pos % psz;
        }
      } else {
        pos = static_cast<int>(p);
        pos_blk = static_cast<size_t>(b);
        pos_row = pos;
      }
    }
  }
  const bool attended = pos >= s0 && pos < s1;
  if (pos >= 0 && (!INT8 || !attended)) {
    // written here; an attended int8 row is written by its tile's pass
    if constexpr (INT8) {
      const size_t at = ((pos_blk * Hkv + h) * (psz / 4) + pos_row / 4) * D;
      for (int i = tid; i < 2 * (D / 4); i += kThreads) {
        const int which = i / (D / 4), c = i - which * (D / 4);
        uint32_t* w = static_cast<uint32_t*>(which ? a.v : a.k) + at + 4 * c;
        const int4 n = *reinterpret_cast<const int4*>(
            static_cast<const int*>(which ? a.v_new : a.k_new) + bh * D + 4 * c);
        *reinterpret_cast<uint4*>(w) = merge_byte(*reinterpret_cast<const uint4*>(w), n, pos_row & 3);
      }
      if (tid < 2) {
        const size_t at_s = ((pos_blk * 4 + (pos_row & 3)) * Hkv + h) * (psz / 4) + pos_row / 4;
        reinterpret_cast<uint16_t*>(tid ? a.vs : a.ks)[at_s] =
            new_scale_bits(tid ? a.vs_new : a.ks_new, bh, a.flags & kNewScaleF32);
      }
    } else {
      const size_t at = ((pos_blk * Hkv + h) * psz + pos_row) * D;
      for (int i = tid; i < 2 * (D / EPC); i += kThreads) {
        const int which = i / (D / EPC), c = i - which * (D / EPC);
        *reinterpret_cast<uint4*>(static_cast<T*>(which ? a.v : a.k) + at + EPC * c) =
            xb::row_chunk<T>(
                static_cast<const __nv_bfloat16*>(which ? a.v_new : a.k_new), bh * D + EPC * c);
      }
    }
  }

  // The live splits of the slot: [first, first + n_live)
  const int first = lo / a.split_len;
  const int n_live = len > lo ? (len - 1) / a.split_len - first + 1 : 0;
  if (s0 >= s1) {  // no live position in this split
    if (n_live == 0 && sp == 0)
      for (int i = tid; i < rep * D; i += kThreads)
        a.out[(static_cast<size_t>(b) * a.H + h * rep) * D + i] = __float2bfloat16(0.f);
    return;
  }

  // q as the B operand: lane 4g + t4 holds dims 2t4, 2t4 + 1 (and + 8) of head g
  uint32_t qb[KS][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    qb[s][0] = qb[s][1] = 0u;
    if (g < rep) {
      const __nv_bfloat16* qr = a.q + (static_cast<size_t>(b) * a.H + h * rep + g) * D + 16 * s + 2 * t4;
      qb[s][0] = *reinterpret_cast<const uint32_t*>(qr);
      qb[s][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
      if constexpr (F16) {  // the fp16 products take q as fp16
        qb[s][0] = xb::bf162_to_f162(qb[s][0]);
        qb[s][1] = xb::bf162_to_f162(qb[s][1]);
      }
    }
  }

  const int t_begin = s0 - s0 % kBK;  // tiles start on a multiple of 64
  const int n_tiles = (s1 - t_begin + kBK - 1) / kBK;
  const bool tile_page = !PAGED || psz % kBK == 0;  // a tile lies in one page

  // Queue the copies of tile t into its stage (positions outside [s0, s1) are
  // zeros), and commit a group even when there is no tile t.
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int tb = t_begin + t * kBK;
      auto& st = sm.st[t % ST];
      size_t tblk = 0;
      int trow = 0;
      if (tile_page) locate(tb, &tblk, &trow);  // the page, once a tile
      if constexpr (INT8) {
        const uint32_t* kw = static_cast<const uint32_t*>(a.k);
        const uint32_t* vw = static_cast<const uint32_t*>(a.v);
        for (int idx = tid; idx < (kBK / 4) * (D / 4); idx += kThreads) {
          const int wr = idx / (D / 4), c = idx - wr * (D / 4);
          const int p0 = tb + 4 * wr;  // a word row: positions p0 .. p0 + 3
          const bool valid = p0 + 3 >= s0 && p0 < s1;
          size_t at = 0;
          if (valid) {
            size_t blk = tblk;
            int row = trow + 4 * wr;
            if (!tile_page) locate(p0, &blk, &row);
            at = ((blk * Hkv + h) * (psz / 4) + row / 4) * D + 4 * c;
          }
          if (attended && p0 == (pos & ~3)) {
            // the word row that takes the new byte: merged on its way in
            const size_t n_at = bh * D + 4 * c;
            const uint4 km = merge_byte(*reinterpret_cast<const uint4*>(kw + at),
                                        *reinterpret_cast<const int4*>(
                                            static_cast<const int*>(a.k_new) + n_at), pos & 3);
            const uint4 vm = merge_byte(*reinterpret_cast<const uint4*>(vw + at),
                                        *reinterpret_cast<const int4*>(
                                            static_cast<const int*>(a.v_new) + n_at), pos & 3);
            *reinterpret_cast<uint4*>(&st.k[wr][4 * c]) = km;
            *reinterpret_cast<uint4*>(&st.v[wr][4 * c]) = vm;
            *reinterpret_cast<uint4*>(static_cast<uint32_t*>(a.k) + at) = km;
            *reinterpret_cast<uint4*>(static_cast<uint32_t*>(a.v) + at) = vm;
          } else {
            xb::cp_async_16(&st.k[wr][4 * c], kw + at, valid);
            xb::cp_async_16(&st.v[wr][4 * c], vw + at, valid);
          }
        }
        // one scale a thread: k for the first 64, v for the rest
        const int which = tid / kBK, i = tid - which * kBK, p = tb + i;
        const bool valid = p >= s0 && p < s1;
        if (valid && p == pos) {
          const uint16_t bits = new_scale_bits(which ? a.vs_new : a.ks_new, bh,
                                               a.flags & kNewScaleF32);
          st.sc[which][i] = bits;
          st.hi[which][i] = 0;
          const size_t at_s = ((pos_blk * 4 + (pos_row & 3)) * Hkv + h) * (psz / 4) + pos_row / 4;
          reinterpret_cast<uint16_t*>(which ? a.vs : a.ks)[at_s] = bits;
        } else {
          size_t at_s = 0;
          if (valid) {
            size_t blk = tblk;
            int row = trow + i;
            if (!tile_page) locate(p, &blk, &row);
            at_s = ((blk * 4 + (row & 3)) * Hkv + h) * (psz / 4) + row / 4;
          }
          const uintptr_t src = reinterpret_cast<uintptr_t>((which ? a.vs : a.ks) + at_s);
          xb::cp_async_4(&st.sc[which][i], reinterpret_cast<const void*>(src & ~uintptr_t{3}),
                         valid);
          st.hi[which][i] = valid ? static_cast<uint8_t>((src >> 1) & 1) : 0;
        }
      } else {
        const T* kc = static_cast<const T*>(a.k);
        const T* vc = static_cast<const T*>(a.v);
        for (int idx = tid; idx < kBK * (D / EPC); idx += kThreads) {
          const int r = idx / (D / EPC), c = idx - r * (D / EPC);
          const int p = tb + r;
          const bool valid = p >= s0 && p < s1;
          if constexpr (KV != xb::kKvBf16) {
            if (valid && p == pos) {  // the new row, converted from the inputs
              const size_t n_at = bh * D + EPC * c;
              *reinterpret_cast<uint4*>(&st.k[r][EPC * c]) =
                  xb::row_chunk<T>(static_cast<const __nv_bfloat16*>(a.k_new), n_at);
              *reinterpret_cast<uint4*>(&st.v[r][EPC * c]) =
                  xb::row_chunk<T>(static_cast<const __nv_bfloat16*>(a.v_new), n_at);
              continue;
            }
          }
          const T *ksrc = kc, *vsrc = vc;
          if (valid && p == pos) {  // bf16: the new row, from the inputs
            ksrc = static_cast<const T*>(a.k_new) + bh * D + EPC * c;
            vsrc = static_cast<const T*>(a.v_new) + bh * D + EPC * c;
          } else if (valid) {
            size_t blk = tblk;
            int row = trow + r;
            if (!tile_page) locate(p, &blk, &row);
            const size_t at = ((blk * Hkv + h) * psz + row) * D + EPC * c;
            ksrc = kc + at;
            vsrc = vc + at;
          }
          xb::cp_async_16(&st.k[r][EPC * c], ksrc, valid);
          xb::cp_async_16(&st.v[r][EPC * c], vsrc, valid);
        }
      }
    }
    xb::cp_async_commit();
  };

  // Per lane: the online softmax of heads 2t4 and 2t4 + 1 over the warp's
  // positions, and o^T [D x 8 heads] as KS m16 tiles (c0, c2: head 2t4).
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float o[KS][4];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;

  // tiles queued ahead: ST - 1, or with one stage (f32 at D = 256) the first
  constexpr int kAhead = ST > 1 ? ST - 1 : 1;
#pragma unroll
  for (int t = 0; t < kAhead; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    if constexpr (ST == 1) {
      if (t > 0) {
        __syncthreads();  // every warp is done with tile t - 1: its stage is free
        issue(t);
      }
      xb::cp_async_wait<0>();
    } else {
      xb::cp_async_wait<ST - 2>();
    }
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if constexpr (ST > 1) issue(t + ST - 1);
    const int wb = t_begin + t * kBK + warp * kRowsW;  // the warp's first position
    if (wb + kRowsW <= s0 || wb >= s1) continue;       // warp-uniform: nothing live
    const auto& st = sm.st[t % ST];

    // scores [16 positions x 8 heads] = k q^T
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t af[4];
      if constexpr (INT8) {
        // position g: word row g / 4, byte g % 4; position g + 8: two word rows on
        const uint32_t* r0 = &st.k[4 * warp + (g >> 2)][16 * s + 2 * t4];
        const uint32_t* r1 = r0 + 2 * (D + 8);
        const uint2 x0 = *reinterpret_cast<const uint2*>(r0);
        const uint2 x1 = *reinterpret_cast<const uint2*>(r1);
        const uint2 x2 = *reinterpret_cast<const uint2*>(r0 + 8);
        const uint2 x3 = *reinterpret_cast<const uint2*>(r1 + 8);
        af[0] = xb::unpack_pair(x0.x, x0.y, g & 3);
        af[1] = xb::unpack_pair(x1.x, x1.y, g & 3);
        af[2] = xb::unpack_pair(x2.x, x2.y, g & 3);
        af[3] = xb::unpack_pair(x3.x, x3.y, g & 3);
      } else if constexpr (F32) {
        // rows g, g + 8 and columns 2t4 (+ 8) as ldmatrix would give them, split
        const float* r0 = &st.k[warp * kRowsW + g][16 * s + 2 * t4];
        const float* r1 = r0 + 8 * (D + 8);
        const float2 x0 = *reinterpret_cast<const float2*>(r0);
        const float2 x1 = *reinterpret_cast<const float2*>(r1);
        const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(r1 + 8);
        uint32_t lo[4];
        xb::split_bf16(x0.x, x0.y, af[0], lo[0]);
        xb::split_bf16(x1.x, x1.y, af[1], lo[1]);
        xb::split_bf16(x2.x, x2.y, af[2], lo[2]);
        xb::split_bf16(x3.x, x3.y, af[3], lo[3]);
        xb::mma_bf16(sc, lo, qb[s][0], qb[s][1]);
      } else {
        xb::ldmatrix_x4(af, &st.k[warp * kRowsW + (lane & 15)][16 * s + (lane >> 4) * 8]);
      }
      if constexpr (F16)
        xb::mma_f16(sc, af, qb[s][0], qb[s][1]);
      else
        xb::mma_bf16(sc, af, qb[s][0], qb[s][1]);
    }

    // mask, one maximum and one rescale for the 16 positions: sc[e] is
    // position g + 8 * (e >> 1), head 2t4 + (e & 1)
    float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
    if constexpr (INT8) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = warp * kRowsW + g + 8 * hf;
        ksc[hf] = bf16_bits_to_float(st.hi[0][i] ? st.sc[0][i] >> 16 : st.sc[0][i] & 0xffffu);
        vsc[hf] = bf16_bits_to_float(st.hi[1][i] ? st.sc[1][i] >> 16 : st.sc[1][i] & 0xffffu);
      }
    }
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = wb + g + 8 * (e >> 1);
      x[e] = p >= s0 && p < s1 ? sc[e] * a.scale * ksc[e >> 1] : kNegInf;
    }
    float mx[2] = {fmaxf(x[0], x[2]), fmaxf(x[1], x[3])};
    float alpha[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx[n] = fmaxf(mx[n], __shfl_xor_sync(0xffffffffu, mx[n], off));
      const float m_new = fmaxf(m_r[n], mx[n]);
      alpha[n] = __expf(m_r[n] - m_new);
      m_r[n] = m_new;
    }
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = x[e] > 0.5f * kNegInf ? __expf(x[e] - m_r[e & 1]) : 0.f;
      x[e] = pe;
      pv[e] = pe * vsc[e >> 1];  // int8: the v scale folded into p
    }
    l_r[0] = l_r[0] * alpha[0] + x[0] + x[2];  // this lane's positions; summed over g at the end
    l_r[1] = l_r[1] * alpha[1] + x[1] + x[3];

    // o^T += v^T p^T: p^T as the B operand, transposed from the score fragment
    // (f32: its high part b0, b1 and its low part b0l, b1l)
    uint32_t b0, b1, b0l = 0u, b1l = 0u;
    if constexpr (F16) {
      b0 = xb::movmatrix_trans(xb::pack_f16(pv[0], pv[1]));
      b1 = xb::movmatrix_trans(xb::pack_f16(pv[2], pv[3]));
    } else if constexpr (F32) {
      uint32_t h0, l0, h1, l1;
      xb::split_bf16(pv[0], pv[1], h0, l0);
      xb::split_bf16(pv[2], pv[3], h1, l1);
      b0 = xb::movmatrix_trans(h0);
      b1 = xb::movmatrix_trans(h1);
      b0l = xb::movmatrix_trans(l0);
      b1l = xb::movmatrix_trans(l1);
    } else {
      b0 = xb::movmatrix_trans(xb::pack_bf16(pv[0], pv[1]));
      b1 = xb::movmatrix_trans(xb::pack_bf16(pv[2], pv[3]));
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      o[mt][0] *= alpha[0];
      o[mt][1] *= alpha[1];
      o[mt][2] *= alpha[0];
      o[mt][3] *= alpha[1];
      uint32_t av[4];
      if constexpr (INT8) {
        // dim g (+ 8) of positions 2t4, 2t4 + 1 (+ 8): two bytes of one word
        const uint32_t* r0 = &st.v[4 * warp + (t4 >> 1)][16 * mt + g];
        const uint32_t* r1 = r0 + 2 * (D + 8);
        const uint32_t sel = (t4 & 1) ? 0x0302u : 0x0100u;  // bytes 2(t4&1), +1 -> bits 0, 16
        av[0] = xb::biased_bytes_to_bf162(__byte_perm(r0[0], 0u, sel));
        av[1] = xb::biased_bytes_to_bf162(__byte_perm(r0[8], 0u, sel));
        av[2] = xb::biased_bytes_to_bf162(__byte_perm(r1[0], 0u, sel));
        av[3] = xb::biased_bytes_to_bf162(__byte_perm(r1[8], 0u, sel));
      } else if constexpr (F32) {
        // dim g (+ 8) of positions 2t4, 2t4 + 1 (+ 8), as ldmatrix.trans would give them
        constexpr int VS = D + 4;
        const float* c0 = &st.v[warp * kRowsW + 2 * t4][16 * mt + g];
        uint32_t lo[4];
        xb::split_bf16(c0[0], c0[VS], av[0], lo[0]);
        xb::split_bf16(c0[8], c0[VS + 8], av[1], lo[1]);
        xb::split_bf16(c0[8 * VS], c0[9 * VS], av[2], lo[2]);
        xb::split_bf16(c0[8 * VS + 8], c0[9 * VS + 8], av[3], lo[3]);
        xb::mma_bf16(o[mt], lo, b0, b1);    // v_lo p_hi
        xb::mma_bf16(o[mt], av, b0l, b1l);  // v_hi p_lo
      } else {
        xb::ldmatrix_x4_trans(av, &st.v[warp * kRowsW + (lane & 7) + (lane >> 4) * 8]
                                       [16 * mt + ((lane >> 3) & 1) * 8]);
      }
      if constexpr (F16)
        xb::mma_f16(o[mt], av, b0, b1);
      else
        xb::mma_bf16(o[mt], av, b0, b1);
    }
  }
  xb::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps merge through it

#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) l_r[n] += __shfl_xor_sync(0xffffffffu, l_r[n], off);
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = 2 * t4 + (e & 1);
      if (head < rep) sm.mg.o[warp][head][16 * mt + g + 8 * (e >> 1)] = o[mt][e];
    }
  if (g == 0)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      if (2 * t4 + n < rep) {
        sm.mg.m[warp][2 * t4 + n] = m_r[n];
        sm.mg.l[warp][2 * t4 + n] = l_r[n];
      }
  __syncthreads();

  const size_t part_rows = static_cast<size_t>(a.B) * Hkv * a.n_split * rep;
  float* part_o = a.part;
  float* part_m = a.part + part_rows * D;
  float* part_l = part_m + part_rows;
  __nv_bfloat16* out = a.out + (static_cast<size_t>(b) * a.H + h * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.mg.m[w][r]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(sm.mg.m[w][r] - mx);
      l += sm.mg.l[w][r] * c;
      acc += sm.mg.o[w][r][d] * c;
    }
    if (n_live == 1) {
      out[i] = __float2bfloat16(acc / l);  // l > 0: the split holds a live position
    } else {
      const size_t row = (bh * a.n_split + sp) * rep + r;
      part_o[row * D + d] = acc;
      if (d == 0) {
        part_m[row] = mx;
        part_l[row] = l;
      }
    }
  }
  if (n_live == 1) return;

  __threadfence();  // the partial result is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&a.counters[bh], 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block of the (slot, kv head): the live splits, in split order
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const size_t row0 = (bh * a.n_split + first) * rep + r;
    float mx = kNegInf;
    for (int z = 0; z < n_live; ++z) mx = fmaxf(mx, __ldcg(part_m + row0 + z * rep));
    float l = 0.f, acc = 0.f;
    for (int z = 0; z < n_live; ++z) {
      const size_t row = row0 + z * rep;
      const float c = __expf(__ldcg(part_m + row) - mx);
      l += __ldcg(part_l + row) * c;
      acc += __ldcg(part_o + row * D + d) * c;
    }
    out[i] = __float2bfloat16(acc / l);
  }
  if (tid == 0) a.counters[bh] = 0;  // ready for the next call
}

template <int D, int REP, int KV, bool PAGED>
int launch(const Args& a, cudaStream_t st) {
  auto kernel = decode_attention_kernel<D, REP, KV, PAGED>;
  const int smem = static_cast<int>(sizeof(Smem<D, REP, KV>));
  // above 48 KB shared memory is dynamic and has to be asked for
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.n_split, a.Hkv, a.B);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int KV, bool PAGED>
int by_rep(const Args& a, cudaStream_t st) {
  if (a.rep == 1) return launch<D, 1, KV, PAGED>(a, st);
  if (a.rep == 2) return launch<D, 2, KV, PAGED>(a, st);
  if (a.rep <= 4) return launch<D, 4, KV, PAGED>(a, st);
  return launch<D, 8, KV, PAGED>(a, st);
}

template <int KV, bool PAGED>
int by_dim(const Args& a, int D, cudaStream_t st) {
  switch (D) {
    case 64:
      return by_rep<64, KV, PAGED>(a, st);
    case 128:
      return by_rep<128, KV, PAGED>(a, st);
    case 256:
      return by_rep<256, KV, PAGED>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int KV>
int by_table(const Args& a, int D, bool paged, cudaStream_t st) {
  return paged ? by_dim<KV, true>(a, D, st) : by_dim<KV, false>(a, D, st);
}

}  // namespace

// q, out [B, H, D] bf16; k, v one layer of the cache: rows of dtype 0 (bf16),
// 1 (fp16) or 2 (f32), or with ks/vs int32 words and their bf16 scales (dtype
// ignored); table null (linear: psz = S, n_pages = B) or int [B, S / psz]
// (k/v/ks/vs pools of n_pages pages).  lengths, positions int32 or int64 [B]
// (flags 1, 2).  k_new null: no append; else [B, Hkv, D] bf16 rows, cast to
// the cache's type (int8: int32 biased bytes, and ks_new/vs_new
// [B, Hkv] scales, f32 with flag 4, else bf16); positions [B] then.  part is
// a workspace of B * H * n_split * (D + 2) floats, counters B * Hkv ints, all
// 0 at the call and all 0 again when the kernel has run (calls that share
// them must be ordered, as launches on one stream are).  New rows, q and
// k_new must be 16-byte aligned.  Returns cudaErrorInvalidValue (1) for a
// shape it does not take.
extern "C" int xb_decode_attention(const void* q, void* k, void* v, void* ks, void* vs,
                                   const void* lengths, const void* positions, const void* table,
                                   const void* k_new, const void* v_new, const void* ks_new,
                                   const void* vs_new, void* part, void* counters, void* out,
                                   int B, int H, int Hkv, int S, int psz, int n_pages, int D,
                                   int n_split, int split_len, int window, int flags, int dtype,
                                   float scale, void* stream) {
  if (B == 0) return 0;
  const bool int8 = ks != nullptr, paged = table != nullptr;
  if (Hkv <= 0 || H % Hkv || H / Hkv > 8 || split_len % kBK || n_split * split_len < S ||
      psz <= 0 || S % psz || n_pages <= 0 || (int8 && psz % 4) ||
      (k_new != nullptr && (positions == nullptr || (int8 && (!ks_new || !vs_new)))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<__nv_bfloat16*>(ks);
  a.vs = static_cast<__nv_bfloat16*>(vs);
  a.lengths = lengths;
  a.positions = positions;
  a.table = static_cast<const int*>(table);
  a.k_new = k_new;
  a.v_new = v_new;
  a.ks_new = ks_new;
  a.vs_new = vs_new;
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.rep = H / Hkv;
  a.S = S;
  a.psz = psz;
  a.n_pages = n_pages;
  a.n_split = n_split;
  a.split_len = split_len;
  a.window = window;
  a.flags = flags;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8) return by_table<xb::kKvInt8>(a, D, paged, st);
  switch (dtype) {
    case xb::kKvBf16:
      return by_table<xb::kKvBf16>(a, D, paged, st);
    case xb::kKvF16:
      return by_table<xb::kKvF16>(a, D, paged, st);
    case xb::kKvF32:
      return by_table<xb::kKvF32>(a, D, paged, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
