// Chunked-prefill attention: a [N, T, H, D] chunk of queries against the
// cache rows of slots slot_ids[n] of one layer, causal by global position;
// out [N, T, H, D].  The cache is bf16 rows k/v [B, Hkv, S, D], or the packed
// int8 cache, words [B, Hkv, S/4, D] int32 (byte j of word w = position
// 4w + j, stored as value + 128) with bf16 scales [B, 4, Hkv, S/4].
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
// q-tile from L2, so it sits far above the memory line.  This first version
// does its products in f32 on the CUDA cores (67 TFLOP/s at most), not on the
// tensor cores; its design keeps those cores fed:
// - one block per (q-tile of 64 queries, query head, chunk row): blocks are
//   independent, so nothing is carried across the grid, and a block loops
//   over the key tiles of [window_lo, max position of its tile] only.  Query
//   head h reads kv head h / rep; the rep blocks of a kv head find its rows
//   in L2;
// - a key tile of 32 positions goes to shared memory as bf16: cache rows as
//   they are, int8 words unpacked in registers (logical shifts on uint32_t)
//   to byte - 128, which bf16 holds exactly.  The scales never touch the
//   tile: the score is (q . (byte - 128)) * scale * ks and the v scale is
//   folded into the probability, p * vs.  The TPU kernel's 128 * sum(q)
//   correction and 2^(-8j) field scaling avoided shifts on its vector unit
//   and are not copied;
// - each warp owns 16 queries.  For q k^T a lane holds a 4 x 4 patch of the
//   16 x 32 score tile (4 queries, 4 keys), so a value read from shared
//   memory feeds 4 FMAs; row maxima reduce over 8 lanes by shuffles; the
//   online softmax state (max, sum) stays in registers.  For p v the
//   probabilities pass through shared memory and a lane holds D/32
//   contiguous output values of all 16 queries, so v rows are read in one
//   coalesced access and a probability is a broadcast;
// - probabilities stay f32 for p v in both cache forms (the TPU kernel cast
//   them to bf16 on the dense path only).
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
// eagerly.  Here the lookup is in the tile load: a key tile of 32 positions
// may cross pages (page_size 16), so each thread finds the page of the row
// (int8: of the word, which never crosses a page) it loads, one division and
// one table read per 16-byte load (a shift when the page size is a power of
// two, as the usual 16 to 256 are); the rest of the kernel sees the same
// shared-memory tile.  The linear cache is the case of one page of S rows per
// slot.  A table entry is clamped into [0, n_pages) before use: rows of a page
// that was never given are never visible to a live query, and nothing faults.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16;           // queries per warp
constexpr int kTQ = kWarps * kRows; // queries per block
constexpr int kBK = 32;             // keys per tile
constexpr int kPStride = 40;        // floats per row of the probability tile
constexpr float kNegInf = -1e30f;

template <int D>
struct alignas(16) Smem {
  float q[kTQ][D + 4];
  __nv_bfloat16 k[kBK][D + 8];
  __nv_bfloat16 v[kBK][D];
  float p[kWarps][kRows][kPStride];
  float row[kWarps][kRows];  // per query: the rescale of this step, at the end 1 / sum
  float ksc[kBK];            // per key: softmax scale (times the k scale)
  float vsc[kBK];            // per key: the v scale
  int pos[kTQ];              // per query: its position, -1 for padding
  int hi, lo;                // largest and smallest live position of the tile
};

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// N consecutive 32-bit words in one access (p is aligned to N words).
template <int N>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&out)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "1, 2 or 4 words");
  if constexpr (N == 1) {
    out[0] = *static_cast<const uint32_t*>(p);
  } else if constexpr (N == 2) {
    const uint2 t = *static_cast<const uint2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    const uint4 t = *static_cast<const uint4*>(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  }
}

template <int N>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&in)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "1, 2 or 4 words");
  if constexpr (N == 1) {
    *static_cast<uint32_t*>(p) = in[0];
  } else if constexpr (N == 2) {
    *static_cast<uint2*>(p) = make_uint2(in[0], in[1]);
  } else {
    *static_cast<uint4*>(p) = make_uint4(in[0], in[1], in[2], in[3]);
  }
}

// byte j of four words, as bf16 values byte - 128, packed in two words
__device__ __forceinline__ void unpack_byte(const uint32_t (&w)[4], int j, uint32_t (&out)[2]) {
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = static_cast<float>(static_cast<int>((w[i] >> (8 * j)) & 0xffu) - 128);
  out[0] = pack_bf16(f[0], f[1]);
  out[1] = pack_bf16(f[2], f[3]);
}

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

// DPL: D / 32.  INT8: k/v are packed words and ks/vs their scales; otherwise
// k/v are bf16 rows and ks/vs are unused.  PAGED: k/v (and ks/vs) are pools of
// pages of psz positions found through table [B, S / psz]; otherwise psz == S.
template <int DPL, bool INT8, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int t0 = blockIdx.x * kTQ, h = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  // the q tile, as f32
  for (int idx = tid; idx < kTQ * (D / 8); idx += kWarps * 32) {
    const int r = idx / (D / 8), c = idx - r * (D / 8);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (t0 + r < T)
      load_words<4>(q + ((static_cast<size_t>(n) * T + t0 + r) * H + h) * D + c * 8, w);
    float4 a = make_float4(bf16_lo(w[0]), bf16_hi(w[0]), bf16_lo(w[1]), bf16_hi(w[1]));
    float4 b = make_float4(bf16_lo(w[2]), bf16_hi(w[2]), bf16_lo(w[3]), bf16_hi(w[3]));
    *reinterpret_cast<float4*>(&sm.q[r][c * 8]) = a;
    *reinterpret_cast<float4*>(&sm.q[r][c * 8 + 4]) = b;
  }
  __syncthreads();

  const int hi = sm.hi;
  const int lo = window > 0 ? max(sm.lo - (window - 1), 0) : 0;

  // lane (i, j) of a warp: queries i + 4a and keys j + 8c of the score tile
  const int i = lane >> 3, j = lane & 7;
  int pos_a[4];
  int warp_hi = -1;
#pragma unroll
  for (int a = 0; a < 4; ++a) pos_a[a] = sm.pos[warp * kRows + i + 4 * a];
  for (int r = 0; r < kRows; ++r) warp_hi = max(warp_hi, sm.pos[warp * kRows + r]);

  float m_a[4], l_a[4], o[kRows][DPL];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_a[a] = kNegInf;
    l_a[a] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.f;

  const int Sw = S / 4, pszw = psz / 4;
  for (int kb = hi >= 0 ? (lo / kBK) * kBK : 0; kb <= hi; kb += kBK) {
    __syncthreads();  // the tile of the step before has been used
    if constexpr (INT8) {
      const uint32_t* kw = static_cast<const uint32_t*>(k_raw);
      const uint32_t* vw = static_cast<const uint32_t*>(v_raw);
      for (int idx = tid; idx < (kBK / 4) * (D / 4); idx += kWarps * 32) {
        const int wr = idx / (D / 4), c = idx - wr * (D / 4);
        const int w = kb / 4 + wr;
        // beyond the cache: byte 128, the value 0
        uint32_t a[4] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u};
        uint32_t b[4] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u};
        if (w < Sw) {
          int wi;
          const size_t blk =
              find_block<PAGED>(w, slot, pszw, psz_shift - 2, table_row, n_pages, &wi);
          const size_t at = ((blk * Hkv + hk) * pszw + wi) * D + c * 4;
          load_words<4>(kw + at, a);
          load_words<4>(vw + at, b);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t t[2];
          unpack_byte(a, jj, t);
          store_words<2>(&sm.k[4 * wr + jj][c * 4], t);
          unpack_byte(b, jj, t);
          store_words<2>(&sm.v[4 * wr + jj][c * 4], t);
        }
      }
      if (tid < kBK) {
        const int s = kb + tid;
        float a = 0.f, b = 0.f;
        if (s < S) {
          // scales[blk, j, h, w] of position 4w + j of the block
          int si;
          const size_t blk = find_block<PAGED>(s, slot, psz, psz_shift, table_row, n_pages, &si);
          const size_t at = ((blk * 4 + (si & 3)) * Hkv + hk) * pszw + (si >> 2);
          a = __bfloat162float(ks[at]);
          b = __bfloat162float(vs[at]);
        }
        sm.ksc[tid] = a * scale;
        sm.vsc[tid] = b;
      }
    } else {
      const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k_raw);
      const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v_raw);
      for (int idx = tid; idx < kBK * (D / 8); idx += kWarps * 32) {
        const int r = idx / (D / 8), c = idx - r * (D / 8);
        uint32_t a[4] = {0u, 0u, 0u, 0u}, b[4] = {0u, 0u, 0u, 0u};
        if (kb + r < S) {
          int ri;
          const size_t blk = find_block<PAGED>(kb + r, slot, psz, psz_shift, table_row, n_pages, &ri);
          const size_t at = ((blk * Hkv + hk) * psz + ri) * D + c * 8;
          load_words<4>(kp + at, a);
          load_words<4>(vp + at, b);
        }
        store_words<4>(&sm.k[r][c * 8], a);
        store_words<4>(&sm.v[r][c * 8], b);
      }
      if (tid < kBK) sm.ksc[tid] = scale;
    }
    __syncthreads();
    if (kb > warp_hi) continue;  // no query of this warp sees the tile (warp-uniform)

    // scores: 4 queries x 4 keys a lane
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qv[a] = *reinterpret_cast<const float4*>(&sm.q[warp * kRows + i + 4 * a][d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t kk[2];
        load_words<2>(&sm.k[j + 8 * c][d], kk);
        const float k0 = bf16_lo(kk[0]), k1 = bf16_hi(kk[0]);
        const float k2 = bf16_lo(kk[1]), k3 = bf16_hi(kk[1]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float s = sc[a][c];
          s = fmaf(qv[a].x, k0, s);
          s = fmaf(qv[a].y, k1, s);
          s = fmaf(qv[a].z, k2, s);
          s = fmaf(qv[a].w, k3, s);
          sc[a][c] = s;
        }
      }
    }

    // mask by position, online softmax, probabilities to shared memory
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int p = pos_a[a];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = kb + j + 8 * c;
        const bool live = s <= p && (window <= 0 || s > p - window);
        sc[a][c] = live ? sc[a][c] * sm.ksc[j + 8 * c] : kNegInf;
        mx = fmaxf(mx, sc[a][c]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_a[a], mx);
      const float alpha = expf(m_a[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pe = sc[a][c] > 0.5f * kNegInf ? expf(sc[a][c] - m_new) : 0.f;
        sum += pe;
        sm.p[warp][i + 4 * a][j + 8 * c] = INT8 ? pe * sm.vsc[j + 8 * c] : pe;
      }
      l_a[a] = l_a[a] * alpha + sum;  // this lane's keys; summed over lanes at the end
      m_a[a] = m_new;
      if (j == 0) sm.row[warp][i + 4 * a] = alpha;
    }
    __syncwarp();

    // output: D/32 values of each of the 16 queries a lane
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float alpha = sm.row[warp][r];
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] *= alpha;
    }
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t w[DPL / 2];
        load_words<DPL / 2>(&sm.v[kk + c][lane * DPL], w);
#pragma unroll
        for (int e = 0; e < DPL / 2; ++e) {
          vv[c][2 * e] = bf16_lo(w[e]);
          vv[c][2 * e + 1] = bf16_hi(w[e]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(&sm.p[warp][r][kk]);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          float acc = o[r][e];
          acc = fmaf(pp.x, vv[0][e], acc);
          acc = fmaf(pp.y, vv[1][e], acc);
          acc = fmaf(pp.z, vv[2][e], acc);
          acc = fmaf(pp.w, vv[3][e], acc);
          o[r][e] = acc;
        }
      }
    }
    __syncwarp();  // sm.p and sm.row are rewritten in the next step
  }

  // 1 / sum per query; a query that saw nothing (padding) gets 0
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float l = l_a[a];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (j == 0) sm.row[warp][i + 4 * a] = l > 0.f ? 1.f / l : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + warp * kRows + r;
    if (t >= T) break;
    const float inv = sm.row[warp][r];
    uint32_t w[DPL / 2];
#pragma unroll
    for (int e = 0; e < DPL / 2; ++e) w[e] = pack_bf16(o[r][2 * e] * inv, o[r][2 * e + 1] * inv);
    store_words<DPL / 2>(out + ((static_cast<size_t>(n) * T + t) * H + h) * D + lane * DPL, w);
  }
}

template <int DPL, bool INT8, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* positions, const void* slot_ids, const void* table, void* out, int N,
           int T, int H, int Hkv, int B, int S, int psz, int n_pages, int window, float scale,
           cudaStream_t st) {
  constexpr int D = DPL * 32;
  auto kernel = prefill_attention_kernel<DPL, INT8, PAGED>;
  // above 48 KB shared memory is dynamic and has to be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sizeof(Smem<D>)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTQ - 1) / kTQ, H, N);
  kernel<<<grid, kWarps * 32, sizeof(Smem<D>), st>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(positions),
      static_cast<const int*>(slot_ids), static_cast<const int*>(table),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, B, S, psz, n_pages, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT8, bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* positions, const void* slot_ids, const void* table, void* out, int N,
             int T, int H, int Hkv, int B, int S, int psz, int n_pages, int D, int window,
             float scale, void* stream) {
  if (N == 0 || T == 0) return 0;
  if (H % Hkv || (INT8 && S % 4)) return static_cast<int>(cudaErrorInvalidValue);
  if (PAGED && (psz <= 0 || n_pages <= 0 || S % psz || (INT8 && psz % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<2, INT8, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T, H,
                                    Hkv, B, S, psz, n_pages, window, scale, st);
    case 128:
      return launch<4, INT8, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T, H,
                                    Hkv, B, S, psz, n_pages, window, scale, st);
    case 256:
      return launch<8, INT8, PAGED>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T, H,
                                    Hkv, B, S, psz, n_pages, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out [N, T, H, D] bf16; k/v of one layer; positions int [N, T]; slot_ids
// int [N]; window 0 = none.  Returns cudaErrorInvalidValue (1) for a shape it
// does not take.  With ks == nullptr the cache is bf16 rows [B, Hkv, S, D];
// otherwise int8 words [B, Hkv, S/4, D] with scales ks/vs [B, 4, Hkv, S/4].
extern "C" int xb_prefill_attention(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* positions,
                                    const void* slot_ids, void* out, int N, int T, int H,
                                    int Hkv, int B, int S, int D, int window, float scale,
                                    void* stream) {
  if (ks != nullptr)
    return dispatch<true, false>(q, k, v, ks, vs, positions, slot_ids, nullptr, out, N, T, H,
                                 Hkv, B, S, S, B, D, window, scale, stream);
  return dispatch<false, false>(q, k, v, ks, vs, positions, slot_ids, nullptr, out, N, T, H,
                                Hkv, B, S, S, B, D, window, scale, stream);
}

// The paged form: k/v are pools [n_pages, Hkv, psz, D] bf16, or with ks/vs
// word pools [n_pages, Hkv, psz/4, D] and scale pools [n_pages, 4, Hkv, psz/4];
// table int [B, P], slot_ids choose its rows; a slot holds P * psz positions.
extern "C" int xb_prefill_attention_paged(const void* q, const void* k, const void* v,
                                          const void* ks, const void* vs,
                                          const void* positions, const void* slot_ids,
                                          const void* table, void* out, int N, int T, int H,
                                          int Hkv, int B, int P, int psz, int n_pages, int D,
                                          int window, float scale, void* stream) {
  if (ks != nullptr)
    return dispatch<true, true>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T, H, Hkv,
                                B, P * psz, psz, n_pages, D, window, scale, stream);
  return dispatch<false, true>(q, k, v, ks, vs, positions, slot_ids, table, out, N, T, H, Hkv,
                               B, P * psz, psz, n_pages, D, window, scale, stream);
}
