// Decode attention: one query token per slot against the head-major cache of
// one layer; out [B, H, D].  Two cache forms in one source: bf16 rows
// k/v [B, Hkv, S, D], and the packed int8 cache, words [B, Hkv, S/4, D] int32
// (byte j of word w = position 4w + j, stored as value + 128) with bf16
// scales [B, 4, Hkv, S/4].
//
// Replaces the Pallas kernels xbitops_tpu/kernels/decode_attention.py
// _kernel_v2 (decode_attention.py:176) and _kernel (decode_attention.py:80),
// entry decode_attention (decode_attention.py:925), for the dense bf16 and
// int8 caches and for their paged forms (below).  The TPU's two forms (a
// per-block grid for the interpreter, a pipelined per-slot program on the
// chip) become this one kernel.
//
// What bounds it on an H100: reading the live cache rows, B * Hkv * len * D
// values of 2 bytes (bf16) or 1 byte plus 2 scales a row (int8), far below
// the tensor-core line.  So it reads only each slot's live rows [lo, len)
// and spreads them over the card:
// - split-KV flash decoding: grid (splits, Hkv, B); a block takes one kv
//   head of one slot over `split_len` positions, its four warps take
//   positions (int8: word rows of four positions) in turn, and each warp
//   keeps an online softmax in f32 for the rep = H/Hkv query heads of that
//   kv head (query head h*rep + r uses kv head h), so a k/v row is read once
//   for all of them;
// - a lane holds D/32 contiguous values of q, k, v and the output, so a
//   warp reads a row in one coalesced access; q.k reduces by shuffles;
// - int8: a lane reads D/32 words of a word row and unpacks the four
//   positions in registers with logical shifts; the score is
//   (q . (byte - 128)) * scale * ks and the v scale is folded into the
//   probability, p * vs, before p . (byte - 128), so no dequantized row is
//   ever formed.  The TPU kernel's 128 * sum(q) correction and 2^(-8j) field
//   scaling avoided shifts on its vector unit; here a shift costs one
//   cycle;
// - blocks cannot carry state across the grid, so each writes its
//   (max, sum, unnormalised output) and a second small kernel combines the
//   splits of each (slot, head).
// lengths are clamped to [0, S]; a window w > 0 reads [max(0, len-w), len).
// A split with no live row writes max = -1e30, sum 0; a slot whose length is
// 0 gets a zero output.
//
// The paged forms (entries xb_decode_attention_paged and
// xb_decode_attention_int8_paged): k/v are page pools [n_pages, Hkv, psz, D]
// (int8: words [n_pages, Hkv, psz/4, D] with scales [n_pages, 4, Hkv, psz/4],
// the four positions of a word Hkv * psz/4 apart) and position p of slot b
// lies in pool page table[b, p / psz] at row p % psz; a slot's capacity is
// S = P * psz.  The kernel is the same one: a split walks its positions a
// page at a time and looks the page up once per page (the TPU kernel put the
// lookup in its index maps, one page per grid step), and the linear cache is
// the case of one page of S rows per slot, page b.  A split may cross many
// pages (page_size 16 against a split of 256) or lie inside one.  A table
// entry is an address: it is clamped into [0, n_pages) before use, as the TPU
// kernel clamps it at 0, so an inactive slot (length S, a row of -1) reads
// page 0 and faults nothing; its output is never used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRepMax = 8;
constexpr float kNegInf = -1e30f;

// N consecutive words in one 8- or 16-byte access (p is aligned to N words).
template <int N>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p, uint32_t (&out)[N]) {
  if constexpr (N == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    static_assert(N % 4 == 0, "words per lane: 2 or a multiple of 4");
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint4 t = *reinterpret_cast<const uint4*>(p + i);
      out[i] = t.x;
      out[i + 1] = t.y;
      out[i + 2] = t.z;
      out[i + 3] = t.w;
    }
  }
}

// One online-softmax step of a warp for one cache position: the score of each
// of the rep query heads against the row kf (times s_scale), then the value
// row vf weighted by the probability times v_scale.
template <int DPL>
__device__ __forceinline__ void attend_row(const float (&qr)[kRepMax][DPL],
                                           const float (&kf)[DPL], const float (&vf)[DPL],
                                           float s_scale, float v_scale, int rep,
                                           float (&acc)[kRepMax][DPL],
                                           float (&m_r)[kRepMax], float (&l_r)[kRepMax]) {
#pragma unroll
  for (int r = 0; r < kRepMax; ++r) {
    if (r >= rep) break;
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) d = fmaf(qr[r][i], kf[i], d);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    d *= s_scale;
    const float m_new = fmaxf(m_r[r], d);
    const float alpha = expf(m_r[r] - m_new);
    const float pe = expf(d - m_new);
    l_r[r] = l_r[r] * alpha + pe;
    const float pv = pe * v_scale;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(acc[r][i], alpha, pv * vf[i]);
    m_r[r] = m_new;
  }
}

// DPL: values per lane, D / 32.  INT8: k/v are packed words and ks/vs their
// scales; otherwise k/v are bf16 rows and ks/vs are unused.  PAGED: k/v (and
// ks/vs) are pools of pages of psz positions found through table [B, P];
// otherwise psz == S and slot b is its own single page.
// The int8 forms are held to four blocks an SM up to D = 128, so to 128
// registers a thread: without the bound the linear one takes 135 and the paged
// one 149, three blocks an SM, and on an H100 they run 15% behind at 7B shapes
// (0.123 against 0.107 ms the linear op; the paged form spills 60 bytes under
// the bound and is faster all the same).  The bf16 forms take 118 and 122
// registers and need no bound.
template <int DPL, bool INT8, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32, (INT8 && DPL <= 4) ? 4 : 1)
attend_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const void* __restrict__ k_raw, const void* __restrict__ v_raw,
                    const __nv_bfloat16* __restrict__ ks,
                    const __nv_bfloat16* __restrict__ vs,
                    const int* __restrict__ lengths, const int* __restrict__ table,
                    float* __restrict__ part_o, float* __restrict__ part_m,
                    float* __restrict__ part_l, int H, int Hkv, int S, int psz, int n_pages,
                    int n_split, int split_len, int window, float scale) {
  constexpr int D = DPL * 32;
  __shared__ float sm_m[kWarps][kRepMax];
  __shared__ float sm_l[kWarps][kRepMax];
  __shared__ float sm_o[kWarps][kRepMax][D];

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rep = H / Hkv;
  const int len = min(max(lengths[b], 0), S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int s0 = max(sp * split_len, lo);
  const int s1 = min((sp + 1) * split_len, len);

  float qr[kRepMax][DPL], acc[kRepMax][DPL], m_r[kRepMax], l_r[kRepMax];
#pragma unroll
  for (int r = 0; r < kRepMax; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[r][i] = 0.f;
      qr[r][i] = r < rep
          ? __bfloat162float(q[(static_cast<size_t>(b) * H + h * rep + r) * D + lane * DPL + i])
          : 0.f;
    }
  }

  // positions [s0, s1), a page at a time: pi is the slot's page, blk the
  // block of psz rows that holds it, [r0, r1) its rows of this split
  const int page0 = s0 < s1 ? s0 / psz : 0, page1 = s0 < s1 ? (s1 - 1) / psz + 1 : 0;
  for (int pi = page0; pi < page1; ++pi) {
    int blk = b;
    if constexpr (PAGED)
      blk = min(max(table[static_cast<size_t>(b) * (S / psz) + pi], 0), n_pages - 1);
    const int r0 = max(s0 - pi * psz, 0), r1 = min(s1 - pi * psz, psz);
    if constexpr (INT8) {
      const uint32_t* k = static_cast<const uint32_t*>(k_raw);
      const uint32_t* v = static_cast<const uint32_t*>(v_raw);
      const int Sw = psz / 4;
      const size_t head = (static_cast<size_t>(blk) * Hkv + h) * Sw;
      // scales[blk, j, h, w]: the four positions of a word lie Hkv * Sw apart
      const size_t sc_head = (static_cast<size_t>(blk) * 4 * Hkv + h) * Sw;
      const size_t sc_j = static_cast<size_t>(Hkv) * Sw;
      for (int w = r0 / 4 + warp; 4 * w < r1; w += kWarps) {
        uint32_t kw[DPL], vw[DPL];
        load_words<DPL>(k + (head + w) * D + lane * DPL, kw);
        load_words<DPL>(v + (head + w) * D + lane * DPL, vw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * w + j;
          if (p < r0 || p >= r1) continue;  // warp-uniform
          const float ksj = __bfloat162float(ks[sc_head + j * sc_j + w]);
          const float vsj = __bfloat162float(vs[sc_head + j * sc_j + w]);
          float kf[DPL], vf[DPL];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            kf[i] = static_cast<float>(static_cast<int>((kw[i] >> (8 * j)) & 0xffu) - 128);
            vf[i] = static_cast<float>(static_cast<int>((vw[i] >> (8 * j)) & 0xffu) - 128);
          }
          attend_row<DPL>(qr, kf, vf, scale * ksj, vsj, rep, acc, m_r, l_r);
        }
      }
    } else {
      const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(k_raw);
      const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(v_raw);
      const size_t head = (static_cast<size_t>(blk) * Hkv + h) * psz;
      for (int p = r0 + warp; p < r1; p += kWarps) {
        const __nv_bfloat16* kp = k + (head + p) * D + lane * DPL;
        const __nv_bfloat16* vp = v + (head + p) * D + lane * DPL;
        float kf[DPL], vf[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kf[i] = __bfloat162float(kp[i]);
          vf[i] = __bfloat162float(vp[i]);
        }
        attend_row<DPL>(qr, kf, vf, scale, 1.f, rep, acc, m_r, l_r);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRepMax; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      sm_m[warp][r] = m_r[r];
      sm_l[warp][r] = l_r[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_o[warp][r][lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * D; idx += kWarps * 32) {
    const int r = idx / D, d = idx - (idx / D) * D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float l = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][r] - mx);
      l += sm_l[w][r] * c;
      o += sm_o[w][r][d] * c;
    }
    const size_t row = (static_cast<size_t>(b) * H + h * rep + r) * n_split + sp;
    part_o[row * D + d] = o;
    if (d == 0) {
      part_m[row] = mx;
      part_l[row] = l;
    }
  }
}

__global__ void combine_kernel(const float* __restrict__ part_o,
                               const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               __nv_bfloat16* __restrict__ out, int n_split, int D) {
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s) l += pl[s] * expf(pm[s] - mx);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < n_split; ++s)
      o += part_o[(bh * n_split + s) * D + d] * expf(pm[s] - mx);
    out[bh * D + d] = __float2bfloat16(o * inv);
  }
}

template <int DPL, bool INT8, bool PAGED>
void launch_split(const dim3& grid, cudaStream_t st, const void* q, const void* k,
                  const void* v, const void* ks, const void* vs, const void* lengths,
                  const void* table, void* part_o, void* part_m, void* part_l, int H, int Hkv,
                  int S, int psz, int n_pages, int n_split, int split_len, int window,
                  float scale) {
  attend_split_kernel<DPL, INT8, PAGED><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), k, v,
      static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs),
      static_cast<const int*>(lengths), static_cast<const int*>(table),
      static_cast<float*>(part_o), static_cast<float*>(part_m), static_cast<float*>(part_l),
      H, Hkv, S, psz, n_pages, n_split, split_len, window, scale);
}

// table == nullptr: the linear cache of B slots of S rows.  Otherwise pools of
// n_pages pages of psz rows and table [B, S / psz].  Returns
// cudaErrorInvalidValue (1) for a head_dim, GQA ratio or page size it does not
// take.
template <bool INT8, bool PAGED>
int decode_attention(const void* q, const void* k, const void* v, const void* ks,
                     const void* vs, const void* lengths, const void* table, void* part_o,
                     void* part_m, void* part_l, void* out, int B, int H, int Hkv, int S,
                     int psz, int n_pages, int D, int n_split, int split_len, int window,
                     float scale, void* stream) {
  if (H % Hkv || H / Hkv > kRepMax) return static_cast<int>(cudaErrorInvalidValue);
  if (INT8 && (S % 4 || split_len % 4)) return static_cast<int>(cudaErrorInvalidValue);
  if (PAGED && (psz <= 0 || n_pages <= 0 || S % psz || (INT8 && psz % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_split, Hkv, B);
  switch (D) {
    case 64:
      launch_split<2, INT8, PAGED>(grid, st, q, k, v, ks, vs, lengths, table, part_o, part_m,
                                   part_l, H, Hkv, S, psz, n_pages, n_split, split_len, window,
                                   scale);
      break;
    case 128:
      launch_split<4, INT8, PAGED>(grid, st, q, k, v, ks, vs, lengths, table, part_o, part_m,
                                   part_l, H, Hkv, S, psz, n_pages, n_split, split_len, window,
                                   scale);
      break;
    case 256:
      launch_split<8, INT8, PAGED>(grid, st, q, k, v, ks, vs, lengths, table, part_o, part_m,
                                   part_l, H, Hkv, S, psz, n_pages, n_split, split_len, window,
                                   scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<<<B * H, 128, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<__nv_bfloat16*>(out), n_split, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int xb_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lengths, void* part_o, void* part_m,
                                   void* part_l, void* out, int B, int H, int Hkv,
                                   int S, int D, int n_split, int split_len,
                                   int window, float scale, void* stream) {
  return decode_attention<false, false>(q, k, v, nullptr, nullptr, lengths, nullptr, part_o,
                                        part_m, part_l, out, B, H, Hkv, S, S, B, D, n_split,
                                        split_len, window, scale, stream);
}

// The packed int8 cache: k/v are the words [B, Hkv, S/4, D] of one layer,
// ks/vs its scales [B, 4, Hkv, S/4]; S counts positions.
extern "C" int xb_decode_attention_int8(const void* q, const void* k, const void* v,
                                        const void* ks, const void* vs,
                                        const void* lengths, void* part_o, void* part_m,
                                        void* part_l, void* out, int B, int H, int Hkv,
                                        int S, int D, int n_split, int split_len,
                                        int window, float scale, void* stream) {
  return decode_attention<true, false>(q, k, v, ks, vs, lengths, nullptr, part_o, part_m,
                                       part_l, out, B, H, Hkv, S, S, B, D, n_split, split_len,
                                       window, scale, stream);
}

// The paged bf16 cache: k/v are the pools [n_pages, Hkv, psz, D] of one layer,
// table int [B, P]; a slot's capacity is P * psz positions.
extern "C" int xb_decode_attention_paged(const void* q, const void* k, const void* v,
                                         const void* lengths, const void* table, void* part_o,
                                         void* part_m, void* part_l, void* out, int B, int H,
                                         int Hkv, int P, int psz, int n_pages, int D,
                                         int n_split, int split_len, int window, float scale,
                                         void* stream) {
  return decode_attention<false, true>(q, k, v, nullptr, nullptr, lengths, table, part_o,
                                       part_m, part_l, out, B, H, Hkv, P * psz, psz, n_pages,
                                       D, n_split, split_len, window, scale, stream);
}

// The paged int8 cache: word pools [n_pages, Hkv, psz/4, D] and scale pools
// [n_pages, 4, Hkv, psz/4]; psz counts positions.
extern "C" int xb_decode_attention_int8_paged(const void* q, const void* k, const void* v,
                                              const void* ks, const void* vs,
                                              const void* lengths, const void* table,
                                              void* part_o, void* part_m, void* part_l,
                                              void* out, int B, int H, int Hkv, int P, int psz,
                                              int n_pages, int D, int n_split, int split_len,
                                              int window, float scale, void* stream) {
  return decode_attention<true, true>(q, k, v, ks, vs, lengths, table, part_o, part_m, part_l,
                                      out, B, H, Hkv, P * psz, psz, n_pages, D, n_split,
                                      split_len, window, scale, stream);
}
