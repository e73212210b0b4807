// In-place KV append: write one new row per slot into the head-major cache of
// one layer at row positions[i].  Two kernels: the dense cache k/v
// [B, Hkv, S, D] of bf16, fp16 or f32 rows, and the packed int8 cache (below).
//
// Replaces the Pallas kernels xbitops_tpu/kernels/kv_append.py:_kernel_dense
// (entry kv_append_dense, kv_append.py:109) and :_kernel (entry
// kv_append_packed, kv_append.py:166).
//
// What bounds it: nothing on an H100 -- it moves B * Hkv * D * 2 values
// (1 MB at 7B, B=8, bf16), so its time is the launch.  The TPU kernel
// rewrote a slab of 32 bytes' worth of rows per slot (16 bf16 rows, 8 f32
// rows) because of the TPU's tiling; here one small block a (slot, kv head)
// moves exactly that row of k and of v, one 16-byte store a thread, nothing
// else.  The dense cache's type is a template argument (csrc/kvtype.cuh):
// new rows come as bf16 or in the cache's type, and a thread converts its
// piece of a row on the way (16 bytes of the cache: 8 values of bf16 or fp16,
// 4 of f32), rounded to nearest as the JAX kernel's .astype(k.dtype) does.  Decode writes its rows inside the attention
// kernel (csrc/decode_attention.cu); this kernel serves the other one-row
// writes.
//
// Row i goes to slot i.  It writes nothing when its position is outside
// [0, S): padding and inactive slots carry position S.
//
// The packed int8 cache keeps four positions in one int32 word: words
// [B, Hkv, S/4, D], byte j of word w = position 4w + j (value + 128), and
// scales [B, 4, Hkv, S/4] bf16 with scales[b, j, h, w] for position 4w + j.
// Its append replaces byte pos % 4 of each (head, dim) word of the target
// word row and sets the position's two scales: launch-bound like the bf16
// one.  The TPU kernel moved an 8-row slab and a 128-lane scale chunk through
// VMEM and picked the new scales with a one-hot reduce, all for Mosaic's
// tiling; none of it is needed here.  Its first port here ran one block a
// slot that walked Hkv * D words one at a time, behind casting passes of the
// wrapper; it is now the bf16 one's shape: one block a (slot, kv head), a
// thread read-modify-writing 4 adjacent words with one 16-byte load and
// store, the new bytes read 16 bytes at a time, the new scales taken as they
// come (f32, rounded to bf16 here as PyTorch rounds, or bf16) and the
// positions as int32 or int64.  The word is handled as uint32_t, so byte 3
// (the sign bits of the int32) shifts logically.
//
// The paged forms (entries xb_kv_append_paged, xb_kv_append_packed_paged) are
// the same two kernels with another target: k/v are page pools
// [n_pages, Hkv, psz, D] (int8: words [n_pages, Hkv, psz/4, D], scales
// [n_pages, 4, Hkv, psz/4]) and position p of slot i lies in pool page
// table[i, p / psz] at row p % psz, where the linear cache has slot i's own
// S rows.  A table entry is an address: a row is written only when
// 0 <= p < P * psz and 0 <= table[i, p / psz] < n_pages, so a slot without a
// page for its position (entry -1) writes nothing, as the JAX package's
// dropped scatter does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kvtype.cuh"

namespace {

// Where position pos of slot i goes: the linear cache keeps it in block i of
// `rows` = S rows at row pos; a pool in block table[i, pos / rows] of `rows`
// = psz rows at row pos % rows.  False: nothing is written.
template <bool PAGED>
__device__ __forceinline__ bool locate(int i, long long pos, int rows,
                                       const int* __restrict__ table, int P, int n_pages,
                                       int* block, int* row) {
  if constexpr (PAGED) {
    if (pos < 0 || pos >= static_cast<long long>(P) * rows) return false;
    const int page = table[static_cast<size_t>(i) * P + pos / rows];
    if (page < 0 || page >= n_pages) return false;
    *block = page;
    *row = static_cast<int>(pos % rows);
  } else {
    if (pos < 0 || pos >= rows) return false;
    *block = i;
    *row = static_cast<int>(pos);
  }
  return true;
}

// Grid (Hkv, B), 2 * D / EPC threads (EPC = 16 / sizeof(T) values in 16
// bytes): thread c < D / EPC writes 16 bytes of the k row, the rest the v row.
// New rows bf16, cast to T; positions int32, or int64 with pos64.
template <typename T, bool PAGED>
__global__ void kv_append_kernel(uint4* __restrict__ k, uint4* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ k_new,
                                 const __nv_bfloat16* __restrict__ v_new,
                                 const void* __restrict__ positions, int pos64,
                                 const int* __restrict__ table, int P, int n_pages, int Hkv,
                                 int S, int D) {
  constexpr int EPC = 16 / sizeof(T);
  const int h = blockIdx.x, i = blockIdx.y;
  const long long p = pos64 ? static_cast<const long long*>(positions)[i]
                            : static_cast<const int*>(positions)[i];
  int blk, pos;
  if (!locate<PAGED>(i, p, S, table, P, n_pages, &blk, &pos)) return;
  const int chunks = D / EPC;  // 16-byte pieces of a row
  const int which = threadIdx.x / chunks, c = threadIdx.x - which * chunks;
  const size_t dst = ((static_cast<size_t>(blk) * Hkv + h) * S + pos) * chunks + c;
  const size_t src = ((static_cast<size_t>(i) * Hkv + h) * chunks + c) * EPC;
  (which ? v : k)[dst] = xb::row_chunk<T>(which ? v_new : k_new, src);
}

// A new scale as bf16 bits: f32 (s_f32) rounded to nearest even, or bf16.
__device__ __forceinline__ uint16_t scale_bits(const void* p, size_t i, int s_f32) {
  if (!s_f32) return static_cast<const uint16_t*>(p)[i];
  const __nv_bfloat16 b = __float2bfloat16(static_cast<const float*>(p)[i]);
  return *reinterpret_cast<const uint16_t*>(&b);
}

// Grid (Hkv, B), 2 * D / 4 threads: thread c < D / 4 replaces byte pos % 4 of
// words 4c..4c + 3 of the k row, the rest of the v row; the first thread of
// each also writes the scale.  kq/vq int32 [B, Hkv, D] (biased values, the
// low byte is taken); positions int32, or int64 with pos64.
template <bool PAGED>
__global__ void kv_append_packed_kernel(uint4* __restrict__ k, uint4* __restrict__ v,
                                        uint16_t* __restrict__ ks, uint16_t* __restrict__ vs,
                                        const uint4* __restrict__ kq,
                                        const uint4* __restrict__ vq,
                                        const void* __restrict__ ks_new,
                                        const void* __restrict__ vs_new, int s_f32,
                                        const void* __restrict__ positions, int pos64,
                                        const int* __restrict__ table, int P, int n_pages,
                                        int Hkv, int Sw, int D) {
  const int h = blockIdx.x, i = blockIdx.y;
  const long long p = pos64 ? static_cast<const long long*>(positions)[i]
                            : static_cast<const int*>(positions)[i];
  int blk, pos;
  if (!locate<PAGED>(i, p, Sw * 4, table, P, n_pages, &blk, &pos)) return;
  const int w = pos >> 2, sh = 8 * (pos & 3);
  const uint32_t keep = ~(0xffu << sh);
  const int chunks = D / 4;  // 16-byte pieces of a word row
  const int which = threadIdx.x / chunks, c = threadIdx.x - which * chunks;
  uint4* words = which ? v : k;
  const size_t dst = ((static_cast<size_t>(blk) * Hkv + h) * Sw + w) * chunks + c;
  const uint4 q = (which ? vq : kq)[(static_cast<size_t>(i) * Hkv + h) * chunks + c];
  uint4 o = words[dst];
  o.x = (o.x & keep) | ((q.x & 0xffu) << sh);
  o.y = (o.y & keep) | ((q.y & 0xffu) << sh);
  o.z = (o.z & keep) | ((q.z & 0xffu) << sh);
  o.w = (o.w & keep) | ((q.w & 0xffu) << sh);
  words[dst] = o;
  if (c == 0) {
    const size_t sdst = ((static_cast<size_t>(blk) * 4 + (pos & 3)) * Hkv + h) * Sw + w;
    (which ? vs : ks)[sdst] =
        scale_bits(which ? vs_new : ks_new, static_cast<size_t>(i) * Hkv + h, s_f32);
  }
}

template <bool PAGED>
int append_packed(void* k, void* v, void* ks, void* vs, const void* kq, const void* vq,
                  const void* ks_new, const void* vs_new, int s_f32, const void* positions,
                  int pos64, const void* table, int P, int n_pages, int B, int Hkv, int Sw, int D,
                  void* stream) {
  if (D % 4 || D > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  kv_append_packed_kernel<PAGED>
      <<<dim3(Hkv, B), 2 * (D / 4), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<uint4*>(k), static_cast<uint4*>(v), static_cast<uint16_t*>(ks),
          static_cast<uint16_t*>(vs), static_cast<const uint4*>(kq),
          static_cast<const uint4*>(vq), ks_new, vs_new, s_f32, positions, pos64,
          static_cast<const int*>(table), P, n_pages, Hkv, Sw, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED>
int append_t(void* k, void* v, const void* k_new, const void* v_new,
             const void* positions, int pos64, const void* table, int P, int n_pages, int B,
             int Hkv, int S, int D, void* stream) {
  constexpr int EPC = 16 / sizeof(T);
  kv_append_kernel<T, PAGED>
      <<<dim3(Hkv, B), 2 * (D / EPC), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<uint4*>(k), static_cast<uint4*>(v),
          static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
          positions, pos64, static_cast<const int*>(table), P, n_pages, Hkv, S, D);
  return static_cast<int>(cudaGetLastError());
}

// dtype: the cache's type (xb::KvForm: bf16, fp16 or f32); new rows bf16.
template <bool PAGED>
int append(void* k, void* v, const void* k_new, const void* v_new, int dtype,
           const void* positions, int pos64, const void* table, int P, int n_pages, int B,
           int Hkv, int S, int D, void* stream) {
  if (D % 8 || D > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  switch (dtype) {
    case xb::kKvBf16:
      return append_t<__nv_bfloat16, PAGED>(k, v, k_new, v_new, positions, pos64, table, P,
                                            n_pages, B, Hkv, S, D, stream);
    case xb::kKvF16:
      return append_t<__half, PAGED>(k, v, k_new, v_new, positions, pos64, table, P,
                                     n_pages, B, Hkv, S, D, stream);
    case xb::kKvF32:
      return append_t<float, PAGED>(k, v, k_new, v_new, positions, pos64, table, P,
                                    n_pages, B, Hkv, S, D, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kq, vq int32 [B, Hkv, D], 16-byte aligned; ks_new, vs_new [B, Hkv] f32
// (s_f32 = 1) or bf16; positions int32 [B], or int64 with pos64 = 1.
extern "C" int xb_kv_append_packed(void* k, void* v, void* ks, void* vs, const void* kq,
                                   const void* vq, const void* ks_new, const void* vs_new,
                                   int s_f32, const void* positions, int pos64, int B, int Hkv,
                                   int Sw, int D, void* stream) {
  return append_packed<false>(k, v, ks, vs, kq, vq, ks_new, vs_new, s_f32, positions, pos64,
                              nullptr, 0, 0, B, Hkv, Sw, D, stream);
}

// k/v rows of dtype 0 (bf16), 1 (fp16) or 2 (f32); k_new, v_new bf16
// [B, Hkv, D], 16-byte aligned; positions int32 [B], or int64 with pos64 = 1.
extern "C" int xb_kv_append(void* k, void* v, const void* k_new, const void* v_new, int dtype,
                            const void* positions, int pos64, int B, int Hkv, int S, int D,
                            void* stream) {
  return append<false>(k, v, k_new, v_new, dtype, positions, pos64, nullptr, 0, 0, B, Hkv, S, D,
                       stream);
}

// The paged forms: k/v (and ks/vs) are the pools of one layer, table int
// [B, P], pszw / psz the word rows / rows of a page.
extern "C" int xb_kv_append_packed_paged(void* k, void* v, void* ks, void* vs, const void* kq,
                                         const void* vq, const void* ks_new,
                                         const void* vs_new, int s_f32, const void* positions,
                                         int pos64, const void* table, int P, int n_pages, int B,
                                         int Hkv, int pszw, int D, void* stream) {
  if (P <= 0 || n_pages <= 0 || pszw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return append_packed<true>(k, v, ks, vs, kq, vq, ks_new, vs_new, s_f32, positions, pos64,
                             table, P, n_pages, B, Hkv, pszw, D, stream);
}

extern "C" int xb_kv_append_paged(void* k, void* v, const void* k_new, const void* v_new,
                                  int dtype, const void* positions, int pos64,
                                  const void* table, int P, int n_pages, int B, int Hkv, int psz,
                                  int D, void* stream) {
  if (P <= 0 || n_pages <= 0 || psz <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return append<true>(k, v, k_new, v_new, dtype, positions, pos64, table, P, n_pages, B, Hkv,
                      psz, D, stream);
}
