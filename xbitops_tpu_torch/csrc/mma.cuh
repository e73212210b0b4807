// Warp-level tensor-core pieces shared by the kernels that multiply on
// mma.sync (qgemv_mma.cu, qgemv_word.cu, prefill_attention.cu,
// decode_attention.cu): the bf16 and fp16 m16n8k16 products, ldmatrix,
// movmatrix, cp.async, the exact decode of packed integers to bf16 pairs, and
// the split of f32 values into a bf16 high and low part.
//
// Fragment layout of mma.m16n8k16.row.col, lane = 4*g + t4 (g = 0..7, t4 = 0..3):
//   A (16 x 16, row): a0 = (row g,   k 2t4, 2t4+1)   a1 = (row g+8, k 2t4, 2t4+1)
//                     a2 = (row g,   k 2t4+8, +9)    a3 = (row g+8, k 2t4+8, +9)
//   B (16 x 8, col):  b0 = (k 2t4, 2t4+1; n g)       b1 = (k 2t4+8, +9; n g)
//   C (16 x 8):       c0, c1 = (row g, n 2t4, 2t4+1) c2, c3 = (row g+8, same n)
// A 32-bit register holds two bf16 values, the lower index in the low half.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xb {

constexpr uint32_t kBf16x2_128 = 0x43004300u;  // (128.0, 128.0)
constexpr uint32_t kBf16x2_16 = 0x41804180u;   // (16.0, 16.0)
constexpr uint32_t kBf16x2_1 = 0x3F803F80u;    // (1.0, 1.0)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product on fp16 operands (f32 sums).
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of 16-bit values; lanes 8i..8i+7 give the row addresses
// (16 bytes each) of matrix i, and r[i] holds matrix i: lane 4g + t4 gets row
// g, columns 2t4 and 2t4 + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, each matrix transposed: lane 4g + t4 gets rows 2t4 and 2t4 + 1 of
// column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// An 8 x 8 matrix of 16-bit values held as ldmatrix leaves it (lane 4g + t4:
// row g, columns 2t4 and 2t4 + 1), transposed in registers: lane 4g + t4 then
// holds rows 2t4 and 2t4 + 1 of column g.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// 16 bytes from global to shared memory without passing registers; with
// `valid` false nothing is read and the 16 bytes are zero.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

// The same for 4 bytes (a source that is only word-aligned).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t bf162_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf162_fma(uint32_t a, uint32_t b, uint32_t c) {
  const __nv_bfloat162 r = __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Two integers of up to 4 bits, in bits 0-3 and 16-19 of `v` (other bits
// ignored), as a bf16 pair, exactly: the nibble goes into the mantissa of
// 128.0 (whose unit in the last place is 1) and 128 comes off again.
__device__ __forceinline__ uint32_t nibbles_to_bf162(uint32_t v) {
  return bf162_sub((v & 0x000F000Fu) | kBf16x2_128, kBf16x2_128);
}

// Two integers of up to 8 bits, in bits 0-7 and 16-23 of `v`, as a bf16
// pair, exactly (255 needs 8 significant bits, which bf16 has): low nibble
// plus 16 times high nibble, one rounding-free fused multiply-add.
__device__ __forceinline__ uint32_t bytes_to_bf162(uint32_t v) {
  return bf162_fma(nibbles_to_bf162(v >> 4), kBf16x2_16, nibbles_to_bf162(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t pack_f16(float a, float b) {
  const __half2 t = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// A bf16 pair (the lower index in the low half) as the fp16 pair of the same
// values, rounded to nearest (exact for bf16 values inside fp16's normal range).
__device__ __forceinline__ uint32_t bf162_to_f162(uint32_t a) {
  return pack_f16(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u));
}

// Two f32 values as a bf16 pair hi and a bf16 pair lo = x - hi, rounded: hi + lo
// holds x to 16 significant bits (relative error <= 2^-17), so products of
// them on the bf16 tensor cores keep an f32 operand to f32-like accuracy.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// The biased bytes (value + 128) in bits 0-7 and 16-23 of t as the bf16 pair
// (byte - 128), exactly: the low seven bits go into the mantissa of 128.0,
// and what comes off is 128 when the byte's top bit is set, else 256.
__device__ __forceinline__ uint32_t biased_bytes_to_bf162(uint32_t t) {
  return bf162_sub((t & 0x007F007Fu) | kBf16x2_128, (t & 0x00800080u) ^ 0x43804380u);
}

// Byte j of w0 and of w1 (the packed int8 cache), as a bf16 pair.
__device__ __forceinline__ uint32_t unpack_pair(uint32_t w0, uint32_t w1, int j) {
  return biased_bytes_to_bf162(__byte_perm(w0, w1, j | ((4 + j) << 8)));
}

}  // namespace xb
