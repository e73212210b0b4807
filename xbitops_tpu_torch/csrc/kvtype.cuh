// The element types of a dense KV cache (bf16, fp16 or f32 rows), shared by
// kv_append.cu, decode_attention.cu and prefill_attention.cu, and the
// conversion of new rows into them.  New rows come as bf16 (the model's
// activations); a bf16 value is converted as PyTorch's and JAX's casts convert it: exactly to f32, and to
// fp16 rounded to nearest even (inf past fp16's range, subnormals kept).
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace xb {

// A cache form, as the C entries take it: the dense types, and the packed int8
// cache (decode_attention.cu, prefill_attention.cu).
enum KvForm { kKvBf16 = 0, kKvF16 = 1, kKvF32 = 2, kKvInt8 = 3 };

template <int KV>
struct KvElem {
  using T = __nv_bfloat16;
};
template <>
struct KvElem<kKvF16> {
  using T = __half;
};
template <>
struct KvElem<kKvF32> {
  using T = float;
};

__device__ __forceinline__ void from_float(float x, __nv_bfloat16* o) { *o = __float2bfloat16_rn(x); }
__device__ __forceinline__ void from_float(float x, __half* o) { *o = __float2half_rn(x); }
__device__ __forceinline__ void from_float(float x, float* o) { *o = x; }

// 16 bytes of a row as the cache's type T: bf16 elements [at, at + 16 /
// sizeof(T)) of `rows`, converted.  Aligned: `at` is a multiple of
// 16 / sizeof(T) and the rows start on 16 bytes.
template <typename T>
__device__ __forceinline__ uint4 row_chunk(const __nv_bfloat16* rows, size_t at) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return *reinterpret_cast<const uint4*>(rows + at);
  constexpr int n = 16 / sizeof(T);
  __nv_bfloat16 src[n];
  if constexpr (n == 8)
    *reinterpret_cast<uint4*>(src) = *reinterpret_cast<const uint4*>(rows + at);
  else
    *reinterpret_cast<uint2*>(src) = *reinterpret_cast<const uint2*>(rows + at);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int i = 0; i < n; ++i) from_float(__bfloat162float(src[i]), o + i);
  return out;
}

}  // namespace xb
