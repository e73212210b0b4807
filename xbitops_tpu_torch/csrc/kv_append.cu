// In-place KV append: write one new row per slot into the head-major bf16
// cache of one layer, k/v [B, Hkv, S, D], at row positions[i].
//
// Replaces the Pallas kernel xbitops_tpu/kernels/kv_append.py:_kernel_dense
// (entry kv_append_dense, kv_append.py:109).
//
// What bounds it: nothing on an H100 -- it moves B * Hkv * D * 2 values
// (1 MB at 7B, B=8), so its time is the launch.  The TPU kernel rewrote a
// 16-row slab per slot because of the TPU's tiling; here each thread block
// copies exactly its slot's Hkv * D new values, nothing else.
//
// Row i goes to slot i.  It writes nothing when its position is outside
// [0, S): padding and inactive slots carry position S.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void kv_append_kernel(uint16_t* __restrict__ k, uint16_t* __restrict__ v,
                                 const uint16_t* __restrict__ k_new,
                                 const uint16_t* __restrict__ v_new,
                                 const int* __restrict__ positions,
                                 int B, int Hkv, int S, int D) {
  const int i = blockIdx.x;
  if (i >= B) return;
  const int pos = positions[i];
  if (pos < 0 || pos >= S) return;
  const int row = Hkv * D;
  for (int e = threadIdx.x; e < row; e += blockDim.x) {
    const int h = e / D, d = e - (e / D) * D;
    const size_t dst = ((static_cast<size_t>(i) * Hkv + h) * S + pos) * D + d;
    const size_t src = static_cast<size_t>(i) * row + e;
    k[dst] = k_new[src];
    v[dst] = v_new[src];
  }
}

}  // namespace

extern "C" int xb_kv_append(void* k, void* v, const void* k_new, const void* v_new,
                            const void* positions, int B, int Hkv, int S, int D,
                            void* stream) {
  if (B == 0) return 0;
  kv_append_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(k), static_cast<uint16_t*>(v),
      static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),
      static_cast<const int*>(positions), B, Hkv, S, D);
  return static_cast<int>(cudaGetLastError());
}
