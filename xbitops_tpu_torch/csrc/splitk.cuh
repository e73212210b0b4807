// The second pass of a split-K matmul: out = the sum over splits of
// part[split], added in split order, so the result does not depend on which
// block finished first.  Shared by qgemv.cu and qgemv_mma.cu.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace xb {

static __global__ void add_splits_kernel(const float* __restrict__ part, int splits, size_t MN,
                                         void* __restrict__ out, int out_f32) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < MN;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += part[z * MN + i];
    if (out_f32)
      static_cast<float*>(out)[i] = v;
    else
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  }
}

// Launches the pass on `st` and returns cudaGetLastError().
static inline int add_splits(const float* part, int splits, int M, int N, void* out, int out_f32,
                             cudaStream_t st) {
  const size_t MN = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  add_splits_kernel<<<blocks, 256, 0, st>>>(part, splits, MN, out, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xb
