// W4A8-style matmul on packed weights: out[M, N] (f32) from int8 activations
// aq[M, K] and the integer weight values of a packed QTensor, with the scales
// applied to INTEGER dot products:
//   grouped:     out = sum_g  s_g * (aq_g . wq_g) - (sum aq_g) * sz_g
//   per channel: out = s * (aq . wq) - (sum aq) * sz      (one group over all K)
// The caller quantized the activations per row and applies their scale to
// this output.
//
// Replaces the Pallas kernels xbitops_tpu/kernels/qgemv_kernel.py:_kernel_a8
// (grouped scales) and :_kernel_a8_perchannel (entry qmatmul_kernel(a8=True),
// qgemv_kernel.py:335).
//
// What bounds it on an H100: operations.  It runs at admission (M in the
// hundreds or thousands), where the packed weight is read once for many
// rows; the int8 tensor cores are the limit a fast version would reach.
//
// Design (simple first: no wgmma, no TMA, no pipelining yet):
// - a block owns a 128 x 128 output tile and walks K in chunks of up to 128
//   rows; a chunk never crosses a scale group, so all its products belong to
//   one scale row;
// - per chunk the int8 activation tile goes to shared memory as it is, and
//   the chunk's weights are decoded once for all 128 rows of M: the planes of
//   a multi-plane width combine into ONE integer before the dot (<= 127 for
//   widths <= 7; width 8 holds 0..255 and is stored minus 128), packed four
//   consecutive K rows to a 32-bit word per column, which is the B fragment
//   of the tensor-core instruction; the paired 4-bit plane and the 8-bit
//   plane decode four rows at once with byte permutes, every other layout
//   row by row;
// - eight warps (4 along M x 2 along N, 32 x 64 each) multiply with
//   mma.sync.m16n8k32 (s8 x s8 -> s32): all sums are exact integers;
// - grouped: the s32 sums run through a group, then fold in f32:
//   acc += float(d_g) * s_g - float(asum_g) * szb_g, asum_g the exact integer
//   row sum of the activations and szb = sz - 128 s for width 8;
// - per channel: s32 over all of K (|sum| <= 127 * 255 * K < 2^31 for
//   K < 66k), the 128 * asum of width 8 added back as an integer, and one
//   rescale at the store, with no fused multiply-add, so the output has the
//   bits of the plain version.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "planes.cuh"

namespace {

using xb::load_scale;
using xb::Planes;

constexpr int kThreads = 256;
constexpr int TM = 128, TN = 128, KC = 128;
constexpr int kAStride = KC + 16;  // bytes a row of the activation tile: conflict-free fragments
constexpr int kWStride = TN + 8;   // words a row of the weight tile: conflict-free fragments

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool PERCHANNEL>
__global__ void __launch_bounds__(kThreads)
qgemv_a8_kernel(const int8_t* __restrict__ a, int M, int K, int N, Planes pl,
                const void* __restrict__ s, const void* __restrict__ sz, int s_f16, int tile_k,
                int gt, int gt_pad, float* __restrict__ out) {
  __shared__ __align__(16) int8_t a_s[TM * kAStride];         // [m][k]
  __shared__ __align__(16) uint32_t w_s[(KC / 4) * kWStride];  // [k/4][n], 4 K rows a word
  __shared__ int w_row[xb::kMaxPlanes][KC];
  __shared__ int w_shift[xb::kMaxPlanes][KC];
  __shared__ int asum_s[TM];  // the activations' row sums over the group (per channel: all K)
  __shared__ float s_s[TN], szb_s[TN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m_warp = (warp & 3) * 32, n_warp = (warp >> 2) * 64;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int g_tile = tile_k / gt;  // K rows per scale row
  const bool bits8 = pl.n == 1 && pl.pb[0] == 8;
  // the two single-plane layouts whose four consecutive K rows decode at once
  const int fast = pl.n != 1 ? 0 : (pl.paired ? 1 : (bits8 ? 2 : 0));
  const bool n_vec = (N % 4) == 0;
  const bool a_vec = (K % 16) == 0;
  uint32_t mask[xb::kMaxPlanes];
  int off[xb::kMaxPlanes];
  for (int p = 0; p < xb::kMaxPlanes; ++p) {
    mask[p] = p < pl.n ? (1u << pl.pb[p]) - 1u : 0u;
    off[p] = p < pl.n ? xb::plane_offset(pl, p) : 0;
  }

  int d[2][8][4];      // exact integer sums: of the current group, or of all K
  float acc[2][8][4];  // grouped: the folded groups
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[mi][ni][e] = 0;
        acc[mi][ni][e] = 0.f;
      }
  if (PERCHANNEL && tid < TM) asum_s[tid] = 0;

  for (int k0 = 0; k0 < K;) {
    // the chunk: up to KC rows, all within one scale row
    const int u = k0 / g_tile;
    const int seg_end = PERCHANNEL ? K : min(K, (u + 1) * g_tile);
    const int kc = min(KC, seg_end - k0);
    const int ksteps = (kc + 31) / 32;
    __syncthreads();  // the previous chunk is consumed

    // --- phase 1: plane tables, the activation tile, the group's scales ---
    if (tid < KC && tid < kc)
      for (int p = 0; p < pl.n; ++p)
        xb::plane_slot(pl, p, tile_k, k0 + tid, w_row[p][tid], w_shift[p][tid]);
    if (a_vec && (k0 % 16) == 0 && kc == KC) {
      // 16 bytes a thread: 8 lanes cover a row of the chunk
      for (int i = tid; i < TM * (KC / 16); i += kThreads) {
        const int m = i / (KC / 16), q = i - m * (KC / 16);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + m < M)
          v = __ldg(reinterpret_cast<const uint4*>(a + static_cast<size_t>(m0 + m) * K + k0) + q);
        *reinterpret_cast<uint4*>(a_s + m * kAStride + q * 16) = v;
      }
    } else {
      // ragged chunk: byte loads, zero past the chunk and past M
      const int words = ksteps * 8;
      for (int i = tid; i < TM * words; i += kThreads) {
        const int m = i / words, q = i - m * words;
        uint32_t v = 0u;
        if (m0 + m < M) {
          const int8_t* src = a + static_cast<size_t>(m0 + m) * K + k0 + q * 4;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (q * 4 + b < kc) v |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * b);
        }
        *reinterpret_cast<uint32_t*>(a_s + m * kAStride + q * 4) = v;
      }
    }
    if (!PERCHANNEL && tid < TN) {
      const int n = min(n0 + tid, N - 1);
      const int t = k0 / tile_k, gi = (k0 - t * tile_k) / g_tile;
      const size_t si = (static_cast<size_t>(t) * gt_pad + gi) * N + n;
      const float sv = load_scale(s, si, s_f16);
      s_s[tid] = sv;
      szb_s[tid] = load_scale(sz, si, s_f16) - (bits8 ? 128.f * sv : 0.f);
    }
    __syncthreads();

    // --- phase 2: decode the chunk's weights; the activations' row sums ---
    // an item: 4 consecutive K rows x 4 adjacent columns; a warp's lanes on
    // adjacent column quads
    for (int i = tid; i < ksteps * 8 * (TN / 4); i += kThreads) {
      const int k4 = i / (TN / 4), n4 = i - k4 * (TN / 4);
      const int n = n0 + n4 * 4;
      uint32_t word[4] = {0u, 0u, 0u, 0u};
      const int r0 = k4 * 4;
      const bool quad = n_vec && n < N && r0 + 3 < kc;
      if (quad && fast == 1 && w_shift[0][r0] < 16 && w_row[0][r0 + 2] == w_row[0][r0] + 1 &&
          w_shift[0][r0 + 2] == w_shift[0][r0]) {
        // paired 4-bit plane: a word holds rows 2r and 2r + 1 of a pair slot
        // 16 bits apart, so two word rows give the four K rows, one byte
        // permute a column
        const int sh = w_shift[0][r0];
        uint32_t w0[4], w1[4];
        xb::load_words<4>(pl.ptr[0], w_row[0][r0], N, n, w0);
        xb::load_words<4>(pl.ptr[0], w_row[0][r0] + 1, N, n, w1);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          word[c] = __byte_perm((w0[c] >> sh) & 0x000F000Fu, (w1[c] >> sh) & 0x000F000Fu, 0x6420);
      } else if (quad && fast == 2 && w_row[0][r0 + 3] == w_row[0][r0] + 3 &&
                 w_shift[0][r0 + 3] == w_shift[0][r0]) {
        // 8-bit plane: byte j of four consecutive word rows; minus 128 flips bit 7
        const uint32_t j = w_shift[0][r0] >> 3;
        const uint32_t sel = j | ((4u + j) << 4);
        uint32_t w[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b) xb::load_words<4>(pl.ptr[0], w_row[0][r0] + b, N, n, w[b]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          word[c] = __byte_perm(__byte_perm(w[0][c], w[1][c], sel),
                                __byte_perm(w[2][c], w[3][c], sel), 0x5410) ^ 0x80808080u;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int r = r0 + b;
          if (r >= kc || n >= N) continue;
          uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int p = 0; p < xb::kMaxPlanes; ++p) {
            if (p >= pl.n) break;
            uint32_t w[4];
            if (n_vec) {
              xb::load_words<4>(pl.ptr[p], w_row[p][r], N, n, w);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                w[c] = n + c < N
                           ? __ldg(pl.ptr[p] + static_cast<size_t>(w_row[p][r]) * N + n + c)
                           : 0u;
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) v[c] |= ((w[c] >> w_shift[p][r]) & mask[p]) << off[p];
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int val = static_cast<int>(v[c]) - (bits8 ? 128 : 0);
            word[c] |= (static_cast<uint32_t>(val) & 0xffu) << (8 * b);
          }
        }
      }
      *reinterpret_cast<uint4*>(w_s + k4 * kWStride + n4 * 4) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
    {
      // two threads a row, half of the staged chunk each
      const int m = tid >> 1, half = tid & 1;
      int sum = 0;
      const uint32_t* row = reinterpret_cast<const uint32_t*>(a_s + m * kAStride);
      for (int q = half * 4 * ksteps; q < (half + 1) * 4 * ksteps; ++q)
        sum = __dp4a(static_cast<int>(row[q]), 0x01010101, sum);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      // a group (per channel: all of K) may span several chunks
      const bool fresh = !PERCHANNEL && k0 == u * g_tile;
      if (half == 0) asum_s[m] = (fresh ? 0 : asum_s[m]) + sum;
    }
    __syncthreads();

    // --- phase 3: the integer products ---
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* base = a_s + (m_warp + mi * 16 + g) * kAStride + ks * 32 + t4 * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kAStride);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kAStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const uint32_t* wb = w_s + (ks * 8 + t4) * kWStride + n_warp + ni * 8 + g;
        const uint32_t b0 = wb[0], b1 = wb[4 * kWStride];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(d[mi][ni], af[mi], b0, b1);
      }
    }

    k0 += kc;
    if (!PERCHANNEL && (k0 == seg_end)) {
      // the group is complete: fold its integer sums into the f32 accumulator
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float as_lo = static_cast<float>(asum_s[m_warp + mi * 16 + g]);
        const float as_hi = static_cast<float>(asum_s[m_warp + mi * 16 + g + 8]);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int nl = n_warp + ni * 8 + t4 * 2 + (e & 1);
            const float as = (e & 2) ? as_hi : as_lo;
            acc[mi][ni][e] = fmaf(static_cast<float>(d[mi][ni][e]), s_s[nl], acc[mi][ni][e]);
            acc[mi][ni][e] = fmaf(-as, szb_s[nl], acc[mi][ni][e]);
            d[mi][ni][e] = 0;
          }
      }
    }
  }

  if (PERCHANNEL) __syncthreads();  // asum_s is complete
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ml = m_warp + mi * 16 + g + ((e & 2) ? 8 : 0);
        const int m = m0 + ml;
        const int n = n0 + n_warp + ni * 8 + t4 * 2 + (e & 1);
        if (m >= M || n >= N) continue;
        float v;
        if (PERCHANNEL) {
          // one scale row over all of K: row 0 of tile 0
          const int asum = asum_s[ml];
          const int dd = d[mi][ni][e] + (bits8 ? 128 * asum : 0);
          v = __fsub_rn(__fmul_rn(static_cast<float>(dd), load_scale(s, n, s_f16)),
                        __fmul_rn(static_cast<float>(asum), load_scale(sz, n, s_f16)));
        } else {
          v = acc[mi][ni][e];
        }
        out[static_cast<size_t>(m) * N + n] = v;
      }
}

}  // namespace

// aq: int8 [M, K] contiguous, K the packed row count; out: f32 [M, N].
// perchannel != 0 takes one scale row (tile 0, row 0) for all of K.
// Grid: x = N / 128, y = M / 128 (both rounded up).
extern "C" int xb_qgemv_a8(const void* aq, int M, int K, int N, const void* p0, const void* p1,
                           const void* p2, int pb0, int pb1, int pb2, int paired, const void* s,
                           const void* sz, int s_f16, int tile_k, int gt, int gt_pad,
                           int perchannel, void* out, void* stream) {
  if (K % tile_k || gt < 1 || tile_k % gt) return static_cast<int>(cudaErrorInvalidValue);
  const Planes pl = xb::make_planes(p0, p1, p2, pb0, pb1, pb2, paired);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  const int8_t* a = static_cast<const int8_t*>(aq);
  float* o = static_cast<float*>(out);
  if (perchannel)
    qgemv_a8_kernel<true><<<grid, kThreads, 0, st>>>(a, M, K, N, pl, s, sz, s_f16, tile_k, gt,
                                                     gt_pad, o);
  else
    qgemv_a8_kernel<false><<<grid, kThreads, 0, st>>>(a, M, K, N, pl, s, sz, s_f16, tile_k, gt,
                                                      gt_pad, o);
  return static_cast<int>(cudaGetLastError());
}
