// The split-and-combine helpers of K6 (int4_kv_attention.cu), the
// quantized-KV decode attention over per-token affine nibbles.
//
// The TPU kernels walk the whole history of one (row, KV head) in order on
// one core, carrying (m, l, acc) from tile to tile.  On the H100 that would
// use 4 of 132 SMs at Qwen2-VL-7B's 4 KV heads, so the history is split into
// blocks of TC tokens instead: each block computes the softmax partials of
// its tokens against its own maximum, and `combine_kernel` rescales and sums
// them.  A block whose tokens are all invisible writes nothing, and the
// combine skips it by the same `live_range` rule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kvd {
namespace {  // each source gets its own copy of the combine kernel

constexpr int TC = 128;       // history tokens per block (one per thread)
constexpr int THREADS = 128;  // threads per block
constexpr int ROWS = 8;       // query rows per block; grid z covers g

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Visible columns [lo, hi) of split s for a row with cursor `off` and
// `left_pad`: left_pad <= c < off, inside the split and the capacity.
__device__ __forceinline__ void live_range(int s, int off, int lp, int C,
                                           int& lo, int& hi) {
  lo = max(s * TC, lp);
  hi = min(min((s + 1) * TC, C), off);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Softmax over one block's tokens for its R query rows.  On entry
// p[r][i] holds the score of token s*TC + i (-inf where invisible); on exit
// it holds p = exp(score - m_r) (0 where invisible), pv[k][r][i] holds
// bf16(p * vscale_k[token]) for each of the nv value scales, and
// ml[((s*BH + bh)*G + row)*3 + {0, 1, 2}] = (m_r, sum p, sum p * vbias) for
// each row (vbias may be null: the third entry is then 0).
__device__ __forceinline__ void block_softmax(
    float (*p)[TC], float (*pv0)[TC], float (*pv1)[TC], int nv,
    const float* vscale0, const float* vscale1, const float* vbias, int R,
    int s, int lo, int hi, float* ml_row0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += THREADS / 32) {
    float mx = -INFINITY;
    for (int i = lane; i < TC; i += 32) mx = fmaxf(mx, p[r][i]);
    mx = warp_max(mx);
    float sum = 0.f, bsum = 0.f;
    for (int i = lane; i < TC; i += 32) {
      const int c = s * TC + i;
      const bool live = c >= lo && c < hi;
      const float e = live ? expf(p[r][i] - mx) : 0.f;
      p[r][i] = e;
      pv0[r][i] = live ? bf16r(e * vscale0[c]) : 0.f;
      if (nv > 1) pv1[r][i] = live ? bf16r(e * vscale1[c]) : 0.f;
      sum += e;
      if (vbias != nullptr && live) bsum += e * vbias[c];
    }
    sum = warp_sum(sum);
    bsum = warp_sum(bsum);
    if (lane == 0) {
      ml_row0[r * 3] = mx;
      ml_row0[r * 3 + 1] = sum;
      ml_row0[r * 3 + 2] = bsum;
    }
  }
}

// out[bh, r, :] = (sum_s w_s acc_s + sum_s w_s bias_s) / max(sum_s w_s l_s,
// 1e-30) with w_s = exp(m_s - max_s m_s), over the live splits; 0 for a
// row that sees nothing.  Grid (G, BH), any block size.
__global__ void combine_kernel(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               const int* __restrict__ offset,
                               const int* __restrict__ left_pad,
                               float* __restrict__ out, int NS, int BH, int G,
                               int C, int D) {
  const int r = blockIdx.x, bh = blockIdx.y;
  const int off = offset[bh], lp = left_pad[bh];
  float M = -INFINITY;
  for (int s = 0; s < NS; ++s) {
    int lo, hi;
    live_range(s, off, lp, C, lo, hi);
    if (lo < hi) M = fmaxf(M, part_ml[(((size_t)s * BH + bh) * G + r) * 3]);
  }
  float L = 0.f, bias = 0.f;
  for (int s = 0; s < NS; ++s) {
    int lo, hi;
    live_range(s, off, lp, C, lo, hi);
    if (lo >= hi) continue;
    const float* ml = part_ml + (((size_t)s * BH + bh) * G + r) * 3;
    const float w = expf(ml[0] - M);
    L += ml[1] * w;
    bias += ml[2] * w;
  }
  const float denom = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < NS; ++s) {
      int lo, hi;
      live_range(s, off, lp, C, lo, hi);
      if (lo >= hi) continue;
      const size_t row = ((size_t)s * BH + bh) * G + r;
      acc += part_acc[row * D + d] * expf(part_ml[row * 3] - M);
    }
    out[((size_t)bh * G + r) * D + d] = (acc + bias) / denom;
  }
}

}  // namespace
}  // namespace kvd
