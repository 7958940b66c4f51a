// K6: decode attention over a per-token-affine 4-bit KV cache.
//
// Replaces mlx_vlm_tpu/ops/int4_kv_attention.py:int4_kv_decode_attention
// (Pallas kernel _kernel).  For each (row, KV head) bh, its g query rows
// arrive as int8 codes q8 [BH, g, D] with (sum q8, qs) in qmeta [BH, g, 2];
// the cache holds codes k4/v4 [BH, C, D/2] (dims [0, D/2) in the low nibble,
// [D/2, D) in the high one) and per-token f32 scale/bias ks, kb, vs, vb
// [BH, C].  Column c is visible when left_pad <= c < offset.  Then
//   score_c = qs * (ks_c * (q8 . k4_c) + kb_c * sum(q8)) * scale,
//   out = (sum_c bf16(p_c * vs_c) * v4_c + sum_c p_c * vb_c) / max(sum p, 1e-30)
// with p = exp(score - max) -- the reference's contract.
//
// Bound on the H100: device-memory bytes.  A decode step reads D/2 code
// bytes and two f32 scales for K and for V per visible token and KV head
// (144 bytes at D = 128) and does ~2 * g * D operations per token, far
// below the ~295 operations per byte where compute would bind.  At
// Qwen2-VL-7B's 4 KV heads one block per head would leave 128 of 132 SMs
// idle, so the history is split into blocks of 128 tokens (see
// kv_decode_common.cuh) and each block serves all g query rows of its KV
// head, reading every code byte once.  The score dot is exact: nibbles are
// unpacked four at a time and summed against the int8 query with __dp4a.
// Scores go to shared memory, one warp per row takes its block softmax,
// and for the value side one thread per output dim walks the block's
// tokens.

#include "kv_decode_common.cuh"

namespace {

using kvd::ROWS;
using kvd::TC;
using kvd::THREADS;

__global__ void __launch_bounds__(THREADS)
int4_kv_split_kernel(const int8_t* __restrict__ q8,
                     const float* __restrict__ qmeta,
                     const uint8_t* __restrict__ k4,
                     const float* __restrict__ ks,
                     const float* __restrict__ kb,
                     const uint8_t* __restrict__ v4,
                     const float* __restrict__ vs,
                     const float* __restrict__ vb,
                     const int* __restrict__ offset,
                     const int* __restrict__ left_pad,
                     float* __restrict__ part_ml,
                     float* __restrict__ part_acc, int BH, int G, int C,
                     int D, float scale) {
  __shared__ float p[ROWS][TC];   // scores, then probabilities
  __shared__ float pv[ROWS][TC];  // bf16(p * vs)

  const int s = blockIdx.x, bh = blockIdx.y, r0 = blockIdx.z * ROWS;
  const int R = min(ROWS, G - r0);
  int lo, hi;
  kvd::live_range(s, offset[bh], left_pad[bh], C, lo, hi);
  if (lo >= hi) return;  // nothing visible: the combine skips this split

  const int h = D / 2, tid = threadIdx.x;
  const size_t tok0 = (size_t)bh * C;  // this head's first token
  const int c = s * TC + tid;
  const bool live = c >= lo && c < hi;
  const int8_t* qrows = q8 + ((size_t)bh * G + r0) * D;

  // ---- scores, one thread per token: exact integer dots
  int isum[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) isum[r] = 0;
  if (live) {
    const uint8_t* krow = k4 + (tok0 + c) * h;
    if ((h & 3) == 0) {  // rows are 4-byte aligned: four nibbles per __dp4a
      const uint32_t* kw = reinterpret_cast<const uint32_t*>(krow);
      for (int w = 0; w < h / 4; ++w) {
        const uint32_t x = __ldg(kw + w);
        const int klo = (int)(x & 0x0F0F0F0Fu);
        const int khi = (int)((x >> 4) & 0x0F0F0F0Fu);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < R) {
            const int* qw = reinterpret_cast<const int*>(qrows + r * D);
            isum[r] = __dp4a(__ldg(qw + w), klo, isum[r]);
            isum[r] = __dp4a(__ldg(qw + h / 4 + w), khi, isum[r]);
          }
        }
      }
    } else {
      for (int j = 0; j < h; ++j) {
        const int x = krow[j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < R)
            isum[r] += qrows[r * D + j] * (x & 15) +
                       qrows[r * D + h + j] * (x >> 4);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < R) {
      float sc = -INFINITY;
      if (live) {
        const float* meta = qmeta + ((size_t)bh * G + r0 + r) * 2;
        sc = ((float)isum[r] * ks[tok0 + c] + meta[0] * kb[tok0 + c]) *
             meta[1] * scale;
      }
      p[r][tid] = sc;
    }
  }
  __syncthreads();

  float* ml = part_ml + (((size_t)s * BH + bh) * G + r0) * 3;
  kvd::block_softmax(p, pv, nullptr, 1, vs + tok0, nullptr, vb + tok0, R, s,
                     lo, hi, ml);
  __syncthreads();

  // ---- values, one thread per output dim over the block's live tokens
  for (int d = tid; d < D; d += THREADS) {
    const int col = d < h ? d : d - h, shift = d < h ? 0 : 4;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int cc = lo; cc < hi; ++cc) {
      const float code = (float)((v4[(tok0 + cc) * h + col] >> shift) & 15);
      const int i = cc - s * TC;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] += pv[r][i] * code;
    }
    float* dst = part_acc + (((size_t)s * BH + bh) * G + r0) * D + d;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < R) dst[(size_t)r * D] = acc[r];
  }
}

}  // namespace

// q8 int8 [BH, G, D]; qmeta f32 [BH, G, 2]; k4/v4 u8 [BH, C, D/2]; ks, kb,
// vs, vb f32 [BH, C]; offset, left_pad int32 [BH]; scratch part_ml f32
// [NS, BH, G, 3] and part_acc f32 [NS, BH, G, D] with NS = ceil(C / 128);
// out f32 [BH, G, D].  D even.  Two launches: the split pass and the
// combine.
extern "C" int mvt_int4_kv_attention(
    const void* q8, const void* qmeta, const void* k4, const void* ks,
    const void* kb, const void* v4, const void* vs, const void* vb,
    const void* offset, const void* left_pad, void* part_ml, void* part_acc,
    void* out, int BH, int G, int C, int D, float scale, void* stream) {
  const int NS = (C + TC - 1) / TC;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(NS, BH, (G + ROWS - 1) / ROWS);
  int4_kv_split_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(qmeta),
      static_cast<const uint8_t*>(k4), static_cast<const float*>(ks),
      static_cast<const float*>(kb), static_cast<const uint8_t*>(v4),
      static_cast<const float*>(vs), static_cast<const float*>(vb),
      static_cast<const int*>(offset), static_cast<const int*>(left_pad),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), BH, G, C,
      D, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kvd::combine_kernel<<<dim3(G, BH), 128, 0, st>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<const int*>(offset), static_cast<const int*>(left_pad),
      static_cast<float*>(out), NS, BH, G, C, D);
  return (int)cudaGetLastError();
}
