// K7 and K8: decode attention over TurboQuant (rotated Lloyd-Max) KV codes.
//
// Replaces mlx_vlm_tpu/ops/tq_kv_attention.py:tq_kv_decode_attention
// (Pallas kernel _kernel, helper _decode_tile) with one segment, and
// :tq_kv_decode_attention_split (kernel _split_kernel) with two.  A segment
// covers Dseg consecutive rotated dims with its own codes kq/vq
// [BH, C, Dseg*bits/8], per-token scales ks/vs [BH, C] and code tables.
// Codes use core/turboquant.py's strided bit-plane layout: with
// w = Dseg / 8, dim j = i*w + m is bit i of byte m of each of the `bits`
// planes (8-bit codes are raw bytes).  A code decodes to bf16(lut[code]);
// the rotated query is rounded to bf16.  Column c is visible when
// left_pad <= c < offset, and
//   score_c = (sum_seg (q_seg . k_seg,c) * ks_seg,c) * scale,
//   out_seg = sum_c bf16(p_c * vs_seg,c) v_seg,c / max(sum p, 1e-30)
// with p = exp(score - max): the reference's contract for both kernels.
//
// Bound on the H100: device-memory bytes (at kv_bits 3.5 and D = 128,
// 112 code bytes and 8 scale bytes per visible token and KV head).  The
// TPU kernel materializes lut[code] with a select tree because Mosaic has
// no gather; here the tables (at most 256 entries) sit in shared memory and
// a code indexes them.  As in K6 the history is split into blocks of 128
// tokens (kv_decode_common.cuh), and each block serves all g query rows of
// its KV head, decoding each code byte once: in the score pass one thread
// per token walks its code row byte by byte, and in the value pass one
// thread per output dim walks the block's tokens.

#include "kv_decode_common.cuh"

namespace {

using kvd::ROWS;
using kvd::TC;
using kvd::THREADS;

constexpr int MAX_LUT = 256;  // 8-bit codes

struct Segment {
  const uint8_t* kq;
  const float* ks;
  const uint8_t* vq;
  const float* vs;
  const float* klut;
  const float* vlut;
  int d, kbits, vbits;
};

struct TqArgs {
  const float* q;  // [BH, G, D] rotated query rows
  Segment seg[2];
  int nseg;
  const int* offset;
  const int* left_pad;
  float* part_ml;
  float* part_acc;
  int BH, G, C, D;
  float scale;
};

// Row width in bytes of Dseg codes of `bits` bits.
__device__ __forceinline__ int code_width(int d, int bits) {
  return d * bits / 8;
}

// Code of dim j of one token's code row (strided bit-plane layout).
__device__ __forceinline__ int code_at(const uint8_t* row, int d, int bits,
                                       int j) {
  if (bits == 8) return row[j];
  const int w = d / 8, m = j % w, i = j / w;
  int code = 0;
  for (int b = 0; b < bits; ++b) code |= ((row[b * w + m] >> i) & 1) << b;
  return code;
}

// __grid_constant__: the segments are indexed at run time without copying
// the parameters to local memory.
__global__ void __launch_bounds__(THREADS)
tq_split_kernel(const __grid_constant__ TqArgs a) {
  extern __shared__ float q_sm[];       // [R][D] bf16-rounded query
  __shared__ float lut[2][2][MAX_LUT];  // [segment][k, v], bf16-rounded
  __shared__ float p[ROWS][TC];
  __shared__ float pv[2][ROWS][TC];     // bf16(p * vs) per segment

  const int s = blockIdx.x, bh = blockIdx.y, r0 = blockIdx.z * ROWS;
  const int R = min(ROWS, a.G - r0), D = a.D, C = a.C;
  int lo, hi;
  kvd::live_range(s, a.offset[bh], a.left_pad[bh], C, lo, hi);
  if (lo >= hi) return;  // nothing visible: the combine skips this split

  const int tid = threadIdx.x;
  const size_t tok0 = (size_t)bh * C;
  for (int i = tid; i < R * D; i += THREADS)
    q_sm[i] = kvd::bf16r(a.q[((size_t)bh * a.G + r0) * D + i]);
  for (int g = 0; g < a.nseg; ++g) {
    const Segment& sg = a.seg[g];
    for (int i = tid; i < (1 << sg.kbits); i += THREADS)
      lut[g][0][i] = kvd::bf16r(sg.klut[i]);
    for (int i = tid; i < (1 << sg.vbits); i += THREADS)
      lut[g][1][i] = kvd::bf16r(sg.vlut[i]);
  }
  __syncthreads();

  // ---- scores, one thread per token
  const int c = s * TC + tid;
  const bool live = c >= lo && c < hi;
  float score[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) score[r] = 0.f;
  if (live) {
    int dim0 = 0;
    for (int g = 0; g < a.nseg; ++g) {
      const Segment& sg = a.seg[g];
      const int bits = sg.kbits;
      const uint8_t* row = sg.kq + (tok0 + c) * code_width(sg.d, bits);
      float dot[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dot[r] = 0.f;
      if (bits == 8) {
        for (int j = 0; j < sg.d; ++j) {
          const float val = lut[g][0][row[j]];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (r < R) dot[r] += q_sm[r * D + dim0 + j] * val;
        }
      } else {
        const int w = sg.d / 8;
        for (int m = 0; m < w; ++m) {
          int code[8];  // the codes of dims i*w + m, built plane by plane
#pragma unroll
          for (int i = 0; i < 8; ++i) code[i] = 0;
          for (int b = 0; b < bits; ++b) {
            const int byte = row[b * w + m];
#pragma unroll
            for (int i = 0; i < 8; ++i) code[i] |= ((byte >> i) & 1) << b;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float val = lut[g][0][code[i]];
            const int j = dim0 + i * w + m;
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              if (r < R) dot[r] += q_sm[r * D + j] * val;
          }
        }
      }
      const float kscale = sg.ks[tok0 + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) score[r] += dot[r] * kscale;
      dim0 += sg.d;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (r < R) p[r][tid] = live ? score[r] * a.scale : -INFINITY;
  __syncthreads();

  float* ml = a.part_ml + (((size_t)s * a.BH + bh) * a.G + r0) * 3;
  kvd::block_softmax(p, pv[0], pv[1], a.nseg, a.seg[0].vs + tok0,
                     a.nseg > 1 ? a.seg[1].vs + tok0 : nullptr, nullptr, R,
                     s, lo, hi, ml);
  __syncthreads();

  // ---- values, one thread per output dim over the block's live tokens
  for (int d = tid; d < D; d += THREADS) {
    const int g = (a.nseg > 1 && d >= a.seg[0].d) ? 1 : 0;
    const Segment& sg = a.seg[g];
    const int j = d - (g ? a.seg[0].d : 0);
    const int width = code_width(sg.d, sg.vbits);
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int cc = lo; cc < hi; ++cc) {
      const float val =
          lut[g][1][code_at(sg.vq + (tok0 + cc) * width, sg.d, sg.vbits, j)];
      const int i = cc - s * TC;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] += pv[g][r][i] * val;
    }
    float* dst = a.part_acc + (((size_t)s * a.BH + bh) * a.G + r0) * D + d;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < R) dst[(size_t)r * D] = acc[r];
  }
}

}  // namespace

// q f32 [BH, G, D]; for each of nseg (1: K7, 2: K8) segments its codes
// kq/vq u8 [BH, C, d*bits/8], scales ks/vs f32 [BH, C] and code tables
// klut/vlut f32 [2**bits]; offset, left_pad int32 [BH]; scratch part_ml f32
// [NS, BH, G, 3] and part_acc f32 [NS, BH, G, D] with NS = ceil(C / 128);
// out f32 [BH, G, D].  Segment dims are multiples of 8 and sum to D.  Two
// launches: the split pass and the combine.
extern "C" int mvt_tq_kv_attention(
    const void* q, const void* kq0, const void* ks0, const void* vq0,
    const void* vs0, const void* klut0, const void* vlut0, const void* kq1,
    const void* ks1, const void* vq1, const void* vs1, const void* klut1,
    const void* vlut1, const void* offset, const void* left_pad,
    void* part_ml, void* part_acc, void* out, int d0, int kbits0, int vbits0,
    int d1, int kbits1, int vbits1, int nseg, int BH, int G, int C,
    float scale, void* stream) {
  TqArgs a;
  a.q = static_cast<const float*>(q);
  const void* ptrs[2][6] = {{kq0, ks0, vq0, vs0, klut0, vlut0},
                            {kq1, ks1, vq1, vs1, klut1, vlut1}};
  const int dims[2][3] = {{d0, kbits0, vbits0}, {d1, kbits1, vbits1}};
  for (int g = 0; g < 2; ++g) {
    a.seg[g].kq = static_cast<const uint8_t*>(ptrs[g][0]);
    a.seg[g].ks = static_cast<const float*>(ptrs[g][1]);
    a.seg[g].vq = static_cast<const uint8_t*>(ptrs[g][2]);
    a.seg[g].vs = static_cast<const float*>(ptrs[g][3]);
    a.seg[g].klut = static_cast<const float*>(ptrs[g][4]);
    a.seg[g].vlut = static_cast<const float*>(ptrs[g][5]);
    a.seg[g].d = dims[g][0];
    a.seg[g].kbits = dims[g][1];
    a.seg[g].vbits = dims[g][2];
  }
  a.nseg = nseg;
  a.offset = static_cast<const int*>(offset);
  a.left_pad = static_cast<const int*>(left_pad);
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.BH = BH;
  a.G = G;
  a.C = C;
  a.D = d0 + (nseg > 1 ? d1 : 0);
  a.scale = scale;

  const int NS = (C + TC - 1) / TC;
  const size_t q_bytes = (size_t)min(ROWS, G) * a.D * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bytes > 32 * 1024) {  // beside 16 KB of static shared memory
    cudaError_t err = cudaFuncSetAttribute(
        tq_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)q_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(NS, BH, (G + ROWS - 1) / ROWS);
  tq_split_kernel<<<grid, THREADS, q_bytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kvd::combine_kernel<<<dim3(G, BH), 128, 0, st>>>(
      a.part_ml, a.part_acc, a.offset, a.left_pad, static_cast<float*>(out),
      NS, BH, G, C, a.D);
  return (int)cudaGetLastError();
}
