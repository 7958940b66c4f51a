// K5: mlx group-affine linears, y = x @ dequant(W)^T, 4- or 8-bit codes.
//
// Replaces mlx_vlm_tpu/ops/qmatmul.py:_qmm_2d (Pallas kernels _qmm4_kernel
// and _qmm8_kernel).  x [M, K] bf16; W in the mlx byte layout: q [N, K*BITS/8]
// uint8 (4-bit: byte j of a row holds code 2j in its low nibble and code 2j+1
// in its high nibble; 8-bit: one code per byte); scales and biases
// [N, K/group] bf16, group in {32, 64, 128}; y [M, N] bf16.
//
// Numerics: the reference dequantizes code*s + b in f32 and multiplies in
// f32 over the whole of K, rounding once to bf16.  This kernel factors each
// group instead:  sum_{k in grp} x*(q*s + b) = s * sum x*q + b * sum x.
// Codes 0..255 are exact in bf16 and a bf16 x times a code is exact in f32,
// so x*q runs with no rounding of the weight (tensor cores with f32
// accumulators on the GEMM route, f32 FMAs on the GEMV route); the group
// partial is scaled by the f32-widened s and b multiplies the f32 sum of x
// over the group.  The result equals the reference's up to f32
// reassociation, then one rounding to bf16.  (K1 differs: it rounds
// code*s + b to bf16 before its MMA, as its reference does.)
//
// Two routes in one launch entry point:
// - M <= 8 (decode steps, the prefill lm_head row): bound by device-memory
//   bandwidth; at Qwen2-VL-7B one exact decode step's linears and head read
//   about 3.98 GB at 4 bits (about 1.19 ms at 3.35 TB/s) and 7.5 GB at 8
//   bits (2.2 ms), scales and biases included (reckoned from the shapes;
//   the measured times are in PERF.md).  Each output row is a
//   contiguous K*BITS/8-byte stream, so a block of 128 threads owns 4 output
//   rows and strides over their 16-byte chunks (one chunk lies in one group
//   for every group size taken), loading x once per chunk for the 4 rows;
//   partials reduce by warp shuffles and then across the 4 warps.  With
//   N = 512 (k/v projections) only 128 blocks run, fewer than the card's
//   132 SMs.
// - M > 8 (prefill chunks): bound by tensor-core operations (2*M*N*K at
//   989 TFLOP/s bf16).  A block owns 64 rows of x and 128 output rows and
//   walks K in steps of 32 codes (the smallest group).  x and the unpacked
//   codes (as bf16) are staged in shared memory, with the next step's global
//   loads held in registers while the current step computes; eight warps run
//   mma.sync m16n8k16 into per-group partials that are folded into the f32
//   accumulators with the group's scale and bias at each group's end.
//   No cp.async / TMA / wgmma yet: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ GEMM route

constexpr int BM = 64;        // rows of x per block
constexpr int BN = 128;       // output rows (of W) per block
constexpr int BK = 32;        // codes of K per step (the smallest group)
constexpr int THREADS = 256;  // 8 warps: 2 (m) x 4 (n), each 32 x 32
constexpr int XS = BK + 8;    // bf16 per x row in smem (20 words: no conflicts)
constexpr int WS = BK + 8;    // bf16 per W row in smem

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// 16 code bytes -> bf16 codes in 4 (8-bit) or 8 (4-bit) 32-bit words, in K
// order (lower K at the lower address)
template <int BITS>
__device__ __forceinline__ void unpack_codes(const uint4 q, uint32_t* out) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 16 * 8 / BITS / 2; ++i) {
    if (BITS == 4) {
      const uint32_t byte = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
      out[i] = pack_bf16((float)(byte & 0xFu), (float)(byte >> 4));
    } else {
      const uint32_t pair = (w[i / 2] >> (16 * (i % 2))) & 0xFFFFu;
      out[i] = pack_bf16((float)(pair & 0xFFu), (float)(pair >> 8));
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
           const __nv_bfloat16* __restrict__ scales,
           const __nv_bfloat16* __restrict__ biases,
           __nv_bfloat16* __restrict__ y, int M, int K, int N,
           int group_size) {
  constexpr int QV = BK * BITS / 8 / 16;  // 16-byte code vectors per W row
  __shared__ __align__(16) __nv_bfloat16 xs[BM * XS];
  __shared__ __align__(16) __nv_bfloat16 ws[BN * WS];  // [n][k]
  __shared__ float xsum[BM];         // sum of x over the current group
  __shared__ float gs[BN], gb[BN];   // the current group's scale and bias

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm = warp / 4, wn = warp % 4;
  const size_t row_bytes = (size_t)K * BITS / 8;
  const int G = K / group_size;
  const int steps = K / BK, per_group = group_size / BK;

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = part[a][b][c] = 0.f;

  // this thread's share of a step's loads: one 8-bf16 vector of x (row
  // tid / 4), one 16-byte code vector (W row tid / QV) and, at a group's
  // first step, one scale / bias pair (W row tid)
  const int xr_row = tid / 4, xr_col = (tid % 4) * 8;
  const int qr_row = tid / QV, qr_part = tid % QV;
  uint4 xr, qr;
  float sr = 0.f, br = 0.f;
  auto load = [&](int step) {
    const int k0 = step * BK;
    xr = make_uint4(0, 0, 0, 0);
    if (m0 + xr_row < M)
      xr = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + xr_row) * K +
                                           k0 + xr_col);
    qr = make_uint4(0, 0, 0, 0);
    if (qr_row < BN && n0 + qr_row < N)
      qr = *reinterpret_cast<const uint4*>(q + (size_t)(n0 + qr_row) * row_bytes +
                                           (size_t)k0 * BITS / 8 + qr_part * 16);
    if (step % per_group == 0 && tid < BN && n0 + tid < N) {
      const size_t i = (size_t)(n0 + tid) * G + step / per_group;
      sr = __bfloat162float(scales[i]);
      br = __bfloat162float(biases[i]);
    }
  };

  load(0);
  for (int step = 0; step < steps; ++step) {
    // stage this step: x as is, codes unpacked to bf16, the row sums of x
    *reinterpret_cast<uint4*>(xs + xr_row * XS + xr_col) = xr;
    {
      const uint32_t w[4] = {xr.x, xr.y, xr.z, xr.w};
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += bf16_lo(w[i]) + bf16_hi(w[i]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (tid % 4 == 0)
        xsum[xr_row] = (step % per_group == 0) ? s : xsum[xr_row] + s;
    }
    if (qr_row < BN) {
      uint32_t words[16 * 8 / BITS / 2];
      unpack_codes<BITS>(qr, words);
      uint4* dst = reinterpret_cast<uint4*>(ws + qr_row * WS +
                                            qr_part * (16 * 8 / BITS));
#pragma unroll
      for (int v = 0; v < 16 * 8 / BITS / 8; ++v)
        dst[v] = make_uint4(words[4 * v], words[4 * v + 1], words[4 * v + 2],
                            words[4 * v + 3]);
    }
    if (step % per_group == 0 && tid < BN) {
      gs[tid] = sr;
      gb[tid] = br;
    }
    __syncthreads();
    if (step + 1 < steps) load(step + 1);  // in flight during the MMAs

    const uint32_t* xsw = reinterpret_cast<const uint32_t*>(xs);
    const uint32_t* wsw = reinterpret_cast<const uint32_t*>(ws);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        a[mt][0] = xsw[(r * XS) / 2 + kk * 8 + t];
        a[mt][1] = xsw[((r + 8) * XS) / 2 + kk * 8 + t];
        a[mt][2] = xsw[(r * XS) / 2 + kk * 8 + 4 + t];
        a[mt][3] = xsw[((r + 8) * XS) / 2 + kk * 8 + 4 + t];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + g;
        const uint32_t b0 = wsw[(col * WS) / 2 + kk * 8 + t];
        const uint32_t b1 = wsw[(col * WS) / 2 + kk * 8 + 4 + t];
        mma_bf16(part[0][nt], a[0], b0, b1);
        mma_bf16(part[1][nt], a[1], b0, b1);
      }
    }
    if ((step + 1) % per_group == 0) {  // the group ends: fold its partials
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
            const int c = wn * 32 + nt * 8 + 2 * t + (e & 1);
            acc[mt][nt][e] = fmaf(gs[c], part[mt][nt][e],
                                  fmaf(gb[c], xsum[r], acc[mt][nt][e]));
            part[mt][nt][e] = 0.f;
          }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + nt * 8 + 2 * t + (e & 1);
        if (row < M && col < N)
          y[(size_t)row * N + col] = __float2bfloat16_rn(acc[mt][nt][e]);
      }
}

// ------------------------------------------------------------ GEMV route

constexpr int MV_THREADS = 128;  // 4 warps
constexpr int MV_ROWS = 4;       // output rows per block

template <int BITS, int M>
__global__ void __launch_bounds__(MV_THREADS)
qmv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
           const __nv_bfloat16* __restrict__ scales,
           const __nv_bfloat16* __restrict__ biases,
           __nv_bfloat16* __restrict__ y, int K, int N, int group_size) {
  constexpr int CODES = 16 * 8 / BITS;  // codes per 16-byte chunk: 32 or 16
  __shared__ float red[MV_THREADS / 32][M * MV_ROWS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * MV_ROWS;
  const size_t row_bytes = (size_t)K * BITS / 8;
  const int chunks = (int)(row_bytes / 16);
  const int G = K / group_size;

  float acc[M][MV_ROWS];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) acc[m][r] = 0.f;

  for (int c = tid; c < chunks; c += MV_THREADS) {
    const int k0 = c * CODES;
    const int grp = k0 / group_size;  // the whole chunk lies in this group
    uint4 w[MV_ROWS];
    float s[MV_ROWS], b[MV_ROWS];
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) {
      const int n = n0 + r;
      w[r] = make_uint4(0, 0, 0, 0);
      s[r] = b[r] = 0.f;
      if (n < N) {
        w[r] = *reinterpret_cast<const uint4*>(q + (size_t)n * row_bytes +
                                               (size_t)c * 16);
        s[r] = __bfloat162float(scales[(size_t)n * G + grp]);
        b[r] = __bfloat162float(biases[(size_t)n * G + grp]);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float xv[CODES];
      const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)m * K + k0);
#pragma unroll
      for (int v = 0; v < CODES / 8; ++v) {
        const uint4 u = xp[v];
        const uint32_t uw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xv[8 * v + 2 * i] = bf16_lo(uw[i]);
          xv[8 * v + 2 * i + 1] = bf16_hi(uw[i]);
        }
      }
      float xsum = 0.f;
#pragma unroll
      for (int i = 0; i < CODES; ++i) xsum += xv[i];
#pragma unroll
      for (int r = 0; r < MV_ROWS; ++r) {
        const uint32_t ww[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < CODES; ++i) {
          const uint32_t code =
              BITS == 4 ? (ww[i / 8] >> (4 * (i % 8))) & 0xFu
                        : (ww[i / 4] >> (8 * (i % 4))) & 0xFFu;
          dot = fmaf(xv[i], (float)code, dot);
        }
        acc[m][r] = fmaf(s[r], dot, fmaf(b[r], xsum, acc[m][r]));
      }
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) {
      float v = acc[m][r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][m * MV_ROWS + r] = v;
    }
  __syncthreads();
  if (tid < M * MV_ROWS) {
    const int m = tid / MV_ROWS, n = n0 + tid % MV_ROWS;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < MV_THREADS / 32; ++wi) v += red[wi][tid];
    if (n < N) y[(size_t)m * N + n] = __float2bfloat16_rn(v);
  }
}

template <int BITS>
cudaError_t launch(const __nv_bfloat16* x, const uint8_t* q,
                   const __nv_bfloat16* s, const __nv_bfloat16* b,
                   __nv_bfloat16* y, int M, int K, int N, int group_size,
                   cudaStream_t st) {
  if (M > 8) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    qmm_kernel<BITS><<<grid, THREADS, 0, st>>>(x, q, s, b, y, M, K, N,
                                               group_size);
    return cudaGetLastError();
  }
  const int blocks = (N + MV_ROWS - 1) / MV_ROWS;
#define MVT_QMV(MR)                                                       \
  case MR:                                                                \
    qmv_kernel<BITS, MR><<<blocks, MV_THREADS, 0, st>>>(x, q, s, b, y, K, \
                                                        N, group_size);   \
    break;
  switch (M) {
    MVT_QMV(1) MVT_QMV(2) MVT_QMV(3) MVT_QMV(4)
    MVT_QMV(5) MVT_QMV(6) MVT_QMV(7) MVT_QMV(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MVT_QMV
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 (16-byte aligned rows); q [N, K*bits/8] u8; scales and
// biases [N, K/group_size] bf16; y [M, N] bf16.  bits in {4, 8}; group_size
// in {32, 64, 128}; K a multiple of 2 * group_size (4-bit) or of group_size
// (8-bit).  The wrapper checks all of it.
extern "C" int mvt_qmatmul(const void* x, const void* q, const void* scales,
                           const void* biases, void* y, int M, int K, int N,
                           int bits, int group_size, void* stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* bp = static_cast<const __nv_bfloat16*>(biases);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || group_size % BK || K % group_size) return (int)cudaErrorInvalidValue;
  if (bits == 4) return (int)launch<4>(xp, qp, sp, bp, yp, M, K, N, group_size, st);
  if (bits == 8) return (int)launch<8>(xp, qp, sp, bp, yp, M, K, N, group_size, st);
  return (int)cudaErrorInvalidValue;
}
