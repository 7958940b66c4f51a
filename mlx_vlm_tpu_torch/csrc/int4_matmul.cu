// K1: W4A16 GEMM for the halves-packed grouped-int4 layout (prefill linears).
//
// Replaces mlx_vlm_tpu/ops/int4_matvec.py:_int4_matmul (Pallas kernel _mm_kern).
// y = x @ dequant(W) for x [M, K] bf16 and W in the Int4GroupedTensor layout
// (qp [K, N2p] uint8: low nibble -> column j, high nibble -> column N2p + j;
// sl/sh/bl/bh [G, N2p] f32).  Each weight is dequantized as code * s + b in
// f32 and rounded to bf16 (the reference's `.astype(x.dtype)`), products
// accumulate in f32, and the output is rounded to bf16 and sliced to n.
//
// Bound on the H100: tensor-core throughput at prefill sizes (M = 512 rows
// per chunk gives ~512 operations per weight byte, above the card's
// ~295 bf16 operations per byte of device memory).
// Design: a block owns a 64-row tile of x and 64 packed columns, i.e. 128
// output columns (64 of the low plane, 64 of the high plane).  It walks K one
// quantization group (64 rows) at a time: x and the packed bytes are staged
// in shared memory, the weights are dequantized once per block into a bf16
// tile stored column-major (so the MMA's B fragments are single 32-bit
// loads), and four warps run mma.sync m16n8k16 bf16 with f32 accumulators
// held in registers for the whole K loop.  There is no software pipelining
// yet: loads and MMAs alternate behind __syncthreads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // rows of x per block
constexpr int BN = 64;              // packed columns per block (128 outputs)
constexpr int BK = 64;              // K rows per step: one group
constexpr int THREADS = 128;        // 4 warps: 2 (rows) x 2 (planes)
constexpr int XS = BK + 8;          // bf16 per x row in smem (36 words)
constexpr int WS = BK + 8;          // bf16 per weight column in smem
constexpr int QS = BN + 16;         // bytes per packed row in smem

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

__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ qp,
                   const float* __restrict__ sl, const float* __restrict__ sh,
                   const float* __restrict__ bl, const float* __restrict__ bh,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N2p,
                   int n) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM * XS];
  __shared__ __align__(16) __nv_bfloat16 ws[2 * BN * WS];  // [column][k]
  __shared__ __align__(16) uint8_t qs[BK * QS];
  __shared__ float sc[4][BN];  // s_lo, s_hi, b_lo, b_hi of this group

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * BN;  // first packed column
  const int m0 = blockIdx.y * BM;
  const int wm = warp / 2;         // rows wm*32 .. +32
  const int wn = warp % 2;         // plane: columns wn*64 .. +64 of the tile

  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  const int G = K / BK;
  for (int grp = 0; grp < G; ++grp) {
    const int k0 = grp * BK;
    // x tile: 64 rows x 8 vectors of 8 bf16
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {
      const int v = tid + i * THREADS, r = v / 8, cv = v % 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 +
                                              cv * 8);
      *reinterpret_cast<uint4*>(xs + r * XS + cv * 8) = val;
    }
    // packed tile: 64 rows x 4 vectors of 16 bytes
#pragma unroll
    for (int i = 0; i < (BK * BN / 16) / THREADS; ++i) {
      const int v = tid + i * THREADS, r = v / 4, cv = v % 4;
      *reinterpret_cast<uint4*>(qs + r * QS + cv * 16) =
          *reinterpret_cast<const uint4*>(qp + (size_t)(k0 + r) * N2p + n0 +
                                          cv * 16);
    }
    for (int i = tid; i < 4 * BN; i += THREADS) {
      const int a = i / BN, j = i % BN;
      const float* src = a == 0 ? sl : a == 1 ? sh : a == 2 ? bl : bh;
      sc[a][j] = src[(size_t)grp * N2p + n0 + j];
    }
    __syncthreads();

    // dequantize: thread owns k pair (2kp, 2kp+1) and 16 packed columns
    {
      const int kp = tid % 32, nb = tid / 32;
      const uint4 r0 = *reinterpret_cast<const uint4*>(qs + (2 * kp) * QS + nb * 16);
      const uint4 r1 = *reinterpret_cast<const uint4*>(qs + (2 * kp + 1) * QS + nb * 16);
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
      const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
      uint32_t* wsw = reinterpret_cast<uint32_t*>(ws);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int j = nb * 16 + c;
        const uint32_t q0 = (w0[c / 4] >> (8 * (c % 4))) & 0xFFu;
        const uint32_t q1 = (w1[c / 4] >> (8 * (c % 4))) & 0xFFu;
        const float slo = sc[0][j], shi = sc[1][j], blo = sc[2][j], bhi = sc[3][j];
        wsw[(j * WS) / 2 + kp] = pack_bf16((float)(q0 & 0xFu) * slo + blo,
                                           (float)(q1 & 0xFu) * slo + blo);
        wsw[((BN + j) * WS) / 2 + kp] = pack_bf16((float)(q0 >> 4) * shi + bhi,
                                                  (float)(q1 >> 4) * shi + bhi);
      }
    }
    __syncthreads();

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
      for (int nt = 0; nt < 8; ++nt) {
        const int col = wn * 64 + nt * 8 + g;
        const uint32_t b0 = wsw[(col * WS) / 2 + kk * 8 + t];
        const uint32_t b1 = wsw[(col * WS) / 2 + kk * 8 + 4 + t];
        mma_bf16(acc[0][nt], a[0], b0, b1);
        mma_bf16(acc[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: tile column wn*64 + nt*8 + 2t (+1) is plane wn, packed column
  // n0 + nt*8 + 2t (+1); global column = wn * N2p + packed column
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = wn * N2p + n0 + nt * 8 + 2 * t + (e & 1);
        if (row < M && col < n)
          y[(size_t)row * n + col] = __float2bfloat16_rn(acc[mt][nt][e]);
      }
    }
  }
}

}  // namespace

// x [M, K] bf16; qp [K, N2p] u8; s/b planes [G, N2p] f32 with group 64;
// y [M, n] bf16.  N2p % 64 == 0, K % 64 == 0, K % 8 == 0 for 16-byte rows.
extern "C" int mvt_int4_matmul(const void* x, const void* qp, const void* sl,
                               const void* sh, const void* bl, const void* bh,
                               void* y, int M, int K, int N2p, int n,
                               void* stream) {
  dim3 grid(N2p / BN, (M + BM - 1) / BM), block(THREADS);
  int4_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qp),
      static_cast<const float*>(sl), static_cast<const float*>(sh),
      static_cast<const float*>(bl), static_cast<const float*>(bh),
      static_cast<__nv_bfloat16*>(y), M, K, N2p, n);
  return (int)cudaGetLastError();
}
