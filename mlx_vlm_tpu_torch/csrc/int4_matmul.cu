// K1: W4A16 GEMM for the halves-packed grouped-int4 layout (prefill linears).
//
// Replaces mlx_vlm_tpu/ops/int4_matvec.py:_int4_matmul (Pallas kernel
// _mm_kern).  y = x @ dequant(W) for x [M, K] bf16 and W in the
// Int4GroupedTensor layout (qp [K, N2p] uint8: low nibble -> column j, high
// nibble -> column N2p + j; sl/sh/bl/bh [G, N2p] f32, any group size g with
// g % 16 == 0 and K % g == 0).  Each weight is dequantized as code * s + b
// in f32 and rounded to bf16 (the reference's `.astype(x.dtype)`), products
// accumulate in f32, and the output is rounded once to bf16 and cut to n.
//
// What bounds it on the H100: the bound is tensor-core work.  A 512-row
// prefill chunk does ~512 operations per weight byte, above the card's ~295
// bf16 operations per byte of device memory, so the floor is the bf16 rate
// (989 TFLOP/s).  Four things stand between a W4A16 kernel and that rate,
// and the design answers each:
//
// - The dequantization is ALU work beside the tensor cores.  The operands
//   are swapped, y^T[n, m] = W[n, :] . x[m, :]^T, so that the weight is the
//   A operand of `wgmma.mma_async.m64nBMk16` and comes from REGISTERS: each
//   consumer thread turns its packed bytes straight into its A fragment
//   (code via the 2^23 float trick, one FMA with s and b, cvt.rn.bf16x2),
//   and the weight never returns to shared memory as bf16.  One packed byte
//   feeds two output columns: a block owns 64 packed columns; consumer
//   warpgroup 0 dequantizes their low nibbles and warpgroup 1 their high
//   nibbles, both against the same x tile, so every weight is dequantized
//   once per block.  The A row -> column map is permuted (A rows g and g+8
//   of a warp are packed columns 2g and 2g+1) so a thread reads its two
//   columns' bytes with one 16-bit load per k row.
// - The dequantization must overlap the products.  A consumer dequantizes a
//   whole 64-deep stage (four 16-k slices) into one A buffer while the
//   previous stage's four wgmmas run from the other (wgmma.wait_group 1);
//   the stage loop is unrolled by two so both buffers stay in registers.
// - Loads must overlap both.  One producer thread keeps a ring of stages in
//   flight with TMA: x (BM rows x 64 k, bf16, 128-byte swizzle, the K-major
//   B layout wgmma reads with no transpose), the packed bytes (64 k x 64
//   bytes, 64-byte swizzle, so the consumers' 16-bit reads are free of bank
//   conflicts) and, by cp.async.bulk, the scales and biases of each group
//   the stage touches.  Full/empty mbarriers pair producer and consumers
//   (one empty arrival per consumer warp); nothing waits on __syncthreads
//   after the start.  The producer's warpgroup hands its registers to the
//   consumers (setmaxnreg 40 / 232), which a 256-row tile's 128 f32
//   accumulators per thread need.
// - Narrow outputs leave SMs idle (the k/v projections, N = 512, give 16
//   tiles at M = 512).  The wrapper splits K into S slices (its rule:
//   ops/int4_matvec.py:int4_matmul_plan); each slice writes f32 partials
//   [S, M, n] and a second pass sums them in a fixed order and rounds once,
//   so the result does not depend on run order.
//
// What still holds it above the bound (PERF.md §6): the same pipeline with
// the dequantization taken out stays well above it too.  x is read from L2
// once per 128-output column block, 28 times over at N = 3584, so wider
// column tiles (two accumulators per consumer) are the next step; clusters
// that multicast x tiles to 2 or 4 column blocks were tried and were slower,
// their CTAs advancing in lockstep.
//
// Ragged edges: TMA fills x rows >= M and k >= K with zeros (the packed
// bytes past K too, and a stage's scale slot is clamped to the last group),
// the epilogue masks rows >= M and columns >= n.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BK = 64;          // k per stage
constexpr int BNP = 64;         // packed columns per block (128 outputs)
constexpr int MAX_STAGES = 8;
constexpr int MAXG = 4;         // groups one stage can touch (g = 16)
constexpr int CONSUMERS = 2;    // warpgroups: low plane, high plane
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup

template <int BM>
struct Layout {
  static constexpr int X_BYTES = BM * BK * 2;          // x tile, 128B swizzle
  static constexpr int Q_BYTES = BK * BNP;             // packed tile, 64B swizzle
  static constexpr int S_BYTES = MAXG * 4 * BNP * 4;   // [slot][sl sh bl bh][64]
  static constexpr int STAGE = X_BYTES + Q_BYTES + S_BYTES;
  // as many stages as ~160 KB of shared memory holds (one block per SM)
  static constexpr int STAGES = BM == 64 ? 8 : BM == 128 ? 6 : 4;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "stages must keep 1024-byte alignment");
};

// code * s + b in f32 for the nibble in bits [0, 4) of v: the code becomes
// a float exactly through the 2^23 exponent trick (no int-to-float unit).
__device__ __forceinline__ float deq(uint32_t v, float s, float b) {
  return fmaf(__uint_as_float(0x4B000000u | (v & 0xFu)) - 8388608.0f, s, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of one 16-k slice for one thread: packed columns jA (A row
// g) and jA + 1 (A row g + 8) of the plane that `shift` selects, k rows 2t,
// 2t+1, 2t+8, 2t+9 of the slice.  `q` points at the thread's byte pair in k
// row 2t of the slice (the 64-byte swizzle puts the four rows' pairs at the
// same column offset); `sc` at the group's scale of column jA.
__device__ __forceinline__ void dequant_slice(uint32_t (&a)[4],
                                              const uint8_t* q,
                                              const float* sc, int shift) {
  const uint32_t v0 = *reinterpret_cast<const uint16_t*>(q) >> shift;
  const uint32_t v1 = *reinterpret_cast<const uint16_t*>(q + 64) >> shift;
  const uint32_t v2 = *reinterpret_cast<const uint16_t*>(q + 8 * 64) >> shift;
  const uint32_t v3 = *reinterpret_cast<const uint16_t*>(q + 9 * 64) >> shift;
  const float2 s = *reinterpret_cast<const float2*>(sc);
  const float2 b = *reinterpret_cast<const float2*>(sc + 2 * BNP);
  a[0] = pack_bf16(deq(v0, s.x, b.x), deq(v1, s.x, b.x));
  a[1] = pack_bf16(deq(v0 >> 8, s.y, b.y), deq(v1 >> 8, s.y, b.y));
  a[2] = pack_bf16(deq(v2, s.x, b.x), deq(v3, s.x, b.x));
  a[3] = pack_bf16(deq(v2 >> 8, s.y, b.y), deq(v3 >> 8, s.y, b.y));
}

// Grid: (ceil(M / BM) row blocks, N2p / 64 column blocks, splits).  Warps
// 0-3 and 4-7 are the consumer warpgroups of the low and high plane; one
// thread of warpgroup 2 is the producer, and the warpgroup gives its
// registers to the consumers (setmaxnreg).  With splits > 1 the block
// writes f32 partials of its K slice to part[blockIdx.z], else bf16 to y.
template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
int4_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap qmap,
                   const float* __restrict__ sl, const float* __restrict__ sh,
                   const float* __restrict__ bl, const float* __restrict__ bh,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                   int M, int K, int N2p, int n, int g, int splits) {
  using L = Layout<BM>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM, j0 = blockIdx.y * BNP;
  const int T = (K + BK - 1) / BK, G = K / g;
  const int t0 = (int)((long long)blockIdx.z * T / splits);
  const int t1 = (int)((long long)(blockIdx.z + 1) * T / splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp > CONSUMERS * 4) return;
    // ---- producer: one thread keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&qmap))
                   : "memory");
      for (int it = 0; it < t1 - t0; ++it) {
        const int tile = t0 + it;
        const int s = it % L::STAGES;
        mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * L::STAGE;
        const int k0 = tile * BK;
        const int gA = k0 / g, gB = min((k0 + BK - 1) / g, G - 1);
        const int ng = gB - gA + 1;
        mbar_expect_tx(&full[s], L::X_BYTES + L::Q_BYTES + ng * 4 * BNP * 4);
        tma_load_2d(st, &xmap, &full[s], k0, m0);
        tma_load_2d(st + L::X_BYTES, &qmap, &full[s], j0, k0);
        float* sc = reinterpret_cast<float*>(st + L::X_BYTES + L::Q_BYTES);
        for (int q = 0; q < ng; ++q) {
          const size_t off = (size_t)(gA + q) * N2p + j0;
          bulk_load(sc + (4 * q + 0) * BNP, sl + off, BNP * 4, &full[s]);
          bulk_load(sc + (4 * q + 1) * BNP, sh + off, BNP * 4, &full[s]);
          bulk_load(sc + (4 * q + 2) * BNP, bl + off, BNP * 4, &full[s]);
          bulk_load(sc + (4 * q + 3) * BNP, bh + off, BNP * 4, &full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup `plane`, warp w of it
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int plane = warp / 4, w = warp % 4, g8 = lane / 4, t = lane % 4;
  const int jA = 16 * w + 2 * g8;                // packed column of A row g8
  const int qoff = (2 * t) * 64 + ((w ^ t) << 4) + 2 * g8;
  const int soff = plane * BNP + jA;
  const int shift = 4 * plane;
  const int g16 = g / 16;

  Acc<BM> acc;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc.v[i] = 0.f;
  // A fragments of two stages: one is dequantized while the other's four
  // wgmmas run (the stage loop is unrolled by two to keep them in registers)
  uint32_t a0[4][4], a1[4][4];
  int prev = -1;

  auto stage = [&](uint32_t(&a)[4][4], uint32_t(&done)[4][4], int it) {
    const int tile = t0 + it;
    const int s = it % L::STAGES;
    mbar_wait(&full[s], (it / L::STAGES) & 1);
    const uint8_t* st = smem + s * L::STAGE;
    const uint8_t* qs = st + L::X_BYTES + qoff;
    const float* sc = reinterpret_cast<const float*>(st + L::X_BYTES +
                                                     L::Q_BYTES) + soff;
    int gi = (tile * 4) / g16;          // group of the next 16-k slice
    int left = g16 - (tile * 4) % g16;  // its slices still to come
    const int gA = gi;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int slot = min(gi, G - 1) - gA;
      dequant_slice(a[kk], qs + kk * 16 * 64, sc + slot * 4 * BNP, shift);
      if (--left == 0) {
        ++gi;
        left = g16;
      }
    }
    const uint32_t xaddr = smem_u32(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a[kk], x_desc(xaddr + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();
    // the previous stage's wgmmas are done: its registers and stage are free
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_reg(done[kk][r]);
    __syncwarp();
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = s;
  };

  int it = 0;
  for (; t0 + it + 1 < t1; it += 2) {
    stage(a0, a1, it);
    stage(a1, a0, it + 1);
  }
  if (t0 + it < t1) stage(a0, a1, it);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) fence_reg(acc.v[i]);

  // ---- epilogue: acc.v[4i + e] is column jA + (e >> 1), token 8i + 2t +
  // (e & 1) of the tile
  const int c = plane * N2p + j0 + jA;
  if (c >= n) return;
  const bool pair = (n % 2 == 0);  // then c + 1 < n too (c is even)
#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * i + 2 * t + e;
      if (m >= M) continue;
      const float lo = acc.v[4 * i + e], hi = acc.v[4 * i + 2 + e];
      if (splits > 1) {
        float* dst = part + ((size_t)blockIdx.z * M + m) * n + c;
        if (pair) {
          *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
        } else {
          dst[0] = lo;
          if (c + 1 < n) dst[1] = hi;
        }
      } else {
        __nv_bfloat16* dst = y + (size_t)m * n + c;
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(lo, hi);
        } else {
          dst[0] = __float2bfloat16_rn(lo);
          if (c + 1 < n) dst[1] = __float2bfloat16_rn(hi);
        }
      }
    }
  }
}

template <int BM>
cudaError_t launch(const void* x, const void* qp, const float* sl,
                   const float* sh, const float* bl, const float* bh,
                   __nv_bfloat16* y, float* part, int M, int K, int N2p, int n,
                   int g, int splits, cudaStream_t stream) {
  CUtensorMap xmap, qmap;
  if (!tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BM, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&qmap, qp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N2p, BK, BNP,
                  CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const int smem = Layout<BM>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      int4_matmul_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, N2p / BNP, splits);
  int4_matmul_kernel<BM><<<grid, THREADS, smem, stream>>>(
      xmap, qmap, sl, sh, bl, bh, y, part, M, K, N2p, n, g, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)M * n;
  const int blocks = (int)min((total / 4 + 255) / 256 + 1, 4LL * 132);
  splitk_reduce<<<blocks, 256, 0, stream>>>(part, y, total, splits);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16; qp [K, N2p] u8; s/b planes [G, N2p] f32 with group g
// (g % 16 == 0, K % g == 0); y [M, n] bf16; part [splits, M, n] f32 scratch
// when splits > 1.  N2p % 64 == 0, K % 8 == 0; x, qp and the planes 16-byte
// aligned.  bm (64, 128 or 256) is the row tile.
extern "C" int mvt_int4_matmul(const void* x, const void* qp, const void* sl,
                               const void* sh, const void* bl, const void* bh,
                               void* y, void* part, int M, int K, int N2p,
                               int n, int g, int bm, int splits,
                               void* stream) {
  auto* fsl = static_cast<const float*>(sl);
  auto* fsh = static_cast<const float*>(sh);
  auto* fbl = static_cast<const float*>(bl);
  auto* fbh = static_cast<const float*>(bh);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* fp = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 64:
      return (int)launch<64>(x, qp, fsl, fsh, fbl, fbh, yb, fp, M, K, N2p, n, g,
                             splits, s);
    case 128:
      return (int)launch<128>(x, qp, fsl, fsh, fbl, fbh, yb, fp, M, K, N2p, n,
                              g, splits, s);
    case 256:
      return (int)launch<256>(x, qp, fsl, fsh, fbl, fbh, yb, fp, M, K, N2p, n,
                              g, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
