// K2: grouped-int4 GEMV for M <= 8 rows (decode linears, prefill lm_head).
//
// Replaces mlx_vlm_tpu/ops/int4_matvec.py:_int4_matvec (Pallas kernel
// _kern).  y[m, :] = x[m, :] @ dequant(W) for x [M, K] bf16 and W in the
// halves-packed Int4GroupedTensor layout: qp [K, N2p] uint8, the low nibble
// of byte (k, j) is column j and the high nibble column N2p + j; sl/sh/bl/bh
// [G, N2p] f32 are the per (K-group, column) scales and biases of the two
// planes, any group size g with g % 16 == 0 and K % g == 0.  Each weight is
// code * s + b, products and sums are f32, and y is rounded once to bf16
// and cut to n columns.  One launch per call, nothing else launched.
//
// What bounds it on the H100: device-memory bandwidth.  A call reads each
// packed byte once (two weights) and 16 bytes of scales per packed column
// and group, and does 2 M operations per weight: even at M = 8 that is far
// below the ~295 operations per byte where the tensor cores would bound.
// What the design does about it:
//
// - Bytes in flight.  Little's law at 3.35 TB/s and ~0.7 us asks for ~18 KB
//   in flight per SM.  One producer thread per block keeps a ring of STAGES
//   code stages full by TMA: a box of 64 k rows x 128 packed columns (8 KB,
//   128-byte swizzle) and x's 64 k for 8 rows (1 KB; rows >= M read as zero).
//   The scales of every group a stage touches travel by cp.async.bulk into
//   a ring of their own (SSTAGES deep).  The consumers copy a code stage into
//   registers and hand it back at once, so the ring refills while they
//   compute (holding the stage through the compute left it part empty).
//   4 code stages of 9 KB and 6 scale stages per block, 4 blocks of 160
//   threads per SM (95 registers): up to ~190 KB requested per SM at g = 64.
// - Filling the card at every shape.  A block streams one strip of 128
//   packed columns (256 outputs) over a K slice of whole groups; the plan
//   (ops/int4_matvec.py:int4_matvec_plan) picks the slice count S for two
//   blocks per SM, slices of at most 14 stages (so that the last wave of
//   blocks is short) and at most 16 slices (the cluster).
// - The arithmetic, with the weight read once for all rows.  f32 FMAs on
//   CUDA cores would take ~4 instructions per code, about the whole issue
//   budget at the bandwidth.  Each group is factored as K5 does
//   (qmatmul.cu): y += s * sum_k x (128 + q) + (b - 128 s) * sum_k x.  The
//   codes become exact bf16 values 128 + q with a byte permute, a shift and
//   one LOP3 per pair (the nibble is the mantissa of 128.0), so that
//   `mma.sync m16n8k16` sums x (128 + q) for 16 outputs x 8 rows of x into
//   f32 with no rounding of the weight or of x, and a fifth MMA with A = 1
//   sums x per group and row into the same fragment layout.  This equals
//   the reference up to f32 reassociation.  At M = 1 only one of the MMA's
//   8 columns is used, at no cost in bytes.  ROWS (M rounded up to 1, 2, 4
//   or 8) is a template parameter that cuts the fold and the stores to the
//   rows that exist.  Tried on the card and dropped: sums of x from a
//   prologue or from CUDA-core adds instead of the fifth MMA, and two or
//   four warps per 32 columns; each was slower.
// - MMA layout.  A warp owns 32 packed columns as four 16 x 16 A tiles:
//   tile i, row r < 8 is the low nibble of packed column 4r + i and row
//   r + 8 its high nibble, so one 32-bit read of each of the k rows (2t,
//   2t+1, 2t+8, 2t+9) feeds all four tiles, and a byte permute joins two k
//   rows into the (k, k+1) pairs the fragment wants.  With 128-byte rows
//   and the 128-byte swizzle these reads are free of bank conflicts.
// - The K slices are summed in the same launch, in a fixed order, with no
//   float atomics, through a thread-block cluster along K: the S <= 16
//   blocks of a strip (one per slice; past 8 with the non-portable cluster
//   size) leave their f32 partials [M, 2 x 128] in their own shared memory,
//   and after a cluster barrier each block adds all the slices' partials in
//   slice order, read from distributed shared memory, for its 1/S share of
//   the strip's outputs, and writes them as bf16.  A ticket (partials in
//   device memory, the last block of the strip adds them) was tried first:
//   its fence, atomic and device-memory round trips cost more than the
//   rest of a small call.  The result does not depend on which block
//   finishes first.
// - Ragged edges: a slice's last stage may reach past its end (those rows
//   are loaded and not used) or past K (zero-filled); the stores mask rows
//   >= M and columns >= n.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;             // k rows per stage
constexpr int STRIP = 128;         // packed columns per block (256 outputs)
constexpr int WARPS = 4;           // consumer warps, 32 packed columns each
constexpr int CONSUMERS = WARPS * 32;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int STAGES = 4;          // code + x stages
constexpr int SSTAGES = 6;         // scale stages (a code stage's groups each)
constexpr int XROWS = 8;           // x rows per stage (the MMA's n)
constexpr int MAX_SLICES = 16;     // a cluster's blocks (non-portable size)
constexpr int Q_BYTES = BK * STRIP;               // codes, 128B swizzle
constexpr int X_BYTES = XROWS * BK * 2;           // x, 128B swizzle
constexpr int QX_BYTES = Q_BYTES + X_BYTES;       // one code + x stage
constexpr int SLOT_BYTES = 4 * STRIP * 4;         // one group's [sl sh bl bh]
constexpr int MAX_SLOTS = BK / 16;                // groups a stage touches
static_assert(QX_BYTES % 1024 == 0, "stages keep the swizzle's alignment");

// Shared memory of a call: the code ring, the scale ring of `slots` groups
// per stage, alignment slack.
__host__ __device__ constexpr int smem_bytes(int slots) {
  return STAGES * QX_BYTES + SSTAGES * slots * SLOT_BYTES + 1024;
}

// Groups of size g that one stage can touch: stages start at a multiple of
// g plus a multiple of BK, and every group boundary is a multiple of 16.
int stage_slots(int g) {
  if (g % BK == 0) return 1;
  if (BK % g == 0) return BK / g;
  return BK / g + 2 < MAX_SLOTS ? BK / g + 2 : MAX_SLOTS;
}

// Byte offset of (row, byte c) in a tile of 128-byte rows written by TMA
// with the 128-byte swizzle: 16-byte chunk c / 16 is XORed with row % 8.
__device__ __forceinline__ int swz(int row, int c) {
  return row * 128 + ((((c >> 4) ^ row) & 7) << 4) + (c & 15);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two codes as exact bf16 values 128 + code: the nibbles at bits [0, 4) and
// [16, 20) of v become the mantissa of 128.0 (bf16 0x4300).
__device__ __forceinline__ uint32_t codes128(uint32_t v) {
  uint32_t r;  // one LOP3: (v & 0x000F000F) | 0x43004300
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(r)
      : "r"(v), "r"(0x000F000Fu), "r"(0x43004300u));
  return r;
}

// The end of a split call: every block of the strip's cluster (one per K
// slice, rank z = blockIdx.y) holds its f32 partial [M][256] at `red` in
// its shared memory; block z adds all the slices' partials, in slice order,
// for its share of the strip's outputs, and writes them as bf16.  Every
// thread of every block of the cluster calls this.
__device__ __forceinline__ void cluster_sum(const float* red,
                                            __nv_bfloat16* __restrict__ y,
                                            int M, int N2p, int n, int j0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial is in place
  const int S = gridDim.y, z = blockIdx.y;
  const int items = M * 2 * (STRIP / 4);  // four columns of one row each
  const int first = z * items / S, last = (z + 1) * items / S;
  for (int idx = first + threadIdx.x; idx < last; idx += blockDim.x) {
    const int m = idx / (2 * (STRIP / 4)), q4 = idx % (2 * (STRIP / 4));
    const float* src = red + m * 2 * STRIP + 4 * q4;
    float4 v[MAX_SLICES];
#pragma unroll
    for (int r = 0; r < MAX_SLICES; ++r)
      if (r < S)
        v[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(const_cast<float*>(src), r));
    float4 acc = v[0];
#pragma unroll
    for (int r = 1; r < MAX_SLICES; ++r) {
      if (r < S) {
        acc.x += v[r].x;
        acc.y += v[r].y;
        acc.z += v[r].z;
        acc.w += v[r].w;
      }
    }
    const int col = (q4 / (STRIP / 4)) * N2p + j0 + 4 * (q4 % (STRIP / 4));
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (col + u < n) y[(size_t)m * n + col + u] = __float2bfloat16_rn(a[u]);
  }
  cluster.sync();  // no block leaves while the others read its partial
}

// Grid: (N2p / 128 strips, S slices).  Warps 0-3 consume, lane 0 of warp 4
// produces.  Slice z covers groups [z G / S, (z + 1) G / S); with S > 1 the
// slices of a strip form one cluster (1, S, 1).
template <int ROWS>
__global__ void __launch_bounds__(THREADS, 4)
int4_matvec_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap qmap,
                   const float* __restrict__ sl, const float* __restrict__ sh,
                   const float* __restrict__ bl, const float* __restrict__ bh,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N2p,
                   int n, int g, int slots) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ __align__(8) uint64_t sempty[SSTAGES];
  // aligned by an offset from the __shared__ array, so that the compiler
  // keeps the shared address space (32-bit LDS, no generic loads)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = blockIdx.x, z = blockIdx.y, S = gridDim.y;
  const int j0 = strip * STRIP;
  const int G = K / g;
  const int kb = (int)((long long)z * G / S) * g;
  const int ke = (int)((long long)(z + 1) * G / S) * g;
  const int nst = (ke - kb + BK - 1) / BK;
  float* scales = reinterpret_cast<float*>(smem + STAGES * QX_BYTES);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);  // one arrival per consumer warp
    }
    for (int s = 0; s < SSTAGES; ++s) mbar_init(&sempty[s], WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // ---- producer: one thread keeps both rings full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&qmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      for (int it = 0; it < nst; ++it) {
        const int s = it % STAGES, ss = it % SSTAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_wait(&sempty[ss], ((it / SSTAGES) & 1) ^ 1);
        uint8_t* st = smem + s * QX_BYTES;
        const int k0 = kb + it * BK;
        const int gA = k0 / g, gB = (min(k0 + BK, ke) - 1) / g;
        const int ng = gB - gA + 1;
        mbar_expect_tx(&full[s], QX_BYTES + ng * SLOT_BYTES);
        tma_load_2d(st, &qmap, &full[s], j0, k0);
        tma_load_2d(st + Q_BYTES, &xmap, &full[s], k0, 0);
        float* sc = scales + ss * slots * (SLOT_BYTES / 4);
        for (int q = 0; q < ng; ++q) {
          const size_t off = (size_t)(gA + q) * N2p + j0;
          bulk_load(sc + (4 * q + 0) * STRIP, sl + off, STRIP * 4, &full[s]);
          bulk_load(sc + (4 * q + 1) * STRIP, sh + off, STRIP * 4, &full[s]);
          bulk_load(sc + (4 * q + 2) * STRIP, bl + off, STRIP * 4, &full[s]);
          bulk_load(sc + (4 * q + 3) * STRIP, bh + off, STRIP * 4, &full[s]);
        }
      }
    }
    __syncwarp();
    if (S > 1) cluster_sum(reinterpret_cast<float*>(smem), y, M, N2p, n, j0);
    return;
  }

  // ---- consumers: warp w owns packed columns j0 + 32 w + [0, 32); tile i
  // of it holds packed columns j0 + 32 w + 4 r + i, r < 8
  const int r8 = lane / 4, t = lane % 4;
  const int cq = 32 * warp + 4 * r8;  // the 4 packed columns of this word
  // step j reads code rows 16 j + (2t, 2t+1, 2t+8, 2t+9) at byte cq; the
  // swizzle XORs with row % 8, which 16 j leaves alone
  const int oq0 = swz(2 * t, cq), oq1 = swz(2 * t + 1, cq);
  const int oq2 = swz(2 * t + 8, cq), oq3 = swz(2 * t + 9, cq);
  const uint32_t ONES[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                            0x3F803F80u};  // bf16 1s: the A of the x sums
  float tot[4][4];  // [tile][lo row 2t, lo row 2t+1, hi row 2t, hi 2t+1]
  float d[4][4], dx[4];  // this group's sums of x (128 + q), and of x
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dx[e] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[i][e] = d[i][e] = 0.f;
  }
  const int gsteps = g / 16;  // 16-deep MMA steps per group
  int left = gsteps, gcur = kb / g;

  for (int it = 0; it < nst; ++it) {
    const int s = it % STAGES, ss = it % SSTAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint8_t* qs = smem + s * QX_BYTES;
    const uint8_t* xs = qs + Q_BYTES;
    const float* sc = scales + ss * slots * (SLOT_BYTES / 4);
    const int k0 = kb + it * BK;
    const int steps = (min(k0 + BK, ke) - k0) / 16;
    const int gA = k0 / g;
    // the stage's codes and x into registers; the code stage goes back to
    // the producer at once, the scale stage once its groups are folded
    uint32_t w[BK / 16][4], b[BK / 16][2];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      if (j < steps) {
        const uint8_t* qj = qs + 16 * 128 * j;
        w[j][0] = *reinterpret_cast<const uint32_t*>(qj + oq0);
        w[j][1] = *reinterpret_cast<const uint32_t*>(qj + oq1);
        w[j][2] = *reinterpret_cast<const uint32_t*>(qj + oq2);
        w[j][3] = *reinterpret_cast<const uint32_t*>(qj + oq3);
        b[j][0] = *reinterpret_cast<const uint32_t*>(
            xs + swz(r8, 32 * j + 4 * t));
        b[j][1] = *reinterpret_cast<const uint32_t*>(
            xs + swz(r8, 32 * j + 4 * t + 16));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      if (j < steps) {
        mma_bf16(dx, ONES, b[j][0], b[j][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // byte i of the words: k rows (2t, 2t+1) into bytes 0 and 2 of
          // u01, (2t+8, 2t+9) into u23; low nibbles A rows r, high r + 8
          const uint32_t sel = i | ((4 + i) << 8);
          const uint32_t u01 = __byte_perm(w[j][0], w[j][1], sel);
          const uint32_t u23 = __byte_perm(w[j][2], w[j][3], sel);
          const uint32_t a[4] = {codes128(u01), codes128(u01 >> 4),
                                 codes128(u23), codes128(u23 >> 4)};
          mma_bf16(d[i], a, b[j][0], b[j][1]);
        }
        if (--left == 0) {
          // group gcur ends: y += s * sum x (128 + q) + (b - 128 s) sum x
          const float* gs = sc + (gcur - gA) * 4 * STRIP + cq;
          const float4 s_lo = *reinterpret_cast<const float4*>(gs);
          const float4 s_hi = *reinterpret_cast<const float4*>(gs + STRIP);
          const float4 b_lo = *reinterpret_cast<const float4*>(gs + 2 * STRIP);
          const float4 b_hi = *reinterpret_cast<const float4*>(gs + 3 * STRIP);
          const float sL[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
          const float sH[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
          const float bL[4] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w};
          const float bH[4] = {b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cL = fmaf(-128.f, sL[i], bL[i]);
            const float cH = fmaf(-128.f, sH[i], bH[i]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (2 * t + e < ROWS) {
                tot[i][e] += fmaf(sL[i], d[i][e], cL * dx[e]);
                tot[i][2 + e] += fmaf(sH[i], d[i][2 + e], cH * dx[e]);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) dx[e] = 0.f;
          left = gsteps;
          ++gcur;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sempty[ss]);
  }

  // ---- rows 2t and 2t + 1 of tile i: packed column j0 + cq + i
  const int row0 = 2 * t;
  if (S == 1) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = row0 + e;
      if (m < ROWS && m < M) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = j0 + cq + i;
          if (c < n) y[(size_t)m * n + c] = __float2bfloat16_rn(tot[i][e]);
          if (N2p + c < n)
            y[(size_t)m * n + N2p + c] = __float2bfloat16_rn(tot[i][2 + e]);
        }
      }
    }
    return;
  }
  // split: the partial into this block's code ring, which every consumer
  // is done with after the barrier, then the cluster adds the slices
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  float* red = reinterpret_cast<float*>(smem);  // [M][lo 128 | hi 128]
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = row0 + e;
    if (m < ROWS && m < M) {
      float* p = red + m * 2 * STRIP + cq;
      *reinterpret_cast<float4*>(p) =
          make_float4(tot[0][e], tot[1][e], tot[2][e], tot[3][e]);
      *reinterpret_cast<float4*>(p + STRIP) = make_float4(
          tot[0][2 + e], tot[1][2 + e], tot[2][2 + e], tot[3][2 + e]);
    }
  }
  cluster_sum(red, y, M, N2p, n, j0);
}

template <int ROWS>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& qmap,
                   const float* sl, const float* sh, const float* bl,
                   const float* bh, __nv_bfloat16* y, int M, int K, int N2p,
                   int n, int g, int slices, cudaStream_t stream) {
  const int slots = stage_slots(g);
  const int smem = smem_bytes(slots);
  auto kernel = int4_matvec_kernel<ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && slices > 8)  // clusters past 8 blocks
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N2p / STRIP, slices);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = slices;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, qmap, sl, sh, bl, bh, y, M, K,
                           N2p, n, g, slots);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x [M <= 8, K] bf16; qp [K, N2p] u8; s/b planes [G, N2p] f32 with group g
// (g % 16 == 0, K % g == 0); y [M, n] bf16; 1 <= slices <= 16 and at most
// G.  N2p % 128 == 0; x, qp and the planes 16-byte aligned.
extern "C" int mvt_int4_matvec(const void* x, const void* qp, const void* sl,
                               const void* sh, const void* bl, const void* bh,
                               void* y, int M, int K, int N2p, int n, int g,
                               int slices, void* stream) {
  if (M < 1 || M > XROWS || N2p % STRIP || g % 16 || K % g ||
      slices < 1 || slices > MAX_SLICES || slices > K / g)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, qmap;
  if (!tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, XROWS,
                  BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&qmap, qp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N2p, BK,
                  STRIP, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto* fsl = static_cast<const float*>(sl);
  auto* fsh = static_cast<const float*>(sh);
  auto* fbl = static_cast<const float*>(bl);
  auto* fbh = static_cast<const float*>(bh);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (M == 1)
    return (int)launch<1>(xmap, qmap, fsl, fsh, fbl, fbh, yb, M, K, N2p, n,
                          g, slices, st);
  if (M == 2)
    return (int)launch<2>(xmap, qmap, fsl, fsh, fbl, fbh, yb, M, K, N2p, n,
                          g, slices, st);
  if (M <= 4)
    return (int)launch<4>(xmap, qmap, fsl, fsh, fbl, fbh, yb, M, K, N2p, n,
                          g, slices, st);
  return (int)launch<8>(xmap, qmap, fsl, fsh, fbl, fbh, yb, M, K, N2p, n, g,
                        slices, st);
}

extern "C" const char* mvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
