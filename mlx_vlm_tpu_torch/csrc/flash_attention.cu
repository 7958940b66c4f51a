// K4: flash-attention forward for chunked prefill over a fixed-capacity
// cache, written for Hopper.
//
// Replaces mlx_vlm_tpu/ops/flash_attention.py:flash_attention (:89, Pallas
// kernel _fa2_kernel :31).  q [B, H, S, 128] attends to the cache k/v
// [B, KVH, C, 128] (GQA: kv head = h / (H / KVH)).  Query row i of batch row
// b sits at position offset[b] + i and keeps cache column j when
//   left_pad[b] <= j <= offset[b] + i   and (window <= 0 or j > pos - window).
// Masked scores are -0.7 * FLT_MAX, the softmax is online in f32, a row
// whose running sum stays 0 divides by 1, and the output is rounded once to
// bf16 -- the reference's rules.
//
// What bounds it on the H100, at the main path's shape (B = 1, H = 28,
// KVH = 4, S = 512 rows against C = 8192 at offset 7680), and what the
// design does about each:
// - Operations: 4 * 128 per visible (row, head, column), 58 GFLOP, 0.059 ms
//   at 989 TFLOP/s.  Only `wgmma` reaches that rate, so both products run
//   on it: S = Q K^T with Q and K from shared memory (m64n128k16, both
//   K-major), and O += P V with P from registers, converted in place from
//   the score accumulators, and V as an MN-major B (wgmma.cuh's mn_desc and
//   transpose-B bit: the V tile keeps D contiguous, as the cache does).
// - Exponentials: one per (row, head, column) of a walked tile, 115 M,
//   about 0.03 ms at 16 per clock per SM -- half the tensor-core time, so
//   they must run while the tensor cores work.  Each consumer warpgroup
//   issues tile j's Q K^T and tile j-1's P V together and does tile j's
//   softmax while P V runs (O is rescaled after it lands), and the two
//   warpgroups take turns to issue (ping-pong on two named barriers), so
//   one's softmax also hides under the other's products (kernel-only runs
//   on the card: either alone left the tensor cores idle for part of each
//   softmax, and a third ring stage helped both).  The exponentials are ex2
//   with scale * log2(e) folded into one FFMA.  The mask is applied only to tiles that cut some row's
//   visible range (the causal diagonal, left_pad's tile, the window's edge,
//   the tile past C); every other tile is proven interior from the
//   warpgroup's row bounds.  A masked score is the finite -0.7 * FLT_MAX
//   set after scaling, never scaled itself (times log2(e) it would overflow
//   to -inf, and -inf - -inf is NaN).
// - L2 bytes: each block reads its KV head's live K and V tiles once, for
//   128 query rows: 250 tiles x 28 heads x 64 KB = 0.45 GB per call at the
//   main shape (64 rows per block would read 0.94 GB).  One
//   producer thread keeps them in flight by TMA (128-byte swizzle, two
//   64-column boxes per 128-column tile) through a three-stage ring with
//   separate full/empty mbarriers for K and V, so Q K^T of a tile waits
//   only for its K, and copies never wait on math.
// - Grid: one block per (128-row q tile, head, batch row): 4 x 28 = 112
//   blocks at the main shape, one per SM (224 KB of shared memory, 384
//   threads), one wave on 85% of the 132 SMs.  KV is not split, no two
//   heads share a block and no cluster multicasts K/V: nothing needs a
//   combine pass, so one call is one kernel and a repeat gives the same
//   bits.  Filling the last 20 SMs would take a KV split and its combine.
// - Dead tiles cost nothing: a block walks the tiles from its first live
//   column (left_pad, the window of its first row) to its last row's
//   position.  Columns past C read as zeros (a 3-D tensor map per KV head)
//   and are masked.
//
// Warp roles: warpgroups 0 and 1 are consumers of 64 query rows each;
// warpgroup 2 gives its registers to them (setmaxnreg 40 / 232) and one of
// its threads is the producer.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"
#include "wgmma.cuh"

namespace {

constexpr int D = 128;
constexpr int CONSUMERS = 2;          // warpgroups of 64 query rows
constexpr int BQ = 64 * CONSUMERS;    // query rows per block
constexpr int BKV = 128;              // cache columns per tile
constexpr int STAGES = 3;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int BOX_Q = 64 * 64 * 2;    // 64 rows x 64 columns, 128-byte swizzle
constexpr int BOX_KV = BKV * 64 * 2;  // 128 rows x 64 columns
constexpr int Q_BYTES = 2 * BOX_Q;    // one warpgroup's q rows
constexpr int KV_BYTES = 2 * BOX_KV;  // one K or V tile
constexpr int SMEM = CONSUMERS * Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
constexpr float NEG = -0.7f * 3.402823466e38f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Grid: (ceil(S / BQ) q tiles, H, B).  Accumulator layout of a consumer
// thread (warp w of its warpgroup, lane = 4g + t): v[4i + e] is row
// 16w + g + 8 * (e >> 1) of the warpgroup's 64, column 8i + 2t + (e & 1).
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o,
                 const int* __restrict__ offset,
                 const int* __restrict__ left_pad, int H, int KVH, int S,
                 int C, float scale, int window) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], k_empty[STAGES],
      v_full[STAGES], v_empty[STAGES];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + CONSUMERS * Q_BYTES;
  uint8_t* vs = ks + STAGES * KV_BYTES;

  const int ti = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kv_mat = b * KVH + h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int off = offset[b], lp = left_pad[b];

  // live tiles: from the first column any row may keep to the block's last
  // query position
  const int q_hi = off + min(ti * BQ + BQ - 1, S - 1);
  int first_col = lp;
  if (window > 0) first_col = max(first_col, off + ti * BQ - window + 1);
  const int first = max(first_col, 0) / BKV;
  const int n = max(0, min(q_hi, C - 1) / BKV - first + 1);

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS * 4);  // one arrival per consumer warp
      mbar_init(&v_empty[s], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // ---- producer: one thread loads q once, then keeps the K/V ring full
    if (warp == CONSUMERS * 4 && lane == 0) {
      const CUtensorMap* maps[3] = {&qmap, &kmap, &vmap};
      for (const CUtensorMap* m : maps)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(m))
                     : "memory");
      mbar_expect_tx(&q_full, CONSUMERS * Q_BYTES);
      for (int wg = 0; wg < CONSUMERS; ++wg)
        for (int x = 0; x < 2; ++x)
          tma_load_3d(qs + wg * Q_BYTES + x * BOX_Q, &qmap, &q_full, 64 * x,
                      ti * BQ + 64 * wg, b * H + h);
      for (int it = 0; it < n; ++it) {
        const int s = it % STAGES, phase = ((it / STAGES) & 1) ^ 1;
        const int c0 = (first + it) * BKV;
        mbar_wait(&k_empty[s], phase);
        mbar_expect_tx(&k_full[s], KV_BYTES);
        for (int x = 0; x < 2; ++x)
          tma_load_3d(ks + s * KV_BYTES + x * BOX_KV, &kmap, &k_full[s],
                      64 * x, c0, kv_mat);
        mbar_wait(&v_empty[s], phase);
        mbar_expect_tx(&v_full[s], KV_BYTES);
        for (int x = 0; x < 2; ++x)
          tma_load_3d(vs + s * KV_BYTES + x * BOX_KV, &vmap, &v_full[s],
                      64 * x, c0, kv_mat);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, warp w of it
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  const float sl = scale * LOG2E;
  const int row0 = ti * BQ + 64 * wg + 16 * w + g;  // rows row0, row0 + 8
  // each of the thread's rows keeps columns [lo, hi]; every row of the
  // warpgroup keeps [lo_all, hi_all], so a tile inside it needs no mask
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = off + row0 + 8 * r;
    lo[r] = window > 0 ? max(lp, pos - window + 1) : lp;
    hi[r] = min(pos, C - 1);
  }
  const int wg_pos = off + ti * BQ + 64 * wg;
  const int lo_all = window > 0 ? max(lp, wg_pos + 64 - window) : lp;
  const int hi_all = min(wg_pos, C - 1);

  Acc<128> sacc, oacc;
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc.v[i] = oacc.v[i] = 0.f;
  uint32_t pa[BKV / 16][4];
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f}, alpha[2];
  const uint32_t q_addr = smem_u32(qs + wg * Q_BYTES);

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // issue S = Q K^T on stage s, and O += P V on stage s
  auto qk = [&](int s) {
    const uint32_t k_addr = smem_u32(ks + s * KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sacc, x_desc(q_addr + (kk / 4) * BOX_Q + (kk % 4) * 32),
               x_desc(k_addr + (kk / 4) * BOX_KV + (kk % 4) * 32), kk > 0);
  };
  auto pv = [&](int s) {
    const uint32_t v_addr = smem_u32(vs + s * KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs<1>(oacc, pa[kk], mn_desc(v_addr + kk * 16 * 128, BOX_KV));
  };
  // the scores of the tile at column c0 become p = exp2(s * sl - m) in
  // place; m_run, l_run (this thread's part of the row sum) and alpha, the
  // factor for O, move on
  auto softmax = [&](int c0) {
    float mult = sl;  // s * mult is the score in log2 units
    if (!(sl > 0.f) || c0 < lo_all || c0 + BKV - 1 > hi_all) {
      mult = 1.f;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * i + 2 * t + (e & 1), r = e >> 1;
          sacc.v[4 * i + e] = col >= lo[r] && col <= hi[r]
                                  ? sacc.v[4 * i + e] * sl
                                  : NEG;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
        mx = fmaxf(mx, fmaxf(sacc.v[4 * i + 2 * r], sacc.v[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * mult);
      alpha[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = ex2(fmaf(sacc.v[4 * i + e], mult, -m_new));
          sacc.v[4 * i + e] = p;
          sum += p;
        }
      l_run[r] = l_run[r] * alpha[r] + sum;
    }
  };
  // p as the A fragments of P V: columns 16kk .. 16kk + 15 are slice kk
  auto to_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(sacc.v[8 * kk + 2 * x], sacc.v[8 * kk + 2 * x + 1]);
  };
  auto fence_s = [&]() {
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(sacc.v[i]);
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(oacc.v[i]);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) fence_reg(pa[kk][x]);
  };

  // the two warpgroups take turns to issue their products (named barriers
  // 1 and 2, 128 threads waiting + 128 passing), so one's softmax runs
  // while the other's products hold the tensor cores; warpgroup 0 starts
  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto turn_pass = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  };

  mbar_wait(&q_full, 0);
  if (n > 0) {
    if (wg == 1) turn_pass();
    mbar_wait(&k_full[0], 0);
    turn_wait();
    wgmma_fence();
    qk(0);
    wgmma_commit();
    turn_pass();
    wgmma_wait<0>();
    fence_s();
    release(&k_empty[0]);
    softmax(first * BKV);
    to_p();
    for (int it = 1; it < n; ++it) {
      const int s = it % STAGES, sp = (it - 1) % STAGES;
      mbar_wait(&k_full[s], (it / STAGES) & 1);
      mbar_wait(&v_full[sp], ((it - 1) / STAGES) & 1);
      turn_wait();
      wgmma_fence();
      qk(s);
      wgmma_commit();
      pv(sp);
      wgmma_commit();
      turn_pass();
      wgmma_wait<1>();  // S of tile it is in; P V of tile it - 1 runs on
      fence_s();
      release(&k_empty[s]);
      softmax((first + it) * BKV);
      wgmma_wait<0>();
      fence_o();
      release(&v_empty[sp]);
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) {
        oacc.v[4 * i] *= alpha[0];
        oacc.v[4 * i + 1] *= alpha[0];
        oacc.v[4 * i + 2] *= alpha[1];
        oacc.v[4 * i + 3] *= alpha[1];
      }
      to_p();
    }
    const int s = (n - 1) % STAGES;
    mbar_wait(&v_full[s], ((n - 1) / STAGES) & 1);
    turn_wait();
    wgmma_fence();
    pv(s);
    wgmma_commit();
    if (wg == 0) turn_pass();  // warpgroup 1 has the last turn
    wgmma_wait<0>();
    fence_o();
  }

  // ---- epilogue: O / l, rounded once to bf16
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / (l == 0.f ? 1.f : l);
  }
  __nv_bfloat16* ob = o + ((size_t)(b * H + h) * S) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(ob + (size_t)row * D + 2 * t);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      dst[4 * i] = pack_bf16(oacc.v[4 * i + 2 * r] * inv[r],
                             oacc.v[4 * i + 2 * r + 1] * inv[r]);
  }
}

}  // namespace

// q [B, H, S, 128], k/v [B, KVH, C, 128], o [B, H, S, 128] bf16, each
// 16-byte aligned; offset and left_pad [B] int32 on the device.
// H % KVH == 0.  The grid and tiles are ops/flash_attention.py's
// flash_attention_plan.
extern "C" int mvt_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, const void* offset,
                                   const void* left_pad, int B, int H, int KVH,
                                   int S, int C, float scale, int window,
                                   void* stream) {
  CUtensorMap qmap, kmap, vmap;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_3d(&qmap, q, bf16, 2, B * H, S, D, 64, 64, sw) ||
      !tensor_map_3d(&kmap, k, bf16, 2, B * KVH, C, D, BKV, 64, sw) ||
      !tensor_map_3d(&vmap, v, bf16, 2, B * KVH, C, D, BKV, 64, sw))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(offset), static_cast<const int*>(left_pad), H,
      KVH, S, C, scale, window);
  return (int)cudaGetLastError();
}
