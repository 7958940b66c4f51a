// K4: flash-attention forward for chunked prefill over a fixed-capacity cache.
//
// Replaces mlx_vlm_tpu/ops/flash_attention.py:flash_attention (Pallas kernel
// _fa2_kernel).  q [B, H, S, D] attends to the cache k/v [B, KVH, C, D]
// (GQA: kv head = h / (H / KVH)).  Query row i of batch row b sits at
// position offset[b] + i and keeps cache column j when
//   left_pad[b] <= j <= offset[b] + i   and (window <= 0 or j > pos - window).
// Masked scores are -0.7 * FLT_MAX, the softmax is online in f32, and a row
// whose running sum stays 0 divides by 1 -- the reference's rules.
//
// Bound on the H100: at S = 512 query rows against a cache of C >= 8192 the
// product is ~2 * S operations per K/V byte, so the kernel is bound by its
// tensor-core work, and the score matrix must never reach device memory.
// Design: one block of four warps per (q tile of 64 rows, head, batch row);
// each warp owns 16 query rows whose Q fragments stay in registers.  The
// block walks 64-column K/V tiles from the first live tile (left_pad,
// window) to the last live one (the tile's last query position), so dead
// tiles cost nothing.  Q.K^T and P.V run on mma.sync m16n8k16 bf16 with f32
// accumulators; the P fragment is reused from the score accumulators in
// registers, and V's B fragments come from ldmatrix.trans.  D is fixed at
// 128 (the Qwen2-VL-7B head size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 64;         // cache columns per tile
constexpr int THREADS = 128;    // 4 warps x 16 rows
constexpr int KS = D + 8;       // bf16 per K/V row in smem (68 words)
constexpr float NEG = -0.7f * 3.402823466e38f;

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem_ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 const int* __restrict__ offset,
                 const int* __restrict__ left_pad, int H, int KVH, int S,
                 int C, float scale, int window) {
  __shared__ __align__(16) __nv_bfloat16 ks[BKV * KS];
  __shared__ __align__(16) __nv_bfloat16 vs[BKV * KS];

  const int ti = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = offset[b], lp = left_pad[b];

  const __nv_bfloat16* qb = q + ((size_t)(b * H + h) * S) * D;
  const __nv_bfloat16* kb = k + ((size_t)(b * KVH + kvh) * C) * D;
  const __nv_bfloat16* vb = v + ((size_t)(b * KVH + kvh) * C) * D;

  // this thread's two query rows (local to the tile) and their positions
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int i0 = ti * BQ + r0, i1 = ti * BQ + r1;  // row index in S
  const int pos0 = off + i0, pos1 = off + i1;

  uint32_t qa[D / 16][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(qb + (size_t)i0 * D);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(qb + (size_t)i1 * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = i0 < S ? q0[kk * 8 + t] : 0u;
      qa[kk][1] = i1 < S ? q1[kk * 8 + t] : 0u;
      qa[kk][2] = i0 < S ? q0[kk * 8 + 4 + t] : 0u;
      qa[kk][3] = i1 < S ? q1[kk * 8 + 4 + t] : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  // live tiles: from the first column any row may keep to the tile's last
  // query position
  const int q_lo = off + ti * BQ;
  const int q_hi = off + min(ti * BQ + BQ - 1, S - 1);
  int first_col = lp;
  if (window > 0) first_col = max(first_col, q_lo - window + 1);
  const int first = max(first_col, 0) / BKV;
  const int last = min(q_hi, C - 1) / BKV;

  for (int j = first; j <= last; ++j) {
    const int col0 = j * BKV;
    __syncthreads();  // the previous tile's smem reads are done
#pragma unroll
    for (int i = 0; i < (BKV * D / 8) / THREADS; ++i) {
      const int vidx = tid + i * THREADS, r = vidx / (D / 8), cv = vidx % (D / 8);
      const size_t src = (size_t)(col0 + r) * D + cv * 8;
      *reinterpret_cast<uint4*>(ks + r * KS + cv * 8) =
          *reinterpret_cast<const uint4*>(kb + src);
      *reinterpret_cast<uint4*>(vs + r * KS + cv * 8) =
          *reinterpret_cast<const uint4*>(vb + src);
    }
    __syncthreads();

    // scores for 16 rows x 64 columns per warp
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const uint32_t* ksw = reinterpret_cast<const uint32_t*>(ks);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
        const int cr = nt * 8 + g;
        mma_bf16(s[nt], qa[kk], ksw[(cr * KS) / 2 + kk * 8 + t],
                 ksw[(cr * KS) / 2 + kk * 8 + 4 + t]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + nt * 8 + 2 * t + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        bool keep = col <= pos && col >= lp;
        if (window > 0) keep = keep && col > pos - window;
        s[nt][e] = keep ? s[nt][e] * scale : NEG;
      }
    }

    // online softmax; row ri's values are s[*][2ri], s[*][2ri+1], shared by
    // the four threads of a quad
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * ri], s[nt][2 * ri + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[ri], mx);
      const float alpha = expf(m_run[ri] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
        for (int e = 2 * ri; e < 2 * ri + 2; ++e) {
          const float p = expf(s[nt][e] - m_new);
          s[nt][e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[ri] = l_run[ri] * alpha + sum;
      m_run[ri] = m_new;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        acc[d][2 * ri] *= alpha;
        acc[d][2 * ri + 1] *= alpha;
      }
    }

    // acc += P V: the score accumulators of column tiles 2kk, 2kk+1 are the
    // A fragment of the k-step kk
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + vrow * KS + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }

  const float inv0 = 1.f / (l_run[0] == 0.f ? 1.f : l_run[0]);
  const float inv1 = 1.f / (l_run[1] == 0.f ? 1.f : l_run[1]);
  __nv_bfloat16* ob = o + ((size_t)(b * H + h) * S) * D;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (i0 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)i0 * D + col) =
          pack_bf16(acc[d][0] * inv0, acc[d][1] * inv0);
    if (i1 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)i1 * D + col) =
          pack_bf16(acc[d][2] * inv1, acc[d][3] * inv1);
  }
}

}  // namespace

// q [B, H, S, 128], k/v [B, KVH, C, 128], o [B, H, S, 128] bf16; offset and
// left_pad [B] int32 on the device.  C % 64 == 0, H % KVH == 0.
extern "C" int mvt_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, const void* offset,
                                   const void* left_pad, int B, int H, int KVH,
                                   int S, int C, float scale, int window,
                                   void* stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B), block(THREADS);
  flash_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(offset), static_cast<const int*>(left_pad), H,
      KVH, S, C, scale, window);
  return (int)cudaGetLastError();
}
