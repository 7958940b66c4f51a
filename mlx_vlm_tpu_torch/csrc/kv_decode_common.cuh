// What K6 (int4_kv_attention.cu) and K7 / K8 (tq_kv_attention.cu), the
// quantized-KV decode attention kernels, share: the bulk-copy staging of a
// split's token runs, the warp reductions and `mma.sync` wrappers, and the
// end of a split's block -- one live split writes the output itself, else
// every block arrives on a per-card counter and the last K blocks of a
// (KV head, row group) combine the live splits in a fixed order.
//
// Each kernel cuts a KV head's history into splits, one block each, and
// takes a split's softmax against the split's own maximum; a block leaves
// in shared memory `part` [rows][D] (its sum of p-weighted values) and
// `ml` [rows][2] (its maximum and sum of p) for `finish_split`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr long long TIMEOUT_NS = 2000000000LL;  // a combiner's wait

__host__ __device__ constexpr int align16(int x) {
  return (x + 15) & ~15;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// A staging copy of n bytes from global `src` to shared offset `dst`, with
// dst congruent to src modulo 16, so that the 16-byte aligned middle goes by
// one bulk copy and the unaligned ends by threads.  `base` is the shared
// offset of token t0 for a token run.
struct Run {
  const uint8_t* src;
  int dst, n, base;
};

__device__ __forceinline__ int mis16(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Tokens [ca, cb) of one array (`width` bytes a token) of head bh: token c
// lands at base + (c - t0) * width.
__device__ __forceinline__ Run token_run(const void* array, int width, int bh,
                                         int C, int t0, int ca, int cb,
                                         int region) {
  const uint8_t* g0 =
      static_cast<const uint8_t*>(array) + ((size_t)bh * C + t0) * width;
  Run r;
  r.base = region + mis16(g0);
  r.src = g0 + (size_t)(ca - t0) * width;
  r.dst = r.base + (ca - t0) * width;
  r.n = (cb - ca) * width;
  return r;
}

__device__ __forceinline__ Run span_run(const void* src, int n, int region) {
  Run r;
  r.src = static_cast<const uint8_t*>(src);
  r.base = r.dst = region + mis16(src);
  r.n = n;
  return r;
}

// The run's 16-byte aligned middle [m0, m1) (bytes from its start).
__device__ __forceinline__ void run_middle(const Run& r, int& m0, int& m1) {
  m0 = min((16 - mis16(r.src)) & 15, r.n);
  m1 = max(m0, r.n - mis16(r.src + r.n));
}

__device__ __forceinline__ void run_copy(uint8_t* sm, const Run& r,
                                          uint64_t* bar) {
  int m0, m1;
  run_middle(r, m0, m1);
  if (m1 > m0) bulk_load(sm + r.dst + m0, r.src + m0, m1 - m0, bar);
}

__device__ __forceinline__ uint32_t run_bytes(const Run& r) {
  int m0, m1;
  run_middle(r, m0, m1);
  return m1 - m0;
}

// The run's unaligned ends, copied by the block's threads.
__device__ __forceinline__ void run_ends(uint8_t* sm, const Run& r) {
  int m0, m1;
  run_middle(r, m0, m1);
  const int ends = m0 + (r.n - m1);
  for (int i = threadIdx.x; i < ends; i += blockDim.x) {
    const int k = i < m0 ? i : m1 + (i - m0);
    sm[r.dst + k] = r.src[k];
  }
}

__device__ __forceinline__ float4 fma4(float4 acc, float4 x, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(x.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(x.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(x.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(x.w, w));
  return acc;
}

// Makes this thread's partial sums visible before the block arrives.
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// A combiner's share of the n live splits: output items [i0, i1) (row r, 4
// dims d4 at r * d4n + d4).  Maxima and sums of p at ml[k * kml + r], sums
// at acc[k * kacc + item].  With M = max m_k, w_k = exp(m_k - M),
// L = sum l_k w_k and A = sum acc_k w_k, writes A / max(L, 1e-30).  Eight
// lanes take an item: lane `sub` loads and sums the splits sub, sub + 8,
// ... in order (up to 32 splits in one round trip), and the eight partial
// sums meet in a fixed xor tree.
__device__ __forceinline__ void combine_splits(const float2* ml, size_t kml,
                                               const float4* acc, size_t kacc,
                                               int n, int i0, int i1, int d4n,
                                               float4* out) {
  const int tid = threadIdx.x, sub = tid & 7;
  const int slots = blockDim.x >> 3;
  for (int base = i0; base < i1; base += slots) {
    const int idx = base + (tid >> 3);
    const bool valid = idx < i1;
    const int r = valid ? idx / d4n : 0;
    float mv[4], lv[4];
    float4 xv[4];
    float M = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = sub + 8 * j;
      const bool ok = valid && k < n;
      const float2 t = ok ? __ldcg(ml + k * kml + r)
                          : make_float2(-INFINITY, 0.f);
      xv[j] = ok ? __ldcg(acc + k * kacc + idx)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      mv[j] = t.x;
      lv[j] = t.y;
      M = fmaxf(M, t.x);
    }
    for (int k = sub + 32; valid && k < n; k += 8)
      M = fmaxf(M, __ldcg(ml + k * kml + r).x);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (mv[j] > -INFINITY) {
        const float w = expf(mv[j] - M);
        L = __fadd_rn(L, __fmul_rn(lv[j], w));
        s = fma4(s, xv[j], w);
      }
    }
    for (int k = sub + 32; valid && k < n; k += 8) {
      const float2 t = __ldcg(ml + k * kml + r);
      const float w = expf(t.x - M);
      L = __fadd_rn(L, __fmul_rn(t.y, w));
      s = fma4(s, __ldcg(acc + k * kacc + idx), w);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      L = __fadd_rn(L, __shfl_xor_sync(0xffffffffu, L, o));
      s.x = __fadd_rn(s.x, __shfl_xor_sync(0xffffffffu, s.x, o));
      s.y = __fadd_rn(s.y, __shfl_xor_sync(0xffffffffu, s.y, o));
      s.z = __fadd_rn(s.z, __shfl_xor_sync(0xffffffffu, s.z, o));
      s.w = __fadd_rn(s.w, __shfl_xor_sync(0xffffffffu, s.w, o));
    }
    if (valid && sub == 0) {
      const float dn = fmaxf(L, 1e-30f);
      out[idx] = make_float4(s.x / dn, s.y / dn, s.z / dn, s.w / dn);
    }
  }
}

// Where the scratch and the counters of a launch lie, and how it is cut.
struct SplitOut {
  float* part_ml;     // [NS, BH, G, 2]: each split's max and sum of p
  float* part_acc;    // [NS, BH, G, D]: each split's p-weighted sums
  unsigned* tickets;  // [BH * Z][2] arrivals and finished combiners, zero
                      // between launches
  float* out;         // [BH, G, D]
  int BH, G, D, NS, Z;
  int K;              // combiners: the last K blocks of a (head, rows)
};

// The end of the block of split s (tokens [t0, t0 + TS), visible [lo, hi))
// of KV head bh and row group z (rows row0 .. row0 + R): `part` and `ml`
// hold the split's sums in shared memory when lo < hi.  Every block of the
// grid calls it, the block's threads together; `last` is a shared int.
__device__ __forceinline__ void finish_split(const SplitOut& a,
                                             const float* part,
                                             const float* ml, int& last,
                                             int s, int bh, int z, int row0,
                                             int R, int lo, int hi, int lp,
                                             int end, int TS) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int D = a.D, G = a.G;
  // live splits are contiguous: [s_lo, s_lo + nl)
  const int s_lo = lp / TS, nl = lp < end ? (end - 1) / TS - s_lo + 1 : 0;
  const int d4n = D / 4;
  const size_t orow = (size_t)bh * G + row0;
  if (nl <= 1) {
    // one live split (or none, then split 0) writes the output itself
    if (lo < hi || (nl == 0 && s == 0))
      for (int idx = tid; idx < R * d4n; idx += nthreads) {
        const int r = idx / d4n, d4 = idx - r * d4n;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        float dn = 1e-30f;
        if (lo < hi) {
          x = reinterpret_cast<const float4*>(part)[idx];
          dn = fmaxf(ml[2 * r + 1], 1e-30f);
        }
        reinterpret_cast<float4*>(a.out + (orow + r) * D)[d4] =
            make_float4(x.x / dn, x.y / dn, x.z / dn, x.w / dn);
      }
    return;
  }
  if (lo < hi) {
    const size_t prow = ((size_t)s * a.BH + bh) * G + row0;
    for (int idx = tid; idx < R * d4n; idx += nthreads) {
      const int r = idx / d4n, d4 = idx - r * d4n;
      reinterpret_cast<float4*>(a.part_acc + (prow + r) * D)[d4] =
          reinterpret_cast<const float4*>(part)[idx];
    }
    if (tid < R)
      reinterpret_cast<float2*>(a.part_ml)[prow + tid] =
          make_float2(ml[2 * tid], ml[2 * tid + 1]);
    fence_gpu();
  }

  // ---- arrival: the last K blocks of this (head, row group) to arrive
  // combine the live splits, combiner j its j-th slice of the outputs, once
  // every block has arrived; the last combiner to finish sets the counters
  // back to 0
  __syncthreads();
  unsigned* arrived = a.tickets + ((size_t)bh * a.Z + z) * 2;
  if (tid == 0) last = (int)atom_add_acq_rel(arrived, 1u);
  __syncthreads();
  const int K = a.K, j = last - (a.NS - K);
  if (j < 0) return;
  if (tid == 0 && j < K - 1) {
    const long long t0 = now_ns();
    for (int spin = 0; ld_acquire(arrived) < (unsigned)a.NS; ++spin) {
      __nanosleep(64);
      if ((spin & 255) == 255 && now_ns() - t0 > TIMEOUT_NS) __trap();
    }
  }
  __syncthreads();
  const size_t cstride = (size_t)a.BH * G;
  const int items = R * d4n;
  combine_splits(reinterpret_cast<const float2*>(a.part_ml) +
                     s_lo * cstride + orow,
                 cstride,
                 reinterpret_cast<const float4*>(a.part_acc) +
                     (s_lo * cstride + orow) * d4n,
                 cstride * d4n, nl, j * items / K, (j + 1) * items / K, d4n,
                 reinterpret_cast<float4*>(a.out + orow * D));
  if (tid == 0 && atomicAdd(arrived + 1, 1u) == (unsigned)(K - 1)) {
    arrived[0] = 0u;
    arrived[1] = 0u;
  }
}

}  // namespace
