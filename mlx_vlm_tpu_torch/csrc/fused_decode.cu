// K3: the whole-stack int4 decode step (B = 1, S = 1) in one persistent kernel.
//
// Replaces mlx_vlm_tpu/ops/fused_decode.py: `fused_decode_step` (:1355, the
// pipelined grid) and `fused_decode_step_manual` (:964, the manual-DMA kernel
// with its optional fused lm_head).  It follows the manual kernel's "z2" math
// (`_mv2z` :1085): x is rounded to bf16 before each weight dot; per
// quantization group the dots with the raw code bytes (lo + 16 * hi) and with
// the high nibble are taken in f32, and the planes' scales and biases apply to
// those group partials, the bias term with the unrounded f32 sum of x.
//
// Bound on the H100: device-memory bandwidth.  A Qwen2-VL-7B step reads about
// 4.4 GB: 4.08 GB of int4 codes and f32 scale planes for the 28 x 7 linears,
// 0.34 GB of int4 lm_head and the bf16 KV history up to `offset` (17 MB at 300
// tokens, 0.49 GB at 8.5k).  At 3.35 TB/s that is about 1.3 ms.  The per-linear
// path launches ~2,400 kernels for the same step and leaves the card idle.
//
// Design: one cooperative launch, the grid sized by occupancy to every SM
// (at most MAX_BLOCKS_PER_SM blocks each), phases separated by grid barriers.
// Per layer:
//   A  q|k|v GEMV            (x = rms_norm1(h), recomputed by every block)
//   B  q|k|v finish          (sum K slices, bias, RoPE; k/v to the outputs
//                             and into the bf16 cache at `offset`)
//   C  attention partials    (kv head x history chunk; online softmax)
//   D  o GEMV                (x = the chunks combined, one head per K slice)
//   E  h += o
//   F  gate|up GEMV          (x = rms_norm2(h))
//   G  down GEMV             (x = silu(gate) * up from the gate|up slices)
//   H  h += down
// then the head: final norm + lm_head GEMV, and the logits summed in vocab
// order.  A GEMV work unit is 128 packed columns (256 outputs: the low and
// the high nibble planes) by a slice of 128 or 512 rows of K; 32 lanes of 8
// threads each stream 16-byte rows of codes, and the block writes its sums to
// a per-slice partial row.  Splitting K keeps even the 512-wide k/v
// projections spread over all SMs; the partial rows (at most 4.3 MB, read
// once by the next phase) stay in L2.  Sums are taken in a fixed order, so a
// step is deterministic.  Scratch written inside the kernel is read with
// __ldcg (L2, never the non-coherent path), so no block sees a stale line
// after a barrier.  History is read only in [0, offset): the row this step
// writes at `offset` is never read by it, which is what makes the in-kernel
// cache write safe.  Inner loops are plain f32 FMA on CUDA cores; wgmma, TMA
// and overlap of phases are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TX = 8;               // 16-byte column vectors per unit row
constexpr int TY = 32;              // K lanes per unit
constexpr int STRIP = TX * 16;      // packed columns per unit
constexpr int HD = 128;             // head size
constexpr int MAX_GQ = 8;           // q heads per kv head
constexpr int T_SUB = 64;           // history tokens per attention sub-block
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int MAX_GRID = 512;       // bound of the chunk-combine weights

enum { X_NORM, X_ATTN, X_ACT };
enum { W_Q, W_K, W_V, W_O, W_GATE, W_UP, W_DOWN, W_HEAD };

// Mirrors `_Args` in ops/fused_decode.py field by field.
struct FusedDecodeArgs {
  const void* w[40];                 // 8 linears x (qp, sl, sh, bl, bh)
  const void* bias[3];               // q, k, v biases [L, n] or null
  const void* norm1;                 // [L, D]
  const void* norm2;                 // [L, D]
  const void* final_norm;            // [D]
  const void* h_in;                  // [D]
  const void* cos;                   // [HD / 2] f32
  const void* sin;                   // [HD / 2] f32
  void* k_cache;                     // [L, 1, n_kv, C, HD] bf16
  void* v_cache;
  void* h_out;                       // [D] f32, also the residual stream
  void* k_new;                       // [L, n_kv * HD] f32
  void* v_new;
  void* logits;                      // [vocab] f32
  void* part_a;                      // q|k|v, gate|up and head partial rows
  void* part_b;                      // o and down partial rows
  void* qbuf;                        // [D] f32: q after RoPE and scaling
  void* attn_ml;                     // [n_heads, max_chunks, 2] f32
  void* attn_acc;                    // [n_heads, max_chunks, HD] f32
  int n2p[8];
  int ks[5];                         // K rows per unit: qkv, o, gu, down, head
  int L, D, I, n_heads, n_kv, group_size, capacity, offset, vocab;
  int has_head, small_bf16, max_chunks;
  float eps, scale;
};

struct Lin {
  const uint8_t* qp;
  const float *sl, *sh, *bl, *bh;
  int n2p, out_off;
};

struct Smem {
  float red[THREADS / 32][2 * STRIP];
  float xs[512];                     // x slice, f32
  float xb[512];                     // x slice rounded to bf16
  float q[MAX_GQ][HD];
  float qb[MAX_GQ][HD];
  float s[MAX_GQ][T_SUB];            // scores, then bf16-rounded probabilities
  float m[MAX_GQ], l[MAX_GQ], alpha[MAX_GQ];
  float wc[MAX_GRID];                // chunk-combine weights
  float stat;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// small inputs (h, norms, biases) come in the model's dtype
__device__ __forceinline__ float ldp(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ Lin make_lin(const FusedDecodeArgs& a, int i, int l, int K,
                        int out_off) {
  Lin r;
  r.n2p = a.n2p[i];
  const size_t qs = (size_t)l * K * r.n2p;
  const size_t ps = (size_t)l * (K / a.group_size) * r.n2p;
  r.qp = static_cast<const uint8_t*>(a.w[5 * i]) + qs;
  r.sl = static_cast<const float*>(a.w[5 * i + 1]) + ps;
  r.sh = static_cast<const float*>(a.w[5 * i + 2]) + ps;
  r.bl = static_cast<const float*>(a.w[5 * i + 3]) + ps;
  r.bh = static_cast<const float*>(a.w[5 * i + 4]) + ps;
  r.out_off = out_off;
  return r;
}

// history tokens per attention unit and the number of chunks: enough chunks
// to give every block a unit, each a whole number of T_SUB sub-blocks
__device__ int attn_chunks(const FusedDecodeArgs& a, int* tokens) {
  const int nsub = (a.offset + T_SUB - 1) / T_SUB;
  const int target = max(1, (int)gridDim.x / a.n_kv);
  const int per = max(1, (nsub + target - 1) / target);
  *tokens = per * T_SUB;
  return max(1, (a.offset + *tokens - 1) / *tokens);
}

// 1 / rms(h) of the residual stream, into sm.stat (every block, redundantly)
__device__ void block_inv_rms(const FusedDecodeArgs& a, Smem& sm) {
  const float* h = static_cast<const float*>(a.h_out);
  float s = 0.f;
  for (int i = threadIdx.x; i < a.D; i += THREADS) {
    const float v = __ldcg(h + i);
    s = fmaf(v, v, s);
  }
  s = warp_sum(s);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red[0][threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += sm.red[0][w];
    sm.stat = 1.f / sqrtf(t / (float)a.D + a.eps);
  }
  __syncthreads();
}

// x rows [r0, r0 + KS) of the phase's input, into sm.xs / sm.xb
__device__ void stage_x(const FusedDecodeArgs& a, Smem& sm, int mode, int l,
                        const void* norm_w, int r0, int KS) {
  const int tid = threadIdx.x;
  if (mode == X_ATTN) {  // KS == HD: the slice is one head's output
    const int hh = r0 / HD;
    int T;
    const int nch = attn_chunks(a, &T);
    const float* ml = static_cast<const float*>(a.attn_ml) +
                      (size_t)hh * a.max_chunks * 2;
    const float* acc = static_cast<const float*>(a.attn_acc) +
                       (size_t)hh * a.max_chunks * HD;
    if (tid < 32) {
      float M = -INFINITY;
      for (int c = tid; c < nch; c += 32) M = fmaxf(M, __ldcg(ml + 2 * c));
      M = warp_max(M);
      float Ls = 0.f;
      for (int c = tid; c < nch; c += 32)
        Ls += __ldcg(ml + 2 * c + 1) * expf(__ldcg(ml + 2 * c) - M);
      Ls = warp_sum(Ls);
      for (int c = tid; c < nch; c += 32)
        sm.wc[c] = expf(__ldcg(ml + 2 * c) - M) / Ls;
    }
    __syncthreads();
    if (tid < HD) {
      float x = 0.f;
      for (int c = 0; c < nch; ++c)
        x = fmaf(__ldcg(acc + (size_t)c * HD + tid), sm.wc[c], x);
      sm.xs[tid] = x;
      sm.xb[tid] = bf16r(x);
    }
    return;
  }
  const float* h = static_cast<const float*>(a.h_out);
  const float* pa = static_cast<const float*>(a.part_a);
  const int gu_stride = 2 * (a.n2p[W_GATE] + a.n2p[W_UP]);
  const int gu_slices = a.D / a.ks[2];
  for (int r = tid; r < KS; r += THREADS) {
    float x;
    if (mode == X_NORM) {
      x = __ldcg(h + r0 + r) * sm.stat *
          ldp(norm_w, (size_t)l * a.D + r0 + r, a.small_bf16);
    } else {  // X_ACT: gate * sigmoid(gate) * up
      float g = 0.f, u = 0.f;
      for (int s = 0; s < gu_slices; ++s) {
        const float* row = pa + (size_t)s * gu_stride;
        g += __ldcg(row + r0 + r);
        u += __ldcg(row + 2 * a.n2p[W_GATE] + r0 + r);
      }
      x = g * (1.f / (1.f + expf(-g))) * u;
    }
    sm.xs[r] = x;
    sm.xb[r] = bf16r(x);
  }
}

// y = x @ dequant(W) for up to three linears sharing x; partial row `slice`
// of `out` gets the unit's 256 outputs
template <int R>
__device__ void gemv(const FusedDecodeArgs& a, Smem& sm, const Lin* lins,
                     int nlin, int K, int mode, int l, const void* norm_w,
                     float* out, int stride) {
  constexpr int KS = R * TY;
  const int tid = threadIdx.x, tx = tid & (TX - 1), ty = tid / TX;
  int strips = 0;
  for (int i = 0; i < nlin; ++i) strips += lins[i].n2p / STRIP;
  const int units = strips * (K / KS);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int slice = u / strips;
    int strip = u % strips, li = 0;
    while (strip >= lins[li].n2p / STRIP) strip -= lins[li++].n2p / STRIP;
    const Lin& w = lins[li];
    const int r0 = slice * KS;
    __syncthreads();  // the previous unit is done with xs and red
    stage_x(a, sm, mode, l, norm_w, r0, KS);
    __syncthreads();

    const int col0 = strip * STRIP + tx * 16;
    const int row0 = r0 + ty * R;  // a lane's R rows lie in one group
    const uint8_t* qrow = w.qp + (size_t)row0 * w.n2p + col0;
    float z2[16], zh[16], sig = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) z2[i] = zh[i] = 0.f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const uint4 q =
          __ldcs(reinterpret_cast<const uint4*>(qrow + (size_t)r * w.n2p));
      const float xv = sm.xb[ty * R + r];
      sig += sm.xs[ty * R + r];
      const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t b = (wd[i >> 2] >> (8 * (i & 3))) & 0xFFu;
        z2[i] = fmaf(xv, (float)b, z2[i]);
        zh[i] = fmaf(xv, (float)(b >> 4), zh[i]);
      }
    }
    const size_t so = (size_t)(row0 / a.group_size) * w.n2p + col0;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 sl = __ldcs(reinterpret_cast<const float4*>(w.sl + so) + v);
      const float4 sh = __ldcs(reinterpret_cast<const float4*>(w.sh + so) + v);
      const float4 bl = __ldcs(reinterpret_cast<const float4*>(w.bl + so) + v);
      const float4 bh = __ldcs(reinterpret_cast<const float4*>(w.bh + so) + v);
      const float s_l[4] = {sl.x, sl.y, sl.z, sl.w};
      const float s_h[4] = {sh.x, sh.y, sh.z, sh.w};
      const float b_l[4] = {bl.x, bl.y, bl.z, bl.w};
      const float b_h[4] = {bh.x, bh.y, bh.z, bh.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * v + j;
        const float zl = z2[i] - 16.f * zh[i];
        z2[i] = zl * s_l[j] + sig * b_l[j];
        zh[i] = zh[i] * s_h[j] + sig * b_h[j];
      }
    }
    // the 4 K lanes of a warp, then the 8 warps
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      z2[i] += __shfl_xor_sync(0xffffffffu, z2[i], 8);
      z2[i] += __shfl_xor_sync(0xffffffffu, z2[i], 16);
      zh[i] += __shfl_xor_sync(0xffffffffu, zh[i], 8);
      zh[i] += __shfl_xor_sync(0xffffffffu, zh[i], 16);
    }
    if ((tid & 31) < TX) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sm.red[tid >> 5][i * TX + tx] = z2[i];
        sm.red[tid >> 5][STRIP + i * TX + tx] = zh[i];
      }
    }
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < THREADS / 32; ++wi) s += sm.red[wi][tid];
    const int half = tid / STRIP, p = tid % STRIP;
    const int col = strip * STRIP + (p % TX) * 16 + p / TX;
    out[(size_t)slice * stride + w.out_off + half * w.n2p + col] = s;
  }
}

__device__ void gemv_ks(const FusedDecodeArgs& a, Smem& sm, const Lin* lins,
                        int nlin, int K, int KS, int mode, int l,
                        const void* norm_w, void* out, int stride) {
  if (mode == X_NORM) block_inv_rms(a, sm);
  if (KS == 512)
    gemv<16>(a, sm, lins, nlin, K, mode, l, norm_w, static_cast<float*>(out),
             stride);
  else
    gemv<4>(a, sm, lins, nlin, K, mode, l, norm_w, static_cast<float*>(out),
            stride);
}

// B: sum the q|k|v slices, add the biases, RoPE; q (scaled) to qbuf, k/v to
// k_new / v_new and into the cache row `offset`
__device__ void qkv_finish(const FusedDecodeArgs& a, int l) {
  const int nq = a.n_heads * HD, nk = a.n_kv * HD;
  const int off[3] = {0, 2 * a.n2p[W_Q], 2 * (a.n2p[W_Q] + a.n2p[W_K])};
  const int nlen[3] = {nq, nk, nk};
  const int stride = 2 * (a.n2p[W_Q] + a.n2p[W_K] + a.n2p[W_V]);
  const int slices = a.D / a.ks[0];
  const float* pa = static_cast<const float*>(a.part_a);
  const float* cs = static_cast<const float*>(a.cos);
  const float* sn = static_cast<const float*>(a.sin);
  const int step = gridDim.x * THREADS;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < nq + 2 * nk;
       i += step) {
    const int seg = i < nq ? 0 : (i < nq + nk ? 1 : 2);
    const int idx = i - (seg == 0 ? 0 : (seg == 1 ? nq : nq + nk));
    auto value = [&](int j) {
      float s = 0.f;
      for (int k = 0; k < slices; ++k)
        s += __ldcg(pa + (size_t)k * stride + off[seg] + j);
      if (a.bias[seg])
        s += ldp(a.bias[seg], (size_t)l * nlen[seg] + j, a.small_bf16);
      return s;
    };
    float val = value(idx);
    const int d = idx % HD;
    if (seg < 2) {  // duplicated-half RoPE
      const int hf = HD / 2;
      const float pv = value(d < hf ? idx + hf : idx - hf);
      const float rot = d < hf ? -pv : pv;
      val = val * cs[d % hf] + rot * sn[d % hf];
    }
    if (seg == 0) {
      static_cast<float*>(a.qbuf)[idx] = val * a.scale;
    } else {
      float* dst = static_cast<float*>(seg == 1 ? a.k_new : a.v_new);
      dst[(size_t)l * nk + idx] = val;
      __nv_bfloat16* cache =
          static_cast<__nv_bfloat16*>(seg == 1 ? a.k_cache : a.v_cache);
      const int kv = idx / HD;
      cache[(((size_t)l * a.n_kv + kv) * a.capacity + a.offset) * HD + d] =
          __float2bfloat16(val);
    }
  }
}

// C: one unit per (kv head, history chunk): bf16 q . bf16 k scores, an
// online softmax over T_SUB-token sub-blocks with bf16-rounded
// probabilities for the value dot; chunk 0 starts from the current token
// (f32 score and value).  Writes (m, l, acc) per q head and chunk.
__device__ void attention(const FusedDecodeArgs& a, Smem& sm, int l) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkv = a.n_kv, gq = a.n_heads / nkv;
  int T;
  const int nch = attn_chunks(a, &T);
  const float* qbuf = static_cast<const float*>(a.qbuf);
  const float* kn = static_cast<const float*>(a.k_new) + (size_t)l * nkv * HD;
  const float* vn = static_cast<const float*>(a.v_new) + (size_t)l * nkv * HD;
  const int d = tid % HD, hg = tid / HD;
  for (int u = blockIdx.x; u < nkv * nch; u += gridDim.x) {
    const int kvh = u % nkv, c = u / nkv;
    const int t0 = c * T, t1 = min(a.offset, t0 + T);
    const size_t base = ((size_t)l * nkv + kvh) * a.capacity * HD;
    const __nv_bfloat16* kb =
        static_cast<const __nv_bfloat16*>(a.k_cache) + base;
    const __nv_bfloat16* vb =
        static_cast<const __nv_bfloat16*>(a.v_cache) + base;
    __syncthreads();
    for (int i = tid; i < gq * HD; i += THREADS) {
      const float v = __ldcg(qbuf + (size_t)kvh * gq * HD + i);
      sm.q[i / HD][i % HD] = v;
      sm.qb[i / HD][i % HD] = bf16r(v);
    }
    __syncthreads();
    if (warp < gq) {
      float m = -INFINITY, ls = 0.f;
      if (c == 0) {
        float s = 0.f;
        for (int j = lane; j < HD; j += 32)
          s = fmaf(sm.q[warp][j], __ldcg(kn + kvh * HD + j), s);
        m = warp_sum(s);
        ls = 1.f;
      }
      if (lane == 0) {
        sm.m[warp] = m;
        sm.l[warp] = ls;
      }
    }
    float acc[4];
    const float vcur = c == 0 ? __ldcg(vn + kvh * HD + d) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = vcur;
    __syncthreads();
    for (int s0 = t0; s0 < t1; s0 += T_SUB) {
      const int n = min(T_SUB, t1 - s0);
      for (int tt = warp; tt < T_SUB; tt += THREADS / 32) {
        if (tt < n) {
          const uint2 raw = __ldcs(
              reinterpret_cast<const uint2*>(kb + (size_t)(s0 + tt) * HD) +
              lane);
          const __nv_bfloat162 k01 =
              *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
          const __nv_bfloat162 k23 =
              *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
          const float2 f01 = __bfloat1622float2(k01);
          const float2 f23 = __bfloat1622float2(k23);
          for (int h = 0; h < gq; ++h) {
            const float* qh = &sm.qb[h][lane * 4];
            float p = qh[0] * f01.x;
            p = fmaf(qh[1], f01.y, p);
            p = fmaf(qh[2], f23.x, p);
            p = fmaf(qh[3], f23.y, p);
            p = warp_sum(p);
            if (lane == 0) sm.s[h][tt] = p;
          }
        } else if (lane == 0) {
          for (int h = 0; h < gq; ++h) sm.s[h][tt] = -INFINITY;
        }
      }
      __syncthreads();
      if (warp < gq) {
        const float sa = sm.s[warp][lane], sb = sm.s[warp][lane + 32];
        const float m_old = sm.m[warp];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(sa, sb)));
        const float pa = expf(sa - m_new), pb = expf(sb - m_new);
        const float ps = warp_sum(pa + pb);
        __syncwarp();
        sm.s[warp][lane] = bf16r(pa);
        sm.s[warp][lane + 32] = bf16r(pb);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          sm.alpha[warp] = alpha;
          sm.m[warp] = m_new;
          sm.l[warp] = sm.l[warp] * alpha + ps;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (hg + 2 * j < gq) acc[j] *= sm.alpha[hg + 2 * j];
      for (int tt = 0; tt < n; ++tt) {
        const float vv = __bfloat162float(vb[(size_t)(s0 + tt) * HD + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (hg + 2 * j < gq) acc[j] = fmaf(sm.s[hg + 2 * j][tt], vv, acc[j]);
      }
      __syncthreads();
    }
    float* ml = static_cast<float*>(a.attn_ml);
    float* ac = static_cast<float*>(a.attn_acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hh = hg + 2 * j;
      if (hh < gq) {
        const size_t head = (size_t)kvh * gq + hh;
        ac[(head * a.max_chunks + c) * HD + d] = acc[j];
      }
    }
    if (tid < gq) {
      const size_t head = (size_t)kvh * gq + tid;
      ml[(head * a.max_chunks + c) * 2] = sm.m[tid];
      ml[(head * a.max_chunks + c) * 2 + 1] = sm.l[tid];
    }
  }
}

// E / H: h += the sum of a GEMV's K slices
__device__ void residual(const FusedDecodeArgs& a, const void* part,
                         int slices, int stride) {
  float* h = static_cast<float*>(a.h_out);
  const float* p = static_cast<const float*>(part);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < a.D;
       i += gridDim.x * THREADS) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += __ldcg(p + (size_t)k * stride + i);
    h[i] = __ldcg(h + i) + s;
  }
}

__global__ void __launch_bounds__(THREADS, MAX_BLOCKS_PER_SM)
    fused_decode_kernel(const FusedDecodeArgs a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int D = a.D, I = a.I;
  float* h = static_cast<float*>(a.h_out);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < D;
       i += gridDim.x * THREADS)
    h[i] = ldp(a.h_in, i, a.small_bf16);
  grid.sync();
  const int qkv_stride = 2 * (a.n2p[W_Q] + a.n2p[W_K] + a.n2p[W_V]);
  const int o_stride = 2 * a.n2p[W_O];
  const int gu_stride = 2 * (a.n2p[W_GATE] + a.n2p[W_UP]);
  const int dn_stride = 2 * a.n2p[W_DOWN];
  for (int l = 0; l < a.L; ++l) {
    Lin lins[3];
    lins[0] = make_lin(a, W_Q, l, D, 0);
    lins[1] = make_lin(a, W_K, l, D, 2 * a.n2p[W_Q]);
    lins[2] = make_lin(a, W_V, l, D, 2 * (a.n2p[W_Q] + a.n2p[W_K]));
    gemv_ks(a, sm, lins, 3, D, a.ks[0], X_NORM, l, a.norm1, a.part_a,
            qkv_stride);
    grid.sync();
    qkv_finish(a, l);
    grid.sync();
    attention(a, sm, l);
    grid.sync();
    lins[0] = make_lin(a, W_O, l, D, 0);
    gemv_ks(a, sm, lins, 1, D, a.ks[1], X_ATTN, l, nullptr, a.part_b,
            o_stride);
    grid.sync();
    residual(a, a.part_b, D / a.ks[1], o_stride);
    grid.sync();
    lins[0] = make_lin(a, W_GATE, l, D, 0);
    lins[1] = make_lin(a, W_UP, l, D, 2 * a.n2p[W_GATE]);
    gemv_ks(a, sm, lins, 2, D, a.ks[2], X_NORM, l, a.norm2, a.part_a,
            gu_stride);
    grid.sync();
    lins[0] = make_lin(a, W_DOWN, l, I, 0);
    gemv_ks(a, sm, lins, 1, I, a.ks[3], X_ACT, l, nullptr, a.part_b,
            dn_stride);
    grid.sync();
    residual(a, a.part_b, I / a.ks[3], dn_stride);
    grid.sync();
  }
  if (!a.has_head) return;
  Lin head = make_lin(a, W_HEAD, 0, D, 0);
  const int hd_stride = 2 * a.n2p[W_HEAD];
  gemv_ks(a, sm, &head, 1, D, a.ks[4], X_NORM, 0, a.final_norm, a.part_a,
          hd_stride);
  grid.sync();
  const float* pa = static_cast<const float*>(a.part_a);
  float* logits = static_cast<float*>(a.logits);
  const int slices = D / a.ks[4];
  for (int c = blockIdx.x * THREADS + threadIdx.x; c < a.vocab;
       c += gridDim.x * THREADS) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += __ldcg(pa + (size_t)k * hd_stride + c);
    logits[c] = s;
  }
}

bool valid(const FusedDecodeArgs& a, int grid) {
  if (a.n_kv <= 0 || a.n_heads % a.n_kv || a.n_heads / a.n_kv > MAX_GQ)
    return false;
  if (a.D != a.n_heads * HD || a.group_size % 16 || a.ks[1] != HD)
    return false;
  const int K[5] = {a.D, a.D, a.D, a.I, a.D};
  for (int i = 0; i < 5; ++i)
    if ((a.ks[i] != 128 && a.ks[i] != 512) || K[i] % a.ks[i]) return false;
  for (int i = 0; i < (a.has_head ? 8 : 7); ++i)
    if (a.n2p[i] <= 0 || a.n2p[i] % STRIP) return false;
  if (a.has_head && a.vocab > 2 * a.n2p[W_HEAD]) return false;
  return a.offset >= 0 && a.offset < a.capacity && a.max_chunks >= grid;
}

}  // namespace

// blocks of the cooperative grid on the current device (negative: an error)
extern "C" int mvt_fused_decode_grid() {
  int dev = 0, sms = 0, coop = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, fused_decode_kernel, THREADS, 0);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorCooperativeLaunchTooLarge;
  return std::min(MAX_GRID, sms * std::min(per, MAX_BLOCKS_PER_SM));
}

extern "C" int mvt_fused_decode(const void* args, void* stream) {
  const FusedDecodeArgs* a = static_cast<const FusedDecodeArgs*>(args);
  const int grid = mvt_fused_decode_grid();
  if (grid < 0) return -grid;
  if (grid == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (!valid(*a, grid)) return (int)cudaErrorInvalidValue;
  void* params[] = {const_cast<FusedDecodeArgs*>(a)};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_decode_kernel), dim3(grid), dim3(THREADS),
      params, 0, static_cast<cudaStream_t>(stream));
}
