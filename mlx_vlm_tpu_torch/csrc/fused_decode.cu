// K3: the whole-stack int4 decode step (B = 1, S = 1) in one persistent kernel.
//
// Replaces mlx_vlm_tpu/ops/fused_decode.py: `fused_decode_step` (:1355, the
// pipelined grid) and `fused_decode_step_manual` (:964, the manual-DMA kernel
// with its optional fused lm_head).  It follows the manual kernel's "z2" math
// (`_mv2z` :1085) up to f32 reassociation: x is rounded to bf16 before each
// weight dot, each quantization group's dots with the low and the high code
// planes are taken in f32, and the planes' scales and biases apply to those
// group partials, the bias term with the unrounded f32 sum of x.  (The
// reference sums z2 = lo + 16 hi and subtracts 16 zh; here the low plane is
// summed directly, which is the same sum.)
//
// Bound on the H100: device-memory bandwidth.  A Qwen2-VL-7B step reads about
// 4.4 GB: 4.08 GB of int4 codes and f32 scale planes for the 28 x 7 linears,
// 0.34 GB of int4 lm_head and the bf16 KV history up to the cursor (17 MB at
// 300 tokens, 0.49 GB at 8.5k).  At 3.35 TB/s that is about 1.3 ms.
//
// Design: one cooperative launch of one block per SM: two consumer
// warpgroups and a producer warpgroup; phases separated by grid barriers
// among the consumers.  Per layer five phases, five barriers:
//   QKV   q|k|v GEMV, x = rms_norm1(h)
//   ATTN  per (kv head, history chunk): sum the unit's q|k|v pieces, bias,
//         RoPE (the chunk-0 unit writes k_new, v_new and the cache row at
//         the cursor), then attention over the chunk on mma.sync
//   O     o GEMV, x = the chunks combined; the reduce epilogue adds the
//         residual: h += o
//   GU    gate|up GEMV, x = rms_norm2(h); the epilogue writes silu(gate) up
//   DOWN  down GEMV, x = act; the epilogue: h += down
// then the head: x = final_norm(h), lm_head GEMV, the epilogue writes the
// logits.  What it does about the bound:
//
// - One ring that runs ahead.  Nothing the ring carries depends on what the
//   step computes, so each block owns a fixed list of stages for the whole
//   step (the host plan, ops/fused_decode.py:fused_decode_plan: a phase's
//   quantization groups, strip by strip of 128 packed columns, cut into
//   equal contiguous ranges, one per block; a range's part in one strip is
//   a piece).  A weight stage is a TMA box of 64 k rows x 128 packed
//   columns (128-byte swizzle, 8 KB) from a 2-D map over the [L * K, N2p]
//   codes, with the four scale planes of each group that ends in it by
//   cp.async.bulk, one copy per lane; after a layer's q|k|v pieces come
//   its attention unit's history tiles, 64 tokens x 64 dims of K or V a
//   stage, from 3-D maps over the whole capacity.  The four producer
//   warps take the stages in turn and wait only for a free stage, never for
//   x or a barrier, so they cross phase boundaries, grid barriers and
//   layers, as the reference's cross-kind lookahead does (:665-686): while
//   the consumers wait at a barrier or stage x, the next phase's stages
//   land (19 stages of 10 KB at 7B with g = 64).
// - Code sums on the tensor cores (K2's method, csrc/int4_matvec.cu): a byte
//   permute and one LOP3 make two codes exact bf16 values 128 + q, and
//   `mma.sync m16n8k16` sums x (128 + q) against bf16 x (padded to the MMA's
//   8 columns at no cost in bytes).  Each group folds as
//   y += s (sum x_b (128 + q) - 128 sum x_b) + b sum x_f32, with both sums
//   of x (the bias term's unrounded) taken once per group by the x staging
//   on the CUDA cores.  No code goes through an int -> float conversion.
//   (Folding (b - 128 s) sum x_f32 instead would leave 128 s sum (x_b - x)
//   in every group, far outside the reference's agreement.)  A piece's rows
//   go in units of lcm(64, g) rows (whole stages and whole groups) to the
//   two warpgroups in turn, so that two stages are in work at once; their
//   sums are added in warpgroup order at the piece's end.  The x of a norm
//   phase is staged once for all its pieces, with its loads in flight
//   together.
// - Fewer barriers: the q|k|v finish runs inside the attention units, and
//   the residual adds inside the reduce epilogue of the o and down GEMVs: a
//   ticket per strip (integer atomic) lets the last of its pieces add all
//   pieces in order (a strip of one piece needs no ticket), so sums keep a
//   fixed order (no float atomics) and a step is bit-identical from run to
//   run.  The epilogue also writes each strip's sum of h^2, from which the
//   next phase takes rms(h).  5 barriers a layer, 5 L a step (226 in the
//   first design).  Layer 0 reads the input h directly.  h_out is updated in
//   place: in a phase only the block that closes a strip reads and writes
//   its columns.
// - Attention on mma.sync: S = q k^T with the gq <= 8 q heads of a kv head
//   as the M rows (padded to 16), then O^T += V^T P^T, so that P stays in
//   the registers where S landed (the B operand) and O^T holds only real
//   heads.  Rows at or past the cursor are kept out of both products: their
//   scores are set to -inf, and their value rows are read as zeros (the
//   lanes of the P V ldmatrix that address such a row point at a zero row
//   in shared memory instead; 0 x NaN would be NaN), so whatever the cache
//   holds past the cursor never reaches a sum.  Warpgroup 0 takes the
//   tiles, each warp 16 tokens with its own online softmax; q, history k/v
//   and probabilities are rounded to bf16, the current token's score and
//   value stay f32 (reference :826-851).  The chunk count gives every block
//   a unit where the history allows; each unit's (m, l, acc) is combined in
//   order in the o staging.
// - The cursor is a device word (`cursor`), read once per launch: the
//   history length, the row the step writes and the attention chunks,
//   min(max_chunks, ceil(offset / T_TILE)), all come from it, so one
//   launch captured in a CUDA graph serves every step as the word advances.
//   Everything the host passes is fixed per cache and plan.
// - Scratch written in the kernel is read with __ldcg (L2), never through
//   the non-coherent path.  Waits time out after 2 s and trap, so a fault
//   ends the launch with an error instead of a hang.
//
// Measured (PERF.md, NVIDIA H100 80GB HBM3): the weight stages arrive at
// ~1.5 TB/s in the big phases, about what one box of 64 rows x 128 bytes at
// a large row stride gets from the memory system (K2 streams the same boxes
// at up to ~1.8 TB/s), and each phase boundary adds a chain of L2 round
// trips that the ring covers only in part.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tma_ring.cuh"

namespace {

// Mirrored in ops/fused_decode.py (the plan): keep both in step.
constexpr int NWG = 2;                     // consumer warpgroups
constexpr int CWARPS = 4 * NWG;            // consumer warps
constexpr int CONSUMERS = CWARPS * 32;
constexpr int THREADS = CONSUMERS + 128;   // + the producer warpgroup
constexpr int BK = 64;                     // code rows per ring stage
constexpr int STRIP = 128;                 // packed columns per piece
constexpr int Q_BYTES = BK * STRIP;        // codes of one stage, 8 KB
constexpr int SLOT_BYTES = 4 * STRIP * 4;  // one group's [sl sh bl bh]
constexpr int MAX_STAGES = 32;
constexpr int HD = 128;                    // head size
constexpr int MAX_GQ = 8;                  // q heads per kv head
constexpr int T_TILE = 64;                 // history tokens per attention tile
constexpr int KV_BOX = T_TILE * 64 * 2;    // [64 tokens, 64 dims] bf16: a stage
// shared memory an attention unit needs in the x region: the q|k|v rows,
// then the four attention warps' (m, l) and O^T for the combine
constexpr int ATT_SCRATCH = ((MAX_GQ + 2) * HD + 4 * (2 + HD) * MAX_GQ) * 4;
constexpr int MAX_CHUNKS = 160;
constexpr long long TIMEOUT_NS = 2000000000LL;
static_assert(NWG >= 2, "the reduce epilogue takes 256 consumer threads");

enum { W_Q, W_K, W_V, W_O, W_GATE, W_UP, W_DOWN, W_HEAD };
enum { P_QKV, P_O, P_GU, P_DOWN, P_HEAD };
enum { X_NORM, X_ATTN, X_ACT };

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
  void* part;                        // partial rows: [strip][piece][256]
  void* act;                         // [I] f32: silu(gate) * up
  void* attn_ml;                     // [n_heads, max_chunks, 2] f32
  void* attn_acc;                    // [n_heads, max_chunks, HD] f32
  void* sumsq;                       // [2][D / 256] f32: h^2 per strip
  void* sync;                        // u32: grid barrier, then the tickets
  const int* cursor;                 // int32: history rows, the write row
  int n2p[8];
  int pmax[5];                       // pieces a strip has at most, per phase
  int L, D, I, n_heads, n_kv, group_size, capacity, vocab;
  int has_head, small_bf16;
  int grid, stages, slots, xrows, seg_rows, unit_rows, max_chunks;
  int smem_bytes;
  float eps, scale;
};

// What the kernel receives: the arguments and the TMA maps, built per call.
struct Params {
  FusedDecodeArgs a;
  CUtensorMap wmap[8];               // codes [L * K, N2p] u8 (head: [K, N2p])
  CUtensorMap kmap, vmap;            // history [L * n_kv, capacity, HD] bf16
};
static_assert(sizeof(Params) <= 4096, "kernel parameters fit in 4 KB");

struct Static {
  uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  float wc[CWARPS][MAX_CHUNKS];      // chunk-combine weights, a head a warp
  float red[NWG - 1][2 * STRIP];     // warpgroups' sums of a piece
  float red2[CWARPS];
  float scur[MAX_GQ];                // current token's score per q head
  float cs[HD];                      // RoPE's cos, then sin
  float inv;                         // 1 / rms of h
  int last;                          // this block closed a ticket
  int offset, chunks;                // the cursor and the attention chunks
  uint4 zero;                        // a zero row of 8 bf16 for ldmatrix
};

struct Phase {
  int lin0, nlin, K, G, strips, U, nb, pmax, key0;  // nb: blocks with units
};

// A block's piece: rows [kb, ke) of strip `strip` of its phase (packed
// columns j0 + [0, 128) of linear `lin`), the strip's piece number `ord`
struct Piece {
  int strip, lin, j0, kb, ke, ord;
};

// ------------------------------------------------------------ helpers
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// mbarrier wait (tma_ring.cuh's, with the timeout)
__device__ __forceinline__ void wait_bar(uint64_t* bar, int phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (int spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
    if (!done && (spin & 1023) == 1023) {
      if (!t0) t0 = now_ns();
      else if (now_ns() - t0 > TIMEOUT_NS) __trap();
    }
  }
}

// the consumer warps only (the producer never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// atomic add with release and acquire semantics at device scope: the
// block's writes before it (ordered by a bar.sync) are visible to whoever
// reads the new value, and what they wrote before is visible here
__device__ __forceinline__ uint32_t atom_add_acq_rel(uint32_t* p, uint32_t v) {
  uint32_t old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Grid barrier among the consumer warps of every block (all resident: the
// launch is cooperative).  Block 0 adds 2^31 - (blocks - 1), every other
// block 1, so the top bit flips when the last block arrives and the rest
// of the word is left as it was: the word needs no reset between barriers
// or launches.  The bar.sync before the release add and after the acquire
// loads orders every thread's accesses (CUTLASS's grid barrier pattern).
__device__ void grid_barrier(uint32_t* bar, int blocks) {
  consumer_sync();
  if (threadIdx.x == 0) {
    const uint32_t inc = blockIdx.x == 0 ? 0x80000000u - (blocks - 1) : 1u;
    const uint32_t flip = (atom_add_acq_rel(bar, inc) >> 31) ^ 1;
    long long t0 = now_ns();
    for (int spin = 0; (ld_acquire(bar) >> 31) != flip; ++spin)
      if ((spin & 1023) == 1023 && now_ns() - t0 > TIMEOUT_NS) __trap();
  }
  consumer_sync();
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A word of shared memory, loaded where it is used: a value the kernel set
// once (the cursor, the chunk count) need not hold a register across loops
__device__ __forceinline__ int lds(const int* p) {
  int v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(smem_u32(p)));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// Byte offset of (row, byte c) in a tile of 128-byte rows written by TMA
// with the 128-byte swizzle: 16-byte chunk c / 16 is XORed with row % 8.
__device__ __forceinline__ int swz(int row, int c) {
  return row * 128 + ((((c >> 4) ^ row) & 7) << 4) + (c & 15);
}

// Shared address of token `tok`, 8-dim block `blk` (0..15) of a K or V
// tile: two [64 tokens, 64 dims] boxes (ring stages at b[0], b[1]) written
// by TMA with the 128-byte swizzle.
__device__ __forceinline__ uint32_t kv_at(const uint32_t (&b)[2], int tok,
                                          int blk) {
  return b[blk >> 3] + tok * 128 + (((blk & 7) ^ (tok & 7)) << 4);
}

// sum of src[p * stride] for p < n, in order, with 8 loads in flight
__device__ __forceinline__ float sum_rows(const float* src, int n,
                                          size_t stride) {
  float s = 0.f;
  for (int p0 = 0; p0 < n; p0 += 8) {
    float v[8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
      v[p] = p0 + p < n ? __ldcg(src + (size_t)(p0 + p) * stride) : 0.f;
#pragma unroll
    for (int p = 0; p < 8; ++p) s += v[p];
  }
  return s;
}

// ------------------------------------------------------------ the plan
// Mirrored by ops/fused_decode.py:FusedDecodePlan.

__device__ __forceinline__ Phase phase_of(const FusedDecodeArgs& a, int p) {
  // ticket counters: o, gate|up (one per gate strip), down, head
  const int o = a.n2p[W_O] / STRIP, gu = a.n2p[W_GATE] / STRIP;
  const int dn = a.n2p[W_DOWN] / STRIP;
  Phase r;
  r.K = a.D;
  switch (p) {
    case P_QKV: r.lin0 = W_Q, r.nlin = 3, r.key0 = 0; break;
    case P_O: r.lin0 = W_O, r.nlin = 1, r.key0 = 0; break;
    case P_GU: r.lin0 = W_GATE, r.nlin = 2, r.key0 = o; break;
    case P_DOWN: r.lin0 = W_DOWN, r.nlin = 1, r.key0 = o + gu, r.K = a.I;
      break;
    default: r.lin0 = W_HEAD, r.nlin = 1, r.key0 = o + gu + dn; break;
  }
  r.strips = 0;
  for (int i = 0; i < r.nlin; ++i) r.strips += a.n2p[r.lin0 + i] / STRIP;
  r.G = r.K / a.group_size;
  r.U = r.strips * r.G;
  r.nb = min(a.grid, r.U);  // so that every block in use owns a unit
  r.pmax = a.pmax[p];
  return r;
}

// the block whose range holds group unit u of a phase (U * nb < 2^32)
__device__ __forceinline__ int owner(const Phase& ph, int u) {
  return (int)(((unsigned)u * ph.nb + ph.nb - 1) / (unsigned)ph.U);
}

__device__ __forceinline__ int pieces_of(const Phase& ph, int s) {
  return owner(ph, s * ph.G + ph.G - 1) - owner(ph, s * ph.G) + 1;
}

// this block's group units [u0, u1) of a phase
__device__ __forceinline__ void unit_range(const Phase& ph, int* u0, int* u1) {
  const unsigned b = min((int)blockIdx.x, ph.nb);
  *u0 = (int)((unsigned)ph.U * b / ph.nb);
  *u1 = (int)((unsigned)ph.U * min(b + 1, (unsigned)ph.nb) / ph.nb);
}

// the piece of this block that starts at unit u (u < u1)
__device__ Piece piece_at(const FusedDecodeArgs& a, const Phase& ph, int u,
                          int u1) {
  Piece r;
  r.strip = u / ph.G;
  const int ue = min(u1, (r.strip + 1) * ph.G);
  int s = r.strip, lin = ph.lin0;
  while (s >= a.n2p[lin] / STRIP) s -= a.n2p[lin++] / STRIP;
  r.lin = lin;
  r.j0 = s * STRIP;
  r.kb = (u - r.strip * ph.G) * a.group_size;
  r.ke = (ue - r.strip * ph.G) * a.group_size;
  r.ord = blockIdx.x - owner(ph, r.strip * ph.G);
  return r;
}

// ------------------------------------------------------------ producer

// The four producer warps walk the block's pieces and take its stages in
// turn; for each of its stages a warp's lane 0 waits for the stage to be
// free and arms it, then lane 0 loads the codes and lanes 1.. the scale
// planes of the groups that end in the stage.
__device__ void produce(const Params& p, uint8_t* ring, Static& st) {
  const FusedDecodeArgs& a = p.a;
  const int lane = threadIdx.x & 31, pw = (threadIdx.x - CONSUMERS) >> 5;
  int turn = 0;  // the producer warp of the next stage
  const int g = a.group_size, sb = Q_BYTES + a.slots * SLOT_BYTES;
  int s = 0, ph = 0;
  auto issue = [&](int l, int pid) {
    const Phase ps = phase_of(a, pid);
    int u0, u1;
    unit_range(ps, &u0, &u1);
    for (int u = u0; u < u1;) {
      const Piece pc = piece_at(a, ps, u, u1);
      u += (pc.ke - pc.kb) / g;
      const int n2p = a.n2p[pc.lin];
      // lane 1 + 4 q + f copies plane f of the q-th group ending in a stage
      const int f = (lane - 1) & 3, q = (lane - 1) >> 2;
      const float* plane =
          static_cast<const float*>(a.w[5 * pc.lin + 1 + f]) +
          ((size_t)l * ps.G + pc.kb / g + q) * n2p + pc.j0;
      const CUtensorMap* map = &p.wmap[pc.lin];
      const int row0 = l * ps.K;
      int gend = pc.kb + g;  // the end of the next group
      for (int k0 = pc.kb; k0 < pc.ke; k0 += BK) {
        const int k1 = min(k0 + BK, pc.ke);
        int ng = 0;
        while (gend + ng * g <= k1) ++ng;
        uint8_t* stage = ring + s * sb;
        if (turn == pw) {
          if (lane == 0) {
            wait_bar(&st.empty[s], ph ^ 1);
            mbar_expect_tx(&st.full[s], Q_BYTES + ng * SLOT_BYTES);
          }
          __syncwarp();
          if (lane == 0) {
            tma_load_2d(stage, map, &st.full[s], pc.j0, row0 + k0);
          } else if (q < ng) {
            float* sc = reinterpret_cast<float*>(stage + Q_BYTES);
            bulk_load(sc + (4 * q + f) * STRIP, plane, STRIP * 4,
                      &st.full[s]);
          }
        }
        plane += (size_t)ng * n2p;
        gend += ng * g;
        if (++s == a.stages) s = 0, ph ^= 1;
        if (++turn == 4) turn = 0;
      }
    }
  };
  // the history tiles of this block's attention units: per 64-token tile
  // four stages, K's dims [0, 64) and [64, 128), then V's
  const int nsub = (st.offset + T_TILE - 1) / T_TILE, nch = st.chunks;
  auto issue_attn = [&](int l) {
    for (int u = blockIdx.x; u < a.n_kv * nch; u += a.grid) {
      const int kvh = u % a.n_kv, ch = u / a.n_kv;
      const int t1 = (int)((unsigned)(ch + 1) * nsub / nch);
      for (int tile = (int)((unsigned)ch * nsub / nch); tile < t1; ++tile)
        for (int q = 0; q < 4; ++q) {
          if (turn == pw && lane == 0) {
            wait_bar(&st.empty[s], ph ^ 1);
            mbar_expect_tx(&st.full[s], KV_BOX);
            tma_load_3d(ring + s * sb, q < 2 ? &p.kmap : &p.vmap,
                        &st.full[s], (q & 1) * 64, tile * T_TILE,
                        l * a.n_kv + kvh);
          }
          if (++s == a.stages) s = 0, ph ^= 1;
          if (++turn == 4) turn = 0;
        }
    }
  };
  for (int l = 0; l < a.L; ++l) {
    issue(l, P_QKV);
    issue_attn(l);
    for (int pid = P_O; pid <= P_DOWN; ++pid) issue(l, pid);
  }
  if (a.has_head) issue(0, P_HEAD);
}

// ------------------------------------------------------------ consumers

struct Ctx {
  const Params& p;
  Static& st;
  uint8_t* ring;
  uint8_t* xreg;
  int s, ph;      // the next ring stage and its phase parity
};

// h at column i: the input for layer 0 until the o phase writes h_out
__device__ __forceinline__ float h_at(const FusedDecodeArgs& a, bool in,
                                      int i) {
  return in ? ldp(a.h_in, i, a.small_bf16)
            : __ldcg(static_cast<const float*>(a.h_out) + i);
}

// x rows [r0, r1) of the phase's input: bf16 into xs, the f32 sums of each
// group's x and of its bf16 x into xg (warp per group, in a fixed order).
// The first pass puts x (for a norm: h times the norm's weight, and rms(h)
// from `which`'s sums, which the second pass applies) in f32 into xf with
// its loads in flight together; `in`: h is the step's input (layer 0),
// whose rms the block takes itself.
__device__ void stage_x(Ctx& c, int mode, int l, bool in, int which,
                        const void* norm_w, int r0, int r1) {
  const FusedDecodeArgs& a = c.p.a;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* xf = reinterpret_cast<float*>(c.xreg);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(c.xreg + a.xrows * 4);
  float* xg = reinterpret_cast<float*>(c.xreg + a.xrows * 6);
  const int g = a.group_size, ng = (r1 - r0) / g;
  consumer_sync();  // the previous pieces are done with xs and xg
  float scale = 1.f;
  if (mode == X_ATTN) {
    // warp w takes heads w, w + CWARPS, ... of the rows: the chunks'
    // weights exp(m_c - M) / L into wc[w], then every thread the rows
    const float* ml = static_cast<const float*>(a.attn_ml);
    const float* acc = static_cast<const float*>(a.attn_acc);
    const int nch = lds(&c.st.chunks), h0 = r0 / HD, h1 = (r1 + HD - 1) / HD;
    for (int hb = h0; hb < h1; hb += CWARPS) {
      const int hh = hb + warp;
      if (hh < h1) {
        const float* m = ml + (size_t)hh * a.max_chunks * 2;
        float mv[MAX_CHUNKS / 32], lv[MAX_CHUNKS / 32], M = -INFINITY;
#pragma unroll
        for (int k = 0; k < MAX_CHUNKS / 32; ++k) {
          const int ch = lane + 32 * k;
          mv[k] = ch < nch ? __ldcg(m + 2 * ch) : -INFINITY;
          lv[k] = ch < nch ? __ldcg(m + 2 * ch + 1) : 0.f;
          M = fmaxf(M, mv[k]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
        float Ls = 0.f;
#pragma unroll
        for (int k = 0; k < MAX_CHUNKS / 32; ++k)
          Ls += lv[k] * (mv[k] = expf(mv[k] - M));
        Ls = warp_sum(Ls);
#pragma unroll
        for (int k = 0; k < MAX_CHUNKS / 32; ++k)
          if (lane + 32 * k < nch) c.st.wc[warp][lane + 32 * k] = mv[k] / Ls;
      }
      consumer_sync();
      const int e0 = max(r0, hb * HD), e1 = min(r1, min(h1, hb + CWARPS) * HD);
      for (int r = e0 + tid; r < e1; r += CONSUMERS) {
        const int hh = r / HD;
        const float* ah = acc + ((size_t)hh * a.max_chunks * HD + r - hh * HD);
        const float* w = c.st.wc[hh - hb];
        float x = 0.f;
        for (int c0 = 0; c0 < nch; c0 += 8) {
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = c0 + k < nch ? __ldcg(ah + (size_t)(c0 + k) * HD) : 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (c0 + k < nch) x = fmaf(v[k], w[c0 + k], x);
        }
        xf[r - r0] = x;
      }
      consumer_sync();
    }
  } else {
    // rms(h): the strips' sums of h^2 (warp 0), loaded beside x
    if (mode == X_NORM && !in && warp == 0) {
      const int n = a.n2p[W_O] / STRIP;
      const float* ss = static_cast<const float*>(a.sumsq) + which * n;
      float t = 0.f;
      for (int i = lane; i < n; i += 32) t += __ldcg(ss + i);
      t = warp_sum(t);
      if (lane == 0) c.st.inv = 1.f / sqrtf(t / (float)a.D + a.eps);
    }
    const float* act = static_cast<const float*>(a.act);
    const float* hf = static_cast<const float*>(a.h_out);
    float sq = 0.f;
    // four rows a thread at a time (r0 and r1 are multiples of 16)
#pragma unroll 4
    for (int r = r0 + 4 * tid; r < r1; r += 4 * CONSUMERS) {
      float4 x;
      if (mode == X_ACT) {
        x = __ldcg(reinterpret_cast<const float4*>(act + r));
      } else {
        if (in && a.small_bf16) {
          const uint2 hb2 = *reinterpret_cast<const uint2*>(
              static_cast<const __nv_bfloat16*>(a.h_in) + r);
          const float2 p0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&hb2.x));
          const float2 p1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&hb2.y));
          x = make_float4(p0.x, p0.y, p1.x, p1.y);
        } else {
          x = in ? *reinterpret_cast<const float4*>(
                       static_cast<const float*>(a.h_in) + r)
                 : __ldcg(reinterpret_cast<const float4*>(hf + r));
        }
        sq = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, sq))));
        const size_t wi = (size_t)l * a.D + r;
        float4 w;
        if (a.small_bf16) {
          const uint2 wb = *reinterpret_cast<const uint2*>(
              static_cast<const __nv_bfloat16*>(norm_w) + wi);
          const float2 q0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&wb.x));
          const float2 q1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&wb.y));
          w = make_float4(q0.x, q0.y, q1.x, q1.y);
        } else {
          w = *reinterpret_cast<const float4*>(
              static_cast<const float*>(norm_w) + wi);
        }
        x = make_float4(x.x * w.x, x.y * w.y, x.z * w.z, x.w * w.w);
      }
      *reinterpret_cast<float4*>(xf + r - r0) = x;
    }
    if (mode == X_NORM && in) {  // layer 0: rms of the whole input h
      sq = warp_sum(sq);
      if (lane == 0) c.st.red2[warp] = sq;
    }
    consumer_sync();
    if (mode == X_NORM && in && tid == 0) {
      float t = 0.f;
      for (int w = 0; w < CWARPS; ++w) t += c.st.red2[w];
      c.st.inv = 1.f / sqrtf(t / (float)a.D + a.eps);
    }
    if (mode == X_NORM) {
      consumer_sync();
      scale = c.st.inv;
    }
  }
  for (int gi = warp; gi < ng; gi += CWARPS) {
    float s = 0.f, sb = 0.f;
    for (int e = lane; e < g; e += 32) {
      const float v = xf[gi * g + e] * scale;
      const __nv_bfloat16 vb = __float2bfloat16(v);
      xs[gi * g + e] = vb;
      s += v;
      sb += __bfloat162float(vb);
    }
    s = warp_sum(s);
    sb = warp_sum(sb);
    if (lane == 0) xg[gi] = s, xg[a.xrows / 16 + gi] = sb;
  }
  consumer_sync();
}

// One piece's GEMV from the ring.  The piece's rows go in units of
// lcm(64, g) rows (whole stages and whole groups) to the warpgroups in
// turn, so that NWG stages are in work at once; warp (wg, cw) owns packed
// columns j0 + 32 cw + [0, 32) as four 16 x 16 A tiles (tile i, row r < 8:
// the low nibble of packed column 4 r + i, row r + 8 its high nibble).
// Leaves the piece's sums in tot of warpgroup 0 ([tile][lo, hi]; every lane
// of a quad alike).
__device__ void gemv_piece(Ctx& c, int mode, int l, bool in,
                           const void* norm_w, const Piece& pc, bool staged,
                           float (&tot)[4][2]) {
  const FusedDecodeArgs& a = c.p.a;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, cw = warp & 3;
  const int r8 = lane >> 2, t = lane & 3;
  const int cq = 32 * cw + 4 * r8;  // the 4 packed columns of this word
  const int oq0 = swz(2 * t, cq), oq1 = swz(2 * t + 1, cq);
  const int oq2 = swz(2 * t + 8, cq), oq3 = swz(2 * t + 9, cq);
  const uint32_t* xs32 =
      reinterpret_cast<const uint32_t*>(c.xreg + a.xrows * 4);
  const float* xg = reinterpret_cast<const float*>(c.xreg + a.xrows * 6);
  const int g = a.group_size, sb = Q_BYTES + a.slots * SLOT_BYTES;
  const int spu = a.unit_rows / BK;  // stages per unit
  float d[4][4];  // this group's sums of x_b (128 + q)
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) tot[i][0] = tot[i][1] = 0.f;
  int us = 0, uw = 0;  // the stage within its unit, the unit's warpgroup
  for (int r0 = pc.kb; r0 < pc.ke; r0 += a.seg_rows) {
    const int r1 = staged ? pc.ke : min(r0 + a.seg_rows, pc.ke);
    const int xb = staged ? 0 : r0;  // the row xs and xg start at
    if (!staged) {
      stage_x(c, mode, l, in, 0, norm_w, r0, r1);
    }
    int gend = r0 + g, gi = (r0 - xb) / g;  // the next group's end, index
    for (int k0 = r0; k0 < r1; k0 += BK) {
      const int k1 = min(k0 + BK, r1);
      if (uw == wg) {
        wait_bar(&c.st.full[c.s], c.ph);
        const uint8_t* qs = c.ring + c.s * sb;
        const float* sc = reinterpret_cast<const float*>(qs + Q_BYTES);
        const int steps = (k1 - k0) / 16;
        const int x0 = (k0 - xb) / 2;  // this stage's first x pair
        int slot = 0, ge = gend, gj = gi;
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          if (j < steps) {
            {
              const uint8_t* qj = qs + 16 * 128 * j;
              const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qj + oq0);
              const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qj + oq1);
              const uint32_t w2 = *reinterpret_cast<const uint32_t*>(qj + oq2);
              const uint32_t w3 = *reinterpret_cast<const uint32_t*>(qj + oq3);
              // every MMA column gets the same x: k rows (2t, 2t+1), (2t+8,
              // 2t+9)
              const uint32_t b0 = xs32[x0 + 8 * j + t];
              const uint32_t b1 = xs32[x0 + 8 * j + t + 4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                // byte i of the words: k rows (2t, 2t+1) into bytes 0 and 2
                // of u01, (2t+8, 2t+9) into u23; low nibbles A rows r, high
                // r + 8
                const uint32_t sel = i | ((4 + i) << 8);
                const uint32_t u01 = __byte_perm(w0, w1, sel);
                const uint32_t u23 = __byte_perm(w2, w3, sel);
                const uint32_t av[4] = {codes128(u01), codes128(u01 >> 4),
                                        codes128(u23), codes128(u23 >> 4)};
                mma_bf16(d[i], av, b0, b1);
              }
            }
            if (k0 + 16 * (j + 1) == ge) {
              // the group ends: y += s (sum x_b (128 + q) - 128 sum x_b)
              //                     + b sum x_f32
              const float* gs = sc + slot * 4 * STRIP + cq;
              const float4 s_lo = *reinterpret_cast<const float4*>(gs);
              const float4 s_hi =
                  *reinterpret_cast<const float4*>(gs + STRIP);
              const float4 b_lo =
                  *reinterpret_cast<const float4*>(gs + 2 * STRIP);
              const float4 b_hi =
                  *reinterpret_cast<const float4*>(gs + 3 * STRIP);
              const float sL[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
              const float sH[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
              const float bL[4] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w};
              const float bH[4] = {b_hi.x, b_hi.y, b_hi.z, b_hi.w};
              const float sx = xg[gj], off = 128.f * xg[a.xrows / 16 + gj];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                tot[i][0] += fmaf(sL[i], d[i][0] - off, bL[i] * sx);
                tot[i][1] += fmaf(sH[i], d[i][2] - off, bH[i] * sx);
#pragma unroll
                for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
              }
              ++slot;
              ++gj;
              ge += g;
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&c.st.empty[c.s]);
      }
      while (gend <= k1) gend += g, ++gi;  // the groups that ended here
      if (++c.s == a.stages) c.s = 0, c.ph ^= 1;
      if (++us == spu) us = 0, uw = uw + 1 == NWG ? 0 : uw + 1;
    }
    if (staged) break;
  }
  // the warpgroups' sums, added in warpgroup order (the first bar.sync:
  // warpgroup 0 is done reading the previous piece's)
  consumer_sync();
  if (t == 0 && wg > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c.st.red[wg - 1][cq + i] = tot[i][0];
      c.st.red[wg - 1][STRIP + cq + i] = tot[i][1];
    }
  }
  consumer_sync();
  if (wg == 0) {
#pragma unroll
    for (int w = 0; w < NWG - 1; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tot[i][0] += c.st.red[w][cq + i];
        tot[i][1] += c.st.red[w][STRIP + cq + i];
      }
  }
}

// The reduce epilogue of a piece: its sums go to partial row (strip, ord);
// the block that brings a strip's last piece (for gate|up: of a gate strip
// and its up strip) adds the pieces in order and finishes the columns.
__device__ void finish_piece(Ctx& c, int pid, const Phase& ph, const Piece& pc,
                             bool in, const float (&tot)[4][2]) {
  const FusedDecodeArgs& a = c.p.a;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* part = static_cast<float*>(a.part);
  if ((lane & 3) == 0 && warp < 4) {
    const int cq = 32 * warp + (lane >> 2) * 4;
    float* dst = part + ((size_t)pc.strip * ph.pmax + pc.ord) * 2 * STRIP + cq;
    *reinterpret_cast<float4*>(dst) =
        make_float4(tot[0][0], tot[1][0], tot[2][0], tot[3][0]);
    *reinterpret_cast<float4*>(dst + STRIP) =
        make_float4(tot[0][1], tot[1][1], tot[2][1], tot[3][1]);
  }
  if (pid == P_QKV) return;
  const int key = pc.j0 / STRIP;  // the strip within its linear
  const int sg = pid == P_GU ? key : pc.strip;  // gate strip of a pair
  const int su = pid == P_GU ? key + a.n2p[W_GATE] / STRIP : -1;
  const int n0 = pieces_of(ph, sg);
  const int n1 = pid == P_GU ? pieces_of(ph, su) : 0;
  consumer_sync();  // every partial store of this block is issued
  if (n0 + n1 > 1) {
    if (tid == 0) {
      uint32_t* cnt = static_cast<uint32_t*>(a.sync) + 1 + ph.key0 + key;
      const uint32_t old = atom_add_acq_rel(cnt, 1u);
      c.st.last = old == (uint32_t)(n0 + n1 - 1);
      if (c.st.last) *cnt = 0u;  // the next use is a grid barrier away
    }
    consumer_sync();
    if (!c.st.last) return;
  }
  const int n2p = a.n2p[pc.lin];
  float sq = 0.f;
  if (tid < 2 * STRIP) {
    const int col = (tid / STRIP) * n2p + pc.j0 + tid % STRIP;  // output
    auto sum = [&](int strip, int n) {
      return sum_rows(part + (size_t)strip * ph.pmax * 2 * STRIP + tid, n,
                      2 * STRIP);
    };
    if (pid == P_GU) {
      if (col < a.I) {
        const float gt = sum(sg, n0), up = sum(su, n1);
        static_cast<float*>(a.act)[col] = gt * (1.f / (1.f + expf(-gt))) * up;
      }
    } else if (pid == P_HEAD) {
      if (col < a.vocab) static_cast<float*>(a.logits)[col] = sum(sg, n0);
    } else if (col < a.D) {
      const float v = h_at(a, in, col) + sum(sg, n0);
      static_cast<float*>(a.h_out)[col] = v;
      sq = v * v;
    }
  }
  if (pid == P_O || pid == P_DOWN) {  // this strip's sum of h^2
    sq = warp_sum(sq);
    if (lane == 0) c.st.red2[warp] = sq;
    consumer_sync();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < CWARPS; ++w) t += c.st.red2[w];
      static_cast<float*>(a.sumsq)[(pid == P_DOWN) * (a.n2p[W_O] / STRIP) +
                                   pc.strip] = t;
    }
  }
}

__device__ void run_phase(Ctx& c, int pid, int l) {
  const FusedDecodeArgs& a = c.p.a;
  const Phase ph = phase_of(a, pid);
  int u0, u1;
  unit_range(ph, &u0, &u1);
  if (u0 == u1) return;
  const bool in = l == 0 && (pid == P_QKV || pid == P_O);
  const int mode = pid == P_O ? X_ATTN : pid == P_DOWN ? X_ACT : X_NORM;
  const void* norm_w = pid == P_QKV ? a.norm1 : pid == P_GU ? a.norm2
                                                            : a.final_norm;
  // x = a norm of h is the same for every piece of the phase: staged once
  const bool staged = mode == X_NORM;
  if (staged) {
    stage_x(c, mode, l, in, pid == P_GU ? 0 : 1, norm_w, 0, a.D);
  }
  for (int u = u0; u < u1;) {
    const Piece pc = piece_at(a, ph, u, u1);
    u += (pc.ke - pc.kb) / a.group_size;
    float tot[4][2];
    {
      gemv_piece(c, mode, l, in, norm_w, pc, staged, tot);
    }
    finish_piece(c, pid, ph, pc, in, tot);
  }
}

// ATTN: one unit per (kv head, history chunk).  The q|k|v finish first
// (sum the pieces, bias, RoPE; q scaled), then the chunk's tiles, tile i
// on attention warpgroup (ait + i) % 2 and its stage: each warp takes 16
// tokens of the tile, S = q k^T with the q heads as M rows (rows >= gq and
// 8..15 are zero), an online softmax per warp, O^T += V^T bf16(P)^T.  The
// warps' states (and, in chunk 0, the current token in f32) are combined
// in order into (m, l, acc) per q head and chunk.
__device__ void attention(Ctx& c, int l) {
  const FusedDecodeArgs& a = c.p.a;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, cw = warp & 3;
  const int r8 = lane >> 2, t = lane & 3;
  const int nkv = a.n_kv, gq = a.n_heads / nkv;
  float* buf = reinterpret_cast<float*>(c.xreg);  // [gq + 2][HD]
  const float* part = static_cast<const float*>(a.part);
  const Phase qkv = phase_of(a, P_QKV);
  for (int u = blockIdx.x; u < nkv * lds(&c.st.chunks); u += a.grid) {
    const int kvh = u % nkv, ch = u / nkv, nch = lds(&c.st.chunks);
    const int nsub = (lds(&c.st.offset) + T_TILE - 1) / T_TILE;
    const int s0 = (int)((long long)ch * nsub / nch);
    const int ntiles = (int)((long long)(ch + 1) * nsub / nch) - s0;
    consumer_sync();  // the previous unit is done with buf

    // ---- q|k|v finish for this kv head: output column `col` of linear
    // `lin` is plane col / n2p of packed column col % n2p.  A thread takes
    // four neighbouring columns (one float4 of each partial row) and has
    // all its loads, the bias's too, in flight together.
    const int nq = gq * HD, n4 = (nq + 2 * HD) / 4;
    constexpr int ITEMS = ((MAX_GQ + 2) * HD / 4 + CONSUMERS - 1) / CONSUMERS;
    const float* src[ITEMS];
    int npc[ITEMS];
    float4 acc[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = 4 * (tid + k * CONSUMERS);
      npc[k] = 0;
      acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      src[k] = part;
      if (i < 4 * n4) {
        int lin, col, strip0;
        if (i < nq) {
          lin = W_Q, col = kvh * nq + i, strip0 = 0;
        } else if (i < nq + HD) {
          lin = W_K, col = kvh * HD + i - nq, strip0 = a.n2p[W_Q] / STRIP;
        } else {
          lin = W_V, col = kvh * HD + i - nq - HD;
          strip0 = (a.n2p[W_Q] + a.n2p[W_K]) / STRIP;
        }
        const int n2p = a.n2p[lin], pcol = col % n2p;
        const int strip = strip0 + pcol / STRIP;
        src[k] = part + (size_t)strip * qkv.pmax * 2 * STRIP +
                 (col / n2p) * STRIP + pcol % STRIP;
        npc[k] = pieces_of(qkv, strip);
        if (a.bias[lin]) {
          const size_t bi = (size_t)l * (lin ? nkv * HD : a.D) + col;
          if (a.small_bf16) {
            const uint2 bb = *reinterpret_cast<const uint2*>(
                static_cast<const __nv_bfloat16*>(a.bias[lin]) + bi);
            const float2 b0 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&bb.x));
            const float2 b1 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&bb.y));
            acc[k] = make_float4(b0.x, b0.y, b1.x, b1.y);
          } else {
            acc[k] = *reinterpret_cast<const float4*>(
                static_cast<const float*>(a.bias[lin]) + bi);
          }
        }
      }
    }
    for (int p0 = 0; p0 < qkv.pmax; p0 += 4) {
      float4 v[ITEMS][4];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          v[k][p] = p0 + p < npc[k]
                        ? __ldcg(reinterpret_cast<const float4*>(
                              src[k] + (size_t)(p0 + p) * 2 * STRIP))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);  // the pieces in order
#pragma unroll
        for (int p = 0; p < 4; ++p)
          t = make_float4(t.x + v[k][p].x, t.y + v[k][p].y, t.z + v[k][p].z,
                          t.w + v[k][p].w);
        acc[k] = make_float4(acc[k].x + t.x, acc[k].y + t.y, acc[k].z + t.z,
                             acc[k].w + t.w);  // onto the bias
      }
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (tid + k * CONSUMERS < n4)
        *reinterpret_cast<float4*>(buf + 4 * (tid + k * CONSUMERS)) = acc[k];
    consumer_sync();
    // duplicated-half RoPE on the q rows and the k row, in place by pairs
    for (int i = tid; i < (gq + 1) * (HD / 2); i += CONSUMERS) {
      const int r = i / (HD / 2), dd = i % (HD / 2);
      float* row = buf + r * HD;
      const float x1 = row[dd], x2 = row[dd + HD / 2];
      const float cd = c.st.cs[dd], sd = c.st.cs[HD / 2 + dd];
      float o1 = x1 * cd + -x2 * sd;
      float o2 = x2 * cd + x1 * sd;
      if (r < gq) {
        o1 *= a.scale;
        o2 *= a.scale;
      }
      row[dd] = o1;
      row[dd + HD / 2] = o2;
    }
    consumer_sync();
    const float* kcur = buf + nq;
    const float* vcur = buf + nq + HD;
    if (ch == 0) {
      const int nk = nkv * HD;
      float* kn = static_cast<float*>(a.k_new) + (size_t)l * nk + kvh * HD;
      float* vn = static_cast<float*>(a.v_new) + (size_t)l * nk + kvh * HD;
      const size_t row =
          (((size_t)l * nkv + kvh) * a.capacity + lds(&c.st.offset)) * HD;
      for (int dd = tid; dd < HD; dd += CONSUMERS) {
        kn[dd] = kcur[dd];
        vn[dd] = vcur[dd];
        static_cast<__nv_bfloat16*>(a.k_cache)[row + dd] =
            __float2bfloat16(kcur[dd]);
        static_cast<__nv_bfloat16*>(a.v_cache)[row + dd] =
            __float2bfloat16(vcur[dd]);
      }
      for (int h = warp; h < gq; h += CWARPS) {  // the current token, f32
        float s = 0.f;
        for (int dd = lane; dd < HD; dd += 32)
          s = fmaf(buf[h * HD + dd], kcur[dd], s);
        s = warp_sum(s);
        if (lane == 0) c.st.scur[h] = s;
      }
    }

    // ---- the chunk's history tiles
    float o[8][4], m = -INFINITY, ls = 0.f;  // O^T: dims 16 mb + .., heads
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    // warpgroup 0 takes the tiles from the ring (four stages each); the
    // other warpgroups step over them
    const int sb = Q_BYTES + a.slots * SLOT_BYTES;
    uint32_t qa[8][2];  // q as A fragments: row r8 (a q head), 16-dim steps
    if (wg == 0) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float* qr = buf + r8 * HD + 16 * s + 2 * t;
        qa[s][0] = r8 < gq ? pack_bf16(qr[0], qr[1]) : 0u;
        qa[s][1] = r8 < gq ? pack_bf16(qr[8], qr[9]) : 0u;
      }
    }
    for (int i = 0; i < ntiles; ++i) {
      int ss[4], pp[4];  // the tile's stages: K lo, K hi, V lo, V hi
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ss[q] = c.s, pp[q] = c.ph;
        if (++c.s == a.stages) c.s = 0, c.ph ^= 1;
      }
      if (wg != 0) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) wait_bar(&c.st.full[ss[q]], pp[q]);
      const uint32_t kb[2] = {smem_u32(c.ring + ss[0] * sb),
                              smem_u32(c.ring + ss[1] * sb)};
      const uint32_t vb[2] = {smem_u32(c.ring + ss[2] * sb),
                              smem_u32(c.ring + ss[3] * sb)};
      float sc[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
        const int tok = 16 * cw + 8 * nb + (lane & 7);
#pragma unroll
        for (int s2 = 0; s2 < 4; ++s2) {
          uint32_t r[4];
          ldsm_x4(kv_at(kb, tok, 4 * s2 + (lane >> 3)), r);
          const uint32_t a0[4] = {qa[2 * s2][0], 0u, qa[2 * s2][1], 0u};
          const uint32_t a1[4] = {qa[2 * s2 + 1][0], 0u, qa[2 * s2 + 1][1],
                                  0u};
          mma_bf16(sc[nb], a0, r[0], r[1]);
          mma_bf16(sc[nb], a1, r[2], r[3]);
        }
      }
      // scores (row r8, tokens 2t, 2t + 1 of each 8-token block); columns
      // at or past the cursor (whatever the cache holds there) are masked
      const int past =
          lds(&c.st.offset) - ((s0 + i) * T_TILE + 16 * cw + 2 * t);
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * nb + e >= past) sc[nb][e] = -INFINITY;
          mx = fmaxf(mx, sc[nb][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m, mx);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m - mu);
      float p[2][2];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) p[nb][e] = expf(sc[nb][e] - mu);
      ls = ls * alpha + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
      m = mn;
      // O^T's columns are heads 2t, 2t + 1: their alphas live in rows r8 =
      // 2t, 2t + 1
      const float a0s = __shfl_sync(0xffffffffu, alpha, 8 * t);
      const float a1s = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][0] *= a0s;
        o[n][1] *= a1s;
        o[n][2] *= a0s;
        o[n][3] *= a1s;
      }
      // P^T as B: k = tokens (2t, 2t + 1) and (2t + 8, 2t + 9), n = head
      const uint32_t pb0 = pack_bf16(p[0][0], p[0][1]);
      const uint32_t pb1 = pack_bf16(p[1][0], p[1][1]);
      const int mi = lane >> 3;  // the ldmatrix this lane addresses
      const int vtok = 16 * cw + (mi >> 1) * 8 + (lane & 7);
      // a value row at or past the cursor is read from the zero row
      const bool vlive = (s0 + i) * T_TILE + vtok < lds(&c.st.offset);
#pragma unroll
      for (int mb = 0; mb < 8; ++mb) {
        uint32_t r[4];
        ldsm_x4_t(vlive ? kv_at(vb, vtok, 2 * mb + (mi & 1))
                        : smem_u32(&c.st.zero),
                  r);
        mma_bf16(o[mb], r, pb0, pb1);
      }
      __syncwarp();
      if (lane == 0)
#pragma unroll
        for (int q = 0; q < 4; ++q) mbar_arrive(&c.st.empty[ss[q]]);
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);

    // ---- combine the warps (and the current token) in order
    constexpr int AW = 4;  // the warps of warpgroup 0
    float* cm = buf + (MAX_GQ + 2) * HD;  // [AW][MAX_GQ]
    float* cl = cm + AW * MAX_GQ;
    float* co = cl + AW * MAX_GQ;                // [AW][MAX_GQ][HD]
    if (warp < AW) {
      if (t == 0 && r8 < gq) {
        cm[warp * MAX_GQ + r8] = m;
        cl[warp * MAX_GQ + r8] = ls;
      }
#pragma unroll
      for (int mb = 0; mb < 8; ++mb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 2 * t + (e & 1), dd = 16 * mb + r8 + 8 * (e >> 1);
          if (h < gq) co[(warp * MAX_GQ + h) * HD + dd] = o[mb][e];
        }
    }
    consumer_sync();
    float* ml = static_cast<float*>(a.attn_ml);
    float* ac = static_cast<float*>(a.attn_acc);
    for (int i = tid; i < gq * HD; i += CONSUMERS) {
      const int h = i / HD, dd = i % HD;
      float M = ch == 0 ? c.st.scur[h] : -INFINITY;
      for (int w = 0; w < AW; ++w) M = fmaxf(M, cm[w * MAX_GQ + h]);
      float ov = 0.f, L = 0.f;
      for (int w = 0; w < AW; ++w) {
        const float e = expf(cm[w * MAX_GQ + h] - M);
        ov = fmaf(e, co[(w * MAX_GQ + h) * HD + dd], ov);
        L = fmaf(e, cl[w * MAX_GQ + h], L);
      }
      if (ch == 0) {
        const float e = expf(c.st.scur[h] - M);
        ov = fmaf(e, vcur[dd], ov);
        L += e;
      }
      const size_t head = (size_t)kvh * gq + h;
      ac[(head * a.max_chunks + ch) * HD + dd] = ov;
      if (dd == 0) {
        ml[(head * a.max_chunks + ch) * 2] = M;
        ml[(head * a.max_chunks + ch) * 2 + 1] = L;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Static st;
  const FusedDecodeArgs& a = p.a;
  // aligned by an offset from the __shared__ array, so that the compiler
  // keeps the shared address space
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int sb = Q_BYTES + a.slots * SLOT_BYTES;
  uint8_t* ring = smem;
  uint8_t* xreg = ring + a.stages * sb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&st.full[s], 1);
      mbar_init(&st.empty[s], 4);  // one arrival per warp of its warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the cursor word: a row past the capacity would be written out of
    // bounds, so the launch stops there (the host checks it beforehand)
    const int off = *a.cursor;
    if (off < 0 || off >= a.capacity) __trap();
    const int nsub = (off + T_TILE - 1) / T_TILE;
    st.offset = off;
    st.chunks = max(1, min(a.max_chunks, nsub));
    st.zero = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS)
      for (int i = 0; i < 10; ++i) {
        if (i == W_HEAD && !a.has_head) continue;
        const CUtensorMap* m = i < 8 ? &p.wmap[i] : i == 8 ? &p.kmap : &p.vmap;
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(m))
                     : "memory");
      }
    produce(p, ring, st);
    return;
  }

  Ctx c{p, st, ring, xreg, 0, 0};
  uint32_t* bar = static_cast<uint32_t*>(a.sync);
  // RoPE's cos and sin, read by the attention units past a bar.sync
  if (threadIdx.x < HD)
    st.cs[threadIdx.x] = static_cast<const float*>(
        threadIdx.x < HD / 2 ? a.cos : a.sin)[threadIdx.x % (HD / 2)];
  for (int l = 0; l < a.L; ++l) {
    run_phase(c, P_QKV, l);
    grid_barrier(bar, a.grid);
    attention(c, l);
    grid_barrier(bar, a.grid);
    run_phase(c, P_O, l);
    grid_barrier(bar, a.grid);
    run_phase(c, P_GU, l);
    grid_barrier(bar, a.grid);
    run_phase(c, P_DOWN, l);
    grid_barrier(bar, a.grid);
  }
  if (a.has_head) run_phase(c, P_HEAD, 0);
}

bool valid(const FusedDecodeArgs& a) {
  if (a.n_kv <= 0 || a.n_heads % a.n_kv || a.n_heads / a.n_kv > MAX_GQ)
    return false;
  const int g = a.group_size;
  if (a.D != a.n_heads * HD || g <= 0 || g % 16 || a.D % g || a.I % g)
    return false;
  if (a.stages < 2 || a.stages > MAX_STAGES || a.slots < (BK + g - 1) / g ||
      a.xrows < a.seg_rows || a.xrows < a.D || a.unit_rows % BK ||
      a.unit_rows % g ||
      a.seg_rows < a.unit_rows || a.seg_rows % a.unit_rows || a.grid < 1)
    return false;
  for (int i = 0; i < (a.has_head ? 8 : 7); ++i)
    if (a.n2p[i] <= 0 || a.n2p[i] % STRIP) return false;
  if (a.n2p[W_GATE] != a.n2p[W_UP] || a.n2p[W_O] != a.n2p[W_DOWN] ||
      2 * a.n2p[W_Q] < a.D || 2 * a.n2p[W_K] < a.n_kv * HD ||
      2 * a.n2p[W_V] < a.n_kv * HD || 2 * a.n2p[W_O] < a.D ||
      2 * a.n2p[W_GATE] < a.I)
    return false;
  for (int i = 0; i < (a.has_head ? 5 : 4); ++i)
    if (a.pmax[i] < 1) return false;
  if (a.has_head && a.vocab > 2 * a.n2p[W_HEAD]) return false;
  if (a.max_chunks < 1 || a.max_chunks > MAX_CHUNKS || !a.cursor)
    return false;
  const int sb = Q_BYTES + a.slots * SLOT_BYTES;
  if (a.smem_bytes < a.stages * sb +
                         max(a.xrows * 6 + a.xrows / 16 * 8, ATT_SCRATCH) + 1024)
    return false;
  return a.capacity > 0;
}

}  // namespace

// Blocks of the kernel that can be resident at once on the current device
// with `smem` bytes of dynamic shared memory, if the device takes
// cooperative launches (negative: a CUDA error).
extern "C" int mvt_fused_decode_grid(int smem) {
  int dev = 0, sms = 0, coop = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, fused_decode_kernel, THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorCooperativeLaunchTooLarge;
  return sms * per;
}


extern "C" int mvt_fused_decode(const void* args, void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  p.a = *static_cast<const FusedDecodeArgs*>(args);
  const FusedDecodeArgs& a = p.a;
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const int K[8] = {a.D, a.D, a.D, a.D, a.D, a.D, a.I, a.D};
  for (int i = 0; i < (a.has_head ? 8 : 7); ++i) {
    const int rows = (i == W_HEAD ? 1 : a.L) * K[i];
    if (!tensor_map(&p.wmap[i], a.w[5 * i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                    rows, a.n2p[i], BK, STRIP, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  // the whole capacity: the kernel keeps rows at or past the cursor out of
  // its sums, so the maps do not depend on the step
  if (!tensor_map_3d(&p.kmap, a.k_cache, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     a.L * a.n_kv, a.capacity, HD, T_TILE, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_3d(&p.vmap, a.v_cache, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     a.L * a.n_kv, a.capacity, HD, T_TILE, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = a.smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_decode_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
