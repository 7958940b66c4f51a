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
// A row that sees nothing gets 0.
//
// What bounds it on the H100: device-memory bytes.  At kv_bits 3.5 and
// D = 128 a visible token costs 112 code bytes and 8 scale bytes per KV
// head, read once, against 4 g D operations: far below the tensor cores'
// rate.  A call at 8.5k tokens and 4 KV heads reads ~4.1 MB, 1.2 us at
// 3.35 TB/s; the launch, the first bytes' latency, the decode on the
// integer pipes and the cross-block combine are what stand above that.
// What the design does about it:
//
// - Bytes before arithmetic.  A block owns T consecutive tokens (a split)
//   of one KV head and its query rows; T, the warps, the combiners and the
//   shared-memory layout come from ops/tq_kv_attention.py:
//   tq_kv_attention_plan, which mirrors `tq_layout` here.  In the
//   [BH, C, w] layout the split's tokens are one contiguous run of each of
//   kq, ks, vs and vq per segment; one thread starts a `cp.async.bulk`
//   (1-D TMA) for every run at the block's start, with the query rows and
//   code tables: keys, scales, q and tables on one mbarrier, values on a
//   second, so the scores start while the values still arrive.  The
//   unaligned ends of a run (a capacity or view that is not 16-byte
//   aligned) are copied by threads.  No compute loop reads device memory.
// - Enough bytes in flight.  The plan cuts each head's capacity into NS,
//   about SMs / heads, splits of at most T tokens, so the grid is one block
//   per SM with all of a block's bytes (~32 KB at 272 tokens) requested at
//   once.  The grid is sized from the capacity C, not the cursor, so a
//   CUDA graph replays at any offset; the split size follows the cursor on
//   the card (a head's NS splits cover [0, min(C, offset)) in whole tiles),
//   so a short history still spreads over the grid.  Blocks wholly outside
//   [left_pad, offset) only arrive.
// - Each code decoded once into `mma.sync m16n8k16` operands (bf16, f32
//   sums).  Scores: the decoded keys are A (16 tokens x 16 dims), the
//   query is B (the g <= 8 rows of a KV head on the n = 8 side, a second
//   n-tile up to 16).  Values: the decoded values are A (16 dims x 16
//   tokens), bf16(p * vs) is B.  Every operand is already the contract's
//   bf16 value and products are exact in f32, so only the order of the
//   sums differs from the plain version.  A tile's 16 slots are chosen for
//   the bit planes: nm bytes (16, 8 or 4) of every plane at 16 / nm bit
//   positions, so a thread loads each plane's 4 bytes of its tokens once
//   (one 32-bit shared load where the run is word aligned, as on the main
//   path) and takes every bit position of them from registers: the codes
//   of 4 byte lanes come out of one rotate and one masked OR per plane.
//   The query fragments are laid out once per block in that slot order,
//   zero past a segment's last byte: a segment as narrow as 8 dims pads its
//   k-step rather than share it with the other segment, whose per-token
//   scales differ.  Tables of up to 8 levels sit in registers as low and
//   high bytes, looked up with `prmt` 4 codes at a time; wider codes index
//   the bf16 table in shared memory.  8-bit codes are raw bytes.
// - The work of a block is the decode on the integer pipes (the codes'
//   bits, the lookups), so the warps share it evenly: the plan picks the
//   fewest warps (at most 12) that leave no warp more than its share of
//   16-token tiles, each warp takes whole tiles of the scores and of the
//   values (its partial sums of every dim, summed in warp order), and a
//   block with fewer tiles than warps splits the values by output m-tile
//   instead.  The softmax of a row (max, p, sum, bf16(p * vs)) is one
//   warp's, with no block barrier inside.
// - One launch per call.  One live split writes the output itself.  Else
//   every block writes its split's (max, sum of p) and f32 sums and
//   arrives on a counter per (KV head, row group); the last K blocks to
//   arrive (K <= 8 and at most SMs / heads, so that waiting blocks can
//   never hold every SM) wait for the rest and each combines its share of
//   the outputs: eight lanes an output, each loading and weighting its
//   splits in one round trip, the eight sums meeting in a fixed xor tree,
//   so a repeat is bit-identical.  The last combiner to finish sets the
//   counters back to 0: the per-card zeroed counters stay zero between
//   launches.  A wait traps after 2 s rather than hang.  This end of a
//   block is kv_decode_common.cuh's `finish_split`, shared with K6.
// - Tried on the card and dropped (chip_smoke.py's check_kv_kernels and
//   per-block timestamps): the combine in a thread-block cluster through
//   distributed shared memory (clusters of 8 packed two blocks onto some
//   SMs, which then set the time), a second level of tickets (each level
//   adds a fence, an atomic and two L2 round trips), the whole combine in
//   the last block (one SM reading every split's partials), one tile of
//   17 per warp (registers spill) and the values split by m-tile at every
//   size (more shared loads per code).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_decode_common.cuh"

namespace {

constexpr int TILE = 16;         // tokens of one mma tile
constexpr int MAX_SEGS = 2;      // K8's two segments
constexpr int MAX_NT = 2;        // n-tiles of 8 query rows per block
constexpr int MAX_WARPS = 12;    // warps per block (8 at two n-tiles)
constexpr int LUT_ENTRIES = 256;  // bf16 levels per table (8-bit codes)
constexpr int GROUP_TILES = 8;   // tiles of one byte group (bit positions)
constexpr int ARRAY_SLACK = 32;  // misalignment (< 16) and 8 bytes read past
constexpr int MAX_COMBINERS = 8;  // last blocks of a head that combine

struct TqSeg {
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
  TqSeg seg[MAX_SEGS];
  int nseg;
  const int* offset;    // [BH]
  const int* left_pad;  // [BH]
  float* part_ml;       // [NS, BH, G, 2]: each split's max and sum of p
  float* part_acc;      // [NS, BH, G, D]: each split's sum of bf16(p vs) v
  unsigned* tickets;    // [BH * Z][2] arrivals and finished combiners,
                        // zero between launches
  float* out;           // [BH, G, D]
  int BH, G, C, D, T, NS, Z;
  int K;                // combiners: the last K blocks of a (head, rows)
  float scale;
};

// How one segment's codes are cut into 16-slot tiles.  Bit planes: a group
// is nm consecutive bytes of each plane, cut into nm / 2 tiles of 16 / nm
// bit positions each; nm in {16, 8, 4} gives the fewest tiles for w bytes a
// plane (ties to the widest).  8-bit codes: a tile is 16 consecutive dims,
// groups of 8 tiles.
struct SegGeo {
  int w, nm, lg, groups, steps;  // lg = log2(nm)
};

__host__ __device__ inline SegGeo seg_geo(int d, int bits) {
  SegGeo g;
  g.w = d / 8;
  if (bits == 8) {
    g.nm = 16;
    g.lg = 4;
    g.steps = (d + TILE - 1) / TILE;
    g.groups = (g.steps + GROUP_TILES - 1) / GROUP_TILES;
    return g;
  }
  g.nm = 16;
  g.steps = 1 << 30;
  for (int nm = 16; nm >= 4; nm /= 2) {
    const int tiles = nm / 2 * ((g.w + nm - 1) / nm);
    if (tiles < g.steps) {
      g.steps = tiles;
      g.nm = nm;
    }
  }
  g.groups = (g.w + g.nm - 1) / g.nm;
  g.lg = g.nm == 16 ? 4 : g.nm == 8 ? 3 : 2;
  return g;
}

__host__ __device__ inline int code_width(int d, int bits) {
  return bits == 8 ? d : d / 8 * bits;
}

// Dynamic shared memory of a block, in bytes from its 16-byte aligned base
// (ops/tq_kv_attention.py:_smem_bytes mirrors it).
struct TqLayout {
  int lut;               // [seg][k, v][LUT_ENTRIES] bf16 tables
  int lraw;              // [seg][k, v] staged f32 tables
  int qraw;              // staged f32 query rows [8 nt][D]
  int qf;                // [nt][k-step][lane] 4 bf16: query fragments
  int S;                 // [8 nt][T] f32 scores
  int pv;                // [seg][8 nt][T] bf16(p * vs)
  int ml;                // [8 nt][2] f32 this split's max and sum of p
  int part;              // [8 nt][D] f32 this split's sum of bf16(p vs) v
  int red;               // [warps][8 nt][D] f32 each warp's share of part
  int arr[MAX_SEGS][4];  // kq, ks, vs, vq staging regions
  int steps;             // key k-steps of all segments
  int bytes;
};

__host__ __device__ inline TqLayout tq_layout(const int* d, const int* kbits,
                                              const int* vbits, int nseg,
                                              int T, int D, int nt,
                                              int warps) {
  TqLayout L;
  const int rows = 8 * nt;
  int o = 0;
  L.lut = o;
  o += nseg * 2 * LUT_ENTRIES * 2;
  L.lraw = o;
  o += nseg * 2 * align16(LUT_ENTRIES * 4 + ARRAY_SLACK);
  L.qraw = o;
  o += align16(rows * D * 4 + ARRAY_SLACK);
  L.steps = 0;
#pragma unroll
  for (int g = 0; g < MAX_SEGS; ++g)
    if (g < nseg) L.steps += seg_geo(d[g], kbits[g]).steps;
  L.qf = o;
  o += nt * L.steps * 32 * 8;
  L.S = o;
  o += rows * T * 4;
  L.pv = o;
  o += nseg * rows * T * 2;
  L.ml = o;
  o += align16(rows * 2 * 4);
  L.part = o;
  o += rows * D * 4;
  L.red = o;
  o += warps * rows * D * 4;
#pragma unroll
  for (int g = 0; g < MAX_SEGS; ++g) {
    const int widths[4] = {code_width(d[g], kbits[g]), 4, 4,
                           code_width(d[g], vbits[g])};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      L.arr[g][j] = o;
      if (g < nseg) o += align16(T * widths[j] + ARRAY_SLACK);
    }
  }
  L.bytes = o;
  return L;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)bf16_bits(lo) | ((uint32_t)bf16_bits(hi) << 16);
}

// The 4 bytes at byte offset `off` (any alignment) of shared memory seen as
// 32-bit words.
__device__ __forceinline__ uint32_t ld_bytes4(const uint32_t* sw, int off) {
  const uint32_t lo = sw[off >> 2], hi = sw[(off >> 2) + 1];
  return __funnelshift_r(lo, hi, (uint32_t)(off & 3) * 8);
}

// A code table: up to 8 levels as low and high bytes in registers, else the
// bf16 table in shared memory.
struct Lut {
  uint32_t lo[2], hi[2];
  const uint16_t* tbl;
};

template <int BITS>
__device__ __forceinline__ void load_lut(Lut& L, const uint16_t* tbl) {
  L.tbl = tbl;
  if constexpr (BITS <= 3) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(tbl);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      L.lo[j] = prmt(w[2 * j], w[2 * j + 1], 0x6420);
      L.hi[j] = prmt(w[2 * j], w[2 * j + 1], 0x7531);
    }
  }
}

// The codes of 4 byte lanes of `cw` -> two bf16 pairs: lanes (0, 1) and
// (2, 3), or with STRIDED lanes (0, 2) and (1, 3).
template <int BITS, bool STRIDED>
__device__ __forceinline__ void decode4(uint32_t cw, const Lut& L,
                                        uint32_t& p0, uint32_t& p1) {
  if constexpr (BITS <= 3) {
    // the four codes as the nibbles of a prmt selector
    const uint32_t t = cw | (cw >> 4);
    const uint32_t sel = prmt(t, 0, 0x4420);
    const uint32_t lo = prmt(L.lo[0], L.lo[1], sel);
    const uint32_t hi = prmt(L.hi[0], L.hi[1], sel);
    p0 = prmt(lo, hi, STRIDED ? 0x6240 : 0x5140);
    p1 = prmt(lo, hi, STRIDED ? 0x7351 : 0x7362);
  } else {
    const uint32_t v0 = L.tbl[cw & 0xff], v1 = L.tbl[(cw >> 8) & 0xff],
                   v2 = L.tbl[(cw >> 16) & 0xff], v3 = L.tbl[cw >> 24];
    p0 = STRIDED ? (v0 | v2 << 16) : (v0 | v1 << 16);
    p1 = STRIDED ? (v1 | v3 << 16) : (v2 | v3 << 16);
  }
}

// Dim (within the segment) of slot L = 4 tig + e of key k-step `st`, or -1
// for a pad slot past the segment.
__device__ __forceinline__ int key_dim(const SegGeo& g, bool raw, int d,
                                       int st, int L) {
  if (raw) {
    const int dim = st * TILE + L;
    return dim < d ? dim : -1;
  }
  const int mg = st >> (g.lg - 1), bt = st & (g.nm / 2 - 1);
  const int byte = (mg << g.lg) + (L & (g.nm - 1));
  const int bit = (bt << (4 - g.lg)) + (L >> g.lg);
  return byte < g.w ? bit * g.w + byte : -1;
}

// Dim of m-slot (gid, h) (slot gid + 8 h) of value tile bt of group mg.
__device__ __forceinline__ int value_dim(const SegGeo& g, bool raw, int d,
                                         int mg, int bt, int gid, int h) {
  if (raw) {
    const int dim = (mg * GROUP_TILES + bt) * TILE + 2 * gid + h;
    return dim < d ? dim : -1;
  }
  const int byte = (mg << g.lg) + 2 * (gid & (g.nm / 2 - 1)) + h;
  const int bit = (bt << (4 - g.lg)) + (gid >> (g.lg - 1));
  return byte < g.w ? bit * g.w + byte : -1;
}

// What a pass over one segment needs.
struct SegView {
  SegGeo g;
  int codes;   // shared byte offset of token t0's code row
  int width;   // code bytes per token
  int d, dim0;
};

// Whether every 32-bit load of a pass is word aligned: the run's base, the
// row width and the plane width are whole words (true on the main path's
// shapes; otherwise each load is two words and a funnel shift).
__device__ __forceinline__ bool words_aligned(const SegView& v, bool raw) {
  return !(v.codes & 3) && !(v.width & 3) && (raw || !(v.g.w & 3));
}

template <bool AL>
__device__ __forceinline__ uint32_t ld4(const uint32_t* sw, int off) {
  if constexpr (AL) return sw[off >> 2];
  else return ld_bytes4(sw, off);
}

// The 2 bytes at `o0` and at `o1` (even offsets) as one word: [o0, o0 + 1,
// o1, o1 + 1].  Aligned, `hsel` picks the half-words (0x5410 low, 0x7632
// high).
template <bool AL>
__device__ __forceinline__ uint32_t ld_pair(const uint32_t* sw, int o0,
                                            int o1, uint32_t hsel) {
  if constexpr (AL) return prmt(sw[o0 >> 2], sw[o1 >> 2], hsel);
  else return prmt(ld_bytes4(sw, o0), ld_bytes4(sw, o1), 0x5410);
}

// Bit i of each byte lane of the `BITS` plane words, as 4 codes in byte
// lanes: plane b's bits rotated from 8 e + i to 8 e + b.
template <int BITS>
__device__ __forceinline__ uint32_t gather_bits(const uint32_t (&X)[BITS],
                                                int i) {
  uint32_t cw = 0;
#pragma unroll
  for (int b = 0; b < BITS; ++b)
    cw |= __funnelshift_r(X[b], X[b], (i - b) & 31) & (0x01010101u << b);
  return cw;
}

// The same after each plane word was rotated by (i0 - b) once: bit
// i0 + amt of each byte lane, with one rotation amount for every plane.
template <int BITS>
__device__ __forceinline__ uint32_t gather_rot(const uint32_t (&Y)[BITS],
                                               int amt) {
  uint32_t cw = 0;
#pragma unroll
  for (int b = 0; b < BITS; ++b)
    cw |= __funnelshift_r(Y[b], Y[b], amt) & (0x01010101u << b);
  return cw;
}

// Scores of one segment for the warp's tiles: S (+)= (q . k) * ks.
template <int BITS, bool AL, int NT>
__device__ __forceinline__ void scores_seg(const uint8_t* sm, const SegView v,
                                           const float* kscale,
                                           const uint2* qf, int steps,
                                           const uint16_t* tbl, float* S,
                                           int T, int tfirst, int tlast,
                                           int W, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  Lut L;
  load_lut<BITS>(L, tbl);
  for (int tile = tfirst + warp; tile < tlast; tile += W) {
    const int tok = tile * TILE;
    const int r0 = v.codes + (tok + gid) * v.width, r1 = r0 + 8 * v.width;
    // two accumulator chains (even and odd k-steps), added at the end
    float acc[2][NT][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][nt][j] = 0.f;
    for (int mg = 0; mg < v.g.groups; ++mg) {
      if constexpr (BITS == 8) {
        const int n = min(GROUP_TILES, v.g.steps - mg * GROUP_TILES);
#pragma unroll
        for (int bt = 0; bt < GROUP_TILES; ++bt) {
          if (bt < n) {
            const int st = mg * GROUP_TILES + bt, o = st * TILE + 4 * tig;
            uint32_t A[4];
            decode4<8, false>(ld4<AL>(sw, r0 + o), L, A[0], A[2]);
            decode4<8, false>(ld4<AL>(sw, r1 + o), L, A[1], A[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint2 b = qf[(nt * steps + st) * 32 + lane];
              mma_bf16(acc[bt & 1][nt], A, b.x, b.y);
            }
          }
        }
      } else {
        const int half = v.g.nm / 2;
        const int bo = (mg << v.g.lg) + ((4 * tig) & (v.g.nm - 1));
        const int i0 = (4 * tig) >> v.g.lg, ib = 16 >> v.g.lg;
        uint32_t X0[BITS], X1[BITS];
#pragma unroll
        for (int b = 0; b < BITS; ++b) {
          const uint32_t x0 = ld4<AL>(sw, r0 + b * v.g.w + bo);
          const uint32_t x1 = ld4<AL>(sw, r1 + b * v.g.w + bo);
          X0[b] = __funnelshift_r(x0, x0, (i0 - b) & 31);
          X1[b] = __funnelshift_r(x1, x1, (i0 - b) & 31);
        }
#pragma unroll
        for (int bt = 0; bt < GROUP_TILES; ++bt) {
          if (bt < half) {
            const int st = mg * half + bt;
            uint32_t A[4];
            decode4<BITS, false>(gather_rot<BITS>(X0, bt * ib), L, A[0], A[2]);
            decode4<BITS, false>(gather_rot<BITS>(X1, bt * ib), L, A[1], A[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint2 b = qf[(nt * steps + st) * 32 + lane];
              mma_bf16(acc[bt & 1][nt], A, b.x, b.y);
            }
          }
        }
      }
    }
    const float k0 = kscale[tok + gid], k1 = kscale[tok + gid + 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = nt * 8 + 2 * tig + (j & 1);
        float* dst = S + row * T + tok + gid + 8 * (j >> 1);
        const float x = __fmul_rn(__fadd_rn(acc[0][nt][j], acc[1][nt][j]),
                                  j < 2 ? k0 : k1);
        *dst = first ? x : __fadd_rn(*dst, x);
      }
  }
}

// One value m-tile (tile bt of byte group mg: 16 output dims) over all the
// block's tiles, written to part [8 NT][D]: the sums of bf16(p vs) v.
template <int BITS, bool AL, int NT>
__device__ __forceinline__ void values_mtile(const uint8_t* sm,
                                             const SegView v, int mg, int bt,
                                             const uint16_t* pv, int T,
                                             const uint16_t* tbl, float* part,
                                             int D, int tfirst, int tlast) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  Lut L;
  load_lut<BITS>(L, tbl);
  // byte offset of this thread's 2 bytes in a token's plane (row for
  // 8-bit codes), and the bit position they take
  int bo, i = 0;
  if constexpr (BITS == 8) {
    bo = (mg * GROUP_TILES + bt) * TILE + 2 * gid;
  } else {
    bo = (mg << v.g.lg) + 2 * (gid & (v.g.nm / 2 - 1));
    i = (bt << (4 - v.g.lg)) + (gid >> (v.g.lg - 1));
  }
  const uint32_t hsel = (bo & 2) ? 0x7632 : 0x5410;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
  for (int tile = tfirst; tile < tlast; ++tile) {
    const int tok = tile * TILE;
    // tokens 4 tig + j, j = 0..3 (k-slots 2 tig, 2 tig + 1, 2 tig + 8,
    // 2 tig + 9), as 16-bit pairs of the m-slots gid and gid + 8
    const int rt = v.codes + (tok + 4 * tig) * v.width + bo, wd = v.width;
    uint32_t A[4];
    if constexpr (BITS == 8) {
      decode4<8, true>(ld_pair<AL>(sw, rt, rt + wd, hsel), L, A[0], A[1]);
      decode4<8, true>(ld_pair<AL>(sw, rt + 2 * wd, rt + 3 * wd, hsel), L,
                       A[2], A[3]);
    } else {
      uint32_t X01[BITS], X23[BITS];
#pragma unroll
      for (int b = 0; b < BITS; ++b) {
        const int o = rt + b * v.g.w;
        X01[b] = ld_pair<AL>(sw, o, o + wd, hsel);
        X23[b] = ld_pair<AL>(sw, o + 2 * wd, o + 3 * wd, hsel);
      }
      decode4<BITS, true>(gather_bits<BITS>(X01, i), L, A[0], A[1]);
      decode4<BITS, true>(gather_bits<BITS>(X23, i), L, A[2], A[3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = *reinterpret_cast<const uint2*>(
          pv + (nt * 8 + gid) * T + tok + 4 * tig);
      mma_bf16(acc[nt], A, b.x, b.y);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int dim = value_dim(v.g, BITS == 8, v.d, mg, bt, gid, h);
    if (dim < 0) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* dst = part + (nt * 8 + 2 * tig) * D + v.dim0 + dim;
      dst[0] = acc[nt][2 * h];
      dst[D] = acc[nt][2 * h + 1];
    }
  }
}

// This warp's tiles (tfirst + warp, + W, ...) of one segment's values, all
// its dims, into red [8 NT][D] (f32; zeros where the warp has no tile).
template <int BITS, bool AL, int NT>
__device__ __forceinline__ void values_tiles(const uint8_t* sm,
                                             const SegView v,
                                             const uint16_t* pv, int T,
                                             const uint16_t* tbl, float* red,
                                             int D, int tfirst, int tlast,
                                             int W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  Lut L;
  load_lut<BITS>(L, tbl);
  for (int mg = 0; mg < v.g.groups; ++mg) {
    const int n = BITS == 8 ? min(GROUP_TILES, v.g.steps - mg * GROUP_TILES)
                            : v.g.nm / 2;
    int bo = (mg * GROUP_TILES) * TILE + 2 * gid, i0 = 0, lb = 0;
    if constexpr (BITS != 8) {
      bo = (mg << v.g.lg) + 2 * (gid & (v.g.nm / 2 - 1));
      i0 = gid >> (v.g.lg - 1);
      lb = 4 - v.g.lg;
    }
    const uint32_t hsel = (bo & 2) ? 0x7632 : 0x5410;
    float acc[GROUP_TILES][NT][4];
#pragma unroll
    for (int bt = 0; bt < GROUP_TILES; ++bt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[bt][nt][j] = 0.f;
    for (int tile = tfirst + warp; tile < tlast; tile += W) {
      const int tok = tile * TILE;
      uint32_t B[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            pv + (nt * 8 + gid) * T + tok + 4 * tig);
        B[nt][0] = b.x;
        B[nt][1] = b.y;
      }
      // tokens 4 tig + j, j = 0..3 (k-slots 2 tig, 2 tig + 1, 2 tig + 8,
      // 2 tig + 9)
      const int rt = v.codes + (tok + 4 * tig) * v.width + bo, wd = v.width;
      if constexpr (BITS == 8) {
#pragma unroll
        for (int bt = 0; bt < GROUP_TILES; ++bt) {
          if (bt < n) {
            const int o = rt + bt * TILE;
            uint32_t A[4];
            decode4<8, true>(ld_pair<AL>(sw, o, o + wd, hsel), L, A[0], A[1]);
            decode4<8, true>(ld_pair<AL>(sw, o + 2 * wd, o + 3 * wd, hsel),
                             L, A[2], A[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(acc[bt][nt], A, B[nt][0], B[nt][1]);
          }
        }
      } else {
        uint32_t X01[BITS], X23[BITS];
#pragma unroll
        for (int b = 0; b < BITS; ++b) {
          const int o = rt + b * v.g.w;
          const uint32_t x01 = ld_pair<AL>(sw, o, o + wd, hsel);
          const uint32_t x23 = ld_pair<AL>(sw, o + 2 * wd, o + 3 * wd, hsel);
          X01[b] = __funnelshift_r(x01, x01, (i0 - b) & 31);
          X23[b] = __funnelshift_r(x23, x23, (i0 - b) & 31);
        }
#pragma unroll
        for (int bt = 0; bt < GROUP_TILES; ++bt) {
          if (bt < n) {
            uint32_t A[4];
            decode4<BITS, true>(gather_rot<BITS>(X01, bt << lb), L, A[0],
                                A[1]);
            decode4<BITS, true>(gather_rot<BITS>(X23, bt << lb), L, A[2],
                                A[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(acc[bt][nt], A, B[nt][0], B[nt][1]);
          }
        }
      }
    }
#pragma unroll
    for (int bt = 0; bt < GROUP_TILES; ++bt) {
      if (bt < n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dim = value_dim(v.g, BITS == 8, v.d, mg, bt, gid, h);
          if (dim < 0) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float* dst = red + (nt * 8 + 2 * tig) * D + v.dim0 + dim;
            dst[0] = acc[bt][nt][2 * h];
            dst[D] = acc[bt][nt][2 * h + 1];
          }
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void scores_dispatch(int bits, const uint8_t* sm,
                                                const SegView& v,
                                                const float* ks,
                                                const uint2* qf, int steps,
                                                const uint16_t* tbl, float* S,
                                                int T, int tf, int tl, int W,
                                                bool first) {
  const bool al = words_aligned(v, bits == 8);
  switch (bits) {
#define TQ_CASE(B)                                                       \
  case B:                                                                \
    if (al)                                                              \
      scores_seg<B, true, NT>(sm, v, ks, qf, steps, tbl, S, T, tf, tl,   \
                              W, first);                                 \
    else                                                                 \
      scores_seg<B, false, NT>(sm, v, ks, qf, steps, tbl, S, T, tf, tl,  \
                               W, first);                                \
    break;
    TQ_CASE(1) TQ_CASE(2) TQ_CASE(3) TQ_CASE(4) TQ_CASE(5) TQ_CASE(6)
    TQ_CASE(7) TQ_CASE(8)
#undef TQ_CASE
  }
}

template <int NT>
__device__ __forceinline__ void tiles_dispatch(int bits, const uint8_t* sm,
                                               const SegView& v,
                                               const uint16_t* pv, int T,
                                               const uint16_t* tbl,
                                               float* red, int D, int tf,
                                               int tl, int W) {
  const bool al = words_aligned(v, bits == 8);
  switch (bits) {
#define TQ_CASE(B)                                                         \
  case B:                                                                  \
    if (al)                                                                \
      values_tiles<B, true, NT>(sm, v, pv, T, tbl, red, D, tf, tl, W);     \
    else                                                                   \
      values_tiles<B, false, NT>(sm, v, pv, T, tbl, red, D, tf, tl, W);    \
    break;
    TQ_CASE(1) TQ_CASE(2) TQ_CASE(3) TQ_CASE(4) TQ_CASE(5) TQ_CASE(6)
    TQ_CASE(7) TQ_CASE(8)
#undef TQ_CASE
  }
}

template <int NT>
__device__ __forceinline__ void values_dispatch(int bits, const uint8_t* sm,
                                                const SegView& v, int mg,
                                                int bt, const uint16_t* pv,
                                                int T, const uint16_t* tbl,
                                                float* part, int D, int tf,
                                                int tl) {
  const bool al = words_aligned(v, bits == 8);
  switch (bits) {
#define TQ_CASE(B)                                                          \
  case B:                                                                   \
    if (al)                                                                 \
      values_mtile<B, true, NT>(sm, v, mg, bt, pv, T, tbl, part, D, tf, tl); \
    else                                                                    \
      values_mtile<B, false, NT>(sm, v, mg, bt, pv, T, tbl, part, D, tf,   \
                                 tl);                                       \
    break;
    TQ_CASE(1) TQ_CASE(2) TQ_CASE(3) TQ_CASE(4) TQ_CASE(5) TQ_CASE(6)
    TQ_CASE(7) TQ_CASE(8)
#undef TQ_CASE
  }
}

// Grid (NS splits, BH KV heads, Z row groups).
template <int NT>
__global__ void __launch_bounds__(NT == 1 ? MAX_WARPS * 32 : 256, 1)
    tq_attention_kernel(const __grid_constant__ TqArgs a) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ __align__(8) uint64_t bars[2];  // keys, scales, q, tables; values
  __shared__ int last;

  constexpr int RG = 8 * NT;
  const int s = blockIdx.x, bh = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x, W = nthreads >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int T = a.T, C = a.C, D = a.D, G = a.G;
  const int row0 = z * RG, R = min(RG, G - row0);
  const int off = a.offset[bh], lp = a.left_pad[bh];
  // the split size follows the cursor: the NS splits of a head cover its
  // history [0, min(C, offset)) in whole tiles, at most T tokens each
  const int end = min(C, off);
  const int TS = min(T, max(TILE, (end + a.NS * TILE - 1) / (a.NS * TILE) * TILE));
  const int t0 = s * TS;
  const int lo = max(t0, lp), hi = min(min(t0 + TS, C), off);

  int dd[MAX_SEGS], kb[MAX_SEGS], vb[MAX_SEGS];
#pragma unroll
  for (int g = 0; g < MAX_SEGS; ++g) {
    dd[g] = a.seg[g].d;
    kb[g] = a.seg[g].kbits;
    vb[g] = a.seg[g].vbits;
  }
  const TqLayout Ly = tq_layout(dd, kb, vb, a.nseg, T, D, NT, W);
  constexpr int LRAW = align16(LUT_ENTRIES * 4 + ARRAY_SLACK);
  float* ml = reinterpret_cast<float*>(sm + Ly.ml);
  float* part = reinterpret_cast<float*>(sm + Ly.part);

  if (lo < hi) {
    // whole tiles of the live tokens, cut at the capacity
    const int ca = t0 + ((lo - t0) & ~(TILE - 1));
    const int cb = min(C, t0 + ((hi - t0 + TILE - 1) & ~(TILE - 1)));
    // (S and pv keep rows of T, the largest split)
    const int tfirst = (ca - t0) / TILE, tlast = (cb - t0 + TILE - 1) / TILE;
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // staging runs: kq, ks, vs of each segment, the query rows and the code
    // tables on the first barrier, vq on the second; a segment past nseg
    // stages nothing
    Run runs[MAX_SEGS][4], luts[MAX_SEGS][2];
#pragma unroll
    for (int g = 0; g < MAX_SEGS; ++g) {
      const TqSeg& sg = a.seg[g];
      const void* arrays[4] = {sg.kq, sg.ks, sg.vs, sg.vq};
      const int widths[4] = {code_width(sg.d, sg.kbits), 4, 4,
                             code_width(sg.d, sg.vbits)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        runs[g][j] = token_run(arrays[j], widths[j], bh, C, t0, ca, cb,
                               Ly.arr[g][j]);
        if (g >= a.nseg) runs[g][j].n = 0;
      }
      luts[g][0] = span_run(sg.klut, 4 << sg.kbits, Ly.lraw + 2 * g * LRAW);
      luts[g][1] =
          span_run(sg.vlut, 4 << sg.vbits, Ly.lraw + (2 * g + 1) * LRAW);
      if (g >= a.nseg) luts[g][0].n = luts[g][1].n = 0;
    }
    const Run qrun =
        span_run(a.q + ((size_t)bh * G + row0) * D, R * D * 4, Ly.qraw);
    if (tid == 0) {
      uint32_t tx0 = run_bytes(qrun), tx1 = 0;
#pragma unroll
      for (int g = 0; g < MAX_SEGS; ++g) {
#pragma unroll
        for (int j = 0; j < 3; ++j) tx0 += run_bytes(runs[g][j]);
        tx0 += run_bytes(luts[g][0]) + run_bytes(luts[g][1]);
        tx1 += run_bytes(runs[g][3]);
      }
      mbar_expect_tx(&bars[0], tx0);
      mbar_expect_tx(&bars[1], tx1);
      run_copy(sm, qrun, &bars[0]);
#pragma unroll
      for (int g = 0; g < MAX_SEGS; ++g) {
#pragma unroll
        for (int j = 0; j < 4; ++j) run_copy(sm, runs[g][j], &bars[j == 3]);
        run_copy(sm, luts[g][0], &bars[0]);
        run_copy(sm, luts[g][1], &bars[0]);
      }
    }
    run_ends(sm, qrun);
#pragma unroll
    for (int g = 0; g < MAX_SEGS; ++g) {
#pragma unroll
      for (int j = 0; j < 4; ++j) run_ends(sm, runs[g][j]);
      run_ends(sm, luts[g][0]);
      run_ends(sm, luts[g][1]);
    }
    __syncthreads();
    mbar_wait(&bars[0], 0);

    // query fragments in the key tiles' slot order, bf16, zero for pad
    // slots and rows past G
    {
      const float* qs = reinterpret_cast<const float*>(sm + qrun.dst);
      uint2* qf = reinterpret_cast<uint2*>(sm + Ly.qf);
      for (int idx = tid; idx < NT * Ly.steps * 32; idx += nthreads) {
        const int ln = idx & 31, st_all = (idx >> 5) % Ly.steps;
        const int nt = (idx >> 5) / Ly.steps;
        const int row = nt * 8 + (ln >> 2), tg = ln & 3;
        int g = 0, st = st_all, dim0 = 0;
        SegGeo geo = seg_geo(a.seg[0].d, a.seg[0].kbits);
        if (st >= geo.steps) {
          st -= geo.steps;
          dim0 = a.seg[0].d;
          g = 1;
          geo = seg_geo(a.seg[1].d, a.seg[1].kbits);
        }
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dim = key_dim(geo, a.seg[g].kbits == 8, a.seg[g].d, st,
                                  4 * tg + e);
          v[e] = (row < R && dim >= 0) ? qs[row * D + dim0 + dim] : 0.f;
        }
        qf[idx] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      }
    }
    // code tables, bf16, zero past 2**bits
    {
      uint16_t* tb = reinterpret_cast<uint16_t*>(sm + Ly.lut);
      for (int i = tid; i < a.nseg * 2 * LUT_ENTRIES; i += nthreads) {
        const int g = i / (2 * LUT_ENTRIES), isv = (i / LUT_ENTRIES) & 1;
        const TqSeg& sg = a.seg[g];
        const float* lut = isv ? sg.vlut : sg.klut;
        const float* raw = reinterpret_cast<const float*>(
            sm + Ly.lraw + (2 * g + isv) * LRAW + mis16(lut));
        const int e = i % LUT_ENTRIES, bits = isv ? sg.vbits : sg.kbits;
        tb[i] = e < (1 << bits) ? bf16_bits(raw[e]) : (uint16_t)0;
      }
    }
    __syncthreads();

    // ---- scores
    float* S = reinterpret_cast<float*>(sm + Ly.S);
    {
      int st0 = 0;
#pragma unroll
      for (int g = 0; g < MAX_SEGS; ++g) {
        if (g >= a.nseg) break;
        const TqSeg& sg = a.seg[g];
        SegView v;
        v.g = seg_geo(sg.d, sg.kbits);
        v.codes = runs[g][0].base;
        v.width = code_width(sg.d, sg.kbits);
        v.d = sg.d;
        v.dim0 = 0;
        scores_dispatch<NT>(
            sg.kbits, sm, v,
            reinterpret_cast<const float*>(sm + runs[g][1].base),
            reinterpret_cast<const uint2*>(sm + Ly.qf) + st0 * 32, Ly.steps,
            reinterpret_cast<const uint16_t*>(sm + Ly.lut) +
                (2 * g) * LUT_ENTRIES,
            S, T, tfirst, tlast, W, g == 0);
        st0 += v.g.steps;
      }
    }
    __syncthreads();

    // ---- softmax over this split, a warp per row: the row's max over its
    // visible tokens, then p = exp(score - max), the sum of p and
    // bf16(p * vs) for every staged token (0 where invisible)
    {
      uint16_t* pv = reinterpret_cast<uint16_t*>(sm + Ly.pv);
      const int i0 = tfirst * TILE, i1 = tlast * TILE;
      for (int r = warp; r < R; r += W) {
        const float* Sr = S + r * T;
        float mx = -INFINITY;
#pragma unroll 4
        for (int c = lo + lane; c < hi; c += 32)
          mx = fmaxf(mx, __fmul_rn(Sr[c - t0], a.scale));
        mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll 4
        for (int i = i0 + lane; i < i1; i += 32) {
          const int c = t0 + i;
          const bool live = c >= lo && c < hi;
          const float p = live ? expf(__fmul_rn(Sr[i], a.scale) - mx) : 0.f;
          sum += p;
#pragma unroll
          for (int g = 0; g < MAX_SEGS; ++g) {
            if (g >= a.nseg) break;
            const float* vs =
                reinterpret_cast<const float*>(sm + runs[g][2].base);
            pv[(g * RG + r) * T + i] =
                live ? bf16_bits(__fmul_rn(p, vs[i])) : (uint16_t)0;
          }
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          ml[2 * r] = mx;
          ml[2 * r + 1] = sum;
        }
      }
    }
    __syncthreads();

    // ---- values.  Few tiles: warp w takes the m-tiles w, w + W, ... of
    // the segments (16 output dims each) over every tile, into part.  Else
    // each warp takes its tiles, all dims, into its red slice, and the
    // slices are summed in warp order into part.
    mbar_wait(&bars[1], 0);
    if (tlast - tfirst < W) {
      const int n0 = seg_geo(a.seg[0].d, a.seg[0].vbits).steps;
      const int total =
          n0 + (a.nseg > 1 ? seg_geo(a.seg[1].d, a.seg[1].vbits).steps : 0);
      for (int mt = warp; mt < total; mt += W) {
        const int g = mt < n0 ? 0 : 1, k = mt - (g ? n0 : 0);
        const TqSeg& sg = a.seg[g];
        SegView v;
        v.g = seg_geo(sg.d, sg.vbits);
        v.codes = g ? runs[1][3].base : runs[0][3].base;
        v.width = code_width(sg.d, sg.vbits);
        v.d = sg.d;
        v.dim0 = g ? a.seg[0].d : 0;
        const bool raw = sg.vbits == 8;
        const int mg = raw ? k / GROUP_TILES : k >> (v.g.lg - 1);
        const int bt = raw ? k % GROUP_TILES : k & (v.g.nm / 2 - 1);
        values_dispatch<NT>(
            sg.vbits, sm, v, mg, bt,
            reinterpret_cast<const uint16_t*>(sm + Ly.pv) + g * RG * T, T,
            reinterpret_cast<const uint16_t*>(sm + Ly.lut) +
                (2 * g + 1) * LUT_ENTRIES,
            part, D, tfirst, tlast);
      }
      __syncthreads();
    } else {
      float* red = reinterpret_cast<float*>(sm + Ly.red);
      int dim0 = 0;
#pragma unroll
      for (int g = 0; g < MAX_SEGS; ++g) {
        if (g >= a.nseg) break;
        const TqSeg& sg = a.seg[g];
        SegView v;
        v.g = seg_geo(sg.d, sg.vbits);
        v.codes = runs[g][3].base;
        v.width = code_width(sg.d, sg.vbits);
        v.d = sg.d;
        v.dim0 = dim0;
        tiles_dispatch<NT>(
            sg.vbits, sm, v,
            reinterpret_cast<const uint16_t*>(sm + Ly.pv) + g * RG * T, T,
            reinterpret_cast<const uint16_t*>(sm + Ly.lut) +
                (2 * g + 1) * LUT_ENTRIES,
            red + warp * RG * D, D, tfirst, tlast, W);
        dim0 += sg.d;
      }
      __syncthreads();
      const float4* r4 = reinterpret_cast<const float4*>(red);
      for (int idx = tid; idx < R * D / 4; idx += nthreads) {
        float4 acc = r4[idx];
        for (int w = 1; w < W; ++w) {
          const float4 x = r4[w * RG * D / 4 + idx];
          acc.x = __fadd_rn(acc.x, x.x);
          acc.y = __fadd_rn(acc.y, x.y);
          acc.z = __fadd_rn(acc.z, x.z);
          acc.w = __fadd_rn(acc.w, x.w);
        }
        reinterpret_cast<float4*>(part)[idx] = acc;
      }
    }
    __syncthreads();
  }

  const SplitOut o = {a.part_ml, a.part_acc, a.tickets, a.out,
                      a.BH, G, D, a.NS, a.Z, a.K};
  finish_split(o, part, ml, last, s, bh, z, row0, R, lo, hi, lp, end, TS);
}

template <int NT>
cudaError_t launch(const TqArgs& a, int warps, int smem, cudaStream_t st) {
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        tq_attention_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  tq_attention_kernel<NT><<<dim3(a.NS, a.BH, a.Z), warps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q f32 [BH, G, D]; for each of nseg (1: K7, 2: K8) segments its codes
// kq/vq u8 [BH, C, code width], scales ks/vs f32 [BH, C] and code tables
// klut/vlut f32 [2**bits]; offset, left_pad int32 [BH]; scratch part_ml
// f32 [NS, BH, G, 2] and part_acc f32 [NS, BH, G, D] with NS = ceil(C / T);
// tickets u32 [BH * Z * 2], zero (and left zero); out f32 [BH, G, D].
// Segment dims are multiples of 8 and sum to D.  T (tokens a split, a
// multiple of 16), warps, combiners (1 to 8, at most NS, and so few that
// the waiting ones never hold every SM: at most SMs / (BH * Z)) and smem
// (the layout's bytes, checked here) come from
// ops/tq_kv_attention.py:tq_kv_attention_plan.  One launch.
extern "C" int mvt_tq_kv_attention(
    const void* q, const void* kq0, const void* ks0, const void* vq0,
    const void* vs0, const void* klut0, const void* vlut0, const void* kq1,
    const void* ks1, const void* vq1, const void* vs1, const void* klut1,
    const void* vlut1, const void* offset, const void* left_pad,
    void* part_ml, void* part_acc, void* tickets, void* out, int d0,
    int kbits0, int vbits0, int d1, int kbits1, int vbits1, int nseg, int BH,
    int G, int C, int T, int warps, int combiners, int smem, float scale,
    void* stream) {
  TqArgs a;
  a.q = static_cast<const float*>(q);
  const void* ptrs[2][6] = {{kq0, ks0, vq0, vs0, klut0, vlut0},
                            {kq1, ks1, vq1, vs1, klut1, vlut1}};
  const int dims[2][3] = {{d0, kbits0, vbits0}, {d1, kbits1, vbits1}};
  if (nseg < 1 || nseg > MAX_SEGS || G < 1 || T < TILE || T % TILE ||
      warps < 1 || warps > (G <= 8 ? MAX_WARPS : 8))
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < 2; ++g) {
    a.seg[g].kq = static_cast<const uint8_t*>(ptrs[g][0]);
    a.seg[g].ks = static_cast<const float*>(ptrs[g][1]);
    a.seg[g].vq = static_cast<const uint8_t*>(ptrs[g][2]);
    a.seg[g].vs = static_cast<const float*>(ptrs[g][3]);
    a.seg[g].klut = static_cast<const float*>(ptrs[g][4]);
    a.seg[g].vlut = static_cast<const float*>(ptrs[g][5]);
    a.seg[g].d = g < nseg ? dims[g][0] : 0;
    a.seg[g].kbits = g < nseg ? dims[g][1] : 1;
    a.seg[g].vbits = g < nseg ? dims[g][2] : 1;
    if (g < nseg && (a.seg[g].d < 8 || a.seg[g].d % 8 || a.seg[g].kbits < 1 ||
                     a.seg[g].kbits > 8 || a.seg[g].vbits < 1 ||
                     a.seg[g].vbits > 8))
      return (int)cudaErrorInvalidValue;
  }
  a.nseg = nseg;
  a.offset = static_cast<const int*>(offset);
  a.left_pad = static_cast<const int*>(left_pad);
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.tickets = static_cast<unsigned*>(tickets);
  a.out = static_cast<float*>(out);
  a.BH = BH;
  a.G = G;
  a.C = C;
  a.D = d0 + (nseg > 1 ? d1 : 0);
  a.T = T;
  a.NS = (C + T - 1) / T;
  a.K = combiners;
  if (combiners < 1 || combiners > MAX_COMBINERS || combiners > a.NS)
    return (int)cudaErrorInvalidValue;
  const int nt = G <= 8 ? 1 : MAX_NT;
  a.Z = (G + 8 * nt - 1) / (8 * nt);
  a.scale = scale;
  int dd[2], kb[2], vb[2];
  for (int g = 0; g < 2; ++g) {
    dd[g] = a.seg[g].d;
    kb[g] = a.seg[g].kbits;
    vb[g] = a.seg[g].vbits;
  }
  // the plan's shared-memory bytes must be this layout's
  if (tq_layout(dd, kb, vb, nseg, T, a.D, nt, warps).bytes != smem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(nt == 1 ? launch<1>(a, warps, smem, st)
                       : launch<2>(a, warps, smem, st));
}
