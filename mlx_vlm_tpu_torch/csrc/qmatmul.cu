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
// accumulators, as exact bf16 operands); the group partial is scaled by the
// f32-widened s and b multiplies the f32 sum of x over the group.  The
// result equals the reference's up to f32 reassociation, then one rounding
// to bf16.  (K1 differs: it rounds code*s + b to bf16 before its MMA, as
// its reference does.)
//
// Two routes:
// - M <= 8, both widths (decode steps, the prefill lm_head row), entry
//   mvt_qmatmul_gemv, one launch per call: bound by device-memory
//   bandwidth; at Qwen2-VL-7B one exact decode step's linears and head read
//   about 3.98 GB at 4 bits (about 1.19 ms at 3.35 TB/s) and 7.5 GB at 8
//   bits (2.2 ms), scales and biases included (reckoned from the shapes;
//   the measured times are in PERF.md).  qmv_kernel<BITS, G>:
//   * Codes exact on mma.sync m16n8k16 (bf16, f32 accumulate): W is the A
//     operand, 16 W rows a warp tile; x the B operand, columns >= M zero.
//     A 4-bit word (8 codes) becomes four bf16 pairs 128 + q with a shift
//     and one LOP3 each (the nibble is the mantissa of 128.0); an 8-bit
//     word (4 codes) two pairs of parts, 128 + (low nibble) and 256 + 16
//     (high nibble) (the high nibble shifted to mantissa bits 3-6 of
//     256.0), two MMAs into one partial, so that the partial sums x (384 +
//     q).  No integer-to-float conversion anywhere (chip_smoke.py phase 1
//     counts I2F in the SASS).  A group ends in acc += s P + (b - c s) sum x,
//     c = 128 or 384.
//   * The k order: the quad of an A row reads word t of each 16-byte piece
//     of the row (t its lane in the quad), so every 16-k slice of the MMAs
//     lies in one piece, and so in one group at g = 32, 64 and 128; a
//     word's pairs are (i, i + 4) at 4 bits and (i, i + 2) at 8, and x is
//     staged in that order (x_order) so that a B fragment is one shared
//     load.  The sum over a group does not depend on the order of its k.
//   * Bytes in flight: each warp keeps a ring of MV_RING stages of its 16
//     rows x MV_SS * 32 bytes in shared memory, filled by cp.async with
//     the L2 256-byte prefetch hint (a warp instruction copies 128
//     contiguous bytes of 4 rows); the stage's two 16-byte pieces per step
//     sum into two partials, two MMA chains.  Loads of the codes into
//     registers (8 rows x 32 bytes a warp instruction) were tried first and
//     streamed at ~1 TB/s; a deeper ring only lengthened the time to issue
//     it (PERF.md).
//   * Scales and biases once per group per row: a block copies its rows'
//     values with cp.async as whole 16-byte pieces (4-byte words for a
//     chunk of each row), ahead of the codes that need them; the fold
//     reads them from shared memory.  Loading them into registers at each
//     step, as first built, made more L2 requests than the codes did.
//   * x: copied once per block (per chunk of K where M rows of K do not fit
//     in ops/qmatmul.py's GEMV_SMEM_BYTES) by cp.async as the first copies
//     of the block, so that they do not wait behind the code stream, then
//     put in pair order in place while the first stages are in flight; the
//     sum of x per group and row is taken there, once per block.
//   * Filling the card (ops/qmatmul.py:qmatmul_gemv_plan): a block of 8
//     warps owns RT row tiles of 16 rows, its 8 / RT warps per tile split
//     K, and the warps' partials are added in shared memory in the order
//     of their parts.  With one chunk of K and more tiles than two blocks
//     an SM, the grid is persistent: 2 blocks an SM walk the tiles, each
//     warp's ring streams on into the next tile while the block finishes
//     one, and the next tile's values go to a second slot, so the last
//     wave of blocks does not run alone on a few SMs.  No atomics: a
//     repeated call is bit-identical.
//   * Ragged N: rows >= N are not copied and not stored.  Any number of
//     groups a row, odd too (Qwen2-VL-72B's down_proj at 8 bits and g =
//     128: 231): the values are copied as 32-bit words of the array, a
//     chunk's copy of a row from the word that holds its first group (one
//     group early where that group is a word's high half), and the array's
//     last value alone by a plain load where the values are odd in all.
// - M > 8, both widths (prefill chunks of an exact model), entry
//   mvt_qmatmul_gemm, one kernel qmm_gemm_kernel<BITS, BM, GT>: bound by
//   tensor-core operations at 512 rows (2 M N K at 989 TFLOP/s bf16, twice
//   that at 8 bits, whose codes take two MMAs), by bytes at a 58-row chunk
//   of an 8-bit model (3584^2: 13.6 MB, about 4 us at 3.35 TB/s).
//   K1's pipeline (int4_matmul.cu; the wgmma helpers and the split-K pass
//   are in wgmma.cuh), with what differs for the mlx layout:
//   * Operands swapped: y^T[n, m] = W[n, :] . x[m, :]^T, W the A operand of
//     wgmma.m64nBMk16 from REGISTERS, x the K-major B tile that TMA loads
//     with the 128-byte swizzle.  A block owns 128 W rows (two consumer
//     warpgroups of 64) against BM x rows (64 or 128); one producer thread
//     keeps a ring of 64-code stages full: x (BM x 64 bf16) and the codes
//     as they lie in memory (128 W rows x 32 bytes at 4 bits, no swizzle;
//     x 64 bytes at 8 bits, with the 64-byte swizzle), one TMA box, behind
//     full/empty mbarriers.  The stages per ring (QmmLayout) fill the 227
//     KB for each width and row tile.
//   * Codes exact, no integer-to-float conversion (chip_smoke.py phase 1
//     counts I2F in the 8-bit instance's SASS).  4 bits: each nibble
//     becomes bf16 128 + q with a PRMT and one LOP3 per pair, as K2 does.
//     8 bits: each byte gives two exact parts, 128 + (low nibble) and 256 +
//     16 (high nibble), as the GEMV's codes8, and the two parts run as two
//     wgmmas into the same partial, which then sums x (384 + q).  A group's
//     partial P accumulates on wgmma into an f32 accumulator of its own,
//     zeroed by scale-d = 0 at the group's first 16-k slice, and is folded
//     at the group's end in f32: acc += s P + (b - c s) sum x, c = 128 or
//     384.  Codes 0..255 and the parts are exact in bf16 and x times them
//     exact in f32, so the contract above holds.
//   * The A fragment against the mlx byte order: thread (g8, t) of a 16-k
//     slice needs codes 2t, 2t+1, 2t+8 and 2t+9 of each of its two W rows.
//     4 bits: bytes t and t + 4 of the row's 8-byte slice; the thread reads
//     its two 32-byte rows of the stage with four 16-byte loads (rows 64
//     apart within a quarter warp: no bank conflicts; each row is read by
//     the quad's four threads at once), and PRMTs gather byte t of the
//     eight words.  8 bits: halfwords t and t + 4 of the row's 16-byte
//     chunk; one 16-byte load per row and slice, one PRMT per halfword, and
//     the 64-byte swizzle puts the two rows of a quarter warp's two quads
//     (128 bytes apart) on other banks.  A row g8 / g8 + 8 of a warp are W
//     rows 2 g8 / 2 g8 + 1, as in K1, so the epilogue stores bf16 pairs.
//     x arrives unpermuted, so every k is in its natural order.
//   * Registers: the next step's A fragments are built while the current
//     step's wgmmas run, as in K1.  A 4-bit step is a stage (16
//     registers); an 8-bit stage's fragments are twice that, so at BM =
//     128 its step is half a stage (two slices, four wgmmas): acc, P and
//     two steps' fragments fit in the 208 registers setmaxnreg leaves the
//     consumers (the group-data warps need 80).  At BM = 64 an 8-bit step
//     is a stage, and a second partial fits (below).
//   * Sums of x, scales and biases: the producer warpgroup's three idle
//     warps take turns, one stage in three each, and write into the stage
//     (s, b - c s) in f32 for the block's 128 W rows and the sum of x per
//     row and group (from the x tile in shared memory; at g = 128 the
//     group's second stage adds the first's), then signal a third
//     mbarrier.  A warp loads the scales and biases of its next stage
//     before it waits for this one, so the L2 round trip is off the
//     pipeline: with each thread reading its rows' scales at the stage it
//     wrote, one round trip per stage set the pace of the whole kernel.
//     Cost per stage: 8-16 scale and bias reads and 16-32 16-byte shared
//     reads per lane of one warp, ~1,100 adds, off the consumers' path
//     but on the same SM sub-partitions.
//   * The fold needs the partial complete.  With one partial per
//     warpgroup (4 bits; 8 bits at BM = 128) a fold waits for its group's
//     wgmmas (wait_group 0) while the other warpgroup's wgmmas may run; two
//     partials at BM = 128 with two steps of fragments would be 224
//     registers.  The 8-bit kernel at BM = 64 (a 58-row chunk) has two,
//     P and Q, taking turns by group: a group is folded once the next
//     group's wgmmas are issued (wait_group 1).  ptxas serializes every
//     wgmma of a kernel (warning C7514 / C7515) where a partial that is
//     read might be one still in flight, so the partials' roles are fixed
//     in the code: the loop is unrolled over two groups, the kernel is
//     built for each g (GT; 0 elsewhere, g a runtime shift), and the loop
//     drains its wgmmas (wait_group 0) before its back edge.  A build with
//     one loop for every g, or with a wgmma in flight across the back
//     edge, or choosing the partial at run time, was serialized.
//   * What bounds the 4-bit kernel on an H100: instruction issue, not the
//     tensor cores.  The fold is 2 FMAs per accumulator and group on the
//     consumers' SM sub-partitions, beside the A fragments' PRMT / LOP3
//     work and the group-data warps' sums.  Builds with the fold or the sums
//     of x taken out (wrong results, timing only) ran faster, the fold the
//     more, and with both out about as fast as K1.  Tried and dropped:
//     making the warpgroups take turns to issue their wgmmas (named
//     barriers; no change), and summing x on mma.sync with A = 1 in the
//     group-data warps, as K2 does (slower: the MMAs' latency chain per
//     stage).  (A timing build whose partial is never read also lets
//     ptxas drop the wgmmas that feed it, so the fold's share measured
//     that way is too large.)  At 8 bits the tensor cores have twice the
//     work per code and the fold the same.  At BM = 64 the wgmmas are
//     m64n64k16, and timing builds of the 8-bit kernel (the hi parts'
//     wgmmas taken out, the A fragments not built, the sums of x or the
//     whole group data not taken) each ran faster, none by enough to
//     reach the tensor bound: no one part sets its pace.  Building the
//     next stage's fragments slice by slice between this stage's wgmmas
//     was tried and ran slower.
//   * Narrow outputs and short chunks: the plan
//     (ops/qmatmul.py:qmatmul_plan) splits K into S slices of whole units
//     of max(g, 64) codes, enough to fill the 132 SMs (at 8 bits also in
//     two where more tiles than SMs leave the last wave part empty); slices
//     write f32 partials that splitk_reduce adds in slice order and rounds
//     once.  No atomics: a repeated call is bit-identical.
//   * Ragged edges: TMA fills x rows >= M and W rows >= N with zeros; the
//     epilogue masks them.  Any M, any N; K % (2 g) == 0 at 4 bits, K % g
//     == 0 at 8.  At 8 bits and g = 32, K an odd multiple of 32 ends in a
//     half stage: TMA fills its x and code columns past K with zeros, and
//     the group-data warp gives the missing second group s = b = 0, so
//     that group's fold adds nothing (the stage's last unit counts as a
//     whole one in the K split).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"
#include "wgmma.cuh"

namespace {

// ------------------------------------------------------------- helpers

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t and_or(uint32_t v, uint32_t mask,
                                           uint32_t bits) {
  uint32_t r;  // one LOP3: (v & mask) | bits
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(v), "r"(mask),
      "r"(bits));
  return r;
}

// ------------------------------------------------------------ GEMM route

constexpr int QG_BK = 64;        // codes of K per stage
constexpr int QG_BN = 128;       // output columns (W rows) per block
constexpr int QG_THREADS = 384;  // two consumer warpgroups + one producer
constexpr int QG_MAX_STAGES = 12;

// A stage of the GEMM's ring for BITS-bit codes and a row tile of BM: x
// (BM x 64 bf16, 128-byte swizzle), the codes (128 W rows x 32 bytes at 4
// bits, no swizzle; x 64 bytes at 8 bits, 64-byte swizzle), then the
// group data.  ops/qmatmul.py:_gemm_smem mirrors it.
template <int BITS, int BM>
struct QmmLayout {
  static constexpr int X_BYTES = BM * QG_BK * 2;            // x, 128B swizzle
  static constexpr int W_BYTES = QG_BN * QG_BK * BITS / 8;  // codes
  static constexpr int SC_BYTES = 2 * QG_BN * 8;      // float2 [slot][row]
  static constexpr int XS_BYTES = 2 * BM * 4;         // float [slot][row]
  static constexpr int META = (SC_BYTES + XS_BYTES + 1023) / 1024 * 1024;
  static constexpr int STAGE = X_BYTES + W_BYTES + META;
  static constexpr int STAGES =
      BITS == 4 ? (BM == 64 ? 12 : 8) : (BM == 64 ? 11 : 8);
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  static constexpr float OFF = BITS == 4 ? 128.f : 384.f;  // code offset
  static_assert(STAGE % 1024 == 0, "stages must keep 1024-byte alignment");
  static_assert(STAGES <= QG_MAX_STAGES, "barrier arrays too short");
  static_assert(SMEM + 3 * QG_MAX_STAGES * 8 <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

// The two codes of byte I of r as bf16 128 + code (low nibble in the low
// half): byte I of r and of r >> 4 go to bits [0, 8) and [16, 24), then one
// LOP3 keeps their low nibbles under the exponent of 128.0 (bf16 0x4300).
template <int I>
__device__ __forceinline__ uint32_t code_pair(uint32_t r, uint32_t r4) {
  const uint32_t v =
      prmt(r, r4, I | (I << 4) | ((4 + I) << 8) | ((4 + I) << 12));
  uint32_t out;  // (v & 0x000F000F) | 0x43004300
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(out)
      : "r"(v), "r"(0x000F000Fu), "r"(0x43004300u));
  return out;
}

// A fragments of one stage (four 16-k slices) for one thread.  `w` points
// at W row r0 of the stage (32 code bytes; row r0 + 1 follows): A row g8 is
// W row r0, A row g8 + 8 is W row r0 + 1.  Slice kk needs codes 2t, 2t+1
// (byte t of word 2kk) and 2t+8, 2t+9 (byte t of word 2kk+1) of each row:
// two 16-byte reads per row, and `sel` gathers byte t of the eight words
// into two registers (byte j of the first = byte t of word j).
__device__ __forceinline__ void q4_fragments(uint32_t (&a)[4][4],
                                             const uint8_t* w, uint32_t sel) {
  uint32_t r[2][2], r4[2][2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const uint4 u0 = *reinterpret_cast<const uint4*>(w + 32 * row);
    const uint4 u1 = *reinterpret_cast<const uint4*>(w + 32 * row + 16);
    r[row][0] = prmt(prmt(u0.x, u0.y, sel), prmt(u0.z, u0.w, sel), 0x5410);
    r[row][1] = prmt(prmt(u1.x, u1.y, sel), prmt(u1.z, u1.w, sel), 0x5410);
    r4[row][0] = r[row][0] >> 4;
    r4[row][1] = r[row][1] >> 4;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // slices 2h (words 4h, 4h+1), 2h + 1
    a[2 * h][0] = code_pair<0>(r[0][h], r4[0][h]);
    a[2 * h][1] = code_pair<0>(r[1][h], r4[1][h]);
    a[2 * h][2] = code_pair<1>(r[0][h], r4[0][h]);
    a[2 * h][3] = code_pair<1>(r[1][h], r4[1][h]);
    a[2 * h + 1][0] = code_pair<2>(r[0][h], r4[0][h]);
    a[2 * h + 1][1] = code_pair<2>(r[1][h], r4[1][h]);
    a[2 * h + 1][2] = code_pair<3>(r[0][h], r4[0][h]);
    a[2 * h + 1][3] = code_pair<3>(r[1][h], r4[1][h]);
  }
}

// A fragments of 16-k slice kk of a stage for one thread, 8-bit codes.
// `w` points at W row r0 of the stage's code box (64 bytes a row, row r0 +
// 1 follows), whose 16-byte chunk c of both rows TMA wrote at chunk c ^ sw
// (the 64-byte swizzle, sw = (r0 / 2) % 4).  The slice needs bytes 2t,
// 2t+1 (halfword t of chunk kk) and 2t+8, 2t+9 (halfword t + 4) of each
// row; `sel` puts halfword t of a word pair at bytes 0 and 2.  Each byte
// gives two exact bf16 parts, lo = 128 + (low nibble) and hi = 256 + 16
// (high nibble) (as codes8 below).
__device__ __forceinline__ void q8_slice(uint32_t (&lo)[4], uint32_t (&hi)[4],
                                         const uint8_t* w, int sw, int kk,
                                         uint32_t sel) {
  const int c = kk ^ sw;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const uint4 u = *reinterpret_cast<const uint4*>(w + 64 * row + 16 * c);
    const uint32_t v0 = prmt(u.x, u.y, sel), v1 = prmt(u.z, u.w, sel);
    lo[row] = and_or(v0, 0x000F000Fu, 0x43004300u);
    lo[2 + row] = and_or(v1, 0x000F000Fu, 0x43004300u);
    hi[row] = and_or(v0 >> 1, 0x00780078u, 0x43804380u);
    hi[2 + row] = and_or(v1 >> 1, 0x00780078u, 0x43804380u);
  }
}

// acc += s P + (b - c s) sum(x) for one finished group (c = 128 at 4 bits,
// 384 at 8): `sc` holds the group's (s, b - c s) per W row, `xs` its sum of
// x per x row.  P.v[4i + e] is W row r0 + (e >> 1), x row 8i + 2t + (e & 1).
template <int BM>
__device__ __forceinline__ void qmm_fold(Acc<BM>& acc, const Acc<BM>& P,
                                         const float2* sc, const float* xs,
                                         int r0, int t) {
  const float4 v = *reinterpret_cast<const float4*>(sc + r0);
#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
    const float2 x2 = *reinterpret_cast<const float2*>(xs + 8 * i + 2 * t);
    acc.v[4 * i] = fmaf(v.x, P.v[4 * i], fmaf(v.y, x2.x, acc.v[4 * i]));
    acc.v[4 * i + 1] =
        fmaf(v.x, P.v[4 * i + 1], fmaf(v.y, x2.y, acc.v[4 * i + 1]));
    acc.v[4 * i + 2] =
        fmaf(v.z, P.v[4 * i + 2], fmaf(v.w, x2.x, acc.v[4 * i + 2]));
    acc.v[4 * i + 3] =
        fmaf(v.z, P.v[4 * i + 3], fmaf(v.w, x2.y, acc.v[4 * i + 3]));
  }
}

__device__ __forceinline__ float bf16_sum8(const uint4 u) {
  return ((bf16_lo(u.x) + bf16_hi(u.x)) + (bf16_lo(u.y) + bf16_hi(u.y))) +
         ((bf16_lo(u.z) + bf16_hi(u.z)) + (bf16_lo(u.w) + bf16_hi(u.w)));
}

// floor(n / d) for a split's bounds, m = ceil(2^32 / d) from the host (0
// for d = 1): exact while n d < 2^32, and free of the integer-to-float
// conversions that the code of an integer division holds.
__device__ __forceinline__ int div_magic(uint32_t n, uint32_t m) {
  return m ? (int)__umulhi(n, m) : (int)n;
}

// Grid: (ceil(M / BM) x tiles, ceil(N / 128) W tiles, splits).  Warps 0-3
// and 4-7 are the consumer warpgroups of W rows 0-63 and 64-127 of the
// tile; lane 0 of warp 8 is the producer; warps 9-11 take turns to write a
// stage's group data (s, b - c s, sums of x).  Split slice z covers units
// [z U / S, (z + 1) U / S) of the U units of max(g, 64) codes (split_m the
// magic of S for div_magic); with splits > 1 the block writes f32 partials
// to part[z], else bf16 to y.  g = 1 << lg, so that the kernel divides by
// no runtime value; the 8-bit kernel at BM = 64 is built for each g (GT).
template <int BITS, int BM, int GT>
__global__ void __launch_bounds__(QG_THREADS, 1)
qmm_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap qmap,
                const __nv_bfloat16* __restrict__ scales,
                const __nv_bfloat16* __restrict__ biases,
                __nv_bfloat16* __restrict__ y, float* __restrict__ part, int M,
                int K, int N, int lg, int splits, uint32_t split_m) {
  using L = QmmLayout<BITS, BM>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[QG_MAX_STAGES], empty[QG_MAX_STAGES];
  __shared__ __align__(8) uint64_t ready[QG_MAX_STAGES];
  // aligned by an offset from the __shared__ array (32-bit shared loads)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * QG_BN;
  static_assert((BITS == 8 && BM == 64) == (GT != 0), "GT: 8-bit, BM 64");
  const int g = GT ? GT : 1 << lg, G = K >> lg;
  const int lu = lg > 6 ? lg : 6;  // a unit is 1 << lu codes: max(g, 64)
  const int per_unit = 1 << (lu - 6);  // stages per unit
  // whole units, and at 8 bits and g = 32 a trailing half stage as one
  const int units = (K + (1 << lu) - 1) >> lu;
  const int t0 = div_magic(blockIdx.z * units, split_m) * per_unit;
  const int t1 = div_magic((blockIdx.z + 1) * units, split_m) * per_unit;
  const int slots = g == 32 ? 2 : 1;  // groups that end in one stage

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
      mbar_init(&ready[s], 1);  // the group-data warp of the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n");
    if (warp == 8) {
      // ---- producer: one thread keeps the ring of x and code tiles full
      if (lane == 0) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&xmap))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&qmap))
                     : "memory");
        for (int it = 0; it < t1 - t0; ++it) {
          const int s = it % L::STAGES;
          mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * L::STAGE;
          const int k0 = (t0 + it) * QG_BK;
          mbar_expect_tx(&full[s], L::X_BYTES + L::W_BYTES);
          tma_load_2d(st, &xmap, &full[s], k0, m0);
          tma_load_2d(st + L::X_BYTES, &qmap, &full[s], k0 * BITS / 8, n0);
        }
      }
      return;
    }
    // ---- group data: warp 9 + j writes stages j, j + 3, j + 6, ...; lane
    // l handles W rows and x rows l + 32 i of the tile.  Each stage's
    // scales and biases are loaded one turn (three stages) ahead.
    const int j = warp - 9, nst = t1 - t0;
    uint32_t cur[4][2], nxt[4][2];  // bf16 s and b: [row][s, b], slot 1 high
    auto load_sb = [&](int it, uint32_t(&sb)[4][2]) {
      const int gi = ((t0 + it) * QG_BK) >> lg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + lane + 32 * i;
        const size_t at = (size_t)n * G + gi;
        sb[i][0] = sb[i][1] = 0u;
        if (n < N && slots == 2 && !(G & 1)) {  // two groups: one aligned
                                                // 32-bit read
          sb[i][0] = *reinterpret_cast<const uint32_t*>(scales + at);
          sb[i][1] = *reinterpret_cast<const uint32_t*>(biases + at);
        } else if (n < N && slots == 2) {  // an odd group count: 16-bit
          // reads, the second group 0 past the row's last (a half stage)
          const uint32_t hi = gi + 1 < G;
          sb[i][0] = *reinterpret_cast<const uint16_t*>(scales + at) |
                     (hi ? (uint32_t)*reinterpret_cast<const uint16_t*>(
                               scales + at + 1) << 16
                         : 0u);
          sb[i][1] = *reinterpret_cast<const uint16_t*>(biases + at) |
                     (hi ? (uint32_t)*reinterpret_cast<const uint16_t*>(
                               biases + at + 1) << 16
                         : 0u);
        } else if (n < N) {
          sb[i][0] = *reinterpret_cast<const uint16_t*>(scales + at);
          sb[i][1] = *reinterpret_cast<const uint16_t*>(biases + at);
        }
      }
    };
    if (j < nst) load_sb(j, cur);
    for (int it = j; it < nst; it += 3) {
      if (it + 3 < nst) load_sb(it + 3, nxt);
      const int s = it % L::STAGES;
      const int k0 = (t0 + it) * QG_BK;
      mbar_wait(&full[s], (it / L::STAGES) & 1);
      uint8_t* st = smem + s * L::STAGE;
      float2* sc = reinterpret_cast<float2*>(st + L::X_BYTES + L::W_BYTES);
      float* xs = reinterpret_cast<float*>(st + L::X_BYTES + L::W_BYTES +
                                           L::SC_BYTES);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          if (slot < slots) {
            const float sv = slot ? bf16_hi(cur[i][0]) : bf16_lo(cur[i][0]);
            const float bv = slot ? bf16_hi(cur[i][1]) : bf16_lo(cur[i][1]);
            sc[slot * QG_BN + lane + 32 * i] =
                make_float2(sv, fmaf(-L::OFF, sv, bv));
          }
        }
      }
      // g = 128, the group's second stage: add the first stage's sums,
      // which another warp writes (that stage is not released before this
      // one is ready)
      const float* first = nullptr;
      if (slots == 1 && (k0 & (g - 1)) != 0) {
        const int sp = (it - 1) % L::STAGES;
        mbar_wait(&ready[sp], ((it - 1) / L::STAGES) & 1);
        first = reinterpret_cast<const float*>(
            smem + sp * L::STAGE + L::X_BYTES + L::W_BYTES + L::SC_BYTES);
      }
#pragma unroll 1
      for (int i = 0; i < BM / 32; ++i) {
        const int r = lane + 32 * i;
        // 16-byte chunk c of x row r sits at chunk c ^ (r % 8)
        const uint8_t* xr = st + r * 128;
        float half[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sum = 0.f;
#pragma unroll
          for (int c = 4 * h; c < 4 * h + 4; ++c)
            sum += bf16_sum8(*reinterpret_cast<const uint4*>(
                xr + ((c ^ (r & 7)) << 4)));
          half[h] = sum;
        }
        if (slots == 2) {
          xs[r] = half[0];
          xs[BM + r] = half[1];
        } else {
          xs[r] = (half[0] + half[1]) + (first ? first[r] : 0.f);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[s]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cur[i][0] = nxt[i][0];
        cur[i][1] = nxt[i][1];
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns W rows 64 wg .. 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
  const int wg = warp / 4, w = warp % 4, g8 = lane / 4, t = lane % 4;
  const int r0 = 64 * wg + 16 * w + 2 * g8;  // W row of A row g8 (+1: g8+8)

  Acc<BM> acc, P;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc.v[i] = P.v[i] = 0.f;
  // A fragments of two steps: one is built while the other's wgmmas run
  uint32_t a0[4][4], a1[4][4];
  int prev = -1;

  // fold partial Pg, whose wgmmas are done, of the group whose data stage
  // s holds in `slot`
  auto fold_partial = [&](Acc<BM>& Pg, int s, int slot) {
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) fence_reg(Pg.v[i]);
    const uint8_t* m = smem + s * L::STAGE + L::X_BYTES + L::W_BYTES;
    qmm_fold<BM>(acc, Pg, reinterpret_cast<const float2*>(m) + slot * QG_BN,
                 reinterpret_cast<const float*>(m + L::SC_BYTES) + slot * BM,
                 r0, t);
  };
  // fold P once its wgmmas end
  auto fold = [&](int s, int slot) {
    wgmma_wait<0>();
    fold_partial(P, s, slot);
  };

  if constexpr (BITS == 4) {
    // a step is a stage: four slices, one wgmma each
    const uint32_t sel = t | ((4 + t) << 4);
    auto stage = [&](uint32_t(&a)[4][4], uint32_t(&done)[4][4], int it) {
      const int s = it % L::STAGES;
      const int phase = (it / L::STAGES) & 1;
      mbar_wait(&full[s], phase);
      mbar_wait(&ready[s], phase);
      const uint8_t* st = smem + s * L::STAGE;
      q4_fragments(a, st + L::X_BYTES + r0 * 32, sel);
      const bool starts = ((t0 + it) * QG_BK & (g - 1)) == 0;
      // the group that ended with the previous stage is complete: fold it
      if (starts && prev >= 0) fold(prev, slots - 1);
      const uint32_t xaddr = smem_u32(st);
      wgmma_fence();
      wgmma_rs(P, a[0], x_desc(xaddr), starts ? 0 : 1);
      wgmma_rs(P, a[1], x_desc(xaddr + 32));
      if (slots == 2) {  // g = 32: the stage's first group ends here
        wgmma_commit();
        fold(s, 0);
        wgmma_fence();
        wgmma_rs(P, a[2], x_desc(xaddr + 64), 0);
      } else {
        wgmma_rs(P, a[2], x_desc(xaddr + 64));
      }
      wgmma_rs(P, a[3], x_desc(xaddr + 96));
      wgmma_commit();
      wgmma_wait<1>();
      // the previous stage's wgmmas are done: its registers and stage are
      // free
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
    fold(prev, slots - 1);
  } else {
    const uint32_t sel = (2 * t) | ((2 * t + 1) << 8);
    const int sw = g8 & 3;  // (r0 / 2) % 4
    if constexpr (BM == 64) {
      // A step is a stage, as at 4 bits (its fragments are 32 registers),
      // and two partials, P and Q, take turns by group, so that a group is
      // folded while the next group's wgmmas run.  ptxas serializes the
      // wgmmas wherever a partial that is read might be one still in
      // flight, so the partials' roles are fixed in the code (the loop is
      // unrolled over two groups, the kernel built for each g) and no wgmma
      // is in flight across the loop's back edge.
      Acc<BM> Q;
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) Q.v[i] = 0.f;
      uint32_t b0[8][4], b1[8][4];
      // stage it into partial Pc (`starts`: its group's first stage); the
      // group that ended with the previous stage is in Pp and is folded
      // once this stage's wgmmas run.  `split` (g = 32): slices 0-1 are a
      // group into Pc and slices 2-3 one into Pp, each folded while the
      // other's wgmmas run.
      auto stage = [&](uint32_t(&a)[8][4], uint32_t(&done)[8][4],
                       Acc<BM>& Pc, Acc<BM>& Pp, int it, bool starts,
                       bool split) {
        const int s = it % L::STAGES;
        const int phase = (it / L::STAGES) & 1;
        mbar_wait(&full[s], phase);
        mbar_wait(&ready[s], phase);
        const uint8_t* st = smem + s * L::STAGE;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          q8_slice(a[2 * i], a[2 * i + 1], st + L::X_BYTES + r0 * 64, sw, i,
                   sel);
        const uint32_t xaddr = smem_u32(st);
        wgmma_fence();
        wgmma_rs(Pc, a[0], x_desc(xaddr), starts ? 0 : 1);
        wgmma_rs(Pc, a[1], x_desc(xaddr));
        wgmma_rs(Pc, a[2], x_desc(xaddr + 32));
        wgmma_rs(Pc, a[3], x_desc(xaddr + 32));
        if (split) {
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's second group is done
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) fence_reg(done[kk][r]);
          if (prev >= 0) fold_partial(Pp, prev, 1);
          wgmma_fence();
          wgmma_rs(Pp, a[4], x_desc(xaddr + 64), 0);
          wgmma_rs(Pp, a[5], x_desc(xaddr + 64));
          wgmma_rs(Pp, a[6], x_desc(xaddr + 96));
          wgmma_rs(Pp, a[7], x_desc(xaddr + 96));
          wgmma_commit();
          wgmma_wait<1>();
          fold_partial(Pc, s, 0);  // this stage's first group is done
        } else {
          wgmma_rs(Pc, a[4], x_desc(xaddr + 64));
          wgmma_rs(Pc, a[5], x_desc(xaddr + 64));
          wgmma_rs(Pc, a[6], x_desc(xaddr + 96));
          wgmma_rs(Pc, a[7], x_desc(xaddr + 96));
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's wgmmas are done
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) fence_reg(done[kk][r]);
          if (starts && prev >= 0) fold_partial(Pp, prev, 0);
        }
        __syncwarp();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
      };

      const int nst = t1 - t0;
      int it = 0;
      bool tail = false;
      if constexpr (GT == 32) {
        for (; it + 2 <= nst; it += 2) {
          stage(b0, b1, P, Q, it, true, true);
          stage(b1, b0, P, Q, it + 1, true, true);
          wgmma_wait<0>();
        }
        if (it < nst) stage(b0, b1, P, Q, it, true, true);
      } else if constexpr (GT == 64) {
        // four groups between drains: each drain costs a bubble
        for (; it + 4 <= nst; it += 4) {
          stage(b0, b1, P, Q, it, true, false);
          stage(b1, b0, Q, P, it + 1, true, false);
          stage(b0, b1, P, Q, it + 2, true, false);
          stage(b1, b0, Q, P, it + 3, true, false);
          wgmma_wait<0>();
        }
        if (it + 2 <= nst) {
          stage(b0, b1, P, Q, it, true, false);
          stage(b1, b0, Q, P, it + 1, true, false);
          wgmma_wait<0>();
          it += 2;
        }
        tail = it < nst;
        if (tail) stage(b0, b1, P, Q, it, true, false);
      } else {
        for (; it + 4 <= nst; it += 4) {
          stage(b0, b1, P, Q, it, true, false);
          stage(b1, b0, P, Q, it + 1, false, false);
          stage(b0, b1, Q, P, it + 2, true, false);
          stage(b1, b0, Q, P, it + 3, false, false);
          wgmma_wait<0>();
        }
        tail = it < nst;  // one group of two stages
        if (tail) {
          stage(b0, b1, P, Q, it, true, false);
          stage(b1, b0, P, Q, it + 1, false, false);
        }
      }
      // the last group: Q at g = 32 (slot 1), else P after a tail group
      wgmma_wait<0>();
      if (tail)
        fold_partial(P, prev, 0);
      else
        fold_partial(Q, prev, GT == 32 ? 1 : 0);
    } else {
      // a step is half a stage: two slices, two wgmmas each (lo and hi
      // parts), so that two steps' fragments fit beside acc and P at BM =
      // 128; a fold waits for the wgmmas to drain
      int prev_slot = 0;
      auto step = [&](uint32_t(&a)[4][4], uint32_t(&done)[4][4], int j) {
        const int it = j >> 1, h = j & 1;
        const int s = it % L::STAGES;
        if (h == 0) {
          const int phase = (it / L::STAGES) & 1;
          mbar_wait(&full[s], phase);
          mbar_wait(&ready[s], phase);
        }
        const uint8_t* st = smem + s * L::STAGE;
        const uint8_t* w = st + L::X_BYTES + r0 * 64;
        q8_slice(a[0], a[1], w, sw, 2 * h, sel);
        q8_slice(a[2], a[3], w, sw, 2 * h + 1, sel);
        const bool starts = (((t0 + it) * QG_BK + 32 * h) & (g - 1)) == 0;
        // the group that ended with the previous step is complete: fold it
        if (starts && prev >= 0) fold(prev, prev_slot);
        const uint32_t xaddr = smem_u32(st) + 64 * h;
        wgmma_fence();
        wgmma_rs(P, a[0], x_desc(xaddr), starts ? 0 : 1);
        wgmma_rs(P, a[1], x_desc(xaddr));
        wgmma_rs(P, a[2], x_desc(xaddr + 32));
        wgmma_rs(P, a[3], x_desc(xaddr + 32));
        wgmma_commit();
        wgmma_wait<1>();
        // the previous step's wgmmas are done: its registers are free, and
        // its stage too where it was the stage's second half
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) fence_reg(done[kk][r]);
        __syncwarp();
        if (h == 0 && prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        prev_slot = slots == 2 ? h : 0;
      };

      for (int j = 0; j < 2 * (t1 - t0); j += 2) {
        step(a0, a1, j);
        step(a1, a0, j + 1);
      }
      fold(prev, prev_slot);
    }
  }

  // ---- epilogue: acc.v[4i + e] is W row r0 + (e >> 1), x row 8i + 2t +
  // (e & 1) of the tile
  const int n = n0 + r0;
  if (n >= N) return;
  const bool pair = (N % 2 == 0);  // then n + 1 < N too (n is even)
#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * i + 2 * t + e;
      if (m >= M) continue;
      const float lo = acc.v[4 * i + e], hi = acc.v[4 * i + 2 + e];
      if (splits > 1) {
        float* dst = part + ((size_t)blockIdx.z * M + m) * N + n;
        if (pair) {
          *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
        } else {
          dst[0] = lo;
          if (n + 1 < N) dst[1] = hi;
        }
      } else {
        __nv_bfloat16* dst = y + (size_t)m * N + n;
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(lo, hi);
        } else {
          dst[0] = __float2bfloat16_rn(lo);
          if (n + 1 < N) dst[1] = __float2bfloat16_rn(hi);
        }
      }
    }
  }
}

template <int BITS, int BM, int GT>
cudaError_t launch_qmm(const void* x, const void* q, const __nv_bfloat16* s,
                       const __nv_bfloat16* b, __nv_bfloat16* y, float* part,
                       int M, int K, int N, int g, int splits,
                       cudaStream_t st) {
  CUtensorMap xmap, qmap;
  if (!tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BM,
                  QG_BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N,
                  K * BITS / 8, QG_BN, QG_BK * BITS / 8,
                  BITS == 4 ? CU_TENSOR_MAP_SWIZZLE_NONE
                            : CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const int smem = QmmLayout<BITS, BM>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      qmm_gemm_kernel<BITS, BM, GT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, (N + QG_BN - 1) / QG_BN, splits);
  const int lg = g == 32 ? 5 : g == 64 ? 6 : 7;
  const uint32_t split_m =
      splits > 1 ? (uint32_t)(((1ULL << 32) + splits - 1) / splits) : 0u;
  qmm_gemm_kernel<BITS, BM, GT><<<grid, QG_THREADS, smem, st>>>(
      xmap, qmap, s, b, y, part, M, K, N, lg, splits, split_m);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)M * N;
  const int blocks = (int)min((total / 4 + 255) / 256 + 1, 4LL * 132);
  splitk_reduce<<<blocks, 256, 0, st>>>(part, y, total, splits);
  return cudaGetLastError();
}

// ------------------------------------------------------------ GEMV route

constexpr int MV_THREADS = 256;  // 8 warps: RT row tiles x 8 / RT parts of K
constexpr int MV_STEP = 32;      // code bytes of one W row per step
constexpr int MV_SS = 4;         // steps per ring stage
constexpr int MV_RING = 2;       // ring stages per warp
constexpr int MV_ROW = MV_SS * MV_STEP + 16;  // a stage row in shared memory
                                              // (rows 16 bytes apart mod 128)
constexpr int MV_WARP_RING = MV_RING * 16 * MV_ROW;  // bytes per warp
constexpr int MV_RED_BYTES = MV_THREADS / 32 * 16 * 8 * 4;  // warps' partials
// dynamic shared memory of a block at most
constexpr int MV_SMEM_MAX = 232448 - MV_RED_BYTES;

// The GEMV's shape for BITS-bit codes in groups of G.
template <int BITS, int G>
struct Qmv {
  static constexpr int GB = G * BITS / 8;  // code bytes of a group
  static constexpr int GPS = GB <= MV_STEP ? MV_STEP / GB : 0;  // groups a
                                                                // step holds
  static constexpr int SPG = GB > MV_STEP ? GB / MV_STEP : 1;   // steps a
                                                                // group takes
  static constexpr int UNIT = GB > MV_STEP ? GB : MV_STEP;  // K unit, bytes
  static constexpr int GPU = GPS > 1 ? GPS : 1;             // groups a unit
  static constexpr int XB = BITS == 4 ? 16 : 8;  // x bytes per code word
  static constexpr float OFF = BITS == 4 ? 128.f : 384.f;  // code offset
};

// Shared memory of a GEMV block (launch_qmv and ops/qmatmul.py:_gemv_smem):
// the warps' rings; the scales and biases of a tile's rows for a chunk
// ([slots][2][16 RT rows][sbw values]: with one chunk, the rows as they
// lie in memory, sbw = K / g, in two slots when the grid is persistent;
// with more, the 32-bit words that hold the chunk's groups, one more group
// where a row's copy starts a group early); x of a chunk, M rows of xstride
// bytes; the sums of x, 8 per group of a chunk.
struct QmvSmem {
  int sbw, sb_slots, xstride, bytes;
};

__host__ __device__ inline QmvSmem qmv_smem(int M, int K, int bits, int g,
                                            int lrt, int lnc, int slots) {
  const int gb = g * bits / 8, unit = gb > MV_STEP ? gb : MV_STEP;
  const int units = K / 8 * bits / unit;
  const int cu = (units + (1 << lnc) - 1) >> lnc;       // units of a chunk
  const int kc = cu * unit / bits * 8;                  // codes of a chunk
  QmvSmem r;
  r.sbw = lnc ? (kc / g + 2) / 2 * 2 : K / g;
  r.sb_slots = slots;  // 2: a persistent block's next tile in the other
  r.xstride = (kc * 2 + 127) / 128 * 128 + 16;  // x rows 16 bytes apart
  r.bytes = 8 * MV_WARP_RING + r.sb_slots * 2 * (16 << lrt) * r.sbw * 2 +
            M * r.xstride + kc / g * 8 * 4;
  return r;
}

// 4-bit: the eight codes of a word (code i at bits [4i, 4i + 4)) as four
// pairs of exact bf16 128 + code; pair i holds codes i and i + 4.
__device__ __forceinline__ void codes4(uint32_t w, uint32_t (&r)[4]) {
  r[0] = and_or(w, 0x000F000Fu, 0x43004300u);
  r[1] = and_or(w >> 4, 0x000F000Fu, 0x43004300u);
  r[2] = and_or(w >> 8, 0x000F000Fu, 0x43004300u);
  r[3] = and_or(w >> 12, 0x000F000Fu, 0x43004300u);
}

// 8-bit: the four codes of a word (code i in byte i) as two pairs of exact
// bf16 parts, lo = 128 + (low nibble) and hi = 256 + 16 (high nibble), so
// that lo + hi = 384 + code; pair i holds codes i and i + 2.  The high
// nibble, shifted to mantissa bits 3-6 of 256.0 (bf16 0x4380), counts 16.
__device__ __forceinline__ void codes8(uint32_t w, uint32_t (&lo)[2],
                                       uint32_t (&hi)[2]) {
  lo[0] = and_or(w, 0x000F000Fu, 0x43004300u);
  hi[0] = and_or(w >> 1, 0x00780078u, 0x43804380u);
  lo[1] = and_or(w >> 8, 0x000F000Fu, 0x43004300u);
  hi[1] = and_or(w >> 9, 0x00780078u, 0x43804380u);
}

// Eight bf16 of x (k0 .. k0 + 7, two to a word, the lower k in the low
// half) in the order a code word's pairs take them: 4-bit (k0, k0+4),
// (k0+1, k0+5), (k0+2, k0+6), (k0+3, k0+7); 8-bit (k0, k0+2), (k0+1, k0+3),
// (k0+4, k0+6), (k0+5, k0+7).
template <int BITS>
__device__ __forceinline__ uint4 x_order(uint4 u) {
  if (BITS == 4)
    return make_uint4(prmt(u.x, u.z, 0x5410), prmt(u.x, u.z, 0x7632),
                      prmt(u.y, u.w, 0x5410), prmt(u.y, u.w, 0x7632));
  return make_uint4(prmt(u.x, u.y, 0x5410), prmt(u.x, u.y, 0x7632),
                    prmt(u.z, u.w, 0x5410), prmt(u.z, u.w, 0x7632));
}

// 16 bytes into shared memory, asynchronously, asking L2 to fetch the 256
// bytes around them (the rest of a row's stream)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(
                   dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row tiles of 16 RT W rows, RT = 1 << lrt; a block of 8 warps computes a
// tile, warp w its row tile w % RT over part w / RT of K (K is cut into
// units of whole groups and whole 32-byte steps, the units into 8 / RT
// parts).  With one chunk of K (lnc = 0) a block's x is staged once and the
// block walks tiles blockIdx.x, + gridDim.x, ...: each warp streams its
// stages across tiles, the next tile's scales and biases going into the
// other of two slots; with NC = 1 << lnc chunks, x of a chunk at a time,
// the grid holds one block per tile.  Shared memory as qmv_smem lays it
// out.
//
// The expert-indexed entry (`experts` set, M = 1): W is a stack of E
// experts [E, N, K * BITS / 8] (scales and biases [E, N, K / G]) and the
// grid's second axis runs over pairs: the blocks of row p read the pair's
// expert e = experts[p] and x row rows[p] (p where rows is null) from the
// device, offset the codes, scales and biases by e experts and x by that
// row, and write row p of y [pairs, N].  Nothing of the pairs is read on
// the host, so the launch can be captured in a CUDA graph and replayed
// with other pairs.  An expert index outside [0, E) traps.
template <int BITS, int G>
__global__ void __launch_bounds__(MV_THREADS, 2)
qmv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
           const __nv_bfloat16* __restrict__ scales,
           const __nv_bfloat16* __restrict__ biases,
           __nv_bfloat16* __restrict__ y, int M, int K, int N, int lrt,
           int lnc, const int* __restrict__ experts,
           const int* __restrict__ rows, int E) {
  using C = Qmv<BITS, G>;
  if (experts) {
    const int p = blockIdx.y, e = experts[p];
    if (e < 0 || e >= E) __trap();
    const size_t values = (size_t)N * (K / G);  // scales of one expert
    q += (size_t)e * N * (K / 8 * BITS);
    scales += e * values;
    biases += e * values;
    x += (size_t)(rows ? rows[p] : p) * K;
    y += (size_t)p * N;
  }
  extern __shared__ __align__(16) uint8_t mv_smem[];
  __shared__ float red[MV_THREADS / 32][16][8];  // each warp's partial
  const int tiles = (N + (16 << lrt) - 1) >> (4 + lrt);
  const QmvSmem L =
      qmv_smem(M, K, BITS, G, lrt, lnc, (int)gridDim.x < tiles ? 2 : 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int rt = warp & ((1 << lrt) - 1), wk = warp >> lrt, lwk = 3 - lrt;
  const bool xon = g8 < M;
  const int row_bytes = K / 8 * BITS, ngroups = K / G;
  const int units = row_bytes / C::UNIT;
  uint8_t* ring = mv_smem + warp * MV_WARP_RING;
  const uint32_t ring_u32 = smem_u32(ring);
  const int sb_array = (16 << lrt) * L.sbw;  // values per array
  auto* sbs = reinterpret_cast<__nv_bfloat16*>(mv_smem + 8 * MV_WARP_RING);
  uint8_t* xs = mv_smem + 8 * MV_WARP_RING + L.sb_slots * 2 * sb_array * 2;
  float* xsum = reinterpret_cast<float*>(xs + M * L.xstride);

  // stage st of the warp's steps [s0, s0 + nst) of tile `tile` into ring
  // slot `ring_slot`: 16 rows x MV_SS * 2 pieces of 16 bytes, a row's
  // pieces on neighbouring lanes (the caller commits)
  auto issue = [&](int tile, int st, int ring_slot, int s0, int nst) {
    const int row0 = (tile << (4 + lrt)) + 16 * rt;
    const uint32_t slot = ring_u32 + ring_slot * (16 * MV_ROW);
#pragma unroll
    for (int u = 0; u < MV_SS; ++u) {
      const int id = u * 32 + lane, r = id / (2 * MV_SS), pc = id % (2 * MV_SS);
      const int i = st * MV_SS + pc / 2;  // the piece's step
      if (tile < tiles && i < nst && row0 + r < N)
        cp_async16(slot + r * MV_ROW + pc * 16,
                   q + (size_t)(row0 + r) * row_bytes + (s0 + i) * MV_STEP +
                       (pc & 1) * 16);
    }
  };

  // the first group of row r's values that a chunk's copy from group cg0
  // starts at: cg0, or the group before where cg0 is the high half of a
  // 32-bit word of the array (row r of a tile starts at an odd value where
  // r and the groups per row are odd)
  auto sb_first = [&](int r, int cg0) {
    return cg0 - (((r & ngroups) + cg0) & 1);
  };

  // every thread: the scales and biases of tile `tile`'s rows for groups
  // [cg0, cg0 + ng) into values slot `slot` (the caller commits).  The
  // copies are cp.async words; a value that would end a word past the
  // array's end (an odd number of values in all) is copied by a plain load
  // and store, which the barrier before the values are read makes visible.
  auto issue_sb = [&](int tile, int slot, int cg0, int ng) {
    const int nb0 = tile << (4 + lrt), nrows = min(16 << lrt, N - nb0);
    const uint32_t base = smem_u32(sbs) + slot * 2 * sb_array * 2;
    const size_t total = (size_t)N * ngroups;  // values of each array
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const __nv_bfloat16* arr = a ? biases : scales;
      const __nv_bfloat16* src = arr + (size_t)nb0 * ngroups;
      const uint32_t dst = base + a * sb_array * 2;
      __nv_bfloat16* dsv = sbs + (slot * 2 + a) * sb_array;
      if (lnc == 0) {  // whole rows: one span, 16-byte copies where aligned
        const int vals = nrows * ngroups, bytes = vals * 2;
        const int n16 =
            reinterpret_cast<uintptr_t>(src) % 16 ? 0 : bytes / 16;
        for (int i = threadIdx.x; i < n16; i += MV_THREADS)
          cp_async16(dst + 16 * i,
                     reinterpret_cast<const uint8_t*>(src) + 16 * i);
        for (int i = 4 * n16 + threadIdx.x; i < bytes / 4; i += MV_THREADS)
          cp_async4(dst + 4 * i, reinterpret_cast<const uint8_t*>(src) + 4 * i);
        if ((vals & 1) && threadIdx.x == 0) dsv[vals - 1] = src[vals - 1];
      } else {  // a chunk of each row: the words that hold its groups,
                // from group sb_first(r, cg0) at the row's value 0
        int lw = 0;  // words per row at most, rounded up to a power of two
        while ((1 << lw) < (ng + 2) >> 1) ++lw;
        for (int i = threadIdx.x; i < (nrows << lw); i += MV_THREADS) {
          const int r = i >> lw, w = i & ((1 << lw) - 1);
          const int e0 = sb_first(r, cg0);
          if (w < (cg0 + ng - e0 + 1) >> 1) {
            const size_t e = (size_t)(nb0 + r) * ngroups + e0 + 2 * w;
            if (e + 1 < total)
              cp_async4(dst + (r * L.sbw + 2 * w) * 2, arr + e);
            else
              dsv[r * L.sbw + 2 * w] = arr[e];
          }
        }
      }
    }
  };

  // x rows 0 .. M-1, codes [k0, k0 + 8 nblk) of a chunk, into xs as they
  // lie in memory: thread i copies 16-byte blocks i + 256 j of each row (the
  // caller commits)
  auto issue_x = [&](int k0, int nblk) {
    const uint32_t base = smem_u32(xs);
    for (int m = 0; m < M; ++m)
      for (int j = threadIdx.x; j < nblk; j += MV_THREADS)
        cp_async16(base + m * L.xstride + j * 16,
                   x + (size_t)m * K + k0 + 8 * j);
  };
  // once a thread's copies of x have landed: each of its blocks into pair
  // order in place, and the sum of x per group and row into xsum (a group
  // is G / 8 neighbouring lanes' blocks)
  auto stage_x = [&](int nblk) {
    const int rb = (nblk + 31) & ~31;  // blocks per row, in whole warps
    for (int m = 0; m < M; ++m) {
      for (int b0 = warp * 32; b0 < rb; b0 += MV_THREADS) {
        const int j = b0 + lane;
        uint4* p = reinterpret_cast<uint4*>(xs + m * L.xstride + j * 16);
        const uint4 u = j < nblk ? *p : make_uint4(0, 0, 0, 0);
        float sum = bf16_sum8(u);
#pragma unroll
        for (int o = 1; o < G / 8; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (j < nblk) {
          *p = x_order<BITS>(u);
          if ((lane & (G / 8 - 1)) == 0) xsum[j / (G / 8) * 8 + m] = sum;
        }
      }
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float P0[4] = {0.f, 0.f, 0.f, 0.f}, P1[4] = {0.f, 0.f, 0.f, 0.f};

  // acc += s P + (b - OFF s) sum x for a group with partial P: its scale
  // and bias at sv (rows g8 and g8 + 8 of the tile's values), its sums of x
  // at xg (x rows 2t and 2t + 1)
  auto fold = [&](const float (&P)[4], const __nv_bfloat16* sv,
                  const float* xg) {
    const float sA = __bfloat162float(sv[0]);
    const float sB = __bfloat162float(sv[8 * L.sbw]);
    const float bA = __bfloat162float(sv[sb_array]);
    const float bB = __bfloat162float(sv[sb_array + 8 * L.sbw]);
    const float x0 = 2 * t < M ? xg[0] : 0.f;
    const float x1 = 2 * t + 1 < M ? xg[1] : 0.f;
    const float cA = fmaf(-C::OFF, sA, bA), cB = fmaf(-C::OFF, sB, bB);
    acc[0] = fmaf(sA, P[0], fmaf(cA, x0, acc[0]));
    acc[1] = fmaf(sA, P[1], fmaf(cA, x1, acc[1]));
    acc[2] = fmaf(sB, P[2], fmaf(cB, x0, acc[2]));
    acc[3] = fmaf(sB, P[3], fmaf(cB, x1, acc[3]));
  };

  // piece p (16 bytes) of a step whose codes sit at st (row g8) and x at xp
  // (row g8, the step's word t): the quad reads word t of each of its two
  // rows, so that every 16-k slice of the MMAs lies in one piece and so in
  // one group; partial into P
  auto piece = [&](float (&P)[4], const uint8_t* st, const uint8_t* xp,
                   int p) {
    const uint32_t wa = *reinterpret_cast<const uint32_t*>(st + 16 * p);
    const uint32_t wb =
        *reinterpret_cast<const uint32_t*>(st + 8 * MV_ROW + 16 * p);
    xp += 4 * p * C::XB;
    if (BITS == 4) {
      const uint4 b =
          xon ? *reinterpret_cast<const uint4*>(xp) : make_uint4(0, 0, 0, 0);
      uint32_t ra[4], rb[4];
      codes4(wa, ra);
      codes4(wb, rb);
      const uint32_t a0[4] = {ra[0], rb[0], ra[1], rb[1]};
      const uint32_t a1[4] = {ra[2], rb[2], ra[3], rb[3]};
      mma_bf16(P, a0, b.x, b.y);
      mma_bf16(P, a1, b.z, b.w);
    } else {
      const uint2 b =
          xon ? *reinterpret_cast<const uint2*>(xp) : make_uint2(0, 0);
      uint32_t la[2], ha[2], lb[2], hb[2];
      codes8(wa, la, ha);
      codes8(wb, lb, hb);
      const uint32_t a0[4] = {la[0], lb[0], la[1], lb[1]};
      const uint32_t a1[4] = {ha[0], hb[0], ha[1], hb[1]};
      mma_bf16(P, a0, b.x, b.y);
      mma_bf16(P, a1, b.x, b.y);
    }
  };

  // step v of a stage: codes at st, x at xp, its (first) group's values at
  // sv and sums of x at xg; the two pieces into partials of their own (two
  // MMA chains), folded at the end of each group.  `last`: the step ends a
  // group (always when a group is no longer than a step).
  auto step = [&](const uint8_t* st, const uint8_t* xp,
                  const __nv_bfloat16* sv, const float* xg, bool last) {
    piece(P0, st, xp, 0);
    piece(P1, st, xp, 1);
    if (C::GPS == 2) {  // piece p is group p
      fold(P0, sv, xg);
      fold(P1, sv + 1, xg + 8);
    } else if (last) {
      float P[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) P[i] = P0[i] + P1[i];
      fold(P, sv, xg);
    } else {
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) P0[i] = P1[i] = 0.f;
  };

  // stage stg of the warp's part (steps [s0, s0 + nst)) in ring slot
  // ring_slot, once it has landed: x and sums of x relative to the chunk's
  // first code byte cbyte0, values in slot `slot` laid out from group e0
  constexpr int XSTEP = MV_STEP / 4 * C::XB;  // x bytes per step
  auto consume = [&](int stg, int ring_slot, int s0, int nst, int cbyte0,
                     int e0, int slot) {
    const uint8_t* sp = ring + ring_slot * (16 * MV_ROW) + g8 * MV_ROW + 4 * t;
    const uint8_t* xp0 =
        xs + g8 * L.xstride + ((s0 * MV_STEP - cbyte0) / 4 + t) * C::XB;
    const float* xg0 = xsum + (s0 * MV_STEP - cbyte0) / C::GB * 8 + 2 * t;
    const __nv_bfloat16* sv0 = sbs + slot * 2 * sb_array +
                               (16 * rt + g8) * L.sbw + s0 * MV_STEP / C::GB -
                               e0;
    const int i0 = stg * MV_SS;  // the stage's first step in the part
    // step v of the stage; its first group in the part at gi
    auto run = [&](int v) {
      const int gi = C::GPS ? (i0 + v) * C::GPS : (i0 + v) / C::SPG;
      step(sp + v * MV_STEP, xp0 + (i0 + v) * XSTEP, sv0 + gi, xg0 + gi * 8,
           C::GPS || (i0 + v) % C::SPG == C::SPG - 1);
    };
    if (i0 + MV_SS <= nst) {  // a whole stage: its steps may interleave
#pragma unroll
      for (int v = 0; v < MV_SS; ++v) run(v);
    } else {
#pragma unroll
      for (int v = 0; v < MV_SS; ++v)
        if (i0 + v < nst) run(v);
    }
  };

  // the warps' partials of tile `tile`, added in the order of their K parts
  auto finish = [&](int tile) {
    red[warp][g8][2 * t] = acc[0];
    red[warp][g8][2 * t + 1] = acc[1];
    red[warp][g8 + 8][2 * t] = acc[2];
    red[warp][g8 + 8][2 * t + 1] = acc[3];
    __syncthreads();
    const int rows = 16 << lrt;
    for (int o = threadIdx.x; o < (M << (4 + lrt)); o += MV_THREADS) {
      const int m = o >> (4 + lrt), r = o & (rows - 1);
      const int n = (tile << (4 + lrt)) + r;
      float v = 0.f;
      for (int w = 0; w < (8 >> lrt); ++w)
        v += red[(w << lrt) + (r >> 4)][r & 15][m];
      if (n < N) y[(size_t)m * N + n] = __float2bfloat16_rn(v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = 0.f;
  };

  // x's copies (hitting L2) go first, so that they do not wait behind the
  // code stream
  constexpr int SPU = C::UNIT / MV_STEP;  // steps per unit
  if (lnc == 0) {
    // the warp's part, the same in every tile
    const int wu0 = (wk * units) >> lwk;
    const int wun = (((wk + 1) * units) >> lwk) - wu0;
    const int s0 = wu0 * SPU, nst = wun * SPU;
    const int stages = max(1, (nst + MV_SS - 1) / MV_SS);
    const int nblk = units * C::UNIT / BITS;  // 16-byte blocks of an x row
    // the next stage to issue: stage `is` of tile `it`, the warp's
    // stage `ig` counted across tiles (its ring slot ig % RING), whose
    // values go to slot `isl`; a tile's values are issued with its stage 0
    int it = blockIdx.x, is = 0, isl = 0, ig = 0;
    auto issue_next = [&]() {
      if (is == 0 && it < tiles) issue_sb(it, isl, 0, ngroups);
      issue(it, is, ig++ % MV_RING, s0, nst);
      cp_async_commit();
      if (++is == stages) is = 0, it += gridDim.x, isl ^= 1;
    };
    issue_x(0, nblk);
    cp_async_commit();
#pragma unroll
    for (int r = 0; r < MV_RING; ++r) issue_next();
    cp_async_wait<MV_RING>();  // this thread's copies of x
    stage_x(nblk);  // while the first stages are in flight
    int slot = 0, cg = 0;  // the tile's values slot; the stage across tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int stg = 0; stg < stages; ++stg) {
        cp_async_wait<MV_RING - 1>();  // this stage (and its tile's values)
        if (stg == 0)
          __syncthreads();  // the tile's values, x: every thread's copies
        else
          __syncwarp();
        consume(stg, cg++ % MV_RING, s0, nst, 0, 0, slot);
        __syncwarp();  // the stage is read: refill its slot
        issue_next();
      }
      finish(tile);
      slot ^= 1;
    }
  } else {
    const int tile = blockIdx.x;
    for (int c = 0; c < (1 << lnc); ++c) {
      const int cu0 = (c * units) >> lnc;
      const int cn = (((c + 1) * units) >> lnc) - cu0;
      const int wu0 = cu0 + ((wk * cn) >> lwk);
      const int wun = cu0 + (((wk + 1) * cn) >> lwk) - wu0;
      const int s0 = wu0 * SPU, nst = wun * SPU;
      const int stages = (nst + MV_SS - 1) / MV_SS;
      const int cbyte0 = cu0 * C::UNIT, cg0 = cu0 * C::GPU;
      const int nblk = cn * C::UNIT / BITS;  // 16-byte blocks of an x row
      if (c > 0) __syncthreads();  // every warp is done with the last chunk
      issue_x(cbyte0 / BITS * 8, nblk);
      cp_async_commit();
      issue_sb(tile, 0, cg0, cn * C::GPU);
      cp_async_commit();
#pragma unroll
      for (int r = 0; r < MV_RING; ++r) {
        issue(tile, r, r, s0, nst);  // empty past nst
        cp_async_commit();
      }
      cp_async_wait<MV_RING + 1>();  // this thread's copies of x
      stage_x(nblk);
      cp_async_wait<MV_RING>();  // and of the scales and biases
      __syncthreads();
      for (int stg = 0; stg < stages; ++stg) {
        cp_async_wait<MV_RING - 1>();  // this stage
        __syncwarp();
        consume(stg, stg % MV_RING, s0, nst, cbyte0,
                sb_first(16 * rt + g8, cg0), 0);
        __syncwarp();  // the stage is read: refill its slot
        issue(tile, stg + MV_RING, stg % MV_RING, s0, nst);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    finish(tile);
  }
  cp_async_wait<0>();
}

// SMs of the current device (the persistent grid's size is twice that),
// read once per device
inline int sm_count(int dev) {
  static int count[64];
  if (dev < 0 || dev >= 64) return 132;
  if (!count[dev] && cudaDeviceGetAttribute(&count[dev],
                                            cudaDevAttrMultiProcessorCount,
                                            dev) != cudaSuccess)
    return 132;
  return count[dev];
}

// `pairs` rows of blocks: 1, or the pairs of the expert-indexed entry
// (experts and rows as qmv_kernel reads them, E experts in the stack)
template <int BITS, int G>
cudaError_t launch_qmv(const __nv_bfloat16* x, const uint8_t* q,
                       const __nv_bfloat16* s, const __nv_bfloat16* b,
                       __nv_bfloat16* y, int M, int K, int N, int lrt,
                       int lnc, cudaStream_t st, const int* experts = nullptr,
                       const int* rows = nullptr, int E = 0, int pairs = 1) {
  using C = Qmv<BITS, G>;
  const int tiles = (N + (16 << lrt) - 1) >> (4 + lrt);
  // persistent (2 blocks an SM) with one chunk and more tiles than that,
  // when every warp's part has a ring's stages (a tile's values slot is
  // refilled only once the tile has started); as ops/qmatmul.py's
  // _gemv_persistent decides
  const int units = K / 8 * BITS / C::UNIT;
  const int min_steps = (units >> (3 - lrt)) * (C::UNIT / MV_STEP);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(dev);
  const bool persistent =
      lnc == 0 && min_steps >= MV_RING * MV_SS && tiles > 2 * sms;
  const int smem = qmv_smem(M, K, BITS, G, lrt, lnc, persistent ? 2 : 1).bytes;
  if (smem > MV_SMEM_MAX || dev >= 64) return cudaErrorInvalidValue;
  static bool sized[64];  // the shared-memory limit raised, once per device
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(qmv_kernel<BITS, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MV_SMEM_MAX);
    if (err != cudaSuccess) return err;
    sized[dev] = true;
  }
  const dim3 grid(persistent ? 2 * sms : tiles, pairs);
  qmv_kernel<BITS, G><<<grid, MV_THREADS, smem, st>>>(
      x, q, s, b, y, M, K, N, lrt, lnc, experts, rows, E);
  return cudaGetLastError();
}

}  // namespace

// The GEMV route (1 <= M <= 8, both widths): x [M, K] bf16 (16-byte
// aligned); q [N, K*bits/8] u8 (8-byte aligned rows); scales and biases
// [N, K/group_size] bf16 (4-byte aligned); y [M, N] bf16.  bits in {4, 8};
// group_size in {32, 64, 128}; K a multiple of the K unit, max(group bytes,
// 32) of codes (8-bit: a group; 4-bit: a group pair at g = 32); row_tiles
// in {1, 2, 4, 8} and chunks a power of two, at most the K units, from the
// plan (ops/qmatmul.py:qmatmul_gemv_plan).
extern "C" int mvt_qmatmul_gemv(const void* x, const void* q,
                                const void* scales, const void* biases,
                                void* y, int M, int K, int N, int bits,
                                int group_size, int row_tiles, int chunks,
                                void* stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* bp = static_cast<const __nv_bfloat16*>(biases);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group_size;
  if ((bits != 4 && bits != 8) || (g != 32 && g != 64 && g != 128))
    return (int)cudaErrorInvalidValue;
  const int gb = g * bits / 8;
  const int unit = (gb > MV_STEP ? gb : MV_STEP) * 8 / bits;  // codes
  if (M < 1 || M > 8 || N < 1 || K < 1 || K % unit ||
      row_tiles < 1 || row_tiles > 8 || (row_tiles & (row_tiles - 1)) ||
      chunks < 1 || (chunks & (chunks - 1)) || chunks > K / unit)
    return (int)cudaErrorInvalidValue;
  const int lrt = __builtin_ctz(row_tiles), lnc = __builtin_ctz(chunks);
#define MVT_QMV(B, G)                                                     \
  if (bits == B && g == G)                                                \
    return (int)launch_qmv<B, G>(xp, qp, sp, bp, yp, M, K, N, lrt, lnc, st);
  MVT_QMV(4, 32) MVT_QMV(4, 64) MVT_QMV(4, 128)
  MVT_QMV(8, 32) MVT_QMV(8, 64) MVT_QMV(8, 128)
#undef MVT_QMV
  return (int)cudaErrorInvalidValue;
}

// The expert-indexed GEMV (the experts of a mixture-of-experts layer at
// decode): y [pairs, N] bf16, y[p] = x[rows[p]] @ dequant(W[experts[p]])^T.
// x [R, K] bf16 (16-byte aligned); q [E, N, K*bits/8] u8; scales and biases
// [E, N, K/group_size] bf16 (4-byte aligned, N * K / group_size even, so
// that every expert's values start on a 32-bit word); experts and rows
// int32 [pairs] on the device (rows null: x row p), read by the kernel.
// One launch: the GEMV's grid of row tiles for one x row, times the pairs.
// bits, group_size, K, row_tiles and chunks as mvt_qmatmul_gemv takes them
// at M = 1 (ops/qmatmul.py:qmatmul_gemv_plan(1, ...)).
extern "C" int mvt_qmatmul_gemv_experts(const void* x, const void* q,
                                        const void* scales,
                                        const void* biases, void* y,
                                        const void* experts, const void* rows,
                                        int pairs, int E, int K, int N,
                                        int bits, int group_size,
                                        int row_tiles, int chunks,
                                        void* stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* bp = static_cast<const __nv_bfloat16*>(biases);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const auto* ep = static_cast<const int*>(experts);
  const auto* rp = static_cast<const int*>(rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group_size;
  if ((bits != 4 && bits != 8) || (g != 32 && g != 64 && g != 128) || !ep)
    return (int)cudaErrorInvalidValue;
  const int gb = g * bits / 8;
  const int unit = (gb > MV_STEP ? gb : MV_STEP) * 8 / bits;  // codes
  if (pairs < 1 || pairs > 65535 || E < 1 || N < 1 || K < 1 || K % unit ||
      ((long long)N * (K / g)) % 2 || row_tiles < 1 || row_tiles > 8 ||
      (row_tiles & (row_tiles - 1)) || chunks < 1 ||
      (chunks & (chunks - 1)) || chunks > K / unit)
    return (int)cudaErrorInvalidValue;
  const int lrt = __builtin_ctz(row_tiles), lnc = __builtin_ctz(chunks);
#define MVT_QMVE(B, G)                                                   \
  if (bits == B && g == G)                                               \
    return (int)launch_qmv<B, G>(xp, qp, sp, bp, yp, 1, K, N, lrt, lnc, st, \
                                 ep, rp, E, pairs);
  MVT_QMVE(4, 32) MVT_QMVE(4, 64) MVT_QMVE(4, 128)
  MVT_QMVE(8, 32) MVT_QMVE(8, 64) MVT_QMVE(8, 128)
#undef MVT_QMVE
  return (int)cudaErrorInvalidValue;
}

// The GEMM route (M > 8, both widths): x [M, K] bf16, q [N, K * bits / 8]
// u8, scales and biases [N, K/g] bf16, y [M, N] bf16, part [splits, M, N]
// f32 scratch when splits > 1.  g in {32, 64, 128}; K a multiple of 2 g at
// 4 bits, of g at 8; bm 64 or 128, splits at most the units of max(g, 64)
// codes (a trailing half stage counted as one); x and q 16-byte aligned,
// scales and biases 4-byte aligned.  The wrapper's plan
// (ops/qmatmul.py:qmatmul_plan) picks bm and splits.
extern "C" int mvt_qmatmul_gemm(const void* x, const void* q,
                                const void* scales, const void* biases,
                                void* y, void* part, int M, int K, int N,
                                int bits, int group_size, int bm, int splits,
                                void* stream) {
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* bp = static_cast<const __nv_bfloat16*>(biases);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group_size, unit = g > QG_BK ? g : QG_BK;
  const int units = (K + unit - 1) / unit;
  if (M <= 0 || N <= 0 || (g != 32 && g != 64 && g != 128) || K <= 0 ||
      K % (bits == 4 ? 2 * g : g) || splits < 1 || splits > units ||
      (splits > 1 && !part) ||
      (unsigned long long)units * splits * splits >= (1ULL << 32))
    return (int)cudaErrorInvalidValue;
#define MVT_QMM(B, BM_, GT)                                               \
  if (bits == B && bm == BM_ && (GT == 0 || g == GT))                     \
    return (int)launch_qmm<B, BM_, GT>(x, q, sp, bp, yp, pp, M, K, N, g,  \
                                       splits, st);
  MVT_QMM(4, 64, 0) MVT_QMM(4, 128, 0) MVT_QMM(8, 128, 0)
  MVT_QMM(8, 64, 32) MVT_QMM(8, 64, 64) MVT_QMM(8, 64, 128)
#undef MVT_QMM
  return (int)cudaErrorInvalidValue;
}
