// K6: decode attention over a per-token-affine 4-bit KV cache.
//
// Replaces mlx_vlm_tpu/ops/int4_kv_attention.py:int4_kv_decode_attention
// (Pallas kernel _kernel).  For each (row, KV head) bh, its g query rows
// arrive as int8 codes q8 [BH, g, D] with (sum q8, qs) in qmeta [BH, g, 2];
// the cache holds codes k4/v4 [BH, C, D/2] (dims [0, D/2) in the low nibble,
// [D/2, D) in the high one) and per-token f32 scale/bias ks, kb, vs, vb
// [BH, C].  Column c is visible when left_pad <= c < offset.  Then
//   score_c = qs * (ks_c * (q8 . k4_c) + kb_c * sum(q8)) * scale,
//   out = (sum_c bf16(p_c * vs_c) * v4_c + sum_c p_c * vb_c) / max(sum p, 1e-30)
// with p = exp(score - max) -- the reference's contract.  A row that sees
// nothing gets 0.
//
// What bounds it on the H100: device-memory bytes.  A visible token costs
// D/2 key and D/2 value code bytes and four f32 scales per KV head (144
// bytes at D = 128), read once, against ~4 g D operations.  A call at 8.5k
// tokens and 4 KV heads reads ~4.9 MB, 1.5 us at 3.35 TB/s; the launch, the
// first bytes' latency and the cross-block combine stand above that.  The
// design is K7 / K8's (tq_kv_attention.cu), on K6's simpler codes:
//
// - One launch per call.  A block owns T consecutive tokens (a split) of
//   one KV head and its query rows; T, the warps, the combiners and the
//   shared-memory layout come from ops/int4_kv_attention.py:
//   int4_kv_attention_plan, which mirrors `kv4_layout` here (the launch
//   refuses a plan whose bytes differ).  The grid is sized from the
//   capacity C, about SMs / heads splits a head, so a CUDA graph replays at
//   any offset; on the card a head's splits cover [0, min(C, offset)) in
//   whole 16-token tiles, so a short history still spreads over the grid.
//   One live split writes the output itself; else the last K blocks of a
//   head combine the live splits in a fixed order (kv_decode_common.cuh's
//   `finish_split`, shared with K7 / K8, as are the per-card counters).
// - Bytes before arithmetic.  In the [BH, C, D/2] layout a split's tokens
//   are one contiguous run of each of k4, ks, kb, vs, vb and v4.  One
//   thread starts a `cp.async.bulk` for every run at the block's start:
//   the keys, all four scale runs, the query codes and their (sum, qs) on
//   one mbarrier, the value codes on a second, so the scores and the
//   softmax (which needs vs and vb) run while the value codes still
//   arrive.  Unaligned run ends (a capacity that is not a multiple of 4
//   leaves the f32 runs unaligned) are copied by threads.  No compute loop
//   reads device memory: ~39 KB a block at C = 8704, 4 heads.
// - Keys exact on `mma.sync.m16n8k32` (s8 operands, s32 sums): the
//   reference's own two int8 dots.  A is 16 tokens x 32 k-slots, B the
//   query codes with a KV head's g <= 8 rows on n (zero rows to 8; a
//   second n-tile up to 16, past that row groups).  K-step st takes code
//   bytes 16 st .. 16 st + 15 of a token: lane (gid, tig) loads word
//   4 st + tig of tokens gid and gid + 8, and `x & 0x0F0F0F0F` gives its
//   slots 4 tig .. 4 tig + 3 (dims 16 st + 4 tig ..), `(x >> 4) &
//   0x0F0F0F0F` its slots 16 + 4 tig .. (dims D/2 + 16 st + 4 tig ..).
//   The query fragments are laid out once per block in that slot order,
//   zero past D/2 (a D/2 that is not a multiple of 16 pads its last
//   k-step).  Each s32 score becomes f32 once and takes ks, kb, sum q8, qs
//   and scale in f32 in the plain version's order; invisible tokens are
//   masked by select (-inf), so NaN or huge scales past the cursor cannot
//   leak.
// - Values on bf16 `mma.sync.m16n8k16`, K7's roles: A is the codes (16
//   dims x 16 tokens), B is bf16(p * vs) (16 tokens x 8 rows).  A group of
//   four m-tiles covers 32 code bytes: m-tile k of group grp gives m-slot
//   gid the low nibble of byte 32 grp + 4 gid + k (dim b) and m-slot
//   gid + 8 its high nibble (dim D/2 + b), so lane (gid, tig) loads one
//   word of each of its four tokens 4 tig .. 4 tig + 3 and builds all four
//   m-tiles from registers: `prmt` puts byte k of two tokens in the two
//   halves, a mask-and-or with 0x43004300 makes bf16(128 + q) of the low
//   nibbles (the high ones after a shift by 4), and one bf16x2 subtract of
//   128 leaves q exactly.  Taken over folding -128 * sum bf16(p * vs) per
//   row (K2's route): every product is then exact, so only the order of
//   the f32 sums differs from the plain version, for one subtract per
//   register.  The rank-1 term sum p * vb stays f32, in the softmax,
//   and is added to the split's sums before they are written.
// - The softmax of a row (max, p, sum p, bf16(p * vs), sum p * vb) is one
//   warp's, with no block barrier inside.  Each warp takes whole tiles of
//   the scores and of the values (its partial sums of every dim, summed in
//   warp order); a block with fewer tiles than warps splits the values by
//   output m-tile instead.  Tried on the card and dropped: each warp taking
//   the softmax of its own score tiles against the split's maximum (the
//   warps' row maxima merged through shared memory) was no faster; nor
//   were two blocks per SM or fewer, longer splits (chip_smoke.py's
//   `time_k6` under other plans): shorter splits add partials to combine,
//   longer ones lengthen every block.
// - Left from the TPU kernel: its grid order and its M_ROWS = 8 padding.
// - Dropped here without a chip run: the query as A and the keys as B
//   (n = 8 tokens would halve the tokens an mma takes), and K7's value
//   slots (a group of 4 m-tiles reads one word a token here, where
//   K7's bit planes need a load per plane).

#include "kv_decode_common.cuh"

namespace {

constexpr int TILE = 16;          // tokens of one mma tile
constexpr int MAX_NT = 2;         // n-tiles of 8 query rows per block
constexpr int MAX_WARPS = 12;     // warps per block (8 at two n-tiles)
constexpr int ARRAY_SLACK = 48;   // misalignment (< 16) and 28 bytes read past
constexpr int MAX_COMBINERS = 8;  // last blocks of a head that combine
constexpr int KEY_BYTES = 16;     // code bytes of a token per key k-step
constexpr int GROUP_BYTES = 32;   // code bytes of a token per value group

struct Kv4Args {
  const int8_t* q8;     // [BH, G, D] query codes
  const float* qmeta;   // [BH, G, 2]: sum(q8), qs
  const uint8_t* k4;    // [BH, C, D/2]
  const float* ks;      // [BH, C]
  const float* kb;
  const float* vs;
  const float* vb;
  const uint8_t* v4;    // [BH, C, D/2]
  const int* offset;    // [BH]
  const int* left_pad;  // [BH]
  SplitOut o;
  int C, T;
  float scale;
};

__host__ __device__ constexpr int key_steps(int D) {
  return (D / 2 + KEY_BYTES - 1) / KEY_BYTES;
}

__host__ __device__ constexpr int value_groups(int D) {
  return (D / 2 + GROUP_BYTES - 1) / GROUP_BYTES;
}

// Dynamic shared memory of a block, in bytes from its 16-byte aligned base
// (ops/int4_kv_attention.py:_smem_bytes mirrors it).
struct Kv4Layout {
  int qraw;    // staged query codes [8 nt][D]
  int meta;    // staged (sum q8, qs) [8 nt][2]
  int qf;      // [nt][k-step][lane] 2 x 4 s8: query fragments
  int S;       // [8 nt][T] f32 scores
  int pv;      // [8 nt][T] bf16(p * vs)
  int ml;      // [8 nt][2] f32 this split's max and sum of p
  int bias;    // [8 nt] f32 this split's sum of p * vb
  int part;    // [8 nt][D] f32 this split's sums
  int red;     // [warps][8 nt][D] f32 each warp's share of part
  int arr[6];  // k4, ks, kb, vs, vb, v4 staging regions
  int bytes;
};

__host__ __device__ inline Kv4Layout kv4_layout(int T, int D, int nt,
                                                int warps) {
  Kv4Layout L;
  const int rows = 8 * nt, h = D / 2;
  int o = 0;
  L.qraw = o;
  o += align16(rows * D + ARRAY_SLACK);
  L.meta = o;
  o += align16(rows * 2 * 4 + ARRAY_SLACK);
  L.qf = o;
  o += nt * key_steps(D) * 32 * 8;
  L.S = o;
  o += rows * T * 4;
  L.pv = o;
  o += rows * T * 2;
  L.ml = o;
  o += align16(rows * 2 * 4);
  L.bias = o;
  o += align16(rows * 4);
  L.part = o;
  o += rows * D * 4;
  L.red = o;
  o += warps * rows * D * 4;
  const int widths[6] = {h, 4, 4, 4, 4, h};
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    L.arr[j] = o;
    o += align16(T * widths[j] + ARRAY_SLACK);
  }
  L.bytes = o;
  return L;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The nibbles at bits 0-3 and 16-19 of t as a bf16 pair, exactly: the mask
// and or make 128 + q, the subtract leaves q.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t t) {
  uint32_t x = (t & 0x000F000Fu) | 0x43004300u;
  asm("sub.rn.bf16x2 %0, %0, %1;\n" : "+r"(x) : "r"(0x43004300u));
  return x;
}

// One key k-step of a tile: code words w0 + 4 st (token gid) and w1 + 4 st
// (token gid + 8) against the query fragments of step st.
template <int NT>
__device__ __forceinline__ void key_step(int (&acc)[NT][4],
                                         const uint32_t* sw, int w0, int w1,
                                         const uint2* qf, int steps, int st,
                                         int lane) {
  const uint32_t x0 = sw[w0 + 4 * st], x1 = sw[w1 + 4 * st];
  const uint32_t A[4] = {x0 & 0x0F0F0F0Fu, x1 & 0x0F0F0F0Fu,
                         (x0 >> 4) & 0x0F0F0F0Fu, (x1 >> 4) & 0x0F0F0F0Fu};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint2 b = qf[(nt * steps + st) * 32 + lane];
    mma_s8(acc[nt], A, b.x, b.y);
  }
}

// Scores of the warp's tiles (tfirst + warp, + W, ...) into S [8 NT][T]:
// the exact integer dot, then the plain version's f32 fold; -inf where
// invisible.
template <int NT>
__device__ __forceinline__ void scores(const uint8_t* sm, int codes, int h,
                                       const float* ks, const float* kb,
                                       const float* meta, const uint2* qf,
                                       int steps, float* S, int T, int t0,
                                       int lo, int hi, int R, float scale,
                                       int tfirst, int tlast, int W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  // (sum q8, qs) of this lane's rows nt * 8 + 2 tig + e
  float qsum[NT][2], qsc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = nt * 8 + 2 * tig + e;
      qsum[nt][e] = row < R ? meta[2 * row] : 0.f;
      qsc[nt][e] = row < R ? meta[2 * row + 1] : 0.f;
    }
  for (int tile = tfirst + warp; tile < tlast; tile += W) {
    const int tok = tile * TILE;
    const int w0 = (codes + (tok + gid) * h) / 4 + tig, w1 = w0 + 2 * h;
    // two accumulator chains (even and odd k-steps): integer sums, exact
    int acc[2][NT][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][nt][j] = 0;
    for (int st = 0; st < steps; st += 2) {
      key_step<NT>(acc[0], sw, w0, w1, qf, steps, st, lane);
      if (st + 1 < steps)
        key_step<NT>(acc[1], sw, w0, w1, qf, steps, st + 1, lane);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tok + gid + 8 * (j >> 1), c = t0 + t;
      const bool live = c >= lo && c < hi;
      const float k = ks[t], b = kb[t];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int e = j & 1, row = nt * 8 + 2 * tig + e;
        const float x = __fmul_rn(
            __fmul_rn(__fadd_rn(__fmul_rn((float)(acc[0][nt][j] +
                                                  acc[1][nt][j]),
                                          k),
                                __fmul_rn(qsum[nt][e], b)),
                      qsc[nt][e]),
            scale);
        if (row < R) S[row * T + t] = live ? x : -INFINITY;
      }
    }
  }
}

// KN value m-tiles of group grp (m-tiles 4 grp + k0 ..) over the tiles
// tbeg, tbeg + tstep, ... < tend, written to dst [8 NT][D] (each output
// once, dims past D/2 skipped).
template <int NT, int KN>
__device__ __forceinline__ void values(const uint8_t* sm, int codes, int h,
                                       const uint16_t* pv, int T, float* dst,
                                       int D, int grp, int k0, int tbeg,
                                       int tend, int tstep) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  const int b0 = grp * GROUP_BYTES + 4 * gid;  // this lane's word in a row
  float acc[KN][NT][4];
#pragma unroll
  for (int k = 0; k < KN; ++k)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][nt][j] = 0.f;
  for (int tile = tbeg; tile < tend; tile += tstep) {
    const int tok = tile * TILE;
    uint32_t B[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = *reinterpret_cast<const uint2*>(
          pv + (nt * 8 + gid) * T + tok + 4 * tig);
      B[nt][0] = b.x;
      B[nt][1] = b.y;
    }
    // tokens 4 tig + j (k-slots 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9)
    const int w = (codes + (tok + 4 * tig) * h + b0) / 4, hw = h / 4;
    const uint32_t x0 = sw[w], x1 = sw[w + hw], x2 = sw[w + 2 * hw],
                   x3 = sw[w + 3 * hw];
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      // byte k0 + k of two tokens in the two halves
      const uint32_t sel = 0x4400u + 0x1111u * (uint32_t)(k0 + k);
      const uint32_t t01 = prmt(x0, x1, sel), t23 = prmt(x2, x3, sel);
      const uint32_t A[4] = {nibbles_bf16(t01), nibbles_bf16(t01 >> 4),
                             nibbles_bf16(t23), nibbles_bf16(t23 >> 4)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[k][nt], A, B[nt][0], B[nt][1]);
    }
  }
#pragma unroll
  for (int k = 0; k < KN; ++k) {
    const int b = b0 + k0 + k;
    if (b >= h) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* row = dst + (nt * 8 + 2 * tig) * D;
      row[b] = acc[k][nt][0];
      row[D + b] = acc[k][nt][1];
      row[h + b] = acc[k][nt][2];
      row[D + h + b] = acc[k][nt][3];
    }
  }
}

// Grid (NS splits, BH KV heads, Z row groups).
template <int NT>
__global__ void __launch_bounds__(NT == 1 ? MAX_WARPS * 32 : 256, 1)
    kv4_attention_kernel(const __grid_constant__ Kv4Args a) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ __align__(8) uint64_t bars[2];  // keys, scales, q; values
  __shared__ int last;

  constexpr int RG = 8 * NT;
  const int s = blockIdx.x, bh = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x, W = nthreads >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int T = a.T, C = a.C, D = a.o.D, G = a.o.G, h = D / 2;
  const int row0 = z * RG, R = min(RG, G - row0);
  const int off = a.offset[bh], lp = a.left_pad[bh];
  // the split size follows the cursor: the NS splits of a head cover its
  // history [0, min(C, offset)) in whole tiles, at most T tokens each
  const int NS = a.o.NS, end = min(C, off);
  const int TS = min(T, max(TILE, (end + NS * TILE - 1) / (NS * TILE) * TILE));
  const int t0 = s * TS;
  const int lo = max(t0, lp), hi = min(min(t0 + TS, C), off);
  const Kv4Layout Ly = kv4_layout(T, D, NT, W);
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

    // staging runs: k4, ks, kb, vs, vb, the query codes and their (sum, qs)
    // on the first barrier, v4 on the second
    const void* arrays[6] = {a.k4, a.ks, a.kb, a.vs, a.vb, a.v4};
    const int widths[6] = {h, 4, 4, 4, 4, h};
    Run runs[6];
#pragma unroll
    for (int j = 0; j < 6; ++j)
      runs[j] = token_run(arrays[j], widths[j], bh, C, t0, ca, cb, Ly.arr[j]);
    const size_t qrow = (size_t)bh * G + row0;
    const Run qrun = span_run(a.q8 + qrow * D, R * D, Ly.qraw);
    const Run mrun = span_run(a.qmeta + qrow * 2, R * 2 * 4, Ly.meta);
    if (tid == 0) {
      uint32_t tx0 = run_bytes(qrun) + run_bytes(mrun);
#pragma unroll
      for (int j = 0; j < 5; ++j) tx0 += run_bytes(runs[j]);
      mbar_expect_tx(&bars[0], tx0);
      mbar_expect_tx(&bars[1], run_bytes(runs[5]));
      run_copy(sm, qrun, &bars[0]);
      run_copy(sm, mrun, &bars[0]);
#pragma unroll
      for (int j = 0; j < 6; ++j) run_copy(sm, runs[j], &bars[j == 5]);
    }
    run_ends(sm, qrun);
    run_ends(sm, mrun);
#pragma unroll
    for (int j = 0; j < 6; ++j) run_ends(sm, runs[j]);
    __syncthreads();
    mbar_wait(&bars[0], 0);

    // query fragments in the key slot order: b.x = slots 4 tig .. (dims
    // 16 st + 4 tig ..), b.y = slots 16 + 4 tig .. (dims h + 16 st +
    // 4 tig ..); zero past h and for rows past G.  Warp-strided over the
    // (n-tile, k-step) pairs.
    const int steps = key_steps(D);
    {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(sm + qrun.dst);
      uint2* qf = reinterpret_cast<uint2*>(sm + Ly.qf);
      for (int j = warp; j < NT * steps; j += W) {
        const int nt = j >= steps, st = j - nt * steps;
        const int row = nt * 8 + (lane >> 2);
        const int byte0 = st * KEY_BYTES + 4 * (lane & 3);
        uint2 b = make_uint2(0u, 0u);
        if (row < R && byte0 < h)
          b = make_uint2(q[(row * D + byte0) / 4], q[(row * D + h + byte0) / 4]);
        qf[j * 32 + lane] = b;
      }
    }
    __syncthreads();

    // ---- scores
    float* S = reinterpret_cast<float*>(sm + Ly.S);
    scores<NT>(sm, runs[0].base, h,
               reinterpret_cast<const float*>(sm + runs[1].base),
               reinterpret_cast<const float*>(sm + runs[2].base),
               reinterpret_cast<const float*>(sm + mrun.dst),
               reinterpret_cast<const uint2*>(sm + Ly.qf), steps, S, T, t0,
               lo, hi, R, a.scale, tfirst, tlast, W);
    __syncthreads();

    // ---- softmax over this split, a warp per row: the row's max over its
    // visible tokens, then p = exp(score - max), the sums of p and of
    // p * vb, and bf16(p * vs) for every staged token (0 where invisible)
    float* bias = reinterpret_cast<float*>(sm + Ly.bias);
    uint16_t* pv = reinterpret_cast<uint16_t*>(sm + Ly.pv);
    {
      const float* vs = reinterpret_cast<const float*>(sm + runs[3].base);
      const float* vb = reinterpret_cast<const float*>(sm + runs[4].base);
      const int i0 = tfirst * TILE, i1 = tlast * TILE;
      for (int r = warp; r < R; r += W) {
        const float* Sr = S + r * T;
        float mx = -INFINITY;
#pragma unroll 4
        for (int c = lo + lane; c < hi; c += 32) mx = fmaxf(mx, Sr[c - t0]);
        mx = warp_max(mx);
        float sum = 0.f, bsum = 0.f;
#pragma unroll 4
        for (int i = i0 + lane; i < i1; i += 32) {
          const int c = t0 + i;
          const bool live = c >= lo && c < hi;
          const float p = live ? expf(Sr[i] - mx) : 0.f;
          sum += p;
          bsum += live ? __fmul_rn(p, vb[i]) : 0.f;
          pv[r * T + i] = live ? bf16_bits(__fmul_rn(p, vs[i])) : (uint16_t)0;
        }
        sum = warp_sum(sum);
        bsum = warp_sum(bsum);
        if (lane == 0) {
          ml[2 * r] = mx;
          ml[2 * r + 1] = sum;
          bias[r] = bsum;
        }
      }
    }
    __syncthreads();

    // ---- values.  Few tiles: warp w takes the m-tiles w, w + W, ... (16
    // output dims each) over every tile, into part.  Else each warp takes
    // its tiles, all dims, into its red slice, and the slices are summed in
    // warp order into part.  Then part + sum p * vb.
    mbar_wait(&bars[1], 0);
    const int groups = value_groups(D);
    if (tlast - tfirst < W) {
      for (int mt = warp; mt < 4 * groups; mt += W)
        values<NT, 1>(sm, runs[5].base, h, pv, T, part, D, mt >> 2, mt & 3,
                      tfirst, tlast, 1);
      __syncthreads();
      for (int idx = tid; idx < R * D; idx += nthreads)
        part[idx] = __fadd_rn(part[idx], bias[idx / D]);
    } else {
      float* red = reinterpret_cast<float*>(sm + Ly.red);
      for (int grp = 0; grp < groups; ++grp)
        values<NT, 4>(sm, runs[5].base, h, pv, T, red + warp * RG * D, D,
                      grp, 0, tfirst + warp, tlast, W);
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
        const float b = bias[idx * 4 / D];
        reinterpret_cast<float4*>(part)[idx] =
            make_float4(__fadd_rn(acc.x, b), __fadd_rn(acc.y, b),
                        __fadd_rn(acc.z, b), __fadd_rn(acc.w, b));
      }
    }
    __syncthreads();
  }

  finish_split(a.o, part, ml, last, s, bh, z, row0, R, lo, hi, lp, end, TS);
}

template <int NT>
cudaError_t launch(const Kv4Args& a, int warps, int smem, cudaStream_t st) {
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kv4_attention_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  kv4_attention_kernel<NT>
      <<<dim3(a.o.NS, a.o.BH, a.o.Z), warps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q8 int8 [BH, G, D]; qmeta f32 [BH, G, 2]; k4/v4 u8 [BH, C, D/2] (q8, k4
// and v4 4-byte aligned); ks, kb, vs, vb f32 [BH, C]; offset, left_pad int32 [BH];
// scratch part_ml f32 [NS, BH, G, 2] and part_acc f32 [NS, BH, G, D] with
// NS = ceil(C / T); tickets u32 [BH * Z * 2], zero (and left zero); out f32
// [BH, G, D].  D a multiple of 8.  T (tokens a split, a multiple of 16),
// warps, combiners (1 to 8, at most NS, and so few that the waiting ones
// never hold every SM: at most SMs / (BH * Z)) and smem (the layout's
// bytes, checked here) come from
// ops/int4_kv_attention.py:int4_kv_attention_plan.  One launch.
extern "C" int mvt_int4_kv_attention(
    const void* q8, const void* qmeta, const void* k4, const void* ks,
    const void* kb, const void* v4, const void* vs, const void* vb,
    const void* offset, const void* left_pad, void* part_ml, void* part_acc,
    void* tickets, void* out, int BH, int G, int C, int D, int T, int warps,
    int combiners, int smem, float scale, void* stream) {
  const int nt = G <= 8 ? 1 : MAX_NT;
  if (BH < 1 || G < 1 || C < 1 || D < 8 || D % 8 || T < TILE || T % TILE ||
      warps < 1 || warps > (nt == 1 ? MAX_WARPS : 8) ||
      (reinterpret_cast<uintptr_t>(q8) & 3) ||
      (reinterpret_cast<uintptr_t>(k4) & 3) ||
      (reinterpret_cast<uintptr_t>(v4) & 3))
    return (int)cudaErrorInvalidValue;
  Kv4Args a;
  a.q8 = static_cast<const int8_t*>(q8);
  a.qmeta = static_cast<const float*>(qmeta);
  a.k4 = static_cast<const uint8_t*>(k4);
  a.ks = static_cast<const float*>(ks);
  a.kb = static_cast<const float*>(kb);
  a.vs = static_cast<const float*>(vs);
  a.vb = static_cast<const float*>(vb);
  a.v4 = static_cast<const uint8_t*>(v4);
  a.offset = static_cast<const int*>(offset);
  a.left_pad = static_cast<const int*>(left_pad);
  a.o.part_ml = static_cast<float*>(part_ml);
  a.o.part_acc = static_cast<float*>(part_acc);
  a.o.tickets = static_cast<unsigned*>(tickets);
  a.o.out = static_cast<float*>(out);
  a.o.BH = BH;
  a.o.G = G;
  a.o.D = D;
  a.o.NS = (C + T - 1) / T;
  a.o.Z = (G + 8 * nt - 1) / (8 * nt);
  a.o.K = combiners;
  a.C = C;
  a.T = T;
  a.scale = scale;
  if (combiners < 1 || combiners > MAX_COMBINERS || combiners > a.o.NS)
    return (int)cudaErrorInvalidValue;
  // the plan's shared-memory bytes must be this layout's
  if (kv4_layout(T, D, nt, warps).bytes != smem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(nt == 1 ? launch<1>(a, warps, smem, st)
                       : launch<2>(a, warps, smem, st));
}
