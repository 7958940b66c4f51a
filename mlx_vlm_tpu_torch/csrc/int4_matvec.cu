// K2: grouped-int4 GEMV for M <= 8 rows (decode linears, prefill lm_head).
//
// Replaces mlx_vlm_tpu/ops/int4_matvec.py:_int4_matvec (Pallas kernel _kern).
// y[m, :] = x[m, :] @ dequant(W), W in the halves-packed Int4GroupedTensor
// layout: qp [K, N2p] uint8, the low nibble of byte (k, j) is column j and
// the high nibble column N2p + j; sl/sh/bl/bh [G, N2p] f32 are the per
// (K-group, column) affine scales and biases of the two planes.  x is f32,
// the dequantized weight is f32 (code * s + b), the output is f32.
//
// Bound on the H100: device-memory bandwidth.  Every weight byte is used
// once per row of x, so a decode step reads the whole packed model.
// Design: each thread streams 16 consecutive bytes of a qp row per load
// (16-byte loads, 8 threads of a warp cover 128 contiguous bytes) for 16 rows
// of one K-group, keeping that group's 64 scale values in registers.  A block
// owns 128 packed columns (256 outputs) and a 512-row slice of K, so even the
// narrow projections launch hundreds of blocks; the 32 K-lanes of a block
// reduce in shared memory and the slices are summed by a second small kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 16;                 // packed columns per thread (16 bytes)
constexpr int TX = 8;                   // column vectors per block
constexpr int TY = 32;                  // K lanes per block
constexpr int ROWS = 16;                // K rows per lane
constexpr int STRIP = TX * VEC;         // 128 packed columns per block
constexpr int KSLICE = TY * ROWS;       // 512 rows of K per block
constexpr int RED_STRIDE = 2 * STRIP + 8;  // padded: conflict-free stores

__global__ void __launch_bounds__(TX * TY)
int4_matvec_partial(const float* __restrict__ x,
                    const uint8_t* __restrict__ qp,
                    const float* __restrict__ sl, const float* __restrict__ sh,
                    const float* __restrict__ bl, const float* __restrict__ bh,
                    float* __restrict__ part, int M, int K, int N2p,
                    int group_size) {
  __shared__ float red[TY * RED_STRIDE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m = blockIdx.z;
  const int col0 = blockIdx.x * STRIP + tx * VEC;
  const int row0 = blockIdx.y * KSLICE + ty * ROWS;

  float lo[VEC], hi[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) lo[i] = hi[i] = 0.f;

  // K and group_size are multiples of ROWS, so a lane's rows are all in
  // range and all in one group
  if (row0 < K) {
    const size_t so = (size_t)(row0 / group_size) * N2p + col0;
    float s_lo[VEC], s_hi[VEC], b_lo[VEC], b_hi[VEC];
#pragma unroll
    for (int v = 0; v < VEC / 4; ++v) {
      const float4 a = reinterpret_cast<const float4*>(sl + so)[v];
      const float4 b = reinterpret_cast<const float4*>(sh + so)[v];
      const float4 c = reinterpret_cast<const float4*>(bl + so)[v];
      const float4 d = reinterpret_cast<const float4*>(bh + so)[v];
      s_lo[4 * v] = a.x; s_lo[4 * v + 1] = a.y; s_lo[4 * v + 2] = a.z; s_lo[4 * v + 3] = a.w;
      s_hi[4 * v] = b.x; s_hi[4 * v + 1] = b.y; s_hi[4 * v + 2] = b.z; s_hi[4 * v + 3] = b.w;
      b_lo[4 * v] = c.x; b_lo[4 * v + 1] = c.y; b_lo[4 * v + 2] = c.z; b_lo[4 * v + 3] = c.w;
      b_hi[4 * v] = d.x; b_hi[4 * v + 1] = d.y; b_hi[4 * v + 2] = d.z; b_hi[4 * v + 3] = d.w;
    }
    const float* xr = x + (size_t)m * K + row0;
    const uint8_t* qr = qp + (size_t)row0 * N2p + col0;
#pragma unroll 4
    for (int r = 0; r < ROWS; ++r) {
      const float xv = xr[r];
      const uint4 q = *reinterpret_cast<const uint4*>(qr + (size_t)r * N2p);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const uint32_t byte = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
        const float wl = (float)(byte & 0xFu) * s_lo[i] + b_lo[i];
        const float wh = (float)(byte >> 4) * s_hi[i] + b_hi[i];
        lo[i] = fmaf(xv, wl, lo[i]);
        hi[i] = fmaf(xv, wh, hi[i]);
      }
    }
  }

  // slot p = i * TX + tx holds packed column tx * VEC + i of the strip
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[ty * RED_STRIDE + i * TX + tx] = lo[i];
    red[ty * RED_STRIDE + STRIP + i * TX + tx] = hi[i];
  }
  __syncthreads();
  const int t = ty * TX + tx;  // 0 .. 2 * STRIP - 1
  const int half = t / STRIP, p = t % STRIP;
  float s = 0.f;
#pragma unroll 8
  for (int y = 0; y < TY; ++y) s += red[y * RED_STRIDE + half * STRIP + p];
  const int col = blockIdx.x * STRIP + (p % TX) * VEC + p / TX + half * N2p;
  part[((size_t)blockIdx.y * M + m) * (2 * (size_t)N2p) + col] = s;
}

// y[m, c] = sum over K slices of part[slice, m, c] for c < n: output column c
// is plane entry c of the [lo | hi] partial row, so no index remap is needed
__global__ void int4_matvec_reduce(const float* __restrict__ part,
                                   float* __restrict__ y, int slices, int M,
                                   int N2p, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * n) return;
  const int m = idx / n, c = idx % n;
  float s = 0.f;
  for (int k = 0; k < slices; ++k)
    s += part[((size_t)k * M + m) * (2 * (size_t)N2p) + c];
  y[idx] = s;
}

}  // namespace

extern "C" int mvt_int4_matvec_slices(int K) { return (K + KSLICE - 1) / KSLICE; }

// x [M, K] f32; qp [K, N2p] u8; s/b planes [G, N2p] f32; part scratch
// [slices, M, 2 * N2p] f32; y [M, n] f32.  N2p % 128 == 0, K % group == 0,
// group % 16 == 0.
extern "C" int mvt_int4_matvec(const void* x, const void* qp, const void* sl,
                               const void* sh, const void* bl, const void* bh,
                               void* part, void* y, int M, int K, int N2p,
                               int n, int group_size, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slices = mvt_int4_matvec_slices(K);
  dim3 grid(N2p / STRIP, slices, M), block(TX, TY);
  int4_matvec_partial<<<grid, block, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(qp),
      static_cast<const float*>(sl), static_cast<const float*>(sh),
      static_cast<const float*>(bl), static_cast<const float*>(bh),
      static_cast<float*>(part), M, K, N2p, group_size);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = M * n;
  int4_matvec_reduce<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(y), slices, M, N2p,
      n);
  return (int)cudaGetLastError();
}

extern "C" const char* mvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
