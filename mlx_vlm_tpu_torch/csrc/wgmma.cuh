// Shared by the kernels that run `wgmma` on bf16 tiles in shared memory
// (K1 int4_matmul.cu, K5's int4 GEMM in qmatmul.cu, K4 flash_attention.cu):
// the fence / commit / wait helpers, a register fence, the shared-memory
// descriptors of 128-byte-swizzled tiles (K-major, and MN-major for a B
// whose N is contiguous), the m64n{64,128,256}k16 wrappers with A from
// registers, m64n128k16 with A from shared memory, and the ordered second
// pass of a split-K call.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int N>
struct Acc {
  float v[N / 2];
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep a register's value where it is across the asynchronous wgmma.
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r));
}
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r));
}

// Shared-memory matrix descriptor of a K-major bf16 tile with 128-byte rows
// and the 128-byte swizzle: 8-row core groups 1024 bytes apart.
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of an MN-major bf16 tile with the 128-byte swizzle, the layout
// TMA writes for rows of 64 contiguous N values: 8-row K groups 1024 bytes
// apart, the next 64 N values `lbo` bytes on.  wgmma reads it as B with the
// transpose-B bit set.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A . B for one 16-k slice: A [64 x 16] bf16 from registers (the
// mma.sync m16n8k16 A fragment per warp), B the K-major tile at `desc`
// (or, at m64n128 with TRANS_B = 1, the MN-major tile of mn_desc).
// scale_d = 0 overwrites d with the product, 1 adds to it.
__device__ __forceinline__ void wgmma_rs(Acc<64>& d, const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]), "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15]),
        "+f"(d.v[16]), "+f"(d.v[17]), "+f"(d.v[18]), "+f"(d.v[19]), "+f"(d.v[20]), "+f"(d.v[21]), "+f"(d.v[22]), "+f"(d.v[23]),
        "+f"(d.v[24]), "+f"(d.v[25]), "+f"(d.v[26]), "+f"(d.v[27]), "+f"(d.v[28]), "+f"(d.v[29]), "+f"(d.v[30]), "+f"(d.v[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_rs(Acc<128>& d, const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]), "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15]),
        "+f"(d.v[16]), "+f"(d.v[17]), "+f"(d.v[18]), "+f"(d.v[19]), "+f"(d.v[20]), "+f"(d.v[21]), "+f"(d.v[22]), "+f"(d.v[23]),
        "+f"(d.v[24]), "+f"(d.v[25]), "+f"(d.v[26]), "+f"(d.v[27]), "+f"(d.v[28]), "+f"(d.v[29]), "+f"(d.v[30]), "+f"(d.v[31]),
        "+f"(d.v[32]), "+f"(d.v[33]), "+f"(d.v[34]), "+f"(d.v[35]), "+f"(d.v[36]), "+f"(d.v[37]), "+f"(d.v[38]), "+f"(d.v[39]),
        "+f"(d.v[40]), "+f"(d.v[41]), "+f"(d.v[42]), "+f"(d.v[43]), "+f"(d.v[44]), "+f"(d.v[45]), "+f"(d.v[46]), "+f"(d.v[47]),
        "+f"(d.v[48]), "+f"(d.v[49]), "+f"(d.v[50]), "+f"(d.v[51]), "+f"(d.v[52]), "+f"(d.v[53]), "+f"(d.v[54]), "+f"(d.v[55]),
        "+f"(d.v[56]), "+f"(d.v[57]), "+f"(d.v[58]), "+f"(d.v[59]), "+f"(d.v[60]), "+f"(d.v[61]), "+f"(d.v[62]), "+f"(d.v[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_rs(Acc<256>& d, const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]), "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15]),
        "+f"(d.v[16]), "+f"(d.v[17]), "+f"(d.v[18]), "+f"(d.v[19]), "+f"(d.v[20]), "+f"(d.v[21]), "+f"(d.v[22]), "+f"(d.v[23]),
        "+f"(d.v[24]), "+f"(d.v[25]), "+f"(d.v[26]), "+f"(d.v[27]), "+f"(d.v[28]), "+f"(d.v[29]), "+f"(d.v[30]), "+f"(d.v[31]),
        "+f"(d.v[32]), "+f"(d.v[33]), "+f"(d.v[34]), "+f"(d.v[35]), "+f"(d.v[36]), "+f"(d.v[37]), "+f"(d.v[38]), "+f"(d.v[39]),
        "+f"(d.v[40]), "+f"(d.v[41]), "+f"(d.v[42]), "+f"(d.v[43]), "+f"(d.v[44]), "+f"(d.v[45]), "+f"(d.v[46]), "+f"(d.v[47]),
        "+f"(d.v[48]), "+f"(d.v[49]), "+f"(d.v[50]), "+f"(d.v[51]), "+f"(d.v[52]), "+f"(d.v[53]), "+f"(d.v[54]), "+f"(d.v[55]),
        "+f"(d.v[56]), "+f"(d.v[57]), "+f"(d.v[58]), "+f"(d.v[59]), "+f"(d.v[60]), "+f"(d.v[61]), "+f"(d.v[62]), "+f"(d.v[63]),
        "+f"(d.v[64]), "+f"(d.v[65]), "+f"(d.v[66]), "+f"(d.v[67]), "+f"(d.v[68]), "+f"(d.v[69]), "+f"(d.v[70]), "+f"(d.v[71]),
        "+f"(d.v[72]), "+f"(d.v[73]), "+f"(d.v[74]), "+f"(d.v[75]), "+f"(d.v[76]), "+f"(d.v[77]), "+f"(d.v[78]), "+f"(d.v[79]),
        "+f"(d.v[80]), "+f"(d.v[81]), "+f"(d.v[82]), "+f"(d.v[83]), "+f"(d.v[84]), "+f"(d.v[85]), "+f"(d.v[86]), "+f"(d.v[87]),
        "+f"(d.v[88]), "+f"(d.v[89]), "+f"(d.v[90]), "+f"(d.v[91]), "+f"(d.v[92]), "+f"(d.v[93]), "+f"(d.v[94]), "+f"(d.v[95]),
        "+f"(d.v[96]), "+f"(d.v[97]), "+f"(d.v[98]), "+f"(d.v[99]), "+f"(d.v[100]), "+f"(d.v[101]), "+f"(d.v[102]), "+f"(d.v[103]),
        "+f"(d.v[104]), "+f"(d.v[105]), "+f"(d.v[106]), "+f"(d.v[107]), "+f"(d.v[108]), "+f"(d.v[109]), "+f"(d.v[110]), "+f"(d.v[111]),
        "+f"(d.v[112]), "+f"(d.v[113]), "+f"(d.v[114]), "+f"(d.v[115]), "+f"(d.v[116]), "+f"(d.v[117]), "+f"(d.v[118]), "+f"(d.v[119]),
        "+f"(d.v[120]), "+f"(d.v[121]), "+f"(d.v[122]), "+f"(d.v[123]), "+f"(d.v[124]), "+f"(d.v[125]), "+f"(d.v[126]), "+f"(d.v[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (+)= A . B for one 16-k slice with both operands in shared memory: A
// [64 x 16] and B [128 x 16], each a K-major tile at its x_desc.
__device__ __forceinline__ void wgmma_ss(Acc<128>& d, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]), "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15]),
        "+f"(d.v[16]), "+f"(d.v[17]), "+f"(d.v[18]), "+f"(d.v[19]), "+f"(d.v[20]), "+f"(d.v[21]), "+f"(d.v[22]), "+f"(d.v[23]),
        "+f"(d.v[24]), "+f"(d.v[25]), "+f"(d.v[26]), "+f"(d.v[27]), "+f"(d.v[28]), "+f"(d.v[29]), "+f"(d.v[30]), "+f"(d.v[31]),
        "+f"(d.v[32]), "+f"(d.v[33]), "+f"(d.v[34]), "+f"(d.v[35]), "+f"(d.v[36]), "+f"(d.v[37]), "+f"(d.v[38]), "+f"(d.v[39]),
        "+f"(d.v[40]), "+f"(d.v[41]), "+f"(d.v[42]), "+f"(d.v[43]), "+f"(d.v[44]), "+f"(d.v[45]), "+f"(d.v[46]), "+f"(d.v[47]),
        "+f"(d.v[48]), "+f"(d.v[49]), "+f"(d.v[50]), "+f"(d.v[51]), "+f"(d.v[52]), "+f"(d.v[53]), "+f"(d.v[54]), "+f"(d.v[55]),
        "+f"(d.v[56]), "+f"(d.v[57]), "+f"(d.v[58]), "+f"(d.v[59]), "+f"(d.v[60]), "+f"(d.v[61]), "+f"(d.v[62]), "+f"(d.v[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Second pass of a split-K call: y = bf16(sum over the splits of part
// [splits, total] f32), the splits summed in order, so the result does not
// depend on which block finished first.
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ part,
                   __nv_bfloat16* __restrict__ y, long long total,
                   int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  // float4 rows of every split stay 16-byte aligned only when 4 | total
  const long long quads = total % 4 == 0 ? total / 4 : 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    float4 acc = reinterpret_cast<const float4*>(part)[i];
    for (int z = 1; z < splits; ++z) {
      const float4 v = reinterpret_cast<const float4*>(part + z * total)[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y + 4 * i);
    out[0] = __floats2bfloat162_rn(acc.x, acc.y);
    out[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
  for (long long i = 4 * quads + blockIdx.x * (long long)blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    float acc = part[i];
    for (int z = 1; z < splits; ++z) acc += part[z * total + i];
    y[i] = __float2bfloat16_rn(acc);
  }
}

}  // namespace
