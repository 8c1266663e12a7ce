// Hopper (sm_90a) building blocks shared by the tensor-core kernels:
// flash attention's bf16 instantiation (flash_attention.cu), the SSD
// intra-chunk kernel's (ssd_scan.cu), the backwards of both
// (flash_attention_bwd.cu, ssd_scan_bwd.cu), the FCNN forward and dgrad
// kernels with bf16 weights (fcnn_fwd_tc.cu, fcnn_dgrad_tc.cu) and the
// FCNN wgrad kernel with bf16 data (fcnn_wgrad_tc.cu).
//   * wgmma wrappers: m64nNk16 bf16 products into fp32 accumulators, N =
//     16, 32, 64 or 128, A from shared memory (ss) or from registers (rs),
//     each operand K-major or MN-major as its template flags say;
//   * desc_sw128 / desc_sw32: the shared-memory descriptor of a 128-byte-
//     (32-byte-) swizzled tile;
//   * wg_fence / wg_commit / wg_wait_all and fence_regs around the
//     asynchronous products; fence_proxy_async between writes by threads to
//     shared memory and a product that reads them;
//   * mbarrier and TMA helpers, and pack_bf16 / split_pack for register A
//     fragments;
//   * encode_map (host): the 4-D tensor map over a (B, heads, S, D) view
//     that K6's forward and backward load their tiles through;
//   * the fp32 backwards of K6 and K7: mma.sync m16n8k8 TF32 products, each
//     fp32 operand split into TF32 hi + lo and a product taken as three
//     (3xTF32, mma_3xtf32), with the split helpers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// d (64 x 128, fp32) (+)= A (64 x 16) · B (16 x 128), both in shared
// memory; kTransA / kTransB = 1 for an MN-major operand, 0 (the default)
// for K-major; scale_d = 0 overwrites d
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 register fragments) ·
// B (16 x 64); kTransB = 1 (the default) for B MN-major in shared memory,
// 0 for K-major
template <int kTransB = 1>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(kTransB));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 register fragments) ·
// B (16 x 128); kTransB = 1 (the default) for B MN-major in shared memory,
// 0 for K-major
template <int kTransB = 1>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(kTransB));
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile whose
// 8-row groups are 1024 bytes apart (SBO); LBO is the stride between
// 64-column atoms of an MN-major operand (unused for K-major).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// the same for a 32-byte-swizzled tile (layout type 3), whose 8-row groups
// of 32-byte rows are 256 bytes apart: an MN-major operand 16 columns
// wide; LBO is the stride between 16-column atoms
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v = hi + lo: hi = bf16(v), lo = bf16(v − hi) (v − hi is exact in fp32),
// each pair packed with its lower column in the lower half
__device__ __forceinline__ void split_pack(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d (64 x 64, fp32) (+)= A (64 x 16) · B (16 x 64), both in shared
// memory; kTransA / kTransB = 1 for an MN-major operand, 0 for K-major;
// scale_d = 0 overwrites d
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64, fp32) = A (64 x 16) · B (16 x 64), both in shared memory:
// the first k16 step of a product, which writes d without reading it, so
// d's old values die at their last use (a "+f" operand would keep them
// live up to the product); kTransA / kTransB as above
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n64k16_first(float (&d)[32], uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0), "n"(kTransA), "n"(kTransB));
}

// d (64 x 128, fp32) = A (64 x 16) · B (16 x 128), both in shared memory:
// the first k16 step of a product, as above
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n128k16_first(float (&d)[64], uint64_t desc_a,
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),
        "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0), "n"(kTransA), "n"(kTransB));
}

// d (64 x 32, fp32) (+)= A (64 x 16) · B (16 x 32), both in shared
// memory; kTransA / kTransB = 1 for an MN-major operand, 0 for K-major;
// scale_d = 0 overwrites d
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (64 x 16, fp32) (+)= A (64 x 16) · B (16 x 16), both in shared
// memory; kTransA / kTransB = 1 for an MN-major operand, 0 for K-major;
// scale_d = 0 overwrites d
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n16k16(float (&d)[8], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (64 x 16, fp32) += A (64 x 16, bf16 register fragments) · B (16 x 16);
// kTransB = 1 (the default) for B MN-major in shared memory, 0 for K-major
template <int kTransB = 1>
__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(kTransB));
}

// orders this thread's earlier writes to shared memory (st.shared,
// cp.async) before later reads by the async proxy (wgmma, TMA); a barrier
// must follow before another thread's product reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- fp32 products on the tensor cores as three TF32 products (3xTF32)
//
// v = hi + lo + r: hi = tf32(v), rounded to nearest (|v − hi| <= 2^-11·|v|;
// v − hi is exact in fp32, with at most 13 significant bits), lo = v − hi
// with its 13 low bits cleared (truncated to 11 significant bits: |r| <
// 2^-22·|v|).  a·b is taken as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b (the
// small terms first), each into the fp32 accumulator: the dropped
// lo_a·lo_b is at most 2^-22·|a·b|, so a product keeps about 22 of fp32's
// 24 bits, where one TF32 product keeps 11.  tf32(v) as
// cvt.rna.tf32.f32 rounds it (to nearest, ties away from zero: half an ulp
// added to the magnitude, the 13 low bits cleared), in two integer
// instructions, where the conversion runs on a quarter-rate pipe; lo takes
// one.
//
// A NaN stays NaN: the carry can turn a NaN's hi into a zero of either
// sign (0x7FFFFFFF, the card's NaN, becomes −0.0), but v − hi is then the
// card's NaN, 0x7FFFFFFF, and truncation leaves it NaN, so lo carries it
// into lo_a·hi_b and hi_a·lo_b.  Rounding lo would lose it as hi does; a
// test for NaN before hi's rounding spilled the fp32 K7 backward's
// registers and took the K6 backward ~10% longer (NVIDIA H100 80GB HBM3,
// 700 W).  An inf v has lo =
// inf − inf = NaN: a·b is NaN where one fp32 product could give inf (so
// is a finite v within an ulp of the largest fp32, whose hi rounds up to
// inf)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xFFFFE000u;
}

// an operand fragment of mma.m16n8k8 (A: 4 registers, B: 2) as hi and lo
template <int N>
struct Tf32Frag {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float v) { split_tf32(v, hi[i], lo[i]); }
};

// d (16 x 8, fp32) += a (16 x 8) · b (8 x 8), TF32 operands (mma.sync, one
// warp): a_i at rows g + 8·(i % 2), column t + 4·(i / 2); b_i at row t + 4i,
// column g; d_i at row g + 8·(i / 2), column 2t + i % 2 (g = lane / 4, t =
// lane % 4)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in 3xTF32 (lo·hi, hi·lo, then hi·hi)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Tf32Frag<4>& a,
                                           const Tf32Frag<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// cp.async of one fp32 (ok: else zeros, the source not read) and of 16
// bytes of which the first `bytes` are read (the rest zeros), for the
// fp32 tiles of those kernels
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [0, rows) of a slice (row stride `stride`, fp32) into shared memory
// at dst with a row pitch of `pitch` floats, kRows x kCols floats in all,
// zeros past rows and cols, by cp.async from `threads` threads: 16 bytes
// at a time where `vec` (16-byte aligned rows, pitch a multiple of 4),
// else 4
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_f32_tile(uint32_t dst, int pitch,
                                              const float* __restrict__ src,
                                              long long stride, int rows, int cols,
                                              bool vec) {
  if (vec) {
    constexpr int kChunks = kCols / 4;
    for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = 4 * (idx % kChunks);
      const int bytes = r < rows ? 4 * max(0, min(4, cols - c)) : 0;
      cp_async16(dst + 4 * (r * pitch + c), bytes ? src + r * stride + c : src, bytes);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * kCols; idx += kThreads) {
      const int r = idx / kCols, c = idx % kCols;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + 4 * (r * pitch + c), ok ? src + r * stride + c : src, ok);
    }
  }
}

// The accumulator of one m16n8 product used as the A operand of the next
// (k = its 8 columns): d_0..d_3 go to a_0, a_2, a_1, a_3, so A's column
// t (t + 4) is the accumulator's column 2t (2t + 1).  The B operand of that
// product must take its rows in the same order: b_0 from row 2t, b_1 from
// row 2t + 1 of the 8.
__device__ __forceinline__ void acc_as_a(Tf32Frag<4>& a, const float (&d)[4]) {
  a.set(0, d[0]);
  a.set(1, d[2]);
  a.set(2, d[1]);
  a.set(3, d[3]);
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the extension needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// 4-D bf16 map over the (D, S, H, B) view with strides st = (b, h, s) in
// elements, boxes of 64 columns x `rows` rows, 128-byte swizzle, zero fill.
// A dimension of size 1 is never stepped: it gets a stride TMA accepts.
inline bool encode_map(CUtensorMap* map, const void* ptr, const long long* st,
                       int B, int H, int S, int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t stride_s = S > 1 ? st[2] * 2 : (D * 2 + 15) / 16 * 16;
  cuuint64_t stride_h = H > 1 ? st[1] * 2 : stride_s * S;
  cuuint64_t stride_b = B > 1 ? st[0] * 2 : stride_h * H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {stride_s, stride_h, stride_b};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
