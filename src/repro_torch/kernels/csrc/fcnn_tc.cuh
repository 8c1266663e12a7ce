// Pieces shared by the FCNN kernels that multiply on Hopper's tensor cores:
// the forward (fcnn_fwd_tc.cu) and dgrad (fcnn_dgrad_tc.cu) kernels where
// the weights are bf16, and the wgrad (fcnn_wgrad_tc.cu) where the data
// are.  The forward and dgrad cut the batch into 64-row tiles (one
// warpgroup's m64 wgmma), the wgrad dW's columns; all split the
// contraction over the blocks of a thread-block cluster in slices of 64
// (128 bytes of bf16, four k16 steps) and stage the slices with cp.async
// in a ring of 3 to 8 stages (fcnn_splitk.cuh's copy_chunk: 16 bytes
// where a row allows, else 4-byte fp32 elements or bf16 pairs, or two
// guarded 2-byte loads).  With one warpgroup an SM, latency is what is
// left exposed: the first slice's trip from memory, each slice's, and an
// epilogue's dependent work, so the epilogue reads the partial sums 16
// bytes a rank at a time and stores pairs of outputs.
//   * ring_stages: how deep a ring is;
//   * mainloop: the slices through the ring, the copies kStages − 1
//     slices ahead of the products;
//   * sw128 / sw32: where an element of a 128-byte- (32-byte-) swizzled
//     tile lies, the layouts tc::desc_sw128 / tc::desc_sw32 describe;
//   * for_chunks: the chunks of a tile each thread copies;
//   * pair / split_pack (hopper_tc.cuh's): two neighbouring elements of a
//     staged slice as fp32, and an fp32 pair split into bf16 hi = bf16(v)
//     and lo = bf16(v − hi), packed as a wgmma A fragment.  hi + lo carries ~16
//     bits (|v − hi − lo| <= 2^-17·|v|), so two bf16 products, summed in
//     fp32, stand for the fp32 × bf16 product the reference computes;
//   * mma_rs / mma_ss: the m64nNk16 wgmma of a tile width N (16, 64, 128
//     from registers; 16, 64 from shared memory);
//   * finish / reduce_pairs: the complete tile to the epilogue, two
//     neighbouring columns at a time, from the registers where the cluster
//     has one block, else summed in rank order through distributed shared
//     memory (no atomics, no workspace, repeated calls bit-identical; every
//     rank's read of four columns in flight together, the split a template
//     parameter);
//   * store_pair: two neighbouring outputs, one store where aligned.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "fcnn_splitk.cuh"
#include "hopper_tc.cuh"

namespace fcnn_tc {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;         // output tile rows: one warpgroup's m64
constexpr int SLICE = 64;      // contraction elements of one stage
constexpr int THREADS = 128;   // one warpgroup
constexpr int MAX_SPLIT = 16;  // blocks of a cluster (above 8, non-portable)
// rows of a slice that threads read as register fragments: SLICE elements
// and 8 of padding, so each row starts 16-byte aligned and a warp's
// fragment reads (8 rows x 4 pairs) hit distinct banks
constexpr int PITCH = SLICE + 8;

// the stages of a ring whose stage takes `stage_bytes`: as many as fit in
// 110 KB (two blocks an SM), at least 3 and at most 8
__host__ __device__ constexpr int ring_stages(int stage_bytes) {
  return 110 * 1024 / stage_bytes < 3 ? 3
         : 110 * 1024 / stage_bytes > 8 ? 8
                                        : 110 * 1024 / stage_bytes;
}

// byte offset of 2-byte element c of row r in a 128-byte-swizzled tile of
// 64-element rows (16-byte chunk c / 8 of the row moves to chunk
// (c / 8) ^ (r % 8)): the layout of a K-major operand, and of each
// 64-column atom of an MN-major one
__host__ __device__ constexpr uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + 2 * (c & 7);
}

// the same in a 32-byte-swizzled tile of 16-element rows (chunk c / 8
// moves to (c / 8) ^ ((r / 4) % 2)): an MN-major operand 16 columns wide
__host__ __device__ constexpr uint32_t sw32(int r, int c) {
  return r * 32 + ((((c >> 3) ^ ((r >> 2) & 1))) << 4) + 2 * (c & 7);
}

// fn(row, col) for each chunk of CW elements of an R x W tile that this
// thread copies (fcnn::Map's chunks).  Unrolled by 8 at most: 4-byte
// copies of a 128-column tile give a thread 32 chunks, whose addresses,
// all live at once, spilled registers
template <int R, int W, int CW, class Fn>
__device__ __forceinline__ void for_chunks(Fn fn) {
  using Chunks = fcnn::Map<CW, W, R, THREADS>;
  const int t = threadIdx.x;
#pragma unroll 8
  for (int i = 0; i < Chunks::kCount; ++i)
    if (Chunks::has(t, i)) fn(Chunks::row(t, i), Chunks::col(t, i));
}

// two neighbouring elements (the first at an even index) as fp32
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

using tc::split_pack;  // hopper_tc.cuh

// Slices [0, count) of this block through a ring of kStages stages:
// load(slice, stage) issues a slice's copies, mma(stage) its products,
// retired before it returns.  The copies run kStages − 1 slices ahead.
template <int kStages, class Load, class Mma>
__device__ __forceinline__ void mainloop(int count, Load load, Mma mma) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) load(s, s);
    fcnn::cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    fcnn::cp_async_wait<kStages - 2>();  // this thread's copies of slice i landed
    tc::fence_proxy_async();             // ... and are visible to the wgmma
    // slice i visible to all; every product of slice i - 1 has retired
    __syncthreads();
    if (i + kStages - 1 < count) load(i + kStages - 1, (i + kStages - 1) % kStages);
    fcnn::cp_async_commit();
    mma(i % kStages);
  }
}

// d (64 x N) += A (register fragments) · B (shared memory)
template <int N, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t desc_b) {
  if constexpr (N == 16) tc::wgmma_rs_m64n16k16<kTransB>(d, a, desc_b);
  else if constexpr (N == 64) tc::wgmma_rs_m64n64k16<kTransB>(d, a, desc_b);
  else tc::wgmma_rs_m64n128k16<kTransB>(d, a, desc_b);
}

// d (64 x N) += A (K-major) · B (MN-major), both in shared memory
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t desc_a,
                                       uint64_t desc_b) {
  if constexpr (N == 16) tc::wgmma_ss_m64n16k16<0, 1>(d, desc_a, desc_b, 1);
  else tc::wgmma_ss_m64n64k16<0, 1>(d, desc_a, desc_b, 1);
}

// Rows [rank·BM/S, (rank+1)·BM/S) of the cluster's partial tiles (BM x N
// floats at `red` in each block, pitch PITCH) summed over the S ranks in
// order, four neighbouring columns (one 16-byte read a rank) at a time,
// to epi(row, col, v0, v1) for each pair.  S is a template parameter:
// every rank's reads of a quad are issued together, and each thread's
// quads are unrolled.
template <int S, int N, int PITCH, class Epilogue>
__device__ __forceinline__ void reduce_pairs(float* red, int rank, Epilogue epi) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kRows = BM / S, kQuads = kRows * N / 4;
  static_assert(N % 4 == 0 && PITCH % 4 == 0, "16-byte reads of the partials");
  cluster.sync();  // every partial written
  const float* part[S];
#pragma unroll
  for (int q = 0; q < S; ++q) part[q] = cluster.map_shared_rank(red, q);
#pragma unroll
  for (int i = 0; i < (kQuads + THREADS - 1) / THREADS; ++i) {
    const int p = threadIdx.x + i * THREADS;
    if (kQuads % THREADS != 0 && p >= kQuads) break;
    const int r = rank * kRows + p / (N / 4), c = 4 * (p % (N / 4));
    float4 v[S];
#pragma unroll
    for (int q = 0; q < S; ++q) v[q] = *reinterpret_cast<const float4*>(part[q] + r * PITCH + c);
    float4 sum = v[0];
#pragma unroll
    for (int q = 1; q < S; ++q)
      sum = make_float4(sum.x + v[q].x, sum.y + v[q].y, sum.z + v[q].z, sum.w + v[q].w);
    epi(r, c, sum.x, sum.y);
    epi(r, c + 2, sum.z, sum.w);
  }
  cluster.sync();  // every partial stays alive until all ranks have read it
}

// The BM x N tile's complete sum to epi(row, col, v0, v1), the sums of
// columns col and col + 1 (col even) of a row, both within the tile.
// Accumulator e of this thread holds row r0 + 8·((e / 2) % 2), column
// 8·(e / 4) + cin + e % 2 (the wgmma fragment).  With one block in the
// cluster the sums leave the registers; else each block parks its
// partial tile at the start of its shared memory (the ring is free: every
// product has retired) and rank r sums rows [r·BM/split, (r+1)·BM/split)
// over the ranks in order (reduce_pairs).
template <int N, class Epilogue>
__device__ __forceinline__ void finish(float (&acc)[N / 2], uint8_t* smem, int split,
                                       int rank, int r0, int cin, Epilogue epi) {
  if (split == 1) {
#pragma unroll
    for (int e = 0; e < N / 2; e += 2)
      epi(r0 + 8 * ((e >> 1) & 1), 8 * (e >> 2) + cin, acc[e], acc[e + 1]);
    return;
  }
  constexpr int kRedPitch = N + 8;  // float2 writes of a warp: two wavefronts
  fcnn::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int e = 0; e < N / 2; e += 2)
    *reinterpret_cast<float2*>(&red[(r0 + 8 * ((e >> 1) & 1)) * kRedPitch +
                                    8 * (e >> 2) + cin]) = make_float2(acc[e], acc[e + 1]);
  switch (split) {
    case 2: reduce_pairs<2, N, kRedPitch>(red, rank, epi); break;
    case 4: reduce_pairs<4, N, kRedPitch>(red, rank, epi); break;
    case 8: reduce_pairs<8, N, kRedPitch>(red, rank, epi); break;
    default: reduce_pairs<16, N, kRedPitch>(red, rank, epi); break;
  }
}

// two neighbouring outputs (col even) of a row of `width` elements at p:
// one 8-byte (fp32) or 4-byte (bf16) store where `pairs` (the width is
// even and the base aligned), else one element at a time, the second only
// where it lies in the row (last = false)
__device__ __forceinline__ void store_pair(float* p, float v0, float v1, bool pairs,
                                           bool last) {
  if (pairs) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (!last) p[1] = v1;
  }
}
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1, bool pairs,
                                           bool last) {
  if (pairs) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (!last) p[1] = __float2bfloat16_rn(v1);
  }
}

}  // namespace fcnn_tc
