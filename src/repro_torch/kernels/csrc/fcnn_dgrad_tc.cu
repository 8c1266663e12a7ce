// FCNN backward-data kernel on Hopper's tensor cores (sm_90a) for bf16
// weights: dX = (dY ⊙ A'(Y)) @ Wᵀ.
//
// Replaces the TPU kernel fcnn_layer_dgrad (_dgrad_kernel) of
// src/repro/kernels/fcnn_layer.py where W is bf16: case (a), bf16 dY and Y,
// and case (b), fp32 ones.  fcnn_dgrad.cu keeps fp32 weights (cases (c)
// and (d)) on the CUDA cores.  dY, Y are (M, N), W is (K, N), read in place
// as Wᵀ (w[k * N + n]); dX takes dY's type.
//
// The products.  dZ = dY ⊙ A'(Y) is fp32 in the reference (act_deriv of
// fcnn_act.cuh, from the output Y), so the product is an fp32 × bf16 one
// in both cases, and rounding dZ to bf16 would move each product by up to
// 2^-9.  dZ never exists in device memory: each thread reads the dY and Y
// of its wgmma A fragment from the staged slice, forms dZ in fp32, splits
// it into hi = bf16(dZ) and lo = bf16(dZ − hi) and issues two
// register-A wgmmas against the same B: hi·Wᵀ + lo·Wᵀ misses dZ·Wᵀ by at
// most 2^-17 of it.  A bf16 dX is rounded once, after the cluster's sum.
//
// What bounds it on an H100.  At NN5 (batch 128) the layers' dgrads are
// 1 GFLOP each, 2 µs at the bf16 peak with the two products, against
// 2.9-3.1 µs of HBM bytes (the 8 MB bf16 W): bytes.  At NN1 (batch 64,
// 1000-500-10 behind its first layer) a dgrad is at most 0.06 GFLOP over
// 1.2 MB: a launch's latency and one exposed copy of each slice bind it.
//
// Design.  One warpgroup (128 threads) a block computes a 64 x BN tile of
// dX (BN = 128 or 64 columns, rows of W; a template parameter the host
// plan picks,
// fcnn_layer.py:dgrad_tc_plan, so every wgmma chain has a compile-time
// length).  The contraction N is split over the blocks of a cluster (up to
// 16) in slices of 64, staged by cp.async in a ring of 3 to 8 stages
// (fcnn_tc::ring_stages): dY's and Y's slices as padded rows in their own
// type (the threads read them), W's as BN rows of 64 contraction elements
// in a 128-byte-swizzled tile, which is Wᵀ K-major: no transpose bit.
// Rows that are not 16-byte multiples (N = 500 or 10 in bf16, odd widths)
// take 4-byte or 2-byte copies, so TMA, which needs 16-byte strides, is
// not used.  The cluster's partial tiles are summed in rank order through
// distributed shared memory (fcnn_tc::finish): one launch, no atomics, no
// workspace, and repeated calls give bit-identical dX.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fcnn_act.cuh"
#include "fcnn_tc.cuh"

namespace {

using namespace fcnn_tc;
using fcnn::copy_chunk;
using fcnn::kChunk;

// One stage of the ring: dY's and Y's slices (padded rows of TD) and W's
// (BN rows of SLICE elements, swizzled), each a multiple of 1024 bytes,
// plus 1024 bytes to align the ring.
template <class TD, int BN>
struct Layout {
  static constexpr int kZ = BM * PITCH * static_cast<int>(sizeof(TD));
  static constexpr int kB = BN * 128;
  static constexpr int kStage = 2 * kZ + kB;
  static constexpr int kStages = ring_stages(kStage);
  static constexpr int kSmem = kStages * kStage + 1024;
  static_assert(kZ % 1024 == 0 && kB % 1024 == 0, "swizzle-aligned tiles");
  static_assert(BM * (BN + 8) * 4 <= kStages * kStage, "partials fit in the ring");
};

// grid (split, ceil(K / BN), ceil(M / BM)), clusters of (split, 1, 1)
template <class TD, int ACT, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fcnn_dgrad_tc_kernel(const TD* __restrict__ dy, const TD* __restrict__ y,
                     const bf16* __restrict__ w, TD* __restrict__ dx, int M, int K,
                     int N, bool pairs, bool pairs_out) {
  using L = Layout<TD, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_u32(smem);

  const int split = gridDim.x;
  const int rank = blockIdx.x;  // the block's rank in its cluster
  const int col0 = blockIdx.y * BN;
  const int row0 = blockIdx.z * BM;
  const int t = threadIdx.x;

  // this rank's contraction slices: an even share, possibly none
  const int n_slices = (N + SLICE - 1) / SLICE;
  const int s_begin = rank * n_slices / split;
  const int count = (rank + 1) * n_slices / split - s_begin;

  auto load = [&](int slice, int stage) {
    uint8_t* zs = smem + stage * L::kStage;
    uint8_t* ws = zs + 2 * L::kZ;
    const int n0 = (s_begin + slice) * SLICE;
    for_chunks<BM, SLICE, kChunk<TD, VEC>>([&](int r, int c) {
      const int gr = row0 + r, gn = n0 + c;
      const bool ok = gr < M && gn < N;
      const bool ok_hi = gr < M && gn + 1 < N;
      const size_t off = ok ? static_cast<size_t>(gr) * N + gn : 0;
      TD* z = reinterpret_cast<TD*>(zs) + r * PITCH + c;
      copy_chunk<TD, VEC>(z, dy + off, ok, ok_hi, pairs);
      copy_chunk<TD, VEC>(z + BM * PITCH, y + off, ok, ok_hi, pairs);
    });
    // Wᵀ's slice: BN rows of W (columns of dX) x SLICE contraction entries
    for_chunks<BN, SLICE, kChunk<bf16, VEC>>([&](int r, int c) {
      const int gk = col0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      const bf16* src = w + (ok ? static_cast<size_t>(gk) * N + gn : 0);
      copy_chunk<bf16, VEC>(reinterpret_cast<bf16*>(ws + sw128(r, c)), src, ok,
                            gk < K && gn + 1 < N, pairs);
    });
  };

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  // this thread's fragment rows r0 and r0 + 8, columns cin, cin + 1 (+ 8)
  const int lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;
  const int cin = 2 * (lane % 4);

  tc::fence_regs(acc);
  mainloop<L::kStages>(count, load, [&](int stage) {
    const TD* zs = reinterpret_cast<const TD*>(smem + stage * L::kStage);
    const TD* ys = zs + BM * PITCH;
    const uint32_t wa = sbase + stage * L::kStage + 2 * L::kZ;
    // dZ = dY ⊙ A'(Y) in fp32 at this thread's fragment, split hi/lo
    uint32_t hi[SLICE / 16][4], lo[SLICE / 16][4];
#pragma unroll
    for (int kk = 0; kk < SLICE / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int off = (r0 + 8 * (q & 1)) * PITCH + 16 * kk + cin + 8 * (q >> 1);
        const float2 d = pair(zs + off), yy = pair(ys + off);
        split_pack(make_float2(d.x * fcnn::act_deriv<ACT>(yy.x),
                               d.y * fcnn::act_deriv<ACT>(yy.y)),
                   hi[kk][q], lo[kk][q]);
      }
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < SLICE / 16; ++kk) {
      const uint64_t d = tc::desc_sw128(wa + kk * 32, 16);
      mma_rs<BN, 0>(acc, hi[kk], d);
      mma_rs<BN, 0>(acc, lo[kk], d);
    }
    tc::wg_commit();
    tc::wg_wait_all();
    tc::fence_regs(acc);
  });

  finish<BN>(acc, smem, split, rank, r0, cin, [&](int r, int c, float v0, float v1) {
    const int gr = row0 + r, gc = col0 + c;
    if (gr < M && gc < K)
      store_pair(dx + static_cast<size_t>(gr) * K + gc, v0, v1, pairs_out, gc + 1 >= K);
  });
}

template <class TD, int ACT, int BN, bool VEC>
cudaError_t launch(const TD* dy, const TD* y, const bf16* w, TD* dx, int M, int K,
                   int N, int split, cudaStream_t s) {
  auto kern = fcnn_dgrad_tc_kernel<TD, ACT, BN, VEC>;
  constexpr int smem = Layout<TD, BN>::kSmem;
  const bool pairs = fcnn::pair_rows(dy, N) && fcnn::pair_rows(y, N) &&
                     fcnn::pair_rows(w, N);
  // dX's rows take pair stores (8 bytes fp32, 4 bf16)
  const bool pairs_out =
      K % 2 == 0 && reinterpret_cast<uintptr_t>(dx) % (2 * sizeof(TD)) == 0;
  // opt in once per instantiation (above 48 KB of shared memory, clusters
  // of 16), outside any CUDA graph capture later launches are recorded into
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (K + BN - 1) / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, dy, y, w, dx, M, K, N, pairs, pairs_out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class TD, int ACT, int BN>
cudaError_t dgrad(const void* dyv, const void* yv, const void* wv, void* dxv, int M,
                  int K, int N, int split, cudaStream_t s) {
  const auto dy = static_cast<const TD*>(dyv);
  const auto y = static_cast<const TD*>(yv);
  const auto w = static_cast<const bf16*>(wv);
  const auto dx = static_cast<TD*>(dxv);
  // 16-byte rows of dY, Y and W
  const bool vec = N % kChunk<TD, true> == 0 && N % kChunk<bf16, true> == 0 &&
                   ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(w)) % 16) == 0;
  return vec ? launch<TD, ACT, BN, true>(dy, y, w, dx, M, K, N, split, s)
             : launch<TD, ACT, BN, false>(dy, y, w, dx, M, K, N, split, s);
}

template <class TD, int ACT>
cudaError_t dgrad_width(const void* dy, const void* y, const void* w, void* dx, int M,
                        int K, int N, int width, int split, cudaStream_t s) {
  switch (width) {
    case 64: return dgrad<TD, ACT, 64>(dy, y, w, dx, M, K, N, split, s);
    case 128: return dgrad<TD, ACT, 128>(dy, y, w, dx, M, K, N, split, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class TD>
cudaError_t dgrad_typed(const void* dy, const void* y, const void* w, void* dx, int M,
                        int K, int N, int act, int width, int split, cudaStream_t s) {
  using namespace fcnn;  // Act
  switch (act) {
    case kSigmoid: return dgrad_width<TD, kSigmoid>(dy, y, w, dx, M, K, N, width, split, s);
    case kRelu: return dgrad_width<TD, kRelu>(dy, y, w, dx, M, K, N, width, split, s);
    case kTanh: return dgrad_width<TD, kTanh>(dy, y, w, dx, M, K, N, width, split, s);
    case kNone: return dgrad_width<TD, kNone>(dy, y, w, dx, M, K, N, width, split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dy, y (M, N), w (K, N) bf16 -> dx (M, K); dy, y and dx bf16 where
// dy_bf16, else fp32.  dX tiles 64 x `width` (64 or 128); split in {1, 2,
// 4, 8, 16} blocks of a cluster share the contraction N in slices of 64
cudaError_t launch_fcnn_dgrad_tc(const void* dy, const void* y, const void* w,
                                 void* dx, int M, int K, int N, int act, int width,
                                 int split, int dy_bf16, cudaStream_t s) {
  if (M < 1 || K < 1 || N < 1 || split < 1 || split > MAX_SPLIT ||
      (split & (split - 1)) != 0 || width < 64 || (K + width - 1) / width > 65535 ||
      (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  return dy_bf16 ? dgrad_typed<bf16>(dy, y, w, dx, M, K, N, act, width, split, s)
                 : dgrad_typed<float>(dy, y, w, dx, M, K, N, act, width, split, s);
}

