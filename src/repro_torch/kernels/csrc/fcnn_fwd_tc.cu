// FCNN forward kernel on Hopper's tensor cores (sm_90a) for bf16 weights:
// out = act(x @ w + b).
//
// Replaces the TPU kernel fcnn_layer (_fwd_kernel) of
// src/repro/kernels/fcnn_layer.py where w (and b) are bf16: case (a), bf16
// x, and case (b), fp32 x.  fcnn_fwd.cu keeps fp32 weights (cases (c) and
// (d)) on the CUDA cores.  x is (M, K), w (K, N), b (N,), all row-major;
// out takes x's type.
//
// The products.  The reference promotes a mixed pair to fp32 exactly.  In
// case (a) both operands are bf16, their products are exact in fp32, and
// one bf16 wgmma with an fp32 accumulator computes the reference's sum: x
// is a shared-memory operand (ss).  In case (b) x is fp32, and rounding it
// to bf16 would move each product by up to 2^-9 (TF32, ~2^-11, fails the
// 1e-4 bar of an fp32 out too).  So each thread reads its x fragment from
// the staged fp32 slice, splits each value into hi = bf16(x) and lo =
// bf16(x − hi), and issues two register-A wgmmas against the same B: hi·w
// + lo·w misses x·w by at most 2^-17 of it.  The bias add and act_fwd run
// in fp32 on the complete sum; a bf16 out is rounded once.
//
// What bounds it on an H100.  NN5's layers (batch 128, 1024-4000-1000-
// 4000) are 1 GFLOP each, 1 µs at the bf16 peak (2 µs with case (b)'s two
// products), against 2.8 µs of HBM bytes for the 8 MB bf16 w: bytes.  At
// NN1 (batch 64, 784-1000-500-10) a layer is at most 0.1 GFLOP over 1.7 MB:
// a launch's latency and one exposed copy of each slice bind it.
//
// Design.  One warpgroup (128 threads) a block computes a 64 x BN tile of
// out: BN = 64, or 16 for the last layers (N = 10), a template parameter
// the host plan picks (fcnn_layer.py:fwd_tc_plan), so every wgmma chain
// has a compile-time length.  The contraction K is split over the blocks
// of a cluster (up to 16) in slices of 64, staged by cp.async in a ring of
// 3 to 8 stages (fcnn_tc::ring_stages): x's slice as a 128-byte-swizzled
// K-major tile (case (a)) or as padded fp32 rows the threads read (case
// (b)), w's slice as BN columns of 64 rows, MN-major (the transpose bit):
// one 128-byte-swizzled atom of 64 columns, or a 32-byte-swizzled one of
// 16 where BN = 16.  Rows that are not 16-byte multiples (K or N of 500,
// 10 or odd) take 4-byte or 2-byte copies, so TMA, which needs 16-byte
// strides, is not used.  The cluster's partial tiles are summed in rank
// order through distributed shared memory (fcnn_tc::finish); the bias add
// and the activation run on that sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fcnn_act.cuh"
#include "fcnn_tc.cuh"

namespace {

using namespace fcnn_tc;
using fcnn::copy_chunk;
using fcnn::kChunk;

// One stage of the ring: x's slice (a swizzled bf16 tile, or padded fp32
// rows) and w's (BN columns of SLICE rows), each a multiple of 1024 bytes
// (the 128-byte swizzle's period), plus 1024 bytes to align the ring.
template <class TX, int BN>
struct Layout {
  static constexpr bool kSS = sizeof(TX) == 2;  // case (a): x in shared memory
  static constexpr int kA = kSS ? BM * 128 : BM * PITCH * 4;
  static constexpr int kB = BN == 16 ? SLICE * 32 : SLICE * 128;
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = ring_stages(kStage);
  static constexpr int kSmem = kStages * kStage + 1024;
  static_assert(kA % 1024 == 0 && kB % 1024 == 0, "swizzle-aligned tiles");
  static_assert(BM * (BN + 8) * 4 <= kStages * kStage, "partials fit in the ring");
};

// where element (k, n) of w's slice lies in its stage
template <int BN>
__device__ __forceinline__ uint32_t w_offset(int k, int n) {
  if constexpr (BN == 16) return sw32(k, n);
  else return sw128(k, n);
}

// the descriptor of w's slice at k16 step kk: 16 rows of the MN-major
// tile (one atom: its LBO, the stride between atoms, is not read), its
// 8-row groups 1024 (256) bytes apart
template <int BN>
__device__ __forceinline__ uint64_t w_desc(uint32_t addr, int kk) {
  if constexpr (BN == 16) return tc::desc_sw32(addr + kk * 16 * 32, SLICE * 32);
  else return tc::desc_sw128(addr + kk * 16 * 128, SLICE * 128);
}

// grid (split, ceil(N / BN), ceil(M / BM)), clusters of (split, 1, 1)
template <class TX, int BN, bool VEC_X, bool VEC_W>
__global__ void __launch_bounds__(THREADS, 1)
fcnn_fwd_tc_kernel(const TX* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ b, TX* __restrict__ out, int M, int K,
                   int N, int act, bool pairs_x, bool pairs_w, bool pairs_out) {
  using L = Layout<TX, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_u32(smem);

  const int split = gridDim.x;
  const int rank = blockIdx.x;  // the block's rank in its cluster
  const int col0 = blockIdx.y * BN;
  const int row0 = blockIdx.z * BM;
  const int t = threadIdx.x;

  // this rank's contraction slices: an even share, possibly none
  const int n_slices = (K + SLICE - 1) / SLICE;
  const int s_begin = rank * n_slices / split;
  const int count = (rank + 1) * n_slices / split - s_begin;

  auto load = [&](int slice, int stage) {
    uint8_t* xs = smem + stage * L::kStage;
    uint8_t* ws = xs + L::kA;
    const int k0 = (s_begin + slice) * SLICE;
    for_chunks<BM, SLICE, kChunk<TX, VEC_X>>([&](int r, int c) {
      const int gr = row0 + r, gk = k0 + c;
      const bool ok = gr < M && gk < K;
      const TX* src = x + (ok ? static_cast<size_t>(gr) * K + gk : 0);
      const uint32_t off = L::kSS ? sw128(r, c) : (r * PITCH + c) * 4;
      copy_chunk<TX, VEC_X>(reinterpret_cast<TX*>(xs + off), src, ok,
                            gr < M && gk + 1 < K, pairs_x);
    });
    for_chunks<SLICE, BN, kChunk<bf16, VEC_W>>([&](int r, int c) {
      const int gk = k0 + r, gn = col0 + c;
      const bool ok = gk < K && gn < N;
      const bf16* src = w + (ok ? static_cast<size_t>(gk) * N + gn : 0);
      copy_chunk<bf16, VEC_W>(reinterpret_cast<bf16*>(ws + w_offset<BN>(r, c)), src,
                              ok, gk < K && gn + 1 < N, pairs_w);
    });
  };

  // the tile's slice of b in fp32, read once for the epilogue (made
  // visible by the main loop's barriers, or the cluster's)
  __shared__ float bias[BN];
  for (int c = t; c < BN; c += THREADS)
    bias[c] = col0 + c < N ? __bfloat162float(b[col0 + c]) : 0.f;

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  // this thread's fragment rows r0 and r0 + 8, columns cin, cin + 1 (+ 8)
  const int lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;
  const int cin = 2 * (lane % 4);

  tc::fence_regs(acc);
  mainloop<L::kStages>(count, load, [&](int stage) {
    const uint32_t xa = sbase + stage * L::kStage;
    const uint32_t wa = xa + L::kA;
    if constexpr (L::kSS) {
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < SLICE / 16; ++kk)
        mma_ss<BN>(acc, tc::desc_sw128(xa + kk * 32, 16), w_desc<BN>(wa, kk));
    } else {
      const float* xs = reinterpret_cast<const float*>(smem + stage * L::kStage);
      uint32_t hi[SLICE / 16][4], lo[SLICE / 16][4];
#pragma unroll
      for (int kk = 0; kk < SLICE / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_pack(pair(xs + (r0 + 8 * (q & 1)) * PITCH + 16 * kk + cin + 8 * (q >> 1)),
                     hi[kk][q], lo[kk][q]);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < SLICE / 16; ++kk) {
        const uint64_t d = w_desc<BN>(wa, kk);
        mma_rs<BN, 1>(acc, hi[kk], d);
        mma_rs<BN, 1>(acc, lo[kk], d);
      }
    }
    tc::wg_commit();
    tc::wg_wait_all();
    tc::fence_regs(acc);
  });

  finish<BN>(acc, smem, split, rank, r0, cin, [&](int r, int c, float v0, float v1) {
    const int gr = row0 + r, gc = col0 + c;
    if (gr < M && gc < N)
      store_pair(out + static_cast<size_t>(gr) * N + gc,
                 fcnn::act_fwd_fast(act, v0 + bias[c]),
                 fcnn::act_fwd_fast(act, v1 + bias[c + 1]),
                 pairs_out, gc + 1 >= N);
  });
}

template <class TX, int BN, bool VEC_X, bool VEC_W>
cudaError_t launch(const TX* x, const bf16* w, const bf16* b, TX* out, int M, int K,
                   int N, int act, int split, cudaStream_t s) {
  auto kern = fcnn_fwd_tc_kernel<TX, BN, VEC_X, VEC_W>;
  constexpr int smem = Layout<TX, BN>::kSmem;
  const bool pairs_x = fcnn::pair_rows(x, K), pairs_w = fcnn::pair_rows(w, N);
  // out's rows take pair stores (8 bytes fp32, 4 bf16)
  const bool pairs_out =
      N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(TX)) == 0;
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
  cfg.gridDim = dim3(split, (N + BN - 1) / BN, (M + BM - 1) / BM);
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
      cudaLaunchKernelEx(&cfg, kern, x, w, b, out, M, K, N, act, pairs_x, pairs_w, pairs_out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class TX, int BN>
cudaError_t fwd(const void* xv, const void* wv, const void* bv, void* outv, int M,
                int K, int N, int act, int split, cudaStream_t s) {
  const auto x = static_cast<const TX*>(xv);
  const auto w = static_cast<const bf16*>(wv);
  const auto b = static_cast<const bf16*>(bv);
  const auto out = static_cast<TX*>(outv);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // 16-byte rows of x, of w
  const bool vx = K % kChunk<TX, true> == 0 && aligned(x);
  const bool vw = N % kChunk<bf16, true> == 0 && aligned(w);
  if (vx)
    return vw ? launch<TX, BN, true, true>(x, w, b, out, M, K, N, act, split, s)
              : launch<TX, BN, true, false>(x, w, b, out, M, K, N, act, split, s);
  return vw ? launch<TX, BN, false, true>(x, w, b, out, M, K, N, act, split, s)
            : launch<TX, BN, false, false>(x, w, b, out, M, K, N, act, split, s);
}

template <class TX>
cudaError_t fwd_typed(const void* x, const void* w, const void* b, void* out, int M,
                      int K, int N, int act, int width, int split, cudaStream_t s) {
  switch (width) {
    case 16: return fwd<TX, 16>(x, w, b, out, M, K, N, act, split, s);
    case 64: return fwd<TX, 64>(x, w, b, out, M, K, N, act, split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K), w (K, N) bf16, b (N,) bf16 -> out (M, N); x and out bf16 where
// x_bf16, else fp32.  Output tiles 64 x `width` (16 or 64); split in
// {1, 2, 4, 8, 16} blocks of a cluster share the contraction K in slices
// of 64
cudaError_t launch_fcnn_fwd_tc(const void* x, const void* w, const void* b, void* out,
                               int M, int K, int N, int act, int width, int split,
                               int x_bf16, cudaStream_t s) {
  if (M < 1 || K < 1 || N < 1 || split < 1 || split > MAX_SPLIT ||
      (split & (split - 1)) != 0 || act < fcnn::kNone || act > fcnn::kTanh ||
      width < 16 || (N + width - 1) / width > 65535 || (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  return x_bf16 ? fwd_typed<bf16>(x, w, b, out, M, K, N, act, width, split, s)
                : fwd_typed<float>(x, w, b, out, M, K, N, act, width, split, s);
}

