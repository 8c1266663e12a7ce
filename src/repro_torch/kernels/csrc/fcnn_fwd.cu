// FCNN forward kernel for Hopper (sm_90a): out = act(x @ w + b).
//
// Replaces the TPU kernel fcnn_layer (_fwd_kernel) of
// src/repro/kernels/fcnn_layer.py.  x is (M, K), w (K, N), b (N,), all
// row-major.  x is fp32 or bf16, and so is w (b in w's type); out takes
// x's type, as the TPU kernel's.  Each operand is read in its own type and
// widened to fp32 as it leaves shared memory for registers; products and
// sums are IEEE fp32 on the CUDA cores (the reference promotes a mixed
// pair to fp32 exactly, and TF32 keeps about three digits and fails the
// 1e-4 bar), the bias add and the activation run in fp32, and a bf16 out
// is rounded once, to nearest even, after the split-K sum.
//
// What bounds it on an H100: at NN1's layer 2 (M = 64, K = 1000, N = 500)
// the call is 64 MFLOP over 2.3 MB, ~1 µs at the fp32 peak and ~0.7 µs at
// 3.35 TB/s.  A 64-row batch cut into 64 x 64 tiles gives 8 blocks on 132
// SMs, each walking the whole contraction with one exposed global-memory
// round trip per slice: latency and occupancy, not either peak, bound it.
// The design is the dgrad kernel's (fcnn_dgrad.cu):
//   * 64 x 32 output tiles, 128 threads, 4 rows x 4 neighbouring columns
//     each, and the contraction K split over the blocks of a thread-block
//     cluster (up to 16; above 8 the non-portable size), so the grid fills
//     the 132 SMs with up to four blocks each (the fp32 ring of 39 KB
//     leaves room for them; a bf16 operand halves its part); the host
//     picks the split and the slice width (16 or 32) from (M, K, N), the
//     same for every type (fcnn_layer.py:fwd_plan);
//   * a 3-stage cp.async ring of contraction slices: x's slice as BM rows
//     of the slice (contiguous along k, as dgrad's dZ), w's as BK rows of
//     32 output columns (contiguous along the columns), so a thread reads
//     four neighbouring columns of one k as one float4 (8 bytes in bf16)
//     and eight threads read one row: no bank conflicts;
//   * partial tiles summed in rank order through distributed shared memory
//     (fcnn_splitk.cuh), rank r taking rows [r·64/split, (r+1)·64/split).
//     The bias add and the activation run once, on the complete sum: in
//     that reduction, or in registers when split == 1.
// Rows that are not 16-byte aligned take 4-byte copies (VEC_X is false
// where K is not a multiple of 16 bytes, VEC_W where N is not, e.g. N = 10
// or, in bf16, N = 500), chosen by the host: one fp32 element, or a pair
// of bf16 ones (two guarded 2-byte loads where the width is odd, e.g. K =
// 13).  Out-of-range rows and columns are zero-filled by the copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fcnn_act.cuh"
#include "fcnn_splitk.cuh"

namespace {

using namespace fcnn;  // act_fwd, copy_chunk, load4, store*, Map, cluster_reduce_rows

constexpr int BM = 64;         // output tile rows (batch)
constexpr int BN = 32;         // output tile columns
constexpr int STAGES = 3;
constexpr int THREADS = 128;   // 16 x 8 threads, 4 x 4 outputs each
constexpr int RED_PITCH = BN + 1;
constexpr int MAX_SPLIT = 16;

// x's rows in the ring: BK elements and 16 bytes of padding, so each row
// starts 16-byte aligned
template <class TX, int BK>
__host__ __device__ constexpr int x_pitch() {
  return BK + 16 / static_cast<int>(sizeof(TX));
}

// the ring: STAGES x (x slice: BM rows of x_pitch | w slice: BK rows of BN)
template <class TX, class TW, int BK>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (BM * x_pitch<TX, BK>() * static_cast<int>(sizeof(TX)) +
                   BK * BN * static_cast<int>(sizeof(TW)));
}

// grid (split, ceil(N / BN), ceil(M / BM)), clusters of (split, 1, 1); BK:
// the contraction slice of one stage.  As in dgrad_kernel, a minimum of one
// block an SM leaves ptxas the registers it needs (no spills).
template <class TX, class TW, bool VEC_X, bool VEC_W, int BK>
__global__ void __launch_bounds__(THREADS, 1)
fcnn_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                const TW* __restrict__ b, TX* __restrict__ out, int M, int K,
                int N, int act, bool pairs_x, bool pairs_w) {
  constexpr int XP = x_pitch<TX, BK>();
  extern __shared__ float4 smem4[];
  auto Xs = reinterpret_cast<TX (*)[BM * XP]>(smem4);
  auto Ws = reinterpret_cast<TW (*)[BK * BN]>(Xs + STAGES);
  static_assert(BM * RED_PITCH * static_cast<int>(sizeof(float)) <=
                    smem_bytes<TX, TW, BK>(),
                "partials fit in the ring");

  const int split = gridDim.x;
  const int rank = blockIdx.x;  // the block's rank in its cluster
  const int col0 = blockIdx.y * BN;
  const int row0 = blockIdx.z * BM;
  const int t = threadIdx.x;
  const int tx = t % 8;   // columns 4tx .. 4tx + 3
  const int ty = t / 8;   // rows ty + 16i

  // this rank's contraction slices: an even share, possibly none
  const int n_slices = (K + BK - 1) / BK;
  const int s_begin = rank * n_slices / split;
  const int count = (rank + 1) * n_slices / split - s_begin;

  using Xm = Map<kChunk<TX, VEC_X>, BK, BM, THREADS>;
  using Wm = Map<kChunk<TW, VEC_W>, BN, BK, THREADS>;
  auto load = [&](int slice, int stage) {
    const int k0 = (s_begin + slice) * BK;
#pragma unroll
    for (int i = 0; i < Xm::kCount; ++i) {
      if (!Xm::has(t, i)) continue;
      const int r = Xm::row(t, i), c = Xm::col(t, i);
      const int gr = row0 + r, gk = k0 + c;
      const bool ok = gr < M && gk < K;
      const TX* src = x + (ok ? static_cast<size_t>(gr) * K + gk : 0);
      copy_chunk<TX, VEC_X>(&Xs[stage][r * XP + c], src, ok, gr < M && gk + 1 < K,
                            pairs_x);
    }
#pragma unroll
    for (int i = 0; i < Wm::kCount; ++i) {
      if (!Wm::has(t, i)) continue;
      const int r = Wm::row(t, i), c = Wm::col(t, i);
      const int gk = k0 + r, gn = col0 + c;
      const bool ok = gk < K && gn < N;
      const TW* src = w + (ok ? static_cast<size_t>(gk) * N + gn : 0);
      copy_chunk<TW, VEC_W>(&Ws[stage][r * BN + c], src, ok, gk < K && gn + 1 < N,
                            pairs_w);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    const int stage = i % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice i landed
    // slice i visible to all; every thread is done with slice i - 1's stage
    __syncthreads();
    if (i + STAGES - 1 < count) load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const TX* xs = Xs[stage];
    const TW* ws = Ws[stage];
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 a[4], bq[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = load4(&xs[(ty + 16 * r) * XP + k]);
#pragma unroll
      for (int q = 0; q < 4; ++q) bq[q] = load4(&ws[(k + q) * BN + 4 * tx]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float av[4] = {a[r].x, a[r].y, a[r].z, a[r].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] = fmaf(av[q], bq[q].x, acc[r][0]);
          acc[r][1] = fmaf(av[q], bq[q].y, acc[r][1]);
          acc[r][2] = fmaf(av[q], bq[q].z, acc[r][2]);
          acc[r][3] = fmaf(av[q], bq[q].w, acc[r][3]);
        }
      }
    }
  }

  if (split == 1) {  // bias and activation on the complete sum, in registers
    const int gc = col0 + 4 * tx;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = row0 + ty + 16 * r;
      if (gr >= M) continue;
      TX* o = out + static_cast<size_t>(gr) * N + gc;
      if constexpr (VEC_W) {  // N % 4 == 0: the four columns are all in or out
        if (gc < N) {
          const float4 bb = load4(b + gc);
          store4(o, make_float4(act_fwd(act, acc[r][0] + bb.x), act_fwd(act, acc[r][1] + bb.y),
                                act_fwd(act, acc[r][2] + bb.z), act_fwd(act, acc[r][3] + bb.w)));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < N) store(o + j, act_fwd(act, acc[r][j] + to_f32(b[gc + j])));
      }
    }
    return;
  }

  // the partial tile into this block's shared memory (the ring is free)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem4);  // BM x RED_PITCH floats
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(ty + 16 * r) * RED_PITCH + 4 * tx + j] = acc[r][j];
  cluster_reduce_rows<BM, BN, RED_PITCH, THREADS>(
      red, split, rank, [&](int r, int c, float sum) {
        const int gr = row0 + r, gc = col0 + c;
        if (gr < M && gc < N)
          store(out + static_cast<size_t>(gr) * N + gc, act_fwd(act, sum + to_f32(b[gc])));
      });
}

template <class TX, class TW, bool VEC_X, bool VEC_W, int BK>
cudaError_t launch(const TX* x, const TW* w, const TW* b, TX* out, int M, int K,
                   int N, int act, int split, cudaStream_t s) {
  auto kern = fcnn_fwd_kernel<TX, TW, VEC_X, VEC_W, BK>;
  const bool pairs_x = pair_rows(x, K), pairs_w = pair_rows(w, N);
  // allow clusters of 16 once per instantiation, outside any CUDA graph
  // capture that later launches are recorded into (every ring is below
  // 48 KB: no shared-memory opt-in)
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + BN - 1) / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<TX, TW, BK>();
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, x, w, b, out, M, K, N, act, pairs_x, pairs_w);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class TX, class TW, int BK>
cudaError_t fwd(const void* xv, const void* wv, const void* bv, void* outv,
                int M, int K, int N, int act, int split, cudaStream_t s) {
  const auto x = static_cast<const TX*>(xv);
  const auto w = static_cast<const TW*>(wv);
  const auto b = static_cast<const TW*>(bv);
  const auto out = static_cast<TX*>(outv);
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  // 16-byte rows of x; of w, with b and out read and written four at a time
  const bool vx = K % kChunk<TX, true> == 0 && !misaligned(x);
  const bool vw = N % kChunk<TW, true> == 0 && N % 4 == 0 && !misaligned(w) &&
                  !misaligned(b) && !misaligned(out);
  if (vx)
    return vw ? launch<TX, TW, true, true, BK>(x, w, b, out, M, K, N, act, split, s)
              : launch<TX, TW, true, false, BK>(x, w, b, out, M, K, N, act, split, s);
  return vw ? launch<TX, TW, false, true, BK>(x, w, b, out, M, K, N, act, split, s)
            : launch<TX, TW, false, false, BK>(x, w, b, out, M, K, N, act, split, s);
}

template <class TX, class TW>
cudaError_t fwd_typed(const void* x, const void* w, const void* b, void* out,
                      int M, int K, int N, int act, int split, int slice,
                      cudaStream_t s) {
  return slice == 16 ? fwd<TX, TW, 16>(x, w, b, out, M, K, N, act, split, s)
                     : fwd<TX, TW, 32>(x, w, b, out, M, K, N, act, split, s);
}

}  // namespace

// x (M, K), w (K, N), b (N,) -> out (M, N); x and out fp32, or bf16 where
// x_bf16; w and b fp32, or bf16 where w_bf16.  split in {1, 2, 4, 8, 16}
// blocks of a cluster share the contraction K in slices of `slice` (16 or
// 32)
cudaError_t launch_fcnn_fwd(const void* x, const void* w, const void* b,
                            void* out, int M, int K, int N, int act, int split,
                            int slice, int x_bf16, int w_bf16, cudaStream_t s) {
  if (M < 1 || K < 1 || N < 1 || split < 1 || split > MAX_SPLIT ||
      (split & (split - 1)) != 0 || (slice != 16 && slice != 32) ||
      act < kNone || act > kTanh || (N + BN - 1) / BN > 65535 ||
      (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return w_bf16 ? fwd_typed<bf16, bf16>(x, w, b, out, M, K, N, act, split, slice, s)
                  : fwd_typed<bf16, float>(x, w, b, out, M, K, N, act, split, slice, s);
  return w_bf16 ? fwd_typed<float, bf16>(x, w, b, out, M, K, N, act, split, slice, s)
                : fwd_typed<float, float>(x, w, b, out, M, K, N, act, split, slice, s);
}
