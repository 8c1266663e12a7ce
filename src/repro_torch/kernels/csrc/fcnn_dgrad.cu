// FCNN backward-data kernel for Hopper (sm_90a): dX = (dY * A'(Y)) @ W^T.
//
// Replaces the TPU kernel fcnn_layer_dgrad (_dgrad_kernel) of
// src/repro/kernels/fcnn_layer.py.  dY, Y are (M, N), W is (K, N) and read
// in place as W^T (w[k * N + n]); dZ = dY * A'(Y) (act_deriv of
// fcnn_act.cuh, from the output Y) never exists in device memory.  dY and
// Y are fp32 or bf16 (one type), W fp32 or bf16, each read in its own
// type; dX takes dY's type, as the TPU kernel's.  dZ is formed in fp32
// and the product runs in IEEE fp32 on the CUDA cores, whatever the types
// (the reference's dZ is fp32, so the product is an fp32 one even for bf16
// operands; TF32 keeps about three digits and fails the 1e-4 bar); a bf16
// dX is rounded once, to nearest even, after the split-K sum.
//
// What bounds it on an H100: at NN1's layer 2 (M = 64, K = 1000, N = 500)
// the call is 64 MFLOP over 2.3 MB, ~1 µs at the fp32 peak, ~0.7 µs at
// 3.35 TB/s.  A 64-row batch cut into 64 x 64 tiles gives 16 blocks on 132
// SMs, each walking the whole contraction with one exposed global-memory
// round trip per slice: the kernel is bound by latency and occupancy, not
// by either peak.  The design attacks both:
//   * smaller tiles (64 x 32, 128 threads, 4 x 4 outputs each) and a
//     split of the contraction N over the blocks of a thread-block cluster
//     (at most 8, the portable size), so the grid fills the 132 SMs with
//     up to two blocks each; the host picks the split and the slice width
//     (16 or 32) from (M, K, N), the same for every type
//     (fcnn_layer.py:dgrad_plan);
//   * a 3-stage cp.async ring of contraction slices, so the loads of later
//     slices are in flight while the FMAs of the current one run.
//     cp.async copies raw bytes, so each thread turns the dY elements it
//     copied into dZ once they land, before the block's barrier: in place
//     for fp32 dY, into an fp32 slice of its own for bf16 dY (dZ is not
//     rounded to bf16);
//   * the partial tiles of a cluster are summed through distributed shared
//     memory in rank order 0, 1, ..., split - 1: rank r sums and writes
//     rows [r·64/split, (r+1)·64/split) of the tile.  One launch, no atomics,
//     no workspace, and repeated calls give bit-identical dX.
// Rows that are not 16-byte aligned (N = 10, or N = 500 in bf16) take
// 4-byte copies, one fp32 element or a pair of bf16 ones (two guarded
// 2-byte loads where N is odd): the VEC template flag, chosen by the host
// from the shape.
// Out-of-range rows and columns are zero-filled by the copies, which makes
// their dZ and W zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fcnn_act.cuh"
#include "fcnn_splitk.cuh"

namespace {

using namespace fcnn;  // Act, act_deriv, copy_chunk, load4, store, Map, cluster_reduce_rows

constexpr int BM = 64;         // dX tile rows (batch)
constexpr int BK = 32;         // dX tile columns (rows of W)
constexpr int STAGES = 3;
constexpr int THREADS = 128;   // 8 x 16 threads, 4 x 4 outputs each
constexpr int RED_PITCH = BK + 1;
constexpr int MAX_SPLIT = 8;

// a row of a slice in the ring: BN elements of T and 16 bytes of padding,
// so rows stay 16-byte aligned and the 16- and 8-byte reads conflict-free
template <class T, int BN>
__host__ __device__ constexpr int pitch() {
  return BN + 16 / static_cast<int>(sizeof(T));
}

// the ring: STAGES x (dY | Y | W | dZ where dY is bf16) slices
template <class TD, class TW, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (2 * BM * pitch<TD, BN>() * static_cast<int>(sizeof(TD)) +
                   BK * pitch<TW, BN>() * static_cast<int>(sizeof(TW)) +
                   (kZInPlace<TD> ? 0 : BM * pitch<float, BN>() * 4));
}

// grid (split, ceil(K / BK), ceil(M / BM)), clusters of (split, 1, 1);
// BN: the contraction slice of one stage.  The minimum of one block per SM
// lets ptxas take the registers it needs: without it, it held the VEC
// instantiations to 64 registers and spilled in one of them.
template <class TD, class TW, int ACT, bool VEC, int BN>
__global__ void __launch_bounds__(THREADS, 1)
dgrad_kernel(const TD* __restrict__ dy, const TD* __restrict__ y,
             const TW* __restrict__ w, TD* __restrict__ dx, int M, int K,
             int N, bool pairs) {
  constexpr int PD = pitch<TD, BN>(), PW = pitch<TW, BN>(), PF = pitch<float, BN>();
  extern __shared__ float4 smem4[];
  auto Zs = reinterpret_cast<TD (*)[BM * PD]>(smem4);
  auto Ys = Zs + STAGES;
  auto Ws = reinterpret_cast<TW (*)[BK * PW]>(Ys + STAGES);
  auto Zf = kZInPlace<TD> ? reinterpret_cast<float (*)[BM * PF]>(smem4)
                          : reinterpret_cast<float (*)[BM * PF]>(Ws + STAGES);
  static_assert(BM * RED_PITCH * static_cast<int>(sizeof(float)) <=
                    smem_bytes<TD, TW, BN>(),
                "partials fit in the ring");

  const int split = gridDim.x;
  const int rank = blockIdx.x;  // the block's rank in its cluster
  const int col0 = blockIdx.y * BK;
  const int row0 = blockIdx.z * BM;
  const int t = threadIdx.x;
  const int tx = t % 8;   // columns tx + 8j
  const int ty = t / 8;   // rows ty + 16i

  // this rank's contraction slices: an even share, possibly none
  const int n_slices = (N + BN - 1) / BN;
  const int s_begin = rank * n_slices / split;
  const int count = (rank + 1) * n_slices / split - s_begin;

  using Z = Map<kChunk<TD, VEC>, BN, BM, THREADS>;
  using Wm = Map<kChunk<TW, VEC>, BN, BK, THREADS>;
  auto load = [&](int slice, int stage) {
    const int n0 = (s_begin + slice) * BN;
#pragma unroll
    for (int i = 0; i < Z::kCount; ++i) {
      if (!Z::has(t, i)) continue;
      const int r = Z::row(t, i), c = Z::col(t, i);
      const int gr = row0 + r, gn = n0 + c;
      const bool ok = gr < M && gn < N;
      const bool ok_hi = gr < M && gn + 1 < N;
      const size_t off = ok ? static_cast<size_t>(gr) * N + gn : 0;
      copy_chunk<TD, VEC>(&Zs[stage][r * PD + c], dy + off, ok, ok_hi, pairs);
      copy_chunk<TD, VEC>(&Ys[stage][r * PD + c], y + off, ok, ok_hi, pairs);
    }
    // W tile: BK rows of W (columns of dX) x BN contraction entries
#pragma unroll
    for (int i = 0; i < Wm::kCount; ++i) {
      if (!Wm::has(t, i)) continue;
      const int r = Wm::row(t, i), c = Wm::col(t, i);
      const int gk = col0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      const TW* src = w + (ok ? static_cast<size_t>(gk) * N + gn : 0);
      copy_chunk<TW, VEC>(&Ws[stage][r * PW + c], src, ok, gk < K && gn + 1 < N, pairs);
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
    // dZ = dY * A'(Y) in fp32 over the elements this thread copied
#pragma unroll
    for (int e = 0; e < Z::kCount; ++e) {
      if (!Z::has(t, e)) continue;
      const int r = Z::row(t, e), c = Z::col(t, e);
      const TD* z = &Zs[stage][r * PD + c];
      const TD* yy = &Ys[stage][r * PD + c];
      float* zf = &Zf[stage][r * PF + c];
#pragma unroll
      for (int cc = 0; cc < Z::kWidth; ++cc)
        zf[cc] = to_f32(z[cc]) * act_deriv<ACT>(to_f32(yy[cc]));
    }
    // slice i visible to all; every thread is done with slice i - 1's stage
    __syncthreads();
    if (i + STAGES - 1 < count) load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* zs = Zf[stage];
    const TW* ws = Ws[stage];
#pragma unroll
    for (int n = 0; n < BN; n += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(&zs[(ty + 16 * r) * PF + n]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = load4(&ws[(tx + 8 * j) * PW + n]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = acc[r][j];
          v = fmaf(a[r].x, b[j].x, v);
          v = fmaf(a[r].y, b[j].y, v);
          v = fmaf(a[r].z, b[j].z, v);
          v = fmaf(a[r].w, b[j].w, v);
          acc[r][j] = v;
        }
    }
  }

  if (split == 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gr = row0 + ty + 16 * r, gc = col0 + tx + 8 * j;
        if (gr < M && gc < K) store(dx + static_cast<size_t>(gr) * K + gc, acc[r][j]);
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
    for (int j = 0; j < 4; ++j) red[(ty + 16 * r) * RED_PITCH + tx + 8 * j] = acc[r][j];
  cluster_reduce_rows<BM, BK, RED_PITCH, THREADS>(
      red, split, rank, [&](int r, int c, float sum) {
        const int gr = row0 + r, gc = col0 + c;
        if (gr < M && gc < K) store(dx + static_cast<size_t>(gr) * K + gc, sum);
      });
}

template <class TD, class TW, int ACT, bool VEC, int BN>
cudaError_t launch(const TD* dy, const TD* y, const TW* w, TD* dx, int M, int K,
                   int N, int split, cudaStream_t s) {
  auto kern = dgrad_kernel<TD, TW, ACT, VEC, BN>;
  constexpr int smem = smem_bytes<TD, TW, BN>();
  const bool pairs = pair_rows(dy, N) && pair_rows(y, N) && pair_rows(w, N);
  // opt in once per instantiation (above 48 KB for BN = 32), outside any
  // CUDA graph capture that later launches are recorded into
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (K + BK - 1) / BK, (M + BM - 1) / BM);
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, dy, y, w, dx, M, K, N, pairs);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class TD, class TW, int ACT>
cudaError_t dgrad(const void* dyv, const void* yv, const void* wv, void* dxv,
                  int M, int K, int N, int split, int slice, cudaStream_t s) {
  const auto dy = static_cast<const TD*>(dyv);
  const auto y = static_cast<const TD*>(yv);
  const auto w = static_cast<const TW*>(wv);
  const auto dx = static_cast<TD*>(dxv);
  // 16-byte rows of dY, Y and W (dX is written an element at a time)
  const bool vec = N % kChunk<TD, true> == 0 && N % kChunk<TW, true> == 0 &&
                   ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(w)) % 16) == 0;
  if (slice == 16)
    return vec ? launch<TD, TW, ACT, true, 16>(dy, y, w, dx, M, K, N, split, s)
               : launch<TD, TW, ACT, false, 16>(dy, y, w, dx, M, K, N, split, s);
  return vec ? launch<TD, TW, ACT, true, 32>(dy, y, w, dx, M, K, N, split, s)
             : launch<TD, TW, ACT, false, 32>(dy, y, w, dx, M, K, N, split, s);
}

template <class TD, class TW>
cudaError_t dgrad_typed(const void* dy, const void* y, const void* w, void* dx,
                        int M, int K, int N, int act, int split, int slice,
                        cudaStream_t s) {
  switch (act) {
    case kSigmoid: return dgrad<TD, TW, kSigmoid>(dy, y, w, dx, M, K, N, split, slice, s);
    case kRelu: return dgrad<TD, TW, kRelu>(dy, y, w, dx, M, K, N, split, slice, s);
    case kTanh: return dgrad<TD, TW, kTanh>(dy, y, w, dx, M, K, N, split, slice, s);
    case kNone: return dgrad<TD, TW, kNone>(dy, y, w, dx, M, K, N, split, slice, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dy, y (M, N), w (K, N) -> dx (M, K); dy, y and dx fp32, or bf16 where
// dy_bf16; w fp32, or bf16 where w_bf16.  split in {1, 2, 4, 8} blocks of a
// cluster share the contraction N in slices of `slice` (16 or 32)
cudaError_t launch_fcnn_dgrad(const void* dy, const void* y, const void* w,
                              void* dx, int M, int K, int N, int act, int split,
                              int slice, int dy_bf16, int w_bf16, cudaStream_t s) {
  if (M < 1 || K < 1 || N < 1 || split < 1 || split > MAX_SPLIT ||
      (slice != 16 && slice != 32) ||
      (split & (split - 1)) != 0 || (K + BK - 1) / BK > 65535 ||
      (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (dy_bf16)
    return w_bf16 ? dgrad_typed<bf16, bf16>(dy, y, w, dx, M, K, N, act, split, slice, s)
                  : dgrad_typed<bf16, float>(dy, y, w, dx, M, K, N, act, split, slice, s);
  return w_bf16 ? dgrad_typed<float, bf16>(dy, y, w, dx, M, K, N, act, split, slice, s)
                : dgrad_typed<float, float>(dy, y, w, dx, M, K, N, act, split, slice, s);
}
