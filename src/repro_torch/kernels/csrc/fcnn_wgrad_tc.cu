// FCNN backward-weights kernel on Hopper's tensor cores (sm_90a) for bf16
// activations: dW = Xᵀ (dY ⊙ A'(Y)) and db = Σ_rows dY ⊙ A'(Y).
//
// Replaces the TPU kernel fcnn_layer_wgrad (_wgrad_kernel) of
// src/repro/kernels/fcnn_layer.py where x is bf16: case (a), bf16 data in a
// bf16 network, and case (d), bf16 data in an fp32 network, with dY and Y
// bf16 or fp32 (one type TD).  fcnn_wgrad.cu keeps fp32 x (cases (b), (c))
// on the CUDA cores.  x is (M, K), dY and Y (M, N), all row-major; dW (K, N)
// takes x's type (bf16), db (N,) dY's.
//
// The products.  dZ = dY ⊙ A'(Y) is fp32 in the reference (act_deriv of
// fcnn_act.cuh, from the output Y), so dW is a bf16 × fp32 product, and
// rounding dZ to bf16 would move each term by up to 2^-9.  dZ never exists
// in device memory: each thread forms it in fp32 from the staged dY and Y
// at its wgmma fragment, splits it into hi = bf16(dZ) and lo = bf16(dZ −
// hi) and issues two register-A wgmmas against the same X: hi·X + lo·X
// misses dZ·X by at most 2^-17 of it (x is bf16, exact).  db is summed from
// the fp32 dZ itself.  dW is rounded to bf16 once, after the cluster's sum.
//
// What bounds it on an H100.  The contraction is the batch (64 or 128 in
// NN1-NN6).  At NN5 (batch 128) a layer's two products are 2 GFLOP, 2 µs
// at the bf16 peak, against 2.8-3.1 µs of HBM bytes, most of them the 8 MB
// bf16 dW: bytes.  At NN1 (batch 64) a call is at most 0.2 GFLOP over 1.9
// MB: a launch's latency and one exposed copy of each slice bind it.
//
// Design.  The kernel computes the transpose, dWᵀ = dZᵀ · X, so that dZ,
// which the threads form, is the register A operand, and X the B operand
// from shared memory.  One warpgroup (128 threads) a block computes a 64 x
// BN tile of dWᵀ: 64 columns of dW (n) by BN = 64 or 128 rows of dW (k), a
// template parameter the host plan picks (fcnn_layer.py:wgrad_tc_plan), so
// every wgmma chain has a compile-time length.  The batch is split over the
// blocks of a cluster (up to 16) in slices of 64 rows, staged by cp.async in
// a ring of 3 to 8 stages (fcnn_tc::ring_stages), of which a launch takes
// only as many as a rank has slices, and no fewer than the epilogue needs
// (at a batch of 64 or 128, one or two: every slice in flight at once, and
// room for two blocks an SM): X's slice as it lies, [m][k], which is
// the B operand MN-major (the transpose bit), in 128-byte-swizzled atoms of
// 64 columns; dY's and Y's as padded rows [m][n] in their own type, which
// the threads read at transposed positions (a fragment pair is two batch
// rows of one n): the pitch, 68 fp32 or 72 bf16 elements, keeps each row
// 16-byte aligned and puts a warp's reads (8 n by 4 batch rows) on
// distinct banks.  Rows that are not 16-byte multiples (500 or odd widths)
// take 4-byte or 2-byte copies, so TMA, which needs 16-byte strides, is not
// used.  The cluster's partial tiles are summed in rank order through
// distributed shared memory (fcnn_tc::finish); the sum is written, rounded,
// into a [k][n] tile in the ring's shared memory (free once the products
// retire) and leaves it 16 bytes a thread along dW's rows, so the stores
// are coalesced.  db: the blocks of dW's first row tile sum their dZ, each
// thread over its fragments, then over the four lanes of a quad by
// shuffles, then over the cluster's ranks in order; no atomics, and
// repeated calls give bit-identical dW and db.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fcnn_act.cuh"
#include "fcnn_tc.cuh"

namespace {

using namespace fcnn_tc;
using fcnn::copy_chunk;
using fcnn::kChunk;

// elements a row of the staged dY and Y slices: BM columns and a pad (see
// the design note above)
template <class TD>
constexpr int kZPitch = sizeof(TD) == 4 ? BM + 4 : BM + 8;

// One stage of the ring: X's slice (SLICE batch rows of BN bf16, in atoms
// of 64 columns) and dY's and Y's (SLICE padded rows of TD), each a
// multiple of 1024 bytes, plus 1024 bytes to align the ring.  After the
// products the ring holds the cluster's partials (kRed bytes, finish) and
// then the rounded tile of dW, BN rows of BM bf16 and a pad.
template <class TD, int BN>
struct Layout {
  static constexpr int kB = SLICE * BN * 2;
  static constexpr int kZ = SLICE * kZPitch<TD> * static_cast<int>(sizeof(TD));
  static constexpr int kStage = kB + 2 * kZ;
  static constexpr int kStages = ring_stages(kStage);
  static constexpr int kSmem = kStages * kStage + 1024;
  static constexpr int kRed = BM * (BN + 8) * 4;
  static constexpr int kOutPitch = BM + 8;
  // stages the epilogue's partials and dW tile take
  static constexpr int kEpiStages = (kRed + BN * kOutPitch * 2 + kStage - 1) / kStage;
  static_assert(kB % 1024 == 0 && kZ % 1024 == 0, "swizzle-aligned tiles");
  static_assert(kRed + BN * kOutPitch * 2 <= kStages * kStage, "epilogue fits in the ring");
};

// where element (m, k) of X's slice lies in its stage: atom k / 64, each
// SLICE rows of 128 bytes, swizzled
template <int BN>
__device__ __forceinline__ uint32_t x_offset(int m, int k) {
  return (k >> 6) * (SLICE * 128) + sw128(m, k & 63);
}

// grid (split, ceil(K / BN), ceil(N / BM)), clusters of (split, 1, 1)
template <class TD, int ACT, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fcnn_wgrad_tc_kernel(const bf16* __restrict__ x, const TD* __restrict__ dy,
                     const TD* __restrict__ y, bf16* __restrict__ dw, TD* __restrict__ db,
                     int M, int K, int N, bool pairs_x, bool pairs_z, bool vec_out,
                     bool pairs_out) {
  using L = Layout<TD, BN>;
  constexpr int P = kZPitch<TD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_u32(smem);

  const int split = gridDim.x;
  const int rank = blockIdx.x;     // the block's rank in its cluster
  const int k0 = blockIdx.y * BN;  // rows of dW (columns of the tile)
  const int n0 = blockIdx.z * BM;  // columns of dW (rows of the tile)
  const int t = threadIdx.x;

  // this rank's batch slices: an even share, possibly none
  const int n_slices = (M + SLICE - 1) / SLICE;
  const int s_begin = rank * n_slices / split;
  const int count = (rank + 1) * n_slices / split - s_begin;

  auto load = [&](int slice, int stage) {
    uint8_t* xs = smem + stage * L::kStage;
    TD* zs = reinterpret_cast<TD*>(xs + L::kB);
    const int m0 = (s_begin + slice) * SLICE;
    for_chunks<SLICE, BN, kChunk<bf16, VEC>>([&](int r, int c) {
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < K;
      const bf16* src = x + (ok ? static_cast<size_t>(gm) * K + gk : 0);
      copy_chunk<bf16, VEC>(reinterpret_cast<bf16*>(xs + x_offset<BN>(r, c)), src, ok,
                            gm < M && gk + 1 < K, pairs_x);
    });
    for_chunks<SLICE, BM, kChunk<TD, VEC>>([&](int r, int c) {
      const int gm = m0 + r, gn = n0 + c;
      const bool ok = gm < M && gn < N;
      const bool ok_hi = gm < M && gn + 1 < N;
      const size_t off = ok ? static_cast<size_t>(gm) * N + gn : 0;
      TD* z = zs + r * P + c;
      copy_chunk<TD, VEC>(z, dy + off, ok, ok_hi, pairs_z);
      copy_chunk<TD, VEC>(z + SLICE * P, y + off, ok, ok_hi, pairs_z);
    });
  };

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  // this thread's fragment rows r0 and r0 + 8 (columns n0 + r0 (+ 8) of
  // dW), columns cin, cin + 1 (+ 8) (batch rows of a k16 step)
  const int lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;
  const int cin = 2 * (lane % 4);
  float dbs[2] = {0.f, 0.f};  // this thread's dZ summed at its two columns

  tc::fence_regs(acc);
  mainloop<L::kStages>(count, load, [&](int stage) {
    const uint32_t xa = sbase + stage * L::kStage;
    const TD* zs = reinterpret_cast<const TD*>(smem + stage * L::kStage + L::kB);
    const TD* ys = zs + SLICE * P;
    // dZᵀ in fp32 at this thread's fragment: (n, m) and (n, m + 1) for n =
    // r0 + 8 (q % 2), m = 16 kk + cin + 8 (q / 2), split hi/lo
    uint32_t hi[SLICE / 16][4], lo[SLICE / 16][4];
#pragma unroll
    for (int kk = 0; kk < SLICE / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int off = (16 * kk + cin + 8 * (q >> 1)) * P + r0 + 8 * (q & 1);
        const float z0 = fcnn::to_f32(zs[off]) * fcnn::act_deriv<ACT>(fcnn::to_f32(ys[off]));
        const float z1 =
            fcnn::to_f32(zs[off + P]) * fcnn::act_deriv<ACT>(fcnn::to_f32(ys[off + P]));
        dbs[q & 1] += z0;
        dbs[q & 1] += z1;
        split_pack(make_float2(z0, z1), hi[kk][q], lo[kk][q]);
      }
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < SLICE / 16; ++kk) {
      // X's batch rows 16 kk .. 16 kk + 15; atoms of 64 columns SLICE·128
      // bytes apart
      const uint64_t d = tc::desc_sw128(xa + kk * 16 * 128, SLICE * 128);
      mma_rs<BN, 1>(acc, hi[kk], d);
      mma_rs<BN, 1>(acc, lo[kk], d);
    }
    tc::wg_commit();
    tc::wg_wait_all();
    tc::fence_regs(acc);
  });

  // db, in the blocks of dW's first row tile: each column's sum over the
  // quad that holds it, in a fixed order (every lane gets the same bits),
  // then rank 0 sums the ranks' in rank order
  __shared__ float db_part[BM];
  if (blockIdx.y == 0) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 1);
      dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 2);
    }
    if (lane % 4 == 0) {
      db_part[r0] = dbs[0];
      db_part[r0 + 8] = dbs[1];
    }
    if (split > 1) cluster.sync();  // every rank's part written
    else __syncthreads();
    if (rank == 0 && t < BM && n0 + t < N) {
      float sum = 0.f;
      for (int q = 0; q < split; ++q)
        sum += (split > 1 ? cluster.map_shared_rank(db_part, q) : db_part)[t];
      fcnn::store(db + n0 + t, sum);
    }
    // the other ranks' parts stay alive until finish's cluster.sync
  }

  bf16* out = reinterpret_cast<bf16*>(smem + L::kRed);
  __syncthreads();  // every thread's reads of the ring are done
  finish<BN>(acc, smem, split, rank, r0, cin, [&](int r, int c, float v0, float v1) {
    out[c * L::kOutPitch + r] = __float2bfloat16_rn(v0);
    out[(c + 1) * L::kOutPitch + r] = __float2bfloat16_rn(v1);
  });
  __syncthreads();

  // this rank's columns of dW, [rank·BM/split, (rank+1)·BM/split) of the
  // tile, along dW's rows: 16 bytes a thread where N % 8 == 0, else pairs
  const int cols = BM / split, c0 = rank * cols;
  if (vec_out && cols % 8 == 0) {
    const int per = cols / 8;
    for (int i = t; i < BN * per; i += THREADS) {
      const int k = i / per, c = c0 + 8 * (i % per);
      const int gk = k0 + k, gn = n0 + c;
      if (gk < K && gn < N)
        *reinterpret_cast<uint4*>(dw + static_cast<size_t>(gk) * N + gn) =
            *reinterpret_cast<const uint4*>(out + k * L::kOutPitch + c);
    }
  } else {
    const int per = cols / 2;
    for (int i = t; i < BN * per; i += THREADS) {
      const int k = i / per, c = c0 + 2 * (i % per);
      const int gk = k0 + k, gn = n0 + c;
      if (gk < K && gn < N) {
        bf16* p = dw + static_cast<size_t>(gk) * N + gn;
        const bf16* v = out + k * L::kOutPitch + c;
        if (pairs_out) {
          *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(v);
        } else {
          p[0] = v[0];
          if (gn + 1 < N) p[1] = v[1];
        }
      }
    }
  }
}

template <class TD, int ACT, int BN, bool VEC>
cudaError_t launch(const bf16* x, const TD* dy, const TD* y, bf16* dw, TD* db, int M,
                   int K, int N, int split, cudaStream_t s) {
  using L = Layout<TD, BN>;
  auto kern = fcnn_wgrad_tc_kernel<TD, ACT, BN, VEC>;
  // the ring's stages this launch touches: mainloop uses stage s < count
  // only where a rank's count of slices is under kStages
  const int per_rank = ((M + SLICE - 1) / SLICE + split - 1) / split;
  const int stages = per_rank > L::kEpiStages ? per_rank : L::kEpiStages;
  const int smem = (stages < L::kStages ? stages : L::kStages) * L::kStage + 1024;
  const bool pairs_x = fcnn::pair_rows(x, K);
  const bool pairs_z = fcnn::pair_rows(dy, N) && fcnn::pair_rows(y, N);
  // dW's rows take 16-byte stores, or 4-byte pairs
  const bool vec_out = N % 8 == 0 && reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  const bool pairs_out = fcnn::pair_rows(dw, N);
  // opt in once per instantiation (above 48 KB of shared memory, clusters
  // of 16), outside any CUDA graph capture later launches are recorded into
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (K + BN - 1) / BN, (N + BM - 1) / BM);
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, x, dy, y, dw, db, M, K, N, pairs_x,
                                             pairs_z, vec_out, pairs_out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class TD, int ACT, int BN>
cudaError_t wgrad(const void* xv, const void* dyv, const void* yv, void* dwv, void* dbv,
                  int M, int K, int N, int split, cudaStream_t s) {
  const auto x = static_cast<const bf16*>(xv);
  const auto dy = static_cast<const TD*>(dyv);
  const auto y = static_cast<const TD*>(yv);
  const auto dw = static_cast<bf16*>(dwv);
  const auto db = static_cast<TD*>(dbv);
  // 16-byte rows of X, dY and Y
  const bool vec = K % kChunk<bf16, true> == 0 && N % kChunk<TD, true> == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                     reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  return vec ? launch<TD, ACT, BN, true>(x, dy, y, dw, db, M, K, N, split, s)
             : launch<TD, ACT, BN, false>(x, dy, y, dw, db, M, K, N, split, s);
}

template <class TD, int ACT>
cudaError_t wgrad_width(const void* x, const void* dy, const void* y, void* dw, void* db,
                        int M, int K, int N, int width, int split, cudaStream_t s) {
  switch (width) {
    case 64: return wgrad<TD, ACT, 64>(x, dy, y, dw, db, M, K, N, split, s);
    case 128: return wgrad<TD, ACT, 128>(x, dy, y, dw, db, M, K, N, split, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class TD>
cudaError_t wgrad_typed(const void* x, const void* dy, const void* y, void* dw, void* db,
                        int M, int K, int N, int act, int width, int split, cudaStream_t s) {
  using namespace fcnn;  // Act
  switch (act) {
    case kSigmoid: return wgrad_width<TD, kSigmoid>(x, dy, y, dw, db, M, K, N, width, split, s);
    case kRelu: return wgrad_width<TD, kRelu>(x, dy, y, dw, db, M, K, N, width, split, s);
    case kTanh: return wgrad_width<TD, kTanh>(x, dy, y, dw, db, M, K, N, width, split, s);
    case kNone: return wgrad_width<TD, kNone>(x, dy, y, dw, db, M, K, N, width, split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) bf16, dy, y (M, N) -> dw (K, N) bf16, db (N,); dy, y and db bf16
// where dy_bf16, else fp32.  dWᵀ tiles 64 x `width` (64 or 128); split in
// {1, 2, 4, 8, 16} blocks of a cluster share the batch M in slices of 64
cudaError_t launch_fcnn_wgrad_tc(const void* x, const void* dy, const void* y, void* dw,
                                 void* db, int M, int K, int N, int act, int width,
                                 int split, int dy_bf16, cudaStream_t s) {
  if (M < 1 || K < 1 || N < 1 || split < 1 || split > MAX_SPLIT ||
      (split & (split - 1)) != 0 || width < 64 || (K + width - 1) / width > 65535 ||
      (N + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  return dy_bf16 ? wgrad_typed<bf16>(x, dy, y, dw, db, M, K, N, act, width, split, s)
                 : wgrad_typed<float>(x, dy, y, dw, db, M, K, N, act, width, split, s);
}
