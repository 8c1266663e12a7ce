// FCNN backward-weights kernel for Hopper (sm_90a): dW = Xᵀ @ dZ and
// db = Σ_rows dZ, with dZ = dY * A'(Y).
//
// Replaces the TPU kernel fcnn_layer_wgrad (_wgrad_kernel) of
// src/repro/kernels/fcnn_layer.py.  x is (M, K), dY and Y (M, N), all
// row-major; dZ (act_deriv of fcnn_act.cuh, from the output Y) never exists
// in device memory.  x is fp32 or bf16, and so are dY and Y (one type),
// each read in its own type; dW takes x's type and db dY's, as the TPU
// kernel's.  dZ is formed in fp32 and the product and db's sum run in IEEE
// fp32 on the CUDA cores (the reference's dZ is fp32); a bf16 dW or db is
// rounded once, to nearest even, at the store.
//
// What bounds it on an H100: the contraction is the batch (64 or 128 in
// NN1-NN6) over many output tiles.  At NN1 a call is 4-100 MFLOP over
// 0.1-4.5 MB, a few µs of either peak, so latency bounds it; at NN5 (1
// GFLOP a layer) the fp32 FMAs and the re-reads of x, dY and Y (once per
// tile row or column) do.  The design:
//   * the batch in 32-row slices through a ring of cp.async stages, all
//     issued before the first is used: with the 64-row tiles a 64-row
//     batch is in flight at once and costs one exposed round trip; a
//     longer one walks the ring while the earlier slices are consumed.
//     The ring is as deep as leaves room for a second block on the SM
//     (one stage for the largest tile): at NN5 more resident blocks hide
//     the round trips better than a deeper ring.  Each thread forms dZ
//     from the elements it copied once they land (cp.async moves raw
//     bytes): in place for fp32 dY, into an fp32 slice of its own for
//     bf16 dY (dZ is not rounded to bf16);
//   * 16-byte copies of every operand where its rows allow (VEC_X where
//     K is a multiple of 16 bytes, VEC_Z where N is), else 4-byte ones:
//     one fp32 element, or a pair of bf16 ones (two guarded 2-byte loads
//     where the width is odd); x
//     needs no transpose, as a thread reads four neighbouring k of one
//     batch row as one float4 (8 bytes in bf16);
//   * a register micro-tile of 4 or 8 (k) x 8 (n) a thread, read as two or
//     three float4 a batch row (eight threads read one 128-byte row of
//     dZ: no bank conflicts), so FFMAs, not shared-memory loads, set the
//     pace; dW stored four elements at a time where N % 4 == 0;
//   * three tiles (Tile64/128/256 below), picked by the host from the
//     shape, the same for every type (fcnn_layer.py:wgrad_plan): small dW
//     keeps 64 x 64 tiles, four to an SM, so NN1's grids fill the card;
//     large dW takes bigger tiles, two to an SM, whose blocks read each
//     batch row of x, dY and Y fewer times;
//   * db deterministic without atomics: the blocks of dW's first row tile
//     also sum dZ's columns, so each db column is written by one block.
// Out-of-range rows and columns are zero-filled by the copies, which makes
// their x and dZ zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fcnn_act.cuh"
#include "fcnn_splitk.cuh"

namespace {

using namespace fcnn;  // act_deriv, copy_chunk, load4, store*, Map

constexpr int BMS = 32;  // batch rows of one stage

// A dW tile of BK rows x BN columns: 16 x BN / 8 threads, each with TK =
// BK / 16 rows (groups of four, 64 apart) by 8 columns (two groups of
// four, BN / 2 apart); a ring of STAGES 32-row slices of the batch.
template <int BK_, int BN_, int STAGES_>
struct Tile {
  static constexpr int BK = BK_, BN = BN_, STAGES = STAGES_;
  static constexpr int THREADS = 2 * BN;
  static constexpr int TK = BK / 16;
};
// the three tiles of fcnn_layer.py:wgrad_plan (fp32 ring sizes)
using Tile64 = Tile<64, 64, 2>;     // 128 threads, 4 x 8 each, 48 KB
using Tile128 = Tile<128, 64, 3>;   // 128 threads, 8 x 8 each, 96 KB
using Tile256 = Tile<128, 128, 1>;  // 256 threads, 8 x 8 each, 48 KB

// a stage: x slice [BMS][BK] | dY slice [BMS][BN] | Y [BMS][BN] | dZ
// [BMS][BN] fp32 where dY is bf16; every part a multiple of 16 bytes
template <class T, class TX, class TD>
__host__ __device__ constexpr int stage_bytes() {
  return BMS * (T::BK * static_cast<int>(sizeof(TX)) +
                2 * T::BN * static_cast<int>(sizeof(TD)) +
                (kZInPlace<TD> ? 0 : T::BN * 4));
}

// Two blocks to an SM, which holds a 256-thread block to 128 registers a
// thread; the 256-thread tile's scalar-copy instantiations (rows not
// 16-byte aligned) spill within that, so they ask for one.
template <class T, bool VEC_X, bool VEC_Z>
__host__ __device__ constexpr int min_blocks() {
  return T::THREADS < 256 || (VEC_X && VEC_Z) ? 2 : 1;
}

// grid (ceil(N / BN), ceil(K / BK))
template <class T, class TX, class TD, bool VEC_X, bool VEC_Z>
__global__ void __launch_bounds__(T::THREADS, (min_blocks<T, VEC_X, VEC_Z>()))
fcnn_wgrad_kernel(const TX* __restrict__ x, const TD* __restrict__ dy,
                  const TD* __restrict__ y, TX* __restrict__ dw,
                  TD* __restrict__ db, int M, int K, int N, int act,
                  bool pairs_x, bool pairs_z) {
  constexpr int BK = T::BK, BN = T::BN, TK = T::TK, STAGES = T::STAGES;
  constexpr int THREADS = T::THREADS, STAGE = stage_bytes<T, TX, TD>();
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const auto xs_of = [&](int s) { return reinterpret_cast<TX*>(smem + s * STAGE); };
  const auto zs_of = [&](int s) {
    return reinterpret_cast<TD*>(smem + s * STAGE + BMS * BK * sizeof(TX));
  };
  const auto ys_of = [&](int s) { return zs_of(s) + BMS * BN; };
  const auto zf_of = [&](int s) {
    return kZInPlace<TD> ? reinterpret_cast<float*>(zs_of(s))
                         : reinterpret_cast<float*>(ys_of(s) + BMS * BN);
  };

  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BK;
  const int t = threadIdx.x;
  const int tk = t / (BN / 8);  // dW rows 64g + 4tk + (0..3), g < TK / 4
  const int tn = t % (BN / 8);  // dW columns BN/2 h + 4tn + (0..3), h < 2
  const bool sum_db = blockIdx.y == 0 && t < BN;
  const int count = (M + BMS - 1) / BMS;

  using Xm = Map<kChunk<TX, VEC_X>, BK, BMS, THREADS>;
  using Zm = Map<kChunk<TD, VEC_Z>, BN, BMS, THREADS>;
  auto load = [&](int slice, int stage) {
    const int m0 = slice * BMS;
    TX* xs = xs_of(stage);
    TD* zs = zs_of(stage);
    TD* ys = ys_of(stage);
#pragma unroll
    for (int i = 0; i < Xm::kCount; ++i) {
      if (!Xm::has(t, i)) continue;
      const int r = Xm::row(t, i), c = Xm::col(t, i);
      const int gm = m0 + r, gk = row0 + c;
      const bool ok = gm < M && gk < K;
      const TX* src = x + (ok ? static_cast<size_t>(gm) * K + gk : 0);
      copy_chunk<TX, VEC_X>(&xs[r * BK + c], src, ok, gm < M && gk + 1 < K, pairs_x);
    }
#pragma unroll
    for (int i = 0; i < Zm::kCount; ++i) {
      if (!Zm::has(t, i)) continue;
      const int r = Zm::row(t, i), c = Zm::col(t, i);
      const int gm = m0 + r, gn = col0 + c;
      const bool ok = gm < M && gn < N;
      const bool ok_hi = gm < M && gn + 1 < N;
      const size_t off = ok ? static_cast<size_t>(gm) * N + gn : 0;
      copy_chunk<TD, VEC_Z>(&zs[r * BN + c], dy + off, ok, ok_hi, pairs_z);
      copy_chunk<TD, VEC_Z>(&ys[r * BN + c], y + off, ok, ok_hi, pairs_z);
    }
  };

  float acc[TK][8];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float dbsum = 0.f;

  // every stage's copies issued up front; one commit group a slice
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < count) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    const int stage = i % STAGES;
    cp_async_wait<STAGES - 1>();  // this thread's copies of slice i landed
    // dZ = dY * A'(Y) in fp32 over the elements this thread copied
    {
      const TD* zs = zs_of(stage);
      const TD* ys = ys_of(stage);
      float* zf = zf_of(stage);
#pragma unroll
      for (int e = 0; e < Zm::kCount; ++e) {
        if (!Zm::has(t, e)) continue;
        const int o = Zm::row(t, e) * BN + Zm::col(t, e);
#pragma unroll
        for (int c = 0; c < Zm::kWidth; ++c)
          zf[o + c] = to_f32(zs[o + c]) * act_deriv(act, to_f32(ys[o + c]));
      }
    }
    __syncthreads();  // slice i's dZ visible to all

    // batch rows of this slice, rounded up to 4 (the rest are zero-filled)
    const int rows = min(BMS, M - i * BMS);
    const float* zs = zf_of(stage);
    if (sum_db)
      for (int m = 0; m < rows; ++m) dbsum += zs[m * BN + t];
    const TX* xs = xs_of(stage);
    for (int m0 = 0; m0 < rows; m0 += 4) {
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int m = m0 + mm;
        float av[TK];
#pragma unroll
        for (int g = 0; g < TK / 4; ++g) {
          const float4 a = load4(&xs[m * BK + 64 * g + 4 * tk]);
          av[4 * g] = a.x;
          av[4 * g + 1] = a.y;
          av[4 * g + 2] = a.z;
          av[4 * g + 3] = a.w;
        }
        const float4 z0 = *reinterpret_cast<const float4*>(&zs[m * BN + 4 * tn]);
        const float4 z1 = *reinterpret_cast<const float4*>(&zs[m * BN + BN / 2 + 4 * tn]);
        const float zv[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
        for (int r = 0; r < TK; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[r], zv[j], acc[r][j]);
      }
    }
    if (i + STAGES < count) {  // more batch than the ring holds: refill
      __syncthreads();         // every thread is done with this stage
      load(i + STAGES, stage);
    }
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < TK; ++r) {
    const int gk = row0 + 64 * (r / 4) + 4 * tk + r % 4;
    if (gk >= K) continue;
    TX* o = dw + static_cast<size_t>(gk) * N + col0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = BN / 2 * h + 4 * tn;
      if constexpr (VEC_Z) {  // N % 4 == 0: the four columns are all in or out
        if (col0 + c < N)
          store4(o + c, make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                                    acc[r][4 * h + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col0 + c + j < N) store(o + c + j, acc[r][4 * h + j]);
      }
    }
  }
  if (sum_db && col0 + t < N) store(db + col0 + t, dbsum);
}

template <class T, class TX, class TD, bool VEC_X, bool VEC_Z>
cudaError_t launch(const TX* x, const TD* dy, const TD* y, TX* dw, TD* db, int M,
                   int K, int N, int act, cudaStream_t s) {
  auto kern = fcnn_wgrad_kernel<T, TX, TD, VEC_X, VEC_Z>;
  constexpr int stage = stage_bytes<T, TX, TD>();
  // opt in to the full ring (above 48 KB) once per instantiation, outside
  // any CUDA graph capture that later launches are recorded into
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::STAGES * stage);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // a short batch never reaches the later stages
  const int slices = (M + BMS - 1) / BMS;
  const int stages = slices < T::STAGES ? slices : T::STAGES;
  const dim3 grid((N + T::BN - 1) / T::BN, (K + T::BK - 1) / T::BK);
  fcnn_wgrad_kernel<T, TX, TD, VEC_X, VEC_Z><<<grid, T::THREADS, stages * stage, s>>>(
      x, dy, y, dw, db, M, K, N, act, pair_rows(x, K), pair_rows(dy, N) && pair_rows(y, N));
  return cudaGetLastError();
}

template <class T, class TX, class TD>
cudaError_t wgrad(const void* xv, const void* dyv, const void* yv, void* dwv,
                  void* dbv, int M, int K, int N, int act, cudaStream_t s) {
  if ((K + T::BK - 1) / T::BK > 65535) return cudaErrorInvalidValue;
  const auto x = static_cast<const TX*>(xv);
  const auto dy = static_cast<const TD*>(dyv);
  const auto y = static_cast<const TD*>(yv);
  const auto dw = static_cast<TX*>(dwv);
  const auto db = static_cast<TD*>(dbv);
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  // 16-byte rows of x; of dY and Y, with dW written four at a time
  const bool vx = K % kChunk<TX, true> == 0 && !misaligned(x);
  const bool vz = N % kChunk<TD, true> == 0 && N % 4 == 0 && !misaligned(dy) &&
                  !misaligned(y) && !misaligned(dw);
  if (vx)
    return vz ? launch<T, TX, TD, true, true>(x, dy, y, dw, db, M, K, N, act, s)
              : launch<T, TX, TD, true, false>(x, dy, y, dw, db, M, K, N, act, s);
  return vz ? launch<T, TX, TD, false, true>(x, dy, y, dw, db, M, K, N, act, s)
            : launch<T, TX, TD, false, false>(x, dy, y, dw, db, M, K, N, act, s);
}

template <class TX, class TD>
cudaError_t wgrad_typed(const void* x, const void* dy, const void* y, void* dw,
                        void* db, int M, int K, int N, int act, int tile_rows,
                        int tile_cols, cudaStream_t s) {
  if (tile_rows == 64 && tile_cols == 64)
    return wgrad<Tile64, TX, TD>(x, dy, y, dw, db, M, K, N, act, s);
  if (tile_rows == 128 && tile_cols == 64)
    return wgrad<Tile128, TX, TD>(x, dy, y, dw, db, M, K, N, act, s);
  if (tile_rows == 128 && tile_cols == 128)
    return wgrad<Tile256, TX, TD>(x, dy, y, dw, db, M, K, N, act, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, K), dy, y (M, N) -> dw (K, N), db (N,); x and dw fp32, or bf16
// where x_bf16; dy, y and db fp32, or bf16 where dy_bf16; dW in tiles of
// tile_rows x tile_cols: 64 x 64, 128 x 64 or 128 x 128
cudaError_t launch_fcnn_wgrad(const void* x, const void* dy, const void* y,
                              void* dw, void* db, int M, int K, int N, int act,
                              int tile_rows, int tile_cols, int x_bf16,
                              int dy_bf16, cudaStream_t s) {
  if (M < 1 || K < 1 || N < 1 || act < kNone || act > kTanh)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return dy_bf16 ? wgrad_typed<bf16, bf16>(x, dy, y, dw, db, M, K, N, act,
                                             tile_rows, tile_cols, s)
                   : wgrad_typed<bf16, float>(x, dy, y, dw, db, M, K, N, act,
                                              tile_rows, tile_cols, s);
  return dy_bf16 ? wgrad_typed<float, bf16>(x, dy, y, dw, db, M, K, N, act,
                                            tile_rows, tile_cols, s)
                 : wgrad_typed<float, float>(x, dy, y, dw, db, M, K, N, act,
                                             tile_rows, tile_cols, s);
}
