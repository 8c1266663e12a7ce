// FCNN period kernels for Hopper (sm_90a): forward and wgrad.
//
// Replaces the TPU kernels of src/repro/kernels/fcnn_layer.py:
//   fcnn_layer        (_fwd_kernel)    -> launch_fcnn_fwd    act(x @ w + b)
//   fcnn_layer_wgrad  (_wgrad_kernel)  -> launch_fcnn_wgrad  dW = X^T @ dZ, db = sum_rows dZ
// (fcnn_layer_dgrad has a kernel of its own, fcnn_dgrad.cu.)
//
// Both are one tiled fp32 GEMM (gemm_kernel) with different operand
// loaders and epilogues, so the element-wise work of each period rides
// along with the product instead of making its own pass over device memory:
//   * forward: bias add + activation in the epilogue;
//   * wgrad:   dZ = dY * A'(Y) formed while the dY tile is loaded (dZ never
//              exists in device memory); the contraction runs over the
//              batch inside the block, and the blocks of the first row tile
//              also sum dZ's columns into db, so every db column is written
//              by exactly one block (no atomics, deterministic).
// Activations and their derivatives from the output Y: fcnn_act.cuh.
//
// What bounds it on an H100: at the FCNN shapes (batch 64-128, widths
// 10-4000) each call moves 0.03-17 MB and does 0.6-1000 MFLOP, i.e. a few
// microseconds at 3.35 TB/s or 67 TFLOP/s (fp32 outside the tensor cores);
// a 64-row batch gives few output tiles, so the card is far from full and
// launch latency dominates.  The design keeps fp32 exactness (no TF32, no
// tensor cores: the parity tolerances are IEEE fp32's) and fuses every
// element-wise step so each operand is read once.  Ragged edges (784, 10,
// batch 1) are masked in place: no padded copies.  TPU grid steps that
// carried an accumulator in VMEM become a loop inside one block.

#include <cuda_runtime.h>

#include "fcnn_act.cuh"

namespace {

constexpr int BM = 64;        // output tile rows
constexpr int BN = 64;        // output tile columns
constexpr int BK = 16;        // contraction slice held in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = BM / 16;
constexpr int TN = BN / 16;

using namespace fcnn;  // Act, act_fwd, act_deriv

// Operand loaders: value of logical element (r, c).  kContigSecond says
// which logical index walks contiguous memory, so the tile load can give
// neighbouring threads neighbouring addresses.
struct RowMajor {  // (r, c) -> p[r * ld + c]
  static constexpr bool kContigSecond = true;
  const float* p;
  int ld;
  __device__ float operator()(int r, int c) const {
    return p[static_cast<size_t>(r) * ld + c];
  }
};

struct ColMajor {  // (r, c) -> p[c * ld + r]
  static constexpr bool kContigSecond = false;
  const float* p;
  int ld;
  __device__ float operator()(int r, int c) const {
    return p[static_cast<size_t>(c) * ld + r];
  }
};

template <int ACT>
struct DzRowMajor {  // (r, c) -> dy * A'(y) at [r * ld + c]
  static constexpr bool kContigSecond = true;
  const float* dy;
  const float* y;
  int ld;
  __device__ float operator()(int r, int c) const {
    const size_t i = static_cast<size_t>(r) * ld + c;
    return dy[i] * act_deriv<ACT>(y[i]);
  }
};

template <int ACT>
struct BiasActStore {
  const float* b;
  float* out;
  int ld;
  __device__ void operator()(int r, int c, float acc) const {
    out[static_cast<size_t>(r) * ld + c] = act_fwd<ACT>(acc + b[c]);
  }
};

struct Store {
  float* out;
  int ld;
  __device__ void operator()(int r, int c, float acc) const {
    out[static_cast<size_t>(r) * ld + c] = acc;
  }
};

// out(R, C) = epilogue(A(R, KC) @ B(KC, C)).  One block per 64 x 64 output
// tile; the contraction is walked in BK slices staged in shared memory.
// SUM_B_COLS: blocks of row tile 0 also write colsum[c] = sum_k B(k, c).
template <class LoadA, class LoadB, class Epilogue, bool SUM_B_COLS>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(int R, int C, int KC, LoadA load_a, LoadB load_b, Epilogue epi,
            float* colsum) {
  // +1 column of padding keeps the transposing stores off one bank
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const bool sum_cols = SUM_B_COLS && blockIdx.y == 0 && t < BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float csum = 0.f;

  for (int k0 = 0; k0 < KC; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = t + i * THREADS;
      const int r = LoadA::kContigSecond ? e / BK : e % BM;
      const int kk = LoadA::kContigSecond ? e % BK : e / BM;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < R && gk < KC) ? load_a(gr, gk) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = t + i * THREADS;
      const int c = LoadB::kContigSecond ? e % BN : e / BK;
      const int kk = LoadB::kContigSecond ? e / BN : e % BK;
      const int gc = col0 + c;
      const int gk = k0 + kk;
      Bs[kk][c] = (gc < C && gk < KC) ? load_b(gk, gc) : 0.f;
    }
    __syncthreads();

    if (sum_cols) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) csum += Bs[kk][t];
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < R && c < C) epi(r, c, acc[i][j]);
    }
  }
  if (sum_cols && col0 + t < C) colsum[col0 + t] = csum;
}

template <bool SUM_B_COLS, class LoadA, class LoadB, class Epilogue>
cudaError_t launch_gemm(int R, int C, int KC, LoadA a, LoadB b, Epilogue epi,
                        float* colsum, cudaStream_t stream) {
  const dim3 grid((C + BN - 1) / BN, (R + BM - 1) / BM);
  gemm_kernel<LoadA, LoadB, Epilogue, SUM_B_COLS>
      <<<grid, THREADS, 0, stream>>>(R, C, KC, a, b, epi, colsum);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t fwd(const float* x, const float* w, const float* b, float* out,
                int M, int K, int N, cudaStream_t s) {
  return launch_gemm<false>(M, N, K, RowMajor{x, K}, RowMajor{w, N},
                            BiasActStore<ACT>{b, out, N}, nullptr, s);
}

template <int ACT>
cudaError_t wgrad(const float* x, const float* dy, const float* y, float* dw,
                  float* db, int M, int K, int N, cudaStream_t s) {
  // rows K, columns N, contraction M: A(k, m) = x[m * K + k], B = dZ (M, N)
  return launch_gemm<true>(K, N, M, ColMajor{x, K}, DzRowMajor<ACT>{dy, y, N},
                           Store{dw, N}, db, s);
}

}  // namespace

cudaError_t launch_fcnn_fwd(const float* x, const float* w, const float* b,
                            float* out, int M, int K, int N, int act,
                            cudaStream_t s) {
  switch (act) {
    case kSigmoid: return fwd<kSigmoid>(x, w, b, out, M, K, N, s);
    case kRelu: return fwd<kRelu>(x, w, b, out, M, K, N, s);
    case kTanh: return fwd<kTanh>(x, w, b, out, M, K, N, s);
    case kNone: return fwd<kNone>(x, w, b, out, M, K, N, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_fcnn_wgrad(const float* x, const float* dy, const float* y,
                              float* dw, float* db, int M, int K, int N,
                              int act, cudaStream_t s) {
  switch (act) {
    case kSigmoid: return wgrad<kSigmoid>(x, dy, y, dw, db, M, K, N, s);
    case kRelu: return wgrad<kRelu>(x, dy, y, dw, db, M, K, N, s);
    case kTanh: return wgrad<kTanh>(x, dy, y, dw, db, M, K, N, s);
    case kNone: return wgrad<kNone>(x, dy, y, dw, db, M, K, N, s);
    default: return cudaErrorInvalidValue;
  }
}
