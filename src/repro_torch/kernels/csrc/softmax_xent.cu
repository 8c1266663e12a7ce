// Softmax cross-entropy kernels for Hopper (sm_90a): the FCNN output period.
//
// Replaces the TPU kernels of src/repro/kernels/softmax_xent.py:
//   softmax_xent_fwd      (_fwd_kernel) -> launch_xent_fwd
//       (nll, lse) per row, and the batch mean of nll
//   softmax_xent_dlogits  (_bwd_kernel) -> launch_xent_dlogits
//       (exp(x - lse) - onehot) * scale, scale per row or g / B
// Logits are fp32 or bf16, upcast on load; nll, lse and the mean are fp32
// and dlogits has the logits' dtype, as in the reference.
//
// What bounds them on an H100: the (B, C) logits are tiny on this path
// (64 x 10 fp32 = 2.5 KB), so both kernels take about the time of a
// launch, and what a call adds to it is the chain of memory latencies it
// waits on.  The design therefore does two things.  It moves into the
// kernels the work that the training step used to launch around them: K4
// writes the batch mean of nll (no torch mean after it) and K5 forms g / B
// from the loss cotangent g (no division and no expand-and-copy before
// it).  And it keeps each kernel to one round of loads, all in flight at
// once.
//
// K4 at C <= 16 and B <= 256 (every FCNN batch; the "lane" kernel): one
// block of B threads rounded up to whole warps, a thread a row.  The
// thread loads its row into registers with every load in flight at once,
// then takes the row's max, its sum of exps (independent terms) and the
// label's logit, and the block sums nll.  Of the one-block shapes tried on
// the H100 at (64, 10) and (128, 10) -- the tile staged in shared memory
// first, a warp or a half-warp a row, the row held in 32 registers -- this
// one was the fastest at both.  Elsewhere (the "warp" kernel) one block of
// 8 warps walks the rows, a warp a row, each lane carrying its own
// online-softmax state (m, l) over classes lane, lane + 32, ... and the
// warp merging the carries once per row.  The mean is reduced in a fixed
// order: each thread over its rows, the warp (butterfly shuffles), then
// the block's warps in order.  No atomics; repeated calls give
// bit-identical means.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kLaneClasses = 16;    // the lane kernel's largest C
constexpr int kLaneRows = 256;      // ... and largest B (= its largest block)
constexpr int kWarpRows = 8;        // the warp kernel's warps a block
constexpr int kDlogitsThreads = 256;  // K5's threads a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one online-softmax step: fold logit v into the carry (m, l), one exp
__device__ __forceinline__ void online(float v, float& m, float& l) {
  if (v > m) {
    l = l * expf(m - v) + 1.f;
    m = v;
  } else {
    l += expf(v - m);
  }
}

// The block's sum of every thread's `part`: warps, then warps in order;
// thread 0 returns it (every thread must call).
__device__ __forceinline__ float block_sum(float part) {
  __shared__ float warp_part[32];
  part = warp_sum(part);
  if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = part;
  __syncthreads();
  float sum = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < blockDim.x / 32; ++w) sum += warp_part[w];
  return sum;
}

// K4, lane kernel: one block of blockDim.x >= B threads, a thread a row.
template <typename T>
__global__ void __launch_bounds__(kLaneRows)
xent_fwd_lane_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                     float* __restrict__ nll, float* __restrict__ lse,
                     float* __restrict__ mean, int B, int C) {
  const int r = threadIdx.x;
  float part = 0.f;
  if (r < B) {
    const int label = labels[r];
    const T* x = logits + static_cast<size_t>(r) * C;
    float v[kLaneClasses];
    float m = kNegInf, l = 0.f, t = 0.f;
#pragma unroll
    for (int c = 0; c < kLaneClasses; ++c) {  // every load in flight at once
      v[c] = c < C ? to_f32(x[c]) : kNegInf;
      m = fmaxf(m, v[c]);
    }
#pragma unroll
    for (int c = 0; c < kLaneClasses; ++c) {
      if (c < C) l += expf(v[c] - m);
      if (c < C && c == label) t = v[c];
    }
    const float s = m + logf(l);
    lse[r] = s;
    nll[r] = s - t;
    part = s - t;
  }
  const float sum = block_sum(part);
  if (threadIdx.x == 0) *mean = sum / static_cast<float>(B);
}

// K4, warp kernel: one block of kWarpRows warps, a warp a row; warp w
// takes rows w, w + kWarpRows, ...
template <typename T>
__global__ void __launch_bounds__(32 * kWarpRows)
xent_fwd_warp_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                     float* __restrict__ nll, float* __restrict__ lse,
                     float* __restrict__ mean, int B, int C) {
  const int lane = threadIdx.x % 32;
  float part = 0.f;  // lane 0: its warp's rows' nll
  for (int r = threadIdx.x / 32; r < B; r += kWarpRows) {
    const T* x = logits + static_cast<size_t>(r) * C;
    const int label = labels[r];
    float m = kNegInf, l = 0.f;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) online(to_f32(x[c]), m, l);
    const float m_row = warp_max(m);
    l = warp_sum(l * expf(m - m_row));
    if (lane == 0) {
      const float t = label >= 0 && label < C ? to_f32(x[label]) : 0.f;
      const float s = m_row + logf(l);
      lse[r] = s;
      nll[r] = s - t;
      part += s - t;
    }
  }
  const float sum = block_sum(part);
  if (threadIdx.x == 0) *mean = sum / static_cast<float>(B);
}

// K5.  One element a thread, a grid-stride loop over the B x C elements;
// the row's factor is scale[r * scale_stride] / scale_div (per row: stride
// 1 or 0 and div 1; from the loss cotangent: scale = g, stride 0, div B).
template <typename T>
__global__ void __launch_bounds__(kDlogitsThreads)
xent_dlogits_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ scale,
                    int scale_stride, int scale_div, T* __restrict__ dx, int B,
                    int C) {
  const size_t n = static_cast<size_t>(B) * C;
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i < n; i += step) {
    const int r = static_cast<int>(i / C);
    const int c = static_cast<int>(i - static_cast<size_t>(r) * C);
    const float f = scale[static_cast<size_t>(r) * scale_stride] /
                    static_cast<float>(scale_div);
    const float p = expf(to_f32(logits[i]) - lse[r]);
    store(dx + i, (p - (c == labels[r] ? 1.f : 0.f)) * f);
  }
}

__global__ void empty_kernel() {}

template <typename T>
cudaError_t xent_fwd(const void* logits, const int* labels, float* nll, float* lse,
                     float* mean, int B, int C, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  if (C <= kLaneClasses && B <= kLaneRows) {
    const int threads = B > 32 ? (B + 31) / 32 * 32 : 32;  // whole warps
    xent_fwd_lane_kernel<T><<<1, threads, 0, s>>>(x, labels, nll, lse, mean, B, C);
  } else {
    xent_fwd_warp_kernel<T><<<1, 32 * kWarpRows, 0, s>>>(x, labels, nll, lse,
                                                         mean, B, C);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t xent_dlogits(const void* logits, const int* labels, const float* lse,
                         const float* scale, int scale_stride, int scale_div,
                         void* dx, int B, int C, cudaStream_t s) {
  const long long n = static_cast<long long>(B) * C;
  const long long want = (n + kDlogitsThreads - 1) / kDlogitsThreads;
  const int blocks = static_cast<int>(want < 4 * 132 ? want : 4 * 132);
  xent_dlogits_kernel<T><<<blocks, kDlogitsThreads, 0, s>>>(
      static_cast<const T*>(logits), labels, lse, scale, scale_stride, scale_div,
      static_cast<T*>(dx), B, C);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_xent_fwd(const void* logits, const int* labels, float* nll,
                            float* lse, float* mean, int B, int C, int bf16,
                            cudaStream_t s) {
  return bf16 ? xent_fwd<__nv_bfloat16>(logits, labels, nll, lse, mean, B, C, s)
              : xent_fwd<float>(logits, labels, nll, lse, mean, B, C, s);
}

cudaError_t launch_xent_dlogits(const void* logits, const int* labels,
                                const float* lse, const float* scale,
                                int scale_stride, int scale_div, void* dx, int B,
                                int C, int bf16, cudaStream_t s) {
  return bf16 ? xent_dlogits<__nv_bfloat16>(logits, labels, lse, scale,
                                            scale_stride, scale_div, dx, B, C, s)
              : xent_dlogits<float>(logits, labels, lse, scale, scale_stride,
                                    scale_div, dx, B, C, s);
}

cudaError_t launch_empty(cudaStream_t s) {
  empty_kernel<<<1, 32, 0, s>>>();
  return cudaGetLastError();
}
