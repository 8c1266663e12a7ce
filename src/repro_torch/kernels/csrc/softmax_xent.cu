// Softmax cross-entropy kernels for Hopper (sm_90a): the FCNN output period.
//
// Replaces the TPU kernels of src/repro/kernels/softmax_xent.py:
//   softmax_xent_fwd      (_fwd_kernel) -> launch_xent_fwd      (nll, lse) per row
//   softmax_xent_dlogits  (_bwd_kernel) -> launch_xent_dlogits  (exp(x - lse) - onehot) * scale
//
// Forward: one warp per row walks the classes in chunks of 32 with the
// online-softmax recurrence (running max m, rescaled sum l), masks the tail
// to -1e30 and picks the label's logit; lane 0 writes nll = lse - x[label]
// and lse = m + log(l), both fp32.  The TPU kernel carried (m, l, t) across
// sequential grid steps in VMEM; here the class loop is inside the warp and
// the carries live in registers.  Probabilities never reach device memory.
// Backward: dlogits recomputed from the saved lse, one read of the logits
// and one write, one warp per row reading lse, scale and the label once.
//
// What bounds it on an H100: the (B, C) logits are tiny on this path
// (64 x 10 fp32 = 2.5 KB), so both kernels are launch-latency bound; the
// design makes each a single pass that reads every input once.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr float kNegInf = -1e30f;

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

__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                float* __restrict__ nll, float* __restrict__ lse, int B, int C) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (r >= B) return;  // whole warp leaves together
  const float* x = logits + static_cast<size_t>(r) * C;
  const int label = labels[r];

  float m = kNegInf;
  float l = 0.f;
  float t = 0.f;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const float v = c < C ? x[c] : kNegInf;
    const float m_new = fmaxf(m, warp_max(v));
    l = l * expf(m - m_new) + warp_sum(expf(v - m_new));
    m = m_new;
    if (c < C && c == label) t = v;
  }
  t = warp_sum(t);  // the label's logit sits in exactly one lane
  if (lane == 0) {
    const float s = m + logf(l);
    lse[r] = s;
    nll[r] = s - t;
  }
}

__global__ void __launch_bounds__(kThreads)
xent_dlogits_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ scale,
                    float* __restrict__ dx, int B, int C) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (r >= B) return;
  const float s = lse[r];
  const float g = scale[r];
  const int label = labels[r];
  const size_t row = static_cast<size_t>(r) * C;
  for (int c = lane; c < C; c += 32) {
    const float p = expf(logits[row + c] - s);
    dx[row + c] = (p - (c == label ? 1.f : 0.f)) * g;
  }
}

}  // namespace

cudaError_t launch_xent_fwd(const float* logits, const int* labels, float* nll,
                            float* lse, int B, int C, cudaStream_t s) {
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  xent_fwd_kernel<<<blocks, kThreads, 0, s>>>(logits, labels, nll, lse, B, C);
  return cudaGetLastError();
}

cudaError_t launch_xent_dlogits(const float* logits, const int* labels,
                                const float* lse, const float* scale, float* dx,
                                int B, int C, cudaStream_t s) {
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  xent_dlogits_kernel<<<blocks, kThreads, 0, s>>>(logits, labels, lse, scale, dx,
                                                  B, C);
  return cudaGetLastError();
}
