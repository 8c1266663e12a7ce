// Activations of the FCNN periods and their derivatives from the output
// Y, shared by the forward (fcnn_fwd.cu), dgrad (fcnn_dgrad.cu) and wgrad
// (fcnn_wgrad.cu) kernels.  act_deriv mirrors
// repro_torch/kernels/ref.py::act_deriv_from_output line for line.
#pragma once

namespace fcnn {

// the codes of repro_torch/kernels/fcnn_layer.py's ACT_CODES
enum Act : int { kNone = 0, kSigmoid = 1, kRelu = 2, kTanh = 3 };

template <int ACT>
__device__ __forceinline__ float act_fwd(float z) {
  if constexpr (ACT == kSigmoid) return 1.f / (1.f + expf(-z));
  else if constexpr (ACT == kRelu) return fmaxf(z, 0.f);
  else if constexpr (ACT == kTanh) return tanhf(z);
  else return z;
}

template <int ACT>
__device__ __forceinline__ float act_deriv(float y) {
  if constexpr (ACT == kSigmoid) return y * (1.f - y);
  else if constexpr (ACT == kRelu) return y > 0.f ? 1.f : 0.f;
  else if constexpr (ACT == kTanh) return 1.f - y * y;
  else return 1.f;
}

// the same with the activation as a run-time code, for kernels that apply
// it outside their inner loop (one instantiation serves all four)
__device__ __forceinline__ float act_fwd(int act, float z) {
  switch (act) {
    case kSigmoid: return act_fwd<kSigmoid>(z);
    case kRelu: return act_fwd<kRelu>(z);
    case kTanh: return act_fwd<kTanh>(z);
    default: return z;
  }
}

// act_fwd(act, z) without a branch in the sigmoid: exp by __expf and the
// quotient by __fdividef (within ~1e-6 of act_fwd's, far inside the bf16
// ulp and the 1e-4 of an fp32 output the kernels are held to).  IEEE
// division takes a branch to its slow path, and an epilogue of 32 of them
// a thread on one warpgroup an SM spent microseconds on the latency (the
// tensor-core forward, fcnn_fwd_tc.cu)
__device__ __forceinline__ float act_fwd_fast(int act, float z) {
  switch (act) {
    case kSigmoid: return __fdividef(1.f, 1.f + __expf(-z));
    case kRelu: return fmaxf(z, 0.f);
    case kTanh: return tanhf(z);
    default: return z;
  }
}

__device__ __forceinline__ float act_deriv(int act, float y) {
  switch (act) {
    case kSigmoid: return act_deriv<kSigmoid>(y);
    case kRelu: return act_deriv<kRelu>(y);
    case kTanh: return act_deriv<kTanh>(y);
    default: return 1.f;
  }
}

}  // namespace fcnn
