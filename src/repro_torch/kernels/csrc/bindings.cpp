// Python bindings of the five FCNN kernels.  The only source that includes
// PyTorch's headers: the kernels themselves (fcnn_layer.cu, softmax_xent.cu)
// export plain launchers that take raw pointers and a stream and return the
// launch's cudaError_t.  The Python wrappers (kernels/fcnn_layer.py,
// kernels/softmax_xent.py) check device, dtype, shape and contiguity and
// allocate the outputs; these functions launch on PyTorch's current stream
// and raise if the launch was refused.

#include <torch/extension.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

cudaError_t launch_fcnn_fwd(const float* x, const float* w, const float* b,
                            float* out, int M, int K, int N, int act,
                            cudaStream_t s);
cudaError_t launch_fcnn_dgrad(const float* dy, const float* y, const float* w,
                              float* dx, int M, int K, int N, int act,
                              cudaStream_t s);
cudaError_t launch_fcnn_wgrad(const float* x, const float* dy, const float* y,
                              float* dw, float* db, int M, int K, int N,
                              int act, cudaStream_t s);
cudaError_t launch_xent_fwd(const float* logits, const int* labels, float* nll,
                            float* lse, int B, int C, cudaStream_t s);
cudaError_t launch_xent_dlogits(const float* logits, const int* labels,
                                const float* lse, const float* scale, float* dx,
                                int B, int C, cudaStream_t s);

namespace {

void check_launch(cudaError_t err, const char* kernel) {
  TORCH_CHECK(err == cudaSuccess, kernel, " launch failed: ",
              cudaGetErrorString(err));
}

cudaStream_t stream_of(const torch::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

float* f32(const torch::Tensor& t) { return t.data_ptr<float>(); }

// x (M, K), w (K, N), b (N,) -> out (M, N)
void fcnn_fwd(const torch::Tensor& x, const torch::Tensor& w,
              const torch::Tensor& b, torch::Tensor out, int64_t act) {
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(launch_fcnn_fwd(f32(x), f32(w), f32(b), f32(out), x.size(0),
                               x.size(1), w.size(1), act, stream_of(x)),
               "fcnn_layer");
}

// dy, y (M, N), w (K, N) -> dx (M, K)
void fcnn_dgrad(const torch::Tensor& dy, const torch::Tensor& y,
                const torch::Tensor& w, torch::Tensor dx, int64_t act) {
  const c10::cuda::CUDAGuard guard(dy.device());
  check_launch(launch_fcnn_dgrad(f32(dy), f32(y), f32(w), f32(dx), dy.size(0),
                                 w.size(0), dy.size(1), act, stream_of(dy)),
               "fcnn_layer_dgrad");
}

// x (M, K), dy, y (M, N) -> dw (K, N), db (N,)
void fcnn_wgrad(const torch::Tensor& x, const torch::Tensor& dy,
                const torch::Tensor& y, torch::Tensor dw, torch::Tensor db,
                int64_t act) {
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(launch_fcnn_wgrad(f32(x), f32(dy), f32(y), f32(dw), f32(db),
                                 x.size(0), x.size(1), dy.size(1), act,
                                 stream_of(x)),
               "fcnn_layer_wgrad");
}

// logits (B, C), labels (B,) int32 -> nll, lse (B,)
void xent_fwd(const torch::Tensor& logits, const torch::Tensor& labels,
              torch::Tensor nll, torch::Tensor lse) {
  const c10::cuda::CUDAGuard guard(logits.device());
  check_launch(launch_xent_fwd(f32(logits), labels.data_ptr<int>(), f32(nll),
                               f32(lse), logits.size(0), logits.size(1),
                               stream_of(logits)),
               "softmax_xent_fwd");
}

// logits (B, C), labels, lse, scale (B,) -> dx (B, C)
void xent_dlogits(const torch::Tensor& logits, const torch::Tensor& labels,
                  const torch::Tensor& lse, const torch::Tensor& scale,
                  torch::Tensor dx) {
  const c10::cuda::CUDAGuard guard(logits.device());
  check_launch(launch_xent_dlogits(f32(logits), labels.data_ptr<int>(),
                                   f32(lse), f32(scale), f32(dx),
                                   logits.size(0), logits.size(1),
                                   stream_of(logits)),
               "softmax_xent_dlogits");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fcnn_fwd", &fcnn_fwd);
  m.def("fcnn_dgrad", &fcnn_dgrad);
  m.def("fcnn_wgrad", &fcnn_wgrad);
  m.def("xent_fwd", &xent_fwd);
  m.def("xent_dlogits", &xent_dlogits);
}
