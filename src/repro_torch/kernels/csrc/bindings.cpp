// Python bindings of the seven kernels.  The only source that includes
// PyTorch's headers: the kernels themselves (fcnn_fwd.cu, fcnn_dgrad.cu,
// fcnn_wgrad.cu, softmax_xent.cu, flash_attention.cu, ssd_scan.cu) export
// plain launchers that take raw pointers, strides and a stream and return
// the launch's cudaError_t.  The Python wrappers (kernels/fcnn_layer.py, kernels/softmax_xent.py,
// kernels/flash_attention.py, kernels/ssd_scan.py) check device, dtype,
// shape and strides and allocate the outputs; these functions launch on
// PyTorch's current stream and raise if the launch was refused.

#include <torch/extension.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

cudaError_t launch_fcnn_fwd(const float* x, const float* w, const float* b,
                            float* out, int M, int K, int N, int act, int split,
                            int slice, cudaStream_t s);
cudaError_t launch_fcnn_dgrad(const float* dy, const float* y, const float* w,
                              float* dx, int M, int K, int N, int act, int split,
                              int slice, cudaStream_t s);
cudaError_t launch_fcnn_wgrad(const float* x, const float* dy, const float* y,
                              float* dw, float* db, int M, int K, int N,
                              int act, int tile_rows, int tile_cols,
                              cudaStream_t s);
cudaError_t launch_xent_fwd(const void* logits, const int* labels, float* nll,
                            float* lse, float* mean, int B, int C, int bf16,
                            int warps_per_row, int vec, cudaStream_t s);
cudaError_t launch_xent_dlogits(const void* logits, const int* labels,
                                const float* lse, const float* scale,
                                int scale_stride, int scale_div, void* dx, int B,
                                int C, int bf16, int vec, cudaStream_t s);
cudaError_t launch_empty(cudaStream_t s);
cudaError_t launch_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, const long long* st, int B, int H,
                                   int KV, int Sq, int Sk, int D, int causal,
                                   int bf16, cudaStream_t stream);
cudaError_t launch_ssd_chunk(const void* x, const float* dt_a, const void* b,
                             const void* c, void* y, float* state,
                             float* decay, const long long* st, int BC, int Q,
                             int H, int P, int N, int bf16, int heads,
                             cudaStream_t stream);

namespace {

void check_launch(cudaError_t err, const char* kernel) {
  TORCH_CHECK(err == cudaSuccess, kernel, " launch failed: ",
              cudaGetErrorString(err));
}

cudaStream_t stream_of(const torch::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

float* f32(const torch::Tensor& t) { return t.data_ptr<float>(); }

// x (M, K), w (K, N), b (N,) -> out (M, N); the contraction split over
// ``split`` blocks of a cluster, in slices of ``slice``
void fcnn_fwd(const torch::Tensor& x, const torch::Tensor& w,
              const torch::Tensor& b, torch::Tensor out, int64_t act,
              int64_t split, int64_t slice) {
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(launch_fcnn_fwd(f32(x), f32(w), f32(b), f32(out), x.size(0),
                               x.size(1), w.size(1), act, split, slice,
                               stream_of(x)),
               "fcnn_layer");
}

// dy, y (M, N), w (K, N) -> dx (M, K); the contraction split over
// ``split`` blocks of a cluster, in slices of ``slice``
void fcnn_dgrad(const torch::Tensor& dy, const torch::Tensor& y,
                const torch::Tensor& w, torch::Tensor dx, int64_t act,
                int64_t split, int64_t slice) {
  const c10::cuda::CUDAGuard guard(dy.device());
  check_launch(launch_fcnn_dgrad(f32(dy), f32(y), f32(w), f32(dx), dy.size(0),
                                 w.size(0), dy.size(1), act, split, slice,
                                 stream_of(dy)),
               "fcnn_layer_dgrad");
}

// x (M, K), dy, y (M, N) -> dw (K, N), db (N,); dW in tiles of
// ``tile_rows`` x ``tile_cols``
void fcnn_wgrad(const torch::Tensor& x, const torch::Tensor& dy,
                const torch::Tensor& y, torch::Tensor dw, torch::Tensor db,
                int64_t act, int64_t tile_rows, int64_t tile_cols) {
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(launch_fcnn_wgrad(f32(x), f32(dy), f32(y), f32(dw), f32(db),
                                 x.size(0), x.size(1), dy.size(1), act,
                                 tile_rows, tile_cols, stream_of(x)),
               "fcnn_layer_wgrad");
}

// logits (B, C) fp32 or bf16, labels (B,) int32 -> nll, lse (B,), mean (0-d);
// warps_per_row 0 is the one-block lane kernel, else the rows kernel with
// that many warps a row (16-byte loads with vec), as fwd_plan picks
void xent_fwd(const torch::Tensor& logits, const torch::Tensor& labels,
              torch::Tensor nll, torch::Tensor lse, torch::Tensor mean,
              int64_t warps_per_row, int64_t vec) {
  const c10::cuda::CUDAGuard guard(logits.device());
  check_launch(launch_xent_fwd(logits.data_ptr(), labels.data_ptr<int>(),
                               f32(nll), f32(lse), f32(mean), logits.size(0),
                               logits.size(1),
                               logits.scalar_type() == at::kBFloat16,
                               warps_per_row, vec, stream_of(logits)),
               "softmax_xent_fwd");
}

// logits (B, C), labels, lse (B,) -> dx (B, C) in the logits' dtype; the
// row factor is scale[r * scale_stride] / scale_div; 16-byte vectors with
// vec, as softmax_xent.vector_loads picks
void xent_dlogits(const torch::Tensor& logits, const torch::Tensor& labels,
                  const torch::Tensor& lse, const torch::Tensor& scale,
                  int64_t scale_stride, int64_t scale_div, torch::Tensor dx,
                  int64_t vec) {
  const c10::cuda::CUDAGuard guard(logits.device());
  check_launch(launch_xent_dlogits(logits.data_ptr(), labels.data_ptr<int>(),
                                   f32(lse), f32(scale), scale_stride,
                                   scale_div, dx.data_ptr(), logits.size(0),
                                   logits.size(1),
                                   logits.scalar_type() == at::kBFloat16,
                                   vec, stream_of(logits)),
               "softmax_xent_dlogits");
}

// an empty kernel on the current stream: the launch floor that K4 and K5
// are timed against
void launch_floor() {
  check_launch(launch_empty(c10::cuda::getCurrentCUDAStream().stream()),
               "empty kernel");
}

// q, o (B, H, Sq, D) and k, v (B, KV, Sk, D), H a multiple of KV (GQA),
// Sk = Sq where causal; read and written through their strides
void flash_attention(const torch::Tensor& q, const torch::Tensor& k,
                     const torch::Tensor& v, torch::Tensor o, bool causal) {
  const c10::cuda::CUDAGuard guard(q.device());
  long long st[12];
  const torch::Tensor* ts[4] = {&q, &k, &v, &o};
  for (int i = 0; i < 4; ++i)
    for (int d = 0; d < 3; ++d) st[3 * i + d] = ts[i]->stride(d);
  check_launch(launch_flash_attention(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), st,
                   q.size(0), q.size(1), k.size(1), q.size(2), k.size(2),
                   q.size(3), causal, q.scalar_type() == at::kBFloat16,
                   stream_of(q)),
               "flash_attention");
}

// x (BC, Q, H, P), dt_a (BC, Q, H), b, c (BC, Q, H, N) through their
// strides -> y (BC, Q, H, P), state (BC, H, P, N), decay (BC, Q, H); bf16
// blocks walk `heads` consecutive heads of a chunk (1 for fp32)
void ssd_chunk(const torch::Tensor& x, const torch::Tensor& dt_a,
               const torch::Tensor& b, const torch::Tensor& c, torch::Tensor y,
               torch::Tensor state, torch::Tensor decay, int64_t heads) {
  const c10::cuda::CUDAGuard guard(x.device());
  long long st[12];
  const torch::Tensor* ts[4] = {&x, &dt_a, &b, &c};
  for (int i = 0; i < 4; ++i)
    for (int d = 0; d < 3; ++d) st[3 * i + d] = ts[i]->stride(d);
  check_launch(launch_ssd_chunk(x.data_ptr(), f32(dt_a), b.data_ptr(),
                                c.data_ptr(), y.data_ptr(), f32(state),
                                f32(decay), st, x.size(0), x.size(1),
                                x.size(2), x.size(3), b.size(3),
                                x.scalar_type() == at::kBFloat16, heads,
                                stream_of(x)),
               "ssd_chunk");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fcnn_fwd", &fcnn_fwd);
  m.def("fcnn_dgrad", &fcnn_dgrad);
  m.def("fcnn_wgrad", &fcnn_wgrad);
  m.def("xent_fwd", &xent_fwd);
  m.def("xent_dlogits", &xent_dlogits);
  m.def("launch_floor", &launch_floor);
  m.def("flash_attention", &flash_attention);
  m.def("ssd_chunk", &ssd_chunk);
}
