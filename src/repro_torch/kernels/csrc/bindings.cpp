// Python bindings of the seven kernels and the backwards of K6 and K7.  The
// only source that includes PyTorch's headers: the kernels themselves
// (fcnn_fwd.cu, fcnn_dgrad.cu, fcnn_fwd_tc.cu, fcnn_dgrad_tc.cu,
// fcnn_wgrad.cu, fcnn_wgrad_tc.cu, softmax_xent.cu, flash_attention.cu,
// flash_attention_bwd.cu, ssd_scan.cu, ssd_scan_bwd.cu) export
// plain launchers that take raw pointers, strides and a stream and return
// the launch's cudaError_t.  The Python wrappers (kernels/fcnn_layer.py, kernels/softmax_xent.py,
// kernels/flash_attention.py, kernels/ssd_scan.py) check device, dtype,
// shape and strides and allocate the outputs; these functions launch on
// PyTorch's current stream and raise if the launch was refused.

#include <torch/extension.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

cudaError_t launch_fcnn_fwd(const void* x, const void* w, const void* b,
                            void* out, int M, int K, int N, int act, int split,
                            int slice, int x_bf16, int w_bf16, cudaStream_t s);
cudaError_t launch_fcnn_dgrad(const void* dy, const void* y, const void* w,
                              void* dx, int M, int K, int N, int act, int split,
                              int slice, int dy_bf16, int w_bf16, cudaStream_t s);
cudaError_t launch_fcnn_fwd_tc(const void* x, const void* w, const void* b,
                               void* out, int M, int K, int N, int act,
                               int width, int split, int x_bf16,
                               cudaStream_t s);
cudaError_t launch_fcnn_dgrad_tc(const void* dy, const void* y, const void* w,
                                 void* dx, int M, int K, int N, int act,
                                 int width, int split, int dy_bf16,
                                 cudaStream_t s);
cudaError_t launch_fcnn_wgrad(const void* x, const void* dy, const void* y,
                              void* dw, void* db, int M, int K, int N, int act,
                              int tile_rows, int tile_cols, int x_bf16,
                              int dy_bf16, cudaStream_t s);
cudaError_t launch_fcnn_wgrad_tc(const void* x, const void* dy, const void* y,
                                 void* dw, void* db, int M, int K, int N,
                                 int act, int width, int split, int dy_bf16,
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
                                   void* o, float* lse, const long long* st,
                                   int B, int H, int KV, int Sq, int Sk, int D,
                                   int causal, int window, int bf16,
                                   cudaStream_t stream);
cudaError_t launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout,
                                       const float* lse, float* delta, void* dq,
                                       void* dk, void* dv, const long long* st,
                                       int B, int H, int KV, int Sq, int Sk, int D,
                                       int causal, int window, int bf16,
                                       const int* plan, int n_pat, int blocks,
                                       int slots, float* dq_acc, float* dkv_acc,
                                       int* ctr, long long n_ctr, cudaStream_t stream);
cudaError_t launch_ssd_chunk(const void* x, const float* dt_a, const void* b,
                             const void* c, void* y, float* state,
                             float* decay, const long long* st, int BC, int Q,
                             int H, int P, int N, int bf16, int heads,
                             cudaStream_t stream);
cudaError_t launch_ssd_chunk_bwd(const void* x, const float* dt_a, const void* b,
                                 const void* c, const void* dy, const float* dstate,
                                 const float* ddecay, void* dx, float* ddt, float* part,
                                 void* db, void* dc, const long long* st, int BC, int Q,
                                 int H, int P, int N, int G, int bf16, int heads,
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

// 1 for a bf16 tensor, 0 for fp32: the FCNN kernels take either
int bf16_flag(const torch::Tensor& t, const char* kernel, const char* name) {
  TORCH_CHECK(t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16,
              kernel, ": ", name, " must be float32 or bfloat16");
  return t.scalar_type() == at::kBFloat16;
}

// `t` in the type of `like`: the operands a kernel reads or writes as one
void same_type(const torch::Tensor& t, const torch::Tensor& like,
               const char* kernel, const char* name, const char* like_name) {
  TORCH_CHECK(t.scalar_type() == like.scalar_type(), kernel, ": ", name,
              " must have ", like_name, "'s dtype");
}

// x (M, K), w (K, N), b (N,) -> out (M, N), out in x's dtype and b in w's;
// the contraction split over ``split`` blocks of a cluster, in slices of
// ``slice``
void fcnn_fwd(const torch::Tensor& x, const torch::Tensor& w,
              const torch::Tensor& b, torch::Tensor out, int64_t act,
              int64_t split, int64_t slice) {
  const char* k = "fcnn_layer";
  const int xb = bf16_flag(x, k, "x"), wb = bf16_flag(w, k, "w");
  same_type(b, w, k, "b", "w");
  same_type(out, x, k, "out", "x");
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(launch_fcnn_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                               out.data_ptr(), x.size(0), x.size(1), w.size(1),
                               act, split, slice, xb, wb, stream_of(x)),
               k);
}

// dy, y (M, N), w (K, N) -> dx (M, K), y and dx in dy's dtype; the
// contraction split over ``split`` blocks of a cluster, in slices of
// ``slice``
void fcnn_dgrad(const torch::Tensor& dy, const torch::Tensor& y,
                const torch::Tensor& w, torch::Tensor dx, int64_t act,
                int64_t split, int64_t slice) {
  const char* k = "fcnn_layer_dgrad";
  const int db = bf16_flag(dy, k, "dy"), wb = bf16_flag(w, k, "w");
  same_type(y, dy, k, "y", "dy");
  same_type(dx, dy, k, "dx", "dy");
  const c10::cuda::CUDAGuard guard(dy.device());
  check_launch(launch_fcnn_dgrad(dy.data_ptr(), y.data_ptr(), w.data_ptr(),
                                 dx.data_ptr(), dy.size(0), w.size(0),
                                 dy.size(1), act, split, slice, db, wb,
                                 stream_of(dy)),
               k);
}

// K1 on the tensor cores: x (M, K), w (K, N) and b (N,) bf16 -> out (M, N)
// in x's dtype; out tiles 64 x ``width``, the contraction split over
// ``split`` blocks of a cluster
void fcnn_fwd_tc(const torch::Tensor& x, const torch::Tensor& w,
                 const torch::Tensor& b, torch::Tensor out, int64_t act,
                 int64_t width, int64_t split) {
  const char* k = "fcnn_layer";
  const int xb = bf16_flag(x, k, "x");
  TORCH_CHECK(w.scalar_type() == at::kBFloat16, k, ": w must be bfloat16");
  same_type(b, w, k, "b", "w");
  same_type(out, x, k, "out", "x");
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(launch_fcnn_fwd_tc(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), x.size(0), x.size(1),
                                  w.size(1), act, width, split, xb,
                                  stream_of(x)),
               k);
}

// K2 on the tensor cores: dy, y (M, N), w (K, N) bf16 -> dx (M, K) in dy's
// dtype; dX tiles 64 x ``width``, the contraction split over ``split``
// blocks of a cluster
void fcnn_dgrad_tc(const torch::Tensor& dy, const torch::Tensor& y,
                   const torch::Tensor& w, torch::Tensor dx, int64_t act,
                   int64_t width, int64_t split) {
  const char* k = "fcnn_layer_dgrad";
  const int db = bf16_flag(dy, k, "dy");
  TORCH_CHECK(w.scalar_type() == at::kBFloat16, k, ": w must be bfloat16");
  same_type(y, dy, k, "y", "dy");
  same_type(dx, dy, k, "dx", "dy");
  const c10::cuda::CUDAGuard guard(dy.device());
  check_launch(launch_fcnn_dgrad_tc(dy.data_ptr(), y.data_ptr(), w.data_ptr(),
                                    dx.data_ptr(), dy.size(0), w.size(0),
                                    dy.size(1), act, width, split, db,
                                    stream_of(dy)),
               k);
}

// x (M, K), dy, y (M, N) -> dw (K, N) in x's dtype, db (N,) in dy's; dW in
// tiles of ``tile_rows`` x ``tile_cols``
void fcnn_wgrad(const torch::Tensor& x, const torch::Tensor& dy,
                const torch::Tensor& y, torch::Tensor dw, torch::Tensor db,
                int64_t act, int64_t tile_rows, int64_t tile_cols) {
  const char* k = "fcnn_layer_wgrad";
  const int xb = bf16_flag(x, k, "x"), dyb = bf16_flag(dy, k, "dy");
  same_type(y, dy, k, "y", "dy");
  same_type(dw, x, k, "dw", "x");
  same_type(db, dy, k, "db", "dy");
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(launch_fcnn_wgrad(x.data_ptr(), dy.data_ptr(), y.data_ptr(),
                                 dw.data_ptr(), db.data_ptr(), x.size(0),
                                 x.size(1), dy.size(1), act, tile_rows,
                                 tile_cols, xb, dyb, stream_of(x)),
               k);
}

// K3 on the tensor cores: x (M, K) bf16, dy, y (M, N) -> dw (K, N) bf16,
// db (N,) in dy's dtype; dWᵀ tiles 64 x ``width``, the batch split over
// ``split`` blocks of a cluster
void fcnn_wgrad_tc(const torch::Tensor& x, const torch::Tensor& dy,
                   const torch::Tensor& y, torch::Tensor dw, torch::Tensor db,
                   int64_t act, int64_t width, int64_t split) {
  const char* k = "fcnn_layer_wgrad";
  TORCH_CHECK(x.scalar_type() == at::kBFloat16, k, ": x must be bfloat16");
  const int dyb = bf16_flag(dy, k, "dy");
  same_type(y, dy, k, "y", "dy");
  same_type(dw, x, k, "dw", "x");
  same_type(db, dy, k, "db", "dy");
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(launch_fcnn_wgrad_tc(x.data_ptr(), dy.data_ptr(), y.data_ptr(),
                                    dw.data_ptr(), db.data_ptr(), x.size(0),
                                    x.size(1), dy.size(1), act, width, split,
                                    dyb, stream_of(x)),
               k);
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
// Sk = Sq where causal; read and written through their strides; a causal
// call with window > 0 keeps key k for query q where q - window < k <= q;
// lse: nullptr, or the (B, H, Sq) fp32 log-sum-exp of each row
void flash_attention_launch(const torch::Tensor& q, const torch::Tensor& k,
                            const torch::Tensor& v, torch::Tensor o, float* lse,
                            bool causal, int64_t window) {
  const c10::cuda::CUDAGuard guard(q.device());
  long long st[12];
  const torch::Tensor* ts[4] = {&q, &k, &v, &o};
  for (int i = 0; i < 4; ++i)
    for (int d = 0; d < 3; ++d) st[3 * i + d] = ts[i]->stride(d);
  check_launch(launch_flash_attention(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse, st,
                   q.size(0), q.size(1), k.size(1), q.size(2), k.size(2),
                   q.size(3), causal, static_cast<int>(window),
                   q.scalar_type() == at::kBFloat16, stream_of(q)),
               "flash_attention");
}

void flash_attention(const torch::Tensor& q, const torch::Tensor& k,
                     const torch::Tensor& v, torch::Tensor o, bool causal,
                     int64_t window) {
  flash_attention_launch(q, k, v, o, nullptr, causal, window);
}

// the same, also writing lse (B, H, Sq) fp32, contiguous
void flash_attention_lse(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, torch::Tensor o, torch::Tensor lse,
                         bool causal, int64_t window) {
  flash_attention_launch(q, k, v, o, f32(lse), causal, window);
}

// dq, dk, dv of flash_attention from q, k, v, o, dout (q's and k's shapes,
// through their strides) and the forward's lse; delta is fp32 scratch the
// first kernel fills ((B, H, Sq) for fp32 data, the row stats for bf16).
// bf16 only (empty tensors for fp32): plan (int32, n_pat units and the
// order tables), the persistent grid's blocks, the slots of a dQ tile's
// sum, the fp32 scratch dq_acc and dkv_acc (empty where no span is split)
// and the int32 counters ctr
void flash_attention_bwd(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, const torch::Tensor& o,
                         const torch::Tensor& dout, const torch::Tensor& lse,
                         torch::Tensor delta, torch::Tensor dq, torch::Tensor dk,
                         torch::Tensor dv, bool causal, int64_t window,
                         const torch::Tensor& plan, int64_t n_pat, int64_t blocks,
                         int64_t slots, torch::Tensor dq_acc, torch::Tensor dkv_acc,
                         torch::Tensor ctr) {
  const c10::cuda::CUDAGuard guard(q.device());
  long long st[24];
  const torch::Tensor* ts[8] = {&q, &k, &v, &o, &dout, &dq, &dk, &dv};
  for (int i = 0; i < 8; ++i)
    for (int d = 0; d < 3; ++d) st[3 * i + d] = ts[i]->stride(d);
  auto f32_or_null = [](const torch::Tensor& t) {
    return t.numel() ? t.data_ptr<float>() : nullptr;
  };
  check_launch(launch_flash_attention_bwd(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   dout.data_ptr(), f32(lse), f32(delta), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), st, q.size(0), q.size(1),
                   k.size(1), q.size(2), k.size(2), q.size(3), causal,
                   static_cast<int>(window), q.scalar_type() == at::kBFloat16,
                   plan.numel() ? plan.data_ptr<int>() : nullptr,
                   static_cast<int>(n_pat), static_cast<int>(blocks),
                   static_cast<int>(slots), f32_or_null(dq_acc), f32_or_null(dkv_acc),
                   ctr.numel() ? ctr.data_ptr<int>() : nullptr, ctr.numel(),
                   stream_of(q)),
               "flash_attention_bwd");
}

// x (BC, Q, H, P), dt_a (BC, Q, H), b, c (BC, Q, H, N) through their
// strides -> y (BC, Q, H, P), state (BC, H, P, N), decay (BC, Q, H); a
// block walks `heads` consecutive heads of a chunk (fp32: more than one
// only where B's and C's head strides are 0)
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

// the backward of ssd_chunk: x, dt_a, b, c as the forward takes them, dy
// (x's shape, through its strides), dstate (BC, H, P, N) and ddecay (BC, Q,
// H) fp32 contiguous, each cotangent empty where it is zero -> dx, ddt
// (BC, Q, H) fp32, db and dc (BC, Q, G, N), summing each group's H / G
// heads.  bf16 blocks walk `heads` heads of one group (1 for fp32);
// parts (2, BC, Q, H / heads, N) fp32 is the scratch of each block's (fp32:
// each head's) dB and dC before the group sum, empty where each bf16 block
// is a whole group
void ssd_chunk_bwd(const torch::Tensor& x, const torch::Tensor& dt_a,
                   const torch::Tensor& b, const torch::Tensor& c,
                   const torch::Tensor& dy, const torch::Tensor& dstate,
                   const torch::Tensor& ddecay, torch::Tensor dx, torch::Tensor ddt,
                   torch::Tensor parts, torch::Tensor db, torch::Tensor dc,
                   int64_t heads) {
  const c10::cuda::CUDAGuard guard(x.device());
  long long st[15] = {};
  const torch::Tensor* ts[5] = {&x, &dt_a, &b, &c, &dy};
  for (int i = 0; i < 5; ++i)
    if (ts[i]->numel())
      for (int d = 0; d < 3; ++d) st[3 * i + d] = ts[i]->stride(d);
  check_launch(launch_ssd_chunk_bwd(
                   x.data_ptr(), f32(dt_a), b.data_ptr(), c.data_ptr(),
                   dy.numel() ? dy.data_ptr() : nullptr,
                   dstate.numel() ? f32(dstate) : nullptr,
                   ddecay.numel() ? f32(ddecay) : nullptr, dx.data_ptr(), f32(ddt),
                   parts.numel() ? f32(parts) : nullptr, db.data_ptr(), dc.data_ptr(), st,
                   x.size(0), x.size(1), x.size(2), x.size(3), b.size(3), db.size(2),
                   x.scalar_type() == at::kBFloat16, static_cast<int>(heads),
                   stream_of(x)),
               "ssd_chunk_bwd");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fcnn_fwd", &fcnn_fwd);
  m.def("fcnn_dgrad", &fcnn_dgrad);
  m.def("fcnn_fwd_tc", &fcnn_fwd_tc);
  m.def("fcnn_dgrad_tc", &fcnn_dgrad_tc);
  m.def("fcnn_wgrad", &fcnn_wgrad);
  m.def("fcnn_wgrad_tc", &fcnn_wgrad_tc);
  m.def("xent_fwd", &xent_fwd);
  m.def("xent_dlogits", &xent_dlogits);
  m.def("launch_floor", &launch_floor);
  m.def("flash_attention", &flash_attention);
  m.def("flash_attention_lse", &flash_attention_lse);
  m.def("flash_attention_bwd", &flash_attention_bwd);
  m.def("ssd_chunk", &ssd_chunk);
  m.def("ssd_chunk_bwd", &ssd_chunk_bwd);
}
