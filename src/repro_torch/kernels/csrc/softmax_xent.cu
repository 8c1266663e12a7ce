// Softmax cross-entropy kernels for Hopper (sm_90a): the FCNN output period
// and the LM's token loss.
//
// Replaces the TPU kernels of src/repro/kernels/softmax_xent.py:
//   softmax_xent_fwd      (_fwd_kernel) -> launch_xent_fwd
//       (nll, lse) per row, and the batch mean of nll
//   softmax_xent_dlogits  (_bwd_kernel) -> launch_xent_dlogits
//       (exp(x - lse) - onehot) * scale, scale per row or g / B
// Logits are fp32 or bf16, upcast on load; nll, lse and the mean are fp32
// and dlogits has the logits' dtype, as in the reference.
//
// What bounds them on an H100 at the FCNN's shapes: the (B, C) logits are
// tiny there (64 x 10 fp32 = 2.5 KB), so both kernels take about the time
// of a launch, and what a call adds to it is the chain of memory latencies it
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
// one was the fastest at both.  The block sums the mean in a fixed order:
// each warp (butterfly shuffles), then the block's warps in order.
//
// K4 elsewhere (the "rows" kernels; the LM loss at (B*L, padded vocab),
// e.g. (2048, 49408) fp32 = 405 MB, bound by bytes at 0.121 ms): the rows
// are spread over a grid, as the TPU kernel tiles them over a parallel
// grid axis with the class tiles as a sequential carry.  A block is 8
// warps; a row goes to a group of W warps (W = 8, a block a row, where C
// >= 4096; else W = 1, a warp a row and 8 rows a block), so the grid has
// ceil(B * W / 8) blocks -- 2048 at the LM shape, enough to keep every SM's
// loads in flight.  Each thread walks its row in 16-byte vectors (4 fp32 or
// 8 bf16 logits; scalars where C is not a multiple of that or the logits
// are not 16-byte aligned), reads every logit once, picks the label's
// logit out of the vector that holds it, and carries an online-softmax
// state (m, l): one max and one rescale a vector, one exp a logit.  The
// group merges its carries in a fixed order (butterfly shuffles, then its
// warps in order through shared memory) and writes nll and lse.  The mean
// is a second launch of one block (``xent_mean_kernel``) that sums nll in
// a fixed order -- each thread a strided run of rows, then the block as
// above -- so no floating-point atomics, and repeated calls give
// bit-identical means.  ``softmax_xent.fwd_plan`` picks W and the vector
// width on the host with the rule of ``xent_fwd`` below.
//
// K5 (one kernel at every shape; the LM loss's backward at (2048, 49408)
// fp32 = 809.5 MB read and written is bound by bytes at 0.242 ms): a row to
// blockIdx.x and a tile of kRowUnroll 16-byte vectors a thread to
// blockIdx.y.  It loads the row's label, lse and factor once, starts its
// kRowUnroll loads before any arithmetic, and writes 16-byte vectors
// (scalars where C is not a multiple of the vector or the data is not
// 16-byte aligned).  A block is kDlogitsThreads threads: along x as few
// whole warps as cover a row of fewer vectors, and along y as many rows
// as fill the rest (8 rows of 32 threads at the FCNN's C = 10).  An
// elements kernel (a grid-stride loop over the B x C elements) ran at 44%
// of the byte bound (0.547 ms) and 24% in bf16 on the H100, spending its
// instruction slots on a 64-bit division per element to find the row.
// ``softmax_xent.vector_loads`` picks the vector width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kLaneClasses = 16;    // the lane kernel's largest C
constexpr int kLaneRows = 256;      // ... and largest B (= its largest block)
constexpr int kRowWarps = 8;        // the rows kernels' warps a block
constexpr int kRowsThreads = 32 * kRowWarps;
constexpr int kMeanThreads = 1024;   // the mean kernel's block
constexpr int kDlogitsThreads = 256;  // K5's most threads a block
constexpr int kRowUnroll = 4;         // K5: vectors a thread

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

// K4, rows kernels: blocks of kRowsThreads threads; a row to each group of
// WARPS warps (kRowWarps / WARPS rows a block).  VEC: 16-byte loads.
template <typename T, int WARPS, bool VEC>
__global__ void __launch_bounds__(kRowsThreads)
xent_fwd_rows_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                     float* __restrict__ nll, float* __restrict__ lse, int B,
                     int C) {
  constexpr int kGroup = 32 * WARPS;                 // threads a row
  constexpr int kV = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * (kRowWarps / WARPS) + warp / WARPS;
  const int t_in_row = threadIdx.x % kGroup;
  float m = kNegInf, l = 0.f, t = 0.f;
  int label = -1;
  if (r < B) {
    label = labels[r];
    const T* x = logits + static_cast<size_t>(r) * C;
    if constexpr (VEC) {
      using Vec = uint4;
      const Vec* xv = reinterpret_cast<const Vec*>(x);
      const int n_vec = C / kV;
#pragma unroll 4
      for (int i = t_in_row; i < n_vec; i += kGroup) {
        const Vec raw = __ldg(xv + i);
        const T* e = reinterpret_cast<const T*>(&raw);
        float v[kV];
        float vmax = kNegInf;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          v[j] = to_f32(e[j]);
          vmax = fmaxf(vmax, v[j]);
          if (i * kV + j == label) t = v[j];
        }
        if (vmax > m) {
          l *= expf(m - vmax);
          m = vmax;
        }
#pragma unroll
        for (int j = 0; j < kV; ++j) l += expf(v[j] - m);
      }
    } else {
      for (int c = t_in_row; c < C; c += kGroup) {
        const float v = to_f32(x[c]);
        online(v, m, l);
        if (c == label) t = v;
      }
    }
  }
  // merge the group's carries: its warps' lanes, then its warps in order
  float m_row = warp_max(m);
  l = warp_sum(l * expf(m - m_row));
  t = warp_sum(t);
  if constexpr (WARPS > 1) {
    __shared__ float part_m[kRowWarps], part_l[kRowWarps], part_t[kRowWarps];
    if (lane == 0) {
      part_m[warp] = m_row;
      part_l[warp] = l;
      part_t[warp] = t;
    }
    __syncthreads();
    const int w0 = warp / WARPS * WARPS;
    m_row = kNegInf;
    for (int w = w0; w < w0 + WARPS; ++w) m_row = fmaxf(m_row, part_m[w]);
    l = 0.f;
    t = 0.f;
    for (int w = w0; w < w0 + WARPS; ++w) {
      l += part_l[w] * expf(part_m[w] - m_row);
      t += part_t[w];
    }
  }
  if (r < B && t_in_row == 0) {
    const float s = m_row + logf(l);
    lse[r] = s;
    nll[r] = s - t;
  }
}

// K4's mean after the rows kernels: one block of kMeanThreads threads;
// thread i sums rows i, i + kMeanThreads, ... in order, then block_sum.
__global__ void __launch_bounds__(kMeanThreads)
xent_mean_kernel(const float* __restrict__ nll, float* __restrict__ mean, int B) {
  float part = 0.f;
  for (int r = threadIdx.x; r < B; r += kMeanThreads) part += nll[r];
  const float sum = block_sum(part);
  if (threadIdx.x == 0) *mean = sum / static_cast<float>(B);
}

// K5: row blockIdx.x * blockDim.y + threadIdx.y, vectors [blockIdx.y *
// blockDim.x * kRowUnroll, ...) of it, kRowUnroll a thread, blockDim.x
// apart.  The row's factor is
// scale[r * scale_stride] / scale_div (per row: stride 1 or 0 and div 1;
// from the loss cotangent: scale = g, stride 0, div B).  VEC: 16-byte
// vectors.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kDlogitsThreads)
xent_dlogits_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ scale,
                    int scale_stride, int scale_div, T* __restrict__ dx, int B,
                    int C) {
  constexpr int kV = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  using Vec = typename std::conditional<VEC, uint4, T>::type;
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= B) return;
  const float f = scale[static_cast<size_t>(r) * scale_stride] /
                  static_cast<float>(scale_div);
  const float s = lse[r];
  const int label = labels[r];
  const Vec* x = reinterpret_cast<const Vec*>(logits + static_cast<size_t>(r) * C);
  Vec* y = reinterpret_cast<Vec*>(dx + static_cast<size_t>(r) * C);
  const int n_vec = C / kV;
  const int first = blockIdx.y * blockDim.x * kRowUnroll + threadIdx.x;
  Vec raw[kRowUnroll];
#pragma unroll
  for (int u = 0; u < kRowUnroll; ++u) {  // every load in flight at once
    const int i = first + u * blockDim.x;
    if (i < n_vec) raw[u] = x[i];
  }
#pragma unroll
  for (int u = 0; u < kRowUnroll; ++u) {
    const int i = first + u * blockDim.x;
    if (i < n_vec) {
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      Vec out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float p = expf(to_f32(e[j]) - s);
        store(o + j, (p - (i * kV + j == label ? 1.f : 0.f)) * f);
      }
      y[i] = out;
    }
  }
}

__global__ void empty_kernel() {}

// warps_per_row 0: the lane kernel (C <= 16, B <= 256); else the rows
// kernel with that many warps a row (1 or 8) and, with vec, 16-byte loads,
// then the mean kernel.  softmax_xent.fwd_plan makes the choice.
template <typename T>
cudaError_t xent_fwd(const void* logits, const int* labels, float* nll, float* lse,
                     float* mean, int B, int C, int warps_per_row, int vec,
                     cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  if (warps_per_row == 0) {
    if (C > kLaneClasses || B > kLaneRows) return cudaErrorInvalidValue;
    const int threads = B > 32 ? (B + 31) / 32 * 32 : 32;  // whole warps
    xent_fwd_lane_kernel<T><<<1, threads, 0, s>>>(x, labels, nll, lse, mean, B, C);
    return cudaGetLastError();
  }
  if (warps_per_row != 1 && warps_per_row != kRowWarps) return cudaErrorInvalidValue;
  const int rows_a_block = kRowWarps / warps_per_row;
  const int blocks = (B + rows_a_block - 1) / rows_a_block;
  if (warps_per_row == 1) {
    if (vec)
      xent_fwd_rows_kernel<T, 1, true><<<blocks, kRowsThreads, 0, s>>>(x, labels, nll, lse, B, C);
    else
      xent_fwd_rows_kernel<T, 1, false><<<blocks, kRowsThreads, 0, s>>>(x, labels, nll, lse, B, C);
  } else {
    if (vec)
      xent_fwd_rows_kernel<T, kRowWarps, true><<<blocks, kRowsThreads, 0, s>>>(x, labels, nll, lse, B, C);
    else
      xent_fwd_rows_kernel<T, kRowWarps, false><<<blocks, kRowsThreads, 0, s>>>(x, labels, nll, lse, B, C);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_mean_kernel<<<1, kMeanThreads, 0, s>>>(nll, mean, B);
  return cudaGetLastError();
}

// 16-byte vectors where vec (softmax_xent.vector_loads makes the choice);
// blocks of kDlogitsThreads: the fewest whole warps that cover a row (at
// most kDlogitsThreads) along x, rows along y
template <typename T>
cudaError_t xent_dlogits(const void* logits, const int* labels, const float* lse,
                         const float* scale, int scale_stride, int scale_div,
                         void* dx, int B, int C, int vec, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  T* y = static_cast<T*>(dx);
  const int n_vec = vec ? C / (16 / static_cast<int>(sizeof(T))) : C;
  if (B == 0 || n_vec == 0) return cudaSuccess;  // nothing to write
  const int tx = n_vec < kDlogitsThreads ? (n_vec + 31) / 32 * 32
                                         : kDlogitsThreads;
  const dim3 block(tx, kDlogitsThreads / tx);
  const int per_block = tx * kRowUnroll;
  const dim3 grid((B + block.y - 1) / block.y, (n_vec + per_block - 1) / per_block);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (vec)
    xent_dlogits_kernel<T, true><<<grid, block, 0, s>>>(
        x, labels, lse, scale, scale_stride, scale_div, y, B, C);
  else
    xent_dlogits_kernel<T, false><<<grid, block, 0, s>>>(
        x, labels, lse, scale, scale_stride, scale_div, y, B, C);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_xent_fwd(const void* logits, const int* labels, float* nll,
                            float* lse, float* mean, int B, int C, int bf16,
                            int warps_per_row, int vec, cudaStream_t s) {
  return bf16 ? xent_fwd<__nv_bfloat16>(logits, labels, nll, lse, mean, B, C,
                                        warps_per_row, vec, s)
              : xent_fwd<float>(logits, labels, nll, lse, mean, B, C,
                                warps_per_row, vec, s);
}

cudaError_t launch_xent_dlogits(const void* logits, const int* labels,
                                const float* lse, const float* scale,
                                int scale_stride, int scale_div, void* dx, int B,
                                int C, int bf16, int vec, cudaStream_t s) {
  return bf16 ? xent_dlogits<__nv_bfloat16>(logits, labels, lse, scale,
                                            scale_stride, scale_div, dx, B, C,
                                            vec, s)
              : xent_dlogits<float>(logits, labels, lse, scale, scale_stride,
                                    scale_div, dx, B, C, vec, s);
}

cudaError_t launch_empty(cudaStream_t s) {
  empty_kernel<<<1, 32, 0, s>>>();
  return cudaGetLastError();
}
