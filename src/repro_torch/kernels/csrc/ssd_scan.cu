// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a): the Mamba2 prefill's
// quadratic term.
//
// Replaces the TPU kernel ssd_chunk (_kernel) of
// src/repro/kernels/ssd_scan.py.  Per (chunk, head), with
// cs = cumsum(dt_a) in fp32:
//   y_diag[t] = Σ_{s<=t} (C_t·B_s) exp(cs_t − cs_s) x_s     (in x's dtype)
//   state     = Σ_s exp(cs_{Q-1} − cs_s) B_s x_sᵀ            (P x N, fp32)
//   decay[t]  = exp(cs_t)                                   (fp32)
//
// Design.  One thread block of 256 threads per (head, chunk); the heads of
// a chunk are neighbours in the grid, so the B and C of a chunk, shared by
// every head when groups = 1 (passed as stride-0 views, never copied), are
// read once from device memory and then from L2.  Q <= 128 and P, N <= 64
// cover Zamba2 (Q = 128, P = N = 64) and the smaller test shapes.  The
// block stages x, B and C of its chunk in shared memory as fp32 (rows
// padded to a multiple of 64 and P, N to 64, zero-filled; 120 KB at
// Q = 128, hence the opt-in above 48 KB), and forms cs with a one-warp
// scan.  y_diag is never built from a (Q, Q) decay matrix in device
// memory: for each 64-row output tile and each 64-column source
// tile up to the diagonal, the block forms the weights (C_t·B_s)·exp(cs_t −
// cs_s) for s <= t in registers (4 x 4 per thread), parks that one 64 x 64
// tile in shared memory, and accumulates tile @ x in registers.  The state
// is a second register-tiled product over the chunk's rows.  This is the
// fusion the TPU kernel exists for; nothing of size Q x Q reaches device
// memory.
//
// What bounds it on an H100: at the serving shapes (16 chunks x 64 heads,
// Q = 128, P = N = 64, bf16 x) the kernel reads ~17 MB and writes ~34 MB
// against ~4 GFLOP of fp32 products with full diagonal tiles: bytes bound
// the ideal kernel (~15 µs) while this first version, on the CUDA cores in
// fp32 at one 120 KB block per SM, is bound by its operations.  Tensor
// cores for the two products and smaller staging (bf16 in shared memory,
// two blocks per SM) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kWPitch = kTile + 4;
constexpr int kMaxQ = 128;
constexpr int kMaxDim = 64;  // P and N: one 64-column tile each
constexpr int kPitch = kMaxDim + 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides4 {
  long long c, q, h;  // chunk, row, head strides in elements; last is 1
};

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// rows [0, rows) of an (rows, cols) slab into shared memory, fp32, pitch
// `pitch`; rows in [n_rows, rows) and columns in [n_cols, round_up(cols))
// are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long stride_q, int n_rows,
                                      int rows, int n_cols, int cols,
                                      int pitch) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols;
    const int c = idx % cols;
    float v = 0.f;
    if (r < n_rows && c < n_cols) v = to_f32(src[r * stride_q + c]);
    dst[r * pitch + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt_a,
                 const T* __restrict__ b, const T* __restrict__ c,
                 T* __restrict__ y, float* __restrict__ state,
                 float* __restrict__ decay, Strides4 sx, Strides4 sa,
                 Strides4 sb, Strides4 sc, int H, int Q, int P, int N) {
  const int QP = round_up(Q, kTile);
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // QP x kPitch
  float* Bs = Xs + QP * kPitch;                 // QP x kPitch
  float* Cs = Bs + QP * kPitch;                 // QP x kPitch
  float* Ws = Cs + QP * kPitch;                 // kTile x kWPitch
  float* cs = Ws + kTile * kWPitch;             // QP
  float* wst = cs + QP;                         // QP: exp(cs_{Q-1} − cs_s)

  const int h = blockIdx.x;
  const int ch = blockIdx.y;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32;

  stage(Xs, x + ch * sx.c + h * sx.h, sx.q, Q, QP, P, kMaxDim, kPitch);
  stage(Bs, b + ch * sb.c + h * sb.h, sb.q, Q, QP, N, kMaxDim, kPitch);
  stage(Cs, c + ch * sc.c + h * sc.h, sc.q, Q, QP, N, kMaxDim, kPitch);

  // cs = inclusive cumsum of dt_a over the chunk: each lane of warp 0 sums
  // a run of consecutive rows, then the runs' totals are scanned
  if (threadIdx.x < 32) {
    const float* a = dt_a + ch * sa.c + h * sa.h;
    const int per = (Q + 31) / 32;
    const int beg = min(lane * per, Q);
    const int end = min(beg + per, Q);
    float run = 0.f;
    for (int t = beg; t < end; ++t) {
      run += a[t * sa.q];
      cs[t] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane > 0)
      for (int t = beg; t < end; ++t) cs[t] += excl;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < QP; t += kThreads) {
    if (t < Q) {
      decay[(static_cast<long long>(ch) * Q + t) * H + h] = expf(cs[t]);
      wst[t] = expf(cs[Q - 1] - cs[t]);
    } else {
      cs[t] = 0.f;
      wst[t] = 0.f;
    }
  }
  __syncthreads();

  // y_diag, one 64-row output tile at a time: rows t0 + ty + 16i,
  // columns 4tx + e
  for (int t0 = 0; t0 < Q; t0 += kTile) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

    for (int s0 = 0; s0 <= t0; s0 += kTile) {
      float w[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
      for (int n = 0; n < kMaxDim; n += 4) {
        float4 cf[4], bf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cf[i] = *reinterpret_cast<const float4*>(&Cs[(t0 + ty + 16 * i) * kPitch + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bf[j] = *reinterpret_cast<const float4*>(&Bs[(s0 + tx + 16 * j) * kPitch + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            w[i][j] = fmaf(cf[i].x, bf[j].x, w[i][j]);
            w[i][j] = fmaf(cf[i].y, bf[j].y, w[i][j]);
            w[i][j] = fmaf(cf[i].z, bf[j].z, w[i][j]);
            w[i][j] = fmaf(cf[i].w, bf[j].w, w[i][j]);
          }
      }
      __syncthreads();  // the previous source tile's weights are consumed
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + tx + 16 * j;
          const bool keep = s <= t && t < Q;
          Ws[(ty + 16 * i) * kWPitch + tx + 16 * j] =
              keep ? w[i][j] * expf(cs[t] - cs[s]) : 0.f;
        }
      }
      __syncthreads();
      for (int s = 0; s < kTile; s += 4) {
        float4 wf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wf[i] = *reinterpret_cast<const float4*>(&Ws[(ty + 16 * i) * kWPitch + s]);
        const float* xr = &Xs[(s0 + s) * kPitch + 4 * tx];
        const float4 x0 = *reinterpret_cast<const float4*>(xr);
        const float4 x1 = *reinterpret_cast<const float4*>(xr + kPitch);
        const float4 x2 = *reinterpret_cast<const float4*>(xr + 2 * kPitch);
        const float4 x3 = *reinterpret_cast<const float4*>(xr + 3 * kPitch);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = acc[i];
          a[0] = fmaf(wf[i].x, x0.x, fmaf(wf[i].y, x1.x, fmaf(wf[i].z, x2.x, fmaf(wf[i].w, x3.x, a[0]))));
          a[1] = fmaf(wf[i].x, x0.y, fmaf(wf[i].y, x1.y, fmaf(wf[i].z, x2.y, fmaf(wf[i].w, x3.y, a[1]))));
          a[2] = fmaf(wf[i].x, x0.z, fmaf(wf[i].y, x1.z, fmaf(wf[i].z, x2.z, fmaf(wf[i].w, x3.z, a[2]))));
          a[3] = fmaf(wf[i].x, x0.w, fmaf(wf[i].y, x1.w, fmaf(wf[i].z, x2.w, fmaf(wf[i].w, x3.w, a[3]))));
        }
      }
    }
    // y (BC, Q, H, P), contiguous
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= Q) continue;
      T* yr = y + ((static_cast<long long>(ch) * Q + t) * H + h) * P;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 4 * tx + e;
        if (p < P) yr[p] = from_f32<T>(acc[i][e]);
      }
    }
  }

  // state[p][n] = Σ_s wst[s] x[s][p] B[s][n]: p = 4ty + e, n = 4tx + f;
  // state (BC, H, P, N), contiguous
  float* st = state + (static_cast<long long>(ch) * H + h) * P * N;
  float a[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f) a[e][f] = 0.f;
  for (int s = 0; s < Q; ++s) {
    const float ws = wst[s];
    const float4 xv = *reinterpret_cast<const float4*>(&Xs[s * kPitch + 4 * ty]);
    const float4 bv = *reinterpret_cast<const float4*>(&Bs[s * kPitch + 4 * tx]);
    const float xs[4] = {xv.x * ws, xv.y * ws, xv.z * ws, xv.w * ws};
    const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f) a[e][f] = fmaf(xs[e], bs[f], a[e][f]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int p = 4 * ty + e;
    if (p >= P) continue;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int n = 4 * tx + f;
      if (n < N) st[p * N + n] = a[e][f];
    }
  }
}

int smem_bytes(int Q) {
  const int QP = round_up(Q, kTile);
  const int floats = 3 * QP * kPitch + kTile * kWPitch + 2 * QP;
  return floats * static_cast<int>(sizeof(float));
}

template <typename T>
cudaError_t launch(const void* x, const float* dt_a, const void* b,
                   const void* c, void* y, float* state, float* decay,
                   const long long* st, int BC, int Q, int H, int P, int N,
                   cudaStream_t stream) {
  auto kern = ssd_chunk_kernel<T>;
  // opt in once per instantiation at the largest chunk the wrapper admits,
  // so launches of smaller chunks need no further attribute call
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kMaxQ));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const Strides4 sx{st[0], st[1], st[2]};
  const Strides4 sa{st[3], st[4], st[5]};
  const Strides4 sb{st[6], st[7], st[8]};
  const Strides4 sc{st[9], st[10], st[11]};
  const dim3 grid(H, BC);
  kern<<<grid, kThreads, smem_bytes(Q), stream>>>(
      static_cast<const T*>(x), dt_a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), state, decay, sx, sa, sb,
      sc, H, Q, P, N);
  return cudaGetLastError();
}

}  // namespace

// x (BC, Q, H, P), dt_a (BC, Q, H) fp32, b, c (BC, Q, H, N) with unit last
// stride; st: the (chunk, row, head) strides of x, dt_a, b and c in that
// order, in elements (a head stride of 0 broadcasts one group to all
// heads).  y (BC, Q, H, P) in x's dtype, state (BC, H, P, N) and decay
// (BC, Q, H) fp32, all contiguous.  bf16 != 0 for bfloat16 x, b, c.
cudaError_t launch_ssd_chunk(const void* x, const float* dt_a, const void* b,
                             const void* c, void* y, float* state,
                             float* decay, const long long* st, int BC, int Q,
                             int H, int P, int N, int bf16,
                             cudaStream_t stream) {
  if (BC < 1 || BC > 65535 || Q < 1 || Q > kMaxQ || H < 1 || P < 1 ||
      P > kMaxDim || N < 1 || N > kMaxDim)
    return cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(x, dt_a, b, c, y, state, decay, st, BC, Q, H, P, N, stream);
  return launch<float>(x, dt_a, b, c, y, state, decay, st, BC, Q, H, P, N, stream);
}
