// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of K6's
// attention from the forward's saved log-sum-exp, for LM training.
//
// Replaces no pallas_call: the reference's TPU kernel
// (src/repro/kernels/flash_attention.py) has no VJP.  This is the
// counterpart of the reference's flash-style VJP _sdpa_chunked_bwd
// (src/repro/models/layers.py), which recomputes each key chunk's
// probabilities from the saved lse, generalised to every mask K6's forward
// takes (causal, causal with a sliding window, full with Sq != Sk) and to
// grouped-query attention: q, o, dO and dQ are (B, H, Sq, D), k, v, dK and
// dV (B, KV, Sk, D), query head h reads KV head h / (H / KV), all through
// their (batch, head, seq) strides.  With s = q·kᵀ·scale (scale = 1/√D),
// p = exp(s − lse) and delta = Σ_d o·dO per query row:
//
//   dV = Σ pᵀ·dO    dP = dO·vᵀ    dS = p ⊙ (dP − delta) · scale
//   dQ = dS·k       dK = Σ dSᵀ·q
//
// Three kernels, launched in order on one stream:
//   (a) flash_bwd_delta_kernel: delta (B, H, Sq) fp32, one warp a row;
//   (b) dK and dV: a block owns one (batch, KV head, 64-key tile) and walks
//       the G query heads of its group and their 64-row query tiles, so
//       each dK and dV element is summed by one block in a fixed order;
//   (c) dQ: a block owns one (batch, query head, 64-row query tile) and
//       walks the key tiles.
// No atomics: repeated calls are bit-identical.  Tiles wholly masked
// (above the causal diagonal, below a window) are never loaded, as in the
// forward; a query row past Sq gets lse = +inf (p = 0) and a key past Sk
// is masked, so ragged tiles add nothing.
//
// bf16 (namespace-local wgmma kernels): every product on the tensor cores
// with wgmma, one warpgroup a block, tiles of 64 rows x 64 columns fed by
// TMA (128-byte swizzle, zeros past S and D) and the walked tiles through
// a two-stage ring.  The roundings are the reference's: S, dP and every
// sum in fp32; p stays fp32 for dV (the reference multiplies it by the
// fp32 upcast of dO), so pᵀ enters wgmma as a bf16 hi + lo pair, two
// products summed in fp32 (~16 bits of p); dS is rounded to bf16 for dQ
// and dK, as the reference rounds it (ds.astype(q.dtype)).  Scores are
// exponentiated in log2 units (exp2 of s·log2(e)/√D − lse·log2(e)).
// fp32: the CUDA cores, 4 x 4 register tiles a thread as in the fp32
// forward (fp32's parity bar rules out TF32).
//
// What bounds it on an H100: five products over the kept (query, key)
// pairs, 10·D operations a pair and head, against each of q, k, v, o, dO,
// lse and the three gradients moved once: at granite-3-2b's (1, 32, 2048,
// 64) causal on 8 KV heads ~43 GFLOP over ~42 MB, far above the ridge, so
// the bound is the tensor cores' 989 TFLOP/s (bf16) or the CUDA cores' 67
// (fp32).  The bf16 kernels run six products (p's hi and lo) and recompute
// S and dP in both (b) and (c): 8 products a pair where the bound counts 5.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;         // rows of a query or key tile
constexpr float kLog2e = 1.4426950408889634f;

struct Str3 {
  long long b, h, s;  // in elements; the last (D) stride is 1
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// whether key `key` is attended by query row `row`
__device__ __forceinline__ bool kept(int row, int key, int Sq, int Sk,
                                     int causal, int window) {
  return row < Sq && key < Sk && (!causal || key <= row) &&
         (window == 0 || key > row - window);
}

// (a) delta[r] = Σ_d o[r, d]·dO[r, d] in fp32, a warp a row (B·H·Sq rows)
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, Str3 so, Str3 sd, int H,
                       int Sq, int D, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (r >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(r % Sq);
  const long long bh = r / Sq;
  const long long b = bh / H, h = bh % H;
  const T* op = o + b * so.b + h * so.h + s * so.s;
  const T* dp = dout + b * sd.b + h * sd.h + s * sd.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(op[d]), to_f32(dp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// ------------------------------------------------------------------ fp32

constexpr int kThreads = 256;          // 16 x 16 threads, 4 x 4 each
constexpr int kPPitch = kTile + 4;     // rows of the P and dS tiles

// Rows [row0, row0 + 64) of one (batch, head) slice into shared memory
// with row pitch kDPad + 4; rows >= S and columns >= D are zero.
template <int kDPad>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          long long stride_s, int row0, int S,
                                          int D) {
  constexpr int kPitch = kDPad + 4;
  for (int idx = threadIdx.x; idx < kTile * kDPad; idx += kThreads) {
    const int r = idx / kDPad;
    const int d = idx % kDPad;
    const int row = row0 + r;
    dst[r * kPitch + d] = row < S && d < D ? src[row * stride_s + d] : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// a[i][4g + e] += Σ_c t[(ty + 16i)·kPPitch + c] · m[c·kPitch + 4tx + 64g + e]
// over the 64 columns c of a P or dS tile t (rows ty + 16i of the output)
template <int kDPad>
__device__ __forceinline__ void tile_product(float (&a)[4][kDPad / 16],
                                             const float* t, const float* m,
                                             int tx, int ty) {
  constexpr int kPitch = kDPad + 4;
  for (int c = 0; c < kTile; c += 4) {
    float4 tf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tf[i] = *reinterpret_cast<const float4*>(&t[(ty + 16 * i) * kPPitch + c]);
#pragma unroll
    for (int g = 0; g < kDPad / 64; ++g) {
      const int col = 4 * tx + 64 * g;
      const float4 m0 = *reinterpret_cast<const float4*>(&m[(c + 0) * kPitch + col]);
      const float4 m1 = *reinterpret_cast<const float4*>(&m[(c + 1) * kPitch + col]);
      const float4 m2 = *reinterpret_cast<const float4*>(&m[(c + 2) * kPitch + col]);
      const float4 m3 = *reinterpret_cast<const float4*>(&m[(c + 3) * kPitch + col]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* r = &a[i][4 * g];
        r[0] = fmaf(tf[i].x, m0.x, fmaf(tf[i].y, m1.x, fmaf(tf[i].z, m2.x, fmaf(tf[i].w, m3.x, r[0]))));
        r[1] = fmaf(tf[i].x, m0.y, fmaf(tf[i].y, m1.y, fmaf(tf[i].z, m2.y, fmaf(tf[i].w, m3.y, r[1]))));
        r[2] = fmaf(tf[i].x, m0.z, fmaf(tf[i].y, m1.z, fmaf(tf[i].z, m2.z, fmaf(tf[i].w, m3.z, r[2]))));
        r[3] = fmaf(tf[i].x, m0.w, fmaf(tf[i].y, m1.w, fmaf(tf[i].z, m2.w, fmaf(tf[i].w, m3.w, r[3]))));
      }
    }
  }
}

// s[i][j] = A[ty + 16i]·B[tx + 16j] and t[i][j] = C[ty + 16i]·E[tx + 16j]
// over the padded D of four staged tiles
template <int kDPad>
__device__ __forceinline__ void two_scores(float (&s)[4][4], float (&t)[4][4],
                                           const float* A, const float* B,
                                           const float* C, const float* E,
                                           int tx, int ty) {
  constexpr int kPitch = kDPad + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
  for (int d = 0; d < kDPad; d += 4) {
    float4 af[4], bf[4], cf[4], ef[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      af[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * kPitch + d]);
      cf[i] = *reinterpret_cast<const float4*>(&C[(ty + 16 * i) * kPitch + d]);
      bf[i] = *reinterpret_cast<const float4*>(&B[(tx + 16 * i) * kPitch + d]);
      ef[i] = *reinterpret_cast<const float4*>(&E[(tx + 16 * i) * kPitch + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = dot4(af[i], bf[j], s[i][j]);
        t[i][j] = dot4(cf[i], ef[j], t[i][j]);
      }
  }
}

// rows ty + 16i, columns 4tx + 64g + e of a (rows, D) gradient
template <int kDPad>
__device__ __forceinline__ void store_rows(float* out, long long stride_s,
                                           const float (&a)[4][kDPad / 16],
                                           int row0, int S, int D, int tx,
                                           int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int g = 0; g < kDPad / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * g + e;
        if (col < D) out[row * stride_s + col] = a[i][4 * g + e];
      }
  }
}

// (b), fp32: one block per (64-key tile, batch·KV head)
template <int kDPad>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, Str3 sq,
                      Str3 sk, Str3 sv, Str3 sdo, Str3 sdk, Str3 sdv, int H, int G,
                      int Sq, int Sk, int D, int causal, int window, float scale) {
  constexpr int kPitch = kDPad + 4;
  constexpr int kCols = kDPad / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * kPitch;
  float* Qs = Vs + kTile * kPitch;
  float* Os = Qs + kTile * kPitch;   // dO
  float* Ps = Os + kTile * kPitch;   // Pᵀ: [key][query]
  float* Ds = Ps + kTile * kPPitch;  // dSᵀ
  float* Ls = Ds + kTile * kPPitch;  // the query tile's lse
  float* Dl = Ls + kTile;            // and delta

  const int KV = H / G;
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / KV;
  const int hk = blockIdx.y % KV;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_qt = (Sq + kTile - 1) / kTile;
  // the query tiles holding a row that attends a key of this tile
  const int qt_begin = causal ? k0 / kTile : 0;
  const int qt_end = window > 0 ? min(n_qt, (k0 + kTile - 2 + window) / kTile + 1) : n_qt;

  load_rows<kDPad>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, Sk, D);
  load_rows<kDPad>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, Sk, D);
  float adv[4][kCols], adk[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) adv[i][c] = adk[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* qp = q + b * sq.b + h * sq.h;
    const float* op = dout + b * sdo.b + h * sdo.h;
    const float* lp = lse + (static_cast<long long>(b) * H + h) * Sq;
    const float* dlp = delta + (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      load_rows<kDPad>(Qs, qp, sq.s, q0, Sq, D);
      load_rows<kDPad>(Os, op, sdo.s, q0, Sq, D);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < Sq ? lp[row] : 0.f;
        Dl[threadIdx.x] = row < Sq ? dlp[row] : 0.f;
      }
      __syncthreads();

      // Sᵀ and dPᵀ: keys ty + 16i, queries tx + 16j
      float s[4][4], dp[4][4];
      two_scores<kDPad>(s, dp, Ks, Qs, Vs, Os, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = kept(q0 + c, k0 + ty + 16 * i, Sq, Sk, causal, window)
                              ? expf(s[i][j] * scale - Ls[c])
                              : 0.f;
          Ps[(ty + 16 * i) * kPPitch + c] = p;
          Ds[(ty + 16 * i) * kPPitch + c] = p * (dp[i][j] - Dl[c]) * scale;
        }
      __syncthreads();

      // dV += Pᵀ dO, dK += dSᵀ Q
      tile_product<kDPad>(adv, Ps, Os, tx, ty);
      tile_product<kDPad>(adk, Ds, Qs, tx, ty);
    }
  }
  store_rows<kDPad>(dk + b * sdk.b + hk * sdk.h, sdk.s, adk, k0, Sk, D, tx, ty);
  store_rows<kDPad>(dv + b * sdv.b + hk * sdv.h, sdv.s, adv, k0, Sk, D, tx, ty);
}

// (c), fp32: one block per (64-row query tile, batch·head), the tiles
// with the most keys first
template <int kDPad>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, Str3 sq, Str3 sk, Str3 sv, Str3 sdo,
                    Str3 sdq, int H, int G, int Sq, int Sk, int D, int causal,
                    int window, float scale) {
  constexpr int kPitch = kDPad + 4;
  constexpr int kCols = kDPad / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + kTile * kPitch;   // dO
  float* Ks = Os + kTile * kPitch;
  float* Vs = Ks + kTile * kPitch;
  float* Ds = Vs + kTile * kPitch;   // dS: [query][key]

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / G;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* kp = k + b * sk.b + hk * sk.h;
  const float* vp = v + b * sv.b + hk * sv.h;

  load_rows<kDPad>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq, D);
  load_rows<kDPad>(Os, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, D);
  float lse_r[4], dl_r[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = static_cast<long long>(blockIdx.y) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : 0.f;
    dl_r[i] = row < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + kTile) : Sk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kTile * kTile : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_rows<kDPad>(Ks, kp, sk.s, kv0, Sk, D);
    load_rows<kDPad>(Vs, vp, sv.s, kv0, Sk, D);
    __syncthreads();

    // S and dP: queries ty + 16i, keys tx + 16j
    float s[4][4], dp[4][4];
    two_scores<kDPad>(s, dp, Qs, Ks, Os, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = kept(q0 + ty + 16 * i, kv0 + c, Sq, Sk, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
        Ds[(ty + 16 * i) * kPPitch + c] = p * (dp[i][j] - dl_r[i]) * scale;
      }
    __syncthreads();
    tile_product<kDPad>(acc, Ds, Ks, tx, ty);  // dQ += dS K
  }
  store_rows<kDPad>(dq + b * sdq.b + h * sdq.h, sdq.s, acc, q0, Sq, D, tx, ty);
}

template <typename Kern>
cudaError_t opt_in(Kern kern, int smem, bool& done) {
  // once per instantiation, outside any CUDA graph capture that later
  // launches are recorded into
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = err == cudaSuccess;
  return err;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Str3 sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, KV, Sq, Sk, D, causal, window;
};

template <int kDPad>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  constexpr int kPitch = kDPad + 4;
  const int f = static_cast<int>(sizeof(float));
  const int smem_kv = f * (4 * kTile * kPitch + 2 * kTile * kPPitch + 2 * kTile);
  const int smem_q = f * (4 * kTile * kPitch + kTile * kPPitch);
  static bool kv_in = false, q_in = false;
  cudaError_t err = opt_in(flash_bwd_dkdv_kernel<kDPad>, smem_kv, kv_in);
  if (err == cudaSuccess) err = opt_in(flash_bwd_dq_kernel<kDPad>, smem_q, q_in);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(a.D));
  const int G = a.H / a.KV;
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  flash_bwd_dkdv_kernel<kDPad>
      <<<dim3((a.Sk + kTile - 1) / kTile, a.B * a.KV), kThreads, smem_kv, stream>>>(
          f32(a.q), f32(a.k), f32(a.v), f32(a.dout), a.lse, a.delta,
          static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk, a.sv,
          a.sdo, a.sdk, a.sdv, a.H, G, a.Sq, a.Sk, a.D, a.causal, a.window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<kDPad>
      <<<dim3((a.Sq + kTile - 1) / kTile, a.B * a.H), kThreads, smem_q, stream>>>(
          f32(a.q), f32(a.k), f32(a.v), f32(a.dout), a.lse, a.delta,
          static_cast<float*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.H, G, a.Sq,
          a.Sk, a.D, a.causal, a.window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

using namespace tc;

constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kBox = kTile * 128; // a 64-row, 64-column bf16 box

// d (64 x 64·kChunks) += A (64 x 16, register fragments) · B (16 x
// 64·kChunks), B MN-major in shared memory with its 64-column boxes kBox
// bytes apart
template <int kChunks>
__device__ __forceinline__ void mma_rs(float (&d)[32 * kChunks], const uint32_t (&a)[4],
                                       uint32_t b_addr);
template <>
__device__ __forceinline__ void mma_rs<1>(float (&d)[32], const uint32_t (&a)[4],
                                          uint32_t b_addr) {
  wgmma_rs_m64n64k16(d, a, desc_sw128(b_addr, kBox));
}
template <>
__device__ __forceinline__ void mma_rs<2>(float (&d)[64], const uint32_t (&a)[4],
                                          uint32_t b_addr) {
  wgmma_rs_m64n128k16(d, a, desc_sw128(b_addr, kBox));
}

// d (64 x 64, fp32) = A·Bᵀ over D: A and B 64-row tiles, K-major in shared
// memory (kChunks boxes), one k16 step 32 bytes inside a box
template <int kChunks>
__device__ __forceinline__ void mma_scores(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * kChunks; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_m64n64k16<0, 0>(d, desc_sw128(a + off, 16), desc_sw128(b + off, 16), kk > 0);
  }
}

// fragment element e of a thread's 64 x 64 accumulator: row 16·warp +
// lane/4 + 8·((e/2) % 2), column 8·(e/4) + 2·(lane % 4) + e % 2.  The
// fragment of columns [16kk, 16kk + 16) is, pair by pair, the A fragment
// of k16 step kk of the next product.

// bf16 pairs of rows row0 and row0 + 8 of a (rows, D) gradient from a
// 64 x 64·kChunks accumulator
template <int kChunks>
__device__ __forceinline__ void store_frag(bf16* out, long long stride_s,
                                           const float (&a)[32 * kChunks], int row0,
                                           int col_in, int S, int D) {
#pragma unroll
  for (int e = 0; e < 32 * kChunks; e += 2) {
    const int row = row0 + 8 * ((e / 2) % 2);
    const int col = 8 * (e / 4) + col_in;
    if (row >= S || col >= D) continue;
    bf16* dst = out + row * stride_s + col;
    if (col + 1 < D) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a[e], a[e + 1]);
    } else {
      *dst = __float2bfloat16(a[e]);
    }
  }
}

// (b), bf16: one block per (64-key tile, batch·KV head).  Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ put the keys on the accumulator's rows, so pᵀ and dSᵀ are
// the register A operands of dV += pᵀ·dO and dK += dSᵀ·Q, with dO and Q
// the MN-major B.  Q and dO of the walked (head, query tile) pairs come
// through a two-stage TMA ring, their lse (in log2 units) and delta
// through a two-stage array the threads fill one tile ahead.
template <int kChunks>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, Str3 sdk, Str3 sdv, int H, int G,
                            int Sq, int Sk, int D, int causal, int window,
                            float scale, float scale_log2) {
  constexpr int kT = kBox * kChunks;  // one tile's bytes
  constexpr int kAcc = 32 * kChunks;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float lse_s[2][kTile], dl_s[2][kTile];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + kT;
  auto q_s = [&](int st) { return base + (2 + 2 * st) * kT; };
  auto do_s = [&](int st) { return base + (3 + 2 * st) * kT; };
  const uint32_t kv_full = base + 6 * kT;
  auto full = [&](int st) { return kv_full + 8 * (1 + st); };

  const int KV = H / G;
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / KV;
  const int hk = blockIdx.y % KV;
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt_begin = causal ? k0 / kTile : 0;
  const int qt_end = window > 0 ? min(n_qt, (k0 + kTile - 2 + window) / kTile + 1) : n_qt;
  const int nq = qt_end - qt_begin;
  const int n = G * nq;  // walked (head, query tile) pairs, head-major
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int i) {  // thread 0: pair i's Q and dO into stage i % 2
    const int st = i & 1;
    const int h = hk * G + i / nq;
    const int q0 = (qt_begin + i % nq) * kTile;
    mbar_expect_tx(full(st), 2 * kT);
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(q_s(st) + c * kBox, &tq, full(st), 64 * c, q0, h, b);
      tma_load_4d(do_s(st) + c * kBox, &tdo, full(st), 64 * c, q0, h, b);
    }
  };
  auto stage_rows = [&](int i) {  // all threads: pair i's lse and delta
    const int st = i & 1;
    const long long at = (static_cast<long long>(b) * H + hk * G + i / nq) * Sq;
    const int row = (qt_begin + i % nq) * kTile + tid % kTile;
    if (tid < kTile)
      lse_s[st][tid] = row < Sq ? lse[at + row] * kLog2e : INFINITY;
    else
      dl_s[st][tid - kTile] = row < Sq ? delta[at + row] : 0.f;
  };
  if (tid == 0) {
    mbar_expect_tx(kv_full, 2 * kT);
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(k_s + c * kBox, &tk, kv_full, 64 * c, k0, hk, b);
      tma_load_4d(v_s + c * kBox, &tv, kv_full, 64 * c, k0, hk, b);
    }
    issue(0);
  }
  stage_rows(0);
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // and key0 + 8
  const int col_in = 2 * (lane % 4);
  float adv[kAcc], adk[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) adv[e] = adk[e] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    // stage st ^ 1 was last read in pair i − 1, which every thread has left
    if (tid == 0 && i + 1 < n) issue(i + 1);
    const int q0 = (qt_begin + i % nq) * kTile;
    mbar_wait(full(st), (i >> 1) & 1);

    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    mma_scores<kChunks>(s, k_s, q_s(st));
    mma_scores<kChunks>(dp, v_s, do_s(st));
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // pᵀ in s, dSᵀ in dp; a pair is masked where the tile crosses the
    // diagonal or reaches below the window
    const bool masked = (causal && q0 < k0 + kTile - 1) ||
                        (window > 0 && q0 + kTile - 1 >= k0 + window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = 8 * (e / 4) + col_in + (e % 2);
      float p = exp2f(s[e] * scale_log2 - lse_s[st][c]);
      if (masked) {
        const int key = key0 + 8 * ((e / 2) % 2);
        const int row = q0 + c;
        if ((causal && key > row) || (window > 0 && key <= row - window)) p = 0.f;
      }
      dp[e] = p * (dp[e] - dl_s[st][c]) * scale;
      s[e] = p;
    }
    uint32_t ph[4][4], pl[4][4], ds[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      ds[e / 8][(e % 8) / 2] = pack_bf16(dp[e], dp[e + 1]);
      split_pack(make_float2(s[e], s[e + 1]), ph[e / 8][(e % 8) / 2],
                 pl[e / 8][(e % 8) / 2]);
    }

    // dV += (pᵀ hi + pᵀ lo)·dO, dK += dSᵀ·Q over the 64 queries in k16
    // steps of 16 rows (2048 bytes)
    fence_regs(adv);
    fence_regs(adk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs<kChunks>(adv, ph[kk], do_s(st) + kk * 2048);
      mma_rs<kChunks>(adv, pl[kk], do_s(st) + kk * 2048);
      mma_rs<kChunks>(adk, ds[kk], q_s(st) + kk * 2048);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(adv);
    fence_regs(adk);
    if (i + 1 < n) stage_rows(i + 1);
    __syncthreads();
  }

  store_frag<kChunks>(dk + b * sdk.b + hk * sdk.h, sdk.s, adk, key0, col_in, Sk, D);
  store_frag<kChunks>(dv + b * sdv.b + hk * sdv.h, sdv.s, adv, key0, col_in, Sk, D);
}

// (c), bf16: one block per (64-row query tile, batch·head), the tiles with
// the most keys first.  Q and dO load once; K and V tiles come through a
// two-stage TMA ring; S = Q·Kᵀ and dP = dO·Vᵀ, then dQ += dS·K with dS
// the register A operand and K the MN-major B.
template <int kChunks>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq,
                          Str3 sdq, int H, int G, int Sq, int Sk, int D, int causal,
                          int window, float scale, float scale_log2) {
  constexpr int kT = kBox * kChunks;
  constexpr int kAcc = 32 * kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + kT;
  auto k_s = [&](int st) { return base + (2 + 2 * st) * kT; };
  auto v_s = [&](int st) { return base + (3 + 2 * st) * kT; };
  const uint32_t q_full = base + 6 * kT;
  auto full = [&](int st) { return q_full + 8 * (1 + st); };

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / G;
  const int kv_end = causal ? min(Sk, q0 + kTile) : Sk;
  const int n_kv = (kv_end + kTile - 1) / kTile;
  const int n_begin = window > 0 ? max(0, q0 - window + 1) / kTile : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int j) {  // thread 0: key tile j into stage (j − n_begin) % 2
    const int st = (j - n_begin) & 1;
    mbar_expect_tx(full(st), 2 * kT);
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(k_s(st) + c * kBox, &tk, full(st), 64 * c, j * kTile, hk, b);
      tma_load_4d(v_s(st) + c * kBox, &tv, full(st), 64 * c, j * kTile, hk, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, 2 * kT);
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(q_s + c * kBox, &tq, q_full, 64 * c, q0, h, b);
      tma_load_4d(do_s + c * kBox, &tdo, q_full, 64 * c, q0, h, b);
    }
    issue(n_begin);
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 16 * warp + lane / 4;  // and row0 + 8
  const int col_in = 2 * (lane % 4);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = static_cast<long long>(blockIdx.y) * Sq + row;
    lse2[r] = row < Sq ? lse[at] * kLog2e : INFINITY;
    dl[r] = row < Sq ? delta[at] : 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;

  mbar_wait(q_full, 0);
  for (int j = n_begin; j < n_kv; ++j) {
    const int i = j - n_begin;
    const int st = i & 1;
    // stage st ^ 1 was last read in tile j − 1, which every thread has left
    if (tid == 0 && j + 1 < n_kv) issue(j + 1);
    mbar_wait(full(st), (i >> 1) & 1);

    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    mma_scores<kChunks>(s, q_s, k_s(st));
    mma_scores<kChunks>(dp, do_s, v_s(st));
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS in dp; a tile is masked where it runs past Sk, crosses the
    // diagonal or reaches below the window
    const int kv0 = j * kTile;
    const bool masked = kv0 + kTile > Sk || (causal && kv0 + kTile - 1 > q0) ||
                        (window > 0 && kv0 <= q0 + kTile - 1 - window);
    uint32_t ds[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      float d2[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = (e / 2) % 2;
        float p = exp2f(s[e + x] * scale_log2 - lse2[r]);
        if (masked) {
          const int key = kv0 + 8 * (e / 4) + col_in + x;
          const int row = row0 + 8 * r;
          if (key >= Sk || (causal && key > row) || (window > 0 && key <= row - window))
            p = 0.f;
        }
        d2[x] = p * (dp[e + x] - dl[r]) * scale;
      }
      ds[e / 8][(e % 8) / 2] = pack_bf16(d2[0], d2[1]);
    }

    // dQ += dS·K over the 64 keys in k16 steps of 16 rows (2048 bytes)
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<kChunks>(acc, ds[kk], k_s(st) + kk * 2048);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    __syncthreads();
  }

  store_frag<kChunks>(dq + b * sdq.b + h * sdq.h, sdq.s, acc, row0, col_in, Sq, D);
}

template <int kChunks>
cudaError_t launch_bf16(const Args& a, const long long* st, cudaStream_t stream) {
  // q's and dO's maps span H heads and Sq rows, k's and v's KV heads and Sk
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map(&tq, a.q, st, a.B, a.H, a.Sq, a.D, kTile) ||
      !encode_map(&tk, a.k, st + 3, a.B, a.KV, a.Sk, a.D, kTile) ||
      !encode_map(&tv, a.v, st + 6, a.B, a.KV, a.Sk, a.D, kTile) ||
      !encode_map(&tdo, a.dout, st + 12, a.B, a.H, a.Sq, a.D, kTile))
    return cudaErrorInvalidValue;
  const int smem = 1024 + 6 * kBox * kChunks + 8 * 3;
  static bool kv_in = false, q_in = false;
  cudaError_t err = opt_in(flash_bwd_dkdv_wgmma_kernel<kChunks>, smem, kv_in);
  if (err == cudaSuccess) err = opt_in(flash_bwd_dq_wgmma_kernel<kChunks>, smem, q_in);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(a.D));
  const float scale_log2 = kLog2e * scale;
  const int G = a.H / a.KV;
  flash_bwd_dkdv_wgmma_kernel<kChunks>
      <<<dim3((a.Sk + kTile - 1) / kTile, a.B * a.KV), kWgThreads, smem, stream>>>(
          tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
          static_cast<bf16*>(a.dv), a.sdk, a.sdv, a.H, G, a.Sq, a.Sk, a.D, a.causal,
          a.window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<kChunks>
      <<<dim3((a.Sq + kTile - 1) / kTile, a.B * a.H), kWgThreads, smem, stream>>>(
          tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), a.sdq, a.H, G,
          a.Sq, a.Sk, a.D, a.causal, a.window, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, H, Sq, D) and k, v, dk, dv: (B, KV, Sk, D), H a
// multiple of KV, with unit D stride; st: the (b, h, s) strides in
// elements of q, k, v, o, dout, dq, dk and dv in that order; lse: the
// forward's (B, H, Sq) fp32, contiguous; delta: (B, H, Sq) fp32 scratch
// the first kernel fills; bf16_data != 0 for bfloat16 data (lse and delta
// fp32 either way).  Masks as launch_flash_attention's: causal needs Sq = Sk,
// window > 0 a causal call.
cudaError_t launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout,
                                       const float* lse, float* delta, void* dq,
                                       void* dk, void* dv, const long long* st,
                                       int B, int H, int KV, int Sq, int Sk, int D,
                                       int causal, int window, int bf16_data,
                                       cudaStream_t stream) {
  if (D < 1 || D > 128 || Sq < 1 || Sk < 1 || (causal && Sq != Sk) || B * H < 1 ||
      B * H > 65535 || KV < 1 || H % KV != 0 || window < 0 || (window > 0 && !causal))
    return cudaErrorInvalidValue;
  // TMA: 16-byte aligned bases (the wrapper checks them and the strides)
  if (bf16_data && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(dout)) % 16)
    return cudaErrorMisalignedAddress;
  auto s3 = [&](int i) { return Str3{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv, s3(0), s3(1), s3(2), s3(4),
               s3(5), s3(6), s3(7), B, H, KV, Sq, Sk, D, causal, window};
  const long long rows = static_cast<long long>(B) * H * Sq;
  const dim3 grid_delta(static_cast<unsigned>((rows + 7) / 8));
  if (bf16_data) {
    flash_bwd_delta_kernel<bf16><<<grid_delta, 256, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, s3(3),
        s3(4), H, Sq, D, rows);
  } else {
    flash_bwd_delta_kernel<float><<<grid_delta, 256, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta, s3(3),
        s3(4), H, Sq, D, rows);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bf16_data)
    return D <= 64 ? launch_bf16<1>(a, st, stream) : launch_bf16<2>(a, st, stream);
  return D <= 64 ? launch_fp32<64>(a, stream) : launch_fp32<128>(a, stream);
}
