// Flash attention forward for Hopper (sm_90a): the LM prefill's
// self-attention.
//
// Replaces the TPU kernel flash_attention (_kernel) of
// src/repro/kernels/flash_attention.py: o = softmax(q kᵀ / √D) v per
// (batch, head), causal or not, with the online softmax (running max m,
// sum l and the output accumulator in fp32), masked scores at -1e30 and
// the probabilities rounded to v's dtype before the PV product, as the
// TPU kernel and the model's _sdpa do.
//
// Design.  The TPU grid walked the kv blocks in sequence and carried m, l
// and acc in VMEM scratch from one grid step to the next.  Here one thread
// block of 256 threads owns one (batch·head, 64-row query tile) and the kv
// loop runs inside it: Q stays in shared memory, each 64-row K and V tile
// is staged in shared memory (converted to fp32 on load), and m, l and the
// 64 x D accumulator live in registers (thread (ty, tx) holds rows
// ty + 16i, i < 4, and columns 4tx + 64g .. +3).  Causal tiles above the
// diagonal are never loaded; the tiles are walked from the longest causal
// row first so the heavy blocks start early.  q, k, v and o are read and
// written through their (batch, head, seq) strides, so the model's
// (B, S, H, D) projections are passed as transposed views with no copy.
// Any S >= 1 (ragged tiles are masked in place) and D <= 128 (padded with
// zeros to 64 or 128 in shared memory); fp32 or bf16.
//
// What bounds it on an H100: at the serving shapes (1, 32, S, 64) causal
// the work is 4·S²·D·H/2 operations over 4·S·D·H·2 bytes, ~S/4 operations
// per byte, far above the ridge.  This first version multiplies in fp32
// on the CUDA cores (67 TFLOP/s peak, not the 989 of bf16 tensor cores):
// both products are register-tiled 4 x 4 per thread from float4 shared
// loads, 8 loads per 64 FMAs for QKᵀ.  Tensor cores (mma/wgmma) and a
// TMA-fed K/V ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;
constexpr int kPPitch = kBlockKV + 4;
constexpr float kNegInf = -1e30f;

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

// v rounded to T's precision and back (p.astype(v.dtype) in the reference)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

struct Strides3 {
  long long b, h, s;  // in elements; the last (D) stride is 1
};

// Rows [row0, row0 + 64) of one (batch, head) slice into shared memory as
// fp32 with row pitch kDPad + 4; rows >= S and columns >= D are zero.
template <typename T, int kDPad>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long stride_s, int row0, int S,
                                          int D) {
  constexpr int kPitch = kDPad + 4;
  for (int idx = threadIdx.x; idx < kBlockKV * kDPad; idx += kThreads) {
    const int r = idx / kDPad;
    const int d = idx % kDPad;
    const int row = row0 + r;
    float v = 0.f;
    if (row < S && d < D) v = to_f32(src[row * stride_s + d]);
    dst[r * kPitch + d] = v;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int kDPad>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides3 sq,
                 Strides3 sk, Strides3 sv, Strides3 so, int H, int S, int D,
                 int causal, float scale) {
  constexpr int kPitch = kDPad + 4;
  constexpr int kCols = kDPad / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kBlockQ x kPitch
  float* Ks = Qs + kBlockQ * kPitch;            // kBlockKV x kPitch
  float* Vs = Ks + kBlockKV * kPitch;           // kBlockKV x kPitch
  float* Ps = Vs + kBlockKV * kPitch;           // kBlockQ x kPPitch

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, kDPad>(Qs, qp, sq.s, q0, S, D);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + kBlockQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, kDPad>(Ks, kp, sk.s, kv0, S, D);
    load_tile<T, kDPad>(Vs, vp, sv.s, kv0, S, D);
    __syncthreads();

    // scores: rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < kDPad; d += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * kPitch + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * kPitch + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
    }

    // online softmax per row; the 16 threads of a row share one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        const bool keep = col < S && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * i) * kPPitch + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + half_warp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows ty + 16i, columns 4tx + 64g + e
    for (int c = 0; c < kBlockKV; c += 4) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kPPitch + c]);
#pragma unroll
      for (int g = 0; g < kDPad / 64; ++g) {
        const int col = 4 * tx + 64 * g;
        const float4 v0 = *reinterpret_cast<const float4*>(&Vs[(c + 0) * kPitch + col]);
        const float4 v1 = *reinterpret_cast<const float4*>(&Vs[(c + 1) * kPitch + col]);
        const float4 v2 = *reinterpret_cast<const float4*>(&Vs[(c + 2) * kPitch + col]);
        const float4 v3 = *reinterpret_cast<const float4*>(&Vs[(c + 3) * kPitch + col]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = &acc[i][4 * g];
          a[0] = fmaf(pf[i].x, v0.x, fmaf(pf[i].y, v1.x, fmaf(pf[i].z, v2.x, fmaf(pf[i].w, v3.x, a[0]))));
          a[1] = fmaf(pf[i].x, v0.y, fmaf(pf[i].y, v1.y, fmaf(pf[i].z, v2.y, fmaf(pf[i].w, v3.y, a[1]))));
          a[2] = fmaf(pf[i].x, v0.z, fmaf(pf[i].y, v1.z, fmaf(pf[i].z, v2.z, fmaf(pf[i].w, v3.z, a[2]))));
          a[3] = fmaf(pf[i].x, v0.w, fmaf(pf[i].y, v1.w, fmaf(pf[i].z, v2.w, fmaf(pf[i].w, v3.w, a[3]))));
        }
      }
    }
  }

  T* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int g = 0; g < kDPad / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * g + e;
        if (col < D) op[row * so.s + col] = from_f32<T>(acc[i][4 * g + e] / l[i]);
      }
  }
}

template <typename T, int kDPad>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int S, int D,
                   int causal, cudaStream_t stream) {
  constexpr int kPitch = kDPad + 4;
  const int smem = static_cast<int>(sizeof(float)) *
                   (kBlockQ * kPitch + 2 * kBlockKV * kPitch + kBlockQ * kPPitch);
  auto kern = flash_fwd_kernel<T, kDPad>;
  // opt in to the shared memory once per instantiation (outside any CUDA
  // graph capture that later launches record into)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  const Strides3 sq{st[0], st[1], st[2]};
  const Strides3 sk{st[3], st[4], st[5]};
  const Strides3 sv{st[6], st[7], st[8]};
  const Strides3 so{st[9], st[10], st[11]};
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, H, S, D,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, S, D) with unit D stride; st: the (b, h, s) strides of
// q, k, v and o in that order, in elements; bf16 != 0 for bfloat16 data.
cudaError_t launch_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, const long long* st, int B, int H,
                                   int S, int D, int causal, int bf16,
                                   cudaStream_t stream) {
  if (D < 1 || D > 128 || S < 1 || B * H < 1 || B * H > 65535)
    return cudaErrorInvalidValue;
  if (bf16) {
    return D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, st, B, H, S, D, causal, stream)
                   : launch<__nv_bfloat16, 128>(q, k, v, o, st, B, H, S, D, causal, stream);
  }
  return D <= 64 ? launch<float, 64>(q, k, v, o, st, B, H, S, D, causal, stream)
                 : launch<float, 128>(q, k, v, o, st, B, H, S, D, causal, stream);
}
