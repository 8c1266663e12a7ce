// Flash attention forward for Hopper (sm_90a): the LM prefill's
// self-attention.
//
// Replaces the TPU kernel flash_attention (_kernel) of
// src/repro/kernels/flash_attention.py: o = softmax(q kᵀ / √D) v per
// (batch, head), causal or not, with the online softmax (running max m,
// sum l and the output accumulator in fp32), masked scores at -1e30 and
// the probabilities rounded to v's dtype before the PV product, as the
// TPU kernel and the model's _sdpa do.  k and v may have fewer heads than q
// (grouped-query attention, the model's _sdpa contract): q is (B, H, Sq, D),
// k and v (B, KV, Sk, D) with H a multiple of KV, and query head h reads KV
// head h / (H / KV) in place, with no copy of K or V per group; the TPU
// kernel itself took equal heads.  Sk may differ from Sq when the
// attention is not causal (the encoder-decoder's cross-attention: the
// decoder's queries over the encoder's frames); causal attention needs
// Sq = Sk, and the launcher refuses anything else.  A causal call may
// take a sliding window (window > 0): key k is kept for query q where
// q - window < k <= q, the reference model's mask for a prefill longer
// than its attn_window (src/repro/models/layers.py, attention); window 0
// is none.  Two instantiations, chosen by dtype (neither stands in for the
// other):
//
//   bf16  flash_fwd_wgmma_kernel (namespace tc): both products on the
//         tensor cores with wgmma, K/V fed by TMA through a shared-memory
//         ring (design below, at the kernel).
//   fp32  flash_fwd_kernel: fp32 FMAs on the CUDA cores.  fp32's parity
//         bar (2e-5 of the largest output) rules out one TF32 pass and
//         bf16 tensor cores; a split that keeps fp32's bits (3xTF32, as
//         the fp32 backward runs, flash_attention_bwd.cu) is not ruled
//         out, and is not done here yet.
//
// With an lse pointer (training: kLse, a template flag, so the serving
// kernels are unchanged) both also write each row's log-sum-exp of its
// scaled scores, m + log(l) in natural-log units, as the reference's
// _flash_fwd_core returns it; flash_attention_bwd.cu recomputes the
// probabilities from it.
//
// Common to both.  The TPU grid walked the kv blocks in sequence and
// carried m, l and acc in VMEM scratch from one grid step to the next.
// Here one thread block owns one (batch·head, query tile), the kv loop
// runs inside it and m, l and the accumulator live in registers.  Causal
// tiles above the diagonal are never loaded, and with a window neither
// are the tiles wholly below it: the kv loop starts at the tile that holds
// key q0 - window + 1 of the block's first row q0, so a windowed prefill
// costs O(S·window), not O(S²).  Every row keeps its diagonal key, so no
// row is fully masked; a row whose keys all lie in a later tile than the
// first one the block loads sees that tile as scores of -1e30 (p = 1
// against a running max of -1e30), and the first kept key's max clears
// them (alpha = 0).  The query tiles are walked from the longest causal
// row first so the heavy blocks start early.  q,
// k, v and o are read and written through their (batch, head, seq)
// strides, so the model's (B, S, H, D) projections are passed as
// transposed views with no copy.  Any Sq, Sk >= 1 and D <= 128.
//
// What bounds it on an H100: at the serving shapes (1, 32, S, 64) causal
// the work is 4·S²·D·H/2 operations over 4·S·D·H·2 bytes, ~S/4 operations
// per byte, far above the ridge: the bound is the tensor cores' 989
// TFLOP/s in bf16 and the CUDA cores' 67 TFLOP/s in fp32.
//
// fp32 kernel: one 256-thread block per 64 query rows; Q stays in shared
// memory, each 64-row K and V tile is staged in shared memory, thread
// (ty, tx) holds rows ty + 16i, i < 4, and columns 4tx + 64g .. +3 of the
// accumulator; both products are register-tiled 4 x 4 per thread from
// float4 shared loads.  Ragged tiles are masked in place and D is padded
// with zeros to 64 or 128 in shared memory.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <stdint.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;
constexpr int kPPitch = kBlockKV + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
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

template <typename T, int kDPad, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides3 sq,
                 Strides3 sk, Strides3 sv, Strides3 so, int H, int G, int Sq,
                 int Sk, int D, int causal, int window, float scale) {
  constexpr int kPitch = kDPad + 4;
  constexpr int kCols = kDPad / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kBlockQ x kPitch
  float* Ks = Qs + kBlockQ * kPitch;            // kBlockKV x kPitch
  float* Vs = Ks + kBlockKV * kPitch;           // kBlockKV x kPitch
  float* Ps = Vs + kBlockKV * kPitch;           // kBlockQ x kPPitch

  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / G;  // the KV head of query head h's group
  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + hk * sk.h;
  const T* vp = v + b * sv.b + hk * sv.h;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, kDPad>(Qs, qp, sq.s, q0, Sq, D);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  // the first tile that holds a key in row q0's window
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kBlockKV * kBlockKV : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, kDPad>(Ks, kp, sk.s, kv0, Sk, D);
    load_tile<T, kDPad>(Vs, vp, sv.s, kv0, Sk, D);
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
        const bool keep = col < Sk && (!causal || col <= row) &&
                          (window == 0 || col > row - window);
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

  if constexpr (kLse) {
    // every thread of a row's half-warp holds its m and l
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (tx == 0 && row < Sq)
        lse[static_cast<long long>(blockIdx.y) * Sq + row] = m[i] + logf(l[i]);
    }
  }
  T* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int g = 0; g < kDPad / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * g + e;
        if (col < D) op[row * so.s + col] = from_f32<T>(acc[i][4 * g + e] / l[i]);
      }
  }
}

template <typename T, int kDPad, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const long long* st, int B, int H, int KV,
                   int Sq, int Sk, int D, int causal, int window,
                   cudaStream_t stream) {
  constexpr int kPitch = kDPad + 4;
  const int smem = static_cast<int>(sizeof(float)) *
                   (kBlockQ * kPitch + 2 * kBlockKV * kPitch + kBlockQ * kPPitch);
  auto kern = flash_fwd_kernel<T, kDPad, kLse>;
  // opt in to the shared memory once per instantiation (outside any CUDA
  // graph capture that later launches record into)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  const Strides3 sq{st[0], st[1], st[2]};
  const Strides3 sk{st[3], st[4], st[5]};
  const Strides3 sv{st[6], st[7], st[8]};
  const Strides3 so{st[9], st[10], st[11]};
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, sv, so, H, H / KV,
      Sq, Sk, D, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores (wgmma), K/V through a TMA ring.
//
// One block of 288 threads owns one (batch·head, 128-row query tile): two
// consumer warpgroups of 64 query rows each and one producer warp.  The
// producer's lane 0 loads the Q tile once and then 128-row K and V tiles
// into a two-stage shared-memory ring with cp.async.bulk.tensor (TMA), each
// stage completing on a "full" mbarrier and handed back on an "empty" one.
// The tensor maps are 4-D over the (D, S, heads, B) view of q, k and v with
// their own strides, lengths and head counts (Sq and H for q, Sk and KV for
// k and v; a block of query head h loads K/V head h / (H / KV)), so a tile
// never crosses into the next head: rows past the length and columns past
// D arrive as zeros (TMA's out-of-bounds fill).  Tiles
// are 64 columns wide (128 bytes) with the 128-byte swizzle; D = 128 is two
// such boxes side by side.
//
// Per kv tile a consumer warpgroup runs
//   S = Q·Kᵀ   wgmma m64n128k16, Q and K both K-major in shared memory;
//   online softmax on the S fragment in registers (row max and sum over the
//              4 threads that share a row: shfl_xor 1, 2), p = exp(s − m)
//              in fp32, l summed from the unrounded p, p rounded to bf16;
//   O += P·V   wgmma m64n(D)k16 with P as the register A operand (the
//              accumulator fragment of S is, pair by pair, the A fragment
//              of the next product) and V MN-major in shared memory.
// Scores are kept in log2 units (s · log2(e)/√D, exp2) — the same
// function as exp(s/√D − m) up to fp32 rounding.
namespace tc {

constexpr int kBlockQ = 128;
constexpr int kBlockKV = 128;
constexpr int kStages = 2;
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kBoxBytes = 128 * 128;         // 128 rows x 64 bf16 columns

template <int kChunks>
__device__ __forceinline__ void wgmma_pv(float (&o)[32 * kChunks],
                                         const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_pv<1>(float (&o)[32], const uint32_t (&a)[4],
                                            uint64_t desc) {
  wgmma_rs_m64n64k16(o, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_pv<2>(float (&o)[64], const uint32_t (&a)[4],
                                            uint64_t desc) {
  wgmma_rs_m64n128k16(o, a, desc);
}

// kChunks 64-column boxes cover D (D <= 64 * kChunks); kLse: write lse
template <int kChunks, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       Strides3 so, int H, int G,
                       int Sq, int Sk, int D, int causal, int window,
                       float scale_log2) {
  constexpr int kTile = kBoxBytes * kChunks;   // one Q, K or V tile
  constexpr int kAcc = 32 * kChunks;           // O fragment per thread
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + kTile;          // stage st: K at +2·st·kTile, V after
  const uint32_t bars = kv_s + 2 * kStages * kTile;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };

  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;  // longest rows first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / G;  // the KV head of query head h's group
  const int kv_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  const int n_kv = (kv_end + kBlockKV - 1) / kBlockKV;
  // the first tile that holds a key in row q0's window; the producer and
  // the consumers count ring stages and parities from it
  const int n_begin = window > 0 ? max(0, q0 - window + 1) / kBlockKV : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: lane 0 keeps the ring full
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, kTile);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(q_s + c * kBoxBytes, &tq, q_full, 64 * c, q0, h, b);
      for (int n = n_begin; n < n_kv; ++n) {
        const int i = n - n_begin;
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty(st), ((i / kStages) - 1) & 1);
        const uint32_t k_s = kv_s + 2 * st * kTile;
        mbar_expect_tx(full(st), 2 * kTile);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(k_s + c * kBoxBytes, &tk, full(st), 64 * c, n * kBlockKV, hk, b);
          tma_load_4d(k_s + kTile + c * kBoxBytes, &tv, full(st), 64 * c,
                      n * kBlockKV, hk, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64·wg + [0, 64)
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
  const int col_in = 2 * (lane % 4);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int n = n_begin; n < n_kv; ++n) {
    const int i = n - n_begin;
    const int st = i % kStages;
    const uint32_t k_s = kv_s + 2 * st * kTile;
    const uint32_t v_s = k_s + kTile;
    mbar_wait(full(st), (i / kStages) & 1);

    // S = Q Kᵀ over D in k16 steps; the step moves 32 bytes inside a box
    float s[64];
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kChunks; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_m64n128k16(s, desc_sw128(q_s + off + 64 * wg * 128, 16),
                          desc_sw128(k_s + off, 16), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // mask, online softmax.  s[i]: row row0 + 8·((i/2)%2), column
    // kv0 + 8·(i/4) + col_in + i%2.  A tile is masked where it runs past
    // Sk, crosses the diagonal of this warpgroup's first row, or (window)
    // reaches below the window of its last row q0 + 64·wg + 63
    const int kv0 = n * kBlockKV;
    const bool masked = kv0 + kBlockKV > Sk ||
                        (causal && kv0 + kBlockKV - 1 > q0 + 64 * wg) ||
                        (window > 0 && kv0 <= q0 + 64 * wg + 63 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float v = s[i] * scale_log2;
      if (masked) {
        const int row = row0 + 8 * ((i / 2) % 2);
        const int col = kv0 + 8 * (i / 4) + col_in + (i % 2);
        if (col >= Sk || (causal && col > row) ||
            (window > 0 && col <= row - window))
          v = kNegInf;
      }
      s[i] = v;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], v);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = (i / 2) % 2;
      const float p0 = exp2f(s[i] - m[r]);
      const float p1 = exp2f(s[i + 1] - m[r]);
      sum[r] += p0 + p1;
      p[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i / 2) % 2];

    // O += P V over the 128 kv rows in k16 steps of 16 rows (2048 bytes)
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk)
      wgmma_pv<kChunks>(acc, p[kk], desc_sw128(v_s + kk * 2048, kBoxBytes));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(st));
  }

  // o = acc / l in bf16; the 4 threads of a row hold parts of its sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (kLse) {
    // m is in log2 units of the scaled scores: lse = (m + log2 l)·ln 2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (lane % 4 == 0 && row < Sq)
        lse[static_cast<long long>(blockIdx.y) * Sq + row] =
            (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
  __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int row = row0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + col_in;
    if (row >= Sq || col >= D) continue;
    const float li = l[(i / 2) % 2];
    __nv_bfloat16* dst = op + row * so.s + col;
    if (col + 1 < D) {
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[i] / li, acc[i + 1] / li);
    } else {
      *dst = __float2bfloat16(acc[i] / li);
    }
  }
}

template <int kChunks, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const long long* st, int B, int H, int KV,
                   int Sq, int Sk, int D, int causal, int window,
                   cudaStream_t stream) {
  // q's map spans its H heads and Sq rows, k's and v's their KV heads and
  // Sk rows
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, st, B, H, Sq, D, kBlockKV) ||
      !encode_map(&tk, k, st + 3, B, KV, Sk, D, kBlockKV) ||
      !encode_map(&tv, v, st + 6, B, KV, Sk, D, kBlockKV))
    return cudaErrorInvalidValue;
  const int smem = 1024 + (1 + 2 * kStages) * kBoxBytes * kChunks +
                   8 * (1 + 2 * kStages);
  auto kern = flash_fwd_wgmma_kernel<kChunks, kLse>;
  // opt in once per instantiation, outside any CUDA graph capture that
  // later launches are recorded into
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  const Strides3 so{st[9], st[10], st[11]};
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                         lse, so, H, H / KV, Sq, Sk, D, causal,
                                         window, scale_log2);
  return cudaGetLastError();
}

}  // namespace tc

namespace {

// the instantiation for the dtype and D
template <bool kLse>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, const long long* st, int B, int H, int KV,
                     int Sq, int Sk, int D, int causal, int window, int bf16,
                     cudaStream_t stream) {
  if (bf16)
    return D <= 64 ? tc::launch<1, kLse>(q, k, v, o, lse, st, B, H, KV, Sq, Sk, D,
                                         causal, window, stream)
                   : tc::launch<2, kLse>(q, k, v, o, lse, st, B, H, KV, Sq, Sk, D,
                                         causal, window, stream);
  return D <= 64 ? launch<float, 64, kLse>(q, k, v, o, lse, st, B, H, KV, Sq, Sk,
                                           D, causal, window, stream)
                 : launch<float, 128, kLse>(q, k, v, o, lse, st, B, H, KV, Sq, Sk,
                                            D, causal, window, stream);
}

}  // namespace

// q, o: (B, H, Sq, D) and k, v: (B, KV, Sk, D), H a multiple of KV, with
// unit D stride; st: the (b, h, s) strides of q, k, v and o in that order,
// in elements; bf16 != 0 for bfloat16 data.  Query head h attends with KV
// head h / (H / KV) (grouped-query attention; KV = H is multi-head).
// Causal attention needs Sq = Sk; window > 0 (a sliding window) needs a
// causal call.  lse: nullptr, or (B, H, Sq) fp32 contiguous, each row's
// log-sum-exp of its scaled scores.
cudaError_t launch_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const long long* st,
                                   int B, int H, int KV, int Sq, int Sk, int D,
                                   int causal, int window, int bf16,
                                   cudaStream_t stream) {
  if (D < 1 || D > 128 || Sq < 1 || Sk < 1 || (causal && Sq != Sk) || B * H < 1 ||
      B * H > 65535 || KV < 1 || H % KV != 0 || window < 0 || (window > 0 && !causal))
    return cudaErrorInvalidValue;
  // TMA: 16-byte aligned base and strides (the wrapper checks them first)
  if (bf16 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorMisalignedAddress;
  return lse != nullptr
             ? dispatch<true>(q, k, v, o, lse, st, B, H, KV, Sq, Sk, D, causal,
                              window, bf16, stream)
             : dispatch<false>(q, k, v, o, lse, st, B, H, KV, Sq, Sk, D, causal,
                               window, bf16, stream);
}
