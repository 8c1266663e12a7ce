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
//   fp32  flash_fwd_tf32_kernel (namespace f32): both products on the
//         tensor cores as 3xTF32 on mma.sync (each fp32 operand split into
//         TF32 hi + lo, a product taken as lo·hi + hi·lo + hi·hi: ~22 of
//         fp32's 24 bits, where one TF32 product keeps 11 and misses
//         fp32's parity bar, 2e-5 of the largest output), K/V through a
//         cp.async ring (design below, at the kernel).
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
// TFLOP/s in bf16 and, in fp32, their 495 TFLOP/s of TF32 for three TF32
// products a product (kernels/cost.py).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <stdint.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides3 {
  long long b, h, s;  // in elements; the last (D) stride is 1
};

// ---------------------------------------------------------------------------
// fp32: both products on the tensor cores as 3xTF32 (hopper_tc.cuh).
//
// One block of 256 threads (8 warps) owns one (batch·head, 128-row query
// tile); warp w owns its 16 rows q0 + 16w.., and per kv tile runs
//   S = Q·Kᵀ   mma.sync m16n8k8 over D, Q as A fragments split into TF32
//              hi + lo once a block (kept in shared memory in fragment
//              order, two 16-byte loads a k-step), K as B fragments split
//              as they are read;
//   online softmax on the S fragment in registers (a row's max and sum
//              over the 4 lanes that share it: shfl_xor 1, 2), p = exp(s −
//              m) in fp32, each lane summing l over its own columns (the
//              lanes' parts are added once, at the end);
//   O += P·V   P from the accumulator to the A operand in registers
//              (tc::acc_as_a, one k8 slice of keys at a time, split as it
//              goes), V as B fragments whose rows follow that order, split
//              in three (v = hi + lo + lo2 exactly: lo2 the two bits the
//              truncated lo drops) and taken as hi_p·lo2 + lo_p·hi +
//              hi_p·lo + hi_p·hi, so a p of exactly 1 (one kept key, a
//              window of 1) gives v itself, as an fp32 product does; the
//              tile's P·V is summed in a fresh accumulator and added to O
//              by one fp32 FMA, o·alpha + pv, so the tensor cores' sums
//              (which truncate) run over one tile's keys only.
// K and V tiles (kKV keys, rows of D + 4 floats, so a warp's fragment
// loads hit 32 distinct banks) go through a ring of kStages stages by
// cp.async, the next kStages − 1 tiles in flight during a tile's products;
// one barrier a tile.  D <= 64: 64-key tiles, three stages (169,984 bytes
// with Q's fragments); D = 128: 32-key tiles, two stages (198,656 bytes:
// Q's fragments take 128 KB).  A warp skips a tile in which none of its
// rows keeps a key (above its last row's diagonal, below its first row's
// window, or its rows all past Sq); a tile that crosses a mask reads each
// element's.  The grid is (batch·head, query tile), the longest causal
// rows first in launch order for every head.
namespace f32 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;

// v = hi + lo + lo2 exactly: tc::split_tf32's hi and lo, and lo2 the bits
// of v − hi that the truncated lo drops (at most 2 significant bits)
__device__ __forceinline__ void split3_tf32(float v, uint32_t& hi, uint32_t& lo,
                                            uint32_t& lo2) {
  hi = tc::to_tf32(v);
  const float r = v - __uint_as_float(hi);
  lo = __float_as_uint(r) & 0xFFFFE000u;
  lo2 = __float_as_uint(r - __uint_as_float(lo));
}

// shared memory in floats for D padded to kDPad: Q's hi and lo fragments
// (each warp kDPad / 8 k-steps x 32 lanes x 4 values, hi then lo), then
// the ring, each stage a K and a V tile of kKV rows of kDPad + 4 floats
template <int kDPad>
struct Layout {
  static constexpr int kKV = kDPad == 128 ? 32 : 64;
  static constexpr int kStages = kDPad == 128 ? 2 : 3;
  static constexpr int kPitch = kDPad + 4;
  static constexpr int kQFrag = kWarps * (kDPad / 8) * 32 * 4;
  static constexpr int kRing = 2 * kQFrag;
  static constexpr int kTile = kKV * kPitch;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBytes = 4 * (kRing + kStages * kStage);
};

template <int kDPad, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Strides3 sq, Strides3 sk, Strides3 sv,
                      Strides3 so, int H, int G, int Sq, int Sk, int D, int causal,
                      int window, float scale, bool vec) {
  using L = Layout<kDPad>;
  constexpr int kKV = L::kKV, kPitch = L::kPitch, kStages = L::kStages;
  constexpr int kKK = kDPad / 8;   // k-steps of S over D, n8 tiles of O
  constexpr int kNS = kKV / 8;     // n8 tiles of S, k-steps of P·V
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const uint32_t sm_s = tc::smem_u32(sm);

  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBlockQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / G;  // hk: the KV head of h's group
  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int r0 = q0 + 16 * w;  // the warp's rows r0 + g8 and r0 + g8 + 8

  const float* const kp = k + b * sk.b + hk * sk.h;
  const float* const vp = v + b * sv.b + hk * sv.h;
  const int kv_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  // the first tile that holds a key in row q0's window
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kKV * kKV : 0;
  const int n_kv = (kv_end - kv_begin + kKV - 1) / kKV;

  auto load_kv = [&](int i) {
    const int kv0 = kv_begin + i * kKV;
    const uint32_t st = sm_s + 4 * (L::kRing + (i % kStages) * L::kStage);
    tc::load_f32_tile<kKV, kDPad, kThreads>(st, kPitch, kp + kv0 * sk.s, sk.s, Sk - kv0, D,
                                            vec);
    tc::load_f32_tile<kKV, kDPad, kThreads>(st + 4 * L::kTile, kPitch, vp + kv0 * sv.s, sv.s,
                                            Sk - kv0, D, vec);
  };
  // the first kStages − 1 tiles in flight while Q is split (one commit
  // group a tile, empty past the last, so the waits below count tiles)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kv) load_kv(i);
    tc::cp_commit();
  }

  // Q: this warp's rows as A fragments, split once: a_i at row g8 + 8·(i %
  // 2), column 8kk + t4 + 4·(i / 2); zero past Sq and D
  float4* const qhi = reinterpret_cast<float4*>(sm) + w * kKK * 32 + lane;
  float4* const qlo = qhi + L::kQFrag / 4;
  {
    const float* const qp = q + b * sq.b + h * sq.h;
#pragma unroll 4
    for (int kk = 0; kk < kKK; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g8 + 8 * (i % 2), col = 8 * kk + t4 + 4 * (i / 2);
        tc::split_tf32(row < Sq && col < D ? qp[row * sq.s + col] : 0.f, hi[i], lo[i]);
      }
      qhi[kk * 32] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                                 __uint_as_float(hi[2]), __uint_as_float(hi[3]));
      qlo[kk * 32] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                 __uint_as_float(lo[2]), __uint_as_float(lo[3]));
    }
  }
  __syncwarp();

  float acc[kKK][4];
#pragma unroll
  for (int c = 0; c < kKK; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's part of each row's sum

  for (int i = 0; i < n_kv; ++i) {
    tc::cp_wait<kStages - 2>();
    __syncthreads();  // tile i is in; every warp is done with tile i − 1
    if (i + kStages - 1 < n_kv) load_kv(i + kStages - 1);
    tc::cp_commit();
    const int kv0 = kv_begin + i * kKV;
    if (r0 >= Sq || (causal && kv0 > r0 + 15) ||
        (window > 0 && kv0 + kKV - 1 <= r0 - window))
      continue;  // no row of this warp keeps a key of the tile
    const float* const Ks = sm + L::kRing + (i % kStages) * L::kStage;
    const float* const Vs = Ks + L::kTile;

    // S = Q Kᵀ: s[j][e] at row r0 + g8 + 8·(e / 2), key kv0 + 8j + 2·t4 + e % 2
    float s[kNS][4];
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) {
      const float4 h4 = qhi[kk * 32], l4 = qlo[kk * 32];
      tc::Tf32Frag<4> qa;
      qa.hi[0] = __float_as_uint(h4.x);
      qa.hi[1] = __float_as_uint(h4.y);
      qa.hi[2] = __float_as_uint(h4.z);
      qa.hi[3] = __float_as_uint(h4.w);
      qa.lo[0] = __float_as_uint(l4.x);
      qa.lo[1] = __float_as_uint(l4.y);
      qa.lo[2] = __float_as_uint(l4.z);
      qa.lo[3] = __float_as_uint(l4.w);
      const float* const kr = Ks + g8 * kPitch + 8 * kk + t4;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        tc::Tf32Frag<2> kb;
        kb.set(0, kr[8 * j * kPitch]);
        kb.set(1, kr[8 * j * kPitch + 4]);
        tc::mma_3xtf32(s[j], qa, kb);
      }
    }

    // mask (only where the tile runs past Sk, crosses the diagonal of the
    // warp's first row or reaches below the window of its last), online
    // softmax
    const bool masked = kv0 + kKV > Sk || (causal && kv0 + kKV - 1 > r0) ||
                        (window > 0 && kv0 <= r0 + 15 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int row = r0 + g8 + 8 * (e / 2);
          const int col = kv0 + 8 * j + 2 * t4 + e % 2;
          if (col >= Sk || (causal && col > row) || (window > 0 && col <= row - window))
            x = kNegInf;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e / 2]);
        sum[e / 2] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];

    // pv = P V, one k8 slice of keys at a time: A's column t4 (t4 + 4) is
    // key 8j + 2·t4 (+1), so V's B fragment takes rows 8j + 2·t4 and + 1
    float pv[kKK][4];
#pragma unroll
    for (int c = 0; c < kKK; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      tc::Tf32Frag<4> pa;
      tc::acc_as_a(pa, s[j]);
      const float* const vr = Vs + (8 * j + 2 * t4) * kPitch + g8;
#pragma unroll
      for (int c = 0; c < kKK; ++c) {
        tc::Tf32Frag<2> vb;
        uint32_t lo2[2];
        split3_tf32(vr[8 * c], vb.hi[0], vb.lo[0], lo2[0]);
        split3_tf32(vr[kPitch + 8 * c], vb.hi[1], vb.lo[1], lo2[1]);
        tc::mma_tf32(pv[c], pa.hi, lo2);
        tc::mma_3xtf32(pv[c], pa, vb);
      }
    }
#pragma unroll
    for (int c = 0; c < kKK; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = fmaf(acc[c][e], alpha[e / 2], pv[c][e]);
  }
  tc::cp_wait<0>();  // no copy outlives the block

  // o = acc / l; the 4 lanes of a row hold parts of its sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (kLse) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g8 + 8 * r;
      if (t4 == 0 && row < Sq)
        lse[static_cast<long long>(bh) * Sq + row] = m[r] + logf(l[r]);
    }
  }
  float* const op = o + b * so.b + h * so.h;
#pragma unroll
  for (int c = 0; c < kKK; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g8 + 8 * (e / 2), col = 8 * c + 2 * t4 + e % 2;
      if (row < Sq && col < D) op[row * so.s + col] = acc[c][e] / l[e / 2];
    }
}

template <int kDPad, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const long long* st, int B, int H, int KV, int Sq, int Sk, int D,
                   int causal, int window, cudaStream_t stream) {
  constexpr int smem = Layout<kDPad>::kBytes;
  auto kern = flash_fwd_tf32_kernel<kDPad, kLse>;
  // opt in to the shared memory once per instantiation (outside any CUDA
  // graph capture that later launches record into)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  // 16-byte copies of K and V where their rows start 16-byte aligned
  bool vec = (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 3; i < 9; ++i) vec = vec && st[i] % 4 == 0;
  const Strides3 sq{st[0], st[1], st[2]};
  const Strides3 sk{st[3], st[4], st[5]};
  const Strides3 sv{st[6], st[7], st[8]};
  const Strides3 so{st[9], st[10], st[11]};
  kern<<<dim3(B * H, n_qt), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk, sv, so, H, H / KV,
      Sq, Sk, D, causal, window, 1.0f / sqrtf(static_cast<float>(D)), vec);
  return cudaGetLastError();
}

}  // namespace f32

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
  return D <= 64 ? f32::launch<64, kLse>(q, k, v, o, lse, st, B, H, KV, Sq, Sk, D,
                                         causal, window, stream)
                 : f32::launch<128, kLse>(q, k, v, o, lse, st, B, H, KV, Sq, Sk, D,
                                          causal, window, stream);
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
