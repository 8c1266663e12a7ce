// Backward of the Mamba2 SSD intra-chunk kernel (ssd_scan.cu) for Hopper
// (sm_90a): the gradients the Mamba2 and Zamba2 training steps take through
// the SSD's quadratic term.
//
// No TPU kernel to replace: the reference has no backward kernel for
// ssd_chunk and trains the SSD by autodiff of its jnp twin (jax.vjp of
// ssd_chunk_ref in src/repro/kernels/ref.py, vmapped by ops.ssd_chunk).
// Per (chunk, head), with cs = cumsum(dt_a), L[t,s] = exp(cs_t − cs_s) on
// s <= t (0 above, masked before exp), S = C·Bᵀ, w_s = exp(cs_{Q-1} − cs_s),
// and the cotangents dy (Q x P), dst (P x N, fp32), ddec (Q, fp32):
//   dM = dy·xᵀ, dS = dM∘L
//   dx = (S∘L)ᵀ·dy + w∘(B·dstᵀ)
//   dC = dS·B,  dB = dSᵀ·C + w∘(x·dst)
//   dcs_t = Σ_s (dS∘S)[t,s] − Σ_s (dS∘S)[s,t] − dw_t·w_t + ddec_t·exp(cs_t)
//           (+ Σ_s dw_s·w_s at t = Q−1),  dw_s = Σ_n (x·dst)[s,n]·B[s,n]
//   d(dt_a) = the reverse cumsum of dcs over the chunk.
// Nothing of size Q x Q reaches device memory: S, L and dM are recomputed
// from x, dt_a, B, C and dy, tile by tile, in registers.
//
// What bounds it on an H100: bytes.  At Zamba2-1.2B's training shape (16
// chunks x 64 heads, Q = 128, P = N = 64, one B/C group) the function must
// move ~70 MB (x, dy and dx in bf16, the fp32 dst) against ~7.6 GFLOP of
// products: ~21 µs of bytes, ~7.6 µs at the bf16 tensor-core peak; at
// mamba2-2.7b's (80 heads, N = 128) ~109 MB and ~16 GFLOP (kernels/cost.py
// ssd_chunk_bwd).  This first
// kernel also writes each head's dB and dC in fp32 and reads them back for
// the group sum (2 x 34 MB at Zamba2's shape, 2 x 84 MB at mamba2-2.7b's):
// that traffic, not the products, is what a faster kernel would remove
// first (a block walking a group's heads, summing in registers).
//
// bf16 design.  One block of 256 threads (two warpgroups) per (chunk,
// head); warpgroup g owns the 64 rows 64g.. of a 128-row chunk.  x, dy, B
// and C are staged as bf16 by cp.async into 128-byte-swizzled tiles (zero
// past Q, P and N), dst as a bf16 hi/lo pair (64 rows of P, N in 64-column
// tiles).  Two passes, neither with a Q x Q tile in shared memory:
//   pass 1, rows t:  S = C·Bᵀ and dM = dy·xᵀ (wgmma, both K-major) per
//            64 x 64 tile up to the diagonal; dS = dM∘L and the row sums of
//            dS∘S on the accumulator fragment; dC += dS·B with dS as bf16
//            hi + lo register A fragments and B MN-major;
//   pass 2, rows s:  dx = w∘(B·dstᵀ) and F = x·dst (dst hi + lo), dw from F
//            and B, dB = w∘F; then per tile t >= s: Sᵀ = B·Cᵀ and dMᵀ =
//            x·dyᵀ recomputed (the transposes a warpgroup's own rows need,
//            in place of sharing a Q x Q tile across warpgroups), Wᵀ =
//            Sᵀ∘Lᵀ and dSᵀ = dMᵀ∘Lᵀ; dx += Wᵀ·dy and dB += dSᵀ·C, the fp32
//            weights as hi + lo register fragments, dy and C MN-major; the
//            row sums of dSᵀ∘Sᵀ are the column sums of dS∘S.
// Then one warp forms dcs and its reverse cumsum in a fixed order.  The
// hi/lo split is what keeps the fp32 operands (S∘L, dS, dst) exact enough:
// one bf16 rounding (2^-9 relative) of dS moves dB and dC, and of dst
// moves d(dt_a), past their bars (tests/test_torch_ssd_bwd.py emulates
// both); bf16 x bf16 products are exact and every sum stays fp32.
// Accumulators: dC (pass 1) and dx + dB (pass 2) beside two 64 x 64
// fragments take up to ~200 registers a thread at N = 128, so a block
// runs alone on its SM (84 KB of shared memory at N <= 64, 132 KB at 128).
//
// fp32 design: a simple CUDA-core kernel, one 256-thread block per (chunk,
// head).  x, dy, B and C are staged as fp32 in shared memory; 32 x 32
// tiles of S∘L, dS and dS∘S are formed one (t-tile, s-tile) pair at a
// time, s-tiles outer: dx and dB of the s-tile stay in registers, dC
// accumulates in its fp32 per-head buffer in device memory, each element
// read and written by one thread in a fixed order.
//
// Both write each head's dB and dC in fp32; group_sum_kernel then sums the
// H / G consecutive heads of each of G groups (one B/C group broadcast to
// every head: G = 1) in head order and rounds once to b's dtype.  No
// atomics: repeats are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_tc.cuh"
#include "ssd_common.cuh"

namespace {

using ssd::chunk_cumsum;
using ssd::kMaxN;
using ssd::kMaxP;
using ssd::kMaxQ;
using ssd::round_up;
using ssd::Strides4;

// Σ over the lanes in a fixed order (a tree down to lane 0), then
// broadcast: every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// d(dt_a)[k] = Σ_{t>=k} dcs_t over the chunk, by one whole warp, with
// dcs_t = rows_t − cols_t − dw_t·w_t + ddec_t·exp(cs_t), plus Σ_s dw_s·w_s
// at t = Q−1; out and ddec are (BC, Q, H) rows, `stride` (H) apart
__device__ __forceinline__ void finish_ddt(float* __restrict__ out,
                                           const float* __restrict__ ddec, long long stride,
                                           const float* rows, const float* cols,
                                           const float* dwv, const float* w,
                                           const float* cs, int Q) {
  const int lane = threadIdx.x % 32;
  const int per = (Q + 31) / 32;
  const int beg = min(lane * per, Q);
  const int end = min(beg + per, Q);
  float part = 0.f;
  for (int t = beg; t < end; ++t) part += dwv[t] * w[t];
  const float total = warp_sum(part);
  float v[kMaxQ / 32];
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int t = beg + k;
    v[k] = 0.f;
    if (t < end) {
      v[k] = rows[t] - cols[t] - dwv[t] * w[t];
      if (ddec != nullptr) v[k] += ddec[t * stride] * expf(cs[t]);
      if (t == Q - 1) v[k] += total;
    }
  }
  float run = 0.f;  // suffix sums within the lane's run
#pragma unroll
  for (int k = kMaxQ / 32 - 1; k >= 0; --k) {
    run += v[k];
    v[k] = run;
  }
  float incl = run;  // suffix scan of the runs' totals over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float down = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += down;
  }
  float excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k)
    if (beg + k < end) out[(beg + k) * stride] = v[k] + excl;
}

// out (BC·Q, G, N) = Σ over the H / G consecutive heads of each group of
// part (BC·Q, H, N), in head order, rounded once to T; blockIdx.y picks dB
// (0) or dC (1)
template <typename T>
__global__ void group_sum_kernel(const float* __restrict__ part, T* __restrict__ db,
                                 T* __restrict__ dc, long long rows, int H, int G, int N) {
  const long long total = rows * G * N;
  const float* src = part + blockIdx.y * rows * H * N;
  T* dst = blockIdx.y == 0 ? db : dc;
  const int rep = H / G;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int n = idx % N;
    const long long rg = idx / N;
    const int g = rg % G;
    const long long r = rg / G;
    const float* s = src + (r * H + static_cast<long long>(g) * rep) * N + n;
    float acc = 0.f;
    for (int k = 0; k < rep; ++k) acc += s[static_cast<long long>(k) * N];
    if constexpr (sizeof(T) == 2)
      dst[idx] = __float2bfloat16(acc);
    else
      dst[idx] = acc;
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores.

constexpr int kThreads = 256;
constexpr int kT = 32;  // tile of (t, s) pairs

__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src,
                                          long long stride_q, int n_rows, int rows,
                                          int cols, int pitch) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols;
    const int c = idx % cols;
    dst[r * pitch + c] = src != nullptr && r < n_rows ? src[r * stride_q + c] : 0.f;
  }
}

__host__ __device__ __forceinline__ int f32_smem_floats(int Q, int P, int N) {
  const int QP = round_up(Q, kT);
  return 2 * QP * (P + 1) + 2 * QP * (N + 1) + 3 * kT * (kT + 1) + 5 * QP;
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt_a,
                   const float* __restrict__ b, const float* __restrict__ c,
                   const float* __restrict__ dy, const float* __restrict__ dstate,
                   const float* __restrict__ ddecay, float* __restrict__ dx,
                   float* __restrict__ ddt, float* __restrict__ part, Strides4 sx,
                   Strides4 sa, Strides4 sb, Strides4 sc, Strides4 sy, int BC, int H,
                   int Q, int P, int N) {
  const int QP = round_up(Q, kT);
  const int pp = P + 1, pn = N + 1, pt = kT + 1;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // QP x pp
  float* DY = X + QP * pp;                     // QP x pp
  float* Bs = DY + QP * pp;                    // QP x pn
  float* Cs = Bs + QP * pn;                    // QP x pn
  float* Wt = Cs + QP * pn;                    // kT x pt: (S∘L)[t][s]
  float* Dt = Wt + kT * pt;                    // kT x pt: dS[t][s]
  float* Rt = Dt + kT * pt;                    // kT x pt: (dS∘S)[t][s]
  float* cs = Rt + kT * pt;                    // QP each:
  float* w = cs + QP;
  float* rows = w + QP;                        // Σ_s (dS∘S)[t][s]
  float* cols = rows + QP;                     // Σ_t (dS∘S)[t][s]
  float* dwv = cols + QP;

  const int h = blockIdx.x;
  const int ch = blockIdx.y;
  const int tid = threadIdx.x;
  stage_f32(X, x + ch * sx.c + h * sx.h, sx.q, Q, QP, P, pp);
  stage_f32(DY, dy == nullptr ? nullptr : dy + ch * sy.c + h * sy.h, sy.q, Q, QP, P, pp);
  stage_f32(Bs, b + ch * sb.c + h * sb.h, sb.q, Q, QP, N, pn);
  stage_f32(Cs, c + ch * sc.c + h * sc.h, sc.q, Q, QP, N, pn);
  if (tid < 32) chunk_cumsum(cs, dt_a + ch * sa.c + h * sa.h, sa.q, Q);
  __syncthreads();
  for (int t = tid; t < QP; t += kThreads) {
    w[t] = t < Q ? expf(cs[Q - 1] - cs[t]) : 0.f;
    if (t >= Q) cs[t] = 0.f;
    rows[t] = cols[t] = 0.f;
  }
  __syncthreads();

  const float* dst = dstate == nullptr ? nullptr
                                       : dstate + (static_cast<long long>(ch) * H + h) * P * N;
  const long long row0 = static_cast<long long>(ch) * Q;
  float* dbp = part;                                   // (BC, Q, H, N)
  float* dcp = part + static_cast<long long>(BC) * Q * H * N;
  // this thread's row of an s-tile and its columns p = l + 8k, n = l + 8k
  const int r = tid / 8;
  const int l = tid % 8;
  const int nT = QP / kT;
  for (int j = 0; j < nT; ++j) {
    const int s = j * kT + r;
    float dxa[kMaxP / 8], dba[kMaxN / 8];
    // the state's terms: dx = w∘(B·dstᵀ), F = x·dst, dB = w∘F, dw = Σ F∘B
    float dwp = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxP / 8; ++k) {
      const int p = l + 8 * k;
      float e = 0.f;
      if (dst != nullptr && p < P)
        for (int n = 0; n < N; ++n) e = fmaf(Bs[s * pn + n], dst[p * N + n], e);
      dxa[k] = w[s] * e;
    }
#pragma unroll
    for (int k = 0; k < kMaxN / 8; ++k) {
      const int n = l + 8 * k;
      float f = 0.f;
      if (dst != nullptr && n < N)
        for (int p = 0; p < P; ++p) f = fmaf(X[s * pp + p], dst[p * N + n], f);
      if (n < N) dwp = fmaf(f, Bs[s * pn + n], dwp);
      dba[k] = w[s] * f;
    }
    dwp += __shfl_xor_sync(0xffffffffu, dwp, 1);
    dwp += __shfl_xor_sync(0xffffffffu, dwp, 2);
    dwp += __shfl_xor_sync(0xffffffffu, dwp, 4);
    if (l == 0) dwv[s] = dwp;

    for (int i = j; i < nT; ++i) {
      // the (t-tile i, s-tile j) pairs, four a thread
      for (int idx = tid; idx < kT * kT; idx += kThreads) {
        const int tt = idx / kT, ss = idx % kT;
        const int t = i * kT + tt, s2 = j * kT + ss;
        float sv = 0.f, mv = 0.f;
        for (int n = 0; n < N; ++n) sv = fmaf(Cs[t * pn + n], Bs[s2 * pn + n], sv);
        for (int p = 0; p < P; ++p) mv = fmaf(DY[t * pp + p], X[s2 * pp + p], mv);
        const float lv = s2 <= t && t < Q ? expf(cs[t] - cs[s2]) : 0.f;
        Wt[tt * pt + ss] = sv * lv;
        Dt[tt * pt + ss] = mv * lv;
        Rt[tt * pt + ss] = mv * lv * sv;
      }
      __syncthreads();
      if (tid < kT) {
        float acc = 0.f;
        for (int ss = 0; ss < kT; ++ss) acc += Rt[tid * pt + ss];
        rows[i * kT + tid] += acc;
      } else if (tid < 2 * kT) {
        float acc = 0.f;
        for (int tt = 0; tt < kT; ++tt) acc += Rt[tt * pt + tid - kT];
        cols[j * kT + tid - kT] += acc;
      }
      // dx and dB of the s-tile: Σ_t Wᵀ·dy and Σ_t dSᵀ·C
#pragma unroll
      for (int k = 0; k < kMaxP / 8; ++k) {
        const int p = l + 8 * k;
        if (p >= P) continue;
        float acc = dxa[k];
        for (int tt = 0; tt < kT; ++tt) acc = fmaf(Wt[tt * pt + r], DY[(i * kT + tt) * pp + p], acc);
        dxa[k] = acc;
      }
#pragma unroll
      for (int k = 0; k < kMaxN / 8; ++k) {
        const int n = l + 8 * k;
        if (n >= N) continue;
        float acc = dba[k];
        for (int tt = 0; tt < kT; ++tt) acc = fmaf(Dt[tt * pt + r], Cs[(i * kT + tt) * pn + n], acc);
        dba[k] = acc;
      }
      // dC of the t-tile: Σ_s dS·B, accumulated over the s-tiles in order
      const int t = i * kT + r;
      if (t < Q) {
        float* row = dcp + ((row0 + t) * H + h) * N;
        for (int n = l; n < N; n += 8) {
          float acc = j == 0 ? 0.f : row[n];
          for (int ss = 0; ss < kT; ++ss) acc = fmaf(Dt[r * pt + ss], Bs[(j * kT + ss) * pn + n], acc);
          row[n] = acc;
        }
      }
      __syncthreads();  // the tiles are consumed
    }
    if (s < Q) {
      float* xr = dx + ((row0 + s) * H + h) * P;
#pragma unroll
      for (int k = 0; k < kMaxP / 8; ++k)
        if (l + 8 * k < P) xr[l + 8 * k] = dxa[k];
      float* br = dbp + ((row0 + s) * H + h) * N;
#pragma unroll
      for (int k = 0; k < kMaxN / 8; ++k)
        if (l + 8 * k < N) br[l + 8 * k] = dba[k];
    }
  }
  __syncthreads();
  if (tid < 32)
    finish_ddt(ddt + row0 * H + h, ddecay == nullptr ? nullptr : ddecay + row0 * H + h, H,
               rows, cols, dwv, w, cs, Q);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.
namespace ssd_bwd_tc {

using ssd::tile::aligned16;
using ssd::tile::bf16;
using ssd::tile::cp_async_commit;
using ssd::tile::cp_async_wait_all;
using ssd::tile::exp_f;
using ssd::tile::kRows;
using ssd::tile::kThreads;
using ssd::tile::kTileBytes;
using ssd::tile::pack;
using ssd::tile::split;
using ssd::tile::stage;
using ssd::tile::stage_n;
using ssd::tile::sw128;

constexpr int kDstTileBytes = kMaxP * 128;  // 64 rows (P) x 64 columns of N

// Shared memory for N in kNT 64-column tiles: x and dy (one tile each), B
// and C (kNT each), dst hi and lo (kNT 64-row tiles each), then cs, w, the
// row and column sums of dS∘S and dw; + alignment.  kNT = 1: 84 KB; kNT =
// 2: 132 KB.
template <int kNT>
struct Layout {
  static constexpr uint32_t kX = 0;
  static constexpr uint32_t kDY = kTileBytes;
  static constexpr uint32_t kB = 2 * kTileBytes;
  static constexpr uint32_t kC = (2 + kNT) * kTileBytes;
  static constexpr uint32_t kDH = (2 + 2 * kNT) * kTileBytes;
  static constexpr uint32_t kDL = kDH + kNT * kDstTileBytes;
  static constexpr uint32_t kF = kDL + kNT * kDstTileBytes;
  static constexpr int kSmem = 1024 + kF + 5 * kRows * 4;
};

// dS or S∘L of a 64 x 64 accumulator fragment, columns 32·half.. (two k16
// steps), as bf16 hi and lo register A fragments
__device__ __forceinline__ void frags(const float (&v)[32], int half, uint32_t (&hi)[2][4],
                                      uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int e = 16 * half; e < 16 * half + 16; e += 2) {
    bf16 h0, l0, h1, l1;
    split(v[e], h0, l0);
    split(v[e + 1], h1, l1);
    hi[(e / 8) % 2][(e % 8) / 2] = pack(h0, h1);
    lo[(e / 8) % 2][(e % 8) / 2] = pack(l0, l1);
  }
}

// d (+)= A·B for k16 steps over N (4·kNT) with A and B both K-major
// 64-row slices of 64-column tiles (kNT tiles kTileBytes apart)
template <int kNT>
__device__ __forceinline__ void product_over_n(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * kNT; ++kk) {
    const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
    tc::wgmma_ss_m64n64k16<0, 0>(d, tc::desc_sw128(a + off, 16), tc::desc_sw128(b + off, 16),
                                 kk > 0);
  }
}

// d (+)= A·B over P's four k16 steps, A and B K-major 64-row slices of one
// 64-column tile
__device__ __forceinline__ void product_over_p(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::wgmma_ss_m64n64k16<0, 0>(d, tc::desc_sw128(a + kk * 32, 16),
                                 tc::desc_sw128(b + kk * 32, 16), kk > 0);
}

// d += (hi + lo)·B over 64 rows of K from `b` (an MN-major operand: rows of
// K, 64 columns a tile, kNT tiles kTileBytes apart); hi, lo from `v`
template <int kNT>
__device__ __forceinline__ void product_rs(float (&d)[32 * kNT], const float (&v)[32],
                                           uint32_t b) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t hi[2][4], lo[2][4];
    frags(v, half, hi, lo);
    tc::fence_regs(d);
    tc::wg_fence();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint64_t desc = tc::desc_sw128(b + (2 * half + k) * 2048, kTileBytes);
      if constexpr (kNT == 1) {
        tc::wgmma_rs_m64n64k16(d, hi[k], desc);
        tc::wgmma_rs_m64n64k16(d, lo[k], desc);
      } else {
        tc::wgmma_rs_m64n128k16(d, hi[k], desc);
        tc::wgmma_rs_m64n128k16(d, lo[k], desc);
      }
    }
    tc::wg_commit();
    tc::wg_wait_all();
    tc::fence_regs(d);
  }
}

// Σ over the 4 lanes of a quad (one accumulator row), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int kNT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt_a,
                     const bf16* __restrict__ b, const bf16* __restrict__ c,
                     const bf16* __restrict__ dy, const float* __restrict__ dstate,
                     const float* __restrict__ ddecay, bf16* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ part, Strides4 sx,
                     Strides4 sa, Strides4 sb, Strides4 sc, Strides4 sy, int BC, int H,
                     int Q, int P, int N, int vec) {
  using Lay = Layout<kNT>;
  constexpr int kN = 32 * kNT;  // accumulators of an N-wide product
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_u32(smem);
  float* cs = reinterpret_cast<float*>(smem + Lay::kF);
  float* w = cs + kRows;
  float* rows = w + kRows;
  float* cols = rows + kRows;
  float* dwv = cols + kRows;

  const int h = blockIdx.x;
  const int ch = blockIdx.y;
  const int tid = threadIdx.x;
  stage(smem, Lay::kX, x + ch * sx.c + h * sx.h, sx.q, Q, P, vec);
  // a missing cotangent stages as zeros (0 rows: the source is not read)
  stage(smem, Lay::kDY, dy == nullptr ? x : dy + ch * sy.c + h * sy.h, sy.q,
        dy == nullptr ? 0 : Q, P, vec);
  stage_n<kNT>(smem, Lay::kB, b + ch * sb.c + h * sb.h, sb.q, Q, N, vec);
  stage_n<kNT>(smem, Lay::kC, c + ch * sc.c + h * sc.h, sc.q, Q, N, vec);
  cp_async_commit();

  // dst (P x N fp32, contiguous) as bf16 hi and lo tiles: rows p, 64
  // columns of N a tile, zero past P and N
  const float* dst = dstate == nullptr ? nullptr
                                       : dstate + (static_cast<long long>(ch) * H + h) * P * N;
  for (int idx = tid; idx < kMaxP * 8 * kNT; idx += kThreads) {
    const int r = idx / (8 * kNT);
    const int t = (idx / 8) % kNT;
    const int j = idx % 8;
    uint4 hv, lv;
    bf16* hh = reinterpret_cast<bf16*>(&hv);
    bf16* ll = reinterpret_cast<bf16*>(&lv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = 64 * t + 8 * j + e;
      const float v = dst != nullptr && r < P && n < N ? dst[r * N + n] : 0.f;
      split(v, hh[e], ll[e]);
    }
    const uint32_t off = t * kDstTileBytes + sw128(r, j);
    *reinterpret_cast<uint4*>(smem + Lay::kDH + off) = hv;
    *reinterpret_cast<uint4*>(smem + Lay::kDL + off) = lv;
  }
  if (tid < 32) {
    chunk_cumsum(cs, dt_a + ch * sa.c + h * sa.h, sa.q, Q);
    __syncwarp();
    for (int t = tid; t < kRows; t += 32) {
      w[t] = t < Q ? exp_f(cs[Q - 1] - cs[t]) : 0.f;
      if (t >= Q) cs[t] = 0.f;
      rows[t] = cols[t] = dwv[t] = 0.f;
    }
  }
  cp_async_wait_all();
  tc::fence_proxy_async();
  __syncthreads();

  // warpgroup g: rows 64g + [0, 64); this thread's fragment rows are r0 and
  // r0 + 8, its columns 8·(e/4) + cin + e%2 for accumulator e.  g comes
  // through a shuffle from lane 0 so that the compiler sees it warp-uniform
  // and does not serialize the products under `if` on it
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;
  const int r0 = 64 * g + 16 * ((tid % 128) / 32) + lane / 4;
  const int cin = 2 * (lane % 4);
  const int tiles = (Q + 63) / 64;
  const long long row0 = static_cast<long long>(ch) * Q;
  float* dbp = part;                                   // (BC, Q, H, N)
  float* dcp = part + static_cast<long long>(BC) * Q * H * N;

  if (g < tiles) {  // pass 1: rows t of this warpgroup
    float dc_acc[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) dc_acc[e] = 0.f;
    float rs[2] = {0.f, 0.f};
    const float cs_t[2] = {cs[r0], cs[r0 + 8]};
    for (int j = 0; j <= g; ++j) {  // 64-column source tiles up to the diagonal
      float sv[32], dm[32];
      tc::fence_regs(sv);
      tc::fence_regs(dm);
      tc::wg_fence();
      product_over_n<kNT>(sv, sbase + Lay::kC + 64 * g * 128, sbase + Lay::kB + 64 * j * 128);
      product_over_p(dm, sbase + Lay::kDY + 64 * g * 128, sbase + Lay::kX + 64 * j * 128);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::fence_regs(sv);
      tc::fence_regs(dm);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int t = r0 + 8 * ((e / 2) % 2);
        const int s = 64 * j + 8 * (e / 4) + cin + e % 2;
        const float lv = s <= t && t < Q ? exp_f(cs_t[(e / 2) % 2] - cs[s]) : 0.f;
        dm[e] *= lv;                        // dS
        rs[(e / 2) % 2] += dm[e] * sv[e];   // dS∘S
      }
      product_rs<kNT>(dc_acc, dm, sbase + Lay::kB + 64 * j * 128);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = quad_sum(rs[i]);
      const int t = r0 + 8 * i;
      if (lane % 4 == 0 && t < Q) rows[t] = v;
    }
    // dC of this head (fp32), rows t
#pragma unroll
    for (int e = 0; e < kN; e += 2) {
      const int t = r0 + 8 * ((e / 2) % 2);
      const int n = 8 * (e / 4) + cin;
      if (t >= Q || n >= N) continue;
      float* d = dcp + ((row0 + t) * H + h) * N + n;
      d[0] = dc_acc[e];
      if (n + 1 < N) d[1] = dc_acc[e + 1];
    }
  }

  if (g < tiles) {  // pass 2: rows s of this warpgroup
    float dx_acc[32], db_acc[kN];
    const uint32_t b_rows = sbase + Lay::kB + 64 * g * 128;
    const uint32_t x_rows = sbase + Lay::kX + 64 * g * 128;
    // the state's terms: dx = B·dstᵀ and F = x·dst (dst hi + lo), then
    // scaled by w; dw = Σ_n F∘B
    tc::fence_regs(dx_acc);
    tc::fence_regs(db_acc);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kNT; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      const uint32_t doff = (kk / 4) * kDstTileBytes + (kk % 4) * 32;
      tc::wgmma_ss_m64n64k16<0, 0>(dx_acc, tc::desc_sw128(b_rows + off, 16),
                                   tc::desc_sw128(sbase + Lay::kDH + doff, 16), kk > 0);
      tc::wgmma_ss_m64n64k16<0, 0>(dx_acc, tc::desc_sw128(b_rows + off, 16),
                                   tc::desc_sw128(sbase + Lay::kDL + doff, 16), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = tc::desc_sw128(x_rows + kk * 32, 16);
      const uint64_t dh = tc::desc_sw128(sbase + Lay::kDH + kk * 2048, kDstTileBytes);
      const uint64_t dl = tc::desc_sw128(sbase + Lay::kDL + kk * 2048, kDstTileBytes);
      if constexpr (kNT == 1) {
        tc::wgmma_ss_m64n64k16<0, 1>(db_acc, da, dh, kk > 0);
        tc::wgmma_ss_m64n64k16<0, 1>(db_acc, da, dl, 1);
      } else {
        tc::wgmma_ss_m64n128k16<0, 1>(db_acc, da, dh, kk > 0);
        tc::wgmma_ss_m64n128k16<0, 1>(db_acc, da, dl, 1);
      }
    }
    tc::wg_commit();
    tc::wg_wait_all();
    tc::fence_regs(dx_acc);
    tc::fence_regs(db_acc);
    const float w_s[2] = {w[r0], w[r0 + 8]};
    float dw[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int s = r0 + 8 * ((e / 2) % 2);
      const int n = 8 * (e / 4) + cin + e % 2;
      const bf16 bv = *reinterpret_cast<const bf16*>(
          smem + Lay::kB + (n / 64) * kTileBytes + sw128(s, (n % 64) / 8) + 2 * (n % 8));
      dw[(e / 2) % 2] += db_acc[e] * __bfloat162float(bv);
      db_acc[e] *= w_s[(e / 2) % 2];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) dx_acc[e] *= w_s[(e / 2) % 2];

    float colsum[2] = {0.f, 0.f};
    const float cs_s[2] = {cs[r0], cs[r0 + 8]};
    for (int i = g; i < tiles; ++i) {  // 64-row tiles t >= s
      float st[32], dmt[32];
      tc::fence_regs(st);
      tc::fence_regs(dmt);
      tc::wg_fence();
      product_over_n<kNT>(st, b_rows, sbase + Lay::kC + 64 * i * 128);
      product_over_p(dmt, x_rows, sbase + Lay::kDY + 64 * i * 128);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::fence_regs(st);
      tc::fence_regs(dmt);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int s = r0 + 8 * ((e / 2) % 2);
        const int t = 64 * i + 8 * (e / 4) + cin + e % 2;
        const float lv = s <= t && t < Q ? exp_f(cs[t] - cs_s[(e / 2) % 2]) : 0.f;
        dmt[e] *= lv;                              // dSᵀ
        colsum[(e / 2) % 2] += dmt[e] * st[e];     // (dS∘S)ᵀ
        st[e] *= lv;                               // (S∘L)ᵀ
      }
      product_rs<1>(dx_acc, st, sbase + Lay::kDY + 64 * i * 128);
      product_rs<kNT>(db_acc, dmt, sbase + Lay::kC + 64 * i * 128);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float cv = quad_sum(colsum[i]);
      const float dv = quad_sum(dw[i]);
      const int s = r0 + 8 * i;
      if (lane % 4 == 0 && s < Q) {
        cols[s] = cv;
        dwv[s] = dv;
      }
    }
    // dx (BC, Q, H, P) in bf16 and dB of this head (fp32), rows s
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int s = r0 + 8 * ((e / 2) % 2);
      const int p = 8 * (e / 4) + cin;
      if (s >= Q || p >= P) continue;
      bf16* d = dx + ((row0 + s) * H + h) * P + p;
      d[0] = __float2bfloat16(dx_acc[e]);
      if (p + 1 < P) d[1] = __float2bfloat16(dx_acc[e + 1]);
    }
#pragma unroll
    for (int e = 0; e < kN; e += 2) {
      const int s = r0 + 8 * ((e / 2) % 2);
      const int n = 8 * (e / 4) + cin;
      if (s >= Q || n >= N) continue;
      float* d = dbp + ((row0 + s) * H + h) * N + n;
      d[0] = db_acc[e];
      if (n + 1 < N) d[1] = db_acc[e + 1];
    }
  }
  __syncthreads();
  if (tid < 32)
    finish_ddt(ddt + row0 * H + h, ddecay == nullptr ? nullptr : ddecay + row0 * H + h, H,
               rows, cols, dwv, w, cs, Q);
}

template <int kNT>
cudaError_t launch(const void* x, const float* dt_a, const void* b, const void* c,
                   const void* dy, const float* dstate, const float* ddecay, void* dx,
                   float* ddt, float* part, const long long* st, int BC, int Q, int H, int P,
                   int N, cudaStream_t stream) {
  // opt in once per instantiation (the first launch must come outside any
  // CUDA graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_wgmma_kernel<kNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<kNT>::kSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  bool vec = P % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(b) && aligned16(c) &&
             (dy == nullptr || aligned16(dy));
  const int strides_of_x_b_c_dy[] = {0, 1, 2, 6, 7, 8, 9, 10, 11, 12, 13, 14};
  for (int i : strides_of_x_b_c_dy) vec = vec && st[i] % 8 == 0;
  const Strides4 sx{st[0], st[1], st[2]};
  const Strides4 sa{st[3], st[4], st[5]};
  const Strides4 sb{st[6], st[7], st[8]};
  const Strides4 sc{st[9], st[10], st[11]};
  const Strides4 sy{st[12], st[13], st[14]};
  ssd_bwd_wgmma_kernel<kNT><<<dim3(H, BC), kThreads, Layout<kNT>::kSmem, stream>>>(
      static_cast<const bf16*>(x), dt_a, static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<const bf16*>(dy), dstate, ddecay,
      static_cast<bf16*>(dx), ddt, part, sx, sa, sb, sc, sy, BC, H, Q, P, N, vec);
  return cudaGetLastError();
}

}  // namespace ssd_bwd_tc

cudaError_t launch_f32(const float* x, const float* dt_a, const float* b, const float* c,
                       const float* dy, const float* dstate, const float* ddecay, float* dx,
                       float* ddt, float* part, const long long* st, int BC, int Q, int H,
                       int P, int N, cudaStream_t stream) {
  // opt in once at the largest shapes the wrapper admits (the first launch
  // must come outside any CUDA graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        f32_smem_floats(kMaxQ, kMaxP, kMaxN) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const Strides4 sx{st[0], st[1], st[2]};
  const Strides4 sa{st[3], st[4], st[5]};
  const Strides4 sb{st[6], st[7], st[8]};
  const Strides4 sc{st[9], st[10], st[11]};
  const Strides4 sy{st[12], st[13], st[14]};
  const int smem = f32_smem_floats(Q, P, N) * static_cast<int>(sizeof(float));
  ssd_bwd_f32_kernel<<<dim3(H, BC), kThreads, smem, stream>>>(
      x, dt_a, b, c, dy, dstate, ddecay, dx, ddt, part, sx, sa, sb, sc, sy, BC, H, Q, P, N);
  return cudaGetLastError();
}

}  // namespace

// x (BC, Q, H, P), dt_a (BC, Q, H) fp32, b, c (BC, Q, H, N) and dy (x's
// shape; nullptr: zero) with unit last stride; st: the (chunk, row, head)
// strides of x, dt_a, b, c and dy in that order, in elements (a head stride
// of 0 broadcasts one B/C group to all heads).  dstate (BC, H, P, N) and
// ddecay (BC, Q, H) fp32 contiguous, or nullptr (zero).  dx (BC, Q, H, P) in
// x's dtype and ddt (BC, Q, H) fp32, contiguous; part (2, BC, Q, H, N) fp32
// scratch for each head's dB and dC; db, dc (BC, Q, G, N) in b's dtype, each
// group summing H / G consecutive heads.  bf16 != 0 for bfloat16 x, b, c,
// dy, which run the tensor-core kernel; fp32 the CUDA-core one.
cudaError_t launch_ssd_chunk_bwd(const void* x, const float* dt_a, const void* b,
                                 const void* c, const void* dy, const float* dstate,
                                 const float* ddecay, void* dx, float* ddt, float* part,
                                 void* db, void* dc, const long long* st, int BC, int Q,
                                 int H, int P, int N, int G, int bf16,
                                 cudaStream_t stream) {
  if (BC < 1 || BC > 65535 || Q < 1 || Q > kMaxQ || H < 1 || H > 65535 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16)
    err = N <= 64 ? ssd_bwd_tc::launch<1>(x, dt_a, b, c, dy, dstate, ddecay, dx, ddt, part,
                                          st, BC, Q, H, P, N, stream)
                  : ssd_bwd_tc::launch<2>(x, dt_a, b, c, dy, dstate, ddecay, dx, ddt, part,
                                          st, BC, Q, H, P, N, stream);
  else
    err = launch_f32(static_cast<const float*>(x), dt_a, static_cast<const float*>(b),
                     static_cast<const float*>(c), static_cast<const float*>(dy), dstate,
                     ddecay, static_cast<float*>(dx), ddt, part, st, BC, Q, H, P, N, stream);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(BC) * Q;
  const long long total = rows * G * N;
  const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
  if (bf16)
    group_sum_kernel<__nv_bfloat16><<<dim3(blocks, 2), 256, 0, stream>>>(
        part, static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc), rows, H, G,
        N);
  else
    group_sum_kernel<float><<<dim3(blocks, 2), 256, 0, stream>>>(
        part, static_cast<float*>(db), static_cast<float*>(dc), rows, H, G, N);
  return cudaGetLastError();
}
