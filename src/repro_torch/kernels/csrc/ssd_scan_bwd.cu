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
// dB and dC of the heads of one B/C group are summed (ssm_groups G: H / G
// consecutive heads a group).  Nothing of size Q x Q reaches device
// memory.
//
// What bounds it on an H100: bytes.  At Zamba2-1.2B's training shape (16
// chunks x 64 heads, Q = 128, P = N = 64, one B/C group) the function must
// move ~70 MB (x, dy and dx in bf16, the fp32 dst) against ~7.6 GFLOP of
// products: ~21 µs of bytes, ~7.6 µs at the bf16 tensor-core peak; at
// mamba2-2.7b's (80 heads, N = 128) ~109 MB and ~16 GFLOP (kernels/cost.py
// ssd_chunk_bwd).  A head's share of an SM is ~64 KB (N = 64) to ~80 KB
// (N = 128) of those bytes, ~2.5-3 µs at the SM's share of the bandwidth,
// so a block must keep the next head's loads in flight under this head's
// work and write nothing a head does not have to.
//
// bf16 design.  One block of 256 threads (two warpgroups) walks `heads`
// consecutive heads of one chunk that lie in one B/C group (the host plan
// ssd_bwd_plan in kernels/ssd_scan.py: 8 of Zamba2's 64 heads and 10 of
// mamba2-2.7b's 80, 128 blocks, one wave on 132 SMs; 1 where B and C are
// per head).
//   once a block:  B and C staged by cp.async into 128-byte-swizzled tiles
//            (zero past Q and N); at N <= 64, S = C·Bᵀ over the three
//            lower 64 x 64 tiles, kept in fp32 in shared memory;
//   per head:  x and dy of the next head are in flight (cp.async into the
//            second buffer), and from the middle of this head on its dst
//            (fp32, each thread's chunks where their bf16 hi and lo will
//            go) and its decay cotangent;
//     rows t:  six units, the 64 x 32 halves of the three lower tiles,
//            three a warpgroup: dM = dy·xᵀ (and S at N = 128), L's
//            exponentials (one MUFU.EX2 each) while those products run,
//            dS = dM∘L added to ΣdS (registers, fp32, head order), the row
//            sums of dS∘S, the column sums (each warp's 16 rows reduced by
//            shuffles in a fixed order), and W = S∘L written once as bf16
//            hi and lo tiles (stmatrix);
//     dst:   converted in place into bf16 hi and lo tiles (P rows, 64
//            columns of N a tile), each thread the chunks it copied, so no
//            barrier but the one before the products;
//     rows s (warpgroup g: rows 64g..):  F = x·dst in 64-column halves of
//            N, dw = Σ_n F∘B, w∘F added to dB's accumulator (registers,
//            fp32, head order); dx = w∘(B·dstᵀ), then dx += Wᵀ·dy with W's
//            tiles read MN-major, so no Sᵀ or dMᵀ is recomputed; dx written
//            in bf16; warpgroup 1 forms d(dt_a) and its reverse cumsum in a
//            fixed order;
//   once a block:  ΣdS written as hi and lo tiles over W's; dC = ΣdS·B
//            (ΣdS K-major) and dB += ΣdSᵀ·C (MN-major): Σ_h dS_h·B =
//            (Σ_h dS_h)·B, so the two N-wide products a head had are one a
//            block.  The block's dB and dC leave once: in fp32 as one part
//            of its group (2·BC·Q·(H / heads)·N floats, group_sum_kernel adds
//            a group's parts in block order and rounds once), or rounded
//            to bf16 where the block is its group's only one.
// The hi/lo split is what keeps the fp32 operands (S∘L, ΣdS, dst) exact
// enough: one bf16 rounding (2^-9 relative) of ΣdS moves dB and dC, and of
// dst moves d(dt_a), past their bars (tests/test_torch_ssd_bwd.py
// emulates the block's order of sums); bf16 x bf16 products are exact and
// every sum stays fp32.  No atomics: every sum runs in a fixed order and
// repeats are bit-identical.  Every wgmma group is awaited before the next
// branch or loop edge (ptxas serializes a group left in flight across one).
//
// Shared memory (bytes; one block an SM, 227,872 of the 232,448 a block
// may take, at either N):
//                       N <= 64    N = 128
//   B, C                 32,768     65,536
//   x, dy (2 buffers)    65,536     65,536
//   dst (fp32 / hi+lo)   16,384     32,768
//   W or ΣdS (hi+lo)     49,152     49,152
//   S (fp32)             49,152          —
//   cs (16 heads), sums  13,856     13,856   + 1,024 alignment
// At N = 128 S does not fit beside double-buffered x and dy: it is
// recomputed per head (24 more k16 steps, in the same wgmma group as dM),
// which was chosen over single-buffered x and dy (their load would then
// wait on the previous head's products).  dst is not double-buffered at
// either N (its load overlaps dx's product and the next head's rows-t
// work, not a whole head).
//
// Registers: 246 a thread at N = 128, 221 at N <= 64, none spilled
// (ptxas).  ΣdS (48 a thread) and dB's accumulator (32 or 64) live across
// the heads, so everything else is kept short: the rows-t work in 64 x 32
// halves, three a warpgroup (whole tiles, one and two a warpgroup, put 64
// of ΣdS in warpgroup 1); F's fragment dead before B·dstᵀ's is made; dB
// and dC as one 64-column accumulator a tile; d(dt_a) by 128 threads, a
// row each, its decay cotangent staged by cp.async rather than held; dst
// converted a chunk at a time; shared-memory reads of neighbouring columns
// in pairs (B for dw, cs for L: as single bf16 and fp32 loads they cost
// more than any product); the thread's index, the shared-memory base
// and the chunk read anew each head through opaque moves, so that the
// compiler recomputes the addresses, masks and descriptors built from
// them where they are used rather than holding them in registers across
// the heads (hoisted, they spilled over 700 bytes at N = 128).
//
// Weighed and not taken: dw as Σ_p x∘(B·dstᵀ) with w∘x as a register A
// operand of the F product (no F fragment, but three products where two
// serve); S kept in registers across heads (beside ΣdS and dB's
// accumulator it passes 255 registers a thread at N = 128).
//
// fp32 design: a simple CUDA-core kernel, one 256-thread block per (chunk,
// head).  x, dy, B and C are staged as fp32 in shared memory; 32 x 32
// tiles of S∘L, dS and dS∘S are formed one (t-tile, s-tile) pair at a
// time, s-tiles outer: dx and dB of the s-tile stay in registers, dC
// accumulates in its fp32 per-head buffer in device memory, each element
// read and written by one thread in a fixed order.  It writes each head's
// dB and dC in fp32; group_sum_kernel then sums the H / G consecutive heads
// of each of G groups in head order and rounds once.

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

// out (BC·Q, G, N) = Σ over the H / G consecutive entries of each group
// of part (BC·Q, H, N) (the fp32 kernel's heads, or the bf16 kernel's
// blocks' parts), in order, rounded once to T; blockIdx.y picks dB (0) or
// dC (1)
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
using ssd::tile::cp_async16;
using ssd::tile::cp_async_commit;
using ssd::tile::kRows;
using ssd::tile::kThreads;
using ssd::tile::kTileBytes;
using ssd::tile::stage;
using ssd::tile::stage_n;
using ssd::tile::sw128;

constexpr int kDstTileBytes = kMaxP * 128;  // 64 rows (P) x 64 columns of N
constexpr int kQTileBytes = 64 * 128;       // a 64 x 64 bf16 tile of S∘L or ΣdS
constexpr int kMaxHeads = 16;               // heads a block walks, at most
constexpr int kWarps = kThreads / 32;

// Shared memory for N in kNT 64-column tiles (the budget of the header):
// B and C (kNT tiles each), x and dy (two buffers each), dst (fp32 staged,
// then its bf16 hi and lo tiles in place), the three lower 64 x 64 tiles
// of S∘L (then of ΣdS) as hi and lo, at kNT = 1 the three tiles of S in
// fp32; then cs of every head, the row sums of dS∘S (a part each
// warpgroup), dw, the column sums (a part each unit and warp), d(dt_a)'s
// 8 partial sums and the decay's cotangent (two heads' rows); +
// alignment.  227,872 bytes at either kNT.
template <int kNT>
struct Layout {
  static constexpr uint32_t kB = 0;
  static constexpr uint32_t kC = kNT * kTileBytes;
  static constexpr uint32_t kX = 2 * kNT * kTileBytes;
  static constexpr uint32_t kDY = kX + 2 * kTileBytes;
  static constexpr uint32_t kD = kDY + 2 * kTileBytes;
  static constexpr uint32_t kW = kD + 2 * kNT * kDstTileBytes;
  static constexpr uint32_t kS = kW + 6 * kQTileBytes;
  static constexpr uint32_t kF = kS + (kNT == 1 ? 3 * 64 * 64 * 4 : 0);
  static constexpr int kSums = (kMaxHeads + 5) * kRows + 6 * 4 * 32 + 8;  // floats
  static constexpr int kSmem = 1024 + kF + kSums * 4;
};

// exp(d) as one MUFU.EX2 (ex2.approx.ftz of d·log2 e, within 2 fp32 ulps;
// exp2f adds a range fix-up around it): L's and w's exponentials
__device__ __forceinline__ float exp_ex2(float d) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d * 1.4426950408889634f));
  return y;
}

// copy 4 bytes (an fp32 element of a ragged dst)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// wait until at most one of this thread's cp.async groups is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// dst's 16-byte chunk `idx` of kNT tiles of P rows x 64 columns (8
// columns a chunk): row p, first column n0, and the byte offsets of its
// bf16 hi and lo chunks from the start of dst's area
template <int kNT>
struct DstChunk {
  int p, n0;
  uint32_t hi, lo;
  __device__ __forceinline__ explicit DstChunk(int idx)
      : p(idx / (8 * kNT)),
        n0(64 * ((idx / 8) % kNT) + 8 * (idx % 8)),
        hi(((idx / 8) % kNT) * kDstTileBytes + sw128(idx / (8 * kNT), idx % 8)),
        lo(hi + kNT * kDstTileBytes) {}
};

// One head's dst (P x N fp32, contiguous; nothing where the cotangent is
// missing) into dst's area at `at`, where this thread will convert it: the
// 8 floats of each of its chunks go where the chunk's bf16 hi (columns
// n0..n0+3) and lo (n0+4..n0+7) will be, so that the thread converts them
// in place with no barrier.  vec: 16-byte copies (N % 8 == 0, 16-byte
// aligned), else 4-byte ones.
template <int kNT>
__device__ __forceinline__ void stage_dst(uint32_t at, const float* __restrict__ src, int P,
                                          int N, bool vec, int tid) {
  if (src == nullptr) return;
#pragma unroll
  for (int k = 0; k < 2 * kNT; ++k) {
    const DstChunk<kNT> d(tid + k * kThreads);
    if (d.p >= P || d.n0 >= N) continue;
    const float* row = src + d.p * N + d.n0;
    if (vec) {
      cp_async16(at + d.hi, row, true);
      cp_async16(at + d.lo, row + 4, true);
    } else {
      for (int e = 0; e < 8 && d.n0 + e < N; ++e)
        cp_async4(at + (e < 4 ? d.hi + 4 * e : d.lo + 4 * (e - 4)), row + e);
    }
  }
}

// The same thread's chunks of dst converted in place into bf16 hi and lo
// (zero past P and N, or where the cotangent is missing), once its copies
// have landed, a chunk at a time
template <int kNT>
__device__ __forceinline__ void convert_dst(uint8_t* area, bool has, int P, int N, int tid) {
#pragma unroll 1  // a chunk at a time: unrolled, its loads ran ahead and spilled at N = 128
  for (int k = 0; k < 2 * kNT; ++k) {
    const DstChunk<kNT> d(tid + k * kThreads);
    float v[8];
    const float4 a = *reinterpret_cast<const float4*>(area + d.hi);
    const float4 b = *reinterpret_cast<const float4*>(area + d.lo);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    uint4 hv, lv;
    uint32_t* hh = reinterpret_cast<uint32_t*>(&hv);
    uint32_t* ll = reinterpret_cast<uint32_t*>(&lv);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const bool in = has && d.p < P;
      const float2 pair = make_float2(in && d.n0 + e < N ? v[e] : 0.f,
                                      in && d.n0 + e + 1 < N ? v[e + 1] : 0.f);
      tc::split_pack(pair, hh[e / 2], ll[e / 2]);
    }
    *reinterpret_cast<uint4*>(area + d.hi) = hv;
    *reinterpret_cast<uint4*>(area + d.lo) = lv;
  }
}

// d = A·B for k16 steps over N (4·kNT) with A and B both K-major 64-row
// slices of 64-column tiles (kNT tiles kTileBytes apart)
template <int kNT>
__device__ __forceinline__ void product_over_n(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * kNT; ++kk) {
    const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
    tc::wgmma_ss_m64n64k16<0, 0>(d, tc::desc_sw128(a + off, 16), tc::desc_sw128(b + off, 16),
                                 kk > 0);
  }
}

// d += (hi + lo)·B over the 64 rows of K of a 64 x 64 tile: the tile's hi
// and lo halves at `a` (K-major, kTransA = 0, or MN-major, 1), B MN-major
// at `b` (rows of K, 64 columns a tile, kNT tiles kTileBytes apart), one
// 64-column accumulator d[n] a tile
template <int kNT, int kTransA>
__device__ __forceinline__ void product_hilo(float (&d)[kNT][32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ka = kTransA ? kk * 2048 : kk * 32;
    const uint32_t lbo = kTransA ? kTileBytes : 16;
    const uint64_t hi = tc::desc_sw128(a + ka, lbo);
    const uint64_t lo = tc::desc_sw128(a + kQTileBytes + ka, lbo);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const uint64_t db = tc::desc_sw128(b + n * kTileBytes + kk * 2048, kTileBytes);
      tc::wgmma_ss_m64n64k16<kTransA, 1>(d[n], hi, db, 1);
      tc::wgmma_ss_m64n64k16<kTransA, 1>(d[n], lo, db, 1);
    }
  }
}

// four 8 x 8 bf16 matrices to shared memory: this lane's row address `at`
// (matrix lane / 8, row lane % 8), r[k] its two elements of matrix k (row
// lane / 4, columns 2·(lane % 4), + 1: an accumulator fragment's layout)
__device__ __forceinline__ void stmatrix_x4(uint32_t at, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(at),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// a warpgroup's 64 x 32 accumulator fragment (the half of a 64 x 64 tile
// from 16-byte chunk `chunk0` on) as bf16 hi and lo into the tile at
// shared address `tile` (hi, then lo kQTileBytes on), by stmatrix: its 8 x
// 8 blocks (row group rg, column group cg) are the fragment's elements
// 4·cg + 2·rg and + 1; wq: the warp's first row in the tile
__device__ __forceinline__ void store_hilo(uint32_t tile, const float (&v)[16], int wq,
                                           int lane, int chunk0) {
  uint32_t hi[8], lo[8];
#pragma unroll
  for (int b = 0; b < 8; ++b)  // block 2·cg + rg
    tc::split_pack(make_float2(v[4 * (b / 2) + 2 * (b % 2)], v[4 * (b / 2) + 2 * (b % 2) + 1]),
                   hi[b], lo[b]);
  const int m = lane / 8;
#pragma unroll
  for (int c2 = 0; c2 < 2; ++c2) {  // column groups 2·c2, 2·c2 + 1: blocks 4·c2 + m
    const uint32_t at = tile + sw128(wq + 8 * (m % 2) + lane % 8, chunk0 + 2 * c2 + m / 2);
    stmatrix_x4(at, hi[4 * c2], hi[4 * c2 + 1], hi[4 * c2 + 2], hi[4 * c2 + 3]);
    stmatrix_x4(at + kQTileBytes, lo[4 * c2], lo[4 * c2 + 1], lo[4 * c2 + 2], lo[4 * c2 + 3]);
  }
}

// Σ over the 4 lanes of a quad (one accumulator row), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// d(dt_a) of one head by the 128 threads of warpgroup 1, thread t its row
// t: dcs_t = rows_t − cols_t − dw_t·w_t + ddec_t·exp(cs_t), the row sums of
// dS∘S added over the warpgroups' parts (warpgroup 0 has rows t of both
// tiles, warpgroup 1 of tile 1), the column sums over the units and warps
// that hold them (32 columns a unit: units 0 and 2 hold columns 0..31, 1
// and 3 columns 32..63, 4 and 5 the rest; units 2..5 only where Q > 64);
// then d(dt_a)_k = Σ_{t>=k} dcs_t + Σ_s dw_s·w_s (the term at t = Q−1 is in
// every suffix), suffix sums within each warp, then over the later warps,
// all in a fixed order.  ddec: the decay's cotangent at row t (0 where it
// is missing); part: 8 floats of shared memory
__device__ __forceinline__ void finish_ddt_wg(float* __restrict__ out, float ddec,
                                              long long stride, const float* rowp,
                                              const float* colp, const float* dwv,
                                              const float* cs, float* part, int Q, int tiles,
                                              int t) {
  const int lane = t % 32;
  const int w = t / 32;
  float v = 0.f, p = 0.f;
  if (t < Q) {
    p = dwv[t] * exp_ex2(cs[Q - 1] - cs[t]);
    const int c = t / 32;
    const float* cp = colp + (c < 2 ? c : c + 2) * 128 + t % 32;  // unit 0, 1, 4 or 5
    float col = ((cp[0] + cp[32]) + cp[64]) + cp[96];
    if (c < 2 && tiles > 1) col = (((col + cp[256]) + cp[288]) + cp[320]) + cp[352];
    const float row = t < 64 ? rowp[t] : rowp[t] + rowp[kRows + t];
    v = row - col - p;
    v += ddec * expf(cs[t]);
  }
  float incl = v;  // Σ over this warp's rows >= t
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float down = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += down;
  }
  const float ptot = warp_sum(p);
  if (lane == 0) {
    part[w] = incl;
    part[4 + w] = ptot;
  }
  asm volatile("bar.sync 1, 128;" ::: "memory");
  float later = ((part[4] + part[5]) + part[6]) + part[7];
  for (int k = 3; k > w; --k) later += part[k];
  if (t < Q) out[t * stride] = incl + later;
}

// rows r0, r0 + 8 of an accumulator fragment 32·kW columns wide into a
// row-major output of `ld` elements a row (columns < n_cols), in fp32 or
// rounded once to bf16; rows >= n_rows are dropped
template <typename T, int kW>
__device__ __forceinline__ void store_rows(T* __restrict__ out, long long ld, const float (&v)[kW],
                                           int r0, int cin, int n_rows, int n_cols) {
#pragma unroll
  for (int e = 0; e < kW; e += 2) {
    const int r = r0 + 8 * ((e / 2) % 2);
    const int n = 8 * (e / 4) + cin;
    if (r >= n_rows || n >= n_cols) continue;
    T* d = out + r * ld + n;
    if constexpr (sizeof(T) == 2) {
      if (n + 1 < n_cols && n_cols % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(v[e], v[e + 1]);
      } else {
        d[0] = __float2bfloat16(v[e]);
        if (n + 1 < n_cols) d[1] = __float2bfloat16(v[e + 1]);
      }
    } else {
      if (n + 1 < n_cols && n_cols % 2 == 0) {
        *reinterpret_cast<float2*>(d) = make_float2(v[e], v[e + 1]);
      } else {
        d[0] = v[e];
        if (n + 1 < n_cols) d[1] = v[e + 1];
      }
    }
  }
}

// One block walks `heads` consecutive heads of one chunk, all in one B/C
// group (the design of the header).  part: the block's dB and dC in fp32
// at (2, BC, Q, gridDim.x, N), summed per group by group_sum_kernel; or
// nullptr where the block is its group's only one, and dB and dC go to db
// and dc (BC, Q, gridDim.x, N) rounded once.
template <int kNT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt_a,
                     const bf16* __restrict__ b, const bf16* __restrict__ c,
                     const bf16* __restrict__ dy, const float* __restrict__ dstate,
                     const float* __restrict__ ddecay, bf16* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ part, bf16* __restrict__ db,
                     bf16* __restrict__ dc, Strides4 sx, Strides4 sa, Strides4 sb,
                     Strides4 sc, Strides4 sy, int BC, int H, int Q, int P, int N,
                     int heads, int vec, int vec_dst) {
  using Lay = Layout<kNT>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_u32(smem);
  // after the tiles: cs of each head (kMaxHeads x kRows), then the row
  // sums of dS∘S (a part each warpgroup, 2 x kRows), dw (kRows), the column
  // sums of dS∘S (a part each unit and warp, 6 x 4 x 32), d(dt_a)'s 8
  // partial sums and the decay's cotangent (2 x kRows: two heads)
  float* cs_all = reinterpret_cast<float*>(smem + Lay::kF);

  const int ch = blockIdx.y;
  const int h0 = blockIdx.x * heads;
  const int tid = threadIdx.x;
  // head h's x and dy of chunk cq (the chunk as the caller sees it) into
  // buffer `buf`
  auto stage_xy = [&](uint8_t* base, int buf, int cq, int h) {
    const bf16* xh = x + cq * sx.c + h * sx.h;
    stage(base, Lay::kX + buf * kTileBytes, xh, sx.q, Q, P, vec);
    // a missing cotangent stages as zeros (0 rows: the source is not read)
    stage(base, Lay::kDY + buf * kTileBytes, dy == nullptr ? xh : dy + cq * sy.c + h * sy.h,
          sy.q, dy == nullptr ? 0 : Q, P, vec);
  };
  // head h's dst, and for warpgroup 1's d(dt_a) the decay's cotangent
  // (row t by thread 128 + t, into buffer `buf` of two)
  auto stage_dst_of = [&](int cq, int h, int buf, int t) {
    stage_dst<kNT>(sbase + Lay::kD,
                   dstate == nullptr ? nullptr
                                     : dstate + (static_cast<long long>(cq) * H + h) * P * N,
                   P, N, vec_dst, t);
    const int r = t - 128;
    if (ddecay != nullptr && r >= 0 && r < Q)
      cp_async4(sbase + Lay::kF + (Lay::kSums - 2 * kRows + buf * kRows + r) * 4,
                ddecay + (static_cast<long long>(cq) * Q + r) * H + h);
  };

  // B and C of the block's group, once; head h0's x, dy (one group) and
  // dst (the next)
  stage_n<kNT>(smem, Lay::kB, b + ch * sb.c + h0 * sb.h, sb.q, Q, N, vec);
  stage_n<kNT>(smem, Lay::kC, c + ch * sc.c + h0 * sc.h, sc.q, Q, N, vec);
  stage_xy(smem, 0, ch, h0);
  cp_async_commit();
  stage_dst_of(ch, h0, 0, tid);
  cp_async_commit();

  // cs of every head, one warp a head
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int i = warp; i < heads; i += kWarps) {
    float* cs = cs_all + i * kRows;
    chunk_cumsum(cs, dt_a + ch * sa.c + (h0 + i) * sa.h, sa.q, Q);
    for (int t = Q + lane; t < kRows; t += 32) cs[t] = 0.f;
  }

  // warpgroup g: rows 64g + [0, 64) of the chunk, t in the products over
  // rows t, s in those over rows s; this thread's fragment rows are r0 and
  // r0 + 8, its columns 8·(e/4) + cin + e%2 for accumulator e.  g comes
  // through a shuffle from lane 0 so that the compiler sees it warp-uniform
  // and does not serialize the products under `if` on it
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wr = 16 * ((tid % 128) / 32) + lane / 4;
  const int r0 = 64 * g + wr;
  const int cin = 2 * (lane % 4);
  const int tiles = (Q + 63) / 64;
  const bool active = g < tiles;

  float sds[3][16];  // ΣdS over the heads so far, units 3g..3g+2
  float db_acc[kNT][32];  // Σ w∘F over the heads so far, then + ΣdSᵀ·C; rows s
#pragma unroll
  for (int e = 0; e < 16; ++e) sds[0][e] = sds[1][e] = sds[2][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e)
#pragma unroll
    for (int n = 0; n < kNT; ++n) db_acc[n][e] = 0.f;

  if constexpr (kNT == 1) {  // S = C·Bᵀ once, kept in fp32 as each thread's fragments
    cp_async_wait_one();
    tc::fence_proxy_async();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j > g) continue;
        float sv[32];
        tc::fence_regs(sv);
        tc::wg_fence();
        product_over_n<1>(sv, sbase + Lay::kC + 64 * g * 128, sbase + Lay::kB + 64 * j * 128);
        tc::wg_commit();
        tc::wg_wait_all();
        tc::fence_regs(sv);
        float4* keep = reinterpret_cast<float4*>(smem + Lay::kS) + (g + j) * 8 * 128 + tid % 128;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          keep[q * 128] = make_float4(sv[4 * q], sv[4 * q + 1], sv[4 * q + 2], sv[4 * q + 3]);
      }
    }
  }

#pragma unroll 1
  for (int i = 0; i < heads; ++i) {
    // the block's chunk and first head read anew (opaque, as below): the
    // pointers built from them are not kept across heads
    int cq, bq;
    asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(cq));
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bq));
    const int h = bq * heads + i;
    const long long rq = static_cast<long long>(cq) * Q;
    const int buf = i & 1;
    // this head's view of the thread's index and of the shared-memory
    // base, opaque to the compiler: the addresses, descriptors and masks
    // built from them are computed where they are used, not hoisted out
    // of the loop into registers live across every head (beside ΣdS and
    // dB's accumulator they spilled); the descriptors' base comes through
    // a shuffle from lane 0, so that it is known warp-uniform
    int tq;
    asm volatile("mov.b32 %0, %1;" : "=r"(tq) : "r"(tid));
    uint8_t* sm;
    asm volatile("mov.b64 %0, %1;" : "=l"(sm) : "l"(smem));
    uint32_t sb;
    asm volatile("mov.b32 %0, %1;" : "=r"(sb) : "r"(sbase));
    sb = __shfl_sync(0xffffffffu, sb, 0);  // seen warp-uniform again
    const int lane = tq % 32;
    const int warp = tq / 32;
    const int wr = 16 * ((tq % 128) / 32) + lane / 4;
    const int r0 = 64 * g + wr;
    const int cin = 2 * (lane % 4);
    float* rowp = reinterpret_cast<float*>(sm + Lay::kF) + kMaxHeads * kRows;
    float* dwv = rowp + 2 * kRows;
    float* colp = dwv + kRows;
    const float* ddvs = reinterpret_cast<const float*>(sm + Lay::kF) + Lay::kSums - 2 * kRows;
    const float* cs = reinterpret_cast<const float*>(sm + Lay::kF) + i * kRows;
    const uint32_t xb = sb + Lay::kX + buf * kTileBytes;
    const uint32_t yb = sb + Lay::kDY + buf * kTileBytes;
    cp_async_wait_one();
    tc::fence_proxy_async();
    __syncthreads();  // head i's x and dy in place, the other buffers free
    if (i + 1 < heads) stage_xy(sm, buf ^ 1, cq, h + 1);
    cp_async_commit();

    // products over rows t in six units, a 64 x 32 half (rows t of tile
    // it, columns s of half hh of tile j) of each lower 64 x 64 tile,
    // three a warpgroup (warpgroup g takes units 3g..3g+2): S (or its kept
    // tiles) and dM = dy·xᵀ; dS = dM∘L into ΣdS, the row and column sums
    // of dS∘S, and S∘L as hi + lo into shared memory for dx's product.
    // Halves, three a warpgroup: ΣdS takes 48 registers a thread in each,
    // where whole tiles (one and two) took 64 in one and passed 255 beside
    // dB's accumulator at N = 128
    if (active) {
      const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
      float rs[3][2];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        rs[k][0] = rs[k][1] = 0.f;
        const int u = 3 * g + k;
        const int it = u >= 2, j = u >= 4, hh = u & 1;
        if (it >= tiles) continue;
        const int rt = 64 * it + wr;  // this thread's first row t
        const uint32_t src = 64 * j + 32 * hh;  // the half's first column s
        float sv[16], dm[16];
        tc::fence_regs(dm);
        if constexpr (kNT == 2) tc::fence_regs(sv);
        tc::wg_fence();
        if constexpr (kNT == 2) {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
            tc::wgmma_ss_m64n32k16<0, 0>(
                sv, tc::desc_sw128(sb + Lay::kC + 64 * it * 128 + off, 16),
                tc::desc_sw128(sb + Lay::kB + src * 128 + off, 16), kk > 0);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          tc::wgmma_ss_m64n32k16<0, 0>(dm, tc::desc_sw128(yb + 64 * it * 128 + kk * 32, 16),
                                       tc::desc_sw128(xb + src * 128 + kk * 32, 16), kk > 0);
        tc::wg_commit();
        // L of the unit while the products run
        const float cs_t[2] = {cs[rt], cs[rt + 8]};
        float lv[16];
#pragma unroll
        for (int e = 0; e < 16; e += 2) {
          const int t = rt + 8 * ((e / 2) % 2);
          const int s = src + 8 * (e / 4) + cin;  // even: cs[s], cs[s + 1] in one load
          const float2 css = *reinterpret_cast<const float2*>(cs + s);
          lv[e] = s <= t && t < Q ? exp_ex2(cs_t[(e / 2) % 2] - css.x) : 0.f;
          lv[e + 1] = s + 1 <= t && t < Q ? exp_ex2(cs_t[(e / 2) % 2] - css.y) : 0.f;
        }
        tc::wg_wait_all();
        tc::fence_regs(dm);
        if constexpr (kNT == 2) {
          tc::fence_regs(sv);
        } else {
          const float4* keep = reinterpret_cast<const float4*>(sm + Lay::kS) +
                               ((it + j) * 8 + 4 * hh) * 128 + tq % 128;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = keep[q * 128];
            sv[4 * q] = v.x;
            sv[4 * q + 1] = v.y;
            sv[4 * q + 2] = v.z;
            sv[4 * q + 3] = v.w;
          }
        }
        // column sums: the two rows of a column pair added, then each
        // column's 8 row-lanes reduced and scattered (lane bits 4, 3, 2)
        float cp[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float rr[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int e = 4 * q + c;
            const float ds = dm[e] * lv[e];    // dS
            rr[c] = ds * sv[e];                // dS∘S
            rs[k][c / 2] += rr[c];
            sds[k][e] += ds;
            sv[e] *= lv[e];                    // S∘L
          }
          const float c0 = rr[0] + rr[2], c1 = rr[1] + rr[3];
          cp[q] = (b4 ? c1 : c0) + __shfl_xor_sync(0xffffffffu, b4 ? c0 : c1, 16);
        }
        float cp2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          cp2[c] = (b3 ? cp[2 * c + 1] : cp[2 * c]) +
                   __shfl_xor_sync(0xffffffffu, b3 ? cp[2 * c] : cp[2 * c + 1], 8);
        const float cp1 = (b2 ? cp2[1] : cp2[0]) +
                          __shfl_xor_sync(0xffffffffu, b2 ? cp2[0] : cp2[1], 4);
        // this lane now holds column 8q + cin + b4 of the half, q = 2·b2 + b3
        colp[(u * 4 + warp % 4) * 32 + 8 * (2 * b2 + b3) + cin + b4] = cp1;
        store_hilo(sb + Lay::kW + (it + j) * 2 * kQTileBytes, sv, wr - lane / 4, lane, 4 * hh);
      }
      // the row sums of this warpgroup's units, each tile of rows t apart
      // (warpgroup 0: units 0, 1 on tile 0 and 2 on tile 1; warpgroup 1:
      // all three on tile 1), in unit order
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float first = g == 0 ? rs[0][c] + rs[1][c] : rs[0][c] + rs[1][c] + rs[2][c];
        const float v0 = quad_sum(first);
        const float v1 = quad_sum(rs[2][c]);
        if (lane % 4 == 0) {
          const int t = 64 * g + wr + 8 * c;  // warpgroup 1: tile 1
          if (t < Q) rowp[g * kRows + t] = v0;
          if (g == 0 && tiles > 1) rowp[64 + wr + 8 * c] = v1;
        }
      }
      tc::fence_proxy_async();
    }

    // dst into bf16 hi and lo tiles (P rows, 64 columns of N a tile), each
    // thread the chunks it copied
    cp_async_wait_one();
    convert_dst<kNT>(sm + Lay::kD, dstate != nullptr, P, N, tq);
    tc::fence_proxy_async();
    __syncthreads();  // S∘L's tiles, the sums and dst's tiles in place

    // products over rows s: dx = w∘(B·dstᵀ) and F = x·dst (dst hi + lo,
    // N in 64-column halves), dw = Σ_n F∘B, Σ w∘F into dB's accumulator
    float dxa[1][32];
    float (&dx_acc)[32] = dxa[0];
    const float last = cs[Q - 1];
    if (active) {
      const uint32_t b_rows = sb + Lay::kB + 64 * g * 128;
      const uint32_t x_rows = xb + 64 * g * 128;
      const uint32_t dh = sb + Lay::kD;
      const uint32_t dl = dh + kNT * kDstTileBytes;
      const float w_s[2] = {exp_ex2(last - cs[r0]), exp_ex2(last - cs[r0 + 8])};
      float dw[2] = {0.f, 0.f};
      // F first, then B·dstᵀ: the two fragments are never live together
#pragma unroll
      for (int half = 0; half < kNT; ++half) {
        float f[32];
        tc::fence_regs(f);
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = tc::desc_sw128(x_rows + kk * 32, 16);
          const uint32_t doff = half * kDstTileBytes + kk * 2048;
          tc::wgmma_ss_m64n64k16<0, 1>(f, da, tc::desc_sw128(dh + doff, kDstTileBytes), kk > 0);
          tc::wgmma_ss_m64n64k16<0, 1>(f, da, tc::desc_sw128(dl + doff, kDstTileBytes), 1);
        }
        tc::wg_commit();
        tc::wg_wait_all();
        tc::fence_regs(f);
#pragma unroll
        for (int e = 0; e < 32; e += 2) {  // B[s][n], B[s][n + 1] in one load
          const int s = r0 + 8 * ((e / 2) % 2);
          const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              sm + Lay::kB + half * kTileBytes + sw128(s, e / 4) + 2 * cin));
          dw[(e / 2) % 2] += f[e] * bv.x;
          dw[(e / 2) % 2] += f[e + 1] * bv.y;
          db_acc[half][e] += w_s[(e / 2) % 2] * f[e];
          db_acc[half][e + 1] += w_s[(e / 2) % 2] * f[e + 1];
        }
      }
      tc::fence_regs(dx_acc);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kNT; ++kk) {
        const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
        const uint32_t doff = (kk / 4) * kDstTileBytes + (kk % 4) * 32;
        tc::wgmma_ss_m64n64k16<0, 0>(dx_acc, tc::desc_sw128(b_rows + off, 16),
                                     tc::desc_sw128(dh + doff, 16), kk > 0);
        tc::wgmma_ss_m64n64k16<0, 0>(dx_acc, tc::desc_sw128(b_rows + off, 16),
                                     tc::desc_sw128(dl + doff, 16), 1);
      }
      tc::wg_commit();
      tc::wg_wait_all();
      tc::fence_regs(dx_acc);
#pragma unroll
      for (int e = 0; e < 32; ++e) dx_acc[e] *= w_s[(e / 2) % 2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float v = quad_sum(dw[k]);
        const int s = r0 + 8 * k;
        if (lane % 4 == 0 && s < Q) dwv[s] = v;
      }
    }
    __syncthreads();  // dst's tiles read, dw in place
    if (i + 1 < heads) stage_dst_of(cq, h + 1, buf ^ 1, tq);
    cp_async_commit();
    const int tr = tq % 128;

    // dx += (S∘L)ᵀ·dy over the t-tiles >= s: S∘L's tiles MN-major (hi +
    // lo), dy MN-major; then dx (BC, Q, H, P) in bf16
    if (active) {
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        if (it < g || it >= tiles) continue;
        tc::fence_regs(dx_acc);
        tc::wg_fence();
        product_hilo<1, 1>(dxa, sb + Lay::kW + (it + g) * 2 * kQTileBytes,
                           yb + 64 * it * 128);
        tc::wg_commit();
        tc::wg_wait_all();
        tc::fence_regs(dx_acc);
      }
      store_rows<bf16, 32>(dx + (rq * H + h) * P, static_cast<long long>(H) * P, dx_acc, r0,
                           cin, Q, P);
    }
    if (g == 1)  // the warpgroup with fewer of dx's products
      finish_ddt_wg(ddt + rq * H + h, ddecay == nullptr ? 0.f : ddvs[buf * kRows + tr], H,
                    rowp, colp, dwv, cs, colp + 6 * 4 * 32, Q, tiles, tr);
  }

  __syncthreads();  // the last head's products are done: S∘L's tiles are free
  if (active) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int u = 3 * g + k;
      const int it = u >= 2, j = u >= 4;
      if (it < tiles)
        store_hilo(sbase + Lay::kW + (it + j) * 2 * kQTileBytes, sds[k], wr - lane / 4, lane,
                   4 * (u & 1));
    }
    tc::fence_proxy_async();
  }
  __syncthreads();
  if (active) {
    // dC = ΣdS·B over the s-tiles <= t (ΣdS K-major), dB += ΣdSᵀ·C over the
    // t-tiles >= s (ΣdS MN-major); both as hi + lo against B and C MN-major
    float dc_acc[kNT][32];
#pragma unroll
    for (int e = 0; e < 32; ++e)
#pragma unroll
      for (int n = 0; n < kNT; ++n) dc_acc[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j > g) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n) tc::fence_regs(dc_acc[n]);
      tc::wg_fence();
      product_hilo<kNT, 0>(dc_acc, sbase + Lay::kW + (g + j) * 2 * kQTileBytes,
                           sbase + Lay::kB + 64 * j * 128);
      tc::wg_commit();
      tc::wg_wait_all();
#pragma unroll
      for (int n = 0; n < kNT; ++n) tc::fence_regs(dc_acc[n]);
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      if (it < g || it >= tiles) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n) tc::fence_regs(db_acc[n]);
      tc::wg_fence();
      product_hilo<kNT, 1>(db_acc, sbase + Lay::kW + (it + g) * 2 * kQTileBytes,
                           sbase + Lay::kC + 64 * it * 128);
      tc::wg_commit();
      tc::wg_wait_all();
#pragma unroll
      for (int n = 0; n < kNT; ++n) tc::fence_regs(db_acc[n]);
    }
    // this block's dB and dC: rows (BC·Q) of gridDim.x parts of N, 64
    // columns a tile
    const long long ld = static_cast<long long>(gridDim.x) * N;
    const long long at =
        static_cast<long long>(ch) * Q * ld + static_cast<long long>(blockIdx.x) * N;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (part != nullptr) {
        store_rows<float, 32>(part + at + 64 * n, ld, db_acc[n], r0, cin, Q, N - 64 * n);
        store_rows<float, 32>(part + static_cast<long long>(BC) * Q * ld + at + 64 * n, ld,
                              dc_acc[n], r0, cin, Q, N - 64 * n);
      } else {
        store_rows<bf16, 32>(db + at + 64 * n, ld, db_acc[n], r0, cin, Q, N - 64 * n);
        store_rows<bf16, 32>(dc + at + 64 * n, ld, dc_acc[n], r0, cin, Q, N - 64 * n);
      }
    }
  }
}

template <int kNT>
cudaError_t launch(const void* x, const float* dt_a, const void* b, const void* c,
                   const void* dy, const float* dstate, const float* ddecay, void* dx,
                   float* ddt, float* part, void* db, void* dc, const long long* st, int BC,
                   int Q, int H, int P, int N, int heads, cudaStream_t stream) {
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
  const bool vec_dst = dstate == nullptr || (N % 8 == 0 && aligned16(dstate));
  const Strides4 sx{st[0], st[1], st[2]};
  const Strides4 sa{st[3], st[4], st[5]};
  const Strides4 sb{st[6], st[7], st[8]};
  const Strides4 sc{st[9], st[10], st[11]};
  const Strides4 sy{st[12], st[13], st[14]};
  ssd_bwd_wgmma_kernel<kNT><<<dim3(H / heads, BC), kThreads, Layout<kNT>::kSmem, stream>>>(
      static_cast<const bf16*>(x), dt_a, static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<const bf16*>(dy), dstate, ddecay,
      static_cast<bf16*>(dx), ddt, part, static_cast<bf16*>(db), static_cast<bf16*>(dc), sx,
      sa, sb, sc, sy, BC, H, Q, P, N, heads, vec, vec_dst);
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
// x's dtype and ddt (BC, Q, H) fp32, contiguous; db, dc (BC, Q, G, N) in
// b's dtype, each group summing H / G consecutive heads.  bf16 != 0 for
// bfloat16 x, b, c, dy, which run the tensor-core kernel with `heads`
// consecutive heads of one group a block (a divisor of H / G, at most 16):
// part (2, BC, Q, H / heads, N) fp32 takes each block's dB and dC, or is
// nullptr where a block is a whole group (H / heads = G) and writes db and
// dc itself.  fp32 runs the CUDA-core kernel, one head a block (heads = 1),
// with part (2, BC, Q, H, N) fp32 for each head's dB and dC.
cudaError_t launch_ssd_chunk_bwd(const void* x, const float* dt_a, const void* b,
                                 const void* c, const void* dy, const float* dstate,
                                 const float* ddecay, void* dx, float* ddt, float* part,
                                 void* db, void* dc, const long long* st, int BC, int Q,
                                 int H, int P, int N, int G, int bf16, int heads,
                                 cudaStream_t stream) {
  if (BC < 1 || BC > 65535 || Q < 1 || Q > kMaxQ || H < 1 || H > 65535 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G)
    return cudaErrorInvalidValue;
  const int parts = bf16 ? H / heads : H;
  if (bf16 && (heads < 1 || heads > ssd_bwd_tc::kMaxHeads || (H / G) % heads ||
               (part == nullptr && parts != G)))
    return cudaErrorInvalidValue;
  if (!bf16 && (heads != 1 || part == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16)
    err = N <= 64 ? ssd_bwd_tc::launch<1>(x, dt_a, b, c, dy, dstate, ddecay, dx, ddt, part,
                                          db, dc, st, BC, Q, H, P, N, heads, stream)
                  : ssd_bwd_tc::launch<2>(x, dt_a, b, c, dy, dstate, ddecay, dx, ddt, part,
                                          db, dc, st, BC, Q, H, P, N, heads, stream);
  else
    err = launch_f32(static_cast<const float*>(x), dt_a, static_cast<const float*>(b),
                     static_cast<const float*>(c), static_cast<const float*>(dy), dstate,
                     ddecay, static_cast<float*>(dx), ddt, part, st, BC, Q, H, P, N, stream);
  if (err != cudaSuccess || part == nullptr) return err;
  const long long rows = static_cast<long long>(BC) * Q;
  const long long total = rows * G * N;
  const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
  if (bf16)
    group_sum_kernel<__nv_bfloat16><<<dim3(blocks, 2), 256, 0, stream>>>(
        part, static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc), rows, parts,
        G, N);
  else
    group_sum_kernel<float><<<dim3(blocks, 2), 256, 0, stream>>>(
        part, static_cast<float*>(db), static_cast<float*>(dc), rows, H, G, N);
  return cudaGetLastError();
}
