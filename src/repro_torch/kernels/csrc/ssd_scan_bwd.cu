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
// ssd_chunk_bwd).  In fp32 the bytes are ~1.5x and the products, three
// TF32 products each, ~46 µs at Zamba2's shape at the 495 TFLOP/s TF32
// peak: about even.  A head's share of an SM is ~64 KB (N = 64) to ~80 KB
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
// fp32 design.  The same structure on the tensor cores: a block of 256
// threads (8 warps) walks ssd_bwd_plan's heads of one B/C group, every
// product as 3xTF32 on mma.sync (each fp32 operand split into TF32 hi + lo,
// a product taken as lo·hi + hi·lo + hi·hi: ~22 of fp32's 24 bits of each
// operand, where one TF32 product keeps 11; one TF32 pass is ruled out by
// the fp32 bars, a split that keeps fp32's bits is not).  Everything runs
// transposed (rows s, columns t), so the sums over t that dx and dB take
// stay inside a warp: warp w owns the 16 rows s of s-block w (w < 4) or
// 11 − w (the two warps of a scheduler partition share 18 of the 72 m16 x
// n8 tiles of the lower triangle).
//   once a block:  B staged (cp.async, rows of N + 4 floats); C in the head
//            buffers' place; Sᵀ = B·Cᵀ tile by tile, kept as fragments (a
//            thread's four values where it reads them back);
//   per head:  dy and dst staged (two buffers at N <= 64: the next head's
//            in flight during this head; one at N = 128), x as register A
//            fragments split once; dx = w∘(B·dstᵀ); for each t-tile dMᵀ =
//            x·dyᵀ, Wᵀ = Sᵀ∘Lᵀ, dSᵀ = dMᵀ∘Lᵀ added to ΣdSᵀ (fragments in
//            shared memory, head order), the sums of dS∘S, and dx += Wᵀ·dy
//            with Wᵀ going from the accumulator to the A operand in
//            registers; F = x·dst tile by tile for dw and Σ w∘F (dB's
//            accumulator, registers); d(dt_a) by one warp;
//   once a block:  C again; dB = ΣdSᵀ·C + Σ w∘F, dC = ΣdS·B, written as
//            the block's fp32 part (group_sum_kernel adds a group's parts
//            in block order) or as dB and dC where the block is its group.
// Shared memory: B 67,584 bytes at N = 128 (34,816 at 64), S and ΣdS as
// fragments 36,864 each, the head buffers (dy 34,816, dst 33,792 or
// 17,408; C's place at the ends) and the sums 6,656: 216,576 bytes at N =
// 128 with one head buffer, 219,648 at N <= 64 with two; one block an SM.
// x in shared memory too would pass the 232,448 a block may take, so it
// lives in registers (64 a thread as hi + lo), and Σ w∘F, dB's
// accumulator, in 32 registers at N <= 64 and in the block's fp32 dB part
// at N = 128 (beside x's and dx's registers its 64 spill).  S is formed once a block at either N (fp32 S beside double-
// buffered dy does not fit at N = 128; recomputing it per head would add
// a third to the products, so N = 128 waits on its head's loads instead).

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
// of part (BC·Q, H, N) (the blocks' parts, H here the blocks of a chunk),
// in order, rounded once to T; blockIdx.y picks dB (0) or dC (1)
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
// fp32: tensor cores, every product as 3xTF32 (hopper_tc.cuh).
namespace ssd_bwd_f32 {

constexpr int kThreads = 256;     // 8 warps
constexpr int kRows = 128;        // rows of a chunk's tiles, zero past Q
constexpr int kTiles = 72;        // the m16 x n8 tiles of Sᵀ's lower part
constexpr int kMaxHeads = 16;     // heads a block walks, at most

// shared memory in floats for N padded to kNP (64 or 128): B (rows of kNP
// + 4), S and ΣdS as fragments (each warp its tiles, each lane its 4
// values: read back by the thread that wrote them), the head buffers
// (dy in rows of 68, dst in rows of kNP + 4; two of them at kNP = 64, one
// at 128), then cs, w, the row sums, the column sums, dw and each warp's
// part of the row sums.  C takes the head buffers' place at the block's
// start and end.  219,648 bytes at kNP = 64, 216,576 at 128.
template <int kNP>
struct Layout {
  static constexpr int kPB = kNP + 4;
  static constexpr int kPY = kMaxP + 4;
  static constexpr int kBufs = kNP == 64 ? 2 : 1;
  static constexpr int kB = 0;
  static constexpr int kS = kB + kRows * kPB;
  static constexpr int kSum = kS + kTiles * 128;
  static constexpr int kHead = kSum + kTiles * 128;
  static constexpr int kDst = kRows * kPY;                 // in a head buffer
  static constexpr int kHeadBuf = kDst + kMaxP * kPB;
  static constexpr int kSmall = kHead + kBufs * kHeadBuf;  // cs, w, rows, cols, dw
  static constexpr int kRowsP = kSmall + 5 * kRows;        // 8 warps' row sums
  static constexpr int kBytes = 4 * (kRowsP + 8 * kRows);
  static_assert(kRows * kPB <= kBufs * kHeadBuf, "C fits in the head buffers");
};

// the first of s-block sb's tiles (its tiles are t-tiles 2·sb .. 15)
__device__ __forceinline__ int tile0(int sb) { return sb * (17 - sb); }

// Σ_h w∘F of a warp's rows, dB's accumulator over the heads: in registers
// (kInRegs), or at N = 128, where its 64 registers a thread spill beside
// x's and dx's, in the block's dB part itself (fp32, each element read and
// written by the thread that owns it, in head order; at the end the dB
// product accumulates onto it).  `at` is the element's place in the part,
// or nullptr past Q or N.
template <int kNn, bool kInRegs>
struct DbAcc {
  float v[kNn][4];
  __device__ __forceinline__ DbAcc() {
#pragma unroll
    for (int n = 0; n < kNn; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[n][e] = 0.f;
  }
  __device__ __forceinline__ void add(int n, int e, float x, float*, bool) { v[n][e] += x; }
  __device__ __forceinline__ float get(int n, int e, const float*) const { return v[n][e]; }
};
template <int kNn>
struct DbAcc<kNn, false> {
  // the read is volatile, so the compiler issues it where the sum is taken
  // (hoisted, the whole row's reads hold 64 registers and spill; fetched a
  // tile ahead, the F product's registers spill instead)
  __device__ __forceinline__ void add(int, int, float x, float* at, bool first) {
    if (at == nullptr) return;
    if (!first) {
      float old;
      asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(old) : "l"(at) : "memory");
      x += old;
    }
    __stcg(at, x);
  }
  __device__ __forceinline__ float get(int, int, const float* at) const {
    return at != nullptr ? __ldcg(at) : 0.f;
  }
};

// Per (chunk, head), in the transposed orientation (rows s, columns t):
// warp w owns rows s of s-block sb = w (w < 4) or 11 − w, so the two warps
// of a scheduler partition hold 18 of the 72 tiles between them, and for
// each head walks its t-tiles j = 2·sb .. (8-row tiles, t >= 16·sb):
//   dMᵀ = x·dyᵀ (16 x 8 over P; x as register A fragments),
//   Wᵀ = Sᵀ∘Lᵀ and dSᵀ = dMᵀ∘Lᵀ (S read back from its fragments),
//   ΣdSᵀ += dSᵀ (its fragments in shared memory, in head order), the sums
//   of dS∘S by t (a part each warp) and by s (in registers),
//   dx += Wᵀ·dy (Wᵀ from the accumulator as the A operand: k = t);
// after its t-tiles, dx += w∘(B·dstᵀ) went first, F = x·dst gives dw and
// w∘F added to dB's accumulator (registers, head order).  Once a block:
// S = B·Cᵀ at the start, dB = ΣdSᵀ·C + Σ w∘F and dC = ΣdS·B at the end.
template <int kNP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dt_a,
                    const float* __restrict__ b, const float* __restrict__ c,
                    const float* __restrict__ dy, const float* __restrict__ dstate,
                    const float* __restrict__ ddecay, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ dbp, float* __restrict__ dcp,
                    Strides4 sx, Strides4 sa, Strides4 sb_, Strides4 sc, Strides4 sy, int BC,
                    int H, int Q, int P, int N, int heads, bool vec_y, bool vec_bc,
                    bool vec_d) {
  using L = Layout<kNP>;
  constexpr int kPB = L::kPB, kPY = L::kPY;
  constexpr int kNn = kNP / 8;   // n8 tiles of N
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const uint32_t sm_s = tc::smem_u32(sm);
  const float* const Bs = sm + L::kB;
  float* const Sf = sm + L::kS;
  float* const Sum = sm + L::kSum;
  float* const cs = sm + L::kSmall;
  float* const w = cs + kRows;
  float* const rows = w + kRows;
  float* const cols = rows + kRows;
  float* const dwv = cols + kRows;
  float* const rows_p = sm + L::kRowsP;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int sb = warp < 4 ? warp : 11 - warp;
  const int s0 = 16 * sb;
  const int ch = blockIdx.y;
  const int h0 = blockIdx.x * heads;
  const int jend = (Q + 7) / 8;       // t-tiles holding a row t < Q
  const long long row0 = static_cast<long long>(ch) * Q;

  // B, and C into the head buffers
  const float* bsrc = b + ch * sb_.c + h0 * sb_.h;
  const float* csrc = c + ch * sc.c + h0 * sc.h;
  tc::load_f32_tile<kRows, kNP, kThreads>(sm_s + 4 * L::kB, kPB, bsrc, sb_.q, Q, N, vec_bc);
  tc::load_f32_tile<kRows, kNP, kThreads>(sm_s + 4 * L::kHead, kPB, csrc, sc.q, Q, N, vec_bc);
  tc::cp_commit();
  tc::cp_wait<0>();
  __syncthreads();

  // Sᵀ = B·Cᵀ over N, tile by tile, into its fragments; ΣdSᵀ zeroed
  {
    const float* Cs = sm + L::kHead;
    for (int j = 2 * sb; j < jend; ++j) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kNn; ++kk) {
        tc::Tf32Frag<4> a;
        const float* br = Bs + (s0 + g8) * kPB + 8 * kk + t4;
        a.set(0, br[0]);
        a.set(1, br[8 * kPB]);
        a.set(2, br[4]);
        a.set(3, br[8 * kPB + 4]);
        tc::Tf32Frag<2> bf;
        const float* cr = Cs + (8 * j + g8) * kPB + 8 * kk + t4;
        bf.set(0, cr[0]);
        bf.set(1, cr[4]);
        tc::mma_3xtf32(acc, a, bf);
      }
      const int at = ((tile0(sb) + j - 2 * sb) * 32 + lane) * 4;
      *reinterpret_cast<float4*>(Sf + at) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(Sum + at) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  DbAcc<kNn, kNP == 64> dba;   // Σ_h w∘F of this warp's rows
  // this block's dB part: rows (BC·Q) of gridDim.x parts of N; the place of
  // element (n, e) of this thread's fragments in it, or nullptr
  const long long ld = static_cast<long long>(gridDim.x) * N;
  const long long at0 = row0 * ld + static_cast<long long>(blockIdx.x) * N;
  auto db_at = [&](int n, int e) -> float* {
    const int s = s0 + g8 + 8 * (e / 2), col = 8 * n + 2 * t4 + e % 2;
    return s < Q && col < N ? dbp + at0 + s * ld + col : nullptr;
  };
  __syncthreads();  // C is consumed

  // head hh's dy and dst into head buffer hh % kBufs
  auto load_head = [&](int hh) {
    const int h = h0 + hh;
    const uint32_t buf = sm_s + 4 * (L::kHead + (hh % L::kBufs) * L::kHeadBuf);
    tc::load_f32_tile<kRows, kMaxP, kThreads>(buf, kPY, dy == nullptr ? x : dy + ch * sy.c + h * sy.h,
                                              sy.q, dy == nullptr ? 0 : Q, P, vec_y);
    tc::load_f32_tile<kMaxP, kNP, kThreads>(
        buf + 4 * L::kDst, kPB,
        dstate == nullptr ? x : dstate + (static_cast<long long>(ch) * H + h) * P * N, N,
        dstate == nullptr ? 0 : P, N, vec_d);
    tc::cp_commit();
  };
  load_head(0);

  for (int hh = 0; hh < heads; ++hh) {
    const int h = h0 + hh;
    if (L::kBufs == 2 && hh + 1 < heads) {
      load_head(hh + 1);
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    const float* Ys = sm + L::kHead + (hh % L::kBufs) * L::kHeadBuf;
    const float* Ds = Ys + L::kDst;
    // x of this warp's rows as A fragments, split once a head: a_i at row
    // s0 + g8 + 8·(i % 2), column 8kk + t4 + 4·(i / 2)
    tc::Tf32Frag<4> xf[8];
    {
      const float* xp = x + ch * sx.c + h * sx.h;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s0 + g8 + 8 * (i % 2), p = 8 * kk + t4 + 4 * (i / 2);
          xf[kk].set(i, s < Q && p < P ? xp[s * sx.q + p] : 0.f);
        }
    }
    if (warp == 0) {
      chunk_cumsum(cs, dt_a + ch * sa.c + h * sa.h, sa.q, Q);
      __syncwarp();
      for (int t = lane; t < kRows; t += 32) {
        w[t] = t < Q ? expf(cs[Q - 1] - cs[t]) : 0.f;
        if (t >= Q) cs[t] = 0.f;
      }
    }
    __syncthreads();

    // dx = w∘(B·dstᵀ) first: rows s0 + g8 (+8), columns 8p + 2·t4 (+1)
    float dxa[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[p][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNn; ++kk) {
      tc::Tf32Frag<4> a;
      const float* br = Bs + (s0 + g8) * kPB + 8 * kk + t4;
      a.set(0, br[0]);
      a.set(1, br[8 * kPB]);
      a.set(2, br[4]);
      a.set(3, br[8 * kPB + 4]);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        tc::Tf32Frag<2> bf;
        const float* dr = Ds + (8 * p + g8) * kPB + 8 * kk + t4;
        bf.set(0, dr[0]);
        bf.set(1, dr[4]);
        tc::mma_3xtf32(dxa[p], a, bf);
      }
    }
    const float w_lo = w[s0 + g8], w_hi = w[s0 + g8 + 8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      dxa[p][0] *= w_lo;
      dxa[p][1] *= w_lo;
      dxa[p][2] *= w_hi;
      dxa[p][3] *= w_hi;
    }

    // the t-tiles
    const float cs_lo = cs[s0 + g8], cs_hi = cs[s0 + g8 + 8];
    float col_lo = 0.f, col_hi = 0.f;  // Σ_t (dS∘S)[t][s] of rows s0 + g8 (+8)
    for (int j = 2 * sb; j < jend; ++j) {
      float dm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        tc::Tf32Frag<2> bf;
        const float* yr = Ys + (8 * j + g8) * kPY + 8 * kk + t4;
        bf.set(0, yr[0]);
        bf.set(1, yr[4]);
        tc::mma_3xtf32(dm, xf[kk], bf);
      }
      const int at = ((tile0(sb) + j - 2 * sb) * 32 + lane) * 4;
      const float4 sv = *reinterpret_cast<const float4*>(Sf + at);
      const float4 acc = *reinterpret_cast<const float4*>(Sum + at);
      const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
      float wt[4], ds[4], r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + g8 + 8 * (e / 2), t = 8 * j + 2 * t4 + e % 2;
        const float l = s <= t && t < Q ? expf(cs[t] - (e < 2 ? cs_lo : cs_hi)) : 0.f;
        wt[e] = s4[e] * l;
        ds[e] = dm[e] * l;
        r[e] = ds[e] * s4[e];
      }
      *reinterpret_cast<float4*>(Sum + at) =
          make_float4(acc.x + ds[0], acc.y + ds[1], acc.z + ds[2], acc.w + ds[3]);
      col_lo += r[0] + r[1];
      col_hi += r[2] + r[3];
      // Σ_s (dS∘S)[t][s] over this warp's 16 rows: columns 2·t4 (+1)
      float c0 = r[0] + r[2], c1 = r[1] + r[3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c0 += __shfl_xor_sync(0xffffffffu, c0, o);
        c1 += __shfl_xor_sync(0xffffffffu, c1, o);
      }
      if (g8 == 0) {
        rows_p[sb * kRows + 8 * j + 2 * t4] = c0;
        rows_p[sb * kRows + 8 * j + 2 * t4 + 1] = c1;
      }
      // dx += Wᵀ·dy over this tile's 8 rows t
      tc::Tf32Frag<4> wa;
      tc::acc_as_a(wa, wt);
      const float* yr = Ys + (8 * j + 2 * t4) * kPY + g8;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        tc::Tf32Frag<2> bf;
        bf.set(0, yr[8 * p]);
        bf.set(1, yr[kPY + 8 * p]);
        tc::mma_3xtf32(dxa[p], wa, bf);
      }
    }
    col_lo += __shfl_xor_sync(0xffffffffu, col_lo, 1);
    col_hi += __shfl_xor_sync(0xffffffffu, col_hi, 1);
    col_lo += __shfl_xor_sync(0xffffffffu, col_lo, 2);
    col_hi += __shfl_xor_sync(0xffffffffu, col_hi, 2);

    // F = x·dst column tile by column tile: dw and dB's w∘F
    float dw_lo = 0.f, dw_hi = 0.f;
#pragma unroll
    for (int n = 0; n < kNn; ++n) {
      float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        tc::Tf32Frag<2> bf;
        const float* dr = Ds + (8 * kk + t4) * kPB + 8 * n + g8;
        bf.set(0, dr[0]);
        bf.set(1, dr[4 * kPB]);
        tc::mma_3xtf32(f, xf[kk], bf);
      }
      const float* br = Bs + (s0 + g8) * kPB + 8 * n + 2 * t4;
      dw_lo += f[0] * br[0] + f[1] * br[1];
      dw_hi += f[2] * br[8 * kPB] + f[3] * br[8 * kPB + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dba.add(n, e, (e < 2 ? w_lo : w_hi) * f[e], db_at(n, e), hh == 0);
    }
    dw_lo += __shfl_xor_sync(0xffffffffu, dw_lo, 1);
    dw_hi += __shfl_xor_sync(0xffffffffu, dw_hi, 1);
    dw_lo += __shfl_xor_sync(0xffffffffu, dw_lo, 2);
    dw_hi += __shfl_xor_sync(0xffffffffu, dw_hi, 2);
    if (t4 == 0) {
      cols[s0 + g8] = col_lo;
      cols[s0 + g8 + 8] = col_hi;
      dwv[s0 + g8] = dw_lo;
      dwv[s0 + g8 + 8] = dw_hi;
    }
    // dx of this head
    float* const dxp = dx + (row0 * H + h) * P;
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + g8 + 8 * (e / 2), col = 8 * p + 2 * t4 + e % 2;
        if (s < Q && col < P) dxp[static_cast<long long>(s) * H * P + col] = dxa[p][e];
      }
    __syncthreads();  // the row sums' parts, cols and dw are in
    if (warp == 0) {
      for (int t = lane; t < Q; t += 32) {
        float v = 0.f;
        for (int k = 0; k <= t / 16; ++k) v += rows_p[k * kRows + t];
        rows[t] = v;
      }
      __syncwarp();
      finish_ddt(ddt + row0 * H + h, ddecay == nullptr ? nullptr : ddecay + row0 * H + h, H,
                 rows, cols, dwv, w, cs, Q);
    }
    if (L::kBufs == 1 && hh + 1 < heads) load_head(hh + 1);  // its buffer is consumed
    __syncthreads();  // cs, w and the sums are consumed
  }

  // C again into the head buffers, then dB = ΣdSᵀ·C + Σ w∘F
  tc::load_f32_tile<kRows, kNP, kThreads>(sm_s + 4 * L::kHead, kPB, csrc, sc.q, Q, N, vec_bc);
  tc::cp_commit();
  tc::cp_wait<0>();
  __syncthreads();
  const float* Cs = sm + L::kHead;
  // both products in passes of kNs n8 tiles (N = 128: two passes of 64
  // columns, whose 32-register accumulators leave room for the rest)
  constexpr int kNs = kNP == 128 ? kNn / 2 : kNn;
#pragma unroll
  for (int n0 = 0; n0 < kNn; n0 += kNs) {
    float dbf[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dbf[n][e] = dba.get(n0 + n, e, db_at(n0 + n, e));
    for (int j = 2 * sb; j < jend; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          Sum + ((tile0(sb) + j - 2 * sb) * 32 + lane) * 4);
      const float d4[4] = {v.x, v.y, v.z, v.w};
      tc::Tf32Frag<4> a;
      tc::acc_as_a(a, d4);
      const float* cr = Cs + (8 * j + 2 * t4) * kPB + 8 * n0 + g8;
#pragma unroll
      for (int n = 0; n < kNs; ++n) {
        tc::Tf32Frag<2> bf;
        bf.set(0, cr[8 * n]);
        bf.set(1, cr[kPB + 8 * n]);
        tc::mma_3xtf32(dbf[n], a, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (float* at = db_at(n0 + n, e)) *at = dbf[n][e];
  }

  // dC = ΣdS·B: this warp's rows t of t-block sb, over s = 0 .. 16·sb + 15
  // (k-steps of 8 s, A read from ΣdSᵀ's fragments: element (s, t) is lane
  // (s % 8)·4 + (t % 8) / 2, value (t % 2) + 2·((s % 16) / 8) of tile (s /
  // 16, t / 8))
  if (s0 >= Q) return;
  auto sum_at = [&](int s, int t) {
    const int tile = tile0(s / 16) + t / 8 - 2 * (s / 16);
    return Sum[(tile * 32 + (s % 8) * 4 + (t % 8) / 2) * 4 + (t % 2) + 2 * ((s % 16) / 8)];
  };
#pragma unroll
  for (int n0 = 0; n0 < kNn; n0 += kNs) {
    float dca[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dca[n][e] = 0.f;
    for (int kk = 0; kk < 2 * sb + 2; ++kk) {
      // k = 8kk + 2·t4 (+1) for a_0/a_1 (a_2/a_3): rows t = s0 + g8 (+8)
      tc::Tf32Frag<4> a;
      const int s = 8 * kk + 2 * t4, t = s0 + g8;
      a.set(0, sum_at(s, t));
      a.set(1, sum_at(s, t + 8));
      a.set(2, sum_at(s + 1, t));
      a.set(3, sum_at(s + 1, t + 8));
      const float* br = Bs + s * kPB + 8 * n0 + g8;
#pragma unroll
      for (int n = 0; n < kNs; ++n) {
        tc::Tf32Frag<2> bf;
        bf.set(0, br[8 * n]);
        bf.set(1, br[kPB + 8 * n]);
        tc::mma_3xtf32(dca[n], a, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = s0 + g8 + 8 * (e / 2), col = 8 * (n0 + n) + 2 * t4 + e % 2;
        if (t < Q && col < N) dcp[at0 + t * ld + col] = dca[n][e];
      }
  }
}

}  // namespace ssd_bwd_f32

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

template <int kNP>
cudaError_t launch_f32(const float* x, const float* dt_a, const float* b, const float* c,
                       const float* dy, const float* dstate, const float* ddecay, float* dx,
                       float* ddt, float* db, float* dc, const long long* st, int BC, int Q,
                       int H, int P, int N, int heads, cudaStream_t stream) {
  using L = ssd_bwd_f32::Layout<kNP>;
  // opt in once per instantiation (the first launch must come outside any
  // CUDA graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(ssd_bwd_f32::ssd_bwd_tf32_kernel<kNP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 L::kBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const Strides4 sx{st[0], st[1], st[2]};
  const Strides4 sa{st[3], st[4], st[5]};
  const Strides4 sb{st[6], st[7], st[8]};
  const Strides4 sc{st[9], st[10], st[11]};
  const Strides4 sy{st[12], st[13], st[14]};
  using ssd::tile::aligned16;
  // 16-byte copies where every row starts 16-byte aligned
  const bool vec_y = dy == nullptr || (aligned16(dy) && sy.c % 4 == 0 && sy.q % 4 == 0 &&
                                       sy.h % 4 == 0);
  const bool vec_bc = aligned16(b) && aligned16(c) && sb.c % 4 == 0 && sb.q % 4 == 0 &&
                      sb.h % 4 == 0 && sc.c % 4 == 0 && sc.q % 4 == 0 && sc.h % 4 == 0;
  const bool vec_d = dstate == nullptr || (aligned16(dstate) && N % 4 == 0);
  ssd_bwd_f32::ssd_bwd_tf32_kernel<kNP><<<dim3(H / heads, BC), ssd_bwd_f32::kThreads,
                                          L::kBytes, stream>>>(
      x, dt_a, b, c, dy, dstate, ddecay, dx, ddt, db, dc, sx, sa, sb, sc, sy, BC, H, Q, P, N,
      heads, vec_y, vec_bc, vec_d);
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
// bfloat16 x, b, c, dy (the wgmma kernel), else fp32 (the 3xTF32 kernel);
// either walks `heads` consecutive heads of one group a block (a divisor
// of H / G, at most 16): part (2, BC, Q, H / heads, N) fp32 takes each
// block's dB and dC, or is nullptr where a block is a whole group (H /
// heads = G) and writes db and dc itself.
cudaError_t launch_ssd_chunk_bwd(const void* x, const float* dt_a, const void* b,
                                 const void* c, const void* dy, const float* dstate,
                                 const float* ddecay, void* dx, float* ddt, float* part,
                                 void* db, void* dc, const long long* st, int BC, int Q,
                                 int H, int P, int N, int G, int bf16, int heads,
                                 cudaStream_t stream) {
  if (BC < 1 || BC > 65535 || Q < 1 || Q > kMaxQ || H < 1 || H > 65535 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G)
    return cudaErrorInvalidValue;
  const int parts = heads >= 1 ? H / heads : 0;
  const int max_heads = bf16 ? ssd_bwd_tc::kMaxHeads : ssd_bwd_f32::kMaxHeads;
  if (heads < 1 || heads > max_heads || (H / G) % heads || (part == nullptr && parts != G))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16) {
    err = N <= 64 ? ssd_bwd_tc::launch<1>(x, dt_a, b, c, dy, dstate, ddecay, dx, ddt, part,
                                          db, dc, st, BC, Q, H, P, N, heads, stream)
                  : ssd_bwd_tc::launch<2>(x, dt_a, b, c, dy, dstate, ddecay, dx, ddt, part,
                                          db, dc, st, BC, Q, H, P, N, heads, stream);
  } else {
    // each block's dB and dC into its part, or into db and dc where a block
    // is a whole group
    float* const dbp = part != nullptr ? part : static_cast<float*>(db);
    float* const dcp = part != nullptr ? part + static_cast<long long>(BC) * Q * parts * N
                                       : static_cast<float*>(dc);
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    err = N <= 64 ? launch_f32<64>(f(x), dt_a, f(b), f(c), f(dy), dstate, ddecay,
                                   static_cast<float*>(dx), ddt, dbp, dcp, st, BC, Q, H, P, N,
                                   heads, stream)
                  : launch_f32<128>(f(x), dt_a, f(b), f(c), f(dy), dstate, ddecay,
                                    static_cast<float*>(dx), ddt, dbp, dcp, st, BC, Q, H, P,
                                    N, heads, stream);
  }
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
        part, static_cast<float*>(db), static_cast<float*>(dc), rows, parts, G, N);
  return cudaGetLastError();
}
