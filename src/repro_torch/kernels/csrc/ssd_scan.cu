// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a): the Mamba2 prefill's
// quadratic term.
//
// Replaces the TPU kernel ssd_chunk (_kernel) of
// src/repro/kernels/ssd_scan.py.  Per (chunk, head), with
// cs = cumsum(dt_a) in fp32:
//   y_diag[t] = Σ_{s<=t} (C_t·B_s) exp(cs_t − cs_s) x_s     (in x's dtype)
//   state     = Σ_s exp(cs_{Q-1} − cs_s) B_s x_sᵀ            (P x N, fp32)
//   decay[t]  = exp(cs_t)                                   (fp32)
// Nothing of size Q x Q reaches device memory: that fusion is what the TPU
// kernel exists for.  Q <= 128, P <= 64 and N <= 128 cover Zamba2 (Q = 128,
// P = N = 64), Mamba2-2.7B (Q = 128, P = 64, N = 128) and the smaller test
// shapes.  N reaches both kernels as a template parameter (64 or 128
// columns), never as a run-time loop bound.  x, B and C are read through
// their (chunk, row, head) strides, so one B/C group broadcast to every
// head (ssm_groups = 1) is a stride-0 view, never copied.  Two
// instantiations, chosen by dtype (neither stands in for the other):
//
//   bf16  ssd_chunk_wgmma_kernel: both products on the tensor cores
//         (design below).
//   fp32  ssd_chunk_tf32_kernel: both products on the tensor cores as
//         3xTF32 on mma.sync (each fp32 operand split into TF32 hi + lo, a
//         product taken as lo·hi + hi·lo + hi·hi: ~22 of fp32's 24 bits,
//         where one TF32 product keeps 11 and misses fp32's 1e-5 bar); a
//         block walks the heads of one B/C group, S = C·Bᵀ once a block
//         (design below, at the kernel).
//
// What bounds the bf16 kernel on an H100: bytes.  At the serving shape (16
// chunks x 64 heads, Q = 128, P = N = 64, stride-0 B/C) it must move ~52 MB
// (x read, y written and the fp32 state written, 16.8 MB each; the state's
// fp32 is fixed by the contract) against ~3.2 GFLOP of products, 3.3 µs at
// the bf16 tensor-core peak: ~15.5 µs of bytes.
//
// At Mamba2-2.7B's prefill shape (16 chunks x 80 heads, Q = 128, P = 64,
// N = 128, stride-0 B/C) it moves ~86 MB (x and y 21 MB each, the fp32
// state 42 MB) against ~11 GFLOP with the hi/lo split: ~26 µs of bytes,
// ~11 µs of bf16 operations.
//
// bf16 design.  One block of 256 threads (two warpgroups) walks
// heads_per_block consecutive heads of one chunk (the host plan ssd_plan
// in kernels/ssd_scan.py picks it so that the grid fills the card).  At
// N <= 64 a block holds 6 tiles (101 KB: two blocks per SM); at N = 128
// C, B and the w·B hi/lo tiles are two 64-column tiles each and all 10
// tiles stay resident (165 KB: one block per SM).  That layout was chosen
// over building w·B and the state one 64-column half of N at a time (8
// tiles, 133 KB): 133 KB still leaves one block per SM, so the split
// would buy no occupancy and would add a barrier and a second pass over
// x per head.  With all tiles resident, S = C·Bᵀ takes 8 k16 steps in
// place of 4 and the state one m64n128 product in place of m64n64; the
// rest of the kernel is N's size-free.  x, B and C are staged as
// bf16 by cp.async (16-byte copies with zero fill, or element by element
// for ragged shapes) into 128-byte-swizzled tiles of 128 rows; where
// the B and C head strides are both 0 they are staged once for all the
// block's heads, and the next head's x is in flight while the current one
// computes.  One warp per head scans cs and writes decay.  Per head:
//   S = C·Bᵀ   wgmma m64n64k16 per 64 x 64 tile up to the diagonal, over
//              N in k16 steps, C and B both K-major in shared memory
//              (warpgroup wg owns rows 64·wg.. and tiles j <= wg);
//   W = S ∘ exp(cs_t − cs_s) on s <= t, in fp32 on the accumulator
//              fragment, split into bf16 hi = bf16(W) and lo = bf16(W − hi)
//              and packed as register A fragments;
//   y += hi·x + lo·x   wgmma m64n64k16, x MN-major in shared memory;
//   state = xᵀ·(wB_hi + wB_lo)   wgmma m64n(N)k16 with both operands
//              MN-major in shared memory (warpgroup 0), where w_s·B[s][n]
//              with w_s = exp(cs_{Q-1} − cs_s) is formed by all threads as a
//              bf16 hi/lo pair.
// The hi/lo split is what keeps the weights exact enough: W and w·B are
// fp32 values, and one rounding to bf16 (2^-9 relative) puts y and the
// state past their bars; hi + lo carries ~16 bits, the products' sums stay
// in fp32, and C·Bᵀ's products are exact on bf16 inputs.  S is recomputed per
// head from the staged B and C (4 wgmma a tile): keeping it across heads
// would take 64 more registers a thread or 48 KB of shared memory, either
// of which leaves one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"
#include "ssd_common.cuh"

namespace {

using ssd::chunk_cumsum;
using ssd::kMaxN;
using ssd::kMaxP;
using ssd::kMaxQ;
using ssd::round_up;
using ssd::Strides4;

// ---------------------------------------------------------------------------
// fp32: tensor cores, every product as 3xTF32 (hopper_tc.cuh).
//
// One block of 256 threads (8 warps) walks `heads` consecutive heads of
// one chunk that share their B and C (the backward's host plan,
// ssd_bwd_plan in kernels/ssd_scan.py: 8 of Zamba2's 64 heads and 10 of
// mamba2-2.7b's 80, 128 blocks, one wave on 132 SMs; one head a block
// where B and C are per head).
//   once a block:  B and C staged by cp.async (rows of N + 4 floats, zero
//            past Q and N) with the first head's x; cs, decay and w_s =
//            exp(cs_{Q-1} − cs_s) of every head, a warp a head; S = C·Bᵀ
//            over the 72 m16 x k8 tiles of its lower part (s <= t), kept in
//            registers across a barrier and then stored as fragments (each
//            lane's 4 values) in C's place;
//   per head:  the next head's x in flight (cp.async, two buffers);
//     y:     warp w owns rows t of row block rb = w (w < 4) or 11 − w, so
//            the two warps of a scheduler partition share 18 of the 72
//            tiles; per k8 slice of s, W = S∘exp(cs_t − cs_s) on s <= t on
//            the fragment, which goes to the A operand in registers
//            (tc::acc_as_a), and y += W·x over P in n8 tiles;
//     state: warp w owns rows p 16·(w % 4).. and half of N; state = (w∘x)ᵀ·B
//            over the chunk's rows, w∘x formed as A's fragment is read.
// The k index of the products that read S's fragments or take w∘x as A
// pairs A's columns t4 and t4 + 4 with rows 2·t4 and 2·t4 + 1 of the k8
// slice, which puts every fragment read of x and B (rows of 68 and N + 4
// floats) on 32 distinct banks.  Shared memory: B and C/S 34,816 and
// 36,864 bytes at N <= 64 (S's fragments pass C), 67,584 each at N = 128,
// x 69,632, each head's cs and w 16,384: 157,696 and 221,184 bytes, one
// block an SM.
namespace ssd_f32 {

constexpr int kThreads = 256;     // 8 warps
constexpr int kRows = 128;        // rows of a chunk's tiles, zero past Q
constexpr int kTiles = 72;        // the m16 x k8 tiles of S's lower part
constexpr int kMaxHeads = 16;     // heads a block walks, at most
constexpr int kPX = kMaxP + 4;    // an x row

// shared memory in floats for N padded to kNP (64 or 128)
template <int kNP>
struct Layout {
  static constexpr int kPB = kNP + 4;
  static constexpr int kB = 0;
  static constexpr int kC = kB + kRows * kPB;   // C, then S's fragments
  static constexpr int kCS = kRows * kPB > kTiles * 128 ? kRows * kPB : kTiles * 128;
  static constexpr int kX = kC + kCS;           // two buffers
  static constexpr int kSmall = kX + 2 * kRows * kPX;   // cs, then w, of each head
  static constexpr int kBytes = 4 * (kSmall + 2 * kMaxHeads * kRows);
};

// the first of row block rb's tiles (its k8 slices 0 .. 2·rb + 1)
__device__ __forceinline__ int tile0(int rb) { return rb * (rb + 1); }

template <int kNP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dt_a,
                      const float* __restrict__ b, const float* __restrict__ c,
                      float* __restrict__ y, float* __restrict__ state,
                      float* __restrict__ decay, Strides4 sx, Strides4 sa, Strides4 sb,
                      Strides4 sc, int H, int Q, int P, int N, int heads, bool vec_x,
                      bool vec_bc) {
  using L = Layout<kNP>;
  constexpr int kPB = L::kPB;
  constexpr int kNn = kNP / 8;    // k-steps of S over N
  constexpr int kNh = kNn / 2;    // n8 tiles of a warp's half of the state
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const uint32_t sm_s = tc::smem_u32(sm);
  const float* const Bs = sm + L::kB;
  float* const Sf = sm + L::kC;
  float* const cs_all = sm + L::kSmall;
  float* const w_all = cs_all + kMaxHeads * kRows;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int rb = warp < 4 ? warp : 11 - warp;   // rows t0 .. t0 + 15 of y and S
  const int t0 = 16 * rb;
  const int ch = blockIdx.y;
  const int h0 = blockIdx.x * heads;
  const int kend = (Q + 7) / 8;                 // k8 slices holding a row < Q
  const int nsl = min(2 * rb + 2, kend);        // the warp's slices of S
  const long long row0 = static_cast<long long>(ch) * Q;

  auto load_x = [&](int i) {
    tc::load_f32_tile<kRows, kMaxP, kThreads>(sm_s + 4 * (L::kX + (i % 2) * kRows * kPX), kPX,
                                              x + ch * sx.c + (h0 + i) * sx.h, sx.q, Q, P,
                                              vec_x);
  };
  tc::load_f32_tile<kRows, kNP, kThreads>(sm_s + 4 * L::kB, kPB, b + ch * sb.c + h0 * sb.h,
                                          sb.q, Q, N, vec_bc);
  tc::load_f32_tile<kRows, kNP, kThreads>(sm_s + 4 * L::kC, kPB, c + ch * sc.c + h0 * sc.h,
                                          sc.q, Q, N, vec_bc);
  load_x(0);
  tc::cp_commit();

  // cs, decay and w of every head of the block, warp i the heads i, i + 8
  for (int i = warp; i < heads; i += kThreads / 32) {
    float* const cs = cs_all + i * kRows;
    float* const wv = w_all + i * kRows;
    chunk_cumsum(cs, dt_a + ch * sa.c + (h0 + i) * sa.h, sa.q, Q);
    __syncwarp();
    const float last = cs[Q - 1];
    __syncwarp();
    for (int t = lane; t < kRows; t += 32) {
      if (t < Q) {
        decay[(row0 + t) * H + h0 + i] = expf(cs[t]);
        wv[t] = expf(last - cs[t]);
      } else {
        cs[t] = 0.f;
        wv[t] = 0.f;
      }
    }
  }
  tc::cp_wait<0>();
  __syncthreads();  // B, C and the first x are in

  // S = C·Bᵀ: tile (rb, kk), rows t0 + g8 (+8), columns s = 8kk + 2·t4 (+1)
  {
    float sacc[16][4];
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[kk][e] = 0.f;
    const float* const Cs = sm + L::kC;
    if (t0 < Q) {
#pragma unroll 2
      for (int ks = 0; ks < kNn; ++ks) {
        tc::Tf32Frag<4> a;
        const float* const cr = Cs + (t0 + g8) * kPB + 8 * ks + t4;
        a.set(0, cr[0]);
        a.set(1, cr[8 * kPB]);
        a.set(2, cr[4]);
        a.set(3, cr[8 * kPB + 4]);
        const float* const br = Bs + g8 * kPB + 8 * ks + t4;
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          if (kk < nsl) {
            tc::Tf32Frag<2> bf;
            bf.set(0, br[8 * kk * kPB]);
            bf.set(1, br[8 * kk * kPB + 4]);
            tc::mma_3xtf32(sacc[kk], a, bf);
          }
        }
      }
    }
    __syncthreads();  // C is consumed: S's fragments take its place
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      if (kk < nsl && t0 < Q)
        *reinterpret_cast<float4*>(Sf + ((tile0(rb) + kk) * 32 + lane) * 4) =
            make_float4(sacc[kk][0], sacc[kk][1], sacc[kk][2], sacc[kk][3]);
  }

  const int pb = warp % 4, nh = warp / 4;   // the warp's state rows and half of N
  for (int i = 0; i < heads; ++i) {
    const int h = h0 + i;
    tc::cp_wait<0>();
    __syncthreads();  // head i's x (and S) in; every warp is done with head i − 1
    if (i + 1 < heads) {  // the next head's x, under this head's products
      load_x(i + 1);
      tc::cp_commit();
    }
    const float* const Xs = sm + L::kX + (i % 2) * kRows * kPX;
    const float* const cs = cs_all + i * kRows;
    const float* const wv = w_all + i * kRows;

    // y over the warp's slices: W's fragment from S's, then W·x
    if (t0 < Q) {
      float ya[8][4];
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[p][e] = 0.f;
      const float ct[2] = {cs[t0 + g8], cs[t0 + g8 + 8]};
      for (int kk = 0; kk < nsl; ++kk) {
        const float4 sv = *reinterpret_cast<const float4*>(Sf + ((tile0(rb) + kk) * 32 + lane) * 4);
        const float2 css = *reinterpret_cast<const float2*>(cs + 8 * kk + 2 * t4);
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
        float wt[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + g8 + 8 * (e / 2), s = 8 * kk + 2 * t4 + e % 2;
          wt[e] = s <= t ? s4[e] * expf(ct[e / 2] - (e % 2 ? css.y : css.x)) : 0.f;
        }
        tc::Tf32Frag<4> wa;
        tc::acc_as_a(wa, wt);
        const float* const xr = Xs + (8 * kk + 2 * t4) * kPX + g8;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          tc::Tf32Frag<2> xb;
          xb.set(0, xr[8 * p]);
          xb.set(1, xr[kPX + 8 * p]);
          tc::mma_3xtf32(ya[p], wa, xb);
        }
      }
      // y (BC, Q, H, P), contiguous
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + g8 + 8 * (e / 2), col = 8 * p + 2 * t4 + e % 2;
          if (t < Q && col < P) y[((row0 + t) * H + h) * P + col] = ya[p][e];
        }
    }

    // state = (w∘x)ᵀ·B: rows p = 16·pb + g8 (+8), columns n = 8·(kNh·nh + j)
    // + 2·t4 (+1), over the chunk's rows in k8 steps
    if (16 * pb < P) {
      float sa_[kNh][4];
#pragma unroll
      for (int j = 0; j < kNh; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa_[j][e] = 0.f;
      for (int ks = 0; ks < kend; ++ks) {
        const int s0 = 8 * ks + 2 * t4;
        const float2 ww = *reinterpret_cast<const float2*>(wv + s0);
        const float* const xr = Xs + s0 * kPX + 16 * pb + g8;
        tc::Tf32Frag<4> a;
        a.set(0, ww.x * xr[0]);
        a.set(1, ww.x * xr[8]);
        a.set(2, ww.y * xr[kPX]);
        a.set(3, ww.y * xr[kPX + 8]);
        const float* const br = Bs + s0 * kPB + 8 * kNh * nh + g8;
#pragma unroll
        for (int j = 0; j < kNh; ++j) {
          tc::Tf32Frag<2> bf;
          bf.set(0, br[8 * j]);
          bf.set(1, br[kPB + 8 * j]);
          tc::mma_3xtf32(sa_[j], a, bf);
        }
      }
      // state (BC, H, P, N), contiguous
      float* const sp = state + (static_cast<long long>(ch) * H + h) * P * N;
#pragma unroll
      for (int j = 0; j < kNh; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * pb + g8 + 8 * (e / 2);
          const int n = 8 * (kNh * nh + j) + 2 * t4 + e % 2;
          if (p < P && n < N) sp[p * N + n] = sa_[j][e];
        }
    }
  }
}

template <int kNP>
cudaError_t launch(const float* x, const float* dt_a, const float* b, const float* c,
                   float* y, float* state, float* decay, const long long* st, int BC, int Q,
                   int H, int P, int N, int heads, cudaStream_t stream) {
  const Strides4 sx{st[0], st[1], st[2]};
  const Strides4 sa{st[3], st[4], st[5]};
  const Strides4 sb{st[6], st[7], st[8]};
  const Strides4 sc{st[9], st[10], st[11]};
  // a block's heads share one B and C: stride-0 heads, or one head a block
  if (heads < 1 || heads > kMaxHeads || H % heads || (heads > 1 && (sb.h != 0 || sc.h != 0)))
    return cudaErrorInvalidValue;
  // opt in once per instantiation (the first launch must come outside any
  // CUDA graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_tf32_kernel<kNP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<kNP>::kBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  using ssd::tile::aligned16;
  // 16-byte copies where every row starts 16-byte aligned
  const bool vec_x = aligned16(x) && sx.c % 4 == 0 && sx.q % 4 == 0 && sx.h % 4 == 0;
  const bool vec_bc = aligned16(b) && aligned16(c) && sb.c % 4 == 0 && sb.q % 4 == 0 &&
                      sb.h % 4 == 0 && sc.c % 4 == 0 && sc.q % 4 == 0 && sc.h % 4 == 0;
  ssd_chunk_tf32_kernel<kNP><<<dim3(H / heads, BC), kThreads, Layout<kNP>::kBytes, stream>>>(
      x, dt_a, b, c, y, state, decay, sx, sa, sb, sc, H, Q, P, N, heads, vec_x, vec_bc);
  return cudaGetLastError();
}

}  // namespace ssd_f32

// ---------------------------------------------------------------------------
// bf16: tensor cores.
namespace ssd_tc {

using ssd::tile::bf16;
using ssd::tile::kRows;        // rows of every tile, zero past Q
using ssd::tile::kThreads;     // two warpgroups
using ssd::tile::kTileBytes;   // 128 rows x 64 bf16 columns
constexpr int kMaxHeads = 8;   // heads a block walks, at most

// Shared memory of the kernel for N in kNT 64-column tiles: C and B (kNT
// tiles each), x (two buffers of one tile), w·B hi and lo (kNT tiles
// each), then cs of each head; + alignment.  kNT = 1: 101 KB, two blocks
// an SM; kNT = 2: 165 KB, one.
template <int kNT>
struct Layout {
  static constexpr uint32_t kC = 0;
  static constexpr uint32_t kB = kNT * kTileBytes;
  static constexpr uint32_t kX = 2 * kNT * kTileBytes;
  static constexpr uint32_t kWH = (2 * kNT + 2) * kTileBytes;
  static constexpr uint32_t kWL = (3 * kNT + 2) * kTileBytes;
  static constexpr uint32_t kCs = (4 * kNT + 2) * kTileBytes;
  static constexpr int kSmem = 1024 + kCs + kMaxHeads * kRows * 4;
  static constexpr int kBlocksPerSM = kNT == 1 ? 2 : 1;
};

using ssd::tile::cp_async_commit;
using ssd::tile::cp_async_wait_all;
using ssd::tile::exp_f;
using ssd::tile::pack;
using ssd::tile::split;
using ssd::tile::stage;
using ssd::tile::stage_n;
using ssd::tile::sw128;

// kNT: N in 64-column tiles (1 for N <= 64, 2 for N <= 128)
template <int kNT>
__global__ void __launch_bounds__(kThreads, Layout<kNT>::kBlocksPerSM)
ssd_chunk_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt_a,
                       const bf16* __restrict__ b, const bf16* __restrict__ c,
                       bf16* __restrict__ y, float* __restrict__ state,
                       float* __restrict__ decay, Strides4 sx, Strides4 sa,
                       Strides4 sb, Strides4 sc, int H, int Q, int P, int N,
                       int heads, int vec) {
  using Lay = Layout<kNT>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_u32(smem);
  constexpr uint32_t kC = Lay::kC, kB = Lay::kB, kX = Lay::kX, kWH = Lay::kWH,
                     kWL = Lay::kWL;
  float* cs_all = reinterpret_cast<float*>(smem + Lay::kCs);  // heads x kRows

  const int ch = blockIdx.y;
  const int h0 = blockIdx.x * heads;
  const bool shared_bc = sb.h == 0 && sc.h == 0;
  const int tid = threadIdx.x;
  const bf16* xc = x + ch * sx.c;
  const bf16* bc = b + ch * sb.c;
  const bf16* cc = c + ch * sc.c;

  stage_n<kNT>(smem, kC, cc + h0 * sc.h, sc.q, Q, N, vec);
  stage_n<kNT>(smem, kB, bc + h0 * sb.h, sb.q, Q, N, vec);
  stage(smem, kX, xc + h0 * sx.h, sx.q, Q, P, vec);
  cp_async_commit();

  // cs and decay of every head of the block, one warp a head
  if (tid / 32 < heads) {
    const int i = tid / 32;
    float* cs = cs_all + i * kRows;
    chunk_cumsum(cs, dt_a + ch * sa.c + (h0 + i) * sa.h, sa.q, Q);
    __syncwarp();
    for (int t = tid % 32; t < kRows; t += 32) {
      if (t < Q)
        decay[(static_cast<long long>(ch) * Q + t) * H + h0 + i] = expf(cs[t]);
      else
        cs[t] = 0.f;
    }
  }

  // warpgroup g: rows 64g + [0, 64) of y; this thread's fragment rows are
  // r0 and r0 + 8, its columns 8·(e/4) + cin + e%2 for accumulator e.  g
  // comes through a shuffle from lane 0 so that the compiler sees it
  // warp-uniform and does not serialize the products under `if` on it
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;
  const int r0 = 64 * g + 16 * ((tid % 128) / 32) + lane / 4;
  const int cin = 2 * (lane % 4);
  const bool pairs_p = P % 2 == 0;
  const bool pairs_n = N % 2 == 0;

  for (int i = 0; i < heads; ++i) {
    const int h = h0 + i;
    const float* cs = cs_all + i * kRows;
    const uint32_t xs = kX + (i & 1) * kTileBytes;
    cp_async_wait_all();
    tc::fence_proxy_async();
    __syncthreads();  // head i's x, B and C (and every cs) are in place
    if (i + 1 < heads) {  // the next head's x, under this head's products
      stage(smem, kX + ((i + 1) & 1) * kTileBytes, xc + (h + 1) * sx.h, sx.q, Q, P,
            vec);
      cp_async_commit();
    }

    // w_s·B[s][n] as a bf16 hi/lo pair, w_s = exp(cs_{Q-1} − cs_s); rows
    // past Q are zero already in B
    const float cs_last = cs[Q - 1];
    for (int idx = tid; idx < kNT * kRows * 8; idx += kThreads) {
      const int r = (idx >> 3) % kRows;
      const uint32_t off = (idx / (kRows * 8)) * kTileBytes + sw128(r, idx & 7);
      const float w = exp_f(cs_last - cs[r]);
      const uint4 bv = *reinterpret_cast<const uint4*>(smem + kB + off);
      const bf16* bb = reinterpret_cast<const bf16*>(&bv);
      uint4 hv, lv;
      bf16* hh = reinterpret_cast<bf16*>(&hv);
      bf16* ll = reinterpret_cast<bf16*>(&lv);
#pragma unroll
      for (int e = 0; e < 8; ++e) split(w * __bfloat162float(bb[e]), hh[e], ll[e]);
      *reinterpret_cast<uint4*>(smem + kWH + off) = hv;
      *reinterpret_cast<uint4*>(smem + kWL + off) = lv;
    }
    tc::fence_proxy_async();
    __syncthreads();

    if (64 * g < Q) {
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      const float cs_t[2] = {cs[r0], cs[r0 + 8]};
      for (int j = 0; j <= g; ++j) {  // 64-column source tiles up to the diagonal
        float s[32];
        tc::fence_regs(s);
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * kNT; ++kk) {  // over N: tile kk / 4, k16 step kk % 4
          const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
          tc::wgmma_ss_m64n64k16<0, 0>(
              s, tc::desc_sw128(sbase + kC + off + 64 * g * 128, 16),
              tc::desc_sw128(sbase + kB + off + 64 * j * 128, 16), kk > 0);
        }
        tc::wg_commit();
        tc::wg_wait_all();
        tc::fence_regs(s);

        // two k16 steps (16 columns each) at a time, to keep the fragments
        // in flight within the register budget of two blocks per SM
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t ahi[2][4], alo[2][4];
#pragma unroll
          for (int e = 16 * half; e < 16 * half + 16; e += 2) {
            const int t = r0 + 8 * ((e / 2) % 2);
            const int s0 = 64 * j + 8 * (e / 4) + cin;
            const float2 css = *reinterpret_cast<const float2*>(cs + s0);
            const float ct = cs_t[(e / 2) % 2];
            const float w0 = s0 <= t ? s[e] * exp_f(ct - css.x) : 0.f;
            const float w1 = s0 + 1 <= t ? s[e + 1] * exp_f(ct - css.y) : 0.f;
            bf16 h0v, l0v, h1v, l1v;
            split(w0, h0v, l0v);
            split(w1, h1v, l1v);
            ahi[(e / 8) % 2][(e % 8) / 2] = pack(h0v, h1v);
            alo[(e / 8) % 2][(e % 8) / 2] = pack(l0v, l1v);
          }
          tc::fence_regs(acc);
          tc::wg_fence();
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int kk = 2 * half + k;
            const uint64_t dx =
                tc::desc_sw128(sbase + xs + (4 * j + kk) * 2048, kTileBytes);
            tc::wgmma_rs_m64n64k16(acc, ahi[k], dx);
            tc::wgmma_rs_m64n64k16(acc, alo[k], dx);
          }
          tc::wg_commit();
          tc::wg_wait_all();
          tc::fence_regs(acc);
        }
      }
      // y (BC, Q, H, P), contiguous
      bf16* yp = y + (static_cast<long long>(ch) * Q * H + h) * P;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int t = r0 + 8 * ((e / 2) % 2);
        const int p = 8 * (e / 4) + cin;
        if (t >= Q || p >= P) continue;
        bf16* dst = yp + static_cast<long long>(t) * H * P + p;
        if (pairs_p) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[e], acc[e + 1]);
        } else {
          dst[0] = __float2bfloat16(acc[e]);
          if (p + 1 < P) dst[1] = __float2bfloat16(acc[e + 1]);
        }
      }
    }

    if (g == 0) {  // state = xᵀ (w·B), over the chunk's rows in k16 steps
      float st[32 * kNT];
      tc::fence_regs(st);
      tc::wg_fence();
      // all 128 rows (zero past Q): a run-time trip count here would make
      // ptxas serialize the products.  N = 128 is one m64n128 product whose
      // second 64-column atom of w·B is the next tile (LBO = kTileBytes)
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        const uint64_t dx = tc::desc_sw128(sbase + xs + kk * 2048, kTileBytes);
        const uint64_t dh = tc::desc_sw128(sbase + kWH + kk * 2048, kTileBytes);
        const uint64_t dl = tc::desc_sw128(sbase + kWL + kk * 2048, kTileBytes);
        if constexpr (kNT == 1) {
          tc::wgmma_ss_m64n64k16<1, 1>(st, dx, dh, kk > 0);
          tc::wgmma_ss_m64n64k16<1, 1>(st, dx, dl, 1);
        } else {
          tc::wgmma_ss_m64n128k16<1, 1>(st, dx, dh, kk > 0);
          tc::wgmma_ss_m64n128k16<1, 1>(st, dx, dl, 1);
        }
      }
      tc::wg_commit();
      tc::wg_wait_all();
      tc::fence_regs(st);
      // state (BC, H, P, N), contiguous: row p = r0 + 8·((e/2)%2), column n
      float* sp = state + (static_cast<long long>(ch) * H + h) * P * N;
#pragma unroll
      for (int e = 0; e < 32 * kNT; e += 2) {
        const int p = r0 + 8 * ((e / 2) % 2);
        const int n = 8 * (e / 4) + cin;
        if (p >= P || n >= N) continue;
        float* dst = sp + p * N + n;
        if (pairs_n) {
          *reinterpret_cast<float2*>(dst) = make_float2(st[e], st[e + 1]);
        } else {
          dst[0] = st[e];
          if (n + 1 < N) dst[1] = st[e + 1];
        }
      }
    }

    if (!shared_bc && i + 1 < heads) {  // per-head B and C: the next head's
      __syncthreads();                  // once this head's products are done
      stage_n<kNT>(smem, kC, cc + (h + 1) * sc.h, sc.q, Q, N, vec);
      stage_n<kNT>(smem, kB, bc + (h + 1) * sb.h, sb.q, Q, N, vec);
      cp_async_commit();
    }
  }
}

using ssd::tile::aligned16;

template <int kNT>
cudaError_t launch(const void* x, const float* dt_a, const void* b, const void* c,
                   void* y, float* state, float* decay, const long long* st, int BC,
                   int Q, int H, int P, int N, int heads, cudaStream_t stream) {
  if (heads < 1 || heads > kMaxHeads || H % heads) return cudaErrorInvalidValue;
  // opt in once per instantiation (the first launch must come outside any
  // CUDA graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_wgmma_kernel<kNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<kNT>::kSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  bool vec = P % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(b) && aligned16(c);
  const int strides_of_x_b_c[] = {0, 1, 2, 6, 7, 8, 9, 10, 11};
  for (int i : strides_of_x_b_c) vec = vec && st[i] % 8 == 0;
  const Strides4 sx{st[0], st[1], st[2]};
  const Strides4 sa{st[3], st[4], st[5]};
  const Strides4 sb{st[6], st[7], st[8]};
  const Strides4 sc{st[9], st[10], st[11]};
  const dim3 grid(H / heads, BC);
  ssd_chunk_wgmma_kernel<kNT><<<grid, kThreads, Layout<kNT>::kSmem, stream>>>(
      static_cast<const bf16*>(x), dt_a, static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<bf16*>(y), state, decay, sx, sa, sb,
      sc, H, Q, P, N, heads, vec);
  return cudaGetLastError();
}

}  // namespace ssd_tc

}  // namespace

// x (BC, Q, H, P), dt_a (BC, Q, H) fp32, b, c (BC, Q, H, N) with unit last
// stride; st: the (chunk, row, head) strides of x, dt_a, b and c in that
// order, in elements (a head stride of 0 broadcasts one group to all
// heads).  y (BC, Q, H, P) in x's dtype, state (BC, H, P, N) and decay
// (BC, Q, H) fp32, all contiguous.  bf16 != 0 for bfloat16 x, b, c (the
// wgmma kernel), else fp32 (the 3xTF32 kernel); either walks `heads`
// consecutive heads of a chunk a block, a divisor of H (at most 8 in
// bf16, 16 in fp32; fp32 takes more than one only where B's and C's head
// strides are 0).
cudaError_t launch_ssd_chunk(const void* x, const float* dt_a, const void* b,
                             const void* c, void* y, float* state,
                             float* decay, const long long* st, int BC, int Q,
                             int H, int P, int N, int bf16, int heads,
                             cudaStream_t stream) {
  if (BC < 1 || BC > 65535 || Q < 1 || Q > kMaxQ || H < 1 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN)
    return cudaErrorInvalidValue;
  if (bf16)
    return N <= 64 ? ssd_tc::launch<1>(x, dt_a, b, c, y, state, decay, st, BC, Q, H, P,
                                       N, heads, stream)
                   : ssd_tc::launch<2>(x, dt_a, b, c, y, state, decay, st, BC, Q, H, P,
                                       N, heads, stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(c);
  auto* yf = static_cast<float*>(y);
  return N <= 64 ? ssd_f32::launch<64>(xf, dt_a, bf, cf, yf, state, decay, st, BC, Q, H, P,
                                       N, heads, stream)
                 : ssd_f32::launch<128>(xf, dt_a, bf, cf, yf, state, decay, st, BC, Q, H,
                                        P, N, heads, stream);
}
