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
// fp32: three kernels, the products on the tensor cores as 3xTF32
// (mma.sync; each fp32 operand split into TF32 hi + lo, a product taken as
// lo·hi + hi·lo + hi·hi, hopper_tc.cuh):
//   (a) flash_bwd_prep_f32_kernel: delta (B, H, Sq) fp32, one warp a row,
//       and the counters zeroed;
//   (b) flash_bwd_tf32_kernel: dK, dV and dQ in one pass over the unit
//       list bwd_schedule builds with 64-key spans (the persistent grid and
//       ticket of the bf16 kernel below): eight warps, each 16 keys of the
//       span and 32 queries of a tile for Sᵀ and dPᵀ, dV and dK summed in
//       registers over the walk, dQ's part (dSᵀ through shared memory) added
//       to its slot of the tile's fp32 sum in list order; five products a
//       pair, S and dP once;
//   (c) flash_bwd_dq_sum_kernel: dQ's slots added in slot order.
// bf16: three kernels, every product on the tensor cores with wgmma:
//   (a) flash_bwd_prep_kernel: delta and lse·log2(e) per query row, in
//       64-row tiles the main kernel loads in one bulk copy, and the
//       counters zeroed;
//   (b) flash_bwd_wgmma_kernel: dK, dV and dQ in one pass.  A persistent
//       grid takes units (batch, KV head, 128-key span, a slice of the
//       span's (query tile, query head) walk) from a ticket, in the order
//       of a list the wrapper builds heaviest first (bwd_schedule in
//       kernels/flash_attention.py).  A producer thread loads K and V of
//       the span once and streams Q, dO and the row stats through a TMA
//       ring; two consumer warpgroups of 64 keys each compute Sᵀ and dPᵀ,
//       then dV and dK in registers, and dQ's part over their own keys
//       from their dSᵀ in shared memory: six products a (64-query, 128-key)
//       pair, S and dP computed once, and neither warpgroup waits on the
//       other's products.  The two dQ parts are summed in shared memory; a
//       writer thread adds the pair's part to its tile's fp32 sum with a
//       TMA store (the first part) or TMA reduce-add (the rest), in the
//       list's order, a counter a tile deciding whose turn it is (a tile's
//       sum may be cut into slots taking its parts in turn, each slot a
//       sum of its own, so its chain of waits is shorter); a span whose
//       walk the list split sums its slices' dK and dV the same way, in
//       fp32 scratch;
//   (c) flash_bwd_dq_round_kernel: dQ's slots added in slot order and
//       rounded to bf16 once.
// No atomic add of a value: repeated calls are bit-identical (the bf16
// kernel's only atomic takes a ticket, its counters order the sums without
// carrying a value, and a TMA reduce-add waits for its turn).  Tiles
// wholly masked (above the causal diagonal, below a window) are never
// loaded, as in the forward; a query row past Sq gets lse = +inf (p = 0)
// and a key past Sk is masked or, in bf16, a zero row of K and V that is
// never stored, so ragged tiles add nothing.
//
// bf16: tiles fed by TMA (128-byte swizzle, zeros past S and D).  The
// roundings are the reference's: S, dP and every sum in fp32; p stays fp32
// for dV (the reference multiplies it by the fp32 upcast of dO), so pᵀ
// enters wgmma as a bf16 hi + lo pair, two products summed in fp32 (~16
// bits of p); dS is rounded to bf16 for dQ and dK, as the reference rounds
// it (ds.astype(q.dtype)), so storing it in bf16 for dQ's product is exact;
// each gradient is rounded to bf16 once.  Scores are exponentiated in log2
// units (exp2 of s·log2(e)/√D − lse·log2(e)).  fp32: S, dP, p, dS and every
// sum in fp32 as the reference takes them; each product's fp32 operands
// enter as TF32 hi + lo and three products (about 22 of fp32's 24 bits of
// each operand, the dropped lo·lo term at most 2^-22 of a product), where
// one TF32 product would keep 11 bits: one TF32 pass is ruled out by the
// fp32 bars, a split that keeps fp32's bits is not.
//
// fp32 design, weighed: wgmma reads a TF32 operand from shared memory only
// K-major (its transpose bits exist for 16-bit types alone), so dV = pᵀ·dO,
// dK = dSᵀ·Q and dQ = dS·K would need dO, Q and K staged a second time
// transposed, and TMA does not transpose; three bf16 terms would read
// MN-major as the bf16 kernel does, but take six products where 3xTF32
// takes three.  mma.sync takes its fragments from registers, loaded from
// shared memory in any layout: pᵀ and dSᵀ go from the Sᵀ/dPᵀ accumulators
// to dV's and dK's A operand without leaving registers (hopper_tc.cuh
// acc_as_a), and dO, Q and K are read row-major with a 4-float row pad
// that makes every fragment load hit 32 banks.  fp32 tiles take twice the
// shared memory of bf16: 64-key spans (not 128) keep K, V, two stages of
// Q/dO and dSᵀ in 122,880 bytes at D <= 64 and 221,184 at D = 128, one block an
// SM; the dQ sums go through the block (it waits for its turn, adds, and
// passes the turn on) rather than a writer thread, in the slots
// bwd_schedule gives a tile (at granite-3-2b's shape 1, 2 and 4 slots ran
// as fast: the waits are not what bounds it).
//
// What bounds it on an H100: five products over the kept (query, key)
// pairs, 10·D operations a pair and head, against each of q, k, v, o, dO,
// lse and the three gradients moved once: at granite-3-2b's (1, 32, 2048,
// 64) causal on 8 KV heads ~43 GFLOP over ~42 MB, far above the ridge, so
// the bound is the tensor cores' 989 TFLOP/s (bf16) or the CUDA cores' 67
// (fp32; 495 as 3xTF32, three products each).  The bf16 kernel runs six
// products (p's hi and lo), and its dQ parts travel through L2 (the fp32
// scratch, 16.8 MB at granite's shape); the fp32 kernel runs fifteen TF32
// products a pair and sends its dQ parts through L2 the same way.

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

// (a), fp32: delta[r] = Σ_d o[r, d]·dO[r, d] in fp32, a warp a row (B·H·Sq
// rows), and `ctr` (the ticket and the order counters) zeroed, in every
// call, so a replayed CUDA graph starts from zero too
__global__ void __launch_bounds__(256)
flash_bwd_prep_f32_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                          float* __restrict__ delta, Str3 so, Str3 sd, int H, int Sq,
                          int D, long long rows, int* __restrict__ ctr, int n_ctr) {
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < n_ctr;
       i += static_cast<long long>(gridDim.x) * 256)
    ctr[i] = 0;
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (r >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(r % Sq);
  const long long bh = r / Sq;
  const long long b = bh / H, h = bh % H;
  const float* op = o + b * so.b + h * so.h + s * so.s;
  const float* dp = dout + b * sd.b + h * sd.h + s * sd.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(op[d], dp[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
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

// ------------------------------------------------------------------ bf16

using namespace tc;

constexpr int kBox = kTile * 128;    // a 64-row, 64-column bf16 box
constexpr int kSpan = 128;           // keys of a unit: 64 for each consumer warpgroup
constexpr int kSpanBox = kSpan * 128;
constexpr int kConsumers = 256;      // two warpgroups
// + the producer warpgroup, of which two threads work (the loads, dQ's
// sums): setmaxnreg moves registers between whole warpgroups, and ptxas
// launches 384 threads at 168 registers, so the producer's 128 x (168 −
// 24) pay for the consumers' 256 x (240 − 168)
constexpr int kMainThreads = kConsumers + 128;
constexpr int kMainRegs = 168;
constexpr int kStatBytes = 2 * kTile * 4;       // a tile's lse·log2(e) and delta
constexpr int kDqBox = kTile * 128;             // 64 rows of 32 fp32 columns

// what fits in shared memory beside K, V and the dS buffer: a ring of 3
// (Q, dO, stats) stages, and 2 dQ buffers at D <= 64, 1 at D = 128
template <int kChunks>
struct Ring {
  static constexpr int kStages = 3;
  static constexpr int kDqBufs = kChunks == 1 ? 2 : 1;
  static constexpr int kStage = 2 * kBox * kChunks + 1024;  // Q, dO, stats
  static constexpr int kDq = 2 * kDqBox * kChunks;          // 64 x 64·kChunks fp32
};

// (a), bf16: delta and lse·log2(e) of each query row into `stats`, tile by
// tile ((B·H·n_qt) tiles of 64 lse then 64 delta, +inf and 0 past Sq), which
// the main kernel loads with one bulk copy a tile; and `ctr` (the ticket
// and the order counters) zeroed, in every call, so a replayed CUDA graph
// starts from zero too
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ stats, Str3 so,
                      Str3 sd, int H, int Sq, int D, int n_qt, long long rows,
                      int* __restrict__ ctr, int n_ctr) {
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < n_ctr;
       i += static_cast<long long>(gridDim.x) * 256)
    ctr[i] = 0;
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (r >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x % 32;
  const int padded = n_qt * kTile;
  const int s = static_cast<int>(r % padded);
  const long long bh = r / padded;
  const long long b = bh / H, h = bh % H;
  float acc = 0.f;
  if (s < Sq) {
    const bf16* op = o + b * so.b + h * so.h + s * so.s;
    const bf16* dp = dout + b * sd.b + h * sd.h + s * sd.s;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(op[d]), to_f32(dp[d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    float* t = stats + (bh * n_qt + s / kTile) * (2 * kTile) + s % kTile;
    t[0] = s < Sq ? lse[bh * Sq + s] * kLog2e : INFINITY;
    t[kTile] = s < Sq ? acc : 0.f;
  }
}

// (c), bf16: dQ's fp32 slots (slots, B·H, n_qt·64, ld) added in slot
// order, those of a query tile with count[qt] parts the first
// min(slots, count[qt]), and rounded once into dq, two columns a thread
__global__ void __launch_bounds__(256)
flash_bwd_dq_round_kernel(const float* __restrict__ acc, const int* __restrict__ count,
                          bf16* __restrict__ dq, Str3 sdq, int H, int Sq, int D, int n_qt,
                          int ld, int slots, long long pairs) {
  const int half = (D + 1) / 2;
  const long long plane = pairs / half / Sq * n_qt * kTile * ld;  // a slot
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < pairs;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int c = 2 * static_cast<int>(i % half);
    const long long row = i / half;
    const int s = static_cast<int>(row % Sq);
    const long long bh = row / Sq;
    const float* a = acc + (bh * n_qt * kTile + s) * ld + c;
    float2 v = *reinterpret_cast<const float2*>(a);
    const int used = min(slots, count[s / kTile]);
    for (int j = 1; j < used; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(a + j * plane);
      v.x += x.x;
      v.y += x.y;
    }
    bf16* dst = dq + (bh / H) * sdq.b + (bh % H) * sdq.h + s * sdq.s + c;
    if (c + 1 < D) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v.x, v.y);
    } else {
      *dst = __float2bfloat16(v.x);
    }
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a 3-D tile from shared memory stored (TMA) or added (TMA reduce) into
// the tensor `map` describes; completion through the bulk async-group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_add_3d(const CUtensorMap* map, uint32_t src, int c0,
                                           int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// orders global memory between the generic proxy (the counters) and the
// async proxy (the TMA store and reduce)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// keeps the register A operands of a wgmma alive (unmoved and unreused)
// until the wait that follows its completion
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4], uint32_t (&b)[4][4],
                                            uint32_t (&c)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("" : "+r"(a[i][j]), "+r"(b[i][j]), "+r"(c[i][j])::"memory");
}

// a barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// The ordered sums.  A (64-row tile, gradient) sum has `count` parts, each
// added in the unit list's order: part `rank` waits until the tile's
// counter reads `rank`, stores (rank 0) or adds its part into the fp32
// scratch, then sets the counter to rank + 1.  Counters order the adds; no
// value is ever added atomically, so every call sums in the same order.
// The warpgroup form (dK and dV of a split span): one thread waits, the
// warpgroup's barrier `bar` passes the turn on.
__device__ __forceinline__ void wait_turn(const int* ctr, int rank, int bar) {
  if (rank == 0) return;
  if (threadIdx.x % 128 == 0)
    while (ld_acquire(ctr) != rank) __nanosleep(32);
  wg_bar(bar);
}

__device__ __forceinline__ void pass_turn(int* ctr, int rank, int count, int bar) {
  if (rank == count - 1) return;  // the last part: nobody waits on it
  __threadfence();
  wg_bar(bar);
  if (threadIdx.x % 128 == 0) st_release(ctr, rank + 1);
}

// one warpgroup's part of a 64-row tile (rows 16·warp + lane/4 + 8·((e/2) %
// 2), columns 8·(e/4) + 2·(lane % 4) + e % 2 of its fragment): `part` is
// added to the running sum in `scratch` (fp32, row stride ld, read and
// written through L2; 64 columns' reads issued before their first write)
// unless it is the first, and the last part writes the sum to `out` in
// bf16 (row stride out_s); rows >= rows and columns >= D are not written
template <int kN>
__device__ __forceinline__ void add_part(const float (&part)[kN], float* scratch, int ld,
                                         bf16* out, long long out_s, int rows, int D,
                                         bool first, bool last) {
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int e0 = 0; e0 < kN; e0 += 32) {
    float2 sum[16];
#pragma unroll
    for (int e = e0; e < e0 + 32; e += 2) {
      const int r = 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
      const int c = 8 * (e / 4) + 2 * (lane % 4);
      sum[(e - e0) / 2] = make_float2(0.f, 0.f);
      if (!first && r < rows && c < D)
        sum[(e - e0) / 2] = __ldcg(reinterpret_cast<const float2*>(scratch + r * ld + c));
    }
#pragma unroll
    for (int e = e0; e < e0 + 32; e += 2) {
      const int r = 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
      const int c = 8 * (e / 4) + 2 * (lane % 4);
      if (r >= rows || c >= D) continue;
      const float x = sum[(e - e0) / 2].x + part[e], y = sum[(e - e0) / 2].y + part[e + 1];
      if (!last) {
        __stcg(reinterpret_cast<float2*>(scratch + r * ld + c), make_float2(x, y));
      } else {
        bf16* dst = out + r * out_s + c;
        if (c + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
        } else {
          *dst = __float2bfloat16(x);
        }
      }
    }
  }
}

// d (64 x 64, fp32) = A·Bᵀ over D: A and B tiles K-major in shared memory,
// kChunks boxes of 64 columns a_chunk and b_chunk bytes apart, one k16 step
// 32 bytes inside a box; the first step writes d without reading it
template <int kChunks>
__device__ __forceinline__ void mma_scores(float (&d)[32], uint32_t a, uint32_t a_chunk,
                                           uint32_t b, uint32_t b_chunk) {
  wgmma_ss_m64n64k16_first<0, 0>(d, desc_sw128(a, 16), desc_sw128(b, 16));
#pragma unroll
  for (int kk = 1; kk < 4 * kChunks; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_m64n64k16<0, 0>(d, desc_sw128(a + (kk / 4) * a_chunk + off, 16),
                             desc_sw128(b + (kk / 4) * b_chunk + off, 16), 1);
  }
}

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

// a warpgroup's dQ part, 64 queries x 64·kChunks columns, = dS_w·K_w over
// its 64 keys: its rows of the stored dSᵀ (a key a 128-byte row) the
// MN-major A, its rows of K the MN-major B (64-column boxes kSpanBox
// apart); each k16 step is 16 keys (2048 bytes) of both, the first
// writing d without reading it
template <int kChunks>
__device__ __forceinline__ void mma_dq(float (&d)[32 * kChunks], uint32_t ds, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a = desc_sw128(ds + kk * 2048, kSpanBox);
    const uint64_t b = desc_sw128(k + kk * 2048, kSpanBox);
    if constexpr (kChunks == 1) {
      if (kk == 0)
        wgmma_ss_m64n64k16_first<1, 1>(d, a, b);
      else
        wgmma_ss_m64n64k16<1, 1>(d, a, b, 1);
    } else {
      if (kk == 0)
        wgmma_ss_m64n128k16_first<1, 1>(d, a, b);
      else
        wgmma_ss_m64n128k16<1, 1>(d, a, b, 1);
    }
  }
}

// 2^x for the probabilities: MUFU.EX2 alone (flushing a result below
// 2^-126 to 0, which no sum here can see)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// pᵀ = exp2(Sᵀ·scale·log2 e − lse·log2 e) into s and dSᵀ = pᵀ(dPᵀ − delta)·
// scale into dp, in place, element e at key row key0 + 8·((e/2) % 2) and
// query column q0 + 8·(e/4) + col_in + e % 2; kMask: the pair crosses the
// diagonal or the window's edge, so each element is checked (a separate
// instantiation, so unmasked pairs compute no masks)
template <bool kMask>
__device__ __forceinline__ void probs(float (&s)[32], float (&dp)[32], const float* lse2,
                                      const float* dl, float scale_log2, float scale,
                                      int col_in, int key0, int q0, int causal, int window) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int c = 8 * (e / 4) + col_in + (e % 2);
    float p = exp2_ftz(s[e] * scale_log2 - lse2[c]);
    if constexpr (kMask) {
      const int key = key0 + 8 * ((e / 2) % 2), row = q0 + c;
      if ((causal && key > row) || (window > 0 && key <= row - window)) p = 0.f;
    }
    dp[e] = p * (dp[e] - dl[c]) * scale;
    s[e] = p;
  }
}

// Sᵀ = K_w·Qᵀ and dPᵀ = V_w·dOᵀ of one pair once its stage (Q at s_q, dO
// after it) is loaded; the caller commits the group.  No register fence
// here: the products may be issued while others run, and ptxas serializes
// every wgmma where an instruction between an issue and its wait touches
// an accumulator of one (the asm's "+f" operands order s and dp already)
template <int kChunks>
__device__ __forceinline__ void issue_scores(float (&s)[32], float (&dp)[32], uint32_t full,
                                             uint32_t parity, uint32_t kw, uint32_t vw,
                                             uint32_t s_q) {
  mbar_wait(full, parity);
  wg_fence();
  mma_scores<kChunks>(s, kw, kSpanBox, s_q, kBox);
  mma_scores<kChunks>(dp, vw, kSpanBox, s_q + kBox * kChunks, kBox);
}

// where the elements of a thread's 64 x 64·kChunks dQ fragment lie in a
// dQ buffer: element e is row r = 16·warp + lane/4 + 8·((e/2) % 2), column
// c = 8·(e/4) + 2·(lane % 4) + e % 2, stored in 32-column box c / 32 = e /
// 16 at 16-byte chunk (c % 32 / 4) ^ (r % 8), the 128-byte swizzle the
// writer's TMA expects.  r % 8 is lane / 4, and the chunk takes four
// values a thread, one for each (e / 4) % 4: four addresses, the rest an
// immediate offset
struct PartAddr {
  uint32_t a[4];
  __device__ __forceinline__ explicit PartAddr(uint32_t buf) {
    const int lane = threadIdx.x % 32;
    const int x = lane / 4, b1 = (lane / 2) % 2;
    const uint32_t row = buf + (16 * ((threadIdx.x % 128) / 32) + x) * 128 + 8 * (lane % 2);
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = row + (((2 * k + b1) ^ x) << 4);
  }
  __device__ __forceinline__ uint32_t at(int e) const {
    return a[(e / 4) % 4] + (e / 16) * kDqBox + ((e / 2) % 2) * 1024;
  }
};

__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// The plan (int32, built by kernels/flash_attention.py bwd_schedule): the
// pattern of one (batch, KV head), n_pat units in list order, 4 ints each:
// the key span n (keys [128n, 128n + 128)), the walked query tiles
// [qt_lo, qt_hi), and its dK/dV part's rank | count << 16; then rank[qt ·
// n_sp + n], the place of span n's part among query tile qt's dQ parts
// (-1: none); then count[qt].  Unit t of the list is pattern unit t / BKV
// of (batch·KV head) t % BKV, so every (batch, KV head) repeats the
// pattern's order.  Part r of a dQ tile goes into slot r % slots, where it
// is part r / slots of that slot's ordered sum.
struct Plan {
  const int* p;
  int n_pat, n_qt, n_sp, slots;
  __device__ int span(int u) const { return p[4 * u]; }
  __device__ int qt_lo(int u) const { return p[4 * u + 1]; }
  __device__ int qt_hi(int u) const { return p[4 * u + 2]; }
  __device__ int dkv(int u) const { return p[4 * u + 3]; }
  __device__ int dq_rank(int qt, int n) const { return p[4 * n_pat + qt * n_sp + n]; }
  __device__ int dq_count(int qt) const { return p[4 * n_pat + n_qt * n_sp + qt]; }
};

// dQ's part of pair j into its buffer (dst), use `round` of the buffer:
// warpgroup 0 stores its part once the writer is done with the buffer's
// last contents (`reused`); warpgroup 1 adds its own to it, element by
// element (part 0 + part 1), and hands the pair's part (tile, rank; rank
// -1 ends the writer) to the writer
template <int kN>
__device__ __forceinline__ void post_part(const float (&acc)[kN], int round, bool reused,
                                          int tile, int rank, int w, uint32_t dst,
                                          uint32_t half, uint32_t full, uint32_t empty,
                                          int (&job)[2]) {
  const PartAddr at(dst);
  if (w == 0) {
    if (reused) mbar_wait(empty, (round - 1) & 1);
    if (rank >= 0) {
#pragma unroll
      for (int e = 0; e < kN; e += 2) st_shared2(at.at(e), acc[e], acc[e + 1]);
    }
    mbar_arrive(half);
  } else {
    mbar_wait(half, round & 1);
    if (rank >= 0) {
#pragma unroll
      for (int e = 0; e < kN; e += 2) {
        const float2 p0 = ld_shared2(at.at(e));
        st_shared2(at.at(e), p0.x + acc[e], p0.y + acc[e + 1]);
      }
    }
    if (threadIdx.x == 128) {
      job[0] = tile;
      job[1] = rank;
    }
    fence_proxy_async();
    mbar_arrive(full);
  }
}

// (b), bf16: the one fused kernel for dK, dV and dQ.  A persistent grid
// (one block an SM) takes units from a ticket in list order.  A unit owns
// one (batch, KV head, 128-key span) and a slice of its walk: the query
// tiles [qt_lo, qt_hi), highest first, and for each the G query heads of
// the group.  One producer thread loads K and V of the span once (TMA) and
// streams each walked pair's Q, dO and row stats through the ring;
// consumer warpgroup w owns keys 64w..64w + 63 of the span and, for each
// pair,
//   Sᵀ = K_w·Qᵀ, dPᵀ = V_w·dOᵀ          (2 products over D)
//   pᵀ = exp2(Sᵀ·scale·log2 e − lse·log2 e), dSᵀ = pᵀ(dPᵀ − delta)·scale
//   dV += pᵀ(hi + lo)·dO, dK += dSᵀ·Q  (3 products over the 64 queries)
//   dQ_w = dS_w·K_w                    (1 product over its 64 keys, dSᵀ
//                                       through shared memory)
// so six products a (64-query, 128-key) pair, S and dP once, and the two
// warpgroups never wait on each other's products.  Warpgroup 0 puts its
// dQ part in a dQ buffer (fp32, 128-byte swizzled boxes of 32 columns);
// warpgroup 1 adds its own to it there (part 0 + part 1, element by
// element); a second producer thread, the writer, adds the pair's part to
// query tile (head, qt)'s fp32 sum in the list's order with one TMA store
// (the first part) or TMA reduce-add (the rest), so no consumer waits on
// another unit.  At the end of its walk a warpgroup writes its dK and dV
// in bf16 or, where the plan split the span's walk, adds them to the
// span's fp32 sum in list order (add_part); a third kernel rounds dQ.
template <int kChunks>
__global__ void __launch_bounds__(kMainThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdq,
                       const float* __restrict__ stats, Plan plan, int BKV,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, Str3 sdk, Str3 sdv,
                       float* __restrict__ dkv_acc, int* __restrict__ ctr, int H, int G,
                       int Sk, int causal, int window, int D, float scale,
                       float scale_log2) {
  using R = Ring<kChunks>;
  constexpr int kQ = kBox * kChunks;        // a Q or dO tile (64 rows)
  constexpr int kKV = kSpanBox * kChunks;   // a K or V span (128 rows)
  constexpr int kAcc = 32 * kChunks;
  constexpr int kLd = 64 * kChunks;         // the fp32 scratch's row stride
  extern __shared__ uint8_t smem_raw[];
  __shared__ int sched;                     // the unit the producer took
  __shared__ int jobs[R::kDqBufs][2];       // each dQ buffer's tile and rank
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* gen = smem_raw + (base - smem_u32(smem_raw));  // base, generic
  const uint32_t k_s = base;
  const uint32_t v_s = base + kKV;
  const uint32_t ds_s = base + 2 * kKV;     // dSᵀ, a key a 128-byte row
  auto stage = [&](int st) { return ds_s + kSpanBox + st * R::kStage; };
  auto dq_s = [&](int j) { return stage(R::kStages) + j * R::kDq; };
  const uint32_t bars = dq_s(R::kDqBufs);
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int st) { return bars + 16 + 8 * st; };
  auto empty = [&](int st) { return bars + 16 + 8 * (R::kStages + st); };
  // a dQ buffer: its part 0 stored (dq_half), the pair's part stored
  // (dq_full), the writer done with it (dq_empty)
  auto dq_half = [&](int j) { return bars + 16 + 8 * (2 * R::kStages + j); };
  auto dq_full = [&](int j) { return bars + 16 + 8 * (2 * R::kStages + R::kDqBufs + j); };
  auto dq_empty = [&](int j) {
    return bars + 16 + 8 * (2 * R::kStages + 2 * R::kDqBufs + j);
  };

  const int KV = H / G;
  const int n_units = plan.n_pat * BKV;
  const int n_qt = plan.n_qt, n_sp = plan.n_sp;
  int* const ticket = ctr;
  int* const dq_ctr = ctr + 1;  // a counter a (tile, slot)
  int* const dkv_ctr = dq_ctr + static_cast<long long>(BKV) * G * n_qt * plan.slots;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers);
    for (int st = 0; st < R::kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    for (int j = 0; j < R::kDqBufs; ++j) {
      mbar_init(dq_half(j), 128);
      mbar_init(dq_full(j), 128);
      mbar_init(dq_empty(j), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      // the loads: units from the ticket, K and V, then the ring
      int i = 0;  // pairs issued over all units
      for (int it = 0;; ++it) {
        const int t = atomicAdd(ticket, 1);
        // the consumers are done with the last unit's K, V and sched
        if (it > 0) mbar_wait(kv_empty, (it - 1) & 1);
        sched = t;
        if (t >= n_units) {
          mbar_arrive(kv_full);
          break;
        }
        const int u = t / BKV, bh = t % BKV;
        const int b = bh / KV, hk = bh % KV;
        const int n = plan.span(u);
        mbar_expect_tx(kv_full, 2 * kKV);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(k_s + c * kSpanBox, &tk, kv_full, 64 * c, n * kSpan, hk, b);
          tma_load_4d(v_s + c * kSpanBox, &tv, kv_full, 64 * c, n * kSpan, hk, b);
        }
        for (int qt = plan.qt_hi(u) - 1; qt >= plan.qt_lo(u); --qt) {
          for (int g = 0; g < G; ++g, ++i) {
            const int st = i % R::kStages;
            if (i >= R::kStages) mbar_wait(empty(st), ((i / R::kStages) - 1) & 1);
            const int h = hk * G + g;
            const uint32_t s = stage(st);
            mbar_expect_tx(full(st), 2 * kQ + kStatBytes);
            for (int c = 0; c < kChunks; ++c) {
              tma_load_4d(s + c * kBox, &tq, full(st), 64 * c, qt * kTile, h, b);
              tma_load_4d(s + kQ + c * kBox, &tdo, full(st), 64 * c, qt * kTile, h, b);
            }
            bulk_load(s + 2 * kQ,
                      stats + (static_cast<long long>(b * H + h) * n_qt + qt) * (2 * kTile),
                      kStatBytes, full(st));
          }
        }
      }
    } else if (tid == kConsumers + 32) {
      // the writer: each pair's dQ part into its slot of its tile's fp32
      // sum, in the list's order; a tile (batch·head·n_qt + qt) of rank -1
      // ends
      for (int j = 0;; ++j) {
        const int buf = j % R::kDqBufs;
        mbar_wait(dq_full(buf), (j / R::kDqBufs) & 1);
        const int tile = jobs[buf][0], rank = jobs[buf][1];
        if (rank < 0) break;
        const int bh = tile / n_qt, qt = tile % n_qt;
        const int slot = rank % plan.slots, turn = rank / plan.slots;
        int* const c = dq_ctr + static_cast<long long>(tile) * plan.slots + slot;
        if (turn > 0)
          while (ld_acquire(c) != turn) __nanosleep(32);
        fence_proxy_async_global();
        const int plane = slot * BKV * G + bh;
        for (int x = 0; x < 2 * kChunks; ++x) {
          if (turn == 0)
            tma_store_3d(&tdq, dq_s(buf) + x * kDqBox, 32 * x, qt * kTile, plane);
          else
            tma_add_3d(&tdq, dq_s(buf) + x * kDqBox, 32 * x, qt * kTile, plane);
        }
        bulk_commit_wait();
        fence_proxy_async_global();
        // the slot's last part passes its turn to nobody; the counters
        // restart at 0 in the next call's first kernel
        if (rank + plan.slots < plan.dq_count(qt)) st_release(c, turn + 1);
        mbar_arrive(dq_empty(buf));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // warpgroup-uniform to the compiler: a branch on it around a wgmma
    // must not make ptxas serialize the products
    const int w = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int col_in = 2 * (lane % 4);
    const int bar = 1 + w;
    float acc[kAcc];  // this warpgroup's dQ part
    int i = 0;  // pairs consumed over all units
    for (int it = 0;; ++it) {
      mbar_wait(kv_full, it & 1);
      const int t = sched;
      if (t >= n_units) break;
      const int u = t / BKV, bh = t % BKV;
      const int b = bh / KV, hk = bh % KV;
      const int n = plan.span(u);
      const int qt_lo = plan.qt_lo(u), qt_hi = plan.qt_hi(u);
      const int k0 = n * kSpan + 64 * w;             // this warpgroup's first key
      const int key0 = k0 + 16 * warp + lane / 4;     // and key0 + 8
      const uint32_t kw_s = k_s + 64 * w * 128, vw_s = v_s + 64 * w * 128;
      const uint32_t dsw_s = ds_s + 64 * w * 128;     // this warpgroup's dSᵀ rows

      float adv[kAcc], adk[kAcc];
#pragma unroll
      for (int e = 0; e < kAcc; ++e) adv[e] = adk[e] = 0.f;
      // Each pair issues and awaits its own products: the scores, then
      // dK/dV's and dQ's (ptxas serializes the products of a wgmma
      // pipeline that crosses the loop's back edge, and D = 128 has no
      // registers for the next pair's scores beside dK/dV's operands)
      for (int qt = qt_hi - 1; qt >= qt_lo; --qt) {
        const int q0 = qt * kTile;
        const int rank = plan.dq_rank(qt, n);
        // a pair is masked where the tile crosses the diagonal or reaches
        // below the window
        const bool masked = (causal && q0 < k0 + kTile - 1) ||
                            (window > 0 && q0 + kTile - 1 >= k0 + window);
        for (int g = 0; g < G; ++g, ++i) {
          const int st = i % R::kStages;
          const uint32_t s_q = stage(st), s_do = s_q + kQ;
          const float* lse2 = reinterpret_cast<const float*>(gen + (s_q + 2 * kQ - base));
          const float* dl = lse2 + kTile;

          float s[32], dp[32];
          issue_scores<kChunks>(s, dp, full(st), (i / R::kStages) & 1, kw_s, vw_s, s_q);
          wg_commit();
          wg_wait_all();
          fence_regs(s);
          fence_regs(dp);

          if (masked)
            probs<true>(s, dp, lse2, dl, scale_log2, scale, col_in, key0, q0, causal, window);
          else
            probs<false>(s, dp, lse2, dl, scale_log2, scale, col_in, key0, q0, causal, window);
          // the A fragments: pᵀ as bf16 hi + lo, dSᵀ rounded
          uint32_t ph[4][4], pl[4][4], ds[4][4];
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            ds[e / 8][(e % 8) / 2] = pack_bf16(dp[e], dp[e + 1]);
            split_pack(make_float2(s[e], s[e + 1]), ph[e / 8][(e % 8) / 2],
                       pl[e / 8][(e % 8) / 2]);
          }

          // dSᵀ into this warpgroup's rows of the dS buffer, 128-byte
          // swizzled: key row r, the 16-byte chunk of queries 8·(e/4).. at
          // chunk (e/4) ^ (r % 8).  Only this warpgroup's dQ product reads
          // them, and the pair before's was awaited
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const int r = 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
            st_shared(dsw_s + r * 128 + (((e / 4) ^ (r % 8)) << 4) + 4 * (lane % 4),
                      ds[e / 8][(e % 8) / 2]);
          }
          fence_proxy_async();
          wg_bar(bar);

          // dV += (pᵀ hi + pᵀ lo)·dO, dK += dSᵀ·Q over the 64 queries in k16
          // steps of 16 rows (2048 bytes)
          fence_regs(adv);
          fence_regs(adk);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma_rs<kChunks>(adv, ph[kk], s_do + kk * 2048);
            mma_rs<kChunks>(adv, pl[kk], s_do + kk * 2048);
            mma_rs<kChunks>(adk, ds[kk], s_q + kk * 2048);
          }
          if constexpr (kChunks == 1) {
            // D <= 64: dQ's product in the same batch (its dS is stored)
            mma_dq<kChunks>(acc, dsw_s, kw_s);
            wg_commit();
            wg_wait_all();
            fence_regs(adv);
            fence_regs(adk);
            fence_frags(ph, pl, ds);
            mbar_arrive(empty(st));
          } else {
            // D = 128: no registers for dQ's part beside dK/dV's operands
            wg_commit();
            wg_wait_all();
            fence_regs(adv);
            fence_regs(adk);
            fence_frags(ph, pl, ds);
            mbar_arrive(empty(st));
            wg_fence();
            mma_dq<kChunks>(acc, dsw_s, kw_s);
            wg_commit();
            wg_wait_all();
          }
          fence_regs(acc);
          const int buf = i % R::kDqBufs;
          post_part<kAcc>(acc, i / R::kDqBufs, i >= R::kDqBufs,
                          (b * H + hk * G + g) * n_qt + qt, rank, w, dq_s(buf),
                          dq_half(buf), dq_full(buf), dq_empty(buf), jobs[buf]);
        }
      }
      mbar_arrive(kv_empty);  // every product reading K or V is done

      // dK and dV of this warpgroup's 64 keys: written at once, or this
      // slice's part of the span's ordered sum
      const int rank = plan.dkv(u) & 0xffff, count = plan.dkv(u) >> 16;
      int* const c = dkv_ctr + (static_cast<long long>(bh) * n_sp + n) * 2 + w;
      const long long row = static_cast<long long>(bh) * Sk + k0;
      const long long half = static_cast<long long>(BKV) * Sk * kLd;
      wait_turn(c, rank, bar);
      add_part<kAcc>(adk, dkv_acc + row * kLd, kLd, dk + b * sdk.b + hk * sdk.h + k0 * sdk.s,
                     sdk.s, Sk - k0, D, rank == 0, rank == count - 1);
      add_part<kAcc>(adv, dkv_acc + half + row * kLd, kLd,
                     dv + b * sdv.b + hk * sdv.h + k0 * sdv.s, sdv.s, Sk - k0, D, rank == 0,
                     rank == count - 1);
      pass_turn(c, rank, count, bar);
    }
    // the writer's last job: the end
    const int buf = i % R::kDqBufs;
    post_part<kAcc>(acc, i / R::kDqBufs, i >= R::kDqBufs, 0, -1, w, dq_s(buf), dq_half(buf),
                    dq_full(buf), dq_empty(buf), jobs[buf]);
  }
}

// ------------------------------------------------------------------ fp32
//
// (b), fp32: the fused kernel for dK, dV and dQ on the tensor cores, every
// product as 3xTF32 (hopper_tc.cuh).  A persistent grid takes units from a
// ticket in the order of the list bwd_schedule builds with 64-key spans;
// a unit owns one (batch, KV head, 64-key span) and a slice of its walk.
// Warp w (8 a block) owns keys 16·(w % 4).. of the span and queries
// 32·(w / 4).. of each walked 64-row tile, and for each pair
//   Sᵀ = K_w·Q_wᵀ, dPᵀ = V_w·dO_wᵀ      (16 x 32, over D)
//   pᵀ = exp(Sᵀ·scale − lse), dSᵀ = pᵀ(dPᵀ − delta)·scale
//   dV_w += pᵀ·dO_w, dK_w += dSᵀ·Q_w    (16 x D, over its 32 queries; pᵀ
//                                       and dSᵀ as register A operands)
// then, dSᵀ through shared memory, warp w takes queries 16·(w % 4).. and
// half of D of dQ's part dS·K over the span's 64 keys.  Five products a
// pair, S and dP once.  The block adds the pair's dQ part to its slot of
// the tile's fp32 sum in the list's order (a counter a (tile, slot), the
// first part stored); at the end of the walk warps 4-7 hand their dK/dV
// halves to warps 0-3 through shared memory, which add them (half 0 +
// half 1) and write dK and dV, or add them to the span's sum in dk and dv
// in list order where the plan split the span's walk.  Q, dO and the row
// stats of the next pair are in flight (cp.async, two buffers) during a
// pair's products.
namespace f32 {

constexpr int kSpan = 64;              // keys of a unit
constexpr int kThreads = 256;          // 8 warps
constexpr int kDsPitch = kTile + 4;    // a dSᵀ row: one key, 64 queries

// shared memory in floats: K and V of the span, two stages of (Q, dO, lse,
// delta), dSᵀ; rows of kDPad + 4 floats (a warp's fragment loads then hit
// 32 distinct banks)
template <int kDPad>
struct Layout {
  static constexpr int kPitch = kDPad + 4;
  static constexpr int kTileF = kTile * kPitch;
  static constexpr int kStage = 2 * kTileF + 2 * kTile;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileF;
  static constexpr int kStages = kV + kTileF;
  static constexpr int kDS = kStages + 2 * kStage;
  static constexpr int kBytes = 4 * (kDS + kSpan * kDsPitch);
};

// The ordered sums of the fp32 kernel, the whole block taking part: part
// `turn` of a sum waits until its counter reads `turn`, then stores (turn
// 0) or adds its part, then sets the counter to turn + 1.  No value is
// added atomically, so every call sums in the same order.
__device__ __forceinline__ void block_wait_turn(const int* ctr, int turn) {
  if (turn > 0 && threadIdx.x == 0)
    while (ld_acquire(ctr) != turn) __nanosleep(32);
  __syncthreads();
}

__device__ __forceinline__ void block_pass_turn(int* ctr, int turn) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(ctr, turn + 1);
}

// v at p, or added to what p holds (read through L2)
__device__ __forceinline__ void put2(float* p, float x, float y, bool first) {
  if (!first) {
    const float2 o = __ldcg(reinterpret_cast<const float2*>(p));
    x += o.x;
    y += o.y;
  }
  __stcg(reinterpret_cast<float2*>(p), make_float2(x, y));
}

__device__ __forceinline__ void put1(float* p, float x, bool first) {
  __stcg(p, first ? x : x + __ldcg(p));
}

template <int kDPad>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      Plan plan, int BKV, float* __restrict__ dq_acc,
                      float* __restrict__ dk, float* __restrict__ dv, int* __restrict__ ctr,
                      Str3 sq, Str3 sk, Str3 sv, Str3 sdo, Str3 sdk, Str3 sdv, int H, int G,
                      int Sq, int Sk, int D, int causal, int window, float scale, bool vec) {
  using L = Layout<kDPad>;
  constexpr int kPitch = L::kPitch;
  constexpr int kN = kDPad / 8;        // n8 tiles of a dK/dV row
  constexpr int kNq = kDPad / 16;      // n8 tiles of a warp's half of a dQ row
  constexpr int kJ = kDPad == 128 ? 1 : 4;
  constexpr int kNqs = kDPad == 128 ? kNq / 2 : kNq;  // dQ's n8 tiles a pass
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const uint32_t sm_s = smem_u32(sm);
  __shared__ int sched;

  const int KV = H / G;
  const int n_units = plan.n_pat * BKV;
  const int n_qt = plan.n_qt, n_sp = plan.n_sp;
  int* const ticket = ctr;
  int* const dq_ctr = ctr + 1;  // a counter a (tile, slot)
  int* const dkv_ctr = dq_ctr + static_cast<long long>(BKV) * G * n_qt * plan.slots;
  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int kb = w % 4, qh = w / 4;    // keys 16·kb.., queries 32·qh.. of a pair
  const float* const Ks = sm + L::kK;
  const float* const Vs = sm + L::kV;
  float* const Ds = sm + L::kDS;
  const long long plane = static_cast<long long>(BKV) * G * n_qt * kTile * kDPad;

  for (;;) {
    if (tid == 0) sched = atomicAdd(ticket, 1);
    __syncthreads();
    const int t = sched;
    if (t >= n_units) break;
    const int u = t / BKV, bkv = t % BKV;
    const int b = bkv / KV, hk = bkv % KV;
    const int n = plan.span(u);
    const int k0 = n * kSpan;
    const int qt_lo = plan.qt_lo(u), qt_hi = plan.qt_hi(u);
    const int pairs = (qt_hi - qt_lo) * G;

    // the stage of pair i: query tile qt_hi − 1 − i / G, head hk·G + i % G
    auto load_pair = [&](int i) {
      const int qt = qt_hi - 1 - i / G, h = hk * G + i % G;
      const uint32_t st = sm_s + 4 * (L::kStages + (i % 2) * L::kStage);
      const int q0 = qt * kTile;
      tc::load_f32_tile<kTile, kDPad, kThreads>(st, kPitch, q + b * sq.b + h * sq.h + q0 * sq.s,
                                                sq.s, Sq - q0, D, vec);
      tc::load_f32_tile<kTile, kDPad, kThreads>(
          st + 4 * L::kTileF, kPitch, dout + b * sdo.b + h * sdo.h + q0 * sdo.s, sdo.s,
          Sq - q0, D, vec);
      if (tid < 2 * kTile) {
        const int r = q0 + tid % kTile;
        const float* src = (tid < kTile ? lse : delta) + (static_cast<long long>(b) * H + h) * Sq;
        tc::cp_async4(st + 4 * (2 * L::kTileF + tid), r < Sq ? src + r : src, r < Sq);
      }
    };
    tc::load_f32_tile<kTile, kDPad, kThreads>(sm_s + 4 * L::kK, kPitch,
                                              k + b * sk.b + hk * sk.h + k0 * sk.s, sk.s,
                                              Sk - k0, D, vec);
    tc::load_f32_tile<kTile, kDPad, kThreads>(sm_s + 4 * L::kV, kPitch,
                                              v + b * sv.b + hk * sv.h + k0 * sv.s, sv.s,
                                              Sk - k0, D, vec);
    load_pair(0);
    tc::cp_commit();

    float dka[kN][4], dva[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

    for (int i = 0; i < pairs; ++i) {
      if (i + 1 < pairs) {
        load_pair(i + 1);
        tc::cp_commit();
        tc::cp_wait<1>();
      } else {
        tc::cp_wait<0>();
      }
      __syncthreads();  // pair i's stage is in; the last pair's dSᵀ is consumed
      const int qt = qt_hi - 1 - i / G, h = hk * G + i % G;
      const int q0 = qt * kTile;
      const float* const Qs = sm + L::kStages + (i % 2) * L::kStage;
      const float* const Os = Qs + L::kTileF;
      const float* const Ls = Os + L::kTileF;
      const float* const Dl = Ls + kTile;

      // whether the pair crosses the diagonal or the window's edge, or
      // holds a row past Sq or a key past Sk: only then is each element's
      // mask read
      const bool masked = (causal && q0 < k0 + kSpan - 1) ||
                          (window > 0 && q0 + kTile - 1 >= k0 + window) ||
                          q0 + kTile > Sq || k0 + kSpan > Sk;
      // kJ of the warp's four 8-query tiles at a time: Sᵀ and dPᵀ (keys
      // 16·kb + g8 (+8), queries 32·qh + 8j + 2·t4 (+1)) over D, pᵀ and
      // dSᵀ, then dV and dK over those queries (D = 128 takes one at a
      // time: beside dK's and dV's 128 registers, four spill)
#pragma unroll
      for (int j0 = 0; j0 < 4; j0 += kJ) {
        float s[kJ][4], dp[kJ][4];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kDPad / 8; ++kk) {
          tc::Tf32Frag<4> ka, va;
          const float* kr = Ks + (16 * kb + g8) * kPitch + 8 * kk + t4;
          const float* vr = Vs + (16 * kb + g8) * kPitch + 8 * kk + t4;
          ka.set(0, kr[0]);
          ka.set(1, kr[8 * kPitch]);
          ka.set(2, kr[4]);
          ka.set(3, kr[8 * kPitch + 4]);
          va.set(0, vr[0]);
          va.set(1, vr[8 * kPitch]);
          va.set(2, vr[4]);
          va.set(3, vr[8 * kPitch + 4]);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int row = (32 * qh + 8 * (j0 + j) + g8) * kPitch + 8 * kk + t4;
            tc::Tf32Frag<2> qf, of;
            qf.set(0, Qs[row]);
            qf.set(1, Qs[row + 4]);
            of.set(0, Os[row]);
            of.set(1, Os[row + 4]);
            tc::mma_3xtf32(s[j], ka, qf);
            tc::mma_3xtf32(dp[j], va, of);
          }
        }
        // pᵀ into s, dSᵀ into dp and the dSᵀ buffer
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 16 * kb + g8 + 8 * (e / 2);
            const int c = 32 * qh + 8 * (j0 + j) + 2 * t4 + e % 2;
            const float p = !masked || kept(q0 + c, k0 + key, Sq, Sk, causal, window)
                                ? expf(s[j][e] * scale - Ls[c])
                                : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - Dl[c]) * scale;
          }
#pragma unroll
          for (int e = 0; e < 4; e += 2)
            *reinterpret_cast<float2*>(
                &Ds[(16 * kb + g8 + 4 * e) * kDsPitch + 32 * qh + 8 * (j0 + j) + 2 * t4]) =
                make_float2(dp[j][e], dp[j][e + 1]);
        }
        // dV += pᵀ·dO and dK += dSᵀ·Q over these 8·kJ queries, 8 a step
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          tc::Tf32Frag<4> pa, da;
          tc::acc_as_a(pa, s[j]);
          tc::acc_as_a(da, dp[j]);
          const int row = (32 * qh + 8 * (j0 + j) + 2 * t4) * kPitch + g8;
#pragma unroll
          for (int c = 0; c < kN; ++c) {
            tc::Tf32Frag<2> of, qf;
            of.set(0, Os[row + 8 * c]);
            of.set(1, Os[row + kPitch + 8 * c]);
            qf.set(0, Qs[row + 8 * c]);
            qf.set(1, Qs[row + kPitch + 8 * c]);
            tc::mma_3xtf32(dva[c], pa, of);
            tc::mma_3xtf32(dka[c], da, qf);
            // D = 128: no loads hoisted past the step (beside dK's and
            // dV's 128 registers they spill)
          }
        }
      }
      __syncthreads();  // dSᵀ is whole

      // dQ's part: queries 16·kb + g8 (+8), columns (kDPad / 2)·qh + 8c +
      // 2·t4 (+1), over the span's 64 keys
      const int rank = plan.dq_rank(qt, n);
      const int slot = rank % plan.slots, turn = rank / plan.slots;
      const long long tile = (static_cast<long long>(b) * H + h) * n_qt + qt;
      int* const cnt = dq_ctr + tile * plan.slots + slot;
      float* const part = dq_acc + slot * plane + tile * kTile * kDPad;
      // (D = 128 in two passes of 32 columns: its dK and dV hold 128
      // registers; the part goes out once the turn has come, pass by pass)
      if (kNqs < kNq) block_wait_turn(cnt, turn);
#pragma unroll
      for (int c0 = 0; c0 < kNq; c0 += kNqs) {
        float dqa[kNqs][4];
#pragma unroll
        for (int c = 0; c < kNqs; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[c][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kSpan / 8; ++kk) {
          tc::Tf32Frag<4> a;
          const float* d0 = Ds + (8 * kk + 2 * t4) * kDsPitch + 16 * kb + g8;
          a.set(0, d0[0]);
          a.set(1, d0[8]);
          a.set(2, d0[kDsPitch]);
          a.set(3, d0[kDsPitch + 8]);
          const float* kr =
              Ks + (8 * kk + 2 * t4) * kPitch + (kDPad / 2) * qh + 8 * c0 + g8;
#pragma unroll
          for (int c = 0; c < kNqs; ++c) {
            tc::Tf32Frag<2> bf;
            bf.set(0, kr[8 * c]);
            bf.set(1, kr[kPitch + 8 * c]);
            tc::mma_3xtf32(dqa[c], a, bf);
          }
        }
        if (kNqs == kNq) block_wait_turn(cnt, turn);
#pragma unroll
        for (int c = 0; c < kNqs; ++c)
#pragma unroll
          for (int e = 0; e < 4; e += 2)
            put2(part + (16 * kb + g8 + 4 * e) * kDPad + (kDPad / 2) * qh + 8 * (c0 + c) +
                     2 * t4,
                 dqa[c][e], dqa[c][e + 1], turn == 0);
      }
      block_pass_turn(cnt, turn);
    }

    // dK and dV: warps 4-7 hand their halves to warps 0-3 through the
    // stages' space (every stage is consumed: the last pair's barriers)
    float* const hand = sm + L::kStages;
    if (qh == 1) {
#pragma unroll
      for (int c = 0; c < kN; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hand[((kb * kN + c) * 4 + e) * 32 + lane] = dka[c][e];
          hand[(((4 + kb) * kN + c) * 4 + e) * 32 + lane] = dva[c][e];
        }
    }
    __syncthreads();
    const int rank = plan.dkv(u) & 0xffff, count = plan.dkv(u) >> 16;
    int* const cnt = dkv_ctr + static_cast<long long>(bkv) * n_sp + n;
    block_wait_turn(cnt, rank);
    if (qh == 0) {
      float* const kp = dk + b * sdk.b + hk * sdk.h;
      float* const vp = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
      for (int c = 0; c < kN; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 16 * kb + g8 + 8 * (e / 2);
          const int col = 8 * c + 2 * t4 + e % 2;
          if (key >= Sk || col >= D) continue;
          const float x = dka[c][e] + hand[((kb * kN + c) * 4 + e) * 32 + lane];
          const float y = dva[c][e] + hand[(((4 + kb) * kN + c) * 4 + e) * 32 + lane];
          put1(kp + key * sdk.s + col, x, rank == 0);
          put1(vp + key * sdv.s + col, y, rank == 0);
        }
    }
    if (rank + 1 < count)
      block_pass_turn(cnt, rank);
    else
      __syncthreads();  // the hand-over space is consumed
  }
}

}  // namespace f32

// (c), fp32: dQ's fp32 slots (slots, B·H, n_qt·64, ld) added in slot
// order, those of a query tile with count[qt] parts the first min(slots,
// count[qt]), into dq (fp32, through its strides)
__global__ void __launch_bounds__(256)
flash_bwd_dq_sum_kernel(const float* __restrict__ acc, const int* __restrict__ count,
                        float* __restrict__ dq, Str3 sdq, int H, int Sq, int D, int n_qt,
                        int ld, int slots, long long total) {
  const long long plane = total / D / Sq * n_qt * kTile * ld;  // a slot
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int c = static_cast<int>(i % D);
    const long long row = i / D;
    const int s = static_cast<int>(row % Sq);
    const long long bh = row / Sq;
    const float* a = acc + (bh * n_qt * kTile + s) * ld + c;
    const int used = min(slots, count[s / kTile]);
    float x = used > 0 ? a[0] : 0.f;
    for (int j = 1; j < used; ++j) x += a[j * plane];
    dq[(bh / H) * sdq.b + (bh % H) * sdq.h + s * sdq.s + c] = x;
  }
}

template <int kDPad>
cudaError_t launch_fp32(const Args& a, const int* plan, int n_pat, int blocks, int slots,
                        float* dq_acc, int* ctr, bool vec, cudaStream_t stream) {
  constexpr int smem = f32::Layout<kDPad>::kBytes;
  static bool opted = false;
  cudaError_t err = opt_in(f32::flash_bwd_tf32_kernel<kDPad>, smem, opted);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int n_sp = (a.Sk + f32::kSpan - 1) / f32::kSpan;
  const Plan p{plan, n_pat, n_qt, n_sp, slots};
  const auto f32p = [](const void* x) { return static_cast<const float*>(x); };
  f32::flash_bwd_tf32_kernel<kDPad><<<blocks, f32::kThreads, smem, stream>>>(
      f32p(a.q), f32p(a.k), f32p(a.v), f32p(a.dout), a.lse, a.delta, p, a.B * a.KV, dq_acc,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), ctr, a.sq, a.sk, a.sv, a.sdo,
      a.sdk, a.sdv, a.H, a.H / a.KV, a.Sq, a.Sk, a.D, a.causal, a.window,
      1.0f / sqrtf(static_cast<float>(a.D)), vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(a.B) * a.H * a.Sq * a.D;
  const long long grid = (total + 255) / 256 < 65535LL * 16 ? (total + 255) / 256 : 65535LL * 16;
  flash_bwd_dq_sum_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(
      dq_acc, plan + 4 * n_pat + n_qt * n_sp, static_cast<float*>(a.dq), a.sdq, a.H, a.Sq,
      a.D, n_qt, kDPad, slots, total);
  return cudaGetLastError();
}

// the main kernel's dynamic shared memory: K and V, the dS buffer, the
// ring, the dQ buffers, their barriers, and 1024 bytes to align the base
template <int kChunks>
constexpr int main_smem() {
  using R = Ring<kChunks>;
  return 1024 + 2 * kSpanBox * kChunks + kSpanBox + R::kStages * R::kStage +
         R::kDqBufs * R::kDq + 8 * (2 + 2 * R::kStages + 3 * R::kDqBufs);
}

// dQ's fp32 slots (planes, rows, ld), planes = slots·B·H, as a 3-D map of
// 64-row, 32-column boxes with the 128-byte swizzle, the dQ buffers' layout
bool encode_f32_map(CUtensorMap* map, float* ptr, int ld, int rows, int bh) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 4,
                                 static_cast<cuuint64_t>(ld) * 4 * rows};
  const cuuint32_t box[3] = {32, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// once per instantiation, outside any CUDA graph capture: refuse a build
// whose register count is not kMainRegs, the count the fused kernel's
// setmaxnreg hand-over is sized for (at another, setmaxnreg.inc would wait
// for registers no warpgroup frees and the kernel would never end), and
// opt the kernel in to its shared memory
template <int kChunks>
cudaError_t prepare_main(int smem) {
  const auto kern = flash_bwd_wgmma_kernel<kChunks>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err == cudaSuccess && attr.numRegs != kMainRegs) err = cudaErrorInvalidKernelImage;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

template <int kChunks>
cudaError_t launch_bf16(const Args& a, const long long* st, const int* plan, int n_pat,
                        int blocks, int slots, float* dq_acc, float* dkv_acc, int* ctr,
                        cudaStream_t stream) {
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  constexpr int kLd = 64 * kChunks;
  // q's and dO's maps span H heads and Sq rows in 64-row boxes, k's and v's
  // KV heads and Sk rows in 128-row boxes
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!encode_map(&tq, a.q, st, a.B, a.H, a.Sq, a.D, kTile) ||
      !encode_map(&tk, a.k, st + 3, a.B, a.KV, a.Sk, a.D, kSpan) ||
      !encode_map(&tv, a.v, st + 6, a.B, a.KV, a.Sk, a.D, kSpan) ||
      !encode_map(&tdo, a.dout, st + 12, a.B, a.H, a.Sq, a.D, kTile) ||
      !encode_f32_map(&tdq, dq_acc, kLd, n_qt * kTile, slots * a.B * a.H))
    return cudaErrorInvalidValue;
  constexpr int smem = main_smem<kChunks>();
  static const cudaError_t ready = prepare_main<kChunks>(smem);
  if (ready != cudaSuccess) return ready;
  const float scale = 1.0f / sqrtf(static_cast<float>(a.D));
  const int n_sp = (a.Sk + kSpan - 1) / kSpan;
  const Plan p{plan, n_pat, n_qt, n_sp, slots};
  flash_bwd_wgmma_kernel<kChunks><<<blocks, kMainThreads, smem, stream>>>(
      tq, tk, tv, tdo, tdq, a.delta, p, a.B * a.KV, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.sdk, a.sdv, dkv_acc, ctr, a.H, a.H / a.KV, a.Sk,
      a.causal, a.window, a.D, scale, kLog2e * scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(a.B) * a.H * a.Sq * ((a.D + 1) / 2);
  const long long grid = (pairs + 255) / 256 < 65535LL * 16 ? (pairs + 255) / 256 : 65535LL * 16;
  flash_bwd_dq_round_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(
      dq_acc, plan + 4 * n_pat + n_qt * n_sp, static_cast<bf16*>(a.dq), a.sdq, a.H, a.Sq,
      a.D, n_qt, kLd, slots, pairs);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, H, Sq, D) and k, v, dk, dv: (B, KV, Sk, D), H a
// multiple of KV, with unit D stride; st: the (b, h, s) strides in
// elements of q, k, v, o, dout, dq, dk and dv in that order; lse: the
// forward's (B, H, Sq) fp32, contiguous; bf16_data != 0 for bfloat16 data
// (lse fp32 either way).  Masks as launch_flash_attention's: causal needs
// Sq = Sk, window > 0 a causal call.  delta: fp32 scratch the first kernel
// fills, (B, H, Sq) for fp32 data, for bf16 the row stats (B·H·n_qt tiles
// of 2 x 64, n_qt = ceil(Sq / 64)).  bf16 only (else ignored): plan and
// n_pat, the unit list's pattern (see Plan); blocks, the persistent grid;
// slots, the slots of a dQ tile's sum; dq_acc (slots·B·H, 64·n_qt, 64·ceil(D /
// 64)) and dkv_acc (2·B·KV·Sk·64·ceil(D / 64), only where the plan splits a
// span) fp32 scratch; ctr, n_ctr = 1 + B·H·n_qt·slots + 2·B·KV·ceil(Sk / 128)
// int32 counters, zeroed by the first kernel.
cudaError_t launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout,
                                       const float* lse, float* delta, void* dq,
                                       void* dk, void* dv, const long long* st,
                                       int B, int H, int KV, int Sq, int Sk, int D,
                                       int causal, int window, int bf16_data,
                                       const int* plan, int n_pat, int blocks,
                                       int slots, float* dq_acc, float* dkv_acc,
                                       int* ctr, long long n_ctr, cudaStream_t stream) {
  if (D < 1 || D > 128 || Sq < 1 || Sk < 1 || (causal && Sq != Sk) || B * H < 1 ||
      B * H > 65535 || KV < 1 || H % KV != 0 || window < 0 || (window > 0 && !causal))
    return cudaErrorInvalidValue;
  auto s3 = [&](int i) { return Str3{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv, s3(0), s3(1), s3(2), s3(4),
               s3(5), s3(6), s3(7), B, H, KV, Sq, Sk, D, causal, window};
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int n_sp = bf16_data ? (Sk + kSpan - 1) / kSpan : (Sk + f32::kSpan - 1) / f32::kSpan;
  if (plan == nullptr || n_pat < 1 || blocks < 1 || slots < 1 || dq_acc == nullptr ||
      ctr == nullptr ||
      n_ctr != 1 + static_cast<long long>(B) * H * n_qt * slots + 2LL * B * KV * n_sp)
    return cudaErrorInvalidValue;
  if (!bf16_data) {
    const long long rows = static_cast<long long>(B) * H * Sq;
    flash_bwd_prep_f32_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta, s3(3), s3(4), H,
        Sq, D, rows, ctr, static_cast<int>(n_ctr));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // 16-byte copies where every row of q, k, v and dO starts 16-byte aligned
    bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                 reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
                16) == 0;
    for (int i : {0, 1, 2, 4})
      for (int d = 0; d < 3; ++d) vec = vec && st[3 * i + d] % 4 == 0;
    return D <= 64 ? launch_fp32<64>(a, plan, n_pat, blocks, slots, dq_acc, ctr, vec, stream)
                   : launch_fp32<128>(a, plan, n_pat, blocks, slots, dq_acc, ctr, vec, stream);
  }
  // TMA: 16-byte aligned bases (the wrapper checks them and the strides)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(delta)) % 16)
    return cudaErrorMisalignedAddress;
  const long long rows = static_cast<long long>(B) * H * n_qt * kTile;
  flash_bwd_prep_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta, s3(3),
      s3(4), H, Sq, D, n_qt, rows, ctr, static_cast<int>(n_ctr));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return D <= 64
             ? launch_bf16<1>(a, st, plan, n_pat, blocks, slots, dq_acc, dkv_acc, ctr, stream)
             : launch_bf16<2>(a, st, plan, n_pat, blocks, slots, dq_acc, dkv_acc, ctr, stream);
}
