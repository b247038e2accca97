// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel
// (driven by ssd_scan there).  It computes the same function: for each
// (batch, head), sequentially over chunks of kQ rows, with an fp32 state
// S [P, N] that starts at zero,
//
//     cum = cumsum(dt a)                             [Q]
//     G   = tril(C B^T * exp(cum_i - cum_j))         [Q, Q]  (mask in the exponent)
//     y   = G u + exp(cum) * (C S^T),  u = x dt      [Q, P]
//     S  <- exp(cum_Q) S + (exp(cum_Q - cum) u)^T B  [P, N]
//
// Inputs x [B, S, H, P] and b/c [B, S, N] (one group for all heads) in
// float32 or bfloat16, dt [B, S, H] and a [H] in float32; outputs y in x's
// dtype and the final state [B, H, P, N] in float32.
//
// Two routes, chosen by the caller (kernel.py's ``route``) from the dtype and
// the shape:
// - ssd_fwd_tc, for bfloat16 x/b/c with P and N multiples of 8 (every shape
//   a served model gives it): the products on the tensor cores (wgmma), the
//   tiles brought by TMA.
// - ssd_fwd_fma, for float32, and for bfloat16 with P or N not a multiple
//   of 8 (TMA needs 16-byte strides): every product on the fp32 FMA units,
//   the TPU kernel's arithmetic.  fp32 inputs stay on it because a product
//   of fp32 operands on the tensor cores (TF32, or three bf16 terms) would
//   not keep fp32's tolerance as cheaply as the bf16 split below keeps bf16's.
//
// What bounds it on this card.  Per (batch, head) a chunk of Q rows does
// 2 Q^2 N (C B^T, once for all heads) + Q^2 P (G u, lower triangle) +
// 2 Q N P (C S^T) + 2 Q P N (state update) operations against 2 Q P
// elements of x and y.  At mamba2-1.3b's shapes (H 64, P 64, N 128, bf16) a
// call moves 17 MB for a prompt of 866 tokens (5.1 us at 3.35 TB/s) and
// does 2.1 GFLOP (2.2 us at 989 TFLOP/s on the tensor cores): the bound is
// set by bytes.  The kernel cannot reach it at a batch of one: a prompt of S
// tokens is a chain of ceil(S / 64) chunks, each a few dependent products,
// and there are only 128 such chains (64 heads x 2 slices of P) for 132
// SMs.  What bounds it is the latency of one chunk's chain of products.
//
// What the design does (ssd_fwd_tc).  One block per (32 columns of P, head,
// batch) walks the chunks in order (so a batch of one still gives 128
// blocks), with warpgroup 0 computing and warp 4 loading:
// - The loader keeps the next chunk's C and B tiles [64 x N] and x tile
//   [64 x 64] in flight with TMA into a ring of two stages (128-byte
//   swizzle; columns past N or P and rows past S are zero-filled).  dt of
//   one head lies at a stride of H floats, too narrow for a tensor map, so
//   the loader reads it with plain loads one chunk ahead, takes the
//   cumulative sum as a warp-shuffle scan, and leaves in the stage the
//   scalars the consumers need: cum (in log2 units), dt, the rows' decay to
//   the chunk's end times dt, and the chunk's decay.
// - C B^T is a wgmma with both operands K-major in shared memory (recomputed
//   per block: N / 16 steps of m64n64k16 a chunk).  The decay, the mask (in
//   the exponent: exp is never taken of a positive difference) and dt are
//   applied in registers with one ex2.approx and one multiply each, and G
//   goes in as the register A operand of G x.
// - The fp32 state lives in the warpgroup's accumulator registers across
//   chunks, as S^T [N x 32] (M = N in one or two m64 tiles): S^T += B^T x~
//   is a wgmma whose A operand is B's tile read in place as MN-major (the
//   transpose bit).
// - Between two chunks, with no wgmma in flight, the threads write what the
//   next chunk's products read besides TMA's tiles: the state in two terms
//   (for C S^T), x^T and x~^T = (x exp(cum_Q - cum) dt)^T (K-major B
//   operands of 32 columns for G x and the state update), as 8 x 8 matrices
//   through ldmatrix and stmatrix.trans, behind one async-proxy fence and
//   one barrier; then the state decays by a multiply.  ptxas serialises
//   every wgmma of the kernel if an accumulator is written, or a register
//   that an earlier wgmma wrote is read, while a wgmma is in flight, or if
//   a wgmma sits in a branch or a loop of unknown length: hence this place,
//   and depth loops over all 64 NB columns of N (zeros past N).
// - y is stored from registers, clipped at S and at the block's columns;
//   the final state likewise, once.
// About 113 KB of shared memory and 152 registers, so two blocks share an
// SM where there are more blocks than SMs (the batch of 4).  What bounds it
// now is the chain of one chunk in one warpgroup: four warps, one per
// scheduler, pay the full latency of each dependent step (the products, the
// exponentials of G, the writes between chunks); the tensor cores idle most
// of a chunk.  Splitting a chunk between two consumer warpgroups (G and
// G x in one, the state in the other) is the next step.
//
// Two terms keep fp32 accuracy on bf16 tensor cores.  x, B and C are bf16
// and exact as they are; dt, the decays and the state are not.  Each fp32
// factor is folded into one operand, which is split into hi = bf16(v) and
// lo = bf16(v - hi) (about 16 bits of mantissa between them), and the
// product is two wgmmas accumulating in fp32: C B^T (exact operands, one
// term), G x (G split), C S^T (S split), B^T x~ (x~ split).  Emulated in
// PyTorch at mamba2's widths (tests/test_torch_ssd_scan.py), the relative
// error (max abs error / max abs value) against the fp32 ssd_chunked is a
// few 1e-6 for y and for the state; one term (plain bf16 operands) gives
// about 2e-3, which the fp32 state would carry into every decode step.
//
// Ragged S.  The TPU wrapper asserts that its chunk divides S; served
// prompts have exact lengths.  Rows past S in the last chunk are loaded as
// zeros with dt = 0: their decay is 1 and their u is 0, so the state passes
// through unchanged, and their y rows are not stored.  Inputs are contiguous
// and 16-byte aligned (ops.py checks it).
//
// The backward (ssd_scan_bwd) replaces the JAX package's custom VJP
// src/repro/kernels/ssd_scan/ops.py::_ssd_bwd (:25-28), which is no Pallas
// kernel: jax.vjp through the sequential reference_ssd, recomputed from the
// saved inputs.  Given dy and the final state's cotangent (zeros in
// training), it returns dx, ddt, da, db and dc in three launches:
// 1. pass 1: per (32 columns of P, head, batch), a forward walk over the
//    chunks that stores each chunk's entry state S_k [P, N], and, in the
//    same launch, a backward walk that stores the gradient dS of each
//    chunk's exit state, into scratch [B, H, S/64, P, N];
// 2. pass 2: per chunk, all chunks in parallel, the chunk's gradients from
//    S_k and dS (formulas at ssd_bwd_chunk);
// 3. ssd_bwd_reduce: b and c are shared by the heads and a by the rows, so
//    dB, dC (per head or group of heads) and da (per chunk) are partial
//    sums, added over the heads, and over batch and chunks, in a fixed
//    order: no atomics, and two passes are bit-identical.
// What bounds it on this card.  At the train shape of mamba2-1.3b (B 8, S
// 256, H 64, P 64, N 128, bf16) the products take 13.0 GFLOP, 0.013 ms at
// 989 TFLOP/s on the bf16 tensor cores, against 53 MB of inputs and
// outputs, 0.016 ms at 3.35 TB/s: the bound is 0.016 ms, set by bytes.  The
// scratch adds 67 MB for each of S_k and dS, written once and read once
// (0.080 ms of the memory's time), and the partials of dB and dC.
// Two routes, chosen by the caller (kernel.py's ``bwd_route``):
// - the wgmma route, for bf16 with P <= 64 and P and N multiples of 8 (every
//   shape a model gives it): ssd_bwd_walk_tc is the forward kernel's state
//   recurrence on the tensor cores, both walks in one launch, storing the
//   states as two bf16 terms (hi, lo: the fp32 bytes) with TMA;
//   ssd_bwd_chunk_tc takes one block per (chunk, group of up to 8 heads,
//   batch), computes C B^T once for the group, and walks its heads with two
//   consumer warpgroups (rows j: dB, du, dx; rows i: dC) on wgmma, every
//   fp32 factor in two bf16 terms as the forward's, dB and dC summed over
//   the group in registers, so the partials shrink eightfold (8.4 MB each
//   at the train shape).  Emulated in PyTorch at mamba2's widths
//   (tests/test_torch_ssd_scan.py), each gradient is within a few 1e-6 of
//   fp32 autograd relative to its largest value; one term gives 4e-4 to
//   3e-3.  On an H100 80GB HBM3 (700 W) at the train shape it took
//   0.18 ms: 8.8-8.9 % of the bound, 7.1x the FMA route's 1.28-1.29 ms on
//   the same inputs (chip_smoke.py, PERF.md, which has the time of each of
//   the three launches).  What holds it is the
//   scratch: the states' 268 MB written and read are 0.080 ms at 3.35
//   TB/s.  Below that, the walks are chains of four dependent chunk
//   updates per block, 2048 blocks of one warpgroup; the chunk pass is one
//   block per SM (216 KB of shared memory), its two warpgroups each a
//   serial chain of products and waits per head, in two waves of 256
//   blocks.
// - the FMA route, for float32 and the other bf16 shapes: ssd_bwd_states
//   and ssd_bwd_chunk in fp32 FMA arithmetic, each thread adding 4 x 4
//   blocks from operands it reads from shared memory by 16-byte loads, with
//   the columns spread so that a quarter warp reads distinct banks; per-head
//   partials of dB and dC.  Two loaded floats per four FMAs cap it at half
//   the FMA rate, and 176 KB of shared memory and 216 registers a thread
//   leave one block of 8 warps per SM: at the bf16 train shape it took 1.28
//   ms (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "../../common/csrc/hopper.cuh"

namespace {

constexpr int kQ = 64;          // rows of one chunk
constexpr int kMaxPT = 32;      // columns of P per block
constexpr int kMaxN = 128;      // largest state size the shared memory holds

struct Params {
  const void* x;   // [B, S, H, P]
  const float* dt; // [B, S, H]
  const float* a;  // [H]
  const void* b;   // [B, S, N]
  const void* c;   // [B, S, N]
  void* y;         // [B, S, H, P]
  float* state;    // [B, H, P, N]
  int B, S, H, P, N, pt;  // pt: columns of P per block
};

// ---------------------------------------------------------------- fp32 FMA route
constexpr int kThreads = 256;
constexpr int kPad = 4;         // row padding of the shared arrays, in floats
constexpr int kLDQ = kQ + kPad;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store4(float* dst, float v0, float v1, float v2, float v3) {
  *reinterpret_cast<float4*>(dst) = make_float4(v0, v1, v2, v3);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float v0, float v1, float v2,
                                       float v3) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// acc[r][c] += sum_{k < K} A[k][r0 + r] * Bm[k][c0 + c]: both operands in
// shared memory, laid out [k][row] with 16-byte aligned rows.
__device__ __forceinline__ void mma4x4(float (&acc)[4][4], const float* A, int lda,
                                       const float* Bm, int ldb, int K, int r0, int c0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(A + k * lda + r0);
    const float4 bv = *reinterpret_cast<const float4*>(Bm + k * ldb + c0);
    const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__host__ __device__ constexpr size_t smem_floats(int n, int pt) {
  return 2 * (size_t)n * kLDQ      // Ct, Bt: C and B transposed, [n][row]
         + (size_t)kQ * (n + kPad)  // Bn: B by rows, [row][n], scaled by w
         + (size_t)kQ * kLDQ        // Gt: G transposed, [j][i]
         + (size_t)kQ * (pt + kPad)  // U: u = x dt, [row][p]
         + (size_t)n * (pt + kPad)   // St: the state transposed, [n][p]
         + 3 * (size_t)kQ;           // la, cum, w
}

// One block per (P slice of 32 columns, head, batch) walks the chunks in
// order with S^T in shared memory.  Per chunk it stages B and C (both
// transposed, and B row by row) and u = x dt as fp32, computes cum, G^T, y
// and the new state as four small products, each thread owning 4 x 4
// outputs and reading two float4s for every 16 FMAs; tiles of G above the
// diagonal are skipped.  149 KB of shared memory at N 128: one block per SM.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_fwd_fma(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, pt = p.pt;
  const int ldn = N + kPad, ldp = pt + kPad;
  float* Ct = smem;
  float* Bt = Ct + N * kLDQ;
  float* Bn = Bt + N * kLDQ;
  float* Gt = Bn + kQ * ldn;
  float* U = Gt + kQ * kLDQ;
  float* St = U + kQ * ldp;
  float* la = St + N * ldp;  // dt a of each row
  float* cum = la + kQ;      // its inclusive prefix sum
  float* w = cum + kQ;       // dt of each row, then exp(cum_Q - cum)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * pt, h = blockIdx.y, bi = blockIdx.z;
  const float a = p.a[h];
  const T* xg = static_cast<const T*>(p.x);
  const T* bg = static_cast<const T*>(p.b);
  const T* cg = static_cast<const T*>(p.c);
  T* yg = static_cast<T*>(p.y);
  const long long row0 = (long long)bi * p.S;  // first row of this batch entry

  for (int e = tid; e < N * ldp; e += kThreads) St[e] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += kQ) {
    const int L = min(kQ, p.S - t0);  // rows of this chunk; the rest are zeros
    __syncthreads();  // the previous chunk is consumed (and St is zeroed)

    // stage B and C in both layouts, and dt a and dt of this head
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int j = e / N, n = e - j * N;
      float bv = 0.f, cv = 0.f;
      if (j < L) {
        const long long off = (row0 + t0 + j) * N + n;
        bv = to_f(bg[off]);
        cv = to_f(cg[off]);
      }
      Bn[j * ldn + n] = bv;
      Bt[n * kLDQ + j] = bv;
      Ct[n * kLDQ + j] = cv;
    }
    if (tid < kQ) {
      const float d = tid < L ? p.dt[(row0 + t0 + tid) * p.H + h] : 0.f;
      la[tid] = d * a;
      w[tid] = d;
    }
    __syncthreads();

    // u = x dt of this block's columns; cum in order, as a sequential cumsum
    for (int e = tid; e < kQ * pt; e += kThreads) {
      const int j = e / pt, q = e - j * pt;
      const float xv = j < L ? to_f(xg[((row0 + t0 + j) * p.H + h) * p.P + p0 + q]) : 0.f;
      U[j * ldp + q] = xv * w[j];
    }
    if (tid < kQ) {
      float s = 0.f;
      for (int j = 0; j <= tid; ++j) s += la[j];
      cum[tid] = s;
    }
    __syncthreads();

    // G^T, and the decay of each row to the end of the chunk
    if (tid < kQ) w[tid] = expf(cum[kQ - 1] - cum[tid]);
    for (int t = tid; t < (kQ / 4) * (kQ / 4); t += kThreads) {
      const int i0 = (t / (kQ / 4)) * 4, j0 = (t % (kQ / 4)) * 4;
      float acc[4][4] = {};
      if (j0 <= i0) mma4x4(acc, Ct, kLDQ, Bt, kLDQ, N, i0, j0);  // else above the diagonal
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float g[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = i0 + ii, j = j0 + jj;
          g[ii] = j <= i ? acc[ii][jj] * expf(cum[i] - cum[j]) : 0.f;
        }
        store4(Gt + (j0 + jj) * kLDQ + i0, g[0], g[1], g[2], g[3]);
      }
    }
    __syncthreads();

    // y = G u + exp(cum) (C S^T) for the chunk's rows; B scaled by w for the
    // state update (Bn is not read here)
    for (int t = tid; t < (kQ / 4) * (pt / 4); t += kThreads) {
      const int i0 = (t / (pt / 4)) * 4, q0 = (t % (pt / 4)) * 4;
      float intra[4][4] = {}, inter[4][4] = {};
      mma4x4(intra, Gt, kLDQ, U, ldp, i0 + 4, i0, q0);  // G[i][j] = 0 for j > i
      mma4x4(inter, Ct, kLDQ, St, ldp, N, i0, q0);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ii;
        if (i >= L) break;
        const float e = expf(cum[i]);
        float o[4];
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) o[qq] = fmaf(e, inter[ii][qq], intra[ii][qq]);
        store4(yg + ((row0 + t0 + i) * p.H + h) * p.P + p0 + q0, o[0], o[1], o[2], o[3]);
      }
    }
    for (int e = tid; e < L * N; e += kThreads) {
      const int j = e / N;
      Bn[j * ldn + (e - j * N)] *= w[j];
    }
    __syncthreads();  // S^T has been read by every y tile

    // S^T[n][q] <- exp(cum_Q) S^T[n][q] + sum_j u[j][q] w_j B[j][n]
    const float chunk_decay = expf(cum[kQ - 1]);
    for (int t = tid; t < (pt / 4) * (N / 4); t += kThreads) {
      const int q0 = (t / (N / 4)) * 4, n0 = (t % (N / 4)) * 4;
      float acc[4][4] = {};
      mma4x4(acc, U, ldp, Bn, ldn, L, q0, n0);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        float* s = St + (n0 + nn) * ldp + q0;
        const float4 old = *reinterpret_cast<const float4*>(s);
        store4(s, fmaf(chunk_decay, old.x, acc[0][nn]), fmaf(chunk_decay, old.y, acc[1][nn]),
               fmaf(chunk_decay, old.z, acc[2][nn]), fmaf(chunk_decay, old.w, acc[3][nn]));
      }
    }
  }
  __syncthreads();

  float* sg = p.state + (((long long)bi * p.H + h) * p.P + p0) * N;
  for (int e = tid; e < pt * N; e += kThreads) {
    const int q = e / N, n = e - q * N;
    sg[q * N + n] = St[n * ldp + q];
  }
}

// ---------------------------------------------------------------- bf16 tensor-core route
constexpr int kStages = 2;
constexpr int kConsumers = 128;  // warpgroup 0
constexpr int kTcThreads = 160;  // and the loader, warp 4
constexpr int kBox = 64 * 64;    // elements of a [64][64] bf16 tile, 8 KB
constexpr int kPBox = 32 * 64;   // elements of a [32][64] bf16 tile, 4 KB
constexpr float kLog2e = 1.4426950408889634f;

// What the loader leaves in a stage besides the tiles, per row of the chunk
struct __align__(16) ChunkScalars {
  float cum[kQ];  // inclusive cumsum of dt a, times log2(e)
  float dt[kQ];   // dt: G_ij = (C B^T)_ij 2^(cum_i - cum_j) dt_j
  float wx[kQ];   // exp(cum_Q - cum) dt: x~ = x wx, the rows' share of the new state
  float decay;    // exp(cum_Q), the state's decay over the chunk
};

// Shared memory in bf16 elements from a 1024-byte boundary, every tile in
// TMA's 128-byte swizzle.  Per stage: C and B as NB boxes [64 rows][64 of
// N] each, x as [64 rows][64 columns of P from the block's first]; then
// x^T [32 columns of P][64 rows]; then x~^T as [64][64 rows], its hi term
// in rows 0..31 and its lo term in rows 32..63; then the state, NB boxes
// [64][64 of N] of hi and lo rows alike.
template <int NB>
struct TcTiles {
  static constexpr int STAGE = (2 * NB + 1) * kBox;
  static constexpr int XT = kStages * STAGE;
  static constexpr int XS = XT + kPBox;
  static constexpr int SS = XS + kBox;
  static constexpr size_t SMEM = 2 * (size_t)(SS + NB * kBox) + 1024;  // + alignment
};

using hopper::fast_exp2;
using hopper::pack_bf16;

// (v0, v1) as two bf16 pairs whose sum carries about 16 bits: hi = bf16(v),
// lo = bf16(v - hi)
__device__ __forceinline__ void split_pack(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// descriptor of the kk-th 16-deep step of a K-major operand: boxes of
// ``rows`` rows by 64 of depth, one after another
__device__ __forceinline__ uint64_t kmajor(const __nv_bfloat16* tile, int rows, int kk) {
  return hopper::desc_sw128(tile + (kk / 4) * rows * 64 + (kk % 4) * 16, 16, 1024);
}

template <int NB>
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_fwd_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc, const Params p) {
  using T = TcTiles<NB>;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ ChunkScalars scal[kStages];
  bf16* sm = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int p0 = blockIdx.x * p.pt, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (p.S + kQ - 1) / kQ;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 33);  // the loader's 32 lanes and its expect_tx
      hopper::mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ loader warp
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0) {
      hopper::tma_prefetch(&tx);
      hopper::tma_prefetch(&tb);
      hopper::tma_prefetch(&tc);
    }
    const float a2 = p.a[h] * kLog2e;
    const float* dtg = p.dt + (long long)b * p.S * p.H + h;
    float d0, d1;  // dt of rows lane and 32 + lane of the next chunk, 0 past S
    auto load_dt = [&](int t0) {
      d0 = t0 + lane < p.S ? dtg[(long long)(t0 + lane) * p.H] : 0.f;
      d1 = t0 + 32 + lane < p.S ? dtg[(long long)(t0 + 32 + lane) * p.H] : 0.f;
    };
    load_dt(0);
    for (int k = 0; k < n_chunks; ++k) {
      const int s = k % kStages, t0 = k * kQ;
      hopper::mbar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
      if (lane == 0) {
        bf16* st = sm + s * T::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * T::STAGE);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load_3d(st + c * kBox, &tc, &full[s], 64 * c, t0, b);
          hopper::tma_load_3d(st + (NB + c) * kBox, &tb, &full[s], 64 * c, t0, b);
        }
        hopper::tma_load_4d(st + 2 * NB * kBox, &tx, &full[s], p0, h, t0, b);
      }
      // inclusive scan of dt a log2(e) over the chunk's 64 rows
      float c0 = d0 * a2, c1 = d1 * a2;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, c0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, c1, off);
        if (lane >= off) {
          c0 += u0;
          c1 += u1;
        }
      }
      c1 += __shfl_sync(0xffffffffu, c0, 31);
      const float cq = __shfl_sync(0xffffffffu, c1, 31);
      ChunkScalars& cs = scal[s];
      cs.cum[lane] = c0;
      cs.cum[32 + lane] = c1;
      cs.dt[lane] = d0;
      cs.dt[32 + lane] = d1;
      cs.wx[lane] = exp2f(cq - c0) * d0;
      cs.wx[32 + lane] = exp2f(cq - c1) * d1;
      if (lane == 0) cs.decay = exp2f(cq);
      hopper::mbar_arrive(&full[s]);
      if (k + 1 < n_chunks) load_dt(t0 + kQ);
    }
  } else {
    // ------------------------------------------------ consumer warpgroup
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
    const int r0 = 16 * warp + g;    // this lane's accumulator rows: r0 and r0 + 8
    bf16* const xt = sm + T::XT;
    bf16* const xs2 = sm + T::XS;  // x~^T: hi rows, then lo rows
    bf16* const ss = sm + T::SS;   // the state: per box, hi rows, then lo rows
    bf16* const yg = static_cast<bf16*>(p.y);

    float cb[32], ya[16], yi[16], st[NB][16];
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int i = 0; i < 16; ++i) st[m][i] = 0.f;
    uint32_t gh[4][4], gl[4][4];

    // What chunk k's products read from shared memory besides TMA's tiles,
    // written by the threads as 8 x 8 matrices through stmatrix.trans (and
    // ldmatrix) between two chunks, when no wgmma is in flight (registers
    // that a wgmma wrote may not be read while another is in flight without
    // ptxas inserting a wait), behind one fence and one barrier; then the
    // state's decay over chunk k.
    auto prepare = [&](int k) {
      const int s = k % kStages;
      const bf16* xs = sm + s * T::STAGE + 2 * NB * kBox;
      hopper::mbar_wait(&full[s], (k / kStages) & 1);
      // x's rows 16w..16w+15 (warp w), loaded first: the stores below keep
      // their order with loads from shared memory
      uint32_t xr[2][4];
      float w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j0 = 16 * warp + 8 * i;
        hopper::ldmatrix_x4(xr[i], xs + hopper::sw128_offset(j0 + (lane & 7), 8 * (lane >> 3)));
        w[i] = scal[s].wx[j0 + lane / 4];  // this lane's row of every matrix
      }
      // the state after chunk k - 1 (zeros before the first) in two terms
      // for C S^T: the accumulator's blocks (rows n, columns p) land as [p][n]
#pragma unroll
      for (int m = 0; m < NB; ++m)
#pragma unroll
        for (int jj = 0; jj < 4; jj += 2) {
          uint32_t hr[4], lr[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_pack(st[m][4 * jj + 2 * q], st[m][4 * jj + 2 * q + 1], hr[q], lr[q]);
          const int o = m * kBox + hopper::sw128_offset(8 * (jj + (lane >> 4)) + (lane & 7),
                                                         16 * warp + 8 * ((lane >> 3) & 1));
          hopper::stmatrix_x4_trans(ss + o, hr);
          hopper::stmatrix_x4_trans(ss + kPBox + o, lr);
        }
      // x^T (exact) and x~^T = (x wx)^T in two terms, for the 32 columns of P
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t hr[4], lr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[i][q]));
          split_pack(v.x * w[i], v.y * w[i], hr[q], lr[q]);
        }
        const int o = hopper::sw128_offset(lane, 16 * warp + 8 * i);  // row p = lane
        hopper::stmatrix_x4_trans(xt + o, xr[i]);
        hopper::stmatrix_x4_trans(xs2 + o, hr);
        hopper::stmatrix_x4_trans(xs2 + kPBox + o, lr);
      }
      const float decay = scal[s].decay;
#pragma unroll
      for (int m = 0; m < NB; ++m)
#pragma unroll
        for (int i = 0; i < 16; ++i) st[m][i] *= decay;
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1, kConsumers);
    };

    prepare(0);
    for (int k = 0; k < n_chunks; ++k) {
      const int s = k % kStages, t0 = k * kQ;
      const bf16* cs = sm + s * T::STAGE;
      const bf16* bs = cs + NB * kBox;
      const ChunkScalars& sc = scal[s];

      // C B^T, over all 64 NB columns of N (those past N are zeros)
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        hopper::wgmma_ss_n64<0, 0>(cb, kmajor(cs, 64, kk), kmajor(bs, 64, kk), kk > 0);
      hopper::wgmma_commit();
      const float cr0 = sc.cum[r0], cr1 = sc.cum[r0 + 8];
      float2 cc[8], dc[8];  // G's column terms, loaded before the wgmmas order the loads
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        cc[jj] = *reinterpret_cast<const float2*>(&sc.cum[8 * jj + 2 * tg]);
        dc[jj] = *reinterpret_cast<const float2*>(&sc.dt[8 * jj + 2 * tg]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(cb);

      // C S^T of the state after the previous chunk, and S^T <- decay S^T +
      // B^T x~, with B's tile as the MN-major A operand ([rows][N] read as
      // [N][rows])
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk) {
        const uint64_t dc = kmajor(cs, 64, kk);
        const bf16* sk = ss + (kk / 4) * kBox + (kk % 4) * 16;
        hopper::wgmma_ss_n32<0, 0>(yi, dc, hopper::desc_sw128(sk, 16, 1024), kk > 0);
        hopper::wgmma_ss_n32<0, 0>(yi, dc, hopper::desc_sw128(sk + kPBox, 16, 1024), 1);
      }
#pragma unroll
      for (int m = 0; m < NB; ++m) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = hopper::desc_sw128(bs + m * kBox + kk * 16 * 64, 2 * kBox, 1024);
          hopper::wgmma_ss_n32<1, 0>(st[m], da, hopper::desc_sw128(xs2 + 16 * kk, 16, 1024), 1);
          hopper::wgmma_ss_n32<1, 0>(st[m], da,
                                     hopper::desc_sw128(xs2 + kPBox + 16 * kk, 16, 1024), 1);
        }
      }

      // G_ij = (C B^T)_ij exp(cum_i - cum_j) dt_j for j <= i, in two terms,
      // as the A fragments of G x (k-step kk takes columns 16kk..16kk+15)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * jj + 2 * tg;
        const float g00 = cb[4 * jj + 0] * dc[jj].x * fast_exp2(j <= r0 ? cr0 - cc[jj].x : -INFINITY);
        const float g01 = cb[4 * jj + 1] * dc[jj].y * fast_exp2(j + 1 <= r0 ? cr0 - cc[jj].y : -INFINITY);
        const float g10 = cb[4 * jj + 2] * dc[jj].x * fast_exp2(j <= r0 + 8 ? cr1 - cc[jj].x : -INFINITY);
        const float g11 = cb[4 * jj + 3] * dc[jj].y * fast_exp2(j + 1 <= r0 + 8 ? cr1 - cc[jj].y : -INFINITY);
        split_pack(g00, g01, gh[jj / 2][(jj % 2) * 2], gl[jj / 2][(jj % 2) * 2]);
        split_pack(g10, g11, gh[jj / 2][(jj % 2) * 2 + 1], gl[jj / 2][(jj % 2) * 2 + 1]);
      }

      // y_intra = G x
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = hopper::desc_sw128(xt + 16 * kk, 16, 1024);
        hopper::wgmma_rs_n32<0>(ya, gh[kk], dx, kk > 0);
        hopper::wgmma_rs_n32<0>(ya, gl[kk], dx, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(ya);
      hopper::fence_operands(yi);
#pragma unroll
      for (int m = 0; m < NB; ++m) hopper::fence_operands(st[m]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::fence_operands(gh[kk]);
        hopper::fence_operands(gl[kk]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);  // the stage is read

      // y = G x + exp(cum) (C S^T), rows past S and columns past the block's
      // not stored
      bf16* yrow = yg + (((long long)b * p.S + t0 + r0) * p.H + h) * p.P + p0;
      const long long row8 = 8ll * p.H * p.P;  // from row r0 to row r0 + 8
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (t0 + r0 + 8 * r < p.S) {
          const float e = fast_exp2(r ? cr1 : cr0);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int col = 8 * jj + 2 * tg;
            if (col < p.pt)
              *reinterpret_cast<uint32_t*>(yrow + r * row8 + col) =
                  pack_bf16(fmaf(e, yi[4 * jj + 2 * r], ya[4 * jj + 2 * r]),
                            fmaf(e, yi[4 * jj + 2 * r + 1], ya[4 * jj + 2 * r + 1]));
          }
        }
      }
      if (k + 1 < n_chunks) prepare(k + 1);
    }

    // the final state [P, N] of this block's columns
    float* sg = p.state + (((long long)b * p.H + h) * p.P + p0) * p.N;
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int n = 64 * m + r0 + 8 * ((e >> 1) & 1), q = 8 * (e / 4) + 2 * tg + (e & 1);
        if (n < p.N && q < p.pt) sg[(long long)q * p.N + n] = st[m][e];
      }
  }
}

// ---------------------------------------------------------------- backward (fp32 FMA)
constexpr int kBwdThreads = 256;
constexpr int kBwdPT = 32;  // columns of P per pass over P (and per block of ssd_bwd_states)

struct BwdParams {
  const void* x;        // [B, S, H, P]
  const float* dt;      // [B, S, H]
  const float* a;       // [H]
  const void* b;        // [B, S, N]
  const void* c;        // [B, S, N]
  const void* dy;       // [B, S, H, P], x's dtype
  const float* dstate;  // [B, H, P, N], the final state's cotangent; null: zeros
  float* states;        // [B, H, NC, P, N] scratch: the state entering each chunk
  float* dstates;       // [B, H, NC, P, N] scratch: the gradient of the state leaving it
  void* dx;             // [B, S, H, P] in x's dtype, or null
  float* ddt;           // [B, S, H], or null
  float* db_part;       // [B, S, H, N] scratch: each head's dB, or null
  float* dc_part;       // [B, S, H, N] scratch: each head's dC, or null
  float* da_part;       // [B, NC, H] scratch: each chunk's da, or null
  void* db;             // [B, S, N] in b's dtype, or null
  void* dc;             // [B, S, N] in c's dtype, or null
  float* da;            // [H], or null
  int B, S, H, P, N, NC, pt;
  int parts;            // the partials of dB and dC per row: H (FMA route), H / G (wgmma route)
};

__device__ __forceinline__ void from_f(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// The backward's products, each thread adding a 4 x 4 block to acc, both
// operands in shared memory (leading dims and bases multiples of 4 floats),
// each taken in the layout it is staged in, by 16-byte loads:
//   tn: acc[r][c] += sum_{k0<=k<k1} A[k][r0 + r] Bm[k][c0 + c]
//   nn: acc[r][c] += sum_k A[r0 + r][k] Bm[k][c0 + c]           (k0, k1 multiples of 4)
//   nt: acc[r][c] += sum_k A[r0 + r][k] Bm[c0 + c cs][k]         (k0, k1 multiples of 4)
// nt's columns lie cs apart, so that the threads of a quarter warp read
// neighbouring rows of Bm (a row stride of an odd number of 16-byte words
// then spreads them over the banks); neighbouring rows 4 apart would meet
// in two banks.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float (&a)[4],
                                       const float (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

__device__ __forceinline__ void mma_tn(float (&acc)[4][4], const float* A, int lda,
                                       const float* Bm, int ldb, int k0, int k1, int r0,
                                       int c0) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 av = lds4(A + k * lda + r0), bv = lds4(Bm + k * ldb + c0);
    const float a[4] = {av.x, av.y, av.z, av.w}, b[4] = {bv.x, bv.y, bv.z, bv.w};
    fma4x4(acc, a, b);
  }
}

__device__ __forceinline__ void mma_nn(float (&acc)[4][4], const float* A, int lda,
                                       const float* Bm, int ldb, int k0, int k1, int r0,
                                       int c0) {
  for (int k = k0; k < k1; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = lds4(A + (r0 + i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 bv = lds4(Bm + (k + kk) * ldb + c0);
      const float a[4] = {(&av[0].x)[kk], (&av[1].x)[kk], (&av[2].x)[kk], (&av[3].x)[kk]};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
      fma4x4(acc, a, b);
    }
  }
}

__device__ __forceinline__ void mma_nt(float (&acc)[4][4], const float* A, int lda,
                                       const float* Bm, int ldb, int k0, int k1, int r0,
                                       int c0, int cs) {
  for (int k = k0; k < k1; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = lds4(A + (r0 + i) * lda + k);
      bv[i] = lds4(Bm + (c0 + i * cs) * ldb + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float a[4] = {(&av[0].x)[kk], (&av[1].x)[kk], (&av[2].x)[kk], (&av[3].x)[kk]};
      const float b[4] = {(&bv[0].x)[kk], (&bv[1].x)[kk], (&bv[2].x)[kk], (&bv[3].x)[kk]};
      fma4x4(acc, a, b);
    }
  }
}

// Sums across a warp in a fixed order (every run adds the same pairs)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Inclusive prefix (suffix) sums over the kQ = 64 rows, one row per thread of
// warps 0 and 1: a shuffle scan in each warp, then warp 1 (0) adds the other
// warp's total.  Called by every thread; callers sync after.
template <bool kSuffix>
__device__ __forceinline__ void scan_rows(float v, float* out) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < kQ) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = kSuffix ? __shfl_down_sync(0xffffffffu, v, off)
                              : __shfl_up_sync(0xffffffffu, v, off);
      if (kSuffix ? lane + off < 32 : lane >= off) v += u;
    }
    out[tid] = v;
  }
  __syncthreads();
  if (kSuffix ? tid < 32 : tid >= 32 && tid < kQ) out[tid] += out[kSuffix ? 32 : 31];
}

// dt a of the chunk's rows, its inclusive prefix sum, and dt; rows past S
// have dt = 0.  Callers sync after.
__device__ __forceinline__ void chunk_cumsum(const BwdParams& p, long long row0, int t0, int L,
                                             int h, float a, float* la, float* cum, float* dtv) {
  const int tid = threadIdx.x;
  float v = 0.f;
  if (tid < kQ) {
    const float d = tid < L ? p.dt[(row0 + t0 + tid) * p.H + h] : 0.f;
    v = d * a;
    la[tid] = v;
    dtv[tid] = d;
  }
  scan_rows<false>(v, cum);
}

// Pass 1 of the backward, both directions in one launch: one block per (P
// slice of pt columns, head, 2 x batch + direction).  Direction 0 walks the
// chunks forward from a zero state and stores the state entering each;
// direction 1 walks them backward from the final state's cotangent and
// stores the gradient of the state leaving each:
//     S  <- exp(cum_Q) S  + sum_j (x_j exp(cum_Q - cum_j) dt_j) B_j^T
//     dS <- exp(cum_Q) dS + sum_i (dy_i exp(cum_i)) C_i^T
// Each thread keeps one 4 x 4 tile of the [pt, N] state in registers.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) ssd_bwd_states(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, pt = p.pt, ldn = N + kPad, ldp = pt + kPad;
  float* W = smem;           // [kQ][ldn]: B rows (forward) or C rows (backward)
  float* V = W + kQ * ldn;   // [kQ][ldp]: the rows' factors of this block's columns
  float* la = V + kQ * ldp;  // dt a
  float* cum = la + kQ;
  float* coef = cum + kQ;    // dt, then each row's factor

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * pt, h = blockIdx.y, bi = blockIdx.z >> 1, dir = blockIdx.z & 1;
  const float a = p.a[h];
  const T* vg = static_cast<const T*>(dir ? p.dy : p.x);
  const T* wg = static_cast<const T*>(dir ? p.c : p.b);
  const long long row0 = (long long)bi * p.S;
  float* out = (dir ? p.dstates : p.states) + ((long long)bi * p.H + h) * p.NC * p.P * N;

  const bool owner = tid < (pt / 4) * (N / 4);
  const int q0 = owner ? (tid / (N / 4)) * 4 : 0, n0 = owner ? (tid % (N / 4)) * 4 : 0;
  float st[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st[i][j] = dir && p.dstate && owner
                     ? p.dstate[(((long long)bi * p.H + h) * p.P + p0 + q0 + i) * N + n0 + j]
                     : 0.f;

  for (int it = 0; it < p.NC; ++it) {
    const int k = dir ? p.NC - 1 - it : it;
    const int t0 = k * kQ, L = min(kQ, p.S - t0);
    if (owner)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store4(out + ((long long)k * p.P + p0 + q0 + i) * N + n0, st[i][0], st[i][1], st[i][2],
               st[i][3]);
    if (it + 1 == p.NC) break;  // the state past the walk is not needed
    __syncthreads();            // the previous chunk is consumed
    for (int e = tid; e < kQ * N; e += kBwdThreads) {
      const int j = e / N, n = e - j * N;
      W[j * ldn + n] = j < L ? to_f(wg[(row0 + t0 + j) * N + n]) : 0.f;
    }
    chunk_cumsum(p, row0, t0, L, h, a, la, cum, coef);
    __syncthreads();
    if (tid < kQ) coef[tid] = dir ? expf(cum[tid]) : expf(cum[kQ - 1] - cum[tid]) * coef[tid];
    __syncthreads();
    for (int e = tid; e < kQ * pt; e += kBwdThreads) {
      const int j = e / pt, q = e - j * pt;
      V[j * ldp + q] =
          j < L ? to_f(vg[((row0 + t0 + j) * p.H + h) * p.P + p0 + q]) * coef[j] : 0.f;
    }
    __syncthreads();
    if (owner) {
      const float decay = expf(cum[kQ - 1]);
      float acc[4][4] = {};
      mma_tn(acc, V, ldp, W, ldn, 0, L, q0, n0);  // sum_j V[j][q] W[j][n]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = fmaf(decay, st[i][j], acc[i][j]);
    }
  }
}

__host__ __device__ constexpr size_t bwd_chunk_smem_floats(int n, int pt) {
  return 2 * (size_t)kQ * (n + kPad)        // C and B rows
         + 2 * (size_t)kQ * (pt + kPad)     // x and dy rows of one pass
         + 2 * (size_t)pt * (n + kPad)      // S and dS rows of one pass
         + 2 * (size_t)kQ * (kQ + kPad)     // M (then W) and D
         + (size_t)(kBwdPT / 4) * kQ        // per-row partials over a pass's columns
         + 2 * (size_t)(kMaxN / 4) * kQ     // per-row partials over N
         + 8 * (size_t)kQ + kBwdThreads / 32;  // per-row scalars; per-warp partials
}

// Pass 2: one block per (chunk, head, batch), the chunks in parallel, from
// the chunk's entry state S and the gradient dS of its exit state (pass 1).
// With L_ij = exp(cum_i - cum_j) for i >= j (0 above the diagonal; exp is
// never taken of j > i), u = x dt, e_i = exp(cum_i), t_j = exp(cum_Q - cum_j)
// and DU_ij = dy_i . u_j:
//     du_j  = sum_{i>=j} (C_i . B_j) L_ij dy_i + t_j dS B_j
//     dB_j  = sum_{i>=j} DU_ij L_ij C_i + t_j dS^T u_j
//     dC_i  = sum_{j<=i} DU_ij L_ij B_j + e_i S^T dy_i
//     dcum_i = sum_j W_ij - sum_j W_ji + e_i dy_i^T S C_i - t_i u_i^T dS B_i,
//              W_ij = DU_ij (C_i . B_j) L_ij; and dcum_Q += sum_j t_j u_j^T dS B_j
//              + exp(cum_Q) <dS, S>
//     d(dt a) = reverse cumsum of dcum;  ddt = d(dt a) a + du . x;  dx = du dt
// The products over P run in passes of pt columns; DU and each thread's
// tiles of dB and dC stay in registers across them.  dB and dC are this
// head's share (per-head partials, summed over H by ssd_bwd_reduce), da this
// chunk's.  Every sum runs in a fixed order: no atomics.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) ssd_bwd_chunk(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, pt = p.pt, ldn = N + kPad, ldp = pt + kPad, ldq = kQ + kPad;
  float* Cr = smem;              // [kQ][ldn]
  float* Br = Cr + kQ * ldn;     // [kQ][ldn]
  float* Xr = Br + kQ * ldn;     // [kQ][ldp] x, this pass's columns
  float* Yr = Xr + kQ * ldp;     // [kQ][ldp] dy, this pass's columns
  float* Sm = Yr + kQ * ldp;     // [pt][ldn] S, this pass's rows of P
  float* dSm = Sm + pt * ldn;    // [pt][ldn] dS, this pass's rows of P
  float* M = dSm + pt * ldn;     // [kQ][ldq] (C B^T) L, then W
  float* D = M + kQ * ldq;       // [kQ][ldq] DU L
  float* red = D + kQ * ldq;     // [kBwdPT / 4][kQ] sum over 4 columns of P of du x
  float* red_e = red + (kBwdPT / 4) * kQ;  // [kMaxN / 4][kQ] sum over 4 of N, e-term
  float* red_t = red_e + (kMaxN / 4) * kQ;  // [kMaxN / 4][kQ] sum over 4 of N, t-term
  float* la = red_t + (kMaxN / 4) * kQ;
  float* cum = la + kQ;
  float* dtv = cum + kQ;
  float* ev = dtv + kQ;          // exp(cum)
  float* tv = ev + kQ;           // exp(cum_Q - cum)
  float* ddtx = tv + kQ;         // sum_p du x
  float* dcum = ddtx + kQ;
  float* tterm = dcum + kQ;      // t_j u_j^T dS B_j
  float* ss = tterm + kQ;        // [kBwdThreads / 32] per-warp partial sums

  const int tid = threadIdx.x, k = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int t0 = k * kQ, L = min(kQ, p.S - t0);
  const float a = p.a[h];
  const T* xg = static_cast<const T*>(p.x);
  const T* yg = static_cast<const T*>(p.dy);
  const T* bg = static_cast<const T*>(p.b);
  const T* cg = static_cast<const T*>(p.c);
  const long long row0 = (long long)bi * p.S;
  const long long sbase = (((long long)bi * p.H + h) * p.NC + k) * p.P * N;  // [P][N] of chunk k

  for (int e = tid; e < kQ * N; e += kBwdThreads) {
    const int j = e / N, n = e - j * N;
    float bv = 0.f, cv = 0.f;
    if (j < L) {
      const long long off = (row0 + t0 + j) * N + n;
      bv = to_f(bg[off]);
      cv = to_f(cg[off]);
    }
    Br[j * ldn + n] = bv;
    Cr[j * ldn + n] = cv;
  }
  chunk_cumsum(p, row0, t0, L, h, a, la, cum, dtv);
  __syncthreads();
  if (tid < kQ) {
    ev[tid] = expf(cum[tid]);
    tv[tid] = expf(cum[kQ - 1] - cum[tid]);
    ddtx[tid] = 0.f;
  }

  // this thread's block of [kQ][kQ] (M, DU, D, W): rows i0..i0 + 3, columns
  // jb, jb + 16, jb + 32, jb + 48; none below the diagonal where jb > i0 + 3
  const int i0 = (tid / (kQ / 4)) * 4, jb = tid % (kQ / 4);
  const bool lower = jb <= i0 + 3;
  {
    float acc[4][4] = {};
    if (lower) mma_nt(acc, Cr, ldn, Br, ldn, 0, N, i0, jb, kQ / 4);  // C_i . B_j
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = i0 + ii, j = jb + jj * (kQ / 4);
        M[i * ldq + j] = j <= i ? acc[ii][jj] * expf(cum[i] - cum[j]) : 0.f;
      }
  }

  // this thread's tiles of [kQ][N] (dB, dC): up to two
  const int nt = N / 4, n_tiles = (kQ / 4) * nt;
  float du_[4][4] = {};  // dy_i . x_j over the passes (dt_j applied after)
  float dcs[2][4][4] = {}, dbs[2][4][4] = {};
  float ss_part = 0.f;

  for (int p0 = 0; p0 < p.P; p0 += pt) {
    __syncthreads();  // the previous pass is consumed (and M written)
    for (int e = tid; e < kQ * pt; e += kBwdThreads) {
      const int j = e / pt, q = e - j * pt;
      float xv = 0.f, yv = 0.f;
      if (j < L) {
        const long long off = ((row0 + t0 + j) * p.H + h) * p.P + p0 + q;
        xv = to_f(xg[off]);
        yv = to_f(yg[off]);
      }
      Xr[j * ldp + q] = xv;
      Yr[j * ldp + q] = yv;
    }
    for (int e = tid; e < pt * N; e += kBwdThreads) {
      const int q = e / N, n = e - q * N;
      const long long off = sbase + (long long)(p0 + q) * N + n;
      const float sv = p.states[off], dsv = p.dstates[off];
      Sm[q * ldn + n] = sv;
      dSm[q * ldn + n] = dsv;
      ss_part = fmaf(sv, dsv, ss_part);
    }
    __syncthreads();

    if (lower) mma_nt(du_, Yr, ldp, Xr, ldp, 0, pt, i0, jb, kQ / 4);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int t = tid + m * kBwdThreads;
      if (t < n_tiles) {
        const int r0 = (t / nt) * 4, c0 = (t % nt) * 4;
        mma_nn(dcs[m], Yr, ldp, Sm, ldn, 0, pt, r0, c0);   // dy^T S
        mma_nn(dbs[m], Xr, ldp, dSm, ldn, 0, pt, r0, c0);  // x^T dS
      }
    }
    // du of this pass's columns (rows ju..ju + 3, columns qb + qs qq), dx,
    // and du . x per row
    const int qs = pt / 4;
    if (tid < (kQ / 4) * qs) {
      const int ju = (tid / qs) * 4, qb = tid % qs;
      float u1[4][4] = {}, u2[4][4] = {};
      for (int i = ju; i < kQ; ++i) {  // sum_{i>=j} M_ij dy_i
        const float4 mv = lds4(M + i * ldq + ju);
        const float a[4] = {mv.x, mv.y, mv.z, mv.w};
        float b[4];
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) b[qq] = Yr[i * ldp + qb + qq * qs];
        fma4x4(u1, a, b);
      }
      mma_nt(u2, Br, ldn, dSm, ldn, 0, N, ju, qb, qs);  // dS B_j
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = ju + jj;
        const long long off = ((row0 + t0 + j) * p.H + h) * p.P + p0 + qb;
        float s = 0.f;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const float du = fmaf(tv[j], u2[jj][qq], u1[jj][qq]);
          s = fmaf(du, Xr[j * ldp + qb + qq * qs], s);
          if (p.dx && j < L) from_f(static_cast<T*>(p.dx) + off + qq * qs, du * dtv[j]);
        }
        red[qb * kQ + j] = s;
      }
    }
    __syncthreads();
    if (tid < kQ)
      for (int r = 0; r < pt / 4; ++r) ddtx[tid] += red[r * kQ + tid];
  }

  // W = DU M into M, D = DU L: each thread its own block
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int i = i0 + ii, j = jb + jj * (kQ / 4);
      const float du = du_[ii][jj] * dtv[j];
      M[i * ldq + j] *= du;  // 0 above the diagonal
      D[i * ldq + j] = j <= i ? du * expf(cum[i] - cum[j]) : 0.f;
    }
  // the state terms of dC and dB, their rows' shares of dcum, then the L terms
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int t = tid + m * kBwdThreads;
    if (t < n_tiles) {
      const int r0 = (t / nt) * 4, c0 = (t % nt) * 4;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = r0 + ii;
        float se = 0.f, st = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          dcs[m][ii][cc] *= ev[r];
          dbs[m][ii][cc] *= tv[r] * dtv[r];
          se = fmaf(Cr[r * ldn + c0 + cc], dcs[m][ii][cc], se);
          st = fmaf(Br[r * ldn + c0 + cc], dbs[m][ii][cc], st);
        }
        red_e[(c0 / 4) * kQ + r] = se;
        red_t[(c0 / 4) * kQ + r] = st;
      }
    }
  }
  __syncthreads();  // D, W, red_e and red_t are written
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int t = tid + m * kBwdThreads;
    if (t < n_tiles) {
      const int r0 = (t / nt) * 4, c0 = (t % nt) * 4;
      mma_tn(dbs[m], D, ldq, Cr, ldn, r0, kQ, r0, c0);      // sum_{i>=j} D_ij C_i
      mma_nn(dcs[m], D, ldq, Br, ldn, 0, r0 + 4, r0, c0);  // sum_{j<=i} D_ij B_j
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = r0 + ii;
        if (r >= L) break;
        const long long off = ((row0 + t0 + r) * p.H + h) * N + c0;
        const float(&gb)[4] = dbs[m][ii];
        const float(&gc)[4] = dcs[m][ii];
        if (p.db_part) store4(p.db_part + off, gb[0], gb[1], gb[2], gb[3]);
        if (p.dc_part) store4(p.dc_part + off, gc[0], gc[1], gc[2], gc[3]);
      }
    }
  }
  {
    // dcum of row r = tid / 4, each of its 4 threads over a quarter of the
    // columns, then across the 4
    const int r = tid >> 2, qq = tid & 3;
    float sw = 0.f, se = 0.f, st = 0.f;
    for (int j = qq * (kQ / 4); j < (qq + 1) * (kQ / 4); ++j) sw += M[r * ldq + j] - M[j * ldq + r];
    for (int c = qq; c < nt; c += 4) {
      se += red_e[c * kQ + r];
      st += red_t[c * kQ + r];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sw += __shfl_xor_sync(0xffffffffu, sw, off);
      se += __shfl_xor_sync(0xffffffffu, se, off);
      st += __shfl_xor_sync(0xffffffffu, st, off);
    }
    if (qq == 0) {
      dcum[r] = sw + se - st;
      tterm[r] = st;
    }
    const float sum = warp_sum(ss_part);  // <dS, S>, a warp's share
    if ((tid & 31) == 0) ss[tid >> 5] = sum;
  }
  __syncthreads();
  if (tid < 32) {  // the cum_Q terms, into the last row's dcum
    const float t_all = warp_sum(tterm[tid] + tterm[tid + 32]);
    const float s_all = warp_sum(tid < kBwdThreads / 32 ? ss[tid] : 0.f);
    if (tid == 0) dcum[kQ - 1] += t_all + expf(cum[kQ - 1]) * s_all;
  }
  __syncthreads();
  // d(dt a) of each row, the reverse cumsum of dcum
  scan_rows<true>(tid < kQ ? dcum[tid] : 0.f, la);
  __syncthreads();
  if (tid < kQ) {
    const float dla = la[tid];
    if (p.ddt && tid < L) p.ddt[(row0 + t0 + tid) * p.H + h] = fmaf(dla, a, ddtx[tid]);
    const float share = warp_sum(dla * dtv[tid]);  // da: the rows' shares
    if ((tid & 31) == 0) ss[tid >> 5] = share;
  }
  __syncthreads();
  if (tid == 0 && p.da_part) p.da_part[((long long)bi * p.NC + k) * p.H + h] = ss[0] + ss[1];
}

// Pass 3: db and dc, each the sum of the partials over the heads (one per
// head on the FMA route, one per group of heads on the wgmma route), and da
// the sum over batch and chunks of theirs, each in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) ssd_bwd_reduce(const BwdParams p) {
  const long long n_out = (long long)p.B * p.S * p.N;
  for (long long e = (long long)blockIdx.x * kBwdThreads + threadIdx.x; e < n_out;
       e += (long long)gridDim.x * kBwdThreads) {
    const long long src = (e / p.N) * p.parts * p.N + e % p.N;  // [b, s][part 0][n]
    if (p.db) {
      float s = 0.f;
      for (int h = 0; h < p.parts; ++h) s += p.db_part[src + (long long)h * p.N];
      from_f(static_cast<T*>(p.db) + e, s);
    }
    if (p.dc) {
      float s = 0.f;
      for (int h = 0; h < p.parts; ++h) s += p.dc_part[src + (long long)h * p.N];
      from_f(static_cast<T*>(p.dc) + e, s);
    }
  }
  if (p.da && blockIdx.x == 0)
    for (int h = threadIdx.x; h < p.H; h += kBwdThreads) {
      float s = 0.f;
      for (long long r = 0; r < (long long)p.B * p.NC; ++r) s += p.da_part[r * p.H + h];
      p.da[h] = s;
    }
}

// ---------------------------------------------------------------- backward (bf16 tensor cores)
// The wgmma route of the backward, for bf16 with P <= 64 and P and N
// multiples of 8.  Its scratch holds each state as two bf16 terms, hi =
// bf16(v) and lo = bf16(v - hi), in planes [B, H, NC, 2, P, N] (the bytes of
// the FMA route's fp32 [B, H, NC, P, N]), which TMA loads as wgmma operands.
constexpr int kMaxG = 8;  // heads per block of ssd_bwd_chunk_tc

// ssd_bwd_walk_tc, what the loader leaves in a stage besides the tiles
struct __align__(16) WalkScalars {
  float coef[kQ];  // each row's factor: exp(cum_Q - cum) dt (forward), exp(cum) (backward)
  float decay;     // exp(cum_Q)
};

// Shared memory of ssd_bwd_walk_tc in bf16 elements from a 1024-byte
// boundary, 128-byte swizzle.  Per stage: W (B or C) as NB boxes [64 rows][64
// of N] and V (x or dy) as one box [64 rows][64 columns of P from the
// block's first]; then (V coef)^T [32 columns of P][64 rows], hi rows 0..31
// and lo rows 32..63; then two buffers of the state as NB boxes [64][64 of
// N], hi in rows 0..31 and lo in rows 32..63, which TMA stores.
template <int NB>
struct WalkTiles {
  static constexpr int STAGE = (NB + 1) * kBox;
  static constexpr int VT = kStages * STAGE;
  static constexpr int SS = VT + kBox;
  static constexpr size_t SMEM = 2 * (size_t)(SS + 2 * NB * kBox) + 1024;  // + alignment
};

// Pass 1 on the tensor cores, both directions in one launch: one block per
// (32 columns of P, head, 2 x batch + direction), warpgroup 0 computing and
// warp 4 loading, the forward kernel's state recurrence (ssd_fwd_tc) without
// its y.  Direction 0 walks chunks 0..NC-1 from a zero state and stores the
// state entering each; direction 1 walks them backward from the final
// state's cotangent and stores the gradient of the state leaving each:
//     S^T  <- exp(cum_Q) S^T  + B^T (x exp(cum_Q - cum) dt)
//     dS^T <- exp(cum_Q) dS^T + C^T (dy exp(cum))
// The state lives in fp32 accumulators (S^T [N x 32], M = N in one or two
// m64 tiles); W's tile is the MN-major A operand read in place, (V coef)^T
// the K-major B operand in two terms.  Before each chunk's update the
// threads write the state in two terms through stmatrix.trans as [P][N]
// boxes, which one thread stores with TMA from one of two buffers (the
// store of the chunk before reads the other).
template <int NB>
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_bwd_walk_tc(const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap tst, const __grid_constant__ CUtensorMap tdst,
                    const BwdParams p) {
  using T = WalkTiles<NB>;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ WalkScalars scal[kStages];
  bf16* sm = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int p0 = blockIdx.x * p.pt, h = blockIdx.y, b = blockIdx.z >> 1, dir = blockIdx.z & 1;
  const int n_upd = p.NC - 1;  // the state past the walk is not needed
  auto chunk = [&](int it) { return dir ? p.NC - 1 - it : it; };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 33);  // the loader's 32 lanes and its expect_tx
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ loader warp
    const int lane = threadIdx.x - kConsumers;
    const CUtensorMap* tw = dir ? &tc : &tb;
    const CUtensorMap* tv = dir ? &tdy : &tx;
    if (lane == 0) {
      hopper::tma_prefetch(tw);
      hopper::tma_prefetch(tv);
    }
    const float a2 = p.a[h] * kLog2e;
    const float* dtg = p.dt + (long long)b * p.S * p.H + h;
    float d0 = 0.f, d1 = 0.f;  // dt of rows lane and 32 + lane of the next chunk, 0 past S
    auto load_dt = [&](int t0) {
      d0 = t0 + lane < p.S ? dtg[(long long)(t0 + lane) * p.H] : 0.f;
      d1 = t0 + 32 + lane < p.S ? dtg[(long long)(t0 + 32 + lane) * p.H] : 0.f;
    };
    if (n_upd > 0) load_dt(chunk(0) * kQ);
    for (int it = 0; it < n_upd; ++it) {
      const int s = it % kStages, t0 = chunk(it) * kQ;
      hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        bf16* st = sm + s * T::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * T::STAGE);
#pragma unroll
        for (int c = 0; c < NB; ++c) hopper::tma_load_3d(st + c * kBox, tw, &full[s], 64 * c, t0, b);
        hopper::tma_load_4d(st + NB * kBox, tv, &full[s], p0, h, t0, b);
      }
      // inclusive scan of dt a log2(e) over the chunk's 64 rows
      float c0 = d0 * a2, c1 = d1 * a2;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, c0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, c1, off);
        if (lane >= off) {
          c0 += u0;
          c1 += u1;
        }
      }
      c1 += __shfl_sync(0xffffffffu, c0, 31);
      const float cq = __shfl_sync(0xffffffffu, c1, 31);
      WalkScalars& ws = scal[s];
      ws.coef[lane] = dir ? exp2f(c0) : exp2f(cq - c0) * d0;
      ws.coef[32 + lane] = dir ? exp2f(c1) : exp2f(cq - c1) * d1;
      if (lane == 0) ws.decay = exp2f(cq);
      hopper::mbar_arrive(&full[s]);
      if (it + 1 < n_upd) load_dt(chunk(it + 1) * kQ);
    }
  } else {
    // ------------------------------------------------ consumer warpgroup
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
    const int r0 = 16 * warp + g;  // this lane's accumulator rows (of N): r0 and r0 + 8
    bf16* const vt = sm + T::VT;   // (V coef)^T: hi rows, then lo rows
    const CUtensorMap* to = dir ? &tdst : &tst;

    float st[NB][16];
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int n = 64 * m + r0 + 8 * ((e >> 1) & 1), q = 8 * (e / 4) + 2 * tg + (e & 1);
        st[m][e] = dir && p.dstate && n < p.N && q < p.pt
                       ? p.dstate[(((long long)b * p.H + h) * p.P + p0 + q) * p.N + n]
                       : 0.f;
      }

    for (int it = 0; it < p.NC; ++it) {
      const int s = it % kStages, k = chunk(it);
      const bool upd = it < n_upd;
      bf16* const ss = sm + T::SS + (it & 1) * NB * kBox;
      // the state entering chunk k (or the gradient leaving it) in two terms:
      // the accumulator's blocks (rows n, columns p) land as [p][n]
#pragma unroll
      for (int m = 0; m < NB; ++m)
#pragma unroll
        for (int jj = 0; jj < 4; jj += 2) {
          uint32_t hr[4], lr[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_pack(st[m][4 * jj + 2 * q], st[m][4 * jj + 2 * q + 1], hr[q], lr[q]);
          const int o = m * kBox + hopper::sw128_offset(8 * (jj + (lane >> 4)) + (lane & 7),
                                                         16 * warp + 8 * ((lane >> 3) & 1));
          hopper::stmatrix_x4_trans(ss + o, hr);
          hopper::stmatrix_x4_trans(ss + kPBox + o, lr);
        }
      if (upd) {
        // (V coef)^T in two terms for the 32 columns of P, then the decay
        const bf16* vs = sm + s * T::STAGE + NB * kBox;
        hopper::mbar_wait(&full[s], (it / kStages) & 1);
        uint32_t vr[2][4];
        float w[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j0 = 16 * warp + 8 * i;
          hopper::ldmatrix_x4(vr[i], vs + hopper::sw128_offset(j0 + (lane & 7), 8 * (lane >> 3)));
          w[i] = scal[s].coef[j0 + lane / 4];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t hr[4], lr[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 v =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vr[i][q]));
            split_pack(v.x * w[i], v.y * w[i], hr[q], lr[q]);
          }
          const int o = hopper::sw128_offset(lane, 16 * warp + 8 * i);  // row p = lane
          hopper::stmatrix_x4_trans(vt + o, hr);
          hopper::stmatrix_x4_trans(vt + kPBox + o, lr);
        }
        const float decay = scal[s].decay;
#pragma unroll
        for (int m = 0; m < NB; ++m)
#pragma unroll
          for (int e = 0; e < 16; ++e) st[m][e] *= decay;
      }
      if (tid == 0) hopper::bulk_wait<0, true>();  // the other buffer's store has read it
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1, kConsumers);
      if (tid == 0) {
        const int plane = (((b * p.H + h) * p.NC) + k) * 2;
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          hopper::tma_store_3d(to, ss + m * kBox, 64 * m, p0, plane);
          hopper::tma_store_3d(to, ss + m * kBox + kPBox, 64 * m, p0, plane + 1);
        }
        hopper::bulk_commit();
      }
      if (upd) {
        const bf16* ws = sm + s * T::STAGE;
        hopper::wgmma_fence();
#pragma unroll
        for (int m = 0; m < NB; ++m) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = hopper::desc_sw128(ws + m * kBox + kk * 16 * 64, 2 * kBox, 1024);
            hopper::wgmma_ss_n32<1, 0>(st[m], da, hopper::desc_sw128(vt + 16 * kk, 16, 1024), 1);
            hopper::wgmma_ss_n32<1, 0>(st[m], da,
                                       hopper::desc_sw128(vt + kPBox + 16 * kk, 16, 1024), 1);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < NB; ++m) hopper::fence_operands(st[m]);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);  // the stage is read
      }
    }
    if (tid == 0) hopper::bulk_wait<0, false>();
  }
}

// ssd_bwd_chunk_tc, per head of the block: the rows' scalars
struct __align__(16) HeadScalars {
  float cum[kQ];  // inclusive cumsum of dt a, times log2(e)
  float dt[kQ];
  float e[kQ];    // exp(cum): the decay from the chunk's start
  float t[kQ];    // exp(cum_Q - cum): the decay to the chunk's end
  float decay;    // exp(cum_Q)
};

// ... and the rows' shares of dcum and ddt that its warpgroups leave
struct RowTerms {
  float w_row[kMaxG][kQ];  // sum_j W_ij  (warpgroup 1)
  float w_col[kMaxG][kQ];  // sum_i W_ij  (warpgroup 0)
  float e_term[kMaxG][kQ]; // e_i dy_i^T S C_i  (warpgroup 1)
  float t_term[kMaxG][kQ]; // t_j u_j^T dS B_j  (warpgroup 0)
  float du_x[kMaxG][kQ];   // du_j . x_j  (warpgroup 0)
  float ds_s[kMaxG][4];    // <dS, S>, per warp of warpgroup 1
};

// Shared memory of ssd_bwd_chunk_tc in bf16 elements from a 1024-byte
// boundary, every tile in TMA's 128-byte swizzle: C and B of the chunk as NB
// boxes [64 rows][64 of N] each; then per stage (one head) x and dy as one
// box [64 rows][64 of P] each, and S hi, S lo, dS hi, dS lo as NB boxes [64
// of P][64 of N] each.
template <int NB>
struct ChunkTiles {
  static constexpr int CS = 0, BS = NB * kBox, STAGE0 = 2 * NB * kBox;
  static constexpr int X = 0, DY = kBox, SH = 2 * kBox, SL = SH + NB * kBox, DSH = SL + NB * kBox,
                       DSL = DSH + NB * kBox, STAGE = DSL + NB * kBox;
  static constexpr size_t SMEM = 2 * (size_t)(STAGE0 + kStages * STAGE) + 1024;  // + alignment
};

constexpr int kChunkConsumers = 256;  // warpgroups 0 and 1
constexpr int kChunkThreads = 384;    // and the loader, warpgroup 2

// the kk-th 16-deep step of an MN-major B operand whose depth is a tile's
// 64 rows and whose columns run over its boxes of 64
__device__ __forceinline__ uint64_t mn_major(const __nv_bfloat16* tile, int kk) {
  return hopper::desc_sw128(tile + kk * 16 * 64, 2 * kBox, 1024);
}

// D[64 x 64 NB] (+)= A[64 x 16] B[16 x 64 NB], A from registers, B MN-major
template <int NB>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32 * NB], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NB == 1)
    hopper::wgmma_rs_n64<1>(d, a, db, 1);
  else
    hopper::wgmma_rs_n128<1>(d, a, db, 1);
}

// A 64 x 64 fp32 accumulator (columns as the depth of the next product) as
// A fragments in two terms: k-step kk takes columns 16kk.., its n8 tiles 2kk
// and 2kk + 1
__device__ __forceinline__ void split_frags(const float (&v)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    split_pack(v[4 * j], v[4 * j + 1], hi[j / 2][(j % 2) * 2], lo[j / 2][(j % 2) * 2]);
    split_pack(v[4 * j + 2], v[4 * j + 3], hi[j / 2][(j % 2) * 2 + 1], lo[j / 2][(j % 2) * 2 + 1]);
  }
}

// The warpgroup's 64 rows of a [64][64] bf16 tile as A fragments (ldmatrix),
// each row times its factor (w0 for row 16 warp + g, w1 for the row 8
// below), in two terms
__device__ __forceinline__ void scaled_frags(const __nv_bfloat16* tile, float w0, float w1,
                                             uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], int warp,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t r[4];
    hopper::ldmatrix_x4(r, tile + hopper::sw128_offset(16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1),
                                                       16 * kk + 8 * (lane >> 4)));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[q]));
      const float w = (q & 1) ? w1 : w0;
      split_pack(v.x * w, v.y * w, hi[kk][q], lo[kk][q]);
    }
  }
}

// two bf16 of a swizzled [64][64] tile at (row, col), col even
__device__ __forceinline__ float2 tile_pair(const __nv_bfloat16* tile, int row, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + hopper::sw128_offset(row, col)));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Pass 2 on the tensor cores: one block per (chunk, group of G heads,
// batch), warpgroups 0 and 1 computing, warpgroup 2 loading.  C and B of the
// chunk come once, C B^T (warpgroup 1) and B C^T (warpgroup 0) are computed
// once; then the block walks its heads in order, each head's x, dy, S and
// dS through a ring of two stages.  The formulas are ssd_bwd_chunk's; with
// D = DU∘L (DU_ij = dy_i . u_j, L the decays below the diagonal):
//   warpgroup 0, rows j: D^T from X dY^T; dB += D^T C + (x t dt) dS; du =
//     M^T dy + t (B dS^T), M^T = (B C^T)∘L^T; dx = du dt; sum_p du x; the
//     t term t dt x . (B dS^T); the column sums of W = D∘(C B^T);
//   warpgroup 1, rows i: D from dY X^T; dC += D B + (dy e) S; the e term
//     e dy . (C S^T); the row sums of W; <dS, S>.
// Every product is a wgmma: x, dy, B and C enter exact; each fp32 factor
// (D, M^T, x t dt, dy e, and the states from pass 1) in two bf16 terms,
// hi = bf16(v) and lo = bf16(v - hi), and a product of two split factors
// in three (hi hi, hi lo, lo hi), all summed in fp32.  dB and dC stay in
// fp32 registers over the group's heads (no atomics; the heads in a fixed
// order) and are stored as the group's partial; then each warp finishes
// one head's rows: dcum, its reverse cumsum, ddt and the chunk's share of
// da.
template <int NB>
__global__ void __launch_bounds__(kChunkThreads, 1)
    ssd_bwd_chunk_tc(const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                     const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                     const __grid_constant__ CUtensorMap tst, const __grid_constant__ CUtensorMap tdst,
                     const BwdParams p) {
  using T = ChunkTiles<NB>;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bc_full, full[kStages], empty[kStages];
  __shared__ HeadScalars hsc[kMaxG];
  __shared__ RowTerms rt;
  bf16* sm = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const bf16* cs = sm + T::CS;
  const bf16* bs = sm + T::BS;

  const int k = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.parts, h0 = grp * G;
  const int t0 = k * kQ, L = min(kQ, p.S - t0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bc_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kChunkConsumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kChunkConsumers) {
    // ------------------------------------------------ loader warpgroup
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == kChunkConsumers) {
      hopper::tma_prefetch(&tb);
      hopper::tma_prefetch(&tc);
      hopper::tma_prefetch(&tx);
      hopper::tma_prefetch(&tdy);
      hopper::tma_prefetch(&tst);
      hopper::tma_prefetch(&tdst);
      hopper::mbar_arrive_expect_tx(&bc_full, 2 * T::STAGE0);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        hopper::tma_load_3d(sm + T::CS + c * kBox, &tc, &bc_full, 64 * c, t0, b);
        hopper::tma_load_3d(sm + T::BS + c * kBox, &tb, &bc_full, 64 * c, t0, b);
      }
      for (int gi = 0; gi < G; ++gi) {
        const int s = gi % kStages, h = h0 + gi;
        hopper::mbar_wait(&empty[s], ((gi / kStages) & 1) ^ 1);
        bf16* st = sm + T::STAGE0 + s * T::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * T::STAGE);
        hopper::tma_load_4d(st + T::X, &tx, &full[s], 0, h, t0, b);
        hopper::tma_load_4d(st + T::DY, &tdy, &full[s], 0, h, t0, b);
        const int plane = ((b * p.H + h) * p.NC + k) * 2;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load_3d(st + T::SH + c * kBox, &tst, &full[s], 64 * c, 0, plane);
          hopper::tma_load_3d(st + T::SL + c * kBox, &tst, &full[s], 64 * c, 0, plane + 1);
          hopper::tma_load_3d(st + T::DSH + c * kBox, &tdst, &full[s], 64 * c, 0, plane);
          hopper::tma_load_3d(st + T::DSL + c * kBox, &tdst, &full[s], 64 * c, 0, plane + 1);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  hopper::setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this lane's accumulator rows
  const int cw = threadIdx.x / 32;            // consumer warp 0..7

  // the heads' scalars, warp w for head w: cumsum of dt a in log2 units
  if (cw < G) {
    const float a2 = p.a[h0 + cw] * kLog2e;
    const float* dtg = p.dt + (long long)b * p.S * p.H + h0 + cw;
    const float d0 = lane < L ? dtg[(long long)(t0 + lane) * p.H] : 0.f;
    const float d1 = 32 + lane < L ? dtg[(long long)(t0 + 32 + lane) * p.H] : 0.f;
    float c0 = d0 * a2, c1 = d1 * a2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_up_sync(0xffffffffu, c0, off);
      const float u1 = __shfl_up_sync(0xffffffffu, c1, off);
      if (lane >= off) {
        c0 += u0;
        c1 += u1;
      }
    }
    c1 += __shfl_sync(0xffffffffu, c0, 31);
    const float cq = __shfl_sync(0xffffffffu, c1, 31);
    HeadScalars& hs = hsc[cw];
    hs.cum[lane] = c0;
    hs.cum[32 + lane] = c1;
    hs.dt[lane] = d0;
    hs.dt[32 + lane] = d1;
    hs.e[lane] = exp2f(c0);
    hs.e[32 + lane] = exp2f(c1);
    hs.t[lane] = exp2f(cq - c0);
    hs.t[32 + lane] = exp2f(cq - c1);
    if (lane == 0) hs.decay = exp2f(cq);
  }
  hopper::named_barrier_sync(1, kChunkConsumers);

  // C B^T (warpgroup 1, rows i) or B C^T (warpgroup 0, rows j), once
  float cb[32];
  hopper::mbar_wait(&bc_full, 0);
  {
    const bf16* ra = wg ? cs : bs;
    const bf16* rb = wg ? bs : cs;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      hopper::wgmma_ss_n64<0, 0>(cb, kmajor(ra, 64, kk), kmajor(rb, 64, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(cb);
  }

  float grad[32 * NB];  // dB (warpgroup 0) or dC (warpgroup 1) over the group's heads
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) grad[i] = 0.f;
  float acc[32], aux[32];
  uint32_t fh[4][4], fl[4][4];

  for (int gi = 0; gi < G; ++gi) {
    const int s = gi % kStages, h = h0 + gi;
    const bf16* st = sm + T::STAGE0 + s * T::STAGE;
    const bf16* xs = st + T::X;
    const bf16* dys = st + T::DY;
    const bf16* sh = st + T::SH;
    const bf16* sl = st + T::SL;
    const bf16* dsh = st + T::DSH;
    const bf16* dsl = st + T::DSL;
    const HeadScalars& hs = hsc[gi];
    const float cr[2] = {hs.cum[r0], hs.cum[r1]};
    hopper::mbar_wait(&full[s], (gi / kStages) & 1);

    // DU^T = X dY^T (rows j) or DU = dY X^T (rows i), exact operands
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss_n64<0, 0>(acc, kmajor(wg ? dys : xs, 64, kk), kmajor(wg ? xs : dys, 64, kk),
                                 kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);

    if (wg == 0) {
      // ------------------------------------------ warpgroup 0: rows j
      const float dr[2] = {hs.dt[r0], hs.dt[r1]}, tr[2] = {hs.t[r0], hs.t[r1]};
      // D^T_ji = DU^T_ji dt_j L_ij (i >= j), and the column sums of W
      float wsum[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 ci = *reinterpret_cast<const float2*>(&hs.cum[8 * jj + 2 * tg]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, i = 8 * jj + 2 * tg + (e & 1);
          const float l = fast_exp2(i >= (r ? r1 : r0) ? ((e & 1) ? ci.y : ci.x) - cr[r] : -INFINITY);
          const float v = acc[4 * jj + e] * dr[r] * l;
          acc[4 * jj + e] = v;
          wsum[r] = fmaf(v, cb[4 * jj + e], wsum[r]);
        }
      }
      split_frags(acc, fh, fl);
      wsum[0] = quad_sum(wsum[0]);
      wsum[1] = quad_sum(wsum[1]);
      if (tg == 0) {
        rt.w_col[gi][r0] = wsum[0];
        rt.w_col[gi][r1] = wsum[1];
      }
      // dB += D^T C, C read in place as the MN-major B operand
      hopper::fence_operands(grad);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_mn<NB>(grad, fh[kk], mn_major(cs, kk));
        wgmma_rs_mn<NB>(grad, fl[kk], mn_major(cs, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(grad);
      // dB += (x t dt) dS
      scaled_frags(xs, tr[0] * dr[0], tr[1] * dr[1], fh, fl, warp, lane);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_mn<NB>(grad, fh[kk], mn_major(dsh, kk));
        wgmma_rs_mn<NB>(grad, fh[kk], mn_major(dsl, kk));
        wgmma_rs_mn<NB>(grad, fl[kk], mn_major(dsh, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(grad);
      // B dS^T (depth N, both K-major) into acc
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk) {
        hopper::wgmma_ss_n64<0, 0>(acc, kmajor(bs, 64, kk), kmajor(dsh, 64, kk), kk > 0);
        hopper::wgmma_ss_n64<0, 0>(acc, kmajor(bs, 64, kk), kmajor(dsl, 64, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 ci = *reinterpret_cast<const float2*>(&hs.cum[8 * jj + 2 * tg]);
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, i = 8 * jj + 2 * tg + (e & 1);
          m[e] = cb[4 * jj + e] *
                 fast_exp2(i >= (r ? r1 : r0) ? ((e & 1) ? ci.y : ci.x) - cr[r] : -INFINITY);
        }
        split_pack(m[0], m[1], fh[jj / 2][(jj % 2) * 2], fl[jj / 2][(jj % 2) * 2]);
        split_pack(m[2], m[3], fh[jj / 2][(jj % 2) * 2 + 1], fl[jj / 2][(jj % 2) * 2 + 1]);
      }
      // M^T = (B C^T)∘L^T as fragments, then M^T dY, dY read in place as the
      // MN-major B operand
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_rs_n64<1>(aux, fh[kk], mn_major(dys, kk), kk > 0);
        hopper::wgmma_rs_n64<1>(aux, fl[kk], mn_major(dys, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(aux);
      // du = M^T dy + t (B dS^T): dx = du dt, sum_p du x, and the t term
      float sx[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
      __nv_bfloat16* dxg = static_cast<__nv_bfloat16*>(p.dx);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + 2 * tg;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? r1 : r0;
          const float2 xv = tile_pair(xs, row, col);
          const float b0 = acc[4 * jj + 2 * r], b1 = acc[4 * jj + 2 * r + 1];
          const float du0 = fmaf(tr[r], b0, aux[4 * jj + 2 * r]);
          const float du1 = fmaf(tr[r], b1, aux[4 * jj + 2 * r + 1]);
          sx[r] = fmaf(du0, xv.x, fmaf(du1, xv.y, sx[r]));
          sb[r] = fmaf(b0, xv.x, fmaf(b1, xv.y, sb[r]));
          if (dxg != nullptr && row < L && col < p.P)
            *reinterpret_cast<uint32_t*>(dxg + (((long long)b * p.S + t0 + row) * p.H + h) * p.P + col) =
                pack_bf16(du0 * dr[r], du1 * dr[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sx[r] = quad_sum(sx[r]);
        sb[r] = quad_sum(sb[r]);
      }
      if (tg == 0) {
        rt.du_x[gi][r0] = sx[0];
        rt.du_x[gi][r1] = sx[1];
        rt.t_term[gi][r0] = tr[0] * dr[0] * sb[0];
        rt.t_term[gi][r1] = tr[1] * dr[1] * sb[1];
      }
    } else {
      // ------------------------------------------ warpgroup 1: rows i
      // D_ij = DU_ij dt_j L_ij (j <= i), and the row sums of W
      float wsum[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 cj = *reinterpret_cast<const float2*>(&hs.cum[8 * jj + 2 * tg]);
        const float2 dj = *reinterpret_cast<const float2*>(&hs.dt[8 * jj + 2 * tg]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = 8 * jj + 2 * tg + (e & 1);
          const float l = fast_exp2(j <= (r ? r1 : r0) ? cr[r] - ((e & 1) ? cj.y : cj.x) : -INFINITY);
          const float v = acc[4 * jj + e] * ((e & 1) ? dj.y : dj.x) * l;
          acc[4 * jj + e] = v;
          wsum[r] = fmaf(v, cb[4 * jj + e], wsum[r]);
        }
      }
      split_frags(acc, fh, fl);
      wsum[0] = quad_sum(wsum[0]);
      wsum[1] = quad_sum(wsum[1]);
      if (tg == 0) {
        rt.w_row[gi][r0] = wsum[0];
        rt.w_row[gi][r1] = wsum[1];
      }
      // dC += D B, B read in place as the MN-major B operand
      hopper::fence_operands(grad);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_mn<NB>(grad, fh[kk], mn_major(bs, kk));
        wgmma_rs_mn<NB>(grad, fl[kk], mn_major(bs, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(grad);
      // dC += (dy e) S
      const float er[2] = {hs.e[r0], hs.e[r1]};
      scaled_frags(dys, er[0], er[1], fh, fl, warp, lane);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_mn<NB>(grad, fh[kk], mn_major(sh, kk));
        wgmma_rs_mn<NB>(grad, fh[kk], mn_major(sl, kk));
        wgmma_rs_mn<NB>(grad, fl[kk], mn_major(sh, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(grad);
      // C S^T (depth N, both K-major), for the e term
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk) {
        hopper::wgmma_ss_n64<0, 0>(aux, kmajor(cs, 64, kk), kmajor(sh, 64, kk), kk > 0);
        hopper::wgmma_ss_n64<0, 0>(aux, kmajor(cs, 64, kk), kmajor(sl, 64, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(aux);
      float se[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + 2 * tg;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 yv = tile_pair(dys, r ? r1 : r0, col);
          se[r] = fmaf(yv.x, aux[4 * jj + 2 * r], fmaf(yv.y, aux[4 * jj + 2 * r + 1], se[r]));
        }
      }
      se[0] = quad_sum(se[0]);
      se[1] = quad_sum(se[1]);
      if (tg == 0) {
        rt.e_term[gi][r0] = er[0] * se[0];
        rt.e_term[gi][r1] = er[1] * se[1];
      }
      // <dS, S>: the four tiles share one layout, so element by element
      float dot = 0.f;
      for (int q = tid; q < NB * kBox / 2; q += 128) {
        const float2 a0 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(sh)[q]);
        const float2 a1 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(sl)[q]);
        const float2 b0 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(dsh)[q]);
        const float2 b1 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(dsl)[q]);
        dot = fmaf(a0.x + a1.x, b0.x + b1.x, fmaf(a0.y + a1.y, b0.y + b1.y, dot));
      }
      dot = warp_sum(dot);
      if (lane == 0) rt.ds_s[gi][warp] = dot;
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this warp has read the stage
  }

  // the group's partial of dB (warpgroup 0) or dC (warpgroup 1), rows past S
  // and columns past N not stored
  float* part = wg ? p.dc_part : p.db_part;
  if (part != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      if (row < L) {
        float* out = part + (((long long)b * p.S + t0 + row) * p.parts + grp) * p.N;
#pragma unroll
        for (int jj = 0; jj < 8 * NB; ++jj) {
          const int col = 8 * jj + 2 * tg;
          if (col < p.N)
            *reinterpret_cast<float2*>(out + col) =
                make_float2(grad[4 * jj + 2 * r], grad[4 * jj + 2 * r + 1]);
        }
      }
    }
  }

  // each warp one head: dcum, its reverse cumsum d(dt a), ddt and da's share
  hopper::named_barrier_sync(1, kChunkConsumers);
  if (cw < G) {
    const int h = h0 + cw;
    const HeadScalars& hs = hsc[cw];
    float v0 = rt.w_row[cw][lane] - rt.w_col[cw][lane] + rt.e_term[cw][lane] - rt.t_term[cw][lane];
    float v1 = rt.w_row[cw][32 + lane] - rt.w_col[cw][32 + lane] + rt.e_term[cw][32 + lane] -
               rt.t_term[cw][32 + lane];
    const float t_all = warp_sum(rt.t_term[cw][lane] + rt.t_term[cw][32 + lane]);
    const float s_all = rt.ds_s[cw][0] + rt.ds_s[cw][1] + rt.ds_s[cw][2] + rt.ds_s[cw][3];
    if (lane == 31) v1 += t_all + hs.decay * s_all;  // the cum_Q terms, into the last row
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_down_sync(0xffffffffu, v0, off);
      const float u1 = __shfl_down_sync(0xffffffffu, v1, off);
      if (lane + off < 32) {
        v0 += u0;
        v1 += u1;
      }
    }
    v0 += __shfl_sync(0xffffffffu, v1, 0);
    const float a = p.a[h];
    if (p.ddt != nullptr) {
      if (lane < L) p.ddt[((long long)b * p.S + t0 + lane) * p.H + h] = fmaf(v0, a, rt.du_x[cw][lane]);
      if (32 + lane < L)
        p.ddt[((long long)b * p.S + t0 + 32 + lane) * p.H + h] = fmaf(v1, a, rt.du_x[cw][32 + lane]);
    }
    const float share = warp_sum(fmaf(v0, hs.dt[lane], v1 * hs.dt[32 + lane]));
    if (lane == 0 && p.da_part != nullptr) p.da_part[((long long)b * p.NC + k) * p.H + h] = share;
  }
}

// ---------------------------------------------------------------- launch
constexpr int kTmaError = -1000;  // kTmaError - CUresult: a tensor map the driver refused

// pass 3, where db, dc or da is asked for
template <typename T>
int launch_reduce(const BwdParams& p, cudaStream_t stream) {
  if (p.db || p.dc || p.da) {
    const long long n_out = (long long)p.B * p.S * p.N;
    const long long want = (n_out + kBwdThreads - 1) / kBwdThreads;
    const int blocks = want < 4096 ? (int)want : 4096;
    ssd_bwd_reduce<T><<<blocks, kBwdThreads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const size_t states_bytes = ((size_t)kQ * (p.N + kPad) + (size_t)kQ * (p.pt + kPad) + 3 * kQ) *
                              sizeof(float);
  const size_t chunk_bytes = bwd_chunk_smem_floats(p.N, p.pt) * sizeof(float);
  cudaError_t attr = cudaFuncSetAttribute(ssd_bwd_states<T>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)states_bytes);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(ssd_bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)chunk_bytes);
  if (attr != cudaSuccess) return (int)attr;
  ssd_bwd_states<T><<<dim3(p.P / p.pt, p.H, 2 * p.B), kBwdThreads, states_bytes, stream>>>(p);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  ssd_bwd_chunk<T><<<dim3(p.NC, p.H, p.B), kBwdThreads, chunk_bytes, stream>>>(p);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  return launch_reduce<T>(p, stream);
}

template <int NB>
int launch_bwd_tc(const BwdParams& p, cudaStream_t stream) {
  CUtensorMap tx, tdy, tb, tc, tst, tdst, tst_ld, tdst_ld;
  // x and dy as (P, H, S, B) in boxes of 64 columns of one head by 64 rows; b
  // and c as (N, S, B) in boxes of 64 by 64 rows; the states' planes as (N,
  // P, B H NC 2) in boxes of 64 by 32 rows of P (the walk's stores) or 64
  // (the chunk pass's loads)
  const long long x_dims[4] = {p.P, p.H, p.S, p.B};
  const long long x_strides[3] = {p.P, (long long)p.H * p.P, (long long)p.S * p.H * p.P};
  const int x_box[4] = {64, 1, kQ, 1};
  const long long bc_dims[3] = {p.N, p.S, p.B};
  const long long bc_strides[2] = {p.N, (long long)p.S * p.N};
  const int bc_box[3] = {64, kQ, 1};
  const long long s_dims[3] = {p.N, p.P, 2ll * p.B * p.H * p.NC};
  const long long s_strides[2] = {p.N, (long long)p.P * p.N};
  const int st_box[3] = {64, kBwdPT, 1}, ld_box[3] = {64, 64, 1};
  int rc = hopper::encode_bf16(&tx, p.x, 4, x_dims, x_strides, x_box);
  if (rc == 0) rc = hopper::encode_bf16(&tdy, p.dy, 4, x_dims, x_strides, x_box);
  if (rc == 0) rc = hopper::encode_bf16(&tb, p.b, 3, bc_dims, bc_strides, bc_box);
  if (rc == 0) rc = hopper::encode_bf16(&tc, p.c, 3, bc_dims, bc_strides, bc_box);
  if (rc == 0) rc = hopper::encode_bf16(&tst, p.states, 3, s_dims, s_strides, st_box);
  if (rc == 0) rc = hopper::encode_bf16(&tdst, p.dstates, 3, s_dims, s_strides, st_box);
  if (rc == 0) rc = hopper::encode_bf16(&tst_ld, p.states, 3, s_dims, s_strides, ld_box);
  if (rc == 0) rc = hopper::encode_bf16(&tdst_ld, p.dstates, 3, s_dims, s_strides, ld_box);
  if (rc != 0) return kTmaError - rc;
  cudaError_t attr = cudaFuncSetAttribute(ssd_bwd_walk_tc<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)WalkTiles<NB>::SMEM);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(ssd_bwd_walk_tc<NB>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(ssd_bwd_chunk_tc<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)ChunkTiles<NB>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  ssd_bwd_walk_tc<NB><<<dim3(p.P / p.pt, p.H, 2 * p.B), kTcThreads, WalkTiles<NB>::SMEM, stream>>>(
      tb, tc, tx, tdy, tst, tdst, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_tc<NB><<<dim3(p.NC, p.parts, p.B), kChunkThreads, ChunkTiles<NB>::SMEM, stream>>>(
      tb, tc, tx, tdy, tst_ld, tdst_ld, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce<__nv_bfloat16>(p, stream);
}

template <typename T>
int launch_fma(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.N, p.pt) * sizeof(float);
  const cudaError_t attr =
      cudaFuncSetAttribute(ssd_fwd_fma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  ssd_fwd_fma<T><<<dim3(p.P / p.pt, p.H, p.B), kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_tc(const Params& p, cudaStream_t stream) {
  CUtensorMap tx, tb, tc;
  // x as (P, H, S, B) in boxes of 64 columns of one head by 64 rows; b and c
  // as (N, S, B) in boxes of 64 by 64 rows
  const long long x_dims[4] = {p.P, p.H, p.S, p.B};
  const long long x_strides[3] = {p.P, (long long)p.H * p.P, (long long)p.S * p.H * p.P};
  const int x_box[4] = {64, 1, kQ, 1};
  const long long bc_dims[3] = {p.N, p.S, p.B};
  const long long bc_strides[2] = {p.N, (long long)p.S * p.N};
  const int bc_box[3] = {64, kQ, 1};
  int rc = hopper::encode_bf16(&tx, p.x, 4, x_dims, x_strides, x_box);
  if (rc == 0) rc = hopper::encode_bf16(&tb, p.b, 3, bc_dims, bc_strides, bc_box);
  if (rc == 0) rc = hopper::encode_bf16(&tc, p.c, 3, bc_dims, bc_strides, bc_box);
  if (rc != 0) return kTmaError - rc;
  // all of the SM's shared memory, so that two blocks fit on one
  cudaError_t attr = cudaFuncSetAttribute(ssd_fwd_tc<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)TcTiles<NB>::SMEM);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(ssd_fwd_tc<NB>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  if (attr != cudaSuccess) return (int)attr;
  ssd_fwd_tc<NB><<<dim3(p.P / p.pt, p.H, p.B), kTcThreads, TcTiles<NB>::SMEM, stream>>>(
      tx, tb, tc, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c and y): 0 float32, 1 bfloat16.  tensor_cores: 1 for the
// tensor-core kernel (bfloat16, P and N multiples of 8), 0 for the FMA one.
// All tensors contiguous and 16-byte aligned.  Returns the CUDA error of the
// launch (0 on success), -1 for a dtype this library was not built for, -2
// for a shape the chosen kernel does not take, or -1000 - CUresult for a
// tensor map the driver refused.
extern "C" int ssd_scan_fwd(int dtype, int tensor_cores, const void* x, const void* dt,
                            const void* a, const void* b, const void* c, void* y, void* state,
                            int B, int S, int H, int P, int N, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || N < 4 || N > kMaxN || N % 4 ||
      P < 4 || P % 4 || (P > kMaxPT && P % kMaxPT))
    return -2;
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c, y,
                 static_cast<float*>(state), B, S, H, P, N, P > kMaxPT ? kMaxPT : P};
  if (P / p.pt > 65535) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != 1 || P % 8 || N % 8) return -2;
    return N > 64 ? launch_tc<2>(p, st) : launch_tc<1>(p, st);
  }
  return dtype == 1 ? launch_fma<__nv_bfloat16>(p, st) : launch_fma<float>(p, st);
}

// The backward of ssd_scan_fwd for the cotangents dy [B, S, H, P] (x's
// dtype) and dstate [B, H, P, N] (float32, or null for zeros).  dtype as
// above, for x, b, c, dy, dx, db and dc; dt, a, ddt, da and the scratch in
// float32.  tensor_cores: 1 for the wgmma route (bfloat16, P <= 64, P and N
// multiples of 8), 0 for the FMA one.  parts: the partials of dB and dC per
// row, H on the FMA route and H / G on the wgmma route, whose blocks take G
// <= 8 heads each.  The scratch: states and dstates [B, H, ceil(S / 64), P,
// N] (fp32; two bf16 planes per state on the wgmma route); db_part and
// dc_part [B, S, parts, N] (each null where db, dc is); da_part [B, ceil(S /
// 64), H] (null where da is).  A null output is not computed.  All tensors
// contiguous; the outputs and scratch 16-byte aligned.  Returns as
// ssd_scan_fwd.
extern "C" int ssd_scan_bwd(int dtype, int tensor_cores, const void* x, const void* dt,
                            const void* a, const void* b, const void* c, const void* dy,
                            const void* dstate, void* states, void* dstates, void* dx, void* ddt,
                            void* db_part, void* dc_part, void* da_part, void* db, void* dc,
                            void* da, int B, int S, int H, int P, int N, int parts, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const int NC = S < 1 ? 0 : (S + kQ - 1) / kQ;
  if (B < 1 || S < 1 || H < 1 || 2 * B > 65535 || H > 65535 || N < 4 || N > kMaxN || N % 4 ||
      P < 4 || P % 4 || (P > kBwdPT && P % kBwdPT) || (db && !db_part) || (dc && !dc_part) ||
      (da && !da_part) || parts < 1 || H % parts)
    return -2;
  const BwdParams p{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c, dy,
                    static_cast<const float*>(dstate), static_cast<float*>(states),
                    static_cast<float*>(dstates), dx, static_cast<float*>(ddt),
                    static_cast<float*>(db_part), static_cast<float*>(dc_part),
                    static_cast<float*>(da_part), db, dc, static_cast<float*>(da),
                    B, S, H, P, N, NC, P > kBwdPT ? kBwdPT : P, parts};
  if (P / p.pt > 65535) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != 1 || P % 8 || N % 8 || P > 64 || H / parts > kMaxG) return -2;
    return N > 64 ? launch_bwd_tc<2>(p, st) : launch_bwd_tc<1>(p, st);
  }
  if (parts != H) return -2;
  return dtype == 1 ? launch_bwd<__nv_bfloat16>(p, st) : launch_bwd<float>(p, st);
}

extern "C" const char* ssd_scan_error_string(int code) {
  static thread_local char msg[96];
  if (code == -1) return "dtype not built";
  if (code == -2) return "shape outside the chosen kernel's limits";
  if (code <= kTmaError) {
    snprintf(msg, sizeof msg, "tensor map refused by the driver (CUresult %d)", kTmaError - code);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}
