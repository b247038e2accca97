// Flash attention for Hopper (sm_90a), causal, sliding-window, GQA: the
// forward, and below it the backward (its own note).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_flash_kernel
// (driven by flash_attention_bhsd there).  It computes the same function: an
// online softmax over KV tiles with the running max, normaliser and
// accumulator kept in fp32; the scale the caller passes (d^-0.5); causal and
// sliding-window masks; KV tiles that no row of the query tile may attend to
// are skipped; the output is acc / l with l == 0 guarded.  Given an lse
// buffer (training), it also writes each row's logsumexp of the scaled
// scores, which the backward reads.
//
// What bounds it on this card.  Causal prefill does about 2*B*H*S^2*D
// operations (the causal half of Q K^T and of P V) and must move
// (2*H + 2*KV)*B*S*D elements (q, k, v read once, o written once).  At the
// served shapes (internlm2-1.8b: H 16, KV 8, D 128; granite-moe: D 64; bf16)
// the operations over 989 TFLOP/s outweigh the bytes over 3.35 TB/s once S
// passes about 900 (D 128).  Below those bounds sit two more: every block
// streams each K/V tile it needs from L2 (64 KB per 128 x 128 tile step at
// D 128: 128 operations per byte read, which the L2's bandwidth does not
// sustain at the tensor cores' rate), and the softmax, whose 16 K
// exponentials per step take as long on the special-function units (16 a
// cycle per SM) as the step's products at D 64 take on the tensor cores.
//
// What the design does about that (bf16).  Only wgmma reaches the tensor
// cores' full rate, and it wants its operands in swizzled shared memory, fed
// without the threads' help.  One block takes 128 query rows of one (batch,
// head): warpgroups 0 and 1 (64 rows each) compute, warpgroup 2 loads.  One
// thread of the loader brings Q once and then K and V tiles of 128 keys
// through a ring of stages (3 at D > 64, 6 at D <= 64) with TMA, K and V
// each completing on an mbarrier, a stage released by the consumers on
// another, so later tiles stream in while this one is computed.  S = Q K^T
// is a wgmma with both operands K-major in shared memory; P, converted to
// bf16 in registers, is the A operand of O += P V, and V is read in place as
// an MN-major B operand (the transpose bit): nothing is transposed or staged
// by the threads.  S and O stay in registers (setmaxnreg gives the
// consumers 240 and the loader 24).  Each warpgroup issues S_i = Q K_i^T and
// O += P_{i-1} V_{i-1} together and runs the softmax of tile i while they
// run; the two warpgroups take turns at issuing (named barriers), so one's
// softmax overlaps the other's products.  The exponentials are single
// ex2.approx instructions with the scale folded into one FMA.  The mask is
// computed only on tiles that cross the diagonal, the window's edge or Skv;
// tiles wholly masked for the block are skipped; the query tiles are the
// grid's slow dimension, heaviest first.  O / l goes through shared memory
// (Q's rows, no longer read) to one TMA store per warpgroup.
//
// Tried on the H100 and dropped: a cluster of two blocks (the two query heads
// of a kv head) multicasting each K/V tile, which halves the L2 reads, was
// slower; Q in registers, 192-key tiles at D 64, and separate K and V
// releases were no faster.
//
// Head dims.  The 128-byte swizzle spans 64 bf16, so Q, K, V and O move as
// 64-column boxes: one at D <= 64, two at D > 64.  The columns past D
// (D 32, 80, 96) are zero-filled by TMA and cost math, never a wrong
// number: a zero column adds 0 to every score, and its output column is
// clipped by the store.  Rows past S and keys past Skv also load as zeros; a
// zero key still scores 0, so keys past Skv are masked, and rows past S are
// clipped.
//
// The fp32 kernel, used where the model computes in fp32 (parity runs and
// tests), runs on the FMA units as before: TF32 tensor cores would not hold
// fp32's tolerance.
//
// Layout.  q and o are [B, S, H, D], k and v [B, Skv, KV, D], read through
// their strides with the last dim contiguous, so the caller needs no
// transpose copy: the tensor maps are 4-D (D, heads, S, B) over the
// caller's strides (TMA takes any strides that are multiples of 16 bytes).
// GQA maps query head h to kv head h / (H / KV).  The caller guarantees
// 16-byte aligned rows and strides (ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "../../common/csrc/hopper.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, S] fp32, each row's logsumexp of the scaled scores, or null
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, H, KV, S, Skv;
  float scale;
  int causal, window;
};

// The KV tiles [*t_begin, *t_end) that hold a key some row of the query tile
// [q0, q0 + rows) attends to: the block-level pruning of the TPU kernel.
__device__ __forceinline__ void kv_tile_range(const Params& p, int q0, int rows, int bk,
                                              int* t_begin, int* t_end) {
  const int q_last = min(q0 + rows, p.S) - 1;
  int k_begin = 0, k_end = p.Skv;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  *t_begin = k_begin / bk;
  *t_end = k_end > k_begin ? (k_end + bk - 1) / bk : *t_begin;
}

__device__ __forceinline__ bool attends(const Params& p, int row, int col) {
  return col < p.Skv && (!p.causal || col <= row) && (p.window <= 0 || row - col < p.window);
}

// reductions over the four lanes that share one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// exponentials are hopper::fast_exp2 (subnormal results flush to 0: a weight
// below 2^-126 of the row's largest adds nothing in fp32)
using hopper::fast_exp2;
using hopper::pack_bf16;

// ---------------------------------------------------------------- bf16
constexpr int kBQ = 128;        // query rows per block: 64 per consumer warpgroup
constexpr int kBK = 128;        // keys per tile
constexpr int kConsumers = 256;  // warpgroups 0 and 1
constexpr int kThreads = 384;    // and the loader, warpgroup 2

template <int D>
struct Tiles {
  static constexpr int DP = D <= 64 ? 64 : 128;  // D in 64-column boxes, zero-filled past D
  static constexpr int BOXES = DP / 64;
  static constexpr int STAGES = DP == 64 ? 6 : 3;
  static constexpr int Q_ELEMS = kBQ * DP;
  static constexpr int KV_ELEMS = kBK * DP;  // one of K or V in one stage
  static constexpr size_t SMEM = 2 * (Q_ELEMS + 2 * STAGES * KV_ELEMS) + 1024;  // + alignment
};

// S = Q K^T for one tile: 64 rows of this warpgroup x 128 keys, depth DP in
// steps of 16 (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], const __nv_bfloat16* q_wg,
                                         const __nv_bfloat16* ks) {
#pragma unroll
  for (int kk = 0; kk < Tiles<D>::DP / 16; ++kk) {
    const int box = kk / 4, step = (kk % 4) * 16;  // 64-column box, 32 bytes a step
    const uint64_t da = hopper::desc_sw128(q_wg + box * kBQ * 64 + step, 16, 1024);
    const uint64_t db = hopper::desc_sw128(ks + box * kBK * 64 + step, 16, 1024);
    hopper::wgmma_ss_n128<0, 0>(sc, da, db, kk > 0);
  }
}

// O += P V for one tile: V [keys][DP] read in place as an MN-major operand
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Tiles<D>::DP / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         const __nv_bfloat16* vs) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = hopper::desc_sw128(vs + kk * 16 * 64, 2 * kBK * 64, 1024);
    if constexpr (Tiles<D>::DP == 64)
      hopper::wgmma_rs_n64<1>(o, pa[kk], db, 1);
    else
      hopper::wgmma_rs_n128<1>(o, pa[kk], db, 1);
  }
}

// The online softmax of one score tile, in place: raw scores in, P (fp32)
// out; m (raw units) and l updated; returns in alpha the factor by which
// the rows' earlier sums shrink.  The mask is applied only where ``edge``.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& p, bool edge,
                                             int row0, int col0, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!attends(p, row0 + 8 * (e >> 1), col0 + 8 * j + (e & 1))) sc[4 * j + e] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  }
  float nb[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    const float base = mx[r] == -INFINITY ? 0.f : mx[r];  // every key so far masked
    alpha[r] = fast_exp2((m[r] - base) * scale_log2);
    nb[r] = -base * scale_log2;
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = fast_exp2(fmaf(sc[4 * j + e], scale_log2, nb[e >> 1]));
      sc[4 * j + e] = pr;
      rs[e >> 1] += pr;
    }
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// An accumulator of N columns in bf16 as the A fragments of a product whose
// depth is those columns (P of P V): k-step kk takes columns 16kk.., i.e.
// its n8 tiles 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&pa)[N / 16][4], const float (&sc)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(sc[4 * j + 0], sc[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// Shared memory, from a 1024-byte boundary: Q as BOXES boxes [kBQ][64], then
// per stage K as BOXES boxes [kBK][64] and V the same, all 128-byte swizzled.
// K and V of a stage complete on barriers of their own, so S = Q K^T of a
// tile may start before its V has landed.
//
// In step i a consumer warpgroup issues S_i = Q K_i^T and then
// O += P_{i-1} V_{i-1}, waits for S_i only, runs the softmax of tile i while
// P V runs, then waits for P V, releases the stage of tile i - 1 and
// rescales O.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   const Params p) {
  using T = Tiles<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[T::STAGES], v_full[T::STAGES],
      kv_empty[T::STAGES];
  bf16* Qs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* KVs = Qs + T::Q_ELEMS;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  int t_begin, t_end;
  kv_tile_range(p, q0, kBQ, kBK, &t_begin, &t_end);

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&kv_empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ loader warpgroup
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::mbar_arrive_expect_tx(&q_full, 2 * T::Q_ELEMS);
#pragma unroll
      for (int c = 0; c < T::BOXES; ++c)
        hopper::tma_load_4d(Qs + c * kBQ * 64, &tq, &q_full, 64 * c, h, q0, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % T::STAGES;
        hopper::mbar_wait(&kv_empty[s], ((i / T::STAGES) & 1) ^ 1);
        bf16* ks = KVs + s * 2 * T::KV_ELEMS;
        bf16* vs = ks + T::KV_ELEMS;
        hopper::mbar_arrive_expect_tx(&k_full[s], 2 * T::KV_ELEMS);
#pragma unroll
        for (int c = 0; c < T::BOXES; ++c)
          hopper::tma_load_4d(ks + c * kBK * 64, &tk, &k_full[s], 64 * c, kvh, t * kBK, b);
        hopper::mbar_arrive_expect_tx(&v_full[s], 2 * T::KV_ELEMS);
#pragma unroll
        for (int c = 0; c < T::BOXES; ++c)
          hopper::tma_load_4d(vs + c * kBK * 64, &tv, &v_full[s], 64 * c, kvh, t * kBK, b);
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    hopper::setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
    const int wq0 = q0 + 64 * wg;            // this warpgroup's first row
    const int row0 = wq0 + 16 * warp + g;    // this lane's rows: row0 and row0 + 8
    const float scale_log2 = p.scale * 1.4426950408889634f;
    const bf16* q_wg = Qs + 64 * wg * 64;
    // masks only where the tile crosses an edge for this warpgroup's rows
    auto edge = [&](int t) {
      const int k0 = t * kBK;
      return k0 + kBK > p.Skv || (p.causal && k0 + kBK - 1 > wq0) ||
             (p.window > 0 && wq0 + 63 - k0 >= p.window);
    };
    auto keys = [&](int i) { return KVs + (i % T::STAGES) * 2 * T::KV_ELEMS; };
    auto values = [&](int i) { return keys(i) + T::KV_ELEMS; };
    auto parity = [](int i) { return (uint32_t)((i / T::STAGES) & 1); };
    auto release = [&](int i) {  // one arrival per warp on the stage's barrier
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&kv_empty[i % T::STAGES]);
    };

    float o[T::DP / 2];
#pragma unroll
    for (int i = 0; i < T::DP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
    float l[2] = {0.f, 0.f};              // this lane's part of the normaliser
    float sc[kBK / 2], alpha[2];
    uint32_t pa[kBK / 16][4];

    // The two warpgroups take turns at issuing their products (named barriers
    // 1 and 2): while one runs its softmax, the other's products keep the
    // tensor cores busy.  Warpgroup 0 goes first; warpgroup 1 owes no turn
    // after its last.
    const int n = t_end - t_begin;
    auto my_turn = [&] { hopper::named_barrier_sync(1 + wg, kConsumers); };
    auto pass_turn = [&](bool last) {
      if (!(last && wg == 1)) hopper::named_barrier_arrive(2 - wg, kConsumers);
    };
    if (wg == 1 && n > 0) hopper::named_barrier_arrive(1, kConsumers);

    hopper::mbar_wait(&q_full, 0);
    if (n > 0) {
      hopper::mbar_wait(&k_full[0], 0);
      my_turn();
      hopper::wgmma_fence();
      issue_qk<D>(sc, q_wg, keys(0));
      hopper::wgmma_commit();
      pass_turn(false);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sc);
      softmax_tile(sc, m, l, alpha, p, edge(t_begin), row0, t_begin * kBK + 2 * tg, scale_log2);
      pack_frags<kBK>(pa, sc);
    }
    for (int i = 1; i < n; ++i) {
      const int t = t_begin + i;
      hopper::mbar_wait(&k_full[i % T::STAGES], parity(i));
      hopper::mbar_wait(&v_full[(i - 1) % T::STAGES], parity(i - 1));
      my_turn();
      hopper::fence_operands(o);
      hopper::wgmma_fence();
      issue_qk<D>(sc, q_wg, keys(i));
      hopper::wgmma_commit();
      issue_pv<D>(o, pa, values(i - 1));
      hopper::wgmma_commit();
      pass_turn(false);
      hopper::wgmma_wait<1>();  // S_i has landed; P V of tile i - 1 still runs
      hopper::fence_operands(sc);
      softmax_tile(sc, m, l, alpha, p, edge(t), row0, t * kBK + 2 * tg, scale_log2);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) hopper::fence_operands(pa[kk]);
      release(i - 1);
#pragma unroll
      for (int j = 0; j < T::DP / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      pack_frags<kBK>(pa, sc);
    }
    if (n > 0) {
      hopper::mbar_wait(&v_full[(n - 1) % T::STAGES], parity(n - 1));
      my_turn();
      hopper::fence_operands(o);
      hopper::wgmma_fence();
      issue_pv<D>(o, pa, values(n - 1));
      hopper::wgmma_commit();
      pass_turn(true);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) hopper::fence_operands(pa[kk]);
      release(n - 1);
    }

    // O / l into this warpgroup's rows of the Q tile, which nothing reads any
    // more, in TMA's swizzle; then one thread stores them (rows past S and
    // columns past D are clipped)
    const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
    if (p.lse != nullptr && tg == 0) {
      // m is the raw scores' max and l sums exp2((s - m) scale log2 e), so the
      // natural logsumexp of the scaled scores is scale m + ln l (+inf for a
      // row that attends no key, whose O is 0: the backward's P is then 0)
      float* lse = p.lse + ((long long)b * p.H + h) * p.S;
      if (row0 < p.S) lse[row0] = l0 == 0.f ? INFINITY : fmaf(m[0], p.scale, logf(l0));
      if (row0 + 8 < p.S) lse[row0 + 8] = l1 == 0.f ? INFINITY : fmaf(m[1], p.scale, logf(l1));
    }
    bf16* ob = Qs + 64 * wg * 64;
    const int r = 16 * warp + g;
#pragma unroll
    for (int j = 0; j < T::DP / 8; ++j) {
      bf16* box = ob + (j / 8) * kBQ * 64;
      const int col = (8 * j) % 64 + 2 * tg;
      *reinterpret_cast<uint32_t*>(box + hopper::sw128_offset(r, col)) =
          pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
      *reinterpret_cast<uint32_t*>(box + hopper::sw128_offset(r + 8, col)) =
          pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(3 + wg, 128);  // this warpgroup's rows are written
    if (tid == 0 && wq0 < p.S) {
#pragma unroll
      for (int c = 0; c < T::BOXES; ++c) hopper::tma_store_4d(&to, ob + c * kBQ * 64, 64 * c, h, wq0, b);
      hopper::bulk_commit();
      hopper::bulk_wait<0, false>();
    }
  }
}

// ---------------------------------------------------------------- fp32
constexpr int kFBQ = 64;  // query rows per block
constexpr int kFBK = 32;  // keys per tile
constexpr int kFThreads = 256;  // four lanes per query row

template <int D>
__global__ void __launch_bounds__(kFThreads) flash_fwd_f32(const Params p) {
  constexpr int LDQ = D + 1;      // odd pitch: the rows a warp reads fall in distinct banks
  constexpr int LDP = kFBK + 1;
  constexpr int NC = kFBK / 4;    // score columns per lane
  constexpr int NDV = D / 4;      // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kFBQ][LDQ]
  float* Ks = Qs + kFBQ * LDQ;                 // [kFBK][LDQ]
  float* Vs = Ks + kFBK * LDQ;                 // [kFBK][D]
  float* Ps = Vs + kFBK * D;                   // [kFBQ][LDP]

  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;  // lane owns row r, columns sub + 4j
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kFBQ;
  const int row = q0 + r;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kFBQ * (D / 4); i += kFThreads) {
    const int rr = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + rr < p.S) val = *reinterpret_cast<const float4*>(qg + (q0 + rr) * p.q_ss + c);
    float* dst = Qs + rr * LDQ + c;
    dst[0] = val.x;
    dst[1] = val.y;
    dst[2] = val.z;
    dst[3] = val.w;
  }

  float acc[NDV];
#pragma unroll
  for (int n = 0; n < NDV; ++n) acc[n] = 0.f;
  float m = -INFINITY, l = 0.f;

  int t_begin, t_end;
  kv_tile_range(p, q0, kFBQ, kFBK, &t_begin, &t_end);
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kFBK;
    __syncthreads();  // Q is staged, and the previous tile is consumed
    for (int i = tid; i < kFBK * (D / 4); i += kFThreads) {
      const int rr = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kk4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kk4;
      if (k0 + rr < p.Skv) {
        kk4 = *reinterpret_cast<const float4*>(kg + (k0 + rr) * p.k_ss + c);
        vv4 = *reinterpret_cast<const float4*>(vg + (k0 + rr) * p.v_ss + c);
      }
      float* kd = Ks + rr * LDQ + c;
      kd[0] = kk4.x;
      kd[1] = kk4.y;
      kd[2] = kk4.z;
      kd[3] = kk4.w;
      *reinterpret_cast<float4*>(Vs + rr * D + c) = vv4;
    }
    __syncthreads();

    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * LDQ + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] = fmaf(qd, Ks[(sub + 4 * j) * LDQ + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float x = attends(p, row, k0 + sub + 4 * j) ? s[j] * p.scale : -INFINITY;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = quad_max(mx);
    const float base = mx == -INFINITY ? 0.f : mx;
    const float alpha = expf(m - base);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float pr = expf(s[j] - base);
      Ps[r * LDP + sub + 4 * j] = pr;
      rs += pr;
    }
    l = l * alpha + rs;
#pragma unroll
    for (int n = 0; n < NDV; ++n) acc[n] *= alpha;
    __syncwarp();  // the row's four lanes share one warp
    for (int j = 0; j < kFBK; ++j) {
      const float pj = Ps[r * LDP + j];
#pragma unroll
      for (int n = 0; n < NDV; ++n) acc[n] = fmaf(pj, Vs[j * D + sub + 4 * n], acc[n]);
    }
  }

  const float lt = quad_sum(l);
  const float den = lt == 0.f ? 1.f : lt;
  if (p.lse != nullptr && sub == 0 && row < p.S)  // m and the scores here are scaled
    p.lse[((long long)b * p.H + h) * p.S + row] = lt == 0.f ? INFINITY : m + logf(lt);
  if (row < p.S) {
    float* orow = og + row * p.o_ss + sub;
#pragma unroll
    for (int n = 0; n < NDV; ++n) orow[4 * n] = acc[n] / den;
  }
}

// ================================================================ backward
// Flash attention backward: dq, dk and dv, with no S x S matrix in memory.
//
// Replaces the JAX package's custom VJP of the flash kernel,
// src/repro/kernels/flash_attention/ops.py::_flash_bwd, which is jax.vjp of
// the dense reference_attention (a recompute that builds the S x S scores).
// It computes the same function by the formulas of that VJP, from q, k, v,
// the forward's o and its logsumexp rows (lse, natural log of the scaled
// scores): delta = rowsum(dO o); P = exp(scale Q K^T - lse), masked as the
// forward masks; dV = P^T dO; dS = P (dO V^T - delta); dQ = scale dS K;
// dK = scale dS^T Q; dK and dV summed over the query heads of a GQA group.
//
// What bounds it on this card.  At the train shape (bf16 B 8, S 256, H 16,
// KV 8, D 128, causal) it must read q, k, v, o, dO and lse and write dq, dk
// and dv once: 50.5 MB, 0.0151 ms at 3.35 TB/s; its five products over the
// 32,896 attended pairs per (batch, head) are 5.4 GFLOP, 0.0054 ms at 989
// TFLOP/s.  So bytes bound it, as the forward at this shape; below that
// sit the recomputed products (S and dP are computed twice, once by each
// kind of block: 7.5 GFLOP in all), the balance of unequal blocks over 132
// SMs and the latency of one dependent chain of products per tile.
//
// Design.  Two launches, no float atomics, so two passes give the same
// bits.  (1) flash_bwd_prep, one warp per row: delta and lse log2(e) into
// fp32 scratch padded to a multiple of 128 rows (+inf and 0 past S, which
// zero P there), so the tiles come by bulk copies.  (2) One grid of two
// kinds of blocks, which write disjoint outputs: a dK/dV block per 128 keys
// of a (kv head, batch) walks the group's query heads and the query tiles
// that reach its keys (q_tile_range, the transpose of the forward's
// kv_tile_range) in a fixed order, holding dK and dV in registers: it
// computes S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T sit in
// registers as the A operand of dV += P^T dO and dK += dS^T Q.  A dQ block
// per 128 query rows of a (head, batch) walks the key tiles that its rows
// reach, as the forward does, computing S and dP again and dQ += dS K.
// Under the causal mask the blocks are unequal (at the train shape a dK/dV
// block walks 8 or 4 query tiles, a dQ block 4 or 2 key tiles): as two
// launches the dK/dV grid was one wave of 128 blocks set by its heaviest
// and the dQ grid two uneven waves, each launch draining the card.  In one
// grid the blocks run in their natural order (dK/dV by key block, then dQ
// from the last query tile down), which at the train shapes is heaviest
// first across both kinds, so the light ones fill the tail.  The grid is
// launched with programmatic dependent launch behind the pre-pass: its
// blocks set up their barriers and load K, V, Q and dO while the pre-pass
// runs, and the loader waits (griddepcontrol.wait) only before it reads
// lse2 and delta.  The bf16 blocks run on wgmma with TMA tiles through an mbarrier ring and setmaxnreg, as the forward; P and dS
// enter the tensor cores in bf16 (their fp32 values rounded once), every
// sum is fp32.  The fp32 kernels (parity runs and tests) stay two launches
// on the FMA units, four lanes per row, as the fp32 forward.
//
// Weighed and not built: dQ in the dK/dV blocks, through dS in shared
// memory summed across key blocks, needs float atomics (run-to-run bits) or
// per-key-tile partials and a reduction (33.5 MB more traffic at the train
// shape, twice this kernel's bytes bound); recomputing S and dP costs 2 of
// 7 products instead.  On an H100 80GB HBM3 (700 W) at the train shape the
// three launches took 0.064 ms at D 128 and 0.049 ms at D 64 (0.80x and
// 1.01-1.03x SDPA's backward); the one grid 0.056 and 0.044 ms (0.70-0.71x
// and 0.89-0.91x; chip_smoke.py, PERF.md).  The per-tile chain (products,
// wait, softmax terms, products, wait) is not yet overlapped across tiles
// as the forward's is.

struct BwdParams {
  Params f;          // q, k, v, o (read), their strides, the shape, scale, masks
  const float* lse;  // [B, H, S] from the forward
  const void* dout;  // dO [B, S, H, D]
  void* dq;          // [B, S, H, D], or null: not computed
  void* dk;          // [B, Skv, KV, D], or null: not stored
  void* dv;          // the same
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float* lse2;   // [B, H, S_pad] scratch: lse * log2(e), +inf past S
  float* delta;  // [B, H, S_pad] scratch: rowsum(dO * O), 0 past S
  int S_pad, D;
};

constexpr float kLog2e = 1.4426950408889634f;

// The query tiles [*t_begin, *t_end) that hold a row attending to some key
// of [k0, k0 + keys): the transpose of kv_tile_range.
__device__ __forceinline__ void q_tile_range(const Params& p, int k0, int keys, int bq,
                                             int* t_begin, int* t_end) {
  const int k_last = min(k0 + keys, p.Skv) - 1;
  int q_begin = 0, q_end = p.S;
  if (p.causal) q_begin = k0;
  if (p.window > 0) q_end = min(q_end, k_last + p.window);
  *t_begin = q_begin / bq;
  *t_end = q_end > q_begin ? (q_end + bq - 1) / bq : *t_begin;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Programmatic dependent launch: the pre-pass lets the backward grid start
// at once (its blocks set up their barriers and load K, V, Q and dO), and
// the backward's loader waits for the pre-pass to finish before it reads
// lse2 and delta.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The pre-pass: delta = rowsum(dO * O) in fp32 and lse2 = lse log2(e), each
// [B, H, S_pad], with the rows past S padded (delta 0, lse2 +inf, so that
// P = 2^(s scale log2 e - lse2) is 0 there).  One warp per row.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_prep(const BwdParams bp) {
  griddep_launch_dependents();
  const Params& p = bp.f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + warp;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  float dot = 0.f, l2 = INFINITY;
  if (row < p.S) {
    const T* o = static_cast<const T*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh;
    const T* g = static_cast<const T*>(bp.dout) + b * bp.do_sb + row * bp.do_ss + h * bp.do_sh;
    for (int d = lane; d < bp.D; d += 32) dot = fmaf(to_float(o[d]), to_float(g[d]), dot);
    l2 = bp.lse[(long long)bh * p.S + row] * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (lane == 0 && row < bp.S_pad) {
    const long long i = (long long)bh * bp.S_pad + row;
    bp.delta[i] = dot;
    bp.lse2[i] = l2;
  }
}

// ---------------------------------------------------------------- bf16 backward
constexpr int kBKb = 128;  // dK/dV: keys per block, 64 per consumer warpgroup
constexpr int kBQb = 64;   // dK/dV: query rows per tile
constexpr int kBQd = 128;  // dQ: query rows per block, 64 per consumer warpgroup
constexpr int kBKd = 64;   // dQ: keys per tile

template <int D>
struct BwdTiles {
  static constexpr int DP = Tiles<D>::DP;
  static constexpr int BOXES = Tiles<D>::BOXES;
  // dK/dV: K and V of the block once, then a ring of (Q, dO) query tiles
  static constexpr int KV_ELEMS = kBKb * DP;
  static constexpr int QT_ELEMS = kBQb * DP;
  static constexpr int STAGES = DP == 64 ? 5 : 3;
  static constexpr size_t SMEM_KV = 2 * (2 * KV_ELEMS + 2 * STAGES * QT_ELEMS) + 1024;
  // dQ: Q and dO of the block once, then a ring of (K, V) key tiles
  static constexpr int Q_ELEMS = kBQd * DP;
  static constexpr int KT_ELEMS = kBKd * DP;
  static constexpr int DQ_STAGES = DP == 64 ? 6 : 3;
  static constexpr size_t SMEM_Q = 2 * (2 * Q_ELEMS + 2 * DQ_STAGES * KT_ELEMS) + 1024;
};

// acc[64 x 64] = A B^T over depth DP, both operands K-major in shared memory
// in 64-column boxes: A is this warpgroup's 64 rows of a tile whose boxes
// hold ``a_box`` elements, B a tile of 64 rows (issued, not waited for)
template <int DP>
__device__ __forceinline__ void issue_abt(float (&acc)[32], const __nv_bfloat16* a, int a_box,
                                          const __nv_bfloat16* bt) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int box = kk / 4, step = (kk % 4) * 16;
    const uint64_t da = hopper::desc_sw128(a + box * a_box + step, 16, 1024);
    const uint64_t db = hopper::desc_sw128(bt + box * 64 * 64 + step, 16, 1024);
    hopper::wgmma_ss_n64<0, 0>(acc, da, db, kk > 0);
  }
}

// acc[64 x DP] += A B, A [64 x 64] from registers (fragments of an
// accumulator), B a tile of 64 rows of depth x DP columns read in place as an
// MN-major operand (as V in the forward's P V)
template <int DP>
__device__ __forceinline__ void issue_ab(float (&acc)[DP / 2], const uint32_t (&fr)[4][4],
                                         const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = hopper::desc_sw128(b + kk * 16 * 64, 2 * 64 * 64, 1024);
    if constexpr (DP == 64)
      hopper::wgmma_rs_n64<1>(acc, fr[kk], db, 1);
    else
      hopper::wgmma_rs_n128<1>(acc, fr[kk], db, 1);
  }
}

// 64 x DP fp32 accumulator rows (this warpgroup's) times ``mul`` in bf16 into
// rows [0, 64) of a tile of 64-column boxes of ``box_elems`` elements, in
// TMA's swizzle
template <int DP>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* rows, int box_elems,
                                           const float (&acc)[DP / 2], float mul, int warp, int g,
                                           int tg) {
  const int r = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    __nv_bfloat16* box = rows + (j / 8) * box_elems;
    const int col = (8 * j) % 64 + 2 * tg;
    *reinterpret_cast<uint32_t*>(box + hopper::sw128_offset(r, col)) =
        pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(box + hopper::sw128_offset(r + 8, col)) =
        pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// ``rows`` rows (a multiple of 64) of one head from ``row0``, as boxes of 64
// rows by 64 columns: the tensor maps of the backward all take 64-row boxes,
// and a tile of 128 rows is two of them, one after the other
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int col, int head, int row0, int b,
                                          int rows) {
  for (int r = 0; r < rows; r += 64)
    hopper::tma_load_4d(dst + r * 64, map, bar, col, head, row0 + r, b);
}

// dK and dV of 128 keys [k0, k0 + 128) of one (kv head, batch): warpgroups
// 0 and 1 computing 64 keys each, warpgroup 2 loading.  K and V come once;
// then for each query head of the group and each 64-row query tile that
// reaches these keys, in that order, Q, dO and the tile's lse2 and delta
// rows come through a ring of stages.  Per tile a warpgroup computes
// S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major in shared
// memory), then in registers P^T = 2^(S^T scale log2 e - lse2) (masked) and
// dS^T = P^T (dP^T - delta), and adds dV += P^T dO and dK += dS^T Q with
// P^T and dS^T as bf16 A fragments and dO and Q read in place as MN-major B
// operands.  dK and dV stay in fp32 registers over the whole walk (no
// atomics: each key's sums are one block's, in a fixed order); at the end
// they go through shared memory (this warpgroup's rows of K and V, which
// only it reads) to TMA stores.
template <int D>
__device__ __forceinline__ void bwd_dkdv(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const CUtensorMap* tdo,
                                         const CUtensorMap* tdk, const CUtensorMap* tdv,
                                         const BwdParams& bp, int b, int kvh, int kb) {
  using T = BwdTiles<D>;
  using bf16 = __nv_bfloat16;
  const Params& p = bp.f;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[T::STAGES], empty[T::STAGES];
  __shared__ __align__(16) float lse_s[T::STAGES][kBQb], dl_s[T::STAGES][kBQb];
  bf16* Ks = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Vs = Ks + T::KV_ELEMS;
  bf16* QOs = Vs + T::KV_ELEMS;  // per stage: Q, then dO

  const int group = p.H / p.KV;
  const int k0 = kb * kBKb;
  int t_begin, t_end;
  q_tile_range(p, k0, kBKb, kBQb, &t_begin, &t_end);
  const int per_head = t_end - t_begin, n = group * per_head;
  auto head = [&](int i) { return kvh * group + i / per_head; };
  auto first_row = [&](int i) { return (t_begin + i % per_head) * kBQb; };

  if (threadIdx.x == 0) {
    hopper::mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ loader warpgroup
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch(tq);
      hopper::tma_prefetch(tk);
      hopper::tma_prefetch(tv);
      hopper::tma_prefetch(tdo);
      hopper::mbar_arrive_expect_tx(&kv_full, 2 * 2 * T::KV_ELEMS);
#pragma unroll
      for (int c = 0; c < T::BOXES; ++c) {
        load_rows(Ks + c * kBKb * 64, tk, &kv_full, 64 * c, kvh, k0, b, kBKb);
        load_rows(Vs + c * kBKb * 64, tv, &kv_full, 64 * c, kvh, k0, b, kBKb);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % T::STAGES, h = head(i), q0 = first_row(i);
        hopper::mbar_wait(&empty[s], ((i / T::STAGES) & 1) ^ 1);
        bf16* qs = QOs + s * 2 * T::QT_ELEMS;
        bf16* dos = qs + T::QT_ELEMS;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * 2 * T::QT_ELEMS + 2 * kBQb * 4);
#pragma unroll
        for (int c = 0; c < T::BOXES; ++c) {
          hopper::tma_load_4d(qs + c * kBQb * 64, tq, &full[s], 64 * c, h, q0, b);
          hopper::tma_load_4d(dos + c * kBQb * 64, tdo, &full[s], 64 * c, h, q0, b);
        }
        if (i == 0) griddep_wait();  // lse2 and delta are the pre-pass's
        const long long off = ((long long)b * p.H + h) * bp.S_pad + q0;
        hopper::bulk_load(lse_s[s], bp.lse2 + off, kBQb * 4, &full[s]);
        hopper::bulk_load(dl_s[s], bp.delta + off, kBQb * 4, &full[s]);
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    hopper::setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
    const int kw0 = k0 + 64 * wg;           // this warpgroup's first key
    const int kr0 = kw0 + 16 * warp + g;    // this lane's keys: kr0 and kr0 + 8
    const float scale_log2 = p.scale * kLog2e;
    bf16* k_wg = Ks + 64 * wg * 64;
    bf16* v_wg = Vs + 64 * wg * 64;
    // masks only where the query tile crosses an edge for this warpgroup's keys
    auto edge = [&](int q0) {
      return kw0 + 64 > p.Skv || (p.causal && kw0 + 63 > q0) ||
             (p.window > 0 && q0 + kBQb - 1 - kw0 >= p.window);
    };

    float dv[T::DP / 2], dk[T::DP / 2];
#pragma unroll
    for (int i = 0; i < T::DP / 2; ++i) dv[i] = dk[i] = 0.f;
    float st[32], dpt[32];
    uint32_t pa[4][4], da[4][4];

    hopper::mbar_wait(&kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, q0 = first_row(i);
      hopper::mbar_wait(&full[s], (i / T::STAGES) & 1);
      const bf16* qs = QOs + s * 2 * T::QT_ELEMS;
      const bf16* dos = qs + T::QT_ELEMS;
      hopper::wgmma_fence();
      issue_abt<T::DP>(st, k_wg, kBKb * 64, qs);
      issue_abt<T::DP>(dpt, v_wg, kBKb * 64, dos);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(st);
      hopper::fence_operands(dpt);
      const bool masked = edge(q0);
      const float* ls = lse_s[s];
      const float* dl = dl_s[s];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tg + (e & 1);  // query row q0 + c, key kr0 + 8 (e >> 1)
          float pr = fast_exp2(fmaf(st[4 * j + e], scale_log2, -ls[c]));
          if (masked && !attends(p, q0 + c, kr0 + 8 * (e >> 1))) pr = 0.f;
          st[4 * j + e] = pr;
          dpt[4 * j + e] = pr * (dpt[4 * j + e] - dl[c]);
        }
      }
      pack_frags<64>(pa, st);
      pack_frags<64>(da, dpt);
      hopper::fence_operands(dv);
      hopper::fence_operands(dk);
      hopper::wgmma_fence();
      issue_ab<T::DP>(dv, pa, dos);
      issue_ab<T::DP>(dk, da, qs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(dv);
      hopper::fence_operands(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::fence_operands(pa[kk]);
        hopper::fence_operands(da[kk]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // dK = scale dS^T Q and dV into this warpgroup's rows of K and V (read
    // by nobody else), then one thread stores them; keys past Skv and
    // columns past D are clipped
    stage_rows<T::DP>(k_wg, kBKb * 64, dk, p.scale, warp, g, tg);
    stage_rows<T::DP>(v_wg, kBKb * 64, dv, 1.f, warp, g, tg);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + wg, 128);
    if (tid == 0 && kw0 < p.Skv) {
#pragma unroll
      for (int c = 0; c < T::BOXES; ++c) {
        if (bp.dk != nullptr) hopper::tma_store_4d(tdk, k_wg + c * kBKb * 64, 64 * c, kvh, kw0, b);
        if (bp.dv != nullptr) hopper::tma_store_4d(tdv, v_wg + c * kBKb * 64, 64 * c, kvh, kw0, b);
      }
      hopper::bulk_commit();
      hopper::bulk_wait<0, false>();
    }
  }
}

// dQ of 128 query rows [q0, q0 + 128) of one (head, batch): warpgroups 0
// and 1 computing 64 rows each, warpgroup 2 loading.  Q, dO and the rows'
// lse2 and delta come once; then each 64-key tile that the rows reach, K
// and V through a ring of stages.  Per tile S = Q K^T and dP = dO V^T
// (wgmma, K-major operands), P and dS = P (dP - delta) in registers, and
// dQ += dS K with dS as bf16 A fragments and K read in place as an
// MN-major operand.  The forward's structure with dO V^T beside Q K^T; no
// atomics.
template <int D>
__device__ __forceinline__ void bwd_dq(const CUtensorMap* tq, const CUtensorMap* tk,
                                       const CUtensorMap* tv, const CUtensorMap* tdo,
                                       const CUtensorMap* tdq, const BwdParams& bp, int b, int h,
                                       int qt) {
  using T = BwdTiles<D>;
  using bf16 = __nv_bfloat16;
  const Params& p = bp.f;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[T::DQ_STAGES], empty[T::DQ_STAGES];
  __shared__ __align__(16) float lse_s[kBQd], dl_s[kBQd];
  bf16* Qs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* dOs = Qs + T::Q_ELEMS;
  bf16* KVs = dOs + T::Q_ELEMS;  // per stage: K, then V

  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kBQd;
  int t_begin, t_end;
  kv_tile_range(p, q0, kBQd, kBKd, &t_begin, &t_end);
  const int n = t_end - t_begin;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < T::DQ_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ loader warpgroup
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch(tq);
      hopper::tma_prefetch(tk);
      hopper::tma_prefetch(tv);
      hopper::tma_prefetch(tdo);
      hopper::mbar_arrive_expect_tx(&q_full, 2 * 2 * T::Q_ELEMS + 2 * kBQd * 4);
#pragma unroll
      for (int c = 0; c < T::BOXES; ++c) {
        load_rows(Qs + c * kBQd * 64, tq, &q_full, 64 * c, h, q0, b, kBQd);
        load_rows(dOs + c * kBQd * 64, tdo, &q_full, 64 * c, h, q0, b, kBQd);
      }
      griddep_wait();  // lse2 and delta are the pre-pass's
      const long long off = ((long long)b * p.H + h) * bp.S_pad + q0;
      hopper::bulk_load(lse_s, bp.lse2 + off, kBQd * 4, &q_full);
      hopper::bulk_load(dl_s, bp.delta + off, kBQd * 4, &q_full);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % T::DQ_STAGES;
        hopper::mbar_wait(&empty[s], ((i / T::DQ_STAGES) & 1) ^ 1);
        bf16* ks = KVs + s * 2 * T::KT_ELEMS;
        bf16* vs = ks + T::KT_ELEMS;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * 2 * T::KT_ELEMS);
#pragma unroll
        for (int c = 0; c < T::BOXES; ++c) {
          hopper::tma_load_4d(ks + c * kBKd * 64, tk, &full[s], 64 * c, kvh, t * kBKd, b);
          hopper::tma_load_4d(vs + c * kBKd * 64, tv, &full[s], 64 * c, kvh, t * kBKd, b);
        }
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    hopper::setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
    const int wq0 = q0 + 64 * wg;
    const int r0 = 64 * wg + 16 * warp + g;  // this lane's rows of the block: r0 and r0 + 8
    const float scale_log2 = p.scale * kLog2e;
    bf16* q_wg = Qs + 64 * wg * 64;
    const bf16* do_wg = dOs + 64 * wg * 64;
    auto edge = [&](int t) {
      const int k0 = t * kBKd;
      return k0 + kBKd > p.Skv || (p.causal && k0 + kBKd - 1 > wq0) ||
             (p.window > 0 && wq0 + 63 - k0 >= p.window);
    };

    float dq[T::DP / 2];
#pragma unroll
    for (int i = 0; i < T::DP / 2; ++i) dq[i] = 0.f;
    float sc[32], dp[32];
    uint32_t fr[4][4];

    hopper::mbar_wait(&q_full, 0);
    const float l2[2] = {lse_s[r0], lse_s[r0 + 8]};
    const float dl[2] = {dl_s[r0], dl_s[r0 + 8]};
    for (int i = 0; i < n; ++i) {
      const int s = i % T::DQ_STAGES, t = t_begin + i;
      hopper::mbar_wait(&full[s], (i / T::DQ_STAGES) & 1);
      const bf16* ks = KVs + s * 2 * T::KT_ELEMS;
      const bf16* vs = ks + T::KT_ELEMS;
      hopper::wgmma_fence();
      issue_abt<T::DP>(sc, q_wg, kBQd * 64, ks);
      issue_abt<T::DP>(dp, do_wg, kBQd * 64, vs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sc);
      hopper::fence_operands(dp);
      const bool masked = edge(t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;  // row q0 + r0 + 8r, key t kBKd + 8j + 2tg + (e & 1)
          float pr = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -l2[r]));
          if (masked && !attends(p, q0 + r0 + 8 * r, t * kBKd + 8 * j + 2 * tg + (e & 1)))
            pr = 0.f;
          dp[4 * j + e] = pr * (dp[4 * j + e] - dl[r]);
        }
      }
      pack_frags<64>(fr, dp);
      hopper::fence_operands(dq);
      hopper::wgmma_fence();
      issue_ab<T::DP>(dq, fr, ks);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::fence_operands(fr[kk]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // dQ = scale dS K into this warpgroup's rows of Q, then one TMA store
    stage_rows<T::DP>(q_wg, kBQd * 64, dq, p.scale, warp, g, tg);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + wg, 128);
    if (tid == 0 && wq0 < p.S) {
#pragma unroll
      for (int c = 0; c < T::BOXES; ++c) hopper::tma_store_4d(tdq, q_wg + c * kBQd * 64, 64 * c, h, wq0, b);
      hopper::bulk_commit();
      hopper::bulk_wait<0, false>();
    }
  }
}

// The order of the backward's blocks: every dK/dV block by key block (B KV
// blocks each), then every dQ block from the last query tile down (B H
// blocks each).  Under the causal mask that is heaviest first within each
// kind, and at the train shapes (S 256, group 2) heaviest first across both
// (dK/dV 8 and 4 query tiles of 2 heads, then dQ 4 and 2 key tiles).
// One launch for every dK/dV and dQ block: they write disjoint outputs and
// read only q, k, v, dO and the pre-pass's rows.  n_kv is the key blocks,
// 0 when neither dK nor dV is asked for.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tdq, const __grid_constant__ CUtensorMap tdk,
                   const __grid_constant__ CUtensorMap tdv, const BwdParams bp, const int n_kv) {
  const Params& p = bp.f;
  const int blk = blockIdx.x, kv_blocks = n_kv * p.B * p.KV;
  if (blk < kv_blocks) {
    const int per = p.B * p.KV, i = blk % per;
    bwd_dkdv<D>(&tq, &tk, &tv, &tdo, &tdk, &tdv, bp, i / p.KV, i % p.KV, blk / per);
  } else {
    const int j = blk - kv_blocks, per = p.B * p.H, i = j % per;
    const int tile = (p.S + kBQd - 1) / kBQd - 1 - j / per;
    bwd_dq<D>(&tq, &tk, &tv, &tdo, &tdq, bp, i / p.H, i % p.H, tile);
  }
}

// ---------------------------------------------------------------- fp32 backward
// The parity and test route, on the FMA units, four lanes per row as the
// fp32 forward.
constexpr int kGBK = 64;  // dK/dV: keys per block
constexpr int kGBQ = 32;  // dK/dV: query rows per tile

template <int D>
__global__ void __launch_bounds__(kFThreads) flash_bwd_dkdv_f32(const BwdParams bp) {
  const Params& p = bp.f;
  constexpr int LD = D + 1, LDP = kGBQ + 1;
  constexpr int NC = kGBQ / 4;  // query columns per lane
  constexpr int NDV = D / 4;    // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [kGBK][LD]
  float* Vs = Ks + kGBK * LD;                  // [kGBK][LD]
  float* Qs = Vs + kGBK * LD;                  // [kGBQ][LD]
  float* Gs = Qs + kGBQ * LD;                  // dO [kGBQ][LD]
  float* Ps = Gs + kGBQ * LD;                  // P^T [kGBK][LDP]
  float* Ss = Ps + kGBK * LDP;                 // dS^T [kGBK][LDP]
  float* Ls = Ss + kGBK * LDP;                 // lse2 [kGBQ]
  float* Dl = Ls + kGBQ;                       // delta [kGBQ]

  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;  // lane owns key r, columns sub + 4j
  const int b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV;
  const int group = p.H / p.KV;
  const int k0 = blockIdx.x * kGBK;
  const int key = k0 + r;
  const float scale_log2 = p.scale * kLog2e;

  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  for (int i = tid; i < kGBK * (D / 4); i += kFThreads) {
    const int rr = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 kk4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kk4;
    if (k0 + rr < p.Skv) {
      kk4 = *reinterpret_cast<const float4*>(kg + (k0 + rr) * p.k_ss + c);
      vv4 = *reinterpret_cast<const float4*>(vg + (k0 + rr) * p.v_ss + c);
    }
    float* kd = Ks + rr * LD + c;
    float* vd = Vs + rr * LD + c;
    kd[0] = kk4.x; kd[1] = kk4.y; kd[2] = kk4.z; kd[3] = kk4.w;
    vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
  }

  float dk[NDV], dv[NDV];
#pragma unroll
  for (int n = 0; n < NDV; ++n) dk[n] = dv[n] = 0.f;
  int t_begin, t_end;
  q_tile_range(p, k0, kGBK, kGBQ, &t_begin, &t_end);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* gg = static_cast<const float*>(bp.dout) + b * bp.do_sb + h * bp.do_sh;
    const long long lrow = ((long long)b * p.H + h) * bp.S_pad;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kGBQ;
      __syncthreads();  // K/V are staged, and the previous tile is consumed
      for (int i = tid; i < kGBQ * (D / 4); i += kFThreads) {
        const int rr = i / (D / 4), c = (i % (D / 4)) * 4;
        float4 qq4 = make_float4(0.f, 0.f, 0.f, 0.f), gg4 = qq4;
        if (q0 + rr < p.S) {
          qq4 = *reinterpret_cast<const float4*>(qg + (q0 + rr) * p.q_ss + c);
          gg4 = *reinterpret_cast<const float4*>(gg + (q0 + rr) * bp.do_ss + c);
        }
        float* qd = Qs + rr * LD + c;
        float* gd = Gs + rr * LD + c;
        qd[0] = qq4.x; qd[1] = qq4.y; qd[2] = qq4.z; qd[3] = qq4.w;
        gd[0] = gg4.x; gd[1] = gg4.y; gd[2] = gg4.z; gd[3] = gg4.w;
      }
      if (tid < kGBQ) {
        Ls[tid] = bp.lse2[lrow + q0 + tid];  // S_pad covers the tile
        Dl[tid] = bp.delta[lrow + q0 + tid];
      }
      __syncthreads();

      float st[NC], dpt[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) st[j] = dpt[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = Ks[r * LD + d], vd = Vs[r * LD + d];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          st[j] = fmaf(kd, Qs[(sub + 4 * j) * LD + d], st[j]);
          dpt[j] = fmaf(vd, Gs[(sub + 4 * j) * LD + d], dpt[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = sub + 4 * j;
        const float pr =
            attends(p, q0 + c, key) ? exp2f(fmaf(st[j], scale_log2, -Ls[c])) : 0.f;
        Ps[r * LDP + c] = pr;
        Ss[r * LDP + c] = pr * (dpt[j] - Dl[c]);
      }
      __syncwarp();  // the key's four lanes share one warp
      for (int j = 0; j < kGBQ; ++j) {
        const float pj = Ps[r * LDP + j], sj = Ss[r * LDP + j];
#pragma unroll
        for (int n = 0; n < NDV; ++n) {
          dv[n] = fmaf(pj, Gs[j * LD + sub + 4 * n], dv[n]);
          dk[n] = fmaf(sj, Qs[j * LD + sub + 4 * n], dk[n]);
        }
      }
    }
  }
  if (key < p.Skv) {
    if (bp.dk != nullptr) {
      float* row = static_cast<float*>(bp.dk) + b * bp.dk_sb + key * bp.dk_ss + kvh * bp.dk_sh + sub;
#pragma unroll
      for (int n = 0; n < NDV; ++n) row[4 * n] = dk[n] * p.scale;
    }
    if (bp.dv != nullptr) {
      float* row = static_cast<float*>(bp.dv) + b * bp.dv_sb + key * bp.dv_ss + kvh * bp.dv_sh + sub;
#pragma unroll
      for (int n = 0; n < NDV; ++n) row[4 * n] = dv[n];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads) flash_bwd_dq_f32(const BwdParams bp) {
  const Params& p = bp.f;
  constexpr int LD = D + 1, LDP = kFBK + 1;
  constexpr int NC = kFBK / 4;  // key columns per lane
  constexpr int NDV = D / 4;    // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kFBQ][LD]
  float* Gs = Qs + kFBQ * LD;                  // dO [kFBQ][LD]
  float* Ks = Gs + kFBQ * LD;                  // [kFBK][LD]
  float* Vs = Ks + kFBK * LD;                  // [kFBK][LD]
  float* Ps = Vs + kFBK * LD;                  // dS [kFBQ][LDP]

  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;  // lane owns row r, columns sub + 4j
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kFBQ;
  const int row = q0 + r;
  const float scale_log2 = p.scale * kLog2e;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* gg = static_cast<const float*>(bp.dout) + b * bp.do_sb + h * bp.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  for (int i = tid; i < kFBQ * (D / 4); i += kFThreads) {
    const int rr = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 qq4 = make_float4(0.f, 0.f, 0.f, 0.f), gg4 = qq4;
    if (q0 + rr < p.S) {
      qq4 = *reinterpret_cast<const float4*>(qg + (q0 + rr) * p.q_ss + c);
      gg4 = *reinterpret_cast<const float4*>(gg + (q0 + rr) * bp.do_ss + c);
    }
    float* qd = Qs + rr * LD + c;
    float* gd = Gs + rr * LD + c;
    qd[0] = qq4.x; qd[1] = qq4.y; qd[2] = qq4.z; qd[3] = qq4.w;
    gd[0] = gg4.x; gd[1] = gg4.y; gd[2] = gg4.z; gd[3] = gg4.w;
  }
  const long long lrow = ((long long)b * p.H + h) * bp.S_pad + row;  // S_pad covers the tile
  const float l2 = bp.lse2[lrow], dl = bp.delta[lrow];

  float dq[NDV];
#pragma unroll
  for (int n = 0; n < NDV; ++n) dq[n] = 0.f;
  int t_begin, t_end;
  kv_tile_range(p, q0, kFBQ, kFBK, &t_begin, &t_end);
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kFBK;
    __syncthreads();  // Q/dO are staged, and the previous tile is consumed
    for (int i = tid; i < kFBK * (D / 4); i += kFThreads) {
      const int rr = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kk4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kk4;
      if (k0 + rr < p.Skv) {
        kk4 = *reinterpret_cast<const float4*>(kg + (k0 + rr) * p.k_ss + c);
        vv4 = *reinterpret_cast<const float4*>(vg + (k0 + rr) * p.v_ss + c);
      }
      float* kd = Ks + rr * LD + c;
      float* vd = Vs + rr * LD + c;
      kd[0] = kk4.x; kd[1] = kk4.y; kd[2] = kk4.z; kd[3] = kk4.w;
      vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
    }
    __syncthreads();

    float s[NC], dp[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * LD + d], gd = Gs[r * LD + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        s[j] = fmaf(qd, Ks[(sub + 4 * j) * LD + d], s[j]);
        dp[j] = fmaf(gd, Vs[(sub + 4 * j) * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = sub + 4 * j;
      const float pr = attends(p, row, k0 + c) ? exp2f(fmaf(s[j], scale_log2, -l2)) : 0.f;
      Ps[r * LDP + c] = pr * (dp[j] - dl);
    }
    __syncwarp();  // the row's four lanes share one warp
    for (int j = 0; j < kFBK; ++j) {
      const float ds = Ps[r * LDP + j];
#pragma unroll
      for (int n = 0; n < NDV; ++n) dq[n] = fmaf(ds, Ks[j * LD + sub + 4 * n], dq[n]);
    }
  }
  if (row < p.S) {
    float* out = static_cast<float*>(bp.dq) + b * bp.dq_sb + row * bp.dq_ss + h * bp.dq_sh + sub;
#pragma unroll
    for (int n = 0; n < NDV; ++n) out[4 * n] = dq[n] * p.scale;
  }
}

// ---------------------------------------------------------------- launch
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr int kTmaError = -1000;  // kTmaError - CUresult: a tensor map the driver refused

// 4-D tensor map (D, heads, S, B) of q, k or v with boxes of 64 columns of one
// head and ``rows`` rows of S
int encode_qkv(CUtensorMap* map, const void* base, int D, int heads, int S, int B, long long sb,
               long long ss, long long sh, int rows) {
  const long long dims[4] = {D, heads, S, B};
  const long long strides[3] = {sh, ss, sb};
  const int box[4] = {64, 1, rows, 1};
  const int rc = hopper::encode_bf16(map, base, 4, dims, strides, box);
  return rc == 0 ? 0 : kTmaError - rc;
}

template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  int rc = encode_qkv(&tq, p.q, D, p.H, p.S, p.B, p.q_sb, p.q_ss, p.q_sh, kBQ);
  if (rc == 0) rc = encode_qkv(&tk, p.k, D, p.KV, p.Skv, p.B, p.k_sb, p.k_ss, p.k_sh, kBK);
  if (rc == 0) rc = encode_qkv(&tv, p.v, D, p.KV, p.Skv, p.B, p.v_sb, p.v_ss, p.v_sh, kBK);
  if (rc == 0) rc = encode_qkv(&to, p.o, D, p.H, p.S, p.B, p.o_sb, p.o_ss, p.o_sh, 64);
  if (rc != 0) return rc;
  const int attr = set_smem(flash_fwd_bf16<D>, Tiles<D>::SMEM);
  if (attr != 0) return attr;
  // the query tiles are the slow grid dimension, so the heaviest are dispatched first
  flash_fwd_bf16<D><<<dim3(p.B * p.H, (p.S + kBQ - 1) / kBQ), kThreads, Tiles<D>::SMEM, stream>>>(
      tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kFBQ + kFBK) * (D + 1) + kFBK * D + kFBQ * (kFBK + 1));
  const int attr = set_smem(flash_fwd_f32<D>, smem);
  if (attr != 0) return attr;
  flash_fwd_f32<D><<<dim3((p.S + kFBQ - 1) / kFBQ, p.B * p.H), kFThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int dtype, const Params& p, cudaStream_t stream) {
  return dtype == 1 ? launch_bf16<D>(p, stream) : launch_f32<D>(p, stream);
}

template <int D>
int launch_bwd_bf16(const BwdParams& bp, cudaStream_t stream) {
  using T = BwdTiles<D>;
  const Params& p = bp.f;
  // every map in boxes of 64 rows; an output not asked for gets a
  // placeholder, never stored to
  CUtensorMap tq, tk, tv, tdo, tdq, tdk, tdv;
  int rc = encode_qkv(&tq, p.q, D, p.H, p.S, p.B, p.q_sb, p.q_ss, p.q_sh, 64);
  if (rc == 0) rc = encode_qkv(&tdo, bp.dout, D, p.H, p.S, p.B, bp.do_sb, bp.do_ss, bp.do_sh, 64);
  if (rc == 0) rc = encode_qkv(&tk, p.k, D, p.KV, p.Skv, p.B, p.k_sb, p.k_ss, p.k_sh, 64);
  if (rc == 0) rc = encode_qkv(&tv, p.v, D, p.KV, p.Skv, p.B, p.v_sb, p.v_ss, p.v_sh, 64);
  tdq = tq;
  tdk = tk;
  tdv = tv;
  if (rc == 0 && bp.dq != nullptr)
    rc = encode_qkv(&tdq, bp.dq, D, p.H, p.S, p.B, bp.dq_sb, bp.dq_ss, bp.dq_sh, 64);
  if (rc == 0 && bp.dk != nullptr)
    rc = encode_qkv(&tdk, bp.dk, D, p.KV, p.Skv, p.B, bp.dk_sb, bp.dk_ss, bp.dk_sh, 64);
  if (rc == 0 && bp.dv != nullptr)
    rc = encode_qkv(&tdv, bp.dv, D, p.KV, p.Skv, p.B, bp.dv_sb, bp.dv_ss, bp.dv_sh, 64);
  if (rc != 0) return rc;
  const int n_kv = (bp.dk != nullptr || bp.dv != nullptr) ? (p.Skv + kBKb - 1) / kBKb : 0;
  const int n_qt = bp.dq != nullptr ? (p.S + kBQd - 1) / kBQd : 0;
  const int blocks = n_kv * p.B * p.KV + n_qt * p.B * p.H;
  if (blocks == 0) return 0;
  const size_t smem = T::SMEM_KV > T::SMEM_Q ? T::SMEM_KV : T::SMEM_Q;
  const int attr = set_smem(flash_bwd_bf16<D>, smem);
  if (attr != 0) return attr;
  // programmatic dependent launch behind the pre-pass (griddep_wait)
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  void* args[] = {&tq, &tk, &tv, &tdo, &tdq, &tdk, &tdv, const_cast<BwdParams*>(&bp),
                  const_cast<int*>(&n_kv)};
  return (int)cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(flash_bwd_bf16<D>), args);
}

template <int D>
int launch_bwd_f32(const BwdParams& bp, cudaStream_t stream) {
  const Params& p = bp.f;
  if (bp.dk != nullptr || bp.dv != nullptr) {
    const size_t smem =
        sizeof(float) * (2 * (kGBK + kGBQ) * (D + 1) + 2 * kGBK * (kGBQ + 1) + 2 * kGBQ);
    const int attr = set_smem(flash_bwd_dkdv_f32<D>, smem);
    if (attr != 0) return attr;
    flash_bwd_dkdv_f32<D><<<dim3((p.Skv + kGBK - 1) / kGBK, p.B * p.KV), kFThreads, smem,
                            stream>>>(bp);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (bp.dq != nullptr) {
    const size_t smem = sizeof(float) * (2 * (kFBQ + kFBK) * (D + 1) + kFBQ * (kFBK + 1));
    const int attr = set_smem(flash_bwd_dq_f32<D>, smem);
    if (attr != 0) return attr;
    flash_bwd_dq_f32<D><<<dim3((p.S + kFBQ - 1) / kFBQ, p.B * p.H), kFThreads, smem, stream>>>(bp);
  }
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_bwd(int dtype, const BwdParams& bp, cudaStream_t stream) {
  const Params& p = bp.f;
  const dim3 grid(bp.S_pad / 8, p.B * p.H);
  if (dtype == 1)
    flash_bwd_prep<__nv_bfloat16><<<grid, 256, 0, stream>>>(bp);
  else
    flash_bwd_prep<float><<<grid, 256, 0, stream>>>(bp);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return dtype == 1 ? launch_bwd_bf16<D>(bp, stream) : launch_bwd_f32<D>(bp, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements.  Returns the
// cudaGetLastError() of the launch (0 on success), -1 for a head dim or
// dtype this library was not built for, or -1000 - CUresult for a tensor
// map the driver refused.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, float* lse, long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                                   long long o_sh, int B, int H, int KV, int S, int Skv, int D,
                                   float scale, int causal, int window, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const Params p{q,    k,    v,    o,    lse,  q_sb, q_ss, q_sh, k_sb,  k_ss,   k_sh,  v_sb,
                 v_ss, v_sh, o_sb, o_ss, o_sh, B,    H,    KV,    S,      Skv,   scale,
                 causal, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch<32>(dtype, p, st);
    case 64: return dispatch<64>(dtype, p, st);
    case 80: return dispatch<80>(dtype, p, st);
    case 96: return dispatch<96>(dtype, p, st);
    case 128: return dispatch<128>(dtype, p, st);
    default: return -1;
  }
}

// The backward: dq, dk and dv of the attention whose forward wrote ``o`` and
// ``lse``, for the cotangent ``dout`` of o, in q's dtype.  A null dq is not
// computed; a null dk or dv is not stored (dK and dV come from one kernel).
// ``lse2`` and ``delta`` are fp32 scratch of [B, H, S_pad], S_pad >= S a
// multiple of 128.  Strides are in elements.  Returns as flash_attention_fwd.
extern "C" int flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o, const float* lse,
    const void* dout, void* dq, void* dk, void* dv, float* lse2, float* delta, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh, int B, int H, int KV, int S, int Skv,
    int D, int S_pad, float scale, int causal, int window, void* stream) {
  if ((dtype != 0 && dtype != 1) || S_pad < S || S_pad % 128) return -1;
  BwdParams bp{};
  bp.f = Params{q,    k,    v,    const_cast<void*>(o), nullptr, q_sb, q_ss, q_sh, k_sb, k_ss,
                k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, B,    H,    KV,   S,    Skv,
                scale, causal, window};
  bp.lse = lse;
  bp.dout = dout;
  bp.dq = dq;
  bp.dk = dk;
  bp.dv = dv;
  bp.do_sb = do_sb, bp.do_ss = do_ss, bp.do_sh = do_sh;
  bp.dq_sb = dq_sb, bp.dq_ss = dq_ss, bp.dq_sh = dq_sh;
  bp.dk_sb = dk_sb, bp.dk_ss = dk_ss, bp.dk_sh = dk_sh;
  bp.dv_sb = dv_sb, bp.dv_ss = dv_ss, bp.dv_sh = dv_sh;
  bp.lse2 = lse2;
  bp.delta = delta;
  bp.S_pad = S_pad;
  bp.D = D;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch_bwd<32>(dtype, bp, st);
    case 64: return dispatch_bwd<64>(dtype, bp, st);
    case 80: return dispatch_bwd<80>(dtype, bp, st);
    case 96: return dispatch_bwd<96>(dtype, bp, st);
    case 128: return dispatch_bwd<128>(dtype, bp, st);
    default: return -1;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  static thread_local char msg[96];
  if (code == -1) return "head dim or dtype not built";
  if (code <= kTmaError) {
    snprintf(msg, sizeof msg, "tensor map refused by the driver (CUresult %d)", kTmaError - code);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}
