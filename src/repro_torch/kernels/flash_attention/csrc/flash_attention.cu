// Flash attention forward for Hopper (sm_90a): causal, sliding-window, GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_flash_kernel
// (driven by flash_attention_bhsd there).  It computes the same function: an
// online softmax over KV tiles with the running max, normaliser and
// accumulator kept in fp32; the scale the caller passes (d^-0.5); causal and
// sliding-window masks; KV tiles that no row of the query tile may attend to
// are skipped; the output is acc / l with l == 0 guarded.
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

// P in bf16 as the A fragments of P V: k-step kk takes columns 16kk.. of the
// score tile, i.e. its n8 tiles 2kk and 2kk + 1
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBK / 16][4], const float (&sc)[kBK / 2]) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
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
      pack_p(pa, sc);
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
      pack_p(pa, sc);
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
  if (row < p.S) {
    float* orow = og + row * p.o_ss + sub;
#pragma unroll
    for (int n = 0; n < NDV; ++n) orow[4 * n] = acc[n] / den;
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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements.  Returns the
// cudaGetLastError() of the launch (0 on success), -1 for a head dim or
// dtype this library was not built for, or -1000 - CUresult for a tensor
// map the driver refused.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                                   long long o_sh, int B, int H, int KV, int S, int Skv, int D,
                                   float scale, int causal, int window, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const Params p{q,    k,    v,    o,    q_sb, q_ss, q_sh, k_sb,  k_ss,   k_sh,  v_sb,
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

extern "C" const char* flash_attention_error_string(int code) {
  static thread_local char msg[96];
  if (code == -1) return "head dim or dtype not built";
  if (code <= kTmaError) {
    snprintf(msg, sizeof msg, "tensor map refused by the driver (CUresult %d)", kTmaError - code);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}
