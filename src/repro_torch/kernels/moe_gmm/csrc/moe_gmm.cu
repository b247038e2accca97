// Grouped expert matmul for Hopper (sm_90a): out[e] = a[e] @ b[e], forward
// and backward.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py::_gmm_kernel
// (driven by grouped_matmul there).  It computes the same function: a
// [E, M, K] times b [E, K, N], the products summed in fp32 over K and the
// result cast to a's dtype, [E, M, N].  The forward is x [E, C, D] times w
// [E, D, F] (capacity buckets of E experts); the backward, as the JAX
// package's custom VJP, is two more products of the same kind, with an
// operand transposed: dx = g w^T and dw = x^T g.  The transposes are never
// copied: every operand is read in place, in whichever of its last two
// dims is contiguous.  In wgmma's terms an operand is K-major when its
// depth K is contiguous and MN-major when its M (for a) or N (for b) is:
//   forward  x w:     a = x K-major,      b = w MN-major;
//   dx =     g w^T:   a = g K-major,      b = w^T K-major (w's F is dx's K);
//   dw =     x^T g:   a = x^T MN-major,   b = g MN-major (K is the capacity C).
//
// What bounds it on this card.  One call does 2*E*M*K*N operations and must
// move (E*M*K + E*K*N + E*M*N) elements.  At granite-moe-1b-a400m's shapes
// (E 32, D 1024, F 512 and D 512, F 1024, bf16) the expert weights alone are
// 33.5 MB a call, so decode (C = 8 on 4 slots) is bound by memory (0.010 ms
// over 3.35 TB/s) and every served prefill capacity up to C 1280 too (C 1280
// moves 159 MB, 0.048 ms, and does 42.9 GFLOP, 0.043 ms at 989 TFLOP/s); C
// 2560 is bound by the tensor cores.  Training at B 8 x S 256 gives C 640:
// each forward, dx and dw product there does 21.5 GFLOP (0.022 ms) and moves
// 96.5 MB (0.029 ms), bound by bytes.  Below those bounds sits the traffic
// between L2 and the SMs: every output tile streams a strip of a and of b,
// so small tiles read the same bytes from L2 many times over.
//
// What the design does about that (bf16).  Two kernels, both built from
// TMA loads into a ring of 128-byte swizzled stages (one loader thread,
// mbarriers for full and empty stages) and wgmma products with fp32
// accumulators in registers, two consumer warpgroups per block:
// - Tiled (every layout; the forward at C > 16): output tiles of 128 x 256
//   (64 rows per warpgroup, m64n256k16) where there are enough of them to
//   give every SM two, else 128 x 128; a depth of 64 per stage, 3 or 5
//   stages.  Each operand's stage is a stack of boxes taken from its tensor
//   map: for a K-major operand, rows of M or N with the depth along each
//   row (one box of 128 rows for a, boxes of 64 for b); for an MN-major
//   one, boxes of 64 rows of depth with 64 of M or N along each row, read
//   through wgmma's transpose bit.  The layout is a template parameter of
//   each operand (the loader's boxes and the descriptors' offsets follow
//   it), so one kernel serves the forward and both backward products.  A
//   128 x 256 tile reads a quarter fewer L2 bytes per output than 128 x
//   128, and half as many as the old 64 x 64.
//   One block per SM walks the tiles (persistent), and the loader runs
//   ahead across tiles, so the next tile's loads overlap this tile's last
//   products and its stores.  The consumers keep one wgmma group in flight
//   and release a stage when the group that read it is done.  Each
//   warpgroup writes its 64 x BN outputs, in bf16, into shared memory in
//   TMA's swizzle, and one thread stores them with TMA, in whole lines,
//   while the loader goes on: stores of 4 bytes from every thread would
//   write 32-byte sectors in halves and hold the consumers.
// - Decode (the forward layout at C <= 16): the operands are swapped,
//   out^T = w^T x^T, so F fills wgmma's 64-row M dimension and C its N
//   dimension (8 or 16), where the unswapped product would be 7/8 padding.
//   w^T is an MN-major A operand in place, x^T a K-major B operand.  One
//   block per 128 columns of F of one expert streams that expert's weights
//   through 8 stages of 16 KB, so 128 KB of weights are in flight per SM:
//   enough to keep HBM busy, which is all that bounds decode.  Its output
//   is small (C x F per expert) and is stored from registers.
// The fp32 kernel (parity runs and tests) runs on the FMA units, in every
// layout: TF32 tensor cores would not hold fp32's tolerance over D = 1024.
//
// Edges.  Rows past M, columns past N and depth past K are zero-filled by
// TMA and never stored (the TMA store clips them), so C (the capacity,
// ragged in serving and training) may be any size >= 1, as M or as K (dw
// sums over it): the TPU wrapper asserts that its block divides C.
//
// Layout.  a, b and out are read and written through their strides (3-D
// tensor maps over the caller's strides): of each operand's last two dims
// one is contiguous, every row starts on a 16-byte boundary (TMA's own
// condition on the base and the strides), the contiguous dims and N are
// multiples of 16 bytes' worth of elements (ops.py checks all of it), and
// out is [E, M, N] with N contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

#include "../../common/csrc/hopper.cuh"

namespace {

struct Params {
  const void* a;
  const void* b;
  void* o;
  long long a_se, a_s;  // a [E, M, K]: the expert stride, the stride of M (K-major) or of K
  long long b_se, b_s;  // b [E, K, N]: the expert stride, the stride of K (MN-major) or of N
  long long o_se, o_sm; // o [E, M, N]
  int E, M, K, N;
};

using bf16 = __nv_bfloat16;

using hopper::pack_bf16;

__device__ __forceinline__ bf16* align1024(unsigned char* p) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------- bf16
constexpr int kBK = 64;          // depth of one stage: one swizzled box of 128 bytes
constexpr int kBox = 64 * kBK;   // elements of one box of 64 x 64
constexpr int kConsumers = 256;  // warpgroups 0 and 1
constexpr int kThreads = 384;    // and the loader, warpgroup 2
constexpr int kSwapMaxC = 16;    // M up to this takes the swapped (decode) kernel

// tiled: a as one box [kBM][64] (K-major) or kBM / 64 boxes [64][64]
// (M-major), then b as BN / 64 boxes [64][64]
constexpr int kBM = 128;
// and the output tile [kBM][BN] as BN / 64 boxes [kBM][64] for the TMA store
template <int BN>
struct Tiles {
  static constexpr int STAGES = BN == 256 ? 3 : 5;
  static constexpr int STAGE_ELEMS = kBM * kBK + kBK * BN;
  static constexpr size_t SMEM = 2 * (STAGES * STAGE_ELEMS + kBM * BN) + 1024;
};

// decode tiles: w as two boxes [64][64] (F columns), then x box [N][64]
constexpr int kSwapBF = 128, kSwapStages = 8;
template <int N>
struct SwapTiles {
  static constexpr int STAGE_ELEMS = kBK * kSwapBF + N * kBK;  // a multiple of 512: 1024 bytes
  static constexpr size_t SMEM = 2 * kSwapStages * STAGE_ELEMS + 1024;
};

// The ring both kernels share: the loader waits for a stage to be released
// before refilling it; the consumers wait for it to fill.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;
  __device__ void init(int consumers) const {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], consumers);
    }
    hopper::mbar_fence_init();
  }
  __device__ void produce(int i, uint32_t bytes) const {
    const int s = i % stages;
    hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[s], bytes);
  }
  __device__ void consume(int i) const { hopper::mbar_wait(&full[i % stages], (i / stages) & 1); }
  __device__ void release(int i) const { hopper::mbar_arrive(&empty[i % stages]); }
};

// The box of an operand's map that starts at row mn of M or N and depth k
// (64 of each, or kBM rows of a K-major a).  The map's innermost dim is the
// operand's contiguous one: the depth for a K-major operand, M or N for an
// MN-major one.
template <bool MN_MAJOR>
__device__ __forceinline__ void load_box(bf16* dst, const CUtensorMap* map, uint64_t* bar, int mn,
                                         int k, int e) {
  if constexpr (MN_MAJOR)
    hopper::tma_load_3d(dst, map, bar, mn, k, e);
  else
    hopper::tma_load_3d(dst, map, bar, k, mn, e);
}

// The wgmma descriptor of the kk-th 16-deep step of a stack of such boxes
// (hopper.cuh): K-major, 32 bytes into each 128-byte row; MN-major, 16 rows
// of depth (2048 bytes) further, the next 64 of M or N in the next box.
template <bool MN_MAJOR>
__device__ __forceinline__ uint64_t operand_desc(const bf16* boxes, int kk) {
  if constexpr (MN_MAJOR)
    return hopper::desc_sw128(boxes + kk * 16 * 64, 2 * kBox, 1024);
  else
    return hopper::desc_sw128(boxes + kk * 16, 16, 1024);
}

// One block per SM walks the output tiles (N fastest, then M, then the
// expert) in steps of the grid; the loader runs ahead across tiles, so the
// next tile's loads overlap this tile's last products and its stores.
// A_MN and B_MN are the operands' layouts (true: MN-major).
template <int BN, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_bf16(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
             const __grid_constant__ CUtensorMap to, const Params p) {
  using T = Tiles<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES];
  bf16* smem = align1024(smem_raw);
  const Ring ring{full, empty, T::STAGES};
  const int n_tiles = (p.N + BN - 1) / BN, m_tiles = (p.M + kBM - 1) / kBM;
  const int tiles = n_tiles * m_tiles * p.E;
  const int ktiles = (p.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) ring.init(kConsumers);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ loader warpgroup
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch(&ta);
      hopper::tma_prefetch(&tb);
      int it = 0;  // stages filled so far, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles % m_tiles) * kBM;
        const int e = tile / (n_tiles * m_tiles);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          ring.produce(it, 2 * T::STAGE_ELEMS);
          uint64_t* bar = &full[it % T::STAGES];
          bf16* as = smem + (it % T::STAGES) * T::STAGE_ELEMS;
          bf16* bs = as + kBM * kBK;
#pragma unroll
          for (int h = 0; h < (A_MN ? kBM / 64 : 1); ++h)  // K-major: one box of kBM rows
            load_box<A_MN>(as + h * kBox, &ta, bar, m0 + 64 * h, kt * kBK, e);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            load_box<B_MN>(bs + c * kBox, &tb, bar, n0 + 64 * c, kt * kBK, e);
        }
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    hopper::setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
    float acc[BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles % m_tiles) * kBM;
      const int e = tile / (n_tiles * m_tiles);
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        ring.consume(it);
        // this warpgroup's 64 rows of M: its own box of a, in either layout
        const bf16* as = smem + (it % T::STAGES) * T::STAGE_ELEMS + wg * kBox;
        const bf16* bs = smem + (it % T::STAGES) * T::STAGE_ELEMS + kBM * kBK;
        hopper::fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = operand_desc<A_MN>(as, kk);
          const uint64_t db = operand_desc<B_MN>(bs, kk);
          if constexpr (BN == 256)
            hopper::wgmma_ss_n256<A_MN, B_MN>(acc, da, db, kt > 0 || kk > 0);
          else
            hopper::wgmma_ss_n128<A_MN, B_MN>(acc, da, db, kt > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the group of the previous stage is done: release it
        hopper::fence_operands(acc);
        if (kt > 0) ring.release(it - 1);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      ring.release(it - 1);

      // the tile into this warpgroup's rows of the output buffer, in TMA's
      // swizzle, once the previous tile's store has read them; then one
      // thread stores it (rows past M and columns past N are clipped)
      bf16* ob = smem + T::STAGES * T::STAGE_ELEMS + 64 * wg * 64;
      if (tid == 0) hopper::bulk_wait<0, true>();
      hopper::named_barrier_sync(1 + wg, 128);
      const int r = 16 * warp + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        bf16* box = ob + (j / 8) * kBM * 64;
        const int col = (8 * j) % 64 + 2 * tg;
        *reinterpret_cast<uint32_t*>(box + hopper::sw128_offset(r, col)) =
            pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(box + hopper::sw128_offset(r + 8, col)) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1 + wg, 128);
      if (tid == 0 && m0 + 64 * wg < p.M) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          hopper::tma_store_3d(&to, ob + c * kBM * 64, n0 + 64 * c, m0 + 64 * wg, e);
        hopper::bulk_commit();
      }
    }
    if (tid == 0) hopper::bulk_wait<0, false>();
  }
}

// out^T [F, C] = w^T [F, D] x^T [D, C] (the forward layout: a = x, b = w):
// M = 128 columns of F per block (64 per warpgroup), N = C padded to 8 or 16
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_bf16_swap(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const Params p) {
  using T = SwapTiles<N>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kSwapStages], empty[kSwapStages];
  bf16* smem = align1024(smem_raw);
  const Ring ring{full, empty, kSwapStages};
  const int f0 = blockIdx.x * kSwapBF, e = blockIdx.z;
  const int ktiles = (p.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) ring.init(kConsumers);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch(&tx);
      hopper::tma_prefetch(&tw);
      for (int kt = 0; kt < ktiles; ++kt) {
        ring.produce(kt, 2 * T::STAGE_ELEMS);
        uint64_t* bar = &full[kt % kSwapStages];
        bf16* ws = smem + (kt % kSwapStages) * T::STAGE_ELEMS;
        hopper::tma_load_3d(ws, &tw, bar, f0, kt * kBK, e);
        hopper::tma_load_3d(ws + kBK * 64, &tw, bar, f0 + 64, kt * kBK, e);
        hopper::tma_load_3d(ws + kBK * kSwapBF, &tx, bar, kt * kBK, 0, e);
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      ring.consume(kt);
      const bf16* ws = smem + (kt % kSwapStages) * T::STAGE_ELEMS + wg * kBK * 64;
      const bf16* xs = smem + (kt % kSwapStages) * T::STAGE_ELEMS + kBK * kSwapBF;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(ws + kk * 16 * 64, kBK * 64 * 2, 1024);
        const uint64_t db = hopper::desc_sw128(xs + kk * 16, 16, 1024);
        if constexpr (N == 8)
          hopper::wgmma_ss_n8<1, 0>(acc, da, db, 1);
        else
          hopper::wgmma_ss_n16<1, 0>(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operands(acc);
      if (kt > 0) ring.release(kt - 1);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);

    bf16* og = static_cast<bf16*>(p.o) + e * p.o_se;
    const int f = f0 + 64 * wg + 16 * warp + g;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 8 * j + 2 * tg + (r & 1), fr = f + 8 * (r >> 1);
        if (c < p.M && fr < p.N) og[c * p.o_sm + fr] = __float2bfloat16(acc[4 * j + r]);
      }
    }
  }
}

// ---------------------------------------------------------------- fp32
constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFThreads = 256;  // 16 x 16 threads of 4 x 4 outputs

// Each thread brings one float4 of each operand's tile, along the
// operand's contiguous dim: a K-major tile as 64 rows (of M or N) of 4
// float4s of depth, an MN-major one as 16 rows of depth of 16 float4s.
template <bool MN_MAJOR>
__device__ __forceinline__ float4 load_f32(const float* base, long long s, int mn0, int k0, int MN,
                                           int K, int tid) {
  const int r = MN_MAJOR ? tid >> 4 : tid >> 2, q = MN_MAJOR ? (tid & 15) * 4 : (tid & 3) * 4;
  const int mn = MN_MAJOR ? mn0 + q : mn0 + r, k = MN_MAJOR ? k0 + r : k0 + q;
  if (mn >= MN || k >= K) return make_float4(0.f, 0.f, 0.f, 0.f);
  return *reinterpret_cast<const float4*>(MN_MAJOR ? base + k * s + mn : base + mn * s + k);
}

// ...and stores it into the tile in shared memory, depth-major ([k][mn])
template <bool MN_MAJOR, int W>
__device__ __forceinline__ void store_f32(float (&tile)[kFBK][W], float4 v, int tid) {
  if constexpr (MN_MAJOR) {
    *reinterpret_cast<float4*>(&tile[tid >> 4][(tid & 15) * 4]) = v;
  } else {
    const int r = tid >> 2, q = (tid & 3) * 4;
    tile[q][r] = v.x;
    tile[q + 1][r] = v.y;
    tile[q + 2][r] = v.z;
    tile[q + 3][r] = v.w;
  }
}

template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kFThreads) gmm_f32(const Params p) {
  __shared__ __align__(16) float As[kFBK][kFBM + 4];  // a tile: [k][m]
  __shared__ __align__(16) float Bs[kFBK][kFBN + 4];  // b tile: [k][n]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kFBN, m0 = blockIdx.y * kFBM, e = blockIdx.z;
  const float* ag = static_cast<const float*>(p.a) + e * p.a_se;
  const float* bg = static_cast<const float*>(p.b) + e * p.b_se;
  float* og = static_cast<float*>(p.o) + e * p.o_se;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kFBK) {
    const float4 av = load_f32<A_MN>(ag, p.a_s, m0, k0, p.M, p.K, tid);
    const float4 bv = load_f32<B_MN>(bg, p.b_s, n0, k0, p.N, p.K, tid);
    __syncthreads();  // the previous tile is consumed
    store_f32<A_MN>(As, av, tid);
    store_f32<B_MN>(Bs, bv, tid);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av4[4] = {a.x, a.y, a.z, a.w}, bv4[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av4[i], bv4[j], acc[i][j]);
    }
  }

  const int col = n0 + tx * 4;
  if (col >= p.N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row < p.M)
      *reinterpret_cast<float4*>(og + row * p.o_sm + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------------- launch
constexpr int kTmaError = -1000;  // kTmaError - CUresult: a tensor map the driver refused

// 3-D tensor map (inner, rows, E) with boxes [box_rows][64]
int encode_3d(CUtensorMap* map, const void* base, int inner, int rows, int E, long long s_row,
              long long s_e, int box_rows) {
  const long long dims[3] = {inner, rows, E};
  const long long strides[2] = {s_row, s_e};
  const int box[3] = {64, box_rows, 1};
  const int rc = hopper::encode_bf16(map, base, 3, dims, strides, box);
  return rc == 0 ? 0 : kTmaError - rc;
}

// the SMs of the current device (the persistent grid), or -1
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return n;
}

template <typename Kernel, typename... Maps>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p,
           const Maps&... maps) {
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid, kThreads, smem, stream>>>(maps..., p);
  return (int)cudaGetLastError();
}

// the tiled kernel of one layout: tiles of 128 x 256 read a quarter fewer
// L2 bytes per output than 128 x 128, where there are enough of them to
// give every SM two
template <bool A_MN, bool B_MN>
int launch_tiled(cudaStream_t st, const Params& p, const CUtensorMap& ta, const CUtensorMap& tb,
                 const CUtensorMap& to) {
  const int sms = sm_count();
  if (sms < 0) return -3;
  const long long m_tiles = (p.M + kBM - 1) / kBM;
  const long long wide = m_tiles * ((p.N + 255) / 256) * p.E;
  const long long narrow = m_tiles * ((p.N + 127) / 128) * p.E;
  if (wide >= 2 * sms)
    return launch(gmm_bf16<256, A_MN, B_MN>, dim3((unsigned)std::min<long long>(wide, sms)),
                  Tiles<256>::SMEM, st, p, ta, tb, to);
  return launch(gmm_bf16<128, A_MN, B_MN>, dim3((unsigned)std::min<long long>(narrow, sms)),
                Tiles<128>::SMEM, st, p, ta, tb, to);
}

template <bool A_MN, bool B_MN>
int launch_f32(cudaStream_t st, const Params& p) {
  gmm_f32<A_MN, B_MN><<<dim3((p.N + kFBN - 1) / kFBN, (p.M + kFBM - 1) / kFBM, p.E), kFThreads,
                        0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// out [E, M, N] = a [E, M, K] @ b [E, K, N].  dtype: 0 float32, 1 bfloat16.
// Strides are in elements, one per dim of each operand (a_se, a_sm, a_sk
// for a's E, M and K): of each operand's last two dims one has stride 1 (a:
// K, else M; b: N, else K); out's N has stride 1.  Returns the
// cudaGetLastError() of the launch (0 on success), -1 for a dtype this
// library was not built for, -2 for an empty or oversized shape, -3 without
// a current device, -4 for an operand with neither of its last two dims
// contiguous, or -1000 - CUresult for a tensor map the driver refused.
extern "C" int moe_gmm(int dtype, const void* a, const void* b, void* o, long long a_se,
                       long long a_sm, long long a_sk, long long b_se, long long b_sk,
                       long long b_sn, long long o_se, long long o_sm, int E, int M, int K, int N,
                       void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (E < 1 || M < 1 || K < 1 || N < 1 || E > 65535 || (M + kFBM - 1) / kFBM > 65535) return -2;
  if ((a_sk != 1 && a_sm != 1) || (b_sn != 1 && b_sk != 1)) return -4;
  const bool a_mn = a_sk != 1, b_mn = b_sn == 1;
  const Params p{a, b, o, a_se, a_mn ? a_sk : a_sm, b_se, b_mn ? b_sk : b_sn, o_se, o_sm,
                 E, M, K, N};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (a_mn) return b_mn ? launch_f32<true, true>(st, p) : launch_f32<true, false>(st, p);
    return b_mn ? launch_f32<false, true>(st, p) : launch_f32<false, false>(st, p);
  }
  // a's map: (K, M, E) when K-major, in boxes of kBM rows, (M, K, E) when
  // M-major; b's: (N, K, E) when N-major, (K, N, E) when K-major.  The
  // forward layout at M <= 16 takes the swapped kernel, with a in boxes of
  // 8 or 16 rows.
  const bool swap = !a_mn && b_mn && M <= kSwapMaxC;
  CUtensorMap ta, tb, to;
  int rc = a_mn ? encode_3d(&ta, a, M, K, E, a_sk, a_se, 64)
                : encode_3d(&ta, a, K, M, E, a_sm, a_se, !swap ? kBM : M <= 8 ? 8 : 16);
  if (rc == 0)
    rc = b_mn ? encode_3d(&tb, b, N, K, E, b_sk, b_se, 64)
              : encode_3d(&tb, b, K, N, E, b_sn, b_se, 64);
  if (rc == 0 && !swap) rc = encode_3d(&to, o, N, M, E, o_sm, o_se, 64);
  if (rc != 0) return rc;
  if (swap) {
    const dim3 f_tiles((N + kSwapBF - 1) / kSwapBF, 1, E);
    if (M <= 8) return launch(gmm_bf16_swap<8>, f_tiles, SwapTiles<8>::SMEM, st, p, ta, tb);
    return launch(gmm_bf16_swap<16>, f_tiles, SwapTiles<16>::SMEM, st, p, ta, tb);
  }
  if (a_mn) return b_mn ? launch_tiled<true, true>(st, p, ta, tb, to)
                        : launch_tiled<true, false>(st, p, ta, tb, to);
  return b_mn ? launch_tiled<false, true>(st, p, ta, tb, to)
              : launch_tiled<false, false>(st, p, ta, tb, to);
}

extern "C" const char* moe_gmm_error_string(int code) {
  static thread_local char msg[96];
  if (code == -1) return "dtype not built";
  if (code == -2) return "empty shape, or more experts or capacity tiles than the grid holds";
  if (code == -3) return "no current CUDA device";
  if (code == -4) return "an operand with neither of its last two dims contiguous";
  if (code <= kTmaError) {
    snprintf(msg, sizeof msg, "tensor map refused by the driver (CUresult %d)", kTmaError - code);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}
