// Grouped expert matmul for Hopper (sm_90a): out[e] = x[e] @ w[e].
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py::_gmm_kernel
// (driven by grouped_matmul there).  It computes the same function: x
// [E, C, D] (capacity buckets of E experts) times w [E, D, F], the products
// summed in fp32 over D and the result cast to x's dtype, [E, C, F].
//
// What bounds it on this card.  One call does 2*E*C*D*F operations and must
// move (E*C*D + E*D*F + E*C*F) elements.  At granite-moe-1b-a400m's shapes
// (E 32, D 1024, F 512 and D 512, F 1024, bf16) the expert weights alone are
// 33.5 MB a call, so decode (C = 8 on 4 slots) is bound by memory (0.010 ms
// over 3.35 TB/s) and every served prefill capacity up to C 1280 too (C 1280
// moves 159 MB, 0.048 ms, and does 42.9 GFLOP, 0.043 ms at 989 TFLOP/s); C
// 2560 is bound by the tensor cores.  Below those bounds sits the traffic
// between L2 and the SMs: every output tile streams a strip of x and of w,
// so small tiles read the same bytes from L2 many times over.
//
// What the design does about that (bf16).  Two kernels, both built from
// TMA loads into a ring of 128-byte swizzled stages (one loader thread,
// mbarriers for full and empty stages) and wgmma products with fp32
// accumulators in registers, two consumer warpgroups per block:
// - Prefill (C > 16): output tiles of 128 x 256 (64 rows per warpgroup,
//   m64n256k16) where there are enough of them to give every SM two, else
//   128 x 128; a depth of 64 per stage, 3 or 5 stages.  x tiles are K-major;
//   w [D, F] is row-major, so its tiles are MN-major B operands read in
//   place through the transpose bit.  A 128 x 256 tile reads a quarter
//   fewer L2 bytes per output than 128 x 128, and half as many as the old
//   64 x 64.  One block per SM walks the tiles (persistent), and the loader
//   runs ahead across tiles, so the next tile's loads overlap this tile's
//   last products and its stores.  The consumers keep one wgmma group in
//   flight and release a stage when the group that read it is done.  Each
//   warpgroup writes its 64 x BN outputs, in bf16, into shared memory in
//   TMA's swizzle, and one thread stores them with TMA, in whole lines,
//   while the loader goes on: stores of 4 bytes from every thread would
//   write 32-byte sectors in halves and hold the consumers.
// - Decode (C <= 16): the operands are swapped, out^T = w^T x^T, so F
//   fills wgmma's 64-row M dimension and C its N dimension (8 or 16), where
//   the unswapped product would be 7/8 padding.  w^T is an MN-major A
//   operand in place, x^T a K-major B operand.  One block per 128 columns
//   of F of one expert streams that expert's weights through 8 stages of
//   16 KB, so 128 KB of weights are in flight per SM: enough to keep HBM
//   busy, which is all that bounds decode.  Its output is small (C x F per
//   expert) and is stored from registers.
// The fp32 kernel (parity runs and tests) runs on the FMA units as before:
// TF32 tensor cores would not hold fp32's tolerance over D = 1024.
//
// Edges.  Rows past C, columns past F and depth past D are zero-filled by
// TMA and never stored (the TMA store clips them), so C (the capacity,
// ragged in serving) may be any size >= 1: the TPU wrapper asserts that its
// block divides C.
//
// Layout.  x, w and out are read and written through their strides on the
// leading dims (3-D tensor maps over the caller's strides); the last dim of
// each is contiguous, every row starts on a 16-byte boundary (TMA's own
// condition on the base and the strides) and D and F are multiples of 16
// bytes' worth of elements (ops.py checks all of it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

#include "../../common/csrc/hopper.cuh"

namespace {

struct Params {
  const void* x;
  const void* w;
  void* o;
  long long x_se, x_sc;  // x [E, C, D]
  long long w_se, w_sd;  // w [E, D, F]
  long long o_se, o_sc;  // o [E, C, F]
  int E, C, D, F;
};

using bf16 = __nv_bfloat16;

using hopper::pack_bf16;

__device__ __forceinline__ bf16* align1024(unsigned char* p) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------- bf16
constexpr int kBK = 64;          // depth of one stage: one swizzled box of 128 bytes
constexpr int kConsumers = 256;  // warpgroups 0 and 1
constexpr int kThreads = 384;    // and the loader, warpgroup 2
constexpr int kSwapMaxC = 16;    // C up to this takes the swapped (decode) kernel

// prefill tiles: x box [kBM][64], then w as BN / 64 boxes [64][64] (F columns)
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

// One block per SM walks the output tiles (F fastest, then C, then the
// expert) in steps of the grid; the loader runs ahead across tiles, so the
// next tile's loads overlap this tile's last products and its stores.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_bf16(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap to, const Params p) {
  using T = Tiles<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES];
  bf16* smem = align1024(smem_raw);
  const Ring ring{full, empty, T::STAGES};
  const int n_tiles = (p.F + BN - 1) / BN, m_tiles = (p.C + kBM - 1) / kBM;
  const int tiles = n_tiles * m_tiles * p.E;
  const int ktiles = (p.D + kBK - 1) / kBK;

  if (threadIdx.x == 0) ring.init(kConsumers);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ loader warpgroup
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch(&tx);
      hopper::tma_prefetch(&tw);
      int it = 0;  // stages filled so far, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles % m_tiles) * kBM;
        const int e = tile / (n_tiles * m_tiles);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          ring.produce(it, 2 * T::STAGE_ELEMS);
          uint64_t* bar = &full[it % T::STAGES];
          bf16* xs = smem + (it % T::STAGES) * T::STAGE_ELEMS;
          bf16* ws = xs + kBM * kBK;
          hopper::tma_load_3d(xs, &tx, bar, kt * kBK, m0, e);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            hopper::tma_load_3d(ws + c * kBK * 64, &tw, bar, n0 + 64 * c, kt * kBK, e);
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
        const bf16* xs = smem + (it % T::STAGES) * T::STAGE_ELEMS + 64 * wg * kBK;
        const bf16* ws = smem + (it % T::STAGES) * T::STAGE_ELEMS + kBM * kBK;
        hopper::fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = hopper::desc_sw128(xs + kk * 16, 16, 1024);
          const uint64_t db = hopper::desc_sw128(ws + kk * 16 * 64, 2 * kBK * 64, 1024);
          if constexpr (BN == 256)
            hopper::wgmma_ss_n256<0, 1>(acc, da, db, kt > 0 || kk > 0);
          else
            hopper::wgmma_ss_n128<0, 1>(acc, da, db, kt > 0 || kk > 0);
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
      // thread stores it (rows past C and columns past F are clipped)
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
      if (tid == 0 && m0 + 64 * wg < p.C) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          hopper::tma_store_3d(&to, ob + c * kBM * 64, n0 + 64 * c, m0 + 64 * wg, e);
        hopper::bulk_commit();
      }
    }
    if (tid == 0) hopper::bulk_wait<0, false>();
  }
}

// out^T [F, C] = w^T [F, D] x^T [D, C]: M = 128 columns of F per block (64
// per warpgroup), N = C padded to 8 or 16
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
  const int ktiles = (p.D + kBK - 1) / kBK;

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
        if (c < p.C && fr < p.F) og[c * p.o_sc + fr] = __float2bfloat16(acc[4 * j + r]);
      }
    }
  }
}

// ---------------------------------------------------------------- fp32
constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFThreads = 256;  // 16 x 16 threads of 4 x 4 outputs

__global__ void __launch_bounds__(kFThreads) gmm_f32(const Params p) {
  __shared__ __align__(16) float As[kFBK][kFBM + 4];  // x tile, transposed: [k][m]
  __shared__ __align__(16) float Bs[kFBK][kFBN + 4];  // w tile: [k][n]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kFBN, m0 = blockIdx.y * kFBM, e = blockIdx.z;
  const float* xg = static_cast<const float*>(p.x) + e * p.x_se;
  const float* wg = static_cast<const float*>(p.w) + e * p.w_se;
  float* og = static_cast<float*>(p.o) + e * p.o_se;

  const int ar = tid >> 2, ac = (tid & 3) * 4;   // this thread's float4 of the x tile
  const int br = tid >> 4, bc = (tid & 15) * 4;  // ...and of the w tile
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < p.D; k0 += kFBK) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (m0 + ar < p.C && k0 + ac < p.D)
      av = *reinterpret_cast<const float4*>(xg + (m0 + ar) * p.x_sc + k0 + ac);
    if (k0 + br < p.D && n0 + bc < p.F)
      bv = *reinterpret_cast<const float4*>(wg + (k0 + br) * p.w_sd + n0 + bc);
    __syncthreads();  // the previous tile is consumed
    As[ac + 0][ar] = av.x;
    As[ac + 1][ar] = av.y;
    As[ac + 2][ar] = av.z;
    As[ac + 3][ar] = av.w;
    *reinterpret_cast<float4*>(&Bs[br][bc]) = bv;
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
  if (col >= p.F) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row < p.C)
      *reinterpret_cast<float4*>(og + row * p.o_sc + col) =
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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the last dim of
// x, w and o has stride 1.  Returns the cudaGetLastError() of the launch (0
// on success), -1 for a dtype this library was not built for, -2 for an
// empty or oversized shape, -3 without a current device, or -1000 - CUresult
// for a tensor map the driver refused.
extern "C" int moe_gmm_fwd(int dtype, const void* x, const void* w, void* o, long long x_se,
                           long long x_sc, long long w_se, long long w_sd, long long o_se,
                           long long o_sc, int E, int C, int D, int F, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 || (C + kFBM - 1) / kFBM > 65535) return -2;
  const Params p{x, w, o, x_se, x_sc, w_se, w_sd, o_se, o_sc, E, C, D, F};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gmm_f32<<<dim3((F + kFBN - 1) / kFBN, (C + kFBM - 1) / kFBM, E), kFThreads, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  // x in boxes of 8 or 16 rows (decode) or kBM rows (prefill, which also
  // stores through the output's map)
  const int x_rows = C <= 8 ? 8 : C <= kSwapMaxC ? 16 : kBM;
  CUtensorMap tx, tw, to;
  int rc = encode_3d(&tx, x, D, C, E, x_sc, x_se, x_rows);
  if (rc == 0) rc = encode_3d(&tw, w, F, D, E, w_sd, w_se, kBK);
  if (rc == 0 && x_rows == kBM) rc = encode_3d(&to, o, F, C, E, o_sc, o_se, 64);
  if (rc != 0) return rc;
  const dim3 f_tiles((F + kSwapBF - 1) / kSwapBF, 1, E);
  if (x_rows == 8) return launch(gmm_bf16_swap<8>, f_tiles, SwapTiles<8>::SMEM, st, p, tx, tw);
  if (x_rows == 16) return launch(gmm_bf16_swap<16>, f_tiles, SwapTiles<16>::SMEM, st, p, tx, tw);
  // tiles of 128 x 256 read a quarter fewer L2 bytes per output than 128 x
  // 128, where there are enough of them to give every SM two
  const int sms = sm_count();
  if (sms < 0) return -3;
  const long long m_tiles = (C + kBM - 1) / kBM;
  const long long wide = m_tiles * ((F + 255) / 256) * E, narrow = m_tiles * ((F + 127) / 128) * E;
  if (wide >= 2 * sms)
    return launch(gmm_bf16<256>, dim3((unsigned)std::min<long long>(wide, sms)), Tiles<256>::SMEM,
                  st, p, tx, tw, to);
  return launch(gmm_bf16<128>, dim3((unsigned)std::min<long long>(narrow, sms)), Tiles<128>::SMEM,
                st, p, tx, tw, to);
}

extern "C" const char* moe_gmm_error_string(int code) {
  static thread_local char msg[96];
  if (code == -1) return "dtype not built";
  if (code == -2) return "empty shape, or more experts or capacity tiles than the grid holds";
  if (code == -3) return "no current CUDA device";
  if (code <= kTmaError) {
    snprintf(msg, sizeof msg, "tensor map refused by the driver (CUresult %d)", kTmaError - code);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}
