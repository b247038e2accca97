// Grouped expert matmul for Hopper (sm_90a): out[e] = x[e] @ w[e].
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py::_gmm_kernel
// (driven by grouped_matmul there).  It computes the same function: x
// [E, C, D] (capacity buckets of E experts) times w [E, D, F], the products
// summed in fp32 over D and the result cast to x's dtype, [E, C, F].
//
// What bounds it on this card.  One call does 2*E*C*D*F operations and must
// move (E*C*D + E*D*F + E*C*F) elements.  At granite-moe-1b-a400m's shapes
// (E 32, D 1024, F 512, bf16) the expert weights alone are 33.5 MB a call,
// so decode (C = 8 on 4 slots) is bound by memory (about 0.010 ms over
// 3.35 TB/s).  A prefill group of 4 x 1024 tokens (C = 1280) moves 159 MB
// (0.048 ms) and does 42.9 GFLOP (0.043 ms over 989 TFLOP/s): the two bounds
// are close, so a fast kernel has to keep both the tensor cores and the
// memory busy.
//
// What the design does about that.  One block per (F tile, C tile, expert)
// of 64 x 64 outputs keeps its fp32 accumulators in registers and loops over
// D in tiles of 32, so nothing but the output reaches device memory and each
// weight tile is read once per C tile (once per call in decode, where C fits
// one tile).  Tiles stream into shared memory through a three-stage cp.async
// ring, so the loads of the next two tiles are in flight while the tensor
// cores work on this one; that also keeps enough bytes in flight for the
// memory-bound decode.  The bf16 kernel runs on the tensor cores (ldmatrix
// and mma.sync m16n8k16, fp32 accumulation): a product of two bf16 values is
// exact in fp32, which is the TPU kernel's arithmetic (it upcasts and sums in
// fp32).  The fp32 kernel runs on the FMA units: TF32 tensor cores would not
// hold fp32's tolerance over D = 1024.  It is a first, simple design: no TMA,
// no wgmma, no warp specialisation, no persistent blocks.
//
// Layout.  x, w and out are read and written through their strides on the
// leading dims; the last dim of each is contiguous and every row starts on a
// 16-byte boundary, and D and F are multiples of 16 bytes' worth of
// elements (ops.py checks all of it).  Rows past C, columns past F and depth
// past D are masked here, so C (the capacity, ragged in serving) may be any
// size >= 1: the TPU wrapper asserts that its block divides C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device to shared memory; src_bytes 0 writes 16 zero bytes
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- bf16
constexpr int kBM = 64;  // rows of C per block
constexpr int kBN = 64;  // columns of F per block
constexpr int kBK = 32;  // depth of one shared-memory tile
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 2 x 2 warps of 32 x 32 outputs
constexpr int kLDA = kBK + 8;  // pitches of 80 and 144 bytes: conflict-free ldmatrix
constexpr int kLDB = kBN + 8;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage depth tile kt of x (rows m0.., into as [kBM][kLDA]) and of w
// (columns n0.., into bs [kBK][kLDB]) with 16-byte cp.async copies; chunks
// past C, D or F are filled with zeros.
__device__ __forceinline__ void load_tile_bf16(const Params& p, const __nv_bfloat16* xg,
                                               const __nv_bfloat16* wg, __nv_bfloat16* as,
                                               __nv_bfloat16* bs, int m0, int n0, int kt) {
  const int k0 = kt * kBK;
  for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    const bool in = m0 + r < p.C && k0 + c < p.D;
    cp_async16(as + r * kLDA + c, in ? xg + (m0 + r) * p.x_sc + k0 + c : xg, in ? 16 : 0);
  }
  for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const bool in = k0 + r < p.D && n0 + c < p.F;
    cp_async16(bs + r * kLDB + c, in ? wg + (k0 + r) * p.w_sd + n0 + c : wg, in ? 16 : 0);
  }
}

// Fragments of mma m16n8k16 (lane = 4 * g + tg):
//   A 16x16: a0 (g, 2tg..2tg+1), a1 (g+8, 2tg..), a2 (g, 2tg+8..), a3 (g+8, 2tg+8..)
//   B 16x8:  b0 (k 2tg..2tg+1, n g), b1 (k 2tg+8.., n g)
//   C 16x8:  c0,c1 (g, 2tg..2tg+1), c2,c3 (g+8, 2tg..2tg+1)
// ldmatrix.x4 takes the row addresses of four 8x8 matrices from lanes 0-7,
// 8-15, 16-23 and 24-31.  Addressing row (lane & 15), column (lane >> 4) * 8
// of a 16x16 tile gives A's a0..a3 from the row-major x tile, and, with
// .trans, b0/b1 of two neighbouring n8 tiles from the row-major [k][n] w tile.
__global__ void __launch_bounds__(kThreads) gmm_bf16(const Params p) {
  __shared__ __align__(128) __nv_bfloat16 As[kStages][kBM * kLDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kStages][kBK * kLDB];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) + e * p.x_se;
  const __nv_bfloat16* wg = static_cast<const __nv_bfloat16*>(p.w) + e * p.w_se;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + e * p.o_se;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  const int ktiles = (p.D + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile_bf16(p, xg, wg, As[s], Bs[s], m0, n0, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (for this thread)
    __syncthreads();               // ...for every thread, and tile kt - 1 is consumed
    const int nk = kt + kStages - 1;  // refill the stage that tile kt - 1 used
    if (nk < ktiles) load_tile_bf16(p, xg, wg, As[nk % kStages], Bs[nk % kStages], m0, n0, nk);
    cp_async_commit();

    const __nv_bfloat16* as = As[kt % kStages];
    const __nv_bfloat16* bs = Bs[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * kLDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * kLDB + wn * 32 + nj * 16 + (lane >> 4) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int row = m0 + wm * 32 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + tg * 2;
      if (col >= p.F) continue;
      if (row < p.C)
        *reinterpret_cast<uint32_t*>(og + row * p.o_sc + col) =
            pack_bf16(acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < p.C)
        *reinterpret_cast<uint32_t*>(og + (row + 8) * p.o_sc + col) =
            pack_bf16(acc[mi][ni][2], acc[mi][ni][3]);
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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the last dim of
// x, w and o has stride 1.  Returns the cudaGetLastError() of the launch (0
// on success), -1 for a dtype this library was not built for, -2 for an
// empty or oversized shape.
extern "C" int moe_gmm_fwd(int dtype, const void* x, const void* w, void* o, long long x_se,
                           long long x_sc, long long w_se, long long w_sd, long long o_se,
                           long long o_sc, int E, int C, int D, int F, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 || (C + kBM - 1) / kBM > 65535) return -2;
  const Params p{x, w, o, x_se, x_sc, w_se, w_sd, o_se, o_sc, E, C, D, F};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    gmm_bf16<<<dim3((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E), kThreads, 0, st>>>(p);
  } else {
    gmm_f32<<<dim3((F + kFBN - 1) / kFBN, (C + kFBM - 1) / kFBM, E), kFThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* moe_gmm_error_string(int code) {
  if (code == -1) return "dtype not built";
  if (code == -2) return "empty shape, or more experts or capacity tiles than the grid holds";
  return cudaGetErrorString((cudaError_t)code);
}
