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
// internlm2-1.8b shapes (H 16, KV 8, D 128, bf16) the operations over
// 989 TFLOP/s outweigh the bytes over 3.35 TB/s once S exceeds about 900:
// long prompts are bound by the tensor cores, short ones by memory.
//
// What the design does about that.  The bf16 kernel runs both products on
// the tensor cores (mma.sync m16n8k16 with fp32 accumulation), keeps each
// 64 x 64 score tile in registers so that no score reaches device memory,
// reads each K/V tile once per 64-row query tile, and skips the tiles beyond
// the causal frontier or outside the window, so it does only the causal half
// of the work.  The heaviest query tiles are launched first to even out the
// causal imbalance.  It is a first, simple design: no TMA, no wgmma, no warp
// specialisation and no double buffering yet.  The fp32 kernel, used where
// the model computes in fp32, runs on the FMA units: TF32 tensor cores would
// not hold fp32's tolerance.
//
// Layout.  q and o are [B, S, H, D], k and v [B, Skv, KV, D], read through
// their strides with the last dim contiguous, so the caller needs no
// transpose copy.  GQA maps query head h to kv head h / (H / KV).  Rows past
// S and keys past Skv are masked, so S need not be a multiple of the tile.
// The caller guarantees 16-byte aligned rows (see ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---------------------------------------------------------------- bf16
constexpr int kBQ = 64;  // query rows per block: 16 per warp
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layout of mma m16n8k16 (lane = 4 * g + tg):
//   A 16x16: a0 (g, 2tg..2tg+1), a1 (g+8, 2tg..), a2 (g, 2tg+8..), a3 (g+8, 2tg+8..)
//   B 16x8:  b0 (k 2tg..2tg+1, n g), b1 (k 2tg+8.., n g)
//   C 16x8:  c0,c1 (g, 2tg..2tg+1), c2,c3 (g+8, 2tg..2tg+1)
// Two neighbouring C tiles of P form one A fragment of the P V product.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  constexpr int LD = D + 8;     // pitch of the Q and K tiles: conflict-free fragment loads
  constexpr int LDV = kBK + 8;  // pitch of the transposed V tile
  constexpr int KD = D / 16;    // k-steps of Q K^T
  constexpr int ND = D / 8;     // n-tiles of the output
  constexpr int NK = kBK / 8;   // n-tiles of the score tile
  constexpr int VEC = 8;        // bf16 per 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBQ][LD]
  __nv_bfloat16* Ks = Qs + kBQ * LD;                           // [kBK][LD]
  __nv_bfloat16* Vt = Ks + kBK * LD;                           // [D][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kBQ;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * (D / VEC); i += kThreads) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.S) val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  __syncthreads();

  uint32_t qf[KD][4];
  {
    const __nv_bfloat16* base = Qs + (warp * 16 + g) * LD + tg * 2;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ld_u32(base + kk * 16);
      qf[kk][1] = ld_u32(base + 8 * LD + kk * 16);
      qf[kk][2] = ld_u32(base + kk * 16 + 8);
      qf[kk][3] = ld_u32(base + 8 * LD + kk * 16 + 8);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this lane's part of the normaliser
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0 and row0 + 8
  const float scale_log2 = p.scale * 1.4426950408889634f;

  int t_begin, t_end;
  kv_tile_range(p, q0, kBQ, kBK, &t_begin, &t_end);
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBK * (D / VEC); i += kThreads) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kk4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.Skv) {
        kk4 = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_ss + c);
        vv4 = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kk4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < VEC; ++j) Vt[(c + j) * LDV + r] = ve[j];
    }
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kb = Ks + (nt * 8 + g) * LD + tg * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma_16816(s[nt], qf[kk], ld_u32(kb + kk * 16), ld_u32(kb + kk * 16 + 8));
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + nt * 8 + tg * 2 + (e & 1);
        const float x = attends(p, row, col) ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // every key so far masked
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2f(s[nt][e] - base[e >> 1]);
        s[nt][e] = pr;
        rs[e >> 1] += pr;
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kt][0], s[2 * kt][1]), pack_bf16(s[2 * kt][2], s[2 * kt][3]),
          pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
      const __nv_bfloat16* vb = Vt + g * LDV + kt * 16 + tg * 2;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        mma_16816(acc[nd], a, ld_u32(vb + nd * 8 * LDV), ld_u32(vb + nd * 8 * LDV + 8));
    }
  }

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  if (row0 < p.S) {
    __nv_bfloat16* orow = og + row0 * p.o_ss + tg * 2;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) = pack_bf16(acc[nd][0] / d0, acc[nd][1] / d0);
  }
  if (row0 + 8 < p.S) {
    __nv_bfloat16* orow = og + (row0 + 8) * p.o_ss + tg * 2;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) = pack_bf16(acc[nd][2] / d1, acc[nd][3] / d1);
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
int launch(Kernel kernel, int q_tiles, int threads, size_t smem, const Params& p,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(q_tiles, p.B * p.H), threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 1) {
    const size_t smem = sizeof(__nv_bfloat16) * ((kBQ + kBK) * (D + 8) + D * (kBK + 8));
    return launch(flash_fwd_bf16<D>, (p.S + kBQ - 1) / kBQ, kThreads, smem, p, stream);
  }
  const size_t smem = sizeof(float) * ((kFBQ + kFBK) * (D + 1) + kFBK * D + kFBQ * (kFBK + 1));
  return launch(flash_fwd_f32<D>, (p.S + kFBQ - 1) / kFBQ, kFThreads, smem, p, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements.  Returns the
// cudaGetLastError() of the launch (0 on success), or -1 for a head dim or
// dtype this library was not built for.
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
  return code < 0 ? "head dim or dtype not built" : cudaGetErrorString((cudaError_t)code);
}
