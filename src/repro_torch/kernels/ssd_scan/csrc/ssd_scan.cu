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
// dtype and the final state [B, H, P, N] in float32.  All arithmetic is
// fp32, as in the TPU kernel.
//
// What bounds it on this card.  Per (batch, head) a chunk of Q rows does
// about 2 Q^2 N (C B^T) + Q^2 P (G u, lower triangle) + 2 Q N P (C S^T) +
// 2 Q P N (state update) operations against 2 Q P elements of x and y.  At
// mamba2-1.3b's shapes (H 64, P 64, N 128) that is some 60 fp32 operations
// for every byte moved, well above the card's 20 (67 TFLOP/s over
// 3.35 TB/s): the kernel is bound by operations, and by how fast fp32 FMAs
// can be fed from shared memory.
//
// What the design does about that.  The TPU kernel's chunk of 512 does not
// carry over (G alone would be 1 MB of fp32 against 227 KB of shared
// memory), and the result does not depend on the chunk, so this kernel takes
// Q = 64.  One block per (P slice of 32 columns, head, batch) walks the
// chunks in order, so the state never leaves the block: S^T lives in shared
// memory.  Per chunk the block stages B and C (both transposed, and B row
// by row) and u = x dt in shared memory as fp32, computes cum, G^T, y and
// the new state as four small products, each thread owning 4 x 4 outputs
// and reading two float4s for every 16 FMAs.  Tiles of G above the diagonal
// are skipped, and so is the part of G u past the diagonal.  The mask is
// applied in the exponent: exp is never taken of a positive difference.
// At P 64 two blocks share a head (each recomputes C B^T), so a batch of one
// gives 128 blocks for the 132 SMs.  It is a first, simple design on the FMA
// units: no tensor cores (C B^T would be exact on bf16 ones), no cp.async,
// one block per SM (149 KB of shared memory at N 128).
//
// Ragged S.  The TPU wrapper asserts that its chunk divides S; served
// prompts have exact lengths.  Rows past S in the last chunk are loaded as
// zeros with dt = 0: their decay is 1 and their u is 0, so the state passes
// through unchanged, and their y rows are not stored.  Inputs are contiguous
// (ops.py checks it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;          // rows of one chunk
constexpr int kMaxPT = 32;      // columns of P per block
constexpr int kMaxN = 128;      // largest state size the shared memory holds
constexpr int kThreads = 256;
constexpr int kPad = 4;         // row padding of the shared arrays, in floats
constexpr int kLDQ = kQ + kPad;

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

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_fwd(const Params p) {
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

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.N, p.pt) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd<T><<<dim3(p.P / p.pt, p.H, p.B), kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c and y): 0 float32, 1 bfloat16.  All tensors contiguous.
// Returns the CUDA error of the launch (0 on success), -1 for a dtype this
// library was not built for, -2 for a shape the kernel does not take.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt, const void* a,
                            const void* b, const void* c, void* y, void* state, int B, int S,
                            int H, int P, int N, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || N < 4 || N > kMaxN || N % 4 ||
      P < 4 || P % 4 || (P > kMaxPT && P % kMaxPT))
    return -2;
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c, y,
                 static_cast<float*>(state), B, S, H, P, N, P > kMaxPT ? kMaxPT : P};
  if (P / p.pt > 65535) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(p, st) : launch<float>(p, st);
}

extern "C" const char* ssd_scan_error_string(int code) {
  if (code == -1) return "dtype not built";
  if (code == -2) return "shape outside the kernel's limits";
  return cudaGetErrorString((cudaError_t)code);
}
