// Relation-weighted matmul and its gradients, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of analysisgnn_tpu/kernels/pallas_relmm.py::
// relation_weighted_matmul: the forward _fwd_kernel (pallas_call :73) and the
// backward _dwa_kernel (pallas_call :122).  With x [N, F], w [T, F, G] and
// alpha [T, N], all f32 and contiguous:
//
//     out[n, g]   = sum_t alpha[t, n] * sum_f x[n, f] * w[t, f, g]     (forward)
//     dx          = the forward with w^T [T, G, F] and gout [N, G]      (same kernel)
//     dw[t, f, g] = sum_n alpha[t, n] * x[n, f] * gout[n, g]
//     da[t, n]    = sum_g (x[n] @ w[t])[g] * gout[n, g]
//
// Bound on the H100: operations.  At the training shape (N = 5,376,
// F = G = 256, T = 7) each of the four computes 2*T*N*F*G = 4.93 GFLOP and
// moves about 13 MB, so the f32 rate outside the tensor cores (67 TFLOP/s)
// bounds it at about 74 us, against about 4 us for the bytes at 3.35 TB/s.
//
// Design.  The forward is one GEMM of [N, T*F] x [T*F, G] whose A tile is
// alpha[t, n] * x[n, f], scaled while it is staged into shared memory, so the
// [T, N, G] intermediate of the einsum never exists: each block owns a 64x64
// tile of out, loops over (t, f) in chunks of 16, accumulates a 4x4 micro-tile
// per thread in f32 registers, and writes its tile once.  The TPU kernel's
// dw accumulated into one output block across its sequential grid; GPU blocks
// run in parallel, so here each block owns one 64x64 tile of dw[t] and loops
// over all N rows itself: no atomics, and the same result on every run.  da
// is a row-wise dot: each block owns 64 rows n of one relation t, recomputes
// (x @ w[t]) tile by tile over G and dots it with gout in registers.  It does
// NOT share the g @ w[t]^T product of dx (dx sums over t, da needs each t
// apart); in the edge-zxp model alpha carries no gradient, so the wrapper
// launches it only when autograd asks for d alpha.  All sums are f32 FMAs on
// the SIMT cores (no TF32); wgmma, TMA and pipelined staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of the output tile
constexpr int BN = 64;   // columns of the output tile
constexpr int BK = 16;   // depth of one shared-memory chunk
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int APAD = 4;  // keeps float4 alignment and spreads the A stores over banks

struct Tiles {
  float a[BK][BM + APAD];  // a[k][m]
  float b[BK][BN];         // b[k][n]
};

// acc[i][j] += sum_k a[k][ty*TM + i] * b[k][tx*TN + j]
__device__ __forceinline__ void mma_chunk(const Tiles& s, float (&acc)[TM][TN], int ty, int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&s.a[k][ty * TM]);
    const float4 bv = *reinterpret_cast<const float4*>(&s.b[k][tx * TN]);
    const float ar[TM] = {av.x, av.y, av.z, av.w};
    const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// a[k][m] = scale[m0+m] * src[(m0+m)*ld + k0+k], zero outside m < m_lim, k < k_lim.
// Consecutive threads read consecutive k of one row (the contiguous axis).
template <bool SCALED>
__device__ __forceinline__ void stage_a_rows(Tiles& s, const float* __restrict__ src,
                                             const float* __restrict__ scale, int64_t m0,
                                             int64_t m_lim, int k0, int k_lim, int ld, int tid) {
#pragma unroll
  for (int idx = tid; idx < BM * BK; idx += THREADS) {
    const int m = idx / BK, k = idx % BK;
    const int64_t gm = m0 + m;
    const int gk = k0 + k;
    float v = 0.f;
    if (gm < m_lim && gk < k_lim) {
      v = __ldg(src + gm * ld + gk);
      if (SCALED) v *= __ldg(scale + gm);
    }
    s.a[k][m] = v;
  }
}

// a[k][m] = scale[k0+k] * src[(k0+k)*ld + m0+m], zero outside k < k_lim, m < m_lim.
__device__ __forceinline__ void stage_a_cols(Tiles& s, const float* __restrict__ src,
                                             const float* __restrict__ scale, int64_t k0,
                                             int64_t k_lim, int m0, int m_lim, int ld, int tid) {
#pragma unroll
  for (int idx = tid; idx < BM * BK; idx += THREADS) {
    const int k = idx / BM, m = idx % BM;
    const int64_t gk = k0 + k;
    const int gm = m0 + m;
    float v = 0.f;
    if (gk < k_lim && gm < m_lim) v = __ldg(scale + gk) * __ldg(src + gk * ld + gm);
    s.a[k][m] = v;
  }
}

// b[k][n] = src[(k0+k)*ld + n0+n], zero outside k < k_lim, n < n_lim.
__device__ __forceinline__ void stage_b(Tiles& s, const float* __restrict__ src, int64_t k0,
                                        int64_t k_lim, int n0, int n_lim, int ld, int tid) {
#pragma unroll
  for (int idx = tid; idx < BK * BN; idx += THREADS) {
    const int k = idx / BN, n = idx % BN;
    const int64_t gk = k0 + k;
    const int gn = n0 + n;
    s.b[k][n] = (gk < k_lim && gn < n_lim) ? __ldg(src + gk * ld + gn) : 0.f;
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// out [N, G] = sum_t alpha[t] (.) (x @ w[t]); grid (ceil(N/BM), ceil(G/BN)).
__global__ void __launch_bounds__(THREADS)
rwm_forward_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ alpha, float* __restrict__ out,
                   int64_t N, int F, int G, int T) {
  __shared__ __align__(16) Tiles s;
  const int tid = threadIdx.x, ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int64_t n0 = (int64_t)blockIdx.x * BM;
  const int g0 = blockIdx.y * BN;
  float acc[TM][TN];
  zero(acc);
  for (int t = 0; t < T; ++t) {
    const float* wt = w + (int64_t)t * F * G;
    const float* at = alpha + (int64_t)t * N;
    for (int f0 = 0; f0 < F; f0 += BK) {
      stage_a_rows<true>(s, x, at, n0, N, f0, F, F, tid);
      stage_b(s, wt, f0, F, g0, G, G, tid);
      __syncthreads();
      mma_chunk(s, acc, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t n = n0 + ty * TM + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int g = g0 + tx * TN + j;
      if (g < G) out[n * G + g] = acc[i][j];
    }
  }
}

// dw [T, F, G]: dw[t] = (alpha[t] (.) x)^T @ gout; grid (ceil(F/BM), ceil(G/BN), T).
__global__ void __launch_bounds__(THREADS)
rwm_dw_kernel(const float* __restrict__ x, const float* __restrict__ gout,
              const float* __restrict__ alpha, float* __restrict__ dw,
              int64_t N, int F, int G) {
  __shared__ __align__(16) Tiles s;
  const int tid = threadIdx.x, ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int f0 = blockIdx.x * BM;
  const int g0 = blockIdx.y * BN;
  const int t = blockIdx.z;
  const float* at = alpha + (int64_t)t * N;
  float acc[TM][TN];
  zero(acc);
  for (int64_t n0 = 0; n0 < N; n0 += BK) {
    stage_a_cols(s, x, at, n0, N, f0, F, F, tid);
    stage_b(s, gout, n0, N, g0, G, G, tid);
    __syncthreads();
    mma_chunk(s, acc, ty, tx);
    __syncthreads();
  }
  float* dwt = dw + (int64_t)t * F * G;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int f = f0 + ty * TM + i;
    if (f >= F) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int g = g0 + tx * TN + j;
      if (g < G) dwt[(int64_t)f * G + g] = acc[i][j];
    }
  }
}

// da [T, N]: da[t, n] = <(x @ w[t])[n], gout[n]>; grid (ceil(N/BM), T).
__global__ void __launch_bounds__(THREADS)
rwm_dalpha_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ gout, float* __restrict__ da,
                  int64_t N, int F, int G) {
  __shared__ __align__(16) Tiles s;
  const int tid = threadIdx.x, ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int64_t n0 = (int64_t)blockIdx.x * BM;
  const int t = blockIdx.y;
  const float* wt = w + (int64_t)t * F * G;
  float dot[TM] = {0.f, 0.f, 0.f, 0.f};
  for (int g0 = 0; g0 < G; g0 += BN) {
    float acc[TM][TN];
    zero(acc);
    for (int f0 = 0; f0 < F; f0 += BK) {
      stage_a_rows<false>(s, x, nullptr, n0, N, f0, F, F, tid);
      stage_b(s, wt, f0, F, g0, G, G, tid);
      __syncthreads();
      mma_chunk(s, acc, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t n = n0 + ty * TM + i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int g = g0 + tx * TN + j;
        if (g < G) dot[i] = fmaf(acc[i][j], __ldg(gout + n * G + g), dot[i]);
      }
    }
  }
  // the BN / TN = 16 threads sharing ty are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = (BN / TN) / 2; off > 0; off >>= 1) dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t n = n0 + ty * TM + i;
      if (n < N) da[(int64_t)t * N + n] = dot[i];
    }
  }
}

inline unsigned cdiv(int64_t a, int64_t b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

// Each launcher runs on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is a contiguous f32 array of the shape named above.

extern "C" int rwm_forward_launch(const float* x, const float* w, const float* alpha, float* out,
                                  long long N, int F, int G, int T, void* stream) {
  if (N <= 0 || G <= 0) return (int)cudaSuccess;
  const dim3 grid(cdiv(N, BM), cdiv(G, BN));
  rwm_forward_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, w, alpha, out, N, F, G, T);
  return (int)cudaGetLastError();
}

extern "C" int rwm_dw_launch(const float* x, const float* gout, const float* alpha, float* dw,
                             long long N, int F, int G, int T, void* stream) {
  if (T <= 0 || F <= 0 || G <= 0) return (int)cudaSuccess;
  const dim3 grid(cdiv(F, BM), cdiv(G, BN), (unsigned)T);
  rwm_dw_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, gout, alpha, dw, N, F, G);
  return (int)cudaGetLastError();
}

extern "C" int rwm_dalpha_launch(const float* x, const float* w, const float* gout, float* da,
                                 long long N, int F, int G, int T, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaSuccess;
  const dim3 grid(cdiv(N, BM), (unsigned)T);
  rwm_dalpha_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, w, gout, da, N, F, G);
  return (int)cudaGetLastError();
}
