// Sorted-segment mean with a base row, and sorted-segment sum, for Hopper
// (sm_90a).
//
// Replaces two Pallas TPU kernels of analysisgnn_tpu/kernels/pallas_segment.py:
//
//   * K1 segment_mean_base_sorted (kernel _mean_base_kernel, launcher
//     _mean_base_pallas).  For segment ids sorted ascending it computes
//
//         out[s]    = (x_base[s mod m] + sum_{seg_e == s} msgs[e]) / max(count_s, 1)
//         counts[s] = count_s
//
//     The base row is added to the sum but not counted; an empty segment
//     keeps its base row.
//   * K4 segment_sum_sorted (kernel _segment_sum_kernel), the same walk
//     without base row, count or divide:
//
//         out[s] = sum_{seg_e == s} msgs[e]        (0 for an empty segment)
//
// In both, ids outside [0, num_segments) (padding) lie outside
// row_ptr[0] .. row_ptr[S] and are never read.
//
// K1 reads its rows (msgs and x_base) as float32 or as bfloat16 (the row type
// is a template parameter); it accumulates in f32 and writes f32 out and
// counts either way, the dtype the JAX node layout gives at that point under
// bf16 compute (a bf16 sum over an f32 count).  The sum (K4) takes f32 only.
//
// Bound on the H100: bytes.  The mean reads E*F*b + E*4 + m*F*b bytes (b = 4
// for f32 rows, 2 for bf16) and writes S*F*4 + S*4 (the sum: E*F*4 + E*4
// in, S*F*4 out), and does about one add per message element, far below the
// card's 3.35 TB/s break-even arithmetic intensity.
//
// Design.  The TPU kernels contracted one-hot [128, 256] blocks on the MXU
// because Mosaic has no in-kernel gather and needs (8, 128) DMA tiles; none
// of that carries over.  Here the wrapper hands over CSR row pointers of the
// sorted ids, each block owns WARPS_PER_BLOCK consecutive segments (one warp
// per segment), and a warp walks its segment's contiguous edge range once
// with its lanes across the feature axis, four elements a load when
// F % 4 == 0 (16-byte float4 loads of f32 rows, 8-byte loads of bf16 rows;
// two such groups per lane, so a 256-wide row is one pass).  Sums stay
// in f32 registers and every output row is written once, so disjoint rows
// need no atomics.  The sum is a compile-time mode (MEAN = false) of the same
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// float4 chunks per lane in one pass over a segment's edges: 2 covers F <= 256
// (the hidden width of the trained models) with every edge's row loaded once
constexpr int CHUNKS = 2;

// the c-th group of four elements of a row, as f32
__device__ __forceinline__ float4 load4(const float* row, int c) {
  return __ldg(reinterpret_cast<const float4*>(row) + c);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + c);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T, bool VEC, bool MEAN>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
segment_mean_base_kernel(const T* __restrict__ msgs,
                         const int* __restrict__ row_ptr,
                         const T* __restrict__ x_base,
                         float* __restrict__ out,
                         float* __restrict__ counts,
                         int64_t num_segments, int64_t base_rows, int F) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t s = (int64_t)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (s >= num_segments) return;
  const int64_t e0 = row_ptr[s];
  const int64_t e1 = row_ptr[s + 1];
  // the sum mode has no base row (x_base may be null) and divides by 1
  const float denom = MEAN ? fmaxf((float)(e1 - e0), 1.0f) : 1.0f;
  const T* base = MEAN ? x_base + (s % base_rows) * (int64_t)F : nullptr;
  float* o = out + s * (int64_t)F;
  if (VEC) {
    const int F4 = F >> 2;
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int c0 = lane; c0 < F4; c0 += 32 * CHUNKS) {
      float4 acc[CHUNKS], b[CHUNKS];
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int c = c0 + 32 * k;
        b[k] = (MEAN && c < F4) ? load4(base, c) : acc[k];
      }
      const T* row = msgs + e0 * F;
      int64_t e = e0;
      // two edges per iteration: up to 2 * CHUNKS independent loads in flight
      for (; e + 1 < e1; e += 2, row += 2 * F) {
#pragma unroll
        for (int k = 0; k < CHUNKS; ++k) {
          const int c = c0 + 32 * k;
          if (c < F4) {
            const float4 v0 = load4(row, c);
            const float4 v1 = load4(row + F, c);
            add4(acc[k], v0);
            add4(acc[k], v1);
          }
        }
      }
      if (e < e1) {
#pragma unroll
        for (int k = 0; k < CHUNKS; ++k) {
          const int c = c0 + 32 * k;
          if (c < F4) add4(acc[k], load4(row, c));
        }
      }
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const int c = c0 + 32 * k;
        if (c < F4) {
          float4 r;
          r.x = (b[k].x + acc[k].x) / denom;
          r.y = (b[k].y + acc[k].y) / denom;
          r.z = (b[k].z + acc[k].z) / denom;
          r.w = (b[k].w + acc[k].w) / denom;
          o4[c] = r;
        }
      }
    }
  } else {
    for (int c = lane; c < F; c += 32) {
      float acc = 0.f;
      for (int64_t e = e0; e < e1; ++e) acc += load1(msgs + e * F + c);
      o[c] = MEAN ? (load1(base + c) + acc) / denom : acc;
    }
  }
  if (MEAN && lane == 0) counts[s] = (float)(e1 - e0);
}

template <typename T>
int mean_launch(const T* msgs, const int* row_ptr, const T* x_base, float* out, float* counts,
                long long num_segments, long long base_rows, int F, int vec, void* stream) {
  if (num_segments <= 0) return (int)cudaSuccess;
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((unsigned)((num_segments + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    segment_mean_base_kernel<T, true, true><<<grid, block, 0, st>>>(
        msgs, row_ptr, x_base, out, counts, num_segments, base_rows, F);
  } else {
    segment_mean_base_kernel<T, false, true><<<grid, block, 0, st>>>(
        msgs, row_ptr, x_base, out, counts, num_segments, base_rows, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// vec != 0 requires F % 4 == 0 and 16-byte aligned msgs, x_base and out.
extern "C" int segment_mean_base_launch(const float* msgs, const int* row_ptr,
                                        const float* x_base, float* out,
                                        float* counts, long long num_segments,
                                        long long base_rows, int F, int vec,
                                        void* stream) {
  return mean_launch<float>(msgs, row_ptr, x_base, out, counts, num_segments, base_rows, F, vec, stream);
}

// K1 on bf16 rows: msgs and x_base bf16, out and counts f32.  vec != 0
// requires F % 4 == 0, 8-byte aligned msgs and x_base and a 16-byte aligned out.
extern "C" int segment_mean_base_bf16_launch(const __nv_bfloat16* msgs, const int* row_ptr,
                                             const __nv_bfloat16* x_base, float* out,
                                             float* counts, long long num_segments,
                                             long long base_rows, int F, int vec,
                                             void* stream) {
  return mean_launch<__nv_bfloat16>(msgs, row_ptr, x_base, out, counts, num_segments, base_rows, F, vec, stream);
}

// K4: out[s] = sum of the msgs rows of segment s.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).  vec != 0 requires F % 4 == 0
// and 16-byte aligned msgs and out.
extern "C" int segment_sum_launch(const float* msgs, const int* row_ptr,
                                  float* out, long long num_segments, int F,
                                  int vec, void* stream) {
  if (num_segments <= 0) return (int)cudaSuccess;
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((unsigned)((num_segments + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    segment_mean_base_kernel<float, true, false><<<grid, block, 0, st>>>(
        msgs, row_ptr, nullptr, out, nullptr, num_segments, 1, F);
  } else {
    segment_mean_base_kernel<float, false, false><<<grid, block, 0, st>>>(
        msgs, row_ptr, nullptr, out, nullptr, num_segments, 1, F);
  }
  return (int)cudaGetLastError();
}
