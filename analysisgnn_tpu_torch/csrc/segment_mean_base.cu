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
// Bound on the H100: bytes.  The mean reads E*F*4 + E*4 + m*F*4 bytes and
// writes S*F*4 + S*4 (the sum: E*F*4 + E*4 in, S*F*4 out), and does about one
// add per message element, far below the card's 3.35 TB/s break-even
// arithmetic intensity.
//
// Design.  The TPU kernels contracted one-hot [128, 256] blocks on the MXU
// because Mosaic has no in-kernel gather and needs (8, 128) DMA tiles; none
// of that carries over.  Here the wrapper hands over CSR row pointers of the
// sorted ids, each block owns WARPS_PER_BLOCK consecutive segments (one warp
// per segment), and a warp walks its segment's contiguous edge range once
// with its lanes across the feature axis, as 16-byte float4 loads when
// F % 4 == 0 (two float4 per lane, so a 256-wide row is one pass).  Sums stay
// in f32 registers and every output row is written once, so disjoint rows
// need no atomics.  The sum is a compile-time mode (MEAN = false) of the same
// kernel.

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

template <bool VEC, bool MEAN>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
segment_mean_base_kernel(const float* __restrict__ msgs,
                         const int* __restrict__ row_ptr,
                         const float* __restrict__ x_base,
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
  const float* base = MEAN ? x_base + (s % base_rows) * (int64_t)F : nullptr;
  float* o = out + s * (int64_t)F;
  if (VEC) {
    const int F4 = F >> 2;
    const float4* base4 = reinterpret_cast<const float4*>(base);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int c0 = lane; c0 < F4; c0 += 32 * CHUNKS) {
      float4 acc[CHUNKS], b[CHUNKS];
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int c = c0 + 32 * k;
        b[k] = (MEAN && c < F4) ? __ldg(base4 + c) : acc[k];
      }
      const float4* row = reinterpret_cast<const float4*>(msgs) + e0 * F4;
      int64_t e = e0;
      // two edges per iteration: up to 2 * CHUNKS independent loads in flight
      for (; e + 1 < e1; e += 2, row += 2 * F4) {
#pragma unroll
        for (int k = 0; k < CHUNKS; ++k) {
          const int c = c0 + 32 * k;
          if (c < F4) {
            const float4 v0 = __ldg(row + c);
            const float4 v1 = __ldg(row + F4 + c);
            add4(acc[k], v0);
            add4(acc[k], v1);
          }
        }
      }
      if (e < e1) {
#pragma unroll
        for (int k = 0; k < CHUNKS; ++k) {
          const int c = c0 + 32 * k;
          if (c < F4) add4(acc[k], __ldg(row + c));
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
      for (int64_t e = e0; e < e1; ++e) acc += __ldg(msgs + e * F + c);
      o[c] = MEAN ? (__ldg(base + c) + acc) / denom : acc;
    }
  }
  if (MEAN && lane == 0) counts[s] = (float)(e1 - e0);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// vec != 0 requires F % 4 == 0 and 16-byte aligned msgs, x_base and out.
extern "C" int segment_mean_base_launch(const float* msgs, const int* row_ptr,
                                        const float* x_base, float* out,
                                        float* counts, long long num_segments,
                                        long long base_rows, int F, int vec,
                                        void* stream) {
  if (num_segments <= 0) return (int)cudaSuccess;
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((unsigned)((num_segments + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    segment_mean_base_kernel<true, true><<<grid, block, 0, st>>>(
        msgs, row_ptr, x_base, out, counts, num_segments, base_rows, F);
  } else {
    segment_mean_base_kernel<false, true><<<grid, block, 0, st>>>(
        msgs, row_ptr, x_base, out, counts, num_segments, base_rows, F);
  }
  return (int)cudaGetLastError();
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
    segment_mean_base_kernel<true, false><<<grid, block, 0, st>>>(
        msgs, row_ptr, nullptr, out, nullptr, num_segments, 1, F);
  } else {
    segment_mean_base_kernel<false, false><<<grid, block, 0, st>>>(
        msgs, row_ptr, nullptr, out, nullptr, num_segments, 1, F);
  }
  return (int)cudaGetLastError();
}
