// Fused segment softmax + weighted aggregation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel analysisgnn_tpu/kernels/pallas_segment.py::
// segment_softmax_agg_sorted (kernel _softmax_agg_kernel, launcher
// _ssa_impl): the HGT attention reduction.  Edges lie in B relation blocks;
// inside a block they are sorted by node, padding last.  For every node v
// and head h, over v's edges in ALL blocks,
//
//     max[v, h] = max_e logits[e, h]                (0 for a node without edges)
//     den[v, h] = max(sum_e exp(logits[e, h] - max[v, h]), 1e-16)
//     out[v, h*D + d] = sum_e exp(logits[e, h] - max[v, h]) * msgs[e, h*D + d] / den[v, h]
//
// msgs is head-major: feature f belongs to head f / D.  max and den are
// written for the backward, which recomputes the weights from them.
//
// Bound on the H100: bytes.  The function reads each valid edge's logits and
// message row once (E_valid * (H + F) * 4 bytes, plus the row pointers) and
// writes out, max and den once; it does a few operations per message
// element.  Padding edges are neither read nor needed.
//
// Design.  The TPU kernel walked 256-node tiles, DMA'd 1024-edge chunks and
// built one-hot [128, 256] matrices for the MXU, because Mosaic has no
// in-kernel gather.  None of that carries over.  Here row_ptr[b * (n + 1) + v]
// is where node v's edges start in block b (row_ptr[b * (n + 1) + n] is
// where the block's padding starts), one warp owns one node, and it walks
// the node's B edge ranges twice:
//   pass 1: lanes stride over the node's edges and take the per-head max,
//           reduced across the warp with shuffles;
//   pass 2: lanes lie across the feature axis (16-byte float4 loads when
//           the layout allows: lane l holds chunks l and l + 32, so a
//           256-wide row is one pass), and each lane sums the exp-weighted
//           messages and the exp weights of its chunks' heads, reading each
//           valid message row once.
// Each output row, its max and its den are written once: disjoint rows need
// no atomics.  A lane loads the ranges of up to 32 blocks at once and the
// warp broadcasts them with shuffles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_HEADS = 32;
constexpr unsigned FULL = 0xffffffffu;

// W floats per chunk: a float4 load, or one float
template <int W>
struct Chunk;

template <>
struct Chunk<4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Chunk<1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

// this lane's share of the edge ranges of blocks b0 .. b0 + 31 of node v
__device__ __forceinline__ void load_ranges(const int* __restrict__ row_ptr, int64_t stride, int64_t v,
                                            int b0, int num_blocks, int lane, int& start, int& end) {
  start = end = 0;
  if (b0 + lane < num_blocks) {
    const int64_t i = (int64_t)(b0 + lane) * stride + v;
    start = __ldg(row_ptr + i);
    end = __ldg(row_ptr + i + 1);
  }
}

template <int W, int CHUNKS>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
segment_softmax_agg_kernel(const float* __restrict__ logits,  // [E, H]
                           const float* __restrict__ msgs,    // [E, F], head-major
                           const int* __restrict__ row_ptr,   // [B * (n + 1)]
                           float* __restrict__ out,           // [n, F]
                           float* __restrict__ node_max,      // [n, H]
                           float* __restrict__ node_den,      // [n, H]
                           int64_t n, int num_blocks, int H, int F) {
  __shared__ float smax[WARPS_PER_BLOCK][MAX_HEADS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t v = (int64_t)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (v >= n) return;  // the whole warp: v depends on the warp only
  const int64_t stride = n + 1;
  const int D = F / H;

  // ---- pass 1: per-head max over all blocks ----
  if (lane < H) smax[warp][lane] = -INFINITY;
  __syncwarp();
  for (int b0 = 0; b0 < num_blocks; b0 += 32) {
    int my_start, my_end;
    load_ranges(row_ptr, stride, v, b0, num_blocks, lane, my_start, my_end);
    const int nb = min(32, num_blocks - b0);
    for (int h = 0; h < H; ++h) {
      float m = -INFINITY;
      for (int bb = 0; bb < nb; ++bb) {
        const int e0 = __shfl_sync(FULL, my_start, bb);
        const int e1 = __shfl_sync(FULL, my_end, bb);
        for (int e = e0 + lane; e < e1; e += 32) m = fmaxf(m, __ldg(logits + (int64_t)e * H + h));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      if (lane == 0) smax[warp][h] = fmaxf(smax[warp][h], m);
      __syncwarp();
    }
  }
  if (lane < H) {
    float m = smax[warp][lane];
    if (!isfinite(m)) m = 0.f;  // a node without edges: max 0, as the TPU kernel
    smax[warp][lane] = m;
    node_max[v * H + lane] = m;
  }
  __syncwarp();

  // ---- pass 2: exp-weighted sums and denominators ----
  const int FW = F / W;  // chunks in a row
  for (int c0 = 0; c0 < FW; c0 += 32 * CHUNKS) {  // the same trip count on every lane
    float acc[CHUNKS][W];
    float den[CHUNKS];
    float mk[CHUNKS];
    int head[CHUNKS];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int c = c0 + lane + 32 * k;
      head[k] = c < FW ? (c * W) / D : 0;
      mk[k] = smax[warp][head[k]];
      den[k] = 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j) acc[k][j] = 0.f;
    }
    for (int b0 = 0; b0 < num_blocks; b0 += 32) {
      int my_start, my_end;
      load_ranges(row_ptr, stride, v, b0, num_blocks, lane, my_start, my_end);
      const int nb = min(32, num_blocks - b0);
      for (int bb = 0; bb < nb; ++bb) {
        const int e0 = __shfl_sync(FULL, my_start, bb);
        const int e1 = __shfl_sync(FULL, my_end, bb);
#pragma unroll 2
        for (int e = e0; e < e1; ++e) {
          const float* lrow = logits + (int64_t)e * H;
          const float* mrow = msgs + (int64_t)e * F;
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k) {
            const int c = c0 + lane + 32 * k;
            if (c < FW) {
              const float w = expf(__ldg(lrow + head[k]) - mk[k]);
              float x[W];
              Chunk<W>::load(mrow + c * W, x);
              den[k] += w;
#pragma unroll
              for (int j = 0; j < W; ++j) acc[k][j] = fmaf(w, x[j], acc[k][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < FW) {
        const float d = fmaxf(den[k], 1e-16f);
        float r[W];
#pragma unroll
        for (int j = 0; j < W; ++j) r[j] = acc[k][j] / d;
        Chunk<W>::store(out + v * F + c * W, r);
        if ((c * W) % D == 0) node_den[v * H + head[k]] = d;  // the lane holding the head's first feature
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Requires 1 <= H <= 32 and F % H == 0; vec != 0 further requires
// (F / H) % 4 == 0 and 16-byte aligned msgs and out.
extern "C" int segment_softmax_agg_launch(const float* logits, const float* msgs, const int* row_ptr,
                                          float* out, float* node_max, float* node_den, long long n,
                                          int num_blocks, int H, int F, int vec, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((unsigned)((n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    segment_softmax_agg_kernel<4, 2><<<grid, block, 0, st>>>(logits, msgs, row_ptr, out, node_max, node_den, n,
                                                             num_blocks, H, F);
  } else {
    segment_softmax_agg_kernel<1, 8><<<grid, block, 0, st>>>(logits, msgs, row_ptr, out, node_max, node_den, n,
                                                             num_blocks, H, F);
  }
  return (int)cudaGetLastError();
}
