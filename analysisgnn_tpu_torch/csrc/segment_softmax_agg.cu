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
// where the block's padding starts), and one warp owns one node.  At the
// HGT train shape (n = 7,936, 13 blocks, mean degree 9, max 33; 2,513 nodes
// without edges, 3.4 non-empty ranges a node) a warp that walked every
// range once per head for the max and then loaded one message row at a time
// would wait on H x B + degree dependent memory rounds.  The design cuts
// that chain:
//   ranges: lane b loads block b's (start, end) once, for up to 32 blocks at
//           a time; a warp prefix sum of the lengths and a ballot of the
//           non-empty ones give every lane the node's edges as one flat list
//           in block order, walked in chunks of 32 (lane l holds the chunk's
//           l-th edge index).  Empty ranges cost no loop trip, and a node
//           without edges writes max 0, den 1e-16 and a zero row and leaves;
//   pass 1: lanes lie across (edge, head) pairs, H heads by G = 32 / H
//           (rounded down to a power of two) edges, and each lane issues its
//           (up to 4 per chunk at H = 4) logit loads before the first max;
//           one shuffle tree across the G edge groups gives each head's max;
//   pass 2: lanes lie across the feature axis (16-byte float4 loads when the
//           layout allows: lane l holds chunks l and l + 32, so a 256-wide
//           row is one pass), and the warp loads PREFETCH edges' message rows
//           and logits before its first FMA, then sums the exp-weighted
//           messages and the exp weights of its chunks' heads edge by edge,
//           reading each valid message row once.
// Pass 2 adds the terms edge by edge in the walk's order whatever PREFETCH
// is, so the sums' rounding does not depend on it.  Each output row, its
// max and its den are written once: disjoint rows need no atomics.
// Blocks past the 32nd are walked the same way, 32 at a time.
//
// Occupancy.  PREFETCH = 4 holds 4 x 2 float4s of messages a lane: ptxas
// gives the float4 kernel 95 registers, so 5 blocks of 4 warps fit an SM
// (20 warps; 7,936 nodes are 3 such waves).  Timed on an H100 (700 W)
// while the kernel was designed, 4 rows in flight beat 1, 2 and 8 (8
// spills in the scalar kernel and leaves 8 warps an SM), and 4 warps a
// block beat 8 (a block waits for its slowest warp).  Two other ways to
// keep more rows in flight gained nothing there and are not kept: asking
// the L2 for each range's rows ahead (cp.async.bulk.prefetch), and a
// warp-private shared-memory ring of 2 to 8 rows a stage filled by
// cp.async.bulk on mbarriers.  Without pass 1 the kernel was no faster,
// and without pass 2's message loads it took under half the time: what is
// left is the message rows' gather.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 4;
constexpr int MAX_HEADS = 32;
constexpr int PREFETCH = 4;  // message rows a warp loads before it adds the first
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

// Walks node v's edges of all blocks in block order, in chunks of up to 32:
// body(my_e, cnt) with lane l < cnt holding the chunk's l-th edge index.
// Returns the node's degree.  Every lane of the warp calls it together.
template <class Body>
__device__ __forceinline__ int walk_edges(const int* __restrict__ row_ptr, int64_t stride, int64_t v,
                                          int num_blocks, int lane, Body&& body) {
  int total = 0;
  for (int b0 = 0; b0 < num_blocks; b0 += 32) {
    int start = 0, len = 0;
    if (b0 + lane < num_blocks) {
      const int64_t i = (int64_t)(b0 + lane) * stride + v;
      start = __ldg(row_ptr + i);
      len = __ldg(row_ptr + i + 1) - start;
    }
    int incl = len;  // the node's edges in blocks b0 .. b0 + lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    const int excl = incl - len;
    const int deg = __shfl_sync(FULL, incl, 31);
    const unsigned nonempty = __ballot_sync(FULL, len > 0);
    for (int c = 0; c < deg; c += 32) {
      const int i = c + lane;  // this lane's place in the flat list: in exactly one non-empty range
      int my_e = 0;
      for (unsigned m = nonempty; m; m &= m - 1) {
        const int b = __ffs(m) - 1;
        const int bx = __shfl_sync(FULL, excl, b);
        const int bs = __shfl_sync(FULL, start, b);
        const int bl = __shfl_sync(FULL, len, b);
        if (i >= bx && i < bx + bl) my_e = bs + (i - bx);
      }
      body(my_e, min(32, deg - c));
    }
    total += deg;
  }
  return total;
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
  const int lane = threadIdx.x & 31;
  const int64_t v = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (v >= n) return;  // the whole warp: v depends on the warp only
  const int64_t stride = n + 1;
  const int D = F / H;
  const int FW = F / W;  // chunks in a row

  // ---- pass 1: per-head max; lane (g, h) = (lane / H, lane % H) takes head
  // h of each chunk's edges g, g + G, g + 2G, ... ----
  const int G = 1 << (31 - __clz(32 / H));  // a power of two, G * H <= 32
  const int P = G * H;                      // lanes at work
  const int hl = lane % H, gl = lane / H;
  float m = -INFINITY;
  const int deg = walk_edges(row_ptr, stride, v, num_blocks, lane, [&](int my_e, int cnt) {
    const int kmax = (cnt + G - 1) / G;
    for (int k0 = 0; k0 < kmax; k0 += 4) {
      float lv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = gl + G * (k0 + u);
        const int e = __shfl_sync(FULL, my_e, idx & 31);
        lv[u] = (lane < P && idx < cnt) ? __ldg(logits + (int64_t)e * H + hl) : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) m = fmaxf(m, lv[u]);
    }
  });
  for (int off = P >> 1; off >= H; off >>= 1) m = fmaxf(m, __shfl_down_sync(FULL, m, off));
  // lane h < H now holds head h's max
  if (!isfinite(m)) m = 0.f;  // a node without edges: max 0, as the TPU kernel
  if (lane < H) node_max[v * H + lane] = m;
  if (deg == 0) {  // den 1e-16 and a zero row
    if (lane < H) node_den[v * H + lane] = 1e-16f;
    float z[W];
#pragma unroll
    for (int j = 0; j < W; ++j) z[j] = 0.f;
    for (int c = lane; c < FW; c += 32) Chunk<W>::store(out + v * F + c * W, z);
    return;
  }

  // ---- pass 2: exp-weighted sums and denominators, PREFETCH rows at a time ----
  for (int c0 = 0; c0 < FW; c0 += 32 * CHUNKS) {  // the same trip count on every lane
    float acc[CHUNKS][W];
    float den[CHUNKS];
    float mk[CHUNKS];
    int head[CHUNKS];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int c = c0 + lane + 32 * k;
      head[k] = c < FW ? (c * W) / D : 0;
      mk[k] = __shfl_sync(FULL, m, head[k]);
      den[k] = 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j) acc[k][j] = 0.f;
    }
    walk_edges(row_ptr, stride, v, num_blocks, lane, [&](int my_e, int cnt) {
      for (int u0 = 0; u0 < cnt; u0 += PREFETCH) {
        float x[PREFETCH][CHUNKS][W];
        float lg[PREFETCH][CHUNKS];
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u) {
          const int e = __shfl_sync(FULL, my_e, (u0 + u) & 31);
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k) {
            const int c = c0 + lane + 32 * k;
            if (u0 + u < cnt && c < FW) {
              lg[u][k] = __ldg(logits + (int64_t)e * H + head[k]);
              Chunk<W>::load(msgs + (int64_t)e * F + c * W, x[u][k]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u) {
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k) {
            const int c = c0 + lane + 32 * k;
            if (u0 + u < cnt && c < FW) {
              const float w = expf(lg[u][k] - mk[k]);
              den[k] += w;
#pragma unroll
              for (int j = 0; j < W; ++j) acc[k][j] = fmaf(w, x[u][k][j], acc[k][j]);
            }
          }
        }
      }
    });
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
  if (H < 1 || H > MAX_HEADS) return (int)cudaErrorInvalidValue;
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
