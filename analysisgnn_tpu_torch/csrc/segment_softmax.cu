// Sorted-segment softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel analysisgnn_tpu/kernels/pallas_segment.py::
// segment_softmax_sorted (kernel _segment_softmax_kernel).  For destination
// ids sorted ascending and logits [E, H] float32 it computes, per run of
// equal ids and per head h,
//
//     m      = max of the run's logits in head h   (0 where not finite)
//     out[e] = exp(logits[e, h] - m) / max(sum_run exp(logits - m), 1e-16)
//
// An id in [0, num_nodes) owns one run: the CSR range row_ptr[n] ..
// row_ptr[n + 1].  Ids outside that interval (the TPU function's padding
// tiles) are not part of any node's range; each run of equal ids among them
// gets its own softmax as well, walked by two extra warps: one for the ids
// below 0, one for the ids at or past num_nodes.
//
// Bound on the H100: bytes.  The function reads E*H*4 + E*4 bytes and writes
// E*H*4, with a handful of operations (max, subtract, exp, add, divide) per
// logit, far below the card's break-even arithmetic intensity.
//
// Design.  The TPU kernel tiled 256 nodes per grid step and built per-edge
// maxima and denominators with one-hot matmuls on the MXU; its pass 3
// rewrote 1,024-edge chunks that overlap the neighbouring tiles, which is
// safe only because the TPU grid runs in order.  Here one warp owns one
// destination and walks its contiguous CSR range three times: a max, an
// exp-sum, and the normalised write.  It writes only its own edges, so no
// block reads or writes another block's rows, and no atomics are needed.
// When H divides 32, the lanes lie across (edge, head) pairs: lane L reads
// head L % H of edge L / H, the warp covers 32 / H edges a step with
// coalesced loads, and a butterfly over the lanes of one head reduces the max
// and the sum.  Otherwise each lane owns one head (32 heads a pass) and
// walks the edges alone.  The second and third passes re-read the run's
// logits from the caches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;

// softmax over the edges [a, b), which share one destination id
__device__ void softmax_run(const float* __restrict__ logits,
                            float* __restrict__ out, int64_t a, int64_t b,
                            int H, int lane) {
  if (a >= b) return;
  if (32 % H == 0) {
    const int G = 32 / H;  // edges per warp step
    const int h = lane % H;
    const int64_t first = a + lane / H;
    float m = -INFINITY;
    for (int64_t e = first; e < b; e += G) m = fmaxf(m, __ldg(logits + e * H + h));
    for (int o = 16; o >= H; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    if (!isfinite(m)) m = 0.f;
    float s = 0.f;
    for (int64_t e = first; e < b; e += G) s += expf(__ldg(logits + e * H + h) - m);
    for (int o = 16; o >= H; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    const float den = fmaxf(s, 1e-16f);
    for (int64_t e = first; e < b; e += G) {
      const int64_t i = e * H + h;
      out[i] = expf(__ldg(logits + i) - m) / den;
    }
  } else {
    for (int h = lane; h < H; h += 32) {
      float m = -INFINITY;
      for (int64_t e = a; e < b; ++e) m = fmaxf(m, __ldg(logits + e * H + h));
      if (!isfinite(m)) m = 0.f;
      float s = 0.f;
      for (int64_t e = a; e < b; ++e) s += expf(__ldg(logits + e * H + h) - m);
      const float den = fmaxf(s, 1e-16f);
      for (int64_t e = a; e < b; ++e) out[e * H + h] = expf(__ldg(logits + e * H + h) - m) / den;
    }
  }
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
segment_softmax_kernel(const float* __restrict__ logits,
                       const int* __restrict__ dst,
                       const int* __restrict__ row_ptr,
                       float* __restrict__ out, int64_t num_edges,
                       int64_t num_nodes, int H) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (w < num_nodes) {
    softmax_run(logits, out, row_ptr[w], row_ptr[w + 1], H, lane);
    return;
  }
  // the two tails: ids below 0, then ids at or past num_nodes
  int64_t a, b;
  if (w == num_nodes) {
    a = 0;
    b = row_ptr[0];
  } else if (w == num_nodes + 1) {
    a = row_ptr[num_nodes];
    b = num_edges;
  } else {
    return;
  }
  while (a < b) {
    // the end of the run that starts at a: the first edge with another id
    const int id = __ldg(dst + a);
    int64_t e = a + 1;
    while (e < b) {
      const int64_t p = e + lane;
      const bool boundary = p >= b || __ldg(dst + p) != id;
      const unsigned mask = __ballot_sync(FULL, boundary);
      if (mask) {
        e += __ffs(mask) - 1;
        break;
      }
      e += 32;
    }
    if (e > b) e = b;
    softmax_run(logits, out, a, e, H, lane);
    a = e;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// logits [E, H] float32 and dst [E] int32 (ascending) are contiguous;
// row_ptr [num_nodes + 1] int32 holds the CSR row pointers of dst.
extern "C" int segment_softmax_launch(const float* logits, const int* dst,
                                      const int* row_ptr, float* out,
                                      long long num_edges, long long num_nodes,
                                      int H, void* stream) {
  if (num_edges <= 0) return (int)cudaSuccess;
  const long long warps = num_nodes + 2;
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((unsigned)((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
  segment_softmax_kernel<<<grid, block, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      logits, dst, row_ptr, out, num_edges, num_nodes, H);
  return (int)cudaGetLastError();
}
