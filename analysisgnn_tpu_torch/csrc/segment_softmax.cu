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
// Every run of equal ids gets its own softmax, wherever its ids lie: the
// kernel finds the runs in dst itself, so it needs no node count and no row
// pointers.
//
// Bound on the H100: bytes.  The function reads E*H*4 + E*4 bytes and writes
// E*H*4, with a handful of operations (max, subtract, exp, add, divide) per
// logit, far below the card's break-even arithmetic intensity.
//
// Design.  The TPU kernel tiled 256 nodes per grid step, built per-edge
// maxima and denominators with one-hot matmuls on the MXU, and rewrote
// chunks that overlap the neighbouring tiles in a third pass, which only its
// sequential grid made safe.  Here one launch does everything and each logit
// is read from memory once:
//
//   * Each warp owns the runs that START in a slice of 32 edges (e == 0 or
//     dst[e] != dst[e - 1]; one ballot of the slice's ids).  It reads the
//     ids of the next slice too, which give the last run's tail there; its
//     window is the 64 edges of both slices, and it reads the logits of its
//     own runs only.  A run longer than the window takes an online max and
//     sum (the running sum rescaled when the max rises) and one more read.
//   * The lanes lie across (chunk, head): lane = sub * HP + hh holds head
//     hh of the C = 64 / (32 / HP) consecutive window edges of chunk sub, HP
//     heads a grid row.  A run's max and its sum of exps are segmented
//     reductions: a serial pass over each lane's chunk in registers, a scan
//     of the chunks' partials across the lanes of a head (log2(32 / HP)
//     shuffles), one shuffle for the carry into a chunk and one for the
//     total of a run that ends in a later chunk, then a backward pass.
//     Every shuffle serves all heads at once: 10 shuffles a warp at H = 4,
//     where one edge a lane would need some 100.
//   * Each output is written by one warp: no atomics, no second pass, no
//     host-built row pointers.
//
// On an NVIDIA H100 80GB HBM3 (700 W) the kernel alone takes a few percent
// longer than the three-pass kernel it replaced, which walked each
// destination's CSR range, and several times a plain copy of the same rows.
// What a call saves is that kernel's row pointers (an arange and a
// searchsorted a call): a call's kernels take about half the device time at
// the HGT train batch's shape (k5_turns.py times a call against another
// checkout's, in turns).  An edge-per-lane version (runs crossing a slice
// finished by butterflies), a block-level one (runs crossing warps met in
// shared memory), this one with its rows staged through shared memory for
// 16-byte loads and stores, and the plainest one-launch form (a warp's runs
// found by a ballot, then the old kernel's walk of each run in turn, its
// first logits kept in registers) were no faster; the last was slower at both
// timed shapes.  What holds it is not known: the card's hardware counters were
// not readable where it was measured.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int SLICE = 32;   // edges whose runs a warp owns
constexpr int WINDOW = 64;  // the slice and the next one: the last run's tail
constexpr unsigned FULL = 0xffffffffu;
constexpr float DEN_FLOOR = 1e-16f;

// bits 0 .. j of a 64-bit mask (j in [-1, 63])
__device__ __forceinline__ uint64_t upto(int j) { return j >= 63 ? ~0ull : (2ull << j) - 1; }

template <bool MAX>
__device__ __forceinline__ float op(float a, float b) { return MAX ? fmaxf(a, b) : a + b; }

// The segmented reduction of one head over the window: on return x[c] holds
// the max (MAX) or the sum over the run of window edge j0 + c, for every edge
// of the lane's chunk.  `bits` are the chunk's run starts (bit c), `lo_sub`
// the chunk where the run of the chunk's last edge starts, `end_lane` the
// lane that holds that run's last edge.
template <int C, int HP, bool MAX>
__device__ __forceinline__ void segment_reduce(float (&x)[C], uint64_t bits, int sub, int lo_sub, int end_lane,
                                               int lane) {
  constexpr int P = 32 / HP;  // chunks a head
  const float ident = MAX ? -INFINITY : 0.f;
  // the serial pass: x[c] = the reduction from the run's start (or the chunk's) to c
#pragma unroll
  for (int c = 1; c < C; ++c) {
    if (!((bits >> c) & 1)) x[c] = op<MAX>(x[c - 1], x[c]);
  }
  // the chunks' partials of the run that reaches each chunk's end, scanned
  float run = x[C - 1];
#pragma unroll
  for (int d = 1; d < P; d <<= 1) {
    const float y = __shfl_up_sync(FULL, run, d * HP);
    if (sub - d >= lo_sub) run = op<MAX>(run, y);
  }
  // the carry into the chunk's first run, when that run began before it
  float carry = __shfl_up_sync(FULL, run, HP);
  if (sub == 0 || (bits & 1)) carry = ident;
  const int first = bits ? __ffsll((long long)bits) - 1 : C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < first) x[c] = op<MAX>(carry, x[c]);
  }
  // the run of the chunk's last edge ends here or in the chunk of end_lane,
  // where it is that chunk's first run: its value at that run's last edge
  float at_first_end = x[C - 1];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    if (c == first) at_first_end = x[c - 1];
  }
  float total = __shfl_sync(FULL, at_first_end, end_lane);
  if (end_lane == lane) total = x[C - 1];
  // backward: every edge takes its run's total
#pragma unroll
  for (int c = C - 1; c > 0; --c) {
    const float prev = x[c - 1];  // the forward value: the previous run's total when c starts a run
    x[c] = total;
    if ((bits >> c) & 1) total = prev;
  }
  x[0] = total;
}

// The softmax of the run [a, b), longer than the window: lanes across (edge,
// head) pairs, P = 32 / HP edges a step, an online max and sum per lane,
// combined over the lanes of a head; a non-finite max takes the sum again
// from the logits at 0.  Then one more read for the write.
template <int HP>
__device__ void long_run(const float* __restrict__ logits, float* __restrict__ out, int64_t a, int64_t b, int H,
                         int h, int sub) {
  constexpr int P = 32 / HP;
  const bool head = h < H;
  float m = -INFINITY, s = 0.f;
  for (int64_t e = a + sub; e < b; e += P) {
    const float v = head ? __ldg(logits + e * H + h) : -INFINITY;
    const float mn = fmaxf(m, v);
    if (mn != -INFINITY) s = s * expf(m - mn) + expf(v - mn);
    m = mn;
  }
  for (int o = 16; o >= HP; o >>= 1) {
    const float mo = __shfl_xor_sync(FULL, m, o), so = __shfl_xor_sync(FULL, s, o);
    const float mn = fmaxf(m, mo);
    s = mn == -INFINITY ? 0.f : s * expf(m - mn) + so * expf(mo - mn);
    m = mn;
  }
  if (!isfinite(m)) {  // all -inf, or an inf: the plain version's sum at m = 0
    m = 0.f;
    s = 0.f;
    for (int64_t e = a + sub; e < b; e += P) s += head ? expf(__ldg(logits + e * H + h)) : 0.f;
    for (int o = 16; o >= HP; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  }
  const float den = fmaxf(s, DEN_FLOOR);
  if (!head) return;
  for (int64_t e = a + sub; e < b; e += P) out[e * H + h] = expf(__ldg(logits + e * H + h) - m) / den;
}

// HP: heads a grid row (blockIdx.y * HP ..), a power of two of at most 32
template <int HP>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
segment_softmax_kernel(const float* __restrict__ logits, const int* __restrict__ dst, float* __restrict__ out,
                       int64_t num_edges, int H) {
  constexpr int P = 32 / HP, C = WINDOW / P;  // chunks a head, edges a chunk
  const int lane = threadIdx.x & 31;
  const int64_t s0 = ((int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5)) * SLICE;
  if (s0 >= num_edges) return;

  // run starts in the slice (A) and in the next one (B)
  const int64_t ea = s0 + lane, eb = ea + SLICE;
  const int ida = ea < num_edges ? __ldg(dst + ea) : 0;
  const int idb = eb < num_edges ? __ldg(dst + eb) : 0;
  int pa = __shfl_up_sync(FULL, ida, 1), pb = __shfl_up_sync(FULL, idb, 1);
  const int a31 = __shfl_sync(FULL, ida, 31);
  if (lane == 0) {
    pa = s0 > 0 ? __ldg(dst + s0 - 1) : ~ida;
    pb = a31;
  }
  const unsigned sa = __ballot_sync(FULL, ea < num_edges && ida != pa);
  if (!sa) return;  // the slice lies inside a run of an earlier warp
  const unsigned sb = __ballot_sync(FULL, eb < num_edges && idb != pb);
  const uint64_t starts = sa | ((uint64_t)sb << 32);
  const int first = __ffs(sa) - 1, last = 31 - __clz(sa);
  // the last run reaches into B up to its first start; past the window, it is long
  const int own_end = sb ? SLICE + __ffs(sb) - 1 : WINDOW;
  int64_t end = 0;
  if (!sb && s0 + WINDOW < num_edges) {
    const int last_id = __shfl_sync(FULL, idb, 31);
    for (end = s0 + WINDOW; end < num_edges; end += 32) {
      const int64_t x = end + lane;
      const unsigned b = __ballot_sync(FULL, x >= num_edges || __ldg(dst + x) != last_id);
      if (b) {
        end += __ffs(b) - 1;
        break;
      }
    }
    if (end > num_edges) end = num_edges;
  }
  const bool long_last = end > s0 + WINDOW;
  const int own_hi = long_last ? last : own_end;  // window edges [first, own_hi) are written here

  const int hh = lane % HP, sub = lane / HP, j0 = sub * C;
  const int h = blockIdx.y * HP + hh;
  const bool head = h < H;
  // the chunk's run starts; the chunk where the run of its last edge starts;
  // the lane of that run's last edge
  const uint64_t bits = (starts >> j0) & (C == 64 ? ~0ull : (1ull << C) - 1);
  const uint64_t before = starts & upto(j0 + C - 1), after = starts & ~upto(j0 + C - 1);
  const int lo_sub = before ? (63 - __clzll((long long)before)) / C : 0;
  const int end_j = (after ? __ffsll((long long)after) - 1 : WINDOW) - 1;
  const int end_lane = (end_j / C) * HP + hh;

  float x[C], v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    const int64_t e = s0 + j;
    v[c] = head && j >= first && j < own_end && e < num_edges ? __ldg(logits + e * H + h) : -INFINITY;
    x[c] = v[c];
  }
  segment_reduce<C, HP, true>(x, bits, sub, lo_sub, end_lane, lane);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = expf(v[c] - (isfinite(x[c]) ? x[c] : 0.f));  // -inf past our runs: 0
    x[c] = v[c];
  }
  segment_reduce<C, HP, false>(x, bits, sub, lo_sub, end_lane, lane);
  if (head) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const int64_t e = s0 + j;
      if (j >= first && j < own_hi && e < num_edges) out[e * H + h] = v[c] / fmaxf(x[c], DEN_FLOOR);
    }
  }
  if (long_last) long_run<HP>(logits, out, s0 + last, end, H, h, sub);
}

template <int HP>
void launch_hp(const float* logits, const int* dst, float* out, long long num_edges, int H, cudaStream_t stream) {
  const long long warps = (num_edges + SLICE - 1) / SLICE;
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((unsigned)((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK), (unsigned)((H + HP - 1) / HP));
  segment_softmax_kernel<HP><<<grid, block, 0, stream>>>(logits, dst, out, num_edges, H);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// logits [E, H] float32 and dst [E] int32 (ascending) are contiguous.
extern "C" int segment_softmax_launch(const float* logits, const int* dst, float* out, long long num_edges, int H,
                                      void* stream) {
  if (num_edges <= 0 || H <= 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (H == 1) launch_hp<1>(logits, dst, out, num_edges, H, st);
  else if (H == 2) launch_hp<2>(logits, dst, out, num_edges, H, st);
  else if (H <= 4) launch_hp<4>(logits, dst, out, num_edges, H, st);
  else if (H <= 8) launch_hp<8>(logits, dst, out, num_edges, H, st);
  else if (H <= 16) launch_hp<16>(logits, dst, out, num_edges, H, st);
  else launch_hp<32>(logits, dst, out, num_edges, H, st);
  return (int)cudaGetLastError();
}
