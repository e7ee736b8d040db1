// Halo pull over a line of graph partitions, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel analysisgnn_tpu/kernels/halo.py::
// halo_pull_pallas (kernel _halo_push_kernel).  For D partitions of
// N_local rows each, stacked as x [D, N_local, F] float32, it fills every
// partition's [2H, F] halo from its neighbours on the line:
//
//     out[d, 0:H,  :] = x[d - 1, N_local - H : N_local, :]   (0 for d = 0)
//     out[d, H:2H, :] = x[d + 1, 0 : H, :]                   (0 for d = D - 1)
//
// On the TPU each chip held one partition and pushed its boundary rows into
// its neighbours' buffers with remote DMAs, after a barrier that made sure
// the neighbours had zeroed them.  Here all D partitions lie in one card's
// memory, so the exchange is one gather-copy: no barrier, no semaphores.
//
// Bound on the H100: bytes.  It reads (D - 1) * 2H * F * 4 bytes (the end
// partitions have one neighbour each) and writes D * 2H * F * 4, with no
// arithmetic.  At the shapes of the partitioned HybridGNN (H = one edge
// span, a few dozen rows; F = 256) that is well under a megabyte (0.1 us at
// 3.35 TB/s), so what bounds one launch is the launch floor on the device
// (about 3 us) and, above all, the host's call around it.  Hence the
// launcher's short signature: the layout arguments that do not change
// between calls come packed in a HaloArgs made once per layout
// (kernels/halo.py::HaloPlan), and a call passes two pointers, the plan and
// the stream.
//
// Design.  One block per (partition, side): blockIdx.x the partition,
// blockIdx.y the side (0 the left halo, 1 the right).  The block's threads
// stride over the H * F elements of its slot and write each once, as a copy
// of the neighbour's element or as a zero; no atomics, no state shared
// between blocks.  When the rows are 16-byte aligned and F % 4 == 0
// (VEC), the copy moves float4s; otherwise a scalar loop follows the
// input's strides, so a non-contiguous input needs no copy first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
halo_pull_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int D, int64_t n_local, int64_t H, int64_t F, int64_t sd,
                 int64_t sn, int64_t sf) {
  const int d = blockIdx.x;
  const int side = blockIdx.y;
  const int src = side == 0 ? d - 1 : d + 1;
  const bool has = src >= 0 && src < D;
  const int64_t row0 = side == 0 ? n_local - H : 0;
  float* slot = out + ((int64_t)d * 2 + side) * H * F;
  const float* from = x + (has ? (int64_t)src * sd + row0 * sn : 0);
  if (VEC) {
    const int64_t f4 = F / 4;
    float4* slot4 = reinterpret_cast<float4*>(slot);
    for (int64_t i = threadIdx.x; i < H * f4; i += THREADS) {
      const int64_t r = i / f4, c = i - r * f4;
      slot4[i] = has ? __ldg(reinterpret_cast<const float4*>(from + r * sn) + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int64_t i = threadIdx.x; i < H * F; i += THREADS) {
      const int64_t r = i / F, c = i - r * F;
      slot[i] = has ? __ldg(from + r * sn + c * sf) : 0.f;
    }
  }
}

}  // namespace

// The launch arguments of one [D, n_local, F] layout and halo H: element
// strides (sd, sn, sf) of x, and vec != 0 when the layout allows 16-byte
// copies (sf == 1, F % 4 == 0, sd and sn multiples of 4).  Field for field
// the ctypes Structure kernels/halo.py::_HaloArgs.
struct HaloArgs {
  long long D, n_local, H, F, sd, sn, sf, vec;
};

// Launches on `stream` and returns cudaGetLastError() (0 on success).  x is
// [D, n_local, F] float32 with the plan's strides; out is a contiguous
// [D, 2H, F] float32.  The float4 path runs when the plan allows it and both
// pointers are 16-byte aligned, else the scalar loop.
extern "C" int halo_pull_launch(const float* x, float* out, const HaloArgs* a, void* stream) {
  if (a->D <= 0 || a->H <= 0 || a->F <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)a->D, 2);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = a->vec && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    halo_pull_kernel<true><<<grid, THREADS, 0, s>>>(x, out, (int)a->D, a->n_local, a->H, a->F, a->sd, a->sn, a->sf);
  } else {
    halo_pull_kernel<false><<<grid, THREADS, 0, s>>>(x, out, (int)a->D, a->n_local, a->H, a->F, a->sd, a->sn, a->sf);
  }
  return (int)cudaGetLastError();
}
