// Relation-weighted matmul and its gradients, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of analysisgnn_tpu/kernels/pallas_relmm.py::
// relation_weighted_matmul: the forward _fwd_kernel (pallas_call :73) and the
// backward _dwa_kernel (pallas_call :122).  With x [N, F], w [T, F, G] and
// alpha [T, N], all f32 and contiguous:
//
//     out[n, g]   = sum_t alpha[t, n] * sum_f x[n, f] * w[t, f, g]     (forward)
//     dx[n, f]    = sum_t alpha[t, n] * sum_g gout[n, g] * w[t, f, g]  (the same kernel, w read as w^T)
//     dw[t, f, g] = sum_n alpha[t, n] * x[n, f] * gout[n, g]
//     da[t, n]    = sum_g (x[n] @ w[t])[g] * gout[n, g]
//
// Bound on the H100: operations.  At the training shape (N = 5,376,
// F = G = 256, T = 7) each computes 2*T*N*F*G = 4.93 GFLOP and moves about
// 13 MB (4 us at 3.35 TB/s).
//
// All four run on the tensor cores in three TF32 passes at f32
// accuracy: each f32 operand is split as v = hi + lo with hi = tf32(v) and
// lo = tf32(v - hi), both rounded to nearest as cvt.rna does, and every
// product is lo*hi + hi*lo + hi*hi accumulated in f32 (the two small terms
// issued first; lo*lo, about 2^-22 of the product, is dropped).  That is
// 3 x 4.93 GFLOP at 495 TFLOP/s: 30 us.  No global TF32 setting is read or
// changed.  TF32 wgmma reads both operands from shared memory K-major only
// (no transpose for .tf32), so every operand is staged: asynchronous copies
// (cp.async, zero-filled past the edges) bring raw f32 tiles into a ring, and
// the block splits each into hi and lo and writes both, transposed where the
// stored layout is not K-major, into tiles of 32-float rows with the 128-byte
// swizzle that the wgmma descriptors name.  Every tensor-core block is two
// warpgroups that stage together and each run their own 64 rows.
//
//   * Forward / dx (rwm_tc_forward_kernel<B_KMAJOR, false, WIDTH>): a block owns a
//     128 x WIDTH tile of out.  Its 128 rows of x are split into shared memory
//     once, a panel of 128 K at a time, and reused for every relation, as the
//     TPU kernel keeps x in VMEM; the [T, N, G] intermediate never exists.
//     The weights stream chunk by chunk, in the order (panel, relation,
//     32-deep K chunk), through a ring of raw copies and a ring of split
//     tiles, so that the copies run ahead and the split of chunk c+1 overlaps
//     the wgmmas of the chunks before it.  After a relation's K loop each
//     warpgroup adds alpha[t, row] times its per-relation accumulator into a
//     second register accumulator.  The forward reads w[t] [F, G] (G
//     contiguous: split and transposed); dx reads the same w as its B with
//     K = G, K-major as stored, so no w^T is copied.  WIDTH is 128, 96 or 64,
//     whichever pick_width estimates the fastest for the grid it gives; at the
//     train shape 96: 126 blocks on 132 SMs, where 128 would leave 48 SMs
//     idle and 64 would need two waves.
//   * dw (rwm_tc_dw_kernel): dw[t] is an [F, G] product with K = N, both
//     operands N-major as stored (transposed while split; x scaled by
//     alpha[t, n] first); a block owns a 128 x 128 tile.  The TPU kernel
//     carried this sum across its sequential grid; GPU blocks run in
//     parallel, so N is cut into S contiguous ranges (S fills the SMs), each
//     block writes its partial [F, G] tile into a scratch [S, T, F, G], and
//     rwm_sum_splits_kernel adds the S partials in a fixed order: no atomics,
//     the same bits on every run.
//   * d alpha (rwm_tc_forward_kernel<false, true, WIDTH>) is the forward's
//     mainloop with another epilogue: each thread holds the values of gout at
//     its accumulator's positions in the registers where the forward keeps
//     its output, and after a relation's K loop over a panel it dots its
//     accumulator fragment with them, row by row; quad shuffles sum the 4
//     lanes that share a row.  A block sees WIDTH of G's columns and one
//     panel of F at a time, so each (column tile, panel) writes its partial
//     [T, N] into a scratch [S, T, N], and rwm_sum_splits_kernel adds the S
//     partials in a fixed order: no atomics, the same bits on every run.  It
//     has no launch on the model's path (alpha carries no gradient there).
//   * bf16 forward: x [N, F] and w [T, F, G] in bf16, alpha [T, N] and out
//     [N, G] in f32, as the Pallas forward takes bf16 operands with
//     preferred_element_type=f32.  One bf16 tensor-core pass per product, f32
//     accumulation: a product of two bf16 values is exact in f32, so the
//     kernels differ from the f32 einsum of the upcast operands only in the
//     order of their sums.  Bound on the H100 at the train shape: operations,
//     4.93 GFLOP at 989 TFLOP/s is 5.0 us (x, w, alpha in and out in f32 move
//     9.3 MB, 2.8 us).  Two kernels, chosen by the shapes and pointers alone
//     (kernels/relmm.py::forward_kernel; no failure switches kernels):
//     - rwm_bf16_wgmma_kernel<WIDTH>, wherever TMA can describe the operands
//       (F and G multiples of 8, x and w 16-byte aligned).  A block owns a
//       128 x WIDTH tile of out (WIDTH from pick_width, as the f32 forward):
//       one producer warp issues TMA copies, two consumer warpgroups run
//       wgmma m64nWIDTHk16 bf16 on 64 rows each.  The block's rows of x are
//       copied once, a panel of up to 8 chunks of 64 K at a time (all of F
//       up to 512), K-major with the 128-byte swizzle, and reused for every
//       relation.  w[t] streams through a ring of 4 chunks of 64 K x WIDTH
//       behind full and empty mbarriers, in the order (panel, relation, K
//       chunk), read by wgmma MN-major as stored (G contiguous: the
//       transpose flag of a 16-bit B), in boxes of 32 columns with the
//       64-byte swizzle, so nothing is transposed anywhere.  TMA zero-fills
//       the N, F and G tails; a 3-D map over [T, F, G] keeps a chunk's K
//       tail out of the next relation.  After a relation's K loop over a
//       panel each warpgroup adds alpha[t, row] times its per-relation
//       accumulator into a second register tile, so the [T, N, G]
//       intermediate never exists.
//     - rwm_bf16_forward_kernel<VEC> (mma.sync m16n8k16), for the rest: a
//       block of four warps owns a 64 x 64 tile; for each relation it walks K
//       in 32-deep chunks, staging the x chunk as stored and the w chunk
//       transposed to [G, K] (the B fragments read pairs of K), one chunk in
//       flight, then the same alpha epilogue.
//     The backward of a bf16 forward runs the f32 kernels above on f32 copies
//     of x and w (kernels/relmm.py), as the Pallas backward upcasts.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is reached through the runtime (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ inline unsigned cdiv(int64_t a, int64_t b) { return (unsigned)((a + b - 1) / b); }

// ------------------------------------------------------------------ tensor cores

constexpr int WG = 128;                 // one warpgroup
constexpr int NT = 2 * WG;              // threads of a tensor-core block: two warpgroups
constexpr int TBM = 64;                 // rows of one warpgroup's accumulator (wgmma m64)
constexpr int TBN = 128;                // columns of a dw tile (wgmma n128)
constexpr int FWD_BM = 2 * TBM;         // rows of a forward/dx tile: one 64-row half per warpgroup
constexpr int TBK = 32;                 // depth of one chunk: one 128-byte swizzled row of f32
constexpr int PANEL = 4;                // chunks of A held in shared memory at once (K <= 128 a panel)
constexpr int DW_RAW = 3;               // dw: raw chunks in flight
constexpr int A_TILE = TBM * TBK;       // floats of one warpgroup's 64-row chunk of A (8 KB)
constexpr int B_TILE = TBN * TBK;       // floats of one chunk of dw's B (16 KB)
constexpr int FA_TILE = FWD_BM * TBK;   // floats of one chunk of the forward's A (16 KB)
constexpr int DW_BM = 2 * TBM;          // rows (F) of a dw tile: one 64-row half per warpgroup
constexpr int ALIGN = 1024;             // a swizzle atom: 8 rows x 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float* align_smem(unsigned char* p) {
  return reinterpret_cast<float*>(p + ((ALIGN - (smem_u32(p) & (ALIGN - 1))) & (ALIGN - 1)));
}

// Offset in floats of the 4-float group k4 (k = 4*k4 .. 4*k4+3) of row r of a
// K-major tile with 32-float rows and the 128-byte swizzle: the 16-byte group
// index is XORed with the row's index within its 8-row atom.
__device__ __forceinline__ int swz(int r, int k4) { return r * TBK + ((k4 ^ (r & 7)) << 2); }

// TF32 rounding to nearest, ties away from zero (cvt.rna.tf32.f32) on the
// bits: the 13 low mantissa bits are rounded into the 10 kept ones.  Two
// integer operations, where cvt.rna compiles to a longer sequence with a
// branch; a NaN stays a NaN or becomes an infinity whose lo (NaN - inf) is NaN.
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// v = hi + lo + O(2^-22 v), hi and lo both TF32 values
__device__ __forceinline__ void split_store(float* hi, float* lo, int off, float4 v) {
  float4 h, l;
  h.x = tf32_rna(v.x); l.x = tf32_rna(v.x - h.x);
  h.y = tf32_rna(v.y); l.y = tf32_rna(v.y - h.y);
  h.z = tf32_rna(v.z); l.z = tf32_rna(v.z - h.z);
  h.w = tf32_rna(v.w); l.w = tf32_rna(v.w - h.w);
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most PENDING committed groups of copies are still in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// this thread's shared-memory writes become visible to the wgmma (async proxy) reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}

// keeps the compiler from moving accesses of the accumulator across a wgmma fence or wait
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte swizzle:
// start address >> 4, leading offset unused (1), stride between 8-row atoms
// 1,024 bytes (>> 4 = 64), layout 1 (128B swizzle).  The tile starts on a
// 1,024-byte boundary; the k-th 8-deep slice of its 32-deep rows starts
// 32*k bytes in, which the hardware swizzles as the stores did.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d[64 x 128] (+)= a[64 x 8] * b[8 x 128]^T (d is overwritten when `accumulate`
// is 0), tf32 in, f32 accumulate; thread (warp w, lane l) of the warpgroup
// holds rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1):
// d[4j] (r, c), d[4j+1] (r, c+1), d[4j+2] (r+8, c), d[4j+3] (r+8, c+1)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the same as m64n64k8: d[64 x 64], d[4j .. 4j+3] as above for j < 8
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the same as m64n96k8: d[64 x 96], d[4j .. 4j+3] as above for j < 12
__device__ __forceinline__ void wgmma_tf32(float (&d)[48], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47},"
      " %48, %49, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// One 32-deep chunk in three TF32 passes: per 8-deep slice lo*hi and hi*lo,
// then hi*hi.  The first product overwrites d unless `accumulate`.
template <int R>
__device__ __forceinline__ void mma_chunk(float (&d)[R], const float* a_hi, const float* a_lo, const float* b_hi,
                                          const float* b_lo, bool accumulate) {
  const uint64_t ah = smem_desc(a_hi), al = smem_desc(a_lo), bh = smem_desc(b_hi), bl = smem_desc(b_lo);
#pragma unroll
  for (int i = 0; i < TBK / 8; ++i) {
    const int k = 2 * i;  // 32 bytes = 2 units of the descriptor's address
    wgmma_tf32(d, al + k, bh + k, accumulate || i > 0);
    wgmma_tf32(d, ah + k, bl + k, 1);
    wgmma_tf32(d, ah + k, bh + k, 1);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// raw[r][c] = src[(r0+r)*ld + c0+c] for r < ROWS, c < COLS, zero where
// r0+r >= r_lim or c0+c >= ld, by asynchronous copies: 16 bytes each when
// `vec` (ld % 4 == 0 and src 16-byte aligned), else 4.
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(float* raw, const float* __restrict__ src, int64_t ld, int64_t r0,
                                          int64_t r_lim, int64_t c0, bool vec, int tid) {
  static_assert(ROWS * COLS % (4 * NT) == 0, "whole 16-byte copies per thread");
  if (vec) {
    constexpr int C4 = COLS / 4;
#pragma unroll
    for (int j = 0; j < ROWS * C4 / NT; ++j) {
      const int i = tid + j * NT, r = i / C4, c = (i % C4) * 4;
      const bool ok = r0 + r < r_lim && c0 + c < ld;
      cp_async16(raw + r * COLS + c, ok ? src + (r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int j = 0; j < ROWS * COLS / NT; ++j) {
      const int i = tid + j * NT, r = i / COLS, c = i % COLS;
      const bool ok = r0 + r < r_lim && c0 + c < ld;
      cp_async4(raw + r * COLS + c, ok ? src + (r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

// raw [TBK][ROWS] (K rows, ROWS contiguous; each K row scaled by scale[k]
// when given) -> hi, lo [ROWS][TBK] K-major swizzled.  32 lanes read 32
// consecutive floats of one K row; each 8 lanes write 8 rows' 16-byte groups
// into distinct banks.
template <int ROWS>
__device__ __forceinline__ void split_mn(const float* raw, float* hi, float* lo, const float* scale, int tid) {
  static_assert(ROWS * (TBK / 4) % NT == 0, "whole groups per thread");
#pragma unroll
  for (int j = 0; j < ROWS * (TBK / 4) / NT; ++j) {
    const int i = tid + j * NT, r = i % ROWS, k4 = i / ROWS, k = 4 * k4;
    float4 v = make_float4(raw[k * ROWS + r], raw[(k + 1) * ROWS + r], raw[(k + 2) * ROWS + r],
                           raw[(k + 3) * ROWS + r]);
    if (scale != nullptr) {
      v.x *= scale[k]; v.y *= scale[k + 1]; v.z *= scale[k + 2]; v.w *= scale[k + 3];
    }
    split_store(hi, lo, swz(r, k4), v);
  }
}

// raw [ROWS][TBK] (K contiguous) -> hi, lo [ROWS][TBK] K-major swizzled
template <int ROWS>
__device__ __forceinline__ void split_k(const float* raw, float* hi, float* lo, int tid) {
  static_assert(ROWS * (TBK / 4) % NT == 0, "whole groups per thread");
#pragma unroll
  for (int j = 0; j < ROWS * (TBK / 4) / NT; ++j) {
    const int i = tid + j * NT, r = i / (TBK / 4), k4 = i % (TBK / 4);
    split_store(hi, lo, swz(r, k4), *reinterpret_cast<const float4*>(raw + r * TBK + 4 * k4));
  }
}

// Rows m0 .. m0+ROWS-1 of a [M, K] matrix, K chunks kb0 .. kb0+nkb-1, split
// into the A tiles hi[kb], lo[kb] (loaded once per panel, so plain loads, 8
// in flight per thread).
template <int ROWS>
__device__ __forceinline__ void load_a_panel(const float* __restrict__ a, int64_t M, int K, int64_t m0, int kb0,
                                             int nkb, float* hi, float* lo, bool vec, int tid) {
  constexpr int PER_KB = ROWS * (TBK / 4) / NT, BATCH = 8;  // groups of one chunk per thread; loads in flight
  static_assert(ROWS * (TBK / 4) % NT == 0 && PANEL * PER_KB % BATCH == 0, "whole batches per thread");
  for (int j0 = 0; j0 < nkb * PER_KB; j0 += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tid + (j0 + u) * NT, kb = i / (ROWS * (TBK / 4)), r = (i / (TBK / 4)) % ROWS;
      const int64_t m = m0 + r;
      const int k = (kb0 + kb) * TBK + 4 * (i % (TBK / 4));
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kb < nkb && m < M) {
        const float* p = a + m * K + k;
        if (vec) {
          if (k < K) v[u] = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v[u].x = k < K ? __ldg(p) : 0.f;
          v[u].y = k + 1 < K ? __ldg(p + 1) : 0.f;
          v[u].z = k + 2 < K ? __ldg(p + 2) : 0.f;
          v[u].w = k + 3 < K ? __ldg(p + 3) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tid + (j0 + u) * NT, kb = i / (ROWS * (TBK / 4)), r = (i / (TBK / 4)) % ROWS;
      if (kb < nkb) split_store(hi + kb * ROWS * TBK, lo + kb * ROWS * TBK, swz(r, i % (TBK / 4)), v[u]);
    }
  }
}

// out[r, c] for the 64 x 2R tile at (m0, n0) from the accumulator layout of
// wgmma_tf32; `wtid` is the thread's index within its warpgroup
template <int R>
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float (&d)[R], int64_t M, int NC,
                                           int64_t m0, int n0, int wtid) {
  const int warp = wtid / 32, lane = wtid % 32;
  const int64_t r0 = m0 + warp * 16 + lane / 4;
  const bool pairs = (NC % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = r0 + 8 * h;
    if (r >= M) continue;
    float* row = out + r * NC;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs && c + 1 < NC) {
        *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
      } else {
        if (c < NC) row[c] = v0;
        if (c + 1 < NC) row[c + 1] = v1;
      }
    }
  }
}

// The forward/dx tile is 128 rows by WIDTH columns (wgmma n WIDTH), WIDTH one
// of 128, 96 and 64 (pick_width chooses).  Its rings: RAW raw chunks of B in
// flight, CONV split ones (CONV - 1 in the tensor cores while one is split),
// as many as fit beside a 4-chunk panel of A.
template <int WIDTH>
struct FwdTile {
  static_assert(WIDTH == 128 || WIDTH == 96 || WIDTH == 64, "a width with a wgmma_tf32 overload");
  static constexpr int CONV = WIDTH == 64 ? 3 : 2;
  static constexpr int RAW = WIDTH == 128 ? 2 : WIDTH == 96 ? 3 : 4;
  static constexpr int B = WIDTH * TBK;  // floats of one chunk of B
  static constexpr size_t smem_bytes(int panel) {
    return (size_t)(2 * panel * FA_TILE + (2 * CONV + RAW) * B) * sizeof(float) + ALIGN;
  }
};

// out [M, NC] = sum_t alpha[t] (.) (a [M, K] @ B_t [K, NC]); grid (ceil(M/128), ceil(NC/WIDTH)).
// B_t is w + t*K*NC: [K, NC] row-major (the forward: w[t] with K = F, NC = G)
// or, with B_KMAJOR, [NC, K] row-major (dx: w[t] with NC = F, K = G).  Both
// warpgroups stage every chunk of B; warpgroup h multiplies rows 64h .. 64h+63
// of the block's A panel with it.
// With DALPHA, `side` is gout [M, NC] in place of alpha, and `out` is the
// partials [S, T, M]: out[s, t, m] = sum over the block's columns of
// (a @ B_t)[m, :] * gout[m, :] over panel p's K, s = blockIdx.y * panels + p.
template <bool B_KMAJOR, bool DALPHA, int WIDTH>
__global__ void __launch_bounds__(NT, 1)
rwm_tc_forward_kernel(const float* __restrict__ a, const float* __restrict__ w, const float* __restrict__ side,
                      float* __restrict__ out, int64_t M, int K, int NC, int T) {
  static_assert(!(B_KMAJOR && DALPHA), "d alpha reads w[t] as stored, [F, G]");
  constexpr int CONV = FwdTile<WIDTH>::CONV, RAW = FwdTile<WIDTH>::RAW, FB_TILE = FwdTile<WIDTH>::B;
  extern __shared__ unsigned char smem_bytes[];
  const int nkb = (int)cdiv(K, TBK), panel = nkb < PANEL ? nkb : PANEL;
  float* a_hi = align_smem(smem_bytes);      // [panel][FA_TILE]
  float* a_lo = a_hi + panel * FA_TILE;      // [panel][FA_TILE]
  float* b_hi = a_lo + panel * FA_TILE;      // [CONV][FB_TILE]
  float* b_lo = b_hi + CONV * FB_TILE;       // [CONV][FB_TILE]
  float* raw = b_lo + CONV * FB_TILE;        // [RAW][FB_TILE], the copies' landing ring

  const int tid = threadIdx.x, half = tid / WG, wtid = tid % WG;
  const int64_t m0 = (int64_t)blockIdx.x * FWD_BM;
  const int n0 = blockIdx.y * WIDTH;
  const int64_t ld_b = B_KMAJOR ? K : NC;
  const bool vec_a = K % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool vec_b = ld_b % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int chunks = T * nkb;  // in the order (panel, relation, K chunk of the panel)

  // chunk c's copy into raw[c % RAW], one commit group per chunk (empty past the end)
  auto copy_chunk = [&](int c) {
    if (c < chunks) {
      const int p = c / (T * panel), kb0 = p * panel, width = nkb - kb0 < panel ? nkb - kb0 : panel;
      const int r = c - p * T * panel, t = r / width, kb = kb0 + r % width;
      const float* wt = w + (int64_t)t * K * NC;
      float* dst = raw + (c % RAW) * FB_TILE;
      if (B_KMAJOR) copy_tile<WIDTH, TBK>(dst, wt, ld_b, n0, NC, (int64_t)kb * TBK, vec_b, tid);
      else copy_tile<TBK, WIDTH>(dst, wt, ld_b, (int64_t)kb * TBK, K, n0, vec_b, tid);
    }
    cp_async_commit();
  };
  // raw[c % RAW] -> b_hi, b_lo[c % CONV]
  auto split_chunk = [&](int c) {
    const float* src = raw + (c % RAW) * FB_TILE;
    const int s = (c % CONV) * FB_TILE;
    if (B_KMAJOR) split_k<WIDTH>(src, b_hi + s, b_lo + s, tid);
    else split_mn<WIDTH>(src, b_hi + s, b_lo + s, nullptr, tid);
  };

  // res: the output tile (forward, dx), or gout at the accumulator's positions (d alpha)
  float acc[WIDTH / 2], res[WIDTH / 2];
  zero(res);
  zero(acc);
  pin(acc);
  if (chunks > 0) {
    for (int c = 0; c < RAW; ++c) copy_chunk(c);
    load_a_panel<FWD_BM>(a, M, K, m0, 0, panel, a_hi, a_lo, vec_a, tid);
    cp_async_wait<RAW - 1>();  // chunk 0 has landed
    __syncthreads();
    split_chunk(0);
    fence_async_smem();
    __syncthreads();
    copy_chunk(RAW);
  }
  const int warp = wtid / 32, lane = wtid % 32;
  const int64_t r0 = m0 + half * TBM + warp * 16 + lane / 4, r1 = r0 + 8;
  if (DALPHA) {
#pragma unroll
    for (int j = 0; j < WIDTH / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      res[4 * j] = r0 < M && col < NC ? __ldg(side + r0 * NC + col) : 0.f;
      res[4 * j + 1] = r0 < M && col + 1 < NC ? __ldg(side + r0 * NC + col + 1) : 0.f;
      res[4 * j + 2] = r1 < M && col < NC ? __ldg(side + r1 * NC + col) : 0.f;
      res[4 * j + 3] = r1 < M && col + 1 < NC ? __ldg(side + r1 * NC + col + 1) : 0.f;
    }
  }
  const int panels = panel > 0 ? (int)cdiv(nkb, panel) : 0;
  int c = 0;
  for (int kb0 = 0; kb0 < nkb; kb0 += panel) {
    const int width = nkb - kb0 < panel ? nkb - kb0 : panel;
    for (int t = 0; t < T; ++t) {
      const float a0 = !DALPHA && r0 < M ? __ldg(side + (int64_t)t * M + r0) : 0.f;
      const float a1 = !DALPHA && r1 < M ? __ldg(side + (int64_t)t * M + r1) : 0.f;
      for (int kc = 0; kc < width; ++kc, ++c) {
        const int s = (c % CONV) * FB_TILE;
        wgmma_fence();
        mma_chunk(acc, a_hi + kc * FA_TILE + half * A_TILE, a_lo + kc * FA_TILE + half * A_TILE, b_hi + s,
                  b_lo + s, kc > 0);
        wgmma_commit();
        if (c + 1 < chunks) {
          const bool new_panel = t == T - 1 && kc == width - 1;
          // this warpgroup's wgmmas of chunk c+1-CONV, whose split tiles chunk c+1
          // takes, are done (before a new panel of A: all of them); CONV - 1
          // chunks stay in the tensor cores while chunk c+1 is split
          if (new_panel) wgmma_wait<0>();
          else wgmma_wait<CONV - 1>();
          cp_async_wait<RAW - 1>();  // chunk c+1 has landed
          __syncthreads();
          if (new_panel) {
            const int next = nkb - kb0 - width < panel ? nkb - kb0 - width : panel;
            load_a_panel<FWD_BM>(a, M, K, m0, kb0 + width, next, a_hi, a_lo, vec_a, tid);
          }
          split_chunk(c + 1);
          fence_async_smem();
          __syncthreads();
          copy_chunk(c + 1 + RAW);
        }
      }
      // the relation's K loop over this panel is done
      wgmma_wait<0>();
      pin(acc);
      if (DALPHA) {
        // out[s, t, row] = <acc[row, :], gout[row, :]>: this thread's columns in
        // ascending j, then the quad's 4 lanes (xor 1, then xor 2)
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int j = 0; j < WIDTH / 8; ++j) {
          d0 = fmaf(acc[4 * j], res[4 * j], d0);
          d0 = fmaf(acc[4 * j + 1], res[4 * j + 1], d0);
          d1 = fmaf(acc[4 * j + 2], res[4 * j + 2], d1);
          d1 = fmaf(acc[4 * j + 3], res[4 * j + 3], d1);
        }
        d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
        d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
        d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
        d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
        float* part = out + ((int64_t)(blockIdx.y * panels + kb0 / panel) * T + t) * M;
        if (lane % 4 == 0) {
          if (r0 < M) part[r0] = d0;
          if (r1 < M) part[r1] = d1;
        }
      } else {  // res += alpha[t] (.) acc
#pragma unroll
        for (int j = 0; j < WIDTH / 8; ++j) {
          res[4 * j] = fmaf(a0, acc[4 * j], res[4 * j]);
          res[4 * j + 1] = fmaf(a0, acc[4 * j + 1], res[4 * j + 1]);
          res[4 * j + 2] = fmaf(a1, acc[4 * j + 2], res[4 * j + 2]);
          res[4 * j + 3] = fmaf(a1, acc[4 * j + 3], res[4 * j + 3]);
        }
      }
      pin(acc);
    }
  }
  if (!DALPHA) store_tile(out, res, M, NC, m0 + half * TBM, n0, wtid);
}

constexpr size_t DW_SMEM_BYTES =
    (size_t)((4 + DW_RAW) * (DW_BM * TBK + B_TILE) + DW_RAW * TBK) * sizeof(float) + ALIGN;

// dst[s, t] [F, G] = sum over this split's rows n of (alpha[t, n] x[n])^T gout[n];
// grid (ceil(F/128), ceil(G/128), T*S); split s takes the 32-row chunks
// [s*C/S, (s+1)*C/S) of C = ceil(N/32); warpgroup h owns rows 64h .. 64h+63
// of the block's 128 x 128 tile.
__global__ void __launch_bounds__(NT, 1)
rwm_tc_dw_kernel(const float* __restrict__ x, const float* __restrict__ gout, const float* __restrict__ alpha,
                 float* __restrict__ dst, int64_t N, int F, int G, int T, int S) {
  constexpr int DA = DW_BM * TBK;        // floats of one chunk of A
  extern __shared__ unsigned char smem_bytes[];
  float* a_hi = align_smem(smem_bytes);  // [2][DA]
  float* a_lo = a_hi + 2 * DA;           // [2][DA]
  float* b_hi = a_lo + 2 * DA;           // [2][B_TILE]
  float* b_lo = b_hi + 2 * B_TILE;       // [2][B_TILE]
  float* raw_a = b_lo + 2 * B_TILE;      // [DW_RAW][TBK][DW_BM]
  float* raw_b = raw_a + DW_RAW * DA;    // [DW_RAW][TBK][TBN]
  float* raw_al = raw_b + DW_RAW * B_TILE;  // [DW_RAW][TBK]

  const int tid = threadIdx.x, half = tid / WG, wtid = tid % WG;
  const int f0 = blockIdx.x * DW_BM, g0 = blockIdx.y * TBN;
  const int t = blockIdx.z / S, sp = blockIdx.z % S;
  const int64_t total = (N + TBK - 1) / TBK;
  const int64_t c_begin = total * sp / S;
  const int chunks = (int)(total * (sp + 1) / S - c_begin);
  const float* at = alpha + (int64_t)t * N;
  const bool vec_x = F % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_g = G % 4 == 0 && (reinterpret_cast<uintptr_t>(gout) & 15) == 0;

  // chunk c's copies into ring slot c % DW_RAW, one commit group per chunk (empty past the end)
  auto copy_chunk = [&](int c) {
    if (c < chunks) {
      const int64_t n0 = (c_begin + c) * TBK;
      const int r = c % DW_RAW;
      copy_tile<TBK, DW_BM>(raw_a + r * DA, x, F, n0, N, f0, vec_x, tid);
      copy_tile<TBK, TBN>(raw_b + r * B_TILE, gout, G, n0, N, g0, vec_g, tid);
      if (tid < TBK) cp_async4(raw_al + r * TBK + tid, n0 + tid < N ? at + n0 + tid : at, n0 + tid < N);
    }
    cp_async_commit();
  };
  auto split_chunk = [&](int c) {
    const int r = c % DW_RAW, s = c & 1;
    split_mn<DW_BM>(raw_a + r * DA, a_hi + s * DA, a_lo + s * DA, raw_al + r * TBK, tid);
    split_mn<TBN>(raw_b + r * B_TILE, b_hi + s * B_TILE, b_lo + s * B_TILE, nullptr, tid);
  };

  float acc[64];
  zero(acc);
  pin(acc);
  if (chunks > 0) {
    for (int c = 0; c < DW_RAW; ++c) copy_chunk(c);
    cp_async_wait<DW_RAW - 1>();  // chunk 0 has landed
    __syncthreads();
    split_chunk(0);
    fence_async_smem();
    __syncthreads();
    copy_chunk(DW_RAW);
  }
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    wgmma_fence();
    mma_chunk(acc, a_hi + s * DA + half * A_TILE, a_lo + s * DA + half * A_TILE, b_hi + s * B_TILE,
              b_lo + s * B_TILE, true);
    wgmma_commit();
    if (c + 1 < chunks) {
      wgmma_wait<1>();              // chunk c-1's wgmmas are done: its split tiles may be rewritten
      cp_async_wait<DW_RAW - 1>();  // chunk c+1 has landed
      __syncthreads();
      split_chunk(c + 1);
      fence_async_smem();
      __syncthreads();
      copy_chunk(c + 1 + DW_RAW);
    }
  }
  wgmma_wait<0>();
  pin(acc);
  store_tile(dst + ((int64_t)sp * T + t) * F * G, acc, F, G, f0 + half * TBM, g0, wtid);
}

// out[i] = sum_s part[s, i], s ascending
__global__ void rwm_sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t count,
                                      int S) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += (int64_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < S; ++s) v += part[s * count + i];
    out[i] = v;
  }
}

template <bool B_KMAJOR, bool DALPHA, int WIDTH>
int forward_launch_bn(const float* a, const float* w, const float* side, float* out, long long M, int K, int NC,
                      int T, cudaStream_t stream) {
  const int nkb = (int)cdiv(K, TBK);
  const size_t smem = FwdTile<WIDTH>::smem_bytes(nkb < PANEL ? nkb : PANEL);
  cudaError_t err = cudaFuncSetAttribute(rwm_tc_forward_kernel<B_KMAJOR, DALPHA, WIDTH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(M, FWD_BM), cdiv(NC, WIDTH));
  rwm_tc_forward_kernel<B_KMAJOR, DALPHA, WIDTH><<<grid, NT, smem, stream>>>(a, w, side, out, M, K, NC, T);
  return (int)cudaGetLastError();
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || sms < 1) {
    return 1;
  }
  return sms;
}

// The column width of the forward/dx tile.  A warpgroup's wgmma reads
// 64 x 8 floats of A and WIDTH x 8 of B from shared memory, which bounds the
// tensor cores here, so a column costs in proportion to (64 + WIDTH) / WIDTH:
// 1.00, 1.11 and 1.33 for 128, 96 and 64.  A narrower tile gives more blocks
// to fill the SMs (one block an SM).  The estimate: waves times width times
// the cost of a column.
int pick_width(long long M, int NC) {
  const int widths[3] = {128, 96, 64};
  const long long sms = sm_count(), rows = cdiv(M, FWD_BM);
  int best = 0;
  double best_cost = 0.0;
  for (int i = 0; i < 3; ++i) {
    const long long waves = (rows * cdiv(NC, widths[i]) + sms - 1) / sms;
    const double cost = (double)waves * (64 + widths[i]);
    if (i == 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return widths[best];
}

template <bool B_KMAJOR, bool DALPHA = false>
int forward_launch(const float* a, const float* w, const float* side, float* out, long long M, int K, int NC, int T,
                   cudaStream_t st) {
  switch (pick_width(M, NC)) {
    case 128: return forward_launch_bn<B_KMAJOR, DALPHA, 128>(a, w, side, out, M, K, NC, T, st);
    case 96: return forward_launch_bn<B_KMAJOR, DALPHA, 96>(a, w, side, out, M, K, NC, T, st);
    default: return forward_launch_bn<B_KMAJOR, DALPHA, 64>(a, w, side, out, M, K, NC, T, st);
  }
}

// out[i] = sum_s part[s, i] over `count` elements, s ascending
int sum_splits(const float* part, float* out, long long count, int S, cudaStream_t st) {
  const unsigned blocks = cdiv(count, 256) < 1024u ? cdiv(count, 256) : 1024u;
  rwm_sum_splits_kernel<<<blocks, 256, 0, st>>>(part, out, count, S);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 forward

constexpr int BF_BM = 64;        // rows of a block's tile
constexpr int BF_BN = 64;        // columns of a block's tile
constexpr int BF_BK = 32;        // K depth of one staged chunk: two m16n8k16 steps
constexpr int BF_LD = BF_BK + 8; // shared row pitch in bf16 (80 bytes: conflict-free fragment reads)
constexpr int BF_THREADS = 128;  // four warps, 2 x 2 over the tile, 32 x 32 each

// d += a * b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring bf16 values as one 32-bit fragment register (the lower index in the low half)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// out[n, g] = sum_t alpha[t, n] * sum_f x[n, f] * w[t, f, g].  VEC: F % 8 == 0,
// G % 8 == 0 and 16-byte aligned x and w, so a thread copies 8 bf16 at once.
template <bool VEC>
__global__ void __launch_bounds__(BF_THREADS)
rwm_bf16_forward_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ alpha, float* __restrict__ out, int64_t N, int F, int G, int T) {
  __shared__ __align__(16) __nv_bfloat16 sa[BF_BM][BF_LD];  // x chunk [row][k]
  __shared__ __align__(16) __nv_bfloat16 sb[BF_BN][BF_LD];  // w chunk transposed [column][k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row (column) group and pair index
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int64_t m0 = (int64_t)blockIdx.x * BF_BM;
  const int n0 = blockIdx.y * BF_BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  float total[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) total[i][j][k] = 0.0f;

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* wt = w + (int64_t)t * F * G;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;

    for (int k0 = 0; k0 < F; k0 += BF_BK) {
      __syncthreads();  // every warp has read the previous chunk's fragments
      if (VEC) {
        // x: 64 rows x 4 groups of 8 K; w: 32 K x 8 groups of 8 columns (zeros past the edges)
        for (int i = tid; i < BF_BM * (BF_BK / 8); i += BF_THREADS) {
          const int r = i >> 2, c = (i & 3) * 8;
          const int64_t row = m0 + r;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (row < N && k0 + c < F) v = *reinterpret_cast<const uint4*>(x + row * F + k0 + c);
          *reinterpret_cast<uint4*>(&sa[r][c]) = v;
        }
        for (int i = tid; i < BF_BK * (BF_BN / 8); i += BF_THREADS) {
          const int kk = i >> 3, c = (i & 7) * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (k0 + kk < F && n0 + c < G) v = *reinterpret_cast<const uint4*>(wt + (int64_t)(k0 + kk) * G + n0 + c);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) sb[c + j][kk] = e[j];
        }
      } else {
        for (int i = tid; i < BF_BM * BF_BK; i += BF_THREADS) {
          const int r = i / BF_BK, c = i % BF_BK;
          const int64_t row = m0 + r;
          sa[r][c] = (row < N && k0 + c < F) ? x[row * F + k0 + c] : zero;
        }
        for (int i = tid; i < BF_BK * BF_BN; i += BF_THREADS) {
          const int kk = i / BF_BN, c = i % BF_BN;
          sb[c][kk] = (k0 + kk < F && n0 + c < G) ? wt[(int64_t)(k0 + kk) * G + n0 + c] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BF_BK; ks += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm + i * 16 + g;
          a[i][0] = ld_pair(&sa[r][ks + 2 * q]);
          a[i][1] = ld_pair(&sa[r + 8][ks + 2 * q]);
          a[i][2] = ld_pair(&sa[r][ks + 2 * q + 8]);
          a[i][3] = ld_pair(&sa[r + 8][ks + 2 * q + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn + j * 8 + g;
          b[j][0] = ld_pair(&sb[c][ks + 2 * q]);
          b[j][1] = ld_pair(&sb[c][ks + 2 * q + 8]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    }
    // total += alpha[t, row] * (x @ w[t]) on this thread's rows (r0: d[0..1], r1: d[2..3])
    const float* at = alpha + (int64_t)t * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t r0 = m0 + wm + i * 16 + g, r1 = r0 + 8;
      const float a0 = r0 < N ? at[r0] : 0.0f, a1 = r1 < N ? at[r1] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        total[i][j][0] += a0 * acc[i][j][0];
        total[i][j][1] += a0 * acc[i][j][1];
        total[i][j][2] += a1 * acc[i][j][2];
        total[i][j][3] += a1 * acc[i][j][3];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r0 = m0 + wm + i * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + wn + j * 8 + 2 * q;
      if (r0 < N) {
        if (c < G) out[r0 * G + c] = total[i][j][0];
        if (c + 1 < G) out[r0 * G + c + 1] = total[i][j][1];
      }
      if (r1 < N) {
        if (c < G) out[r1 * G + c] = total[i][j][2];
        if (c + 1 < G) out[r1 * G + c + 1] = total[i][j][3];
      }
    }
  }
}

// ------------------------------------------------------------------ bf16 forward on wgmma

constexpr int BW_BK = 64;                        // K depth of a chunk: one 128-byte swizzled row of bf16
constexpr int BW_BOX_N = 32;                     // columns of a w box: 64 bytes, the 64-byte swizzle
constexpr int BW_STAGES = 4;                     // w chunks in flight
constexpr int BW_PANEL = 8;                      // x chunks resident at once (all of F up to 512)
constexpr int BW_THREADS = NT + 32;              // two consumer warpgroups, then the producer warp
constexpr int BW_X_TILE = FWD_BM * BW_BK * 2;    // bytes of one x chunk, 128 rows (16 KB)
constexpr int BW_BOX = BW_BK * BW_BOX_N * 2;     // bytes of one w box, 64 K x 32 columns (4 KB)
constexpr int BW_BARRIERS = BW_PANEL + 1 + 2 * BW_STAGES;

template <int WIDTH>
struct Bf16Tile {
  static_assert(WIDTH % BW_BOX_N == 0, "whole boxes per chunk");
  static constexpr int BOXES = WIDTH / BW_BOX_N;
  static constexpr int STAGE = BOXES * BW_BOX;  // bytes of one w chunk
  static constexpr size_t smem_bytes(int panel) {
    return (size_t)panel * BW_X_TILE + (size_t)BW_STAGES * STAGE + BW_BARRIERS * sizeof(uint64_t) + ALIGN;
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// the producer's arrival, announcing `bytes` that TMA copies will complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed (a fresh barrier counts
// the phase before its first, of parity 1, as completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of an MN-major w chunk (WIDTH columns
// contiguous, as stored) in 32-column boxes of 64 K rows with the 64-byte
// swizzle: start address >> 4, leading offset = the stride between the
// 32-column boxes along MN (4,096 bytes >> 4), stride offset = the stride
// between 8-deep groups of K (8 rows of 64 bytes: 512 >> 4), layout 2 (64B
// swizzle).  The k-th 16-deep slice starts 16 * 64 = 1,024 bytes further.
__device__ __forceinline__ uint64_t smem_desc_mn64(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)(BW_BOX >> 4) << 16) |
         ((uint64_t)((8 * BW_BOX_N * 2) >> 4) << 32) | (2ull << 62);
}

// d[64 x 64] (+)= a[64 x 16] * b[16 x 64], bf16 in, f32 accumulate: A
// K-major, B MN-major (transpose flag 1); d's layout as wgmma_tf32's
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the same as m64n96k16: d[64 x 96]
__device__ __forceinline__ void wgmma_bf16(float (&d)[48], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47},"
      " %48, %49, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the same as m64n128k16: d[64 x 128]
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// out[n, g] = sum_t alpha[t, n] * sum_f x[n, f] * w[t, f, g]; grid (ceil(N/128),
// ceil(G/WIDTH)).  x_map: x [N, F] in boxes of 128 rows x 64 K (128-byte
// swizzle); w_map: w [T, F, G] in boxes of 1 x 64 K x 32 columns (64-byte
// swizzle).  Threads 0-255 are the consumer warpgroups (warpgroup h owns rows
// 64h .. 64h+63 of the tile), thread 256 issues every copy.
template <int WIDTH>
__global__ void __launch_bounds__(BW_THREADS, 1)
rwm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                      const float* __restrict__ alpha, float* __restrict__ out, int64_t N, int F, int G, int T) {
  using Tile = Bf16Tile<WIDTH>;
  extern __shared__ unsigned char smem_bytes[];
  const int nkb = (int)cdiv(F, BW_BK), panel = nkb < BW_PANEL ? nkb : BW_PANEL;
  unsigned char* xs = reinterpret_cast<unsigned char*>(align_smem(smem_bytes));  // [panel][BW_X_TILE]
  unsigned char* ws = xs + panel * BW_X_TILE;                                     // [BW_STAGES][Tile::STAGE]
  uint64_t* x_full = reinterpret_cast<uint64_t*>(ws + BW_STAGES * Tile::STAGE);  // [BW_PANEL]: x chunk landed
  uint64_t* x_empty = x_full + BW_PANEL;                                          // the panel's wgmmas are done
  uint64_t* w_full = x_empty + 1;                                                 // [BW_STAGES]: w chunk landed
  uint64_t* w_empty = w_full + BW_STAGES;                                         // [BW_STAGES]: its wgmmas are done
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * FWD_BM;
  const int n0 = blockIdx.y * WIDTH;
  constexpr int CONSUMER_WARPS = NT / 32;  // each arrives once on an empty barrier

  if (tid == 0) {
    for (int i = 0; i < BW_PANEL; ++i) mbar_init(&x_full[i], 1);
    mbar_init(x_empty, CONSUMER_WARPS);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NT) {  // the producer warp
    if (tid == NT) {
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&x_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
      int stage = 0, parity = 0;
      for (int kb0 = 0, p = 0; kb0 < nkb; kb0 += panel, ++p) {
        const int width = nkb - kb0 < panel ? nkb - kb0 : panel;
        if (p > 0) mbar_wait(x_empty, (p - 1) & 1);  // both warpgroups are done with the previous panel
        for (int kc = 0; kc < width; ++kc) {
          mbar_expect_tx(&x_full[kc], BW_X_TILE);
          tma_load_2d(xs + kc * BW_X_TILE, &x_map, &x_full[kc], (kb0 + kc) * BW_BK, (int)m0);
        }
        for (int t = 0; t < T; ++t) {
          for (int kc = 0; kc < width; ++kc) {
            mbar_wait(&w_empty[stage], parity ^ 1);
            mbar_expect_tx(&w_full[stage], Tile::STAGE);
#pragma unroll
            for (int b = 0; b < Tile::BOXES; ++b) {
              tma_load_3d(ws + stage * Tile::STAGE + b * BW_BOX, &w_map, &w_full[stage], n0 + b * BW_BOX_N,
                          (kb0 + kc) * BW_BK, t);
            }
            if (++stage == BW_STAGES) {
              stage = 0;
              parity ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  const int half = tid / WG, wtid = tid % WG, warp = wtid / 32, lane = tid % 32;
  const int64_t r0 = m0 + half * TBM + warp * 16 + lane / 4, r1 = r0 + 8;
  float acc[WIDTH / 2], res[WIDTH / 2];
  zero(res);
  zero(acc);
  pin(acc);
  int stage = 0, parity = 0;
  for (int kb0 = 0, p = 0; kb0 < nkb; kb0 += panel, ++p) {
    const int width = nkb - kb0 < panel ? nkb - kb0 : panel;
    for (int t = 0; t < T; ++t) {
      const float a0 = r0 < N ? __ldg(alpha + (int64_t)t * N + r0) : 0.f;
      const float a1 = r1 < N ? __ldg(alpha + (int64_t)t * N + r1) : 0.f;
      int held = 0;  // the stage of the chunk whose wgmmas may still run
      for (int kc = 0; kc < width; ++kc) {
        if (t == 0) mbar_wait(&x_full[kc], p & 1);
        mbar_wait(&w_full[stage], parity);
        __syncwarp();  // the lanes leave their waits apart; the wgmmas below are warp-aligned
        const uint64_t da = smem_desc(xs + kc * BW_X_TILE + half * (BW_X_TILE / 2));
        const uint64_t db = smem_desc_mn64(ws + stage * Tile::STAGE);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BW_BK / 16; ++ks) {
          // 16 K further: 32 bytes along x's rows, 16 rows of w's 64-byte rows
          wgmma_bf16(acc, da + 2 * ks, db + 64 * ks, kc > 0 || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's wgmmas are done: its stage may be refilled
        if (kc > 0 && lane == 0) mbar_arrive(&w_empty[held]);
        held = stage;
        if (++stage == BW_STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
      // the relation's K loop over this panel is done
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&w_empty[held]);
      pin(acc);
#pragma unroll
      for (int j = 0; j < WIDTH / 8; ++j) {  // res += alpha[t] (.) acc
        res[4 * j] = fmaf(a0, acc[4 * j], res[4 * j]);
        res[4 * j + 1] = fmaf(a0, acc[4 * j + 1], res[4 * j + 1]);
        res[4 * j + 2] = fmaf(a1, acc[4 * j + 2], res[4 * j + 2]);
        res[4 * j + 3] = fmaf(a1, acc[4 * j + 3], res[4 * j + 3]);
      }
      pin(acc);
    }
    if (lane == 0) mbar_arrive(x_empty);  // this warp's wgmmas of the panel are done
  }
  store_tile(out, res, N, G, m0 + half * TBM, n0, wtid);
}

// cuTensorMapEncodeTiled of the driver API, reached through the runtime so
// that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA can describe x [N, F] and w [T, F, G] in bf16: 16-byte aligned bases and
// row pitches (F and G multiples of 8)
bool bf16_tma_fits(const void* x, const void* w, int F, int G) {
  return F % 8 == 0 && G % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(w) & 15) == 0;
}

// The tensor map of a contiguous bf16 tensor, dims innermost first, elements
// copied in boxes of `box` with `swizzle`, zeros past every edge; encoded on
// the host for every launch, since x is a new tensor every step
bool bf16_map(CUtensorMap* map, cuuint32_t rank, const void* base, const cuuint64_t* dim, const cuuint32_t* box,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t stride[2];  // bytes, of every dim but the innermost
  stride[0] = dim[0] * 2;
  if (rank > 2) stride[1] = stride[0] * dim[1];
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dim, stride, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WIDTH>
int bf16_wgmma_launch_bn(const CUtensorMap& x_map, const CUtensorMap& w_map, const float* alpha, float* out,
                         long long N, int F, int G, int T, cudaStream_t st) {
  const int nkb = (int)cdiv(F, BW_BK);
  const size_t smem = Bf16Tile<WIDTH>::smem_bytes(nkb < BW_PANEL ? nkb : BW_PANEL);
  cudaError_t err = cudaFuncSetAttribute(rwm_bf16_wgmma_kernel<WIDTH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(N, FWD_BM), cdiv(G, WIDTH));
  rwm_bf16_wgmma_kernel<WIDTH><<<grid, BW_THREADS, smem, st>>>(x_map, w_map, alpha, out, N, F, G, T);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher runs on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is a contiguous f32 array of the shape named above.

extern "C" int rwm_forward_launch(const float* x, const float* w, const float* alpha, float* out,
                                  long long N, int F, int G, int T, void* stream) {
  if (N <= 0 || G <= 0) return (int)cudaSuccess;
  return forward_launch<false>(x, w, alpha, out, N, F, G, T, reinterpret_cast<cudaStream_t>(stream));
}

// dx [N, F] from gout [N, G], w [T, F, G], alpha [T, N]
extern "C" int rwm_dx_launch(const float* gout, const float* w, const float* alpha, float* dx,
                             long long N, int F, int G, int T, void* stream) {
  if (N <= 0 || F <= 0) return (int)cudaSuccess;
  return forward_launch<true>(gout, w, alpha, dx, N, G, F, T, reinterpret_cast<cudaStream_t>(stream));
}

// The number of N ranges S that rwm_dw_launch cuts the rows into: as many as
// keep every (F tile, G tile, relation, range) block on an SM of its own in
// one wave, at least 1 and at most one per 32-row chunk.
extern "C" int rwm_dw_splits(long long N, int F, int G, int T) {
  const long long sms = sm_count();
  const long long tiles = (long long)cdiv(F, DW_BM) * cdiv(G, TBN) * (T > 0 ? T : 1);
  long long s = sms / tiles;
  const long long chunks = (long long)cdiv(N, TBK);
  if (s > chunks) s = chunks;
  return s < 1 ? 1 : (int)s;
}

// dw [T, F, G]; `partial` is scratch of S*T*F*G floats when S > 1 (unused when S == 1)
extern "C" int rwm_dw_launch(const float* x, const float* gout, const float* alpha, float* dw, float* partial,
                             long long N, int F, int G, int T, int S, void* stream) {
  if (T <= 0 || F <= 0 || G <= 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(rwm_tc_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DW_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(F, DW_BM), cdiv(G, TBN), (unsigned)(T * S));
  rwm_tc_dw_kernel<<<grid, NT, DW_SMEM_BYTES, st>>>(x, gout, alpha, S > 1 ? partial : dw, N, F, G, T, S);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  return sum_splits(partial, dw, (long long)T * F * G, S, st);
}

// The number of partials S of d alpha: one per (column tile, panel of F)
// of the forward's grid on the current device.
extern "C" int rwm_dalpha_splits(long long N, int F, int G) {
  if (N <= 0 || F <= 0 || G <= 0) return 1;
  const int nkb = (int)cdiv(F, TBK);
  return (int)(cdiv(G, pick_width(N, G)) * cdiv(nkb, nkb < PANEL ? nkb : PANEL));
}

// da [T, N] from x [N, F], w [T, F, G], gout [N, G]; `partial` is scratch of
// S*T*N floats when S = rwm_dalpha_splits(N, F, G) > 1 (unused when S == 1)
extern "C" int rwm_dalpha_launch(const float* x, const float* w, const float* gout, float* da, float* partial,
                                 long long N, int F, int G, int T, int S, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (G <= 0 || F <= 0) return (int)cudaMemsetAsync(da, 0, sizeof(float) * T * N, st);
  if (S != rwm_dalpha_splits(N, F, G)) return (int)cudaErrorInvalidValue;
  const int err = forward_launch<false, true>(x, w, gout, S > 1 ? partial : da, N, F, G, T, st);
  if (err != (int)cudaSuccess || S == 1) return err;
  return sum_splits(partial, da, (long long)T * N, S, st);
}

// out [N, G] f32 from x [N, F] bf16, w [T, F, G] bf16 and alpha [T, N] f32, on
// wgmma; refuses (cudaErrorInvalidValue) operands that TMA cannot describe
extern "C" int rwm_bf16_wgmma_launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* alpha, float* out,
                                     long long N, int F, int G, int T, void* stream) {
  if (N <= 0 || G <= 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (F <= 0 || T <= 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * N * G, st);
  if (!bf16_tma_fits(x, w, F, G)) return (int)cudaErrorInvalidValue;
  // x [N, F] in boxes of 128 rows x 64 K, 128-byte swizzle; w [T, F, G] in
  // boxes of 1 x 64 K x 32 columns, 64-byte swizzle
  const cuuint64_t x_dim[2] = {(cuuint64_t)F, (cuuint64_t)N};
  const cuuint32_t x_box[2] = {BW_BK, FWD_BM};
  const cuuint64_t w_dim[3] = {(cuuint64_t)G, (cuuint64_t)F, (cuuint64_t)T};
  const cuuint32_t w_box[3] = {BW_BOX_N, BW_BK, 1};
  CUtensorMap x_map, w_map;
  if (!bf16_map(&x_map, 2, x, x_dim, x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !bf16_map(&w_map, 3, w, w_dim, w_box, CU_TENSOR_MAP_SWIZZLE_64B)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (pick_width(N, G)) {
    case 128: return bf16_wgmma_launch_bn<128>(x_map, w_map, alpha, out, N, F, G, T, st);
    case 96: return bf16_wgmma_launch_bn<96>(x_map, w_map, alpha, out, N, F, G, T, st);
    default: return bf16_wgmma_launch_bn<64>(x_map, w_map, alpha, out, N, F, G, T, st);
  }
}

// the same on mma.sync, for any F, G and alignment
extern "C" int rwm_bf16_forward_launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* alpha,
                                       float* out, long long N, int F, int G, int T, void* stream) {
  if (N <= 0 || G <= 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (F <= 0 || T <= 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * N * G, st);
  const dim3 grid(cdiv(N, BF_BM), cdiv(G, BF_BN));
  const bool vec = F % 8 == 0 && G % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (vec) {
    rwm_bf16_forward_kernel<true><<<grid, BF_THREADS, 0, st>>>(x, w, alpha, out, N, F, G, T);
  } else {
    rwm_bf16_forward_kernel<false><<<grid, BF_THREADS, 0, st>>>(x, w, alpha, out, N, F, G, T);
  }
  return (int)cudaGetLastError();
}
