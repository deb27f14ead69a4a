// The PPA evaluation body shared by the three kernels (ppa_int.cu,
// ppa_fused.cu, softmax_ppa.cu).
//
// Replaces src/repro/kernels/body.py (select_coeffs_sweep + ppa_eval_block)
// and transcribes src/repro/core/datapath.py::horner_body.
//
// * Segment select: the reference runs an unrolled (S-1)-step
//   compare-select sweep, because the TPU vector unit cannot address
//   memory per lane.  ppa_int.cu binary-searches the segment starts staged
//   in shared memory (ppa_select: upper bound, minus one, clamped at 0):
//   the same row, in ceil(log2(S+1)) steps instead of S-1.  ppa_fused.cu
//   and softmax_ppa.cu stage the table's idx_lut (the same row for every
//   input in [lo, hi), tabulated by kernels/ops.py::pack_table) and select
//   with one load (ppa_stage_lut, below).
// * Horner: signed 32-bit arithmetic with the plan's shifts; `>>` on a
//   signed int is the arithmetic shift (two's-complement floor), as in
//   numpy and torch.  Products, sums and left shifts go through unsigned
//   arithmetic so that they wrap exactly as the int32 tensors of the plain
//   version do (the pack-time guard proves no node leaves int32 anyway).
// * round_mults adds the half ULP only before a positive multiplier shift;
//   the final down_out shift stays a plain floor.
#pragma once

#include <cuda_runtime.h>

#define PPA_MAX_ORDER 4
// layout of the int array the Python wrappers pass (kernels/ops.py
// plan_ints): order, round_mults, mult_shifts[4], up_g[3], up_a[3], up_h,
// up_b, down_out
#define PPA_PLAN_INTS 15

struct PpaPlan {
  int order;
  int round_mults;
  int mult_shifts[PPA_MAX_ORDER];
  int up_g[PPA_MAX_ORDER - 1];
  int up_a[PPA_MAX_ORDER - 1];
  int up_h;
  int up_b;
  int down_out;
};

static inline PpaPlan ppa_plan_from_ints(const int* v) {
  PpaPlan p;
  p.order = v[0];
  p.round_mults = v[1];
  for (int i = 0; i < PPA_MAX_ORDER; ++i) p.mult_shifts[i] = v[2 + i];
  for (int i = 0; i < PPA_MAX_ORDER - 1; ++i) {
    p.up_g[i] = v[6 + i];
    p.up_a[i] = v[9 + i];
  }
  p.up_h = v[12];
  p.up_b = v[13];
  p.down_out = v[14];
  return p;
}

// Shared memory the staged table takes: S starts + S * (order + 1) coefs.
static inline size_t ppa_table_smem_bytes(int num_segments, int order) {
  return sizeof(int) * (size_t)num_segments * (size_t)(order + 2);
}

// Blocks for a grid-stride pass over n elements: enough to fill the card,
// few enough that each block stages the table once for many elements.
static inline int ppa_grid_blocks(long long n, int threads) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  long long want = (n + threads - 1) / threads;
  long long cap = (long long)sms * 8;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

__device__ __forceinline__ int ppa_shl(int v, int s) {
  return (int)((unsigned)v << s);
}

__device__ __forceinline__ int ppa_apply_shift(int v, int sh) {
  if (sh > 0) return v >> sh;
  if (sh < 0) return ppa_shl(v, -sh);
  return v;
}

__device__ __forceinline__ int ppa_trunc_mult(const PpaPlan& p, int v, int sh) {
  if (p.round_mults && sh > 0) v = (int)((unsigned)v + (1u << (sh - 1)));
  return ppa_apply_shift(v, sh);
}

// Index of the last start <= x; 0 below starts[0].
__device__ __forceinline__ int ppa_select(const int* starts, int num_segments,
                                          int x) {
  int lo = 0, hi = num_segments;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (starts[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo > 0 ? lo - 1 : 0;
}

// Select + Horner for one integer input at FWL w_in -> output at FWL w_out.
__device__ __forceinline__ int ppa_eval(const PpaPlan& p, const int* starts,
                                        const int* coefs, int num_segments,
                                        int x) {
  const int* row = coefs + ppa_select(starts, num_segments, x) * (p.order + 1);
  int h = ppa_trunc_mult(p, (int)((unsigned)row[0] * (unsigned)x),
                         p.mult_shifts[0]);
  for (int i = 1; i < p.order; ++i) {
    int g = (int)((unsigned)ppa_shl(h, p.up_g[i - 1]) +
                  (unsigned)ppa_shl(row[i], p.up_a[i - 1]));
    h = ppa_trunc_mult(p, (int)((unsigned)g * (unsigned)x), p.mult_shifts[i]);
  }
  int out = (int)((unsigned)ppa_shl(h, p.up_h) +
                  (unsigned)ppa_shl(row[p.order], p.up_b));
  return ppa_apply_shift(out, p.down_out);
}

// Copy the table into shared memory; every thread of the block takes part.
__device__ __forceinline__ void ppa_stage_table(const int* __restrict__ starts,
                                                const int* __restrict__ coefs,
                                                int num_segments, int order,
                                                int* s_starts, int* s_coefs) {
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x)
    s_starts[i] = starts[i];
  const int nc = num_segments * (order + 1);
  for (int i = threadIdx.x; i < nc; i += blockDim.x) s_coefs[i] = coefs[i];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// For kernels whose order is a template parameter (ppa_fused.cu,
// softmax_ppa.cu).  The stage loop is unrolled, so every index into the
// plan's arrays is a compile-time constant: the plan stays in the kernel's
// parameter space and no stack frame is needed (a loop bounded by the
// run-time `order` makes the compiler copy the plan to local memory).

// Horner over one segment's coefficients c = (a_1 .. a_ORDER, b).
template <int ORDER>
__device__ __forceinline__ int ppa_horner(const PpaPlan& p,
                                          const int (&c)[ORDER + 1], int x) {
  int h = ppa_trunc_mult(p, (int)((unsigned)c[0] * (unsigned)x),
                         p.mult_shifts[0]);
#pragma unroll
  for (int i = 1; i < ORDER; ++i) {
    const int g = (int)((unsigned)ppa_shl(h, p.up_g[i - 1]) +
                        (unsigned)ppa_shl(c[i], p.up_a[i - 1]));
    h = ppa_trunc_mult(p, (int)((unsigned)g * (unsigned)x), p.mult_shifts[i]);
  }
  const int out = (int)((unsigned)ppa_shl(h, p.up_h) +
                        (unsigned)ppa_shl(c[ORDER], p.up_b));
  return ppa_apply_shift(out, p.down_out);
}

// Horner over a coefficient row in shared memory.
template <int ORDER>
__device__ __forceinline__ int ppa_horner_row(const PpaPlan& p,
                                              const int* row, int x) {
  int c[ORDER + 1];
#pragma unroll
  for (int i = 0; i <= ORDER; ++i) c[i] = row[i];
  return ppa_horner<ORDER>(p, c, x);
}

// Shared-memory layout of a staged table: the idx_lut (span = hi - lo
// ints), then the coefficient rows from the next 16-byte boundary.
static inline __host__ __device__ int ppa_lut_coef_offset(int span) {
  return (span + 3) & ~3;
}

static inline size_t ppa_lut_smem_bytes(int span, int num_coefs) {
  return sizeof(int) * ((size_t)ppa_lut_coef_offset(span) + (size_t)num_coefs);
}

// Copy the table's idx_lut and its coefficient rows into shared memory
// (layout above); every thread of the block takes part.  16 bytes a load,
// and each thread issues up to K loads before it stores, so the copy takes
// one round trip to L2 for up to 16 * K bytes a thread (both global arrays
// come from torch allocations, 16-byte aligned).  K sets the registers the
// copy holds: 4 * K.
template <int K>
__device__ __forceinline__ void ppa_stage_lut(const int* __restrict__ idx_lut,
                                              int span,
                                              const int* __restrict__ coefs,
                                              int num_coefs, int* smem) {
  const int na = span / 4, nb = num_coefs / 4, total = na + nb;
  const int4* ga = reinterpret_cast<const int4*>(idx_lut);
  const int4* gb = reinterpret_cast<const int4*>(coefs);
  int4* sa = reinterpret_cast<int4*>(smem);
  int4* sb = reinterpret_cast<int4*>(smem + ppa_lut_coef_offset(span));
  for (int base = threadIdx.x; base < total; base += K * blockDim.x) {
    int4 r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = base + k * blockDim.x;
      if (i < total) r[k] = i < na ? __ldg(ga + i) : __ldg(gb + (i - na));
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = base + k * blockDim.x;
      if (i < total) {
        if (i < na) sa[i] = r[k];
        else sb[i - na] = r[k];
      }
    }
  }
  int* s_coefs = smem + ppa_lut_coef_offset(span);
  for (int i = 4 * na + threadIdx.x; i < span; i += blockDim.x)
    smem[i] = idx_lut[i];
  for (int i = 4 * nb + threadIdx.x; i < num_coefs; i += blockDim.x)
    s_coefs[i] = coefs[i];
  __syncthreads();
}

// The current card's SM count (read once per card), for grids sized to
// the work.
static inline int ppa_sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return cached[dev];
}
