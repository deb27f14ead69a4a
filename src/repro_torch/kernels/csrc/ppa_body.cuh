// The one PPA evaluation body shared by the three kernels
// (ppa_int.cu, ppa_fused.cu, softmax_ppa.cu).
//
// Replaces src/repro/kernels/body.py (select_coeffs_sweep + ppa_eval_block)
// and transcribes src/repro/core/datapath.py::horner_body.
//
// * Segment select: the reference runs an unrolled (S-1)-step
//   compare-select sweep, because the TPU vector unit cannot address
//   memory per lane.  Here each thread binary-searches the segment starts
//   staged in shared memory (upper bound, minus one, clamped at 0): the
//   same row, in ceil(log2(S+1)) steps instead of S-1.
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
