// The PPA evaluation body shared by the three kernels (ppa_int.cu,
// ppa_fused.cu, softmax_ppa.cu).
//
// Replaces src/repro/kernels/body.py (select_coeffs_sweep + ppa_eval_block)
// and transcribes src/repro/core/datapath.py::horner_body.
//
// * Segment select: the reference runs an unrolled (S-1)-step
//   compare-select sweep, because the TPU vector unit cannot address
//   memory per lane.  Here each kernel stages the table's idx_lut (the
//   segment of every input in [lo, hi), tabulated by kernels/ops.py::
//   pack_table) and the coefficient rows in shared memory (ppa_stage_lut,
//   below), and selects with one load of the idx_lut at the input clamped
//   to [lo, hi - 1].
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

// ---------------------------------------------------------------------------
// Every kernel takes the order as a template parameter.  The stage loop is
// unrolled, so every index into the plan's arrays is a compile-time
// constant: the plan stays in the kernel's parameter space and no stack frame is needed (a loop bounded by the
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

// The launch of an elementwise kernel that stages a table (ppa_stage_lut)
// and gives each thread one 16-byte vector, or one element past the n_vec
// vectors (tail of them): blocks of `threads` sized to that work, at most
// blocks_per_sm per SM, beyond which blocks walk the input so that a
// block's staged table serves many vectors.  Fails when the staged table
// does not fit in the 48 KB of shared memory a launch gets without opting
// in.
struct PpaGrid {
  unsigned blocks;
  size_t smem;
};

static inline cudaError_t ppa_lut_grid(long long n_vec, long long tail,
                                       int threads, int blocks_per_sm,
                                       int span, int num_coefs, PpaGrid* g) {
  const long long work = n_vec > tail ? n_vec : tail;
  const long long cap = (long long)ppa_sm_count() * blocks_per_sm;
  const long long want = (work + threads - 1) / threads;
  g->blocks = (unsigned)(want < cap ? want : cap);
  g->smem = ppa_lut_smem_bytes(span, num_coefs);
  return g->smem > 48 * 1024 ? cudaErrorInvalidValue : cudaSuccess;
}
