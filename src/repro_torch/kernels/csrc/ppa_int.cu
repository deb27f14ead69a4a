// Integer PPA kernel: int32 x at FWL w_in -> int32 y at FWL w_out.
//
// Replaces the Pallas kernel src/repro/kernels/ppa.py::_ppa_kernel
// (ppa_eval_2d), registry backend "pallas" -> "cuda_int" here.
//
// What bounds it on an H100: per element it reads 4 B and writes 4 B, and
// needs one select (an index and a load) and the Horner chain: 13 int32
// operations at order 2.  At 3.35 TB/s and 16.75 T int32 op/s the 8 B
// take about 2.4 ns per thousand elements against 0.8 for the operations,
// so bytes set the bound: the kernel has to stream.  Design:
// * Select: any int32 x is clamped to [lo, hi - 1] (before subtracting lo,
//   so nothing overflows at the int32 ends) and indexes the table's
//   idx_lut; the row it names is read and Horner runs on the unclamped x.
//   The wrapper (kernels/ppa.py) refuses a table whose idx_lut does not
//   run from row 0 to row S - 1, so this is the search's row for every
//   int32 input:
//   the out-of-interval inputs wrap as the plain version's int32 tensors
//   do.  Each block stages the idx_lut and the rows in shared memory (1.2
//   KB for exp2_frac-16, 13.7 KB for sigmoid_wide-16, at most 22.0 KB) and
//   issues its first inputs' load before that, so both arrive in one round
//   trip.
// * The kernel is templated on the order, so every index into the plan is
//   a compile-time constant (no stack frame).
// * Each thread loads and stores 16 bytes (4 values) and loads its next
//   vector while it computes the current one; the wrapper gives the count
//   of such vectors, and the elements after them (or all of them, for an
//   input not 16-byte aligned) take one thread each.  The grid is sized to
//   that work up to INT_BLOCKS_PER_SM blocks per SM, beyond which blocks
//   walk the input, so a block's staged table serves many vectors.  Of
//   the launch shapes measured (PERF.md), 4 blocks of 256 threads per SM
//   were the fastest: more blocks stage the table more often, fewer
//   threads keep fewer loads in flight.
#include "ppa_body.cuh"

#define INT_THREADS 256
#define INT_BLOCKS_PER_SM 4

struct IntArgs {
  const int* idx_lut;  // (hi - lo,) segment of each input in [lo, hi)
  const int* coefs;    // (S, order + 1): a_1 .. a_n, b
  int num_coefs;
  int lo, hi;
};

template <int ORDER>
__device__ __forceinline__ int int_one(const IntArgs& a, const PpaPlan& p,
                                       const int* s_idx, const int* s_coefs,
                                       int x) {
  const int xc = min(max(x, a.lo), a.hi - 1);
  return ppa_horner_row<ORDER>(p, s_coefs + s_idx[xc - a.lo] * (ORDER + 1),
                               x);
}

// A grid-stride walk: thread g takes the 16-byte vectors g, g + stride, ...
// below n_vec, then the elements n_vec * 4 + g, ... below n.
template <int ORDER>
__global__ void __launch_bounds__(INT_THREADS)
    ppa_int_kernel(const int* __restrict__ x, int* __restrict__ y, long long n,
                   long long n_vec, IntArgs a, PpaPlan p) {
  extern __shared__ int4 smem4[];  // 16-byte aligned
  int* smem = reinterpret_cast<int*>(smem4);
  const int span = a.hi - a.lo;
  const int* s_idx = smem;
  const int* s_coefs = smem + ppa_lut_coef_offset(span);
  const int4* x4 = reinterpret_cast<const int4*>(x);
  int4* y4 = reinterpret_cast<int4*>(y);
  const long long g = (long long)blockIdx.x * INT_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * INT_THREADS;
  int4 v;
  if (g < n_vec) v = x4[g];
  // every shipped table (22.0 KB at most) in one round of 8 loads a thread
  ppa_stage_lut<8>(a.idx_lut, span, a.coefs, a.num_coefs, smem);
  for (long long t = g; t < n_vec; t += stride) {
    // the next vector loads while this one is computed
    const bool more = t + stride < n_vec;
    int4 next;
    if (more) next = x4[t + stride];
    int4 r;
    r.x = int_one<ORDER>(a, p, s_idx, s_coefs, v.x);
    r.y = int_one<ORDER>(a, p, s_idx, s_coefs, v.y);
    r.z = int_one<ORDER>(a, p, s_idx, s_coefs, v.z);
    r.w = int_one<ORDER>(a, p, s_idx, s_coefs, v.w);
    y4[t] = r;
    if (more) v = next;
  }
  for (long long i = n_vec * 4 + g; i < n; i += stride)
    y[i] = int_one<ORDER>(a, p, s_idx, s_coefs, x[i]);
}

// One thread per vector (or per element past the vectors), in blocks of
// INT_THREADS, at most INT_BLOCKS_PER_SM blocks per SM (ppa_lut_grid).
template <int ORDER>
static int launch(const int* x, int* y, long long n, long long n_vec,
                  const IntArgs& a, const PpaPlan& p, cudaStream_t stream) {
  PpaGrid g;
  const cudaError_t rc =
      ppa_lut_grid(n_vec, n - n_vec * 4, INT_THREADS, INT_BLOCKS_PER_SM,
                   a.hi - a.lo, a.num_coefs, &g);
  if (rc != cudaSuccess) return (int)rc;
  ppa_int_kernel<ORDER><<<g.blocks, INT_THREADS, g.smem, stream>>>(
      x, y, n, n_vec, a, p);
  return (int)cudaGetLastError();
}

// n_vec: 16-byte vectors to load as such (0 unless x and y are 16-byte
// aligned).  The table's idx_lut covers [lo, hi).
extern "C" int ppa_int_launch(const int* x, int* y, long long n,
                              long long n_vec, const int* idx_lut,
                              const int* coefs, int num_coefs,
                              const int* plan_ints, int lo, int hi,
                              void* stream) {
  if (n <= 0) return 0;
  if (n_vec < 0 || n_vec * 4 > n || hi <= lo)
    return (int)cudaErrorInvalidValue;
  const IntArgs a = {idx_lut, coefs, num_coefs, lo, hi};
  const PpaPlan p = ppa_plan_from_ints(plan_ints);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.order) {
    case 1: return launch<1>(x, y, n, n_vec, a, p, s);
    case 2: return launch<2>(x, y, n, n_vec, a, p, s);
    case 3: return launch<3>(x, y, n, n_vec, a, p, s);
    case 4: return launch<4>(x, y, n, n_vec, a, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
