// Design study for the fused PPA kernel's segment select; not part of the
// package.  The package's kernel (src/repro_torch/kernels/csrc/
// ppa_fused.cu, included whole below and so built here once more) looks
// the segment up in the table's idx_lut, staged in shared memory.  The
// alternative: a coarse first-level index over the top bits of x - lo
// gives the segment of the bucket's first input, and a few search steps
// over the starts finish the select; its tables are staged the same way.
// scripts/torch_select_study.py builds this file and times both on the
// card.
#include "ppa_fused.cu"

// the package kernel's default launch shape (kernels/fused.py
// DEFAULT_LAUNCH), at which both are timed
#define FUSED_THREADS 128
#define FUSED_BLOCKS_PER_SM 4

struct CoarseArgs {
  const int* starts;  // (S,)
  const int* first;   // per bucket: the segment of its first input
  int num_buckets;
  int num_segments;
  int shift;          // bucket of x: (x - lo) >> shift
  int top;            // first search step, 2^(steps - 1); 0 for no step
};

// s_first, s_starts, s_coefs: the coarse index, the starts and the rows,
// staged in shared memory as the package's kernel stages its table.
template <int ORDER, int SYM, bool GATE>
__device__ __forceinline__ float coarse_one(const FusedArgs& a,
                                            const CoarseArgs& c,
                                            const PpaPlan& p,
                                            const int* s_first,
                                            const int* s_starts,
                                            const int* s_coefs, float x0) {
  const float xf = SYM != SYM_NONE ? fabsf(x0) : x0;
  bool oob_hi;
  const int xi = fused_quantize(a, xf, oob_hi);
  int seg = s_first[(xi - a.lo) >> c.shift];
  for (int step = c.top; step > 0; step >>= 1)
    if (seg + step < c.num_segments && s_starts[seg + step] <= xi)
      seg += step;
  return fused_finish<SYM, GATE>(
      a, ppa_horner_row<ORDER>(p, s_coefs + seg * (ORDER + 1), xi), x0, xf,
      oob_hi);
}

// The served case only: bf16, order 2, sigmoid symmetry, gated; the same
// walk as ppa_fused_kernel.
__global__ void __launch_bounds__(FUSED_THREADS)
    coarse_fused_kernel(const __nv_bfloat16* __restrict__ x,
                        __nv_bfloat16* __restrict__ y, long long n,
                        long long n_vec, FusedArgs a, CoarseArgs c,
                        PpaPlan p) {
  using V = Vec16<__nv_bfloat16>;
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int* s_first = smem;
  const int* s_starts = smem + ppa_lut_coef_offset(c.num_buckets);
  int* tail = smem + ppa_lut_coef_offset(c.num_buckets) +
              ppa_lut_coef_offset(c.num_segments);
  const int* s_coefs = tail;
  const long long g = (long long)blockIdx.x * FUSED_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * FUSED_THREADS;
  float v[V::N];
  if (g < n_vec) V::load(x + g * V::N, v);
  ppa_stage_lut<8>(c.first, c.num_buckets, c.starts, c.num_segments, smem);
  ppa_stage_lut<8>(a.coefs, a.num_coefs, a.coefs, 0, tail);
  for (long long t = g; t < n_vec; t += stride) {
#pragma unroll
    for (int i = 0; i < V::N; ++i)
      v[i] = coarse_one<2, SYM_SIGMOID, true>(a, c, p, s_first, s_starts,
                                              s_coefs, v[i]);
    V::store(y + t * V::N, v);
    if (t + stride < n_vec) V::load(x + (t + stride) * V::N, v);
  }
  for (long long i = n_vec * V::N + g; i < n; i += stride)
    y[i] = V::narrow(coarse_one<2, SYM_SIGMOID, true>(
        a, c, p, s_first, s_starts, s_coefs, V::widen(x[i])));
}

// Arguments as ppa_fused_launch's for a bf16 input, with the coarse index
// in place of idx_lut.
extern "C" int coarse_fused_launch(const void* x, void* y, long long n,
                                   long long n_vec, const int* first,
                                   int num_buckets, const int* starts,
                                   int num_segments, int shift, int top,
                                   const int* coefs, int num_coefs,
                                   const int* plan_ints, const int* statics_i,
                                   float sat_hi, void* stream) {
  if (n <= 0) return 0;
  const PpaPlan p = ppa_plan_from_ints(plan_ints);
  if (p.order != 2 || statics_i[2] != SYM_SIGMOID || !statics_i[4])
    return (int)cudaErrorInvalidValue;
  FusedArgs a;
  a.idx_lut = nullptr;
  a.coefs = coefs;
  a.num_coefs = num_coefs;
  a.lo = statics_i[0];
  a.hi = statics_i[1];
  a.sat = statics_i[3];
  a.sat_hi = sat_hi;
  a.scale_in = (float)(1 << statics_i[5]);
  a.inv_scale_out = 1.0f / (float)(1 << statics_i[6]);
  CoarseArgs c;
  c.starts = starts;
  c.first = first;
  c.num_buckets = num_buckets;
  c.num_segments = num_segments;
  c.shift = shift;
  c.top = top;
  // the grid of ppa_fused.cu's launch_gate
  const long long tail = n - n_vec * 8;
  const long long work = n_vec > tail ? n_vec : tail;
  const long long cap = (long long)ppa_sm_count() * FUSED_BLOCKS_PER_SM;
  const long long want = (work + FUSED_THREADS - 1) / FUSED_THREADS;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  const size_t smem =
      sizeof(int) * ((size_t)ppa_lut_coef_offset(num_buckets) +
                     (size_t)ppa_lut_coef_offset(num_segments) + num_coefs);
  coarse_fused_kernel<<<blocks, FUSED_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, n_vec, a, c, p);
  return (int)cudaGetLastError();
}
