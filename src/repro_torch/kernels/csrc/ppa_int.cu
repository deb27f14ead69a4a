// Integer PPA kernel: int32 x at FWL w_in -> int32 y at FWL w_out.
//
// Replaces the Pallas kernel src/repro/kernels/ppa.py::_ppa_kernel
// (ppa_eval_2d), registry backend "pallas" -> "cuda_int" here.
//
// What bounds it on an H100: per element it reads 4 B and writes 4 B, and
// does a binary search over S starts (ceil(log2(S+1)) compare-select steps,
// about 10 for sigmoid_wide's 461 segments) plus the order-2 Horner chain:
// some 40-60 int32 operations (47 for sigmoid_wide).  An H100 SXM has 64
// int32 lanes per SM, 16.75 T op/s in all, against 3.35 TB/s of device
// memory: 47 operations take longer than 8 B, so operations set the bound.
// Design: the flat array is walked grid-stride with a masked tail (no tile
// padding, which was a TPU constraint), and the grid is capped at 8 blocks
// per SM so every block stages the (S,) starts and (S, n+1) coefficient
// ROM into shared memory once (under 9 KB for S <= 537) and reuses them
// for thousands of elements; the search then runs on shared memory.
#include "ppa_body.cuh"

__global__ void ppa_int_kernel(const int* __restrict__ x, int* __restrict__ y,
                               long long n, const int* __restrict__ starts,
                               const int* __restrict__ coefs, int num_segments,
                               PpaPlan plan) {
  extern __shared__ int smem[];
  int* s_starts = smem;
  int* s_coefs = smem + num_segments;
  ppa_stage_table(starts, coefs, num_segments, plan.order, s_starts, s_coefs);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = ppa_eval(plan, s_starts, s_coefs, num_segments, x[i]);
  }
}

extern "C" int ppa_int_launch(const int* x, int* y, long long n,
                              const int* starts, const int* coefs,
                              int num_segments, const int* plan_ints,
                              void* stream) {
  if (n <= 0) return 0;
  const PpaPlan plan = ppa_plan_from_ints(plan_ints);
  const int threads = 256;
  const size_t smem = ppa_table_smem_bytes(num_segments, plan.order);
  ppa_int_kernel<<<ppa_grid_blocks(n, threads), threads, smem,
                   (cudaStream_t)stream>>>(x, y, n, starts, coefs,
                                           num_segments, plan);
  return (int)cudaGetLastError();
}
