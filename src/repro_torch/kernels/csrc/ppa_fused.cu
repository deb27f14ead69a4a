// Fused float -> PPA -> float activation kernel, float32 or bfloat16.
//
// Replaces the Pallas kernel src/repro/kernels/fused.py::_fused_kernel
// (ppa_fused_2d / ppa_fused_apply), registry backend "pallas_fused" ->
// "cuda_fused" here.  Per element, in float32:
//   quantize floor(|x| * 2^w_in + 0.5) -> symmetry -> clip to [lo, hi-1]
//   with oob_hi -> select + Horner -> / 2^w_out -> saturation (sat_hi or
//   identity) -> symmetry restore (odd / sigmoid / minus_x) -> optional
//   x * T(x) gate.
// The order of operations and the cast points (x -> float32 ... ->
// x.dtype) are those of the plain version, kernels/ops.py::_apply_f32, and
// every float operation is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, ...), built with -fmad=false: nothing is
// contracted into an FMA, so the result is bit-identical.  A bf16 input is
// widened on load and the float32 result rounded to nearest-even on store
// (__float2bfloat16_rn), as torch's .to(bfloat16) does.
//
// What bounds it on an H100: on the main path it is the SwiGLU silu gate on
// (B, T, 8192) bf16 at prefill and decode, 2 B read + 2 B written per
// element, against a binary search over 461 starts plus order-2 Horner
// (about 54 int32 operations with the clamps and selects) and about 12
// float operations.  An H100 SXM has 64 int32 lanes per SM, 16.75 T op/s
// in all, against 3.35 TB/s of device memory: the int32 operations take
// about 2.7x as long as the 4 B, so operations set the bound.  Design:
// as ppa_int.cu, a capped grid-stride walk with the table staged once per
// block in shared memory; moving 2 B instead of 4 B per element in bf16
// halves the bytes of the float32 reference kernel.
#include <cuda_bf16.h>

#include "ppa_body.cuh"

// symmetry codes, as kernels/fused.py passes them
#define SYM_NONE 0
#define SYM_ODD 1
#define SYM_SIGMOID 2
#define SYM_MINUS_X 3

struct FusedStatics {
  int lo, hi;
  int symmetry;
  int has_sat_hi;
  int sat_identity;
  int gate;
  float sat_hi;
  float scale_in;   // 2^w_in
  float scale_out;  // 2^w_out
};

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void ppa_fused_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 long long n, const int* __restrict__ starts,
                                 const int* __restrict__ coefs,
                                 int num_segments, PpaPlan plan,
                                 FusedStatics st) {
  extern __shared__ int smem[];
  int* s_starts = smem;
  int* s_coefs = smem + num_segments;
  ppa_stage_table(starts, coefs, num_segments, plan.order, s_starts, s_coefs);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x0 = load_f32(x, i);
    const float xf = st.symmetry != SYM_NONE ? fabsf(x0) : x0;
    // float -> int32 conversion truncates and saturates (cvt.rzi.s32.f32)
    int xi = (int)floorf(__fadd_rn(__fmul_rn(fabsf(xf), st.scale_in), 0.5f));
    if (xf < 0.0f) xi = -xi;
    const bool oob_hi = xi >= st.hi;
    xi = min(max(xi, st.lo), st.hi - 1);
    const int yi = ppa_eval(plan, s_starts, s_coefs, num_segments, xi);
    float v = __fdiv_rn((float)yi, st.scale_out);
    if (st.sat_identity) {
      if (oob_hi) v = xf;
    } else if (st.has_sat_hi) {
      if (oob_hi) v = st.sat_hi;
    }
    const bool neg = x0 < 0.0f;
    if (neg) {
      if (st.symmetry == SYM_ODD) v = -v;
      else if (st.symmetry == SYM_SIGMOID) v = __fsub_rn(1.0f, v);
      else if (st.symmetry == SYM_MINUS_X) v = __fsub_rn(v, xf);
    }
    if (st.gate) v = __fmul_rn(x0, v);
    store_f32(y, i, v);
  }
}

// dtype: 0 float32, 1 bfloat16.  statics_i: lo, hi, symmetry, has_sat_hi,
// sat_identity, gate, w_in, w_out.
extern "C" int ppa_fused_launch(const void* x, void* y, long long n, int dtype,
                                const int* starts, const int* coefs,
                                int num_segments, const int* plan_ints,
                                const int* statics_i, float sat_hi,
                                void* stream) {
  if (n <= 0) return 0;
  const PpaPlan plan = ppa_plan_from_ints(plan_ints);
  FusedStatics st;
  st.lo = statics_i[0];
  st.hi = statics_i[1];
  st.symmetry = statics_i[2];
  st.has_sat_hi = statics_i[3];
  st.sat_identity = statics_i[4];
  st.gate = statics_i[5];
  st.sat_hi = sat_hi;
  st.scale_in = (float)(1 << statics_i[6]);
  st.scale_out = (float)(1 << statics_i[7]);
  const int threads = 256;
  const int blocks = ppa_grid_blocks(n, threads);
  const size_t smem = ppa_table_smem_bytes(num_segments, plan.order);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    ppa_fused_kernel<float><<<blocks, threads, smem, s>>>(
        (const float*)x, (float*)y, n, starts, coefs, num_segments, plan, st);
  } else if (dtype == 1) {
    ppa_fused_kernel<__nv_bfloat16><<<blocks, threads, smem, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, starts, coefs,
        num_segments, plan, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
