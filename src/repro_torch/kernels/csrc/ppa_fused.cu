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
// x.dtype) are those of the plain version, kernels/fused.py::condition_f32,
// and every float operation is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, ...), built with -fmad=false: nothing is
// contracted into an FMA, so the result is bit-identical.  The division by
// 2^w_out is a product with the exact 2^-w_out, which rounds the same way.
// A bf16 input is widened on load and the float32 result rounded to
// nearest-even on store (__floats2bfloat162_rn), as torch's .to(bfloat16)
// does.
//
// What bounds it on an H100: on the main path it is the SwiGLU silu gate
// on (B, T, 8192) bf16, (4, 1, 8192) at decode and (512, 8192) at the
// largest prefill bucket.  Per element it moves 2 B in and 2 B out, and
// needs one select (an index and a load), the order-2 Horner chain and
// the conditioning: about 20 int32 and 12 float32 operations.  At 3.35
// TB/s and 16.75 T int32 op/s the two take about as long, so the kernel is
// bound by bytes and int32 issue together.  Design:
// * Select: the clipped input indexes the table's idx_lut (pack_table's
//   segment of every input in [lo, hi), at most 4096 entries for the
//   shipped tables), and the coefficient row it names is read: two
//   shared-memory loads.  Each block stages the idx_lut and the rows once
//   (8 KB + 5.5 KB for sigmoid_wide-16), and issues its first inputs'
//   load before that, so both arrive in one round trip.  (Read through L1
//   instead, with no staging, the two dependent gathers each went to L2 on
//   a cold SM, and the kernel was slower than the parent's at decode; see
//   PERF.md.)
// * The kernel is templated on the order, the symmetry and the gate, so
//   the plan's arrays are indexed at compile time (no stack frame) and the
//   unused branches are gone.
// * Each thread loads and stores 16 bytes (8 bf16 or 4 float32 values);
//   the wrapper gives the count of such vectors, and the elements after
//   them (or all of them, for an input not 16-byte aligned) take one
//   thread each.  The grid is sized to that work up to the launch's
//   blocks per SM (below), beyond which blocks walk the input, so a
//   block's staged table serves many vectors.
// * The launch shape (threads a block, blocks an SM at most) is the
//   wrapper's argument: kernels/fused.py's process default, (128, 4), which
//   the tuner (tune/autotune.py, stage 3) may replace.  The kernel reads
//   blockDim, so one entry serves every shape; __launch_bounds__ of the
//   largest block, FUSED_MAX_THREADS, caps its registers at 128.  Every
//   shape computes each element alike, so the output is bit-identical
//   across shapes.
#include <cuda_bf16.h>

#include "ppa_body.cuh"

// symmetry codes, as kernels/fused.py passes them
#define SYM_NONE 0
#define SYM_ODD 1
#define SYM_SIGMOID 2
#define SYM_MINUS_X 3

// saturation of inputs at or beyond hi
#define SAT_NONE 0
#define SAT_CONST 1
#define SAT_IDENTITY 2

// the largest block a launch may ask for (registers: 65536 / 512 = 128)
#define FUSED_MAX_THREADS 512

struct FusedArgs {
  const int* idx_lut;  // (hi - lo,) segment of each input in [lo, hi)
  const int* coefs;    // (S, order + 1): a_1 .. a_n, b
  int num_coefs;
  int lo, hi;
  int sat;
  float sat_hi;
  float scale_in;       // 2^w_in
  float inv_scale_out;  // 2^-w_out
};

// Quantize the range-reduced input xf to the table's grid and clip it to
// [lo, hi - 1]; oob_hi flags the inputs at or beyond hi.
__device__ __forceinline__ int fused_quantize(const FusedArgs& a, float xf,
                                              bool& oob_hi) {
  // round down to int32, saturating (cvt.rmi.s32.f32): floor, then the
  // plain version's truncating conversion, in one step
  int xi = __float2int_rd(__fadd_rn(__fmul_rn(fabsf(xf), a.scale_in), 0.5f));
  if (xf < 0.0f) xi = -xi;
  oob_hi = xi >= a.hi;
  return min(max(xi, a.lo), a.hi - 1);
}

// The datapath's output yi back to float: dequantize, saturate, restore
// the symmetry, gate.
template <int SYM, bool GATE>
__device__ __forceinline__ float fused_finish(const FusedArgs& a, int yi,
                                              float x0, float xf,
                                              bool oob_hi) {
  float v = __fmul_rn((float)yi, a.inv_scale_out);
  if (a.sat == SAT_IDENTITY) {
    if (oob_hi) v = xf;
  } else if (a.sat == SAT_CONST) {
    if (oob_hi) v = a.sat_hi;
  }
  if (SYM != SYM_NONE && x0 < 0.0f) {
    if (SYM == SYM_ODD) v = -v;
    else if (SYM == SYM_SIGMOID) v = __fsub_rn(1.0f, v);
    else v = __fsub_rn(v, xf);
  }
  if (GATE) v = __fmul_rn(x0, v);
  return v;
}

// One element; s_idx and s_coefs are the table staged in shared memory.
template <int ORDER, int SYM, bool GATE>
__device__ __forceinline__ float fused_one(const FusedArgs& a,
                                           const PpaPlan& p, const int* s_idx,
                                           const int* s_coefs, float x0) {
  const float xf = SYM != SYM_NONE ? fabsf(x0) : x0;
  bool oob_hi;
  const int xi = fused_quantize(a, xf, oob_hi);
  const int* row = s_coefs + s_idx[xi - a.lo] * (ORDER + 1);
  return fused_finish<SYM, GATE>(a, ppa_horner_row<ORDER>(p, row, xi), x0,
                                 xf, oob_hi);
}

// 16 bytes of T as float32 values, and back
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the upper half of the float32 with the same value
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = (unsigned)__bfloat16_as_ushort(h.x) |
             ((unsigned)__bfloat16_as_ushort(h.y) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
};

// A grid-stride walk: thread g takes the 16-byte vectors g, g + stride, ...
// below n_vec, then the elements n_vec * N + g, ... below n.  The first
// vector's load is issued before the table is staged, so both are in
// flight together.
template <typename T, int ORDER, int SYM, bool GATE>
__global__ void __launch_bounds__(FUSED_MAX_THREADS)
    ppa_fused_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                     long long n_vec, FusedArgs a, PpaPlan p) {
  constexpr int N = Vec16<T>::N;
  extern __shared__ int4 smem4[];  // 16-byte aligned
  int* smem = reinterpret_cast<int*>(smem4);
  const int span = a.hi - a.lo;
  const int* s_idx = smem;
  const int* s_coefs = smem + ppa_lut_coef_offset(span);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float v[N];
  if (g < n_vec) Vec16<T>::load(x + g * N, v);
  // sigmoid_wide-16's 13.5 KB in one round of 8 loads a thread
  ppa_stage_lut<8>(a.idx_lut, span, a.coefs, a.num_coefs, smem);
  for (long long t = g; t < n_vec; t += stride) {
    // the next vector loads while this one is computed
    const bool more = t + stride < n_vec;
    float next[N];
    if (more) Vec16<T>::load(x + (t + stride) * N, next);
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = fused_one<ORDER, SYM, GATE>(a, p, s_idx, s_coefs, v[i]);
    Vec16<T>::store(y + t * N, v);
    if (more) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = next[i];
    }
  }
  for (long long i = n_vec * N + g; i < n; i += stride)
    y[i] = Vec16<T>::narrow(fused_one<ORDER, SYM, GATE>(
        a, p, s_idx, s_coefs, Vec16<T>::widen(x[i])));
}

struct FusedLaunch {
  const void* x;
  void* y;
  long long n, n_vec;
  FusedArgs a;
  PpaPlan p;
  int threads, blocks_per_sm;
  cudaStream_t stream;
};

// One thread per vector (or per element past the vectors), in blocks of
// L.threads, at most L.blocks_per_sm blocks per SM: a small input
// (decode) gets a grid sized to it, a large one (prefill) walks with each
// block's table staged once for many vectors.
template <typename T, int ORDER, int SYM>
static int launch_gate(const FusedLaunch& L, int gate) {
  PpaGrid g;
  const cudaError_t rc = ppa_lut_grid(
      L.n_vec, L.n - L.n_vec * Vec16<T>::N, L.threads, L.blocks_per_sm,
      L.a.hi - L.a.lo, L.a.num_coefs, &g);
  if (rc != cudaSuccess) return (int)rc;
  const T* x = (const T*)L.x;
  T* y = (T*)L.y;
  if (gate)
    ppa_fused_kernel<T, ORDER, SYM, true>
        <<<g.blocks, L.threads, g.smem, L.stream>>>(x, y, L.n, L.n_vec, L.a,
                                                     L.p);
  else
    ppa_fused_kernel<T, ORDER, SYM, false>
        <<<g.blocks, L.threads, g.smem, L.stream>>>(x, y, L.n, L.n_vec, L.a,
                                                     L.p);
  return (int)cudaGetLastError();
}

template <typename T, int ORDER>
static int launch_sym(const FusedLaunch& L, int sym, int gate) {
  switch (sym) {
    case SYM_NONE: return launch_gate<T, ORDER, SYM_NONE>(L, gate);
    case SYM_ODD: return launch_gate<T, ORDER, SYM_ODD>(L, gate);
    case SYM_SIGMOID: return launch_gate<T, ORDER, SYM_SIGMOID>(L, gate);
    case SYM_MINUS_X: return launch_gate<T, ORDER, SYM_MINUS_X>(L, gate);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_order(const FusedLaunch& L, int sym, int gate) {
  switch (L.p.order) {
    case 1: return launch_sym<T, 1>(L, sym, gate);
    case 2: return launch_sym<T, 2>(L, sym, gate);
    case 3: return launch_sym<T, 3>(L, sym, gate);
    case 4: return launch_sym<T, 4>(L, sym, gate);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16.  n_vec: 16-byte vectors to load as such
// (0 unless x and y are 16-byte aligned).  statics_i: lo, hi, symmetry,
// saturation, gate, w_in, w_out.  threads: a multiple of 32 up to
// FUSED_MAX_THREADS; blocks_per_sm: at least 1, at most 2048 threads an SM.
extern "C" int ppa_fused_launch(const void* x, void* y, long long n,
                                long long n_vec, int dtype, const int* idx_lut,
                                const int* coefs, int num_coefs,
                                const int* plan_ints,
                                const int* statics_i, float sat_hi,
                                int threads, int blocks_per_sm,
                                void* stream) {
  if (threads <= 0 || threads > FUSED_MAX_THREADS || threads % 32 != 0 ||
      blocks_per_sm <= 0 || threads * blocks_per_sm > 2048)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  FusedLaunch L;
  L.x = x;
  L.y = y;
  L.n = n;
  L.n_vec = n_vec;
  L.a.idx_lut = idx_lut;
  L.a.coefs = coefs;
  L.a.num_coefs = num_coefs;
  L.a.lo = statics_i[0];
  L.a.hi = statics_i[1];
  L.a.sat = statics_i[3];
  L.a.sat_hi = sat_hi;
  L.a.scale_in = (float)(1 << statics_i[5]);
  L.a.inv_scale_out = 1.0f / (float)(1 << statics_i[6]);
  L.p = ppa_plan_from_ints(plan_ints);
  L.threads = threads;
  L.blocks_per_sm = blocks_per_sm;
  L.stream = (cudaStream_t)stream;
  const int sym = statics_i[2], gate = statics_i[4];
  if (dtype == 0) {
    if (n_vec < 0 || n_vec * 4 > n) return (int)cudaErrorInvalidValue;
    return launch_order<float>(L, sym, gate);
  }
  if (dtype == 1) {
    if (n_vec < 0 || n_vec * 8 > n) return (int)cudaErrorInvalidValue;
    return launch_order<__nv_bfloat16>(L, sym, gate);
  }
  return (int)cudaErrorInvalidValue;
}
