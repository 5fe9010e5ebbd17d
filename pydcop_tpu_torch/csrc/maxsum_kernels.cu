// Max-Sum's two contiguous phases as hand-written CUDA kernels for Hopper
// (sm_90a), with a plain C interface bound from Python by ctypes
// (pydcop_tpu_torch/ops/maxsum_kernels.py builds and loads this file).
//
// They replace the three Pallas TPU kernels of
// pydcop_tpu/ops/pallas_maxsum.py and compute what those compute:
//
//   factor_round_binary_shared  <- factor_round_binary_shared / _factor_kernel_shared
//   factor_round_binary         <- factor_round_binary / _factor_kernel
//   q_update                    <- q_update / _qup_kernel
//
// Layout: messages are [d, m] (or [d, E]) row-major, so element (a, i)
// sits at a * ld + i, ld the row stride (the factor kernels read their q
// rows from, and write their r rows into, column blocks of the [d, E]
// message arrays in place).  One thread owns one lane i and walks the grid in a
// grid-stride loop; neighbouring threads read neighbouring i, so every
// load and store of a row is coalesced.  The per-lane partial minima live
// in registers (the domain size d is a template parameter for the small
// domains; one generic instance takes any runtime d, its arrays in local
// memory: d <= 64 for the factor kernels, the Pallas kernels' cap; the
// generic q update keeps no array and reads its inputs twice, so it takes
// any d).  The ragged tail of m is masked by the loop bound; no lane
// padding is copied.
//
// Bound: all three are memory-bound streaming passes (a handful of f32
// operations per byte).  Bytes per call, f32 messages:
//   shared factor kernel   16*d*m   (read q0, q1; write r0, r1)
//   per-factor kernel      16*d*m + 4*d*d*m   (plus the table stream)
//   q_update               16*d*E   (read be, r, q; write q_new)
// over the card's 3.35 TB/s.  The design reads each input element once
// and writes each output once; nothing is staged beyond the shared
// [d, d] table (shared memory).
//
// Messages are stored as float or bf16 (converted only through
// __bfloat162float / __float2bfloat16_rn).  The factor phase computes in
// the table's type, as the Pallas body does (f = tab_ref.dtype): with an
// f32 table every operation is f32; with a bf16 table the q inputs are
// rounded to bf16 and every add and subtract is rounded to bf16 (an f32
// operation on bf16 values, then one rounding, as PyTorch and XLA compute
// bf16 arithmetic).  The q update is f32 whatever the message type, or,
// on request (per_op), bf16 operation by operation in the same way: the
// JAX package's form for a bf16 belief outside the factor-kernel gate.
// Explicit round-to-nearest intrinsics keep every multiply-add apart (the
// build also passes --fmad=false): results are bit-equal to the plain
// PyTorch versions in maxsum_kernels.py.  The association order is the
// Pallas kernels': S = (T + q0) + q1.  Minima propagate NaN, as
// jnp.minimum and torch.amin do (fminf does not).
//
// Each entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() so the wrapper can raise
// on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 64;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The factor phase's compute type F: rnd<F> rounds an f32 value to F
// (the identity for float).
template <typename F>
__device__ __forceinline__ float rnd(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// NaN-propagating minimum: NaN in either operand wins.
__device__ __forceinline__ float nanmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// One lane's factor phase, computed in F (the table's type).  TAB(a, b)
// yields the table cell; D is the compile-time domain size or 0 for the
// runtime-d instance.
template <int D, typename F, typename T, typename Tab>
__device__ __forceinline__ void factor_lane(
    int d, int64_t ldq, int64_t ldr, int64_t i, const Tab& tab,
    const T* __restrict__ q0, const T* __restrict__ q1,
    T* __restrict__ r0, T* __restrict__ r1) {
  // with D > 0 every trip count below is a compile-time constant, so
  // the loops unroll and the arrays stay in registers
  constexpr int N = D > 0 ? D : kMaxD;
  const int dd = D > 0 ? D : d;
  float a0[N], a1[N], m0[N], m1[N];
  for (int a = 0; a < dd; ++a) {
    a0[a] = rnd<F>(ld(q0 + a * ldq + i));
    a1[a] = rnd<F>(ld(q1 + a * ldq + i));
    m0[a] = CUDART_INF_F;
    m1[a] = CUDART_INF_F;
  }
  for (int a = 0; a < dd; ++a) {
    for (int b = 0; b < dd; ++b) {
      const float s =
          rnd<F>(__fadd_rn(rnd<F>(__fadd_rn(tab(a, b), a0[a])), a1[b]));
      m0[a] = nanmin(m0[a], s);
      m1[b] = nanmin(m1[b], s);
    }
  }
  float mn0 = CUDART_INF_F, mn1 = CUDART_INF_F;
  for (int a = 0; a < dd; ++a) {
    m0[a] = rnd<F>(__fsub_rn(m0[a], a0[a]));
    m1[a] = rnd<F>(__fsub_rn(m1[a], a1[a]));
    mn0 = nanmin(mn0, m0[a]);
    mn1 = nanmin(mn1, m1[a]);
  }
  for (int a = 0; a < dd; ++a) {
    st(r0 + a * ldr + i, rnd<F>(__fsub_rn(m0[a], mn0)));
    st(r1 + a * ldr + i, rnd<F>(__fsub_rn(m1[a], mn1)));
  }
}

struct SharedTab {
  const float* t;  // shared memory, [d, d]
  int d;
  __device__ __forceinline__ float operator()(int a, int b) const {
    return t[a * d + b];
  }
};

template <typename F>
struct StreamedTab {
  const F* __restrict__ t;  // device memory, [d, d, m]
  int d;
  int64_t m;
  int64_t i;
  __device__ __forceinline__ float operator()(int a, int b) const {
    return ld(t + (static_cast<int64_t>(a) * d + b) * m + i);
  }
};

// F: the table's type (float or __nv_bfloat16), also the compute type;
// T: the message type.
template <int D, typename F, typename T>
__global__ void __launch_bounds__(kThreads) factor_shared_kernel(
    const F* __restrict__ tab, const T* __restrict__ q0,
    const T* __restrict__ q1, T* __restrict__ r0, T* __restrict__ r1,
    int d, int64_t m, int64_t ldq, int64_t ldr) {
  __shared__ float s_tab[(D > 0 ? D : kMaxD) * (D > 0 ? D : kMaxD)];
  for (int j = threadIdx.x; j < d * d; j += blockDim.x) s_tab[j] = ld(tab + j);
  __syncthreads();
  const SharedTab t{s_tab, d};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    factor_lane<D, F>(d, ldq, ldr, i, t, q0, q1, r0, r1);
  }
}

template <int D, typename F, typename T>
__global__ void __launch_bounds__(kThreads) factor_kernel(
    const F* __restrict__ tab, const T* __restrict__ q0,
    const T* __restrict__ q1, T* __restrict__ r0, T* __restrict__ r1,
    int d, int64_t m, int64_t ldq, int64_t ldr) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    const StreamedTab<F> t{tab, d, m, i};
    factor_lane<D, F>(d, ldq, ldr, i, t, q0, q1, r0, r1);
  }
}

// F: the compute type.  float is the Pallas body (f32 arithmetic);
// __nv_bfloat16 is the JAX package's XLA form for a bf16 belief outside
// the factor-kernel gate: damp and 1 - damp (taken in f32) and every
// difference, product and sum rounded to bf16.
template <int D, typename F, typename T>
__global__ void __launch_bounds__(kThreads) q_update_kernel(
    const T* __restrict__ be, const T* __restrict__ r,
    const T* __restrict__ q, float damp_f32, T* __restrict__ out, int d,
    int64_t e) {
  const float damp = rnd<F>(damp_f32);
  const float omd = rnd<F>(__fsub_rn(1.0f, damp_f32));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < e; i += stride) {
    if constexpr (D > 0) {  // qn in registers
      float qn[D];
      float mn = CUDART_INF_F;
      for (int a = 0; a < D; ++a) {
        qn[a] = rnd<F>(__fsub_rn(ld(be + a * e + i), ld(r + a * e + i)));
        mn = nanmin(mn, qn[a]);
      }
      for (int a = 0; a < D; ++a) {
        const float x = rnd<F>(__fsub_rn(qn[a], mn));
        st(out + a * e + i,
           rnd<F>(__fadd_rn(rnd<F>(__fmul_rn(damp, ld(q + a * e + i))),
                            rnd<F>(__fmul_rn(omd, x)))));
      }
    } else {  // any d: the min first, then be - r again (same operations)
      float mn = CUDART_INF_F;
      for (int a = 0; a < d; ++a)
        mn = nanmin(mn, rnd<F>(__fsub_rn(ld(be + a * e + i),
                                         ld(r + a * e + i))));
      for (int a = 0; a < d; ++a) {
        const float x = rnd<F>(__fsub_rn(
            rnd<F>(__fsub_rn(ld(be + a * e + i), ld(r + a * e + i))), mn));
        st(out + a * e + i,
           rnd<F>(__fadd_rn(rnd<F>(__fmul_rn(damp, ld(q + a * e + i))),
                            rnd<F>(__fmul_rn(omd, x)))));
      }
    }
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// Dispatch on d: template instances for the small domains, the generic
// one (D = 0) otherwise.  CALL(D) launches one instance.
#define DISPATCH_D(d, CALL)          \
  switch (d) {                       \
    case 2: CALL(2); break;          \
    case 3: CALL(3); break;          \
    case 4: CALL(4); break;          \
    case 5: CALL(5); break;          \
    case 8: CALL(8); break;          \
    default: CALL(0); break;         \
  }

template <typename F, typename T>
void launch_factor(bool shared, const void* tab, const void* q0,
                   const void* q1, void* r0, void* r1, int d, int64_t m,
                   int64_t ldq, int64_t ldr, cudaStream_t s) {
  const int grid = blocks_for(m);
  const F* t = static_cast<const F*>(tab);
  const T* a = static_cast<const T*>(q0);
  const T* b = static_cast<const T*>(q1);
  T* o0 = static_cast<T*>(r0);
  T* o1 = static_cast<T*>(r1);
#define FACTOR_SHARED(D) \
  factor_shared_kernel<D, F, T><<<grid, kThreads, 0, s>>>( \
      t, a, b, o0, o1, d, m, ldq, ldr)
#define FACTOR(D) \
  factor_kernel<D, F, T><<<grid, kThreads, 0, s>>>( \
      t, a, b, o0, o1, d, m, ldq, ldr)
  if (shared) {
    DISPATCH_D(d, FACTOR_SHARED)
  } else {
    DISPATCH_D(d, FACTOR)
  }
#undef FACTOR_SHARED
#undef FACTOR
}

template <typename F, typename T>
void launch_q_update(const void* be, const void* r, const void* q,
                     float damp, void* out, int d, int64_t e,
                     cudaStream_t s) {
  const int grid = blocks_for(e);
#define Q_UPDATE(D) \
  q_update_kernel<D, F, T><<<grid, kThreads, 0, s>>>( \
      static_cast<const T*>(be), static_cast<const T*>(r), \
      static_cast<const T*>(q), damp, static_cast<T*>(out), d, e)
  DISPATCH_D(d, Q_UPDATE)
#undef Q_UPDATE
}

}  // namespace

extern "C" {

// tab: [d, d] (shared) or [d, d, m], contiguous, float (tab_bf16 == 0) or
// __nv_bfloat16 (tab_bf16 == 1); q0, q1: [d, m] row views with row stride
// ldq; r0, r1: [d, m] row views with row stride ldr; messages are float
// (bf16 == 0) or __nv_bfloat16 (bf16 == 1).  1 <= d <= 64,
// 1 <= m <= ldq, ldr.
int pydcop_factor_round_binary(int shared, const void* tab, int tab_bf16,
                               const void* q0, const void* q1, void* r0,
                               void* r1, int d, int64_t m, int64_t ldq,
                               int64_t ldr, int bf16, void* stream) {
  if (d < 1 || d > kMaxD || m < 1 || ldq < m || ldr < m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sh = shared != 0;
  if (tab_bf16 && bf16) {
    launch_factor<__nv_bfloat16, __nv_bfloat16>(sh, tab, q0, q1, r0, r1, d,
                                                m, ldq, ldr, s);
  } else if (tab_bf16) {
    launch_factor<__nv_bfloat16, float>(sh, tab, q0, q1, r0, r1, d, m, ldq,
                                        ldr, s);
  } else if (bf16) {
    launch_factor<float, __nv_bfloat16>(sh, tab, q0, q1, r0, r1, d, m, ldq,
                                        ldr, s);
  } else {
    launch_factor<float, float>(sh, tab, q0, q1, r0, r1, d, m, ldq, ldr, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// be, r, q, out: [d, e] of float or __nv_bfloat16; damp is the f32
// damping factor.  per_op (bf16 only): round every operation to bf16
// instead of computing in f32.  d >= 1, e >= 1.
int pydcop_q_update(const void* be, const void* r, const void* q, float damp,
                    void* out, int d, int64_t e, int bf16, int per_op,
                    void* stream) {
  if (d < 1 || e < 1 || (per_op && !bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_op) {
    launch_q_update<__nv_bfloat16, __nv_bfloat16>(be, r, q, damp, out, d, e,
                                                  s);
  } else if (bf16) {
    launch_q_update<float, __nv_bfloat16>(be, r, q, damp, out, d, e, s);
  } else {
    launch_q_update<float, float>(be, r, q, damp, out, d, e, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
