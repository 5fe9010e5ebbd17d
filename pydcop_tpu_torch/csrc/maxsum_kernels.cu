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
// message arrays in place).  The ragged tail of m is masked; no lane
// padding is copied.
//
// Two designs, chosen by the domain size d:
//
// * d in {2, 3, 4, 5, 8} (factor kernels) and d in {2, 3, 4, 5, 8} or any
//   d (q update): one thread owns one lane i and walks the grid in a
//   grid-stride loop; neighbouring threads read neighbouring i, so every
//   load and store of a row is coalesced.  d is a template parameter, the
//   loops unroll and the per-lane minima live in registers.  The generic
//   q update keeps no array and reads be and r twice, so it takes any d.
//
// * Every other d <= 64 (the Pallas kernels' cap) for the factor kernels:
//   the lane-tile instance (factor_tile_kernel).  A lane's joint has d*d
//   cells, up to 4096, too many for one thread: with the joint's minima
//   in per-lane arrays indexed at run time they lived in local memory
//   (a 1 KB stack frame), one thread walked all d*d cells, and a narrow m
//   left most of the card idle.  Here a block takes a tile of 32 lanes
//   (one warp's width: every load and store along i is coalesced) and
//   splits the rows a of the joint across its W = ceil(d / R) warps, R = 4
//   rows per thread (so a narrow m still puts up to 16 warps per tile on
//   the card; 4 was faster than 8 for both kernels at every d and m
//   measured, and than 16 where that was tried).
//   The tile's q0 and q1 columns [d, 32] (and the shared kernel's [d, d]
//   table, transposed so a thread's R rows of one column b are one
//   16-byte-aligned vector) are staged in shared memory.  Each thread
//   walks b = 0 .. d-1 once, computing its R cells of column b: the row
//   minima for r0 stay in R registers, the column minimum over its rows
//   goes to a per-warp partial [W, d, 32] in shared memory.  A last pass
//   folds the W partials of each column in warp order, subtracts q,
//   min-normalises across warps and stores.  Nothing is indexed at run
//   time, so nothing lives in local memory.  Every cell is computed once.
//   Blocks walk the tiles in a grid-stride loop, at most as many as fit on
//   the card at once (so the shared table is staged once per block).  The
//   per-factor kernel streams its [d, d, m] table once, coalesced along
//   i, 32 cells per thread in flight, kept in the table's type until used
//   (an f32 table in two groups, one loading while the other is folded).  Shared memory is 4 * (2*32*d + 32*W*d + 64*W
//   [+ d*W*R]) bytes, at most 167,936 at d = 64, R = 4: above 48 KB it is
//   opted in (cudaFuncSetAttribute, once per device and size, so no
//   attribute call lands in a captured CUDA graph); a refused launch
//   returns its error.
//
// Bound: bytes per call, f32 messages:
//   shared factor kernel   16*d*m   (read q0, q1; write r0, r1)
//   per-factor kernel      16*d*m + 4*d*d*m   (plus the table stream)
//   q_update               16*d*E   (read be, r, q; write q_new)
// over the card's 3.35 TB/s; operations per factor call (4*d*d + 6*d)*m
// (two adds and two minima per cell) over 67 TFLOP/s, a rate that counts
// a fused multiply-add as two operations.  By these two bounds all three
// kernels are bound by bytes at every d <= 64 (the per-factor table
// stream is 4 bytes per cell against 4 operations; the shared kernel's
// operations overtake its bytes only near d = 80).  But the factor
// kernels issue adds and minima, not multiply-adds, so they can reach
// at most half of the operation rate, and a NaN-propagating minimum is
// two compares and a select: a cell costs about 8 instructions.  So the
// shared kernel is held by instruction issue, not bytes, above d of
// about 18, and at d = 64 it can reach only about 30% of its bound; the
// per-factor kernel stays bound by its table stream.  Each design reads
// each input element once from device memory and writes each output
// once.
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
// jnp.minimum and torch.amin do (fminf does not).  Every minimum is folded
// in ascending order (over b for r0, over a for r1 and for both
// normalisers); the tile instance folds contiguous runs of rows per warp
// and then the runs in warp order, which gives the same result as one
// ascending fold (nanmin keeps the first NaN and the last of equal
// values), so even the sign of a zero matches the unrolled instances.
//
// Each entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() so the wrapper can raise
// on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

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

// -- the lane-tile instance (any d <= 64 without its own template) --------

constexpr int kLanes = 32;  // lanes per tile: one warp's width
constexpr int kRows = 4;    // rows of the joint per thread (R)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// R consecutive floats from 16-byte-aligned shared memory.
template <int R>
__device__ __forceinline__ void load_vec(const float* p, float (&t)[R]) {
  static_assert(R % 4 == 0, "rows per thread must be a multiple of 4");
#pragma unroll
  for (int k = 0; k < R; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    t[k] = v.x;
    t[k + 1] = v.y;
    t[k + 2] = v.z;
    t[k + 3] = v.w;
  }
}

// Where one block's tile lives and what its thread owns.
struct Tile {
  int d, dp, lo, nr, w, lane;  // dp: the transposed table's padded row
  int64_t m, rowstep;          // rowstep: d * m, one table row a
  float* s_tab;  // [d, dp]: s_tab[b * dp + a] = T[a, b] (shared table)
  float* s_q0;   // [d, 32]
  float* s_q1;   // [d, 32]
  float* s_col;  // [W, d, 32]: each warp's column minima
  float* s_mn;   // [2, W, 32]: each warp's run of the two normalisers
};

// The table cells of this thread's R rows in columns b0 .. b0 + C - 1
// (cells past the joint's edge are left unset and never read).  Cells
// streamed from device memory stay in the table's type until they are
// used, so no conversion waits on a load in flight (with bf16 tables a
// conversion next to each load made the per-factor kernel 3x slower);
// each is read once, so it is loaded evict-first (__ldcs), out of the
// message rows' way.
template <int C, int R, bool SHARED, typename F, typename Cell>
__device__ __forceinline__ void load_cols(const Tile& k, const F* tab,
                                          int64_t ic, int b0,
                                          Cell (&t)[C][R]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = b0 + c;
    if constexpr (SHARED) {
      if (b < k.d) load_vec<R>(k.s_tab + b * k.dp + k.lo, t[c]);
    } else {  // T[lo + r, b, i] at ((lo + r) * d + b) * m + i
      const F* const cell = tab + k.lo * k.rowstep + b * k.m + ic;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (b < k.d && r < k.nr) t[c][r] = __ldcs(cell + r * k.rowstep);
    }
  }
}

// This thread's cells of columns b0 .. b0 + C - 1: the row minima in m0,
// each column's minimum over the thread's rows to the warp's partial.
template <int C, int R, typename F, typename Cell>
__device__ __forceinline__ void fold_cols(const Tile& k, int b0,
                                          const Cell (&t)[C][R],
                                          const float (&a0)[R],
                                          float (&m0)[R]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = b0 + c;
    if (b < k.d) {
      const float qb = k.s_q1[b * kLanes + k.lane];
      float cm = CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < k.nr) {
          const float s = rnd<F>(
              __fadd_rn(rnd<F>(__fadd_rn(to_f(t[c][r]), a0[r])), qb));
          m0[r] = nanmin(m0[r], s);
          cm = nanmin(cm, s);
        }
      }
      k.s_col[(k.w * k.d + b) * kLanes + k.lane] = cm;
    }
  }
}

// F: the table's (and compute) type; T: the message type; SHARED: one
// [d, d] table, else [d, d, m].  blockDim.x = 32 * ceil(d / R); dynamic
// shared memory as in the note.
template <typename F, typename T, bool SHARED>
__global__ void __launch_bounds__((kMaxD + kRows - 1) / kRows * kLanes)
    factor_tile_kernel(const F* __restrict__ tab, const T* __restrict__ q0,
                       const T* __restrict__ q1, T* __restrict__ r0,
                       T* __restrict__ r1, int d, int64_t m, int64_t ldq,
                       int64_t ldr) {
  constexpr int R = kRows;
  // Table columns per group.  One from shared memory (more pushes
  // instances past 64 registers, where ptxas spills rather than halve
  // the occupancy).  From device memory 32 cells per thread in flight:
  // an f32 table in two groups of 16, one loaded while the other is
  // folded; a bf16 table in one group of 32 (on the card the two groups
  // were faster with f32 tables at small d and slower with bf16 tables).
  constexpr bool kTwo = !SHARED && std::is_same_v<F, float>;
  constexpr int C = SHARED ? 1 : (kTwo ? 16 : 32) / R;
  using Cell = std::conditional_t<SHARED, float, F>;
  extern __shared__ float4 smem4[];
  const int nw = blockDim.x / kLanes;
  Tile k;
  k.d = d;
  k.dp = nw * R;
  k.w = threadIdx.x / kLanes;
  k.lane = threadIdx.x % kLanes;
  k.lo = k.w * R;                // this warp's first row (and column)
  k.nr = min(R, d - k.lo);       // its rows: 1 .. R
  k.m = m;
  k.rowstep = static_cast<int64_t>(d) * m;
  k.s_tab = reinterpret_cast<float*>(smem4);
  k.s_q0 = k.s_tab + (SHARED ? d * k.dp : 0);
  k.s_q1 = k.s_q0 + d * kLanes;
  k.s_col = k.s_q1 + d * kLanes;
  k.s_mn = k.s_col + nw * d * kLanes;
  if constexpr (SHARED) {
    for (int j = threadIdx.x; j < d * k.dp; j += blockDim.x) {
      const int b = j / k.dp, a = j % k.dp;
      k.s_tab[j] = a < d ? ld(tab + a * d + b) : 0.0f;
    }
  }
  const int64_t tiles = (m + kLanes - 1) / kLanes;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t i0 = tile * kLanes;
    const int64_t i = i0 + k.lane;
    const int64_t ic = i < m ? i : m - 1;  // ragged tail: clamped loads
    Cell ta[C][R], tb[C][R];
    if constexpr (kTwo) load_cols<C, R, SHARED>(k, tab, ic, 0, ta);
    for (int j = threadIdx.x; j < d * kLanes; j += blockDim.x) {
      const int64_t ij = i0 + j % kLanes;
      const int64_t off = (j / kLanes) * ldq + (ij < m ? ij : m - 1);
      k.s_q0[j] = rnd<F>(ld(q0 + off));
      k.s_q1[j] = rnd<F>(ld(q1 + off));
    }
    __syncthreads();

    float a0[R], m0[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a0[r] = r < k.nr ? k.s_q0[(k.lo + r) * kLanes + k.lane] : 0.0f;
      m0[r] = CUDART_INF_F;
    }
    if constexpr (kTwo) {
      for (int b0 = 0; b0 < d; b0 += 2 * C) {
        load_cols<C, R, SHARED>(k, tab, ic, b0 + C, tb);
        fold_cols<C, R, F>(k, b0, ta, a0, m0);
        load_cols<C, R, SHARED>(k, tab, ic, b0 + 2 * C, ta);
        fold_cols<C, R, F>(k, b0 + C, tb, a0, m0);
      }
    } else {
      for (int b0 = 0; b0 < d; b0 += C) {
        load_cols<C, R, SHARED>(k, tab, ic, b0, ta);
        fold_cols<C, R, F>(k, b0, ta, a0, m0);
      }
    }
    // r0 rows: minus own q, and this warp's run of the normaliser
    float mn = CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < k.nr) {
        m0[r] = rnd<F>(__fsub_rn(m0[r], a0[r]));
        mn = nanmin(mn, m0[r]);
      }
    }
    k.s_mn[k.w * kLanes + k.lane] = mn;
    __syncthreads();

    // r1 columns lo .. lo + nr - 1: fold the warps' partials in order
    float m1[R];
    mn = CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m1[r] = 0.0f;
      if (r < k.nr) {
        const int b = k.lo + r;
        float v = CUDART_INF_F;
        for (int u = 0; u < nw; ++u)
          v = nanmin(v, k.s_col[(u * d + b) * kLanes + k.lane]);
        m1[r] = rnd<F>(__fsub_rn(v, k.s_q1[b * kLanes + k.lane]));
        mn = nanmin(mn, m1[r]);
      }
    }
    k.s_mn[(nw + k.w) * kLanes + k.lane] = mn;
    __syncthreads();

    float mn0 = CUDART_INF_F, mn1 = CUDART_INF_F;
    for (int u = 0; u < nw; ++u) {
      mn0 = nanmin(mn0, k.s_mn[u * kLanes + k.lane]);
      mn1 = nanmin(mn1, k.s_mn[(nw + u) * kLanes + k.lane]);
    }
    if (i < m) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < k.nr) {
          st(r0 + (k.lo + r) * ldr + i, rnd<F>(__fsub_rn(m0[r], mn0)));
          st(r1 + (k.lo + r) * ldr + i, rnd<F>(__fsub_rn(m1[r], mn1)));
        }
      }
    }
    // the next tile's staging overwrites only the q columns, last read
    // before the barrier above; its partials and normalisers are written
    // after its first barrier, which every thread reaches after these
    // reads
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

// Dispatch on d: template instances for the small domains, OTHER (a
// statement) otherwise.  CALL(D) launches one instance.
#define DISPATCH_SMALL_D(d, CALL, OTHER) \
  switch (d) {                           \
    case 2: CALL(2); break;              \
    case 3: CALL(3); break;              \
    case 4: CALL(4); break;              \
    case 5: CALL(5); break;              \
    case 8: CALL(8); break;              \
    default: OTHER; break;               \
  }
// ... with the generic instance (D = 0) for every other d
#define DISPATCH_D(d, CALL) DISPATCH_SMALL_D(d, CALL, CALL(0))

bool unrolled_d(int d) {
  return d == 2 || d == 3 || d == 4 || d == 5 || d == 8;
}

// Shared memory of the lane-tile instance, in floats (see the note).
int64_t tile_smem_floats(int d, bool shared) {
  const int nw = (d + kRows - 1) / kRows;
  return (shared ? int64_t{d} * nw * kRows : 0) + 2 * kLanes * d +
         int64_t{kLanes} * nw * d + 2 * kLanes * nw;
}

template <typename F, typename T, bool SHARED>
cudaError_t launch_tile(const F* tab, const T* q0, const T* q1, T* r0,
                        T* r1, int d, int64_t m, int64_t ldq, int64_t ldr,
                        cudaStream_t s) {
  auto* kernel = factor_tile_kernel<F, T, SHARED>;
  const int threads = (d + kRows - 1) / kRows * kLanes;
  const size_t smem = sizeof(float) * tile_smem_floats(d, SHARED);
  // opt in above 48 KB once per device and size, so that a launch
  // captured in a CUDA graph makes no attribute call
  static size_t opted[64] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= 64))
    err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && smem > opted[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) opted[dev] = smem;
  }
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // every block resident at once: the shared table is staged per block
  const int64_t tiles = (m + kLanes - 1) / kLanes;
  const int64_t cap = static_cast<int64_t>(per_sm) * sms;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  kernel<<<grid, threads, smem, s>>>(tab, q0, q1, r0, r1, d, m, ldq, ldr);
  return cudaGetLastError();
}

template <typename F, typename T>
cudaError_t launch_factor(bool shared, const void* tab, const void* q0,
                          const void* q1, void* r0, void* r1, int d,
                          int64_t m, int64_t ldq, int64_t ldr,
                          cudaStream_t s) {
  const F* t = static_cast<const F*>(tab);
  const T* a = static_cast<const T*>(q0);
  const T* b = static_cast<const T*>(q1);
  T* o0 = static_cast<T*>(r0);
  T* o1 = static_cast<T*>(r1);
  if (!unrolled_d(d)) {
    return shared ? launch_tile<F, T, true>(t, a, b, o0, o1, d, m, ldq, ldr, s)
                  : launch_tile<F, T, false>(t, a, b, o0, o1, d, m, ldq, ldr,
                                             s);
  }
  const int grid = blocks_for(m);
#define FACTOR_SHARED(D) \
  factor_shared_kernel<D, F, T><<<grid, kThreads, 0, s>>>( \
      t, a, b, o0, o1, d, m, ldq, ldr)
#define FACTOR(D) \
  factor_kernel<D, F, T><<<grid, kThreads, 0, s>>>( \
      t, a, b, o0, o1, d, m, ldq, ldr)
  if (shared) {
    DISPATCH_SMALL_D(d, FACTOR_SHARED, )
  } else {
    DISPATCH_SMALL_D(d, FACTOR, )
  }
#undef FACTOR_SHARED
#undef FACTOR
  return cudaGetLastError();
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
  cudaError_t err;
  if (tab_bf16 && bf16) {
    err = launch_factor<__nv_bfloat16, __nv_bfloat16>(
        sh, tab, q0, q1, r0, r1, d, m, ldq, ldr, s);
  } else if (tab_bf16) {
    err = launch_factor<__nv_bfloat16, float>(sh, tab, q0, q1, r0, r1, d, m,
                                              ldq, ldr, s);
  } else if (bf16) {
    err = launch_factor<float, __nv_bfloat16>(sh, tab, q0, q1, r0, r1, d, m,
                                              ldq, ldr, s);
  } else {
    err = launch_factor<float, float>(sh, tab, q0, q1, r0, r1, d, m, ldq,
                                      ldr, s);
  }
  return static_cast<int>(err);
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
