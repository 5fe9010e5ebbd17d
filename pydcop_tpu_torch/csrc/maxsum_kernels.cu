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
// padding is copied.  The q update reads the belief [d, n] itself through
// the edges' variable index (be[a, i] = belief[a, edge_var[i]], the
// broadcast-back gather), so no [d, E] copy of it is written and read
// back; the belief, 12 MB at a million variables with d = 3, stays in the
// 50 MB L2 cache while the kernel runs.
//
// Designs, chosen by the domain size d:
//
// * d in {2, 3, 4, 5, 8}: one thread owns one lane i and walks the grid
//   in a grid-stride loop; neighbouring threads read neighbouring i, so
//   every load and store of a row is coalesced (the belief reads of the
//   q update follow edge_var).  d is a template parameter, the loops
//   unroll and the per-lane values live in registers.
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
// * Every other d for the q update (no cap at 64): the same lane-tile
//   idea (q_update_tile_kernel).  A block takes a tile of L lanes and
//   splits the rows across G row groups; each thread computes be - r for
//   its rows once and keeps it on chip until the output: for d <= 128 in
//   4 registers per thread (G = ceil(d / 4) groups of L = 32 lanes), past
//   128 in an [d, L] array in shared memory (32 groups of ceil(d / 32)
//   rows, the widest L of 32 .. 1 that fits, opted in above 48 KB as the
//   factor tile is).
//   The per-group minima fold in group order after one barrier.  So every
//   input element is read once from device memory (the instance it
//   replaces walked the rows twice, the second time through L2, one
//   serial chain of loads per lane).
//
// Bound: bytes per call, f32 messages:
//   shared factor kernel   16*d*m   (read q0, q1; write r0, r1)
//   per-factor kernel      16*d*m + 4*d*d*m   (plus the table stream)
//   q_update               12*d*E + 4*E + 4*d*n   (read r, q and the
//                          i32 edge index; write q_new; read the
//                          belief [d, n] once: 16*d*E with the
//                          identity index, be itself [d, E])
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
// The batch axis (several restarts and instances in one launch).  Each
// entry point takes B batches of the same shapes, B = I * R (instances
// times restarts), in ONE launch: batch b reads its q and r (and the q
// update's belief and output) at b times their batch strides, and the
// operands that belong to an instance (the factor tables, the q update's
// edge index and damping) at (b / R) times theirs, a stride of 0 meaning
// one operand shared by every batch.  The unrolled instances take the
// batch on gridDim.y (each block walks batches b = blockIdx.y, + gridDim.y,
// ... and lanes in a grid-stride loop along x); the lane-tile instances
// walk the flattened (batch, tile) range in their grid-stride loop, so the
// resident grid is sized as before, now over B times the tiles.  A block
// of the shared-table kernels stages a batch's table when it differs from
// the one it holds.  Per lane, batch b computes exactly what an unbatched
// launch on batch b's operands computes, in the same order: B = 1 with
// every stride 0 is the unbatched call.
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

// Batch strides of a factor launch (see the note): batch b reads its table
// at (b / per) * tab, its q rows at b * q and writes its r rows at b * r.
struct FactorBatch {
  int n, per;
  int64_t tab, q, r;
};

// Batch strides of a q-update launch: the belief at b * belief, the edge
// index at (b / per) * idx, r, q and the output at b * msg; damping
// damp[b / per] when damp is set, else the launch's scalar.
struct QBatch {
  int n, per;
  int64_t belief, idx, msg;
  const float* damp;
};

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
    int d, int64_t m, int64_t ldq, int64_t ldr, FactorBatch bt) {
  __shared__ float s_tab[(D > 0 ? D : kMaxD) * (D > 0 ? D : kMaxD)];
  const SharedTab t{s_tab, d};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t staged = -1;  // the table offset s_tab holds
  for (int b = blockIdx.y; b < bt.n; b += gridDim.y) {
    const int64_t toff = (b / bt.per) * bt.tab;
    if (toff != staged) {  // uniform over the block
      __syncthreads();     // the previous table's last reads
      for (int j = threadIdx.x; j < d * d; j += blockDim.x)
        s_tab[j] = ld(tab + toff + j);
      __syncthreads();
      staged = toff;
    }
    const int64_t qo = b * bt.q, ro = b * bt.r;
    for (int64_t i =
             static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < m; i += stride) {
      factor_lane<D, F>(d, ldq, ldr, i, t, q0 + qo, q1 + qo, r0 + ro,
                        r1 + ro);
    }
  }
}

template <int D, typename F, typename T>
__global__ void __launch_bounds__(kThreads) factor_kernel(
    const F* __restrict__ tab, const T* __restrict__ q0,
    const T* __restrict__ q1, T* __restrict__ r0, T* __restrict__ r1,
    int d, int64_t m, int64_t ldq, int64_t ldr, FactorBatch bt) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int b = blockIdx.y; b < bt.n; b += gridDim.y) {
    const F* const tb = tab + (b / bt.per) * bt.tab;
    const int64_t qo = b * bt.q, ro = b * bt.r;
    for (int64_t i =
             static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < m; i += stride) {
      const StreamedTab<F> t{tb, d, m, i};
      factor_lane<D, F>(d, ldq, ldr, i, t, q0 + qo, q1 + qo, r0 + ro,
                        r1 + ro);
    }
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
    factor_tile_kernel(const F* __restrict__ tab_all,
                       const T* __restrict__ q0_all,
                       const T* __restrict__ q1_all, T* __restrict__ r0_all,
                       T* __restrict__ r1_all, int d, int64_t m, int64_t ldq,
                       int64_t ldr, FactorBatch bt) {
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
  const int64_t tiles = (m + kLanes - 1) / kLanes;
  int64_t staged = -1;  // the table offset s_tab holds
  for (int64_t bt_tile = blockIdx.x; bt_tile < tiles * bt.n;
       bt_tile += gridDim.x) {
    // batch bb's tile: its operands at their batch offsets
    const int64_t bb = bt_tile / tiles, tile = bt_tile - bb * tiles;
    const int64_t toff = (bb / bt.per) * bt.tab;
    const F* const tab = tab_all + toff;
    const T* const q0 = q0_all + bb * bt.q;
    const T* const q1 = q1_all + bb * bt.q;
    T* const r0 = r0_all + bb * bt.r;
    T* const r1 = r1_all + bb * bt.r;
    if constexpr (SHARED) {
      // every thread passed the previous tile's last barrier, after its
      // last table read; the barrier after the q staging below publishes
      // the new table
      if (toff != staged) {
        for (int j = threadIdx.x; j < d * k.dp; j += blockDim.x) {
          const int b = j / k.dp, a = j % k.dp;
          k.s_tab[j] = a < d ? ld(tab + a * d + b) : 0.0f;
        }
        staged = toff;
      }
    }
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

// -- the q update ---------------------------------------------------------

// r, q, the edge index and the output are touched once: the register
// instances load and store them evict-first (__ldcs / __stcs), so they
// do not push the belief, read at random columns, out of L2.  (The staged
// instance measured slower with them, at d = 300: it loads and stores
// plainly.)
__device__ __forceinline__ float ld_once(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_once(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcs(p));
}
__device__ __forceinline__ void st_once(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_once(__nv_bfloat16* p, float v) {
  __stcs(p, __float2bfloat16_rn(v));
}

// be[a, i]: a belief cell rounded to the message type T (B: the belief's
// type, T or float), as belief.to(T) rounds it before the gather.
template <typename T, typename B>
__device__ __forceinline__ float ld_belief(const B* p) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && std::is_same_v<B, float>)
    return rnd<__nv_bfloat16>(*p);
  else
    return ld(p);
}

// Lane i's column of the belief: edge_idx[i], or i without an index.
__device__ __forceinline__ int64_t belief_col(const int32_t* idx, int64_t i) {
  return idx ? __ldcs(idx + i) : i;
}

// One output cell: damp * q + (1 - damp) * (qn - mn), each operation in F.
template <typename F>
__device__ __forceinline__ float damped(float damp, float omd, float qv,
                                        float qn, float mn) {
  const float x = rnd<F>(__fsub_rn(qn, mn));
  return rnd<F>(__fadd_rn(rnd<F>(__fmul_rn(damp, qv)),
                          rnd<F>(__fmul_rn(omd, x))));
}

// F: the compute type.  float is the Pallas body (f32 arithmetic);
// __nv_bfloat16 is the JAX package's XLA form for a bf16 belief outside
// the factor-kernel gate: damp and 1 - damp (taken in f32) and every
// difference, product and sum rounded to bf16.  T: the message type;
// B: the belief's.  belief is [d, n] with row stride ldb; idx[i] is lane
// i's column in it (the broadcast-back gather), or null for column i.
template <int D, typename F, typename T, typename B>
__global__ void __launch_bounds__(kThreads) q_update_kernel(
    const B* __restrict__ belief_all, int64_t ldb,
    const int32_t* __restrict__ idx_all, const T* __restrict__ r_all,
    const T* __restrict__ q_all, float damp_f32, T* __restrict__ out_all,
    int64_t e, QBatch bt) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int bb = blockIdx.y; bb < bt.n; bb += gridDim.y) {
    const float dmp = bt.damp ? bt.damp[bb / bt.per] : damp_f32;
    const float damp = rnd<F>(dmp);
    const float omd = rnd<F>(__fsub_rn(1.0f, dmp));
    const B* const belief = belief_all + bb * bt.belief;
    const int32_t* const idx =
        idx_all ? idx_all + (bb / bt.per) * bt.idx : nullptr;
    const T* const r = r_all + bb * bt.msg;
    const T* const q = q_all + bb * bt.msg;
    T* const out = out_all + bb * bt.msg;
    for (int64_t i =
             static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < e; i += stride) {
      const int64_t col = belief_col(idx, i);
      float qn[D], qv[D];
      float mn = CUDART_INF_F;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        qn[a] = rnd<F>(__fsub_rn(ld_belief<T>(belief + a * ldb + col),
                                 ld_once(r + a * e + i)));
        qv[a] = ld_once(q + a * e + i);
        mn = nanmin(mn, qn[a]);
      }
#pragma unroll
      for (int a = 0; a < D; ++a)
        st_once(out + a * e + i, damped<F>(damp, omd, qv[a], qn[a], mn));
    }
  }
}

// -- the generic q update (any d without its own template) ------------------

constexpr int kQRows = 4;     // rows per thread held in registers (R)
constexpr int kQGroups = 32;  // row groups of a block at most
constexpr int kQRegD = kQRows * kQGroups;  // 128: the largest d in registers

// Thread t owns lane t % L of the block's tile of L lanes and the rows
// lo .. lo + nr - 1 of row group t / L (G groups: contiguous runs of
// `rows` rows, the last ones shorter or empty).  It computes qn = be - r
// for its rows once, keeps it on chip (R registers, or with STAGED its
// cells of an [d, L] array in shared memory), folds their minimum in
// ascending order, and leaves it in the group's partial; after one
// barrier every thread folds the G partials in group order (so the
// minimum is the ascending fold's, NaN and signed zero included) and
// writes its rows.  The partials alternate between two buffers from tile
// to tile, so one barrier per tile suffices.  Blocks walk the tiles in a
// grid-stride loop.
template <typename F, typename T, typename B, bool STAGED>
__global__ void __launch_bounds__(1024) q_update_tile_kernel(
    const B* __restrict__ belief_all, int64_t ldb,
    const int32_t* __restrict__ idx_all, const T* __restrict__ r_all,
    const T* __restrict__ q_all, float damp_f32, T* __restrict__ out_all,
    int d, int64_t e, int lanes, int rows, QBatch bt) {
  extern __shared__ float smem[];
  const int L = lanes;
  const int G = blockDim.x / L;
  const int lane = threadIdx.x % L;
  const int lo = (threadIdx.x / L) * rows;
  const int nr = max(0, min(rows, d - lo));
  float* const s_qn = smem + 2 * G * L;  // [d, L] after the partials [2, G, L]
  const int64_t tiles = (e + L - 1) / L;
  int buf = 0;
  for (int64_t bt_tile = blockIdx.x; bt_tile < tiles * bt.n;
       bt_tile += gridDim.x) {
    // batch bb's tile: its operands at their batch offsets
    const int64_t bb = bt_tile / tiles, tile = bt_tile - bb * tiles;
    const float dmp = bt.damp ? bt.damp[bb / bt.per] : damp_f32;
    const float damp = rnd<F>(dmp);
    const float omd = rnd<F>(__fsub_rn(1.0f, dmp));
    const B* const belief = belief_all + bb * bt.belief;
    const int32_t* const idx =
        idx_all ? idx_all + (bb / bt.per) * bt.idx : nullptr;
    const T* const r = r_all + bb * bt.msg;
    const T* const q = q_all + bb * bt.msg;
    T* const out = out_all + bb * bt.msg;
    const int64_t i = tile * L + lane;
    const int64_t ic = i < e ? i : e - 1;  // ragged tail: clamped loads
    const int64_t col = belief_col(idx, ic);
    float* const part = smem + buf * G * L;
    buf ^= 1;
    float mn = CUDART_INF_F;
    if constexpr (!STAGED) {
      constexpr int R = kQRows;
      float qn[R], qv[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        qn[k] = qv[k] = 0.0f;
        if (k < nr) {
          const int64_t a = lo + k;
          qn[k] = rnd<F>(__fsub_rn(ld_belief<T>(belief + a * ldb + col),
                                   ld_once(r + a * e + ic)));
          qv[k] = ld_once(q + a * e + ic);
          mn = nanmin(mn, qn[k]);
        }
      }
      part[threadIdx.x] = mn;
      __syncthreads();
      mn = CUDART_INF_F;
      for (int u = 0; u < G; ++u) mn = nanmin(mn, part[u * L + lane]);
      if (i < e) {
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (k < nr)
            st_once(out + (lo + k) * e + i,
                    damped<F>(damp, omd, qv[k], qn[k], mn));
      }
    } else {
      for (int k = 0; k < nr; ++k) {
        const int64_t a = lo + k;
        const float v = rnd<F>(__fsub_rn(ld_belief<T>(belief + a * ldb + col),
                                         ld(r + a * e + ic)));
        s_qn[(lo + k) * L + lane] = v;  // read back by this thread only
        mn = nanmin(mn, v);
      }
      part[threadIdx.x] = mn;
      __syncthreads();
      mn = CUDART_INF_F;
      for (int u = 0; u < G; ++u) mn = nanmin(mn, part[u * L + lane]);
      if (i < e) {
        for (int k = 0; k < nr; ++k) {
          const int64_t a = lo + k;
          st(out + a * e + i, damped<F>(damp, omd, ld(q + a * e + i),
                                        s_qn[(lo + k) * L + lane], mn));
        }
      }
    }
  }
}

// The unrolled instances' grid: batches on y (at most kMaxBlocks of
// them), lanes on x, at most kMaxBlocks blocks in all; B = 1 gives the
// unbatched grid.
dim3 blocks_for(int64_t n, int batch) {
  const int gy = batch < kMaxBlocks ? batch : kMaxBlocks;
  const int64_t cap = kMaxBlocks / gy > 1 ? kMaxBlocks / gy : 1;
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return dim3(static_cast<unsigned>(b < cap ? b : cap),
              static_cast<unsigned>(gy));
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

bool unrolled_d(int d) {
  return d == 2 || d == 3 || d == 4 || d == 5 || d == 8;
}

// The grid that keeps every block of `kernel` resident at once, at most
// `tiles` blocks.  Above 48 KB of dynamic shared memory the kernel is
// opted in first, once per device and size (`opted`: one per kernel), so
// that a launch captured in a CUDA graph makes no attribute call.
template <typename Kernel>
cudaError_t resident_grid(Kernel* kernel, int threads, size_t smem,
                          int64_t tiles, size_t (&opted)[64], int* grid) {
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
  const int64_t cap = static_cast<int64_t>(per_sm) * sms;
  *grid = static_cast<int>(tiles < cap ? tiles : cap);
  return cudaSuccess;
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
                        const FactorBatch& bt, cudaStream_t s) {
  auto* kernel = factor_tile_kernel<F, T, SHARED>;
  const int threads = (d + kRows - 1) / kRows * kLanes;
  const size_t smem = sizeof(float) * tile_smem_floats(d, SHARED);
  static size_t opted[64] = {};
  // every block resident at once: the shared table is staged per block
  int grid = 0;
  const cudaError_t err = resident_grid(
      kernel, threads, smem, (m + kLanes - 1) / kLanes * bt.n, opted, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(tab, q0, q1, r0, r1, d, m, ldq, ldr,
                                     bt);
  return cudaGetLastError();
}

template <typename F, typename T>
cudaError_t launch_factor(bool shared, const void* tab, const void* q0,
                          const void* q1, void* r0, void* r1, int d,
                          int64_t m, int64_t ldq, int64_t ldr,
                          const FactorBatch& bt, cudaStream_t s) {
  const F* t = static_cast<const F*>(tab);
  const T* a = static_cast<const T*>(q0);
  const T* b = static_cast<const T*>(q1);
  T* o0 = static_cast<T*>(r0);
  T* o1 = static_cast<T*>(r1);
  if (!unrolled_d(d)) {
    return shared ? launch_tile<F, T, true>(t, a, b, o0, o1, d, m, ldq, ldr,
                                            bt, s)
                  : launch_tile<F, T, false>(t, a, b, o0, o1, d, m, ldq, ldr,
                                             bt, s);
  }
  const dim3 grid = blocks_for(m, bt.n);
#define FACTOR_SHARED(D) \
  factor_shared_kernel<D, F, T><<<grid, kThreads, 0, s>>>( \
      t, a, b, o0, o1, d, m, ldq, ldr, bt)
#define FACTOR(D) \
  factor_kernel<D, F, T><<<grid, kThreads, 0, s>>>( \
      t, a, b, o0, o1, d, m, ldq, ldr, bt)
  if (shared) {
    DISPATCH_SMALL_D(d, FACTOR_SHARED, )
  } else {
    DISPATCH_SMALL_D(d, FACTOR, )
  }
#undef FACTOR_SHARED
#undef FACTOR
  return cudaGetLastError();
}

// The generic q update's block: G row groups of L lanes (see the note).
// In registers (d <= 128): G = ceil(d / 4) groups of 32 lanes (fuller
// blocks for a small d, up to 256 threads, were no faster at d = 10).
// STAGED (d > 128): 32 groups of ceil(d / 32) rows, and the widest L of
// 32, 16, .., 1 whose [d, L] array and partials fit the device's shared
// memory (d up to 58,080 at L = 1 on an H100).
template <typename F, typename T, typename B, bool STAGED>
cudaError_t launch_q_tile(const B* belief, int64_t ldb, const int32_t* idx,
                          const T* r, const T* q, float damp, T* out, int d,
                          int64_t e, const QBatch& bt, cudaStream_t s) {
  auto* kernel = q_update_tile_kernel<F, T, B, STAGED>;
  static size_t opted[64] = {};
  int groups = (d + kQRows - 1) / kQRows, rows = kQRows;
  int lanes = kLanes;
  auto smem_of = [&](int l) {
    return sizeof(float) * (2 * int64_t{groups} + (STAGED ? d : 0)) * l;
  };
  if constexpr (STAGED) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    groups = kQGroups;
    rows = (d + groups - 1) / groups;
    while (lanes > 1 && smem_of(lanes) > static_cast<size_t>(optin))
      lanes /= 2;
    if (smem_of(lanes) > static_cast<size_t>(optin))
      return cudaErrorInvalidValue;
  }
  const int threads = groups * lanes;
  const size_t smem = smem_of(lanes);
  int grid = 0;
  const cudaError_t err = resident_grid(
      kernel, threads, smem, (e + lanes - 1) / lanes * bt.n, opted, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(belief, ldb, idx, r, q, damp, out, d, e,
                                     lanes, rows, bt);
  return cudaGetLastError();
}

template <typename F, typename T, typename B>
cudaError_t launch_q_update(const void* belief, int64_t ldb,
                            const int32_t* idx, const void* r, const void* q,
                            float damp, void* out, int d, int64_t e,
                            const QBatch& bt, cudaStream_t s) {
  const B* b = static_cast<const B*>(belief);
  const T* rr = static_cast<const T*>(r);
  const T* qq = static_cast<const T*>(q);
  T* o = static_cast<T*>(out);
  if (!unrolled_d(d)) {
    return d <= kQRegD
               ? launch_q_tile<F, T, B, false>(b, ldb, idx, rr, qq, damp, o,
                                               d, e, bt, s)
               : launch_q_tile<F, T, B, true>(b, ldb, idx, rr, qq, damp, o, d,
                                              e, bt, s);
  }
  const dim3 grid = blocks_for(e, bt.n);
#define Q_UPDATE(D) \
  q_update_kernel<D, F, T, B><<<grid, kThreads, 0, s>>>( \
      b, ldb, idx, rr, qq, damp, o, e, bt)
  DISPATCH_SMALL_D(d, Q_UPDATE, )
#undef Q_UPDATE
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tab: [d, d] (shared) or [d, d, m], contiguous, float (tab_bf16 == 0) or
// __nv_bfloat16 (tab_bf16 == 1); q0, q1: [d, m] row views with row stride
// ldq; r0, r1: [d, m] row views with row stride ldr; messages are float
// (bf16 == 0) or __nv_bfloat16 (bf16 == 1).  1 <= d <= 64,
// 1 <= m <= ldq, ldr.  batch >= 1 batches (see the note): batch b's table
// at (b / per) * tab_bstride elements, its q rows at b * q_bstride, its r
// rows at b * r_bstride; batch 1 with every stride 0 is one unbatched call.
int pydcop_factor_round_binary(int shared, const void* tab, int tab_bf16,
                               const void* q0, const void* q1, void* r0,
                               void* r1, int d, int64_t m, int64_t ldq,
                               int64_t ldr, int bf16, int batch, int per,
                               int64_t tab_bstride, int64_t q_bstride,
                               int64_t r_bstride, void* stream) {
  if (d < 1 || d > kMaxD || m < 1 || ldq < m || ldr < m || batch < 1 ||
      per < 1 || tab_bstride < 0 || q_bstride < 0 || r_bstride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sh = shared != 0;
  const FactorBatch bt{batch, per, tab_bstride, q_bstride, r_bstride};
  cudaError_t err;
  if (tab_bf16 && bf16) {
    err = launch_factor<__nv_bfloat16, __nv_bfloat16>(
        sh, tab, q0, q1, r0, r1, d, m, ldq, ldr, bt, s);
  } else if (tab_bf16) {
    err = launch_factor<__nv_bfloat16, float>(sh, tab, q0, q1, r0, r1, d, m,
                                              ldq, ldr, bt, s);
  } else if (bf16) {
    err = launch_factor<float, __nv_bfloat16>(sh, tab, q0, q1, r0, r1, d, m,
                                              ldq, ldr, bt, s);
  } else {
    err = launch_factor<float, float>(sh, tab, q0, q1, r0, r1, d, m, ldq,
                                      ldr, bt, s);
  }
  return static_cast<int>(err);
}

// belief: [d, n] contiguous, float (belief_bf16 == 0) or __nv_bfloat16
// (belief_bf16 == 1, only with bf16 messages); edge_idx: int32[e], each
// entry in [0, n), or null for the identity (n == e); r, q, out: [d, e]
// contiguous, float (bf16 == 0) or __nv_bfloat16 (bf16 == 1); damp is the
// f32 damping factor.  be[a, i] = belief[a, edge_idx[i]], rounded to the
// message type.  per_op (bf16 belief and messages only): round every
// operation to bf16 instead of computing in f32.  d >= 1, e >= 1, n >= 1.
// batch >= 1 batches (see the note): batch b's belief at
// b * belief_bstride elements, its edge index at (b / per) * idx_bstride,
// its r, q and output at b * msg_bstride, its damping damp_arr[b / per]
// (f32 on the device) or, with damp_arr null, damp.
int pydcop_q_update(const void* belief, const int32_t* edge_idx,
                    const void* r, const void* q, float damp,
                    const float* damp_arr, void* out, int d, int64_t e,
                    int64_t n, int belief_bf16, int bf16, int per_op,
                    int batch, int per, int64_t belief_bstride,
                    int64_t idx_bstride, int64_t msg_bstride, void* stream) {
  if (d < 1 || e < 1 || n < 1 || (!edge_idx && n != e) ||
      (per_op && !belief_bf16) || (belief_bf16 && !bf16) || batch < 1 ||
      per < 1 || belief_bstride < 0 || idx_bstride < 0 || msg_bstride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const QBatch bt{batch, per, belief_bstride, idx_bstride, msg_bstride,
                  damp_arr};
  cudaError_t err;
  if (per_op) {
    err = launch_q_update<bf, bf, bf>(belief, n, edge_idx, r, q, damp, out,
                                      d, e, bt, s);
  } else if (belief_bf16) {
    err = launch_q_update<float, bf, bf>(belief, n, edge_idx, r, q, damp, out,
                                         d, e, bt, s);
  } else if (bf16) {
    err = launch_q_update<float, bf, float>(belief, n, edge_idx, r, q, damp,
                                            out, d, e, bt, s);
  } else {
    err = launch_q_update<float, float, float>(belief, n, edge_idx, r, q,
                                               damp, out, d, e, bt, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
