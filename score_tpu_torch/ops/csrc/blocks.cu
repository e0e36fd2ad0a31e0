// Batched small-block Cholesky and triangular substitutions in f32.
//
// Hand-written Hopper (sm_90a) port of the two Pallas TPU kernels in
// score_tpu/ops/pallas_blocks.py. See score_tpu_torch/ops/blocks.py for the
// plain PyTorch twin of each kernel and the Python wrappers that launch
// these entry points. Callers: the f32 band (cyclic reduction,
// score_tpu_torch/solver/pcr.py) at D = 6 (2D poses) and D = 12 (3D poses)
// and the QCQP range elimination's pivot inverses at D = 2 and D = 3,
// through score_tpu_torch/solver/smallblocks.py.
//
// Layouts (row-major, f32; L, Y, X contiguous; A read through its block
// stride, B through its three strides):
//   A, L : (M, D, D)     B, Y, X : (M, D, K)
// The TPU kernels put the batch on the 128 lanes, (D, D, M), so that every
// step of the unrolled recurrence is one full-width vector op. On the card
// a thread (D = 2, 3, 6) or a lane group of 16, a lane a row (D = 12's
// Cholesky and narrow solves), takes the batch index instead, and the
// blocks keep the port's (M, D, D) layout. A solve takes one or two
// right-hand sides against the same factor in one launch.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns the cudaError_t of the launch (0 = ok).
// Kernels are templated on the block size D; D = 2, 3, 6 and 12 are
// instantiated.

#include <cuda_runtime.h>

namespace {

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out);
template <>
__device__ __forceinline__ void load_vec<1>(const float* p, float* out) {
  out[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float* out) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  out[0] = t.x;
  out[1] = t.y;
}
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float* out) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v);
template <>
__device__ __forceinline__ void store_vec<1>(float* p, const float* v) {
  p[0] = v[0];
}
template <>
__device__ __forceinline__ void store_vec<2>(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <>
__device__ __forceinline__ void store_vec<4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The unit in which blocks of D x D floats move between device memory and
// shared memory: 16 bytes where D * D is a multiple of 4 (D = 2, 6, 12),
// so that a unit stays inside one block; a float otherwise (D = 3: the
// 3 x 3 QCQP pivots, 9 floats a block, a batch aligned only to 4 bytes).
template <int D>
struct Unit {
  static constexpr int kFloats = D * D % 4 == 0 ? 4 : 1;
  static constexpr int kPerBlock = D * D / kFloats;
};

// Stages n blocks of D x D floats, block b at src + b * sbm (each block
// contiguous; for 16-byte units sbm a multiple of 4 floats and src 16-byte
// aligned), into shared memory at a padded stride of D * D + 1 floats, so
// that lanes working on different blocks read distinct banks. The unit
// q = tid + u * nthreads goes to thread tid: neighbouring threads load
// neighbouring units. A thread's U units are all in flight before its
// first store. U must cover the units: n * Unit<D>::kPerBlock <=
// U * nthreads.
template <int D, int U>
__device__ __forceinline__ void stage_blocks(const float* __restrict__ src,
                                             long long sbm, int n, float* dst,
                                             int tid, int nthreads) {
  constexpr int W = Unit<D>::kFloats;
  constexpr int Q = Unit<D>::kPerBlock;
  constexpr int LS = D * D + 1;
  float v[U][W];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = tid + u * nthreads;
    if (q < n * Q) load_vec<W>(src + (q / Q) * sbm + W * (q % Q), v[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = tid + u * nthreads;
    if (q < n * Q) {
      float* d = dst + (q / Q) * LS + W * (q % Q);
#pragma unroll
      for (int w = 0; w < W; ++w) d[w] = v[u][w];
    }
  }
}

// stage_blocks' work by cp.async (16-byte units only): each unit goes from
// device memory to shared memory without passing through registers, at a
// padded stride LS that keeps every unit 16-byte aligned; the thread waits
// for its own copies (a barrier must follow before other threads read).
template <int D, int U, int LS>
__device__ __forceinline__ void stage_blocks_async(const float* __restrict__ src,
                                                   long long sbm, int n, float* dst,
                                                   int tid, int nthreads) {
  static_assert(Unit<D>::kFloats == 4 && LS % 4 == 0, "16-byte units");
  constexpr int Q = Unit<D>::kPerBlock;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = tid + u * nthreads;
    if (q < n * Q) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(dst + (q / Q) * LS + 4 * (q % Q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s), "l"(src + (q / Q) * sbm + 4 * (q % Q)));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Replaces _chol_kernel (pallas_blocks.py:36) at D = 2, 3 and 6. A thread
// owns one block: the
// thread block's blocks are staged by stage_blocks (16-byte loads on
// neighbouring addresses, float loads at D = 3, in flight together, A read
// through its block stride so that the f32 band's odd-row view costs no
// copy), a thread reads
// its block from shared memory, forms the lower triangle in registers in
// the plain twin's left-looking column order (column j = (A[:, j] -
// sum_{k<j} L[:, k] L[j, k]), k ascending) and, as the TPU kernel does,
// multiplies by one rsqrt of the pivot per column where the twin divides by
// its square root (one more rounding, inside the 1e-5 the f32 path is held
// to; no IEEE division or square root on the chain). L goes back through the
// same shared-memory slot, strictly-upper triangle zero, and leaves as
// coalesced stores in the staging's units. A non-positive pivot gives NaN,
// as in the twin.
// Bound: at the f32 path's sizes (M = 1..2363 blocks, at most 0.6 MB read
// and written at D = 12) the traffic takes well under a microsecond at an
// H100 SXM's 3.35 TB/s (data sheet, 700 W), so a launch's latency sets the
// time: one round trip to memory, a barrier, D rsqrt and the column chain,
// the stores. Thread blocks of 32 threads spread M = 1024 over 32 SMs.
constexpr int kCholThreads = 32;

template <int D>
__global__ void __launch_bounds__(kCholThreads)
chol_kernel(const float* __restrict__ A, float* __restrict__ L, int M,
            long long sam) {
  constexpr int DD = D * D;
  constexpr int W = Unit<D>::kFloats;
  constexpr int Q = Unit<D>::kPerBlock;
  constexpr int LS = DD + 1;
  __shared__ float sA[kCholThreads * LS];
  const int m0 = blockIdx.x * kCholThreads;
  const int n = min(kCholThreads, M - m0);
  const int tid = threadIdx.x;
  stage_blocks<D, Q>(A + (size_t)m0 * sam, sam, n, sA, tid, kCholThreads);
  __syncthreads();
  float* s = sA + tid * LS;
  if (tid < n) {
    float Lr[D][D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = s[j * D + j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc = acc - Lr[j][k] * Lr[j][k];
      const float piv = rsqrtf(acc);
      Lr[j][j] = acc * piv;
#pragma unroll
      for (int i = j + 1; i < D; ++i) {
        float v = s[i * D + j];
#pragma unroll
        for (int k = 0; k < j; ++k) v = v - Lr[i][k] * Lr[j][k];
        Lr[i][j] = v * piv;
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) s[i * D + j] = (j <= i) ? Lr[i][j] : 0.0f;
    }
  }
  __syncthreads();
  float* out = L + (size_t)m0 * DD;
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int q = tid + u * kCholThreads;
    if (q < n * Q) store_vec<W>(out + W * q, sA + (q / Q) * LS + W * (q % Q));
  }
}

// A lane group of kGroupLanes lanes owns one block at D = 12, lane i its row
// i (lanes 12-15 idle); two groups a warp.
constexpr int kGroupLanes = 16;
constexpr unsigned kFullMask = 0xffffffffu;

// Replaces _chol_kernel at D = 12 (the 3D band's 12 x 12 blocks). A lane
// group owns a block and lane i its row i: the lane loads its row's three
// 16-byte units (the group's 36 together, A read through its block stride,
// so the f32 band's odd-row view costs no copy) and keeps the row in
// registers, where column j's entry becomes L[i][j] once the column is
// done. Column j: every lane forms v_i = A[i][j] - sum_{k<j} L[i][k] L[j][k]
// (k ascending; row j's entries reach the group by __shfl_sync from lane
// j), lane j's v_j is the pivot, and every lane i >= j takes L[i][j] =
// v_i * rsqrt(v_j): per element the arithmetic of the one-thread chain at
// D = 2, 3, 6 (chol_kernel). The strictly-upper triangle
// is zero; a non-positive pivot gives NaN. Each lane stores its row as
// three 16-byte units.
// Bound: latency, as at the other sizes (M = 512 blocks move 0.6 MB). The
// one-thread chain at D = 12 (157 registers) took 5.2 us at M = 4 and 9.6
// us at M = 512 on an H100 (PERF.md); here a column costs two shuffles,
// an rsqrt and one multiply-add on the critical path, and thread blocks of
// 4 groups spread M = 512 over 128 SMs.
constexpr int kCholLaneThreads = 64;

template <int D>
__global__ void __launch_bounds__(kCholLaneThreads)
chol_lanes_kernel(const float* __restrict__ A, float* __restrict__ L, int M,
                  long long sam) {
  static_assert(D <= kGroupLanes && D % 4 == 0, "a lane a row, 16-byte units");
  const int i = threadIdx.x % kGroupLanes;
  const int m = blockIdx.x * (kCholLaneThreads / kGroupLanes) + threadIdx.x / kGroupLanes;
  const bool owns = m < M && i < D;
  float a[D];
  if (owns) {
    const float* row = A + (size_t)m * sam + i * D;
#pragma unroll
    for (int u = 0; u < D / 4; ++u) load_vec<4>(row + 4 * u, a + 4 * u);
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) a[j] = 0.0f;
  }
  // every lane runs every column (the shuffles need the whole warp); the
  // lanes that own no row compute values nobody stores
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float v = a[j];
#pragma unroll
    for (int k = 0; k < j; ++k) v = v - a[k] * __shfl_sync(kFullMask, a[k], j, kGroupLanes);
    const float piv = rsqrtf(__shfl_sync(kFullMask, v, j, kGroupLanes));
    a[j] = i >= j ? v * piv : 0.0f;
  }
  if (owns) {
    float* row = L + ((size_t)m * D + i) * D;
#pragma unroll
    for (int u = 0; u < D / 4; ++u) store_vec<4>(row + 4 * u, a + 4 * u);
  }
}

// One right-hand side of a substitution launch: B read through its three
// element strides, X contiguous (M, D, K). A launch takes one or two that
// share L, M, D and K; blockIdx.z picks one.
struct Rhs {
  const float* B;
  float* X;
  long long sbm, sbr, sbc;
};
struct RhsPair {
  Rhs r[2];
};

__device__ __forceinline__ Rhs pick(const RhsPair& p) {
  return blockIdx.z ? p.r[1] : p.r[0];
}

// The substitutions of one thread's V columns of one block: L Y = B row by
// row (k ascending, then the reciprocal of the diagonal) and, with BACK,
// L^T X = Y from the last row up (each row's updates k ascending), in
// place in rows. l is the block of L, ri its diagonal's reciprocals.
template <int D, int V, bool BACK>
__device__ __forceinline__ void substitute(float (&rows)[D][V], const float* l,
                                           const float* ri) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int k = 0; k < i; ++k) {
      const float lik = l[i * D + k];
#pragma unroll
      for (int v = 0; v < V; ++v) rows[i][v] = rows[i][v] - lik * rows[k][v];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) rows[i][v] *= ri[i];
  }
  if constexpr (BACK) {
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
#pragma unroll
      for (int k = i + 1; k < D; ++k) {
        const float lki = l[k * D + i];
#pragma unroll
        for (int v = 0; v < V; ++v) rows[i][v] = rows[i][v] - lki * rows[k][v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) rows[i][v] *= ri[i];
    }
  }
}

// Replaces _tri_solve_kernel (pallas_blocks.py:79), and fuses what follows
// it in every caller on the f32 path: L Y = B by forward substitution and,
// with BACK, L^T X = Y by back substitution on the same registers, so that
// one launch solves L L^T X = B and B in, X out is all the traffic. A
// launch takes one or two right-hand sides against the same L (RhsPair,
// the grid's z): the f32 band's two solves of a factor level, W2 =
// (L L^T)^-1 U_even^T and W1 = (L L^T)^-1 U_odd, are one launch. A column's
// arithmetic does not depend on the other columns, the other rhs or the
// layout.
//
// D = 2, 3 and 6 (tri_solve_kernel): a thread owns V neighbouring rhs
// columns of one block m (V = 4, 2 or 1 floats: the widest vector that K,
// the strides and the base addresses of every rhs keep aligned), loads its
// D rows of B once, all loads in flight together, substitutes in registers
// in the plain version's order (row by row, k ascending forward and
// descending rows backward) and stores X once. The thread block is
// three-dimensional, (column vectors, blocks m, staging layers), and the
// grid is (block ranges, column tiles, rhs): no thread divides by K. The
// blockDim.y blocks of L that a thread block touches are staged once into
// shared memory by stage_blocks, while the loads of B are in flight, each
// at a stride of D*D + 1 floats so that lanes on different blocks m read
// distinct banks; where a block of L has more staging units (Unit<D>) than
// the thread block has columns (K = 1, K = 6), further layers of threads
// (blockDim.z) take a unit each and then leave. The reciprocals of the
// diagonals are taken once per staged L: a thread multiplies where the
// plain version divides (as the TPU kernel does; one more rounding, inside
// the 1e-5 the f32 path is held to). B is read through its three strides,
// so a transposed or stepped view costs no copy (then by scalar loads); X
// is contiguous.
//
// Bound: the arrow panel (K = 138..258) moves B in and X out (6.8 MB at
// Manhattan-4's first level, ~2 us at an H100 SXM's 3.35 TB/s, data sheet,
// 700 W): memory bounds it, and blocks of 256 threads keep enough 8-byte
// loads in flight. A level's couplings (K = 6) and a direction (K = 1) are
// 3072 and 1024 threads of work in all: latency bounds them (the launch,
// one round trip to memory for L and B together, 72 dependent multiply-
// adds), and blocks of 64 threads spread that work over more SMs.
constexpr int kPanelThreads = 256;
constexpr int kSmallThreads = 64;
// an H100 SXM's SMs, and the work in thread blocks of kPanelThreads that
// fills them twice: the least work that is given the large block
constexpr int kSMs = 132;
constexpr long long kPanelWork = 2LL * kSMs * kPanelThreads;

template <int D, int V, bool BACK>
__global__ void __launch_bounds__(kPanelThreads)
tri_solve_kernel(const float* __restrict__ L, RhsPair rhs, int M, int K) {
  constexpr int DD = D * D;
  constexpr int LS = DD + 1;  // padded stride of a staged L
  extern __shared__ __align__(16) float smem[];
  const int TY = blockDim.y;
  float* sL = smem;            // TY x LS
  float* sR = smem + TY * LS;  // TY x D reciprocals of the diagonals
  const int m0 = blockIdx.x * TY;
  const int n = min(TY, M - m0);
  const int ml = threadIdx.y;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;  // column vector
  // layers z > 0 of the thread block only help to stage L
  const bool solves = threadIdx.z == 0 && ml < n && cv < K / V;
  const size_t m = (size_t)(m0 + ml);
  const Rhs r = pick(rhs);

  // the thread's D rows of B, in flight while L is staged
  float rows[D][V];
  if (solves) {
    const float* b = r.B + m * r.sbm + (size_t)cv * V * r.sbc;
#pragma unroll
    for (int i = 0; i < D; ++i) load_vec<V>(b + i * r.sbr, rows[i]);
  }

  const int tid = (threadIdx.z * TY + ml) * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * TY * blockDim.z;
  const float* Lsrc = L + (size_t)m0 * DD;
  // one unit of L per thread: launch_tri_v gives the block at least
  // Unit<D>::kPerBlock threads for each of its TY blocks
  stage_blocks<D, 1>(Lsrc, DD, n, sL, tid, nthreads);
  for (int q = tid; q < n * D; q += nthreads)
    sR[q] = 1.0f / __ldg(Lsrc + (q / D) * DD + (q % D) * (D + 1));
  __syncthreads();
  if (!solves) return;

  substitute<D, V, BACK>(rows, sL + ml * LS, sR + ml * D);
  float* x = r.X + m * D * K + (size_t)cv * V;
#pragma unroll
  for (int i = 0; i < D; ++i) store_vec<V>(x + (size_t)i * K, rows[i]);
}

// D = 12, the 3D band's blocks, in two layouts by the rhs width, both a
// column a thread or a group (V = 1: B is read by scalars, so a transposed
// or stepped view costs nothing more than a contiguous one).
//
// K >= kWideColumns (tri_solve_tile_kernel): a thread owns one column of one
// block and the thread block is (columns, blocks m) with no staging layers:
// every thread stages its share of the TY blocks of L (ceil(36 / K) 16-byte
// units, by cp.async straight into shared memory at a 16-byte-aligned
// stride, while its B loads and the diagonals the thread inverts are in
// flight), and every thread solves. TY = ceil(M / 132) blocks m (at most
// 64 / K), so that M = 512 takes 128 thread blocks, one an SM. The
// substitution is tri_solve_kernel's (substitute).
//
// K < kWideColumns (tri_solve_lanes_kernel): a lane group of 16 per (block
// m, column), lane i owns row i. The lane loads B[m][i][c], its row of L
// (three 16-byte units), its column of L (12 floats) and its diagonal.
// Forward: at step k lane k scales its row by the reciprocal of its
// diagonal and hands x_k to the group by __shfl_sync; every lane i > k
// subtracts L[i][k] x_k (k ascending in each row, as a thread's chain).
// Back: from the last row up, lane i forms x_i = (y_i - sum_{k>i} L[k][i]
// x_k) (k ascending) times its reciprocal and hands it to the group.
//
// Why two: the tile layout's thread stages 36 / K units of L and inverts
// 12 / K diagonals, which at K = 1 (a direction, most of the f32 band's
// solves) is a whole block a thread; the lane group loads one block row
// and one column a lane at any K but pays two shuffles a row on its chain
// and reads L once per column. Measured at M = 512 on an H100 (PERF.md), the
// tile layout is the faster from K = 4 up (K = 12, 18: the couplings and
// the panel) and the lane groups at K = 1 and 2.
// Bound: latency (M = 512 at K = 18, 12, 1 moves 0.1-0.9 MB). Both layouts
// are right at every K; -DBLOCKS_WIDE_COLUMNS=n moves the width at which
// the tile layout takes over (a measurement build times each layout alone).
#ifndef BLOCKS_WIDE_COLUMNS
#define BLOCKS_WIDE_COLUMNS 4
#endif
constexpr int kWideColumns = BLOCKS_WIDE_COLUMNS;
constexpr int kLaneSolveThreads = 128;

template <int D, bool BACK, int U>
__global__ void __launch_bounds__(kSmallThreads)
tri_solve_tile_kernel(const float* __restrict__ L, RhsPair rhs, int M, int K) {
  constexpr int DD = D * D;
  constexpr int LS = DD + 4;  // 16-byte aligned; blocks m on distinct banks
  extern __shared__ __align__(16) float smem[];
  const int TY = blockDim.y;
  float* sL = smem;
  float* sR = smem + TY * LS;
  const int m0 = blockIdx.x * TY;
  const int n = min(TY, M - m0);
  const int ml = threadIdx.y;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const bool solves = ml < n && c < K;
  const size_t m = (size_t)(m0 + ml);
  const Rhs r = pick(rhs);

  float rows[D][1];
  if (solves) {
    const float* b = r.B + m * r.sbm + (size_t)c * r.sbc;
#pragma unroll
    for (int i = 0; i < D; ++i) rows[i][0] = __ldg(b + i * r.sbr);
  }
  const int tid = ml * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * TY;
  const float* Lsrc = L + (size_t)m0 * DD;
  // the diagonals, R a thread (ceil(12 / TX) <= ceil(U / 3)), in flight
  // with B and the staging
  constexpr int R = (U + 2) / 3;
  float dg[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int q = tid + t * nthreads;
    if (q < n * D) dg[t] = __ldg(Lsrc + (q / D) * DD + (q % D) * (D + 1));
  }
  stage_blocks_async<D, U, LS>(Lsrc, DD, n, sL, tid, nthreads);
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int q = tid + t * nthreads;
    if (q < n * D) sR[q] = 1.0f / dg[t];
  }
  // B's rows arrive before the barrier, with the staging, and are not
  // loaded after it
  if (solves) {
#pragma unroll
    for (int i = 0; i < D; ++i) asm volatile("" : "+f"(rows[i][0]));
  }
  __syncthreads();
  if (!solves) return;

  substitute<D, 1, BACK>(rows, sL + ml * LS, sR + ml * D);
  float* x = r.X + m * D * K + c;
#pragma unroll
  for (int i = 0; i < D; ++i) x[(size_t)i * K] = rows[i][0];
}

template <int D, bool BACK>
__global__ void __launch_bounds__(kLaneSolveThreads)
tri_solve_lanes_kernel(const float* __restrict__ L, RhsPair rhs, int M, int K) {
  static_assert(D <= kGroupLanes && D % 4 == 0, "a lane a row, 16-byte units");
  const int i = threadIdx.x % kGroupLanes;
  const long long g = (long long)blockIdx.x * (kLaneSolveThreads / kGroupLanes) +
                      threadIdx.x / kGroupLanes;
  const long long m = g / K;
  const int c = (int)(g % K);
  const bool owns = m < M && i < D;
  const Rhs r = pick(rhs);
  float y = 0.0f, diag = 1.0f, lrow[D], lcol[D];
  if (owns) {
    const float* l = L + m * D * D;
    y = __ldg(r.B + m * r.sbm + i * r.sbr + c * r.sbc);
#pragma unroll
    for (int u = 0; u < D / 4; ++u) load_vec<4>(l + i * D + 4 * u, lrow + 4 * u);
#pragma unroll
    for (int k = 0; k < D; ++k) lcol[k] = __ldg(l + k * D + i);
    diag = __ldg(l + i * (D + 1));
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) lrow[k] = lcol[k] = 0.0f;
  }
  const float ri = 1.0f / diag;
  // every lane runs every step (the shuffles need the whole warp)
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (i == k) y *= ri;
    const float xk = __shfl_sync(kFullMask, y, k, kGroupLanes);
    if (i > k) y = y - lrow[k] * xk;
  }
  float x = y;
  if constexpr (BACK) {
    float xs[D];
#pragma unroll
    for (int j = D - 1; j >= 0; --j) {
      float z = y;
#pragma unroll
      for (int k = j + 1; k < D; ++k) z = z - lcol[k] * xs[k];
      z *= ri;
      if (i == j) x = z;
      xs[j] = __shfl_sync(kFullMask, z, j, kGroupLanes);
    }
  }
  if (owns) r.X[(m * D + i) * K + c] = x;
}

template <int D, bool BACK>
cudaError_t launch_tri_wide_blocks(const float* L, const RhsPair& rhs, int pairs,
                                   int M, int K, cudaStream_t st) {
  if (K < kWideColumns) {
    constexpr int per = kLaneSolveThreads / kGroupLanes;
    const long long groups = (long long)M * K;
    const dim3 grid((unsigned)((groups + per - 1) / per), 1, pairs);
    tri_solve_lanes_kernel<D, BACK><<<grid, kLaneSolveThreads, 0, st>>>(L, rhs, M, K);
    return cudaGetLastError();
  }
  const int TX = K < kSmallThreads ? K : kSmallThreads;
  const long long tiles = (K + TX - 1) / TX;
  if (tiles > 65535) return cudaErrorInvalidValue;
  int TY = (M + kSMs - 1) / kSMs;
  TY = TY < kSmallThreads / TX ? TY : kSmallThreads / TX;
  TY = TY < 1 ? 1 : TY;
  const dim3 grid((M + TY - 1) / TY, (unsigned)tiles, pairs);
  const dim3 block(TX, TY);
  const size_t smem = (size_t)TY * (D * D + 4 + D) * sizeof(float);
  // units of L a thread stages: ceil(36 / TX), rounded up to an
  // instantiation
  const int need = (Unit<D>::kPerBlock + TX - 1) / TX;
  if (need <= 1)
    tri_solve_tile_kernel<D, BACK, 1><<<grid, block, smem, st>>>(L, rhs, M, K);
  else if (need <= 2)
    tri_solve_tile_kernel<D, BACK, 2><<<grid, block, smem, st>>>(L, rhs, M, K);
  else if (need <= 4)
    tri_solve_tile_kernel<D, BACK, 4><<<grid, block, smem, st>>>(L, rhs, M, K);
  else if (need <= 12)
    tri_solve_tile_kernel<D, BACK, 12><<<grid, block, smem, st>>>(L, rhs, M, K);
  else
    tri_solve_tile_kernel<D, BACK, 36><<<grid, block, smem, st>>>(L, rhs, M, K);
  return cudaGetLastError();
}

template <int D, int V, bool BACK>
cudaError_t launch_tri_v(const float* L, const RhsPair& rhs, int pairs, int M,
                         int K, cudaStream_t st) {
  const int KV = K / V;
  const int target = (long long)M * KV >= kPanelWork ? kPanelThreads : kSmallThreads;
  const int TX = KV < target ? KV : target;
  // layers of threads, so that a thread stages at most one unit of L
  // where the columns are few (K = 1: 9 layers at D = 6 and D = 3)
  const int TZ = (Unit<D>::kPerBlock + TX - 1) / TX;
  int TY = target / (TX * TZ);
  TY = TY < 1 ? 1 : (TY < M ? TY : M);
  const long long tiles = (KV + TX - 1) / TX;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((M + TY - 1) / TY, (unsigned)tiles, pairs);
  const dim3 block(TX, TY, TZ);
  const size_t smem = (size_t)TY * (D * D + 1 + D) * sizeof(float);
  tri_solve_kernel<D, V, BACK><<<grid, block, smem, st>>>(L, rhs, M, K);
  return cudaGetLastError();
}

inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// D = 12 takes its own layouts; below, picks the vector width: V floats per
// thread need unit-stride columns and every row of B and of X on a multiple
// of 4 V bytes, for every rhs of the launch (a column's arithmetic does not
// depend on V).
template <int D, bool BACK>
cudaError_t launch_tri(const float* L, const RhsPair& rhs, int pairs,
                       long long M, int K, cudaStream_t st) {
  if (M > 0x7fffffff / (D * D) || (Unit<D>::kFloats == 4 && !aligned_to(L, 16)))
    return cudaErrorInvalidValue;
  if constexpr (D == 12) {
    return launch_tri_wide_blocks<D, BACK>(L, rhs, pairs, (int)M, K, st);
  } else {
    auto fits = [&](int v) {
      for (int p = 0; p < pairs; ++p) {
        const Rhs& r = rhs.r[p];
        if (!(r.sbc == 1 && K % v == 0 && r.sbr % v == 0 && r.sbm % v == 0 &&
              aligned_to(r.B, 4 * v) && aligned_to(r.X, 4 * v)))
          return false;
      }
      return true;
    };
    if (fits(4)) return launch_tri_v<D, 4, BACK>(L, rhs, pairs, (int)M, K, st);
    if (fits(2)) return launch_tri_v<D, 2, BACK>(L, rhs, pairs, (int)M, K, st);
    return launch_tri_v<D, 1, BACK>(L, rhs, pairs, (int)M, K, st);
  }
}

template <bool BACK>
int launch_tri_d(const float* L, const RhsPair& rhs, int pairs, long long M,
                 int D, int K, void* stream) {
  if (M == 0 || K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 2:
      return (int)launch_tri<2, BACK>(L, rhs, pairs, M, K, st);
    case 3:
      return (int)launch_tri<3, BACK>(L, rhs, pairs, M, K, st);
    case 6:
      return (int)launch_tri<6, BACK>(L, rhs, pairs, M, K, st);
    case 12:
      return (int)launch_tri<12, BACK>(L, rhs, pairs, M, K, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

inline int grid_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* blocks_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// A is read through its block stride sam (elements; each block contiguous;
// where D * D is a multiple of 4, sam too and A and L 16-byte aligned); L
// is contiguous (M, D, D).
int block_chol(const float* A, float* L, long long M, int D, long long sam,
               void* stream) {
  if (M == 0) return 0;
  const bool units16 = D * D % 4 == 0;
  if (M > 0x7fffffff / (D * D) ||
      (units16 && (sam % 4 || !aligned_to(A, 16) || !aligned_to(L, 16))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = grid_for(M, kCholThreads);
  switch (D) {
    case 2:
      chol_kernel<2><<<grid, kCholThreads, 0, st>>>(A, L, (int)M, sam);
      break;
    case 3:
      chol_kernel<3><<<grid, kCholThreads, 0, st>>>(A, L, (int)M, sam);
      break;
    case 6:
      chol_kernel<6><<<grid, kCholThreads, 0, st>>>(A, L, (int)M, sam);
      break;
    case 12:
      chol_lanes_kernel<12><<<grid_for(M, kCholLaneThreads / kGroupLanes),
                              kCholLaneThreads, 0, st>>>(A, L, (int)M, sam);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B is read through its element strides (sbm between blocks, sbr between
// rows, sbc between columns); X is contiguous (M, D, K). Where B2 is not
// null, the same launch solves for B2 (read through its own strides) into
// X2 (contiguous (M, D, K)).

// L X = B
int block_tri_lower_solve(const float* L, const float* B, float* X,
                          long long M, int D, int K, long long sbm,
                          long long sbr, long long sbc, const float* B2,
                          float* X2, long long sbm2, long long sbr2,
                          long long sbc2, void* stream) {
  const Rhs first{B, X, sbm, sbr, sbc};
  const RhsPair rhs{{first, B2 ? Rhs{B2, X2, sbm2, sbr2, sbc2} : first}};
  return launch_tri_d<false>(L, rhs, B2 ? 2 : 1, M, D, K, stream);
}

// L L^T X = B
int block_chol_solve(const float* L, const float* B, float* X, long long M,
                     int D, int K, long long sbm, long long sbr,
                     long long sbc, const float* B2, float* X2, long long sbm2,
                     long long sbr2, long long sbc2, void* stream) {
  const Rhs first{B, X, sbm, sbr, sbc};
  const RhsPair rhs{{first, B2 ? Rhs{B2, X2, sbm2, sbr2, sbc2} : first}};
  return launch_tri_d<true>(L, rhs, B2 ? 2 : 1, M, D, K, stream);
}

}  // extern "C"
