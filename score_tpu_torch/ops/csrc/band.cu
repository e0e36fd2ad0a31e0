// Block-tridiagonal band kernels: compacting cyclic reduction (CR) levels
// followed by parallel cyclic reduction (PCR) of the remainder, in f64.
//
// Hand-written Hopper (sm_90a) port of the Pallas TPU kernels in
// score_tpu/ops/pallas_pcr.py. See score_tpu_torch/ops/band.py for the
// algorithm, the plain PyTorch twin of every kernel and the Python wrappers
// that launch these entry points.
//
// Layouts (all contiguous, row-major, f64):
//   band blocks D, A, C, U, invD : (C, Tp, Db, Db)
//   PCR level factors E, F       : (L, C, Tp, Db, Db)
//   one CR level's blocks        : (C, Tp/2, Db, Db) each
//   right-hand sides b, x        : (C, Tp, Db, K)
// Position i of chain c reads block i +- s of the same chain and zero
// outside [0, Tp); this replaces the TPU kernels' masked lane rolls. A CR
// level reads the even/odd rows of its fine input by index, which replaces
// the stride-2 lane slices the TPU caller makes between launches.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns the cudaError_t of the launch (0 = ok).
// Kernels are templated on the block size Db; only Db = 6 (2D pose blocks)
// is instantiated.

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------
// Per-block device functions (one Db x Db block per thread, row-major in
// local arrays). Same operation order as the plain PyTorch versions in
// score_tpu_torch/solver/smallblocks.py.
// ---------------------------------------------------------------------

// Left-looking column Cholesky: L lower-triangular with A = L L^T.
template <int Db>
__device__ __forceinline__ void chol(const double* A, double* L) {
#pragma unroll
  for (int j = 0; j < Db; ++j) {
    double c[Db];
#pragma unroll
    for (int i = 0; i < Db; ++i) c[i] = A[i * Db + j];
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const double ljk = L[j * Db + k];
#pragma unroll
      for (int i = 0; i < Db; ++i) c[i] = c[i] - L[i * Db + k] * ljk;
    }
    const double piv = sqrt(c[j]);
#pragma unroll
    for (int i = 0; i < Db; ++i) L[i * Db + j] = (i >= j) ? c[i] / piv : 0.0;
  }
}

// Inverse of an SPD block: Cholesky, then L Y = I and L^T X = Y.
template <int Db>
__device__ __forceinline__ void inv_spd(const double* A, double* X) {
  double L[Db * Db];
  double Y[Db * Db];
  chol<Db>(A, L);
  // forward substitution, all Db columns of the identity at once
#pragma unroll
  for (int i = 0; i < Db; ++i) {
#pragma unroll
    for (int col = 0; col < Db; ++col) {
      double r = (i == col) ? 1.0 : 0.0;
#pragma unroll
      for (int k = 0; k < i; ++k) r = r - L[i * Db + k] * Y[k * Db + col];
      Y[i * Db + col] = r / L[i * Db + i];
    }
  }
  // back substitution with L^T
#pragma unroll
  for (int i = Db - 1; i >= 0; --i) {
#pragma unroll
    for (int col = 0; col < Db; ++col) {
      double r = Y[i * Db + col];
#pragma unroll
      for (int k = i + 1; k < Db; ++k) r = r - L[k * Db + i] * X[k * Db + col];
      X[i * Db + col] = r / L[i * Db + i];
    }
  }
}

template <int Db>
__device__ __forceinline__ void load_block(const double* __restrict__ src,
                                           double* dst) {
#pragma unroll
  for (int e = 0; e < Db * Db; ++e) dst[e] = src[e];
}

template <int Db>
__device__ __forceinline__ void store_block(double* __restrict__ dst,
                                            const double* src) {
#pragma unroll
  for (int e = 0; e < Db * Db; ++e) dst[e] = src[e];
}

// ---------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------

// A[c, i] = U[c, i-1]^T, zero at i = 0. One thread per output element.
template <int Db>
__global__ void init_a_kernel(const double* __restrict__ U,
                              double* __restrict__ A, int nC, int Tp) {
  const long long n = (long long)nC * Tp * Db * Db;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int col = (int)(e % Db);
  const int row = (int)((e / Db) % Db);
  const long long blk = e / (Db * Db);  // c * Tp + i
  const int i = (int)(blk % Tp);
  A[e] = (i == 0) ? 0.0 : U[(blk - 1) * Db * Db + col * Db + row];
}

// invD[b] = D[b]^{-1} for every block b. One thread per block.
template <int Db>
__global__ void __launch_bounds__(128)
block_inv_kernel(const double* __restrict__ D, double* __restrict__ invD,
                 long long nblocks) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  double M[Db * Db];
  double X[Db * Db];
  load_block<Db>(D + b * Db * Db, M);
  inv_spd<Db>(M, X);
  store_block<Db>(invD + b * Db * Db, X);
}

// ---------------------------------------------------------------------
// band_pcr_level: one PCR level at shift s.
//
// Mapping: a group of 8 neighbouring lanes owns one position (4 positions
// per warp); lanes 0..Db-1 of the group each hold ONE ROW of every block
// in registers, lanes Db..7 only help to move data. 8 (not Db) lanes per
// group keeps a group inside a warp, so the width-8 shuffles of the
// Cholesky need no index arithmetic, and gives the 18 double2 of a block
// to 8 lanes as three 16-byte accesses on neighbouring addresses. The
// nine input blocks of a position (its own A, C, D and invD, C, A of
// i-s and invD, A, C of i+s) are staged in shared memory with cp.async,
// all in flight at once; a row-times-block product then reads the other
// block's rows as 16-byte broadcasts. The kernel takes inv(D) of its
// input and writes inv(D') of its output, so every block is inverted
// once per level: Cholesky across the group by shuffles, then lane c
// solves column c of L Y = I, L^T X = Y. Outputs go back through shared
// memory and leave as 16-byte coalesced stores. Arithmetic order is that
// of the plain PyTorch version (left-looking column Cholesky, products
// summed over k ascending).
// ---------------------------------------------------------------------

constexpr int kGroupLanes = 8;                   // lanes per position
constexpr int kPosPerWarp = 32 / kGroupLanes;    // 4
constexpr int kLevelWarps = 4;                   // 128 threads, 16 positions

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// out[c] = sum_k p[k] * Q[k][c], Q row-major in shared memory (16-byte
// aligned), k ascending from 0.0 as the plain version's matmul.
template <int Db>
__device__ __forceinline__ void row_times_block(const double* p,
                                                const double* Q,
                                                double* out) {
#pragma unroll
  for (int c = 0; c < Db; ++c) out[c] = 0.0;
#pragma unroll
  for (int k = 0; k < Db; ++k) {
#pragma unroll
    for (int c = 0; c < Db; c += 2) {
      const double2 q = *reinterpret_cast<const double2*>(Q + k * Db + c);
      out[c] += p[k] * q.x;
      out[c + 1] += p[k] * q.y;
    }
  }
}

// Inverse of an SPD block across a lane group, called by every lane of the
// warp: lane r < Db of the group holds row r of the block in Dv (a group
// with no block, and lanes Db..7, pass rows of the identity). Cholesky by
// width-8 shuffles (lane r ends with row r of L), L through the shared
// block Lm, then lane c solves column c of L Y = I, L^T X = Y and writes it
// to the shared block inv. Lm and inv may be blocks whose reads by the
// group precede the call. The caller synchronises before inv is read.
template <int Db>
__device__ __forceinline__ void group_inv_spd(const double* Dv, double* Lm,
                                              double* inv, int r, bool row) {
  double Lr[Db];
#pragma unroll
  for (int j = 0; j < Db; ++j) {
    double cj = Dv[j];
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const double ljk = __shfl_sync(0xffffffffu, Lr[k], j, kGroupLanes);
      cj = cj - Lr[k] * ljk;
    }
    const double piv = sqrt(__shfl_sync(0xffffffffu, cj, j, kGroupLanes));
    Lr[j] = (r >= j) ? cj / piv : 0.0;
  }
  __syncwarp();  // every lane has finished reading what Lm and inv held
  if (row) {
#pragma unroll
    for (int c = 0; c < Db; ++c) Lm[r * Db + c] = Lr[c];
  }
  __syncwarp();
  if (row) {
    double y[Db], x[Db];
#pragma unroll
    for (int q = 0; q < Db; ++q) {
      double v = (q == r) ? 1.0 : 0.0;
#pragma unroll
      for (int k = 0; k < q; ++k) v = v - Lm[q * Db + k] * y[k];
      y[q] = v / Lm[q * Db + q];
    }
#pragma unroll
    for (int q = Db - 1; q >= 0; --q) {
      double v = y[q];
#pragma unroll
      for (int k = q + 1; k < Db; ++k) v = v - Lm[k * Db + q] * x[k];
      x[q] = v / Lm[q * Db + q];
    }
#pragma unroll
    for (int q = 0; q < Db; ++q) inv[q * Db + r] = x[q];
  }
}

template <int Db>
__global__ void __launch_bounds__(kLevelWarps * 32)
pcr_level_kernel(const double* __restrict__ D, const double* __restrict__ A,
                 const double* __restrict__ Cc,
                 const double* __restrict__ invD, double* __restrict__ E,
                 double* __restrict__ F, double* __restrict__ D2,
                 double* __restrict__ A2, double* __restrict__ C2,
                 double* __restrict__ invD2, int nC, int Tp, int s) {
  static_assert(Db % 2 == 0 && Db <= kGroupLanes, "row-per-lane layout");
  constexpr int BS = Db * Db;
  constexpr int V = BS / 2;  // double2 per block
  // [block slot][position of the warp][BS]; slots while reading:
  // 0 A_i, 1 C_i, 2 D_i, 3 invD_dn, 4 C_dn, 5 A_dn, 6 invD_up, 7 A_up,
  // 8 C_up; while writing: 0 E, 1 F, 2 D', 3 A', 4 C', 5 L, 6 invD'.
  __shared__ __align__(16) double sm[kLevelWarps][9][kPosPerWarp][BS];

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) / kGroupLanes;  // position of the warp
  const int r = threadIdx.x & (kGroupLanes - 1);   // row held by this lane
  const long long t =
      (long long)blockIdx.x * (kLevelWarps * kPosPerWarp) + (threadIdx.x >> 3);
  const bool valid = t < (long long)nC * Tp;
  const int i = valid ? (int)(t % Tp) : 0;
  const bool has_dn = valid && i - s >= 0;
  const bool has_up = valid && i + s < Tp;
  const bool row = r < Db;
  double(*my)[kPosPerWarp][BS] = sm[warp];

  {
    const double* src[9] = {A + t * BS,          Cc + t * BS,
                            D + t * BS,          invD + (t - s) * BS,
                            Cc + (t - s) * BS,   A + (t - s) * BS,
                            invD + (t + s) * BS, A + (t + s) * BS,
                            Cc + (t + s) * BS};
#pragma unroll
    for (int b = 0; b < 9; ++b) {
      const bool on = b < 3 ? valid : (b < 6 ? has_dn : has_up);
#pragma unroll
      for (int v = r; v < V; v += kGroupLanes) {
        double* dst = &my[b][g][2 * v];
        if (on) {
          cp_async16(dst, src[b] + 2 * v);
        } else {
          dst[0] = 0.0;
          dst[1] = 0.0;
        }
      }
    }
    cp_async_wait_all();
  }
  __syncwarp();

  double Ev[Db], Fv[Db], Dv[Db], Av[Db], Cv[Db];
  if (row) {
    double p[Db], acc[Db];
    // E = -A_i invD_{i-s};  A' = E A_{i-s};  D' gets E C_{i-s}
#pragma unroll
    for (int c = 0; c < Db; ++c) p[c] = my[0][g][r * Db + c];
    row_times_block<Db>(p, my[3][g], Ev);
#pragma unroll
    for (int c = 0; c < Db; ++c) Ev[c] = has_dn ? -Ev[c] : 0.0;
    row_times_block<Db>(Ev, my[5][g], Av);
    row_times_block<Db>(Ev, my[4][g], Dv);
    // F = -C_i invD_{i+s};  C' = F C_{i+s};  D' gets F A_{i+s}
#pragma unroll
    for (int c = 0; c < Db; ++c) p[c] = my[1][g][r * Db + c];
    row_times_block<Db>(p, my[6][g], Fv);
#pragma unroll
    for (int c = 0; c < Db; ++c) Fv[c] = has_up ? -Fv[c] : 0.0;
    row_times_block<Db>(Fv, my[8][g], Cv);
    row_times_block<Db>(Fv, my[7][g], acc);
    // D' = D_i + (E C_{i-s} + F A_{i+s})
#pragma unroll
    for (int c = 0; c < Db; ++c)
      Dv[c] = my[2][g][r * Db + c] + (Dv[c] + acc[c]);
  }
  if (!valid || !row) {
    // idle lanes take the identity through the shuffles below
#pragma unroll
    for (int c = 0; c < Db; ++c) Dv[c] = (c == r) ? 1.0 : 0.0;
  }

  __syncwarp();  // every lane has finished reading the staged inputs
  if (row) {
#pragma unroll
    for (int c = 0; c < Db; ++c) {
      my[0][g][r * Db + c] = Ev[c];
      my[1][g][r * Db + c] = Fv[c];
      my[2][g][r * Db + c] = Dv[c];
      my[3][g][r * Db + c] = Av[c];
      my[4][g][r * Db + c] = Cv[c];
    }
  }
  // inv(D') across the group: L through slot 5, the inverse into slot 6
  group_inv_spd<Db>(Dv, my[5][g], my[6][g], r, row);
  __syncwarp();
  if (valid) {
    double* dst[6] = {E + t * BS,  F + t * BS,  D2 + t * BS,
                      A2 + t * BS, C2 + t * BS, invD2 + t * BS};
    const int slot[6] = {0, 1, 2, 3, 4, 6};
#pragma unroll
    for (int b = 0; b < 6; ++b) {
#pragma unroll
      for (int v = r; v < V; v += kGroupLanes)
        *reinterpret_cast<double2*>(dst[b] + 2 * v) =
            *reinterpret_cast<const double2*>(&my[slot[b]][g][2 * v]);
    }
  }
}

// ---------------------------------------------------------------------
// band_cr_level: one compacting cyclic-reduction (CR) level. Coarse
// position j of a chain keeps fine row 2j, reduced exactly as a PCR level
// at s = 1 reduces it, and eliminates the odd rows 2j -+ 1; it also stores
// what the solve's back-substitution needs for odd row 2j + 1 (its inverse
// and its input couplings A, C). Inputs are at the fine length 2*Th,
// outputs at the coarse length Th; fine row 2j of chain c is block 2*t for
// t = c*Th + j, so the compaction costs no gather.
//
// Mapping: the lane-group layout of band_pcr_level. A thread block has 16
// groups of 8 lanes: groups 1..15 own 15 consecutive coarse positions, and
// group 0 stands in for the position before them. Every group owns ONE odd
// row, 2t + 1 for its position t: it stages that row's D, A, C (and, groups
// 1..15, the even row's) in shared memory by 16-byte cp.async, inverts the
// odd D with the group inversion it shares with band_pcr_level, and leaves
// the inverse in shared memory. After one block barrier a group takes
// F = -C_{2j} invD_{2j+1} from its own odd row and E = -A_{2j} invD_{2j-1}
// from the group before it, whose staged A, C it multiplies as well: every
// odd block is inverted once per thread block that uses it, all inversions
// of a thread block side by side, where a thread of the kernel before this
// one inverted both neighbours in its own dependent chain. Group 0 exists
// so that the first position's halo inverse does not double that position's
// chain (one inversion in 16 is repeated). The outputs leave through
// shared memory as 16-byte stores; Ao, Co are the staged copies.
// Arithmetic order is that of the plain PyTorch version.
// Bound: 7 blocks of traffic per fine position pair (1.6 MB at
// Manhattan-4's first level, half a microsecond of HBM time), so latency
// bounds a launch: the dependent f64 chain of a Cholesky, two
// substitutions and two row-times-block products.
// ---------------------------------------------------------------------

constexpr int kCrGroups = kLevelWarps * kPosPerWarp;  // 16 lane groups
constexpr int kCrPositions = kCrGroups - 1;           // and one is the halo

template <int Db>
__global__ void __launch_bounds__(kLevelWarps * 32)
cr_level_kernel(const double* __restrict__ D, const double* __restrict__ A,
                const double* __restrict__ Cc, double* __restrict__ E,
                double* __restrict__ F, double* __restrict__ invDo,
                double* __restrict__ Ao, double* __restrict__ Co,
                double* __restrict__ D2, double* __restrict__ A2,
                double* __restrict__ C2, int nC, int Th) {
  static_assert(Db % 2 == 0 && Db <= kGroupLanes, "row-per-lane layout");
  constexpr int BS = Db * Db;
  constexpr int V = BS / 2;  // double2 per block
  // [group][block slot][BS]; slots: 0 D_odd, then L; 1 A_odd; 2 C_odd;
  // 3 D_even, then D'; 4 A_even, then E; 5 C_even, then F; 6 invD_odd;
  // 7 A'; 8 C'. The next group reads slots 6, 1, 2, which stay as they are.
  __shared__ __align__(16) double sm[kCrGroups][9][BS];

  const int q = threadIdx.x / kGroupLanes;        // group of the block
  const int r = threadIdx.x & (kGroupLanes - 1);  // row held by this lane
  const int n = nC * Th;
  // group 0: the position before the block's first, for its odd row only
  const int t = (int)blockIdx.x * kCrPositions + q - 1;
  const bool pos = q > 0 && t < n;  // owns coarse position t
  // odd row 2t + 1 is wanted: by its owner, or by the block's first
  // position when that has a lower neighbour in its chain
  const bool odd = q > 0 ? pos : (t >= 0 && t + 1 < n && (t + 1) % Th != 0);
  const bool has_dn = pos && t % Th != 0;  // odd row 2j - 1, group q - 1's
  const bool row = r < Db;
  double(*my)[BS] = sm[q];

  if (odd) {
    const long long o = (2LL * t + 1) * BS;  // odd row; the even row is before
    const double* src[6] = {D + o,      A + o,      Cc + o,
                            D + o - BS, A + o - BS, Cc + o - BS};
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      if (b < 3 || pos) {
#pragma unroll
        for (int v = r; v < V; v += kGroupLanes)
          cp_async16(&my[b][2 * v], src[b] + 2 * v);
      }
    }
  }
  cp_async_wait_all();
  __syncwarp();

  double Dv[Db];
#pragma unroll
  for (int c = 0; c < Db; ++c)
    Dv[c] = (odd && row) ? my[0][r * Db + c] : ((c == r) ? 1.0 : 0.0);
  group_inv_spd<Db>(Dv, my[0], my[6], r, row);
  __syncthreads();  // the group before has its inverse and A, C in place

  if (pos && row) {
    // A lane overwrites only rows it alone has read (row r of slots 3, 4,
    // 5) and slots nobody reads (7, 8), each result as soon as it is
    // complete: few rows are live at a time.
    double p[Db], Xv[Db], out[Db], acc[Db];
    // F = -C_{2j} invD_{2j+1};  C' = F C_{2j+1};  D' gets F A_{2j+1}
#pragma unroll
    for (int c = 0; c < Db; ++c) p[c] = my[5][r * Db + c];
    row_times_block<Db>(p, my[6], Xv);
#pragma unroll
    for (int c = 0; c < Db; ++c) {
      Xv[c] = -Xv[c];
      my[5][r * Db + c] = Xv[c];
    }
    row_times_block<Db>(Xv, my[2], out);
#pragma unroll
    for (int c = 0; c < Db; ++c) my[8][r * Db + c] = out[c];
    row_times_block<Db>(Xv, my[1], acc);
    // E = -A_{2j} invD_{2j-1};  A' = E A_{2j-1};  D' gets E C_{2j-1}
    if (has_dn) {
      const double(*dn)[BS] = sm[q - 1];
#pragma unroll
      for (int c = 0; c < Db; ++c) p[c] = my[4][r * Db + c];
      row_times_block<Db>(p, dn[6], Xv);
#pragma unroll
      for (int c = 0; c < Db; ++c) {
        Xv[c] = -Xv[c];
        my[4][r * Db + c] = Xv[c];
      }
      row_times_block<Db>(Xv, dn[1], out);
#pragma unroll
      for (int c = 0; c < Db; ++c) my[7][r * Db + c] = out[c];
      row_times_block<Db>(Xv, dn[2], out);
    } else {
#pragma unroll
      for (int c = 0; c < Db; ++c)
        my[4][r * Db + c] = my[7][r * Db + c] = out[c] = 0.0;
    }
    // D' = D_{2j} + (E C_{2j-1} + F A_{2j+1})
#pragma unroll
    for (int c = 0; c < Db; ++c)
      my[3][r * Db + c] = my[3][r * Db + c] + (out[c] + acc[c]);
  }
  __syncwarp();
  if (pos) {
    const long long o = (long long)t * BS;
    double* dst[8] = {E + o,  F + o,  invDo + o, Ao + o,
                      Co + o, D2 + o, A2 + o,    C2 + o};
    const int slot[8] = {4, 5, 6, 1, 2, 3, 7, 8};
#pragma unroll
    for (int b = 0; b < 8; ++b) {
#pragma unroll
      for (int v = r; v < V; v += kGroupLanes)
        *reinterpret_cast<double2*>(dst[b] + 2 * v) =
            *reinterpret_cast<const double2*>(&my[slot[b]][2 * v]);
    }
  }
}

// CR rhs reduction onto the kept rows:
//   out[j] = b[2j] + (E_j b[2j-1] + F_j b[2j+1])
// b is fine (C, 2*Th, Db, K), out coarse (C, Th, Db, K). One thread per
// output element; consecutive threads run along the rhs columns, so the
// reads of b and the writes of out are contiguous.
template <int Db>
__global__ void __launch_bounds__(256)
cr_reduce_kernel(const double* __restrict__ E, const double* __restrict__ F,
                 const double* __restrict__ b, double* __restrict__ out,
                 int nC, int Th, int K) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)nC * Th * Db * K) return;
  const int k = (int)(e % K);
  const int r = (int)((e / K) % Db);
  const long long t = e / ((long long)K * Db);  // c * Th + j
  const int j = (int)(t % Th);
  const long long f = 2 * t;
  const long long bs = (long long)Db * Db;
  const long long rs = (long long)Db * K;  // one fine row of b
  double ae = 0.0;
  if (j > 0) {
    const double* Er = E + t * bs + r * Db;
    const double* bd = b + (f - 1) * rs + k;
#pragma unroll
    for (int q = 0; q < Db; ++q) ae += Er[q] * bd[(long long)q * K];
  }
  double af = 0.0;
  const double* Fr = F + t * bs + r * Db;
  const double* bu = b + (f + 1) * rs + k;
#pragma unroll
  for (int q = 0; q < Db; ++q) af += Fr[q] * bu[(long long)q * K];
  out[e] = b[f * rs + (long long)r * K + k] + (ae + af);
}

// CR back-substitution of the eliminated rows, re-interleaving them with
// the kept rows' solution:
//   x[2j]   = x_ev[j]
//   x[2j+1] = invD_j ((b[2j+1] - A_j x_ev[j]) - C_j x_ev[j+1])
// (invD, A, C: the odd rows' blocks stored by cr_level_kernel). One thread
// per (chain, j, rhs column) writes both fine rows of its column.
template <int Db>
__global__ void __launch_bounds__(256)
cr_backsub_kernel(const double* __restrict__ invDo,
                  const double* __restrict__ Ao,
                  const double* __restrict__ Co, const double* __restrict__ b,
                  const double* __restrict__ xe, double* __restrict__ x,
                  int nC, int Th, int K) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (long long)nC * Th * K) return;
  const int k = (int)(w % K);
  const long long t = w / K;  // c * Th + j
  const int j = (int)(t % Th);
  const long long f = 2 * t;
  const long long bs = (long long)Db * Db;
  const long long rs = (long long)Db * K;
  const double* xj = xe + t * rs + k;
  double xv[Db], rv[Db];
#pragma unroll
  for (int p = 0; p < Db; ++p) xv[p] = xj[(long long)p * K];
  const double* Aj = Ao + t * bs;
#pragma unroll
  for (int q = 0; q < Db; ++q) {
    double a = 0.0;
#pragma unroll
    for (int p = 0; p < Db; ++p) a += Aj[q * Db + p] * xv[p];
    rv[q] = b[(f + 1) * rs + (long long)q * K + k] - a;
  }
  if (j + 1 < Th) {
    const double* xn = xe + (t + 1) * rs + k;
    double xu[Db];
#pragma unroll
    for (int p = 0; p < Db; ++p) xu[p] = xn[(long long)p * K];
    const double* Cj = Co + t * bs;
#pragma unroll
    for (int q = 0; q < Db; ++q) {
      double a = 0.0;
#pragma unroll
      for (int p = 0; p < Db; ++p) a += Cj[q * Db + p] * xu[p];
      rv[q] = rv[q] - a;
    }
  }
  const double* Vj = invDo + t * bs;
#pragma unroll
  for (int r = 0; r < Db; ++r) {
    double a = 0.0;
#pragma unroll
    for (int q = 0; q < Db; ++q) a += Vj[r * Db + q] * rv[q];
    x[f * rs + (long long)r * K + k] = xv[r];
    x[(f + 1) * rs + (long long)r * K + k] = a;
  }
}

// ---------------------------------------------------------------------
// band_pcr_solve: all PCR levels of the rhs replay plus x = invD b in one
// launch. A thread block holds a chunk of the rhs columns of one chain in
// shared memory, in ONE (Tp, Db, Kc) buffer updated in place: a thread
// keeps a level's outputs in registers across the block barrier that ends
// the level's reads, adds them into the buffer, and a second barrier opens
// the next level. Two kernels share that scheme:
//
//   wide   (Tp <= 256, K >= 5): a thread owns a position and a register
//          tile of all Db rows by 8 columns (48 accumulators), so an
//          element of E_i / F_i is read once for the whole strip and an
//          element of b once for all Db rows. G threads per position
//          (G * 8 columns per block) share the E, F that the block stages
//          through shared memory: the level's E and F, each cut into an
//          upper and a lower half of rows, pass as four tiles through a
//          ring of three buffers filled by 16-byte cp.async copies on
//          neighbouring addresses, two tiles in flight while one is used.
//          A thread reads its 144-byte half block and its neighbours' rhs
//          as 16-byte vectors; the half block's stride and the rhs
//          buffer's padded position stride (an odd number of 16-byte
//          units) keep a quarter warp on distinct banks.
//   narrow (K <= 4, or any K on chains longer than 256): one thread per
//          (position, row) and CT in {1, 2, 4} columns, IT items per
//          thread; the Db rows of a position and its two neighbour
//          products lie on neighbouring lanes, whose 16-byte loads of E, F
//          rows (48 bytes a row) are contiguous across the warp, and for
//          IT <= 4 all of a level's loads start, unconditionally,
//          before the first is used.
//
// What bounds them on an H100 (profile_port.py --ablate, PERF.md): the E
// and F of a level, which every block of a chain reads again from L2. One
// SM pulls a level of a 256-long chain (147 KB) in about 1.2 us, so a
// direction solve (K = 1, one block per chain) spends over half of its time
// there; the panel's blocks together draw about 4 TB/s from L2, and the two
// tiles a block keeps in flight do not hide that: a third of the panel's
// time is these copies, a third the products (bound by shared-memory
// reads), the rest the rhs in and out and the barriers.
// ---------------------------------------------------------------------

// profile_port.py --ablate builds this file with -DBAND_NO_STAGING (the
// level loop of band_pcr_solve moves no E, F) and -DBAND_NO_PRODUCT (the
// wide kernel's level loop multiplies nothing) to price those parts; the
// results are then wrong, and no other build defines them.
constexpr int kWideCols = 8;
constexpr int kWideMaxT = 256;     // also the most threads of a wide block
constexpr int kWideRing = 3;
constexpr int kNarrowThreads = 512;
constexpr int kNarrowAcc = 24;  // accumulators per thread: IT * CT

__device__ __forceinline__ double2 ldg2(const double* p) {
  return __ldg(reinterpret_cast<const double2*>(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int Db>
__global__ void __launch_bounds__(kWideMaxT)
pcr_solve_wide_kernel(const double* __restrict__ E,
                      const double* __restrict__ F,
                      const double* __restrict__ invD,
                      const double* __restrict__ b, double* __restrict__ x,
                      int nC, int Tp, int L, int K, int G) {
  static_assert(Db % 2 == 0, "half blocks of whole rows");
  constexpr int CT = kWideCols;
  constexpr int BS = Db * Db;
  constexpr int HR = Db / 2;        // rows of a half block
  constexpr int HS = HR * Db;       // doubles of a half block
  constexpr int HV = HS / 2;        // 16-byte units of a half block
  const int W = G * CT;             // columns of the block
  const int PS = Db * W + 2;        // padded position stride, doubles
  extern __shared__ __align__(16) double smem[];
  double* ring = smem;                               // kWideRing x Tp x HS
  double* rhs = smem + (size_t)kWideRing * Tp * HS;  // Tp x PS
  const int c = blockIdx.x;
  const int k0 = blockIdx.y * W;
  const int i = threadIdx.x % Tp;
  const int g = threadIdx.x / Tp;
  const bool live = g < G;
  const int kg = g * CT;  // first column of this thread inside the block
  const int ntiles = 4 * L + 2;  // two more: the halves of invD

  // Tile n = 4 * level + 2 * side + half: all positions' half blocks, as
  // Tp * HV 16-byte units dealt to the threads in order. A thread's (at
  // most HV) units sit at the same offsets in every tile: computed once.
  int unit_src[HV], unit_dst[HV];
#pragma unroll
  for (int m = 0; m < HV; ++m) {
    const int q = threadIdx.x + m * blockDim.x;
    const int p = q / HV, v = q % HV;
    unit_src[m] = q < Tp * HV ? p * BS + 2 * v : -1;
    unit_dst[m] = p * HS + 2 * v;
  }
  auto stage = [&](int n) {
    if (n < ntiles) {
      const int lev = n >> 2, side = (n >> 1) & 1, half = n & 1;
      const double* src =
          (lev == L ? invD + (long long)c * Tp * BS
                    : (side == 0 ? E : F) + ((long long)lev * nC + c) * Tp * BS) +
          half * HS;
      double* dst = ring + (size_t)(n % kWideRing) * Tp * HS;
#pragma unroll
      for (int m = 0; m < HV; ++m)
        if (unit_src[m] >= 0) cp_async16(dst + unit_dst[m], src + unit_src[m]);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // The block's rhs columns: rows of W doubles, K apart in b. With K even
  // every pair of columns is 16-byte aligned and goes by cp.async, as the
  // first group; else by scalar loads, eight in flight per thread.
  const double* bsrc = b + (long long)c * Tp * Db * K + k0;
  if (K % 2 == 0) {
    const int hw = W / 2;
    for (int idx = threadIdx.x; idx < Tp * Db * hw; idx += blockDim.x) {
      const int kk = 2 * (idx % hw);
      const int row = idx / hw;  // position * Db + row of the block
      double* dst = rhs + (row / Db) * PS + (row % Db) * W + kk;
      if (k0 + kk < K) {
        cp_async16(dst, bsrc + (long long)row * K + kk);
      } else {
        dst[0] = 0.0;
        dst[1] = 0.0;
      }
    }
  } else {
    const int total = Tp * Db * W;
    for (int idx0 = threadIdx.x; idx0 < total; idx0 += 8 * blockDim.x) {
      double v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int idx = idx0 + m * blockDim.x;
        const int kk = idx % W, row = idx / W;
        v[m] = (idx < total && k0 + kk < K) ? bsrc[(long long)row * K + kk] : 0.0;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int idx = idx0 + m * blockDim.x;
        const int kk = idx % W, row = idx / W;
        if (idx < total) rhs[(row / Db) * PS + (row % Db) * W + kk] = v[m];
      }
    }
  }
  stage(0);  // its group also holds the rhs copies
  stage(1);

  double acc[Db][CT];
#pragma unroll
  for (int r = 0; r < Db; ++r)
#pragma unroll
    for (int k = 0; k < CT; ++k) acc[r][k] = 0.0;

  // acc[half's rows] += (half block of tile n at position i) * rhs[pos]
  auto half_product = [&](int n, int half, int pos) {
    const double* M = ring + (size_t)(n % kWideRing) * Tp * HS + i * HS;
    const double* bn = rhs + pos * PS + kg;
    double2 bv[Db][CT / 2];
#pragma unroll
    for (int j = 0; j < Db; ++j)
#pragma unroll
      for (int k = 0; k < CT / 2; ++k)
        bv[j][k] = *reinterpret_cast<const double2*>(bn + j * W + 2 * k);
#pragma unroll
    for (int rr = 0; rr < HR; ++rr) {
      const int r = half * HR + rr;
#pragma unroll
      for (int j = 0; j < Db; j += 2) {
        const double2 m = *reinterpret_cast<const double2*>(M + rr * Db + j);
#pragma unroll
        for (int k = 0; k < CT / 2; ++k) {
          acc[r][2 * k] += m.x * bv[j][k].x;
          acc[r][2 * k + 1] += m.x * bv[j][k].y;
        }
#pragma unroll
        for (int k = 0; k < CT / 2; ++k) {
          acc[r][2 * k] += m.y * bv[j + 1][k].x;
          acc[r][2 * k + 1] += m.y * bv[j + 1][k].y;
        }
      }
    }
  };

  for (int lev = 0; lev < L; ++lev) {
    const int s = 1 << lev;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = 4 * lev + u;
      cp_async_wait<1>();  // this thread's copies of tile n have landed
      __syncthreads();     // everyone's have, and tile n - 1 is done with
#ifndef BAND_NO_STAGING
      stage(n + 2);
#endif
      const int nb = (u < 2) ? i - s : i + s;
#ifndef BAND_NO_PRODUCT
      if (live && nb >= 0 && nb < Tp) half_product(n, u & 1, nb);
#endif
    }
    __syncthreads();  // every read of this level's input is done
    if (live) {
      double* bo = rhs + i * PS + kg;
#pragma unroll
      for (int r = 0; r < Db; ++r)
#pragma unroll
        for (int k = 0; k < CT; k += 2) {
          double2* slot = reinterpret_cast<double2*>(bo + r * W + k);
          double2 v = *slot;
          v.x += acc[r][k];
          v.y += acc[r][k + 1];
          *slot = v;
          acc[r][k] = 0.0;
          acc[r][k + 1] = 0.0;
        }
    }
    // the next tile's barrier orders these writes before the next reads
  }

  // x = invD b: the last two tiles, on the thread's own rhs
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int n = 4 * L + u;
    cp_async_wait<1>();
    __syncthreads();
    stage(n + 2);
    if (live) half_product(n, u, i);
  }
  cp_async_wait<0>();
  if (live) {
    // x leaves through the thread's own slots of the rhs buffer
    double* bo = rhs + i * PS + kg;
#pragma unroll
    for (int r = 0; r < Db; ++r)
#pragma unroll
      for (int k = 0; k < CT; k += 2)
        *reinterpret_cast<double2*>(bo + r * W + k) =
            make_double2(acc[r][k], acc[r][k + 1]);
  }
  __syncthreads();
  double* xdst = x + (long long)c * Tp * Db * K + k0;
  if (K % 2 == 0) {
    const int hw = W / 2;
    for (int idx = threadIdx.x; idx < Tp * Db * hw; idx += blockDim.x) {
      const int kk = 2 * (idx % hw);
      const int row = idx / hw;
      if (k0 + kk < K)
        *reinterpret_cast<double2*>(xdst + (long long)row * K + kk) =
            *reinterpret_cast<const double2*>(rhs + (row / Db) * PS +
                                              (row % Db) * W + kk);
    }
  } else {
    for (int idx = threadIdx.x; idx < Tp * Db * W; idx += blockDim.x) {
      const int kk = idx % W, row = idx / W;
      if (k0 + kk < K)
        xdst[(long long)row * K + kk] = rhs[(row / Db) * PS + (row % Db) * W + kk];
    }
  }
}

template <int Db, int CT, int IT>
__global__ void __launch_bounds__(kNarrowThreads)
pcr_solve_narrow_kernel(const double* __restrict__ E,
                        const double* __restrict__ F,
                        const double* __restrict__ invD,
                        const double* __restrict__ b, double* __restrict__ x,
                        int nC, int Tp, int L, int K) {
  constexpr int BS = Db * Db;
  constexpr int PS = Db * CT;
  constexpr bool kPreload = IT <= 4;  // 2 * Db * IT doubles of E, F rows
  extern __shared__ __align__(16) double smem[];
  const int c = blockIdx.x;
  const int k0 = blockIdx.y * CT;
  const int nitem = Tp * Db;  // item w = i * Db + r

  for (int idx = threadIdx.x; idx < nitem * CT; idx += blockDim.x) {
    const int kk = idx % CT;
    const int w = idx / CT;
    const int k = k0 + kk;
    smem[idx] = (k < K) ? b[((long long)c * nitem + w) * K + k] : 0.0;
  }
  __syncthreads();

  double acc[IT][CT];
  for (int lev = 0; lev < L; ++lev) {
    const int s = 1 << lev;
    const long long base = ((long long)lev * nC + c) * Tp * BS;
    if constexpr (kPreload) {
      // Every load is unconditional (rows past the end read the last
      // item's; E, F rows whose neighbour lies outside the chain hold
      // zeros and are skipped below), so none waits for another.
      double2 m[IT][2][Db / 2];
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int w = min((int)(threadIdx.x + it * blockDim.x), nitem - 1);
        const long long row = base + (long long)w * Db;
#pragma unroll
        for (int q = 0; q < Db / 2; ++q) {
#ifndef BAND_NO_STAGING
          m[it][0][q] = ldg2(E + row + 2 * q);
          m[it][1][q] = ldg2(F + row + 2 * q);
#else
          m[it][0][q] = m[it][1][q] = make_double2(1.0, (double)row);
#endif
        }
      }
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int w = threadIdx.x + it * blockDim.x;
        const int i = w / Db;
#pragma unroll
        for (int k = 0; k < CT; ++k) acc[it][k] = 0.0;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int nb = side == 0 ? i - s : i + s;
          if (w < nitem && nb >= 0 && nb < Tp) {
            const double* bn = smem + nb * PS;
#pragma unroll
            for (int q = 0; q < Db / 2; ++q) {
#pragma unroll
              for (int k = 0; k < CT; ++k)
                acc[it][k] += m[it][side][q].x * bn[2 * q * CT + k];
#pragma unroll
              for (int k = 0; k < CT; ++k)
                acc[it][k] += m[it][side][q].y * bn[(2 * q + 1) * CT + k];
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < IT; ++it) {
#pragma unroll
        for (int k = 0; k < CT; ++k) acc[it][k] = 0.0;
        const int w = threadIdx.x + it * blockDim.x;
        if (w >= nitem) continue;
        const int i = w / Db;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int nb = side == 0 ? i - s : i + s;
          if (nb < 0 || nb >= Tp) continue;
          const double* M = (side == 0 ? E : F) + base + (long long)w * Db;
          const double* bn = smem + nb * PS;
#pragma unroll
          for (int j = 0; j < Db; j += 2) {
            const double2 mm = ldg2(M + j);
#pragma unroll
            for (int k = 0; k < CT; ++k) acc[it][k] += mm.x * bn[j * CT + k];
#pragma unroll
            for (int k = 0; k < CT; ++k)
              acc[it][k] += mm.y * bn[(j + 1) * CT + k];
          }
        }
      }
    }
    __syncthreads();  // every read of this level's input is done
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int w = threadIdx.x + it * blockDim.x;
      if (w >= nitem) continue;
#pragma unroll
      for (int k = 0; k < CT; ++k) smem[w * CT + k] += acc[it][k];
    }
    __syncthreads();
  }

#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int w = threadIdx.x + it * blockDim.x;
    if (w >= nitem) continue;
    const int i = w / Db;
    const double* V = invD + ((long long)c * nitem + w) * Db;
    const double* bi = smem + i * PS;
    double out[CT];
#pragma unroll
    for (int k = 0; k < CT; ++k) out[k] = 0.0;
#pragma unroll
    for (int j = 0; j < Db; j += 2) {
      const double2 mm = ldg2(V + j);
#pragma unroll
      for (int k = 0; k < CT; ++k) out[k] += mm.x * bi[j * CT + k];
#pragma unroll
      for (int k = 0; k < CT; ++k) out[k] += mm.y * bi[(j + 1) * CT + k];
    }
#pragma unroll
    for (int k = 0; k < CT; ++k)
      if (k0 + k < K) x[((long long)c * nitem + w) * K + k0 + k] = out[k];
  }
}

// Opt the kernel in to the shared memory it may ask for, once per kernel.
template <typename Kern>
cudaError_t allow_smem(Kern kern, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <int Db, int CT, int IT>
cudaError_t launch_narrow_it(const double* E, const double* F,
                             const double* invD, const double* b, double* x,
                             int nC, int Tp, int L, int K, int threads,
                             cudaStream_t st) {
  static bool allowed = false;
  cudaError_t err = allow_smem(pcr_solve_narrow_kernel<Db, CT, IT>, &allowed);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)Tp * Db * CT * sizeof(double);
  const dim3 grid(nC, (K + CT - 1) / CT);
  pcr_solve_narrow_kernel<Db, CT, IT><<<grid, threads, smem, st>>>(
      E, F, invD, b, x, nC, Tp, L, K);
  return cudaGetLastError();
}

template <int Db, int CT>
cudaError_t launch_narrow(const double* E, const double* F,
                          const double* invD, const double* b, double* x,
                          int nC, int Tp, int L, int K, cudaStream_t st) {
  constexpr int ITMAX = kNarrowAcc / CT;
  const size_t smem = (size_t)Tp * Db * CT * sizeof(double);
  // the fewest rounds of items that 512 threads allow, spread evenly
  const int nitem = Tp * Db;
  const int rounds = (nitem + kNarrowThreads - 1) / kNarrowThreads;
  if (rounds > ITMAX || smem > 232448) return cudaErrorInvalidValue;
  const int threads = (((nitem + rounds - 1) / rounds + 31) / 32) * 32;
  // one to four rounds: the kernel that loads a level's rows ahead; more
  // (chains longer than 256): the most rounds the accumulators allow
  switch (rounds) {
    case 1:
      return launch_narrow_it<Db, CT, 1>(E, F, invD, b, x, nC, Tp, L, K, threads, st);
    case 2:
      return launch_narrow_it<Db, CT, 2>(E, F, invD, b, x, nC, Tp, L, K, threads, st);
    case 3:
      return launch_narrow_it<Db, CT, 3>(E, F, invD, b, x, nC, Tp, L, K, threads, st);
    case 4:
      return launch_narrow_it<Db, CT, 4>(E, F, invD, b, x, nC, Tp, L, K, threads, st);
  }
  return launch_narrow_it<Db, CT, ITMAX>(E, F, invD, b, x, nC, Tp, L, K,
                                         threads, st);
}

template <int Db>
cudaError_t launch_wide(const double* E, const double* F, const double* invD,
                        const double* b, double* x, int nC, int Tp, int L,
                        int K, int G, cudaStream_t st) {
  static bool allowed = false;
  if (Tp > kWideMaxT || G < 1 || Tp * G > kWideMaxT)
    return cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kWideRing * Tp * (Db / 2) * Db +
       (size_t)Tp * (Db * G * kWideCols + 2)) * sizeof(double);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(pcr_solve_wide_kernel<Db>, &allowed);
  if (err != cudaSuccess) return err;
  const int W = G * kWideCols;
  const dim3 grid(nC, (K + W - 1) / W);
  const int threads = ((Tp * G + 31) / 32) * 32;
  pcr_solve_wide_kernel<Db><<<grid, threads, smem, st>>>(E, F, invD, b, x, nC,
                                                         Tp, L, K, G);
  return cudaGetLastError();
}

inline int grid_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* band_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int band_init_a(const double* U, double* A, int nC, int Tp, int Db,
                void* stream) {
  const long long n = (long long)nC * Tp * Db * Db;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Db) {
    case 6:
      init_a_kernel<6><<<grid_for(n, 256), 256, 0, st>>>(U, A, nC, Tp);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int band_block_inv(const double* D, double* invD, long long nblocks, int Db,
                   void* stream) {
  if (nblocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Db) {
    case 6:
      block_inv_kernel<6><<<grid_for(nblocks, 128), 128, 0, st>>>(D, invD,
                                                                  nblocks);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int band_pcr_level(const double* D, const double* A, const double* Cc,
                   const double* invD, double* E, double* F, double* D2,
                   double* A2, double* C2, double* invD2, int nC, int Tp,
                   int Db, int s, void* stream) {
  const long long n = (long long)nC * Tp;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int per_block = kLevelWarps * kPosPerWarp;
  switch (Db) {
    case 6:
      pcr_level_kernel<6><<<grid_for(n, per_block), kLevelWarps * 32, 0, st>>>(
          D, A, Cc, invD, E, F, D2, A2, C2, invD2, nC, Tp, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int band_cr_level(const double* D, const double* A, const double* Cc,
                  double* E, double* F, double* invDo, double* Ao, double* Co,
                  double* D2, double* A2, double* C2, int nC, int Th, int Db,
                  void* stream) {
  const long long n = (long long)nC * Th;
  if (n == 0) return 0;
  if (n > 0x3fffffff) return (int)cudaErrorInvalidValue;  // 2t + 1 as an int
  cudaStream_t st = (cudaStream_t)stream;
  switch (Db) {
    case 6:
      cr_level_kernel<6><<<grid_for(n, kCrPositions), kLevelWarps * 32, 0, st>>>(
          D, A, Cc, E, F, invDo, Ao, Co, D2, A2, C2, nC, Th);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int band_cr_reduce(const double* E, const double* F, const double* b,
                   double* out, int nC, int Th, int Db, int K, void* stream) {
  const long long n = (long long)nC * Th * Db * K;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Db) {
    case 6:
      cr_reduce_kernel<6><<<grid_for(n, 256), 256, 0, st>>>(E, F, b, out, nC,
                                                            Th, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int band_cr_backsub(const double* invDo, const double* Ao, const double* Co,
                    const double* b, const double* xe, double* x, int nC,
                    int Th, int Db, int K, void* stream) {
  const long long n = (long long)nC * Th * K;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Db) {
    case 6:
      cr_backsub_kernel<6><<<grid_for(n, 256), 256, 0, st>>>(
          invDo, Ao, Co, b, xe, x, nC, Th, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ct: columns of a thread's register tile, as ops/band.py chose them: 8
// runs the wide kernel with `groups` threads per position (8 * groups
// columns per block), 1, 2 or 4 the narrow one.
int band_pcr_solve(const double* E, const double* F, const double* invD,
                   const double* b, double* x, int nC, int Tp, int Db, int L,
                   int K, int ct, int groups, void* stream) {
  if (nC == 0 || K == 0 || Tp == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (Db != 6) return (int)cudaErrorInvalidValue;
  switch (ct) {
    case 8:
      return (int)launch_wide<6>(E, F, invD, b, x, nC, Tp, L, K, groups, st);
    case 4:
      return (int)launch_narrow<6, 4>(E, F, invD, b, x, nC, Tp, L, K, st);
    case 2:
      return (int)launch_narrow<6, 2>(E, F, invD, b, x, nC, Tp, L, K, st);
    case 1:
      return (int)launch_narrow<6, 1>(E, F, invD, b, x, nC, Tp, L, K, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
