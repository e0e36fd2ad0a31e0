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
// Kernels are templated on the block size Db and instantiated for Db = 6
// (2D pose blocks, [R | t] with R 2 x 2) and Db = 12 (3D, R 3 x 3); any
// other Db returns cudaErrorInvalidValue.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// The level pointers of band_cr_reduce and band_cr_backsub, passed to the
// C entries by value (ops/build.py mirrors them as ctypes structures).
constexpr int kCrMaxLevels = 10;  // levels a launch takes (ops/band.py)

struct CrReduceLevels {
  const double* E[kCrMaxLevels];  // level l: (C, T >> (l + 1), Db, Db)
  const double* F[kCrMaxLevels];
  double* out[kCrMaxLevels];      // b_{l+1}: (C, T >> (l + 1), Db, K)
};

struct CrBacksubLevels {
  const double* invD[kCrMaxLevels];  // level l's odd rows: (C, T >> (l + 1), Db, Db)
  const double* A[kCrMaxLevels];
  const double* C[kCrMaxLevels];
  const double* b[kCrMaxLevels];     // b_l, the level's fine rhs: (C, T >> l, Db, K)
};

// The plan of cr_reduce_tree_kernel (band._chain_plan, ops/build.py
// mirrors it): a tile stage of levels 1 .. top (top = 0: none, a chain a
// thread block) with tiles of P positions of level top, in chunks of Kf
// columns (the grid); then the whole chain from level top in chunks of Kc
// columns, its E, F staged in shared memory where `stage`.
struct CrReducePlan {
  int top;
  int P;
  int Kf;
  int Kc;
  int stage;
};

// The outputs of band_cr_factor's levels, level l: (C, T >> (l + 1), Db, Db)
// each, as band_cr_level returns them.
struct CrFactorLevels {
  double* E[kCrMaxLevels];
  double* F[kCrMaxLevels];
  double* invD[kCrMaxLevels];  // the odd rows' inverses
  double* A[kCrMaxLevels];     // the odd rows' couplings
  double* C[kCrMaxLevels];
};

namespace {

// The lane-group layout of the kernels that work on whole blocks
// (band_block_inv, band_pcr_level and band_cr_level at Db = 6, the narrow
// band_cr_backsub at both sizes): a group of `group` neighbouring lanes
// owns one position and lane r < Db of the group holds row r of every
// block. A group is 8 lanes for Db = 6 (4 groups a warp) and 16 for
// Db = 12 (2 a warp), so it stays inside a warp and its shuffles have a
// width of a power of two. The level kernels stage nine blocks per group
// in static shared memory, under 48 KB a thread block: 4 warps of 4 groups
// in band_pcr_level, and 16 groups of band_cr_level; 41,472 bytes each. At
// Db = 12 band_block_inv, band_pcr_level and band_cr_level have a layout
// of their own: a thread per block element (block_inv_element_kernel,
// pcr_level_element_kernel, cr_level_element_kernel).
template <int Db>
struct Lanes {
  static constexpr int group = Db <= 8 ? 8 : 16;   // lanes per position
  static constexpr int per_warp = 32 / group;      // positions per warp
  static constexpr int level_warps = 4;            // band_pcr_level, Db = 6
  static constexpr int cr_groups = 16;             // band_cr_level, Db = 6
};

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

// ---------------------------------------------------------------------
// band_pcr_level: one PCR level at shift s.
//
// Db = 6 (pcr_level_kernel). Mapping: a lane group of Lanes<Db>::group = 8
// lanes owns one position; lanes 0..Db-1 of the group each hold ONE ROW
// of every block in registers, the other lanes only help to move data. A
// power-of-two group (not Db lanes) keeps a group inside a warp, so the
// shuffles of the Cholesky need no index arithmetic, and gives the Db^2 / 2
// double2 of a block to the group as 16-byte accesses on neighbouring
// addresses (three per lane at Db = 6, four or five at Db = 12). The
// nine input blocks of a position (its own A, C, D and invD, C, A of
// i-s and invD, A, C of i+s) are staged in shared memory with cp.async,
// all in flight at once; a row-times-block product then reads the other
// block's rows as 16-byte broadcasts. The kernel takes inv(D) of its
// input and writes inv(D') of its output, so every block is inverted
// once per level: Cholesky across the group by shuffles, then lane c
// solves column c of L Y = I, L^T X = Y. Outputs go back through shared
// memory and leave as 16-byte coalesced stores. Arithmetic order is that
// of the plain PyTorch version (left-looking column Cholesky, products
// summed over k ascending). A thread block is Lanes<Db>::level_warps
// warps: 16 positions in 128 threads. Db = 12 runs
// pcr_level_element_kernel below.
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async.wait_group for a count known at run time: at most n of the
// thread's groups left in flight (n > 7 waits for 7 or fewer).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n <= 0 ? 0 : n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Waits on an mbarrier's phase. A wait that has not ended after ~2^32
// clocks (seconds) traps: a fault, never a hang.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One thread: a 1D bulk copy (TMA) of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from global to shared memory, completing on `bar`
// (whose expected transaction count the caller has raised).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ double2 ldg2(const double* p) {
  return __ldg(reinterpret_cast<const double2*>(p));
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
// with no block, and lanes Db and up, pass rows of the identity). Cholesky
// by shuffles of the group's width (lane r ends with row r of L), L
// through the shared block Lm, then lane c solves column c of L Y = I,
// L^T X = Y and writes it to the shared block inv. Lm and inv may be
// blocks whose reads by the group precede the call. The caller
// synchronises before inv is read.
template <int Db>
__device__ __forceinline__ void group_inv_spd(const double* Dv, double* Lm,
                                              double* inv, int r, bool row) {
  constexpr int GL = Lanes<Db>::group;
  double Lr[Db];
#pragma unroll
  for (int j = 0; j < Db; ++j) {
    double cj = Dv[j];
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const double ljk = __shfl_sync(0xffffffffu, Lr[k], j, GL);
      cj = cj - Lr[k] * ljk;
    }
    const double piv = sqrt(__shfl_sync(0xffffffffu, cj, j, GL));
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

// ---------------------------------------------------------------------
// band_block_inv: invD[b] = D[b]^{-1} for every SPD block b.
//
// Mapping (Db = 6; Db = 12 runs block_inv_element_kernel below): the
// lane-group layout, a group per block (16 blocks in a thread block of 128
// threads): lane r < Db loads row r of its block by 16-byte loads (the
// group's rows are the block, contiguous), the group inverts it with
// group_inv_spd, and the inverse leaves through shared memory as 16-byte
// stores. The kernel before this one gave a whole
// block to one thread: at Db = 6, 72 doubles of local arrays and a
// dependent chain of ~Db^3 operations per thread (14.2 us for 1,024 blocks
// on an H100); at Db = 12, 576 doubles a thread, past the registers.
// Bound: latency, of a launch and of the Cholesky's and substitutions'
// dependent f64 chains (2 blocks of traffic per position: 0.6 MB at
// Manhattan-4's 1,024 blocks, 0.2 us of HBM time).
// ---------------------------------------------------------------------

constexpr int kBlockInvThreads = 128;

template <int Db>
__global__ void __launch_bounds__(kBlockInvThreads)
block_inv_kernel(const double* __restrict__ D, double* __restrict__ invD,
                 long long nblocks) {
  constexpr int GL = Lanes<Db>::group;
  constexpr int NG = kBlockInvThreads / GL;  // blocks per thread block
  constexpr int BS = Db * Db;
  constexpr int V = BS / 2;  // double2 per block
  static_assert(Db % 2 == 0 && Db <= GL, "row-per-lane layout");
  __shared__ __align__(16) double sm[NG][2][BS];  // L, then the inverse
  const int q = threadIdx.x / GL;
  const int r = threadIdx.x & (GL - 1);
  const long long b = (long long)blockIdx.x * NG + q;
  const bool valid = b < nblocks;
  const bool row = r < Db;
  double Dv[Db];
  if (valid && row) {
    const double* src = D + b * BS + r * Db;
#pragma unroll
    for (int c = 0; c < Db; c += 2) {
      const double2 v = __ldg(reinterpret_cast<const double2*>(src + c));
      Dv[c] = v.x;
      Dv[c + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < Db; ++c) Dv[c] = (c == r) ? 1.0 : 0.0;
  }
  group_inv_spd<Db>(Dv, sm[q][0], sm[q][1], r, row);
  __syncwarp();
  if (valid) {
#pragma unroll
    for (int v = r; v < V; v += GL)
      *reinterpret_cast<double2*>(invD + b * BS + 2 * v) =
          *reinterpret_cast<const double2*>(&sm[q][1][2 * v]);
  }
}

template <int Db>
__global__ void __launch_bounds__(Lanes<Db>::level_warps * 32)
pcr_level_kernel(const double* __restrict__ D, const double* __restrict__ A,
                 const double* __restrict__ Cc,
                 const double* __restrict__ invD, double* __restrict__ E,
                 double* __restrict__ F, double* __restrict__ D2,
                 double* __restrict__ A2, double* __restrict__ C2,
                 double* __restrict__ invD2, int nC, int Tp, int s) {
  constexpr int GL = Lanes<Db>::group;
  constexpr int PW = Lanes<Db>::per_warp;
  constexpr int NW = Lanes<Db>::level_warps;
  static_assert(Db % 2 == 0 && Db <= GL, "row-per-lane layout");
  constexpr int BS = Db * Db;
  constexpr int V = BS / 2;  // double2 per block
  // [block slot][position of the warp][BS]; slots while reading:
  // 0 A_i, 1 C_i, 2 D_i, 3 invD_dn, 4 C_dn, 5 A_dn, 6 invD_up, 7 A_up,
  // 8 C_up; while writing: 0 E, 1 F, 2 D', 3 A', 4 C', 5 L, 6 invD'.
  __shared__ __align__(16) double sm[NW][9][PW][BS];

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) / GL;  // position of the warp
  const int r = threadIdx.x & (GL - 1);   // row held by this lane
  const long long t = (long long)blockIdx.x * (NW * PW) + threadIdx.x / GL;
  const bool valid = t < (long long)nC * Tp;
  const int i = valid ? (int)(t % Tp) : 0;
  const bool has_dn = valid && i - s >= 0;
  const bool has_up = valid && i + s < Tp;
  const bool row = r < Db;
  double(*my)[PW][BS] = sm[warp];

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
      for (int v = r; v < V; v += GL) {
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

  // Row r of slots 0, 1, 2 is read by lane r alone, so E and F go there as
  // soon as their products are done: fewer rows live in registers (at
  // Db = 12 a row is 24 registers).
  double Dv[Db], Av[Db], Cv[Db];
  if (row) {
    double p[Db], X[Db], acc[Db];
    // E = -A_i invD_{i-s};  A' = E A_{i-s};  D' gets E C_{i-s}
#pragma unroll
    for (int c = 0; c < Db; ++c) p[c] = my[0][g][r * Db + c];
    row_times_block<Db>(p, my[3][g], X);
#pragma unroll
    for (int c = 0; c < Db; ++c) X[c] = has_dn ? -X[c] : 0.0;
    row_times_block<Db>(X, my[5][g], Av);
    row_times_block<Db>(X, my[4][g], Dv);
#pragma unroll
    for (int c = 0; c < Db; ++c) my[0][g][r * Db + c] = X[c];
    // F = -C_i invD_{i+s};  C' = F C_{i+s};  D' gets F A_{i+s}
#pragma unroll
    for (int c = 0; c < Db; ++c) p[c] = my[1][g][r * Db + c];
    row_times_block<Db>(p, my[6][g], X);
#pragma unroll
    for (int c = 0; c < Db; ++c) X[c] = has_up ? -X[c] : 0.0;
    row_times_block<Db>(X, my[8][g], Cv);
    row_times_block<Db>(X, my[7][g], acc);
#pragma unroll
    for (int c = 0; c < Db; ++c) my[1][g][r * Db + c] = X[c];
    // D' = D_i + (E C_{i-s} + F A_{i+s})
#pragma unroll
    for (int c = 0; c < Db; ++c) {
      Dv[c] = my[2][g][r * Db + c] + (Dv[c] + acc[c]);
      my[2][g][r * Db + c] = Dv[c];
    }
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
      for (int v = r; v < V; v += GL)
        *reinterpret_cast<double2*>(dst[b] + 2 * v) =
            *reinterpret_cast<const double2*>(&my[slot[b]][g][2 * v]);
    }
  }
}

// ---------------------------------------------------------------------
// band_pcr_level at Db = 12: a thread per block element.
//
// Replaces pallas_pcr.py:_factor_level_kernel (:312) and, by two
// launches, _factor_level2_kernel (:338) at 12 x 12 blocks. What bounds
// it: latency. A level moves 10 blocks per position (0.9 us of HBM time
// at 3D 1x1000's 256-block remainder) and its work is a dependent chain:
// two products, two more that need their rows, a Cholesky and two
// substitutions. The lane-group layout gave a lane a whole row, so a
// lane ran six row-times-block products of 144 multiply-adds and a
// Cholesky by 66 dependent shuffles, with 2 warps on each SM, and its
// forward substitution also divided the exact zeros above each column's
// diagonal.
//
// Mapping: a position has Db * Db = 144 threads, thread (r, c) owning
// element (r, c) of every output; a thread block holds kLevelPositions = 1
// position (256 thread blocks at one chain of 256), and a register cap
// keeps kLevelBlocksPerSM of them on an SM. The nine input blocks of a
// position are staged in shared memory by 16-byte cp.async, all in flight
// at once. Each product element is one Db-term chain, k ascending from
// 0.0 as the plain version's matmul: E and F, a barrier, then A', C' and
// the two terms of D'. E, F, D', A' and C' leave from the registers that
// hold them, a block's 144 elements on neighbouring addresses, while D' is
// inverted by element_inv_spd (below), which makes group_inv_spd's
// operations in its order: element (r, j), r >= j, of the Cholesky is
// D'_rj minus L_rk L_jk for k ascending, over the square root of the pivot
// D'_jj minus L_jk^2 for k ascending. Thread (r, j) subtracts each term as
// column k lands (right-looking) and keeps its own copy of the pivot, made
// by the same operations as thread (j, j)'s, so a column takes one barrier
// over the block and a square root and a division on the chain. Thread
// c < Db then solves column c of L Y = I, L^T X = Y as group_inv_spd's
// lane c does, from its diagonal on and with its quotients by
// markstein_div: the same values, fewer dependent steps. band_cr_level and
// band_block_inv call the same function at Db = 12.
// ---------------------------------------------------------------------

// a / b, correctly rounded, from r = RN(1 / b) (a, b and the quotient
// normal, as the band's pivots and their solves are): q0 = RN(a r) is
// within 2 ulps; one correction RN(q + (a - b q) r), the remainder exact by
// an FMA, makes it faithful, and a second, by Markstein's theorem (q
// faithful, r within half an ulp of 1 / b), correctly rounded.
__device__ __forceinline__ double markstein_div(double a, double b, double r) {
  double q = __dmul_rn(a, r);
  q = __fma_rn(__fma_rn(-b, q, a), r, q);
  return __fma_rn(__fma_rn(-b, q, a), r, q);
}

// Inverse of an SPD Db x Db block by the Db * Db threads that own its
// elements: thread e = (r, c) passes a, element (r, c) of the block, and
// piv, its diagonal element (c, c). Lm and X are blocks of shared memory,
// rcp Db doubles of it; X holds the inverse after the caller's next block
// barrier. It holds block barriers: every thread of the thread block calls
// it, each group of Db * Db threads (e = 0 .. Db * Db - 1 in each) with a
// block of its own, and every thread belongs to a group. Called by
// pcr_level_element_kernel (D'), cr_level_element_kernel (the odd rows)
// and block_inv_element_kernel, so the three agree bit for bit.
//
// The Cholesky goes into Lm, a column a barrier. Thread (r, c), r >= c,
// holds a = D_rc and its own copy piv of the pivot D_cc and subtracts
// L_rk L_ck and L_ck L_ck as column k < c lands: group_inv_spd's
// operations in its left-looking order, k ascending, without its chain of
// j products between a column's barrier and its square root. Thread c < Db
// then solves column c of L Y = I, L^T X = Y in column c of X (X over Y:
// x_q needs y_q and x_k, k > q), group_inv_spd's operations in its order.
// y_q = +0 for q < c exactly (0 - L_qk * 0 = +0, then +0 / L_qq), and a
// term L_qk y_k with y_k = +0 leaves v as it was, so the thread starts at
// its diagonal: fewer dependent steps. A quotient v / L_qq is v * r_q
// corrected twice, r_q = 1 / L_qq rounded to nearest (__drcp_rn, formed by
// the diagonal's thread off the chain): the correctly rounded quotient the
// division gives (markstein_div), in five dependent operations where the
// division refines a reciprocal first. A measurement build with
// -DBAND_LEVEL_NO_INVERSE compiles the whole inversion out of the three
// kernels (profile_port.py prices it; X is then left as it was).
template <int Db>
__device__ __forceinline__ void element_inv_spd(double a, double piv, double* Lm,
                                                double* X, double* rcp, int e) {
#ifndef BAND_LEVEL_NO_INVERSE
  const int r = e / Db, col = e - r * Db;
#pragma unroll
  for (int k = 0; k < Db; ++k) {
    if (col == k && r >= k) Lm[r * Db + k] = a / sqrt(piv);
    __syncthreads();
    if (col > k && r >= col) {
      const double lck = Lm[col * Db + k];
      a = a - Lm[r * Db + k] * lck;
      piv = piv - lck * lck;
    }
  }
  if (e < Db) rcp[e] = __drcp_rn(Lm[e * Db + e]);
  __syncthreads();
  if (e < Db) {
    double* Y = X + e;
#pragma unroll
    for (int q = 0; q < Db; ++q) {
      if (q < e) {
        Y[q * Db] = 0.0;
      } else {
        double v = (q == e) ? 1.0 : 0.0;
#pragma unroll
        for (int k = 0; k < q; ++k)
          if (k >= e) v = v - Lm[q * Db + k] * Y[k * Db];
        Y[q * Db] = markstein_div(v, Lm[q * Db + q], rcp[q]);
      }
    }
#pragma unroll
    for (int q = Db - 1; q >= 0; --q) {
      double v = Y[q * Db];
#pragma unroll
      for (int k = q + 1; k < Db; ++k) v = v - Lm[k * Db + q] * Y[k * Db];
      Y[q * Db] = markstein_div(v, Lm[q * Db + q], rcp[q]);
    }
  }
#endif
}

constexpr int kLevelPositions = 1;
// thread blocks an SM must hold: a register cap (uncapped, ptxas gave a
// thread 206 registers and an SM one block)
constexpr int kLevelBlocksPerSM = 4;

template <int Db>
__global__ void __launch_bounds__(kLevelPositions * Db * Db, kLevelBlocksPerSM)
pcr_level_element_kernel(const double* __restrict__ D, const double* __restrict__ A,
                         const double* __restrict__ Cc,
                         const double* __restrict__ invD, double* __restrict__ E,
                         double* __restrict__ F, double* __restrict__ D2,
                         double* __restrict__ A2, double* __restrict__ C2,
                         double* __restrict__ invD2, int nC, int Tp, int s) {
  constexpr int BS = Db * Db;
  constexpr int V = BS / 2;  // double2 per block
  static_assert(BS % 2 == 0, "16-byte units, half a position's threads a block");
  // [position][block slot][BS]; slots while reading: 0 A_i, 1 C_i, 2 D_i,
  // 3 invD_dn, 4 C_dn, 5 A_dn, 6 invD_up, 7 A_up, 8 C_up; then 0 E, 1 F,
  // 2 D', 4 L, 5 invD'.
  __shared__ __align__(16) double sm[kLevelPositions][9][BS];

  const int g = threadIdx.x / BS;  // position of the thread block
  const int e = threadIdx.x - g * BS;
  const int r = e / Db, col = e - r * Db;
  const long long t = (long long)blockIdx.x * kLevelPositions + g;
  const bool valid = t < (long long)nC * Tp;
  const int i = valid ? (int)(t % Tp) : 0;
  const bool has_dn = valid && i - s >= 0;
  const bool has_up = valid && i + s < Tp;
  double(*my)[BS] = sm[g];

  {
    // thread e moves unit v of block 2m + half for m = 0..4 (BS = 2V
    // threads: a block's units to each half of the position's threads)
    const int half = e >= V, v = e - half * V;
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int b = 2 * m + half;
      if (b < 9) {
        const bool on = b < 3 ? valid : (b < 6 ? has_dn : has_up);
        const double* base = b == 2 ? D : (b == 3 || b == 6) ? invD
                            : (b == 0 || b == 5 || b == 7) ? A : Cc;
        const long long at = b < 3 ? t : (b < 6 ? t - s : t + s);
        double* dst = &my[b][2 * v];
        if (on) {
          cp_async16(dst, base + at * BS + 2 * v);
        } else {
          dst[0] = 0.0;
          dst[1] = 0.0;
        }
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // E = -A_i invD_{i-s};  F = -C_i invD_{i+s}
  double ev = 0.0, fv = 0.0;
#pragma unroll
  for (int k = 0; k < Db; ++k) {
    ev += my[0][r * Db + k] * my[3][k * Db + col];
    fv += my[1][r * Db + k] * my[6][k * Db + col];
  }
  ev = has_dn ? -ev : 0.0;
  fv = has_up ? -fv : 0.0;
  if (valid) {  // thread e stores element e: a block's 144 threads, contiguous
    E[t * BS + e] = ev;
    F[t * BS + e] = fv;
  }
  __syncthreads();  // every read of A_i, C_i and the neighbours' inverses is done
  my[0][e] = ev;
  my[1][e] = fv;
  __syncthreads();

  // A' = E A_{i-s};  C' = F C_{i+s};  D' = D_i + (E C_{i-s} + F A_{i+s})
  double a2 = 0.0, c2 = 0.0, d1 = 0.0, d2 = 0.0;
#pragma unroll
  for (int k = 0; k < Db; ++k) {
    const double ek = my[0][r * Db + k], fk = my[1][r * Db + k];
    a2 += ek * my[5][k * Db + col];
    d1 += ek * my[4][k * Db + col];
    c2 += fk * my[8][k * Db + col];
    d2 += fk * my[7][k * Db + col];
  }
  // a position past the end inverts the identity
  const double dp = valid ? my[2][e] + (d1 + d2) : (r == col ? 1.0 : 0.0);
  if (valid) {
    D2[t * BS + e] = dp;
    A2[t * BS + e] = a2;
    C2[t * BS + e] = c2;
  }
  my[2][e] = dp;    // slot 2 is read by thread e alone until this barrier
  __syncthreads();  // D' is whole; the neighbours' A and C are read

  // inv(D') into slot 5: L through slot 4, the reciprocals of its diagonal
  // through slot 6 (free after the products)
  element_inv_spd<Db>(dp, my[2][col * Db + col], my[4], my[5], my[6], e);
  __syncthreads();
  if (valid) invD2[t * BS + e] = my[5][e];
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
// Mapping (Db = 6; Db = 12 runs cr_level_element_kernel below): the
// lane-group layout of band_pcr_level. A thread block has NG lane groups
// (Lanes<Db>::cr_groups: 16 groups of 8 lanes): groups 1..NG-1 own
// consecutive coarse positions, and group 0 stands in for the position
// before them. Every
// group owns ONE odd row, 2t + 1 for its position t: it stages that row's
// D, A, C (and, groups 1..NG-1, the even row's) in shared memory by 16-byte
// cp.async, inverts the
// odd D with the group inversion it shares with band_pcr_level, and leaves
// the inverse in shared memory. After one block barrier a group takes
// F = -C_{2j} invD_{2j+1} from its own odd row and E = -A_{2j} invD_{2j-1}
// from the group before it, whose staged A, C it multiplies as well: every
// odd block is inverted once per thread block that uses it, all inversions
// of a thread block side by side, where a thread of the kernel before this
// one inverted both neighbours in its own dependent chain. Group 0 exists
// so that the first position's halo inverse does not double that position's
// chain (one inversion in NG is repeated). The outputs leave through
// shared memory as 16-byte stores; Ao, Co are the staged copies.
// Arithmetic order is that of the plain PyTorch version.
// Bound: 7 blocks of traffic per fine position pair (1.6 MB at
// Manhattan-4's first level, half a microsecond of HBM time), so latency
// bounds a launch: the dependent f64 chain of a Cholesky, two
// substitutions and two row-times-block products, 7.4-8.4 us a level on an
// NVIDIA H100 80GB HBM3 at 700 W (profile_port.py --factor). No factor
// runs it at Db = 6: band_cr_factor takes a factor's levels in one or two
// launches (below); band_cr_level's callers do.
// ---------------------------------------------------------------------

template <int Db>
__global__ void __launch_bounds__(Lanes<Db>::cr_groups * Lanes<Db>::group)
cr_level_kernel(const double* __restrict__ D, const double* __restrict__ A,
                const double* __restrict__ Cc, double* __restrict__ E,
                double* __restrict__ F, double* __restrict__ invDo,
                double* __restrict__ Ao, double* __restrict__ Co,
                double* __restrict__ D2, double* __restrict__ A2,
                double* __restrict__ C2, int nC, int Th) {
  constexpr int GL = Lanes<Db>::group;
  constexpr int NG = Lanes<Db>::cr_groups;  // one of them is the halo
  static_assert(Db % 2 == 0 && Db <= GL, "row-per-lane layout");
  constexpr int BS = Db * Db;
  constexpr int V = BS / 2;  // double2 per block
  // [group][block slot][BS]; slots: 0 D_odd, then L; 1 A_odd; 2 C_odd;
  // 3 D_even, then D'; 4 A_even, then E; 5 C_even, then F; 6 invD_odd;
  // 7 A'; 8 C'. The next group reads slots 6, 1, 2, which stay as they are.
  __shared__ __align__(16) double sm[NG][9][BS];

  const int q = threadIdx.x / GL;        // group of the block
  const int r = threadIdx.x & (GL - 1);  // row held by this lane
  const int n = nC * Th;
  // group 0: the position before the block's first, for its odd row only
  const int t = (int)blockIdx.x * (NG - 1) + q - 1;
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
        for (int v = r; v < V; v += GL)
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
      for (int v = r; v < V; v += GL)
        *reinterpret_cast<double2*>(dst[b] + 2 * v) =
            *reinterpret_cast<const double2*>(&my[slot[b]][2 * v]);
    }
  }
}

// ---------------------------------------------------------------------
// band_cr_level at Db = 12: a thread per block element.
//
// Replaces pallas_pcr.py:_cr_level_kernel (:362) at 12 x 12 blocks. What
// bounds it: latency. A level moves 7 blocks per pair of fine rows (2.5 us
// of HBM time at 3D 1x1000's first level, Th = 512) and its work is a
// dependent chain: the inverse of an odd block (a Cholesky and two
// substitutions), two products, a barrier and four more. The lane-group
// layout (cr_level_kernel, kept at Db = 6) gave a lane a whole row: each
// lane ran a Cholesky of 66 dependent shuffles, 24 IEEE divisions and six
// row-times-block products of 144 multiply-adds, in thread blocks of two
// warps.
//
// Mapping: a thread block owns P consecutive coarse positions t0 .. t0 +
// P - 1 (of all chains, laid end to end) and has P + 1 groups of Db * Db
// threads; thread e = (r, c) of a group owns element (r, c) of every block
// the group touches. Group g inverts odd row 2t + 1 of t = t0 + g - 1
// (group 0: the row before the first position, when that position has a
// lower neighbour in its chain), all groups side by side with
// element_inv_spd, each odd block once per thread block. Thread e reads
// elements (r, c) and (c, c) of its odd D, and element e of its position's
// even D, straight into registers; the blocks that the products read by
// rows and columns (the odd rows' A and C, the even row's A and C) are
// staged in shared memory by 16-byte cp.async, issued before the inversion
// and waited for after it. Then group g >= 1 takes E = -A_{2t} invD_{2t-1}
// (group g - 1's inverse) and F = -C_{2t} invD_{2t+1} (its own), a
// barrier, then A' = E A_{2t-1}, C' = F C_{2t+1} and D' = D_{2t} + (E
// C_{2t-1} + F A_{2t+1}); each element a Db-term chain, k ascending from
// 0.0 as the plain version's matmul. Every output leaves from the register
// that holds it, a block's 144 elements on neighbouring addresses. A
// register cap keeps kCrLevelThreadsPerSM threads on an SM.
//
// P, by level (band._cr_level_tile, passed at launch; the outputs are the
// same bits at every P): P = 1 (288 threads, four thread blocks an SM:
// every odd block inverted by two thread blocks) where a level has fewer
// than 1,024 positions, so that 3D 1x1000's first level fits the card at
// once; P = 3 (576 threads, two an SM: six positions an SM where P = 1
// holds four, one odd block in four inverted twice) from 1,024 positions,
// the 3D fold's first four levels, which take several waves. At the 3D
// fold's levels (C = 64; NVIDIA H100 80GB HBM3, 700 W; profile_port.py
// --factor) P = 3 took 112.4, 61.5, 32.5, 18.9 us against P = 1's 131.4,
// 68.8, 35.9, 19.6 from 8,192 down to 1,024 positions, and 12.6 against
// 11.3 at 512: the factor 269 us against 299. P = 2 and 4 hold four
// positions an SM, as P = 1, and were slower a factor (PERF.md). Every 3D
// factor runs it a level; band_cr_factor is built for Db = 6 only
// (band._factor_takes).
// ---------------------------------------------------------------------

constexpr int kCrLevelThreadsPerSM = 1152;

template <int Db, int P>
__global__ void __launch_bounds__((P + 1) * Db * Db, kCrLevelThreadsPerSM / ((P + 1) * Db * Db))
cr_level_element_kernel(const double* __restrict__ D, const double* __restrict__ A,
                        const double* __restrict__ Cc, double* __restrict__ E,
                        double* __restrict__ F, double* __restrict__ invDo,
                        double* __restrict__ Ao, double* __restrict__ Co,
                        double* __restrict__ D2, double* __restrict__ A2,
                        double* __restrict__ C2, int nC, int Th) {
  constexpr int BS = Db * Db;
  constexpr int V = BS / 2;  // double2 per block
  static_assert(BS % 2 == 0 && 1 <= P && (P + 1) * BS <= 1024, "groups of a thread block");
  static_assert(8 * ((2 * P + 1) * 4 * BS + (P + 1) * Db) <= 48 * 1024, "static shared memory");
  // [group][slot][BS]: 0 A_odd, 1 C_odd, 2 L, 3 inverse of D_odd
  __shared__ __align__(16) double odd[P + 1][4][BS];
  // [position][slot][BS]: 0 A_even, 1 C_even, 2 E, 3 F
  __shared__ __align__(16) double even[P][4][BS];
  __shared__ double rcp[P + 1][Db];

  const int g = threadIdx.x / BS;  // group of the thread block
  const int e = threadIdx.x - g * BS;
  const int r = e / Db, col = e - r * Db;
  const int n = nC * Th;
  const int t = (int)blockIdx.x * P + g - 1;
  const bool pos = g > 0 && t < n;  // group g owns coarse position t
  // odd row 2t + 1 is wanted: by its owner, or by the thread block's first
  // position when that has a lower neighbour in its chain
  const bool odd_on = g > 0 ? pos : (t >= 0 && t + 1 < n && (t + 1) % Th != 0);
  const bool has_dn = pos && t % Th != 0;  // odd row 2t - 1, group g - 1's
  const long long o = (long long)t * BS;   // coarse block t; fine rows 2t, 2t + 1

  // thread e moves unit v of A (e < V) or of C (e >= V), of the odd row and
  // of the even row
  const int half = e >= V, v = e - half * V;
  const double* AC = half ? Cc : A;
  if (odd_on) cp_async16(&odd[g][half][2 * v], AC + 2 * o + BS + 2 * v);
  if (pos) cp_async16(&even[g - 1][half][2 * v], AC + 2 * o + 2 * v);
  // an odd row nobody wants is the identity
  double a = r == col ? 1.0 : 0.0, piv = 1.0, dev = 0.0;
  if (odd_on) {
    a = __ldg(D + 2 * o + BS + e);
    piv = __ldg(D + 2 * o + BS + col * Db + col);
  }
  if (pos) dev = __ldg(D + 2 * o + e);

  element_inv_spd<Db>(a, piv, odd[g][2], odd[g][3], rcp[g], e);
  cp_async_wait_all();
  __syncthreads();  // every inverse and every staged block is in place

  double(*my)[BS] = even[g > 0 ? g - 1 : 0];
  if (pos) {
    // E = -A_{2t} invD_{2t-1};  F = -C_{2t} invD_{2t+1}
    const double* Xdn = odd[g - 1][3];
    const double* Xup = odd[g][3];
    double ev = 0.0, fv = 0.0;
#pragma unroll
    for (int k = 0; k < Db; ++k) {
      ev += my[0][r * Db + k] * Xdn[k * Db + col];
      fv += my[1][r * Db + k] * Xup[k * Db + col];
    }
    ev = has_dn ? -ev : 0.0;
    fv = -fv;
    my[2][e] = ev;
    my[3][e] = fv;
    E[o + e] = ev;
    F[o + e] = fv;
    invDo[o + e] = Xup[e];
    Ao[o + e] = odd[g][0][e];
    Co[o + e] = odd[g][1][e];
  }
  __syncthreads();  // E and F are whole
  if (pos) {
    // A' = E A_{2t-1};  C' = F C_{2t+1};  D' = D_{2t} + (E C_{2t-1} + F A_{2t+1})
    const double(*dn)[BS] = odd[g - 1];
    const double(*up)[BS] = odd[g];
    double a2 = 0.0, c2 = 0.0, d1 = 0.0, d2 = 0.0;
#pragma unroll
    for (int k = 0; k < Db; ++k) {
      const double fk = my[3][r * Db + k];
      c2 += fk * up[1][k * Db + col];
      d2 += fk * up[0][k * Db + col];
    }
    if (has_dn) {  // else E is zero, and group g - 1 may hold no odd row
#pragma unroll
      for (int k = 0; k < Db; ++k) {
        const double ek = my[2][r * Db + k];
        a2 += ek * dn[0][k * Db + col];
        d1 += ek * dn[1][k * Db + col];
      }
    }
    D2[o + e] = dev + (d1 + d2);
    A2[o + e] = a2;
    C2[o + e] = c2;
  }
}

// ---------------------------------------------------------------------
// band_block_inv at Db = 12: a thread per block element.
//
// Replaces pallas_pcr.py:_block_inv_kernel (:423) at 12 x 12 blocks.
// Bound by latency: a launch, one read of a block and the dependent chain
// of element_inv_spd (2 blocks of traffic per block: 0.18 us of HBM time
// at 3D 1x1000's 256 blocks). The lane-group layout (block_inv_kernel,
// kept at Db = 6) put 8 blocks in a thread block, so 256 blocks filled 32
// of the 132 SMs, and a lane ran the whole Cholesky by 66 dependent
// shuffles and 24 IEEE divisions. Here a thread block is one block of 144
// threads: thread e = (r, c) reads elements (r, c) and (c, c) straight
// into registers (the block's 144 threads on neighbouring addresses),
// element_inv_spd inverts it, and thread e writes element e of the
// inverse. A register cap keeps kInvThreadsPerSM threads on an SM.
// ---------------------------------------------------------------------

constexpr int kInvThreadsPerSM = 1152;

template <int Db>
__global__ void __launch_bounds__(Db * Db, kInvThreadsPerSM / (Db * Db))
block_inv_element_kernel(const double* __restrict__ D, double* __restrict__ invD) {
  constexpr int BS = Db * Db;
  __shared__ __align__(16) double sm[2][BS];  // L, the inverse
  __shared__ double rcp[Db];
  const int e = threadIdx.x;
  const int col = e % Db;
  const long long o = (long long)blockIdx.x * BS;
  element_inv_spd<Db>(__ldg(D + o + e), __ldg(D + o + col * Db + col), sm[0], sm[1], rcp, e);
  __syncthreads();
  invD[o + e] = sm[1][e];
}

// ---------------------------------------------------------------------
// band_cr_factor: a run of n compacting CR levels in ONE launch and, where
// the run ends at one position a chain, the inverse of that block. Built
// for Db = 6 (kFactorBlock) only: the 3D factor runs band_cr_level a level.
//
// Replaces pallas_pcr.py:_cr_level_kernel (:362), which the TPU caller
// launched once a level (:606-620), and, on the factor's path,
// _block_inv_kernel (:423): the run's last level inverts the one block a
// chain it leaves. What bounds it on the card: not bytes. A factor reads D,
// A, C once and writes every level's E, F, invD, A, C and the last invD
// once: 1.4 us of HBM time on Manhattan-4's band, 1.75 on robot20's and
// 17.5 at the 2D fold (3.35 TB/s, NVIDIA H100 80GB HBM3 at 700 W). Its
// time is the dependent chain of its levels: a level inverts its odd
// blocks (a Cholesky and two substitutions), then E, F and from them A',
// C', D', which the next level inverts. The per-level kernel before this
// one (cr_level_kernel, kept for band_cr_level) paid a launch and a round
// trip of D', A', C' through HBM a level: 7.4-8.4 us a level up to 2,048
// positions, and band_block_inv 5.5-6.4 us after the last (that card;
// profile_port.py --factor).
//
// Mapping: a thread block owns a tile of P consecutive positions of the
// run's coarsest level (level n) of one chain and stages the D, A, C of
// every fine row they depend on in shared memory by 16-byte cp.async: the
// tile's 2^n P rows and the left halo of 2^n - 1 rows (none before the
// chain's start). The levels run there, in place: level l's position p in
// the slot of fine row p << l, its odd rows at (2q + 1) << (l - 1). A
// level (1) inverts all its odd blocks side by side in place over their D,
// a group of Db threads a block (row_inv_spd: 48 blocks a pass), each odd
// block once a thread block, (2) a thread per row and 2 columns of a
// position's blocks forms E and F, Db-term chains on 16-byte loads, which
// go over the even row's A and C, and (3) A' = E A_{2p-1}, C' = F C_{2p+1}
// and D' = D_{2p} + (E C_{2p-1} + F A_{2p+1}) go over the even row's A, C
// and D; positions in passes of 16, three block barriers a pass. The tile
// also computes the halo's positions (2^(n-l) - 1 at level l), so that a
// level reads nothing from another thread block; only its own positions'
// E, F, invD, A, C leave, by 16-byte stores. Then the own positions' D',
// A', C' leave for the next run, or, where the run ends at one position a
// chain (P = 1, the whole chain, no halo), the thread block inverts that
// D' with the function band_block_inv calls (group_inv_spd) and writes
// invD. ops/band.py plans the runs (band._factor_runs: at most two
// launches a factor on the cells, by Tp alone) and the tile
// (band._factor_tile).
//
// Measured (that card, profile_port.py --factor, PERF.md §6): the 2D
// factors take 0.52-0.54x the per-level kernels' time on Manhattan-4 and
// robot20 and 0.93x at the 2D fold. A Db = 12 build (a row and 4 columns a
// thread, element_inv_spd for the last block) measured slower than
// band_cr_level a level on the 3D solves' bands (a 12 x 12 row inversion
// ~6.5 us a level in one SM, products ~0.6 us a position) and was taken
// out. Sums run in the plain version's order (products k ascending from
// 0.0, the inversion in group_inv_spd's); only nvcc's contraction to FMAs
// differs.
// ---------------------------------------------------------------------

// the block size it is built for, and the threads of a thread block: 48
// inversion groups and 16 positions a products pass (576 threads, one
// block an SM, measured slower at every 2D cell: PERF.md)
constexpr int kFactorBlock = 6;
constexpr int kFactorThreads = 288;

// Inverse of an SPD Db x Db block in place by a group of Db threads, a
// thread a row: on entry the shared block X holds it, after the caller's
// next block barrier its inverse. The Cholesky goes over X's lower
// triangle a column per block barrier: thread r keeps a copy of each pivot
// D_cc it needs (c <= r) and subtracts L_rk L_ck and L_ck L_ck as column k
// lands, element_inv_spd's operations in its order; the diagonal's thread
// leaves 1 / L_kk rounded to nearest in the upper triangle (rcp_slot).
// Thread c solves column c of L Y = I in registers as element_inv_spd's
// thread c does, row k of Y right after column k lands (off the
// Cholesky's chain: its threads c <= k have no pivot left to form), then
// L^T X = Y, the quotients by markstein_div, and writes X over L after a
// barrier. So the inverse is element_inv_spd's, bit for bit, with no
// scratch and a twelfth of its threads. Every thread of the thread block
// calls it (it holds block barriers); a group with no block passes on =
// false and reads and writes nothing. -DBAND_LEVEL_NO_INVERSE compiles it
// out.
template <int Db>
__device__ __forceinline__ int rcp_slot(int k) {
  return k + 1 < Db ? k * Db + k + 1 : Db - 1;  // (k, k + 1), and (0, Db - 1) for the last
}

template <int Db>
__device__ __forceinline__ void row_inv_spd(double* X, int r, bool on) {
#ifndef BAND_LEVEL_NO_INVERSE
  double a[Db], piv[Db], y[Db];
#pragma unroll
  for (int c = 0; c < Db; ++c) {
    a[c] = on && c <= r ? X[r * Db + c] : 0.0;
    piv[c] = on && c <= r ? X[c * Db + c] : 1.0;
    y[c] = 0.0;
  }
  __syncthreads();  // every group has read its block: L goes over it
#pragma unroll
  for (int k = 0; k < Db; ++k) {
    if (on && r >= k) {
      const double l = a[k] / sqrt(piv[k]);
      X[r * Db + k] = l;
      if (r == k) X[rcp_slot<Db>(k)] = __drcp_rn(l);
    }
    __syncthreads();
    if (on && r <= k) {  // row k of Y, column r
      double v = (k == r) ? 1.0 : 0.0;
#pragma unroll
      for (int j = 0; j < k; ++j)
        if (j >= r) v = v - X[k * Db + j] * y[j];
      y[k] = markstein_div(v, X[k * Db + k], X[rcp_slot<Db>(k)]);
    }
    if (on && r > k) {
      const double lrk = X[r * Db + k];
#pragma unroll
      for (int c = k + 1; c < Db; ++c) {
        if (c <= r) {
          const double lck = X[c * Db + k];
          a[c] = a[c] - lrk * lck;
          piv[c] = piv[c] - lck * lck;
        }
      }
    }
  }
  if (on) {
#pragma unroll
    for (int q = Db - 1; q >= 0; --q) {
      double v = y[q];
#pragma unroll
      for (int k = q + 1; k < Db; ++k) v = v - X[k * Db + q] * y[k];
      y[q] = markstein_div(v, X[q * Db + q], X[rcp_slot<Db>(q)]);
    }
  }
  __syncthreads();  // every group has read its L: the inverse goes over it
  if (on) {
#pragma unroll
    for (int q = 0; q < Db; ++q) X[q * Db + r] = y[q];
  }
#endif
}

// Rows of a tile of P positions of level n, the left halo included (the
// whole chain of T where the tile is the chain), and the shared memory of
// its thread block: the rows' D, A and C, and where the run ends at one
// position a chain (last) the final inversion's scratch, a block each for
// the L and the inverse of group_inv_spd's group 0 (band._factor_smem
// mirrors it).
__host__ __device__ inline int cr_factor_rows(int n, int T, int P) {
  return P == (T >> n) ? T : (P << n) + (1 << n) - 1;
}

inline long long cr_factor_smem(int n, int T, int P, int Db, bool last) {
  long long d = 3LL * cr_factor_rows(n, T, P) * Db * Db;
  if (last) d += 2 * Db * Db;
  return d * (long long)sizeof(double);
}

// CW doubles at x to v, from v to p, from x to p, by 16-byte accesses
// (x, p 16-byte aligned)
template <int CW>
__device__ __forceinline__ void load_units(const double* x, double* v) {
#pragma unroll
  for (int j = 0; j < CW; j += 2) {
    const double2 u = *reinterpret_cast<const double2*>(x + j);
    v[j] = u.x;
    v[j + 1] = u.y;
  }
}

template <int CW>
__device__ __forceinline__ void store_units(double* p, const double* v) {
#pragma unroll
  for (int j = 0; j < CW; j += 2)
    *reinterpret_cast<double2*>(p + j) = make_double2(v[j], v[j + 1]);
}

template <int CW>
__device__ __forceinline__ void copy_units(double* p, const double* x) {
#pragma unroll
  for (int j = 0; j < CW; j += 2)
    *reinterpret_cast<double2*>(p + j) = *reinterpret_cast<const double2*>(x + j);
}

#ifdef BAND_FACTOR_CLOCKS
// thread 0 of thread block 0: 0 start, 1 rows staged, 2 + 2 (l - 1) level
// l's odd blocks inverted, 3 + 2 (l - 1) its products, 31 end; written as
// SM cycles since the start over its first level's E (a measurement build)
#define FACTOR_CLOCK(i) \
  if (threadIdx.x == 0 && blockIdx.x == 0) clk[i] = clock64();
#else
#define FACTOR_CLOCK(i)
#endif

// two thread blocks an SM
template <int Db, int NT>
__global__ void __launch_bounds__(NT, 2)
cr_factor_kernel(const double* __restrict__ D, const double* __restrict__ A,
                 const double* __restrict__ Cc, const CrFactorLevels lv,
                 double* __restrict__ D2, double* __restrict__ A2, double* __restrict__ C2,
                 double* __restrict__ invDn, int n, int T, int P) {
  constexpr int BS = Db * Db;
  // the products' register tile: a row and CW columns of a block a thread
  // (one 16-byte unit), so that each element of a row block read from
  // shared memory serves CW products (the reads, not the multiply-adds,
  // bound the products; three rows a thread read less but spilled and took
  // 5-10 % longer a factor: PERF.md)
  constexpr int CW = 2;
  constexpr int CQ = Db / CW;       // column groups of a block
  constexpr int TP = CQ * Db;       // threads of a position in the products
  constexpr int PP = NT / TP;       // positions a products pass
  constexpr int NG = NT / Db;       // inversion groups
  static_assert(NT % BS == 0 && NT % 32 == 0 && Db % CW == 0 && NT % TP == 0,
                "groups of the thread block");
#ifdef BAND_FACTOR_CLOCKS
  long long clk[32] = {};
#endif
  FACTOR_CLOCK(0)
  extern __shared__ __align__(16) double sm[];
  const int rows = cr_factor_rows(n, T, P);
  double* Ds = sm;
  double* As = Ds + (long long)rows * BS;
  double* Cs = As + (long long)rows * BS;
  const int Tn = T >> n, tiles = Tn / P;
  const int c = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - c * tiles) * P;
  const int span = 1 << n;
  const int lo = max(0, span * j0 - (span - 1));  // the tile's first fine row
  {
    const long long o = ((long long)c * T + lo) * BS;
    const int units = (span * (j0 + P) - lo) * (BS / 2);
    for (int u = threadIdx.x; u < units; u += NT) {
      cp_async16(Ds + 2 * u, D + o + 2 * u);
      cp_async16(As + 2 * u, A + o + 2 * u);
      cp_async16(Cs + 2 * u, Cc + o + 2 * u);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  FACTOR_CLOCK(1)
  const int g = threadIdx.x / Db, r = threadIdx.x - g * Db;  // inversion group and row
  const int pg = threadIdx.x / TP, w = threadIdx.x - pg * TP;  // position of a pass
  const int r0 = w / CQ, c0 = (w % CQ) * CW;  // its row and first column
  for (int l = 1; l <= n; ++l) {
    const int wl = n - l, step = 1 << (l - 1);
    const int plo = max(0, (j0 << wl) - ((1 << wl) - 1)), phi = ((j0 + P) << wl) - 1;
    const int own = j0 << wl;
    const long long Th = T >> l;
    // (1) the odd rows 2q + 1 of level l - 1 that positions plo .. phi read
    const int q0 = plo > 0 ? plo - 1 : 0, nq = phi - q0 + 1;
    for (int i0 = 0; i0 < nq; i0 += NG) {
      const bool on = i0 + g < nq;
      const int q = q0 + (on ? i0 + g : 0);
      row_inv_spd<Db>(Ds + (long long)((2 * q + 1) * step - lo) * BS, r, on);
    }
    __syncthreads();
    FACTOR_CLOCK(2 + 2 * (l - 1))
    // (2) E, F; (3) A', C', D': row r0, columns c0 .. c0 + CW - 1 of a
    // position
    for (int p0 = plo; p0 <= phi; p0 += PP) {
      const bool on = p0 + pg <= phi;
      const int p = on ? p0 + pg : plo;
      const bool dn = p > 0;  // has an odd row below in its chain
      const long long ie = (long long)(2 * p * step - lo) * BS + r0 * Db;  // the even row's row r0
      const long long iu = (long long)((2 * p + 1) * step - lo) * BS + c0;  // the odd rows' columns
      const long long id = dn ? iu - 2LL * step * BS : iu;
      double ev[CW] = {}, fv[CW] = {};
      if (on) {
#pragma unroll
        for (int k = 0; k < Db; ++k) {
          double xu[CW], xd[CW];
          load_units<CW>(Ds + iu + k * Db, xu);
          load_units<CW>(Ds + id + k * Db, xd);
          const double ck = Cs[ie + k], ak = As[ie + k];
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            fv[j] += ck * xu[j];
            ev[j] += ak * xd[j];
          }
        }
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          fv[j] = -fv[j];
          ev[j] = dn ? -ev[j] : 0.0;
        }
        if (p >= own) {
          const long long o = (c * Th + p) * BS + r0 * Db + c0, u = iu + r0 * Db;
          store_units<CW>(lv.E[l - 1] + o, ev);
          store_units<CW>(lv.F[l - 1] + o, fv);
          copy_units<CW>(lv.invD[l - 1] + o, Ds + u);
          copy_units<CW>(lv.A[l - 1] + o, As + u);
          copy_units<CW>(lv.C[l - 1] + o, Cs + u);
        }
      }
      __syncthreads();  // the pass's even rows' A and C are read
      if (on) {
        store_units<CW>(As + ie + c0, ev);
        store_units<CW>(Cs + ie + c0, fv);
      }
      __syncthreads();  // E and F are whole
      double a2[CW] = {}, c2[CW] = {}, d1[CW] = {}, d2[CW] = {};
      if (on) {  // (E is zero where the position has no odd row below)
#pragma unroll
        for (int k = 0; k < Db; ++k) {
          double cu[CW], au[CW], ad[CW], cd[CW];
          load_units<CW>(Cs + iu + k * Db, cu);
          load_units<CW>(As + iu + k * Db, au);
          load_units<CW>(As + id + k * Db, ad);
          load_units<CW>(Cs + id + k * Db, cd);
          const double fk = Cs[ie + k], ek = As[ie + k];
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            c2[j] += fk * cu[j];
            d2[j] += fk * au[j];
            a2[j] += ek * ad[j];
            d1[j] += ek * cd[j];
          }
        }
      }
      __syncthreads();  // E and F are read
      if (on) {
        double dv[CW];
        load_units<CW>(Ds + ie + c0, dv);
#pragma unroll
        for (int j = 0; j < CW; ++j) dv[j] = dv[j] + (d1[j] + d2[j]);
        store_units<CW>(Ds + ie + c0, dv);
        store_units<CW>(As + ie + c0, a2);
        store_units<CW>(Cs + ie + c0, c2);
      }
    }
    __syncthreads();
    FACTOR_CLOCK(3 + 2 * (l - 1))
  }
  if (invDn != nullptr) {
    // the chain's one position, at row 0: its inverse, by band_block_inv's
    // function, in the scratch after the rows. The other groups invert a
    // block of ones plus the identity, whose quotients all stay on the f64
    // division's fast path (an identity's zero numerators take its slow
    // path); their results are not read.
    double* fin = Cs + (long long)rows * BS;
    constexpr int GL = Lanes<Db>::group;
    const int lr = threadIdx.x & (GL - 1);
    const bool row = threadIdx.x < GL && lr < Db;
    double Dv[Db];
#pragma unroll
    for (int k = 0; k < Db; ++k) Dv[k] = row ? Ds[lr * Db + k] : (k == lr ? 2.0 : 1.0);
    group_inv_spd<Db>(Dv, fin, fin + BS, lr, row);
    __syncthreads();
    for (int u = threadIdx.x; u < BS; u += NT) invDn[(long long)c * BS + u] = fin[BS + u];
  } else {
    // the own positions of level n leave for the next run
    for (int u = threadIdx.x; u < P * BS; u += NT) {
      const int j = u / BS, f = u - j * BS;
      const long long i = (long long)(((j0 + j) << n) - lo) * BS + f;
      const long long o = ((long long)c * Tn + j0 + j) * BS + f;
      D2[o] = Ds[i];
      A2[o] = As[i];
      C2[o] = Cs[i];
    }
  }
  FACTOR_CLOCK(31)
#ifdef BAND_FACTOR_CLOCKS
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == 0)
    for (int i = 0; i < 32; ++i) lv.E[0][i] = (double)(clk[i] ? clk[i] - clk[0] : -1);
#endif
}

// ---------------------------------------------------------------------
// band_cr_reduce and band_cr_backsub: every compacting level of a solve in
// ONE launch each. The TPU caller launched _cr_reduce_kernel and
// _cr_backsub_kernel once a level (pallas_pcr.py:770-810) only because its
// kernels are gridless; the kernels before these did the same, and each
// level's rhs made a round trip through HBM.
//
// Level l (0-based, fine -> coarse) halves the chain, T >> l rows in,
// Th = T >> (l + 1) out; its blocks E, F, invD, A, C are (C, Th, Db, Db):
//   reduce   b_{l+1}[j] = b_l[2j] + (E_j b_l[2j-1] + F_j b_l[2j+1])
//   backsub  x_l[2j] = x_{l+1}[j],
//            x_l[2j+1] = invD_j ((b_l[2j+1] - A_j x_{l+1}[j]) - C_j x_{l+1}[j+1])
// (no E term at a chain's first position, no C term at its last).
//
// Two designs, by where the run ends (ops/band.py routes):
//   - a run that ends at more than one position a chain (a schedule that
//     stops above one block a chain, and the first run of a chain longer
//     than 2^kCrMaxLevels): the tile kernels below. A thread block owns a
//     tile of P consecutive positions of the coarsest level (depth n) of
//     one chain and a chunk of Kc rhs columns (grid y); band._cr_plan plans
//     (P, Kc) so that the grid covers the card's SMs where the chain allows
//     and the shared memory stays small enough for several blocks an SM.
//     The reduce's tile is also each tile stage of the tree reduce;
//   - a run that ends at ONE position a chain (a band-solve pass at the
//     default schedule, whole on chains of up to 2^kCrMaxLevels): the chain
//     kernels (cr_reduce_tree_kernel, cr_backsub_chain_kernel, further
//     down), one launch each way at both block sizes.
// A tile's dependencies between levels are local:
//   - reduce: coarsest position j reads the fine rows 2^n j - (2^n - 1) ..
//     2^n j + 2^n - 1, so a tile reads its own 2^n P fine rows and a left
//     halo of 2^n - 1 rows (none before a chain's start); at level l + 1 it
//     also computes the 2^(n-l-1) - 1 positions before its own, which the
//     tile before owns (recomputed from the halo, never written);
//   - backsub: a tile's 2^n P fine rows need, besides its own coarsest
//     solution, only the coarsest solution at the position after the tile
//     (none past a chain's end), at every level.
// Intermediate levels stay in shared memory: the reduce writes each level's
// own rows once to HBM (the back substitution reads their odd rows, the
// PCR solve the last level), the back substitution writes only the finest
// x. Arithmetic order is the plain per-level version's: each block product
// summed over q ascending from 0.0, b[2j] + (E b + F b), (b - A x) - C x;
// only nvcc's contraction to FMAs differs.
// ---------------------------------------------------------------------

// threads of a thread block, at most: the reduce holding Db rows a thread
// and the register-step backsub; the reduce at a row a thread; the element
// backsub
constexpr int kCrThreads = 256;
constexpr int kCrReduceRowThreads = 1024;
constexpr int kCrElementThreads = 512;
constexpr int kBacksubNarrowK = 4;  // most rhs columns of the narrow step
constexpr int kBacksubNarrowThreads = 64;  // one level's narrow kernel: 8 positions (Db = 6) or 4
constexpr int kBacksubWideThreads = 256;
// band_cr_reduce's layouts, by the rhs width: a thread per (output row,
// column) below kReduceRegisterRowsK, a thread per (position, column)
// holding the Db rows in registers from it (-DBAND_CR_REGISTER_ROWS_K=n
// moves the edge in measurement builds of profile_port.py --kernels).
#ifndef BAND_CR_REGISTER_ROWS_K
#define BAND_CR_REGISTER_ROWS_K 8
#endif
constexpr int kReduceRegisterRowsK = BAND_CR_REGISTER_ROWS_K;
// rows of a column a thread of the element backsub (Db = 12) holds:
// 3 measured fastest at 3D 1x1000's panel (profile_port.py --kernels times
// a thread per row, -DBAND_CR_ELEMENT_ROWS=1, beside it)
#ifndef BAND_CR_ELEMENT_ROWS
#define BAND_CR_ELEMENT_ROWS 3
#endif
constexpr int kBacksubElementRows = BAND_CR_ELEMENT_ROWS;
// -DBAND_CR_CLOCKS: thread 0 of the first blocks records clock64() at the
// phases of a launch and writes them over its output (measurement builds)
#ifdef BAND_CR_CLOCKS
#define CR_CLOCK(i) \
  if (threadIdx.x == 0) clk[i] = clock64();
#define CR_CLOCKS_OUT(dst)                                                      \
  __syncthreads();                                                             \
  if (threadIdx.x == 0 && blockIdx.x < 4 && blockIdx.y == 0)                   \
    for (int i = 0; i < 16; ++i) (dst)[blockIdx.x * 16 + i] = (double)(clk[i] - clk[0]);
#else
#define CR_CLOCK(i)
#define CR_CLOCKS_OUT(dst)
#endif

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa), "l"(gmem));
}

// Copies n doubles (n even, both ends 16-byte aligned) by the block's
// threads, 16-byte cp.async units on neighbouring addresses.
__device__ __forceinline__ void stage_span(double* dst, const double* src, int n) {
  for (int u = threadIdx.x; u < n / 2; u += blockDim.x) cp_async16(dst + 2 * u, src + 2 * u);
}

// Copies `rows` rhs rows by the block's threads with cp.async. In HBM a row
// is Db lines of K doubles, rows src_stride doubles apart, and the chunk is
// kc columns from src; in shared memory lines are Kc doubles, rows
// dst_stride apart. Units: 16 bytes over a whole row where the chunk is
// every column (a row is Db * K doubles, an even count, 16-byte aligned),
// 16 bytes a line where K and Kc are even, else 8 bytes.
__device__ void stage_rhs(double* dst, int dst_stride, const double* src,
                          long long src_stride, int rows, int Db, int K, int Kc,
                          int kc) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (kc == K) {
    const int per = Db * K / 2;
    for (int u = t; u < rows * per; u += nt) {
      const int r = u / per, v = 2 * (u - r * per);
      cp_async16(dst + r * dst_stride + v, src + r * src_stride + v);
    }
  } else if (K % 2 == 0 && Kc % 2 == 0) {
    const int per = kc / 2;
    for (int u = t; u < rows * Db * per; u += nt) {
      const int l = u / per, v = 2 * (u - l * per);
      const int r = l / Db, q = l - r * Db;
      cp_async16(dst + r * dst_stride + q * Kc + v, src + r * src_stride + (long long)q * K + v);
    }
  } else {
    for (int u = t; u < rows * Db * kc; u += nt) {
      const int l = u / kc, v = u - l * kc;
      const int r = l / Db, q = l - r * Db;
      cp_async8(dst + r * dst_stride + q * Kc + v, src + r * src_stride + (long long)q * K + v);
    }
  }
}

// acc[i] += sum_q M[i][q] * v[q] for R rows of M (row-major, Db wide, in
// shared memory, 16-byte aligned), q ascending; acc starts at 0.0.
template <int Db, int R>
__device__ __forceinline__ void rows_times_col(const double* M, const double* v,
                                               double* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int q = 0; q < Db; q += 2) {
      const double2 m = *reinterpret_cast<const double2*>(M + i * Db + q);
      acc[i] += m.x * v[q];
      acc[i] += m.y * v[q + 1];
    }
  }
}

// ---------------------------------------------------------------------
// band_cr_reduce on a run that ends at more than one position a chain
// (cr_reduce_levels_kernel<Db, R>, its body reduce_tile), and the tile
// stages of cr_reduce_tree_kernel.
//
// A thread block stages its tile's E and F blocks of every level (with the
// halo positions) and its fine rhs rows with the left halo in shared memory
// by cp.async, all copies in flight at once, then computes level after
// level from shared memory: level l + 1 reads the buffer that level l wrote
// (two buffers take turns), a block barrier between levels. A thread owns
// R rows of one column of a position: R = 1 (a thread per output row and
// column: the most threads, for directions) or R = Db (a thread per
// position and column: b read once for all Db rows, block rows arriving as
// broadcasts, for the panel), chosen by K (kReduceRegisterRowsK).
// Consecutive threads run along the columns: shared-memory reads of b are
// conflict-free and the HBM writes coalesce. Bound: bytes for a wide panel
// (Manhattan-4's first run: the fine rhs in, the reduced ones out, 20.9 MB,
// 6.2 us at 3.35 TB/s); a launch and the dependent chains of the levels for
// 3D and for directions. On a run that ends at one position a chain its
// tile was the whole chain with a halo it never filled, its E, F staged
// again for every column chunk: such runs take the tree kernel.
// ---------------------------------------------------------------------

// One tile of the reduce: P coarsest positions from j0 of chain c and the
// columns k0 .. k0 + min(Kc, K - k0) - 1, n levels from level l0 (b: level
// l0's rhs, T its chain length; the levels' blocks and outputs are lv's
// l0 .. l0 + n - 1): the body of cr_reduce_levels_kernel (l0 = 0), and each
// tile stage of cr_reduce_tree_kernel.
// Ends without a barrier after its last level. clk: the clock slots of
// -DBAND_CR_CLOCKS builds. GROUPS: the fine rows and level 1's E, F as one
// cp.async group, each further level's E, F as one more, and a level starts
// when its group has landed (the chain kernel's fine phase); else one wait
// for every copy (the tile kernel, as measured).
template <int Db, int R, bool GROUPS = false>
__device__ __forceinline__ void reduce_tile(const CrReduceLevels& lv,
                                            const double* __restrict__ b, int l0, int n,
                                            int T, int K, int P, int Kc, int c, int j0,
                                            int k0, double* sm, long long* clk) {
  constexpr int BS = Db * Db;
  constexpr int G = Db / R;  // threads a position and column
  const int kc = min(Kc, K - k0);
  const int RS = Db * Kc;  // a staged rhs row
  // shared memory: level 1's E then F blocks, level 2's, ...; the fine rows;
  // level 1's output (level 2's goes to the fine rows' buffer, and so on).
  // Level lev covers the positions pbase .. pbase + cnt - 1, its own P <<
  // (n - lev) and the h = 2^(n - lev) - 1 before them.
  int ef_total = 0;
  for (int lev = 1; lev <= n; ++lev) ef_total += 2 * (((P + 1) << (n - lev)) - 1) * BS;
  double* buf[2];
  buf[0] = sm + ef_total;
  buf[1] = buf[0] + (((P + 1) << n) - 1) * RS;
  // Everything the tile reads, in flight at once by 16-byte cp.async (8-byte
  // where a chunk's lines are odd): the fine rows and every level's E, F.
  // (Bulk copies by the Tensor Memory Accelerator measured no faster at the
  // main path's shapes and slower at Manhattan-4's panel, one 60 KB copy a
  // thread block.)
  {
    const int base = (j0 << n) - ((1 << n) - 1);  // fine row of staged row 0
    const int lo = max(base, 0), hi = min((j0 + P) << n, T);
    stage_rhs(buf[0] + (lo - base) * RS, RS, b + ((long long)c * T + lo) * Db * K + k0,
              (long long)Db * K, hi - lo, Db, K, Kc, kc);
    double* e = sm;
    for (int lev = 1; lev <= n; ++lev) {
      const int Th = T >> lev;
      const int cnt = ((P + 1) << (n - lev)) - 1;
      const int pbase = (j0 << (n - lev)) - ((1 << (n - lev)) - 1);
      const int plo = max(pbase, 0), phi = min((j0 + P) << (n - lev), Th);
      const long long g = ((long long)c * Th + plo) * BS;
      stage_span(e + (plo - pbase) * BS, lv.E[l0 + lev - 1] + g, (phi - plo) * BS);
      stage_span(e + (cnt + plo - pbase) * BS, lv.F[l0 + lev - 1] + g, (phi - plo) * BS);
      e += 2 * cnt * BS;
      if (GROUPS) cp_async_commit();
    }
  }
  CR_CLOCK(1)
  if (!GROUPS) cp_async_wait_all();
  CR_CLOCK(2)
  if (!GROUPS) __syncthreads();
  CR_CLOCK(3)
  const double* e = sm;
  for (int lev = 1; lev <= n; ++lev) {
    if (GROUPS) {  // the rows and levels 1 .. lev's E, F have landed
      cp_async_wait_upto(n - lev);
      __syncthreads();
    }
    const int Th = T >> lev;
    const int h = (1 << (n - lev)) - 1;
    const int cnt = ((P + 1) << (n - lev)) - 1;
    const int pbase = (j0 << (n - lev)) - h;
    const double* in = buf[(lev - 1) & 1];
    double* nxt = buf[lev & 1];
    double* out = lv.out[l0 + lev - 1];
    const int items = cnt * G * kc;
    for (int w = threadIdx.x; w < items; w += blockDim.x) {
      const int k = w % kc;
      const int s = w / kc / G;  // staged position
      const int r0 = (w / kc - s * G) * R;
      const int j = pbase + s;
      if (j < 0 || j >= Th) continue;
      // rows 2j - 1, 2j, 2j + 1 of the level's input are staged rows 2s .. 2s + 2
      const double* bm = in + 2 * s * RS + k;
      const double* bp = bm + 2 * RS;
      double ae[R], af[R], v[Db];
#pragma unroll
      for (int i = 0; i < R; ++i) ae[i] = af[i] = 0.0;
      if (j > 0) {
#pragma unroll
        for (int q = 0; q < Db; ++q) v[q] = bm[q * Kc];
        rows_times_col<Db, R>(e + s * BS + r0 * Db, v, ae);
      }
#pragma unroll
      for (int q = 0; q < Db; ++q) v[q] = bp[q * Kc];
      rows_times_col<Db, R>(e + (cnt + s) * BS + r0 * Db, v, af);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = r0 + i;
        const double o = bm[RS + r * Kc] + (ae[i] + af[i]);
        if (lev < n) nxt[s * RS + r * Kc + k] = o;
        if (s >= h) out[(((long long)c * Th + j) * Db + r) * K + k0 + k] = o;
      }
    }
    e += 2 * cnt * BS;
    CR_CLOCK(2 + 2 * lev)
    if (lev < n && !GROUPS) __syncthreads();
    CR_CLOCK(3 + 2 * lev)
  }
}

template <int Db, int R>
__global__ void __launch_bounds__(R == 1 ? kCrReduceRowThreads : kCrThreads)
cr_reduce_levels_kernel(const CrReduceLevels lv, const double* __restrict__ b,
                        int n, int T, int K, int P, int Kc) {
#ifdef BAND_CR_CLOCKS
  long long clk[16] = {};
#else
  long long* clk = nullptr;
#endif
  CR_CLOCK(0)
  extern __shared__ __align__(16) double sm[];
  const int tiles = ((T >> n) + P - 1) / P;
  const int c = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - c * tiles) * P;  // first coarsest position
  reduce_tile<Db, R>(lv, b, 0, n, T, K, P, Kc, c, j0, blockIdx.y * Kc, sm, clk);
  CR_CLOCKS_OUT(lv.out[n - 1])
}

// ---------------------------------------------------------------------
// band_cr_backsub on a run that ends at more than one position a chain (a
// run that ends at one takes cr_backsub_chain_kernel, further down: there a
// tile was the whole chain on 1 to 8 thread blocks at the tails, its blocks
// read again for every chunk of columns). The tile's solution lives in ONE
// shared buffer in the finest layout: row i holds x_0[2^n j0 + i] for i = 0 .. 2^n P, so level
// l's x_l[m] sits at row (m - m0) << l and a level only fills the odd
// slots between the rows of the level above; row 2^n P is the coarsest
// solution after the tile. The kernels, chosen by K, Db and the levels
// (ops/band.py plans for the same rule, band._backsub_step):
//
//   one level (Manhattan-4) at K <= 4 or Db = 6: the per-level kernels'
//     cr_backsub_narrow_kernel and cr_backsub_wide_kernel, unchanged (the
//     launch is the level's);
//   cr_backsub_levels_kernel<Db, S>: the same per-position steps
//     (backsub_item), level after level over a tile, the block rows and b
//     read from HBM (16-byte loads), issued before the barrier that ends
//     the level above. The coarsest level reads x from HBM and the finest
//     writes it there:
//       S = 0, narrow (K <= 4; every Db): a lane group of 8 (Db = 6) or 16
//         lanes a position, lane r a row; the other rows of x and of the
//         intermediate gathered by shuffles of the group's width;
//       S = 1, 2, wide (K > 4, Db = 6): a thread a position and S
//         neighbouring columns (double2 where K is even), all Db rows in
//         registers, block rows as broadcasts.
//   cr_backsub_element_kernel<Db, R> (K > 4, Db = 12): a thread per R
//     rows of a column of a position (R = kBacksubElementRows: the rows
//     share the thread's column of x, where a thread a row read it R
//     times from shared memory, the bound of that layout). A, C, invD and
//     the odd rows of b of every level, and the coarsest x, are staged in
//     shared memory by cp.async, all in flight at once; a level writes
//     rv = (b - A x) - C x over the staged b (each element by its own
//     thread), one block barrier, then x = invD rv (the thread a position
//     and column of the kernel before ran three dependent 12 x 12 products
//     on 216 16-byte loads).
// Bound: bytes for the 2D panel (Manhattan-4, 28 MB, 8.4 us at 3.35 TB/s);
// a launch and the levels' dependent chains in 3D and for directions.
// ---------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void load_cols(const double* p, double* v) {
  if constexpr (V == 2) {
    const double2 t = ldg2(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_cols(double* p, const double* v) {
  if constexpr (V == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// out[q][v] = sum_p M[q][p] * y[p][v], p ascending from 0.0; M's rows are
// read as double2 (broadcast across the threads of a position).
template <int Db, int V>
__device__ __forceinline__ void block_times_cols(const double* __restrict__ M,
                                                 double (*y)[V],
                                                 double (*out)[V]) {
#pragma unroll
  for (int q = 0; q < Db; ++q) {
#pragma unroll
    for (int v = 0; v < V; ++v) out[q][v] = 0.0;
#pragma unroll
    for (int p = 0; p < Db; p += 2) {
      const double2 m = ldg2(M + q * Db + p);
#pragma unroll
      for (int v = 0; v < V; ++v) out[q][v] += m.x * y[p][v];
#pragma unroll
      for (int v = 0; v < V; ++v) out[q][v] += m.y * y[p + 1][v];
    }
  }
}


template <int V>
__device__ __forceinline__ void load_cols_shared(const double* p, double* v) {
  if constexpr (V == 2) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// A solve of one level at K <= 4, or at Db = 6: the launch is the level's,
// and its steps are those of the per-level kernels, unchanged (the same
// steps inlined into the tile kernel below took more registers and ran the
// 2D panel up to 0.8 us slower). narrow: a lane group per position, lane r
// a row, its rows of A, C, invD, b and x loaded before the first product,
// the other rows of x and of the intermediate gathered by shuffles of the
// group's width (8 positions in a block of 64 at Db = 6). wide: a thread
// per position and V neighbouring columns (V = 2 where K is even and the
// rhs arrays 16-byte aligned), the block rows broadcasts across a warp, the
// rhs rows coalesced along the columns.
template <int Db>
__global__ void __launch_bounds__(kBacksubNarrowThreads)
cr_backsub_narrow_kernel(const double* __restrict__ invDo,
                         const double* __restrict__ Ao,
                         const double* __restrict__ Co,
                         const double* __restrict__ b,
                         const double* __restrict__ xe,
                         double* __restrict__ x, int n, int Th, int K) {
  constexpr int GL = Lanes<Db>::group;
  static_assert(Db % 2 == 0 && Db <= GL, "row-per-lane layout");
  constexpr int BS = Db * Db;
  constexpr int KN = kBacksubNarrowK;
  const int t = blockIdx.x * (kBacksubNarrowThreads / GL) +
                threadIdx.x / GL;  // c * Th + j
  const int r = threadIdx.x & (GL - 1);
  const bool row = t < n && r < Db;
  const bool has_up = t < n && t % Th + 1 < Th;
  const long long rs = (long long)Db * K;
  double Ar[Db], Cr[Db], Vr[Db], xr[KN], ur[KN], br[KN];
#pragma unroll
  for (int p = 0; p < Db; ++p) Ar[p] = Cr[p] = Vr[p] = 0.0;
#pragma unroll
  for (int k = 0; k < KN; ++k) xr[k] = ur[k] = br[k] = 0.0;
  // every load of the lane, before the first product
  if (row) {
    const long long o = (long long)t * BS + r * Db;
#pragma unroll
    for (int p = 0; p < Db; p += 2) {
      const double2 a = ldg2(Ao + o + p);
      const double2 v = ldg2(invDo + o + p);
      Ar[p] = a.x;
      Ar[p + 1] = a.y;
      Vr[p] = v.x;
      Vr[p + 1] = v.y;
      if (has_up) {
        const double2 c = ldg2(Co + o + p);
        Cr[p] = c.x;
        Cr[p + 1] = c.y;
      }
    }
    const double* xs = xe + (long long)t * rs + (long long)r * K;
    const double* bs = b + (2LL * t + 1) * rs + (long long)r * K;
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      if (k < K) {
        xr[k] = __ldg(xs + k);
        br[k] = __ldg(bs + k);
        if (has_up) ur[k] = __ldg(xs + rs + k);
      }
    }
  }
  double* x0 = x + 2LL * t * rs + (long long)r * K;  // fine row 2j, row r
  double* x1 = x0 + rs;                               // fine row 2j + 1
#pragma unroll
  for (int k = 0; k < KN; ++k) {
    if (k < K) {  // K is the same for the whole grid: every lane shuffles
      double a = 0.0;
#pragma unroll
      for (int p = 0; p < Db; ++p)
        a += Ar[p] * __shfl_sync(0xffffffffu, xr[k], p, GL);
      double rv = br[k] - a;
      a = 0.0;
#pragma unroll
      for (int p = 0; p < Db; ++p)
        a += Cr[p] * __shfl_sync(0xffffffffu, ur[k], p, GL);
      if (has_up) rv = rv - a;
      double out = 0.0;
#pragma unroll
      for (int q = 0; q < Db; ++q)
        out += Vr[q] * __shfl_sync(0xffffffffu, rv, q, GL);
      if (row) {
        x0[k] = xr[k];
        x1[k] = out;
      }
    }
  }
}

template <int Db, int V>
__global__ void __launch_bounds__(kBacksubWideThreads)
cr_backsub_wide_kernel(const double* __restrict__ invDo,
                       const double* __restrict__ Ao,
                       const double* __restrict__ Co,
                       const double* __restrict__ b,
                       const double* __restrict__ xe,
                       double* __restrict__ x, int n, int Th, int K) {
  constexpr int BS = Db * Db;
  const int KV = K / V;
  const int w = blockIdx.x * kBacksubWideThreads + threadIdx.x;
  if (w >= n * KV) return;
  const int t = w / KV;  // c * Th + j
  const int k = (w - t * KV) * V;
  const bool has_up = t % Th + 1 < Th;
  const long long rs = (long long)Db * K;
  const double* xj = xe + (long long)t * rs + k;
  const double* bo = b + (2LL * t + 1) * rs + k;
  double xv[Db][V], xu[Db][V], bv[Db][V];
#pragma unroll
  for (int p = 0; p < Db; ++p) {
    load_cols<V>(xj + (long long)p * K, xv[p]);
    load_cols<V>(bo + (long long)p * K, bv[p]);
  }
  if (has_up) {
#pragma unroll
    for (int p = 0; p < Db; ++p) load_cols<V>(xj + rs + (long long)p * K, xu[p]);
  }
  double rv[Db][V], a[Db][V];
  block_times_cols<Db, V>(Ao + (long long)t * BS, xv, a);
#pragma unroll
  for (int q = 0; q < Db; ++q) {
#pragma unroll
    for (int v = 0; v < V; ++v) rv[q][v] = bv[q][v] - a[q][v];
  }
  if (has_up) {
    block_times_cols<Db, V>(Co + (long long)t * BS, xu, a);
#pragma unroll
    for (int q = 0; q < Db; ++q) {
#pragma unroll
      for (int v = 0; v < V; ++v) rv[q][v] = rv[q][v] - a[q][v];
    }
  }
  block_times_cols<Db, V>(invDo + (long long)t * BS, rv, a);
  double* x0 = x + 2LL * t * rs + k;
#pragma unroll
  for (int r = 0; r < Db; ++r) {
    store_cols<V>(x0 + (long long)r * K, xv[r]);
    store_cols<V>(x0 + rs + (long long)r * K, a[r]);
  }
}

// One work item of the register steps: position t of level lev (global
// index c * Th + m, m its place in the chain), item w of the position's
// `per` (a lane of the narrow step's group; a column pair or column of the
// wide one), at index s of the x source and destination (xs: x_lev,
// positions xsp apart, rows xsr; xd: x_{lev-1}, rows of position 2s, 2s +
// 1 and, with `halo`, 2s + 2 = the coarsest row after the tile). FROM_HBM:
// x_lev is read from HBM (the coarsest level), else from the shared
// buffer, after the block barrier that ends the level above (`sync`: the
// first pass of a level; every thread of the block calls with the same
// value). TO_HBM: x_{lev-1} goes to HBM (the finest level, both rows), else
// to the buffer (its odd rows, and where x_lev came from HBM also the even
// rows and the halo). The loads from HBM are issued before that barrier.
template <int Db, int S, bool FROM_HBM, bool TO_HBM>
__device__ __forceinline__ void backsub_item(const double* Ab, const double* Cb,
                                             const double* Vb, const double* bl,
                                             const double* xs, long long xsp, int xsr,
                                             double* xd, long long xdp, int xdr, int K,
                                             int per, int w, long long s, long long t, int m,
                                             int Th, bool pos, bool halo, bool sync) {
  constexpr int BS = Db * Db;
  constexpr int GL = Lanes<Db>::group;
  constexpr int V = S == 0 ? 1 : S;
  constexpr int KN = kBacksubNarrowK;
  constexpr bool kEven = FROM_HBM || TO_HBM;
  const bool has_up = pos && m + 1 < Th;
  const double* bo = bl + (2 * t + 1) * Db * K;
  const long long o = t * BS;
  if constexpr (S == 0) {
    const int r = w & (GL - 1);
    const bool row = pos && r < Db;
    double Ar[Db], Cr[Db], Vr[Db], xr[KN], ur[KN], br[KN];
#pragma unroll
    for (int p = 0; p < Db; ++p) Ar[p] = Cr[p] = Vr[p] = 0.0;
#pragma unroll
    for (int k = 0; k < KN; ++k) xr[k] = ur[k] = br[k] = 0.0;
    if (row) {
#pragma unroll
      for (int p = 0; p < Db; p += 2) {
        const double2 a = ldg2(Ab + o + r * Db + p);
        const double2 v = ldg2(Vb + o + r * Db + p);
        Ar[p] = a.x;
        Ar[p + 1] = a.y;
        Vr[p] = v.x;
        Vr[p + 1] = v.y;
        if (has_up) {
          const double2 cc = ldg2(Cb + o + r * Db + p);
          Cr[p] = cc.x;
          Cr[p + 1] = cc.y;
        }
      }
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        if (k < K) {
          br[k] = __ldg(bo + (long long)r * K + k);
          if (FROM_HBM) {
            xr[k] = __ldg(xs + s * xsp + r * xsr + k);
            if (has_up) ur[k] = __ldg(xs + (s + 1) * xsp + r * xsr + k);
          }
        }
      }
    }
    if (!FROM_HBM) {
      if (sync) __syncthreads();  // the level above is in the buffer
      if (row) {
#pragma unroll
        for (int k = 0; k < KN; ++k) {
          if (k < K) {
            xr[k] = xs[s * xsp + r * xsr + k];
            if (has_up) ur[k] = xs[(s + 1) * xsp + r * xsr + k];
          }
        }
      }
    }
    double* d = xd + 2 * s * xdp + r * xdr;
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      if (k < K) {  // K is the same for the whole grid: every lane shuffles
        double a = 0.0;
#pragma unroll
        for (int p = 0; p < Db; ++p) a += Ar[p] * __shfl_sync(0xffffffffu, xr[k], p, GL);
        double rv = br[k] - a;
        a = 0.0;
#pragma unroll
        for (int p = 0; p < Db; ++p) a += Cr[p] * __shfl_sync(0xffffffffu, ur[k], p, GL);
        if (has_up) rv = rv - a;
        double out = 0.0;
#pragma unroll
        for (int q = 0; q < Db; ++q) out += Vr[q] * __shfl_sync(0xffffffffu, rv, q, GL);
        if (row) {
          if (kEven) d[k] = xr[k];
          d[xdp + k] = out;
          if (halo) d[2 * xdp + k] = ur[k];
        }
      }
    }
  } else {
    const int k = (w % per) * V;
    double bv[Db][V], xv[Db][V], xu[Db][V];
    const double* xp = xs + s * xsp + k;
    if (pos) {
#pragma unroll
      for (int p = 0; p < Db; ++p) load_cols<V>(bo + (long long)p * K + k, bv[p]);
      if (FROM_HBM) {
#pragma unroll
        for (int p = 0; p < Db; ++p) load_cols<V>(xp + p * xsr, xv[p]);
        if (has_up) {
#pragma unroll
          for (int p = 0; p < Db; ++p) load_cols<V>(xp + xsp + p * xsr, xu[p]);
        }
      }
    }
    if (!FROM_HBM) {
      if (sync) __syncthreads();
      if (pos) {
#pragma unroll
        for (int p = 0; p < Db; ++p) load_cols_shared<V>(xp + p * xsr, xv[p]);
        if (has_up) {
#pragma unroll
          for (int p = 0; p < Db; ++p) load_cols_shared<V>(xp + xsp + p * xsr, xu[p]);
        }
      }
    }
    if (pos) {
      double rv[Db][V], a[Db][V];
      block_times_cols<Db, V>(Ab + o, xv, a);
#pragma unroll
      for (int q = 0; q < Db; ++q) {
#pragma unroll
        for (int u = 0; u < V; ++u) rv[q][u] = bv[q][u] - a[q][u];
      }
      if (has_up) {
        block_times_cols<Db, V>(Cb + o, xu, a);
#pragma unroll
        for (int q = 0; q < Db; ++q) {
#pragma unroll
          for (int u = 0; u < V; ++u) rv[q][u] = rv[q][u] - a[q][u];
        }
      }
      block_times_cols<Db, V>(Vb + o, rv, a);
      double* d = xd + 2 * s * xdp + k;
#pragma unroll
      for (int r = 0; r < Db; ++r) {
        if (kEven) store_cols<V>(d + r * xdr, xv[r]);
        store_cols<V>(d + xdp + r * xdr, a[r]);
        if (halo) store_cols<V>(d + 2 * xdp + r * xdr, xu[r]);
      }
    }
  }
}

// The levels of a tile, coarsest first; the tile's Pl = P << (n - lev)
// positions m0 .. m0 + Pl - 1 of level lev take passes of the thread block.
template <int Db, int S, bool FROM_HBM, bool TO_HBM>
__device__ __forceinline__ void backsub_level(const double* Ab, const double* Cb,
                                              const double* Vb, const double* bl,
                                              const double* xs, long long xsp, int xsr,
                                              double* xd, long long xdp, int xdr, int c,
                                              int Th, int Pl, int m0, int K, int per) {
  const int items = Pl * per;
  for (int base = 0; base < items; base += blockDim.x) {
    const int w = base + threadIdx.x;
    const int s = w / per;
    const int m = m0 + s;
    const bool pos = w < items && m < Th;
    const bool halo = FROM_HBM && !TO_HBM && s == Pl - 1 && m + 1 < Th;
    backsub_item<Db, S, FROM_HBM, TO_HBM>(Ab, Cb, Vb, bl, xs, xsp, xsr, xd, xdp, xdr, K, per,
                                          w, s, (long long)c * Th + m, m, Th, pos, halo,
                                          base == 0);
  }
}

// Two or more levels: a tile of P coarsest positions and Kc columns, the
// levels' x between the coarsest and the finest in the shared buffer.
template <int Db, int S>
__global__ void __launch_bounds__(kCrThreads)
cr_backsub_levels_kernel(const CrBacksubLevels lv, const double* __restrict__ xe,
                         double* __restrict__ x, int n, int T, int K, int P, int Kc) {
  extern __shared__ __align__(16) double sm[];
  constexpr int GL = Lanes<Db>::group;
  constexpr int V = S == 0 ? 1 : S;
  const int Tn = T >> n;
  const int tiles = (Tn + P - 1) / P;
  const int c = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - c * tiles) * P;
  const int k0 = blockIdx.y * Kc;
  const int kc = min(Kc, K - k0);
  const int RS = Db * Kc;
  const int per = S == 0 ? GL : kc / V;  // kc is even where V = 2
  // x_n and the finest x in HBM; the levels between in the shared buffer
  const double* xg = xe + ((long long)c * Tn + j0) * Db * K + k0;
  double* xo = x + ((long long)c * T + (j0 << n)) * Db * K + k0;
  const long long hp = (long long)Db * K;  // a position's stride in HBM
  for (int lev = n; lev >= 1; --lev) {
    const int Th = T >> lev, Pl = P << (n - lev), m0 = j0 << (n - lev);
    const double *Ab = lv.A[lev - 1], *Cb = lv.C[lev - 1], *Vb = lv.invD[lev - 1];
    const double* bl = lv.b[lev - 1] + k0;
    const long long up = (long long)RS << lev, down = (long long)RS << (lev - 1);
    if (lev == n)
      backsub_level<Db, S, true, false>(Ab, Cb, Vb, bl, xg, hp, K, sm, down, Kc, c, Th, Pl,
                                        m0, K, per);
    else if (lev == 1)
      backsub_level<Db, S, false, true>(Ab, Cb, Vb, bl, sm, up, Kc, xo, hp, K, c, Th, Pl, m0,
                                        K, per);
    else
      backsub_level<Db, S, false, false>(Ab, Cb, Vb, bl, sm, up, Kc, sm, down, Kc, c, Th, Pl,
                                         m0, K, per);
  }
}

template <int Db, int R>
__global__ void __launch_bounds__(kCrElementThreads)
cr_backsub_element_kernel(const CrBacksubLevels lv, const double* __restrict__ xe,
                          double* __restrict__ x, int n, int T, int K, int P, int Kc) {
#ifdef BAND_CR_CLOCKS
  long long clk[16] = {};
#endif
  CR_CLOCK(0)
  extern __shared__ __align__(16) double sm[];
  constexpr int BS = Db * Db;
  const int Tn = T >> n;
  const int tiles = (Tn + P - 1) / P;
  const int c = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - c * tiles) * P;
  const int k0 = blockIdx.y * Kc;
  const int kc = min(Kc, K - k0);
  const int RS = Db * Kc;
  // shared memory: the solution buffer (finest layout, (P << n) + 1 rows),
  // then for level n, n - 1, ..., 1: invD, A, C of its P << (n - lev)
  // positions and their odd rows of b (rv after the level's first half)
  double* xb = sm;
  double* lvl = xb + ((P << n) + 1) * RS;
  // Everything the tile reads, in flight at once by cp.async: the coarsest
  // x of the tile and of the position after it, and every level's invD, A,
  // C and odd rows of b.
  {
    const long long hp = (long long)Db * K;  // a position's stride in HBM
    stage_rhs(xb, RS << n, xe + ((long long)c * Tn + j0) * hp + k0, hp, min(P + 1, Tn - j0),
              Db, K, Kc, kc);
    double* q = lvl;
    for (int lev = n; lev >= 1; --lev) {
      const int Th = T >> lev, Pl = P << (n - lev), m0 = j0 << (n - lev);
      const int v = min(Pl, Th - m0);
      const long long g = ((long long)c * Th + m0) * BS;
      stage_span(q, lv.invD[lev - 1] + g, v * BS);
      stage_span(q + Pl * BS, lv.A[lev - 1] + g, v * BS);
      stage_span(q + 2 * Pl * BS, lv.C[lev - 1] + g, v * BS);
      stage_rhs(q + 3 * Pl * BS, RS, lv.b[lev - 1] + ((long long)c * 2 * Th + 2 * m0 + 1) * hp + k0,
                2 * hp, v, Db, K, Kc, kc);
      q += Pl * (3 * BS + RS);
    }
  }
  CR_CLOCK(1)
  cp_async_wait_all();
  CR_CLOCK(2)
  __syncthreads();
  CR_CLOCK(3)
  const double* q = lvl;
  for (int lev = n; lev >= 1; --lev) {
    const int Th = T >> lev, Pl = P << (n - lev), m0 = j0 << (n - lev);
    const double* Vs = q;
    const double* As = q + Pl * BS;
    const double* Cs = q + 2 * Pl * BS;
    double* bs = const_cast<double*>(q) + 3 * Pl * BS;
    constexpr int G = Db / R;  // threads a position and column
    const int items = Pl * G * kc;
    // rv = (b - A x) - C x_up over the staged b: a thread R rows of a column
    for (int w = threadIdx.x; w < items; w += blockDim.x) {
      const int k = w % kc, s = w / kc / G, r0 = (w / kc - s * G) * R;
      const int m = m0 + s;
      if (m >= Th) continue;
      const double* xa = xb + (s << lev) * RS + k;
      double xv[Db], rv[R];
#pragma unroll
      for (int p = 0; p < Db; ++p) xv[p] = xa[p * Kc];
      double* bw = bs + s * RS + r0 * Kc + k;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        double a = 0.0;
        rows_times_col<Db, 1>(As + s * BS + (r0 + i) * Db, xv, &a);
        rv[i] = bw[i * Kc] - a;
      }
      if (m + 1 < Th) {
#pragma unroll
        for (int p = 0; p < Db; ++p) xv[p] = xa[(RS << lev) + p * Kc];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          double a = 0.0;
          rows_times_col<Db, 1>(Cs + s * BS + (r0 + i) * Db, xv, &a);
          rv[i] = rv[i] - a;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) bw[i * Kc] = rv[i];
    }
    CR_CLOCK(4 + 3 * (n - lev))
    __syncthreads();
    CR_CLOCK(5 + 3 * (n - lev))
    // x_{lev-1}[2m + 1] = invD rv
    for (int w = threadIdx.x; w < items; w += blockDim.x) {
      const int k = w % kc, s = w / kc / G, r0 = (w / kc - s * G) * R;
      const int m = m0 + s;
      if (m >= Th) continue;
      double rv[Db];
#pragma unroll
      for (int p = 0; p < Db; ++p) rv[p] = bs[s * RS + p * Kc + k];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = r0 + i;
        double out = 0.0;
        rows_times_col<Db, 1>(Vs + s * BS + r * Db, rv, &out);
        if (lev > 1) {
          xb[((s << lev) + (1 << (lev - 1))) * RS + r * Kc + k] = out;
        } else {
          double* xo = x + (((long long)c * T + (j0 << n) + 2 * s) * Db + r) * K + k0 + k;
          xo[0] = xb[2 * s * RS + r * Kc + k];
          xo[(long long)Db * K] = out;
        }
      }
    }
    q += Pl * (3 * BS + RS);
    CR_CLOCK(6 + 3 * (n - lev))
    if (lev > 1) __syncthreads();
  }
  CR_CLOCKS_OUT(x)
}

// ---------------------------------------------------------------------
// band_cr_reduce and band_cr_backsub on a run that ends at ONE position a
// chain (cr_reduce_tree_kernel, cr_backsub_chain_kernel). Since the band
// compacts to one block (band.CR_BASE_LENGTH = 1) a band-solve pass is one
// such run each way on every chain of up to 2^kCrMaxLevels = 1,024 blocks:
// ONE launch each way (longer chains first take runs of the tile kernels
// above). They replace the same TPU kernels as the tile kernels
// (pallas_pcr.py:385 _cr_reduce_kernel, :405 _cr_backsub_kernel), which now
// take only runs that end at more than one position a chain (a schedule no
// solve uses).
//
// What held the kernels before these back (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6): a pass was cut into runs of at most 8 levels, so
// Manhattan-4 and 3D 1x1000 made two launches each way, the first on the
// tile kernels with one coarsest position a thread block (32 and 64 thread
// blocks for 132 SMs), each recomputing a left halo as long as its own rows
// at every level; the tails' short levels a second launch from HBM (6.2-6.7
// us at K = 1 against bounds of 0.01-0.03 us); the 3D back substitution
// staged every level's blocks at once, so the 3D fold's panel took two
// launches.
//
// The design:
//   reduce: a tile stage, then the whole chain (band._chain_plan plans it:
//     CrReducePlan). The tile stage is the grid: a thread block a tile of P
//     positions of level top (and a chunk of Kf columns) with its left
//     halo, levels 1 .. top from b (reduce_tile). Each such block then takes
//     a ticket of its chain's counter (`tickets`) once its rows are out;
//     the block that takes the last runs the whole chain from level top,
//     with no halo, reading the tiles' rows through L2 (cp.async.cg, after a
//     fence): its E, F staged once (`stage`, a cp.async group a level) or
//     read through L1, the rhs in chunks of Kc columns through a ring of two
//     buffers, each level in place in the finest layout, one barrier a
//     level. No thread block waits for another: a block that takes no last
//     ticket ends; the one that does resets the counter, so every counter is
//     zero before and after a launch. Where the chains alone fill the card
//     (top = 0), a chain a thread block. The fine levels go over the card
//     where their halo is short, the last few on one thread block a chain.
//   backsub: a thread block owns a segment of T / S fine rows; the rows of
//     x_l it needs form an interval at every level (x_{l-1}[2p] = x_l[p],
//     x_{l-1}[2p + 1] from x_l[p], x_l[p + 1]): the whole chain for S = 1,
//     one or two positions at the coarse levels and the segment at the fine
//     ones otherwise. Each block recomputes its few coarse positions (no
//     ticket, no wait). Directions (K <= 4 at Db = 6, K <= 2 at Db = 12:
//     cr_backsub_lanes_kernel): the
//     narrow tile step's layout, a lane group a position of the segment's
//     widest level, lane r a row, its rows of a level's A, C, invD and b
//     read from L2 into registers one level ahead, x_l in two shared
//     buffers, one barrier a level. Panels (cr_backsub_chain_kernel): the
//     levels' invD, A, C and odd rows of b stream through a ring of three
//     level slots in shared memory (one cp.async group a level, coarsest
//     first, issued two levels ahead of the level computed into the slot of
//     the level just done): the shared memory of the widest levels, not the
//     sum over all. Its columns go in chunks through two compact x buffers;
//     a thread owns all six rows of a column (Db = 6: rv = (b - A x) - C
//     x_up and x = invD rv in registers) or three (Db = 12, with a barrier
//     between); the finest x is written once.
// Arithmetic order is the plain twins': each block product summed over q
// ascending from 0.0, b[2j] + (E b + F b), (b - A x) - C x; only nvcc's
// contraction to FMAs differs. Bound: bytes at the folds and the 2D panels
// (each element of the rhs, the blocks and the outputs moved once: the
// 100-trial fold's reduce 151 MB, 45 us at 3.35 TB/s); elsewhere a launch
// and the levels' dependent chain: 10 levels in sequence on 3D 1x1000, a
// barrier and product chains a level, and the reduce's hand-off to the
// whole chain (a fence, an atomic, the chain's E, F into one SM). The clock
// build, NVIDIA H100 80GB HBM3, 700 W (PERF.md §6): 3D 1x1000 at K = 1, the
// reduce's tile stage 4.85 us, the hand-off 2.9 us, six levels 4.3 us; the
// back substitution's ten levels 0.45-0.65 us each. Against the parent's
// runs of at most 8 levels (PR 10's tiles and PR 19's chain kernels, in
// turns): a pass's back substitution at K = 1 0.25-0.65x, the panels'
// 0.68-0.83x but the 3D fold's (1.16x, one launch for two); the reduce
// 0.86-1.02x at the panels, 0.94-1.09x at K = 1.
// -DBAND_CR_CLOCKS: the thread block that finishes chain 0 (reduce) or
// segment 0 of chain 0 (backsub) records kChainClocks clock64() values and
// writes them over its output (the reduce: level 1's) (measurement builds).
// Reduce: 0 start, 1 its
// tile done, 24 the chain's last ticket taken, 3 the whole chain's copies
// issued, 4 + 2 (d - 1) / 5 + 2 (d - 1) its level d (chunk 0) begun / done,
// 31 end, 32.. its tile's own (reduce_tile: 33 copies issued, then each
// level). Backsub: 0 start, 1 copies issued, 2 + 2 (n - l) / 3 + 2 (n - l)
// level l (chunk 0) begun / done, 31 end.
constexpr int kChainClocks = 64;
#ifdef BAND_CR_CLOCKS
#define CR_CHAIN_CLOCK(i) \
  if (threadIdx.x == 0) clk[i] = clock64();
#define CR_CHAIN_CLOCKS_OUT(first, dst, cap)                                     \
  if ((first) && threadIdx.x == 0)                                              \
    for (int i = 0; i < kChainClocks && i < (cap); ++i) (dst)[i] = (double)(clk[i] - clk[0]);
#define CR_CHAIN_TILE_CLOCKS (clk + 32)
#else
#define CR_CHAIN_CLOCK(i)
#define CR_CHAIN_CLOCKS_OUT(first, dst, cap)
#define CR_CHAIN_TILE_CLOCKS nullptr
#endif

// acc[v] += sum_q M[q] * x[q][v] for one row of M (Db wide, 16-byte
// aligned) and V columns, q ascending: each column's sum in
// rows_times_col's order.
template <int Db, int V>
__device__ __forceinline__ void row_times_cols(const double* M, double (*x)[V],
                                               double* acc) {
#pragma unroll
  for (int q = 0; q < Db; q += 2) {
    const double2 m = *reinterpret_cast<const double2*>(M + q);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += m.x * x[q][v];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += m.y * x[q + 1][v];
  }
}

// Rows of a column a thread of cr_reduce_tree_kernel holds at the panel
// (K >= kReduceRegisterRowsK): all six at Db = 6, a third at Db = 12; a
// thread block is kCrThreads (a row a thread in 512 or 1024 threads read the
// rhs Db times and ran the folds 1.3-1.8x slower; half the rows at Db = 6
// in 512 or 1024 threads no faster: profile_port.py --cr).
template <int Db>
constexpr int chain_rows() { return Db == 12 ? 4 : Db; }

// The whole-chain stage of cr_reduce_tree_kernel: levels m + 1 .. n of chain
// c from its level-m rows at src (2^(n - m) rows of Db x K, src at column
// k0), columns k0 .. k0 + kw - 1 in chunks of Kc through a ring of two
// buffers (chunk q + 1 in flight while chunk q computes), the levels' E, F
// staged in shared memory (stage: staged once by bulk copies, a level's E
// and F completing on its mbarrier of `bars`,
// one cp.async group a level, a level starting when its group has landed) or
// read through L1; each level computed in place in the finest layout (level
// d's position j at row j << d: a position's own row is read and written only
// by its own threads, the odd rows only read), one barrier a level.
template <int Db, int R, int V>
__device__ __forceinline__ void reduce_chain(const CrReduceLevels& lv, const double* src, int c,
                                             int m, int n, int K, int k0, int kw, int Kc,
                                             int stage, double* sm, unsigned long long* bars,
                                             long long* clk) {
  constexpr int BS = Db * Db;
  constexpr int G = Db / R;  // threads a position and column
  const int Tc = 1 << (n - m);
  const int nc = n - m;
  const long long rs = (long long)Db * K;  // a position's stride in HBM
  const int chunks = (kw + Kc - 1) / Kc;
  const int RS = Db * Kc;    // a staged row
  const int ring = Tc * RS;  // a chunk's rows
  double* ef = sm;           // level d's E, F (stage): after levels 1 .. d - 1's
  double* rows = sm + (stage ? 2 * (Tc - 1) * BS : 0);
  // every level's E, F: two bulk copies a level, contiguous in HBM
  if (stage) {
    if (threadIdx.x == 0) {
      for (int d = 1; d <= nc; ++d) mbar_init(bars + d - 1, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers are set, and every access of the stage before is done
    if (threadIdx.x == 0) {
      // the bulk copies (async proxy) after the generic accesses to this memory
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int d = 1; d <= nc; ++d) {
        const int Th = Tc >> d;
        const long long g = (long long)c * Th * BS;
        double* e = ef + 2 * (Tc - (Tc >> (d - 1))) * BS;
        const unsigned bytes = (unsigned)(Th * BS * sizeof(double));
        mbar_expect(bars + d - 1, 2 * bytes);
        bulk_copy(e, lv.E[m + d - 1] + g, bytes, bars + d - 1);
        bulk_copy(e + Th * BS, lv.F[m + d - 1] + g, bytes, bars + d - 1);
      }
    }
  }
  // chunk 0's rows, then chunk 1's: a cp.async group each
  stage_rhs(rows, RS, src, rs, Tc, Db, K, Kc, min(Kc, kw));
  cp_async_commit();
  if (chunks > 1) {
    stage_rhs(rows + ring, RS, src + Kc, rs, Tc, Db, K, Kc, min(Kc, kw - Kc));
    cp_async_commit();
  }
  CR_CHAIN_CLOCK(3)
  for (int q = 0; q < chunks; ++q) {
    const int j0 = q * Kc, kc = min(Kc, kw - j0);
    double* buf = rows + (q & 1) * ring;
    if (q > 0) {
      __syncthreads();  // chunk q - 1 is done with the buffer chunk q + 1 takes
      if (q + 1 < chunks)
        stage_rhs(rows + ((q + 1) & 1) * ring, RS, src + j0 + Kc, rs, Tc, Db, K, Kc,
                  min(Kc, kw - j0 - Kc));
      cp_async_commit();
      cp_async_wait<1>();  // chunk q has landed
    }
    for (int d = 1; d <= nc; ++d) {
      if (q == 0 && d == 1) cp_async_wait_upto(chunks > 1 ? 1 : 0);  // chunk 0
      if (q == 0 && stage) mbar_wait(bars + d - 1, 0);                // level d's E, F
      __syncthreads();
      if (q == 0) {
        CR_CHAIN_CLOCK(2 + 2 * d)
      }
      const int Th = Tc >> d, sh = d - 1;
      const double *E, *F;
      if (stage) {
        E = ef + 2 * (Tc - (Tc >> (d - 1))) * BS;
        F = E + Th * BS;
      } else {
        E = lv.E[m + d - 1] + (long long)c * Th * BS;
        F = lv.F[m + d - 1] + (long long)c * Th * BS;
      }
      double* out = lv.out[m + d - 1] + (long long)c * Th * rs + k0 + j0;
      const int per = kc / V;  // column groups: kc is even where V = 2
      const int items = Th * G * per;
      for (int w = threadIdx.x; w < items; w += blockDim.x) {
        const int k = (w % per) * V;
        const int s = w / per / G;  // the level's position
        const int r0 = (w / per - s * G) * R;
        // the level's input rows 2s - 1, 2s, 2s + 1 sit at rows (2s -+ 1) << sh
        // and s << d; the output replaces row 2s in place
        double* b0 = buf + (s << d) * RS + k;
        const double* bp = b0 + (RS << sh);
        double ae[R][V] = {}, af[R][V] = {}, v[Db][V];
        if (s > 0) {
          const double* bm = b0 - (RS << sh);
#pragma unroll
          for (int p = 0; p < Db; ++p) load_cols_shared<V>(bm + p * Kc, v[p]);
#pragma unroll
          for (int i = 0; i < R; ++i)
            row_times_cols<Db, V>(E + s * BS + (r0 + i) * Db, v, ae[i]);
        }
#pragma unroll
        for (int p = 0; p < Db; ++p) load_cols_shared<V>(bp + p * Kc, v[p]);
#pragma unroll
        for (int i = 0; i < R; ++i)
          row_times_cols<Db, V>(F + s * BS + (r0 + i) * Db, v, af[i]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = r0 + i;
          double o[V];
          load_cols_shared<V>(b0 + r * Kc, o);
#pragma unroll
          for (int u = 0; u < V; ++u) o[u] = o[u] + (ae[i][u] + af[i][u]);
          store_cols<V>(b0 + r * Kc, o);
          store_cols<V>(out + ((long long)s * Db + r) * K + k, o);
        }
      }
      if (q == 0) {
        CR_CHAIN_CLOCK(3 + 2 * d)
      }
    }
  }
}

// The E and F of levels l0 + 1 .. n of chain c (fine length T) at the
// positions that come from the level-l0 positions a .. b - 1, into L2 (one
// prefetch a 128-byte line): the whole-chain stage's cp.async copies of
// them then find them in L2. The tiles issue them before their own copies.
template <int Db>
__device__ __forceinline__ void prefetch_levels(const CrReduceLevels& lv, int c, int T, int l0,
                                                int n, int a, int b) {
  constexpr long long BS = Db * Db;
  for (int l = l0 + 1; l <= n; ++l) {
    const int lo = a >> (l - l0), hi = (b - 1) >> (l - l0);
    const long long g = ((long long)c * (T >> l) + lo) * BS;
    const char* e = reinterpret_cast<const char*>(lv.E[l - 1] + g);
    const char* f = reinterpret_cast<const char*>(lv.F[l - 1] + g);
    const int bytes = (hi - lo + 1) * (int)BS * 8;
    for (int o = threadIdx.x * 128; o < bytes; o += blockDim.x * 128) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(e + o));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(f + o));
    }
  }
}

// Doubles of cr_reduce_tree_kernel's shared memory before its stages': the
// flag of the chain's last ticket, and an mbarrier a whole-chain level.
constexpr int kTreeHeader = 2 + kCrMaxLevels;

// Thread blocks an SM the tree kernel is compiled for: two (at most 128
// registers a thread) but where ptxas spilled at that cap, the panel
// instances with a tile stage and the 3D panel's column pairs without
// (ptxas -v, sm_90a; a spill fails chip_smoke.py), and four for the
// directions' whole-chain kernel (the 2D fold's 400 chains in one wave);
// with no bound ptxas took 80 registers and spilled too.
// (-DBAND_CR_TREE_MIN_BLOCKS=b takes b at every instance: measurement
// builds, profile_port.py --cr --pass --sweep.)
constexpr int tree_min_blocks(int Db, int R, int V, bool TILES) {
#ifdef BAND_CR_TREE_MIN_BLOCKS
  return BAND_CR_TREE_MIN_BLOCKS;
#else
  return R > 1 && (TILES || (Db == 12 && V == 2)) ? 1 : (TILES || R > 1 ? 2 : 4);
#endif
}

// TILES: the plan has a tile stage (else a chain a thread block: a kernel of
// its own, so that its registers are the whole-chain stage's alone).
template <int Db, int R, int V, bool TILES>
__global__ void __launch_bounds__(kCrThreads, tree_min_blocks(Db, R, V, TILES))
cr_reduce_tree_kernel(const CrReduceLevels lv, const double* __restrict__ b,
                      int* __restrict__ tickets, int n, int K, const CrReducePlan plan) {
#ifdef BAND_CR_CLOCKS
  long long clk[kChainClocks];
  if (threadIdx.x == 0)
    for (int i = 0; i < kChainClocks; ++i) clk[i] = 0;
#else
  long long* clk = nullptr;
#endif
  CR_CHAIN_CLOCK(0)
  extern __shared__ __align__(16) double smem[];
  // whether this block took its chain's last ticket, the whole chain's
  // mbarriers, then the stages' own shared memory
  int* last = reinterpret_cast<int*>(smem);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + 2);
  double* sm = smem + kTreeHeader;
  const int T = 1 << n;
  const long long rs = (long long)Db * K;  // a position's stride in HBM
  if constexpr (!TILES) {  // a chain a thread block
    const int c = blockIdx.x;
    reduce_chain<Db, R, V>(lv, b + (long long)c * T * rs, c, 0, n, K, 0, K, plan.Kc, plan.stage,
                           sm, bars, clk);
    CR_CHAIN_CLOCK(31)
    CR_CHAIN_CLOCKS_OUT(c == 0, lv.out[0], (long long)gridDim.x * (T >> 1) * Db * K)
    return;
  }
  // the tile stage: the grid, a tile and chunk of Kf columns a thread block
  const int chunks = (K + plan.Kf - 1) / plan.Kf;
  const int tiles = (T >> plan.top) / plan.P;
  const int per = tiles * chunks;  // thread blocks a chain
  const int nC = gridDim.x / per;
  const int c = blockIdx.x / per;
  const int r = blockIdx.x - c * per, u = r / chunks, q = r - u * chunks;
  if (q == 0)  // chunk 0: the whole chain's E, F from this tile's positions
    prefetch_levels<Db>(lv, c, T, plan.top, n, u * plan.P, (u + 1) * plan.P);
  reduce_tile<Db, R, true>(lv, b, 0, plan.top, T, K, plan.P, plan.Kf, c, u * plan.P,
                           q * plan.Kf, sm, CR_CHAIN_TILE_CLOCKS);
  CR_CHAIN_CLOCK(1)
  __threadfence();
  __syncthreads();  // every thread's rows of the tile are out
  if (threadIdx.x == 0) {
    int* k = tickets + c * chunks + q;  // the chain's chunk q
    *last = atomicAdd(k, 1) == tiles - 1;
    if (*last) *k = 0;  // zero again for the next launch
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();  // the rows of every tile of the chain's chunk are visible
  CR_CHAIN_CLOCK(24)
  const int k0 = q * plan.Kf;
  reduce_chain<Db, R, V>(lv, lv.out[plan.top - 1] + (long long)c * (T >> plan.top) * rs + k0, c,
                         plan.top, n, K, k0, min(plan.Kf, K - k0), plan.Kc, plan.stage, sm, bars,
                         clk);
  CR_CHAIN_CLOCK(31)
  CR_CHAIN_CLOCKS_OUT(c == 0 && q == 0, lv.out[0], (long long)nC * (T >> 1) * Db * K)
}

// The rows of x_l that segment s of S of a chain of T = 2^n fine rows
// needs, lo[l] .. hi[l] for l = 0 .. n (band._chain_intervals mirrors it):
// the segment's own fine rows at l = 0; x_{l-1}[2p] = x_l[p] and
// x_{l-1}[2p + 1] needs x_l[p], x_l[p + 1].
__host__ __device__ inline void chain_intervals(int n, int S, int s, int* lo, int* hi) {
  const int T = 1 << n, seg = T / S;
  lo[0] = s * seg;
  hi[0] = lo[0] + seg - 1;
  for (int l = 1; l <= n; ++l) {
    lo[l] = lo[l - 1] >> 1;
    const int up = (hi[l - 1] + 1) >> 1;
    hi[l] = up < (T >> l) - 1 ? up : (T >> l) - 1;
  }
}

// Level l's odd rows of the interval: positions plo .. plo + np - 1 of its
// blocks (np may be 0).
__host__ __device__ inline void chain_odd(int lo, int hi, int* plo, int* np) {
  *plo = lo >> 1;
  *np = hi >= 1 ? ((hi - 1) >> 1) - *plo + 1 : 0;
}

// Rows of a column a thread of the chain back substitution computes, and
// the threads of a thread block, by the rhs width. Narrow widths (4 < K <
// kReduceRegisterRowsK; K <= 4 takes cr_backsub_lanes_kernel): one, rv over
// the staged b, a barrier, then the thread's row of invD rv (all Db rows a
// thread ran Manhattan-4's direction pass 15.7 us against 14.3 before the
// lane-group kernel took the directions). Panels: all six at Db = 6, rv and x
// = invD rv in registers, no barrier between (a row a thread: 42.0 us
// against 32.4 at Manhattan-4's panel, 172 against 129 at the 2D fold);
// three at Db = 12 (the 3D fold's panel 118 us against 154 at one row and
// 163 at all twelve; 3D 1x1000's 21.0 against 24.8). NVIDIA H100 80GB
// HBM3, 700 W, builds of -DBAND_CR_CHAIN_BACKSUB_ROWS=n, which takes n rows
// a thread at both sizes and widths (0: Db).
template <int Db>
constexpr int chain_backsub_rows(bool panel) {
#ifdef BAND_CR_CHAIN_BACKSUB_ROWS
  return BAND_CR_CHAIN_BACKSUB_ROWS > 0 ? BAND_CR_CHAIN_BACKSUB_ROWS : Db;
#else
  return panel ? (Db == 12 ? 3 : Db) : 1;
#endif
}
template <int R>
constexpr int chain_backsub_threads() { return R == 1 ? 512 : 256; }

// The back substitution's level slots: level l's invD, A, C of its odd
// positions plo .. plo + np - 1 and their rows of b (a chunk of columns) in
// slot (l - 1) % D of a ring of D = min(n, kBacksubRing) slots; then the two
// x buffers. (A ring as deep as the levels, every level's copies in flight
// at once, measured slower at every cell, 1.0-1.7x: the shared memory of
// more levels for fewer thread blocks an SM; profile_port.py --cr --pass
// --sweep, NVIDIA H100 80GB HBM3, 700 W.)
constexpr int kBacksubRing = 3;
__host__ __device__ inline int chain_level_doubles(int np, int Db, int Kc) {
  return np > 0 ? np * (3 * Db * Db + Db * Kc) : 0;
}

// Level l's copies for the back substitution into q, one cp.async group:
// the invD, A, C blocks of the odd positions of the interval lo .. hi of
// x_{l-1} and their rows of b (columns k0 .. k0 + kc - 1 of a Kc chunk).
template <int Db>
__device__ __forceinline__ void chain_issue(const CrBacksubLevels& lv, double* q, int lo, int hi,
                                            int l, int c, int T, int K, int Kc, int kc, int k0) {
  constexpr int BS = Db * Db;
  int plo, np;
  chain_odd(lo, hi, &plo, &np);
  if (np > 0) {
    const long long rs = (long long)Db * K;
    const long long g = ((long long)c * (T >> l) + plo) * BS;
    stage_span(q, lv.invD[l - 1] + g, np * BS);
    stage_span(q + np * BS, lv.A[l - 1] + g, np * BS);
    stage_span(q + 2 * np * BS, lv.C[l - 1] + g, np * BS);
    stage_rhs(q + 3 * np * BS, Db * Kc,
              lv.b[l - 1] + ((long long)c * (T >> (l - 1)) + 2 * plo + 1) * rs + k0, 2 * rs, np,
              Db, K, Kc, kc);
  }
  cp_async_commit();
}

template <int Db, int R, int V>
__global__ void __launch_bounds__(chain_backsub_threads<R>(), 2)
cr_backsub_chain_kernel(const CrBacksubLevels lv, const double* __restrict__ xe,
                        double* __restrict__ x, int n, int K, int S, int Kc, int rows) {
#ifdef BAND_CR_CLOCKS
  long long clk[kChainClocks];
  if (threadIdx.x == 0)
    for (int i = 0; i < kChainClocks; ++i) clk[i] = 0;
#endif
  CR_CHAIN_CLOCK(0)
  extern __shared__ __align__(16) double sm[];
  constexpr int BS = Db * Db;
  constexpr int G = Db / R;  // threads a position and column
  const int T = 1 << n;
  const int c = blockIdx.x / S, s = blockIdx.x - c * S;
  const long long rs = (long long)Db * K;  // a position's stride in HBM
  const int RS = Db * Kc;                  // a staged row
  int lo[kCrMaxLevels + 1], hi[kCrMaxLevels + 1];
  chain_intervals(n, S, s, lo, hi);
  // the ring: level l in slot (l - 1) % D, each slot the widest of this
  // segment's levels it takes; off[j] its start, off[D] the x buffers'
  const int D = min(n, kBacksubRing);
  int off[kBacksubRing + 1];
  off[0] = 0;
  for (int j = 0; j < D; ++j) {
    int widest = 0;
    for (int l = j + 1; l <= n; l += D) {
      int plo, np;
      chain_odd(lo[l - 1], hi[l - 1], &plo, &np);
      widest = max(widest, chain_level_doubles(np, Db, Kc));
    }
    off[j + 1] = off[j] + widest;
  }
  double* xa = sm + off[D];  // x_l over its interval: two buffers of `rows`
  double* xb = xa + rows * RS;
  for (int k0 = 0; k0 < K; k0 += Kc) {
    const int kc = min(Kc, K - k0);
    // level l's copies into its slot, a cp.async group: its blocks and its
    // odd rows of b; levels n .. n - D + 1 at once, then one a level
    for (int l = n; l > n - D; --l)
      chain_issue<Db>(lv, sm + off[(l - 1) % D], lo[l - 1], hi[l - 1], l, c, T, K, Kc, kc, k0);
    if (k0 == 0) {
      CR_CHAIN_CLOCK(1)
    }
    double* cur = xa;
    double* nxt = xb;
    // x_n: the chain's one coarsest position
    for (int w = threadIdx.x; w < Db * kc; w += blockDim.x) {
      const int e = w / kc, k = w - e * kc;
      cur[e * Kc + k] = xe[c * rs + (long long)e * K + k0 + k];
    }
    for (int l = n; l >= 1; --l) {
      const int Tl = T >> l, ilo = lo[l - 1], ihi = hi[l - 1], xlo = lo[l];
      int plo, np;
      chain_odd(ilo, ihi, &plo, &np);
      // level l's group has landed (the levels issued after it may fly: D -
      // 1 of the first batch, then D - 2)
      cp_async_wait_upto(l == n ? min(D - 1, l - 1) : min(D - 2, l - 1));
      __syncthreads();  // and x_l is in the buffer, level l + 1's slot is free
      const int ahead = l - D + 1;  // into level l + 1's slot
      if (l < n && ahead >= 1)
        chain_issue<Db>(lv, sm + off[(ahead - 1) % D], lo[ahead - 1], hi[ahead - 1], ahead, c, T,
                        K, Kc, kc, k0);
      if (k0 == 0) {
        CR_CHAIN_CLOCK(2 + 2 * (n - l))
      }
      auto dst = [&](int i, int r, int k) -> double* {
        return l > 1 ? nxt + (i - ilo) * RS + r * Kc + k
                     : x + ((long long)c * T + i) * rs + (long long)r * K + k0 + k;
      };
      // x_{l-1}[2p] = x_l[p]
      const int e0 = (ilo + 1) >> 1, ne = (ihi >> 1) - e0 + 1;
      for (int w = threadIdx.x; w < ne * Db * kc; w += blockDim.x) {
        const int k = w % kc, t = w / kc, r = t % Db, p = e0 + t / Db;
        *dst(2 * p, r, k) = cur[(p - xlo) * RS + r * Kc + k];
      }
      // x_{l-1}[2p + 1] = invD ((b - A x_l[p]) - C x_l[p + 1]): R rows of a
      // column a thread
      double* blk = sm + off[(l - 1) % D];
      const double* Vb = blk;
      const double* Ab = blk + np * BS;
      const double* Cb = blk + 2 * np * BS;
      double* bs = blk + 3 * np * BS;
      const int per = kc / V;  // column groups: kc is even where V = 2
      const int items = (np > 0 ? np : 0) * G * per;
      for (int w = threadIdx.x; w < items; w += blockDim.x) {
        const int k = (w % per) * V, t = w / per, j = t / G, r0 = (t - j * G) * R;
        const int p = plo + j, o = j * BS;
        const double* xs = cur + (p - xlo) * RS + k;
        double* bw = bs + j * RS + k;
        double xv[Db][V], rv[R][V];
#pragma unroll
        for (int q = 0; q < Db; ++q) load_cols_shared<V>(xs + q * Kc, xv[q]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          double a[V] = {};
          row_times_cols<Db, V>(Ab + o + (r0 + i) * Db, xv, a);
#pragma unroll
          for (int v = 0; v < V; ++v) rv[i][v] = bw[(r0 + i) * Kc + v] - a[v];
        }
        if (p + 1 < Tl) {
#pragma unroll
          for (int q = 0; q < Db; ++q) load_cols_shared<V>(xs + RS + q * Kc, xv[q]);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            double a[V] = {};
            row_times_cols<Db, V>(Cb + o + (r0 + i) * Db, xv, a);
#pragma unroll
            for (int v = 0; v < V; ++v) rv[i][v] = rv[i][v] - a[v];
          }
        }
        if constexpr (R == Db) {
#pragma unroll
          for (int i = 0; i < Db; ++i) {
            double out[V] = {};
            row_times_cols<Db, V>(Vb + o + i * Db, rv, out);
            store_cols<V>(dst(2 * p + 1, i, k), out);
          }
        } else {
#pragma unroll
          for (int i = 0; i < R; ++i) bw[(r0 + i) * Kc] = rv[i][0];
        }
      }
      if constexpr (R < Db) {
        __syncthreads();  // every row of rv over the staged b
        for (int w = threadIdx.x; w < items; w += blockDim.x) {
          const int k = w % kc, t = w / kc, j = t / G, r0 = (t - j * G) * R;
          double rv[Db];
#pragma unroll
          for (int q = 0; q < Db; ++q) rv[q] = bs[j * RS + q * Kc + k];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            double out = 0.0;
            rows_times_col<Db, 1>(Vb + j * BS + (r0 + i) * Db, rv, &out);
            *dst(2 * plo + 2 * j + 1, r0 + i, k) = out;
          }
        }
      }
      if (k0 == 0) {
        CR_CHAIN_CLOCK(3 + 2 * (n - l))
      }
      double* t = cur;
      cur = nxt;
      nxt = t;
    }
    __syncthreads();  // the buffers and the slots are free for the next chunk
  }
  CR_CHAIN_CLOCK(31)
  CR_CHAIN_CLOCKS_OUT(blockIdx.x == 0, x, (long long)(gridDim.x / S) * T * rs)
}

// The directions' chain back substitution (K <= lanes_max_k): the
// narrow tile step's layout over a segment's whole ascent. A lane group a
// position (lane r a row, Lanes<Db>::group lanes), a group for each
// position of the segment's widest level, so a group takes at most one odd
// and one even position a level; its rows of that level's A, C, invD and b
// are read from L2 into registers (no staging), two levels ahead of the
// level computed. x_l over the segment's interval lies in one of two
// shared buffers; a lane reads the Db rows of x_l[p] and x_l[p + 1] there
// (broadcasts), and gathers the rows of (b - A x) - C x for its row of
// invD by shuffles of the group. One barrier a level. K is a template
// argument: every index is a constant but the level's.
template <int Db, int K>
struct LaneRows {
  double A[Db], C[Db], V[Db], b[K];
};

// Level l's rows of lane r of the group at odd position p (none where !on:
// zeros; no C where !up).
template <int Db, int K>
__device__ __forceinline__ void lanes_rows(const CrBacksubLevels& lv, int l, int c, int T, int p,
                                           bool on, bool up, int r, LaneRows<Db, K>& w) {
  constexpr int BS = Db * Db;
#pragma unroll
  for (int q = 0; q < Db; ++q) w.A[q] = w.C[q] = w.V[q] = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) w.b[k] = 0.0;
  if (!on) return;
  const long long o = ((long long)c * (T >> l) + p) * BS + r * Db;
#pragma unroll
  for (int q = 0; q < Db; q += 2) {
    const double2 a = ldg2(lv.A[l - 1] + o + q);
    const double2 v = ldg2(lv.invD[l - 1] + o + q);
    w.A[q] = a.x;
    w.A[q + 1] = a.y;
    w.V[q] = v.x;
    w.V[q + 1] = v.y;
    if (up) {
      const double2 m = ldg2(lv.C[l - 1] + o + q);
      w.C[q] = m.x;
      w.C[q + 1] = m.y;
    }
  }
  const double* bs = lv.b[l - 1] + ((long long)c * (T >> (l - 1)) + 2 * p + 1) * Db * K + r * K;
#pragma unroll
  for (int k = 0; k < K; ++k) w.b[k] = __ldg(bs + k);
}

// The interval lo .. hi of x_l that a segment of fine rows lo0 .. hi0 of a
// chain of T needs (chain_intervals in closed form: no array).
__device__ __forceinline__ void lanes_interval(int lo0, int hi0, int T, int l, int* lo, int* hi) {
  *lo = lo0 >> l;
  *hi = min((hi0 + (1 << l) - 1) >> l, (T >> l) - 1);
}

// Issues level l's rows of this lane (l >= 1 and a position of the group at
// that level; else zeros).
template <int Db, int K>
__device__ __forceinline__ void lanes_issue(const CrBacksubLevels& lv, int l, int c, int T,
                                            int lo0, int hi0, int g, int r, LaneRows<Db, K>& w) {
  int plo = 0, np = 0;
  if (l >= 1) {
    int lo, hi;
    lanes_interval(lo0, hi0, T, l - 1, &lo, &hi);
    chain_odd(lo, hi, &plo, &np);
  }
  lanes_rows<Db, K>(lv, l, c, T, plo + g, l >= 1 && r < Db && g < np,
                    l >= 1 && plo + g + 1 < (T >> l), r, w);
}

// Level l of cr_backsub_lanes_kernel: x_{l-1} over its interval from x_l
// (cur) into nxt, or into x in HBM at l = 1, with this lane's rows w (C
// zero where x_l[p + 1] is past the chain: the plain twin's C x_up with
// x_up = 0 subtracts +0.0 too). The K columns' chains are independent.
template <int Db, int K>
__device__ __forceinline__ void lanes_level(const LaneRows<Db, K>& w, const double* cur,
                                            double* nxt, double* x, int l, int c, int T,
                                            int lo0, int hi0, int g, int r) {
  constexpr int GL = Lanes<Db>::group;
  constexpr int RS = Db * K;  // a position's rows, in HBM and in the buffers
  int ilo, ihi, xlo, xhi, plo, np;
  lanes_interval(lo0, hi0, T, l - 1, &ilo, &ihi);
  lanes_interval(lo0, hi0, T, l, &xlo, &xhi);
  chain_odd(ilo, ihi, &plo, &np);
  double* out = l > 1 ? nxt + r * K - (long long)ilo * RS : x + ((long long)c * T) * RS + r * K;
  // x_{l-1}[2p] = x_l[p], a group a position
  const int e = ((ilo + 1) >> 1) + g;
  if (r < Db && 2 * e <= ihi) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[2 * e * RS + k] = cur[(e - xlo) * RS + r * K + k];
  }
  // x_{l-1}[2p + 1] = invD ((b - A x_l[p]) - C x_l[p + 1]), lane r row r
  const int p = plo + g;
  const bool on = r < Db && g < np;
  const double* xs = cur + (on ? p - xlo : 0) * RS;
  const double* xu = on && p + 1 <= xhi ? xs + RS : xs;
  double rv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) rv[k] = 0.0;
  if (on) {
    double a[K] = {}, u[K] = {};
#pragma unroll
    for (int q = 0; q < Db; ++q) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a[k] += w.A[q] * xs[q * K + k];
        u[k] += w.C[q] * xu[q * K + k];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) rv[k] = (w.b[k] - a[k]) - u[k];
  }
  double o[K] = {};
#pragma unroll
  for (int q = 0; q < Db; ++q) {
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] += w.V[q] * __shfl_sync(0xffffffffu, rv[k], q, GL);
  }
  if (on) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[(2 * p + 1) * RS + k] = o[k];
  }
}

// Threads of a cr_backsub_lanes_kernel block at most (three levels' rows
// in registers take more than the 128 registers a thread of 512 threads:
// ptxas spilled), and the most rhs columns it takes: 4 at Db = 6, 2 at Db =
// 12 (ptxas spilled at 3 and 4; cr_backsub_chain_kernel takes those).
constexpr int kLanesMaxThreads = 256;
template <int Db>
constexpr int lanes_max_k() { return Db == 12 ? 2 : kBacksubNarrowK; }

template <int Db, int K>
__global__ void __launch_bounds__(kLanesMaxThreads)
cr_backsub_lanes_kernel(const CrBacksubLevels lv, const double* __restrict__ xe,
                        double* __restrict__ x, int n, int S, int rows) {
#ifdef BAND_CR_CLOCKS
  long long clk[kChainClocks];
  if (threadIdx.x == 0)
    for (int i = 0; i < kChainClocks; ++i) clk[i] = 0;
#endif
  CR_CHAIN_CLOCK(0)
  extern __shared__ __align__(16) double sm[];
  constexpr int GL = Lanes<Db>::group;
  constexpr int RS = Db * K;
  const int T = 1 << n;
  const int c = blockIdx.x / S, s = blockIdx.x - c * S;
  const int g = threadIdx.x / GL, r = threadIdx.x & (GL - 1);
  const int lo0 = s * (T / S), hi0 = lo0 + T / S - 1;  // the segment's fine rows
  double* xa = sm;  // x_l over its interval: level l reads one, writes the other
  double* xb = sm + rows * RS;
  // level l's rows in w[(n - l) % 3]: levels n and n - 1 now, then each
  // level issues the one two below it into the set of the level above
  LaneRows<Db, K> w0, w1, w2;
  lanes_issue<Db, K>(lv, n, c, T, lo0, hi0, g, r, w0);
  lanes_issue<Db, K>(lv, n - 1, c, T, lo0, hi0, g, r, w1);
  for (int i = threadIdx.x; i < RS; i += blockDim.x) xa[i] = xe[(long long)c * RS + i];
  CR_CHAIN_CLOCK(1)
  __syncthreads();
  // three levels an iteration, so that each set of rows keeps its registers
  for (int l = n; l >= 1; l -= 3) {
    lanes_issue<Db, K>(lv, l - 2, c, T, lo0, hi0, g, r, w2);
    CR_CHAIN_CLOCK(2 + 2 * (n - l))
    lanes_level<Db, K>(w0, xa, xb, x, l, c, T, lo0, hi0, g, r);
    CR_CHAIN_CLOCK(3 + 2 * (n - l))
    __syncthreads();  // x_{l-1} is whole, x_l free
    if (l == 1) break;
    lanes_issue<Db, K>(lv, l - 3, c, T, lo0, hi0, g, r, w0);
    CR_CHAIN_CLOCK(2 + 2 * (n - l + 1))
    lanes_level<Db, K>(w1, xb, xa, x, l - 1, c, T, lo0, hi0, g, r);
    CR_CHAIN_CLOCK(3 + 2 * (n - l + 1))
    __syncthreads();
    if (l == 2) break;
    lanes_issue<Db, K>(lv, l - 4, c, T, lo0, hi0, g, r, w1);
    CR_CHAIN_CLOCK(2 + 2 * (n - l + 2))
    lanes_level<Db, K>(w2, xa, xb, x, l - 2, c, T, lo0, hi0, g, r);
    CR_CHAIN_CLOCK(3 + 2 * (n - l + 2))
    __syncthreads();
    // x_{l-3} is in xb: the next iteration reads xa
    double* t = xa;
    xa = xb;
    xb = t;
  }
  CR_CHAIN_CLOCK(31)
  CR_CHAIN_CLOCKS_OUT(blockIdx.x == 0, x, (long long)(gridDim.x / S) * T * RS)
}

// ---------------------------------------------------------------------
// band_pcr_solve: all PCR levels of the rhs replay plus x = invD b in one
// launch. Three kernels, by block size and shape (ops/band.py picks):
//
// Db = 6: a thread block holds a chunk of the rhs columns of one chain in
// shared memory, in ONE (Tp, Db, Kc) buffer updated in place: a thread
// keeps a level's outputs in registers across the block barrier that ends
// the level's reads, adds them into the buffer, and a second barrier opens
// the next level.
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
//   narrow (K <= 4, and any K on chains longer than 256): one thread per
//          (position, row) and CT in {1, 2, 4} columns, IT items per
//          thread; the Db rows of a position and its two neighbour
//          products lie on neighbouring lanes, whose 16-byte loads of E,
//          F rows (8 * Db bytes a row) are contiguous across the warp,
//          and for IT * Db <= 24 all of a level's loads start,
//          unconditionally, before the first is used.
//
// What bounds them on an H100 (profile_port.py --ablate, PERF.md): the E
// and F of a level, which every block of a chain reads again from L2. One
// SM pulls a level of a 256-long chain (147 KB) in about 1.2 us, so a
// direction solve (K = 1, one block per chain) spends over half of its time
// there; the panel's blocks together draw about 4 TB/s from L2, and the two
// tiles a block keeps in flight do not hide that: a third of the panel's
// time is these copies, a third the products (bound by shared-memory
// reads), the rest the rhs in and out and the barriers.
//
// Db = 12: pcr_solve_cluster_kernel, below.
// ---------------------------------------------------------------------

// profile_port.py --ablate builds this file with -DBAND_NO_STAGING (the
// level loop of band_pcr_solve moves no E, F) and -DBAND_NO_PRODUCT (the
// wide kernel's level loop multiplies nothing) to price those parts, and
// profile_port.py --sweep3d and --kernels with -DBAND_LEVEL_NO_INVERSE
// (the Db = 12 band_pcr_level, band_cr_level and band_block_inv form no
// inverse) and -DBAND_CLUSTER_CLOCKS (the
// cluster band_pcr_solve writes its first worker's clocks over x); the
// results are then wrong, and no other build defines them.
constexpr int kWideCols = 8;
constexpr int kWideMaxT = 256;     // also the most threads of a wide block
constexpr int kWideRing = 3;
constexpr int kNarrowThreads = 512;
// Accumulators per thread of the narrow kernel, IT * CT (Db = 6).
constexpr int kNarrowAcc = 24;

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
  // 2 * Db * IT doubles of E, F rows in registers: IT <= 4 at Db = 6,
  // IT <= 2 at Db = 12
  constexpr bool kPreload = IT * Db <= 24;
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

// ---------------------------------------------------------------------
// band_pcr_solve at Db = 12: one thread-block cluster per chain.
//
// Replaces pallas_pcr.py:_solve_kernel (:433) at 12 x 12 blocks. What
// bounded the narrow kernel there: one SM per (chain, column) pulled all
// levels of E and F (4.7 MB at a chain of 256) at ~67 GB/s, and the panel's
// 18 thread blocks pulled them again each.
//
// Mapping: a cluster of P thread blocks (P a power of two up to 16, P
// dividing Tp) serves one chain and a chunk of Kc rhs columns (grid: nC * P
// by the chunks). Block p of the cluster owns positions [p n, (p + 1) n),
// n = Tp / P, and keeps their rows of the rhs, all Kc columns, in its own
// shared memory, in two (n, Db, Kc) buffers: level l reads buffer l % 2
// and writes the other. The neighbours' rows at i -+ s are read from the
// block that owns them through distributed shared memory (mapa, then
// ld.shared::cluster), and one cluster barrier a level, split into its arrive (release, after
// the block's writes) and its wait (acquire, before the next reads), orders
// both the writes before the next level's reads and this level's reads
// before the next level's writes. The barrier is about half of a level's
// time at P = 16 on an H100; signals between the two partner blocks of a
// level on mbarriers of their own took longer.
// The owned positions' E and F rows of a level are contiguous (n * 1152
// bytes each) and pass through a ring of two stages: the block's last
// thread, in a warp of its own, starts the next level's stage as two 1D bulk
// copies (cp.async.bulk) completing on the stage's mbarrier while a level
// is computed; the last stage holds invD. (More stages in flight at the
// start held up the first barrier behind their copies, and a computing
// thread that starts them begins its level late.) So every block reads E,
// F and invD once per solve, whatever K is, and a chain's blocks share
// them P ways. A worker thread owns up to kClusterItems (position, column)
// pairs and RG rows of each, their offsets worked out once: acc from 0.0,
// E's terms then F's with j ascending, then b += acc, as the narrow
// kernel; x = invD b with j ascending from 0.0. RG = 1 (a thread a row)
// where the workers allow, for directions; 3 for up to kClusterWide
// pairs; else 12, the whole strip, each neighbour element read once for
// its 12 rows.
// ---------------------------------------------------------------------

constexpr int kClusterThreads = 384;
constexpr int kClusterMax = 16;
constexpr int kClusterWide = 96;
// stages of the E, F ring: the next level's copies fly while a level is
// computed (more in flight at the start held up the first barrier: an
// SM's copies queue behind each other)
constexpr int kClusterRing = 2;
constexpr int kClusterItems = 4;  // (position, row group, column) a thread


// Stage `lev` of the ring (slot lev % R): the owned positions' E and F of
// level lev, or after the last level their invD, as 1D bulk copies that
// complete on the slot's mbarrier. Called by one thread.
template <int Db>
__device__ __forceinline__ void cluster_stage(double* ring, unsigned long long* bars,
                                              const double* E, const double* F,
                                              const double* invD, int lev, int L,
                                              int R, int nC, int c, int Tp, int i0,
                                              int n) {
  constexpr int BS = Db * Db;
  const int slot = lev % R;
  double* dst = ring + (size_t)slot * 2 * n * BS;
  const unsigned side = (unsigned)n * BS * sizeof(double);  // a multiple of 16
  const unsigned bar = smem_addr(bars + slot);
  const bool level = lev < L;
  const long long o = (((long long)lev * nC + c) * Tp + i0) * BS;
  const double* first = level ? E + o : invD + ((long long)c * Tp + i0) * BS;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(level ? 2 * side : side)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(first), "r"(side), "r"(bar)
      : "memory");
  if (level)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst + n * BS)),
        "l"(F + o), "r"(side), "r"(bar)
        : "memory");
}

// The address in the cluster's shared window of `p` (a location of this
// block's shared memory) at the same offset in block `rank`, and a load
// through it (the block's own rank included).
__device__ __forceinline__ unsigned cluster_addr(const double* p, int rank) {
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra)
               : "r"(smem_addr(p)), "r"(rank));
  return ra;
}

__device__ __forceinline__ double ld_cluster(unsigned addr) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n" : "=d"(v) : "r"(addr) : "memory");
  return v;
}

// The cluster-wide barrier in two halves: arrive (release: this thread's
// writes before it are visible to the cluster after the wait) and wait
// (acquire). Every thread of every block arrives and waits alternately.
__device__ __forceinline__ void cluster_barrier_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int Db, int RG>
__global__ void __launch_bounds__(kClusterThreads)
pcr_solve_cluster_kernel(const double* __restrict__ E,
                         const double* __restrict__ F,
                         const double* __restrict__ invD,
                         const double* __restrict__ b, double* __restrict__ x,
                         int nC, int Tp, int L, int K, int Kc, int R) {
  namespace cg = cooperative_groups;
  static_assert(Db % RG == 0 && Db % 2 == 0, "row groups of whole rows");
  constexpr int BS = Db * Db;
  constexpr int NG = Db / RG;  // row groups of a position
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int p = (int)cluster.block_rank();
  const int c = blockIdx.x / P;
  const int n = Tp / P;
  const int i0 = p * n;
  const int k0 = blockIdx.y * Kc;
  const int kc = min(Kc, K - k0);
  const int RS = n * Db * Kc;  // doubles of one rhs buffer
  extern __shared__ __align__(16) double smem[];
  __shared__ __align__(8) unsigned long long bars[kClusterRing];
  double* rhs = smem;                 // [level parity][n][Db][Kc]
  double* ring = smem + 2 * RS;       // [slot][E | F][n][BS]; invD in E's place
  const int stages = max(1, min(R - 1, L + 1));  // started before the first level
#ifdef BAND_CLUSTER_CLOCKS
  long long clk[1 + 3 * 10];  // L <= 9
  clk[0] = clock64();
#endif

  if (threadIdx.x == blockDim.x - 1) {
    for (int m = 0; m < R; ++m) mbar_init(bars + m, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {  // the owned rows of the rhs into buffer 0, before the ring's copies
     // queue ahead of them
    const double* src = b + ((long long)c * Tp + i0) * Db * K + k0;
    for (int idx = threadIdx.x; idx < n * Db * kc; idx += blockDim.x) {
      const int row = idx / kc, kk = idx - row * kc;
      rhs[row * Kc + kk] = src[(long long)row * K + kk];
    }
  }
  __syncthreads();
  if (threadIdx.x == blockDim.x - 1)
    for (int lev = 0; lev < stages; ++lev)
      cluster_stage<Db>(ring, bars, E, F, invD, lev, L, R, nC, c, Tp, i0, n);
  // A thread's items (position j, row group g, column kk) are the same at
  // every level: at most kClusterItems of them (the launch checks it),
  // their offsets worked out once. The block's last warp has none: its
  // last thread starts the ring's copies.
  const int items = n * kc * NG;
  const int workers = blockDim.x - 32;
  const bool producer = threadIdx.x == blockDim.x - 1;
  int off[kClusterItems], pos[kClusterItems];
#pragma unroll
  for (int m = 0; m < kClusterItems; ++m) {
    const int item = threadIdx.x + m * workers;
    const int kk = item % kc, rest = item / kc;
    const int g = rest % NG, j = rest / NG;
    pos[m] = threadIdx.x < workers && item < items ? j : -1;
    off[m] = (j * Db + g * RG) * Kc + kk;  // of row g RG of the rhs buffer
  }
  cluster_barrier_arrive();  // this block's level-0 rows are written

  for (int lev = 0; lev < L; ++lev) {
    mbar_wait(bars + lev % R, (lev / R) & 1);  // this level's E, F
    cluster_barrier_wait();  // every block's level-lev rows are written
#ifdef BAND_CLUSTER_CLOCKS
    clk[1 + 3 * lev] = clock64();
#endif
    // the slot level lev - 1 used (its reads are done) takes the stage
    // R - 1 levels ahead
    if (producer && lev + R - 1 <= L)
      cluster_stage<Db>(ring, bars, E, F, invD, lev + R - 1, L, R, nC, c, Tp, i0, n);
#ifdef BAND_CLUSTER_CLOCKS
    clk[2 + 3 * lev] = clock64();
#endif
    const int s = 1 << lev;
    const double* cur = rhs + (lev & 1) * RS;
    double* nxt = rhs + ((lev + 1) & 1) * RS;
    const double* Es = ring + (size_t)(lev % R) * 2 * n * BS;
#pragma unroll
    for (int m = 0; m < kClusterItems; ++m) {
      const int j = pos[m];
      if (j < 0) continue;
      const int i = i0 + j;
      const int o = off[m];
      const int kk = o % Kc;
      const int g = (o / Kc - j * Db) / RG;
      // both neighbours' rows first (zeros outside the chain), so their
      // loads, local or remote, are in flight together
      double bv[2][Db];
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int nb = side == 0 ? i - s : i + s;
        const bool in = nb >= 0 && nb < Tp;
        const int q = in ? nb / n : p;
        const unsigned src =
            cluster_addr(cur + (in ? nb - q * n : 0) * Db * Kc + kk, q);
#pragma unroll
        for (int jj = 0; jj < Db; ++jj)
          bv[side][jj] = in ? ld_cluster(src + jj * Kc * (unsigned)sizeof(double)) : 0.0;
      }
      double acc[RG];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) acc[rr] = 0.0;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int nb = side == 0 ? i - s : i + s;
        if (nb < 0 || nb >= Tp) continue;
        const double* M = Es + side * n * BS + j * BS + g * RG * Db;
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
#pragma unroll
          for (int jj = 0; jj < Db; jj += 2) {
            const double2 mm = *reinterpret_cast<const double2*>(M + rr * Db + jj);
            acc[rr] += mm.x * bv[side][jj];
            acc[rr] += mm.y * bv[side][jj + 1];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) nxt[o + rr * Kc] = cur[o + rr * Kc] + acc[rr];
    }
#ifdef BAND_CLUSTER_CLOCKS
    clk[3 + 3 * lev] = clock64();
#endif
    // this block's level-(lev + 1) rows are written and its level-lev reads
    // done; the next level waits for every block's arrival
    cluster_barrier_arrive();
  }
  mbar_wait(bars + L % R, (L / R) & 1);  // invD
  cluster_barrier_wait();  // no block reads another's memory after this

  // x = invD b on the block's own rows
  const double* cur = rhs + (L & 1) * RS;
  const double* Vs = ring + (size_t)(L % R) * 2 * n * BS;
  double* xdst = x + ((long long)c * Tp + i0) * Db * K + k0;
#pragma unroll
  for (int m = 0; m < kClusterItems; ++m) {
    const int j = pos[m];
    if (j < 0) continue;
    const int o = off[m];
    const int kk = o % Kc;
    const int g = (o / Kc - j * Db) / RG;
    double bv[Db];
#pragma unroll
    for (int jj = 0; jj < Db; ++jj) bv[jj] = cur[(j * Db + jj) * Kc + kk];
    const double* M = Vs + j * BS + g * RG * Db;
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      double out = 0.0;
#pragma unroll
      for (int jj = 0; jj < Db; jj += 2) {
        const double2 mm = *reinterpret_cast<const double2*>(M + rr * Db + jj);
        out += mm.x * bv[jj];
        out += mm.y * bv[jj + 1];
      }
      xdst[(long long)(j * Db + g * RG + rr) * K + kk] = out;
    }
  }
#ifdef BAND_CLUSTER_CLOCKS
  // the first worker's clocks at each level's barrier, after its stage
  // wait and after its products, from the kernel's start, over x
  if (threadIdx.x == 0 && blockIdx.y == 0)
    for (int m = 0; m < 1 + 3 * L; ++m) x[blockIdx.x * 32 + m] = (double)(clk[m] - clk[0]);
#endif
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

// The cluster kernel's launch: opts in to cluster sizes above 8 and to the
// shared memory the plan asks for (a refusal returns its error), checks
// that the card can place one cluster of this shape (cached per shape),
// and launches with cudaLaunchKernelEx.
template <int Db, int RG>
cudaError_t launch_cluster_rg(const double* E, const double* F, const double* invD,
                              const double* b, double* x, int nC, int Tp, int L,
                              int K, int P, int Kc, int R, size_t smem, int threads,
                              cudaStream_t st) {
  auto kern = pcr_solve_cluster_kernel<Db, RG>;
  static bool nonportable = false;
  static size_t allowed = 0;
  // shapes whose placement was checked: (P, threads, smem bytes)
  static long long placed[16][3];
  static int nplaced = 0;
  cudaError_t err;
  // a refusal is returned, and cleared from the runtime's last error so
  // that the next launch's check does not report it again
  auto refused = [](cudaError_t e) {
    cudaGetLastError();
    return e;
  };
  if (!nonportable) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return refused(err);
    nonportable = true;
  }
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return refused(err);
    allowed = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nC * P, (K + Kc - 1) / Kc);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  bool known = false;
  for (int m = 0; m < nplaced && !known; ++m)
    known = placed[m][0] == P && placed[m][1] == threads && placed[m][2] == (long long)smem;
  if (!known) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return refused(err);
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    if (nplaced < 16) {
      placed[nplaced][0] = P;
      placed[nplaced][1] = threads;
      placed[nplaced][2] = (long long)smem;
      ++nplaced;
    }
  }
  err = cudaLaunchKernelEx(&cfg, kern, E, F, invD, b, x, nC, Tp, L, K, Kc, R);
  if (err != cudaSuccess) return refused(err);
  return cudaGetLastError();
}

// P: the cluster size, Kc: the columns of a chunk, as ops/band.py planned
// them (band._solve_cluster_plan, which leaves room for a ring of two
// stages). The ring takes as many stages as the rest of the shared memory
// holds, up to kClusterRingMax and the L + 1 stages of a solve.
template <int Db>
cudaError_t launch_cluster(const double* E, const double* F, const double* invD,
                           const double* b, double* x, int nC, int Tp, int L,
                           int K, int P, int Kc, cudaStream_t st) {
  if (P < 1 || P > kClusterMax || (P & (P - 1)) || Tp % P || Kc < 1 ||
      (K + Kc - 1) / Kc > 65535 || (long long)nC * P > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int n = Tp / P;
  const size_t rhs = (size_t)2 * n * Db * Kc * sizeof(double);
  const size_t stage = (size_t)2 * n * Db * Db * sizeof(double);
  const int R = L >= 1 ? kClusterRing : 1;
  const size_t smem = rhs + R * stage;
  const long long pairs = (long long)n * (K < Kc ? K : Kc);  // (position, column)
  constexpr int kWorkers = kClusterThreads - 32;  // and the producer's warp
  if (pairs > (long long)kClusterItems * kWorkers) return cudaErrorInvalidValue;
  // the fewest rows a thread that the workers allow: a thread a row for
  // directions, a quarter of them, or the whole strip
  auto threads = [](long long work) {
    return (int)((work < kWorkers ? (work + 31) / 32 * 32 : kWorkers) + 32);
  };
  if (pairs * Db <= kWorkers)
    return launch_cluster_rg<Db, 1>(E, F, invD, b, x, nC, Tp, L, K, P, Kc, R, smem,
                                    threads(pairs * Db), st);
  if (pairs < kClusterWide)
    return launch_cluster_rg<Db, 3>(E, F, invD, b, x, nC, Tp, L, K, P, Kc, R, smem,
                                    threads(pairs * (Db / 3)), st);
  return launch_cluster_rg<Db, Db>(E, F, invD, b, x, nC, Tp, L, K, P, Kc, R, smem,
                                   threads(pairs), st);
}

inline int grid_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// One launch of each kernel at block size Db (the C entries below pick Db).

template <int Db>
cudaError_t launch_init_a(const double* U, double* A, int nC, int Tp,
                          cudaStream_t st) {
  const long long n = (long long)nC * Tp * Db * Db;
  init_a_kernel<Db><<<grid_for(n, 256), 256, 0, st>>>(U, A, nC, Tp);
  return cudaGetLastError();
}

template <int Db>
cudaError_t launch_block_inv(const double* D, double* invD, long long nblocks,
                             cudaStream_t st) {
  if constexpr (Db == 12) {
    if (nblocks > 0x7fffffff) return cudaErrorInvalidValue;  // a thread block a block
    block_inv_element_kernel<Db><<<(unsigned)nblocks, Db * Db, 0, st>>>(D, invD);
  } else {
    constexpr int per_block = kBlockInvThreads / Lanes<Db>::group;
    block_inv_kernel<Db><<<grid_for(nblocks, per_block), kBlockInvThreads, 0, st>>>(
        D, invD, nblocks);
  }
  return cudaGetLastError();
}

template <int Db>
cudaError_t launch_pcr_level(const double* D, const double* A, const double* Cc,
                             const double* invD, double* E, double* F,
                             double* D2, double* A2, double* C2, double* invD2,
                             int nC, int Tp, int s, cudaStream_t st) {
  if constexpr (Db == 12) {
    pcr_level_element_kernel<Db><<<grid_for((long long)nC * Tp, kLevelPositions),
                                   kLevelPositions * Db * Db, 0, st>>>(
        D, A, Cc, invD, E, F, D2, A2, C2, invD2, nC, Tp, s);
  } else {
    constexpr int warps = Lanes<Db>::level_warps;
    constexpr int per_block = warps * Lanes<Db>::per_warp;
    pcr_level_kernel<Db><<<grid_for((long long)nC * Tp, per_block), warps * 32, 0, st>>>(
        D, A, Cc, invD, E, F, D2, A2, C2, invD2, nC, Tp, s);
  }
  return cudaGetLastError();
}

template <int Db, int P>
void launch_cr_level_element(const double* D, const double* A, const double* Cc,
                             double* E, double* F, double* invDo, double* Ao,
                             double* Co, double* D2, double* A2, double* C2,
                             int nC, int Th, cudaStream_t st) {
  cr_level_element_kernel<Db, P><<<grid_for((long long)nC * Th, P), (P + 1) * Db * Db,
                                    0, st>>>(
      D, A, Cc, E, F, invDo, Ao, Co, D2, A2, C2, nC, Th);
}

// P: coarse positions a thread block at Db = 12, 1 or 3 (band._cr_level_tile);
// 1 at Db = 6, whose thread block is 15 positions
template <int Db>
cudaError_t launch_cr_level(const double* D, const double* A, const double* Cc,
                            double* E, double* F, double* invDo, double* Ao,
                            double* Co, double* D2, double* A2, double* C2,
                            int nC, int Th, int P, cudaStream_t st) {
  if constexpr (Db == 12) {
    if (P == 1)
      launch_cr_level_element<Db, 1>(D, A, Cc, E, F, invDo, Ao, Co, D2, A2, C2, nC, Th, st);
    else if (P == 3)
      launch_cr_level_element<Db, 3>(D, A, Cc, E, F, invDo, Ao, Co, D2, A2, C2, nC, Th, st);
    else
      return cudaErrorInvalidValue;
  } else {
    if (P != 1) return cudaErrorInvalidValue;
    constexpr int groups = Lanes<Db>::cr_groups;
    cr_level_kernel<Db><<<grid_for((long long)nC * Th, groups - 1),
                          groups * Lanes<Db>::group, 0, st>>>(
        D, A, Cc, E, F, invDo, Ao, Co, D2, A2, C2, nC, Th);
  }
  return cudaGetLastError();
}

// band_cr_factor: n levels (1 to kCrMaxLevels) of nC chains of T, tiles of
// P positions of level n (a power of two dividing T >> n); invDn (only
// where T >> n == 1) takes the last block's inverse, else D2, A2, C2 the
// level-n band. A plan past the limits, or a block size other than
// kFactorBlock, returns cudaErrorInvalidValue.
template <int Db>
cudaError_t launch_cr_factor(const double* D, const double* A, const double* Cc,
                             const CrFactorLevels& lv, double* D2, double* A2, double* C2,
                             double* invDn, int nC, int n, int T, int P, cudaStream_t st) {
  if constexpr (Db != kFactorBlock) {
    return cudaErrorInvalidValue;
  } else {
    if (n < 1 || n > kCrMaxLevels || T < 2 || T % (1 << n) || P < 1 || (P & (P - 1)) ||
        (T >> n) % P || (invDn != nullptr && (T >> n) != 1) ||
        (invDn == nullptr && (D2 == nullptr || A2 == nullptr || C2 == nullptr)))
      return cudaErrorInvalidValue;
    const long long blocks = (long long)nC * ((T >> n) / P);
    const long long smem = cr_factor_smem(n, T, P, Db, invDn != nullptr);
    if (blocks > 0x7fffffff || smem > 232448) return cudaErrorInvalidValue;
    static bool allowed = false;
    const cudaError_t err = allow_smem(cr_factor_kernel<Db, kFactorThreads>, &allowed);
    if (err != cudaSuccess) return err;
    cr_factor_kernel<Db, kFactorThreads><<<(unsigned)blocks, kFactorThreads, smem, st>>>(
        D, A, Cc, lv, D2, A2, C2, invDn, n, T, P);
    return cudaGetLastError();
  }
}

// Shared memory of one thread block of band_cr_reduce: every level's E and
// F at its own and halo positions, the fine rows with the left halo, and
// level 1's output (deeper levels reuse the two buffers).
inline long long cr_reduce_smem(int n, int Db, int P, int Kc) {
  long long d = 0;
  for (int lev = 1; lev <= n; ++lev)
    d += 2 * ((((long long)P + 1) << (n - lev)) - 1) * Db * Db;
  d += ((((long long)P + 1) << n) - 1) * Db * Kc;
  if (n > 1) d += ((((long long)P + 1) << (n - 1)) - 1) * Db * Kc;
  return d * (long long)sizeof(double);
}

// Shared memory of one thread block of band_cr_backsub: the solution buffer
// (none for one level of the register steps) and, for the element kernel,
// every level's invD, A, C and odd rows of b.
inline long long cr_backsub_smem(int n, int Db, int P, int Kc, bool element) {
  const long long rows = (((long long)P << n) + 1) * Db * Kc;
  if (!element) return n > 1 ? rows * (long long)sizeof(double) : 0;
  long long d = rows;
  for (int lev = n; lev >= 1; --lev)
    d += ((long long)P << (n - lev)) * (3LL * Db * Db + (long long)Db * Kc);
  return d * (long long)sizeof(double);
}

// A plan the kernels take: 1 to kCrMaxLevels levels that halve T, a tile
// of 1 to T >> n coarsest positions, chunks of 1 to K columns, and a grid
// and shared memory the card launches.
inline bool cr_plan_ok(int nC, int n, int T, int K, int P, int Kc, long long smem) {
  if (n < 1 || n > kCrMaxLevels || T < 1 || T % (1 << n) || P < 1 || P > (T >> n) ||
      Kc < 1 || Kc > K || smem > 232448)
    return false;
  const long long tiles = ((T >> n) + P - 1) / P;
  return (long long)nC * tiles <= 0x7fffffff && (K + Kc - 1) / Kc <= 65535;
}

// Threads of a fused CR thread block: whole warps for the first level's
// items (it has the most), at most `most`.
inline int cr_threads(long long items, int most) {
  return (int)(items < most ? (items + 31) / 32 * 32 : most);
}

inline dim3 cr_grid(int nC, int n, int T, int K, int P, int Kc) {
  return dim3(nC * (((T >> n) + P - 1) / P), (K + Kc - 1) / Kc);
}

template <int Db, int R>
cudaError_t launch_cr_reduce_rows(const CrReduceLevels& lv, const double* b, int nC, int n,
                                  int T, int K, int P, int Kc, size_t smem,
                                  cudaStream_t st) {
  static bool allowed = false;
  const cudaError_t err = allow_smem(cr_reduce_levels_kernel<Db, R>, &allowed);
  if (err != cudaSuccess) return err;
  // the first level's items (it has the most): positions, threads of one, columns
  const long long items = ((((long long)P + 1) << (n - 1)) - 1) * (Db / R) * (K < Kc ? K : Kc);
  cr_reduce_levels_kernel<Db, R><<<cr_grid(nC, n, T, K, P, Kc),
                                   cr_threads(items, R == 1 ? kCrReduceRowThreads : kCrThreads),
                                   smem, st>>>(lv, b, n, T, K, P, Kc);
  return cudaGetLastError();
}

template <int Db>
cudaError_t launch_cr_reduce(const CrReduceLevels& lv, const double* b, int nC, int n,
                             int T, int K, int P, int Kc, cudaStream_t st) {
  const long long smem = cr_reduce_smem(n, Db, P, Kc);
  if (!cr_plan_ok(nC, n, T, K, P, Kc, smem)) return cudaErrorInvalidValue;
  if (K >= kReduceRegisterRowsK)
    return launch_cr_reduce_rows<Db, Db>(lv, b, nC, n, T, K, P, Kc, smem, st);
  return launch_cr_reduce_rows<Db, 1>(lv, b, nC, n, T, K, P, Kc, smem, st);
}

template <int Db, int S>
cudaError_t launch_cr_backsub_steps(const CrBacksubLevels& lv, const double* xe, double* x,
                                    int nC, int n, int T, int K, int P, int Kc, size_t smem,
                                    long long items, cudaStream_t st) {
  if (n == 1) {  // the per-level kernels' grids: every position of every chain
    const long long pos = (long long)nC * (T >> 1);
    if (Kc != K || pos > 0x7fffffff) return cudaErrorInvalidValue;
    if constexpr (S == 0) {
      constexpr int per_block = kBacksubNarrowThreads / Lanes<Db>::group;
      cr_backsub_narrow_kernel<Db><<<grid_for(pos, per_block), kBacksubNarrowThreads, 0, st>>>(
          lv.invD[0], lv.A[0], lv.C[0], lv.b[0], xe, x, (int)pos, T >> 1, K);
    } else {
      const long long w = pos * (K / S);
      if (w > 0x7fffffff) return cudaErrorInvalidValue;
      cr_backsub_wide_kernel<Db, S><<<grid_for(w, kBacksubWideThreads), kBacksubWideThreads, 0,
                                      st>>>(lv.invD[0], lv.A[0], lv.C[0], lv.b[0], xe, x,
                                            (int)pos, T >> 1, K);
    }
    return cudaGetLastError();
  }
  static bool allowed = false;
  const cudaError_t err = allow_smem(cr_backsub_levels_kernel<Db, S>, &allowed);
  if (err != cudaSuccess) return err;
  cr_backsub_levels_kernel<Db, S><<<cr_grid(nC, n, T, K, P, Kc), cr_threads(items, kCrThreads),
                                    smem, st>>>(lv, xe, x, n, T, K, P, Kc);
  return cudaGetLastError();
}

// The step by the rhs width, as band._backsub_step plans for it: narrow for
// K <= 4, else wide at Db = 6 (column pairs where K and Kc are even and the
// rhs arrays 16-byte aligned) and the element kernel at Db = 12.
template <int Db>
cudaError_t launch_cr_backsub(const CrBacksubLevels& lv, const double* xe, double* x,
                              int nC, int n, int T, int K, int P, int Kc, cudaStream_t st) {
  const bool element = Db == 12 && K > kBacksubNarrowK;
  const long long smem = cr_backsub_smem(n, Db, P, Kc, element);
  if (!cr_plan_ok(nC, n, T, K, P, Kc, smem)) return cudaErrorInvalidValue;
  const long long finest = (long long)P << (n - 1);  // positions of the finest level
  const int kc = K < Kc ? K : Kc;
  if (K <= kBacksubNarrowK) {
    if (Kc != K) return cudaErrorInvalidValue;
    return launch_cr_backsub_steps<Db, 0>(lv, xe, x, nC, n, T, K, P, Kc, smem,
                                          finest * Lanes<Db>::group, st);
  }
  if constexpr (Db == 12) {
    static bool allowed = false;
    constexpr int R = kBacksubElementRows;
    const cudaError_t err = allow_smem(cr_backsub_element_kernel<Db, R>, &allowed);
    if (err != cudaSuccess) return err;
    cr_backsub_element_kernel<Db, R><<<cr_grid(nC, n, T, K, P, Kc),
                                       cr_threads(finest * (Db / R) * kc, kCrElementThreads),
                                       smem, st>>>(lv, xe, x, n, T, K, P, Kc);
    return cudaGetLastError();
  } else {
    auto aligned16 = [](const void* p) {
      return reinterpret_cast<unsigned long long>(p) % 16 == 0;
    };
    bool pairs = K % 2 == 0 && Kc % 2 == 0 && aligned16(xe) && aligned16(x);
    for (int l = 0; l < n; ++l) pairs = pairs && aligned16(lv.b[l]);
    if (pairs)
      return launch_cr_backsub_steps<Db, 2>(lv, xe, x, nC, n, T, K, P, Kc, smem,
                                            finest * (kc / 2), st);
    return launch_cr_backsub_steps<Db, 1>(lv, xe, x, nC, n, T, K, P, Kc, smem, finest * kc,
                                          st);
  }
}

// Shared memory of cr_reduce_tree_kernel: the more of its stages' (the
// tile's, cr_reduce_smem; the whole chain's: its E, F where staged, and one
// or two chunks of Kc columns of its rows), and kTreeHeader doubles for the
// flag of the chain's last ticket and the whole chain's mbarriers.
inline long long cr_tree_reduce_smem(int n, int Db, int K, const CrReducePlan& p) {
  const long long Tc = (1LL << n) >> p.top;
  const int chunks = ((p.top ? p.Kf : K) + p.Kc - 1) / p.Kc;
  long long d = ((chunks > 1 ? 2 : 1) * Tc * Db * p.Kc + (p.stage ? 2 * (Tc - 1) * Db * Db : 0)) *
                (long long)sizeof(double);
  if (p.top) {
    const long long f = cr_reduce_smem(p.top, Db, p.P, p.Kf);
    if (f > d) d = f;
  }
  return d + kTreeHeader * (long long)sizeof(double);
}

// A plan the tree kernel takes: a tile stage below n levels with tiles of a
// power of two of positions, chunks of 1 to K columns (the whole chain's
// within the tile stage's), and, where the whole chain's rows come from the
// tile stage, 16-byte reads (every column, or K, Kf and Kc even).
inline bool cr_tree_plan_ok(int n, int K, const CrReducePlan& p) {
  if (n < 1 || n > kCrMaxLevels || p.top < 0 || p.top >= n || p.Kc < 1 || p.Kc > K)
    return false;
  if (p.top == 0) return true;
  return p.Kf >= 1 && p.Kf <= K && p.Kc <= p.Kf && p.P >= 1 && (p.P & (p.P - 1)) == 0 &&
         p.P <= ((1 << n) >> p.top) &&
         (p.Kc == K || (K % 2 == 0 && p.Kf % 2 == 0 && p.Kc % 2 == 0));
}

template <int Db, int R, int V, bool TILES>
cudaError_t launch_cr_reduce_tree_rows(const CrReduceLevels& lv, const double* b, int* tickets,
                                       int nC, int n, int K, const CrReducePlan& p,
                                       long long smem, cudaStream_t st) {
  static bool allowed = false;
  const cudaError_t err = allow_smem(cr_reduce_tree_kernel<Db, R, V, TILES>, &allowed);
  if (err != cudaSuccess) return err;
  constexpr int G = Db / R;
  const int T = 1 << n;
  const long long blocks =
      p.top ? (long long)nC * ((T >> p.top) / p.P) * ((K + p.Kf - 1) / p.Kf) : nC;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  // the most items of a stage's first level: the whole chain's, the tile's
  const int W = p.top ? p.Kf : K;  // the whole chain's columns a thread block
  long long items = (long long)((T >> p.top) >> 1) * G * ((W < p.Kc ? W : p.Kc) / V);
  if (p.top) {
    const long long t = (long long)(((p.P + 1) << (p.top - 1)) - 1) * G * (K < p.Kf ? K : p.Kf);
    if (t > items) items = t;
  }
  cr_reduce_tree_kernel<Db, R, V, TILES><<<(unsigned)blocks, cr_threads(items, kCrThreads), smem,
                                           st>>>(lv, b, tickets, n, K, p);
  return cudaGetLastError();
}

template <int Db, int R, int V>
cudaError_t launch_cr_reduce_tree_tiles(const CrReduceLevels& lv, const double* b, int* tickets,
                                        int nC, int n, int K, const CrReducePlan& p,
                                        long long smem, cudaStream_t st) {
  if (p.top)
    return launch_cr_reduce_tree_rows<Db, R, V, true>(lv, b, tickets, nC, n, K, p, smem, st);
  return launch_cr_reduce_tree_rows<Db, R, V, false>(lv, b, tickets, nC, n, K, p, smem, st);
}

// band_cr_reduce on a run of n levels that ends at one position a chain, as
// band._chain_plan planned it (CrReducePlan). The rows that one stage
// writes and another reads move in 16-byte units through L2 (cp.async.cg).
template <int Db>
cudaError_t launch_cr_reduce_tree(const CrReduceLevels& lv, const double* b, int* tickets,
                                  int nC, int n, int K, const CrReducePlan& p, cudaStream_t st) {
  if (!cr_tree_plan_ok(n, K, p) || (p.top > 0 && tickets == nullptr))
    return cudaErrorInvalidValue;
  const long long smem = cr_tree_reduce_smem(n, Db, K, p);
  if (smem > 232448) return cudaErrorInvalidValue;
  // the panel: several rows a thread, and column pairs (double2) where
  // every chunk's width falls on 16-byte boundaries (half the rows a thread
  // at Db = 6: all six by two columns took more than 128 registers)
  if (K >= kReduceRegisterRowsK && K % 2 == 0 && p.Kc % 2 == 0)
    return launch_cr_reduce_tree_tiles<Db, Db == 6 ? 3 : chain_rows<Db>(), 2>(lv, b, tickets, nC,
                                                                              n, K, p, smem, st);
  if (K >= kReduceRegisterRowsK)
    return launch_cr_reduce_tree_tiles<Db, chain_rows<Db>(), 1>(lv, b, tickets, nC, n, K, p,
                                                                smem, st);
  return launch_cr_reduce_tree_tiles<Db, 1, 1>(lv, b, tickets, nC, n, K, p, smem, st);
}

// cr_backsub_chain_kernel over S segments of a chain of 2^n: the shared
// memory (the most over the segments of its ring's slots, each the widest of
// the levels it takes, and two x buffers of `rows` positions of Kc columns),
// `rows` (the longest interval of x_l, l >= 1) and the most positions p of
// a level.
inline void cr_chain_backsub_shape(int n, int Db, int S, int Kc, long long* smem, int* rows,
                                   int* items) {
  const int D = n < kBacksubRing ? n : kBacksubRing;
  long long blocks = 0;
  int r = 1, it = 1;
  for (int s = 0; s < S; ++s) {
    int lo[kCrMaxLevels + 1], hi[kCrMaxLevels + 1];
    chain_intervals(n, S, s, lo, hi);
    int widest[kBacksubRing] = {};
    for (int l = 1; l <= n; ++l) {
      int plo, np;
      chain_odd(lo[l - 1], hi[l - 1], &plo, &np);
      const int d = chain_level_doubles(np, Db, Kc);
      if (d > widest[(l - 1) % D]) widest[(l - 1) % D] = d;
      if (hi[l] - lo[l] + 1 > r) r = hi[l] - lo[l] + 1;
      const int its = (hi[l - 1] >> 1) - (lo[l - 1] >> 1) + 1;
      if (its > it) it = its;
    }
    long long bl = 0;
    for (int j = 0; j < D; ++j) bl += widest[j];
    if (bl > blocks) blocks = bl;
  }
  *rows = r;
  *items = it;
  *smem = (blocks + 2LL * r * Db * Kc) * (long long)sizeof(double);
}

template <int Db, int R, int V>
cudaError_t launch_cr_backsub_chain_cols(const CrBacksubLevels& lv, const double* xe, double* x,
                                         int nC, int n, int K, int S, int Kc, int rows,
                                         long long smem, int items, cudaStream_t st) {
  static bool allowed = false;
  const cudaError_t err = allow_smem(cr_backsub_chain_kernel<Db, R, V>, &allowed);
  if (err != cudaSuccess) return err;
  cr_backsub_chain_kernel<Db, R, V><<<nC * S,
                                      cr_threads((long long)items * (Db / R) *
                                                     ((K < Kc ? K : Kc) / V),
                                                 chain_backsub_threads<R>()),
                                      smem, st>>>(lv, xe, x, n, K, S, Kc, rows);
  return cudaGetLastError();
}

// cr_backsub_lanes_kernel: a lane group for each of the `items` positions
// of a segment's widest level (at most kLanesMaxThreads), two x buffers of
// `rows` positions.
template <int Db, int K>
cudaError_t launch_cr_backsub_lanes(const CrBacksubLevels& lv, const double* xe, double* x,
                                    int nC, int n, int S, int rows, int items, cudaStream_t st) {
  const long long lanes = (long long)items * Lanes<Db>::group;
  const long long smem = 2LL * rows * Db * K * (long long)sizeof(double);
  if (lanes > kLanesMaxThreads || smem > 232448) return cudaErrorInvalidValue;
  static bool allowed = false;
  const cudaError_t err = allow_smem(cr_backsub_lanes_kernel<Db, K>, &allowed);
  if (err != cudaSuccess) return err;
  cr_backsub_lanes_kernel<Db, K><<<nC * S, cr_threads(lanes, kLanesMaxThreads), smem, st>>>(
      lv, xe, x, n, S, rows);
  return cudaGetLastError();
}

// band_cr_backsub on a run of n levels that ends at one position a chain:
// S segments a chain (a power of two up to 2^n), chunks of Kc columns.
template <int Db>
cudaError_t launch_cr_backsub_chain(const CrBacksubLevels& lv, const double* xe, double* x,
                                    int nC, int n, int K, int S, int Kc, cudaStream_t st) {
  if (n < 1 || n > kCrMaxLevels || S < 1 || S > (1 << n) || (S & (S - 1)) || Kc < 1 ||
      Kc > K || (long long)nC * S > 0x7fffffff)
    return cudaErrorInvalidValue;
  long long smem;
  int rows, items;
  cr_chain_backsub_shape(n, Db, S, Kc, &smem, &rows, &items);
  if (K <= lanes_max_k<Db>()) {  // the directions: a lane group a position
    if (Kc != K) return cudaErrorInvalidValue;
    if (K == 1) return launch_cr_backsub_lanes<Db, 1>(lv, xe, x, nC, n, S, rows, items, st);
    if (K == 2) return launch_cr_backsub_lanes<Db, 2>(lv, xe, x, nC, n, S, rows, items, st);
    if constexpr (lanes_max_k<Db>() == 4) {
      if (K == 3) return launch_cr_backsub_lanes<Db, 3>(lv, xe, x, nC, n, S, rows, items, st);
      return launch_cr_backsub_lanes<Db, 4>(lv, xe, x, nC, n, S, rows, items, st);
    }
  }
  if (smem > 232448) return cudaErrorInvalidValue;
  constexpr int R = chain_backsub_rows<Db>(true);
  if (K < kReduceRegisterRowsK)
    return launch_cr_backsub_chain_cols<Db, chain_backsub_rows<Db>(false), 1>(
        lv, xe, x, nC, n, K, S, Kc, rows, smem, items, st);
  // column pairs (double2) where a thread holds all Db rows and every
  // chunk's width and the output's columns fall on 16-byte boundaries
  if constexpr (R == Db) {
    if (K % 2 == 0 && Kc % 2 == 0 && reinterpret_cast<unsigned long long>(x) % 16 == 0)
      return launch_cr_backsub_chain_cols<Db, R, 2>(lv, xe, x, nC, n, K, S, Kc, rows, smem,
                                                    items, st);
  }
  return launch_cr_backsub_chain_cols<Db, R, 1>(lv, xe, x, nC, n, K, S, Kc, rows, smem, items, st);
}

template <int Db>
cudaError_t launch_pcr_solve(const double* E, const double* F, const double* invD,
                             const double* b, double* x, int nC, int Tp, int L,
                             int K, int ct, int groups, cudaStream_t st) {
  if constexpr (Db == 12) {
    return launch_cluster<Db>(E, F, invD, b, x, nC, Tp, L, K, ct, groups, st);
  } else {
    switch (ct) {
      case 8:  // the wide kernel's Db x 8 register tile
        return launch_wide<Db>(E, F, invD, b, x, nC, Tp, L, K, groups, st);
      case 4:
        return launch_narrow<Db, 4>(E, F, invD, b, x, nC, Tp, L, K, st);
      case 2:
        return launch_narrow<Db, 2>(E, F, invD, b, x, nC, Tp, L, K, st);
      case 1:
        return launch_narrow<Db, 1>(E, F, invD, b, x, nC, Tp, L, K, st);
    }
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// The instantiated block sizes: 6 (2D) and 12 (3D).
#define BAND_DISPATCH(Db, call)              \
  switch (Db) {                              \
    case 6: {                                \
      constexpr int kDb = 6;                 \
      return (int)call;                      \
    }                                        \
    case 12: {                               \
      constexpr int kDb = 12;                \
      return (int)call;                      \
    }                                        \
    default:                                 \
      return (int)cudaErrorInvalidValue;     \
  }

extern "C" {

const char* band_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int band_init_a(const double* U, double* A, int nC, int Tp, int Db,
                void* stream) {
  if ((long long)nC * Tp == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_init_a<kDb>(U, A, nC, Tp, st))
}

int band_block_inv(const double* D, double* invD, long long nblocks, int Db,
                   void* stream) {
  if (nblocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_block_inv<kDb>(D, invD, nblocks, st))
}

int band_pcr_level(const double* D, const double* A, const double* Cc,
                   const double* invD, double* E, double* F, double* D2,
                   double* A2, double* C2, double* invD2, int nC, int Tp,
                   int Db, int s, void* stream) {
  if ((long long)nC * Tp == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_pcr_level<kDb>(D, A, Cc, invD, E, F, D2, A2, C2, invD2,
                                          nC, Tp, s, st))
}

int band_cr_level(const double* D, const double* A, const double* Cc,
                  double* E, double* F, double* invDo, double* Ao, double* Co,
                  double* D2, double* A2, double* C2, int nC, int Th, int Db, int P,
                  void* stream) {
  const long long n = (long long)nC * Th;
  if (n == 0) return 0;
  if (n > 0x3fffffff) return (int)cudaErrorInvalidValue;  // 2t + 1 as an int
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_cr_level<kDb>(D, A, Cc, E, F, invDo, Ao, Co, D2, A2, C2,
                                         nC, Th, P, st))
}

// A run of `levels` compacting levels of a factor in one launch (fine
// length T, tiles of P positions of the run's last level, as
// band._factor_tile planned them): each level's E, F, invD, A, C into lv;
// the last level's band into D2, A2, C2, or, where it has one position a
// chain, that block's inverse into invDn (D2, A2, C2 unused, may be null).
// Db = 6 only.
int band_cr_factor(const double* D, const double* A, const double* Cc, CrFactorLevels lv,
                   double* D2, double* A2, double* C2, double* invDn, int levels, int nC,
                   int T, int Db, int P, void* stream) {
  if ((long long)nC * T == 0) return 0;
  if ((long long)nC * T > 0x3fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_cr_factor<kDb>(D, A, Cc, lv, D2, A2, C2, invDn, nC, levels, T, P,
                                          st))
}

// Every compacting level of a solve in one launch: levels (1 to
// kCrMaxLevels) halve the fine chain length T; P and Kc, the tile of
// coarsest positions and the rhs columns of a thread block, as
// ops/band.py planned them (band._cr_plan). A plan past the limits returns
// cudaErrorInvalidValue.
int band_cr_reduce(CrReduceLevels lv, const double* b, int levels, int nC, int T,
                   int Db, int K, int P, int Kc, void* stream) {
  if ((long long)nC * T * K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_cr_reduce<kDb>(lv, b, nC, levels, T, K, P, Kc, st))
}

int band_cr_backsub(CrBacksubLevels lv, const double* xe, double* x, int levels, int nC,
                    int T, int Db, int K, int P, int Kc, void* stream) {
  if ((long long)nC * T * K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_cr_backsub<kDb>(lv, xe, x, nC, levels, T, K, P, Kc, st))
}

// band_cr_reduce / band_cr_backsub on a run that ends at one position a
// chain (levels halve the chain 2^levels to 1): the reduce by the plan of
// band._chain_plan (CrReducePlan) with `tickets` (zero, as many as the
// plan's counters; zero again after the launch; unused without tile
// stages); the back substitution's segments S a chain and chunk Kc.
int band_cr_reduce_chain(CrReduceLevels lv, const double* b, int* tickets, int levels, int nC,
                         int Db, int K, CrReducePlan plan, void* stream) {
  if ((long long)nC * K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_cr_reduce_tree<kDb>(lv, b, tickets, nC, levels, K, plan, st))
}

int band_cr_backsub_chain(CrBacksubLevels lv, const double* xe, double* x, int levels, int nC,
                          int Db, int K, int S, int Kc, void* stream) {
  if ((long long)nC * K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_cr_backsub_chain<kDb>(lv, xe, x, nC, levels, K, S, Kc, st))
}

// Db = 6: ct, the columns of a thread's register tile, as ops/band.py chose
// them: 8 runs the wide kernel with `groups` threads per position (8 *
// groups columns per block), 1, 2 or 4 the narrow one. Db = 12: ct is the
// cluster size P and groups the columns of a chunk Kc of the cluster
// kernel (ops/band.py's _solve_cluster_plan; profile_port.py --sweep3d
// times P = 4, 8, 16).
int band_pcr_solve(const double* E, const double* F, const double* invD,
                   const double* b, double* x, int nC, int Tp, int Db, int L,
                   int K, int ct, int groups, void* stream) {
  if (nC == 0 || K == 0 || Tp == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  BAND_DISPATCH(Db, launch_pcr_solve<kDb>(E, F, invD, b, x, nC, Tp, L, K, ct,
                                          groups, st))
}

}  // extern "C"
