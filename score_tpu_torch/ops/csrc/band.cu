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

// out = sign * (P @ Q)
template <int Db>
__device__ __forceinline__ void matmul(const double* P, const double* Q,
                                       double* out, double sign) {
#pragma unroll
  for (int r = 0; r < Db; ++r) {
#pragma unroll
    for (int c = 0; c < Db; ++c) {
      double acc = 0.0;
#pragma unroll
      for (int k = 0; k < Db; ++k) acc += P[r * Db + k] * Q[k * Db + c];
      out[r * Db + c] = sign * acc;
    }
  }
}

// out += P @ Q
template <int Db>
__device__ __forceinline__ void matmul_acc(const double* P, const double* Q,
                                           double* out) {
#pragma unroll
  for (int r = 0; r < Db; ++r) {
#pragma unroll
    for (int c = 0; c < Db; ++c) {
      double acc = 0.0;
#pragma unroll
      for (int k = 0; k < Db; ++k) acc += P[r * Db + k] * Q[k * Db + c];
      out[r * Db + c] += acc;
    }
  }
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

// One PCR level at shift s. One thread per (chain, position).
template <int Db>
__global__ void __launch_bounds__(128)
pcr_level_kernel(const double* __restrict__ D, const double* __restrict__ A,
                 const double* __restrict__ Cc, double* __restrict__ E,
                 double* __restrict__ F, double* __restrict__ D2,
                 double* __restrict__ A2, double* __restrict__ C2, int nC,
                 int Tp, int s) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nC * Tp) return;
  const int i = (int)(t % Tp);
  const long long bs = (long long)Db * Db;
  const bool has_dn = i - s >= 0;
  const bool has_up = i + s < Tp;

  double Ev[Db * Db], Fv[Db * Db], X[Db * Db], Y[Db * Db];
  // E = -A_i invD_{i-s}
  if (has_dn) {
    load_block<Db>(D + (t - s) * bs, Y);
    inv_spd<Db>(Y, X);
    load_block<Db>(A + t * bs, Y);
    matmul<Db>(Y, X, Ev, -1.0);
  } else {
#pragma unroll
    for (int e = 0; e < Db * Db; ++e) Ev[e] = 0.0;
  }
  // F = -C_i invD_{i+s}
  if (has_up) {
    load_block<Db>(D + (t + s) * bs, Y);
    inv_spd<Db>(Y, X);
    load_block<Db>(Cc + t * bs, Y);
    matmul<Db>(Y, X, Fv, -1.0);
  } else {
#pragma unroll
    for (int e = 0; e < Db * Db; ++e) Fv[e] = 0.0;
  }
  store_block<Db>(E + t * bs, Ev);
  store_block<Db>(F + t * bs, Fv);

  // D' = D_i + (E C_{i-s} + F A_{i+s});  A' = E A_{i-s};  C' = F C_{i+s}
  double S[Db * Db];
#pragma unroll
  for (int e = 0; e < Db * Db; ++e) S[e] = 0.0;
  if (has_dn) {
    load_block<Db>(Cc + (t - s) * bs, Y);
    matmul_acc<Db>(Ev, Y, S);
    load_block<Db>(A + (t - s) * bs, Y);
    matmul<Db>(Ev, Y, X, 1.0);
  } else {
#pragma unroll
    for (int e = 0; e < Db * Db; ++e) X[e] = 0.0;
  }
  store_block<Db>(A2 + t * bs, X);
  if (has_up) {
    load_block<Db>(A + (t + s) * bs, Y);
    matmul_acc<Db>(Fv, Y, S);
    load_block<Db>(Cc + (t + s) * bs, Y);
    matmul<Db>(Fv, Y, X, 1.0);
  } else {
#pragma unroll
    for (int e = 0; e < Db * Db; ++e) X[e] = 0.0;
  }
  store_block<Db>(C2 + t * bs, X);
  load_block<Db>(D + t * bs, Y);
#pragma unroll
  for (int e = 0; e < Db * Db; ++e) Y[e] = Y[e] + S[e];
  store_block<Db>(D2 + t * bs, Y);
}

// One compacting cyclic-reduction (CR) level. One thread per (chain, coarse
// position j): fine row 2j is kept and reduced exactly as a PCR level at
// s = 1 reduces it; the odd neighbours 2j -+ 1 are eliminated. The thread
// also stores what the solve's back-substitution needs for odd row 2j + 1
// (its inverse, and its input couplings A, C). Inputs are at the fine
// length 2*Th, outputs at the coarse length Th; fine row 2j of chain c is
// block 2*t for t = c*Th + j, so the compaction costs no gather.
template <int Db>
__global__ void __launch_bounds__(128)
cr_level_kernel(const double* __restrict__ D, const double* __restrict__ A,
                const double* __restrict__ Cc, double* __restrict__ E,
                double* __restrict__ F, double* __restrict__ invDo,
                double* __restrict__ Ao, double* __restrict__ Co,
                double* __restrict__ D2, double* __restrict__ A2,
                double* __restrict__ C2, int nC, int Th) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nC * Th) return;
  const int j = (int)(t % Th);
  const long long bs = (long long)Db * Db;
  const long long f = 2 * t;       // kept fine row 2j
  const long long up = f + 1;      // odd row 2j + 1: always inside the chain
  const bool has_dn = j > 0;       // odd row 2j - 1

  double Ev[Db * Db], Fv[Db * Db], X[Db * Db], Y[Db * Db];
  // F = -C_{2j} invD_{2j+1}; invD_{2j+1}, A_{2j+1}, C_{2j+1} kept
  load_block<Db>(D + up * bs, Y);
  inv_spd<Db>(Y, X);
  store_block<Db>(invDo + t * bs, X);
  load_block<Db>(Cc + f * bs, Y);
  matmul<Db>(Y, X, Fv, -1.0);
  store_block<Db>(F + t * bs, Fv);
  load_block<Db>(A + up * bs, Y);
  store_block<Db>(Ao + t * bs, Y);
  load_block<Db>(Cc + up * bs, Y);
  store_block<Db>(Co + t * bs, Y);
  // E = -A_{2j} invD_{2j-1}
  if (has_dn) {
    load_block<Db>(D + (f - 1) * bs, Y);
    inv_spd<Db>(Y, X);
    load_block<Db>(A + f * bs, Y);
    matmul<Db>(Y, X, Ev, -1.0);
  } else {
#pragma unroll
    for (int e = 0; e < Db * Db; ++e) Ev[e] = 0.0;
  }
  store_block<Db>(E + t * bs, Ev);

  // D' = D_{2j} + (E C_{2j-1} + F A_{2j+1});  A' = E A_{2j-1};  C' = F C_{2j+1}
  double S[Db * Db];
#pragma unroll
  for (int e = 0; e < Db * Db; ++e) S[e] = 0.0;
  if (has_dn) {
    load_block<Db>(Cc + (f - 1) * bs, Y);
    matmul_acc<Db>(Ev, Y, S);
    load_block<Db>(A + (f - 1) * bs, Y);
    matmul<Db>(Ev, Y, X, 1.0);
  } else {
#pragma unroll
    for (int e = 0; e < Db * Db; ++e) X[e] = 0.0;
  }
  store_block<Db>(A2 + t * bs, X);
  load_block<Db>(A + up * bs, Y);
  matmul_acc<Db>(Fv, Y, S);
  load_block<Db>(Cc + up * bs, Y);
  matmul<Db>(Fv, Y, X, 1.0);
  store_block<Db>(C2 + t * bs, X);
  load_block<Db>(D + f * bs, Y);
#pragma unroll
  for (int e = 0; e < Db * Db; ++e) Y[e] = Y[e] + S[e];
  store_block<Db>(D2 + t * bs, Y);
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

// All PCR levels of the rhs replay plus x = invD b in one launch.
// Block (c, chunk) holds rhs columns [chunk*Kc, chunk*Kc + Kc) of chain c
// in shared memory as two (Tp, Db, Kc) buffers; levels are separated by
// block barriers.
template <int Db>
__global__ void __launch_bounds__(256)
pcr_solve_kernel(const double* __restrict__ E, const double* __restrict__ F,
                 const double* __restrict__ invD,
                 const double* __restrict__ b, double* __restrict__ x,
                 int nC, int Tp, int L, int K, int Kc) {
  extern __shared__ double smem[];
  double* cur = smem;
  double* nxt = smem + (size_t)Tp * Db * Kc;
  const int c = blockIdx.x;
  const int k0 = blockIdx.y * Kc;
  const long long bs = (long long)Db * Db;
  const int nfill = Tp * Db * Kc;

  for (int idx = threadIdx.x; idx < nfill; idx += blockDim.x) {
    const int kk = idx % Kc;
    const int r = (idx / Kc) % Db;
    const int i = idx / (Kc * Db);
    const int k = k0 + kk;
    cur[idx] = (k < K) ? b[(((long long)c * Tp + i) * Db + r) * K + k] : 0.0;
  }
  __syncthreads();

  const int nwork = Tp * Kc;
  for (int lev = 0; lev < L; ++lev) {
    const int s = 1 << lev;
    const double* El = E + ((long long)lev * nC + c) * Tp * bs;
    const double* Fl = F + ((long long)lev * nC + c) * Tp * bs;
    for (int w = threadIdx.x; w < nwork; w += blockDim.x) {
      const int kk = w % Kc;
      const int i = w / Kc;
      double acc[Db];
#pragma unroll
      for (int r = 0; r < Db; ++r) acc[r] = 0.0;
      if (i - s >= 0) {
        const double* Ei = El + (long long)i * bs;
        const double* bd = cur + (size_t)(i - s) * Db * Kc + kk;
#pragma unroll
        for (int r = 0; r < Db; ++r) {
          double a = 0.0;
#pragma unroll
          for (int j = 0; j < Db; ++j) a += Ei[r * Db + j] * bd[j * Kc];
          acc[r] = a;
        }
      }
      if (i + s < Tp) {
        const double* Fi = Fl + (long long)i * bs;
        const double* bu = cur + (size_t)(i + s) * Db * Kc + kk;
#pragma unroll
        for (int r = 0; r < Db; ++r) {
          double a = 0.0;
#pragma unroll
          for (int j = 0; j < Db; ++j) a += Fi[r * Db + j] * bu[j * Kc];
          acc[r] += a;
        }
      }
      const size_t o = (size_t)i * Db * Kc + kk;
#pragma unroll
      for (int r = 0; r < Db; ++r) nxt[o + r * Kc] = cur[o + r * Kc] + acc[r];
    }
    __syncthreads();
    double* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int w = threadIdx.x; w < nwork; w += blockDim.x) {
    const int kk = w % Kc;
    const int i = w / Kc;
    const int k = k0 + kk;
    if (k >= K) continue;
    const double* Vi = invD + ((long long)c * Tp + i) * bs;
    const double* bi = cur + (size_t)i * Db * Kc + kk;
#pragma unroll
    for (int r = 0; r < Db; ++r) {
      double a = 0.0;
#pragma unroll
      for (int j = 0; j < Db; ++j) a += Vi[r * Db + j] * bi[j * Kc];
      x[(((long long)c * Tp + i) * Db + r) * K + k] = a;
    }
  }
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
                   double* E, double* F, double* D2, double* A2, double* C2,
                   int nC, int Tp, int Db, int s, void* stream) {
  const long long n = (long long)nC * Tp;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Db) {
    case 6:
      pcr_level_kernel<6><<<grid_for(n, 128), 128, 0, st>>>(
          D, A, Cc, E, F, D2, A2, C2, nC, Tp, s);
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (Db) {
    case 6:
      cr_level_kernel<6><<<grid_for(n, 128), 128, 0, st>>>(
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

int band_pcr_solve(const double* E, const double* F, const double* invD,
                   const double* b, double* x, int nC, int Tp, int Db, int L,
                   int K, int Kc, void* stream) {
  if (nC == 0 || K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = 2 * (size_t)Tp * Db * Kc * sizeof(double);
  const dim3 grid(nC, (K + Kc - 1) / Kc);
  cudaError_t err;
  switch (Db) {
    case 6:
      err = cudaFuncSetAttribute(pcr_solve_kernel<6>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      pcr_solve_kernel<6><<<grid, 256, smem, st>>>(E, F, invD, b, x, nC, Tp,
                                                   L, K, Kc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
