// Batched small-block Cholesky and forward substitution in f32.
//
// Hand-written Hopper (sm_90a) port of the two Pallas TPU kernels in
// score_tpu/ops/pallas_blocks.py. See score_tpu_torch/ops/blocks.py for the
// plain PyTorch twin of each kernel and the Python wrappers that launch
// these entry points. Callers: the f32 band (cyclic reduction,
// score_tpu_torch/solver/pcr.py) at D = 6 and the QCQP range elimination's
// pivot inverses at D = 2, through score_tpu_torch/solver/smallblocks.py.
//
// Layouts (all contiguous, row-major, f32):
//   A, L : (M, D, D)     B, Y : (M, D, K)
// The TPU kernels put the batch on the 128 lanes, (D, D, M), so that every
// step of the unrolled recurrence is one full-width vector op. On the card
// a thread takes the batch index instead, and the blocks keep the port's
// (M, D, D) layout.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns the cudaError_t of the launch (0 = ok).
// Kernels are templated on the block size D; D = 2 and D = 6 are
// instantiated.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Replaces _chol_kernel (pallas_blocks.py:36). One thread per block: the
// block's lower triangle lives in registers, columns are formed in the
// left-looking order of the plain twin (column j = (A[:, j] - sum_{k<j}
// L[:, k] L[j, k]) / sqrt(pivot)), and the strictly-upper triangle is
// written as zero. A non-positive pivot gives NaN, as in the twin.
// Bound: at the f32 path's sizes (M = 1024..2070 blocks, 66..295 KB read
// and written) the traffic takes well under a microsecond at an H100
// SXM's 3.35 TB/s (data sheet, 700 W), so the launch latency sets the
// time; the design spends nothing on coalescing (each thread reads its
// own 144-byte block through L1).
template <int D>
__global__ void __launch_bounds__(kThreads)
chol_kernel(const float* __restrict__ A, float* __restrict__ L, long long M) {
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const float* a = A + m * D * D;
  float* l = L + m * D * D;
  float Lr[D][D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float c[D];
#pragma unroll
    for (int i = j; i < D; ++i) c[i] = a[i * D + j];
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const float ljk = Lr[j][k];
#pragma unroll
      for (int i = j; i < D; ++i) c[i] = c[i] - Lr[i][k] * ljk;
    }
    const float piv = sqrtf(c[j]);
#pragma unroll
    for (int i = j; i < D; ++i) Lr[i][j] = c[i] / piv;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) l[i * D + j] = (j <= i) ? Lr[i][j] : 0.0f;
  }
}

// Replaces _tri_solve_kernel (pallas_blocks.py:79). One thread per (block
// m, rhs column), flat index m * K + column, so neighbouring threads read
// and write neighbouring columns of B and Y. Rows are solved in the twin's
// order and divided by L_ii (the TPU kernel multiplies by a reciprocal;
// both compute the same function). The threads of one thread block share
// few L blocks (one or two for the arrow panel, K = 138..258; 128 for a
// single column): they are staged once into shared memory with coalesced
// loads, at most kThreads blocks since 128 consecutive indices span at
// most 128 values of m.
// Bound: a wide panel moves B in and Y out (6.9 MB at Manhattan-4's first
// level, ~2 us at an H100 SXM's 3.35 TB/s, data sheet, 700 W), so memory
// bounds it there; a single column is latency-bound.
template <int D>
__global__ void __launch_bounds__(kThreads)
tri_lower_kernel(const float* __restrict__ L, const float* __restrict__ B,
                 float* __restrict__ Y, long long M, int K) {
  __shared__ float sL[kThreads * D * D];
  const long long total = M * K;
  const long long t0 = (long long)blockIdx.x * kThreads;
  const long long t_last = (t0 + kThreads - 1 < total) ? t0 + kThreads - 1 : total - 1;
  const long long m_lo = t0 / K;
  const int nL = (int)(t_last / K - m_lo + 1);
  const float* Lsrc = L + m_lo * D * D;
  for (int e = threadIdx.x; e < nL * D * D; e += kThreads) sL[e] = Lsrc[e];
  __syncthreads();

  const long long t = t0 + threadIdx.x;
  if (t >= total) return;
  const long long m = t / K;
  const long long col = t - m * K;
  const float* l = sL + (m - m_lo) * D * D;
  const float* b = B + m * D * K + col;
  float* y = Y + m * D * K + col;
  float rows[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float r = b[(long long)i * K];
#pragma unroll
    for (int k = 0; k < i; ++k) r = r - l[i * D + k] * rows[k];
    rows[i] = r / l[i * D + i];
    y[(long long)i * K] = rows[i];
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

int block_chol(const float* A, float* L, long long M, int D, void* stream) {
  if (M == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = grid_for(M, kThreads);
  switch (D) {
    case 2:
      chol_kernel<2><<<grid, kThreads, 0, st>>>(A, L, M);
      break;
    case 6:
      chol_kernel<6><<<grid, kThreads, 0, st>>>(A, L, M);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int block_tri_lower_solve(const float* L, const float* B, float* Y,
                          long long M, int D, int K, void* stream) {
  if (M == 0 || K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = grid_for(M * K, kThreads);
  switch (D) {
    case 2:
      tri_lower_kernel<2><<<grid, kThreads, 0, st>>>(L, B, Y, M, K);
      break;
    case 6:
      tri_lower_kernel<6><<<grid, kThreads, 0, st>>>(L, B, Y, M, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
