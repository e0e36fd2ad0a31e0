// Batched small-block Cholesky and triangular substitutions in f32.
//
// Hand-written Hopper (sm_90a) port of the two Pallas TPU kernels in
// score_tpu/ops/pallas_blocks.py. See score_tpu_torch/ops/blocks.py for the
// plain PyTorch twin of each kernel and the Python wrappers that launch
// these entry points. Callers: the f32 band (cyclic reduction,
// score_tpu_torch/solver/pcr.py) at D = 6 and the QCQP range elimination's
// pivot inverses at D = 2, through score_tpu_torch/solver/smallblocks.py.
//
// Layouts (row-major, f32; L, Y, X contiguous; A read through its block
// stride, B through its three strides):
//   A, L : (M, D, D)     B, Y, X : (M, D, K)
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

// Stages n blocks of D x D floats, block b at src + b * sbm (a multiple of 4
// floats; 16-byte aligned; each block contiguous), into shared memory at a
// padded stride of D * D + 1 floats, so that lanes working on different
// blocks read distinct banks. The 16-byte unit q = tid + u * nthreads goes
// to thread tid: neighbouring threads load neighbouring units, and a
// thread's U loads are all issued before the first store. U must cover the
// units: n * D * D / 4 <= U * nthreads.
template <int D, int U>
__device__ __forceinline__ void stage_blocks(const float* __restrict__ src,
                                             long long sbm, int n, float* dst,
                                             int tid, int nthreads) {
  constexpr int Q = D * D / 4;  // 16-byte units per block
  constexpr int LS = D * D + 1;
  static_assert(D * D % 4 == 0, "a 16-byte unit stays inside one block");
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = tid + u * nthreads;
    if (q < n * Q)
      v[u] = __ldg(reinterpret_cast<const float4*>(src + (q / Q) * sbm + 4 * (q % Q)));
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = tid + u * nthreads;
    if (q < n * Q) {
      float* d = dst + (q / Q) * LS + 4 * (q % Q);
      d[0] = v[u].x;
      d[1] = v[u].y;
      d[2] = v[u].z;
      d[3] = v[u].w;
    }
  }
}

// Replaces _chol_kernel (pallas_blocks.py:36). A thread owns one block: the
// thread block's blocks are staged by stage_blocks (16-byte loads on
// neighbouring addresses, all in flight together, A read through its block
// stride so that the f32 band's odd-row view costs no copy), a thread reads
// its block from shared memory, forms the lower triangle in registers in
// the plain twin's left-looking column order (column j = (A[:, j] -
// sum_{k<j} L[:, k] L[j, k]), k ascending) and, as the TPU kernel does,
// multiplies by one rsqrt of the pivot per column where the twin divides by
// its square root (one more rounding, inside the 1e-5 the f32 path is held
// to; no IEEE division or square root on the chain). L goes back through the
// same shared-memory slot, strictly-upper triangle zero, and leaves as
// coalesced 16-byte stores. A non-positive pivot gives NaN, as in the twin.
// Bound: at the f32 path's sizes (M = 4..2070 blocks, at most 0.3 MB read
// and written) the traffic takes well under a microsecond at an H100 SXM's
// 3.35 TB/s (data sheet, 700 W), so a launch's latency sets the time: one
// round trip to memory, a barrier, six rsqrt and the column chain, the
// stores. Thread blocks of 32 threads spread M = 1024 over 32 SMs.
constexpr int kCholThreads = 32;

template <int D>
__global__ void __launch_bounds__(kCholThreads)
chol_kernel(const float* __restrict__ A, float* __restrict__ L, int M,
            long long sam) {
  constexpr int DD = D * D;
  constexpr int Q = DD / 4;
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
  float4* out = reinterpret_cast<float4*>(L + (size_t)m0 * DD);
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int q = tid + u * kCholThreads;
    if (q < n * Q) {
      const float* d = sA + (q / Q) * LS + 4 * (q % Q);
      out[q] = make_float4(d[0], d[1], d[2], d[3]);
    }
  }
}

// Replaces _tri_solve_kernel (pallas_blocks.py:79), and fuses what follows
// it in every caller on the f32 path: L Y = B by forward substitution and,
// with BACK, L^T X = Y by back substitution on the same registers, so that
// one launch solves L L^T X = B and B in, X out is all the traffic.
//
// Mapping: a thread owns V neighbouring rhs columns of one block m (V = 4,
// 2 or 1 floats: the widest vector that K, B's strides and the base
// addresses keep aligned), loads its D rows of B once, all loads in flight
// together, substitutes in registers in the plain version's order (row by
// row, k ascending forward and descending rows backward) and stores X once.
// The thread block is two-dimensional, (column vectors, blocks m), and the
// grid is (block ranges, column tiles): no thread divides by K. The
// blockDim.y blocks of L that a thread block touches are staged once into
// shared memory by stage_blocks, while the loads of B are in flight, each
// at a stride of D*D + 1 floats so that lanes on different blocks m read
// distinct banks; where a block of L has more 16-byte units than the
// thread block has columns (K = 1, K = 6), further layers of threads
// (blockDim.z) take a unit each and then leave. The reciprocals of the
// diagonals are taken once per staged L: a thread multiplies where the plain version divides (as the TPU
// kernel does; one more rounding, inside the 1e-5 the f32 path is held to).
// B is read through its three strides, so a transposed or stepped view
// costs no copy (then by scalar loads); X is contiguous.
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
// thread blocks of kPanelThreads that fill an H100's 132 SMs twice: the
// least work that is given the large block
constexpr long long kPanelWork = 2LL * 132 * kPanelThreads;

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

template <int D, int V, bool BACK>
__global__ void __launch_bounds__(kPanelThreads)
tri_solve_kernel(const float* __restrict__ L, const float* __restrict__ B,
                 float* __restrict__ X, int M, int K, long long sbm,
                 long long sbr, long long sbc) {
  constexpr int DD = D * D;
  constexpr int LS = DD + 1;  // padded stride of a staged L
  static_assert(DD % 4 == 0, "a 16-byte unit stays inside one block of L");
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

  // the thread's D rows of B, in flight while L is staged
  float rows[D][V];
  if (solves) {
    const float* b = B + m * sbm + (size_t)cv * V * sbc;
#pragma unroll
    for (int i = 0; i < D; ++i) load_vec<V>(b + i * sbr, rows[i]);
  }

  const int tid = (threadIdx.z * TY + ml) * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * TY * blockDim.z;
  const float* Lsrc = L + (size_t)m0 * DD;
  // one unit of L per thread: launch_tri_v gives the block at least
  // D * D / 4 threads for each of its TY blocks
  stage_blocks<D, 1>(Lsrc, DD, n, sL, tid, nthreads);
  for (int q = tid; q < n * D; q += nthreads)
    sR[q] = 1.0f / __ldg(Lsrc + (q / D) * DD + (q % D) * (D + 1));
  __syncthreads();
  if (!solves) return;

  const float* l = sL + ml * LS;
  const float* ri = sR + ml * D;
  float* x = X + m * D * K + (size_t)cv * V;
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
#pragma unroll
  for (int i = 0; i < D; ++i) store_vec<V>(x + (size_t)i * K, rows[i]);
}

template <int D, int V, bool BACK>
cudaError_t launch_tri_v(const float* L, const float* B, float* X, int M,
                         int K, long long sbm, long long sbr, long long sbc,
                         cudaStream_t st) {
  const int KV = K / V;
  const int target = (long long)M * KV >= kPanelWork ? kPanelThreads : kSmallThreads;
  const int TX = KV < target ? KV : target;
  // layers of threads, so that a thread stages at most one 16-byte unit
  // of L where the columns are few (K = 1: 9 layers, one of which solves)
  const int TZ = (D * D / 4 + TX - 1) / TX;
  int TY = target / (TX * TZ);
  TY = TY < 1 ? 1 : (TY < M ? TY : M);
  const long long tiles = (KV + TX - 1) / TX;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((M + TY - 1) / TY, (unsigned)tiles);
  const dim3 block(TX, TY, TZ);
  const size_t smem = (size_t)TY * (D * D + 1 + D) * sizeof(float);
  tri_solve_kernel<D, V, BACK><<<grid, block, smem, st>>>(L, B, X, M, K, sbm,
                                                          sbr, sbc);
  return cudaGetLastError();
}

inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// Picks the vector width: V floats per thread need unit-stride columns and
// every row of B and of X on a multiple of 4 V bytes.
template <int D, bool BACK>
cudaError_t launch_tri(const float* L, const float* B, float* X, long long M,
                       int K, long long sbm, long long sbr, long long sbc,
                       cudaStream_t st) {
  if (M > 0x7fffffff / (D * D) || !aligned_to(L, 16))
    return cudaErrorInvalidValue;
  auto fits = [&](int v) {
    return sbc == 1 && K % v == 0 && sbr % v == 0 && sbm % v == 0 &&
           aligned_to(B, 4 * v) && aligned_to(X, 4 * v);
  };
  if (fits(4))
    return launch_tri_v<D, 4, BACK>(L, B, X, (int)M, K, sbm, sbr, sbc, st);
  if (fits(2))
    return launch_tri_v<D, 2, BACK>(L, B, X, (int)M, K, sbm, sbr, sbc, st);
  return launch_tri_v<D, 1, BACK>(L, B, X, (int)M, K, sbm, sbr, sbc, st);
}

template <bool BACK>
int launch_tri_d(const float* L, const float* B, float* X, long long M, int D,
                 int K, long long sbm, long long sbr, long long sbc,
                 void* stream) {
  if (M == 0 || K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 2:
      return (int)launch_tri<2, BACK>(L, B, X, M, K, sbm, sbr, sbc, st);
    case 6:
      return (int)launch_tri<6, BACK>(L, B, X, M, K, sbm, sbr, sbc, st);
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

// A is read through its block stride sam (elements; a multiple of 4, each
// block contiguous, A 16-byte aligned); L is contiguous (M, D, D).
int block_chol(const float* A, float* L, long long M, int D, long long sam,
               void* stream) {
  if (M == 0) return 0;
  if (M > 0x7fffffff / (D * D) || sam % 4 || !aligned_to(A, 16) ||
      !aligned_to(L, 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = grid_for(M, kCholThreads);
  switch (D) {
    case 2:
      chol_kernel<2><<<grid, kCholThreads, 0, st>>>(A, L, (int)M, sam);
      break;
    case 6:
      chol_kernel<6><<<grid, kCholThreads, 0, st>>>(A, L, (int)M, sam);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B is read through its element strides (sbm between blocks, sbr between
// rows, sbc between columns); Y and X are contiguous (M, D, K).

// L Y = B
int block_tri_lower_solve(const float* L, const float* B, float* Y,
                          long long M, int D, int K, long long sbm,
                          long long sbr, long long sbc, void* stream) {
  return launch_tri_d<false>(L, B, Y, M, D, K, sbm, sbr, sbc, stream);
}

// L L^T X = B
int block_chol_solve(const float* L, const float* B, float* X, long long M,
                     int D, int K, long long sbm, long long sbr,
                     long long sbc, void* stream) {
  return launch_tri_d<true>(L, B, X, M, D, K, sbm, sbr, sbc, stream);
}

}  // extern "C"
