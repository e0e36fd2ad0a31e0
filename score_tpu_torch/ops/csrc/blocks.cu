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
// a thread takes the batch index instead, and the blocks keep the port's
// (M, D, D) layout.
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
// neighbouring units. A thread loads in groups of at most 12 units (48
// floats in registers at D = 12), each group all in flight before its
// first store. U must cover the units: n * Unit<D>::kPerBlock <=
// U * nthreads.
template <int D, int U>
__device__ __forceinline__ void stage_blocks(const float* __restrict__ src,
                                             long long sbm, int n, float* dst,
                                             int tid, int nthreads) {
  constexpr int W = Unit<D>::kFloats;
  constexpr int Q = Unit<D>::kPerBlock;
  constexpr int LS = D * D + 1;
  constexpr int G = U < 12 ? U : 12;
#pragma unroll
  for (int u0 = 0; u0 < U; u0 += G) {
    float v[G][W];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int q = tid + (u0 + g) * nthreads;
      if (u0 + g < U && q < n * Q) load_vec<W>(src + (q / Q) * sbm + W * (q % Q), v[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int q = tid + (u0 + g) * nthreads;
      if (u0 + g < U && q < n * Q) {
        float* d = dst + (q / Q) * LS + W * (q % Q);
#pragma unroll
        for (int w = 0; w < W; ++w) d[w] = v[g][w];
      }
    }
  }
}

// Replaces _chol_kernel (pallas_blocks.py:36). A thread owns one block: the
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
// as in the twin. At D = 12 a thread holds the 78 floats of its lower
// triangle in registers (the unrolled chain indexes them statically).
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
// distinct banks; where a block of L has more staging units (Unit<D>) than
// the thread block has columns (K = 1, K = 6; every K at D = 12), further
// layers of threads (blockDim.z) take a unit each and then leave. The
// reciprocals of the diagonals are taken once per staged L: a thread
// multiplies where the plain version divides (as the TPU kernel does; one
// more rounding, inside the 1e-5 the f32 path is held to).
// B is read through its three strides, so a transposed or stepped view
// costs no copy (then by scalar loads); X is contiguous.
//
// Bound: the arrow panel (K = 138..258) moves B in and X out (6.8 MB at
// Manhattan-4's first level, ~2 us at an H100 SXM's 3.35 TB/s, data sheet,
// 700 W): memory bounds it, and blocks of 256 threads keep enough 8-byte
// loads in flight. A level's couplings (K = 6) and a direction (K = 1) are
// 3072 and 1024 threads of work in all: latency bounds them (the launch,
// one round trip to memory for L and B together, 72 dependent multiply-
// adds), and blocks of 64 threads spread that work over more SMs. The 3D
// shapes (D = 12: M = 512 at K = 12, 18 and 1, 0.1-0.9 MB) are latency
// bound too; there the 36 units of a block of L take 36 / TX layers, so a
// thread block holds one block m (a simple first layout: 512 thread blocks
// of 36 threads, 1 to 9 of which solve).
constexpr int kPanelThreads = 256;
constexpr int kSmallThreads = 64;
// thread blocks of kPanelThreads that fill an H100's 132 SMs twice: the
// least work that is given the large block
constexpr long long kPanelWork = 2LL * 132 * kPanelThreads;

template <int D, int V, bool BACK>
__global__ void __launch_bounds__(kPanelThreads)
tri_solve_kernel(const float* __restrict__ L, const float* __restrict__ B,
                 float* __restrict__ X, int M, int K, long long sbm,
                 long long sbr, long long sbc) {
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
  // Unit<D>::kPerBlock threads for each of its TY blocks
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
  // layers of threads, so that a thread stages at most one unit of L
  // where the columns are few (K = 1: 9 layers at D = 6 and D = 3, 36 at
  // D = 12, one of which solves)
  const int TZ = (Unit<D>::kPerBlock + TX - 1) / TX;
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
  if (M > 0x7fffffff / (D * D) || (Unit<D>::kFloats == 4 && !aligned_to(L, 16)))
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
    case 3:
      return (int)launch_tri<3, BACK>(L, B, X, M, K, sbm, sbr, sbc, st);
    case 6:
      return (int)launch_tri<6, BACK>(L, B, X, M, K, sbm, sbr, sbc, st);
    case 12:
      return (int)launch_tri<12, BACK>(L, B, X, M, K, sbm, sbr, sbc, st);
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
      chol_kernel<12><<<grid, kCholThreads, 0, st>>>(A, L, (int)M, sam);
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
