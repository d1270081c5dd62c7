// K3: batched factor and inverse of 48x48 diagonal blocks, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel waveome_tpu/pallas_ops/chol_pallas.py
// (_diag_factor_impl, body _diag_factor_body): for every SPD block D of a
// (B, 48, 48) batch, the lower Cholesky factor L11 and its inverse L11^-1,
// both with zero upper triangles. linalg.cholesky_hybrid composes it with
// the panel solve P = A21 L11^-T and the trailing update as batched GEMMs.
//
// On the TPU the batch ran on the 128 vector lanes. Here each thread block
// owns one matrix, kept in shared memory (the block and its inverse, 2 x 9.4
// KB with rows padded to 49 floats so that column walks are free of bank
// conflicts):
//   1. load the lower triangle of D (the upper one is never read);
//   2. factor it column by column, unblocked and right-looking: thread i
//      owns row i, scales L[i][j] by 1/sqrt(pivot) and applies the rank-1
//      update to its own row of the trailing triangle; three barriers per
//      column;
//   3. invert L by forward substitution: thread c solves L x = e_c for
//      column c of L^-1, reading rows of L as broadcasts and writing only
//      its own column, so this phase needs no barrier;
//   4. write L and L^-1, zeros above the diagonal.
// Pivots are clamped at 1e-30 as in the Pallas body (chol_pallas.py:186,
// :202): a block that is not positive definite gives large finite values,
// never NaN from a negative square root.
//
// What bounds it on the H100: bytes. At 1024 blocks it reads the 4.8 MB of
// the lower triangles and writes 18.9 MB, about 7.1 us at 3.35 TB/s; its
// ~0.1 GFLOP is negligible.
// In practice a block's 96 barrier-separated steps of a few FMAs each
// dominate, so it is latency bound: enough blocks (one per matrix, 64
// threads, ~19 KB of shared memory, 11 resident per SM) overlap them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NB = 48;        // block size (the Pallas kernel's HBLK)
constexpr int LD = NB + 1;    // padded row stride in shared memory
constexpr int THREADS = 64;   // two warps; threads >= NB idle in phase 2-3

__global__ void __launch_bounds__(THREADS)
diag_factor_kernel(const float* __restrict__ D, float* __restrict__ L,
                   float* __restrict__ Linv) {
  __shared__ float S[NB * LD];
  __shared__ float X[NB * LD];
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * NB * NB;
  const float* d = D + base;

  // 1. lower triangle of D into S, zeros above
  for (int idx = tid; idx < NB * NB; idx += THREADS) {
    const int r = idx / NB, c = idx % NB;
    S[r * LD + c] = c <= r ? d[idx] : 0.0f;
  }
  __syncthreads();

  // 2. unblocked right-looking factor; thread i owns row i
  const int i = tid;
  for (int j = 0; j < NB; ++j) {
    const float rs = rsqrtf(fmaxf(S[j * LD + j], 1e-30f));
    float lij = 0.0f;
    if (i >= j && i < NB) lij = S[i * LD + j] * rs;
    __syncthreads();  // everyone has read the pivot and column j
    if (i >= j && i < NB) S[i * LD + j] = lij;
    __syncthreads();  // column j of L is final
    if (i > j && i < NB) {
      for (int k = j + 1; k <= i; ++k)
        S[i * LD + k] = fmaf(-lij, S[k * LD + j], S[i * LD + k]);
    }
    __syncthreads();  // trailing triangle updated
  }

  // 3. L^-1 by forward substitution, one column per thread
  const int c = tid;
  if (c < NB) {
    for (int r = 0; r < NB; ++r) {
      float acc = 0.0f;
      for (int k = c; k < r; ++k) acc = fmaf(S[r * LD + k], X[k * LD + c], acc);
      const float e = r == c ? 1.0f : 0.0f;
      X[r * LD + c] = r < c ? 0.0f : (e - acc) / fmaxf(S[r * LD + r], 1e-30f);
    }
  }
  __syncthreads();

  // 4. write both, zero upper triangles
  float* l = L + base;
  float* li = Linv + base;
  for (int idx = tid; idx < NB * NB; idx += THREADS) {
    const int r = idx / NB, cc = idx % NB;
    const bool low = cc <= r;
    l[idx] = low ? S[r * LD + cc] : 0.0f;
    li[idx] = low ? X[r * LD + cc] : 0.0f;
  }
}

}  // namespace

// The block size the kernel is built for; cuda_ops/diag_factor_cuda.py
// checks it.
extern "C" int waveome_diag_factor_nb() { return NB; }

extern "C" int waveome_diag_factor_forward(const float* d, float* l,
                                           float* linv, int B, void* stream) {
  cudaGetLastError();  // clear a stale, non-sticky error from elsewhere
  if (B <= 0) return 0;
  diag_factor_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(d, l, linv);
  return (int)cudaGetLastError();
}
