// K3: batched factor and inverse of 48x48 diagonal blocks, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel waveome_tpu/pallas_ops/chol_pallas.py
// (_diag_factor_impl, body _diag_factor_body): for every SPD block D of a
// batch of 48x48 float32 blocks, the lower Cholesky factor L11 and its
// inverse L11^-1, both with zero upper triangles. linalg.cholesky_hybrid
// composes it with the panel solve P = A21 L11^-T and the trailing update
// as batched GEMMs, reading each diagonal block of its work matrix and
// writing L11 into its factor in place (the strided entry below).
//
// On the TPU the batch ran on the 128 vector lanes. Here one warp owns one
// matrix, and a block holds WPB independent warps: no block-wide barrier.
//   1. load: lane l reads the lower triangle of row l + 16, and lanes
//      l < 16 also of row l, straight into registers (16-byte loads where
//      the addresses allow; 48 floats a row, statically indexed: every
//      loop over the 48 columns is unrolled in full). Rows 0..15 are the
//      second set because they are short: their trailing updates stop at
//      column 15;
//   2. factor, right-looking, column j at a time: the rows' entries j are
//      scaled by the rsqrt of the clamped pivot. The lane of row j + 1
//      sends L[j+1][j] and the next pivot (its entry j + 1 less L[j+1][j]^2)
//      by shuffles, so the chain of pivots never waits on shared memory;
//      the scaled column j goes to the warp's copy of L in shared memory,
//      column-major, and after a __syncwarp every lane reads it back as
//      16-byte broadcasts and updates its rows' trailing entries in
//      registers. Then each lane takes the reciprocals 1/max(L[r][r],
//      1e-30) of rows r = l and l + 32 (a division inside the unrolled loop
//      would split it at each column's slow-path branch);
//   3. L, zero above the diagonal, goes from the registers through a
//      row-major staging buffer to device memory, whole rows at a time;
//   4. inverse: lane c owns column c of L^-1, and lanes c < 16 also column
//      c + 32 (of which only rows 32..47 are not zero), in registers, and
//      solves L x = e_c column-oriented: x[k] *= 1/L[k][k], then x[m] -=
//      L[m][k] x[k] for m > k, with L's column k as broadcasts from the
//      warp's copy. The 47 - k updates of a step are independent, so no
//      sum is one long chain;
//   5. L^-1 goes out a row per store: lanes hold consecutive columns, so a
//      store is one 128-byte line (measured a little faster than staging).
// Pivots are clamped at 1e-30 and the inverse multiplies by the reciprocal
// of max(L[k][k], 1e-30), as the Pallas body (chol_pallas.py:186, :202): a
// block that is not positive definite gives large finite values, never NaN
// from a negative square root. Entries above the diagonal are set by
// selects, never by products, so they are exactly zero.
//
// What bounds it on the H100: bytes, by the count. At 1024 blocks it reads
// the 4.8 MB of the lower triangles and writes 18.9 MB, about 7.1 us at
// 3.35 TB/s; its ~0.11 GFLOP is ~1.7 us at the float32 rate. In practice a
// warp's single stream of mostly dependent steps bounds it: 1024 matrices
// are ~8 warps an SM, two a scheduler, which hide only part of each
// column's latency (clock counts by phase in PERF.md).
//
// Interface: pointers with a row stride and a batch stride (in floats) for
// D, L and L^-1; the last dimension has stride 1. The contiguous entry is
// the case 48, 48 * 48.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NB = 48;                   // block size (the Pallas HBLK)
constexpr int LDS = 52;                  // row stride of shared buffers
constexpr int WPB = 4;                   // warps (matrices) per block
constexpr int GROUPS = NB / 4;           // 16-byte groups per row
constexpr int BUF = NB * LDS;            // floats of one buffer
constexpr int WARP_SMEM = 2 * BUF + NB;  // L, staging, reciprocals
constexpr size_t SMEM = sizeof(float) * WPB * WARP_SMEM;
constexpr unsigned FULL = 0xffffffffu;

// A 16-byte group of row r of a strided matrix (VEC: one access).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p) {
  if (VEC) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, float4 v) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
  }
}

// The warp's staging buffer (row-major, stride LDS) to a 48x48 matrix in
// device memory, whole rows: lane t of a pass writes one 16-byte group.
template <bool VEC>
__device__ __forceinline__ void write_out(const float* s, float* g,
                                          long long ld, int lane) {
#pragma unroll
  for (int t = 0; t < NB * GROUPS / 32; ++t) {
    const int idx = lane + 32 * t, r = idx / GROUPS, q = idx % GROUPS;
    store4<VEC>(g + r * ld + 4 * q,
                *reinterpret_cast<const float4*>(s + r * LDS + 4 * q));
  }
}

// 1/sqrt(x) from the special function unit, as rsqrtf, without its
// handling of subnormal inputs: the clamped pivots are >= 1e-30, normal.
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <bool VEC>
__global__ void __launch_bounds__(WPB * 32)
diag_factor_kernel(const float* __restrict__ D, long long d_ld,
                   long long d_bs, float* __restrict__ L, long long l_ld,
                   long long l_bs, float* __restrict__ Linv, long long i_ld,
                   long long i_bs, int B) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = (long long)blockIdx.x * WPB + warp;
  if (m >= B) return;
  float* const lc = reinterpret_cast<float*>(smem4) + warp * WARP_SMEM;
  float* const st = lc + BUF;      // row-major staging of L
  float* const rinv = st + BUF;    // 1 / max(L[k][k], 1e-30)
  const bool two = lane < 16;  // a second row (lane), a second column

  // 1. each lane loads the lower triangle of its rows straight into
  // registers: row lane + 16, and for lanes < 16 also row lane; entries
  // above the diagonal become zeros by selects
  float ah[NB], al[NB];  // rows lane + 16 and lane
  {
    const float* dh = D + m * d_bs + (lane + 16) * d_ld;
    const float* dl = D + m * d_bs + lane * d_ld;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) {
      const float4 v = 4 * q <= lane + 16 ? load4<VEC>(dh + 4 * q) : z;
      const float4 w = two && 4 * q <= lane ? load4<VEC>(dl + 4 * q) : z;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ah[4 * q + c] = 4 * q + c <= lane + 16 ? comp(v, c) : 0.f;
        al[4 * q + c] = 4 * q + c <= lane ? comp(w, c) : 0.f;
      }
    }
  }

  // 2. right-looking factor; lc[j * LDS + k] = L[k][j]. Row n is al of
  // lane n (n < 16) or ah of lane n - 16
  float pv = __shfl_sync(FULL, al[0], 0);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float rs = rsqrt_approx(fmaxf(pv, 1e-30f));
    const float lh = lane + 16 >= j ? ah[j] * rs : 0.f;
    const float ll = lane >= j ? al[j] * rs : 0.f;
    ah[j] = lh;
    al[j] = ll;
    if (j + 1 < NB) {
      // L[n][j] and the next pivot come by shuffles from the lane of row
      // n = j + 1, so the chain of pivots never waits on shared memory
      const int n = j + 1, src = n < 16 ? n : n - 16;
      const float ln = n < 16 ? ll : lh;
      const float an = n < 16 ? al[n] : ah[n];
      const float lnj = __shfl_sync(FULL, ln, src);
      pv = __shfl_sync(FULL, fmaf(-ln, ln, an), src);
      ah[n] = fmaf(-lh, lnj, ah[n]);
      if (n < 16) al[n] = fmaf(-ll, lnj, al[n]);
    }
    float* col = lc + j * LDS;
    col[lane + 16] = lh;
    if (two) col[lane] = ll;
    __syncwarp();
#pragma unroll
    for (int q = (j + 2) / 4; q < GROUPS; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(col + 4 * q);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 4 * q + c;
        if (k <= j + 1) continue;
        const float lk = comp(v, c);
        ah[k] = fmaf(-lh, lk, ah[k]);
        if (k < 16) al[k] = fmaf(-ll, lk, al[k]);
      }
    }
  }

  // the reciprocals of the pivots, rows lane and lane + 32
  rinv[lane] = 1.0f / fmaxf(lc[lane * LDS + lane], 1e-30f);
  if (two) rinv[lane + 32] = 1.0f / fmaxf(lc[(lane + 32) * (LDS + 1)], 1e-30f);

  // 3. L out through the staging buffer (the registers hold zeros above
  // the diagonal: each column's select wrote them)
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) {
    *reinterpret_cast<float4*>(st + (lane + 16) * LDS + 4 * q) =
        make_float4(ah[4 * q], ah[4 * q + 1], ah[4 * q + 2], ah[4 * q + 3]);
    if (two)
      *reinterpret_cast<float4*>(st + lane * LDS + 4 * q) =
          make_float4(al[4 * q], al[4 * q + 1], al[4 * q + 2], al[4 * q + 3]);
  }
  __syncwarp();
  write_out<VEC>(st, L + m * l_bs, l_ld, lane);

  // 4. L^-1, column-oriented forward substitution: x0 = column lane, x1 =
  // rows 32..47 of column lane + 32 (its rows above 32 are zero)
  float x0[NB], x1[NB - 32];
#pragma unroll
  for (int k = 0; k < NB; ++k) x0[k] = k == lane ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < NB - 32; ++k) x1[k] = k == lane ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float r = rinv[k];
    x0[k] *= r;
    if (k >= 32) x1[k - 32] *= r;
    const float* col = lc + k * LDS;
#pragma unroll
    for (int q = (k + 1) / 4; q < GROUPS; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(col + 4 * q);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * q + c;
        if (i <= k) continue;
        const float li = comp(v, c);
        x0[i] = fmaf(-li, x0[k], x0[i]);
        if (k >= 32) x1[i - 32] = fmaf(-li, x1[k - 32], x1[i - 32]);
      }
    }
  }

  // 5. L^-1 out, a row per store (lanes on consecutive columns, so each
  // store is one 128-byte line), zero above the diagonal by selects, so a
  // non-finite value of a block that is not positive definite cannot leak
  // there
  float* li = Linv + m * i_bs;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    li[k * i_ld + lane] = k >= lane ? x0[k] : 0.f;
    if (two)
      li[k * i_ld + lane + 32] = k >= 32 && k - 32 >= lane ? x1[k - 32] : 0.f;
  }
}

template <bool VEC>
int launch(const float* d, long long d_ld, long long d_bs, float* l,
           long long l_ld, long long l_bs, float* linv, long long i_ld,
           long long i_bs, int B, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      diag_factor_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  diag_factor_kernel<VEC><<<(B + WPB - 1) / WPB, WPB * 32, SMEM, stream>>>(
      d, d_ld, d_bs, l, l_ld, l_bs, linv, i_ld, i_bs, B);
  return (int)cudaGetLastError();
}

}  // namespace

// The block size the kernel is built for; cuda_ops/diag_factor_cuda.py
// checks it.
extern "C" int waveome_diag_factor_nb() { return NB; }

// D, L and L^-1 as (B, 48, 48) views with unit column stride: row stride
// and batch stride of each, in floats. 16-byte accesses when every pointer
// is 16-byte aligned and every stride a multiple of 4, scalar ones else.
extern "C" int waveome_diag_factor_strided(
    const float* d, long long d_ld, long long d_bs, float* l, long long l_ld,
    long long l_bs, float* linv, long long i_ld, long long i_bs, int B,
    void* stream) {
  cudaGetLastError();  // clear a stale, non-sticky error from elsewhere
  if (B <= 0) return 0;
  if (d_ld < NB || l_ld < NB || i_ld < NB) return (int)cudaErrorInvalidValue;
  const bool vec =
      ((uintptr_t)d | (uintptr_t)l | (uintptr_t)linv) % 16 == 0 &&
      ((d_ld | d_bs | l_ld | l_bs | i_ld | i_bs) & 3) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<true>(d, d_ld, d_bs, l, l_ld, l_bs, linv, i_ld, i_bs,
                            B, s)
             : launch<false>(d, d_ld, d_bs, l, l_ld, l_bs, linv, i_ld, i_bs,
                             B, s);
}

// Contiguous (B, 48, 48) batches.
extern "C" int waveome_diag_factor_forward(const float* d, float* l,
                                           float* linv, int B, void* stream) {
  return waveome_diag_factor_strided(d, NB, NB * NB, l, NB, NB * NB, linv, NB,
                                     NB * NB, B, stream);
}
