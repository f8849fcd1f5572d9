// K5: the general banded (DIA) SpMV y = A x of the general-matrix path, and
// K5 over a stack of k columns.
//
//   y[r] = sum_{k=0..K-1} bands[k*n + r] * x[r + off_k],
//   the term dropped where r + off_k lies outside [0, n).
//
// Replaces tpusparse/kernels/diaband.py::dia_mv_pallas (Pallas body
// _kernel), which the aij route runs for every f32 level apply: the rho
// power iterations and Galerkin probes of the setup, and the V-cycle's
// smoothing, residuals and transfers plus the inner CG apply of the solve.
// The batched form is KSP.mat_solve's apply of a DIA operator, which the
// JAX package runs as the vmapped XLA form of DIA.mv (tpusparse/ksp.py:
// 792-810).
//
// Bound on the H100: bytes.  One apply reads K bands, x and writes y:
// (K + 2) * n * 4 bytes (972 MB at 300^3 with K = 7, ~0.29 ms at
// 3.35 TB/s) against 2K flops per row; over k columns (K + 2k) * n * 4
// bytes.  Design: one thread per row, grid-stride, neighbouring threads on
// neighbouring rows, so each band read and the y write coalesce; the
// shifted x reads of neighbouring threads are contiguous too, and the +-1
// and +-nx ones hit L1/L2 (a 300^3 x-plane is 360 KB, so even the
// +-nx*ny reads are 1.4 MB apart in a 50 MB L2).  The band-major (K, n)
// layout is the container's own; the TPU's slab-major stack only arranged
// VMEM DMAs.  The batched kernel takes a thread's k columns CHUNK = 4 at a
// time, in a chunk loop that is not unrolled: each band value is read once
// into a register for the chunk's columns, whose sums stay in registers,
// so a band issues 4 x loads at once.  (Its first design, one column at a
// time around K5's row function with the bands found again in L1, took
// 1.34 ms at 300^3 with k = 4, 36% of the bound; this one 0.89 ms, 54%.)
// Shared-memory staging of x, vector loads and several rows per thread are
// later work.
//
// Accumulation is in f32 in ascending band order, each term one explicit
// __fmaf_rn, in both kernels: a column of the batched kernel is bit for
// bit a K5 launch on it, whatever nvcc would contract on its own.  x is
// never read out of range, whatever the band holds there.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_BANDS = 192;  // the DIA family's cap (DIA.host_bands)
constexpr long long MAX_BLOCKS = 132 * 8 * 4;  // SMs x resident blocks x 4 waves

// passed by value: 1.5 KB of the 4 KB kernel-parameter space
struct Offsets {
  long long v[MAX_BANDS];
};

__global__ void __launch_bounds__(BLOCK)
dia_mv_kernel(const float* __restrict__ bands, const float* __restrict__ x,
              float* __restrict__ y, long long n, int k, Offsets off) {
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long r = (long long)blockIdx.x * BLOCK + threadIdx.x; r < n;
       r += stride) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      const long long c = r + off.v[j];
      if (c >= 0 && c < n) acc = __fmaf_rn(bands[(long long)j * n + r], x[c], acc);
    }
    y[r] = acc;
  }
}

constexpr int CHUNK = 4;  // columns a thread accumulates in registers at once

__global__ void __launch_bounds__(BLOCK)
dia_mv_batched_kernel(const float* __restrict__ bands,
                      const float* __restrict__ x, float* __restrict__ y,
                      long long n, int k, Offsets off, int ncols) {
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long r = (long long)blockIdx.x * BLOCK + threadIdx.x; r < n;
       r += stride) {
#pragma unroll 1
    for (int c0 = 0; c0 < ncols; c0 += CHUNK) {
      const int m = ncols - c0;
      const float* xc = x + (long long)c0 * n;
      float acc[CHUNK];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) acc[i] = 0.0f;
      for (int j = 0; j < k; ++j) {
        const long long c = r + off.v[j];
        if (c >= 0 && c < n) {
          const float b = bands[(long long)j * n + r];
#pragma unroll
          for (int i = 0; i < CHUNK; ++i)
            if (i < m) acc[i] = __fmaf_rn(b, xc[(long long)i * n + c], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
        if (i < m) y[(long long)(c0 + i) * n + r] = acc[i];
    }
  }
}

int grid_blocks(long long n) {
  long long blocks = (n + BLOCK - 1) / BLOCK;
  return (int)(blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
}

bool load_offsets(Offsets& off, const long long* offsets, int k) {
  if (k < 1 || k > MAX_BANDS) return false;
  for (int j = 0; j < k; ++j) off.v[j] = offsets[j];
  return true;
}

}  // namespace

extern "C" int tps_dia_mv(const float* bands, const float* x, float* y,
                          long long n, int k, const long long* offsets,
                          void* stream) {
  Offsets off;
  if (!load_offsets(off, offsets, k)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  dia_mv_kernel<<<grid_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      bands, x, y, n, k, off);
  return (int)cudaGetLastError();
}

// K5 over the k = ncols columns of the (ncols, n) stack x.
extern "C" int tps_dia_mv_batched(const float* bands, const float* x,
                                  float* y, long long n, int k,
                                  const long long* offsets, int ncols,
                                  void* stream) {
  Offsets off;
  if (!load_offsets(off, offsets, k) || ncols < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || ncols == 0) return 0;
  dia_mv_batched_kernel<<<grid_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      bands, x, y, n, k, off, ncols);
  return (int)cudaGetLastError();
}
