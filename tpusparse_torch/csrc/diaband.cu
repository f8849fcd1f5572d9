// K5: the general banded (DIA) SpMV y = A x of the general-matrix path, K5
// over a stack of k columns, and K5h, K5 on one rank's rows with its windows.
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
// K5 and K5h are one kernel, dia_mv_window_kernel, on the contiguous rows
// [r0, r0 + nl) of an n-row matrix:
//
//   y[i] = sum_k bands[k*nl + i] * x(r0 + i + off_k),   i in [0, nl),
//
// where a global column c reads the rank's own x[c - r0], its low window
// xlo[c - (r0 - hl)] (the hl entries below r0 that the ranks below sent),
// or its high window xhi[c - (r0 + nl)] (the hh entries above), and is
// dropped outside [0, n).  K5 is the launch with r0 = 0, nl = n and no
// windows; K5h is one rank's (dist/general.py::DistDIA, the block-row
// executor; in the JAX package tpusparse/dist/general.py::DistDIA._mv_shard
// applies the same function per shard with XLA slices of a halo-extended
// vector).  The three segments are read in place: no extended copy of x is
// made.  Bound: ((K + 2) nl + hl + hh) * 4 bytes.  A row whose bands all
// land in the rank's own x (every row but the `below` first and the `above`
// last) runs a loop with no bounds test; an edge row tests each term and
// picks its segment (the warps that straddle an edge diverge).  (K5's first
// body tested every term on every row: 0.46 ms at 300^3, K = 7, against
// this kernel's 0.39.)
//
// Accumulation is in f32 in ascending band order, each term one explicit
// __fmaf_rn, in both kernels: a column of the batched kernel is bit for
// bit a K5 launch on it, and the rows that every rank's K5h writes are bit
// for bit one K5 launch on the whole vector, for any split, whatever nvcc
// would contract on its own.  x is never read out of range, whatever the
// band holds there.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_BANDS = 192;  // the DIA family's cap (DIA.host_bands)
constexpr long long MAX_BLOCKS = 132 * 8 * 4;  // SMs x resident blocks x 4 waves

// passed by value: 1.5 KB of the 4 KB kernel-parameter space
struct Offsets {
  long long v[MAX_BANDS];
};

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

__global__ void __launch_bounds__(BLOCK)
dia_mv_window_kernel(const float* __restrict__ bands,
                     const float* __restrict__ x,
                     const float* __restrict__ xlo,
                     const float* __restrict__ xhi, float* __restrict__ y,
                     long long nl, long long r0, long long n, long long hl,
                     long long below, long long above, int k, Offsets off) {
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < nl;
       i += stride) {
    float acc = 0.0f;
    if (i >= below && i + above < nl) {
      // every column in the rank's own x (all but the edge rows): no
      // bounds test, the same terms in the same order
      for (int j = 0; j < k; ++j)
        acc = __fmaf_rn(bands[(long long)j * nl + i], x[i + off.v[j]], acc);
    } else {
      for (int j = 0; j < k; ++j) {
        const long long c = r0 + i + off.v[j];
        if (c >= 0 && c < n) {
          const long long l = c - r0;  // the column in the rank's numbering
          const float v = l < 0 ? xlo[l + hl] : (l < nl ? x[l] : xhi[l - nl]);
          acc = __fmaf_rn(bands[(long long)j * nl + i], v, acc);
        }
      }
    }
    y[i] = acc;
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

int launch_window(const float* bands, const float* x, const float* xlo,
                  const float* xhi, float* y, long long nl, long long r0,
                  long long n, long long hl, int k, const Offsets& off,
                  cudaStream_t stream) {
  if (nl == 0) return 0;
  long long below = 0, above = 0;  // how far the bands reach below and above
  for (int j = 0; j < k; ++j) {
    if (-off.v[j] > below) below = -off.v[j];
    if (off.v[j] > above) above = off.v[j];
  }
  dia_mv_window_kernel<<<grid_blocks(nl), BLOCK, 0, stream>>>(
      bands, x, xlo, xhi, y, nl, r0, n, hl, below, above, k, off);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: the kernel on all n rows of x.
extern "C" int tps_dia_mv(const float* bands, const float* x, float* y,
                          long long n, int k, const long long* offsets,
                          void* stream) {
  Offsets off;
  if (!load_offsets(off, offsets, k) || n < 0)
    return (int)cudaErrorInvalidValue;
  // all n rows as one rank's: no column falls outside x, so the windows
  // are never read
  return launch_window(bands, x, x, x, y, n, 0, n, 0, k, off,
                       (cudaStream_t)stream);
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

// K5h on rows [r0, r0 + nl) of an n-row matrix: bands (k, nl), the rank's
// x (nl), its windows xlo (hl entries below r0) and xhi (hh above r0 + nl).
// The caller checks that the windows cover every column in [0, n) that a
// band reaches.
extern "C" int tps_dia_mv_window(const float* bands, const float* x,
                                 const float* xlo, const float* xhi, float* y,
                                 long long nl, long long r0, long long n,
                                 long long hl, long long hh, int k,
                                 const long long* offsets, void* stream) {
  Offsets off;
  if (!load_offsets(off, offsets, k) || nl < 0 || r0 < 0 || hl < 0 ||
      hh < 0 || hl > r0 || r0 + nl + hh > n)
    return (int)cudaErrorInvalidValue;
  return launch_window(bands, x, xlo, xhi, y, nl, r0, n, hl, k, off,
                       (cudaStream_t)stream);
}
