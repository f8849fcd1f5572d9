// K5: the general banded (DIA) SpMV y = A x of the general-matrix path.
//
//   y[r] = sum_{k=0..K-1} bands[k*n + r] * x[r + off_k],
//   the term dropped where r + off_k lies outside [0, n).
//
// Replaces tpusparse/kernels/diaband.py::dia_mv_pallas (Pallas body
// _kernel), which the aij route runs for every f32 level apply: the rho
// power iterations and Galerkin probes of the setup, and the V-cycle's
// smoothing, residuals and transfers plus the inner CG apply of the solve.
//
// Bound on the H100: bytes.  One apply reads K bands, x and writes y:
// (K + 2) * n * 4 bytes (972 MB at 300^3 with K = 7, ~0.29 ms at
// 3.35 TB/s) against 2K flops per row.  Design: one thread per row,
// grid-stride, neighbouring threads on neighbouring rows, so each band
// read and the y write coalesce; the shifted x reads of neighbouring
// threads are contiguous too, and the +-1 and +-nx ones hit L1/L2 (a
// 300^3 x-plane is 360 KB, so even the +-nx*ny reads are 1.4 MB apart in
// a 50 MB L2).  The band-major (K, n) layout is the container's own; the
// TPU's slab-major stack only arranged VMEM DMAs.  Shared-memory staging
// of x, vector loads and several rows per thread are later work.
//
// Accumulation is in f32 in ascending band order, as DIA.mv's twin sums;
// nvcc may contract each multiply-add into an FMA.  x is never read out of
// range, whatever the band holds there.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_BANDS = 48;
constexpr long long MAX_BLOCKS = 132 * 8 * 4;  // SMs x resident blocks x 4 waves

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
      if (c >= 0 && c < n) acc += bands[(long long)j * n + r] * x[c];
    }
    y[r] = acc;
  }
}

}  // namespace

extern "C" int tps_dia_mv(const float* bands, const float* x, float* y,
                          long long n, int k, const long long* offsets,
                          void* stream) {
  if (k < 1 || k > MAX_BANDS) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Offsets off;
  for (int j = 0; j < k; ++j) off.v[j] = offsets[j];
  long long blocks = (n + BLOCK - 1) / BLOCK;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  dia_mv_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      bands, x, y, n, k, off);
  return (int)cudaGetLastError();
}
