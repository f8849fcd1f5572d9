// The tentative grid transfers of the structured smoothed-aggregation
// hierarchy (amg/transfer.py::StructuredTransfer, sparse/padded.py::
// PaddedTransfer), one launch each way:
//
//   T^T (agg_restrict):  out[c] = tnorm[c] * sum of r over the fine cells of
//                        aggregate c
//   T   (agg_prolong):   out[p] = (e_c * tnorm)[agg(p)], zero on the pads
//
// Aggregates are fz x fy x fx boxes of the (nz, ny, nx) grid, ragged at the
// high end of each axis (a factor of 1 leaves an axis uncoarsened, under
// -pc_gamg_threshold).  The fine field lies in a layout of NZ x NY x NX
// cells a column, cell (k, j, i) of the grid at (z0 + k, j, i): the padded
// layout (kernels/stencil7.py::padded_shape: z0 = FACE = 3 zero planes on
// each z face, x rounded up to a multiple of 4) or the plain one (z0 = 0,
// no pads).  Leading stack axes (KSP.mat_solve's columns) are ncols fields,
// one after the other, over one tnorm.
//
// It replaces no Pallas kernel: the JAX package applies T as three
// contractions with 0/1 per-axis membership matrices, which XLA sends to the
// TPU's matrix unit (tpusparse/amg/transfer.py).  The same three einsums on
// this card run as full-f32 GEMMs on the CUDA cores (TF32 is off): at the
// 720^3 padded fine level about 260 GFLOP a direction against the ~27 adds
// a coarse cell needs, 11.5 ms of an inner iteration's 36 ms.
//
// Bound on the H100: bytes.  Each direction reads or writes the fine field
// once (1.5 GB at 720^3 in f32, 0.45 ms at 3.35 TB/s) and touches the
// coarse field (1/27 of it) twice.
//
// agg_restrict: one block a coarse row (jc, kc, column).  Its threads walk
// the aggregate's fz x fy fine rows along x in quads of 4 cells, 16-byte
// loads (8 for bf16, 32 for f64) coalesced along x with the streaming hint
// (read once); with fz, fy <= 3 every one of a quad's up to 9 loads is
// issued before its sums (f64: each row's 3).  Each fine x's sum over z,
// then over y, goes to shared memory; after one barrier each thread adds
// the fx cells of a coarse cell and scales by tnorm (read before the fine
// loads).  Rows longer than AGG_CHUNK fine cells take several rounds of
// that.  The pads are never read.
//
// agg_prolong: one warp a row (k, j) of a column of the fine layout, a quad of
// 4 cells a lane, written with one 16-byte store (8 bf16, 32 f64); pad rows
// and pad cells are written as zero.  The coarse values (1/27 of the
// bytes) are read one at a time through L1 and L2: 9 fine rows share a
// coarse row.
//
// Rounding: T has one term a cell, e_c * tnorm rounded once as PyTorch's
// multiply does, so it equals the einsum form bit for bit.  T^T adds in
// the einsums' order: the z members first, then the y members of those
// sums, then the x members, each in ascending index (every add rounded on
// its own: __fadd_rn / __dadd_rn, no FMA), and multiplies by tnorm last.
// bf16 sums in f32 and rounds to bf16 after each axis stage and after the
// scale, as the three bf16 einsums (f32 accumulation) and the multiply do.
// cuBLAS documents no order of its own sums, so T^T agrees with the card's
// einsum to rounding and with a twin in the order above bit for bit
// (kernels/transfer.py::agg_restrict_ordered).
//
// ALIGNED: NX is a multiple of 4 and the fine field's base is 16-byte
// aligned, so every quad is whole vector accesses; otherwise each cell is
// its own access (the plain layout's 27^3, 9^3 and 3^3 levels).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int AGG_BLOCK = 256;          // threads of a block at most
constexpr int AGG_WARPS = AGG_BLOCK / 32;  // agg_prolong: fine rows a block
constexpr int AGG_CHUNK = 1024;         // agg_restrict: fine cells of a round

// The fine layout and the grid in it, and the aggregation.
struct Layout {
  int NZ, NY, NX, z0;  // the layout of a column; grid cell (k, j, i) at (z0 + k, j, i)
  int nz, ny, nx;      // the grid
};
struct Agg {
  int fz, fy, fx;      // per-axis factors
  int ncz, ncy, ncx;   // the coarse grid: ceil(n / f) an axis
};

// The arithmetic of a field type on widened values S.
template <class T>
struct Num {  // float
  using S = float;
  __device__ static S add(S a, S b) { return __fadd_rn(a, b); }
  __device__ static S mul(S a, S b) { return __fmul_rn(a, b); }
  __device__ static S round(S v) { return v; }
  __device__ static T put(S v) { return v; }
};
template <>
struct Num<double> {
  using S = double;
  __device__ static S add(S a, S b) { return __dadd_rn(a, b); }
  __device__ static S mul(S a, S b) { return __dmul_rn(a, b); }
  __device__ static S round(S v) { return v; }
  __device__ static double put(S v) { return v; }
};
template <>
struct Num<__nv_bfloat16> {  // f32 arithmetic, rounded to bf16 where PyTorch's ops round
  using S = float;
  __device__ static S add(S a, S b) { return __fadd_rn(a, b); }
  __device__ static S round(S v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static S mul(S a, S b) { return round(__fmul_rn(a, b)); }
  __device__ static __nv_bfloat16 put(S v) { return __float2bfloat16_rn(v); }
};

// One value through the read-only cache, widened (bf16 -> f32 is exact).
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load1(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Four consecutive values at p, read once (ld.global.cs): whole vector
// loads when ALIGNED, else the first n one at a time and zeros after.
template <bool ALIGNED>
__device__ __forceinline__ void load4(const float* p, int n, float (&v)[4]) {
  if (ALIGNED) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) v[l] = l < n ? __ldcs(p + l) : 0.0f;
}
template <bool ALIGNED>
__device__ __forceinline__ void load4(const double* p, int n, double (&v)[4]) {
  if (ALIGNED) {
    const double2* q = reinterpret_cast<const double2*>(p);
    const double2 a = __ldcs(q), b = __ldcs(q + 1);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) v[l] = l < n ? __ldcs(p + l) : 0.0;
}
template <bool ALIGNED>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, float (&v)[4]) {
  if (ALIGNED) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) v[l] = l < n ? load1(p + l) : 0.0f;
}

// Store four values at p: whole vector stores when ALIGNED, else the
// first n one at a time.
template <bool ALIGNED>
__device__ __forceinline__ void store4(float* p, int n, const float (&v)[4]) {
  if (ALIGNED) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (l < n) p[l] = v[l];
}
template <bool ALIGNED>
__device__ __forceinline__ void store4(double* p, int n, const double (&v)[4]) {
  if (ALIGNED) {
    double2* q = reinterpret_cast<double2*>(p);
    q[0] = make_double2(v[0], v[1]);
    q[1] = make_double2(v[2], v[3]);
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (l < n) p[l] = v[l];
}
template <bool ALIGNED>
__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, const float (&v)[4]) {
  unsigned short b[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) b[l] = __bfloat16_as_ushort(__float2bfloat16_rn(v[l]));
  if (ALIGNED) {
    *reinterpret_cast<uint2*>(p) = make_uint2(b[0] | (unsigned)b[1] << 16, b[2] | (unsigned)b[3] << 16);
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (l < n) reinterpret_cast<unsigned short*>(p)[l] = b[l];
}

// acc = the sum over an aggregate's my rows (stride NX) of the sums over its
// mz planes (stride plane) of the quad at p, each stage rounded.  SMALL
// (mz, my <= 3): the loads of PRE rows' planes (all 9 in f32 and bf16, a
// row's 3 in f64, which spilled with 9) before their sums.
template <bool ALIGNED, bool SMALL, class T, class S>
__device__ __forceinline__ void column_sums(S (&acc)[4], const T* p, long long plane, int NX,
                                            int mz, int my, int n) {
  using N = Num<T>;
  if (SMALL) {
    constexpr int PRE = sizeof(S) == 8 ? 1 : 3;
#pragma unroll
    for (int y0 = 0; y0 < 3; y0 += PRE) {
      S v[PRE][3][4];
#pragma unroll
      for (int dy = 0; dy < PRE; ++dy)
#pragma unroll
        for (int z = 0; z < 3; ++z)
          if (y0 + dy < my && z < mz) load4<ALIGNED>(p + z * plane + (y0 + dy) * NX, n, v[dy][z]);
#pragma unroll
      for (int dy = 0; dy < PRE; ++dy) {
        const int y = y0 + dy;
        if (y < my) {
          S s[4];
#pragma unroll
          for (int l = 0; l < 4; ++l) s[l] = v[dy][0][l];
#pragma unroll
          for (int z = 1; z < 3; ++z)
            if (z < mz)
#pragma unroll
              for (int l = 0; l < 4; ++l) s[l] = N::add(s[l], v[dy][z][l]);
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[l] = y == 0 ? N::round(s[l]) : N::add(acc[l], N::round(s[l]));
        }
      }
    }
  } else {
#pragma unroll 1
    for (int y = 0; y < my; ++y) {
      S s[4], w[4];
      load4<ALIGNED>(p + y * NX, n, s);
#pragma unroll 1
      for (int z = 1; z < mz; ++z) {
        load4<ALIGNED>(p + z * plane + y * NX, n, w);
#pragma unroll
        for (int l = 0; l < 4; ++l) s[l] = N::add(s[l], w[l]);
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[l] = y == 0 ? N::round(s[l]) : N::add(acc[l], N::round(s[l]));
    }
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) acc[l] = N::round(acc[l]);
}

// T^T: one block a coarse row (jc, kc, column) = blockIdx, in rounds of cc
// coarse cells (cc fx fine cells, a multiple of 4 and at most AGG_CHUNK).
// A thread's first two tnorm values of a round are loaded before its fine
// loads, so no dependent read of device memory follows the barrier.
template <class T, bool ALIGNED, bool SMALL>
__global__ void __launch_bounds__(AGG_BLOCK)
agg_restrict_kernel(const T* __restrict__ r, const T* __restrict__ tnorm, T* __restrict__ out,
                    Layout L, Agg A, int cc) {
  using N = Num<T>;
  using S = typename N::S;
  __shared__ __align__(16) S fine[AGG_CHUNK];  // a round's sums over z and y, a fine x each
  const int jc = (int)blockIdx.x, kc = (int)blockIdx.y, col = (int)blockIdx.z;
  const int k0 = A.fz * kc, j0 = A.fy * jc;
  const int mz = min(A.fz, L.nz - k0), my = min(A.fy, L.ny - j0);
  const long long plane = (long long)L.NY * L.NX;
  const T* src = r + ((long long)col * L.NZ + L.z0 + k0) * plane + (long long)j0 * L.NX;
  const long long crow = ((long long)kc * A.ncy + jc) * A.ncx;
  T* dst = out + (long long)col * A.ncz * A.ncy * A.ncx + crow;
  const T* tn = tnorm + crow;
  const int t = (int)threadIdx.x, nt = (int)blockDim.x;
  for (int c0 = 0; c0 < A.ncx; c0 += cc) {
    const int x0 = c0 * A.fx, xn = min(cc * A.fx, L.nx - x0), cn = min(cc, A.ncx - c0);
    const S t0 = t < cn ? load1(tn + c0 + t) : S(0), t1 = t + nt < cn ? load1(tn + c0 + t + nt) : S(0);
    for (int q = 4 * t; q < xn; q += 4 * nt) {
      S acc[4];
      column_sums<ALIGNED, SMALL>(acc, src + x0 + q, plane, L.NX, mz, my, xn - q);
#pragma unroll
      for (int l = 0; l < 4; ++l) fine[q + l] = acc[l];
    }
    __syncthreads();
    auto emit = [&](int c, S scale) {  // coarse cell c0 + c of the round
      const int f0 = c * A.fx, mx = min(A.fx, xn - f0);
      S s = fine[f0];
      for (int m = 1; m < mx; ++m) s = N::add(s, fine[f0 + m]);
      dst[c0 + c] = N::put(N::mul(N::round(s), scale));
    };
    if (t < cn) emit(t, t0);
    if (t + nt < cn) emit(t + nt, t1);
    for (int c = t + 2 * nt; c < cn; c += nt) emit(c, load1(tn + c0 + c));
    __syncthreads();
  }
}

// T: one warp a row (k, j) of the fine layout, blockIdx.y the column, a
// quad a lane.  A coarse value is read and scaled once a quad, and again
// only where the quad crosses into the next aggregate.
template <class T, bool ALIGNED>
__global__ void __launch_bounds__(AGG_BLOCK)
agg_prolong_kernel(const T* __restrict__ ec, const T* __restrict__ tnorm, T* __restrict__ out,
                   Layout L, Agg A) {
  using N = Num<T>;
  using S = typename N::S;
  const int row = (int)blockIdx.x * AGG_WARPS + (int)threadIdx.x / 32, col = (int)blockIdx.y;
  if (row >= L.NZ * L.NY) return;
  const int lane = (int)threadIdx.x % 32;
  const int j = row % L.NY, k = row / L.NY - L.z0;
  const bool live = k >= 0 && k < L.nz && j < L.ny;
  const long long crow = live ? ((long long)(k / A.fz) * A.ncy + j / A.fy) * A.ncx : 0;
  const T* e = ec + (long long)col * A.ncz * A.ncy * A.ncx + crow;
  const T* tn = tnorm + crow;
  const int nx = live ? L.nx : 0;  // the row's cells that take a value; the rest are zero
  T* dst = out + ((long long)col * L.NZ * L.NY + row) * L.NX;
  for (int i0 = 4 * lane; i0 < L.NX; i0 += 128) {
    S v[4];
    int c = i0 / A.fx, m = i0 - c * A.fx;
    S val = i0 < nx ? N::mul(load1(e + c), load1(tn + c)) : S(0);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      v[l] = i0 + l < nx ? val : S(0);
      if (++m == A.fx) {
        m = 0, ++c;
        if (l < 3 && i0 + l + 1 < nx) val = N::mul(load1(e + c), load1(tn + c));
      }
    }
    store4<ALIGNED>(dst + i0, L.NX - i0, v);
  }
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The layout and aggregation of a call, or false when they are not a
// grid inside its layout with factors in [1, AGG_CHUNK / 4].
bool plan(int NZ, int NY, int NX, int z0, int nz, int ny, int nx, int fz, int fy, int fx, int ncols,
          Layout& L, Agg& A) {
  const bool ok = nz > 0 && ny > 0 && nx > 0 && z0 >= 0 && z0 + nz <= NZ && ny <= NY && nx <= NX &&
                  fz >= 1 && fy >= 1 && fx >= 1 && fz <= AGG_CHUNK / 4 && fy <= AGG_CHUNK / 4 &&
                  fx <= AGG_CHUNK / 4 && ncols > 0;
  if (!ok) return false;
  L = Layout{NZ, NY, NX, z0, nz, ny, nx};
  A = Agg{fz, fy, fx, cdiv(nz, fz), cdiv(ny, fy), cdiv(nx, fx)};
  return true;
}

template <class T>
int restrict_launch(const void* r, const void* tnorm, void* out, const Layout& L, const Agg& A, int ncols,
                    cudaStream_t stream) {
  if (A.ncz > 65535 || ncols > 65535) return (int)cudaErrorInvalidValue;
  // a round: cc coarse cells, cc fx fine cells (a multiple of 4); a
  // thread a quad of its fine cells, whole warps
  const int cc = 4 * (AGG_CHUNK / (4 * A.fx));
  const int quads = cdiv(std::min(cc * A.fx, L.nx), 4);
  const int threads = std::min(AGG_BLOCK, 32 * cdiv(quads, 32));
  const bool aligned = L.NX % 4 == 0 && aligned16(r);
  const bool small = A.fz <= 3 && A.fy <= 3;
  const T* u = static_cast<const T*>(r);
  const T* tn = static_cast<const T*>(tnorm);
  T* v = static_cast<T*>(out);
  const dim3 grid(A.ncy, A.ncz, ncols);
  if (aligned && small)
    agg_restrict_kernel<T, true, true><<<grid, threads, 0, stream>>>(u, tn, v, L, A, cc);
  else if (aligned)
    agg_restrict_kernel<T, true, false><<<grid, threads, 0, stream>>>(u, tn, v, L, A, cc);
  else if (small)
    agg_restrict_kernel<T, false, true><<<grid, threads, 0, stream>>>(u, tn, v, L, A, cc);
  else
    agg_restrict_kernel<T, false, false><<<grid, threads, 0, stream>>>(u, tn, v, L, A, cc);
  return (int)cudaGetLastError();
}

template <class T>
int prolong_launch(const void* ec, const void* tnorm, void* out, const Layout& L, const Agg& A, int ncols,
                   cudaStream_t stream) {
  const long long rows = (long long)L.NZ * L.NY;  // a column's
  if (rows >= (1LL << 31) - AGG_WARPS || ncols > 65535) return (int)cudaErrorInvalidValue;
  const T* e = static_cast<const T*>(ec);
  const T* tn = static_cast<const T*>(tnorm);
  T* v = static_cast<T*>(out);
  const dim3 grid((unsigned)((rows + AGG_WARPS - 1) / AGG_WARPS), ncols);
  if (L.NX % 4 == 0 && aligned16(out))
    agg_prolong_kernel<T, true><<<grid, AGG_BLOCK, 0, stream>>>(e, tn, v, L, A);
  else
    agg_prolong_kernel<T, false><<<grid, AGG_BLOCK, 0, stream>>>(e, tn, v, L, A);
  return (int)cudaGetLastError();
}

}  // namespace

// out (ncols, ncz, ncy, ncx) = T^T r for each of the ncols fields of r
// (ncols, NZ, NY, NX), the (nz, ny, nx) grid at (z0, 0, 0) of each, over
// the (ncz, ncy, ncx) tnorm; all contiguous, of one type.  dtype: 0 f32,
// 1 f64, 2 bf16.  A grid that leaves its layout, a factor outside [1,
// 256], or more than 65535 coarse planes or columns is refused.
extern "C" int tps_agg_restrict(const void* r, const void* tnorm, void* out, int NZ, int NY, int NX, int z0,
                                int nz, int ny, int nx, int fz, int fy, int fx, int ncols, int dtype,
                                void* stream) {
  Layout L;
  Agg A;
  if (!plan(NZ, NY, NX, z0, nz, ny, nx, fz, fy, fx, ncols, L, A)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return restrict_launch<float>(r, tnorm, out, L, A, ncols, s);
    case 1: return restrict_launch<double>(r, tnorm, out, L, A, ncols, s);
    case 2: return restrict_launch<__nv_bfloat16>(r, tnorm, out, L, A, ncols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out (ncols, NZ, NY, NX) = T e_c for each of the ncols coarse fields of
// e_c (ncols, ncz, ncy, ncx): grid cell (k, j, i) at (z0 + k, j, i) of a
// column, every other cell of the layout zero.  Arguments as for
// tps_agg_restrict.
extern "C" int tps_agg_prolong(const void* ec, const void* tnorm, void* out, int NZ, int NY, int NX, int z0,
                               int nz, int ny, int nx, int fz, int fy, int fx, int ncols, int dtype,
                               void* stream) {
  Layout L;
  Agg A;
  if (!plan(NZ, NY, NX, z0, nz, ny, nx, fz, fy, fx, ncols, L, A)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return prolong_launch<float>(ec, tnorm, out, L, A, ncols, s);
    case 1: return prolong_launch<double>(ec, tnorm, out, L, A, ncols, s);
    case 2: return prolong_launch<__nv_bfloat16>(ec, tnorm, out, L, A, ncols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
