// The variable-coefficient 27-point apply of the coarse levels:
// y[p] = sum_o coef[o][p] * x[p + o] over the 27 offsets o in {-1, 0, 1}^3,
// with zero fill where p + o leaves the grid (sparse/varstencil.py::
// VarStencil27.mv), over one (nz, ny, nx) field or each column of a stack.
//
// It replaces no Pallas kernel: the JAX package leaves the apply to one XLA
// fusion (tpusparse/sparse/varstencil.py:76).  In PyTorch the same sum is
// a pad, the centre product and, for each of the 26 other offsets, a
// strided multiply and an add: about 54 kernels an apply, each a pass over
// the field, and some 80 host dispatches.  A GAMG level >= 1 applies its
// operator 6 times a cycle, so those launches and passes were most of a
// V-cycle's time on the stencil route.
//
// Bound on the H100: bytes.  One pass reads the 27 coefficient planes, x
// and y's write: 62 bytes a cell with bf16 coefficients and f32 fields
// (cast_coarse_coefs), 116 in f32, 232 in f64; 0.256 ms at 240^3 in bf16
// at 3.35 TB/s, against 54 flops a cell.  The coefficients are 87% of the
// bytes and each is read once, so the design streams them with as many
// loads in flight as it can.  A block of 256 threads owns a tile of VS_TY
// = 16 rows by VS_TX = 64 columns of one plane k, a quad of 4 x cells a
// thread (kernels/varstencil27.py::varstencil27_tiles: one block a tile of
// each plane of each column, 14,400 at 240^3).  It stages planes k - 1, k
// and k + 1 of x over the tile and a one-cell rim (zeros past the grid's
// faces) in shared memory, as f32 (f64 for f64 fields), meets one
// barrier, and reads the coefficient quads of its cells straight from
// device memory, coalesced along x, 8 (bf16), 16 (f32) or 32 (f64) bytes a
// quad, with the streaming hint (read once), a plane's 9 before their
// sums; its 4 sums stay in registers and y is written once.  x is read
// about three times, mostly from L2 (a plane is 230 KB at 240^3).  A
// z-march on K1h's design (stencil7.cu: a ring of planes, each x value
// read once, chunks of planes a block) was the first design: with the
// chunks of a one-wave plan (60 planes at 240^3) it reached 64-67% of the
// bound, and it ran faster the shorter its chunks, up to one plane a
// block at 3 blocks an SM (84%): each block's steps wait on one barrier
// and one round of loads, and only many short-lived blocks keep the
// device's loads in flight between them (PERF.md section 6).
//
// Rounding: every cell sums in OFFSETS order as the PyTorch form does, the
// centre product first and then each other offset, with every product and
// sum rounded on its own (__fmul_rn / __fadd_rn, __dmul_rn / __dadd_rn: no
// contraction into an FMA), so that the output equals the PyTorch form bit
// for bit.  The (coefficient, field) pairs: (bf16, f32) widens each
// coefficient exactly and multiplies in f32, as PyTorch's bf16 x f32
// promotion does; (f32, f32); (f64, f64); (bf16, bf16), the bf16 V-cycle
// (cast_hierarchy), rounds each product and each sum to bf16 as PyTorch's
// bf16 multiply and add do (f32 arithmetic, one round to nearest even).
// The products at p + o outside the grid are computed with the zero fill,
// as there, so a coefficient stored there behaves as it does in PyTorch.
//
// ALIGNED: nx is a multiple of 4 and the three bases are 16-byte aligned,
// so every quad is one or two vector loads; otherwise each cell is loaded
// on its own (the 27^3, 9^3 and 3^3 levels).
#include <cuda_bf16.h>

#include "star7.cuh"

namespace {

using tps::BLOCK;

constexpr int VS_QX = 16;                  // quads a tile row
constexpr int VS_TX = 4 * VS_QX;           // 64 tile columns
constexpr int VS_TY = BLOCK / VS_QX;       // 16 tile rows, a quad a thread
// a staged row: its left cell at 3, the tile's cells at [4, 68), its right
// cell at 68 (the tile's quads on 16 bytes)
constexpr int VS_ROW = VS_TX + 8;
constexpr int VS_PLANE = (VS_TY + 2) * VS_ROW;
constexpr int VS_CENTRE = 13;  // the offset (0, 0, 0)
// The blocks an SM must hold (__launch_bounds__): 3 with bf16
// coefficients (at most 85 registers a thread), 2 with f32 (at 3 the
// one-cell form spilled), 1 with f64.
template <class C>
constexpr int VS_MIN_BLOCKS = sizeof(C) == 2 ? 3 : sizeof(C) == 4 ? 2 : 1;

// Four consecutive values of a row as loaded: bf16 as two 32-bit words
// (the lower address in the low half), f32 and f64 as themselves.
template <class T>
struct Raw {
  T v[4];
};
template <>
struct Raw<__nv_bfloat16> {
  unsigned w[2];
};

template <class T>
struct Widen {
  using S = T;
  __device__ static T get(const Raw<T>& q, int l) { return q.v[l]; }
  __device__ static T one(const T* p) { return __ldg(p); }
};
template <>
struct Widen<__nv_bfloat16> {
  using S = float;
  // bf16 -> f32 is exact: the bits in the upper half
  __device__ static float get(const Raw<__nv_bfloat16>& q, int l) {
    const unsigned w = q.w[l >> 1];
    return __uint_as_float(l & 1 ? w & 0xffff0000u : w << 16);
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
};

// One quad of 4 values at p (16-byte aligned for f32 and f64, 8 for bf16);
// STREAM: read once (ld.global.cs), else through the read-only cache.
template <bool STREAM>
__device__ __forceinline__ Raw<float> vec_load(const float* p) {
  const float4 f = STREAM ? __ldcs(reinterpret_cast<const float4*>(p))
                          : __ldg(reinterpret_cast<const float4*>(p));
  return Raw<float>{{f.x, f.y, f.z, f.w}};
}
template <bool STREAM>
__device__ __forceinline__ Raw<double> vec_load(const double* p) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 a = STREAM ? __ldcs(q) : __ldg(q), b = STREAM ? __ldcs(q + 1) : __ldg(q + 1);
  return Raw<double>{{a.x, a.y, b.x, b.y}};
}
template <bool STREAM>
__device__ __forceinline__ Raw<__nv_bfloat16> vec_load(const __nv_bfloat16* p) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
  const uint2 u = STREAM ? __ldcs(q) : __ldg(q);
  return Raw<__nv_bfloat16>{{u.x, u.y}};
}

// The quad of `row` at cells [i0, i0 + 4), zeros past nx or without a row.
// ALIGNED: nx is a multiple of 4, so a quad lies wholly inside or outside.
template <bool ALIGNED, bool STREAM, class T>
__device__ __forceinline__ Raw<T> load_quad(const T* row, int i0, int nx) {
  Raw<T> q{};
  if (!row || i0 >= nx) return q;
  if (ALIGNED) return vec_load<STREAM>(row + i0);
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (i0 + l < nx)
        q.w[l >> 1] |= (unsigned)__ldg(reinterpret_cast<const unsigned short*>(row + i0 + l)) << (16 * (l & 1));
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (i0 + l < nx) q.v[l] = __ldg(row + i0 + l);
  }
  return q;
}

// The arithmetic of one (coefficient, field) pair on widened values S.
template <class C, class X>
struct Arith {  // f32 fields, bf16 or f32 coefficients
  using S = float;
  __device__ static S mul(S c, S x) { return __fmul_rn(c, x); }
  __device__ static S add(S a, S b) { return __fadd_rn(a, b); }
};
template <>
struct Arith<double, double> {
  using S = double;
  __device__ static S mul(S c, S x) { return __dmul_rn(c, x); }
  __device__ static S add(S a, S b) { return __dadd_rn(a, b); }
};
template <>
struct Arith<__nv_bfloat16, __nv_bfloat16> {  // each result rounded to bf16
  using S = float;
  __device__ static float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static S mul(S c, S x) { return bf(__fmul_rn(c, x)); }
  __device__ static S add(S a, S b) { return bf(__fadd_rn(a, b)); }
};

// Store the quad's cells below nx (all four when ALIGNED).
template <bool ALIGNED>
__device__ __forceinline__ void store_quad(float* p, int i0, int nx, const float (&v)[4]) {
  if (ALIGNED) {
    *reinterpret_cast<float4*>(p + i0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (i0 + l < nx) p[i0 + l] = v[l];
}
template <bool ALIGNED>
__device__ __forceinline__ void store_quad(double* p, int i0, int nx, const double (&v)[4]) {
  if (ALIGNED) {
    double2* q = reinterpret_cast<double2*>(p + i0);
    q[0] = make_double2(v[0], v[1]);
    q[1] = make_double2(v[2], v[3]);
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (i0 + l < nx) p[i0 + l] = v[l];
}
template <bool ALIGNED>
__device__ __forceinline__ void store_quad(__nv_bfloat16* p, int i0, int nx, const float (&v)[4]) {
  // v holds bf16 values already: the conversion is exact
  unsigned short b[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) b[l] = __bfloat16_as_ushort(__float2bfloat16_rn(v[l]));
  if (ALIGNED) {
    *reinterpret_cast<uint2*>(p + i0) = make_uint2(b[0] | (unsigned)b[1] << 16, b[2] | (unsigned)b[3] << 16);
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (i0 + l < nx) reinterpret_cast<unsigned short*>(p)[i0 + l] = b[l];
}

// A quad of a staged plane at p (16-byte aligned), read and written whole:
// one or two 16-byte accesses a thread, free of bank conflicts across a
// warp.
__device__ __forceinline__ void smem_get(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void smem_get(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0], b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void smem_put(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void smem_put(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// The coefficient quads of the offsets 9 PI .. 9 PI + 8 (the plane dk = PI
// - 1) at the cells' quad, the centre's skipped: it is summed first.
template <int PI, bool ALIGNED, class C>
__device__ __forceinline__ void load_plane(Raw<C> (&b)[9], const C* c0, long long n, int i0, int nx) {
#pragma unroll
  for (int q = 0; q < 9; ++q)
    if (9 * PI + q != VS_CENTRE) b[q] = load_quad<ALIGNED, true>(c0 + (9 * PI + q) * n, i0, nx);
}

// acc += the products of the plane dk = PI - 1, in OFFSETS order; `plane`
// is the staged plane at the thread's quad.
template <int PI, class A, class C, class S>
__device__ __forceinline__ void sum_plane(S (&acc)[4], const Raw<C> (&b)[9], const S* plane) {
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    const S* row = plane + (dj - 1) * VS_ROW;
    S w[6], m[4];  // x at cells i0 - 1 .. i0 + 4 of the row
    smem_get(row, m);
    w[0] = row[-1];
#pragma unroll
    for (int l = 0; l < 4; ++l) w[1 + l] = m[l];
    w[5] = row[4];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      if (9 * PI + 3 * dj + di == VS_CENTRE) continue;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        acc[l] = A::add(acc[l], A::mul(Widen<C>::get(b[3 * dj + di], l), w[l + di]));
    }
  }
}

// One block: one tile of one plane k of one column.  It stages planes k -
// 1, k and k + 1 of the tile and its one-cell rim, one after the other,
// meets the block's one barrier, and sums the centre's product and then
// each plane dk's, loading a plane's 9 coefficient quads before its sums.
template <class C, class X, bool ALIGNED>
__global__ void __launch_bounds__(BLOCK, VS_MIN_BLOCKS<C>)
varstencil27_kernel(const C* __restrict__ coef, const X* __restrict__ x, X* __restrict__ y,
                    int nz, int ny, int nx, int tiles_x) {
  using A = Arith<C, X>;
  using S = typename A::S;
  __shared__ __align__(16) S planes[3][VS_PLANE];
  const long long n = (long long)nz * ny * nx;
  const int k = (int)blockIdx.y, col = (int)blockIdx.z;
  x += col * n;
  y += col * n;
  const int t = (int)threadIdx.x, qx = t % VS_QX, ly = t / VS_QX;
  const int tx0 = (int)blockIdx.x % tiles_x * VS_TX, ty0 = (int)blockIdx.x / tiles_x * VS_TY;
  const int j = ty0 + ly, i0 = tx0 + 4 * qx;
  const int own = (ly + 1) * VS_ROW + 4 + 4 * qx;  // the thread's quad in a staged plane

  auto row = [&](int p, int jj) -> const X* {
    return p >= 0 && p < nz && jj >= 0 && jj < ny ? x + ((long long)p * ny + jj) * nx : nullptr;
  };
  // the thread's cells of plane p, staged into pl (zeros past the grid):
  // its own quad and, in threads 0-31, a quad of the rows above and below
  // the tile, in threads 32-67 a cell left or right of a staged row (the
  // corners too, which the offsets (dk, +-1, +-1) read)
  auto stage = [&](S* pl, int p) {
    S v[4];
    const Raw<X> q = load_quad<ALIGNED, false>(row(p, j), i0, nx);
#pragma unroll
    for (int l = 0; l < 4; ++l) v[l] = Widen<X>::get(q, l);
    smem_put(pl + own, v);
    if (t < 2 * VS_QX) {
      const int r = t < VS_QX ? 0 : VS_TY + 1, c = t % VS_QX;
      const Raw<X> h = load_quad<ALIGNED, false>(row(p, ty0 - 1 + r), tx0 + 4 * c, nx);
#pragma unroll
      for (int l = 0; l < 4; ++l) v[l] = Widen<X>::get(h, l);
      smem_put(pl + r * VS_ROW + 4 + 4 * c, v);
    } else if (t < 2 * VS_QX + 2 * (VS_TY + 2)) {
      const int c = t - 2 * VS_QX, i = c % 2 ? tx0 + VS_TX : tx0 - 1;
      const X* r = row(p, ty0 - 1 + c / 2);
      pl[c / 2 * VS_ROW + (c % 2 ? 4 + VS_TX : 3)] = r && i >= 0 && i < nx ? Widen<X>::one(r + i) : S(0);
    }
  };
#pragma unroll
  for (int d = 0; d < 3; ++d) stage(planes[d], k - 1 + d);
  __syncthreads();
  if (j >= ny || i0 >= nx) return;

  const C* c0 = coef + ((long long)k * ny + j) * nx;
  S acc[4], xc[4];
  const Raw<C> centre = load_quad<ALIGNED, true>(c0 + VS_CENTRE * n, i0, nx);
  smem_get(planes[1] + own, xc);
#pragma unroll
  for (int l = 0; l < 4; ++l) acc[l] = A::mul(Widen<C>::get(centre, l), xc[l]);
  Raw<C> b[9];
  load_plane<0, ALIGNED>(b, c0, n, i0, nx);
  sum_plane<0, A>(acc, b, planes[0] + own);
  load_plane<1, ALIGNED>(b, c0, n, i0, nx);
  sum_plane<1, A>(acc, b, planes[1] + own);
  load_plane<2, ALIGNED>(b, c0, n, i0, nx);
  sum_plane<2, A>(acc, b, planes[2] + own);
  store_quad<ALIGNED>(y + ((long long)k * ny + j) * nx, i0, nx, acc);
}

template <class C, class X>
int launch(const void* coef, const void* x, void* y, int nz, int ny, int nx, bool aligned,
           dim3 grid, int tiles_x, cudaStream_t stream) {
  const C* c = static_cast<const C*>(coef);
  const X* u = static_cast<const X*>(x);
  X* v = static_cast<X*>(y);
  if (aligned)
    varstencil27_kernel<C, X, true><<<grid, BLOCK, 0, stream>>>(c, u, v, nz, ny, nx, tiles_x);
  else
    varstencil27_kernel<C, X, false><<<grid, BLOCK, 0, stream>>>(c, u, v, nz, ny, nx, tiles_x);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

}  // namespace

// y = A x for each of the ncols (nz, ny, nx) fields of x, contiguous, over
// one contiguous (27, nz, ny, nx) coefficient stack.  pair: 0 (bf16, f32),
// 1 (f32, f32), 2 (f64, f64), 3 (bf16, bf16); y has the field's type.  One
// block a tile of VS_TY x VS_TX cells of a plane of a column: a grid of
// (tiles_x tiles_y, nz, ncols) blocks (kernels/varstencil27.py::
// varstencil27_tiles); tiles that do not cover the plane exactly once are
// refused.
extern "C" int tps_varstencil27_mv(const void* coef, const void* x, void* y, int nz, int ny,
                                   int nx, int ncols, int pair, int tiles_x, int tiles_y,
                                   void* stream) {
  const bool plan_ok = nz > 0 && ny > 0 && nx > 0 && ncols > 0 && tiles_x == (nx + VS_TX - 1) / VS_TX &&
                       tiles_y == (ny + VS_TY - 1) / VS_TY && (long long)tiles_x * tiles_y < (1LL << 31) &&
                       nz <= 65535 && ncols <= 65535;
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  const bool aligned = nx % 4 == 0 && aligned16(coef) && aligned16(x) && aligned16(y);
  const dim3 grid(tiles_x * tiles_y, nz, ncols);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pair) {
    case 0: return launch<__nv_bfloat16, float>(coef, x, y, nz, ny, nx, aligned, grid, tiles_x, s);
    case 1: return launch<float, float>(coef, x, y, nz, ny, nx, aligned, grid, tiles_x, s);
    case 2: return launch<double, double>(coef, x, y, nz, ny, nx, aligned, grid, tiles_x, s);
    case 3: return launch<__nv_bfloat16, __nv_bfloat16>(coef, x, y, nz, ny, nx, aligned, grid, tiles_x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers a thread, spilled (local) bytes a thread and static shared
// bytes a block of the kernel of `pair` in its 16-byte (aligned 1) or
// 4-byte form, and the blocks an SM holds.
extern "C" int tps_varstencil27_attributes(int pair, int aligned, int* regs, int* local_bytes,
                                           int* static_smem, int* blocks_per_sm) {
  const void* kernels[4][2] = {
      {(const void*)varstencil27_kernel<__nv_bfloat16, float, false>,
       (const void*)varstencil27_kernel<__nv_bfloat16, float, true>},
      {(const void*)varstencil27_kernel<float, float, false>,
       (const void*)varstencil27_kernel<float, float, true>},
      {(const void*)varstencil27_kernel<double, double, false>,
       (const void*)varstencil27_kernel<double, double, true>},
      {(const void*)varstencil27_kernel<__nv_bfloat16, __nv_bfloat16, false>,
       (const void*)varstencil27_kernel<__nv_bfloat16, __nv_bfloat16, true>},
  };
  if (pair < 0 || pair > 3) return (int)cudaErrorInvalidValue;
  const void* kernel = kernels[pair][aligned ? 1 : 0];
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *static_smem = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, BLOCK, 0);
}
