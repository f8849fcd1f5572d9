// K1: the level-0 7-point star apply y = A x on the padded-resident layout.
//
// Replaces tpusparse/kernels/stencil7.py::star7_mv_padded (Pallas body
// _kernel), which the setup runs for the rho power iterations and the
// 27-comb Galerkin probing, and the solve for each inner CG's r0 = b - A x0.
//
// Bound on the H100: bytes.  The ideal is one read of x and diag and one
// write of y (12 bytes per cell, ~330 MB at 300^3, ~0.1 ms at 3.35 TB/s);
// 13 flops per cell are nothing against that.  Design: one thread per
// padded cell, neighbouring threads on neighbouring x addresses so every
// load and store coalesces; the six neighbour reads of x hit in L1/L2
// (a z-plane of a 300^3 field is 360 KB, so the k-1 / k+1 planes of a
// block's rows are still cached when it runs).  Register-resident z
// marching and shared-memory tiles are later work.
//
// K1p, the star on the plain (nz, ny, nx) layout, replaces
// tpusparse/kernels/stencil7.py::star7_mv_pallas, which pads x and diag into
// the resident layout, runs star7_mv_padded and crops y: 4 extra field
// passes.  Here the star masks every neighbour read by the domain bounds, so
// the plain field is a geometry with no face planes and nxp = nx, launched
// directly: one read of x and diag, one write of y (3 passes, ~324 MB at
// 300^3, ~0.097 ms at 3.35 TB/s).
//
// K1p over a stack, y[c] = A x[c] for the k columns of a (k, nz, ny, nx)
// field (KSP.mat_solve's block apply; the JAX package vmaps the star's XLA
// form instead), is one launch for the whole stack: one thread a cell that
// reads diag once and loops over the columns.  Bound: (2k + 1) n 4 bytes
// (diag once, x and y once a column).  The loop is not unrolled: unrolled,
// the launch took 0.52 ms at 300^3 with k = 4, rolled 0.44 (H100, 700 W).
// Each column is bit for bit one K1p launch: both kernels apply star_rn,
// the star with every rounding spelled out (two kernels would each be free
// to contract its sums into FMAs their own way, and did: the unpinned
// columns differed from K1p by an ulp).  K1p stays a kernel without the
// loop, which cost it 7% (0.18 against 0.17 ms) as the k = 1 launch.
#include "star7.cuh"

using namespace tps;

__global__ void __launch_bounds__(BLOCK)
star7_mv_kernel(const float* __restrict__ x, const float* __restrict__ diag,
                float* __restrict__ y, Geom g, Legs a, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float out = 0.0f;
  if (cell(g, q, k, j, i))
    out = star(Field{x}, diag[q] * x[q], q, k, j, i, g, a, pinned);
  y[q] = out;
}

extern "C" int tps_star7_mv(const float* x, const float* diag, float* y,
                            int nz, int ny, int nx, int nxp, float cx,
                            float cy, float cz, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  star7_mv_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
      x, diag, y, g, Legs{cx, cy, cz}, pinned);
  return (int)cudaGetLastError();
}

// (A u)[q] on the plain layout, as star() in star7.cuh but with every
// rounding explicit (no contraction left to the compiler), so that K1p and
// its stacked form compute it bit for bit alike.  Every cell of the plain
// layout is in the domain.
__device__ __forceinline__ float star_rn(const float* __restrict__ u, float center, long long q,
                                         int k, int j, int i, const Geom& g, Legs a, int pinned) {
  float xm = i > 0 ? u[q - 1] : 0.0f;
  float xp = i < g.nx - 1 ? u[q + 1] : 0.0f;
  float ym = j > 0 ? u[q - g.nxp] : 0.0f;
  float yp = j < g.ny - 1 ? u[q + g.nxp] : 0.0f;
  float zm = k > 0 ? u[q - g.plane] : 0.0f;
  float zp = k < g.nz - 1 ? u[q + g.plane] : 0.0f;
  if (pinned) {
    if (k == 0 && j == 0 && i == 0) return center;
    if (k == 0 && j == 0 && i == 1) xm = 0.0f;
    if (k == 0 && j == 1 && i == 0) ym = 0.0f;
    if (k == 1 && j == 0 && i == 0) zm = 0.0f;
  }
  const float s = __fmaf_rn(a.cx, __fadd_rn(xp, xm), center);
  return __fmaf_rn(a.cz, __fadd_rn(zp, zm), __fmaf_rn(a.cy, __fadd_rn(yp, ym), s));
}

__global__ void __launch_bounds__(BLOCK)
star7_mv_plain_kernel(const float* __restrict__ x, const float* __restrict__ diag,
                      float* __restrict__ y, Geom g, Legs a, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  cell(g, q, k, j, i);
  y[q] = star_rn(x, __fmul_rn(diag[q], x[q]), q, k, j, i, g, a, pinned);
}

__global__ void __launch_bounds__(BLOCK)
star7_mv_batched_kernel(const float* __restrict__ x, const float* __restrict__ diag,
                        float* __restrict__ y, Geom g, Legs a, int pinned, int nk) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  cell(g, q, k, j, i);
  const float d = diag[q];
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    const long long o = (long long)c * g.total;
    y[o + q] = star_rn(x + o, __fmul_rn(d, x[o + q]), q, k, j, i, g, a, pinned);
  }
}

// K1p: y = A x for each of the k plain (nz, ny, nx) fields of x; k = 1 runs
// the kernel without the column loop.
extern "C" int tps_star7_mv_plain(const float* x, const float* diag, float* y,
                                  int nz, int ny, int nx, int k, float cx,
                                  float cy, float cz, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nx, 0);
  if (k == 1)
    star7_mv_plain_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
        x, diag, y, g, Legs{cx, cy, cz}, pinned);
  else
    star7_mv_batched_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
        x, diag, y, g, Legs{cx, cy, cz}, pinned, k);
  return (int)cudaGetLastError();
}

// K1h, the halo form of K1p: y = A x on one (nz, ny, nx) block of f32
// whose neighbours' planes come from four ghost planes.  Replaces what
// tpusparse/dist/halo.py::_mv_shard computes under shard_map (the
// per-shard star with ppermuted boundary planes); its single-device
// kernel is tpusparse/kernels/stencil7.py::star7_mv_pallas, as K1p's.
// dist/halo.py::halo_mv launches it once a rank an apply, over the rank's
// whole z-slab with the two planes received from ranks r -+ 1.
//
// The block may be a strided view (plane stride sp, row stride sr, x unit
// stride; diag with x's strides, y with its own, osp and osr), so y is
// written in place with no copy of x, diag or y.  The ghosts are
// contiguous: z-low and z-high (ny, nx), y-low and y-high (nz, nx); a null
// pointer is a zero face (the domain boundary).  (ko, jo, io) is the
// pinned cell of the block, or ko = -1: its row keeps its diagonal term
// and its neighbours' reads of it are dropped (the caller ships ghost
// planes with the origin already masked, tpusparse/dist/halo.py:84-96).
//
// Bound on the H100: bytes, 3 passes of the block (x and diag read, y
// written) and the ghost planes; 13 flops a cell are nothing beside them.
// Design: a z-march on K15's (fused7.cu's march1).  A block of 256 threads
// owns a tile of HX_TY = 16 rows by HX_TX = 64 columns, a quad of 4 x
// cells a thread, and marches up one z-chunk of the block's planes; one
// launch covers the block, its chunks chosen so that the grid fills whole
// waves (kernels/stencil7.py::halo_plan, zmarch_slab_plan's rule).  x
// comes through a ring of HX_DEPTH planes in shared memory by cp.async,
// HX_AHEAD planes ahead of the plane computed, so that a block keeps that
// many planes of loads in flight.  A staged plane is the tile, one row a
// side (the y neighbours) and one cell a side of each tile row (the x
// neighbours past the tile).  A thread keeps its quads of planes k - 1 and
// k in registers (z-low and the centre), takes its z-high quad from the
// ring, its y neighbours from the rows above and below there, and its x
// neighbours from the next lanes (a warp holds two tile rows) or, at a
// row's ends, from the staged cells.  diag is read once, a quad one plane
// ahead into registers, and not staged; y is written once.  One barrier a
// plane.  The same march without async copies (each thread's share of a
// plane loaded into registers one plane ahead, then stored into the ring)
// ran 3% slower at 300^3 (medians of 4 and 5 timings in two calls); both
// at 72-79% of the bound, where the first K1h, one thread a cell and one
// launch a (z, y) block, ran at 47-49% (PERF.md section 6).  The plane
// below and above a chunk is the block's own or, at the block's ends, its
// z ghost; a y-edge row its y ghost's; a null ghost, a row past the y-edge
// row and a cell past x's ends are zeros.  No division: a thread's (k, j,
// i) come from its tile, its lane and the march step.
//
// ALIGNED: the bases, the strides and nx are multiples of 4 floats, so
// every row starts on 16 bytes: 16-byte copies, loads and stores, the
// row's last quad cut to its cells by the copy's src-size.  Otherwise
// every copy, load and store is 4 bytes (views into a slab of odd width).
//
// Every rounding is star_rn's, so each cell sums in K1p's order and the
// output is bit for bit one K1p launch on the global field.
constexpr int HX_QX = 16;                      // quads a tile row
constexpr int HX_TX = 4 * HX_QX;               // 64 tile columns
constexpr int HX_TY = BLOCK / HX_QX;           // 16 tile rows, a quad a thread
static_assert(32 % HX_QX == 0, "a warp holds whole tile rows");
// floats a staged row: its left cell at 3, the tile's cells at [4, 68),
// its right cell at 68 (the tile's quads on 16 bytes)
constexpr int HX_ROW = HX_TX + 8;
constexpr int HX_PLANE = (HX_TY + 2) * HX_ROW;  // the tile's rows and one a side
// 3 planes ahead, a ring of 4 (20.7 KB); 3 blocks an SM, so that a thread
// has the 78 registers it needs (at 4 blocks, 64 registers, it spilled).
// 2 or 4 planes ahead ran within the noise of 3 at 300^3 (PERF.md section
// 6)
constexpr int HX_AHEAD = 3;
constexpr int HX_DEPTH = HX_AHEAD + 1;
constexpr int HX_MIN_BLOCKS = 3;
constexpr int HX_SMEM = HX_DEPTH * HX_PLANE * (int)sizeof(float);

// Where row j of plane p of the block's neighbourhood (p in [-1, nz], j
// in [-1, ny]) comes from: the block, a ghost (p = -1 / nz: zlo / zhi; j
// = -1 / ny: ylo / yhi), or nowhere (nullptr: a zero face, a null ghost,
// a corner, a row past the y-edge row).  The pointer is the row's cell i =
// 0.
struct HaloSrc {
  const float* x;
  const float* zlo;
  const float* zhi;
  const float* ylo;
  const float* yhi;
  long long sp, sr;
  int nz, ny, nx;
  __device__ __forceinline__ const float* row(int p, int j) const {
    const bool in_p = p >= 0 && p < nz, in_j = j >= 0 && j < ny;
    if (in_p && in_j) return x + (long long)p * sp + (long long)j * sr;
    if (in_j && (p == -1 || p == nz)) {
      const float* g = p < 0 ? zlo : zhi;
      return g ? g + (long long)j * nx : nullptr;
    }
    if (in_p && (j == -1 || j == ny)) {
      const float* g = j < 0 ? ylo : yhi;
      return g ? g + (long long)p * nx : nullptr;
    }
    return nullptr;
  }
};

// The quad of `row` at cells [i0, i0 + 4) (i0 a multiple of 4), zeros
// past nx or without a row: staged into dst by cp.async, loaded, stored.
template <bool ALIGNED>
__device__ __forceinline__ void copy_quad(float* dst, const float* row, int i0,
                                          int nx, const float* any) {
  if constexpr (ALIGNED) {
    const int n = row ? min(max(nx - i0, 0), 4) : 0;
    cp_async16(dst, n ? row + i0 : any, 4 * n);
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const bool v = row && i0 + l < nx;
      cp_async4(dst + l, v ? row + i0 + l : any, v);
    }
  }
}

template <bool ALIGNED>
__device__ __forceinline__ Quad load_quad(const float* row, int i0, int nx) {
  Quad q{};
  if (!row) return q;
  if (ALIGNED && i0 + 4 <= nx)
    return quad_of(__ldg(reinterpret_cast<const float4*>(row + i0)));
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (i0 + l < nx) q.v[l] = __ldg(row + i0 + l);
  return q;
}

template <bool ALIGNED>
__device__ __forceinline__ void store_quad(float* row, int i0, int nx,
                                           const Quad& v) {
  if (ALIGNED && i0 + 4 <= nx) {
    *reinterpret_cast<float4*>(row + i0) = float4_of(v);
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (i0 + l < nx) row[i0 + l] = v.v[l];
}

__device__ __forceinline__ Quad shared_quad(const float* p) {
  return quad_of(*reinterpret_cast<const float4*>(p));
}

template <bool ALIGNED>
__global__ void __launch_bounds__(BLOCK, HX_MIN_BLOCKS)
star7_mv_halo_kernel(HaloSrc s, const float* __restrict__ diag,
                     float* __restrict__ y, long long osp, long long osr,
                     Legs a, int ko, int jo, int io, int zchunk) {
  extern __shared__ float4 halo_smem[];
  float* ring = reinterpret_cast<float*>(halo_smem);
  const int t = (int)threadIdx.x, qx = t % HX_QX, ly = t / HX_QX;
  const int tx0 = (int)blockIdx.x * HX_TX, ty0 = (int)blockIdx.y * HX_TY;
  const int j = ty0 + ly, i0 = tx0 + 4 * qx, nx = s.nx;
  const int z0 = (int)blockIdx.z * zchunk, z1 = min(z0 + zchunk, s.nz);
  // the pinned cell or a neighbour of it lies in this block's region
  const bool pin = ko >= 0 && ko >= z0 - 1 && ko <= z1 && jo >= ty0 - 1 &&
                   jo <= ty0 + HX_TY && io >= tx0 - 1 && io <= tx0 + HX_TX;
  const int own = (ly + 1) * HX_ROW + 4 + 4 * qx;  // the thread's quad
  auto slot = [&](int p) {
    return ring + (unsigned)(p - z0 + 1) % HX_DEPTH * HX_PLANE;
  };
  // the thread's share of staged plane p (z0 - 1 .. z1): its quad, and on
  // a plane the chunk computes, warp 0 the rows above and below the tile,
  // warp 1 the cells left and right of its rows
  auto stage = [&](int p) {
    if (p <= z1) {
      float* pl = slot(p);
      copy_quad<ALIGNED>(pl + own, s.row(p, j), i0, nx, s.x);
      if (p >= z0 && p < z1) {
        if (t < 2 * HX_QX) {
          const int r = t < HX_QX ? 0 : HX_TY + 1, q = t % HX_QX;
          copy_quad<ALIGNED>(pl + r * HX_ROW + 4 + 4 * q, s.row(p, ty0 - 1 + r),
                             tx0 + 4 * q, nx, s.x);
        } else if (t < 2 * HX_QX + 2 * HX_TY) {
          const int c = t - 2 * HX_QX, r = c / 2 + 1, right = c % 2;
          const int i = right ? tx0 + HX_TX : tx0 - 1;
          const float* row = s.row(p, ty0 - 1 + r);
          const bool v = row && i >= 0 && i < nx;
          cp_async4(pl + r * HX_ROW + (right ? 4 + HX_TX : 3), v ? row + i : s.x, v);
        }
      }
    }
    cp_async_commit();
  };
  const float* drow = j < s.ny ? diag + (long long)j * s.sr : nullptr;
  float* yrow = y + (long long)j * osr;

  for (int n = 0; n <= HX_AHEAD; ++n) stage(z0 - 1 + n);
  Quad dc = load_quad<ALIGNED>(drow ? drow + (long long)z0 * s.sp : nullptr, i0, nx);
  cp_async_wait<HX_AHEAD - 1>();  // planes z0 - 1 and z0
  __syncthreads();
  Quad um = shared_quad(slot(z0 - 1) + own), uc = shared_quad(slot(z0) + own);
  for (int k = z0; k < z1; ++k) {
    const Quad dn = load_quad<ALIGNED>(
        drow && k + 1 < z1 ? drow + (long long)(k + 1) * s.sp : nullptr, i0, nx);
    cp_async_wait<HX_AHEAD - 2>();  // plane k + 1
    __syncthreads();
    // plane k + AHEAD into the slot of plane k - 1, read last before the
    // barrier
    stage(k + HX_AHEAD);
    const float* pl = slot(k);
    const Quad zp = shared_quad(slot(k + 1) + own);
    const Quad ym = shared_quad(pl + own - HX_ROW), yp = shared_quad(pl + own + HX_ROW);
    float left = __shfl_up_sync(0xffffffffu, uc.v[3], 1);
    float right = __shfl_down_sync(0xffffffffu, uc.v[0], 1);
    if (qx == 0) left = pl[own - 1];
    if (qx == HX_QX - 1) right = pl[own + 4];
    if (j < s.ny) {
      Quad w;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float xm = l == 0 ? left : uc.v[l - 1];
        float xp = l == 3 ? right : uc.v[l + 1];
        float ymv = ym.v[l], ypv = yp.v[l], zmv = um.v[l], zpv = zp.v[l];
        const float center = __fmul_rn(dc.v[l], uc.v[l]);
        bool origin = false;
        if (pin) {
          const int i = i0 + l;
          if (k == ko && j == jo) {
            origin = i == io;
            if (i - 1 == io) xm = 0.0f;
            if (i + 1 == io) xp = 0.0f;
          }
          if (i == io) {
            if (k == ko && j - 1 == jo) ymv = 0.0f;
            if (k == ko && j + 1 == jo) ypv = 0.0f;
            if (j == jo && k - 1 == ko) zmv = 0.0f;
            if (j == jo && k + 1 == ko) zpv = 0.0f;
          }
        }
        const float sx = __fmaf_rn(a.cx, __fadd_rn(xp, xm), center);
        w.v[l] = origin ? center
                        : __fmaf_rn(a.cz, __fadd_rn(zpv, zmv),
                                    __fmaf_rn(a.cy, __fadd_rn(ypv, ymv), sx));
      }
      store_quad<ALIGNED>(yrow + (long long)k * osp, i0, nx, w);
    }
    um = uc;
    uc = zp;
    dc = dn;
  }
}

// K1h's launch plan is (tiles_x, tiles_y) tiles of HX_TY x HX_TX cells
// over the (ny, nx) plane times `chunks` z-chunks of `zchunk` planes
// (kernels/stencil7.py::halo_plan); a plan that does not cover the block
// exactly once, or asks for other shared bytes, is refused.
static bool halo_plan_ok(int nz, int ny, int nx, int tiles_x, int tiles_y,
                         int chunks, int zchunk, int smem_bytes) {
  return zchunk > 0 && tiles_x == (nx + HX_TX - 1) / HX_TX &&
         tiles_y == (ny + HX_TY - 1) / HX_TY && tiles_y <= 65535 &&
         chunks == (nz + zchunk - 1) / zchunk && chunks <= 65535 &&
         smem_bytes == HX_SMEM;
}

static bool aligned16(const void* p) {
  return ((unsigned long long)p & 15) == 0;
}

extern "C" int tps_star7_mv_halo(const float* x, const float* diag, float* y,
                                 int nz, int ny, int nx, long long sp, long long sr,
                                 long long osp, long long osr, const float* zlo,
                                 const float* zhi, const float* ylo,
                                 const float* yhi, float cx, float cy, float cz,
                                 long long origin, int tiles_x, int tiles_y,
                                 int chunks, int zchunk, int smem_bytes,
                                 void* stream) {
  if (!halo_plan_ok(nz, ny, nx, tiles_x, tiles_y, chunks, zchunk, smem_bytes))
    return (int)cudaErrorInvalidValue;
  int ko = -1, jo = -1, io = -1;
  if (origin >= 0) {
    const long long plane = (long long)ny * nx, rem = origin % plane;
    ko = (int)(origin / plane);
    jo = (int)(rem / nx);
    io = (int)(rem % nx);
  }
  const bool aligned = nx % 4 == 0 && sp % 4 == 0 && sr % 4 == 0 &&
                       osp % 4 == 0 && osr % 4 == 0 && aligned16(x) &&
                       aligned16(diag) && aligned16(y) && aligned16(zlo) &&
                       aligned16(zhi) && aligned16(ylo) && aligned16(yhi);
  const HaloSrc s{x, zlo, zhi, ylo, yhi, sp, sr, nz, ny, nx};
  const dim3 grid(tiles_x, tiles_y, chunks);
  if (aligned)
    star7_mv_halo_kernel<true><<<grid, BLOCK, smem_bytes, (cudaStream_t)stream>>>(
        s, diag, y, osp, osr, Legs{cx, cy, cz}, ko, jo, io, zchunk);
  else
    star7_mv_halo_kernel<false><<<grid, BLOCK, smem_bytes, (cudaStream_t)stream>>>(
        s, diag, y, osp, osr, Legs{cx, cy, cz}, ko, jo, io, zchunk);
  return (int)cudaGetLastError();
}

// Registers a thread, spilled (local) bytes a thread, static shared bytes
// a block and the blocks an SM holds (with the plan's dynamic shared
// bytes) of K1h's aligned (1) or 4-byte (0) form.
extern "C" int tps_halo_attributes(int aligned, int* regs, int* local_bytes,
                                   int* static_smem, int* blocks_per_sm) {
  const void* kernel = aligned ? (const void*)star7_mv_halo_kernel<true>
                               : (const void*)star7_mv_halo_kernel<false>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *static_smem = (int)attr.sharedSizeBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      BLOCK, HX_SMEM);
  return (int)err;
}

extern "C" const char* tps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int tps_block_size() { return BLOCK; }
