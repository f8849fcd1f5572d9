// CG's vector updates (solve/cg.py), two streaming launches an iteration:
//
//   cg_update_r:   r' = r - alpha ap
//   cg_update_xp:  x' = x + alpha p,  p' = z + beta p   (p read once)
//
// It replaces no Pallas kernel: the JAX package leaves the three updates
// of its CG body to one XLA fusion (tpusparse/solve/cg.py).  In PyTorch
// each update was two launches, a multiply by the 0-d device scalar (the
// strided elementwise kernel: a stride-0 operand is not vectorised) and
// an add, 15 passes over the field an iteration; these two kernels make 8
// (r' before the preconditioner, which reads it; x' beside p', since
// nothing reads x between the two).
//
// Bound on the H100: bytes.  A pass over the 720^3 padded field is 1.505
// GB in f32, so cg_update_r (3 passes) takes at least 1.35 ms and
// cg_update_xp (5 passes) 2.25 ms at 3.35 TB/s.  One thread a 16-byte
// vector of each field (float4, double2), a grid over them all, plain
// loads and stores: at 726 x 720 x 720 the chip measured 92-93% / 91-92%
// of the bound so.  A grid-stride loop on a grid of one wave (84-86%),
// evict-first hints (ld.global.cs / st.global.cs: 3-4 points less) and
// 2-8 vectors a thread (no gain) measured worse.  The n mod W cells past
// the last whole vector are the first threads' of block 0.  A base that is
// not 16-byte aligned (a view at an odd offset) takes one cell a thread.
//
// Rounding: as PyTorch's two ops a statement.  alpha and beta are read on
// the device from their 0-d tensors (f32 or f64; no host read) and cast to
// the field's type once, as the multiply's dynamic cast does (f64 -> f32
// rounds to nearest; f32 -> f64 is exact); then the product is rounded
// and the sum rounded (__fmul_rn, then __fadd_rn / __fsub_rn; f64 __dmul_rn,
// __dadd_rn / __dsub_rn), never contracted into an FMA.  So the outputs
// equal the torch expressions bit for bit.
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int CG_BLOCK = 256;

template <class T>
struct Num;
template <>
struct Num<float> {
  using V = float4;  // 16 bytes
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float from(double v) { return __double2float_rn(v); }
  __device__ static float from(float v) { return v; }
};
template <>
struct Num<double> {
  using V = double2;
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double from(double v) { return v; }
  __device__ static double from(float v) { return (double)v; }
};

// The 0-d scalar at p (f64 when is_f64, else f32) in the field's type.
template <class T>
__device__ __forceinline__ T scalar(const void* p, int is_f64) {
  return is_f64 ? Num<T>::from(__ldg(static_cast<const double*>(p)))
                : Num<T>::from(__ldg(static_cast<const float*>(p)));
}

// r - alpha ap on one unit U (a whole vector, or one cell).
template <class T, class U>
__device__ __forceinline__ U update_r(U r, U ap, T alpha) {
  T* rl = reinterpret_cast<T*>(&r);
  const T* al = reinterpret_cast<const T*>(&ap);
#pragma unroll
  for (int l = 0; l < (int)(sizeof(U) / sizeof(T)); ++l) rl[l] = Num<T>::sub(rl[l], Num<T>::mul(alpha, al[l]));
  return r;
}

// x + alpha p into x and z + beta p into p, on one unit.
template <class T, class U>
__device__ __forceinline__ void update_xp(U& x, U& p, U z, T alpha, T beta) {
  T* xl = reinterpret_cast<T*>(&x);
  T* pl = reinterpret_cast<T*>(&p);
  const T* zl = reinterpret_cast<const T*>(&z);
#pragma unroll
  for (int l = 0; l < (int)(sizeof(U) / sizeof(T)); ++l) {
    xl[l] = Num<T>::add(xl[l], Num<T>::mul(alpha, pl[l]));
    pl[l] = Num<T>::add(zl[l], Num<T>::mul(beta, pl[l]));
  }
}

// The unit of a launch: 16-byte vectors (VEC) or single cells.
template <class T, bool VEC>
using Unit = typename std::conditional<VEC, typename Num<T>::V, T>::type;

// out = r - alpha ap: one unit a thread (VEC: the n / W whole vectors, then
// block 0's first threads the n mod W tail cells).
template <class T, bool VEC>
__global__ void __launch_bounds__(CG_BLOCK)
cg_update_r_kernel(const T* __restrict__ r, const T* __restrict__ ap, const void* __restrict__ alpha_p,
                   int alpha_f64, T* __restrict__ out, long long n) {
  using U = Unit<T, VEC>;
  constexpr int W = sizeof(U) / sizeof(T);
  const T alpha = scalar<T>(alpha_p, alpha_f64);
  const long long nu = n / W, i = (long long)blockIdx.x * CG_BLOCK + threadIdx.x;
  if (i < nu)
    reinterpret_cast<U*>(out)[i] =
        update_r(reinterpret_cast<const U*>(r)[i], reinterpret_cast<const U*>(ap)[i], alpha);
  if (VEC && blockIdx.x == 0 && threadIdx.x < n - nu * W) {
    const long long c = nu * W + threadIdx.x;
    out[c] = update_r(r[c], ap[c], alpha);
  }
}

// x_out = x + alpha p and p_out = z + beta p, p read once; units as above.
template <class T, bool VEC>
__global__ void __launch_bounds__(CG_BLOCK)
cg_update_xp_kernel(const T* __restrict__ x, const T* __restrict__ p, const T* __restrict__ z,
                    const void* __restrict__ alpha_p, int alpha_f64, const void* __restrict__ beta_p,
                    int beta_f64, T* __restrict__ x_out, T* __restrict__ p_out, long long n) {
  using U = Unit<T, VEC>;
  constexpr int W = sizeof(U) / sizeof(T);
  const T alpha = scalar<T>(alpha_p, alpha_f64), beta = scalar<T>(beta_p, beta_f64);
  const long long nu = n / W, i = (long long)blockIdx.x * CG_BLOCK + threadIdx.x;
  if (i < nu) {
    U a = reinterpret_cast<const U*>(x)[i], b = reinterpret_cast<const U*>(p)[i];
    update_xp(a, b, reinterpret_cast<const U*>(z)[i], alpha, beta);
    reinterpret_cast<U*>(x_out)[i] = a;
    reinterpret_cast<U*>(p_out)[i] = b;
  }
  if (VEC && blockIdx.x == 0 && threadIdx.x < n - nu * W) {
    const long long c = nu * W + threadIdx.x;
    T a = x[c], b = p[c];
    update_xp(a, b, z[c], alpha, beta);
    x_out[c] = a;
    p_out[c] = b;
  }
}

bool aligned16(const void* q) { return ((unsigned long long)q & 15) == 0; }

// Launch `kernel` over `units` units, one a thread; false where the grid
// would pass the card's 2^31 - 1 blocks.
template <class K, class... Args>
int launch(K kernel, long long units, cudaStream_t s, Args... args) {
  const long long blocks = std::max(1LL, (units + CG_BLOCK - 1) / CG_BLOCK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, CG_BLOCK, 0, s>>>(args...);
  return (int)cudaGetLastError();
}

template <class T>
int update_r_launch(const void* r, const void* ap, const void* alpha, int alpha_f64, void* out, long long n,
                    cudaStream_t s) {
  const T* rt = static_cast<const T*>(r);
  const T* at = static_cast<const T*>(ap);
  T* ot = static_cast<T*>(out);
  if (aligned16(r) && aligned16(ap) && aligned16(out))
    return launch(cg_update_r_kernel<T, true>, n / (16 / (long long)sizeof(T)), s, rt, at, alpha, alpha_f64, ot, n);
  return launch(cg_update_r_kernel<T, false>, n, s, rt, at, alpha, alpha_f64, ot, n);
}

template <class T>
int update_xp_launch(const void* x, const void* p, const void* z, const void* alpha, int alpha_f64,
                     const void* beta, int beta_f64, void* x_out, void* p_out, long long n, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* pt = static_cast<const T*>(p);
  const T* zt = static_cast<const T*>(z);
  T* xo = static_cast<T*>(x_out);
  T* po = static_cast<T*>(p_out);
  if (aligned16(x) && aligned16(p) && aligned16(z) && aligned16(x_out) && aligned16(p_out))
    return launch(cg_update_xp_kernel<T, true>, n / (16 / (long long)sizeof(T)), s, xt, pt, zt, alpha, alpha_f64,
                  beta, beta_f64, xo, po, n);
  return launch(cg_update_xp_kernel<T, false>, n, s, xt, pt, zt, alpha, alpha_f64, beta, beta_f64, xo, po, n);
}

}  // namespace

// out = r - alpha ap over n contiguous cells of one type (dtype: 0 f32, 1
// f64); alpha a device scalar of f64 when alpha_f64, else f32.  n = 0
// launches nothing.
extern "C" int tps_cg_update_r(const void* r, const void* ap, const void* alpha, void* out, long long n, int dtype,
                               int alpha_f64, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return update_r_launch<float>(r, ap, alpha, alpha_f64, out, n, s);
    case 1: return update_r_launch<double>(r, ap, alpha, alpha_f64, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x_out = x + alpha p and p_out = z + beta p over n contiguous cells of one
// type; arguments as for tps_cg_update_r.
extern "C" int tps_cg_update_xp(const void* x, const void* p, const void* z, const void* alpha, const void* beta,
                                void* x_out, void* p_out, long long n, int dtype, int alpha_f64, int beta_f64,
                                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return update_xp_launch<float>(x, p, z, alpha, alpha_f64, beta, beta_f64, x_out, p_out, n, s);
    case 1: return update_xp_launch<double>(x, p, z, alpha, alpha_f64, beta, beta_f64, x_out, p_out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
