// Double-double (dd) dense linear algebra for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes; see
// loraine_tpu_torch/ops/dd_linalg.py).
//
// Three kernels of the native dd NT scaling (ops/nt_scaling.py:nt_scale_dd):
//   D1 lt_dd_jacobi <- loraine_tpu/ops/dd_linalg.py::_dd_jacobi_impl (the
//      round-robin parallel cyclic Jacobi in dd; dd_eigh_jacobi)
//   D2 lt_dd_chol   <- loraine_tpu/ops/dd_linalg.py::dd_chol (left-looking
//      dd Cholesky with its ok flag)
//   D3 lt_dd_gemm   <- loraine_tpu/ops/dd_linalg.py::dd_matmul (dd GEMM)
// None of them replaces a Pallas kernel: on the TPU these are XLA programs
// (fori_loops over rounds and columns, each compiled into one program).
// As eager torch ops they made one call of nt_scale_dd at theta1's m = 56
// ~2.3M device launches on an H100; here each call of a matrix function is
// one launch (a call of nt_scale_dd: D1 once, D2 once, D3 eight times).
//
// Arithmetic. A dd value is an unevaluated pair hi + lo of doubles, built
// from the error-free transforms TwoSum and Dekker's split/TwoProd
// (ops/dd.py). They are exact only if every + - * rounds once, so every
// one is written with __dadd_rn / __dsub_rn / __dmul_rn, which nvcc never
// contracts into an FMA; division and sqrt are __ddiv_rn / __dsqrt_rn
// (IEEE, correctly rounded, as torch's are). The operations follow the
// order of the plain versions in ops/dd.py and ops/dd_linalg.py one for
// one, the 0.0 * x terms included (they decide the sign of a zero), so
// each kernel equals its plain version bit for bit on the card.
//
// What bounds them on this card. Tensor cores have no dd, so the work is
// f64 arithmetic on the SM's FP64 units. D1 and D2 are sequences of
// dependent rounds (D1: sweeps * (m - 1) rounds; D2: m columns, each a
// product pass and a log2(m)-level tree): the time is the latency of the
// rounds and their block-wide barriers, far above the flop and byte
// bounds. One block per matrix keeps A and V (D1) or L and the products
// (D2) in shared memory for the whole call where 32 m^2 + 20 m bytes fit
// the opt-in maximum (m <= 84 on an H100; every dd2 block of the repo's
// cases is <= 56), else in global memory (regime "global", the same code).
// D3 is a plain tiled GEMM, 16 x 16 outputs a block, one thread an output,
// each term dd_mul, summed by dd_add in ascending k: latency of the
// dependent dd_add chain per output.

#include <cuda_runtime.h>

namespace {

constexpr int ERR_SHAPE = -2;
constexpr int NT = 512;           // threads of a D1 / D2 block
constexpr int TILE = 16;          // D3: TILE x TILE outputs a block

struct dd {
  double hi, lo;
};

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// ---- ops/dd.py ---------------------------------------------------------------

__device__ __forceinline__ dd two_sum(double a, double b) {
  const double s = add(a, b);
  const double bb = add(sub(s, a), mul(0.0, b));
  return {s, add(sub(a, sub(s, bb)), sub(b, bb))};
}

__device__ __forceinline__ void split(double a, double& hi, double& lo) {
  const double c = mul(134217729.0, a);  // 2^27 + 1
  hi = sub(c, sub(c, a));
  lo = sub(a, hi);
}

__device__ __forceinline__ dd two_prod(double a, double b) {
  const double p = mul(a, b);
  double ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  const double e = add(add(add(sub(mul(ah, bh), p), mul(ah, bl)), mul(al, bh)), mul(al, bl));
  return {p, e};
}

__device__ __forceinline__ dd renorm(double hi, double lo) {
  const double s = add(hi, lo);
  const double t = add(sub(s, hi), mul(0.0, lo));
  return {s, sub(lo, t)};
}

__device__ __forceinline__ dd dd_add(dd x, dd y) {
  const dd s = two_sum(x.hi, y.hi);
  const dd t = two_sum(x.lo, y.lo);
  const dd v = renorm(s.hi, add(s.lo, t.hi));
  return renorm(v.hi, add(t.lo, v.lo));
}

__device__ __forceinline__ dd dd_neg(dd x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ dd dd_mul_f64(dd x, double a) {
  const dd p = two_prod(x.hi, a);
  return renorm(p.hi, add(p.lo, mul(x.lo, a)));
}

// ---- ops/dd_linalg.py ----------------------------------------------------------

__device__ __forceinline__ dd dd_mul(dd x, dd y) {
  const dd p = two_prod(x.hi, y.hi);
  const double t = add(mul(x.hi, y.lo), mul(x.lo, y.hi));
  return renorm(p.hi, add(p.lo, t));
}

__device__ __forceinline__ dd dd_sqr(dd x) {
  return dd_mul(x, {add(x.hi, mul(0.0, x.lo)), add(x.lo, mul(0.0, x.hi))});
}

__device__ __forceinline__ dd dd_const(double c, double like) {
  const double z = mul(0.0, like);
  return {add(z, c), z};
}

__device__ dd dd_div(dd x, dd y) {
  const double yh = y.hi != 0.0 ? y.hi : 1.0;
  const double q1 = __ddiv_rn(x.hi, yh);
  const dd r = dd_add(x, dd_neg(dd_mul_f64(y, q1)));
  const double q2 = __ddiv_rn(r.hi, yh);
  const dd r2 = dd_add(r, dd_neg(dd_mul_f64(y, q2)));
  const double q3 = __ddiv_rn(r2.hi, yh);
  const dd q = two_sum(q1, q2);
  return renorm(q.hi, add(q.lo, q3));
}

__device__ dd dd_sqrt(dd x) {
  const bool pos = x.hi > 0.0;
  const double xh = pos ? x.hi : 1.0;
  const double s = __dsqrt_rn(xh);
  const dd s2 = two_prod(s, add(s, mul(0.0, s)));
  const dd r = dd_add({xh, pos ? x.lo : 0.0}, {-s2.hi, -s2.lo});
  const double d = __ddiv_rn(r.hi, mul(2.0, s));
  const dd out = two_sum(s, d);
  return {pos ? out.hi : 0.0, pos ? out.lo : 0.0};
}

__device__ __forceinline__ dd dd_abs(dd x) {
  const bool neg = x.hi < 0.0;
  return {neg ? -x.hi : x.hi, neg ? -x.lo : x.lo};
}

// dd_linalg.py::_rotation: the dd Givens rotation (c, s) of the pair (p, q)
// from A[p,p], A[q,q], A[p,q], with the Demmel-Veselic 2^-100 activity test
// and the asymptotic t = 1/(2 tau) past |tau| > 1e150.
__device__ void rotation(dd app, dd aqq, dd apq, dd& c, dd& s) {
  const double scale = add(__dsqrt_rn(fabs(mul(app.hi, aqq.hi))), 1e-300);
  const bool active = fabs(apq.hi) > mul(0x1p-100, scale);
  const dd apq_s = {active ? apq.hi : 1.0, active ? apq.lo : 0.0};
  const dd num = dd_add(aqq, dd_neg(app));
  const dd den = dd_mul_f64(apq_s, 2.0);
  const dd tau = dd_div(num, den);
  const bool big = fabs(tau.hi) > 1e150;
  const dd tau_c = {big ? 1.0 : tau.hi, big ? 0.0 : tau.lo};
  const double sgn = tau.hi >= 0.0 ? 1.0 : -1.0;
  const dd tau2 = dd_sqr(tau_c);
  const dd one = dd_const(1.0, tau.hi);
  const dd root = dd_sqrt(dd_add(one, tau2));
  const dd den_t = dd_add(dd_abs(tau_c), root);
  dd t_small = dd_div(one, den_t);
  t_small = {mul(sgn, t_small.hi), mul(sgn, t_small.lo)};
  const dd t_big = dd_div(one, dd_mul_f64(tau, 2.0));
  dd t = big ? t_big : t_small;
  if (!active) t = {0.0, 0.0};
  c = dd_div(one, dd_sqrt(dd_add(one, dd_sqr(t))));
  s = dd_mul(t, c);
}

__device__ __forceinline__ dd ld(const double* h, const double* l, int i) { return {h[i], l[i]}; }
__device__ __forceinline__ void st(double* h, double* l, int i, dd v) {
  h[i] = v.hi;
  l[i] = v.lo;
}

// ---- D1: the round-robin parallel cyclic Jacobi ---------------------------------
//
// One block per matrix. a (hi, lo): [nb, m, m] the matrix, rotated in place;
// v (hi, lo): [nb, m, m] the start basis, updated in place; pairs:
// round_robin_pairs(m) as int32 [m-1, 2, m/2]. A round: one thread per pair
// computes (c, s) from p = min, q = max of the pair (p's view: the partner q
// takes the same c and -s -> s_p = -s, s_q = +s); barrier; the columns
// (A J)[i,j] = c_j A[i,j] + s_j A[i,perm j] and V J, each thread the two
// columns of one pair in one row; barrier; the rows (J^T B)[i,j] = c_i B[i,j]
// + s_i B[perm i,j]; barrier. dd_sym (A <- (A + A^T) / 2) after each sweep.
template <bool SMEM>
__global__ void __launch_bounds__(NT)
    dd_jacobi_kernel(double* __restrict__ gah, double* __restrict__ gal, double* __restrict__ gvh,
                  double* __restrict__ gvl, const int* __restrict__ pairs, int m, int sweeps) {
  extern __shared__ double sm[];
  const int h = m / 2;
  const int mm = m * m;
  const size_t off = (size_t)blockIdx.x * mm;
  double *Ah, *Al, *Vh, *Vl, *rot;
  if (SMEM) {
    Ah = sm;
    Al = Ah + mm;
    Vh = Al + mm;
    Vl = Vh + mm;
    rot = Vl + mm;
    for (int e = threadIdx.x; e < mm; e += NT) {
      Ah[e] = gah[off + e];
      Al[e] = gal[off + e];
      Vh[e] = gvh[off + e];
      Vl[e] = gvl[off + e];
    }
  } else {
    Ah = gah + off;
    Al = gal + off;
    Vh = gvh + off;
    Vl = gvl + off;
    rot = sm;
  }
  // rot: c.hi, c.lo, s.hi, s.lo [4][h], then p, q [2][h] as int
  int* pq = reinterpret_cast<int*>(rot + 4 * h);
  __syncthreads();
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < m - 1; ++r) {
      for (int k = threadIdx.x; k < h; k += NT) {
        const int a = pairs[(2 * r) * h + k], b = pairs[(2 * r + 1) * h + k];
        const int p = a < b ? a : b, q = a < b ? b : a;
        dd c, s;
        rotation(ld(Ah, Al, p * m + p), ld(Ah, Al, q * m + q), ld(Ah, Al, p * m + q), c, s);
        rot[k] = c.hi;
        rot[h + k] = c.lo;
        rot[2 * h + k] = s.hi;
        rot[3 * h + k] = s.lo;
        pq[k] = p;
        pq[h + k] = q;
      }
      __syncthreads();
      // columns of A and V: items (matrix, row i, pair k)
      for (int e = threadIdx.x; e < 2 * m * h; e += NT) {
        const int w = e >= m * h;
        const int rem = e - w * m * h;
        const int i = rem / h, k = rem - i * h;
        double* Xh = w ? Vh : Ah;
        double* Xl = w ? Vl : Al;
        const int p = pq[k], q = pq[h + k];
        const dd c = {rot[k], rot[h + k]}, s = {rot[2 * h + k], rot[3 * h + k]};
        const dd xp = ld(Xh, Xl, i * m + p), xq = ld(Xh, Xl, i * m + q);
        st(Xh, Xl, i * m + p, dd_add(dd_mul(c, xp), dd_mul(dd_neg(s), xq)));
        st(Xh, Xl, i * m + q, dd_add(dd_mul(c, xq), dd_mul(s, xp)));
      }
      __syncthreads();
      // rows of A: items (pair k, column j)
      for (int e = threadIdx.x; e < h * m; e += NT) {
        const int k = e / m, j = e - k * m;
        const int p = pq[k], q = pq[h + k];
        const dd c = {rot[k], rot[h + k]}, s = {rot[2 * h + k], rot[3 * h + k]};
        const dd ap = ld(Ah, Al, p * m + j), aq = ld(Ah, Al, q * m + j);
        st(Ah, Al, p * m + j, dd_add(dd_mul(c, ap), dd_mul(dd_neg(s), aq)));
        st(Ah, Al, q * m + j, dd_add(dd_mul(c, aq), dd_mul(s, ap)));
      }
      __syncthreads();
    }
    // dd_sym: entry (i, j) = dd_add(A[i,j], A[j,i]) / 2; one thread per i <= j
    for (int e = threadIdx.x; e < mm; e += NT) {
      const int i = e / m, j = e - i * m;
      if (i > j) continue;
      const dd x = ld(Ah, Al, i * m + j), y = ld(Ah, Al, j * m + i);
      const dd u = dd_add(x, y), w = dd_add(y, x);
      st(Ah, Al, i * m + j, {mul(0.5, u.hi), mul(0.5, u.lo)});
      st(Ah, Al, j * m + i, {mul(0.5, w.hi), mul(0.5, w.lo)});
    }
    __syncthreads();
  }
  if (SMEM) {
    for (int e = threadIdx.x; e < mm; e += NT) {
      gah[off + e] = Ah[e];
      gal[off + e] = Al[e];
      gvh[off + e] = Vh[e];
      gvl[off + e] = Vl[e];
    }
  }
}

// ---- D2: the left-looking dd Cholesky ---------------------------------------------
//
// One block per matrix. Column j: the products P[i,k] = L[i,k] L[j,k] of
// the rows i >= j over all m columns (the uncomputed ones are zero); their
// sum in dd_sum's pairwise tree (halving, the odd element folded into the
// first slot), in place, one barrier a level; c_i = A[i,j] - t_i; the
// pivot c_j (ok &= c_j > 0), its dd_sqrt, computed by every thread (the
// same bits); L[j,j] = 0 + piv, L[i,j] = c_i / piv + 0 below.
template <bool SMEM>
__global__ void __launch_bounds__(NT)
    dd_chol_kernel(const double* __restrict__ gah, const double* __restrict__ gal,
                double* __restrict__ glh, double* __restrict__ gll, double* __restrict__ gph,
                double* __restrict__ gpl, bool* __restrict__ ok_out, int m) {
  extern __shared__ double sm[];
  const int mm = m * m;
  const size_t off = (size_t)blockIdx.x * mm;
  const double* Ah = gah + off;
  const double* Al = gal + off;
  double *Lh, *Ll, *Ph, *Pl, *ch;
  if (SMEM) {
    Lh = sm;
    Ll = Lh + mm;
    Ph = Ll + mm;
    Pl = Ph + mm;
    ch = Pl + mm;
  } else {
    Lh = glh + off;
    Ll = gll + off;
    Ph = gph + off;
    Pl = gpl + off;
    ch = sm;
  }
  double* cl = ch + m;
  for (int e = threadIdx.x; e < mm; e += NT) {
    Lh[e] = 0.0;
    Ll[e] = 0.0;
  }
  __syncthreads();
  bool ok = true;
  for (int j = 0; j < m; ++j) {
    const int rows = m - j;
    for (int e = threadIdx.x; e < rows * m; e += NT) {
      const int i = j + e / m, k = e % m;
      st(Ph, Pl, i * m + k, dd_mul(ld(Lh, Ll, i * m + k), ld(Lh, Ll, j * m + k)));
    }
    __syncthreads();
    for (int n = m; n > 1; n /= 2) {
      const int half = n / 2;
      for (int e = threadIdx.x; e < rows * half; e += NT) {
        const int i = j + e / half, k = e % half;
        dd acc = dd_add(ld(Ph, Pl, i * m + k), ld(Ph, Pl, i * m + k + half));
        if ((n & 1) && k == 0) acc = dd_add(acc, ld(Ph, Pl, i * m + n - 1));
        st(Ph, Pl, i * m + k, acc);
      }
      __syncthreads();
    }
    for (int i = j + threadIdx.x; i < m; i += NT)
      st(ch, cl, i, dd_add(ld(Ah, Al, i * m + j), dd_neg(ld(Ph, Pl, i * m))));
    __syncthreads();
    const dd d = ld(ch, cl, j);
    const bool pos = d.hi > 0.0;
    ok = ok && pos;
    const dd piv = dd_sqrt({pos ? d.hi : 1.0, pos ? d.lo : 0.0});
    for (int i = j + threadIdx.x; i < m; i += NT) {
      if (i == j) {
        st(Lh, Ll, i * m + j, {add(0.0, piv.hi), add(0.0, piv.lo)});
      } else {
        const dd col = dd_div(ld(ch, cl, i), piv);
        st(Lh, Ll, i * m + j, {add(col.hi, 0.0), add(col.lo, 0.0)});
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) ok_out[blockIdx.x] = ok;
  if (SMEM) {
    for (int e = threadIdx.x; e < mm; e += NT) {
      glh[off + e] = Lh[e];
      gll[off + e] = Ll[e];
    }
  }
}

// ---- D3: the dd GEMM ------------------------------------------------------------------
//
// C = A B for [nb, m, k] @ [nb, k, n] (contiguous); C[i,j] = dd_mul(A[i,0],
// B[0,j]), then dd_add(C, dd_mul(A[i,kk], B[kk,j])) for kk = 1 .. k-1.
__global__ void __launch_bounds__(TILE* TILE)
    dd_gemm_kernel(const double* __restrict__ ah, const double* __restrict__ al,
                const double* __restrict__ bh, const double* __restrict__ bl,
                double* __restrict__ ch, double* __restrict__ cl, int nb, int m, int k, int n) {
  __shared__ double sah[TILE][TILE], sal[TILE][TILE], sbh[TILE][TILE], sbl[TILE][TILE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * TILE + ty, col = blockIdx.x * TILE + tx;
  for (int b = blockIdx.z; b < nb; b += gridDim.z) {
    const size_t oa = (size_t)b * m * k, ob = (size_t)b * k * n, oc = (size_t)b * m * n;
    dd acc = {0.0, 0.0};
    for (int k0 = 0; k0 < k; k0 += TILE) {
      const bool ina = row < m && k0 + tx < k, inb = k0 + ty < k && col < n;
      sah[ty][tx] = ina ? ah[oa + (size_t)row * k + k0 + tx] : 0.0;
      sal[ty][tx] = ina ? al[oa + (size_t)row * k + k0 + tx] : 0.0;
      sbh[ty][tx] = inb ? bh[ob + (size_t)(k0 + ty) * n + col] : 0.0;
      sbl[ty][tx] = inb ? bl[ob + (size_t)(k0 + ty) * n + col] : 0.0;
      __syncthreads();
      const int kend = k - k0 < TILE ? k - k0 : TILE;
      for (int kk = 0; kk < kend; ++kk) {
        const dd p = dd_mul({sah[ty][kk], sal[ty][kk]}, {sbh[kk][tx], sbl[kk][tx]});
        acc = k0 + kk == 0 ? p : dd_add(acc, p);
      }
      __syncthreads();
    }
    if (row < m && col < n) {
      ch[oc + (size_t)row * n + col] = acc.hi;
      cl[oc + (size_t)row * n + col] = acc.lo;
    }
  }
}

// shared memory of a D1 / D2 block in the "smem" regime (1) and the "global"
// regime (0)
int jacobi_bytes(int m, int regime) {
  return (regime ? 32 * m * m : 0) + 16 * m + 4 * m;
}
int chol_bytes(int m, int regime) { return (regime ? 32 * m * m : 0) + 16 * m; }

int bytes_of(int kernel, int m, int regime) {
  return kernel == 0 ? jacobi_bytes(m, regime) : chol_bytes(m, regime);
}

// "smem" (1) where the block fits the current device's opt-in shared memory
// (m <= 84 on an H100 for both), else "global" (0); -2 if neither fits
int regime_of(int kernel, int m) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return ERR_SHAPE;
  if (bytes_of(kernel, m, 1) <= optin) return 1;
  return bytes_of(kernel, m, 0) <= optin ? 0 : ERR_SHAPE;
}

template <typename K>
cudaError_t prepare(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Each returns a cudaError_t (0 = success) or -2 (the shape does not fit).

// The regime that lt_dd_jacobi (kernel 0) or lt_dd_chol (kernel 1) takes at
// m on the current device: 1 = "smem" (the matrices in shared memory), 0 =
// "global" (lt_dd_chol then needs its product scratch); -2 if none fits.
extern "C" int lt_dd_regime(int kernel, int m) { return m < 1 ? ERR_SHAPE : regime_of(kernel, m); }

// D1. ah, al, vh, vl: [nb, m, m] f64, rotated in place (A: the matrix, V:
// the basis); pairs: [m-1, 2, m/2] int32; m even.
extern "C" int lt_dd_jacobi(double* ah, double* al, double* vh, double* vl, const int* pairs,
                            int nb, int m, int sweeps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 2 || m % 2 || sweeps < 0 || nb < 1) return ERR_SHAPE;
  const int regime = regime_of(0, m);
  if (regime < 0) return regime;
  const int bytes = jacobi_bytes(m, regime);
  cudaError_t err;
  if (regime) {
    err = prepare(dd_jacobi_kernel<true>, bytes);
    if (err != cudaSuccess) return err;
    dd_jacobi_kernel<true><<<nb, NT, bytes, st>>>(ah, al, vh, vl, pairs, m, sweeps);
  } else {
    err = prepare(dd_jacobi_kernel<false>, bytes);
    if (err != cudaSuccess) return err;
    dd_jacobi_kernel<false><<<nb, NT, bytes, st>>>(ah, al, vh, vl, pairs, m, sweeps);
  }
  return cudaGetLastError();
}

// D2. ah, al: [nb, m, m] f64 input; lh, ll: [nb, m, m] output (L); ph, pl:
// [nb, m, m] product scratch (read only in the "global" regime, else may be
// null); ok: [nb] bool output.
extern "C" int lt_dd_chol(const double* ah, const double* al, double* lh, double* ll, double* ph,
                          double* pl, bool* ok, int nb, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || nb < 1) return ERR_SHAPE;
  const int regime = regime_of(1, m);
  if (regime < 0 || (!regime && (ph == nullptr || pl == nullptr))) return ERR_SHAPE;
  const int bytes = chol_bytes(m, regime);
  cudaError_t err;
  if (regime) {
    err = prepare(dd_chol_kernel<true>, bytes);
    if (err != cudaSuccess) return err;
    dd_chol_kernel<true><<<nb, NT, bytes, st>>>(ah, al, lh, ll, ph, pl, ok, m);
  } else {
    err = prepare(dd_chol_kernel<false>, bytes);
    if (err != cudaSuccess) return err;
    dd_chol_kernel<false><<<nb, NT, bytes, st>>>(ah, al, lh, ll, ph, pl, ok, m);
  }
  return cudaGetLastError();
}

// D3. ah, al: [nb, m, k]; bh, bl: [nb, k, n]; ch, cl: [nb, m, n] output;
// all f64, contiguous; k >= 1.
extern "C" int lt_dd_gemm(const double* ah, const double* al, const double* bh, const double* bl,
                          double* ch, double* cl, int nb, int m, int k, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb < 1 || m < 1 || k < 1 || n < 1) return ERR_SHAPE;
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, nb < 65535 ? nb : 65535);
  dd_gemm_kernel<<<grid, dim3(TILE, TILE), 0, st>>>(ah, al, bh, bl, ch, cl, nb, m, k, n);
  return cudaGetLastError();
}
