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
// each kernel equals its plain version bit for bit on the card. What the
// designs below change is which thread computes an entry, and when.
//
// What bounds them on this card. Tensor cores have no dd, so the work is
// unfused f64 adds and multiplies on the SMs' FP64 lanes (64 an SM). D1 and
// D2 are chains of dependent steps: D1 sweeps * (m - 1) rounds, each
// waiting for the angles of the last, whose rotation (below) is a chain
// of 11 IEEE divisions and 3 square roots; D2 m columns, each a product
// pass, a log2(m)-level tree, a square root and a division. Their time
// is that latency and the barriers between the steps, far above the
// card-wide flop and byte bounds; the designs cut both.
//
// D1 (lt_dd_jacobi). Entry (i, j) of a round's column step J and the row
// step after it read only the 2x2 block of i's pair of rows and j's pair of
// columns, so one thread takes a whole block through both steps in
// registers (the plain version's order: column step, then row step) and a
// round needs one barrier. The rows of A are owned by tournament position:
// position k (0 <= k < m) of round r holds label 0 (k = 0) or
// 1 + (k - 1 + r) mod (m - 1) (round_robin_pairs), pair k is the positions
// (k, m - 1 - k), and a block ("CTA") owns the pairs [k0, k1) of a balanced
// split, both rows of each, so its blocks read local rows only. Each round
// every row moves one position (k -> k - 1, 1 -> m - 1, 0 stays): the
// rotating thread writes each rotated block straight into the row's slot of
// the next round, in the other of two buffers, remote (distributed shared
// memory) for the two rows that leave a CTA. Meanwhile one lane per pair of
// the next round recomputes, from the current buffer, the three 2x2 blocks
// its angle needs (A[p,p], A[q,q], A[p,q] after the round; the same
// arithmetic as their owners, so the same bits) and runs the rotation, and
// stores the angle into every CTA of the cluster. One cluster barrier ends
// the round; a round costs the angle chain plus that barrier, with the
// rotation of the matrix beside it. V is only column-rotated, so its rows
// stay put, a share in each CTA. After each sweep (the tournament is back
// at position = label) dd_sym runs as one more step with the next sweep's
// first angles beside it. Regimes (lt_dd_plan, by m and the card):
//   "block"   one CTA a matrix (a cluster of 1) for m <= BLOCK_MAX_M (20),
//             where a cluster's barrier costs more than its spread of the work;
//   "cluster" C CTAs a matrix (C from CLUSTER_SIZES, the first whose
//             share, 48 m^2 / C bytes and the angles, fits the opt-in
//             shared memory: to m ~ 264 at C = 16 on an H100);
//   "global"  past that: the same code with each CTA's buffers in a global
//             scratch (loads past L1), C = 16.
// A batch of nb matrices is nb clusters; they never wait for each other.
//
// D2 (lt_dd_chol). Left-looking: column j's t_i = sum_k L[i,k] L[j,k] in
// dd_sum's halving tree over all m columns (the uncomputed ones are exact
// zeros; the odd element folds into slot 0). Eight lanes take a row, its
// tree in a slot array of their own, a __syncwarp a level, so the tree needs
// no block barrier; slots that are exact zeros (every slot k >= j) are
// skipped, which removes about half the FP64 instructions (the FP64 issue
// rate, not latency, bounded a warp a row). A column is one barrier before
// the divisions and one after L's column is written. L and the trees stay
// in shared memory ("warp", to m = 105 on an H100); past that "global" is
// the product-array form with L in the output.
//
// D3 is a plain tiled GEMM, 16 x 16 outputs a block, one thread an output,
// each term dd_mul, summed by dd_add in ascending k: latency of the
// dependent dd_add chain per output.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ERR_SHAPE = -2;
constexpr int NTJ = 512;          // threads of a D1 block (and of D2 in "global")
constexpr int NTC = 512;          // threads of a D2 block in "warp"
constexpr int ROWS = NTC / 8;     // D2 "warp": rows at once, 8 lanes a row
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
// and the asymptotic t = 1/(2 tau) past |tau| > 1e150. The plain version
// computes both branches of t and selects one; only the selected one is
// computed here (the same bits), and none for an inactive pair (t = 0).
__device__ void rotation(dd app, dd aqq, dd apq, dd& c, dd& s) {
  const double scale = add(__dsqrt_rn(fabs(mul(app.hi, aqq.hi))), 1e-300);
  const bool active = fabs(apq.hi) > mul(0x1p-100, scale);
  const dd apq_s = {active ? apq.hi : 1.0, active ? apq.lo : 0.0};
  const dd num = dd_add(aqq, dd_neg(app));
  const dd den = dd_mul_f64(apq_s, 2.0);
  const dd tau = dd_div(num, den);
  const dd one = dd_const(1.0, tau.hi);
  dd t = {0.0, 0.0};
  if (active) {
    if (fabs(tau.hi) > 1e150) {
      t = dd_div(one, dd_mul_f64(tau, 2.0));
    } else {
      const double sgn = tau.hi >= 0.0 ? 1.0 : -1.0;
      const dd root = dd_sqrt(dd_add(one, dd_sqr(tau)));
      const dd t_small = dd_div(one, dd_add(dd_abs(tau), root));
      t = {mul(sgn, t_small.hi), mul(sgn, t_small.lo)};
    }
  }
  c = dd_div(one, dd_sqrt(dd_add(one, dd_sqr(t))));
  s = dd_mul(t, c);
}

__device__ __forceinline__ dd ld(const double* h, const double* l, size_t i) { return {h[i], l[i]}; }
__device__ __forceinline__ void st(double* h, double* l, size_t i, dd v) {
  h[i] = v.hi;
  l[i] = v.lo;
}
// a dd entry of D1's buffers or D2's L (one 16-byte word); in D1's "global"
// regime other CTAs write the buffers, so loads go past the (incoherent) L1
template <bool G>
__device__ __forceinline__ dd ld2(const double2* p) {
  const double2 v = G ? __ldcg(p) : *p;
  return {v.x, v.y};
}
__device__ __forceinline__ void st2(double2* p, dd v) { *p = make_double2(v.hi, v.lo); }
__device__ __forceinline__ dd half_of(dd u) { return {mul(0.5, u.hi), mul(0.5, u.lo)}; }

// ---- D1: the round-robin parallel cyclic Jacobi ---------------------------------
//
// The tournament (ops/eigh.py::round_robin_pairs): the label at position k of
// round r, the position of label x in round r, a row's position in the next
// round, and the pair (k or m - 1 - k) of a position.
__device__ __forceinline__ int label_at(int k, int r, int m) {
  if (k == 0) return 0;
  const int u = k - 1 + r;
  return 1 + (u >= m - 1 ? u - (m - 1) : u);
}
__device__ __forceinline__ int pos_of(int x, int r, int m) {
  if (x == 0) return 0;
  const int u = x - 1 - r;
  return 1 + (u < 0 ? u + (m - 1) : u);
}
__device__ __forceinline__ int next_pos(int k, int m) { return k == 0 ? 0 : (k == 1 ? m - 1 : k - 1); }
__device__ __forceinline__ int pair_of(int k, int m) { return k < m / 2 ? k : m - 1 - k; }

// Where the row at position k lives: its CTA (the owner of its pair in the
// split lo_b = b h / C) and its slot there (2 (pair - lo_b), + 1 for the
// bottom position m - 1 - pair).
__device__ __forceinline__ int slot_of(int k, int m, int C, int& owner) {
  const int h = m / 2, pi = pair_of(k, m);
  owner = ((pi + 1) * C - 1) / h;
  return 2 * (pi - owner * h / C) + (k >= h);
}

// dd entries of one CTA's region: two buffers of A's rows (2 ceil(h/C)
// rows each), its V rows (ceil(m/C)), the angles [2][h] x (c, s)
__host__ __device__ __forceinline__ int jacobi_rows(int m, int C) {
  return 2 * ((m / 2 + C - 1) / C);
}
__host__ __device__ __forceinline__ int jacobi_region(int m, int C) {
  return (2 * jacobi_rows(m, C) + (m + C - 1) / C) * m + 4 * (m / 2);
}

// A''[x, y] after a round, from the entries of its 2x2 block before it:
// rows x and its partner xx (the row angle cx, sx signed for x), columns
// y and yy (cy, sy signed for y): the column step, then the row step
__device__ __forceinline__ dd rotated(dd axy, dd axyy, dd axxy, dd axxyy, dd cx, dd sx, dd cy,
                                      dd sy) {
  const dd bx = dd_add(dd_mul(cy, axy), dd_mul(sy, axyy));
  const dd bxx = dd_add(dd_mul(cy, axxy), dd_mul(sy, axxyy));
  return dd_add(dd_mul(cx, bx), dd_mul(sx, bxx));
}

constexpr int CMAX = 16;

// One cluster of C CTAs per matrix (C = 1: one block, no cluster). a (hi,
// lo): [nb, m, m] the matrix, rotated; v (hi, lo): [nb, m, m] the start
// basis, updated; both in place. scratch: the CTAs' regions in the
// "global" regime (G), else unused.
template <bool G>
__global__ void __launch_bounds__(NTJ, 1)
    dd_jacobi_kernel(double* __restrict__ gah, double* __restrict__ gal, double* __restrict__ gvh,
                     double* __restrict__ gvl, double2* scratch, int m, int sweeps, int C) {
  extern __shared__ double2 smj[];
  __shared__ double2* peer[CMAX];  // every CTA's region (generic addresses)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x % C, mat = blockIdx.x / C;
  const int h = m / 2, R = jacobi_rows(m, C), reg = jacobi_region(m, C);
  const int nvmax = (m + C - 1) / C;
  double2* base = G ? scratch + (size_t)blockIdx.x * reg : smj;
  if (threadIdx.x < C)
    peer[threadIdx.x] = G ? scratch + ((size_t)mat * C + threadIdx.x) * reg
                          : (C > 1 ? cluster.map_shared_rank(smj, (int)threadIdx.x) : smj);
  double2* V = base + 2 * R * m;
  const int ang_at = (2 * R + nvmax) * m;  // [2][h][2] in every region
  const double2* ang0 = base + ang_at;
  const int lo = rank * h / C, np = (rank + 1) * h / C - lo;
  const int vlo = rank * m / C, nv = (rank + 1) * m / C - vlo;
  const int tid = threadIdx.x;
  // threads [0, np) are the angle lanes; the warps from aw on rotate
  const int aw = (np + 31) / 32 * 32, rt = tid - aw, nrot = NTJ - aw;
  const size_t off = (size_t)mat * m * m;
  auto sync = [&]() {
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  // the row at position k in buffer buf (its owner's slot)
  auto row = [&](int buf, int k) -> double2* {
    int b;
    const int s = slot_of(k, m, C, b);
    return (b == rank ? base : peer[b]) + (size_t)(buf * R + s) * m;
  };
  // the angle of pair k into buffer par of every CTA
  auto publish = [&](int par, int k, dd c, dd s) {
    for (int b = 0; b < C; ++b) {
      double2* a = (b == rank ? base : peer[b]) + ang_at + 2 * (par * h + k);
      st2(a, c);
      st2(a + 1, s);
    }
  };
  auto angle = [&](int par, int k, dd& c, dd& s) {
    c = ld2<G>(ang0 + 2 * (par * h + k));
    s = ld2<G>(ang0 + 2 * (par * h + k) + 1);
  };

  // round 0: position = label; own rows and V rows in
  for (int e = tid; e < 2 * np * m; e += NTJ) {
    const int s = e / m, j = e - s * m, pi = lo + s / 2;
    const int k = (s & 1) ? m - 1 - pi : pi;
    st2(base + e, ld(gah, gal, off + (size_t)k * m + j));
  }
  for (int e = tid; e < nv * m; e += NTJ) st2(V + e, ld(gvh, gvl, off + (size_t)vlo * m + e));
  sync();  // the rows are in, and every CTA runs before any remote store
  if (sweeps > 0 && tid < np) {  // the first angles, from the local rows
    const int p = lo + tid, q = m - 1 - p;
    const double2* rp = base + (size_t)(2 * tid) * m;
    const double2* rq = rp + m;
    dd c, s;
    rotation(ld2<G>(rp + p), ld2<G>(rq + q), ld2<G>(rp + q), c, s);
    publish(0, p, c, s);
  }
  sync();
  int cur = 0, par = 0;
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < m - 1; ++r) {
      if (rt >= 0) {
        for (int e = rt; e < (np + nv) * h; e += nrot) {
          const int t = e / h, k = e - t * h;
          const int y1 = label_at(k, r, m), y2 = label_at(m - 1 - k, r, m);
          const int cp = y1 < y2 ? y1 : y2, cq = y1 < y2 ? y2 : y1;
          dd cc, sc;
          angle(par, k, cc, sc);
          const dd nsc = dd_neg(sc);
          if (t < np) {  // the 2x2 block of own pair t and column pair k
            const int pi = lo + t, k1 = pi, k2 = m - 1 - pi;
            const int x1 = label_at(k1, r, m), x2 = label_at(k2, r, m);
            dd cr, sr;
            angle(par, pi, cr, sr);
            const dd s1 = x1 < x2 ? dd_neg(sr) : sr, s2 = x1 < x2 ? sr : dd_neg(sr);
            const double2* r1 = base + (size_t)(cur * R + 2 * t) * m;
            const double2* r2 = r1 + m;
            const dd a1p = ld2<G>(r1 + cp), a1q = ld2<G>(r1 + cq);
            const dd a2p = ld2<G>(r2 + cp), a2q = ld2<G>(r2 + cq);
            const dd b1p = dd_add(dd_mul(cc, a1p), dd_mul(nsc, a1q));
            const dd b1q = dd_add(dd_mul(cc, a1q), dd_mul(sc, a1p));
            const dd b2p = dd_add(dd_mul(cc, a2p), dd_mul(nsc, a2q));
            const dd b2q = dd_add(dd_mul(cc, a2q), dd_mul(sc, a2p));
            double2* w1 = row(cur ^ 1, next_pos(k1, m));
            double2* w2 = row(cur ^ 1, next_pos(k2, m));
            st2(w1 + cp, dd_add(dd_mul(cr, b1p), dd_mul(s1, b2p)));
            st2(w1 + cq, dd_add(dd_mul(cr, b1q), dd_mul(s1, b2q)));
            st2(w2 + cp, dd_add(dd_mul(cr, b2p), dd_mul(s2, b1p)));
            st2(w2 + cq, dd_add(dd_mul(cr, b2q), dd_mul(s2, b1q)));
          } else {  // V's row vlo + t - np, column pair k, in place
            double2* vr = V + (size_t)(t - np) * m;
            const dd vp = ld2<false>(vr + cp), vq = ld2<false>(vr + cq);
            st2(vr + cp, dd_add(dd_mul(cc, vp), dd_mul(nsc, vq)));
            st2(vr + cq, dd_add(dd_mul(cc, vq), dd_mul(sc, vp)));
          }
        }
      } else if (tid < np && r < m - 2) {
        // the angle of own pair lo + tid in round r + 1, from this round's
        // buffer: its labels p < q, their partners pp, qq in round r
        const int k = lo + tid;
        const int a = label_at(k, r + 1, m), b = label_at(m - 1 - k, r + 1, m);
        const int p = a < b ? a : b, q = a < b ? b : a;
        const int kp = pos_of(p, r, m), kq = pos_of(q, r, m);
        const int pp = label_at(m - 1 - kp, r, m), qq = label_at(m - 1 - kq, r, m);
        const double2 *rp = row(cur, kp), *rpp = row(cur, m - 1 - kp);
        const double2 *rq = row(cur, kq), *rqq = row(cur, m - 1 - kq);
        dd cP, sP, cQ, sQ;
        angle(par, pair_of(kp, m), cP, sP);
        angle(par, pair_of(kq, m), cQ, sQ);
        const dd sp = p < pp ? dd_neg(sP) : sP, sq = q < qq ? dd_neg(sQ) : sQ;
        const dd app = rotated(ld2<G>(rp + p), ld2<G>(rp + pp), ld2<G>(rpp + p), ld2<G>(rpp + pp),
                               cP, sp, cP, sp);
        const dd aqq = rotated(ld2<G>(rq + q), ld2<G>(rq + qq), ld2<G>(rqq + q), ld2<G>(rqq + qq),
                               cQ, sq, cQ, sq);
        const dd apq = rotated(ld2<G>(rp + q), ld2<G>(rp + qq), ld2<G>(rpp + q), ld2<G>(rpp + qq),
                               cP, sp, cQ, sq);
        dd c, s;
        rotation(app, aqq, apq, c, s);
        publish(par ^ 1, k, c, s);
      }
      sync();
      cur ^= 1;
      if (r < m - 2) par ^= 1;
    }
    // dd_sym (positions = labels again): own rows, entry (i, j) from the
    // row of label j; beside it the first angles of the next sweep
    if (rt >= 0) {
      double2* out = base + (size_t)((cur ^ 1) * R) * m;
      const double2* in = base + (size_t)(cur * R) * m;
      for (int e = rt; e < 2 * np * m; e += nrot) {
        const int s = e / m, j = e - s * m, pi = lo + s / 2;
        const int i = (s & 1) ? m - 1 - pi : pi;
        st2(out + e, half_of(dd_add(ld2<G>(in + e), ld2<G>(row(cur, j) + i))));
      }
    } else if (tid < np && sw + 1 < sweeps) {
      const int p = lo + tid, q = m - 1 - p;
      const double2* rp = base + (size_t)(cur * R + 2 * tid) * m;
      const double2* rq = rp + m;
      const dd app = ld2<G>(rp + p), aqq = ld2<G>(rq + q);
      dd c, s;
      rotation(half_of(dd_add(app, app)), half_of(dd_add(aqq, aqq)),
               half_of(dd_add(ld2<G>(rp + q), ld2<G>(rq + p))), c, s);
      publish(par ^ 1, p, c, s);
    }
    sync();
    cur ^= 1;
    par ^= 1;
  }
  // positions = labels: own rows and V rows out
  const double2* fin = base + (size_t)(cur * R) * m;
  for (int e = tid; e < 2 * np * m; e += NTJ) {
    const int s = e / m, j = e - s * m, pi = lo + s / 2;
    const int k = (s & 1) ? m - 1 - pi : pi;
    st(gah, gal, off + (size_t)k * m + j, ld2<G>(fin + e));
  }
  for (int e = tid; e < nv * m; e += NTJ) st(gvh, gvl, off + (size_t)vlo * m + e, ld2<false>(V + e));
}

// ---- D2: the left-looking dd Cholesky ---------------------------------------------
//
// "warp": one block of NTC threads per matrix, L in shared memory. Eight
// lanes take a row (four rows a warp, ROWS rows at once). Column j: the
// row's tree of t_i in its slot array S (in place; a __syncwarp a level):
// level 0 slot s = dd_add(P[s], P[s + m/2]) (slot 0 then adds P[m - 1] at
// an odd m), P[k] = dd_mul(L[i,k], L[j,k]) formed by the lane; each further
// level slot k = dd_add(S[k], S[k + half]), slot 0 adding S[n - 1] at an
// odd n. The columns k >= j are not computed yet, so P[k] = (+0, +0)
// exactly for k >= j, and so is every slot k >= j of every level (dd_mul and
// dd_add of (+0, +0) pairs give (+0, +0)): those slots are neither computed
// nor stored, and a read of one takes (+0, +0); the adds of such a zero to
// a computed slot are kept (they can change the sign of a zero), so t_i
// has dd_sum's bits. Then c_i = A[i,j] - t_i (row j: the pivot, ok &=
// c_j > 0, its dd_sqrt); barrier; L[j,j] = 0 + piv, L[i,j] = c_i / piv + 0
// below, a thread a row; barrier.
__global__ void __launch_bounds__(NTC, 1)
    dd_chol_kernel(const double* __restrict__ gah, const double* __restrict__ gal,
                   double* __restrict__ glh, double* __restrict__ gll, bool* __restrict__ ok_out,
                   int m) {
  extern __shared__ double2 smc[];
  __shared__ double2 piv;
  __shared__ int okv;
  const int half0 = m / 2, slots = half0 > 0 ? half0 : 1;
  double2* L = smc;                                // [m][m]
  double2* cv = L + m * m;                         // [m]: c_i of the column
  double2* S = cv + m + (threadIdx.x >> 3) * slots;  // this row group's tree
  const size_t off = (size_t)blockIdx.x * m * m;
  const int g = (threadIdx.x >> 3) & 3, l = threadIdx.x & 7, warp = threadIdx.x >> 5;
  const dd zero = {0.0, 0.0};
  for (int e = threadIdx.x; e < m * m; e += NTC) L[e] = make_double2(0.0, 0.0);
  if (threadIdx.x == 0) okv = 1;
  __syncthreads();
  for (int j = 0; j < m; ++j) {
    const double2* Lj = L + (size_t)j * m;
    auto slot = [&](int k) { return k < j ? ld2<false>(S + k) : zero; };
    for (int i0 = j + 4 * warp; i0 < m; i0 += ROWS) {  // the same trips across the warp
      const int i = i0 + g;
      const double2* Li = L + (size_t)(i < m ? i : j) * m;
      __syncwarp();
      int n = m;
      for (int s = l; s < (half0 < j ? half0 : j); s += 8) {
        const dd a = dd_mul(ld2<false>(Li + s), ld2<false>(Lj + s));
        dd v = dd_add(a, s + half0 < j ? dd_mul(ld2<false>(Li + s + half0), ld2<false>(Lj + s + half0))
                                       : zero);
        if ((n & 1) && s == 0) v = dd_add(v, zero);  // P[m - 1], column m - 1 >= j
        st2(S + s, v);
      }
      n = half0;
      while (n > 1) {
        __syncwarp();
        const int half = n / 2;
        for (int k = l; k < (half < j ? half : j); k += 8) {
          dd v = dd_add(ld2<false>(S + k), slot(k + half));
          if ((n & 1) && k == 0) v = dd_add(v, slot(n - 1));
          st2(S + k, v);
        }
        n = half;
      }
      __syncwarp();
      if (l == 0 && i < m) {
        const dd t = m > 1 && j > 0 ? ld2<false>(S) : zero;
        const dd c = dd_add(ld(gah, gal, off + (size_t)i * m + j), dd_neg(t));
        if (i == j) {
          const bool pos = c.hi > 0.0;
          if (!pos) okv = 0;
          st2(&piv, dd_sqrt({pos ? c.hi : 1.0, pos ? c.lo : 0.0}));
        } else {
          st2(cv + i, c);
        }
      }
    }
    __syncthreads();
    for (int i = j + threadIdx.x; i < m; i += NTC) {
      const dd p = ld2<false>(&piv);
      if (i == j) {
        st2(L + (size_t)j * m + j, {add(0.0, p.hi), add(0.0, p.lo)});
      } else {
        const dd col = dd_div(ld2<false>(cv + i), p);
        st2(L + (size_t)i * m + j, {add(col.hi, 0.0), add(col.lo, 0.0)});
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) ok_out[blockIdx.x] = okv != 0;
  for (int e = threadIdx.x; e < m * m; e += NTC) st(glh, gll, off + e, ld2<false>(L + e));
}

// "global" (past the shared memory's reach): L in the output, the products
// P[i,k] = L[i,k] L[j,k] of the rows i >= j in a scratch [m][m] (ph, pl),
// summed in place, one tree level a barrier; c in shared memory.
__global__ void __launch_bounds__(NTJ)
    dd_chol_global_kernel(const double* __restrict__ gah, const double* __restrict__ gal,
                          double* __restrict__ glh, double* __restrict__ gll,
                          double* __restrict__ gph, double* __restrict__ gpl,
                          bool* __restrict__ ok_out, int m) {
  extern __shared__ double smg[];
  const int mm = m * m;
  const size_t off = (size_t)blockIdx.x * mm;
  const double* Ah = gah + off;
  const double* Al = gal + off;
  double* Lh = glh + off;
  double* Ll = gll + off;
  double* Ph = gph + off;
  double* Pl = gpl + off;
  double* ch = smg;
  double* cl = ch + m;
  for (int e = threadIdx.x; e < mm; e += NTJ) {
    Lh[e] = 0.0;
    Ll[e] = 0.0;
  }
  __syncthreads();
  bool ok = true;
  for (int j = 0; j < m; ++j) {
    const int rows = m - j;
    for (int e = threadIdx.x; e < rows * m; e += NTJ) {
      const int i = j + e / m, k = e % m;
      st(Ph, Pl, i * m + k, dd_mul(ld(Lh, Ll, i * m + k), ld(Lh, Ll, j * m + k)));
    }
    __syncthreads();
    for (int n = m; n > 1; n /= 2) {
      const int half = n / 2;
      for (int e = threadIdx.x; e < rows * half; e += NTJ) {
        const int i = j + e / half, k = e % half;
        dd acc = dd_add(ld(Ph, Pl, i * m + k), ld(Ph, Pl, i * m + k + half));
        if ((n & 1) && k == 0) acc = dd_add(acc, ld(Ph, Pl, i * m + n - 1));
        st(Ph, Pl, i * m + k, acc);
      }
      __syncthreads();
    }
    for (int i = j + threadIdx.x; i < m; i += NTJ)
      st(ch, cl, i, dd_add(ld(Ah, Al, i * m + j), dd_neg(ld(Ph, Pl, i * m))));
    __syncthreads();
    const dd d = ld(ch, cl, j);
    const bool pos = d.hi > 0.0;
    ok = ok && pos;
    const dd piv = dd_sqrt({pos ? d.hi : 1.0, pos ? d.lo : 0.0});
    for (int i = j + threadIdx.x; i < m; i += NTJ) {
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

// ---- plans ------------------------------------------------------------------------
//
// D1: below BLOCK_MAX_M one block; else the first cluster size of
// CLUSTER_SIZES (at most m/2 CTAs) whose region fits the opt-in shared
// memory; else "global" with GLOBAL_C CTAs. Chosen by measurement
// (benchmarks/dd_kernels.py on an H100; PERF.md section 6).
constexpr int BLOCK_MAX_M = 20;
constexpr int CLUSTER_SIZES[] = {8, 16};
constexpr int GLOBAL_C = 16;

enum { JACOBI_GLOBAL = 0, JACOBI_BLOCK = 1, JACOBI_CLUSTER = 2 };
enum { CHOL_GLOBAL = 0, CHOL_WARP = 1 };

int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

int jacobi_fits(int m, int C, int optin) {
  const int np = (m / 2 + C - 1) / C;
  return C >= 1 && C <= CMAX && C <= m / 2 && np <= NTJ - 32 &&
         (long long)16 * jacobi_region(m, C) + 8 * CMAX <= optin;
}

// the regime of D1 at m (force > 0: C = force CTAs in shared memory, < 0:
// -force CTAs in "global"; 0: the rule above), its cluster size in *C
int jacobi_plan(int m, int force, int* C) {
  const int optin = optin_bytes();
  if (optin < 0 || m < 2 || m % 2) return ERR_SHAPE;
  if (force > 0) {
    *C = force;
    return jacobi_fits(m, force, optin) ? (force == 1 ? JACOBI_BLOCK : JACOBI_CLUSTER) : ERR_SHAPE;
  }
  if (force < 0) {
    *C = -force;
    return -force <= CMAX && -force <= m / 2 && (m / 2 + *C - 1) / *C <= NTJ - 32 ? JACOBI_GLOBAL
                                                                                 : ERR_SHAPE;
  }
  if (m <= BLOCK_MAX_M || m / 2 < 2) {
    *C = 1;
    if (jacobi_fits(m, 1, optin)) return JACOBI_BLOCK;
  }
  for (int c : CLUSTER_SIZES) {
    *C = c < m / 2 ? c : m / 2;
    if (jacobi_fits(m, *C, optin)) return *C == 1 ? JACOBI_BLOCK : JACOBI_CLUSTER;
  }
  *C = GLOBAL_C < m / 2 ? GLOBAL_C : m / 2;
  return (m / 2 + *C - 1) / *C <= NTJ - 32 ? JACOBI_GLOBAL : ERR_SHAPE;
}

// L, c and the row groups' trees
int chol_bytes(int m) { return 16 * (m * m + m + ROWS * (m / 2 > 0 ? m / 2 : 1)); }

int chol_plan(int m) {
  const int optin = optin_bytes();
  if (optin < 0 || m < 1) return ERR_SHAPE;
  if (chol_bytes(m) + 32 <= optin) return CHOL_WARP;
  return 16 * m <= optin ? CHOL_GLOBAL : ERR_SHAPE;
}

template <typename K>
cudaError_t prepare(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool G>
int launch_jacobi(double* ah, double* al, double* vh, double* vl, double2* scratch, int nb, int m,
                  int sweeps, int C, cudaStream_t st) {
  auto kern = dd_jacobi_kernel<G>;
  const int bytes = G ? 0 : 16 * jacobi_region(m, C);
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * C, 1, 1);
  cfg.blockDim = dim3(NTJ, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  if (C > 1) {
    if (C > 8) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    // the clusters never wait for each other: any number may queue, but
    // one must be able to run
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (active < 1) return ERR_SHAPE;
  }
  err = cudaLaunchKernelEx(&cfg, kern, ah, al, vh, vl, scratch, m, sweeps, C);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 = success) or -2 (the shape does not fit).

// The plan of lt_dd_jacobi (kernel 0; force as lt_dd_jacobi's) or
// lt_dd_chol (kernel 1) at m on the current device: returns the regime
// (D1: 0 "global", 1 "block", 2 "cluster"; D2: 0 "global", 1 "warp") or -2;
// out[0] = the CTAs a matrix, out[1] = the scratch a matrix in 16-byte
// words (D1 "global": the CTAs' regions; D2 "global": the products).
extern "C" int lt_dd_plan(int kernel, int m, int force, int* out) {
  int C = 1;
  const int regime = kernel == 0 ? jacobi_plan(m, force, &C) : chol_plan(m);
  if (regime < 0) return regime;
  out[0] = C;
  out[1] = regime != 0 ? 0 : (kernel == 0 ? C * jacobi_region(m, C) : m * m);
  return regime;
}

// D1. ah, al, vh, vl: [nb, m, m] f64, rotated in place (A: the matrix, V:
// the basis); m even; scratch: nb times lt_dd_plan's out[1] words where
// that is nonzero. force: 0 the plan's choice; k > 0 a cluster of k CTAs in
// shared memory (1: "block"), k < 0 "global" with -k (a comparison).
extern "C" int lt_dd_jacobi(double* ah, double* al, double* vh, double* vl, void* scratch,
                            int nb, int m, int sweeps, int force, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sweeps < 0 || nb < 1) return ERR_SHAPE;
  int C = 1;
  const int regime = jacobi_plan(m, force, &C);
  if (regime < 0 || (regime == JACOBI_GLOBAL && scratch == nullptr)) return ERR_SHAPE;
  double2* s = static_cast<double2*>(scratch);
  return regime == JACOBI_GLOBAL ? launch_jacobi<true>(ah, al, vh, vl, s, nb, m, sweeps, C, st)
                                 : launch_jacobi<false>(ah, al, vh, vl, s, nb, m, sweeps, C, st);
}

// D2. ah, al: [nb, m, m] f64 input; lh, ll: [nb, m, m] output (L); scratch:
// nb times lt_dd_plan's out[1] words ("global": the products; else may be
// null); ok: [nb] bool output.
extern "C" int lt_dd_chol(const double* ah, const double* al, double* lh, double* ll,
                          void* scratch, bool* ok, int nb, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb < 1) return ERR_SHAPE;
  const int regime = chol_plan(m);
  if (regime < 0 || (regime == CHOL_GLOBAL && scratch == nullptr)) return ERR_SHAPE;
  cudaError_t err;
  if (regime == CHOL_WARP) {
    const int bytes = chol_bytes(m);
    err = prepare(dd_chol_kernel, bytes);
    if (err != cudaSuccess) return err;
    dd_chol_kernel<<<nb, NTC, bytes, st>>>(ah, al, lh, ll, ok, m);
  } else {
    double* ph = static_cast<double*>(scratch);
    err = prepare(dd_chol_global_kernel, 16 * m);
    if (err != cudaSuccess) return err;
    dd_chol_global_kernel<<<nb, NTJ, 16 * m, st>>>(ah, al, lh, ll, ph, ph + (size_t)nb * m * m,
                                                   ok, m);
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
