// Integer Ozaki GEMM for Hopper (sm_90a): an f64-accurate product from
// exact int8 x int8 -> int32 tensor-core products. Bound to Python through
// a plain C interface (ctypes; see loraine_tpu_torch/ops/int8gemm.py).
//
// Replaces the two halves of loraine_tpu/ops/int8gemm.py, which are XLA
// ops there and not Pallas kernels:
//   O1 lt_ozaki_slice_s8 <- int8gemm.py::_slice_int8
//      (f64 fibers -> s int8 slices on an exponent-aligned grid)
//   O2 lt_ozaki_gemm_s8  <- int8gemm.py::matmul_f64_mxu's pair loop
//      (dot_general int8 -> int32 per slice pair, then the weighted sum)
//
// What it computes. A's row i (a fiber along k) is cut into s slices,
//   A[i, :] = a_scale[i] * sum_p 2^(-6(p+1)) Q_p[i, :]  (+ residual),
// with q = rint(R * 2^(6(p+1)-e)) and R -= q * 2^(e-6(p+1)): every step is
// exact in f64 (q is an integer of at most 7 bits, the factors are powers
// of two). B's columns are cut the same way. Then
//   out = a_scale b_scale * sum_t 2^(-6(t+2)) sum_{p+q=t} Q_p(A) Q_q(B)
// over t = 0..tmax. Each pair's product is exact in int32 (|q| <= 33 and
// k <= 2^17 keep every partial below 2^28), each pair's sum in f64 is exact
// (at most 11 pairs, below 2^32), and the weighted term is exact too; the
// only rounding is out + acc_t w_t, taken in ascending t. The plain version
// (ops/int8gemm.py) does the same operations in the same order, so the
// kernels equal it bit for bit. The exponents e (and the scales 2^e) come
// from the wrapper, computed in torch with the plain version's own code:
// the kernels never take a log2 of their own.
//
// Layouts. O1 reads f64 X [batch, rows, k] at any strides (sb, sr, sk) and
// writes int8 [s, batch, rows, kp], k-contiguous and zero-padded to kp (a
// multiple of 16). A is sliced as [batch, n, k]; B [batch, k, c] is sliced
// per column, so its slices come out transposed, [s, batch, c, kp]: both
// operands of O2 are then k-contiguous, as mma.sync's .row.col reads them.
//
// What bounds it on this card. At the IPM's shapes (maxG11: 800^3, twice
// an iteration; thetaG11: 2401 x 801 x 801, then 2401 x 801 x 2401) the
// scheme does 76 int8 products (s = 11 at bits = 55), 76 x 2 n c k
// operations: ~0.039 ms at 800^3 against the 1,979 TOPS int8 peak, more
// than the f64 product's own bound (~0.015 ms at 67 TFLOP/s). So on the
// H100 the route is expected to lose to the library's DGEMM; it exists so
// that the port runs every option value of the JAX package.
//
// Design (simple and right first). O2: one block of 8 warps per (64 x 64
// output tile, batch element); per pair, 64 x 128-byte k-tiles of both
// slices are staged in shared memory (rows padded to 144 bytes, so the
// fragment loads of a warp hit 32 distinct banks), and each warp runs
// mma.sync m16n8k32 s8 on its 32 x 16 sub-tile with int32 accumulators;
// at the end of a pair they are converted to f64 and added to acc_t, at the
// end of each t acc_t w_t is added to out, and the epilogue scales by
// a_scale[i] b_scale[j]. The k-tiles are not double-buffered and every
// pair reloads its slices: wgmma, TMA and a persistent grid are later work.
// O1: one block per 32 x 32 tile of (fibers, k), read along whichever axis
// is contiguous and staged through shared memory, so that both the f64
// reads and the int8 writes are coalesced.
//
// Rounding is explicit (__dmul_rn, __dadd_rn, __dsub_rn): the compiler may
// not contract a multiply and an add into an FMA, which would round
// differently from the plain version where a product is not exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BETA = 6;  // payload bits per slice (int8gemm.py:INT8_BETA)

// slicing tile
constexpr int ST = 32;
constexpr int ST_ROWS = 8;  // blockDim (32, 8)

// product tile
constexpr int BM = 64, BN = 64;  // output tile
constexpr int BK = 128;           // k-tile, bytes
constexpr int LDS = BK + 16;      // shared row stride, bytes
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns)

constexpr int ERR_SHAPE = -2;

// EXACT 2^n for n clamped to [-1022, 1023], as ozaki.pow2_int clamps it.
__device__ __forceinline__ double pow2(int n) {
  n = n < -1022 ? -1022 : (n > 1023 ? 1023 : n);
  return __longlong_as_double(static_cast<long long>(n + 1023) << 52);
}

__global__ void __launch_bounds__(ST * ST_ROWS)
    slice_kernel(const double* __restrict__ X, const int* __restrict__ e,
                 int8_t* __restrict__ out, int s, int batch, int rows, int k,
                 int kp, long long sb, long long sr, long long sk) {
  __shared__ double tile[ST][ST + 1];  // [fiber - r0][position - k0]
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * ST, k0 = blockIdx.x * ST;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool k_contig = sk == 1;
  const double* Xb = X + b * sb;
  for (int i = ty; i < ST; i += ST_ROWS) {
    // neighbouring threads read neighbouring addresses
    const int r = k_contig ? r0 + i : r0 + tx;
    const int kk = k_contig ? k0 + tx : k0 + i;
    double v = 0.0;
    if (r < rows && kk < k) v = Xb[r * sr + kk * sk];
    if (k_contig)
      tile[i][tx] = v;
    else
      tile[tx][i] = v;
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(batch) * rows * kp;
  for (int i = ty; i < ST; i += ST_ROWS) {
    const int r = r0 + i, kk = k0 + tx;
    if (r >= rows || kk >= kp) continue;
    double R = tile[i][tx];  // 0 in the pad [k, kp)
    const int ex = e[static_cast<size_t>(b) * rows + r];
    int8_t* o = out + (static_cast<size_t>(b) * rows + r) * kp + kk;
    for (int p = 0; p < s; ++p) {
      const double inv = pow2(BETA * (p + 1) - ex);
      const double sigma = pow2(ex - BETA * (p + 1));
      const double q = rint(__dmul_rn(R, inv));
      o[p * plane] = static_cast<int8_t>(static_cast<int>(q));
      R = __dsub_rn(R, __dmul_rn(q, sigma));
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const int8_t* __restrict__ Asl, const int8_t* __restrict__ Bsl,
                const double* __restrict__ a_scale,
                const double* __restrict__ b_scale, double* __restrict__ out,
                int s, int tmax, int batch, int n, int c, int kp) {
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];
  const int b = blockIdx.z, i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment coordinates
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 32 rows x 16 cols
  const size_t planeA = static_cast<size_t>(batch) * n * kp;
  const size_t planeB = static_cast<size_t>(batch) * c * kp;
  const int8_t* Ab = Asl + static_cast<size_t>(b) * n * kp;
  const int8_t* Bb = Bsl + static_cast<size_t>(b) * c * kp;

  // [m16 tile][n8 tile][fragment element]: rows g, g, g+8, g+8 and
  // columns 2 tg, 2 tg + 1 of each 16 x 8 tile
  double res[2][2][4], acc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) res[mi][ni][r] = 0.0;

  for (int t = 0; t <= tmax; ++t) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0;
    const int plo = t - s + 1 > 0 ? t - s + 1 : 0;
    const int phi = t < s - 1 ? t : s - 1;
    for (int p = plo; p <= phi; ++p) {
      const int8_t* Ap = Ab + p * planeA;
      const int8_t* Bq = Bb + (t - p) * planeB;
      int ci[2][2][4] = {};
      for (int k0 = 0; k0 < kp; k0 += BK) {
        for (int l = tid; l < BM * (BK / 16); l += GEMM_THREADS) {
          const int r = l / (BK / 16), kk = k0 + (l % (BK / 16)) * 16;
          uint4 va = make_uint4(0, 0, 0, 0), vb = va;
          if (kk < kp) {
            if (i0 + r < n)
              va = *reinterpret_cast<const uint4*>(
                  Ap + static_cast<size_t>(i0 + r) * kp + kk);
            if (j0 + r < c)
              vb = *reinterpret_cast<const uint4*>(
                  Bq + static_cast<size_t>(j0 + r) * kp + kk);
          }
          *reinterpret_cast<uint4*>(sA + r * LDS + (kk - k0)) = va;
          *reinterpret_cast<uint4*>(sB + r * LDS + (kk - k0)) = vb;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
          unsigned af[2][4], bf[2][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int8_t* base = sA + (wm * 32 + mi * 16 + g) * LDS + kk + tg * 4;
            af[mi][0] = ld32(base);                // row g,     k 4tg..
            af[mi][1] = ld32(base + 8 * LDS);      // row g + 8, k 4tg..
            af[mi][2] = ld32(base + 16);           // row g,     k 16 + 4tg..
            af[mi][3] = ld32(base + 8 * LDS + 16);  // row g + 8, k 16 + 4tg..
          }
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const int8_t* base = sB + (wn * 16 + ni * 8 + g) * LDS + kk + tg * 4;
            bf[ni][0] = ld32(base);       // column g, k 4tg..
            bf[ni][1] = ld32(base + 16);  // column g, k 16 + 4tg..
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni) mma_s8(ci[mi][ni], af[mi], bf[ni]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[mi][ni][r] = __dadd_rn(acc[mi][ni][r],
                                       static_cast<double>(ci[mi][ni][r]));
    }
    const double w = pow2(-BETA * (t + 2));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          res[mi][ni][r] = __dadd_rn(res[mi][ni][r], __dmul_rn(acc[mi][ni][r], w));
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + wm * 32 + mi * 16 + g + (r >= 2 ? 8 : 0);
        const int j = j0 + wn * 16 + ni * 8 + tg * 2 + (r & 1);
        if (i < n && j < c) {
          const double sc = __dmul_rn(a_scale[static_cast<size_t>(b) * n + i],
                                      b_scale[static_cast<size_t>(b) * c + j]);
          out[(static_cast<size_t>(b) * n + i) * c + j] = __dmul_rn(res[mi][ni][r], sc);
        }
      }
}

}  // namespace

// O1. X: f64 [batch, rows, k] at element strides (sb, sr, sk); e: int32
// [batch, rows], the fiber exponents; out: int8 [s, batch, rows, kp], kp a
// multiple of 16 and >= k (the pad is written as 0). Returns a cudaError_t
// (0 = success) or ERR_SHAPE.
extern "C" int lt_ozaki_slice_s8(const double* X, const int* e, int8_t* out,
                                 int s, int batch, int rows, int k, int kp,
                                 long long sb, long long sr, long long sk,
                                 void* stream) {
  if (s < 1 || s > 127 || batch < 1 || batch > 65535 || rows < 1 || k < 1 ||
      kp < k || kp % 16)
    return ERR_SHAPE;
  dim3 grid((kp + ST - 1) / ST, (rows + ST - 1) / ST, batch);
  slice_kernel<<<grid, dim3(ST, ST_ROWS), 0, static_cast<cudaStream_t>(stream)>>>(
      X, e, out, s, batch, rows, k, kp, sb, sr, sk);
  return cudaGetLastError();
}

// O2. Asl: int8 [s, batch, n, kp] (A's slices); Bsl: int8 [s, batch, c, kp]
// (B's slices, transposed); a_scale: f64 [batch, n]; b_scale: f64
// [batch, c]; out: f64 [batch, n, c]. Sums the pairs p + q = t for
// t = 0..tmax (tmax <= 2 s - 2). Returns a cudaError_t (0 = success) or
// ERR_SHAPE.
extern "C" int lt_ozaki_gemm_s8(const int8_t* Asl, const int8_t* Bsl,
                                const double* a_scale, const double* b_scale,
                                double* out, int s, int tmax, int batch, int n,
                                int c, int kp, void* stream) {
  if (s < 1 || tmax < 0 || tmax > 2 * s - 2 || batch < 1 || batch > 65535 ||
      n < 1 || c < 1 || kp < 16 || kp % 16 || (n + BM - 1) / BM > 65535)
    return ERR_SHAPE;
  dim3 grid((c + BN - 1) / BN, (n + BM - 1) / BM, batch);
  gemm_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      Asl, Bsl, a_scale, b_scale, out, s, tmax, batch, n, c, kp);
  return cudaGetLastError();
}
