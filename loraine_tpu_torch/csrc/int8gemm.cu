// Integer Ozaki GEMM for Hopper (sm_90a): an f64-accurate product from
// exact int8 x int8 -> int32 tensor-core products. Bound to Python through
// a plain C interface (ctypes; see loraine_tpu_torch/ops/int8gemm.py).
//
// Replaces the two halves of loraine_tpu/ops/int8gemm.py, which are XLA
// ops there and not Pallas kernels:
//   O1 lt_ozaki_slice_s8 <- int8gemm.py::_slice_int8
//      (f64 fibers -> their exponents e, scales 2^e and s int8 slices on
//      the grid 2^e)
//   O2 lt_ozaki_gemm_s8  <- int8gemm.py::matmul_f64_mxu's pair loop
//      (dot_general int8 -> int32 per slice pair, then the weighted sum)
//
// What it computes. A's row i (a fiber along k) has the exponent
//   e_i = floor(log2(max(max_k |A[i, k]|, 2^-1000))) + 2   (2^e_i >= 2 max)
// and is cut into s slices,
//   A[i, :] = 2^e_i sum_p 2^(-6(p+1)) Q_p[i, :]  (+ residual),
// with q = rint(R * 2^(6(p+1)-e)) and R -= q * 2^(e-6(p+1)): every step is
// exact in f64 (q is an integer of at most 7 bits, the factors are powers
// of two). B's columns are cut the same way. Then
//   out = 2^e_i 2^e_j sum_t 2^(-6(t+2)) sum_{p+q=t} Q_p(A) Q_q(B)
// over t = 0..tmax. |q| <= 33, so a t's pairs (at most S_MAX = 11) summed
// over k <= K_MAX = 2^17 stay below 11 * 33^2 * 2^17 < 2^31: ONE int32
// accumulator per weight t holds the exact sum of all of its pairs, which
// is the exact f64 sum of the pair products that the plain version forms
// (every partial is an integer below 2^53). The only rounding is the sum
// over t, out + acc_t w_t in ascending t with __dmul_rn/__dadd_rn, then
// out (2^e_i 2^e_j); that order is fixed, and everything before it is
// integer arithmetic that may be split and reordered freely. The plain
// version (ops/int8gemm.py) does the same rounded operations in the same
// order, so the kernels equal it bit for bit. e is computed with CUDA's
// double log2, the function torch's CUDA log2 calls (ops/ozaki.py
// ceil_log2): frexp would differ by one where log2 rounds up to a power of
// two just below it.
//
// Layouts. O1 reads f64 X [batch, rows, k] at any strides (sb, sr, sk) and
// writes int8 [s, batch, rows, kp], k-contiguous and zero-padded to kp (a
// multiple of 16), e int32 and 2^e f64 [batch, rows]. A is sliced as
// [batch, n, k]; B [batch, k, c] per column (as B.mT), so its slices come
// out transposed, [s, batch, c, kp]: both operands of O2 are K-major, the
// only layout wgmma takes for 8-bit types.
//
// What bounds it on this card. At the IPM's shapes (maxG11: 800^3, twice
// an iteration; thetaG11: 2401 x 801 x 801, then 2401 x 801 x 2401) the
// scheme does 76 int8 products (s = 11 at bits = 55): 76 x 2 n c k
// operations, ~0.039 ms at 800^3 against the 1,979 TOPS int8 peak, more
// than the f64 product's own bound (~0.015 ms at 67 TFLOP/s). So the route
// loses to the library's DGEMM even at its bound; it exists so that the
// port runs every option value of the JAX package. O1 is bound by bytes:
// X read once, s slices written. O2 reads both slice tiles of every pair
// from L2: a 128 x 128 tile takes 2 x 128 bytes of L2 traffic per k for
// 128^2 products, which at the card's L2 rate caps it well below the int8
// peak (PERF.md has the measurements).
//
// O2's design. A 128 x 128 output tile per block: one producer thread issues
// TMA loads (4-D tensor maps over [s, batch, rows, kp], 128-byte boxes of
// k with the 128-byte swizzle, zero fill past kp and past n or c) into a
// ring of STAGES shared-memory stages guarded by mbarriers (full: the TMA
// bytes landed; empty: every consumer warpgroup that reads the stage is
// done with it); two consumer warpgroups, 64 rows each, run
// wgmma.mma_async m64n128k32 .s32.s8.s8 on both operands in shared memory,
// one k-tile's four wgmma in flight while the next is issued. The producer
// streams the pairs p of each t and their k-tiles, A's plane p against B's
// plane t - p, and the consumers keep one int32 accumulator (64 registers
// a thread) per t across all of its pairs: the first wgmma of a t
// overwrites it (scale-d = 0). To cut the L2 traffic, the blocks run as
// clusters of CM row tiles: the CM tiles of a cluster share B's tile, each
// CTA loads 1/CM of it and multicasts it to the others, so that a CTA
// reads BM + BN / CM bytes per k instead of BM + BN. At the end of a t
// the first chunk of a tile adds acc_t w_t to its f64 running sum, kept in
// shared memory (128 KB, which leaves room for three stages: in registers
// a consumer thread would hold 64 + 128 values, past the 168 registers
// that 288 threads leave it); later chunks store acc_t to an int32
// workspace. 800^2 gives only 56 tiles (7 columns of 8 rows, padded to
// whole clusters) for 132 SMs, so the wrapper's planner
// (ops/int8gemm.py::gemm_plan) splits a tile's weights t = 0..tmax into
// contiguous chunks balanced by pair count and orders the units longest
// first; with more than one chunk, a small epilogue kernel continues each
// tile's f64 sum in ascending t from the workspace and applies the scales.
// A whole product is O1, O1, O2 and at most that epilogue: four launches.
//
// O1's design. One block of 256 threads per 8 fibers: the fibers' maxima
// (threads laid along whichever axis of X is contiguous), e and 2^e, then
// 128-position strips of the 8 fibers staged through shared memory and
// sliced, each lane writing 4 consecutive int8 of a slice as one word.
//
// Rounding is explicit (__dmul_rn, __dadd_rn, __dsub_rn): the compiler may
// not contract a multiply and an add into an FMA, which would round
// differently from the plain version where a product is not exact.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BETA = 6;  // payload bits per slice (int8gemm.py:INT8_BETA)
constexpr long long K_MAX = 1LL << 17;  // ops/int8gemm.py:K_MAX
constexpr int S_MAX = 11;               // slices at bits = 55
constexpr int Q_MAX = 33;               // |q| <= 33 (in fact 32: 2^e >= 2 max)
// one int32 accumulator per weight t: its at most S_MAX pairs, each a sum
// of k <= K_MAX products of two slices, never overflow
static_assert(S_MAX * Q_MAX * Q_MAX * K_MAX < (1LL << 31), "int32 accumulator overflow");
constexpr double TINY = 0x1p-1000;      // int8gemm.py:_TINY

// O1
constexpr int FB = 8;          // fibers per block
constexpr int SK = 128;        // positions per staged strip
constexpr int SLICE_THREADS = 256;

// O2
constexpr int BM = 128, BN = 128;  // output tile
constexpr int BK = 128;            // k-tile, bytes (one 128-byte swizzle row)
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = (BM + BN) * BK;
constexpr int RES_BYTES = BM * BN * 8;  // the first chunk's f64 running sum
constexpr int GEMM_THREADS = 288;  // consumer warpgroups 0 and 1, producer warp 8
// a cluster of CM row tiles shares B's tile: each CTA loads 1/CM of it and
// multicasts it to the others (ops/int8gemm.py:CLUSTER)
constexpr int CM = 2;
constexpr int MAX_T = 32;          // weights t (tmax <= 2 s - 2)
constexpr int EPI_THREADS = 256;
constexpr int ERR_SHAPE = -2, ERR_TMAP = -3;

struct Plan {
  int nchunks;             // chunk i covers t in [tlo[i], tlo[i + 1])
  int tlo[MAX_T + 1];
  int order[MAX_T];        // block u runs chunk order[u / tiles]
};

// EXACT 2^n for n clamped to [-1022, 1023], as ozaki.pow2_int clamps it.
__device__ __forceinline__ double pow2(int n) {
  n = n < -1022 ? -1022 : (n > 1023 ? 1023 : n);
  return __longlong_as_double(static_cast<long long>(n + 1023) << 52);
}

// max that keeps a NaN, as torch.amax does
__device__ __forceinline__ double nanmax(double a, double b) {
  return (b > a || b != b) ? b : a;
}

// ---------------------------------------------------------------- O1

template <bool KC>  // KC: X is contiguous along k (sk == 1)
__global__ void __launch_bounds__(SLICE_THREADS)
    slice_kernel(const double* __restrict__ X, int8_t* __restrict__ out,
                 int* __restrict__ e_out, double* __restrict__ sc_out, int s,
                 int batch, int rows, int k, int kp, long long sb, long long sr,
                 long long sk) {
  __shared__ double red[FB][33];
  __shared__ int ex_s[FB];
  __shared__ __align__(16) double tile[FB][SK + 2];
  const int b = blockIdx.y, r0 = blockIdx.x * FB, tid = threadIdx.x;
  // global reads: neighbouring threads on neighbouring addresses
  const int f = KC ? tid >> 5 : tid & (FB - 1);
  const int ko = KC ? tid & 31 : tid >> 3;
  const int r = r0 + f;
  const double* x = X + b * sb + static_cast<long long>(r) * sr;
  double mx = 0.0;
  if (r < rows)
    for (int kk = ko; kk < k; kk += 32) mx = nanmax(mx, fabs(x[KC ? kk : kk * sk]));
  red[f][ko] = mx;
  __syncthreads();
  if (tid < FB) {
    double m = red[tid][0];
    for (int i = 1; i < 32; ++i) m = nanmax(m, red[tid][i]);
    // ozaki.ceil_log2(clamp_min(m, 2^-1000)): 2^e in [2 m, 4 m]
    const double xm = m < TINY ? TINY : m;
    const int ex = static_cast<int>(floor(log2(xm)) + 2.0);
    ex_s[tid] = ex;
    if (r0 + tid < rows) {
      e_out[static_cast<size_t>(b) * rows + r0 + tid] = ex;
      sc_out[static_cast<size_t>(b) * rows + r0 + tid] = pow2(ex);
    }
  }
  __syncthreads();
  const int w = tid >> 5, lane = tid & 31;  // slicing: fiber r0 + w, 4 positions a lane
  const int rw = r0 + w;
  const int ex = ex_s[w];
  const size_t plane = static_cast<size_t>(batch) * rows * kp;
  int8_t* o = out + (static_cast<size_t>(b) * rows + rw) * kp;
  for (int k0 = 0; k0 < kp; k0 += SK) {
#pragma unroll
    for (int i = 0; i < SK / 32; ++i) {  // zeros past k
      const int kk = k0 + ko + 32 * i;
      tile[f][ko + 32 * i] = (r < rows && kk < k) ? x[KC ? kk : kk * sk] : 0.0;
    }
    __syncthreads();
    const int kk = k0 + 4 * lane;
    if (rw < rows && kk < kp) {
      double R[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) R[j] = tile[w][4 * lane + j];
      for (int p = 0; p < s; ++p) {
        const double inv = pow2(BETA * (p + 1) - ex);
        const double sigma = pow2(ex - BETA * (p + 1));
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double q = rint(__dmul_rn(R[j], inv));
          word |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(
                      static_cast<int>(q)))) << (8 * j);
          R[j] = __dsub_rn(R[j], __dmul_rn(q, sigma));
        }
        *reinterpret_cast<uint32_t*>(o + p * plane + kk) = word;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- O2

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity ``parity`` to complete. A wait of ~2^34
// cycles (seconds) can only be a fault: trap instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// the same box to the CTAs of ``mask`` (bits = ranks in the cluster), at
// the same shared-memory offset, completing on each one's barrier
__device__ __forceinline__ void tma_load_mc(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar,
                                            uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar),
      "h"(mask)
      : "memory");
}

// arrive on the barrier at this offset in the cluster's CTA ``cta``
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster (also a block barrier)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// tile 1024-byte aligned
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ULL << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // at most N committed groups still in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (cutlass::warpgroup_fence_operand)
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 128, s32) = A (64 x 32, s8) B^T (128 x 32, s8) + (scale_d ? D : 0)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The element of the 128 x 128 tile that consumer thread th (0..255) holds
// in accumulator register r (0..63): warpgroup th / 128 has rows 64 wg ..,
// its warp w rows 16 w .., and register 4 j + q of the m64n128 fragment
// is row g (+8 for q >= 2), column 8 j + 2 tg (+1 for odd q).
__device__ __forceinline__ void frag_rc(int th, int r, int& row, int& col) {
  const int lane = th & 31, g = lane >> 2, tg = lane & 3;
  row = 64 * (th >> 7) + 16 * ((th >> 5) & 3) + g + ((r & 2) ? 8 : 0);
  col = 8 * (r >> 2) + 2 * tg + (r & 1);
}

__device__ __forceinline__ void tile_of(int tile, int tn, int tc, int& b, int& i0, int& j0) {
  b = tile / (tn * tc);
  const int rem = tile % (tn * tc);
  i0 = (rem / tc) * BM;
  j0 = (rem % tc) * BN;
}

// the pairs p of weight t: p in [plo, phi]
__device__ __forceinline__ int pair_lo(int t, int s) { return t - s + 1 > 0 ? t - s + 1 : 0; }
__device__ __forceinline__ int pair_hi(int t, int s) { return t < s - 1 ? t : s - 1; }

// a consumer warpgroup is done with stage st: tell every CTA of the
// cluster, since each one's producer multicasts into this CTA's stages
__device__ __forceinline__ void release(uint64_t* empty, int st) {
#pragma unroll
  for (int r = 0; r < CM; ++r) mbar_arrive_at(smem_addr(&empty[st]), r);
}

// The consumers: warpgroup th / 128 has rows 64 wg .. 64 wg + 63 of the
// tile, and runs the wgmma of every stage the producer fills. The first
// chunk's f64 running sum lives in shared memory (res[r][th]: 128 KB), so
// that a thread's 64 accumulators and its addressing fit the registers.
__device__ __forceinline__ void consume(const Plan& plan, int chunk, int tile, int b, int i0,
                                        int j0, int nkt, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, const double* __restrict__ a_scale,
                                        const double* __restrict__ b_scale,
                                        double* __restrict__ out, double* __restrict__ ws64,
                                        int* __restrict__ ws32, int s, int n, int c) {
  const int th = threadIdx.x, wg = th >> 7;
  const int t_begin = plan.tlo[chunk], t_end = plan.tlo[chunk + 1];
  double* res = reinterpret_cast<double*>(smem + STAGES * STAGE_BYTES) + th;
  int acc[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0;
  const int ntl = plan.tlo[plan.nchunks] - plan.tlo[1];  // weights in the workspace
  int st = 0, ph = 0;
  for (int t = t_begin; t < t_end; ++t) {
    int scale_d = 0;  // the first wgmma of a t overwrites the accumulator
    int prev = -1;    // the stage of the k-tile still in flight
    for (int p = pair_lo(t, s); p <= pair_hi(t, s); ++p)
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(smem_addr(&full[st]), ph);
        const uint32_t sa = smem_addr(smem + st * STAGE_BYTES);
        const uint64_t da = make_desc(sa + wg * 64 * BK);
        const uint64_t db = make_desc(sa + BM * BK);
        fence_acc(acc);
        wgmma_fence();
        // past kp the tile is TMA's zero fill: all four k32 steps run, so
        // that no wgmma sits on a divergent path
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          // the k offset inside the swizzled row: 32 bytes = 2 units of 16
          wgmma_s8(acc, da + 2 * kk, db + 2 * kk, scale_d);
          scale_d = 1;
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-tile's products are done
        fence_acc(acc);
        if (prev >= 0 && (th & 127) == 0) release(empty, prev);
        prev = st;
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    wgmma_wait<0>();
    fence_acc(acc);
    if ((th & 127) == 0) release(empty, prev);
    if (chunk == 0) {
      // the plain version's out = acc_0 w_0, then out + acc_t w_t
      const double w = pow2(-BETA * (t + 2));
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const double term = __dmul_rn(static_cast<double>(acc[r]), w);
        res[r * 256] = t == 0 ? term : __dadd_rn(res[r * 256], term);
      }
    } else {
      int4* dst = reinterpret_cast<int4*>(ws32) +
                  (static_cast<size_t>(tile) * ntl + (t - plan.tlo[1])) * 16 * 256 + th;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j * 256] = make_int4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  if (chunk != 0) return;
  if (plan.nchunks > 1) {  // the epilogue kernel goes on from here
    double2* dst = reinterpret_cast<double2*>(ws64) + static_cast<size_t>(tile) * 32 * 256 + th;
#pragma unroll
    for (int jj = 0; jj < 32; ++jj)
      dst[jj * 256] = make_double2(res[(2 * jj) * 256], res[(2 * jj + 1) * 256]);
    return;
  }
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    int row, col;
    frag_rc(th, r, row, col);
    const int i = i0 + row, j = j0 + col;
    if (i < n && j < c) {
      const double sc = __dmul_rn(a_scale[static_cast<size_t>(b) * n + i],
                                  b_scale[static_cast<size_t>(b) * c + j]);
      out[(static_cast<size_t>(b) * n + i) * c + j] = __dmul_rn(res[r * 256], sc);
    }
  }
}

__global__ void __cluster_dims__(CM, 1, 1) __launch_bounds__(GEMM_THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                const __grid_constant__ CUtensorMap tmB, const double* __restrict__ a_scale,
                const double* __restrict__ b_scale, double* __restrict__ out,
                double* __restrict__ ws64, int* __restrict__ ws32,
                const __grid_constant__ Plan plan, int s, int n, int c, int kp, int tn, int tc,
                int tiles) {
  extern __shared__ uint8_t smem_raw[];
  // stages 1024-byte aligned (the 128-byte swizzle's period)
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES + RES_BYTES);
  uint64_t* empty = full + STAGES;

  // block u: chunk order[u / tiles] of the cluster g = (u % tiles) / CM,
  // whose CTA of rank rr has the tile (CM tp + rr, tj) of batch element b
  const int u = blockIdx.x;
  const int chunk = plan.order[u / tiles];
  const int rr = static_cast<int>(cluster_rank());
  const int g = (u % tiles) / CM, tnp = tn / CM;
  const int b = g / (tnp * tc), tj = g % tc;
  const int ti = (g % (tnp * tc)) / tc * CM + rr;
  const int tile = (b * tn + ti) * tc + tj;
  const int i0 = ti * BM, j0 = tj * BN;
  const int t_begin = plan.tlo[chunk], t_end = plan.tlo[chunk + 1];
  const int nkt = (kp + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(smem_addr(&full[st]), 1);
      mbar_init(smem_addr(&empty[st]), 2 * CM);  // each consumer warpgroup of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread streams (t, p, k-tile) through the ring:
    // A's tile to this CTA, its share of B's tile to the whole cluster
    if (threadIdx.x == 256) {
      const uint16_t mask = (1u << CM) - 1;  // every CTA of the cluster
      const int rb = rr * (BN / CM);            // the first row of this CTA's share
      int st = 0, ph = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int p = pair_lo(t, s); p <= pair_hi(t, s); ++p)
          for (int kt = 0; kt < nkt; ++kt) {
            mbar_wait(smem_addr(&empty[st]), ph ^ 1);
            const uint32_t fb = smem_addr(&full[st]);
            mbar_expect_tx(fb, STAGE_BYTES);
            const uint32_t sa = smem_addr(smem + st * STAGE_BYTES);
            const uint32_t sb = sa + BM * BK;
            tma_load(sa, &tmA, kt * BK, i0, b, p, fb);
            tma_load_mc(sb + rb * BK, &tmB, kt * BK, j0 + rb, b, t - p, fb, mask);
            if (++st == STAGES) {
              st = 0;
              ph ^= 1;
            }
          }
    }
    __syncwarp();
  } else {
    consume(plan, chunk, tile, b, i0, j0, nkt, smem, full, empty, a_scale, b_scale, out, ws64,
            ws32, s, n, c);
  }
  // no CTA leaves while another may still arrive on its barriers
  cluster_sync();
}

// The sum over t continued past the first chunk: one block per tile,
// thread th holding what consumer thread th held.
__global__ void __launch_bounds__(EPI_THREADS)
    epilogue_kernel(const double* __restrict__ ws64, const int* __restrict__ ws32,
                    const double* __restrict__ a_scale, const double* __restrict__ b_scale,
                    double* __restrict__ out, int t1, int ntl, int n, int c, int tn, int tc) {
  const int tile = blockIdx.x, th = threadIdx.x;
  int b, i0, j0;
  tile_of(tile, tn, tc, b, i0, j0);
  const double2* r64 = reinterpret_cast<const double2*>(ws64) +
                       static_cast<size_t>(tile) * 32 * 256 + th;
  const int4* r32 = reinterpret_cast<const int4*>(ws32) +
                    static_cast<size_t>(tile) * ntl * 16 * 256 + th;
  for (int j = 0; j < 16; ++j) {
    const double2 lo = r64[(2 * j) * 256], hi = r64[(2 * j + 1) * 256];
    double res[4] = {lo.x, lo.y, hi.x, hi.y};
    for (int tl = 0; tl < ntl; ++tl) {
      const int4 a = r32[(tl * 16 + j) * 256];
      const double w = pow2(-BETA * (t1 + tl + 2));
      const int av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        res[q] = __dadd_rn(res[q], __dmul_rn(static_cast<double>(av[q]), w));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int row, col;
      frag_rc(th, 4 * j + q, row, col);
      const int i = i0 + row, jc = j0 + col;
      if (i < n && jc < c) {
        const double sc = __dmul_rn(a_scale[static_cast<size_t>(b) * n + i],
                                    b_scale[static_cast<size_t>(b) * c + jc]);
        out[(static_cast<size_t>(b) * n + i) * c + jc] = __dmul_rn(res[q], sc);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: reach it through the runtime's
// entry-point query, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &q);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map over int8 slices [s, batch, rows, kp]: boxes of 128 bytes of k
// by `box_rows` rows of one plane, 128-byte swizzle, zeros out of bounds
// (a box of 64 rows lands in the same swizzled layout as half of one of 128)
bool slice_map(CUtensorMap* map, const int8_t* base, int s, int batch, int rows, int kp,
               int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch), static_cast<cuuint64_t>(s)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(kp),
                                 static_cast<cuuint64_t>(rows) * kp,
                                 static_cast<cuuint64_t>(batch) * rows * kp};
  const cuuint32_t box[4] = {BK, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(base), dims, strides,
            box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// O1. X: f64 [batch, rows, k] at element strides (sb, sr, sk); out: int8
// [s, batch, rows, kp], kp a multiple of 16 and >= k (the pad is written
// as 0); e: int32 [batch, rows]; scale: f64 [batch, rows] (= 2^e). Returns
// a cudaError_t (0 = success) or ERR_SHAPE.
extern "C" int lt_ozaki_slice_s8(const double* X, int8_t* out, int* e, double* scale, int s,
                                 int batch, int rows, int k, int kp, long long sb,
                                 long long sr, long long sk, void* stream) {
  if (s < 1 || s > 127 || batch < 1 || batch > 65535 || rows < 1 || k < 1 || kp < k ||
      kp % 16)
    return ERR_SHAPE;
  dim3 grid((rows + FB - 1) / FB, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sk == 1)
    slice_kernel<true><<<grid, SLICE_THREADS, 0, st>>>(X, out, e, scale, s, batch, rows, k, kp,
                                                       sb, sr, sk);
  else
    slice_kernel<false><<<grid, SLICE_THREADS, 0, st>>>(X, out, e, scale, s, batch, rows, k,
                                                        kp, sb, sr, sk);
  return cudaGetLastError();
}

// O2's tile count for [batch, n, .] @ [batch, ., c]: the tile grid padded
// to whole clusters (ops/int8gemm.py checks its plan against it).
extern "C" long long lt_ozaki_gemm_tiles(int batch, int n, int c) {
  return static_cast<long long>(batch) * (((n + BM - 1) / BM + CM - 1) / CM * CM) *
         ((c + BN - 1) / BN);
}

// O2. Asl: int8 [s, batch, n, kp] (A's slices); Bsl: int8 [s, batch, c, kp]
// (B's slices, transposed); a_scale: f64 [batch, n]; b_scale: f64
// [batch, c]; out: f64 [batch, n, c]. Sums the pairs p + q = t for
// t = 0..tmax (tmax <= 2 s - 2) in the chunks tlo[0] = 0 < tlo[1] < ... <
// tlo[nchunks] = tmax + 1, launched in the chunk order `order`
// (ops/int8gemm.py::gemm_plan). With nchunks > 1, ws64 holds f64
// [tiles, 128 * 128] and ws32 int32 [tiles, tmax + 1 - tlo[1], 128 * 128]
// (tiles = lt_ozaki_gemm_tiles(batch, n, c)), and the epilogue kernel
// runs after the product. Returns a cudaError_t (0 = success), ERR_SHAPE
// or ERR_TMAP (no tensor map).
extern "C" int lt_ozaki_gemm_s8(const int8_t* Asl, const int8_t* Bsl, const double* a_scale,
                                const double* b_scale, double* out, double* ws64, int* ws32,
                                int s, int tmax, int batch, int n, int c, int kp,
                                int nchunks, const int* tlo, const int* order, void* stream) {
  // the int32 accumulator of a t holds at most s pairs of kp products
  if (s < 1 || tmax < 0 || tmax > 2 * s - 2 || tmax >= MAX_T || batch < 1 || n < 1 ||
      c < 1 || kp < 16 || kp % 16 ||
      static_cast<long long>(s) * Q_MAX * Q_MAX * kp >= (1LL << 31) || nchunks < 1 ||
      nchunks > tmax + 1 || tlo[0] != 0 || tlo[nchunks] != tmax + 1)
    return ERR_SHAPE;
  Plan plan{};
  plan.nchunks = nchunks;
  for (int i = 0; i <= nchunks; ++i) plan.tlo[i] = tlo[i];
  for (int i = 0; i < nchunks; ++i) {
    if (tlo[i + 1] <= tlo[i] || order[i] < 0 || order[i] >= nchunks) return ERR_SHAPE;
    plan.order[i] = order[i];
  }
  if (nchunks > 1 && (ws64 == nullptr || ws32 == nullptr)) return ERR_SHAPE;
  // the tile grid padded to whole clusters: a tile past n computes TMA's
  // zeros and writes nothing
  const int tn = ((n + BM - 1) / BM + CM - 1) / CM * CM;
  const int tc = (c + BN - 1) / BN;
  const long long tiles = static_cast<long long>(batch) * tn * tc;
  if (tiles * nchunks >= (1LL << 31)) return ERR_SHAPE;
  CUtensorMap tmA, tmB;
  if (!slice_map(&tmA, Asl, s, batch, n, kp, BM) ||
      !slice_map(&tmB, Bsl, s, batch, c, kp, BN / CM))
    return ERR_TMAP;
  const int smem = STAGES * STAGE_BYTES + RES_BYTES + 2 * STAGES * 8 + 1024;
  cudaError_t rc =
      cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gemm_kernel<<<static_cast<unsigned>(tiles * nchunks), GEMM_THREADS, smem, st>>>(
      tmA, tmB, a_scale, b_scale, out, ws64, ws32, plan, s, n, c, kp, tn, tc,
      static_cast<int>(tiles));
  rc = cudaGetLastError();
  if (rc != cudaSuccess || nchunks == 1) return rc;
  epilogue_kernel<<<static_cast<unsigned>(tiles), EPI_THREADS, 0, st>>>(
      ws64, ws32, a_scale, b_scale, out, tlo[1], tmax + 1 - tlo[1], n, c, tn, tc);
  return cudaGetLastError();
}
