// Single-launch conjugate gradients for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see loraine_tpu_torch/ops/pcg.py).
//
// Replaces the two Pallas TPU kernels of loraine_tpu/ops/pcg_pallas.py:
//   B3 lt_cg_minres_f64 <- pcg_pallas.py::_kernel_ff
//      (pcg_pallas_ff: CG on Hp = Mli H Mli^T, minimum-residual iterate,
//      stall exit after np/2 + 64 non-improving iterations)
//   B4 lt_cg_f32        <- pcg_pallas.py::_kernel
//      (pcg_pallas_mixed: plain f32 CG)
//
// What it computes. One whole CG solve per launch, with no host round trip
// inside the loop: x0 = 0, r = p = b, alpha = rr / pAp and beta = rr' / rr
// with the where(den != 0, den, 1) guards, stop when rr <= tol2 or
// it >= maxiter (B3 also when the stall counter reaches stall_max). B3
// returns the iterate of least ||r||^2 (strict < improvement), B4 the last.
// tol2 is read from device memory and the iteration count written there, so
// the wrapper's refinement passes need no host sync. B3's body is native
// f64: the TPU kernel carries every value as an unevaluated sum of two f32
// words (~2^-47) only because the TPU has no f64 unit; an f64 Hp takes the
// same bytes as the hi/lo pair and is at least as precise. Vectors are plain
// [n] arrays (the TPU's equal-lane [np, 128] tiles and identity-matmul
// transposes have no purpose here), and no padding is needed.
//
// What bounds it on this card. A CG iteration is one n x n matvec and two
// dot products, each a dependency of the next step: 2 n^2 flops against
// 8 n^2 bytes of Hp (f64), read from the 50 MB L2 (Hp is 1.7 MB at n = 464,
// 8 MB at n = 1000). At these sizes the bytes are a few microseconds at most;
// what bounds an iteration is the three grid-wide dependencies (matvec ->
// pAp -> r, rr -> p -> next matvec).
//
// What the design does about it. A cooperative launch of G = min(ceil(n/8),
// SMs) blocks of 256 threads, persistent for the whole solve. Each warp owns
// rows of the matvec (Hp row read coalesced, p staged in shared memory);
// each thread owns entries of x, r, p for the updates. The three
// dependencies are three grid.sync() per iteration. Cross-block sums go
// through per-block partials that EVERY block reduces itself in the same
// fixed order, so all blocks hold bitwise-equal scalars and take the same
// branch (a divergent exit would deadlock the next grid.sync()). Partials
// alternate between two buffers so that a block never overwrites one another
// block may still be reading. Values written by another block are read with
// __ldcg (L2, not a possibly stale L1 line).
//
// Time on one NVIDIA H100 80GB HBM3 at 700 W, one solve of the kappa = 1e3
// system of chip_smoke.py: B3 2.51 ms for 355 iterations at n = 464 (7.1 us
// an iteration), 3.27 ms for 381 at n = 1000; B4 2.58 ms (379 iterations)
// and 3.55 ms (391). The plain PyTorch versions: 54-103 ms (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 1024;  // scratch holds 2 * MAX_BLOCKS partials

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the sum
}

// Sum of one value per thread, in a fixed order, returned to every thread.
template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = T(0);
    for (int w = 0; w < WARPS; ++w) s += red[w];
    red[WARPS] = s;
  }
  __syncthreads();
  const T s = red[WARPS];
  __syncthreads();  // red may be reused right away
  return s;
}

// Sum of the G block partials; every block computes it the same way.
template <typename T>
__device__ T grid_sum(const T* part, int G, T* red) {
  T v = T(0);
  for (int k = threadIdx.x; k < G; k += THREADS) v += __ldcg(part + k);
  return block_sum(v, red);
}

template <typename T, bool MINRES>
__global__ void __launch_bounds__(THREADS)
cg_kernel(const T* __restrict__ H, const T* __restrict__ b,
          const T* __restrict__ tol2p, T* __restrict__ x_out,
          int* __restrict__ it_out, T* __restrict__ scratch, int n,
          int maxiter, int stall_max) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ps = reinterpret_cast<T*>(smem_raw);  // p, staged for the matvec
  __shared__ T red[WARPS + 1];

  const int G = gridDim.x;
  T* x = scratch;
  T* r = x + n;
  T* p = r + n;
  T* Ap = p + n;
  T* part_a = Ap + n;               // pAp partials
  T* part_b = part_a + MAX_BLOCKS;  // rr partials
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  const int nthreads = G * THREADS;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nwarps = G * WARPS;
  const T tol2 = *tol2p;

  T loc = T(0);
  for (int i = tid; i < n; i += nthreads) {
    const T bi = b[i];
    x[i] = T(0);
    r[i] = bi;
    __stcg(p + i, bi);
    if (MINRES) x_out[i] = T(0);
    loc += bi * bi;
  }
  T s = block_sum(loc, red);
  if (threadIdx.x == 0) __stcg(part_b + blockIdx.x, s);
  grid.sync();
  T rr = grid_sum(part_b, G, red);
  T best = rr;
  int stall = 0;
  int it = 0;

  while (rr > tol2 && it < maxiter && (!MINRES || stall < stall_max)) {
    // Ap = Hp p: one warp per row, p from shared memory
    for (int j = threadIdx.x; j < n; j += THREADS) ps[j] = __ldcg(p + j);
    __syncthreads();
    T pap = T(0);
    for (int i = gwarp; i < n; i += nwarps) {
      const T* row = H + (size_t)i * n;
      T acc = T(0);
#pragma unroll 4
      for (int j = lane; j < n; j += 32) acc += __ldg(row + j) * ps[j];
      acc = warp_sum(acc);
      if (lane == 0) {
        __stcg(Ap + i, acc);
        pap += ps[i] * acc;
      }
    }
    s = block_sum(pap, red);
    if (threadIdx.x == 0) __stcg(part_a + blockIdx.x, s);
    grid.sync();

    T pAp = grid_sum(part_a, G, red);
    pAp = pAp != T(0) ? pAp : T(1);
    const T alpha = rr / pAp;
    loc = T(0);
    for (int i = tid; i < n; i += nthreads) {
      x[i] += alpha * __ldcg(p + i);
      const T ri = r[i] - alpha * __ldcg(Ap + i);
      r[i] = ri;
      loc += ri * ri;
    }
    s = block_sum(loc, red);
    if (threadIdx.x == 0) __stcg(part_b + blockIdx.x, s);
    grid.sync();

    const T rr_n = grid_sum(part_b, G, red);
    const T beta = rr_n / (rr != T(0) ? rr : T(1));
    const bool improved = MINRES && rr_n < best;
    for (int i = tid; i < n; i += nthreads) {
      __stcg(p + i, r[i] + beta * __ldcg(p + i));
      if (improved) x_out[i] = x[i];
    }
    if (improved) {
      best = rr_n;
      stall = 0;
    } else {
      ++stall;
    }
    rr = rr_n;
    ++it;
    grid.sync();
  }
  if (!MINRES) {
    for (int i = tid; i < n; i += nthreads) x_out[i] = x[i];
  }
  if (tid == 0) *it_out = it;
}

template <typename T, bool MINRES>
int launch(const T* H, const T* b, const T* tol2, T* x, int* it, T* scratch,
           int n, int maxiter, int stall_max, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  auto kern = cg_kernel<T, MINRES>;
  const size_t smem = (size_t)n * sizeof(T);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int G = (n + WARPS - 1) / WARPS;
  if (G > sms) G = sms;  // every block co-resident, at most one per SM
  if (G > MAX_BLOCKS) G = MAX_BLOCKS;
  void* args[] = {(void*)&H, (void*)&b, (void*)&tol2, (void*)&x, (void*)&it,
                  (void*)&scratch, (void*)&n, (void*)&maxiter, (void*)&stall_max};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(G), dim3(THREADS),
                                    args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Scratch length (elements) the wrapper allocates for a system of size n.
extern "C" int lt_cg_scratch_len(int n) { return 4 * n + 2 * MAX_BLOCKS; }

// B3. H: [n, n] f64 SPD (row-major), b: [n], tol2: device scalar;
// x: [n] output (minimum-residual iterate), it: device int32 output.
// Returns a cudaError_t (0 = success).
extern "C" int lt_cg_minres_f64(const double* H, const double* b,
                                const double* tol2, double* x, int* it,
                                double* scratch, int n, int maxiter,
                                int stall_max, void* stream) {
  return launch<double, true>(H, b, tol2, x, it, scratch, n, maxiter,
                              stall_max, stream);
}

// B4. Same layout in f32, last iterate, no stall exit.
extern "C" int lt_cg_f32(const float* H, const float* b, const float* tol2,
                         float* x, int* it, float* scratch, int n, int maxiter,
                         void* stream) {
  return launch<float, false>(H, b, tol2, x, it, scratch, n, maxiter, 0,
                              stream);
}
