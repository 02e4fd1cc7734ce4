// Single-launch conjugate gradients for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see loraine_tpu_torch/ops/pcg.py).
//
// Replaces the two Pallas TPU kernels of loraine_tpu/ops/pcg_pallas.py and
// the f64 polish that loraine_tpu/ipm/step.py:820-835 runs after the first:
//   B3     lt_cg_minres_f64 <- pcg_pallas.py::_kernel_ff
//          (pcg_pallas_ff: CG on Hp = Mli H Mli^T, minimum-residual iterate,
//          stall exit after np/2 + 64 non-improving iterations)
//   B4     lt_cg_f32        <- pcg_pallas.py::_kernel
//          (pcg_pallas_mixed: plain f32 CG)
//   polish lt_cg_f64        <- the f64 last-iterate CG of the kit=1 kernel
//          route (a device while-loop under jit in the JAX package)
//
// What it computes. One whole CG solve per launch, with no host round trip
// inside the loop: x0 = 0, r = p = b, alpha = rr / pAp and beta = rr' / rr
// with the where(den != 0, den, 1) guards, stop when rr <= tol2 or
// it >= maxiter (B3 also when the stall counter reaches stall_max). B3
// returns the iterate of least ||r||^2 (strict < improvement), B4 and the
// polish the last. tol2 is read from device memory and the iteration count
// written there, so the wrappers need no host sync. B3's body is native
// f64: the TPU kernel carries every value as an unevaluated sum of two f32
// words (~2^-47) only because the TPU has no f64 unit; an f64 Hp takes the
// same bytes as the hi/lo pair and is at least as precise. Vectors are plain
// [n] arrays (the TPU's equal-lane [np, 128] tiles and identity-matmul
// transposes have no purpose here), and no padding is needed.
//
// What bounds it on this card. A CG iteration is one n x n matvec and two
// dot products, each a dependency of the next step: 2 n^2 flops against
// n^2 words of Hp. The TPU kernel keeps Hp in VMEM for the whole solve. At
// these sizes the arithmetic is well under a microsecond an iteration; what
// bounds an iteration is where Hp lives and how the three dependencies
// (matvec -> pAp -> r, rr -> p -> next matvec) are synchronised. One template
// (type T, MINRES) serves all three functions, in a regime chosen by the
// shape alone (ops/pcg.py::regime_for_cg, which mirrors the byte counts
// below); every regime runs one launch per solve:
//
// (a) "block": one block of 256 threads, Hp in its shared memory at an odd
//     row stride, for n up to what one block holds (n (n | 1) + n + 16
//     words <= 232,448 bytes: f64 n <= 169, f32 n <= 240), taken below
//     n = 128 (ops/pcg.py::CLUSTER_FROM): control1 (21), tru3/vib3 (36),
//     theta1 (104). Hp is loaded from device memory once per call; every
//     iteration then synchronises with three __syncthreads() and nothing
//     else. Thread t owns row t: it walks the row with p[j] broadcast from
//     shared memory (the odd stride puts a warp's 32 rows in 32 banks) and
//     keeps x[t], r[t], p[t] (and B3's best x[t]) in registers. Bound by
//     each thread's chain of n shared-memory loads and the barriers: ~0.4 us
//     an iteration fixed and ~0.014 us a row in f64 (PERF.md section 6).
//
// (b) "cluster": one thread block cluster of C blocks (C = 8 or 16, the
//     latter a non-portable size), Hp's rows spread over their shared
//     memory, for n beyond (a) while ceil(n/C) rows of Hp, whole p and r and
//     the partial slots fit a block (C = 16: f64 n <= 656, f32 n <= 944):
//     theta_G100 (464) and everything cg_materialize='auto' sends (n <= 512).
//     Block b owns rows [b n / C, (b+1) n / C) of Hp (loaded once) and the
//     same entries of x and r; every block keeps a whole copy of p and of r.
//     One CG iteration is two exchanges, each waited for on the receiver's
//     own mbarrier, and no grid barrier or cluster.sync():
//       1. each block multiplies its rows by its p, forms its partial pAp
//          and stores it into slot b of every block's shared memory with
//          st.async, which counts its bytes on that block's barrier 1. Each
//          block waits until its barrier 1 has all C partials.
//       2. each block sums the C partials in block order, so all blocks hold
//          bitwise-equal alpha; updates its x and r entries; stores its r
//          entries and its partial rr into every block the same way,
//          counted on barrier 2, and waits until its barrier 2 has all n + C
//          values.
//       3. each block sums rr' in block order, computes beta and the whole
//          p = r + beta p from the whole r (n flops, the same operations in
//          every block, so every copy of p is the same), and takes the
//          min-residual and stall decisions, which are the same everywhere,
//          so all blocks leave the loop at the same iteration.
//     Thread 0 arms both barriers (one arrival, expect_tx of the bytes) at
//     the top of each iteration; a peer's bytes may land before that, which
//     the barrier's transaction count allows. No buffer needs a second copy,
//     and no phase of a barrier can take another iteration's bytes: a peer
//     sends exchange 1 of k+1 only after its own exchange 2 of k completed,
//     which needs this block's exchange-2 stores of k, issued after this
//     block read every pAp slot of k (alpha, then a __syncthreads()); it
//     sends exchange 2 of k+1 only after its exchange 1 of k+1 completed,
//     which needs this block's pAp of k+1, issued after the __syncthreads()
//     that ends iteration k, so after every read of the r copy and the rr
//     slots of k. The same chains order each barrier's phases. The call
//     ends with one cluster.sync(), so that no block exits while a peer
//     could still address its shared memory (none does after the last
//     exchange 2; the closing barrier keeps that true under any later
//     change of the loop). cudaOccupancyMaxActiveClusters is queried before
//     the launch; if no such cluster can be resident the call fails (-1)
//     and the wrapper raises. A wait that lasts 20 s traps, so that a fault
//     ends the launch instead of hanging the card. Bound by the two
//     exchanges an iteration (~1.6 us fixed with 16 blocks on an H100) and
//     each block's matvec over its rows (PERF.md section 6).
//
// (c) "grid": beyond (b) (f64 n from 657 to 1024 with
//     cg_materialize='always'), the cooperative kernel of the first port,
//     unchanged: G = min(ceil(n/8), SMs) blocks of 256 threads, Hp read from
//     L2 every iteration, three grid.sync() an iteration. Each warp owns
//     rows of the matvec (Hp row read coalesced, p staged in shared memory);
//     each thread owns entries of x, r, p for the updates. Cross-block sums go
//     through per-block partials that EVERY block reduces itself in the same
//     fixed order, so all blocks hold bitwise-equal scalars and take the same
//     branch (a divergent exit would deadlock the next grid.sync()). Partials
//     alternate between two buffers so that a block never overwrites one
//     another block may still be reading. Values written by another block are
//     read with __ldcg (L2, not a possibly stale L1 line).
//
// Times on the card: PERF.md section 6 (chip_smoke.py phase 6 times every
// regime that fits at each n).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;      // (c): threads per block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 1024;  // (c): scratch holds 2 * MAX_BLOCKS partials
constexpr int NTB = 256;          // (a): threads per block, one per row of Hp
constexpr int NWB = NTB / 32;
constexpr int NT = 512;           // (b): threads per block
constexpr int NW = NT / 32;
constexpr int CMAX = 16;          // (b): most blocks in a cluster
constexpr int RB = 2;             // (b): matvec rows a warp reduces at once
constexpr unsigned long long WAIT_NS = 20000000000ull;  // (b): 20 s, then trap
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int ERR_NO_CLUSTER = -1;  // no cluster of this shape can be resident
constexpr int ERR_SHAPE = -2;       // the shape does not fit the regime

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the sum
}

// Butterfly sum: every lane ends with the same bits (each step adds the
// same two values, and IEEE addition commutes).
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[0] + ... + s[k-1] (k <= 16) as one fixed pairwise tree: the same bits
// in every thread and every block that asks. (Every loop has a constant
// trip count, so v stays in registers.)
template <typename T>
__device__ __forceinline__ T sum_tree(const T* s, int k) {
  T v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = i < k ? s[i] : T(0);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] += v[i + 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] += v[i + 4];
  return (v[0] + v[2]) + (v[1] + v[3]);
}

template <typename T>
__device__ __forceinline__ T nonzero(T v) {
  return v != T(0) ? v : T(1);
}

// ---- (a) "block" ------------------------------------------------------------

// Hp's row stride in shared memory: odd, so that the 32 threads of a warp,
// one row each, read 32 different banks.
__host__ __device__ inline int block_ld(int n) { return n | 1; }

template <typename T>
size_t block_bytes(int n) {
  return sizeof(T) * ((size_t)n * block_ld(n) + (size_t)n + 2 * NWB);
}

template <typename T, bool MINRES>
__global__ void __launch_bounds__(NTB)
cg_block_kernel(const T* __restrict__ H, const T* __restrict__ b,
                const T* __restrict__ tol2p, T* __restrict__ x_out,
                int* __restrict__ it_out, int n, int maxiter, int stall_max) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = block_ld(n);
  T* Hs = reinterpret_cast<T*>(smem_raw);  // [n, ld] Hp
  T* ps = Hs + (size_t)n * ld;             // [n] p
  T* red = ps + n;                         // [2, NWB] warp partials of pAp, rr
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool own = t < n;  // thread t keeps row t: (Hp p)[t], x[t], r[t], p[t]
  for (int k = t; k < n * n; k += NTB) {
    const int i = k / n;
    Hs[(size_t)i * ld + (k - i * n)] = __ldg(H + k);
  }
  const T tol2 = *tol2p;
  T ri = own ? b[t] : T(0);
  T pi = ri, xi = T(0), bx = T(0);
  if (own) ps[t] = pi;
  T v = warp_allsum(ri * ri);
  if (lane == 0) red[NWB + w] = v;
  __syncthreads();
  T rr = sum_tree(red + NWB, NWB);
  T best = rr;
  int stall = 0, it = 0;
  const T* row = Hs + (size_t)(own ? t : 0) * ld;

  while (rr > tol2 && it < maxiter && (!MINRES || stall < stall_max)) {
    // (Hp p)[t]: thread t walks its row, p[j] broadcast to the warp
    T ap = T(0);
    if (own) {
      T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
      int j = 0;
      for (; j + 3 < n; j += 4) {
        a0 += row[j] * ps[j];
        a1 += row[j + 1] * ps[j + 1];
        a2 += row[j + 2] * ps[j + 2];
        a3 += row[j + 3] * ps[j + 3];
      }
      for (; j < n; ++j) a0 += row[j] * ps[j];
      ap = (a0 + a1) + (a2 + a3);
    }
    v = warp_allsum(pi * ap);
    if (lane == 0) red[w] = v;
    __syncthreads();  // the pAp partials

    const T alpha = rr / nonzero(sum_tree(red, NWB));
    xi += alpha * pi;
    ri -= alpha * ap;
    v = warp_allsum(ri * ri);
    if (lane == 0) red[NWB + w] = v;
    __syncthreads();  // the rr partials, and every read of p is done

    const T rr_n = sum_tree(red + NWB, NWB);
    const T beta = rr_n / nonzero(rr);
    pi = ri + beta * pi;
    if (own) ps[t] = pi;
    if (MINRES) {
      if (rr_n < best) {
        best = rr_n;
        bx = xi;
        stall = 0;
      } else {
        ++stall;
      }
    }
    rr = rr_n;
    ++it;
    __syncthreads();  // p whole before the next matvec
  }
  if (own) x_out[t] = MINRES ? bx : xi;
  if (t == 0) *it_out = it;
}

// ---- (b) "cluster" ----------------------------------------------------------

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// The one arrival of the barrier's current phase, which then completes
// once `bytes` have landed.
__device__ __forceinline__ void mbar_arm(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete; traps after
// WAIT_NS, so that a fault ends the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  const unsigned long long t0 = now_ns();
  for (unsigned k = 1;; ++k) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((k & 255) == 0 && now_ns() - t0 > WAIT_NS) __trap();
  }
}

// Stores v into the shared memory of block `rank` of the cluster, at the
// place of `dst` there, and counts its bytes on that block's `bar`.
template <typename T>
__device__ __forceinline__ void st_remote(T* dst, unsigned rank, T v, unsigned long long* bar) {
  unsigned ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  if constexpr (sizeof(T) == 8) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
                 ::"r"(ra), "l"(__double_as_longlong(v)), "r"(rb)
                 : "memory");
  } else {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                 ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb)
                 : "memory");
  }
}

template <typename T>
size_t cluster_bytes(int n, int C) {
  const size_t rmax = (n + C - 1) / C;
  return 16 + sizeof(T) * (rmax * n + 2 * (size_t)n + 2 * rmax + 2 * CMAX + 2 * NW);
}

template <typename T, bool MINRES>
__global__ void __launch_bounds__(NT)
cg_cluster_kernel(const T* __restrict__ H, const T* __restrict__ b,
                  const T* __restrict__ tol2p, T* __restrict__ x_out,
                  int* __restrict__ it_out, int n, int maxiter, int stall_max,
                  int C) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cb = (int)cluster.block_rank();
  const int lo = cb * n / C, rows = (cb + 1) * n / C - lo;
  const int rmax = (n + C - 1) / C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [2] exchange 1 (pAp partials) and 2 (rr partials and r) have landed
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw);
  T* Hs = reinterpret_cast<T*>(smem_raw + 16);  // [rmax, n] rows lo.. of Hp
  T* ps = Hs + (size_t)rmax * n;                // [n] p, whole
  T* rs = ps + n;                               // [n] r, whole, from the owners
  T* Aps = rs + n;                              // [rmax] Hp p on the own rows
  T* rown = Aps + rmax;                         // [rmax] the own r, to send
  T* slot = rown + rmax;                        // [2, CMAX] the blocks' pAp, rr
  T* red = slot + 2 * CMAX;                     // [2, NW] warp partials
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool own = t < rows;  // thread t keeps x and r of row lo + t
  for (int k = t; k < rows * n; k += NT) Hs[k] = __ldg(H + (size_t)lo * n + k);
  const T tol2 = *tol2p;
  // every block forms p = b and b.b whole, with the same operations
  T v = T(0);
  for (int j = t; j < n; j += NT) {
    const T bj = b[j];
    ps[j] = bj;
    v += bj * bj;
  }
  v = warp_allsum(v);
  if (lane == 0) red[NW + w] = v;
  T ri = own ? b[lo + t] : T(0);
  T xi = T(0), bx = T(0);
  if (t == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // the barriers are set, and every block runs
  T rr = sum_tree(red + NW, NW);
  T best = rr;
  int stall = 0, it = 0;
  const unsigned bytes1 = C * sizeof(T), bytes2 = (C + n) * sizeof(T);

  while (rr > tol2 && it < maxiter && (!MINRES || stall < stall_max)) {
    const unsigned parity = it & 1;
    if (t == 0) {
      mbar_arm(bar, bytes1);
      mbar_arm(bar + 1, bytes2);
    }
    // 1. Ap = Hp p on the own rows: warp w takes rows w, w + NW, ..., RB
    //    of them at a time, p from shared memory
    T pap = T(0);
    for (int i0 = w; i0 < rows; i0 += NW * RB) {
      T acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = T(0);
      for (int j = lane; j < n; j += 32) {
        const T pj = ps[j];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int i = i0 + NW * r;
          if (i < rows) acc[r] += Hs[(size_t)i * n + j] * pj;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int i = i0 + NW * r;
          if (i < rows) {
            Aps[i] = acc[r];
            pap += ps[lo + i] * acc[r];
          }
        }
      }
    }
    if (lane == 0) red[w] = pap;
    __syncthreads();
    // every block's partial pAp into slot cb of every block
    if (t < C) st_remote(slot + cb, t, sum_tree(red, NW), bar);
    mbar_wait(bar, parity);

    // 2. alpha from the C partials (the same tree in every block); x, r on
    //    the own rows, sent with the partial rr to every block
    const T alpha = rr / nonzero(sum_tree(slot, C));
    if (own) {
      xi += alpha * ps[lo + t];
      ri -= alpha * Aps[t];
      rown[t] = ri;
    }
    v = warp_allsum(ri * ri);
    if (lane == 0) red[NW + w] = v;
    __syncthreads();
    if (t < C) st_remote(slot + CMAX + cb, t, sum_tree(red + NW, NW), bar + 1);
    for (int k = t; k < rows * C; k += NT) {
      const int i = k % rows, q = k / rows;
      st_remote(rs + lo + i, q, rown[i], bar + 1);
    }
    mbar_wait(bar + 1, parity);

    // 3. beta from the C partials; the whole p, the same in every block
    const T rr_n = sum_tree(slot + CMAX, C);
    const T beta = rr_n / nonzero(rr);
    for (int j = t; j < n; j += NT) ps[j] = rs[j] + beta * ps[j];
    if (MINRES) {
      if (rr_n < best) {
        best = rr_n;
        bx = xi;
        stall = 0;
      } else {
        ++stall;
      }
    }
    rr = rr_n;
    ++it;
    __syncthreads();  // p whole before the next matvec
  }
  if (own) x_out[lo + t] = MINRES ? bx : xi;
  if (cb == 0 && t == 0) *it_out = it;
  cluster.sync();  // no block leaves while a peer may address its memory
}

// ---- (c) "grid" -------------------------------------------------------------

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

// ---- launchers --------------------------------------------------------------

template <typename T, bool MINRES>
int launch_block(const T* H, const T* b, const T* tol2, T* x, int* it, int n,
                 int maxiter, int stall_max, cudaStream_t st) {
  const size_t bytes = block_bytes<T>(n);
  if (bytes > SMEM_MAX || n > NTB) return ERR_SHAPE;
  auto kern = cg_block_kernel<T, MINRES>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<1, NTB, bytes, st>>>(H, b, tol2, x, it, n, maxiter, stall_max);
  return cudaGetLastError();
}

template <typename T, bool MINRES>
int launch_cluster(const T* H, const T* b, const T* tol2, T* x, int* it, int n,
                   int maxiter, int stall_max, int C, cudaStream_t st) {
  if (C < 1 || C > CMAX) return ERR_SHAPE;
  const size_t bytes = cluster_bytes<T>(n, C);
  if (bytes > SMEM_MAX || (n + C - 1) / C > NT) return ERR_SHAPE;
  auto kern = cg_cluster_kernel<T, MINRES>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return ERR_NO_CLUSTER;
  err = cudaLaunchKernelEx(&cfg, kern, H, b, tol2, x, it, n, maxiter, stall_max, C);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool MINRES>
int launch_grid(const T* H, const T* b, const T* tol2, T* x, int* it, T* scratch,
                int n, int maxiter, int stall_max, cudaStream_t st) {
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
                                    args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Regime codes: 0 = (c) "grid", 1 = (a) "block", 2 = (b) "cluster" of C
// blocks. Returns a cudaError_t (0 = success), ERR_NO_CLUSTER or ERR_SHAPE.
template <typename T, bool MINRES>
int run(const T* H, const T* b, const T* tol2, T* x, int* it, T* scratch, int n,
        int maxiter, int stall_max, int regime, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1) return cudaErrorInvalidValue;
  if (regime == 1) return launch_block<T, MINRES>(H, b, tol2, x, it, n, maxiter, stall_max, st);
  if (regime == 2)
    return launch_cluster<T, MINRES>(H, b, tol2, x, it, n, maxiter, stall_max, C, st);
  if (regime == 0 && scratch != nullptr)
    return launch_grid<T, MINRES>(H, b, tol2, x, it, scratch, n, maxiter, stall_max, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Scratch length (elements) regime (c) needs for a system of size n; the
// other regimes take none.
extern "C" int lt_cg_scratch_len(int n) { return 4 * n + 2 * MAX_BLOCKS; }

// B3. H: [n, n] f64 SPD (row-major), b: [n], tol2: device scalar;
// x: [n] output (minimum-residual iterate), it: device int32 output;
// scratch: lt_cg_scratch_len(n) elements in regime 0, else unused.
extern "C" int lt_cg_minres_f64(const double* H, const double* b,
                                const double* tol2, double* x, int* it,
                                double* scratch, int n, int maxiter,
                                int stall_max, int regime, int C, void* stream) {
  return run<double, true>(H, b, tol2, x, it, scratch, n, maxiter, stall_max,
                           regime, C, stream);
}

// B4. Same layout in f32, last iterate, no stall exit.
extern "C" int lt_cg_f32(const float* H, const float* b, const float* tol2,
                         float* x, int* it, float* scratch, int n, int maxiter,
                         int regime, int C, void* stream) {
  return run<float, false>(H, b, tol2, x, it, scratch, n, maxiter, 0, regime, C,
                           stream);
}

// The polish. Same layout in f64, last iterate, no stall exit.
extern "C" int lt_cg_f64(const double* H, const double* b, const double* tol2,
                         double* x, int* it, double* scratch, int n, int maxiter,
                         int regime, int C, void* stream) {
  return run<double, false>(H, b, tol2, x, it, scratch, n, maxiter, 0, regime, C,
                            stream);
}
