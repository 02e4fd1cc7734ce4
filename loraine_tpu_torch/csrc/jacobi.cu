// Batched f32 parallel cyclic Jacobi for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see loraine_tpu_torch/ops/jacobi.py).
//
// Replaces the two Pallas TPU kernels of loraine_tpu/ops/jacobi_pallas.py:
//   B1 lt_jacobi_eigh_f32   <- jacobi_pallas.py::_kernel
//      (eigh_pallas_f32: eigenvalues + transposed eigenvectors)
//   B2 lt_jacobi_bounds_f32 <- jacobi_pallas.py::_kernel_eigmin
//      (eig_bounds_pallas: per-row Gershgorin bounds of the rotated matrix)
//
// What it computes. The wrapper hands in [nb, mp, mp] f32 matrices, already
// normalized to spectral radius <= 1 and padded with a decoupled sentinel
// diagonal. Every round applies mp/2 disjoint Givens rotations J^T A J in the
// order of the Pallas round-robin tournament: the host table `pairs`
// ([mp-1, 2, mp/2] int32) lists, per round, the original indices (p, q) that
// the Pallas kernel holds at positions (i, i + mp/2). P^(mp-1) = I, so one
// table serves every sweep. p is the top position's row, so tau, the active
// test and the rotation signs are those of the Pallas kernel, and each 2x2
// block is rotated rows first, then columns, as there.
//
// What bounds it on this card. A round is a tiny amount of arithmetic
// (~6 flops per matrix element) behind a dependency on the previous round, and
// a call runs sweeps * (mp - 1) rounds: 7,990 for B1 at mp = 800 (10 sweeps),
// 3,196 for B2 (4 sweeps); each round waits for the previous one. At
// mp = 800 one f32 matrix is 2.56 MB, far above the 227 KB of shared memory a
// block may use, so the TPU design (the whole batch resident in VMEM) has no
// counterpart. The matrices (A ping-pong buffers plus the eigenvector rows,
// ~7.7 MB a matrix) stay in device memory and are served from the 50 MB L2.
// The cost is then one launch per round plus the gathered, uncoalesced reads
// that the label order implies.
//
// What the design does about it. Each round is spread over the whole card:
// a thread owns one 2x2 block A[{p,q},{r,s}] (and, for B1, one column of the
// eigenvector row pair). A block of 256 threads covers a 16 x 16 tile of
// pair blocks and recomputes the 16 + 16 rotation angles it needs from the
// previous A buffer, so a round needs no separate angle pass and no
// cross-block communication beyond the round boundary. Each round is one
// launch; the host loop enqueues all of them in one call. (A persistent
// cooperative launch with a grid barrier per round was measured slower at
// mp = 800 on an H100: 62.9 vs 53.1 ms for B1, see PERF.md.)
//
// Every literal is f32 (1e-9f, 1e-3f): a double literal would promote the
// rotation math. c = 1/sqrtf(1 + t^2) uses the correctly rounded sqrt and
// division, as the plain version does (rsqrtf is approximate, and its error
// accumulates over 7,990 rounds). nvcc contracts mul+add to FMA here, so results differ from
// the plain PyTorch version at f32 rounding; the contracts are seed quality
// and bound validity, not bit equality.

#include <cuda_runtime.h>

namespace {

constexpr int TP = 16;        // pairs per tile edge
constexpr int NT = TP * TP;   // threads per block

// Givens angle zeroing A[p, q] (stable tan formula, jacobi_pallas.py:151-162).
// Inactive pairs (including every pad coupling, which is exactly 0) get the
// identity rotation.
__device__ __forceinline__ void rotation(float app, float apq, float aqq,
                                         float& c, float& s) {
  const bool active = fabsf(apq) > 1e-9f * (fabsf(app) + fabsf(aqq) + 1e-3f);
  const float apq_safe = active ? apq : 1.0f;
  const float tau = (aqq - app) / (2.0f * apq_safe);
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  t = active ? t : 0.0f;
  c = 1.0f / sqrtf(1.0f + t * t);  // correctly rounded, unlike rsqrtf
  s = t * c;
}

// One tile of one round for one matrix. Tiles [0, tiles_p^2) are A tiles
// (16 row pairs x 16 column pairs); the rest (B1 only) are eigenvector tiles
// (16 row pairs x 16 columns of VT, updated in place: each element is owned
// by one thread per round). One block runs one tile.
__device__ void round_tile(int tile, const float* src, float* dst, float* vt,
                           const int* pq, int mp, int tiles_p, int tiles_vc) {
  __shared__ float sc[2][TP];
  __shared__ float ss[2][TP];
  const int half = mp / 2;
  const int tx = threadIdx.x % TP;
  const int ty = threadIdx.x / TP;
  const int* P = pq;
  const int* Q = pq + half;
  const int tiles_a = tiles_p * tiles_p;
  const bool is_a = tile < tiles_a;
  int ti, tj;
  if (is_a) {
    ti = tile / tiles_p;
    tj = tile % tiles_p;
  } else {
    ti = (tile - tiles_a) / tiles_vc;
    tj = (tile - tiles_a) % tiles_vc;
  }
  if (ty < 2) {
    // ty == 0: angles of the tile's row pairs; ty == 1: of its column pairs
    const int k = (ty == 0 ? ti : tj) * TP + tx;
    float c = 1.0f, s = 0.0f;
    if ((ty == 0 || is_a) && k < half) {
      const int p = P[k], q = Q[k];
      rotation(src[p * mp + p], src[p * mp + q], src[q * mp + q], c, s);
    }
    sc[ty][tx] = c;
    ss[ty][tx] = s;
  }
  __syncthreads();
  const int i = ti * TP + ty;
  if (is_a) {
    const int j = tj * TP + tx;
    if (i < half && j < half) {
      const int p = P[i], q = Q[i], r = P[j], s = Q[j];
      const float ci = sc[0][ty], si = ss[0][ty];
      const float cj = sc[1][tx], sj = ss[1][tx];
      const float a_pr = src[p * mp + r], a_ps = src[p * mp + s];
      const float a_qr = src[q * mp + r], a_qs = src[q * mp + s];
      // rows first: B = J_pq^T A
      const float b_pr = ci * a_pr - si * a_qr;
      const float b_qr = si * a_pr + ci * a_qr;
      const float b_ps = ci * a_ps - si * a_qs;
      const float b_qs = si * a_ps + ci * a_qs;
      // then columns: B J_rs
      dst[p * mp + r] = cj * b_pr - sj * b_ps;
      dst[p * mp + s] = sj * b_pr + cj * b_ps;
      dst[q * mp + r] = cj * b_qr - sj * b_qs;
      dst[q * mp + s] = sj * b_qr + cj * b_qs;
    }
  } else {
    const int k = tj * TP + tx;
    if (i < half && k < mp) {
      const int p = P[i], q = Q[i];
      const float c = sc[0][ty], s = ss[0][ty];
      const float vp = vt[p * mp + k], vq = vt[q * mp + k];
      vt[p * mp + k] = c * vp - s * vq;
      vt[q * mp + k] = s * vp + c * vq;
    }
  }
}

__global__ void __launch_bounds__(NT)
round_kernel(const float* src, float* dst, float* vt, const int* pq, int mp,
             int tiles_p, int tiles_vc) {
  const size_t off = (size_t)blockIdx.y * mp * mp;
  round_tile(blockIdx.x, src + off, dst + off, vt ? vt + off : nullptr, pq, mp,
             tiles_p, tiles_vc);
}

__global__ void identity_kernel(float* vt, int mp, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) {
    const int k = idx % (mp * mp);
    vt[idx] = (k / mp == k % mp) ? 1.0f : 0.0f;
  }
}

__global__ void diag_kernel(const float* a, float* lam, int mp, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) {
    const int b = idx / mp, i = idx % mp;
    lam[idx] = a[(size_t)b * mp * mp + (size_t)i * mp + i];
  }
}

// Per-row Gershgorin bounds of the rotated matrix (jacobi_pallas.py:241-247):
// g_i = a_ii - sum_{j != i} |a_ij|, h_i = a_ii + sum_{j != i} |a_ij|.
// One block of 128 threads per (row, matrix).
__global__ void __launch_bounds__(128)
gersh_kernel(const float* a, float* g, float* h, int mp) {
  const int i = blockIdx.x, b = blockIdx.y;
  const float* row = a + (size_t)b * mp * mp + (size_t)i * mp;
  float sum = 0.0f;
  for (int j = threadIdx.x; j < mp; j += blockDim.x) sum += fabsf(row[j]);
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
  __shared__ float part[4];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    const float d = row[i];
    const float off = ((part[0] + part[1]) + (part[2] + part[3])) - fabsf(d);
    g[b * mp + i] = d - off;
    h[b * mp + i] = d + off;
  }
}

// Enqueues all rounds; *out is the buffer that then holds the final A.
cudaError_t run_rounds(float* a0, float* a1, float* vt, const int* pairs,
                       int nb, int mp, int nrounds, cudaStream_t stream,
                       float** out) {
  const int half = mp / 2;
  const int tiles_p = (half + TP - 1) / TP;
  const int tiles_vc = (mp + TP - 1) / TP;
  const dim3 grid(tiles_p * tiles_p + (vt ? tiles_p * tiles_vc : 0), nb);
  *out = (nrounds & 1) ? a1 : a0;
  for (int r = 0; r < nrounds; ++r) {
    const float* src = (r & 1) ? a1 : a0;
    float* dst = (r & 1) ? a0 : a1;
    round_kernel<<<grid, NT, 0, stream>>>(
        src, dst, vt, pairs + (size_t)(r % (mp - 1)) * mp, mp, tiles_p,
        tiles_vc);
    if (r == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaGetLastError();
}

}  // namespace

// B1. a: [nb, mp, mp] input, overwritten; a2, vt: [nb, mp, mp] scratch and
// output (vt = eigenvectors as rows); lam: [nb, mp] output (unsorted, label
// order). Returns a cudaError_t (0 = success).
extern "C" int lt_jacobi_eigh_f32(float* a, float* a2, float* vt, float* lam,
                                  const int* pairs, int nb, int mp,
                                  int nrounds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = nb * mp * mp;
  identity_kernel<<<(total + 255) / 256, 256, 0, st>>>(vt, mp, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* fin = nullptr;
  err = run_rounds(a, a2, vt, pairs, nb, mp, nrounds, st, &fin);
  if (err != cudaSuccess) return err;
  diag_kernel<<<(nb * mp + 255) / 256, 256, 0, st>>>(fin, lam, mp, nb * mp);
  return cudaGetLastError();
}

// B2. a: [nb, mp, mp] input, overwritten; a2 scratch; g, h: [nb, mp] output
// per-row lower/upper Gershgorin bounds of the rotated matrix.
extern "C" int lt_jacobi_bounds_f32(float* a, float* a2, float* g, float* h,
                                    const int* pairs, int nb, int mp,
                                    int nrounds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fin = nullptr;
  cudaError_t err =
      run_rounds(a, a2, nullptr, pairs, nb, mp, nrounds, st, &fin);
  if (err != cudaSuccess) return err;
  gersh_kernel<<<dim3(mp, nb), 128, 0, st>>>(fin, g, h, mp);
  return cudaGetLastError();
}
