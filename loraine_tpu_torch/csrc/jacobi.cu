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
// order of the Pallas round-robin tournament: position k of the tournament
// (0 <= k < mp) holds an original index (label), and the pairs of a round
// are the labels at positions (k, k + mp/2). p is the top position's label,
// so tau, the active test and the rotation signs are those of the Pallas
// kernel, and each 2x2 block is rotated rows first, then columns, as there.
// The matrix stays in label order; only the position -> label table moves,
// by the recurrence of ops/jacobi.py::pair_table (label_src below).
//
// What bounds it on this card. A call runs sweeps * (mp - 1) rounds, each
// ~6 flops per element of A (and 3 per element of the eigenvector rows),
// each waiting for the previous one: 7,990 rounds for B1 at mp = 800, 3,196
// for B2. The arithmetic is far below the card's f32 rate (0.7 ms for B1 at
// mp = 800); what costs is moving the matrix through memory every round and
// the round-to-round dependency. The TPU kernel keeps the whole matrix in
// VMEM for the call; a Hopper SM has 227 KB of shared memory, a cluster of
// 16 SMs ~3.6 MB. The regime is chosen by the shape (nb, mp) alone
// (ops/jacobi.py::regime_for, which mirrors the byte counts below): "sm"
// where it fits and is the faster (B1 below mp 144, B2 below 192, or more
// matrices than one wave of clusters holds), else "cluster" where it fits,
// else "rounds":
//
// (a) "sm": one block per matrix, the matrix (and, for B1, the eigenvector
//     rows) in the block's shared memory for the whole call, one launch.
//     Fits while 4 mp (mp+1) + (B1) 4 mp^2 + 28 mp bytes <= 232,448: B1
//     mp <= 160, B2 mp <= 224. Bound by one SM's instruction issue and
//     shared-memory instructions (each round reads and writes every
//     element). A round: one lane per pair of the next round reads the three
//     2x2 blocks its angle needs; __syncthreads(); the other warps rotate A
//     in place (each 2x2 block, each eigenvector element, has one owner
//     thread per round) while those lanes compute the next angles and
//     16-byte row records (row offsets, c, s); __syncthreads(). A rotating
//     lane keeps one column pair for the round, in registers, and its warp
//     walks the row pairs, one broadcast record each: 4 loads and 4 stores
//     per 2x2 block. Eigenvector rows move two columns a thread. A's row
//     stride is mp + 1 against bank conflicts.
//
// (b) "cluster": one thread block cluster of 16 blocks per matrix (a
//     non-portable size), the matrix spread over their shared memory, one
//     launch; mp <= 912. Rows are owned by tournament position: block b
//     holds the rows at positions [lo_b, hi_b) and [mp/2 + lo_b, mp/2 + hi_b)
//     (pair_lo), so both rows of each of its pairs are local and every
//     rotation reads and writes local memory only; the in-place hazard of a
//     remote partner row does not arise. The tournament then moves one top
//     row from each block to the next and one bottom row back (pair_table's
//     permutation shifts position ranges by one). A round is: each block
//     reads the angles it does not own from their owners (remote loads, in
//     parallel) while one lane per own pair reads the three 2x2 blocks its
//     next-round angle needs; __syncthreads(); warps 1..31 rotate the local
//     rows while those lanes compute the next round's angles (the same
//     arithmetic as the blocks' owners, so the same bits); __syncthreads();
//     the two leaving rows go as float4 remote stores into the neighbours'
//     free row slots, and 12 "edge" values (the entries a neighbour needs
//     for the pair that takes an arriving row) to the neighbours; one
//     cluster barrier (and one after the last round, so that no block exits
//     while another still reads its angles). Angles, records, labels, slot tables and edge values
//     are double buffered by round. Bound, on an H100, by the cluster
//     barrier (~0.8 us with 16 x 1024 threads, most of it the release
//     fence) and by each SM's shared-memory instructions (its share of A,
//     read and written every round, ~170 KB at mp = 816).
//     B1's eigenvector rows (2.66 MB at mp = 816) do not fit beside A, but
//     their columns never mix: a second cluster of 16 blocks per matrix
//     holds them by column ranges, two columns a thread, and replays the
//     angles that the first cluster writes to a log in global memory, one
//     flagged entry per round and pair (put_angle below). The consumer only waits for the producer,
//     never the reverse, and the host launches at most as many
//     matrices at once as cudaOccupancyMaxActiveClusters lets be resident
//     (producers first in the grid); a consumer that waits 20 s traps, so a
//     fault ends the launch instead of hanging the card.
//
// (c) "rounds": beyond a cluster's capacity (mp > 912), one launch per
//     round over the whole card: a thread owns one 2x2 block
//     (and, for B1, one eigenvector column pair), a block of 256 threads a
//     16 x 16 tile of pair blocks, recomputing the angles it needs from the
//     previous A buffer; the host table `pairs` ([mp-1, 2, mp/2] int32)
//     gives each round's labels.
//
// Every regime applies the same per-element arithmetic (rotation, rot2x2,
// rot_pair) and sums the Gershgorin rows in the same order (gersh_row), so
// the three agree bit for bit. Each operation is a round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never
// contracts to FMA, in the plain version's order of operations: on the card
// B1's outputs equal the plain version's tensor ops bit for bit, and B2's
// differ only by the order of the Gershgorin row sums (torch's f32 sqrt on a
// CPU is not correctly rounded, so the CPU run differs at f32 rounding).
// rsqrtf would be approximate, and its error accumulates over 7,990 rounds.
// The contracts are seed quality and bound validity, not bit equality.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TP = 16;          // (c): pairs per tile edge
constexpr int NT = TP * TP;     // (c): threads per block
constexpr int NTR = 1024;       // (a), (b): threads per block
constexpr int NW = NTR / 32;    // (a), (b): warps per block
constexpr int CL = 16;          // (b): blocks per cluster
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int ERR_NO_CLUSTER = -1;  // no cluster of this shape can be resident
constexpr int ERR_SHAPE = -2;       // the shape does not fit the regime
constexpr int EDGE = 12;         // (b): edge values a block keeps per round
constexpr unsigned long long WAIT_NS = 20000000000ull;  // consumer timeout

// ---- shared arithmetic -----------------------------------------------------
// Every operation rounds once, as the plain version's tensor ops do on the
// card: the _rn intrinsics are never contracted to FMA.

// Givens angle zeroing A[p, q] (stable tan formula, jacobi_pallas.py:151-162,
// in the plain version's order of operations). Inactive pairs (including
// every pad coupling, which is exactly 0) get the identity rotation.
__device__ __forceinline__ void rotation(float app, float apq, float aqq,
                                         float& c, float& s) {
  const bool active =
      fabsf(apq) > __fmul_rn(1e-9f, __fadd_rn(__fadd_rn(fabsf(app), fabsf(aqq)), 1e-3f));
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), __fmul_rn(2.0f, active ? apq : 1.0f));
  float t = __fdiv_rn(1.0f, __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)))));
  t = active ? (tau >= 0.0f ? t : -t) : 0.0f;
  c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  s = __fmul_rn(t, c);
}

// The 2x2 block A[{p,q},{r,s}]: rows first (B = J_pq^T A), then columns
// (B J_rs), as the Pallas kernel.
__device__ __forceinline__ void rot2x2(float& pr, float& ps, float& qr,
                                       float& qs, float ci, float si, float cj,
                                       float sj) {
  const float b_pr = __fsub_rn(__fmul_rn(ci, pr), __fmul_rn(si, qr));
  const float b_qr = __fadd_rn(__fmul_rn(si, pr), __fmul_rn(ci, qr));
  const float b_ps = __fsub_rn(__fmul_rn(ci, ps), __fmul_rn(si, qs));
  const float b_qs = __fadd_rn(__fmul_rn(si, ps), __fmul_rn(ci, qs));
  pr = __fsub_rn(__fmul_rn(cj, b_pr), __fmul_rn(sj, b_ps));
  ps = __fadd_rn(__fmul_rn(sj, b_pr), __fmul_rn(cj, b_ps));
  qr = __fsub_rn(__fmul_rn(cj, b_qr), __fmul_rn(sj, b_qs));
  qs = __fadd_rn(__fmul_rn(sj, b_qr), __fmul_rn(cj, b_qs));
}

// One element pair of the eigenvector rows p, q.
__device__ __forceinline__ void rot_pair(float& vp, float& vq, float c, float s) {
  const float p = vp, q = vq;
  vp = __fsub_rn(__fmul_rn(c, p), __fmul_rn(s, q));
  vq = __fadd_rn(__fmul_rn(s, p), __fmul_rn(c, q));
}

// Per-row Gershgorin bounds (jacobi_pallas.py:241-247) by one warp:
// g_i = a_ii - sum_{j != i} |a_ij|, h_i = a_ii + sum_{j != i} |a_ij|, summed
// as 128 strided partial sums, a shuffle tree per 32 of them, then
// (s0 + s1) + (s2 + s3): the same order in every regime.
__device__ void gersh_row(const float* row, int i, int mp, float* g, float* h) {
  const int lane = threadIdx.x & 31;
  float part[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    float sum = 0.0f;
    for (int j = 32 * v + lane; j < mp; j += 128) sum += fabsf(row[j]);
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
    part[v] = sum;
  }
  if (lane == 0) {
    const float d = row[i];
    const float off = ((part[0] + part[1]) + (part[2] + part[3])) - fabsf(d);
    g[i] = d - off;
    h[i] = d + off;
  }
}

// ---- the tournament in shared memory ----------------------------------------
// pq[k] = p | q << 16: the labels at positions k and k + mp/2 (mp < 2^15).

__device__ __forceinline__ int pq_p(int v) { return v & 0xffff; }
__device__ __forceinline__ int pq_q(int v) { return (int)((unsigned)v >> 16); }

// Label at position x.
__device__ __forceinline__ int label_at(const int* pq, int x, int half) {
  return x < half ? pq_p(pq[x]) : pq_q(pq[x - half]);
}

// Position whose label position i holds after one more round: pair_table's
// permutation [L0 | R0 L1..L_{h-2}] / [R1..R_{h-1} | L_{h-1}].
__device__ __forceinline__ int label_src(int i, int half, int mp) {
  if (i == 0) return 0;
  if (i == 1) return half;
  if (i < half) return i - 1;
  if (i < mp - 1) return i + 1;
  return half - 1;
}

__device__ __forceinline__ void init_pairs(int* pq, int half) {
  for (int k = threadIdx.x; k < half; k += blockDim.x) pq[k] = k | (k + half) << 16;
}

// Label at position x after one more round.
__device__ __forceinline__ int next_label(const int* pq, int x, int half) {
  return label_at(pq, label_src(x, half, 2 * half), half);
}

// One pair's label word after one more round.
__device__ __forceinline__ int next_pair(const int* pq, int k, int half) {
  return next_label(pq, k, half) | next_label(pq, k + half, half) << 16;
}

// Rotates nrows row pairs of A in place, on warps w0..NW-1: rr[i] = (row
// offsets of the pair's top and bottom rows, c, s); the column pairs are
// pq/ang. A warp takes a chunk of 32 column pairs (one per lane: labels and
// angle in registers, on neighbouring labels, so on distinct banks) and
// walks its share of the row pairs; each row pair is one broadcast record.
__device__ void rotate_rows(float* A, const int4* rr, int nrows, const int* pq,
                            const float2* ang, int half, int w0) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0, nw = NW - w0;
  const int nc = (half + 31) / 32;
  if (warp < 0) return;
  const int chunk = warp % nc, g = warp / nc, ng = (nw - 1 - chunk) / nc + 1;
  const int j = chunk * 32 + lane;
  if (j >= half) return;
  const int v = pq[j], r = pq_p(v), s = pq_q(v);
  const float2 a = ang[j];
  auto one = [&](int i) {
    const int4 rec = rr[i];
    float* rp = A + rec.x;
    float* rq = A + rec.y;
    rot2x2(rp[r], rp[s], rq[r], rq[s], __int_as_float(rec.z), __int_as_float(rec.w), a.x, a.y);
  };
  int i = g;
  for (; i + ng < nrows; i += 2 * ng) {  // two row pairs in flight
    one(i);
    one(i + ng);
  }
  if (i < nrows) one(i);
}

// Rotates the eigenvector rows (2 npairs columns at an even stride ld) by
// every pair, on threads t0..NTR-1: a thread keeps two neighbouring columns
// (one 8-byte access per row) and walks its share of the row pairs.
__device__ void rotate_vt(float* V, int ld, int npairs, const int* pq, const float2* ang,
                          int half, int t0) {
  const int t = (int)threadIdx.x - t0, groups = (NTR - t0) / npairs;
  if (t < 0 || t >= groups * npairs) return;
  const int k = 2 * (t % npairs);
  for (int i = t / npairs; i < half; i += groups) {
    const int v = pq[i];
    const float2 a = ang[i];
    float2* vp = reinterpret_cast<float2*>(V + pq_p(v) * ld + k);
    float2* vq = reinterpret_cast<float2*>(V + pq_q(v) * ld + k);
    float2 x = *vp, y = *vq;
    rot_pair(x.x, y.x, a.x, a.y);
    rot_pair(x.y, y.y, a.x, a.y);
    *vp = x;
    *vq = y;
  }
}

// A 2x2 block of A: rows (top, bottom) x columns (top label, bottom label).
struct Quad {
  float pr, ps, qr, qs;
};

__device__ __forceinline__ Quad load_quad(const float* A, int rop, int roq, int cr, int cs) {
  return {A[rop + cr], A[rop + cs], A[roq + cr], A[roq + cs]};
}

// One entry of the rotated block (ri: the row pair's angle, cj: the column
// pair's), computed as its owner computes it, so to the same bits.
__device__ __forceinline__ float rotated(Quad q, float2 ri, float2 cj, bool row_top,
                                         bool col_top) {
  rot2x2(q.pr, q.ps, q.qr, q.qs, ri.x, ri.y, cj.x, cj.y);
  return row_top ? (col_top ? q.pr : q.ps) : (col_top ? q.qr : q.qs);
}

// The next round's pair k takes label p from position xp = label_src(k)
// and q from xq = label_src(k + half) of this round: its angle needs the
// rotated entries (p, p), (p, q), (q, q), which lie in the 2x2 blocks (ip,
// ip), (ip, iq), (iq, iq) of this round's pairs ip, iq. An angle thread
// reads those three blocks before the round's rotation and computes the
// angle while the other warps rotate.
struct NextPair {
  int ip, iq;
  bool pt, qt;  // p (q) is the top label of its pair
};

__device__ __forceinline__ NextPair next_pair_of(int k, int half) {
  const int xp = label_src(k, half, 2 * half), xq = label_src(k + half, half, 2 * half);
  return {xp < half ? xp : xp - half, xq < half ? xq : xq - half, xp < half, xq < half};
}

// Rotated entries (p, p) (returned), (p, q) and (q, q) of the next pair.
__device__ __forceinline__ float next_angle_inputs(const Quad& bpp, const Quad& bpq,
                                                   const Quad& bqq, NextPair n, const float2* ang,
                                                   float& apq, float& aqq) {
  const float2 ai = ang[n.ip], aj = ang[n.iq];
  apq = rotated(bpq, ai, aj, n.pt, n.qt);
  aqq = rotated(bqq, aj, aj, n.qt, n.qt);
  return rotated(bpp, ai, ai, n.pt, n.pt);
}

// Byte counts of the one-launch regimes (ops/jacobi.py::smem_bytes mirrors
// them): A's rows at stride mp + 1 (a), mp + 4 (b); the eigenvector rows at
// stride mp (a); per pair a row record (16 B) and an angle (8 B), both
// double buffered, and two label words; in (b) two slot tables, two sets of
// edge values and the neighbours' slot numbers (16 B); B1's consumer blocks
// hold mp x cluster_cols(mp) eigenvector entries, one set of angles and the
// labels.
__host__ __device__ constexpr int sm_bytes(int mp, bool vec) {
  return 4 * mp * (mp + 1) + (vec ? 4 * mp * mp : 0) + 28 * mp;
}
__host__ __device__ constexpr int cluster_pairs_max(int mp) { return (mp / 2 + CL - 1) / CL; }
__host__ __device__ constexpr int cluster_slots(int mp) { return 2 * cluster_pairs_max(mp) + 2; }
// even, so that a consumer block's rows hold whole column pairs
__host__ __device__ constexpr int cluster_cols(int mp) { return ((mp + CL - 1) / CL + 1) / 2 * 2; }
// row stride: a multiple of 4 floats, so that rows move as float4
__host__ __device__ constexpr int cluster_ld(int mp) { return mp + 4; }
__host__ __device__ constexpr int cluster_row_bytes(int mp) {
  return 32 * cluster_pairs_max(mp) + 12 * mp + 8 * cluster_slots(mp) + 8 * EDGE + 16 +
         4 * cluster_slots(mp) * cluster_ld(mp);
}
__host__ __device__ constexpr int cluster_col_bytes(int mp) {
  return 4 * mp * cluster_cols(mp) + 8 * mp;
}
__host__ __device__ constexpr int cluster_bytes(int mp, bool vec) {
  return vec && cluster_col_bytes(mp) > cluster_row_bytes(mp) ? cluster_col_bytes(mp)
                                                              : cluster_row_bytes(mp);
}

// First pair position of block b of a cluster.
__host__ __device__ __forceinline__ int pair_lo(int b, int half) { return b * half / CL; }

// B1's angle log: one 16-byte entry (c, flag, s, flag) per round and pair,
// written with one vector store; the flag (round + 1) travels in the same
// 8 bytes as each value, so a reader that sees the flag sees the value
// (the LL protocol of NCCL). The wrapper zeroes the log.
__device__ __forceinline__ void put_angle(int4* e, float c, float s, int flag) {
  asm volatile("st.volatile.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(e),
               "r"(__float_as_int(c)), "r"(flag), "r"(__float_as_int(s)), "r"(flag)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the entry of round flag - 1; traps after WAIT_NS, so that a
// producer that never comes ends the launch instead of hanging the card.
__device__ __forceinline__ float2 get_angle(const int4* e, int flag) {
  const unsigned long long t0 = now_ns();
  for (unsigned n = 1;; ++n) {
    int4 v;
    asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(e)
                 : "memory");
    if (v.y == flag && v.w == flag) return make_float2(__int_as_float(v.x), __int_as_float(v.z));
    if ((n & 255) == 0 && now_ns() - t0 > WAIT_NS) __trap();
  }
}

// ---- (a) one block per matrix in shared memory -----------------------------

// x0, x1: B1 eigenvector rows [nb, mp, mp] and eigenvalues [nb, mp];
// B2 lower and upper Gershgorin bounds [nb, mp] each. Warps 0..na-1 hold
// one angle thread per pair; the rest rotate.
template <bool VEC>
__global__ void __launch_bounds__(NTR)
sm_kernel(const float* __restrict__ a_in, float* x0, float* x1, int mp, int nrounds) {
  extern __shared__ int4 smem4[];
  const int half = mp / 2, ld = mp + 1, tid = threadIdx.x, na = (half + 31) / 32;
  int4* rr = smem4;  // [2][half]: row pair records
  float2* ang = reinterpret_cast<float2*>(rr + 2 * half);  // [2][half]
  int* pq = reinterpret_cast<int*>(ang + 2 * half);  // [2][half]
  float* A = reinterpret_cast<float*>(pq + 2 * half);  // [mp][ld]
  float* V = A + mp * ld;  // B1 only: [mp][mp]
  const size_t off = (size_t)blockIdx.x * mp * mp;
  for (int e = tid; e < mp * mp; e += NTR) {
    const int r = e / mp, c = e - r * mp;
    A[r * ld + c] = a_in[off + e];
    if (VEC) V[e] = r == c ? 1.0f : 0.0f;
  }
  init_pairs(pq, half);
  __syncthreads();
  for (int k = tid; k < half; k += NTR) {  // round 0: position i holds label i
    float c, s;
    rotation(A[k * ld + k], A[k * ld + k + half], A[(k + half) * ld + k + half], c, s);
    ang[k] = make_float2(c, s);
    rr[k] = make_int4(k * ld, (k + half) * ld, __float_as_int(c), __float_as_int(s));
  }
  __syncthreads();
  for (int r = 0; r < nrounds; ++r) {
    const int cur = r & 1, nx = cur ^ 1;
    const int* pqc = pq + cur * half;
    const float2* angc = ang + cur * half;
    const bool angle = r + 1 < nrounds && tid < half;  // thread tid: next round's pair tid
    NextPair n;
    Quad bpp, bpq, bqq;
    if (angle) {
      n = next_pair_of(tid, half);
      const int vp = pqc[n.ip], vq = pqc[n.iq];
      const int rp = pq_p(vp) * ld, rq = pq_q(vp) * ld;
      bpp = load_quad(A, rp, rq, pq_p(vp), pq_q(vp));
      bpq = load_quad(A, rp, rq, pq_p(vq), pq_q(vq));
      bqq = load_quad(A, pq_p(vq) * ld, pq_q(vq) * ld, pq_p(vq), pq_q(vq));
    }
    __syncthreads();
    if (angle) {
      float apq, aqq, c, s;
      const float app = next_angle_inputs(bpp, bpq, bqq, n, angc, apq, aqq);
      rotation(app, apq, aqq, c, s);
      const int vp = pqc[n.ip], vq = pqc[n.iq];
      const int p = n.pt ? pq_p(vp) : pq_q(vp), q = n.qt ? pq_p(vq) : pq_q(vq);
      ang[nx * half + tid] = make_float2(c, s);
      rr[nx * half + tid] = make_int4(p * ld, q * ld, __float_as_int(c), __float_as_int(s));
      pq[nx * half + tid] = p | q << 16;
    }
    rotate_rows(A, rr + cur * half, half, pqc, angc, half, na);
    if (VEC) rotate_vt(V, mp, half, pqc, angc, half, 32 * na);
    __syncthreads();
  }
  if (VEC) {
    for (int e = tid; e < mp * mp; e += NTR) x0[off + e] = V[e];
    for (int i = tid; i < mp; i += NTR) x1[(size_t)blockIdx.x * mp + i] = A[i * ld + i];
  } else {
    for (int i = tid >> 5; i < mp; i += NW)
      gersh_row(A + i * ld, i, mp, x0 + (size_t)blockIdx.x * mp, x1 + (size_t)blockIdx.x * mp);
  }
}

// ---- (b) one cluster per matrix --------------------------------------------

// B1's eigenvector rows: block v of a consumer cluster holds columns
// [v mp / 16, (v + 1) mp / 16) of every row and replays the producer's
// angles from the log, round by round.
__device__ void vt_consumer(const int4* log, float* vt, int mp, int nrounds) {
  extern __shared__ int4 smem4[];
  const int half = mp / 2, tid = threadIdx.x, v = blockIdx.x;
  const int c0 = v * mp / CL, nc = (v + 1) * mp / CL - c0, ldv = cluster_cols(mp);
  float2* ang = reinterpret_cast<float2*>(smem4);  // [half]
  int* pq = reinterpret_cast<int*>(ang + half);  // [2][half]
  float* V = reinterpret_cast<float*>(pq + 2 * half);  // [mp][ldv]
  for (int e = tid; e < mp * ldv; e += NTR) {  // padding columns stay 0
    const int p = e / ldv, k = e - p * ldv;
    V[e] = p == c0 + k && k < nc ? 1.0f : 0.0f;
  }
  init_pairs(pq, half);
  for (int r = 0; r < nrounds; ++r) {
    for (int k = tid; k < half; k += NTR) ang[k] = get_angle(log + (size_t)r * half + k, r + 1);
    __syncthreads();
    const int* pqc = pq + (r & 1) * half;
    rotate_vt(V, ldv, (nc + 1) / 2, pqc, ang, half, 0);
    for (int k = tid; k < half; k += NTR) pq[((r + 1) & 1) * half + k] = next_pair(pqc, k, half);
    __syncthreads();
  }
  for (int e = tid; e < mp * nc; e += NTR) {
    const int p = e / nc, k = e - p * nc;
    vt[(size_t)p * mp + c0 + k] = V[p * ldv + k];
  }
}

// Slot of local position l after this round's move, in block b with K local
// pairs and slot table sl (sl[2K], sl[2K+1]: the free slots, which receive
// the rows from blocks b-1 and b+1).
__device__ __forceinline__ int next_slot(const int* sl, int l, int b, int K) {
  const int f0 = sl[2 * K], f1 = sl[2 * K + 1];
  if (l < K)  // top positions
    return b == 0 ? (l == 0 ? sl[0] : l == 1 ? sl[K] : sl[l - 1]) : (l == 0 ? f0 : sl[l - 1]);
  if (l < 2 * K - 1) return sl[l + 1];  // bottom positions but the last
  if (l == 2 * K - 1) return b == CL - 1 ? sl[K - 1] : f1;
  if (l == 2 * K) return b == 0 ? f0 : b == CL - 1 ? f1 : sl[K - 1];  // the new free slots
  return b == 0 ? sl[K - 1] : sl[K];
}

// Grid (16, nmat) for B2, (16, 2 nmat) for B1: row y < nmat is the cluster
// of matrix y, row nmat + y (B1) the consumer cluster of its eigenvector
// rows. x0, x1 as in sm_kernel; log [nmat, nrounds, mp/2] (zeroed) only
// for B1.
//
// One cluster barrier a round. Lane l < K of warp 0 is the angle thread of
// the block's own pair lo + l in the next round: it reads the three 2x2
// blocks its angle needs before the rotation and computes the angle while
// warps 1..31 rotate; at the start of the next round every block reads the
// angles it does not own from their owners (angles, records, labels and
// slot tables are double buffered by round). Two of those
// blocks lie in rows of a neighbour for the two pairs that take an
// arriving row; their entries come from the "edge" values the neighbour
// pushed the round before. After the rotation the leaving rows go into the
// neighbours' free slots and the next round's edge values to the
// neighbours; the barrier then makes all of it visible.
//
// Edge values of block b (12 floats a round): [0..3] row p at columns
// (p, p2, x, q), [4..7] row p2 at the same columns, where p, p2, x, q are the
// labels at positions lo-1, half+lo-1, lo+1, half+lo+1 (the top edge: next
// round's pair lo takes row p from block b-1); [8..11] rows y and q at
// columns (y, q), labels at positions hi and half+hi (the bottom edge: next
// round's pair hi-1 takes row q from block b+1).
template <bool VEC>
__global__ void __launch_bounds__(NTR)
cluster_kernel(const float* __restrict__ a_in, float* x0, float* x1, int4* log, int mp,
               int nrounds, int nmat) {
  const int mat = VEC ? blockIdx.y % nmat : blockIdx.y;
  const size_t logoff = (size_t)mat * nrounds * (mp / 2);
  if (VEC && blockIdx.y >= nmat) {
    vt_consumer(log + logoff, x0 + (size_t)mat * mp * mp, mp, nrounds);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int4 smem4[];
  const int b = (int)cluster.block_rank();
  const int half = mp / 2, ld = cluster_ld(mp), tid = threadIdx.x, S = cluster_slots(mp);
  const int KM = cluster_pairs_max(mp);
  const int lo = pair_lo(b, half), hi = pair_lo(b + 1, half), K = hi - lo;
  const bool top_edge = b > 0, bottom_edge = b < CL - 1;
  int4* rr = smem4;  // [2][KM]: records of the local row pairs
  float2* ang = reinterpret_cast<float2*>(rr + 2 * KM);  // [2][half]
  int* pq = reinterpret_cast<int*>(ang + 2 * half);  // [2][half]
  int* slt = pq + 2 * half;  // [2][S]: slots of the local positions, then 2 free
  float* edge = reinterpret_cast<float*>(slt + 2 * S);  // [2][EDGE]
  int* nfree = reinterpret_cast<int*>(edge + 2 * EDGE);  // [4]: the neighbours' free slots
  float* rows = reinterpret_cast<float*>(nfree + 4);  // [S][ld], 16-byte aligned
  // round 0: local position l < K is top position lo + l, K <= l < 2K bottom
  // position half + lo + l - K, position i holds label i; every block takes
  // all angles and its edge values straight from the input
  const float* a = a_in + (size_t)mat * mp * mp;
  for (int e = tid; e < 2 * K * mp; e += NTR) {
    const int l = e / mp, c = e - l * mp;
    const int label = l < K ? lo + l : half + lo + l - K;
    rows[l * ld + c] = a[(size_t)label * mp + c];
  }
  for (int l = tid; l < 2 * K + 2; l += NTR) slt[l] = l;
  init_pairs(pq, half);
  for (int k = tid; k < half; k += NTR) {
    float c, s;
    rotation(a[(size_t)k * mp + k], a[(size_t)k * mp + k + half],
             a[(size_t)(k + half) * mp + k + half], c, s);
    ang[k] = make_float2(c, s);
    if (k >= lo && k < hi) {
      const int l = k - lo;
      rr[l] = make_int4(l * ld, (K + l) * ld, __float_as_int(c), __float_as_int(s));
      if (VEC) put_angle(log + logoff + k, c, s, 1);
    }
  }
  if (tid < EDGE) {
    const int tp[4] = {lo - 1, half + lo - 1, lo + 1, half + lo + 1};
    const int bt[2] = {hi, half + hi};
    if (tid < 8 && top_edge) edge[tid] = a[(size_t)tp[tid / 4] * mp + tp[tid % 4]];
    if (tid >= 8 && bottom_edge) edge[tid] = a[(size_t)bt[(tid - 8) / 2] * mp + bt[tid % 2]];
  }
  cluster.sync();  // every block runs before any remote store
  const int Kup = pair_lo(b + 2, half) - hi;                 // K of block b + 1
  const int Kdn = top_edge ? lo - pair_lo(b - 1, half) : 0;  // K of block b - 1
  for (int r = 0; r < nrounds; ++r) {
    const int cur = r & 1, nx = cur ^ 1;
    const int* pqc = pq + cur * half;
    const int* sl = slt + cur * S;
    const float2* angc = ang + cur * half;
    const bool more = r + 1 < nrounds;
    // the angle threads read the blocks of their next-round angle; two
    // lanes read where this round's leaving rows will go
    const bool angle = more && tid < K;
    const int l = tid;
    NextPair n;
    Quad bpp, bpq, bqq;
    if (angle) {
      n = next_pair_of(lo + l, half);
      const int vp = pqc[n.ip], vq = pqc[n.iq];
      const float* ec = edge + cur * EDGE;
      // the local rows of pair i: slots of positions i and half + i
      auto local = [&](int i, int v) {
        return load_quad(rows, sl[i - lo] * ld, sl[K + i - lo] * ld, pq_p(v), pq_q(v));
      };
      if (top_edge && l == 0) {  // pair ip = lo - 1 is block b-1's
        bpp = {ec[0], ec[1], ec[4], ec[5]};
        bpq = {ec[2], ec[3], ec[6], ec[7]};
        bqq = local(n.iq, vq);
      } else if (bottom_edge && l == K - 1) {  // pair iq = hi is block b+1's
        bpp = local(n.ip, vp);
        bpq = local(n.ip, vq);
        bqq = {ec[8], ec[9], ec[10], ec[11]};
      } else {
        bpp = local(n.ip, vp);
        bpq = local(n.ip, vq);
        bqq = local(n.iq, vq);
      }
    }
    if (more && tid == 30 && bottom_edge)
      nfree[0] = cluster.map_shared_rank(slt + cur * S, b + 1)[2 * Kup];
    if (more && tid == 31 && top_edge)
      nfree[1] = cluster.map_shared_rank(slt + cur * S, b - 1)[2 * Kdn + 1];
    // meanwhile the other warps take the other blocks' angles of this round
    // and advance the labels and slot table
    if (tid >= 512 && tid < 512 + half && (tid - 512 < lo || tid - 512 >= hi)) {
      const int k = tid - 512;
      ang[cur * half + k] = cluster.map_shared_rank(ang + cur * half, ((k + 1) * CL - 1) / half)[k];
    }
    if (more) {
      for (int k = tid - 32; k >= 0 && k < half; k += NTR)
        pq[nx * half + k] = next_pair(pqc, k, half);
      for (int j = tid - 32 - half; j >= 0 && j < 2 * K + 2; j += NTR)
        slt[nx * S + j] = next_slot(sl, j, b, K);
    }
    __syncthreads();
    if (angle) {
      float apq, aqq, c, s;
      const float app = next_angle_inputs(bpp, bpq, bqq, n, angc, apq, aqq);
      rotation(app, apq, aqq, c, s);
      const int k = lo + l;
      ang[nx * half + k] = make_float2(c, s);  // the other blocks take it next round
      rr[nx * KM + l] = make_int4(next_slot(sl, l, b, K) * ld, next_slot(sl, K + l, b, K) * ld,
                                  __float_as_int(c), __float_as_int(s));
      if (VEC) put_angle(log + logoff + (size_t)(r + 1) * half + k, c, s, r + 2);
    }
    rotate_rows(rows, rr + cur * KM, K, pqc, angc, half, 1);
    __syncthreads();
    if (!more) break;  // the last round moves no rows (the barrier follows the loop)
    // edge values of round r+1 (the last warp): rows after this round's
    // rotation at the labels of round r+1
    if (tid >= NTR - 32 && tid < NTR - 32 + EDGE) {
      const int i = tid - (NTR - 32);
      if (i < 4 && bottom_edge) {  // block b+1's row p: position hi-1 next round
        const int tp[4] = {hi - 1, half + hi - 1, hi + 1, half + hi + 1};
        cluster.map_shared_rank(edge, b + 1)[nx * EDGE + i] =
            rows[next_slot(sl, K - 1, b, K) * ld + next_label(pqc, tp[i], half)];
      } else if (i >= 4 && i < 8 && top_edge) {  // own row p2: now the first bottom row
        const int tp[4] = {lo - 1, half + lo - 1, lo + 1, half + lo + 1};
        edge[nx * EDGE + i] = rows[sl[K] * ld + next_label(pqc, tp[i - 4], half)];
      } else if (i >= 8 && i < 10 && bottom_edge) {  // own row y: now the last top row
        const int bt[2] = {hi, half + hi};
        edge[nx * EDGE + i] = rows[sl[K - 1] * ld + next_label(pqc, bt[i - 8], half)];
      } else if (i >= 10 && top_edge) {  // block b-1's row q: position half+lo next round
        const int bt[2] = {lo, half + lo};
        cluster.map_shared_rank(edge, b - 1)[nx * EDGE + i] =
            rows[next_slot(sl, K, b, K) * ld + next_label(pqc, bt[i - 10], half)];
      }
    }
    // the leaving rows into the neighbours' free slots, 16 bytes a store
    const int m4 = mp / 4;
    for (int e = tid; e < 2 * m4; e += NTR) {
      const int side = e / m4, c = 4 * (e - side * m4);
      if (side == 0 && bottom_edge)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(rows, b + 1) + nfree[0] * ld + c) =
            *reinterpret_cast<const float4*>(rows + sl[K - 1] * ld + c);
      if (side == 1 && top_edge)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(rows, b - 1) + nfree[1] * ld + c) =
            *reinterpret_cast<const float4*>(rows + sl[K] * ld + c);
    }
    cluster.sync();
  }
  // The last round's remote angle reads (above) must end before any block
  // of the cluster exits: its shared memory goes with it.
  cluster.sync();
  const int last = (nrounds - 1) & 1;
  const int* pqf = pq + last * half;
  const int* sl = slt + last * S;
  if (VEC) {
    for (int l = tid; l < 2 * K; l += NTR) {
      const int p = label_at(pqf, l < K ? lo + l : half + lo + l - K, half);
      x1[(size_t)mat * mp + p] = rows[sl[l] * ld + p];
    }
  } else {
    for (int l = tid >> 5; l < 2 * K; l += NW) {
      const int p = label_at(pqf, l < K ? lo + l : half + lo + l - K, half);
      gersh_row(rows + sl[l] * ld, p, mp, x0 + (size_t)mat * mp, x1 + (size_t)mat * mp);
    }
  }
}

// ---- (c) one launch per round ----------------------------------------------

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
      float a_pr = src[p * mp + r], a_ps = src[p * mp + s];
      float a_qr = src[q * mp + r], a_qs = src[q * mp + s];
      rot2x2(a_pr, a_ps, a_qr, a_qs, sc[0][ty], ss[0][ty], sc[1][tx], ss[1][tx]);
      dst[p * mp + r] = a_pr;
      dst[p * mp + s] = a_ps;
      dst[q * mp + r] = a_qr;
      dst[q * mp + s] = a_qs;
    }
  } else {
    const int k = tj * TP + tx;
    if (i < half && k < mp) {
      const int p = P[i], q = Q[i];
      rot_pair(vt[p * mp + k], vt[q * mp + k], sc[0][ty], ss[0][ty]);
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

// One warp per (row, matrix).
__global__ void __launch_bounds__(128)
gersh_kernel(const float* a, float* g, float* h, int mp) {
  const int i = blockIdx.x * 4 + (threadIdx.x >> 5), b = blockIdx.y;
  if (i < mp)
    gersh_row(a + (size_t)b * mp * mp + (size_t)i * mp, i, mp, g + (size_t)b * mp,
              h + (size_t)b * mp);
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

// ---- launchers of the one-launch regimes -----------------------------------

template <bool VEC>
int launch_sm(const float* a, float* x0, float* x1, int nb, int mp, int nrounds,
              cudaStream_t st) {
  const int bytes = sm_bytes(mp, VEC);
  if (bytes > SMEM_MAX || mp / 2 > NTR) return ERR_SHAPE;
  cudaError_t err =
      cudaFuncSetAttribute(sm_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  sm_kernel<VEC><<<nb, NTR, bytes, st>>>(a, x0, x1, mp, nrounds);
  return cudaGetLastError();
}

template <bool VEC>
int launch_cluster(const float* a, float* x0, float* x1, int4* log, int nb, int mp,
                   int nrounds, cudaStream_t st) {
  const int bytes = cluster_bytes(mp, VEC);
  // block 0 needs two top positions (the tournament's fixed position and
  // the one it feeds);  // two top positions, and lanes 30 and 31 of warp 0 free of angle work
  if (bytes > SMEM_MAX || mp / 2 < 2 * CL || cluster_pairs_max(mp) > 30) return ERR_SHAPE;
  auto kern = cluster_kernel<VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, VEC ? 2 : 1, 1);
  cfg.blockDim = dim3(NTR, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return err;
  // B1's producer and consumer clusters must be resident together; B2's
  // clusters are independent and may queue
  const int per = VEC ? active / 2 : nb;
  if (active < 1 || per < 1) return ERR_NO_CLUSTER;
  const int half = mp / 2;
  for (int m0 = 0; m0 < nb; m0 += per) {
    const int n = nb - m0 < per ? nb - m0 : per;
    cfg.gridDim = dim3(CL, VEC ? 2 * n : n, 1);
    const size_t mat = (size_t)m0 * mp;
    err = cudaLaunchKernelEx(&cfg, kern, a + mat * mp, x0 + (VEC ? mat * mp : mat),
                             x1 + mat, VEC ? log + (size_t)m0 * nrounds * half : log,
                             mp, nrounds, n);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// Regime codes: 0 = (c) one launch per round, 1 = (a) one block per matrix,
// 2 = (b) one cluster per matrix. Returns a cudaError_t (0 = success) or
// -1 (no cluster of this shape can be resident) / -2 (shape does not fit the
// regime).
//
// B1. a: [nb, mp, mp] input (overwritten in regime 0 only); a2: [nb, mp, mp]
// scratch and pairs: [mp-1, 2, mp/2] labels (regime 0 only); vt: [nb, mp, mp]
// output (eigenvectors as rows); lam: [nb, mp] output (unsorted, label
// order); log: [nb, nrounds, mp/2] 16-byte entries, zeroed (regime 2
// only).
extern "C" int lt_jacobi_eigh_f32(float* a, float* a2, float* vt, float* lam,
                                  const int* pairs, void* log,
                                  int nb, int mp, int nrounds, int regime,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (regime == 1) return launch_sm<true>(a, vt, lam, nb, mp, nrounds, st);
  if (regime == 2)
    return launch_cluster<true>(a, vt, lam, static_cast<int4*>(log), nb, mp,
                                nrounds, st);
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

// B2. a, a2, pairs as for B1; g, h: [nb, mp] output per-row lower/upper
// Gershgorin bounds of the rotated matrix.
extern "C" int lt_jacobi_bounds_f32(float* a, float* a2, float* g, float* h,
                                    const int* pairs, int nb, int mp,
                                    int nrounds, int regime, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (regime == 1) return launch_sm<false>(a, g, h, nb, mp, nrounds, st);
  if (regime == 2)
    return launch_cluster<false>(a, g, h, nullptr, nb, mp, nrounds, st);
  float* fin = nullptr;
  cudaError_t err =
      run_rounds(a, a2, nullptr, pairs, nb, mp, nrounds, st, &fin);
  if (err != cudaSuccess) return err;
  gersh_kernel<<<dim3((mp + 3) / 4, nb), 128, 0, st>>>(fin, g, h, mp);
  return cudaGetLastError();
}
