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
// (ops/jacobi.py::regime_for, which mirrors the byte counts below, and
// holds the boundaries the card timed): (e) "dsmem" from mp 64 to 448 (B2),
// 288 (B1 of up to 3 matrices) or 464 (B1 of 4 to 7) while one wave of its
// clusters holds the nb matrices (7 on an H100); else "sm" where it fits
// (so below mp 64, or past that wave), else (b) "cluster" where it fits (to
// mp 912; B2 of one matrix to 832), else "grid" where it fits (to mp 2400),
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
// (b) "cluster": one thread block cluster of 16 blocks of 1024 threads per
//     matrix (a non-portable size), the matrix spread over their shared
//     memory, one launch; mp <= 912. Rows are owned by tournament position:
//     block b holds the rows at positions [lo_b, hi_b) and [mp/2 + lo_b,
//     mp/2 + hi_b) (pair_lo) in row slots through a slot table, so both rows
//     of each of its pairs are local and every rotation reads and writes
//     local memory only. The tournament then moves one top row from each
//     block to the next and one bottom row back (pair_table's permutation
//     shifts position ranges by one) into the slot the receiver's leaving row
//     vacated, and 12 "edge" values (the entries a neighbour needs for the
//     pair that takes an arriving row) go with them. No cluster barrier: a
//     round's angles, rows and edge values are bulk copies
//     (cp.async.bulk shared::cluster) that count their bytes on the
//     receiver's mbarrier of the round's parity, and a block waits only for
//     what it reads next round. Its warps split the round: warp 0 computes
//     the next round's angles from the 2x2 blocks it reads before the
//     rotation (the same arithmetic as the owners', so the same bits) and
//     copies them into the 15 other blocks; warps 2..31 each rotate one
//     column pair down the local rows, the rows that leave and those the
//     edge values come from first, then arrive on a local barrier, on which
//     warp 1 waits to copy the leaving rows and edge values out while they
//     rotate the rest; only the warps whose columns hold warp 0's 2x2 blocks
//     wait for it to read them (named barrier 1). Labels come in closed form
//     from a position's place on the tournament's cycle (cyc), slot tables
//     through a fixed gather (slot_src), warp 0's per-lane indices from a
//     packed table: no division by a runtime value in the loop. Bound, on an
//     H100, by each SM's instruction issue for the rotation: ~44
//     instructions a 2x2 block, 24 of them unfused f32 multiplies and adds,
//     over its ~10,600 blocks a round at mp 816. Timed by parts there
//     (PERF.md, B2): the first version of this regime took 5.05 us a round,
//     ~1.07 of it its cluster barrier, ~0.55 its remote row stores, ~0.16
//     its remote angle loads, ~2.44 the rotation and ~1.23 its index code,
//     two __syncthreads() and the angle chain; this one takes ~2.95 us, of
//     which the rotation ~2.5 (its first four records at half the rate of
//     the rest) and ~0.3 the round's wait and table gather before it.
//     B1's eigenvector rows (2.66 MB at mp = 816) do not fit beside A, but
//     their columns never mix: a second cluster of 16 blocks per matrix
//     holds them by column ranges, two columns a thread, and replays the
//     angles that the first cluster writes to a log in global memory, one
//     flagged entry per round and pair (put_pair below), loaded a round
//     ahead; it keeps pace (it ends within a microsecond of the first), so
//     B1's round is the first cluster's. The consumer only waits for the
//     producer, never the reverse, and the host launches at most as many
//     matrices at once as cudaOccupancyMaxActiveClusters lets be resident
//     (producers first in the grid); a wait that lasts 20 s traps, so a
//     fault ends the launch instead of hanging the card.
//
// (c) "rounds": past (d)'s capacity (mp > 2400 on an H100 SXM's 132 SMs),
//     one launch per round over the whole card: a thread owns one 2x2 block
//     (and, for B1, one eigenvector column pair), a block of 256 threads a
//     16 x 16 tile of pair blocks, recomputing the angles it needs from the
//     previous A buffer; the host table `pairs` ([mp-1, 2, mp/2] int32)
//     gives each round's labels. sweeps * (mp - 1) dependent launches a call: 10,070
//     for B1 at mp 1008, each moving A (and V) through L2.
//
// (d) "grid": past a cluster's capacity (912 < mp, to 2400 on 132 SMs), one
//     cooperative launch a call: (b) with the whole card in place of a
//     cluster. It replaces (c)'s launch per round. Each matrix gets G blocks
//     of 1024 threads, one per SM (G = the card's SMs / the matrices a
//     launch holds: 132 on an H100 SXM at nb = 1; fewer SMs hold smaller
//     matrices), and block b owns the rows of its pair positions, as pair_lo
//     lays them out, in shared memory, so rotations touch local memory
//     only. There is no distributed shared memory across a grid: a block
//     publishes its pairs' next-round angles, its two leaving rows and the
//     edge values its neighbours need to exchange buffers in global memory,
//     each value beside the round's flag in one store (put_pair, as (b)'s
//     angle log), double buffered by round parity; the next round, every
//     block waits for all of the round's angles and its two arriving rows,
//     each thread for its own entries. No grid barrier: a block waits for
//     exactly what it reads, as soon as it is written. Bound, on an H100,
//     by a round's chain of L2 round trips (publish, see the flag, compute
//     the next angles), not by each SM's shared-memory traffic (at mp 1008
//     a block holds 8 of A's rows, 32 KB). B1's eigenvector rows travel
//     with A's in shared memory while both fit (to mp ~1790 at G = 132);
//     past that they stay in the output, in global memory by label (16 MB
//     at mp 2000, held by the 50 MB L2), and each block rotates its pairs'
//     rows there, every element through L2 each round, at the end of the
//     round, once A's rows and the angles are out (no angle depends on
//     them): a flag per block, set after a fence, tells its neighbours, the
//     rows' next owners, that it is done with them. Where a launch
//     cannot hold every block at once the call fails (-1) and the wrapper
//     raises: a block that never ran would leave the others waiting; a wait
//     that lasts 20 s traps.
//
// (e) "dsmem": one thread block cluster of 16 blocks of 256 threads per
//     matrix, the rows laid out as in (b) and (d) (B1's eigenvector rows in
//     the same slots as A's), one launch, and no cluster barrier: each block
//     stores its pairs' next angles into every other block's shared memory,
//     and its two leaving rows and the edge values into its neighbours'
//     free slots, with st.async, which counts the bytes on the receiver's
//     mbarrier of the round's parity; a block waits only for what it reads.
//     At mp 160 a round is small (80 rotations, ~10 rows a block), and its
//     floor is one DSMEM exchange (~0.26 us measured for an all-to-all
//     store and wait) and the chain of the next angle (the 2x2 blocks
//     rotated, three divisions, two square roots: ~0.2 us when its code is
//     cached). Written as (b) and (d) are, the same exchange takes 2.4-2.8
//     us a round whatever the cluster size: the loop is ~1,800
//     instructions of branchy index code (label_src, next_slot, divisions
//     by runtime values), each part run once a round by one or a few
//     warps, so a round waits on instruction fetch. So here the labels
//     advance through a table of label_src, the three slot tables through a
//     fixed gather map (slot_src), per-lane indices are fixed before the
//     loop, the sends and pushes are short loops, warp 0 (the next angles)
//     does not wait for the other warps' table work (a named barrier), and
//     the rows leave as soon as they are rotated, while warp 0 may still
//     send angles: ~0.9 us a round for B2 and ~1.1 us for B1 at mp 160
//     (PERF.md). Past mp 448 (B2; 288 for B1 of up to 3 matrices) (b) is
//     the faster: each block's share of the rotation grows with mp, and
//     (b) has four times the threads for it; B1 fits only to mp 640 (A and
//     the eigenvector rows in one block). A
//     cluster that cannot be resident fails the call (-1); a wait that
//     lasts 20 s traps.
//
// Every regime applies the same per-element arithmetic (rotation, rot2x2,
// rot_pair) and sums the Gershgorin rows in the same order (gersh_row), so
// the five agree bit for bit. Each operation is a round-to-nearest
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
constexpr int NTR = 1024;       // (a), (b), (d): threads per block
constexpr int NW = NTR / 32;    // (a), (b), (d): warps per block
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int ERR_NO_CLUSTER = -1;  // no cluster of this shape can be resident
constexpr int ERR_SHAPE = -2;       // the shape does not fit the regime
constexpr int EDGE = 12;         // (b), (d), (e): edge values a block keeps per round
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
  // chunk of columns j, row pairs g, g + ng, ...
  auto walk = [&](int j, int g, int ng) {
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
  };
  if (nw >= nc) {  // every chunk has a warp, most several
    const int chunk = warp % nc;
    walk(chunk * 32 + lane, warp / nc, (nw - 1 - chunk) / nc + 1);
  } else {  // more chunks than warps ("grid" past mp 1984): a warp walks several
    for (int chunk = warp; chunk < nc; chunk += nw) walk(chunk * 32 + lane, 0, 1);
  }
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

// Bytes of an (a) block (ops/jacobi.py::smem_bytes mirrors it; (b), (d) and
// (e) below): A's rows at stride mp + 1, the eigenvector rows at stride mp,
// per pair a row record (16 B) and an angle (8 B), both double buffered, and
// two label words.
__host__ __device__ constexpr int sm_bytes(int mp, bool vec) {
  return 4 * mp * (mp + 1) + (vec ? 4 * mp * mp : 0) + 28 * mp;
}

// First pair position of block b of nblk blocks (a cluster, or a matrix's
// blocks in (d)).
__host__ __device__ __forceinline__ int pair_lo(int b, int half, int nblk) {
  return b * half / nblk;
}

// Flagged entries, (b)'s angle log and (d)'s exchange buffers: a 16-byte
// entry (a, flag, b, flag) or an 8-byte one (a, flag), written with one
// vector store; the flag travels in the same 8 bytes as each value, so a
// reader that sees the flag sees the value (the LL protocol of NCCL). The
// wrapper zeroes the buffers; flags start at 1.
__device__ __forceinline__ void put_pair(int4* e, float a, float b, int flag) {
  asm volatile("st.volatile.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(e),
               "r"(__float_as_int(a)), "r"(flag), "r"(__float_as_int(b)), "r"(flag)
               : "memory");
}

__device__ __forceinline__ void put_one(int2* e, float a, int flag) {
  asm volatile("st.volatile.global.v2.s32 [%0], {%1, %2};" ::"l"(e), "r"(__float_as_int(a)),
               "r"(flag)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spins until `done`; traps after WAIT_NS, so that a writer that never
// comes ends the launch instead of hanging the card.
template <typename F>
__device__ __forceinline__ void wait_until(F done) {
  unsigned long long t0 = 0;
  for (unsigned n = 1; !done(); ++n)
    if ((n & 255) == 0) {
      if (t0 == 0) t0 = now_ns();
      else if (now_ns() - t0 > WAIT_NS) __trap();
    }
}

__device__ __forceinline__ int4 ld_entry(const int4* e) {
  int4 v;
  asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(e)
               : "memory");
  return v;
}

// The values of entry e written with `flag`: v, loaded earlier, or e
// reloaded until it holds the flag.
__device__ __forceinline__ float2 entry_value(const int4* e, int flag, int4 v) {
  wait_until([&] {
    if (v.y == flag && v.w == flag) return true;
    v = ld_entry(e);
    return false;
  });
  return make_float2(__int_as_float(v.x), __int_as_float(v.z));
}

// The entry written with `flag`.
__device__ __forceinline__ float2 get_pair(const int4* e, int flag) {
  return entry_value(e, flag, ld_entry(e));
}

__device__ __forceinline__ float get_one(const int2* e, int flag) {
  int2 v;
  wait_until([&] {
    asm volatile("ld.volatile.global.v2.s32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y)
                 : "l"(e)
                 : "memory");
    return v.y == flag;
  });
  return __int_as_float(v.x);
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

// ---- row slots and edge values of (b), (d) and (e) --------------------------
//
// Edge values of block b (EDGE = 12 floats a round in (d) and (e); (b)
// lays the same values out for its bulk copies, wide::EDGE_IN): [0..3] row
// p at columns (p, p2, x, q), [4..7] row p2 at the same columns, where p,
// p2, x, q are the labels at positions lo-1, half+lo-1, lo+1, half+lo+1
// (the top edge: next round's pair lo takes row p from block b-1 and row p2,
// which block b sends to b-1); [8..11] rows y and q at columns (y, q),
// labels at positions hi and half+hi (the bottom edge: next round's pair
// hi-1 takes row q from block b+1 and row y, which b sends to b+1).

// Where local position l's slot comes from in this round's move, in block b
// of nblk with K local pairs: an index into the slot table (entries 2K, 2K+1
// are the free slots, which receive the rows from blocks b-1 and b+1).
__host__ __device__ __forceinline__ int slot_src(int l, int b, int K, int nblk) {
  if (l < K)  // top positions
    return b == 0 ? (l == 0 ? 0 : l == 1 ? K : l - 1) : (l == 0 ? 2 * K : l - 1);
  if (l < 2 * K - 1) return l + 1;  // bottom positions but the last
  if (l == 2 * K - 1) return b == nblk - 1 ? K - 1 : 2 * K + 1;
  if (l == 2 * K) return b == 0 ? 2 * K : b == nblk - 1 ? 2 * K + 1 : K - 1;  // the new free slots
  return b == 0 ? K - 1 : K;
}

// Slot of local position l after this round's move (slot table sl).
__device__ __forceinline__ int next_slot(const int* sl, int l, int b, int K, int nblk) {
  return sl[slot_src(l, b, K, nblk)];
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

// ---- (d) one cooperative launch over the card ------------------------------

// Eigenvector rows of B1 in (d): none (B2), in shared memory beside A's rows,
// or in the output itself, by label.
enum { V_NONE = 0, V_SMEM = 1, V_GLOBAL = 2 };

__host__ __device__ constexpr int grid_pairs_max(int mp, int G) { return (mp / 2 + G - 1) / G; }
__host__ __device__ constexpr int grid_slots(int mp, int G) {
  return 2 * grid_pairs_max(mp, G) + 2;
}
// Shared memory of a block (ops/jacobi.py::smem_bytes mirrors it): row
// records [2][KM] (16 B), A's rows [S][mp] (V_SMEM: and V's), the round's
// angles [half] (8 B), labels [2][half], slot tables [2][S], edge values.
__host__ __device__ constexpr int grid_bytes(int mp, int G, int vm) {
  return 32 * grid_pairs_max(mp, G) + 4 * grid_slots(mp, G) * mp * (vm == V_SMEM ? 2 : 1) +
         16 * (mp / 2) + 8 * grid_slots(mp, G) + 4 * EDGE;
}
// Exchange buffers of one matrix in global memory, in int32 words, of
// flagged entries: angles [2][half] (c, s), leaving rows [G][2][2][mp/2] (two
// values an entry; V_SMEM: and V's), edge values [G][2][8] (one an entry),
// each indexed by the parity of the round that reads it; V_GLOBAL: a flag
// per block, the last round whose eigenvector rows it has written (4 words
// apart).
__host__ __device__ constexpr long long grid_scratch(int mp, int G, int vm) {
  return 4LL * mp + 8LL * G * mp * (vm == V_SMEM ? 2 : 1) + 32LL * G + 4LL * G;
}

// The SMs of the current device: "grid" plans one block on each.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

struct GridPlan {
  int per;  // matrices a launch holds at once
  int G;    // blocks per matrix
  int vm;   // V_NONE, V_SMEM or V_GLOBAL
  bool ok;  // the shape fits the regime
};

// The plan of nb matrices at padded size mp on a card of `sms` SMs, one
// block each (mirrored by ops/jacobi.py::grid_plan): as many matrices at once
// as leave each matrix enough of the blocks to hold its rows (A's; B1's
// eigenvector rows go to global memory where they do not fit beside them),
// the rest in further launches. A block needs two pairs (block 0 two top
// positions, every block distinct edge pairs) and at most one warp of angle
// threads.
GridPlan grid_plan(int nb, int mp, bool vec, int sms) {
  const int half = mp / 2;
  auto fits = [&](int G) {
    return G >= 1 && half / G >= 2 && grid_pairs_max(mp, G) <= 32 &&
           grid_bytes(mp, G, vec ? V_GLOBAL : V_NONE) <= SMEM_MAX;
  };
  auto blocks_for = [&](int per) {
    return sms / per < half / 2 ? sms / per : half / 2;
  };
  int per = nb < sms ? nb : sms;
  while (per > 1 && !fits(blocks_for(per))) --per;
  if (per < 1) per = 1;
  const int G = blocks_for(per);
  const int vm = !vec ? V_NONE : grid_bytes(mp, G, V_SMEM) <= SMEM_MAX ? V_SMEM : V_GLOBAL;
  return {per, G, vm, fits(G)};
}

__device__ __forceinline__ void rot_pair4(float4& x, float4& y, float c, float s) {
  rot_pair(x.x, y.x, c, s);
  rot_pair(x.y, y.y, c, s);
  rot_pair(x.z, y.z, c, s);
  rot_pair(x.w, y.w, c, s);
}

// V_SMEM: rotates the eigenvector rows of the K local pairs, which sit in
// the slots of A's (rr's records), 16 bytes a step, on threads t0..NTR-1.
__device__ void rotate_slot_rows(float* V, const int4* rr, int K, int mp, int t0) {
  const int m4 = mp / 4;
  for (int e = (int)threadIdx.x - t0; e >= 0 && e < K * m4; e += NTR - t0) {
    const int i = e / m4, c = 4 * (e - i * m4);
    const int4 rec = rr[i];
    float4* vp = reinterpret_cast<float4*>(V + rec.x + c);
    float4* vq = reinterpret_cast<float4*>(V + rec.y + c);
    float4 x = *vp, y = *vq;
    rot_pair4(x, y, __int_as_float(rec.z), __int_as_float(rec.w));
    *vp = x;
    *vq = y;
  }
}

// V_GLOBAL: the same on the rows of the output vt, by label (pq, ang: the K
// local pairs' labels and angles). Another block rotated them the round
// before: read and written through L2 (__ldcg, __stcg), never a stale L1,
// after that block's flags (see grid_kernel).
__device__ void rotate_label_rows(float* vt, const int* pq, const float2* ang, int K, int mp,
                                  int t0) {
  const int m4 = mp / 4;
  for (int e = (int)threadIdx.x - t0; e >= 0 && e < K * m4; e += NTR - t0) {
    const int i = e / m4, c = 4 * (e - i * m4);
    const int v = pq[i];
    float4* vp = reinterpret_cast<float4*>(vt + (size_t)pq_p(v) * mp + c);
    float4* vq = reinterpret_cast<float4*>(vt + (size_t)pq_q(v) * mp + c);
    float4 x = __ldcg(vp), y = __ldcg(vq);
    rot_pair4(x, y, ang[i].x, ang[i].y);
    __stcg(vp, x);
    __stcg(vq, y);
  }
}

// Grid (per * G) blocks of NTR threads, launched cooperatively (so that all
// are resident: a block waits for others' entries): blocks [y G, (y + 1) G)
// hold matrix y of the launch, block b its pair positions [lo, hi) =
// pair_lo(b, half, G) as in (b). x0, x1 as in sm_kernel (under V_GLOBAL x0
// holds the eigenvector rows from the start); scratch: grid_scratch words
// per matrix, zeroed.
//
// A round r: each thread waits for its entries of round r (flag r) in the
// exchange buffers, published the round before: every angle of the round,
// the rows arriving from the neighbours, their edge values; __syncthreads();
// lane l < K of warp 0 reads the three 2x2 blocks of the next-round angle
// of pair lo + l (local rows, or edge values at the two edge pairs), while
// the other warps advance the labels and the slot table; __syncthreads();
// those lanes compute the next angles and publish them, while warps 1..31
// rotate the local rows (and B1's eigenvector rows); __syncthreads(); the
// two leaving rows and the edge values the neighbours need go out. No
// barrier: a block waits only for the entries it reads. The buffers are
// double buffered by round parity, and a block can be at most one round
// ahead of another's reads: it needs every block's angles of its round,
// which each block publishes after it has read the round before. Under
// V_GLOBAL the eigenvector rows are rotated last in the round, after the
// block has waited for the flags of the neighbours that rotated them the
// round before (rows move only between neighbours); then it fences and
// sets its own flag.
template <int VM>
__global__ void __launch_bounds__(NTR)
grid_kernel(const float* __restrict__ a_in, float* x0, float* x1, int* scratch, int mp,
            int nrounds, int G) {
  extern __shared__ int4 smem4[];
  const int mat = blockIdx.x / G, b = blockIdx.x - mat * G;
  const int half = mp / 2, tid = threadIdx.x, KM = grid_pairs_max(mp, G), S = 2 * KM + 2;
  const int lo = pair_lo(b, half, G), hi = pair_lo(b + 1, half, G), K = hi - lo, m2 = mp / 2;
  const bool top_edge = b > 0, bottom_edge = b < G - 1;
  int4* rr = smem4;                                     // [2][KM]: records of the local pairs
  float* rows = reinterpret_cast<float*>(rr + 2 * KM);  // [S][mp], 16-byte aligned
  float* V = rows + S * mp;                             // V_SMEM: [S][mp], A's slots
  float2* ang = reinterpret_cast<float2*>(V + (VM == V_SMEM ? S * mp : 0));  // [half]
  int* pq = reinterpret_cast<int*>(ang + half);         // [2][half]
  int* slt = pq + 2 * half;                             // [2][S]
  float* edge = reinterpret_cast<float*>(slt + 2 * S);  // [EDGE]: edge values
  int4* gang = reinterpret_cast<int4*>(scratch + (size_t)mat * grid_scratch(mp, G, VM));
  int4* grow = gang + mp;
  int4* gvrow = grow + (size_t)2 * G * mp;  // V_SMEM
  int2* gedge = reinterpret_cast<int2*>(gvrow + (VM == V_SMEM ? (size_t)2 * G * mp : 0));
  int* vdone = reinterpret_cast<int*>(gedge + (size_t)16 * G);  // V_GLOBAL: [G], 4 apart
  float* vt = x0 + (size_t)mat * mp * mp;
  // a block's two leaving rows for a round, mp/2 entries each: side 0 its
  // last top row (to blk + 1), side 1 its first bottom row (to blk - 1)
  auto out_row = [&](int4* base, int blk, int par, int side) {
    return base + (((size_t)blk * 2 + par) * 2 + side) * (mp / 2);
  };
  auto edge_out = [&](int blk, int par) { return gedge + ((size_t)blk * 2 + par) * 8; };
  // the leaving rows of a row array (the slots of local positions K-1 and
  // K in table sl) into dst (side 0, then side 1), with their round's flag
  auto publish_leaving = [&](const float* from, const int* sl, int4* dst, int flag) {
    for (int e = tid; e < 2 * m2; e += NTR) {
      const int side = e / m2, k = e - side * m2;
      if (side == 0 ? bottom_edge : top_edge) {
        const int slot = side == 0 ? sl[K - 1] : sl[K];
        const float2 v = reinterpret_cast<const float2*>(from + slot * mp)[k];
        put_pair(dst + (size_t)side * m2 + k, v.x, v.y, flag);
      }
    }
  };
  // round 0, as in (b): the local rows, every angle and the edge values
  // straight from the input; position i holds label i
  const float* a = a_in + (size_t)mat * mp * mp;
  for (int e = tid; e < 2 * K * mp; e += NTR) {
    const int l = e / mp, c = e - l * mp;
    const int label = l < K ? lo + l : half + lo + l - K;
    rows[l * mp + c] = a[(size_t)label * mp + c];
    if (VM == V_SMEM) V[l * mp + c] = c == label ? 1.0f : 0.0f;
    if (VM == V_GLOBAL) __stcg(vt + (size_t)label * mp + c, c == label ? 1.0f : 0.0f);
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
      rr[l] = make_int4(l * mp, (K + l) * mp, __float_as_int(c), __float_as_int(s));
    }
  }
  if (tid < EDGE) {
    const int tp[4] = {lo - 1, half + lo - 1, lo + 1, half + lo + 1};
    const int bt[2] = {hi, half + hi};
    if (tid < 8 && top_edge) edge[tid] = a[(size_t)tp[tid / 4] * mp + tp[tid % 4]];
    if (tid >= 8 && bottom_edge) edge[tid] = a[(size_t)bt[(tid - 8) / 2] * mp + bt[tid % 2]];
  }
  __syncthreads();
  for (int r = 0; r < nrounds; ++r) {
    const int cur = r & 1, nx = cur ^ 1;
    const int* pqc = pq + cur * half;
    const int* sl = slt + cur * S;
    const bool more = r + 1 < nrounds;
    if (r > 0) {
      for (int k = tid; k < half; k += NTR) ang[k] = get_pair(gang + cur * half + k, r);
      // block b-1's last top row into local position 0, block b+1's first
      // bottom row into local position 2K - 1 (this round's free slots)
      for (int e = tid; e < 2 * m2; e += NTR) {
        const int side = e / m2, c = e - side * m2;
        if (side == 0 ? top_edge : bottom_edge) {
          const int blk = side == 0 ? b - 1 : b + 1, slot = side == 0 ? sl[0] : sl[2 * K - 1];
          reinterpret_cast<float2*>(rows + slot * mp)[c] =
              get_pair(out_row(grow, blk, cur, side) + c, r);
          if (VM == V_SMEM)
            reinterpret_cast<float2*>(V + slot * mp)[c] =
                get_pair(out_row(gvrow, blk, cur, side) + c, r);
        }
      }
      if (tid < 4 && top_edge) edge[tid] = get_one(edge_out(b - 1, cur) + tid, r);
      if (tid >= 4 && tid < 6 && bottom_edge)
        edge[6 + tid] = get_one(edge_out(b + 1, cur) + tid, r);
      __syncthreads();
    }
    const bool angle = more && tid < K;
    const int l = tid;
    NextPair n;
    Quad bpp, bpq, bqq;
    if (angle) {
      n = next_pair_of(lo + l, half);
      const int vp = pqc[n.ip], vq = pqc[n.iq];
      auto local = [&](int i, int v) {
        return load_quad(rows, sl[i - lo] * mp, sl[K + i - lo] * mp, pq_p(v), pq_q(v));
      };
      if (top_edge && l == 0) {  // pair ip = lo - 1 is block b-1's
        bpp = {edge[0], edge[1], edge[4], edge[5]};
        bpq = {edge[2], edge[3], edge[6], edge[7]};
        bqq = local(n.iq, vq);
      } else if (bottom_edge && l == K - 1) {  // pair iq = hi is block b+1's
        bpp = local(n.ip, vp);
        bpq = local(n.ip, vq);
        bqq = {edge[8], edge[9], edge[10], edge[11]};
      } else {
        bpp = local(n.ip, vp);
        bpq = local(n.ip, vq);
        bqq = local(n.iq, vq);
      }
    }
    if (more && tid >= 32 && tid < NTR - 32)
      for (int k = tid - 32; k < half; k += NTR - 64) pq[nx * half + k] = next_pair(pqc, k, half);
    if (more && tid >= NTR - 32)
      for (int j = tid - (NTR - 32); j < 2 * K + 2; j += 32)
        slt[nx * S + j] = next_slot(sl, j, b, K, G);
    __syncthreads();
    if (angle) {
      float apq, aqq, c, s;
      const float app = next_angle_inputs(bpp, bpq, bqq, n, ang, apq, aqq);
      rotation(app, apq, aqq, c, s);
      put_pair(gang + nx * half + lo + l, c, s, r + 1);  // every block reads it next round
      rr[nx * KM + l] = make_int4(next_slot(sl, l, b, K, G) * mp,
                                  next_slot(sl, K + l, b, K, G) * mp, __float_as_int(c),
                                  __float_as_int(s));
    }
    rotate_rows(rows, rr + cur * KM, K, pqc, ang, half, 1);
    if (VM == V_SMEM) rotate_slot_rows(V, rr + cur * KM, K, mp, 32);
    __syncthreads();
    if (more) {
      // edge values of round r+1 (the last warp), as in (b): the
      // neighbours' go to the exchange buffer, the block's own stay in
      // shared memory
      if (tid >= NTR - 32 && tid < NTR - 32 + EDGE) {
        const int i = tid - (NTR - 32);
        if (i < 4 && bottom_edge) {  // block b+1's row p: position hi-1 next round
          const int tp[4] = {hi - 1, half + hi - 1, hi + 1, half + hi + 1};
          put_one(edge_out(b, nx) + i,
                  rows[next_slot(sl, K - 1, b, K, G) * mp + next_label(pqc, tp[i], half)],
                  r + 1);
        } else if (i >= 4 && i < 8 && top_edge) {  // own row p2: now the first bottom row
          const int tp[4] = {lo - 1, half + lo - 1, lo + 1, half + lo + 1};
          edge[i] = rows[sl[K] * mp + next_label(pqc, tp[i - 4], half)];
        } else if (i >= 8 && i < 10 && bottom_edge) {  // own row y: now the last top row
          const int bt[2] = {hi, half + hi};
          edge[i] = rows[sl[K - 1] * mp + next_label(pqc, bt[i - 8], half)];
        } else if (i >= 10 && top_edge) {  // block b-1's row q: position half+lo next round
          const int bt[2] = {lo, half + lo};
          put_one(edge_out(b, nx) + 4 + (i - 10),
                  rows[next_slot(sl, K, b, K, G) * mp + next_label(pqc, bt[i - 10], half)],
                  r + 1);
        }
      }
      publish_leaving(rows, sl, out_row(grow, b, nx, 0), r + 1);
      if (VM == V_SMEM) publish_leaving(V, sl, out_row(gvrow, b, nx, 0), r + 1);
    }
    // V_GLOBAL: round r's rotation of the eigenvector rows in the output,
    // after A's rows and the angles are out (no angle depends on them),
    // while the next round's entries are on their way
    if (VM == V_GLOBAL) {
      // the rows' last owners (this block and its neighbours) are done
      // with them: their round r-1 tails set their flags to r
      if (r > 0 && tid < 2 && (tid == 0 ? top_edge : bottom_edge)) {
        const int* f = vdone + 4 * (tid == 0 ? b - 1 : b + 1);
        wait_until([&] {
          int v;
          asm volatile("ld.volatile.global.s32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
          return v >= r;
        });
        __threadfence();
      }
      __syncthreads();
      rotate_label_rows(vt, pqc + lo, ang + lo, K, mp, 0);
      __syncthreads();
      if (more && tid == 0) {
        __threadfence();
        asm volatile("st.volatile.global.s32 [%0], %1;" ::"l"(vdone + 4 * b), "r"(r + 1)
                     : "memory");
      }
    }
    if (!more) break;  // the last round moves nothing
  }
  const int last = (nrounds - 1) & 1;
  const int* pqf = pq + last * half;
  const int* sl = slt + last * S;
  auto label = [&](int l) { return label_at(pqf, l < K ? lo + l : half + lo + l - K, half); };
  if (VM == V_NONE) {
    for (int l = tid >> 5; l < 2 * K; l += NW)
      gersh_row(rows + sl[l] * mp, label(l), mp, x0 + (size_t)mat * mp, x1 + (size_t)mat * mp);
    return;
  }
  for (int l = tid; l < 2 * K; l += NTR)
    x1[(size_t)mat * mp + label(l)] = rows[sl[l] * mp + label(l)];
  if (VM == V_SMEM)
    for (int e = tid; e < 2 * K * (mp / 4); e += NTR) {
      const int l = e / (mp / 4), c = e - l * (mp / 4);
      reinterpret_cast<float4*>(vt + (size_t)label(l) * mp)[c] =
          reinterpret_cast<const float4*>(V + sl[l] * mp)[c];
    }
}

// ---- (e) one portable cluster per matrix, point to point -------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// The one arrival of the barrier's current phase, which then completes
// once `bytes` have landed (they may land before it).
__device__ __forceinline__ void mbar_arm(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete; traps after
// WAIT_NS, so that a fault ends the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned long long t0 = 0;
  for (unsigned k = 0;; ++k) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((k & 255) == 255) {  // the clock only on a long wait
      if (t0 == 0) t0 = now_ns();
      else if (now_ns() - t0 > WAIT_NS) __trap();
    }
  }
}

// The same place as `local` in the shared memory of block `rank` of the
// cluster.
__device__ __forceinline__ unsigned remote(const void* local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(local)), "r"(rank));
  return r;
}

// Stores v at the place of dst in block `rank`, counting its bytes on that
// block's barrier `bar` (st.async: the bytes complete the barrier's
// transaction count, so the receiver sees them once its phase completes).
__device__ __forceinline__ void st_remote(float* dst, int rank, float v, unsigned long long* bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(remote(dst, rank)), "r"(__float_as_uint(v)), "r"(remote(bar, rank))
               : "memory");
}
__device__ __forceinline__ void st_remote(float2* dst, int rank, float2 v,
                                          unsigned long long* bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               ::"r"(remote(dst, rank)), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
               "r"(remote(bar, rank))
               : "memory");
}
__device__ __forceinline__ void st_remote(float4* dst, int rank, float4 v,
                                          unsigned long long* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(remote(dst, rank)), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(remote(bar, rank))
      : "memory");
}

namespace dsmem {

constexpr int NTH = 256;       // threads per block
constexpr int NWD = NTH / 32;  // warps per block
constexpr int BLOCKS = 16;     // blocks per cluster (non-portable; ops/jacobi.py::DSMEM_CLUSTER)

__host__ __device__ constexpr int pairs_max(int mp) { return (mp / 2 + BLOCKS - 1) / BLOCKS; }
__host__ __device__ constexpr int slots(int mp) { return 2 * pairs_max(mp) + 2; }
// Shared memory of a block (ops/jacobi.py::smem_bytes mirrors it): two
// mbarriers, A's rows [S][mp] (B1: and the eigenvector rows beside them),
// row records [KM] (16 B), the angles [3][mp/2] (8 B), the labels by
// position [2][mp] and label_src's table [mp], three slot tables [2][3 S]
// (the block's and its two neighbours') and their gather map [3 S], edge
// values [2][EDGE].
__host__ __device__ constexpr int bytes(int mp, bool vec) {
  return 16 + 4 * slots(mp) * mp * (vec ? 2 : 1) + 16 * pairs_max(mp) + 24 * mp + 36 * slots(mp) +
         8 * EDGE;
}

// Named barrier 1: warp 0 arrives once its lanes hold the 2x2 blocks of the
// next angles; the other warps wait there before they rotate.
__device__ __forceinline__ void quads_read() {
  __syncwarp();
  asm volatile("barrier.cta.arrive 1, %0;" ::"n"(NTH) : "memory");
}
__device__ __forceinline__ void wait_quads_read() {
  asm volatile("barrier.cta.sync 1, %0;" ::"n"(NTH) : "memory");
}
// Named barrier 2, warps 1.. alone: the local rows are rotated.
__device__ __forceinline__ void rows_rotated() {
  asm volatile("barrier.cta.sync 2, %0;" ::"n"(NTH - 32) : "memory");
}

// Grid (C, nmat), clusters of C = BLOCKS blocks: cluster y holds
// matrix y, block b its pair positions [lo, hi) = pair_lo(b, mp/2, C), in
// row slots through a slot table, as (d) lays them out; under B1 the
// eigenvector rows sit in the same slots of a second row array. x0, x1 as
// in sm_kernel.
//
// A round r: every thread waits on the block's barrier of the round's
// parity for what the round brings (the other blocks' angles of round r,
// the two arriving rows, already in their slots, and the neighbours' edge
// values). Warp 0: lane l < K reads the three 2x2 blocks of the next angle
// of pair lo + l, the warp arrives at named barrier 1, those lanes compute
// the next angles, and the warp's 32 lanes store them into every other
// block (st.async). Warps 1..: they gather the next round's labels and
// slot tables (the block's, and its copies of the neighbours', which say
// where the leaving rows go) through fixed index tables and write the local
// pairs' row records; wait at barrier 1; rotate the local rows (and B1's
// eigenvector rows), each thread one column pair down its row pairs; sync
// among themselves (named barrier 2); then they take 16 bytes of each
// leaving row an item (B1: of the eigenvector rows too) and store them into
// the neighbours' free slots, and the last warp stores the edge values the
// neighbours need. One __syncthreads() ends the round. So
// the rows leave while warp 0 still computes or sends angles. No cluster
// barrier: each store counts its bytes on the receiver's barrier, and a
// block waits only for what it reads. The loop is short and nearly free of
// branches: a round is a chain of a few hundred instructions, most of them
// one warp's, and two DSMEM stores' flight.
//
// Why the buffers suffice. A block's round r+2 stores need every block's
// round r+1 angles, which a block sends only after its wait of round r:
// so a barrier (by round parity) never takes bytes of a phase still open,
// and the angles, three buffers by round, never land in a buffer still read
// (round r's, by the rotation beside the sends of round r+1's). Labels,
// slot tables and edge values are double buffered by parity: a round reads
// what the round before wrote, and writes what the next reads, before the
// __syncthreads() that ends it. A row lands in the slot its receiver's own
// leaving row vacated the round before; the receiver read that row (to
// send it, and items w < 6 the edge values they keep from it) before it
// sent the row the sender waits for, because each pushing item loads its
// part of both leaving rows before it stores either.
template <bool VEC>
__global__ void __launch_bounds__(NTH)
cluster_kernel(const float* __restrict__ a_in, float* x0, float* x1, int mp, int nrounds) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int4 smem4[];
  constexpr int C = BLOCKS;
  const int b = (int)cluster.block_rank(), mat = blockIdx.y;
  const int half = mp / 2, tid = threadIdx.x, S = slots(mp), T = 3 * S, m4 = mp / 4;
  const int lo = pair_lo(b, half, C), hi = pair_lo(b + 1, half, C), K = hi - lo;
  const bool top_edge = b > 0, bottom_edge = b < C - 1;
  const int Kdn = top_edge ? lo - pair_lo(b - 1, half, C) : 0;     // K of block b - 1
  const int Kup = bottom_edge ? pair_lo(b + 2, half, C) - hi : 0;  // K of block b + 1
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem4);  // [2]
  float* rows = reinterpret_cast<float*>(smem4 + 1);    // [S][mp], 16-byte aligned
  float* V = rows + S * mp;                              // B1: [S][mp], A's slots
  int4* rr = reinterpret_cast<int4*>(V + (VEC ? S * mp : 0));  // [KM]: row offsets, c, s
  float2* ang = reinterpret_cast<float2*>(rr + pairs_max(mp));  // [3][half]
  int* lab = reinterpret_cast<int*>(ang + 3 * half);    // [2][mp]: label at each position
  int* src = lab + 2 * mp;                               // [mp]: label_src
  int* tab = src + mp;    // [2][T]: slot tables of this block, block b+1, block b-1 (S each)
  int* gat = tab + 2 * T;                                // [T]: tab_next[e] = tab[gat[e]]
  float* edge = reinterpret_cast<float*>(gat + T);      // [2][EDGE]: edge values
  // round 0, as in (d): the local rows, every angle and the edge values
  // straight from the input; position i holds label i
  const float* a = a_in + (size_t)mat * mp * mp;
  for (int e = tid; e < 2 * K * mp; e += NTH) {
    const int l = e / mp, c = e - l * mp;
    const int label = l < K ? lo + l : half + lo + l - K;
    rows[l * mp + c] = a[(size_t)label * mp + c];
    if (VEC) V[l * mp + c] = c == label ? 1.0f : 0.0f;
  }
  for (int x = tid; x < mp; x += NTH) {
    lab[x] = x;
    src[x] = label_src(x, half, mp);
  }
  for (int e = tid; e < T; e += NTH) {
    const int t = e / S, l = e - t * S, Kt = t == 0 ? K : t == 1 ? Kup : Kdn;
    const bool used = Kt > 0 && l < 2 * Kt + 2;  // block 0 has no b-1, block C-1 no b+1
    tab[e] = l;
    gat[e] = used ? t * S + slot_src(l, t == 0 ? b : t == 1 ? b + 1 : b - 1, Kt, C) : e;
  }
  for (int k = tid; k < half; k += NTH) {
    float c, s;
    rotation(a[(size_t)k * mp + k], a[(size_t)k * mp + k + half],
             a[(size_t)(k + half) * mp + k + half], c, s);
    ang[k] = make_float2(c, s);
  }
  if (tid < EDGE) {
    const int tp[4] = {lo - 1, half + lo - 1, lo + 1, half + lo + 1};
    const int bt[2] = {hi, half + hi};
    if (tid < 8 && top_edge) edge[tid] = a[(size_t)tp[tid / 4] * mp + tp[tid % 4]];
    if (tid >= 8 && bottom_edge) edge[tid] = a[(size_t)bt[(tid - 8) / 2] * mp + bt[tid % 2]];
  }
  // lane l < K of warp 0: the next pair lo + l takes its rows from pairs ip
  // and iq; lane 0's pair ip and lane K-1's pair iq are the neighbours',
  // whose 2x2 blocks come as edge values
  const NextPair nxp = next_pair_of(lo + (tid < K ? tid : 0), half);
  const bool e_top = top_edge && tid == 0, e_bot = bottom_edge && tid == K - 1;
  const int li = (e_top ? nxp.iq : nxp.ip) - lo, lj = (e_bot ? nxp.ip : nxp.iq) - lo;
  // warp 0's sends: item e = lane + 32 t is pair e % K to the (e / K + 1)-th
  // block after b
  const int nsend = K * (C - 1), dp = 32 % K, dq = 32 / K;
  const int p0 = tid % K, q0 = (tid & 31) / K;
  // rotating threads: thread u keeps column pair j0 (+ nu ...) and walks
  // row pairs g0, g0 + R, ...; under B1 then 16 bytes (column c0) of the
  // eigenvector rows of pairs h0, h0 + R4, ...
  const int u = tid - 32, nu = NTH - 32;
  const int R = nu >= half ? nu / half : 1, j0 = u % half, g0 = u / half;
  const int R4 = nu / m4 > 0 ? nu / m4 : 1, c0 = u % m4, h0 = u / m4;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // the barriers are set, and every block runs, before any remote store
  // bytes a round brings: the other blocks' angles, and from each
  // neighbour a row (B1: two) and its edge values (4 from b-1, 2 from b+1)
  const unsigned row_bytes = 4u * mp * (VEC ? 2 : 1);
  const unsigned expect = 8u * (half - K) + (top_edge ? row_bytes + 16 : 0) +
                          (bottom_edge ? row_bytes + 8 : 0);
  for (int r = 0; r < nrounds; ++r) {
    const int cur = r & 1, nx = cur ^ 1, b3 = r % 3, n3 = b3 == 2 ? 0 : b3 + 1;
    const int* labc = lab + cur * mp;
    int* labn = lab + nx * mp;
    const int* tc = tab + cur * T;
    int* tn = tab + nx * T;
    const float2* angc = ang + b3 * half;
    float2* angn = ang + n3 * half;
    const float* ec = edge + cur * EDGE;
    const bool more = r + 1 < nrounds;
    if (r > 0) {
      if (tid == 0) mbar_arm(bar + cur, expect);
      mbar_wait(bar + cur, ((r - 1) >> 1) & 1);
    }
    // the pushing threads' slots: the two leaving rows, the neighbours' free slots
    const int s_top = tc[K - 1], s_bot = tc[K], f_up = tc[S + 2 * Kup], f_dn = tc[2 * S + 2 * Kdn + 1];
    if (tid < 32) {
      const bool angle = more && tid < K;
      Quad bpp, bpq, bqq;
      if (angle) {
        const int pc0 = labc[nxp.ip], pc1 = labc[nxp.ip + half];
        const int qc0 = labc[nxp.iq], qc1 = labc[nxp.iq + half];
        const int ri0 = tc[li] * mp, ri1 = tc[K + li] * mp, rj0 = tc[lj] * mp, rj1 = tc[K + lj] * mp;
        const Quad lpp = load_quad(rows, ri0, ri1, pc0, pc1), lpq = load_quad(rows, ri0, ri1, qc0, qc1);
        const Quad lqq = load_quad(rows, rj0, rj1, qc0, qc1);
        bpp = e_top ? Quad{ec[0], ec[1], ec[4], ec[5]} : lpp;
        bpq = e_top ? Quad{ec[2], ec[3], ec[6], ec[7]} : lpq;
        bqq = e_bot ? Quad{ec[8], ec[9], ec[10], ec[11]} : lqq;
      }
      quads_read();
      float c = 1.0f, s = 0.0f;
      if (angle) {
        float apq, aqq;
        const float app = next_angle_inputs(bpp, bpq, bqq, nxp, angc, apq, aqq);
        rotation(app, apq, aqq, c, s);
        angn[lo + tid] = make_float2(c, s);
      }
      if (more) {  // the K new angles into every other block, spread over the warp
        int p = p0, q = q0;
        for (int e = tid; e - tid < nsend; e += 32) {
          const float cx = __shfl_sync(0xffffffffu, c, p), sx = __shfl_sync(0xffffffffu, s, p);
          const int dst = b + 1 + q;
          if (e < nsend) st_remote(angn + lo + p, dst < C ? dst : dst - C, make_float2(cx, sx), bar + nx);
          p += dp;
          q += dq;
          if (p >= K) {
            p -= K;
            ++q;
          }
        }
      }
    } else {
      if (more)  // the next round's labels and slot tables
        for (int x = u; x < mp + T; x += nu) {
          if (x < mp) labn[x] = labc[src[x]];
          else tn[x - mp] = tc[gat[x - mp]];
        }
      for (int i = u; i < K; i += nu) {
        const float2 ai = angc[lo + i];
        rr[i] = make_int4(tc[i] * mp, tc[K + i] * mp, __float_as_int(ai.x), __float_as_int(ai.y));
      }
      wait_quads_read();  // warp 0 holds its 2x2 blocks; the records are written
      // J^T A J on the local rows: column pair j, row pairs g0, g0 + R, ...
      if (g0 < R)
        for (int j = j0; j < half; j += nu) {
          const int cr = labc[j], cs = labc[j + half];
          const float2 aj = angc[j];
#pragma unroll 2
          for (int i = g0; i < K; i += R) {
            const int4 rec = rr[i];
            float* rp = rows + rec.x;
            float* rq = rows + rec.y;
            rot2x2(rp[cr], rp[cs], rq[cr], rq[cs], __int_as_float(rec.z), __int_as_float(rec.w),
                   aj.x, aj.y);
          }
        }
      if (VEC && h0 < R4)  // the eigenvector rows, 16 bytes an item
        for (int c4 = c0; c4 < m4; c4 += nu) {
#pragma unroll 2
          for (int i = h0; i < K; i += R4) {
            const int4 rec = rr[i];
            float4* vp = reinterpret_cast<float4*>(V + rec.x) + c4;
            float4* vq = reinterpret_cast<float4*>(V + rec.y) + c4;
            float4 x = *vp, y = *vq;
            rot_pair4(x, y, __int_as_float(rec.z), __int_as_float(rec.w));
            *vp = x;
            *vq = y;
          }
        }
      if (more) {
        rows_rotated();
        for (int w = u; w < (VEC ? 2 : 1) * m4; w += nu) {
          // items w < 6 first keep, for lanes 0 and K-1 of the next round,
          // the edge values that lie in a leaving row: row p2 (now the first
          // bottom row, leaving for b-1) at the labels of positions lo-1,
          // half+lo-1, lo+1, half+lo+1, and row y (now the last top row,
          // leaving for b+1) at those of hi, half+hi
          if (w < 4 && top_edge)
            edge[nx * EDGE + 4 + w] =
                rows[s_bot * mp + labn[(w & 1 ? half : 0) + lo + (w & 2 ? 1 : -1)]];
          if (w >= 4 && w < 6 && bottom_edge)
            edge[nx * EDGE + 4 + w] = rows[s_top * mp + labn[(w & 1) * half + hi]];
          // 16 bytes of each leaving row (w >= mp/4: of the eigenvector
          // rows), both loaded before either is stored: the last top row
          // into block b+1's free slot, the first bottom row into block b-1's
          float* M = VEC && w >= m4 ? V : rows;
          const int c = 4 * (w < m4 ? w : w - m4);
          float4 vt, vb;
          if (bottom_edge) vt = *reinterpret_cast<const float4*>(M + s_top * mp + c);
          if (top_edge) vb = *reinterpret_cast<const float4*>(M + s_bot * mp + c);
          if (bottom_edge) st_remote(reinterpret_cast<float4*>(M + f_up * mp + c), b + 1, vt, bar + nx);
          if (top_edge) st_remote(reinterpret_cast<float4*>(M + f_dn * mp + c), b - 1, vb, bar + nx);
        }
        // the neighbours' edge values from rows that stay, as in (b):
        // block b+1's row p (position hi-1 next round) at positions hi-1,
        // half+hi-1, hi+1, half+hi+1; block b-1's row q (position half+lo
        // next round) at lo, half+lo
        const int i = tid - (NTH - 32);
        if (i >= 0 && i < 4 && bottom_edge)
          st_remote(edge + nx * EDGE + i, b + 1,
                    rows[tn[K - 1] * mp + labn[(i & 1 ? half : 0) + hi + (i & 2 ? 1 : -1)]],
                    bar + nx);
        if (i >= 4 && i < 6 && top_edge)
          st_remote(edge + nx * EDGE + 6 + i, b - 1, rows[tn[K] * mp + labn[(i & 1) * half + lo]],
                    bar + nx);
      }
    }
    __syncthreads();
  }
  const int last = (nrounds - 1) & 1;
  const int* labf = lab + last * mp;
  const int* tf = tab + last * T;
  auto label = [&](int l) { return labf[l < K ? lo + l : half + lo + l - K]; };
  if (VEC) {
    for (int l = tid; l < 2 * K; l += NTH)
      x1[(size_t)mat * mp + label(l)] = rows[tf[l] * mp + label(l)];
    float* vt = x0 + (size_t)mat * mp * mp;
    for (int e = tid; e < 2 * K * m4; e += NTH) {
      const int l = e / m4, c = e - l * m4;
      reinterpret_cast<float4*>(vt + (size_t)label(l) * mp)[c] =
          reinterpret_cast<const float4*>(V + tf[l] * mp)[c];
    }
  } else {
    for (int l = tid >> 5; l < 2 * K; l += NWD)
      gersh_row(rows + tf[l] * mp, label(l), mp, x0 + (size_t)mat * mp, x1 + (size_t)mat * mp);
  }
  cluster.sync();  // no block leaves while a peer may still address its memory
}

}  // namespace dsmem

// ---- (b) one cluster per matrix, 1024 threads a block, point to point ------

// Makes this thread's shared-memory writes visible to the bulk copies
// (the async proxy) that another thread issues after a barrier.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One arrival on a barrier of this block.
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) of this
// block's shared memory at src to cluster address dst, counting them on the
// barrier at cluster address bar (the receiver's).
__device__ __forceinline__ void bulk_remote(unsigned dst, const void* src, unsigned bytes,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

namespace wide {

constexpr int BLOCKS = 16;     // blocks per cluster (non-portable; ops/jacobi.py::CLUSTER)
constexpr int EDGE_IN = 24;    // edge values a block receives and keeps a round, free slots
constexpr int EDGE_OUT = 12;   // edge values a block sends a round, its free slots

__host__ __device__ constexpr int pairs_max(int mp) { return (mp / 2 + BLOCKS - 1) / BLOCKS; }
__host__ __device__ constexpr int slots(int mp) { return 2 * pairs_max(mp) + 2; }
// a block's angles sit in a 16-byte aligned run of ang_stride(mp) entries
__host__ __device__ constexpr int ang_stride(int mp) { return (pairs_max(mp) + 1) / 2 * 2; }
// Shared memory of a block of the matrix's cluster (ops/jacobi.py::smem_bytes
// mirrors it): three mbarriers (32 B), A's rows [S][mp], row records [2][KM]
// (16 B), the angles [3][BLOCKS][ang_stride] (8 B), warp 0's lane table
// [32] (16 B), the edge values received [2][EDGE_IN] and sent [2][EDGE_OUT],
// the slot table [2][S] (2 B).
__host__ __device__ constexpr int bytes(int mp) {
  return 32 + 4 * slots(mp) * mp + 32 * pairs_max(mp) + 24 * BLOCKS * ang_stride(mp) + 512 +
         8 * (EDGE_IN + EDGE_OUT) + 4 * slots(mp);
}
// B1's consumer block: columns [v mp / 16, (v + 1) mp / 16) of every
// eigenvector row at an even stride cols(mp), and two rounds of angles (8 B
// a pair) and labels (4 B).
__host__ __device__ constexpr int cols(int mp) { return ((mp + BLOCKS - 1) / BLOCKS + 1) / 2 * 2; }
__host__ __device__ constexpr int consumer_bytes(int mp) { return 4 * mp * cols(mp) + 12 * mp; }

// The tournament in closed form. Positions 1..mp-1 form one cycle that each
// round advances by one place (pair_table's permutation; position 0 keeps
// label 0): cyc(x) is position x's place on it (-1 for position 0), and
// after rm rounds (0 <= rm < mp - 1) place c holds the label of the
// position at place c - rm. So a thread that reads the labels of fixed
// positions keeps their places and the round modulo mp - 1, and reads no
// table.
__host__ __device__ __forceinline__ int cyc(int x, int half) {
  return x == 0 ? -1 : x < half ? x - 1 : 3 * half - 2 - x;
}
__host__ __device__ __forceinline__ int label_of(int c, int rm, int half) {
  if (c < 0) return 0;
  int d = c - rm;
  if (d < 0) d += 2 * half - 1;
  return d < half - 1 ? d + 1 : 3 * half - 2 - d;
}

// The rotation record of pair i of a block of K pairs: records 0..3 hold
// the pairs 0 and K-1, whose rows leave, and 1 and K-2, whose rows hold the
// edge values the neighbours need (rotated first), then pairs 2.. in order.
__host__ __device__ __forceinline__ int rot_pos(int i, int K) {
  return i == 0 ? 0 : i == K - 1 ? 1 : i == 1 ? 2 : i == K - 2 ? 3 : i + 2;
}

// Pair k's angle entry: entry k - lo_b of block b's run, b = ((k + 1) 16 -
// 1) / half, the block that owns pair k.
__device__ __forceinline__ int aidx(int k, int half, int KA) {
  const int o = ((k + 1) * BLOCKS - 1) / half;
  return o * KA + k - pair_lo(o, half, BLOCKS);
}

// The entry (rt: top row, ct: top column) of the 2x2 block q rotated by
// J_i^T q J_j, computed as its owner computes it (rows first, then columns;
// rot2x2) but only the operations it needs: the same bits, a third of the
// work on warp 0's chain.
__device__ __forceinline__ float rotated_entry(const Quad& q, float2 ri, float2 cj, bool rt,
                                               bool ct) {
  const float br = rt ? __fsub_rn(__fmul_rn(ri.x, q.pr), __fmul_rn(ri.y, q.qr))
                      : __fadd_rn(__fmul_rn(ri.y, q.pr), __fmul_rn(ri.x, q.qr));
  const float bs = rt ? __fsub_rn(__fmul_rn(ri.x, q.ps), __fmul_rn(ri.y, q.qs))
                      : __fadd_rn(__fmul_rn(ri.y, q.ps), __fmul_rn(ri.x, q.qs));
  return ct ? __fsub_rn(__fmul_rn(cj.x, br), __fmul_rn(cj.y, bs))
            : __fadd_rn(__fmul_rn(cj.y, br), __fmul_rn(cj.x, bs));
}

// Warp 0's lane l < K of block b: the next pair lo + l takes its rows from
// this round's pairs n.ip and n.iq, whose 2x2 blocks it reads from local
// positions li, K + li, lj, K + lj (lane 0's pair ip and lane K-1's pair iq
// are the neighbours': their blocks come as edge values) at the columns of
// places cp0.., with the angles at ai_p, ai_q; it writes its angle at
// ai_own and the nrec-th record, whose rows sit next round in this round's
// table entries sl0, sl1; next round its quads' rows sit in entries si0..
// Kept packed in shared memory (pack, unpack: places < 1024, angle entries
// < 512, table entries < 64), so that none of it holds registers across
// the loop.
struct Lane {
  NextPair n;
  int cp0, cp1, cq0, cq1, ai_p, ai_q, ai_own, nrec, sl0, sl1, si0, si1, sj0, sj1;
};

__device__ __forceinline__ int4 pack(const Lane& L) {
  return make_int4(L.cp0 + 1 | (L.cp1 + 1) << 16, L.cq0 + 1 | (L.cq1 + 1) << 16,
                   L.si0 | L.si1 << 6 | L.sj0 << 12 | L.sj1 << 18 | L.sl0 << 24,
                   L.n.ip | L.n.iq << 10 | L.n.pt << 20 | L.n.qt << 21 | L.sl1 << 22);
}

// (places are stored + 1: position 0's place is -1; ip lies in [lo-1,
// hi-2], iq in [lo+1, hi], so their owners are b-1, b and b+1)
__device__ __forceinline__ Lane unpack(int4 v, int l, int b, int lo, int hi, int K, int half,
                                       int KA) {
  Lane L;
  L.cp0 = (v.x & 0xffff) - 1, L.cp1 = (v.x >> 16) - 1, L.cq0 = (v.y & 0xffff) - 1, L.cq1 = (v.y >> 16) - 1;
  L.si0 = v.z & 63, L.si1 = v.z >> 6 & 63, L.sj0 = v.z >> 12 & 63, L.sj1 = v.z >> 18 & 63;
  L.sl0 = v.z >> 24 & 63;
  L.n.ip = v.w & 1023, L.n.iq = v.w >> 10 & 1023, L.n.pt = v.w >> 20 & 1, L.n.qt = v.w >> 21 & 1;
  L.sl1 = v.w >> 22 & 63;
  L.ai_p = L.n.ip < lo ? (b - 1) * KA + L.n.ip - pair_lo(b - 1, half, BLOCKS) : b * KA + L.n.ip - lo;
  L.ai_q = L.n.iq >= hi ? (b + 1) * KA + L.n.iq - hi : b * KA + L.n.iq - lo;
  L.ai_own = b * KA + l, L.nrec = rot_pos(l, K);
  return L;
}

// Lane l's fields that pack keeps, from its block's layout.
__device__ __forceinline__ Lane lane_of(int l, int b, int lo, int K, int half) {
  Lane L;
  L.n = next_pair_of(lo + l, half);
  const bool e_top = b > 0 && l == 0, e_bot = b < BLOCKS - 1 && l == K - 1;
  const int li = (e_top ? L.n.iq : L.n.ip) - lo, lj = (e_bot ? L.n.ip : L.n.iq) - lo;
  L.cp0 = cyc(L.n.ip, half), L.cp1 = cyc(L.n.ip + half, half);
  L.cq0 = cyc(L.n.iq, half), L.cq1 = cyc(L.n.iq + half, half);
  L.sl0 = slot_src(l, b, K, BLOCKS), L.sl1 = slot_src(K + l, b, K, BLOCKS);
  L.si0 = slot_src(li, b, K, BLOCKS), L.si1 = slot_src(K + li, b, K, BLOCKS);
  L.sj0 = slot_src(lj, b, K, BLOCKS), L.sj1 = slot_src(K + lj, b, K, BLOCKS);
  return L;
}

// Named barrier 1: warp 0 arrives once its lanes hold the 2x2 blocks of the
// next angles; the warps whose columns hold those blocks wait there before
// they rotate (`count` threads in all).
__device__ __forceinline__ void quads_read(int count) {
  __syncwarp();
  asm volatile("barrier.cta.arrive 1, %0;" ::"r"(count) : "memory");
}
__device__ __forceinline__ void wait_quads_read(int count) {
  asm volatile("barrier.cta.sync 1, %0;" ::"r"(count) : "memory");
}

// B1's eigenvector rows: block v of the consumer cluster holds columns
// [v mp / 16, (v + 1) mp / 16) of every eigenvector row, two columns a
// thread (one 8-byte access a row), and replays the producer's angles from
// the log. A round: rotate with the round's angles and labels, then lanes
// k < mp/2 take pair k's angle of the next round, loaded a round before
// (the producer runs ahead, so it is there unless the consumer has caught
// up), its labels in closed form, and load the angle of the round after;
// one __syncthreads().
__device__ void consumer(const int4* log, float* vt, int mp, int nrounds) {
  extern __shared__ int4 smem4[];
  const int half = mp / 2, tid = threadIdx.x, v = blockIdx.x, ldv = cols(mp);
  const int c0 = v * mp / BLOCKS, nc = (v + 1) * mp / BLOCKS - c0;
  float* V = reinterpret_cast<float*>(smem4);                // [mp][ldv]
  float2* ang = reinterpret_cast<float2*>(V + mp * ldv);      // [2][half]
  int* pq = reinterpret_cast<int*>(ang + 2 * half);          // [2][half]
  for (int e = tid; e < mp * ldv; e += NTR) {  // padding columns stay 0
    const int p = e / ldv, k = e - p * ldv;
    V[e] = p == c0 + k && k < nc ? 1.0f : 0.0f;
  }
  const bool lane = tid < half;
  const int ck0 = cyc(tid, half), ck1 = cyc(tid + half, half);
  int4 pre = make_int4(0, 0, 0, 0);
  if (lane) {
    ang[tid] = get_pair(log + tid, 1);
    pq[tid] = tid | (tid + half) << 16;
    if (nrounds > 1) pre = ld_entry(log + half + tid);
  }
  __syncthreads();
  int rm = 0;  // r modulo mp - 1
  for (int r = 0; r < nrounds; ++r) {
    const int cur = r & 1, nx = cur ^ 1, rn = rm + 1 == mp - 1 ? 0 : rm + 1;
    rotate_vt(V, ldv, ldv / 2, pq + cur * half, ang + cur * half, half, 0);
    if (lane && r + 1 < nrounds) {
      const int4* e = log + (size_t)(r + 1) * half + tid;
      ang[nx * half + tid] = entry_value(e, r + 2, pre);
      pq[nx * half + tid] = label_of(ck0, rn, half) | label_of(ck1, rn, half) << 16;
      if (r + 2 < nrounds) pre = ld_entry(e + half);
    }
    __syncthreads();
    rm = rn;
  }
  for (int e = tid; e < mp * nc; e += NTR) {
    const int p = e / nc, k = e - p * nc;
    vt[(size_t)p * mp + c0 + k] = V[p * ldv + k];
  }
}

// Grid (BLOCKS, nmat), or (BLOCKS, 2 nmat) for B1, clusters of BLOCKS
// blocks of NTR threads: cluster y < nmat holds matrix y, block b its pair
// positions [lo, hi) = pair_lo(b, mp/2, BLOCKS), in row slots through a slot
// table, as (d) and (e) lay them out; for B1 cluster nmat + y is matrix y's
// consumer, fed by the angle log [nmat, nrounds, mp/2] of 16-byte flagged
// entries (zeroed). x0, x1 as in sm_kernel.
//
// A round r: every thread waits on the block's barrier of the round's
// parity for what the round brings: the other blocks' angles of round r,
// the two arriving rows, already in their slots, and the neighbours' edge
// values with their free slots for this round's rows. Warps 1.. (the
// rotating warps) gather the next round's slot table through fixed
// indices; those whose columns hold the 2x2 blocks warp 0 reads wait for it
// at named barrier 1 (the others start at once); each thread rotates one
// column pair down its records (rot_pos): first the four that hold the
// leaving rows and the rows of the edge values, then each warp arrives on
// the block's `ready` barrier, then the others. Warp 0 does the rest: lane
// l < K reads the three 2x2 blocks of the next angle of pair lo + l
// (addresses computed the round before) and the warp arrives at barrier 1;
// the lanes compute the next angles and write them with the next round's
// row records (B1: and the log), and 15 lanes copy the block's angles into
// the other blocks (cp.async.bulk, one copy each); the warp waits for
// `ready`, copies the two leaving rows into the neighbours' free slots,
// gathers the neighbours' edge values and its next free slots and copies
// them too. One __syncthreads() ends the round. So the rotating threads do
// nothing but rotate, every transfer is a bulk copy that counts its bytes
// on the receiver's barrier, no thread waits for a remote store, and no
// cluster barrier: a block waits only for what it reads. Every index is
// fixed before the loop or computed in closed form (cyc).
//
// Edge values (EDGE_IN a round): [0..3] block b-1's row p at the labels of
// positions lo-1, half+lo-1, lo+1, half+lo+1, [4] b-1's free slot for this
// block's first bottom row; [8, 9] block b+1's row q at hi, half+hi, [10]
// b+1's free slot for the last top row; [12..15] row p2 (the row this block
// sent to b-1) at lo-1.., [16, 17] row y (sent to b+1) at hi, half+hi. The
// next pair lo takes rows p, p2, the next pair hi-1 rows y, q.
//
// Why the buffers suffice. A block's round r+2 copies need every block's
// round r+1 angles, which a block sends only after its wait of round r:
// so a barrier (by round parity) never takes bytes of a phase still open,
// and the angles, three buffers by round, never land in a buffer still read
// (round r's, by the rotation beside the copies of round r+1's), nor is a
// buffer rewritten while a copy still reads it. Row records, slot tables
// and edge values are double buffered by parity: a round reads what the
// round before wrote, and writes what the next reads, before the
// __syncthreads() that ends it. A row lands in the slot its receiver's own
// leaving row vacated the round before, whose copy out had landed before
// the sender could start the round.
template <bool VEC>
__global__ void __launch_bounds__(NTR, 1)
cluster_kernel(const float* __restrict__ a_in, float* x0, float* x1, int4* log, int mp,
               int nrounds, int nmat) {
  constexpr int C = BLOCKS, NU = NTR - 64;  // NU rotating threads (warps 2..)
  const int mat = VEC ? blockIdx.y % nmat : blockIdx.y;
  const size_t logoff = (size_t)mat * nrounds * (mp / 2);
  if (VEC && blockIdx.y >= nmat) {
    consumer(log + logoff, x0 + (size_t)mat * mp * mp, mp, nrounds);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int4 smem4[];
  const int b = (int)cluster.block_rank();
  const int half = mp / 2, tid = threadIdx.x, S = slots(mp);
  const int KM = pairs_max(mp), KA = ang_stride(mp), row4 = 4 * mp;  // bytes of a row
  const int lo = pair_lo(b, half, C), hi = pair_lo(b + 1, half, C), K = hi - lo;
  const bool top_edge = b > 0, bottom_edge = b < C - 1;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem4);  // [2] + ready
  unsigned long long* ready = bar + 2;
  float* rows = reinterpret_cast<float*>(smem4 + 2);     // [S][mp], 16-byte aligned
  int4* rr = reinterpret_cast<int4*>(rows + S * mp);     // [2][KM]: row bytes, c, s
  float2* ang = reinterpret_cast<float2*>(rr + 2 * KM);  // [3][C][KA]: by block
  int4* lanes = reinterpret_cast<int4*>(ang + 3 * C * KA);  // [32]: warp 0's, packed
  float* edge = reinterpret_cast<float*>(lanes + 32);    // [2][EDGE_IN]
  float* eout = edge + 2 * EDGE_IN;                      // [2][EDGE_OUT]
  unsigned short* tab = reinterpret_cast<unsigned short*>(eout + 2 * EDGE_OUT);  // [2][S]
  char* rowb = reinterpret_cast<char*>(rows);
  // round 0, as in (d): the local rows, every angle and the edge values
  // straight from the input; position i holds label i
  const float* a = a_in + (size_t)mat * mp * mp;
  for (int e = tid; e < 2 * K * mp; e += NTR) {
    const int l = e / mp, c = e - l * mp;
    rows[l * mp + c] = a[(size_t)(l < K ? lo + l : half + lo + l - K) * mp + c];
  }
  for (int e = tid; e < S; e += NTR) tab[e] = e;
  for (int k = tid; k < half; k += NTR) {
    float c, s;
    rotation(a[(size_t)k * mp + k], a[(size_t)k * mp + k + half],
             a[(size_t)(k + half) * mp + k + half], c, s);
    ang[aidx(k, half, KA)] = make_float2(c, s);
    if (k >= lo && k < hi) {
      const int l = k - lo;
      rr[rot_pos(l, K)] = make_int4(l * row4, (K + l) * row4, __float_as_int(c), __float_as_int(s));
      if (VEC) put_pair(log + logoff + k, c, s, 1);
    }
  }
  if (tid < 12) {
    const int tp[4] = {lo - 1, half + lo - 1, lo + 1, half + lo + 1};
    const int bt[2] = {hi, half + hi};
    const int i = tid & 3;
    if (tid < 4 && top_edge) edge[i] = a[(size_t)tp[0] * mp + tp[i]];                   // p
    if (tid >= 4 && tid < 8 && top_edge) edge[12 + i] = a[(size_t)tp[1] * mp + tp[i]];  // p2
    if (tid >= 8 && tid < 10 && bottom_edge) edge[16 + i] = a[(size_t)bt[0] * mp + bt[i]];  // y
    if (tid >= 10 && bottom_edge) edge[8 + (i & 1)] = a[(size_t)bt[1] * mp + bt[i & 1]];  // q
  }
  if (tid == 0) {  // the neighbours' free slots of round 0: their identity tables
    const int Kdn = top_edge ? lo - pair_lo(b - 1, half, C) : 0;
    const int Kup = bottom_edge ? pair_lo(b + 2, half, C) - hi : 0;
    reinterpret_cast<int*>(edge)[4] = 2 * Kdn + 1;
    reinterpret_cast<int*>(edge)[10] = 2 * Kup;
  }
  // warp 0's quads in the coming round: row offsets (two a word) and column
  // labels (two a word), for lane l < K
  unsigned rows_i, rows_j, cols_p, cols_q;
  {
    const Lane L = lane_of(tid < K ? tid : 0, b, lo, K, half);
    if (tid < K) lanes[tid] = pack(L);
    const int li = (top_edge && tid == 0 ? L.n.iq : L.n.ip) - lo;
    const int lj = (bottom_edge && tid == K - 1 ? L.n.ip : L.n.iq) - lo;
    rows_i = li * mp | (unsigned)((K + li) * mp) << 16;
    rows_j = lj * mp | (unsigned)((K + lj) * mp) << 16;
    cols_p = label_of(L.cp0, 0, half) | (unsigned)label_of(L.cp1, 0, half) << 16;
    cols_q = label_of(L.cq0, 0, half) | (unsigned)label_of(L.cq1, 0, half) << 16;
  }
  // rotating threads: thread u keeps column pair j (its labels' places cj0,
  // cj1, its angle entry aj) and walks records g, g + R, ...: those below
  // nA, then from nB
  const int u = tid - 64, nA = K < 4 ? K : 4, R = NU / half;
  const int j = u >= 0 ? u % half : 0, g = u >= 0 ? u / half : R;
  const int aj = aidx(j, half, KA), nB = g < nA ? g + (nA - g + R - 1) / R * R : g;
  // thread u < S advances entry u of the slot table: from entry gsrc
  const int gsrc = u >= 0 && u < 2 * K + 2 ? slot_src(u, b, K, C) : u;
  // barrier 1: warp 0 reads the columns of the pairs [lo-1, hi] only, so
  // only the warps with such a column pair wait for it (cnt1 threads in all)
  int cnt1 = 32, last = 0;
  bool wait1 = false;
  for (int q = 0; q < R; ++q) {
    const int a0 = q * half + (lo > 0 ? lo - 1 : 0), a1 = q * half + (hi < half ? hi : half - 1);
    const int w0 = a0 / 32 + 2, w1 = (a1 < NU ? a1 : NU - 1) / 32 + 2;
    const int from = w0 > last ? w0 : last + 1;
    if (w1 >= from) cnt1 += 32 * (w1 - from + 1), last = w1;
    wait1 = wait1 || ((tid >> 5) >= w0 && (tid >> 5) <= w1);
  }
  // bytes a round brings: the other blocks' angles (whole 16-byte units),
  // and from each neighbour a row and its edge values (32 bytes from b-1,
  // 16 from b+1)
  unsigned expect = 0;
  for (int o = 0; o < C; ++o)
    if (o != b) expect += 16u * ((pair_lo(o + 1, half, C) - pair_lo(o, half, C) + 1) / 2);
  expect += (top_edge ? row4 + 32 : 0) + (bottom_edge ? row4 + 16 : 0);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    mbar_init(ready, NTR / 32 - 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // the barriers are set, and every block runs, before any remote copy
  int rm = 0;  // r modulo mp - 1
  for (int r = 0; r < nrounds; ++r) {
    const int cur = r & 1, nx = cur ^ 1, b3 = r % 3, n3 = b3 == 2 ? 0 : b3 + 1;
    const int rn = rm + 1 == mp - 1 ? 0 : rm + 1;  // r + 1 modulo mp - 1
    const unsigned short* tc = tab + cur * S;
    unsigned short* tn = tab + nx * S;
    const int4* rc = rr + cur * KM;
    const float2* angc = ang + b3 * C * KA;
    float2* angn = ang + n3 * C * KA;
    const bool more = r + 1 < nrounds;
    if (r > 0) {
      if (tid == 0) mbar_arm(bar + cur, expect);
      mbar_wait(bar + cur, ((r - 1) >> 1) & 1);
    }
    if (tid < 32) {
      const bool angle = more && tid < K;
      const bool e_top = top_edge && tid == 0, e_bot = bottom_edge && tid == K - 1;
      Quad bpp, bpq, bqq;
      if (angle) {
        const float* ec = edge + cur * EDGE_IN;
        const int ri0 = rows_i & 0xffff, ri1 = rows_i >> 16, rj0 = rows_j & 0xffff, rj1 = rows_j >> 16;
        const int pc0 = cols_p & 0xffff, pc1 = cols_p >> 16, qc0 = cols_q & 0xffff, qc1 = cols_q >> 16;
        const Quad lpp = load_quad(rows, ri0, ri1, pc0, pc1), lpq = load_quad(rows, ri0, ri1, qc0, qc1);
        const Quad lqq = load_quad(rows, rj0, rj1, qc0, qc1);
        bpp = e_top ? Quad{ec[0], ec[1], ec[12], ec[13]} : lpp;
        bpq = e_top ? Quad{ec[2], ec[3], ec[14], ec[15]} : lpq;
        bqq = e_bot ? Quad{ec[16], ec[17], ec[8], ec[9]} : lqq;
      }
      quads_read(cnt1);
      if (angle) {
        const Lane L = unpack(lanes[tid], tid, b, lo, hi, K, half, KA);
        float c, s;
        const float2 ap = angc[L.ai_p], aq = angc[L.ai_q];
        const float apq = rotated_entry(bpq, ap, aq, L.n.pt, L.n.qt);
        const float aqq = rotated_entry(bqq, aq, aq, L.n.qt, L.n.qt);
        rotation(rotated_entry(bpp, ap, ap, L.n.pt, L.n.pt), apq, aqq, c, s);
        angn[L.ai_own] = make_float2(c, s);
        rr[nx * KM + L.nrec] =
            make_int4(tc[L.sl0] * row4, tc[L.sl1] * row4, __float_as_int(c), __float_as_int(s));
        if (VEC) put_pair(log + logoff + (size_t)(r + 1) * half + lo + tid, c, s, r + 2);
        // the quads' addresses next round
        rows_i = tc[L.si0] * mp | (unsigned)(tc[L.si1] * mp) << 16;
        rows_j = tc[L.sj0] * mp | (unsigned)(tc[L.sj1] * mp) << 16;
        cols_p = label_of(L.cp0, rn, half) | (unsigned)label_of(L.cp1, rn, half) << 16;
        cols_q = label_of(L.cq0, rn, half) | (unsigned)label_of(L.cq1, rn, half) << 16;
      }
      if (more) {
        fence_async();
        __syncwarp();
        if (tid < C - 1) {  // the block's next angles into every other block
          const int dst = b + 1 + tid < C ? b + 1 + tid : b + 1 + tid - C;
          bulk_remote(remote(angn + b * KA, dst), angn + b * KA, 16u * ((K + 1) / 2),
                      remote(bar + nx, dst));
        }
      }
    } else if (tid < 64) {  // warp 1: the rows and edge values that leave
      const int t = tid - 32;
      if (more) {
        mbar_wait(ready, r & 1);  // the rotating warps have rotated their first records
        const int* ei = reinterpret_cast<const int*>(edge + cur * EDGE_IN);
        if (t == 0 && bottom_edge)  // the last top row into block b+1's free slot
          bulk_remote(remote(rowb + ei[10] * row4, b + 1), rowb + tc[K - 1] * row4, row4,
                      remote(bar + nx, b + 1));
        if (t == 1 && top_edge)  // the first bottom row into block b-1's
          bulk_remote(remote(rowb + ei[4] * row4, b - 1), rowb + tc[K] * row4, row4,
                      remote(bar + nx, b - 1));
        // the edge values at their next-round labels (lanes 0..3 block
        // b+1's row p, 6, 7 block b-1's row q, 8..11 p2, 12, 13 y), and this
        // block's free slots next round (lanes 4, 5), where its neighbours
        // copy their rows
        int epos = 0;
        if (t < 4) epos = (t & 1 ? half : 0) + hi + (t & 2 ? 1 : -1);
        if (t == 6 || t == 7) epos = (t & 1) * half + lo;
        if (t >= 8 && t < 12) epos = (t & 1 ? half : 0) + lo + (t & 2 ? 1 : -1);
        if (t == 12 || t == 13) epos = (t & 1) * half + hi;
        const int col = label_of(cyc(epos >= 0 && epos < mp ? epos : 0, half), rn, half);
        float* eo = eout + nx * EDGE_OUT;
        float* en = edge + nx * EDGE_IN;
        if (t < 4) eo[t] = rows[tn[K - 1] * mp + col];
        if (t == 4) reinterpret_cast<int*>(eo)[4] = tn[2 * K + 1];
        if (t == 5) reinterpret_cast<int*>(eo)[10] = tn[2 * K];
        if (t == 6 || t == 7) eo[2 + t] = rows[tn[K] * mp + col];
        if (t >= 8 && t < 12) en[4 + t] = rows[tc[K] * mp + col];
        if (t == 12 || t == 13) en[4 + t] = rows[tc[K - 1] * mp + col];
        fence_async();
        __syncwarp();
        if (t == 0 && bottom_edge) bulk_remote(remote(en, b + 1), eo, 32, remote(bar + nx, b + 1));
        if (t == 1 && top_edge)
          bulk_remote(remote(en + 8, b - 1), eo + 8, 16, remote(bar + nx, b - 1));
      }
    } else {
      if (more && u < S) tn[u] = tc[gsrc];  // the next round's slot table
      if (wait1) wait_quads_read(cnt1);
      // J^T A J on the local rows at column pair j (labels cr, cs): records
      // n0, n0 + R, ... below n1
      const int cr = label_of(cyc(j, half), rm, half), cs = label_of(2 * half - 2 - j, rm, half);
      const float2 aa = angc[aj];
      char* colr = rowb + 4 * cr;  // a row's elements of the column pair: these
      char* cols = rowb + 4 * cs;  // plus the row's byte offset
      auto rotate = [&](int n0, int n1) {
#pragma unroll 2
        for (int n = n0; n < n1; n += R) {
          const int4 rec = rc[n];
          rot2x2(*reinterpret_cast<float*>(colr + rec.x), *reinterpret_cast<float*>(cols + rec.x),
                 *reinterpret_cast<float*>(colr + rec.y), *reinterpret_cast<float*>(cols + rec.y),
                 __int_as_float(rec.z), __int_as_float(rec.w), aa.x, aa.y);
        }
      };
      if (g < R) rotate(g, nA);
      fence_async();  // the leaving rows and edge values go out by bulk copies
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(ready);
      if (g < R) rotate(nB, K);
    }
    __syncthreads();
    rm = rn;
  }
  const int rl = (nrounds - 1) % (mp - 1);
  const unsigned short* tf = tab + ((nrounds - 1) & 1) * S;
  auto label = [&](int l) { return label_of(cyc(l < K ? lo + l : half + lo + l - K, half), rl, half); };
  if (VEC) {
    for (int l = tid; l < 2 * K; l += NTR)
      x1[(size_t)mat * mp + label(l)] = rows[tf[l] * mp + label(l)];
  } else {
    for (int l = tid >> 5; l < 2 * K; l += NW)
      gersh_row(rows + tf[l] * mp, label(l), mp, x0 + (size_t)mat * mp, x1 + (size_t)mat * mp);
  }
  cluster.sync();  // no block leaves while a peer may still address its memory
}

}  // namespace wide

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

// (b): B1's producer and consumer clusters must be resident together, so a
// launch holds half the clusters that can be; B2's are independent and may
// queue.
template <bool VEC>
int launch_cluster(const float* a, float* x0, float* x1, int4* log, int nb, int mp, int nrounds,
                   cudaStream_t st) {
  constexpr int C = wide::BLOCKS;
  const int rows = wide::bytes(mp), cons = wide::consumer_bytes(mp);
  const int bytes = VEC && cons > rows ? cons : rows;
  // a block needs two pairs and at most one warp of angle lanes, and two
  // rotating threads for each column pair (so each slot-table entry has
  // one too; a consumer block then has a thread for each pair's log entry)
  if (bytes > SMEM_MAX || mp / 2 / C < 2 || wide::pairs_max(mp) > 32 || mp > NTR - 64) return ERR_SHAPE;
  if (VEC && log == nullptr) return ERR_SHAPE;
  auto kern = wide::cluster_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, VEC ? 2 : 1, 1);
  cfg.blockDim = dim3(NTR, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return err;
  const int per = VEC ? active / 2 : nb;
  if (active < 1 || per < 1) return ERR_NO_CLUSTER;
  const int half = mp / 2;
  for (int m0 = 0; m0 < nb; m0 += per) {
    const int n = nb - m0 < per ? nb - m0 : per;
    cfg.gridDim = dim3(C, VEC ? 2 * n : n, 1);
    const size_t mat = (size_t)m0 * mp;
    err = cudaLaunchKernelEx(&cfg, kern, a + mat * mp, x0 + (VEC ? mat * mp : mat), x1 + mat,
                             VEC ? log + (size_t)m0 * nrounds * half : log, mp, nrounds, n);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <bool VEC>
int launch_dsmem(const float* a, float* x0, float* x1, int nb, int mp, int nrounds,
                 cudaStream_t st) {
  constexpr int C = dsmem::BLOCKS;
  const int bytes = dsmem::bytes(mp, VEC);
  // a block needs two pairs and at most one warp of angle threads
  if (bytes > SMEM_MAX || mp / 2 / C < 2 || dsmem::pairs_max(mp) > 32) return ERR_SHAPE;
  auto kern = dsmem::cluster_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, nb, 1);
  cfg.blockDim = dim3(dsmem::NTH, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return ERR_NO_CLUSTER;  // the clusters are independent and may queue
  err = cudaLaunchKernelEx(&cfg, kern, a, x0, x1, mp, nrounds);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int VM>
int launch_grid_vm(const float* a, float* x0, float* x1, int* scratch, int nb, int mp,
                   int nrounds, GridPlan pl, int sms, cudaStream_t st) {
  auto kern = grid_kernel<VM>;
  const int bytes = grid_bytes(mp, pl.G, VM);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTR, bytes);
  if (err != cudaSuccess) return err;
  // a block waits for the others' entries: all must be resident at once
  if ((long long)per_sm * sms < (long long)pl.per * pl.G) return ERR_NO_CLUSTER;
  const long long len = grid_scratch(mp, pl.G, VM);
  for (int m0 = 0; m0 < nb; m0 += pl.per) {
    const int n = nb - m0 < pl.per ? nb - m0 : pl.per;
    const float* a_m = a + (size_t)m0 * mp * mp;
    float* x0_m = x0 + (size_t)m0 * (VM == V_NONE ? mp : (size_t)mp * mp);
    float* x1_m = x1 + (size_t)m0 * mp;
    int* sc_m = scratch + m0 * len;
    int G = pl.G;
    void* args[] = {(void*)&a_m, (void*)&x0_m, (void*)&x1_m, (void*)&sc_m,
                    (void*)&mp,  (void*)&nrounds, (void*)&G};
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3(n * pl.G), dim3(NTR), args,
                                      bytes, st);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

int launch_grid(const float* a, float* x0, float* x1, int* scratch, int nb, int mp,
                int nrounds, bool vec, cudaStream_t st) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const GridPlan pl = grid_plan(nb, mp, vec, sms);
  if (!pl.ok || scratch == nullptr || nrounds < 1) return ERR_SHAPE;
  if (pl.vm == V_SMEM)
    return launch_grid_vm<V_SMEM>(a, x0, x1, scratch, nb, mp, nrounds, pl, sms, st);
  if (pl.vm == V_GLOBAL)
    return launch_grid_vm<V_GLOBAL>(a, x0, x1, scratch, nb, mp, nrounds, pl, sms, st);
  return launch_grid_vm<V_NONE>(a, x0, x1, scratch, nb, mp, nrounds, pl, sms, st);
}

}  // namespace

// Regime codes: 0 = (c) one launch per round, 1 = (a) one block per matrix,
// 2 = (b) one cluster per matrix, 3 = (d) one cooperative launch over the
// card, 4 = (e) one cluster per matrix, point to point. Returns a
// cudaError_t (0 = success) or -1 (no cluster of this shape, or not every
// block of the grid, can be resident) / -2 (shape does not fit the regime).
//
// B1. a: [nb, mp, mp] input (overwritten in regime 0 only); a2: [nb, mp, mp]
// scratch and pairs: [mp-1, 2, mp/2] labels (regime 0 only); vt: [nb, mp, mp]
// output (eigenvectors as rows); lam: [nb, mp] output (unsorted, label
// order); scratch: regime 2, the angle log [nb, nrounds, mp/2] of 16-byte
// entries, zeroed; regime 3, lt_jacobi_grid_scratch int32 words, zeroed.
extern "C" int lt_jacobi_eigh_f32(float* a, float* a2, float* vt, float* lam,
                                  const int* pairs, void* scratch,
                                  int nb, int mp, int nrounds, int regime, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (regime == 1) return launch_sm<true>(a, vt, lam, nb, mp, nrounds, st);
  if (regime == 2)
    return launch_cluster<true>(a, vt, lam, static_cast<int4*>(scratch), nb, mp, nrounds, st);
  if (regime == 3)
    return launch_grid(a, vt, lam, static_cast<int*>(scratch), nb, mp, nrounds, true, st);
  if (regime == 4) return launch_dsmem<true>(a, vt, lam, nb, mp, nrounds, st);
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

// B2. a, a2, pairs as for B1; scratch: regime 3 only; g, h: [nb, mp] output
// per-row lower/upper Gershgorin bounds of the rotated matrix.
extern "C" int lt_jacobi_bounds_f32(float* a, float* a2, float* g, float* h,
                                    const int* pairs, void* scratch, int nb, int mp,
                                    int nrounds, int regime, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (regime == 1) return launch_sm<false>(a, g, h, nb, mp, nrounds, st);
  if (regime == 2) return launch_cluster<false>(a, g, h, nullptr, nb, mp, nrounds, st);
  if (regime == 3)
    return launch_grid(a, g, h, static_cast<int*>(scratch), nb, mp, nrounds, false, st);
  if (regime == 4) return launch_dsmem<false>(a, g, h, nb, mp, nrounds, st);
  float* fin = nullptr;
  cudaError_t err =
      run_rounds(a, a2, nullptr, pairs, nb, mp, nrounds, st, &fin);
  if (err != cudaSuccess) return err;
  gersh_kernel<<<dim3((mp + 3) / 4, nb), 128, 0, st>>>(fin, g, h, mp);
  return cudaGetLastError();
}

// int32 words of regime 3's exchange buffers for nb matrices on the current
// device (the wrapper allocates and zeroes them), or -2 where the shape does
// not fit the regime there.
extern "C" long long lt_jacobi_grid_scratch(int nb, int mp, int vec) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return ERR_SHAPE;
  const GridPlan pl = grid_plan(nb, mp, vec != 0, sms);
  return pl.ok ? nb * grid_scratch(mp, pl.G, pl.vm) : ERR_SHAPE;
}
