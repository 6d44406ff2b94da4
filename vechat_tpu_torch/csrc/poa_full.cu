// The full-matrix linear-gap sequence-to-graph DP of B10 and its traceback
// for Hopper (sm_90a), with a plain C interface for ctypes: F1, the int32 H
// matrix and the best cell of one window a block; F2, the walk of one
// window a warp.
//
// Replaces vechat_tpu/ops/kernels/poa_jax.py: poa_align_batch_device, plain
// XLA there (no pallas_call): a fori_loop over the DP rows with the in-row
// gap as a cummax, the best-cell selection as masked argmaxes, and a
// batched traceback fori_loop of L steps with an active mask. The plain
// PyTorch versions in ops/kernels/poa_full.py follow those loops; both give
// the same pairs, counts and scores, word for word. It is an int32 max-plus
// recurrence: the tensor cores have no part in it.
//
// F1 (poa_full_dp_kernel<MODE, K>): a block a window, K columns a thread
// (thread t owns columns tK .. tK + K - 1, in registers; blockDim = W / K
// rounded up to a warp; K = 1 up to 256 columns, 4 above: dp_columns). Before the row loop the block stages the window's
// in-slots in shared memory as int16, each row's distinct ones first with
// their count, and its codes and sink flags. Row n + 1 (rank n):
//   * each distinct predecessor row p: diag = H[p][j-1] + (seq[j-1] ==
//     code ? m : x), vert = H[p][j] + g; as the profile does not depend on
//     p, the thread keeps the largest of the rows at each column (vmax, and
//     at column tK - 1), then cand[j] = max(vmax[j-1] + prof[j], vmax[j] +
//     g); column 0 takes vmax[0] + g in nw, 0 else. Row p comes from
//       - registers if p == n (the row just computed: the thread's columns,
//         and column tK - 1 from the scan's prefix),
//       - nothing if p == 0 (j*g, or 0 in sw),
//       - the ring if n + 1 - p <= R: the last R = kRing rows in shared
//         memory, row r in slot r mod R (R = 16 serves every read of
//         chip_smoke.py's 9a batch and all but a few of 9b's; PERF.md),
//       - global memory otherwise (stored at least one barrier ago).
//     A row's word and first slot are read a row ahead.
//   * the in-row gap H[j] = max(H[j-1] + g, cand[j]) as an inclusive
//     max-scan of t[j] = cand[j] - j*g: serial over the thread's K columns,
//     five __shfl_up_sync steps over the warp's thread totals, lane 31
//     publishes the warp's total, one __syncthreads, each thread takes the
//     maximum of the totals to its warp's left (16-byte shared loads, the
//     first 8 unconditionally); H[j] = max(scan, prefix) + j*g, clamped at
//     0 in sw
//   * the row goes to global memory (for F2; where W is a multiple of K a
//     live thread stores all its K columns, those past seq_len included)
//     and to ring slot (n + 1) mod R. One barrier a row is enough: row n's
//     reads of the ring come before barrier n and its writes after it, so
//     the slot it overwrites (row n + 1 - R, which row n may read) is no
//     longer read by any thread, and a row is read from the ring only from
//     row n + 2 on, after at least one barrier past its store. The warps'
//     totals alternate between two buffers by the row's parity.
//   * the best cell as the rows are written: each thread keeps the first
//     row where the largest of its cells of the mode's cells rose (nw: the
//     sink rows at column seq_len; ov: the sink rows' columns 1..seq_len;
//     sw: every real cell), and at the end reads that row back for its
//     first column at the value: its first strict maximum in flat (rank,
//     column) order. One block reduction keeps the largest value at the
//     lowest flat index (rank * S + column - 1; in nw the rank). best[b] =
//     (score, flat index), the index -1 for an sw window whose best is not
//     positive (no walk). With no cell above the reference's -2^30 it is
//     (-2^30, 0), as its argmax.
// Rows past n_nodes and columns past seq_len are not computed, and no
// result reads them (a column depends on columns to its left only, a row
// on earlier rows only).
//
// F2 (poa_full_walk_kernel<MODE>): one warp a window, from F1's best cell.
// The warp first stages the window's in-slots (int16), codes and the
// read's codes in its part of shared memory. A walk step: lane s < P reads
// slot s of the node from shared memory and loads its two cells,
// H[p][j-1] and H[p][j], while every lane loads H[i][j-1]: one round trip
// to the L2 a step. It tests diagonal (h == H[p][j-1] + match) and
// vertical (h == H[p][j] + g), a ballot of each; __ffs picks the first
// true slot, diagonal before vertical before horizontal (h == H[i][j-1] +
// g); none gives diagonal slot 0, the reference's argmax. The next h is
// the chosen cell, taken from its lane by a shuffle. Lane 0 writes the
// pair (node id | -1, j - 1 | -1) at L - 1 - k. The walk ends when (0, 0)
// is reached (nw), i or j is 0 (ov) or H is 0 (sw), at its exact step
// count; then the lanes write -2 over the columns before its pairs.
//
// What bounds them: F1 is one chain a row (the predecessors' shared
// loads, the scan's serial part and shuffles, the barrier, the prefix),
// n_nodes rows a window, a block a window; F2 is one chain of dependent
// steps, a load from the L2 or device memory each. Neither bytes nor
// operations come near the card's rates (chip_smoke.py, phase 9).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 30);  // the reference's NEG
constexpr int kMaxThreads = 1024;
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90 (227 KB)
constexpr int kWalkWarps = 4;     // F2's warps a block where shared memory allows
constexpr int kRing = 16;         // F1's rows kept in shared memory (a power of two)

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// F1's dynamic shared memory: the ring [kRing][cols] int32, then the
// in-slots [N][P] int16, then a word a row: code | sink << 8 | distinct
// slots << 16
size_t dp_smem(int N, int P, int cols) {
  return (size_t)kRing * cols * 4 + align16((size_t)N * P * 2) + (size_t)N * 4;
}

// F2's dynamic shared memory a warp: the in-slots [N][P] int16, the codes
// [N] and the read's codes [S]
__host__ __device__ size_t walk_smem(int N, int P, int S) {
  return align16((size_t)N * P * 2) + align16(N) + align16(S);
}

struct DpArgs {
  const uint8_t* codes;
  const int* preds;
  const uint8_t* is_sink;
  const int* n_nodes;
  const uint8_t* seq;
  const int* seq_len;
  int* H;
  int* best;
  int N, P, S, m, x, g;
};

template <int K>
__device__ __forceinline__ void load_cols(const int* p, int (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const int4 t = *reinterpret_cast<const int4*>(p + q);
      v[q] = t.x;
      v[q + 1] = t.y;
      v[q + 2] = t.z;
      v[q + 3] = t.w;
    }
  } else {
    v[0] = p[0];
  }
}

template <int K>
__device__ __forceinline__ void store_cols(int* p, const int (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4)
      *reinterpret_cast<int4*>(p + q) = make_int4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else {
    p[0] = v[0];
  }
}

// row p of H at the columns c0 .. c0 + K - 1 (v) and at c0 - 1 (lf), for
// row n + 1: from the registers (p == n, the row just computed), nothing
// (p == 0), the ring (n - p < kRing) or global memory
template <int MODE, int K>
__device__ __forceinline__ void pred_row(int p, int n, const int* ring, int cols,
                                         const int* Hb, int W, int c0, int slen, int g,
                                         const int (&cur)[K], int left, int (&v)[K], int& lf) {
  if (p == n) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = cur[k];
    lf = left;
  } else if (p == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = MODE == 1 ? 0 : (c0 + k) * g;
    lf = MODE == 1 ? 0 : (c0 - 1) * g;
  } else if (n - p < kRing) {
    const int* row = ring + (size_t)(p & (kRing - 1)) * cols;
    load_cols<K>(row + c0, v);
    lf = c0 ? row[c0 - 1] : 0;
  } else {  // older than the ring: global memory, stored rows ago
    const int* row = Hb + (size_t)p * W;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = c0 + k <= slen ? row[c0 + k] : 0;
    lf = c0 ? row[c0 - 1] : 0;
  }
}

// slots[e] = preds[e] clamped to [0, N], for e < total, by `nthreads`
// threads from `tid`, 8 loads in flight a thread, of 16 bytes each where
// the window's table is a multiple of 4 slots (its rows then start 16-byte
// aligned, and the last load stays inside it)
__device__ __forceinline__ void stage_slots(const int* __restrict__ preds, short* slots,
                                            int total, int table, int N, int tid, int nthreads) {
  constexpr int U = 8;
  const int step = table % 4 == 0 ? 4 : 1;
  for (int base = 0; base < total; base += nthreads * U * step) {
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + (u * nthreads + tid) * step;
      if (e >= total) continue;
      if (step == 4) {
        v[u] = *reinterpret_cast<const int4*>(preds + e);
      } else {
        v[u].x = preds[e];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + (u * nthreads + tid) * step;
      if (e >= total) continue;
      slots[e] = (short)min(max(v[u].x, 0), N);
      if (step == 4) {
        if (e + 1 < total) slots[e + 1] = (short)min(max(v[u].y, 0), N);
        if (e + 2 < total) slots[e + 2] = (short)min(max(v[u].z, 0), N);
        if (e + 3 < total) slots[e + 3] = (short)min(max(v[u].w, 0), N);
      }
    }
  }
}

template <int MODE, int K>  // MODE 0 nw, 1 sw, 2 ov
__global__ void __launch_bounds__(kMaxThreads / K) poa_full_dp_kernel(const DpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) int totals[2][32];
  __shared__ int red_v[32], red_i[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int N = a.N, P = a.P, S = a.S, g = a.g;
  const int W = S + 1;
  const int cols = nthreads * K;
  int* ring = reinterpret_cast<int*>(smem);
  short* slots = reinterpret_cast<short*>(smem + (size_t)kRing * cols * 4);
  int* info = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(slots) +
                                     align16((size_t)N * P * 2));
  const int nn = min(max(a.n_nodes[b], 0), N);
  const int slen = min(max(a.seq_len[b], 0), S);
  int* Hb = a.H + (size_t)b * (N + 1) * W;

  // stage: the in-slots (clamped, int16) and each row's code and sink flag
  // with coalesced loads; then a thread a row moves its distinct slots to
  // the front (a repeat of slot 0 gives the same candidates) and adds
  // their count to the row's word
  {
    stage_slots(a.preds + (size_t)b * N * P, slots, nn * P, N * P, N, tid, nthreads);
    const uint8_t* cb = a.codes + (size_t)b * N;
    const uint8_t* kb = a.is_sink + (size_t)b * N;
    for (int r = tid; r < nn; r += nthreads) info[r] = (int)cb[r] | (kb[r] ? 1 << 8 : 0);
    __syncthreads();
    for (int r = tid; r < nn; r += nthreads) {
      short* row = slots + (size_t)r * P;
      const short p0 = row[0];
      int d = 1;
      for (int s = 1; s < P; ++s) {
        const short p = row[s];
        if (p != p0) row[d++] = p;
      }
      info[r] |= d << 16;
    }
  }

  const int c0 = tid * K;
  int sq[K], jg[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int col = c0 + k;
    jg[k] = col * g;
    sq[k] = (col >= 1 && col <= slen) ? (int)a.seq[(size_t)b * S + col - 1] : -1;
  }
  // the thread's columns among the mode's cells: [lo, hi]
  const int lo = MODE == 0 ? slen : max(c0, 1);
  const int hi = min(c0 + K - 1, slen);
  const bool scans = lo <= hi && (MODE != 0 || (slen >= c0 && slen < c0 + K));
  const bool live = c0 <= slen;

  // row 0; cur holds the previous row at the thread's columns, left at c0 - 1
  int cur[K];
#pragma unroll
  for (int k = 0; k < K; ++k) cur[k] = MODE == 1 ? 0 : jg[k];
  int left = (MODE == 1 || c0 == 0) ? 0 : (c0 - 1) * g;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (c0 + k <= slen) Hb[c0 + k] = cur[k];
  int bv = kNeg;
  __syncthreads();  // the staged table

  // a row's word and first slot are read a row ahead, off the row's chain
  int word = nn > 0 ? info[0] : 0;
  int p0 = nn > 0 ? slots[0] : 0;
  int brow = 0;  // the row of the thread's best value
  for (int n = 0; n < nn; ++n) {
    const int code = word & 0xff;
    const bool track = scans && (MODE == 1 || ((word >> 8) & 1));  // a row of the mode's cells
    const int deg = word >> 16;
    const short* ps = slots + (size_t)n * P;
    int t[K];
    if (live) {
      // vmax: the largest of the predecessor rows at each column, lm at
      // c0 - 1 (the profile does not depend on the row, so one max a slot)
      int vmax[K], lm;
      pred_row<MODE, K>(p0, n, ring, cols, Hb, W, c0, slen, g, cur, left, vmax, lm);
      for (int s = 1; s < deg; ++s) {
        int v[K], lf;
        pred_row<MODE, K>(ps[s], n, ring, cols, Hb, W, c0, slen, g, cur, left, v, lf);
#pragma unroll
        for (int k = 0; k < K; ++k) vmax[k] = max(vmax[k], v[k]);
        lm = max(lm, lf);
      }
      int cand[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int prof = sq[k] == code ? a.m : a.x;
        cand[k] = (c0 + k) ? max((k ? vmax[k - 1] : lm) + prof, vmax[k] + g) : vmax[k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int col = c0 + k;
        const int full = col ? cand[k] : (MODE == 0 ? cand[k] + g : 0);
        t[k] = col <= slen ? full - jg[k] : kNeg;
        if (k) t[k] = max(t[k], t[k - 1]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) t[k] = kNeg;
    }
    // the warp's scan of the thread totals, then the warps' carry
    int tot = t[K - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)  // a lane below o gets its own total back
      tot = max(tot, __shfl_up_sync(kFull, tot, o));
    int* tw = totals[n & 1];
    if (lane == 31) tw[warp] = tot;
    int pre = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) pre = kNeg;
    __syncthreads();
    // the scan through c0 - 1: the totals of the warps to the left, the
    // first 8 (as many as F1 has at its default columns a thread) in two
    // 16-byte loads, the rest four at a time
    {
      const int4 a4 = *reinterpret_cast<const int4*>(tw);
      const int4 b4 = *reinterpret_cast<const int4*>(tw + 4);
      int m0 = max(max(0 < warp ? a4.x : kNeg, 1 < warp ? a4.y : kNeg),
                   max(2 < warp ? a4.z : kNeg, 3 < warp ? a4.w : kNeg));
      int m1 = max(max(4 < warp ? b4.x : kNeg, 5 < warp ? b4.y : kNeg),
                   max(6 < warp ? b4.z : kNeg, 7 < warp ? b4.w : kNeg));
      for (int q = 8; q < warp; q += 4) {
        const int4 t4 = *reinterpret_cast<const int4*>(tw + q);
        m0 = max(m0, max(t4.x, q + 1 < warp ? t4.y : kNeg));
        m1 = max(m1, max(q + 2 < warp ? t4.z : kNeg, q + 3 < warp ? t4.w : kNeg));
      }
      pre = max(pre, max(m0, m1));
    }
    if (n + 1 < nn) {
      word = info[n + 1];
      p0 = slots[(size_t)(n + 1) * P];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cur[k] = max(t[k], pre) + jg[k];
      if (MODE == 1) cur[k] = max(cur[k], 0);
    }
    left = pre + (c0 - 1) * g;
    if (MODE == 1) left = max(left, 0);
    store_cols<K>(ring + (size_t)((n + 1) & (kRing - 1)) * cols + c0, cur);
    int* out = Hb + (size_t)(n + 1) * W + c0;
    if (W % K == 0) {  // the same for the block; a live thread's K columns are in the row
      if (live) store_cols<K>(out, cur);
    } else if (live) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (c0 + k <= slen) out[k] = cur[k];
    }
    if (track) {  // the row's largest of the thread's cells; its column at the end
      int mx = kNeg;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (c0 + k >= lo && c0 + k <= hi) mx = max(mx, cur[k]);
      if (mx > bv) {
        bv = mx;
        brow = n;
      }
    }
  }
  // the thread's first strict maximum in flat order: the first row that
  // reached it, the first of its columns there (read back from H, which
  // this thread wrote)
  int bi = 0;
  if (bv > kNeg) {
    const int* row = Hb + (size_t)(brow + 1) * W;
    bi = INT_MAX;
#pragma unroll
    for (int k = K - 1; k >= 0; --k)
      if (c0 + k >= lo && c0 + k <= hi && row[c0 + k] == bv) bi = c0 + k;
    bi = MODE == 0 ? brow : brow * S + bi - 1;
  }

  // the block's best: the largest value at the lowest flat index
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (nthreads >> 5); ++w) {
      if (red_v[w] > bv || (red_v[w] == bv && red_i[w] < bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    }
    if (MODE == 1 && bv <= 0) bi = -1;  // no positive cell: no walk
    a.best[2 * b] = bv;
    a.best[2 * b + 1] = bi;
  }
}

struct WalkArgs {
  const int* H;
  const int* best;
  const uint8_t* codes;
  const int* preds;
  const int* node_id;
  const int* n_nodes;
  const uint8_t* seq;
  const int* seq_len;
  int* pairs;
  int* count;
  int* score;
  int B, N, P, S, m, x, g;
};

template <int MODE>
__global__ void poa_full_walk_kernel(const WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wib;
  if (b >= a.B) return;
  const int N = a.N, P = a.P, S = a.S, g = a.g;
  const int W = S + 1;
  const int L = N + S + 1;
  const int nn = min(max(a.n_nodes[b], 0), N);
  const int slen = min(max(a.seq_len[b], 0), S);
  const int* Hb = a.H + (size_t)b * (N + 1) * W;
  const int* nid = a.node_id + (size_t)b * N;
  int* out = a.pairs + (size_t)b * L * 2;

  // stage the window's in-slots, codes and read in this warp's part
  unsigned char* mine = smem + (size_t)wib * walk_smem(N, P, S);
  short* sl = reinterpret_cast<short*>(mine);
  uint8_t* cd = mine + align16((size_t)N * P * 2);
  uint8_t* sq = cd + align16(N);
  {
    stage_slots(a.preds + (size_t)b * N * P, sl, nn * P, N * P, N, lane, 32);
    const uint8_t* cb = a.codes + (size_t)b * N;
    const uint8_t* sb = a.seq + (size_t)b * S;
    for (int e = lane; e < nn; e += 32) cd[e] = cb[e];
    for (int e = lane; e < slen; e += 32) sq[e] = sb[e];
  }
  __syncwarp();

  const int bv = a.best[2 * b];
  const int bi = a.best[2 * b + 1];
  int i, j;
  if (MODE == 0) {
    i = bi + 1;
    j = slen;
  } else if (bi < 0) {  // sw with no positive cell
    i = j = 0;
  } else {
    i = bi / S + 1;
    j = bi % S + 1;
  }
  const bool empty = i == 0 && j == 0;

  int k = 0;
  int h = Hb[(size_t)i * W + j];
  bool active = !empty && (MODE == 0 ? true : MODE == 2 ? (i != 0 && j != 0) : h != 0);
  while (active && k < L) {
    const int node = max(i - 1, 0);
    const int jm1 = max(j - 1, 0);
    const int mc = sq[jm1] == cd[node] ? a.m : a.x;
    const int p = lane < P ? sl[node * P + lane] : 0;
    const int* row = Hb + (size_t)p * W;
    // one round trip: the slot's two cells, the horizontal cell, the id
    const int dv = row[jm1];
    const int vv = row[j];
    const int hz = Hb[(size_t)i * W + jm1];
    const int id = nid[node];
    const bool d_ok = lane < P && i != 0 && j != 0 && h == dv + mc;
    const bool v_ok = lane < P && i != 0 && h == vv + g;
    const unsigned bd = __ballot_sync(kFull, d_ok);
    const unsigned bvv = __ballot_sync(kFull, v_ok);
    int src = 0, pj = j - 1;
    bool vert = false, horiz = false;
    if (bd) {
      src = __ffs(bd) - 1;
    } else if (bvv) {
      src = __ffs(bvv) - 1;
      vert = true;
      pj = j;
    } else if (j != 0 && h == hz + g) {
      horiz = true;
    }  // none: diagonal slot 0, as the reference's argmax
    const int pi_s = __shfl_sync(kFull, p, src);
    const int h_s = __shfl_sync(kFull, vert ? vv : dv, src);
    const int pi = horiz ? i : pi_s;
    if (lane == 0) {
      int2 pr;
      pr.x = pi == i ? -1 : id;
      pr.y = pj == j ? -1 : j - 1;
      reinterpret_cast<int2*>(out)[L - 1 - k] = pr;
    }
    ++k;
    i = pi;
    j = max(pj, 0);
    h = horiz ? hz : h_s;
    active = MODE == 0 ? !(i == 0 && j == 0) : MODE == 2 ? (i != 0 && j != 0) : h != 0;
  }
  for (int c = lane; c < L - k; c += 32) reinterpret_cast<int2*>(out)[c] = make_int2(-2, -2);
  if (lane == 0) {
    a.count[b] = k;
    a.score[b] = bv;
  }
}

using DpKernel = void (*)(const DpArgs);
using WalkKernel = void (*)(const WalkArgs);

// F1's columns a thread at S (f1_columns in ops/kernels/poa_full.py): 1 up
// to 256 columns (S = 63, 127, 255: 2, 4 and 8 warps), 4 above (S = 511: 4
// warps; 767: 6; 1023: 8)
int dp_columns(int S) { return S + 1 <= 256 ? 1 : 4; }

template <int MODE>
DpKernel dp_kernel_k(int S) {
  return dp_columns(S) == 1 ? poa_full_dp_kernel<MODE, 1> : poa_full_dp_kernel<MODE, 4>;
}

DpKernel dp_kernel(int mode, int S) {
  return mode == 0 ? dp_kernel_k<0>(S) : mode == 1 ? dp_kernel_k<1>(S) : dp_kernel_k<2>(S);
}

WalkKernel walk_kernel(int mode) {
  return mode == 0 ? poa_full_walk_kernel<0>
                   : mode == 1 ? poa_full_walk_kernel<1> : poa_full_walk_kernel<2>;
}

int dp_threads(int S, int k) { return (S + 1 + 32 * k - 1) / (32 * k) * 32; }

int walk_warps(int N, int P, int S) {
  const size_t per = walk_smem(N, P, S);
  return per > (size_t)kSmemMax ? 0 : (int)std::min<size_t>(kWalkWarps, kSmemMax / per);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// F1's threads a block and dynamic shared memory at (N, P, S); 0 threads
// where it cannot launch (more than 1024 threads; N past int16; shared
// memory past a block's)
int poa_full_dp_plan(int N, int P, int S, int* smem_bytes) {
  *smem_bytes = 0;
  if (N > 32767 || P < 1 || S < 1) return 0;
  const int k = dp_columns(S);
  const int threads = dp_threads(S, k);
  const size_t smem = dp_smem(N, P, threads * k);
  if (threads > kMaxThreads || smem > (size_t)kSmemMax) return 0;
  *smem_bytes = (int)smem;
  return threads;
}

// F2's warps a block (at most 4) and their dynamic shared memory; 0 warps
// where one warp's staging does not fit in a block's shared memory
int poa_full_walk_plan(int N, int P, int S, int* smem_bytes) {
  const int warps = P >= 1 && P <= 32 && N <= 32767 ? walk_warps(N, P, S) : 0;
  *smem_bytes = (int)(warps * walk_smem(N, P, S));
  return warps;
}

// F1 on one window a block; mode 0 nw, 1 sw, 2 ov
int poa_full_dp_launch(const uint8_t* codes, const int* preds, const uint8_t* is_sink,
                       const int* n_nodes, const uint8_t* seq, const int* seq_len, int* H,
                       int* best, int B, int N, int P, int S, int mode, int m, int x, int g,
                       void* stream) {
  int smem = 0;
  const int threads = poa_full_dp_plan(N, P, S, &smem);
  if (threads == 0 || B < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const DpKernel kernel = dp_kernel(mode, S);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const DpArgs a{codes, preds, is_sink, n_nodes, seq, seq_len, H, best, N, P, S, m, x, g};
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// F2 on one window a warp, from F1's best [B, 2]
int poa_full_walk_launch(const int* H, const int* best, const uint8_t* codes, const int* preds,
                         const int* node_id, const int* n_nodes, const uint8_t* seq,
                         const int* seq_len, int* pairs, int* count, int* score, int B, int N,
                         int P, int S, int mode, int m, int x, int g, void* stream) {
  int smem = 0;
  const int warps = poa_full_walk_plan(N, P, S, &smem);
  if (warps == 0 || B < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const WalkKernel kernel = walk_kernel(mode);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const WalkArgs a{H, best, codes, preds, node_id, n_nodes, seq, seq_len, pairs, count, score,
                   B, N, P, S, m, x, g};
  kernel<<<(B + warps - 1) / warps, warps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// registers a thread, static shared memory and local memory of F1 (which
// 0, as launched at S) or F2 (which 1) in `mode`: out[0..2]
int poa_full_attrs(int which, int mode, int S, int* out) {
  cudaFuncAttributes at;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const cudaError_t e = which == 0 ? cudaFuncGetAttributes(&at, dp_kernel(mode, S))
                                   : cudaFuncGetAttributes(&at, walk_kernel(mode));
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = (int)at.localSizeBytes;
  return 0;
}

}  // extern "C"
