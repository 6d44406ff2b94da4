// The heaviest-bundle machine of round 2's window consensus for Hopper
// (sm_90a), with a plain C interface for ctypes: G6, the scores and
// predecessors over the ranks, the branch-completion passes and the
// backward walk of one window a block.
//
// Replaces vechat_tpu/ops/kernels/graph_consensus.py: heaviest_bundle (with
// _bundle_scan), XLA loops that step every window of a batch together (one
// rank a step, a while_loop of branch-completion passes, a while_loop of
// walk steps), because the TPU has no scalar threads. Here a block stages
// each window in shared memory and its first warp runs the window's
// machine; the plain PyTorch version in ops/kernels/graph_consensus.py is
// the batched machine, and both give the same outputs, word for word.
//
// Reference semantics vendor/spoa graph.cpp:534-638, the rules of
// csrc/poagraph.cpp:370-443:
//   * a rank step: lanes 0..P-1 hold the node's in-slots (tail, weight);
//     each takes its tail's score; the winning slot is the lexicographic
//     maximum of (weight, tail score), the LAST maximal slot on a full tie
//     (two warp maxima, then 31 - __clz of a ballot); no usable slot gives
//     score -1 and predecessor -1; every lane writes both and keeps the
//     running FIRST strict maximum (the first rank a pass processes always
//     takes it)
//   * a branch-completion pass: lane q (q < the start's out-degree) sets -1
//     on the in-slot tails, other than the start, of the start's q-th
//     out-head; then the ranks past the start's are scanned again, tails of
//     score -1 skipped; a pass that processes no rank keeps the start; the
//     passes go on while the start has out-edges, at most max_iters of
//     them, and a window still going then is flagged
//   * the walk: from the start along predecessors until -1 (lane 0, at most
//     walk_steps steps, the JAX loop's cap), into the scores' row, which
//     the walk no longer needs; then the block writes the path reversed
// Scores are int32 as in JAX: a path score is at most N x the largest edge
// weight, 2048 x (64 sequences x 2 x 1000) < 2^31 under the port's ladders.
//
// The design: a block of 16 warps stages the window's n = min(n_nodes, N)
// ranks in rank order beside the scores and predecessors: rank r's node
// (rank_to_node[r], clamped) and min(indeg, P) packed in a word, its
// in-slot tails (uint16, clamped) and weights (int32), about 100 bytes a
// rank at P = 16. So rank r + 2's row is a shared load whose address
// depends on no load, issued while step r reduces, and the tails' scores
// of rank r + 1 are read then as well: a step's one store, to its own
// node's score, reaches the next step through registers (the last written
// node and score, taken where a lane's tail is that node), so no load is
// on the chain of steps. What remains on it: the two warp maxima, a ballot,
// a shuffle and the stores, which every lane makes (so its own reads of
// the steps after see them, with no __syncwarp a step). The rival tails'
// marking reads out_nbr and the heads' in-slots where they lie (a few
// times a window). A window whose ranks pass a block's shared memory (n over 1668
// at N = 8192, 1996 at 4096, P = 16) reads its rows where they lie
// (rank_to_node, then the row, two steps ahead), chosen per window inside
// the kernel (bundle_rank_cap).
//
// What bounds it: the chain of dependent rank steps, n_nodes steps a pass,
// one window a block (B <= 64 windows fill half the SMs with one warp
// walking each). Neither bytes nor operations come near the card's rates;
// see chip_smoke.py's phase 8.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemOptin = 232448;  // a block's shared memory on sm_90 (227 KB)
constexpr int kBundleThreads = 512;
// the kernel's static shared memory (the path's length), rounded up
constexpr int kStaticBytes = 16;
// elements a staging pass loads before it stores them
constexpr int kStageUnroll = 8;

__device__ __forceinline__ int clamp_hi(int v, int hi) { return v < hi ? v : hi; }

// G6's shared memory in bytes with `cap` ranks staged: the scores and
// predecessors [N] int32, then each staged rank's node and usable slot
// count packed in a word [cap], its in-slot weights int32 [cap, P] and
// tails uint16 [cap, P] (rounded up to a word)
__host__ __device__ inline size_t bundle_smem_bytes(int N, int P, int cap) {
  return 8 * (size_t)N + 4 * (size_t)cap * (1 + P) + ((2 * (size_t)cap * P + 3) & ~(size_t)3);
}

// The ranks G6 stages: a window's n = min(n_nodes, N) ranks where n is at
// most this, N or as many as a block's shared memory holds beside the
// scores and predecessors (and the kernel's static word, kStaticBytes)
__host__ __device__ inline int bundle_rank_cap(int N, int P) {
  long long cap = ((long long)kSmemOptin - kStaticBytes - 8LL * N - 3) / (6LL * P + 4);
  if (cap > N) cap = N;
  return cap > 0 ? (int)cap : 0;
}

// One rank's row: the node, its usable slot count (the in-degree, at most
// P) and this lane's in-slot (tail, weight).
struct RankRow {
  int v, d, t, w;
};

// The rows of window b's ranks as a lane sees them: staged (kStaged:
// node[r] = v | d << 16, tails and weights [n, P]), else where they lie,
// read as the plain machine clamps them.
template <bool kStaged>
struct Rows {
  const int *in_nbr, *in_w, *indeg, *rank_to_node;
  const int* node;
  const int* wts;
  const unsigned short* ids;
  size_t row0;
  int N, P;

  __device__ __forceinline__ RankRow at(int r, int lane) const {
    RankRow x;
    const bool on = lane < P;
    if constexpr (kStaged) {
      const int s = node[r];
      x.v = s & 0xffff;
      x.d = s >> 16;
      x.t = on ? ids[r * P + lane] : 0;
      x.w = on ? wts[r * P + lane] : 0;
    } else {
      x.v = clamp_hi(max(rank_to_node[row0 + r], 0), N - 1);
      const size_t rv = row0 + x.v;
      x.d = clamp_hi(indeg[rv], P);
      x.t = on ? clamp_hi(max(in_nbr[rv * P + lane], 0), N - 1) : 0;
      x.w = on ? in_w[rv * P + lane] : 0;
    }
    return x;
  }
};

// A rank's weight maximum over its usable slots (INT_MIN: none) and the
// ballot of them; kSkip also drops the slots whose tail scores -1.
template <bool kSkip>
__device__ __forceinline__ void weight_max(const RankRow& x, int sc, int lane, bool& ok,
                                           unsigned& any, int& mw) {
  ok = lane < x.d;
  if (kSkip) ok = ok && sc != -1;
  any = __ballot_sync(kFull, ok);
  mw = __reduce_max_sync(kFull, ok ? x.w : INT_MIN);
}

// One pass over ranks lo < r < n (every lane the same control flow). Writes
// scores and preds of the processed nodes; returns the pass's first strict
// maximum in rank order, -1 where no rank was processed. At step r the
// registers hold rank r's row (cur) and its tails' scores as they stood
// before step r - 1 stored (pre), and rank r + 1's row (nxt); step r - 1's
// node and score (last_v, last_sc) stand in for a tail that is that node.
// The step first reads rank r + 2's row and rank r + 1's tails' scores,
// then reduces; a tail read as the step stores rank r's node may see
// either value, and takes last_sc at the next step all the same. Every
// lane makes the step's stores, of the same values to the same words, so
// that its own reads at the steps after see them: no __syncwarp orders
// them. Without kSkip a
// rank's usable slots and weight maximum do not depend on the scores: rank
// r + 1's are reduced at step r, off the chain of steps, which is then one
// maximum of the scores and a sum.
template <bool kStaged, bool kSkip>
__device__ int bundle_pass(const Rows<kStaged>& rows, int* scores, int* preds, int lo, int n,
                           int lane) {
  int r = lo + 1;
  if (r >= n) return -1;
  int maxn = -1, maxsc = 0;
  RankRow cur = rows.at(r, lane);
  RankRow nxt = r + 1 < n ? rows.at(r + 1, lane) : cur;
  int pre = scores[cur.t];
  int last_v = -1, last_sc = 0;
  bool ok = false;
  unsigned any = 0;
  int mw = 0;
  if (!kSkip) weight_max<false>(cur, 0, lane, ok, any, mw);
  for (; r < n; ++r) {
    const RankRow after = r + 2 < n ? rows.at(r + 2, lane) : nxt;
    const int nxt_pre = scores[nxt.t];
    bool nxt_ok = false;
    unsigned nxt_any = 0;
    int nxt_mw = 0;
    if (!kSkip) weight_max<false>(nxt, 0, lane, nxt_ok, nxt_any, nxt_mw);
    const int sc = cur.t == last_v ? last_sc : pre;
    if (kSkip) weight_max<true>(cur, sc, lane, ok, any, mw);
    const bool c2 = ok && cur.w == mw;
    const int ms = __reduce_max_sync(kFull, c2 ? sc : INT_MIN);
    const int new_sc = any ? mw + ms : -1;
    const unsigned c3 = __ballot_sync(kFull, c2 && sc == ms);
    const int tail = __shfl_sync(kFull, cur.t, c3 ? 31 - __clz(c3) : 0);
    scores[cur.v] = new_sc;
    preds[cur.v] = any ? tail : -1;
    if (maxn == -1 || maxsc < new_sc) {
      maxn = cur.v;
      maxsc = new_sc;
    }
    last_v = cur.v;
    last_sc = new_sc;
    cur = nxt;
    nxt = after;
    pre = nxt_pre;
    ok = nxt_ok;
    any = nxt_any;
    mw = nxt_mw;
  }
  return maxn;
}

// Warp 0's passes of window b over its n ranks (n > 0), staged or where
// they lie: the first pass, then the branch-completion passes. Returns the
// start of the walk; `active`: still going after max_iters passes.
template <bool kStaged>
__device__ int bundle_passes(const Rows<kStaged>& rows, const int* __restrict__ out_nbr,
                             const int* __restrict__ out_deg, const int* __restrict__ rank_of,
                             int* scores, int* preds, int n, int Q, int max_iters, int lane,
                             bool& active) {
  const int *in_nbr = rows.in_nbr, *indeg = rows.indeg;
  const size_t row0 = rows.row0;
  const int N = rows.N, P = rows.P;
  int maxn = bundle_pass<kStaged, false>(rows, scores, preds, -1, n, lane);
  active = out_deg[row0 + maxn] > 0;
  for (int it = 0; active && it < max_iters; ++it) {
    // rival tails: the in-slot tails, other than maxn, of maxn's out-heads
    const int od = clamp_hi(out_deg[row0 + maxn], Q);
    if (lane < od) {
      const int h = clamp_hi(max(out_nbr[(row0 + maxn) * Q + lane], 0), N - 1);
      const int hd = clamp_hi(indeg[row0 + h], P);
      for (int p = 0; p < hd; ++p) {
        const int t = clamp_hi(max(in_nbr[(row0 + h) * P + p], 0), N - 1);
        if (t != maxn) scores[t] = -1;
      }
    }
    __syncwarp();
    const int found =
        bundle_pass<kStaged, true>(rows, scores, preds, rank_of[row0 + maxn], n, lane);
    if (found >= 0) maxn = found;
    active = found >= 0 && out_deg[row0 + maxn] > 0;
  }
  return maxn;
}

// A block a window b. in_nbr/in_w [B, N, P] (in-edge tails and weights,
// slot order), indeg [B, N], out_nbr [B, N, Q] (out-edge heads), out_deg
// [B, N], rank_of/rank_to_node [B, N], n_nodes [B]. Writes cons [B, N] (the
// path's node ids left-packed, 0 past it), cons_len [B] and overflow [B]
// (1: branch completion still going after max_iters passes). The block
// stages the window's ranks where n <= cap (bundle_rank_cap); warp 0 runs
// the passes and the walk; the block writes the path.
__global__ void __launch_bounds__(kBundleThreads)
graph_bundle_kernel(const int* __restrict__ in_nbr, const int* __restrict__ in_w,
                    const int* __restrict__ indeg, const int* __restrict__ out_nbr,
                    const int* __restrict__ out_deg, const int* __restrict__ rank_of,
                    const int* __restrict__ rank_to_node, const int* __restrict__ n_nodes,
                    int* __restrict__ cons, int* __restrict__ cons_len,
                    int* __restrict__ overflow, int N, int P, int Q, int max_iters,
                    int walk_steps, int cap) {
  extern __shared__ int4 smem4[];
  __shared__ int path_len;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const size_t row0 = (size_t)b * N;
  int* scores = reinterpret_cast<int*>(smem4);
  int* preds = scores + N;
  int* node = preds + N;
  int* wts = node + cap;
  unsigned short* ids = reinterpret_cast<unsigned short*>(wts + (size_t)cap * P);
  const int n = clamp_hi(n_nodes[b], N);
  const int ranks = n <= cap && n > 0 ? n : 0;  // the ranks staged
  for (int i = tid; i < N; i += kBundleThreads) scores[i] = preds[i] = -1;
  for (int r = tid; r < ranks; r += kBundleThreads) {
    const int v = clamp_hi(max(rank_to_node[row0 + r], 0), N - 1);
    const int d = clamp_hi(indeg[row0 + v], P);
    node[r] = (int)(((unsigned)d << 16) | (unsigned)v);
  }
  __syncthreads();
  // each staged rank's in-slots, kStageUnroll gathers in flight a thread
  // before their stores
  const int m = ranks * P;
  for (int base = tid; base < m; base += kStageUnroll * kBundleThreads) {
    int t[kStageUnroll], w[kStageUnroll];
#pragma unroll
    for (int k = 0; k < kStageUnroll; ++k) {
      const int i = base + k * kBundleThreads;
      t[k] = w[k] = 0;
      if (i < m) {
        const int r = i / P;
        const size_t at = (row0 + (node[r] & 0xffff)) * P + (i - r * P);
        t[k] = in_nbr[at];
        w[k] = in_w[at];
      }
    }
#pragma unroll
    for (int k = 0; k < kStageUnroll; ++k) {
      const int i = base + k * kBundleThreads;
      if (i < m) {
        ids[i] = (unsigned short)clamp_hi(max(t[k], 0), N - 1);
        wts[i] = w[k];
      }
    }
  }
  __syncthreads();
  if (tid < 32) {
    int maxn = 0;
    bool active = false;
    if (n > 0 && ranks == n) {
      const Rows<true> rows{in_nbr, in_w, indeg, rank_to_node, node, wts, ids, row0, N, P};
      maxn = bundle_passes(rows, out_nbr, out_deg, rank_of, scores, preds, n, Q, max_iters,
                           lane, active);
    } else if (n > 0) {
      const Rows<false> rows{in_nbr, in_w, indeg, rank_to_node, node, wts, ids, row0, N, P};
      maxn = bundle_passes(rows, out_nbr, out_deg, rank_of, scores, preds, n, Q, max_iters,
                           lane, active);
    }
    // the backward walk, into the scores' row
    __syncwarp();
    if (lane == 0) {
      int k = 0;
      if (n > 0) {
        int cur = maxn;
        for (int s = 0; s < walk_steps; ++s) {
          scores[clamp_hi(k, N - 1)] = cur;
          ++k;
          const int nxt = preds[cur];
          if (nxt < 0) break;
          cur = clamp_hi(nxt, N - 1);
        }
      }
      path_len = k;
      cons_len[b] = k;
      overflow[b] = active ? 1 : 0;
    }
  }
  __syncthreads();
  const int k = path_len;
  for (int i = tid; i < N; i += kBundleThreads)
    cons[row0 + i] = i < k ? scores[min(max(k - 1 - i, 0), N - 1)] : 0;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int graph_bundle_launch(const int* in_nbr, const int* in_w, const int* indeg, const int* out_nbr,
                        const int* out_deg, const int* rank_of, const int* rank_to_node,
                        const int* n_nodes, int* cons, int* cons_len, int* overflow, int B, int N,
                        int P, int Q, int max_iters, int walk_steps, void* stream) {
  const int cap = bundle_rank_cap(N, P);
  const size_t smem = bundle_smem_bytes(N, P, cap);
  if (smem > (size_t)kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_bundle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  graph_bundle_kernel<<<B, kBundleThreads, smem, (cudaStream_t)stream>>>(
      in_nbr, in_w, indeg, out_nbr, out_deg, rank_of, rank_to_node, n_nodes, cons, cons_len,
      overflow, N, P, Q, max_iters, walk_steps, cap);
  return (int)cudaGetLastError();
}

// G6's rank capacity at (N, P) (bundle_rank_cap) and shared memory in
// bytes: out[0..1]
int graph_bundle_smem(int N, int P, int* out) {
  out[0] = bundle_rank_cap(N, P);
  out[1] = (int)bundle_smem_bytes(N, P, out[0]);
  return 0;
}

// registers a thread, static shared memory and local memory of G6: out[0..2]
int graph_consensus_attrs(int* out) {
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, (const void*)graph_bundle_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = (int)at.localSizeBytes;
  return 0;
}

}  // extern "C"
