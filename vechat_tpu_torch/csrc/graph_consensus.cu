// The heaviest-bundle machine of round 2's window consensus for Hopper
// (sm_90a), with a plain C interface for ctypes: G6, the scores and
// predecessors over the ranks, the branch-completion passes and the
// backward walk of one window a warp.
//
// Replaces vechat_tpu/ops/kernels/graph_consensus.py: heaviest_bundle (with
// _bundle_scan), XLA loops that step every window of a batch together (one
// rank a step, a while_loop of branch-completion passes, a while_loop of
// walk steps), because the TPU has no scalar threads. Here each window is
// one warp running its own machine; the plain PyTorch version in
// ops/kernels/graph_consensus.py is the batched machine, and both give the
// same outputs, word for word.
//
// Reference semantics vendor/spoa graph.cpp:534-638, the rules of
// csrc/poagraph.cpp:370-443:
//   * a rank step: lanes 0..P-1 hold the node's in-slots (tail, weight);
//     each reads its tail's score from shared memory; the winning slot is
//     the lexicographic maximum of (weight, tail score), the LAST maximal
//     slot on a full tie (two warp maxima, then 31 - __clz of a ballot);
//     no usable slot gives score -1 and predecessor -1; lane 0 writes both,
//     and every lane keeps the running FIRST strict maximum (the first rank
//     a pass processes always takes it)
//   * a branch-completion pass: lane q (q < the start's out-degree) sets -1
//     on the in-slot tails, other than the start, of the start's q-th
//     out-head; then the ranks past the start's are scanned again, tails of
//     score -1 skipped; a pass that processes no rank keeps the start; the
//     passes go on while the start has out-edges, at most max_iters of
//     them, and a window still going then is flagged
//   * the walk: from the start along predecessors until -1 (lane 0, at most
//     walk_steps steps, the JAX loop's cap), into the scores' row, which
//     the walk no longer needs; then every lane writes the path reversed
// Scores are int32 as in JAX: a path score is at most N x the largest edge
// weight, 2048 x (64 sequences x 2 x 1000) < 2^31 under the port's ladders.
//
// What bounds it: the chain of dependent rank steps (the tails' scores
// read from shared memory after the previous step's write, two reductions,
// a ballot, a shuffle, lane 0's stores), n_nodes steps a pass, one window a
// warp and one warp a block (B <= 64 windows fill half the SMs with one warp
// each). The next rank's node, in-degree and in-slot row do not depend on
// the scores: they are loaded while the current step reduces. Neither bytes
// nor operations come near the card's rates; see chip_smoke.py's phase 8.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ int clamp_hi(int v, int hi) { return v < hi ? v : hi; }

// One rank's row: the node, its usable slot count (the in-degree, at most
// P) and this lane's in-slot (tail, weight).
struct RankRow {
  int v, d, t, w;
};

__device__ __forceinline__ RankRow load_row(const int* __restrict__ in_nbr,
                                            const int* __restrict__ in_w,
                                            const int* __restrict__ indeg,
                                            const int* __restrict__ rank_to_node, size_t row0,
                                            int r, int N, int P, int lane) {
  RankRow x;
  x.v = clamp_hi(max(rank_to_node[row0 + r], 0), N - 1);
  const size_t rv = row0 + x.v;
  x.d = clamp_hi(indeg[rv], P);
  x.t = 0;
  x.w = 0;
  if (lane < P) {
    x.t = clamp_hi(max(in_nbr[rv * P + lane], 0), N - 1);
    x.w = in_w[rv * P + lane];
  }
  return x;
}

// One pass over ranks lo < r < n (every lane the same control flow). Writes
// scores and preds of the processed nodes; returns the pass's first strict
// maximum in rank order, -1 where no rank was processed.
__device__ int bundle_pass(const int* __restrict__ in_nbr, const int* __restrict__ in_w,
                           const int* __restrict__ indeg, const int* __restrict__ rank_to_node,
                           int* scores, int* preds, size_t row0, int N, int P, int lo, int n,
                           bool skip, int lane) {
  int maxn = -1, maxsc = 0;
  int r = lo + 1;
  if (r >= n) return -1;
  RankRow next = load_row(in_nbr, in_w, indeg, rank_to_node, row0, r, N, P, lane);
  for (; r < n; ++r) {
    const RankRow cur = next;
    // the next rank's row is in flight while this step reduces
    if (r + 1 < n) next = load_row(in_nbr, in_w, indeg, rank_to_node, row0, r + 1, N, P, lane);
    const int sc = scores[cur.t];
    bool ok = lane < cur.d;
    if (skip) ok = ok && sc != -1;
    int new_sc = -1, new_pred = -1;
    if (__ballot_sync(kFull, ok)) {
      const int mw = __reduce_max_sync(kFull, ok ? cur.w : INT_MIN);
      const bool c2 = ok && cur.w == mw;
      const int ms = __reduce_max_sync(kFull, c2 ? sc : INT_MIN);
      const unsigned c3 = __ballot_sync(kFull, c2 && sc == ms);
      new_pred = __shfl_sync(kFull, cur.t, 31 - __clz(c3));
      new_sc = mw + ms;
    }
    // every lane has read its tail's score (the reductions synchronised
    // the warp) before lane 0 writes
    __syncwarp();
    if (lane == 0) {
      scores[cur.v] = new_sc;
      preds[cur.v] = new_pred;
    }
    if (maxn == -1 || maxsc < new_sc) {
      maxn = cur.v;
      maxsc = new_sc;
    }
    __syncwarp();
  }
  return maxn;
}

// One warp a window b. in_nbr/in_w [B, N, P] (in-edge tails and weights,
// slot order), indeg [B, N], out_nbr [B, N, Q] (out-edge heads), out_deg
// [B, N], rank_of/rank_to_node [B, N], n_nodes [B]. Writes cons [B, N] (the
// path's node ids left-packed, 0 past it), cons_len [B] and overflow [B]
// (1: branch completion still going after max_iters passes). Shared
// memory: the scores and the predecessors (N int32 each).
__global__ void __launch_bounds__(32)
graph_bundle_kernel(const int* __restrict__ in_nbr, const int* __restrict__ in_w,
                    const int* __restrict__ indeg, const int* __restrict__ out_nbr,
                    const int* __restrict__ out_deg, const int* __restrict__ rank_of,
                    const int* __restrict__ rank_to_node, const int* __restrict__ n_nodes,
                    int* __restrict__ cons, int* __restrict__ cons_len,
                    int* __restrict__ overflow, int N, int P, int Q, int max_iters,
                    int walk_steps) {
  extern __shared__ int smem[];
  int* scores = smem;
  int* preds = smem + N;
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t row0 = (size_t)b * N;
  for (int i = lane; i < N; i += 32) scores[i] = preds[i] = -1;
  __syncwarp();
  const int n = clamp_hi(n_nodes[b], N);
  int maxn = 0;
  bool active = false;
  if (n > 0) {
    maxn = bundle_pass(in_nbr, in_w, indeg, rank_to_node, scores, preds, row0, N, P, -1, n,
                       false, lane);
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
      const int found = bundle_pass(in_nbr, in_w, indeg, rank_to_node, scores, preds, row0, N,
                                    P, rank_of[row0 + maxn], n, true, lane);
      if (found >= 0) maxn = found;
      active = found >= 0 && out_deg[row0 + maxn] > 0;
    }
  }
  // the backward walk, into the scores' row
  __syncwarp();
  int k = 0;
  if (lane == 0 && n > 0) {
    int cur = maxn;
    for (int s = 0; s < walk_steps; ++s) {
      scores[clamp_hi(k, N - 1)] = cur;
      ++k;
      const int nxt = preds[cur];
      if (nxt < 0) break;
      cur = clamp_hi(nxt, N - 1);
    }
  }
  k = __shfl_sync(kFull, k, 0);
  __syncwarp();
  for (int i = lane; i < N; i += 32)
    cons[row0 + i] = i < k ? scores[min(max(k - 1 - i, 0), N - 1)] : 0;
  if (lane == 0) {
    cons_len[b] = k;
    overflow[b] = active ? 1 : 0;
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= (size_t)kSmemDefault) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int graph_bundle_launch(const int* in_nbr, const int* in_w, const int* indeg, const int* out_nbr,
                        const int* out_deg, const int* rank_of, const int* rank_to_node,
                        const int* n_nodes, int* cons, int* cons_len, int* overflow, int B, int N,
                        int P, int Q, int max_iters, int walk_steps, void* stream) {
  const size_t smem = (size_t)N * 8;
  int rc = set_smem((const void*)graph_bundle_kernel, smem);
  if (rc) return rc;
  graph_bundle_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      in_nbr, in_w, indeg, out_nbr, out_deg, rank_of, rank_to_node, n_nodes, cons, cons_len,
      overflow, N, P, Q, max_iters, walk_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
