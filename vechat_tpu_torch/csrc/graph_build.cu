// The three stepping machines of round 1's incremental build for Hopper
// (sm_90a), with a plain C interface for ctypes: G3, the topological order
// with aligned-node bundles; G4, the AddAlignment fusion walk; G5, the
// backward reachability of the positional subgraph.
//
// Replaces vechat_tpu/ops/kernels/graph_build.py: topo_ranks_bundled,
// fuse_alignments and the fixpoint loop of positional_subgraph, three XLA
// loops that step every window of a batch together (one node push or pop,
// one pair, or one round of propagation a step), because the TPU has no
// scalar threads. Here each window is one warp running its own machine; the
// plain PyTorch versions in ops/kernels/graph_build.py are the batched
// machines, and both give the same outputs, word for word.
//
// G3 (graph_topo_bundled_kernel), reference semantics graph.cpp:301-371,
// the rule of csrc/poagraph.cpp:96-140: G2's machine (graph_cycle.cu) with
// the rings. Lanes 0..P-1 hold the top node's in-slots and lanes P..P+R-1
// its ring members (P + R <= 32). A dependency is unmet when it has not
// been emitted; ring members count only for a node outside a bundle. The
// ring lanes lie above the slot lanes, so the highest set bit of the ballot
// is the last unmet ring member, else the last unmet in-slot: the one the
// batched machine pushes. Every unmet ring member is claimed into the
// bundle the moment the top scans it. A node emits when nothing is unmet; a
// representative (a node outside a bundle) appends itself and then its
// whole ring to the order. The next root is the first id neither emitted
// nor in a bundle; both sets only grow, so a cursor that never moves back
// finds it. The steps are capped where the JAX loop stops (topo_steps), and
// the stack and rank writes clamp to the last slot as JAX does, so a cyclic
// graph (only in a window already flagged) stays inside the arrays.
//
// G4 (graph_fuse_kernel), graph.cpp:182-299 and csrc/poagraph.cpp:142-201:
// one warp a window runs JAX's walk in its order. First the unaligned
// prefix run [0, vfront), then the suffix run [vback + 1, slen), each a
// chain of new nodes; then the pairs of rows L - count .. L - 1 (a new node,
// the aligned node or a ring member with the same code, a new node
// ring-linked to its column); then the bridge into the suffix run. Every
// lane runs the same uniform control flow; lane 0 (or lane r for ring slot
// r) stores, and a __syncwarp orders the stores before the next reads. An
// edge merges into the first (tail, head) edge below n_edges, found by a
// ballot over the (tail, head) table kept in shared memory 32 edges at a
// time, else it is appended. Writes past N, E or R clamp to the last slot
// and set the window's overflow bits, as JAX does.
//
// G5 (graph_reach_kernel), graph.cpp:640-666: the nodes >= begin (and
// below n_nodes) from which `end` is reached along in-edges and rings. The
// result is a set, so a depth-first traversal gives the JAX fixpoint's: a
// stack and a visited bitmap in shared memory, the in-edges from a CSR
// built by torch ops, each new node claimed by an atomicOr on the bitmap
// and pushed at its ballot rank.
//
// What bounds them: chains of dependent steps, one window a warp and one
// warp a block (B <= 64 windows fill half the SMs with one warp each).
// G3 and G5 take about 2 steps a node; G4 a step a pair plus its edge
// search (n_edges / 32 ballots from shared memory). Neither bytes nor
// operations come near the card's rates; see chip_smoke.py's phase 7.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ bool bit_of(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void set_bit(unsigned* bits, int i) {
  bits[i >> 5] |= 1u << (i & 31);
}

// true for the lane that set the bit (it was clear)
__device__ __forceinline__ bool claim_bit(unsigned* bits, int i) {
  const unsigned m = 1u << (i & 31);
  return !(atomicOr(&bits[i >> 5], m) & m);
}

__device__ __forceinline__ int clamp_hi(int v, int hi) { return v < hi ? v : hi; }

// One warp a window b. in_nbr [B, N, P] (in-edge tails, slot order, padding
// 0), indeg [B, N], aligned [B, N, R] (ring members, insertion order),
// acount [B, N], n_nodes [B]. Writes rank_of and rank_to_node [B, N] (0
// where nothing was ranked). Shared memory: the emitted and bundle bitmaps
// (N bits each) and the stack (N int32).
__global__ void __launch_bounds__(32)
graph_topo_bundled_kernel(const int* __restrict__ in_nbr, const int* __restrict__ indeg,
                          const int* __restrict__ aligned, const int* __restrict__ acount,
                          const int* __restrict__ n_nodes, int* __restrict__ rank_of,
                          int* __restrict__ rank_to_node, int N, int P, int R, int max_steps) {
  extern __shared__ unsigned smem[];
  const int words = (N + 31) >> 5;
  unsigned* emitted = smem;
  unsigned* bundled = smem + words;
  int* stack = reinterpret_cast<int*>(smem + 2 * words);
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t row0 = (size_t)b * N;
  for (int i = lane; i < N; i += 32) {
    rank_of[row0 + i] = 0;
    rank_to_node[row0 + i] = 0;
  }
  for (int i = lane; i < words; i += 32) emitted[i] = bundled[i] = 0;
  __syncwarp();
  const int n = n_nodes[b];
  const int ids = clamp_hi(n, N);  // the ids a root can take
  int sp = 0, rcnt = 0, cursor = 0;
  for (int step = 0; step < max_steps && (sp > 0 || rcnt < n); ++step) {
    if (sp == 0) {
      while (cursor < ids && (bit_of(emitted, cursor) || bit_of(bundled, cursor))) ++cursor;
      if (lane == 0) stack[0] = cursor < ids ? cursor : 0;  // none: argmax of nothing, 0
      sp = 1;
      __syncwarp();
      continue;  // the root's dependencies are read at the next step
    }
    const int v = stack[clamp_hi(sp - 1, N - 1)];
    const size_t rv = row0 + v;
    // one load a lane (its in-slot or ring slot), in flight with the two
    // counts: no branch between the slot lanes and the ring lanes
    const int r = lane - P;
    const bool held = lane < P + R;
    const int* src = lane < P ? in_nbr + rv * P + lane : aligned + rv * R + r;
    const int node = held ? *src : 0;
    const int dv = indeg[rv];
    const int av = acount[rv];
    const bool vb = bit_of(bundled, v);
    const bool live = lane < P ? lane < dv : (!vb && r < av);
    const bool unmet = held && live && !bit_of(emitted, node);
    const unsigned ball = __ballot_sync(kFull, unmet);
    if (ball) {
      // the ballot has synchronised the warp: every read of the bundle
      // bitmap above is done before these claims
      const int u = __shfl_sync(kFull, node, 31 - __clz(ball));
      if (unmet && lane >= P) atomicOr(&bundled[node >> 5], 1u << (node & 31));
      if (lane == 0) stack[clamp_hi(sp, N - 1)] = u;
      ++sp;
    } else {
      if (lane == 0) set_bit(emitted, v);
      if (!vb) {
        if (lane == 0) {
          rank_to_node[row0 + clamp_hi(rcnt, N - 1)] = v;
          rank_of[rv] = rcnt;
        }
        if (lane >= P && r < R && r < av) {
          const int pos = rcnt + 1 + r;
          rank_to_node[row0 + clamp_hi(pos, N - 1)] = node;
          rank_of[row0 + node] = pos;
        }
        rcnt += 1 + av;
      }
      --sp;
    }
    __syncwarp();
  }
}

// One warp a window b. off [B * N + 1] and csr_tails (the valid in-edges of
// node v of window b at off[b * N + v] up to the next), aligned [B, N, R],
// acount [B, N], begin/end/n_nodes [B], use_full [B]. Writes keep [B, N]
// (0 or 1). Shared memory: the kept bitmap (N bits) and the stack (N int32).
__global__ void __launch_bounds__(32)
graph_reach_kernel(const int* __restrict__ off, const int* __restrict__ csr_tails,
                   const int* __restrict__ aligned, const int* __restrict__ acount,
                   const int* __restrict__ begin, const int* __restrict__ end,
                   const unsigned char* __restrict__ use_full, const int* __restrict__ n_nodes,
                   unsigned char* __restrict__ keep, int N, int R) {
  extern __shared__ unsigned smem[];
  const int words = (N + 31) >> 5;
  unsigned* kept = smem;
  int* stack = reinterpret_cast<int*>(smem + words);
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t row0 = (size_t)b * N;
  const int real = clamp_hi(n_nodes[b], N);  // ids below n_nodes
  if (use_full[b]) {
    for (int i = lane; i < N; i += 32) keep[row0 + i] = i < real;
    return;
  }
  for (int i = lane; i < words; i += 32) kept[i] = 0;
  __syncwarp();
  const int lo = begin[b], e = end[b];
  const int first = lo > 0 ? lo : 0;  // the least id kept
  int sp = 0;
  if (e >= lo && e >= 0 && e < real) {
    if (lane == 0) {
      set_bit(kept, e);
      stack[0] = e;
    }
    sp = 1;
  }
  __syncwarp();
  const unsigned below = (1u << lane) - 1;
  while (sp > 0) {
    const int v = stack[sp - 1];
    --sp;
    __syncwarp();  // the pop is read before a push takes its slot
    const size_t rv = row0 + v;
    // the ring and the CSR bounds are loaded together, ahead of the edges
    const int av = clamp_hi(acount[rv], R);
    const int m = lane < R ? aligned[rv * R + lane] : 0;
    const int e1 = off[rv + 1];
    for (int base = off[rv]; base < e1; base += 32) {
      const int k = base + lane;
      int t = 0;
      bool mine = false;
      if (k < e1) {
        t = csr_tails[k];
        mine = t >= first && t < real && claim_bit(kept, t);
      }
      const unsigned ball = __ballot_sync(kFull, mine);
      if (mine) stack[sp + __popc(ball & below)] = t;
      sp += __popc(ball);
    }
    const bool mine = lane < av && m >= first && m < real && claim_bit(kept, m);
    const unsigned ball = __ballot_sync(kFull, mine);
    if (mine) stack[sp + __popc(ball & below)] = m;
    sp += __popc(ball);
    __syncwarp();
  }
  for (int i = lane; i < N; i += 32) keep[row0 + i] = bit_of(kept, i);
}

constexpr int kOvfNodes = 1, kOvfEdges = 2, kOvfRings = 4;

// One window's graph, its sequence and its walk state; every field uniform
// across the warp.
struct Fuse {
  int* codes;
  int2* th;  // shared: (tail, head) of every edge slot
  int* weights;
  int* aligned;
  int* acount;
  int* lab_lo;
  int* lab_hi;
  int bit_lo, bit_hi;
  const int* seq;
  const int* seq_w;
  int N, E, R, W;
  int n_nodes, n_edges, ovf;
  int lane;

  __device__ int at(const int* a, int i) const { return a[i < 0 ? 0 : (i < W ? i : W - 1)]; }

  // A new node with `code`; its id, clamped to N - 1 past the cap.
  __device__ int add_node(int code) {
    const int pos = clamp_hi(n_nodes, N - 1);
    if (lane == 0) codes[pos] = code;
    ++n_nodes;
    __syncwarp();
    return pos;
  }

  // Merge w into the first (t -> h) edge below n_edges, else append it.
  __device__ void add_edge(int t, int h, int w) {
    const int lim = clamp_hi(n_edges, E);
    int found = -1;
    for (int base = 0; base < lim; base += 32) {
      const int e = base + lane;
      bool hit = false;
      if (e < lim) {
        const int2 x = th[e];
        hit = x.x == t && x.y == h;
      }
      const unsigned ball = __ballot_sync(kFull, hit);
      if (ball) {
        found = base + __ffs(ball) - 1;
        break;
      }
    }
    if (found >= 0) {
      if (lane == 0) {
        weights[found] += w;
        if (lab_lo) {
          lab_lo[found] |= bit_lo;
          lab_hi[found] |= bit_hi;
        }
      }
    } else {
      const int pos = clamp_hi(n_edges, E - 1);
      if (lane == 0) {
        th[pos] = make_int2(t, h);
        weights[pos] = w;
        if (lab_lo) {
          lab_lo[pos] = bit_lo;
          lab_hi[pos] = bit_hi;
        }
      }
      if (n_edges >= E) ovf |= kOvfEdges;
      ++n_edges;
    }
    __syncwarp();
  }

  // A chain of new nodes for positions [lo, hi); returns (last, first).
  __device__ int2 run(int lo, int hi) {
    int prev = -1, first = -1;
    for (int i = lo; i < hi; ++i) {
      const int nid = add_node(at(seq, i));
      if (prev >= 0 && i > lo) add_edge(prev, nid, at(seq_w, i - 1) + at(seq_w, i));
      if (first < 0) first = nid;
      prev = nid;
    }
    return make_int2(prev, first);
  }

  // One matched pair (a_n: node id or -1, a_p: position >= 0); returns curr.
  __device__ int pair(int a_n, int a_p) {
    const int code = at(seq, a_p);
    const bool is_new = a_n < 0;
    const int jt = a_n < 0 ? 0 : clamp_hi(a_n, N - 1);
    const bool jt_match = !is_new && codes[jt] == code;
    const int av = acount[jt];
    // lane r holds ring slot r of jt, read before anything changes
    int m = 0, m_pos = 0;
    bool hit = false;
    if (lane < R) {
      m = aligned[jt * R + lane];
      m_pos = clamp_hi(acount[m], R - 1);
      hit = !is_new && !jt_match && lane < av && codes[m] == code;
    }
    const unsigned ring_hit = __ballot_sync(kFull, hit);
    const int ring_node = __shfl_sync(kFull, m, ring_hit ? __ffs(ring_hit) - 1 : 0);
    const bool need_new = is_new || (!jt_match && !ring_hit);
    const int new_id = need_new ? add_node(code) : 0;
    const int curr = jt_match ? jt : (ring_hit ? ring_node : new_id);
    if (need_new && !is_new) {
      // every member gets curr appended; curr's ring is the members, then
      // jt; jt gets curr (graph.cpp:260-279), in JAX's order of scatters
      const bool member = lane < R && lane < av;
      if (member) {
        aligned[m * R + m_pos] = curr;
        atomicAdd(&acount[m], 1);
      }
      __syncwarp();
      if (member) aligned[curr * R + lane] = m;
      __syncwarp();
      const int slot = clamp_hi(av, R - 1);
      if (lane == 0) {
        aligned[curr * R + slot] = jt;
        acount[curr] = av + 1;
        aligned[jt * R + slot] = curr;
        acount[jt] += 1;
      }
      if (av + 1 > R) ovf |= kOvfRings;
      __syncwarp();
    }
    return curr;
  }
};

// One warp a window b: the graph buffers codes [B, N], tails/heads/weights
// [B, E], n_nodes/n_edges [B], aligned [B, N, R], acount [B, N] and, with
// labels, lab_lo/lab_hi [B, E] are updated in place; pairs [B, L, 2] (node
// id | -1, position | -1; the last `count` rows), seq/seq_w [B, W],
// seq_len [B], active [B], bit_lo/bit_hi [B]. Writes overflow [B] (bits).
// Shared memory: the (tail, head) table, E int2.
__global__ void __launch_bounds__(32)
graph_fuse_kernel(int* codes, int* tails, int* heads, int* weights, int* n_nodes, int* n_edges,
                  int* aligned, int* acount, int* lab_lo, int* lab_hi,
                  const int* __restrict__ bit_lo, const int* __restrict__ bit_hi,
                  const int* __restrict__ pairs, const int* __restrict__ count,
                  const int* __restrict__ seq, const int* __restrict__ seq_w,
                  const int* __restrict__ seq_len, const unsigned char* __restrict__ active,
                  int* __restrict__ overflow, int N, int E, int R, int L, int W, int track) {
  extern __shared__ int2 th[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t eb = (size_t)b * E;
  for (int i = lane; i < E; i += 32) th[i] = make_int2(tails[eb + i], heads[eb + i]);
  Fuse f;
  f.codes = codes + (size_t)b * N;
  f.th = th;
  f.weights = weights + eb;
  f.aligned = aligned + (size_t)b * N * R;
  f.acount = acount + (size_t)b * N;
  f.lab_lo = track ? lab_lo + eb : nullptr;
  f.lab_hi = track ? lab_hi + eb : nullptr;
  f.bit_lo = track ? bit_lo[b] : 0;
  f.bit_hi = track ? bit_hi[b] : 0;
  f.seq = seq + (size_t)b * W;
  f.seq_w = seq_w + (size_t)b * W;
  f.N = N;
  f.E = E;
  f.R = R;
  f.W = W;
  f.n_nodes = n_nodes[b];
  f.n_edges = n_edges[b];
  f.ovf = 0;
  f.lane = lane;
  __syncwarp();

  // vfront / vback: the first and last sequence position of the pairs
  const int* pr = pairs + (size_t)b * L * 2;
  const int cnt = count[b];
  const int k0 = L - cnt > 0 ? L - cnt : 0;
  int vfront = 1 << 30, vback = -1;
  for (int k = k0 + lane; k < L; k += 32) {
    const int p = pr[2 * k + 1];
    if (p >= 0) {
      vfront = min(vfront, p);
      vback = max(vback, p);
    }
  }
  vfront = __reduce_min_sync(kFull, vfront);
  vback = __reduce_max_sync(kFull, vback);
  const int slen = seq_len[b];
  // no pairs, or none with a position: the whole sequence is one run
  const bool no_aln = cnt == 0 || vback < 0;
  if (no_aln) {
    vfront = slen;
    vback = slen - 1;
  }
  if (active[b]) {
    const int prefix_prev = f.run(0, vfront).x;
    const int suffix_first = f.run(vback + 1, slen).y;
    int prev = prefix_prev;
    if (!no_aln) {
      for (int k = k0; k < L; ++k) {
        const int a_p = pr[2 * k + 1];
        if (a_p < 0) continue;
        const int curr = f.pair(pr[2 * k], a_p);
        if (prev >= 0) f.add_edge(prev, curr, f.at(f.seq_w, a_p - 1) + f.at(f.seq_w, a_p));
        prev = curr;
      }
      if (suffix_first >= 0 && prev >= 0)
        f.add_edge(prev, suffix_first, f.at(f.seq_w, vback) + f.at(f.seq_w, vback + 1));
    }
  }
  if (f.n_nodes > N) f.ovf |= kOvfNodes;
  if (f.n_edges > E) f.ovf |= kOvfEdges;
  __syncwarp();
  for (int i = lane; i < E; i += 32) {
    tails[eb + i] = th[i].x;
    heads[eb + i] = th[i].y;
  }
  if (lane == 0) {
    n_nodes[b] = f.n_nodes;
    n_edges[b] = f.n_edges;
    overflow[b] = f.ovf;
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

int graph_topo_bundled_launch(const int* in_nbr, const int* indeg, const int* aligned,
                              const int* acount, const int* n_nodes, int* rank_of,
                              int* rank_to_node, int B, int N, int P, int R, int max_steps,
                              void* stream) {
  const size_t smem = (size_t)((N + 31) / 32) * 8 + (size_t)N * 4;
  int rc = set_smem((const void*)graph_topo_bundled_kernel, smem);
  if (rc) return rc;
  graph_topo_bundled_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      in_nbr, indeg, aligned, acount, n_nodes, rank_of, rank_to_node, N, P, R, max_steps);
  return (int)cudaGetLastError();
}

int graph_reach_launch(const int* off, const int* csr_tails, const int* aligned,
                       const int* acount, const int* begin, const int* end,
                       const unsigned char* use_full, const int* n_nodes, unsigned char* keep,
                       int B, int N, int R, void* stream) {
  const size_t smem = (size_t)((N + 31) / 32) * 4 + (size_t)N * 4;
  int rc = set_smem((const void*)graph_reach_kernel, smem);
  if (rc) return rc;
  graph_reach_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(off, csr_tails, aligned, acount,
                                                            begin, end, use_full, n_nodes, keep,
                                                            N, R);
  return (int)cudaGetLastError();
}

int graph_fuse_launch(int* codes, int* tails, int* heads, int* weights, int* n_nodes,
                      int* n_edges, int* aligned, int* acount, int* lab_lo, int* lab_hi,
                      const int* bit_lo, const int* bit_hi, const int* pairs, const int* count,
                      const int* seq, const int* seq_w, const int* seq_len,
                      const unsigned char* active, int* overflow, int B, int N, int E, int R,
                      int L, int W, int track, void* stream) {
  const size_t smem = (size_t)E * sizeof(int2);
  int rc = set_smem((const void*)graph_fuse_kernel, smem);
  if (rc) return rc;
  graph_fuse_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, lab_lo, lab_hi, bit_lo,
      bit_hi, pairs, count, seq, seq_w, seq_len, active, overflow, N, E, R, L, W, track);
  return (int)cudaGetLastError();
}

}  // extern "C"
