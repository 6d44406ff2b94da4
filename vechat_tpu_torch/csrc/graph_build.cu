// The three stepping machines of round 1's incremental build for Hopper
// (sm_90a), with a plain C interface for ctypes: G3, the topological order
// with aligned-node bundles; G4, the AddAlignment fusion walk; G5, the
// backward reachability of the positional subgraph.
//
// Replaces vechat_tpu/ops/kernels/graph_build.py: topo_ranks_bundled,
// fuse_alignments and the fixpoint loop of positional_subgraph, three XLA
// loops that step every window of a batch together (one node push or pop,
// one pair, or one round of propagation a step), because the TPU has no
// scalar threads. Here a block runs each window's machine: it stages the
// window in shared memory and its first warp walks; the plain PyTorch
// versions in ops/kernels/graph_build.py are the batched machines, and both
// give the same outputs, word for word.
//
// G3 (graph_topo_bundled_kernel), reference semantics graph.cpp:301-371,
// the rule of csrc/poagraph.cpp:96-140: G2's machine (graph_cycle.cu) with
// the rings. A block of 16 warps stages the window's in-slot and ring ids
// (uint16, a row of P + R a node) and (indeg, acount) pairs in shared
// memory beside the stack, both bitmaps and both outputs, which it writes
// back once at the end. Warp 0 walks: lanes 0..P-1 hold the top node's
// in-slots and lanes P..P+R-1 its ring members (P + R <= 32). A dependency
// is unmet when it has not been emitted; ring members count only for a node
// outside a bundle. The ring lanes lie above the slot lanes, so the highest
// set bit of the ballot is the last unmet ring member, else the last unmet
// in-slot: the one the batched machine pushes. Every unmet ring member is claimed into the bundle the
// moment the top scans it (an atomicOr, skipped for a node already
// claimed). A node emits when nothing is unmet; a representative (a node
// outside a bundle) appends itself and then its whole ring to the order.
// The top's row rides in registers from the step before: the lanes load
// the next top's row and counts before lane 0's stores (the node below the
// top, read at the step's start, for a pop; the pushed node at the
// decision), and read the bitmaps only after the step before has stored
// them; lane 0 sets an emitted bit by a plain store of the word it read. The next root is the first id
// neither emitted nor in a bundle; both sets only grow, so a cursor that
// never moves back finds it, a word of both bitmaps at a time. The steps
// are capped where the JAX loop stops (topo_steps), one push, pop or
// rooting a step, and the stack and rank writes clamp to the last slot as
// JAX does, so a cyclic graph (only in a window already flagged) stays
// inside the arrays; where a ring past R or ranks past N make several
// lanes write one slot, the last write in the plain machine's order wins.
// A window past shared memory (N = 4096 at P = 16, R = 8) takes the global
// form: the same machine reading the rows and counts where they lie.
//
// G4 (graph_fuse_kernel), graph.cpp:182-299 and csrc/poagraph.cpp:142-201:
// a block a window stages the window (the (tail, head) table, weights,
// labels, codes, rings and counts) in shared memory and lists each node's
// out-edges there (first_out, next_out: a push a slot by atomicExch);
// then its first warp runs JAX's walk in its order. First the unaligned
// prefix run [0, vfront), then the suffix run [vback + 1, slen), each a
// chain of new nodes; then the pairs of rows L - count .. L - 1 (a new node,
// the aligned node or a ring member with the same code, a new node
// ring-linked to its column); then the bridge into the suffix run. The
// lanes load 32 positions or pairs at a time (with their codes and edge
// weights) and the walk takes them by shuffles. Every lane runs the same
// uniform control flow; lane 0 (or lane r for ring slot r) stores, and a
// __syncwarp orders the stores before the next reads. An edge merges into
// the first (tail, head) edge below n_edges, the least index among the
// tail's listed out-edges with that head (slot E - 1, where appends past
// the cap land, is searched on its own), else it is appended and listed.
// Writes past N, E or R clamp to the last slot and set the window's
// overflow bits, as JAX does. Then the block writes the window back. A
// window past shared memory (fuse_smem_ints over the card's 227 KB) takes
// the global form: the table and the lists in a scratch buffer, the rest
// updated where it lies; the launcher's caller chooses by the size.
//
// G5 (graph_reach_kernel), graph.cpp:640-666: the nodes >= begin (and
// below n_nodes) from which `end` is reached along in-edges and rings. The
// result is a set, so a depth-first traversal gives the JAX fixpoint's. A
// block a window groups the valid edges with both ends in [begin, n_nodes)
// by head (a count a head by shared atomics, a block scan, a scatter) and
// stages the rings and counts; its first warp then pops up to four nodes a
// step, eight lanes a node taking its ring and then its in-edges eight at
// a time, each new node claimed by an atomicOr on a bitmap and pushed at
// its ballot rank, every load from shared memory. Past shared memory, the
// global form keeps the groups and the stack in a scratch buffer.
//
// What bounds them: chains of dependent steps, one window a block and one
// warp walking (B <= 64 windows fill half the SMs). G3 takes about 2 steps
// a node (a cyclic flagged window runs to its cap), each a shared load of
// the bitmaps, the ballot, its last lane and a shuffle from it, and the
// next row's shared load (`k1_probe.py latency` times each link); G4 a step a pair, its edge
// lookup a few dependent shared loads (the tail's out-degree); G5 a step
// for up to four kept nodes, so that the graph's depth below the end node
// bounds its steps. Neither bytes nor operations come near the card's
// rates; see chip_smoke.py's phase 7.

#include <cuda_runtime.h>

#include "block_scan.cuh"

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

constexpr int kTopoThreads = 512;
// elements a staging pass loads before it stores them
constexpr int kStageUnroll = 8;

// G3's shared memory in bytes. Both forms: the stack [N] int32 and the
// emitted and bundled bitmaps. The shared form also: each node's (indeg,
// acount) as an int2, rank_of and rank_to_node [N] int32, and each node's
// row of P in-slot and R ring ids as uint16 [N, P + R] (rounded up to a
// word).
__host__ __device__ inline size_t topo_smem_bytes(int N, int P, int R, bool shared) {
  const size_t n = N, words = (N + 31) / 32;
  size_t bytes = 4 * n + 8 * words;
  if (shared) bytes += 16 * n + ((2 * n * (P + R) + 3) & ~(size_t)3);
  return bytes;
}

// src [N, W] int32 (a window's rows, contiguous) into columns col0 ..
// col0 + W - 1 of dst [N, K] uint16, by the whole block, kStageUnroll
// coalesced loads in flight a thread before their stores.
__device__ __forceinline__ void stage_ids(unsigned short* dst, const int* __restrict__ src,
                                          int N, int W, int K, int col0) {
  const int n = N * W;
  for (int base = threadIdx.x; base < n; base += kStageUnroll * kTopoThreads) {
    int x[kStageUnroll];
#pragma unroll
    for (int r = 0; r < kStageUnroll; ++r) {
      const int i = base + r * kTopoThreads;
      x[r] = i < n ? src[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kStageUnroll; ++r) {
      const int i = base + r * kTopoThreads;
      if (i < n) {
        const int v = i / W;
        dst[v * K + col0 + (i - v * W)] = (unsigned short)x[r];
      }
    }
  }
}

// A block a window b. in_nbr [B, N, P] (in-edge tails, slot order, padding
// 0), indeg [B, N], aligned [B, N, R] (ring members, insertion order),
// acount [B, N], n_nodes [B]. Writes rank_of and rank_to_node [B, N] (0
// where nothing was ranked). kShared: the block stages the window's rows
// (ids as uint16: N <= 8192) and counts in shared memory and keeps the
// outputs there, written back at the end; else warp 0 reads the rows and
// counts where they lie and writes the outputs in place (zeroed by the
// block first). Warp 0 runs the machine. The top's row and counts are
// carried in registers and the next top's are loaded as the step decides,
// before its stores: the pushed node's on a push, the node below the top
// (read at the step's start) on a pop. The bitmaps are read only after the
// step before has stored.
template <bool kShared>
__global__ void __launch_bounds__(kTopoThreads)
graph_topo_bundled_kernel(const int* __restrict__ in_nbr, const int* __restrict__ indeg,
                          const int* __restrict__ aligned, const int* __restrict__ acount,
                          const int* __restrict__ n_nodes, int* __restrict__ rank_of,
                          int* __restrict__ rank_to_node, int N, int P, int R, int max_steps) {
  extern __shared__ int4 smem4[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int K = P + R, words = (N + 31) >> 5;
  const size_t row0 = (size_t)b * N;
  char* p = reinterpret_cast<char*>(smem4);
  int2* cnt = nullptr;
  unsigned short* ids = nullptr;
  int *rk = rank_of + row0, *r2n = rank_to_node + row0;
  if constexpr (kShared) {
    cnt = reinterpret_cast<int2*>(p);
    rk = reinterpret_cast<int*>(cnt + N);
    r2n = rk + N;
    p = reinterpret_cast<char*>(r2n + N);
  }
  int* stack = reinterpret_cast<int*>(p);
  unsigned* emitted = reinterpret_cast<unsigned*>(stack + N);
  unsigned* bundled = emitted + words;
  if constexpr (kShared) ids = reinterpret_cast<unsigned short*>(bundled + words);
  for (int i = tid; i < N; i += kTopoThreads) {
    rk[i] = 0;
    r2n[i] = 0;
  }
  for (int i = tid; i < words; i += kTopoThreads) emitted[i] = bundled[i] = 0;
  if constexpr (kShared) {
    for (int i = tid; i < N; i += kTopoThreads) cnt[i] = make_int2(indeg[row0 + i], acount[row0 + i]);
    stage_ids(ids, in_nbr + row0 * P, N, P, K, 0);
    stage_ids(ids, aligned + row0 * R, N, R, K, P);
  }
  __syncthreads();
  if (tid < 32) {
    const int n = n_nodes[b];
    const int last = clamp_hi(n, N);  // the ids a root can take
    const int r = lane - P;
    const bool held = lane < K;
    // lane's slot of node v (an in-slot, a ring slot or nothing) and v's
    // (indeg, acount)
    auto load = [&](int v, int& node, int2& c) {
      if constexpr (kShared) {
        node = held ? ids[v * K + lane] : 0;
        c = cnt[v];
      } else {
        const size_t rv = row0 + v;
        node = lane < P ? in_nbr[rv * P + lane] : (held ? aligned[rv * R + r] : 0);
        c = make_int2(indeg[rv], acount[rv]);
      }
    };
    int sp = 0, rcnt = 0, cursor = 0, v = 0, node = 0;
    int2 c = make_int2(0, 0);
    for (int step = 0; step < max_steps && (sp > 0 || rcnt < n); ++step) {
      if (sp == 0) {
        // the first id neither emitted nor bundled, a word at a time
        while (cursor < last) {
          const unsigned avail =
              ~(emitted[cursor >> 5] | bundled[cursor >> 5]) & (kFull << (cursor & 31));
          if (avail) {
            cursor = (cursor & ~31) + __ffs(avail) - 1;
            break;
          }
          cursor = (cursor & ~31) + 32;
        }
        v = cursor < last ? cursor : 0;  // none: argmax of nothing, 0
        load(v, node, c);
        if (lane == 0) stack[0] = v;
        sp = 1;
        __syncwarp();
        continue;  // the root's dependencies are read at the next step
      }
      // v = stack[min(sp - 1, N - 1)]. Read first, side by side: the bits
      // this step tests (a lane's slot of no live dependency reads a bit it
      // ignores; a claim of a node already bundled is skipped), v's word of
      // the emitted bitmap, and `below`, the top after a pop, with its row
      const int at = (unsigned)node < (unsigned)N ? node : 0;
      const bool done = bit_of(emitted, at);
      const bool claimed = bit_of(bundled, at);
      const unsigned ew = emitted[v >> 5];  // v's word, as it stands
      const bool vb = bit_of(bundled, v);
      const int below = stack[clamp_hi(sp > 1 ? sp - 2 : 0, N - 1)];
      int below_node;
      int2 below_c;
      load(below, below_node, below_c);
      const int dv = c.x, av = c.y;
      const bool live = lane < P ? lane < dv : (!vb && r < av);
      const bool unmet = held && live && !done;
      const unsigned ball = __ballot_sync(kFull, unmet);
      if (ball) {
        // the ballot has synchronised the warp: every read of the bundle
        // bitmap above is done before these claims
        const int u = __shfl_sync(kFull, node, 31 - __clz(ball));
        if (unmet && lane >= P && !claimed) atomicOr(&bundled[node >> 5], 1u << (node & 31));
        load(u, node, c);  // the pushed node's row, before the stack's store
        if (lane == 0) stack[clamp_hi(sp, N - 1)] = u;
        ++sp;
        v = u;
      } else {
        if (lane == 0) emitted[v >> 5] = ew | (1u << (v & 31));  // only lane 0 writes it
        if (!vb) {
          if (lane == 0) {
            r2n[clamp_hi(rcnt, N - 1)] = v;
            rk[v] = rcnt;
          }
          const bool ring_on = lane >= P && r < R && r < av;
          const int pos = clamp_hi(rcnt + 1 + r, N - 1);
          if (av > R || rcnt + av > N - 1) {
            // a ring past its cap (its slots may repeat a node) or ranks
            // past N (clamped to one slot), only in a flagged window: the
            // plain machine's scatters, where the last write to a slot
            // wins, lane 0's first
            __syncwarp();
            const unsigned on = __ballot_sync(kFull, ring_on);
            const unsigned later = ~((2u << lane) - 1);
            const unsigned same_pos = __match_any_sync(kFull, pos) & on & later;
            const unsigned same_node = __match_any_sync(kFull, node) & on & later;
            if (ring_on && !same_pos) r2n[pos] = node;
            if (ring_on && !same_node) rk[node] = rcnt + 1 + r;
          } else if (ring_on) {
            r2n[pos] = node;
            rk[node] = pos;
          }
          rcnt += 1 + av;
        }
        --sp;
        v = below;
        node = below_node;
        c = below_c;
      }
      __syncwarp();
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int i = tid; i < N; i += kTopoThreads) {
      rank_of[row0 + i] = rk[i];
      rank_to_node[row0 + i] = r2n[i];
    }
  }
}

constexpr int kReachThreads = 256;
// G5's traversal pops up to kPops nodes a step, kPopLanes lanes a node
constexpr int kPopLanes = 8, kPops = 32 / kPopLanes;

// A block a window b; tails/heads [B, E], n_edges [B], aligned [B, N, R],
// acount [B, N], begin/end/n_nodes [B], use_full [B]. Writes keep [B, N]
// (0 or 1). The block groups the window's in-edges by head (a count a head
// by shared atomics, a block scan, the tails scattered down from each
// group's end), keeping only edges with both ends in [max(begin, 0),
// n_nodes): no other edge can add a node. Then warp 0 runs the traversal.
// kShared: the groups, rings, counts and stack in shared memory (with the
// bitmap); else the groups and stack in `scratch` (2N + 1 + E words a
// window) and the rings and counts read where they are.
template <bool kShared>
__global__ void __launch_bounds__(kReachThreads)
graph_reach_kernel(const int* __restrict__ tails, const int* __restrict__ heads,
                   const int* __restrict__ n_edges, const int* __restrict__ aligned,
                   const int* __restrict__ acount, const int* __restrict__ begin,
                   const int* __restrict__ end, const unsigned char* __restrict__ use_full,
                   const int* __restrict__ n_nodes, unsigned char* __restrict__ keep,
                   int* __restrict__ scratch, int N, int E, int R) {
  extern __shared__ int4 smem4[];
  __shared__ int tot[kReachThreads / 32];
  int* sm = reinterpret_cast<int*>(smem4);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const size_t row0 = (size_t)b * N;
  const int real = clamp_hi(n_nodes[b], N);  // ids below n_nodes
  const int lo = begin[b], e = end[b];
  if (use_full[b] || !(e >= lo && e >= 0 && e < real)) {
    const bool full = use_full[b];
    for (int i = tid; i < N; i += kReachThreads) keep[row0 + i] = full && i < real;
    return;
  }
  const int first = lo > 0 ? lo : 0;  // the least id kept
  const int words = (N + 31) >> 5;
  unsigned* kept = reinterpret_cast<unsigned*>(sm);
  int *pos, *csr, *stack;
  const int *ring, *rcount;
  if constexpr (kShared) {
    pos = sm + words;  // [N + 1]
    csr = pos + N + 1;  // [E]
    int* ring_s = csr + E;  // [N * R]
    int* count_s = ring_s + N * R;  // [N]
    stack = count_s + N;  // [N]
    const int* ab = aligned + row0 * R;
    for (int i = tid; i < N * R; i += kReachThreads) ring_s[i] = ab[i];
    for (int i = tid; i < N; i += kReachThreads) count_s[i] = acount[row0 + i];
    ring = ring_s;
    rcount = count_s;
  } else {
    pos = scratch + (size_t)b * (2 * N + 1 + E);
    csr = pos + N + 1;
    stack = csr + E;
    ring = aligned + row0 * R;
    rcount = acount + row0;
  }
  for (int i = tid; i <= N; i += kReachThreads) pos[i] = 0;
  for (int i = tid; i < words; i += kReachThreads) kept[i] = 0;
  __syncthreads();
  const int ne = clamp_hi(n_edges[b], E);
  const int* tb = tails + (size_t)b * E;
  const int* hb = heads + (size_t)b * E;
  for (int k = tid; k < ne; k += kReachThreads) {
    const int t = tb[k], h = hb[k];
    if (t >= first && t < real && h >= first && h < real) atomicAdd(&pos[h], 1);
  }
  __syncthreads();
  // pos[h]: the edges into heads <= h; pos[N] (no edge) the total
  vk::block_scan(pos, N + 1, tot);
  for (int k = tid; k < ne; k += kReachThreads) {
    const int t = tb[k], h = hb[k];
    if (t >= first && t < real && h >= first && h < real) csr[atomicSub(&pos[h], 1) - 1] = t;
  }
  __syncthreads();
  // node v's in-edge tails are now csr[pos[v] .. pos[v + 1]), in no order.
  // A step pops up to kPops nodes, one to each group of kPopLanes lanes;
  // a group takes its node's candidates (the ring, then the in-edges)
  // kPopLanes at a time.
  if (tid < 32) {
    if (lane == 0) {
      set_bit(kept, e);
      stack[0] = e;
    }
    int sp = 1;
    __syncwarp();
    const unsigned below = (1u << lane) - 1;
    const int g = lane / kPopLanes, sub = lane % kPopLanes;
    while (sp > 0) {
      const int take = sp < kPops ? sp : kPops;
      const int v = g < take ? stack[sp - 1 - g] : 0;
      sp -= take;
      __syncwarp();  // the pops are read before a push takes their slots
      int av = 0, e0 = 0, cnt = 0;
      if (g < take) {
        av = clamp_hi(rcount[v], R);
        e0 = pos[v] - av;  // candidate i >= av is csr[e0 + i]
        cnt = pos[v + 1] - e0;
      }
      const int most = __reduce_max_sync(kFull, cnt);
      for (int i = sub; i - sub < most; i += kPopLanes) {
        const int c = i < cnt ? (i < av ? ring[v * R + i] : csr[e0 + i]) : -1;
        const bool mine = c >= first && c < real && claim_bit(kept, c);
        const unsigned ball = __ballot_sync(kFull, mine);
        if (mine) stack[sp + __popc(ball & below)] = c;
        sp += __popc(ball);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < N; i += kReachThreads) keep[row0 + i] = bit_of(kept, i);
}

constexpr int kOvfNodes = 1, kOvfEdges = 2, kOvfRings = 4;

// One window's graph, its sequence and its walk state; every field uniform
// across the warp. The arrays lie in shared memory (the shared form) or are
// the graph buffers and a global scratch (the global form).
struct Fuse {
  int* codes;  // [N]
  int2* th;  // [E]: (tail, head) of every edge slot
  int* weights;  // [E]
  int* aligned;  // [N * R]
  int* acount;  // [N]
  int* lab_lo;  // [E], or null without labels
  int* lab_hi;
  int* first_out;  // [N]: an out-edge of each node, -1 for none
  int* next_out;  // [E]: the next out-edge of the same tail, -1 at the end
  int bit_lo, bit_hi;
  const int* seq;
  const int* seq_w;
  int N, E, R, W;
  int n_nodes, n_edges, ovf;
  int lane;

  __device__ __forceinline__ int at(const int* a, int i) const {
    return a[i < 0 ? 0 : (i < W ? i : W - 1)];
  }

  // A new node with `code`; its id, clamped to N - 1 past the cap.
  __device__ __forceinline__ int add_node(int code) {
    const int pos = clamp_hi(n_nodes, N - 1);
    if (lane == 0) codes[pos] = code;
    ++n_nodes;
    __syncwarp();
    return pos;
  }

  // Merge w into the first (t -> h) edge below n_edges, else append it.
  // The slots below min(n_edges, E - 1) are listed under their tails (a
  // slot there is written once, when it is appended); the list is in no
  // order, so the least matching index over the whole list is the one. Slot
  // E - 1, where every append past the cap lands, is never listed: it is
  // searched on its own once n_edges >= E, after every listed slot.
  __device__ __forceinline__ void add_edge(int t, int h, int w) {
    int found = E;
    for (int e = first_out[t]; e >= 0; e = next_out[e]) {
      if (th[e].y == h && e < found) found = e;
    }
    if (found == E && n_edges >= E) {
      const int2 x = th[E - 1];
      if (x.x == t && x.y == h) found = E - 1;
    }
    if (found < E) {
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
        if (pos < E - 1) {
          next_out[pos] = first_out[t];
          first_out[t] = pos;
        }
      }
      if (n_edges >= E) ovf |= kOvfEdges;
      ++n_edges;
    }
    __syncwarp();
  }

  // A chain of new nodes for positions [lo, hi); returns (last, first).
  // Lane j loads position base + j's code and edge weight, 32 at a time.
  __device__ __forceinline__ int2 run(int lo, int hi) {
    int prev = -1, first = -1;
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const int code_l = at(seq, i);
      const int w_l = at(seq_w, i - 1) + at(seq_w, i);
      const int n = hi - base < 32 ? hi - base : 32;
      for (int j = 0; j < n; ++j) {
        const int code = __shfl_sync(kFull, code_l, j);
        const int w = __shfl_sync(kFull, w_l, j);
        const int nid = add_node(code);
        if (prev >= 0 && base + j > lo) add_edge(prev, nid, w);
        if (first < 0) first = nid;
        prev = nid;
      }
    }
    return make_int2(prev, first);
  }

  // One matched pair (a_n: node id or -1; the position's code); returns curr.
  __device__ __forceinline__ int pair(int a_n, int code) {
    const bool is_new = a_n < 0;
    const int jt = a_n < 0 ? 0 : clamp_hi(a_n, N - 1);
    const bool jt_match = !is_new && codes[jt] == code;
    const int av = acount[jt];
    // lane r holds ring slot r of jt, read before anything changes
    const bool member = lane < R && lane < av;
    int m = 0, m_pos = 0;
    bool hit = false;
    if (lane < R) m = aligned[jt * R + lane];
    if (member) {
      m_pos = clamp_hi(acount[m], R - 1);
      hit = !is_new && !jt_match && codes[m] == code;
    }
    const unsigned ring_hit = __ballot_sync(kFull, hit);
    const int ring_node = __shfl_sync(kFull, m, ring_hit ? __ffs(ring_hit) - 1 : 0);
    const bool need_new = is_new || (!jt_match && !ring_hit);
    const int new_id = need_new ? add_node(code) : 0;
    const int curr = jt_match ? jt : (ring_hit ? ring_node : new_id);
    if (need_new && !is_new) {
      // every member gets curr appended; curr's ring is the members, then
      // jt; jt gets curr (graph.cpp:260-279), in JAX's order of scatters
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

// The shared form's window in shared memory, or the global form's scratch,
// in ints: see graph_fuse_kernel.
__host__ __device__ inline size_t fuse_smem_ints(int N, int E, int R, int track) {
  return (size_t)(4 + (track ? 2 : 0)) * E + 3 * (size_t)N + (size_t)N * R;
}
__host__ __device__ inline size_t fuse_scratch_ints(int N, int E) {
  return ((3 * (size_t)E + N + 1) / 2) * 2;  // even: th is int2
}

constexpr int kFuseThreads = 256;

// A block a window b, its first warp walking: the graph buffers codes [B,
// N], tails/heads/weights [B, E], n_nodes/n_edges [B], aligned [B, N, R],
// acount [B, N] and, with labels, lab_lo/lab_hi [B, E] are updated in
// place; pairs [B, L, 2] (node id | -1, position | -1; the last `count`
// rows), seq/seq_w [B, W], seq_len [B], active [B], bit_lo/bit_hi [B].
// Writes overflow [B] (bits). The block stages the window and builds the
// out-edge lists (a push a listed slot by atomicExch); warp 0 walks; the
// block writes the window back. kShared: the whole window in shared memory
// (th, weights, next_out, the labels, codes, acount, first_out, the rings:
// fuse_smem_ints); else th, next_out and first_out in `scratch`
// (fuse_scratch_ints a window) and the rest updated where it lies.
template <bool kShared>
__global__ void __launch_bounds__(kFuseThreads, 1)
graph_fuse_kernel(int* codes, int* tails, int* heads, int* weights, int* n_nodes, int* n_edges,
                  int* aligned, int* acount, int* lab_lo, int* lab_hi,
                  const int* __restrict__ bit_lo, const int* __restrict__ bit_hi,
                  const int* __restrict__ pairs, const int* __restrict__ count,
                  const int* __restrict__ seq, const int* __restrict__ seq_w,
                  const int* __restrict__ seq_len, const unsigned char* __restrict__ active,
                  int* __restrict__ overflow, int* __restrict__ scratch, int N, int E, int R, int L,
                  int W, int track) {
  extern __shared__ int4 smem4[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const size_t nb = (size_t)b * N, eb = (size_t)b * E;
  Fuse f;
  f.lab_lo = f.lab_hi = nullptr;
  if constexpr (kShared) {
    f.th = reinterpret_cast<int2*>(smem4);
    int* p = reinterpret_cast<int*>(f.th + E);
    f.weights = p;
    p += E;
    f.next_out = p;
    p += E;
    if (track) {
      f.lab_lo = p;
      f.lab_hi = p + E;
      p += 2 * E;
    }
    f.codes = p;
    f.acount = p + N;
    f.first_out = p + 2 * N;
    f.aligned = p + 3 * N;
    for (int i = tid; i < E; i += kFuseThreads) f.weights[i] = weights[eb + i];
    if (track) {
      for (int i = tid; i < E; i += kFuseThreads) {
        f.lab_lo[i] = lab_lo[eb + i];
        f.lab_hi[i] = lab_hi[eb + i];
      }
    }
    for (int i = tid; i < N; i += kFuseThreads) {
      f.codes[i] = codes[nb + i];
      f.acount[i] = acount[nb + i];
    }
    for (int i = tid; i < N * R; i += kFuseThreads) f.aligned[i] = aligned[nb * R + i];
  } else {
    int* s = scratch + b * fuse_scratch_ints(N, E);
    f.th = reinterpret_cast<int2*>(s);
    f.next_out = s + 2 * E;
    f.first_out = s + 3 * E;
    f.codes = codes + nb;
    f.weights = weights + eb;
    f.aligned = aligned + nb * R;
    f.acount = acount + nb;
    if (track) {
      f.lab_lo = lab_lo + eb;
      f.lab_hi = lab_hi + eb;
    }
  }
  for (int i = tid; i < E; i += kFuseThreads) f.th[i] = make_int2(tails[eb + i], heads[eb + i]);
  for (int i = tid; i < N; i += kFuseThreads) f.first_out[i] = -1;
  __syncthreads();
  const int listed = clamp_hi(n_edges[b], E - 1);
  for (int e = tid; e < listed; e += kFuseThreads) {
    const int t = f.th[e].x;
    if (t >= 0 && t < N) f.next_out[e] = atomicExch(&f.first_out[t], e);
  }
  __syncthreads();

  if (tid < 32) {
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
        // lane j loads pair k + j, its position's code and edge weight; the
        // pairs with a position are walked in order, shuffled from their lanes
        for (int base = k0; base < L; base += 32) {
          const int k = base + lane;
          const int an = k < L ? pr[2 * k] : 0;
          const int ap = k < L ? pr[2 * k + 1] : -1;
          const int code_l = f.at(f.seq, ap);
          const int w_l = f.at(f.seq_w, ap - 1) + f.at(f.seq_w, ap);
          for (unsigned todo = __ballot_sync(kFull, ap >= 0); todo; todo &= todo - 1) {
            const int j = __ffs(todo) - 1;
            const int a_n = __shfl_sync(kFull, an, j);
            const int code = __shfl_sync(kFull, code_l, j);
            const int w = __shfl_sync(kFull, w_l, j);
            const int curr = f.pair(a_n, code);
            if (prev >= 0) f.add_edge(prev, curr, w);
            prev = curr;
          }
        }
        if (suffix_first >= 0 && prev >= 0)
          f.add_edge(prev, suffix_first, f.at(f.seq_w, vback) + f.at(f.seq_w, vback + 1));
      }
    }
    if (f.n_nodes > N) f.ovf |= kOvfNodes;
    if (f.n_edges > E) f.ovf |= kOvfEdges;
    if (lane == 0) {
      n_nodes[b] = f.n_nodes;
      n_edges[b] = f.n_edges;
      overflow[b] = f.ovf;
    }
  }
  __syncthreads();
  for (int i = tid; i < E; i += kFuseThreads) {
    const int2 x = f.th[i];
    tails[eb + i] = x.x;
    heads[eb + i] = x.y;
  }
  if constexpr (kShared) {
    for (int i = tid; i < E; i += kFuseThreads) weights[eb + i] = f.weights[i];
    if (track) {
      for (int i = tid; i < E; i += kFuseThreads) {
        lab_lo[eb + i] = f.lab_lo[i];
        lab_hi[eb + i] = f.lab_hi[i];
      }
    }
    for (int i = tid; i < N; i += kFuseThreads) {
      codes[nb + i] = f.codes[i];
      acount[nb + i] = f.acount[i];
    }
    for (int i = tid; i < N * R; i += kFuseThreads) aligned[nb * R + i] = f.aligned[i];
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

// shared: the shared form (topo_smem_bytes of the window in shared memory),
// else the global form
int graph_topo_bundled_launch(const int* in_nbr, const int* indeg, const int* aligned,
                              const int* acount, const int* n_nodes, int* rank_of,
                              int* rank_to_node, int B, int N, int P, int R, int max_steps,
                              int shared, void* stream) {
  const size_t smem = topo_smem_bytes(N, P, R, shared);
  const void* kernel = shared ? (const void*)graph_topo_bundled_kernel<true>
                              : (const void*)graph_topo_bundled_kernel<false>;
  int rc = set_smem(kernel, smem);
  if (rc) return rc;
  if (shared)
    graph_topo_bundled_kernel<true><<<B, kTopoThreads, smem, (cudaStream_t)stream>>>(
        in_nbr, indeg, aligned, acount, n_nodes, rank_of, rank_to_node, N, P, R, max_steps);
  else
    graph_topo_bundled_kernel<false><<<B, kTopoThreads, smem, (cudaStream_t)stream>>>(
        in_nbr, indeg, aligned, acount, n_nodes, rank_of, rank_to_node, N, P, R, max_steps);
  return (int)cudaGetLastError();
}

int graph_reach_launch(const int* tails, const int* heads, const int* n_edges,
                       const int* aligned, const int* acount, const int* begin, const int* end,
                       const unsigned char* use_full, const int* n_nodes, unsigned char* keep,
                       int* scratch, int B, int N, int E, int R, void* stream) {
  const size_t words = (size_t)(N + 31) / 32;
  const bool shared = scratch == nullptr;
  const size_t staged = (size_t)N + 1 + E + (size_t)N * R + 2 * (size_t)N;
  const size_t smem = 4 * (words + (shared ? staged : 0));
  const void* kernel = shared ? (const void*)graph_reach_kernel<true>
                              : (const void*)graph_reach_kernel<false>;
  int rc = set_smem(kernel, smem);
  if (rc) return rc;
  if (shared)
    graph_reach_kernel<true><<<B, kReachThreads, smem, (cudaStream_t)stream>>>(
        tails, heads, n_edges, aligned, acount, begin, end, use_full, n_nodes, keep, scratch, N, E,
        R);
  else
    graph_reach_kernel<false><<<B, kReachThreads, smem, (cudaStream_t)stream>>>(
        tails, heads, n_edges, aligned, acount, begin, end, use_full, n_nodes, keep, scratch, N, E,
        R);
  return (int)cudaGetLastError();
}

// scratch null: the shared form (fuse_smem_ints of the window in shared
// memory); else the global form, fuse_scratch_ints a window of scratch
int graph_fuse_launch(int* codes, int* tails, int* heads, int* weights, int* n_nodes,
                      int* n_edges, int* aligned, int* acount, int* lab_lo, int* lab_hi,
                      const int* bit_lo, const int* bit_hi, const int* pairs, const int* count,
                      const int* seq, const int* seq_w, const int* seq_len,
                      const unsigned char* active, int* overflow, int* scratch, int B, int N,
                      int E, int R, int L, int W, int track, void* stream) {
  const bool shared = scratch == nullptr;
  const size_t smem = shared ? 4 * fuse_smem_ints(N, E, R, track) : 0;
  const void* kernel = shared ? (const void*)graph_fuse_kernel<true>
                              : (const void*)graph_fuse_kernel<false>;
  int rc = set_smem(kernel, smem);
  if (rc) return rc;
  if (shared)
    graph_fuse_kernel<true><<<B, kFuseThreads, smem, (cudaStream_t)stream>>>(
        codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, lab_lo, lab_hi, bit_lo,
        bit_hi, pairs, count, seq, seq_w, seq_len, active, overflow, scratch, N, E, R, L, W,
        track);
  else
    graph_fuse_kernel<false><<<B, kFuseThreads, smem, (cudaStream_t)stream>>>(
        codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, lab_lo, lab_hi, bit_lo,
        bit_hi, pairs, count, seq, seq_w, seq_len, active, overflow, scratch, N, E, R, L, W,
        track);
  return (int)cudaGetLastError();
}

// registers a thread, static shared memory and local memory of G3 (which
// 0: shared form, 5: global), G5 (1: shared form, 2: global) or G4 (3:
// shared form, 4: global): out[0..2]
int graph_build_attrs(int which, int* out) {
  const void* kernels[] = {(const void*)graph_topo_bundled_kernel<true>,
                           (const void*)graph_reach_kernel<true>,
                           (const void*)graph_reach_kernel<false>,
                           (const void*)graph_fuse_kernel<true>,
                           (const void*)graph_fuse_kernel<false>,
                           (const void*)graph_topo_bundled_kernel<false>};
  if (which < 0 || which > 5) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, kernels[which]);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = (int)at.localSizeBytes;
  return 0;
}

}  // extern "C"
