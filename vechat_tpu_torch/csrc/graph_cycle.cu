// The two stack machines of the device prune cycle for Hopper (sm_90a), with
// a plain C interface for ctypes: G1, the preorder DFS that renumbers the
// largest component, and G2, the topological ranking of the renumbered graph.
//
// Replaces vechat_tpu/ops/kernels/graph_cycle.py: dfs_preorder and
// topo_ranks, two XLA while_loop machines that step every window of a batch
// together, one node push or pop a step, because the TPU has no scalar
// threads. Here a block stages each window in shared memory and its first
// warp steps the window's machine on its own; the
// plain PyTorch versions in ops/kernels/graph_cycle.py are the batched
// machines; both give the same outputs, word for word.
//
// G1 (graph_dfs_kernel), reference semantics vendor/spoa graph.cpp:984-1019
// (DfsUtil): preorder, a node marked at discovery, the descent into the
// first unvisited neighbour in scan order (in-edge tails, then out-edge
// heads). A block of 16 warps a window scans each node's slots in use,
// min(deg, A, 32), into offsets and, where the window's total is within
// dfs_slot_cap (4N: a graph of 2N edges), copies them compactly in slot
// order into shared memory, beside the stack's frames, the visited bitmap
// and both outputs (written back at the end); a window past the cap is
// walked from its rows where they lie. Warp 0 walks: lane k holds slot k of
// the top node; the first slot at or past the frame's scan pointer whose
// node is unvisited is __ffs of the ballot, its node shuffled from that
// lane. The top frame and the one below it ride in
// registers: a push loads the new node's row before lane 0's stores, a pop
// takes the frame below at once (see dfs_walk).
//
// G2 (graph_topo_kernel), reference semantics graph.cpp:301-371, the rule of
// csrc/poagraph.cpp:96-140: roots in id order, the LAST unmet in-edge
// dependency of the top frame expanded first, a node emitted once all its
// dependencies are: G3's machine (graph_build.cu) without the rings. A
// block of 16 warps a window stages the rows of the window's n = min(n_sub,
// N) nodes in shared memory (the in-slot tails as uint16 [n, P], min(indeg,
// P) as a byte) beside the stack, the emitted bitmap and both outputs,
// which it writes back once at the end. Warp 0 walks: lanes 0..P-1 hold the
// top node's in-slots (P <= 32); the last unmet slot is 31 - __clz of the
// ballot. The top's row rides in registers: the pushed node's is loaded as
// the step decides, before the step's stores, and the node below the top
// is read with its row at the step's start, for an emit; an emitted bit is
// set by a plain store of the word the step read. A step has no branch,
// and every lane makes its stores, so no __syncwarp orders them. The next
// root is found a word of the bitmap at a time, by a cursor that never
// moves back. A window whose rows pass a block's shared memory (n over
// 4033 at N = 8192, P = 16; never at N <= 4096) reads them where they lie,
// chosen per window inside the kernel (topo_row_cap), as does a window
// with a tail outside its n nodes, which the cycle's renumbered graph
// never has.
//
// What bounds them: the chain of dependent steps, about 2N a window, one
// window a block and one warp walking, so that a launch of B <= 64 windows
// fills half the SMs. A G1 push is a shared load of the bitmap and the
// slot bounds, the ballot, its first lane and the shuffles from it, the
// next row's shared load and lane 0's plain stores (`k1_probe.py latency`
// times each link); a G2 push the same without the bounds, an emit a shared
// load of the bits and the ballot. Neither bytes nor operations come near
// the card's rates; see chip_smoke.py's phase 6.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool bit_of(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void set_bit(unsigned* bits, int i) {
  bits[i >> 5] |= 1u << (i & 31);
}

constexpr int kDfsThreads = 512;
constexpr int kSmemOptin = 232448;  // a block's shared memory on sm_90 (227 KB)
// rows a staging pass loads before it stores them
constexpr int kStageUnroll = 8;

// G1's shared memory without the slots, in bytes: the scan's word a warp,
// the frames [N] int4, off [N + 1], new_id and order [N] int32, the
// visited bitmap
__host__ __device__ inline size_t dfs_fixed_bytes(int N) {
  return 4 * (kDfsThreads / 32 + 7 * (size_t)N + 1 + (size_t)(N + 31) / 32);
}

// The slots G1 stages compactly: 4N (the cycle's graphs have E = 2N edges,
// so their slots below min(deg, A) sum to at most 4N), at most N a lane,
// and no more than a block's shared memory holds beside the rest
__host__ __device__ inline int dfs_slot_cap(int N, int A) {
  const long long lanes = A < 32 ? A : 32;
  long long cap = 4LL * N;
  if (lanes * N < cap) cap = lanes * N;
  const long long room = ((long long)kSmemOptin - (long long)dfs_fixed_bytes(N)) / 4;
  if (room < cap) cap = room > 0 ? room : 0;
  return (int)cap;
}

// Warp 0's DFS of window b. off [N + 1]: node v's slots are its entries
// off[v] .. off[v + 1] - 1 of `slots` (kCompact) or its first off[v + 1] -
// off[v] slots of adj [N, A] (the window's rows, where they lie). Every
// other array is in shared memory; frames[d] = (node, lo, hi, scan
// pointer) of the stack's frame d. The top frame and the one below it ride
// in registers, with lane k's slot of each one's row (u, bu). A step first
// reads the visited bits and slot bounds of the top's slots; on a push the
// new node, its bounds and its bitmap word are shuffled from the lane that
// held it and its row is loaded before lane 0's stores (the word with the
// new bit set, a plain store: no atomic on the chain), and the top becomes
// the frame below; on a pop the frame below becomes the top at once, and the one
// below that is read back from `frames`, its row at the next step's start,
// for a later pop.
template <bool kCompact>
__device__ void dfs_walk(const int* __restrict__ adj, const int* off, const int* slots,
                         unsigned* visited, int4* frames, int* new_id, int* order, int root,
                         bool has, int* n_sub, int A) {
  const int lane = threadIdx.x;
  auto row = [&](int v, int lo, int hi) -> int {
    if (lane >= hi - lo) return 0;
    return kCompact ? slots[lo + lane] : adj[(size_t)v * A + lane];
  };
  int sp = has ? 1 : 0, cnt = sp;
  int4 top = make_int4(root, has ? off[root] : 0, has ? off[root + 1] : 0, 0);
  int u = row(top.x, top.y, top.z);
  int4 below = make_int4(0, 0, 0, 0);
  int bu = 0;
  bool stale = false;  // below's row is still to be read
  if (lane == 0) {
    order[0] = root;
    if (has) {
      set_bit(visited, root);
      new_id[root] = 0;
      frames[0] = top;
    }
  }
  __syncwarp();
  while (sp > 0) {
    const unsigned vw = visited[u >> 5];  // the word of u's bit, as it stands
    const bool seen = (vw >> (u & 31)) & 1u;
    const int ulo = off[u], uhi = off[u + 1];
    if (stale) bu = row(below.x, below.y, below.z);
    const bool cand = lane < top.z - top.y && lane >= top.w && !seen;
    const unsigned ball = __ballot_sync(kFull, cand);
    if (ball) {
      // push: the top's scan moves past slot j, w is discovered
      const int j = __ffs(ball) - 1;
      const int w = __shfl_sync(kFull, u, j);
      const int wlo = __shfl_sync(kFull, ulo, j), whi = __shfl_sync(kFull, uhi, j);
      const unsigned ww = __shfl_sync(kFull, vw, j);
      below = make_int4(top.x, top.y, top.z, j + 1);
      bu = u;
      stale = false;
      top = make_int4(w, wlo, whi, 0);
      u = row(w, wlo, whi);  // the new top's row, before the stores
      if (lane == 0) {
        frames[sp - 1].w = j + 1;
        frames[sp] = top;
        visited[w >> 5] = ww | (1u << (w & 31));  // only lane 0 writes the bitmap
        new_id[w] = cnt;
        order[cnt] = w;
      }
      ++cnt;
      ++sp;
    } else {
      // the frame is exhausted: the one below resumes at its scan pointer
      --sp;
      top = below;
      u = bu;
      stale = sp > 1;
      if (stale) below = frames[sp - 2];
    }
    __syncwarp();
  }
  if (lane == 0) *n_sub = cnt;
}

// A block a window b. adj [B, N, A] int32 (slot k of node v: its k-th
// neighbour in scan order, padding 0), deg [B, N] (the true count, which
// may pass A), comp [B, N] bytes (non-zero in the winning component), root
// [B] int64. Writes new_id [B, N] (-1 outside the component), order [B, N]
// (preorder position -> node id; order[0] is the root even where the root
// lies outside, the rest 0) and n_sub [B]. The block scans min(deg, A, 32)
// into each node's slot offset and, where the window's slots fit
// dfs_slot_cap, copies them compactly into shared memory in slot order;
// warp 0 then walks (dfs_walk), reading a window past the cap from adj
// where it lies. The outputs are kept in shared memory and written back.
__global__ void __launch_bounds__(kDfsThreads)
graph_dfs_kernel(const int* __restrict__ adj, const int* __restrict__ deg,
                 const unsigned char* __restrict__ comp, const long long* __restrict__ root,
                 int* __restrict__ new_id, int* __restrict__ order, int* __restrict__ n_sub,
                 int N, int A, int cap) {
  extern __shared__ int4 smem4[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int words = (N + 31) >> 5, lanes = A < 32 ? A : 32;
  const size_t row0 = (size_t)b * N;
  int* tot = reinterpret_cast<int*>(smem4);
  int4* frames = smem4 + kDfsThreads / 128;  // [N], after the scan's words
  int* off = reinterpret_cast<int*>(frames + N);  // [N + 1]
  int* nid = off + N + 1;
  int* ord = nid + N;
  unsigned* visited = reinterpret_cast<unsigned*>(ord + N);
  int* slots = reinterpret_cast<int*>(visited + words);  // [cap]
  for (int i = tid; i < N; i += kDfsThreads) {
    const int d = deg[row0 + i];
    off[i + 1] = d < 0 ? 0 : (d < lanes ? d : lanes);
    nid[i] = -1;
    ord[i] = 0;
  }
  for (int i = tid; i < words; i += kDfsThreads) visited[i] = 0;
  if (tid == 0) off[0] = 0;
  __syncthreads();
  // off[v + 1]: the slots of nodes <= v; off[N] the window's total
  vk::block_scan(off, N + 1, tot);
  const bool compact = off[N] <= cap;
  const int* ab = adj + row0 * A;
  if (compact) {
    // warp w copies node v = i / 32's slots, lane k its slot k, kStageUnroll
    // nodes' loads in flight before their stores
    for (int base = tid; base < 32 * N; base += kStageUnroll * kDfsThreads) {
      int x[kStageUnroll], at[kStageUnroll];
#pragma unroll
      for (int r = 0; r < kStageUnroll; ++r) {
        const int i = base + r * kDfsThreads, v = i >> 5, k = i & 31;
        at[r] = -1;
        x[r] = 0;
        if (i < 32 * N && k < off[v + 1] - off[v]) {
          at[r] = off[v] + k;
          x[r] = ab[(size_t)v * A + k];
        }
      }
#pragma unroll
      for (int r = 0; r < kStageUnroll; ++r)
        if (at[r] >= 0) slots[at[r]] = x[r];
    }
  }
  __syncthreads();
  if (tid < 32) {
    const int r = (int)root[b];
    const bool has = comp[row0 + r] != 0;
    if (compact)
      dfs_walk<true>(ab, off, slots, visited, frames, nid, ord, r, has, n_sub + b, A);
    else
      dfs_walk<false>(ab, off, slots, visited, frames, nid, ord, r, has, n_sub + b, A);
  }
  __syncthreads();
  for (int i = tid; i < N; i += kDfsThreads) {
    new_id[row0 + i] = nid[i];
    order[row0 + i] = ord[i];
  }
}

constexpr int kTopoThreads = 512;

// G2's shared memory in bytes with `cap` rows staged: rank_of, rank_to_node
// and the stack [N] int32, the emitted bitmap, then each staged node's
// in-slot tails as uint16 [cap, P] (rounded up to a word) and its
// min(indeg, P) as a byte [cap]
__host__ __device__ inline size_t topo_smem_bytes(int N, int P, int cap) {
  return 4 * (3 * (size_t)N + (size_t)(N + 31) / 32) + ((2 * (size_t)cap * P + 3) & ~(size_t)3) +
         (size_t)cap;
}

// The rows G2 stages: a window's n = min(n_sub, N) nodes where n is at most
// this, N or as many as a block's shared memory holds beside the rest (4033
// at N = 8192, P = 16; every N <= 4096 fits whole at P = 16)
__host__ __device__ inline int topo_row_cap(int N, int P) {
  const long long room = (long long)kSmemOptin - (long long)topo_smem_bytes(N, P, 0) - 3;
  long long cap = room / (2LL * P + 1);
  if (cap > N) cap = N;
  return cap > 0 ? (int)cap : 0;
}

// Warp 0's topological walk of window b over its n nodes, its rows staged
// (kStaged: ids, deg) or read where they lie (in_nbr, indeg). The top
// node v's row and usable count ride in registers (lane k < P: its k-th
// in-slot tail t; d = min(indeg, P)). A step first reads, side by side,
// the emitted bit of each lane's tail, v's word of the bitmap, and the node
// below the top on the stack with its row; then the ballot of the unmet
// slots decides, with no branch: the last unmet tail is shuffled from its
// lane (31 - __clz) and the row of the node it names (v on an emit) is
// loaded before the step's stores; an emit takes the node below the top at
// once and sets v's bit by a plain store of the word the step read. Every
// lane makes each store, of the same value to the same word, so that its
// own later reads see it: no __syncwarp orders a step's stores before the
// next step's reads. The stack and rank stores clamp to the last slot as
// the plain machine does.
template <bool kStaged>
__device__ void topo_walk(const int* __restrict__ in_nbr, const int* __restrict__ indeg,
                          size_t row0, const unsigned short* ids, const unsigned char* deg,
                          unsigned* emitted, int* stack, int* rk, int* r2n, int n, int N, int P) {
  const int lane = threadIdx.x;
  auto load = [&](int v, int& t, int& d) {
    if constexpr (kStaged) {
      t = lane < P ? ids[v * P + lane] : 0;
      d = deg[v];
    } else {
      const size_t rv = row0 + v;
      t = lane < P ? in_nbr[rv * P + lane] : 0;
      const int dv = indeg[rv];
      d = dv < 0 ? 0 : (dv < P ? dv : P);
    }
  };
  int sp = 0, cnt = 0, cursor = 0, v = 0, t = 0, d = 0;
  while (sp > 0 || cnt < n) {
    if (sp == 0) {
      // The next root is the first unemitted id below n. The emitted set only
      // grows, so that id never moves back: a cursor that only moves forward,
      // a word of the bitmap at a time, finds at every rooting step the node
      // the batched machine's argmax over the whole row finds (none: 0)
      while (cursor < n) {
        const unsigned avail = ~emitted[cursor >> 5] & (kFull << (cursor & 31));
        if (avail) {
          cursor = (cursor & ~31) + __ffs(avail) - 1;
          break;
        }
        cursor = (cursor & ~31) + 32;
      }
      v = cursor < n ? cursor : 0;
      load(v, t, d);
      stack[0] = v;
      sp = 1;
      continue;  // the root's dependencies are read at the next step
    }
    const bool done = bit_of(emitted, t);
    const unsigned ew = emitted[v >> 5];  // v's word, as it stands
    const int below = stack[sp > 1 ? sp - 2 : 0];
    int bt, bd;
    load(below, bt, bd);
    const unsigned ball = __ballot_sync(kFull, lane < d && !done);
    // push the last unmet dependency in slot order, or, with none, emit the top
    const bool push = ball != 0;
    const int w = __shfl_sync(kFull, t, 31 - __clz(ball));
    int wt, wd;
    load(push ? w : v, wt, wd);
    if (push) stack[sp < N ? sp : N - 1] = w;
    if (!push) {
      emitted[v >> 5] = ew | (1u << (v & 31));
      rk[v] = cnt;
      r2n[cnt < N ? cnt : N - 1] = v;
    }
    sp += push ? 1 : -1;
    cnt += push ? 0 : 1;
    v = push ? w : below;
    t = push ? wt : bt;
    d = push ? wd : bd;
  }
}

// A block a window b. in_nbr [B, N, P] int32 (slot k of node v: the tail
// of its k-th in-edge in slot order, padding 0; P <= 32), indeg [B, N],
// n_sub [B]. Writes rank_of [B, N] and rank_to_node [B, N] (0 where nothing
// was ranked). The block stages the rows of the window's n = min(n_sub, N)
// nodes (tails as uint16: N <= 8192) and their min(indeg, P) where n <=
// cap (topo_row_cap), and keeps the stack, the bitmap and both outputs in
// shared memory; warp 0 walks (topo_walk) the staged rows where every
// staged tail lies below n, as the renumbered graph's do (so the walk
// reaches no other node), else the rows where they lie; the block writes
// the outputs back once, coalesced.
__global__ void __launch_bounds__(kTopoThreads)
graph_topo_kernel(const int* __restrict__ in_nbr, const int* __restrict__ indeg,
                  const int* __restrict__ n_sub, int* __restrict__ rank_of,
                  int* __restrict__ rank_to_node, int N, int P, int cap) {
  extern __shared__ int4 smem4[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int words = (N + 31) >> 5;
  const size_t row0 = (size_t)b * N;
  int* rk = reinterpret_cast<int*>(smem4);
  int* r2n = rk + N;
  int* stack = r2n + N;
  unsigned* emitted = reinterpret_cast<unsigned*>(stack + N);
  unsigned short* ids = reinterpret_cast<unsigned short*>(emitted + words);
  unsigned char* deg =
      reinterpret_cast<unsigned char*>(ids) + ((2 * (size_t)cap * P + 3) & ~(size_t)3);
  const int n = n_sub[b] < N ? n_sub[b] : N;
  const int rows = n <= cap && n > 0 ? n : 0;  // the nodes whose rows are staged
  for (int i = tid; i < N; i += kTopoThreads) rk[i] = r2n[i] = 0;
  for (int i = tid; i < words; i += kTopoThreads) emitted[i] = 0;
  for (int i = tid; i < rows; i += kTopoThreads) {
    const int d = indeg[row0 + i];
    deg[i] = (unsigned char)(d < 0 ? 0 : (d < P ? d : P));
  }
  // the rows are contiguous: a coalesced copy, kStageUnroll loads in flight
  // a thread before their stores
  const int* src = in_nbr + row0 * P;
  const int m = rows * P;
  bool outside = false;  // a staged tail at or past n
  for (int base = tid; base < m; base += kStageUnroll * kTopoThreads) {
    int x[kStageUnroll];
#pragma unroll
    for (int r = 0; r < kStageUnroll; ++r) {
      const int i = base + r * kTopoThreads;
      x[r] = i < m ? src[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kStageUnroll; ++r) {
      const int i = base + r * kTopoThreads;
      if (i < m) {
        ids[i] = (unsigned short)x[r];
        outside |= (unsigned)x[r] >= (unsigned)n;
      }
    }
  }
  const bool staged = __syncthreads_or(outside) == 0 && rows > 0;
  if (tid < 32) {
    if (staged)
      topo_walk<true>(in_nbr, indeg, row0, ids, deg, emitted, stack, rk, r2n, n, N, P);
    else
      topo_walk<false>(in_nbr, indeg, row0, ids, deg, emitted, stack, rk, r2n, n, N, P);
  }
  __syncthreads();
  for (int i = tid; i < N; i += kTopoThreads) {
    rank_of[row0 + i] = rk[i];
    rank_to_node[row0 + i] = r2n[i];
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int graph_dfs_launch(const int* adj, const int* deg, const unsigned char* comp,
                     const long long* root, int* new_id, int* order, int* n_sub, int B, int N,
                     int A, void* stream) {
  const int cap = dfs_slot_cap(N, A);
  const size_t smem = dfs_fixed_bytes(N) + 4 * (size_t)cap;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_dfs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  graph_dfs_kernel<<<B, kDfsThreads, smem, (cudaStream_t)stream>>>(adj, deg, comp, root, new_id,
                                                                   order, n_sub, N, A, cap);
  return (int)cudaGetLastError();
}

int graph_topo_launch(const int* in_nbr, const int* indeg, const int* n_sub, int* rank_of,
                      int* rank_to_node, int B, int N, int P, void* stream) {
  const int cap = topo_row_cap(N, P);
  const size_t smem = topo_smem_bytes(N, P, cap);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_topo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  graph_topo_kernel<<<B, kTopoThreads, smem, (cudaStream_t)stream>>>(in_nbr, indeg, n_sub, rank_of,
                                                                     rank_to_node, N, P, cap);
  return (int)cudaGetLastError();
}

// G1's slot capacity at (N, A) (dfs_slot_cap) and shared memory in bytes:
// out[0..1]
int graph_dfs_smem(int N, int A, int* out) {
  out[0] = dfs_slot_cap(N, A);
  out[1] = (int)(dfs_fixed_bytes(N) + 4 * (size_t)out[0]);
  return 0;
}

// G2's row capacity at (N, P) (topo_row_cap) and shared memory in bytes:
// out[0..1]
int graph_topo_smem(int N, int P, int* out) {
  out[0] = topo_row_cap(N, P);
  out[1] = (int)topo_smem_bytes(N, P, out[0]);
  return 0;
}

// registers a thread, static shared memory and local memory of G1 (which
// 0) or G2 (1): out[0..2]
int graph_cycle_attrs(int which, int* out) {
  const void* kernels[] = {(const void*)graph_dfs_kernel, (const void*)graph_topo_kernel};
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, kernels[which]);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = (int)at.localSizeBytes;
  return 0;
}

}  // extern "C"
