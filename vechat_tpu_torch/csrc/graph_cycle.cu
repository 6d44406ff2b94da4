// The two stack machines of the device prune cycle for Hopper (sm_90a), with
// a plain C interface for ctypes: G1, the preorder DFS that renumbers the
// largest component, and G2, the topological ranking of the renumbered graph.
//
// Replaces vechat_tpu/ops/kernels/graph_cycle.py: dfs_preorder and
// topo_ranks, two XLA while_loop machines that step every window of a batch
// together, one node push or pop a step, because the TPU has no scalar
// threads. Here each window's machine is one warp stepping on its own; the
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
// dependencies are. Lanes 0..P-1 hold the in-slots (P <= 32); the last unmet
// slot is 31 - __clz of the ballot. One warp a block, the stack and the
// emitted bitmap in shared memory, the rows read from global memory.
//
// What bounds them: the chain of dependent steps, about 2N a window, one
// window a block and one warp walking, so that a launch of B <= 64 windows
// fills half the SMs. A G1 push is a shared load of the bitmap and the
// slot bounds, the ballot, its first lane and the shuffles from it, the
// next row's shared load and lane 0's plain stores (`k1_probe.py latency`
// times each link); a G2 step waits on a global read of its row. Neither bytes nor operations come near the
// card's rates; see chip_smoke.py's phase 6.

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

// One warp a window b. in_nbr [B, N, P] int32 (slot k of node v: the tail
// of its k-th in-edge in slot order, padding 0), indeg [B, N], n_sub [B].
// Writes rank_of [B, N] and rank_to_node [B, N] (0 past n_sub). Shared
// memory: the emitted bitmap (N bits) and the stack (N int32).
__global__ void __launch_bounds__(32)
graph_topo_kernel(const int* __restrict__ in_nbr, const int* __restrict__ indeg,
                  const int* __restrict__ n_sub, int* __restrict__ rank_of,
                  int* __restrict__ rank_to_node, int N, int P) {
  extern __shared__ unsigned smem[];
  const int words = (N + 31) >> 5;
  unsigned* emitted = smem;
  int* stack = reinterpret_cast<int*>(smem + words);
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t row0 = (size_t)b * N;
  for (int i = lane; i < N; i += 32) {
    rank_of[row0 + i] = 0;
    rank_to_node[row0 + i] = 0;
  }
  for (int i = lane; i < words; i += 32) emitted[i] = 0;
  __syncwarp();
  const int n = n_sub[b] < N ? n_sub[b] : N;
  const int lanes = P < 32 ? P : 32;
  int sp = 0, cnt = 0, cursor = 0;
  while (sp > 0 || cnt < n) {
    if (sp == 0) {
      // The next root is the first unemitted id below n. The emitted set only
      // grows, so that id never moves back: a cursor that only moves forward
      // finds, at every rooting step, the node the batched machine's argmax
      // over the whole row finds. Only ids below n are ever emitted and
      // cnt < n, so the cursor stops below n.
      while (cursor < n && bit_of(emitted, cursor)) ++cursor;
      if (lane == 0) stack[0] = cursor;
      sp = 1;
      __syncwarp();
      continue;  // the root's dependencies are read at the next step
    }
    const int v = stack[sp - 1];
    const int d = indeg[row0 + v];
    int t = 0;
    if (lane < lanes) t = in_nbr[(row0 + v) * P + lane];
    const bool unmet = lane < lanes && lane < d && !bit_of(emitted, t);
    const unsigned ball = __ballot_sync(kFull, unmet);
    if (ball) {
      // push the last unmet dependency in slot order
      const int j = 31 - __clz(ball);
      const int w = __shfl_sync(kFull, t, j);
      if (lane == 0) stack[sp] = w;
      ++sp;
    } else {
      // every dependency has emitted: emit the top
      if (lane == 0) {
        set_bit(emitted, v);
        rank_of[row0 + v] = cnt;
        rank_to_node[row0 + cnt] = v;
      }
      ++cnt;
      --sp;
    }
    __syncwarp();
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
  const size_t smem = (size_t)((N + 31) / 32) * 4 + (size_t)N * 4;
  graph_topo_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(in_nbr, indeg, n_sub, rank_of,
                                                           rank_to_node, N, P);
  return (int)cudaGetLastError();
}

// G1's slot capacity at (N, A) (dfs_slot_cap) and shared memory in bytes:
// out[0..1]
int graph_dfs_smem(int N, int A, int* out) {
  out[0] = dfs_slot_cap(N, A);
  out[1] = (int)(dfs_fixed_bytes(N) + 4 * (size_t)out[0]);
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
