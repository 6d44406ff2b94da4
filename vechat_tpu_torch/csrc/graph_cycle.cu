// The two stack machines of the device prune cycle for Hopper (sm_90a), with
// a plain C interface for ctypes: G1, the preorder DFS that renumbers the
// largest component, and G2, the topological ranking of the renumbered graph.
//
// Replaces vechat_tpu/ops/kernels/graph_cycle.py: dfs_preorder and
// topo_ranks, two XLA while_loop machines that step every window of a batch
// together, one node push or pop a step, because the TPU has no scalar
// threads. Here each window is one warp stepping its own machine: the
// stack, its scan pointers and the visited (emitted) bitmap live in shared
// memory, and a step is one read of the top node's row, a ballot over its
// slots and a few stores by lane 0. The plain PyTorch versions in
// ops/kernels/graph_cycle.py are the batched machines; both give the same
// outputs, word for word.
//
// G1 (graph_dfs_kernel), reference semantics vendor/spoa graph.cpp:984-1019
// (DfsUtil): preorder, a node marked at discovery, the descent into the
// first unvisited neighbour in scan order (in-edge tails, then out-edge
// heads). Lane k holds adjacency slot k of the top node (A <= 32 slots); the
// first slot at or past the frame's scan pointer whose node is unvisited is
// __ffs of the ballot.
//
// G2 (graph_topo_kernel), reference semantics graph.cpp:301-371, the rule of
// csrc/poagraph.cpp:96-140: roots in id order, the LAST unmet in-edge
// dependency of the top frame expanded first, a node emitted once all its
// dependencies are. Lanes 0..P-1 hold the in-slots (P <= 32); the last unmet
// slot is 31 - __clz of the ballot.
//
// What bounds them: the chain of dependent steps (shared read of the top,
// global read of its row, shared read of the bitmap, ballot, stores), about
// 2N steps a window, one window a warp and one warp a block, so a launch of
// B <= 64 windows fills half the SMs with one warp each. Neither bytes nor
// operations come near the card's rates; see chip_smoke.py's phase 6.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool bit_of(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void set_bit(unsigned* bits, int i) {
  bits[i >> 5] |= 1u << (i & 31);
}

// One warp a window b. adj [B, N, A] int32 (slot k of node v: its k-th
// neighbour in scan order, padding 0), deg [B, N], comp [B, N] (1 in the
// winning component), root [B]. Writes new_id [B, N] (-1 outside the
// component), order [B, N] (preorder position -> node id; order[0] is the
// root even where the root lies outside, the rest 0) and n_sub [B].
// Shared memory: the visited bitmap (N bits), the stack (N int32) and each
// frame's scan pointer (N bytes).
__global__ void __launch_bounds__(32)
graph_dfs_kernel(const int* __restrict__ adj, const int* __restrict__ deg,
                 const unsigned char* __restrict__ comp, const int* __restrict__ root,
                 int* __restrict__ new_id, int* __restrict__ order, int* __restrict__ n_sub,
                 int N, int A) {
  extern __shared__ unsigned smem[];
  const int words = (N + 31) >> 5;
  unsigned* visited = smem;
  int* stack = reinterpret_cast<int*>(smem + words);
  unsigned char* pptr = reinterpret_cast<unsigned char*>(stack + N);
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t row0 = (size_t)b * N;
  for (int i = lane; i < N; i += 32) {
    new_id[row0 + i] = -1;
    order[row0 + i] = 0;
  }
  for (int i = lane; i < words; i += 32) visited[i] = 0;
  const int r = root[b];
  const bool has = comp[row0 + r] != 0;
  __syncwarp();
  if (lane == 0) {
    order[row0] = r;
    if (has) {
      set_bit(visited, r);
      new_id[row0 + r] = 0;
      stack[0] = r;
      pptr[0] = 0;
    }
  }
  __syncwarp();
  int sp = has ? 1 : 0, cnt = sp;
  const int lanes = A < 32 ? A : 32;
  while (sp > 0) {
    const int v = stack[sp - 1];
    const int p = pptr[sp - 1];
    // the row and the degree are independent loads, in flight together
    const int d = deg[row0 + v];
    int u = 0;
    if (lane < lanes) u = adj[(row0 + v) * A + lane];
    const bool cand = lane < lanes && lane >= p && lane < d && !bit_of(visited, u);
    const unsigned ball = __ballot_sync(kFull, cand);
    if (ball) {
      // push: the parent's scan moves past slot j, u is discovered
      const int j = __ffs(ball) - 1;
      const int w = __shfl_sync(kFull, u, j);
      if (lane == 0) {
        pptr[sp - 1] = (unsigned char)(j + 1);
        set_bit(visited, w);
        new_id[row0 + w] = cnt;
        order[row0 + cnt] = w;
        stack[sp] = w;
        pptr[sp] = 0;
      }
      ++cnt;
      ++sp;
    } else {
      --sp;  // the frame is exhausted
    }
    __syncwarp();
  }
  if (lane == 0) n_sub[b] = cnt;
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
                     const int* root, int* new_id, int* order, int* n_sub, int B, int N,
                     int A, void* stream) {
  const size_t smem = (size_t)((N + 31) / 32) * 4 + (size_t)N * 4 + N;
  graph_dfs_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(adj, deg, comp, root, new_id,
                                                          order, n_sub, N, A);
  return (int)cudaGetLastError();
}

int graph_topo_launch(const int* in_nbr, const int* indeg, const int* n_sub, int* rank_of,
                      int* rank_to_node, int B, int N, int P, void* stream) {
  const size_t smem = (size_t)((N + 31) / 32) * 4 + (size_t)N * 4;
  graph_topo_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(in_nbr, indeg, n_sub, rank_of,
                                                           rank_to_node, N, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
