"""The haplotype prune cycle of round 1 (B8) as batched PyTorch programs
over dense edge-list graph tensors, with its two stack machines as CUDA
kernels (G1, G2) and its realignments on K1 and the dense walk.

Counterpart of `vechat_tpu/ops/kernels/graph_cycle.py` (the XLA program
`haplotype_cycle` and its parts, same names, same layouts): PruneGraph,
largest connected component, renumbering, topological ranking, the
realignment of every sequence, AddWeights and the corrected-sequence emit
(reference semantics: vendor/spoa/src/graph.cpp:811-982 PruneGraph,
:984-1089 DfsUtil/LargestSubgraph, :1104-1165 AddWeights, :1167-1179
GenerateCorrectedSequence; src/window.cpp:300-396 the cycle).

Graph representation (per window, capacity-padded, batch axis B first):
  codes[N]        node character codes, indexed by node id
  tails/heads[E]  edge endpoints; ascending edge index = insertion order =
                  every node's in/out slot order (spoa appends edges
                  globally and prune's compaction is monotone)
  weights[E]      edge weights
  valid[E]        pruning clears bits instead of compacting

Everything but the stack machines and the alignments is the array work XLA
ran: scatter-adds, gathers, stable sorts, `searchsorted`, cumulative sums,
as PyTorch ops on the tensors' device. Semantics kept bit for bit:
  * prune confidences in float32, as the device program computes them
    (w / total out of the tail, w / total into the head, w / average weight,
    the host's double average cast to float32); integer sums are exact in
    float32 at these sizes, and 0/0 is NaN, which drops the edge
  * every argsort is a stable sort; `searchsorted` is left-sided
  * a scatter that JAX drops at index N or E goes into a padded extra column
    that is sliced away
  * argmax picks the first maximum; the winning component maximises
    (size, min node id), the last discovered of largest size (graph.cpp:1049)

`dfs_preorder` (G1) and `topo_ranks` (G2) launch the kernels of
`csrc/graph_cycle.cu` on CUDA tensors and run their plain versions, the
batched machines of the JAX program, on CPU tensors. G1 stages a window's
adjacency compactly in shared memory where its slots fit `dfs_slot_cap`,
else walks the rows where they lie; G2 stages a window's in-slot rows in
shared memory where they fit `topo_row_cap`, else reads them where they
lie. The cycle gives both its own tensors as they are (`check=False`).
`poa_align_mixed` runs
K1 once for each align mode that has sequences (nw at the command line's
scores, sw at 3/-5/-4) and the dense walk with the node ids of the ranks,
in launches cut by the backend's `LAUNCH_BYTES`; its results do not depend
on the cut, on the DP width or on the in-edge slots a launch carries.

A window is flagged for the host route when it overflows a capacity: an
adjacency row past `a_cap` (bit `OVF_A_CAP`), an in-slot row past `p_cap`
(`OVF_P_CAP`), new edges past E (`OVF_NEW_EDGES`), or a predecessor
distance past 511, which K1's 9-bit distance field cannot hold
(`OVF_RING`). The first three are the JAX program's overflow; the last is
K1's capacity rule and changes no result. `haplotype_cycle` refuses a
bucket whose scores leave K1's int16 rows: its caller sends such windows
to the host before they are packed.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build
from .backend import LAUNCH_BYTES, MAX_RING
from .dense import W_BUCKETS, bucket
from .poa_linear import _check_inputs, fits_int16, pack_aux, poa_dp, traceback_walk_dense

BIG = 2**30

# overflow bits of `haplotype_cycle` (any bit set: the host route)
OVF_A_CAP = 1
OVF_P_CAP = 2
OVF_NEW_EDGES = 4
OVF_RING = 8
OVF_BITS = dict(a_cap=OVF_A_CAP, p_cap=OVF_P_CAP, new_edges=OVF_NEW_EDGES, ring=OVF_RING)

# rounds of `cc_min_labels` between two reads of its `changed` flag
CC_CHECK = 4
# steps of a plain stack machine between two reads of its `active` flag
PLAIN_CHECK = 8
# SW scores of the realignments (src/window.cpp:326)
SW_SCORES = (3, -5, -4)


# ----------------------------------------------------------- host packing


def graph_to_edges(graph, n_cap: int, e_cap: int):
    """Pack a host graph (native or Python) into the flat edge-list form:
    dict(codes [n_cap], tails/heads/weights [e_cap], n_nodes, n_edges),
    numpy int32, or None when a cap is exceeded. Edge index order =
    insertion order = every per-node slot order."""
    if hasattr(graph, "edges_dense"):  # native C++ graph
        return graph.edges_dense(n_cap, e_cap)
    n = graph.num_nodes()
    m = len(graph.edges)
    if n > n_cap or m > e_cap:
        return None
    codes = np.zeros(n_cap, dtype=np.int32)
    tails = np.zeros(e_cap, dtype=np.int32)
    heads = np.zeros(e_cap, dtype=np.int32)
    weights = np.zeros(e_cap, dtype=np.int32)
    codes[:n] = graph.codes
    for i, e in enumerate(graph.edges):
        tails[i] = e.tail
        heads[i] = e.head
        weights[i] = min(e.weight, 0x7FFFFFFF)
    return dict(codes=codes, tails=tails, heads=heads, weights=weights, n_nodes=n, n_edges=m)


def _ar(n, dev):
    return torch.arange(n, device=dev)


def _scatter_add(B, n, index, src, dtype):
    """[B, n] zeros plus src scattered at index; an index of n is dropped."""
    out = torch.zeros((B, n + 1), dtype=dtype, device=index.device)
    return out.scatter_add_(1, index, src.to(dtype))[:, :n]


# ------------------------------------------------------------------ prune


def prune_edges(tails, heads, weights, valid, n_nodes_cap: int, avg_weight,
                min_confidence, min_support):
    """Edge keep mask [B, E] after one PruneGraph pass (graph.cpp:811-982):
    keep = w / tot_out[tail] >= d and w / tot_in[head] >= d and w / avg >= s,
    every sum over the pre-prune state, in float32."""
    B, E = tails.shape
    N = n_nodes_cap
    dev = tails.device
    tails, heads = tails.long(), heads.long()
    f32 = torch.float32
    w = weights.to(f32)
    wv = torch.where(valid, w, torch.zeros((), dtype=f32, device=dev))
    tot_out = _scatter_add(B, N, tails, wv, f32)
    tot_in = _scatter_add(B, N, heads, wv, f32)
    conf_uv = w / torch.gather(tot_out, 1, tails)
    conf_vu = w / torch.gather(tot_in, 1, heads)
    supp = w / torch.as_tensor(avg_weight, dtype=f32, device=dev).reshape(B, 1)
    d = torch.as_tensor(min_confidence, dtype=f32, device=dev)
    s = torch.as_tensor(min_support, dtype=f32, device=dev)
    if d.dim() == 1:
        d = d[:, None]
    if s.dim() == 1:
        s = s[:, None]
    return (conf_uv >= d) & (conf_vu >= d) & (supp >= s) & valid


# ----------------------------------------------------- connected components


def cc_min_labels(tails, heads, valid, node_alive, stats: Optional[dict] = None):
    """Min-node-id label [B, N] of each connected component (undirected,
    valid edges): min-hooking and pointer jumping to a fixpoint, at most 2N
    rounds. The fixpoint is the minimum node id of each component whatever
    the schedule, so the flag is read on the host once every `CC_CHECK`
    rounds (rounds past the fixpoint change nothing). `stats["cc_rounds"]`
    gets the rounds run."""
    B, N = node_alive.shape
    dev = tails.device
    tails, heads = tails.long(), heads.long()
    label = _ar(N, dev).expand(B, N).clone()
    t_idx = torch.where(valid, tails, N)
    h_idx = torch.where(valid, heads, N)
    rounds = 0
    while True:
        for _ in range(min(CC_CHECK, 2 * N - rounds)):
            lt = torch.gather(label, 1, tails)
            lh = torch.gather(label, 1, heads)
            mn = torch.where(valid, torch.minimum(lt, lh), N)
            new = torch.cat([label, torch.full((B, 1), N, dtype=label.dtype, device=dev)], 1)
            new = new.scatter_reduce(1, t_idx, mn, "amin")
            new = new.scatter_reduce(1, h_idx, mn, "amin")[:, :N]
            # pointer jumping (label compression), twice a round
            new = torch.gather(new, 1, new)
            new = torch.gather(new, 1, new)
            changed = (new != label).any()
            label = new
            rounds += 1
        if rounds >= 2 * N or not bool(changed):
            break
    if stats is not None:
        stats["cc_rounds"] = stats.get("cc_rounds", 0) + rounds
    return label


def select_component(labels, node_alive):
    """(comp_mask [B, N], root [B]) of the winning component: the one that
    maximises (size, min node id); root = its min node id."""
    B, N = labels.shape
    dev = labels.device
    labels = labels.long()
    lab = torch.where(node_alive, labels, N)
    sizes = _scatter_add(B, N, lab, node_alive, torch.int64)
    score = sizes * (N + 1) + _ar(N, dev)
    root = torch.argmax(score, dim=1)
    return node_alive & (labels == root[:, None]), root


# --------------------------------------------------------------- adjacency


def _group_positions(sorted_owner):
    """Position of each entry within its (contiguous) owner group."""
    B, M = sorted_owner.shape
    idx = _ar(M, sorted_owner.device).expand(B, M)
    start = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=sorted_owner.device),
                       sorted_owner[:, 1:] != sorted_owner[:, :-1]], 1)
    return idx - torch.cummax(torch.where(start, idx, -1), dim=1).values


def _slot_table(owner, nbr, ok, key, N: int, cap: int):
    """Dense per-owner lists in key order: (table [B, N, cap], count [B, N],
    overflow [B]), int32 as the kernels take them; entries past `cap` are
    dropped."""
    B = owner.shape[0]
    perm = torch.sort(torch.where(ok, key, BIG), dim=1, stable=True).indices
    s_owner = torch.gather(torch.where(ok, owner, N), 1, perm)
    s_nbr = torch.gather(nbr, 1, perm)
    pos = _group_positions(s_owner)
    count = _scatter_add(B, N, s_owner, s_owner < N, torch.int64)
    slot_ok = (s_owner < N) & (pos < cap)
    # one flat buffer with the dropped entries' slot at its very end, so the
    # table is a contiguous view, as the kernels take it
    base = _ar(B, owner.device)[:, None] * (N * cap)
    flat = torch.where(slot_ok, base + s_owner * cap + pos, B * N * cap)
    table = torch.zeros(B * N * cap + 1, dtype=torch.int32, device=owner.device)
    table.scatter_(0, flat.reshape(-1), torch.where(slot_ok, s_nbr, 0).to(torch.int32).reshape(-1))
    return (table[: B * N * cap].view(B, N, cap), count.to(torch.int32),
            (count > cap).any(dim=1))


def build_undirected_adjacency(tails, heads, valid, n_nodes_cap: int, a_cap: int):
    """Per-node neighbour lists in the reference's DFS scan order: in-edge
    tails first, then out-edge heads, each ascending in edge index
    (graph.cpp:984-1019). Returns (adj [B, N, a_cap], deg [B, N],
    overflow [B])."""
    B, E = tails.shape
    tails, heads = tails.long(), heads.long()
    eidx = _ar(E, tails.device).expand(B, E)
    owner = torch.cat([heads, tails], 1)
    ordr = torch.cat([eidx, eidx + E], 1)
    return _slot_table(owner, torch.cat([tails, heads], 1), torch.cat([valid, valid], 1),
                       owner * (2 * E) + ordr, n_nodes_cap, a_cap)


# ------------------------------------------------------------ the kernels


_DFS_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_TOPO_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_INTS3 = ctypes.c_int * 3
# largest N a launch takes (G1's frames, offsets, outputs and bitmap, and G2's
# stack, bitmap and outputs, in a block's shared memory)
N_MAX = 8192
# shared memory a block can opt into on Hopper (227 KB)
SMEM_OPTIN = 232448
# G1's block (csrc/graph_cycle.cu:kDfsThreads): the scan keeps a word a warp
DFS_THREADS = 512
# the forms of a G2 launch (_build.BUILD_FORMS), by its N: every window's
# rows fit a block's shared memory, or each window is staged where its rows
# fit (topo_row_cap); either way a window with a tail outside its n nodes
# (none in the cycle's renumbered graph) reads its rows where they lie
# (topo_staged)
FORMS = ("shared", "by window")


def _lib():
    lib = _build.get_lib("graph_cycle")
    if lib.graph_dfs_launch.argtypes is None:
        for fn, args in ((lib.graph_dfs_launch, _DFS_ARGS), (lib.graph_topo_launch, _TOPO_ARGS),
                         (lib.graph_dfs_smem, [ctypes.c_int, ctypes.c_int, _INTS3]),
                         (lib.graph_topo_smem, [ctypes.c_int, ctypes.c_int, _INTS3]),
                         (lib.graph_cycle_attrs, [ctypes.c_int, _INTS3])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def kernel_attrs(kernel: str) -> dict:
    """Registers a thread, static shared memory and local memory (spills)
    of G1 ("graph_dfs") or G2 ("graph_topo"), as the card's loader reports
    them."""
    out = _INTS3()
    rc = _lib().graph_cycle_attrs({"graph_dfs": 0, "graph_topo": 1}[kernel], out)
    _build.check(_lib(), rc, "graph_cycle_attrs")
    return dict(registers=out[0], static_smem_bytes=out[1], local_bytes=out[2])


def _int32(t):
    return t.to(torch.int32).contiguous()


# ------------------------------------------------------------ G1: DFS


def dfs_fixed_bytes(N: int) -> int:
    """G1's shared memory without its slots (csrc/graph_cycle.cu:
    dfs_fixed_bytes): the scan's word a warp, the stack's frames [N] int4,
    the slot offsets [N + 1], new_id and order [N], the visited bitmap."""
    return 4 * (DFS_THREADS // 32 + 7 * N + 1 + (N + 31) // 32)


def dfs_slot_cap(N: int, A: int) -> int:
    """The adjacency slots G1 stages compactly in shared memory
    (dfs_slot_cap): 4N (the cycle's graphs have E = 2N edges, so their
    slots below min(deg, A) sum to at most 4N), at most N a lane, and no
    more than the block's shared memory holds beside the rest. A window
    with more slots is walked from its rows where they lie."""
    return max(0, min(4 * N, min(A, 32) * N, (SMEM_OPTIN - dfs_fixed_bytes(N)) // 4))


def dfs_compact(deg, A: int):
    """[B] bool: True where G1 stages the window's slots compactly in shared
    memory, False where it walks the rows where they lie; its slots,
    min(deg, A, 32) a node, within dfs_slot_cap."""
    return deg.long().clamp(0, min(A, 32)).sum(dim=1) <= dfs_slot_cap(deg.shape[1], A)


def _dfs_plain(adj, deg, comp_mask, root):
    """Plain version of G1: the JAX program's batched stack machine, every
    window a push of one newly discovered node or a pop a step."""
    B, N, A = adj.shape
    dev = adj.device
    adj, deg, root = adj.long(), deg.long(), root.long()
    b = _ar(B, dev)
    has = comp_mask[b, root]
    visited = torch.zeros((B, N), dtype=torch.bool, device=dev)
    visited[b, root] = has
    new_id = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    new_id[b, root] = torch.where(has, 0, -1)
    order = torch.zeros((B, N), dtype=torch.int64, device=dev)
    order[b, 0] = root
    stack = torch.zeros((B, N), dtype=torch.int64, device=dev)
    stack[b, 0] = root
    pptr = torch.zeros((B, N), dtype=torch.int64, device=dev)
    sp = has.long()
    cnt = sp.clone()
    ar_a = _ar(A, dev)[None, :]
    steps = 0
    while steps < 2 * N + 1 and bool((sp > 0).any()):
        for _ in range(PLAIN_CHECK):
            active = sp > 0
            top = (sp - 1).clamp_min(0)
            v = stack[b, top]
            p = pptr[b, top]
            row = adj[b, v]  # [B, A]
            cand = (ar_a >= p[:, None]) & (ar_a < deg[b, v][:, None]) & ~torch.gather(visited, 1, row)
            anyc = cand.any(dim=1)
            jstar = torch.argmax(cand.to(torch.int32), dim=1)
            u = row[b, jstar]
            push = active & anyc
            pop = active & ~anyc
            pptr[b, top] = torch.where(push, jstar + 1, p)
            visited[b, u] |= push
            new_id[b, u] = torch.where(push, cnt, new_id[b, u])
            c1 = cnt.clamp_max(N - 1)
            order[b, c1] = torch.where(push, u, order[b, c1])
            s1 = sp.clamp_max(N - 1)
            stack[b, s1] = torch.where(push, u, stack[b, s1])
            pptr[b, s1] = torch.where(push, 0, pptr[b, s1])
            cnt = cnt + push.long()
            sp = sp + push.long() - pop.long()
        steps += PLAIN_CHECK
    return new_id, order, cnt


def dfs_preorder(adj, deg, comp_mask, root, check=True):
    """Preorder DFS numbering of the winning component from its min-id root
    (graph.cpp:984-1019). adj [B, N, A], deg [B, N], comp_mask [B, N] bool,
    root [B]. Returns (new_id [B, N], -1 outside the component; order
    [B, N], preorder position -> node id; n_sub [B]). CPU tensors run the
    plain machine; CUDA tensors launch G1 or raise. With `check` the inputs
    are made int32 (root int64, comp_mask bytes) and contiguous and
    checked; the cycle passes False for its own tensors, which are so
    already: G1 is launched on them as they are."""
    B, N, A = adj.shape
    dev = adj.device
    if dev.type == "cpu":
        return _dfs_plain(adj, deg, comp_mask, root)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if A > 32 or N > N_MAX:
        raise ValueError(f"G1 takes A <= 32 and N <= {N_MAX}, got A={A}, N={N}")
    if check:
        adj, deg, root = _int32(adj), _int32(deg), root.to(torch.int64).contiguous()
        if comp_mask.dtype not in (torch.bool, torch.uint8):
            comp_mask = comp_mask.to(torch.uint8)
        comp_mask = comp_mask.contiguous()
        _check_inputs(dict(adj=adj, deg=deg), torch.int32, dev)
        _check_inputs(dict(root=root), torch.int64, dev)
        _check_inputs(dict(comp_mask=comp_mask), comp_mask.dtype, dev)
        if deg.shape != (B, N) or comp_mask.shape != (B, N) or root.shape != (B,):
            raise ValueError("G1 takes adj [B, N, A], deg and comp_mask [B, N], root [B]")
    out = torch.empty((2 * B * N + B,), dtype=torch.int32, device=dev)
    new_id, order = out[: 2 * B * N].view(2, B, N)
    n_sub = out[2 * B * N :]
    if B:
        launch_dfs(adj, deg, comp_mask, root, new_id, order, n_sub)
    return new_id, order, n_sub


def launch_dfs(adj, deg, comp, root, new_id, order, n_sub):
    """G1 alone, on `dfs_preorder`'s buffers (adj, deg int32; comp bool or
    uint8; root int64), all on the card; `chip_smoke.py` times it apart
    from that glue. The kernel writes every element of its outputs."""
    B, N, A = adj.shape
    stream = torch.cuda.current_stream(adj.device).cuda_stream
    with torch.cuda.device(adj.device):
        rc = _lib().graph_dfs_launch(adj.data_ptr(), deg.data_ptr(), comp.data_ptr(),
                                     root.data_ptr(), new_id.data_ptr(), order.data_ptr(),
                                     n_sub.data_ptr(), B, N, A, stream)
    _build.check(_lib(), rc, "graph_dfs")
    _build.LAUNCHES["graph_dfs"] += 1


def dfs_smem(N: int, A: int) -> tuple:
    """(slot capacity, shared memory in bytes) of a G1 launch at (N, A), as
    the library computes them: `dfs_slot_cap` and `dfs_fixed_bytes` are
    their mirror."""
    out = _INTS3()
    _lib().graph_dfs_smem(N, A, out)
    return out[0], out[1]


# ------------------------------------------------------- subgraph renumber


def renumber_subgraph(tails, heads, valid, new_id, order, codes):
    """The winning component as a fresh graph: nodes in DFS preorder, edges
    in (new tail id, old edge index) order, every weight reset to 0
    (graph.cpp:1021-1089). Returns (tails2, heads2, weights2, valid2 [B, E],
    n_edges2 [B], codes2 [B, N]).

    An edge survives where both its ends do. Within capacity a kept edge
    from a component node ends in the component, so this is the JAX
    program's rule (tail in the component); past A_CAP the DFS may stop
    short of a node whose edge would then point at id -1, in a window
    flagged for the host whose graph must stay valid for the kernels."""
    B, E = tails.shape
    new_id = new_id.long()
    nt = torch.gather(new_id, 1, tails.long())
    nh = torch.gather(new_id, 1, heads.long())
    survive = valid & (nt >= 0) & (nh >= 0)
    key = torch.where(survive, nt * E + _ar(E, tails.device), BIG)
    perm = torch.sort(key, dim=1, stable=True).indices
    tails2 = torch.gather(torch.where(survive, nt, 0), 1, perm)
    heads2 = torch.gather(torch.where(survive, nh, 0), 1, perm)
    valid2 = torch.gather(survive, 1, perm)
    weights2 = torch.zeros((B, E), dtype=torch.int64, device=tails.device)
    codes2 = torch.gather(codes.long(), 1, order.long())
    return tails2, heads2, weights2, valid2, survive.sum(dim=1), codes2


# ----------------------------------------------------------- in-edge slots


def build_in_slots(tails, heads, valid, n_nodes_cap: int, p_cap: int):
    """Per-node in-edge tails in slot order (ascending edge index). Returns
    (in_nbr [B, N, p_cap], indeg [B, N], out_deg [B, N], overflow [B])."""
    B, E = tails.shape
    N = n_nodes_cap
    tails, heads = tails.long(), heads.long()
    in_nbr, indeg, overflow = _slot_table(heads, tails, valid,
                                          heads * E + _ar(E, tails.device), N, p_cap)
    out_deg = _scatter_add(B, N, torch.where(valid, tails, N), valid, torch.int64)
    return in_nbr, indeg, out_deg, overflow


# ------------------------------------------------------- G2: topo ranking


def _topo_plain(in_nbr, indeg, n_sub):
    """Plain version of G2: the JAX program's batched machine, every window
    a rooting, a push of its last unmet dependency or an emit a step."""
    B, N, P = in_nbr.shape
    dev = in_nbr.device
    in_nbr, indeg, n_sub = in_nbr.long(), indeg.long(), n_sub.long()
    b = _ar(B, dev)
    ar_n = _ar(N, dev)[None, :]
    ar_p = _ar(P, dev)[None, :]
    emitted = torch.zeros((B, N), dtype=torch.bool, device=dev)
    rank_of = torch.zeros((B, N), dtype=torch.int64, device=dev)
    rank_to_node = torch.zeros((B, N), dtype=torch.int64, device=dev)
    stack = torch.zeros((B, N), dtype=torch.int64, device=dev)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    steps = 0
    while steps < 3 * N + 2 and bool(((sp > 0) | (cnt < n_sub)).any()):
        for _ in range(PLAIN_CHECK):
            need_root = (sp == 0) & (cnt < n_sub)
            unem = ~emitted & (ar_n < n_sub[:, None])
            root = torch.argmax(unem.to(torch.int32), dim=1)
            top = (sp - 1).clamp_min(0)
            v = torch.where(need_root, root, stack[b, top])
            row = in_nbr[b, v]  # [B, P]
            dep_unmet = (ar_p < indeg[b, v][:, None]) & ~torch.gather(emitted, 1, row)
            any_unmet = dep_unmet.any(dim=1)
            last = (P - 1) - torch.argmax(dep_unmet.flip(1).to(torch.int32), dim=1)
            u = row[b, last]
            active = need_root | (sp > 0)
            do_push = active & ~need_root & any_unmet
            do_emit = active & ~need_root & ~any_unmet
            slot = sp.clamp_max(N - 1)
            stack[b, slot] = torch.where(need_root, v, torch.where(do_push, u, stack[b, slot]))
            sp = sp + (need_root | do_push).long() - do_emit.long()
            emitted[b, v] |= do_emit
            rank_of[b, v] = torch.where(do_emit, cnt, rank_of[b, v])
            rpos = cnt.clamp_max(N - 1)
            rank_to_node[b, rpos] = torch.where(do_emit, v, rank_to_node[b, rpos])
            cnt = cnt + do_emit.long()
        steps += PLAIN_CHECK
    return rank_of, rank_to_node


def topo_ranks(in_nbr, indeg, n_sub, check=True):
    """Topological emission order of the renumbered (bundle-free) graph
    (graph.cpp:301-371): roots in id order, the last unmet in-edge
    dependency expanded first. in_nbr [B, N, P], indeg [B, N], n_sub [B].
    Returns (rank_of [B, N], rank_to_node [B, N]). CPU tensors run the
    plain machine; CUDA tensors launch G2 or raise. With `check` the inputs
    are made int32 and contiguous and checked; the cycle passes False for
    its own buffers, which are so already: G2 is launched on them as they
    are."""
    B, N, P = in_nbr.shape
    dev = in_nbr.device
    if dev.type == "cpu":
        return _topo_plain(in_nbr, indeg, n_sub)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if P > 32 or N > N_MAX:
        raise ValueError(f"G2 takes P <= 32 and N <= {N_MAX}, got P={P}, N={N}")
    if check:
        in_nbr, indeg, n_sub = _int32(in_nbr), _int32(indeg), _int32(n_sub)
        _check_inputs(dict(in_nbr=in_nbr, indeg=indeg, n_sub=n_sub), torch.int32, dev)
        if indeg.shape != (B, N) or n_sub.shape != (B,):
            raise ValueError("G2 takes in_nbr [B, N, P], indeg [B, N], n_sub [B]")
    rank_of, rank_to_node = torch.empty((2, B, N), dtype=torch.int32, device=dev)
    if B:
        launch_topo(in_nbr, indeg, n_sub, rank_of, rank_to_node)
    return rank_of, rank_to_node


def launch_topo(in_nbr, indeg, n_sub, rank_of, rank_to_node):
    """G2 alone, on the int32 buffers of `topo_ranks`, all on the card;
    `chip_smoke.py` times it apart from that glue. The kernel writes every
    element of its outputs."""
    B, N, P = in_nbr.shape
    dev = in_nbr.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _build.on_device(dev):
        rc = _lib().graph_topo_launch(in_nbr.data_ptr(), indeg.data_ptr(), n_sub.data_ptr(),
                                      rank_of.data_ptr(), rank_to_node.data_ptr(), B, N, P,
                                      stream)
    _build.check(_lib(), rc, "graph_topo")
    _build.LAUNCHES["graph_topo"] += 1
    _build.BUILD_FORMS[("graph_topo", N, FORMS[topo_row_cap(N, P) < N])] += 1


def topo_smem_bytes(N: int, P: int, cap: int) -> int:
    """G2's shared memory with `cap` rows staged (csrc/graph_cycle.cu:
    topo_smem_bytes): rank_of, rank_to_node and the stack [N] int32, the
    emitted bitmap, the staged rows' tails as uint16 [cap, P] (rounded up to
    a word) and their min(indeg, P) as bytes."""
    return 4 * (3 * N + (N + 31) // 32) + ((2 * cap * P + 3) & ~3) + cap


def topo_row_cap(N: int, P: int) -> int:
    """The rows G2 stages (topo_row_cap): a window of n = min(n_sub, N)
    nodes stages them where n is at most this, N or as many as a block's
    shared memory holds beside the rest; a larger window reads its rows
    where they lie."""
    return max(0, min(N, (SMEM_OPTIN - topo_smem_bytes(N, P, 0) - 3) // (2 * P + 1)))


def topo_staged(in_nbr, n_sub):
    """[B] bool: False where G2 reads the window's rows where they lie: its
    n = min(n_sub, N) nodes pass `topo_row_cap`, or a tail in their rows
    lies outside [0, n) (never in the renumbered graph of the cycle); True
    where it walks them from shared memory."""
    B, N, P = in_nbr.shape
    n = n_sub.long().clamp_max(N)
    real = torch.arange(N, device=in_nbr.device)[None, :, None] < n[:, None, None]
    t = in_nbr.long()
    outside = (real & ((t < 0) | (t >= n[:, None, None]))).flatten(1).any(1)
    return (n <= topo_row_cap(N, P)) & ~outside


def topo_smem(N: int, P: int) -> tuple:
    """(row capacity, shared memory in bytes) of a G2 launch at (N, P), as
    the library computes them: `topo_row_cap` and `topo_smem_bytes` are
    their mirror."""
    out = _INTS3()
    _lib().graph_topo_smem(N, P, out)
    return out[0], out[1]


# ------------------------------------------------------- DP array assembly


def build_dp_arrays(rank_of, rank_to_node, in_nbr, indeg, out_deg, codes, n_sub):
    """Rank-ordered aligner inputs in the layout of csrc/poagraph.cpp:poa_dense:
    codes_dp[r] = code of the rank-r node; preds_dp[r, s] = DP row (rank + 1)
    of the s-th in-edge tail, no predecessors -> row 0, padding repeats slot
    0; is_sink[r] = the node has no out-edges."""
    B, N, P = in_nbr.shape
    dev = in_nbr.device
    r2n = rank_to_node.long()
    codes_dp = torch.gather(codes.long(), 1, r2n)
    indeg_r = torch.gather(indeg.long(), 1, r2n)
    is_sink = (torch.gather(out_deg.long(), 1, r2n) == 0) & (_ar(N, dev)[None, :] < n_sub[:, None])
    tails_r = torch.gather(in_nbr.long(), 1, r2n[:, :, None].expand(B, N, P))
    pred_rows = torch.gather(rank_of.long(), 1, tails_r.reshape(B, N * P)).reshape(B, N, P) + 1
    has_pred = _ar(P, dev)[None, None, :] < indeg_r[:, :, None]
    first = torch.where(indeg_r > 0, pred_rows[:, :, 0], 0)
    preds_dp = torch.where(has_pred, pred_rows, first[:, :, None])
    return codes_dp, preds_dp, is_sink


# ------------------------------------------------------------ mixed-mode DP


def pred_distance(preds_dp, n_sub):
    """Largest (DP row - predecessor row) of each window's real rows [B]
    (row-0 predecessors excluded: K1 pins row 0 in a slot of its own)."""
    B, N, P = preds_dp.shape
    rows = _ar(N, preds_dp.device)[None, :, None] + 1
    live = rows <= n_sub.reshape(B, 1, 1)
    return torch.where((preds_dp > 0) & live, rows - preds_dp, 0).amax(dim=(1, 2))


def dp_width(S: int) -> int:
    """K1's lane count for sequences of up to S codes: S + 1 lanes (lane j =
    position j - 1) rounded up to a multiple of 32."""
    return -(-(S + 1) // 32) * 32


def poa_align_mixed(codes_dp, preds_dp, is_sink, n_sub, seq, seq_len, is_sw, m, x, g,
                    node_id=None, active=None):
    """Batched sequence-to-graph alignment with an align mode per sequence
    (`is_sw`: sw at 3/-5/-4, else nw at (m, x, g)), on K1 and the dense walk.
    codes_dp [B, N], preds_dp [B, N, P], is_sink [B, N], n_sub [B] from
    `build_dp_arrays`; seq [B, D, S] (0xFF padding), seq_len [B, D];
    node_id [B, N] (rank -> node id) or None; active [B, D] (None: all):
    inactive sequences are not aligned.

    Returns (pairs [B, D, L, 2] int32 back to front, right-aligned, -2
    before them, L = N + S + 1, the JAX program's layout; count [B, D];
    score [B, D]; ring_over [B] bool). Pair rows are (rank or node id | -1,
    seq pos | -1). A window whose predecessor distance passes 511
    (`ring_over`) is not aligned: its pairs are all -2, its counts 0."""
    dev = seq.device
    B, D, S = seq.shape
    N, P = preds_dp.shape[1], preds_dp.shape[2]
    L = N + S + 1
    preds_dp, n_sub, seq, seq_len = preds_dp.long(), n_sub.long(), seq.long(), seq_len.long()
    dist = pred_distance(preds_dp, n_sub)
    ring_over = dist > MAX_RING
    act = torch.ones((B, D), dtype=torch.bool, device=dev) if active is None else active.clone()
    act &= ~ring_over[:, None]
    # a window past the ring aligns nothing, and K1 sees every row of it
    # with row 0 as its one predecessor
    preds_dp = torch.where(ring_over[:, None, None], 0, preds_dp)
    sel = {"nw": act & ~is_sw, "sw": act & is_sw}
    cnt = {k: s.sum(dim=1) for k, s in sel.items()}
    indeg = (preds_dp[:, :, 1:] != preds_dp[:, :, :1]).sum(dim=2) + 1
    live = _ar(N, dev)[None, :] < n_sub[:, None]
    d_nw, d_sw, ring, deg_max, len_max = torch.stack([
        cnt["nw"].max(), cnt["sw"].max(), torch.where(ring_over, 0, dist).max(),
        torch.where(live, indeg, 0).max(),
        torch.where(act, seq_len, 0).max()]).tolist() if B * D else (0, 0, 0, 0, 0)
    # results depend on neither: lanes past a sequence's end and in-edge
    # slots past a node's in-degree take part in no best cell or walk. W
    # stays within dp_width(S), the width `fits_int16` was asked about
    W = min(bucket(len_max + 1, W_BUCKETS) or dp_width(S), dp_width(S))
    Pm = min(bucket(max(deg_max, 1), (4, 8, 16)) or P, P)
    R = max(1, min(ring, N))

    pn = torch.full((B, D + 1, L), -2, dtype=torch.int16, device=dev)
    pp = torch.full_like(pn, -2)
    count = torch.zeros((B, D + 1), dtype=torch.int32, device=dev)
    score = torch.zeros_like(count)
    codes32 = _int32(codes_dp)
    sink32 = _int32(is_sink)
    nsub32 = _int32(n_sub)
    aux_src = _int32(preds_dp[:, :, :Pm].transpose(1, 2))
    nid32 = None if node_id is None else _int32(node_id)
    for mode, dm in (("nw", d_nw), ("sw", d_sw)):
        if dm == 0:
            continue
        mm, xx, gg = (m, x, g) if mode == "nw" else SW_SCORES
        # the mode's sequences of each window first, in index order
        order = torch.sort((~sel[mode]).to(torch.int32), dim=1, stable=True).indices[:, :dm]
        slot_ok = _ar(dm, dev)[None, :] < cnt[mode][:, None]
        sq = torch.gather(seq, 1, order[:, :, None].expand(B, dm, S))[:, :, : W - 1]
        seqp = torch.full((B, dm, W), 0xFF, dtype=torch.int32, device=dev)
        seqp[:, :, 1 : 1 + sq.shape[2]] = torch.where(slot_ok[:, :, None], sq, 0xFF).to(torch.int32)
        seqp[:, :, 1] = torch.where(slot_ok, seqp[:, :, 1], 0)  # padding: one 'A'
        slen = _int32(torch.where(slot_ok, torch.gather(seq_len, 1, order), 1))
        dst = torch.where(slot_ok, order, D)
        per_slot = (N + 1) * dm * W * 2 + dm * (R + 1) * W * 2
        step = max(1, LAUNCH_BYTES // per_slot)
        for b0 in range(0, B, step):
            cut = slice(b0, b0 + step)
            aux, deg = pack_aux(aux_src[cut], R)
            dirs, maxi, maxj, sc = poa_dp(codes32[cut], aux, deg, sink32[cut], nsub32[cut],
                                          seqp[cut].contiguous(), slen[cut].contiguous(),
                                          mode, mm, xx, gg, R)
            wn, wp, wc = traceback_walk_dense(dirs, maxi, maxj, mode, L, Pm,
                                              None if nid32 is None else nid32[cut])
            idx = dst[cut]
            pn[cut].scatter_(1, idx[:, :, None].expand(-1, -1, L), wn)
            pp[cut].scatter_(1, idx[:, :, None].expand(-1, -1, L), wp)
            count[cut].scatter_(1, idx, wc)
            score[cut].scatter_(1, idx, sc)
    pairs = torch.stack([pn[:, :D], pp[:, :D]], dim=3).to(torch.int32)
    return pairs, count[:, :D], score[:, :D], ring_over


def ranks_to_ids(pairs, rank_to_node):
    """The rank column of traceback pairs [B, D, L, 2] as node ids."""
    B, D, L, _ = pairs.shape
    r = pairs[..., 0].long()
    ids = torch.gather(rank_to_node.long(), 1, r.clamp_min(0).reshape(B, D * L)).reshape(B, D, L)
    return torch.stack([torch.where(r >= 0, ids, r), pairs[..., 1].long()], dim=3)


# -------------------------------------------------------------- AddWeights


def add_weights_batch(tails, heads, weights, valid, n_edges, pairs, seq_w, n_nodes_cap: int):
    """AddWeights of every realigned sequence of each window
    (graph.cpp:1104-1165): each adjacent matched pair adds w[p-1] + w[p] to
    the edge (prev -> curr); a missing edge between surviving nodes is
    appended after the existing ones in first-occurrence order across the
    sequence stream. pairs [B, D, L, 2] in node-id space, seq_w [B, D, S].
    Returns (tails', heads', weights', valid', n_edges', overflow [B])."""
    B, E = tails.shape
    D, L = pairs.shape[1], pairs.shape[2]
    N = n_nodes_cap
    dev = tails.device
    tails, heads, weights = tails.long(), heads.long(), weights.long()
    n_edges = n_edges.long()
    an = pairs[..., 0].long()
    ap = pairs[..., 1].long()
    matched = (an >= 0) & (ap >= 0)
    contrib = matched[:, :, 1:] & matched[:, :, :-1]
    t_c, h_c, p_c = an[:, :, :-1], an[:, :, 1:], ap[:, :, 1:]
    seq_w = seq_w.long()
    wp = torch.gather(seq_w, 2, p_c.clamp_min(0))
    wpm1 = torch.gather(seq_w, 2, (p_c - 1).clamp_min(0))
    C = D * (L - 1)
    key = torch.where(contrib, t_c * N + h_c, BIG).reshape(B, C)
    w_flat = torch.where(contrib, wp + wpm1, 0).reshape(B, C)
    c_valid = contrib.reshape(B, C)

    # lookup against the round-start edge set
    ekey, eperm = torch.sort(torch.where(valid, tails * N + heads, BIG), dim=1, stable=True)
    slot = torch.searchsorted(ekey, key).clamp_(0, E - 1)
    found = torch.gather(ekey, 1, slot) == key
    eidx = torch.gather(eperm, 1, slot)
    hit = found & c_valid
    weights = weights + _scatter_add(B, E, torch.where(hit, eidx, E), torch.where(hit, w_flat, 0),
                                     torch.int64)

    # new edges: not-found keys deduplicated by first stream occurrence; the
    # stable sort keeps equal keys in stream order
    nf = c_valid & ~found
    sk, perm2 = torch.sort(torch.where(nf, key, BIG), dim=1, stable=True)
    sw_ = torch.gather(torch.where(nf, w_flat, 0), 1, perm2)
    live = sk < BIG
    first = torch.cat([live[:, :1], (sk[:, 1:] != sk[:, :-1]) & live[:, 1:]], 1)
    gid = torch.cumsum(first.long(), dim=1) - 1
    n_new = torch.where(first, gid + 1, 0).amax(dim=1)
    gsum = _scatter_add(B, C, torch.where(live, gid, C), torch.where(live, sw_, 0), torch.int64)
    # the representative (first) entry of each group, ordered by first
    # occurrence: within equal keys the stream order ascends
    rep_order = torch.where(first, perm2, BIG)
    rep_key = torch.where(first, sk, BIG)
    rep_sum = torch.where(first, torch.gather(gsum, 1, gid.clamp_min(0)), 0)
    perm3 = torch.sort(rep_order, dim=1, stable=True).indices
    NE = min(E, C)
    new_key = torch.gather(rep_key, 1, perm3)[:, :NE]
    new_sum = torch.gather(rep_sum, 1, perm3)[:, :NE]

    j_new = _ar(NE, dev)[None, :]
    dst = n_edges[:, None] + j_new
    put = (j_new < n_new[:, None]) & (dst < E)
    dst_c = torch.where(put, dst, E)

    def place(base, vals):
        out = torch.cat([base, base[:, :1]], 1)
        return out.scatter_(1, dst_c, vals.to(base.dtype))[:, :E]

    tails = place(tails, torch.where(put, new_key // N, 0))
    heads = place(heads, torch.where(put, new_key % N, 0))
    weights = place(weights, torch.where(put, new_sum, 0))
    valid = place(valid, put)
    overflow = n_edges + n_new > E
    return tails, heads, weights, valid, torch.clamp(n_edges + n_new, max=E), overflow


# ------------------------------------------------------------------- emit


def corrected_emit(pairs, codes):
    """GenerateCorrectedSequence (graph.cpp:1167-1179): the code of every
    non-gap node on the alignment path [B, L, 2], in path order. Returns
    (out [B, L] left-packed, out_len [B])."""
    B, L, _ = pairs.shape
    an = pairs[:, :, 0].long()
    keep = an >= 0
    pos = torch.cumsum(keep.long(), dim=1) - 1
    ch = torch.gather(codes.long(), 1, an.clamp_min(0))
    out = torch.zeros((B, L + 1), dtype=torch.int64, device=pairs.device)
    out.scatter_(1, torch.where(keep, pos, L), torch.where(keep, ch, 0))
    return out[:, :L], keep.sum(dim=1)


# ------------------------------------------------------------- full cycle


def prune_and_rebuild(tails, heads, weights, valid, codes, n_alive, avg_weight, min_confidence,
                      min_support, n_cap: int, a_cap: int, p_cap: int,
                      stats: Optional[dict] = None):
    """One prune -> largest component -> renumber -> topological rank pass.
    Returns the renumbered graph (edge arrays, codes, n_sub), the rank
    tables, the DP arrays and the overflow bits of each window."""
    node_alive = _ar(n_cap, tails.device)[None, :] < n_alive.reshape(-1, 1)
    keep = prune_edges(tails, heads, weights, valid, n_cap, avg_weight, min_confidence,
                       min_support)
    labels = cc_min_labels(tails, heads, keep, node_alive, stats)
    comp_mask, root = select_component(labels, node_alive)
    adj, deg, ovf_a = build_undirected_adjacency(tails, heads, keep, n_cap, a_cap)
    new_id, order, n_sub = dfs_preorder(adj, deg, comp_mask, root, check=False)
    t2, h2, w2, v2, ne2, codes2 = renumber_subgraph(tails, heads, keep, new_id, order, codes)
    in_nbr, indeg, out_deg, ovf_p = build_in_slots(t2, h2, v2, n_cap, p_cap)
    rank_of, rank_to_node = topo_ranks(in_nbr, indeg, n_sub, check=False)
    n_sub = n_sub.long()
    codes_dp, preds_dp, is_sink = build_dp_arrays(rank_of, rank_to_node, in_nbr, indeg, out_deg,
                                                  codes2, n_sub)
    overflow = torch.where(ovf_a, OVF_A_CAP, 0) | torch.where(ovf_p, OVF_P_CAP, 0)
    return dict(tails=t2, heads=h2, weights=w2, valid=v2, n_edges=ne2, codes=codes2,
                n_sub=n_sub, rank_of=rank_of, rank_to_node=rank_to_node, codes_dp=codes_dp,
                preds_dp=preds_dp, is_sink=is_sink, overflow=overflow)


def haplotype_cycle(tails, heads, weights, n_edges, codes, n_nodes, avg_weight, seqs, seq_len,
                    seq_w, is_sw, d_used, min_confidence, min_support, num_prune: int, m: int,
                    x: int, g: int, a_cap: int = 32, p_cap: int = 16,
                    stats: Optional[dict] = None):
    """The haplotype prune cycle of a window batch (src/window.cpp:300-396):
    prune + largest subgraph; (num_prune - 1) times realign every sequence,
    AddWeights and prune again; then the backbone's sw alignment and the
    corrected-sequence emit. Tensors on one device (tails/heads/weights
    [B, E], n_edges [B], codes [B, N], n_nodes [B], avg_weight [B] float32,
    seqs/seq_w [B, D, S] with sequence 0 the backbone, seq_len [B, D],
    is_sw [B, D] bool, d_used [B]).

    Returns (corrected [B, N + S + 1], out_len [B], overflow [B] int64
    bits, n_sub [B]). A window with any overflow bit must be recomputed on
    the host. `stats`, a dict, gets `cc_rounds` (see `cc_min_labels`).
    Raises ValueError on scores that leave K1's int16 rows at (N, S)."""
    B, E = tails.shape
    N = codes.shape[1]
    D, S = seqs.shape[1], seqs.shape[2]
    dev = tails.device
    if not (fits_int16(N, dp_width(S), m, x, g) and fits_int16(N, dp_width(S), *SW_SCORES)):
        raise ValueError(f"scores ({m}, {x}, {g}) or {SW_SCORES} leave K1's int16 rows at "
                         f"N={N}, S={S}: such a bucket takes the host cycle")
    valid0 = _ar(E, dev)[None, :] < n_edges.reshape(B, 1)
    st = prune_and_rebuild(tails, heads, weights, valid0, codes, n_nodes, avg_weight,
                           min_confidence, min_support, N, a_cap, p_cap, stats)
    overflow = st["overflow"]
    seq_active = _ar(D, dev)[None, :] < d_used.reshape(B, 1)

    for _ in range(num_prune - 1):
        pairs, _, _, ring_over = poa_align_mixed(
            st["codes_dp"], st["preds_dp"], st["is_sink"], st["n_sub"], seqs, seq_len, is_sw,
            m, x, g, node_id=st["rank_to_node"], active=seq_active)
        overflow = overflow | torch.where(ring_over, OVF_RING, 0)
        t2, h2, w2, v2, ne2, ovf_w = add_weights_batch(
            st["tails"], st["heads"], st["weights"], st["valid"], st["n_edges"], pairs, seq_w, N)
        overflow = overflow | torch.where(ovf_w, OVF_NEW_EDGES, 0)
        st = prune_and_rebuild(t2, h2, w2, v2, st["codes"], st["n_sub"], avg_weight,
                               min_confidence, min_support, N, a_cap, p_cap, stats)
        overflow = overflow | st["overflow"]

    # the backbone's sw alignment and the corrected emit (src/window.cpp:388-394)
    p_bb, _, _, ring_over = poa_align_mixed(
        st["codes_dp"], st["preds_dp"], st["is_sink"], st["n_sub"], seqs[:, :1], seq_len[:, :1],
        torch.ones((B, 1), dtype=torch.bool, device=dev), m, x, g, node_id=st["rank_to_node"])
    overflow = overflow | torch.where(ring_over, OVF_RING, 0)
    corrected, out_len = corrected_emit(p_bb[:, 0], st["codes"])
    return corrected, out_len, overflow, st["n_sub"]
