"""The incremental build of round 1 (B7) as batched PyTorch programs over
dense edge-list graph tensors, with its three stepping machines as CUDA
kernels (G3, G4, G5) and its layer alignments on K1 and the dense walk.

Counterpart of `vechat_tpu/ops/kernels/graph_build.py` (the XLA program
`device_build` and its parts, same names, same argument order, same
layouts): AddAlignment fusion, the aligned-node bundled topological order
and the positional subgraph (reference semantics: vendor/spoa
src/graph.cpp:182-299 AddAlignment, :301-371 TopologicalSort with aligned
bundles, :640-745 Subgraph/UpdateAlignment; host twin
csrc/poagraph.cpp:96-201, :330-368; the build loop src/window.cpp:84-136).

Graph state, beyond `graph_cycle`'s edge-list form:
  aligned[B, N, R]  aligned-node rings, insertion order (R = ring cap)
  acount[B, N]      ring lengths

Order-sensitive semantics kept word for word:
  * fusion: the unaligned prefix run, then the suffix run, then the matched
    pairs, node ids allocated in that order; an edge merges into the first
    existing (tail, head) edge, else it is appended; a new node aligned to
    `jt` is ring-linked in the reference's member order (graph.cpp:260-279)
  * bundled topological order: roots in id order, skipping nodes in a
    bundle; the dependencies of the top are its in-edge tails (slot order)
    and then its unmet ring members, all claimed into the bundle when the
    top first scans them; the last unmet one is expanded first; a bundle's
    representative emits itself and then its whole ring, contiguously
  * positional subgraph: backward reachability from `end` through nodes
    >= `begin` along in-edges and rings; renumbered ascending in old id;
    edges re-emitted in (head, edge index) order; rings filtered in order

`topo_ranks_bundled` (G3), the reachability of `positional_subgraph` (G5,
`reach_keep`) and `fuse_walk`, the walk of `fuse_alignments` (G4), launch
the kernels of `csrc/graph_build.cu` on CUDA tensors and run their plain
versions, the batched machines of the JAX program, on CPU tensors.
`device_build` keeps its graph in int32 buffers that `fuse_walk_` updates
in place, one G4 launch a layer step with no copies; G5 groups the
in-edges by head itself; G3 takes the build's int32 buffers as they are
(`check=False`). G3, G4 and G5 take their shared form where the window
fits a block's shared memory (`kernel_form`), else their global form (G4
and G5 on a scratch buffer, G3 reading its rows where they lie).
Everything else is the array work XLA ran, as torch ops
on the tensors' device. A write that JAX drops at index N or E goes into
a padded extra column that is sliced away; a write past a capacity is
clamped to the last slot and flags the window, as in JAX.

`device_build` flags a window (`overflow_bits`, beside JAX's `overflow`)
for nodes past N, edges past E, a ring past R, in-slots past P, or a
predecessor distance past 511 (K1's 9-bit field; JAX's int32 DP has no such
limit). A window once flagged is frozen: its later layers are neither
ranked, aligned nor fused (JAX goes on with clamped writes); its result is
thrown away either way, and its flag is the same.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .graph_cycle import (
    BIG,
    PLAIN_CHECK,
    SMEM_OPTIN,
    _ar,
    _int32,
    build_dp_arrays,
    build_in_slots,
    poa_align_mixed,
)
from .poa_linear import _check_inputs

# overflow bits of `fuse_walk` and `device_build` (any bit: the host route)
OVF_N_CAP = 1
OVF_E_CAP = 2
OVF_R_CAP = 4
OVF_P_CAP = 8
OVF_RING = 16
BUILD_OVF_BITS = dict(n_cap=OVF_N_CAP, e_cap=OVF_E_CAP, r_cap=OVF_R_CAP, p_cap=OVF_P_CAP,
                      ring=OVF_RING)

# rounds of the plain reachability between two reads of its `changed` flag
REACH_CHECK = 8
# largest N and E a launch takes (G3's bitmaps and stack, and G5's bitmap,
# in shared memory, G3's node ids as uint16; G4's and G5's global forms'
# scratch)
N_MAX = 8192
E_MAX = 16384


def fuse_smem_bytes(N: int, E: int, R: int, track: bool) -> int:
    """Shared memory of G4's shared form (csrc/graph_build.cu:fuse_smem_ints):
    the (tail, head) table, weights, next_out and the labels [E]; codes,
    acount and first_out [N]; the rings [N, R]."""
    return 4 * ((4 + 2 * track) * E + 3 * N + N * R)


def fuse_scratch_ints(N: int, E: int) -> int:
    """Scratch of G4's global form a window (fuse_scratch_ints): the table,
    next_out and first_out, rounded up to an even count."""
    return (3 * E + N + 1) // 2 * 2


def reach_smem_bytes(N: int, E: int, R: int) -> int:
    """Shared memory of G5's shared form: the kept bitmap, the group bounds
    [N + 1], the grouped tails [E], the rings [N, R], the counts and the
    stack [N]."""
    return 4 * ((N + 31) // 32 + N + 1 + E + N * R + 2 * N)


def reach_scratch_ints(N: int, E: int) -> int:
    """Scratch of G5's global form a window: the group bounds, the grouped
    tails and the stack."""
    return 2 * N + 1 + E


def topo_smem_bytes(N: int, P: int, R: int) -> int:
    """Shared memory of G3's shared form (csrc/graph_build.cu:topo_smem_bytes):
    the stack, rank_of and rank_to_node [N] int32, the (indeg, acount) pairs
    [N], the emitted and bundled bitmaps, and the in-slot and ring ids [N,
    P + R] as uint16, rounded up to a word."""
    return 4 * N + 8 * ((N + 31) // 32) + 16 * N + (2 * N * (P + R) + 3) // 4 * 4


def kernel_form(kernel: str, N: int, E: int = 0, R: int = 0, track: bool = False,
                P: int = 0) -> str:
    """"shared" where the window fits the block's shared memory, else
    "global": the form the launch of G4 ("graph_fuse", from N, E, R and
    track), G5 ("graph_reach", N, E, R) or G3 ("graph_topo_bundled", N, P,
    R) takes."""
    if kernel == "graph_fuse":
        need = fuse_smem_bytes(N, E, R, track)
    elif kernel == "graph_reach":
        need = reach_smem_bytes(N, E, R)
    else:
        need = topo_smem_bytes(N, P, R)
    return "shared" if need <= SMEM_OPTIN else "global"


def topo_steps(N: int) -> int:
    """Steps of the JAX machine's while_loop at N: iterations of 4 steps while
    the counter is below 3N + 2 + 4. A window that has not finished by then
    (only a cyclic graph, in a flagged window) stops there, in both versions."""
    return 4 * -(-(3 * N + 6) // 4)


def _bit32(j: int) -> int:
    """1 << j as an int32 value (bit 31 is negative)."""
    v = 1 << j
    return v - (1 << 32) if v >= 1 << 31 else v


_TOPO_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_REACH_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_FUSE_ARGS = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ATTRS_OUT = ctypes.c_int * 3


def _lib():
    lib = _build.get_lib("graph_build")
    if lib.graph_fuse_launch.argtypes is None:
        for fn, args in ((lib.graph_topo_bundled_launch, _TOPO_ARGS),
                         (lib.graph_reach_launch, _REACH_ARGS),
                         (lib.graph_fuse_launch, _FUSE_ARGS),
                         (lib.graph_build_attrs, [ctypes.c_int, _ATTRS_OUT])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def kernel_attrs(kernel: str, form: str = "shared") -> dict:
    """Registers a thread, static shared memory and local memory (spills)
    of G3 ("graph_topo_bundled"), G4 ("graph_fuse") or G5 ("graph_reach")
    in `form`, as the card's loader reports them."""
    which = {("graph_topo_bundled", "shared"): 0, ("graph_reach", "shared"): 1,
             ("graph_reach", "global"): 2, ("graph_fuse", "shared"): 3,
             ("graph_fuse", "global"): 4, ("graph_topo_bundled", "global"): 5}[(kernel, form)]
    out = _ATTRS_OUT()
    rc = _lib().graph_build_attrs(which, out)
    _build.check(_lib(), rc, "graph_build_attrs")
    return dict(registers=out[0], static_smem_bytes=out[1], local_bytes=out[2])


def _on_card(dev) -> bool:
    """True on a CUDA device, False on the CPU (the plain versions); raises
    for any other device."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------- G3: bundled topo ranks


def _topo_bundled_plain(in_nbr, indeg, aligned, acount, n_nodes):
    """Plain version of G3: the JAX program's batched machine, every window
    a rooting, a push of its last unmet dependency or an emit a step."""
    B, N, P = in_nbr.shape
    R = aligned.shape[2]
    dev = in_nbr.device
    in_nbr, indeg, aligned = in_nbr.long(), indeg.long(), aligned.long()
    acount, n_nodes = acount.long(), n_nodes.long()
    b = _ar(B, dev)
    ar_n, ar_p, ar_r = _ar(N, dev)[None, :], _ar(P, dev)[None, :], _ar(R, dev)[None, :]
    # one padded column: JAX's dropped writes land there
    emitted = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    in_bundle = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    rank_of = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    rank_to_node = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    stack = torch.zeros((B, N), dtype=torch.int64, device=dev)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    rcnt = torch.zeros(B, dtype=torch.int64, device=dev)
    steps, cap = 0, topo_steps(N)
    while steps < cap and bool(((sp > 0) | (rcnt < n_nodes)).any()):
        for _ in range(min(PLAIN_CHECK, cap - steps)):
            need_root = (sp == 0) & (rcnt < n_nodes)
            rootable = ~emitted[:, :N] & ~in_bundle[:, :N] & (ar_n < n_nodes[:, None])
            root = torch.argmax(rootable.to(torch.int32), dim=1)
            top = (sp - 1).clamp(0, N - 1)
            v = torch.where(need_root, root, stack[b, top])
            tails_row = in_nbr[b, v]
            tail_unmet = (ar_p < indeg[b, v][:, None]) & ~torch.gather(emitted, 1, tails_row)
            av = acount[b, v]
            ring_row = aligned[b, v]
            v_bundled = in_bundle[b, v]
            ring_unmet = ((ar_r < av[:, None]) & ~torch.gather(emitted, 1, ring_row)
                          & ~v_bundled[:, None])
            any_ring, any_tail = ring_unmet.any(1), tail_unmet.any(1)
            last_ring = (R - 1) - torch.argmax(ring_unmet.flip(1).to(torch.int32), dim=1)
            last_tail = (P - 1) - torch.argmax(tail_unmet.flip(1).to(torch.int32), dim=1)
            # ring dependencies are pushed after tail ones, so they pop first
            u = torch.where(any_ring, ring_row[b, last_ring], tails_row[b, last_tail])
            active = need_root | (sp > 0)
            do_push = active & ~need_root & (any_ring | any_tail)
            do_emit = active & ~need_root & ~(any_ring | any_tail)
            # every unmet ring member is claimed when the top scans it
            claim = ring_unmet & (do_push | do_emit)[:, None]
            in_bundle.scatter_(1, torch.where(claim, ring_row, N), True)
            slot = sp.clamp_max(N - 1)
            stack[b, slot] = torch.where(need_root, v, torch.where(do_push, u, stack[b, slot]))
            sp = sp + (need_root | do_push).long() - do_emit.long()
            emitted[b, v] |= do_emit
            # a representative emits itself, then its whole ring
            rep = do_emit & ~v_bundled
            pos_v = rcnt.clamp_max(N - 1)
            rank_to_node[b, pos_v] = torch.where(rep, v, rank_to_node[b, pos_v])
            rank_of.scatter_(1, torch.where(rep, v, N)[:, None], rcnt[:, None])
            ring_on = (ar_r < av[:, None]) & rep[:, None]
            ring_pos = rcnt[:, None] + 1 + ar_r
            rank_to_node.scatter_(1, torch.where(ring_on, ring_pos.clamp_max(N - 1), N), ring_row)
            rank_of.scatter_(1, torch.where(ring_on, ring_row, N), ring_pos)
            rcnt = rcnt + torch.where(rep, 1 + av, 0)
        steps += PLAIN_CHECK
    return rank_of[:, :N], rank_to_node[:, :N]


def topo_ranks_bundled(in_nbr, indeg, aligned, acount, n_nodes, check=True):
    """Topological emission order with aligned-node bundles
    (graph.cpp:301-371; csrc/poagraph.cpp:96-140). in_nbr [B, N, P] (in-edge
    tails, slot order), indeg [B, N], aligned [B, N, R], acount [B, N],
    n_nodes [B]. Returns (rank_of [B, N], rank_to_node [B, N]). CPU tensors
    run the plain machine; CUDA tensors launch G3 or raise. With `check`
    the inputs are made int32 and contiguous and checked; the build passes
    False for its own buffers, which are so already: G3 is launched on them
    as they are."""
    B, N, P = in_nbr.shape
    R = aligned.shape[2]
    dev = in_nbr.device
    if not _on_card(dev):
        return _topo_bundled_plain(in_nbr, indeg, aligned, acount, n_nodes)
    if P + R > 32 or N > N_MAX:
        raise ValueError(f"G3 takes P + R <= 32 and N <= {N_MAX}, got P={P}, R={R}, N={N}")
    if check:
        in_nbr, indeg, aligned, acount, n_nodes = (_int32(t) for t in (in_nbr, indeg, aligned,
                                                                        acount, n_nodes))
        _check_inputs(dict(in_nbr=in_nbr, indeg=indeg, aligned=aligned, acount=acount,
                           n_nodes=n_nodes), torch.int32, dev)
        if aligned.shape[:2] != (B, N) or indeg.shape != (B, N) or acount.shape != (B, N):
            raise ValueError("G3 takes in_nbr [B, N, P], indeg and acount [B, N], "
                             "aligned [B, N, R]")
    rank_of, rank_to_node = torch.empty((2, B, N), dtype=torch.int32, device=dev)
    if B:
        launch_topo_bundled(in_nbr, indeg, aligned, acount, n_nodes, rank_of, rank_to_node)
    return rank_of, rank_to_node


def launch_topo_bundled(in_nbr, indeg, aligned, acount, n_nodes, rank_of, rank_to_node):
    """G3 alone, on the int32 buffers of `topo_ranks_bundled`, all on the
    card, in the form `kernel_form` gives; `chip_smoke.py` times it apart
    from that glue. The kernel writes every element of its outputs."""
    B, N, P = in_nbr.shape
    R = aligned.shape[2]
    form = kernel_form("graph_topo_bundled", N, R=R, P=P)
    stream = torch.cuda.current_stream(in_nbr.device).cuda_stream
    with torch.cuda.device(in_nbr.device):
        rc = _lib().graph_topo_bundled_launch(
            in_nbr.data_ptr(), indeg.data_ptr(), aligned.data_ptr(), acount.data_ptr(),
            n_nodes.data_ptr(), rank_of.data_ptr(), rank_to_node.data_ptr(), B, N, P, R,
            topo_steps(N), int(form == "shared"), stream)
    _build.check(_lib(), rc, "graph_topo_bundled")
    _build.LAUNCHES["graph_topo_bundled"] += 1
    _build.BUILD_FORMS[("graph_topo_bundled", N, form)] += 1


# ------------------------------------------------------------ G4: fusion


def _fuse_plain(codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, pairs, count,
                seq, seq_w, seq_len, active_w, lab_lo=None, lab_hi=None, bit_lo=None,
                bit_hi=None):
    """Plain version of G4: the JAX program's batched walk, one prefix or
    suffix position, or one pair, of every window a step. Returns what
    `fuse_walk` returns."""
    B, N = codes.shape
    E = tails.shape[1]
    R = aligned.shape[2]
    L = pairs.shape[1]
    W = seq.shape[1]
    dev = codes.device
    b = _ar(B, dev)
    ar_e, ar_r = _ar(E, dev)[None, :], _ar(R, dev)[None, :]
    track = lab_lo is not None

    def padded(t, n):
        out = torch.zeros((B, n + 1) + tuple(t.shape[2:]), dtype=torch.int64, device=dev)
        out[:, :n] = t
        return out

    # state, each with one padded row or column for the dropped writes
    codes_p, tails_p, heads_p, weights_p = (padded(codes, N), padded(tails, E),
                                            padded(heads, E), padded(weights, E))
    al = padded(aligned, N)  # [B, N + 1, R]
    al_flat = al.view(B, (N + 1) * R)
    ac = padded(acount, N)
    if track:
        lab = [padded(lab_lo, E), padded(lab_hi, E)]
        bits = [bit_lo.long(), bit_hi.long()]
    n_nodes, n_edges = n_nodes.long().clone(), n_edges.long().clone()
    seq, seq_w, seq_len, count = seq.long(), seq_w.long(), seq_len.long(), count.long()
    active = active_w.bool()
    ovf = torch.zeros(B, dtype=torch.int64, device=dev)

    an, ap = pairs[:, :, 0].long(), pairs[:, :, 1].long()
    ap_ok = (_ar(L, dev)[None, :] >= (L - count[:, None])) & (ap >= 0)
    vfront = torch.where(ap_ok, ap, BIG).amin(1)
    vback = torch.where(ap_ok, ap, -1).amax(1)
    # no alignment, or one without sequence positions: the whole sequence
    # is one unaligned run (graph.cpp:209-213)
    no_aln = (count == 0) | ~ap_ok.any(1)
    vfront = torch.where(no_aln, seq_len, vfront)
    vback = torch.where(no_aln, seq_len - 1, vback)

    def at(t, i):
        return t[b, i.clamp(0, W - 1)]

    def add_node(code, do):
        nonlocal n_nodes
        pos = n_nodes.clamp_max(N - 1)
        codes_p[b, torch.where(do, pos, N)] = code
        n_nodes = n_nodes + do.long()
        return pos

    def add_edge(t, h, w, do):
        """Merge into the existing (t -> h) edge, else append (graph.cpp:94-107)."""
        nonlocal n_edges, ovf
        hit = ((tails_p[:, :E] == t[:, None]) & (heads_p[:, :E] == h[:, None])
               & (ar_e < n_edges[:, None]))
        found = hit.any(1)
        eidx = torch.argmax(hit.to(torch.int32), dim=1)
        weights_p[b, torch.where(do & found, eidx, E)] += w
        pos = n_edges.clamp_max(E - 1)
        app = do & ~found
        dst = torch.where(app, pos, E)
        tails_p[b, dst] = t
        heads_p[b, dst] = h
        weights_p[b, dst] = w
        if track:
            touched = torch.where(do, torch.where(found, eidx, pos), E)
            for lw, bit in zip(lab, bits):
                cur = lw[b, touched.clamp_max(E - 1)]
                lw[b, touched] = torch.where(app, bit, cur | bit)
        ovf = ovf | torch.where(app & (n_edges >= E), OVF_E_CAP, 0)
        n_edges = n_edges + app.long()

    def run(lo, hi):
        """A chain of fresh nodes for positions [lo, hi); (its last, first)."""
        prev = torch.full((B,), -1, dtype=torch.int64, device=dev)
        first = prev.clone()
        steps = int(torch.where(active, hi - lo, 0).max().clamp_min(0)) if B else 0
        for k in range(steps):
            i = lo + k
            do = active & (i < hi)
            nid = add_node(at(seq, i), do)
            add_edge(prev, nid, at(seq_w, i - 1) + at(seq_w, i), do & (prev >= 0) & (i > lo))
            first = torch.where(do & (first < 0), nid, first)
            prev = torch.where(do, nid, prev)
        return prev, first

    prefix_prev, _ = run(torch.zeros_like(vfront), vfront)
    _, suffix_first = run(vback + 1, seq_len)

    # the matched pairs (graph.cpp:238-292); steps before every window's
    # pair region change nothing
    prev = prefix_prev
    walking = active & ~no_aln
    k_lo = int(torch.where(walking, L - count, L).min().clamp_min(0)) if B else L
    for k in range(k_lo, L):
        a_n, a_p = an[:, k], ap[:, k]
        do = walking & (k >= L - count) & (a_p >= 0)
        code = at(seq, a_p)
        is_new = a_n < 0
        jt = a_n.clamp(0, N - 1)
        jt_match = ~is_new & (codes_p[b, jt] == code)
        ring_row = al[b, jt]
        av = ac[b, jt]
        ring_hit = ((ar_r < av[:, None]) & (torch.gather(codes_p, 1, ring_row) == code[:, None])
                    & (~is_new & ~jt_match)[:, None])
        ring_found = ring_hit.any(1)
        ring_node = ring_row[b, torch.argmax(ring_hit.to(torch.int32), dim=1)]
        need_new = do & (is_new | (~jt_match & ~ring_found))
        new_id = add_node(code, need_new)
        curr = torch.where(jt_match, jt, torch.where(ring_found, ring_node, new_id))

        # a NEW node aligned to jt: every member gets curr appended, curr's
        # ring is the members then jt, and jt gets curr (graph.cpp:260-279)
        link = need_new & ~is_new
        on = (ar_r < av[:, None]) & link[:, None]
        m_pos = torch.gather(ac, 1, ring_row).clamp_max(R - 1)
        drop = N * R
        al_flat.scatter_(1, torch.where(on, ring_row * R + m_pos, drop), curr[:, None].expand(B, R))
        ac.scatter_add_(1, torch.where(on, ring_row, N), on.long())
        cpos = curr.clamp_max(N - 1)
        al_flat.scatter_(1, torch.where(on, cpos[:, None] * R + ar_r, drop), ring_row)
        slot = av.clamp_max(R - 1)
        al_flat[b, torch.where(link, cpos * R + slot, drop)] = jt
        ac[b, torch.where(link, cpos, N)] = av + 1
        al_flat[b, torch.where(link, jt * R + slot, drop)] = curr
        ac[b, torch.where(link, jt, N)] += 1
        ovf = ovf | torch.where(link & (av + 1 > R), OVF_R_CAP, 0)

        add_edge(prev, curr, at(seq_w, a_p - 1) + at(seq_w, a_p), do & (prev >= 0))
        prev = torch.where(do, curr, prev)

    # the bridge into the suffix run (csrc/poagraph.cpp:196-198)
    add_edge(prev, suffix_first, at(seq_w, vback) + at(seq_w, vback + 1),
             walking & (suffix_first >= 0) & (prev >= 0))
    ovf = ovf | torch.where(n_nodes > N, OVF_N_CAP, 0) | torch.where(n_edges > E, OVF_E_CAP, 0)
    labs = ([x[:, :E] for x in lab] if track
            else [torch.zeros((B, 1), dtype=torch.int64, device=dev)] * 2)
    return (codes_p[:, :N], tails_p[:, :E], heads_p[:, :E], weights_p[:, :E], n_nodes, n_edges,
            al[:, :N], ac[:, :N], ovf, *labs)


def fuse_walk(codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, pairs, count,
              seq, seq_w, seq_len, active_w, lab_lo=None, lab_hi=None, bit_lo=None,
              bit_hi=None):
    """`fuse_alignments` with its overflow as bits (OVF_N_CAP, OVF_E_CAP,
    OVF_R_CAP). CPU tensors run the plain walk; CUDA tensors launch G4 or
    raise. Nothing it is given is written: the kernel works on copies (the
    build updates its own buffers in place, `fuse_walk_`)."""
    B = codes.shape[0]
    dev = codes.device
    track = lab_lo is not None
    if not _on_card(dev):
        return _fuse_plain(codes, tails, heads, weights, n_nodes, n_edges, aligned, acount,
                           pairs, count, seq, seq_w, seq_len, active_w, lab_lo, lab_hi, bit_lo,
                           bit_hi)

    def fresh(t):
        return torch.empty(t.shape, dtype=torch.int32, device=dev).copy_(t)

    state = [fresh(t) for t in (codes, tails, heads, weights, n_nodes, n_edges, aligned, acount)]
    labs = [fresh(lab_lo), fresh(lab_hi)] if track else [None, None]
    bits = [_int32(bit_lo), _int32(bit_hi)] if track else [None, None]
    ins = [_int32(t) for t in (pairs, count, seq, seq_w, seq_len)]
    ovf = fuse_walk_(*state, *ins, active_w.to(torch.uint8).contiguous(), *labs, *bits)
    if not track:
        labs = [torch.zeros((B, 1), dtype=torch.int32, device=dev)] * 2
    return (*state, ovf, *labs)


def fuse_walk_(codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, pairs, count,
               seq, seq_w, seq_len, active_w, lab_lo=None, lab_hi=None, bit_lo=None,
               bit_hi=None, check=True):
    """`fuse_walk` on the graph buffers (codes ... acount, and the labels),
    which it updates in place; returns the overflow bits [B] int32. On the
    card every tensor must be int32 and contiguous (active_w bool or uint8),
    as `device_build` keeps them: G4 is launched on them as they are, and
    `check` (the build's first layer step) checks that, and the shapes,
    first. On the CPU the plain walk runs and its results are copied in."""
    B, N = codes.shape
    E = tails.shape[1]
    R = aligned.shape[2]
    L = pairs.shape[1]
    W = seq.shape[1]
    dev = codes.device
    track = lab_lo is not None
    if not _on_card(dev):
        out = _fuse_plain(codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, pairs,
                          count, seq, seq_w, seq_len, active_w, lab_lo, lab_hi, bit_lo, bit_hi)
        bufs = (codes, tails, heads, weights, n_nodes, n_edges, aligned, acount)
        for buf, o in zip(bufs + ((lab_lo, lab_hi) if track else ()), out[:8] + out[9:]):
            buf.copy_(o)
        return out[8].to(torch.int32)
    if check:
        if R > 32 or E > E_MAX or N > N_MAX or W < 1:
            raise ValueError(f"G4 takes R <= 32, N <= {N_MAX}, E <= {E_MAX} and W >= 1, "
                             f"got R={R}, N={N}, E={E}, W={W}")
        shapes = dict(codes=(B, N), tails=(B, E), heads=(B, E), weights=(B, E), n_nodes=(B,),
                      n_edges=(B,), aligned=(B, N, R), acount=(B, N), pairs=(B, L, 2),
                      count=(B,), seq=(B, W), seq_w=(B, W), seq_len=(B,), active_w=(B,))
        named = dict(zip(shapes, (codes, tails, heads, weights, n_nodes, n_edges, aligned, acount,
                                  pairs, count, seq, seq_w, seq_len, active_w)))
        if track:
            shapes.update(lab_lo=(B, E), lab_hi=(B, E), bit_lo=(B,), bit_hi=(B,))
            named.update(lab_lo=lab_lo, lab_hi=lab_hi, bit_lo=bit_lo, bit_hi=bit_hi)
        for name, shp in shapes.items():
            if tuple(named[name].shape) != shp:
                raise ValueError(f"G4: {name} has shape {tuple(named[name].shape)}, "
                                 f"expected {shp}")
        act = named.pop("active_w")
        if act.dtype not in (torch.bool, torch.uint8) or not act.is_contiguous():
            raise ValueError("G4: active_w must be a contiguous bool or uint8 tensor")
        _check_inputs(named, torch.int32, dev)
    ovf = torch.empty((B,), dtype=torch.int32, device=dev)
    scratch = None
    if kernel_form("graph_fuse", N, E, R, track) == "global":
        scratch = torch.empty((B, fuse_scratch_ints(N, E)), dtype=torch.int32, device=dev)
    if B:
        launch_fuse(codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, lab_lo,
                    lab_hi, bit_lo, bit_hi, pairs, count, seq, seq_w, seq_len, active_w, ovf,
                    scratch)
    return ovf


def launch_fuse(codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, lab_lo, lab_hi,
                bit_lo, bit_hi, pairs, count, seq, seq_w, seq_len, active, overflow,
                scratch=None):
    """G4 alone, on the int32 (active: bool or uint8) buffers of
    `fuse_walk_`, all on the card; the graph buffers (and labels, or None)
    are updated in place. `scratch` ([B, fuse_scratch_ints]) selects the
    global form, None the shared one. `chip_smoke.py` times it apart from
    that glue."""
    B, N = codes.shape
    E, R, L, W = tails.shape[1], aligned.shape[2], pairs.shape[1], seq.shape[1]
    form = "shared" if scratch is None else "global"
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with torch.cuda.device(codes.device):
        rc = _lib().graph_fuse_launch(
            *(_ptr(t) for t in (codes, tails, heads, weights, n_nodes, n_edges, aligned, acount,
                                lab_lo, lab_hi, bit_lo, bit_hi, pairs, count, seq, seq_w,
                                seq_len, active, overflow, scratch)),
            B, N, E, R, L, W, int(lab_lo is not None), stream)
    _build.check(_lib(), rc, "graph_fuse")
    _build.LAUNCHES["graph_fuse"] += 1
    _build.BUILD_FORMS[("graph_fuse", N, form)] += 1


def fuse_alignments(codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, pairs, count,
                    seq, seq_w, seq_len, active_w, lab_lo=None, lab_hi=None, bit_lo=None,
                    bit_hi=None):
    """One AddAlignment a window, batched (graph.cpp:182-299;
    csrc/poagraph.cpp:142-201): codes [B, N], tails/heads/weights [B, E],
    n_nodes/n_edges [B], aligned [B, N, R], acount [B, N], pairs [B, L, 2]
    in node-id space, back to front (the last `count` rows), count [B] (0:
    the whole sequence unaligned), seq/seq_w [B, W], seq_len [B], active_w
    [B] bool; with labels, lab_lo/lab_hi [B, E] edge bitmasks of the
    sequences through each edge and bit_lo/bit_hi [B] this sequence's bit,
    ORed into every edge it touches. Returns (codes, tails, heads, weights,
    n_nodes, n_edges, aligned, acount, overflow [B] bool, lab_lo, lab_hi),
    the labels [B, 1] zeros without them."""
    out = fuse_walk(codes, tails, heads, weights, n_nodes, n_edges, aligned, acount, pairs, count,
                    seq, seq_w, seq_len, active_w, lab_lo, lab_hi, bit_lo, bit_hi)
    return (*out[:8], out[8] != 0, *out[9:])


# ------------------------------------------------ G5: positional reachability


def _reach_plain(tails, heads, n_edges, aligned, acount, begin, end, use_full, n_nodes):
    """Plain version of G5: the JAX program's fixpoint, every window one
    round of in-edge and ring propagation a step. The fixpoint is the same
    set whatever the schedule, so the flag is read every `REACH_CHECK`
    rounds (rounds past it change nothing)."""
    B, E = tails.shape
    N, R = aligned.shape[1], aligned.shape[2]
    dev = tails.device
    tails, heads, aligned = tails.long(), heads.long(), aligned.long()
    n_nodes, begin, end = n_nodes.long(), begin.long(), end.long()
    ar_n = _ar(N, dev)[None, :]
    node_real = ar_n < n_nodes[:, None]
    evalid = _ar(E, dev)[None, :] < n_edges.long()[:, None]
    ok = (ar_n >= begin[:, None]) & node_real
    keep = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    start_ok = (end >= begin) & (end < n_nodes) & (end >= 0) & (end < N)
    keep[_ar(B, dev), torch.where(start_ok, end, N)] = True
    keep = keep[:, :N]
    ring_on_slot = _ar(R, dev)[None, None, :] < acount.long()[:, :, None]
    rounds = 0
    while rounds < N:
        for _ in range(min(REACH_CHECK, N - rounds)):
            kh = torch.gather(keep, 1, heads)
            new = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
            new.scatter_(1, torch.where(evalid & kh, tails, N), True)
            ring_on = ring_on_slot & keep[:, :, None]
            new.scatter_(1, torch.where(ring_on, aligned, N).reshape(B, N * R), True)
            new = (new[:, :N] & ok) | keep
            changed = (new != keep).any()
            keep = new
            rounds += 1
        if not bool(changed):
            break
    return torch.where(use_full.bool()[:, None], node_real, keep)


def reach_keep(tails, heads, n_edges, aligned, acount, begin, end, use_full, n_nodes):
    """The node set of `positional_subgraph` [B, N] bool: the nodes >= begin
    (and below n_nodes) from which `end` is reached along edges and rings,
    `end` among them; nothing where end < begin or end >= n_nodes; every
    real node for `use_full` windows. CPU tensors run the plain fixpoint;
    CUDA tensors launch G5, which groups the in-edges itself, or raise.
    Given int32 contiguous tensors (use_full bool or uint8), as
    `device_build` keeps them, it converts nothing: it allocates the result
    (and, past shared memory, G5's scratch) and launches."""
    B, E = tails.shape
    N, R = aligned.shape[1], aligned.shape[2]
    dev = tails.device
    if not _on_card(dev):
        return _reach_plain(tails, heads, n_edges, aligned, acount, begin, end, use_full, n_nodes)
    if R > 32 or N > N_MAX or E > E_MAX:
        raise ValueError(f"G5 takes R <= 32, N <= {N_MAX} and E <= {E_MAX}, "
                         f"got R={R}, N={N}, E={E}")
    shapes = dict(heads=(B, E), n_edges=(B,), aligned=(B, N, R), acount=(B, N), begin=(B,),
                  end=(B,), use_full=(B,), n_nodes=(B,))
    named = dict(zip(shapes, (heads, n_edges, aligned, acount, begin, end, use_full, n_nodes)))
    for name, shp in shapes.items():
        if tuple(named[name].shape) != shp:
            raise ValueError(f"G5: {name} has shape {tuple(named[name].shape)}, expected {shp}")
    args = [_int32(t) for t in (tails, heads, n_edges, aligned, acount, begin, end, n_nodes)]
    _check_inputs(dict(zip(("tails", "heads", "n_edges", "aligned", "acount", "begin", "end",
                            "n_nodes"), args)), torch.int32, dev)
    full = use_full if use_full.dtype in (torch.bool, torch.uint8) else use_full.bool()
    full = full.contiguous()
    if full.device != dev:
        raise ValueError(f"use_full is on {full.device}, expected {dev}")
    keep = torch.empty((B, N), dtype=torch.bool, device=dev)
    scratch = None
    if kernel_form("graph_reach", N, E, R) == "global":
        scratch = torch.empty((B, reach_scratch_ints(N, E)), dtype=torch.int32, device=dev)
    if B:
        launch_reach(*args[:7], full, args[7], keep, scratch)
    return keep


def launch_reach(tails, heads, n_edges, aligned, acount, begin, end, use_full, n_nodes, keep,
                 scratch=None):
    """G5 alone, on the int32 (use_full: bool or uint8) buffers of
    `reach_keep`, all on the card; `scratch` ([B, reach_scratch_ints])
    selects the global form, None the shared one. `chip_smoke.py` times it
    apart from that glue. The kernel writes every element of `keep`."""
    B, N, R = aligned.shape
    E = tails.shape[1]
    form = "shared" if scratch is None else "global"
    stream = torch.cuda.current_stream(aligned.device).cuda_stream
    with torch.cuda.device(aligned.device):
        rc = _lib().graph_reach_launch(
            *(_ptr(t) for t in (tails, heads, n_edges, aligned, acount, begin, end, use_full,
                                n_nodes, keep, scratch)),
            B, N, E, R, stream)
    _build.check(_lib(), rc, "graph_reach")
    _build.LAUNCHES["graph_reach"] += 1
    _build.BUILD_FORMS[("graph_reach", N, form)] += 1


# ------------------------------------------------------- positional subgraph


def positional_subgraph(codes, tails, heads, weights, n_edges, aligned, acount, begin, end,
                        use_full, n_nodes):
    """The subgraph a partial layer aligns to (graph.cpp:640-666;
    csrc/poagraph.cpp:330-368): the nodes of `reach_keep`, renumbered
    ascending in old id, edges with both ends kept re-emitted in (head, edge
    index) order, each ring's kept members left-compacted in order. Windows
    with `use_full` keep every node, so one batch serves mixed full and
    partial layers. Returns a dict of codes, tails, heads, weights, n_edges,
    aligned, acount, n_sub, order (new id -> old id) and new_id (old id ->
    new id, -1 dropped), int32."""
    B, N = codes.shape
    E = tails.shape[1]
    R = aligned.shape[2]
    dev = codes.device
    keep = reach_keep(tails, heads, n_edges, aligned, acount, begin, end, use_full, n_nodes)
    ar_n = _ar(N, dev)
    new_id = torch.where(keep, torch.cumsum(keep, dim=1) - 1, -1)
    n_sub = keep.sum(dim=1)
    order = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    order.scatter_(1, torch.where(keep, new_id, N), ar_n.expand(B, N))
    order = order[:, :N]
    codes_sub = torch.gather(codes.long(), 1, order)

    # an edge survives where both its ends do
    tails, heads = tails.long(), heads.long()
    nt, nh = torch.gather(new_id, 1, tails), torch.gather(new_id, 1, heads)
    esurv = (_ar(E, dev)[None, :] < n_edges.long()[:, None]) & (nt >= 0) & (nh >= 0)
    eperm = torch.sort(torch.where(esurv, nh * E + _ar(E, dev), BIG), dim=1, stable=True).indices
    tails_sub = torch.gather(torch.where(esurv, nt, 0), 1, eperm)
    heads_sub = torch.gather(torch.where(esurv, nh, 0), 1, eperm)
    weights_sub = torch.gather(torch.where(esurv, weights.long(), 0), 1, eperm)

    # the old ring of each new node, its kept members in new ids, compacted
    ring_old = torch.gather(aligned.long(), 1, order[:, :, None].expand(B, N, R))
    acount_old = torch.gather(acount.long(), 1, order)
    ring_new = torch.gather(new_id, 1, ring_old.reshape(B, N * R)).reshape(B, N, R)
    ring_on = (_ar(R, dev)[None, None, :] < acount_old[:, :, None]) & (ring_new >= 0)
    pos = torch.cumsum(ring_on, dim=2) - 1
    aligned_sub = torch.zeros((B, N, R + 1), dtype=torch.int64, device=dev)
    aligned_sub.scatter_(2, torch.where(ring_on, pos, R), torch.where(ring_on, ring_new, 0))
    out = dict(codes=codes_sub, tails=tails_sub, heads=heads_sub, weights=weights_sub,
               n_edges=esurv.sum(dim=1), aligned=aligned_sub[:, :, :R],
               acount=ring_on.sum(dim=2), n_sub=n_sub, order=order, new_id=new_id)
    return {k: v.to(torch.int32) for k, v in out.items()}


# ------------------------------------------------------------- the build


def device_build(bb_codes, bb_w, bb_len, lseqs, lw, llen, lbegin, lend, lfull, n_layers,
                 n_cap: int, e_cap: int, r_cap: int, m: int, x: int, g: int, p_cap: int = 16,
                 track_labels: bool = False, stats: Optional[dict] = None):
    """Round 1's incremental build of a window batch (src/window.cpp:84-136;
    graph.cpp:182-299 AddAlignment), on the tensors' device: the backbone
    chain, then one layer step for each of max(n_layers) layers. A step cuts
    the positional subgraph (G5), ranks it in bundled topological order (G3),
    NW-aligns the layer at (m, x, g) on K1 and the dense walk, maps the pairs
    back to full-graph ids and fuses them into the graph (G4). Layers come
    in the reference's sorted order (`windows._layer_order`).

    bb_codes/bb_w [B, W] (build weights), bb_len [B]; lseqs/lw [B, SMAX, W]
    (0xFF padding), llen/lbegin/lend [B, SMAX], lfull [B, SMAX] bool (a
    full-span layer aligns to the whole graph), n_layers [B]. Returns a dict
    of codes [B, N], tails/heads/weights [B, E], n_nodes/n_edges [B],
    aligned [B, N, R], acount [B, N], overflow [B] bool, lab_lo/lab_hi
    ([B, E] with `track_labels`, sequence j's bit j; else [B, 1] zeros),
    int32 as JAX's, and `overflow_bits` [B] (see the module docstring).
    `stats`, a dict, gets `layer_steps`, the steps run."""
    B, W = bb_codes.shape
    SMAX = lseqs.shape[1]
    N, E, R = n_cap, e_cap, r_cap
    dev = bb_codes.device
    ar_n, ar_e = _ar(N, dev)[None, :], _ar(E, dev)[None, :]
    bb_len = bb_len.long()

    # the backbone chain (graph.cpp:109-130, AddAlignment of an empty one);
    # a backbone past N is flagged, and its chain stops at N so that every
    # node id stays below N
    codes = torch.zeros((B, max(N, W)), dtype=torch.int64, device=dev)
    codes[:, :W] = bb_codes
    codes = torch.where(ar_n < bb_len[:, None], codes[:, :N], 0)
    n_nodes = bb_len.clone()
    chain_on = ar_e < (bb_len.clamp_max(N)[:, None] - 1)
    tails = torch.where(chain_on, ar_e, 0)
    heads = torch.where(chain_on, ar_e + 1, 0)
    bw = torch.zeros((B, max(E + 1, W)), dtype=torch.int64, device=dev)
    bw[:, :W] = bb_w
    weights = torch.where(chain_on, bw[:, :E] + bw[:, 1 : E + 1], 0)
    n_edges = chain_on.sum(dim=1)
    aligned = torch.zeros((B, N, R), dtype=torch.int64, device=dev)
    acount = torch.zeros((B, N), dtype=torch.int64, device=dev)
    ovf = torch.where(bb_len > N, OVF_N_CAP, 0)
    # the backbone's edges carry label bit 0
    lab = ([torch.where(chain_on, 1, 0), torch.zeros((B, E), dtype=torch.int64, device=dev)]
           if track_labels else [None, None])
    # the graph as int32 buffers, which every layer step's fusion (G4, or on
    # the CPU the plain walk) updates in place; a layer's rows of the inputs
    # contiguous, so that G4 and G5 take them as they are
    graph = [_int32(t) for t in (codes, tails, heads, weights, n_nodes, n_edges, aligned, acount)]
    codes, tails, heads, weights, n_nodes, n_edges, aligned, acount = graph
    lab = [_int32(t) for t in lab] if track_labels else [None, None]
    lseqs_s, lw_s = _int32(lseqs.transpose(0, 1)), _int32(lw.transpose(0, 1))
    llen_s, lbegin_s, lend_s = (_int32(t.t()) for t in (llen, lbegin, lend))
    lfull_s = lfull.bool().t().contiguous()
    if track_labels:  # layer s is sequence s + 1 (the backbone is 0): its bit [SMAX, 2, B]
        bit_rows = [[_bit32(j) if j < 32 else 0, _bit32(j - 32) if j >= 32 else 0]
                    for j in range(1, SMAX + 1)]
        bits_s = torch.tensor(bit_rows, dtype=torch.int32, device=dev)[:, :, None]
        bits_s = bits_s.expand(SMAX, 2, B).contiguous()
    n_layers = n_layers.long()
    steps = int(n_layers.max()) if B else 0
    for s in range(min(steps, SMAX)):
        # a window past its layers, or flagged, is neither aligned nor fused
        active = s < n_layers
        live = active & (ovf == 0)
        slen = torch.where(active, llen_s[s], 1)
        # G5 and its plain version read n_nodes past N as N
        sub = positional_subgraph(codes, tails, heads, weights, n_edges, aligned, acount,
                                  lbegin_s[s], lend_s[s], lfull_s[s] | ~active, n_nodes)
        in_nbr, indeg, out_deg, ovf_p = build_in_slots(
            sub["tails"], sub["heads"], ar_e < sub["n_edges"].long()[:, None], N, p_cap)
        # only a live window's order is read (a frozen one's layer is
        # neither aligned nor fused): G3 ranks no node of the others, whose
        # clamped graphs can hold cycles that run its machine to the cap
        rank_of, rank_to_node = topo_ranks_bundled(in_nbr, indeg, sub["aligned"], sub["acount"],
                                                   torch.where(live, sub["n_sub"], 0),
                                                   check=False)
        codes_dp, preds_dp, is_sink = build_dp_arrays(rank_of, rank_to_node, in_nbr, indeg,
                                                      out_deg, sub["codes"], sub["n_sub"])
        # K1 sees a frozen window's rows with row 0 as their one predecessor
        preds_dp = torch.where(live[:, None, None], preds_dp, 0)
        pairs, count, _, ring_over = poa_align_mixed(
            codes_dp, preds_dp, is_sink, sub["n_sub"], lseqs_s[s][:, None, :], slen[:, None],
            torch.zeros((B, 1), dtype=torch.bool, device=dev), m, x, g,
            node_id=rank_to_node, active=live[:, None])
        # subgraph ids back to full-graph ids (UpdateAlignment, graph.cpp:723-745)
        pn = pairs[:, 0, :, 0]
        mapped = torch.gather(sub["order"], 1, pn.clamp_min(0).long())
        pairs = torch.stack([torch.where(pn >= 0, mapped, pn), pairs[:, 0, :, 1]], dim=2)
        bits = [bits_s[s, 0], bits_s[s, 1]] if track_labels else [None, None]
        ovf_f = fuse_walk_(*graph, pairs, torch.where(live, count[:, 0], 0), lseqs_s[s], lw_s[s],
                           slen, live, *lab, *bits, check=s == 0)
        step_ovf = (ovf_f.long() | torch.where(ovf_p, OVF_P_CAP, 0)
                    | torch.where(ring_over, OVF_RING, 0))
        ovf = ovf | torch.where(live, step_ovf, 0)
    if stats is not None:
        stats["layer_steps"] = stats.get("layer_steps", 0) + min(steps, SMAX)
    if not track_labels:
        lab = [torch.zeros((B, 1), dtype=torch.int64, device=dev)] * 2
    out = dict(codes=codes, tails=tails, heads=heads, weights=weights, n_nodes=n_nodes,
               n_edges=n_edges, aligned=aligned, acount=acount, lab_lo=lab[0], lab_hi=lab[1],
               overflow_bits=ovf)
    out = {k: v.to(torch.int32) for k, v in out.items()}
    out["overflow"] = out["overflow_bits"] != 0
    return out
