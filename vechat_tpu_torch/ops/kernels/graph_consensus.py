"""Round 2's window consensus (B9) as batched PyTorch programs over dense
edge-list graph tensors: the device build with edge labels, the weighted
in-slots and the out-slots, the bundled topological order, the heaviest
bundle with branch completion (kernel G6), per-node coverage and the kTGS
trim, one dispatch a window batch.

Counterpart of `vechat_tpu/ops/kernels/graph_consensus.py` (the XLA program
`device_linear` and its parts, same names, same argument order, same
layouts; reference semantics: vendor/spoa src/graph.cpp:534-588
TraverseHeaviestBundle, :590-638 BranchCompletion, :38-56 Coverage,
:461-485 GenerateConsensus with coverages; the trim src/window.cpp:141-171;
host twin csrc/poagraph.cpp:370-443).

Order-sensitive semantics kept word for word:
  * an in-edge wins on the lexicographic maximum of (weight, tail score);
    on a full tie the LAST maximal slot wins (the host's `<=` replaces)
  * the running maximum is the FIRST strict maximum in rank order; the
    first rank a pass processes always takes it
  * a node with no usable slot gets score -1 and predecessor -1; branch
    completion sets -1 on every in-slot tail (other than the start) of each
    out-head of the start, rescans the ranks past the start's skipping
    tails of score -1, and repeats while the new maximum has out-edges, up
    to `max_branch_iters` passes (a window still going then is flagged)
  * coverage of a consensus node is the count of distinct sequences on its
    in- and out-edges (the OR of their 64-bit labels) PLUS each aligned
    ring member's own count, summed (graph.cpp:480-484)
  * trim: the first and last consensus positions with coverage >= the
    average; none, or begin >= end, keeps the whole consensus

Scores are int32, as JAX's: a path score is at most N x the largest edge
weight, 2048 x (64 sequences x 2 x 1000) ~ 2.6e8 < 2^31 under the ladders
of `pipeline/device_cycle.py` (N <= 2048, depth <= 64; the phred weights of
a FASTQ window are at most 1000 a base); deeper or longer windows take the
host route before they are packed.

`heaviest_bundle` launches G6 (`csrc/graph_consensus.cu`, a block a
window) on CUDA tensors and runs its plain version, the JAX program's
batched machine, on CPU tensors. Everything else is the array work XLA
ran, as torch ops on the tensors' device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .graph_build import BUILD_OVF_BITS, _on_card, device_build, topo_ranks_bundled
from .graph_cycle import _ar, _int32, _slot_table
from .poa_linear import _check_inputs

NEG = -(2**30)

# overflow bits of `device_linear`, beside the build's (any bit: the host route)
OVF_SLOTS = 32  # an in-degree or out-degree past the slot cap
OVF_BRANCH = 64  # branch completion still going after max_branch_iters passes
LINEAR_OVF_BITS = dict(BUILD_OVF_BITS, slots=OVF_SLOTS, branch=OVF_BRANCH)

# largest N a launch takes (the scores and predecessors of a window in a
# block's shared memory)
N_MAX = 8192


def walk_steps(N: int) -> int:
    """Steps of the JAX backward walk's while_loop at N: iterations of 4
    steps while the counter is below N + 4. A path (at most N nodes) ends
    well before; only a cycle of predecessors would run to the cap."""
    return 4 * -(-(N + 4) // 4)


# ----------------------------------------------------- weighted in/out slots


def build_in_slots_weighted(tails, heads, weights, valid, n_nodes_cap: int, p_cap: int):
    """Per-node in-edge (tail, weight) lists in slot order (ascending edge
    index, the spoa in-edge order). Returns (in_nbr [B, N, P], in_w
    [B, N, P], indeg [B, N], overflow [B]), int32 as the kernels take them;
    overflow where an in-degree passes p_cap."""
    E = tails.shape[1]
    tails, heads = tails.long(), heads.long()
    key = heads * E + _ar(E, tails.device)
    in_nbr, indeg, overflow = _slot_table(heads, tails, valid, key, n_nodes_cap, p_cap)
    in_w, _, _ = _slot_table(heads, weights.long(), valid, key, n_nodes_cap, p_cap)
    return in_nbr, in_w, indeg, overflow


def build_out_slots(tails, heads, valid, n_nodes_cap: int, q_cap: int):
    """Per-node out-edge head lists in slot order (ascending edge index).
    Returns (out_nbr [B, N, Q], out_deg [B, N], overflow [B])."""
    E = tails.shape[1]
    tails, heads = tails.long(), heads.long()
    return _slot_table(tails, heads, valid, tails * E + _ar(E, tails.device), n_nodes_cap, q_cap)


# --------------------------------------------------------- heaviest bundle


def _bundle_scan(scores, preds, in_nbr, in_w, indeg, rank_to_node, n_nodes, lo_rank,
                 skip_invalid: bool, win_active, stats: Optional[dict] = None):
    """One pass over the ranks of the scores/predecessors recurrence, every
    window a rank a step (graph.cpp:534-563, :590-638 the branch-completion
    pass; csrc/poagraph.cpp:379-424), in place on scores and preds [B, N + 1]
    int32 (a padded column takes the writes of windows that do not process
    the rank). Processes ranks lo_rank < r < n_nodes of the active windows;
    returns maxn [B], the pass's first strict maximum in rank order (-1
    where no rank was processed)."""
    B, N, P = in_nbr.shape
    dev = in_nbr.device
    b = _ar(B, dev)
    ar_p = _ar(P, dev)[None, :]
    n_nodes, lo_rank = n_nodes.long().clamp_max(N), lo_rank.long()
    maxn = torch.full((B,), -1, dtype=torch.int64, device=dev)
    maxsc = torch.zeros(B, dtype=torch.int32, device=dev)
    lo = torch.where(win_active, lo_rank + 1, N)
    hi = torch.where(win_active, n_nodes, 0)
    r_lo, r_hi = int(lo.min()) if B else 0, int(hi.max()) if B else 0
    if stats is not None:
        steps = (hi - lo).clamp_min(0)
        stats["bundle_steps"] = stats.get("bundle_steps", 0) + int(steps.sum())
        stats["bundle_steps_window"] = stats.get("bundle_steps_window", 0) + steps
    for r in range(max(r_lo, 0), r_hi):
        v = rank_to_node[:, r].long()
        process = (r >= lo) & (r < hi)
        tails_v = in_nbr[b, v].long()  # [B, P]
        w_v = in_w[b, v]
        sc_t = torch.gather(scores, 1, tails_v)
        ok = ar_p < indeg[b, v].long()[:, None]
        if skip_invalid:
            ok = ok & (sc_t != -1)
        has = ok.any(dim=1)
        # lexicographic (weight, tail score) maximum, the LAST maximal slot
        mw = torch.where(ok, w_v, NEG).amax(dim=1)
        c2 = ok & (w_v == mw[:, None])
        ms = torch.where(c2, sc_t, NEG).amax(dim=1)
        c3 = c2 & (sc_t == ms[:, None])
        last = (P - 1) - torch.argmax(c3.flip(1).to(torch.int32), dim=1)
        new_sc = torch.where(has, mw + ms, -1).to(torch.int32)
        new_pred = torch.where(has, tails_v[b, last], -1).to(torch.int32)
        at = torch.where(process, v, N)
        scores[b, at] = new_sc
        preds[b, at] = new_pred
        # the running first strict maximum (scores[maxn] < scores[v] replaces)
        take = process & ((maxn == -1) | (maxsc < new_sc))
        maxn = torch.where(take, v, maxn)
        maxsc = torch.where(take, new_sc, maxsc)
    return maxn


def _heaviest_bundle_plain(in_nbr, in_w, indeg, out_nbr, out_deg, rank_of, rank_to_node, n_nodes,
                           max_branch_iters: int = 64, stats: Optional[dict] = None):
    """Plain version of G6: the JAX program's batched machine. `stats`, a
    dict, gets `bundle_steps` (ranks processed, every pass of every window),
    `bundle_steps_window` (the same [B], a window at a time) and
    `branch_passes` (branch-completion passes, summed over windows)."""
    B, N, P = in_nbr.shape
    Q = out_nbr.shape[2]
    dev = in_nbr.device
    b = _ar(B, dev)
    in_nbr, out_nbr = in_nbr.long(), out_nbr.long()
    indeg, out_deg, rank_of = indeg.long(), out_deg.long(), rank_of.long()
    in_w = in_w.to(torch.int32)
    scores = torch.full((B, N + 1), -1, dtype=torch.int32, device=dev)
    preds = torch.full((B, N + 1), -1, dtype=torch.int32, device=dev)
    nonempty = n_nodes.long() > 0
    args = (in_nbr, in_w, indeg, rank_to_node, n_nodes)
    maxn = _bundle_scan(scores, preds, *args, torch.full((B,), -1, device=dev), False, nonempty,
                        stats)
    maxn = torch.where(nonempty, maxn, 0)

    # branch completion while the running maximum still has out-edges
    active = nonempty & (out_deg[b, maxn] > 0)
    ar_p, ar_q = _ar(P, dev), _ar(Q, dev)
    passes = 0
    for _ in range(max_branch_iters):
        if not bool(active.any()):
            break
        passes += int(active.sum())
        # rival tails: the in-slot tails (other than maxn) of maxn's out-heads
        heads_q = out_nbr[b, maxn]  # [B, Q]
        q_ok = ar_q[None, :] < out_deg[b, maxn][:, None]
        rival = in_nbr[b[:, None], heads_q]  # [B, Q, P]
        r_ok = (q_ok[:, :, None] & (ar_p[None, None, :] < indeg[b[:, None], heads_q][:, :, None])
                & (rival != maxn[:, None, None]) & active[:, None, None])
        scores.scatter_(1, torch.where(r_ok, rival, N).reshape(B, Q * P), -1)
        new_maxn = _bundle_scan(scores, preds, *args, rank_of[b, maxn], True, active, stats)
        found = new_maxn >= 0
        maxn = torch.where(active & found, new_maxn, maxn)
        active = active & found & (out_deg[b, maxn] > 0)
    if stats is not None:
        stats["branch_passes"] = stats.get("branch_passes", 0) + passes

    # the backward walk: push maxn, follow preds until -1, then reverse
    buf = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    cur, act = maxn, nonempty
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    preds = preds.long()
    for _ in range(walk_steps(N)):
        if not bool(act.any()):
            break
        buf[b, torch.where(act, k.clamp_max(N - 1), N)] = cur
        k = k + act.long()
        nxt = preds[b, cur]
        act = act & (nxt >= 0)
        cur = torch.where(act, nxt, cur)
    idx = _ar(N, dev)[None, :]
    cons = torch.gather(buf, 1, (k[:, None] - 1 - idx).clamp(0, N - 1))
    cons = torch.where(idx < k[:, None], cons, 0)
    return cons.to(torch.int32), k.to(torch.int32), active


_BUNDLE_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_INTS3 = ctypes.c_int * 3
# shared memory a block can opt into on Hopper (227 KB), less the kernel's
# static word (csrc/graph_consensus.cu:kStaticBytes)
SMEM_ROOM = 232448 - 16
# the forms of a G6 launch (_build.BUILD_FORMS): every window's ranks
# staged, or each window staged where its ranks fit (bundle_rank_cap)
FORMS = ("shared", "by window")


def _lib():
    lib = _build.get_lib("graph_consensus")
    if lib.graph_bundle_launch.argtypes is None:
        for fn, args in ((lib.graph_bundle_launch, _BUNDLE_ARGS),
                         (lib.graph_bundle_smem, [ctypes.c_int, ctypes.c_int, _INTS3]),
                         (lib.graph_consensus_attrs, [_INTS3])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def kernel_attrs() -> dict:
    """Registers a thread, static shared memory and local memory (spills)
    of G6, as the card's loader reports them."""
    out = _INTS3()
    _build.check(_lib(), _lib().graph_consensus_attrs(out), "graph_consensus_attrs")
    return dict(registers=out[0], static_smem_bytes=out[1], local_bytes=out[2])


def bundle_smem_bytes(N: int, P: int, cap: int) -> int:
    """G6's dynamic shared memory with `cap` ranks staged
    (csrc/graph_consensus.cu:bundle_smem_bytes): the scores and
    predecessors [N] int32, a staged rank's node and slot count in a word,
    its weights int32 [P] and tails uint16 [P] (rounded up to a word)."""
    return 8 * N + 4 * cap * (1 + P) + ((2 * cap * P + 3) & ~3)


def bundle_rank_cap(N: int, P: int) -> int:
    """The ranks G6 stages (bundle_rank_cap): a window of n = min(n_nodes,
    N) ranks stages them in rank order where n is at most this, N or as
    many as a block's shared memory holds beside the scores and
    predecessors; a larger window reads its rows where they lie."""
    return max(0, min(N, (SMEM_ROOM - 8 * N - 3) // (6 * P + 4)))


def bundle_staged(n_nodes, N: int, P: int):
    """[B] bool: True where G6 stages the window's ranks in shared memory,
    False where it reads them where they lie."""
    return n_nodes.long().clamp_max(N) <= bundle_rank_cap(N, P)


def bundle_smem(N: int, P: int) -> tuple:
    """(rank capacity, dynamic shared memory in bytes) of a G6 launch at
    (N, P), as the library computes them: `bundle_rank_cap` and
    `bundle_smem_bytes` are their mirror."""
    out = _INTS3()
    _lib().graph_bundle_smem(N, P, out)
    return out[0], out[1]


def heaviest_bundle(in_nbr, in_w, indeg, out_nbr, out_deg, rank_of, rank_to_node, n_nodes,
                    max_branch_iters: int = 64, check=True):
    """TraverseHeaviestBundle, the BranchCompletion loop and the backward
    walk (graph.cpp:534-638; csrc/poagraph.cpp:379-443). in_nbr/in_w
    [B, N, P] (in-edge tails and weights, slot order), indeg [B, N], out_nbr
    [B, N, Q], out_deg [B, N], rank_of/rank_to_node [B, N] (a topological
    order), n_nodes [B] (at most N). Returns (cons [B, N] consensus node ids
    left-packed in path order, cons_len [B], overflow [B] bool: branch
    completion hit `max_branch_iters`). CPU tensors run the plain machine;
    CUDA tensors launch G6 or raise. With `check` the inputs are made int32
    and contiguous and checked; `device_linear` passes False for its own
    buffers, which are so already: G6 is launched on them as they are."""
    B, N, P = in_nbr.shape
    Q = out_nbr.shape[2]
    dev = in_nbr.device
    if not _on_card(dev):
        return _heaviest_bundle_plain(in_nbr, in_w, indeg, out_nbr, out_deg, rank_of,
                                      rank_to_node, n_nodes, max_branch_iters)
    if P > 32 or Q > 32 or N > N_MAX:
        raise ValueError(f"G6 takes P, Q <= 32 and N <= {N_MAX}, got P={P}, Q={Q}, N={N}")
    args = (in_nbr, in_w, indeg, out_nbr, out_deg, rank_of, rank_to_node, n_nodes)
    if check:
        names = ("in_nbr", "in_w", "indeg", "out_nbr", "out_deg", "rank_of", "rank_to_node",
                 "n_nodes")
        args = [_int32(t) for t in args]
        _check_inputs(dict(zip(names, args)), torch.int32, dev)
        if (in_w.shape != (B, N, P) or out_nbr.shape[:2] != (B, N) or n_nodes.shape != (B,)
                or any(t.shape != (B, N) for t in (indeg, out_deg, rank_of, rank_to_node))):
            raise ValueError("G6 takes in_nbr and in_w [B, N, P], out_nbr [B, N, Q], indeg, "
                             "out_deg, rank_of and rank_to_node [B, N], n_nodes [B]")
    out = torch.empty((B * N + 2 * B,), dtype=torch.int32, device=dev)
    cons = out[: B * N].view(B, N)
    cons_len, overflow = out[B * N :].view(2, B)
    if B:
        launch_bundle(*args, cons, cons_len, overflow, max_branch_iters)
    return cons, cons_len, overflow != 0


def launch_bundle(in_nbr, in_w, indeg, out_nbr, out_deg, rank_of, rank_to_node, n_nodes, cons,
                  cons_len, overflow, max_branch_iters: int = 64):
    """G6 alone, on the int32 buffers of `heaviest_bundle`, all on the card;
    `chip_smoke.py` times it apart from that glue. The kernel writes every
    element of its outputs."""
    B, N, P = in_nbr.shape
    Q = out_nbr.shape[2]
    dev = in_nbr.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _build.on_device(dev):
        rc = _lib().graph_bundle_launch(
            in_nbr.data_ptr(), in_w.data_ptr(), indeg.data_ptr(), out_nbr.data_ptr(),
            out_deg.data_ptr(), rank_of.data_ptr(), rank_to_node.data_ptr(), n_nodes.data_ptr(),
            cons.data_ptr(), cons_len.data_ptr(), overflow.data_ptr(), B, N, P, Q,
            max_branch_iters, walk_steps(N), stream)
    _build.check(_lib(), rc, "graph_bundle")
    _build.LAUNCHES["graph_bundle"] += 1
    _build.BUILD_FORMS[("graph_bundle", N, FORMS[bundle_rank_cap(N, P) < N])] += 1


# ---------------------------------------------------------------- coverage


def consensus_coverage(cons, cons_len, tails, heads, valid, lab_lo, lab_hi, aligned, acount):
    """Coverage by consensus position [B, N] (graph.cpp:461-485): each
    node's count of distinct sequences on its in- and out-edges (the OR of
    the edges' 64-bit labels lab_lo/lab_hi [B, E], as bit counts over the
    incident edges) plus the counts of its aligned ring members, summed; 0
    past cons_len. Ring ids are clamped into the table as JAX's gathers
    clamp (they are node ids below N in every unflagged window)."""
    B, E = tails.shape
    N, R = aligned.shape[1], aligned.shape[2]
    dev = tails.device
    ar32 = _ar(32, dev).to(torch.int32)[None, None, :]
    ebits = torch.cat([(lab_lo.to(torch.int32)[:, :, None] >> ar32) & 1,
                       (lab_hi.to(torch.int32)[:, :, None] >> ar32) & 1], dim=2)
    ebits = torch.where(valid[:, :, None], ebits, 0).reshape(B * E, 64)
    # the sequences of every node's incident edges, counted bit by bit
    counts = torch.zeros((B * (N + 1), 64), dtype=torch.int32, device=dev)
    base = _ar(B, dev)[:, None] * (N + 1)
    for ends in (tails, heads):
        at = base + torch.where(valid, ends.long(), N)
        counts.index_add_(0, at.reshape(-1), ebits)
    node_cov = (counts.view(B, N + 1, 64)[:, :N] > 0).sum(dim=2)  # [B, N]
    ring = aligned.long().clamp(0, N - 1).reshape(B, N * R)
    ring_cov = torch.gather(node_cov, 1, ring).view(B, N, R)
    ring_on = _ar(R, dev)[None, None, :] < acount.long()[:, :, None]
    total = node_cov + torch.where(ring_on, ring_cov, 0).sum(dim=2)
    cov = torch.gather(total, 1, cons.long())
    return torch.where(_ar(N, dev)[None, :] < cons_len.long()[:, None], cov, 0).to(torch.int32)


# ------------------------------------------------------------ trim + emit


def trim_consensus(cons_codes, cons_len, cov, avg_cov, do_trim):
    """The kTGS end trim (src/window.cpp:141-171): keep the consensus from
    the first to the last position with coverage >= avg_cov [B] where
    do_trim [B]; no such position, or begin >= end, keeps it whole (a
    possible chimera). Returns (out [B, N] codes left-packed, out_len [B])."""
    B, N = cons_codes.shape
    dev = cons_codes.device
    idx = _ar(N, dev)[None, :]
    cons_len = cons_len.long()
    ok = (idx < cons_len[:, None]) & (cov.long() >= avg_cov.long()[:, None])
    any_ok = ok.any(dim=1)
    okw = ok.to(torch.int32)
    begin = torch.where(any_ok, torch.argmax(okw, dim=1), cons_len)
    end = torch.where(any_ok, (N - 1) - torch.argmax(okw.flip(1), dim=1), -1)
    do_slice = do_trim.bool() & (begin < end)
    b0 = torch.where(do_slice, begin, 0)
    out_len = torch.where(do_slice, end - begin + 1, cons_len)
    out = torch.gather(cons_codes.long(), 1, (b0[:, None] + idx).clamp(0, N - 1))
    out = torch.where(idx < out_len[:, None], out, 0)
    return out.to(torch.int32), out_len.to(torch.int32)


# ------------------------------------------------------------ full program


def device_linear(bb_codes, bb_w, bb_len, lseqs, lw, llen, lbegin, lend, lfull, n_layers, do_trim,
                  n_cap: int, e_cap: int, r_cap: int, m: int, x: int, g: int, p_cap: int = 16):
    """Round 2's window consensus of a window batch on the tensors' device
    (src/window.cpp:74-174): the incremental build with edge labels
    (`device_build`), the weighted in-slots and the out-slots, the bundled
    topological order (G3), the heaviest bundle with branch completion (G6),
    coverage, the codes along the consensus and the kTGS trim. Arguments as
    `device_build`'s, plus do_trim [B] bool (trim and a kTGS window).

    Returns (out [B, n_cap] int32 codes left-packed, out_len [B], overflow
    [B] int32 bits: the build's `BUILD_OVF_BITS`, `OVF_SLOTS` and
    `OVF_BRANCH`; any bit: the host route). A window the build flags is
    seen by the slots, G3 and G6 without edges or nodes, and one past the
    slot caps without nodes, so that no kernel reads a graph that is not
    valid; its result is thrown away (JAX computes it and throws it away)."""
    built = device_build(bb_codes, bb_w, bb_len, lseqs, lw, llen, lbegin, lend, lfull, n_layers,
                         n_cap, e_cap, r_cap, m, x, g, p_cap=p_cap, track_labels=True)
    dev = bb_codes.device
    bad = built["overflow"]
    valid = _ar(e_cap, dev)[None, :] < torch.where(bad, 0, built["n_edges"]).long()[:, None]
    tails, heads = built["tails"], built["heads"]
    in_nbr, in_w, indeg, ovf_in = build_in_slots_weighted(tails, heads, built["weights"], valid,
                                                          n_cap, p_cap)
    out_nbr, out_deg, ovf_out = build_out_slots(tails, heads, valid, n_cap, p_cap)
    slots = ovf_in | ovf_out
    n_nodes = torch.where(bad | slots, 0, built["n_nodes"].clamp_max(n_cap))
    rank_of, rank_to_node = topo_ranks_bundled(in_nbr, indeg, built["aligned"], built["acount"],
                                               n_nodes, check=False)
    cons, cons_len, branch = heaviest_bundle(in_nbr, in_w, indeg, out_nbr, out_deg, rank_of,
                                             rank_to_node, n_nodes, check=False)
    cov = consensus_coverage(cons, cons_len, tails, heads, valid, built["lab_lo"],
                             built["lab_hi"], built["aligned"], built["acount"])
    cons_codes = torch.gather(built["codes"].long(), 1, cons.long())
    avg_cov = n_layers.long() // 2  # (n_sequences - 1) / 2, the backbone one of them
    out, out_len = trim_consensus(cons_codes, cons_len, cov, avg_cov, do_trim)
    overflow = (built["overflow_bits"] | torch.where(slots, OVF_SLOTS, 0)
                | torch.where(branch, OVF_BRANCH, 0))
    return out, out_len, overflow.to(torch.int32)
