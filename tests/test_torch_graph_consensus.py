"""The port's device round-2 consensus
(`vechat_tpu_torch/ops/kernels/graph_consensus.py`,
`pipeline/device_cycle.run_device_linear`) against the JAX package's
(`vechat_tpu/ops/kernels/graph_consensus.py`) on the same numpy inputs, on
the CPU, exact equality (integer arrays): the weighted in-slots and the
out-slots, `heaviest_bundle` (on built graphs, random DAGs and hand-made
graphs that force its tie, maximum and branch-completion rules, and against
the host oracle), `consensus_coverage`, `trim_consensus` and
`device_linear`; a numpy model of G6's warp steps against the plain
machine; and `run_device_linear` and `generate_consensus_linear` with
VECHAT_DEVICE_LINEAR=1 against the JAX package's host path and its own
device program. A window flagged for overflow is compared by its flag
alone: its result is thrown away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.graph_build_cases import chain_bundle_windows
from tests.test_graph_consensus import _DevBackend, _mk_window, _oracle_build
from tests.test_torch_graph_build import BUILD_ARGS, J_TOPO, _cases, _pack
from tests.test_torch_graph_cycle import (
    _ballot,
    _clz,
    _eq,
    _np,
    _pipeline_windows,
    _random_graphs,
    _windows_of,
)
from vechat_tpu.ops.encode import encode
from vechat_tpu.ops.kernels import graph_build as jgb
from vechat_tpu.ops.kernels import graph_consensus as jgc
from vechat_tpu.ops.kernels.graph_cycle import graph_to_edges
from vechat_tpu_torch.ops.kernels import graph_consensus as tgc
from vechat_tpu_torch.ops.kernels import graph_cycle as tcy

N, E, R, P = 128, 256, 8, 16
# the JAX parts, each compiled once for the shapes of this file
J_IN = jax.jit(jgc.build_in_slots_weighted, static_argnums=(4, 5))
J_OUT = jax.jit(jgc.build_out_slots, static_argnums=(3, 4))
J_BUNDLE = jax.jit(jgc.heaviest_bundle, static_argnames=("max_branch_iters",))
J_COVERAGE = jax.jit(jgc.consensus_coverage)
J_TRIM = jax.jit(jgc.trim_consensus)
INT_MIN = -(2**31)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _slots_both(tails, heads, weights, n_edges, cap=P):
    """Both packages' in- and out-slots of the edge lists, held equal;
    returns the numpy arrays (in_nbr, in_w, indeg, out_nbr, out_deg) and the
    two overflow flags."""
    valid = np.arange(tails.shape[1])[None, :] < np.asarray(n_edges)[:, None]
    j_in = J_IN(jnp.asarray(tails), jnp.asarray(heads), jnp.asarray(weights), jnp.asarray(valid),
                N, cap)
    j_out = J_OUT(jnp.asarray(tails), jnp.asarray(heads), jnp.asarray(valid), N, cap)
    t_in = tgc.build_in_slots_weighted(*_t(tails, heads, weights, valid), N, cap)
    t_out = tgc.build_out_slots(*_t(tails, heads, valid), N, cap)
    for j, t in zip((*j_in, *j_out), (*t_in, *t_out)):
        _eq(j, t)
    j = [np.asarray(a) for a in (*j_in, *j_out)]
    return j[0], j[1], j[2], j[4], j[5], j[3], j[6]


def _bundle_both(args, max_branch_iters=64):
    """JAX's and the port's heaviest_bundle on numpy args, held equal;
    returns JAX's (cons, cons_len, overflow)."""
    want = J_BUNDLE(*map(jnp.asarray, args), max_branch_iters=max_branch_iters)
    got = tgc.heaviest_bundle(*_t(*args), max_branch_iters=max_branch_iters)
    for w, g in zip(want, got):
        _eq(w, g)
    assert got[2].dtype == torch.bool
    return [np.asarray(w) for w in want]


# ------------------------------------------------ built graphs with labels


@pytest.fixture(scope="module")
def built():
    """tests/test_torch_graph_build.py's eight windows built by the JAX
    package with edge labels at seeded weights, with their slots and
    bundled topological ranks."""
    arrays = _pack(_cases(), weighted=True)
    j = jgb.device_build(*(jnp.asarray(arrays[k]) for k in BUILD_ARGS), N, E, R, 3, -5, -4,
                         track_labels=True)
    j = {k: np.asarray(v) for k, v in j.items()}
    assert not j["overflow"].any()
    in_nbr, in_w, indeg, out_nbr, out_deg, ovf_in, ovf_out = _slots_both(
        j["tails"], j["heads"], j["weights"], j["n_edges"])
    assert not ovf_in.any() and not ovf_out.any()
    rank_of, r2n = (np.asarray(a) for a in J_TOPO(jnp.asarray(in_nbr), jnp.asarray(indeg),
                                                   jnp.asarray(j["aligned"]),
                                                   jnp.asarray(j["acount"]),
                                                   jnp.asarray(j["n_nodes"])))
    bundle = [in_nbr, in_w, indeg, out_nbr, out_deg, rank_of, r2n, j["n_nodes"]]
    return arrays, j, bundle


@pytest.mark.parametrize("cap", [P, 2])
def test_weighted_in_slots_and_out_slots_equal_jax(built, cap):
    """Slot order, weights beside their tails, degrees and the overflow
    flags (in-degree or out-degree past the cap) equal JAX's."""
    _, j, _ = built
    out = _slots_both(j["tails"], j["heads"], j["weights"], j["n_edges"], cap)
    if cap == 2:
        assert out[5].any() and out[6].any() and not out[5].all()


def test_heaviest_bundle_on_built_graphs_equals_jax(built):
    _, j, bundle = built
    cons, k, ovf = _bundle_both(bundle)
    assert (k > 0).all() and not ovf.any()
    assert (k <= j["n_nodes"]).all()


@pytest.mark.parametrize("seed", range(4))
def test_heaviest_bundle_equals_the_host_oracle(seed):
    """tests/test_graph_consensus.py's oracle graphs, in the host engine's
    own topological order: the port's path is the host's consensus."""
    rng = np.random.default_rng(seed)
    from tests.test_graph_consensus import _noisy

    base = "".join(rng.choice(list("ACGT"), size=40))
    bb = encode(_noisy(rng, base))
    g = _oracle_build(bb, [encode(_noisy(rng, base)) for _ in range(5)])
    ed = graph_to_edges(g, N, E)
    valid = np.arange(E)[None, :] < ed["n_edges"]
    in_nbr, in_w, indeg, ovf = tgc.build_in_slots_weighted(
        *_t(ed["tails"][None], ed["heads"][None], ed["weights"][None], valid), N, P)
    out_nbr, out_deg, ovf2 = tgc.build_out_slots(*_t(ed["tails"][None], ed["heads"][None], valid),
                                                 N, P)
    assert not ovf.any() and not ovf2.any()
    rank_of = np.zeros((1, N), np.int32)
    r2n = np.zeros((1, N), np.int32)
    for i, v in enumerate(g.rank_to_node):
        rank_of[0, v], r2n[0, i] = i, v
    cons, k, ovf3 = tgc.heaviest_bundle(in_nbr, in_w, indeg, out_nbr, out_deg, *_t(rank_of, r2n),
                                        torch.tensor([g.num_nodes()], dtype=torch.int32))
    assert not bool(ovf3[0])
    g.generate_consensus()
    assert list(_np(cons[0, : int(k[0])])) == list(g.consensus)


# ------------------------------------------------------- hand-made graphs


def _edge_batch(graphs):
    """Graphs [(n, [(tail, head, weight), ...])] with ids in topological
    order as one batch at N, E: (tails, heads, weights, n_edges, n_nodes),
    and identity ranks."""
    B = len(graphs)
    tails, heads, weights = (np.zeros((B, E), np.int32) for _ in range(3))
    n_edges = np.array([len(es) for _, es in graphs], np.int32)
    n_nodes = np.array([n for n, _ in graphs], np.int32)
    for b, (_, es) in enumerate(graphs):
        for i, (t, h, w) in enumerate(es):
            tails[b, i], heads[b, i], weights[b, i] = t, h, w
    ranks = np.tile(np.arange(N, dtype=np.int32), (B, 1))
    return tails, heads, weights, n_edges, n_nodes, ranks


# name -> (graph, its consensus at the default cap, the fewest passes that
# do not flag it)
HAND = {
    # two sources into one node at equal weight (both tails score -1): the
    # full tie goes to the LAST slot
    "full_tie": ((3, [(0, 2, 5), (1, 2, 5)]), [1, 2], 0),
    # two sinks at equal scores: the FIRST strict maximum in rank order
    "first_max": ((3, [(0, 1, 3), (0, 2, 3)]), [0, 1], 0),
    # the heavier edge wins over the higher tail score; the maximum node 1
    # keeps an out-edge, so one branch-completion pass
    "weight_first": ((4, [(0, 1, 9), (1, 3, 1), (2, 3, 4)]), [0, 1, 3], 1),
    # a zero-weight step past the maximum: one pass, the rival tail 2 of
    # node 3 invalidated and skipped
    "one_pass": ((4, [(0, 1, 10), (1, 3, 0), (2, 3, 0)]), [0, 1, 3], 1),
    # a chain of zero weights: three passes
    "three_passes": ((5, [(0, 1, 10), (1, 2, 0), (2, 3, 0), (3, 4, 0)]), [0, 1, 2, 3, 4], 3),
    # a rival with its own positive score, invalidated
    "rival": ((5, [(0, 1, 10), (0, 2, 3), (1, 3, 0), (2, 3, 0), (2, 4, 7)]), [0, 1, 3], 1),
    "empty": ((0, []), [], 0),
    "single": ((1, []), [0], 0),
}


@pytest.fixture(scope="module")
def hand():
    tails, heads, weights, n_edges, n_nodes, ranks = _edge_batch([g for g, _, _ in HAND.values()])
    in_nbr, in_w, indeg, out_nbr, out_deg, _, _ = _slots_both(tails, heads, weights, n_edges)
    return [in_nbr, in_w, indeg, out_nbr, out_deg, ranks, ranks, n_nodes]


def test_heaviest_bundle_rules_on_hand_made_graphs(hand):
    """The tie, maximum and branch-completion rules: JAX's path, the port's,
    and the one written out above."""
    cons, k, ovf = _bundle_both(hand)
    assert not ovf.any()
    for b, (_, want, _) in enumerate(HAND.values()):
        assert list(cons[b, : k[b]]) == want, list(HAND)[b]


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_heaviest_bundle_flags_the_branch_cap_alike(hand, cap):
    """max_branch_iters of 1, 2 and 3: a window that needs more passes is
    flagged, in both packages alike."""
    _, _, ovf = _bundle_both(hand, cap)
    _eq(ovf, [passes > cap for _, _, passes in HAND.values()])


def test_heaviest_bundle_on_random_dags_equals_jax():
    """Random DAGs with weights 0-3 (ties everywhere), in-slots whole and
    cut to 2, ranked by G2's plain machine."""
    rng = np.random.default_rng(41)
    for cap in (P, 2):
        args = _random_bundle_args(rng, cap)
        _bundle_both(args)


def _random_bundle_args(rng, cap, n_full=False):
    """Random DAGs (`_random_graphs`) with weights 0-3, in-slots of cap,
    ranked by G2's plain machine; with `n_full`, every window of N nodes
    (those past its graph isolated)."""
    tails, heads, n_nodes, n_edges = _random_graphs(rng, 8, N, E)
    if n_full:
        n_nodes[:] = N
    tails, heads = tails.astype(np.int32), heads.astype(np.int32)
    weights = rng.integers(0, 4, size=(8, E)).astype(np.int32)
    valid = np.arange(E)[None, :] < n_edges[:, None]
    in_nbr, in_w, indeg, _ = tgc.build_in_slots_weighted(*_t(tails, heads, weights, valid), N, cap)
    out_nbr, out_deg, _ = tgc.build_out_slots(*_t(tails, heads, valid), N, cap)
    rank_of, r2n = tcy.topo_ranks(in_nbr, indeg, torch.from_numpy(n_nodes))
    return [_np(a) for a in (in_nbr, in_w, indeg, out_nbr, out_deg, rank_of, r2n)] + [
        n_nodes.astype(np.int32)]


# ------------------------------------------------------ coverage and trim


def test_consensus_coverage_equals_jax(built):
    """Coverage along the consensus, and along every node in id order (each
    ring member's count added to its own), equal to JAX's."""
    _, j, bundle = built
    cons, k, _ = _bundle_both(bundle)
    valid = np.arange(E)[None, :] < j["n_edges"][:, None]
    B = len(k)
    every = np.tile(np.arange(N, dtype=np.int32), (B, 1))
    on_ring = 0
    for c, n in ((cons, k), (every, j["n_nodes"])):
        args = [c, n, j["tails"], j["heads"], valid, j["lab_lo"], j["lab_hi"], j["aligned"],
                j["acount"]]
        want = J_COVERAGE(*map(jnp.asarray, args))
        got = tgc.consensus_coverage(*_t(*args))
        _eq(want, got)
        ids = np.arange(N)[None, :] < n[:, None]
        on_ring += int((np.take_along_axis(j["acount"], c, axis=1)[ids] > 0).sum())
        assert (np.asarray(want)[ids] > 0).all()
    assert on_ring > 0, "no ring member was counted"


def test_trim_consensus_equals_jax():
    """Random coverages, with rows where no position reaches the average,
    where only one does (begin == end), where the consensus is empty and
    where the trim is off: equal to JAX's; those rows keep the whole
    consensus."""
    rng = np.random.default_rng(8)
    B = 16
    codes = rng.integers(0, 5, size=(B, N)).astype(np.int32)
    cons_len = rng.integers(1, N + 1, size=B).astype(np.int32)
    cov = rng.integers(0, 7, size=(B, N)).astype(np.int32)
    avg = rng.integers(1, 6, size=B).astype(np.int32)
    do_trim = np.ones(B, bool)
    cov[0] = 0  # none reaches the average
    cov[1] = 0
    cov[1, 5] = avg[1]  # one position: begin == end
    cons_len[2] = 0
    do_trim[3] = False
    args = [codes, cons_len, cov, avg, do_trim]
    want = J_TRIM(*map(jnp.asarray, args))
    got = tgc.trim_consensus(*_t(*args))
    for w, g in zip(want, got):
        _eq(w, g)
    out_len = np.asarray(want[1])
    _eq(out_len[:4], cons_len[:4])
    assert (out_len[4:] < cons_len[4:]).any()


# ---------------------------------------------------------- the program


def _linear_both(arrays, do_trim):
    args = [arrays[k] for k in BUILD_ARGS] + [do_trim]
    want = jgc.device_linear(*map(jnp.asarray, args), N, E, R, 3, -5, -4, p_cap=P)
    got = tgc.device_linear(*_t(*args), N, E, R, 3, -5, -4, p_cap=P)
    out, out_len, ovf = (np.asarray(w) for w in want)
    bits = _np(got[2])
    _eq(ovf, bits != 0)
    ok = ~ovf
    _eq(out_len[ok], got[1][ok])
    _eq(out[ok], _np(got[0])[ok])
    return out_len, bits


def test_device_linear_equals_jax():
    """The eight windows at seeded weights, the trim on every other one."""
    arrays = _pack(_cases(), weighted=True)
    do_trim = np.arange(len(arrays["bb_len"])) % 2 == 0
    out_len, bits = _linear_both(arrays, do_trim)
    assert not bits.any() and (out_len > 0).all()


def test_g3_callers_pass_their_int32_buffers_as_they_are(monkeypatch):
    """Both builds call G3 without its checks: every argument they give it
    is an int32 contiguous tensor, as the kernel takes it."""
    from vechat_tpu_torch.ops.kernels import graph_build as tgb

    calls = []

    def spy(original):
        def g3(*args, check=True):
            calls.append(check)
            if not check:
                assert all(a.dtype == torch.int32 and a.is_contiguous() for a in args)
            return original(*args, check=check)

        return g3

    monkeypatch.setattr(tgb, "topo_ranks_bundled", spy(tgb.topo_ranks_bundled))
    monkeypatch.setattr(tgc, "topo_ranks_bundled", spy(tgc.topo_ranks_bundled))
    arrays = _pack(_cases()[:2], weighted=True)
    tgc.device_linear(*_t(*[arrays[k] for k in BUILD_ARGS], np.ones(2, bool)), N, E, R, 3, -5,
                      -4, p_cap=P)
    assert len(calls) > 2 and not any(calls)


def _spied(monkeypatch, module, name, made):
    """Wrap module.name so that its outputs are kept in made[name]."""
    real = getattr(module, name)

    def spy(*args, **kw):
        made[name] = real(*args, **kw)
        return made[name]

    monkeypatch.setattr(module, name, spy)


def test_g2_caller_passes_its_int32_buffers_as_they_are(monkeypatch):
    """The prune cycle calls G2 without its checks, on the very tensors it
    made: `build_in_slots`' table and in-degrees and the n_sub of G1 (int32
    on the card, as here), no copy."""
    made, calls = {}, []
    _spied(monkeypatch, tcy, "build_in_slots", made)
    real_dfs, real_topo = tcy.dfs_preorder, tcy.topo_ranks

    def g1(*args, **kw):  # G1's outputs as the card gives them: int32
        made["g1"] = tuple(t.to(torch.int32) for t in real_dfs(*args, **kw))
        return made["g1"]

    def g2(in_nbr, indeg, n_sub, check=True):
        calls.append(check)
        mine = (made["build_in_slots"][0], made["build_in_slots"][1], made["g1"][2])
        assert all(a is b for a, b in zip((in_nbr, indeg, n_sub), mine))
        assert all(t.dtype == torch.int32 and t.is_contiguous() for t in mine)
        return real_topo(in_nbr, indeg, n_sub, check=check)

    monkeypatch.setattr(tcy, "dfs_preorder", g1)
    monkeypatch.setattr(tcy, "topo_ranks", g2)
    rng = np.random.default_rng(5)
    tails, heads, n_nodes, n_edges = _random_graphs(rng, 4, N, E)
    valid = np.arange(E)[None, :] < n_edges[:, None]
    weights = rng.integers(1, 6, size=(4, E))
    codes = rng.integers(0, 4, size=(4, N))
    st = tcy.prune_and_rebuild(*_t(tails, heads, weights, valid, codes, n_nodes),
                               torch.full((4,), 2.0), 0.2, 0.2, N, 32, P)
    assert calls == [False] and int(st["n_sub"].sum()) > 0


def test_g6_caller_passes_its_int32_buffers_as_they_are(monkeypatch):
    """`device_linear` calls G6 without its checks, on the very tensors it
    made: the weighted in-slots, the out-slots, G3's ranks and n_nodes,
    int32 and contiguous, no copy."""
    made, calls = {}, []
    for name in ("build_in_slots_weighted", "build_out_slots"):
        _spied(monkeypatch, tgc, name, made)
    real_g3, real = tgc.topo_ranks_bundled, tgc.heaviest_bundle

    def g3(*args, **kw):  # G3's outputs as the card gives them: int32
        made["topo_ranks_bundled"] = tuple(t.to(torch.int32) for t in real_g3(*args, **kw))
        return made["topo_ranks_bundled"]

    def g6(*args, max_branch_iters=64, check=True):
        calls.append(check)
        (in_nbr, in_w, indeg, _), (out_nbr, out_deg, _) = (made["build_in_slots_weighted"],
                                                          made["build_out_slots"])
        mine = (in_nbr, in_w, indeg, out_nbr, out_deg, *made["topo_ranks_bundled"])
        assert all(a is b for a, b in zip(args, mine))
        assert all(t.dtype == torch.int32 and t.is_contiguous() for t in args)
        return real(*args, max_branch_iters=max_branch_iters, check=check)

    monkeypatch.setattr(tgc, "topo_ranks_bundled", g3)
    monkeypatch.setattr(tgc, "heaviest_bundle", g6)
    arrays = _pack(_cases()[:2], weighted=True)
    out = tgc.device_linear(*_t(*[arrays[k] for k in BUILD_ARGS], np.ones(2, bool)), N, E, R, 3,
                            -5, -4, p_cap=P)
    assert calls == [False] and (out[1] > 0).all()


def _long_window(seed):
    """A backbone of ~88 bases with 7 full-span layers: its graph grows past
    N = 128 nodes."""
    from tests.test_graph_build import _noisy
    from tests.test_torch_graph_build import W, _layers

    rng = np.random.default_rng(seed)
    while True:
        base = "".join(rng.choice(list("ACGT"), size=88))
        bb = encode(_noisy(rng, base))
        layers = _layers(rng, base, bb, 7, partial=False)
        if len(bb) <= W and all(len(c) <= W for c, *_ in layers):
            return bb, layers


def test_device_linear_flags_capacities_alike():
    """Five of the windows and three long ones, at the shapes of the test
    above: the same windows flagged (nodes past N), the others equal."""
    arrays = _pack(_cases()[:5] + [_long_window(s) for s in (1, 2, 3)], weighted=True)
    _, bits = _linear_both(arrays, np.ones(len(arrays["bb_len"]), bool))
    assert (bits != 0).any() and not (bits[:5] != 0).any()
    assert (bits[bits != 0] & tgc.BUILD_OVF_BITS["n_cap"]).all()


# ------------------------------------------------ numpy model of G6's warp


def _i32(v):
    return (v + 2**31) % 2**32 - 2**31


def g6_warp(in_nbr, in_w, indeg, out_nbr, out_deg, rank_of, r2n, n_nodes, max_iters=64, cap=None,
            rng=None):
    """csrc/graph_consensus.cu:graph_bundle_kernel for one window, step for
    step. The block stages the window's n = min(n_nodes, N) ranks in rank
    order where n <= cap (bundle_rank_cap by default): rank r's node and
    min(indeg, P) packed in a word, its tails (clamped, uint16) and weights;
    else each row is read where it lies (rank_to_node, then the row). A
    pass holds rank r's row and its tails' scores and rank r + 1's row in
    registers; step r first reads rank r + 2's row and rank r + 1's tails'
    scores (and, in a pass without skips, reduces rank r + 1's usable slots
    and weight maximum), side by side with the step's store of rank r's
    node (with `rng`, a lane whose tail is that node sees the old or the
    new value at random: the kernel does not order them), and takes the
    last written (node, score) for a tail that is that node; lanes 0..P-1
    the in-slots, two warp maxima and the last lane of a ballot, the
    stores (every lane's, of the same values). The rival tails of the
    start's out-heads a lane each; the walk into the scores' row, then the
    path reversed."""
    n_cap, p = in_nbr.shape
    q = out_nbr.shape[1]
    cap = tgc.bundle_rank_cap(n_cap, p) if cap is None else cap
    scores = np.full(n_cap, -1, np.int64)
    preds = np.full(n_cap, -1, np.int64)

    def cl(v):
        return min(max(int(v), 0), n_cap - 1)

    def lie(r):
        v = cl(r2n[r])
        t = [cl(in_nbr[v, k]) if k < p else 0 for k in range(32)]
        w = [int(in_w[v, k]) if k < p else 0 for k in range(32)]
        return v, min(int(indeg[v]), p), t, w

    n = min(int(n_nodes), n_cap)
    ranks = n if 0 < n <= cap else 0
    staged = []
    for r in range(ranks):
        v, d, t, w = lie(r)
        word = _i32((d << 16) | v)  # unpacked as the kernel does
        staged.append((word & 0xFFFF, word >> 16, [int(np.uint16(x)) for x in t], w))

    def row(r):
        return staged[r] if r < ranks else lie(r)

    def weight_max(x, sc, skip):
        """A rank's usable slots, their ballot and their weight maximum."""
        ok = [k < x[1] and (not skip or sc[k] != -1) for k in range(32)]
        return ok, _ballot(ok), max(x[3][k] if ok[k] else INT_MIN for k in range(32))

    def bundle_pass(lo, n, skip):
        r = lo + 1
        if r >= n:
            return -1
        maxn, maxsc = -1, 0
        cur = row(r)
        nxt = row(r + 1) if r + 1 < n else cur
        pre = [int(scores[x]) for x in cur[2]]
        last_v, last_sc = -1, 0
        if not skip:  # no skips: reduced a step ahead, off the chain
            ok, any_ok, mw = weight_max(cur, None, False)
        while r < n:
            after = row(r + 2) if r + 2 < n else nxt
            v, d, t, w = cur
            old = [int(scores[x]) for x in nxt[2]]
            if not skip:
                ahead = weight_max(nxt, None, False)
            sc = [last_sc if t[k] == last_v else pre[k] for k in range(32)]
            if skip:
                ok, any_ok, mw = weight_max(cur, sc, True)
            c2 = [ok[k] and w[k] == mw for k in range(32)]
            ms = max(sc[k] if c2[k] else INT_MIN for k in range(32))
            c3 = _ballot(c2[k] and sc[k] == ms for k in range(32))
            tail = t[31 - _clz(c3) if c3 else 0]
            new_sc = _i32(mw + ms) if any_ok else -1
            scores[v], preds[v] = new_sc, (tail if any_ok else -1)
            nxt_pre = [int(scores[x]) if rng is not None and x == v and rng.random() < 0.5
                       else old[k] for k, x in enumerate(nxt[2])]
            if maxn == -1 or maxsc < new_sc:
                maxn, maxsc = v, new_sc
            last_v, last_sc = v, new_sc
            cur, nxt, pre = nxt, after, nxt_pre
            if not skip:
                ok, any_ok, mw = ahead
            r += 1
        return maxn

    maxn, active = 0, False
    if n > 0:
        maxn = bundle_pass(-1, n, False)
        active = out_deg[maxn] > 0
        it = 0
        while active and it < max_iters:
            for lane in range(min(int(out_deg[maxn]), q)):
                h = cl(out_nbr[maxn, lane])
                for k in range(min(int(indeg[h]), p)):
                    t = cl(in_nbr[h, k])
                    if t != maxn:
                        scores[t] = -1
            found = bundle_pass(int(rank_of[maxn]), n, True)
            if found >= 0:
                maxn = found
            active = found >= 0 and out_deg[maxn] > 0
            it += 1
    k = 0
    if n > 0:
        cur = maxn
        for _ in range(tgc.walk_steps(n_cap)):
            scores[min(k, n_cap - 1)] = cur
            k += 1
            if preds[cur] < 0:
                break
            cur = cl(preds[cur])
    cons = [scores[min(max(k - 1 - i, 0), n_cap - 1)] if i < k else 0 for i in range(n_cap)]
    return np.array(cons), k, active


def _chain_args():
    """`chain_bundle_windows` at this file's N: 8 chains, most of them
    stopped by the 64-pass cap, two with ties of weight and score."""
    return chain_bundle_windows(8, N, 3)


def test_warp_model_of_g6_equals_the_plain_machine(built, hand):
    """Built graphs, hand-made ones at caps 64 and 2 (ties of weight and
    score, an empty window), random DAGs with whole and cut in-slots and
    with n = N, and chains that stop at the 64-pass cap: the model gives
    the plain machine's outputs, window by window, with the window's rows
    staged, read where they lie (a cap of 0) and the window just past its
    cap, and with a lane that reads a score as the step stores it seeing
    either value."""
    rng = np.random.default_rng(77)
    chains = _chain_args()
    cases = [(built[2], 64), (hand, 64), (hand, 2), (_random_bundle_args(rng, P), 64),
             (_random_bundle_args(rng, 2), 64), (_random_bundle_args(rng, P, n_full=True), 64),
             (chains, 64)]
    for args, cap in cases:
        cons, k, ovf = tgc.heaviest_bundle(*_t(*args), max_branch_iters=cap)
        for b in range(len(args[7])):
            n = int(args[7][b])
            for rows, seen in ((None, None), (0, None), (max(n - 1, 0), rng)):
                c, kk, a = g6_warp(*(x[b] for x in args), max_iters=cap, cap=rows, rng=seen)
                _eq(c, cons[b])
                assert kk == int(k[b]) and a == bool(ovf[b])
    assert int(tgc.heaviest_bundle(*_t(*chains))[2].sum()) >= 4


def test_heaviest_bundle_at_the_branch_cap_equals_jax():
    """Chains whose branch completion runs to the 64-pass cap, two with ties
    of weight and score: JAX's flags and paths, and the port's."""
    _, _, ovf = _bundle_both(_chain_args())
    assert 4 <= int(np.asarray(ovf).sum()) < 8


# ------------------------------------------------------------ the pipeline


def _to_port(w):
    from vechat_tpu_torch.pipeline import windows as tw

    out = tw.Window(target_id=w.target_id, rank=w.rank, window_type=w.window_type,
                    backbone_codes=w.backbone_codes.copy(), backbone_quality=w.backbone_quality,
                    if_fasta=w.if_fasta)
    for lay in w.layers:
        out.add_layer(lay.codes.copy(), lay.quality, lay.begin, lay.end)
    return out


def _mixed_windows():
    """tests/test_graph_consensus.py's mixed windows (TGS with the trim,
    TGS FASTA, NGS), in the JAX package's Window."""
    rng = np.random.default_rng(13)
    base = "".join(rng.choice(list("ACGT"), size=60))
    out = []
    for wtype, quality in ((1, True), (1, False), (0, True)):
        for depth in (4, 7):
            seed = np.random.default_rng(1000 + wtype * 10 + depth + int(quality))
            out.append(_mk_window(seed, base, depth, wtype, quality))
    return out


def _result(wins):
    return [(list(w.consensus_codes), w.polished) for w in wins]


def test_run_device_linear_equals_jax_host_and_device_paths():
    """The six mixed windows: the port's run_device_linear on the CPU equals
    the JAX package's host path and its own run_device_linear."""
    from vechat_tpu.pipeline import device_cycle as jdc
    from vechat_tpu.pipeline import windows as jw
    from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
    from vechat_tpu_torch.pipeline.device_cycle import run_device_linear

    host = _mixed_windows()
    jw.generate_consensus_linear(host, jw.HostAlignerBackend(3, -5, -4), trim=True)
    jdev = _mixed_windows()
    assert all(jdc.run_device_linear(jdev, _DevBackend(), trim=True))
    wins = [_to_port(w) for w in _mixed_windows()]
    be = TorchAlignerBackend(3, -5, -4, device="cpu")
    assert all(run_device_linear(wins, be, trim=True))
    assert _result(wins) == _result(host) == _result(jdev)
    c = be.counters()
    assert c["n_linear_windows"] == 6 and c["n_linear_host"] == 0
    assert c["n_linear_dispatches"] == 1 and not _routes(c)


@pytest.fixture(scope="module", params=[False, True], ids=["fasta", "fastq"])
def pipeline(request):
    """tests/test_torch_graph_cycle.py's four pipeline windows (kTGS), and
    the JAX package's host round 2 on them, with the trim."""
    spec = _pipeline_windows(request.param)
    return spec, request.param, _jax_linear_host(spec, request.param)


def _jax_linear_host(spec, fastq, scores=(3, -5, -4)):
    from vechat_tpu.pipeline import windows as jw

    host = _windows_of(jw, spec, fastq)
    jw.generate_consensus_linear(host, jw.HostAlignerBackend(*scores), trim=True)
    return _result(host)


def _port_linear(spec, fastq, monkeypatch, scores=(3, -5, -4)):
    from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
    from vechat_tpu_torch.pipeline import windows as tw

    monkeypatch.setenv("VECHAT_DEVICE_LINEAR", "1")
    wins = _windows_of(tw, spec, fastq)
    be = TorchAlignerBackend(*scores, device="cpu")
    tw.generate_consensus_linear(wins, be, trim=True)
    return _result(wins), be


def _routes(c):
    return {k[12:]: v for k, v in c.items() if k.startswith("linear_host_") and v}


def test_full_pipeline_device_linear_equals_the_jax_host_path(pipeline, monkeypatch):
    """`generate_consensus_linear` with VECHAT_DEVICE_LINEAR=1 and the torch
    backend on the CPU: every window on the device program, byte for byte
    the JAX package's host path."""
    spec, fastq, want = pipeline
    got, be = _port_linear(spec, fastq, monkeypatch)
    assert got == want
    c = be.counters()
    assert c["n_linear_windows"] == 4 and c["n_linear_host"] == 0
    assert c["n_linear_dispatches"] == 1 and not _routes(c) and c["fallbacks"] == 0


def test_full_pipeline_routes_flagged_windows_to_the_host(pipeline, monkeypatch):
    """Bits of the build (nodes and edges), the slots and the branch cap on
    three windows: they take the host build and consensus, counted by
    reason; the output does not change."""
    from vechat_tpu_torch.pipeline import device_cycle

    spec, fastq, want = pipeline
    real = device_cycle.device_linear

    def flag(*args, **kw):
        out, out_len, bits = real(*args, **kw)
        extra = torch.tensor([tgc.BUILD_OVF_BITS["n_cap"] | tgc.BUILD_OVF_BITS["e_cap"],
                              tgc.OVF_SLOTS, tgc.OVF_BRANCH, 0], dtype=torch.int32)
        return out, out_len, bits | extra[: len(bits)]

    monkeypatch.setattr(device_cycle, "device_linear", flag)
    got, be = _port_linear(spec, fastq, monkeypatch)
    assert got == want
    c = be.counters()
    assert c["n_linear_windows"] == 1 and c["n_linear_host"] == 3
    assert _routes(c) == dict(n_cap=1, e_cap=1, slots=1, branch=1)


def test_full_pipeline_ladder_and_int16_route_to_the_host(pipeline, monkeypatch):
    """Windows past the node ladder, or in a bucket whose scores leave
    int16, never reach the device program: counted, and the output does
    not change."""
    from vechat_tpu_torch.pipeline import device_cycle

    spec, fastq, want = pipeline
    monkeypatch.setattr(device_cycle, "N_LADDER", (16,))
    got, be = _port_linear(spec, fastq, monkeypatch)
    assert got == want and _routes(be.counters()) == dict(ladder=4)
    monkeypatch.undo()
    scores = (60, -60, -60)
    got, be = _port_linear(spec, fastq, monkeypatch, scores)
    assert got == _jax_linear_host(spec, fastq, scores)
    assert _routes(be.counters()) == dict(int16=4) and be.counters()["n_linear_dispatches"] == 0


def test_host_backend_ignores_the_switch(monkeypatch):
    from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
    from vechat_tpu_torch.pipeline.device_cycle import use_device_linear
    from vechat_tpu_torch.pipeline.windows import HostAlignerBackend

    monkeypatch.delenv("VECHAT_DEVICE_LINEAR", raising=False)
    assert not use_device_linear(TorchAlignerBackend(3, -5, -4, device="cpu"))
    monkeypatch.setenv("VECHAT_DEVICE_LINEAR", "1")
    assert use_device_linear(TorchAlignerBackend(3, -5, -4, device="cpu"))
    assert not use_device_linear(HostAlignerBackend(3, -5, -4))
    monkeypatch.setenv("VECHAT_DEVICE_LINEAR", "off")
    assert not use_device_linear(TorchAlignerBackend(3, -5, -4, device="cpu"))
