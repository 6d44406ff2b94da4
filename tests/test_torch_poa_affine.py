"""Affine POA DP + three-state walk of the port (plain PyTorch versions on
the CPU) against the JAX package's Pallas kernel in interpret mode and the
host oracles. Every quantity is an integer DP result: the tolerance is
exact equality.

`check_case` and `Kind` also serve the convex tests."""

import functools
from typing import Callable, NamedTuple, Tuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_poa_linear import build_graphs, make_case, mutate, pack, rand_seq
from vechat_tpu.ops.kernels import poa_pallas_affine as jaff
from vechat_tpu_torch.ops.encode import encode
from vechat_tpu_torch.ops.graph_align import AffineAligner
from vechat_tpu_torch.ops.kernels import poa_affine as taff
from vechat_tpu_torch.ops.kernels.poa_linear import max_pred_distance, ranks_to_node_ids_np


class Kind(NamedTuple):
    """One gap model: its scores and the two packages' functions."""

    scores: Tuple[int, ...]  # m, x, g, e[, q, c]
    names: Tuple[str, ...]  # the JAX functions' keyword names of `scores`
    jax_align: Callable
    jax_dp: Callable
    port_align: Callable
    port_dp: Callable
    host: Callable


AFFINE = Kind(
    (3, -5, -8, -6), ("m", "x", "g", "e"),
    jaff.poa_align_pallas_affine, jaff._poa_dp_pallas_affine,
    taff.poa_align_affine, taff.poa_dp_affine, AffineAligner,
)


def check_case(kind, jgraphs, tgraphs, seq_lists, mode, N, P, W, ring=0):
    """The same numpy arrays through the JAX kernel (interpret mode) and the
    port on the CPU: pairs, counts, scores, best cells and the defined
    direction words are equal, and the alignments equal the port's host
    oracle on the port's own graphs."""
    arrs = pack(jgraphs, seq_lists, N, P, W)
    codes, preds, sink, nid, nn, seqp, slen = arrs
    B, D = seqp.shape[0], seqp.shape[1]
    score_kw = dict(zip(kind.names, kind.scores))

    j_out = kind.jax_align(
        *[jnp.asarray(a) for a in arrs], align_type=mode, **score_kw,
        interpret=True, ring=ring, emit_node_ids=False,
    )
    t_out = kind.port_align(
        codes, preds, sink, nn, seqp, slen, mode, *kind.scores, ring=ring, device="cpu"
    )
    for name, j, t in zip(("pn", "pp", "count", "score"), j_out, t_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)

    # the DP alone: direction words on rows <= n_nodes and lanes <= slen
    # (the rest is undefined), and the best cell
    j_dp = jax.jit(
        functools.partial(kind.jax_dp, align_type=mode, **score_kw, interpret=True, ring=ring)
    )(*[jnp.asarray(a) for a in (codes, preds, sink, nn, seqp, slen)])
    R = N if ring <= 0 or ring > N else ring
    t32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    aux, deg = taff.pack_aux_gap(t32(preds), R)
    t_dp = kind.port_dp(
        t32(codes).reshape(B, N), aux, deg, t32(sink).reshape(B, N), t32(nn).reshape(B),
        t32(seqp), t32(slen).reshape(B, D), mode, *kind.scores, R,
    )
    for b in range(B):
        for d in range(D):
            rows, lanes = int(nn[b, 0, 0]) + 1, int(slen[b, 0, d]) + 1
            np.testing.assert_array_equal(
                t_dp[0][b, :rows, d, :lanes].numpy(), np.asarray(j_dp[0])[b, :rows, d, :lanes],
                err_msg=f"dirs b={b} d={d}",
            )
    for name, j, t in zip(("maxi", "maxj", "score"), j_dp[1:], t_dp[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[:, 0, :], err_msg=name)

    pn, pp, count, score = (t.numpy() for t in t_out)
    L = pn.shape[2]
    host = kind.host(mode, *kind.scores)
    for b, gr in enumerate(tgraphs):
        for di, q in enumerate(seq_lists[b]):
            c = int(count[b, 0, di])
            ids = ranks_to_node_ids_np(pn[b, di, L - c :].astype(np.int64), nid[b, 0])
            want, wscore = host.align(q, gr, return_score=True)
            assert list(zip(ids.tolist(), pp[b, di, L - c :].tolist())) == want, f"b={b} d={di}"
            assert int(score[b, 0, di]) == wscore
            assert (pn[b, di, : L - c] == -2).all() and (pp[b, di, : L - c] == -2).all()


def gap_heavy_case(seed, base_len, cuts, n_layers=2):
    """A graph of `base` and mutated copies, and queries with the long
    deletions (lo, hi) and insertions (at, length) of `cuts`."""
    rng = np.random.default_rng(seed)
    base = rand_seq(rng, base_len)
    jg, tg = build_graphs([base] + [mutate(rng, base, 0.08) for _ in range(n_layers - 1)])
    qs = []
    for kind, a, b in cuts:
        if kind == "del":
            qs.append(encode(base[:a] + base[b:]))
        else:
            qs.append(encode(base[:a] + rand_seq(rng, b) + base[a:]))
    return [jg], [tg], [qs]


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_affine_small(mode):
    jg, tg, seqs = make_case(20, n_graphs=2, depth=2, D=2, base_len=24)
    check_case(AFFINE, jg, tg, seqs, mode, N=64, P=4, W=32)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_affine_deep_graph(mode):
    jg, tg, seqs = make_case(22, n_graphs=1, depth=5, D=3, base_len=30)
    check_case(AFFINE, jg, tg, seqs, mode, N=96, P=8, W=64)


def test_affine_gap_heavy():
    """Long indels take the F-chain and E-chain states of the walk."""
    jg, tg, seqs = gap_heavy_case(3, 40, [("del", 12, 30), ("ins", 20, 14)])
    check_case(AFFINE, jg, tg, seqs, "nw", N=64, P=4, W=64)


@pytest.mark.parametrize("mode", ["nw", "ov"])
def test_affine_ring_equals_full_history(mode):
    """A ring shorter than the graph (it wraps) gives what full history
    gives, in both packages."""
    ring = 32
    jg, tg, seqs = make_case(24, n_graphs=1, depth=4, D=2, base_len=44)
    codes, preds, sink, nid, nn, seqp, slen = pack(jg, seqs, 96, 8, 64)
    assert max_pred_distance(preds[0].T, nn[0, 0, 0]) <= ring < int(nn[0, 0, 0])
    check_case(AFFINE, jg, tg, seqs, mode, N=96, P=8, W=64, ring=ring)
    full = taff.poa_align_affine(
        codes, preds, sink, nn, seqp, slen, mode, *AFFINE.scores, ring=0, device="cpu"
    )
    ringed = taff.poa_align_affine(
        codes, preds, sink, nn, seqp, slen, mode, *AFFINE.scores, ring=ring, device="cpu"
    )
    for a, b in zip(full, ringed):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16])
def test_affine_code_fields_match_jax(P):
    assert taff.sh_bits_aff(P) == jaff._sh_bits_aff(P)
    assert taff.shf_bits(P) == jaff._shf_bits(P)
    assert taff.EB_BIT == jaff.EB_BIT


def test_affine_fits_int16_matches_jax():
    for args in [(640, 576, 5, -4, -8, -6), (1152, 576, 5, -4, -8, -6), (1152, 576, 3, -5, -8, -6),
                 (4095, 8, 1, -1, -2, -1), (256, 128, 3, -5, -40, -30)]:
        assert taff.fits_int16_affine(*args) == jaff.fits_int16_affine(*args), args


def dp_inputs():
    """Well-formed inputs of a DP wrapper (one graph, one real row)."""
    return dict(
        codes=torch.zeros((1, 8), dtype=torch.int32),
        aux=torch.full((1, 4, 8), 8 << 16, dtype=torch.int32),
        deg=torch.ones((1, 8), dtype=torch.int32),
        sink=torch.ones((1, 8), dtype=torch.int32),
        n_nodes=torch.ones(1, dtype=torch.int32),
        seqp=torch.zeros((1, 2, 32), dtype=torch.int32),
        slen=torch.ones((1, 2), dtype=torch.int32),
    )


@pytest.mark.parametrize(
    "change,R",
    [
        (dict(seqp=torch.zeros((1, 2, 32), dtype=torch.int64)), 8),  # dtype
        (dict(slen=torch.ones((1, 3), dtype=torch.int32)), 8),  # shape
        (dict(aux=torch.zeros((4, 8), dtype=torch.int32)), 8),  # rank
        (dict(codes=torch.zeros((1, 16), dtype=torch.int32)[:, ::2]), 8),  # not contiguous
        ({}, 512),  # ring past the 9-bit delta field
        ({}, 0),
    ],
)
def test_affine_dp_rejects_bad_inputs(change, R):
    with pytest.raises(ValueError):
        taff.poa_dp_affine(**{**dp_inputs(), **change}, align_type="nw", m=3, x=-5, g=-8, e=-6, R=R)


def test_affine_walk_rejects_bad_inputs():
    dirs = torch.zeros((1, 9, 2, 32), dtype=torch.int32)
    mx = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        taff.traceback_walk_affine(dirs.to(torch.int16), mx, mx, "nw", 50, 4)
    with pytest.raises(ValueError):
        taff.traceback_walk_affine(dirs, mx[:, :1], mx, "nw", 50, 4)
    with pytest.raises(ValueError):
        taff.traceback_walk_affine(dirs[0], mx, mx, "nw", 50, 4)


def test_affine_align_defaults_to_the_card(monkeypatch):
    """Left without `device`, poa_align_affine runs on the card: without a
    GPU it raises instead of taking the plain CPU version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jg, _, seqs = make_case(0, n_graphs=1, depth=2, D=1, base_len=20)
    codes, preds, sink, nid, nn, seqp, slen = pack(jg, seqs, 32, 4, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        taff.poa_align_affine(codes, preds, sink, nn, seqp, slen, "nw", *AFFINE.scores)
