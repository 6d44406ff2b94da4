"""Convex (dual-affine) POA DP + three-state walk of the port (plain PyTorch
versions on the CPU) against the JAX package's Pallas kernel in interpret
mode and the host oracles. Every quantity is an integer DP result: the
tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_poa_affine import Kind, check_case, dp_inputs, gap_heavy_case
from tests.test_torch_poa_linear import make_case, pack
from vechat_tpu.ops.kernels import poa_pallas_convex as jcvx
from vechat_tpu_torch.ops.graph_align import ConvexAligner
from vechat_tpu_torch.ops.kernels import poa_convex as tcvx
from vechat_tpu_torch.ops.kernels.poa_linear import max_pred_distance

# kConvex: g < e (not linear), g > q and e < c (not affine)
CONVEX = Kind(
    (3, -5, -8, -6, -10, -2), ("m", "x", "g", "e", "q", "c"),
    jcvx.poa_align_pallas_convex, jcvx._poa_dp_pallas_convex,
    tcvx.poa_align_convex, tcvx.poa_dp_convex, ConvexAligner,
)
# the scores the spoa command line starts with
CLI_DEFAULT = CONVEX._replace(scores=(5, -4, -8, -6, -10, -4))


@pytest.mark.parametrize("mode", ["nw", "sw", "ov"])
def test_convex_small(mode):
    jg, tg, seqs = make_case(30, n_graphs=2, depth=2, D=2, base_len=24)
    check_case(CONVEX, jg, tg, seqs, mode, N=64, P=4, W=32)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_convex_deep_graph(mode):
    jg, tg, seqs = make_case(32, n_graphs=1, depth=5, D=3, base_len=30)
    check_case(CLI_DEFAULT, jg, tg, seqs, mode, N=96, P=8, W=64)


def test_convex_long_gaps():
    """Long indels flip the optimum to the (q, c) channel: the O-chain and
    Q-chain walks that tell convex from affine. The short deletion stays on
    (g, e)."""
    jg, tg, seqs = gap_heavy_case(3, 48, [("del", 10, 38), ("ins", 24, 20), ("del", 20, 23)])
    check_case(CONVEX, jg, tg, seqs, "nw", N=64, P=4, W=96)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_convex_ring_equals_full_history(mode):
    ring = 32
    jg, tg, seqs = make_case(24, n_graphs=1, depth=4, D=2, base_len=44)
    codes, preds, sink, nid, nn, seqp, slen = pack(jg, seqs, 96, 8, 64)
    assert max_pred_distance(preds[0].T, nn[0, 0, 0]) <= ring < int(nn[0, 0, 0])
    check_case(CONVEX, jg, tg, seqs, mode, N=96, P=8, W=64, ring=ring)
    full = tcvx.poa_align_convex(
        codes, preds, sink, nn, seqp, slen, mode, *CONVEX.scores, ring=0, device="cpu"
    )
    ringed = tcvx.poa_align_convex(
        codes, preds, sink, nn, seqp, slen, mode, *CONVEX.scores, ring=ring, device="cpu"
    )
    for a, b in zip(full, ringed):
        assert torch.equal(a, b)


def test_convex_in_degree_over_cap_raises():
    """P > P_CAP would push the H priorities (5P+5) past the 16-bit code:
    both packages refuse it."""
    jg, _, seqs = make_case(0, n_graphs=1, depth=2, D=1, base_len=20)
    arrs = pack(jg, seqs, 32, 16, 32)
    codes, preds, sink, nid, nn, seqp, slen = arrs
    with pytest.raises(ValueError, match="P <= 8"):
        jcvx.poa_align_pallas_convex(
            *[jnp.asarray(a) for a in arrs], align_type="nw",
            **dict(zip(CONVEX.names, CONVEX.scores)), interpret=True,
        )
    with pytest.raises(ValueError, match="P <= 8"):
        tcvx.poa_align_convex(
            codes, preds, sink, nn, seqp, slen, "nw", *CONVEX.scores, device="cpu"
        )
    t32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    aux = torch.full((1, 16, 32), 32 << 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="P <= 8"):
        tcvx.poa_dp_convex(
            t32(codes).reshape(1, 32), aux, torch.ones((1, 32), dtype=torch.int32),
            t32(sink).reshape(1, 32), t32(nn).reshape(1), t32(seqp), t32(slen).reshape(1, 1),
            "nw", *CONVEX.scores, 32,
        )
    with pytest.raises(ValueError, match="P <= 8"):
        tcvx.traceback_walk_convex(
            torch.zeros((1, 33, 1, 32), dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32), "nw", 96, 16,
        )


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_convex_code_fields_match_jax(P):
    assert tcvx.sh_bits_cvx(P) == jcvx._sh_bits_cvx(P)
    assert tcvx.shf_bits_cvx(P) == jcvx._shf_bits_cvx(P)
    assert (tcvx.CB_BIT, tcvx.P_CAP) == (jcvx.CB_BIT, jcvx.P_CAP)
    # the H code (priority and distance) stays inside 16 bits up to P_CAP
    assert tcvx.sh_bits_cvx(tcvx.P_CAP) <= 16


@pytest.mark.parametrize("scores", [(-8, -6, -10, -2), (-8, -6, -10, -4), (-6, -4, -8, -2)])
def test_convex_mat_powers_match_jax(scores):
    assert tcvx.mat_powers(*scores, 10) == jcvx._mat_powers(*scores, 10)


def test_convex_fits_int16_matches_jax():
    for args in [(640, 576, 5, -4, -8, -6, -10, -4), (1152, 576, 5, -4, -8, -6, -10, -4),
                 (1152, 576, 3, -5, -6, -4, -8, -2), (2048, 768, 3, -5, -6, -4, -8, -2),
                 (4095, 8, 1, -1, -2, -1, -3, -1)]:
        assert tcvx.fits_int16_convex(*args) == jcvx.fits_int16_convex(*args), args


def test_convex_dp_rejects_bad_inputs():
    ok = dp_inputs()
    kw = dict(align_type="nw", m=3, x=-5, g=-8, e=-6, q=-10, c=-2)
    tcvx.poa_dp_convex(**ok, **kw, R=8)  # the inputs are good as they stand
    with pytest.raises(ValueError):
        tcvx.poa_dp_convex(**{**ok, "deg": ok["deg"].to(torch.int64)}, **kw, R=8)
    with pytest.raises(ValueError):
        tcvx.poa_dp_convex(**{**ok, "n_nodes": torch.ones(2, dtype=torch.int32)}, **kw, R=8)
    with pytest.raises(ValueError):
        tcvx.poa_dp_convex(**ok, **kw, R=512)


def test_convex_align_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jg, _, seqs = make_case(0, n_graphs=1, depth=2, D=1, base_len=20)
    codes, preds, sink, nid, nn, seqp, slen = pack(jg, seqs, 32, 4, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcvx.poa_align_convex(codes, preds, sink, nn, seqp, slen, "nw", *CONVEX.scores)
