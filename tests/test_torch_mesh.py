"""The port's sharded window-batch aligner (`parallel/mesh.py`) on CPU
devices against the unsharded port and against the JAX package's
`sharded_poa_align_pallas` over 8 virtual devices in interpret mode, and the
backend's sharded route against its single-device route and the host
engine. Pair buffers, counts, scores and alignments are compared exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vechat_tpu_torch.ops.kernels.dense as dense_mod
from vechat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vechat_tpu.parallel.mesh import sharded_poa_align_pallas
from vechat_tpu_torch.cli.racon_main import make_backend
from vechat_tpu_torch.ops.encode import encode
from vechat_tpu_torch.ops.graph_align import LinearAligner
from vechat_tpu_torch.ops.kernels import poa_linear as tpl
from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend, pack_windows
from vechat_tpu_torch.ops.poagraph import PoaGraph
from vechat_tpu_torch.parallel import mesh as tmesh


def mesh_inputs():
    """The inputs of tests/test_mesh_and_modes.py::test_sharded_pallas_kernel_mesh."""
    B, N, P, D, W = 8, 24, 4, 2, 24
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (B, 1, N)).astype(np.int32)
    preds = np.maximum(np.arange(N, dtype=np.int32) - 1, 0)
    preds = np.tile(preds[None, None, :], (B, P, 1))
    sink = np.zeros((B, 1, N), np.int32)
    sink[:, 0, -1] = 1
    nid = np.tile(np.arange(N, dtype=np.int32)[None, None, :], (B, 1, 1))
    nn = np.full((B, 1, 1), N, np.int32)
    seqp = np.full((B, D, W), 0xFF, np.int32)
    slen = np.zeros((B, 1, D), np.int32)
    for b in range(B):
        for d in range(D):
            L = int(rng.integers(8, W - 1))
            seqp[b, d, 1 : 1 + L] = rng.integers(0, 4, L)
            slen[b, 0, d] = L
    return codes, preds, sink, nid, nn, seqp, slen


@pytest.fixture(scope="module")
def jax_sharded():
    """(pn, pp, count, score) of the JAX package's mesh-sharded kernel."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    fn = sharded_poa_align_pallas(jax_make_mesh(8), "nw", 3, -5, -4, interpret=True)
    out = jax.block_until_ready(fn(*[jnp.asarray(a) for a in mesh_inputs()]))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_equals_unsharded_and_jax(k, jax_sharded):
    codes, preds, sink, nid, nn, seqp, slen = arrs = mesh_inputs()
    fn = tmesh.sharded_poa_align_cuda(tmesh.make_mesh(["cpu"] * k), "nw", 3, -5, -4)
    got = fn(*arrs)
    one = tpl.poa_align(
        codes, preds, sink, nn, seqp, slen, "nw", 3, -5, -4, device="cpu",
        emit_rle=False, emit_node_ids=True, node_id=nid,
    )
    for name, g, o, j in zip(("pn", "pp", "count", "score"), got, one, jax_sharded):
        assert g.device.type == "cpu"
        assert torch.equal(g, o), name
        assert g.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(g.numpy(), j, err_msg=name)


@pytest.mark.parametrize("mode,ring,node_ids", [("sw", 8, False), ("ov", 0, True)])
def test_sharded_modes_rings_and_ranks(mode, ring, node_ids):
    codes, preds, sink, nid, nn, seqp, slen = arrs = mesh_inputs()
    fn = tmesh.sharded_poa_align_cuda(
        [torch.device("cpu")] * 4, mode, 3, -5, -4, ring=ring, emit_node_ids=node_ids
    )
    one = tpl.poa_align(
        codes, preds, sink, nn, seqp, slen, mode, 3, -5, -4, ring=ring, device="cpu",
        emit_rle=False, emit_node_ids=node_ids, node_id=nid if node_ids else None,
    )
    for g, o in zip(fn(*arrs), one):
        assert torch.equal(g, o)


def test_batch_must_divide_by_the_shards():
    arrs = mesh_inputs()
    fn = tmesh.sharded_poa_align_cuda(tmesh.make_mesh(["cpu"] * 3), "nw", 3, -5, -4)
    with pytest.raises(ValueError, match="does not divide"):
        fn(*arrs)
    with pytest.raises(ValueError, match="batch axis"):
        tmesh.sharded_poa_align_cuda(tmesh.make_mesh(["cpu"]), "nw", 3, -5, -4)(
            arrs[0][:4], *arrs[1:]
        )


def test_make_mesh_devices(monkeypatch):
    assert tmesh.WINDOW_AXIS == "windows"
    assert tmesh.make_mesh(["cpu", torch.device("cpu")]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        tmesh.make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, 2, ["cuda:0", "cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(asked)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.make_mesh() == [torch.device("cuda", k) for k in range(4)]
    assert tmesh.make_mesh(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert tmesh.make_mesh(["cuda:0", "cuda:0"]) == [torch.device("cuda", 0)] * 2


# ------------------------------------------------------- the backend's route


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def mutate(rng, seq, rate=0.1):
    out = []
    for c in seq:
        r = rng.random()
        if r < rate * 0.5:
            out.append(rng.choice([b for b in "ACGT" if b != c]))
        elif r < rate * 0.7:
            continue
        else:
            out.append(c)
    return "".join(out)


def build_graph(seqs):
    eng = LinearAligner("nw", 3, -5, -4)
    gr = PoaGraph()
    for s in seqs:
        codes = encode(s)
        aln = eng.align(codes, gr) if gr.num_nodes() else []
        gr.add_alignment(aln, codes, np.ones(len(codes), dtype=np.uint32))
    return gr


@pytest.fixture
def small_buckets(monkeypatch):
    monkeypatch.setattr(dense_mod, "N_BUCKETS", (32, 64))
    monkeypatch.setattr(dense_mod, "W_BUCKETS", (32,))
    monkeypatch.setattr(dense_mod, "P_BUCKETS", (4, 8))


def window_items(seed, n_graphs=3, per_graph=3):
    rng = np.random.default_rng(seed)
    base = rand_seq(rng, 20)
    graphs = [build_graph([mutate(rng, base) for _ in range(3)]) for _ in range(n_graphs)]
    items = [(encode(mutate(rng, base)), g, "nw") for g in graphs for _ in range(per_graph)]
    items += [(encode(mutate(rng, base)), graphs[0], "sw"), (np.array([], np.uint8), graphs[1], "nw")]
    return items


@pytest.mark.parametrize("n_shards", [2, 4])
def test_backend_sharded_route_matches_single_and_host(small_buckets, n_shards):
    """Three window graphs over 2 or 4 shards: the batch is padded up to the
    shard count, the dense route is taken, and the alignments are those of
    the single-device (run-length) route and of the host engine."""
    items = window_items(0)
    single = TorchAlignerBackend(3, -5, -4, device="cpu")
    sharded = TorchAlignerBackend(3, -5, -4, device="cpu", devices=["cpu"] * n_shards)
    assert len(sharded.devices) == n_shards and len(single.devices) == 1
    want = single.align_batch(items)
    got = sharded.align_batch(items)
    assert got == want
    sc, uc = sharded.counters(), single.counters()
    assert sc["sharded_dispatches"] == sc["n_dispatches"] >= 1
    assert uc["sharded_dispatches"] == 0 and uc["n_dispatches"] >= 1
    assert sc["fallbacks"] == 0 and sc["device_alignments"] == len(items) - 1
    assert "launches_poa_walk_dense" in sc
    host = {m: LinearAligner(m, 3, -5, -4) for m in ("nw", "sw")}
    for (codes, graph, mode), aln in zip(items[:-1], got):
        assert aln == host[mode].align(codes, graph)
    assert got[-1] == []


def test_backend_sharded_route_raises_on_a_short_walk(small_buckets, monkeypatch):
    """Pairs that disagree with the walk's count are a RuntimeError naming
    the item, never a silent result."""
    import vechat_tpu_torch.ops.kernels.backend as backend_mod

    real = backend_mod.sharded_poa_align_cuda

    def broken(*a, **kw):
        fn = real(*a, **kw)

        def call(*arrs):
            pn, pp, count, score = fn(*arrs)
            return pn, pp, count + 1, score

        return call

    monkeypatch.setattr(backend_mod, "sharded_poa_align_cuda", broken)
    be = TorchAlignerBackend(3, -5, -4, device="cpu", devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="count says"):
        be.align_batch(window_items(1))


def test_pack_windows_padding_slots():
    """Slots past the graphs are the padding the sharded route needs: one
    sink node 'A' and one sequence 'A', a one-pair alignment."""
    gr = build_graph(["ACGTACGT"])
    d = dense_mod.graph_to_dense(gr, 32, 4)
    codes, preds, sink, nid, nn, seqp, slen = pack_windows([(d, [encode("ACGT")])], 32, 4, 32, B=4)
    assert codes.shape[0] == 4 and nn[1:, 0, 0].tolist() == [1, 1, 1]
    assert (preds[1:] == 0).all() and (sink[1:] == 1).all() and (slen[1:] == 1).all()
    pn, pp, count, _ = tpl.poa_align(
        codes, preds, sink, nn, seqp, slen, "nw", 3, -5, -4, device="cpu", emit_rle=False
    )
    assert count[:, 0, 0].tolist() == [8, 1, 1, 1]  # 4 matches and 4 deletions; 'A' on 'A'


def test_backend_devices_default_and_explicit(monkeypatch):
    """`device="cuda"` is every visible card; a card's index, or the CPU, is
    one entry; an explicit list is taken as it stands; no GPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert len(TorchAlignerBackend(3, -5, -4).devices) == 4
    assert TorchAlignerBackend(3, -5, -4, device="cuda:2").devices == [torch.device("cuda", 2)]
    be = make_backend("cuda", 3, -5, -4, devices=["cuda:0", "cuda:0"])
    assert be.devices == [torch.device("cuda", 0)] * 2 and be.device == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("cuda", 3, -5, -4, devices=["cuda:0", "cuda:0"])
    assert make_backend("torch", 3, -5, -4).devices == [torch.device("cpu")]
