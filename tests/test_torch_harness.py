"""The port's harness counterparts on the CPU, each against the JAX
package's: `parallel/mesh.py:sharded_poa_align` (over CPU shards, and the
JAX function over its virtual CPU devices), `sharded_device_polish` and
`sharded_device_linear` at `dryrun_multichip`'s shapes (against the
one-device port and JAX's `device_build` -> `haplotype_cycle` and
`device_linear`), `vechat_tpu_torch/entry.py` (`entry` against
`__graft_entry__.entry`, and `dryrun_multichip` over two CPU shards), and
`utils/roofline.synth_graph_batch` against `bench.synth_graph_batch`.
Every comparison is exact."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vechat_tpu.ops.kernels import graph_build as jgb
from vechat_tpu.ops.kernels import graph_consensus as jgc
from vechat_tpu.ops.kernels import graph_cycle as jcy
from vechat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vechat_tpu.parallel.mesh import sharded_poa_align as jax_sharded_poa_align
from vechat_tpu_torch import entry as port_entry
from vechat_tpu_torch.ops.kernels.poa_full import poa_align_batch_full
from vechat_tpu_torch.parallel import mesh as tmesh
from vechat_tpu_torch.utils import roofline as rf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def graft():
    sys.path.insert(0, REPO)
    import __graft_entry__

    return __graft_entry__


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_poa_align_equals_unsharded_and_jax(k):
    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} virtual devices")
    args = port_entry.example_batch(B=8, N=64, S=63, P=4)
    mode = ("nw", "sw", "ov", "nw")[[1, 2, 4, 8].index(k)]
    got = tmesh.sharded_poa_align(tmesh.make_mesh(["cpu"] * k), mode, 3, -5, -4)(*args)
    one = poa_align_batch_full(*args, mode, 3, -5, -4, device="cpu")
    want = jax_sharded_poa_align(jax_make_mesh(k), mode, 3, -5, -4)(
        *[jnp.asarray(a) for a in args])
    for name, g, o, j in zip(("pairs", "count", "score"), got, one, want):
        assert g.device.type == "cpu" and g.dtype == torch.int32, name
        assert torch.equal(g, o), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)


def test_sharded_poa_align_refuses_a_batch_that_does_not_divide():
    args = port_entry.example_batch(B=8, N=64, S=63, P=4)
    fn = tmesh.sharded_poa_align(tmesh.make_mesh(["cpu"] * 3), "nw", 3, -5, -4)
    with pytest.raises(ValueError, match="divide"):
        fn(*args)


@pytest.fixture(scope="module")
def dryrun_arrays():
    return port_entry.dryrun_inputs(8)


def _build_args(a):
    return [a[k] for k in port_entry.BUILD_KEYS]


def test_sharded_device_polish_equals_one_device_and_jax(dryrun_arrays):
    a = dryrun_arrays
    keys = port_entry.BUILD_KEYS + port_entry.CYCLE_KEYS
    caps = (port_entry.NC, port_entry.EC, port_entry.RC, 3, -5, -4, 0.2, 0.2, 3)
    two = tmesh.sharded_device_polish(["cpu", "cpu"], *caps, a_cap=8, p_cap=4)(
        *(a[k] for k in keys))
    one = tmesh.sharded_device_polish(["cpu"], *caps, a_cap=8, p_cap=4)(
        *(a[k] for k in keys))
    for g, o in zip(two, one):
        assert torch.equal(g, o)
    built = jgb.device_build(*(jnp.asarray(x) for x in _build_args(a)), port_entry.NC,
                             port_entry.EC, port_entry.RC, 3, -5, -4)
    corrected, out_len, overflow, _ = jcy.haplotype_cycle(
        built["tails"], built["heads"], built["weights"], built["n_edges"], built["codes"],
        built["n_nodes"], *(jnp.asarray(a[k]) for k in port_entry.CYCLE_KEYS),
        jnp.float32(0.2), jnp.float32(0.2), num_prune=3, m=3, x=-5, g=-4, a_cap=8, p_cap=4,
        d_chunk=2)
    assert not np.asarray(built["overflow"]).any() and not np.asarray(overflow).any()
    assert not two[2].any() and not two[3].any()
    np.testing.assert_array_equal(two[1].numpy(), np.asarray(out_len))
    np.testing.assert_array_equal(two[0].numpy(), np.asarray(corrected))
    assert int(two[1].sum()) > 0


def test_sharded_device_linear_equals_one_device_and_jax(dryrun_arrays):
    a = dryrun_arrays
    args = [a[k] for k in port_entry.BUILD_KEYS + ("do_trim",)]
    caps = (port_entry.NC, port_entry.EC, port_entry.RC, 3, -5, -4)
    two = tmesh.sharded_device_linear(["cpu", "cpu"], *caps, p_cap=4)(*args)
    one = tmesh.sharded_device_linear(["cpu"], *caps, p_cap=4)(*args)
    for g, o in zip(two, one):
        assert torch.equal(g, o)
    out, out_len, ovf = (np.asarray(w) for w in jgc.device_linear(
        *(jnp.asarray(x) for x in args), *caps, p_cap=4))
    assert not ovf.any() and not two[2].any()
    np.testing.assert_array_equal(two[1].numpy(), out_len)
    np.testing.assert_array_equal(two[0].numpy(), out)


def test_entry_equals_the_graft_entry(graft):
    fn, args = port_entry.entry(device="cpu")
    jfn, jargs = graft.entry()
    assert len(args) == len(jargs) == 7
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a, j)
    got = fn(*args)
    want = jax.jit(jfn)(*[jnp.asarray(a) for a in jargs])
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[0] == 8


def test_entry_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.dryrun_multichip(["cuda:0", "cuda:0"])


def test_dryrun_multichip_on_two_cpu_shards_equals_one(capsys):
    two = port_entry.dryrun_multichip(["cpu", "cpu"])
    assert "[dryrun_multichip] ok: devices=2, batch=8" in capsys.readouterr().out
    one = port_entry.dryrun_multichip(["cpu"])
    for part in "abcd":
        for g, o in zip(two[part], one[part]):
            assert torch.equal(g, o), part
    t = two["totals"]
    assert t["pairs"] == int(one["a"][1].sum()) > 0 and t["cells"] > 0
    assert t["kernel_shard_pairs"] > 0 and t["cycle_out_bases"] > 0
    assert t["linear_out_bases"] > 0
    three = port_entry.dryrun_multichip(["cpu"] * 3)
    assert three["totals"]["batch"] == 9


def test_synth_graph_batch_equals_the_benchmarks(graft):
    import bench

    want, want_cells = bench.synth_graph_batch(6, 256, 8, 3, 128, seed=1)
    got, cells = rf.synth_graph_batch(6, 256, 8, 3, 128, seed=1)
    assert cells == want_cells
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_roofline_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rf.main()
    with pytest.raises(ValueError):
        rf.dp_roofline(device="cpu")
