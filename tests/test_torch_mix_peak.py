"""The mix-peak kernel's plain PyTorch version (K7) against the JAX package's
`mix_kernel` (scripts/roofline.py:79) and against a numpy statement of its
round (`:88-100`), on seeded tiles, exactly.

The JAX package's `measure_mix_peak` gives the kernel uninitialised scratch,
so its own checksum is not defined. The kernel body takes its chains as refs
all the same: here it runs in interpret mode on the port's seeded tile, and
its checksum (lane [0, 0] of the four chains) is held against the port's. A
row's roll is cyclic and rows are independent, so the tile shifted by (r, c)
puts lane [r, c] under the checksum: that holds other lanes to the JAX body
too. The numpy statement beside it holds every lane at once."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from vechat_tpu_torch.utils import roofline as rf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_roofline():
    """scripts/roofline.py of the JAX package, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", os.path.join(ROOT, "scripts", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_checksum(jr, chains, iters, seed):
    """The JAX package's kernel body on one [64, 512] tile of each chain, in
    interpret mode: its checksum."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    out = pl.pallas_call(
        lambda s, a, b, c, d, o: jr.mix_kernel(s, o, a, b, c, d, iters=iters,
                                               ops_per_iter=rf.OPS_PER_ITER),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.int32),
        interpret=True,
    )(jnp.full((1, 1), seed, jnp.int32), *[jnp.asarray(t) for t in chains])
    return int(out[0, 0])


# the lanes put under the checksum: [0, 0] (its left neighbour is lane 511),
# the end of a row, both sides of a warp's 32-lane boundary
LANES = [(0, 0), (63, 511), (17, 32), (40, 31)]


@pytest.mark.parametrize("iters,seed", [(1, 0), (3, 5), (17, 1000)])
def test_mix_plain_matches_the_jax_kernel_body(jax_roofline, iters, seed):
    tile = [t[0].numpy() for t in rf.mix_inputs(1, seed, "cpu")]
    assert (jax_roofline.D, jax_roofline.W) == (rf.ROWS, rf.COLS)
    for r, c in LANES:
        shifted = [np.ascontiguousarray(np.roll(t, (-r, -c), axis=(0, 1))) for t in tile]
        want = jax_checksum(jax_roofline, shifted, iters, seed)
        got = rf.mix_peak(*[torch.from_numpy(t)[None] for t in shifted], iters, seed)
        assert int(got[4][0]) == want, (r, c)
        # the port on the unshifted tile has the same values at lane [r, c]
        plain = rf.mix_peak(*[torch.from_numpy(t)[None] for t in tile], iters, seed)
        lane_sum = sum(x[0, r, c] for x in plain[:4])  # int32, wraps as the checksum does
        assert int(lane_sum) == want, (r, c)



def np_round(x, y, kk):
    """round_ of scripts/roofline.py, operation by operation, in int32."""
    r = np.roll(x, 1, axis=-1)
    s = r + y
    m = np.maximum(s, x)
    cmp = m > y
    sel = np.where(cmp, m, x)
    sh = sel >> 2
    an = sh & 0x7FFF
    ad = an + np.int32(kk)
    mx = np.maximum(ad, y)
    mn = np.minimum(mx, np.int32(0x3FFFFFF))
    orr = mn | np.int32(1)
    return orr - y


def np_mix(a, b, c, d, iters, seed):
    for k in range(iters):
        kk = k + seed
        a = np_round(a, b, kk)
        b = np_round(b, c, kk)
        c = np_round(c, d, kk)
        d = np_round(d, a, kk)
    return a, b, c, d, a[:, 0, 0] + b[:, 0, 0] + c[:, 0, 0] + d[:, 0, 0]


@pytest.mark.parametrize("iters,seed", [(0, 0), (1, 0), (3, 5), (17, 1000)])
def test_mix_plain_matches_the_numpy_round(iters, seed):
    chains = rf.mix_inputs(2, seed, "cpu")
    want = np_mix(*[t.numpy() for t in chains], iters, seed)
    got = rf.mix_peak(*chains, iters, seed)  # CPU tensors: the plain version
    assert len(got) == 5 and got[4].shape == (2,)
    for name, g, w in zip(("a", "b", "c", "d", "checksum"), got, want):
        assert g.dtype == torch.int32 and w.dtype == np.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if iters:
        assert not torch.equal(got[0], chains[0])


def test_roll_wraps_around_the_row():
    """Lane 0 takes lane 511 of its own row: the one step of the round that
    crosses threads in the kernel."""
    x = torch.arange(rf.ROWS * rf.COLS, dtype=torch.int32).reshape(1, rf.ROWS, rf.COLS)
    zero = torch.zeros_like(x)
    # with y = 0 and kk = 0: round(x, 0) = max((max(roll(x), x) >> 2) & 0x7FFF, 0) | 1
    got = rf._round(x, zero, 0)
    rolled = np.roll(x.numpy(), 1, axis=-1)
    want = ((np.maximum(rolled, x.numpy()) >> 2) & 0x7FFF) | 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 0, 0]) == ((511 >> 2) & 0x7FFF) | 1  # from lane 511, not lane 0


def test_mix_inputs_are_seeded():
    a = rf.mix_inputs(1, 3, "cpu")
    b = rf.mix_inputs(1, 3, "cpu")
    c = rf.mix_inputs(1, 4, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert a[0].shape == (1, 64, 512) and a[0].dtype == torch.int32


def test_mix_peak_rejects_bad_inputs():
    a, b, c, d = rf.mix_inputs(1, 0, "cpu")
    with pytest.raises(ValueError):
        rf.mix_peak(a.to(torch.int64), b, c, d, 1)
    with pytest.raises(ValueError):
        rf.mix_peak(a[:, :32], b, c, d, 1)
    with pytest.raises(ValueError):
        rf.mix_peak(a, b.transpose(1, 2), c, d, 1)
    with pytest.raises(ValueError):
        rf.mix_peak(a, b, c, d, -1)


def test_measure_mix_peak_needs_the_card(monkeypatch):
    """The measurement is the card's: the default device raises without a
    GPU, and the CPU is refused outright."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rf.measure_mix_peak()
    with pytest.raises(ValueError, match="CUDA device"):
        rf.measure_mix_peak(device="cpu")


def test_operation_count_of_a_round():
    assert rf.OPS_PER_ROUND == 12 and rf.OPS_PER_ITER == 48
