"""The sustained rate of the POA DP kernels' int32 operation mix on the
card: the mix-peak kernel (K7, `csrc/mix_peak.cu`), its plain PyTorch
version and the measurement.

Counterpart of `scripts/roofline.py`: `mix_kernel` and `measure_mix_peak` of
the JAX package. Four chains a, b, c, d in a ring are each advanced `iters`
times by one round of 12 int32 operations (roll by one lane, add, max,
compare, select, shift, and, add, max, min, or, subtract) over [T, 64, 512]
tiles held in registers. The rate is the slope between `iters` and
`2 * iters` rounds, which removes the launch and the tiles' load and store.
It is what a kernel of this mix can reach on this card, to set beside the
data sheet's INT32 rate under every operation bound.

Two things differ from the TPU kernel, neither in the function a round
computes. The chains are inputs made from a seed and the final tiles are
outputs (the TPU kernel reads its scratch uninitialised, so its checksum is
not defined), so the plain version holds every lane. And there are T tiles
(by default one for each SM), where the TPU's one core has one.

The TPU script's operation table of the Pallas DP kernel and its `main`
(which needs the benchmark's synthetic graphs) are not part of this module.
"""

from __future__ import annotations

import ctypes
import statistics

import numpy as np
import torch

from ..ops.kernels import _build

ROWS, COLS = 64, 512
OPS_PER_ROUND = 12
OPS_PER_ITER = OPS_PER_ROUND * 4  # four chains a round each
# how the kernel rolls a row by one lane (the one operation that is no ALU work)
ROLL = "one __shfl_sync an element from lane-1; lane 31 offers its previous column"


def _round(x, y, kk):
    """One mix round on int32 tensors: scripts/roofline.py:88-100."""
    r = torch.roll(x, 1, dims=-1)
    s = r + y
    m = torch.maximum(s, x)
    sel = torch.where(m > y, m, x)
    an = (sel >> 2) & 0x7FFF
    ad = an + kk
    mn = torch.clamp(torch.maximum(ad, y), max=0x3FFFFFF)
    return (mn | 1) - y


def _mix_plain(a, b, c, d, iters: int, seed: int):
    """Plain PyTorch version of K7: `torch.roll` and elementwise operations,
    a Python loop over the rounds. Same outputs as the kernel, bit for bit."""
    for k in range(iters):
        kk = int(np.int32(k) + np.int32(seed))
        a = _round(a, b, kk)
        b = _round(b, c, kk)
        c = _round(c, d, kk)
        d = _round(d, a, kk)
    checksum = a[:, 0, 0] + b[:, 0, 0] + c[:, 0, 0] + d[:, 0, 0]
    return a, b, c, d, checksum


_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib():
    lib = _build.get_lib("mix_peak")
    if lib.mix_peak_launch.argtypes is None:
        lib.mix_peak_launch.argtypes = _ARGS
        lib.mix_peak_launch.restype = ctypes.c_int
    return lib


def mix_peak(a, b, c, d, iters: int, seed: int = 0):
    """K7. a, b, c, d [T, 64, 512] int32 on one device: the four chains.
    Returns their values after `iters` rounds each and the checksum [T]
    (`a[t, 0, 0] + b[t, 0, 0] + c[t, 0, 0] + d[t, 0, 0]`). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    dev = a.device
    for name, t in dict(a=a, b=b, c=c, d=d).items():
        if t.dim() != 3 or tuple(t.shape[1:]) != (ROWS, COLS) or t.shape != a.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected [T, {ROWS}, {COLS}]")
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
    if iters < 0:
        raise ValueError(f"iters={iters} is negative")
    if dev.type == "cpu":
        return _mix_plain(a, b, c, d, iters, seed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    T = a.shape[0]
    outs = [torch.empty_like(a) for _ in range(4)]
    checksum = torch.empty(T, dtype=torch.int32, device=dev)
    if T == 0:
        return (*outs, checksum)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().mix_peak_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
            *[o.data_ptr() for o in outs], checksum.data_ptr(),
            T, iters, seed, stream,
        )
    _build.check(_lib(), rc, "mix_peak")
    _build.LAUNCHES["mix_peak"] += 1
    return (*outs, checksum)


def mix_inputs(T: int, seed: int, device) -> tuple:
    """The four chains [T, 64, 512] int32, made from `seed` with numpy."""
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (T, ROWS, COLS), dtype=np.int32)).to(device)
        for _ in range(4)
    )


def measure_mix_peak(iters: int = 2000, device="cuda", seed: int = 0) -> dict:
    """The sustained rate of the mix on `device` (a CUDA device: the default
    raises without a GPU), in element operations a second. CUDA-event times
    of `iters` and `2 * iters` rounds, the median of 5 each after a warm-up;
    the rate is the extra rounds' operations over the extra time. One tile
    for each SM of the card. Returns the rate (`ops_per_s`, `tops`), both
    times and the shape."""
    dev = _build.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the mix peak is a measurement of the card: give a CUDA device")
    T = torch.cuda.get_device_properties(dev).multi_processor_count
    chains = mix_inputs(T, seed, dev)

    def time_ms(n):
        mix_peak(*chains, n, seed)
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            mix_peak(*chains, n, seed)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    ms1, ms2 = time_ms(iters), time_ms(2 * iters)
    elem_ops = OPS_PER_ITER * iters * T * ROWS * COLS  # the extra rounds of the second run
    ops_per_s = elem_ops / ((ms2 - ms1) * 1e-3)
    return dict(ops_per_s=ops_per_s, tops=ops_per_s / 1e12, ms_iters=ms1, ms_2iters=ms2,
                iters=iters, tiles=T, elem_ops=elem_ops, roll=ROLL)
