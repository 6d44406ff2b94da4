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

`main` is the counterpart of the script's `main`: the mix's rate, K1's DP
alone on the benchmark's synthetic window graphs (`synth_graph_batch`, the
counterpart of `bench.py:synth_graph_batch`, the same arrays for a seed),
timed by CUDA events, and its share of the mix roofline. The DP's
operations a cell are K1's own count (18 a cell and 5 a real in-edge, as
`chip_smoke.py` counts them), not the TPU kernel's operation table. It
needs a card:

    python -m vechat_tpu_torch.utils.roofline
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

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


# K1's counted operations (chip_smoke.py's K1_OPS_CELL, K1_OPS_EDGE)
K1_OPS_CELL, K1_OPS_EDGE = 18, 5
# the DP-only timing's batch: bench.py's "full" stage (B, N, P, D, W), as
# scripts/roofline.py times it
DP_SHAPE = (64, 640, 8, ROWS, COLS)
DP_REPS = 10


def synth_graph_batch(B, N, P, D, W, seed=0):
    """Window-graph batch shaped like real correction work: POA graphs
    built from noisy copies of a random base (up to 4 of them, repeated
    over the batch), D noisy query sequences a graph, in K1's layout
    (codes, preds [B, P, N], sink, node_id, n_nodes, seqp [B, D, W] with
    lane j = position j - 1, seq_len [B, 1, D], numpy int32). Returns
    (arrays, real cells). The counterpart of `bench.py:synth_graph_batch`:
    the same arrays for the same arguments."""
    from ..ops.encode import encode
    from ..ops.graph_align import LinearAligner
    from ..ops.kernels.dense import graph_to_dense
    from ..ops.poagraph import PoaGraph

    rng = np.random.default_rng(seed)
    eng = LinearAligner("nw", 3, -5, -4)
    base_len = int((W - 1) * 0.9)

    def noisy(base):
        out = []
        for c in base:
            r = rng.random()
            if r < 0.04:
                out.append(rng.choice(list("ACGT")))
            elif r < 0.06:
                continue
            else:
                out.append(c)
                if rng.random() < 0.02:
                    out.append(rng.choice(list("ACGT")))
        return "".join(out)[: W - 1]

    codes = np.zeros((B, 1, N), np.int32)
    preds = np.zeros((B, P, N), np.int32)
    sink = np.ones((B, 1, N), np.int32)
    nid = np.zeros((B, 1, N), np.int32)
    nn = np.ones((B, 1, 1), np.int32)
    seqp = np.full((B, D, W), 0xFF, np.int32)
    seqp[:, :, 1] = 0
    slen = np.ones((B, 1, D), np.int32)

    built = []
    for _ in range(min(B, 4)):
        base = "".join(rng.choice(list("ACGT"), size=base_len))
        g = PoaGraph()
        while True:
            q = encode(noisy(base))
            aln = eng.align(q, g) if g.num_nodes() else []
            g.add_alignment(aln, q, np.ones(len(q), dtype=np.uint32))
            if g.num_nodes() > N - 80 or len(g.sequences) >= 8:
                break
        d = graph_to_dense(g, N, P)
        if d is None:
            continue
        qs = [encode(noisy(base)) for _ in range(D)]
        built.append((d, qs))

    for b in range(B):
        d, qs = built[b % len(built)]
        codes[b, 0] = d["codes"]
        preds[b] = d["preds"].T
        sink[b, 0] = d["is_sink"].astype(np.int32)
        nid[b, 0] = d["node_id"]
        nn[b, 0, 0] = d["n_nodes"]
        for di, q in enumerate(qs):
            seqp[b, di, 1 : 1 + len(q)] = q
            slen[b, 0, di] = len(q)
    cells = int((nn[:, 0, 0].astype(np.int64) * slen[:, 0].sum(axis=1)).sum())
    return [codes, preds, sink, nid, nn, seqp, slen], cells


def card_name_and_power_limit() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (its first line)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def dp_roofline(device="cuda", mix=None) -> dict:
    """K1's DP alone (`poa_linear.poa_dp`, nw at 3/-5/-4, the ring the
    batched backend would pick) on `synth_graph_batch(*DP_SHAPE)`: the
    median CUDA-event time of `DP_REPS` launches after a warm-up, its
    computed cells (n_nodes x D x W) and real ones (n_nodes x seq_len) a
    second, K1's counted operations a cell, and the share of the mix
    roofline (the mix's rate over those operations) that it reaches. `mix`
    is `measure_mix_peak`'s result (measured here when None)."""
    from ..ops.kernels import poa_linear as pl

    dev = _build.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the roofline is a measurement of the card: give a CUDA device")
    mix = mix or measure_mix_peak(device=dev)
    B, N, P, D, W = DP_SHAPE
    arrays, real_cells = synth_graph_batch(B, N, P, D, W)
    codes, preds, sink, _, nn, seqp, slen = arrays
    ring = max(1, max(pl.max_pred_distance(preds[b].T, int(nn[b, 0, 0])) for b in range(B)))
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (codes, preds, sink, nn, seqp,
                                                                      slen)]
    codes_t, preds_t, sink_t, nn_t, seqp_t, slen_t = t
    aux, deg = pl.pack_aux(preds_t, ring)
    args = (codes_t.reshape(B, N), aux, deg, sink_t.reshape(B, N), nn_t.reshape(B), seqp_t,
            slen_t.reshape(B, D), "nw", 3, -5, -4, ring)
    pl.poa_dp(*args)
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(DP_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pl.poa_dp(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    rows = int(nn.sum())
    live = torch.arange(N, device=dev)[None, :] < nn_t.reshape(B, 1)
    edges = int((deg * live).sum())
    computed = rows * D * W
    ops_cell = K1_OPS_CELL + K1_OPS_EDGE * edges / rows
    measured = computed / (ms * 1e-3)
    roof = mix["ops_per_s"] / ops_cell
    return dict(shape=f"B={B} N={N} P={P} D={D} W={W} ring={ring}", ms=ms,
                computed_cells=computed, real_cells=real_cells, ops_per_cell=ops_cell,
                measured_gcells_computed=measured / 1e9,
                measured_gcups_real=real_cells / (ms * 1e-3) / 1e9,
                roofline_gcells=roof / 1e9, mix_share=measured / roof)


def main(device="cuda") -> dict:
    """Print the card's name and power limit, the mix's sustained rate (K7),
    K1's DP alone on the synthetic batch and its share of the mix roofline,
    then one `ROOFLINE_RESULT {json}` line; return that object. Raises
    without a card."""
    dev = _build.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the roofline is a measurement of the card: give a CUDA device")
    gpu = card_name_and_power_limit()
    print(f"device: {gpu}", flush=True)
    mix = measure_mix_peak(device=dev)
    print(f"sustained int32 mix rate (K7): {mix['tops']:.3f} Tops/s", flush=True)
    dp = dp_roofline(device=dev, mix=mix)
    print(f"K1 dp alone at {dp['shape']}: {dp['ms']:.3f} ms | {dp['ops_per_cell']:.2f} counted "
          f"ops/cell | {dp['measured_gcups_real']:.2f} GCUPS real cells | "
          f"{dp['measured_gcells_computed']:.2f} Gcell/s computed", flush=True)
    print(f"roofline (mix rate / ops a cell): {dp['roofline_gcells']:.2f} Gcell/s; "
          f"share of it: {100 * dp['mix_share']:.1f}%", flush=True)
    result = dict(device=torch.cuda.get_device_name(dev), gpu=gpu, mix_peak_tops=mix["tops"],
                  **{k: v for k, v in dp.items()})
    print("ROOFLINE_RESULT " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
