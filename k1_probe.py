#!/usr/bin/env python3
"""Probes of K1, the linear POA DP kernel of vechat_tpu_torch, of K2, its
run-length walk, of the dense walk, of K3, the banded NW kernel, of K5,
the affine POA DP kernel, and of K6, the convex one, on one NVIDIA GPU
(the timing) or on the output of `cuobjdump -sass` (K1's count).

    python3 k1_probe.py time DIR [DIR ...]   # DIR: the root of a checkout
    python3 k1_probe.py time-k3 [--inputs NPZ] DIR [DIR ...]
    python3 k1_probe.py time-k2 DIR [DIR ...]
    python3 k1_probe.py time-dense DIR [DIR ...]
    python3 k1_probe.py time-k5 DIR [DIR ...]
    python3 k1_probe.py time-k6 DIR [DIR ...]
    python3 k1_probe.py sass FILE            # cuobjdump -sass output or a .so

`time` runs K1 of each DIR's package in a process of its own, in the order
given (list A B B A to compare two versions in turns), on the window inputs
of chip_smoke.py's phase 1 (B=16 N=640 D=32 W=576 P=8, nw and sw, the
backend's ring and ring 511) and phase 3b (the main path's two heaviest
launch shapes as its phase 3 tallied them: B=14 N=640 D=55 and D=51 W=576
P=4, ring 511 in global memory), drawn from the same seeds, and at phase
1's shape with twice the windows (B=32: two warps to a scheduler where
phase 1 gives one, which tells latency from throughput). Each line is one
(DIR, shape): the CUDA-event median of 20 launches, chip_smoke.py's bound
for that work, and the share of K7's mix rate measured by the same process.

`sass` counts, for every poa_dp_kernel instantiation, the instructions a
thread executes for its lanes in one DP row, divided by its lanes (W/32):
the straight-line code from the in-edges' end to the ring and stage stores
(profile, in-row scan, direction code, run markers, packing: "per cell"),
and one guarded in-edge block after the first ("per in-edge"), each split
into the INT32 pipe's instructions (integer ALU, DPX min/max), IMAD (FMA
pipe), shared-memory and shuffle instructions (MIO) and the rest.

`time-k3` runs K3 of each DIR's package in a process of its own, in the
order given, on chip_smoke.py's phase 1 pairs (256 pairs at T=2560 BW=896,
drawn as that script draws them) and, with --inputs, on the launch that
`chip_smoke.py --save-k3 NPZ` kept (the main path's heaviest). Each case is
timed twice: the kernel as built, and a build of the same source whose
kernel stops after the DP rows (-DK3_ROWS_ONLY; for a source without that
switch, the earlier kernel with a thread per band lane, its walk cut by a
patch of the text), so the walk's share is the difference.

`time-k2` runs K2, the run-length walk, of each DIR's package in a process
of its own, in the order given, on the direction words of K1 at `time`'s
phase 1 and phase 3b inputs (the same draws; K1 of each DIR makes them),
and, where the package has it, the expansion of the walk's headers to
node-id pairs (the kernel alone, on the buffers its wrapper made). K2 is
timed through its wrapper (`walk_ms`: the zeroed header buffer, the kernel,
the read of `steps`; the CUDA-event median of 20 calls) and alone through
its C launcher, which both versions share, on buffers made once:
`walk_kernel_ms` on chip_smoke.py's K2_COPIES copies of the direction
words in turn, so that every launch reads them from device memory, and
`walk_kernel_warm_l2_ms` on one copy, so that a launch reads what the one
before left in the L2 (both, like `expand_ms`, launches in a CUDA graph
replayed between CUDA events, chip_smoke.py's `kernel_ms`; the expansion's
inputs stay in the L2, as on the main path). Each line is one (DIR, shape)
with chip_smoke.py's bounds, the headers of the longest walk and the pairs.

`time-dense` runs the dense walk (the sharded route's) of each DIR's package
in a process of its own, in the order given, on K1's direction words at
`time`'s phase 1 inputs (nw and sw, the backend's ring and 511) and at a
shard like phase 5a's largest (B=28 N=640 D=38 W=576 P=4, ring 221, nw;
window inputs of chip_smoke.py from their own seed): the wrapper (`ms`, the
CUDA-event median of 20 calls) and the kernel alone through the C launcher
both versions share (`kernel_ms`: chip_smoke.py's `kernel_ms` over
K2_COPIES copies of the direction words in turn, a cold L2), ranks in pn,
with chip_smoke.py's bound; then both goldens through the backend sharded
over two streams of the card, as phase 5a runs them, under the profiler:
`poa_walk_dense_kernel`'s and `poa_dp_kernel`'s seconds on the card, the
device's busy seconds and the wall, and whether the output is the golden.

`time-k5` runs K5 of each DIR's package in a process of its own, in the
order given, nw with the affine scores of chip_smoke.py's spoa path: at
the last launch of each of its (N, P) buckets (one block, B=1 D=1 W=576,
the graph grown read by read through that DIR's engine on the card, as
`gap_path_phase` grows it), at K1's batched shape (phase 1's 16 window
graphs, D=32, the backend's ring), and at one block (a window graph and
one read) at each of the spoa engine's widths 128, 320, 576, 768. Each
line is one (DIR, shape, lanes a thread): the kernel alone through its C
launcher on buffers made once (`kernel_ms`, chip_smoke.py's `kernel_ms`:
24 launches in a CUDA graph), the real rows and microseconds a row, the
rings' memory, the registers and spills ptxas reported for that
instantiation (`_build.ptxas_usage`, where the package keeps them) and
chip_smoke.py's bound; the line of the lanes the wrapper picks
(`default`) also has the wrapper's time (`ms`, the CUDA-event median of 20
calls). A package whose launcher takes the lanes a thread is timed at
every one its kernel is built for that divides W/32; one with a thread a
lane through its old launcher.

`time-k6` does the same for K6, with the launches of both of
chip_smoke.py's convex spoa runs (the command line's scores and those
within 8) and the command line's scores elsewhere.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

REPO = os.path.dirname(os.path.abspath(__file__))

# (label, seed offset, [(B, N, P, W, D), ...], modes, rings): inputs drawn in
# order from one generator, as chip_smoke.py draws them; ring None = the
# backend's (the largest predecessor distance)
SHAPES = [
    ("phase 1", 0, [(16, 640, 8, 576, 32)], ("nw", "sw"), (None, 511)),
    ("phase 3b", 2, [(14, 640, 4, 576, 55), (14, 640, 4, 576, 51)], ("nw",), (511,)),
    # twice phase 1's windows: two warps to each of the 528 schedulers, not one
    ("phase 1, 32 windows", 7, [(32, 640, 8, 576, 32)], ("nw",), (None,)),
]


def _time_one(pkg_dir):
    """Time K1 of the package under pkg_dir; prints one JSON line a case
    with its bound and its share of the measured mix rate (K7, this run)."""
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, pkg_dir)
    # this checkout's chip_smoke.py (its inputs and bounds), whatever DIR holds
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vechat_tpu_torch.ops.kernels import poa_linear as pl
    from vechat_tpu_torch.utils.roofline import measure_mix_peak

    assert pl.__file__.startswith(os.path.abspath(pkg_dir)), pl.__file__
    dev = torch.device("cuda")
    mix_ops_per_s = measure_mix_peak()["tops"] * 1e12
    for label, seed, shapes, modes, rings in SHAPES:
        rng = np.random.default_rng(cs.SEED + seed)
        for B, N, P, W, D in shapes:
            codes, preds, sink, nid, nn, seqp, slen = cs.window_inputs(rng, B, N, P, W, D)
            dist = max(pl.max_pred_distance(preds[b].T, nn[b, 0, 0]) for b in range(B))
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
            nn_t = t(nn).reshape(B)
            real_rows = torch.arange(N + 1, device=dev)[None, :] <= nn_t[:, None]
            for mode in modes:
                for ring in rings:
                    R = ring or max(1, dist)
                    aux, deg = pl.pack_aux(t(preds), R)
                    args = (t(codes).reshape(B, N), aux, deg, t(sink).reshape(B, N), nn_t,
                            t(seqp), t(slen).reshape(B, D), mode, 3, -5, -4, R)
                    ms = cs.time_ms(lambda: pl.poa_dp(*args), warmup=2, reps=20)
                    nbytes, ops = cs.k1_work(nn_t, deg, real_rows, P, D, W, seqp, slen)
                    b_ms, b_by = cs.bound_ms(nbytes, ops)
                    print(json.dumps(dict(
                        pkg=pkg_dir, shape=f"{label}: B={B} N={N} D={D} W={W} P={P} ring={R} {mode}",
                        ms=ms, bound_ms=b_ms, bound_by=b_by,
                        share_of_measured_mix_rate=ops / (ms * 1e-3) / mix_ops_per_s,
                        mix_tops=mix_ops_per_s / 1e12)), flush=True)


def _time_k2(pkg_dir):
    """Time K2 (and the expansion, where there is one) of the package under
    pkg_dir; prints one JSON line a case."""
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, pkg_dir)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vechat_tpu_torch.ops.kernels import poa_linear as pl

    assert pl.__file__.startswith(os.path.abspath(pkg_dir)), pl.__file__
    dev = torch.device("cuda")
    for label, seed, shapes, modes, rings in SHAPES[:2]:
        rng = np.random.default_rng(cs.SEED + seed)
        for B, N, P, W, D in shapes:
            codes, preds, sink, nid, nn, seqp, slen = cs.window_inputs(rng, B, N, P, W, D)
            dist = max(pl.max_pred_distance(preds[b].T, nn[b, 0, 0]) for b in range(B))
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
            nid_t = t(nid).reshape(B, N)
            for mode in modes:
                for ring in rings:
                    R = ring or max(1, dist)
                    aux, deg = pl.pack_aux(t(preds), R)
                    dirs, maxi, maxj, _ = pl.poa_dp(
                        t(codes).reshape(B, N), aux, deg, t(sink).reshape(B, N),
                        t(nn).reshape(B), t(seqp), t(slen).reshape(B, D), mode, 3, -5, -4, R)
                    L = N + W
                    runs, steps, count = pl.traceback_walk_rle(dirs, maxi, maxj, mode, L, P)
                    ms = cs.time_ms(lambda: pl.traceback_walk_rle(dirs, maxi, maxj, mode, L, P),
                                    warmup=2, reps=20)
                    # the kernel alone, through the launcher both versions share,
                    # on buffers made once (a walk rewrites only its own headers):
                    # on copies of dirs in turn (a cold L2), and on dirs alone
                    k_runs, k_count = torch.zeros_like(runs), torch.empty_like(count)
                    k_steps = torch.zeros(1, dtype=torch.int32, device=dev)
                    dirs_c = [dirs] + [dirs.clone() for _ in range(cs.K2_COPIES - 1)]
                    launch = lambda r: pl._lib().poa_walk_launch(  # noqa: E731
                        dirs_c[r].data_ptr(), maxi.data_ptr(), maxj.data_ptr(),
                        k_runs.data_ptr(), k_count.data_ptr(), k_steps.data_ptr(), B, N + 1, D,
                        W, L, P, pl.MODES[mode], torch.cuda.current_stream().cuda_stream)
                    kms = cs.kernel_ms(launch, copies=cs.K2_COPIES)
                    warm_ms = cs.kernel_ms(launch)
                    del dirs_c
                    assert torch.equal(k_runs, runs) and torch.equal(k_count, count)
                    used = runs != 0
                    headers = int(used.sum())
                    row = dict(pkg=pkg_dir, shape=f"{label}: B={B} N={N} D={D} W={W} P={P} "
                               f"ring={R} {mode}", walk_ms=ms, walk_kernel_ms=kms,
                               walk_kernel_warm_l2_ms=warm_ms, headers=headers,
                               longest_walk_headers=int(used.sum(dim=0).max()),
                               pairs=int(count.sum()))
                    row["walk_bound_ms"], _ = cs.bound_ms(*cs.k2_work(headers, B * D))
                    if hasattr(pl, "expand_walk_pairs"):
                        pairs, offsets = pl.expand_walk_pairs(runs, steps, count, nid_t)
                        cnt = count.reshape(-1)
                        err = torch.zeros(1, dtype=torch.int32, device=dev)
                        row["expand_ms"] = cs.kernel_ms(
                            lambda r: pl.launch_expand(runs, steps, cnt, offsets, nid_t, pairs,
                                                       err))
                        assert not int(err.item())
                        row["expand_bound_ms"], _ = cs.bound_ms(
                            *cs.expand_work(headers, B * D, nid_t.numel(), pairs.shape[0]))
                    print(json.dumps(row), flush=True)


def _time_dense(pkg_dir):
    """Time the dense walk of the package under pkg_dir, then profile phase
    5a's golden runs with it; prints one JSON line a case."""
    import importlib.util
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, pkg_dir)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vechat_tpu_torch.ops.kernels import poa_linear as pl

    assert pl.__file__.startswith(os.path.abspath(pkg_dir)), pl.__file__
    dev = torch.device("cuda")
    cases = [("phase 1", 0, (16, 640, 8, 576, 32), ("nw", "sw"), (None, 511)),
             ("5a-like shard", 11, (28, 640, 4, 576, 38), ("nw",), (221,))]
    for label, seed, (B, N, P, W, D), modes, rings in cases:
        rng = np.random.default_rng(cs.SEED + seed)
        codes, preds, sink, nid, nn, seqp, slen = cs.window_inputs(rng, B, N, P, W, D)
        dist = max(pl.max_pred_distance(preds[b].T, nn[b, 0, 0]) for b in range(B))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        for mode in modes:
            for ring in rings:
                R = ring or max(1, dist)
                aux, deg = pl.pack_aux(t(preds), R)
                dirs, maxi, maxj, _ = pl.poa_dp(
                    t(codes).reshape(B, N), aux, deg, t(sink).reshape(B, N), t(nn).reshape(B),
                    t(seqp), t(slen).reshape(B, D), mode, 3, -5, -4, R)
                L = N + W
                out = pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P)
                ms = cs.time_ms(lambda: pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P),
                                warmup=2, reps=20)
                pn, pp, count = (torch.empty_like(o) for o in out)
                dirs_c = [dirs] + [dirs.clone() for _ in range(cs.K2_COPIES - 1)]
                launch = lambda r: pl._lib().poa_walk_dense_launch(  # noqa: E731
                    dirs_c[r].data_ptr(), maxi.data_ptr(), maxj.data_ptr(), 0, pn.data_ptr(),
                    pp.data_ptr(), count.data_ptr(), B, N + 1, D, W, L, P, pl.MODES[mode],
                    torch.cuda.current_stream().cuda_stream)  # the capture's stream
                kms = cs.kernel_ms(launch, copies=cs.K2_COPIES)
                del dirs_c
                assert all(torch.equal(a, b) for a, b in zip((pn, pp, count), out))
                pairs = int(out[2].sum())
                b_ms, b_by = cs.bound_ms(pairs * 2 + 2 * B * D * L * 2 + B * D * 12,
                                         pairs * cs.WALK_OPS_STEP)
                print(json.dumps(dict(
                    pkg=pkg_dir, shape=f"{label}: B={B} N={N} D={D} W={W} P={P} ring={R} {mode}",
                    ms=ms, kernel_ms=kms, bound_ms=b_ms, bound_by=b_by, pairs=pairs,
                    longest_walk_pairs=int(out[2].max()))), flush=True)
    # phase 5a: both goldens through the backend sharded over two streams
    from vechat_tpu_torch.cli.vechat_main import build_parser, run
    from vechat_tpu_torch.io.fastx import write_fasta
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
    from vechat_tpu_torch.utils.logger import Logger

    with tempfile.TemporaryDirectory() as tmp:
        for reads, expected, extra in cs.GOLDENS:
            out_path = os.path.join(tmp, "out.fa")
            args = build_parser().parse_args([reads, "-o", out_path, "--backend", "cuda", *extra])
            backend = TorchAlignerBackend(args.match, args.mismatch, args.gap,
                                          devices=cs.SHARD_DEVICES)
            _build.reset_launches()
            dev_ms = {}
            (corrected, _), wall, busy = cs._profiled(lambda: run(args, Logger(), backend=backend),
                                                      True, dev_ms)
            write_fasta(corrected, out_path)
            print(json.dumps(dict(
                pkg=pkg_dir, run=f"5a {os.path.basename(reads)}", wall_s=wall, device_busy_s=busy,
                poa_walk_dense_kernel_device_s=cs.kernel_device_s(dev_ms, "poa_walk_dense_kernel"),
                poa_dp_kernel_device_s=cs.kernel_device_s(dev_ms, "poa_dp_kernel"),
                dense_launches=_build.LAUNCHES["poa_walk_dense"],
                byte_identical=cs._same_bytes(out_path, expected))), flush=True)


def _time_gap(pkg_dir, kind):
    """Time K5 (kind "affine") or K6 ("convex") of the package under
    pkg_dir; prints one JSON line a case."""
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, pkg_dir)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vechat_tpu_torch.ops.kernels import _build, poa_gap
    from vechat_tpu_torch.ops.kernels import poa_affine as pa
    from vechat_tpu_torch.ops.kernels import poa_convex as pc
    from vechat_tpu_torch.ops.kernels.poa_linear import MODES, SMEM_RING_MAX, max_pred_distance

    affine = kind == "affine"
    mod, k = (pa, "5") if affine else (pc, "6")
    assert mod.__file__.startswith(os.path.abspath(pkg_dir)), mod.__file__
    dp = getattr(mod, f"poa_dp_{kind}")
    launcher = getattr(mod, f"launch_dp_{kind}", None)
    n_rings = 2 if affine else 3
    smem_max = getattr(mod, f"K{k}_SMEM_RING_MAX", SMEM_RING_MAX)
    ops = (cs.K5_OPS_CELL, cs.K5_OPS_EDGE) if affine else (cs.K6_OPS_CELL, cs.K6_OPS_EDGE)
    score_sets = ([("", cs.AFFINE_SCORES)] if affine else
                  [("default ", cs.CONVEX_SCORES), ("within 8 ", cs.CONVEX_SMALL_SCORES)])
    dev = torch.device("cuda")
    reads = cs.spoa_reads(np.random.default_rng(cs.SEED + 1))
    cases = []
    for label, scores in score_sets:
        cases += [(f"spoa {label}{shape}", arrays, ring, scores) for shape, (arrays, ring)
                  in sorted(cs.spoa_launch_inputs(dev, reads, scores).items())]
    inputs = cs.window_inputs(np.random.default_rng(cs.SEED), B=16, N=640, P=8, W=576, D=32)
    preds, nn = inputs[1], inputs[4]
    dist = max(max_pred_distance(preds[b].T, nn[b, 0, 0]) for b in range(preds.shape[0]))
    cases.append(("K1's batched shape", inputs, dist, score_sets[0][1]))
    # one block at each width bucket of the spoa engine (a window graph and
    # one read, as the engine launches them), for the lanes a thread per W
    for W in (128, 320, 576, 768):
        arrays = cs.window_inputs(np.random.default_rng(cs.SEED + 3), B=1, N=1152, P=8, W=W, D=1)
        dist = max_pred_distance(arrays[1][0].T, arrays[4][0, 0, 0])
        cases.append((f"one block at W={W}", arrays, max(dist, 1), score_sets[0][1]))
    for label, arrays, R, scores in cases:
        codes, preds, sink, nid, nn, seqp, slen = arrays
        B, P, N = preds.shape
        D, W = seqp.shape[1], seqp.shape[2]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        nn_t = t(nn).reshape(B)
        real_rows = torch.arange(N + 1, device=dev)[None, :] <= nn_t[:, None]
        aux, deg = pa.pack_aux_gap(t(preds), R)
        args = (t(codes).reshape(B, N), aux, deg, t(sink).reshape(B, N), nn_t, t(seqp),
                t(slen).reshape(B, D), "nw", *scores, R)
        ref = dp(*args)
        ms = cs.time_ms(lambda: dp(*args), warmup=2, reps=20)
        out = poa_gap.dp_buffers(B, N, D, W, R, n_rings, dev, smem_max)
        in_smem = out[4] is None
        if launcher is not None:
            lpts = [n for n in getattr(mod, f"K{k}_LPTS") if (W // 32) % n == 0]
            default = getattr(mod, f"k{k}_lanes_per_thread")(W)
        else:  # a thread a lane, its launcher without the lanes argument
            lpts, default = [None], None
        usage = getattr(_build, "ptxas_usage", lambda name: {})(f"poa_{kind}")
        nbytes, n_ops = cs.gap_dp_work(nn_t, deg, real_rows, P, D, W, seqp, slen, *ops)
        b_ms, b_by = cs.bound_ms(nbytes, n_ops)
        n_rows = int(nn_t.sum())
        for lpt in lpts:
            regs = {}
            if lpt is None:
                dirs, maxi, maxj, score, rings = out
                codes_args = ((pa.sh_bits_aff(P), pa.shf_bits(P)) if affine else
                              (pc.sh_bits_cvx(P), pc.shf_bits_cvx(P), int(np.ceil(np.log2(W)))))
                launch = lambda r: getattr(mod._lib(), f"poa_dp_{kind}_launch")(  # noqa: E731
                    *(a.data_ptr() for a in args[:7]), dirs.data_ptr(), maxi.data_ptr(),
                    maxj.data_ptr(), score.data_ptr(), 0 if rings is None else rings.data_ptr(),
                    B, N, P, D, W, R, MODES["nw"], *scores, int(rings is None), *codes_args,
                    torch.cuda.current_stream().cuda_stream)
            else:
                launch = lambda r: launcher(*args, out, lpt)  # noqa: E731
                key = f"poa_dp_{kind}_kernelILi{lpt}ELb0ELb{int(in_smem)}E"
                regs = next((v for name, v in usage.items() if key in name), {})
            kms = cs.kernel_ms(launch)
            assert torch.equal(out[0][real_rows], ref[0][real_rows])
            assert all(torch.equal(a, b) for a, b in zip(out[1:4], ref[1:]))
            print(json.dumps(dict(
                pkg=pkg_dir, shape=f"{label}: B={B} N={N} D={D} W={W} P={P} ring={R} nw",
                scores="/".join(map(str, scores)), lanes_per_thread=lpt, default=lpt == default,
                ms=ms if lpt == default else None, kernel_ms=kms, rows=n_rows,
                us_per_row=kms * 1e3 / n_rows, ring_memory="shared" if in_smem else "global",
                registers=regs.get("registers"), spill_stores=regs.get("spill_stores"),
                spill_loads=regs.get("spill_loads"), bound_ms=b_ms, bound_by=b_by)), flush=True)


def _rows_only_lib(_build):
    """DIR's pairwise_nw.cu built with its K3 kernel stopping after the DP
    rows, loaded with ctypes."""
    import ctypes
    import tempfile

    with open(os.path.join(_build.CSRC, "pairwise_nw.cu")) as f:
        text = f.read()
    if "K3_ROWS_ONLY" not in text:
        # the earlier kernel, a thread per lane: thread 0 walks after `if (l != 0) return;`
        cut = "  if (l != 0) return;\n  const int ls = lq - lt - lod;"
        assert text.count(cut) == 1, "unknown K3 source"
        text = text.replace(cut, "  return;\n" + cut)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    src = os.path.join(tmp, "pairwise_nw_rows.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(tmp, "libpairwise_nw_rows.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DK3_ROWS_ONLY", "-I", _build.CSRC,
                    "-o", lib, src], check=True, capture_output=True)
    return ctypes.CDLL(lib)


def _time_k3(pkg_dir, inputs_path):
    """Time K3 of the package under pkg_dir, whole and rows only; prints one
    JSON line a (case, build) with its bound."""
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, pkg_dir)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw

    assert pw.__file__.startswith(os.path.abspath(pkg_dir)), pw.__file__
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    cs.window_inputs(rng, B=16, N=640, P=8, W=576, D=32)  # phase 1's draws before K3's
    cases = [("phase 1", cs.k3_inputs(rng, dev), 896)]
    if inputs_path:
        z = np.load(inputs_path)
        t = lambda k: torch.from_numpy(z[k]).to(dev)  # noqa: E731
        cases.append(("main path's heaviest", tuple(t(k) for k in cs.K3_ARGS), int(z["BW"])))
    whole = pw._lib()
    rows_only = _rows_only_lib(_build)
    for label, args, BW in cases:
        NP, T = args[0].shape
        for build, lib in (("whole", whole), ("rows only", rows_only)):
            _build._libs["pairwise_nw"] = lib
            pw._lib()  # sets the argument types of a fresh library
            ms = cs.time_ms(lambda: pw.banded_nw(*args, BW), warmup=2, reps=20)
            b_ms, b_by = cs.bound_ms(*cs.k3_work(args[2], T, BW))
            print(json.dumps(dict(pkg=pkg_dir, shape=f"{label}: NP={NP} T={T} BW={BW}",
                                  build=build, ms=ms, bound_ms=b_ms, bound_by=b_by)),
                  flush=True)
        _build._libs["pairwise_nw"] = whole


INT32 = re.compile(r"^(IADD3|LOP3|SHF|ISETP|SEL|VIMNMX|VIADDMNMX|VIMNMX3|VIADD|PRMT|LEA|IABS|"
                   r"IMNMX|FLO|POPC|BMSK|P2R|R2P|PLOP3)")


def _pipe(op):
    if INT32.match(op):
        return "int32"
    if op.startswith("IMAD"):
        return "imad"
    if op.startswith(("LDS", "STS", "SHFL")):
        return "mio"
    return "other"


def sass_counts(text):
    """{instantiation: counts} from cuobjdump -sass text."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        m = re.search(r"poa_dp_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)ELb(\d)E", name)
        if not m:
            continue
        lpt, pmax, smem, exact, sw = (int(v) for v in m.groups())
        if not exact:
            continue
        ins = []
        for line in fn.splitlines():
            mm = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if mm:
                text_i = re.sub(r"^@!?U?P[T0-9]+\s+", "", mm.group(2))
                ins.append((int(mm.group(1), 16), text_i.split()[0], text_i))
        addr = [a for a, _, _ in ins]

        def region(lo, hi):
            return Counter(_pipe(op) for a, op, _ in ins if lo <= a < hi)

        # the warp scan's last step (shuffle up by 16) is unique
        scan = next(a for a, op, t in ins if op.startswith("SHFL.UP") and ", 0x10," in t)
        back = [a for a, op, t in ins if op.startswith("BRA") and a < scan
                and int(t.split()[-1], 16) < a]
        start = max(back) + 16
        stores = [a for a, op, _ in ins if op.startswith("STS") and a > scan]
        copy = min(a for a, op, _ in ins if op.startswith("LDS.128") and a > scan)
        end = max(a for a in stores if a < copy) + 16
        # guarded in-edge blocks: "@!P BRA skip" then the aux shuffle
        edges = []
        for k, (a, op, t) in enumerate(ins[:-1]):
            if op == "BRA" and ins[k + 1][1].startswith("SHFL.IDX"):
                skip = int(t.split()[-1], 16)
                body = [o for b, o, _ in ins if a < b < skip]
                if (any(o.startswith(("LDS", "LDG")) for o in body)
                        and sum(o.startswith("SHFL") for o in body) == 2):
                    edges.append((a, skip))
        cell = region(start, end)
        edge = region(*edges[1]) if len(edges) > 1 else Counter()
        out[f"LPT={lpt} PMAX={pmax} smem={smem} sw={sw}"] = dict(
            lanes=lpt, instructions=len(addr),
            per_cell={k: v / lpt for k, v in sorted(cell.items())},
            per_in_edge={k: v / lpt for k, v in sorted(edge.items())})
    return out


def main(argv):
    if len(argv) >= 2 and argv[0] == "time":
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        for d in argv[1:]:
            rc = subprocess.run([sys.executable, __file__, "_time", os.path.abspath(d)]).returncode
            if rc:
                return rc
        return 0
    if len(argv) == 2 and argv[0] == "_time":
        _time_one(argv[1])
        return 0
    if len(argv) >= 2 and argv[0] == "time-k3":
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        inputs = ""
        dirs = argv[1:]
        if dirs[0] == "--inputs":
            inputs, dirs = os.path.abspath(dirs[1]), dirs[2:]
        for d in dirs:
            rc = subprocess.run([sys.executable, __file__, "_time_k3", os.path.abspath(d),
                                 inputs]).returncode
            if rc:
                return rc
        return 0
    if len(argv) == 3 and argv[0] == "_time_k3":
        _time_k3(argv[1], argv[2])
        return 0
    if len(argv) >= 2 and argv[0] == "time-k2":
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        for d in argv[1:]:
            rc = subprocess.run([sys.executable, __file__, "_time_k2", os.path.abspath(d)]).returncode
            if rc:
                return rc
        return 0
    if len(argv) == 2 and argv[0] == "_time_k2":
        _time_k2(argv[1])
        return 0
    if len(argv) >= 2 and argv[0] == "time-dense":
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        for d in argv[1:]:
            rc = subprocess.run([sys.executable, __file__, "_time_dense",
                                 os.path.abspath(d)]).returncode
            if rc:
                return rc
        return 0
    if len(argv) == 2 and argv[0] == "_time_dense":
        _time_dense(argv[1])
        return 0
    if len(argv) >= 2 and argv[0] in ("time-k5", "time-k6"):
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        kind = "affine" if argv[0] == "time-k5" else "convex"
        for d in argv[1:]:
            rc = subprocess.run([sys.executable, __file__, "_time_gap", kind,
                                 os.path.abspath(d)]).returncode
            if rc:
                return rc
        return 0
    if len(argv) == 3 and argv[0] == "_time_gap":
        _time_gap(argv[2], argv[1])
        return 0
    if len(argv) == 2 and argv[0] == "sass":
        path = argv[1]
        if path.endswith(".so"):
            tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
            text = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                                  check=True).stdout
        else:
            with open(path) as f:
                text = f.read()
        for k, v in sass_counts(text).items():
            print(json.dumps(dict(kernel=k, **v)))
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
