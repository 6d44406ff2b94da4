#!/usr/bin/env python3
"""Probes of K1, the linear POA DP kernel of vechat_tpu_torch, of K2, its
run-length walk, of the dense walk, of K3, the banded NW kernel, of K5,
the affine POA DP kernel, of K6, the convex one, of K5w and K6w, their
three-state walk, and of F1 and F2, B10's full-matrix DP and its walk,
on one NVIDIA GPU (the timing) or on the output of
`cuobjdump -sass` (K1's count).

    python3 k1_probe.py time DIR [DIR ...]   # DIR: the root of a checkout
    python3 k1_probe.py time-k3 [--inputs NPZ] DIR [DIR ...]
    python3 k1_probe.py time-k4 [--inputs NPZ] DIR [DIR ...]
    python3 k1_probe.py time-k2 DIR [DIR ...]
    python3 k1_probe.py time-dense DIR [DIR ...]
    python3 k1_probe.py time-k5 DIR [DIR ...]
    python3 k1_probe.py time-k6 DIR [DIR ...]
    python3 k1_probe.py time-walk3 DIR [DIR ...]
    python3 k1_probe.py time-full [--inputs NPZ] DIR [DIR ...]
    python3 k1_probe.py time-build [--inputs NPZ] DIR [DIR ...]
    python3 k1_probe.py latency              # a warp's dependent-operation latencies
    python3 k1_probe.py repeat-k7 N          # K7 held to its plain version N times
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

`time-k4` does the same for K4, the tiled NW kernel, on chip_smoke.py's
phase 1 tiles (64 tiles at T=W=512, drawn as that script draws them) and,
with --inputs, on the launches that `chip_smoke.py --save-k4 NPZ` kept:
the main path's heaviest, and every K4 launch of its phase 3 as one case.
Builds: the kernel as built, rows only, and for the present design (4
warps of 4 lanes a thread at W = 512) its other layout, one warp of 16
lanes a thread with no block barrier, by a patch of the text. Each build
is held to the plain version first (rows only excepted), then its wrapper
(`ms`, the CUDA-event median of 20 calls; `wrapper_host_us`, the host's
microseconds a call over 50 calls queued without a wait) and the kernel
alone through its C launcher on buffers made once (`kernel_ms`,
chip_smoke.py's `kernel_ms`: 24 launches in a CUDA graph), each summed
over the case's launches, with the rows, the walks' steps and
chip_smoke.py's bound, and ptxas's registers and spills of the kernel's
instantiations. For the earlier kernel (a thread per lane, a direction
byte a cell) the rows-only build cuts its walk by a patch of the text.

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

`time-walk3` runs K5w and K6w, the three-state walks, of each DIR's package
in a process of its own, in the order given, nw on the direction words of
that DIR's K5 (affine scores) and K6 (the convex scores within 8) at the
last launch of each of the spoa path's (N, P) buckets, as `time-k5` grows
them, and at K1's batched shape (B=16 D=32: 512 walks). Each line is one
(DIR, kernel, shape): the wrapper in DP ranks (`ms`, and `ms_node_ids` for
a package whose walk writes node ids; CUDA-event medians of 20 calls; the
host's microseconds a call, `wrapper_host_us`, and those of the C launcher
alone, `launch_host_us`, over 50 calls queued without a wait), the
kernel alone through its C launcher on buffers made once (`kernel_ms`,
chip_smoke.py's `kernel_ms`: 24 launches in a CUDA graph; a tiled walk
with the tiles its walks staged), the longest walk's
steps and the microseconds a step, and ptxas's registers and spills of
each walk instantiation. Last, K5w on three straight walks of 1000 steps
(a diagonal, a column, a row), which tell a step's cost from a tile's.

`time-full` runs F1 and F2, B10's full-matrix DP and its walk
(`vechat_tpu_torch/csrc/poa_full.cu`), of each DIR's package in a process
of its own, in the order given, on phase 9a's inputs in nw, sw and ov and
on 9b's heaviest launch in its mode (both from `chip_smoke.py --save-full
NPZ`; without --inputs, a 9a-like batch drawn by chip_smoke.py's
`full_window_inputs` from its own seed, and no 9b case), then, for a
package with F1's ring, at the S buckets 63, 127 and 255 on batches of 64
drawn the same way. Each package's outputs are held to the
plain versions first (H where F1 writes it, the pairs, counts and
scores). Each line is one (DIR, case, mode): F1's and F2's wrappers (`ms`, the CUDA-event median of 20 calls)
and kernels alone (`kernel_ms`, chip_smoke.py's `kernel_ms`: 24 launches
in a CUDA graph), µs a row and a step (the largest window's rows, the
longest walk's steps), with ptxas's registers of each kernel.

`time-build` runs G4, G5 and G3, the device build's fusion walk,
reachability and bundled topological order
(`vechat_tpu_torch/csrc/graph_build.cu`), G1 and G2, the prune cycle's
DFS and topological order (`csrc/graph_cycle.cu`), and G6, round 2's
heaviest bundle (`csrc/graph_consensus.cu`), of each DIR's package in a
process of its own, in the order given, on the inputs of phase 7's
heaviest G3, G4 and G5 launch, phase 6's heaviest G1 and G2 launch and
phase 8's heaviest G6 launch at N = 256, 1152 and 2048, as
`chip_smoke.py --save-build NPZ` saved them; an N that phase 7 did not
launch (or every N, without --inputs) is filled by a device build of 64
windows drawn by chip_smoke.py's `synth_build_batch` at that N, this
checkout's package capturing its heaviest launches, one that phase 6
did not by G1's and G2's inputs on 64 DAGs drawn by `synth_dfs_batch`
and `synth_rank_batch`, and one that phase 8 did not by G6's inputs from
`device_linear` on 64 windows of `synth_bundle_batch`. G2 and G6 are
timed as `_time_rank_bundle` says. Each package's outputs are held to
the plain versions first. Each line is one
(DIR, kernel, N): the wrapper as the build or the cycle calls it (`ms`:
G4's in-place call without checks, G5's `reach_keep`, G3's and G1's
without checks; for a package without `fuse_walk_`, G4's copying
`fuse_walk` and G5's `reach_keep` with its torch-sorted CSR, as its
build called them; for one without the check switch, G3's and G1's
wrappers as they were), the kernel alone (`kernel_ms`, chip_smoke.py's
`kernel_ms`; G4 less the graph's copies back), for a package with
`fuse_walk_` also G4 alone with every window inactive, so that it stages
and writes back its windows and walks none (`inactive_ms`), µs a step
(G4: the positions and pairs of the longest walk; G3 and G1: two a node
of the largest window or component, or G3's step cap, topo_steps(N),
where a window's machine runs to it) or a node (G5: the most nodes a
window keeps), G3 and G1 alone with nothing to walk (`idle_ms`: no node
to rank, every root outside its component), the form each took, with the
card's name and power limit.

`latency` times, in one warp with clock64(), the dependent chains a step of
the graph walks (G1, G3) is made of: a multiply-add (the loop's own cost,
taken from the others), a shared load, a shuffle, a ballot, a ballot with
its first lane and a shuffle from it, a shared load through the ballot
and the shuffle to a second shared load, the first candidate's value by
a ballot and a max reduction instead, a shared load through a min
reduction to a second shared load, lane 0's store or atomicOr followed
by __syncwarp and a load; with the SM clock over the run, from
%globaltimer. One JSON line of cycles a link.

`repeat-k7` launches K7, the mix-peak kernel of this checkout, N times at
each of chip_smoke.py's check depths (1 and 8 rounds, its seed, a tile for
each SM) and holds every run to the plain version's outputs, computed once
a depth. One JSON line a depth: the runs, the runs that differed, and for
the first of those the element and both values; then the card's volatile
ECC error counts before and after, as chip_smoke.py reads them. It tells a
fault of the card that does not repeat from one of the kernel.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
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


def _time_walk3(pkg_dir):
    """Time K5w and K6w of the package under pkg_dir; prints one JSON line a
    case."""
    import importlib.util
    import time

    import numpy as np
    import torch

    sys.path.insert(0, pkg_dir)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vechat_tpu_torch.ops.kernels import _build, poa_gap
    from vechat_tpu_torch.ops.kernels import poa_affine as pa
    from vechat_tpu_torch.ops.kernels import poa_convex as pc
    from vechat_tpu_torch.ops.kernels.poa_linear import MODES, max_pred_distance

    assert poa_gap.__file__.startswith(os.path.abspath(pkg_dir)), poa_gap.__file__
    tiled = hasattr(poa_gap, "launch_walk3")  # else one thread a walk
    dev = torch.device("cuda")

    def host_us(fn, n=50):  # the host's time a call, the launches queued
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    reads = cs.spoa_reads(np.random.default_rng(cs.SEED + 1))
    inputs = cs.window_inputs(np.random.default_rng(cs.SEED), B=16, N=640, P=8, W=576, D=32)
    preds, nn = inputs[1], inputs[4]
    dist = max(max_pred_distance(preds[b].T, nn[b, 0, 0]) for b in range(preds.shape[0]))
    def time_case(mod, kernel, label, dirs, maxi, maxj, L, P, nid_t, usage):
        """One JSON line: the walk of `mod` on these words, nw."""
        walk = getattr(mod, f"traceback_{kernel[4:]}")
        B, N1, D, W = dirs.shape
        ref = walk(dirs, maxi, maxj, "nw", L, P)
        row = dict(pkg=pkg_dir, kernel=kernel, shape=label,
                   design="warp a walk" if tiled else "thread a walk",
                   ms=cs.time_ms(lambda: walk(dirs, maxi, maxj, "nw", L, P), warmup=2, reps=20),
                   wrapper_host_us=host_us(lambda: walk(dirs, maxi, maxj, "nw", L, P)))
        out = tuple(torch.empty_like(x) for x in ref)
        if tiled:
            row["ms_node_ids"] = cs.time_ms(
                lambda: walk(dirs, maxi, maxj, "nw", L, P, nid_t), warmup=2, reps=20)
            tiles = torch.zeros((B, D), dtype=torch.int32, device=dev)
            launch = lambda r: poa_gap.launch_walk3(  # noqa: E731
                mod._lib, kernel, dirs, maxi, maxj, None, out, "nw", L, P, tiles=tiles)
            row["kernel_ms"] = cs.kernel_ms(launch)
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
            row["tiles_max"] = int(tiles.max())
            row["tiles_mean"] = float(tiles.float().mean())
            row["launch_host_us"] = host_us(lambda: launch(0))
        else:  # its launcher writes the pairs into rows filled with -2
            for x in out[:2]:
                x.fill_(-2)
            launch = lambda r: getattr(mod._lib(), f"{kernel}_launch")(  # noqa: E731
                dirs.data_ptr(), maxi.data_ptr(), maxj.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), B, N1, D, W, L, P, MODES["nw"],
                torch.cuda.current_stream().cuda_stream)
            row["kernel_ms"] = cs.kernel_ms(launch)
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
        steps = int(ref[2].max())
        row.update(steps=steps, us_per_step=row["kernel_ms"] * 1e3 / max(steps, 1),
                   walks=B * D, pairs=int(ref[2].sum()), ptxas=usage)
        print(json.dumps(row), flush=True)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    for kind, mod, scores in (("affine", pa, cs.AFFINE_SCORES),
                              ("convex", pc, cs.CONVEX_SMALL_SCORES)):
        dp = getattr(mod, f"poa_dp_{kind}")
        kernel = f"poa_walk_{kind}"
        cases = [(f"spoa {shape}", arrays, ring) for shape, (arrays, ring)
                 in sorted(cs.spoa_launch_inputs(dev, reads, scores).items())]
        cases.append(("K1's batched shape", inputs, dist))
        usage = {name: v for name, v in _build.ptxas_usage(f"poa_{kind}").items()
                 if "walk3_kernel" in name}
        for label, arrays, R in cases:
            codes, preds, sink, nid, nn, seqp, slen = arrays
            B, P, N = preds.shape
            D, W = seqp.shape[1], seqp.shape[2]
            aux, deg = pa.pack_aux_gap(t(preds), R)
            dirs, maxi, maxj, _ = dp(t(codes).reshape(B, N), aux, deg, t(sink).reshape(B, N),
                                     t(nn).reshape(B), t(seqp), t(slen).reshape(B, D), "nw",
                                     *scores, R)
            time_case(mod, kernel, f"{label}: B={B} N={N} D={D} W={W} P={P} ring={R} nw",
                      dirs, maxi, maxj, 2 * N + W, P, t(nid).reshape(B, N), usage)
    # straight walks of 1000 steps (K5w, P=1, one walk): a step's and a
    # tile's cost apart. A diagonal leaves a 64 x 32 tile every 32 steps,
    # a column every 64 steps; a row's tiles are one row.
    K, P, n = 1, 1, 1000
    prio = lambda hidx: (3 * (P + 1) - 1 - hidx) << 9  # noqa: E731
    words = {"diagonal": prio(0) | 1, "column": prio(P + 1) | 1, "row": prio(3 * P + 1)}
    starts = {"diagonal": (n, n), "column": (n, 0), "row": (0, n)}
    for label, word in words.items():
        dirs = np.full((1, n + 1, 1, 1024), word, np.int32)
        dirs[0, 0, 0, :] = words["row"]  # the boundary row and column lead to (0, 0)
        dirs[0, :, 0, 0] = words["column"]
        i0, j0 = starts[label]
        time_case(pa, "poa_walk_affine", f"straight {label}: {n} steps, N1={n + 1} W=1024",
                  t(dirs), t(np.array([[i0]], np.int32)), t(np.array([[j0]], np.int32)),
                  2 * n + 1024, P, t(np.arange(n, dtype=np.int32)[None]), {})


# One warp timing its own dependent chains with clock64(): the operations a
# step of the graph kernels' walks (G1, G3) chains, each a loop of `iters`
# links, and the SM clock from %globaltimer over the whole run.
_LATENCY_SRC = r"""
#include <cuda_runtime.h>
constexpr unsigned kFull = 0xffffffffu;
__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__global__ void latency_kernel(long long* out, int iters) {
  __shared__ int s[1024];
  __shared__ unsigned bits[64];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) s[i] = (i + 32) & 1023;
  bits[lane] = bits[lane + 32] = 0;
  __syncwarp();
  const long long ns0 = now_ns(), c0 = clock64();
  long long t;
  int p = lane, k = 0;
  unsigned a = lane;
  // 0: a dependent integer multiply-add, the loop's own cost
  t = clock64();
  for (int i = 0; i < iters; ++i) a = a * 3u + 1u;
  out[k++] = clock64() - t;
  // 1: a dependent shared load
  t = clock64();
  for (int i = 0; i < iters; ++i) p = s[p];
  out[k++] = clock64() - t;
  // 2: a dependent shuffle
  int x = lane;
  t = clock64();
  for (int i = 0; i < iters; ++i) x = __shfl_sync(kFull, x, (lane + 1) & 31);
  out[k++] = clock64() - t;
  // 3: a ballot of the last one's bit
  unsigned b = lane;
  t = clock64();
  for (int i = 0; i < iters; ++i) b = __ballot_sync(kFull, (b >> lane) & 1u) ^ 0x55555555u;
  out[k++] = clock64() - t;
  // 4: a step's decision: the ballot, its first lane, a shuffle from it
  int y = lane;
  t = clock64();
  for (int i = 0; i < iters; ++i) {
    const unsigned bb = __ballot_sync(kFull, ((y + i) & 3) == 0);
    y = __shfl_sync(kFull, y, bb ? __ffs(bb) - 1 : 0) + lane;
  }
  out[k++] = clock64() - t;
  // 5: a step's chain: a shared load, the ballot of its bit, a shuffle
  // from the first set lane, a shared load at the shuffled index
  int q = lane;
  t = clock64();
  for (int i = 0; i < iters; ++i) {
    const int v = s[q];
    const unsigned bb = __ballot_sync(kFull, (v & 32) == 0);
    const int w = __shfl_sync(kFull, v, bb ? __ffs(bb) - 1 : 0);
    q = (w + lane) & 1023;
  }
  out[k++] = clock64() - t;
  // 5b: the same decision by a reduction: the first candidate lane's value
  int z = lane;
  t = clock64();
  for (int i = 0; i < iters; ++i) {
    const bool c = ((z + i) & 3) == 0;
    const unsigned bb = __ballot_sync(kFull, c);
    const bool first = c && !(bb & ((1u << lane) - 1));
    z = __reduce_max_sync(kFull, first ? z : -1) + lane;
  }
  out[k++] = clock64() - t;
  // 5c: a step's chain with a reduction: a shared load, the least lane
  // whose value passes, with its value, a shared load at that value
  int q2 = lane;
  t = clock64();
  for (int i = 0; i < iters; ++i) {
    const int v = s[q2];
    const int f = __reduce_min_sync(kFull, (v & 32) ? 0x7fffffff : (lane << 13) | v);
    q2 = ((f & 1023) + lane) & 1023;
  }
  out[k++] = clock64() - t;
  // 6: lane 0 stores, the warp synchronises, a lane loads what it stored
  int r = lane;
  t = clock64();
  for (int i = 0; i < iters; ++i) {
    if (lane == 0) s[r & 1023] = (r + 32) & 1023;
    __syncwarp();
    r = s[r & 1023];
  }
  out[k++] = clock64() - t;
  // 7: lane 0 sets a bit by atomicOr, the warp synchronises, a lane reads it
  unsigned m = lane;
  t = clock64();
  for (int i = 0; i < iters; ++i) {
    if (lane == 0) atomicOr(&bits[m & 63], 1u << (i & 31));
    __syncwarp();
    m = bits[(m + 1) & 63] + m;
  }
  out[k++] = clock64() - t;
  const long long c1 = clock64(), ns1 = now_ns();
  if (lane == 0) {
    out[k++] = c1 - c0;
    out[k++] = ns1 - ns0;
    out[k++] = (long long)a + p + x + b + y + q + z + q2 + r + m;
  }
}
extern "C" int latency_launch(long long* out, int iters, void* stream) {
  latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
_LATENCY_NAMES = ("imad", "lds", "shfl", "ballot", "ballot_ffs_shfl", "lds_ballot_shfl_lds",
                  "ballot_first_reduce", "lds_reduce_lds", "sts_syncwarp_lds",
                  "atoms_syncwarp_lds")


def _latency(iters=4096):
    """Cycles a link of each chain of _LATENCY_SRC (less the loop's
    multiply-add for the others), and the SM clock of the run; one JSON
    line."""
    import ctypes

    import torch

    sys.path.insert(0, REPO)
    from vechat_tpu_torch.ops.kernels import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "latency_probe.cu")
    with open(src, "w") as f:
        f.write(_LATENCY_SRC)
    lib_path = os.path.join(_build.BUILD_DIR, "liblatency_probe.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.latency_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    out = torch.zeros(len(_LATENCY_NAMES) + 3, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):  # the last of three runs, the clock settled
        assert lib.latency_launch(out.data_ptr(), iters, stream) == 0
        torch.cuda.synchronize()
    vals = out.tolist()
    base = vals[0] / iters
    line = {name: v / iters - (base if i else 0) for i, (name, v) in
            enumerate(zip(_LATENCY_NAMES, vals))}
    line["sm_mhz"] = vals[len(_LATENCY_NAMES)] / vals[len(_LATENCY_NAMES) + 1] * 1e3
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(probe="latency", cycles_a_link=line, iters=iters, gpu=gpu)),
          flush=True)


def _repeat_k7(n):
    """K7 against its plain version n times at each of chip_smoke.py's check
    depths; prints one JSON line a depth and the ECC counts."""
    import importlib.util

    import torch

    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vechat_tpu_torch.utils import roofline as rf

    ecc = cs.gpu_ecc()
    dev = torch.device("cuda")
    T = torch.cuda.get_device_properties(dev).multi_processor_count
    chains = rf.mix_inputs(T, cs.SEED, dev)
    for iters in (1, 8):
        plain = rf._mix_plain(*chains, iters, cs.SEED)
        bad, first = 0, None
        for _ in range(n):
            out = rf.mix_peak(*chains, iters, cs.SEED)
            torch.cuda.synchronize()
            for name, a, b in zip(("a", "b", "c", "d", "checksum"), out, plain):
                where = (a != b).nonzero()
                if len(where):
                    bad += 1
                    if first is None:
                        at = tuple(int(x) for x in where[0])
                        first = dict(output=name, at=at, kernel=int(a[at]), plain=int(b[at]),
                                     elements=len(where))
                    break
        print(json.dumps(dict(kernel="mix_peak", iters=iters, tiles=T, runs=n,
                              runs_differing=bad, first=first)), flush=True)
    print(json.dumps(dict(ecc_before=ecc, ecc_after=cs.gpu_ecc(),
                          gpu=torch.cuda.get_device_name(0))), flush=True)


# for a source without the rows-only switch: the earlier kernel with a thread
# per lane, whose thread 0 walks after this line (K3) or these (K4)
_EARLIER_WALK = {
    "K3": "  if (l != 0) return;\n  const int ls = lq - lt - lod;",
    "K4": "  if (j != 0) return;\n  dist[p] = -((lq >= 0 && lq < W) ? Hs[lq] : kNeg);",
}


def _patched_lib(_build, patches, *flags):
    """DIR's pairwise_nw.cu built with `flags` after `patches`, {file of
    csrc: [(old, new), ...]}, each old text found exactly once (None if one
    is not), the patched files written beside the copy of the source, where
    its includes find them first; loaded with ctypes."""
    import ctypes
    import tempfile

    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    for name in {"pairwise_nw.cu", *patches}:
        with open(os.path.join(_build.CSRC, name)) as f:
            text = f.read()
        for old, new in patches.get(name, ()):
            if text.count(old) != 1:
                return None
            text = text.replace(old, new)
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    lib = os.path.join(tmp, "libpairwise_nw_patched.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", _build.CSRC, "-o", lib,
                    os.path.join(tmp, "pairwise_nw.cu")], check=True, capture_output=True)
    return ctypes.CDLL(lib)


def _rows_only_lib(_build, kernel="K3"):
    """DIR's pairwise_nw.cu built with its `kernel` (K3 or K4) stopping
    after the DP rows (-DK3_ROWS_ONLY, -DK4_ROWS_ONLY), loaded with ctypes."""
    with open(os.path.join(_build.CSRC, "pairwise_nw.cu")) as f:
        switch = f"{kernel}_ROWS_ONLY" in f.read()
    cut = _EARLIER_WALK[kernel]
    lib = _patched_lib(_build, {} if switch else {"pairwise_nw.cu": [(cut, "  return;\n" + cut)]},
                       f"-D{kernel}_ROWS_ONLY")
    assert lib is not None, f"unknown {kernel} source"
    return lib


# K4's other layout at W = 512, for `time-k4` to time against the one built:
# a tile one warp of 16 lanes a thread, with no block barrier and no carry
# between warps (4 rows of 32 bits a 16-byte piece; the shift register's
# funnel shift clamped, so that a shift by 32 moves a whole word)
_K4_ONE_WARP = {
    "nw_rows.cuh": [
        ("return lpt <= 4 ? 16 : 8;", "return lpt <= 4 ? 16 : (lpt <= 8 ? 8 : 4);"),
        ("""    r0 = __funnelshift_r(r0, r1, SB);
    r1 = __funnelshift_r(r1, r2, SB);
    r2 = __funnelshift_r(r2, r3, SB);
    r3 = __funnelshift_r(r3, bits, SB);""", """    r0 = __funnelshift_rc(r0, r1, SB);
    r1 = __funnelshift_rc(r1, r2, SB);
    r2 = __funnelshift_rc(r2, r3, SB);
    r3 = __funnelshift_rc(r3, bits, SB);"""),
    ],
    "pairwise_nw.cu": [
        ("""      const int wtot = __reduce_max_sync(kFull, tot);
      int* xb = xs + (r & 1) * 32;
      if (lane == 0) xb[w] = wtot;
      __syncthreads();  // the row's one barrier: xb is read below, rewritten two rows on
      const int carry = wc.before(xb);  // also the previous warp's last lane's x in this row
""", """      int carry = kLow;
      if constexpr (LPT != 16) {
        const int wtot = __reduce_max_sync(kFull, tot);
        int* xb = xs + (r & 1) * 32;
        if (lane == 0) xb[w] = wtot;
        __syncthreads();
        carry = wc.before(xb);
      }
"""),
        ("long long tiled_scratch_bytes(int T, int W) { return banded_scratch_bytes(T, W); }",
         """long long tiled_scratch_bytes(int T, int W) {
  const int lpt = W == 512 ? 16 : k3_lanes(W);
  return (long long)(T / nw::chunk_rows(lpt) + 1) * (W / lpt) * (long long)sizeof(uint4);
}"""),
        ("  const int lpt = k3_lanes(W);\n", "  const int lpt = W == 512 ? 16 : k3_lanes(W);\n"),
        ("    default: return k4_launch<8>(a, NP, st);",
         "    case 16: return k4_launch<16>(a, NP, st);\n    default: return k4_launch<8>(a, NP, st);"),
    ],
}


def _full_cases(cs, inputs_path, new):
    """time-full's cases: [(label, seven numpy inputs, modes, scores)]."""
    import numpy as np

    if inputs_path:
        z = np.load(inputs_path)
        arrays = lambda pre: tuple(z[pre + k] for k in cs.FULL_ARGS)  # noqa: E731
        cases = [("9a", arrays("a_"), ("nw", "sw", "ov"), (3, -5, -4)),
                 ("9b's heaviest launch", arrays("b_"), (str(z["b_mode"]),),
                  tuple(int(v) for v in z["b_scores"]))]
    else:
        rng = np.random.default_rng(cs.SEED + 17)
        cases = [("9a-like", cs.full_window_inputs(rng, 64, 1024, 8, 767), ("nw", "sw", "ov"),
                  (3, -5, -4))]
    if new:
        rng = np.random.default_rng(cs.SEED + 18)
        for N, S in ((128, 63), (256, 127), (512, 255)):
            arrs = cs.full_window_inputs(rng, 64, N, 8, S, backbone_len=S * 3 // 4)
            cases.append((f"S={S} bucket", arrs, ("nw", "sw"), (3, -5, -4)))
    return cases


def _time_full(pkg_dir, inputs_path):
    """Time F1 and F2 of the package under pkg_dir (its API, the earlier
    one whose F1 returns H alone or the present one, read off `full_dp`'s
    parameters); prints one JSON line a (case, mode)."""
    import importlib.util
    import inspect

    import numpy as np
    import torch

    sys.path.insert(0, pkg_dir)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.kernels import poa_full as pf

    assert pf.__file__.startswith(os.path.abspath(pkg_dir)), pf.__file__
    new = "is_sink" in inspect.signature(pf.full_dp).parameters
    dev = torch.device("cuda")
    pf._lib()  # built, so that ptxas's report is there
    regs = {}
    for fn, use in _build.ptxas_usage("poa_full").items():
        m = re.search(r"poa_full_(dp|walk)_kernelILi(\d)E(?:Li(\d)E)?", fn)
        if m:  # F1 <mode, columns a thread>, F2 <mode>
            regs[f"{m.group(1)}<{','.join(x for x in m.groups()[1:] if x)}>"] = use.get("registers")
    print(json.dumps(dict(pkg=pkg_dir, registers=regs)), flush=True)
    for label, arrays, modes, scores in _full_cases(cs, inputs_path, new):
        t = pf._inputs(*arrays, dev)
        codes, preds, nid, sink, nn, seq, sl = t
        B, N, P = preds.shape
        S = seq.shape[1]
        for mode in modes:
            args = (mode, *scores)
            Hp = pf._dp_full_plain(codes, preds, nn, seq, sl, *args)
            want = pf._walk_full_plain(Hp, codes, preds, nid, sink, nn, seq, sl, *args)
            written = ((torch.arange(N + 1, device=dev)[None, :, None] <= nn.long()[:, None, None])
                       & (torch.arange(S + 1, device=dev)[None, None, :]
                          <= sl.long()[:, None, None]))
            if new:
                H, best = pf.full_dp(codes, preds, sink, nn, seq, sl, *args)
                got = pf.full_walk(H, best, codes, preds, nid, nn, seq, sl, *args)
                Hk, bk = torch.empty_like(H), torch.empty_like(best)
                res = tuple(torch.empty_like(a) for a in got)
                dp = lambda: pf.full_dp(codes, preds, sink, nn, seq, sl, *args)  # noqa: E731
                dp_alone = lambda r: pf.launch_dp(  # noqa: E731
                    codes, preds, sink, nn, seq, sl, Hk, bk, *args)
                walk = lambda: pf.full_walk(H, best, codes, preds, nid, nn, seq, sl, *args)  # noqa
                walk_alone = lambda r: pf.launch_walk(  # noqa: E731
                    H, best, codes, preds, nid, nn, seq, sl, *res, *args)
            else:
                H = pf.full_dp(codes, preds, nn, seq, sl, *args)
                got = pf.full_walk(H, codes, preds, nid, sink, nn, seq, sl, *args)
                Hk = torch.empty_like(H)
                res = tuple(torch.empty_like(a) for a in got)
                dp = lambda: pf.full_dp(codes, preds, nn, seq, sl, *args)  # noqa: E731
                dp_alone = lambda r: pf.launch_dp(  # noqa: E731
                    codes, preds, nn, seq, sl, Hk, *args)
                walk = lambda: pf.full_walk(H, codes, preds, nid, sink, nn, seq, sl, *args)  # noqa
                walk_alone = lambda r: pf.launch_walk(  # noqa: E731
                    H, codes, preds, nid, sink, nn, seq, sl, *res, *args)
            assert torch.equal(H[written], Hp[written]), f"{label} {mode}: H"
            for name, g, w in zip(("pairs", "count", "score"), got, want):
                assert torch.equal(g, w), f"{label} {mode}: {name}"
            line = dict(pkg=pkg_dir, case=f"{label}: B={B} N={N} S={S} P={P}", mode=mode,
                        f1_ms=cs.time_ms(dp, warmup=2, reps=20),
                        f1_kernel_ms=cs.kernel_ms(dp_alone),
                        f2_ms=cs.time_ms(walk, warmup=2, reps=20),
                        f2_kernel_ms=cs.kernel_ms(walk_alone))
            line["f1_us_a_row"] = line["f1_kernel_ms"] * 1e3 / int(nn.max())
            line["f2_us_a_step"] = line["f2_kernel_ms"] * 1e3 / max(int(got[1].max()), 1)
            print(json.dumps(line), flush=True)


BUILD_NS = (256, 1152, 2048)


def _prep_build(inputs_path, out_path):
    """time-build's inputs, with this checkout's package: the G1 to G6
    launches of `inputs_path` (chip_smoke.py --save-build) at each of
    BUILD_NS; the build's others captured from a device build of synthetic
    windows (`synth_build_batch`) on the card, G1's drawn by
    `synth_dfs_batch`, G2's by `synth_rank_batch` and G6's by
    `synth_bundle_batch`; saved to out_path as `save_build_inputs` saves,
    with `source_N{N}`, `{dfs,rank,bundle}_source_N{N}` and G6's rank steps
    a window, `bundle_steps_N{N}`."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from vechat_tpu_torch.ops.kernels import graph_build as gb
    from vechat_tpu_torch.ops.kernels import graph_consensus as gcs

    have = cs.load_build_inputs(inputs_path) if inputs_path else {}
    sources, dev = {}, torch.device("cuda")
    build_tags = tuple(cs.BUILD_TAGS.items())
    for N in BUILD_NS:
        sources[f"source_N{N}"] = np.array("phase 7's heaviest launch")
        if any((tag, N) not in have for _, tag in build_tags):
            sources[f"source_N{N}"] = np.array("synthesized: 64 windows, synth_build_batch")
            rng = np.random.default_rng(cs.SEED + 19 + N)
            args = [torch.from_numpy(a).to(dev) for a in cs.synth_build_batch(rng, 64, N)]
            best = {}
            with cs.capturing_build(best):
                gb.device_build(*args, N, 2 * N, 8, 3, -5, -4, p_cap=16)
            for name, tag in build_tags:
                have[(tag, N)] = cs.heaviest_by_n(best, name)[N]
        sources[f"dfs_source_N{N}"] = np.array("phase 6's heaviest launch")
        if ("dfs", N) not in have:
            sources[f"dfs_source_N{N}"] = np.array("synthesized: 64 windows, synth_dfs_batch")
            have[("dfs", N)] = cs.synth_dfs_batch(np.random.default_rng(cs.SEED + 29 + N), 64, N)
        sources[f"rank_source_N{N}"] = np.array("phase 6's heaviest launch")
        if ("rank", N) not in have:
            sources[f"rank_source_N{N}"] = np.array("synthesized: 64 windows, synth_rank_batch")
            have[("rank", N)] = cs.synth_rank_batch(np.random.default_rng(cs.SEED + 31 + N), 64,
                                                    N, dev)
        sources[f"bundle_source_N{N}"] = np.array("phase 8's heaviest launch")
        if ("bundle", N) not in have:
            sources[f"bundle_source_N{N}"] = np.array(
                "synthesized: 64 windows, synth_bundle_batch")
            have[("bundle", N)] = cs.synth_bundle_batch(np.random.default_rng(cs.SEED + 37 + N),
                                                        64, N, dev)
        # G6's rank steps a window over all its passes, by this checkout's
        # plain version (an older one may not count them a window)
        stats = {}
        gcs._heaviest_bundle_plain(*(torch.from_numpy(a).to(dev) for a in have[("bundle", N)]),
                                   stats=stats)
        sources[f"bundle_steps_N{N}"] = stats["bundle_steps_window"].cpu().numpy()
    cs.save_build_inputs(out_path, {k: v for k, v in have.items() if k[1] in BUILD_NS},
                         **sources)


def _time_cycle_build(pkg_dir, cs, inputs, sources, gpu):
    """G3, G1, G2 and G6 of the package under pkg_dir on time-build's
    inputs (its API, with the check switch or without, read off its
    wrappers); one JSON line a (kernel, N)."""
    import inspect

    import torch

    from vechat_tpu_torch.ops.kernels import graph_build as gb
    from vechat_tpu_torch.ops.kernels import graph_consensus as gcs
    from vechat_tpu_torch.ops.kernels import graph_cycle as gc

    dev = torch.device("cuda")
    new = "check" in inspect.signature(gb.topo_ranks_bundled).parameters
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    for N in BUILD_NS:
        a = [torch.from_numpy(x).to(dev) for x in inputs[("topo", N)]]
        got = gb.topo_ranks_bundled(*a)
        want = gb._topo_bundled_plain(*a)
        diff = ((got[0] != want[0]) | (got[1] != want[1])).any(1).nonzero().flatten()
        if len(diff):  # a ring past R: the plain machine's last write, on the CPU
            on_cpu = gb._topo_bundled_plain(*(x[diff].cpu() for x in a))
            want = tuple(w.index_copy(0, diff, c.to(dev, w.dtype)) for w, c in zip(want, on_cpu))
        for name, g, w in zip(("rank_of", "rank_to_node"), got, want):
            assert torch.equal(g.long(), w.long()), f"G3 N={N}: {name}"
        call = (lambda: gb.topo_ranks_bundled(*a, check=False)) if new else (
            lambda: gb.topo_ranks_bundled(*a))
        ms = cs.time_ms(call, warmup=2, reps=20)
        ins = [i32(x) for x in a]
        res = [torch.empty_like(t) for t in got]
        kms = cs.kernel_ms(lambda r: gb.launch_topo_bundled(*ins, *res))
        assert all(torch.equal(x, y) for x, y in zip(res, got)), f"G3 N={N}: the kernel alone"
        # no node to rank: the block's staging and write-back alone
        idle = ins[:4] + [torch.zeros_like(ins[4])]
        idle_ms = cs.kernel_ms(lambda r: gb.launch_topo_bundled(*idle, *res))
        P, R = a[0].shape[2], a[2].shape[2]
        form = gb.kernel_form("graph_topo_bundled", N, R=R, P=P) if new else "one warp"
        steps = int(cs.topo_steps_taken(*inputs[("topo", N)]).max())
        print(json.dumps(dict(pkg=pkg_dir, kernel="graph_topo_bundled", N=N, B=a[0].shape[0],
                              inputs=str(sources[f"source_N{N}"]), form=form, ms=ms,
                              kernel_ms=kms, idle_ms=idle_ms, steps_longest=steps,
                              us_a_step=kms * 1e3 / max(steps, 1), gpu=gpu)), flush=True)

        d = [torch.from_numpy(x).to(dev) for x in inputs[("dfs", N)]]
        got = gc.dfs_preorder(*d)
        for name, g, w in zip(("new_id", "order", "n_sub"), got, gc._dfs_plain(*d)):
            assert torch.equal(g.long(), w.long()), f"G1 N={N}: {name}"
        call = (lambda: gc.dfs_preorder(*d, check=False)) if new else (lambda: gc.dfs_preorder(*d))
        ms = cs.time_ms(call, warmup=2, reps=20)
        A = d[0].shape[2]
        if new:
            ins = [i32(d[0]), i32(d[1]), d[2].contiguous(), d[3].to(torch.int64).contiguous()]
            form = "shared" if bool(gc.dfs_compact(d[1], A).all()) else "global in some windows"
        else:
            ins = [i32(d[0]), i32(d[1]), d[2].to(torch.uint8).contiguous(), i32(d[3])]
            form = "one warp"
        res = [torch.empty_like(t) for t in got]
        kms = cs.kernel_ms(lambda r: gc.launch_dfs(*ins, *res))
        assert all(torch.equal(x, y) for x, y in zip(res, got)), f"G1 N={N}: the kernel alone"
        # every root outside its component: the block's scan, staging and
        # write-back alone
        idle = [ins[0], ins[1], torch.zeros_like(ins[2]), ins[3]]
        idle_ms = cs.kernel_ms(lambda r: gc.launch_dfs(*idle, *res))
        steps = 2 * int(got[2].max()) - 1  # a push a node but the root, a pop a node
        print(json.dumps(dict(pkg=pkg_dir, kernel="graph_dfs", N=N, B=d[0].shape[0], A=A,
                              inputs=str(sources[f"dfs_source_N{N}"]), form=form, ms=ms,
                              kernel_ms=kms, idle_ms=idle_ms, steps_longest=steps,
                              us_a_step=kms * 1e3 / max(steps, 1), gpu=gpu)), flush=True)
        _time_rank_bundle(pkg_dir, cs, inputs, sources, gpu, N, gc, gcs)


def _time_rank_bundle(pkg_dir, cs, inputs, sources, gpu, N, gc, gcs):
    """G2 and G6 of the package under pkg_dir at N (gc, gcs: its modules),
    held to their plain versions: the wrapper as the cycle or round 2's
    program calls it (a package with the check switch without its checks
    and with G1's int32 n_sub; one without, as it was, its cycle's n_sub
    int64), the kernel alone, the kernel with nothing to walk (`idle_ms`:
    n_sub or n_nodes 0, the staging and write-back alone), µs a step over
    the longest window's steps (G2: two a node; G6: all its passes, as
    `_prep_build` counted them), the form, shared memory and registers;
    one JSON line a kernel."""
    import inspect

    import torch

    dev = torch.device("cuda")
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    new = "check" in inspect.signature(gc.topo_ranks).parameters
    ins = [i32(torch.from_numpy(x).to(dev)) for x in inputs[("rank", N)]]
    got = gc.topo_ranks(*ins)
    for name, g, w in zip(("rank_of", "rank_to_node"), got, gc._topo_plain(*ins)):
        assert torch.equal(g.long(), w.long()), f"G2 N={N}: {name}"
    n_sub64 = ins[2].long()
    call = (lambda: gc.topo_ranks(*ins, check=False)) if new else (
        lambda: gc.topo_ranks(ins[0], ins[1], n_sub64))
    ms = cs.time_ms(call, warmup=2, reps=20)
    res = [torch.empty_like(t) for t in got]
    kms = cs.kernel_ms(lambda r: gc.launch_topo(*ins, *res))
    assert all(torch.equal(x, y) for x, y in zip(res, got)), f"G2 N={N}: the kernel alone"
    idle = ins[:2] + [torch.zeros_like(ins[2])]
    idle_ms = cs.kernel_ms(lambda r: gc.launch_topo(*idle, *res))
    P = ins[0].shape[2]
    if new:
        staged = gc.topo_staged(ins[0], ins[2])
        form = "shared" if bool(staged.all()) else "global in some windows"
        smem = gc.topo_smem(N, P)[1]
    else:
        form, smem = "one warp", 4 * ((N + 31) // 32 + N)
    steps = 2 * int(ins[2].clamp_max(N).max())
    print(json.dumps(dict(pkg=pkg_dir, kernel="graph_topo", N=N, B=ins[0].shape[0], P=P,
                          inputs=str(sources[f"rank_source_N{N}"]), form=form, smem_bytes=smem,
                          ms=ms, kernel_ms=kms, idle_ms=idle_ms, steps_longest=steps,
                          us_a_step=kms * 1e3 / max(steps, 1), **gc.kernel_attrs("graph_topo"),
                          gpu=gpu)), flush=True)

    new = "check" in inspect.signature(gcs.heaviest_bundle).parameters
    ins = [i32(torch.from_numpy(x).to(dev)) for x in inputs[("bundle", N)]]
    got = gcs.heaviest_bundle(*ins)
    for name, g, w in zip(("cons", "cons_len", "overflow"), got, gcs._heaviest_bundle_plain(*ins)):
        assert torch.equal(g.long(), w.long()), f"G6 N={N}: {name}"
    call = (lambda: gcs.heaviest_bundle(*ins, check=False)) if new else (
        lambda: gcs.heaviest_bundle(*ins))
    ms = cs.time_ms(call, warmup=2, reps=20)
    res = (torch.empty_like(got[0]), torch.empty_like(got[1]), torch.empty_like(got[1]))
    kms = cs.kernel_ms(lambda r: gcs.launch_bundle(*ins, *res))
    assert (torch.equal(res[0], got[0]) and torch.equal(res[1], got[1])
            and torch.equal(res[2] != 0, got[2])), f"G6 N={N}: the kernel alone"
    idle = ins[:7] + [torch.zeros_like(ins[7])]
    idle_ms = cs.kernel_ms(lambda r: gcs.launch_bundle(*idle, *res))
    P = ins[0].shape[2]
    if new:
        staged = gcs.bundle_staged(ins[7], N, P)
        form = "shared" if bool(staged.all()) else "global in some windows"
        extra = dict(smem_bytes=gcs.bundle_smem(N, P)[1], **gcs.kernel_attrs())
    else:
        form, extra = "one warp", dict(smem_bytes=8 * N)
    steps = int(sources[f"bundle_steps_N{N}"].max())
    print(json.dumps(dict(pkg=pkg_dir, kernel="graph_bundle", N=N, B=ins[0].shape[0], P=P,
                          inputs=str(sources[f"bundle_source_N{N}"]), form=form, ms=ms,
                          kernel_ms=kms, idle_ms=idle_ms, steps_longest=steps,
                          us_a_step=kms * 1e3 / max(steps, 1), **extra, gpu=gpu)), flush=True)


def _time_build(pkg_dir, inputs_path):
    """Time G4 and G5 of the package under pkg_dir (its API, with or
    without `fuse_walk_`, read off its module) on time-build's inputs, then
    G3 and G1 (`_time_cycle_build`); one JSON line a (kernel, N)."""
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, pkg_dir)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vechat_tpu_torch.ops.kernels import graph_build as gb

    assert gb.__file__.startswith(os.path.abspath(pkg_dir)), gb.__file__

    new = hasattr(gb, "fuse_walk_")
    gb._lib()
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    inputs = cs.load_build_inputs(inputs_path)
    sources = dict(np.load(inputs_path))
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    for N in BUILD_NS:
        source = str(sources[f"source_N{N}"])
        a = [None if x is None else torch.from_numpy(x).to(dev) for x in inputs[("fuse", N)]]
        B = a[0].shape[0]
        track = a[14] is not None
        want = gb._fuse_plain(*a)
        got = gb.fuse_walk(*a)
        for name, g, w in zip(("codes", "tails", "heads", "weights", "n_nodes", "n_edges",
                               "aligned", "acount", "overflow", "lab_lo", "lab_hi"), got, want):
            assert torch.equal(g.long(), w.long()), f"G4 N={N}: {name}"
        state0 = [i32(x) for x in a[:8]] + ([i32(a[14]), i32(a[15])] if track else [])
        work = [torch.empty_like(t) for t in state0]
        labs = work[8:] if track else [None, None]
        bits = [i32(a[16]), i32(a[17])] if track else [None, None]
        ins = [i32(x) for x in a[8:13]]
        ovf = torch.empty((B,), dtype=torch.int32, device=dev)

        def copy(r=0):
            for w, s0 in zip(work, state0):
                w.copy_(s0)

        if new:
            act = a[13].contiguous()
            form = gb.kernel_form("graph_fuse", N, a[1].shape[1], a[6].shape[2], track)
            scratch = (torch.empty((B, gb.fuse_scratch_ints(N, a[1].shape[1])),
                                   dtype=torch.int32, device=dev) if form == "global" else None)

            def step():
                copy()
                gb.fuse_walk_(*work[:8], *ins, act, *labs, *bits, check=False)

            ms = cs.time_ms(step, warmup=2, reps=20) - cs.time_ms(copy, warmup=2, reps=20)

            def alone(r, act=act):
                copy()
                gb.launch_fuse(*work[:8], *labs, *bits, *ins, act, ovf, scratch)
        else:
            act = a[13].to(torch.uint8).contiguous()
            ms = cs.time_ms(lambda: gb.fuse_walk(*a), warmup=2, reps=20)

            def alone(r):
                copy()
                gb.launch_fuse(*work[:8], *labs, *bits, *ins, act, ovf)

        kms = cs.kernel_ms(alone) - cs.kernel_ms(copy)
        idle_ms = None
        if new:  # every window inactive: G4 stages and writes back, and walks none
            idle = torch.zeros_like(act)
            idle_ms = cs.kernel_ms(lambda r: alone(r, idle)) - cs.kernel_ms(copy)
        live = a[13].bool()
        steps = int(torch.where(live, a[9].long() + a[12].long(), 0).max())
        print(json.dumps(dict(pkg=pkg_dir, kernel="graph_fuse", N=N, B=B, labels=track,
                              inputs=source, ms=ms, kernel_ms=kms, inactive_ms=idle_ms,
                              steps_longest_walk=steps,
                              us_a_step=kms * 1e3 / max(steps, 1), gpu=gpu)), flush=True)

        r = [None if x is None else torch.from_numpy(x).to(dev) for x in inputs[("reach", N)]]
        keep = gb.reach_keep(*r)
        assert torch.equal(keep, gb._reach_plain(*r)), f"G5 N={N}"
        ms = cs.time_ms(lambda: gb.reach_keep(*r), warmup=2, reps=20)
        res = torch.empty_like(keep)
        if new:
            E, R = r[0].shape[1], r[3].shape[2]
            scratch = (torch.empty((B, gb.reach_scratch_ints(N, E)), dtype=torch.int32,
                                   device=dev)
                       if gb.kernel_form("graph_reach", N, E, R) == "global" else None)
            rin = [i32(x) for x in r[:7]]

            def alone(k):
                gb.launch_reach(*rin, r[7].contiguous(), i32(r[8]), res, scratch)

            kms = cs.kernel_ms(alone)
            alone(0)
        else:
            off, csr = gb.in_edge_csr(r[0], r[1], r[2], N)
            rin = [i32(x) for x in r[3:7]]
            full, nn = r[7].to(torch.uint8).contiguous(), i32(r[8])
            kms = cs.kernel_ms(lambda k: gb.launch_reach(off, csr, *rin, full, nn, res))
        assert torch.equal(res, keep), f"G5 N={N}: the kernel alone"
        nodes = int((keep & ~r[7].bool()[:, None]).sum(1).max())
        print(json.dumps(dict(pkg=pkg_dir, kernel="graph_reach", N=N, B=B, inputs=source, ms=ms,
                              kernel_ms=kms, nodes_most_kept=nodes,
                              us_a_node=kms * 1e3 / max(nodes, 1), gpu=gpu)), flush=True)
    _time_cycle_build(pkg_dir, cs, inputs, sources, gpu)


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


def _time_k4(pkg_dir, inputs_path):
    """Time K4 of the package under pkg_dir, whole, rows only and, for the
    present design, in its other layout: the wrapper, its host microseconds
    a call and the kernel alone, each summed over a case's launches; prints
    one JSON line a (case, build) with its bound, and ptxas's registers and
    spills of its instantiations."""
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
    cs.window_inputs(rng, B=16, N=640, P=8, W=576, D=32)  # phase 1's draws before K4's
    cs.k3_inputs(rng, dev)
    cases = [("phase 1", [cs.k4_inputs(rng, dev)])]
    if inputs_path:
        z = np.load(inputs_path)
        arrays = lambda pre: tuple(torch.from_numpy(z[pre + k]).to(dev)  # noqa: E731
                                   for k in cs.K4_ARGS)
        cases.append(("main path's heaviest", [arrays("")]))
        n = sum(1 for k in z.files if k.endswith("_qlen"))
        if n:
            cases.append((f"phase 3's {n} launches", [arrays(f"launch{i}_") for i in range(n)]))
    whole = pw._lib()
    for fn, use in _build.ptxas_usage("pairwise_nw").items():
        if "tiled_kernel" in fn:
            print(json.dumps(dict(pkg=pkg_dir, kernel=fn, **use)), flush=True)
    builds = [("whole", whole), ("rows only", _rows_only_lib(_build, "K4"))]
    one_warp = _patched_lib(_build, _K4_ONE_WARP)  # None before the present design
    if one_warp is not None:
        builds.append(("one warp of 16 lanes", one_warp))
    for label, launches in cases:
        wants = [pw._tiled_plain(*args) for args in launches]
        for build, lib in builds:
            if not hasattr(lib, "tiled_scratch_bytes"):  # a direction byte a cell
                lib.tiled_scratch_bytes = lambda T, W: (T + 1) * W
            _build._libs["pairwise_nw"] = lib
            pw._lib()  # sets the argument types of a fresh library
            sums = dict(ms=0.0, kernel_ms=0.0, wrapper_host_us=0.0, bound_ms=0.0)
            for args, want in zip(launches, wants):
                (NP, T), W = args[0].shape, args[1].shape[1]
                if "rows only" not in build:  # exact before it is timed
                    got = pw.tiled_nw(*args)
                    for name, g, w in zip(cs.NW_OUTPUTS, got, want):
                        assert torch.equal(g, w), f"{build} {label}: {name} differs from plain"
                sums["ms"] += cs.time_ms(lambda: pw.tiled_nw(*args), warmup=2, reps=20)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    pw.tiled_nw(*args)
                sums["wrapper_host_us"] += (time.perf_counter() - t0) / 50 * 1e6
                torch.cuda.synchronize()
                sums["kernel_ms"] += cs.kernel_ms(cs.k4_kernel_fn(args))
                b_ms, b_by = cs.bound_ms(*cs.k4_work(args[2], args[3], T, W))
                sums["bound_ms"] += b_ms
            tiles = sum(args[0].shape[0] for args in launches)
            print(json.dumps(dict(pkg=pkg_dir, shape=f"{label}: {tiles} tiles T={T} W={W}",
                                  build=build, launches=len(launches), **sums, bound_by=b_by,
                                  rows=sum(int(args[2].sum()) for args in launches),
                                  longest_tile_rows=max(int(args[2].max()) for args in launches),
                                  steps=sum(int(want[2].sum()) for want in wants),
                                  longest_walk=max(int(want[2].max()) for want in wants))),
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
    if len(argv) >= 2 and argv[0] == "time-k4":
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        inputs = ""
        dirs = argv[1:]
        if dirs[0] == "--inputs":
            inputs, dirs = os.path.abspath(dirs[1]), dirs[2:]
        for d in dirs:
            rc = subprocess.run([sys.executable, __file__, "_time_k4", os.path.abspath(d),
                                 inputs]).returncode
            if rc:
                return rc
        return 0
    if len(argv) == 3 and argv[0] == "_time_k4":
        _time_k4(argv[1], argv[2])
        return 0
    if len(argv) >= 2 and argv[0] == "time-full":
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        inputs = ""
        dirs = argv[1:]
        if dirs[0] == "--inputs":
            inputs, dirs = os.path.abspath(dirs[1]), dirs[2:]
        for d in dirs:
            rc = subprocess.run([sys.executable, __file__, "_time_full", os.path.abspath(d),
                                 inputs]).returncode
            if rc:
                return rc
        return 0
    if len(argv) == 3 and argv[0] == "_time_full":
        _time_full(argv[1], argv[2])
        return 0
    if len(argv) >= 2 and argv[0] == "time-build":
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        inputs = ""
        dirs = argv[1:]
        if dirs[0] == "--inputs":
            inputs, dirs = os.path.abspath(dirs[1]), dirs[2:]
        os.makedirs(os.path.join(REPO, "vechat_tpu_torch", "_build"), exist_ok=True)
        prepared = os.path.join(REPO, "vechat_tpu_torch", "_build", "time_build_inputs.npz")
        rc = subprocess.run([sys.executable, __file__, "_prep_build", inputs, prepared]).returncode
        if rc:
            return rc
        for d in dirs:
            rc = subprocess.run([sys.executable, __file__, "_time_build", os.path.abspath(d),
                                 prepared]).returncode
            if rc:
                return rc
        return 0
    if len(argv) == 3 and argv[0] == "_prep_build":
        _prep_build(argv[1], argv[2])
        return 0
    if len(argv) == 3 and argv[0] == "_time_build":
        _time_build(argv[1], argv[2])
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
    if len(argv) >= 2 and argv[0] == "time-walk3":
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        for d in argv[1:]:
            rc = subprocess.run([sys.executable, __file__, "_time_walk3",
                                 os.path.abspath(d)]).returncode
            if rc:
                return rc
        return 0
    if len(argv) == 2 and argv[0] == "_time_walk3":
        _time_walk3(argv[1])
        return 0
    if len(argv) == 3 and argv[0] == "_time_gap":
        _time_gap(argv[2], argv[1])
        return 0
    if argv == ["latency"]:
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        _latency()
        return 0
    if len(argv) == 2 and argv[0] == "repeat-k7":
        import torch

        if not torch.cuda.is_available():
            print("k1_probe: no CUDA device", file=sys.stderr)
            return 2
        _repeat_k7(int(argv[1]))
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
