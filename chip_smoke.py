#!/usr/bin/env python3
"""Smoke test of vechat_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one GPU
    python3 chip_smoke.py --save-k3 PATH   # also save phase 3c's K3 inputs
    python3 chip_smoke.py --save-k4 PATH   # also save phase 3d's and every phase-3 K4 launch's inputs
    python3 chip_smoke.py --save-full PATH # also save phase 9a's inputs and 9b's heaviest launch's
    python3 chip_smoke.py --save-build PATH  # also save phase 6's heaviest G1 and G2, phase
                                             # 7's heaviest G3, G4 and G5 and phase 8's
                                             # heaviest G6 launches at each N
                                             # (any of the four may be given)

Phases (each raises on failure; the script exits non-zero on any):
  0. the card's name and power limit; build the CUDA kernels with nvcc
  1. each kernel (K1 POA DP, K2 POA walk and the expansion of its headers
     to node-id pairs, the dense POA walk, K3 banded NW, K4 tiled NW, K5/K5w
     affine POA DP and walk, K6/K6w convex POA DP and walk, K7 the int32 mix
     peak) at its path's shapes against its plain PyTorch version on the
     same inputs, exact equality; CUDA-event times of both. K1-K4, the
     expansion and the dense walk at the main path's batched shapes (the
     dense walk's pairs also against K2's, expanded); K5-K6w at the spoa
     path's (one block: B=1, D=1, the graph of phase 4 as it grows) and, as
     extra lines, at K1's batched shape; K7 on one [64, 512] tile for each
     SM, then the measurement of the mix's sustained rate
  2. `vechat --backend cuda` reproduces the two committed goldens
  3. the main path: a seeded two-strain community (2 x 12.5 kb strains,
     1% apart; 200 reads x 2.5 kb at 8% ONT-profile error) corrected by
     `vechat --backend cuda`; wall time, reads/s, error before and after,
     strain preservation, each kernel's launches in this run, the tallies
     of K1's launch shapes (B, D, N, W, P, ring in shared or global memory),
     K3's (T, BW, NP) and K4's (NP, T, W), the device seconds of K1, K2, the
     expansion, K3 and K4, the batched backend's stages (its decode split
     into the pairs' fetch and the lists)
 3b. K1 at the main path's own launches: inputs made at the two heaviest
     shapes of that tally (launches x B*D*N*W), held to K1's plain version
     and both timed; then K2 and the expansion on those direction words;
     at the heaviest, the backend's list building from the expansion's
     pairs beside the other ways to build the same lists, in turns on the
     host's CPU (`decode_lists_row`)
 3c. K3 on exactly the inputs of phase 3's heaviest launch (largest
     NP*T*BW), kept as phase 3 made it, held to its plain version and both
     timed (`--save-k3 PATH` also saves them, for `k1_probe.py time-k3`)
 3d. K4 the same way on the inputs of phase 3's heaviest K4 launch (largest
     NP*T*W), with the kernel alone; it raises if phase 3 launched K4 at no
     size (`--save-k4 PATH` saves them and those of every K4 launch of phase
     3, for `k1_probe.py time-k4`)
  4. the spoa path: 32 reads of one 480-base template (8% ONT-profile
     error) through `vechat-spoa-torch --backend cuda` with linear, affine
     and convex scores, in nw/sw/ov and strand-ambiguous runs (the first 12
     reads for sw, ov and both convex runs: their host engine is Python),
     each byte for byte against `--backend host`; wall time, device
     alignments, host routes and each kernel's launches per run
  5. the scale-out path: (a) both goldens through a backend that shards
     every window batch over two streams of the card (K1 + the dense walk a
     shard; the device seconds of both kernels), and the dense walk once
     more against its plain version on the largest shard this run
     launched; then, on the first 48 reads of phase 3's community (a cut
     of depth that keeps the script well inside its time limit), against
     one reference, `--stream --resume-dir` over those reads on the host
     engine: (b) two processes of the command line on the card, the
     records all-gathered between the rounds over gloo, rank 0's file
     byte for byte; (c) the reference's command on the card, in four
     chunks of 12 reads, byte for byte, then one checkpoint of each round
     deleted and the command run again
  6. the device prune cycle (VECHAT_DEVICE_CYCLE=1: round 1's prune,
     realign and emit cycle on the card, G1 and G2 with K1 and the dense
     walk): both goldens through `vechat --backend cuda`, byte for byte
     against the committed goldens (the community's reads take the device
     cycle in 7b); the windows on the card and on the
     host route by reason, dispatches, the
     cycle's pack/device/fetch seconds, cc_min_labels' rounds, and the
     launches and device seconds of K1, the dense walk, G1 and G2; then G1
     and G2 on the inputs of their heaviest launches, each held to its plain
     version and timed (wrapper as the cycle calls it, kernel alone, plain),
     with its registers, shared memory and form
  7. the device build (VECHAT_DEVICE_BUILD=1: round 1's incremental build
     and prune cycle on the card, G3, G4 and G5 with K1 and the dense walk,
     then G1 and G2): (a) both goldens through `vechat --backend cuda`,
     byte for byte against the committed goldens; (b) the first 48 reads
     of phase 3's community with VECHAT_DEVICE_CYCLE=1 as well, byte for
     byte against the host run of 5b and 5c; the windows built on the card
     and the host routes by reason, dispatches, layer steps, the build's
     pack/device/fetch seconds, and the launches of G3, G4, G5, K1, the
     dense walk, G1 and G2 (in 7b, by CUDA events around each launch,
     their device seconds too) and the form (shared or global memory, by N)
     of each G3, G4 and G5 launch; then G3, G4 and G5 on the inputs of their
     heaviest launches, each held to its plain version and timed (wrapper
     as the build calls it, kernel alone, plain), with its registers and
     shared memory and form (`--save-build PATH` saves the heaviest G3,
     G4 and G5 launch at each N, and phase 6's G1 and G2 and phase 8's G6,
     for `k1_probe.py time-build`)
  8. the device round-2 consensus (VECHAT_DEVICE_LINEAR=1: round 2's build,
     heaviest bundle with branch completion, coverage and trim on the card,
     G3, G4, G5, K1, the dense walk and G6): (a) both goldens through
     `vechat --backend cuda`, byte for byte against the committed goldens;
     (b) the first 48 reads of phase 3's community with
     VECHAT_DEVICE_BUILD=1 and VECHAT_DEVICE_CYCLE=1 as well, so that both
     rounds' window consensus runs on the card, byte for byte against the
     host run of 5b and 5c; the windows of round 2 on the card and the host
     routes by reason, dispatches, the program's pack/device/fetch seconds
     and every kernel's launches (no profiler); then G6 on the inputs of
     its heaviest launch, held to its plain version and timed (wrapper,
     kernel alone, plain), with the rank steps of its longest window, its
     registers, shared memory and form
  9. B10, the full-matrix DP (`--backend full`, F1 and F2 in
     `csrc/poa_full.cu`): (a) F1 and F2 on a synthesized batch of 64 native
     window graphs at B10's buckets (N=1024, S=767, P=8) in nw, sw and ov,
     held to the plain version (F1's H where it writes it and its best
     cell; F2's pairs, counts and scores) and timed (wrappers, kernels
     alone, plain), with the predecessor distances of the batch (the share
     of F1's row reads that its ring serves) and both kernels' registers
     and shared memory a block; (b) both goldens through `vechat --backend
     full`, byte for byte, with the items on the card, the host routes, F1's
     and F2's launches, F1's tally of (B, N, S, P) and the predecessor
     distances over all its launches, then F1 and F2 again on the inputs of
     the run's heaviest launch (`--save-full PATH` saves 9a's inputs and
     these, for `k1_probe.py time-full`); (c) `entry.dryrun_multichip` over two streams of the card,
     every part equal to the one-device run; (d) `utils/roofline.main`,
     which prints its ROOFLINE_RESULT line

The phases run one after another. One process runs beside them: the
reference of 5b, 5c and 7b on the host engine, which needs no card. It
is started once phase 3d has ended and is waited for at 5b, so the walls of
phases 4, 5a and 5b are taken with that one process on another of the
host's cores; those of phases 1 to 3d, 5c and 6 to 9 with nothing.

The second-to-last line is {"kernels": [...]} with, per kernel, its launches
on its path (K1-K4: phase 3; K5-K6w: phase 4; the dense walk: phase 5a; G1
and G2: phase 6; G3-G5: phase 7; G6: phase 8; F1 and F2: phase 9b; K7: the
measurement; counts set to 0 just before each), the
largest difference
from its plain version (0: the tolerance is exact), its time, the plain
version's time and the bound (the least time the card could take for
the same work), each time the wrapper's by CUDA events (K2, the
expansion, the dense walk, K4, K5 and K6 also give `kernel_ms`, the kernel
alone: `walk_expand_rows`, `dense_kernel_ms`, `k4_row`, `check_gap_launch`,
`graph_kernel_row`, `build_kernel_row`, `bundle_kernel_row`, `full_rows`); K1's, K2's
and the expansion's are at phase 3b's heaviest shape, K3's at 3c's launch,
K4's at 3d's, G1's and G2's at phase 6's, G3's, G4's and G5's at phase 7's,
G6's at phase 8's and F1's and F2's at phase 9b's heaviest launches, which
their entries name
(phase 1's rows, K3's 256 pairs with its accepted pairs among them and
K4's 64 tiles, stay lines of their own). The last line is {"ok": true,
"device": {...}}. Without a CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM3 bandwidth,
# and INT32 rate = 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# operation counts per DP cell, read off the kernels (see PERF.md):
# K1 adds 5 per real in-edge on top of 18; K3 and K4 do ~15; a walk step ~20
K1_OPS_CELL, K1_OPS_EDGE = 18, 5
NW_OPS_CELL = 15
WALK_OPS_STEP = 20
# the expansion, a pair: its header's three fields, two steps back, a select,
# the node id and the pack (10)
EXPAND_OPS_PAIR = 10
# K5: 2 packed maxes per in-edge over 2 rings (20); per cell the unpacks,
# E/EB, clamps, pack and best cell (24) and the E prefix max (2: a subtract
# and a max). K6: 5 packed maxes per in-edge over 3 rings (34); per cell the
# chain code (30), the rest (30) and the (E, Q) recurrence (8: 4 adds and 4
# maxes). Both scans are counted at the function's work, one pass along the
# row: the kernels' log-step scans (K5: 5 shuffle steps and one carry a
# warp; K6: 5 shuffle steps of 4 DPX, a carry chained over the warps to the
# left and a second pass over the lanes) are their own choice and stay out
# of the bound. A three-state walk step
# decodes two halfwords (30)
K5_OPS_CELL, K5_OPS_EDGE = 26, 20
K6_OPS_CELL, K6_OPS_EDGE = 68, 34
WALK3_OPS_STEP = 30
# K7 does 12 operations an element a round by the mix's definition, and the
# rate it reports counts those. Its bound counts what the INT32 pipe must at
# least run for them on sm_90a, 8 instruction slots: each add-then-max pair is
# one VIADDMNMX, the roll is a shuffle and the subtract can go as an IMAD
# on the FMA pipe. (As compiled the kernel takes 9: one more select, for the
# roll's last lane.) So a count of operations over the INT32 rate is no floor
# for code that the compiler fuses; the measured rate of the mix stands
# beside every operation bound for that reason
MIX_INT32_SLOTS_ROUND = 8
# set by mix_peak_phase: the mix's measured rate, in counted operations a second
MEASURED = {"mix_ops_per_s": None}


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def log_row(row):
    """Log a kernel's row; one bound by operations also gets the share of
    the mix's measured rate that its counted operations a second come to."""
    rate = MEASURED["mix_ops_per_s"]  # None in a rehearsal on the CPU
    if rate and row["bound_by"] == "operations" and row["kernel"] != "mix_peak":
        row["share_of_measured_mix_rate"] = (
            row["bound_ms"] / row["ms"] * INT32_OPS_PER_S / rate)
    log(row)


def kernel_ms(fn, copies=1, reps=24):
    """Device time (ms) of one call of fn(r), which launches kernels on the
    r-th of `copies` copies of their inputs and allocates nothing: `reps`
    calls, r taking each copy in turn, captured in a CUDA graph and replayed
    between two CUDA events (median of 3 replays), so that the host's
    launches, which take longer than a kernel of a few microseconds, stay
    out of the time. With copies whose bytes together are many times the
    card's 50 MB L2, every call reads its inputs from device memory, as on
    the main path; with one copy, a replay reads what the one before left
    in the L2."""
    import torch

    for r in range(copies):
        fn(r)  # outside the capture: loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(reps):
            fn(k % copies)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def time_ms(fn, warmup=1, reps=5):
    """Median CUDA-event time of fn() after warm-up (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ----------------------------------------------------------------- data

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def rand_seq(rng, n):
    """Random genome as a str."""
    return rng.choice(_ACGT, size=n).tobytes().decode()


def mutate(rng, seq, sub, ins, dele):
    """Read-error simulation: substitutions by +1..3 rotation, deletions by
    mask, insertions (70% homopolymer) after kept positions."""
    a = np.frombuffer(seq.encode(), dtype=np.uint8)
    n = len(a)
    r = rng.random(n)
    code = np.searchsorted(_ACGT, a)
    is_sub = r < sub
    rot = rng.integers(1, 4, size=n)
    code = np.where(is_sub, (code + rot) % 4, code)
    out = _ACGT[code]
    is_del = (~is_sub) & (r < sub + dele)
    is_ins = rng.random(n) < ins
    ins_base = np.where(rng.random(n) < 0.7, out, rng.choice(_ACGT, size=n))
    reps = np.where(is_del, 0, 1 + is_ins.astype(np.int64))
    res = np.empty(int(reps.sum()), dtype=np.uint8)
    pos = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(reps, out=pos[1:])
    keep = ~is_del
    res[pos[:-1][keep]] = out[keep]
    ins_slots = keep & is_ins
    res[pos[:-1][ins_slots] + 1] = ins_base[ins_slots]
    return res.tobytes().decode()


ONT = (0.35, 0.25, 0.40)  # (sub, ins, del) split of the error rate

# gap scores (m, n, g, e[, q, c]) of the spoa path: linear, affine, convex at
# the command line's defaults, convex with every magnitude within 8
LINEAR_SCORES = (3, -5, -4, -4)
AFFINE_SCORES = (3, -5, -8, -6)
CONVEX_SCORES = (5, -4, -8, -6, -10, -4)
CONVEX_SMALL_SCORES = (3, -5, -6, -4, -8, -2)


def score_args(scores):
    """The command line's flags for `scores` (q, c default to g, e)."""
    m, n, g, e = scores[:4]
    q, c = scores[4:] or (g, e)
    return [a for flag, v in zip("mngeqc", (m, n, g, e, q, c)) for a in (f"-{flag}", str(v))]


def ont_read(rng, frag, rate):
    return mutate(rng, frag, rate * ONT[0], rate * ONT[1], rate * ONT[2])


# -------------------------------------------------------- phase 1: kernels


def window_inputs(rng, B, N, P, W, D):
    """B window graphs built by the port's native graph from a 500 bp
    backbone and 8%-error layers (as many as keep the graph within N nodes
    and P in-edges), each with D 8%-error reads of the window, packed in
    the JAX layout."""
    from vechat_tpu_torch.ops.encode import encode
    from vechat_tpu_torch.ops.kernels.backend import pack_windows
    from vechat_tpu_torch.ops.kernels.dense import graph_to_dense
    from vechat_tpu_torch.ops.native_graph import make_graph

    packed = []
    while len(packed) < B:
        backbone = rand_seq(rng, min(500, W - 76, N - 80))
        g = make_graph()
        codes = encode(backbone)
        g.add_alignment([], codes, np.ones(len(codes), np.uint32))
        for _ in range(40):
            layer = encode(ont_read(rng, backbone, 0.08))
            aln = g.align_host(layer, "nw", 3, -5, -4)
            g.add_alignment(aln, layer, np.ones(len(layer), np.uint32))
            if g.num_nodes() > N - 60 or g.max_in_degree() >= P:
                break
        d = graph_to_dense(g, N, P)
        if d is None:
            continue
        seqs = [encode(ont_read(rng, backbone, 0.08))[: W - 1] for _ in range(D)]
        packed.append((d, seqs))
    return pack_windows(packed, N, P, W)


def k1_work(nn_t, deg, real_rows, P, D, W, seqp, slen):
    """(bytes, counted operations) of one K1 launch on this run's data: the
    real rows' graph words, the sequences, the direction rows written and
    the best cells; 18 operations a cell and 5 a real in-edge a cell."""
    B = nn_t.shape[0]
    n_rows = int(nn_t.sum())
    deg_real = int((deg * real_rows[:, 1:]).sum())
    nbytes = (n_rows * (3 + P) * 4 + seqp.nbytes + slen.nbytes
              + (n_rows + B) * D * W * 2 + 3 * B * D * 4)
    return nbytes, n_rows * D * W * K1_OPS_CELL + deg_real * D * W * K1_OPS_EDGE


def k1_k2_phase(device, inputs):
    import torch

    from vechat_tpu_torch.ops.kernels import poa_linear as pl

    codes, preds, sink, nid, nn, seqp, slen = inputs
    B, P, N = preds.shape
    D, W = seqp.shape[1], seqp.shape[2]
    dist = max(pl.max_pred_distance(preds[b].T, nn[b, 0, 0]) for b in range(B))
    log(f"K1/K2 inputs: {B} windows, nodes {int(nn.min())}-{int(nn.max())}, "
        f"max predecessor distance {dist}, D={D}, W={W}")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    codes_t, sink_t = t(codes).reshape(B, N), t(sink).reshape(B, N)
    nid_t = t(nid).reshape(B, N)
    nn_t, seqp_t, slen_t = t(nn).reshape(B), t(seqp), t(slen).reshape(B, D)
    preds_t = t(preds)
    rows = torch.arange(N + 1, device=device)[None, :]
    real_rows = rows <= nn_t[:, None]  # rows the kernel writes
    results = {}
    # the ring the backend picks (the largest predecessor distance) keeps
    # the H ring in shared memory; 511, the largest ring the 9-bit delta
    # field allows, keeps it in global memory
    for mode, ring in (("nw", dist), ("sw", dist), ("nw", 511), ("sw", 511)):
        aux, deg = pl.pack_aux(preds_t, ring)
        args = (codes_t, aux, deg, sink_t, nn_t, seqp_t, slen_t, mode, 3, -5, -4, ring)
        k_out = pl.poa_dp(*args)
        p_out = pl._dp_plain(*args)
        torch.cuda.synchronize()
        err = 0
        for name, a, b in zip(("dirs", "maxi", "maxj", "score"), k_out, p_out):
            if name == "dirs":
                a, b = a[real_rows], b[real_rows]
            bad = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            if bad:
                raise RuntimeError(f"K1 {mode} ring {ring}: {name} differs by {bad}")
            err = max(err, bad)
        dirs, maxi, maxj, _ = k_out
        L = N + W
        shape = f"B={B} N={N} D={D} W={W} P={P} ring={ring} {mode}"
        walk_rows = walk_expand_rows(dirs, maxi, maxj, nid_t, mode, P, shape)
        kr, ks, kc = pl.traceback_walk_rle(dirs, maxi, maxj, mode, L, P)
        # the dense walk (the sharded route's): against its plain version,
        # whole buffers, with ranks and with node ids, and its pairs against
        # K2's expanded
        kd = pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P)
        pd = pl._walk_dense_plain(dirs, maxi, maxj, mode, L, P)
        err3 = _max_err(f"dense walk {mode} ring {ring}", ("pn", "pp", "count"), kd, pd)
        err3 = max(err3, _max_err(f"dense walk {mode} ring {ring} node ids", ("pn", "pp", "count"),
                                  pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P, nid_t),
                                  pl._walk_dense_plain(dirs, maxi, maxj, mode, L, P, nid_t)))
        _dense_equals_rle(kd, kr[:ks], kc, f"{mode} ring {ring}")
        ms1 = time_ms(lambda: pl.poa_dp(*args))
        pms1 = time_ms(lambda: pl._dp_plain(*args), reps=2)
        ms3 = time_ms(lambda: pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P))
        kms3 = dense_kernel_ms(dirs, maxi, maxj, mode, L, P, kd, shape)
        pms3 = time_ms(lambda: pl._walk_dense_plain(dirs, maxi, maxj, mode, L, P), reps=2)
        # bound inputs from this run's data
        k1_bytes, k1_ops = k1_work(nn_t, deg, real_rows, P, D, W, seqp, slen)
        # the dense walk reads one int16 word a step (one step a pair) and
        # writes both [B, D, L] int16 buffers whole: the -2 fill is output
        pairs = int(kd[2].sum())
        kd_bytes = pairs * 2 + 2 * B * D * L * 2 + B * D * 12
        kd_ops = pairs * WALK_OPS_STEP
        rows = {}
        for name, ms, pms, nb, ops, e in (("poa_dp", ms1, pms1, k1_bytes, k1_ops, err),
                                          ("poa_walk_dense", ms3, pms3, kd_bytes, kd_ops, err3)):
            b_ms, b_by = bound_ms(nb, ops)
            rows[name] = dict(kernel=name, shape=shape, ms=ms, plain_ms=pms, max_abs_err=e,
                              bound_ms=b_ms, bound_by=b_by)
            if name == "poa_walk_dense":
                rows[name]["kernel_ms"] = kms3
            log_row(rows[name])
        rows.update(walk_rows)
        if (mode, ring) == ("nw", dist):  # the ring the backend picks
            results.update(rows)
    return results


# K2's inputs are rotated over this many copies of `dirs` when its kernel
# alone is timed: each copy's walks read tens of MB of it, so that together
# they are many times the L2 and every launch reads from device memory
K2_COPIES = 8


def walk_expand_rows(dirs, maxi, maxj, nid_t, mode, P, shape, label=""):
    """K2 and the expansion on K1's `dirs`, each held to its plain version
    (exact: every header, steps, count, pairs, offsets) and timed beside it.
    `ms` is the whole call by CUDA events, as for every other kernel (K2:
    the zeroed header buffer, the kernel and the read of `steps`; the
    expansion: the scan of the counts, the read of the total, the kernel and
    the read of its error word). `kernel_ms` is the kernel alone a launch on
    the buffers its wrapper made (`kernel_ms()`: CUDA events around one
    launch would also hold the host's launch of a kernel this short): K2's
    on `K2_COPIES` copies of `dirs` in turn, so with a cold L2; the
    expansion's on one copy of its inputs, so with the headers in the L2,
    as on the main path, where K2 has just written them. Returns {name:
    row}."""
    import torch

    from vechat_tpu_torch.ops.kernels import poa_linear as pl

    B, N1, D, W = dirs.shape
    L = N1 - 1 + W
    kr, ks, kc = pl.traceback_walk_rle(dirs, maxi, maxj, mode, L, P)
    pr, ps, pc = pl._walk_plain(dirs, maxi, maxj, mode, L, P)
    err2 = _walk_err(kr, ks, kc, pr, ps, pc)
    if err2:
        raise RuntimeError(f"K2 {shape}: walk differs from plain by {err2}")
    kp, ko = pl.expand_walk_pairs(kr, ks, kc, nid_t)
    err4 = _max_err(f"expansion {shape}", ("pairs", "offsets"), (kp, ko),
                    pl._expand_plain(pr, ps, pc, nid_t))
    ms2 = time_ms(lambda: pl.traceback_walk_rle(dirs, maxi, maxj, mode, L, P))
    k_runs, k_count = torch.zeros_like(kr), torch.empty_like(kc)
    k_steps = torch.zeros(1, dtype=torch.int32, device=dirs.device)
    dirs_c = [dirs] + [dirs.clone() for _ in range(K2_COPIES - 1)]
    kms2 = kernel_ms(lambda r: pl.launch_walk(dirs_c[r], maxi, maxj, k_runs, k_count, k_steps,
                                              mode, L, P), copies=K2_COPIES)
    del dirs_c
    if not (torch.equal(k_runs, kr) and torch.equal(k_count, kc)):
        raise RuntimeError(f"K2 {shape}: the timed launches differ from the wrapper's")
    pms2 = time_ms(lambda: pl._walk_plain(dirs, maxi, maxj, mode, L, P), reps=2)
    cnt = kc.reshape(-1)
    err = torch.zeros(1, dtype=torch.int32, device=dirs.device)
    kms4 = kernel_ms(lambda r: pl.launch_expand(kr, ks, cnt, ko, nid_t, kp, err))
    if int(err.item()):
        raise RuntimeError(f"expansion {shape}: the timed launches flagged a count mismatch")
    ms4 = time_ms(lambda: pl.expand_walk_pairs(kr, ks, kc, nid_t))
    pms4 = time_ms(lambda: pl._expand_plain(kr, ks, kc, nid_t), reps=2)
    headers = int((kr != 0).sum())
    longest = int((kr != 0).sum(dim=0).max()) if kr.numel() else 0
    total = kp.shape[0]
    rows = {}
    for name, ms, kms, pms, (nb, ops), e in (
            ("poa_walk", ms2, kms2, pms2, k2_work(headers, B * D), err2),
            ("poa_expand", ms4, kms4, pms4, expand_work(headers, B * D, nid_t.numel(), total),
             err4)):
        b_ms, b_by = bound_ms(nb, ops)
        rows[name] = dict(kernel=name, shape=shape + label, ms=ms, kernel_ms=kms, plain_ms=pms,
                          max_abs_err=e, bound_ms=b_ms, bound_by=b_by, headers=headers,
                          longest_walk_headers=longest, pairs=total)
    for row in rows.values():
        log_row(row)
    return rows


def dense_kernel_ms(dirs, maxi, maxj, mode, L, P, out, shape):
    """The dense walk's kernel alone (`kernel_ms()`), ranks in pn, on the
    buffers of a wrapper's output `out` = (pn, pp, count) and `K2_COPIES`
    copies of `dirs` in turn, so with a cold L2 as K2's; raises unless the
    timed launches wrote what the wrapper did."""
    import torch

    from vechat_tpu_torch.ops.kernels import poa_linear as pl

    pn, pp, count = (torch.empty_like(t) for t in out)
    dirs_c = [dirs] + [dirs.clone() for _ in range(K2_COPIES - 1)]
    kms = kernel_ms(lambda r: pl.launch_walk_dense(dirs_c[r], maxi, maxj, None, pn, pp, count,
                                                   mode, L, P), copies=K2_COPIES)
    del dirs_c
    if not all(torch.equal(a, b) for a, b in zip((pn, pp, count), out)):
        raise RuntimeError(f"dense walk {shape}: the timed launches differ from the wrapper's")
    return kms


def k2_work(headers, BD):
    """(bytes, counted operations) of one K2 launch on this run's data: a
    step reads one int16 code and writes one int32 header, a walk reads its
    start cell and writes its count; 20 operations a step."""
    return headers * (2 + 4) + BD * 12, headers * WALK_OPS_STEP


def expand_work(headers, BD, n_node_ids, pairs):
    """(bytes, counted operations) of one expansion on this run's data: the
    headers, counts and offsets read, the node ids read once, the int16
    pairs written; 10 operations a pair."""
    return headers * 4 + BD * (4 + 8) + n_node_ids * 4 + pairs * 4, pairs * EXPAND_OPS_PAIR


def _dense_equals_rle(dense, runs, count, label):
    """The dense walk's pairs are the run-length walk's, expanded."""
    from vechat_tpu_torch.ops.kernels.poa_linear import runs_to_pairs_np

    pn, pp, cnt = (t.cpu().numpy() for t in dense)
    runs = runs.cpu().numpy()
    if not (cnt == count.cpu().numpy()).all():
        raise RuntimeError(f"dense walk {label}: counts differ from the run-length walk's")
    B, D, L = pn.shape
    for b in range(B):
        for d in range(D):
            c = int(cnt[b, d])
            rn, rp = runs_to_pairs_np(runs[:, b * D + d])
            if not ((pn[b, d, L - c:] == rn).all() and (pp[b, d, L - c:] == rp).all()):
                raise RuntimeError(f"dense walk {label}: pairs of walk ({b}, {d}) differ "
                                   "from the run-length walk's expanded")


def mix_peak_phase(device):
    """K7 against its plain version (every lane of the four chains and the
    checksum, exact), then the measurement: the sustained rate of the DP
    kernels' int32 mix beside the data sheet's INT32 rate."""
    import torch

    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.utils import roofline as rf

    T = torch.cuda.get_device_properties(device).multi_processor_count
    names = ("a", "b", "c", "d", "checksum")
    chains = rf.mix_inputs(T, SEED, device)
    for iters in (1, 8):
        _max_err(f"K7 iters={iters}", names, rf.mix_peak(*chains, iters, SEED),
                 rf._mix_plain(*chains, iters, SEED),
                 again=lambda: rf.mix_peak(*chains, iters, SEED))
    _build.reset_launches()
    m = rf.measure_mix_peak(device=device, seed=SEED)
    launches = _build.LAUNCHES["mix_peak"]
    iters = m["iters"]
    # at the measurement's own depth: once more against the plain version
    # (that run is the plain timing's warm-up)
    err = _max_err(f"K7 iters={iters}", names, rf.mix_peak(*chains, iters, SEED),
                   rf._mix_plain(*chains, iters, SEED),
                   again=lambda: rf.mix_peak(*chains, iters, SEED))
    plain_ms = time_ms(lambda: rf._mix_plain(*chains, iters, SEED), warmup=0, reps=2)
    elems = T * rf.ROWS * rf.COLS
    rounds = 4 * iters * elems  # element rounds: four chains a round each
    b_ms, b_by = bound_ms(8 * elems * 4 + T * 4, MIX_INT32_SLOTS_ROUND * rounds)
    row = dict(kernel="mix_peak", shape=f"T={T} tiles [64, 512] x 4 chains, iters={iters}",
               ms=m["ms_iters"], plain_ms=plain_ms, max_abs_err=err,
               bound_ms=b_ms, bound_by=b_by, launches=launches,
               ms_of_counted_operations_at_paper_rate=(
                   rf.OPS_PER_ROUND * rounds / INT32_OPS_PER_S * 1e3))
    log_row(row)
    MEASURED["mix_ops_per_s"] = m["ops_per_s"]
    log(dict(phase="mix_peak", tops=m["tops"], paper_int32_tops=INT32_OPS_PER_S / 1e12,
             share_of_paper_int32_rate=m["ops_per_s"] / INT32_OPS_PER_S,
             ms_iters=m["ms_iters"], ms_2iters=m["ms_2iters"], iters=iters, tiles=T,
             roll=m["roll"]))
    return {"mix_peak": row}


def gap_kinds():
    """kind: (int16 rings, DP, plain DP, walk, plain walk, operations per
    cell, per in-edge per cell, the bytes the rings may take in shared
    memory, the DP's lanes a thread at a width, its C launcher, the walk's
    C launcher `poa_gap.launch_walk3` bound to its library) of K5/K5w and
    K6/K6w."""
    import functools

    from vechat_tpu_torch.ops.kernels import poa_affine as pa
    from vechat_tpu_torch.ops.kernels import poa_convex as pc
    from vechat_tpu_torch.ops.kernels.poa_gap import launch_walk3

    return {
        "affine": (2, pa.poa_dp_affine, pa._dp_affine_plain, pa.traceback_walk_affine,
                   pa._walk_affine_plain, K5_OPS_CELL, K5_OPS_EDGE, pa.K5_SMEM_RING_MAX,
                   pa.k5_lanes_per_thread, pa.launch_dp_affine,
                   functools.partial(launch_walk3, pa._lib, "poa_walk_affine")),
        "convex": (3, pc.poa_dp_convex, pc._dp_convex_plain, pc.traceback_walk_convex,
                   pc._walk_convex_plain, K6_OPS_CELL, K6_OPS_EDGE, pc.K6_SMEM_RING_MAX,
                   pc.k6_lanes_per_thread, pc.launch_dp_convex,
                   functools.partial(launch_walk3, pc._lib, "poa_walk_convex")),
    }


def gap_dp_work(nn_t, deg, real_rows, P, D, W, seqp, slen, ops_cell, ops_edge):
    """(bytes, counted operations) of one K5 or K6 launch on this run's
    data: the real rows' graph words and the sequences read once, the real
    direction rows and the best cells written once; `ops_cell` a cell and
    `ops_edge` a cell and real in-edge."""
    B = nn_t.shape[0]
    n_rows = int(nn_t.sum())
    deg_real = int((deg * real_rows[:, 1:]).sum())
    nbytes = (n_rows * (3 + P) * 4 + seqp.nbytes + slen.nbytes
              + (n_rows + B) * D * W * 4 + 3 * B * D * 4)
    return nbytes, n_rows * D * W * ops_cell + deg_real * D * W * ops_edge


def check_gap_launch(device, kind, arrays, mode, scores, ring, time_plain):
    """One launch of K5 or K6 and of its walk on `arrays` (the JAX layout of
    `pack_windows`) against the plain versions: exact equality of dirs (rows
    the kernel writes), best cells, scores, pairs and counts; the walk in
    DP ranks and in node ids (the spoa path's call, whose wrapper `ms` is).
    Returns the DP's and the walk's rows (times, bound); `plain_ms` only
    with `time_plain`. Both rows also have the kernel alone (`kernel_ms`:
    24 launches of its C launcher on buffers made once, in a CUDA graph,
    `kernel_ms()`, then held to the wrapper's outputs); the DP's has the
    launch's real rows and the microseconds a row, the ring's memory and
    the lanes a thread; the walk's has the longest walk's steps and tiles,
    and the microseconds a step of that walk."""
    import torch

    from vechat_tpu_torch.ops.kernels import _build, poa_gap
    from vechat_tpu_torch.ops.kernels.poa_affine import pack_aux_gap

    (n_rings, dp, dp_plain, walk, walk_plain, ops_cell, ops_edge, smem_max, lanes,
     launch, walk_launch) = gap_kinds()[kind]
    codes, preds, sink, nid, nn, seqp, slen = arrays
    B, P, N = preds.shape
    D, W = seqp.shape[1], seqp.shape[2]
    L = 2 * N + W
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    nn_t = t(nn).reshape(B)
    real_rows = torch.arange(N + 1, device=device)[None, :] <= nn_t[:, None]
    aux, deg = pack_aux_gap(t(preds), ring)
    args = (t(codes).reshape(B, N), aux, deg, t(sink).reshape(B, N), nn_t, t(seqp),
            t(slen).reshape(B, D), mode, *scores, ring)
    in_smem = n_rings * (ring + 1) * W * 2 <= smem_max
    shape = (f"B={B} N={N} D={D} W={W} P={P} ring={ring} "
             f"({'shared' if in_smem else 'global'}) {mode}")
    label = f"{kind} {shape}"
    k_out = dp(*args)
    p_out = dp_plain(*args)
    err = _max_err(f"{label} DP", ("dirs", "maxi", "maxj", "score"),
                   (k_out[0][real_rows], *k_out[1:]), (p_out[0][real_rows], *p_out[1:]))
    del p_out
    dirs, maxi, maxj, _ = k_out
    nid_t = t(nid).reshape(B, N)
    kw = walk(dirs, maxi, maxj, mode, L, P)
    err2 = _max_err(f"{label} walk", ("pn", "pp", "count"), kw,
                    walk_plain(dirs, maxi, maxj, mode, L, P))
    kw = walk(dirs, maxi, maxj, mode, L, P, nid_t)  # node ids, as the spoa path calls it
    err2 = max(err2, _max_err(f"{label} walk, node ids", ("pn", "pp", "count"), kw,
                              walk_plain(dirs, maxi, maxj, mode, L, P, nid_t)))
    ms1 = time_ms(lambda: dp(*args))
    ms2 = time_ms(lambda: walk(dirs, maxi, maxj, mode, L, P, nid_t))
    n_rows = int(nn_t.sum())
    lpt = lanes(W)
    out = poa_gap.dp_buffers(B, N, D, W, ring, n_rings, device, smem_max)
    kms = kernel_ms(lambda r: launch(*args, out, lpt))
    # the graph's launches wrote what the wrapper's did
    _max_err(f"{label} DP alone", ("dirs", "maxi", "maxj", "score"),
             (out[0][real_rows], *out[1:4]), (k_out[0][real_rows], *k_out[1:]))
    alone = dict(kernel_ms=kms, rows=n_rows, us_per_row=kms * 1e3 / max(n_rows, 1),
                 ring_memory="shared" if in_smem else "global", lanes_per_thread=lpt)
    w_out = tuple(torch.empty_like(x) for x in kw)
    tiles = torch.zeros((B, D), dtype=torch.int32, device=device)

    def walk_alone(r):
        rc = walk_launch(dirs, maxi, maxj, nid_t, w_out, mode, L, P, tiles=tiles)
        _build.check(_build.get_lib(f"poa_{kind}"), rc, f"poa_walk_{kind}")

    w_kms = kernel_ms(walk_alone)
    _max_err(f"{label} walk alone", ("pn", "pp", "count"), w_out, kw)
    longest = int(kw[2].reshape(-1).argmax())
    w_steps = int(kw[2].reshape(-1)[longest])
    walk_row = dict(kernel_ms=w_kms, steps=w_steps, tiles=int(tiles.reshape(-1)[longest]),
                    us_per_step=w_kms * 1e3 / max(w_steps, 1))
    pms1 = pms2 = None
    if time_plain:  # the comparison runs above were the warm-up
        pms1 = time_ms(lambda: dp_plain(*args), warmup=0, reps=2)
        pms2 = time_ms(lambda: walk_plain(dirs, maxi, maxj, mode, L, P), warmup=0, reps=2)
    dp_bytes, dp_ops = gap_dp_work(nn_t, deg, real_rows, P, D, W, seqp, slen, ops_cell, ops_edge)
    # a walk step reads one word, a node step also its node id (pn >= 0);
    # the walk writes both rows whole and its count, and reads its start cell
    steps = int(kw[2].sum())
    walk_bytes = steps * 4 + int((kw[0] >= 0).sum()) * 4 + 2 * B * D * L * 4 + B * D * 12
    rows = []
    for name, ms, pms, nb, ops, e in (
        (f"poa_dp_{kind}", ms1, pms1, dp_bytes, dp_ops, err),
        (f"poa_walk_{kind}", ms2, pms2, walk_bytes, steps * WALK3_OPS_STEP, err2),
    ):
        b_ms, b_by = bound_ms(nb, ops)
        rows.append(dict(kernel=name, shape=shape, scores="/".join(map(str, scores)), ms=ms,
                         plain_ms=pms, max_abs_err=e, bound_ms=b_ms, bound_by=b_by))
        rows[-1].update(alone if name == f"poa_dp_{kind}" else walk_row)
        log_row(rows[-1])
    return rows


def gap_kernels_phase(device, inputs):
    """K5/K5w and K6/K6w at the batched shape of K1/K2 (no path launches them
    so yet; the spoa path's own shapes are `gap_path_phase`): the window
    graphs at the largest predecessor distance and at the first ring past
    shared memory, in nw and sw, and ov once."""
    from vechat_tpu_torch.ops.kernels.poa_linear import max_pred_distance

    preds, nn, seqp = inputs[1], inputs[4], inputs[5]
    B, P, N = preds.shape
    D, W = seqp.shape[1], seqp.shape[2]
    dist = max(max_pred_distance(preds[b].T, nn[b, 0, 0]) for b in range(B))
    log(f"K5/K6 batched inputs: the {B} windows of K1/K2, D={D}, W={W}, dirs "
        f"{(N + 1) * B * D * W * 4 / 1e6:.0f} MB (int32) per launch")
    for kind, scores in (("affine", AFFINE_SCORES), ("convex", CONVEX_SCORES)):
        # the first ring whose int16 rings of R+1 rows leave shared memory
        n_rings, smem_max = gap_kinds()[kind][0], gap_kinds()[kind][7]
        r_global = max(dist, smem_max // (n_rings * W * 2))
        for mode, ring in (("nw", dist), ("sw", dist), ("ov", dist), ("nw", r_global),
                           ("sw", r_global)):
            check_gap_launch(device, kind, inputs, mode, scores, ring, time_plain=False)


def spoa_launch_inputs(device, reads, scores):
    """The launches of one nw spoa run, as `cli/spoa_main.py` makes them: the
    graph grows read by read through the engine on the card, and each
    alignment is one launch at B=1, D=1 in the graph's buckets at the ring
    the engine picks. Returns {(node bucket, in-edge bucket): (arrays,
    ring)} of the last launch at each shape; stops where the engine would
    go to the host."""
    from vechat_tpu_torch.ops.encode import encode
    from vechat_tpu_torch.ops.kernels.graph_engine import TorchGraphEngine
    from vechat_tpu_torch.ops.poagraph import PoaGraph

    engine = TorchGraphEngine("nw", *scores, device=device)
    graph = PoaGraph()
    launches = {}
    for read in reads:
        codes = encode(read)
        aln = []
        if graph.num_nodes():
            packed = engine.pack(codes, graph)
            if packed is None:
                break
            launches[packed[0][1].shape[:0:-1]] = packed  # preds [1, P, N]
            aln = engine.align(codes, graph)
        graph.add_alignment(aln, codes, np.ones(len(codes), np.uint32))
    return launches


def gap_path_phase(device, reads):
    """K5/K5w and K6/K6w at the shapes the spoa path gives them (phase 4's
    reads and scores; one block, B=1 D=1): the last launch at each (node
    bucket, in-edge bucket) the run reaches, nw for every score set, sw and
    ov for the affine one at its largest shape. The `kernels` line takes each
    kernel's row from the largest nw launch (the graph with all but the last
    read in it), where the plain versions are timed too."""
    results = {}
    for kind, scores, modes in (
        ("affine", AFFINE_SCORES, ("nw", "sw", "ov")),
        ("convex", CONVEX_SCORES, ("nw",)),  # the CLI defaults: 640 bucket only
        ("convex", CONVEX_SMALL_SCORES, ("nw",)),
    ):
        launches = spoa_launch_inputs(device, reads, scores)
        top = max(launches)
        for shape in sorted(launches):
            arrays, ring = launches[shape]
            for mode in modes if shape == top else ("nw",):
                rows = check_gap_launch(device, kind, arrays, mode, scores, ring,
                                        time_plain=shape == top and mode == "nw")
                if mode == "nw":
                    for row in rows:
                        results[row["kernel"]] = row
    return results


def _walk_err(kr, ks, kc, pr, ps, pc):
    """K2 against its plain version: the largest difference of any decoded
    header field (first pair's rank and position, run length) over all
    steps, of any walk's pair count, and of the step counts."""
    import torch

    from vechat_tpu_torch.ops.kernels import poa_linear as pl

    torch.cuda.synchronize()

    def fields(runs):
        runs = runs.to(torch.int64)
        return (runs >> pl.RUN_PN_SHIFT, (runs >> pl.RUN_R_BITS) & ((1 << pl.RUN_PP_BITS) - 1),
                runs & ((1 << pl.RUN_R_BITS) - 1))

    err = abs(ks - ps)
    for a, b in zip(fields(kr), fields(pr)):
        err = max(err, int((a - b).abs().max()))
    return max(err, int((kc.to(torch.int64) - pc.to(torch.int64)).abs().max()))


NW_OUTPUTS = ("pt", "pq", "count", "dist")
K3_ARGS = ("t", "ext", "tlen", "qlen", "lo")  # banded_nw's tensors, in order


def nw_pairs(rng, n, lo, hi, rate):
    from vechat_tpu_torch.ops.encode import encode

    pairs = []
    for _ in range(n):
        t = rand_seq(rng, int(rng.integers(lo, hi)))
        q = ont_read(rng, t, rate)[:hi]
        pairs.append((encode(q), encode(t)))
    return pairs


def k3_inputs(rng, device, T=2560, BW=896, NP=256):
    """Phase 1's K3 inputs as `banded_nw`'s arguments on `device`: NP - 1
    pairs of 70-100% of T at 8% ONT-profile error and one pair far beyond
    the band (rejected, but its clipped walk must end)."""
    from vechat_tpu_torch.ops.encode import encode
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw

    pairs = nw_pairs(rng, NP - 1, T * 7 // 10, T - 10, 0.08)
    pairs.append((encode(rand_seq(rng, T * 3 // 4)), encode(rand_seq(rng, T * 3 // 4 + BW // 8))))
    return pw.banded_inputs(*pw.pack_banded(pairs, T, BW), BW, device)


def k3_work(tl, T, BW):
    """(bytes, counted operations) of one K3 launch on this run's data: the
    real rows' target codes, the query windows, the lengths and band
    offsets, pt/pq and count/dist; 15 operations a cell of the real rows."""
    NP = tl.shape[0]
    rows = int(tl.sum())
    nbytes = rows * 4 + int((tl + BW).sum()) * 4 + NP * 12 + NP * (T + BW) * 2 * 2 + NP * 8
    return nbytes, rows * BW * NW_OPS_CELL


def k3_phase(device, rng, T=2560, BW=896, NP=256):
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw

    t, ext, tl, ql, lo_ = k3_inputs(rng, device, T, BW, NP)
    NP = t.shape[0]
    k_out = pw.banded_nw(t, ext, tl, ql, lo_, BW)
    err = _max_err("K3", NW_OUTPUTS, k_out, pw._banded_plain(t, ext, tl, ql, lo_, BW))
    ms = time_ms(lambda: pw.banded_nw(t, ext, tl, ql, lo_, BW))
    pms = time_ms(lambda: pw._banded_plain(t, ext, tl, ql, lo_, BW), reps=2)
    b_ms, b_by = bound_ms(*k3_work(tl, T, BW))
    accepted = int((k_out[3] <= (BW - 1 - (ql - tl).abs()) // 2 - 2).sum())
    row = dict(kernel="pairwise_banded", shape=f"{NP} pairs T={T} BW={BW}",
               ms=ms, plain_ms=pms, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               accepted=accepted)
    log_row(row)
    return {"pairwise_banded": row}


K4_ARGS = ("t", "q", "tlen", "qlen")  # tiled_nw's tensors, in order


def k4_inputs(rng, device, T=512, W=512, NP=64):
    """Phase 1's K4 inputs as `tiled_nw`'s arguments on `device`: NP tiles
    of 80-100% of T at 8% ONT-profile error."""
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw

    tiles = nw_pairs(rng, NP, T * 4 // 5, T - 1, 0.08)
    return pw.tiled_inputs(*pw.pack_tiles(tiles, T, W), device)


def k4_work(tl, ql, T, W):
    """(bytes, counted operations) of one K4 launch on this run's data: the
    real rows' target codes, the real query codes, the lengths, pt/pq
    (int32) and count/dist; 15 operations a cell the result depends on, the
    real rows' lanes 0..qlen (the walk starts at (tlen, qlen) and dist reads
    lane qlen, so no lane past it counts)."""
    NP = tl.shape[0]
    rows = int(tl.sum())
    nbytes = rows * 4 + int(ql.sum()) * 4 + NP * 8 + NP * (T + W) * 4 * 2 + NP * 8
    return nbytes, int((tl.long() * (ql.long() + 1)).sum()) * NW_OPS_CELL


def k4_kernel_fn(args):
    """A callable that launches K4 alone through its C launcher on `args`
    (`tiled_nw`'s tensors) and buffers made once, for `kernel_ms`."""
    import torch

    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw

    t, q, tl, ql = args
    (NP, T), W = t.shape, q.shape[1]
    lib = pw._lib()
    dev = t.device
    scratch = torch.empty(NP * lib.tiled_scratch_bytes(T, W), dtype=torch.uint8, device=dev)
    pt, pq = (torch.empty((NP, T + W), dtype=torch.int32, device=dev) for _ in range(2))
    count, dist = (torch.empty(NP, dtype=torch.int32, device=dev) for _ in range(2))

    def launch(_r=0):
        rc = lib.tiled_launch(t.data_ptr(), q.data_ptr(), tl.data_ptr(), ql.data_ptr(),
                              scratch.data_ptr(), pt.data_ptr(), pq.data_ptr(),
                              count.data_ptr(), dist.data_ptr(), NP, T, W,
                              torch.cuda.current_stream(dev).cuda_stream)  # the capture's
        _build.check(lib, rc, "pairwise_tiled")

    return launch


def k4_row(args, label, **extra):
    """K4 on `args` against its plain version (exact), the wrapper's and the
    plain version's CUDA-event times, the kernel alone (`kernel_ms`) and the
    bound. Logs and returns the row."""
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw

    t, q, tl, ql = args
    (NP, T), W = t.shape, q.shape[1]
    k_out = pw.tiled_nw(*args)
    err = _max_err(f"K4 {label}", NW_OUTPUTS, k_out, pw._tiled_plain(*args))
    ms = time_ms(lambda: pw.tiled_nw(*args))
    kms = kernel_ms(k4_kernel_fn(args))
    pms = time_ms(lambda: pw._tiled_plain(*args), reps=2)
    b_ms, b_by = bound_ms(*k4_work(tl, ql, T, W))
    row = dict(kernel="pairwise_tiled", **extra, shape=f"{NP} tiles T={T} W={W}{label}", ms=ms,
               kernel_ms=kms, plain_ms=pms, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               rows=int(tl.sum()), steps=int(k_out[2].sum()))
    log_row(row)
    return row


def k4_phase(device, rng, T=512, W=512, NP=64):
    return {"pairwise_tiled": k4_row(k4_inputs(rng, device, T, W, NP), "")}


def _max_err(label, names, k_out, p_out, again=None):
    """The largest difference between a kernel's outputs and its plain
    version's; raises if there is any (the tolerance is exact). The error
    names how many elements differ, the first of them with both values and
    the bits they differ in, and, where `again` is given (a callable that
    runs the kernel once more on the same inputs), whether that second run
    gives the same value there: a fault that does not repeat is told from
    one of the code."""
    import torch

    torch.cuda.synchronize()
    err = 0
    for i, (name, a, b) in enumerate(zip(names, k_out, p_out)):
        if a.shape != b.shape:
            raise RuntimeError(f"{label}: {name} has shape {tuple(a.shape)}, plain "
                               f"{tuple(b.shape)}")
        if a.numel() == 0:
            continue
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
        bad = int(diff.max())
        if bad:
            where = (diff != 0).nonzero()
            at = tuple(int(x) for x in where[0])
            ka, pa = int(a[at]), int(b[at])
            msg = (f"{label}: {name} differs from plain by {bad} in {len(where)} of "
                   f"{a.numel()} elements; first at {at}: kernel {ka}, plain {pa}, "
                   f"bits {(ka ^ pa) & 0xFFFFFFFF:#010x}")
            if again is not None:
                second = again()[i]
                torch.cuda.synchronize()
                ka2 = int(second[at])
                same = bool((second.to(torch.int64) == b.to(torch.int64)).all())
                msg += (f"; the kernel run again gives {ka2} there and "
                        f"{'equals plain everywhere' if same else 'still differs from plain'}")
            raise RuntimeError(msg)
        err = max(err, bad)
    return err


# -------------------------------------------------------- phase 2: goldens


DATA = os.path.join(REPO, "tests", "data")
# (reads, the committed expected output, the flags it was made with)
GOLDENS = (
    (os.path.join(DATA, "golden_reads.fq"), os.path.join(DATA, "golden_expected.fa"),
     ["--platform", "ont"]),
    (os.path.join(DATA, "golden2_reads.fq"), os.path.join(DATA, "golden2_expected_pb.fa"),
     ["--platform", "pb", "--no-auto-sensitive"]),
)


def goldens_phase(tmp):
    from vechat_tpu_torch.cli.vechat_main import main

    for reads, expected, extra in GOLDENS:
        out = os.path.join(tmp, os.path.basename(expected))
        t0 = time.perf_counter()
        rc = main([reads, "-o", out, "--backend", "cuda", *extra])
        wall = time.perf_counter() - t0
        same = _same_bytes(out, expected)
        log(dict(phase="golden", reads=os.path.basename(reads), rc=rc, byte_identical=same,
                 wall_s=wall))
        if rc != 0 or not same:
            raise RuntimeError(f"--backend cuda on {reads} does not reproduce {expected}")


# ------------------------------------------------ phase 3: the main path


def community(rng, tmp, n_reads=200, genome_len=12500, read_len=(2000, 3000), rate=0.08):
    """Two strains 1% apart, reads alternating between them (Q20 FASTQ).
    Read lengths spread evenly over `read_len` (mean 2.5 kb), so the
    longest overlaps exceed the 2560-base banded bucket and take the tiled
    kernel, as longer reads do."""
    from vechat_tpu_torch.io.fastx import SeqRecord, write_fastx

    strain_a = rand_seq(rng, genome_len)
    b = list(strain_a)
    for p in rng.choice(genome_len, size=genome_len // 100, replace=False):
        b[p] = rng.choice([c for c in "ACGT" if c != b[p]])
    strain_b = "".join(b)
    reads, truth = [], {}
    for i in range(n_reads):
        src = strain_a if i % 2 == 0 else strain_b
        n = int(rng.integers(read_len[0], read_len[1] + 1))
        start = int(rng.integers(0, genome_len - n))
        frag = src[start : start + n]
        data = ont_read(rng, frag, rate)
        reads.append(SeqRecord(f"r{i}", data, "5" * len(data)))
        truth[f"r{i}"] = (frag, i % 2 == 0, start, data)
    path = os.path.join(tmp, "community.fq")
    write_fastx(reads, path, fmt="fq")
    return path, truth, (strain_a, strain_b)


def device_times(prof):
    """{kernel or copy: ms on the card} of a `torch.profiler` run that
    recorded CUDA activity."""
    device_ms = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us:
            device_ms[ev.key] = device_ms.get(ev.key, 0.0) + us / 1e3
    return device_ms


def main_path_phase(tmp, made, backend_name="cuda"):
    """The main path on `made`, what `community` returned."""
    import torch

    from vechat_tpu_torch.cli.vechat_main import build_parser, run
    from vechat_tpu_torch.ops.encode import encode
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw
    from vechat_tpu_torch.ops.pairwise import edit_distance, edit_distance_infix
    from vechat_tpu_torch.utils.logger import Logger

    path, truth, (strain_a, strain_b) = made
    out_path = os.path.join(tmp, "corrected.fa")
    args = build_parser().parse_args(
        [path, "-o", out_path, "--platform", "ont", "--backend", backend_name]
    )
    # K3's and K4's heaviest launches of the run (largest NP*T*BW and
    # NP*T*W, the first of equals): their inputs, kept for phases 3c and 3d;
    # and every K4 launch's, which 3d may save
    heaviest, heaviest_k4 = {}, {"launches": []}
    banded_nw, tiled_nw = pw.banded_nw, pw.tiled_nw

    def keep_heaviest(t, ext, tlen, qlen, lo, BW):
        size = t.shape[0] * t.shape[1] * BW
        if size > heaviest.get("size", 0):
            heaviest.update(size=size, args=(t, ext, tlen, qlen, lo), BW=BW)
        return banded_nw(t, ext, tlen, qlen, lo, BW)

    def keep_heaviest_k4(t, q, tlen, qlen):
        size = t.shape[0] * t.shape[1] * q.shape[1]
        if size > heaviest_k4.get("size", 0):
            heaviest_k4.update(size=size, args=(t, q, tlen, qlen))
        heaviest_k4["launches"].append((t, q, tlen, qlen))
        return tiled_nw(t, q, tlen, qlen)

    _build.reset_launches()
    pw.banded_nw, pw.tiled_nw = keep_heaviest, keep_heaviest_k4
    try:
        # device activity only: CUPTI records every kernel and copy on the card
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            corrected, backend = run(args, Logger())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        pw.banded_nw, pw.tiled_nw = banded_nw, tiled_nw
    launches = dict(_build.LAUNCHES)
    heaviest["k3_shapes"] = dict(_build.K3_SHAPES)
    heaviest_k4["k4_shapes"] = dict(_build.K4_SHAPES)
    # K1's launch shapes in this run, the heaviest (launches x B*D*N*W) first
    k1_shapes = sorted(({"B": B, "D": D, "N": N, "W": W, "P": P, "ring": ring, "launches": n}
                        for (B, D, N, W, P, ring), n in _build.K1_SHAPES.items()),
                       key=lambda r: -r["launches"] * r["B"] * r["D"] * r["N"] * r["W"])
    counters = backend.counters() if hasattr(backend, "counters") else {}
    device_ms = device_times(prof)
    busy_s = sum(device_ms.values()) / 1e3
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    # K1 has an instantiation a lane count, in-edge slots, ring and mode:
    # its device time summed over them
    k1_device_s = sum(v for k, v in device_ms.items() if "poa_dp_kernel<" in k) / 1e3
    k3_device_s = sum(v for k, v in device_ms.items() if "banded_kernel" in k) / 1e3
    k4_device_s = sum(v for k, v in device_ms.items() if "tiled_kernel" in k) / 1e3
    walk_device_s = {k: sum(v for name, v in device_ms.items() if k in name) / 1e3
                     for k in ("poa_walk_kernel", "poa_expand_kernel")}
    stages = {}
    if hasattr(backend, "t_pack"):
        # decode: the pairs' fetch, then the Alignment lists
        stages = dict(poa_pack_s=backend.t_pack, poa_device_s=backend.t_device,
                      poa_decode_s=backend.t_decode,
                      poa_decode_fetch_s=backend.t_decode_fetch,
                      poa_decode_lists_s=backend.t_decode - backend.t_decode_fetch,
                      poa_host_route_s=backend.t_host_fb)
        pw = backend._pairwise
        if pw is not None:
            stages.update(pair_pack_s=pw.t_tile, pair_device_s=pw.t_device,
                          pair_host_s=pw.t_host, pair_cigar_s=pw.t_asm)

    # infix distances against the read's true origin: the corrected read may
    # be trimmed
    pad = 120
    before, after, own_strain = [], [], 0
    for rec in corrected:
        frag, is_a, start, raw = truth[rec.name.split()[0].rstrip("r")]
        lo, hi = max(0, start - pad), start + len(frag) + pad
        own, other = (strain_a, strain_b) if is_a else (strain_b, strain_a)
        d_own = edit_distance_infix(encode(rec.data), encode(own[lo:hi]))
        d_other = edit_distance_infix(encode(rec.data), encode(other[lo:hi]))
        after.append(d_own / max(len(rec.data), 1))
        own_strain += d_own <= d_other
        before.append(edit_distance(encode(raw), encode(frag)) / len(raw))
    err_before, err_after = float(np.mean(before)), float(np.mean(after))
    reduction = err_before / max(err_after, 1e-9)
    log(dict(phase="main_path", reads=len(truth), corrected=len(corrected), wall_s=wall,
             reads_per_s=len(corrected) / wall, error_before=err_before,
             error_after=err_after, reduction=reduction,
             strain_preservation=f"{own_strain}/{len(corrected)}",
             launches=launches, counters=counters, stages_s=stages,
             device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
             poa_dp_kernel_device_s=k1_device_s, banded_kernel_device_s=k3_device_s,
             tiled_kernel_device_s=k4_device_s,
             poa_walk_kernel_device_s=walk_device_s["poa_walk_kernel"],
             poa_expand_kernel_device_s=walk_device_s["poa_expand_kernel"],
             device_ms_top={k: v for k, v in top}, k1_shapes=k1_shapes,
             k3_shapes=[{"T": T, "BW": BW, "NP": NP, "launches": n}
                        for (T, BW, NP), n in sorted(_build.K3_SHAPES.items())],
             k4_shapes=[{"NP": NP, "T": T, "W": W, "launches": n}
                        for (NP, T, W), n in sorted(_build.K4_SHAPES.items())]))
    if backend_name != "cuda":  # a rehearsal on the CPU
        return launches, k1_shapes, heaviest, heaviest_k4
    for k in MAIN_PATH_KERNELS:
        if launches[k] == 0:
            raise RuntimeError(f"kernel {k} was not launched on the main path")
    if counters["device_alignments"] <= counters["fallbacks"]:
        raise RuntimeError(f"host routes dominate: {counters}")
    if not corrected or reduction < 4:
        raise RuntimeError(f"error fell only {reduction:.2f}x (floor 4x)")
    return launches, k1_shapes, heaviest, heaviest_k4


def k1_path_phase(device, k1_shapes, n_shapes=2):
    """Phase 3b: K1 at the main path's own launches, the `n_shapes` heaviest
    of phase 3's tally: window inputs made at each shape, nw at the ring the
    backend would pick (511 where the tally's ring was in global memory and
    that one is not), held to the plain version and both timed; then K2 and
    the expansion on those direction words (`walk_expand_rows`). Returns
    {kernel: row} for each shape, the heaviest first."""
    import torch

    from vechat_tpu_torch.ops.kernels import poa_linear as pl

    rng = np.random.default_rng(SEED + 2)
    rows = []
    for shp in k1_shapes[:n_shapes]:
        B, D, N, W, P = (shp[k] for k in "BDNWP")
        codes, preds, sink, nid, nn, seqp, slen = window_inputs(rng, B, N, P, W, D)
        ring = max(1, max(pl.max_pred_distance(preds[b].T, nn[b, 0, 0]) for b in range(B)))
        if shp["ring"] == "global" and pl.dp_launch_plan(B, D, W, ring, P)["use_smem"]:
            ring = 511
        plan = pl.dp_launch_plan(B, D, W, ring, P)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        nn_t, seqp_t, slen_t = t(nn).reshape(B), t(seqp), t(slen).reshape(B, D)
        aux, deg = pl.pack_aux(t(preds), ring)
        args = (t(codes).reshape(B, N), aux, deg, t(sink).reshape(B, N), nn_t, seqp_t, slen_t,
                "nw", 3, -5, -4, ring)
        k_out = pl.poa_dp(*args)
        p_out = pl._dp_plain(*args)
        real_rows = torch.arange(N + 1, device=device)[None, :] <= nn_t[:, None]
        err = _max_err(f"K1 at the main path's {shp}", ("dirs", "maxi", "maxj", "score"),
                       (k_out[0][real_rows], *k_out[1:]), (p_out[0][real_rows], *p_out[1:]))
        ms = time_ms(lambda: pl.poa_dp(*args))
        pms = time_ms(lambda: pl._dp_plain(*args), reps=2)
        b_ms, b_by = bound_ms(*k1_work(nn_t, deg, real_rows, P, D, W, seqp, slen))
        shape = (f"B={B} N={N} D={D} W={W} P={P} ring={ring} "
                 f"({'shared' if plan['use_smem'] else 'global'}) nw")
        row = dict(kernel="poa_dp", phase="3b", launches_in_phase_3=shp["launches"],
                   shape=shape, ms=ms, plain_ms=pms, max_abs_err=err, bound_ms=b_ms,
                   bound_by=b_by)
        log_row(row)
        walk_rows = walk_expand_rows(*k_out[:3], t(nid).reshape(B, N), "nw", P, shape,
                                     label=" (3b: K1's direction words)")
        rows.append({"poa_dp": row, **walk_rows})
        if len(rows) == 1:
            runs, steps, count = pl.traceback_walk_rle(*k_out[:3], "nw", N + W, P)
            pairs, offsets = pl.expand_walk_pairs(runs, steps, count, t(nid).reshape(B, N))
            decode_lists_row(pairs, offsets, count, shape)
    return rows


def _lists_records(p, off, cnt):
    """One tolist() of the pairs viewed as (int16, int16) records: numpy
    makes the tuples."""
    pair = np.dtype([("node", np.int16), ("pos", np.int16)])
    flat = p.view(pair).reshape(-1).tolist()
    return [flat[o : o + c] for o, c in zip(off, cnt)]


def _lists_zip_whole(p, off, cnt):
    """Two tolist()s zipped once into one list of tuples, sliced a walk."""
    flat = list(zip(*p.T.tolist()))
    return [flat[o : o + c] for o, c in zip(off, cnt)]


def decode_lists_row(pairs, offsets, count, shape, rounds=6):
    """The batched backend's list building (its `pair_lists`) beside the
    other ways to build the same lists, on one launch's expansion fetched
    to the host, on this machine's CPU: each builder `rounds` times, the
    order reversed every round, the garbage collector run before each call.
    Logs the median seconds of each and of a pair."""
    import gc

    from vechat_tpu_torch.ops.kernels.backend import pair_lists

    p, off, cnt = pairs.cpu().numpy(), offsets.tolist(), count.reshape(-1).tolist()
    # the backend's zips two lists' slices a walk; a run that times it
    # slower than another says which to take
    builders = dict(backend=pair_lists, records=_lists_records, zip_whole=_lists_zip_whole)
    want = pair_lists(p, off, cnt)
    for name, fn in builders.items():
        if fn(p, off, cnt) != want:
            raise RuntimeError(f"decode lists: {name} differs from the backend's pair_lists")
    del want
    times = {name: [] for name in builders}
    order = list(builders)
    for _ in range(rounds):
        for name in order:
            gc.collect()
            t0 = time.perf_counter()
            out = builders[name](p, off, cnt)
            times[name].append(time.perf_counter() - t0)
            del out
        order.reverse()
    med = {name: statistics.median(v) for name, v in times.items()}
    log(dict(phase="3b", decode_lists=shape, pairs=len(p), walks=len(cnt), median_s=med,
             us_a_pair={name: v / max(1, len(p)) * 1e6 for name, v in med.items()},
             times_s=times))


def k3_path_phase(heaviest, save_path=None):
    """Phase 3c: K3 on exactly the inputs of the main path's heaviest launch
    (`main_path_phase` kept them), held to its plain version and both
    timed; with `save_path`, the inputs are also saved there (npz) for
    `k1_probe.py time-k3 --inputs`. Returns the row."""
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw

    args, BW = heaviest["args"], heaviest["BW"]
    NP, T = args[0].shape
    if save_path:
        np.savez(save_path, BW=BW, **{k: a.cpu().numpy() for k, a in zip(K3_ARGS, args)})
    k_out = pw.banded_nw(*args, BW)
    err = _max_err(f"K3 at the main path's {NP} pairs T={T} BW={BW}", NW_OUTPUTS, k_out,
                   pw._banded_plain(*args, BW))
    ms = time_ms(lambda: pw.banded_nw(*args, BW))
    pms = time_ms(lambda: pw._banded_plain(*args, BW), reps=2)
    b_ms, b_by = bound_ms(*k3_work(args[2], T, BW))
    tl, ql = args[2], args[3]
    row = dict(kernel="pairwise_banded", phase="3c",
               launches_in_phase_3=heaviest["k3_shapes"][(T, BW, NP)],
               shape=f"{NP} pairs T={T} BW={BW} (the main path's heaviest launch)",
               ms=ms, plain_ms=pms, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               accepted=int((k_out[3] <= (BW - 1 - (ql - tl).abs()) // 2 - 2).sum()))
    log_row(row)
    return row


def k4_path_phase(heaviest, save_path=None):
    """Phase 3d: K4 on exactly the inputs of the main path's heaviest launch
    (`main_path_phase` kept them), held to its plain version and both
    timed, with the kernel alone; with `save_path`, the inputs are also
    saved there (npz, `K4_ARGS`), and those of every K4 launch of phase 3
    (`launch{i}_` before each name), for `k1_probe.py time-k4 --inputs`.
    Raises if phase 3 launched K4 at no size: the community's longest
    overlaps are meant to pass the banded bucket. Returns the row."""
    if "args" not in heaviest:
        raise RuntimeError("phase 3 launched K4 (the tiled route) at no size")
    args = heaviest["args"]
    NP, T = args[0].shape
    W = args[1].shape[1]
    if save_path:
        arrays = {k: a.cpu().numpy() for k, a in zip(K4_ARGS, args)}
        for i, launch in enumerate(heaviest["launches"]):
            arrays.update({f"launch{i}_{k}": a.cpu().numpy() for k, a in zip(K4_ARGS, launch)})
        np.savez_compressed(save_path, **arrays)
    return k4_row(args, " (the main path's heaviest launch)", phase="3d",
                  launches_in_phase_3=heaviest["k4_shapes"][(NP, T, W)],
                  launches_in_phase_3_all_shapes=sum(heaviest["k4_shapes"].values()))


# ------------------------------------------------ phase 4: the spoa path

MAIN_PATH_KERNELS = ("poa_dp", "poa_walk", "poa_expand", "pairwise_banded", "pairwise_tiled")
GAP_KERNELS = ("poa_dp_affine", "poa_walk_affine", "poa_dp_convex", "poa_walk_convex")


def spoa_reads(rng, n_reads=32):
    """One consensus/MSA unit of the size of the main path's windows: reads
    of one 480-base template, 8% ONT-profile error, each at most 575 bases."""
    template = rand_seq(rng, 480)
    return [ont_read(rng, template, 0.08)[:575] for _ in range(n_reads)]


def spoa_phase(tmp, reads, backend_name="cuda"):
    """`reads` through the spoa command line on the card, every run byte for
    byte against the host engine. Returns the kernels' launches in the phase."""
    import io

    import torch

    from vechat_tpu_torch.cli.spoa_main import build_parser, run
    from vechat_tpu_torch.io.fastx import SeqRecord, write_fastx
    from vechat_tpu_torch.ops.kernels import _build

    comp = str.maketrans("ACGT", "TGCA")
    files = {}
    for name, seqs in (
        ("all", reads),
        ("first12", reads[:12]),
        ("mixed_strands", [s if i % 2 == 0 else s.translate(comp)[::-1]
                           for i, s in enumerate(reads)]),
    ):
        files[name] = os.path.join(tmp, f"spoa_{name}.fa")
        write_fastx([SeqRecord(f"s{i}", s) for i, s in enumerate(seqs)], files[name], fmt="fa")
    affine = score_args(AFFINE_SCORES)
    # the host engine of the convex runs is Python, over a second a read, so
    # both take the first 12 reads: enough for the run at the default scores
    # to pass the 640-node bucket, where it goes to the host (scores of
    # magnitude 10 leave int16 there); the run within 8 stays on the card
    runs = [
        ("linear nw", "all", ["-l", "1", *score_args(LINEAR_SCORES)]),
        ("affine nw", "all", ["-l", "1", *affine]),
        ("convex nw, default scores", "first12", ["-l", "1"]),
        ("convex nw, scores within 8", "first12", ["-l", "1", *score_args(CONVEX_SMALL_SCORES)]),
        ("affine sw", "first12", ["-l", "0", *affine]),
        ("affine ov", "first12", ["-l", "2", *affine]),
        ("affine nw, strand-ambiguous", "mixed_strands", ["-l", "1", "-s", *affine]),
    ]

    def spoa(argv, backend):
        args = build_parser().parse_args([*argv, "--backend", backend])
        out = io.StringIO()
        t0 = time.perf_counter()
        engine = run(args, out)
        if backend == "cuda":
            torch.cuda.synchronize()
        return out.getvalue(), engine, time.perf_counter() - t0

    def profile():  # device activity only; a rehearsal on the CPU has none
        if backend_name != "cuda":
            return contextlib.nullcontext()
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    _build.reset_launches()
    seen = dict(_build.LAUNCHES)
    device_ms, device_wall = {}, 0.0
    for label, which, extra in runs:
        argv = [files[which], "-r", "0", "-r", "1", *extra]
        with profile() as prof:
            got, engine, wall = spoa(argv, backend_name)
        run_ms = device_times(prof) if prof else {}
        for k, v in run_ms.items():
            device_ms[k] = device_ms.get(k, 0.0) + v
        device_wall += wall
        want, _, host_wall = spoa(argv, "host")
        now = dict(_build.LAUNCHES)
        log(dict(phase="spoa", run=label, reads=len(reads) if which != "first12" else 12,
                 byte_identical=got == want, wall_s=wall, host_wall_s=host_wall,
                 device_busy_s=sum(run_ms.values()) / 1e3,
                 device_alignments=engine.device_alignments, fallbacks=engine.fallbacks,
                 launches={k: now[k] - seen[k] for k in now if now[k] != seen[k]}))
        seen = now
        if got != want:
            raise RuntimeError(f"spoa {label}: --backend {backend_name} differs from --backend host")
        if engine.device_alignments == 0:
            raise RuntimeError(f"spoa {label}: no alignment ran on the device")
    launches = dict(_build.LAUNCHES)
    busy_s = sum(device_ms.values()) / 1e3
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:6]
    log(dict(phase="spoa_total", wall_s=device_wall, launches=launches, device_busy_s=busy_s,
             device_idle_share=1 - busy_s / device_wall, device_ms_top=dict(top)))
    if backend_name == "cuda":
        for k in GAP_KERNELS:
            if launches[k] == 0:
                raise RuntimeError(f"kernel {k} was not launched on the spoa path")
    return launches


# --------------------------------------------- phase 5: the scale-out path

SHARD_DEVICES = ["cuda:0", "cuda:0"]  # two shards, two streams, one card
# 5b, 5c, 7b and 8b run on the first reads of phase 3's community, in 4 chunks
# for 5c (a cut of depth: 200 -> 100 -> 64 -> 48 reads, to keep the script
# near its aim of 700 s as phases were added)
SCALE_OUT_READS = 48


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return str(sock.getsockname()[1])


def run_ranks(tmp, argv, world, timeout, **env):
    """`world` processes of `vechat_main` with `argv`, rank r with RANK=r,
    side by side: (wall s until the last has ended, their stderr logs). On a
    failure or at the time limit every process is killed and it raises with
    the end of the failing one's log."""
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r, log_path in enumerate(logs):
            with open(log_path, "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "vechat_tpu_torch.cli.vechat_main", *argv],
                    cwd=REPO, stdout=subprocess.DEVNULL, stderr=err,
                    env=dict(os.environ, PYTHONPATH=REPO, RANK=str(r), LOCAL_RANK=str(r),
                             WORLD_SIZE=str(world), **env)))
        for proc, log_path in zip(procs, logs):
            try:
                rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                with open(log_path) as fh:
                    raise RuntimeError(f"a process ended with {rc}:\n{fh.read()[-3000:]}")
        return time.perf_counter() - t0, logs
    finally:  # no process outlives the call
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _last_counters(log_path):
    """The last `counters:` line a command-line run printed, as a dict."""
    line = None
    with open(log_path) as fh:
        for ln in fh:
            if "counters:" in ln:
                line = ln
    if line is None:
        return {}
    return {k: float(v) if "." in v else int(v)
            for k, v in (kv.split("=") for kv in line.split("counters:")[1].split())}


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _profiled(fn, on_card=True, device_ms=None):
    """fn() under a device-activity profile: (result, wall s, device busy s);
    `device_ms`, a dict, also gets `device_times` of the run. A rehearsal on
    the CPU has no device activity to record."""
    import torch

    if not on_card:
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0, 0.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    times = device_times(prof)
    if device_ms is not None:
        device_ms.update(times)
    return out, wall, sum(times.values()) / 1e3


def _event_timed(fn, on_card=True):
    """fn() with every launch of the port's kernels between two CUDA events
    on its stream: (result, wall s, {kernel: device ms}), a kernel named
    after its C launcher (`poa_dp_launch` -> `poa_dp_kernel`). Only the
    launchers' own kernels are timed, not the torch ops or the copies, so
    there is no busy share; the cost is two event records a launch, where
    the profiler's processing of a trace took seconds. The launchers of
    the libraries loaded before the call are wrapped (every one used after
    phase 6 is)."""
    import torch

    from vechat_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    if not on_card:
        return fn(), time.perf_counter() - t0, {}
    events, saved = [], []
    for lib in _build._libs.values():
        for name, f in list(vars(lib).items()):
            if not name.endswith("_launch"):
                continue

            def timed(*a, _f=f, _n=name[: -len("_launch")] + "_kernel"):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                rc = _f(*a)
                end.record()
                events.append((_n, start, end))
                return rc

            timed.argtypes, timed.restype = f.argtypes, f.restype
            setattr(lib, name, timed)
            saved.append((lib, name, f))
    try:
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for lib, name, f in saved:
            setattr(lib, name, f)
    device_ms = {}
    for name, start, end in events:
        device_ms[name] = device_ms.get(name, 0.0) + start.elapsed_time(end)
    return out, wall, device_ms


def kernel_device_s(device_ms, kernel):
    """Seconds on the card of the kernel named `kernel` (every instantiation)
    in a `device_times` dict."""
    return sum(v for k, v in device_ms.items() if kernel in k) / 1e3


def stream_argv(tmp, community_path, n_reads, backend):
    """5c's command line: FASTQ has 4 lines a read, so --split-size n_reads
    is a quarter of the reads a chunk, 4 chunks. Output `stream_<backend>.fa`,
    checkpoints under `ck_<backend>`."""
    return [community_path, "--platform", "ont", "--stream", "--split-size", str(n_reads),
            "-o", os.path.join(tmp, f"stream_{backend}.fa"),
            "--resume-dir", os.path.join(tmp, f"ck_{backend}"), "--backend", backend]


def head_reads(tmp, community_path, n_reads):
    """The first `n_reads` records of `community_path`, written to a FASTQ
    of their own: the input of 5b and 5c."""
    from vechat_tpu_torch.io.fastx import read_fastx, write_fastx

    path = os.path.join(tmp, f"community_first{n_reads}.fq")
    write_fastx(read_fastx(community_path)[:n_reads], path, fmt="fq")
    return path


def start_stream_host(tmp, reads_path, n_reads):
    """Start the reference of 5b and 5c, 5c's command on the host engine
    over `reads_path` (`n_reads` reads), as a process of its own: (process,
    its stderr log)."""
    log_path = os.path.join(tmp, "stream_host.log")
    with open(log_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vechat_tpu_torch.cli.vechat_main",
             *stream_argv(tmp, reads_path, n_reads, "host")],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=err,
            env=dict(os.environ, PYTHONPATH=REPO))
    return proc, log_path


def wait_stream_host(stream_host, timeout=600):
    """Wait for the process `start_stream_host` started: the seconds its
    command line reported. Raises with the end of its log if it failed."""
    proc, log_path = stream_host
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = "timeout"
    with open(log_path) as fh:
        text = fh.read()
    if rc != 0:
        raise RuntimeError(f"the host reference of 5b and 5c ended with {rc}:\n{text[-3000:]}")
    return float(text.rsplit("total = ", 1)[1].split()[0])  # its last line: "total = <s> s"


def dense_walk_at(device, arrays, mode, scores, ring):
    """The dense walk against its plain version on one shard of the sharded
    route, as `parallel/mesh.py` launches it: K1 on `arrays` (the JAX layout
    of `pack_windows`), then both walks on its direction words; whole buffers,
    exact, with ranks and with the route's node ids. Returns the kernel's
    row (times, the kernel alone with a cold L2, bound)."""
    import torch

    from vechat_tpu_torch.ops.kernels import poa_linear as pl

    codes, preds, sink, nid, nn, seqp, slen = arrays
    B, P, N = preds.shape
    D, W = seqp.shape[1], seqp.shape[2]
    L = N + W
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    R = N if ring <= 0 or ring > N else ring
    aux, deg = pl.pack_aux(t(preds), R)
    dirs, maxi, maxj, _ = pl.poa_dp(t(codes).reshape(B, N), aux, deg, t(sink).reshape(B, N),
                                    t(nn).reshape(B), t(seqp), t(slen).reshape(B, D),
                                    mode, *scores, R)
    shape = f"B={B} N={N} D={D} W={W} P={P} ring={ring} {mode} (a shard of 5a)"
    kd = pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P)
    err = _max_err(f"dense walk {shape}", ("pn", "pp", "count"), kd,
                   pl._walk_dense_plain(dirs, maxi, maxj, mode, L, P))
    # with the node ids the route asks for
    nid = t(nid).reshape(B, N)
    err = max(err, _max_err(f"dense walk {shape} node ids", ("pn", "pp", "count"),
                            pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P, nid),
                            pl._walk_dense_plain(dirs, maxi, maxj, mode, L, P, nid)))
    ms = time_ms(lambda: pl.traceback_walk_dense(dirs, maxi, maxj, mode, L, P))
    kms = dense_kernel_ms(dirs, maxi, maxj, mode, L, P, kd, shape)
    pms = time_ms(lambda: pl._walk_dense_plain(dirs, maxi, maxj, mode, L, P), warmup=0, reps=2)
    pairs = int(kd[2].sum())
    b_ms, b_by = bound_ms(pairs * 2 + 2 * B * D * L * 2 + B * D * 12, pairs * WALK_OPS_STEP)
    row = dict(kernel="poa_walk_dense", shape=shape, ms=ms, kernel_ms=kms, plain_ms=pms,
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by, pairs=pairs)
    log_row(row)
    return row


def scale_out_phase(tmp, reads_path, stream_host, n_reads, backend_name="cuda",
                    goldens=GOLDENS):
    """The scale-out path on the card (see the module docstring, phase 5):
    5b and 5c on `reads_path`, the first `n_reads` reads of phase 3's
    community, against `stream_host`, what `start_stream_host` returned
    for them. Returns the kernels' launches of 5a, the sharded route's
    run, and the dense walk's row at the largest shard 5a launched. With
    another `backend_name` it is a rehearsal on the CPU."""
    import torch

    from vechat_tpu_torch.cli.vechat_main import build_parser, main, run
    from vechat_tpu_torch.io.fastx import write_fasta
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.kernels.backend import TorchAlignerBackend
    from vechat_tpu_torch.utils.logger import Logger

    on_card = backend_name == "cuda"
    devices = SHARD_DEVICES if on_card else ["cpu", "cpu"]
    t_phase = time.perf_counter()
    walls, busy, dense_s = 0.0, 0.0, 0.0

    # 5a: both goldens through the sharded route
    launches_5a = {k: 0 for k in _build.LAUNCHES}
    largest = {}  # the largest sharded launch of 5a: its size, inputs, mode, scores, ring
    for reads, expected, extra in goldens:
        out = os.path.join(tmp, "sharded_" + os.path.basename(expected))
        args = build_parser().parse_args([reads, "-o", out, "--backend", "cuda", *extra])
        backend = TorchAlignerBackend(args.match, args.mismatch, args.gap, devices=devices)
        sharded_fn = backend._sharded_fn

        def keep_largest(mode, ring, sharded_fn=sharded_fn, scores=backend._scores):
            fn = sharded_fn(mode, ring)

            def launch(*arrays):
                size = arrays[1].shape[2] * arrays[5][0].size * arrays[1].shape[0]  # N * D * W * B
                if size > largest.get("size", 0):
                    largest.update(size=size, arrays=arrays, mode=mode, ring=ring,
                                   scores=scores(mode))
                return fn(*arrays)

            return launch

        backend._sharded_fn = keep_largest
        _build.reset_launches()
        dev_ms = {}
        (corrected, _), wall, busy_s = _profiled(
            lambda: run(args, Logger(), backend=backend), on_card, dev_ms)
        launches = dict(_build.LAUNCHES)
        write_fasta(corrected, out)
        same = _same_bytes(out, expected)
        c = backend.counters()
        log(dict(phase="scale_out", run=f"5a sharded backend, {os.path.basename(reads)}",
                 devices=devices, byte_identical=same, wall_s=wall,
                 reads_per_s=len(corrected) / wall, device_busy_s=busy_s,
                 poa_walk_dense_kernel_device_s=kernel_device_s(dev_ms, "poa_walk_dense_kernel"),
                 poa_dp_kernel_device_s=kernel_device_s(dev_ms, "poa_dp_kernel"),
                 device_alignments=c["device_alignments"], fallbacks=c["fallbacks"],
                 sharded_dispatches=c["sharded_dispatches"],
                 launches={k: v for k, v in launches.items() if v}))
        if not same:
            raise RuntimeError(f"5a: the sharded backend on {reads} does not reproduce {expected}")
        if on_card and (launches["poa_walk_dense"] == 0 or launches["poa_walk"] != 0):
            raise RuntimeError(f"5a: the dense-walk route was not the one taken: {launches}")
        if c["sharded_dispatches"] != c["n_dispatches"] or not c["n_dispatches"]:
            raise RuntimeError(f"5a: not every dispatch was sharded: {c}")
        for k, v in launches.items():
            launches_5a[k] += v
        walls, busy = walls + wall, busy + busy_s
        dense_s += kernel_device_s(dev_ms, "poa_walk_dense_kernel")
    # the dense walk at its own path's shape: the first shard of that launch
    per = largest["arrays"][0].shape[0] // len(devices)
    dense_row = dense_walk_at(torch.device("cuda" if on_card else "cpu"),
                              tuple(a[:per] for a in largest["arrays"]),
                              largest["mode"], largest["scores"], largest["ring"])

    # 5b: two processes on the card, all-gather between the rounds, held to
    # the host reference, which is 5c's too
    out_5b = os.path.join(tmp, "two_process.fa")
    wall_5b, rank_logs = run_ranks(
        tmp, [reads_path, "-o", out_5b, "--platform", "ont", "--backend", backend_name],
        2, 600, VECHAT_DIST_INIT="1", MASTER_ADDR="localhost", MASTER_PORT=_free_port())
    host_total = wait_stream_host(stream_host)
    host_out, host_dir = os.path.join(tmp, "stream_host.fa"), os.path.join(tmp, "ck_host")
    same = _same_bytes(out_5b, host_out)
    per_rank = [_last_counters(path) for path in rank_logs]
    left = [f for f in os.listdir(tmp) if ".shard" in f or ".exit" in f]
    log(dict(phase="scale_out", run=f"5b two processes on cuda:0, gloo all-gather, {n_reads} reads",
             byte_identical_to_host=same, wall_s=wall_5b, reads_per_s=n_reads / wall_5b,
             per_rank=[dict(device_alignments=c.get("device_alignments"),
                            fallbacks=c.get("fallbacks"),
                            launches={k[9:]: v for k, v in c.items()
                                      if k.startswith("launches_") and v})
                       for c in per_rank],
             exchange_files_left=left, device_busy_s="not measured",
             host_total_s_beside_phases_4_to_5b=host_total))
    if not same:
        raise RuntimeError("5b: rank 0's output differs from the host engine's")
    if left or (on_card and any(not c.get("launches_poa_dp") for c in per_rank)):
        raise RuntimeError(f"5b: files left {left} or a rank that launched no kernel: {per_rank}")

    # 5c: bounded memory and restart
    argv = stream_argv(tmp, reads_path, n_reads, backend_name)
    cuda_out, cuda_dir = argv[7], argv[9]
    _build.reset_launches()
    _, wall_full, busy_full = _profiled(lambda: main(argv), on_card)
    full = dict(_build.LAUNCHES)
    same = _same_bytes(cuda_out, host_out)
    ckpts = sorted(os.listdir(cuda_dir))
    log(dict(phase="scale_out", run=f"5c --stream --resume-dir, 4 chunks of {n_reads // 4} reads",
             byte_identical_to_host=same, wall_s=wall_full, reads_per_s=n_reads / wall_full,
             device_busy_s=busy_full,
             checkpoints=ckpts, launches={k: v for k, v in full.items() if v}))
    if not same or ckpts != sorted(os.listdir(host_dir)) or len(ckpts) != 8:
        raise RuntimeError(f"5c: --backend {backend_name} differs from --backend host "
                           f"(checkpoints {ckpts})")
    for ck in ("round1.chunk00002.rec", "round2.chunk00003.rec"):
        os.unlink(os.path.join(cuda_dir, ck))
    os.unlink(cuda_out)
    _build.reset_launches()
    _, wall_re, busy_re = _profiled(lambda: main(argv), on_card)
    again = dict(_build.LAUNCHES)
    same = _same_bytes(cuda_out, host_out)
    log(dict(phase="scale_out", run="5c restart, one checkpoint of each round deleted",
             byte_identical_to_host=same, wall_s=wall_re, device_busy_s=busy_re,
             poa_dp_launches=again["poa_dp"], poa_dp_launches_full_run=full["poa_dp"],
             launches={k: v for k, v in again.items() if v}))
    if not same or sorted(os.listdir(cuda_dir)) != ckpts:
        raise RuntimeError("5c: the restarted run differs from the host run")
    if on_card and not 0 < again["poa_dp"] < full["poa_dp"]:
        raise RuntimeError(f"5c: the restart launched K1 {again['poa_dp']} times, "
                           f"the full run {full['poa_dp']}")
    walls, busy = walls + wall_full + wall_re, busy + busy_full + busy_re
    # 5b's processes are not under this process's profiler
    log(dict(phase="scale_out_total", wall_s=time.perf_counter() - t_phase, wall_s_5a_5c=walls,
             wall_s_5b=wall_5b, wall_s_5c=wall_full + wall_re,
             device_busy_s_5a_5c=busy, device_idle_share_5a_5c=1 - busy / walls,
             poa_walk_dense_kernel_device_s_5a=dense_s, launches_5a=launches_5a))
    return launches_5a, dense_row


# ------------------------------------------ phase 6: the device prune cycle

# a step of G1 or G2, counted at the function's work: the top's frame from
# the stack, the degree, a slot's node and its bit (4 loads), 3 compares and
# the ballot's pick (first or last set bit), and lane 0's 4 stores (frame,
# bit, id or rank, stack)
GRAPH_OPS_STEP = 12
CYCLE_KERNELS = ("graph_dfs", "graph_topo")
# their launches' tags in --save-build's npz
CYCLE_TAGS = {"graph_dfs": "dfs", "graph_topo": "rank"}


def graph_work(name, args, got):
    """(bytes, counted operations) of one G1 or G2 launch on this run's data
    (`args` its inputs, `got` its outputs): 2 steps a node of each window's
    component (G1: its discovery and its pop; G2: its push or rooting and its
    emit); of those nodes' rows (adjacency or in-slots) only the slots below
    their degree, and the degree, read once; G1 reads the component mask at
    the root alone, and the root, G2 reads n_sub; both [B, N] int32 outputs
    and G1's n_sub written once."""
    import torch

    B, N, _ = args[0].shape
    if name == "graph_dfs":
        kept = got[0] >= 0
        nbytes_in = B + B * 4
        out_bytes = 2 * B * N * 4 + B * 4
    else:
        kept = torch.arange(N, device=args[0].device)[None, :] < args[2].reshape(B, 1)
        nbytes_in = B * 4
        out_bytes = 2 * B * N * 4
    nodes, slots = int(kept.sum()), int(args[1][kept].sum())
    return 4 * (slots + nodes) + nbytes_in + out_bytes, 2 * nodes * GRAPH_OPS_STEP


def graph_kernel_row(name, args):
    """G1 or G2 on the inputs of phase 6's heaviest launch (`args`, as the
    cycle gave them to the wrapper): held to its plain version (exact), the
    wrapper as the cycle calls it (without its checks) and the plain
    version by CUDA events, the kernel alone (`kernel_ms()`, on one copy of
    the inputs: on the path the torch ops have just written them, so they
    are in the L2), the bound, µs a step (2 a node of the largest
    component), the kernel's registers, spills and shared memory as its
    launcher sizes it, and its form (the windows whose slots or rows it
    staged in shared memory)."""
    import torch

    from vechat_tpu_torch.ops.kernels import graph_cycle as gc

    wrapper, plain, launch, names = {
        "graph_dfs": (lambda *a: gc.dfs_preorder(*a, check=False), gc._dfs_plain, gc.launch_dfs,
                      ("new_id", "order", "n_sub")),
        "graph_topo": (lambda *a: gc.topo_ranks(*a, check=False), gc._topo_plain, gc.launch_topo,
                       ("rank_of", "rank_to_node")),
    }[name]
    B, N, K = args[0].shape
    shape = f"B={B} N={N} {'A' if name == 'graph_dfs' else 'P'}={K} (phase 6's heaviest launch)"
    got = wrapper(*args)
    err = _max_err(f"{name} {shape}", names, got, plain(*args), again=lambda: wrapper(*args))
    ms = time_ms(lambda: wrapper(*args))
    extra = dict(gc.kernel_attrs(name))
    if name == "graph_dfs":
        compact = gc.dfs_compact(args[1], K)
        cap, smem = gc.dfs_smem(N, K)
        extra.update(smem_bytes=smem, slot_cap=cap, windows_staged=int(compact.sum()),
                     form="shared" if bool(compact.all()) else "global in some windows",
                     slots_most=int(args[1].long().clamp(0, min(K, 32)).sum(1).max()))
    else:
        staged = gc.topo_staged(args[0], args[2])
        cap, smem = gc.topo_smem(N, K)
        extra.update(smem_bytes=smem, row_cap=cap, windows_staged=int(staged.sum()),
                     form="shared" if bool(staged.all()) else "global in some windows")
    if name == "graph_dfs":
        ins = (args[0].to(torch.int32).contiguous(), args[1].to(torch.int32).contiguous(),
               args[2].contiguous(), args[3].to(torch.int64).contiguous())
        n_sub = got[2]
    else:
        ins = tuple(a.to(torch.int32).contiguous() for a in args)
        n_sub = args[2]
    outs = tuple(torch.empty_like(t) for t in got)
    kms = kernel_ms(lambda r: launch(*ins, *outs))
    if not all(torch.equal(a, b) for a, b in zip(outs, got)):
        raise RuntimeError(f"{name} {shape}: the timed launches differ from the wrapper's")
    pms = time_ms(lambda: plain(*args), warmup=0, reps=2)
    nbytes, ops = graph_work(name, args, got)
    b_ms, b_by = bound_ms(nbytes, ops)
    # G1: a push a node but the root and a pop a node; G2: about 2 a node
    longest = 2 * int(n_sub.max()) - (name == "graph_dfs")
    row = dict(kernel=name, shape=shape, ms=ms, kernel_ms=kms, plain_ms=pms, max_abs_err=err,
               bound_ms=b_ms, bound_by=b_by, component_nodes=int(n_sub.sum()),
               steps=2 * int(n_sub.sum()), steps_longest=longest,
               us_a_step=kms * 1e3 / max(longest, 1), **extra)
    log_row(row)
    return row


def device_cycle_phase(tmp, backend_name="cuda", goldens=GOLDENS):
    """Phase 6, the device prune cycle (VECHAT_DEVICE_CYCLE=1): both goldens
    through the command line's `run`, byte for byte against the committed
    goldens. Each run: the windows on the card and on the host route by
    reason, dispatches, the cycle's pack/device/fetch seconds,
    cc_min_labels' rounds, and the launches and device seconds of K1, the
    dense walk, G1 and G2. Then G1 and G2 on the inputs of their heaviest
    launches (`graph_kernel_row`). Returns (the kernels' launches in the
    phase, {G1, G2: row}, {(tag, N): the inputs of G1's ("dfs") or G2's
    ("rank") heaviest launch at N}). With another `backend_name` it is a
    rehearsal on the CPU."""
    import torch

    from vechat_tpu_torch.cli.vechat_main import build_parser, run
    from vechat_tpu_torch.io.fastx import write_fasta
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.kernels import graph_cycle as gc
    from vechat_tpu_torch.utils.logger import Logger

    on_card = backend_name == "cuda"
    t_phase = time.perf_counter()
    # every launch's inputs as the cycle gave them, with its component nodes
    # left on the device: the heaviest (most nodes, then B*N) is picked once
    # the runs have ended, so the runs make no sync of their own for it
    kept = {name: [] for name in CYCLE_KERNELS}
    dfs, topo = gc.dfs_preorder, gc.topo_ranks

    def keep(name, fn, nodes):
        def launch(*args, **kw):
            out = fn(*args, **kw)
            kept[name].append((nodes(args, out).sum(), args[0].shape[0] * args[0].shape[1], args))
            return out

        return launch

    runs = [(os.path.basename(r), r, e, x) for r, e, x in goldens]
    _build.reset_launches()
    gc.dfs_preorder = keep("graph_dfs", dfs, lambda a, o: o[2])
    gc.topo_ranks = keep("graph_topo", topo, lambda a, o: a[2])
    os.environ["VECHAT_DEVICE_CYCLE"] = "1"
    walls = busy = 0.0
    try:
        for label, reads, expected, extra in runs:
            out = os.path.join(tmp, "cycle_" + os.path.basename(expected))
            args = build_parser().parse_args([reads, "-o", out, "--backend", backend_name, *extra])
            before = dict(_build.LAUNCHES)
            dev_ms = {}
            (corrected, backend), wall, busy_s = _profiled(lambda: run(args, Logger()), on_card,
                                                           dev_ms)
            write_fasta(corrected, out)
            same = _same_bytes(out, expected)
            c = backend.counters()
            log(dict(phase="device_cycle", run=label, byte_identical=same,
                     wall_s=wall, device_busy_s=busy_s,
                     windows_on_card=c["n_cycle_windows"], windows_to_host=c["n_cycle_host"],
                     host_routes={k[11:]: v for k, v in c.items() if k.startswith("cycle_host_")},
                     dispatches=c["n_cycle_dispatches"], pack_s=c["t_cycle_pack"],
                     device_s=c["t_cycle_device"], fetch_s=c["t_cycle_fetch"],
                     cc_min_labels_rounds=c["cycle_cc_rounds"],
                     device_s_by_kernel={k: kernel_device_s(dev_ms, k) for k in (
                         "poa_dp_kernel", "poa_walk_dense_kernel", "graph_dfs_kernel",
                         "graph_topo_kernel")},
                     launches={k: v - before[k] for k, v in _build.LAUNCHES.items()
                               if v != before[k]}))
            if not same:
                raise RuntimeError(f"6: {label} does not reproduce {expected}")
            if not c["n_cycle_windows"]:
                raise RuntimeError(f"6: no window of {reads} took the device cycle")
            walls, busy = walls + wall, busy + busy_s
    finally:
        del os.environ["VECHAT_DEVICE_CYCLE"]
        gc.dfs_preorder, gc.topo_ranks = dfs, topo
    launches = dict(_build.LAUNCHES)
    if on_card:
        for k in ("poa_dp", "poa_walk_dense", *CYCLE_KERNELS):
            if launches[k] == 0:
                raise RuntimeError(f"6: kernel {k} was not launched by the device cycle")
    rows, by_n = {}, {}
    for name in CYCLE_KERNELS:
        nodes = torch.stack([n for n, _, _ in kept[name]]).tolist() if kept[name] else []
        heaviest = max(range(len(nodes)), key=lambda i: (nodes[i], kept[name][i][1]))
        args = kept[name][heaviest][2]
        # the heaviest at each N, for --save-build
        for i in sorted(range(len(nodes)), key=lambda i: (nodes[i], kept[name][i][1])):
            by_n[(CYCLE_TAGS[name], kept[name][i][2][0].shape[1])] = kept[name][i][2]
        kept[name] = None
        rows[name] = graph_kernel_row(name, args) if on_card else {}
    log(dict(phase="device_cycle_total", wall_s=time.perf_counter() - t_phase,
             wall_s_runs=walls, device_busy_s=busy,
             device_idle_share=1 - busy / walls if on_card else "not measured",
             launches={k: v for k, v in launches.items() if v},
             forms={f"{k} N={n} {f}": v for (k, n, f), v in sorted(_build.BUILD_FORMS.items())
                    if k in CYCLE_KERNELS}))
    return launches, rows, by_n


# ---------------------------------------------- phase 7: the device build

BUILD_KERNELS = ("graph_topo_bundled", "graph_fuse", "graph_reach")
# their launches' tags in --save-build's npz (G1's, from phase 6: "dfs")
BUILD_TAGS = {"graph_topo_bundled": "topo", "graph_fuse": "fuse", "graph_reach": "reach"}
# counted at the function's work. G3: a step as G1's and G2's (GRAPH_OPS_STEP),
# 2 steps a node. G5: a kept node's pop and its CSR bounds (6); an in-edge
# or ring slot of it: its load, 2 compares, the claim and the push (5). G4:
# a sequence position or pair: its fields and code, the node or ring test,
# the node's id, the edge lookup by (tail, head) and its update (20)
REACH_OPS_NODE, REACH_OPS_SLOT = 6, 5
FUSE_OPS_STEP = 20


def _keep_heaviest(best, work, args):
    """Keep in `best`, a dict keyed by the launch's shapes, the inputs of the
    launch with the most `work` (a tensor on the card) among those of one
    shape, chosen on the card: the runs make no host read of their own."""
    import torch

    key = tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a) else a for a in args)
    if key in best:
        w0, a0 = best[key]
        more = work > w0
        work = torch.where(more, work, w0)
        args = tuple(torch.where(more, a, b) if torch.is_tensor(a) else a
                     for a, b in zip(args, a0))
    best[key] = (work, args)


def reach_edge_bytes(args, got):
    """G5's edge bytes on this run's data: (the (tail, head) of every valid
    edge of the windows that cut a subgraph, which G5 reads to group them;
    those of the edges into a kept node alone, all that a traversal over
    in-edges grouped outside the kernel reads)."""
    import torch

    tails, heads, n_edges, use_full = args[0], args[1], args[2], args[7]
    B, E = tails.shape
    cut = (~use_full.bool())[:, None]
    valid = (torch.arange(E, device=tails.device)[None, :] < n_edges.reshape(B, 1)) & cut
    into = valid & torch.gather(got & cut, 1, heads.long())
    return 8 * int(valid.sum()), 8 * int(into.sum())


def topo_steps_taken(in_nbr, indeg, aligned, acount, n_nodes):
    """[B] the steps G3's machine takes in each window (numpy arrays, the
    plain machine's rule): a rooting, a push or an emit a step, stopped at
    topo_steps(N). A window whose graph holds a cycle (one only a flagged
    build gives) runs to that cap, and a launch takes as long as its
    slowest window, so its µs a step are counted against these."""
    from vechat_tpu_torch.ops.kernels.graph_build import topo_steps

    B, N, P = in_nbr.shape
    R = aligned.shape[2]
    cap = topo_steps(N)
    out = np.zeros(B, np.int64)
    for b in range(B):
        tails, deg, ring, cnt = in_nbr[b].tolist(), indeg[b].tolist(), aligned[b].tolist(), acount[b].tolist()
        n = int(n_nodes[b])
        last = min(n, N)
        emitted, bundled = bytearray(N + 1), bytearray(N + 1)
        stack, rcnt, cursor, steps = [], 0, 0, 0
        while steps < cap and (stack or rcnt < n):
            steps += 1
            if not stack:
                while cursor < last and (emitted[cursor] or bundled[cursor]):
                    cursor += 1
                stack.append(cursor if cursor < last else 0)
                continue
            v = stack[-1]
            vb = bundled[v]
            unmet = [t for t in tails[v][: min(P, deg[v])] if not emitted[t]]
            ring_unmet = [] if vb else [m for m in ring[v][: min(R, cnt[v])] if not emitted[m]]
            if unmet or ring_unmet:
                for m in ring_unmet:
                    bundled[m] = 1
                stack.append(ring_unmet[-1] if ring_unmet else unmet[-1])
            else:
                emitted[v] = 1
                rcnt += 0 if vb else 1 + cnt[v]
                stack.pop()
        out[b] = steps
    return out


def build_work(name, args, got):
    """(bytes, counted operations) of one G3, G4 or G5 launch on this run's
    data (`args` its inputs, `got` its outputs), each input read once and
    each output written once. G3: the slots below each real node's
    in-degree and ring count, both counts, n_nodes; the two [B, N] int32
    outputs. G5: of the windows that cut a subgraph, the (tail, head) of
    every valid edge (`reach_edge_bytes`: what it groups) and the ring
    slots and count of each kept node; begin, end, use_full and n_nodes;
    the [B, N] bytes written. G4, of the active windows: the pairs of the
    alignment and the sequence's codes and weights (8 bytes each), a
    weight read and written for each edge update (one a position), the
    tail and head of each appended edge, the code of each new node, and
    with labels both words of each edge touched; the counts and the
    overflow word."""
    import torch

    if name == "graph_topo_bundled":
        in_nbr, indeg, aligned, acount, n_nodes = args
        B, N, P = in_nbr.shape
        real = torch.arange(N, device=in_nbr.device)[None, :] < n_nodes.reshape(B, 1)
        slots = indeg.clamp_max(P) + acount.clamp_max(aligned.shape[2]) + 2
        nodes = int(real.sum())
        return 4 * int(slots[real].sum()) + 4 * B + 8 * B * N, 2 * nodes * GRAPH_OPS_STEP
    if name == "graph_reach":
        tails, heads, n_edges, aligned, acount, begin, end, use_full, n_nodes = args
        B = tails.shape[0]
        N, R = aligned.shape[1], aligned.shape[2]
        kept = got & (~use_full.bool())[:, None]
        ring = int(torch.where(kept, acount.clamp_max(R), 0).sum())
        nk = int(kept.sum())
        edge_bytes, into_bytes = reach_edge_bytes(args, got)
        nbytes = edge_bytes + 4 * (ring + nk) + 13 * B + B * N
        return nbytes, nk * REACH_OPS_NODE + (into_bytes // 8 + ring) * REACH_OPS_SLOT
    codes, n_nodes, n_edges = args[0], args[4], args[5]
    count, seq_len, active = args[9], args[12], args[13].bool()
    B = codes.shape[0]
    act = lambda t: int(torch.where(active, t.long(), 0).sum())  # noqa: E731
    positions, pairs = act(seq_len), act(count)
    new_nodes, new_edges = act(got[4] - n_nodes), act(got[5] - n_edges)
    labels = 8 * positions if args[14] is not None else 0
    nbytes = 8 * (pairs + positions) + 8 * positions + 8 * new_edges + 4 * new_nodes + labels
    return nbytes + 16 * B, (pairs + positions) * FUSE_OPS_STEP


def build_kernel_row(name, args):
    """G3, G4 or G5 on the inputs of phase 7's heaviest launch (`args`, as the
    build gave them to the wrapper, G4's graph as it was before the launch):
    held to its plain version (exact), the wrapper (median of 5) and the
    plain version (once) by CUDA events, the kernel alone (`kernel_ms()` on
    one copy of the inputs: on the path the torch ops have just written
    them, so they are in the L2) and the bound, with the kernel's registers
    and shared memory and the form it took. G4 updates its graph in place,
    so each of its timed launches first copies the graph back: `ms` is
    `fuse_walk_` as the build calls it (no copies, no checks) less those
    copies, and so is the kernel alone; `copying_wrapper_ms` is `fuse_walk`,
    which copies the graph for a caller that keeps it. G5's `ms` is
    `reach_keep`, whose kernel groups the in-edges itself; its row gives
    the bound with the edges into kept nodes alone too
    (`bound_ms_edges_into_kept`, `reach_edge_bytes`)."""
    import torch

    from vechat_tpu_torch.ops.kernels import graph_build as gb

    wrapper, plain = {
        "graph_topo_bundled": (gb.topo_ranks_bundled, gb._topo_bundled_plain),
        "graph_fuse": (gb.fuse_walk, gb._fuse_plain),
        "graph_reach": (gb.reach_keep, gb._reach_plain),
    }[name]
    if name == "graph_fuse":
        names = ("codes", "tails", "heads", "weights", "n_nodes", "n_edges", "aligned", "acount",
                 "overflow", "lab_lo", "lab_hi")
    elif name == "graph_reach":
        names = ("keep",)
    else:
        names = ("rank_of", "rank_to_node")
    B, N = args[0].shape[0], (args[3] if name == "graph_reach" else args[0]).shape[1]
    shape = f"B={B} N={N} (phase 7's heaviest launch)"

    def outs(o):
        return o if isinstance(o, tuple) else (o,)

    got = outs(wrapper(*args))
    # the plain version is timed once, on the run the comparison uses: a
    # run takes seconds (a torch step a machine step)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = outs(plain(*args))
    end.record()
    end.synchronize()
    pms = start.elapsed_time(end)
    extra, form = {}, "shared"
    if name == "graph_topo_bundled":
        # a ring past R (only in a flagged window) scatters several ranks
        # into one slot: the plain machine keeps any of them on the card, the
        # last on the CPU, as G3 does. A window where the two versions
        # differ on the card is held to the plain machine on the CPU.
        diff = ((got[0] != want[0]) | (got[1] != want[1])).any(1).nonzero().flatten()
        if len(diff):
            on_cpu = plain(*(a[diff].cpu() for a in args))
            want = tuple(w.index_copy(0, diff, c.to(w.device, w.dtype))
                         for w, c in zip(want, on_cpu))
        extra["windows_held_on_cpu"] = len(diff)
    err = _max_err(f"{name} {shape}", names, got, want, again=lambda: outs(wrapper(*args)))
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    if name == "graph_topo_bundled":
        # as the build calls it: on its own int32 buffers, without checks
        ms = time_ms(lambda: wrapper(*args, check=False))
        P, R = args[0].shape[2], args[2].shape[2]
        form = gb.kernel_form(name, N, R=R, P=P)
        ins = tuple(i32(a) for a in args)
        res = tuple(torch.empty_like(t) for t in got)
        kms = kernel_ms(lambda r: gb.launch_topo_bundled(*ins, *res))
        same = all(torch.equal(a, b) for a, b in zip(res, got))
        steps = int(topo_steps_taken(*(a.cpu().numpy() for a in args)).max())
        extra.update(checked_wrapper_ms=time_ms(lambda: wrapper(*args)),
                     smem_bytes=gb.topo_smem_bytes(N, P, R) if form == "shared" else
                     4 * N + 8 * ((N + 31) // 32),
                     steps_longest=steps, us_a_step=kms * 1e3 / max(steps, 1))
    elif name == "graph_reach":
        ms = time_ms(lambda: wrapper(*args))
        E, R = args[0].shape[1], args[3].shape[2]
        form = gb.kernel_form(name, N, E, R)
        ins = tuple(i32(a) for a in args[:7])
        full, nn = args[7].contiguous(), i32(args[8])
        res = torch.empty_like(got[0])
        scratch = (torch.empty((B, gb.reach_scratch_ints(N, E)), dtype=torch.int32,
                               device=res.device) if form == "global" else None)
        kms = kernel_ms(lambda r: gb.launch_reach(*ins, full, nn, res, scratch))
        same = torch.equal(res, got[0])
        new_bytes, into_bytes = reach_edge_bytes(args, got[0])
        nbytes, ops = build_work(name, args, got[0])
        extra = dict(smem_bytes=gb.reach_smem_bytes(N, E, R) if form == "shared" else
                     4 * ((N + 31) // 32),
                     bound_ms_edges_into_kept=bound_ms(nbytes - new_bytes + into_bytes, ops)[0],
                     edges_read=new_bytes // 8, edges_into_kept=into_bytes // 8)
    else:
        track = args[14] is not None
        E, R = args[1].shape[1], args[6].shape[2]
        form = gb.kernel_form(name, N, E, R, track)
        state0 = [i32(a) for a in args[:8]] + ([i32(args[14]), i32(args[15])] if track else [])
        work = [torch.empty_like(t) for t in state0]
        labs = work[8:] if track else [None, None]
        bits = [i32(args[16]), i32(args[17])] if track else [None, None]
        ins = [i32(a) for a in args[8:13]]
        act = args[13].contiguous()
        ovf = torch.empty((B,), dtype=torch.int32, device=act.device)
        scratch = (torch.empty((B, gb.fuse_scratch_ints(N, E)), dtype=torch.int32,
                               device=act.device) if form == "global" else None)

        def copy(r=0):
            for w, s in zip(work, state0):
                w.copy_(s)

        def step():
            copy()
            return gb.fuse_walk_(*work[:8], *ins, act, *labs, *bits, check=False)

        def run(r):
            copy()
            gb.launch_fuse(*work[:8], *labs, *bits, *ins, act, ovf, scratch)

        step_ovf = step()
        same_step = (all(torch.equal(a, b) for a, b in zip(work, got[:8] + got[9:]))
                     and torch.equal(step_ovf, got[8]))
        copies_wall = time_ms(copy)
        step_wall = time_ms(step)
        ms = step_wall - copies_wall
        copies = kernel_ms(copy)
        with_copies = kernel_ms(run)
        kms = with_copies - copies
        extra = dict(step_with_copies_ms=step_wall, copies_wall_ms=copies_wall,
                     copying_wrapper_ms=time_ms(lambda: wrapper(*args)),
                     kernel_with_copies_ms=with_copies, copies_ms=copies,
                     smem_bytes=gb.fuse_smem_bytes(N, E, R, track) if form == "shared" else 0)
        same = (same_step and all(torch.equal(a, b) for a, b in zip(work[:8], got[:8]))
                and torch.equal(ovf, got[8]))
    if not same:
        raise RuntimeError(f"{name} {shape}: the timed launches differ from the wrapper's")
    if name != "graph_reach":
        nbytes, ops = build_work(name, args, got)
    b_ms, b_by = bound_ms(nbytes, ops)
    row = dict(kernel=name, shape=shape, ms=ms, kernel_ms=kms, plain_ms=pms, max_abs_err=err,
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops, form=form,
               **gb.kernel_attrs(name, form), **extra)
    log_row(row)
    return row


@contextlib.contextmanager
def capturing_build(best):
    """Within the block, the wrappers of G3, G4 and G5 in `graph_build`
    (which `device_build` calls by these names) keep in best[kernel] the
    inputs of the launch with the most work among those of one shape
    (`_keep_heaviest`): G3's ranked nodes, G4's positions and pairs, G5's
    kept nodes. G4 updates the graph and the labels in place, so those are
    kept as they were before the launch. Yields a one-element list: the
    host seconds spent in the capture's own calls, around the launches."""
    import torch

    from vechat_tpu_torch.ops.kernels import graph_build as gb

    wrapped = {"graph_topo_bundled": "topo_ranks_bundled", "graph_fuse": "fuse_walk_",
               "graph_reach": "reach_keep"}
    originals = {k: getattr(gb, fn) for k, fn in wrapped.items()}
    updated = (0, 1, 2, 3, 4, 5, 6, 7, 14, 15)  # the arguments G4 updates in place
    host_s = [0.0]

    def work_of(name, args, out):
        if name == "graph_topo_bundled":
            return args[4].long().clamp_max(args[0].shape[1]).sum()
        if name == "graph_reach":  # the nodes its traversal keeps
            return (out & ~args[7].bool()[:, None]).sum()
        return torch.where(args[13].bool(), args[9].long() + args[12].long(), 0).sum()

    def keep(name):
        def launch(*args, **kw):
            t0 = time.perf_counter()
            kept = args
            if name == "graph_fuse":
                kept = tuple(a.clone() if i in updated and torch.is_tensor(a) else a
                             for i, a in enumerate(args))
            t1 = time.perf_counter()
            out = originals[name](*args, **kw)
            t2 = time.perf_counter()
            _keep_heaviest(best.setdefault(name, {}), work_of(name, kept, out), kept)
            host_s[0] += t1 - t0 + time.perf_counter() - t2
            return out

        return launch

    for k, fn in wrapped.items():
        setattr(gb, fn, keep(k))
    try:
        yield host_s
    finally:
        for k, fn in wrapped.items():
            setattr(gb, fn, originals[k])


def heaviest_by_n(best, name):
    """{N: the inputs of the heaviest launch at N} of one kernel's captures
    (`capturing_build`), N its graphs' node capacity."""
    out = {}
    for work, args in best.get(name, {}).values():
        N = (args[3] if name == "graph_reach" else args[0]).shape[1]
        w = int(work)
        if N not in out or w > out[N][0]:
            out[N] = (w, args)
    return {N: args for N, (w, args) in sorted(out.items())}


def save_build_inputs(path, launches, **extra):
    """G1, G2, G3, G4, G5 and G6 launches {(tag "dfs", "rank", "topo",
    "fuse", "reach" or "bundle", N): [argument or None]} to an npz for
    `k1_probe.py time-build --inputs PATH` (`--save-build PATH`: phase 6's,
    7's and 8's heaviest at each N):
    `{tag}_N{N}_n` the count of arguments, `{tag}_N{N}_{i}` each that is
    not None; `extra` as it is."""
    out = dict(extra)
    for (tag, N), args in launches.items():
        out[f"{tag}_N{N}_n"] = np.array(len(args))
        out.update({f"{tag}_N{N}_{i}": np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                    for i, a in enumerate(args) if a is not None})
    np.savez_compressed(path, **out)
    log(dict(phase="save_build", path=path, launches=[f"{t} N={n}" for t, n in launches]))


def load_build_inputs(path):
    """{(tag, N): [numpy argument or None, ...]} from `save_build_inputs`."""
    z = np.load(path)
    out = {}
    for key in z.files:
        if key.endswith("_n"):
            tag, n = key.split("_")[:2]
            out[(tag, int(n[1:]))] = [z[f"{tag}_{n}_{i}"] if f"{tag}_{n}_{i}" in z.files else None
                                      for i in range(int(z[key]))]
    return out


def synth_build_batch(rng, B, N, depth=12, W=576):
    """`device_build`'s arguments for B windows built at node capacity N: a
    random backbone of min(0.45 N, W - 16) bases (so that the graph stays
    within N, as the pipeline's node bucket keeps it) and `depth` layers,
    each a copy of it at 8% ONT-profile error, every third cut at random
    ends; build weights 1-40. For `k1_probe.py time-build` at an N that
    phase 7 did not launch."""
    from vechat_tpu_torch.ops.encode import encode

    blen = min(int(0.45 * N), W - 16)
    bb_codes = np.zeros((B, W), np.int32)
    lseqs = np.full((B, depth, W), 0xFF, np.int32)
    llen = np.ones((B, depth), np.int32)
    lbegin = np.zeros((B, depth), np.int32)
    lend = np.zeros((B, depth), np.int32)
    lfull = np.zeros((B, depth), bool)
    for b in range(B):
        base = rand_seq(rng, blen)
        bb_codes[b, :blen] = encode(base)
        for s in range(depth):
            b0, e0 = 0, blen - 1
            if s % 3 == 2:
                b0, e0 = int(rng.integers(0, blen // 4)), blen - 1 - int(rng.integers(0, blen // 4))
            codes = encode(mutate(rng, base[b0 : e0 + 1], *(0.08 * f for f in ONT)))[: W - 1]
            lseqs[b, s, : len(codes)] = codes
            llen[b, s], lbegin[b, s], lend[b, s] = len(codes), b0, e0
            lfull[b, s] = b0 == 0 and e0 == blen - 1
    bb_w = rng.integers(1, 41, size=(B, W)).astype(np.int32)
    lw = rng.integers(1, 41, size=(B, depth, W)).astype(np.int32)
    return (bb_codes, bb_w, np.full(B, blen, np.int32), lseqs, lw, llen, lbegin, lend, lfull,
            np.full(B, depth, np.int32))


def _dag_batch(rng, B, N):
    """B POA-like DAGs at node capacity N: a chain through n in [N/2, N]
    nodes plus forward skip edges of 2-40 nodes, 2N edges at most, inserted
    in a random order. Returns torch (tails, heads, valid [B, 2N], alive
    [B, N])."""
    import torch

    E = 2 * N
    tails = np.zeros((B, E), np.int64)
    heads = np.zeros((B, E), np.int64)
    n_nodes = rng.integers(N // 2, N + 1, size=B)
    n_edges = np.zeros(B, np.int64)
    for b in range(B):
        n = int(n_nodes[b])
        s = rng.integers(0, n - 1, size=n)
        t = np.minimum(s + rng.integers(2, 41, size=n), n - 1)
        pairs = sorted({(i, i + 1) for i in range(n - 1)} | {(int(x), int(y)) for x, y in zip(s, t)
                                                               if x < y})
        pairs = [pairs[k] for k in rng.permutation(len(pairs))][:E]
        n_edges[b] = len(pairs)
        tails[b, : len(pairs)], heads[b, : len(pairs)] = zip(*pairs)
    valid = torch.from_numpy(np.arange(E)[None, :] < n_edges[:, None])
    alive = torch.from_numpy(np.arange(N)[None, :] < n_nodes[:, None])
    return torch.from_numpy(tails), torch.from_numpy(heads), valid, alive


def synth_dfs_batch(rng, B, N, A=32):
    """G1's arguments (adj, deg, comp_mask, root) for B windows at node
    capacity N, as the prune cycle makes them from `_dag_batch`'s graphs,
    every edge kept. For `k1_probe.py time-build` at an N that phase 6 did
    not launch."""
    from vechat_tpu_torch.ops.kernels import graph_cycle as gc

    t, h, valid, alive = _dag_batch(rng, B, N)
    comp, root = gc.select_component(gc.cc_min_labels(t, h, valid, alive), alive)
    adj, deg, _ = gc.build_undirected_adjacency(t, h, valid, N, A)
    return [x.numpy() for x in (adj, deg, comp, root)]


def synth_rank_batch(rng, B, N, device, P=16):
    """G2's arguments (in_nbr, indeg, n_sub) for B windows at node capacity
    N, as the prune cycle makes them from `_dag_batch`'s graphs, every edge
    kept: the largest component numbered by G1 on `device` and renumbered,
    in-slots of P. For `k1_probe.py time-build` at an N that phase 6 did
    not launch."""
    from vechat_tpu_torch.ops.kernels import graph_cycle as gc

    t, h, valid, alive = (x.to(device) for x in _dag_batch(rng, B, N))
    comp, root = gc.select_component(gc.cc_min_labels(t, h, valid, alive), alive)
    adj, deg, _ = gc.build_undirected_adjacency(t, h, valid, N, 32)
    new_id, order, n_sub = gc.dfs_preorder(adj, deg, comp, root)
    codes = t.new_zeros((B, N))
    t2, h2, _, v2, _, _ = gc.renumber_subgraph(t, h, valid, new_id, order, codes)
    in_nbr, indeg, _, _ = gc.build_in_slots(t2, h2, v2, N, P)
    return [x.cpu().numpy() for x in (in_nbr, indeg, n_sub)]


def synth_bundle_batch(rng, B, N, device):
    """G6's arguments for B windows at node capacity N, as round 2's device
    consensus gives them: `device_linear` on `synth_build_batch`'s windows
    on `device` (E = 2N, R = 8, P = 16), its one G6 launch captured. For
    `k1_probe.py time-build` at an N that phase 8 did not launch."""
    import torch

    from vechat_tpu_torch.ops.kernels import graph_consensus as gcs

    args = [torch.from_numpy(a).to(device) for a in synth_build_batch(rng, B, N)]
    caught, real = [], gcs.heaviest_bundle

    def keep(*a, **kw):
        caught.append(a)
        return real(*a, **kw)

    gcs.heaviest_bundle = keep
    try:
        gcs.device_linear(*args, torch.ones(B, dtype=torch.bool, device=device), N, 2 * N, 8, 3,
                          -5, -4, p_cap=16)
    finally:
        gcs.heaviest_bundle = real
    return [x.cpu().numpy() for x in caught[0]]


def device_build_phase(tmp, reads_path, n_reads, backend_name="cuda", goldens=GOLDENS):
    """Phase 7, the device build (VECHAT_DEVICE_BUILD=1): (a) both goldens
    through the command line's `run`, byte for byte against the committed
    goldens; (b) `reads_path`, the first `n_reads` reads of phase 3's
    community, with VECHAT_DEVICE_CYCLE=1 as well (the windows the build
    sends to the host take the host build, then the device cycle), byte
    for byte against the host engine's run of 5b and 5c (its output must
    exist). Each run: the windows built on the card and the host routes by
    reason, dispatches, layer steps, the build's pack/device/fetch seconds
    and the launches of G3, G4, G5, K1, the dense walk, G1 and G2; 7b also
    their device seconds (7b alone, by CUDA events around each launch,
    `_event_timed`), and the form each G4 and G5 launch took (shared or
    global memory, by N). Then G3, G4 and G5 on the inputs of their
    heaviest launches (`build_kernel_row`). Returns (the kernels' launches
    in the phase, {G3, G4, G5: row}, {(tag, N): the inputs of the heaviest
    G3, G4 and G5 launch at N}, for `save_build_inputs`). With another
    `backend_name` it is a rehearsal on the CPU."""
    import torch

    from vechat_tpu_torch.cli.vechat_main import build_parser, run
    from vechat_tpu_torch.io.fastx import write_fasta
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.utils.logger import Logger

    on_card = backend_name == "cuda"
    t_phase = time.perf_counter()
    best = {k: {} for k in BUILD_KERNELS}
    host_out = os.path.join(tmp, "stream_host.fa")
    runs = [(os.path.basename(r), r, e, x, False) for r, e, x in goldens]
    runs.append((f"first {n_reads} reads of the community, with the device cycle", reads_path,
                 host_out, ["--platform", "ont"], True))
    _build.reset_launches()
    os.environ["VECHAT_DEVICE_BUILD"] = "1"
    walls = busy = captured = 0.0
    capture = contextlib.ExitStack()
    capture_s = capture.enter_context(capturing_build(best))
    try:
        for label, reads, expected, extra, cycle in runs:
            if cycle:
                os.environ["VECHAT_DEVICE_CYCLE"] = "1"
            out = os.path.join(tmp, "build_" + os.path.basename(expected))
            args = build_parser().parse_args([reads, "-o", out, "--backend", backend_name, *extra])
            before = dict(_build.LAUNCHES)
            forms_before = dict(_build.BUILD_FORMS)
            capture_before = capture_s[0]
            # 7b's kernels are timed by CUDA events (`_event_timed`); the
            # profiler that did it before took ~16-20 s to process its trace
            timed = on_card and cycle
            try:
                (corrected, backend), wall, dev_ms = _event_timed(lambda: run(args, Logger()),
                                                                  timed)
            finally:
                os.environ.pop("VECHAT_DEVICE_CYCLE", None)
            kernels_s = sum(dev_ms.values()) / 1e3
            write_fasta(corrected, out)
            same = _same_bytes(out, expected)
            c = backend.counters()
            log(dict(phase="device_build", run=label, byte_identical=same,
                     wall_s=wall, capture_host_s=capture_s[0] - capture_before,
                     kernels_device_s=kernels_s if timed else "not measured",
                     device_busy_s="not measured",
                     windows_built_on_card=c["n_build_windows"],
                     windows_to_host_build=c["n_build_host"],
                     host_routes={k[11:]: v for k, v in c.items() if k.startswith("build_host_")},
                     dispatches=c["n_build_dispatches"], layer_steps=c["build_layer_steps"],
                     pack_s=c["t_build_pack"], device_s=c["t_build_device"],
                     fetch_s=c["t_build_fetch"],
                     device_cycle_windows=c["n_cycle_windows"],
                     device_s_by_kernel={k: kernel_device_s(dev_ms, k) for k in (
                         "graph_topo_bundled_kernel", "graph_fuse_kernel", "graph_reach_kernel",
                         "poa_dp_kernel", "poa_walk_dense_kernel", "graph_dfs_kernel",
                         "graph_topo_kernel")} if timed else "not measured",
                     launches={k: v - before[k] for k, v in _build.LAUNCHES.items()
                               if v != before[k]},
                     forms={f"{k} N={n} {f}": v - forms_before.get((k, n, f), 0)
                            for (k, n, f), v in sorted(_build.BUILD_FORMS.items())
                            if v != forms_before.get((k, n, f), 0)}))
            if not same:
                raise RuntimeError(f"7: {label} does not reproduce {expected}")
            if not c["n_build_windows"]:
                raise RuntimeError(f"7: no window of {reads} was built on the device")
            if timed:
                walls, busy = walls + wall, busy + kernels_s
                captured = captured + capture_s[0] - capture_before
    finally:
        del os.environ["VECHAT_DEVICE_BUILD"]
        capture.close()
    launches = dict(_build.LAUNCHES)
    if on_card:
        for k in ("poa_dp", "poa_walk_dense", *BUILD_KERNELS):
            if launches[k] == 0:
                raise RuntimeError(f"7: kernel {k} was not launched by the device build")
    by_n = {(tag, N): args for name, tag in BUILD_TAGS.items()
            for N, args in heaviest_by_n(best, name).items()}
    rows = {}
    for name in BUILD_KERNELS:
        entries = list(best[name].values())
        works = torch.stack([w for w, _ in entries]).tolist()
        args = entries[max(range(len(works)), key=lambda i: works[i])][1]
        best[name] = None
        rows[name] = build_kernel_row(name, args) if on_card else {}
    log(dict(phase="device_build_total", wall_s=time.perf_counter() - t_phase,
             wall_s_7b=walls, capture_host_s_7b=captured, kernels_device_s_7b=busy,
             launches={k: v for k, v in launches.items() if v},
             forms={f"{k} N={n} {f}": v for (k, n, f), v in sorted(_build.BUILD_FORMS.items())}))
    return launches, rows, by_n


# ------------------------------------- phase 8: the device round-2 consensus

# a rank step of G6, counted at the function's work: the node, its
# in-degree, a slot's tail and weight and the tail's score (5 loads), the
# slot and skip tests (2), the two maxima and the ballot's last lane (3),
# the score's sum and the running maximum's compare (2), lane 0's two
# stores (2)
BUNDLE_OPS_STEP = 14
LINEAR_KERNELS = ("graph_bundle",)


def bundle_work(args, stats):
    """(bytes, counted operations) of one G6 launch on this run's data
    (`args` its inputs, `stats` its plain version's counts on them): each
    real node's in-slots below its in-degree (tail and weight), its
    in-degree and its rank_to_node entry, read once, and n_nodes; each
    branch-completion pass's start (its out-degree, rank and out-slots, at
    most 16 of them, counted at 2 words); the [B, N] path and the two [B]
    words written once. Operations: every rank step of every pass
    (`bundle_steps`), BUNDLE_OPS_STEP each."""
    import torch

    in_nbr, indeg, n_nodes = args[0], args[2], args[7]
    B, N, P = in_nbr.shape
    real = torch.arange(N, device=in_nbr.device)[None, :] < n_nodes.reshape(B, 1)
    slots = int(torch.where(real, indeg.long().clamp_max(P), 0).sum())
    nbytes = 8 * slots + 8 * int(real.sum()) + 4 * B + 8 * stats["branch_passes"]
    return nbytes + 4 * B * N + 8 * B, stats["bundle_steps"] * BUNDLE_OPS_STEP


def bundle_kernel_row(args):
    """G6 on the inputs of phase 8's heaviest launch (`args`, as the program
    gave them to the wrapper): held to its plain version (exact), the
    wrapper as the program calls it (without its checks; median of 5) and
    the plain version (once, with its counts) by CUDA events, the kernel
    alone (`kernel_ms()` on one copy of the inputs: on the path the torch
    ops have just written them, so they are in the L2), the bound, µs a
    rank step over the longest window's steps (`steps_longest`, all its
    passes: the launch lasts as long as its slowest window) and over all
    of them a warp, the kernel's registers, spills and shared memory as
    its launcher sizes it, and its form (the windows whose ranks it staged
    in shared memory)."""
    import torch

    from vechat_tpu_torch.ops.kernels import graph_consensus as gcs

    B, N, P = args[0].shape
    shape = f"B={B} N={N} P={P} Q={args[3].shape[2]} (phase 8's heaviest launch)"
    wrapper = lambda: gcs.heaviest_bundle(*args, check=False)  # noqa: E731
    got = wrapper()
    stats = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = gcs._heaviest_bundle_plain(*args, stats=stats)
    end.record()
    end.synchronize()
    pms = start.elapsed_time(end)
    err = _max_err(f"graph_bundle {shape}", ("cons", "cons_len", "overflow"), got, want,
                   again=wrapper)
    ms = time_ms(wrapper)
    ins = tuple(a.to(torch.int32).contiguous() for a in args)
    res = (torch.empty_like(got[0]), torch.empty_like(got[1]), torch.empty_like(got[1]))
    kms = kernel_ms(lambda r: gcs.launch_bundle(*ins, *res))
    if not (torch.equal(res[0], got[0]) and torch.equal(res[1], got[1])
            and torch.equal(res[2] != 0, got[2])):
        raise RuntimeError(f"graph_bundle {shape}: the timed launches differ from the wrapper's")
    nbytes, ops = bundle_work(args, stats)
    b_ms, b_by = bound_ms(nbytes, ops)
    longest = int(stats["bundle_steps_window"].max())
    staged = gcs.bundle_staged(args[7], N, P)
    cap, smem = gcs.bundle_smem(N, P)
    row = dict(kernel="graph_bundle", shape=shape, ms=ms, kernel_ms=kms, plain_ms=pms,
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
               rank_steps=stats["bundle_steps"], branch_passes=stats["branch_passes"],
               steps_longest=longest, us_a_step=kms * 1e3 / max(longest, 1),
               us_a_step_a_warp=kms * 1e3 * B / max(stats["bundle_steps"], 1),
               **gcs.kernel_attrs(), smem_bytes=smem, rank_cap=cap,
               windows_staged=int(staged.sum()),
               form="shared" if bool(staged.all()) else "global in some windows")
    log_row(row)
    return row


def device_linear_phase(tmp, reads_path, n_reads, backend_name="cuda", goldens=GOLDENS):
    """Phase 8, the device round-2 consensus (VECHAT_DEVICE_LINEAR=1): (a)
    both goldens through the command line's `run`, byte for byte against the
    committed goldens; (b) `reads_path`, the first `n_reads` reads of phase
    3's community, with VECHAT_DEVICE_BUILD=1 and VECHAT_DEVICE_CYCLE=1 as
    well, so that both rounds' window consensus runs on the card, byte for
    byte against the host engine's run of 5b and 5c (its output must
    exist). Each run: the windows of round 2 on the card and on the host
    route by reason, dispatches, the program's pack/device/fetch seconds
    and the launches of every kernel (8b: round 1's build counts too). No
    run is profiled. Then G6 on the inputs of its heaviest launch
    (`bundle_kernel_row`). Returns (the kernels' launches in the phase,
    {G6: row}, {("bundle", N): the inputs of G6's heaviest launch at N},
    for `save_build_inputs`). With another `backend_name` it is a
    rehearsal on the CPU."""
    import torch

    from vechat_tpu_torch.cli.vechat_main import build_parser, run
    from vechat_tpu_torch.io.fastx import write_fasta
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.kernels import graph_consensus as gcs
    from vechat_tpu_torch.utils.logger import Logger

    on_card = backend_name == "cuda"
    t_phase = time.perf_counter()
    original = gcs.heaviest_bundle
    best = {}

    def keep(*args, **kw):
        out = original(*args, **kw)
        _keep_heaviest(best, args[7].long().clamp_max(args[0].shape[1]).sum(), args)
        return out

    host_out = os.path.join(tmp, "stream_host.fa")
    runs = [(os.path.basename(r), r, e, x, False) for r, e, x in goldens]
    runs.append((f"first {n_reads} reads of the community, both rounds on the card", reads_path,
                 host_out, ["--platform", "ont"], True))
    _build.reset_launches()
    gcs.heaviest_bundle = keep
    os.environ["VECHAT_DEVICE_LINEAR"] = "1"
    walls = 0.0
    try:
        for label, reads, expected, extra, both in runs:
            if both:
                os.environ["VECHAT_DEVICE_BUILD"] = os.environ["VECHAT_DEVICE_CYCLE"] = "1"
            out = os.path.join(tmp, "linear_" + os.path.basename(expected))
            args = build_parser().parse_args([reads, "-o", out, "--backend", backend_name, *extra])
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            try:
                corrected, backend = run(args, Logger())
            finally:
                os.environ.pop("VECHAT_DEVICE_BUILD", None)
                os.environ.pop("VECHAT_DEVICE_CYCLE", None)
            wall = time.perf_counter() - t0
            write_fasta(corrected, out)
            same = _same_bytes(out, expected)
            c = backend.counters()
            row = dict(phase="device_linear", run=label, byte_identical=same, wall_s=wall,
                       windows_on_card=c["n_linear_windows"],
                       windows_to_host=c["n_linear_host"],
                       host_routes={k[12:]: v for k, v in c.items()
                                    if k.startswith("linear_host_")},
                       dispatches=c["n_linear_dispatches"], pack_s=c["t_linear_pack"],
                       device_s=c["t_linear_device"], fetch_s=c["t_linear_fetch"],
                       launches={k: v - before[k] for k, v in _build.LAUNCHES.items()
                                 if v != before[k]})
            if both:
                row.update(round1_windows_built_on_card=c["n_build_windows"],
                           round1_host_built_windows_on_the_device_cycle=c["n_cycle_windows"])
            log(row)
            if not same:
                raise RuntimeError(f"8: {label} does not reproduce {expected}")
            if not c["n_linear_windows"]:
                raise RuntimeError(f"8: no window of {reads} took the device round-2 consensus")
            walls += wall
    finally:
        del os.environ["VECHAT_DEVICE_LINEAR"]
        gcs.heaviest_bundle = original
    launches = dict(_build.LAUNCHES)
    if on_card:
        for k in ("poa_dp", "poa_walk_dense", "graph_topo_bundled", "graph_fuse", "graph_reach",
                  *LINEAR_KERNELS):
            if launches[k] == 0:
                raise RuntimeError(f"8: kernel {k} was not launched by the device round-2 path")
    entries = list(best.values())
    works = torch.stack([w for w, _ in entries]).tolist()
    args = entries[max(range(len(works)), key=lambda i: works[i])][1]
    by_n = {("bundle", N): a for N, a in heaviest_by_n({"graph_bundle": best},
                                                        "graph_bundle").items()}
    best.clear()
    rows = {"graph_bundle": bundle_kernel_row(args) if on_card else {}}
    log(dict(phase="device_linear_total", wall_s=time.perf_counter() - t_phase, wall_s_runs=walls,
             launches={k: v for k, v in launches.items() if v},
             forms={f"{k} N={n} {f}": v for (k, n, f), v in sorted(_build.BUILD_FORMS.items())
                    if k in LINEAR_KERNELS}))
    return launches, rows, by_n


# ------------------------------ phase 9: B10, the full-matrix DP (--backend full)


FULL_KERNELS = ("poa_full_dp", "poa_full_walk")
FULL_ARGS = ("codes", "preds", "node_id", "is_sink", "n_nodes", "seq", "seq_len")
# counted at the function's work. F1, a cell: the profile's compare and
# select (2), t = H - j*g (1), the prefix max (1, one pass along the row),
# + j*g (1) and sw's clamp (1); a real in-edge, a cell: the diagonal's and
# the vertical's adds and two maxes (4); a cell of the mode's best-cell
# scan: a compare and a select (2). F2, a walk step as K2's (WALK_OPS_STEP)
FULL_OPS_CELL, FULL_OPS_EDGE, FULL_OPS_SCAN = 6, 4, 2


def full_window_inputs(rng, B, N, P, S, backbone_len=None):
    """B window graphs built by the port's native graph from a backbone
    (`backbone_len` bases, by default min(690, S - 60, N - 300)) and
    8%-error layers (as many as keep it within N - 60 nodes and P in-edges),
    each with one 8%-error read of the window, in B10's layout (codes
    uint8 [B, N], preds [B, N, P], node_id, is_sink [B, N], n_nodes, seq
    uint8 [B, S], seq_len)."""
    from vechat_tpu_torch.ops.encode import encode
    from vechat_tpu_torch.ops.kernels.dense import graph_to_dense
    from vechat_tpu_torch.ops.native_graph import make_graph

    codes = np.zeros((B, N), np.uint8)
    preds = np.zeros((B, N, P), np.int32)
    nid = np.zeros((B, N), np.int32)
    sink = np.ones((B, N), bool)
    nn = np.ones(B, np.int32)
    seq = np.full((B, S), 0xFF, np.uint8)
    sl = np.ones(B, np.int32)
    b = 0
    while b < B:
        backbone = rand_seq(rng, backbone_len or min(690, S - 60, N - 300))
        g = make_graph()
        c = encode(backbone)
        g.add_alignment([], c, np.ones(len(c), np.uint32))
        for _ in range(40):
            layer = encode(ont_read(rng, backbone, 0.08))
            g.add_alignment(g.align_host(layer, "nw", 3, -5, -4), layer,
                            np.ones(len(layer), np.uint32))
            if g.num_nodes() > N - 60 or g.max_in_degree() >= P:
                break
        d = graph_to_dense(g, N, P)
        if d is None:
            continue
        codes[b], preds[b], nid[b], sink[b], nn[b] = (d["codes"], d["preds"], d["node_id"],
                                                      d["is_sink"], d["n_nodes"])
        q = encode(ont_read(rng, backbone, 0.08))[:S]
        seq[b, : len(q)] = q
        sl[b] = len(q)
        b += 1
    return codes, preds, nid, sink, nn, seq, sl


def full_work(t, mode, got):
    """(F1's bytes, F1's operations, F2's bytes, F2's operations) of one
    launch on this run's data (`t` the seven inputs on the card, `got` F2's
    outputs): F1 reads each real row's code, sink flag and in-slots and the
    sequence once and writes rows 0..n_nodes by columns 0..seq_len of H and
    the best cell; its cells and real in-edges as FULL_OPS_*, and
    FULL_OPS_SCAN a cell of the mode's best-cell scan. F2 reads the best
    cell and, a step, the node's in-slots, code and id, the read's code,
    and two H cells a real in-slot and the horizontal one (at the window's
    mean real in-degree), and writes the [L, 2] pairs row whole, the count
    and the score."""
    import torch

    codes, preds, nid, sink, nn, seq, sl = t
    B, N, P = preds.shape
    dev = preds.device
    nn64, sl64 = nn.long(), sl.long()
    real = torch.arange(N, device=dev)[None, :] < nn64[:, None]
    indeg = ((preds != preds[:, :, :1]).sum(dim=2) + 1) * real
    edges = indeg.sum(dim=1)
    rows = nn64.sum()
    if mode == "nw":
        scanned = (sink.bool() & real).sum(dim=1)
    elif mode == "ov":
        scanned = (sink.bool() & real).sum(dim=1) * sl64
    else:
        scanned = nn64 * sl64
    f1_bytes = int(rows * (2 + 4 * P) + sl64.sum() + 16 * B
                   + 4 * ((nn64 + 1) * (sl64 + 1)).sum())
    f1_ops = int(((nn64 * FULL_OPS_CELL + edges * FULL_OPS_EDGE) * (sl64 + 1)).sum()
                 + FULL_OPS_SCAN * scanned.sum())
    steps = got[1].long()
    mean_deg = edges.double() / nn64.clamp_min(1)
    step_bytes = (steps.double() * (4 * P + 2 + 4 + 4 * (2 * mean_deg + 1))).sum()
    L = got[0].shape[1]
    f2_bytes = int(step_bytes + B * (8 * L + 16))
    f2_ops = int(WALK_OPS_STEP * steps.sum())
    return f1_bytes, f1_ops, f2_bytes, f2_ops


def pred_distances(preds, nn, ring):
    """F1's predecessor reads of B10's inputs (numpy preds [B, N, P] and
    n_nodes [B]): each real row's distinct slots (a repeat of slot 0 is not
    read), by distance n + 1 - p; row 0 is computed, the row before (1)
    comes from registers, 2..ring from the ring in shared memory, farther
    from global memory. Returns {reads, row_0, hist {distance: reads, up
    to 16, then "17+"}, served_by_ring, global, share_without_global}."""
    preds = np.asarray(preds)
    B, N, P = preds.shape
    real = np.arange(N)[None, :] < np.asarray(nn)[:, None]
    distinct = np.ones(preds.shape, bool)
    distinct[:, :, 1:] = preds[:, :, 1:] != preds[:, :, :1]
    read = distinct & real[:, :, None]
    dist = (np.arange(N)[None, :, None] + 1) - preds
    row0 = int((read & (preds == 0)).sum())
    d = dist[read & (preds > 0)]
    hist = {str(k): int((d == k).sum()) for k in range(1, 17)}
    hist["17+"] = int((d > 16).sum())
    ring_reads = int(((d >= 2) & (d <= ring)).sum())
    far = int((d > ring).sum())
    total = int(read.sum())
    return dict(reads=total, row_0=row0, hist=hist, served_by_ring=ring_reads, ring=ring,
                **{"global": far}, share_without_global=1 - far / max(total, 1))


def full_resources(S, N, P):
    """F1's and F2's registers a thread, static and dynamic shared memory
    and threads a block at this shape (cudaFuncGetAttributes, the
    launchers' plans), in nw (the modes share their layout)."""
    from vechat_tpu_torch.ops.kernels import poa_full as pf

    k = pf.f1_columns(S)
    threads, smem = pf.dp_plan(N, P, S)
    warps, wsmem = pf.walk_plan(N, P, S)
    return dict(poa_full_dp=dict(columns_a_thread=k, threads=threads, dynamic_smem_bytes=smem,
                                 ring=pf.RING, **pf.kernel_attrs("dp", "nw", S)),
                poa_full_walk=dict(warps=warps, threads=warps * 32, dynamic_smem_bytes=wsmem,
                                   **pf.kernel_attrs("walk", "nw")))


def full_rows(arrays, mode, scores, label):
    """F1 and F2 on `arrays` (B10's seven inputs, numpy) in `mode` at
    `scores`: held to the plain version (F1's H on the rows and columns it
    writes and its best cell, F2's pairs, count and score; exact), the
    wrappers (median of 5), the kernels alone (`kernel_ms()`, 24 launches
    in a CUDA graph) and the plain versions (once each) by CUDA events,
    and the bounds. Returns {kernel: row}."""
    import torch

    from vechat_tpu_torch.ops.kernels import poa_full as pf

    t = pf._inputs(*arrays, torch.device("cuda"))
    codes, preds, nid, sink, nn, seq, sl = t
    B, N, P = preds.shape
    S = seq.shape[1]
    shape = f"B={B} N={N} S={S} P={P} {mode}{label}"
    dp_args = (codes, preds, sink, nn, seq, sl, mode, *scores)
    walk_args = (codes, preds, nid, nn, seq, sl, mode, *scores)
    H, best = pf.full_dp(*dp_args)
    got = pf.full_walk(H, best, *walk_args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    Hp = pf._dp_full_plain(codes, preds, nn, seq, sl, mode, *scores)
    end.record()
    end.synchronize()
    pms1 = start.elapsed_time(end)
    start.record()
    want = pf._walk_full_plain(Hp, codes, preds, nid, sink, nn, seq, sl, mode, *scores)
    end.record()
    end.synchronize()
    pms2 = start.elapsed_time(end)
    best_p = pf._best_packed_plain(Hp, sink, nn, sl, mode)
    written = ((torch.arange(N + 1, device=H.device)[None, :, None] <= nn.long()[:, None, None])
               & (torch.arange(S + 1, device=H.device)[None, None, :]
                  <= sl.long()[:, None, None]))

    def again_dp():
        H2, b2 = pf.full_dp(*dp_args)
        return H2[written], b2

    err1 = _max_err(f"poa_full_dp {shape}", ("H", "best"), (H[written], best),
                    (Hp[written], best_p), again=again_dp)
    err2 = _max_err(f"poa_full_walk {shape}", ("pairs", "count", "score"), got, want,
                    again=lambda: pf.full_walk(H, best, *walk_args))
    ms1 = time_ms(lambda: pf.full_dp(*dp_args))
    ms2 = time_ms(lambda: pf.full_walk(H, best, *walk_args))
    ms_both = time_ms(lambda: pf.poa_align_batch_full(*t, mode, *scores, device=H.device))
    Hk, bk = torch.empty_like(H), torch.empty_like(best)
    res = tuple(torch.empty_like(a) for a in got)
    kms1 = kernel_ms(lambda r: pf.launch_dp(codes, preds, sink, nn, seq, sl, Hk, bk, mode,
                                            *scores))
    kms2 = kernel_ms(lambda r: pf.launch_walk(H, best, codes, preds, nid, nn, seq, sl, *res, mode,
                                              *scores))
    if not (torch.equal(Hk[written], H[written]) and torch.equal(bk, best)
            and all(map(torch.equal, res, got))):
        raise RuntimeError(f"poa_full {shape}: the timed launches differ from the wrapper's")
    b1, o1, b2, o2 = full_work(t, mode, got)
    rows = {}
    steps = int(got[1].sum())
    for name, ms, kms, pms, nb, ops, err, extra in (
            ("poa_full_dp", ms1, kms1, pms1, b1, o1, err1,
             dict(rows=int(nn.sum()), us_a_row=kms1 * 1e3 / int(nn.max()))),
            ("poa_full_walk", ms2, kms2, pms2, b2, o2, err2,
             dict(steps=steps, us_a_step=kms2 * 1e3 / max(int(got[1].max()), 1)))):
        b_ms, b_by = bound_ms(nb, ops)
        rows[name] = dict(kernel=name, shape=shape, ms=ms, kernel_ms=kms, plain_ms=pms,
                          max_abs_err=err, bound_ms=b_ms, bound_by=b_by, bytes=nb, ops=ops,
                          wrapper_both_ms=ms_both, **extra)
        log_row(rows[name])
    return rows


def full_layout_lines(arrays, label):
    """Log F1's predecessor reads at `arrays` (how many the ring serves)
    and both kernels' registers and shared memory at its shape."""
    from vechat_tpu_torch.ops.kernels import poa_full as pf

    B, N, P = np.shape(arrays[1])
    S = np.shape(arrays[5])[1]
    log(dict(phase="full_pred_distances", inputs=label,
             **pred_distances(arrays[1], arrays[4], pf.RING)))
    log(dict(phase="full_resources", inputs=label, shape=f"N={N} S={S} P={P}",
             **full_resources(S, N, P)))


def full_kernels_phase(rng):
    """Phase 9a: F1 and F2 on a synthesized batch of 64 native window graphs
    at B10's buckets (N=1024, S=767, P=8), in nw, sw and ov, each held to
    the plain version and timed (`full_rows`), with the batch's predecessor
    distances and the kernels' resources. Returns the inputs."""
    arrays = full_window_inputs(rng, B=64, N=1024, P=8, S=767)
    nn, sl = arrays[4], arrays[6]
    log(f"F1/F2 inputs: 64 windows, nodes {int(nn.min())}-{int(nn.max())}, "
        f"reads {int(sl.min())}-{int(sl.max())} bases")
    full_layout_lines(arrays, "9a")
    for mode in ("nw", "sw", "ov"):
        full_rows(arrays, mode, (3, -5, -4), " (9a)")
    return arrays


def full_backend_phase(tmp, device="cuda", goldens=GOLDENS):
    """Phase 9b: both goldens through the command line's `run` with
    `--backend full`, byte for byte against the committed goldens; the items
    on the card, the host routes (`fallbacks`), F1's and F2's launches and
    F1's tally of (B, N, S, P), F1's predecessor reads over every launch
    (`pred_distances`), every kernel's launches. Then F1 and F2 on the
    inputs of the run's heaviest launch (the largest B x N x S, the first of
    equals), held to the plain version and timed (`full_rows`). Returns
    (the kernels' launches in the phase, {kernel: row}, the heaviest
    launch's {args, mode, scores}). With device="cpu"
    it is a rehearsal on the CPU: the backend is made for the CPU (the plain
    versions) and handed to `run`; no timed rows."""
    from vechat_tpu_torch.cli.racon_main import make_backend
    from vechat_tpu_torch.cli.vechat_main import build_parser, run
    from vechat_tpu_torch.io.fastx import write_fasta
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.kernels import poa_full as pf
    from vechat_tpu_torch.utils.logger import Logger

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    original = pf.poa_align_batch_full
    heaviest = {}
    launched = []  # each launch's (preds, n_nodes): its distances after the timed runs

    def keep(*args, **kw):
        B, N, P = np.shape(args[1])
        work = B * N * np.shape(args[5])[1]
        if work > heaviest.get("work", -1):
            heaviest.update(work=work, args=args[:7], mode=args[7], scores=args[8:11])
        launched.append((args[1], args[4]))
        return original(*args, **kw)

    _build.reset_launches()
    pf.poa_align_batch_full = keep
    try:
        for reads, expected, extra in goldens:
            out = os.path.join(tmp, "full_" + os.path.basename(expected))
            args = build_parser().parse_args([reads, "-o", out, "--backend", "full", *extra])
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            # on the card the command line makes its backend, as for a user
            backend = None if on_card else make_backend("full", args.match, args.mismatch,
                                                        args.gap, device=device)
            corrected, backend = run(args, Logger(), backend=backend)
            wall = time.perf_counter() - t0
            write_fasta(corrected, out)
            same = _same_bytes(out, expected)
            c = backend.counters()
            log(dict(phase="full_backend", reads=os.path.basename(reads), byte_identical=same,
                     wall_s=wall, items_on_card=c["device_alignments"],
                     fallbacks=c["fallbacks"], dispatches=c["n_dispatches"],
                     launches={k: v - before[k] for k, v in _build.LAUNCHES.items()
                               if v != before[k]}))
            if not same:
                raise RuntimeError(f"9b: --backend full on {reads} does not reproduce {expected}")
            if not c["device_alignments"]:
                raise RuntimeError(f"9b: no item of {reads} went through B10")
    finally:
        pf.poa_align_batch_full = original
    launches = dict(_build.LAUNCHES)
    tally = sorted(_build.FULL_SHAPES.items(), key=lambda kv: -kv[1])
    log(dict(phase="full_backend_shapes", launch_shapes_B_N_S_P=[[*k, v] for k, v in tally]))
    dist = {"reads": 0, "row_0": 0, "served_by_ring": 0, "global": 0, "hist": {}}
    for preds, nn in launched:
        d = pred_distances(preds, nn, pf.RING)
        for key in ("reads", "row_0", "served_by_ring", "global"):
            dist[key] += d[key]
        for key, v in d["hist"].items():
            dist["hist"][key] = dist["hist"].get(key, 0) + v
    log(dict(phase="full_pred_distances", inputs="9b, every launch", ring=pf.RING, **dist,
             share_without_global=1 - dist["global"] / max(dist["reads"], 1)))
    for k in FULL_KERNELS:
        if on_card and launches[k] == 0:
            raise RuntimeError(f"9b: kernel {k} was not launched by --backend full")
    rows = {}
    if on_card:
        a = heaviest["args"]
        full_layout_lines(a, "9b's heaviest launch")
        rows = full_rows(a, heaviest["mode"], heaviest["scores"], " (9b's heaviest launch)")
    log(dict(phase="full_backend_total", wall_s=time.perf_counter() - t_phase,
             launches={k: v for k, v in launches.items() if v}))
    return launches, rows, heaviest


def save_full_inputs(path, arrays_9a, heaviest):
    """`--save-full PATH`: 9a's seven inputs (a_*) and those of 9b's
    heaviest launch (b_*, with its mode and scores), for `k1_probe.py
    time-full --inputs PATH`."""
    out = {f"a_{k}": np.asarray(v) for k, v in zip(FULL_ARGS, arrays_9a)}
    out.update({f"b_{k}": np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                for k, v in zip(FULL_ARGS, heaviest["args"])})
    out["b_mode"] = np.array(heaviest["mode"])
    out["b_scores"] = np.array(heaviest["scores"], np.int32)
    np.savez_compressed(path, **out)
    log(dict(phase="save_full", path=path))


def dryrun_phase(devices=("cuda:0", "cuda:0")):
    """Phase 9c: `dryrun_multichip` over `devices` (by default two shards on
    two streams of the one card) and over the first device alone; every
    part's outputs byte for byte equal."""
    import torch

    from vechat_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    many = dryrun_multichip(list(devices))
    t1 = time.perf_counter()
    one = dryrun_multichip([devices[0]])
    t2 = time.perf_counter()
    equal = {part: all(torch.equal(a, b) for a, b in zip(many[part], one[part]))
             for part in "abcd"}
    log(dict(phase="dryrun_multichip", devices=list(devices), totals=many["totals"],
             equal_to_one_device=equal, wall_s=t1 - t0, wall_s_one_device=t2 - t1))
    if not all(equal.values()):
        raise RuntimeError(f"9c: dryrun_multichip over {devices} differs from one device: {equal}")


def roofline_phase():
    """Phase 9d: `utils/roofline.main` (it prints its ROOFLINE_RESULT line)."""
    from vechat_tpu_torch.utils import roofline as rf

    t0 = time.perf_counter()
    res = rf.main()
    log(dict(phase="roofline", wall_s=time.perf_counter() - t0, mix_share=res["mix_share"]))


# ------------------------------------------------------------------ main


REPLACES = {
    "poa_dp": ("vechat_tpu_torch/csrc/poa_linear.cu", "vechat_tpu/ops/kernels/poa_pallas.py:693"),
    "poa_walk": ("vechat_tpu_torch/csrc/poa_linear.cu", "vechat_tpu/ops/kernels/poa_pallas.py:459"),
    # the host decode of K2's headers (runs_to_pairs_np, ranks_to_node_ids_np :616)
    "poa_expand": ("vechat_tpu_torch/csrc/poa_linear.cu",
                   "vechat_tpu/ops/kernels/poa_pallas.py:557"),
    "pairwise_banded": ("vechat_tpu_torch/csrc/pairwise_nw.cu",
                        "vechat_tpu/ops/kernels/pairwise_pallas.py:397"),
    "pairwise_tiled": ("vechat_tpu_torch/csrc/pairwise_nw.cu",
                       "vechat_tpu/ops/kernels/pairwise_pallas.py:173"),
    "poa_dp_affine": ("vechat_tpu_torch/csrc/poa_affine.cu",
                      "vechat_tpu/ops/kernels/poa_pallas_affine.py:488"),
    "poa_walk_affine": ("vechat_tpu_torch/csrc/poa_gap.cuh",
                        "vechat_tpu/ops/kernels/poa_pallas_affine.py:312"),
    "poa_dp_convex": ("vechat_tpu_torch/csrc/poa_convex.cu",
                      "vechat_tpu/ops/kernels/poa_pallas_convex.py:563"),
    "poa_walk_convex": ("vechat_tpu_torch/csrc/poa_gap.cuh",
                        "vechat_tpu/ops/kernels/poa_pallas_convex.py:404"),
    "poa_walk_dense": ("vechat_tpu_torch/csrc/poa_linear.cu",
                       "vechat_tpu/ops/kernels/poa_pallas.py:350"),
    "mix_peak": ("vechat_tpu_torch/csrc/mix_peak.cu", "scripts/roofline.py:119"),
    "graph_dfs": ("vechat_tpu_torch/csrc/graph_cycle.cu",
                  "vechat_tpu/ops/kernels/graph_cycle.py:268"),
    "graph_topo": ("vechat_tpu_torch/csrc/graph_cycle.cu",
                   "vechat_tpu/ops/kernels/graph_cycle.py:443"),
    "graph_topo_bundled": ("vechat_tpu_torch/csrc/graph_build.cu",
                           "vechat_tpu/ops/kernels/graph_build.py:50"),
    "graph_fuse": ("vechat_tpu_torch/csrc/graph_build.cu",
                   "vechat_tpu/ops/kernels/graph_build.py:180"),
    # the fixpoint loop of positional_subgraph (:446), :484-507
    "graph_reach": ("vechat_tpu_torch/csrc/graph_build.cu",
                    "vechat_tpu/ops/kernels/graph_build.py:484"),
    # heaviest_bundle (:205) with its _bundle_scan (:130)
    "graph_bundle": ("vechat_tpu_torch/csrc/graph_consensus.cu",
                     "vechat_tpu/ops/kernels/graph_consensus.py:205"),
    # B10's row loop (:135-153), then its best cell and traceback (:155-265)
    "poa_full_dp": ("vechat_tpu_torch/csrc/poa_full.cu", "vechat_tpu/ops/kernels/poa_jax.py:135"),
    "poa_full_walk": ("vechat_tpu_torch/csrc/poa_full.cu",
                      "vechat_tpu/ops/kernels/poa_jax.py:155"),
}


def gpu_ecc():
    """The card's volatile ECC error counts, corrected and uncorrected, as
    nvidia-smi reads them (or what it says where it cannot)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=ecc.errors.corrected.volatile.total,"
             "ecc.errors.uncorrected.volatile.total", "--format=csv"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return " | ".join((r.stdout + r.stderr).split("\n")).strip(" |")


def main(argv=()):
    # --save-k3 PATH, --save-k4 PATH, --save-full PATH, --save-build PATH:
    # also save the inputs of phase 3c, 3d, 9a and 9b's heaviest launch, and
    # phase 6's heaviest G1 and phase 7's heaviest G3, G4 and G5 launches (npz)
    saves = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(saves) - {"--save-k3", "--save-k4", "--save-full", "--save-build"}:
        print("usage: python3 chip_smoke.py [--save-k3 PATH] [--save-k4 PATH] "
              "[--save-full PATH] [--save-build PATH]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "vechat_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vechat_tpu_torch.ops.kernels import _build

    t_start = time.perf_counter()
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"gpu: {gpu}")
    log("gpu clocks.max.sm: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"gpu ecc errors at the start: {gpu_ecc()}")

    t0 = time.perf_counter()
    reports = _build.build()
    log(dict(phase="build", seconds=time.perf_counter() - t0, built=sorted(reports)))
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    device = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def lap(after):
        log(dict(phase="clock", after=after, script_s=time.perf_counter() - t_start))

    # K7 first: its measured rate stands beside every operation bound below
    rows = mix_peak_phase(device)
    inputs = window_inputs(rng, B=16, N=640, P=8, W=576, D=32)
    rows.update(k1_k2_phase(device, inputs))
    gap_kernels_phase(device, inputs)
    reads = spoa_reads(np.random.default_rng(SEED + 1))
    rows.update(gap_path_phase(device, reads))
    rows.update(k3_phase(device, rng))
    rows.update(k4_phase(device, rng))
    lap("phase 1")

    with tempfile.TemporaryDirectory() as tmp:
        goldens_phase(tmp)
        lap("phase 2")
        made = community(rng, tmp)
        launches, k1_shapes, k3_heaviest, k4_heaviest = main_path_phase(tmp, made)
        lap("phase 3")
        # K1's, K3's and K4's rows in the kernels line are the ones at the
        # main path's heaviest launches; phase 1's rows stay as lines of their own
        rows.update(k1_path_phase(device, k1_shapes)[0])
        lap("phase 3b")
        rows["pairwise_banded"] = k3_path_phase(k3_heaviest, saves.get("--save-k3"))
        lap("phase 3c")
        rows["pairwise_tiled"] = k4_path_phase(k4_heaviest, saves.get("--save-k4"))
        lap("phase 3d")
        part = head_reads(tmp, made[0], SCALE_OUT_READS)
        stream_host = start_stream_host(tmp, part, SCALE_OUT_READS)
        try:
            spoa_launches = spoa_phase(tmp, reads)
            lap("phase 4")
            scale_out_launches, dense_row = scale_out_phase(tmp, part, stream_host,
                                                            SCALE_OUT_READS)
            lap("phase 5")
            cycle_launches, cycle_rows, cycle_by_n = device_cycle_phase(tmp)
            lap("phase 6")
            build_launches, build_rows, build_by_n = device_build_phase(tmp, part,
                                                                        SCALE_OUT_READS)
            lap("phase 7")
            linear_launches, linear_rows, linear_by_n = device_linear_phase(tmp, part,
                                                                            SCALE_OUT_READS)
            if "--save-build" in saves:
                save_build_inputs(saves["--save-build"],
                                  {**cycle_by_n, **build_by_n, **linear_by_n})
            del cycle_by_n, build_by_n, linear_by_n
            lap("phase 8")
            arrays_9a = full_kernels_phase(rng)
            lap("phase 9a")
            full_launches, full_rows_9b, full_heaviest = full_backend_phase(tmp)
            if "--save-full" in saves:
                save_full_inputs(saves["--save-full"], arrays_9a, full_heaviest)
            lap("phase 9b")
            dryrun_phase()
            lap("phase 9c")
            roofline_phase()
            lap("phase 9d")
        finally:  # no process outlives the script
            if stream_host[0].poll() is None:
                stream_host[0].kill()
                stream_host[0].wait()
    # the dense walk's row is the one at its path's shape; phase 1's, at
    # K1/K2's batch, stay as lines of their own
    rows["poa_walk_dense"] = dense_row
    for k in GAP_KERNELS:
        launches[k] = spoa_launches[k]
    launches["poa_walk_dense"] = scale_out_launches["poa_walk_dense"]
    launches["mix_peak"] = rows["mix_peak"]["launches"]
    rows.update(cycle_rows)
    for k in CYCLE_KERNELS:
        launches[k] = cycle_launches[k]
    rows.update(build_rows)
    for k in BUILD_KERNELS:
        launches[k] = build_launches[k]
    rows.update(linear_rows)
    for k in LINEAR_KERNELS:
        launches[k] = linear_launches[k]
    rows.update(full_rows_9b)
    for k in FULL_KERNELS:
        launches[k] = full_launches[k]
    for k, v in launches.items():
        if k in REPLACES and v == 0:
            raise RuntimeError(f"kernel {k} was launched on no path")

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None))
        if name in ("poa_dp", "poa_walk", "poa_expand", "pairwise_banded", "pairwise_tiled",
                    *CYCLE_KERNELS, *BUILD_KERNELS, *LINEAR_KERNELS, *FULL_KERNELS):
            kernels[-1]["shape"] = r["shape"]
        if "kernel_ms" in r:
            kernels[-1]["kernel_ms"] = r["kernel_ms"]
    log(f"gpu ecc errors at the end: {gpu_ecc()}")
    log(f"gpu: {gpu}  total {time.perf_counter() - t_start:.1f} s")
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:
        # beside the traceback: whether the card counted memory errors
        print(f"chip_smoke: gpu ecc errors: {gpu_ecc()}", file=sys.stderr)
        raise
