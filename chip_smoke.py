#!/usr/bin/env python3
"""Smoke test of vechat_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (each raises on failure; the script exits non-zero on any):
  0. the card's name and power limit; build the CUDA kernels with nvcc
  1. each kernel (K1 POA DP, K2 POA walk, K3 banded NW, K4 tiled NW) at the
     main path's shapes against its plain PyTorch version on the same
     inputs, exact equality; CUDA-event times of both
  2. `vechat --backend cuda` reproduces the two committed goldens
  3. the main path: a seeded two-strain community (2 x 12.5 kb strains,
     1% apart; 200 reads x 2.5 kb at 8% ONT-profile error) corrected by
     `vechat --backend cuda`; wall time, reads/s, error before and after,
     strain preservation, and each kernel's launches in this run

The second-to-last line is {"kernels": [...]} with, per kernel, its launches
in phase 3, the largest difference from its plain version in phase 1 (0:
the tolerance is exact), its time, the plain version's time and the bound
(the least time the card could take for the same work). The last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout,
it exits non-zero and prints no result.
"""

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


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
        backbone = rand_seq(rng, min(500, W - 76))
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


def k1_k2_phase(device, rng, B=16, N=640, P=8, W=576, D=32):
    import torch

    from vechat_tpu_torch.ops.kernels import poa_linear as pl

    codes, preds, sink, nid, nn, seqp, slen = window_inputs(rng, B, N, P, W, D)
    dist = max(pl.max_pred_distance(preds[b].T, nn[b, 0, 0]) for b in range(B))
    log(f"K1/K2 inputs: {B} windows, nodes {int(nn.min())}-{int(nn.max())}, "
        f"max predecessor distance {dist}, D={D}, W={W}")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    codes_t, sink_t = t(codes).reshape(B, N), t(sink).reshape(B, N)
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
        kr, ks, kc = pl.traceback_walk_rle(dirs, maxi, maxj, mode, L, P)
        pr, ps, pc = pl._walk_plain(dirs, maxi, maxj, mode, L, P)
        err2 = _walk_err(kr, ks, kc, pr, ps, pc)
        if err2:
            raise RuntimeError(f"K2 {mode} ring {ring}: walk differs from plain by {err2}")
        ms1 = time_ms(lambda: pl.poa_dp(*args))
        pms1 = time_ms(lambda: pl._dp_plain(*args), reps=2)
        ms2 = time_ms(lambda: pl.traceback_walk_rle(dirs, maxi, maxj, mode, L, P))
        pms2 = time_ms(lambda: pl._walk_plain(dirs, maxi, maxj, mode, L, P), reps=2)
        # bound inputs from this run's data
        n_rows = int(nn_t.sum())
        deg_real = int((deg * real_rows[:, 1:]).sum())
        cells = n_rows * D * W
        k1_bytes = (n_rows * (3 + P) * 4 + seqp.nbytes + slen.nbytes
                    + (n_rows + B) * D * W * 2 + 3 * B * D * 4)
        k1_ops = cells * K1_OPS_CELL + deg_real * D * W * K1_OPS_EDGE
        steps = int((kr != 0).sum())
        k2_bytes = steps * (2 + 4) + B * D * 12
        k2_ops = steps * WALK_OPS_STEP
        shape = f"B={B} N={N} D={D} W={W} P={P} ring={ring} {mode}"
        for name, ms, pms, nb, ops, e in (("poa_dp", ms1, pms1, k1_bytes, k1_ops, err),
                                          ("poa_walk", ms2, pms2, k2_bytes, k2_ops, err2)):
            b_ms, b_by = bound_ms(nb, ops)
            row = dict(kernel=name, shape=shape, ms=ms, plain_ms=pms, max_abs_err=e,
                       bound_ms=b_ms, bound_by=b_by)
            log(row)
            if (mode, ring) == ("nw", dist):  # the ring the backend picks
                results[name] = row
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


def nw_pairs(rng, n, lo, hi, rate):
    from vechat_tpu_torch.ops.encode import encode

    pairs = []
    for _ in range(n):
        t = rand_seq(rng, int(rng.integers(lo, hi)))
        q = ont_read(rng, t, rate)[:hi]
        pairs.append((encode(q), encode(t)))
    return pairs


def k3_phase(device, rng, T=2560, BW=896, NP=256):
    from vechat_tpu_torch.ops.encode import encode
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw

    pairs = nw_pairs(rng, NP - 1, T * 7 // 10, T - 10, 0.08)
    # one pair far beyond the band: rejected, but its walk must end
    pairs.append((encode(rand_seq(rng, T * 3 // 4)), encode(rand_seq(rng, T * 3 // 4 + BW // 8))))
    t, ext, tl, ql, lo_ = pw.banded_inputs(*pw.pack_banded(pairs, T, BW), BW, device)
    NP = t.shape[0]
    k_out = pw.banded_nw(t, ext, tl, ql, lo_, BW)
    p_out = pw._banded_plain(t, ext, tl, ql, lo_, BW)
    err = _max_err("K3", k_out, p_out)
    ms = time_ms(lambda: pw.banded_nw(t, ext, tl, ql, lo_, BW))
    pms = time_ms(lambda: pw._banded_plain(t, ext, tl, ql, lo_, BW), reps=2)
    rows = int(tl.sum())
    L = T + BW
    nbytes = rows * 4 + int((tl + BW).sum()) * 4 + NP * 12 + NP * L * 2 * 2 + NP * 8
    b_ms, b_by = bound_ms(nbytes, rows * BW * NW_OPS_CELL)
    accepted = int((k_out[3] <= (BW - 1 - (ql - tl).abs()) // 2 - 2).sum())
    row = dict(kernel="pairwise_banded", shape=f"{NP} pairs T={T} BW={BW}",
               ms=ms, plain_ms=pms, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               accepted=accepted)
    log(row)
    return {"pairwise_banded": row}


def k4_phase(device, rng, T=512, W=512, NP=64):
    from vechat_tpu_torch.ops.kernels import pairwise_nw as pw

    tiles = nw_pairs(rng, NP, T * 4 // 5, T - 1, 0.08)
    t, q, tl, ql = pw.tiled_inputs(*pw.pack_tiles(tiles, T, W), device)
    NP = t.shape[0]
    k_out = pw.tiled_nw(t, q, tl, ql)
    p_out = pw._tiled_plain(t, q, tl, ql)
    err = _max_err("K4", k_out, p_out)
    ms = time_ms(lambda: pw.tiled_nw(t, q, tl, ql))
    pms = time_ms(lambda: pw._tiled_plain(t, q, tl, ql), reps=2)
    rows = int(tl.sum())
    L = T + W
    nbytes = rows * 4 + NP * W * 4 + NP * 8 + NP * L * 4 * 2 + NP * 8
    b_ms, b_by = bound_ms(nbytes, rows * W * NW_OPS_CELL)
    row = dict(kernel="pairwise_tiled", shape=f"{NP} tiles T={T} W={W}", ms=ms,
               plain_ms=pms, max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    log(row)
    return {"pairwise_tiled": row}


def _max_err(label, k_out, p_out):
    import torch

    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(("pt", "pq", "count", "dist"), k_out, p_out):
        bad = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
        if bad:
            raise RuntimeError(f"{label}: {name} differs from plain by {bad}")
        err = max(err, bad)
    return err


# -------------------------------------------------------- phase 2: goldens


def goldens_phase(tmp):
    from vechat_tpu_torch.cli.vechat_main import main

    data = os.path.join(REPO, "tests", "data")
    for reads, expected, extra in (
        ("golden_reads.fq", "golden_expected.fa", ["--platform", "ont"]),
        ("golden2_reads.fq", "golden2_expected_pb.fa", ["--platform", "pb", "--no-auto-sensitive"]),
    ):
        out = os.path.join(tmp, expected)
        t0 = time.perf_counter()
        rc = main([os.path.join(data, reads), "-o", out, "--backend", "cuda", *extra])
        wall = time.perf_counter() - t0
        with open(out, "rb") as a, open(os.path.join(data, expected), "rb") as b:
            same = a.read() == b.read()
        log(dict(phase="golden", reads=reads, rc=rc, byte_identical=same, wall_s=wall))
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


def main_path_phase(tmp, rng, backend_name="cuda"):
    import torch

    from vechat_tpu_torch.cli.vechat_main import build_parser, run
    from vechat_tpu_torch.ops.encode import encode
    from vechat_tpu_torch.ops.kernels import _build
    from vechat_tpu_torch.ops.pairwise import edit_distance, edit_distance_infix
    from vechat_tpu_torch.utils.logger import Logger

    path, truth, (strain_a, strain_b) = community(rng, tmp)
    args = build_parser().parse_args(
        [path, "-o", os.path.join(tmp, "corrected.fa"), "--platform", "ont",
         "--backend", backend_name]
    )
    _build.reset_launches()
    # device activity only: CUPTI records every kernel and copy on the card
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        corrected, backend = run(args, Logger())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    counters = backend.counters() if hasattr(backend, "counters") else {}
    device_ms = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us:
            device_ms[ev.key] = us / 1e3
    busy_s = sum(device_ms.values()) / 1e3
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    stages = {}
    if hasattr(backend, "t_pack"):
        stages = dict(poa_pack_s=backend.t_pack, poa_device_s=backend.t_device,
                      poa_decode_s=backend.t_decode, poa_host_route_s=backend.t_host_fb)
        pw = backend._pairwise
        if pw is not None:
            stages.update(pair_pack_s=pw.t_tile, pair_device_s=pw.t_device,
                          pair_host_s=pw.t_host, pair_cigar_s=pw.t_asm)

    pad = 120
    before, after, own_strain = [], [], 0
    for rec in corrected:
        name = rec.name.split()[0].rstrip("r")
        frag, is_a, start, raw = truth[name]
        end = start + len(frag) + pad
        own = (strain_a if is_a else strain_b)[max(0, start - pad) : end]
        other = (strain_b if is_a else strain_a)[max(0, start - pad) : end]
        d_own = edit_distance_infix(encode(rec.data), encode(own))
        d_other = edit_distance_infix(encode(rec.data), encode(other))
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
             device_ms_top={k: v for k, v in top}))
    if backend_name != "cuda":  # a rehearsal on the CPU
        return launches
    for k in REPLACES:
        if launches[k] == 0:
            raise RuntimeError(f"kernel {k} was not launched on the main path")
    if counters["device_alignments"] <= counters["fallbacks"]:
        raise RuntimeError(f"host routes dominate: {counters}")
    if not corrected or reduction < 4:
        raise RuntimeError(f"error fell only {reduction:.2f}x (floor 4x)")
    return launches


# ------------------------------------------------------------------ main


REPLACES = {
    "poa_dp": ("vechat_tpu_torch/csrc/poa_linear.cu", "vechat_tpu/ops/kernels/poa_pallas.py:693"),
    "poa_walk": ("vechat_tpu_torch/csrc/poa_linear.cu", "vechat_tpu/ops/kernels/poa_pallas.py:459"),
    "pairwise_banded": ("vechat_tpu_torch/csrc/pairwise_nw.cu",
                        "vechat_tpu/ops/kernels/pairwise_pallas.py:397"),
    "pairwise_tiled": ("vechat_tpu_torch/csrc/pairwise_nw.cu",
                       "vechat_tpu/ops/kernels/pairwise_pallas.py:173"),
}


def main():
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
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = _build.build()
    log(dict(phase="build", seconds=time.perf_counter() - t0, built=sorted(reports)))
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    device = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows = {}
    rows.update(k1_k2_phase(device, rng))
    rows.update(k3_phase(device, rng))
    rows.update(k4_phase(device, rng))

    with tempfile.TemporaryDirectory() as tmp:
        goldens_phase(tmp)
        launches = main_path_phase(tmp, rng)

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None))
    log(f"gpu: {gpu}  total {time.perf_counter() - t_start:.1f} s")
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
