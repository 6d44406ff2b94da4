"""Entry points of the port's flagship step, the counterpart of the JAX
package's `__graft_entry__.py` (which stays as it is).

entry(device)            -> (fn, example_args): B10, the batched POA
                            sequence-to-graph DP and its traceback
                            (`poa_full.poa_align_batch_full`, F1 and F2), in
                            nw at 3/-5/-4 on one device (the card unless
                            "cpu" is asked for), and a batch of 8 small
                            window graphs.
dryrun_multichip(devices) -> one step of each sharded stage over an explicit
                            device list (`parallel/mesh.py`), at the
                            reference's tiny shapes and with its checks:
                            (a) B10 with the pairs and cells summed over the
                            shards, (b) K1 and the dense walk, (c) round 1
                            on the device, the build chained into the prune
                            cycle, (d) round 2's consensus on the device.

The reference falls back to virtual CPU devices when it finds fewer than it
is asked for; the port takes the list it is given. As in `make_mesh`, a
device may be named more than once (each entry takes one shard), and a CUDA
device raises where there is no card.

    python -c "from vechat_tpu_torch.entry import dryrun_multichip as d; d(['cuda:0', 'cuda:0'])"
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def example_batch(B=8, N=64, S=63, P=4, seed=0, base_len=40):
    """B small POA window graphs, each of three mutated copies of a random
    base, with a query each: B10's seven numpy inputs, the arrays of
    `__graft_entry__._example_batch` for the same arguments."""
    from .ops.encode import encode
    from .ops.graph_align import LinearAligner
    from .ops.kernels.dense import graph_to_dense
    from .ops.poagraph import PoaGraph

    rng = np.random.default_rng(seed)
    eng = LinearAligner("nw", 3, -5, -4)

    codes_arr = np.zeros((B, N), dtype=np.uint8)
    preds_arr = np.zeros((B, N, P), dtype=np.int32)
    node_id_arr = np.zeros((B, N), dtype=np.int32)
    sink_arr = np.ones((B, N), dtype=bool)
    nn_arr = np.ones(B, dtype=np.int32)
    seq_arr = np.full((B, S), 0xFF, dtype=np.uint8)
    seq_arr[:, 0] = 0
    sl_arr = np.ones(B, dtype=np.int32)

    for b in range(B):
        base = "".join(rng.choice(list("ACGT"), size=base_len))
        g = PoaGraph()
        for _ in range(3):
            mut = list(base)
            for i in range(0, len(mut), 11):
                mut[i] = rng.choice(list("ACGT"))
            q = encode("".join(mut))
            aln = eng.align(q, g) if g.num_nodes() else []
            g.add_alignment(aln, q, np.ones(len(q), dtype=np.uint32))
        d = graph_to_dense(g, N, P)
        if d is None:
            raise ValueError(f"window {b} does not fit N={N}, P={P}")
        codes_arr[b] = d["codes"]
        preds_arr[b] = d["preds"]
        node_id_arr[b] = d["node_id"]
        sink_arr[b] = d["is_sink"]
        nn_arr[b] = d["n_nodes"]
        q = encode("".join(rng.choice(list("ACGT"), size=min(S - 1, base_len + 10))))
        seq_arr[b, : len(q)] = q
        sl_arr[b] = len(q)

    return codes_arr, preds_arr, node_id_arr, sink_arr, nn_arr, seq_arr, sl_arr


def entry(device="cuda"):
    """(fn, example_args): fn(codes, preds, node_id, is_sink, n_nodes, seq,
    seq_len) is B10 in nw at 3/-5/-4 on `device`, returning (pairs, count,
    score) tensors there."""
    from .ops.kernels import _build
    from .ops.kernels.poa_full import poa_align_batch_full

    dev = _build.resolve_device(device)

    def fn(codes, preds, node_id, is_sink, n_nodes, seq, seq_len):
        return poa_align_batch_full(codes, preds, node_id, is_sink, n_nodes, seq, seq_len,
                                    "nw", 3, -5, -4, device=dev)

    return fn, example_batch()


# the device programs' capacities in the dry run: nodes, edges, aligned
# ring, sequences a window (the backbone and 3 layers), sequence length
NC, EC, RC, DC, SC = 64, 128, 4, 4, 31


def dryrun_inputs(B: int, seed: int = 3) -> Dict[str, np.ndarray]:
    """The numpy inputs of the dry run's device programs, parts (c) and
    (d): B windows of a 20-base backbone and 3 layers, each with one base
    changed (`__graft_entry__.py`'s, value for value)."""
    from .ops.encode import encode

    rng = np.random.default_rng(seed)
    a = dict(
        bb_codes=np.zeros((B, SC), np.int32), bb_w=np.zeros((B, SC), np.int32),
        bb_len=np.ones(B, np.int32), lseqs=np.full((B, DC - 1, SC), 0xFF, np.int32),
        lw=np.ones((B, DC - 1, SC), np.int32), llen=np.ones((B, DC - 1), np.int32),
        lbegin=np.zeros((B, DC - 1), np.int32), lend=np.zeros((B, DC - 1), np.int32),
        lfull=np.ones((B, DC - 1), bool), n_layers=np.full(B, DC - 1, np.int32),
        avg=np.full(B, 2.0 * DC, np.float32), seqs=np.full((B, DC, SC), 0xFF, np.int32),
        slen=np.ones((B, DC), np.int32), seq_w=np.ones((B, DC, SC), np.int32),
        is_sw=np.zeros((B, DC), bool), d_used=np.full(B, DC, np.int32),
        do_trim=np.ones(B, bool),
    )
    a["seqs"][:, :, 0] = 0
    for b in range(B):
        base = "".join(rng.choice(list("ACGT"), size=20))
        bb = encode(base)
        a["bb_codes"][b, : len(bb)] = bb
        a["bb_len"][b] = len(bb)
        a["seqs"][b, 0, : len(bb)] = bb
        a["slen"][b, 0] = len(bb)
        for k in range(DC - 1):
            mut = list(base)
            mut[(3 * k + 1) % len(mut)] = rng.choice(list("ACGT"))
            q = encode("".join(mut))
            a["lseqs"][b, k, : len(q)] = q
            a["llen"][b, k] = len(q)
            a["lend"][b, k] = len(bb) - 1
            a["seqs"][b, k + 1, : len(q)] = q
            a["slen"][b, k + 1] = len(q)
            a["is_sw"][b, k + 1] = k % 2 == 1
    return a


BUILD_KEYS = ("bb_codes", "bb_w", "bb_len", "lseqs", "lw", "llen", "lbegin", "lend", "lfull",
              "n_layers")
CYCLE_KEYS = ("avg", "seqs", "slen", "seq_w", "is_sw", "d_used")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(devices: Sequence) -> dict:
    """One step of each sharded stage over `devices` (an explicit list of
    devices or names), on a batch of max(8, n) windows rounded up to a
    multiple of n: (a) B10 (`sharded_poa_align`), (b) K1 and the dense
    walk (`sharded_poa_align_cuda`), (c) `sharded_device_polish`, (d)
    `sharded_device_linear`. Raises where the reference asserts (no pairs,
    an overflow, no output bases); prints one line of totals. Returns every
    part's outputs (CPU tensors) and the totals."""
    from .parallel.mesh import (
        make_mesh,
        sharded_device_linear,
        sharded_device_polish,
        sharded_poa_align,
        sharded_poa_align_cuda,
    )

    devs = make_mesh(list(devices))
    n = len(devs)
    B = -(-max(8, n) // n) * n

    # (a) B10, the cross-shard sums of the pairs and the cells
    args = example_batch(B=B, N=32, S=31, P=4, base_len=12)
    codes, preds, nid, sink, nn, seq, sl = args
    out_a = sharded_poa_align(devs, "nw", 3, -5, -4)(*args)
    total_pairs = int(out_a[1].sum())
    total_cells = int((nn.astype(np.int64) * sl).sum())
    _check(total_pairs > 0, "B10 aligned no pairs")

    # (b) K1 and the dense walk in the JAX package's kernel layout
    W = seq.shape[1] + 1
    seqp = np.full((B, 2, W), 0xFF, np.int32)
    slen = np.ones((B, 1, 2), np.int32)
    for b in range(B):
        L = int(sl[b])
        seqp[b, :, 1 : 1 + L] = seq[b, :L]
        slen[b, 0, :] = L
    out_b = sharded_poa_align_cuda(devs, "nw", 3, -5, -4)(
        codes[:, None, :].astype(np.int32), np.transpose(preds, (0, 2, 1)).astype(np.int32),
        sink[:, None, :].astype(np.int32), nid[:, None, :].astype(np.int32),
        nn[:, None, None].astype(np.int32), seqp, slen)
    kernel_pairs = int(out_b[2].sum())
    _check(kernel_pairs > 0, "K1 and the dense walk aligned no pairs")

    # (c) round 1 on the device: the build chained into the prune cycle
    a = dryrun_inputs(B)
    out_c = sharded_device_polish(devs, NC, EC, RC, 3, -5, -4, 0.2, 0.2, 3, a_cap=8,
                                  p_cap=4)(*(a[k] for k in BUILD_KEYS + CYCLE_KEYS))
    _check(not bool(out_c[3].any()), "the device build flagged a window")
    _check(not bool(out_c[2].any()), "the device prune cycle flagged a window")
    cycle_bases = int(out_c[1].sum())
    _check(cycle_bases > 0, "the device prune cycle emitted no bases")

    # (d) round 2's consensus on the device
    out_d = sharded_device_linear(devs, NC, EC, RC, 3, -5, -4, p_cap=4)(
        *(a[k] for k in BUILD_KEYS + ("do_trim",)))
    _check(not bool(out_d[2].any()), "the device round-2 consensus flagged a window")
    linear_bases = int(out_d[1].sum())
    _check(linear_bases > 0, "the device round-2 consensus emitted no bases")

    totals = dict(devices=n, batch=B, pairs=total_pairs, cells=total_cells,
                  kernel_shard_pairs=kernel_pairs, cycle_out_bases=cycle_bases,
                  linear_out_bases=linear_bases)
    print("[dryrun_multichip] ok: " + ", ".join(f"{k}={v}" for k, v in totals.items()),
          flush=True)
    return dict(a=out_a, b=out_b, c=out_c, d=out_d, totals=totals)
