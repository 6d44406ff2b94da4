"""Sharding of the window-batch alignment step over the cards of one process.

Counterpart of `vechat_tpu/parallel/mesh.py`. The reference scales across
GPUs with independent per-device batches (src/cuda/cudapolisher.cpp:166-181);
the JAX package does it with `shard_map` over a one-axis device mesh. Here
the mesh is a plain list of `torch.device`s: the batch axis of a launch is
cut into one contiguous shard per entry, shard k is uploaded to device k and
runs the POA DP (K1) and the dense walk there on a CUDA stream of its own.
Windows are independent, so the shards exchange nothing and none waits for
another; their outputs come back to the host in shard order.

`sharded_poa_align` does the same for B10, the full-matrix DP and its walk
(`ops/kernels/poa_full.py`, F1 and F2), the counterpart of the JAX
package's function of that name. `sharded_device_polish` and
`sharded_device_linear` shard the device programs the same way: round 1's
build chained into its prune cycle (B7 into B8) and round 2's consensus
(B9), as `dryrun_multichip` (`vechat_tpu_torch/entry.py`) runs them. Those
programs read small values back to the host between their steps; each
read waits on its shard's stream only, so no shard waits on the default
stream, but a shard's steps are enqueued only when the shard before it has
finished its own on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels.poa_linear import poa_align

WINDOW_AXIS = "windows"

Devices = Union[None, int, Sequence[Union[str, torch.device]]]


def make_mesh(n_devices: Devices = None) -> List[torch.device]:
    """The devices a window batch is sharded over: every visible card, the
    first `n_devices` of them, or an explicit list (strings or devices; a
    device may be named more than once, each entry takes one shard). Raises
    when a CUDA device is asked for and there is none."""
    if n_devices is None or isinstance(n_devices, int):
        _build.resolve_device("cuda")
        devs = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
        return devs if n_devices is None else devs[:n_devices]
    devs = [_build.resolve_device(d) for d in n_devices]
    if not devs:
        raise ValueError("an explicit device list must name at least one device")
    return devs


def _sharded(devices: Sequence[torch.device], run_shard):
    """fn(*arrays) running `run_shard(device, shard_arrays)` on one
    contiguous shard of the arrays' batch axis a device, the outputs (a
    tuple of tensors) concatenated in shard order as CPU tensors. B must
    divide by the number of devices. On a CUDA device a shard runs on its
    own stream and its outputs go to pinned host memory; every shard is
    enqueued before the first is waited for. A CPU device runs the plain
    versions. `devices` as `make_mesh` takes an explicit list."""
    devices = make_mesh(list(devices))
    n = len(devices)
    # one stream per shard, made at the first call (and only for a card)
    streams: List[Optional[torch.cuda.Stream]] = [None] * n

    def fn(*args):
        B = args[0].shape[0]
        if any(a.shape[0] != B for a in args):
            raise ValueError(f"the {len(args)} inputs must share their batch axis")
        if B % n:
            raise ValueError(f"batch {B} does not divide over {n} shards")
        per = B // n
        outs = []
        for k, dev in enumerate(devices):
            shard = tuple(a[k * per : (k + 1) * per] for a in args)
            if dev.type != "cuda":
                outs.append(tuple(run_shard(dev, shard)))
                continue
            if streams[k] is None:
                streams[k] = torch.cuda.Stream(device=dev)
            with torch.cuda.stream(streams[k]):
                host = []
                for t in run_shard(dev, shard):
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    host.append(h.copy_(t, non_blocking=True))
                outs.append(tuple(host))
        for s in streams:
            if s is not None:
                s.synchronize()
        return tuple(torch.cat([o[i] for o in outs]) for i in range(len(outs[0])))

    return fn


def sharded_poa_align_cuda(
    devices: Sequence[torch.device],
    align_type: str,
    m: int,
    x: int,
    g: int,
    ring: int = 0,
    emit_node_ids: bool = True,
):
    """The POA DP and the dense walk over `devices` (from `make_mesh`).

    Returns fn(codes, preds, sink, node_id, n_nodes, seqp, seq_len), the
    layouts of `poa_align` (numpy arrays or tensors), giving (pn, pp
    [B, D, L] int16, count, score [B, 1, D] int32) as CPU tensors: the
    shards' outputs in shard order (`_sharded`)."""

    def run_shard(dev, args):
        codes, preds, sink, node_id, n_nodes, seqp, seq_len = args
        return poa_align(
            codes, preds, sink, n_nodes, seqp, seq_len, align_type, m, x, g,
            ring=ring, device=dev, emit_rle=False,
            emit_node_ids=emit_node_ids, node_id=node_id if emit_node_ids else None,
        )

    return _sharded(devices, run_shard)


def sharded_poa_align(devices: Sequence[torch.device], align_type: str, m: int, x: int, g: int):
    """B10 over `devices` (from `make_mesh`), the counterpart of the JAX
    package's `sharded_poa_align`. Returns fn(codes, preds, node_id,
    is_sink, n_nodes, seq, seq_len), the layouts of
    `poa_full.poa_align_batch_full`, giving (pairs [B, L, 2], count [B],
    score [B]) int32 CPU tensors in shard order (`_sharded`)."""
    from ..ops.kernels.poa_full import poa_align_batch_full

    def run_shard(dev, args):
        return poa_align_batch_full(*args, align_type, m, x, g, device=dev)

    return _sharded(devices, run_shard)


def _tensors(args, dev):
    return [a.to(dev) if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in args]


def sharded_device_polish(devices: Sequence[torch.device], n_cap: int, e_cap: int, r_cap: int,
                          m: int, x: int, g: int, min_confidence: float, min_support: float,
                          num_prune: int, a_cap: int, p_cap: int):
    """Round 1 on the device over `devices`: B7's `device_build` chained
    into B8's `haplotype_cycle` as `pipeline/device_cycle.run_device_polish`
    chains them (a window the build flags reaches the cycle without edges).
    Returns fn(bb_codes, bb_w, bb_len, lseqs, lw, llen, lbegin, lend, lfull,
    n_layers, avg_weight, seqs, seq_len, seq_w, is_sw, d_used): the build's
    arguments, then the cycle's (numpy arrays or tensors), giving
    (corrected, out_len, the cycle's overflow bits, the build's overflow
    bits) as CPU tensors in shard order (`_sharded`). `a_cap` and `p_cap`
    are the cycle's caps; the build keeps its own defaults."""
    from ..ops.kernels.graph_build import device_build
    from ..ops.kernels.graph_cycle import haplotype_cycle

    def run_shard(dev, args):
        t = _tensors(args, dev)
        built = device_build(*t[:10], n_cap, e_cap, r_cap, m, x, g)
        bad = built["overflow"]
        out = haplotype_cycle(built["tails"], built["heads"], built["weights"],
                              torch.where(bad, 0, built["n_edges"]), built["codes"],
                              built["n_nodes"].clamp_max(n_cap), *t[10:], min_confidence,
                              min_support, num_prune, m, x, g, a_cap=a_cap, p_cap=p_cap)
        return (*out[:3], built["overflow_bits"])

    return _sharded(devices, run_shard)


def sharded_device_linear(devices: Sequence[torch.device], n_cap: int, e_cap: int, r_cap: int,
                          m: int, x: int, g: int, p_cap: int):
    """Round 2's window consensus on the device over `devices`: B9's
    `device_linear`. Returns fn(bb_codes, bb_w, bb_len, lseqs, lw, llen,
    lbegin, lend, lfull, n_layers, do_trim) (numpy arrays or tensors),
    giving (out, out_len, overflow bits) as CPU tensors in shard order
    (`_sharded`)."""
    from ..ops.kernels.graph_consensus import device_linear

    def run_shard(dev, args):
        return device_linear(*_tensors(args, dev), n_cap, e_cap, r_cap, m, x, g, p_cap=p_cap)

    return _sharded(devices, run_shard)
