"""Sharding of the window-batch alignment step over the cards of one process.

Counterpart of `vechat_tpu/parallel/mesh.py`. The reference scales across
GPUs with independent per-device batches (src/cuda/cudapolisher.cpp:166-181);
the JAX package does it with `shard_map` over a one-axis device mesh. Here
the mesh is a plain list of `torch.device`s: the batch axis of a launch is
cut into one contiguous shard per entry, shard k is uploaded to device k and
runs the POA DP (K1) and the dense walk there on a CUDA stream of its own.
Windows are independent, so the shards exchange nothing and none waits for
another; their outputs come back to the host in shard order.

The XLA-only `sharded_poa_align` of the JAX package wraps its plain-XLA
batch aligner (`poa_jax.poa_align_batch_device`), which the port does not
have yet; the name stays free for it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

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
    shards' outputs in shard order. B must divide by the number of devices.
    On a CUDA device a shard runs on its own stream and its outputs go to
    pinned host memory; every shard is enqueued before the first is waited
    for. A CPU device runs the plain versions."""
    devices = list(devices)
    n = len(devices)
    # one stream per shard, made at the first call (and only for a card)
    streams: List[Optional[torch.cuda.Stream]] = [None] * n

    def run_shard(k, args):
        codes, preds, sink, node_id, n_nodes, seqp, seq_len = args
        return poa_align(
            codes, preds, sink, n_nodes, seqp, seq_len, align_type, m, x, g,
            ring=ring, device=devices[k], emit_rle=False,
            emit_node_ids=emit_node_ids, node_id=node_id if emit_node_ids else None,
        )

    def fn(codes, preds, sink, node_id, n_nodes, seqp, seq_len):
        args = (codes, preds, sink, node_id, n_nodes, seqp, seq_len)
        B = args[0].shape[0]
        if any(a.shape[0] != B for a in args):
            raise ValueError("the seven inputs must share their batch axis")
        if B % n:
            raise ValueError(f"batch {B} does not divide over {n} shards")
        per = B // n
        outs = []
        for k, dev in enumerate(devices):
            shard = tuple(a[k * per : (k + 1) * per] for a in args)
            if dev.type != "cuda":
                outs.append(run_shard(k, shard))
                continue
            if streams[k] is None:
                streams[k] = torch.cuda.Stream(device=dev)
            with torch.cuda.stream(streams[k]):
                host = []
                for t in run_shard(k, shard):
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    host.append(h.copy_(t, non_blocking=True))
                outs.append(tuple(host))
        for s in streams:
            if s is not None:
                s.synchronize()
        return tuple(torch.cat([o[i] for o in outs]) for i in range(4))

    return fn
