"""All-to-all between the shards of a mesh axis: kernel K3 and its plain version.

Replaces the JAX package's Pallas kernel `parallel/ici.py::_a2a_kernel`
(called through `pallas_all_to_all`), the exchange that the four-step
ring-sharded NTT (`ntt_dist.py`) runs for both of its transposes.
`all_to_all` has the semantics of `pallas_all_to_all` and of
`lax.all_to_all(tiled=True)`: shard j receives chunk j of every shard's
`split_axis`, concatenated along `concat_axis` in source order.

As on the TPU, the wrapper moves `split_axis` to the front and flattens
each shard to (D*c, W); the kernel (`csrc/all_to_all.cu`) writes chunk j
of shard s into rows [s*c, (s+1)*c) of shard j's output, through peer
pointers when the two lie on different cards; the wrapper then restores
the axis order and concatenates the D received blocks.

For CUDA shards `all_to_all` launches the kernel, one launch per source
shard; cards that cannot reach each other make it raise (it never stages
through the host).  For CPU shards it runs the plain version
`all_to_all_ref` (torch chunk, `.to(device)` and cat).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import torch

from .. import kernels

# The kernel takes the destination pointers by value in a fixed struct.
MAX_SHARDS = 16

_peers_lock = threading.Lock()
_peers: set = set()          # (device, peer) pairs with peer access enabled


def all_to_all_ref(shards: Sequence[torch.Tensor], split_axis: int,
                   concat_axis: int) -> List[torch.Tensor]:
    """Plain version: out_j = cat_s(chunk j of shards[s] along split_axis)."""
    d = len(shards)
    chunks = [x.chunk(d, dim=split_axis) for x in shards]
    return [torch.cat([chunks[s][j].to(shards[j].device) for s in range(d)],
                      dim=concat_axis)
            for j in range(d)]


def _check(shards: Sequence[torch.Tensor], split_axis: int) -> None:
    d = len(shards)
    if not 1 <= d <= MAX_SHARDS:
        raise ValueError(f"all_to_all over {d} shards; the kernel takes 1..{MAX_SHARDS}")
    x0 = shards[0]
    for x in shards:
        if x.dtype != torch.uint32 or x.shape != x0.shape:
            raise ValueError(f"all_to_all needs uint32 shards of one shape, got "
                             f"{[(tuple(s.shape), s.dtype) for s in shards]}")
        if x.device.type != "cuda":
            raise ValueError(f"the all-to-all kernel needs CUDA shards, got {x.device}")
    if x0.shape[split_axis] % d:
        raise ValueError(f"split axis {split_axis} of {tuple(x0.shape)} does not "
                         f"divide over {d} shards")


def _enable_peers(devices: Sequence[torch.device]) -> None:
    lib = kernels.load()
    with _peers_lock:
        for a in devices:
            for b in devices:
                if a != b and (a, b) not in _peers:
                    kernels.check(lib.fhe_enable_peer_access(a.index, b.index),
                                  f"peer access {a} -> {b}")
                    _peers.add((a, b))


def _event_on(device: torch.device) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def exchange(flats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The 2-D all-to-all on D (D*c, W) uint32 shards.

    out_j[s*c:(s+1)*c] = x_s[j*c:(j+1)*c]: the kernel for CUDA shards, one
    launch per source shard; for CPU shards the plain version,
    `all_to_all_ref(flats, 0, 0)`.
    """
    if all(x.device.type == "cpu" for x in flats):
        return all_to_all_ref(flats, 0, 0)
    _check(flats, 0)
    if not all(x.is_contiguous() and x.dim() == 2 for x in flats):
        raise ValueError("exchange needs contiguous 2-D shards")
    d = len(flats)
    rows, w = flats[0].shape
    chunk = rows // d * w
    outs = [torch.empty_like(x) for x in flats]
    if chunk == 0:
        return outs
    by_card: dict = {}                       # card -> its source shards, in order
    for s, x in enumerate(flats):
        by_card.setdefault(x.device, []).append(s)
    cross = len(by_card) > 1
    if cross:
        _enable_peers(sorted(by_card, key=lambda v: v.index))
        ready = [_event_on(o.device) for o in outs]
    lib = kernels.load()
    dsts = (ctypes.c_void_p * d)(*(o.data_ptr() for o in outs))
    sent = {}
    for card, sources in by_card.items():
        stream = torch.cuda.current_stream(card)
        with kernels.launch_on(card) as handle:
            if cross:
                for j, o in enumerate(outs):
                    if o.device != card:
                        stream.wait_event(ready[j])
                        o.record_stream(stream)
            for s in sources:
                err = lib.fhe_all_to_all(flats[s].data_ptr(), dsts, d, chunk, s, handle)
                kernels.check(err, "all_to_all")
                kernels.launches["all_to_all"] += 1
            if cross:
                sent[card] = _event_on(card)
    if cross:
        for card in by_card:
            stream = torch.cuda.current_stream(card)
            for src_card, ev in sent.items():
                if src_card != card:
                    stream.wait_event(ev)
    return outs


def _flatten(x: torch.Tensor, split_axis: int) -> Tuple[torch.Tensor, tuple]:
    """(..., D*c at split_axis, ...) -> contiguous (D*c, W) and the other dims."""
    xs = x.movedim(split_axis, 0)                    # (D*c, ...rest)
    return xs.reshape(xs.shape[0], -1).contiguous(), tuple(xs.shape[1:])


def all_to_all(shards: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """Exchange chunk j of every shard's split_axis to shard j; concat on concat_axis."""
    if all(x.device.type == "cpu" for x in shards):
        return all_to_all_ref(shards, split_axis, concat_axis)
    d = len(shards)
    _check(shards, split_axis)
    cs = shards[0].shape[split_axis] // d
    flats = [_flatten(x, split_axis) for x in shards]
    rest = flats[0][1]
    outs = exchange([f for f, _ in flats])
    result = []
    for out in outs:
        blocks = out.reshape((d, cs) + rest).movedim(1, 1 + split_axis)
        result.append(torch.cat([blocks[i] for i in range(d)], dim=concat_axis))
    return result
