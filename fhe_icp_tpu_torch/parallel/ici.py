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

For CUDA shards `all_to_all` launches the kernel, one launch per card
covering every source shard on it (`launch_plan`); cards that cannot
reach each other make it raise (it never stages through the host).  For
CPU shards it runs the plain version `all_to_all_ref` (torch chunk,
`.to(device)` and cat).
"""

from __future__ import annotations

import threading
from array import array
from typing import Dict, List, Sequence, Tuple

import torch

from .. import kernels

# The kernel takes the source and destination pointers by value in a fixed struct.
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


def launch_plan(devices: Sequence[torch.device]) -> Dict[torch.device, List[int]]:
    """{card: the indices of the shards on it, in order}, cards in order of first use.

    One K3 launch per card covers its sources; with 8 shards round-robin on
    4 cards, card c holds shards c and c + 4.
    """
    plan: Dict[torch.device, List[int]] = {}
    for s, dev in enumerate(devices):
        plan.setdefault(dev, []).append(s)
    return plan


def _shard_pointers(flats: Sequence[torch.Tensor]) -> Tuple[List[int], List[int]]:
    """Each shard's data pointer and card index, after checking what the kernel takes."""
    d = len(flats)
    shape = flats[0].shape
    if not 1 <= d <= MAX_SHARDS or len(shape) != 2 or shape[0] % d:
        raise ValueError(f"exchange takes 1..{MAX_SHARDS} 2-D shards whose rows divide "
                         f"over them; got {d} of {tuple(shape)}")
    ptrs, cards = [], []
    for x in flats:
        if x.dtype is not torch.uint32 or x.shape != shape or not x.is_cuda \
                or not x.is_contiguous():
            raise ValueError(f"exchange needs contiguous uint32 CUDA shards of one shape, got "
                             f"{[(tuple(y.shape), y.dtype, str(y.device)) for y in flats]}")
        ptrs.append(x.data_ptr())
        cards.append(x.get_device())
    return ptrs, cards


def exchange(flats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The 2-D all-to-all on D (D*c, W) uint32 shards.

    out_j[s*c:(s+1)*c] = x_s[j*c:(j+1)*c]: the kernel for CUDA shards, one
    launch per card; for CPU shards the plain version,
    `all_to_all_ref(flats, 0, 0)`.  The outputs on one card are views of
    one (shards on the card, D*c, W) buffer.  At the four-step NTT's sizes
    the host work of this function, not the copy, sets its time, so the
    checks and pointers take one pass over the shards.
    """
    if flats[0].device.type == "cpu" and all(x.device.type == "cpu" for x in flats):
        return all_to_all_ref(flats, 0, 0)
    srcs, cards = _shard_pointers(flats)
    d = len(flats)
    rows, w = flats[0].shape
    chunk, step = rows // d * w, rows * w * 4
    lib = kernels.load()
    if cards.count(cards[0]) == d:            # one card: sources 0 .. D-1 in order
        card = flats[0].device
        buf = torch.empty((d, rows, w), dtype=torch.uint32, device=card)
        if chunk:
            base = buf.data_ptr()
            ptrs = array("Q", srcs)               # the sources, then the destinations
            ptrs.extend(range(base, base + d * step, step))
            at = ptrs.buffer_info()[0]
            with kernels.launch_on(card) as handle:
                err = lib.fhe_all_to_all(at, None, d, at + 8 * d, d, chunk, handle)
            kernels.check(err, "all_to_all")
            kernels.launches["all_to_all"] += 1
        return list(buf.unbind(0))

    # Several cards: one buffer and one launch each, ordered by stream events.
    plan = launch_plan([x.device for x in flats])
    outs: List[torch.Tensor] = [None] * d
    dsts = array("Q", bytes(8 * d))
    bufs = {}
    for card, sources in plan.items():
        buf = bufs[card] = torch.empty((len(sources), rows, w), dtype=torch.uint32, device=card)
        for pos, (s, view) in enumerate(zip(sources, buf.unbind(0))):
            outs[s] = view
            dsts[s] = buf.data_ptr() + pos * step
    if chunk == 0:
        return outs
    _enable_peers(list(plan))
    ready = {card: _event_on(card) for card in plan}
    sent = {}
    for card, sources in plan.items():
        stream = torch.cuda.current_stream(card)
        card_srcs, index = array("Q", (srcs[s] for s in sources)), array("i", sources)
        with kernels.launch_on(card) as handle:
            for other, ev in ready.items():
                if other != card:
                    stream.wait_event(ev)
                    bufs[other].record_stream(stream)
            err = lib.fhe_all_to_all(card_srcs.buffer_info()[0], index.buffer_info()[0],
                                     len(sources), dsts.buffer_info()[0], d, chunk, handle)
            sent[card] = _event_on(card)
        kernels.check(err, "all_to_all")
        kernels.launches["all_to_all"] += 1
    for card in plan:
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
