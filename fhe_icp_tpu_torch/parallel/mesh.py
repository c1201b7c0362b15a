"""A mesh of logical shards for the port's sharded programs.

The JAX package shards its programs with `jax.shard_map` over a device
mesh, and its CPU tests run them on eight virtual devices in one process.
The port's mesh is that model: one process drives every shard, and each
logical shard has a torch.device, placed round-robin on the visible cards
(`cuda:(i % device_count)`).  On one H100 all shards share the card; on a
host with several cards they spread over them, and the all-to-all
(`parallel/ici.py`) writes across cards through peer pointers.

Axes, as in the JAX package:

* `dp` — documents (ciphertext batches, packed groups);
* `tp` — RNS limbs;
* `sp` — rows of the ring dimension, for the four-step NTT (`ntt_dist.py`).

A sharded value is a plain list of per-shard tensors in mesh order
(row-major over the axes), each on its shard's device.  A spec names, for
each dim of a tensor, the mesh axis that splits it or None, as JAX's
`PartitionSpec` does; a mesh axis that splits no dim replicates the value
over its shards.  `shard` cuts a tensor by a spec, `gather` puts the
pieces back together.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..devices import target

DP_AXIS = "dp"
TP_AXIS = "tp"
SP_AXIS = "sp"

Spec = Tuple[Optional[str], ...]

# Ciphertext batches (B, k, L, N): documents over dp, limbs over tp.
BATCH_SPEC: Spec = (DP_AXIS, None, TP_AXIS, None)
# PackedDocOperand digits (L, G*4, 2N): group-major rows over dp.
PACKED_OPERAND_SPEC: Spec = (None, DP_AXIS, None)
# The same value on every shard.
REPLICATED: Spec = ()


@dataclass(frozen=True)
class Mesh:
    """Named axes of logical shards and the device of each shard."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]     # one per shard, row-major over axes

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, i: int) -> Dict[str, int]:
        """Axis coordinates of shard i."""
        out = {}
        for axis, n in zip(reversed(self.axes), reversed(self.sizes)):
            i, out[axis] = divmod(i, n)
        return out

    def index(self, coords: Mapping[str, int]) -> int:
        """The shard at `coords`; axes left out are at 0."""
        i = 0
        for axis, n in zip(self.axes, self.sizes):
            i = i * n + coords.get(axis, 0)
        return i


def make_mesh(n_devices: int, shape: Optional[Sequence[int]] = None,
              device: torch.device | str = "cuda",
              axes: Tuple[str, ...] = (DP_AXIS, TP_AXIS)) -> Mesh:
    """A mesh of n_devices logical shards over `axes`.

    `shape` gives each axis's size; by default every shard is on the first
    axis.  Shards go round-robin on the visible cards unless `device`
    names the CPU; without CUDA the default raises.
    """
    dev = target(device, "make_mesh")
    shape = tuple(shape) if shape is not None else (n_devices,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes) or math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {shape} over axes {axes} != {n_devices} shards")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", i % count) for i in range(n_devices))
    else:
        devices = (dev,) * n_devices
    return Mesh(tuple(axes), shape, devices)


def _full_spec(spec: Spec, ndim: int) -> Spec:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    return tuple(spec) + (None,) * (ndim - len(spec))


def shard(mesh: Mesh, x: torch.Tensor, spec: Spec) -> List[torch.Tensor]:
    """Cut x by `spec` into one contiguous tensor per shard, on its device."""
    spec = _full_spec(spec, x.dim())
    sizes = mesh.shape
    for dim, axis in enumerate(spec):
        if axis is not None and x.shape[dim] % sizes[axis]:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {sizes[axis]} {axis} shards")
    out = []
    for i, dev in enumerate(mesh.devices):
        c, part = mesh.coords(i), x
        for dim, axis in enumerate(spec):
            if axis is not None:
                step = x.shape[dim] // sizes[axis]
                part = part.narrow(dim, c[axis] * step, step)
        out.append(part.to(dev).contiguous())
    return out


def gather(mesh: Mesh, shards: Sequence[torch.Tensor], spec: Spec,
           device: Optional[torch.device | str] = None) -> torch.Tensor:
    """The whole tensor from its shards (on the first shard's device by default)."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
    dev = mesh.devices[0] if device is None else torch.device(device)
    split = [(dim, axis) for dim, axis in enumerate(_full_spec(spec, shards[0].dim()))
             if axis is not None]

    def block(fixed: Dict[str, int], rest) -> torch.Tensor:
        if not rest:
            return shards[mesh.index(fixed)].to(dev)
        (dim, axis), rest = rest[0], rest[1:]
        return torch.cat([block({**fixed, axis: c}, rest)
                          for c in range(mesh.shape[axis])], dim=dim)
    return block({}, split)
