"""Pipeline parallelism: the packed scoring chain staged over two shards.

A GPipe pipeline of microbatches over a `pp` mesh of two shards, the
counterpart of the JAX package's `parallel/pipeline.py`:

  stage 0 (shard 0's device, its own CUDA stream)   the int8 digit product
          of microbatch t against the query (`pack_cuda.int_mm`)
  stage 1 (shard 1's device, its own CUDA stream)   the separable digit fold
          of microbatch t-1 (`pack.fold_separable`)

At step t both stages work: stage 0 on microbatch t while stage 1 folds
t-1.  The partials pass from stage 0 to stage 1 behind a CUDA event (and
by `.to(device)` when the shards sit on two cards); the bubble is the
usual (P-1)/(M+P-1).  One partials buffer is in flight per stage: the whole
(L, R, 4S) partials tensor never exists, which is pipelining's memory
argument for this chain.  For this chain of two steps data parallelism
over the documents does more (no shard waits on another), so the search
paths shard over `dp`; this module covers the strategy with an exact
implementation.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..ops import pack
from ..ops.cipher import rns_decode_centered
from ..ops.context import CryptoContext
from ..ops.fastdot import N_DIGITS
from ..ops.pack_cuda import int_mm
from .mesh import Mesh, make_mesh

PP_AXIS = "pp"
N_STAGES = 2


def make_pp_mesh(n_devices: int = N_STAGES, device: torch.device | str = "cuda") -> Mesh:
    """A 1-D pipeline mesh of n_devices shards, on the card by default (both
    shards on one card when there is one)."""
    return make_mesh(n_devices, (n_devices,), device, axes=(PP_AXIS,))


class _Stage:
    """One stage's device and, on a card, a CUDA stream of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def run(self):
        """Queue the work of the `with` block on this stage's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def record(self):
        """An event after the work queued so far on this stage (None on the CPU)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def wait(self, event) -> None:
        if event is not None:
            self.stream.wait_event(event)


def make_pipelined_scores(ctx: CryptoContext, mesh: Mesh, level: int, slots: int,
                          n_micro: int) -> Callable[..., torch.Tensor]:
    """The two-stage pipelined packed scoring step.

    Returns fn(a_digits (L, R, 2N) int8, v_digits (L, 2N, 4S) int8,
    pt_corr=1) -> (G, S) int32 exact scores, with the R = 4G rows cut into
    `n_micro` equal microbatches.  Bit-identical to `pack.packed_scores`.
    The result lies on shard 1's device.
    """
    n_pp = mesh.shape[PP_AXIS]
    if n_pp != N_STAGES:
        raise ValueError(f"this pipeline has exactly {N_STAGES} stages, the mesh {n_pp}")
    stages = [_Stage(mesh.devices[mesh.index({PP_AXIS: i})]) for i in range(N_STAGES)]
    # The context's tables carry its card's index ("cuda" names the current card).
    fold_ctx = (ctx if stages[1].device == ctx.p.device
                else CryptoContext(ctx.params, stages[1].device))
    l, s = level, slots

    def fn(a_digits: torch.Tensor, v_digits: torch.Tensor, pt_corr: int = 1) -> torch.Tensor:
        rows = a_digits.shape[1]
        if rows % (N_DIGITS * n_micro):
            raise ValueError(f"{rows} rows do not split into {n_micro} microbatches of "
                             f"whole groups")
        rbm = rows // n_micro                          # rows per microbatch
        s0, s1 = stages
        a, v = a_digits.to(s0.device), v_digits.to(s0.device)
        s0.wait(_current_event(a.device))              # the operands are ready
        _keep(a, s0)
        _keep(v, s0)
        outs, handed = [], None                        # handed: (partials, event)
        for t in range(n_micro + 1):
            fresh = None
            if t < n_micro:                            # stage 0: microbatch t
                with s0.run():
                    part = int_mm(a[:, t * rbm:(t + 1) * rbm], v)
                    # The hand-over: on one card the same tensor; across two a
                    # copy, which runs on this (the source's) stream.
                    buf = part.to(s1.device, non_blocking=True)
                _keep(buf, s1)
                fresh = (buf, s0.record())
            if handed is not None:                     # stage 1: microbatch t - 1
                buf, ev = handed
                s1.wait(ev)
                with s1.run():
                    outs.append(pack.fold_separable(fold_ctx, buf, l, s))
            handed = fresh
        done = s1.record()
        if done is not None:
            torch.cuda.current_stream(s1.device).wait_event(done)
            for out in outs:
                out.record_stream(torch.cuda.current_stream(s1.device))
        acc = torch.cat(outs, dim=1)                   # (L, G, S)
        return rns_decode_centered(fold_ctx, acc.movedim(0, -1)[..., None], l, pt_corr)[..., 0]

    return fn


def _current_event(device: torch.device):
    """An event after the work queued so far on the device's current stream."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _keep(x: torch.Tensor, stage: _Stage) -> None:
    """Mark x (on the stage's device) as used on the stage's stream, so that
    its memory is not handed out again before that stream's work on it is
    done."""
    if stage.stream is not None:
        x.record_stream(stage.stream)
