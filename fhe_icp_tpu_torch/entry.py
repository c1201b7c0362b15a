"""Entry points: one encrypted matvec step, and a dry run of the sharded programs.

`entry()` returns the encrypted batched dot product (matvec) with the exact
single-coefficient score decode, and example arguments for it.

`dryrun_multichip(n)` runs three sharded programs over a mesh of n logical
shards (`parallel/mesh.py`) on tiny shapes, each gated by an exact oracle:

1. the NTT-domain encrypted search (matvec, limbs gathered for the decode,
   top-k) on a (dp, tp) mesh;
2. the slot-packed search with its groups sharded over dp (kernel K1);
3. the four-step ring-sharded NTT forward and inverse over an `sp` mesh
   (kernels K2 and K3), which must give back its input.

The counterparts of the JAX package's `__graft_entry__.py`.  Both run on
the card unless `device` names the CPU.

    python -m fhe_icp_tpu_torch.entry
"""

from __future__ import annotations

import numpy as np
import torch

from .devices import target
from .ops import dot, pack
from .ops.cipher import Ciphertext
from .ops.params import CryptoParams
from .ops.runtime import FheRuntime
from .parallel.mesh import (BATCH_SPEC, PACKED_OPERAND_SPEC, SP_AXIS, gather,
                            make_mesh, shard)
from .parallel.ntt_dist import ROW_SPEC, build_dist_plan, make_dist_ntt
from .parallel.search import make_sharded_packed_search, make_sharded_search

DIM = 128


def _small_runtime(device) -> FheRuntime:
    params = CryptoParams("entry-512", n=512, n_limbs=2, allow_insecure=True)
    rt = FheRuntime(params, device=device)
    rt.generate_keys(seed=0)
    return rt


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): fn(cts_data, query) -> (B,) int32 exact scores."""
    rt = _small_runtime(target(device, "entry"))
    ctx, sk = rt.ctx, rt.keys.sk
    rng = np.random.default_rng(0)
    docs = rng.integers(-1000, 1001, size=(4, DIM)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(DIM,)).astype(np.int32)
    cts = rt.encrypt_vector(docs, seed=1)

    def fn(cts_data: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        prod = dot.matvec_ct_pt(ctx, Ciphertext(cts_data, ctx.n_limbs), q)
        return dot.decrypt_dot(ctx, sk, prod, DIM)

    return fn, (cts.data, torch.from_numpy(query).to(rt.device))


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda") -> None:
    """The three sharded programs over n_devices logical shards; raises on a mismatch."""
    device = target(device, "dryrun_multichip")
    rt = _small_runtime(device)
    ctx, sk = rt.ctx, rt.keys.sk
    # dp x tp: give tp the limb axis when it divides evenly.
    tp = 2 if (n_devices % 2 == 0 and ctx.n_limbs % 2 == 0) else 1
    dp = n_devices // tp
    mesh = make_mesh(n_devices, (dp, tp), device)
    batch = 2 * dp

    rng = np.random.default_rng(0)
    docs = rng.integers(-1000, 1001, size=(batch, DIM)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(DIM,)).astype(np.int32)
    cts = rt.encrypt_vector(docs, seed=1)
    want = docs.astype(np.int64) @ query.astype(np.int64)
    top2 = np.sort(want)[::-1][:2]

    # 1. NTT-domain sharded search.
    step = make_sharded_search(ctx, sk, mesh, d=DIM, level=ctx.n_limbs, top_k=2)
    scores, vals, _ = step(shard(mesh, cts.data, BATCH_SPEC), torch.from_numpy(query))
    _check((scores.cpu().numpy().astype(np.int64) == want).all(),
           "sharded encrypted matvec mismatch")
    _check((vals.cpu().numpy().astype(np.int64) == top2).all(), "sharded top-k mismatch")

    # 2. Slot-packed search: S = N/d docs per ciphertext, one group per dp shard.
    slots = pack.slots_per_ct(ctx.n, DIM)
    pdocs = rng.integers(-1000, 1001, size=(dp * slots, DIM)).astype(np.int32)
    polys = pack.encode_packed(torch.from_numpy(pdocs.reshape(dp, slots, DIM)), ctx.n)
    pct = rt.encrypt(polys, seed=2)
    doc_op = pack.make_packed_doc_operand(ctx, pct.data, pct.level)
    q_op = pack.make_packed_query_operand(ctx, sk, torch.from_numpy(query), DIM, pct.level)
    pstep = make_sharded_packed_search(ctx, mesh, d=DIM, top_k=2)
    flat, pvals, _ = pstep(shard(mesh, doc_op.digits, PACKED_OPERAND_SPEC), q_op.digits)
    pwant = pdocs.astype(np.int64) @ query.astype(np.int64)
    _check((flat.cpu().numpy().astype(np.int64) == pwant).all(),
           "sharded packed matvec mismatch")
    _check((pvals.cpu().numpy().astype(np.int64) == np.sort(pwant)[::-1][:2]).all(),
           "sharded packed top-k mismatch")

    # 3. Distributed-NTT round trip over the ring dimension (sp axis).
    sp_mesh = make_mesh(n_devices, (n_devices,), device, axes=(SP_AXIS,))
    n1 = max(n_devices, 1 << ((ctx.n.bit_length() - 1) // 2))
    plan = build_dist_plan(ctx.n, ctx.primes[:2], n1=n1, device=device)
    fwd, inv = make_dist_ntt(plan, sp_mesh)
    x = rng.integers(0, np.asarray(ctx.primes[:2], np.int64)[:, None, None],
                     size=(2, plan.n1, plan.n2)).astype(np.uint32)
    back = gather(sp_mesh, inv(fwd(shard(sp_mesh, torch.from_numpy(x), ROW_SPEC))), ROW_SPEC)
    _check((back.cpu().numpy() == x).all(), "distributed NTT fwd/inv round trip mismatch")


if __name__ == "__main__":
    fn, args = entry()
    print("entry:", fn(*args).cpu().numpy()[:4])
    dryrun_multichip(8)
    print("dryrun_multichip(8): OK")
