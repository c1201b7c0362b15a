"""Encrypted top-k search over a packed store resident on the card.

Set-up encrypts the configuration's store of seeded quantized unit
vectors (`FheRuntime.encrypt_vector`, in batches), packs it
(`pack.pack_ciphertexts`), switches it to the search level
(`arith.mod_switch_to`) and builds the int8 operand
(`pack.make_packed_doc_operand`), cut into host shards as the port's
search server does (`parallel/multihost.main`).  Each request is one query
through that server's path: `pack.make_packed_query_operand`, then
`multihost.search_host_shard` on a one-card mesh holding this host's shard
of `partition_groups`.  The answer is the top-k values and ids on the host.

The reference is the int64 product of the same documents and queries
(`reference/scores.py`); it checks a seeded sample of the window's queries.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import Check, Tracer, sync
from portbench.reference import scores as ref
from portbench.traffic import generate as gen

from fhe_icp_tpu_torch.ops import arith, pack
from fhe_icp_tpu_torch.ops.cipher import Ciphertext
from fhe_icp_tpu_torch.ops.runtime import FheRuntime
from fhe_icp_tpu_torch.parallel import multihost
from fhe_icp_tpu_torch.parallel.mesh import PACKED_OPERAND_SPEC, make_mesh, shard


class State:
    pass


def setup(cell):
    cfg, mix, dev = cell.config, cell.mix, cell.device
    st = State()
    st.cell, st.d, st.k = cell, cfg["dim"], mix["top_k"]
    st.n_docs, st.scale = cfg["store_docs"], cfg["scale"]
    st.docs = gen.quantized_unit(gen.torch_generator(cell.seed, "docs", dev),
                                 (st.n_docs, st.d), st.scale, dev)
    st.qgen = gen.torch_generator(cell.seed, "queries", dev)

    rt = FheRuntime(cfg["preset"], rlk_levels=[], device=dev)
    rt.generate_keys(seed=gen.stream_seed(cell.seed, "keys"))
    ctx = rt.ctx
    st.ctx, st.sk = ctx, rt.keys.sk
    cts = torch.empty((st.n_docs, 2, ctx.n_limbs, ctx.n), dtype=torch.uint32, device=dev)
    batch = mix["enc_batch"]
    enc_seed = gen.stream_seed(cell.seed, "encrypt")
    for i in range(0, st.n_docs, batch):
        cts[i: i + batch] = rt.encrypt_vector(st.docs[i: i + batch],
                                              seed=(enc_seed + i) % 2 ** 63).data
    packed = pack.pack_ciphertexts(ctx, cts, st.d, ctx.n_limbs)
    del cts
    ct = arith.mod_switch_to(ctx, Ciphertext(packed, ctx.n_limbs), cfg["search_level"])
    del packed
    st.level = ct.level
    st.slots = pack.slots_per_ct(ctx.n, st.d)
    groups = -(-st.n_docs // st.slots)
    st.shard = multihost.partition_groups(groups, cfg["hosts"])[0]
    st.mesh = make_mesh(1, (1, 1), dev)
    op = pack.make_packed_doc_operand(ctx, ct.data, ct.level)
    del ct
    st.doc_shards = shard(st.mesh, multihost.shard_slice(op.digits, st.shard),
                          PACKED_OPERAND_SPEC)
    del op
    st.docs_host = st.docs.cpu().numpy()
    quiet = Tracer(False, dev)
    for i in range(mix["warmup_requests"]):
        serve(st, request(st, i), quiet)
    st.qgen = gen.torch_generator(cell.seed, "queries", dev)   # the window starts at query 0
    sync(dev)
    return st


def request(st, i: int) -> torch.Tensor:
    """A client's query, on the host as the server receives it."""
    return gen.quantized_unit(st.qgen, (st.d,), st.scale, st.cell.device).cpu()


def serve(st, q: torch.Tensor, tracer):
    """One query: the query operand, then this host's shard searched and merged."""
    with tracer.span("search.operand"):
        q_op = pack.make_packed_query_operand(st.ctx, st.sk, q, st.d, st.level)
    with tracer.span("search.shard"):
        vals, idx = multihost.search_host_shard(st.ctx, st.mesh, st.doc_shards, q_op.digits,
                                                st.d, st.shard, st.slots, st.n_docs,
                                                top_k=st.k)
    return np.asarray(vals), np.asarray(idx)


def counts(st, answers) -> dict:
    done = sum(1 for _, a in answers if a is not None)
    return {"queries": done, "dot_products": done * st.n_docs}


def release(st) -> None:
    for name in ("doc_shards", "mesh", "ctx", "sk", "docs", "qgen"):
        setattr(st, name, None)


def _sample(st, answers) -> list:
    n = min(len(answers), st.cell.mix["check_sample"])
    pick = gen.numpy_rng(st.cell.seed, "check").choice(len(answers), n, replace=False)
    return [answers[i] for i in sorted(pick)]


def check(st, answers) -> list:
    """Top-k values and ids of a seeded sample of the window's queries against
    the int64 reference: a query is wrong if its values are not the reference's
    top-k, or an id does not point at its value, or ids repeat."""
    sample = _sample(st, answers)
    queries = np.stack([q.numpy() for q, _ in sample]) if sample else np.zeros((0, st.d))
    got = [a for _, a in sample]
    return [Check("wrong_topk_queries", ref.wrong_topk(st.docs_host, queries, got, st.k), 0)]


def control(st, q: torch.Tensor):
    """The reference in the next lower precision: documents and query rounded
    to int8 (scale/8), their top-k."""
    return ref.topk_int8(st.docs_host, q.numpy(), st.k)
