"""Encrypted top-k search over a per-document store sharded over the cell's cards.

Set-up makes one key set on the first card and gives its secret key to a
runtime on each card (`FheRuntime`).  Card c draws its own documents, seeded
quantized unit vectors from a stream named by c, encrypts them a chunk at a
time (`FheRuntime.encrypt_vector`) and writes each chunk's digit planes
(`fastdot.make_doc_operand`) into its slice of the card's shard of the
store's fastdot operand, allocated at once, so that no intermediate spans
the shard.  The cards take the chunks in turn, so that
they work at once.  The step of `parallel/search.make_sharded_fastdot_search`
over a mesh of the cell's cards is built once.

Each request is one query, on the host as a server receives it:
`fastdot.make_query_operand` on the first card, then the step, which scores
every card's shard on that card, gathers the scores on the first card and
ranks them.  The answer is the top-k values and global ids on the host.

The reference (`reference/exact_topk.py`) runs on the first card once the
store is released.  It checks the top-k of a seeded sample of the window's
queries, and every score of the window's first `score_sample` queries, which
the driver keeps on the first card as the step returns them: a shard that is
dead or out of place shows even where its scores reach no top-k.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import Check, Tracer, sync
from portbench.reference import exact_topk
from portbench.traffic import generate as gen

from fhe_icp_tpu_torch.ops import fastdot
from fhe_icp_tpu_torch.ops.cipher import KeySet, PublicKey, SecretKey
from fhe_icp_tpu_torch.ops.runtime import FheRuntime
from fhe_icp_tpu_torch.parallel import search
from fhe_icp_tpu_torch.parallel.mesh import make_mesh


class State:
    pass


def _keys_on(keys: KeySet, dev: torch.device) -> KeySet:
    sk, pk = keys.sk, keys.pk
    return KeySet(SecretKey(sk.s.to(dev), sk.s_ntt_mont.to(dev), sk.s2_ntt_mont.to(dev)),
                  PublicKey(pk.b_ntt.to(dev), pk.a_ntt.to(dev)))


def setup(cell):
    cfg, mix, devices = cell.config, cell.mix, cell.devices
    cards, per = cfg["cards"], cfg["docs_per_card"]
    if len(devices) != cards or cfg["store_docs"] != cards * per:
        raise ValueError(f"{cell.name}: a store of {cfg['store_docs']} documents in {cards} "
                         f"shards of {per}, on {len(devices)} cards")
    st = State()
    st.cell, st.d, st.k, st.scale = cell, cfg["dim"], mix["top_k"], cfg["scale"]
    st.n_docs = cfg["store_docs"]

    rt = FheRuntime(cfg["preset"], rlk_levels=[], device=cell.device)
    rt.generate_keys(seed=gen.stream_seed(cell.seed, "keys"))
    st.ctx, st.sk, st.level = rt.ctx, rt.keys.sk, rt.ctx.n_limbs
    if cfg["search_level"] != st.level:
        raise ValueError(f"{cell.name}: fastdot reads the store at its encryption level "
                         f"{st.level}, not {cfg['search_level']}")
    rts = [rt] + [FheRuntime(cfg["preset"], keys=_keys_on(rt.keys, d), rlk_levels=[], device=d)
                  for d in devices[1:]]
    docs = [gen.quantized_unit(gen.torch_generator(cell.seed, f"docs-{c}", d), (per, st.d),
                               st.scale, d) for c, d in enumerate(devices)]
    st.shards = [torch.empty((st.level, fastdot.N_DIGITS, per, 2 * st.ctx.n), dtype=torch.int8,
                             device=d) for d in devices]
    enc_seeds = [gen.stream_seed(cell.seed, f"encrypt-{c}") for c in range(cards)]
    chunk = mix["enc_batch"]
    for lo in range(0, per, chunk):
        for c, r in enumerate(rts):
            cts = r.encrypt_vector(docs[c][lo: lo + chunk], seed=(enc_seeds[c] + lo) % 2 ** 63)
            st.shards[c][:, :, lo: lo + chunk] = fastdot.make_doc_operand(
                r.ctx, cts.data, st.level).digits
    del cts, rts
    st.docs_host = np.concatenate([x.cpu().numpy() for x in docs])
    del docs
    st.docs8 = None

    st.mesh = make_mesh(cards, device=cell.device)
    if st.mesh.devices != devices:
        raise ValueError(f"{cell.name}: the mesh's cards {st.mesh.devices} are not {devices}")
    st.step = search.make_sharded_fastdot_search(st.ctx, st.mesh, top_k=st.k)
    # Each card's int8 product, (L, M, K, C): its 4 digit rows a document by
    # the query's 4 digit columns, over the 2N digits of both polynomials.
    st.mm_shapes = [(st.level, fastdot.N_DIGITS * per, 2 * st.ctx.n, fastdot.N_DIGITS)] * cards
    st.kept = {}
    st.qgen = gen.torch_generator(cell.seed, "queries", cell.device)
    quiet = Tracer(False, devices)
    for i in range(mix["warmup_requests"]):
        serve(st, request(st, i), quiet)
    st.kept = {}
    st.qgen = gen.torch_generator(cell.seed, "queries", cell.device)   # the window starts at 0
    sync(devices)
    return st


def request(st, i: int) -> tuple:
    """The i-th client query, on the host as the server receives it."""
    return i, gen.quantized_unit(st.qgen, (st.d,), st.scale, st.cell.device).cpu()


def serve(st, req: tuple, tracer):
    """One query: its operand on the first card, then every card's shard
    scored, the scores gathered and ranked on the first card."""
    i, q = req
    with tracer.span("fastdot.operand"):
        q_op = fastdot.make_query_operand(st.ctx, st.sk, q, st.d, st.level)
    with tracer.span("fastdot.shards"):
        scores, vals, idx = st.step(st.shards, q_op.digits)
        if i < st.cell.mix["score_sample"]:
            st.kept[i] = scores                  # on the first card; no copy, no wait
        answer = vals.cpu().numpy(), idx.cpu().numpy()
    if tracer.profiling == "device":
        tracer.launches.setdefault("fastdot_mm", []).extend(st.mm_shapes)
    return answer


def counts(st, answers) -> dict:
    done = sum(1 for _, a in answers if a is not None)
    return {"queries": done, "dot_products": done * st.n_docs}


def release(st) -> None:
    for name in ("shards", "step", "mesh", "ctx", "sk", "qgen"):
        setattr(st, name, None)


def check(st, answers) -> list:
    """On the first card: the top-k of a seeded sample of the window's queries,
    and every score of its first `score_sample` queries, against the exact
    reference."""
    dev, mix = st.cell.device, st.cell.mix
    n = min(len(answers), mix["check_sample"])
    pick = gen.numpy_rng(st.cell.seed, "check").choice(len(answers), n, replace=False)
    sample = [answers[j] for j in sorted(pick)]
    first = [((i, q), a) for (i, q), a in answers if i < mix["score_sample"]]

    def queries(pairs):
        return np.stack([q.numpy() for (_, q), _ in pairs]) if pairs else \
            np.zeros((0, st.d), dtype=np.int32)
    topk = exact_topk.wrong_topk(st.docs_host, queries(sample), [a for _, a in sample], st.k, dev)
    scores = exact_topk.wrong_scores(st.docs_host, queries(first),
                                     [st.kept.get(i) for (i, _), _ in first], dev)
    return [Check("wrong_topk_queries", topk, 0), Check("wrong_scores", scores, 0)]


def control(st, req: tuple):
    """The reference in the next lower precision: documents and query rounded
    to int8 (scale/8), their top-k, the values scaled back by 8^2."""
    _, q = req
    if st.docs8 is None:
        st.docs8 = torch.round(torch.from_numpy(st.docs_host) / 8).to(torch.int8)
    vals, ids = exact_topk.topk(st.docs8, torch.round(q / 8)[None], st.k, st.cell.device)
    return (vals[:, 0] * 64).cpu().numpy(), ids[:, 0].cpu().numpy()
