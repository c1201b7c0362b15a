"""Fully encrypted compare of two resident documents.

Set-up makes the configuration's keys with relinearization keys
(`FheRuntime.generate_keys`) and encrypts a pool of seeded quantized unit
vectors in both encodings, forward and reversed, resident on the card.
Each request is a pair (i, j) drawn from the seed: `FheRuntime.mul_ct`
of document i's forward and document j's reversed ciphertext with
relinearization, then `FheRuntime.mod_switch` and `FheRuntime.decrypt_dot`;
the answer is the decrypted score on the host.

The reference is the int64 dot product of the two vectors; every answer
of the window is checked.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.harness import Check, Tracer, sync
from portbench.reference import scores as ref
from portbench.traffic import generate as gen

from fhe_icp_tpu_torch.ops.runtime import FheRuntime


class State:
    pass


def setup(cell):
    cfg, mix, dev = cell.config, cell.mix, cell.device
    st = State()
    st.cell, st.d = cell, cfg["dim"]
    pool = mix["pool"]
    st.vecs = gen.quantized_unit(gen.torch_generator(cell.seed, "docs", dev),
                                 (pool, st.d), cfg["scale"], dev)
    st.rt = FheRuntime(cfg["preset"], rlk_levels=cfg["rlk_levels"], device=dev)
    st.rt.generate_keys(seed=gen.stream_seed(cell.seed, "keys"))
    enc_seed = gen.stream_seed(cell.seed, "encrypt")
    fwd, rev = [], []
    for i in range(0, pool, mix["enc_batch"]):
        part = st.vecs[i: i + mix["enc_batch"]]
        fwd.append(st.rt.encrypt_vector(part, seed=(enc_seed + 2 * i) % 2 ** 63))
        rev.append(st.rt.encrypt_vector(part, seed=(enc_seed + 2 * i + 1) % 2 ** 63, rev=True))
    st.fwd = dataclasses.replace(fwd[0], data=torch.cat([c.data for c in fwd]))
    st.rev = dataclasses.replace(rev[0], data=torch.cat([c.data for c in rev]))
    del fwd, rev
    st.vecs_host = st.vecs.cpu().numpy()
    st.rng = gen.numpy_rng(cell.seed, "warmup")
    quiet = Tracer(False, dev)
    for i in range(mix["warmup_requests"]):
        serve(st, request(st, i), quiet)
    st.rng = gen.numpy_rng(cell.seed, "pairs")
    sync(dev)
    return st


def request(st, i: int) -> tuple:
    return tuple(int(x) for x in gen.pairs(st.rng, len(st.vecs_host), 1)[0])


def serve(st, pair: tuple, tracer) -> int:
    i, j = pair
    a = dataclasses.replace(st.fwd, data=st.fwd.data[i])
    b = dataclasses.replace(st.rev, data=st.rev.data[j])
    with tracer.span("compare.mul_relin"):
        prod = st.rt.mul_ct(a, b, relinearize=True)
    with tracer.span("compare.decode"):
        return int(st.rt.decrypt_dot(st.rt.mod_switch(prod), st.d))


def counts(st, answers) -> dict:
    return {"compares": sum(1 for _, a in answers if a is not None)}


def release(st) -> None:
    st.rt = st.fwd = st.rev = st.vecs = None


def check(st, answers) -> list:
    """Every answer of the window against the int64 dot product of its pair."""
    wrong = 0
    for (i, j), got in answers:
        want = int(st.vecs_host[i].astype(np.int64) @ st.vecs_host[j].astype(np.int64))
        wrong += got != want
    return [Check("wrong_scores", wrong, 0)]


def control(st, pair: tuple) -> int:
    """The reference in the next lower precision: the vectors rounded to int8."""
    i, j = pair
    return ref.dot_int8(st.vecs_host[i], st.vecs_host[j])
