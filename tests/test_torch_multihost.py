"""The port's multi-host search against the JAX package's `parallel/multihost.py`.

Everything the JAX package's tests check (partitioning, local and merged
top-k, the single-process pass-through, host-shard searches of two and
three hosts on one- and two-shard meshes against the int64 oracle), each
also held equal to the JAX function on the same inputs, then two real worker processes (`python -m
fhe_icp_tpu_torch.parallel.multihost`, gloo on 127.0.0.1, on the CPU)
that must both print the exact global top-k the JAX package's merge
gives.  Tolerance: none.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_icp_tpu.ops.context import CryptoContext as JaxContext
from fhe_icp_tpu.ops.params import get_params as jax_params
from fhe_icp_tpu.parallel import mesh as jmesh
from fhe_icp_tpu.parallel import multihost as jmh
from fhe_icp_tpu.parallel import search as jsearch
from fhe_icp_tpu_torch.ops import pack
from fhe_icp_tpu_torch.ops.runtime import FheRuntime
from fhe_icp_tpu_torch.parallel import multihost as mh
from fhe_icp_tpu_torch.parallel.mesh import PACKED_OPERAND_SPEC, make_mesh, shard

ROOT = pathlib.Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(41)


@pytest.mark.parametrize("n_groups,n_hosts", [(10, 3), (3128, 2), (7, 7), (5, 8)])
def test_partition_groups_matches_jax(n_groups, n_hosts):
    shards = mh.partition_groups(n_groups, n_hosts)
    assert [(s.host, s.start, s.stop) for s in shards] == \
        [(s.host, s.start, s.stop) for s in jmh.partition_groups(n_groups, n_hosts)]
    assert shards[0].start == 0 and shards[-1].stop == n_groups
    assert all(a.stop == b.start for a, b in zip(shards, shards[1:]))
    assert max(s.groups for s in shards) - min(s.groups for s in shards) <= 1
    if (n_groups, n_hosts) == (10, 3):
        assert [s.groups for s in shards] == [4, 3, 3]
    digits = torch.arange(2 * 4 * n_groups * 3).reshape(2, 4 * n_groups, 3)
    for s, j in zip(shards, jmh.partition_groups(n_groups, n_hosts)):
        np.testing.assert_array_equal(mh.shard_slice(digits, s).numpy(),
                                      np.asarray(jmh.shard_slice(jnp.asarray(digits.numpy()), j)))


def test_local_and_merge_topk_match_jax():
    scores = RNG.integers(-10**6, 10**6, size=1000).astype(np.int64)
    scores[::97] = 5                                    # ties across hosts
    k = 7
    per_host, jper_host, off = [], [], 0
    for p in np.array_split(scores, 3):
        per_host.append(mh.local_topk(p, k, index_offset=off))
        jper_host.append(jmh.local_topk(p, k, index_offset=off))
        off += p.shape[0]
    for (v, i), (jv, ji) in zip(per_host, jper_host):
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(i, ji)
    vals, idx = mh.merge_topk(per_host, k)
    jvals, jidx = jmh.merge_topk(jper_host, k)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(idx, jidx)
    order = np.argsort(-scores, kind="stable")[:k]
    assert (vals == scores[order]).all() and (scores[idx] == scores[order]).all()


def test_global_topk_single_process_passthrough():
    vals = np.asarray([9, 5, 1], dtype=np.int64)
    idx = np.asarray([4, 0, 2], dtype=np.int64)
    v, i = mh.global_topk(vals, idx, 2)
    assert (v == vals[:2]).all() and (i == idx[:2]).all()
    assert mh.initialize() == 0 and mh.initialize(num_processes=1) == 0


@pytest.fixture(scope="module")
def packed_store():
    """29 test-512 documents (a ragged tail: 8 groups of 4 slots) and a query,
    packed as the port's operands, with the clear int64 scores."""
    rt = FheRuntime("test-512", rlk_levels=[], device="cpu")
    rt.generate_keys(seed=3)
    ctx, sk = rt.ctx, rt.keys.sk
    d, n_docs = 128, 29
    rng = np.random.default_rng(43)
    docs = rng.integers(-1000, 1001, size=(n_docs, d)).astype(np.int32)
    query = rng.integers(-1000, 1001, size=(d,)).astype(np.int32)
    cts = rt.encrypt_vector(docs, seed=5)
    packed = pack.pack_ciphertexts(ctx, cts.data, d, cts.level)
    dop = pack.make_packed_doc_operand(ctx, packed, cts.level)
    qop = pack.make_packed_query_operand(ctx, sk, torch.from_numpy(query), d, cts.level)
    truth = docs.astype(np.int64) @ query.astype(np.int64)
    return ctx, d, dop, qop, truth


@pytest.mark.parametrize("n_hosts,n_dp,k", [(2, 1, 5), (2, 2, 5), (3, 1, 8)])
def test_search_host_shard_matches_oracle_and_jax(packed_store, n_hosts, n_dp, k):
    """Simulated hosts, each an n_dp-shard mesh over its slice; the JAX
    package's search_host_shard on the same digits gives the same values and
    ids.  With 3 hosts the last holds 5 real documents, fewer than k = 8."""
    ctx, d, dop, qop, truth = packed_store
    assert len(np.unique(truth)) == len(truth)          # no ties: ids are comparable
    n_docs = len(truth)
    slots = pack.slots_per_ct(ctx.n, d)                 # 4
    groups = dop.digits.shape[1] // 4                   # 8

    jctx = JaxContext(jax_params("test-512"))
    jm = jmesh.make_mesh(n_dp, shape=(n_dp, 1))
    mesh = make_mesh(n_dp, (n_dp, 1), device="cpu")
    per_host, jper_host = [], []
    for sh in mh.partition_groups(groups, n_hosts):
        local = mh.shard_slice(dop.digits, sh)
        per_host.append(mh.search_host_shard(ctx, mesh, shard(mesh, local, PACKED_OPERAND_SPEC),
                                             qop.digits, d, sh, slots, n_docs, top_k=k))
        jlocal = jnp.asarray(local.numpy())
        jper_host.append(jmh.search_host_shard(
            jctx, jm, jax.device_put(jlocal, jsearch.packed_operand_sharding(jm)),
            jnp.asarray(qop.digits.numpy()), d, jmh.HostShard(sh.host, sh.start, sh.stop),
            slots, n_docs, top_k=k))
    for (v, i), (jv, ji) in zip(per_host, jper_host):
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(i, ji)
    assert len(per_host[-1][0]) == min(k, n_docs - sh.start * slots)   # no padding ids
    vals, idx = mh.merge_topk(per_host, k)
    order = np.argsort(-truth, kind="stable")[:k]
    assert (vals == truth[order]).all() and (truth[idx] == truth[order]).all()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_global_topk(tmp_path):
    """Two worker processes joined over gloo: each encrypts and searches its
    half of a test-512 store on the CPU; both print the exact global top-k,
    equal to the JAX package's merge of the clear scores' local top-k."""
    d, k, n_docs = 128, 5, 29
    rng = np.random.default_rng(7)
    docs = rng.integers(-1000, 1001, size=(n_docs, d)).astype(np.int32)
    queries = rng.integers(-1000, 1001, size=(2, d)).astype(np.int32)
    store = tmp_path / "store.npz"
    np.savez(store, docs=docs, queries=queries)
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fhe_icp_tpu_torch.parallel.multihost", coordinator, "2",
         str(pid), "--store", str(store), "--preset", "test-512", "--top-k", str(k),
         "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=60), p.returncode))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the workers did not finish within 60 s")
    results = {}
    for (out, err), rc in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert rc == 0 and line, f"worker failed (rc={rc}):\n{out}\n{err[-2000:]}"
        rec = json.loads(line[-1][len("RESULT "):])
        results[rec["pid"]] = rec
    assert set(results) == {0, 1}
    assert results[0]["shard"] == [0, 4] and results[1]["shard"] == [4, 8]
    slots = 512 // d
    for qi, q in enumerate(queries):
        truth = docs.astype(np.int64) @ q.astype(np.int64)
        per_host = [jmh.local_topk(truth[s.start * slots: min(s.stop * slots, n_docs)], k,
                                   index_offset=s.start * slots)
                    for s in jmh.partition_groups(8, 2)]
        jvals, jidx = jmh.merge_topk(per_host, k)
        for rec in results.values():
            assert rec["ok"] and rec["process_count"] == 2
            assert rec["queries"][qi] == {"vals": jvals.tolist(), "idx": jidx.tolist()}
