"""Multi-host search: a packed store partitioned over processes, an O(k) merge.

The counterpart of the JAX package's `parallel/multihost.py`.  Each
process (host) owns a contiguous slice of the packed ciphertext groups and
scores and ranks it on its own card with the sharded packed search (kernel
K1, `search.make_sharded_packed_search`); only each one's k winners reach
the host and cross processes, and the exact merge runs on the host:

* `partition_groups`, `shard_slice`, `local_topk`, `merge_topk` — numpy,
  as in the JAX package;
* `initialize` joins `torch.distributed` with the gloo backend (the merge
  moves 2k integers a process over TCP, so no NCCL is needed);
* `global_topk` all-gathers each process's k values and indices and merges
  them; without a process group it passes the local result through.

Run as a program, this module is one worker of a multi-process search
(`python -m fhe_icp_tpu_torch.parallel.multihost --help`): it encrypts its
share of a store, searches it, merges with the other workers and checks
the merged top-k against the clear oracle.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from .search import make_sharded_packed_search

logger = logging.getLogger(__name__)

ENC_BATCH = 8192               # the worker's documents per encryption


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> int:
    """Join the process group (gloo over TCP). Returns this process's rank.

    Returns 0 and does nothing for one process.  `coordinator` is the
    "host:port" of rank 0; without it the standard MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK environment variables are read.
    """
    if num_processes == 1 or (num_processes is None and coordinator is None):
        return 0
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    logger.info("joined the process group: rank %d of %d", dist.get_rank(),
                dist.get_world_size())
    return dist.get_rank()


@dataclass(frozen=True)
class HostShard:
    """The contiguous slice of packed ciphertext groups a host owns."""

    host: int
    start: int                 # first packed group index (inclusive)
    stop: int                  # last packed group index (exclusive)

    @property
    def groups(self) -> int:
        return self.stop - self.start


def partition_groups(n_groups: int, n_hosts: int) -> List[HostShard]:
    """Contiguous, balanced partition of packed groups across hosts.

    Contiguity keeps each host's arena slice one range; balance keeps the
    hosts' scoring times even, so that the merge waits on no straggler.
    """
    base, extra = divmod(n_groups, n_hosts)
    shards, start = [], 0
    for h in range(n_hosts):
        size = base + (1 if h < extra else 0)
        shards.append(HostShard(h, start, start + size))
        start += size
    return shards


def shard_slice(packed_digits, shard: HostShard):
    """This host's slice of a PackedDocOperand's (L, G*4, 2N) digits."""
    return packed_digits[:, 4 * shard.start: 4 * shard.stop]


def local_topk(scores: np.ndarray, k: int,
               index_offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k of this host's scores -> (values desc, GLOBAL doc indices)."""
    k = min(k, scores.shape[0])
    part = np.argpartition(-scores, k - 1)[:k]
    order = part[np.argsort(-scores[part], kind="stable")]
    return scores[order], order + index_offset


def merge_topk(per_host: Sequence[Tuple[np.ndarray, np.ndarray]],
               k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-host (values, indices) top-k lists into the global top-k.

    Input lists are descending; the output is the exact global top-k.  The
    data crossing hosts is k values and k indices a host, whatever the
    store's size.
    """
    vals = np.concatenate([v for v, _ in per_host])
    idxs = np.concatenate([i for _, i in per_host])
    order = np.argsort(-vals, kind="stable")[:k]
    return vals[order], idxs[order]


def global_topk(local_vals: np.ndarray, local_idx: np.ndarray,
                k: int) -> Tuple[np.ndarray, np.ndarray]:
    """All-gather each process's local top-k and merge.

    Without a process group of more than one process: the local result.
    Otherwise one all-gather of k values and k indices a process (CPU
    tensors over gloo; a process with fewer than k pads with index -1,
    left out of the merge), then the exact merge on every process.
    """
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return local_vals[:k], local_idx[:k]
    pair = torch.full((2, k), -1, dtype=torch.int64)
    n = min(k, len(local_vals))
    pair[0, :n] = torch.from_numpy(np.asarray(local_vals[:n], dtype=np.int64))
    pair[1, :n] = torch.from_numpy(np.asarray(local_idx[:n], dtype=np.int64))
    gathered = [torch.empty_like(pair) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, pair)
    per_host = [(g[0][g[1] >= 0].numpy(), g[1][g[1] >= 0].numpy()) for g in gathered]
    return merge_topk(per_host, k)


def search_host_shard(ctx, mesh, doc_digits, query_digits, d: int, shard: HostShard,
                      slots: int, n_docs_global: int, top_k: int = 5):
    """Score one host's shard and return the merged global top-k.

    doc_digits: this host's packed operand slice, cut over its mesh
    (`mesh.shard(mesh, shard_slice(...), PACKED_OPERAND_SPEC)`); the
    returned indices are GLOBAL document ids (the shard's offset applied,
    padding slots left out).  The shard is ranked once, on its card, by the
    step's own top-k, and only its <= k values and ids reach the host.  Among
    equal scores the id returned is `torch.topk`'s choice, not the lowest.
    """
    offset = shard.start * slots
    valid = max(0, n_docs_global - offset)
    step = make_sharded_packed_search(ctx, mesh, d=d, top_k=top_k, n_docs=valid)
    _, vals, idx = step(doc_digits, query_digits)
    with span("search.to_host"):
        vals, idx = torch.stack([vals.long(), idx.long()]).cpu().numpy()
        real = idx < valid      # a host with fewer than k documents ranks padding too
    with span("search.rank"):
        return global_topk(vals[real], idx[real] + offset, top_k)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """One worker: join the group, encrypt this host's share of the store
    (keys from seed 0, the same in every worker), search it with each query,
    merge, and check the merged top-k against the clear oracle.

    Prints one line `RESULT <json>`; exits 0 when every query's merged
    top-k values and indices are the oracle's.
    """
    from .. import kernels
    from ..ops import pack
    from ..ops.runtime import FheRuntime
    from .mesh import PACKED_OPERAND_SPEC, make_mesh, shard

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("coordinator", help="host:port of rank 0")
    ap.add_argument("num_processes", type=int)
    ap.add_argument("process_id", type=int)
    ap.add_argument("--store", required=True,
                    help="npz with docs (n, d) and queries (q, d), int32")
    ap.add_argument("--preset", default="pairwise-4096")
    ap.add_argument("--pad-groups", type=int, default=1,
                    help="round the group count up to a multiple of this")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rank = initialize(args.coordinator, args.num_processes, args.process_id)
    z = np.load(args.store)
    docs, queries = z["docs"], z["queries"]
    n, d = docs.shape
    t0 = time.perf_counter()
    rt = FheRuntime(args.preset, rlk_levels=[], device=args.device)
    rt.generate_keys(seed=0)
    ctx, sk = rt.ctx, rt.keys.sk
    slots = pack.slots_per_ct(ctx.n, d)
    groups = -(-n // slots)
    groups += -groups % args.pad_groups
    mine = partition_groups(groups, args.num_processes)[rank]
    # This host's documents, zero vectors past the store's end (they score 0).
    local = np.zeros((mine.groups * slots, d), dtype=np.int32)
    real = docs[mine.start * slots: mine.stop * slots]
    local[:len(real)] = real
    cts = torch.empty((len(local), 2, ctx.n_limbs, ctx.n), dtype=torch.uint32,
                      device=ctx.device)
    for i in range(0, len(local), ENC_BATCH):
        cts[i: i + ENC_BATCH] = rt.encrypt_vector(
            local[i: i + ENC_BATCH], seed=1 + mine.start * slots + i).data
    packed = pack.pack_ciphertexts(ctx, cts, d, ctx.n_limbs)
    del cts
    mesh = make_mesh(1, (1, 1), args.device)
    doc_shards = shard(mesh, pack.make_packed_doc_operand(ctx, packed, ctx.n_limbs).digits,
                       PACKED_OPERAND_SPEC)
    t_build = time.perf_counter() - t0

    truth_all = docs.astype(np.int64) @ queries.astype(np.int64).T
    ok, results, lat = True, [], []
    for qi, q in enumerate(queries):
        t0 = time.perf_counter()
        q_op = pack.make_packed_query_operand(ctx, sk, torch.from_numpy(q), d, ctx.n_limbs)
        vals, idx = search_host_shard(ctx, mesh, doc_shards, q_op.digits, d, mine, slots, n,
                                      top_k=args.top_k)
        lat.append(time.perf_counter() - t0)
        truth = truth_all[:, qi]
        order = np.argsort(-truth, kind="stable")[:args.top_k]
        ok &= bool(np.array_equal(vals, truth[order]) and np.array_equal(truth[idx], vals))
        results.append({"vals": vals.tolist(), "idx": idx.tolist()})
    print("RESULT " + json.dumps({
        "pid": rank, "process_count": args.num_processes, "ok": ok,
        "shard": [mine.start, mine.stop], "queries": results,
        "build_s": t_build, "query_ms": [t * 1e3 for t in lat],
        "launches": dict(kernels.launches)}), flush=True)
    if args.num_processes > 1:
        torch.distributed.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
