"""Drive the PyTorch/CUDA port's encrypted search paths on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-times [DIR]

The second form times K2 alone at the paths' shapes (`k2_times`), one JSON
line per entry and shape, with the package in DIR: an earlier tree of the
port unpacked there (`git archive <commit> | tar -x -C DIR`) runs its own
K2 at the same shapes, so that two trees compare on one card in one run.

Phases (any failure raises and the exit code is not 0):

1. Device and build: needs CUDA, prints the card's name and power limit,
   `utils/debug.check_environment()` and the card's data-sheet peaks,
   builds the kernels of `fhe_icp_tpu_torch/csrc/` with nvcc.
2. Each kernel against its plain PyTorch version on the card, bit-exact:
   the NTT (all four entries: forward, inverse, and their cyclic forms)
   at N = 16 .. 16384 with 1, 2 and 12 rows and limbs, at the batches
   where `ntt_cuda.launch_shape` changes regime (clusters, R rows a
   block, a ragged group of R), at the main path's (8192, 2, 4096) and (2,
   4096), ring-16384's (12, 16384) and the four-step NTT's (16, 12, 16 ..
   256), in every launch the kernels take (`launch_candidates`) at N =
   512, 4096, 16384, and on a view that starts one word into its storage
   (the C entry refuses it, the wrapper realigns it); the scoring kernel
   at the slice shape (2048 groups), a ragged store (3125), one shard of
   the sharded store (391 groups, K split), ragged row tiles (1 and 33
   groups), the test-512 shape (4S = 16, 2N = 1024) and ring-16384's at d
   = 128 and 64 (4S = 512 and 1024, in column tiles); the all-to-all at 2,
   4 and 8 shards, at both exchanges of the ring-16384 four-step NTT and
   at a chunk that is not a multiple of 16 B.
3. The main path at full width, preset pairwise-4096 (N = 4096, 2 limbs):
   keys from seed 0, 65,536 per-document quantized unit vectors
   (d = 128, scale 1000) encrypted in batches of 8192, packed into 2048
   groups, switched to 2 limbs, turned into the int8 doc operand; then 8
   queries through the query operand, the scoring kernel and top-10.
   Every score must equal `docs @ query` in int64 and every top-10 must
   hold the oracle's top-10 scores; a few per-document ciphertexts are
   decrypted in full and by single coefficient.  The kernels' launch
   counts are zeroed just before this phase and must all have risen.
   Then where a query's time goes: host time per stage and, from
   torch.profiler, device time by kernel and the card's idle share.
4. The multi-shard path at full width, on a mesh of 8 logical shards
   (all on one card when it has one): a 100,000-document pairwise-4096
   store packed into 3125 groups padded to 3128, sharded over dp and
   searched by 8 queries (`make_sharded_packed_search`, top-10, n_docs
   masking), every score and top-10 exact; the ring-16384 four-step NTT
   over 8 sp shards (12 limbs, N1 = N2 = 128): round trips and products
   equal to the single-card NTT's; `entry.dryrun_multichip(8)`.  Launch
   counts are zeroed before the phase and read after it: the all-to-all
   must have launched exactly once per card per exchange (16 four-step
   transforms x 2 exchanges = 32 on one card).  Then the
   8-shard search step against one shard holding 1/8 of the store (and
   the card's busy time and idle share over the step), and the
   distributed forward NTT against the single-card one.
   Only where several cards are visible, the shards then spread over all
   of them (`cross_card`): the all-to-all through peer pointers against
   its plain version, the four-step NTT and a sharded search across
   cards, and the all-to-all's times beside the NVLink bound.  With one
   card this phase is skipped.  To run it alone on a host with several,
   call `device_and_build()` and then `cross_card(np.random.default_rng(0))`
   from Python (`python3 -c "import chip_smoke; ..."`).
5. The compare path at full width (`compare_path`): (a) config 1, one
   pairwise-4096 compare, relinearized and in degree 2, exact, noise
   budget >= 2 bits after relinearization; (b) config 2, the 32 x 32
   all-pairs matrix (1024 products, the keyswitch's batch >= 32 regime)
   equal to docs @ docs.T; (c) the 2048 packed ciphertexts of phase 3's
   store re-keyed to new keys (16-bit digits at batch 2048), a sample's
   budget within 3 bits of the old one, then searched under the new key
   (8 queries exact, top-10; outside the launch count, since it runs K1),
   the old key's query operand wrong; (d) config 4, ring-16384 mul_ct ->
   relinearize -> mod_switch -> decrypt_dot exact; (e) config 8,
   galois-4096 `dot_ct_ct_slots(d=128)` with 16-bit-digit rotation keys,
   slot [0, 0] exact.  Launch counts are zeroed before the cases: K2
   forward and inverse must have risen, K1, K3 and K2's cyclic entries
   must not have launched.  Then each case's host time (median of 7 after
   the first), K2 launches and device time a run, the card's busy time
   and idle share, and both branches of `arith._REUSE_MIN_BATCH` at batch
   32 for (b) and (c).  Phase 2 holds K2 on this path's plans: the hybrid
   plans (pairwise-4096 and ring-16384), the digit plans, the special
   prime's and galois-4096's plan over t.
6. Times on the card (CUDA events, median of repeats after warm-up) of
   each kernel, its plain version and, where one PyTorch call computes
   the same function (the int8 matmul alone through `torch._int_mm`; one
   strided `copy_` for the all-to-all), that call, beside the least time
   the card could take (bytes over its device memory's rate or NVLink's,
   or operations at the published peak rate: the card's data-sheet peaks
   from the port's `utils/profiling.CARD_SPECS`, printed in phase 1,
   which fails on a card the table lacks).  The NTT's forward and
   inverse are timed at one encrypt batch (16,384 rows x N = 4096, the
   JSON rows), a query's 2 rows and one ring-16384 polynomial (12 x
   16384), its cyclic entries at one four-step shard (192 x 128, the JSON
   rows), each also by device time per call and each checked bit-exact on
   the inputs it was timed on.  The scoring kernel is
   timed at 2048 groups (the JSON row) and at one 391-group shard, the
   all-to-all at the ring-16384 exchange (the JSON row) and at 256 MiB,
   each also by its device time per call from torch.profiler.
8. The rest of the package (`rest_of_package`), after phase 7 and before
   phase 6's times; launch counts are zeroed before (a)-(e), with the
   oracles' and timings' launches left out: K2 must have risen in this
   process, and K1 in each worker of (d).  (a) Phase 3's 65,536 documents
   encrypted again as per-document ciphertexts (its keys and seeds) into a 4.0 GiB fastdot
   `DocOperand`; 8 queries through `make_query_operand` and `scores`, every
   score == docs @ query == phase 3's packed scores (K1), every top-10 the
   oracle's; the query latency beside K1's packed query, the int8 product
   (`pack_cuda.int_mm`, `torch._int_mm` a limb) beside its byte bound; then
   the same operand on 8 dp shards (`make_sharded_fastdot_search`).  (b)
   Fastdot at ring-16384 (12 limbs, 2N = 32768), 256 documents, exact, and
   the digit fold on +-2^29 partials equal to exact integers.  (c)
   `make_pipelined_scores` on a 2-shard pp mesh over phase 3's packed
   operand, 8 microbatches: every query bit-equal to `packed_scores`;
   its time beside K1's.  (d) Two worker processes on this card
   (`python -m fhe_icp_tpu_torch.parallel.multihost`, gloo on 127.0.0.1,
   their own timeout), each with `partition_groups(3128, 2)`'s half of
   phase 4's store and keys from seed 0, `search_host_shard` then
   `global_topk`: both print the oracle's exact top-10 for every query,
   and neither rebuilds the kernel library.  (e) `ntt_fwd_mxu` at
   pairwise-4096 on 256 polynomials bit-equal to K2's forward after the
   bit reversal, its time against K2's.  (f) phase 3's query and K2 at
   16,384 rows timed by `utils/profiling.measure_ondevice_loop` beside
   CUDA events around one call.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import hashlib
import io
import json
import logging
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The port's package: this checkout's, or the one in DIR after --k2-times.
_ARGS = sys.argv[1:]
TREE = os.path.abspath(_ARGS[1] if _ARGS[:1] == ["--k2-times"] and len(_ARGS) > 1
                       else os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, TREE)

from fhe_icp_tpu_torch import cli, entry, kernels  # noqa: E402
from fhe_icp_tpu_torch.batch import BatchProcessor  # noqa: E402
from fhe_icp_tpu_torch.models.embedder import HashingEmbedder  # noqa: E402
from fhe_icp_tpu_torch.models.reduction import DimensionReducer  # noqa: E402
from fhe_icp_tpu_torch.ops import arith, galois, noise, ntt_cuda, pack, pack_cuda  # noqa: E402
from fhe_icp_tpu_torch.ops import primes as pr  # noqa: E402
from fhe_icp_tpu_torch.ops.cipher import Ciphertext, decrypt_coeff, rekey_keygen  # noqa: E402
from fhe_icp_tpu_torch.ops.context import CryptoContext  # noqa: E402
from fhe_icp_tpu_torch.ops.modmath import mont_mul, to_mont  # noqa: E402
from fhe_icp_tpu_torch.ops.ntt import build_plan  # noqa: E402
from fhe_icp_tpu_torch.ops.params import get_params  # noqa: E402
from fhe_icp_tpu_torch.ops.runtime import FheRuntime  # noqa: E402
from fhe_icp_tpu_torch.parallel import ici  # noqa: E402
from fhe_icp_tpu_torch.parallel.mesh import (PACKED_OPERAND_SPEC, SP_AXIS, gather,  # noqa: E402
                                             make_mesh, shard)
from fhe_icp_tpu_torch.parallel.ntt_dist import (ROW_SPEC, build_dist_plan,  # noqa: E402
                                                 make_dist_ntt)
from fhe_icp_tpu_torch.parallel.search import make_sharded_packed_search  # noqa: E402
from fhe_icp_tpu_torch.utils.quantize import prepare_embedding_for_fhe  # noqa: E402

DEVICE = "cuda"
PRESET = "pairwise-4096"
DIM, SCALE = 128, 1000.0
N_DOCS, ENC_BATCH = 65_536, 8192
N_QUERIES, TOP_K = 8, 10
# The multi-shard path: BASELINE config 5's store on an 8-shard dp mesh, and
# the ring-16384 preset's 12 limbs for the four-step NTT on 8 sp shards.
N_SHARDS, N_DOCS_SHARDED, PAD_GROUPS = 8, 100_000, 8
RING, RING_N1 = "ring-16384", 128

# The compare path: BASELINE configs 1, 2, 4 and 8 and the store rotation.
COMPARE_PAIRS = 32                 # config 2: the 32 x 32 all-pairs matrix
GALOIS = "galois-4096"             # config 8: the slot-packed rotate-and-sum dot
REKEY_SAMPLE = 64                  # store ciphertexts whose budget is read around re-keying
RELIN_BUDGET_BITS, REKEY_COST_BITS = 2, 3
REPS = 7                           # host-clock repeats after the first

# The user path: a 4,096-document store built and searched through the CLI
# and a BatchProcessor (the CLI's defaults: BatchConfig(), hashing embedder).
APP_DOCS, APP_VOCAB = 4096, 5000
APP_QUERIES, APP_PAIRS, APP_TOP_K = 8, 8, 10
REKEYED_PAIRS = 64


KERNELS = {
    "ntt_fwd": ("fhe_icp_tpu_torch/csrc/ntt.cu", "fhe_icp_tpu/ops/ntt_pallas.py:152"),
    "ntt_inv": ("fhe_icp_tpu_torch/csrc/ntt.cu", "fhe_icp_tpu/ops/ntt_pallas.py:165"),
    "pack_score": ("fhe_icp_tpu_torch/csrc/pack_score.cu",
                   "fhe_icp_tpu/ops/pack_pallas.py:67"),
    "ntt_cyclic_fwd": ("fhe_icp_tpu_torch/csrc/ntt.cu", "fhe_icp_tpu/ops/ntt_pallas.py:152"),
    "ntt_cyclic_inv": ("fhe_icp_tpu_torch/csrc/ntt.cu", "fhe_icp_tpu/ops/ntt_pallas.py:165"),
    "all_to_all": ("fhe_icp_tpu_torch/csrc/all_to_all.cu", "fhe_icp_tpu/parallel/ici.py:28"),
}
# The kernels each path must launch.
MAIN_PATH_KERNELS = ("ntt_fwd", "ntt_inv", "pack_score")
COMPARE_PATH_KERNELS = ("ntt_fwd", "ntt_inv")
NOT_ON_COMPARE_PATH = ("pack_score", "all_to_all", "ntt_cyclic_fwd", "ntt_cyclic_inv")
SHARD_PATH_KERNELS = ("all_to_all", "pack_score", "ntt_fwd", "ntt_cyclic_fwd",
                      "ntt_cyclic_inv")
APP_PATH_KERNELS = ("pack_score", "ntt_fwd", "ntt_inv")
# The multi-shard path runs 16 four-step transforms (4 round trips, 2
# products of 2 forward and 1 inverse, and dryrun_multichip's 2), each with
# 2 exchanges, and K3 makes one launch per card per exchange.
K3_LAUNCHES_PER_CARD = 16 * 2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


@contextlib.contextmanager
def uncounted():
    """Launches made inside (an oracle, a timing loop) leave the kernels'
    launch counts as they were: only a path's own launches count."""
    saved = dict(kernels.launches)
    try:
        yield
    finally:
        kernels.launches.clear()
        kernels.launches.update(saved)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, by CUDA events around each run."""
    with uncounted():
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    torch.cuda.synchronize()
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def quantized_unit(rng, shape) -> np.ndarray:
    """L2-normalized Gaussian vectors at scale 1000, rounded (the repo's contract)."""
    v = rng.standard_normal(shape)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return np.round(v * SCALE).astype(np.int32)


def random_residues(rng, plan, shape) -> torch.Tensor:
    l = shape[-2]
    ps = np.asarray(plan.primes[:l], dtype=np.uint64)[:, None]
    x = rng.integers(0, 2 ** 31, size=shape, dtype=np.uint64) % ps
    return torch.from_numpy(x.astype(np.uint32)).to(DEVICE)


# ---------------------------------------------------------------------------


def device_and_build() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    phase("device and build")
    smi = card()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    from fhe_icp_tpu_torch.utils import debug
    print("  check_environment: " + json.dumps(debug.check_environment(verbose=False),
                                               default=str))
    spec = peaks()
    print(f"  data-sheet peaks (utils/profiling): HBM {spec.hbm_gbs:g} GB/s, int8 "
          f"{spec.int8_tops:g} TOP/s, 32-bit multiplies {spec.int32_mul_tops:g} T/s, NVLink "
          f"{spec.nvlink_gbs:g} GB/s each way")
    t0 = time.perf_counter()
    log = kernels.build()
    kernels.load()
    print(f"build {time.perf_counter() - t0:.2f} s")
    report = ptxas_report(log)
    for name, (regs, stack) in report.items():
        print(f"  ptxas: {name}: {regs} registers, {stack} bytes stack")
    ntt = {k: v for k, v in report.items() if k.startswith("ntt_")}
    check(len(ntt) == 32 and all(st == 0 for _, st in ntt.values()),
          f"K2 instances with a stack frame, or missing from the build log: {ntt}")
    print("kernels:", " ".join(KERNELS))
    return smi


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """{kernel: (registers, stack bytes)} from nvcc's -Xptxas -v output.

    K2's templates are named ntt_block_kernel<fwd, twist, C> and
    ntt_warp_kernel<fwd, twist, E>; other kernels keep ptxas's name.
    """
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            t = re.search(r"(ntt_(?:block|warp)_kernel)ILb(\d)ELb(\d)ELi(\d+)E", name)
            if t:
                name = f"{t.group(1)}<{t.group(2)}, {t.group(3)}, {t.group(4)}>"
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            out[name] = [None, int(m.group(1))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out and out[name][0] is None:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def kernels_vs_plain(rng) -> dict:
    phase("kernels against plain versions")
    errs = {name: 0 for name in KERNELS}
    ntt_vs_plain(rng, errs)

    # The slice's store, a ragged one, one 8-shard shard (K split), ragged
    # row tiles; then test-512's shape (4S = 16, 2N = 1024) and ring-16384's
    # at d = 128 and 64 (4S = 512 and 1024: 2 and 4 column tiles, 2N = 32768).
    for preset, d, groups in ((PRESET, DIM, (2048, 3125, 391, 1, 33, 128)),
                              ("test-512", DIM, (33, 512)), (RING, DIM, (1, 64)),
                              (RING, DIM // 2, (33,))):
        rt_ctx = CryptoContext(get_params(preset), DEVICE)
        slots, k = pack.slots_per_ct(rt_ctx.n, d), 2 * rt_ctx.n
        for g in groups:
            a = torch.randint(-128, 128, (2, 4 * g, k), dtype=torch.int8, device="cuda")
            v = torch.randint(-128, 128, (2, k, 4 * slots), dtype=torch.int8, device="cuda")
            e = max_abs_err(pack_cuda.packed_score_residues(rt_ctx, a, v, 2, slots),
                            pack_cuda.packed_score_residues_ref(rt_ctx, a, v, 2, slots))
            check(e == 0, f"pack_score {preset} G={g}: max abs err {e}")
            errs["pack_score"] = max(errs["pack_score"], e)
        print(f"  pack_score at {preset} (4S={4 * slots}, 2N={k}), G={groups} (K slices "
              f"{[pack_cuda.k_splits(2, g, k, 4 * slots) for g in groups]}): bit-exact")

    # mod_switch (a one-limb plan in K2) on the card equals the CPU run.
    m = torch.from_numpy(rng.integers(-1000, 1001, size=(4, 512)).astype(np.int32))
    rt = FheRuntime("test-512-mult", device="cpu")
    rt.generate_keys(seed=0)
    ct = rt.encrypt(m, seed=1)
    want = arith.mod_switch_to(rt.ctx, ct, 2)
    card_ctx = CryptoContext(get_params("test-512-mult"), DEVICE)
    got = arith.mod_switch_to(card_ctx, Ciphertext(ct.data.to(DEVICE), ct.level), 2)
    check(max_abs_err(got.data.cpu(), want.data) == 0 and got.pt_corr == want.pt_corr,
          "mod_switch on the card differs from the CPU")
    check(torch.equal(rt.decrypt(want), m), "mod_switch decrypt")
    print("  mod_switch_to(2) at test-512-mult: card == CPU, decrypts exactly")
    compare_plans_vs_plain(rng, errs)
    user_plans_vs_plain(rng, errs)
    all_to_all_vs_plain(rng, errs)
    return errs


@functools.lru_cache(maxsize=None)
def runtime(preset: str, rlk_levels: tuple) -> FheRuntime:
    """One runtime per preset on the card: phase 2 holds K2 on its plans, and the
    compare path reuses them (a ring-16384 plan takes seconds of host work)."""
    return FheRuntime(preset, rlk_levels=list(rlk_levels), device=DEVICE)


def compare_plans_vs_plain(rng, errs: dict) -> None:
    """K2 forward and inverse on the compare path's plans and shapes, bit-exact.

    The hybrid plans (the chain with the special prime P last) of
    pairwise-4096 at level 2 and ring-16384 at level 12, pairwise-4096's
    digit plans (chain + P minus limb j: not a prefix of the chain), the
    one-prime plan of P, galois-4096's plan over t (22 bits), and the
    special limb sliced out of a hybrid batch (a view the wrapper copies).
    """
    ctx, ring, gctx = (runtime(pre, (lv,)).ctx for pre, lv in
                       ((PRESET, 2), (RING, 12), (GALOIS, 2)))
    store = N_DOCS // pack.slots_per_ct(ctx.n, DIM)
    pairs = COMPARE_PAIRS * COMPARE_PAIRS
    sp_plan = arith._single_prime_plan(ctx, ctx.params.special_prime)
    hyb = ctx.hybrid(2).plan
    cases = [("hybrid, one compare's digits", hyb, (2, 3)),
             ("hybrid, one rotation's 16-bit digits", hyb, (4, 3)),
             ("hybrid, the store's 16-bit digits", hyb, (4 * store, 3)),
             (f"{RING} hybrid, one compare's digits", ring.hybrid(12).plan, (12, 13)),
             (f"{RING} hybrid, divide-by-P", ring.hybrid(12).plan, (2, 13)),
             ("digit plan j=0, all pairs", arith._digit_plan(ctx, 2, 0), (pairs, 2)),
             ("digit plan j=1, all pairs", arith._digit_plan(ctx, 2, 1), (pairs, 2)),
             ("P, all pairs' divide-by-P", sp_plan, (2 * pairs, 1)),
             ("P, the store's divide-by-P", sp_plan, (2 * store, 1)),
             ("t, one slot vector", galois._t_plan(gctx), (1,)),
             ("t, two slot vectors", galois._t_plan(gctx), (2, 1))]
    for what, plan, lead in cases:
        x = random_residues(rng, plan, lead + (plan.n,))
        for name, kern, ref in NTT_ENTRIES[:2]:
            e = max_abs_err(kern(plan, x), ref(plan, x))
            check(e == 0, f"{name} on the {what} plan {lead}: max abs err {e}")
            errs[name] = max(errs[name], e)
    x = random_residues(rng, hyb, (64, 3, ctx.n))
    view = x[:, 2:, :]
    for name, kern, ref in NTT_ENTRIES[:2]:
        e = max_abs_err(kern(sp_plan, view), ref(sp_plan, view.contiguous()))
        check(e == 0, f"{name} on the special limb of a hybrid batch: max abs err {e}")
    print("  K2 fwd and inv bit-exact on the compare path's plans: "
          + "; ".join(f"{what} {lead}" for what, _, lead in cases)
          + "; the special limb sliced from (64, 3, 4096)")


def user_plans_vs_plain(rng, errs: dict) -> None:
    """K2 forward and inverse at the user path's own shapes, bit-exact: an
    encrypt batch of BatchConfig's 10 documents and the corpus's ragged tail
    of 6, one document, a `validate --deep` chunk of 256, and the re-keying
    of 64 documents (128 ciphertexts: 16-bit digits on the hybrid plan, the
    division by P, the re-key keys' own transforms)."""
    ctx = runtime(PRESET, (2,)).ctx
    sp_plan = arith._single_prime_plan(ctx, ctx.params.special_prime)
    hyb = ctx.hybrid(2).plan
    cases = [("encrypt batch", ctx.plan, (10, 2)), ("encrypt tail", ctx.plan, (6, 2)),
             ("one document", ctx.plan, (1, 2)), ("validate chunk", ctx.plan, (256, 2)),
             ("re-key digits", hyb, (4 * 128, 3)), ("re-key divide-by-P", sp_plan, (2 * 128, 1)),
             ("re-key key secret", hyb, (1, 3)), ("re-key key errors", hyb, (4, 3))]
    for what, plan, lead in cases:
        x = random_residues(rng, plan, lead + (plan.n,))
        for name, kern, ref in NTT_ENTRIES[:2]:
            e = max_abs_err(kern(plan, x), ref(plan, x))
            check(e == 0, f"{name} at the user path's {what} {lead}: max abs err {e}")
            errs[name] = max(errs[name], e)
    print("  K2 fwd and inv bit-exact at the user path's shapes: "
          + "; ".join(f"{what} {lead}" for what, _, lead in cases))


NTT_ENTRIES = (("ntt_fwd", ntt_cuda.ntt_fwd, ntt_cuda.ntt_fwd_ref),
               ("ntt_inv", ntt_cuda.ntt_inv, ntt_cuda.ntt_inv_ref),
               ("ntt_cyclic_fwd", ntt_cuda.cyclic_fwd, ntt_cuda.cyclic_fwd_ref),
               ("ntt_cyclic_inv", ntt_cuda.cyclic_inv, ntt_cuda.cyclic_inv_ref))


def regime(rows: int, l: int, n: int) -> tuple:
    s = ntt_cuda.launch_shape(rows, l, n)
    return (s.regime, s.rows_per_block, s.cluster)


def edge_batches(l: int, n: int, limit: int = 4096) -> list:
    """Batches of l-limb rows at K2's regime edges: just below and at the
    first batch launched without a cluster, the first with R > 1 rows per
    block, and the first after it that R does not divide."""
    out, prev, ragged_r = set(), None, None
    for b in range(1, limit + 1):
        kind, r, c = regime(b * l, l, n)
        if prev is not None and prev[2] > 1 and c == 1:
            out |= {b - 1, b}
        if r > 1 and ragged_r is None:
            out.add(b)
            ragged_r = r
        if ragged_r and b % r:
            out.add(b)
            break
        prev = (kind, r, c)
    return sorted(out)


def ntt_vs_plain(rng, errs: dict) -> None:
    """K2 (all four entries) in every regime and at its edges, bit-exact.

    N = 16 .. 16384 at 1, 2 and 12 rows (1, 2 and 12 limbs), 3 x 2 and 5 x 1
    rows, a one-prime plan; the batches where launch_shape leaves clusters
    for one block per row, or first takes R > 1 rows of a limb, and a
    ragged group of R; the main path's (8192, 2, 4096) and (2, 4096) and
    the ring-16384 polynomial (12, 16384); the four-step NTT's shard (16,
    12) at N = 16 .. 256.  Every forward is also inverted back to its input.
    Then every launch the kernels take, and a view one word into its storage.
    """
    two, ring = pr.ntt_primes(2, bits=31), get_params(RING).primes
    cases = []
    for n in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384):
        cases += [(two, (1, 1), n), (two, (1, 2), n), (ring, (1, 12), n), (two, (3, 2), n),
                  (two, (5, 1), n), (two[1:], (3, 1), n)]
    edge_cases = ((two, 2, 4096), (two, 1, 512), (ring, 12, 16384), (two, 2, 16384))
    for prs, l, n in edge_cases:
        cases += [(prs, (b, l), n) for b in edge_batches(l, n)]
    cases += [(two, (ENC_BATCH, 2), 4096), (two, (2,), 4096), (ring, (12,), 16384)]
    cases += [(ring, (16, 12), n) for n in (16, 32, 64, 128, 256)]
    plans, seen = {}, set()
    for prs, lead, n in cases:
        key = (n, tuple(prs[:lead[-1]]))
        if key not in plans:
            plans[key] = build_plan(n, key[1], DEVICE)
        plan = plans[key]
        x = random_residues(rng, plan, lead + (n,))
        for name, kern, ref in NTT_ENTRIES:
            e = max_abs_err(kern(plan, x), ref(plan, x))
            check(e == 0, f"{name} N={n} shape={lead}: max abs err {e}")
            errs[name] = max(errs[name], e)
        check(max_abs_err(ntt_cuda.ntt_inv(plan, ntt_cuda.ntt_fwd(plan, x)), x) == 0,
              f"NTT round trip N={n} shape={lead}")
        seen.add((n,) + regime(x.numel() // n, lead[-1], n))
    edges = {(l, n): edge_batches(l, n) for _, l, n in edge_cases}
    print(f"  K2 fwd, inv, cyclic fwd, cyclic inv bit-exact, fwd -> inv round trips exact, on "
          f"{len(cases)} shapes: N=16..16384 at 1/2/12 limbs, batches at the regime edges "
          f"{edges} (limbs, N): batches; the main path's (8192, 2, 4096) and (2, 4096), "
          f"ring-16384's (12, 16384), the four-step shard's (16, 12, 16..256)")
    print("  launches taken (N, regime, R, C): " + ", ".join(map(str, sorted(seen))))
    # Every launch the kernels take, chosen or not, on a ragged batch of 9.
    forced = []
    for n in (512, 4096, 16384):
        plan = build_plan(n, two, DEVICE)
        x = random_residues(rng, plan, (9, 2, n))
        for _, shape in ntt_cuda.launch_candidates(18, 2, n):
            for name, _, ref in NTT_ENTRIES:
                e = max_abs_err(ntt_cuda._launch(plan, x, name, shape), ref(plan, x))
                check(e == 0, f"{name} N={n} forced {shape}: max abs err {e}")
            forced.append((n, shape.rows_per_block, shape.cluster))
    print(f"  every launch the kernels take, on 9 x 2 rows, all four entries bit-exact "
          f"(N, R, C): {forced}")
    unaligned_view(rng)


def unaligned_view(rng) -> None:
    """K2 on a view that starts one word into its storage (4-byte aligned).

    The block regime moves rows as 16-byte vectors: its C entry refuses the
    view's pointer (cudaErrorInvalidValue) and the wrapper copies the view to
    an aligned tensor first, so all four entries stay bit-exact.
    """
    plan = build_plan(4096, pr.ntt_primes(2, bits=31), DEVICE)
    x = random_residues(rng, plan, (3, 2, 4096))
    buf = torch.empty(x.numel() + 1, dtype=torch.uint32, device=DEVICE)
    buf[1:] = x.reshape(-1)
    view = buf[1:].view(x.shape)
    for name, kern, ref in NTT_ENTRIES:
        e = max_abs_err(kern(plan, view), ref(plan, x))
        check(e == 0, f"{name} on an unaligned view: max abs err {e}")
    s = ntt_cuda.launch_shape(6, 2, 4096)
    out = torch.empty_like(x)
    with kernels.launch_on(view.device) as stream:
        err = kernels.load().fhe_ntt_fwd(view.data_ptr(), out.data_ptr(),
                                         plan.fwd_table.data_ptr(), plan.p.data_ptr(), 6, 2,
                                         4096, 12, s.rows_per_block, s.cluster, s.threads, stream)
    check(err == 1, f"the forward entry took an unaligned pointer (returned {err})")
    print(f"  a view one word into its storage (6 x 4096, C = {s.cluster}): the C entry "
          "refuses it (cudaErrorInvalidValue), the four wrappers are bit-exact")


def ring_shards(rng, d: int, shape) -> list:
    """d shards of uint32 residues of the ring preset's primes, limbs on axis 0."""
    ps = np.asarray(get_params(RING).primes[:shape[0]], dtype=np.uint64)
    ps = ps.reshape((-1,) + (1,) * (len(shape) - 1))
    return [torch.from_numpy((rng.integers(0, 2 ** 31, size=shape, dtype=np.uint64) % ps)
                             .astype(np.uint32)).to(DEVICE) for _ in range(d)]


def random_flats(devices, rows: int, w: int) -> list:
    """One random (rows, w) uint32 shard on each device (any 32-bit values)."""
    return [torch.randint(0, 2 ** 31, (rows, w), dtype=torch.int64, device=dev)
            .to(torch.uint32) for dev in devices]


def all_to_all_vs_plain(rng, errs: dict) -> None:
    """K3 at 2, 4, 8 shards: the ring-16384 exchanges, the 2-D entry, an odd chunk."""
    n_l = len(get_params(RING).primes)
    ring_n2 = get_params(RING).n // RING_N1
    for d in (2, 4, 8):
        cases = [((n_l, RING_N1 // d, ring_n2), 2, 1),      # rows -> columns
                 ((n_l, RING_N1, ring_n2 // d), 1, 2),      # columns -> rows
                 ((3, 8, 5), 1, 2)]                         # chunk 60 B at d = 8
        for shape, split, concat in cases:
            xs = ring_shards(rng, d, shape)
            got = ici.all_to_all(xs, split, concat)
            want = ici.all_to_all_ref(xs, split, concat)
            e = max(max_abs_err(g, w) for g, w in zip(got, want))
            check(e == 0, f"all_to_all d={d} {shape} split {split}: {e}")
            errs["all_to_all"] = max(errs["all_to_all"], e)
        flats = random_flats([torch.device(DEVICE)] * d, d * 3, 7)
        e = max(max_abs_err(g, w)
                for g, w in zip(ici.exchange(flats), ici.all_to_all_ref(flats, 0, 0)))
        check(e == 0, f"exchange d={d}: {e}")
    print("  all_to_all d=2,4,8 at both ring-16384 exchanges, an odd chunk, and the "
          "2-D exchange: bit-exact")


def main_path(rng) -> dict:
    phase(f"main path: {PRESET}, {N_DOCS} documents, {N_QUERIES} queries")
    docs = quantized_unit(rng, (N_DOCS, DIM))
    queries = quantized_unit(rng, (N_QUERIES, DIM))
    torch.cuda.synchronize()
    kernels.launches.clear()
    t_start = time.perf_counter()

    rt = FheRuntime(PRESET, device=DEVICE)
    t0 = time.perf_counter()
    rt.generate_keys(seed=0)
    ctx, sk = rt.ctx, rt.keys.sk
    torch.cuda.synchronize()
    t_keys = time.perf_counter() - t0

    t0 = time.perf_counter()
    store = torch.empty((N_DOCS, 2, ctx.n_limbs, ctx.n), dtype=torch.uint32, device=DEVICE)
    for i in range(0, N_DOCS, ENC_BATCH):
        store[i: i + ENC_BATCH] = rt.encrypt_vector(docs[i: i + ENC_BATCH], seed=1 + i).data
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    print(f"  store: {N_DOCS} ciphertexts, {store.numel() * 4 / 2 ** 30:.2f} GiB")

    t0 = time.perf_counter()
    packed = pack.pack_ciphertexts(ctx, store, DIM, ctx.n_limbs)
    ct = arith.mod_switch_to(ctx, Ciphertext(packed, ctx.n_limbs), 2)
    doc_op = pack.make_packed_doc_operand(ctx, ct.data, ct.level)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    slots = pack.slots_per_ct(ctx.n, DIM)
    check(doc_op.groups == N_DOCS // slots, f"{doc_op.groups} groups")

    want_all = docs.astype(np.int64) @ queries.astype(np.int64).T     # (docs, queries)
    lat = []
    for qi in range(N_QUERIES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_op = pack.make_packed_query_operand(ctx, sk, torch.from_numpy(queries[qi]), DIM,
                                              ct.level)
        scores = pack.packed_scores(ctx, doc_op, q_op, ct.pt_corr).reshape(-1)
        top = torch.topk(scores, TOP_K)
        top_vals = top.values.cpu()
        lat.append(time.perf_counter() - t0)
        got = scores.cpu().numpy().astype(np.int64)
        want = want_all[:, qi]
        check(got.shape == want.shape and (got == want).all(),
              f"query {qi}: {(got != want).sum()} scores differ from docs @ query")
        check(sorted(top_vals.tolist()) == sorted(np.sort(want)[-TOP_K:].tolist()),
              f"query {qi}: top-{TOP_K} scores differ from the oracle's")
        check((want[top.indices.cpu().numpy()] == top_vals.numpy()).all(),
              f"query {qi}: top-{TOP_K} indices do not point at their scores")

    idx = [0, 1, N_DOCS // 2, N_DOCS - 1]
    one = Ciphertext(torch.stack([store[i] for i in idx]), ctx.n_limbs)
    dec = rt.decrypt(one).cpu().numpy()
    check((dec[:, :DIM] == docs[idx]).all() and (dec[:, DIM:] == 0).all(),
          "decrypt of stored ciphertexts")
    for j in (0, DIM - 1):
        got = decrypt_coeff(ctx, sk, one, j).cpu().numpy()
        check((got == docs[idx, j]).all(), f"decrypt_coeff j={j}")
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t_start
    launches = dict(kernels.launches)
    for name in MAIN_PATH_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} not launched on the main path")

    q_ms = statistics.median(lat[1:]) * 1e3
    print(f"  keys {t_keys:.3f} s; encrypt {N_DOCS} docs {t_enc:.3f} s "
          f"({N_DOCS / t_enc:.0f} docs/s); pack + mod_switch + doc operand {t_build:.3f} s")
    print(f"  query latency (operand + score + top-{TOP_K}, host clock, median of "
          f"{N_QUERIES - 1} after the first): {q_ms:.3f} ms = "
          f"{N_DOCS / (q_ms / 1e3):.4g} docs/s; first query {lat[0] * 1e3:.3f} ms")
    print(f"  all {N_QUERIES} queries exact (scores == docs @ query, top-{TOP_K} sets); "
          f"decrypt and decrypt_coeff exact; main path {t_total:.2f} s")
    print(f"  launches on the main path: {launches}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    query_breakdown(ctx, sk, doc_op, queries, ct.pt_corr)
    # The packed store, for the compare path's store rotation.
    store = dict(rt=rt, ct=ct, docs=docs, queries=queries)
    return dict(launches=launches, query_ms=q_ms, encrypt_s=t_enc, build_s=t_build,
                keys_s=t_keys, store=store)


def query_breakdown(ctx, sk, doc_op, queries, pt_corr) -> None:
    """Where a query's time goes: host time per stage, device time by kernel.

    Stages end in a synchronize, so each host time includes its launches.
    The device view comes from torch.profiler over the same queries: busy
    time is the union of the device activity intervals, idle share is the
    rest of the profiled window.
    """
    stages = ("query operand", "packed_scores (kernel + decode)", f"top-{TOP_K}")

    def one_query(q, clock):
        q_op = pack.make_packed_query_operand(ctx, sk, q, DIM, doc_op.level)
        clock()
        scores = pack.packed_scores(ctx, doc_op, q_op, pt_corr).reshape(-1)
        clock()
        torch.topk(scores, TOP_K).values.cpu()
        clock()

    qs = [torch.from_numpy(q) for q in queries]
    per_stage = {name: [] for name in stages}
    for q in qs:
        marks = [time.perf_counter()]

        def clock():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        one_query(q, clock)
        for name, t0, t1 in zip(stages, marks, marks[1:]):
            per_stage[name].append((t1 - t0) * 1e3)
    print("  query stages (host clock, median of "
          f"{len(qs)}): " + "; ".join(f"{name} {statistics.median(v):.3f} ms"
                                      for name, v in per_stage.items()))

    device_view(lambda i: one_query(qs[i], lambda: None), len(qs), "query")


def device_view(run, count: int, unit: str, top: int = 8) -> None:
    """Busy time, idle share and top kernels of `count` back-to-back run(i) (torch.profiler).

    Busy time is the union of the device activity intervals; the idle
    share is the rest of the profiled window.
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with uncounted(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(count):
            run(i)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("  device view: not measured (the profiler recorded no device activity)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    print(f"  device view (torch.profiler, {unit} x {count}): busy {busy / 1e3:.3f} ms "
          f"of a {window_us / 1e3:.3f} ms window, idle share {1 - busy / window_us:.3f}; "
          f"{len(dev)} device activities")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {t / 1e3 / count:.4f} ms/{unit}  x{c / count:g}  {name[:90]}")


def host_ms(fn, reps: int = 10) -> float:
    """Median host-clock time of fn() in ms, each run ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def multi_shard_path(rng) -> dict:
    """The multi-shard path, its launch counts, then its two comparisons."""
    phase(f"multi-shard path: {N_DOCS_SHARDED} documents on {N_SHARDS} dp shards, "
          f"{RING} four-step NTT on {N_SHARDS} sp shards, dryrun_multichip({N_SHARDS})")
    docs = quantized_unit(rng, (N_DOCS_SHARDED, DIM))
    queries = quantized_unit(rng, (N_QUERIES, DIM))
    ring = ring_ntt_case(rng)
    torch.cuda.synchronize()
    kernels.launches.clear()
    t_start = time.perf_counter()
    search = sharded_search(docs, queries)
    dist = ring_sharded_ntt(ring)
    t0 = time.perf_counter()
    entry.dryrun_multichip(N_SHARDS, DEVICE)
    torch.cuda.synchronize()
    print(f"  dryrun_multichip({N_SHARDS}) on the card: three programs exact, "
          f"{time.perf_counter() - t0:.2f} s")
    launches = dict(kernels.launches)
    for name in SHARD_PATH_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} not launched on the multi-shard path")
    cards = len(set(make_mesh(N_SHARDS, (N_SHARDS,), DEVICE, axes=(SP_AXIS,)).devices))
    check(launches.get("all_to_all", 0) == K3_LAUNCHES_PER_CARD * cards,
          f"all_to_all launched {launches.get('all_to_all', 0)} times, not once per card per "
          f"exchange ({K3_LAUNCHES_PER_CARD} x {cards})")
    print(f"  launches on the multi-shard path: {launches}; path "
          f"{time.perf_counter() - t_start:.2f} s")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    overhead = sharding_overhead(search)
    dist_vs_single(dist, ring)
    # The store's documents and queries, for phase 8's multi-process search.
    return dict(launches=launches, query_ms=search["query_ms"], docs=docs, queries=queries,
                **overhead)


def sharded_search(docs: np.ndarray, queries: np.ndarray) -> dict:
    """BASELINE config 5 on the card: a sharded store, 8 exact queries."""
    rt = FheRuntime(PRESET, device=DEVICE)
    rt.generate_keys(seed=0)
    ctx, sk = rt.ctx, rt.keys.sk
    n = len(docs)
    t0 = time.perf_counter()
    store = torch.empty((n, 2, ctx.n_limbs, ctx.n), dtype=torch.uint32, device=DEVICE)
    for i in range(0, n, ENC_BATCH):
        store[i: i + ENC_BATCH] = rt.encrypt_vector(docs[i: i + ENC_BATCH], seed=1 + i).data
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0

    t0 = time.perf_counter()
    packed = pack.pack_ciphertexts(ctx, store, DIM, ctx.n_limbs)
    del store
    ct = arith.mod_switch_to(ctx, Ciphertext(packed, ctx.n_limbs), 2)
    doc_op = pack.make_packed_doc_operand(ctx, ct.data, ct.level, pad_groups_to=PAD_GROUPS)
    slots = pack.slots_per_ct(ctx.n, DIM)
    real_groups = doc_op.n_groups or doc_op.groups
    check(real_groups == -(-n // slots) and doc_op.groups % N_SHARDS == 0,
          f"{real_groups} groups padded to {doc_op.groups}")
    mesh = make_mesh(N_SHARDS, (N_SHARDS, 1), DEVICE)
    doc_shards = shard(mesh, doc_op.digits, PACKED_OPERAND_SPEC)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"  store: {n} ciphertexts encrypted in {t_enc:.3f} s; packed into "
          f"{real_groups} groups padded to {doc_op.groups}, "
          f"{doc_op.groups // N_SHARDS} per shard, in {t_build:.3f} s")
    print(f"  shards of the (dp={N_SHARDS}, tp=1) mesh on: "
          + ", ".join(f"{i}:{dev}" for i, dev in enumerate(mesh.devices)))

    step = make_sharded_packed_search(ctx, mesh, DIM, top_k=TOP_K, pt_corr=ct.pt_corr,
                                      n_docs=n)
    want_all = docs.astype(np.int64) @ queries.astype(np.int64).T
    lat = []
    for qi, query in enumerate(queries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_op = pack.make_packed_query_operand(ctx, sk, torch.from_numpy(query), DIM, ct.level)
        scores, vals, idx = step(doc_shards, q_op.digits)
        vals, idx = vals.cpu().numpy().astype(np.int64), idx.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        got = scores.cpu().numpy().astype(np.int64)
        want = want_all[:, qi]
        check(got.shape == (doc_op.groups * slots,), f"query {qi}: {got.shape} scores")
        check((got[:n] == want).all() and (got[n:] == 0).all(),
              f"query {qi}: {(got[:n] != want).sum()} scores differ from docs @ query")
        check(sorted(vals.tolist()) == sorted(np.sort(want)[-TOP_K:].tolist()),
              f"query {qi}: top-{TOP_K} scores differ from the oracle's")
        check((idx < n).all() and (want[idx] == vals).all(),
              f"query {qi}: top-{TOP_K} indices do not point at their scores")
    q_ms = statistics.median(lat[1:]) * 1e3
    print(f"  {len(queries)} queries exact (scores == docs @ query, pad slots 0, top-{TOP_K} "
          f"values and indices); query latency (operand + sharded step + top-{TOP_K} to "
          f"the host, host clock, median of {len(queries) - 1} after the first) {q_ms:.3f} ms = "
          f"{n / (q_ms / 1e3):.4g} docs/s; first query {lat[0] * 1e3:.3f} ms")
    return dict(ctx=ctx, step=step, doc_shards=doc_shards, q_digits=q_op.digits,
                query_ms=q_ms)


def sharding_overhead(search: dict) -> dict:
    """The 8-shard step against one shard holding 1/8 of the store (one-shard mesh)."""
    ctx, shards, qd = search["ctx"], search["doc_shards"], search["q_digits"]
    one_mesh = make_mesh(1, (1, 1), DEVICE)
    step1 = make_sharded_packed_search(ctx, one_mesh, DIM, top_k=TOP_K)
    ms_n = host_ms(lambda: search["step"](shards, qd)[1].cpu())
    ms_1 = host_ms(lambda: step1(shards[:1], qd)[1].cpu())
    dev_n = cuda_ms(lambda: search["step"](shards, qd))
    dev_1 = cuda_ms(lambda: step1(shards[:1], qd))
    ratio = ms_n / (N_SHARDS * ms_1)
    print(f"  search step (scores, per-shard top-{TOP_K}, merge; host clock, median of 10): "
          f"{N_SHARDS} shards {ms_n:.3f} ms, 1 shard of 1/{N_SHARDS} the store {ms_1:.3f} ms, "
          f"sharding_overhead_vs_serial {ratio:.3f}; CUDA events {dev_n:.3f} / {dev_1:.3f} ms")
    device_view(lambda i: search["step"](shards, qd)[1].cpu(), N_QUERIES, "sharded step")
    return dict(step_ms=ms_n, one_shard_ms=ms_1, sharding_overhead_vs_serial=ratio)


def ring_ntt_case(rng) -> dict:
    """Ring-16384 inputs and their single-card K2 products, made before the counted path."""
    params = get_params(RING)
    primes, n = params.primes, params.n
    l = len(primes)
    splan = build_plan(n, primes, DEVICE)
    mc = [pr.mont_constants(p) for p in primes]
    col = [torch.tensor(np.asarray(v, dtype=np.uint32)[:, None], device=DEVICE)
           for v in (primes, [c["p_neg_inv"] for c in mc], [c["r2_mod_p"] for c in mc])]

    def poly():
        return ring_shards(rng, 1, (l, n))[0]

    def product(a, b):              # a * b in the NTT domain
        p, pinv, r2 = (c.reshape((l,) + (1,) * (a.dim() - 1)).to(a.device) for c in col)
        return mont_mul(a, to_mont(b, p, pinv, r2), p, pinv)

    xs = [poly() for _ in range(4)]
    pairs = [(poly(), poly()) for _ in range(2)]
    wants = [ntt_cuda.ntt_inv(splan, product(ntt_cuda.ntt_fwd(splan, a),
                                             ntt_cuda.ntt_fwd(splan, b)))
             for a, b in pairs]
    return dict(primes=primes, n=n, l=l, splan=splan, xs=xs, pairs=pairs, wants=wants,
                product=product)


def ring_sharded_ntt(case: dict) -> dict:
    """Four-step NTT on N_SHARDS sp shards: round trips, and products equal to one card's."""
    n, l = case["n"], case["l"]
    n2 = n // RING_N1
    sp = make_mesh(N_SHARDS, (N_SHARDS,), DEVICE, axes=(SP_AXIS,))
    t0 = time.perf_counter()
    plan = build_dist_plan(n, case["primes"], n1=RING_N1, device=DEVICE)
    fwd, inv = make_dist_ntt(plan, sp)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0

    def rows(x):
        return shard(sp, x.reshape(l, RING_N1, n2), ROW_SPEC)

    def whole(parts):
        return gather(sp, parts, ROW_SPEC).reshape(l, n)

    for x in case["xs"]:
        check(max_abs_err(whole(inv(fwd(rows(x)))), x) == 0, "distributed NTT round trip")
    for (a, b), want in zip(case["pairs"], case["wants"]):
        fc = [case["product"](u, v) for u, v in zip(fwd(rows(a)), fwd(rows(b)))]
        check(max_abs_err(whole(inv(fc)), want) == 0,
              "distributed NTT product differs from the single-card NTT's")
    print(f"  {RING} (N={n}, L={l}, N1=N2={RING_N1}) on {N_SHARDS} sp shards: "
          f"{len(case['xs'])} round trips exact, {len(case['pairs'])} products == single-card "
          f"K2 products; plan {t_plan:.2f} s")
    return dict(fwd=fwd, rows=rows)


def dist_vs_single(dist: dict, case: dict) -> None:
    x = case["xs"][0]
    parts = dist["rows"](x)
    ms_d = cuda_ms(lambda: dist["fwd"](parts))
    host_d = host_ms(lambda: dist["fwd"](parts))
    ms_s = cuda_ms(lambda: ntt_cuda.ntt_fwd(case["splan"], x))
    print(f"  forward NTT of one (L={case['l']}, N={case['n']}) polynomial: distributed over "
          f"{N_SHARDS} shards {ms_d:.4f} ms (CUDA events; host clock {host_d:.4f} ms), "
          f"single-card K2 {ms_s:.4f} ms")


# ---------------------------------------------------------------------------
# The compare path: ct x ct products, hybrid keyswitching (relinearization,
# re-keying, Galois rotations) and noise, at full width.
# ---------------------------------------------------------------------------


def k2_count() -> int:
    return kernels.launches["ntt_fwd"] + kernels.launches["ntt_inv"]


def center_t(x: int, t: int) -> int:
    r = x % t
    return r - t if r > t // 2 else r


def compare_path(rng, store: dict) -> dict:
    """Cases (a)-(e) once with the launch counts zeroed, then the re-keyed
    store's search (K1, outside the count), then each case's times."""
    phase(f"compare path: {PRESET} compare and {COMPARE_PAIRS} x {COMPARE_PAIRS} all-pairs, "
          f"re-keying the {N_DOCS}-document store, the {RING} chain, the {GALOIS} slot dot")
    pair, docs, ring_pair, slot_pair = (quantized_unit(rng, (k, DIM))
                                        for k in (2, COMPARE_PAIRS, 2, 2))
    torch.cuda.synchronize()
    kernels.launches.clear()
    t_start = time.perf_counter()
    cases = []
    for fn, arg in ((single_compare, pair), (all_pairs, docs), (store_rotation, store),
                    (ring_chain, ring_pair), (slot_dot, slot_pair)):
        k0, t0 = k2_count(), time.perf_counter()
        cases.append(fn(arg))
        torch.cuda.synchronize()
        print(f"    K2 launches in this case (keys and inputs included): {k2_count() - k0}; "
              f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name in COMPARE_PATH_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} not launched on the compare path")
    for name in NOT_ON_COMPARE_PATH:
        check(launches.get(name, 0) == 0, f"kernel {name} launched on the compare path")
    print(f"  launches on the compare path: {launches}; path "
          f"{time.perf_counter() - t_start:.2f} s")
    rekeyed_search(cases[2])
    for case in cases:
        case_times(case)
    for case in cases[1:3]:
        reuse_threshold(*case["threshold"])
    print(f"  compare phase, its times included: {time.perf_counter() - t_start:.2f} s")
    return dict(launches=launches)


def single_compare(pair: np.ndarray) -> dict:
    """(a) Config 1: one compare, relinearized (bench.py's gate 2) and in degree 2
    (the CLI compare), decrypted by single coefficient; budget >= 2 bits."""
    rt = runtime(PRESET, (2,))
    rt.generate_keys(seed=0)
    ct_a = rt.encrypt_vector(pair[0], seed=2)
    ct_b = rt.encrypt_vector(pair[1], seed=3, rev=True)
    want = int(pair[0].astype(np.int64) @ pair[1])
    prod = rt.dot_ct_ct(ct_a, ct_b)
    got = int(rt.decrypt_dot(prod, DIM))
    got2 = int(rt.decrypt_dot(rt.dot_ct_ct(ct_a, ct_b, relinearize=False), DIM))
    check(got == want and got2 == want, f"compare {got} / degree 2 {got2}, want {want}")
    budget = noise.noise_budget_bits(rt.ctx, rt.keys.sk, prod)
    check(budget >= RELIN_BUDGET_BITS, f"post-relinearization budget {budget} bits")
    print(f"  (a) config 1: compare {got} == a . b relinearized and in degree 2; noise budget "
          f"after relinearization {budget} bits")
    return dict(name="(a) config 1", runs={
        "relinearized compare + decrypt_dot":
            lambda: rt.decrypt_dot(rt.dot_ct_ct(ct_a, ct_b), DIM).cpu(),
        "degree-2 compare + decrypt_dot (the CLI)":
            lambda: rt.decrypt_dot(rt.dot_ct_ct(ct_a, ct_b, relinearize=False), DIM).cpu()})


def all_pairs(docs: np.ndarray) -> dict:
    """(b) Config 2: fwd[:, None] x rev[None, :], 1024 products (the batch >= 32
    regime), relinearized and in degree 2; the matrix equals docs @ docs.T."""
    rt = runtime(PRESET, (2,))
    fwd = rt.encrypt_vector(docs, seed=5)
    rev = rt.encrypt_vector(docs, seed=6, rev=True)
    a = Ciphertext(fwd.data[:, None], fwd.level)
    b = Ciphertext(rev.data[None], rev.level)
    want = docs.astype(np.int64) @ docs.astype(np.int64).T
    for relin in (True, False):
        mat = rt.decrypt_dot(rt.dot_ct_ct(a, b, relinearize=relin), DIM).cpu().numpy()
        check((mat == want).all(), f"all-pairs matrix (relinearize={relin}): "
              f"{(mat != want).sum()} entries differ from docs @ docs.T")
    print(f"  (b) config 2: the {len(docs)} x {len(docs)} matrix == docs @ docs.T, "
          "relinearized and in degree 2")
    prod32 = arith.mul_ct(rt.ctx, fwd, rev)          # 32 products: the threshold's batch
    n = len(docs) ** 2
    return dict(name="(b) config 2", runs={
        f"{n} relinearized products + decrypt_dot":
            lambda: rt.decrypt_dot(rt.dot_ct_ct(a, b), DIM).cpu(),
        f"{n} degree-2 products + decrypt_dot":
            lambda: rt.decrypt_dot(rt.dot_ct_ct(a, b, relinearize=False), DIM).cpu()},
        threshold=(f"relinearize {COMPARE_PAIRS} products",
                   lambda: arith.relinearize(rt.ctx, rt.keys.rlk, prod32).data))


def store_rotation(store: dict) -> dict:
    """(c) The main path's packed store re-keyed to keys from seed 1 (16-bit
    digits at batch 2048); a sample's budget within 3 bits of the old one."""
    rt, ct = store["rt"], store["ct"]
    ctx = rt.ctx
    new = FheRuntime(PRESET, rlk_levels=[], device=DEVICE)
    new.generate_keys(seed=1)
    ksk = rekey_keygen(ctx, rt.generator(2), rt.keys.sk, new.keys.sk, levels=[ct.level])[ct.level]
    rekeyed = arith.rekey(ctx, ksk, ct)

    def sample(c):
        return Ciphertext(c.data[:REKEY_SAMPLE], c.level, pt_corr=c.pt_corr)
    before = noise.noise_budget_bits_batch(ctx, rt.keys.sk, sample(ct))
    after = noise.noise_budget_bits_batch(ctx, new.keys.sk, sample(rekeyed))
    check((after >= before - REKEY_COST_BITS).all(),
          f"re-keying cost more than {REKEY_COST_BITS} bits: before {before}, after {after}")
    print(f"  (c) store rotation: {ct.data.shape[0]} packed ciphertexts re-keyed (key "
          f"{tuple(ksk.shape)}); noise budget of {REKEY_SAMPLE} of them {before.min()}.."
          f"{before.max()} bits before, {after.min()}..{after.max()} after")
    ct32 = Ciphertext(ct.data[:COMPARE_PAIRS], ct.level, pt_corr=ct.pt_corr)
    return dict(name="(c) store rotation", ctx=ctx, old_sk=rt.keys.sk, new_sk=new.keys.sk,
                rekeyed=rekeyed, docs=store["docs"], queries=store["queries"],
                runs={f"re-key {ct.data.shape[0]} packed ciphertexts":
                      lambda: arith.rekey(ctx, ksk, ct).data},
                threshold=(f"re-key {COMPARE_PAIRS} packed ciphertexts",
                           lambda: arith.rekey(ctx, ksk, ct32).data))


def rekeyed_search(case: dict) -> None:
    """The re-keyed store searched under the new key: every score exact, every
    top-10 right; the old key's query operand gives wrong scores."""
    ctx, ct, docs, queries = case["ctx"], case["rekeyed"], case["docs"], case["queries"]
    doc_op = pack.make_packed_doc_operand(ctx, ct.data, ct.level)
    want_all = docs.astype(np.int64) @ queries.astype(np.int64).T
    for qi, q in enumerate(queries):
        q_op = pack.make_packed_query_operand(ctx, case["new_sk"], torch.from_numpy(q), DIM,
                                              ct.level)
        scores = pack.packed_scores(ctx, doc_op, q_op, ct.pt_corr).reshape(-1)
        got, want = scores.cpu().numpy().astype(np.int64), want_all[:, qi]
        check((got == want).all(), f"re-keyed store, query {qi}: {(got != want).sum()} scores "
              "differ from docs @ query")
        top = torch.topk(scores, TOP_K)
        check(sorted(top.values.cpu().tolist()) == sorted(np.sort(want)[-TOP_K:].tolist()),
              f"re-keyed store, query {qi}: top-{TOP_K} differs from the oracle's")
    old = pack.make_packed_query_operand(ctx, case["old_sk"], torch.from_numpy(queries[0]), DIM,
                                         ct.level)
    wrong = (pack.packed_scores(ctx, doc_op, old, ct.pt_corr).reshape(-1).cpu().numpy()
             != want_all[:, 0]).sum()
    check(wrong > len(docs) // 2, f"the old key's query still scores {len(docs) - wrong} "
          "documents right")
    print(f"  (c) the re-keyed store searched under the new key: {len(queries)} queries exact "
          f"(scores == docs @ query, top-{TOP_K}); the old key's query operand gets {wrong} of "
          f"{len(docs)} scores wrong")


def ring_chain(pair: np.ndarray) -> dict:
    """(d) Config 4: ring-16384, mul_ct -> relinearize -> mod_switch -> decrypt_dot."""
    rt = runtime(RING, (12,))
    rt.generate_keys(seed=0)
    ctx = rt.ctx
    ct_a = rt.encrypt_vector(pair[0], seed=8)
    ct_b = rt.encrypt_vector(pair[1], seed=9, rev=True)

    def run():
        prod = arith.relinearize(ctx, rt.keys.rlk, arith.mul_ct(ctx, ct_a, ct_b))
        return rt.decrypt_dot(arith.mod_switch(ctx, prod), DIM).cpu()
    got, want = int(run()), int(pair[0].astype(np.int64) @ pair[1])
    check(got == want, f"{RING} chain: {got}, want {want}")
    print(f"  (d) config 4: {RING} (N={ctx.n}, L={ctx.n_limbs}) mul_ct -> relinearize -> "
          f"mod_switch -> decrypt_dot == a . b ({got})")
    return dict(name="(d) config 4", runs={"mul + relinearize + mod_switch + decrypt_dot": run})


def slot_dot(pair: np.ndarray) -> dict:
    """(e) Config 8: galois-4096, dot_ct_ct_slots(d=128) with 16-bit-digit
    rotation keys: log2(128) = 7 rotations; slot [0, 0] exact."""
    rt = runtime(GALOIS, (2,))
    rt.generate_keys(seed=0)
    half = rt.ctx.n // 2
    va, vb = np.zeros((2, 2, half), np.int32)
    va[0, :DIM], vb[0, :DIM] = pair
    sa, sb = rt.encrypt_slots(va, seed=1), rt.encrypt_slots(vb, seed=2)
    rt.rotation_keys(seed=3)
    out = rt.dot_ct_ct_slots(sa, sb, d=DIM)
    got = int(rt.decrypt_slots(out)[0, 0])
    want = center_t(int(pair[0].astype(np.int64) @ pair[1]), rt.ctx.t)
    check(got == want, f"{GALOIS} slot dot: {got}, want {want}")
    budget = noise.noise_budget_bits(rt.ctx, rt.keys.sk, out, max_coeffs=32)
    print(f"  (e) config 8: {GALOIS} (t={rt.ctx.t}) dot_ct_ct_slots(d={DIM}), "
          f"{DIM.bit_length() - 1} rotations: slot [0, 0] == a . b mod t ({got}); noise budget "
          f"{budget} bits")
    return dict(name="(e) config 8", runs={
        f"dot_ct_ct_slots(d={DIM}) + decrypt_slots":
            lambda: rt.decrypt_slots(rt.dot_ct_ct_slots(sa, sb, d=DIM)).cpu()})


def case_times(case: dict) -> None:
    """Host ms (median of 7 after the first), K2 launches and device time a run,
    and the card's busy time and idle share (torch.profiler) over 3 runs."""
    for label, fn in case["runs"].items():
        torch.cuda.synchronize()
        k0 = k2_count()
        fn()
        torch.cuda.synchronize()
        per_run = k2_count() - k0
        ms = host_ms(fn, reps=REPS)
        dev = device_us_per_call(fn, "ntt_", calls=3)
        print(f"  {case['name']}, {label}: {ms:.3f} ms (host clock, median of {REPS} after the "
              f"first); K2 {per_run} launches a run, device time {fmt_us(dev)} a run")
        device_view(lambda i: fn(), 3, "run", top=3)


def reuse_threshold(label: str, fn) -> None:
    """Both branches of `_REUSE_MIN_BATCH` at its batch, 32: JAX's threshold (the
    per-digit plans and the special limb alone in the division) against the
    small-batch branches everywhere.  Recorded only: the threshold stays 32."""
    saved, out, times = arith._REUSE_MIN_BATCH, {}, {}
    for branch, value in ((f"at JAX's threshold {saved}", saved),
                          ("small-batch branches", 1 << 30)):
        arith._REUSE_MIN_BATCH = value
        try:
            out[branch] = fn()
            times[branch] = (host_ms(fn, reps=REPS), device_us_per_call(fn, "ntt_", calls=3))
        finally:
            arith._REUSE_MIN_BATCH = saved
    a, b = out.values()
    check(torch.equal(a, b), f"{label}: the two branches give different integers")
    print(f"  _REUSE_MIN_BATCH, {label}: " + "; ".join(
        f"{branch} {ms:.3f} ms (host clock), K2 device time {fmt_us(dev)}"
        for branch, (ms, dev) in times.items()) + "; identical integers")


# ---------------------------------------------------------------------------
# The user path: the 8-command CLI and a BatchProcessor over one store.
# ---------------------------------------------------------------------------


def app_corpus(rng) -> tuple:
    """APP_DOCS texts of 20-60 words drawn by a Zipf law from a fixed
    APP_VOCAB-word vocabulary, and a sampler of more words."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = set()
    while len(vocab) < APP_VOCAB:
        vocab.add("".join(rng.choice(letters, int(rng.integers(3, 10)))))
    vocab = [str(w) for w in rng.permutation(sorted(vocab))]
    zipf = 1.0 / np.arange(1, APP_VOCAB + 1)
    zipf /= zipf.sum()

    def words(n: int) -> list:
        return [vocab[i] for i in rng.choice(APP_VOCAB, n, p=zipf)]
    texts = [" ".join(words(int(rng.integers(20, 61)))) for _ in range(APP_DOCS)]
    check(len(set(texts)) == APP_DOCS, "the corpus repeats a text")
    return texts, words


def app_queries(rng, texts: list, words) -> list:
    """APP_QUERIES queries: half perturbed copies of stored documents (a
    quarter of their words replaced), half new texts."""
    out = []
    for i in rng.choice(len(texts), APP_QUERIES // 2, replace=False):
        toks = texts[i].split()
        for j in rng.choice(len(toks), len(toks) // 4, replace=False):
            toks[j] = words(1)[0]
        out.append(" ".join(toks))
    return out + [" ".join(words(int(rng.integers(20, 61))))
                  for _ in range(APP_QUERIES - len(out))]


def run_cli(base: str, *args) -> tuple:
    """(stdout, host seconds) of one CLI command in process, as a cold start
    (a new FHEDocumentCLI and processor); fails unless it returns 0."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--storage-dir", f"{base}/docs", "--key-dir", f"{base}/keys",
                       "--preset", PRESET, *args], device=DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(rc == 0, f"`{' '.join(args)}` returned {rc}: {out.getvalue()[-400:]}")
    return out.getvalue(), dt


class AppOracle:
    """The store's scores in the clear: each text embedded by the port's
    hashing embedder, reduced by the store's persisted reducer, quantized
    by the contract; a score is the int64 dot product over scale^2."""

    def __init__(self, base: str, ids: list, texts: dict):
        self.reducer = DimensionReducer.load(f"{base}/docs/reducer.npz", device=DEVICE)
        self.emb = HashingEmbedder()
        self.ids = ids
        self.docs = np.stack([self.quantize(texts[i]) for i in ids])
        self.row = {d: k for k, d in enumerate(ids)}

    def quantize(self, text: str) -> np.ndarray:
        red = self.reducer.transform(self.emb.get_embedding(text))[0]
        return prepare_embedding_for_fhe(red, int(SCALE))[0].astype(np.int64)

    def search(self, query: str, top_k: int, min_similarity: float = -1.0) -> list:
        sims = (self.docs @ self.quantize(query)) / float(SCALE * SCALE)
        return [(self.ids[i], float(sims[i])) for i in np.argsort(-sims)
                if sims[i] >= min_similarity][:top_k]

    def compare(self, a: str, b: str) -> float:
        return float(self.docs[self.row[a]] @ self.docs[self.row[b]]) / (SCALE * SCALE)


def check_searches(proc, oracle, queries) -> list:
    """Every query's top-APP_TOP_K equal to the oracle's, ids and scores;
    host seconds of each search."""
    lat = []
    for qi, q in enumerate(queries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = proc.search_similar(q, top_k=APP_TOP_K, min_similarity=-1.0)
        lat.append(time.perf_counter() - t0)
        check(got == oracle.search(q, APP_TOP_K), f"user path query {qi}: top-{APP_TOP_K} "
              f"{got[:3]}... differs from the oracle's {oracle.search(q, APP_TOP_K)[:3]}...")
    return lat


def check_arena(proc) -> None:
    """The packed search read its operand from the current arena."""
    store = proc.storage
    arena_ids = json.loads((store.dir / "search.arena.ids").read_text())
    check(proc.operand_source == "arena" and (store.dir / "search.arena").exists()
          and store.arena_is_current() and proc._op_cache[1] == arena_ids
          and arena_ids == store.list_documents(),
          f"the search did not go through the current arena (source {proc.operand_source})")


def user_path(rng) -> dict:
    """Phase 7: the CLI's commands in order, then a BatchProcessor held as a
    server, on the card; every search and compare exact, before and after
    `keys rotate` re-keys the store."""
    phase(f"user path: the CLI and a BatchProcessor on {PRESET}, {APP_DOCS} documents, "
          f"{APP_QUERIES} queries")
    texts, words = app_corpus(np.random.default_rng(0))
    queries = app_queries(rng, texts, words)
    ids = [f"doc_{hashlib.sha256(t.encode()).hexdigest()[:12]}" for t in texts]
    by_id = dict(zip(ids, texts))
    t_cli, outs = {}, {}
    # The earlier phases' objects are frozen out of the collector: the CLI's
    # BatchConfig() forces gc.collect() on every batch while the process's
    # RSS is above 4000 MB, and a CLI process does not hold those objects.
    gc.freeze()
    print(f"  host RSS before the phase: {rss_mb():.0f} MB (BatchConfig's limit 4000 MB)")
    with tempfile.TemporaryDirectory() as base:
        os.environ["FHE_MASTER_PASSWORD"] = "chip-smoke-password"
        os.environ["HF_HOME"] = f"{base}/hf"       # no BERT weights: the hashing embedder
        with open(f"{base}/corpus.txt", "w") as f:
            f.write("\n".join(texts) + "\n")
        torch.cuda.synchronize()
        kernels.launches.clear()
        t_start = time.perf_counter()
        cmds = [("keys generate", ("keys", "generate")),
                ("encrypt-batch", ("encrypt-batch", f"{base}/corpus.txt")),
                ("encrypt --tags", ("encrypt", texts[0], "--id", ids[0], "--tags", "smoke",
                                    "user-path")),
                ("compare 1", ("compare", ids[1], ids[2])),
                ("compare 2", ("compare", ids[3], ids[3])),
                ("search", ("search", queries[0])),
                ("stats", ("stats",)), ("validate --deep", ("validate", "--deep")),
                ("estimate", ("estimate",))]
        for label, args in cmds:
            outs[label], t_cli[label] = run_cli(base, *args)
        print("  CLI, each command a cold start (host s): " + "; ".join(
            f"{k} {v:.3f}" for k, v in t_cli.items()), flush=True)
        stats = json.loads(outs["stats"])
        print(f"  encrypt-batch: {APP_DOCS / t_cli['encrypt-batch']:.1f} documents/s "
              f"({outs['encrypt-batch'].strip()}); store "
              f"{stats['storage']['total_size_bytes'] / 2 ** 20:.1f} MiB on disk")
        sorted_ids = sorted(ids)
        oracle = AppOracle(base, sorted_ids, by_id)
        for label, (a, b) in (("compare 1", ids[1:3]), ("compare 2", (ids[3], ids[3]))):
            check(f"Similarity score: {oracle.compare(a, b):.4f}\n" in outs[label],
                  f"CLI {label}: {outs[label]!r}, oracle {oracle.compare(a, b):.4f}")
        want = [f"{d}: {s:.4f}  ({cli.interpret_score(s)})"
                for d, s in oracle.search(queries[0], 5, 0.5)]
        check(outs["search"].splitlines()[:-1] == want and want,
              f"CLI search: {outs['search']!r}, oracle {want}")
        check(stats["storage"]["document_count"] == APP_DOCS, f"stats {stats}")
        check(f"Noise check: {APP_DOCS} healthy, 0 low-budget" in outs["validate --deep"],
              outs["validate --deep"])
        check(json.loads(outs["estimate"])["fits_memory_limit"], outs["estimate"])

        # A server: one processor, 8 queries and 8 compares, all exact.
        t0 = time.perf_counter()
        proc = BatchProcessor(storage_dir=f"{base}/docs", key_dir=f"{base}/keys",
                              preset=PRESET, device=DEVICE)
        t_proc = time.perf_counter() - t0
        check(isinstance(proc.embedder, HashingEmbedder), f"embedder {proc.embedder}")
        check(proc.storage.load(ids[0]).metadata == {"tags": ["smoke", "user-path"]},
              "encrypt --tags did not store the tags")
        lat = check_searches(proc, oracle, queries)
        check_arena(proc)
        pairs = [tuple(map(str, rng.choice(sorted_ids, 2, replace=False)))
                 for _ in range(APP_PAIRS)]
        cmp_lat = []
        for a, b in pairs:
            t0 = time.perf_counter()
            got = proc.compare_encrypted(a, b)
            cmp_lat.append(time.perf_counter() - t0)
            check(got == oracle.compare(a, b), f"compare {a} {b}: {got}, oracle "
                  f"{oracle.compare(a, b)}")
        print(f"  BatchProcessor start {t_proc:.3f} s; {APP_QUERIES} queries exact (top-"
              f"{APP_TOP_K} ids and scores == the clear oracle) through the arena; "
              f"{APP_PAIRS} compares exact; the CLI's 2 compares and its search exact")
        print(f"  search_similar (host clock): first {lat[0] * 1e3:.3f} ms (operand build "
              f"included), warm {statistics.median(lat[1:]) * 1e3:.3f} ms (median of "
              f"{len(lat) - 1})")
        print(f"  compare_encrypted (host clock, median of {APP_PAIRS - 1} after the first): "
              f"{statistics.median(cmp_lat[1:]) * 1e3:.3f} ms; first {cmp_lat[0] * 1e3:.3f} ms",
              flush=True)
        old_key = proc.key_id

        for label, args in (("keys rotate", ("keys", "rotate")),
                            ("search again", ("search", queries[0]))):
            outs[label], t_cli[label] = run_cli(base, *args)
        print(f"  keys rotate {t_cli['keys rotate']:.3f} s; search again "
              f"{t_cli['search again']:.3f} s", flush=True)
        check(f"Re-keyed {APP_DOCS} stored documents to" in outs["keys rotate"],
              outs["keys rotate"])
        check(outs["search again"].splitlines()[:-1] == want,
              f"CLI search after keys rotate: {outs['search again']!r}")
        after = BatchProcessor(storage_dir=f"{base}/docs", key_dir=f"{base}/keys",
                               preset=PRESET, device=DEVICE)
        check(after.key_id != old_key and all(
            e["key_id"] == after.key_id for e in after.storage.index.values()),
            "the store is not under the new key")
        lat_after = check_searches(after, oracle, queries)
        check_arena(after)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t_start
        launches = dict(kernels.launches)
        for name in APP_PATH_KERNELS:
            check(launches.get(name, 0) > 0, f"kernel {name} not launched on the user path")
        print(f"  after keys rotate: {APP_QUERIES} queries exact through the re-exported "
              f"arena; search_similar first {lat_after[0] * 1e3:.3f} ms, warm "
              f"{statistics.median(lat_after[1:]) * 1e3:.3f} ms")
        print(f"  launches on the user path: {launches}; path {t_path:.2f} s", flush=True)
        rekeyed_compares(after, oracle, sorted_ids, rng)
        app_times(after, queries)
    gc.unfreeze()
    return dict(launches=launches)


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2 ** 20


def rekeyed_compares(proc, oracle, ids, rng) -> None:
    """Recorded, not checked: re-keying costs each pairwise-4096 document
    2-3 of its ~35 bits of noise budget and a degree-2 product of fresh
    documents keeps 3-4, so some re-keyed pairs compare wrong, in the JAX
    package alike (the same integers).  The count of exact compares among
    REKEYED_PAIRS random pairs of the re-keyed store."""
    pairs = [tuple(map(str, rng.choice(ids, 2, replace=False))) for _ in range(REKEYED_PAIRS)]
    exact = sum(proc.compare_encrypted(a, b) == oracle.compare(a, b) for a, b in pairs)
    print(f"  compare after keys rotate (recorded, a fault of the reference's re-keying at "
          f"this preset): {exact} of {REKEYED_PAIRS} random pairs exact")


def app_times(proc, queries) -> None:
    """The arena export and the operand build alone, K1 at the store's
    groups, and the card's view of 8 warm searches."""
    store = proc.storage
    t0 = time.perf_counter()
    store.export_arena()
    t_export = time.perf_counter() - t0
    level = store.load(store.list_documents()[0]).ct_level
    builds = []
    for _ in range(3):
        proc._op_cache = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        doc_op = proc._search_operands(level)[1]
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    check_arena(proc)
    print(f"  export_arena ({len(store.list_documents())} documents, "
          f"{os.path.getsize(store.dir / 'search.arena') / 2 ** 20:.1f} MiB) {t_export:.3f} s; "
          f"operand build (arena read, copy to the card, pack, mod_switch, digits; median of 3) "
          f"{statistics.median(builds):.3f} s, {doc_op.groups} groups")
    pack_score_timing(doc_op.groups)
    device_view(lambda i: proc.search_similar(queries[i], top_k=APP_TOP_K, min_similarity=-1.0),
                len(queries), "search")


# ---------------------------------------------------------------------------
# Phase 8: the rest of the package (fastdot, the pipeline, multi-host search,
# the four-step int8 NTT, profiling).  Its modules are imported where they
# are used: `--k2-times DIR` imports an earlier tree's package, which lacks them.
# ---------------------------------------------------------------------------

PIPE_MICRO = 8                     # microbatches of the pipelined scoring
RING_FASTDOT_DOCS = 256
MXU_BATCH, MXU_N1 = 256, 128       # the four-step NTT's batch and N1 (JAX's config 6)
WORKERS, WORKER_TIMEOUT_S = 2, 300
LOOP_K = (4, 20)                   # measure_ondevice_loop's short and long runs
# K2 in this process (encryption, the query operands); K1 only in the
# workers' search: this process launches K1 only for its oracles and times.
REST_PATH_KERNELS = ("ntt_fwd",)
WORKER_KERNELS = ("pack_score",)


def rest_of_package(rng, store: dict, shard_store: dict) -> dict:
    """Phase 8, counts zeroed before (a)-(e) and read after, the oracles'
    and timings' launches left out; then (f)'s times.  Its launches are this
    process's and the workers' together."""
    phase(f"the rest of the package: fastdot over {len(store['docs'])} per-document "
          f"ciphertexts and at {RING}, the pipeline, {WORKERS} worker processes, the "
          f"four-step int8 NTT")
    torch.cuda.synchronize()
    kernels.launches.clear()
    t_start = time.perf_counter()
    packed = fastdot_store(store)
    torch.cuda.empty_cache()
    fastdot_ring(rng)
    pipelined(store, packed)
    torch.cuda.empty_cache()
    worker_launches = multihost_workers(shard_store)
    four_step_ntt(rng, store["rt"].ctx)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name in REST_PATH_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} not launched in phase 8")
    print(f"  launches in phase 8: this process {launches}, its oracles and timings left "
          f"out; the workers {worker_launches}; {time.perf_counter() - t_start:.2f} s")
    loop_times(rng, store, packed)
    print(f"  phase 8, its times included: {time.perf_counter() - t_start:.2f} s")
    for name, n in worker_launches.items():
        launches[name] = launches.get(name, 0) + n
    return dict(launches=launches)


def fastdot_store(store: dict):
    """(a) Phase 3's documents as per-document ciphertexts (its keys, seeds and
    queries) scored by fastdot: every score == docs @ query and == phase 3's
    packed scores (K1), every top-10 the oracle's; then the same operand on 8
    dp shards.  Returns phase 3's packed doc operand."""
    from fhe_icp_tpu_torch.ops import fastdot
    from fhe_icp_tpu_torch.parallel.mesh import DOC_OPERAND_SPEC
    from fhe_icp_tpu_torch.parallel.search import make_sharded_fastdot_search
    rt, ct, docs, queries = store["rt"], store["ct"], store["docs"], store["queries"]
    ctx, sk = rt.ctx, rt.keys.sk
    n, level = len(docs), ctx.n_limbs
    t0 = time.perf_counter()
    digits = torch.empty((level, fastdot.N_DIGITS, n, 2 * ctx.n), dtype=torch.int8,
                         device=DEVICE)
    for i in range(0, n, ENC_BATCH):
        cts = rt.encrypt_vector(docs[i: i + ENC_BATCH], seed=1 + i)
        digits[:, :, i: i + ENC_BATCH] = fastdot.make_doc_operand(ctx, cts.data, level).digits
    dop = fastdot.DocOperand(digits, level)
    packed = pack.make_packed_doc_operand(ctx, ct.data, ct.level)
    torch.cuda.synchronize()
    print(f"  DocOperand {tuple(digits.shape)} int8, {digits.numel() / 2 ** 30:.2f} GiB, "
          f"encrypted and built in {time.perf_counter() - t0:.3f} s")
    want_all = docs.astype(np.int64) @ queries.astype(np.int64).T
    lat, lat_k1 = [], []
    for qi, q in enumerate(queries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_op = fastdot.make_query_operand(ctx, sk, torch.from_numpy(q), DIM, level)
        scores = fastdot.scores(ctx, dop, q_op)
        top = torch.topk(scores, TOP_K)
        top_vals = top.values.cpu()
        lat.append(time.perf_counter() - t0)
        with uncounted():
            t0 = time.perf_counter()
            pq = pack.make_packed_query_operand(ctx, sk, torch.from_numpy(q), DIM, ct.level)
            k1 = pack.packed_scores(ctx, packed, pq, ct.pt_corr).reshape(-1)
            torch.topk(k1, TOP_K).values.cpu()
            lat_k1.append(time.perf_counter() - t0)
        got, want = scores.cpu().numpy().astype(np.int64), want_all[:, qi]
        check(got.shape == want.shape and (got == want).all(),
              f"fastdot query {qi}: {(got != want).sum()} scores differ from docs @ query")
        check((k1.cpu().numpy() == got).all(), f"fastdot query {qi}: differs from K1's scores")
        check(sorted(top_vals.tolist()) == sorted(np.sort(want)[-TOP_K:].tolist())
              and (want[top.indices.cpu().numpy()] == top_vals.numpy()).all(),
              f"fastdot query {qi}: top-{TOP_K} differs from the oracle's")
    print(f"  (a) {len(queries)} fastdot queries exact (scores == docs @ query == K1's packed "
          f"scores, top-{TOP_K}); query latency (operand + scores + top-{TOP_K}, host clock, "
          f"median of {len(lat) - 1} after the first) {statistics.median(lat[1:]) * 1e3:.3f} ms, "
          f"first {lat[0] * 1e3:.3f} ms; K1's packed query on the same documents "
          f"{statistics.median(lat_k1[1:]) * 1e3:.3f} ms")
    a2 = digits.reshape(level, fastdot.N_DIGITS * n, -1)
    v2 = q_op.digits.transpose(1, 2)
    vpad = torch.zeros((level, 2 * ctx.n, 8), dtype=torch.int8, device=DEVICE)
    vpad[:, :, :fastdot.N_DIGITS] = v2
    mm = cuda_ms(lambda: pack_cuda.int_mm(a2, v2))
    lib = cuda_ms(lambda: [torch._int_mm(a2[i], vpad[i]) for i in range(level)])
    byts = a2.numel() + v2.numel() + level * a2.shape[1] * fastdot.N_DIGITS * 4
    bound_ms, _, why = bound(byts, 2 * a2.numel() * fastdot.N_DIGITS, peaks().int8_tops * 1e12)
    fd = cuda_ms(lambda: fastdot.scores(ctx, dop, q_op))
    k1 = cuda_ms(lambda: pack.packed_scores(ctx, packed, pq, ct.pt_corr))
    print(f"  (a) int8 product ({level} x ({a2.shape[1]}, {a2.shape[2]}) x ({a2.shape[2]}, 4 "
          f"padded to 8)), CUDA events: int_mm {mm:.4f} ms, {level} x torch._int_mm alone "
          f"{lib:.4f} ms, bound {bound_ms:.4f} ms ({why}; {byts / 1e9:.3f} GB); "
          f"fastdot.scores {fd:.4f} ms; K1's packed_scores on the same documents {k1:.4f} ms")
    device_view(lambda i: fastdot.scores(ctx, dop, q_op), 3, "fastdot.scores", top=5)

    mesh = make_mesh(N_SHARDS, (N_SHARDS, 1), DEVICE)
    shards = shard(mesh, digits, DOC_OPERAND_SPEC)
    del dop, digits, a2
    step = make_sharded_fastdot_search(ctx, mesh, top_k=TOP_K)
    lat = []
    for qi, q in enumerate(queries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_op = fastdot.make_query_operand(ctx, sk, torch.from_numpy(q), DIM, level)
        scores, vals, idx = step(shards, q_op.digits)
        vals, idx = vals.cpu().numpy().astype(np.int64), idx.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        got, want = scores.cpu().numpy().astype(np.int64), want_all[:, qi]
        check((got == want).all(), f"sharded fastdot query {qi}: {(got != want).sum()} scores "
              "differ from docs @ query")
        check(sorted(vals.tolist()) == sorted(np.sort(want)[-TOP_K:].tolist())
              and (want[idx] == vals).all(),
              f"sharded fastdot query {qi}: top-{TOP_K} differs from the oracle's")
    print(f"  (a) the same documents on {N_SHARDS} dp shards (make_sharded_fastdot_search): "
          f"{len(queries)} queries exact; latency {statistics.median(lat[1:]) * 1e3:.3f} ms "
          f"(host clock, median of {len(lat) - 1} after the first)")
    return packed


def fastdot_ring(rng) -> None:
    """(b) Fastdot at ring-16384 (12 limbs, 2N = 32768, three digit pairs a
    fold group), exact; the fold on adversarial partials equal to integers."""
    from fhe_icp_tpu_torch.ops import fastdot
    rt = runtime(RING, (12,))
    if rt.keys is None:
        rt.generate_keys(seed=0)
    ctx, l = rt.ctx, rt.ctx.n_limbs
    docs = quantized_unit(rng, (RING_FASTDOT_DOCS, DIM))
    queries = quantized_unit(rng, (2, DIM))
    dop = fastdot.make_doc_operand(ctx, rt.encrypt_vector(docs, seed=12).data, l)
    lat = []
    for qi, q in enumerate(queries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = fastdot.scores(ctx, dop, fastdot.make_query_operand(
            ctx, rt.keys.sk, torch.from_numpy(q), DIM, l)).cpu().numpy()
        lat.append(time.perf_counter() - t0)
        want = docs.astype(np.int64) @ q.astype(np.int64)
        check((scores.astype(np.int64) == want).all(),
              f"{RING} fastdot query {qi}: {(scores != want).sum()} scores differ")
    k_len = 2 * ctx.n
    part = rng.choice([-1, 1], size=(l, 4, 64, 4)) * (128 * 128 * k_len)
    part[:, :, 0], part[:, :, 1] = 128 * 128 * k_len, -128 * 128 * k_len
    got = fastdot.fold_digit_products(ctx, torch.from_numpy(part.astype(np.int32)).to(DEVICE),
                                      l, k_len).cpu().numpy()
    want = np.array([[sum(int(part[li, i, m, j]) << (8 * (i + j)) for i in range(4)
                          for j in range(4)) % p for m in range(part.shape[2])]
                     for li, p in enumerate(ctx.primes[:l])])
    check((got.astype(np.int64) == want).all(), "fold of adversarial partials on the card")
    print(f"  (b) {RING} (L={l}, 2N={k_len}): {RING_FASTDOT_DOCS} documents x {len(queries)} "
          f"queries exact ({max(lat) * 1e3:.3f} ms a query at most, host clock); the fold of "
          f"+-2^29 partials (3 pairs a group) on the card == exact integers")


def pipelined(store: dict, packed) -> None:
    """(c) make_pipelined_scores on a 2-shard pp mesh over phase 3's packed
    operand, bit-equal to packed_scores (K1) for every query; times beside K1."""
    from fhe_icp_tpu_torch.parallel.pipeline import make_pipelined_scores, make_pp_mesh
    rt, ct, docs, queries = store["rt"], store["ct"], store["docs"], store["queries"]
    ctx, sk = rt.ctx, rt.keys.sk
    slots = pack.slots_per_ct(ctx.n, DIM)
    mesh = make_pp_mesh(2, DEVICE)
    fn = make_pipelined_scores(ctx, mesh, ct.level, slots, PIPE_MICRO)
    for qi, q in enumerate(queries):
        pq = pack.make_packed_query_operand(ctx, sk, torch.from_numpy(q), DIM, ct.level)
        got = fn(packed.digits, pq.digits, ct.pt_corr)
        with uncounted():
            want = pack.packed_scores(ctx, packed, pq, ct.pt_corr)
        check(torch.equal(got.cpu(), want.cpu()), f"pipeline query {qi}: differs from K1's")
        check((got.reshape(-1).cpu().numpy().astype(np.int64)
               == docs.astype(np.int64) @ q.astype(np.int64)).all(),
              f"pipeline query {qi}: differs from docs @ query")
    ms = cuda_ms(lambda: fn(packed.digits, pq.digits, ct.pt_corr))
    k1 = cuda_ms(lambda: pack.packed_scores(ctx, packed, pq, ct.pt_corr))
    print(f"  (c) pipeline (2 stages on {', '.join(map(str, mesh.devices))}, {PIPE_MICRO} "
          f"microbatches of {4 * packed.groups // PIPE_MICRO} rows): {len(queries)} queries "
          f"bit-equal to packed_scores and docs @ query; {ms:.4f} ms against K1's "
          f"packed_scores {k1:.4f} ms (CUDA events)")
    device_view(lambda i: fn(packed.digits, pq.digits, ct.pt_corr), 3, "pipelined scores", top=5)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_workers(shard_store: dict) -> dict:
    """(d) WORKERS processes on this card, joined over gloo on 127.0.0.1: each
    encrypts its half of phase 4's store (keys from seed 0), searches it with
    K1 and merges; both must print the oracle's exact global top-10.  The
    workers load the kernel library phase 1 built and must not rebuild it.
    Returns the workers' launch counts, summed."""
    from fhe_icp_tpu_torch.parallel import multihost
    docs, queries = shard_store["docs"], shard_store["queries"]
    slots = pack.slots_per_ct(get_params(PRESET).n, DIM)
    groups = -(-len(docs) // slots)
    groups += -groups % PAD_GROUPS
    lib_mtime = kernels.LIB_PATH.stat().st_mtime_ns
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "store.npz")
        np.savez(path, docs=docs, queries=queries)
        coord = f"127.0.0.1:{free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "fhe_icp_tpu_torch.parallel.multihost", coord, str(WORKERS),
             str(pid), "--store", path, "--preset", PRESET, "--pad-groups", str(PAD_GROUPS),
             "--top-k", str(TOP_K), "--device", DEVICE],
            cwd=TREE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(WORKERS)]
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    wall = time.perf_counter() - t0
    recs = {}
    for rc, out, err in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        check(rc == 0 and bool(line), f"worker failed (rc={rc}): {out[-1000:]} {err[-3000:]}")
        rec = json.loads(line[-1][len("RESULT "):])
        recs[rec["pid"]] = rec
    check(sorted(recs) == list(range(WORKERS)), f"workers {sorted(recs)}")
    shards = multihost.partition_groups(groups, WORKERS)
    for qi, q in enumerate(queries):
        truth = docs.astype(np.int64) @ q.astype(np.int64)
        vals, idx = multihost.merge_topk(
            [multihost.local_topk(truth[s.start * slots: min(s.stop * slots, len(docs))], TOP_K,
                                  index_offset=s.start * slots) for s in shards], TOP_K)
        check(np.array_equal(vals, np.sort(truth)[::-1][:TOP_K]), "the oracle's own merge")
        for pid, rec in recs.items():
            check(rec["ok"] and rec["queries"][qi] == {"vals": vals.tolist(), "idx": idx.tolist()},
                  f"worker {pid}, query {qi}: {rec['queries'][qi]} is not the oracle's top-"
                  f"{TOP_K}")
    for pid, rec in recs.items():
        for name in WORKER_KERNELS:
            check(rec["launches"].get(name, 0) > 0, f"worker {pid} did not launch {name}")
        check(rec["shard"] == [shards[pid].start, shards[pid].stop], f"worker {pid} shard")
    check(kernels.LIB_PATH.stat().st_mtime_ns == lib_mtime, "a worker rebuilt the kernels")
    print(f"  (d) {WORKERS} worker processes (gloo on 127.0.0.1), groups "
          + ", ".join(f"{r['shard']}" for r in recs.values())
          + f" of {groups}: each printed the oracle's exact global top-{TOP_K} for "
          f"{len(queries)} queries; wall {wall:.2f} s; build (keys, encrypt, pack, operand) "
          + ", ".join(f"{r['build_s']:.3f}" for r in recs.values()) + " s; query (host clock, "
          "median) " + ", ".join(f"{statistics.median(r['query_ms'][1:]):.3f}"
                                 for r in recs.values())
          + " ms; K1 launches " + ", ".join(str(r["launches"].get("pack_score"))
                                            for r in recs.values())
          + "; the kernel library was not rebuilt")
    total: dict = {}
    for rec in recs.values():
        for name, n in rec["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def four_step_ntt(rng, ctx) -> None:
    """(e) ntt_fwd_mxu at pairwise-4096 on MXU_BATCH polynomials, bit-equal to
    K2's forward after the bit-reversal; its time against K2's."""
    from fhe_icp_tpu_torch.ops.cipher import bitrev
    from fhe_icp_tpu_torch.ops.ntt_mxu import ntt_fwd_mxu
    x = random_residues(rng, ctx.plan, (MXU_BATCH, ctx.n_limbs, ctx.n))
    brv = torch.from_numpy(bitrev(ctx.n)).to(DEVICE)
    got = ntt_fwd_mxu(ctx, x, n1=MXU_N1)
    with uncounted():
        e = max_abs_err(got, ntt_cuda.ntt_fwd(ctx.plan, x).to(torch.int64)[..., brv])
    check(e == 0, f"ntt_fwd_mxu differs from K2's forward: max abs err {e}")
    mxu = cuda_ms(lambda: ntt_fwd_mxu(ctx, x, n1=MXU_N1))
    k2 = cuda_ms(lambda: ntt_cuda.ntt_fwd(ctx.plan, x))
    print(f"  (e) ntt_fwd_mxu ({PRESET}, {MXU_BATCH} x {ctx.n_limbs} x {ctx.n}, N1={MXU_N1}, "
          f"N2={ctx.n // MXU_N1}) bit-equal to K2's forward after the bit reversal; "
          f"{mxu:.4f} ms against K2 {k2:.4f} ms (CUDA events), {mxu / k2:.1f}x")


def loop_times(rng, store: dict, packed) -> None:
    """(f) utils/profiling.measure_ondevice_loop on phase 3's query and on K2 at
    16,384 rows, beside CUDA events around one call."""
    from fhe_icp_tpu_torch.utils.profiling import measure_ondevice_loop
    rt, ct = store["rt"], store["ct"]
    ctx, sk = rt.ctx, rt.keys.sk
    q = torch.from_numpy(store["queries"][0])

    def query(tok):
        pq = pack.make_packed_query_operand(ctx, sk, q, DIM, ct.level)
        return tok + pack.packed_scores(ctx, packed, pq, ct.pt_corr)[0, 0] * 0

    x = random_residues(rng, ctx.plan, (ENC_BATCH, ctx.n_limbs, ctx.n))

    def k2(tok):
        ntt_cuda.ntt_fwd(ctx.plan, x)
        return tok

    tok = torch.zeros((), dtype=torch.int32, device=DEVICE)
    for label, body in (("a packed query (operand + K1 + decode)", query),
                        (f"K2 forward at {ENC_BATCH * ctx.n_limbs} rows", k2)):
        loop = measure_ondevice_loop(body, *LOOP_K, reps=5, device=DEVICE)
        one = cuda_ms(lambda: body(tok))
        print(f"  (f) {label}: measure_ondevice_loop {loop['ms']:.4f} ms a step (slope of "
              f"{LOOP_K[0]} and {LOOP_K[1]} back-to-back steps, median of 5, spread "
              f"{loop['spread']:.3f}); CUDA events around one call {one:.4f} ms")


def cross_card(rng) -> None:
    """The shards spread over every visible card: K3 through peer pointers.

    Runs only where more than one card is visible (skipped on one card):
    K3 against its plain version across cards, the ring-16384 four-step
    NTT across cards against the single-card K2, a sharded packed search
    across cards against docs @ query, and K3's times beside the NVLink
    bound.
    """
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"== cross-card exchange: skipped ({cards} card visible)")
        return
    phase(f"cross-card exchange: {N_SHARDS} shards round-robin on {cards} cards")
    sp = make_mesh(N_SHARDS, (N_SHARDS,), DEVICE, axes=(SP_AXIS,))
    print("  shards on: " + ", ".join(f"{i}:{dev}" for i, dev in enumerate(sp.devices)))
    n_l, n2 = len(get_params(RING).primes), get_params(RING).n // RING_N1
    for shape, split, concat in (((n_l, RING_N1 // N_SHARDS, n2), 2, 1),
                                 ((n_l, RING_N1, n2 // N_SHARDS), 1, 2), ((3, 8, 5), 1, 2)):
        xs = [x.to(dev) for x, dev in zip(ring_shards(rng, N_SHARDS, shape), sp.devices)]
        got = ici.all_to_all(xs, split, concat)
        want = ici.all_to_all_ref(xs, split, concat)
        check(all(g.device == x.device for g, x in zip(got, xs)), "outputs left their cards")
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        check(e == 0, f"cross-card all_to_all {shape} split {split}: {e}")
    print("  all_to_all across cards at both ring-16384 exchanges and an odd chunk: bit-exact")
    case = ring_ntt_case(rng)
    ring_sharded_ntt(case)
    sharded_search(quantized_unit(rng, (8000, DIM)), quantized_unit(rng, (2, DIM)))
    time_exchange(random_flats(sp.devices, n2, n_l * RING_N1 // N_SHARDS),
                  f"at the {RING} exchange")
    time_exchange(random_flats(sp.devices, 2048, 4096), "at 256 MiB")


@functools.lru_cache(maxsize=None)
def peaks():
    """The card's published peaks (NVIDIA data sheet, at its full power limit)
    from the port's table, `utils/profiling.CARD_SPECS`; fails on a card the
    table lacks.  Imported here: `--k2-times` loads trees without the module."""
    from fhe_icp_tpu_torch.utils import profiling
    spec = profiling.card_spec()
    check(spec is not None, f"utils/profiling.CARD_SPECS has no peaks for "
          f"{torch.cuda.get_device_name(0)}")
    return spec


def bound(byts: float, ops: float, ops_per_s: float) -> tuple:
    """(ms, kind, text): the least time the card could take, and what sets it."""
    t_b, t_o = byts / (peaks().hbm_gbs * 1e9) * 1e3, ops / ops_per_s * 1e3
    kind = "bytes" if t_b >= t_o else "operations"
    return max(t_b, t_o), kind, f"set by {kind}: bytes {t_b:.4f} ms, operations {t_o:.4f} ms"


def timings(rng, errs: dict, launches: dict, smi: str) -> list:
    phase(f"times on {smi} (CUDA events, median of repeats)")
    out = k2_timings(rng)
    slots = pack.slots_per_ct(get_params(PRESET).n, DIM)
    out.append(pack_score_timing(N_DOCS // slots))
    # One shard of the multi-shard store: 3125 groups padded to 3128, over 8.
    pack_score_timing(-(-N_DOCS_SHARDED // slots // PAD_GROUPS) * PAD_GROUPS // N_SHARDS)
    out.append(all_to_all_timings())
    for row in out:
        src, rep = KERNELS[row["name"]]
        row.update(route="cuda", source=src, replaces=rep,
                   launches=launches.get(row["name"], 0), max_abs_err=errs[row["name"]])
    return out


# K2's timed shapes, as the paths launch it: (what, primes, batch shape, N).
K2_SHAPES = (("an encrypt batch", "two", (ENC_BATCH, 2), 4096),
             ("a query's rows", "two", (2,), 4096),
             (f"a {RING} polynomial", "ring", (12,), 16384),
             (f"one shard's transform at {RING}", "ring",
              (get_params(RING).n // RING_N1 // N_SHARDS, 12), RING_N1))


def k2_times(rng) -> list:
    """K2 at the paths' shapes: CUDA events around the wrapper and device time
    per call (torch.profiler), one dict per entry and shape.

    The forward and inverse at one 8192-document encrypt batch (16,384 rows
    x N = 4096), a query's 2 rows and one ring-16384 polynomial (12 limbs x
    16384); the cyclic entries at one shard's four-step transform (192 rows
    x 128).  Uses only what every tree of the port has, so that --k2-times
    times an earlier tree the same way.
    """
    primes = {"two": pr.ntt_primes(2, bits=31), "ring": get_params(RING).primes}
    out = []
    for what, which, lead, n in K2_SHAPES:
        l = lead[-1]
        plan = build_plan(n, primes[which][:l], DEVICE)
        x = random_residues(rng, plan, lead + (n,))
        for name, kern, ref in NTT_ENTRIES[2:] if n == RING_N1 else NTT_ENTRIES[:2]:
            ms = cuda_ms(lambda: kern(plan, x), reps=20)
            dev = device_us_per_call(lambda: kern(plan, x), "ntt_", calls=20)
            out.append(dict(name=name, what=what, rows=x.numel() // n, l=l, n=n, ms=ms,
                            dev_us=dev, plan=plan, x=x, kern=kern, ref=ref))
    return out


def k2_timings(rng) -> list:
    """K2's times (`k2_times`), each checked bit-exact on the inputs it was
    timed on, beside its launch, its plain version and its bound.

    The bound counts each row read and written once plus the limbs' tables
    (4N words a limb, 2N for the cyclic entries), and three 32-bit
    multiplies per Shoup product (N/2 log2 N butterflies, and N twists a
    row but for the cyclic entries).  The JSON rows: the forward and
    inverse at one encrypt batch, the cyclic entries at one shard.
    """
    out = []
    for t in k2_times(rng):
        name, plan, x, rows, l, n = t["name"], t["plan"], t["x"], t["rows"], t["l"], t["n"]
        e = max_abs_err(t["kern"](plan, x), t["ref"](plan, x))
        check(e == 0, f"{name} {rows} rows x N={n} (the timed inputs): max abs err {e}")
        twisted = not name.startswith("ntt_cyclic")
        bound_ms, kind, why = bound(2 * rows * n * 4 + l * (4 if twisted else 2) * n * 4,
                                    3 * rows * (n // 2 * plan.log_n + (n if twisted else 0)),
                                    peaks().int32_mul_tops * 1e12)
        plain = cuda_ms(lambda: t["ref"](plan, x), reps=3, warmup=1)
        s = ntt_cuda.launch_shape(rows, l, n)
        print(f"  {name} {rows} rows x N={n} ({t['what']}; {s.regime}, R={s.rows_per_block}, "
              f"C={s.cluster}, {s.blocks} blocks of {s.threads}): {t['ms']:.4f} ms (CUDA "
              f"events around the wrapper; device time per call {fmt_us(t['dev_us'])}); "
              f"bit-exact; plain {plain:.3f} ms; bound {bound_ms:.5f} ms ({why})")
        if rows == ENC_BATCH * 2 or not twisted:
            out.append(dict(name=name, ms=t["ms"], plain_ms=plain, bound_ms=bound_ms,
                            bound_by=kind, library_ms=None))
    return out


def k2_only(tree: str) -> None:
    """--k2-times: K2's times at the paths' shapes, one JSON line each."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = card()
    for t in k2_times(np.random.default_rng(0)):
        print(json.dumps({"tree": tree, "entry": t["name"], "rows": t["rows"], "limbs": t["l"],
                          "n": t["n"], "ms": t["ms"], "device_us": t["dev_us"], "card": smi}),
              flush=True)


def pack_score_timing(g: int) -> dict:
    """K1 on G groups of the slice's preset: the wrapper, the device, the yardstick."""
    ctx = CryptoContext(get_params(PRESET), DEVICE)
    slots, k = pack.slots_per_ct(ctx.n, DIM), 2 * ctx.n
    a = torch.randint(-128, 128, (2, 4 * g, k), dtype=torch.int8, device="cuda")
    v = torch.randint(-128, 128, (2, k, 4 * slots), dtype=torch.int8, device="cuda")
    ms = cuda_ms(lambda: pack_cuda.packed_score_residues(ctx, a, v, 2, slots), reps=20)
    # Both of the entry point's kernels (the query transpose, then the product
    # and fold), and the second alone.
    dev = device_us_per_call(lambda: pack_cuda.packed_score_residues(ctx, a, v, 2, slots),
                             "pack_score")
    dev_main = device_us_per_call(lambda: pack_cuda.packed_score_residues(ctx, a, v, 2, slots),
                                  "pack_score_kernel")
    plain = cuda_ms(lambda: pack_cuda.packed_score_residues_ref(ctx, a, v, 2, slots),
                    reps=3, warmup=1)
    lib = cuda_ms(lambda: [torch._int_mm(a[i], v[i]) for i in range(2)], reps=20)
    byts = a.numel() + v.numel() + 2 * 4 * 4 * slots * 4 + 2 * 8 * 4 + 2 * g * slots * 4
    ops = 2 * a.shape[0] * a.shape[1] * k * v.shape[2]
    bound_ms, kind, why = bound(byts, ops, peaks().int8_tops * 1e12)
    splits = pack_cuda.k_splits(2, g, k, 4 * slots)
    print(f"  pack_score G={g} (L=2, 2N={k}, 4S={4 * slots}, {splits} K slices): {ms:.4f} ms "
          f"(CUDA events around the wrapper; device time per call {fmt_us(dev)}, of which the "
          f"product and fold {fmt_us(dev_main)}); plain {plain:.3f} ms; 2x torch._int_mm "
          f"{lib:.4f} ms; bound {bound_ms:.4f} ms ({why}; {byts / 2 ** 20:.1f} MiB, "
          f"{ops / 1e9:.2f} G int8 ops)")
    return dict(name="pack_score", ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=kind,
                library_ms=lib)


def device_us_per_call(fn, kernel: str, calls: int = 10):
    """Device time per fn() of the kernels whose name holds `kernel` (torch.profiler),
    or None if none was recorded."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    return sum(spans) / calls if spans else None


def fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f} us"


def exchange_bound(flats) -> tuple:
    """(ms, kind, text): each element read once and written once on its card,
    and the off-card share over NVLink at 450 GB/s each way per card."""
    d = len(flats)
    chunk = flats[0].numel() // d * 4
    hbm, sent, recv = {}, {}, {}
    for s, x in enumerate(flats):
        hbm[x.device] = hbm.get(x.device, 0) + 2 * d * chunk      # its input and its output
        for j, y in enumerate(flats):
            if y.device != x.device:
                sent[x.device] = sent.get(x.device, 0) + chunk
                recv[y.device] = recv.get(y.device, 0) + chunk
    t_hbm = max(hbm.values()) / (peaks().hbm_gbs * 1e9) * 1e3
    t_link = (max([max(sent.get(c, 0), recv.get(c, 0)) for c in hbm])
              / (peaks().nvlink_gbs * 1e9) * 1e3)
    return (max(t_hbm, t_link), "bytes",
            f"set by bytes: device memory {t_hbm:.5f} ms, NVLink {t_link:.5f} ms")


def time_exchange(flats, label: str) -> dict:
    """The kernel, its plain version and one strided copy_ on the same shards."""
    d = len(flats)
    rows, w = flats[0].shape
    ms = cuda_ms(lambda: ici.exchange(flats), reps=20)
    plain = cuda_ms(lambda: ici.all_to_all_ref(flats, 0, 0), reps=10)
    lib = None
    if len({x.device for x in flats}) == 1:
        # One copy_ from the stacked input's transposed (D, D, c, W) view;
        # the stacking is not timed.  int32 views: the same bits.
        inp = torch.stack(flats).view(torch.int32).view(d, d, rows // d, w)
        res = torch.empty_like(inp)
        lib = cuda_ms(lambda: res.copy_(inp.transpose(0, 1)), reps=20)
        # The same copy_ into a tensor it allocates, as the kernel's wrapper does.
        alloc = cuda_ms(lambda: torch.empty_like(inp).copy_(inp.transpose(0, 1)), reps=20)
        got = ici.exchange(flats)
        check(all(max_abs_err(res[j].reshape(rows, w).view(torch.uint32), got[j]) == 0
                  for j in range(d)), "the yardstick copy_ computes another function")
    bound_ms, kind, why = exchange_bound(flats)
    total = sum(x.numel() for x in flats) * 4
    dev = device_us_per_call(lambda: ici.exchange(flats), "all_to_all_kernel")
    cards = len({x.device for x in flats})
    print(f"  all_to_all {label}: {d} shards x ({rows}, {w}) uint32, {total / 2 ** 20:.2f} MiB on "
          f"{cards} card(s): {ms:.4f} ms ({cards} launch(es), one per card, "
          f"{2 * total / ms / 1e9:.3f} TB/s read + written; device time per exchange "
          f"{fmt_us(dev)}); "
          f"plain {plain:.4f} ms; copy_ "
          + ("n/a (shards on several cards)" if lib is None
             else f"{lib:.4f} ms (into a new tensor {alloc:.4f} ms)")
          + f"; bound {bound_ms:.5f} ms ({why})")
    return dict(name="all_to_all", ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=kind,
                library_ms=lib)


def all_to_all_timings() -> dict:
    """K3 at the ring-16384 exchange (the path's shape, in the JSON line) and at 256 MiB."""
    mesh = make_mesh(N_SHARDS, (N_SHARDS,), DEVICE, axes=(SP_AXIS,))
    l, n2 = len(get_params(RING).primes), get_params(RING).n // RING_N1
    # The first exchange of the forward transform: (L, N1/D, N2) shards with
    # the split axis N2 moved to the front, (N2, L * N1/D).
    path = time_exchange(random_flats(mesh.devices, n2, l * RING_N1 // N_SHARDS),
                         f"at the {RING} exchange")
    xs = [x.reshape(l, RING_N1 // N_SHARDS, n2)
          for x in random_flats(mesh.devices, l * RING_N1 // N_SHARDS, n2)]
    ms = cuda_ms(lambda: ici.all_to_all(xs, 2, 1), reps=20)
    print(f"  all_to_all with its reshapes (the path's call, rows -> columns): {ms:.4f} ms")
    time_exchange(random_flats(mesh.devices, 2048, 4096), "at 256 MiB")
    return path


def main() -> None:
    logging.basicConfig(level=logging.WARNING)
    smi = device_and_build()
    rng = np.random.default_rng(0)
    errs = kernels_vs_plain(rng)
    run = main_path(rng)
    # The main path's store went with its frame; return its memory before
    # the multi-shard path builds its own.
    torch.cuda.empty_cache()
    shard_run = multi_shard_path(rng)
    store = run.pop("store")
    compare_run = compare_path(rng, store)
    torch.cuda.empty_cache()
    app_run = user_path(rng)
    torch.cuda.empty_cache()
    rest_run = rest_of_package(rng, store, shard_run)
    torch.cuda.empty_cache()
    cross_card(rng)
    launches = {**run["launches"],
                **{k: shard_run["launches"].get(k, 0) for k in ("all_to_all", "ntt_cyclic_fwd",
                                                                "ntt_cyclic_inv")}}
    for k in COMPARE_PATH_KERNELS:
        launches[k] = launches.get(k, 0) + compare_run["launches"].get(k, 0)
    for k in APP_PATH_KERNELS:
        launches[k] = launches.get(k, 0) + app_run["launches"].get(k, 0)
    for k in REST_PATH_KERNELS + WORKER_KERNELS + ("ntt_inv",):
        launches[k] = launches.get(k, 0) + rest_run["launches"].get(k, 0)
    rows = timings(rng, errs, launches, smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if _ARGS[:1] == ["--k2-times"]:
        k2_only(TREE)
    else:
        main()
