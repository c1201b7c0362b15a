"""Drive the PyTorch/CUDA port's encrypted packed search on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):

1. Device and build: needs CUDA, prints the card's name and power limit,
   builds the kernels of `fhe_icp_tpu_torch/csrc/` with nvcc.
2. Each kernel against its plain PyTorch version on the card, bit-exact:
   the NTT at N = 512 .. 16384 with 1 and 2 limbs and several batch
   shapes, the scoring kernel at the slice shape, a ragged and a
   one-group store.
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
4. Times on the card (CUDA events, median of repeats after warm-up) of
   each kernel, its plain version and, for scoring, the int8 matmul
   alone through `torch._int_mm`, beside the least time the card could
   take (bytes at 3.35 TB/s or operations at the published peak rate).

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fhe_icp_tpu_torch import kernels  # noqa: E402
from fhe_icp_tpu_torch.ops import arith, ntt_cuda, pack, pack_cuda  # noqa: E402
from fhe_icp_tpu_torch.ops import primes as pr  # noqa: E402
from fhe_icp_tpu_torch.ops.cipher import Ciphertext, decrypt_coeff  # noqa: E402
from fhe_icp_tpu_torch.ops.context import CryptoContext  # noqa: E402
from fhe_icp_tpu_torch.ops.ntt import build_plan  # noqa: E402
from fhe_icp_tpu_torch.ops.params import get_params  # noqa: E402
from fhe_icp_tpu_torch.ops.runtime import FheRuntime  # noqa: E402

DEVICE = "cuda"
PRESET = "pairwise-4096"
DIM, SCALE = 128, 1000.0
N_DOCS, ENC_BATCH = 65_536, 8192
N_QUERIES, TOP_K = 8, 10

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# 32-bit integer multiplies (IMAD) on the CUDA cores: 64 per clock per SM,
# half the float32 FMA rate behind the 67 TFLOP/s float32 peak.
INT32_MUL_PER_S = 67e12 / 4

KERNELS = {
    "ntt_fwd": ("fhe_icp_tpu_torch/csrc/ntt.cu", "fhe_icp_tpu/ops/ntt_pallas.py:152"),
    "ntt_inv": ("fhe_icp_tpu_torch/csrc/ntt.cu", "fhe_icp_tpu/ops/ntt_pallas.py:165"),
    "pack_score": ("fhe_icp_tpu_torch/csrc/pack_score.cu",
                   "fhe_icp_tpu/ops/pack_pallas.py:67"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, by CUDA events around each run."""
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
    return torch.from_numpy(x.astype(np.uint32)).cuda()


# ---------------------------------------------------------------------------


def device_and_build() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    phase("device and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    log = kernels.build()
    kernels.load()
    print(f"build {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    print("kernels:", " ".join(KERNELS))
    return smi


def kernels_vs_plain(rng) -> dict:
    phase("kernels against plain versions")
    errs = {name: 0 for name in KERNELS}
    primes = pr.ntt_primes(2, bits=31)
    for n in (512, 1024, 2048, 4096, 16384):
        plan = build_plan(n, primes, "cuda")
        one = build_plan(n, primes[1:], "cuda")
        for p, shape in ((plan, (2, n)), (plan, (3, 2, n)), (plan, (2, 5, 2, n)),
                         (plan, (4, 1, n)), (one, (3, 1, n))):
            x = random_residues(rng, p, shape)
            fwd = ntt_cuda.ntt_fwd(p, x)
            e_f = max_abs_err(fwd, ntt_cuda.ntt_fwd_ref(p, x))
            e_i = max_abs_err(ntt_cuda.ntt_inv(p, x), ntt_cuda.ntt_inv_ref(p, x))
            e_r = max_abs_err(ntt_cuda.ntt_inv(p, fwd), x)
            check(e_f == e_i == e_r == 0, f"NTT N={n} shape={shape}: {e_f} {e_i} {e_r}")
            errs["ntt_fwd"] = max(errs["ntt_fwd"], e_f)
            errs["ntt_inv"] = max(errs["ntt_inv"], e_i)
        print(f"  NTT N={n}: fwd, inv, round trip bit-exact (L=1, 2; 5 batch shapes)")
    # The main path's own NTT shapes: one encrypt batch and a key row.
    plan = build_plan(4096, primes, "cuda")
    for shape in ((ENC_BATCH, 2, 4096), (2, 4096)):
        x = random_residues(rng, plan, shape)
        errs["ntt_fwd"] = max(errs["ntt_fwd"], max_abs_err(
            ntt_cuda.ntt_fwd(plan, x), ntt_cuda.ntt_fwd_ref(plan, x)))
        errs["ntt_inv"] = max(errs["ntt_inv"], max_abs_err(
            ntt_cuda.ntt_inv(plan, x), ntt_cuda.ntt_inv_ref(plan, x)))
    check(errs["ntt_fwd"] == errs["ntt_inv"] == 0, f"NTT at main-path shapes: {errs}")
    print(f"  NTT at {(ENC_BATCH, 2, 4096)} and (2, 4096): bit-exact")

    rt_ctx = CryptoContext(get_params(PRESET), DEVICE)
    slots = pack.slots_per_ct(rt_ctx.n, DIM)
    for g in (2048, 3125, 1):
        a = torch.randint(-128, 128, (2, 4 * g, 2 * rt_ctx.n), dtype=torch.int8, device="cuda")
        v = torch.randint(-128, 128, (2, 2 * rt_ctx.n, 4 * slots), dtype=torch.int8,
                          device="cuda")
        e = max_abs_err(pack_cuda.packed_score_residues(rt_ctx, a, v, 2, slots),
                        pack_cuda.packed_score_residues_ref(rt_ctx, a, v, 2, slots))
        check(e == 0, f"pack_score G={g}: max abs err {e}")
        errs["pack_score"] = max(errs["pack_score"], e)
        print(f"  pack_score G={g}: bit-exact")

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
    return errs


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
    for name in KERNELS:
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
    return dict(launches=launches, query_ms=q_ms, encrypt_s=t_enc, build_s=t_build,
                keys_s=t_keys)


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

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in qs:
            one_query(q, lambda: None)
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
    print(f"  device view (torch.profiler, {len(qs)} queries): busy {busy / 1e3:.3f} ms "
          f"of a {window_us / 1e3:.3f} ms window, idle share {1 - busy / window_us:.3f}; "
          f"{len(dev)} device activities")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {t / 1e3 / len(qs):.4f} ms/query  x{c / len(qs):g}  {name[:90]}")


def bound(byts: float, ops: float, ops_per_s: float) -> tuple:
    """(ms, kind, text): the least time the card could take, and what sets it."""
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    kind = "bytes" if t_b >= t_o else "operations"
    return max(t_b, t_o), kind, f"set by {kind}: bytes {t_b:.4f} ms, operations {t_o:.4f} ms"


def timings(rng, errs: dict, launches: dict, smi: str) -> list:
    phase(f"times on {smi} (CUDA events, median of repeats)")
    out = []
    plan = build_plan(4096, pr.ntt_primes(2, bits=31), "cuda")
    x = random_residues(rng, plan, (ENC_BATCH, 2, 4096))
    rows = ENC_BATCH * 2
    # Each row read and written once, plus both limbs' (4N) tables; three
    # 32-bit multiplies per Shoup product: N/2 log2 N butterflies and N twists.
    n = plan.n
    bound_ms, kind, why = bound(2 * rows * n * 4 + 2 * 4 * n * 4,
                                3 * rows * (n // 2 * plan.log_n + n), INT32_MUL_PER_S)
    for name, kern, ref in (("ntt_fwd", ntt_cuda.ntt_fwd, ntt_cuda.ntt_fwd_ref),
                            ("ntt_inv", ntt_cuda.ntt_inv, ntt_cuda.ntt_inv_ref)):
        ms = cuda_ms(lambda: kern(plan, x))
        plain = cuda_ms(lambda: ref(plan, x), reps=3, warmup=1)
        print(f"  {name} {rows} rows x N=4096: {ms:.4f} ms; plain {plain:.3f} ms; "
              f"bound {bound_ms:.4f} ms ({why})")
        out.append(dict(name=name, ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=kind,
                        library_ms=None))

    ctx = CryptoContext(get_params(PRESET), DEVICE)
    slots, k = pack.slots_per_ct(ctx.n, DIM), 2 * ctx.n
    g = N_DOCS // slots
    a = torch.randint(-128, 128, (2, 4 * g, k), dtype=torch.int8, device="cuda")
    v = torch.randint(-128, 128, (2, k, 4 * slots), dtype=torch.int8, device="cuda")
    ms = cuda_ms(lambda: pack_cuda.packed_score_residues(ctx, a, v, 2, slots), reps=20)
    plain = cuda_ms(lambda: pack_cuda.packed_score_residues_ref(ctx, a, v, 2, slots),
                    reps=3, warmup=1)
    lib = cuda_ms(lambda: [torch._int_mm(a[i], v[i]) for i in range(2)], reps=20)
    byts = a.numel() + v.numel() + 2 * 4 * 4 * slots * 4 + 2 * 8 * 4 + 2 * g * slots * 4
    ops = 2 * a.shape[0] * a.shape[1] * k * v.shape[2]
    bound_ms, kind, why = bound(byts, ops, INT8_OPS_PER_S)
    print(f"  pack_score G={g} (L=2, 2N={k}, 4S={4 * slots}): {ms:.4f} ms; plain "
          f"{plain:.3f} ms; 2x torch._int_mm {lib:.4f} ms; bound {bound_ms:.4f} ms ({why}; "
          f"{byts / 2 ** 20:.1f} MiB, {ops / 1e9:.2f} G int8 ops)")
    out.append(dict(name="pack_score", ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=kind,
                    library_ms=lib))
    for row in out:
        src, rep = KERNELS[row["name"]]
        row.update(route="cuda", source=src, replaces=rep,
                   launches=launches.get(row["name"], 0), max_abs_err=errs[row["name"]])
    return out


def main() -> None:
    smi = device_and_build()
    rng = np.random.default_rng(0)
    errs = kernels_vs_plain(rng)
    run = main_path(rng)
    rows = timings(rng, errs, run["launches"], smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
