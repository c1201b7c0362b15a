"""Small sizes of the cells, for runs on the CPU with the kernels' plain versions."""

import time

import torch

from portbench import harness, run

SEED = 2 ** 31 + 12345            # larger than 32 signed bits hold


def small_data(cell: str):
    man = harness.manifest()
    e = harness.find(man["workloads"], cell, "workload")
    cfg = harness.load_json("configs", e["config"] + ".json")
    mix = harness.load_json("traffic", e["traffic"] + ".json")
    if mix["driver"] == "packed_search":
        cfg.update(preset="test-512", store_docs=300)
        mix.update(enc_batch=128, warmup_requests=1, check_sample=16, profile_s=0.2)
    else:
        cfg.update(preset="test-512-mult", rlk_levels=[3], plaintext_modulus=1073479681)
        mix.update(pool=16, enc_batch=8, warmup_requests=1, profile_s=0.2)
    return cfg, mix


def run_small(cell: str, trace: bool = False, seed: int = SEED, serve=None,
              seconds: float = 0.5) -> dict:
    cfg, mix = small_data(cell)
    return run.run_cell(cell, seed, seconds, trace, torch.device("cpu"), cfg, mix,
                        serve=serve, t_process=time.perf_counter())
