"""Fresh encryption randomness of the port's runtime never repeats within a process.

On the CPU a torch generator (mt19937) keeps only the low 32 bits of its
seed, so two generators seeded from entropy draws that differ only above
bit 31 give the same stream.  Default draws therefore advance one
long-lived generator per device instead of seeding a new one per call.
"""

import numpy as np
import torch

from fhe_icp_tpu_torch.ops import runtime
from fhe_icp_tpu_torch.ops.runtime import FheRuntime


def _rt():
    rt = FheRuntime("test-512", rlk_levels=[], device="cpu")
    rt.generate_keys(seed=0)
    return rt


def _msg(seed):
    return np.random.default_rng(seed).integers(-1000, 1001, size=512).astype(np.int32)


def test_default_encryptions_differ_when_entropy_differs_only_above_32_bits(monkeypatch):
    """The smallest input that repeated (a, e): entropy 12345, then 12345 + 2**32."""
    draws = iter([12345, 12345 + 2 ** 32])
    monkeypatch.setattr(runtime, "fresh_seed", lambda: next(draws))
    monkeypatch.setattr(runtime, "_fresh_generators", {})
    rt = _rt()
    a1 = rt.encrypt(_msg(1)).data[..., 1, :, :]
    a2 = rt.encrypt(_msg(2)).data[..., 1, :, :]
    assert not torch.equal(a1, a2)
    # Seeded per call, as before the repair, the two draws collide on the CPU.
    same = [rt.generator(s) for s in (12345, 12345 + 2 ** 32)]
    assert torch.equal(torch.randint(0, 2 ** 31, (8,), generator=same[0]),
                       torch.randint(0, 2 ** 31, (8,), generator=same[1]))


def test_fresh_generator_is_drawn_once_per_device(monkeypatch):
    calls = []
    monkeypatch.setattr(runtime, "fresh_seed", lambda: calls.append(1) or 7)
    monkeypatch.setattr(runtime, "_fresh_generators", {})
    rt = _rt()
    cts = [rt.encrypt_vector(np.arange(4, dtype=np.int32)) for _ in range(3)]
    assert len(calls) == 1
    a = [ct.data[..., 1, :, :] for ct in cts]
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    assert rt.generator(None) is runtime.fresh_generator(torch.device("cpu"))
    for ct in cts:
        assert (rt.decrypt(ct)[:4].numpy() == np.arange(4)).all()


def test_explicit_seeds_are_deterministic():
    rt = _rt()
    m = _msg(3)
    assert torch.equal(rt.encrypt(m, seed=5).data, rt.encrypt(m, seed=5).data)
    assert not torch.equal(rt.encrypt(m, seed=5).data, rt.encrypt(m, seed=6).data)
    assert (rt.decrypt(rt.encrypt(m)).numpy() == m).all()
