"""The port's entry points on logical CPU shards: the three oracle-gated programs.

`dryrun_multichip` runs the NTT-domain sharded search, the slot-packed
sharded search and the ring-sharded NTT round trip, and raises on any
mismatch with its exact oracles; `entry` is the single-device matvec and
decode step.  The JAX package's `__graft_entry__` runs the same programs
on its 8 virtual devices; both must score the same documents alike.
"""

import numpy as np
import pytest
import torch

from fhe_icp_tpu_torch import entry


@pytest.mark.parametrize("n_devices", [8, 4, 2, 1])
def test_dryrun_multichip_on_cpu_shards(n_devices):
    entry.dryrun_multichip(n_devices, device="cpu")


def test_entry_scores_exactly():
    fn, (cts_data, query) = entry.entry(device="cpu")
    rng = np.random.default_rng(0)
    docs = rng.integers(-1000, 1001, size=(4, entry.DIM)).astype(np.int64)
    q = rng.integers(-1000, 1001, size=(entry.DIM,)).astype(np.int64)
    np.testing.assert_array_equal(query.numpy(), q)
    got = fn(cts_data, query)
    assert got.dtype == torch.int32 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), docs @ q)


def test_entry_matches_jax_entry():
    """Both packages' entry steps score the same example documents alike.

    Their keys and ciphertexts differ (each draws its own randomness), so
    the scores are what is compared.
    """
    import jax

    import __graft_entry__ as jentry
    jfn, (jcts, jq) = jentry.entry()
    fn, (cts_data, query) = entry.entry(device="cpu")
    np.testing.assert_array_equal(query.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(np.asarray(jax.jit(jfn)(jcts, jq)),
                                  fn(cts_data, query).numpy())
