"""Port all-to-all (K3's plain version) and mesh sharding bit-exact vs JAX.

The same uint32 shards, made with numpy from a seed, go through the JAX
package's Pallas kernel `pallas_all_to_all` inside `jax.shard_map` over 2,
4 and 8 of the conftest's virtual CPU devices (interpret mode, as
`tests/test_ntt_dist.py` runs it) and through the port's `all_to_all` on
logical CPU shards.  Tolerance: none.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fhe_icp_tpu.parallel.ici import pallas_all_to_all
from fhe_icp_tpu_torch.parallel import ici
from fhe_icp_tpu_torch.parallel.mesh import (BATCH_SPEC, PACKED_OPERAND_SPEC, REPLICATED,
                                             gather, make_mesh, shard)

# (local shard shape, split_axis, concat_axis); the last has a 60-byte chunk
# (not a multiple of 16) at 8 shards.
CASES = [((2, 8, 16), 2, 1), ((2, 8, 16), 1, 2), ((3, 8, 5), 1, 2)]


def _shards(d, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
            for _ in range(d)]


def _jax_all_to_all(locals_, split, concat):
    """JAX's Pallas K3 over len(locals_) virtual devices; returns each device's output."""
    d = len(locals_)
    mesh = jax.make_mesh((d,), ("sp",), devices=jax.devices()[:d],
                         axis_types=(jax.sharding.AxisType.Auto,))
    f = jax.shard_map(lambda x: pallas_all_to_all(x, "sp", split, concat, d, interpret=True),
                      mesh=mesh, in_specs=P("sp"), out_specs=P("sp"), check_vma=False)
    out = np.asarray(jax.jit(f)(np.concatenate(locals_, axis=0)))
    return np.split(out, d, axis=0)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("shape,split,concat", CASES)
def test_all_to_all_matches_pallas_kernel(d, shape, split, concat):
    locals_ = _shards(d, shape, seed=d * 10 + split)
    want = _jax_all_to_all(locals_, split, concat)
    shards = [torch.from_numpy(x) for x in locals_]
    got = ici.all_to_all(shards, split, concat)
    ref = ici.all_to_all_ref(shards, split, concat)
    assert len(got) == len(ref) == d
    for g, r, w in zip(got, ref, want):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(r.numpy(), w)


def test_exchange_is_the_row_all_to_all():
    """Chunk j of shard s lands in rows [s*c, (s+1)*c) of shard j."""
    d, c, w = 4, 3, 5
    flats = [torch.arange(d * c * w, dtype=torch.int64).reshape(d * c, w) + 1000 * s
             for s in range(d)]
    flats = [f.to(torch.uint32) for f in flats]
    outs = ici.exchange(flats)
    for j in range(d):
        for s in range(d):
            np.testing.assert_array_equal(outs[j][s * c:(s + 1) * c].numpy(),
                                          flats[s][j * c:(j + 1) * c].numpy())


def test_kernel_wrapper_refuses_other_devices():
    """Only CPU shards take the plain version; others launch the kernel or raise."""
    x = [torch.zeros((4, 8), dtype=torch.uint32, device="meta") for _ in range(2)]
    with pytest.raises(ValueError):
        ici.exchange(x)
    with pytest.raises(ValueError):
        ici.all_to_all(x, 0, 1)


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_launch_plan_groups_round_robin_shards_by_card(cards):
    """One K3 launch per card, over its sources in shard order: card c of 4 gets [c, c + 4]."""
    devices = [torch.device("cuda", i % cards) for i in range(8)]
    plan = ici.launch_plan(devices)
    assert list(plan) == [torch.device("cuda", c) for c in range(cards)]
    for c in range(cards):
        assert plan[torch.device("cuda", c)] == list(range(c, 8, cards))


@pytest.mark.parametrize("spec", [BATCH_SPEC, PACKED_OPERAND_SPEC, REPLICATED])
def test_shard_and_gather_round_trip(spec):
    mesh = make_mesh(8, (4, 2), device="cpu")
    x = torch.arange(8 * 8 * 4 * 6, dtype=torch.int64).reshape(8, 8, 4, 6)
    parts = shard(mesh, x, spec)
    assert len(parts) == 8
    sizes = mesh.shape
    want = tuple(n // sizes[a] if a else n
                 for n, a in zip(x.shape, tuple(spec) + (None,) * 4))
    assert all(p.shape == want for p in parts)
    torch.testing.assert_close(gather(mesh, parts, spec), x, rtol=0, atol=0)


def test_mesh_places_shards_round_robin():
    mesh = make_mesh(8, (8,), device="cpu", axes=("sp",))
    assert mesh.shape == {"sp": 8} and mesh.size == 8
    assert all(dev.type == "cpu" for dev in mesh.devices)
    m2 = make_mesh(8, (4, 2), device="cpu")
    assert [m2.index(m2.coords(i)) for i in range(8)] == list(range(8))
    assert m2.coords(5) == {"dp": 2, "tp": 1}
    with pytest.raises(ValueError):
        make_mesh(8, (3, 2), device="cpu")
