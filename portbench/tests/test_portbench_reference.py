"""The plain references agree with the port at small sizes on the CPU."""

import numpy as np
import pytest
import torch

from portbench.reference import bgv, scores, text
from portbench.traffic import generate as gen

from fhe_icp_tpu_torch.models.embedder import HashingEmbedder
from fhe_icp_tpu_torch.models.reduction import DimensionReducer
from fhe_icp_tpu_torch.ops import ntt_cuda
from fhe_icp_tpu_torch.ops.params import get_params
from fhe_icp_tpu_torch.ops.runtime import FheRuntime
from fhe_icp_tpu_torch.utils.quantize import prepare_embedding_for_fhe

CPU = torch.device("cpu")


@pytest.mark.parametrize("preset", ["test-512", "test-512-mult", "pairwise-4096"])
def test_limb_primes_are_the_presets(preset):
    p = get_params(preset)
    assert bgv.limb_primes(p.n_limbs) == tuple(p.primes)


@pytest.mark.parametrize("preset", ["test-512", "pairwise-4096"])
def test_ntt_matches_the_port_slot_for_slot(preset):
    rt = FheRuntime(preset, rlk_levels=[], device=CPU)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2 ** 31, size=(3, rt.ctx.n_limbs, rt.ctx.n)) % \
        np.array(rt.ctx.primes)[None, :, None]
    want = ntt_cuda.ntt_fwd_ref(rt.ctx.plan, torch.from_numpy(a.astype(np.uint32))).numpy()
    for i, p in enumerate(rt.ctx.primes):
        assert np.array_equal(bgv.ntt(a[:, i], p), want[:, i].astype(np.int64))
        assert np.array_equal(bgv.intt(want[:, i].astype(np.int64), p), a[:, i])


@pytest.mark.parametrize("preset,rev", [("test-512", False), ("test-512-mult", True),
                                        ("pairwise-4096", False)])
def test_decrypt_matches_the_port(preset, rev):
    rt = FheRuntime(preset, rlk_levels=[], device=CPU)
    rt.generate_keys(seed=7)
    vecs = gen.quantized_unit(gen.torch_generator(5, "v", CPU), (4, 128), 1000, CPU)
    ct = rt.encrypt_vector(vecs, seed=9, rev=rev)
    got = bgv.decrypt(ct.data.numpy(), rt.keys.sk.s.numpy().astype(np.int64), rt.params.t)
    assert np.array_equal(got, rt.decrypt(ct).numpy().astype(np.int64))
    head = vecs.numpy()[:, ::-1] if rev else vecs.numpy()
    assert np.array_equal(got[:, :128], head) and not got[:, 128:].any()


def test_decrypt_with_another_key_gives_noise():
    rt = FheRuntime("test-512", rlk_levels=[], device=CPU)
    rt.generate_keys(seed=7)
    ct = rt.encrypt_vector(torch.ones((1, 128), dtype=torch.int32), seed=1)
    other = FheRuntime("test-512", rlk_levels=[], device=CPU)
    other.generate_keys(seed=8)
    got = bgv.decrypt(ct.data.numpy(), other.keys.sk.s.numpy().astype(np.int64), rt.params.t)
    assert np.abs(got[0, 128:]).max() > 1000


def test_embedder_is_the_port_s_bit_for_bit():
    texts = ["the quick brown fox", "A fast, brown fox leaps!", "", "x " * 300]
    port = HashingEmbedder()
    want = np.stack([port.get_embedding(t) for t in texts])
    assert np.array_equal(text.Embedder().embed(texts), want)


def test_reduction_and_quantization_match_the_port():
    sample = gen.text_sampler(gen.vocabulary(0, 500), 1.0, 20, 60)
    fit = sample(np.random.default_rng(3), 200)
    new = sample(np.random.default_rng(4), 64)
    emb = text.Embedder()
    red = DimensionReducer(128, device=CPU).fit(emb.embed(fit))
    port = np.stack([prepare_embedding_for_fhe(r, 1000)[0]
                     for r in red.transform(emb.embed(new))]).astype(np.int64)
    want = text.vectors(emb.embed(new), red.mean_, red.components_, 1000)
    assert (port != want).mean() < 0.002 and np.abs(port - want).max() <= 1
    gaps = text.reducer_gaps(emb.embed(fit), red.mean_, red.components_)
    assert gaps["reducer_mean_gap"] < 1e-5 and gaps["reducer_subspace_gap"] < 1e-4, gaps


def test_reducer_gaps_see_a_bf16_fit_and_a_wrong_one_but_no_rotation():
    sample = gen.text_sampler(gen.vocabulary(0, 500), 1.0, 20, 60)
    emb = text.Embedder()
    x = emb.embed(sample(np.random.default_rng(3), 200))
    red = DimensionReducer(128, device=CPU).fit(x)
    low = text.reducer_gaps(x, *text.pca_bf16(x, 128))
    assert low["reducer_mean_gap"] > 1e-4 and low["reducer_subspace_gap"] > 1e-3, low
    half = DimensionReducer(128, device=CPU).fit(x[:100])
    assert text.reducer_gaps(x, half.mean_, half.components_)["reducer_subspace_gap"] > 0.1
    rand = np.linalg.qr(np.random.default_rng(5).standard_normal((768, 128)))[0]
    assert text.reducer_gaps(x, red.mean_, rand)["reducer_subspace_gap"] > 0.5
    turn = np.linalg.qr(np.random.default_rng(6).standard_normal((128, 128)))[0]
    rotated = text.reducer_gaps(x, red.mean_, red.components_ @ turn)
    assert rotated["reducer_subspace_gap"] < 1e-4, rotated


def test_bf16_control_departs_from_the_reference():
    sample = gen.text_sampler(gen.vocabulary(0, 500), 1.0, 20, 60)
    emb = text.Embedder()
    red = DimensionReducer(128, device=CPU).fit(emb.embed(sample(np.random.default_rng(3), 200)))
    x = emb.embed(sample(np.random.default_rng(4), 64))
    lo = text.vectors_bf16(x, red.mean_, red.components_, 1000)
    hi = text.vectors(x, red.mean_, red.components_, 1000)
    assert (lo != hi).mean() > 0.05 and (lo != hi).mean(axis=1).max() > 0.15


def test_scores_are_exact_and_topk_is_checked():
    rng = np.random.default_rng(0)
    docs = rng.integers(-1000, 1001, size=(500, 128))
    q = rng.integers(-1000, 1001, size=(3, 128))
    s = scores.scores(docs, q)
    assert np.array_equal(s, docs @ q.T)
    good = []
    for j in range(3):
        idx = np.argsort(-s[:, j], kind="stable")[:10]
        good.append((s[idx, j], idx))
    assert scores.wrong_topk(docs, q, good, 10) == 0
    bad = [(v + (j == 1), i) for j, (v, i) in enumerate(good)]
    assert scores.wrong_topk(docs, q, bad, 10) == 1
    swapped = [(v, i[::-1]) for v, i in good]
    assert scores.wrong_topk(docs, q, swapped, 10) == 3
    assert scores.wrong_topk(docs, q, [None, good[1], good[2]], 10) == 1


def test_int8_control_is_not_exact():
    rng = np.random.default_rng(0)
    v = gen.quantized_unit(gen.torch_generator(0, "d", CPU), (200, 128), 1000, CPU).numpy()
    assert sum(scores.dot_int8(v[i], v[i + 1]) != int(v[i].astype(np.int64) @ v[i + 1])
               for i in range(100)) > 90
    vals, idx = scores.topk_int8(v, v[0], 10)
    assert scores.wrong_topk(v, v[:1], [(vals, idx)], 10) == 1
    del rng


def test_stream_seeds_take_any_size_and_differ():
    seeds = {gen.stream_seed(s, n) for s in (0, 1, 2 ** 31 + 5, 2 ** 40, -3)
             for n in ("docs", "queries")}
    assert len(seeds) == 10 and all(0 <= s < 2 ** 63 for s in seeds)
    a = gen.quantized_unit(gen.torch_generator(2 ** 33, "docs", CPU), (2, 8), 1000, CPU)
    b = gen.quantized_unit(gen.torch_generator(2 ** 33, "docs", CPU), (2, 8), 1000, CPU)
    assert torch.equal(a, b)
