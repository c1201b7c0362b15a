"""The plain reference of the scores, its int8 control and the seeded streams, on the CPU."""

import numpy as np
import torch

from portbench.reference import scores
from portbench.traffic import generate as gen

CPU = torch.device("cpu")


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
