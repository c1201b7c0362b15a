"""`harness.read_profile` on synthetic profiler events: one card reads as it
always has, and several cards are read card by card (busy time the mean of
each card's own union, idle gaps on each card's own timeline)."""

from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.metrics import _read

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Prof:
    """A stand-in for a finished `torch.profiler.profile`: its `events()`."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def ev(name, start, end, card=None):
    """A profiler event over [start, end] µs: on `card`'s device timeline, or
    on the host without a card."""
    return SimpleNamespace(name=name, device_type=CPU if card is None else CUDA,
                           device_index=0 if card is None else card,
                           time_range=SimpleNamespace(start=start, end=end))


SPANS = {"search.operand", "search.shard"}
LAUNCHES = {"k1": [(2, 3125, 8192, 32)], "k2": []}


def one_card_events(card=0):
    return [
        ev("search.operand", 0.0, 55.0),
        ev("search.shard", 56.0, 140.0),
        ev("search.shard", 5.0, 150.0, card),       # the span's copy on the device: no operation
        ev("pack_score_kernel", 10.0, 30.0, card),
        ev("ntt_block_kernel<1, 1, 1>", 25.0, 40.0, card),
        ev("Memcpy HtoD", 60.0, 70.0, card),
        ev("ntt_warp_kernel<0, 1, 2>", 100.0, 130.0, card),
        ev("Memset", 160.0, 170.0, card),
        ev("aten::add", 1.0, 2.0),                   # a host operation
    ]


def test_one_card_reads_as_before():
    """The numbers a one-card cell has always read, pinned: busy is the union
    [10, 40] + [60, 70] + [100, 130] + [160, 170] µs; each gap is labelled by
    the shortest host span around its midpoint."""
    got = harness.read_profile(Prof(one_card_events()), 0.5, SPANS, LAUNCHES, [0])
    assert got == {
        "window_s": 0.5,
        "busy_s": 80.0 / 1e6,
        "busy_s_by_card": [80.0 / 1e6],
        "device_ops": {"pack_score_kernel": 20.0 / 1e6, "ntt_block_kernel<1, 1, 1>": 15.0 / 1e6,
                       "Memcpy HtoD": 10.0 / 1e6, "ntt_warp_kernel<0, 1, 2>": 30.0 / 1e6,
                       "Memset": 10.0 / 1e6},
        "idle_by_span": {"search.operand": 20.0 / 1e6, "search.shard": 30.0 / 1e6,
                         "between spans": 30.0 / 1e6},
        "kernel_s": {"k1": 20.0 / 1e6, "k2": 45.0 / 1e6},
        "launches": LAUNCHES,
    }
    assert list(got["device_ops"]) == ["pack_score_kernel", "ntt_block_kernel<1, 1, 1>",
                                       "Memcpy HtoD", "ntt_warp_kernel<0, 1, 2>", "Memset"]


def test_one_card_by_its_own_index():
    """A cell whose one card has another index reads the same numbers."""
    a = harness.read_profile(Prof(one_card_events(0)), 0.5, SPANS, LAUNCHES, [0])
    b = harness.read_profile(Prof(one_card_events(3)), 0.5, SPANS, LAUNCHES, [3])
    assert a == b


@pytest.mark.parametrize("n", [2, 4])
def test_cards_taking_turns_read_the_mean_not_the_union(n):
    """n cards busy 10 µs each in turn, twice: the union covers the whole
    20n µs, each card 20 µs of it."""
    events = [ev("pack_score_kernel", 10.0 * (n * r + c), 10.0 * (n * r + c) + 10.0, c)
              for r in range(2) for c in range(n)]
    window_s = 20.0 * n / 1e6
    got = harness.read_profile(Prof(events), window_s, set(), LAUNCHES, list(range(n)))
    assert got["busy_s_by_card"] == [20.0 / 1e6] * n
    assert got["busy_s"] == 20.0 / 1e6
    assert got["device_ops"] == {"pack_score_kernel": 20.0 * n / 1e6}
    assert got["kernel_s"] == {"k1": 20.0 * n / 1e6, "k2": 0.0}
    # Each card waits 10(n - 1) µs between its turns.
    assert got["idle_by_span"] == {"between spans": pytest.approx(10.0 * (n - 1) * n / 1e6)}
    run = SimpleNamespace(profile=got)
    assert _read.idle_share(run) == pytest.approx(100.0 * (1 - 1 / n))


def test_a_card_without_events_is_idle():
    got = harness.read_profile(Prof(one_card_events(0)), 0.5, SPANS, LAUNCHES, [0, 1])
    assert got["busy_s_by_card"] == [80.0 / 1e6, 0.0]
    assert got["busy_s"] == 40.0 / 1e6
    assert got["idle_by_span"] == {"search.operand": 20.0 / 1e6, "search.shard": 30.0 / 1e6,
                                   "between spans": 30.0 / 1e6}


def test_idle_gaps_are_labelled_on_each_cards_timeline():
    """Card 0 idles in [10, 20] while card 1 runs, card 1 in [20, 30] while
    card 0 runs: the union has no gap, each card one, labelled by the host
    span around its own midpoint."""
    events = [ev("a", 12.0, 18.0), ev("b", 22.0, 28.0),
              ev("op", 0.0, 10.0, 0), ev("op", 20.0, 30.0, 0),
              ev("op", 10.0, 20.0, 1), ev("op", 30.0, 40.0, 1)]
    got = harness.read_profile(Prof(events), 40e-6, {"a", "b"}, LAUNCHES, [0, 1])
    assert got["idle_by_span"] == {"a": 10.0 / 1e6, "b": 10.0 / 1e6}
    assert got["busy_s"] == 20.0 / 1e6


def test_card_indices():
    assert harness.card_indices(torch.device("cuda", 0)) == [0]
    assert harness.card_indices([torch.device("cuda", i) for i in range(4)]) == [0, 1, 2, 3]
    assert harness.card_indices([torch.device("cpu")] * 4) == [0, 1, 2, 3]
