"""The manifest keeps to the benchmark's contract, and every name in it resolves to files."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_paths_and_command():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w.split("/")
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(section):
    for e in MAN[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]


def test_names_and_units():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[section]]
        assert len(names) == len(set(names)), section
        assert all(NAME.match(n) for n in names), names
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MAN["per_layer"]:
        assert _line(m["layer"])


def test_sources_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_metric_layers_are_named_alike():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert layers["device"] == {"device"}


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_workload_resolves_to_its_files(cell):
    w = next(x for x in MAN["workloads"] if x["name"] == cell)
    conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).is_file()
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"] and data["source"] == conf["source"]
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
    e2e = [m for m in MAN["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = [m for m in MAN["per_layer"]
             if m["moves"] in names and cell in m.get("workloads", [cell])]
    assert layer
    for m in e2e + layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_every_config_is_used_and_has_its_own_file():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    assert all(any(f.startswith(p + "/") for p in MAN["paths"]) for f in files)


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_files_under_paths_have_name_characters():
    for p in MAN["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
