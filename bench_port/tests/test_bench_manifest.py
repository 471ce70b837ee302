"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by a name in it."""

import json
import re

import pytest

from bench_port.tests.conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"hidden_size|intermediate|latent|state_size|projection"
                    r"|mlp_size|_dim$|_rank$|head_dim|expansion"
                    r"|experts_per_tok")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for path in MANIFEST["paths"]:
        assert PATH.match(path) and not path.startswith("/") \
            and ".." not in path and (ROOT / path).is_dir()
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(_line(word) for word in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) \
        and 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_names_and_units():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for group in (MANIFEST["configs"], MANIFEST["workloads"], metrics):
        names = [entry["name"] for entry in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in
                                          MANIFEST["paths"]))
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf
            assert not WIDTHS.search(key), key


def test_metrics_entries():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= m["bound"] <= limit
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in MANIFEST["end_to_end"])
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _reports(cell, metric):
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_is_reported_in_each_cell(metric):
    moved = next(m for m in MANIFEST["end_to_end"]
                 if m["name"] == metric["moves"])
    for w in MANIFEST["workloads"]:
        if _reports(w["name"], metric):
            assert _reports(w["name"], moved), (metric["name"], w["name"])
    assert (ROOT / "bench_port" / "metrics" / f"{metric['name']}.py"
            ).is_file()


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_each_cell_reports_enough_and_has_its_files(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"]
           if _reports(cell["name"], m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(cell["name"], m) for m in MANIFEST["per_layer"])
    here = ROOT / "bench_port"
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    assert (here / "drivers" / f"{traffic['kind']}.py").is_file()
    limits = json.loads((here / "limits" / f"{cell['name']}.json")
                        .read_text())["numbers"]
    for name, limit in limits.items():
        # each limit lies between the readings it was set from
        assert limit["lower"] <= limit["limit"] < limit["upper"], name
    roofline = [m for m in MANIFEST["per_layer"]
                if _reports(cell["name"], m)
                and m["name"].endswith("_roofline")]
    for m in roofline:
        assert any("mfu" in other["name"] and other["moves"] == m["moves"]
                   and _reports(cell["name"], other)
                   for other in MANIFEST["per_layer"])


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
