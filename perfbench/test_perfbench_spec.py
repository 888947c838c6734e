"""BENCHMARK.json resolves to files, keeps the contract's shape, and a
configuration, mix or metric is added by files and entries alone."""
import json
import re
import shutil

import pytest

from perfbench.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = spec.resolve(BENCH, cell)
    assert c.chips == 1
    for key in ("shape", "dtype", "eb", "generator", "reduced", "assumed", "guarantees"):
        assert key in c.config
    assert c.traffic["op"] in ("compress", "decompress")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and all(m["moves"] in e2e for m in c.per_layer)
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "compress_MBps", "decompress_MBps", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_new_config_mix_and_metric_need_only_files(tmp_path):
    here = spec.ROOT / "perfbench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(here / d, tmp_path / "perfbench" / d)
    bench = json.loads(json.dumps(BENCH))
    cfg = dict(json.loads((here / "configs" / "isabel-f32.json").read_text()),
               shape=[50, 500, 500])
    (tmp_path / "perfbench" / "configs" / "isabel-half.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench" / "traffic" / "plain-write.json").write_text(json.dumps(
        {"op": "compress", "options": {"preserve_order": False}, "clients": 1,
         "pool": {"min_fields": 3}}))
    (tmp_path / "perfbench" / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.window.requests))\n")
    bench["configs"].append({"name": "isabel-half", "source": "x",
                             "file": "perfbench/configs/isabel-half.json",
                             "reduced": ["shape"], "why": "x"})
    bench["workloads"].append({"name": "isabel-half.plain-write", "config": "isabel-half",
                               "traffic": "plain-write", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "requests_done", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "x",
                               "moves": "compress_MBps",
                               "workloads": ["isabel-half.plain-write"]})
    bench["end_to_end"][0]["workloads"].append("isabel-half.plain-write")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.resolve(spec.load_benchmark(tmp_path), "isabel-half.plain-write", tmp_path)
    assert c.config["shape"] == [50, 500, 500] and c.config["name"] == "isabel-half"
    assert c.traffic["options"] == {"preserve_order": False}
    assert [m["name"] for m in c.per_layer] == ["requests_done"]

    class Run:
        class window:
            requests = [1, 2, 3]

    assert spec.reader("requests_done", tmp_path)(Run) == 3.0
    with pytest.raises(KeyError):
        spec.resolve(BENCH, "no-such-cell")
