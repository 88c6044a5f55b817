"""The manifest and the files it names: every entry loads by name, and a
file added for a new configuration, traffic mix or metric is found with
no edit to a file that is there."""

import json
import re

import pytest

from anibench.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_loads_by_name():
    man = Manifest()
    data = man.data
    for c in data["configs"]:
        cfg = man.config(c["name"])
        assert cfg["name"] == c["name"]
        for key in ("genomes", "genome_bp", "clusters", "kmer", "window",
                    "frag_len", "min_fraction"):
            assert key in cfg
        assert cfg["reduced"] == c["reduced"]
    for w in data["workloads"]:
        man.traffic(w["traffic"])
        man.config(w["config"])
        assert w["chips"] == 1
        assert man.end_to_end(w["name"]) and man.per_layer(w["name"])
    for m in data["per_layer"]:
        reader = man.metric_reader(m["name"])
        assert reader.LAYER == m["layer"]
        assert reader.MOVES == m["moves"]
        assert reader.read({"jobs": [], "trace": None}) is None


def test_manifest_keeps_to_its_shape():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in data[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in data["end_to_end"]} >= {"setup_s",
                                                        "pairs_per_s"}
    for m in data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in data["workloads"]:
        assert len(w["why"]) <= 200
    ends = {m["name"] for m in data["end_to_end"]}
    assert all(m["moves"] in ends for m in data["per_layer"])
    cells = {w["name"] for w in data["workloads"]}
    for m in data["end_to_end"] + data["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in data["per_layer"]:
        moved = next(e for e in data["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_added_files_are_found_without_an_edit(tiny):
    b = tiny.bench_dir
    (b / "traffic/two_new.json").write_text(json.dumps(
        {"queries": "new_strains", "new_strains": 2, "check_other": 2}))
    (b / "metrics/jobs_read.py").write_text(
        'LAYER = "harness"\nMOVES = "pairs_per_s"\n\n\n'
        'def read(ctx):\n    return float(len(ctx["jobs"]))\n')
    cfg = tiny.config("tiny")
    cfg["name"] = "tiny2"
    (b / "configs/tiny2.json").write_text(json.dumps(cfg))
    data = tiny.data
    data["configs"].append(dict(data["configs"][0], name="tiny2",
                                file="anibench/configs/tiny2.json"))
    data["workloads"].append({"name": "tiny2.two_new", "config": "tiny2",
                              "traffic": "two_new", "chips": 1, "why": "x"})
    data["per_layer"].append({"name": "jobs_read", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "pairs_per_s"})
    (tiny.root / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(tiny.root, b)
    assert man.traffic("two_new")["new_strains"] == 2
    assert man.config("tiny2")["name"] == "tiny2"
    assert [m["name"] for m in man.per_layer("tiny2.two_new")][-1] \
        == "jobs_read"
    assert man.metric_reader("jobs_read").read({"jobs": [{}, {}]}) == 2.0
    with pytest.raises(KeyError):
        man.workload("tiny3.two_new")
