"""The index build's readers on a synthetic ``stats`` dict (the
``index.place`` and ``index.assemble`` spans, the ``index.peak_bytes``
counter; no reading without them), and the 1000-genome configuration
and its cell as the manifest resolves them."""

import pytest

from anibench import panels
from anibench.manifest import Manifest

MS = 1_000_000


def _job(scale=1, peak=30_000_000_000):
    rows = [("job", 0, 100, -1),
            ("index_build", 0, 40, 0),
            ("index.parse", 0, 10, 1),
            ("index.flush", 10, 16, 1),
            ("index.overflow_read", 11, 12, 3),
            ("index.place", 12, 15, 3),
            ("index.parse", 16, 20, 1),
            ("index.flush", 20, 24, 1),
            ("index.place", 21, 23, 7),
            ("index.assemble", 24, 40, 1),
            ("index.sort", 30, 38, 9),
            ("mapper_init", 40, 50, 0)]
    spans = [{"name": n, "start_ns": s * MS * scale, "end_ns": e * MS * scale,
              "parent": p, "attrs": {}} for n, s, e, p in rows]
    counters = {"index.bytes": 21_474_836_480, "index.peak_bytes": peak,
                "l1.key_bits": 64}
    return {"spans": spans, "counters": counters}


def _read(name, jobs):
    return Manifest().metric_reader(name).read({"jobs": jobs, "trace": None})


def test_index_assemble_s():
    # the two places, 3 + 2 ms, and the assembly, 16 ms (its sort inside)
    assert _read("index_assemble_s", [_job()]) == pytest.approx(0.021)
    assert _read("index_assemble_s", [_job(), _job(scale=3)]) == \
        pytest.approx(0.042)
    # a program without the place spans reads its assembly alone
    job = _job()
    job["spans"] = [s for s in job["spans"] if s["name"] != "index.place"]
    for s in job["spans"]:
        s["parent"] = min(s["parent"], 1) if s["name"] != "job" else -1
    assert _read("index_assemble_s", [job]) == pytest.approx(0.016)


def test_index_peak_gb():
    assert _read("index_peak_gb", [_job()]) == pytest.approx(30.0)
    assert _read("index_peak_gb", [_job(), _job(peak=20_000_000_000)]) == \
        pytest.approx(25.0)


@pytest.mark.parametrize("name", ["index_assemble_s", "index_peak_gb"])
def test_no_reading_without_spans_or_counters(name):
    assert _read(name, []) is None
    assert _read(name, [{"t_index_build": 1.0}]) is None
    if name == "index_peak_gb":
        job = _job()
        del job["counters"]["index.peak_bytes"]
        assert _read(name, [job]) is None
        # off a card the program records 0: nothing measured
        assert _read(name, [_job(peak=0)]) is None


def test_the_1000_genome_cell_resolves(tmp_path):
    man = Manifest()
    cell = man.workload("clusters1000_4m6.all_vs_all")
    assert cell["chips"] == 1 and cell["traffic"] == "all_vs_all"
    cfg = man.config(cell["config"])
    assert (cfg["genomes"], cfg["clusters"], cfg["genome_bp"]) == \
        (1000, 20, 4641652)
    assert cfg["reduced"] == ["genomes"] and cfg["published_genomes"] == 90000
    assert len(cfg["source"]) <= 200
    base = man.config("clusters100_4m6")
    same = set(base) - {"name", "deployment", "source", "genomes", "clusters",
                        "assumed", "why_reduced"}
    assert {k: cfg[k] for k in same} == {k: base[k] for k in same}
    traffic = man.traffic(cell["traffic"])
    assert traffic["queries"] == "panel"
    assert {m["name"] for m in man.end_to_end(cell["name"])} == \
        {"pairs_per_s", "setup_s"}
    assert [m["name"] for m in man.per_layer(cell["name"])] == \
        ["index_assemble_s"]
    # the panel's layout at a small genome size: 1000 references in 20
    # species of 50, every one a query, 225 checked pairs of one species
    small = dict(cfg, genome_bp=200)
    panel = panels.make_panel(small, traffic, 2**31 + 7, tmp_path)
    assert len(panel.refs) == 1000 and panel.queries == panel.refs
    assert [panel.ref_species.count(c) for c in range(20)] == [50] * 20
    pairs = panels.check_sample(panel, traffic, 2**31 + 7)
    assert len(pairs) == 225
    assert len({panel.ref_species[panel.refs.index(q)] for q, _ in pairs}) \
        == 1
