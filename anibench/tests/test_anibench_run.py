"""A whole run on the CPU at a tiny size: the shape of the result line,
and ``correct`` false with the timed path broken underneath (the checks
of the harness's look for a card are skipped: the run is driven through
``harness.run_cell`` on the CPU).  And the boundary: nothing that the
benchmark runs loads JAX or the JAX package, and the reference loads
nothing of the port."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from anibench import harness
from anibench.manifest import ROOT


def run(man, workload="tiny.all_vs_all", trace=False, seed=2**31 + 5):
    import io

    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(man, workload, seed, 0.1, trace, "cpu",
                           out=out, err=err)
    return res, out.getvalue(), err.getvalue()


def test_result_line_shape(tiny):
    res, out, err = run(tiny)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert set(res["metrics"]) == {"pairs_per_s", "peak_mem_gb", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(res["compared"]) == ["pairs_wrong", "ani_gap",
                                     "matrix_gap", "jobs_failed"]
    assert err.strip().splitlines()[-4].startswith("pairs_wrong 0 limit 0")
    json.dumps(res)
    assert any(line.startswith('{"job": 0') for line in out.splitlines())


def test_traced_result_line_shape(tiny):
    res, out, _ = run(tiny, "tiny.one_to_many", trace=True)
    assert res["correct"] is True and res["attempted"] == 1
    names = {m["name"] for m in tiny.data["per_layer"]}
    # on the CPU nothing runs on a card: the trace's readers read nothing
    assert set(res["metrics"]) == {"index_build_s", "mapper_init_s",
                                   "map_loop_s", "write_s"}
    assert set(res["metrics"]) <= names
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def _state_unchanged(mp):
    from fastani_tpu_torch.models import device_cgi

    mp.setattr(device_cgi.StreamingCGI, "update", lambda *a, **k: None)


def _half_batch_left_out(mp):
    from fastani_tpu_torch.models import pipeline

    orig = pipeline.FragmentStream.make_batch

    def half(self, b0, B):
        frags, qno, gid, n = orig(self, b0, B)
        frags[n // 2:n] = 0
        return frags, qno, gid, n // 2
    mp.setattr(pipeline.FragmentStream, "make_batch", half)


def _answer_altered(mp):
    from fastani_tpu_torch.models import ani

    orig = ani.results_from_matrices

    def altered(*a, **k):
        rows = orig(*a, **k)
        for r in rows:
            r.count_seq += 1
        return rows
    mp.setattr(ani, "results_from_matrices", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_left_out,
                                   _answer_altered])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    res, _, _ = run(tiny)
    assert res["correct"] is False
    c = res["compared"]
    assert c["pairs_wrong"]["value"] > 0 or c["ani_gap"]["value"] > \
        c["ani_gap"]["limit"]


@pytest.mark.cuda
def test_broken_timed_path_is_not_correct_at_each_cells_size(tmp_path):
    """Each cell at its own size on the card, one seed: a clean job and a
    job with each fault planted, all checked against one reference run;
    prints each job's numbers."""
    import torch

    from anibench import check, panels
    from anibench.manifest import Manifest

    if not torch.cuda.is_available():
        pytest.skip("a cell's own size runs on a card")
    man = Manifest()
    harness.prepare("cuda")
    faults = [None, _state_unchanged, _half_batch_left_out, _answer_altered]
    seed = 2**31 + 404
    for w in man.data["workloads"]:
        cell = man.workload(w["name"])
        config = man.config(cell["config"])
        traffic = man.traffic(cell["traffic"])
        work = tmp_path / w["name"]
        panel = panels.make_panel(config, traffic, seed, work)
        outs = []
        for i, fault in enumerate(faults):
            out = str(work / f"job{i}.tsv")
            with pytest.MonkeyPatch.context() as mp:
                if fault is not None:
                    fault(mp)
                _, wall, rc = harness.run_job(panel.job_argv(out), "cuda")
            assert rc == 0
            outs.append((fault, out, wall))
        pairs = panels.check_sample(panel, traffic, seed)
        ref = check.reference_answers(pairs, config,
                                      torch.device("cuda"))["float32"]
        for fault, out, wall in outs:
            got = check.compare(ref, [out], pairs, panel.queries)
            name = fault.__name__.lstrip("_") if fault else "none"
            print(json.dumps({"cell": w["name"], "seed": seed,
                              "fault": name, "job_s": wall,
                              "pairs_checked": len(pairs), **got}))
            assert check.judge(got) == (fault is None)


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this test needs a machine without a card")
    rc = harness.main(["--workload", "species100_3m.all_vs_all", "--seed",
                       "1", "--seconds", "1"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastani_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fastani_tpu.config", sys)
    assert harness.forbidden_modules() == ["fastani_tpu"]


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_reference_no_port():
    bench = ROOT / "anibench"
    for p in bench.rglob("*.py"):
        assert not _imports(p) & set(harness.FORBIDDEN), p
    for p in (bench / "reference").rglob("*.py"):
        assert "fastani_tpu_torch" not in _imports(p), p


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import anibench.check, anibench.panels; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'fastani_tpu', "
            "'fastani_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_end_children_ends_and_waits_for_a_child_left_running():
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(600)"])
    assert proc.pid in harness.children()
    assert harness.end_children(wait_s=2.0) == [proc.pid]
    assert harness.children() == []
