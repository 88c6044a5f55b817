"""``--profile DIR`` of the port's CLI on the CPU (golden fixtures): the
whole job's torch.profiler trace is written into DIR as
``job.pt.trace.json`` and parses as a Chrome trace with events, among
them a range for each of the job's top-level spans, and the outputs are
the bytes of the same run without the flag, on the fast path and on the
exact path."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastani_tpu_torch import cli
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# the job's span and its top-level phases (fastani_tpu_torch/utils/spans.py)
TOP = {"job", "index_build", "mapper_init", "map_loop", "write"}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """tests/test_golden_frozen.py's one-to-one fixture (seed 2024)."""
    wd = tmp_path_factory.mktemp("torch_profile")
    rng = np.random.default_rng(2024)
    base = synth.random_genome(rng, 150_000)
    strain_a = synth.mutate_genome(rng, base, sub_rate=0.02, indel_rate=0.0003)
    synth.write_fasta(wd / "base.fa", [("base_ctg", base)])
    synth.write_fasta(wd / "strainA.fa", [("sA_ctg", strain_a)])
    return wd


@pytest.mark.parametrize("path", [[], ["--exact"]], ids=["fast", "exact"])
def test_profile_writes_trace_and_same_outputs(workdir, tmp_path, path):
    args = ["-q", str(workdir / "base.fa"), "-r", str(workdir / "strainA.fa"),
            "--matrix", "--device", "cpu"] + path
    prof_dir = tmp_path / "prof"
    res = subprocess.run(
        [sys.executable, "-m", "fastani_tpu_torch.cli"] + args
        + ["-o", str(tmp_path / "p.txt"), "--profile", str(prof_dir)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr[-3000:]
    out = prof_dir / "job.pt.trace.json"
    assert f"profiler trace written to {out}" in res.stderr
    assert os.listdir(prof_dir) == [out.name]
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("dur", 0) > 0 for e in events)
    ranges = {e.get("name") for e in events if e.get("ph") == "X"}
    assert TOP <= ranges, TOP - ranges

    assert cli.main(args + ["-o", str(tmp_path / "n.txt")]) == 0
    for suf in ("", ".matrix"):
        got = (tmp_path / f"p.txt{suf}").read_bytes()
        assert got and got == (tmp_path / f"n.txt{suf}").read_bytes(), suf


@pytest.mark.parametrize("fn,stat", [("run_fast", "t_map_fold"),
                                     ("run", "t_map")],
                         ids=["fast", "exact"])
def test_profile_phase_time_excludes_trace_write(workdir, tmp_path,
                                                 monkeypatch, fn, stat):
    """The mapping phase's seconds are taken before the trace of the job
    is written: the stat is already set when ``export_chrome_trace``
    runs, once, after the job's spans are handed out."""
    from torch.profiler import profile

    from fastani_tpu_torch.config import Parameters
    from fastani_tpu_torch.models import pipeline

    stats, seen = {}, []
    export = profile.export_chrome_trace

    def traced_export(self, path):
        seen.append(stat in stats and "spans" in stats)
        return export(self, path)

    monkeypatch.setattr(profile, "export_chrome_trace", traced_export)
    params = Parameters(query_sequences=[str(workdir / "base.fa")],
                        ref_sequences=[str(workdir / "strainA.fa")],
                        out_file_name=str(tmp_path / "o.txt"),
                        profile_dir=str(tmp_path / "prof"))
    getattr(pipeline, fn)(params, device="cpu", log=lambda m: None,
                          stats=stats)
    assert seen == [True]
    assert stats["t_trace_export"] >= 0 and stats[stat] > 0
    assert stats["profile_trace"].endswith("job.pt.trace.json")
