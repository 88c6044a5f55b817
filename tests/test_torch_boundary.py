"""Package boundary and device defaults of the port: it imports neither
``jax`` nor ``fastani_tpu``, and its entry points run on ``cuda`` unless
asked for ``cpu`` (without a card they raise)."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastani_tpu_torch import cli
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import pipeline
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "fastani_tpu")


def _port_sources():
    return sorted((ROOT / "fastani_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, (path, name)


def test_cli_run_loads_no_jax(tmp_path):
    """A full CLI run on the CPU in a fresh interpreter leaves neither jax
    nor fastani_tpu in sys.modules."""
    rng = np.random.default_rng(1)
    base = synth.random_genome(rng, 30_000)
    synth.write_fasta(tmp_path / "a.fa", [("a", base)])
    synth.write_fasta(tmp_path / "b.fa",
                      [("b", synth.mutate_genome(rng, base, 0.02))])
    code = (
        "import sys\n"
        "from fastani_tpu_torch import cli\n"
        f"assert cli.main(['-q', {str(tmp_path / 'a.fa')!r}, '-r', "
        f"{str(tmp_path / 'b.fa')!r}, '-o', {str(tmp_path / 'o.txt')!r}, "
        "'--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fastani_tpu'))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    assert "CLEAN" in res.stdout
    assert (tmp_path / "o.txt").read_text().count("\t") == 4


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """Without an explicit device an entry point asks for cuda; with no
    card that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    synth.write_fasta(tmp_path / "a.fa",
                      [("a", synth.random_genome(np.random.default_rng(2),
                                                 5000))])
    params = Parameters(query_sequences=[str(tmp_path / "a.fa")],
                        ref_sequences=[str(tmp_path / "a.fa")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_fast(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-q", str(tmp_path / "a.fa"), "-r", str(tmp_path / "a.fa"),
                  "-o", str(tmp_path / "o.txt")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReferenceIndex.build_device(params.finalize())
