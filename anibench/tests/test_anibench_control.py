"""The control: the reference put in the program's place with the one
floating-point stage, the identity and ANI fold, in bfloat16, the
precision below the configuration's float32.  It has to come out as not
correct: on the CPU at a tiny size, and on the card at each cell's own
size on three seeds (``-m cuda``; it prints its readings)."""

import json

import pytest
import torch

from anibench import check, panels
from anibench.manifest import Manifest


def control_numbers(man, workload, seed, device, workdir):
    cell = man.workload(workload)
    config = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    panel = panels.make_panel(config, traffic, seed, workdir)
    pairs = panels.check_sample(panel, traffic, seed)
    got = check.reference_answers(pairs, config, device,
                                  ("float32", "bfloat16"))
    ref, ctl = got["float32"], got["bfloat16"]
    outs = check.control_outputs(ctl, pairs, panel.queries, workdir)
    return check.compare(ref, outs, pairs, panel.queries)


@pytest.mark.parametrize("workload", ["tiny.all_vs_all", "tiny.one_to_many"])
def test_control_is_not_correct_on_a_tiny_panel(tiny, tmp_path, workload):
    got = control_numbers(tiny, workload, 2**31 + 3, torch.device("cpu"),
                          tmp_path)
    assert not check.judge(got)
    assert got["ani_gap"] > 3 * check.LIMITS["ani_gap"]


@pytest.mark.cuda
def test_control_is_not_correct_at_each_cells_size(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the control's readings at a cell's size are taken on "
                    "a card")
    man = Manifest()
    for w in man.data["workloads"]:
        for i, seed in enumerate((2**31 + 101, 2**31 + 202, 2**31 + 303)):
            got = control_numbers(man, w["name"], seed,
                                  torch.device("cuda"), tmp_path / f"{i}")
            print(json.dumps({"control": w["name"], "seed": seed, **got}))
            assert not check.judge(got)
