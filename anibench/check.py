"""Whether the timed jobs' answers are correct: every job's TSV rows and
.matrix cells of a sample of (query, reference) pairs drawn from the seed
(``panels.check_sample``), against the plain FastANI of
``anibench/reference/`` recomputed from the same FASTA files.

Numbers compared, each with its limit (``LIMITS``; PERF.md gives the
readings each was set from):

* ``pairs_wrong``: checked pairs, over all jobs, whose TSV row is there
  where the reference has none or missing where it has one, or whose
  mapped-fragment count or total-fragment count differs; and .matrix
  cells that are NA on one side only.  An exact comparison: limit 0.
* ``ani_gap``: the widest |ANI in the TSV - the reference's ANI| over the
  checked rows of every job.  The TSV prints 6 significant digits.
* ``matrix_gap``: the widest |.matrix cell - the reference's cell|, a cell
  being the mean of the two directions' ANI where both are reported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import os
import time

import numpy as np
import torch

from anibench.reference import fastani

# a run is correct when every number is at or under its limit.  The ANI
# limits lie between the program's largest readings (ANI 5e-5 and
# .matrix 5e-7, the printed digits) and the bfloat16 control's smallest
# (2.56 ANI), with more room above the former
LIMITS = {"pairs_wrong": 0, "ani_gap": 0.02, "matrix_gap": 0.02}
# processes that read and winnow the sampled genomes after the window
READ_WORKERS = min(7, os.cpu_count() or 1)


def reference_answers(pairs, config: dict, device,
                      precisions=("float32",), times=None) -> dict:
    """{precision: {(query, ref): PairResult}} of the plain FastANI, its
    fold in each of ``precisions`` (``bfloat16`` for the control) over
    the same mappings.  On a card the genomes are read by several processes
    and the walk takes larger blocks.  ``times``, a dict, gets the
    seconds of each stage."""
    times = {} if times is None else times
    k, w, l = config["kmer"], config["window"], config["frag_len"]
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    genomes = fastani.load_genomes({p for pr in pairs for p in pr}, k, w, l,
                                   READ_WORKERS if on_card else 1)
    times["load_s"] = time.perf_counter() - t0
    return fastani.answers(genomes, pairs, k, w, l, config["min_fraction"],
                           device, precisions,
                           budget=1 << 29 if on_card else 1 << 27,
                           times=times)


def tsv_rows(path: str, pairs) -> Dict[Tuple[str, str], tuple]:
    want = set(pairs)
    rows = {}
    with open(path) as f:
        for line in f:
            q, r, ani, cnt, tot = line.rstrip("\n").split("\t")
            if (q, r) in want:
                rows[(q, r)] = (float(ani), int(cnt), int(tot))
    return rows


def matrix_cells(path: str, genomes) -> Dict[Tuple[str, str], float]:
    """{(a, b): value or None for NA} of the lower triangle among
    ``genomes``, keyed both ways."""
    want = set(genomes)
    names, cells = [], {}
    with open(path) as f:
        f.readline()
        for line in f:
            parts = line.rstrip("\n").split("\t")
            names.append(parts[0])
            if parts[0] not in want:
                continue
            for j, v in enumerate(parts[1:]):
                if names[j] in want:
                    val = None if v == "NA" else float(v)
                    cells[(parts[0], names[j])] = val
                    cells[(names[j], parts[0])] = val
    return cells


def expected_cell(ref, a: str, b: str):
    vals = [ref[p].ani for p in ((a, b), (b, a)) if p in ref
            and ref[p].reported]
    if not vals:
        return None
    if len(vals) == 1:
        return np.float32(vals[0])
    return np.float32(np.float32(vals[0] + vals[1]) / np.float32(2))


def compare(ref, outputs: List[str], pairs, queries) -> Dict[str, float]:
    """The numbers of ``LIMITS`` for the jobs that wrote ``outputs`` (TSV
    paths; the .matrix beside each)."""
    genomes = sorted({p for pr in pairs for p in pr})
    wrong, ani_gap, mat_gap = 0, 0.0, 0.0
    qset = set(queries)
    for out in outputs:
        rows = tsv_rows(out, pairs)
        for pr in pairs:
            want, got = ref[pr], rows.get(pr)
            if not want.reported:
                wrong += got is not None
                continue
            if got is None or got[1] != want.count \
                    or got[2] != want.total_fragments:
                wrong += 1
                continue
            ani_gap = max(ani_gap, abs(got[0] - float(want.ani)))
        cells = matrix_cells(out + ".matrix", genomes)
        for a in genomes:
            for b in genomes:
                if a <= b or not (a in qset or b in qset):
                    continue
                want = expected_cell(ref, a, b)
                got = cells.get((a, b), "missing")
                if (want is None) != (got is None) or got == "missing":
                    wrong += 1
                elif want is not None:
                    mat_gap = max(mat_gap, abs(got - float(want)))
    return {"pairs_wrong": wrong, "ani_gap": ani_gap, "matrix_gap": mat_gap}


def judge(numbers: Dict[str, float]) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())


def control_outputs(ctl, pairs, queries, workdir) -> List[str]:
    """The control put in the program's place: TSV and .matrix written from
    the reference's answers in a lower precision, formatted as the
    program formats them (%.6g ANI, %.6f cells)."""
    out = str(workdir / "control.tsv")
    with open(out, "w") as f:
        for (q, r), res in ctl.items():
            if res.reported:
                f.write("%s\t%s\t%s\t%d\t%d\n" % (
                    q, r, f"{float(res.ani):.6g}", res.count,
                    res.total_fragments))
    genomes = sorted({p for pr in pairs for p in pr})
    with open(out + ".matrix", "w") as f:
        f.write(f"{len(genomes)}\n")
        for i, a in enumerate(genomes):
            vals = []
            for b in genomes[:i]:
                v = expected_cell(ctl, a, b)
                vals.append("NA" if v is None else "%.6f" % float(v))
            f.write("\t".join([a] + vals) + "\n")
    return [out]
