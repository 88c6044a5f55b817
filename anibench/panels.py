"""Genome panels and jobs, made from ``--seed`` by one generator that reads
a configuration's sizes and a traffic mix's parameters.

The strain generator is a frozen copy of the repository's
(``tests/synth.py``, copied into ``chip_smoke.py`` and ``bench.py``):
a random base genome per species, each strain a copy with point
substitutions and small indels.  A configuration with ``clusters`` 1 is
bench.py's ``build_workload`` (``full``: 100 x 3 Mbp); with more, it is
``build_clustered`` (scripts/run_scale1000.py's: unrelated species of
equal size).  Strain j of a species of n has 1 % + 4 % x j / (n - 1)
substitutions.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List

import numpy as np


def random_genome(rng, n: int) -> np.ndarray:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]


def mutate_genome(rng, seq, sub_rate=0.02, indel_rate=0.0005,
                  indel_max=12) -> np.ndarray:
    """Point substitutions + small indels, like diverged strains."""
    seq = seq.copy()
    n_sub = int(len(seq) * sub_rate)
    if n_sub:
        pos = rng.choice(len(seq), size=n_sub, replace=False)
        seq[pos] = random_genome(rng, n_sub)
    if indel_rate > 0:
        parts = []
        cur = 0
        n_ind = int(len(seq) * indel_rate)
        cuts = np.sort(rng.choice(len(seq), size=n_ind, replace=False))
        for c in cuts:
            parts.append(seq[cur:c])
            if rng.random() < 0.5:
                parts.append(random_genome(rng, int(rng.integers(1,
                                                                indel_max))))
                cur = c
            else:
                cur = min(len(seq), c + int(rng.integers(1, indel_max)))
        parts.append(seq[cur:])
        seq = np.concatenate(parts)
    return seq


def write_fasta(path, contigs, line_width: int = 70) -> None:
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">" + name.encode() + b"\n")
            b = seq.tobytes()
            for i in range(0, len(b), line_width):
                f.write(b[i: i + line_width] + b"\n")


@dataclasses.dataclass
class Panel:
    """A job's inputs: the reference genomes (``refs``), the query
    genomes (``queries``), the species of each (``ref_species``,
    ``query_species``), and the CLI arguments of a job."""
    refs: List[str]
    queries: List[str]
    ref_species: List[int]
    query_species: List[int]
    ref_list: str
    query_list: str
    one_to_many: bool

    def job_argv(self, out: str, queries=None) -> list:
        qs = self.queries if queries is None else queries
        if self.one_to_many and len(qs) == 1:
            q = ["-q", qs[0]]
        else:
            lst = self.query_list
            if queries is not None:
                lst = out + ".queries.txt"
                with open(lst, "w") as f:
                    f.write("\n".join(qs) + "\n")
            q = ["--ql", lst]
        return q + ["--rl", self.ref_list, "-o", out, "--matrix"]


def strain_rate(config: dict, j: int, per: int) -> float:
    lo, hi = config["sub_rate"]
    return lo + (hi - lo) * (j / max(per - 1, 1))


def make_panel(config: dict, traffic: dict, seed: int,
               workdir: pathlib.Path) -> Panel:
    """Write the panel of ``config`` under ``workdir`` and the job's query
    set by ``traffic``: ``"queries": "panel"`` (every genome of the panel
    against every one, ``--ql``/``--rl``) or ``"new_strains"`` (that many
    strains not in the panel, each of a species drawn from the seed, at
    the middle of the substitution range, against the panel)."""
    rng = np.random.default_rng(seed)
    n, size, clusters = (config["genomes"], config["genome_bp"],
                         config["clusters"])
    per = -(-n // clusters)
    bases, refs, species = [], [], []
    workdir.mkdir(parents=True, exist_ok=True)
    i = 0
    for c in range(clusters):
        base = random_genome(rng, size)
        bases.append(base)
        for j in range(min(per, n - i)):
            g = mutate_genome(rng, base, strain_rate(config, j, per),
                              indel_rate=config["indel_rate"])
            p = workdir / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)])
            refs.append(str(p))
            species.append(c)
            i += 1
    ref_list = workdir / "refs.txt"
    ref_list.write_text("\n".join(refs) + "\n")
    if traffic["queries"] == "panel":
        return Panel(refs, list(refs), species, list(species), str(ref_list),
                     str(ref_list), False)
    lo, hi = config["sub_rate"]
    queries, qsp = [], []
    for t in range(traffic["new_strains"]):
        c = int(rng.integers(0, clusters))
        g = mutate_genome(rng, bases[c], (lo + hi) / 2,
                          indel_rate=config["indel_rate"])
        p = workdir / f"query{t}.fa"
        write_fasta(p, [(f"query{t}", g)])
        queries.append(str(p))
        qsp.append(c)
    query_list = workdir / "queries.txt"
    query_list.write_text("\n".join(queries) + "\n")
    return Panel(refs, queries, species, qsp, str(ref_list), str(query_list),
                 True)


def warmup_queries(panel: Panel, config: dict, frag_batch: int) -> list:
    """The job's first batch of queries: the query genomes whose fragments
    fill the first ``frag_batch`` rows."""
    per_genome = max(1, config["genome_bp"] // config["frag_len"])
    return panel.queries[:max(1, -(-frag_batch // per_genome))]


def _strata(rng, n: int, m: int) -> list:
    """``m`` of ``range(n)``, one drawn in each of ``m`` equal strata, so
    that they spread over the whole range."""
    edges = [n * i // m for i in range(m + 1)]
    return [int(rng.integers(a, b)) for a, b in zip(edges, edges[1:])]


def check_sample(panel: Panel, traffic: dict, seed: int):
    """The (query, reference) pairs whose answers are checked, drawn from
    the seed.  With the panel as queries: every ordered pair of a set of
    genomes, so both directions of each .matrix cell are checked: up to
    ``check_strains`` strains of each of as many species as make
    ``check_reported_pairs`` same-species pairs, the species and the
    strains each spread over the panel's order (and so over its
    batches).  With new strains: each strain against every reference of
    its species (every pair that its job reports) and ``check_other``
    references of other species."""
    rng = np.random.default_rng([seed, 1])
    by_sp: dict = {}
    for i, sp in enumerate(panel.ref_species):
        by_sp.setdefault(sp, []).append(i)
    sp_ids = sorted(by_sp)
    if traffic["queries"] == "panel":
        k = min(traffic["check_strains"], max(map(len, by_sp.values())))
        m = min(len(sp_ids), -(-traffic["check_reported_pairs"] // (k * k)))
        pick = []
        for j in _strata(rng, len(sp_ids), m):
            members = by_sp[sp_ids[j]]
            pick += [members[i] for i in
                     _strata(rng, len(members), min(k, len(members)))]
        g = [panel.refs[i] for i in pick]
        return [(q, r) for q in g for r in g]
    pairs = []
    for q, sp in zip(panel.queries, panel.query_species):
        other = [i for i, s in enumerate(panel.ref_species) if s != sp]
        pick = by_sp.get(sp, []) + sorted(
            int(i) for i in rng.choice(other, min(len(other),
                                                  traffic["check_other"]),
                                       replace=False))
        pairs += [(q, panel.refs[i]) for i in pick]
    return pairs
