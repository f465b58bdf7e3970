"""Sample-rate sequence-coverage analysis (a numpy and ``csv`` copy of
``ananke_abm_tpu/utils/sample_coverage.py``, no pandas).

Library form of the reference's ad-hoc inspection notebook
(src/ananke_abm/gen_schedule_check/visualize_multi_samples.ipynb): for a
population subsample, how many of the full population's distinct
purpose-sequences survive, and what fraction of person-days those
surviving sequences cover. Used to pick a training subsample rate that
keeps behavioral diversity.

Sequence counts are a dict {sequence string: count}, ordered as pandas'
``value_counts`` orders them (count descending, ties in order of first
appearance). The string is ``str(tuple(...))`` of the person's purposes
as Python scalars, as pandas' (3.x) tuple aggregation yields them:
``"('Home', 'Work')"`` for a string column, ``"(1, 2)"`` for an integer
one, ``"('Home', nan)"`` where a purpose is missing.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ananke_abm_tpu_torch.utils.make_purposes import (
    Column,
    read_table,
    write_table,
)


def _cells(table: dict, col: str) -> list:
    """A column's values as pandas' ``groupby(...).agg(tuple)`` yields
    them: Python scalars, NaN where missing."""
    v = table[col]
    if isinstance(v, Column):
        v = v.to_numpy()
    return np.asarray(v).tolist()


def sequence_counts(activities: dict, person_col: str = "persid",
                    purpose_col: str = "purpose") -> dict:
    """Per-person purpose-sequence value counts: each person contributes
    one sequence (their activities in table order; persons in order of
    first appearance); returns {stringified sequence: count}, most common
    first."""
    persons = _cells(activities, person_col)
    purposes = _cells(activities, purpose_col)
    seqs: dict = {}
    for p, a in zip(persons, purposes):
        if p != p:  # groupby drops a missing person
            continue
        seqs.setdefault(p, []).append(a)
    counts: dict = {}
    for seq in seqs.values():
        key = str(tuple(seq))
        counts[key] = counts.get(key, 0) + 1
    keys = list(counts)
    order = np.argsort(-np.array(list(counts.values()), dtype=np.int64),
                       kind="stable")
    return {keys[i]: counts[keys[i]] for i in order}


def coverage_vs_full(full_counts: dict, sample_counts: dict) -> dict:
    """Diversity retention of a subsample against the full population.

    Returns ``sampled_unique_sequences`` (fraction of the full
    population's distinct sequences that appear in the sample) and
    ``sampled_sequence_coverage`` (fraction of full person-days whose
    sequence is represented in the sample)."""
    present = [k for k in full_counts if k in sample_counts]
    total = sum(full_counts.values())
    return {
        "sampled_unique_sequences": len(present) / max(1, len(full_counts)),
        "sampled_sequence_coverage": float(
            sum(full_counts[k] for k in present) / max(1, total)),
    }


def sample_coverage_table(
    full_csv: str,
    sampled: Sequence[tuple[float, str]],
    person_col: str = "persid",
    purpose_col: str = "purpose",
    out_csv: str | None = None,
) -> dict:
    """Coverage table over (sample_rate, csv_path) pairs, anchored at
    rate 0 (nothing) and rate 1 (the full CSV), like the notebook's
    ``store_analysis`` frame; {column: float64 array}."""
    cols = (person_col, purpose_col)
    full_counts = sequence_counts(read_table(full_csv, cols), *cols)
    rows = [(0.0, 0.0, 0.0)]
    for rate, path in sorted(sampled):
        cov = coverage_vs_full(
            full_counts, sequence_counts(read_table(path, cols), *cols))
        rows.append((float(rate), cov["sampled_unique_sequences"],
                     cov["sampled_sequence_coverage"]))
    rows.append((1.0, 1.0, 1.0))
    names = ("sample_rate", "sampled_unique_sequences",
             "sampled_sequence_coverage")
    table = {n: np.array([r[i] for r in rows], dtype=np.float64)
             for i, n in enumerate(names)}
    if out_csv:
        write_table({n: Column("float", v.tolist())
                     for n, v in table.items()}, out_csv)
    return table


def plot_sample_coverage(table: dict, out_png: str) -> None:
    """Coverage / unique-sequence curves vs sample rate (the notebook's
    final plot)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(table["sample_rate"], table["sampled_unique_sequences"],
            marker="o", label="unique sequences retained")
    ax.plot(table["sample_rate"], table["sampled_sequence_coverage"],
            marker="s", label="person-day coverage")
    ax.set_xlabel("sample rate")
    ax.set_ylabel("fraction of full population")
    ax.set_ylim(0, 1.05)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
