"""NLVR2's official metrics and report (``visualbert_tpu/utils/nlvr2_eval.py``,
copied; the reference bundles the nlvr repository's eval script,
``nlvr2/eval/metrics.py``: accuracy and consistency over a prediction CSV,
and the CSV report of ``train.py:374-383``)."""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple


def split_identifier(identifier: str) -> str:
    """NLVR2 identifiers are ``split-setid-pairid-sentenceid``; the examples
    of one ``split-setid-sentenceid`` form a consistency group."""
    parts = identifier.split("-")
    if len(parts) >= 4:
        return "-".join(parts[:2] + parts[3:4])
    return identifier


def accuracy(predictions: Dict[str, int], labels: Dict[str, int]) -> float:
    hits = sum(1 for k, v in predictions.items() if labels.get(k) == v)
    return hits / max(len(predictions), 1)


def consistency(predictions: Dict[str, int], labels: Dict[str, int]) -> float:
    """Share of sentence groups whose every image-pair example is right."""
    groups: Dict[str, List[bool]] = collections.defaultdict(list)
    for k, v in predictions.items():
        groups[split_identifier(k)].append(labels.get(k) == v)
    if not groups:
        return 0.0
    return sum(all(v) for v in groups.values()) / len(groups)


def write_csv_report(path: str, rows: Sequence[Tuple[str, int]]):
    """``identifier,prediction`` rows, the prediction written True/False."""
    with open(path, "w") as f:
        for identifier, pred in rows:
            f.write(f"{identifier},{'True' if pred == 1 else 'False'}\n")
