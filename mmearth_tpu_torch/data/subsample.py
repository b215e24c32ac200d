"""Stratified subset selection for low-data finetuning partitions (a copy of
``mmearth_tpu/data/subsample.py``, numpy only).

Behavioral equivalent of the reference's ``stratified_subsample_multilabel``
(subsample.py:22-106): pick ``tot_samples`` indices with a per-class budget of
``tot // n_classes`` (capped by class support, smallest classes served first
so their scarce samples are not stolen by earlier draws), then distribute the
remainder round-robin over classes with leftover samples.  Multilabel samples
count for every class they carry and are removed from all class pools once
selected.  Used for the 0.01x/0.05x/0.50x GEO-Bench partitions
(slurm_fine_tune_subsample.sh:23-31).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def stratified_subsample_multilabel(
    y,
    percentage: float | None = None,
    num_samples: int | None = None,
    multilabel: bool = False,
    classes: Sequence = (),
    seed: int = 1,
):
    """Returns a permuted array of selected indices into ``y``.

    ``y``: labels; scalars for single-label, or per-sample collections /
    binary vectors for multilabel.  ``classes`` is required for multilabel.
    """
    rng = np.random.default_rng(seed)
    tot_samples = num_samples if percentage is None else int(percentage * len(y))
    assert classes or not multilabel, "classes must be provided when multilabel=True"
    if percentage == 1 or tot_samples == len(y):
        return y

    classes = list(classes) if len(classes) else list(np.unique(y))
    pools: dict = {}
    if not multilabel:
        arr = np.asarray(y)
        for c in classes:
            pools[c] = list(np.where(arr == c)[0])
    else:
        pools = {c: [] for c in classes}
        for i, labels in enumerate(y):
            labels_set = set(np.asarray(labels).tolist()) if not np.isscalar(labels) else {labels}
            for c in classes:
                if c in labels_set:
                    pools[c].append(i)

    per_class = np.minimum(
        tot_samples // len(classes), [len(pools[c]) for c in classes]
    )

    def remove_everywhere(chosen):
        chosen = set(np.atleast_1d(chosen).tolist())
        for c in pools:
            pools[c] = [i for i in pools[c] if i not in chosen]

    idxs: list[int] = []
    # serve the smallest classes first
    for n, c in sorted(zip(per_class, classes), key=lambda t: t[0]):
        take = min(int(n), len(pools[c]))
        if take:
            chosen = rng.choice(pools[c], size=take, replace=False)
            remove_everywhere(chosen)
            idxs.extend(int(i) for i in chosen)

    # round-robin the remainder over classes that still have samples
    remaining = tot_samples - len(idxs)
    ci = 0
    while remaining > 0 and any(pools[c] for c in classes):
        c = classes[ci % len(classes)]
        ci += 1
        if pools[c]:
            chosen = int(rng.choice(pools[c]))
            remove_everywhere([chosen])
            idxs.append(chosen)
            remaining -= 1

    return rng.permutation(idxs)
