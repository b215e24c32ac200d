"""The comparison that decides ``correct`` for a training cell.

The set-up drives the program's own training object through its first
dispatch (k steps, one graph replay, on k distinct batches) and keeps, per
parameter leaf, the norm of AdamW's first moment and of the params' change.
The reference follows the same k steps from the same weights, draws and
batches.  Four numbers are compared, each against its limit:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``moment_gap``: per leaf, the gap between the program's and the
  reference's norm of AdamW's first moment after the k steps (the gradient
  as the optimizer got it, averaged over the steps), over the reference's
  norm of that leaf or of the median leaf, whichever is larger; the median
  of these gaps over the leaves.  (The worst leaf swings from seed to seed
  with the rounding of a few bias gradients that are sums with heavy
  cancellation: the first conv's bias, the image-level heads' biases.)
- ``change_gap``: the worst leaf's gap, so measured, of the params' change
  over the k steps, over the leaves whose first gradient in the reference
  is at least a thousandth of the median leaf's (a leaf whose gradient is
  nought to rounding moves under Adam by round-off alone);
- ``change_median_gap``: the median of those leaves' change gaps.  The
  worst leaf's gap swings with the few elements of a LayerNorm's affine,
  whose updates flip sign with rounding; the median is steady from seed to
  seed, and it tells half a batch from a whole one where the worst leaf
  cannot.
"""
from __future__ import annotations

import statistics

import torch

MOVING = 1e-3  # a leaf whose first gradient is under this share of the median leaf's is left out


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def summary(run: dict, weights: dict[str, torch.Tensor]) -> dict:
    """The norms a comparison reads from a run of the reference
    (:func:`reference.step.train`): its losses, and per leaf its first
    gradient, its first moment and its change from ``weights``."""
    return {"losses": list(run["losses"]), "first": leaf_norms(run["first_grad"]),
            "moment": leaf_norms(run["mu"]),
            "change": leaf_norms({k: v - weights[k] for k, v in run["params"].items()})}


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], leaves) -> dict[str, float]:
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}


def moving_leaves(ref: dict) -> list[str]:
    med = statistics.median(ref["first"].values())
    return [k for k, v in ref["first"].items() if v >= MOVING * med]


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog``: the program's ``losses`` and per-leaf ``moment`` and
    ``change`` norms; ``ref``: the reference's :func:`summary`."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program and the reference ran different numbers of steps")
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    change = leaf_gaps(prog["change"], ref["change"], moving_leaves(ref)).values()
    return {"loss_gap": max(losses),
            "moment_gap": statistics.median(
                leaf_gaps(prog["moment"], ref["moment"], list(ref["moment"])).values()),
            "change_gap": max(change), "change_median_gap": statistics.median(change)}


def worst_leaves(prog: dict, ref: dict, n: int = 4) -> dict:
    """For a look at what sets the numbers: per kind, the ``n`` leaves with
    the largest gaps, each with its gap and the two norms."""
    out = {}
    for kind, leaves in (("moment", list(ref["moment"])), ("change", moving_leaves(ref))):
        gaps = leaf_gaps(prog[kind], ref[kind], leaves)
        out[kind] = [[k, gaps[k], prog[kind][k], ref[kind][k]]
                     for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]
    return out


def judge(found: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(found[k] == found[k] and found[k] <= limits[k] for k in limits)


def report(found: dict[str, float], limits: dict[str, float]) -> dict[str, dict]:
    return {k: {"value": found[k], "limit": limits[k]} for k in limits}
