"""Dataset-overall eval metrics (port of ``mmearth_tpu/eval/metrics.py``;
torchmetrics equivalents).

The reference computes metrics over the whole split through accumulating
torchmetrics collections, not minibatch averages (engine_finetune.py:29-53,
195-198).  Each metric here accumulates integer sufficient statistics on
the host; :func:`batch_stats_fn` computes a batch's statistics as tensors on
the logits' device, so an evaluation sums them there and reads them once.

Per-dataset mapping (engine_finetune.py:44-51):
  m-eurosat / m-so2sat / m-brick-kiln -> multiclass Accuracy (micro)
  m-bigearthnet -> multilabel F1 (micro, threshold 0.5 on sigmoid logits)
  m-cashew-plant / m-SA-crop-type -> multiclass Jaccard (macro)
"""
from __future__ import annotations

import numpy as np
import torch


class MulticlassAccuracy:
    """Micro accuracy: argmax(logits) == label."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.correct = 0
        self.total = 0

    def update(self, logits: np.ndarray, labels: np.ndarray):
        preds = np.asarray(logits).argmax(axis=-1).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        self.correct += int((preds == labels).sum())
        self.total += labels.size

    def update_stats(self, stats):
        self.correct += int(stats["correct"])
        self.total += int(stats["total"])

    def compute(self) -> float:
        return self.correct / max(self.total, 1)


class MultilabelF1Micro:
    """Micro F1 over all (sample, label) pairs; preds = sigmoid(logit) > 0.5,
    i.e. logit > 0."""

    def __init__(self, num_labels: int):
        self.num_labels = num_labels
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0
        self.fn = 0

    def update(self, logits: np.ndarray, labels: np.ndarray):
        preds = np.asarray(logits) > 0
        labels = np.asarray(labels) > 0.5
        self.tp += int((preds & labels).sum())
        self.fp += int((preds & ~labels).sum())
        self.fn += int((~preds & labels).sum())

    def update_stats(self, stats):
        self.tp += int(stats["tp"])
        self.fp += int(stats["fp"])
        self.fn += int(stats["fn"])

    def compute(self) -> float:
        denom = 2 * self.tp + self.fp + self.fn
        return 2 * self.tp / denom if denom else 0.0


class MulticlassJaccardMacro:
    """Macro-averaged IoU from an accumulated confusion matrix.  Classes with
    zero union are excluded from the mean (torchmetrics semantics)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.confusion = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    def update(self, logits: np.ndarray, labels: np.ndarray):
        """logits: (..., C); labels: (...) int."""
        preds = np.asarray(logits).argmax(axis=-1).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        valid = (labels >= 0) & (labels < self.num_classes)
        idx = labels[valid] * self.num_classes + preds[valid]
        self.confusion += np.bincount(
            idx, minlength=self.num_classes ** 2
        ).reshape(self.num_classes, self.num_classes)

    def update_stats(self, stats):
        self.confusion += np.asarray(stats["confusion"]).astype(np.int64)

    def compute(self) -> float:
        tp = np.diag(self.confusion).astype(np.float64)
        fp = self.confusion.sum(axis=0) - tp
        fn = self.confusion.sum(axis=1) - tp
        union = tp + fp + fn
        present = union > 0
        if not present.any():
            return 0.0
        iou = np.where(present, tp / np.maximum(union, 1), 0.0)
        return float(iou[present].mean())


# ---------------------------------------------------------------------------
# batch sufficient statistics, as tensors on the logits' device
# ---------------------------------------------------------------------------
def accuracy_stats(logits: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
    preds = logits.argmax(-1).reshape(-1)
    labels = labels.reshape(-1)
    return {"correct": (preds == labels).sum(),
            "total": torch.tensor(labels.numel(), device=logits.device)}


def f1_stats(logits: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
    preds = logits > 0
    lab = labels > 0.5
    return {"tp": (preds & lab).sum(), "fp": (preds & ~lab).sum(), "fn": (~preds & lab).sum()}


def jaccard_stats(logits: torch.Tensor, labels: torch.Tensor,
                  num_classes: int) -> dict[str, torch.Tensor]:
    preds = logits.argmax(-1).reshape(-1)
    labels = labels.reshape(-1).long()
    valid = (labels >= 0) & (labels < num_classes)
    idx = (labels * num_classes + preds)[valid]
    conf = torch.bincount(idx, minlength=num_classes * num_classes)
    return {"confusion": conf.reshape(num_classes, num_classes)}


def batch_stats_fn(dataset: str, num_classes: int):
    kind = METRIC_BY_DATASET[dataset][1]
    if kind is MulticlassAccuracy:
        return accuracy_stats
    if kind is MultilabelF1Micro:
        return f1_stats
    return lambda logits, labels: jaccard_stats(logits, labels, num_classes)


METRIC_BY_DATASET = {
    "m-eurosat": ("Accuracy", MulticlassAccuracy),
    "m-so2sat": ("Accuracy", MulticlassAccuracy),
    "m-brick-kiln": ("Accuracy", MulticlassAccuracy),
    "m-bigearthnet": ("F1Score", MultilabelF1Micro),
    "m-cashew-plant": ("Jaccard", MulticlassJaccardMacro),
    "m-SA-crop-type": ("Jaccard", MulticlassJaccardMacro),
}


def metric_for(dataset: str, num_classes: int):
    name, cls = METRIC_BY_DATASET[dataset]
    return name, cls(num_classes)
