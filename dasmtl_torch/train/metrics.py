"""Host-side evaluation metrics (numpy).

Copy of ``dasmtl/train/metrics.py`` (the port imports nothing of
``dasmtl``).  The reference computes accuracy, confusion matrix, per-class
F1 and weighted F1/precision/recall per task with sklearn during every
validation pass (utils.py:297-322); these are small host-side reductions
over gathered predictions, written directly in numpy (the JAX package holds
its copy to sklearn in tests/test_metrics.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """Rows = true class, columns = predicted class (sklearn convention)."""
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true, np.int64), np.asarray(y_pred, np.int64)),
              1)
    return cm


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    if y_true.size == 0:
        return float("nan")
    return float((y_true == np.asarray(y_pred)).mean())


def _prf_from_cm(cm: np.ndarray):
    """Per-class precision, recall, F1 with zero-division -> 0 (sklearn
    ``zero_division=0`` default behavior)."""
    tp = np.diag(cm).astype(np.float64)
    pred_tot = cm.sum(axis=0).astype(np.float64)
    true_tot = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_tot > 0, tp / pred_tot, 0.0)
        recall = np.where(true_tot > 0, tp / true_tot, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return precision, recall, f1, true_tot


def per_class_f1(y_true, y_pred, num_classes: int) -> np.ndarray:
    _, _, f1, _ = _prf_from_cm(confusion_matrix(y_true, y_pred, num_classes))
    return f1


def weighted_prf(y_true, y_pred, num_classes: int) -> Dict[str, float]:
    """Support-weighted averages, matching sklearn ``average='weighted'``."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    precision, recall, f1, support = _prf_from_cm(cm)
    total = support.sum()
    if total == 0:
        return {"precision": float("nan"), "recall": float("nan"),
                "f1": float("nan")}
    w = support / total
    return {"precision": float((precision * w).sum()),
            "recall": float((recall * w).sum()),
            "f1": float((f1 * w).sum())}


def classification_report(y_true, y_pred, num_classes: int) -> Dict:
    """The full per-task metric bundle the reference prints per validation."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    return {
        "accuracy": accuracy(y_true, y_pred),
        "confusion_matrix": cm,
        "per_class_f1": per_class_f1(y_true, y_pred, num_classes),
        **{f"weighted_{k}": v
           for k, v in weighted_prf(y_true, y_pred, num_classes).items()},
    }


def distance_mae(y_true, y_pred) -> float:
    """Mean absolute distance-bin error in meters (bins are 1 m apart) — the
    paper's localization-error view of task 1."""
    y_true = np.asarray(y_true, np.float64)
    if y_true.size == 0:
        return float("nan")
    return float(np.abs(y_true - np.asarray(y_pred, np.float64)).mean())
