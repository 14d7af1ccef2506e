"""Training metrics (counterpart of llamole_tpu/train/metric.py): token
accuracy under the label mask, and the text metrics (BLEU-4, ROUGE-1/2/L
over whitespace tokens), which live in eval/metric.py and are imported
from there."""

import numpy as np

from ..eval.metric import bleu4, compute_text_metrics, rouge_l, rouge_n
from ..utils.constants import IGNORE_INDEX

__all__ = ["token_accuracy", "bleu4", "rouge_n", "rouge_l",
           "compute_text_metrics"]


def token_accuracy(pred_ids: np.ndarray, label_ids: np.ndarray) -> float:
    """Share of the unmasked label positions (label != IGNORE_INDEX) whose
    predicted id equals the label; 0.0 when every position is masked."""
    pred = np.asarray(pred_ids)
    labels = np.asarray(label_ids)
    mask = labels != IGNORE_INDEX
    if mask.sum() == 0:
        return 0.0
    return float((pred[mask] == labels[mask]).mean())
