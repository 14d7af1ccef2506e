"""llamole_tpu_torch/train/metric.py against llamole_tpu/train/metric.py:
token accuracy on numpy ids, and the text metrics held in one place."""

import numpy as np
import pytest

from llamole_tpu.train.metric import compute_text_metrics as jax_text
from llamole_tpu.train.metric import token_accuracy as jax_accuracy
from llamole_tpu_torch.eval import metric as eval_metric
from llamole_tpu_torch.train import metric


@pytest.mark.parametrize("seed, masked", [(0, 0.0), (1, 0.3), (2, 0.9),
                                          (3, 1.0)])
def test_token_accuracy_matches_jax(seed, masked):
    """Seeded ids with a share of IGNORE_INDEX labels (all masked: 0.0)."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 6, size=(4, 17))
    labels = rng.integers(0, 6, size=(4, 17))
    labels[rng.random(labels.shape) < masked] = -100
    got = metric.token_accuracy(pred, labels)
    assert isinstance(got, float)
    assert got == jax_accuracy(pred, labels)


def test_text_metrics_live_in_eval_metric():
    """train.metric re-exports eval.metric's functions (no second copy),
    which score as the JAX package's do."""
    for name in ("bleu4", "rouge_n", "rouge_l", "compute_text_metrics"):
        assert getattr(metric, name) is getattr(eval_metric, name)
    preds = ["the cat sat on the mat", "a b c d", ""]
    refs = ["the cat sat on a mat", "a b d c", "x"]
    assert metric.compute_text_metrics(preds, refs) == jax_text(preds, refs)
