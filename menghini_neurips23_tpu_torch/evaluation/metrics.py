"""Prediction evaluation (reference utils/compute_metrics.py:18-56)."""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import scipy.stats as st

logger = logging.getLogger(__name__)


def evaluate_predictions(
    config,
    df_predictions: pd.DataFrame,
    test_labeled_files,
    labels,
    unseen_classes,
    seen_classes=None,
):
    """Join predictions to ground truth on basename id.

    UL/SSL -> (accuracy, None, None); TRZSL -> (unseen, seen, harmonic mean)
    (reference compute_metrics.py:32-56).
    """
    df_test = pd.DataFrame({"id": list(test_labeled_files), "true": list(labels)})
    df_test["id"] = df_test["id"].apply(lambda x: x.split("/")[-1])
    df = pd.merge(df_predictions, df_test, on="id")
    # The basename join is many-to-many when basenames collide across
    # directories; the metric then averages over cross-joined rows rather
    # than files.  Real ELEVATER filenames are unique, so this is a data
    # problem worth surfacing, not silently absorbing.
    if len(df) != len(df_predictions):
        logger.warning(
            "evaluate_predictions: basename join produced %d rows for %d "
            "predictions (duplicate basenames across directories?); the "
            "accuracy below averages over joined rows, not files",
            len(df),
            len(df_predictions),
        )

    if config.LEARNING_PARADIGM in ("ul", "ssl"):
        accuracy = np.sum(df["class"] == df["true"]) / df.shape[0]
        return accuracy, None, None

    unseen = df[df["true"].isin(unseen_classes)]
    unseen_accuracy = np.sum(unseen["class"] == unseen["true"]) / unseen.shape[0]
    seen = df[df["true"].isin(seen_classes)]
    seen_accuracy = np.sum(seen["class"] == seen["true"]) / seen.shape[0]
    harmonic_mean = st.hmean([unseen_accuracy, seen_accuracy])
    return unseen_accuracy, seen_accuracy, harmonic_mean
