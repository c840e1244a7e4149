"""Leave-one-dataset-out validation on one device.

Port of localhgt_tpu/analysis/cohort.py::lodo (CRC_LODO_Analysis_v2.py
:700-724), training each fold's classifier with analysis.classifier on
`device`. The rest of the JAX module (KEGG enrichment, timeline
fingerprinting) is host code and is imported from it where used.
"""

from __future__ import annotations

from localhgt_tpu.analysis.classifier import (DEFAULT_MARKERS,
                                              feature_matrix, roc_auc,
                                              select_markers, undersample)
from localhgt_tpu_torch.analysis.classifier import fit_and_score


def lodo(samples, group1: str, group2: str, device,
         marker_num: int = DEFAULT_MARKERS, model: str = "logreg",
         seed: int = 42) -> dict:
    """Leave-one-dataset-out evaluation over the samples' `cohort` labels.

    For each cohort: markers are selected on the remaining cohorts only,
    a model trains on them and is scored on the held-out cohort. Returns
    {"per_cohort": {name: auc}, "weighted_mean": float, "n_markers": {...}}
    with the mean weighted by held-out sample count."""
    elig = [s for s in samples
            if s.disease in (group1, group2)
            or group1 in s.full_disease or group2 in s.full_disease]
    cohorts = sorted({s.cohort for s in elig})
    if len(cohorts) < 2:
        raise ValueError(
            f"LODO needs >= 2 cohorts; got {cohorts!r} — set the cohort "
            "column in the phenotype CSV")
    per = {}
    nmk = {}
    total = 0.0
    n_total = 0
    for held in cohorts:
        train_s = [s for s in elig if s.cohort != held]
        test_s = [s for s in elig if s.cohort == held]
        markers = select_markers(train_s, group1, group2, marker_num)
        nmk[held] = len(markers)
        if not markers or not test_s:
            per[held] = float("nan")
            continue
        Xt, yt, _ = feature_matrix(train_s, markers, group1, group2)
        Xv, yv, _ = feature_matrix(test_s, markers, group1, group2)
        Xt, yt = undersample(Xt, yt, seed)
        auc = roc_auc(yv, fit_and_score(Xt, yt, Xv, device, model, seed))
        per[held] = auc
        if auc == auc:  # not NaN
            total += auc * len(yv)
            n_total += len(yv)
    return {
        "per_cohort": per,
        "weighted_mean": (total / n_total) if n_total else float("nan"),
        "n_markers": nmk,
    }
