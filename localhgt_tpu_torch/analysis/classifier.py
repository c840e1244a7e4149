"""Differential-HGT markers + phenotype classification on one device.

Port of localhgt_tpu/analysis/classifier.py::train_logreg_tpu and
train_and_eval (the method is described there). Marker selection, the
feature matrix, undersampling and the AUC are host code, imported from the
JAX module (which imports jax only inside train_logreg_tpu). The L2
logistic regression trains on `device` with full-batch torch Adam, whose
update and defaults (betas 0.9/0.999, eps 1e-8) are optax's `adam`.
"""

from __future__ import annotations

import numpy as np
import torch

from localhgt_tpu.analysis.classifier import (DEFAULT_MARKERS,
                                              feature_matrix, roc_auc,
                                              select_markers, undersample)


def train_logreg(X, y, device, l2: float = 1e-3, steps: int = 500,
                 lr: float = 0.05, seed: int = 0):
    """L2 logistic regression trained on `device`; returns (score, params)
    as train_logreg_tpu does: `score` maps a feature matrix to
    probabilities on the host, `params` is {"w": [d], "b": []} numpy
    float32. Weights start at zero, so `seed` changes nothing (kept for
    the same signature)."""
    Xd = torch.as_tensor(np.asarray(X, np.float32), device=device)
    yd = torch.as_tensor(np.asarray(y, np.float32), device=device)
    w = torch.zeros(Xd.shape[1], dtype=torch.float32, device=device,
                    requires_grad=True)
    b = torch.zeros((), dtype=torch.float32, device=device,
                    requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad()
        logits = Xd @ w + b
        loss = (torch.nn.functional.binary_cross_entropy_with_logits(
            logits, yd) + l2 * torch.sum(w ** 2))
        loss.backward()
        opt.step()
    params = {"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}

    def score(Xv):
        z = np.asarray(Xv, np.float32) @ params["w"] + params["b"]
        return 1.0 / (1.0 + np.exp(-z))

    return score, params


def fit_and_score(Xt, yt, Xv, device, model: str, seed: int):
    """Validation scores of the chosen model trained on (Xt, yt)."""
    if model == "rf":
        from sklearn.ensemble import RandomForestClassifier

        rfc = RandomForestClassifier(n_estimators=100, random_state=seed)
        rfc.fit(Xt, yt)
        return rfc.predict_proba(Xv)[:, 1]
    score, _ = train_logreg(Xt, yt, device, seed=seed)
    return score(Xv)


def train_and_eval(samples, group1: str, group2: str, device,
                   marker_num: int = DEFAULT_MARKERS, val_frac: float = 0.2,
                   model: str = "logreg", seed: int = 42) -> dict:
    """End-to-end marker selection + training + validation AUC
    (HGT_classifier.py:334-380 `training`). Markers are selected on the
    training split only."""
    rng = np.random.default_rng(seed)
    elig = [s for s in samples
            if s.disease in (group1, group2)
            or group1 in s.full_disease or group2 in s.full_disease]
    order = rng.permutation(len(elig))
    n_val = max(1, int(len(elig) * val_frac))
    val_ids = {elig[i].sample_id for i in order[:n_val]}
    train_s = [s for s in elig if s.sample_id not in val_ids]
    val_s = [s for s in elig if s.sample_id in val_ids]

    markers = select_markers(train_s, group1, group2, marker_num)
    if not markers:
        return {"auc": float("nan"), "n_markers": 0,
                "n_train": len(train_s), "n_val": len(val_s)}
    Xt, yt, _ = feature_matrix(train_s, markers, group1, group2)
    Xv, yv, _ = feature_matrix(val_s, markers, group1, group2)
    Xt, yt = undersample(Xt, yt, seed)
    scores = fit_and_score(Xt, yt, Xv, device, model, seed)
    return {"auc": roc_auc(yv, scores), "n_markers": len(markers),
            "n_train": len(Xt), "n_val": len(Xv), "markers": markers}
