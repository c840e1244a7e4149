"""Per-sample HGT networks and cohort comparison (HGT_network.py).

A sample's HGT network at a taxonomy level: nodes = taxa, edges = the top
`edge_num` junction tags ranked by cross_split_reads
(HGT_network.py:89-141 `get_HGT_matrix`). Properties per network: density,
transitivity, algebraic connectivity, degree assortativity, node/edge counts
(HGT_network.py:143-160 `get_network_properties`). Cohort comparison runs a
rank-sum test on each property between phenotype groups
(HGT_network.py:252-291 `compare_network`, per-level edge_num schedule
[10, 12, 20, 30, 40, 50]). Scale-freeness: power-law vs alternative fits on
the degree sequence (HGT_network.py:167-183 — the `powerlaw` package is
replaced by a discrete-MLE log-likelihood-ratio implementation here).
"""

from __future__ import annotations

import numpy as np

from localhgt_tpu_torch.analysis.taxonomy import LEVELS, Taxonomy

EDGE_NUM_BY_LEVEL = {i + 1: n for i, n in
                     enumerate([10, 12, 20, 30, 40, 50])}
PROPERTIES = ["density", "transitivity", "algebraic_connectivity",
              "assortativity", "node_num", "edge_num"]


def hgt_matrix(sample, tax: Taxonomy, level, edge_num: int):
    """(adjacency [n,n], node list, total_edge_num): top-edge_num edges by
    max cross_split_reads per tag (HGT_network.py:89-141)."""
    score = {}
    for b in sample.bkps:
        edge = tax.edge_tag(b, level)
        s = b.cross_split_reads
        if edge not in score or s > score[edge]:
            score[edge] = s
    ranked = sorted(score.items(), key=lambda kv: kv[1], reverse=True)
    total = len(ranked)
    chosen = {k for k, _ in ranked[: min(edge_num, total)]}
    nodes = {}
    for b in sample.bkps:
        edge = tax.edge_tag(b, level)
        if edge not in chosen:
            continue
        for nd in edge.split("&"):
            if nd not in nodes:
                nodes[nd] = len(nodes)
    A = np.zeros((len(nodes), len(nodes)))
    for b in sample.bkps:
        edge = tax.edge_tag(b, level)
        if edge not in chosen:
            continue
        a, c = edge.split("&")
        A[nodes[a], nodes[c]] = 1
        A[nodes[c], nodes[a]] = 1
    return A, list(nodes), total


def network_properties(sample, tax: Taxonomy, level, edge_num: int):
    """([density, transitivity, algebraic_connectivity, assortativity,
    nodes, edges], total_edge_num); zeros when the sample has fewer than
    edge_num distinct junction tags (HGT_network.py:143-160)."""
    import networkx as nx

    A, _, total = hgt_matrix(sample, tax, level, edge_num)
    if total < edge_num:
        return [0, 0, 0, 0, 0, 0], total
    g = nx.from_numpy_array(A)
    try:
        alg = nx.algebraic_connectivity(g)
    except Exception:
        alg = 0.0
    try:
        asst = nx.degree_assortativity_coefficient(g)
    except Exception:
        asst = 0.0
    if not np.isfinite(asst):
        asst = 0.0
    return [round(nx.density(g), 3), round(nx.transitivity(g), 3),
            round(float(alg), 3), round(float(asst), 3),
            int(g.number_of_nodes()), int(g.number_of_edges())], total


def compare_groups(samples, tax: Taxonomy, group1: str, group2: str,
                   levels=range(1, 7)) -> list:
    """Rank-sum comparison of each network property between two phenotype
    groups at each taxonomy level (HGT_network.py:252-291). Returns rows
    {level, property, p_value, n1, n2, mean1, mean2}."""
    from scipy.stats import ranksums

    rows = []
    for level in levels:
        edge_num = EDGE_NUM_BY_LEVEL.get(level, 50)
        per_prop = {p: ([], []) for p in PROPERTIES}
        for s in samples:
            if s.disease == group1 or group1 in s.full_disease:
                gi = 0
            elif s.disease == group2 or group2 in s.full_disease:
                gi = 1
            else:
                continue
            props, total = network_properties(s, tax, level, edge_num)
            if total < edge_num:
                continue
            for p, v in zip(PROPERTIES, props):
                per_prop[p][gi].append(v)
        for p in PROPERTIES:
            a, b = per_prop[p]
            row = {
                "level": LEVELS[level], "property": p,
                "n1": len(a), "n2": len(b),
                "mean1": float(np.mean(a)) if a else 0.0,
                "mean2": float(np.mean(b)) if b else 0.0,
                "p_value": float("nan"),
            }
            if a and b:
                row["p_value"] = float(ranksums(a, b).pvalue)
            rows.append(row)
    return rows


def _powerlaw_alpha(deg: np.ndarray, xmin: int = 1) -> float:
    """Discrete power-law MLE alpha ~ 1 + n / sum(ln(x/(xmin-0.5)))
    (Clauset-Shalizi-Newman approximation)."""
    x = deg[deg >= xmin].astype(float)
    if len(x) == 0:
        return float("nan")
    return 1.0 + len(x) / np.sum(np.log(x / (xmin - 0.5)))


def scale_free_ratios(sample, tax: Taxonomy, level, edge_num: int):
    """Log-likelihood ratios of power-law vs (lognormal, exponential)
    fits of the degree sequence — positive ratio favours power-law
    (HGT_network.py:161-183). Returns (R_lognormal, R_exponential, total)."""
    A, _, total = hgt_matrix(sample, tax, level, edge_num)
    deg = A.sum(1).astype(int)
    deg = deg[deg >= 1]
    if len(deg) < 3:
        return float("nan"), float("nan"), total
    x = deg.astype(float)
    xmin = 1
    alpha = _powerlaw_alpha(deg, xmin)
    from scipy.special import zeta

    ll_pl = float(np.sum(-alpha * np.log(x)) - len(x) * np.log(zeta(alpha)))
    mu, sig = float(np.mean(np.log(x))), float(np.std(np.log(x)) + 1e-9)
    ll_ln = float(np.sum(
        -np.log(x * sig * np.sqrt(2 * np.pi))
        - (np.log(x) - mu) ** 2 / (2 * sig ** 2)
    ))
    lam = 1.0 / max(float(np.mean(x)) - xmin + 1e-9, 1e-9)
    ll_ex = float(np.sum(np.log(lam) - lam * (x - xmin)))
    return ll_pl - ll_ln, ll_pl - ll_ex, total
