"""Reference divergence scan on torch tensors.

Port of localhgt_tpu/ops/scan.py::scan_hits, reproduced bug for bug (the
stencil and its telescoped left sum are documented there). The host
helpers (`good_intervals`, `peaks_in_intervals`, `final_intervals`,
`truncated_min`) are reused from the JAX package.
"""

from __future__ import annotations

import torch

from localhgt_tpu.config import ScanConfig
from localhgt_tpu.ops.scan import (  # noqa: F401  (re-exports)
    final_intervals, good_intervals, peaks_in_intervals, truncated_min)


def scan_hits(hc: torch.Tensor, k: int, cfg: ScanConfig,
              least_depth: int = 3, true_len=None):
    """Good-window and peak masks.

    hc: int [..., coder_num, L] per-position table counts; true_len: None,
    an int, or an int tensor [...] bounding the peak conditions per row.
    Returns good, peak: bool [..., L]."""
    L = hc.shape[-1]
    w = cfg.peak_w
    window = cfg.window
    dev = hc.device
    hit = hc == least_depth
    single = hit.any(dim=-2)
    trio = hit.all(dim=-2)

    s1 = torch.cumsum(single, dim=-1, dtype=torch.int32)
    s3 = torch.cumsum(trio, dim=-1, dtype=torch.int32)
    pad = window + 2 * k + 4 * w + 8  # covers every negative S offset used
    s1p = torch.nn.functional.pad(s1, (pad, 0))
    s3p = torch.nn.functional.pad(s3, (pad, 0))

    def shifted(sp, off):
        return sp[..., pad + off : pad + off + L]

    one_cnt = s1 - shifted(s1p, -window)
    three_cnt = s3 - shifted(s3p, -window)
    good = ((one_cnt >= truncated_min(window, cfg.hit_ratio))
            & (three_cnt >= truncated_min(window, cfg.match_ratio)))

    j = torch.arange(L, device=dev)
    in_range = j > (2 * k + 2 * w)  # strict, cpp:644
    if true_len is not None:
        tl = torch.as_tensor(true_len, device=dev)
        if tl.dim():
            tl = tl[..., None]
        in_range = in_range & (j < tl)
    right = s1 - shifted(s1p, -w)
    base_left = (shifted(s1p, -w) - shifted(s1p, -2 * w)
                 - shifted(s1p, -k - w) + shifted(s1p, -k - 2 * w))
    peak = torch.zeros(good.shape, dtype=torch.bool, device=dev)
    for m in range(k, 2 * k, cfg.skip_a):
        diff = (base_left + shifted(s1p, -m - w) - shifted(s1p, -m - 2 * w)
                - right)
        neg = in_range & (diff <= -cfg.peak_diff)      # marks position j
        pos = in_range & (diff >= cfg.peak_diff)       # marks position j-m-w
        sh = m + w
        peak |= neg | torch.nn.functional.pad(pos[..., sh:], (0, sh))
    return good, peak
