"""Port parity above 4,096 reference columns, where kernels K1 (sw_align)
and K2 (sw_score) run in bands on the card: their plain versions against
the JAX package's O(MN) numpy oracle, lax.scan formulation and Pallas
kernels in interpret mode, none of which has a width limit. Comparisons
are exact; where scores grow past 2^31 / N, Pallas's int32 row best
wraps, and lax.scan is the reference. (The band schedule itself, written out in numpy, is held to Pallas in
tests/test_torch_sw.py.) And a band launch that the card refuses
raises: a stub library stands in for the kernels' build."""

import contextlib
import ctypes
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localhgt_tpu.ops import pallas_sw
from localhgt_tpu.ops import sw as jax_sw
from localhgt_tpu_torch.ops import cuda_sw

WIDTHS = [cuda_sw.WIDE_MAX_N + 1, 5000]


def _tie_heavy_wide(seed, B, M, N):
    """2-letter alphabet, each query planted with a 1-5 bp insertion
    across the first band's edge (column 4,096) or past it."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2, (B, M)).astype(np.uint8)
    r = rng.integers(0, 2, (B, N)).astype(np.uint8)
    for b in range(B):
        ins = int(rng.integers(1, 6))
        cut = int(rng.integers(4, M - 4))
        seg = np.concatenate([q[b, :cut],
                              rng.integers(0, 2, ins).astype(np.uint8),
                              q[b, cut:]])
        # the segment's last base at column 4,096 or past it
        off = int(rng.integers(cuda_sw.WIDE_MAX_N + 1 - len(seg),
                               N - len(seg) + 1))
        r[b, off:off + len(seg)] = seg
    r[1, :] = 4  # unalignable: zero-score row
    return q, r


@pytest.mark.parametrize("N, M", [(WIDTHS[0], 2), (WIDTHS[1], 1)])
def test_sw_align_plain_matches_oracle_past_the_block(N, M):
    """The O(MN) oracle takes seconds a query row at this width, so it
    sees one short query whose first base no earlier column holds: at
    N = 4,097 two rows whose diagonal crosses from column 4,095 to 4,096,
    at 5,000 one base at column 4,096."""
    rng = np.random.default_rng(N)
    r = rng.integers(0, 4, (1, N)).astype(np.uint8)
    lead = cuda_sw.WIDE_MAX_N + 1 - M  # the query's first column
    r[0, :lead] = rng.integers(1, 4, lead)  # no base 0 before it
    r[0, lead] = 0
    q = r[:, lead:lead + M].copy()
    got = cuda_sw.sw_align(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    assert tuple(got[0]) == jax_sw.sw_align_np(q[0], r[0])
    assert got[0, 0] == M and got[0, 4] >= cuda_sw.WIDE_MAX_N


@pytest.mark.parametrize("N", WIDTHS)
def test_sw_align_plain_matches_pallas_and_lax_scan_past_the_block(N):
    """Every field against Pallas in interpret mode; score and ends
    against lax.scan, which breaks E ties the other way (ROADMAP F1)."""
    B, M = 8, 64
    q, r = _tie_heavy_wide(N, B, M, N)
    got = cuda_sw.sw_align(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    # every alignment but the unalignable row ends in the second band
    assert got[1, 0] == 0
    assert (np.delete(got[:, 4], 1) >= cuda_sw.WIDE_MAX_N).all()
    want = np.asarray(pallas_sw.sw_align_pallas(
        jnp.asarray(q), jnp.asarray(r), tile=B, interpret=True))
    np.testing.assert_array_equal(got, want)
    scan = jax_sw.sw_align(jnp.asarray(q), jnp.asarray(r))
    for i, f in enumerate(jax_sw._FIELDS):
        if f in ("score", "qend", "rend"):
            np.testing.assert_array_equal(got[:, i], np.asarray(scan[f]),
                                          err_msg=f)


def test_sw_align_plain_row_best_where_h_times_n_passes_int32():
    """Where no parameter decays, H grows along every row, and at N =
    50,000 H * N passes 2^31: the plain version picks each row's best in
    int64 (the kernels keep H and the column apart) and equals lax.scan,
    which takes the first maximum of the whole matrix, in score and ends
    (its E ties go the other way, ROADMAP F1). Pallas packs H * N + (N - 1
    - j) in int32, and its row best wraps: its rend lies past N."""
    rng = np.random.default_rng(50_000)
    B, M, N = 2, 3, 50_000
    q = rng.integers(0, 4, (B, M)).astype(np.uint8)
    r = rng.integers(0, 4, (B, N)).astype(np.uint8)
    kw = dict(match=2, mismatch=1, gap_open=1, gap_ext=1)
    got = cuda_sw.sw_align(torch.from_numpy(q), torch.from_numpy(r),
                           **kw).numpy()
    assert (got[:, 0].astype(np.int64) * N >= 1 << 31).all()
    scan = jax_sw.sw_align(jnp.asarray(q), jnp.asarray(r), **kw)
    for i, f in enumerate(jax_sw._FIELDS):
        if f in ("score", "qend", "rend"):
            np.testing.assert_array_equal(got[:, i], np.asarray(scan[f]),
                                          err_msg=f)
    np.testing.assert_array_equal(got[:, 2:5:2], [[M - 1, N - 1]] * B)
    pallas = np.asarray(pallas_sw.sw_align_pallas(
        jnp.asarray(q), jnp.asarray(r), tile=B, interpret=True, **kw))
    assert (pallas[:, 4] >= N).all()


@pytest.mark.parametrize("N", WIDTHS)
def test_sw_score_plain_matches_lax_scan_and_pallas_past_the_block(N):
    B, M = 8, 64
    q, r = _tie_heavy_wide(N + 1, B, M, N)
    got = cuda_sw.sw_score(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_sw.sw_score(jnp.asarray(q), jnp.asarray(r))))
    np.testing.assert_array_equal(got, np.asarray(pallas_sw.sw_score_pallas(
        jnp.asarray(q), jnp.asarray(r), tile=B, interpret=True)))


STUB = r"""
#include <stdint.h>
// the band entry points of csrc/sw.cu as a card that refuses the cluster
// launch answers: cudaErrorLaunchOutOfResources (701); 702 where the
// caller passed no wrap buffer
extern "C" int lht_sw_align_bands(const uint8_t*, const uint8_t*, int32_t*,
                                  long long, int, int, int, int, int, int,
                                  void* wrap, void*) {
  return wrap ? 701 : 702;
}
extern "C" int lht_sw_score_bands(const uint8_t*, const uint8_t*, int32_t*,
                                  long long, int, int, int, int, int, int,
                                  void* wrap, void*) {
  return wrap ? 701 : 702;
}
"""


@pytest.mark.parametrize("fn", ["lht_sw_align_bands", "lht_sw_score_bands"])
def test_refused_band_launch_raises(fn, tmp_path, monkeypatch):
    """A band entry point that returns an error (no cluster of the bands'
    blocks fits the card) makes the launch raise: nothing falls back. Every
    band launch gets the wrap buffer, within the cluster's 8 bands and past
    them: the kernel decides whether it needs it."""
    src = tmp_path / "stub.cpp"
    src.write_text(STUB)
    so = tmp_path / "libstub.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    getattr(lib, fn).argtypes = cuda_sw.BANDS_SIGNATURE
    getattr(lib, fn).restype = ctypes.c_int
    # the launch's stream and device, which a CPU-only torch lacks
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    q = torch.zeros((2, 5), dtype=torch.uint8)
    out = torch.zeros((2, 5), dtype=torch.int32)
    for N in (cuda_sw.WIDE_MAX_N + 1, cuda_sw.WIDE_MAX_N * 8,
              cuda_sw.WIDE_MAX_N * 8 + 1):
        r = torch.zeros((2, N), dtype=torch.uint8)
        with pytest.raises(RuntimeError, match=f"{fn}: CUDA error 701"):
            cuda_sw.launch(lib, fn, q, r, out, 1, -4, -6, -1)
