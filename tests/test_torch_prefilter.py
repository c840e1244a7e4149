"""Port parity of the align stage's seed prefilter (kernel K6's function).

`prefix_bitmap` against the JAX `build_bitmap`, `seed_prefilter_plain`
against the JAX `_seed_prefilter` (its jitted `pf`) on seeded draws, and a
numpy model of K6's schedule in csrc/seed.cu (a warp a read, lane l's
window of tile t at 32t + l, one ballot a stream and 32 positions, a
funnel shift a window, hr from hf, two probes a valid window and the exit
at the first tile that hits) against the plain version. Every comparison
is exact. The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from localhgt_tpu.pipeline import align as jax_align
from localhgt_tpu_torch import tune_seed
from localhgt_tpu_torch.ops import cuda_seed
from localhgt_tpu_torch.pipeline import align

U32 = 0xFFFFFFFF
LAST_WORD = (1 << 27) - 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefixes(rng, n=3_000) -> np.ndarray:
    """Sorted uint32 prefixes padded to a power of two by repeating the
    last, as SeedIndex.build pads them: random ones, a share with bit 31
    of their word, and three in the bitmap's last word (0xFFFFFFFF among
    them)."""
    p = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    p[: n // 4] |= 31
    p = np.unique(np.concatenate(
        [p, [U32, U32 - 1, (LAST_WORD << 5) | 3]]).astype(np.uint32))
    cap = 1 << (len(p) - 1).bit_length()
    return np.concatenate([p, np.full(cap - len(p), p[-1], np.uint32)])


@pytest.fixture(scope="module")
def index():
    """(port bitmap, JAX SeedIndex, prefixes) of one prefix set."""
    pre = _prefixes(np.random.default_rng(7))
    jidx = jax_align.SeedIndex(s=19, sorted_hash=np.zeros(0, np.uint64),
                               sorted_pos=np.zeros(0, np.int64),
                               prefix32=pre)
    bm = align.prefix_bitmap(align.SeedIndex(
        19, np.zeros(0, np.uint64), np.zeros(0, np.int64), prefix32=pre),
        "cpu")
    return bm, jidx, pre


def _draw(seed: int, B: int, L: int, pre: np.ndarray):
    """codes uint8 [B, L], lengths int32 [B]: lengths 0..L, 1% N codes,
    and a quarter of the reads with an indexed prefix planted at a start
    inside the read, on the forward or the reverse-complement strand."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.01] = 4
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:4] = (0, 15, 16, L)
    for b in np.flatnonzero(rng.random(B) < 0.25):
        if lengths[b] < 16:
            continue
        at = int(rng.integers(0, lengths[b] - 15))
        p = int(pre[rng.integers(0, len(pre))])
        codes[b, at:at + 16] = tune_seed.prefix_bases(p, rng.random() < 0.5)
    return codes, lengths


DRAWS = [(1, 2048, 64), (2, 2048, 192), (3, 2048, 192)]


def _plain(codes, lengths, bm) -> np.ndarray:
    return align.seed_prefilter_plain(
        torch.from_numpy(codes), torch.from_numpy(lengths), bm).numpy()


# ---- the numpy model of csrc/seed.cu --------------------------------------

M32 = np.uint64(U32)
EVEN = np.uint64(0x55555555)


def _brev(x):
    x = x.astype(np.uint64)
    for s, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                 (8, 0x00FF00FF)):
        m = np.uint64(m)
        x = ((x >> np.uint64(s)) & m) | ((x & m) << np.uint64(s))
    return ((x >> np.uint64(16)) | (x << np.uint64(16))) & M32


def _spread(x):
    for s, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                 (1, 0x55555555)):
        x = (x | (x << np.uint64(s))) & np.uint64(m)
    return x


def k6_model(codes: np.ndarray, lengths: np.ndarray, bitmap: np.ndarray):
    """(out bool [B], probes issued): K6's schedule with the B warps of a
    launch as the rows of each array and their 32 lanes as the columns."""
    B, L = codes.shape
    lim = np.minimum(lengths.astype(np.int64), L)
    lane = np.arange(32, dtype=np.int64)
    rows = np.arange(B)[:, None]
    bmu = bitmap.view(np.uint32)

    def load(p):  # a lane's code at position p: a non-base at or past lim
        p = np.broadcast_to(p, (B, 32))
        c = codes[rows, np.clip(p, 0, L - 1)].astype(np.uint64)
        return np.where(p < lim[:, None], c, np.uint64(4))

    def streams(c):  # one ballot a bit, reversed: position 0 at bit 31
        preds = ((c & np.uint64(1)) != 0, (c & np.uint64(2)) != 0,
                 c > np.uint64(3))
        return [_brev((p.astype(np.uint64) << lane.astype(np.uint64))
                      .sum(axis=1)) for p in preds]

    def window16(hi, lo):  # __funnelshift_l(lo, hi, lane) >> 16
        cat = (hi << np.uint64(32)) | lo
        return (((cat[:, None] << lane.astype(np.uint64)) >> np.uint64(32))
                & M32) >> np.uint64(16)

    out = np.zeros(B, bool)
    done = np.zeros(B, bool)
    probes = 0
    h = streams(load(lane))
    c = load(32 + lane)
    j0 = 0
    while True:
        active = ~done & (j0 <= lim - 16)
        if not active.any():
            return out, probes
        lo = streams(c)
        c = load(j0 + 64 + lane)
        ok = (window16(h[2], lo[2]) == 0) & active[:, None]
        hf = (_spread(window16(h[1], lo[1])) << np.uint64(1)) | \
            _spread(window16(h[0], lo[0]))
        t = _brev(~hf & M32)
        hr = ((t >> np.uint64(1)) & EVEN) | ((t & EVEN) << np.uint64(1))
        probes += 2 * int(ok.sum())

        def bit(hh):
            w = bmu[(hh >> np.uint64(5)).astype(np.int64)].astype(np.uint64)
            return (w >> (hh & np.uint64(31))) & np.uint64(1)

        hit = ok & ((bit(hf) | bit(hr)) != 0)
        tile_hit = hit.any(axis=1)
        out |= tile_hit
        done |= tile_hit
        h = lo
        j0 += 32


# ---- the tests ------------------------------------------------------------


@pytest.mark.parametrize("case", ["index", "empty"])
def test_prefix_bitmap_equals_jax_build_bitmap(index, case):
    bm, _, pre = index
    if case == "empty":
        pre = np.zeros(0, np.uint32)
        bm = align.prefix_bitmap(align.SeedIndex(
            19, np.zeros(0, np.uint64), np.zeros(0, np.int64)), "cpu")
    jax_align._ensure_pf_jit()
    want = np.asarray(jax_align._PF_JIT[0](jnp.asarray(pre)))
    got = bm.numpy()
    assert got.dtype == np.int32 and got.shape == (1 << 27,)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if case == "index":  # bit 31 and the last word are set
        assert got[LAST_WORD] < 0 and int(np.count_nonzero(got)) > 1000


@pytest.mark.parametrize("seed,B,L", DRAWS)
def test_seed_prefilter_plain_equals_jax(index, seed, B, L):
    bm, jidx, pre = index
    codes, lengths = _draw(seed, B, L, pre)
    want = jax_align._seed_prefilter(codes, lengths, jidx)
    got = _plain(codes, lengths, bm)
    assert np.array_equal(got, want)
    assert 0.1 < got.mean() < 0.4  # planted reads pass, most others fail
    assert not got[:2].any()        # lengths 0 and 15: no window


@pytest.mark.parametrize("seed,B,L", DRAWS)
def test_k6_schedule_model_equals_plain(index, seed, B, L):
    bm, _, pre = index
    codes, lengths = _draw(seed, B, L, pre)
    want = _plain(codes, lengths, bm)
    got, probes = k6_model(codes, lengths, bm.numpy())
    assert np.array_equal(got, want)
    # the kernel probes at least what the function needs, and no more
    # than two probes a window start
    work = tune_seed.prefilter_work(torch.from_numpy(codes),
                                    torch.from_numpy(lengths), bm)
    starts = int(np.maximum(np.minimum(lengths, L) - 15, 0).sum())
    assert work["probes"] <= probes <= 2 * starts


def test_prefilter_work_counts_to_the_first_hit(index):
    """One read that never hits, one whose forward window at 10 hits, one
    whose reverse window at 0 hits, one of length 15."""
    bm, _, pre = index
    rng = np.random.default_rng(5)
    codes = np.full((4, 64), 1, np.uint8)  # all C: not in the index
    for p in (0x55555555, 0xAAAAAAAA):     # its forward and reverse hash
        assert not int(bm[p >> 5]) >> (p & 31) & 1
    lengths = np.array([64, 64, 40, 15], np.int32)
    codes[1, 10:26] = tune_seed.prefix_bases(int(pre[5]), False)
    codes[2, 0:16] = tune_seed.prefix_bases(int(pre[9]), True)
    codes[2, 16:40] = rng.integers(0, 4, 24)
    work = tune_seed.prefilter_work(torch.from_numpy(codes),
                                    torch.from_numpy(lengths), bm)
    assert work["windows"] == 49 + 11 + 1
    assert work["code_bytes"] == 64 + 26 + 16
    assert work["reads_hit"] == 2
    # read 1's forward hit is its 21st probe, read 2's reverse its second
    assert work["probes"] == 2 * 49 + (2 * 11 - 1) + 2
    assert work["bytes"] == work["code_bytes"] + 5 * 4 + 32 * work["sectors"]


def test_chip_smoke_inputs_carry_their_edge_rows():
    """tune_seed.inputs (chip_smoke.py's K6 rows) at a small size: the edge
    rows give what they are built for, and planted reads pass."""
    codes, lengths, bm = tune_seed.inputs(
        "bkp", torch.device("cpu"), shape=(512, 192), ref_bp=20_000)
    got = align.seed_prefilter_plain(codes, lengths, bm).numpy()
    assert got[:12].tolist() == [False, False, True, True, True, True, True,
                                 False, False, False, False, True]
    assert lengths[:12].tolist() == [0, 15, 16, 192, 192, 192, 150, 149,
                                     150, 150, 192, 192]
    assert 0 < got[12:].sum() < 20
    got_model, _ = k6_model(codes.numpy(), lengths.numpy(), bm.numpy())
    assert np.array_equal(got_model, got)


def test_seed_prefilter_device_runs_the_plain_version_on_the_cpu(index):
    bm, _, pre = index
    codes, lengths = _draw(4, 256, 192, pre)
    n0 = cuda_seed.seed_prefilter.launches
    got = align.seed_prefilter_device(torch.from_numpy(codes),
                                      torch.from_numpy(lengths), bm)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), _plain(codes, lengths, bm))
    assert cuda_seed.seed_prefilter.launches == n0


def test_the_kernel_wrapper_raises_on_cpu_tensors(index):
    bm, _, _ = index
    codes = torch.zeros((4, 64), dtype=torch.uint8)
    lengths = torch.full((4,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_seed.seed_prefilter(codes, lengths, bm)
