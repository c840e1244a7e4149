"""Port parity: the count cap `least_depth` at k > 30, where the JAX
package's tables are 4-bit fields. A cap above 7 is refused when the count
stage starts, with the JAX package's message, on one device and over a
mesh; a cap of 7 counts as before; and the conversion to the JAX layout
(the `--count_ckpt` file format) refuses a count that its fields cannot
hold."""

import numpy as np
import pytest
import torch

from localhgt_tpu.config import Config, KmerConfig
from localhgt_tpu.ops import count as jax_count
from localhgt_tpu.ops import encode as jax_encode
from localhgt_tpu.sim.simulate import SimParams, simulate_sample
from localhgt_tpu_torch.ops import count
from localhgt_tpu_torch.parallel import extract_sharded
from localhgt_tpu_torch.parallel.mesh import make_flat_mesh
from localhgt_tpu_torch.pipeline import extract


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fastqs(tmp_path_factory):
    pa = SimParams(n_genomes=2, genome_len=6000, hgt_num=1, depth=3, seed=3)
    _, fq1, fq2, _ = simulate_sample(str(tmp_path_factory.mktemp("ld")),
                                     "ld", pa)
    return fq1, fq2


def _jax_error(k, cap):
    with pytest.raises(ValueError) as e:
        jax_count.clip_every_batches(k, cap)
    return str(e.value)


@pytest.mark.parametrize("where", ["one_device", "mesh"])
@pytest.mark.parametrize("cap", [8, 16])
def test_least_depth_above_7_at_k32_raises_as_in_jax(fastqs, where, cap):
    """The port raises before it allocates a table (a k=32 table is 4 GiB
    of int8), with the message the JAX package's count stage raises."""
    cfg = Config().replace(kmer=KmerConfig(k=32, least_depth=cap))
    masks, _ = jax_encode.hasher_for(32, 3, seed=1)
    with pytest.raises(ValueError) as e:
        if where == "mesh":
            extract_sharded.count_kmers_sharded(
                make_flat_mesh(["cpu"] * 2), *fastqs, masks, cfg)
        else:
            extract.count_kmers(*fastqs, masks, cfg, "cpu")
    assert str(e.value) == _jax_error(32, cap)


@pytest.mark.parametrize("k", [31, 32])
def test_least_depth_7_and_narrow_tables_pass_the_rule(k):
    """The rule's edges are the JAX package's: a cap of 7 passes at k > 30,
    and any cap passes at k <= 30."""
    jax_count.clip_every_batches(k, 7)
    count.check_least_depth(k, 7)
    assert _jax_error(k, 8) == str(
        pytest.raises(ValueError, count.check_least_depth, k, 8).value)
    jax_count.clip_every_batches(30, 16)
    count.check_least_depth(30, 16)


def test_least_depth_7_counts_as_before(fastqs):
    """A cap of 7 saturates at 7, exactly as the JAX count stage does, on
    one device and over a mesh of three shards."""
    from localhgt_tpu.pipeline import extract as jax_extract

    cfg = Config().replace(kmer=KmerConfig(k=14, least_depth=7))
    masks, _ = jax_encode.hasher_for(14, 3, seed=1)
    want, _, _, _ = jax_extract.count_kmers(*fastqs, masks, cfg)
    got, _, _, _ = extract.count_kmers(*fastqs, masks, cfg, "cpu")
    sharded, _, _ = extract_sharded.count_kmers_sharded(
        make_flat_mesh(["cpu"] * 3), *fastqs, masks, cfg)
    for w, g, s in zip(want, got, sharded):
        w = np.asarray(w)
        assert w.max() == 7
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(torch.cat(s).numpy(), w)


def test_tables_to_jax_refuses_a_count_above_15():
    t = torch.zeros(64, dtype=torch.int8)
    t[9] = 15
    (words,) = count.tables_to_jax([t], 32)
    assert jax_count.table_lookup_np(words, np.array([9]))[0] == 15
    t[9] = 16
    with pytest.raises(ValueError, match="does not fit"):
        count.tables_to_jax([t], 32)
    # an int8 table of k <= 30 is the JAX layout itself: 16 is kept
    np.testing.assert_array_equal(count.tables_to_jax([t], 6)[0], t.numpy())
