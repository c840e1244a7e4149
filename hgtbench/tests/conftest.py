"""A tiny benchmark in a temporary folder: one k-mer cell and one direct
cell at k=18 over 4 x 20 kb genomes, with the real metric readers, for
the tests that drive a run on the CPU."""

import json
import shutil

import pytest

from hgtbench import registry

TINY_TRAFFIC = {"depth": 5, "hgt_num": 2, "snp_rate": 0.01,
                "indel_rate": 0.001, "read_len": 150, "mean_frag": 350,
                "frag_sd": 10, "seq_error": 0.002, "min_hgt_len": 500,
                "max_hgt_len": 55000, "reverse_prob": 0.5, "donor_in": True,
                "pool": 2, "checked": 1}


@pytest.fixture
def tiny_bench(tmp_path):
    """(spec, bench_dir) of a benchmark with cells tiny.kmer, tiny.direct."""
    src = registry.BENCH_DIR
    d = tmp_path / "bench"
    for sub in ("layers", "end_to_end"):
        shutil.copytree(src / sub, d / sub)
    (d / "configs").mkdir()
    (d / "traffic").mkdir()
    for name, base in (("tiny_k18", "sim100_k32"),
                       ("tiny_direct", "species20_direct")):
        c = json.loads((src / "configs" / f"{base}.json").read_text())
        c.update(name=name, n_genomes=4, genome_len=20_000, k=18)
        (d / "configs" / f"{name}.json").write_text(json.dumps(c))
    (d / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    spec = registry.load_spec()
    spec["workloads"] = [
        {"name": "tiny.kmer", "config": "tiny_k18", "traffic": "tiny",
         "chips": 1, "why": "test"},
        {"name": "tiny.direct", "config": "tiny_direct", "traffic": "tiny",
         "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    return spec, d
