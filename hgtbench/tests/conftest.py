"""A tiny benchmark in a temporary folder: one k-mer cell and one direct
cell at k=18 over 4 x 20 kb genomes, and the k-mer cell's settings with
QC on raw reads that need it, with the real metric readers, for the tests
that drive a run on the CPU."""

import json
import shutil

import pytest

from hgtbench import registry

TINY_TRAFFIC = {"depth": 5, "hgt_num": 2, "snp_rate": 0.01,
                "indel_rate": 0.001, "read_len": 150, "mean_frag": 350,
                "frag_sd": 10, "seq_error": 0.002, "min_hgt_len": 500,
                "max_hgt_len": 55000, "reverse_prob": 0.5, "donor_in": True,
                "pool": 2, "checked": 1}
# raw reads: short inserts that read into the adapters, and pairs that
# fastp's filter drops
TINY_RAW = {**TINY_TRAFFIC, "adapter_frac": 0.05, "adapter_insert": "60-140",
            "lowq_frac": 0.02}


@pytest.fixture
def tiny_bench(tmp_path):
    """(spec, bench_dir) of a benchmark with cells tiny.kmer, tiny.direct
    and tiny.qc."""
    src = registry.BENCH_DIR
    d = tmp_path / "bench"
    for sub in ("layers", "end_to_end"):
        shutil.copytree(src / sub, d / sub)
    (d / "configs").mkdir()
    (d / "traffic").mkdir()
    for name, base, qc in (("tiny_k18", "sim100_k32", 0),
                           ("tiny_direct", "species20_direct", 0),
                           ("tiny_k18_qc", "sim100_k32", 1)):
        c = json.loads((src / "configs" / f"{base}.json").read_text())
        c.update(name=name, n_genomes=4, genome_len=20_000, k=18,
                 refine_fq=qc)
        (d / "configs" / f"{name}.json").write_text(json.dumps(c))
    (d / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (d / "traffic" / "tiny_raw.json").write_text(json.dumps(TINY_RAW))
    spec = registry.load_spec()
    spec["workloads"] = [
        {"name": "tiny.kmer", "config": "tiny_k18", "traffic": "tiny",
         "chips": 1, "why": "test"},
        {"name": "tiny.direct", "config": "tiny_direct", "traffic": "tiny",
         "chips": 1, "why": "test"},
        {"name": "tiny.qc", "config": "tiny_k18_qc", "traffic": "tiny_raw",
         "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    return spec, d
