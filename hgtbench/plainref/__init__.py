"""The benchmark's plain reference: `pipeline/bkp.py::run` works a sample
out again from the same reference FASTA and FASTQ files the program read.

Frozen copies of the port's modules of the same names (config, the FASTA
and FASTQ readers, the k-mer count, scan, peak map and vote, the aligner,
rawbkp, accbkp and the acc.csv writer), on one device, with each of the
port's kernels replaced by its plain torch version (ops/sw_plain.py for
K1 and K2, ops/vote_plain.py for K3, the plain hashing, count and seed
prefilter for K4 to K6), FASTQ parsed by numpy and seeds looked up by
numpy (the numpy path of the JAX package's aligner) where the port uses
its C++ library. QC (`--refine_fq`) is io/qc.py, written from fastp's
rules, not copied from the port's vectorised one. No mesh, no count
checkpoint. It imports nothing of the port, of the JAX package or of JAX,
and takes nothing the program made: it reads the FASTA itself, not the
port's cached index of it.
"""
