"""PyTorch + CUDA port of the localhgt_tpu HGT detection engine.

The JAX package `localhgt_tpu` stays the reference; this package computes
the same `bkp` outputs with plain torch ops around three hand-written CUDA
kernels for Hopper (`csrc/sw.cu`, `csrc/vote.cu`). Host-only modules of the
reference (FASTA/FASTQ IO, config, the simulator, rawbkp, event) are
imported from `localhgt_tpu`, never copied; none of them imports jax.

Every device function takes an explicit `device`; nothing falls back to
the CPU. A CPU tensor runs each kernel's plain torch version, which is what
the CPU tests hold against the JAX package.
"""
