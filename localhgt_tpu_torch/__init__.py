"""PyTorch + CUDA port of the localhgt_tpu HGT detection engine.

The JAX package `localhgt_tpu` stays the reference; this package computes
the same `bkp` outputs with plain torch ops around three hand-written CUDA
kernels for Hopper (`csrc/sw.cu`, `csrc/vote.cu`). It imports nothing of
`localhgt_tpu`: the host modules it needs (FASTA/FASTQ IO and the C++
reader, config, the simulator, rawbkp, event, the host analyses) are its
own copies under the same relative names, held equal to the originals by
tests/test_torch_host.py.

Every device function takes an explicit `device`; nothing falls back to
the CPU. A CPU tensor runs each kernel's plain torch version, which is what
the CPU tests hold against the JAX package.
"""
