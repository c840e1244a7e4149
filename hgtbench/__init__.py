"""The benchmark of the PyTorch and CUDA port, `localhgt_tpu_torch`.

`python3 -m hgtbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on one CUDA card
(run.py). A cell names a configuration (configs/<name>.json) and a
traffic mix (traffic/<name>.json); each metric has a reader
(end_to_end/<name>.py, layers/<name>.py). `correct` compares the
program's outputs with the plain reference in plainref/ (check.py);
control.py runs that reference with one guarantee broken. CPU tests:
`python -m pytest hgtbench/tests`. Nothing here imports JAX or the JAX
package, and nothing the reference runs imports the port.
"""
