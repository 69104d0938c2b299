"""The benchmark of symtensor_tpu_torch on an NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` in one process and
prints one JSON line. What a cell is made of lives in files found by name
(``spec.py``); README.md says which. Nothing here imports jax or the JAX
package, and neither ``reference/`` nor ``yardsticks/`` imports anything of
the port.
"""
