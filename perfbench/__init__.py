"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints
one JSON line. Everything the harness runs is found by name:

- a configuration: ``BENCHMARK.json``'s ``configs[].file``, a JSON file of
  the published sizes plus the port's engine settings (``spec.py``);
- a traffic mix: ``traffic/<name>.json``, read by one generator
  (``traffic.py``);
- a metric: ``metrics/<name>.py``, a reader with ``read(rec)`` that returns
  a number or None (``metrics/__init__.py`` documents ``rec``);
- the plain reference that decides ``correct``: ``reference/<kind>.py``.

Nothing here imports ``jax`` or the JAX package ``repro``.
"""
