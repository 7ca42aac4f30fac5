"""The benchmark of ``autoscaler_tpu_torch``, the PyTorch and CUDA port.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on one card:

    python3 -m portbench.run --workload burst.k2 --seed 7 --seconds 30 --trace 0

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment's sizes and distributions, and
  the name of its ``estimate``: the system under test
  (``entries/<estimate>.py``) and its plain reference
  (``reference/<estimate>.py``);
- ``traffic/<traffic>.json``: the loop, the pool of worlds, the units;
- ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` → a number,
  or None where the run gave it nothing to read.

The general code reads them: ``spec`` (the files), ``worlds`` (the one
generator), ``loop`` (the closed loop), ``trace`` (the profiler's
reduction), ``roofline`` (peaks and least times), ``check`` (what decides
``correct``) and ``bench`` (one run). Nothing here imports JAX or the JAX
package, and nothing reads ``benchmarks/``, ``bench.py`` or
``chip_smoke.py``.
"""
