"""The benchmark of the PyTorch / CUDA port (``easy_gaussian_splatting_torch``).

One command runs one cell once::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are in ``BENCHMARK.json`` at the repository
root; a configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, the kind of traffic it names ``kinds/<kind>.py``,
a per-layer metric's reader ``metrics/<name>.py``
and a cell's correctness limits ``limits/<cell>.json``, each found by the
name ``BENCHMARK.json`` gives. ``reference/`` is the plain PyTorch
reference that decides ``correct``; ``yardstick.py`` the peaks and the
operation and byte counts. Nothing here imports ``jax``, ``jaxlib``,
``flax`` or ``easy_gaussian_splatting_tpu``; ``reference/`` imports nothing
of the port either. See ``README.md``.
"""
