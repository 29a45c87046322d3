"""The benchmark of the PyTorch/CUDA port (``mirage_tpu_torch``) on NVIDIA
H100 cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root lists the cells, their
configurations, the end-to-end metrics with their bounds and the per-layer
metrics. Everything here is found by name:

- ``configs/<config>.json``: a model configuration, its sizes as run;
- ``traffic/<mix>.json``: a traffic mix's parameters, read by the driver
  it names, ``drivers/<driver>.py`` (``volumes``: inference through the
  wrapper; ``pretrain`` and ``segtune``: training steps as the CLIs build
  them);
- ``cells/<cell>.json``: the limits of a cell's check;
- ``metrics/<name>.py`` (or ``<base>.py`` for ``<base>.<mode>``): a
  metric's reader;
- ``reference/``: the plain float32 model, losses and optimizer the
  checks compare against (it imports nothing of the port);
- ``work.py``: the operations and bytes of a call, counted from shapes;
  ``peaks.py``: the card's peaks; ``trace.py``: the profiler's reduction;
- ``control.py``: the readings the limits are set from (not part of a run);
- ``tests/``: ``python -m pytest benchmark/tests`` (``-m card`` on a card).

A new cell, configuration, traffic mix or metric is new files here and new
entries in ``BENCHMARK.json``.
"""
