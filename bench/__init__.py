"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix,
cell or metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it (``registry.py``):

* ``configs/<config>.json`` — the sizes, source and guarantees of a
  deployment, and the generator (``generators/<generator>.py``) that
  builds its matrix;
* ``traffic/<traffic>.json`` — the parameters of a traffic mix, read by
  the one driver in ``traffic.py``;
* ``cells/<cell>.json`` — a cell's correctness limits;
* ``metrics/<metric>.py`` — the reader of a metric (a metric split by the
  end-to-end metric it moves, ``<stem>.solve``/``<stem>.sweep``, shares
  the reader ``<stem>.py``).

The yardstick lives here too: the traffic, the reduction of traces to
metrics (``trace.py``), the frozen peaks and work functions
(``roofline_frozen.py``) and the plain reference that decides ``correct``
(``reference/``).  Nothing here imports ``jax`` or the JAX package.
"""
