"""The port's benchmark harness: one cell of ``BENCHMARK.json`` a run.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own under ``perfbench/`` that the harness finds
by name: ``configs/<config>.json``, ``traffic/<mix>.json`` (its ``kind``
names the runner module ``harness/<kind>.py``), ``cells/<cell>.json``
(the cell's fixed rate and the limits that decide ``correct``) and
``metrics/<metric>.py`` (a reader with ``read(run) -> float | None``).
"""
