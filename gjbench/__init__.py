"""gjbench: the benchmark of ``repro_torch`` on the card.

One command runs one cell once (see ``README.md``)::

    python3 gjbench/run.py --workload lastfm.a2_rows --seed 7 --seconds 51 --trace 0

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``.
"""
