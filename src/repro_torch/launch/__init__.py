"""Launchers: device meshes (``launch/mesh.py``), spawned ranks of one
world (``launch/ranks.py``), abstract cells, their shardings and their
placement as DTensors (``launch/specs.py``), the serving and training
CLIs (``python -m repro_torch.launch.serve`` / ``launch.train``), and the
dry run of every cell on a fake world (``launch/dryrun.py``, with
``op_analysis.py``, ``roofline.py`` and ``inspect_cell.py``)."""
