"""Launchers: device meshes (``launch/mesh.py``), spawned ranks of one
world (``launch/ranks.py``), abstract cells, their shardings and the
placement of a model's parameters as DTensors (``launch/specs.py``), the
serving and training CLIs (``python -m repro_torch.launch.serve`` /
``launch.train``)."""
