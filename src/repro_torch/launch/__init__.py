"""Launchers: device meshes (``launch/mesh.py``), spawned ranks of one
world (``launch/ranks.py``), the serving and training CLIs
(``python -m repro_torch.launch.serve`` / ``launch.train``)."""
