"""Command-line launchers of the port (the reference's :mod:`repro.launch`).

:mod:`repro_torch.launch.serve` serves QR requests and the transformer
models; :mod:`repro_torch.launch.train` trains them with the
fault-tolerant trainer and replays the stock trainer fault scenarios.  The
dry-run launcher waits for ROADMAP A.15, the production meshes
(``launch/mesh.py``, ``launch/shardings.py``) for A.3b.
"""
