"""Command-line launchers of the port (the reference's :mod:`repro.launch`).

:mod:`repro_torch.launch.serve` serves QR requests and the transformer
models; :mod:`repro_torch.launch.train` trains them with the
fault-tolerant trainer and replays the stock trainer fault scenarios.  The
reference's dry-run launcher (``launch/dryrun.py``) has no counterpart: its
product is the partitioned HLO of 512 placeholder devices on the production
meshes, which one card does not have before the mesh layouts of ROADMAP
A.3e (``launch/mesh.py``, ``launch/shardings.py``) exist; the dry run itself
is A.3f.
"""
