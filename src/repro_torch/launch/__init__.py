"""Command-line launchers of the port (the reference's :mod:`repro.launch`).

:mod:`repro_torch.launch.serve` serves QR requests and the transformer
models; :mod:`repro_torch.launch.train` trains them with the
fault-tolerant trainer and replays the stock trainer fault scenarios;
:mod:`repro_torch.launch.powersgd_dp` trains the reference example's
two-layer model with PowerSGD over 8 rank processes on a data × model mesh
(``examples/powersgd_dp.py``).  :mod:`repro_torch.launch.mesh` lays the
reference's meshes over the rank world.  The reference's dry-run launcher
(``launch/dryrun.py``) has no counterpart: its product is the partitioned
HLO of 512 placeholder devices on the production meshes, which waits for
the model axis of ROADMAP A.3e (``launch/shardings.py``); the dry run
itself is A.3f.
"""
