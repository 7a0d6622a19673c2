"""Command-line launchers of the port (the reference's :mod:`repro.launch`).

Only the QR-serving route of :mod:`repro_torch.launch.serve` is ported; the
model-serving, training and dry-run launchers wait for the model zoo and the
trainer (ROADMAP A.12, A.13, A.15).
"""
