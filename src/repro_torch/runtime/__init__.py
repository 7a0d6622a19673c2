"""Fault-tolerant training runtime, the port of :mod:`repro.runtime`: the
:class:`~repro_torch.runtime.trainer.Trainer` with the paper's three
failure semantics at training-step granularity (BLANK / SHRINK / REBUILD),
over replicas simulated on one card, and the replica-mesh topology of
:mod:`~repro_torch.runtime.elastic`."""
