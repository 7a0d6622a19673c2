"""The synthetic data pipeline (the reference's :mod:`repro.data`)."""
from .pipeline import DataConfig, Prefetcher, SyntheticCorpus, make_batches

__all__ = ["DataConfig", "Prefetcher", "SyntheticCorpus", "make_batches"]
