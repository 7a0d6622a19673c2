"""Numpy ground truth for the TSQR variants (:mod:`.ref`)."""
