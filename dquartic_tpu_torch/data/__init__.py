"""Pair datasets and host -> device streaming (port of :mod:`dquartic_tpu.data`).
The sqMass reader (:mod:`.sqmass`) and the slice generator (:mod:`.slices`)
import pandas and pyarrow, so they load only when imported by name."""

from .dataset import DIAMSDataset, PairBatches
from .pipeline import prefetch_iterator

__all__ = ["DIAMSDataset", "PairBatches", "prefetch_iterator"]
