"""Vector indexes: the flat exact index, the int8 flat index, the IVF and
IVF-PQ indexes, the segmented index, and their snapshots."""

from codegraph_tpu_torch.index.flat import FlatIndex
from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex
from codegraph_tpu_torch.index.ivf import IVFIndex
from codegraph_tpu_torch.index.ivfpq import IVFPQIndex
from codegraph_tpu_torch.index.segments import SegmentedIndex
from codegraph_tpu_torch.index.snapshot import load_arrays, save_arrays

__all__ = [
    "FlatIndex",
    "Int8FlatIndex",
    "IVFIndex",
    "IVFPQIndex",
    "SegmentedIndex",
    "save_arrays",
    "load_arrays",
]
