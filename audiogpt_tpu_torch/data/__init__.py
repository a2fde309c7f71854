"""Data pipeline: the record store, opening a split, and the fixed-shape
host loader (counterpart of ``audiogpt_tpu/data``, the parts the ported
recipes use). ``audioset_labels.csv`` beside these modules is the SED
engines' label table."""

from audiogpt_tpu_torch.data.binarizer import load_split
from audiogpt_tpu_torch.data.loader import ArrayDataLoader, collate_mel_image
from audiogpt_tpu_torch.data.records import RecordDataset, RecordWriter

__all__ = ["ArrayDataLoader", "collate_mel_image", "load_split",
           "RecordDataset", "RecordWriter"]
