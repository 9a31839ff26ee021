"""bwt_tpu_torch — the FM-index sequence-search engine on PyTorch and CUDA.

The PyTorch port of ``bwt_tpu``: index build (prefix-doubling suffix
sort, BWT, fused rank buckets), batched FM-index queries (backward
search, locate, MMS) and the ``single_align`` seed-and-extend aligner,
whose DP stitches run as one launch of a hand-written CUDA kernel on the
card (``csrc/dp_stitch.cu``).  Results are bit-equal to ``bwt_tpu``'s.

Quick start::

    import bwt_tpu_torch
    from bwt_tpu_torch.ops import search

    fmi = bwt_tpu_torch.build_index(genome_text)  # on the card if present
    positions = search.locate(fmi, read_codes, read_lens)
"""

__version__ = "0.1.0"

from bwt_tpu_torch import codec
from bwt_tpu_torch.config import DEFAULT as DEFAULT_CONFIG
from bwt_tpu_torch.config import Config
from bwt_tpu_torch.index import FMIndex, build_index, from_numpy
from bwt_tpu_torch.io import (
    read_npz_index,
    read_ref_index,
    write_npz_index,
    write_ref_index,
)

__all__ = [
    "codec",
    "Config",
    "DEFAULT_CONFIG",
    "FMIndex",
    "build_index",
    "from_numpy",
    "read_npz_index",
    "read_ref_index",
    "write_npz_index",
    "write_ref_index",
]
