"""Index persistence.

Two formats, both readable and writable by ``bwt_tpu`` as well:
  * the reference binary format (fileio.c:8-18): ``int32 len | int32
    C[5] | int32 endloc | int32 idxs[1+len/32] | uint8 bwt[(len+3)/4]``
    (little-endian, big-endian-within-byte 2-bit packing); rank
    checkpoints are rebuilt on load (fileio.c:62-63);
  * the npz v2 schema: ``version, length (int64), sa_rate, bwt_words
    (uint32), buckets, sa_samples, C, endloc[, isa_samples]``.
"""

from __future__ import annotations

import io as _io
from pathlib import Path

import numpy as np

from bwt_tpu_torch import codec
from bwt_tpu_torch.index import FMIndex, from_numpy, index_from_parts


def write_ref_index(fmi: FMIndex, path) -> None:
    """Serialize in the reference's fileio.c format (SA samples at rate
    32; denser indexes are downsampled)."""
    fmi.require_whole("write_ref_index")
    if fmi.sa_rate > 32 or 32 % fmi.sa_rate:
        raise ValueError(
            f"reference format needs sa_rate dividing 32, got {fmi.sa_rate}")
    samples = fmi.sa_samples.cpu().numpy()[:: 32 // fmi.sa_rate]
    words = fmi.bwt_words[:-1].cpu().numpy().view(np.uint32)
    buf = _io.BytesIO()
    buf.write(np.int32(fmi.length).tobytes())
    buf.write(fmi.C.cpu().numpy().astype("<i4").tobytes())
    buf.write(np.int32(int(fmi.endloc)).tobytes())
    buf.write(samples.astype("<i4").tobytes())
    buf.write(codec.words_to_ref_bytes(words, fmi.length).tobytes())
    Path(path).write_bytes(buf.getvalue())


def read_ref_index(path, device=None) -> FMIndex:
    """Load a fileio.c-format index (rank checkpoints rebuilt).  A short
    file raises ``ValueError``, where the reference returns NULL
    ("Could not read index", fileio.c:57-60)."""
    raw = Path(path).read_bytes()
    off = 0

    def take(n_int32, what):
        nonlocal off
        if off + 4 * n_int32 > len(raw):
            raise ValueError(
                f"Could not read index {path}: truncated file "
                f"({len(raw)} bytes, need {off + 4 * n_int32} through "
                f"{what}; fileio.c:57-60 returns NULL here)")
        arr = np.frombuffer(raw, dtype="<i4", count=n_int32, offset=off)
        off += 4 * n_int32
        return arr

    length = int(take(1, "length")[0])
    if length < 0:
        raise ValueError(
            f"Could not read index {path}: negative length {length}")
    take(5, "C")  # rebuilt from the BWT
    endloc = int(take(1, "endloc")[0])
    sa_samples = take(1 + length // 32, "SA samples").copy()
    nbytes = (length + 3) // 4
    if off + nbytes > len(raw):
        raise ValueError(
            f"Could not read index {path}: truncated file "
            f"({len(raw)} bytes, need {off + nbytes} through the packed "
            f"BWT; fileio.c:57-60 returns NULL here)")
    packed = np.frombuffer(raw, dtype=np.uint8, count=nbytes, offset=off)
    return index_from_parts(
        bwt_codes=codec.unpack_ref_bytes(packed, length),
        sa_samples=sa_samples, endloc=endloc, length=length, device=device)


def write_npz_index(fmi: FMIndex, path) -> None:
    fmi.require_whole("write_npz_index")
    d = fmi.to_numpy()
    np.savez_compressed(
        path,
        version=np.int32(2),
        length=np.int64(d.pop("length")),
        sa_rate=np.int32(d.pop("sa_rate")),
        **d,
    )


def read_npz_index(path, device=None) -> FMIndex:
    with np.load(path) as z:
        return from_numpy({k: z[k] for k in z.files}, device=device)
