"""2-bit nucleotide codec: ASCII <-> codes <-> packed layouts (host, numpy).

The reference stores genomes 2-bit packed, 4 bases per byte, big-endian
within the byte: base ``i`` lives in byte ``i >> 2`` at bit offset
``2*(3 - (i & 3))`` (seqindex.c:18-21).  That layout is kept only for
serialization.  The working layout packs 16 bases per 32-bit word in
little-endian 2-bit lanes (base ``j`` of a word at bits ``2*j``).

Code values:
  genome: A=0, C=1, G=2, T=3; any other character -> 0 ('A')
          (build_index.c:54-88).
  reads:  A=0, C=1, G=2, T=3; any other character -> 5 ('N')
          (single_align.c:450-474).  Code 5 matches anything in the DP.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 5

BASES_PER_WORD = 16  # 2-bit lanes in a 32-bit word
NT_CHARS = "ACGT"

_GENOME_LUT = np.zeros(256, dtype=np.uint8)  # default: 0 ('A')
_READ_LUT = np.full(256, N, dtype=np.uint8)  # default: 5 ('N')
for _i, _ch in enumerate(NT_CHARS):
    _GENOME_LUT[ord(_ch)] = _i
    _READ_LUT[ord(_ch)] = _i

# Complement: A<->T, C<->G; N (5) stays N.
_COMPLEMENT = np.arange(256, dtype=np.uint8)
_COMPLEMENT[:4] = [3, 2, 1, 0]
_COMPLEMENT[N] = N


def _as_bytes(s) -> bytes:
    if isinstance(s, str):
        return s.encode("ascii")
    return bytes(s)


def encode_genome(s) -> np.ndarray:
    """ASCII genome text -> uint8 codes 0-3 (non-ACGT -> A=0)."""
    return _GENOME_LUT[np.frombuffer(_as_bytes(s), dtype=np.uint8)]


def encode_read(s) -> np.ndarray:
    """ASCII read -> uint8 codes 0-3 / 5 (non-ACGT -> N=5)."""
    return _READ_LUT[np.frombuffer(_as_bytes(s), dtype=np.uint8)]


def decode(codes) -> str:
    """Codes -> ASCII (5 -> 'N')."""
    lut = np.frombuffer(b"ACGT.N", dtype=np.uint8)
    return lut[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp(codes) -> np.ndarray:
    """Reverse complement of a code array; N (5) maps to N."""
    return _COMPLEMENT[np.asarray(codes, dtype=np.uint8)][::-1]


def pack_ref_bytes(codes) -> np.ndarray:
    """Codes 0-3 -> packed bytes in the reference layout (zero-filled
    tail lanes, seqindex.c:18-21)."""
    codes = np.asarray(codes, dtype=np.uint8)
    nbytes = (len(codes) + 3) // 4
    padded = np.zeros(nbytes * 4, dtype=np.uint8)
    padded[: len(codes)] = codes
    lanes = padded.reshape(nbytes, 4)
    return ((lanes[:, 0] << 6) | (lanes[:, 1] << 4) | (lanes[:, 2] << 2)
            | lanes[:, 3]).astype(np.uint8)


def unpack_ref_bytes(packed, length: int) -> np.ndarray:
    """Packed reference-layout bytes -> codes 0-3 of ``length``."""
    packed = np.asarray(packed, dtype=np.uint8)
    lanes = np.stack([(packed >> s) & 3 for s in (6, 4, 2, 0)], axis=1)
    return lanes.reshape(-1)[:length].astype(np.uint8)


def pack_words(codes) -> np.ndarray:
    """Codes 0-3 -> uint32 words, 16 little-endian 2-bit lanes per word
    (base ``i`` in word ``i >> 4`` at bits ``2*(i & 15)``)."""
    codes = np.asarray(codes, dtype=np.uint32)
    nwords = (len(codes) + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.zeros(nwords * BASES_PER_WORD, dtype=np.uint32)
    padded[: len(codes)] = codes
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(
        padded.reshape(nwords, BASES_PER_WORD) << shifts, axis=1
    ).astype(np.uint32)


def unpack_words(words, length: int) -> np.ndarray:
    """uint32 word layout -> codes 0-3 of ``length``."""
    words = np.asarray(words).astype(np.uint32)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    return ((words[:, None] >> shifts) & 3).reshape(-1)[:length].astype(
        np.uint8)


def words_to_ref_bytes(words, length: int) -> np.ndarray:
    return pack_ref_bytes(unpack_words(words, length))


def random_genome(n: int, seed: int = 0) -> str:
    """gen_seq.c equivalent: uniform ACGT text of length ``n``."""
    rng = np.random.default_rng(seed)
    return "".join(np.array(list(NT_CHARS))[rng.integers(0, 4, size=n)])
