"""Base/quality encoding utilities shared by host and device code.

The reference builds a per-graph dynamic character coder
(vendor/spoa/src/graph.cpp:198-205). Codes only feed equality tests and the
decoder, so a fixed alphabet is semantically equivalent; we use a fixed
16-entry alphabet with ACGTN in the low codes, which keeps device tensors
uint8 and avoids any host round-trip to assign codes.
"""

from __future__ import annotations

import numpy as np

# Fixed alphabet. Order matters only for determinism of our own tensors.
ALPHABET = "ACGTNRYSWKMBDHV-"
CODE_OF = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(ALPHABET):
    CODE_OF[ord(_c)] = _i
DECODE = np.frombuffer(ALPHABET.encode(), dtype=np.uint8)

GAP_CODE = ALPHABET.index("-")

_RC_CODE = np.arange(16, dtype=np.uint8)
_RC_CODE[0:4] = [3, 2, 1, 0]  # A<->T, C<->G; others map to themselves


def encode(seq: str) -> np.ndarray:
    """Uppercase DNA string -> uint8 code array."""
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    codes = CODE_OF[raw]
    if (codes == 255).any():
        bad = chr(raw[int(np.argmax(codes == 255))])
        raise ValueError(f"cannot encode base {bad!r}")
    return codes


def decode(codes: np.ndarray) -> str:
    return DECODE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _RC_CODE[codes[::-1]]


def phred_weights(quality: str | None, length: int) -> np.ndarray:
    """Per-base POA weights.

    FASTQ: w = uint32((1 - 10**((33 - q)/10)) * 1000)   (truncating cast,
    reference: vendor/spoa/src/graph.cpp:165-172, src/window.cpp:366).
    FASTA (no quality): w = 1 (reference: graph.hpp:145 default weight).
    """
    if quality is None:
        return np.ones(length, dtype=np.uint32)
    q = np.frombuffer(quality.encode(), dtype=np.uint8).astype(np.float64)
    w = (1.0 - np.power(10.0, (33.0 - q) / 10.0)) * 1000.0
    return w.astype(np.uint32)


def phred_prob_sum(quality: str) -> float:
    """Sum over bases of (1 - p_err), in float64
    (reference: src/window.cpp:232-237,292-297)."""
    q = np.frombuffer(quality.encode(), dtype=np.uint8).astype(np.float64)
    return float(np.sum(1.0 - np.power(10.0, (33.0 - q) / 10.0)))
