"""Pairwise global edit-distance alignment with CIGAR output.

Plays the role edlib plays in the reference (src/overlap.cpp:205-224): given
the query and target segments of an overlap, produce a standard CIGAR
(M = match/mismatch, I = consumes query, D = consumes target) for an
edit-distance-optimal global (NW) alignment.

Host oracle implementation: numpy row DP with packed traceback for short
segments, Hirschberg divide-and-conquer (rows-only memory) for long ones.
The device path (ops/kernels/pairwise_nw.py) is verified against this.

Tie-break: on equal cost the traceback prefers diagonal, then deletion (D),
then insertion (I). Edit-distance-optimality matches edlib; the exact path on
ties may differ from edlib's internal order, which can shift indel placement
within an optimal alignment.
"""

from __future__ import annotations

import numpy as np

FULL_DP_MAX_CELLS = 4_000_000  # above this, switch to Hirschberg (numpy path)
NATIVE_DP_MAX_CELLS = 64_000_000  # native C++ full DP handles up to ~8kb x 8kb
FULL_DP_MIN_ROWS = 256  # always use full DP below this many query rows


def _native_ready() -> bool:
    try:
        from .native_graph import get_lib

        return get_lib() is not None
    except ImportError:
        return False


def edit_distance_row(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Final DP row of NW edit distance: dist(q, t[:j]) for all j.
    Vectorised over t; loops over q."""
    W = len(t) + 1
    row = np.arange(W, dtype=np.int32)
    for i in range(1, len(q) + 1):
        sub = np.where(t == q[i - 1], 0, 1).astype(np.int32)
        diag = row[:-1] + sub
        up = row[1:] + 1
        new = np.minimum(diag, up)
        # left dependency: serial min -> prefix trick
        # new[j] = min(new[j], new[j-1]+1) == running min of (new[k]-k) + j
        full = np.empty(W, dtype=np.int32)
        full[0] = i
        full[1:] = new
        jg = np.arange(W, dtype=np.int32)
        row = np.minimum.accumulate(full - jg) + jg
        row[0] = i
    return row


def _native_pw_ops(q: np.ndarray, t: np.ndarray):
    """Native C++ full-DP path (identical tie-breaks); None if unavailable
    or too large."""
    if (len(q) + 1) * (len(t) + 1) > 256_000_000:
        return None
    try:
        from .native_graph import get_lib
    except ImportError:
        return None
    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    cap = len(q) + len(t) + 2
    buf = ctypes.create_string_buffer(cap)
    qa = np.ascontiguousarray(q, dtype=np.uint8)
    ta = np.ascontiguousarray(t, dtype=np.uint8)
    n = lib.pw_align(qa, len(qa), ta, len(ta), buf, cap)
    if n < 0:
        return None
    return list(buf.raw[:n].decode())


def _full_dp_cigar(q: np.ndarray, t: np.ndarray) -> list:
    """Full-matrix DP with direction bits; returns list of ops."""
    native = _native_pw_ops(q, t)
    if native is not None:
        return native
    lq, lt = len(q), len(t)
    H = np.zeros((lq + 1, lt + 1), dtype=np.int32)
    H[0, :] = np.arange(lt + 1)
    H[:, 0] = np.arange(lq + 1)
    for i in range(1, lq + 1):
        sub = np.where(t == q[i - 1], 0, 1).astype(np.int32)
        diag = H[i - 1, :-1] + sub
        up = H[i - 1, 1:] + 1
        new = np.minimum(diag, up)
        full = np.empty(lt + 1, dtype=np.int32)
        full[0] = i
        full[1:] = new
        jg = np.arange(lt + 1, dtype=np.int32)
        H[i, :] = np.minimum.accumulate(full - jg) + jg
        H[i, 0] = i

    ops = []
    i, j = lq, lt
    while i > 0 or j > 0:
        if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + (0 if q[i - 1] == t[j - 1] else 1):
            ops.append("M")
            i -= 1
            j -= 1
        elif j > 0 and H[i, j] == H[i, j - 1] + 1:
            ops.append("D")
            j -= 1
        else:
            ops.append("I")
            i -= 1
    ops.reverse()
    return ops


def _hirschberg_ops(q: np.ndarray, t: np.ndarray) -> list:
    """Divide-and-conquer alignment in O(len(t)) memory."""
    cells_cap = NATIVE_DP_MAX_CELLS if _native_ready() else FULL_DP_MAX_CELLS
    if (
        len(q) <= FULL_DP_MIN_ROWS
        or len(q) * len(t) <= cells_cap
        or len(t) == 0
    ):
        return _full_dp_cigar(q, t)
    mid = len(q) // 2
    left = edit_distance_row(q[:mid], t)
    right = edit_distance_row(q[mid:][::-1], t[::-1])[::-1]
    split = int(np.argmin(left + right))
    return _hirschberg_ops(q[:mid], t[:split]) + _hirschberg_ops(q[mid:], t[split:])


def ops_to_cigar(ops: list) -> str:
    out = []
    i = 0
    while i < len(ops):
        j = i
        while j < len(ops) and ops[j] == ops[i]:
            j += 1
        out.append(f"{j - i}{ops[i]}")
        i = j
    return "".join(out)


def _native_pw_cigar(q: np.ndarray, t: np.ndarray):
    """Native path that returns the RLE CIGAR string directly (pw_align_cigar),
    skipping the per-op Python list + RLE join; None if unavailable."""
    if (len(q) + 1) * (len(t) + 1) > 256_000_000:
        return None
    try:
        from .native_graph import get_lib
    except ImportError:
        return None
    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    cap = 3 * (len(q) + len(t) + 2) + 16
    buf = ctypes.create_string_buffer(cap)
    qa = np.ascontiguousarray(q, dtype=np.uint8)
    ta = np.ascontiguousarray(t, dtype=np.uint8)
    n = lib.pw_align_cigar(qa, len(qa), ta, len(ta), buf, cap)
    if n < 0:
        return None
    return buf.raw[:n].decode()


def edit_align(q: np.ndarray, t: np.ndarray) -> str:
    """Global NW edit-distance alignment; returns a standard CIGAR string.
    q consumes 'M'/'I'; t consumes 'M'/'D' (edlib EDLIB_CIGAR_STANDARD)."""
    q = np.asarray(q)
    t = np.asarray(t)
    if len(q) == 0:
        return f"{len(t)}D" if len(t) else ""
    if len(t) == 0:
        return f"{len(q)}I"
    native = _native_pw_cigar(q, t)
    if native is not None:
        return native
    return ops_to_cigar(_hirschberg_ops(q, t))


def edit_distance(q: np.ndarray, t: np.ndarray) -> int:
    return int(edit_distance_row(np.asarray(q), np.asarray(t))[-1])


def edit_distance_infix(q: np.ndarray, t: np.ndarray) -> int:
    """Infix ("HW") edit distance: q aligned somewhere inside t with free
    target ends. The right metric for corrected reads, which are coverage-
    TRIMMED relative to the raw read (racon kTGS trim semantics)."""
    q = np.asarray(q)
    t = np.asarray(t)
    if len(q) == 0:
        return 0
    W = len(t) + 1
    row = np.zeros(W, dtype=np.int32)  # free start in t
    for i in range(1, len(q) + 1):
        sub = np.where(t == q[i - 1], 0, 1).astype(np.int32)
        diag = row[:-1] + sub
        up = row[1:] + 1
        new = np.minimum(diag, up)
        full = np.empty(W, dtype=np.int32)
        full[0] = i
        full[1:] = new
        jg = np.arange(W, dtype=np.int32)
        row = np.minimum.accumulate(full - jg) + jg
        row[0] = i
    return int(row.min())  # free end in t


def cigar_identity(cigar: str, q: np.ndarray, t: np.ndarray) -> tuple:
    """(exact_matches, alignment_block_length) of a CIGAR over code arrays —
    the PAF $10/$11 columns minimap2 -c reports (identity = matches/block)."""
    import re

    qi = ti = matches = block = 0
    for num, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
        num = int(num)
        if op in "M=X":
            matches += int(np.sum(q[qi : qi + num] == t[ti : ti + num]))
            qi += num
            ti += num
            block += num
        elif op == "I":
            qi += num
            block += num
        elif op in "DN":
            ti += num
            block += num
    return matches, block


def cigar_spans(cigar: str) -> tuple:
    """(query_consumed, target_consumed) of a CIGAR string."""
    import re

    ql = tl = 0
    for num, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
        num = int(num)
        if op in "M=X":
            ql += num
            tl += num
        elif op == "I":
            ql += num
        elif op in "DN":
            tl += num
    return ql, tl
