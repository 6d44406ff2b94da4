"""Inputs of G4, the device build's fusion walk, that reach its edge
lookup's hard cases: duplicate (tail, head) pairs and appends at the E - 1
clamp. The card tests (tests/test_torch_cuda.py) and the CPU warp model
(tests/test_torch_graph_build.py) both use them. Each takes the walk's
arguments as numpy arrays in `fuse_walk`'s order and returns a new list;
the arrays it changes are copies. And windows of G6, the heaviest bundle,
whose branch completion runs to its pass cap (`chain_bundle_windows`),
for the card tests and G6's warp model (tests/test_torch_graph_consensus.py)."""

import numpy as np


def _stream(args, b, rows):
    """Window b's pairs become `rows` [(node | -1, code)], at positions 0, 1,
    ... in order (so no unaligned run), the sequence's codes those given."""
    pairs, count, seq, seq_len = args[8], args[9], args[10], args[12]
    L = pairs.shape[1]
    n = len(rows)
    pairs[b] = -2
    pairs[b, L - n :] = [(node, p) for p, (node, _) in enumerate(rows)]
    seq[b, :n] = [c for _, c in rows]
    count[b], seq_len[b] = n, n


def _copies(args, keys):
    out = list(args)
    for k in keys:
        out[k] = np.array(out[k])
    return out


def with_duplicate_edges(args, k=12):
    """Every window whose chain edges (i, i + 1), i in [2, 2 + k), are all in
    its table and that has room for k more edges gets a second copy of each
    appended (n_edges grows by k), and a pair stream that walks that chain
    matching every node, so that each of its edges is looked up while two
    slots hold it: the lower one takes the weight (and the label bits).
    Returns (args, the windows changed)."""
    out = _copies(args, (1, 2, 3, 5, 8, 9, 10, 12) + ((14, 15) if len(args) > 14 else ()))
    codes, tails, heads, weights, n_nodes, n_edges = out[:6]
    E = tails.shape[1]
    changed = []
    for b in range(len(n_edges)):
        ne = int(n_edges[b])
        if ne + k > E - 1 or int(n_nodes[b]) < 2 + k + 1:
            continue
        slots = []
        for i in range(2, 2 + k):
            hit = np.nonzero((tails[b, :ne] == i) & (heads[b, :ne] == i + 1))[0]
            if not len(hit):
                break
            slots.append(int(hit[0]))
        if len(slots) < k:
            continue
        dst = np.arange(ne, ne + k)
        tails[b, dst], heads[b, dst] = tails[b, slots], heads[b, slots]
        weights[b, dst] = weights[b, slots]
        if len(out) > 14:
            for lab in out[14:16]:
                lab[b, dst] = lab[b, slots]
        n_edges[b] = ne + k
        _stream(out, b, [(i, int(codes[b, i])) for i in range(2, 2 + k + 1)])
        changed.append(b)
    return out, changed


def at_the_edge_cap(args, windows=(0, 1, 2, 3)):
    """Every window starts with n_edges = E - 2 (its slots past its own edges
    become valid edges as they are). In `windows` a pair stream then appends
    (x -> a) at E - 2, the last listed slot, and (a -> b) at E - 1, for an
    existing node x and two new nodes a and b; then it appends past the cap
    (each such append overwrites E - 1 and flags the window), looks up the
    overwritten (a -> b) again, looks up (b -> b) just after it was
    appended at E - 1 (found there), and last (x -> a) (found at E - 2).
    The other windows keep their random streams, which append past the cap
    too."""
    out = _copies(args, (5, 8, 9, 10, 12))
    codes, tails, n_nodes, n_edges = out[0], out[1], out[4], out[5]
    E = tails.shape[1]
    n_edges[:] = E - 2
    for b in windows:
        nn = int(n_nodes[b])
        if nn + 2 > codes.shape[1]:
            continue
        x = 1
        a, bb = nn, nn + 1
        cx, ca, cb = int(codes[b, x]), (int(codes[b, x]) + 1) % 4, (int(codes[b, x]) + 2) % 4
        _stream(out, b, [(x, cx), (-1, ca), (-1, cb), (a, ca), (bb, cb), (bb, cb), (bb, cb),
                         (x, cx), (a, ca)])
    return out


def chain_bundle_windows(B, N, seed, P=16):
    """`heaviest_bundle`'s arguments (numpy, int32) for B windows of one
    chain each (40 to N nodes, rank = id), whose edge weights fall to 0
    past a node near the start: the first strict maximum is that node, and
    each branch-completion pass moves it one node on, so that a chain of
    more than about 70 nodes stops at the 64-pass cap. One window in four
    also has ties of weight and score: a second in-edge into every node,
    from two nodes back, of the same weight as the first."""
    rng = np.random.default_rng(seed)
    in_nbr = np.zeros((B, N, P), np.int32)
    in_w = np.zeros((B, N, P), np.int32)
    indeg = np.zeros((B, N), np.int32)
    out_nbr = np.zeros((B, N, P), np.int32)
    out_deg = np.zeros((B, N), np.int32)
    n_nodes = rng.integers(min(40, N), N + 1, size=B).astype(np.int32)
    for b in range(B):
        n, flat = int(n_nodes[b]), int(rng.integers(1, 5))
        for v in range(1, n):
            in_nbr[b, v, 0], in_w[b, v, 0], indeg[b, v] = v - 1, (3 if v <= flat else 0), 1
            out_nbr[b, v - 1, 0], out_deg[b, v - 1] = v, 1
            if b % 4 == 0 and v >= 2:
                in_nbr[b, v, 1], in_w[b, v, 1], indeg[b, v] = v - 2, in_w[b, v, 0], 2
                out_nbr[b, v - 2, out_deg[b, v - 2]] = v
                out_deg[b, v - 2] += 1
    ids = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy()
    return [in_nbr, in_w, indeg, out_nbr, out_deg, ids, ids.copy(), n_nodes]
