"""Communication-minimal tiling (paper §IV-C.2; counterpart of
``repro/sched/tiling.py``).

Given bank coordinates on the NoC mesh and each bank's head type
(retrieval / streaming), partition banks into t = min(n_r, n_s) tiles with
|T_i| <= ceil((n_r+n_s)/t), mixing both types, minimizing the maximum
Manhattan distance between retrieval and streaming banks within a tile.

Solved exactly as the paper does — as a flow problem: binary-search the
distance bound D; feasibility is a bipartite b-matching (anchors = banks
of the minority type, capacity tile_size-1) checked with BFS max-flow
(Edmonds–Karp). Grids are tiny (<=16x16), so this is instant.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

Coord = Tuple[int, int]


@dataclass(frozen=True)
class Tile:
    anchor: Coord               # minority-type bank
    members: tuple              # all bank coords in the tile (incl anchor)
    max_dist: int


def manhattan(a: Coord, b: Coord) -> int:
    return abs(a[0] - b[0]) + abs(a[1] - b[1])


def _max_flow(adj: List[List[int]], n: int, src: int, dst: int,
              cap: Dict[Tuple[int, int], int]) -> Dict[Tuple[int, int], int]:
    """Edmonds–Karp; returns flow dict."""
    flow: Dict[Tuple[int, int], int] = {}

    def residual(u, v):
        return cap.get((u, v), 0) - flow.get((u, v), 0) + flow.get((v, u), 0)

    while True:
        parent = {src: None}
        q = deque([src])
        while q and dst not in parent:
            u = q.popleft()
            for v in adj[u]:
                if v not in parent and residual(u, v) > 0:
                    parent[v] = u
                    q.append(v)
        if dst not in parent:
            return flow
        # bottleneck
        path = []
        v = dst
        while parent[v] is not None:
            path.append((parent[v], v))
            v = parent[v]
        aug = min(residual(u, w) for u, w in path)
        for u, w in path:
            back = flow.get((w, u), 0)
            if back >= aug:
                flow[(w, u)] = back - aug
            else:
                flow[(w, u)] = 0
                flow[(u, w)] = flow.get((u, w), 0) + aug - back


def _feasible(anchors: Sequence[Coord], others: Sequence[Coord],
              d_bound: int, cap_per_tile: int):
    """b-matching: every non-anchor bank assigned to an anchor within
    d_bound, anchors take <= cap_per_tile-1. Returns assignment or None."""
    na, no = len(anchors), len(others)
    src, dst = 0, 1 + na + no
    adj: List[List[int]] = [[] for _ in range(na + no + 2)]
    cap: Dict[Tuple[int, int], int] = {}
    for i, a in enumerate(anchors):
        u = 1 + i
        adj[src].append(u)
        adj[u].append(src)
        cap[(src, u)] = cap_per_tile - 1
        for j, o in enumerate(others):
            if manhattan(a, o) <= d_bound:
                v = 1 + na + j
                adj[u].append(v)
                adj[v].append(u)
                cap[(u, v)] = 1
    for j in range(no):
        v = 1 + na + j
        adj[v].append(dst)
        adj[dst].append(v)
        cap[(v, dst)] = 1
    flow = _max_flow(adj, na + no + 2, src, dst, cap)
    total = sum(flow.get((1 + na + j, dst), 0) for j in range(no))
    if total < no:
        return None
    assign: Dict[int, List[int]] = {i: [] for i in range(na)}
    for i in range(na):
        for j in range(no):
            if flow.get((1 + i, 1 + na + j), 0) > 0:
                assign[i].append(j)
    return assign


def solve_tiling(retrieval: Sequence[Coord], streaming: Sequence[Coord]):
    """Partition banks into tiles. Returns (tiles, max_dist)."""
    n_r, n_s = len(retrieval), len(streaming)
    if n_r == 0 or n_s == 0:  # degenerate: single-type — one tile per bank
        banks = list(retrieval) + list(streaming)
        return [Tile(anchor=b, members=(b,), max_dist=0) for b in banks], 0
    t = min(n_r, n_s)
    cap = -(-(n_r + n_s) // t)
    anchors, others = ((retrieval, streaming) if n_r <= n_s
                       else (streaming, retrieval))
    # binary search minimal feasible D
    dists = sorted({manhattan(a, o) for a in anchors for o in others})
    lo, hi = 0, len(dists) - 1
    best = None
    best_d = dists[-1]
    while lo <= hi:
        mid = (lo + hi) // 2
        res = _feasible(anchors, others, dists[mid], cap)
        if res is not None:
            best, best_d = res, dists[mid]
            hi = mid - 1
        else:
            lo = mid + 1
    assert best is not None, "cap >= 2 should always be feasible at max D"
    tiles = []
    for i, a in enumerate(anchors):
        members = (a,) + tuple(others[j] for j in best[i])
        md = max((manhattan(a, m) for m in members[1:]), default=0)
        tiles.append(Tile(anchor=a, members=members, max_dist=md))
    return tiles, best_d


def grid_coords(rows: int, cols: int) -> List[Coord]:
    return [(r, c) for r in range(rows) for c in range(cols)]


def head_permutation(alpha_layer, static_sparsity: float):
    """Per-layer kv-head order: retrieval heads (desc α) first.

    The single-layer form of the reference's head classification (its
    ``core.gating.classify_heads``).
    """
    import numpy as np

    a = np.asarray(alpha_layer)
    return np.argsort(-a, kind="stable").astype("int32")
