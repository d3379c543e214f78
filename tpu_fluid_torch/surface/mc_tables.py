"""Marching-cubes lookup tables, generated from first principles
(`tpu_fluid.surface.mc_tables`, copied: NumPy only).

The reference ships its 256-entry triangle-count and edge-index tables as
data files (`surface_render_data/polygon_counts.txt`,
`polygon_edge_indices.txt`, loaded by `marching_cubes.h:29-32`) and walks
them in a geometry shader (`31_render_surface/render_surface.geom:84-102`).
This module *derives* equivalent tables instead of shipping opaque data:

For each of the 256 corner-sign configurations:
 1. find the cube edges whose endpoints straddle the isosurface;
 2. on every face, connect crossing edges pairwise with the fixed rule
    "join crossings around positive corners" (each boundary arc between a
    connected pair contains only positive corners).  The rule depends only on
    the face's 4 corner signs, so adjacent cells sharing a face always agree
    — the generated surface is watertight by construction, including on the
    two 4-crossing ambiguous face cases;
 3. chain the face segments into closed loops (every crossing edge lies on
    exactly 2 faces, so the graph is 2-regular);
 4. fan-triangulate each loop, oriented so triangle normals point from the
    positive (inside) region to the negative (outside) region.

Corner/edge numbering matches the classic marching-cubes convention, which is
also what the reference's geometry shader hardcodes
(`render_surface.geom:45-52`).

tests/test_mc_tables.py checks watertightness and orientation on random
smooth fields.
"""

from __future__ import annotations

import numpy as np

# Corner offsets (classic MC numbering: bottom face CCW, then top face).
CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
], dtype=np.int32)

# Edge -> (corner a, corner b), classic numbering.
EDGES = np.array([
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
], dtype=np.int32)

# Faces as cyclic corner loops (viewed from outside the cube).
_FACES = [
    (0, 1, 2, 3),   # z = 0
    (4, 7, 6, 5),   # z = 1
    (0, 4, 5, 1),   # y = 0
    (3, 2, 6, 7),   # y = 1
    (0, 3, 7, 4),   # x = 0
    (1, 5, 6, 2),   # x = 1
]

_EDGE_OF_PAIR = {}
for _e, (_a, _b) in enumerate(EDGES):
    _EDGE_OF_PAIR[(int(_a), int(_b))] = _e
    _EDGE_OF_PAIR[(int(_b), int(_a))] = _e


def _face_segments(face, inside):
    """Segments (pairs of crossing edge ids) on one face for a given corner
    sign assignment, connecting crossings around positive corners."""
    # Walk the cyclic boundary: corner c0, edge(c0,c1), corner c1, ...
    n = len(face)
    crossings = []   # (position in walk, edge id); position = index of the
    # boundary edge in the cyclic corner order
    for k in range(n):
        a, b = face[k], face[(k + 1) % n]
        if inside[a] != inside[b]:
            crossings.append((k, _EDGE_OF_PAIR[(a, b)]))
    if not crossings:
        return []
    segs = []
    m = len(crossings)
    for idx in range(m):
        k0, e0 = crossings[idx]
        k1, e1 = crossings[(idx + 1) % m]
        # the boundary arc from edge k0 to edge k1 (exclusive) passes corners
        # face[k0+1 .. k1]; connect iff all of them are positive (inside)
        corners_between = []
        k = (k0 + 1) % n
        while True:
            corners_between.append(face[k])
            if k == k1:
                break
            k = (k + 1) % n
        if all(inside[c] for c in corners_between):
            segs.append((e0, e1))
    return segs


def _loops_for_config(config):
    inside = [(config >> c) & 1 == 1 for c in range(8)]
    adj = {}
    for face in _FACES:
        for e0, e1 in _face_segments(face, inside):
            adj.setdefault(e0, []).append(e1)
            adj.setdefault(e1, []).append(e0)
    for e, nbrs in adj.items():
        assert len(nbrs) == 2, (config, e, adj)
    loops = []
    visited = set()
    for start in sorted(adj):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            nxt = [x for x in adj[cur] if x != prev]
            nxt = nxt[0] if nxt else adj[cur][0]
            if nxt == start:
                break
            loop.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return inside, loops


def _orient_loop(loop, inside):
    """Orient so fan-triangle normals point from positive toward negative.

    Uses representative geometry with all densities +/-1 (every crossing at
    its edge midpoint) and the mean inside->outside direction."""
    mids = []
    for e in loop:
        a, b = EDGES[e]
        mids.append((CORNERS[a] + CORNERS[b]) / 2.0)
    mids = np.array(mids, dtype=np.float64)
    pos = CORNERS[[c for c in range(8) if inside[c]]].mean(axis=0)
    neg = CORNERS[[c for c in range(8) if not inside[c]]].mean(axis=0)
    out_dir = neg - pos
    # average fan normal
    total = np.zeros(3)
    for i in range(1, len(loop) - 1):
        n = np.cross(mids[i] - mids[0], mids[i + 1] - mids[0])
        total += n
    if np.dot(total, out_dir) < 0:
        return loop[::-1]
    return loop


def generate_tables():
    """Returns (counts[256] int32, edge_indices[256, 3*MAX_TRIS] int32 with
    255 padding, MAX_TRIS)."""
    all_tris = []
    max_tris = 0
    for config in range(256):
        inside, loops = _loops_for_config(config)
        tris = []
        for loop in loops:
            loop = _orient_loop(loop, inside)
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))
        all_tris.append(tris)
        max_tris = max(max_tris, len(tris))

    counts = np.array([len(t) for t in all_tris], dtype=np.int32)
    edges = np.full((256, 3 * max_tris), 255, dtype=np.int32)
    for config, tris in enumerate(all_tris):
        flat = [e for tri in tris for e in tri]
        edges[config, :len(flat)] = flat
    return counts, edges, max_tris


TRI_COUNTS, TRI_EDGES, MAX_TRIS = generate_tables()
