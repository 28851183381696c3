"""Original F-LOAM feature selection — independent comparison twin.

The port's own copy of ``warpsense_tpu/frontends/featsense/
floam_original.py``, loop for loop: the ORIGINAL F-LOAM extraction the
reference vendors for its feature_compare_node (``namespace original`` in
test/floam.h:150-245 + featureExtractionFromSector :30-148).  This is
deliberately NOT the featsense algorithm: it is the independent second
implementation eval/feature_compare.py compares against, so a shared
misreading of the featsense spec cannot hide.

Faithfully reproduced quirks (do not "fix"):
* the N_SCANS==128 ring binning is ``int((angle + 22.5) / 2 + 0.5)`` —
  the original's 2-degree ring spacing, which collapses a 45-deg vFOV
  into ~23 populated scan lines (floam.h:172-178);
* scan lines with < 131 points are skipped entirely (floam.h:188-191);
* per sector: sort by curvature, take up to 20 largest with value > 0.1
  as edges, suppress +-5 neighbors with the 0.05-squared-gap early break,
  and EVERY unpicked point of the sector becomes a surf point
  (floam.h:141-147).
"""
from __future__ import annotations

import numpy as np


def floam_original_features(points: np.ndarray, *, n_scans: int = 128,
                            min_distance: float = 2.0,
                            max_distance: float = 60.0
                            ) -> tuple[np.ndarray, np.ndarray]:
    """points: (N, 3) float (meters, sensor frame; zero rows invalid).

    Returns (edge_idx, surf_idx): GLOBAL indices into ``points``.
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    valid = np.any(pts != 0.0, axis=1) & np.all(np.isfinite(pts), axis=1)

    # ring binning (floam.h:163-183)
    dist = np.hypot(pts[:, 0], pts[:, 1])
    ok = valid & (dist >= min_distance) & (dist <= max_distance)
    with np.errstate(divide="ignore", invalid="ignore"):
        angle = np.degrees(np.arctan(pts[:, 2] / np.maximum(dist, 1e-12)))
    scan_id = ((angle + 22.5) / 2 + 0.5).astype(np.int64)
    ok &= (scan_id >= 0) & (scan_id < n_scans)

    edges: list[int] = []
    surfs: list[int] = []
    for s in range(n_scans):
        line = np.nonzero(ok & (scan_id == s))[0]      # original order
        if len(line) < 131:
            continue
        p = pts[line]
        n = len(line)
        # 11-point curvature, ids j in [5, n-5) (floam.h:195-218)
        total_points = n - 10
        ids = np.arange(5, n - 5)
        window = np.zeros((total_points, 3))
        for k in range(-5, 6):
            window += (p[ids + k] if k else -10.0 * p[ids])
        curv = np.sum(window * window, axis=1)

        # 6 sectors over the curvature list (floam.h:220-233); note the
        # original slices [start, end) with end = start+len-1 — the last
        # element of every non-final sector is DROPPED (kept verbatim)
        sector_length = total_points // 6
        for j in range(6):
            start = sector_length * j
            end = (total_points - 1 if j == 5
                   else sector_length * (j + 1) - 1)
            sub_ids = ids[start:end]
            sub_curv = curv[start:end]
            e, f = _extract_from_sector(p, sub_ids, sub_curv)
            edges.extend(line[e])
            surfs.extend(line[f])
    return np.asarray(edges, np.int64), np.asarray(surfs, np.int64)


def _extract_from_sector(p: np.ndarray, ids: np.ndarray,
                         curv: np.ndarray) -> tuple[list, list]:
    """featureExtractionFromSector (floam.h:30-148) on one sector.

    ``ids`` are indices into the scan line ``p``; returns (edge_ids,
    surf_ids) as scan-line indices."""
    order = np.argsort(curv, kind="stable")            # ascending
    picked: set[int] = set()
    edge_ids: list[int] = []
    largest = 0
    for i in order[::-1]:                              # largest first
        ind = int(ids[i])
        if ind in picked:
            continue
        if curv[i] <= 0.1:
            break
        largest += 1
        picked.add(ind)
        if largest <= 20:
            edge_ids.append(ind)
        else:
            break
        for k in range(1, 6):                          # +-5 suppression
            d = p[ind + k] - p[ind + k - 1]
            if np.dot(d, d) > 0.05:
                break
            picked.add(ind + k)
        for k in range(-1, -6, -1):
            d = p[ind + k] - p[ind + k + 1]
            if np.dot(d, d) > 0.05:
                break
            picked.add(ind + k)
    surf_ids = [int(ids[i]) for i in order if int(ids[i]) not in picked]
    return edge_ids, surf_ids
