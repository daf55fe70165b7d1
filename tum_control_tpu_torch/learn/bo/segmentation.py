"""Track segmentation by curvature hysteresis (host-side precomputation);
the port's own copy of tum_control_tpu/learn/bo/segmentation.py, in numpy
as there.

As BO_WMPC/track_segmentation.py:8-83: curvature = |diff(unwrapped
yaw)| / v, hysteresis-thresholded (lo 2e-5, hi 1e-3) into high-(type 0) and
low-(type 1) curvature segment groups with +-overlap points; segments
shorter than 20 points are discarded. Segments become (track, start, end)
index tuples consumed by the batched objective evaluator.
"""
from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from tum_control_tpu_torch.config import DEFAULT_TRAJECTORY_PATH


def hysteresis(x, th_lo, th_hi, initial=False):
    """Schmitt-trigger thresholding of a 1-D signal: the output switches
    True at x >= th_hi, switches False at x <= th_lo, and holds its previous
    value inside the dead band (th_lo, th_hi). Matches the semantics of the
    reference's helpers.hysteresis (helpers.py:41-50); vectorized here by
    tracking, per position, the index of the most recent decisive sample
    with a running maximum."""
    x = np.asarray(x)
    set_hi = x >= th_hi
    decisive = set_hi | (x <= th_lo)
    # index of the latest decisive sample at or before each position (-1: none)
    last = np.maximum.accumulate(np.where(decisive, np.arange(x.size), -1))
    return np.where(last >= 0, set_hi[np.maximum(last, 0)], bool(initial))


def curvature_segmentation(
    traj_name: str, raw: dict, th_lo: float, th_hi: float, overlap: int
) -> Tuple[List[dict], List[dict]]:
    vel = np.asarray(raw["ref_v"])
    yaw = np.unwrap(np.asarray(raw["ref_yaw"]))
    curvature = np.abs(np.diff(yaw)) / vel[:-1]
    indicator = hysteresis(curvature, th_lo=th_lo, th_hi=th_hi)
    indices = np.where(indicator[:-1] != indicator[1:])[0]
    indices = np.resize(indices, len(indices) + 1)

    groups: Tuple[List[dict], List[dict]] = ([], [])
    M = len(vel)
    for i in range(len(indices) - 1):
        start, end = int(indices[i]) - overlap, int(indices[i + 1]) + overlap
        if abs(end - start) < 20:
            continue
        seg_type = 0 if curvature[indices[i] + 1] > th_lo else 1
        groups[seg_type].append(
            {
                "start": start % M,
                "end": end % M,
                "type": seg_type,
                "trajectory": traj_name,
                "n_points": (end - start) % M,
            }
        )
    return groups


def get_train_segments(
    tracks=("modena", "monteblanco"),
    th_lo: float = 2e-5,
    th_hi: float = 1e-3,
    overlap: int = 10,
    trajectory_path: str = DEFAULT_TRAJECTORY_PATH,
) -> List[List[dict]]:
    """[high_curvature_segments, low_curvature_segments] over the tracks."""
    segments: List[List[dict]] = [[], []]
    for name in tracks:
        with open(os.path.join(trajectory_path, f"reftraj_{name}_edgar.json")) as fh:
            raw = json.load(fh)
        for gid, group in enumerate(curvature_segmentation(name, raw, th_lo, th_hi, overlap)):
            segments[gid].extend(group)
    return segments
