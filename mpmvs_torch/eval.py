"""Accuracy evaluation: depth-map error metrics and point-cloud F1.

Port of ``mpmvs_tpu.eval`` (numpy and scipy, no JAX): the same functions
and CLI, reading files with the port's ``io`` modules. The original
implements the capability the reference *declares but never defines* —
``DmapEval`` / ``ColmapEval`` (reference: include/utility.h:56-57, no
definition anywhere in the tree; evaluation was done with external ETH3D
tooling). Two levels:

  * :func:`eval_depth_map` — per-view estimated-vs-GT depth statistics
    (ETH3D raw GT readable via io.dmb.read_eth3d_gt, COLMAP dmaps via
    read_colmap_dmap).
  * :func:`eval_point_cloud` — ETH3D-style accuracy / completeness / F1 of
    a fused cloud against a ground-truth cloud at distance threshold tau
    (default 2 cm, the BASELINE.md north-star metric).

Nearest-neighbor queries use a scipy cKDTree on the host: evaluation is an
offline, once-per-scene tool, not a hot path.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DepthMetrics:
    """Estimated-vs-GT depth map statistics over valid GT pixels."""

    n_gt: int              # valid GT pixels
    n_est: int             # valid estimated pixels among them
    completeness: float    # n_est / n_gt
    mae: float             # mean |d - gt| over jointly-valid pixels
    med_abs_err: float     # median |d - gt|
    abs_rel: float         # mean |d - gt| / gt
    frac_within: Dict[str, float]  # {threshold(label): fraction}

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def eval_depth_map(
    depth: np.ndarray,
    gt: np.ndarray,
    thresholds: Sequence[float] = (0.02, 0.1, 0.5),
    gt_min: float = 1e-6,
) -> DepthMetrics:
    """Compare an estimated depth map against ground truth.

    Invalid GT pixels (non-finite or <= gt_min) are excluded, matching
    ETH3D's convention of sparse GT coverage; invalid estimates count
    against completeness. ``thresholds`` are absolute depth-unit errors
    (ETH3D: meters — 0.02 is the 2 cm headline tolerance).
    """
    depth = np.asarray(depth, np.float64)
    gt = np.asarray(gt, np.float64)
    if depth.shape != gt.shape:
        raise ValueError(f"shape mismatch: est {depth.shape} vs gt {gt.shape}")
    gt_valid = np.isfinite(gt) & (gt > gt_min)
    est_valid = np.isfinite(depth) & (depth > 0)
    both = gt_valid & est_valid
    n_gt = int(gt_valid.sum())
    n_est = int(both.sum())
    if n_est == 0:
        return DepthMetrics(n_gt=n_gt, n_est=0, completeness=0.0,
                            mae=float("inf"), med_abs_err=float("inf"),
                            abs_rel=float("inf"),
                            frac_within={f"{t:g}": 0.0 for t in thresholds})
    err = np.abs(depth[both] - gt[both])
    rel = err / gt[both]
    # fractions are over all valid-GT pixels: a missing estimate is an error
    # (ETH3D scores completeness jointly, not just accuracy of what exists)
    frac = {f"{t:g}": float((err <= t).sum() / max(n_gt, 1))
            for t in thresholds}
    return DepthMetrics(
        n_gt=n_gt, n_est=n_est,
        completeness=float(n_est / max(n_gt, 1)),
        mae=float(err.mean()),
        med_abs_err=float(np.median(err)),
        abs_rel=float(rel.mean()),
        frac_within=frac,
    )


@dataclasses.dataclass
class CloudMetrics:
    """ETH3D-style point-cloud scores at one distance threshold."""

    tau: float
    n_pred: int
    n_gt: int
    accuracy: float      # fraction of predicted points within tau of GT
    completeness: float  # fraction of GT points within tau of prediction
    f1: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def eval_point_cloud(
    pred_points: np.ndarray,   # (N, 3)
    gt_points: np.ndarray,     # (M, 3)
    tau: float = 0.02,
    max_points: Optional[int] = 2_000_000,
    seed: int = 0,
) -> CloudMetrics:
    """Accuracy / completeness / F1 at distance threshold ``tau``.

    Large clouds are uniformly subsampled to ``max_points`` per side (the
    metrics are point fractions, so subsampling is unbiased).
    """
    from scipy.spatial import cKDTree

    pred = np.asarray(pred_points, np.float64).reshape(-1, 3)
    gt = np.asarray(gt_points, np.float64).reshape(-1, 3)
    pred = pred[np.isfinite(pred).all(axis=1)]
    gt = gt[np.isfinite(gt).all(axis=1)]
    rng = np.random.default_rng(seed)
    if max_points and len(pred) > max_points:
        pred = pred[rng.choice(len(pred), max_points, replace=False)]
    if max_points and len(gt) > max_points:
        gt = gt[rng.choice(len(gt), max_points, replace=False)]
    if len(pred) == 0 or len(gt) == 0:
        return CloudMetrics(tau=tau, n_pred=len(pred), n_gt=len(gt),
                            accuracy=0.0, completeness=0.0, f1=0.0)

    d_pred, _ = cKDTree(gt).query(pred, k=1, distance_upper_bound=tau * 8)
    d_gt, _ = cKDTree(pred).query(gt, k=1, distance_upper_bound=tau * 8)
    acc = float((d_pred <= tau).mean())
    comp = float((d_gt <= tau).mean())
    f1 = 0.0 if acc + comp == 0 else 2 * acc * comp / (acc + comp)
    return CloudMetrics(tau=tau, n_pred=len(pred), n_gt=len(gt),
                        accuracy=acc, completeness=comp, f1=f1)


def eval_scene_depths(
    result_dir: str,
    gt_dir: str,
    view_ids: Sequence[int],
    gt_format: str = "dmb",
    gt_shape: Optional[tuple] = None,
    thresholds: Sequence[float] = (0.02, 0.1, 0.5),
) -> Dict[str, dict]:
    """Evaluate every view's ``depths.dmb`` under ``result_dir`` (the
    pipeline's ``MPMVS/2333_%08d`` layout, reference PatchMatch.cpp:620-633)
    against GT files named ``%08d.<ext>`` in ``gt_dir``.

    gt_format: 'dmb' | 'eth3d' (raw float32, needs gt_shape) | 'colmap'.
    Returns {view_id: metrics dict} plus a 'mean' aggregate.
    """
    import os

    from mpmvs_torch.io.dmb import read_colmap_dmap, read_dmb, read_eth3d_gt

    per_view = {}
    for vid in view_ids:
        est_path = os.path.join(result_dir, f"2333_{vid:08d}", "depths.dmb")
        if not os.path.exists(est_path):
            continue
        est = read_dmb(est_path)
        if gt_format == "dmb":
            gt = read_dmb(os.path.join(gt_dir, f"{vid:08d}.dmb"))
        elif gt_format == "eth3d":
            h, w = gt_shape if gt_shape else (4032, 6048)
            gt = read_eth3d_gt(os.path.join(gt_dir, f"{vid:08d}.raw"), h, w)
        elif gt_format == "colmap":
            gt = read_colmap_dmap(os.path.join(gt_dir, f"{vid:08d}.dmap"))
        else:
            raise ValueError(f"unknown gt_format {gt_format!r}")
        if gt.shape != est.shape:
            # GT at capture resolution, estimate at max_image_size — compare
            # at the estimate's resolution via nearest sampling (depth is not
            # interpolatable across discontinuities).
            ys = (np.arange(est.shape[0]) * gt.shape[0] / est.shape[0]).astype(int)
            xs = (np.arange(est.shape[1]) * gt.shape[1] / est.shape[1]).astype(int)
            gt = gt[ys][:, xs]
        per_view[str(vid)] = eval_depth_map(est, gt, thresholds).to_dict()

    if per_view:
        keys = ("completeness", "mae", "med_abs_err", "abs_rel")
        mean = {k: float(np.mean([m[k] for m in per_view.values()]))
                for k in keys}
        mean["frac_within"] = {
            t: float(np.mean([m["frac_within"][t] for m in per_view.values()]))
            for t in per_view[next(iter(per_view))]["frac_within"]}
        per_view["mean"] = mean
    return per_view


def main(argv=None) -> int:
    """CLI: depth-map or point-cloud evaluation, JSON to stdout."""
    import argparse

    p = argparse.ArgumentParser(
        prog="mpmvs-torch-eval",
        description="Evaluate depth maps / fused point clouds vs GT")
    sub = p.add_subparsers(dest="cmd", required=True)

    pd = sub.add_parser("dmap", help="single depth map vs GT")
    pd.add_argument("--est", required=True, help=".dmb estimated depth")
    pd.add_argument("--gt", required=True)
    pd.add_argument("--gt-format", choices=["dmb", "eth3d", "colmap"],
                    default="dmb")
    pd.add_argument("--gt-shape", type=int, nargs=2, default=None,
                    metavar=("H", "W"))
    pd.add_argument("--thresholds", type=float, nargs="+",
                    default=[0.02, 0.1, 0.5])

    ps = sub.add_parser("scene", help="all views of a result dir vs a GT dir")
    ps.add_argument("--result-dir", required=True,
                    help=".../MPMVS directory with 2333_%%08d subdirs")
    ps.add_argument("--gt-dir", required=True)
    ps.add_argument("--views", type=int, nargs="+", required=True)
    ps.add_argument("--gt-format", choices=["dmb", "eth3d", "colmap"],
                    default="dmb")
    ps.add_argument("--gt-shape", type=int, nargs=2, default=None)
    ps.add_argument("--thresholds", type=float, nargs="+",
                    default=[0.02, 0.1, 0.5])

    pc = sub.add_parser("cloud", help="fused PLY vs GT PLY (F1@tau)")
    pc.add_argument("--pred", required=True)
    pc.add_argument("--gt", required=True)
    pc.add_argument("--tau", type=float, default=0.02)

    args = p.parse_args(argv)
    if args.cmd == "dmap":
        from mpmvs_torch.io.dmb import (read_colmap_dmap, read_dmb,
                                        read_eth3d_gt)

        est = read_dmb(args.est)
        if args.gt_format == "dmb":
            gt = read_dmb(args.gt)
        elif args.gt_format == "eth3d":
            h, w = args.gt_shape or (4032, 6048)
            gt = read_eth3d_gt(args.gt, h, w)
        else:
            gt = read_colmap_dmap(args.gt)
        print(json.dumps(eval_depth_map(est, gt, args.thresholds).to_dict()))
    elif args.cmd == "scene":
        out = eval_scene_depths(args.result_dir, args.gt_dir, args.views,
                                args.gt_format,
                                tuple(args.gt_shape) if args.gt_shape else None,
                                args.thresholds)
        print(json.dumps(out))
    else:
        from mpmvs_torch.io.ply import read_ply_binary

        pred = read_ply_binary(args.pred)[0]
        gt = read_ply_binary(args.gt)[0]
        print(json.dumps(eval_point_cloud(pred, gt, args.tau).to_dict()))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
