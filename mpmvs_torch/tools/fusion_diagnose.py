"""Fusion-gate and depth-outlier diagnosis over a finished workspace.

Port of tools/fusion_diagnose.py. It replays the fusion pass over a
completed workspace in ``synthetic_eval``'s layout (``<workdir>/ws`` with
its MPMVS/ results, ``<workdir>/gt`` with GT .dmb depths) on the device the
caller names, and records:

  * per reference view, the gate funnel (``fusion.fusion_gate_funnel``):
    how many (source, pixel) candidates survive each successive gate of
    fuse_one_view (src/PatchMatch.cpp:403-496), and the candidates that
    fail only the reprojection, relative-depth or angle gate;
  * per view, the depth map's error against GT: MAE, the bad-pixel share
    (|err| > ``--bad-thresh`` m), its sign bias, and the occlusion probe,
    the mean number of sources in which each pixel's GT point is visible
    (its GT depth within 1% of the source's own GT depth).

Run after ``synthetic_eval`` with the same ``--workdir``::

    python -m mpmvs_torch.tools.synthetic_eval --workdir W --out eval.json
    python -m mpmvs_torch.tools.fusion_diagnose --workdir W --out diag.json

``--out`` is required. ``--device`` defaults to ``cuda``; without a card
the tool exits non-zero unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def gt_visibility(gt, cams, scenes, H: int, W: int, device):
    """Per estimated view (H, W) int counts: the sources in which the pixel's
    GT point lies in the image and within 1% of that source's GT depth."""
    import torch

    from mpmvs_torch import geometry as geo

    x, y = geo.pixel_grid(H, W, device=device)
    out = []
    for s in scenes:
        i = s.ref_id
        K_r, R_r, t_r = cams.K[i], cams.R[i], cams.t[i]
        Xw = geo.backproject_world(K_r, R_r, -(R_r.T @ t_r), x, y, gt[i])
        cnt = torch.zeros((H, W), dtype=torch.int32, device=device)
        for j in s.src_ids[1:]:
            pt, pd = geo.project_camera(cams.K[j], cams.R[j], cams.t[j], Xw)
            cc = torch.clamp(torch.round(pt[..., 0]), 0, W - 1).long()
            rr = torch.clamp(torch.round(pt[..., 1]), 0, H - 1).long()
            inb = ((pt[..., 0] >= 0) & (pt[..., 0] < W) & (pt[..., 1] >= 0)
                   & (pt[..., 1] < H))
            d_src = gt[j][rr, cc]
            visible = inb & (d_src > 0) & (
                torch.abs(pd - d_src) / torch.clamp(d_src, min=1e-9) < 0.01)
            cnt += visible.to(torch.int32)
        out.append(cnt.cpu().numpy())
    return out


def diagnose(workdir: str, device, bad_thresh: float = 0.1) -> dict:
    """The report of one finished workspace: {"views": {id: {"funnel",
    "accepted_points", "depth"}}, "totals": {...}, "bad_thresh_m"}."""
    import numpy as np
    import torch

    from mpmvs_torch.camera import CameraStack
    from mpmvs_torch.fusion import (FusionInput, _mark_used, fuse_one_view,
                                    fusion_gate_funnel)
    from mpmvs_torch.io.cams import Scene
    from mpmvs_torch.io.dmb import read_dmb
    from mpmvs_torch.params import ConfigParams
    from mpmvs_torch.pipeline import Pipeline, _np, _pad_stack

    ws = os.path.join(workdir, "ws")
    gt_dir = os.path.join(workdir, "gt")
    pipe = Pipeline(ConfigParams(input_folder=ws, output_folder=ws),
                    device=device, write_jpg=False).load()
    for s in pipe.scenes:
        if s.estimate and not pipe.load_view_result(s.ref_id):
            raise FileNotFoundError(f"no solved result for view {s.ref_id} "
                                    f"under {ws}/MPMVS: run synthetic_eval "
                                    f"with this --workdir first")
    estimable = [s for s in pipe.scenes if s.estimate]
    ids = sorted({v for s in estimable for v in [s.ref_id] + s.src_ids})
    H = max(pipe.views[i].image.shape[0] for i in ids)
    W = max(pipe.views[i].image.shape[1] for i in ids)
    stack = lambda arrays, shape: torch.as_tensor(
        _pad_stack(arrays, shape), device=pipe.device)
    depths = stack([_np(pipe.views[i].result.depth) for i in ids], (H, W))
    normals = stack([_np(pipe.views[i].result.normal) for i in ids],
                    (H, W, 3))
    colors = stack([pipe.views[i].color for i in ids], (H, W, 3))
    cams = CameraStack.stack([pipe.views[i].camera for i in ids]).to(
        pipe.device)
    remap = {vid: k for k, vid in enumerate(ids)}
    scenes_r = [Scene(ref_id=remap[s.ref_id],
                      src_ids=[remap[v] for v in s.src_ids if v in remap],
                      estimate=True) for s in estimable]
    gt = np.stack([read_dmb(os.path.join(gt_dir, f"{v:08d}.dmb"))
                   for v in ids])
    vis = gt_visibility(torch.as_tensor(gt, device=pipe.device), cams,
                        scenes_r, H, W, pipe.device)

    inp = FusionInput(depths=depths, normals=normals, colors=colors,
                      cameras=cams)
    masks = torch.zeros((len(ids), H, W), dtype=torch.bool,
                        device=pipe.device)
    max_src = max(len(s.src_ids) - 1 for s in scenes_r)
    report, tot = {"views": {}}, {}
    depths_h = depths.cpu().numpy()
    for s, vc in zip(scenes_r, vis):
        i, src = s.ref_id, s.src_ids[1:]
        src_valid = torch.zeros(max_src, dtype=torch.bool, device=pipe.device)
        src_valid[:len(src)] = True
        src_idx = torch.zeros(max_src, dtype=torch.int64, device=pipe.device)
        src_idx[:len(src)] = torch.as_tensor(src, device=pipe.device)
        funnel = fusion_gate_funnel(inp, masks, i, src_idx, src_valid)
        out = fuse_one_view(inp, masks, i, src_idx, src_valid,
                            use_dynamic=True)
        n_acc = int(out.accept.sum())
        masks = _mark_used(masks, out, i, src_idx)

        err = depths_h[i] - gt[i]
        bad = np.abs(err) > bad_thresh
        mean_or = lambda a, m, default: float(a[m].mean()) if m.any() \
            else default
        report["views"][ids[i]] = {"funnel": funnel, "accepted_points": n_acc,
                                   "depth": {
            "mae": float(np.abs(err).mean()),
            "bad_frac": float(bad.mean()),
            "bad_sign_mean": mean_or(np.sign(err), bad, 0.0),
            "bad_mean_err": mean_or(err, bad, 0.0),
            "gt_visibility_mean_all": float(vc.mean()),
            "gt_visibility_mean_bad": mean_or(vc, bad, None),
            "gt_visibility_mean_good": float(vc[~bad].mean()),
            "bad_frac_where_gt_occluded(le1 src)": mean_or(bad, vc <= 1,
                                                           None),
            "bad_frac_where_gt_visible(ge2 src)": mean_or(bad, vc >= 2,
                                                          None)}}
        for k, v in funnel.items():
            tot[k] = tot.get(k, 0) + v
        tot["accepted_points"] = tot.get("accepted_points", 0) + n_acc
    report["totals"] = tot
    report["bad_thresh_m"] = bad_thresh
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", required=True,
                   help="synthetic_eval's --workdir (ws/ and gt/)")
    p.add_argument("--bad-thresh", type=float, default=0.1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True, help="JSON report file")
    args = p.parse_args(argv)

    from mpmvs_torch.solver import resolve_device
    from mpmvs_torch.tools import device_record

    dev = resolve_device(args.device)
    report = diagnose(args.workdir, dev, args.bad_thresh)
    report["device"] = device_record(dev)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"totals": report["totals"]}))
    for vid, r in report["views"].items():
        f = r["funnel"]
        print(f"view {vid}: accepted {r['accepted_points']:7d}  "
              f"cand {f['candidates']:9d} -> inb {f['in_bounds']:9d} -> "
              f"reproj {f['reproj_lt2']:8d} -> dd {f['rel_dd_lt_0.01']:8d} "
              f"-> ang {f['angle_lt_10deg']:8d}  | only-kills r/d/a "
              f"{f['only_reproj_fails']}/{f['only_rel_dd_fails']}/"
              f"{f['only_angle_fails']}  | mae {r['depth']['mae']:.3f} bad% "
              f"{100 * r['depth']['bad_frac']:.1f} vis(bad) "
              f"{r['depth']['gt_visibility_mean_bad']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
