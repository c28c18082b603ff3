"""A/B of the JAX package's search deviations against the reference's
search semantics, on the port.

The solver's defaults deviate from the reference's search: tile-banded
random draws (``coherent_random``), the footprint-cap box
(``footprint_cap_mult``), the disparity clamp (``disp_clamp_frac``) and the
init normal cone (``init_normal_cone_deg``). The reference draws
full-range per-pixel randoms every iteration with unbounded footprints
(src/PatchMatch.cu:197-226, 642-722). The full pipeline (photometric,
planar prior, two geometric passes, fusion) runs once per arm on the
raytraced shapes scene and reports wall time, depth MAE and cloud F1:

  * ``deviations_on``: the defaults;
  * ``reference_semantics``: the reference's search, its incoherent fields
    (the init field, refinement trials 0 and 2) through the bucket-sorted
    sample kernel (``sampler="sorted"``);
  * ``reference_semantics_kernel1``: the same search with every field
    through the K-stacked NCC kernel (``sampler="auto"``), which tells the
    sampler's cost apart from the semantics' cost.

Port of tools/ab_deviations.py (the JAX package's ``src_quant8`` knob is
not ported, so its arm drops it)::

    python -m mpmvs_torch.tools.ab_deviations --height 240 --width 320 \\
        --views 7 --out ab.json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

REFERENCE = dict(coherent_random=False, footprint_cap_mult=0.0,
                 disp_clamp_frac=0.0, init_normal_cone_deg=90.0)
ARMS = {
    "deviations_on": {},
    "reference_semantics": dict(REFERENCE, sampler="sorted"),
    "reference_semantics_kernel1": dict(REFERENCE, sampler="auto"),
}


def run_arm(name, overrides, scene, args, workdir):
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.tools import run_shapes_pipeline

    armdir = os.path.join(workdir, name)
    shutil.rmtree(armdir, ignore_errors=True)
    if args.fast:  # plumbing smoke test only, not a valid A/B
        overrides = dict(overrides, max_iterations=1, max_scale=0,
                         geom_iterations=1)
    res = run_shapes_pipeline(scene, armdir, PatchMatchParams(**overrides),
                              args.device, 1 if args.fast else 2, args.tau)
    depth = res["depth"]
    return {
        "params": overrides,
        "wall_s": res["wall_s"],
        "stage_s": res["stage_s"],
        "launches_kernel_plain": res["launches"],
        "depth_mae": depth["mean"]["mae"],
        "depth_frac_within_2cm": depth["mean"]["frac_within"]["0.02"],
        "cloud": res["cloud"].to_dict(),
        "n_fused_points": res["n_fused_points"],
        "per_view_mae": {v: depth[str(v)]["mae"] for v in range(args.views)},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--views", type=int, default=7)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--tau", type=float, default=0.02)
    p.add_argument("--device", default="cuda")
    p.add_argument("--workdir", default=None,
                   help="scratch directory (default: a temporary one, "
                        "removed afterwards)")
    p.add_argument("--out", required=True, help="JSON result file")
    p.add_argument("--arms", default=",".join(ARMS))
    p.add_argument("--fast", action="store_true",
                   help="reduced schedule: plumbing smoke test only")
    args = p.parse_args(argv)

    from mpmvs_torch.solver import resolve_device
    from mpmvs_torch.tools import build_kernels, device_record
    from mpmvs_torch.utils.synthetic import make_shapes_scene

    dev = resolve_device(args.device)
    build_kernels(dev)
    scene = make_shapes_scene(num_views=args.views, height=args.height,
                              width=args.width)
    out = {"scene": {"kind": "raytraced shapes", "views": args.views,
                     "resolution": [args.width, args.height],
                     "tau": args.tau, "fast": bool(args.fast)},
           "device": device_record(dev), "arms": {}}
    workdir = args.workdir or tempfile.mkdtemp(prefix="mpmvs_ab_")
    try:
        for name in args.arms.split(","):
            res = run_arm(name, ARMS[name], scene, args, workdir)
            out["arms"][name] = res
            print(json.dumps({"arm": name, "f1": res["cloud"]["f1"],
                              "mae": res["depth_mae"],
                              "wall_s": res["wall_s"]}), flush=True)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    arms = out["arms"]
    if "deviations_on" in arms and "reference_semantics" in arms:
        a, b = arms["deviations_on"], arms["reference_semantics"]
        out["delta"] = {
            "f1_deviations_minus_reference": a["cloud"]["f1"]
            - b["cloud"]["f1"],
            "mae_deviations_minus_reference": a["depth_mae"]
            - b["depth_mae"]}
        print(json.dumps(out["delta"]))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
