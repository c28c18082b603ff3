"""End-to-end accuracy of the port on the raytraced shapes scene.

The scene (``utils.synthetic.make_shapes_scene``: textured wall, floor,
slanted slab, box and sphere, with occlusions, depth discontinuities and
curved surfaces) has exact GT depth per view and an exact GT surface
cloud, in meters, so F1 at 2 cm means what it means on ETH3D. The run is
the user-facing path: a workspace in the reference's on-disk layout
(images/, cams/, pair.txt) -> ``Pipeline.run`` (photometric pass, planar
prior, geometric passes, fusion) -> ``eval.eval_scene_depths`` on the .dmb
outputs and ``eval.eval_point_cloud`` on the fused PLY.

Port of tools/synthetic_eval.py::

    python -m mpmvs_torch.tools.synthetic_eval --height 720 --width 960 \\
        --views 7 --out eval.json
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--views", type=int, default=7)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--device", default="cuda")
    p.add_argument("--workdir", default=None,
                   help="scratch directory (default: a temporary one, "
                        "removed afterwards)")
    p.add_argument("--out", required=True, help="JSON result file")
    p.add_argument("--geom-iterations", type=int, default=2)
    p.add_argument("--tau", type=float, default=0.02)
    p.add_argument("--fast", action="store_true",
                   help="reduced schedule for smoke testing")
    args = p.parse_args(argv)

    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.solver import resolve_device
    from mpmvs_torch.tools import (build_kernels, device_record,
                                   run_shapes_pipeline)
    from mpmvs_torch.utils.synthetic import make_shapes_scene

    dev = resolve_device(args.device)
    build_kernels(dev)
    params = None
    if args.fast:
        params = PatchMatchParams(max_iterations=1, max_scale=0,
                                  geom_iterations=1)
    workdir = args.workdir or tempfile.mkdtemp(prefix="mpmvs_eval_")
    try:
        t0 = time.perf_counter()
        scene = make_shapes_scene(num_views=args.views, height=args.height,
                                  width=args.width)
        scene_s = time.perf_counter() - t0
        res = run_shapes_pipeline(scene, workdir, params, dev,
                                  args.geom_iterations, args.tau)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    depth_metrics, cloud, wall = res["depth"], res["cloud"], res["wall_s"]

    out = {
        "scene": {
            "kind": "raytraced shapes (wall/floor/slab/box/sphere)",
            "views": args.views,
            "resolution": [args.width, args.height],
            "schedule": {"planar_prior": True, "geom_planar_prior": True,
                         "geom_iterations": args.geom_iterations,
                         "fast": bool(args.fast)},
        },
        "device": device_record(dev),
        "depth": depth_metrics,
        "cloud_f1": cloud.to_dict(),
        "n_fused_points": res["n_fused_points"],
        "setup_s": scene_s + res["setup_s"],
        "wall_s": wall,
        "stage_s": res["stage_s"],
        "launches_kernel_plain": res["launches"],
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"f1": cloud.f1, "accuracy": cloud.accuracy,
                      "completeness": cloud.completeness,
                      "depth_mean": depth_metrics.get("mean"),
                      "wall_s": wall}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
