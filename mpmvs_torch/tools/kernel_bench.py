"""Microbenchmark of the NCC kernel (``csrc/ncc_eval.cu``) on one CUDA card.

Port of tools/kernel_bench.py (the JAX package's Pallas-kernel bench):
the same operating point (``make_plane_scene`` at 3200x2130 with 11
views, a middle row band) and the same field classes, built with the
port's ``ops/random.py``:

  * ``coherent`` -- cone normals + smooth tile-banded depths, what the
    init field and the propagated candidates look like;
  * ``trials`` -- full-hemisphere normals + banded depths, the random
    refinement trials (the footprint-cap-bound worst case);
  * ``full`` -- full-hemisphere normals + full-range depths
    (``random_plane_field``), the reference-semantics init field.

A configuration is K stacked fields at one window scale over one pixel
set: ``packed`` (one checkerboard colour of the band, as a band step
scores it) or ``all`` (every pixel of the band, as init scoring does).
Two more cases take the band step's own calls: ``step-default`` and
``step-reference`` run one real half-iteration (scale 0, colour 0) from a
converged state, the scene's true planes, under the default or the
reference's search semantics (``tools.ab_deviations.REFERENCE``), and
time the two NCC calls it makes, the K=9 candidates and the K=5
refinement trials, on the very inputs the solver built.

Without ``--k`` the default suite runs: K=9 and K=5 at scale 0 on packed
pixels (coherent, trials), K=1 at scale 2 on all pixels (coherent, full),
then both step cases. ``--launch`` picks the kernel's launch: ``auto``
(the default) takes the one the solver takes (for the synthetic fields:
view-major for ``full``, tile for the others), ``both`` times each case
under each. Each case prints one JSON line: CUDA-event ms after a
warm-up, Gtaps/s, the bound (``utils.roofline.ncc_bound``, the least time
the card could take for the same work), the share of it reached, and the
card's name and power limit. ``--check`` also holds the kernel against
its plain version on the same inputs. Without a CUDA device the tool
exits non-zero::

    python -m mpmvs_torch.tools.kernel_bench
    python -m mpmvs_torch.tools.kernel_bench --k 9 --cases trials --check
    python -m mpmvs_torch.tools.kernel_bench --k 5 --cases step-reference \\
        --launch both

What is TPU-only in the JAX tool (``--quad``, ``WIN_BLOCKS``) has no
counterpart here.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import NamedTuple

import torch

Tensor = torch.Tensor

STEPS = ("step-default", "step-reference")
SUITE = ((9, 0, "packed", ("coherent", "trials")),
         (5, 0, "packed", ("coherent", "trials")),
         (1, 2, "all", ("coherent", "full")),
         (None, 0, "packed", STEPS))
LAUNCHES = {"tile": False, "view-major": True}


def _stack(key: Tensor, K: int, K_ref: Tensor, x: Tensor, y: Tensor,
           normal_fn, depth_fn) -> Tensor:
    """K plane fields; field i from the i-th of K keys split into a normal
    key and a depth key (tools/kernel_bench.py:86-98)."""
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import threefry as tf

    fields = []
    for k in tf.split(key, K):
        k_n, k_d = tf.split(k)
        fields.append(geo.plane_from_depth_normal(
            K_ref, x, y, depth_fn(k_d), normal_fn(k_n)))
    return torch.stack(fields)


def _banded(x, y, dmin, dmax, frac):
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf

    return lambda k: pmrand.smooth_banded_uniform(*tf.split(k), x, y, dmin,
                                                  dmax, frac)


def coherent_planes(key, K, K_ref, x, y, dmin, dmax, params) -> Tensor:
    """(K, ..., 4): normals in the init cone, banded depths."""
    from mpmvs_torch.ops import random as pmrand

    cone = math.radians(params.init_normal_cone_deg)
    return _stack(key, K, K_ref, x, y,
                  lambda k: pmrand.cone_normal_field(k, K_ref, x, y, cone),
                  _banded(x, y, dmin, dmax, params.random_band_frac))


def trial_planes(key, K, K_ref, x, y, dmin, dmax, params) -> Tensor:
    """(K, ..., 4): full-hemisphere normals, banded depths."""
    from mpmvs_torch.ops import random as pmrand

    return _stack(key, K, K_ref, x, y,
                  lambda k: pmrand.random_normal_field(k, K_ref, x, y),
                  _banded(x, y, dmin, dmax, params.random_band_frac))


def full_planes(key, K, K_ref, x, y, dmin, dmax, params) -> Tensor:
    """(K, ..., 4): ``random_plane_field`` per field (full-range depths)."""
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf

    return torch.stack([pmrand.random_plane_field(k, K_ref, x, y, dmin, dmax)
                        for k in tf.split(key, K)])


FIELDS = {"coherent": coherent_planes, "trials": trial_planes,
          "full": full_planes}


class Bench(NamedTuple):
    data: object       # SolveData of view 0
    params: object     # PatchMatchParams
    band_rows: int
    y0: int            # first row of the band
    device: dict       # tools.device_record
    gt_plane: Tensor   # (H, W, 4) view 0's true planes


def setup(height: int, width: int, views: int, band_rows: int,
          cap_mult=None, seed: int = 0, device: str = "cuda") -> Bench:
    """The scene on ``device`` and the band: ``band_rows`` 0 takes the
    solve's own band height (``solver.solve_band_rows``)."""
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.solver import build_solve_data, solve_band_rows
    from mpmvs_torch.tools import device_record
    from mpmvs_torch.utils.synthetic import make_plane_scene

    dev = torch.device(device)
    pkw = {} if cap_mult is None else {"footprint_cap_mult": cap_mult}
    params = PatchMatchParams(**pkw)
    scene = make_plane_scene(num_views=views, height=height, width=width,
                             seed=seed)
    data = build_solve_data(torch.as_tensor(scene.images, device=dev),
                            scene.cameras.to(dev))
    br = band_rows or solve_band_rows(params, height, width, views - 1)
    x, y = geo.pixel_grid(height, width, device=dev)
    n_world = torch.as_tensor(scene.gt_normal_world, device=dev)
    gt_plane = geo.plane_from_depth_normal(
        data.K_ref, x, y, torch.as_tensor(scene.gt_depth[0], device=dev),
        geo.normal_world_to_cam(data.R_ref,
                                n_world.expand(height, width, 3)))
    return Bench(data, params, br, (height // 2 // br) * br,
                 device_record(dev), gt_plane)


def case_inputs(bench: Bench, K: int, scale: int, pixels: str, field: str,
                key_seed: int = 7):
    """ncc_eval_multi's arguments for one case."""
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc import ncc_refside
    from mpmvs_torch.ops.packing import packed_coords
    from mpmvs_torch.ops.propagation import _pad_rows, step_halo

    data, params, br, y0 = bench.data, bench.params, bench.band_rows, bench.y0
    dev = data.ref_img.device
    W = data.ref_img.shape[1]
    offs = params.tap_offsets(scale)
    halo = step_halo(scale)
    ref_s = _pad_rows(data.ref_img, halo, halo)[y0:y0 + br + 2 * halo]
    if pixels == "packed":
        phase = 0
        x, y = packed_coords(y0, br, W // 2, phase, device=dev)
    elif pixels == "all":
        phase = None
        x = torch.arange(W, dtype=torch.float32, device=dev)[None].expand(
            br, W).contiguous()
        y = (torch.arange(br, dtype=torch.float32, device=dev)[:, None]
             + float(y0)).expand(br, W).contiguous()
    else:
        raise ValueError(f"pixels must be 'packed' or 'all', got {pixels!r}")
    refside = ncc_refside(ref_s, halo, br, offs, params.sigma_spatial,
                          params.sigma_color, pack_phase=phase)
    planes = FIELDS[field](tf.PRNGKey(key_seed, device=dev), K, data.K_ref,
                           x, y, data.depth_min, data.depth_max, params)
    return (refside, data.src_imgs, data.src_widths, data.src_heights,
            data.A, data.b, data.K_ref, planes.contiguous(), x, y, offs,
            params.cost_max, params.cap_radius(scale))


def step_calls(bench: Bench, semantics: str, key_seed: int = 7):
    """The NCC calls of one half-iteration (``checkerboard_step`` at scale
    0, colour 0, the first iteration) from the converged state, the true
    planes, under ``semantics`` ("default" or "reference"):
    [(args, kwargs)] in call order, the K=9 candidates then the K=5
    refinement trials; kwargs hold the launch the solver picked. The calls
    are answered with a constant cost, so the step adopts neighbours'
    true planes and draws its trials around them."""
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.propagation import PatchMatchState, checkerboard_step
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.tools.ab_deviations import REFERENCE

    params = PatchMatchParams(**{"default": {}, "reference": REFERENCE}[
        semantics])
    data, plane = bench.data, bench.gt_plane
    S = data.src_imgs.shape[0]
    calls = []

    def capture(*args, **kwargs):
        calls.append((args, kwargs))
        planes, x = args[7], args[8]
        return torch.full((planes.shape[0], S) + tuple(x.shape), 0.5,
                          device=x.device)

    H, W = plane.shape[:2]
    state = PatchMatchState(
        plane=plane, cost=torch.ones((H, W), device=plane.device),
        geom_cost=torch.zeros((H, W), device=plane.device),
        sel=torch.full((H, W), (1 << S) - 1, dtype=torch.int32,
                       device=plane.device))
    checkerboard_step(state, data, params, 0, 0, 0,
                      tf.PRNGKey(key_seed, device=plane.device),
                      band_rows=bench.band_rows, ncc_multi=capture)
    return calls


def time_call(bench: Bench, args, head: dict, scattered: bool,
              reps: int = 5, check: bool = False) -> dict:
    """Time ``ncc_eval_multi_kernel(*args)`` under one launch with CUDA
    events; ``head`` and the measurements as one result dict."""
    from mpmvs_torch.ops.ncc_cuda import (ncc_eval_multi_kernel,
                                          ncc_eval_multi_plain)
    from mpmvs_torch.utils.roofline import ncc_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    S, Hp, Wp = args[1].shape
    K = args[7].shape[0]
    R, C = args[8].shape
    P, T = R * C, len(args[10])
    cap = args[12]
    ms = cuda_time_ms(lambda: ncc_eval_multi_kernel(
        *args, scattered=scattered), reps=reps)
    out = ncc_eval_multi_kernel(*args, scattered=scattered)
    b_ms, b_by = ncc_bound(K, S, P, T, 4 * S * Hp * Wp, cap > 0)
    taps = K * S * P * T
    res = dict(head, k=K, launch="view-major" if scattered else "tile",
               band_rows=bench.band_rows,
               shape=f"{C}x{R} px, {S} src {Wp}x{Hp}", cap_radius=cap,
               ms=ms, gtaps_per_s=taps / ms / 1e6, bound_ms=b_ms,
               bound_by=b_by, share_of_bound=b_ms / ms,
               mean_cost=out.mean().item())
    if check:
        want = ncc_eval_multi_plain(*args)
        same = (out == want) | (torch.isnan(out) & torch.isnan(want))
        res["entries_differing"] = int((~same).sum().item())
        fin = torch.isfinite(out) & torch.isfinite(want)
        res["max_abs_err"] = (out - want)[fin].abs().max().item()
        del want
    res.update(kind=bench.device["kind"],
               nvidia_smi=bench.device["nvidia_smi"])
    return res


def _launches(launch: str, auto: bool):
    """The ``scattered`` flags to time: the solver's (``auto``) or the
    named launch, or both."""
    if launch == "auto":
        return (auto,)
    if launch == "both":
        return (False, True)
    return (LAUNCHES[launch],)


def run_case(bench: Bench, K: int, scale: int, pixels: str, field: str,
             reps: int = 5, check: bool = False, launch: str = "auto"):
    """Time one case: a list of result dicts, one per launch and, for the
    step cases, per NCC call of the step (``K`` and ``pixels`` then come
    from the call)."""
    if field in STEPS:
        calls = [(args, kw.get("scattered", False)) for args, kw in
                 step_calls(bench, field.split("-", 1)[1])]
        calls = [c for c in calls if K is None or c[0][7].shape[0] == K]
        pixels = "packed"
    else:
        calls = [(case_inputs(bench, K, scale, pixels, field),
                  field == "full")]
    res = []
    for args, auto in calls:
        for scattered in _launches(launch, auto):
            res.append(time_call(
                bench, args, {"case": field, "scale": scale,
                              "pixels": pixels, "solver_launch":
                              "view-major" if auto else "tile"},
                scattered, reps, check))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=2130)
    ap.add_argument("--width", type=int, default=3200)
    ap.add_argument("--views", type=int, default=11)
    ap.add_argument("--band-rows", type=int, default=0,
                    help="rows of the band (0: the solve's band height)")
    ap.add_argument("--k", type=int, default=None,
                    help="stacked fields per call (default: the suite)")
    ap.add_argument("--scale", type=int, default=0)
    ap.add_argument("--pixels", default="packed", choices=("packed", "all"))
    ap.add_argument("--cases", default="coherent,trials",
                    help=f"comma-separated, of "
                    f"{sorted(FIELDS) + list(STEPS)}")
    ap.add_argument("--cap-mult", type=float, default=None,
                    help="override params.footprint_cap_mult")
    ap.add_argument("--launch", default="auto",
                    choices=("auto", "both") + tuple(LAUNCHES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check", action="store_true",
                    help="also compare with the plain version")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("no CUDA device: kernel_bench times the kernel on a card",
              file=sys.stderr)
        return 1
    from mpmvs_torch.ops import ncc_cuda, nvcc

    nvcc.build(ncc_cuda.SOURCE, ncc_cuda.NVCC_FLAGS, verbose=True)
    t0 = time.perf_counter()
    bench = setup(args.height, args.width, args.views, args.band_rows,
                  args.cap_mult)
    print(f"scene and band in {time.perf_counter() - t0:.1f} s", flush=True)
    one = (args.k, args.scale, args.pixels, tuple(args.cases.split(",")))
    suite = SUITE if args.k is None else (one,)
    for K, scale, pixels, fields in suite:
        for field in fields:
            for res in run_case(bench, K, scale, pixels, field, args.reps,
                                args.check, args.launch):
                print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
