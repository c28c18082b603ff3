"""End-to-end pipeline.

Counterpart of ``mpmvs_tpu.pipeline`` (the reference's main() +
ProcessProblem, src/main.cpp:6-55, src/PatchMatch.cpp:506-638), with the
reference's schedule:

  1. a photometric pass over all estimable views (with a planar-prior
     sub-run when ``planar_prior`` and not ``geom_planar_prior``);
  2. ``geom_iterations`` geometric passes over all views, with a prior
     sub-run inside every pass but the last when ``geom_planar_prior``;
  3. sky masks when ``sky_seg`` (the net and the bilateral kernel on the
     pipeline's device);
  4. multi-view fusion to a coloured PLY, skipping sky pixels.

Results flow pass to pass in memory on the pipeline's device; ``.dmb``
files are written as checkpoints and for drop-in compatibility, and a pass
manifest lets a killed run resume (``resume=True``), geometric passes
included.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch.camera import Camera, CameraStack
from mpmvs_torch.fusion import run_fusion
from mpmvs_torch.io import read_cam_txt, read_dmb, read_pair_txt, write_dmb
from mpmvs_torch.io import write_ply_binary
from mpmvs_torch.io.cams import Scene
from mpmvs_torch.models.sky import generate_sky_masks
from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.params import ConfigParams, PatchMatchParams
from mpmvs_torch.prior import build_planar_prior, draw_triangulation
from mpmvs_torch.solver import SolveResult, resolve_device, solve_view
from mpmvs_torch.utils import visualize
from mpmvs_torch.utils.trace import StageTimer, device_sync


@dataclasses.dataclass
class ViewRecord:
    """One view's loaded inputs + evolving results."""

    index: int
    image: np.ndarray          # (h, w) float32 grayscale
    color: np.ndarray          # (h, w, 3) float32 BGR
    camera: Camera
    result: Optional[SolveResult] = None
    sky_mask: Optional[np.ndarray] = None  # (h, w) bool, True = sky


def _load_view(input_folder: str, view_id: int,
               max_image_size: int) -> ViewRecord:
    """imread grayscale float32 + rescale >max_image_size with K adjustment
    (PatchMatchInit, PatchMatch.cpp:873-925)."""
    import cv2

    img_path = os.path.join(input_folder, "images", f"{view_id:08d}.jpg")
    gray = cv2.imread(img_path, cv2.IMREAD_GRAYSCALE)
    if gray is None:
        raise FileNotFoundError(img_path)
    color = cv2.imread(img_path, cv2.IMREAD_COLOR)
    cam = read_cam_txt(os.path.join(input_folder, "cams",
                                    f"{view_id:08d}_cam.txt"))
    h, w = gray.shape
    if max(h, w) > max_image_size:
        factor = min(max_image_size / w, max_image_size / h)
        nw, nh = round(w * factor), round(h * factor)
        gray = cv2.resize(gray, (nw, nh), interpolation=cv2.INTER_LINEAR)
        color = cv2.resize(color, (nw, nh), interpolation=cv2.INTER_LINEAR)
        cam = cam.rescale(nw / w, nh / h, nw, nh)
    else:
        cam = cam.rescale(1.0, 1.0, w, h)
    return ViewRecord(index=view_id, image=gray.astype(np.float32),
                      color=color.astype(np.float32), camera=cam)


def _pad_stack(arrays: List[np.ndarray], shape, fill=0.0) -> np.ndarray:
    out = np.full((len(arrays),) + tuple(shape), fill, np.float32)
    for i, a in enumerate(arrays):
        sl = tuple(slice(0, s) for s in a.shape)
        out[i][sl] = a
    return out


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class Pipeline:
    """End-to-end MP-MVS pipeline over a dense workspace, on ``device``.

    ``write_jpg`` writes the reference's previews beside each view's
    ``.dmb`` files (``costs.jpg``, ``triangulation.png``, the sky masks); it
    needs OpenCV. ``solve_log`` records (view, stage, seconds) of every
    solve, prior build and prior sub-run."""

    def __init__(self, config: ConfigParams,
                 params: Optional[PatchMatchParams] = None, device="cuda",
                 write_jpg: bool = True):
        self.config = config
        self.params = params or PatchMatchParams(
            max_image_size=config.max_image_size)
        self.device = resolve_device(device)
        self.write_jpg = write_jpg
        self.key = tf.PRNGKey(config.seed, device=self.device)
        self.scenes: List[Scene] = []
        self.views: Dict[int, ViewRecord] = {}
        self.timer = StageTimer()
        self.solve_log: List[Tuple[int, str, float]] = []

    # ---------------- data ----------------

    def load(self):
        cfg = self.config
        self.scenes = read_pair_txt(os.path.join(cfg.input_folder, "pair.txt"),
                                    cfg.max_source_images)
        for s in self.scenes:
            if not s.estimate:
                continue
            for vid in s.src_ids:
                if vid not in self.views:
                    self.views[vid] = _load_view(cfg.input_folder, vid,
                                                 cfg.max_image_size)
        return self

    def load_arrays(self, images, colors, cameras: CameraStack,
                    view_sel: Sequence[Sequence[int]]):
        """Fill the same records :meth:`load` fills from disk, from arrays:
        ``images`` (V, H, W) grayscale, ``colors`` (V, H, W, 3) BGR,
        ``cameras`` V stacked cameras (width/height set), ``view_sel[i]``
        the source ids of view i (empty: not estimated). Source lists are
        cut to ``max_source_images`` like pair.txt entries."""
        cfg = self.config
        images = np.asarray(images, np.float32)
        colors = np.asarray(colors, np.float32)
        V = images.shape[0]
        if len(view_sel) != V or colors.shape[0] != V or \
                cameras.num_views != V:
            raise ValueError("images, colors, cameras and view_sel must "
                             "cover the same views")
        if max(images.shape[1:]) > cfg.max_image_size:
            raise ValueError(f"images of {images.shape[1:]} exceed "
                             f"max_image_size {cfg.max_image_size}")
        self.scenes = [Scene(ref_id=i,
                             src_ids=[i] + list(src)[:cfg.max_source_images],
                             estimate=len(src) > 0)
                       for i, src in enumerate(view_sel)]
        cams = cameras.to("cpu")
        self.views = {i: ViewRecord(index=i, image=images[i],
                                    color=colors[i], camera=cams.view(i))
                      for i in range(V)}
        return self

    def result_dir(self, view_id: int) -> str:
        d = os.path.join(self.config.output_folder, "MPMVS",
                         f"2333_{view_id:08d}")
        os.makedirs(d, exist_ok=True)
        return d

    # ---------------- per-view solve ----------------

    def _scene_stack(self, scene: Scene):
        recs = [self.views[v] for v in scene.src_ids]
        H = max(r.image.shape[0] for r in recs)
        W = max(r.image.shape[1] for r in recs)
        images = _pad_stack([r.image for r in recs], (H, W))
        cams = CameraStack.stack([r.camera for r in recs])
        return images, cams, (H, W)

    def _next_key(self) -> torch.Tensor:
        keys = tf.split(self.key)
        self.key = keys[0]
        return keys[1]

    def process_view(self, scene: Scene, geom: bool, prior: bool,
                     log=print) -> SolveResult:
        """ProcessProblem equivalent: one view's solve (+ prior sub-run).

        A geometric solve warm-starts from the view's current result and
        reads the sources' *current* depth maps, so later views of a pass
        see the depths earlier views already updated (as the JAX package
        does). The prior sub-run reproduces the reference by default:
        photometric scoring, ``max_iterations`` iterations at scale 0; with
        ``config.geom_prior_consistency`` inside a geometric pass it keeps
        the geometric term ("geom_prior")."""
        t0 = time.perf_counter()
        images, cams, (H, W) = self._scene_stack(scene)
        rec = self.views[scene.ref_id]
        h, w = rec.image.shape
        dev = self.device

        src_depths = None
        if geom:
            # a source that is not estimated has no depth map: its depths
            # stay 0, which the geometric cost scores as the full penalty
            # (the reference reads a missing .dmb as an empty map)
            src_depths = torch.zeros((len(scene.src_ids) - 1, H, W),
                                     device=dev)
            for i, v in enumerate(scene.src_ids[1:]):
                if self.views[v].result is not None:
                    d = self.views[v].result.depth
                    src_depths[i, :d.shape[0], :d.shape[1]] = d
            res = self._solve(scene.ref_id, "geom", images, cams,
                              warm=_pad_result(rec.result, H, W),
                              src_depths=src_depths)
        else:
            res = self._solve(scene.ref_id, "photometric", images, cams)
        res = _crop_result(res, h, w)

        if prior:
            t1 = time.perf_counter()
            with self.timer.span("prior_build"):
                cam = rec.camera
                pr = build_planar_prior(
                    _np(res.depth), _np(res.cost), _np(cam.K),
                    float(cam.depth_min) * 0.6, float(cam.depth_max) * 1.2,
                    geom_cost=_np(res.geom_cost) if geom else None,
                    device=dev)
            self.solve_log.append((scene.ref_id, "prior_build",
                                   time.perf_counter() - t1))
            if pr is None:
                log(f"view {scene.ref_id:08d}: too few prior seeds, "
                    f"no prior sub-run")
            else:
                if self.write_jpg:
                    import cv2

                    cv2.imwrite(os.path.join(self.result_dir(scene.ref_id),
                                             "triangulation.png"),
                                draw_triangulation(rec.image, pr))
                if self.config.save_prior_dmb:
                    self._save_prior(scene.ref_id, pr, (h, w))
                geom_prior = geom and self.config.geom_prior_consistency
                planes = torch.zeros((H, W, 4), device=dev)
                planes[:h, :w] = torch.as_tensor(pr.planes, device=dev)
                mask = torch.zeros((H, W), dtype=torch.bool, device=dev)
                mask[:h, :w] = torch.as_tensor(pr.mask, device=dev)
                res = _crop_result(self._solve(
                    scene.ref_id, "geom_prior" if geom_prior else "prior",
                    images, cams, warm=_pad_result(res, H, W),
                    src_depths=src_depths if geom_prior else None,
                    prior_planes=planes, prior_mask=mask), h, w)

        rec.result = res
        log(f"view {scene.ref_id:08d}: geom={geom} prior={prior} "
            f"{time.perf_counter() - t0:.1f}s")
        return res

    def _solve(self, view_id: int, mode: str, images, cams,
               **inputs) -> SolveResult:
        """One solve_view with the next key, timed on the device."""
        stage = {"photometric": "photometric", "geom": "geom"}.get(mode,
                                                                   "prior")
        t0 = time.perf_counter()
        with self.timer.span(f"solve_{stage}"):
            res = solve_view(images, cams, self._next_key(), self.params,
                             mode, device=self.device, **inputs)
            device_sync(self.device)
        self.solve_log.append((view_id, stage, time.perf_counter() - t0))
        return res

    def _save_prior(self, view_id: int, pr, shape):
        """Rasterized prior depth/normal maps (the reference sketches them
        as commented-out depths_prior.dmb/normal_prior.dmb writes,
        PatchMatch.cpp:600-605); enabled by ``save_prior_dmb``."""
        h, w = shape
        cam = self.views[view_id].camera
        x, y = geo.pixel_grid(h, w)
        pl = pr.planes[:h, :w]
        mask = pr.mask[:h, :w]
        d = _np(geo.depth_from_plane(cam.K, torch.as_tensor(pl), x, y))
        d = np.where(mask, d, 0.0).astype(np.float32)
        dirn = self.result_dir(view_id)
        write_dmb(os.path.join(dirn, "depths_prior.dmb"), d)
        write_dmb(os.path.join(dirn, "normal_prior.dmb"),
                  np.where(mask[..., None], pl[..., :3], 0.0).astype(
                      np.float32))

    def save_view(self, view_id: int):
        """Reference-layout .dmb outputs (+ costs.jpg) (PatchMatch.cpp:620-633)."""
        res = self.views[view_id].result
        d = self.result_dir(view_id)
        write_dmb(os.path.join(d, "depths.dmb"), _np(res.depth))
        write_dmb(os.path.join(d, "normals.dmb"), _np(res.normal))
        write_dmb(os.path.join(d, "costs.dmb"), _np(res.cost))
        if self.write_jpg:
            import cv2

            cv2.imwrite(os.path.join(d, "costs.jpg"),
                        visualize.cost_to_img(_np(res.cost)))

    def load_view_result(self, view_id: int) -> bool:
        d = self.result_dir(view_id)
        try:
            depth = read_dmb(os.path.join(d, "depths.dmb"))
            normal = read_dmb(os.path.join(d, "normals.dmb"))
            cost = read_dmb(os.path.join(d, "costs.dmb"))
        except (FileNotFoundError, ValueError):
            return False
        t = lambda a: torch.as_tensor(a, device=self.device)
        self.views[view_id].result = SolveResult(
            depth=t(depth), normal=t(normal), cost=t(cost),
            geom_cost=torch.zeros_like(t(cost)))
        return True

    # ---------------- pass manifest (checkpoint/resume) ----------------

    def _manifest_path(self) -> str:
        d = os.path.join(self.config.output_folder, "MPMVS")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, "progress.json")

    def completed_passes(self) -> List[str]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f).get("completed", [])
        except (FileNotFoundError, ValueError):
            return []

    def _mark_pass_done(self, tag: str):
        done = self.completed_passes()
        if tag not in done:
            done.append(tag)
        with open(self._manifest_path(), "w") as f:
            json.dump({"completed": done}, f)

    def pass_schedule(self):
        """[(tag, geom, prior), ...] — the reference's main.cpp:20-41 order."""
        cfg = self.config
        photo_prior = cfg.planar_prior and not cfg.geom_planar_prior
        sched = [("photometric", False, photo_prior)]
        for git in range(cfg.geom_iterations):
            prior = (cfg.planar_prior and cfg.geom_planar_prior
                     and git != cfg.geom_iterations - 1)
            sched.append((f"geom_{git}", True, prior))
        return sched

    def _resume_point(self, resume: bool):
        """(number of passes to skip, whether stored results were loaded)."""
        if not resume:
            return 0, False
        done = self.completed_passes()
        skip = 0
        for tag, _, _ in self.pass_schedule():
            if tag in done:
                skip += 1
            else:
                break
        if skip == 0:
            return 0, False
        ok = all(self.load_view_result(s.ref_id)
                 for s in self.scenes if s.estimate)
        if not ok:
            return 0, False
        return skip, True

    # ---------------- passes ----------------

    def run(self, log=print, resume: bool = False) -> str:
        cfg = self.config
        if not self.scenes:
            self.load()
        estimable = [s for s in self.scenes if s.estimate]
        log(f"{len(estimable)} depth maps to compute")

        sched = self.pass_schedule()
        skip, loaded = self._resume_point(resume)
        if loaded:
            log(f"resume: skipping {skip} completed pass(es) "
                f"({', '.join(t for t, _, _ in sched[:skip])})")
        elif os.path.exists(self._manifest_path()):
            os.remove(self._manifest_path())

        for pi, (tag, geom, prior) in enumerate(sched):
            if pi < skip:
                continue
            for s in estimable:
                if (resume and not geom and skip == 0
                        and self.load_view_result(s.ref_id)):
                    continue
                self.process_view(s, geom=geom, prior=prior, log=log)
                with self.timer.span("checkpoint"):
                    self.save_view(s.ref_id)
            self._mark_pass_done(tag)

        # sky masks (main.cpp:43-47)
        if cfg.sky_seg:
            with self.timer.span("sky_masks"):
                generate_sky_masks(self, log=log)
                device_sync(self.device)

        ply = self.fuse(log=log)
        log(self.timer.summary())
        self.timer.dump_json(os.path.join(cfg.output_folder, "MPMVS",
                                          "timing.json"))
        return ply

    def fuse(self, log=print) -> str:
        """RunFusion + PLY (PatchMatch.cpp:287-504), on the pipeline's device."""
        cfg = self.config
        estimable = [s for s in self.scenes if s.estimate]
        ids = sorted({v for s in estimable for v in ([s.ref_id] + s.src_ids)
                      if self.views.get(v) and self.views[v].result is not None})
        H = max(self.views[i].image.shape[0] for i in ids)
        W = max(self.views[i].image.shape[1] for i in ids)
        depths = _pad_stack([_np(self.views[i].result.depth) for i in ids],
                            (H, W))
        normals = _pad_stack([_np(self.views[i].result.normal) for i in ids],
                             (H, W, 3))
        colors = _pad_stack([self.views[i].color for i in ids], (H, W, 3))
        sky = None
        if any(self.views[i].sky_mask is not None for i in ids):
            sky = _pad_stack([np.zeros((H, W), np.float32)
                              if self.views[i].sky_mask is None
                              else self.views[i].sky_mask.astype(np.float32)
                              for i in ids], (H, W)) > 0.5
        remap = {vid: k for k, vid in enumerate(ids)}
        scenes_r = [Scene(ref_id=remap[s.ref_id],
                          src_ids=[remap[v] for v in s.src_ids if v in remap],
                          estimate=True)
                    for s in estimable if s.ref_id in remap]
        cams = CameraStack.stack([self.views[i].camera for i in ids])
        t0 = time.perf_counter()
        with self.timer.span("fusion"):
            pts, nrm, col = run_fusion(depths, normals, colors, cams, scenes_r,
                                       use_dynamic=cfg.use_dynamic_consistency,
                                       sky_masks=sky, device=self.device)
        log(f"fusion: {len(pts)} points in {time.perf_counter() - t0:.1f}s")
        out_dir = os.path.join(cfg.output_folder, "MPMVS")
        os.makedirs(out_dir, exist_ok=True)
        ply_path = os.path.join(out_dir, "MPMVS_model.ply")
        write_ply_binary(ply_path, pts, nrm, col)
        if any([cfg.save_dmb, cfg.save_cost_dmb, cfg.save_normal_dmb]):
            self.save_visualizations()
        return ply_path

    def save_visualizations(self):
        """saveDmbAsJpg equivalent (utility.cpp:479-520); needs OpenCV."""
        import cv2

        cfg = self.config
        for s in self.scenes:
            if not s.estimate or self.views[s.ref_id].result is None:
                continue
            d = self.result_dir(s.ref_id)
            res = self.views[s.ref_id].result
            if cfg.save_dmb:
                cv2.imwrite(os.path.join(d, "depths.jpg"),
                            visualize.depth_to_jet(_np(res.depth)))
            if cfg.save_cost_dmb:
                cv2.imwrite(os.path.join(d, "costs.jpg"),
                            visualize.cost_to_img(_np(res.cost)))
            if cfg.save_normal_dmb:
                cv2.imwrite(os.path.join(d, "normals.jpg"),
                            visualize.normal_to_img(_np(res.normal)))


def _pad_result(res: SolveResult, H: int, W: int) -> SolveResult:
    """Zero-pad a result to (H, W)."""
    if res.depth.shape == (H, W):
        return res

    def pad(a):
        channel = (0, 0) if a.ndim == 3 else ()
        return torch.nn.functional.pad(
            a, channel + (0, W - a.shape[1], 0, H - a.shape[0]))

    return SolveResult(depth=pad(res.depth), normal=pad(res.normal),
                       cost=pad(res.cost), geom_cost=pad(res.geom_cost))


def _crop_result(res: SolveResult, h: int, w: int) -> SolveResult:
    if res.depth.shape == (h, w):
        return res
    return SolveResult(depth=res.depth[:h, :w], normal=res.normal[:h, :w],
                       cost=res.cost[:h, :w], geom_cost=res.geom_cost[:h, :w])
