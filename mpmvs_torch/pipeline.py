"""End-to-end pipeline (photometric slice).

Counterpart of ``mpmvs_tpu.pipeline`` (the reference's main() +
ProcessProblem, src/main.cpp:6-55, src/PatchMatch.cpp:506-638): a
photometric pass over all estimable views, then multi-view fusion to a
coloured PLY. Results flow pass to pass in memory on the pipeline's device;
``.dmb`` files are written as checkpoints and for drop-in compatibility, and
a pass manifest lets a killed run resume (``resume=True``).

This slice runs the photometric schedule only. A configuration that asks for
geometric passes (``geom_iterations > 0``), a planar prior or sky masks
raises ``NotImplementedError`` before any work starts; those are ROADMAP
queue 1 items 7, 9 and 11.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mpmvs_torch.camera import Camera, CameraStack
from mpmvs_torch.fusion import run_fusion
from mpmvs_torch.io import read_cam_txt, read_dmb, read_pair_txt, write_dmb
from mpmvs_torch.io import write_ply_binary
from mpmvs_torch.io.cams import Scene
from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.params import ConfigParams, PatchMatchParams
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

    ``write_jpg`` writes the reference's ``costs.jpg`` preview beside each
    view's ``.dmb`` files; it needs OpenCV."""

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
        self.solve_seconds: Dict[int, float] = {}

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
        """ProcessProblem equivalent for the photometric pass."""
        if geom or prior:
            raise NotImplementedError(
                "geometric passes and planar-prior sub-runs are not ported "
                "yet (ROADMAP queue 1 items 7 and 9)")
        t0 = time.perf_counter()
        images, cams, _ = self._scene_stack(scene)
        rec = self.views[scene.ref_id]
        h, w = rec.image.shape
        with self.timer.span("solve_photometric"):
            res = solve_view(images, cams, self._next_key(), self.params,
                             "photometric", device=self.device)
            device_sync(self.device)
        res = _crop_result(res, h, w)
        rec.result = res
        dt = time.perf_counter() - t0
        self.solve_seconds[scene.ref_id] = dt
        log(f"view {scene.ref_id:08d}: geom={geom} prior={prior} {dt:.1f}s")
        return res

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

    def _check_supported(self):
        cfg = self.config
        missing = [name for name, on in (
            ("geometric passes (geom_iterations > 0; ROADMAP item 7)",
             cfg.geom_iterations > 0),
            ("planar prior (ROADMAP item 9)", cfg.planar_prior),
            ("sky segmentation (ROADMAP item 11)", cfg.sky_seg)) if on]
        if missing:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(missing)
                + ". Run with --geom-iterations 0 --planar-prior 0 --sky-seg 0.")

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
        self._check_supported()
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

        ply = self.fuse(log=log)
        log(self.timer.summary())
        self.timer.dump_json(os.path.join(self.config.output_folder, "MPMVS",
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
                                       device=self.device)
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
