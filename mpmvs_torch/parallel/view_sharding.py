"""View-parallel solving: the views of a workspace over the ranks of a group.

Counterpart of ``mpmvs_tpu.parallel.view_sharding`` (and of the per-process
half of ``multihost.MultiHostPipeline``). The reference solves its views one
after another on one GPU (main.cpp:21-26); the JAX package makes the views
a batch axis sharded over a device mesh. Here each rank (one process, one
card) solves its slot of the views (``mesh.view_slots``) one after another
with ``solver.solve_view``; the only coupling between views is a geometric
pass's read of the sources' depth maps, which becomes one all-gather of
every rank's depth maps over the data group (NCCL) per geometric pass.

The semantics are the JAX package's sharded ones, not the serial
``Pipeline``'s, and do not depend on the number of ranks:

  * keys: per pass ``key, sub = split(key)``, then ``split(fold_in(sub,
    tag), N)`` with tag 2 pass for the solve and 2 pass + 1 for the prior
    sub-run (view_sharding.py:203-205); view i takes key i, and with the
    partitionable threefry key i does not depend on N;
  * Jacobi geometric passes: every source's depth comes from the previous
    pass (view_sharding.py:219-224), where the serial pipeline reads the
    depths earlier views of the pass already updated;
  * padding: every view is solved on the batch's uniform (V, H, W), missing
    sources as zero-extent dummy cameras (always off the view: cost 2.0),
    and the padded results carry from pass to pass; what is stored is
    cropped (view_sharding.py:88-101, 126-135);
  * the prior sub-run re-solves only the views that have a prior; each
    rank builds its views' priors on the host (multihost._prior_subrun_mh);
  * a source that is not estimated reads an all-zero depth map, as the
    reference reads a missing ``.dmb`` (the JAX package reads the
    reference's own map there: a fault not carried over).

Each rank writes its views' ``.dmb`` checkpoints; rank 0 keeps the pass
manifest after a barrier, so ``resume`` skips completed passes. The final
results are gathered to rank 0 (no shared filesystem needed), which runs
the sky masks and fusion while the others wait at the control group's
barrier. Each rank writes ``MPMVS/rank_<r>.json``: its views, pass wall
times, prior-build seconds, the bytes and milliseconds of every
collective, the solve log and its kernels' launches.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpmvs_torch.camera import Camera, CameraStack
from mpmvs_torch.io import images as image_io
from mpmvs_torch.models.sky import generate_sky_masks
from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.parallel import mesh
from mpmvs_torch.pipeline import (Pipeline, _crop_result, _np, _pad_result,
                                  _pad_stack)
from mpmvs_torch.prior import build_planar_prior, draw_triangulation
from mpmvs_torch.solver import SolveResult
from mpmvs_torch.utils.trace import device_sync

Tensor = torch.Tensor


@dataclasses.dataclass
class SceneBatch:
    """The estimated views of a pipeline as one uniformly padded batch.

    The JAX package stacks every view's images into one (N, V, H, W)
    array; here a view's padded stack is built when its rank solves it
    (``scene_inputs``), so no rank holds the whole batch."""

    ref_ids: List[int]
    stacks: List[List[int]]     # per view: the view ids of its stack
    src_indices: np.ndarray     # (N, V-1) batch index of each source's depth
    shape: Tuple[int, int, int]  # (V, H, W)
    orig_sizes: List[Tuple[int, int]]

    def scene_inputs(self, pipeline: Pipeline, i: int,
                     device) -> Tuple[Tensor, CameraStack]:
        """View i's (V, H, W) image stack (reference first, zero-padded;
        dummy sources all zeros) and cameras (dummies of zero extent)."""
        V, H, W = self.shape
        recs = [pipeline.views[v] for v in self.stacks[i]]
        images = np.zeros((V, H, W), np.float32)
        images[:len(recs)] = _pad_stack([r.image for r in recs], (H, W))
        cams = [r.camera for r in recs]
        cams += [Camera.create(K=np.eye(3), R=np.eye(3), t=np.zeros(3),
                               width=0, height=0)] * (V - len(recs))
        return (torch.as_tensor(images, device=device),
                CameraStack.stack(cams).to(device))


def build_scene_batch(pipeline: Pipeline) -> SceneBatch:
    """``mpmvs_tpu.parallel.view_sharding.build_scene_batch`` without the
    image stacks: V is the longest stack, (H, W) the largest image of any
    stack. A missing source slot (a dummy) takes the view's own batch index
    as in the JAX package (its fetches land on the previous source's map
    and a dummy never scores); a source that is not estimated takes index
    N, the all-zero map that ``gather_depth_table`` appends."""
    scenes = [s for s in pipeline.scenes if s.estimate]
    N = len(scenes)
    id2batch = {s.ref_id: i for i, s in enumerate(scenes)}
    V = max(len(s.src_ids) for s in scenes)
    H = max(pipeline.views[v].image.shape[0]
            for s in scenes for v in s.src_ids)
    W = max(pipeline.views[v].image.shape[1]
            for s in scenes for v in s.src_ids)
    src_idx = []
    for i, s in enumerate(scenes):
        sidx = [id2batch.get(v, N) for v in s.src_ids[1:]]
        src_idx.append(sidx + [i] * (V - 1 - len(sidx)))
    return SceneBatch(ref_ids=[s.ref_id for s in scenes],
                      stacks=[list(s.src_ids) for s in scenes],
                      src_indices=np.asarray(src_idx, np.int64),
                      shape=(V, H, W),
                      orig_sizes=[tuple(pipeline.views[s.ref_id].image.shape)
                                  for s in scenes])


def gather_depth_table(group: mesh.RankGroup, depths: Sequence[Tensor],
                       slots: List[List[int]], shape: Tuple[int, int]
                       ) -> Tensor:
    """Every rank's padded ``shape`` depth maps (``depths``, this rank's
    slot in order) as one (N + 1, H, W) table in batch order, over the data
    group, with the all-zero map at index N."""
    H, W = shape
    items = mesh.all_gather_items(group, slots, [(d,) for d in depths],
                                  [((H, W), torch.float32)])
    zero = torch.zeros((1, H, W), dtype=torch.float32, device=group.device)
    return torch.cat([torch.stack([d for (d,) in items]), zero])


def gather_src_depths(table: Tensor, src_indices) -> Tensor:
    """(N + 1, H, W) table + (..., S) batch indices -> (..., S, H, W): the
    sources' depth maps of a geometric pass (the JAX package's cross-shard
    ``jnp.take``, view_sharding.py:63-70)."""
    idx = torch.as_tensor(np.asarray(src_indices), dtype=torch.int64,
                          device=table.device)
    return table.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


def _launch_counts() -> Dict[str, int]:
    """Kernel launches and plain calls of this process so far, by
    counter."""
    from mpmvs_torch.io import images
    from mpmvs_torch.ops import bilateral_cuda, ncc_cuda, ncc_sorted

    counters = {"ncc_eval": ncc_cuda.COUNTS, "ncc_sorted": ncc_sorted.COUNTS,
                "ncc_keys": ncc_sorted.KEY_COUNTS,
                "bilateral": bilateral_cuda.COUNTS,
                "bilateral_table": bilateral_cuda.TABLE_COUNTS,
                "ycc_to_bgr": images.COUNTS, "idct": images.IDCT_COUNTS,
                "bgr_to_ycc": images.YCC_COUNTS, "fdct": images.FDCT_COUNTS}
    out = {}
    for name, c in counters.items():
        out[name] = c.kernel
        out[f"{name}_plain"] = c.plain
    return out


def _result_spec(H: int, W: int) -> mesh.Spec:
    """The leaves of a padded SolveResult (depth, normal, cost, geometric
    cost)."""
    return [((H, W), torch.float32), ((H, W, 3), torch.float32),
            ((H, W), torch.float32), ((H, W), torch.float32)]


class ShardedPipeline(Pipeline):
    """The pipeline of one rank of ``group``: its slot of the views, solved
    pass by pass with the JAX package's sharded semantics (module
    docstring), on ``group.device``."""

    def __init__(self, config, params=None, group: mesh.RankGroup = None,
                 write_jpg: bool = True):
        if group is None:
            raise ValueError("ShardedPipeline needs a parallel.mesh.RankGroup")
        super().__init__(config, params, device=group.device,
                         write_jpg=write_jpg)
        self.group = group
        self.pass_log: List[dict] = []
        self.comm_log: List[dict] = []

    def _pass_keys(self, tag: int, n: int) -> Tensor:
        """(n, 2) keys of one pass's solves (view_sharding.py:203-205)."""
        keys = tf.split(self.key)
        self.key = keys[0]
        return tf.split(tf.fold_in(keys[1], tag), n)

    def _collective(self, op: str, tag: str, fn, nbytes: int):
        """Run a collective after a control barrier; log its wait (rank
        skew) and its own milliseconds on this rank."""
        g = self.group
        device_sync(self.device)
        t0 = time.perf_counter()
        mesh.barrier(g)
        t1 = time.perf_counter()
        with self.timer.span(op):
            out = fn()
            device_sync(self.device)
        t2 = time.perf_counter()
        self.comm_log.append({"op": op, "pass": tag, "bytes": nbytes,
                              "ms": (t2 - t1) * 1e3,
                              "wait_ms": (t1 - t0) * 1e3})
        return out

    def _resume_skip(self, resume: bool, batch: SceneBatch,
                     mine: List[int]) -> int:
        """Completed passes to skip, agreed by every rank: rank 0 reads the
        manifest, each rank loads its views' checkpoints, and the skip
        holds only if every rank loaded all of them."""
        g = self.group
        skip = 0
        if resume and g.rank == 0:
            done = self.completed_passes()
            for tag, _, _ in self.pass_schedule():
                if tag not in done:
                    break
                skip += 1
        skip = mesh.all_gather_object(g, skip)[0]
        if skip:
            ok = all(self.load_view_result(batch.ref_ids[i]) for i in mine)
            if not all(mesh.all_gather_object(g, ok)):
                skip = 0
        if skip == 0 and g.rank == 0 and os.path.exists(
                self._manifest_path()):
            os.remove(self._manifest_path())
        return skip

    def _prior_subrun(self, vid: int, hw: Tuple[int, int], res: SolveResult,
                      images: Tensor, cams: CameraStack, key: Tensor,
                      geom: bool, src_d: Optional[Tensor],
                      log) -> Tuple[SolveResult, bool]:
        """One view's planar prior, built on the host, and its
        prior-regularised re-solve (view_sharding.py:149-193); without a
        prior the view keeps ``res``."""
        h, w = hw
        _, H, W = images.shape
        cam = self.views[vid].camera
        t0 = time.perf_counter()
        with self.timer.span("prior_build"):
            pr = build_planar_prior(
                _np(res.depth[:h, :w]), _np(res.cost[:h, :w]), _np(cam.K),
                float(cam.depth_min) * 0.6, float(cam.depth_max) * 1.2,
                geom_cost=_np(res.geom_cost[:h, :w]) if geom else None,
                device=self.device)
        self.solve_log.append((vid, "prior_build", time.perf_counter() - t0))
        if pr is None:
            log(f"view {vid:08d}: too few prior seeds, no prior sub-run")
            return res, False
        if self.write_jpg:
            image_io.write_png(os.path.join(self.result_dir(vid),
                                            "triangulation.png"),
                               draw_triangulation(self.views[vid].image, pr,
                                                  self.device))
        if self.config.save_prior_dmb:
            self._save_prior(vid, pr, (h, w))
        planes = torch.zeros((H, W, 4), device=self.device)
        planes[:h, :w] = torch.as_tensor(pr.planes, device=self.device)
        mask = torch.zeros((H, W), dtype=torch.bool, device=self.device)
        mask[:h, :w] = torch.as_tensor(pr.mask, device=self.device)
        geom_prior = geom and self.config.geom_prior_consistency
        res = self._solve(vid, "geom_prior" if geom_prior else "prior",
                          images, cams, key=key, warm=res,
                          src_depths=src_d if geom_prior else None,
                          prior_planes=planes, prior_mask=mask)
        return res, True

    def run(self, log=print, resume: bool = False) -> Optional[str]:
        """Solve this rank's views through the schedule; on rank 0 also
        the sky masks and fusion. Returns the PLY's path on rank 0, None on
        the others."""
        g, cfg = self.group, self.config
        plog = lambda msg: log(f"[rank {g.rank}/{g.size}] {msg}")
        counts0 = _launch_counts()
        if not self.scenes:
            self.load()
        batch = build_scene_batch(self)
        N = len(batch.ref_ids)
        _, H, W = batch.shape
        slots = mesh.view_slots(N, g.size)
        mine = slots[g.rank]
        plog(f"{N} views over {g.size} ranks ({g.backend}); views "
             f"{[batch.ref_ids[i] for i in mine]} on {self.device}")

        skip = self._resume_skip(resume, batch, mine)
        res: Dict[int, SolveResult] = {}
        if skip:
            plog(f"resume: skipping {skip} completed pass(es)")
            for i in mine:
                res[i] = _pad_result(self.views[batch.ref_ids[i]].result, H,
                                     W)
        mesh.barrier(g)

        for pi, (tag, geom, prior) in enumerate(self.pass_schedule()):
            if pi < skip:
                continue
            t_pass = time.perf_counter()
            n_log = len(self.solve_log)
            keys = self._pass_keys(2 * pi, N)
            table = None
            if geom:
                table = self._collective(
                    "depth_all_gather", tag,
                    lambda: gather_depth_table(
                        g, [res[i].depth for i in mine], slots, (H, W)),
                    N * H * W * 4)
            prior_keys = self._pass_keys(2 * pi + 1, N) if prior else None
            had_prior = []
            for i in mine:
                vid = batch.ref_ids[i]
                t0 = time.perf_counter()
                images, cams = batch.scene_inputs(self, i, self.device)
                src_d = (gather_src_depths(table, batch.src_indices[i])
                         if geom else None)
                if geom:
                    res[i] = self._solve(vid, "geom", images, cams,
                                         key=keys[i], warm=res[i],
                                         src_depths=src_d)
                else:
                    res[i] = self._solve(vid, "photometric", images, cams,
                                         key=keys[i])
                if prior:
                    res[i], had = self._prior_subrun(
                        vid, batch.orig_sizes[i], res[i], images, cams,
                        prior_keys[i], geom, src_d, plog)
                    if had:
                        had_prior.append(i)
                plog(f"view {vid:08d}: geom={geom} prior={prior} "
                     f"{time.perf_counter() - t0:.1f}s")
                del images, cams, src_d
            del table
            if prior:
                n_prior = sum(len(h) for h in
                              mesh.all_gather_object(g, had_prior))
                if g.rank == 0:
                    plog(f"prior sub-run: {n_prior}/{N} views triangulated")
            for i in mine:
                vid = batch.ref_ids[i]
                self.views[vid].result = _crop_result(res[i],
                                                      *batch.orig_sizes[i])
                with self.timer.span("checkpoint"):
                    self.save_view(vid)
            mesh.barrier(g)
            if g.rank == 0:
                self._mark_pass_done(tag)
            self.pass_log.append({
                "pass": tag, "wall_s": time.perf_counter() - t_pass,
                "prior_build_s": sum(s for _, st, s in self.solve_log[n_log:]
                                     if st == "prior_build")})
            if g.rank == 0:
                plog(f"pass {tag} done")

        spec = _result_spec(H, W)
        full = self._collective(
            "result_gather", "final",
            lambda: mesh.gather_items_to_root(
                g, slots, [tuple(res[i]) for i in mine], spec),
            N * mesh.item_bytes(spec))
        ply = None
        if g.rank == 0:
            for i, vid in enumerate(batch.ref_ids):
                self.views[vid].result = _crop_result(
                    SolveResult(*full[i]), *batch.orig_sizes[i])
            del full
            if cfg.sky_seg:
                with self.timer.span("sky_masks"):
                    generate_sky_masks(self, log=plog)
                    device_sync(self.device)
            ply = self.fuse(log=plog)
            plog(self.timer.summary())
            self.timer.dump_json(os.path.join(cfg.output_folder, "MPMVS",
                                              "timing.json"))
        counts1 = _launch_counts()
        self._write_rank_record(batch, mine, {
            k: counts1[k] - counts0[k] for k in counts1})
        mesh.barrier(g)
        return ply

    def _write_rank_record(self, batch: SceneBatch, mine: List[int],
                           launches: Dict[str, int]):
        g = self.group
        path = os.path.join(self.config.output_folder, "MPMVS",
                            f"rank_{g.rank}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"rank": g.rank, "size": g.size, "backend": g.backend,
                       "device": str(self.device),
                       "views": [batch.ref_ids[i] for i in mine],
                       "batch_shape": list(batch.shape),
                       "passes": self.pass_log, "collectives": self.comm_log,
                       "stages": self.timer.as_dict(),
                       "solve_log": self.solve_log, "launches": launches},
                      f, indent=1)


def _run_rank(group: mesh.RankGroup, config, params, resume: bool,
              write_jpg: bool):
    """The work of one spawned rank (``launch``)."""
    pipe = ShardedPipeline(config, params, group=group, write_jpg=write_jpg)
    ply = pipe.run(log=lambda msg: print(msg, flush=True), resume=resume)
    if ply:
        print(f"point cloud: {ply}", flush=True)


def launch(config, params=None, world_size: Optional[int] = None,
           device_type: str = "cuda",
           device_ids: Optional[Sequence[int]] = None, resume: bool = False,
           write_jpg: bool = True) -> str:
    """Run the sharded pipeline in one new process per rank on this host:
    one per card of ``device_ids`` over NCCL, or ``world_size`` ranks on
    the CPU over gloo with ``device_type="cpu"``. Returns the PLY's path
    once every rank has finished; a rank that fails raises here."""
    if device_type == "cuda":
        device_ids = list(device_ids if device_ids is not None
                          else range(world_size))
        world_size = len(device_ids)
    mesh.spawn(_run_rank, (config, params, resume, write_jpg), world_size,
               device_type, device_ids)
    ply = os.path.join(config.output_folder, "MPMVS", "MPMVS_model.ply")
    if not os.path.exists(ply):
        raise RuntimeError(f"the sharded run wrote no {ply}")
    return ply
