"""`_cam.txt` and `pair.txt` readers/writers.

File formats are those produced by ``colmap2mvsnet_acm.py`` and consumed by
the reference (ReadCamera, src/PatchMatch.cpp:111-143; GenerateSampleList,
src/PatchMatch.cpp:67-109):

_cam.txt::

    extrinsic
    r r r t      (x3 rows; a 4th 0 0 0 1 row is read and discarded)
    0 0 0 1
    intrinsic
    k k k        (x3 rows)
    depth_min interval depth_num depth_max

pair.txt::

    N
    ref_id
    num_src  src_id score  src_id score  ...
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from mpmvs_torch.camera import Camera


def read_cam_txt(path: str) -> Camera:
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)

    def skip_word(expected: str):
        word = next(it)
        if word != expected:
            raise ValueError(f"{path}: expected '{expected}', got '{word}'")

    skip_word("extrinsic")
    ext = np.array([float(next(it)) for _ in range(16)], np.float32).reshape(4, 4)
    skip_word("intrinsic")
    K = np.array([float(next(it)) for _ in range(9)], np.float32).reshape(3, 3)
    rest = [float(tok) for tok in it]
    depth_min = rest[0] if len(rest) > 0 else 0.0
    depth_max = rest[3] if len(rest) > 3 else 1.0
    return Camera.create(K=K, R=ext[:3, :3], t=ext[:3, 3], width=0, height=0,
                         depth_min=depth_min, depth_max=depth_max)


def write_cam_txt(path: str, camera: Camera, interval: float = 0.0,
                  depth_num: float = 192.0) -> None:
    K, R, t = (a.detach().cpu().numpy().astype(np.float64)
               for a in (camera.K, camera.R, camera.t))
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for i in range(3):
            f.write(f"{R[i,0]} {R[i,1]} {R[i,2]} {t[i]} \n")
        f.write("0.0 0.0 0.0 1.0 \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(f"{K[i,0]} {K[i,1]} {K[i,2]} \n")
        f.write(f"\n{float(camera.depth_min):f} {interval:f} {depth_num:f} "
                f"{float(camera.depth_max):f}\n")


@dataclasses.dataclass
class Scene:
    """One depth-map job: a reference view and its source views.

    ``src_ids[0]`` is the reference id itself, matching the reference's
    convention (PatchMatch.cpp:85).
    """

    ref_id: int
    src_ids: List[int]
    estimate: bool = True

    @property
    def num_views(self) -> int:
        return len(self.src_ids)


def read_pair_txt(path: str, max_source_images: int = 20) -> List[Scene]:
    """Parse pair.txt into a dense Scene list (GenerateSampleList semantics:
    sources with score<=0 dropped, at most ``max_source_images`` kept by
    original position, gaps in ref ids filled with estimate=False entries,
    zero-source entries marked estimate=False)."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    num_images = int(next(it))
    scenes: List[Scene] = []
    for _ in range(num_images):
        ref_id = int(next(it))
        while ref_id > len(scenes):
            scenes.append(Scene(ref_id=len(scenes), src_ids=[], estimate=False))
        num_src = int(next(it))
        src_ids = [ref_id]
        for j in range(num_src):
            sid, score = int(next(it)), float(next(it))
            if score <= 0.0:
                continue
            if j < max_source_images:
                src_ids.append(sid)
        scenes.append(Scene(ref_id=ref_id, src_ids=src_ids,
                            estimate=num_src > 0))
    return scenes


def write_pair_txt(path: str, view_sel: List[List[Tuple[int, float]]]) -> None:
    with open(path, "w") as f:
        f.write(f"{len(view_sel)}\n")
        for i, pairs in enumerate(view_sel):
            f.write(f"{i}\n{len(pairs)} ")
            for vid, score in pairs:
                f.write(f"{vid} {int(score)} ")
            f.write("\n")
