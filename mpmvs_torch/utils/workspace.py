"""Write a synthetic scene as an on-disk dense workspace.

Produces the exact input contract the reference consumes (images/%08d.jpg,
cams/%08d_cam.txt, pair.txt — colmap2mvsnet_acm.py:418-451), so the
pipeline/CLI can be exercised end-to-end without COLMAP or datasets.
"""

from __future__ import annotations

import os

import numpy as np

from mpmvs_torch.io.cams import write_cam_txt, write_pair_txt
from mpmvs_torch.utils.synthetic import SyntheticScene


def write_workspace(scene: SyntheticScene, folder: str) -> str:
    import cv2
    os.makedirs(os.path.join(folder, "images"), exist_ok=True)
    os.makedirs(os.path.join(folder, "cams"), exist_ok=True)
    V = scene.images.shape[0]
    for v in range(V):
        # PNG under a .jpg name would also load, but keep honest JPEGs at
        # max quality so NCC still matches across views.
        cv2.imwrite(os.path.join(folder, "images", f"{v:08d}.jpg"),
                    scene.images[v].astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 100])
        write_cam_txt(os.path.join(folder, "cams", f"{v:08d}_cam.txt"),
                      scene.cameras.view(v))
    view_sel = [[(j, 10.0) for j in range(V) if j != i] for i in range(V)]
    write_pair_txt(os.path.join(folder, "pair.txt"), view_sel)
    return folder
