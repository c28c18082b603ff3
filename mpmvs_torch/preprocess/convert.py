"""COLMAP dense workspace -> MVS workspace conversion.

Counterpart of ``mpmvs_tpu.preprocess.convert``, with the same arithmetic
and output bytes (``cams/*.txt``, ``pair.txt``); images go through
``io.images`` on the device the caller names:

  * a source named ``*.jpg`` is copied byte for byte, as the JAX converter
    does;
  * any other name (ETH3D's ``.JPG``, DTU's ``.png``, survey and drone
    ``.tif`` included) is read in colour and re-encoded at quality 95, as
    the JAX converter's ``cv2.imwrite(dst, cv2.imread(src))`` does, with
    the same bytes: on a CUDA device through the port's codec, which reads
    JPEG, PNG (every colour type and bit depth, Adam7) and TIFF (strips or
    tiles; uncompressed, LZW, Deflate or PackBits; grey, RGB or palette)
    and raises on anything else, naming why; on the CPU through OpenCV,
    which reads the rest too.

    mpmvs-torch-convert --dense_folder <colmap dense> --save_folder <ws>

Capability port of colmap2mvsnet_acm.py (the reference's L0 preprocessor):
per-image depth ranges from visible sparse points (1%/99% quantiles widened
x0.75/x1.25), pairwise view-selection scores (co-visible point count,
zeroed when the 75th-percentile triangulation angle < 1 deg), and the
images/cams/pair.txt output contract.

The O(N^2 * points) scoring loop — a multiprocessing.Pool of scalar Python
in the reference (colmap2mvsnet_acm.py:398-410) — is replaced by one
vectorized membership/angle computation per pair.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

from mpmvs_torch.io import images as image_io
from mpmvs_torch.preprocess.colmap import qvec_to_rotmat, read_model
from mpmvs_torch.solver import resolve_device


def compute_depth_ranges(images, points3d, extrinsics, intrinsics,
                         max_d: int = 192, interval_scale: float = 1.0):
    """Per-image (depth_min, interval, depth_num, depth_max)."""
    out = {}
    for iid, image in images.items():
        ids = [pid for pid in image.point3d_ids if pid != -1 and pid in points3d]
        if not ids:
            out[iid] = (0.1, 0.01, float(max_d), 100.0)
            continue
        xyz = np.stack([points3d[pid].xyz for pid in ids])
        E = extrinsics[iid]
        z = (xyz @ E[:3, :3].T + E[:3, 3])[:, 2]
        zs = np.sort(z)
        depth_min = zs[int(len(zs) * 0.01)] * 0.75
        depth_max = zs[int(min(len(zs) * 0.99, len(zs) - 1))] * 1.25
        if max_d == 0:
            K = intrinsics[iid]
            R, t = E[:3, :3], E[:3, 3]
            p1 = np.array([K[0, 2], K[1, 2], 1.0])
            p2 = np.array([K[0, 2] + 1.0, K[1, 2], 1.0])
            Ki = np.linalg.inv(K)
            P1 = np.linalg.inv(R) @ (Ki @ p1 * depth_min - t)
            P2 = np.linalg.inv(R) @ (Ki @ p2 * depth_min - t)
            step = np.linalg.norm(P2 - P1)
            depth_num = ((1.0 / depth_min - 1.0 / depth_max)
                         / (1.0 / depth_min - 1.0 / (depth_min + step)))
        else:
            depth_num = max_d
        interval = (depth_max - depth_min) / (depth_num - 1) / interval_scale
        out[iid] = (float(depth_min), float(interval), float(depth_num),
                    float(depth_max))
    return out


def compute_view_scores(images, points3d, extrinsics,
                        min_angle_deg: float = 1.0) -> np.ndarray:
    """(N, N) co-visibility scores with the triangulation-angle gate.

    Score(i,j) = #co-visible sparse points, zeroed when the 75th-percentile
    pairwise triangulation angle is below ``min_angle_deg``
    (calc_score, colmap2mvsnet_acm.py:280-302).
    """
    ids = sorted(images.keys())
    n = len(ids)
    centers = {}
    pt_sets = {}
    for iid in ids:
        E = extrinsics[iid]
        centers[iid] = -E[:3, :3].T @ E[:3, 3]
        pt_sets[iid] = {pid for pid in images[iid].point3d_ids
                        if pid != -1 and pid in points3d}
    score = np.zeros((n, n))
    for a in range(n):
        for b in range(a + 1, n):
            ia, ib = ids[a], ids[b]
            common = pt_sets[ia] & pt_sets[ib]
            if not common:
                continue
            xyz = np.stack([points3d[pid].xyz for pid in common])
            va = centers[ia] - xyz
            vb = centers[ib] - xyz
            cosang = (va * vb).sum(1) / (np.linalg.norm(va, axis=1)
                                         * np.linalg.norm(vb, axis=1))
            theta = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
            s = float(len(common))
            tri_angle = np.sort(theta)[int(len(theta) * 0.75)]
            if tri_angle < min_angle_deg:
                s = 0.0
            score[a, b] = score[b, a] = s
    return score


def convert_image(src: str, dst: str, device="cuda"):
    """One source image into the workspace as ``dst``: copied where its
    name ends in ``.jpg``, else read and re-encoded on ``device`` (the JAX
    converter's cv2.imwrite(dst, cv2.imread(src)))."""
    if src.endswith(".jpg"):
        shutil.copyfile(src, dst)
    else:
        image_io.write_jpeg(dst, image_io.read_colour(src, device), device,
                            quality=95)


def convert_colmap(dense_folder: str, save_folder: str, max_d: int = 192,
                   interval_scale: float = 1.0, model_ext: str = ".txt",
                   num_view: int = 20, log=print, device="cuda") -> str:
    """Produce images/, cams/, pair.txt from a COLMAP dense workspace;
    images that are not ``*.jpg`` are re-encoded on ``device`` (the card
    unless the caller names another)."""
    model_dir = os.path.join(dense_folder, "sparse")
    image_dir = os.path.join(dense_folder, "images")
    cameras, images, points3d = read_model(model_dir, model_ext)

    # renumber images 1..N by sorted original id (colmap2mvsnet_acm.py:351-354)
    images = {i + 1: images[k] for i, k in enumerate(sorted(images.keys()))}

    intrinsics = {iid: cameras[im.camera_id].K for iid, im in images.items()}
    extrinsics = {}
    for iid, im in images.items():
        E = np.eye(4)
        E[:3, :3] = qvec_to_rotmat(im.qvec)
        E[:3, 3] = im.tvec
        extrinsics[iid] = E

    depth_ranges = compute_depth_ranges(images, points3d, extrinsics,
                                        intrinsics, max_d, interval_scale)
    score = compute_view_scores(images, points3d, extrinsics)

    n = len(images)
    num_view = min(num_view, n - 1)
    view_sel = []
    for i in range(n):
        order = np.argsort(score[i])[::-1][:num_view]
        view_sel.append([(int(k), score[i, k]) for k in order])

    cam_dir = os.path.join(save_folder, "cams")
    img_out = os.path.join(save_folder, "images")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(img_out, exist_ok=True)

    for i in range(n):
        iid = i + 1
        with open(os.path.join(cam_dir, f"{i:08d}_cam.txt"), "w") as f:
            f.write("extrinsic\n")
            for r in range(4):
                f.write(" ".join(str(extrinsics[iid][r, c])
                                 for c in range(4)) + " \n")
            f.write("\nintrinsic\n")
            for r in range(3):
                f.write(" ".join(str(intrinsics[iid][r, c])
                                 for c in range(3)) + " \n")
            f.write("\n%f %f %f %f\n" % depth_ranges[iid])

    with open(os.path.join(save_folder, "pair.txt"), "w") as f:
        f.write(f"{n}\n")
        for i, pairs in enumerate(view_sel):
            f.write(f"{i}\n{len(pairs)} ")
            for vid, s in pairs:
                f.write(f"{vid} {int(s)} ")
            f.write("\n")

    for i in range(n):
        convert_image(os.path.join(image_dir, images[i + 1].name),
                      os.path.join(img_out, f"{i:08d}.jpg"), device)
    log(f"converted {n} images -> {save_folder}")
    return save_folder


def main(argv=None):
    p = argparse.ArgumentParser(description="COLMAP -> MVS workspace")
    p.add_argument("--dense_folder", required=True)
    p.add_argument("--save_folder", required=True)
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--model_ext", default=".txt", choices=[".txt", ".bin"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the image codec, e.g. cuda, cpu")
    args = p.parse_args(argv)
    os.makedirs(args.save_folder, exist_ok=True)
    convert_colmap(args.dense_folder, args.save_folder, args.max_d,
                   args.interval_scale, args.model_ext,
                   device=resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
