"""Sky-region masking.

Counterpart of ``mpmvs_tpu.models.sky`` (GenerateSkyRegionMask,
src/PatchMatch.cpp:4-57): pyramid-downscale the BGR image to <= 768 px, run
the segmentation net (the reference's ncnn fp16 model, as
:class:`models.ncnn.NcnnNet`), resize the probability back to working
resolution, refine it with the 37x37 joint bilateral filter guided by the
image (``ops/bilateral_cuda``: the CUDA kernel on the card) and threshold
at 0.6 (SkySegment/src/SkyRegionDetect.cu:3-35).

The JAX package pre-processes with OpenCV (``pyrDown``, ``resize`` on uint8,
``cvtColor``); the machine with the card has no OpenCV, so those steps are
written here in torch on the pipeline's device with OpenCV's integer
arithmetic: ``pyrDown`` is the 5-tap [1 4 6 4 1]/16 filter per axis with
BORDER_REFLECT_101, rounded (sum + 128) >> 8; the uint8 bilinear resize
(``ops.resize.resize_u8``, shared with the pipeline's image reads) uses
11-bit fixed-point weights and OpenCV's vectorised rounding. Both are
bit-exact against cv2 (tests/test_torch_sky.py). The float upsample of the
probability (``ops.resize.resize_f32``) uses OpenCV's sample positions in
float32; cv2 differs from it by at most a few 1e-5 there.

The weights are the port's own copy (``models/weights/skyseg_fp16.npz``,
the same bytes as the JAX package's vendored file);
``MPMVS_SKY_MODEL_DIR`` names another .npz or an ncnn model directory.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mpmvs_torch.io import images
from mpmvs_torch.models.ncnn import NcnnNet, load_ncnn, load_npz
from mpmvs_torch.ops.bilateral_cuda import bilateral_refine as _refine
from mpmvs_torch.ops.resize import resize_f32, resize_u8

Tensor = torch.Tensor

VENDORED_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "weights", "skyseg_fp16.npz")
PARAM_NAME = "skysegsmall_sim-opt-fp16.param"
BIN_NAME = "skysegsmall_sim-opt-fp16.bin"
NET_SIZE = 384
MAX_SIDE = 768
THRESHOLD = 0.6

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def default_model_dir() -> str:
    """``MPMVS_SKY_MODEL_DIR`` if set, else the vendored .npz."""
    return os.environ.get("MPMVS_SKY_MODEL_DIR", VENDORED_NPZ)


def sky_model_available(model_dir: str = None) -> bool:
    model_dir = model_dir or default_model_dir()
    if model_dir.endswith(".npz"):
        return os.path.exists(model_dir) or os.path.exists(VENDORED_NPZ)
    return (os.path.exists(os.path.join(model_dir, PARAM_NAME))
            and os.path.exists(os.path.join(model_dir, BIN_NAME)))


def load_sky_net(model_dir: str = None, device="cuda") -> NcnnNet:
    """The sky net with its weights on ``device`` (the card unless the
    caller names another), in eval mode."""
    model_dir = model_dir or default_model_dir()
    if model_dir.endswith(".npz"):
        path = model_dir if os.path.exists(model_dir) else VENDORED_NPZ
        layers = load_npz(path)
    else:
        layers = load_ncnn(os.path.join(model_dir, PARAM_NAME),
                           os.path.join(model_dir, BIN_NAME))
    return NcnnNet(layers, "input.1", "1959").to(device).eval()


def pyr_down(img: Tensor) -> Tensor:
    """``cv2.pyrDown`` of a uint8-valued (H, W, C) float tensor: 5-tap
    Gaussian per axis, BORDER_REFLECT_101, output ((H+1)//2, (W+1)//2),
    rounded as OpenCV's (sum + 128) >> 8. Exact in float32 (sums < 2^16)."""
    C = img.shape[2]
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=img.device)
    x = F.pad(img.permute(2, 0, 1)[None], (2, 2, 2, 2), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 1, 5).repeat(C, 1, 1, 1), stride=(1, 2),
                 groups=C)
    x = F.conv2d(x, k.view(1, 1, 5, 1).repeat(C, 1, 1, 1), stride=(2, 1),
                 groups=C)
    return torch.floor((x[0] + 128.0) / 256.0).permute(1, 2, 0)


def net_input(bgr: Tensor) -> Tensor:
    """SkySegment::maskExtractor's pre-processing (SkyRegionDetect.cpp:
    626-640): uint8 cast, pyrDown while both sides exceed 768, resize to
    384x384, BGR -> RGB, ImageNet normalisation; (3, 384, 384)."""
    dst = torch.floor(bgr.clamp(0.0, 255.0))  # np.asarray(bgr, np.uint8)
    while dst.shape[0] > MAX_SIDE and dst.shape[1] > MAX_SIDE:
        dst = pyr_down(dst)
    rgb = resize_u8(dst, NET_SIZE, NET_SIZE).flip(-1)
    mean = torch.as_tensor(_IMAGENET_MEAN, device=bgr.device)
    std = torch.as_tensor(_IMAGENET_STD, device=bgr.device)
    return ((rgb - mean) / std).permute(2, 0, 1).contiguous()


@torch.no_grad()
def segment_sky(bgr: Tensor, net: NcnnNet) -> Tensor:
    """(H, W, 3) BGR float tensor -> (H, W) sky probability, on the
    tensor's device (the net must be there too)."""
    prob = net(net_input(bgr))[0]
    return resize_f32(prob, bgr.shape[0], bgr.shape[1])


def bilateral_refine(bgr: Tensor, prob: Tensor,
                     threshold: float = THRESHOLD) -> Tensor:
    """Joint bilateral refinement + threshold -> bool mask (sky.py:85-88
    of the JAX package: 37x37 window, sigma_spatial 72, sigma_color 8)."""
    return _refine(bgr.float(), prob.float()) > threshold


def sky_mask(bgr: Tensor, net: NcnnNet) -> Tuple[Tensor, Tensor]:
    """(probability, refined bool mask) of one view."""
    prob = segment_sky(bgr, net)
    return prob, bilateral_refine(bgr, prob)


def generate_sky_masks(pipeline, log=print, model_dir: str = None):
    """Compute and store the refined sky mask of every estimated view
    (``ViewRecord.sky_mask``, numpy bool); with ``pipeline.write_jpg`` also
    skymask.jpg, skymask_refine.jpg and skymask_fuse.jpg beside the view's
    results (GenerateSkyRegionMask, PatchMatch.cpp:36-54)."""
    if not sky_model_available(model_dir):
        log("sky segmentation model not found — skipping sky masks")
        return
    net = load_sky_net(model_dir, pipeline.device)
    for s in pipeline.scenes:
        if not s.estimate:
            continue
        rec = pipeline.views[s.ref_id]
        bgr = torch.as_tensor(rec.color, dtype=torch.float32,
                              device=pipeline.device)
        prob, mask = sky_mask(bgr, net)
        rec.sky_mask = mask.cpu().numpy()
        if pipeline.write_jpg:
            _write_jpgs(pipeline.result_dir(s.ref_id), rec.color,
                        prob.cpu().numpy(), rec.sky_mask, pipeline.device)
        log(f"sky mask {s.ref_id:08d}: {rec.sky_mask.mean() * 100:.1f}% sky")


def _write_jpgs(folder: str, color: np.ndarray, prob: np.ndarray,
                mask: np.ndarray, device):
    """The three previews, encoded on ``device`` (``io.images``)."""
    write = lambda name, img: images.write_jpeg(os.path.join(folder, name),
                                                img, device)
    write("skymask.jpg", (prob * 255.0).astype(np.uint8))
    write("skymask_refine.jpg", mask.astype(np.uint8) * 255)
    # green overlay (image_mask_fuse, SkyRegionDetect.cpp:462-476)
    fuse = np.asarray(color, np.uint8).copy()
    fuse[mask] = (0, 255, 0)
    write("skymask_fuse.jpg", fuse)
