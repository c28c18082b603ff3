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
uses 11-bit fixed-point weights and OpenCV's vectorised rounding. Both are
bit-exact against cv2 (tests/test_torch_sky.py). The float upsample of the
probability uses OpenCV's sample positions in float32; cv2 differs from it
by at most a few 1e-5 there.

The weights are read by path from the JAX package's vendored file
(``mpmvs_tpu/models/weights/skyseg_fp16.npz``) without importing it;
``MPMVS_SKY_MODEL_DIR`` names another .npz or an ncnn model directory.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mpmvs_torch.models.ncnn import NcnnNet, load_ncnn, load_npz
from mpmvs_torch.ops.bilateral_cuda import bilateral_refine as _refine

Tensor = torch.Tensor

VENDORED_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "mpmvs_tpu", "models", "weights", "skyseg_fp16.npz")
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


def _sample_positions(n_in: int, n_out: int, clamp: bool):
    """OpenCV's linear-resize taps along one axis: source indices (i0, i1)
    and float32 weights (1 - f, f), from f = (float)((d + 0.5) * scale -
    0.5). Columns clamp the fraction at the borders; rows keep it and clip
    the indices (resizeGeneric_)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(np.float32)).astype(np.float32)
    if clamp:
        lo = i0 < 0
        f[lo], i0[lo] = 0.0, 0
        hi = i0 >= n_in - 1
        f[hi], i0[hi] = 0.0, n_in - 1
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return np.clip(i0, 0, n_in - 1), i1, (np.float32(1.0) - f), f


def _taps(n_in: int, n_out: int, clamp: bool, device, fixed: bool):
    i0, i1, w0, w1 = _sample_positions(n_in, n_out, clamp)
    if fixed:  # saturate_cast<short>(w * 2048): round half to even
        w0 = np.rint(w0 * np.float32(2048.0)).astype(np.int64)
        w1 = np.rint(w1 * np.float32(2048.0)).astype(np.int64)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(i0), t(i1), t(w0), t(w1)


def resize_u8(img: Tensor, out_h: int, out_w: int) -> Tensor:
    """``cv2.resize(..., INTER_LINEAR)`` of a uint8-valued (H, W, C) tensor:
    11-bit weights per axis, the row pass in integers, the column pass
    rounded as OpenCV's vector path (VResizeLinearVec_32s8u)."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _taps(w, out_w, True, img.device, True)
    y0, y1, b0, b1 = _taps(h, out_h, False, img.device, True)
    s = img.to(torch.int64)
    rows = s[:, x0] * a0[None, :, None] + s[:, x1] * a1[None, :, None]
    top = ((rows[y0] >> 4) * b0[:, None, None]) >> 16
    bot = ((rows[y1] >> 4) * b1[:, None, None]) >> 16
    return ((top + bot + 2) >> 2).clamp(0, 255).to(torch.float32)


def resize_f32(img: Tensor, out_h: int, out_w: int) -> Tensor:
    """Bilinear resize of an (H, W) float32 map at OpenCV's sample
    positions, in float32."""
    h, w = img.shape
    x0, x1, a0, a1 = _taps(w, out_w, True, img.device, False)
    y0, y1, b0, b1 = _taps(h, out_h, False, img.device, False)
    rows = img[:, x0] * a0 + img[:, x1] * a1
    return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]


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
                        prob.cpu().numpy(), rec.sky_mask)
        log(f"sky mask {s.ref_id:08d}: {rec.sky_mask.mean() * 100:.1f}% sky")


def _write_jpgs(folder: str, color: np.ndarray, prob: np.ndarray,
                mask: np.ndarray):
    import cv2

    cv2.imwrite(os.path.join(folder, "skymask.jpg"),
                (prob * 255.0).astype(np.uint8))
    cv2.imwrite(os.path.join(folder, "skymask_refine.jpg"),
                mask.astype(np.uint8) * 255)
    # green overlay (image_mask_fuse, SkyRegionDetect.cpp:462-476)
    fuse = np.asarray(color, np.uint8).copy()
    fuse[mask] = (0, 255, 0)
    cv2.imwrite(os.path.join(folder, "skymask_fuse.jpg"), fuse)
