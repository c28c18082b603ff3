"""Write the YCCK source of chip_smoke.py's phase 8 on a CUDA card.

    python tests/data/jpeg/make_ycck_source.py OUT.jpg

Phase 8's YCCK view (``chip_smoke.files_scene``: 3200x2130, seed 1) as a
YCCK JPEG (:func:`ycck_source`: four non-interleaved scans, each the card
encoder's grey JPEG of a plane, whose bytes are cv2.imencode's). The file is
committed as ``conversion/ycck_3200x2130.jpg``, and
``make_fixtures.py`` records what cv2 makes of it (``conversion/cv2.json``).
It runs where the card is, not on the machine with OpenCV, because the
scene is made there.
"""

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402
from jpeg_file import adobe_app14, scans_jpeg  # noqa: E402
from mpmvs_torch.io import images  # noqa: E402


def ycck_source(bgr, dev) -> bytes:
    """A YCCK JPEG (Adobe transform 2) of a BGR image, as Photoshop-style
    CMYK stores one: Y, Cb, Cr of the inverted colours at 2x2 and 1x1, 1x1
    (2x2 means, libjpeg's h2v2_downsample rounding) and K = 255 at 2x2, so
    that libjpeg's YCCK -> CMYK and OpenCV's CMYK -> BGR give the colours
    back (within 1) before the JPEG loss. Coded as four non-interleaved
    scans, each the scan of the card encoder's grey JPEG of the plane
    (cv2.imencode's bytes), at quality 90 (jpeg_file.scans_jpeg)."""
    x = 255 - torch.as_tensor(bgr, device=dev).to(torch.int64)
    y, cb, cr = images._ycc_of(x[..., 2], x[..., 1], x[..., 0])
    H, W = y.shape
    half = []
    for p in (cb, cr):  # libjpeg's h2v2_downsample, edges replicated
        p = torch.nn.functional.pad(p[None, None].double(), (
            0, W % 2, 0, H % 2), mode="replicate")[0, 0].long()
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        bias = torch.tensor([1, 2], device=dev).repeat(s.shape[1] // 2 + 1)
        half.append((s + bias[:s.shape[1]]) >> 2)
    k = torch.full_like(y, 255)
    planes = [p.to(torch.uint8) for p in (y, *half, k)]
    greys = [images.encode_jpeg(p, dev, 90) for p in planes]
    return scans_jpeg(greys, [(2, 2), (1, 1), (1, 1), (2, 2)], (H, W),
                      pre=adobe_app14(2))


def main() -> int:
    out = sys.argv[1]
    _, bgr = chip_smoke.files_scene()
    v = chip_smoke.FILES_SOURCES.index("ycck")
    data = ycck_source(bgr[v], torch.device("cuda", 0))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "wb") as f:
        f.write(data)
    print(f"view {v}: {len(data)} bytes to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
