"""Write the full-size WebP sources of ``chip_smoke.py``'s
``phase_webp_parts`` (lossy) and ``phase_lossless_parts`` (lossless) and
cv2's hashes of them.

    python tests/data/webp/make_conversion.py [--part lossy|lossless|all]

``conversion/plane_3200x2130.webp``: view 2 of phase 8's scene
(``chip_smoke.files_scene``: 3200x2130 plane scene, seed 1, the top fifth
sky, colours tinted) as Pillow's lossy WebP at its default quality (75;
libwebp's defaults otherwise). ``conversion/cv2.json``: the sha-256 of the
file, of ``cv2.imread``'s grey (IMREAD_GRAYSCALE) and BGR (IMREAD_COLOR)
arrays of it (numpy's ``tobytes``), and of the JAX converter's workspace
image of it, the bytes of ``cv2.imwrite(dst.jpg, cv2.imread(src))``
(mpmvs_tpu/preprocess/convert.py). The card's machine has no OpenCV, so
the script holds the card's reads to these hashes.

``conversion/plane_3200x2130_lossless.webp`` (``--part lossless`` writes
only it, from the committed lossy file): the lossy source as cv2 reads
it, re-encoded lossless by Pillow at its default effort (quality 80,
method 4: subtract green, a predictor and a cross-colour transform of
blocks of 32, a colour cache, meta prefix codes); its hashes go into
``cv2.json`` under ``lossless``, the same four.

Needs OpenCV and Pillow; the scene takes about a minute on one CPU.
"""

import hashlib
import importlib.util
import io
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
OUT = os.path.join(HERE, "conversion")
VIEW = 2


def _hashes(path: str, data: bytes) -> dict:
    """cv2's sha-256 of the file, its grey and BGR reads and the JAX
    converter's workspace image of it."""
    import cv2

    sha = lambda b: hashlib.sha256(b).hexdigest()
    grey = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    colour = cv2.imread(path, cv2.IMREAD_COLOR)
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "00000000.jpg")
        cv2.imwrite(dst, cv2.imread(path))
        with open(dst, "rb") as jpg:
            workspace = jpg.read()
    return {"source_sha256": sha(data), "gray_sha256": sha(grey.tobytes()),
            "bgr_sha256": sha(colour.tobytes()),
            "workspace_sha256": sha(workspace), "shape": list(colour.shape)}


def lossless() -> dict:
    """Write the lossless source from the committed lossy one; its
    record."""
    import cv2
    from PIL import Image

    bgr = cv2.imread(os.path.join(OUT, "plane_3200x2130.webp"))
    f = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(
        f, "WEBP", lossless=True, quality=80, method=4)
    data = f.getvalue()
    path = os.path.join(OUT, "plane_3200x2130_lossless.webp")
    with open(path, "wb") as out:
        out.write(data)
    record = _hashes(path, data)
    if record["bgr_sha256"] != hashlib.sha256(bgr.tobytes()).hexdigest():
        raise AssertionError("the lossless source does not read back to the "
                             "lossy one's pixels")
    return dict(record, effort="Pillow lossless, quality 80, method 4")


def main(argv=None) -> int:
    import argparse

    import cv2
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("lossy", "lossless", "all"),
                    default="all")
    args = ap.parse_args(argv)
    if args.part == "lossless":
        with open(os.path.join(OUT, "cv2.json")) as f:
            record = json.load(f)
        record["lossless"] = lossless()
        with open(os.path.join(OUT, "cv2.json"), "w") as out:
            json.dump(record, out, indent=1)
            out.write("\n")
        print(json.dumps(record["lossless"]))
        return 0
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, bgr = smoke.files_scene()
    f = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[VIEW][..., ::-1])).save(
        f, "WEBP", quality=75)
    data = f.getvalue()
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "plane_3200x2130.webp")
    with open(path, "wb") as out:
        out.write(data)
    sha = lambda b: hashlib.sha256(b).hexdigest()
    grey = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    colour = cv2.imread(path, cv2.IMREAD_COLOR)
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "00000000.jpg")
        cv2.imwrite(dst, cv2.imread(path))
        with open(dst, "rb") as jpg:
            workspace = jpg.read()
    record = {"source_sha256": sha(data), "gray_sha256": sha(grey.tobytes()),
              "bgr_sha256": sha(colour.tobytes()),
              "workspace_sha256": sha(workspace), "view": VIEW,
              "shape": list(colour.shape), "quality": 75}
    if args.part == "all":
        record["lossless"] = lossless()
    with open(os.path.join(OUT, "cv2.json"), "w") as out:
        json.dump(record, out, indent=1)
        out.write("\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
