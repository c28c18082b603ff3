"""Write the full-size lossy WebP source of ``chip_smoke.py``'s
``phase_webp_parts`` and cv2's hashes of it.

    python tests/data/webp/make_conversion.py

``conversion/plane_3200x2130.webp``: view 2 of phase 8's scene
(``chip_smoke.files_scene``: 3200x2130 plane scene, seed 1, the top fifth
sky, colours tinted) as Pillow's lossy WebP at its default quality (75;
libwebp's defaults otherwise). ``conversion/cv2.json``: the sha-256 of the
file, of ``cv2.imread``'s grey (IMREAD_GRAYSCALE) and BGR (IMREAD_COLOR)
arrays of it (numpy's ``tobytes``), and of the JAX converter's workspace
image of it, the bytes of ``cv2.imwrite(dst.jpg, cv2.imread(src))``
(mpmvs_tpu/preprocess/convert.py). The card's machine has no OpenCV, so
the script holds the card's reads to these hashes.

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


def main() -> int:
    import cv2
    from PIL import Image

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
    with open(os.path.join(OUT, "cv2.json"), "w") as out:
        json.dump(record, out, indent=1)
        out.write("\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
