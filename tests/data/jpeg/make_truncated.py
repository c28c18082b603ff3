"""Write the progressive JPEG fixtures that libjpeg-turbo reads with its
inter-block smoothing, for tests/test_torch_jpeg_smooth.py and
chip_smoke.py phases 1b and 8f, and the lossless JPEGs of a point
transform a scan.

    python tests/data/jpeg/make_truncated.py [--part fixtures|conversion|all]

``truncated/prog_<layout>_<cut>.jpg`` are progressive JPEGs cut short:
cv2.imencode's (libjpeg's simple progression; 4:2:0 at a height whose last
iMCU row holds one block row, 4:2:2, 4:4:0, 4:4:4, grey, a restart
interval) and the progressive CMYK and YCCK files under ``layouts/``
(Pillow's); ``prog_arith_<layout>_<cut>.jpg`` the same files transcoded to
arithmetic coding (``make_arith_lossless.transcode``, the simple
progression of ``jpeg_file.arithmetic_jpeg``) and then cut. Each file is cut
just before every scan after the first (``after_s<k>``: the first k scans
whole) and in the middle of every scan's entropy-coded data (``in_s<k>``).
``truncated/arith_420_stops_at_al1.jpg`` is whole, but its script stops
before the last bit of every coefficient (the simple progression's first
six scans): libjpeg smooths it although nothing is missing. Each is
checked to be read by ``cv2.imread`` from its path (``cv2.imdecode``
refuses a cut stream), and its grey and BGR arrays are added to
``truncated/cv2_arrays.npz`` beside the four sequential files there.

``lossless/rgb_scans_pts_021_p1.jpg`` and
``lossless/cmyk_scans_pts_3102_p6.jpg`` (``make_arith_lossless.LOSSLESS``)
are lossless JPEGs of a scan a component, each of its own point transform;
their arrays join ``lossless/cv2_arrays.npz``.

``--part conversion`` writes phase 8f's source,
``conversion/plane_3200x2130_progressive_cut.jpg``: cv2's BGR of
``tests/data/webp/conversion/plane_3200x2130.webp`` as cv2.imencode's
progressive 4:2:0 q90 JPEG, cut in the middle of its sixth scan's data, and
adds cv2's hashes of it (``progressive_cut``) to ``conversion/cv2.json``.
"""

import argparse
import hashlib
import json
import os
import sys
import tempfile

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import check_host_decoder  # noqa: E402
import jpeg_file as jf  # noqa: E402
import make_arith_lossless as mal  # noqa: E402

TRUNCATED = os.path.join(HERE, "truncated")
CUT_SOURCE = os.path.join(HERE, "conversion",
                          "plane_3200x2130_progressive_cut.jpg")


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth (h, w, 3) BGR picture with faint noise."""
    return np.stack([mal.plane(h, w, seed + c) for c in range(3)], -1)


def encode(img: np.ndarray, sampling=None, restart: int = 0,
           quality: int = 90) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _read(rel: str) -> bytes:
    with open(os.path.join(HERE, rel), "rb") as f:
        return f.read()


def sources() -> dict:
    """The progressive Huffman sources, by layout."""
    return {
        "420": encode(picture(37, 53, 1),
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "422": encode(picture(45, 61, 2),
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "440": encode(picture(37, 45, 3),
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        "444": encode(picture(29, 40, 4),
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "grey": encode(mal.plane(33, 47, 5)),
        "420_restart2": encode(picture(40, 56, 6),
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 2),
        "cmyk": _read("layouts/cmyk_pil_progressive.jpg"),
        "ycck": _read("layouts/ycck_pil_progressive.jpg"),
    }


def scan_starts(data: bytes):
    """The offset of each SOS marker and the end of each scan's entropy-
    coded data (the next marker other than RSTn or a stuffed byte)."""
    out, pos = [], 2
    while True:
        at = data.find(b"\xff\xda", pos)
        if at < 0:
            return out
        end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
        while not (data[end] == 0xFF and data[end + 1] not in (
                0x00, 0xFF, *range(0xD0, 0xD8))):
            end += 1
        out.append((at, at + 4 + int.from_bytes(data[at + 2:at + 4], "big")
                    - 2, end))
        pos = end


def cuts(data: bytes) -> dict:
    """``data`` cut before every scan after the first and in the middle of
    every scan's entropy-coded data."""
    out = {}
    scans = scan_starts(data)
    for k, (at, start, end) in enumerate(scans, 1):
        if k > 1:
            out[f"after_s{k - 1}"] = data[:at]
        out[f"in_s{k}"] = data[:(start + end) // 2]
    return out


def cv2_modes(path: str):
    return (cv2.imread(path, cv2.IMREAD_GRAYSCALE),
            cv2.imread(path, cv2.IMREAD_COLOR))


def write(folder: str, files: dict, arrays: dict) -> None:
    for name, data in files.items():
        path = os.path.join(folder, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        grey, bgr = cv2_modes(path)
        assert grey is not None or bgr is not None, f"cv2 refuses {path}"
        if grey is not None:
            arrays[f"gray_{name}"] = grey
        if bgr is not None:
            arrays[f"bgr_{name}"] = bgr


def stops_at_al1(lib, data: bytes) -> bytes:
    """A whole arithmetic-coded progressive JPEG of ``data``'s coefficients
    whose script is the simple progression's first six scans: every AC
    coefficient of Y stops at Al 1, of Cb and Cr at Al 1, the DC at Al 1."""
    return mal.transcode(lib, data, progressive=True,
                         scans=jf.simple_progression(3)[:6])


def write_fixtures() -> None:
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = check_host_decoder.build(tmp)
        for layout, huff in sources().items():
            arith = mal.transcode(lib, huff, progressive=True)
            for cut, data in cuts(huff).items():
                files[f"prog_{layout}_{cut}"] = data
            for cut, data in cuts(arith).items():
                files[f"prog_arith_{layout}_{cut}"] = data
        files["arith_420_stops_at_al1"] = stops_at_al1(lib,
                                                       sources()["420"])
    path = os.path.join(TRUNCATED, "cv2_arrays.npz")
    arrays = {k: v for k, v in np.load(path).items()
              if not k.split("_", 1)[1].startswith(("prog_", "arith_420_s"))}
    write(TRUNCATED, files, arrays)
    np.savez_compressed(path, **arrays)

    folder = os.path.join(HERE, "lossless")
    path = os.path.join(folder, "cv2_arrays.npz")
    arrays = dict(np.load(path))
    made = {}
    for name in ("rgb_scans_pts_021_p1", "cmyk_scans_pts_3102_p6"):
        factors, h, w, seed, kw = mal.LOSSLESS[name]
        made[name] = jf.lossless_jpeg(mal.planes_of(factors, h, w, seed),
                                      factors=factors, size=(h, w), **kw)
    write(folder, made, arrays)
    np.savez_compressed(path, **arrays)


def conversion_source() -> bytes:
    """Phase 8f's cut progressive source (see the module's doc)."""
    bgr = cv2.imread(mal.WEBP_SOURCE, cv2.IMREAD_COLOR)
    data = encode(bgr, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    _, start, end = scan_starts(data)[5]
    return data[:(start + end) // 2]


def write_conversion() -> None:
    sha = lambda b: hashlib.sha256(b).hexdigest()
    data = conversion_source()
    with open(CUT_SOURCE, "wb") as f:
        f.write(data)
    grey, bgr = cv2_modes(CUT_SOURCE)
    path = os.path.join(HERE, "conversion", "cv2.json")
    with open(path) as f:
        record = json.load(f)
    with open(mal.WEBP_SOURCE, "rb") as f:
        webp = f.read()
    record["progressive_cut"] = {
        "from": "cv2.imencode progressive 4:2:0 q90 of cv2's BGR of "
                "webp/conversion/plane_3200x2130.webp (sha-256 "
                f"{sha(webp)}), cut in the middle of its sixth scan's data",
        "source_sha256": sha(data), "gray_sha256": sha(grey.tobytes()),
        "bgr_sha256": sha(bgr.tobytes()),
        "workspace_sha256": sha(cv2.imencode(".jpg", bgr)[1].tobytes())}
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("all", "fixtures", "conversion"),
                    default="all")
    part = ap.parse_args().part
    if part in ("all", "fixtures"):
        write_fixtures()
    if part in ("all", "conversion"):
        write_conversion()


if __name__ == "__main__":
    main()
