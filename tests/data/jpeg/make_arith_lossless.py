"""Write the arithmetic-coded and lossless JPEG fixtures of
tests/test_torch_jpeg_arith.py, tests/test_torch_jpeg_lossless.py and
chip_smoke.py phases 1b and 8e.

    python tests/data/jpeg/make_arith_lossless.py [--part fixtures|conversion|all]

``arith/`` holds arithmetic-coded transcodes of the Huffman fixtures beside
this file (``jpeg_file.arithmetic_jpeg``, a port of libjpeg-turbo's
jcarith.c, fed the coefficients the host decoder leaves, as ``jpegtran
-arithmetic`` transcodes): 4:2:0, 4:2:2, 4:4:4 and grey, sequential
(SOF9) and progressive (SOF10, libjpeg's simple progression), restart
intervals (one with a fill byte 0xFF before each RSTn marker,
``fill_restart3_420``), conditioning other than the defaults (a DAC
segment), CMYK and
YCCK, EXIF orientations and 4:2:0 images 1 to 4 pixels wide; and
``patched_sof9`` (420_q95 with its SOF0 marker made SOF9, the file once
``refused/arithmetic.jpg``: Huffman data read as arithmetic-coded, which
cv2 reads with "Corrupt JPEG data" warnings). Each transcode is checked
here: cv2 reads it equal to its Huffman original, grey and BGR, which holds
the encoder to libjpeg.

``lossless/`` holds lossless JPEGs (SOF3; ``jpeg_file.lossless_jpeg``) of
smooth planes made from seeds: predictors 1-7, point transforms 0 and above,
precisions 2-8, restarts every 1-3 MCU rows, grey, RGB (ids 1, 2, 3; 'R',
'G', 'B'; other ids; an Adobe transform 0) and CMYK (no marker, Adobe 0, a
JFIF marker), sampling factors other than 1 x 1, odd sizes down to 1 x 1,
EXIF orientations, a scan a component (with a restart inside libjpeg's
iMCU row of a component at 1x2, which cv2 reads otherwise than T.81
predicts), and a stream cut short (cv2.imread feeds zeros past the
file's end). ``lossless/refused/`` holds what cv2 refuses in both modes:
JFIF and Adobe 1 or 2 on three components, Adobe 1 or 2 on four, 1-, 12- and
16-bit samples, a point transform equal to the precision, a restart
interval of part of a row, two components and a stream cut inside its
header.

``truncated/`` holds sequential JPEGs cut short, Huffman (420_q95 and
odd_101x203_q95, libjpeg's insufficient-data rule: once a read goes past
the data, the scan's later MCUs stay zero) and arithmetic-coded (zeros fed
past the data).

``refused/`` (beside this file) gains ``arithmetic_lossless`` (a true SOF11
stream, ``jpeg_file.sof11_constant``) and ``hierarchical`` (DHP, SOF9, EXP,
SOF13: ``jpeg_file.hierarchical_jpeg``), which cv2 refuses too.

Each folder's ``cv2_arrays.npz`` holds ``cv2.imread``'s arrays of each file
in each mode cv2 reads it (``gray_<name>``, ``bgr_<name>``; a grey lossless
file has no BGR, an RGB one no grey). Every file is read by cv2.imread from
its path, as the JAX package reads a workspace.

``--part conversion`` writes chip_smoke.py phase 8e's source,
``conversion/plane_3200x2130_arith.jpg`` (cv2's BGR of
``tests/data/webp/conversion/plane_3200x2130.webp``, cv2.imencode's 4:2:0
q95 JPEG of it transcoded to arithmetic coding) and adds to
``conversion/cv2.json`` its hashes (``arith``) and those of the two lossless
streams the phase writes at run time (``lossless_p1_restart16``,
``lossless_p7``: the source's R, G, B planes, predictor 1 with a restart
every 16 rows and predictor 7; cv2 reads their BGR, which is the source,
and refuses their grey).
"""

import argparse
import hashlib
import importlib.util
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


def _beside(name: str):
    """A module beside this file, loaded by path under its own name (other
    fixture folders have a ``make_fixtures.py`` of their own)."""
    spec = importlib.util.spec_from_file_location(
        f"jpeg_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JPEG_FIXTURES = _beside("make_fixtures")
exif_app1, plane, with_sof = (_JPEG_FIXTURES.exif_app1, _JPEG_FIXTURES.plane,
                              _JPEG_FIXTURES.with_sof)

WEBP_SOURCE = os.path.join(os.path.dirname(HERE), "webp", "conversion",
                           "plane_3200x2130.webp")
ARITH_SOURCE = os.path.join(HERE, "conversion", "plane_3200x2130_arith.jpg")


def _read(rel: str) -> bytes:
    with open(os.path.join(HERE, rel), "rb") as f:
        return f.read()


def transcode(lib, data: bytes, **kw) -> bytes:
    """A Huffman JPEG transcoded to arithmetic coding: its coefficients (the
    host decoder's), quantization tables and APPn segments."""
    coefs, factors, ids, tq, _, size = check_host_decoder.coefficients(
        lib, data)
    segs = jf._segments(data)
    tables = b"".join(jf.segment(m, b) for m, b, _ in segs if m == 0xDB)
    pre = b"".join(jf.segment(m, b) for m, b, _ in segs if 0xE0 <= m <= 0xEF)
    return jf.arithmetic_jpeg(coefs, factors, size, tables, tq=tq, ids=ids,
                              pre=pre, **kw)


DAC = {("dc", 0): (2, 6), ("ac", 0): 2}
# name: (Huffman source, transcode options)
ARITH = {
    "420": ("420_q95", {}),
    "422": ("422_q90", {}),
    "444": ("444_q100", {}),
    "grey": ("gray_q95", {}),
    "progressive_420": ("420_q95", {"progressive": True}),
    "progressive_grey": ("gray_q95", {"progressive": True}),
    "from_progressive": ("progressive_q95", {}),
    "restart3_420": ("420_q95", {"restart": 3}),
    "progressive_restart2": ("422_q90", {"progressive": True,
                                         "restart": 2}),
    "dac_420": ("420_q95", {"dac": DAC}),
    "dac_progressive_444": ("444_q100", {"progressive": True,
                                         "dac": {("dc", 0): (0, 0),
                                                 ("ac", 0): 40}}),
    "scans_420": ("420_q95", {"interleave": False}),
    "cmyk": ("layouts/cmyk_pil", {}),
    "cmyk_progressive": ("layouts/cmyk_pil", {"progressive": True}),
    "ycck": ("layouts/ycck_adobe2", {}),
    "ycck_each_axis": ("layouts/cmyk_each_axis", {"restart": 2}),
    "exif6": ("layouts/exif_orientation6", {}),
    "exif3_progressive": ("layouts/exif_orientation3", {"progressive": True}),
    "w1_420": ("layouts/ycc_420_w1_cv2", {}),
    "w2_422": ("layouts/ycc_422_w2_cv2", {}),
    "w3_420": ("layouts/ycc_420_w3_cv2", {"progressive": True}),
    "w4_422": ("layouts/ycc_422_w4_cv2", {}),
}


def planes_of(shape_factors, h: int, w: int, seed: int, precision: int = 8):
    """Smooth planes (``make_fixtures.plane``) at each component's sampled
    size, scaled to ``precision`` bits."""
    hmax = max(a for a, _ in shape_factors)
    vmax = max(b for _, b in shape_factors)
    return [plane(-(-h * v // vmax), -(-w * f // hmax), seed + i)
            .astype(np.int64) >> (8 - precision)
            for i, (f, v) in enumerate(shape_factors)]


G, RGB, CMYK = [(1, 1)], [(1, 1)] * 3, [(1, 1)] * 4
# name: (factors, h, w, seed, lossless_jpeg options)
LOSSLESS = {
    **{f"grey_p{p}": (G, 37 + 4 * p, 45 + 6 * p, p, {"predictor": p})
       for p in range(1, 8)},
    **{f"rgb_p{p}": (RGB, 30 + 5 * p, 70 - 3 * p, 10 + p, {"predictor": p})
       for p in range(1, 8)},
    "grey_pt2_p5": (G, 40, 52, 20, {"predictor": 5, "pt": 2}),
    "rgb_pt3_p4": (RGB, 33, 41, 21, {"predictor": 4, "pt": 3}),
    "rgb_pt1_p6_restart2": (RGB, 50, 37, 22, {"predictor": 6, "pt": 1,
                                              "restart_rows": 2}),
    **{f"grey_prec{b}_p{1 + b % 7}": (G, 29, 35, 30 + b,
                                      {"predictor": 1 + b % 7,
                                       "precision": b})
       for b in range(2, 8)},
    "rgb_prec6_p2": (RGB, 31, 29, 40, {"predictor": 2, "precision": 6}),
    "rgb_restart1_p7": (RGB, 45, 66, 41, {"predictor": 7,
                                          "restart_rows": 1}),
    "rgb_restart3_p3": (RGB, 64, 96, 42, {"predictor": 3,
                                          "restart_rows": 3}),
    "grey_restart2_p4": (G, 70, 41, 43, {"predictor": 4,
                                         "restart_rows": 2}),
    "rgb_ids_RGB_p2": (RGB, 26, 38, 44, {"predictor": 2, "ids": b"RGB"}),
    "rgb_ids_789_p5": (RGB, 26, 38, 45, {"predictor": 5, "ids": [7, 8, 9]}),
    "rgb_adobe0_p6": (RGB, 26, 38, 46, {"predictor": 6,
                                        "pre": jf.adobe_app14(0)}),
    "cmyk_p1": (CMYK, 30, 44, 50, {"predictor": 1}),
    "cmyk_adobe0_p7_restart2": (CMYK, 35, 27, 51,
                                {"predictor": 7, "restart_rows": 2,
                                 "pre": jf.adobe_app14(0)}),
    "cmyk_jfif_p3": (CMYK, 22, 31, 52, {"predictor": 3,
                                        "pre": jf.jfif_app0()}),
    "rgb_420_p1": ([(2, 2), (1, 1), (1, 1)], 37, 45, 60, {"predictor": 1}),
    "rgb_422_p7_restart1": ([(2, 1), (1, 1), (1, 1)], 29, 51, 61,
                            {"predictor": 7, "restart_rows": 1}),
    "rgb_y1x1_c2x2_p4": ([(1, 1), (2, 2), (2, 2)], 25, 33, 62,
                         {"predictor": 4}),
    "rgb_each_axis_p5": ([(2, 2), (1, 2), (2, 1)], 31, 43, 63,
                         {"predictor": 5, "restart_rows": 2}),
    "cmyk_sampled_p6": ([(2, 2), (1, 1), (1, 1), (2, 2)], 27, 35, 64,
                        {"predictor": 6}),
    "rgb_1x1_p4": (RGB, 1, 1, 70, {"predictor": 4}),
    "rgb_7x3_p3": (RGB, 7, 3, 71, {"predictor": 3}),
    "grey_1x97_p7": (G, 1, 97, 72, {"predictor": 7}),
    "rgb_96x1_p5": (RGB, 96, 1, 73, {"predictor": 5}),
    "rgb_exif6_p4": (RGB, 37, 53, 80, {"predictor": 4,
                                       "pre": exif_app1(6)}),
    "cmyk_exif3_p5": (CMYK, 23, 41, 81, {"predictor": 5,
                                         "pre": exif_app1(3)}),
    "grey_exif8_p2": (G, 33, 20, 82, {"predictor": 2, "pre": exif_app1(8)}),
    # a scan a component; with Y at 1x2, a restart every MCU row (a row of
    # Y) falls inside libjpeg's iMCU rows of two: it undifferences only
    # their first row as a first row, so cv2 reads the odd rows otherwise
    # than T.81 (and this writer) predict them
    "rgb_scans_p3": (RGB, 21, 27, 84, {"predictor": 3, "interleave": False}),
    "rgb_scans_restart2_p6": (RGB, 25, 19, 85, {"predictor": 6,
                                                "restart_rows": 2,
                                                "interleave": False}),
    "rgb_scans_y1x2_restart1_p4": ([(1, 2), (1, 1), (1, 1)], 22, 17, 86,
                                   {"predictor": 4, "restart_rows": 1,
                                    "interleave": False}),
    "cmyk_scans_restart1_p2": (CMYK, 13, 11, 87, {"predictor": 2,
                                                  "restart_rows": 1,
                                                  "interleave": False}),
    # a scan a component, each of its own point transform
    "rgb_scans_pts_021_p1": (RGB, 23, 31, 88, {"predictor": 1,
                                               "pt": (0, 2, 1),
                                               "interleave": False}),
    "cmyk_scans_pts_3102_p6": (CMYK, 19, 26, 89, {"predictor": 6,
                                                  "pt": (3, 1, 0, 2),
                                                  "restart_rows": 2,
                                                  "interleave": False}),
}
TRUNCATED = {"rgb_truncated_p7": (RGB, 40, 52, 90, {"predictor": 7}),
             "cmyk_truncated_p2": (CMYK, 33, 45, 91, {"predictor": 2})}


def with_fill(data: bytes) -> bytes:
    """``data`` with a fill byte 0xFF before each RSTn marker of its scan
    (T.81 B.1.1.2 lets any marker be preceded by fill bytes)."""
    head = data.rindex(b"\xff\xda")
    scan = data[head:]
    for n in range(8):
        scan = scan.replace(bytes([0xFF, 0xD0 + n]), bytes([0xFF, 0xFF,
                                                             0xD0 + n]))
    return data[:head] + scan


def patched(data: bytes, at: bytes, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` past the segment whose first bytes
    are ``at`` set to ``value``."""
    out = bytearray(data)
    out[out.index(at) + offset] = value
    return bytes(out)


def refused_lossless() -> dict:
    """What cv2 refuses in both modes, each a file whose cause is named."""
    rgb = planes_of(RGB, 21, 27, 100)
    cmyk = planes_of(CMYK, 21, 27, 104)
    grey = planes_of(G, 21, 27, 108)
    rows = jf.lossless_jpeg(rgb, restart_rows=1, predictor=2)
    dri = rows.index(b"\xff\xdd")
    partial = rows[:dri + 4] + b"\x00\x05" + rows[dri + 6:]
    two = jf.lossless_jpeg(rgb[:2], predictor=1)
    whole = jf.lossless_jpeg(rgb, predictor=3)
    sos = jf.lossless_jpeg(grey, predictor=1)
    return {
        "rgb_jfif": jf.lossless_jpeg(rgb, pre=jf.jfif_app0()),
        "rgb_adobe1": jf.lossless_jpeg(rgb, pre=jf.adobe_app14(1)),
        "rgb_adobe2": jf.lossless_jpeg(rgb, pre=jf.adobe_app14(2)),
        "cmyk_adobe1": jf.lossless_jpeg(cmyk, pre=jf.adobe_app14(1)),
        "cmyk_adobe2": jf.lossless_jpeg(cmyk, pre=jf.adobe_app14(2)),
        "one_bit": jf.lossless_jpeg([g >> 7 for g in grey], precision=1),
        "twelve_bit": jf.lossless_jpeg([g << 4 for g in grey],
                                       precision=12),
        "sixteen_bit": jf.lossless_jpeg([g * 257 for g in rgb],
                                        precision=16, predictor=7),
        "pt_precision": patched(sos, b"\xff\xda", 9, 8),
        "restart_partial_row": partial,
        "two_components": two,
        "truncated_header": whole[:whole.index(b"\xff\xc3") + 9],
    }


def cv2_modes(path: str):
    return (cv2.imread(path, cv2.IMREAD_GRAYSCALE),
            cv2.imread(path, cv2.IMREAD_COLOR))


def write(folder: str, files: dict, arrays: dict = None) -> None:
    os.makedirs(os.path.join(HERE, folder), exist_ok=True)
    for name, data in files.items():
        path = os.path.join(HERE, folder, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        if arrays is None:
            continue
        grey, bgr = cv2_modes(path)
        assert grey is not None or bgr is not None, f"cv2 refuses {path}"
        if grey is not None:
            arrays[f"gray_{name}"] = grey
        if bgr is not None:
            arrays[f"bgr_{name}"] = bgr


def write_fixtures() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        lib = check_host_decoder.build(tmp)
        made = {}
        for name, (src, kw) in ARITH.items():
            huff = _read(f"{src}.jpg")
            made[name] = transcode(lib, huff, **kw)
            with open(os.path.join(tmp, "a.jpg"), "wb") as f:
                f.write(made[name])
            with open(os.path.join(tmp, "h.jpg"), "wb") as f:
                f.write(huff)
            for a, b in zip(cv2_modes(os.path.join(tmp, "a.jpg")),
                            cv2_modes(os.path.join(tmp, "h.jpg"))):
                assert np.array_equal(a, b), f"cv2 reads {name} otherwise"
        made["fill_restart3_420"] = with_fill(made["restart3_420"])
        for k in ("fill_restart3_420", "restart3_420"):
            with open(os.path.join(tmp, f"{k}.jpg"), "wb") as f:
                f.write(made[k])
        for a, b in zip(*(cv2_modes(os.path.join(tmp, f"{k}.jpg"))
                          for k in ("fill_restart3_420", "restart3_420"))):
            assert np.array_equal(a, b), "cv2 reads fill bytes otherwise"
    made["patched_sof9"] = with_sof(_read("420_q95.jpg"), marker=0xC9)
    cut = lambda b: b[:len(b) * 2 // 3]
    arrays = {}
    write("truncated", {"420_q95": cut(_read("420_q95.jpg")),
                        "odd_101x203_q95": cut(_read("odd_101x203_q95.jpg")),
                        "arith_420": cut(made["420"]),
                        "arith_restart3_420": cut(made["restart3_420"])},
          arrays)
    np.savez_compressed(os.path.join(HERE, "truncated", "cv2_arrays.npz"),
                        **arrays)
    arrays = {}
    write("arith", made, arrays)
    np.savez_compressed(os.path.join(HERE, "arith", "cv2_arrays.npz"),
                        **arrays)

    made = {}
    for name, (factors, h, w, seed, kw) in {**LOSSLESS, **TRUNCATED}.items():
        kw = dict(kw)
        made[name] = jf.lossless_jpeg(
            planes_of(factors, h, w, seed, kw.get("precision", 8)),
            factors=factors, size=(h, w), **kw)
        if name in TRUNCATED:
            made[name] = made[name][:len(made[name]) * 2 // 3]
    arrays = {}
    write("lossless", made, arrays)
    np.savez_compressed(os.path.join(HERE, "lossless", "cv2_arrays.npz"),
                        **arrays)
    refused = refused_lossless()
    write(os.path.join("lossless", "refused"), refused)
    write("refused", {"arithmetic_lossless": jf.sof11_constant(16, 24),
                      "hierarchical": jf.hierarchical_jpeg(16, 24)})
    for folder, names in ((os.path.join("lossless", "refused"), refused),
                          ("refused", ("arithmetic_lossless",
                                       "hierarchical"))):
        for name in names:
            modes = cv2_modes(os.path.join(HERE, folder, f"{name}.jpg"))
            assert modes == (None, None), f"cv2 reads {folder}/{name}"


def write_conversion() -> None:
    """Phase 8e's arithmetic source and the hashes of cv2's reads."""
    sha = lambda b: hashlib.sha256(b).hexdigest()
    with open(WEBP_SOURCE, "rb") as f:
        webp = f.read()
    bgr = cv2.imread(WEBP_SOURCE, cv2.IMREAD_COLOR)
    ok, huff = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert ok
    with tempfile.TemporaryDirectory() as tmp:
        data = transcode(check_host_decoder.build(tmp), huff.tobytes())
    with open(ARITH_SOURCE, "wb") as f:
        f.write(data)
    grey, read = cv2_modes(ARITH_SOURCE)
    assert np.array_equal(read, cv2.imdecode(huff, cv2.IMREAD_COLOR))
    path = os.path.join(HERE, "conversion", "cv2.json")
    with open(path) as f:
        record = json.load(f)
    record["arith"] = {
        "from": "cv2.imencode q95 4:2:0 of cv2's BGR of "
                "webp/conversion/plane_3200x2130.webp (sha-256 "
                f"{sha(webp)}), transcoded to arithmetic coding",
        "source_sha256": sha(data), "gray_sha256": sha(grey.tobytes()),
        "bgr_sha256": sha(read.tobytes()),
        "workspace_sha256": sha(cv2.imencode(".jpg", read)[1].tobytes())}
    rgb = [bgr[..., 2], bgr[..., 1], bgr[..., 0]]
    for key, kw in (("lossless_p1_restart16", {"predictor": 1,
                                               "restart_rows": 16}),
                    ("lossless_p7", {"predictor": 7})):
        stream = jf.lossless_jpeg(rgb, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            p = os.path.join(tmp, "s.jpeg")
            with open(p, "wb") as f:
                f.write(stream)
            grey, read = cv2_modes(p)
        assert grey is None and np.array_equal(read, bgr)
        record[key] = {
            "from": f"jpeg_file.lossless_jpeg of the R, G, B planes of "
                    f"cv2's BGR of webp/conversion/plane_3200x2130.webp, "
                    f"{kw}",
            "stream_sha256": sha(stream), "gray_sha256": None,
            "bgr_sha256": sha(read.tobytes()),
            "workspace_sha256": sha(cv2.imencode(".jpg", read)[1].tobytes())}
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
