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
adds cv2's hashes of it (``progressive_cut``) to ``conversion/cv2.json``,
and those of its first bytes up to 5 bytes into the symbols of the DHT
before its sixth scan (``progressive_cut_in_dht``, with their count).

``--part segments`` writes ``cut_segments/`` (:func:`write_segments`):
JPEGs cut after every byte of marker segments, and which of cv2's arrays
each reads to.
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


def segments(data: bytes):
    """(offset, marker, size) of each marker segment of a JPEG, from its
    first after SOI to its EOI, skipping each scan's entropy-coded data;
    size counts the marker and the length."""
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        size = 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((pos, data[pos + 1], size))
        pos += size
        if out[-1][1] == 0xDA:
            while not (data[pos] == 0xFF and data[pos + 1] not in (
                    0x00, *range(0xD0, 0xD8))):
                pos += 1
    return out


def before_scan(data: bytes, k: int, segment: bytes) -> bytes:
    """``data`` with ``segment`` inserted just before its k-th scan's SOS
    (k from 1)."""
    at = scan_starts(data)[k - 1][0]
    return data[:at] + segment + data[at:]


MARKERS = {0xC0: "sof", 0xC2: "sof", 0xCA: "sof", 0xC4: "dht", 0xCC: "dac",
           0xDA: "sos", 0xDB: "dqt",
           0xDD: "dri", 0xE0: "app0", 0xE1: "app1", 0xFE: "com"}


def sequential_scans() -> bytes:
    """A multi-scan sequential JPEG: 4:2:0 YCbCr as three non-interleaved
    scans, each the scan of cv2.imencode's grey q90 JPEG of the plane
    (``jpeg_file.scans_jpeg``), with the AC table sent again before the
    third scan."""
    factors = [(2, 2), (1, 1), (1, 1)]
    greys = [cv2.imencode(".jpg", p.astype(np.uint8),
                          [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
             for p in mal.planes_of(factors, 30, 44, 7)]
    data = jf.scans_jpeg(greys, factors, (30, 44))
    dht = [data[a:a + n] for a, m, n in segments(data) if m == 0xC4]
    return before_scan(data, 3, dht[-1])


def segment_sources(lib) -> dict:
    """{name: (JPEG, the segments to cut at every byte)}: see
    ``write_segments``."""
    huff = sources()["420"]
    tables = huff
    for k, seg in ((2, jf.segment(0xDB, bytes([0]) + bytes(range(3, 67)))),
                   (3, jf.segment(0xDD, bytes(2))),
                   (4, jf.segment(0xFE, b"cut here")),
                   (5, jf.segment(0xE1, b"http://ns.adobe.com/xap/1.0/\0"
                                        b"<x:xmpmeta/>"))):
        tables = before_scan(tables, k, seg)
    dht = next(huff[a:a + n] for a, m, n in segments(huff)[7:] if m == 0xC4)
    arith = mal.transcode(lib, huff, progressive=True)
    arith = before_scan(before_scan(arith, 3, jf.dac_segment(
        {("dc", 0): (0, 1), ("ac", 0): 5})), 6, dht)
    seq = sequential_scans()
    first_scan = lambda d: next(i for i, (_, m, _) in enumerate(segments(d))
                                if m == 0xDA)
    inserted = lambda d: [i for i, (_, m, _) in enumerate(segments(d))
                          if i > first_scan(d) and m in (
                              0xCC, 0xDB, 0xDD, 0xE1, 0xFE) or
                          (m == 0xC4 and d is arith)]
    return {
        "prog_420": (huff, list(range(len(segments(huff))))),
        "prog_420_tables": (tables, inserted(tables)),
        "prog_arith_420": (arith, inserted(arith)),
        "seq_scans": (seq, [i for i, (_, m, _) in enumerate(segments(seq))
                            if m == 0xDA or i > first_scan(seq)])}


def segment_cuts(lib) -> dict:
    """{name: JPEG}: each source of :func:`segment_sources` cut after every
    byte of each segment it names (``<source>_<marker><k>_at<j>``: j bytes
    of the k-th such marker's segment kept), and the whole files with
    inserted segments."""
    out = {}
    for name, (data, picks) in segment_sources(lib).items():
        segs, seen = segments(data), {}
        for i, (at, marker, size) in enumerate(segs):
            tag = MARKERS[marker]
            seen[tag] = seen.get(tag, 0) + 1
            if i not in picks:
                continue
            for j in range(1, size + 1):
                out[f"{name}_{tag}{seen[tag]}_at{j}"] = data[:at + j]
        if name != "prog_420":
            out[f"{name}_whole"] = data
    return out


def _digest(grey, bgr) -> str:
    return hashlib.sha256(grey.tobytes() + bgr.tobytes()).hexdigest()


def write_segments() -> None:
    """``cut_segments/``: the files of :func:`segment_cuts`, ``cuts.json``
    ({file: what cv2.imread gives: null where it returns None in both
    modes, else the key of its arrays: "truncated/<name>" where
    ``truncated/cv2_arrays.npz`` holds them, else "<name>" in
    ``cut_segments/cv2_arrays.npz``}) and those arrays."""
    folder = os.path.join(HERE, "cut_segments")
    os.makedirs(folder, exist_ok=True)
    for f in os.listdir(folder):
        os.remove(os.path.join(folder, f))
    known = {}
    old = np.load(os.path.join(TRUNCATED, "cv2_arrays.npz"))
    for key in old.files:
        if key.startswith("gray_"):
            stem = key[5:]
            known.setdefault(_digest(old[key], old[f"bgr_{stem}"]),
                             f"truncated/{stem}")
    record, arrays = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cuts = segment_cuts(check_host_decoder.build(tmp))
    for name, data in sorted(cuts.items()):
        path = os.path.join(folder, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        grey, bgr = cv2_modes(path)
        assert (grey is None) == (bgr is None), f"cv2 reads one mode of {path}"
        if grey is None:
            record[name] = None
            continue
        digest = _digest(grey, bgr)
        if digest not in known:
            known[digest] = name
            arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = grey, bgr
        record[name] = known[digest]
    with open(os.path.join(folder, "cuts.json"), "w") as f:
        json.dump(record, f, indent=0, sort_keys=True)
        f.write("\n")
    np.savez_compressed(os.path.join(folder, "cv2_arrays.npz"), **arrays)


def conversion_source(whole: bool = False) -> bytes:
    """Phase 8f's cut progressive source (see the module's doc), or with
    ``whole`` the file it is cut from."""
    bgr = cv2.imread(mal.WEBP_SOURCE, cv2.IMREAD_COLOR)
    data = encode(bgr, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    _, start, end = scan_starts(data)[5]
    return data if whole else data[:(start + end) // 2]


def in_dht(data: bytes) -> int:
    """The length of ``data`` cut 5 bytes into the symbols (past the 16
    counts) of the DHT segment just before its sixth scan."""
    at = scan_starts(data)[5][0]
    return max(a for a, m, _ in segments(data) if m == 0xC4 and a < at) + \
        4 + 17 + 5


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
    n = in_dht(conversion_source(whole=True))
    with tempfile.TemporaryDirectory() as tmp:
        cut = os.path.join(tmp, "cut.jpg")
        with open(cut, "wb") as f:
            f.write(data[:n])
        grey, bgr = cv2_modes(cut)
    record["progressive_cut_in_dht"] = {
        "from": "the first source_bytes bytes of "
                "plane_3200x2130_progressive_cut.jpg: cut 5 bytes into the "
                "symbols of the DHT before its sixth scan",
        "source_bytes": n, "source_sha256": sha(data[:n]),
        "gray_sha256": sha(grey.tobytes()), "bgr_sha256": sha(bgr.tobytes()),
        "workspace_sha256": sha(cv2.imencode(".jpg", bgr)[1].tobytes())}
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("all", "fixtures", "segments",
                                       "conversion"), default="all")
    part = ap.parse_args().part
    if part in ("all", "fixtures"):
        write_fixtures()
    if part in ("all", "segments"):
        write_segments()
    if part in ("all", "conversion"):
        write_conversion()


if __name__ == "__main__":
    main()
