"""The card's BMP and PNM (PBM, PGM, PPM) reads, held against cv2.imread on
the CPU, without the card.

The JAX package reads every image with OpenCV; the port parses a BMP or a
netpbm file on the host (``images.bmp_rows``, RLE4 and RLE8 expanded there
by ``images.bmp_rle``; ``images.pnm_rows``) and converts its samples on
the card with ``raster_to_bgr_kernel`` (``csrc/raster_bgr.h``, built here
with g++ and skipped without it; its plain twin
``images.raster_to_bgr_plain``): palettes, B, G, R byte order, a BMP's
16-bit fields, 16-bit netpbm samples narrowed v >> 8, P1 and P4 with 1 as
black, a bottom-up BMP mirrored top-down by the orientation.

* Every fixture under ``tests/data/bmp`` and ``tests/data/pnm`` reads to
  cv2's stored grey and BGR arrays, 0 entries differing.
* The kernel's arithmetic, built for the host, equals the plain twin on
  every fixture.
* The host's RLE8 and RLE4 expansion gives cv2's image, or is refused where
  cv2 refuses, on random run-length streams (runs past their row, deltas,
  ends of line and of bitmap, data that ends early).
* What cv2 refuses (2 bits, 4-4-4 fields, a run past its row, run-length
  data that ends early, a truncated BMP or PGM, maxval 0, a letter among
  ASCII samples) is refused, naming the cause; a PAM, which cv2 reads, is
  refused as a format the card does not read.
* ``images.image_format`` names a netpbm file as OpenCV's decoders check
  it: "P", the digit, then whitespace.
* On the card (``cuda``, skipped without one): the fixtures read to cv2's
  arrays with one raster launch a read (form ``bgr`` or ``bmp16`` where
  the samples are a BMP's), no plain call; the kernel's BMP forms equal
  their twin at 3200x2130.

OpenCV is imported inside the CPU tests, so the ``cuda`` tests run where
it is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_bmp_pnm.py
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from mpmvs_torch.io import images

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FILES = ([f"bmp/{f}" for f in sorted(os.listdir(os.path.join(DATA, "bmp")))
          if f.endswith(".bmp")]
         + [f"pnm/{f}" for f in sorted(os.listdir(os.path.join(DATA, "pnm")))
            if f.endswith((".pbm", ".pgm", ".ppm"))])
# what the card refuses, and the cause it names
REFUSED = {"bmp/refused/bits2.bmp": "2 bits",
           "bmp/refused/bitfields444.bmp": "5-5-5 and 5-6-5",
           "bmp/refused/rle8_past_row.bmp": "passes its row",
           "bmp/refused/rle8_ends_early.bmp": "ends before its image",
           "bmp/refused/truncated.bmp": "ends before its image",
           "pnm/refused/truncated.pgm": "end before its image",
           "pnm/refused/maxval0.pgm": "maxval 0",
           "pnm/refused/letter.pgm": "other than numbers",
           "pnm/refused/image.pam": "PAM"}


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _module(os.path.join(DATA, "tiff", "check_host_raster.py"),
               "check_host_raster")


def _bytes(rel):
    with open(os.path.join(DATA, rel), "rb") as f:
        return f.read()


def _cv2_arrays(rel):
    folder, name = os.path.split(rel)
    want = np.load(os.path.join(DATA, folder, "cv2_arrays.npz"))
    stem = name.rsplit(".", 1)[0]
    return want[f"gray_{stem}"], want[f"bgr_{stem}"]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the raster kernel's arithmetic")
    return TOOL.build(str(tmp_path_factory.mktemp("host_bmp_pnm")))


@pytest.mark.parametrize("rel", FILES)
def test_host_read_is_cv2(host, rel):
    want_g, want_bgr = _cv2_arrays(rel)
    g, bgr = TOOL.read(host, _bytes(rel))
    np.testing.assert_array_equal(bgr, want_bgr)
    np.testing.assert_array_equal(g, want_g)


@pytest.mark.parametrize("rel", FILES)
def test_raster_kernel_arithmetic_equals_plain(host, rel):
    assert TOOL.kernel_mismatches(host, _bytes(rel)) == 0


@pytest.mark.parametrize("rel", sorted(REFUSED))
def test_refused_raises_naming_why(rel):
    """Refused on the host (so before any copy to a card), naming why; cv2
    refuses each too but the PAM, which it reads."""
    import cv2

    data = _bytes(rel)
    with pytest.raises(ValueError, match=REFUSED[rel]):
        images.decode(data, "cuda")
    buf = np.frombuffer(data, np.uint8)
    read = cv2.imdecode(buf, cv2.IMREAD_COLOR) is not None
    assert read == rel.endswith(".pam")


@pytest.mark.parametrize("bits,seed", [(8, 0), (8, 1), (4, 0), (4, 1)])
def test_rle_expansion_is_cv2_on_random_streams(bits, seed):
    """bmp_rle against cv2 on 400 random RLE8 or RLE4 streams each: the same
    image where cv2 reads the file, a refusal where it does not."""
    import cv2

    maker = _module(os.path.join(DATA, "bmp", "make_fixtures.py"),
                    "bmp_make_fixtures")
    rng = np.random.default_rng(100 * bits + seed)
    read = refused = 0
    for _ in range(400):
        W, H = int(rng.integers(1, 12)), int(rng.integers(1, 8))
        ops = []
        for _ in range(int(rng.integers(1, 30))):
            kind = int(rng.integers(0, 6))
            if kind <= 1:
                idx = int(rng.integers(0, 256)) if bits == 8 else (
                    int(rng.integers(0, 16)), int(rng.integers(0, 16)))
                ops.append(("run", int(rng.integers(1, W + 2)), idx))
            elif kind == 2:
                ops.append(("abs", rng.integers(
                    0, 1 << bits, int(rng.integers(3, W + 3))).tolist()))
            elif kind == 3:
                ops.append(("eol",))
            elif kind == 4:
                ops.append(("delta", int(rng.integers(0, W + 2)),
                            int(rng.integers(0, 3))))
            else:
                ops.append(("eob",))
        palette = rng.integers(0, 256, (1 << bits, 3))
        data = maker.bmp_bytes((maker.rle8 if bits == 8 else maker.rle4)(ops),
                               W, H, bits, palette,
                               compression=1 if bits == 8 else 2)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        try:
            got = palette[images.bmp_rows(data).samples[::-1]][..., ::-1]
        except ValueError:
            got = None
        assert (got is None) == (want is None), ops
        if want is not None:
            np.testing.assert_array_equal(got, want)
            read += 1
        else:
            refused += 1
    assert read > 50 and refused > 50


def test_bmp_forms(host):
    """What bmp_rows makes of the layouts: palettes (RLE expanded to 8-bit
    indices), B, G, R order, 16-bit fields; bottom-up rows as orientation
    4 (OpenCV's top-down mirror), top-down rows as they are."""
    form = lambda rel: images.bmp_rows(_bytes(rel))
    r = form("bmp/rle4.bmp")
    assert (r.form.kind, r.form.bits, r.orientation) == (
        images.RASTER_PALETTE, 8, 4)
    r = form("bmp/bgra32.bmp")
    assert (r.form.kind, r.form.channels, r.form.bgr) == (
        images.RASTER_RGB, 4, 1)
    assert images.raster_form_name(r.form) == "bgr"
    r = form("bmp/rgb565_bitfields.bmp")
    assert (r.form.kind, r.form.bits, r.form.little, r.form.green6) == (
        images.RASTER_BMP16, 16, 1, 1)
    assert form("bmp/rgb555.bmp").form.green6 == 0
    assert form("bmp/pal8_topdown.bmp").orientation == 1
    assert form("bmp/os2_pal8.bmp").form.kind == images.RASTER_PALETTE


def test_pnm_forms():
    """What pnm_rows makes of the netpbm layouts: binary samples as stored
    (P4 packed bits with 1 as black, 16-bit big-endian), ASCII ones parsed
    to bytes through OpenCV's rescale."""
    form = lambda rel: images.pnm_rows(_bytes(rel)).form
    assert (form("pnm/p4_odd_width.pbm").bits,
            form("pnm/p4_odd_width.pbm").min_is_white) == (1, 1)
    assert form("pnm/p6_16.ppm")[:3] == (images.RASTER_RGB, 16, 3)
    assert form("pnm/p2_16.pgm").bits == 16
    r = images.pnm_rows(_bytes("pnm/p2_maxval100_above.pgm"))
    assert r.form.bits == 8 and r.samples.max() == 255


def _pnm_one_by_one(data: bytes, pos: int, count: int, one_digit: bool):
    values = []
    for _ in range(count):
        v, pos = images._pnm_number(data, pos, one_digit)
        values.append(v)
    return values


@pytest.mark.parametrize("body,count,one_digit", [
    (b"12 0 255\n7\t65535 3\r\n", 6, False),   # digits and whitespace
    (b" 007 10 5 9 9 9", 4, False),              # more numbers than read
    (b"1 2 # a comment\n3 4 ", 4, False),        # a comment: one by one
    (b"1 2x3 4 ", 4, False),                     # a consumed non-space
    (b"5 6 7 8", 4, False),                      # ends inside a number
    (b"5 6 7", 4, False),                        # too few numbers
    (b"0101\n 1 0\n0", 7, True),                 # P1 digits, packed
    (b"01 1", 4, True),                          # too few digits
    (b"1234567890123456789 1 ", 2, False),       # past 18 digits
])
def test_ascii_samples_read_as_one_by_one(body, count, one_digit):
    """pnm_rows's numpy parse of ASCII samples gives what one
    _pnm_number call a sample gives (OpenCV's ReadNumber), and raises
    where that raises."""
    data = b"P2\n9 9 255\n" + body
    pos = data.index(body)
    try:
        want = _pnm_one_by_one(data, pos, count, one_digit)
    except (ValueError, OverflowError) as e:
        with pytest.raises(type(e)):
            images._pnm_ascii(data, pos, count, one_digit)
        return
    got = images._pnm_ascii(data, pos, count, one_digit)
    assert got.dtype == np.int64 and got.tolist() == want


def test_ascii_samples_at_size_equal_one_by_one():
    """The numpy parse at 100,000 random samples of 1 to 5 digits, between
    runs of every whitespace character, equals one call a sample."""
    rng = np.random.default_rng(18)
    values = rng.integers(0, 65536, 100_000)
    gaps = [b" \t\n\v\f\r"[i:i + 1] * (1 + i % 3)
            for i in rng.integers(0, 6, len(values))]
    body = b"".join(b"%d" % v + g for v, g in zip(values, gaps))
    got = images._pnm_ascii(body, 0, len(values), False)
    assert got.tolist() == values.tolist()
    assert got.tolist() == _pnm_one_by_one(body, 0, len(values), False)


@pytest.mark.parametrize("head,name", [
    (b"P1\n", "PBM"), (b"P2 ", "PGM"), (b"P3\t", "PPM"), (b"P4\r", "PBM"),
    (b"P5\n", "PGM"), (b"P6\n", "PPM"), (b"P7\n", "PAM"), (b"P5#", "unknown"),
    (b"P8\n", "unknown"), (b"PF\n", "PFM"), (b"BM", "BMP")])
def test_image_format_names_netpbm_as_opencv(head, name):
    assert images.image_format(head + b"1 1 255\n\0") == name


# ----------------------------- on the card -----------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rel", FILES)
def test_card_read_is_cv2(dev, rel):
    want_g, want_bgr = _cv2_arrays(rel)
    kind = rel.split("/")[0]
    before = images.CODEC_COUNTS.forms.get(kind, 0)
    k0, p0 = images.RASTER_COUNTS.kernel, images.RASTER_COUNTS.plain
    g, bgr = images.read_image(os.path.join(DATA, rel), dev)
    assert bgr.device.type == "cuda"
    assert torch.equal(g.cpu(), torch.as_tensor(want_g))
    assert torch.equal(bgr.cpu(), torch.as_tensor(want_bgr))
    assert torch.equal(images.read_colour(os.path.join(DATA, rel), dev).cpu(),
                       torch.as_tensor(want_bgr))
    assert images.CODEC_COUNTS.forms[kind] == before + 2
    assert (images.RASTER_COUNTS.kernel, images.RASTER_COUNTS.plain) == (
        k0 + 2, p0)


@pytest.mark.cuda
@pytest.mark.parametrize("rel", FILES)
def test_card_raster_kernel_equals_plain(dev, rel):
    r = images.raster_rows(_bytes(rel), images._library())
    samples = torch.from_numpy(r.samples).to(dev)
    tables = torch.from_numpy(r.tables).to(dev)
    got = images.raster_to_bgr_kernel(samples, r.form, tables)
    want = images.raster_to_bgr_plain(samples, r.form, tables)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bgr24", "bgra32", "rgb555", "rgb565"])
def test_card_bmp_forms_equal_plain_full_size(dev, kind):
    """At 3200x2130, on random samples: the B, G, R forms and the 16-bit
    fields."""
    rng = np.random.default_rng(len(kind))
    H, W = 2130, 3200
    if kind.startswith("bgr"):
        c = 3 if kind == "bgr24" else 4
        rowbytes = (W * 8 * c + 31) // 32 * 4
        form = images.RasterForm(images.RASTER_RGB, 8, c, 0, 0, 0,
                                 images.NARROW_SHIFT, 0, images.GREY_OPENCV,
                                 W, H, rowbytes, rowbytes * H, bgr=1)
    else:
        rowbytes = (W * 16 + 31) // 32 * 4
        form = images.RasterForm(images.RASTER_BMP16, 16, 1, 0, 1, 0,
                                 images.NARROW_SHIFT, 0, images.GREY_OPENCV,
                                 W, H, rowbytes, rowbytes * H,
                                 green6=int(kind == "rgb565"))
    rows = rng.integers(0, 256, (H, rowbytes)).astype(np.uint8)
    samples = torch.from_numpy(rows).to(dev)
    tables = torch.zeros(images.TABLES_LEN, dtype=torch.uint8, device=dev)
    got = images.raster_to_bgr_kernel(samples, form, tables)
    want = images.raster_to_bgr_plain(samples, form, tables)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rel", sorted(REFUSED))
def test_card_refuses(dev, rel):
    with pytest.raises(ValueError, match=REFUSED[rel]):
        images.read_image(os.path.join(DATA, rel), dev)
