"""JPEGs cut inside a marker segment, held against cv2.imread on the CPU.

cv2.imread reads a JPEG through libjpeg's file source, which feeds the fake
EOI bytes FF D9 at every read past the end of the file. A cut segment is
completed with them and parsed by its marker's own rule; the next marker is
then the fake EOI. The host decoder (``csrc/jpeg_entropy.h``) does the same.

* ``tests/data/jpeg/cut_segments/`` (``make_truncated.py --part
  segments``): cv2's progressive 4:2:0 file cut after every byte of every
  segment, the header's included; the same file with a DQT (redefining a
  table already in use), a DRI, a COM and an APP1 inserted between scans;
  its arithmetic-coded transcode with a DAC and a DHT inserted between
  scans; and a multi-scan sequential file cut inside its SOS headers and a
  DHT between scans. ``cuts.json`` records what cv2.imread gives for each
  file: null where it returns None, else the key of its arrays (most equal
  a ``truncated/prog_*_after_s<k>`` file's). The host decoder with the
  colour kernels' plain twin reads each cut to those arrays, or refuses it
  where cv2 refuses it, with a code that names the cause (2001: the
  completed segment is not valid; 2003: no scan).
* A file that ends in the 0xFF of a marker reads; one cut after a marker's
  code or inside its length is refused, as cv2 refuses it.
* A DQT between scans does not change the table a component latched at its
  first scan.
* chip_smoke.py phase 8f's 3200x2130 source cut inside a DHT's symbols
  reads as cv2 reads it (``conversion/cv2.json``).
* On the card (``cuda``): every cut read to cv2's arrays or refused.

    python -m pytest --noconftest -m cuda tests/test_torch_jpeg_cut_segments.py
"""

import hashlib
import importlib.util
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from mpmvs_torch.io import images

torch.set_num_threads(1)

JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jpeg")
CUTS = os.path.join(JPEG, "cut_segments")
with open(os.path.join(CUTS, "cuts.json")) as _f:
    RECORD = json.load(_f)
# every cut of one segment: "<source>_<marker><k>"
SEGMENTS = sorted({name.rsplit("_at", 1)[0] for name in RECORD
                   if "_at" in name})


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(JPEG, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _module("check_host_decoder")


def _bytes(name):
    with open(os.path.join(CUTS, f"{name}.jpg"), "rb") as f:
        return f.read()


def _cuts(segment):
    return sorted((n for n in RECORD if n.rsplit("_at", 1)[0] == segment),
                  key=lambda n: int(n.rsplit("_at", 1)[1]))


def cv2_arrays(key):
    """cv2's grey and BGR arrays under a key of cuts.json."""
    folder, stem = (("truncated", key[len("truncated/"):])
                    if key.startswith("truncated/") else ("cut_segments", key))
    want = np.load(os.path.join(JPEG, folder, "cv2_arrays.npz"))
    return want[f"gray_{stem}"], want[f"bgr_{stem}"]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host decoder")
    return TOOL.build(str(tmp_path_factory.mktemp("host_cut_segments")))


def test_fixtures_cover_every_kind_of_segment():
    """Cuts at every byte of a DHT and an SOS between the scans of a
    Huffman progressive file, a DAC and a DHT of an arithmetic one, an
    inserted DQT, DRI, COM and APP1, a multi-scan sequential file's SOS
    headers, and the header segments before the first scan."""
    kinds = {re.match(r"[a-z]+", s.split("_")[-1])[0] for s in SEGMENTS}
    assert kinds == {"app", "com", "dac", "dht", "dqt", "dri", "sof", "sos"}
    for src in ("prog_420_", "prog_arith_420_dac", "prog_arith_420_dht",
                "prog_420_tables_dqt", "prog_420_tables_dri",
                "prog_420_tables_com", "prog_420_tables_app1",
                "seq_scans_sos"):
        assert any(s.startswith(src) for s in SEGMENTS), src
    assert len(RECORD) > 900


@pytest.mark.parametrize("segment", SEGMENTS)
def test_cv2_reads_the_cuts_as_recorded(segment):
    """cuts.json holds what cv2.imread gives of each committed file, in
    both modes."""
    import cv2

    for name in _cuts(segment):
        path = os.path.join(CUTS, f"{name}.jpg")
        grey = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if RECORD[name] is None:
            assert grey is None and bgr is None, name
            continue
        want = cv2_arrays(RECORD[name])
        np.testing.assert_array_equal(grey, want[0], err_msg=name)
        np.testing.assert_array_equal(bgr, want[1], err_msg=name)


@pytest.mark.parametrize("segment", SEGMENTS)
def test_host_read_of_every_cut_is_cv2(host, segment):
    """The host decoder with the colour kernels' plain twin: cv2's grey and
    BGR for every cut cv2 reads; refused, naming the cut segment (2001) or
    the missing scan (2003), where cv2 returns None."""
    for name in _cuts(segment):
        data = _bytes(name)
        code = TOOL.status(host, data)
        if RECORD[name] is None:
            assert code in (2001, 2003), (name, code)
            if code == 2003:  # only a file with no whole scan header
                assert data.find(b"\xff\xda") < 0 or "sos1_" in name, name
            continue
        assert code == 0, (name, code)
        gray, bgr = TOOL.decode(host, data)
        want = cv2_arrays(RECORD[name])
        np.testing.assert_array_equal(gray, want[0], err_msg=name)
        np.testing.assert_array_equal(bgr, want[1], err_msg=name)


@pytest.mark.parametrize("source", ["prog_420_tables", "prog_arith_420",
                                    "seq_scans"])
def test_host_read_of_whole_file_is_cv2(host, source):
    """The uncut files with segments inserted between scans: a DQT that
    redefines a table in use changes nothing (jdinput.c latches a
    component's table at its first scan); a DAC of the default conditioning
    and a DHT in an arithmetic file; a DHT before a sequential file's last
    scan."""
    name = f"{source}_whole"
    gray, bgr = TOOL.decode(host, _bytes(name))
    want = cv2_arrays(RECORD[name])
    np.testing.assert_array_equal(gray, want[0])
    np.testing.assert_array_equal(bgr, want[1])


@pytest.mark.parametrize("marker", ["dht3", "sos5", "dht9"])
def test_marker_prefix_is_libjpegs(host, marker):
    """A file that ends in a marker's 0xFF reads (libjpeg skips fill bytes
    before the fake EOI); one that ends after the marker's code or inside
    its length is refused, as cv2 refuses it (the fake bytes make the
    length, then a Huffman table's counts or the scan header, invalid). A
    decoder that stopped at a marker with fewer than four bytes left read
    those."""
    segment = f"prog_420_{marker}"
    assert RECORD[f"{segment}_at1"] is not None
    assert TOOL.status(host, _bytes(f"{segment}_at1")) == 0
    for j in (2, 3):
        assert RECORD[f"{segment}_at{j}"] is None
        assert TOOL.status(host, _bytes(f"{segment}_at{j}")) == 2001


def test_dht_cut_reads_once_its_counts_are_whole(host):
    """In a DHT between scans, a cut from the marker's second byte through
    its 16 counts is refused (the fake bytes sum past 256); a cut inside
    the symbols reads, as the table is checked only when a scan uses it."""
    for segment in (s for s in SEGMENTS if "_dht" in s
                    and not s.startswith(("prog_420_dht1", "prog_420_dht2"))):
        cuts = _cuts(segment)
        read = [RECORD[n] is not None for n in cuts]
        assert read == [True] + [False] * 19 + [True] * (len(cuts) - 20), \
            segment
        for n, r in zip(cuts, read):
            assert (TOOL.status(host, _bytes(n)) == 0) == r, n


def test_conversion_source_cut_in_dht_is_read_as_cv2_reads_it(host):
    """Phase 8f's second source: the committed 3200x2130 cut progressive
    source up to 5 bytes into the symbols of the DHT before its sixth
    scan. The host read (smoothed: five scans whole) gives cv2's hashes."""
    with open(os.path.join(JPEG, "conversion", "cv2.json")) as f:
        rec = json.load(f)["progressive_cut_in_dht"]
    with open(os.path.join(JPEG, "conversion",
                           "plane_3200x2130_progressive_cut.jpg"), "rb") as f:
        data = f.read()[:rec["source_bytes"]]
    sha = lambda b: hashlib.sha256(b).hexdigest()
    assert sha(data) == rec["source_sha256"]
    at = data.rfind(b"\xff\xc4")
    assert len(data) == at + 4 + 17 + 5
    assert TOOL.smoothing(host, data)
    gray, bgr = TOOL.decode(host, data)
    assert sha(gray.tobytes()) == rec["gray_sha256"]
    assert sha(bgr.tobytes()) == rec["bgr_sha256"]


# ----------------------------- on the card -----------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("segment", SEGMENTS)
def test_card_read_of_every_cut_is_cv2(dev, segment):
    for name in _cuts(segment):
        path = os.path.join(CUTS, f"{name}.jpg")
        if RECORD[name] is None:
            with pytest.raises(ValueError):
                images.read_image(path, dev)
            continue
        gray, bgr = images.read_image(path, dev)
        want = cv2_arrays(RECORD[name])
        assert torch.equal(gray.cpu(), torch.as_tensor(want[0])), name
        assert torch.equal(bgr.cpu(), torch.as_tensor(want[1])), name
