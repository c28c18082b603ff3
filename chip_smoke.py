#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mpmvs_torch) on one CUDA card.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # phases 1, 1b, 2 and 5 (builds, kernel checks)

Phases, in order; any failure raises and the script exits non-zero:

1. Device and build: the card's name and power limit, and the ``nvcc``
   builds of ``mpmvs_torch/csrc/ncc_eval.cu``, ``ncc_samples.cu``,
   ``bilateral_refine.cu``, ``geom_cost.cu`` and ``jpeg_codec.cu`` (the
   JPEG decoder's IDCT kernel and its colour kernels of one or three
   components and of four, the encoder's colour and
   forward-DCT kernels, the raster kernel of PNG and TIFF reads, the
   host's entropy coding, PNG unfilter and TIFF decoder, the JPEG 2000
   host decoder, ``j2k_idwt_kernel`` and ``j2k_colour_kernel``), started
   together, with their time and register reports.
1b. The image fixtures on the card against what cv2 gives: the JPEGs of
   ``tests/data/jpeg`` decoded against ``decoded.npz`` (entries that differ
   and the largest difference, grey and BGR) with the IDCT and colour
   kernels against their plain versions on each; the EXIF-oriented and
   RGB-coded files (``layouts/``, and ``refused/`` where
   ``cv2_arrays.npz`` holds them) against cv2's arrays, the RGB form of the
   colour kernel against its plain version; the rest of ``refused/``
   (12-bit, arithmetic-coded lossless, hierarchical, a lossless scan and
   sampling layouts libjpeg refuses) must raise; the arithmetic-coded
   JPEGs of ``arith/`` and the streams cut short of ``truncated/`` (the
   progressive ones, which libjpeg-turbo smooths, too) against cv2's
   arrays, the smoothing kernel (where the file is smoothed), the IDCT and
   colour kernels against their plain versions on each; the JPEGs of
   ``cut_segments/`` (cut after every byte of marker segments:
   ``cuts.json`` names cv2.imread's arrays of each, or null where it
   refuses) read to those arrays with the same kernel checks, or refused
   naming the cut segment or the missing scan; the lossless JPEGs of ``lossless/`` in each mode cv2 reads
   (the other raising), each undifferencing form against its twin on the
   file's planes, ``lossless/refused/`` raising in both entries; the four-component JPEGs (CMYK, YCCK) and every sampling layout
   in ``layouts/`` against cv2's arrays with the colour kernel of each
   (``ycc_to_bgr_kernel``, ``cmyk_to_bgr_kernel``) equal to its plain
   version; the encoder's fixtures
   (``encode/``, colour and grey, 1x1 to 120x176, q75-100) must encode to
   cv2.imencode's stored bytes; the PNGs of ``tests/data/png`` (every
   colour type and bit depth, Adam7, tRNS, gAMA), the TIFFs of
   ``tests/data/tiff`` (JPEG-compressed, YCbCr, signed, CIELab, old-style
   LZW and cut-short ones too), the
   BMPs of ``tests/data/bmp`` and the PNMs of ``tests/data/pnm`` read in
   grey and colour against cv2's arrays, with the raster kernel (for a
   JPEG-compressed TIFF the IDCT over every chunk and the chunked colour
   form) against its plain twin on each; those under ``png/refused``,
   ``tiff/refused``, ``bmp/refused`` and ``pnm/refused`` raising; the
   WebPs first held to cv2 here (loop-filter deltas, 1200 prefix-code
   groups) with each kernel against its twin, and a VP8L back-reference
   before the first pixel raising; every JPEG 2000 file of
   ``tests/data/jp2`` (JP2 and raw codestreams) read to cv2's arrays with
   ``j2k_idwt_kernel`` (each level) and ``j2k_colour_kernel`` against their
   twins on each, the cut lengths cv2 reads (``cuts.json``) to its arrays,
   ``jp2/refused`` raising with each file's code. No entry or byte may
   differ.
2. NCC kernel vs plain: ``ncc_eval_multi`` on the card against its plain
   PyTorch version at K in {1, 5, 9}, S = 10, scales 0 and 2, on
   ground-truth and random planes at the default footprint cap, through
   both of the kernel's launches (tile and view-major); at S = 20 (the 10
   sources twice; two view groups of the tile launch), K = 9, the band
   shape, both launches (no entry may differ); then both
   timed with CUDA events at the main path's band shape (K=9, scale 0),
   and the kernel alone at K=5 on a full-range random field at scale 0
   (view-major launch, as the solver takes it for such trials) and at K=1
   on the init field over every pixel at scale 2, each beside its bound and
   the time PERF.md holds from before the kernel's redesign.
3. At 3200x2130 with 10 sources and the solve's band rows, from the same
   inputs and key, through the kernel and through the plain version: the
   K=1 initial scoring of every pixel, and one half-iteration at scales 2,
   1 and 0; plus the scale-2 step with a constant-cost stand-in for the
   NCC, which times the eager glue around the kernel; then one geom-mode
   half-iteration (scale 0, the sources' true depths) through the
   geometric-cost kernel and through its plain twin, the NCC kernel in
   both arms: the two states must be equal, and the kernel launched twice
   (K=9, K=5).
3b. The geometric-cost kernel (``csrc/geom_cost.cu``) against its plain
   twin at the geom band shape: one band of 2130 rows, its 2130 x 1600
   packed pixels, S = 10 sources' true depths, K = 1 (phase 3's init
   field, warm from its inputs), K = 5 (the trials' call: two random
   fields and three scaled true planes) and K = 9 (the candidates' call:
   8 scaled true planes and the init field), with the solve's camera
   table: no entry may differ; each timed with CUDA events beside the
   kernel's bound and the share of it reached, with the registers a
   thread of the instantiation it takes.
4. The photometric path at 3200x2130 with 1+10 views per estimated view
   (3 of 11 views estimated): ``Pipeline.load_arrays`` + ``Pipeline.run``
   (3 scales x 3 iterations, no geometric pass, no prior, no sky), writing
   .dmb files and the fused PLY to a temporary directory; checks depth
   accuracy, the PLY, and that every NCC call went through the kernel, as
   often as the schedule implies.
5. Bilateral kernel vs plain at 3200x2130: ``bilateral_refine`` on the card
   against its plain version on view 0's guide image (its top fifth painted
   sky blue from here on) with the sky net's probability and on a
   structured random image (both through the float form), and on the guide
   rounded to 8-bit values (the table form); max |diff| <= 1e-5, at most
   1e-4 of the thresholded mask pixels differ, every entry equal, and the
   form taken as the guide implies; the table builder against the plain
   table (no entry may differ); both forms, the builder and the plain
   versions timed with CUDA events.
6. The full path: the same 1+10-view scene with the sky band, its colour
   images rounded to 8-bit values as a workspace's JPEGs give them, default
   ``ConfigParams`` with ``sky_seg=True`` through ``Pipeline.run``: the
   photometric pass, ``geom_0`` with its planar-prior sub-run, ``geom_1``,
   sky masks, fusion. Checks depth accuracy on the non-sky rows after every
   pass, each view's sky fraction against the painted band, that fusing
   with the masks keeps no more points than without, and the launches of
   the NCC, geometric-cost and bilateral kernels against the stated
   schedule (the bilateral kernel through its table form, one table
   build), with no plain call.
7. The sorted path (runs after phase 3, before the sky is painted), on
   view 0's full-range random init field at 3200x2130 with 10 sources:
   (a) the raw-samples form of ``csrc/ncc_samples.cu`` against its plain
   version for every view, cap off and on, and, cap off, at scale 0 on a
   random field over the half-width packed pixels of a refinement trial,
   and the key kernel against its plain version on the same fields: no
   entry may differ; (a2) the fused form (the path's) against its plain
   chain (keys, sort, raw samples, un-permute, ZNCC) on the same three
   fields: no entry may differ; (b)
   ``ncc_eval_sorted`` against the NCC kernel at K=1; (c) CUDA-event times
   of the NCC kernel at K=1 on the coherent default init field and on the
   full-range field (view-major launch), of the sorted path split into the
   pixel record, keys and sort, and the fused kernel, and of the same call
   through the raw-samples form (sort, kernel, un-permute, ZNCC) and the
   plain chain; (d) one photometric solve of view 0 with the
   reference's search semantics, with ``sampler="sorted"`` and with
   ``"auto"``: seconds, median |d-gt|/gt < 1%, and the kernels' launches
   against the stated schedule, with no plain call; the two solves' depth,
   normal and cost may differ on at most MISMATCH_TOL of the pixels.

8. The user's path from files (after phase 6): a 4-view 3200x2130 plane
   scene with the sky band and tinted colours, written as a COLMAP text
   model, a ``.JPG`` image by the card's encoder, an 8-bit RGB ``.tif``
   (LZW, predictor 2), a 16-bit RGB ``.png`` and a YCCK ``.jpeg`` (the
   committed ``tests/data/jpeg/conversion/ycck_3200x2130.jpg``, made of
   view 3 on a card, with the sha-256 of what cv2 makes of it);
   ``mpmvs_torch.preprocess.convert.main`` (on the card), then
   ``mpmvs_torch.cli.main(["--input", ws, "--sky-seg", "1", "--config",
   yaml])``: the default schedule, every view estimated with the other 3
   as sources, every preview on (the YAML's save keys add depths.jpg,
   costs.jpg, normals.jpg). Checks the converted cameras against the
   scene's, median |d-gt|/gt < 1% on ground rows in every view's
   depths.dmb, a non-empty PLY, and the launches of the NCC kernel, the
   bilateral table form and the codec's kernels against the schedule, and
   that the TIFF and PNG sources became the encoding of their pixels
   (16-bit samples narrowed), and that the card reads the YCCK source as
   cv2.imread does (grey and BGR) and converts it to the JAX converter's
   bytes; times the decode and encode per image; holds
   the encoder's colour and DCT kernels to their plain versions at
   3200x2130 (no entry may differ, and the bytes equal) and times them
   beside their bounds, with the copy to the host, the entropy coding and
   the whole encode; times the read of an 8-bit PNG of view 0 (the
   host's PNG writer) and the host unfilter at that size; splits the
   TIFF's and the 16-bit PNG's reads into host parse and decompression, copy to the card and the raster kernel (beside its bound
   and its plain twin, which it must equal), and the YCCK source's read
   into host entropy decode, copy, IDCT and the four-component colour
   kernel (beside its bound and plain twin, which it must equal, on the
   file's planes and on the same planes at 1x1, in both forms).
8b. Lossy WebP (after phase 8's parts, adding no solved view): the
   committed ``tests/data/webp/conversion/plane_3200x2130.webp`` (view 2
   of the scene, libwebp q75; ``cv2.json`` beside it holds the sha-256 of
   cv2's grey and BGR arrays of it and of the JAX converter's workspace
   image) through the converter's image step and the pipeline's read,
   the kernels' counters set to 0 just before: the hashes must be cv2's
   and each of ``vp8_reconstruct_kernel``, ``vp8_loop_filter_kernel`` and
   ``webp_yuv_to_bgr_kernel`` launched twice, no plain call; each kernel
   against its plain twin on the file's frame (no entry may differ), timed
   with CUDA events beside its bound and the twin; the read split into the
   host's parse and entropy decode, the copy, each kernel and the whole
   decode.
8c. Lossless and animated WebP (after 8b, adding no solved view): the
   committed ``tests/data/webp/conversion/plane_3200x2130_lossless.webp``
   (8b's source as cv2 reads it, re-encoded lossless; ``cv2.json``'s
   ``lossless`` entry holds cv2's hashes) through the converter's image
   step and the pipeline's read, the lossless kernels' counters set to 0
   just before: the hashes must be cv2's and ``vp8l_predictor_kernel``,
   ``vp8l_colour_kernel`` (once a run of element-wise transforms) and
   ``webp_argb_to_bgr_kernel`` launched as the file's transforms imply,
   twice each, no plain call; one animated fixture (a lossless first frame
   at (4, 8) on a 60x50 canvas) read against cv2's array; each kernel
   against its plain twin on the file (no entry may differ), timed with
   CUDA events beside its bound and the twin; the read split into the
   host's container check and entropy decode, the copy, each launch and
   the whole decode.
8d. JPEG-compressed TIFF, YCbCr, BMP and PNM (after 8c, adding no solved
   view): the committed ``tests/data/tiff/conversion/
   plane_3200x2130_jpeg.tif`` (8b's source as cv2 reads it, YCbCr 4:2:0
   in 134 strips of 16 rows under one JPEGTables tag; ``cv2.json`` beside
   it holds cv2's hashes) and five small sources (a (2, 2) YCbCr TIFF,
   5-6-5, 24-bit and RLE8 BMPs, a 16-bit PPM) through the converter's
   image step and the pipeline's read, the counters set to 0 just before:
   the TIFF's hashes must be cv2's, the small sources' reads cv2's arrays;
   ``idct_islow_kernel`` launched 3 times and ``ycc_to_bgr_kernel``'s
   chunked form once a read of the TIFF, ``raster_to_bgr_kernel`` twice a
   small source (its ``ycbcr``, ``bmp16`` and ``bgr`` forms twice each),
   no plain call; the IDCT over every strip and the chunked form against
   their twins on the TIFF, the raster kernel's YCbCr and BMP forms on
   3200x2130 samples made from a seed (no entry may differ), each timed
   with CUDA events beside its bound and the twin; the TIFF's read split
   into the host's parse and entropy decode, the copy, the IDCT launches,
   the colour launch and the whole decode.
8e. Arithmetic-coded and lossless JPEGs (after 8d, adding no solved
   view): phase 8b's source as the card reads it (cv2's hash), the
   committed ``tests/data/jpeg/conversion/plane_3200x2130_arith.jpg`` (its
   q95 4:2:0 JPEG transcoded to arithmetic coding) and two lossless RGB
   streams of it written here by ``tests/data/jpeg/jpeg_file.py``
   (predictor 1 with a restart every 16 rows, predictor 7; each stream's
   sha-256 checked against ``cv2.json``), each named ``.jpeg``, through the
   converter's image step, and the arithmetic one through the pipeline's
   read, the counters set to 0 just before: the hashes of the read and of
   the three workspace images must be cv2's, the pipeline's read of a
   lossless stream must raise (cv2 reads its colour only); launches: IDCT
   6 and colour 2 for the arithmetic reads, for the lossless ones
   ``ljpeg_scan_kernel`` 2 (its two passes), ``ljpeg_wavefront_kernel`` 1
   and the colour kernel's RGB form 2, no plain call; each form against
   its twin at full size (no entry may differ), timed with CUDA events and
   from a CUDA graph beside its bound (and the wavefront's step count);
   each read split into host entropy decode (QM or Huffman), copy, each
   launch and the whole decode.
8f. Rarer sources (after 8e, adding no solved view): the committed
   ``tests/data/jpeg/conversion/plane_3200x2130_progressive_cut.jpg``
   (8b's source as cv2.imencode's progressive 4:2:0 q90 JPEG, cut inside
   its sixth scan: libjpeg-turbo smooths its blocks; ``cv2.json``'s
   ``progressive_cut`` holds cv2's hashes), and a CIELab TIFF and an
   old-style LZW TIFF of 8b's source written here
   (``tiff_file.rare_conversion_sources``; their bytes' and cv2's hashes in
   ``tests/data/tiff/conversion/cv2.json``), each through the converter's
   image step and the pipeline's read, the counters set to 0 just before:
   every hash must be cv2's; launches: ``jpeg_smooth_kernel`` 6, the IDCT
   6 and the colour kernel 2 for the cut JPEG, the raster kernel 4 (its
   ``cielab`` form 2), no plain call; the smoothing kernel and the CIELab
   form against their twins at full size (no entry may differ), timed with
   CUDA events and from a CUDA graph beside their bounds
   (``roofline.smooth_bound``, ``cielab_bound``) and the twins; each read
   split into the host's entropy decode or parse and decompression, the
   copy, each launch and the whole decode. Then the cut JPEG's first
   bytes up to 5 into the symbols of the DHT before its sixth scan
   (``progressive_cut_in_dht``): the pipeline's read of it, the counters
   set to 0 just before (smoothing 3, IDCT 3, colour 1, no plain call),
   its hashes cv2's; each kernel against its twin and from a CUDA graph
   beside its bound; the read split on the host clock.
8g. JPEG 2000 sources (after 8f, adding no solved view): the committed
   ``tests/data/jp2/conversion/plane_3200x2130_lossless.jp2`` (8b's source
   as cv2.imwrite's lossless JP2: 5/3, no colour transform),
   ``plane_3200x2130_97_rpcl.jp2`` (Pillow: 9/7, ICT, 1024x1024 tiles,
   RPCL, 128x128 precincts, three rate layers) and
   ``plane_3200x2130_53_rct.jp2`` (Pillow: 5/3, RCT, one tile, LRCP,
   three rate layers), each through the
   converter's image step and the pipeline's read, the counters set to 0
   just before: every hash must be cv2's (``conversion/cv2.json``);
   launches: ``j2k_idwt_kernel`` two a level a read (form ``53`` or
   ``97``), ``j2k_colour_kernel`` one a read (``none``, ``ict`` or
   ``rct``), no
   plain call; both kernels against their twins at full size (no entry may
   differ), timed with CUDA events and from a CUDA graph beside their
   bounds (``roofline.j2k_idwt_bound``, ``j2k_colour_bound``) and the
   twins; each read split into the host's parse and tier-1, the copy, each
   level, the colour launch and the whole decode.
9. Multi-GPU (after phase 8, on its converted workspace): (a) the NCC
   kernel (tile and view-major launches, K=9) and the fused sorted path
   with one zero-extent source (the sharded pipeline's padding: all-zero
   image, identity camera, width = height = 0) against their plain
   versions at 3200x2130 on a band of 64 rows: no entry may differ, and
   the dummy scores cost_max everywhere; (b) ``mpmvs_torch.cli.main([...,
   "--devices", "all"])``: one process per card (``torch.cuda.
   device_count()`` ranks, NCCL), the default schedule with sky and
   fusion, views sharded with the JAX package's semantics. Checks median
   |d-gt|/gt < 1% on ground rows of every view, the PLY, and each rank's
   launches (its ``rank_<r>.json``) against the schedule; prints each
   depth map's digest and each rank's passes and collectives.

Each phase's line carries the seconds since the start. Before the last
three lines, a line gives each kernel's bound (the least time the card
could take at the timed shape) beside its time, and a ``codec`` JSON line
the decode and encode times, the IDCT and colour kernels' times beside
their bounds and the fixtures' mismatches, and a ``multi_gpu`` JSON line
phase 9's facts. The script fails if ``cv2``, ``yaml``, ``jax`` or
``mpmvs_tpu`` was imported. The last three lines of standard output are the card's name and power limit (``nvidia-smi``), a
JSON object describing each kernel (and each form of a kernel that has
several, with its launches on the path that reads it), and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``mpmvs_torch`` package beside this file, the script exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H_FULL, W_FULL = 2130, 3200   # the reference's max_image_size operating point
N_SRC = 10                    # sources per reference view (bench.py's point)
PHASE2_ROWS = 64              # band rows of the kernel-vs-plain check
MISMATCH_TOL = 1e-3           # max fraction of entries differing by > 1e-4
ESTIMATED = (0, 1, 2)         # views estimated in phases 4 and 6
SKY_ROWS = H_FULL // 5        # top rows painted sky blue before phase 5
SKY_BGR = (235.0, 180.0, 135.0)
GROUND_MARGIN = 24            # rows below the band left out of depth checks
BILATERAL_ERR_TOL = 1e-5      # max |kernel - plain| of the refined map
BILATERAL_MASK_TOL = 1e-4     # max fraction of thresholded pixels differing
SKY_FRAC_TOL = 0.02           # |sky fraction - painted fraction| per view
# NCC launches per estimated view of the full path, from the schedule as
# stated (one band of 2130 rows in every mode, asserted in main):
#   photometric: 1 init + 3 scales x 3 iterations x 2 colours x 2 calls
#   geom_0:      1 init + 2 iterations x 2 colours x 2 calls
#   prior run:   1 init + 3 iterations x 2 colours x 2 calls
#   geom_1:      1 init + 2 iterations x 2 colours x 2 calls
NCC_PHOTOMETRIC, NCC_GEOM, NCC_PRIOR = 1 + 3 * 3 * 2 * 2, 1 + 2 * 2 * 2, \
    1 + 3 * 2 * 2
# Geometric-cost launches per geom band step: one K=9 (8 candidates, the
# current plane), one K=5 (the 5 refinement trials); per geom pass of an
# estimated view (the prior sub-run has no geometric term): 2 iterations x
# 2 colours x 1 band x those
GEOM_PER_STEP = 2
GEOM_PER_PASS = 2 * 2 * GEOM_PER_STEP
# Launches of one photometric solve with the reference's search semantics
# (phase 7; tools.ab_deviations.REFERENCE), one band of H_FULL rows: with
# sampler="sorted", the key kernel and the fused sorted kernel once per
# source view for the init field and for each of the 2 random trials of
# every band step (3 scales x 3 iterations x 2 colours), the NCC kernel
# twice per step (K=9 candidates, K=3 trials); with "auto", the NCC kernel
# as in phase 4.
FUSED_SORTED = N_SRC + 3 * 3 * 2 * 2 * N_SRC
NCC_SORTED, NCC_AUTO = 3 * 3 * 2 * 2, 1 + 3 * 3 * 2 * 2
# Phase 8: 4 views, each the others' source (S = 3), one band in every
# mode; colours tinted so the chroma is not flat
FILES_VIEWS = 4
# each view's source: a .JPG (the card's encoder), an 8-bit RGB TIFF (LZW,
# predictor 2, strips of 16 rows), a 16-bit RGB PNG and a YCCK JPEG
# (YCCK_SOURCE, named .jpeg: the converter copies only *.jpg)
FILES_SOURCES = ("JPG", "tif", "png16", "ycck")
TIFF_ROWS_PER_STRIP = 16
FILES_TINT = (0.85, 1.0, 1.1)
# phase 8's YCCK source (tests/data/jpeg/make_ycck_source.py); what cv2
# makes of it is recorded beside it (cv2.json, by make_fixtures.py)
# phase 8d: a JPEG-compressed TIFF source (phase 8b's source as cv2 reads
# it, YCbCr 4:2:0 in 134 strips of 16 rows under one JPEGTables tag), and
# the small YCbCr, BMP and PNM sources read in the same counted run
TIFF_JPEG_SOURCE = os.path.join(HERE, "tests", "data", "tiff", "conversion",
                                "plane_3200x2130_jpeg.tif")
RASTER_SOURCES = ("tiff/ycbcr22_deflate.tif", "bmp/rgb565_bitfields.bmp",
                  "bmp/bgr24_topdown.bmp", "bmp/rle8.bmp", "pnm/p6_16.ppm")
WEBP_SOURCE = os.path.join(HERE, "tests", "data", "webp", "conversion",
                           "plane_3200x2130.webp")
YCCK_SOURCE = os.path.join(HERE, "tests", "data", "jpeg", "conversion",
                           "ycck_3200x2130.jpg")
# phase 8c's lossless source (the lossy one as cv2 reads it, re-encoded
# lossless: tests/data/webp/make_conversion.py) and an animated fixture
# whose lossless first frame sits at (4, 8) on a 60x50 canvas
# (tests/data/webp/make_lossless.py; cv2's arrays beside it)
LOSSLESS_SOURCE = os.path.join(HERE, "tests", "data", "webp", "conversion",
                               "plane_3200x2130_lossless.webp")
# phase 8e: an arithmetic-coded 4:2:0 JPEG of phase 8b's source as cv2 reads
# it (tests/data/jpeg/make_arith_lossless.py), and two lossless streams of
# the same pixels written here by tests/data/jpeg/jpeg_file.py; cv2's hashes
# of all three in cv2.json beside the first
JP2_CONVERSION = os.path.join(HERE, "tests", "data", "jp2", "conversion")
JP2_SOURCES = {"lossless": "plane_3200x2130_lossless.jp2",
               "97_rpcl": "plane_3200x2130_97_rpcl.jp2",
               "53_rct": "plane_3200x2130_53_rct.jp2"}
CUT_SOURCE = os.path.join(HERE, "tests", "data", "jpeg", "conversion",
                          "plane_3200x2130_progressive_cut.jpg")
ARITH_SOURCE = os.path.join(HERE, "tests", "data", "jpeg", "conversion",
                            "plane_3200x2130_arith.jpg")
JPEG_FILE = os.path.join(HERE, "tests", "data", "jpeg", "jpeg_file.py")
LOSSLESS_STREAMS = {"lossless_p1_restart16": {"predictor": 1,
                                              "restart_rows": 16},
                    "lossless_p7": {"predictor": 7}}
ANIMATED_FIXTURE = os.path.join(HERE, "tests", "data", "webp", "lossless",
                                "offset_lossless_flags1.webp")
CAM_TOL = 1e-5   # converted cams vs the scene's, relative
FILES_PREVIEWS = ["costs.jpg", "depths.jpg", "normals.jpg", "skymask.jpg",
                  "skymask_fuse.jpg", "skymask_refine.jpg",
                  "triangulation.png"]
# The NCC kernel's times before its redesign (PERF.md section 6; NVIDIA
# H100 80GB HBM3 at 700 W): K=9 at the band shape, K=1 on the coherent
# init field; K=5 on a full-range field was not timed then.
NCC_MS_BEFORE = {"K=9 gt": "61.87-62.2 ms",
                 "K=5 full-range": "not measured", "K=1 init": "17.2 ms"}


_START = time.perf_counter()


def log(msg: str):
    """Print a line; a phase's line carries the seconds since the start."""
    if msg.startswith("phase "):
        msg = f"{msg} [{time.perf_counter() - _START:.0f} s]"
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def differs(a, b):
    """Entries that differ by > 1e-4; a non-finite entry differs unless both
    are NaN or both the same infinity."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    same = (torch.isnan(a) & torch.isnan(b)) | (a == b)
    return torch.where(fin, (a - b).abs() > 1e-4, ~same)


def compare(a, b):
    """(fraction of entries differing by > 1e-4, max |a - b| over entries
    finite in both)."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    diff = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
    return differs(a, b).float().mean().item(), diff.max().item()


def differing(a, b):
    """(entries that differ, largest |a - b|) of two integer tensors of one
    shape, the kernel's and its plain version's."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes {tuple(a.shape)} and {tuple(b.shape)}")
    d = (a.long() - b.long()).abs()
    return int((d > 0).sum()), int(d.max())


def state_diff(a, b, mask):
    """(fraction of the masked pixels whose plane, cost or view selection
    differ between two PatchMatchStates, max |cost diff|)."""
    bad = (differs(a.plane, b.plane).any(-1) | differs(a.cost, b.cost)
           | (a.sel != b.sel)) & mask
    frac = bad.float().sum().item() / mask.float().sum().item()
    return frac, compare(a.cost, b.cost)[1]


def view_sel():
    """pair lists of the 11-view scene: ESTIMATED views take all others as
    sources; the rest are sources only."""
    V = N_SRC + 1
    return [[j for j in range(V) if j != i] if i in ESTIMATED else []
            for i in range(V)]


def paint_sky(scene):
    """Paint the top SKY_ROWS of every view flat sky blue (colours) and its
    grey (images, cv2's BGR -> grey weights), in place, as the sky tests of
    the JAX package do (tests/test_models.py:93-95)."""
    b, g, r = SKY_BGR
    scene.colors[:, :SKY_ROWS] = SKY_BGR
    scene.images[:, :SKY_ROWS] = 0.114 * b + 0.587 * g + 0.299 * r


def make_scene():
    """The 3200x2130, 1+10-view synthetic plane scene (host arrays)."""
    from mpmvs_torch.utils.synthetic import make_plane_scene

    t0 = time.perf_counter()
    scene = make_plane_scene(num_views=N_SRC + 1, height=H_FULL,
                             width=W_FULL, seed=0)
    log(f"scene: {N_SRC + 1} views at {W_FULL}x{H_FULL} in "
        f"{time.perf_counter() - t0:.1f} s")
    return scene


def band_inputs(data, params, scale: int, y0: int, rows: int, phase: int):
    """Reference side and packed coordinates of one band, as _band_step
    builds them."""
    from mpmvs_torch.ops.ncc import ncc_refside
    from mpmvs_torch.ops.packing import packed_coords
    from mpmvs_torch.ops.propagation import _pad_rows, step_halo

    halo = step_halo(scale)
    H, W = data.ref_img.shape
    ref_pad = _pad_rows(data.ref_img, halo, halo)
    refside = ncc_refside(ref_pad[y0:y0 + rows + 2 * halo], halo, rows,
                          params.tap_offsets(scale), params.sigma_spatial,
                          params.sigma_color, pack_phase=phase)
    x_p, y_p = packed_coords(y0, rows, W // 2, phase, device=data.ref_img.device)
    return refside, x_p, y_p


def test_planes(data, scene, params, kind: str, K: int, x_p, y_p, key):
    """K plane fields at the packed pixels: the ground-truth plane with
    slightly scaled depths, or independent random planes."""
    import torch
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf

    dev = x_p.device
    if kind == "random":
        keys = tf.split(key, K)
        return torch.stack([pmrand.random_plane_field(
            keys[k], data.K_ref, x_p, y_p, data.depth_min, data.depth_max)
            for k in range(K)])
    gt = torch.as_tensor(scene.gt_depth[0], device=dev)
    d = gt[y_p.long(), x_p.long()]
    n_world = torch.as_tensor(scene.gt_normal_world, device=dev)
    n_cam = geo.normal_world_to_cam(data.R_ref, n_world.expand(d.shape + (3,)))
    return torch.stack([geo.plane_from_depth_normal(
        data.K_ref, x_p, y_p, d * (1.0 + 0.002 * k), n_cam) for k in range(K)])


def phase_kernel_vs_plain(data, scene, params, band_rows: int):
    """Phase 2. Returns (worst mismatch fraction, max abs err, kernel ms,
    plain ms) with the times at the main path's band shape."""
    import torch
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc import ncc_refside
    from mpmvs_torch.ops.ncc_cuda import (ncc_eval_multi, ncc_eval_multi_plain)
    from mpmvs_torch.ops.propagation import _pad_rows, step_halo
    from mpmvs_torch.solver import _init_plane
    from mpmvs_torch.utils.roofline import ncc_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    args = (data.src_imgs, data.src_widths, data.src_heights, data.A, data.b,
            data.K_ref)
    worst, max_err = 0.0, 0.0
    key = tf.PRNGKey(7, device=data.ref_img.device)
    for scale in (0, 2):
        offs = params.tap_offsets(scale)
        cap = params.cap_radius(scale)
        refside, x_p, y_p = band_inputs(data, params, scale, H_FULL // 4 * 2,
                                        PHASE2_ROWS, 0)
        for kind in ("gt", "random"):
            for K in (1, 5, 9):
                planes = test_planes(data, scene, params, kind, K, x_p, y_p,
                                     tf.fold_in(key, 10 * scale + K))
                want = ncc_eval_multi_plain(refside, *args, planes, x_p, y_p,
                                            offs, params.cost_max, cap)
                for launch in ("tile", "view-major"):
                    got = ncc_eval_multi(refside, *args, planes, x_p, y_p,
                                         offs, params.cost_max, cap,
                                         scattered=launch == "view-major")
                    torch.cuda.synchronize()
                    frac, err = compare(got, want)
                    unequal = int((~((got == want) | (torch.isnan(got)
                                                      & torch.isnan(want))))
                                  .sum().item())
                    valid = (want < params.cost_max).float().mean().item()
                    log(f"  scale {scale} {kind:6s} K={K} {launch:10s}: "
                        f"frac>1e-4 {frac:.3e} max|diff| {err:.3e}, entries "
                        f"not bit-equal {unequal} of {got.numel()} "
                        f"(cost<{params.cost_max} in {valid:.3f})")
                    worst, max_err = max(worst, frac), max(max_err, err)
    if worst > MISMATCH_TOL:
        raise AssertionError(f"kernel vs plain: {worst:.3e} of entries "
                             f"differ by > 1e-4 (limit {MISMATCH_TOL})")

    # S = 20, the default max_source_images: the tile launch runs sources
    # in groups of NCC_VIEWS_MAX = 10 (csrc/ncc_eval.cu), so this takes two.
    # The 10 sources twice over, K=9 at scale 0 on the band's packed pixels
    offs = params.tap_offsets(0)
    refside, x_p, y_p = band_inputs(data, params, 0, 0, band_rows, 0)
    planes = test_planes(data, scene, params, "gt", 9, x_p, y_p, key)
    args20 = tuple(torch.cat([a, a]) for a in args[:5]) + (data.K_ref,)
    want = ncc_eval_multi_plain(refside, *args20, planes, x_p, y_p, offs,
                                params.cost_max, params.cap_radius(0))
    for launch in ("tile", "view-major"):
        got = ncc_eval_multi(refside, *args20, planes, x_p, y_p, offs,
                             params.cost_max, params.cap_radius(0),
                             scattered=launch == "view-major")
        torch.cuda.synchronize()
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        n_diff = int((~same).sum().item())
        frac, err = compare(got, want)
        log(f"  S=20 K=9 scale 0 {band_rows}x{W_FULL // 2} {launch:10s}: "
            f"entries not bit-equal {n_diff} of {got.numel()}, max|diff| "
            f"{err:.3e}; second group equals the first "
            f"{bool(torch.equal(got[:, 10:], got[:, :10]))}")
        worst, max_err = max(worst, frac), max(max_err, err)
        if n_diff:
            raise AssertionError(f"S=20 kernel vs plain ({launch}): {n_diff}"
                                 f" entries differ")
        del got
    del refside, planes, args20, want

    # timing at the main path's band shape: K=9 candidates at scale 0
    offs = params.tap_offsets(0)
    refside, x_p, y_p = band_inputs(data, params, 0, 0, band_rows, 0)
    planes = test_planes(data, scene, params, "gt", 9, x_p, y_p, key)
    call = lambda fn: (lambda: fn(refside, *args, planes, x_p, y_p, offs,
                                  params.cost_max, params.cap_radius(0)))
    ms_kernel = cuda_time_ms(call(ncc_eval_multi), reps=5)
    ms_plain = cuda_time_ms(call(ncc_eval_multi_plain), reps=2)
    taps = 9 * N_SRC * band_rows * (W_FULL // 2) * len(offs)
    log(f"  timing K=9 S={N_SRC} {band_rows}x{W_FULL // 2}: kernel "
        f"{ms_kernel:.3f} ms ({taps / ms_kernel / 1e6:.3f} Gtaps/s), plain "
        f"{ms_plain:.3f} ms ({taps / ms_plain / 1e6:.3f} Gtaps/s)")

    # the kernel alone at the band step's K=5 trial call on a full-range
    # field, and at init scoring (K=1, every pixel, scale 2)
    src_bytes = 4 * N_SRC * H_FULL * W_FULL
    trials = test_planes(data, scene, params, "random", 5, x_p, y_p,
                         tf.fold_in(key, 5))
    ms_k5 = cuda_time_ms(lambda: ncc_eval_multi(
        refside, *args, trials, x_p, y_p, offs, params.cost_max,
        params.cap_radius(0), scattered=True), reps=5)
    del refside, planes, trials
    scale = params.max_scale
    halo = step_halo(scale)
    refside = ncc_refside(_pad_rows(data.ref_img, halo, halo), halo, H_FULL,
                          params.tap_offsets(scale), params.sigma_spatial,
                          params.sigma_color)
    x, y = geo.pixel_grid(H_FULL, W_FULL, device=x_p.device)
    init = _init_plane(data, params, key, "photometric")[None]
    ms_k1 = cuda_time_ms(lambda: ncc_eval_multi(
        refside, *args, init, x, y, params.tap_offsets(scale),
        params.cost_max, params.cap_radius(scale)), reps=5)
    del refside, init
    T = len(offs)
    for label, ms, K, P in (
            ("K=9 gt", ms_kernel, 9, band_rows * (W_FULL // 2)),
            ("K=5 full-range", ms_k5, 5, band_rows * (W_FULL // 2)),
            ("K=1 init", ms_k1, 1, H_FULL * W_FULL)):
        b_ms, b_by = ncc_bound(K, N_SRC, P, T, src_bytes, True)
        log(f"  NCC kernel {label}: {ms:.3f} ms "
            f"({K * N_SRC * P * T / ms / 1e6:.3f} Gtaps/s); bound "
            f"{b_ms:.3f} ms ({b_by}), {b_ms / ms:.3f} of it reached; before "
            f"the redesign (PERF.md): {NCC_MS_BEFORE[label]}")
    return worst, max_err, ms_kernel, ms_plain


def phase_half_iteration(data, params, band_rows: int, src_depths):
    """Phase 3, at full size and the solve's band rows, kernel vs plain from
    the same inputs and key: the K=1 initial scoring of every pixel, then
    one checkerboard_step at scales 2, 1 and 0. The scale-2 step is also
    timed with a constant-cost stand-in for the NCC (the eager glue alone).
    Then one geom step against ``src_depths``, geometric-cost kernel vs
    plain twin. Returns the max |cost diff| over the NCC comparisons and
    the initial state."""
    import torch
    from mpmvs_torch.ops import geom_cost, geom_cost_cuda, propagation
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc_cuda import (COUNTS, ncc_eval_multi,
                                          ncc_eval_multi_plain)
    from mpmvs_torch.ops.propagation import checkerboard_step
    from mpmvs_torch.solver import initial_state
    from mpmvs_torch.utils.trace import cuda_time_ms

    H, W = data.ref_img.shape
    dev = data.ref_img.device
    key = tf.PRNGKey(3, device=dev)
    state = initial_state(data, params, key, band_rows, ncc_eval_multi)
    plain_init = initial_state(data, params, key, band_rows,
                               ncc_eval_multi_plain)
    torch.cuda.synchronize()
    frac, max_err = state_diff(state, plain_init,
                               torch.ones(H, W, dtype=torch.bool, device=dev))
    del plain_init
    log(f"  initial scoring (K=1) {W}x{H}, S={N_SRC}, bands of {band_rows} "
        f"rows: pixels whose cost or views differ kernel vs plain {frac:.3e}"
        f", max|cost diff| {max_err:.3e}")
    if frac > MISMATCH_TOL:
        raise AssertionError(f"initial scoring kernel vs plain differ on "
                             f"{frac:.3e} of pixels (limit {MISMATCH_TOL})")
    k_step = tf.fold_in(key, 1)

    def glue_only(refside, src, w, h, A, b, K, planes, x, y, offs, cmax, cap,
                  scattered=False):
        return torch.full((planes.shape[0], src.shape[0]) + tuple(x.shape),
                          0.5, device=x.device)

    def step(fn, scale=2):
        return checkerboard_step(state, data, params, scale, 0, 0, k_step,
                                 band_rows=band_rows, ncc_multi=fn)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = {}
    for name, fn in (("kernel", ncc_eval_multi), ("glue", glue_only)):
        ms[name] = cuda_time_ms(lambda: step(fn), reps=3)
    peak = torch.cuda.max_memory_allocated() - base
    # the plain step once, timed and then compared with the kernel's below
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain_steps = {2: step(ncc_eval_multi_plain)}
    end.record()
    torch.cuda.synchronize()
    ms["plain"] = start.elapsed_time(end)
    log(f"  half-iteration {W}x{H}, S={N_SRC}, bands of {band_rows} rows: "
        f"kernel {ms['kernel']:.1f} ms, plain {ms['plain']:.1f} ms (one "
        f"run), glue "
        f"alone {ms['glue']:.1f} ms -> NCC share with kernel "
        f"{(ms['kernel'] - ms['glue']) / ms['kernel']:.3f}; peak extra "
        f"memory {peak / 2**30:.3f} GiB")
    active = ((torch.arange(H, device=dev)[:, None]
               + torch.arange(W, device=dev)[None, :]) % 2) == 0
    for scale in (2, 1, 0):
        a = step(ncc_eval_multi, scale)
        b = (plain_steps.pop(scale) if scale in plain_steps
             else step(ncc_eval_multi_plain, scale))
        torch.cuda.synchronize()
        frac, err = state_diff(a, b, active)
        adopted = ((a.cost != state.cost) & active).float().sum().item() / (
            active.float().sum().item())
        max_err = max(max_err, err)
        log(f"  step at scale {scale}: pixels whose adopted plane, cost or "
            f"views differ kernel vs plain {frac:.3e}, max|cost diff| "
            f"{err:.3e} (cost changed on {adopted:.3f} of active pixels)")
        if frac > MISMATCH_TOL:
            raise AssertionError(f"half-iteration at scale {scale}: kernel "
                                 f"vs plain differ on {frac:.3e} of pixels "
                                 f"(limit {MISMATCH_TOL})")
    # one geom half-iteration against the sources' true depths, through
    # the geometric-cost kernel and through its plain twin (the NCC kernel
    # in both arms); the twin stands in where the solver looks the
    # function up, as the bench's controls do
    gdata = data._replace(src_depths=src_depths)
    gstep = lambda: checkerboard_step(state, gdata, params, 0, 0, 0, k_step,
                                      geom=True, band_rows=band_rows)
    geom_cost_cuda.COUNTS.reset()
    a = gstep()  # also the warm-up of the geom path
    torch.cuda.synchronize()
    launches = geom_cost_cuda.COUNTS.kernel
    start.record()
    gstep()
    end.record()
    torch.cuda.synchronize()
    ms["geom kernel"] = start.elapsed_time(end)
    saved = propagation.geom_consistency_cost
    propagation.geom_consistency_cost = geom_cost.geom_consistency_cost_plain
    try:
        start.record()
        b = gstep()
        end.record()
        torch.cuda.synchronize()
    finally:
        propagation.geom_consistency_cost = saved
    ms["geom plain"] = start.elapsed_time(end)
    frac, err = state_diff(a, b, active)
    n_geom = int((a.geom_cost != b.geom_cost).sum().item())
    log(f"  geom step at scale 0: pixels whose adopted plane, cost or views "
        f"differ, geometric-cost kernel vs plain twin {frac:.3e}, geometric "
        f"costs differing {n_geom}; {launches} geometric-cost launches; "
        f"step {ms['geom kernel']:.1f} ms with the kernel, "
        f"{ms['geom plain']:.1f} ms with the twin (one run each)")
    if frac or n_geom or launches != GEOM_PER_STEP:
        raise AssertionError(f"geom step: kernel vs plain twin differ on "
                             f"{frac:.3e} of pixels, {n_geom} geometric "
                             f"costs; {launches} launches (expected "
                             f"{GEOM_PER_STEP})")
    COUNTS.reset()
    return max_err, state


def phase_geom_cost(data, scene, params, band_rows: int, src_depths, state):
    """Phase 3b: the geometric-cost kernel against its plain twin at the
    geom band shape, K = 1 (phase 3's init field), K = 5 (the trials'
    call: two random fields, three scaled true planes) and K = 9 (the
    candidates' call: 8 scaled true planes and the init field), with the
    solve's camera table. Returns a dict of what the kernels line needs."""
    import torch
    from mpmvs_torch.ops import geom_cost, geom_cost_cuda
    from mpmvs_torch.ops.packing import pack_quincunx, packed_coords
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.utils.roofline import geom_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    dev = data.ref_img.device
    x_p, y_p = packed_coords(0, band_rows, W_FULL // 2, 0, device=dev)
    init = torch.movedim(pack_quincunx(torch.movedim(state.plane, -1, 0), 0),
                         0, -1)
    gt = test_planes(data, scene, params, "gt", 8, x_p, y_p,
                     tf.PRNGKey(5, device=dev))
    rnd = test_planes(data, scene, params, "random", 2, x_p, y_p,
                      tf.PRNGKey(6, device=dev))
    cams = (src_depths, data.src_widths, data.src_heights, data.K_ref,
            data.R_ref, data.C_ref, data.t_ref, data.K_src, data.R_src,
            data.t_src, data.C_src)
    out = {"max_abs_err": 0.0, "ms": {}, "plain_ms": {}, "bound": {},
           "registers": {}}
    N = band_rows * (W_FULL // 2)
    depth_bytes = src_depths.numel() * 4
    wide = geom_cost_cuda.wide_index(*src_depths.shape)
    fields = ((1, init), (5, torch.stack([rnd[0], gt[0], rnd[1], gt[1],
                                          gt[2]])),
              (9, torch.cat([gt, init[None]])))
    for K, planes in fields:
        call = lambda fn: fn(*cams, planes, x_p, y_p, params.geom_cost_max,
                             cams=data.geom_cams)
        got = call(geom_cost.geom_consistency_cost)
        want = call(geom_cost.geom_consistency_cost_plain)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum().item())
        err = (got - want).abs().max().item()
        capped = (want == params.geom_cost_max).float().mean().item()
        del got, want
        ms = cuda_time_ms(lambda: call(geom_cost.geom_consistency_cost),
                          reps=20)
        plain_ms = cuda_time_ms(
            lambda: call(geom_cost.geom_consistency_cost_plain), reps=2)
        b_ms, b_by = geom_bound(K, N_SRC, N, depth_bytes)
        attrs = geom_cost_cuda.kernel_attributes(K, wide)
        log(f"  K={K} S={N_SRC} {band_rows}x{W_FULL // 2}: entries "
            f"differing {n_diff} of {N_SRC * K * N}, max|diff| {err:.3e} "
            f"(capped entries {capped:.3f}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms; bound {b_ms:.4f} ms ({b_by}), "
            f"{b_ms / ms:.3f} of it reached; {attrs['fields_held']} fields "
            f"a thread, {attrs['registers']} registers, "
            f"{attrs['local_bytes']} B spilled, {64 if wide else 32}-bit "
            f"indices")
        if n_diff:
            raise AssertionError(f"geometric-cost kernel vs plain at K={K}:"
                                 f" {n_diff} entries differ")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["ms"][K], out["plain_ms"][K] = ms, plain_ms
        out["bound"][K] = (b_ms, b_by)
        out["registers"][K] = attrs["registers"]
    return out


def phase_pipeline(scene, params):
    """Phase 4: the photometric slice through Pipeline at full size.
    Returns the kernel launches counted during the run."""
    import numpy as np
    import torch
    from mpmvs_torch.io import read_dmb, read_ply_binary
    from mpmvs_torch.ops.ncc_cuda import COUNTS
    from mpmvs_torch.params import ConfigParams
    from mpmvs_torch.pipeline import Pipeline

    # three estimated views: with two, each would be the other's only (and
    # so last) fusion source, which the reference's last-source rule never
    # counts, and the cloud would be empty
    estimable = ESTIMATED
    S = N_SRC
    # the schedule as stated, not as the banding code computes it: the H100
    # band budget (8192 MB) holds 3200x2130 at S=10 in one band of all
    # H_FULL rows, so per view 1 init-scoring call (K=1) + scales x
    # iterations x 2 colours x 1 band x 2 calls (K=9 candidates, K=5 trials)
    expected = len(estimable) * (
        1 + (params.max_scale + 1) * params.max_iterations * 2 * 1 * 2)

    with tempfile.TemporaryDirectory(prefix="mpmvs_smoke_") as out:
        cfg = ConfigParams(input_folder=out, output_folder=out,
                           geom_iterations=0, planar_prior=False,
                           max_source_images=S)
        pipe = Pipeline(cfg, params, device="cuda", write_jpg=False)
        pipe.load_arrays(scene.images, scene.colors, scene.cameras,
                         view_sel())
        torch.cuda.reset_peak_memory_stats()
        COUNTS.reset()
        t0 = time.perf_counter()
        ply = pipe.run(log=lambda m: log("  " + m))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = COUNTS.kernel, COUNTS.plain
        peak = torch.cuda.max_memory_allocated()

        taps_view = (H_FULL * W_FULL * S * 36
                     + params.max_iterations * (params.max_scale + 1) * 2
                     * 14 * S * 36 * (H_FULL * W_FULL // 2))
        for v in estimable:
            d = read_dmb(os.path.join(out, "MPMVS", f"2333_{v:08d}",
                                      "depths.dmb"))
            if d.shape != (H_FULL, W_FULL) or not np.isfinite(d).all():
                raise AssertionError(f"view {v}: depth map not finite/shaped")
            gt = scene.gt_depth[v]
            rel = float(np.median(np.abs(d - gt) / gt))
            sec = sum(t for u, stage, t in pipe.solve_log if u == v)
            log(f"  view {v}: solve {sec:.2f} s, {taps_view / sec / 1e9:.3f} "
                f"Gtaps/s, median |d-gt|/gt {rel:.5f}")
            if not rel < 0.01:
                raise AssertionError(f"view {v}: median rel error {rel}")
        pts, _, _ = read_ply_binary(ply)
        log(f"  run {wall:.1f} s; PLY {len(pts)} points; band rows {H_FULL}; "
            f"peak memory {peak / 2**30:.3f} GiB; kernel launches {launches} "
            f"(schedule implies {expected}); plain calls {plain}")
        if len(pts) == 0:
            raise AssertionError("fused PLY has no points")
    if launches != expected:
        raise AssertionError(f"kernel launched {launches} times, schedule "
                             f"implies {expected}")
    if plain != 0:
        raise AssertionError(f"plain NCC ran {plain} times on the main path")
    return launches


def phase_bilateral(scene):
    """Phase 5. Returns a dict of what the kernels line needs: max |diff|
    over the inputs, and per form (float, table) and for the table builder
    the kernel ms, plain ms and entries equal to plain."""
    import torch
    import torch.nn.functional as F
    from mpmvs_torch.models import sky
    from mpmvs_torch.ops import bilateral_cuda as bc
    from mpmvs_torch.utils.trace import cuda_time_ms

    dev = torch.device("cuda", 0)
    net = sky.load_sky_net(device=dev)
    bgr = torch.as_tensor(scene.colors[0], device=dev)
    prob = sky.segment_sky(bgr, net)
    gen = torch.Generator(device=dev).manual_seed(5)
    # structured random: colour blocks with sharp edges, per-pixel noise,
    # and a smooth random probability
    blocks = torch.rand((1, 3, 54, 80), generator=gen, device=dev) * 235.0
    rbgr = (F.interpolate(blocks, size=(H_FULL, W_FULL), mode="nearest")[0]
            .permute(1, 2, 0) + torch.rand((H_FULL, W_FULL, 3), generator=gen,
                                           device=dev) * 20.0).contiguous()
    logits = torch.randn((1, 1, 27, 40), generator=gen, device=dev) * 3.0
    rprob = torch.sigmoid(F.interpolate(logits, size=(H_FULL, W_FULL),
                                        mode="bilinear")[0, 0]).contiguous()
    # the guide as a workspace's 8-bit image gives it: the table form
    bgr8 = to_8bit(bgr)
    out = {"max_abs_err": 0.0, "equal": {}}
    for name, (g, p), form in (
            ("guide image + net probability", (bgr, prob), "float"),
            ("structured random", (rbgr, rprob), "float"),
            ("8-bit guide + net probability", (bgr8, prob), "table")):
        bc.COUNTS.reset()
        got = bc.bilateral_refine(g, p)
        forms = dict(bc.COUNTS.forms)
        want = bc.bilateral_refine_plain(g, p)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        frac = ((got > sky.THRESHOLD) != (want > sky.THRESHOLD)).float(
        ).mean().item()
        bitwise = (got == want).float().mean().item()
        log(f"  {name}: form {forms}, max|diff| {err:.3e}, equal entries "
            f"{bitwise:.6f}, thresholded pixels differing {frac:.3e} (mask "
            f"fraction {(want > sky.THRESHOLD).float().mean().item():.4f})")
        if not err <= BILATERAL_ERR_TOL or not frac <= BILATERAL_MASK_TOL:
            raise AssertionError(f"bilateral kernel vs plain on {name}: "
                                 f"max|diff| {err} (limit "
                                 f"{BILATERAL_ERR_TOL}), mask fraction "
                                 f"{frac} (limit {BILATERAL_MASK_TOL})")
        if bitwise != 1.0 or forms != {form: 1}:
            raise AssertionError(f"bilateral kernel vs plain on {name}: "
                                 f"equal entries {bitwise}, forms {forms} "
                                 f"(expected 1.0 through the {form} form)")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["equal"][form] = min(out["equal"].get(form, 1.0), bitwise)
    table = bc.colour_table_kernel(bc.SIGMA_COLOR, dev)
    plain_table = bc.colour_table_plain(bc.SIGMA_COLOR, dev)
    n_table = int((table != plain_table).sum().item())
    out["table_max_abs_err"] = (table - plain_table).abs().max().item()
    log(f"  colour table ({bc.TABLE_SIZE} entries) vs plain: {n_table} "
        f"differ")
    if n_table:
        raise AssertionError(f"colour table: {n_table} entries differ")

    def run(g, form):  # one form, forced, on contiguous inputs
        g, p = g.contiguous(), prob.contiguous()
        return lambda: bc._launch(g, p, bc.RADIUS, bc.SIGMA_SPATIAL,
                                  bc.SIGMA_COLOR, form)

    ms = {"float": cuda_time_ms(run(bgr, "float"), reps=10),
          "float 8-bit": cuda_time_ms(run(bgr8, "float"), reps=10),
          "table": cuda_time_ms(run(bgr8, "table"), reps=10),
          "table build": cuda_time_ms(
              lambda: bc.colour_table_kernel(bc.SIGMA_COLOR, dev), reps=10),
          "plain table": cuda_time_ms(
              lambda: bc.colour_table_plain(bc.SIGMA_COLOR, dev), reps=10),
          "plain": cuda_time_ms(lambda: bc.bilateral_refine_plain(bgr, prob),
                                reps=1),
          "plain 8-bit": cuda_time_ms(
              lambda: bc.bilateral_refine_plain(bgr8, prob), reps=1)}
    taps = H_FULL * W_FULL * (2 * bc.RADIUS + 1) ** 2
    log(f"  timing {W_FULL}x{H_FULL}, 37x37 taps: float form "
        f"{ms['float']:.3f} ms ({taps / ms['float'] / 1e6:.3f} Gtaps/s) on "
        f"the guide, {ms['float 8-bit']:.3f} ms on the 8-bit guide; table "
        f"form {ms['table']:.3f} ms ({taps / ms['table'] / 1e6:.3f} "
        f"Gtaps/s); plain {ms['plain']:.3f} / "
        f"{ms['plain 8-bit']:.3f} ms; table build {ms['table build']:.4f} "
        f"ms (plain {ms['plain table']:.4f})")
    out["ms"] = ms
    return out


def to_8bit(bgr):
    """``bgr`` rounded and clipped to the values of an 8-bit image, as
    ``cv2.imread`` gives a workspace's views to the pipeline."""
    import torch

    return torch.clamp(torch.round(bgr), 0.0, 255.0).contiguous()


def phase_full_path(scene, params):
    """Phase 6: the default schedule with sky masks through Pipeline.run,
    on colour images rounded to 8-bit values as a workspace's JPEGs give
    them. Returns the launches counted during the run: NCC kernel,
    bilateral kernel by form, bilateral table builds."""
    import numpy as np
    import torch
    from mpmvs_torch.io import read_ply_binary
    from mpmvs_torch.ops import bilateral_cuda, geom_cost_cuda, ncc_cuda
    from mpmvs_torch.params import ConfigParams
    from mpmvs_torch.pipeline import Pipeline

    ground = slice(SKY_ROWS + GROUND_MARGIN, H_FULL)
    errors = {}
    scene.colors[:] = np.clip(np.round(scene.colors), 0.0, 255.0)
    # the table is built once per process: this run builds it as a fresh
    # one does
    bilateral_cuda.colour_table.cache_clear()

    with tempfile.TemporaryDirectory(prefix="mpmvs_full_") as out:
        cfg = ConfigParams(input_folder=out, output_folder=out,
                           max_source_images=N_SRC, sky_seg=True)
        pipe = Pipeline(cfg, params, device="cuda", write_jpg=False)
        pipe.load_arrays(scene.images, scene.colors, scene.cameras,
                         view_sel())
        log(f"  schedule: {[tag for tag, _, _ in pipe.pass_schedule()]}, "
            f"sky masks, fusion")
        mark_done = pipe._mark_pass_done

        def check_pass(tag):
            """Depth accuracy of every estimated view on the non-sky rows,
            as the pass leaves it."""
            for v in ESTIMATED:
                d = pipe.views[v].result.depth[ground].cpu().numpy()
                gt = scene.gt_depth[v][ground]
                errors[(tag, v)] = float(np.median(np.abs(d - gt) / gt))
            mark_done(tag)

        pipe._mark_pass_done = check_pass
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ncc_cuda.COUNTS.reset()
        geom_cost_cuda.COUNTS.reset()
        bilateral_cuda.COUNTS.reset()
        bilateral_cuda.TABLE_COUNTS.reset()
        t0 = time.perf_counter()
        ply = pipe.run(log=lambda m: log("  " + m))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ncc = (ncc_cuda.COUNTS.kernel, ncc_cuda.COUNTS.plain)
        geom = (geom_cost_cuda.COUNTS.kernel, geom_cost_cuda.COUNTS.plain)
        bil = (bilateral_cuda.COUNTS.kernel, bilateral_cuda.COUNTS.plain)
        bil_forms = dict(bilateral_cuda.COUNTS.forms)
        tables = (bilateral_cuda.TABLE_COUNTS.kernel,
                  bilateral_cuda.TABLE_COUNTS.plain)
        peak = torch.cuda.max_memory_allocated()

        for (tag, v), rel in errors.items():
            log(f"  after {tag}: view {v} median |d-gt|/gt on rows "
                f"{ground.start}-{H_FULL - 1} {rel:.5f}")
        for v in ESTIMATED:
            secs = {stage: [round(t, 3) for u, st, t in pipe.solve_log
                            if u == v and st == stage]
                    for stage in ("photometric", "geom", "prior_build",
                                  "prior")}
            log(f"  view {v} seconds: {secs}")
        sky_s = pipe.timer.stats["sky_masks"].total
        fusion_s = pipe.timer.stats["fusion"].total
        n_sky = len(read_ply_binary(ply)[0])
        masks = {v: pipe.views[v].sky_mask for v in ESTIMATED}
        band = SKY_ROWS / H_FULL
        for v, m in masks.items():
            log(f"  view {v}: sky fraction {m.mean():.4f} (painted band "
                f"{band:.4f}); sky pixels below the band "
                f"{m[ground].mean():.2e}")
        for v in ESTIMATED:
            pipe.views[v].sky_mask = None
        n_all = len(read_ply_binary(pipe.fuse(log=lambda m: None))[0])
        n_prior = sum(stage == "prior" for _, stage, _ in pipe.solve_log)
        log(f"  run {wall:.1f} s (sky stage {sky_s:.2f} s for "
            f"{len(ESTIMATED)} views, fusion {fusion_s:.2f} s); peak memory "
            f"{peak / 2**30:.3f} GiB; PLY {n_sky} points with sky masks, "
            f"{n_all} without")

    bad = {k: e for k, e in errors.items() if not e < 0.01}
    if len(errors) != len(ESTIMATED) * len(pipe.pass_schedule()) or bad:
        raise AssertionError(f"median rel error >= 1% on non-sky rows: {bad}")
    off = {v: float(m.mean()) for v, m in masks.items()
           if not abs(m.mean() - band) < SKY_FRAC_TOL}
    if off:
        raise AssertionError(f"sky fractions {off} not within {SKY_FRAC_TOL}"
                             f" of the painted {band:.3f}")
    if not 0 < n_sky <= n_all:
        raise AssertionError(f"fusion: {n_sky} points with sky masks, "
                             f"{n_all} without")
    if n_prior < len(ESTIMATED):
        log(f"  prior build returned None for {len(ESTIMATED) - n_prior} "
            f"view(s): their {NCC_PRIOR} NCC launches drop out")
    expected = (len(ESTIMATED) * (NCC_PHOTOMETRIC + 2 * NCC_GEOM)
                + n_prior * NCC_PRIOR)
    geom_expected = len(ESTIMATED) * 2 * GEOM_PER_PASS
    log(f"  launches: NCC {ncc[0]} (schedule implies {expected}), plain NCC "
        f"{ncc[1]}; geometric cost {geom[0]} (schedule implies "
        f"{geom_expected}), plain {geom[1]}; bilateral {bil[0]} by form "
        f"{bil_forms} (one per estimated view: {len(ESTIMATED)}, table form "
        f"on 8-bit guides), plain bilateral {bil[1]}; table builds "
        f"{tables[0]}, plain {tables[1]}")
    if ncc != (expected, 0) or geom != (geom_expected, 0) or \
            bil != (len(ESTIMATED), 0) or \
            bil_forms != {"table": len(ESTIMATED)} or tables != (1, 0):
        raise AssertionError(f"launches (kernel, plain): NCC {ncc}, expected "
                             f"({expected}, 0); geometric cost {geom}, "
                             f"expected ({geom_expected}, 0); bilateral "
                             f"{bil} {bil_forms}, expected "
                             f"({len(ESTIMATED)}, 0) through the table form; "
                             f"table builds {tables}, expected (1, 0)")
    return ncc[0], geom[0], bil_forms, tables[0]


def phase_sorted(data, scene, params):
    """Phase 7: the sorted path (csrc/ncc_samples.cu) at 3200x2130 with 10
    sources, on view 0's full-range random init field. Returns a dict of
    what the kernels line and the log need."""
    import numpy as np
    import torch
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import ncc_cuda, ncc_sorted
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc import ncc_refside
    from mpmvs_torch.ops.packing import packed_coords
    from mpmvs_torch.ops.propagation import _pad_rows, step_halo
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.solver import _init_plane, solve_view
    from mpmvs_torch.tools.ab_deviations import REFERENCE
    from mpmvs_torch.tools.kernel_bench import (samples_chain_split,
                                                sorted_split)
    from mpmvs_torch.utils.roofline import (keys_bound, ncc_bound,
                                            samples_bound, sorted_bound)
    from mpmvs_torch.utils.trace import cuda_time_ms

    dev = data.ref_img.device
    H, W = data.ref_img.shape
    S, Hp, Wp = data.src_imgs.shape
    N = H * W
    scale = params.max_scale
    offs = params.tap_offsets(scale)
    T = len(offs)
    x, y = geo.pixel_grid(H, W, device=dev)
    xf, yf = x.reshape(N), y.reshape(N)
    key = tf.PRNGKey(11, device=dev)
    rand = pmrand.random_plane_field(key, data.K_ref, x, y, data.depth_min,
                                     data.depth_max)
    pf = rand.reshape(N, 4)
    coherent = _init_plane(data, params, key, "photometric")
    view = lambda s: (data.src_imgs[s], data.src_widths[s],
                      data.src_heights[s], data.A[s], data.b[s], data.K_ref)
    out = {}

    # (a) the raw-samples form vs its plain version, every view: the init
    # field at scale 2, cap off (the reference semantics) and at the
    # default cap; then, cap off, scale-0 taps on a full-range field over
    # the packed half-width pixels of one colour, the shape of a refinement
    # trial. The keys of every view: key kernel vs its plain version
    x_p, y_p = packed_coords(0, H, W // 2, 0, device=dev)
    trial = pmrand.random_plane_field(tf.PRNGKey(12, device=dev), data.K_ref,
                                      x_p, y_p, data.depth_min,
                                      data.depth_max)
    cases = [(f"init scale {scale}, cap {cap:g}", pf, xf, yf, offs, cap)
             for cap in (0.0, params.cap_radius(scale))]
    cases.append(("trial scale 0, cap 0", trial.reshape(-1, 4),
                  x_p.reshape(-1), y_p.reshape(-1), params.tap_offsets(0),
                  0.0))
    terms = ncc_sorted.view_terms(data.src_widths, data.src_heights, data.A,
                                  data.b, data.K_ref, dev)
    n_diff, n_keys, max_err, keys_err = 0, 0, 0.0, 0.0
    for label, pl, xs, ys, taps, cap in cases:
        flagged, before = [], n_diff
        for s in range(S):
            keys = ncc_sorted.view_keys_kernel(terms, s, pl, xs, ys, Hp, Wp)
            kdiff = (keys - ncc_sorted.bucket_keys_plain(
                data.A[s], data.b[s], data.K_ref, pl, xs, ys, Hp, Wp)).abs()
            n_keys += int((kdiff != 0).sum().item())
            keys_err = max(keys_err, float(kdiff.max().item()))
            perm = torch.sort(keys, stable=True).indices
            args = view(s) + (pl, xs, ys, perm, taps, cap)
            got = ncc_sorted.sample_view_vals_kernel(*args)
            want = ncc_sorted.sample_view_vals_plain(*args)
            torch.cuda.synchronize()
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
            n_diff += int((~same).sum().item())
            max_err = max(max_err, compare(got, want)[1])
            flagged.append(want[-1].mean().item())
            del got, want
        log(f"  (a) raw-samples form vs plain, {label}, {S} views, "
            f"{len(taps) + 1} x {pl.shape[0]} entries each: "
            f"{n_diff - before} differ, max|diff| {max_err:.3e}; flagged "
            f"pixels {min(flagged):.3f}-{max(flagged):.3f}")
    log(f"  (a) key kernel vs plain, {len(cases)} fields x {S} views: "
        f"{n_keys} keys differ")
    out["samples_max_abs_err"], out["keys_max_abs_err"] = max_err, keys_err
    if n_diff or n_keys:
        raise AssertionError(f"raw-samples form vs plain: {n_diff} entries "
                             f"differ; keys: {n_keys} differ")

    # (a2) the fused form (the path's) vs the plain chain (keys, sort, raw
    # samples, un-permute, ZNCC) on the same fields, every view
    halo = step_halo(scale)
    refside = ncc_refside(_pad_rows(data.ref_img, halo, halo), halo, H, offs,
                          params.sigma_spatial, params.sigma_color)
    refside0 = ncc_refside(_pad_rows(data.ref_img, step_halo(0),
                                     step_halo(0)), step_halo(0), H,
                           params.tap_offsets(0), params.sigma_spatial,
                           params.sigma_color, pack_phase=0)
    common = (refside, data.src_imgs, data.src_widths, data.src_heights,
              data.A, data.b, data.K_ref)
    fused_cases = [(f"init scale {scale}, cap {cap:g}", common, rand, x, y,
                    offs, cap) for cap in (0.0, params.cap_radius(scale))]
    fused_cases.append(("trial scale 0, cap 0", (refside0,) + common[1:],
                        trial, x_p, y_p, params.tap_offsets(0), 0.0))
    n_fused, fused_err = 0, 0.0
    for label, com, pl, xs, ys, taps, cap in fused_cases:
        want = ncc_sorted.ncc_eval_sorted_plain(*com, pl, xs, ys, taps,
                                                params.cost_max, cap)
        got = ncc_sorted.ncc_eval_sorted_kernel(*com, pl, xs, ys, taps,
                                                params.cost_max, cap)
        torch.cuda.synchronize()
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        n = int((~same).sum().item())
        n_fused += n
        fused_err = max(fused_err, compare(got, want)[1])
        log(f"  (a2) fused form vs plain chain, {label}, "
            f"{tuple(got.shape)}: {n} entries differ, max|diff| "
            f"{fused_err:.3e} (cost<{params.cost_max} in "
            f"{(want < params.cost_max).float().mean().item():.3f})")
        del got, want
    out["fused_max_abs_err"] = fused_err
    del trial, x_p, y_p, refside0
    if n_fused:
        raise AssertionError(f"fused sorted kernel vs plain chain: "
                             f"{n_fused} entries differ")

    # (b) the sorted path vs the NCC kernel at K=1 on the full-range field
    got = ncc_sorted.ncc_eval_sorted(*common, rand, x, y, offs,
                                     params.cost_max, 0.0)
    want = ncc_cuda.ncc_eval_one(*common, rand, x, y, offs, params.cost_max,
                                 0.0, scattered=True)
    torch.cuda.synchronize()
    frac, err = compare(got, want)
    out["sorted_vs_k1"] = (frac, err)
    log(f"  (b) sorted path vs NCC kernel K=1, full-range field: frac>1e-4 "
        f"{frac:.3e}, max|diff| {err:.3e} (cost<{params.cost_max} in "
        f"{(want < params.cost_max).float().mean().item():.3f})")
    del got, want
    if frac > MISMATCH_TOL:
        raise AssertionError(f"sorted path vs NCC kernel: {frac:.3e} of "
                             f"entries differ by > 1e-4 (limit "
                             f"{MISMATCH_TOL})")

    # (c) CUDA-event times over all 10 views, warmed up
    cap_def = params.cap_radius(scale)
    ms_coh = cuda_time_ms(lambda: ncc_cuda.ncc_eval_one(
        *common, coherent, x, y, offs, params.cost_max, cap_def), reps=5)
    ms_rand = cuda_time_ms(lambda: ncc_cuda.ncc_eval_one(
        *common, rand, x, y, offs, params.cost_max, 0.0, scattered=True),
        reps=5)
    ms_coh_plain = cuda_time_ms(lambda: ncc_cuda.ncc_eval_multi_plain(
        *common, coherent[None], x, y, offs, params.cost_max, cap_def),
        reps=1)
    sargs = common + (rand, x, y, offs, params.cost_max, 0.0)
    ms_path = cuda_time_ms(lambda: ncc_sorted.ncc_eval_sorted_kernel(*sargs),
                           reps=3)
    fused = sorted_split(sargs, reps=3)
    chain = samples_chain_split(sargs, reps=2)
    ms_plain = cuda_time_ms(lambda: ncc_sorted.ncc_eval_sorted_plain(*sargs),
                            reps=1)
    perm0 = ncc_sorted.sort_view(data.A[0], data.b[0], data.K_ref, pf, xf,
                                 yf, Hp, Wp)
    ms_samples_plain = cuda_time_ms(lambda: ncc_sorted.sample_view_vals_plain(
        *view(0), pf, xf, yf, perm0, offs, 0.0), reps=1)

    def fused_plain():  # the fused kernel's work for view 0, given its order
        vals = ncc_sorted.unpermute(ncc_sorted.sample_view_vals_plain(
            *view(0), pf, xf, yf, perm0, offs, 0.0), perm0)
        return ncc_sorted.zncc_from_samples(
            refside, vals[:T].reshape(T, H, W), vals[T].reshape(H, W) > 0.5,
            params.cost_max)

    ms_fused_plain = cuda_time_ms(fused_plain, reps=1)
    taps = N * S * T
    log(f"  (c) K=1, {W}x{H}, S={S}, scale {scale}: NCC kernel on the "
        f"coherent default init field {ms_coh:.3f} ms "
        f"({taps / ms_coh / 1e6:.3f} Gtaps/s; plain {ms_coh_plain:.3f} "
        f"ms); on the full-range field (view-major launch) "
        f"{ms_rand:.3f} ms ({taps / ms_rand / 1e6:.3f} Gtaps/s)")
    log(f"  (c) sorted path, fused form: {ms_path:.3f} ms = record "
        f"{fused['record']:.3f} + keys and sort {fused['keys_sort']:.3f} + "
        f"fused kernel {fused['fused_kernel']:.3f} (event sums over the "
        f"views; {taps / ms_path / 1e6:.3f} Gtaps/s)")
    log(f"  (c) the same call through the raw-samples form: "
        f"{sum(chain.values()):.3f} ms = sort {chain['sort']:.3f} + "
        f"raw-samples kernel {chain['samples_kernel']:.3f} + un-permute "
        f"{chain['unpermute']:.3f} + ZNCC {chain['zncc']:.3f}; plain chain "
        f"{ms_plain:.3f} ms; of one view, given its order: plain samples "
        f"{ms_samples_plain:.3f} ms, plain samples, un-permute and ZNCC "
        f"(the fused kernel's work) {ms_fused_plain:.3f} ms")
    view_bytes = 4 * Hp * Wp
    out.update(ms_coh=ms_coh, ms_rand=ms_rand, ms_path=ms_path, split=fused,
               chain=chain, fused_ms=fused["fused_kernel"] / S,
               fused_plain_ms=ms_fused_plain,
               keys_ms=fused["keys_sort"] / S,
               samples_ms=chain["samples_kernel"] / S,
               samples_plain_ms=ms_samples_plain,
               fused_bound=sorted_bound(N, T, view_bytes, False),
               samples_bound=samples_bound(N, T, view_bytes, False),
               keys_bound=keys_bound(N))
    # the key kernel alone, per view, with the call's terms made once as
    # ncc_eval_sorted makes them
    out["keys_kernel_ms"] = cuda_time_ms(
        lambda: ncc_sorted.view_keys_kernel(terms, 0, pf, xf, yf, Hp, Wp),
        reps=10)
    out["keys_plain_ms"] = cuda_time_ms(
        lambda: ncc_sorted.bucket_keys_plain(data.A[0], data.b[0],
                                             data.K_ref, pf, xf, yf, Hp, Wp),
        reps=3)
    src_bytes = 4 * S * Hp * Wp
    out["k1_init_bound"] = ncc_bound(1, S, N, T, src_bytes, False)
    log(f"  bounds (ms, set by) per view: fused kernel "
        f"{out['fused_bound'][0]:.3f} ({out['fused_bound'][1]}) vs "
        f"{out['fused_ms']:.3f} measured; raw-samples kernel "
        f"{out['samples_bound'][0]:.3f} ({out['samples_bound'][1]}) vs "
        f"{out['samples_ms']:.3f}; key kernel {out['keys_bound'][0]:.3f} "
        f"({out['keys_bound'][1]}) vs {out['keys_kernel_ms']:.3f} (plain "
        f"{out['keys_plain_ms']:.3f}); NCC kernel K=1 over the init field "
        f"{out['k1_init_bound'][0]:.3f} ({out['k1_init_bound'][1]}) vs "
        f"{ms_coh:.3f} coherent, {ms_rand:.3f} full-range")
    del refside, common, sargs, perm0, rand, coherent
    torch.cuda.empty_cache()

    # (d) photometric solves of view 0 with the reference semantics
    solves, results = {}, {}
    gt = scene.gt_depth[0]
    for sampler in ("sorted", "auto"):
        p = PatchMatchParams(sampler=sampler, **REFERENCE)
        ncc_cuda.COUNTS.reset()
        ncc_sorted.COUNTS.reset()
        ncc_sorted.KEY_COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_view(scene.images, scene.cameras, tf.PRNGKey(0), p,
                         device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = (ncc_sorted.COUNTS.forms.get("fused", 0),
                  ncc_sorted.COUNTS.forms.get("samples", 0),
                  ncc_sorted.COUNTS.plain, ncc_sorted.KEY_COUNTS.kernel,
                  ncc_sorted.KEY_COUNTS.plain, ncc_cuda.COUNTS.kernel,
                  ncc_cuda.COUNTS.plain)
        d = res.depth.cpu().numpy()
        rel = float(np.median(np.abs(d - gt) / gt))
        expected = ((FUSED_SORTED, 0, 0, FUSED_SORTED, 0, NCC_SORTED, 0)
                    if sampler == "sorted" else (0, 0, 0, 0, 0, NCC_AUTO, 0))
        log(f"  (d) reference-semantics solve, sampler={sampler!r}: "
            f"{sec:.2f} s, median |d-gt|/gt {rel:.5f}; launches (fused, "
            f"raw-samples, plain samples, key kernel, plain keys, NCC "
            f"kernel, plain NCC) {counts}, the schedule implies {expected}")
        if not (np.isfinite(d).all() and rel < 0.01):
            raise AssertionError(f"sampler={sampler!r}: median rel error "
                                 f"{rel}")
        if counts != expected:
            raise AssertionError(f"sampler={sampler!r}: launches {counts}, "
                                 f"expected {expected}")
        solves[sampler] = (sec, rel, counts)
        results[sampler] = res
    # the sorted path computes the NCC kernel's costs (b), so from the same
    # inputs and key the two solves should agree
    a, b = results["sorted"], results["auto"]
    bad = (differs(a.depth, b.depth) | differs(a.normal, b.normal).any(-1)
           | differs(a.cost, b.cost))
    frac = bad.float().mean().item()
    log(f"  (d) sorted vs auto solve: depth, normal or cost differ by > 1e-4 "
        f"on {frac:.3e} of the pixels (limit {MISMATCH_TOL})")
    if frac > MISMATCH_TOL:
        raise AssertionError(f"sorted and auto solves differ on {frac:.3e} "
                             f"of the pixels")
    del results, a, b
    out["solves"] = solves
    return out


def phase_fixtures():
    """Phase 1b: the image fixtures on the card, against what cv2 gives
    (stored beside them): the JPEGs under tests/data/jpeg decoded against
    decoded.npz, and the IDCT and colour kernels against their plain
    versions on each; the files under layouts/ (EXIF orientations 2..8,
    RGB components) and those under refused/ that cv2_arrays.npz holds,
    decoded against it, the rest of refused/ raising; the encoder's
    fixtures (encode/) encoded to cv2.imencode's stored bytes; the PNGs
    (tests/data/png) and TIFFs (tests/data/tiff) read in grey and colour
    against their cv2 arrays, the raster kernel against its plain twin on
    each, those under png/refused and tiff/refused raising; the BMPs
    (tests/data/bmp) and PNMs (tests/data/pnm) the same way; a
    JPEG-compressed TIFF's IDCT over every chunk and chunked colour form
    against their twins. No entry or byte may differ. Returns {fixture:
    {"gray"/"bgr": (entries differing,
    of, largest |diff|)}} and the encoder's, refusals' and raster kernel's
    counts."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images

    dev = torch.device("cuda", 0)
    folder = os.path.join(HERE, "tests", "data", "jpeg")
    want = np.load(os.path.join(folder, "decoded.npz"))
    extra = np.load(os.path.join(folder, "cv2_arrays.npz"))

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def against(got, ref):
        ref = ref.astype(np.int64)
        got = got.cpu().numpy().astype(np.int64)
        if got.shape != ref.shape:
            return (int(ref.size), int(ref.size), 255)
        d = np.abs(got - ref)
        return (int((d > 0).sum()), int(d.size), int(d.max()))

    def colour_equals_plain(data, name):
        """The file's colour kernel (its form) against the plain version;
        returns its Layout."""
        planes, size, layout = images.decode_planes(data, dev)
        for k, p in zip(images.colour_kernel(planes, layout.factors, size,
                                             layout.space),
                        images.colour_plain(planes, layout.factors, size,
                                            layout.space)):
            torch.cuda.synchronize()
            if not torch.equal(k, p):
                raise AssertionError(f"{name}: colour kernel vs plain differ "
                                     f"on {int((k != p).sum())} entries")
        return layout

    out, four = {}, []
    for name in sorted(f[:-4] for f in os.listdir(folder)
                       if f.endswith(".jpg")):
        data = read(os.path.join(folder, f"{name}.jpg"))
        gray, bgr = images.decode(data, dev)
        comps, _, _ = images.decode_coefficients(data, dev)
        for c in comps:
            got_k = images.idct_islow_kernel(*c)
            got_p = images.idct_islow_plain(*c)
            torch.cuda.synchronize()
            if not torch.equal(got_k, got_p):
                raise AssertionError(f"{name}: IDCT kernel vs plain differ "
                                     f"on {int((got_k != got_p).sum())} "
                                     f"entries")
        layout = colour_equals_plain(data, name)
        row = {"gray": against(gray, want[f"gray_{name}"]),
               "bgr": against(bgr, want[f"bgr_{name}"])}
        out[name] = row
        log(f"  {name} {tuple(bgr.shape)} ratios {layout.factors}: grey "
            f"{row['gray'][0]} of {row['gray'][1]} entries differ from "
            f"cv2 ({row['gray'][0] / row['gray'][1]:.4f}), largest "
            f"{row['gray'][2]}; BGR {row['bgr'][0]} of {row['bgr'][1]} "
            f"({row['bgr'][0] / row['bgr'][1]:.4f}), largest "
            f"{row['bgr'][2]}; IDCT and colour kernels equal plain")
    # EXIF orientations, RGB components, and what stays refused
    refused = []
    for sub in ("layouts", "refused"):
        for fname in sorted(os.listdir(os.path.join(folder, sub))):
            name = f"{sub}/{fname[:-4]}"
            data = read(os.path.join(folder, sub, fname))
            if f"bgr_{name}" not in extra:
                try:
                    images.decode(data, dev)
                except ValueError as e:
                    refused.append(name)
                    log(f"  {name}: raises ({e})")
                    continue
                raise AssertionError(f"{name} was decoded")
            gray, bgr = images.decode(data, dev)
            # the colour kernel of the file's form (YCbCr, RGB, CMYK, YCCK)
            # against the plain version
            layout = colour_equals_plain(data, name)
            if layout.space in (images.SPACE_CMYK, images.SPACE_YCCK):
                four.append(name)
            out[name] = {"gray": against(gray, extra[f"gray_{name}"]),
                         "bgr": against(bgr, extra[f"bgr_{name}"])}
            log(f"  {name} {tuple(bgr.shape)} (orientation "
                f"{layout.orientation}, space {layout.space}, ratios "
                f"{layout.factors}): grey, BGR (entries differing, of, "
                f"largest) {out[name]['gray']}, {out[name]['bgr']}; colour "
                f"kernel equals plain")
    def kernels_equal_plain(data, name):
        """A JPEG's smoothing (where libjpeg smooths), IDCT and colour
        kernels against their plain versions; returns its Layout."""
        comps, _, layout = images.decode_coefficients(data, dev)
        for c, p in zip(comps, layout.smooth):
            if not torch.equal(images.jpeg_smooth_kernel(c[0], p),
                               images.jpeg_smooth_plain(c[0], p)):
                raise AssertionError(f"{name}: smoothing kernel vs plain "
                                     f"differ")
        for c in comps:
            if not torch.equal(images.idct_islow_kernel(*c),
                               images.idct_islow_plain(*c)):
                raise AssertionError(f"{name}: IDCT kernel vs plain differ")
        return colour_equals_plain(data, name)

    # arithmetic-coded and truncated JPEGs: grey and BGR, the IDCT and
    # colour kernels against their plain versions; lossless ones in the
    # modes cv2 reads (the other refused), each form against its twin on the
    # file's planes; what stays refused
    coding = {"arith": 0, "truncated": 0, "lossless": 0, "smoothed": 0}
    for sub in ("arith", "truncated"):
        arrays = np.load(os.path.join(folder, sub, "cv2_arrays.npz"))
        for fname in sorted(f for f in os.listdir(os.path.join(folder, sub))
                            if f.endswith(".jpg")):
            name, stem = f"{sub}/{fname[:-4]}", fname[:-4]
            data = read(os.path.join(folder, sub, fname))
            gray, bgr = images.decode(data, dev)
            coding["smoothed"] += bool(kernels_equal_plain(data, name).smooth)
            out[name] = {"gray": against(gray, arrays[f"gray_{stem}"]),
                         "bgr": against(bgr, arrays[f"bgr_{stem}"])}
            coding[sub] += 1
    arrays = np.load(os.path.join(folder, "lossless", "cv2_arrays.npz"))
    for fname in sorted(f for f in os.listdir(os.path.join(folder,
                                                           "lossless"))
                        if f.endswith(".jpg")):
        name, stem = f"lossless/{fname[:-4]}", fname[:-4]
        data = read(os.path.join(folder, "lossless", fname))
        img = images.lossless_image(*images.host_decode(data))
        up = images.ljpeg_upload(img, dev)
        planes = [None] * len(img.diffs)
        for p in set(img.predictors):
            at = [k for k, q in enumerate(img.predictors) if q == p]
            got = images.ljpeg_undiff_kernel(
                [up[0][k] for k in at], [up[1][k] for k in at], up[2][at], p,
                img.precision, [img.pts[k] for k in at])
            for k, g in zip(at, got):
                planes[k] = g
                if not torch.equal(g, images.ljpeg_undiff_plain(
                        up[0][k], up[1][k], p, img.precision, img.pts[k])):
                    raise AssertionError(f"{name}: lossless form vs its "
                                         f"twin differ")
        row, causes = {}, []
        for fn, modes in ((images.decode_colour, ("bgr",)),
                          (images.decode, ("gray", "bgr"))):
            if all(f"{m}_{stem}" in arrays for m in modes):
                got = fn(data, dev)
                for m, t in zip(modes, got if len(modes) == 2 else [got]):
                    row[m] = against(t, arrays[f"{m}_{stem}"])
                continue
            try:
                fn(data, dev)
            except ValueError as e:
                causes.append(str(e))
                continue
            raise AssertionError(f"{name} was read in a mode cv2 refuses")
        if len(img.diffs) == 1:  # cv2's grey, which no entry reads: the
            # kernel's plane, oriented
            row["gray"] = against(images.orient(planes[0], img.orientation),
                                  arrays[f"gray_{stem}"])
        out[name] = row
        coding["lossless"] += 1
        log(f"  {name} ({len(img.diffs)} components, predictor "
            f"{img.predictors[0]}, Pt {img.pts[0]}, {img.precision} bits): "
            f"(entries differing, of, largest) {row}; refused modes "
            f"{causes}; forms equal their twin")
    for sub in ("lossless/refused",):
        for fname in sorted(os.listdir(os.path.join(folder, sub))):
            data = read(os.path.join(folder, sub, fname))
            for fn in (images.decode_colour, images.decode):
                try:
                    fn(data, dev)
                except ValueError:
                    continue
                raise AssertionError(f"{sub}/{fname} was read")
            refused.append(f"jpeg/{sub}/{fname}")
    log(f"  arithmetic-coded, truncated and lossless JPEGs read on the card "
        f"against cv2's arrays: {coding}")
    coding.update(phase_cut_segments(folder, out, against,
                                     kernels_equal_plain))
    # the encoder: cv2.imencode's stored bytes
    enc_dir = os.path.join(folder, "encode")
    sources = np.load(os.path.join(enc_dir, "sources.npz"))
    enc_bad = {}
    names = sorted(f[:-4] for f in os.listdir(enc_dir) if f.endswith(".jpg"))
    for name in names:
        key, q = name.rsplit("_q", 1)
        ref = read(os.path.join(enc_dir, f"{name}.jpg"))
        got = images.encode_jpeg(torch.as_tensor(sources[key], device=dev),
                                 dev, int(q))
        if got != ref:
            enc_bad[name] = (sum(a != b for a, b in zip(got, ref))
                             + abs(len(got) - len(ref)), len(got), len(ref))
    log(f"  encoder: {len(names) - len(enc_bad)} of {len(names)} fixtures "
        f"(colour and grey, 1x1 to 120x176, q75-100) encode to cv2's bytes; "
        f"differing {enc_bad}")
    # PNG, TIFF, BMP and PNM sources, grey and colour, the raster kernel
    # (a JPEG-compressed TIFF: the IDCT and the chunked colour form)
    # against its plain twin on each
    data_dir = os.path.dirname(folder)
    raster_equal = chunked_equal = 0
    lib = images._library()
    for sub, ext in (("png", (".png",)), ("tiff", (".tif",)),
                     ("bmp", (".bmp",)), ("pnm", (".pbm", ".pgm", ".ppm"))):
        sub_dir = os.path.join(data_dir, sub)
        arrays = np.load(os.path.join(sub_dir, "cv2_arrays.npz"))
        for fname in sorted(f for f in os.listdir(sub_dir)
                            if f.endswith(ext)):
            name, stem = f"{sub}/{fname[:-4]}", fname[:-4]
            data = read(os.path.join(sub_dir, fname))
            bgr = images.decode_colour(data, dev)
            out[name] = {"bgr": against(bgr, arrays[f"bgr_{stem}"])}
            gray, bgr2 = images.decode(data, dev)
            out[name]["gray"] = against(gray, arrays[f"gray_{stem}"])
            out[name]["bgr_of_decode"] = against(bgr2, arrays[f"bgr_{stem}"])
            if sub == "tiff" and images.tiff_compression(data, lib) == 7:
                tj = images.tiff_jpeg_coefficients(data, lib)
                planes = images.tiff_jpeg_planes(tj, dev)
                for c, q, p in zip(tj.coefs, tj.qt, planes):
                    args = (torch.from_numpy(c).to(dev),
                            torch.from_numpy(q.view(np.int16)).to(dev),
                            8 * c.shape[0], 8 * c.shape[1])
                    if not torch.equal(p, images.idct_islow_plain(*args)):
                        raise AssertionError(f"{name}: IDCT over every "
                                             f"chunk vs plain differ")
                got = images.colour_kernel(planes, tj.factors, tj.size,
                                           tj.space, tj.chunks)
                want_p = images.colour_plain(planes, tj.factors, tj.size,
                                             tj.space, tj.chunks)
                what = "IDCT and chunked colour kernels equal plain"
                chunked_equal += 1
            else:
                r = images.raster_rows(data, lib)
                samples = torch.from_numpy(r.samples).to(dev)
                tables = torch.from_numpy(r.tables).to(dev)
                got = images.raster_to_bgr_kernel(samples, r.form, tables)
                want_p = images.raster_to_bgr_plain(samples, r.form, tables)
                what = "raster kernel equals plain"
                raster_equal += 1
            for k, p in zip(got, want_p):
                if not torch.equal(k, p):
                    raise AssertionError(f"{name}: kernel vs plain differ "
                                         f"on {int((k != p).sum())} entries")
            log(f"  {name} {tuple(bgr.shape)}: (entries differing, of, "
                f"largest) {out[name]}; {what}")
    for sub in ("png", "tiff", "bmp", "pnm"):
        for fname in sorted(os.listdir(os.path.join(data_dir, sub,
                                                    "refused"))):
            path = os.path.join(data_dir, sub, "refused", fname)
            causes = []
            for fn in (images.decode_colour, images.decode):
                try:
                    fn(read(path), dev)
                except ValueError as e:
                    causes.append(str(e))
                    continue
                raise AssertionError(f"{sub}/refused/{fname} was read")
            refused.append(f"{sub}/refused/{fname}")
            log(f"  {sub}/refused/{fname}: raises ({causes[0]})")
    coding.update(webp_fixtures(data_dir, out, against))
    coding.update(jp2_fixtures(data_dir, out, against))
    bad = {name: r for name, r in out.items()
           if any(v[0] for v in r.values())}
    if bad or enc_bad:
        raise AssertionError(f"fixtures differ from cv2: decode {bad}, "
                             f"encode {enc_bad}")
    return out, {"encoded_equal": len(names), "refused": refused,
                 "jpeg_coding_fixtures": coding,
                 "raster_kernel_equal_plain": raster_equal,
                 "chunked_colour_equal_plain": chunked_equal,
                 "four_component_equal_cv2": four}


def phase_cut_segments(folder: str, out: dict, against,
                       kernels_equal_plain) -> dict:
    """Phase 1b's JPEGs cut inside a marker segment
    (tests/data/jpeg/cut_segments, cuts.json: cv2.imread's arrays of each
    file, by key, or null where cv2 refuses it): each read on the card to
    those arrays, its smoothing, IDCT and colour kernels against their
    twins, or refused, naming the cut segment (2001) or the missing scan
    (2003). Adds each read's (entries differing, of, largest) to ``out``;
    returns the counts read and refused."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images

    dev = torch.device("cuda", 0)
    cut_dir = os.path.join(folder, "cut_segments")
    with open(os.path.join(cut_dir, "cuts.json")) as f:
        cuts = json.load(f)
    arrays = {"truncated": np.load(os.path.join(folder, "truncated",
                                                "cv2_arrays.npz")),
              "cut_segments": np.load(os.path.join(cut_dir,
                                                   "cv2_arrays.npz"))}
    causes = (images._CODE_ERRORS[2001], images._CODE_ERRORS[2003])
    counts = {"cut_segments_read": 0, "cut_segments_refused": 0}
    for stem, key in sorted(cuts.items()):
        with open(os.path.join(cut_dir, f"{stem}.jpg"), "rb") as f:
            data = f.read()
        if key is None:
            try:
                images.decode(data, dev)
            except ValueError as e:
                if not str(e).endswith(causes):
                    raise AssertionError(f"cut_segments/{stem}: refused "
                                         f"for another cause: {e}")
                counts["cut_segments_refused"] += 1
                continue
            raise AssertionError(f"cut_segments/{stem} was read; cv2 "
                                 f"refuses it")
        gray, bgr = images.decode(data, dev)
        kernels_equal_plain(data, f"cut_segments/{stem}")
        where, name = key.split("/") if "/" in key else ("cut_segments", key)
        out[f"cut_segments/{stem}"] = {
            "gray": against(gray, arrays[where][f"gray_{name}"]),
            "bgr": against(bgr, arrays[where][f"bgr_{name}"])}
        counts["cut_segments_read"] += 1
    log(f"  JPEGs cut inside a marker segment (every byte of DHT, SOS, SOF, "
        f"DQT, DRI, DAC, COM and APPn segments): {counts}; every read's "
        f"smoothing, IDCT and colour kernels equal their twins")
    return counts


def webp_fixtures(data_dir: str, out: dict, against) -> dict:
    """Phase 1b's WebP reads first held to cv2.imread here: lossy frames
    with the loop filter's reference and mode deltas, a VP8L image of 1200
    prefix-code groups, read on the card to cv2's arrays with each kernel
    against its twin, and a VP8L backward reference before the first
    pixel, refused. Adds each read's (entries differing, of, largest) to
    ``out``; returns the counts."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images

    dev = torch.device("cuda", 0)
    lib = images._library()
    counts = {"webp_read": 0, "webp_refused": 0}
    for rel in ("webp/lf_deltas", "webp/lf_deltas_clipped",
                "webp/lossless/groups_1200"):
        folder, stem = os.path.split(os.path.join(data_dir, rel))
        with open(f"{os.path.join(folder, stem)}.webp", "rb") as f:
            data = f.read()
        want = np.load(os.path.join(folder, "cv2_arrays.npz"))
        gray, bgr = images.decode(data, dev)
        out[rel] = {"gray": against(gray, want[f"gray_{stem}"]),
                    "bgr": against(bgr, want[f"bgr_{stem}"])}
        def equal(got, twin, what):
            if any(not torch.equal(a, b) for a, b in zip(got, twin)):
                raise AssertionError(f"{rel}: {what} kernel vs its twin "
                                     f"differ")

        if "lossless" in rel:
            img, info, _ = images.vp8l_frame(data, lib)
            argb, _ = images.vp8l_upload(img, dev)
            equal(images.webp_argb_to_bgr_kernel(argb, info.canvas,
                                                 info.offset),
                  images.webp_argb_to_bgr_plain(argb, info.canvas,
                                                info.offset), "ARGB")
        else:
            frame, _ = images.webp_frame(data, lib)
            (H, W), (mb_h, mb_w) = frame.size, frame.mbs
            rec = torch.from_numpy(frame.records).to(dev)
            coefs = torch.from_numpy(frame.coefs).to(dev)
            prm = frame.params
            planes = images.vp8_reconstruct_kernel(rec, coefs, prm, mb_w,
                                                   mb_h)
            equal(planes, images.vp8_reconstruct_plain(
                rec, coefs, torch.from_numpy(prm), mb_w, mb_h),
                "reconstruction")
            plain = images.vp8_loop_filter_plain(
                *planes, rec, torch.from_numpy(prm), mb_w, mb_h)
            images.vp8_loop_filter_kernel(*planes, rec, prm, mb_w, mb_h)
            equal(planes, plain, "loop filter")
            equal(images.webp_yuv_to_bgr_kernel(*planes, W, H),
                  images.webp_yuv_to_bgr_plain(*planes, W, H), "colour")
        counts["webp_read"] += 1
    rel = "webp/lossless/refused/backref_before_first_pixel.webp"
    with open(os.path.join(data_dir, rel), "rb") as f:
        data = f.read()
    try:
        images.decode(data, dev)
    except ValueError as e:
        if "back-reference outside" not in str(e):
            raise AssertionError(f"{rel}: refused for another cause: {e}")
        counts["webp_refused"] += 1
    else:
        raise AssertionError(f"{rel} was read; cv2 refuses it")
    log(f"  WebP loop-filter deltas, 1200 prefix-code groups and a backward "
        f"reference before the first pixel: {counts}; kernels equal their "
        f"twins")
    return counts


def jp2_fixtures(data_dir: str, out: dict, against) -> dict:
    """Phase 1b's JPEG 2000 reads: every fixture of tests/data/jp2 (JP2
    files and raw codestreams, cv2's and Pillow's writes) read on the card
    (``images.decode``: grey and BGR) to cv2's arrays, with
    ``j2k_idwt_kernel`` (each level's launches) and ``j2k_colour_kernel``
    against their twins on each file; the cut lengths cv2 reads
    (``cuts.json``: the codestream ends right after a SOT marker) to its
    arrays, the byte before each refused; ``refused/`` raising in both
    entries with each file's code. Adds each read's (entries differing, of,
    largest) to ``out``; returns the counts."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images

    dev = torch.device("cuda", 0)
    folder = os.path.join(data_dir, "jp2")
    lib = images._library()
    want = np.load(os.path.join(folder, "cv2_arrays.npz"))
    counts = {"jp2_read": 0, "jp2_levels_equal_plain": 0,
              "jp2_colour_equal_plain": 0, "jp2_cut_read": 0,
              "jp2_refused": 0}

    def read(*parts):
        with open(os.path.join(folder, *parts), "rb") as f:
            return f.read()

    for name in sorted(f for f in os.listdir(folder)
                       if f.endswith((".jp2", ".j2k"))):
        data = read(name)
        gray, bgr = images.decode(data, dev)
        out[f"jp2/{name}"] = {"gray": against(gray, want[f"gray_{name}"]),
                              "bgr": against(bgr, want[f"bgr_{name}"])}
        img = images.j2k_host_image(data, lib)
        coef, sched, col = images.j2k_upload(img, dev)
        scratch = torch.empty_like(coef)
        for lv in sched:
            twin = images.j2k_idwt_plain(coef, lv)
            images.j2k_idwt_kernel(coef, scratch, lv)
            if not torch.equal(coef, twin):
                raise AssertionError(f"jp2/{name}: j2k_idwt_kernel vs its "
                                     f"twin differ at level {lv.level}")
            counts["jp2_levels_equal_plain"] += 1
        if any(not torch.equal(a, b) for a, b in zip(
                images.j2k_colour_kernel(coef, col),
                images.j2k_colour_plain(coef, col))):
            raise AssertionError(f"jp2/{name}: j2k_colour_kernel vs its "
                                 f"twin differ")
        counts["jp2_colour_equal_plain"] += 1
        counts["jp2_read"] += 1
    with open(os.path.join(folder, "cuts.json")) as f:
        cuts = json.load(f)
    arrays = np.load(os.path.join(folder, "cuts_arrays.npz"))
    for name, rec in cuts.items():
        data = read(name)
        for length in rec["cv2_reads"]:
            gray, bgr = images.decode(data[:length], dev)
            out[f"jp2/{name}[:{length}]"] = {
                "gray": against(gray, arrays[f"gray_{name}_{length}"]),
                "bgr": against(bgr, arrays[f"bgr_{name}_{length}"])}
            try:
                images.decode(data[:length - 1], dev)
            except ValueError:
                counts["jp2_cut_read"] += 1
                continue
            raise AssertionError(f"jp2/{name} cut to {length - 1} was read")
    with open(os.path.join(folder, "refused", "refused.json")) as f:
        refused = json.load(f)
    for name, rec in refused.items():
        data = read("refused", name)
        for fn in (images.decode_colour, images.decode):
            try:
                fn(data, dev)
            except ValueError as e:
                if images._CODE_ERRORS[rec["code"]] not in str(e):
                    raise AssertionError(f"jp2/refused/{name}: refused for "
                                         f"another cause: {e}")
                continue
            raise AssertionError(f"jp2/refused/{name} was read")
        counts["jp2_refused"] += 1
    log(f"  JPEG 2000 fixtures: {counts}; every read equal to cv2's "
        f"arrays, each kernel equal to its twin")
    return counts


def write_colmap_model(scene, dense: str, names, per_view: int = 400,
                       seed: int = 0):
    """A COLMAP text model of ``scene`` under ``dense``/sparse: one PINHOLE
    camera and one image (``names[v]``) per view, qvec/tvec from the
    scene's R and t, and 3-D points sampled from each view's GT depth on
    ground rows, with the track of every view they project into."""
    import numpy as np
    from mpmvs_torch.preprocess.colmap import rotmat_to_qvec

    rng = np.random.default_rng(seed)
    cams = scene.cameras
    K, R, t = (cams.K.numpy().astype(np.float64),
               cams.R.numpy().astype(np.float64),
               cams.t.numpy().astype(np.float64))
    V, H, W = scene.gt_depth.shape
    pts = []
    for v in range(V):
        ys = rng.integers(SKY_ROWS + GROUND_MARGIN, H, per_view)
        xs = rng.integers(0, W, per_view)
        d = scene.gt_depth[v][ys, xs].astype(np.float64)
        ray = np.linalg.solve(K[v], np.stack([xs, ys, np.ones_like(xs)]))
        pts.append((R[v].T @ (ray * d - t[v][:, None])).T)
    pts = np.concatenate(pts)
    obs = {v: [] for v in range(V)}
    tracks = []
    for pid, X in enumerate(pts, 1):
        track = []
        for v in range(V):
            p = K[v] @ (R[v] @ X + t[v])
            x, y = p[0] / p[2], p[1] / p[2]
            if p[2] > 0 and 0 <= x < W and 0 <= y < H:
                track.append((v + 1, len(obs[v])))
                obs[v].append((x, y, pid))
        tracks.append(track)
    sparse = os.path.join(dense, "sparse")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for v in range(V):
            fx, fy, cx, cy = (float(K[v][0, 0]), float(K[v][1, 1]),
                              float(K[v][0, 2]), float(K[v][1, 2]))
            f.write(f"{v + 1} PINHOLE {W} {H} {fx!r} {fy!r} {cx!r} {cy!r}\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for v in range(V):
            q = rotmat_to_qvec(R[v])
            f.write(f"{v + 1} {' '.join(repr(float(c)) for c in q)} "
                    f"{' '.join(repr(float(c)) for c in t[v])} {v + 1} "
                    f"{names[v]}\n")
            f.write(" ".join(f"{x:.3f} {y:.3f} {pid}"
                             for x, y, pid in obs[v]) + "\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for pid, (X, track) in enumerate(zip(pts, tracks), 1):
            f.write(f"{pid} {' '.join(repr(float(c)) for c in X)} "
                    f"128 128 128 0.5 "
                    + " ".join(f"{i} {j}" for i, j in track) + "\n")
    return len(pts)


def files_scene():
    """Phase 8's scene: FILES_VIEWS views at 3200x2130 (seed 1), the top
    fifth sky, and its colours tinted, as uint8 BGR (V, H, W, 3)."""
    import numpy as np
    from mpmvs_torch.utils.synthetic import make_plane_scene

    scene = make_plane_scene(num_views=FILES_VIEWS, height=H_FULL,
                             width=W_FULL, seed=1)
    paint_sky(scene)
    bgr = np.clip(np.round(scene.colors * np.array(FILES_TINT, np.float32)),
                  0, 255).astype(np.uint8)
    return scene, bgr


def sha256_of(t) -> str:
    """The sha-256 of a uint8 tensor's bytes, row-major, as numpy's
    ``tobytes`` lays them out."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _ycck_cv2() -> dict:
    """The sha-256 of YCCK_SOURCE, of cv2.imread's grey and BGR arrays of
    it and of the JAX converter's workspace image of it."""
    with open(os.path.join(os.path.dirname(YCCK_SOURCE), "cv2.json")) as f:
        return json.load(f)


def phase_files(params, root: str):
    """Phase 8: the user's path from files at full width. A 4-view
    3200x2130 plane scene (top fifth sky, colours tinted) as a COLMAP text
    model and its sources (FILES_SOURCES) under ``root``;
    ``mpmvs_torch.preprocess.convert.main`` on the card, then
    ``mpmvs_torch.cli.main`` with a YAML config and --sky-seg 1 on the
    converted workspace: the default schedule, every view estimated with
    the other 3 as sources, previews on. Returns what the summary and
    phase 9 need (the workspace and config stay under ``root``)."""
    import numpy as np
    import torch
    from mpmvs_torch import cli, pipeline
    from mpmvs_torch.io import images, read_cam_txt, read_dmb
    from mpmvs_torch.io import read_pair_txt, read_ply_binary
    from mpmvs_torch.ops import bilateral_cuda, ncc_cuda
    from mpmvs_torch.preprocess import convert
    from mpmvs_torch.utils.synthetic import make_plane_scene
    from mpmvs_torch.utils.trace import cuda_time_ms

    dev = torch.device("cuda", 0)
    V = FILES_VIEWS
    ycck_cv2 = _ycck_cv2()
    t0 = time.perf_counter()
    scene, bgr = files_scene()
    log(f"  scene: {V} views at {W_FULL}x{H_FULL} in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    dense, ws = os.path.join(root, "dense"), os.path.join(root, "ws")
    ext = {"JPG": "JPG", "tif": "tif", "png16": "png", "ycck": "jpeg"}
    names = [f"IMG_{v:04d}.{ext[FILES_SOURCES[v]]}" for v in range(V)]
    n_pts = write_colmap_model(scene, dense, names)
    os.makedirs(os.path.join(dense, "images"))
    enc_ms = []
    t1 = time.perf_counter()
    tiff_file = _tiff_file()
    for v in range(V):
        path = os.path.join(dense, "images", names[v])
        kind = FILES_SOURCES[v]
        if kind == "JPG":
            img = torch.as_tensor(bgr[v], device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            images.write_jpeg(path, img, dev)
            enc_ms.append((time.perf_counter() - t2) * 1e3)
            continue
        with open(path, "wb") as f:
            if kind == "ycck":  # the committed file of this view
                with open(YCCK_SOURCE, "rb") as src:
                    ycck = src.read()
                if hashlib.sha256(ycck).hexdigest() != \
                        ycck_cv2["source_sha256"]:
                    raise AssertionError(f"{YCCK_SOURCE} is not the file "
                                         f"whose cv2 reads were recorded")
                f.write(ycck)
            elif kind == "png16":  # the low byte is noise v >> 8 drops
                low = np.random.default_rng(v).integers(
                    0, 256, bgr[v].shape, dtype=np.uint16)
                f.write(png16_bytes(bgr[v][..., ::-1].astype(np.uint16)
                                    * 256 + low))
            else:
                f.write(tiff_file.tiff_bytes(
                    np.ascontiguousarray(bgr[v][..., ::-1]), compression=5,
                    predictor=2, rows_per_strip=TIFF_ROWS_PER_STRIP))
    log(f"  sources written ({', '.join(names)}) in "
        f"{time.perf_counter() - t1:.1f} s")
    config = os.path.join(root, "config.yaml")
    with open(config, "w") as f:
        f.write("%YAML:1.0\n---\n# the reference's defaults\n"
                "Geometric consistency iterations: 2\nPlaner prior: 1\n"
                "Geometric consistency planer prior: 1\n"
                "Sky segment: 1\nUse dynamic_consistency to fuse: 1\n"
                "Max source images num: 20\nMax image size: 3200\n"
                "# every preview\nSave Dmb as JPG: 1\nSave Cost Map: 1\n"
                "Save Normal Map: 1\n")

    ncc_cuda.COUNTS.reset()
    bilateral_cuda.COUNTS.reset()
    bilateral_cuda.TABLE_COUNTS.reset()
    bilateral_cuda.colour_table.cache_clear()
    for c in (images.COUNTS, images.IDCT_COUNTS, images.YCC_COUNTS,
              images.FDCT_COUNTS, images.CODEC_COUNTS, images.RASTER_COUNTS):
        c.reset()
    t1 = time.perf_counter()
    if convert.main(["--dense_folder", dense, "--save_folder", ws]) != 0:
        raise AssertionError("convert.main failed")
    convert_s = time.perf_counter() - t1
    pipes = []
    run = pipeline.Pipeline.run

    def keep(self, *a, **k):  # the CLI's pipeline, for its logs
        pipes.append(self)
        return run(self, *a, **k)

    pipeline.Pipeline.run = keep
    try:
        t1 = time.perf_counter()
        rc = cli.main(["--input", ws, "--sky-seg", "1", "--config",
                       config])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
    finally:
        pipeline.Pipeline.run = run
    if rc != 0 or len(pipes) != 1:
        raise AssertionError(f"cli.main returned {rc}")
    pipe = pipes[0]
    ncc = (ncc_cuda.COUNTS.kernel, ncc_cuda.COUNTS.plain)
    bil = (bilateral_cuda.COUNTS.kernel, bilateral_cuda.COUNTS.plain,
           dict(bilateral_cuda.COUNTS.forms))
    tables = bilateral_cuda.TABLE_COUNTS.kernel
    ycc = (images.COUNTS.kernel, images.COUNTS.plain)
    four = {k: images.COUNTS.forms.get(k, 0) for k in ("cmyk", "ycck")}
    idct_launches = images.IDCT_COUNTS.kernel
    enc_launches = (images.YCC_COUNTS.kernel, images.FDCT_COUNTS.kernel,
                    images.YCC_COUNTS.plain + images.FDCT_COUNTS.plain)
    codec = dict(images.CODEC_COUNTS.forms)
    raster = (images.RASTER_COUNTS.kernel, images.RASTER_COUNTS.plain)
    log(f"  convert {convert_s:.2f} s ({n_pts} sparse points), cli "
        f"{cli_s:.1f} s; {pipe.timer.summary()}")

    # the converter's cameras against the scene's, to text precision
    cam_err = 0.0
    for v in range(V):
        c = read_cam_txt(os.path.join(ws, "cams", f"{v:08d}_cam.txt"))
        for f in ("K", "R", "t"):
            a = getattr(c, f).numpy()
            b = getattr(scene.cameras, f)[v].numpy()
            cam_err = max(cam_err, float(np.abs(a - b).max()
                                         / max(np.abs(b).max(), 1.0)))
    scenes = read_pair_txt(os.path.join(ws, "pair.txt"))
    srcs = {s.ref_id: sorted(s.src_ids[1:]) for s in scenes}
    log(f"  converted cams: max |K, R, t - scene| (relative) "
        f"{cam_err:.2e}; sources {srcs}")
    if cam_err > CAM_TOL or any(
            srcs[v] != [u for u in range(V) if u != v] for v in range(V)):
        raise AssertionError(f"converted workspace: camera error "
                             f"{cam_err}, sources {srcs}")

    ground = slice(SKY_ROWS + GROUND_MARGIN, H_FULL)
    rel = {}
    for v in range(V):
        d = read_dmb(os.path.join(ws, "MPMVS", f"2333_{v:08d}",
                                  "depths.dmb"))
        gt = scene.gt_depth[v]
        if d.shape != gt.shape or not np.isfinite(d).all():
            raise AssertionError(f"view {v}: depth map {d.shape}")
        rel[v] = float(np.median(np.abs(d[ground] - gt[ground])
                                 / gt[ground]))
    pts = read_ply_binary(os.path.join(ws, "MPMVS",
                                       "MPMVS_model.ply"))[0]
    previews = sorted({f for v in range(V) for f in os.listdir(
        os.path.join(ws, "MPMVS", f"2333_{v:08d}")) if f.endswith(
        (".jpg", ".png"))})
    sky = {v: float(pipe.views[v].sky_mask.mean()) for v in range(V)}
    n_prior = sum(stage == "prior" for _, stage, _ in pipe.solve_log)
    log(f"  median |d-gt|/gt on ground rows {rel}; PLY {len(pts)} "
        f"points; sky fractions {sky}; previews {previews}")

    # the TIFF and PNG sources converted on the card: their pixels are the
    # scene's colours (lossless; the 16-bit PNG's high bytes), so the
    # workspace holds their encoding
    converted = {}
    for v in range(V):
        if FILES_SOURCES[v] in ("JPG", "ycck"):
            continue
        with open(os.path.join(ws, "images", f"{v:08d}.jpg"), "rb") as f:
            converted[names[v]] = f.read() == images.encode_jpeg(
                torch.as_tensor(bgr[v], device=dev), dev, 95)
    log(f"  TIFF and PNG sources converted on the card to the encoding of "
        f"their pixels: {converted}")
    if not all(converted.values()):
        raise AssertionError(f"a TIFF or PNG source's workspace image is "
                             f"not the encoding of its pixels: {converted}")
    # the YCCK source: the card reads it as cv2.imread does and the
    # converter writes what the JAX converter's cv2.imwrite(dst,
    # cv2.imread(src)) writes (sha-256 of cv2's arrays and bytes, recorded
    # where cv2 is: tests/data/jpeg/conversion/cv2.json)
    v = FILES_SOURCES.index("ycck")
    g, c = images.read_image(os.path.join(dense, "images", names[v]), dev)
    with open(os.path.join(ws, "images", f"{v:08d}.jpg"), "rb") as f:
        ycck_ws = hashlib.sha256(f.read()).hexdigest()
    ycck_read = {
        "gray": sha256_of(g) == ycck_cv2["gray_sha256"],
        "bgr": sha256_of(c) == ycck_cv2["bgr_sha256"],
        "workspace_image": ycck_ws == ycck_cv2["workspace_sha256"]}
    log(f"  YCCK source {names[v]} equal to cv2's (grey, BGR, the "
        f"converter's workspace image): {ycck_read}")
    if not all(ycck_read.values()):
        raise AssertionError(f"the YCCK source differs from cv2: "
                             f"{ycck_read}")

    # decode and encode per image, host clock around synchronised calls
    dec_ms = []
    for v in range(V):
        path = os.path.join(ws, "images", f"{v:08d}.jpg")
        with open(path, "rb") as f:
            data = f.read()
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            g, c = images.decode(data, dev)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t1) * 1e3)
    # the IDCT (each of the three components) and colour kernels
    # against their plain versions on the last view's planes at full
    # size: no entry may differ
    comps, _, _ = images.decode_coefficients(data, dev)
    idct_err = [differing(images.idct_islow_kernel(*c),
                          images.idct_islow_plain(*c)) for c in comps]
    planes, size, layout = images.decode_planes(data, dev)
    y, cb, cr = planes
    hs, vs = layout.factors[1]
    ycc_err = [differing(images.ycc_to_bgr_kernel(y, cb, cr, hs, vs),
                         images.ycc_to_bgr_plain(y, cb, cr, hs, vs))]
    log(f"  at {W_FULL}x{H_FULL}, chroma {hs}x{vs}: IDCT kernel vs "
        f"plain (entries differing, largest |diff|) per component "
        f"{idct_err}; colour kernel vs plain {ycc_err[0]}")
    if any(e[0] for e in idct_err + ycc_err):
        raise AssertionError(f"codec kernels vs plain at full size: IDCT "
                             f"{idct_err}, colour {ycc_err}")
    kernel_ms = cuda_time_ms(lambda: images.ycc_to_bgr_kernel(
        y, cb, cr, hs, vs), 20)
    plain_ms = cuda_time_ms(lambda: images.ycc_to_bgr_plain(
        y, cb, cr, hs, vs), 3)
    n_px = H_FULL * W_FULL
    bound_ms = (n_px + 2 * cb.numel() + 3 * n_px) / 3.35e12 * 1e3
    # the IDCT of all three components; its bound counts the bytes
    # (2 a coefficient, 1 a sample): int64 work has no peak in the table
    idct = lambda fn: (lambda: [fn(*c) for c in comps])
    idct_ms = cuda_time_ms(idct(images.idct_islow_kernel), 20)
    idct_plain_ms = cuda_time_ms(idct(images.idct_islow_plain), 3)
    idct_bound_ms = sum(2 * c[0].numel() + c[2] * c[3]
                        for c in comps) / 3.35e12 * 1e3
    enc = phase_encode_parts(bgr[0], dev)
    png = phase_png_parts(bgr[0], dev)
    raster_parts = phase_raster_parts({
        k: os.path.join(dense, "images", names[FILES_SOURCES.index(k)])
        for k in ("tif", "png16")}, dev)
    ycck_parts = phase_ycck_parts(*[os.path.join(
        dense, "images", names[FILES_SOURCES.index(k)])
        for k in ("ycck", "JPG")], dev)
    log("phase 8b: the lossy WebP source through the converter's image "
        "step and the pipeline's read; its kernels vs plain")
    webp_parts = phase_webp_parts(dev)
    log("phase 8c: the lossless WebP source through the converter's image "
        "step and the pipeline's read, an animated fixture; the lossless "
        "kernels vs plain")
    lossless_parts = phase_lossless_parts(dev)
    log("phase 8d: the JPEG-compressed TIFF source and the YCbCr, BMP and "
        "PNM sources through the converter's image step and the pipeline's "
        "read; the chunked colour form and the raster kernel's new forms vs "
        "plain")
    tiff_jpeg_parts = phase_tiff_jpeg_parts(dev)
    log("phase 8e: the arithmetic-coded and lossless JPEG sources through "
        "the converter's image step and the pipeline's read; the lossless "
        "forms vs their twin")
    jpeg_coding_parts = phase_jpeg_coding_parts(dev)
    log("phase 8f: a cut progressive JPEG, a CIELab TIFF and an old-style "
        "LZW TIFF through the converter's image step and the pipeline's "
        "read; the smoothing kernel and the CIELab form vs their twins")
    rare_parts = phase_rare_parts(dev)
    log("phase 8g: the JPEG 2000 sources (lossless 5/3, 9/7 ICT tiled "
        "RPCL with layers, 5/3 RCT with layers) through the converter's "
        "image step and "
        "the pipeline's read; the inverse-wavelet and colour kernels vs "
        "their twins")
    jp2_parts = phase_jp2_parts(dev)
    expected = V * (NCC_PHOTOMETRIC + 2 * NCC_GEOM) + n_prior * NCC_PRIOR
    bad = {v: e for v, e in rel.items() if not e < 0.01}
    log(f"  launches: NCC {ncc[0]} (schedule implies {expected}), plain "
        f"{ncc[1]}; bilateral {bil[0]} by form {bil[2]}, plain {bil[1]}, "
        f"table builds {tables}; IDCT kernel {idct_launches}, colour "
        f"kernels {ycc[0]} (four-component {four}), plain {ycc[1]}; encoder "
        f"colour and DCT kernels "
        f"{enc_launches[:2]}, plain {enc_launches[2]}; raster kernel "
        f"{raster[0]}, plain {raster[1]}; codec calls {codec}")
    if bad or len(pts) == 0 or previews != FILES_PREVIEWS:
        raise AssertionError(f"files path: median rel error >= 1% {bad}, "
                             f"PLY {len(pts)} points, previews {previews}")
    # the converter reads the .JPG (the JPEG path), the YCCK .jpeg (the
    # four-component colour kernel), the .tif and the .png (the raster
    # kernel, no colour kernel) and encodes all 4; the pipeline reads the
    # 4 .jpgs; every encode (the previews' too) is one colour and three DCT
    # launches but a grey preview's one
    n_jpg, n_ycck = FILES_SOURCES.count("JPG"), FILES_SOURCES.count("ycck")
    n_raster = {k: sum(FILES_SOURCES[v].startswith(k) for v in range(V))
                for k in ("png", "tif")}
    if ncc != (expected, 0) or bil[:2] != (V, 0) or \
            bil[2] != {"table": V} or tables != 1 or \
            ycc[0] != n_jpg + n_ycck + V or ycc[1] != 0 or \
            four != {"cmyk": 0, "ycck": n_ycck} or \
            idct_launches != 3 * (n_jpg + V) + 4 * n_ycck or \
            codec.get("png") != n_raster["png"] or \
            codec.get("tiff") != n_raster["tif"] or \
            raster != (V - n_jpg - n_ycck, 0) or \
            codec.get("decode") != n_jpg + n_ycck + V or \
            enc_launches[0] != codec.get("encode") or enc_launches[2] or \
            not V <= enc_launches[0] <= enc_launches[1] <= 3 * enc_launches[0]:
        raise AssertionError(f"files path launches: NCC {ncc} (expected "
                             f"{expected}), bilateral {bil}, tables "
                             f"{tables}, colour kernels {ycc} (expected "
                             f"{n_jpg + n_ycck + V}: the converter's and "
                             f"the pipeline's JPEG reads; four-component "
                             f"{four}), IDCT kernel "
                             f"{idct_launches}, encoder kernels "
                             f"{enc_launches}, raster kernel {raster} "
                             f"(expected {V - n_jpg - n_ycck}: the "
                             f"converter's TIFF and PNG reads), codec calls "
                             f"{codec}")
    out.update(ws=ws, config=config, gt_depth=scene.gt_depth,
               images=scene.images, cameras=scene.cameras,
               rel=rel, points=len(pts), ncc=ncc[0], bilateral=bil[0],
               tables=tables, ycc_launches=ycc[0] - sum(four.values()),
               codec=codec,
               enc_ms=enc_ms, dec_ms=dec_ms, ycc_ms=kernel_ms,
               ycc_plain_ms=plain_ms, ycc_bound_ms=bound_ms,
               idct_launches=idct_launches, idct_ms=idct_ms,
               idct_plain_ms=idct_plain_ms, idct_bound_ms=idct_bound_ms,
               idct_vs_plain=idct_err, ycc_vs_plain=ycc_err,
               enc_launches=enc_launches, enc=enc, png=png,
               raster_launches=raster[0], raster=raster_parts,
               cmyk_launches=sum(four.values()), ycck=ycck_parts,
               ycck_read=ycck_read, webp=webp_parts,
               lossless=lossless_parts, tiff_jpeg=tiff_jpeg_parts,
               jpeg_coding=jpeg_coding_parts, rare=rare_parts,
               jp2=jp2_parts)
    return out


def phase_encode_parts(bgr, dev):
    """The encoder at 3200x2130 (phase 8's view 0), part by part: the
    colour kernel (bgr_to_ycc_kernel) and the forward DCT kernel (three
    launches, one a plane) against their plain versions (no entry may
    differ) and timed with CUDA events beside their bounds; the
    coefficients' copy to the host and the host's entropy coding, host
    clock; the whole encode_jpeg, host clock around a synchronised call.
    The bytes of the kernels' path and of the plain versions' (coded on
    the host the same way) must be equal."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.utils.roofline import bgr_to_ycc_bound, fdct_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    img = torch.as_tensor(bgr, device=dev)
    H, W = img.shape[:2]
    lib = images._library()
    qt = images.quality_tables(images.PREVIEW_QUALITY, lib).to(dev)
    planes = images.bgr_to_ycc_kernel(img)
    planes_p = images.bgr_to_ycc_plain(img)
    tables = (qt[0], qt[1], qt[1])
    coefs = [images.fdct_islow_kernel(p, q) for p, q in zip(planes, tables)]
    coefs_p = [images.fdct_islow_plain(p, q)
               for p, q in zip(planes_p, tables)]
    ycc_err = [differing(a, b) for a, b in zip(planes, planes_p)]
    fdct_err = [differing(a, b) for a, b in zip(coefs, coefs_p)]
    log(f"  encoder at {W}x{H}: colour kernel vs plain (entries differing, "
        f"largest |diff|) per plane {ycc_err}; forward DCT kernel vs plain "
        f"{fdct_err}")
    if any(e[0] for e in ycc_err + fdct_err):
        raise AssertionError(f"encoder kernels vs plain at full size: "
                             f"colour {ycc_err}, DCT {fdct_err}")
    out = {"ycc_vs_plain": ycc_err, "fdct_vs_plain": fdct_err}
    out["ycc_ms"] = cuda_time_ms(lambda: images.bgr_to_ycc_kernel(img), 20)
    out["ycc_plain_ms"] = cuda_time_ms(lambda: images.bgr_to_ycc_plain(img),
                                       3)
    dct = lambda fn: (lambda: [fn(p, q) for p, q in zip(planes, tables)])
    out["fdct_ms"] = cuda_time_ms(dct(images.fdct_islow_kernel), 20)
    out["fdct_plain_ms"] = cuda_time_ms(dct(images.fdct_islow_plain), 3)
    out["ycc_bound"] = bgr_to_ycc_bound(H, W, 3)
    out["fdct_bound"] = fdct_bound(sum(c.shape[0] * c.shape[1]
                                       for c in coefs))
    copy_ms, huff_ms, whole_ms = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = [c.cpu() for c in coefs]
        t2 = time.perf_counter()
        data = images.encode_coefficients(host, W, H,
                                          images.PREVIEW_QUALITY, lib)
        t3 = time.perf_counter()
        copy_ms.append((t2 - t1) * 1e3)
        huff_ms.append((t3 - t2) * 1e3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        whole = images.encode_jpeg(img, dev)
        whole_ms.append((time.perf_counter() - t1) * 1e3)
    plain_bytes = images.encode_coefficients([c.cpu() for c in coefs_p], W,
                                             H, images.PREVIEW_QUALITY, lib)
    if not data == whole == plain_bytes:
        raise AssertionError("the encoder's bytes differ between its kernels "
                             "and their plain versions")
    out.update(copy_ms=copy_ms, huffman_ms=huff_ms, encode_ms=whole_ms,
               bytes=len(whole))
    log(f"  encoder at {W}x{H}, q{images.PREVIEW_QUALITY} ({len(whole)} "
        f"bytes, equal to the plain versions'): colour kernel "
        f"{out['ycc_ms']:.4f} ms (bound {out['ycc_bound'][0]:.4f}, plain "
        f"{out['ycc_plain_ms']:.2f}); DCT kernel, 3 planes "
        f"{out['fdct_ms']:.4f} ms (bound {out['fdct_bound'][0]:.4f}, plain "
        f"{out['fdct_plain_ms']:.2f}); copy to host {np.round(copy_ms, 2)} "
        f"ms; entropy coding {np.round(huff_ms, 2)} ms; encode_jpeg "
        f"{np.round(whole_ms, 2)} ms")
    del planes_p, coefs_p
    torch.cuda.empty_cache()
    return out


def phase_png_parts(bgr, dev):
    """The PNG read at 3200x2130: decode_colour of an 8-bit PNG of ``bgr``
    (phase 8's view 0, written by the host's PNG writer, whose zlib stream
    holds filter type 0 only; host clock, synchronised), and the host
    unfilter alone on scanlines of that size whose filter types cycle
    through all five (random bytes are valid filtered data)."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images

    data = images.encode_png(bgr)
    read_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        images.decode_colour(data, dev)
        torch.cuda.synchronize()
        read_ms.append((time.perf_counter() - t1) * 1e3)
    lib = images._library()
    rowbytes = 3 * W_FULL
    raw = np.random.default_rng(0).integers(
        0, 256, (H_FULL, rowbytes + 1)).astype(np.uint8)
    raw[:, 0] = np.arange(H_FULL) % 5
    raw = raw.tobytes()
    rows = np.empty((H_FULL, rowbytes), np.uint8)
    unfilter_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        err = lib.png_unfilter_rows(raw, len(raw), rows.ctypes.data, H_FULL,
                                    rowbytes, 3)
        unfilter_ms.append((time.perf_counter() - t1) * 1e3)
        if err:
            raise AssertionError(f"png_unfilter_rows returned {err}")
    log(f"  PNG at {W_FULL}x{H_FULL}: decode_colour {np.round(read_ms, 2)} "
        f"ms; host unfilter (all five filters) {np.round(unfilter_ms, 2)} "
        f"ms")
    return {"read_ms": read_ms, "unfilter_ms": unfilter_ms}


def _tiff_file():
    """tests/data/tiff/tiff_file.py (the TIFF writer of the tests'
    fixtures; its LZW coder is built with the C compiler), imported."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tiff_file", os.path.join(HERE, "tests", "data", "tiff",
                                  "tiff_file.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def png16_bytes(rgb16) -> bytes:
    """A 16-bit RGB PNG of (H, W, 3) uint16 samples: the rows' filter
    types cycle through all five (each computed from the unfiltered bytes,
    so vectorised), zlib level 1."""
    import struct
    import zlib

    import numpy as np

    H = rgb16.shape[0]
    raw = rgb16.astype(">u2").view(np.uint8).reshape(H, -1).astype(np.int16)
    bpp = 6
    a = np.zeros_like(raw)
    a[:, bpp:] = raw[:, :-bpp]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    c = np.zeros_like(raw)
    c[1:, bpp:] = raw[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    preds = (np.zeros_like(raw), a, b, (a + b) >> 1,
             np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)))
    kinds = np.arange(H) % 5
    rows = np.empty((H, raw.shape[1] + 1), np.uint8)
    rows[:, 0] = kinds
    for k in range(5):
        sel = kinds == k
        rows[sel, 1:] = (raw[sel] - preds[k][sel]) & 255

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", rgb16.shape[1], H, 16,
                                         2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def phase_raster_parts(paths, dev):
    """The TIFF and 16-bit PNG reads at 3200x2130 (phase 8's sources), part
    by part: the host's parse and decompression (``images.raster_rows``:
    LZW and predictor, or zlib and unfilter), the copy of the samples to
    the card, and the raster kernel, each on the host clock around
    synchronised calls; the kernel also with CUDA events beside its bound
    and its plain twin (which it must equal); and the whole
    ``decode_colour``."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.utils.roofline import raster_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    lib = images._library()
    out = {}
    for kind, path in paths.items():
        with open(path, "rb") as f:
            data = f.read()
        host_ms, copy_ms, kernel_host_ms, read_ms = [], [], [], []
        for _ in range(3):
            t1 = time.perf_counter()
            r = images.raster_rows(data, lib)
            t2 = time.perf_counter()
            samples = torch.from_numpy(r.samples).to(dev)
            tables = torch.from_numpy(r.tables).to(dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            images.raster_to_bgr_kernel(samples, r.form, tables)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            images.decode_colour(data, dev)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            host_ms.append((t2 - t1) * 1e3)
            copy_ms.append((t3 - t2) * 1e3)
            kernel_host_ms.append((t4 - t3) * 1e3)
            read_ms.append((t5 - t4) * 1e3)
        got = images.raster_to_bgr_kernel(samples, r.form, tables)
        want = images.raster_to_bgr_plain(samples, r.form, tables)
        err = [differing(a, b) for a, b in zip(got, want)]
        if any(e[0] for e in err):
            raise AssertionError(f"raster kernel vs plain at full size "
                                 f"({kind}): {err}")
        ms = cuda_time_ms(lambda: images.raster_to_bgr_kernel(
            samples, r.form, tables), 20)
        plain_ms = cuda_time_ms(lambda: images.raster_to_bgr_plain(
            samples, r.form, tables), 3)
        bnd = raster_bound(r.form, images.TABLES_LEN)
        out[kind] = {"file_bytes": len(data),
                     "sample_bytes": int(r.samples.nbytes),
                     "host_parse_decompress_ms": host_ms,
                     "copy_to_card_ms": copy_ms,
                     "kernel_host_clock_ms": kernel_host_ms,
                     "decode_colour_ms": read_ms, "kernel_ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bnd[0],
                     "bound_by": bnd[1], "vs_plain": err,
                     "form": r.form._asdict()}
        log(f"  {kind} read at {r.form.width}x{r.form.height} "
            f"({len(data)} file bytes, {r.samples.nbytes} sample bytes): "
            f"host parse and decompression {np.round(host_ms, 2)} ms; copy "
            f"to the card {np.round(copy_ms, 2)} ms; raster kernel "
            f"{ms:.4f} ms (CUDA events; bound {bnd[0]:.4f}, share "
            f"{bnd[0] / ms:.2f}; plain {plain_ms:.2f}; host clock "
            f"{np.round(kernel_host_ms, 3)}); decode_colour "
            f"{np.round(read_ms, 2)} ms; kernel equals plain {err}")
        del samples, got, want
    torch.cuda.empty_cache()
    return out


def phase_ycck_parts(path: str, reference: str, dev):
    """Phase 8's YCCK source (3200x2130; Y and K at 2x2, Cb and Cr at 1x1)
    read part by part, host clock around synchronised calls: the host's
    parse and entropy decode (``images.host_decode``), the copy of the
    coefficients to the card (``upload_coefficients``), the IDCT kernel
    (four launches), the four-component colour kernel and the whole
    ``decode``. The colour kernel also with CUDA events beside its bound
    and its plain twin (which it must equal), on the file's planes and on
    its four planes upsampled to 1x1 (a CMYK file's layout at that size),
    in both forms. ``reference``: a three-component JPEG of the same size
    (phase 8's .JPG, 4:2:0), whose host decode is timed beside."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.utils.roofline import colour_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    with open(path, "rb") as f:
        data = f.read()
    parts = {k: [] for k in ("host_decode_ms", "copy_to_card_ms", "idct_ms",
                             "colour_kernel_ms", "decode_ms")}
    for _ in range(3):
        t1 = time.perf_counter()
        handle, info = images.host_decode(data)
        t2 = time.perf_counter()
        comps, size, layout = images.upload_coefficients(handle, info, dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        planes = images._planes(comps)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        images.colour_kernel(planes, layout.factors, size, layout.space)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        images.decode(data, dev)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t1, t2), (t2, t3), (t3, t4), (t4, t5),
                                     (t5, t6))):
            parts[k].append((b - a) * 1e3)
    if layout.space != images.SPACE_YCCK:
        raise AssertionError(f"{path}: colour space {layout.space}, not YCCK")
    H, W = size
    full = [images._upsample(p, H, W, *f).to(torch.uint8)
            for p, f in zip(planes, layout.factors)]
    with open(reference, "rb") as f:
        ref = f.read()
    ref_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        handle, info = images.host_decode(ref)
        ref_ms.append((time.perf_counter() - t1) * 1e3)
        images.upload_coefficients(handle, info, dev)
    out = {"file_bytes": len(data), "factors": layout.factors, **parts,
           "reference_host_decode_ms": ref_ms, "reference_bytes": len(ref)}
    for label, pl, factors in (("file", planes, layout.factors),
                               ("1x1", full, [(1, 1)] * 4)):
        for ycck in (True, False):
            got = images.cmyk_to_bgr_kernel(pl, factors, ycck, size)
            want = images.cmyk_to_bgr_plain(pl, factors, ycck, size)
            err = [differing(a, b) for a, b in zip(got, want)]
            if any(e[0] for e in err):
                raise AssertionError(f"cmyk_to_bgr_kernel vs plain at full "
                                     f"size ({label}, YCCK {ycck}): {err}")
            ms = cuda_time_ms(lambda: images.cmyk_to_bgr_kernel(
                pl, factors, ycck, size), 20)
            plain_ms = cuda_time_ms(lambda: images.cmyk_to_bgr_plain(
                pl, factors, ycck, size), 3)
            bnd = colour_bound(pl, H, W)
            out[f"{label}_{'ycck' if ycck else 'cmyk'}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "vs_plain": err,
                "plane_bytes": sum(p.numel() for p in pl)}
    f, o = out["file_ycck"], out["1x1_cmyk"]
    log(f"  YCCK read at {W}x{H} ({len(data)} file bytes, ratios "
        f"{layout.factors}): host parse and entropy decode "
        f"{np.round(parts['host_decode_ms'], 2)} ms (the 4:2:0 .JPG's, "
        f"{len(ref)} bytes: {np.round(ref_ms, 2)}); copy to the card "
        f"{np.round(parts['copy_to_card_ms'], 2)} ms; IDCT (4 launches) "
        f"{np.round(parts['idct_ms'], 2)} ms; colour kernel (host clock) "
        f"{np.round(parts['colour_kernel_ms'], 3)} ms; decode "
        f"{np.round(parts['decode_ms'], 2)} ms. cmyk_to_bgr_kernel (CUDA "
        f"events): the file's YCCK {f['ms']:.4f} ms (bound {f['bound_ms']:.4f}"
        f", share {f['bound_ms'] / f['ms']:.2f}; plain {f['plain_ms']:.2f}); "
        f"1x1 CMYK {o['ms']:.4f} ms (bound {o['bound_ms']:.4f}, share "
        f"{o['bound_ms'] / o['ms']:.2f}; plain {o['plain_ms']:.2f}); every "
        f"form equals plain")
    return out


def cuda_timed(fn):
    """(fn(), its ms between two CUDA events): one run of a plain twin."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def _webp_cv2() -> dict:
    """The sha-256 of WEBP_SOURCE, of cv2.imread's grey and BGR arrays of
    it and of the JAX converter's workspace image of it."""
    with open(os.path.join(os.path.dirname(WEBP_SOURCE), "cv2.json")) as f:
        return json.load(f)


def phase_webp_parts(dev):
    """Phase 8b: the committed lossy WebP source (3200x2130, view 2 of
    phase 8's scene, libwebp q75) on the card. Its path, with the counters
    set to 0 just before and read just after: the converter's image step
    (``convert.convert_image``: the read, then the JPEG encode) and the
    pipeline's read (``images.read_image``); the workspace image's bytes
    and the read's grey and BGR must have cv2's recorded sha-256, and each
    of the three kernels must have been launched twice (the reconstruction,
    the loop filter, the colour kernel), no plain twin. Then each kernel
    against its plain twin on the file's frame (no entry may differ), each
    timed with CUDA events beside its bound and the twin, and the read
    split, host clock around synchronised calls: the host's container check,
    parse and entropy decode, the copy of the records and coefficients to
    the card, each kernel, and the whole ``decode``."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.preprocess import convert
    from mpmvs_torch.utils.roofline import (vp8_filter_bound,
                                            vp8_reconstruct_bound,
                                            webp_colour_bound)
    from mpmvs_torch.utils.trace import cuda_time_ms

    want = _webp_cv2()
    with open(WEBP_SOURCE, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != want["source_sha256"]:
        raise AssertionError(f"{WEBP_SOURCE} is not the file whose cv2 reads "
                             f"were recorded")
    counters = (images.VP8_RECON_COUNTS, images.VP8_FILTER_COUNTS,
                images.WEBP_COLOUR_COUNTS, images.CODEC_COUNTS)
    with tempfile.TemporaryDirectory(prefix="mpmvs_webp_") as tmp:
        src, dst = os.path.join(tmp, "IMG_0002.webp"), os.path.join(
            tmp, "00000000.jpg")
        with open(src, "wb") as f:
            f.write(data)
        for c in counters:
            c.reset()
        t1 = time.perf_counter()
        convert.convert_image(src, dst, dev)
        t2 = time.perf_counter()
        g, c = images.read_image(src, dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = [(k.kernel, k.plain) for k in counters[:3]]
        codec = dict(images.CODEC_COUNTS.forms)
        with open(dst, "rb") as f:
            ws = hashlib.sha256(f.read()).hexdigest()
    equal_cv2 = {"gray": sha256_of(g) == want["gray_sha256"],
                 "bgr": sha256_of(c) == want["bgr_sha256"],
                 "workspace_image": ws == want["workspace_sha256"]}
    log(f"  WebP source ({len(data)} bytes): converter image step "
        f"{(t2 - t1) * 1e3:.1f} ms, read {(t3 - t2) * 1e3:.1f} ms; equal to "
        f"cv2's (grey, BGR, the converter's workspace image): {equal_cv2}; "
        f"launches (kernel, plain) reconstruction, filter, colour "
        f"{launches}; codec calls {codec}")
    if not all(equal_cv2.values()):
        raise AssertionError(f"the WebP source differs from cv2: {equal_cv2}")
    if launches != [(2, 0)] * 3 or codec.get("webp") != 2:
        raise AssertionError(f"WebP path launches {launches}, codec calls "
                             f"{codec}: expected 2 of each kernel (the "
                             f"converter's read and the pipeline's), no "
                             f"plain call")

    parts = {k: [] for k in ("host_decode_ms", "copy_to_card_ms",
                             "reconstruct_ms", "filter_ms", "colour_ms",
                             "decode_ms")}
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame, _ = images.webp_frame(data, images._library())
        t2 = time.perf_counter()
        rec = torch.from_numpy(frame.records).to(dev)
        coefs = torch.from_numpy(frame.coefs).to(dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        (H, W), (mb_h, mb_w) = frame.size, frame.mbs
        planes = images.vp8_reconstruct_kernel(rec, coefs, frame.params,
                                               mb_w, mb_h)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        images.vp8_loop_filter_kernel(*planes, rec, frame.params, mb_w, mb_h)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        images.webp_yuv_to_bgr_kernel(*planes, W, H)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        images.decode(data, dev)
        torch.cuda.synchronize()
        t7 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t1, t2), (t2, t3), (t3, t4), (t4, t5),
                                     (t5, t6), (t6, t7))):
            parts[k].append((b - a) * 1e3)
    prm = torch.from_numpy(frame.params)

    unfiltered = images.vp8_reconstruct_kernel(rec, coefs, frame.params,
                                               mb_w, mb_h)
    filtered = tuple(p.clone() for p in unfiltered)
    images.vp8_loop_filter_kernel(*filtered, rec, frame.params, mb_w, mb_h)
    got_out = images.webp_yuv_to_bgr_kernel(*filtered, W, H)
    plains = [cuda_timed(lambda: images.vp8_reconstruct_plain(
                  rec, coefs, prm, mb_w, mb_h)),
              cuda_timed(lambda: images.vp8_loop_filter_plain(
                  *unfiltered, rec, prm, mb_w, mb_h)),
              cuda_timed(lambda: images.webp_yuv_to_bgr_plain(*filtered, W,
                                                             H))]
    n_mb = mb_w * mb_h
    out = {"file_bytes": len(data), "size": [W, H], "mbs": [mb_w, mb_h],
           "header": frame.header, "equal_cv2": equal_cv2,
           "launches": launches, **parts}
    copies = [tuple(p.clone() for p in unfiltered) for _ in range(21)]

    def filter_next():  # each run on a fresh copy of the unfiltered planes
        images.vp8_loop_filter_kernel(*copies.pop(), rec, frame.params,
                                      mb_w, mb_h)

    for name, got, (want_k, plain_ms), fn, bnd in zip(
            ("vp8_reconstruct", "vp8_loop_filter", "webp_yuv_to_bgr"),
            (unfiltered, filtered, got_out), plains,
            (lambda: images.vp8_reconstruct_kernel(rec, coefs, frame.params,
                                                   mb_w, mb_h),
             filter_next,
             lambda: images.webp_yuv_to_bgr_kernel(*filtered, W, H)),
            (vp8_reconstruct_bound(frame.records), vp8_filter_bound(n_mb),
             webp_colour_bound(H, W))):
        err = [differing(a, b) for a, b in zip(got, want_k)]
        if any(e[0] for e in err):
            raise AssertionError(f"{name} kernel vs plain at full size: "
                                 f"{err}")
        ms = cuda_time_ms(fn, 20)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                     "bound_by": bnd[1], "vs_plain": err,
                     "max_abs_err": max(e[1] for e in err)}
    r, f, o = out["vp8_reconstruct"], out["vp8_loop_filter"], \
        out["webp_yuv_to_bgr"]
    log(f"  WebP read at {W}x{H} ({mb_w}x{mb_h} MBs, filter type "
        f"{frame.header['filter_type']} level {frame.header['level']}): host "
        f"container check, parse and entropy decode "
        f"{np.round(parts['host_decode_ms'], 2)} ms; copy to the card "
        f"{np.round(parts['copy_to_card_ms'], 2)} ms; reconstruction "
        f"{np.round(parts['reconstruct_ms'], 3)} ms, loop filter "
        f"{np.round(parts['filter_ms'], 3)} ms, colour "
        f"{np.round(parts['colour_ms'], 3)} ms (host clock); decode "
        f"{np.round(parts['decode_ms'], 2)} ms. CUDA events: "
        + "; ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, share "
                    f"{v['bound_ms'] / v['ms']:.4f}; plain {v['plain_ms']:.1f})"
                    for k, v in (("reconstruction", r), ("filter", f),
                                 ("colour", o)))
        + "; every kernel equals its plain twin")
    return out


def phase_tiff_jpeg_parts(dev):
    """Phase 8d: the committed JPEG-compressed TIFF source (3200x2130:
    phase 8b's source as cv2 reads it, YCbCr at (2, 2), 134 strips of 16
    rows, one JPEGTables tag and abbreviated streams) and the small YCbCr,
    BMP and PNM sources (RASTER_SOURCES) on the card. Their path, with the
    counters set to 0 just before and read just after: the converter's
    image step (``convert.convert_image``) and the pipeline's read
    (``images.read_image``) of each; the TIFF's read and workspace image
    must have cv2's recorded sha-256, the small sources' reads cv2's stored
    arrays and their workspace images the encoding of those; the IDCT must
    have been launched 3 times a read of the TIFF, the chunked colour form
    once a read, the raster kernel twice a small source (forms ycbcr,
    bmp16, bgr twice each), no plain twin. Then the chunked form and the
    IDCT over every strip against their twins on the TIFF, and the raster
    kernel's YCbCr and BMP forms against theirs on samples made from a
    seed at 3200x2130 (no entry may differ), each timed with CUDA events
    beside its bound and the twin (back-to-back calls, and the launches
    alone from a CUDA graph: ``graph_ms``); and the TIFF's read split,
    host clock around synchronised calls: the host's parse and entropy
    decode of the
    134 strips, the copy of the coefficients, the IDCT launches, the
    colour launch, and the whole ``decode``. Last, the host parses of
    3200x2130 BMP and PPM files made from the TIFF's read
    (:func:`host_parse_sources`), host clock: ``images.bmp_rows`` and
    ``images.pnm_rows`` (their samples checked) and the whole ``decode``
    of each."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.preprocess import convert
    from mpmvs_torch.utils.roofline import (chunked_colour_bound, idct_bound,
                                            raster_bound, ycbcr_raster_bound)
    from mpmvs_torch.utils.trace import cuda_graph_ms, cuda_time_ms

    data_dir = os.path.join(HERE, "tests", "data")
    with open(os.path.join(os.path.dirname(TIFF_JPEG_SOURCE), "cv2.json")) \
            as f:
        want = json.load(f)[os.path.basename(TIFF_JPEG_SOURCE)]
    with open(TIFF_JPEG_SOURCE, "rb") as f:
        data = f.read()
    counters = (images.IDCT_COUNTS, images.COUNTS, images.RASTER_COUNTS,
                images.CODEC_COUNTS, images.YCC_COUNTS, images.FDCT_COUNTS)
    sources = [TIFF_JPEG_SOURCE] + [os.path.join(data_dir, r)
                                    for r in RASTER_SOURCES]
    reads, converted = {}, {}
    with tempfile.TemporaryDirectory(prefix="mpmvs_tiff_jpeg_") as tmp:
        for c in counters:
            c.reset()
        t1 = time.perf_counter()
        for k, src in enumerate(sources):
            dst = os.path.join(tmp, f"{k:08d}.jpg")
            convert.convert_image(src, dst, dev)
            reads[src] = images.read_image(src, dev)
            with open(dst, "rb") as f:
                converted[src] = f.read()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {n: (c.kernel, c.plain, dict(c.forms)) for n, c in zip(
            ("idct", "colour", "raster", "codec", "enc_colour", "fdct"),
            counters)}
    g, c = reads[TIFF_JPEG_SOURCE]
    equal_cv2 = {"gray": sha256_of(g) == want["gray"],
                 "bgr": sha256_of(c) == want["bgr"],
                 "workspace_image": hashlib.sha256(
                     converted[TIFF_JPEG_SOURCE]).hexdigest()
                 == want["converted"]}
    small = {}
    for rel, src in zip(RASTER_SOURCES, sources[1:]):
        folder, name = os.path.split(src)
        arrays = np.load(os.path.join(folder, "cv2_arrays.npz"))
        stem = name.rsplit(".", 1)[0]
        g, c = reads[src]
        ws = images.encode_jpeg(torch.as_tensor(arrays[f"bgr_{stem}"],
                                                device=dev), dev)
        small[rel] = {"gray": bool(np.array_equal(
                          g.cpu().numpy(), arrays[f"gray_{stem}"])),
                      "bgr": bool(np.array_equal(c.cpu().numpy(),
                                                 arrays[f"bgr_{stem}"])),
                      "workspace_image": converted[src] == ws}
    log(f"  JPEG TIFF source ({len(data)} bytes) and {len(RASTER_SOURCES)} "
        f"small sources: converter image steps and reads "
        f"{(t2 - t1) * 1e3:.1f} ms; the TIFF equal to cv2's (grey, BGR, the "
        f"converter's workspace image): {equal_cv2}; the small sources "
        f"equal to cv2's arrays {small}; launches (kernel, plain, forms) "
        f"{launches}")
    if not all(equal_cv2.values()) or not all(
            all(v.values()) for v in small.values()):
        raise AssertionError(f"phase 8d's reads differ from cv2: TIFF "
                             f"{equal_cv2}, small sources {small}")
    n = len(RASTER_SOURCES)
    expect = {"idct": (6, 0), "colour": (2, 0), "raster": (2 * n, 0)}
    if any(launches[k][:2] != v for k, v in expect.items()) or \
            launches["colour"][2] != {"chunks": 2} or \
            launches["raster"][2] != {"ycbcr": 2, "bmp16": 2, "bgr": 2} or \
            launches["codec"][2].get("tiff_jpeg") != 2 or \
            launches["codec"][2].get("bmp") != 6 or \
            launches["codec"][2].get("pnm") != 2 or \
            launches["codec"][2].get("tiff") != 2:
        raise AssertionError(f"phase 8d launches {launches}: expected the "
                             f"IDCT 3 times and the chunked colour form "
                             f"once a read of the TIFF, the raster kernel "
                             f"twice a small source, no plain call")

    lib = images._library()
    parts = {k: [] for k in ("host_decode_ms", "copy_to_card_ms",
                             "idct_ms", "colour_ms", "decode_ms")}
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tj = images.tiff_jpeg_coefficients(data, lib)
        t2 = time.perf_counter()
        coefs = [torch.from_numpy(k).to(dev) for k in tj.coefs]
        qts = [torch.from_numpy(q.view(np.int16)).to(dev) for q in tj.qt]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        planes = [images.idct_islow_kernel(k, q, 8 * k.shape[0],
                                           8 * k.shape[1])
                  for k, q in zip(coefs, qts)]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        images.colour_kernel(planes, tj.factors, tj.size, tj.space,
                             tj.chunks)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        images.decode(data, dev)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t1, t2), (t2, t3), (t3, t4), (t4, t5),
                                     (t5, t6))):
            parts[k].append((b - a) * 1e3)
    H, W = tj.size
    out = {"file_bytes": len(data), "size": [W, H], "chunks":
           tj.chunks._asdict(), "equal_cv2": equal_cv2,
           "small_sources_equal_cv2": small,
           "launches": {k: [v[0], v[1], v[2]] for k, v in launches.items()},
           **parts}

    def held(name, run, plain, got, bnd, reps=20):
        want_k = plain()
        err = [differing(a, b) for a, b in zip(got, want_k)]
        if any(e[0] for e in err):
            raise AssertionError(f"{name} vs plain at full size: {err}")
        out[name] = {"ms": cuda_time_ms(run, reps),
                     "graph_ms": cuda_graph_ms(run, reps),
                     "plain_ms": cuda_time_ms(plain, 3), "bound_ms": bnd[0],
                     "bound_by": bnd[1], "vs_plain": err,
                     "max_abs_err": max(e[1] for e in err)}

    idct_k = lambda: [images.idct_islow_kernel(k, q, 8 * k.shape[0],
                                               8 * k.shape[1])
                      for k, q in zip(coefs, qts)]
    idct_p = lambda: [images.idct_islow_plain(k, q, 8 * k.shape[0],
                                              8 * k.shape[1])
                      for k, q in zip(coefs, qts)]
    held("idct_chunks", idct_k, idct_p, idct_k(),
         idct_bound(coefs, planes))
    args = (planes, tj.factors, tj.size, tj.space, tj.chunks)
    held("ycc_to_bgr_chunks", lambda: images.colour_kernel(*args),
         lambda: images.colour_plain(*args), images.colour_kernel(*args),
         chunked_colour_bound(tj.chunks, tj.factors, H, W))
    del coefs, planes
    rng = np.random.default_rng(18)
    forms = {
        "ycbcr": images.RasterForm(
            images.RASTER_YCBCR, 8, 3, 0, 0, 0, images.NARROW_ROUND257, 0,
            images.GREY_OPENCV, W, H, (W // 2) * 6, (W // 2) * 6 * (H // 2),
            sub_h=2, sub_v=2),
        "bgr": images.RasterForm(
            images.RASTER_RGB, 8, 3, 0, 0, 0, images.NARROW_SHIFT, 0,
            images.GREY_OPENCV, W, H, 3 * W, 3 * W * H, bgr=1),
        "bmp16": images.RasterForm(
            images.RASTER_BMP16, 16, 1, 0, 1, 0, images.NARROW_SHIFT, 0,
            images.GREY_OPENCV, W, H, 2 * W, 2 * W * H, green6=1)}
    for form_name, form in forms.items():
        samples = torch.from_numpy(rng.integers(
            0, 256, form.plane_bytes).astype(np.uint8)).to(dev)
        tables = np.zeros(images.TABLES_LEN, np.uint8)
        if form.kind == images.RASTER_YCBCR:
            tables[:5 * 1024] = images.ycbcr_tables(
                ref=(16., 235., 128., 240., 128., 240.)).astype(
                "<i4").view(np.uint8).reshape(-1)
        tables = torch.from_numpy(tables).to(dev)
        run = (lambda s=samples, f=form, t=tables:
               images.raster_to_bgr_kernel(s, f, t))
        held(f"raster_{form_name}", run,
             lambda s=samples, f=form, t=tables:
             images.raster_to_bgr_plain(s, f, t), run(),
             ycbcr_raster_bound(form) if form_name == "ycbcr"
             else raster_bound(form, 0))
    log(f"  JPEG TIFF read at {W}x{H} ({tj.chunks.count} strips of "
        f"{tj.chunks.height} rows): host parse and entropy decode "
        f"{np.round(parts['host_decode_ms'], 2)} ms; copy of the "
        f"coefficients {np.round(parts['copy_to_card_ms'], 2)} ms; IDCT "
        f"launches {np.round(parts['idct_ms'], 3)} ms; colour launch "
        f"{np.round(parts['colour_ms'], 3)} ms (host clock); decode "
        f"{np.round(parts['decode_ms'], 2)} ms. CUDA events: "
        + "; ".join(f"{k} {out[k]['ms']:.4f} ms, launches alone "
                    f"{out[k]['graph_ms']:.4f} (bound "
                    f"{out[k]['bound_ms']:.4f}, share "
                    f"{out[k]['bound_ms'] / out[k]['ms']:.4f}; plain "
                    f"{out[k]['plain_ms']:.1f})"
                    for k in ("idct_chunks", "ycc_to_bgr_chunks",
                              "raster_ycbcr", "raster_bgr", "raster_bmp16"))
        + "; every form equals its plain twin")
    g, c = reads[TIFF_JPEG_SOURCE]
    out["host_parse"] = {}
    for name, (blob, parse, want_samples) in host_parse_sources(
            g.cpu().numpy(), c.cpu().numpy()).items():
        t1 = time.perf_counter()
        r = parse(blob)
        t2 = time.perf_counter()
        images.decode(blob, dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if not np.array_equal(r.samples, want_samples):
            raise AssertionError(f"phase 8d: {name}'s host parse differs "
                                 f"from the samples it was made of")
        out["host_parse"][name] = {"file_bytes": len(blob),
                                   "parse_ms": (t2 - t1) * 1e3,
                                   "decode_ms": (t3 - t2) * 1e3}
    log("  host parses at 3200x2130, host clock: " + "; ".join(
        f"{k} ({v['file_bytes']} bytes) parse {v['parse_ms']:.1f} ms, "
        f"decode {v['decode_ms']:.1f} ms"
        for k, v in out["host_parse"].items()))
    torch.cuda.empty_cache()
    return out


def host_parse_sources(grey, bgr) -> dict:
    """BMP and PPM files of an (H, W) grey and BGR image (W even), each
    with its parse and the samples that parse must give: the grey as an
    8-bit grey-palette RLE8 BMP of 2-pixel runs (the run-length loop's
    most ops: W / 2 a row; each run repeats its first pixel) and of
    255-pixel absolute runs (its fewest), and the BGR as a P3 PPM of
    3-digit ASCII samples (the numpy parse)."""
    import numpy as np
    from mpmvs_torch.io import images

    H, W = grey.shape
    pairs = grey[:, 0::2]

    def bmp(stream: bytes) -> bytes:
        head = struct.pack("<iiHHIIiiII", W, H, 1, 8, 1, len(stream), 2835,
                           2835, 256, 0)
        palette = np.repeat(np.arange(256, dtype=np.uint8), 4)
        palette[3::4] = 0
        body = struct.pack("<I", 40) + head + palette.tobytes()
        return b"BM" + struct.pack("<IHHI", 14 + len(body) + len(stream), 0,
                                   0, 14 + len(body)) + body + stream

    runs = np.zeros((H, W // 2 + 1, 2), np.uint8)
    runs[:, :-1, 0], runs[:, :-1, 1] = 2, pairs  # then an end of line
    absolute = bytearray()
    for row in grey:
        for x in range(0, W, 255):
            n = min(255, W - x)
            absolute += bytes([0, n]) + row[x:x + n].tobytes() + \
                b"\0" * (n & 1)
        absolute += b"\0\0"
    rgb = bgr[..., ::-1].reshape(-1).astype(np.int64)
    digits = np.stack([rgb // 100, rgb // 10 % 10, rgb % 10,
                       np.full_like(rgb, -16)], -1) + ord("0")  # "ddd "
    ppm = b"P3\n%d %d\n255\n" % (W, H) + digits.astype(np.uint8).tobytes()
    bmp_parse, pnm_parse = images.bmp_rows, images.pnm_rows
    return {"bmp_rle8_runs2": (bmp(runs.tobytes() + b"\0\1"), bmp_parse,
                               np.repeat(pairs, 2, axis=1)),
            "bmp_rle8_absolute": (bmp(bytes(absolute) + b"\0\1"), bmp_parse,
                                  grey),
            "ppm_p3": (ppm, pnm_parse, bgr[..., ::-1].reshape(H, 3 * W))}


def phase_lossless_parts(dev):
    """Phase 8c: the committed lossless WebP source (3200x2130: phase 8b's
    source as cv2 reads it, re-encoded lossless by Pillow; subtract green,
    a predictor and a cross-colour transform) on the card. Its path, with
    the counters set to 0 just before and read just after: the converter's
    image step (``convert.convert_image``) and the pipeline's read
    (``images.read_image``); the workspace image's bytes and the read's
    grey and BGR must have cv2's recorded sha-256, and each lossless kernel
    must have been launched as the file's transforms imply (the
    predictor once a read, the colour kernel once a run of element-wise
    transforms, the conversion once), no plain twin. Then one animated
    fixture (a lossless first frame at an offset) read through the card
    against cv2's array. Then each kernel against its plain twin on the
    file (no entry may differ), each timed with CUDA events beside its
    bound and the twin, and the read split, host clock around
    synchronised calls: the container check and host entropy decode, the
    copy of the ARGB image and the transforms' data, each kernel launch,
    and the whole ``decode``."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.preprocess import convert
    from mpmvs_torch.utils.roofline import (vp8l_colour_bound,
                                            vp8l_predictor_bound,
                                            webp_argb_bound)
    from mpmvs_torch.utils.trace import cuda_time_ms

    want = _webp_cv2()["lossless"]
    with open(LOSSLESS_SOURCE, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != want["source_sha256"]:
        raise AssertionError(f"{LOSSLESS_SOURCE} is not the file whose cv2 "
                             f"reads were recorded")
    counters = {"vp8l_predictor": images.VP8L_PREDICTOR_COUNTS,
                "vp8l_colour": images.VP8L_COLOUR_COUNTS,
                "webp_argb_to_bgr": images.WEBP_ARGB_COUNTS}
    with tempfile.TemporaryDirectory(prefix="mpmvs_lossless_") as tmp:
        src, dst = os.path.join(tmp, "IMG_0003.webp"), os.path.join(
            tmp, "00000000.jpg")
        with open(src, "wb") as f:
            f.write(data)
        for c in list(counters.values()) + [images.CODEC_COUNTS]:
            c.reset()
        t1 = time.perf_counter()
        convert.convert_image(src, dst, dev)
        t2 = time.perf_counter()
        g, c = images.read_image(src, dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = {k: (v.kernel, v.plain) for k, v in counters.items()}
        colour_forms = dict(images.VP8L_COLOUR_COUNTS.forms)
        codec = dict(images.CODEC_COUNTS.forms)
        with open(dst, "rb") as f:
            ws = hashlib.sha256(f.read()).hexdigest()
    equal_cv2 = {"gray": sha256_of(g) == want["gray_sha256"],
                 "bgr": sha256_of(c) == want["bgr_sha256"],
                 "workspace_image": ws == want["workspace_sha256"]}
    img, info, _ = images.vp8l_frame(data, images._library())
    runs = images.vp8l_runs(img.transforms)
    n_pred = sum(r[0].type == images.VP8L_PREDICTOR for r in runs)
    expected = {"vp8l_predictor": (2 * n_pred, 0),
                "vp8l_colour": (2 * (len(runs) - n_pred), 0),
                "webp_argb_to_bgr": (2, 0)}
    log(f"  lossless source ({len(data)} bytes; transforms "
        f"{[images.VP8L_TRANSFORM_NAMES[t.type] for t in img.transforms]}, "
        f"bits {[t.bits for t in img.transforms]}; {img.stats}): converter "
        f"image step {(t2 - t1) * 1e3:.1f} ms, read {(t3 - t2) * 1e3:.1f} "
        f"ms; equal to cv2's (grey, BGR, the converter's workspace image): "
        f"{equal_cv2}; launches (kernel, plain) {launches} (expected "
        f"{expected}), colour runs {colour_forms}; codec calls {codec}")
    if not all(equal_cv2.values()):
        raise AssertionError(f"the lossless source differs from cv2: "
                             f"{equal_cv2}")
    if launches != expected or codec.get("webp_lossless") != 2:
        raise AssertionError(f"lossless path launches {launches}, codec "
                             f"calls {codec}: expected {expected} and 2 "
                             f"lossless reads (the converter's and the "
                             f"pipeline's), no plain call")
    arrays = np.load(os.path.join(os.path.dirname(ANIMATED_FIXTURE),
                                  "cv2_arrays.npz"))
    stem = os.path.basename(ANIMATED_FIXTURE)[:-5]
    before = images.CODEC_COUNTS.forms.get("webp_animated", 0)
    ag, ac = images.read_image(ANIMATED_FIXTURE, dev)
    animated = {"gray": bool(np.array_equal(ag.cpu().numpy(),
                                            arrays[f"gray_{stem}"])),
                "bgr": bool(np.array_equal(ac.cpu().numpy(),
                                           arrays[f"bgr_{stem}"])),
                "shape": list(ac.shape),
                "reads": images.CODEC_COUNTS.forms.get("webp_animated",
                                                       0) - before}
    log(f"  animated fixture {stem} (a 30x20 lossless first frame at (4, 8) "
        f"on a 60x50 canvas) vs cv2's arrays: {animated}")
    if not (animated["gray"] and animated["bgr"] and animated["reads"] == 1):
        raise AssertionError(f"the animated fixture differs from cv2: "
                             f"{animated}")

    H, W = img.height, img.width
    parts = {k: [] for k in ["host_decode_ms", "copy_to_card_ms"] + [
        f"launch_{i}_ms" for i in range(len(runs))] + ["argb_to_bgr_ms",
                                                      "decode_ms"]}
    for _ in range(3):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        img, info, _ = images.vp8l_frame(data, images._library())
        marks.append(time.perf_counter())
        argb, transforms = images.vp8l_upload(img, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for run in images.vp8l_runs(transforms):
            argb = images.vp8l_inverse(argb, run[::-1])
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        images.webp_argb_to_bgr_kernel(argb, info.canvas, info.offset)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        images.decode(data, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for k, a, b in zip(parts, marks, marks[1:]):
            parts[k].append((b - a) * 1e3)

    argb, transforms = images.vp8l_upload(img, dev)
    out = {"file_bytes": len(data), "size": [W, H],
           "transforms": [images.VP8L_TRANSFORM_NAMES[t.type]
                          for t in img.transforms],
           "bits": [t.bits for t in img.transforms], "stats": img.stats,
           "equal_cv2": equal_cv2, "launches": launches,
           "colour_runs": colour_forms, "animated_fixture": animated,
           **parts, "runs": []}
    for run in images.vp8l_runs(transforms):
        if run[0].type == images.VP8L_PREDICTOR:
            name = "vp8l_predictor"
            fn = lambda: images.vp8l_predictor_kernel(argb, run[0].data,
                                                      run[0].bits)
            plain = lambda: images.vp8l_predictor_plain(argb, run[0].data,
                                                        run[0].bits)
            bnd = vp8l_predictor_bound(H, argb.shape[1], run[0].data.numel())
        else:
            name = "vp8l_colour"
            fn = lambda: images.vp8l_colour_kernel(argb, run)
            plain = lambda: images.vp8l_colour_plain(argb, run)
            bnd = vp8l_colour_bound(H, argb.shape[1], run[-1].xsize,
                                    sum(t.data.numel() for t in run))
        got = fn()
        want_k, plain_ms = cuda_timed(plain)
        err = differing(got, want_k)
        if err[0]:
            raise AssertionError(f"{name} kernel vs plain at full size "
                                 f"({[t.type for t in run]}): {err}")
        out["runs"].append({
            "kernel": name, "form": "+".join(
                images.VP8L_TRANSFORM_NAMES[t.type] for t in run),
            "ms": cuda_time_ms(fn, 20), "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "vs_plain": err,
            "max_abs_err": err[1]})
        argb = got
    got = images.webp_argb_to_bgr_kernel(argb, info.canvas, info.offset)
    want_k, plain_ms = cuda_timed(lambda: images.webp_argb_to_bgr_plain(
        argb, info.canvas, info.offset))
    err = [differing(a, b) for a, b in zip(got, want_k)]
    if any(e[0] for e in err):
        raise AssertionError(f"webp_argb_to_bgr kernel vs plain at full "
                             f"size: {err}")
    bnd = webp_argb_bound(H, W, W, H)
    out["webp_argb_to_bgr"] = {
        "ms": cuda_time_ms(lambda: images.webp_argb_to_bgr_kernel(
            argb, info.canvas, info.offset), 20),
        "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
        "vs_plain": err, "max_abs_err": max(e[1] for e in err)}
    for name in ("vp8l_predictor", "vp8l_colour"):
        first = next(r for r in out["runs"] if r["kernel"] == name)
        out[name] = dict(first, forms=[r for r in out["runs"]
                                       if r["kernel"] == name])
    log(f"  lossless read at {W}x{H}: host container check and entropy "
        f"decode {np.round(parts['host_decode_ms'], 2)} ms; copy to the "
        f"card {np.round(parts['copy_to_card_ms'], 2)} ms; "
        + "; ".join(f"{r['form']} {np.round(parts[f'launch_{i}_ms'], 3)} ms"
                    for i, r in enumerate(out["runs"]))
        + f"; conversion {np.round(parts['argb_to_bgr_ms'], 3)} ms (host "
        f"clock); decode {np.round(parts['decode_ms'], 2)} ms. CUDA events: "
        + "; ".join(f"{r['form']} {r['ms']:.4f} ms (bound "
                    f"{r['bound_ms']:.4f}, share "
                    f"{r['bound_ms'] / r['ms']:.4f}; plain "
                    f"{r['plain_ms']:.1f})" for r in out["runs"] + [dict(
                        out["webp_argb_to_bgr"], form="conversion")])
        + "; every kernel equals its plain twin")
    return out


def _jpeg_cv2() -> dict:
    """conversion/cv2.json beside ARITH_SOURCE: cv2's hashes of phase 8e's
    arithmetic source and lossless streams (and of phase 8's YCCK
    source)."""
    with open(os.path.join(os.path.dirname(ARITH_SOURCE), "cv2.json")) as f:
        return json.load(f)


def _jpeg_file_module():
    """tests/data/jpeg/jpeg_file.py (numpy and scipy only), loaded by
    path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jpeg_file", JPEG_FILE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_jpeg_coding_parts(dev):
    """Phase 8e: arithmetic-coded and lossless JPEGs at 3200x2130 on the
    card. The source is phase 8b's, cv2's BGR of WEBP_SOURCE, read here by
    the card (its hash must be cv2's); ARITH_SOURCE is a 4:2:0 JPEG of it
    transcoded to arithmetic coding, and two lossless RGB streams of it
    (predictor 1 with a restart every 16 rows, predictor 7) are written
    here by jpeg_file.lossless_jpeg, each stream's sha-256 checked against
    cv2.json's. With the counters set to 0 just before: the converter's
    image step (``convert.convert_image``) of each, named ``.jpeg``, and
    the pipeline's read (``images.read_image``) of the arithmetic one; the
    hashes of that read's grey and BGR and of the three workspace images
    must be cv2's, and ``read_image`` of a lossless stream must raise
    (cv2 reads its colour only). Launches: the IDCT 3 and the colour kernel
    1 a read of the arithmetic file; for each lossless read, its form (the
    scan form's two launches for predictor 1, the wavefront's one for
    predictor 7) and one colour launch (RGB form); no plain call. Then each
    lossless form against its twin at full size (no entry may differ),
    timed with CUDA events and from a CUDA graph beside its byte bound, the
    wavefront's step count and the twin; and each read split, host clock
    around synchronised calls: the host entropy decode (QM, or lossless
    Huffman), the copy to the card, each launch and the whole decode."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.preprocess import convert
    from mpmvs_torch.utils.roofline import (colour_bound, idct_bound,
                                            ljpeg_bound)
    from mpmvs_torch.utils.trace import cuda_graph_ms, cuda_time_ms

    want = _jpeg_cv2()
    _, src = images.read_image(WEBP_SOURCE, dev)
    if sha256_of(src) != _webp_cv2()["bgr_sha256"]:
        raise AssertionError("phase 8e's source is not cv2's BGR of the "
                             "WebP source")
    bgr = src.cpu().numpy()
    jf = _jpeg_file_module()
    t0 = time.perf_counter()
    streams = {k: jf.lossless_jpeg([bgr[..., 2], bgr[..., 1], bgr[..., 0]],
                                   **kw) for k, kw in LOSSLESS_STREAMS.items()}
    write_s = time.perf_counter() - t0
    with open(ARITH_SOURCE, "rb") as f:
        arith = f.read()
    shas = {k: hashlib.sha256(v).hexdigest() for k, v in streams.items()}
    if hashlib.sha256(arith).hexdigest() != want["arith"]["source_sha256"] \
            or any(shas[k] != want[k]["stream_sha256"] for k in streams):
        raise AssertionError(f"phase 8e's files are not those whose cv2 "
                             f"reads were recorded: {shas}")
    counters = {"idct_islow": images.IDCT_COUNTS, "colour": images.COUNTS,
                "ljpeg": images.LJPEG_COUNTS}
    with tempfile.TemporaryDirectory(prefix="mpmvs_jpeg_coding_") as tmp:
        srcs = {"arith": os.path.join(tmp, "IMG_0005.jpeg"),
                **{k: os.path.join(tmp, f"IMG_{k}.jpeg") for k in streams}}
        for k, path in srcs.items():
            with open(path, "wb") as f:
                f.write(arith if k == "arith" else streams[k])
        for c in list(counters.values()) + [images.CODEC_COUNTS]:
            c.reset()
        ws, secs = {}, {}
        for k, path in srcs.items():
            t1 = time.perf_counter()
            convert.convert_image(path, os.path.join(tmp, f"{k}.jpg"), dev)
            secs[f"convert_{k}_s"] = time.perf_counter() - t1
            with open(os.path.join(tmp, f"{k}.jpg"), "rb") as f:
                ws[k] = hashlib.sha256(f.read()).hexdigest()
        t1 = time.perf_counter()
        g, c = images.read_image(srcs["arith"], dev)
        torch.cuda.synchronize()
        secs["read_arith_s"] = time.perf_counter() - t1
        refusals = {}
        for k in streams:
            try:
                images.read_image(srcs[k], dev)
            except ValueError as e:
                refusals[k] = str(e)
        launches = {k: (v.kernel, v.plain, dict(v.forms))
                    for k, v in counters.items()}
        codec = dict(images.CODEC_COUNTS.forms)
    equal_cv2 = {"arith_gray": sha256_of(g) == want["arith"]["gray_sha256"],
                 "arith_bgr": sha256_of(c) == want["arith"]["bgr_sha256"],
                 **{f"{k}_workspace": ws[k] == want[k]["workspace_sha256"]
                    for k in srcs}}
    expected = {"idct_islow": (6, 0, {}), "colour": (4, 0, {"rgb": 2}),
                "ljpeg": (3, 0, {"scan": 2, "wavefront": 1})}
    log(f"  arithmetic source ({len(arith)} bytes) and lossless streams "
        f"({ {k: len(v) for k, v in streams.items()} } bytes, written in "
        f"{write_s:.1f} s): {secs}; equal to cv2's (the arithmetic read's "
        f"grey and BGR, each converted workspace image): {equal_cv2}; "
        f"read_image of the lossless streams raises: {refusals}; launches "
        f"(kernel, plain, forms) {launches} (expected {expected}); codec "
        f"calls {codec}")
    if not all(equal_cv2.values()):
        raise AssertionError(f"phase 8e differs from cv2: {equal_cv2}")
    if launches != expected or len(refusals) != len(streams) or \
            any("colour only" not in e for e in refusals.values()) or \
            codec.get("jpeg_arith") != 2 or \
            codec.get("jpeg_lossless") != len(streams):
        raise AssertionError(f"phase 8e launches {launches}, refusals "
                             f"{refusals}, codec calls {codec}: expected "
                             f"{expected}, the lossless reads refused for "
                             f"cv2's grey, 2 arithmetic and 2 lossless "
                             f"reads")

    out = {"size": list(src.shape[1::-1]), "arith_bytes": len(arith),
           "stream_bytes": {k: len(v) for k, v in streams.items()},
           "write_streams_s": write_s, **secs, "equal_cv2": equal_cv2,
           "launches": launches, "codec": codec}
    # the arithmetic read, part by part
    parts = {k: [] for k in ("host_qm_decode_ms", "copy_to_card_ms",
                             "idct_0_ms", "idct_1_ms", "idct_2_ms",
                             "colour_ms", "decode_ms")}
    for _ in range(3):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        handle, info = images.host_decode(arith)
        marks.append(time.perf_counter())
        comps, size, layout = images.upload_coefficients(handle, info, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        planes = []
        for cp in comps:
            planes.append(images.idct_islow_kernel(*cp))
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        images.colour_kernel(planes, layout.factors, size, layout.space)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        images.decode(arith, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for k, a, b in zip(parts, marks, marks[1:]):
            parts[k].append((b - a) * 1e3)
    H, W = size
    out["arith_read"] = dict(parts, idct_bound_ms=idct_bound(
        [cp[0] for cp in comps], planes)[0], colour_bound_ms=colour_bound(
        planes, H, W)[0])
    log(f"  arithmetic read at {W}x{H}: host QM decode "
        f"{np.round(parts['host_qm_decode_ms'], 1)} ms; copy "
        f"{np.round(parts['copy_to_card_ms'], 2)} ms; IDCT "
        f"{[np.round(parts[f'idct_{i}_ms'], 3) for i in range(3)]} ms; "
        f"colour {np.round(parts['colour_ms'], 3)} ms (host clock); "
        f"decode {np.round(parts['decode_ms'], 1)} ms")
    # the lossless forms: against the twin, timed, and each read's parts
    out["forms"] = {}
    for k, data in streams.items():
        p = LOSSLESS_STREAMS[k]["predictor"]
        form = "scan" if p <= 4 else "wavefront"
        img = images.lossless_image(*images.host_decode(data))
        diffs, firsts, bands = images.ljpeg_upload(img, dev)
        fn = lambda: images.ljpeg_undiff_kernel(diffs, firsts, bands, p,
                                                img.precision, img.pts)
        got = fn()
        twin, plain_ms = cuda_timed(lambda: [images.ljpeg_undiff_plain(
            d, f, p, img.precision, pt)
            for d, f, pt in zip(diffs, firsts, img.pts)])
        err = [differing(a, b) for a, b in zip(got, twin)]
        if any(e[0] for e in err):
            raise AssertionError(f"{form} form vs its twin at full size "
                                 f"({k}): {err}")
        bnd = ljpeg_bound([tuple(d.shape) for d in diffs])
        parts = {q: [] for q in ("host_huffman_decode_ms", "copy_to_card_ms",
                                 "undiff_ms", "colour_ms", "decode_ms")}
        for _ in range(3):
            torch.cuda.synchronize()
            marks = [time.perf_counter()]
            li = images.lossless_image(*images.host_decode(data))
            marks.append(time.perf_counter())
            up = images.ljpeg_upload(li, dev)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            pl = images.ljpeg_undiff_kernel(*up, p, li.precision, li.pts)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            images.colour_kernel(pl, li.factors, li.size, li.space,
                                 fancy=False)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            images.decode_colour(data, dev)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            for q, a, b in zip(parts, marks, marks[1:]):
                parts[q].append((b - a) * 1e3)
        out["forms"][k] = {
            "form": form, "predictor": p,
            "restart_bands": int(bands.shape[1] - 1),
            "ms": cuda_time_ms(fn, 20), "graph_ms": cuda_graph_ms(fn, 10),
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "vs_plain": err, "max_abs_err": max(e[1] for e in err), **parts}
        f = out["forms"][k]
        log(f"  {k} ({form} form, {f['restart_bands']} restart band(s) a "
            f"plane): CUDA events {f['ms']:.4f} ms, graph {f['graph_ms']:.4f} ms (bound "
            f"{f['bound_ms']:.4f}, share {f['bound_ms'] / f['graph_ms']:.4f}"
            f"; twin {f['plain_ms']:.1f} ms, equal); "
            f"read: host Huffman decode "
            f"{np.round(parts['host_huffman_decode_ms'], 1)} ms, copy "
            f"{np.round(parts['copy_to_card_ms'], 2)} ms, undifferencing "
            f"{np.round(parts['undiff_ms'], 3)} ms, colour "
            f"{np.round(parts['colour_ms'], 3)} ms (host clock), "
            f"decode_colour {np.round(parts['decode_ms'], 1)} ms")
    return out


def _tiff_cv2() -> dict:
    """tests/data/tiff/conversion/cv2.json: cv2's hashes of phase 8d's JPEG
    TIFF and of phase 8f's run-time CIELab and old-style LZW TIFFs."""
    with open(os.path.join(os.path.dirname(TIFF_JPEG_SOURCE),
                           "cv2.json")) as f:
        return json.load(f)


def _split(steps, reps: int = 3):
    """Host-clock times (ms) of each of ``steps`` ((name, fn), run in turn,
    each synchronised), ``reps`` times: {name: [ms, ...]}."""
    import torch

    out = {k: [] for k, _ in steps}
    for _ in range(reps):
        for k, fn in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[k].append((time.perf_counter() - t0) * 1e3)
    return out


def dht_cut_parts(cut: bytes, dev) -> dict:
    """Phase 8f's progressive source cut inside a DHT's symbols between its
    fifth and sixth scans: CUT_SOURCE's first bytes, as many as
    conversion/cv2.json's ``progressive_cut_in_dht`` says (their sha-256
    checked). With the counters set to 0 just before, the pipeline's read
    of it as a file: its grey and BGR hashes must be cv2's, with 3
    smoothing, 3 IDCT and 1 colour launches and no plain call. Then the
    smoothing, IDCT and colour kernels against their twins on its planes
    (no entry may differ), each timed from a CUDA graph beside its bound
    and its twin, and the read split on the host clock: entropy decode,
    coefficient copy, each launch."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.utils.roofline import (colour_bound, idct_bound,
                                            smooth_bound)
    from mpmvs_torch.utils.trace import cuda_graph_ms

    rec = _jpeg_cv2()["progressive_cut_in_dht"]
    data = cut[:rec["source_bytes"]]
    if hashlib.sha256(data).hexdigest() != rec["source_sha256"]:
        raise AssertionError("phase 8f's DHT cut is not the file whose cv2 "
                             "read was recorded")
    counters = {"jpeg_smooth": images.SMOOTH_COUNTS,
                "idct_islow": images.IDCT_COUNTS, "colour": images.COUNTS}
    with tempfile.TemporaryDirectory(prefix="mpmvs_dht_cut_") as tmp:
        path = os.path.join(tmp, "IMG_dht_cut.jpg")
        with open(path, "wb") as f:
            f.write(data)
        for c in counters.values():
            c.reset()
        gray, bgr = images.read_image(path, dev)
        torch.cuda.synchronize()
        launches = {k: (v.kernel, v.plain) for k, v in counters.items()}
    equal = {"gray": sha256_of(gray) == rec["gray_sha256"],
             "bgr": sha256_of(bgr) == rec["bgr_sha256"]}
    expected = {"jpeg_smooth": (3, 0), "idct_islow": (3, 0),
                "colour": (1, 0)}
    if not all(equal.values()) or launches != expected:
        raise AssertionError(f"phase 8f's DHT cut: equal to cv2 {equal}, "
                             f"launches {launches} (expected {expected})")
    handle, info = images.host_decode(data)
    comps, size, layout = images.upload_coefficients(handle, info, dev)
    H, W = size
    coefs = [c[0] for c in comps]
    smoothed = [(images.jpeg_smooth_kernel(c[0], p),) + tuple(c[1:])
                for c, p in zip(comps, layout.smooth)]
    planes = [images.idct_islow_kernel(*c) for c in smoothed]
    steps = {
        "jpeg_smooth": (lambda: [images.jpeg_smooth_kernel(c, p) for c, p
                                 in zip(coefs, layout.smooth)],
                        lambda: [images.jpeg_smooth_plain(c, p) for c, p
                                 in zip(coefs, layout.smooth)],
                        smooth_bound(coefs)),
        "idct_islow": (lambda: [images.idct_islow_kernel(*c)
                                for c in smoothed],
                       lambda: [images.idct_islow_plain(*c)
                                for c in smoothed],
                       idct_bound(coefs, planes)),
        "colour": (lambda: images.colour_kernel(planes, layout.factors, size,
                                                layout.space),
                   lambda: images.colour_plain(planes, layout.factors, size,
                                               layout.space),
                   colour_bound(planes, H, W))}
    out = {"bytes": len(data), "size": [W, H], "equal_cv2": equal,
           "launches": launches,
           "latch": [list(p.bits) for p in layout.smooth]}
    for k, (kernel, plain, bnd) in steps.items():
        got = kernel()
        twin, plain_ms = cuda_timed(plain)
        err = [differing(a, b) for a, b in zip(got, twin)]
        if any(e[0] for e in err):
            raise AssertionError(f"phase 8f's DHT cut: {k} kernel vs its "
                                 f"twin: {err}")
        out[k] = {"graph_ms": cuda_graph_ms(kernel, 10), "plain_ms": plain_ms,
                  "bound_ms": bnd[0], "bound_by": bnd[1],
                  "max_abs_err": max(e[1] for e in err)}
    out["read"] = {k: [] for k in ("host_entropy_decode_ms",
                                   "copy_to_card_ms", "decode_ms")}
    for _ in range(3):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        decoded = images.host_decode(data)
        marks.append(time.perf_counter())
        images.upload_coefficients(*decoded, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        images.decode(data, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for k, a, b in zip(out["read"], marks, marks[1:]):
            out["read"][k].append((b - a) * 1e3)
    log(f"  the source cut inside a DHT's symbols ({len(data)} bytes, "
        f"{W}x{H}, latch {out['latch'][0]}): equal to cv2 {equal}, "
        f"launches {launches}; graph ms (bound, twin): " + ", ".join(
            f"{k} {out[k]['graph_ms']:.4f} ({out[k]['bound_ms']:.4f} "
            f"{out[k]['bound_by']}, {out[k]['plain_ms']:.1f})"
            for k in steps) + f"; host entropy decode "
        f"{np.round(out['read']['host_entropy_decode_ms'], 1)} ms, copy "
        f"{np.round(out['read']['copy_to_card_ms'], 2)} ms, decode "
        f"{np.round(out['read']['decode_ms'], 1)} ms (host clock)")
    return out


def phase_rare_parts(dev):
    """Phase 8f: a progressive JPEG cut short, a CIELab TIFF and an old-
    style LZW TIFF at 3200x2130 on the card. CUT_SOURCE (committed: phase
    8b's source as cv2.imencode's progressive 4:2:0 q90 JPEG, cut inside
    its sixth scan) is read with libjpeg-turbo's block smoothing; the two
    TIFFs are made here from phase 8b's source as the card reads it (its
    hash must be cv2's) by tests/data/tiff/tiff_file.py's
    rare_conversion_sources, their bytes' sha-256 checked against
    tests/data/tiff/conversion/cv2.json. With the counters set to 0 just
    before: the converter's image step of each (named ``.jpeg`` and
    ``.tif``) and the pipeline's read; the hashes of each read's grey and
    BGR and of each workspace image must be cv2's. Launches: the smoothing
    kernel 3, the IDCT 3 and the colour kernel 1 a read of the cut JPEG;
    the raster kernel 1 a TIFF read, its CIELab form for the CIELab one; no
    plain call. Then the smoothing kernel (each component of the cut file)
    and the CIELab form (the CIELab TIFF's samples) against their twins
    (no entry may differ), timed with CUDA events and from a CUDA graph
    beside their bounds and the twins; and each read split, host clock
    around synchronised calls: the host's entropy decode or parse and
    decompression, the copy to the card, each launch and the whole
    decode."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.preprocess import convert
    from mpmvs_torch.utils.roofline import (cielab_bound, colour_bound,
                                            idct_bound, raster_bound,
                                            smooth_bound)
    from mpmvs_torch.utils.trace import cuda_graph_ms, cuda_time_ms

    want_jpeg, want_tiff = _jpeg_cv2()["progressive_cut"], _tiff_cv2()
    _, src = images.read_image(WEBP_SOURCE, dev)
    if sha256_of(src) != _webp_cv2()["bgr_sha256"]:
        raise AssertionError("phase 8f's source is not cv2's BGR of the "
                             "WebP source")
    t0 = time.perf_counter()
    tiffs = _tiff_file().rare_conversion_sources(src.cpu().numpy())
    write_s = time.perf_counter() - t0
    with open(CUT_SOURCE, "rb") as f:
        cut = f.read()
    shas = {k: hashlib.sha256(v).hexdigest() for k, v in tiffs.items()}
    if hashlib.sha256(cut).hexdigest() != want_jpeg["source_sha256"] or \
            any(shas[k] != want_tiff[k]["source"] for k in tiffs):
        raise AssertionError(f"phase 8f's files are not those whose cv2 "
                             f"reads were recorded: {shas}")
    lab_name, lzw_name = "lab_3200x2130.tif", "old_lzw_3200x2130.tif"
    counters = {"jpeg_smooth": images.SMOOTH_COUNTS,
                "idct_islow": images.IDCT_COUNTS, "colour": images.COUNTS,
                "raster": images.RASTER_COUNTS}
    with tempfile.TemporaryDirectory(prefix="mpmvs_rare_") as tmp:
        srcs = {"cut": os.path.join(tmp, "IMG_cut.jpeg"),
                lab_name: os.path.join(tmp, "IMG_lab.tif"),
                lzw_name: os.path.join(tmp, "IMG_old_lzw.tif")}
        for k, path in srcs.items():
            with open(path, "wb") as f:
                f.write(cut if k == "cut" else tiffs[k])
        for c in list(counters.values()) + [images.CODEC_COUNTS]:
            c.reset()
        ws, reads, secs = {}, {}, {}
        for k, path in srcs.items():
            t1 = time.perf_counter()
            convert.convert_image(path, os.path.join(tmp, "ws.jpg"), dev)
            secs[f"convert_{k}_s"] = time.perf_counter() - t1
            with open(os.path.join(tmp, "ws.jpg"), "rb") as f:
                ws[k] = hashlib.sha256(f.read()).hexdigest()
            t1 = time.perf_counter()
            reads[k] = images.read_image(path, dev)
            torch.cuda.synchronize()
            secs[f"read_{k}_s"] = time.perf_counter() - t1
        launches = {k: (v.kernel, v.plain, dict(v.forms))
                    for k, v in counters.items()}
        codec = dict(images.CODEC_COUNTS.forms)
    equal_cv2 = {"cut_gray": sha256_of(reads["cut"][0]) ==
                 want_jpeg["gray_sha256"],
                 "cut_bgr": sha256_of(reads["cut"][1]) ==
                 want_jpeg["bgr_sha256"],
                 "cut_workspace": ws["cut"] == want_jpeg["workspace_sha256"]}
    for k in tiffs:
        equal_cv2.update({f"{k}_gray": sha256_of(reads[k][0]) ==
                          want_tiff[k]["gray"],
                          f"{k}_bgr": sha256_of(reads[k][1]) ==
                          want_tiff[k]["bgr"],
                          f"{k}_workspace": ws[k] == want_tiff[k]["converted"]})
    expected = {"jpeg_smooth": (6, 0, {}), "idct_islow": (6, 0, {}),
                "colour": (2, 0, {}), "raster": (4, 0, {"cielab": 2})}
    log(f"  cut progressive source ({len(cut)} bytes), CIELab and old-style "
        f"LZW TIFFs ({ {k: len(v) for k, v in tiffs.items()} } bytes, "
        f"written in {write_s:.1f} s): {secs}; equal to cv2's (each read's "
        f"grey and BGR, each converted workspace image): {equal_cv2}; "
        f"launches (kernel, plain, forms) {launches} (expected {expected}); "
        f"codec calls {codec}")
    if not all(equal_cv2.values()):
        raise AssertionError(f"phase 8f differs from cv2: {equal_cv2}")
    if launches != expected or codec.get("tiff") != 4 or \
            codec.get("decode") != 2:
        raise AssertionError(f"phase 8f launches {launches}, codec calls "
                             f"{codec}: expected {expected}, 4 TIFF reads "
                             f"and 2 JPEG decodes")
    out = {"size": list(src.shape[1::-1]), "cut_bytes": len(cut),
           "tiff_bytes": {k: len(v) for k, v in tiffs.items()},
           "write_tiffs_s": write_s, **secs, "equal_cv2": equal_cv2,
           "launches": launches, "codec": codec}

    # the smoothing kernel: against its twin, timed, and the cut read's parts
    handle, info = images.host_decode(cut)
    comps, size, layout = images.upload_coefficients(handle, info, dev)
    coefs = [c[0] for c in comps]
    smooth = lambda: [images.jpeg_smooth_kernel(c, p)
                      for c, p in zip(coefs, layout.smooth)]
    got = smooth()
    twin, plain_ms = cuda_timed(lambda: [images.jpeg_smooth_plain(c, p)
                                         for c, p in zip(coefs,
                                                         layout.smooth)])
    err = [differing(a, b) for a, b in zip(got, twin)]
    if any(e[0] for e in err):
        raise AssertionError(f"smoothing kernel vs its twin at full size: "
                             f"{err}")
    bnd = smooth_bound(coefs)
    parts = {k: [] for k in ("host_entropy_decode_ms", "copy_to_card_ms",
                             "smooth_ms", "idct_ms", "colour_ms",
                             "decode_ms")}
    for _ in range(3):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        decoded = images.host_decode(cut)
        marks.append(time.perf_counter())
        cs, size, lay = images.upload_coefficients(*decoded, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        cs = [(images.jpeg_smooth_kernel(c[0], p),) + tuple(c[1:])
              for c, p in zip(cs, lay.smooth)]
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        planes = [images.idct_islow_kernel(*c) for c in cs]
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        images.colour_kernel(planes, lay.factors, size, lay.space)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        images.decode(cut, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for k, a, b in zip(parts, marks, marks[1:]):
            parts[k].append((b - a) * 1e3)
    H, W = size
    out["jpeg_smooth"] = {
        "components": [list(c.shape[:2]) for c in coefs],
        "latch": [list(p.bits) for p in layout.smooth],
        "last_good": layout.smooth[0].last_good,
        "ms": cuda_time_ms(smooth, 20), "graph_ms": cuda_graph_ms(smooth, 10),
        "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
        "vs_plain": err, "max_abs_err": max(e[1] for e in err)}
    out["cut_read"] = dict(parts, idct_bound_ms=idct_bound(
        coefs, planes)[0], colour_bound_ms=colour_bound(planes, H, W)[0])
    s = out["jpeg_smooth"]
    log(f"  smoothing kernel on the cut source's {len(coefs)} components "
        f"({s['components']} blocks; last good iMCU row {s['last_good']}): "
        f"CUDA events {s['ms']:.4f} ms, graph {s['graph_ms']:.4f} ms (bound "
        f"{s['bound_ms']:.4f} ({s['bound_by']}), share "
        f"{s['bound_ms'] / s['graph_ms']:.4f}; twin {s['plain_ms']:.1f} ms, "
        f"equal); read at {W}x{H}: host entropy decode "
        f"{np.round(parts['host_entropy_decode_ms'], 1)} ms, copy "
        f"{np.round(parts['copy_to_card_ms'], 2)} ms, smoothing "
        f"{np.round(parts['smooth_ms'], 3)} ms, IDCT "
        f"{np.round(parts['idct_ms'], 3)} ms, colour "
        f"{np.round(parts['colour_ms'], 3)} ms (host clock), decode "
        f"{np.round(parts['decode_ms'], 1)} ms")

    out["dht_cut"] = dht_cut_parts(cut, dev)

    # the CIELab form against its twin, timed; each TIFF read's parts
    lib = images._library()
    for k in tiffs:
        r = images.raster_rows(tiffs[k], lib)
        samples = torch.from_numpy(r.samples).to(dev)
        tables = torch.from_numpy(r.tables).to(dev)
        fn = lambda: images.raster_to_bgr_kernel(samples, r.form, tables)
        parts = _split([
            ("host_parse_decompress_ms", lambda: images.raster_rows(
                tiffs[k], lib)),
            ("copy_to_card_ms", lambda: (torch.from_numpy(r.samples).to(dev),
                                         torch.from_numpy(r.tables).to(dev))),
            ("kernel_ms", fn),
            ("decode_ms", lambda: images.decode(tiffs[k], dev))])
        row = {"form": images.raster_form_name(r.form) or "rgb", **parts}
        if k == lab_name:
            got = fn()
            want, plain_ms = cuda_timed(lambda: images.raster_to_bgr_plain(
                samples, r.form, tables))
            err = [differing(a, b) for a, b in zip(got, want)]
            if any(e[0] for e in err):
                raise AssertionError(f"CIELab form vs its twin at full "
                                     f"size: {err}")
            bnd = cielab_bound(r.form)
            row.update(ms=cuda_time_ms(fn, 20), graph_ms=cuda_graph_ms(fn,
                                                                       10),
                       plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                       vs_plain=err, max_abs_err=max(e[1] for e in err))
            log(f"  CIELab form on {r.form.width}x{r.form.height} 8-bit "
                f"samples: CUDA events {row['ms']:.4f} ms, graph "
                f"{row['graph_ms']:.4f} ms (bound {row['bound_ms']:.4f} "
                f"({row['bound_by']}), share "
                f"{row['bound_ms'] / row['graph_ms']:.4f}; twin "
                f"{row['plain_ms']:.1f} ms, equal)")
        else:
            row["bound_ms"] = raster_bound(r.form, 0)[0]
        out[k] = row
        log(f"  {k} read: host parse and "
            f"{'LZW' if k == lab_name else 'old-style LZW'} "
            f"{np.round(parts['host_parse_decompress_ms'], 1)} ms, copy "
            f"{np.round(parts['copy_to_card_ms'], 2)} ms, raster kernel "
            f"({row['form']} form) {np.round(parts['kernel_ms'], 3)} ms "
            f"(host clock), decode {np.round(parts['decode_ms'], 1)} ms")
    return out


def _jp2_cv2() -> dict:
    """The sha-256 of each JP2_SOURCES file, of cv2.imread's grey and BGR
    arrays of it and of the JAX converter's workspace image of it."""
    with open(os.path.join(JP2_CONVERSION, "cv2.json")) as f:
        return json.load(f)


def phase_jp2_parts(dev):
    """Phase 8g: the three committed 3200x2130 JPEG 2000 sources (phase
    8b's source as cv2 reads it: a lossless 5/3 JP2 written by cv2.imwrite,
    no colour transform; a 9/7 ICT JP2 written by Pillow with 1024x1024
    tiles, RPCL order, 128x128 precincts and three rate layers; a 5/3 RCT
    JP2 written by Pillow, one tile, three rate layers) on the card. With the counters set to 0 just before: the converter's image
    step of each (named ``.jp2``: the read, then the JPEG encode) and the
    pipeline's read; the hashes of each read's grey and BGR and of each
    workspace image must be cv2's (tests/data/jp2/conversion/cv2.json).
    Launches: j2k_idwt_kernel two a level and wavelet (rows, then
    columns), j2k_colour_kernel one, a read; no plain call. Then each kernel against its twin at full size
    (no entry may differ), timed with CUDA events and from a CUDA graph
    beside its bound and its twin; and each read split, host clock around
    synchronised calls: the host's parse and tier-1, the copy to the card,
    each level's two launches, the colour launch and the whole decode."""
    import numpy as np
    import torch
    from mpmvs_torch.io import images
    from mpmvs_torch.preprocess import convert
    from mpmvs_torch.utils.roofline import j2k_colour_bound, j2k_idwt_bound
    from mpmvs_torch.utils.trace import cuda_graph_ms, cuda_time_ms

    want = _jp2_cv2()
    data = {}
    for key, name in JP2_SOURCES.items():
        with open(os.path.join(JP2_CONVERSION, name), "rb") as f:
            data[key] = f.read()
        if hashlib.sha256(data[key]).hexdigest() != \
                want[key]["source_sha256"]:
            raise AssertionError(f"phase 8g's {name} is not the file whose "
                                 f"cv2 reads were recorded")
    lib = images._library()
    imgs = {k: images.j2k_host_image(v, lib) for k, v in data.items()}
    expected_idwt, expected_forms = 0, {}
    for img in imgs.values():
        sched, col = images.j2k_schedule(img), images.j2k_colour_form(img)
        for lv in sched:  # two reads a source, two launches a level
            expected_forms[str(lv.form)] = \
                expected_forms.get(str(lv.form), 0) + 4
        expected_forms[col.form] = expected_forms.get(col.form, 0) + 2
        expected_idwt += 4 * len(sched)
    counters = {"j2k": images.J2K_COUNTS, "enc_colour": images.YCC_COUNTS,
                "fdct": images.FDCT_COUNTS}
    with tempfile.TemporaryDirectory(prefix="mpmvs_jp2_") as tmp:
        srcs = {k: os.path.join(tmp, f"IMG_{k}.jp2") for k in data}
        for k, path in srcs.items():
            with open(path, "wb") as f:
                f.write(data[k])
        for c in list(counters.values()) + [images.CODEC_COUNTS]:
            c.reset()
        ws, reads, secs = {}, {}, {}
        for k, path in srcs.items():
            t1 = time.perf_counter()
            convert.convert_image(path, os.path.join(tmp, "ws.jpg"), dev)
            secs[f"convert_{k}_s"] = time.perf_counter() - t1
            with open(os.path.join(tmp, "ws.jpg"), "rb") as f:
                ws[k] = hashlib.sha256(f.read()).hexdigest()
            t1 = time.perf_counter()
            reads[k] = images.read_image(path, dev)
            torch.cuda.synchronize()
            secs[f"read_{k}_s"] = time.perf_counter() - t1
        launches = {k: (v.kernel, v.plain, dict(v.forms))
                    for k, v in counters.items()}
        codec = dict(images.CODEC_COUNTS.forms)
    equal_cv2 = {}
    for k in data:
        equal_cv2.update({
            f"{k}_gray": sha256_of(reads[k][0]) == want[k]["gray_sha256"],
            f"{k}_bgr": sha256_of(reads[k][1]) == want[k]["bgr_sha256"],
            f"{k}_workspace": ws[k] == want[k]["workspace_sha256"]})
    expected = (expected_idwt + len(data) * 2, 0, expected_forms)
    log(f"  JPEG 2000 sources ({ {k: len(v) for k, v in data.items()} } "
        f"bytes): {secs}; equal to cv2's (each read's grey and BGR, each "
        f"converted workspace image): {equal_cv2}; launches (kernel, plain, "
        f"forms) {launches} (j2k expected {expected}); codec calls {codec}")
    if not all(equal_cv2.values()):
        raise AssertionError(f"phase 8g differs from cv2: {equal_cv2}")
    if launches["j2k"] != expected or codec.get("jp2") != 2 * len(data) or \
            launches["enc_colour"][1] or launches["fdct"][1] or \
            launches["enc_colour"][0] != len(data):
        raise AssertionError(f"phase 8g launches {launches}, codec calls "
                             f"{codec}: expected j2k {expected}, "
                             f"{2 * len(data)} JPEG 2000 reads and "
                             f"{len(data)} encodes")
    out = {"size": list(reads["lossless"][1].shape[1::-1]),
           "bytes": {k: len(v) for k, v in data.items()}, **secs,
           "equal_cv2": equal_cv2, "launches": launches, "codec": codec}

    # each kernel against its twin at full size, timed; each read's parts
    for k, img in imgs.items():
        coef0, sched, col = images.j2k_upload(img, dev)
        coef, scratch = coef0.clone(), torch.empty_like(coef0)
        err, plain_ms = [], 0.0
        for lv in sched:
            twin, ms = cuda_timed(lambda: images.j2k_idwt_plain(coef, lv))
            plain_ms += ms
            images.j2k_idwt_kernel(coef, scratch, lv)
            err.append(differing(coef, twin))
        cgot = images.j2k_colour_kernel(coef, col)
        ctwin, cplain_ms = cuda_timed(lambda: images.j2k_colour_plain(coef,
                                                                      col))
        cerr = [differing(a, b) for a, b in zip(cgot, ctwin)]
        if any(e[0] for e in err + cerr):
            raise AssertionError(f"phase 8g {k}: kernels vs twins at full "
                                 f"size: IDWT {err}, colour {cerr}")
        work = coef0.clone()
        idwt = lambda: [images.j2k_idwt_kernel(work, scratch, lv)
                        for lv in sched]
        colour = lambda: images.j2k_colour_kernel(coef, col)
        bnds = [j2k_idwt_bound(lv) for lv in sched]
        levels = []
        for lv, bnd in zip(sched, bnds):
            one = lambda lv=lv: images.j2k_idwt_kernel(work, scratch, lv)
            levels.append({"level": lv.level, "form": lv.form,
                           "jobs": lv.jobs.numel() // 8, "rows": lv.rows,
                           "cols": lv.cols, "ms": cuda_time_ms(one, 20),
                           "graph_ms": cuda_graph_ms(one, 10),
                           "bound_ms": bnd[0], "bound_by": bnd[1]})
        idwt_bnd = (sum(b[0] for b in bnds),
                    "operations" if any(b[1] == "operations" for b in bnds)
                    else "bytes")
        cbnd = j2k_colour_bound(col)
        row = {"form": str(sched[0].form), "colour_form": col.form,
               "tiles": int(img.info[5] * img.info[6]),
               "code_blocks": int(img.info[14]), "levels": levels,
               "idwt": {"launches_a_read": 2 * len(sched),
                        "ms": cuda_time_ms(idwt, 20),
                        "graph_ms": cuda_graph_ms(idwt, 10),
                        "plain_ms": plain_ms, "bound_ms": idwt_bnd[0],
                        "bound_by": idwt_bnd[1], "vs_plain": err,
                        "max_abs_err": max(e[1] for e in err)},
               "colour": {"ms": cuda_time_ms(colour, 20),
                          "graph_ms": cuda_graph_ms(colour, 10),
                          "plain_ms": cplain_ms, "bound_ms": cbnd[0],
                          "bound_by": cbnd[1], "vs_plain": cerr,
                          "max_abs_err": max(e[1] for e in cerr)}}
        parts = {p: [] for p in ("host_parse_tier1_ms", "copy_to_card_ms",
                                 "idwt_ms", "colour_ms", "decode_ms")}
        level_ms = [[] for _ in sched]
        for _ in range(3):
            torch.cuda.synchronize()
            marks = [time.perf_counter()]
            im = images.j2k_host_image(data[k], lib)
            marks.append(time.perf_counter())
            c2, s2, col2 = images.j2k_upload(im, dev)
            sc2 = torch.empty_like(c2)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            for i, lv in enumerate(s2):
                t0 = time.perf_counter()
                images.j2k_idwt_kernel(c2, sc2, lv)
                torch.cuda.synchronize()
                level_ms[i].append((time.perf_counter() - t0) * 1e3)
            marks.append(time.perf_counter())
            images.j2k_colour_kernel(c2, col2)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            images.decode(data[k], dev)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            for p, a, b in zip(parts, marks, marks[1:]):
                parts[p].append((b - a) * 1e3)
        row["read_parts"] = dict(parts, idwt_level_ms=level_ms)
        out[k] = row
        i, c = row["idwt"], row["colour"]
        log(f"  {JP2_SOURCES[k]} ({row['tiles']} tiles, "
            f"{row['code_blocks']} code-blocks): read split (host clock): "
            f"host parse and tier-1 "
            f"{np.round(parts['host_parse_tier1_ms'], 1)} ms, copy "
            f"{np.round(parts['copy_to_card_ms'], 2)} ms, IDWT levels "
            f"{[np.round(m, 3).tolist() for m in level_ms]} ms, colour "
            f"{np.round(parts['colour_ms'], 3)} ms, decode "
            f"{np.round(parts['decode_ms'], 1)} ms; j2k_idwt_kernel "
            f"({row['form']}, {i['launches_a_read']} launches): CUDA events "
            f"{i['ms']:.4f} ms, graph {i['graph_ms']:.4f} ms (bound "
            f"{i['bound_ms']:.4f} ({i['bound_by']}), share "
            f"{i['bound_ms'] / i['graph_ms']:.4f}; twin {i['plain_ms']:.1f} "
            f"ms, equal); j2k_colour_kernel ({row['colour_form']}): CUDA "
            f"events {c['ms']:.4f} ms, graph {c['graph_ms']:.4f} ms (bound "
            f"{c['bound_ms']:.4f} ({c['bound_by']}), share "
            f"{c['bound_ms'] / c['graph_ms']:.4f}; twin {c['plain_ms']:.1f} "
            f"ms, equal)")
    return out


def phase_dummy_source(files, params):
    """Phase 9 (a): the NCC kernel (both launches) and the fused sorted
    path at 3200x2130 with one zero-extent source, phase 8's view 0 with
    sources 1, 2 and the sharded pipeline's dummy (all-zero image, identity
    camera, width = height = 0), against their plain versions on a band of
    PHASE2_ROWS rows of random planes at scale 0: no entry may differ, and
    the dummy scores cost_max everywhere. Returns the entries compared."""
    import numpy as np
    import torch
    from mpmvs_torch.camera import Camera, CameraStack
    from mpmvs_torch.ops import ncc_cuda, ncc_sorted
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.solver import build_solve_data

    dev = torch.device("cuda", 0)
    images = torch.as_tensor(files["images"][:4], device=dev).clone()
    images[-1] = 0.0
    cams = files["cameras"]
    stack = CameraStack.stack([cams.view(v) for v in range(3)] + [
        Camera.create(K=np.eye(3), R=np.eye(3), t=np.zeros(3), width=0,
                      height=0)]).to(dev)
    data = build_solve_data(images, stack)
    refside, x_p, y_p = band_inputs(data, params, 0, 1024,
                                    PHASE2_ROWS, 1)
    planes = test_planes(data, None, params, "random", 9, x_p, y_p,
                         tf.PRNGKey(91, device=dev))
    args = (refside, data.src_imgs, data.src_widths, data.src_heights,
            data.A, data.b, data.K_ref)
    tail = (params.tap_offsets(0), params.cost_max, params.cap_radius(0))
    checks = {}
    want = ncc_cuda.ncc_eval_multi_plain(*args, planes, x_p, y_p, *tail)
    for launch, scattered in (("tile", False), ("view-major", True)):
        got = ncc_cuda.ncc_eval_multi(*args, planes, x_p, y_p, *tail,
                                      scattered=scattered)
        checks[f"ncc {launch}"] = (int(differs(got, want).sum()),
                                   got.numel())
    got = ncc_sorted.ncc_eval_sorted_kernel(*args, planes[0], x_p, y_p,
                                            *tail)
    want_s = ncc_sorted.ncc_eval_sorted_plain(*args, planes[0], x_p, y_p,
                                              *tail)
    torch.cuda.synchronize()
    checks["fused sorted"] = (int(differs(got, want_s).sum()), got.numel())
    dummy = bool((want[:, -1] == params.cost_max).all()) and bool(
        (want_s[-1] == params.cost_max).all())
    log(f"  one zero-extent source at {W_FULL}x{H_FULL}, K=9, "
        f"{PHASE2_ROWS} rows, scale 0: entries differing from plain "
        f"{checks}; the dummy scores cost_max everywhere: {dummy}")
    if any(d for d, _ in checks.values()) or not dummy:
        raise AssertionError(f"zero-extent source: {checks}, dummy {dummy}")
    return checks


def phase_multi_gpu(files, root: str):
    """Phase 9 (b): phase 8's converted workspace through
    ``cli.main([..., "--devices", "all"])``: one process per card over
    NCCL (R = torch.cuda.device_count()), the default schedule with sky
    and fusion. Checks median |d-gt|/gt < 1% on ground rows of every view,
    the PLY, and each rank's launches (from its ``rank_<r>.json``, counted
    in its own process over the run) against the schedule: the NCC kernel
    per view and prior sub-run of the rank, the sky stage's bilateral
    kernel and table on rank 0, the colour kernel once per view a rank
    loads, no plain call. Prints each depth map's digest."""
    import hashlib

    import numpy as np
    import torch
    from mpmvs_torch import cli
    from mpmvs_torch.io import read_dmb, read_ply_binary

    R = torch.cuda.device_count()
    V = FILES_VIEWS
    out = os.path.join(root, "out_devices")
    torch.cuda.empty_cache()   # the ranks' own processes share the card
    t0 = time.perf_counter()
    rc = cli.main(["--input", files["ws"], "--output", out, "--sky-seg", "1",
                   "--config", files["config"], "--devices", "all"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main --devices all returned {rc}")
    ground = slice(SKY_ROWS + GROUND_MARGIN, H_FULL)
    rel, digests = {}, {}
    for v in range(V):
        path = os.path.join(out, "MPMVS", f"2333_{v:08d}", "depths.dmb")
        with open(path, "rb") as f:
            digests[v] = hashlib.sha256(f.read()).hexdigest()[:16]
        d, gt = read_dmb(path), files["gt_depth"][v]
        if d.shape != gt.shape or not np.isfinite(d).all():
            raise AssertionError(f"view {v}: depth map {d.shape}")
        rel[v] = float(np.median(np.abs(d[ground] - gt[ground])
                                 / gt[ground]))
    pts = read_ply_binary(os.path.join(out, "MPMVS", "MPMVS_model.ply"))[0]
    ranks, bad_counts = [], []
    for r in range(R):
        with open(os.path.join(out, "MPMVS", f"rank_{r}.json")) as f:
            rec = json.load(f)
        n_views = len(rec["views"])
        n_prior = sum(st == "prior" for _, st, _ in rec["solve_log"])
        want = {"ncc_eval": n_views * (NCC_PHOTOMETRIC + 2 * NCC_GEOM)
                + n_prior * NCC_PRIOR,
                "bilateral": V if r == 0 else 0,
                "bilateral_table": 1 if r == 0 else 0,
                "ycc_to_bgr": V, "idct": 3 * V, "ncc_sorted": 0,
                "ncc_keys": 0}
        got = rec["launches"]
        plain = {k: n for k, n in got.items() if k.endswith("_plain") and n}
        if any(got[k] != n for k, n in want.items()) or plain:
            bad_counts.append((r, got, want))
        ranks.append({"rank": r, "device": rec["device"],
                      "views": rec["views"], "prior_sub_runs": n_prior,
                      "launches": {k: got[k] for k in want},
                      "passes": {p["pass"]: p["wall_s"]
                                 for p in rec["passes"]},
                      "collectives": [(c["op"], c["bytes"], c["ms"])
                                      for c in rec["collectives"]]})
    log(f"  --devices all over {R} rank(s) (nccl): {wall:.1f} s; median "
        f"|d-gt|/gt on ground rows {rel}; PLY {len(pts)} points; depth "
        f"digests {digests}")
    for rk in ranks:
        log(f"  rank {rk['rank']}: {json.dumps(rk)}")
    bad = {v: e for v, e in rel.items() if not e < 0.01}
    if bad or len(pts) == 0:
        raise AssertionError(f"--devices all: median rel error >= 1% {bad}, "
                             f"PLY {len(pts)} points")
    if bad_counts:
        raise AssertionError(f"--devices all launches (rank, got, "
                             f"schedule): {bad_counts}")
    return {"ranks": R, "wall_s": wall, "rel": rel, "digests": digests,
            "points": len(pts), "per_rank": ranks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1, 2 and 5 only, no result line")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "mpmvs_torch")):
        print("mpmvs_torch/ not found beside chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mpmvs_torch.ops import bilateral_cuda
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.solver import build_solve_data, solve_band_rows
    from mpmvs_torch.tools import build_kernels
    from mpmvs_torch.utils.roofline import (bilateral_bound, ncc_bound,
                                            table_bound)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"phase 1: device {name}; nvidia-smi: {smi}; torch {torch.__version__}"
        f" CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_kernels(dev, verbose=True)
    log(f"  kernel builds (in parallel) {time.perf_counter() - t0:.2f} s")
    log("phase 1b: the image fixtures on the card vs cv2's arrays and bytes")
    fixtures, fixture_facts = phase_fixtures()

    params = PatchMatchParams()
    scene = make_scene()
    data = build_solve_data(torch.as_tensor(scene.images, device=dev),
                            scene.cameras.to(dev))
    for geom in (False, True):
        band_rows = solve_band_rows(params, H_FULL, W_FULL, N_SRC, geom)
        if band_rows != H_FULL:
            raise AssertionError(f"band rows {band_rows} (geom/prior modes: "
                                 f"{geom}): the H100 band budget should hold "
                                 f"{W_FULL}x{H_FULL} at S={N_SRC} in one "
                                 f"band")

    log("phase 2: NCC kernel vs plain")
    worst, max_err, ms_k, ms_p = phase_kernel_vs_plain(data, scene, params,
                                                       band_rows)
    if not args.quick:
        log("phase 3: initial scoring and half-iterations, kernel vs plain")
        src_depths = torch.as_tensor(scene.gt_depth[1:], device=dev)
        err3, state = phase_half_iteration(data, params, band_rows,
                                           src_depths)
        max_err = max(max_err, err3)
        log("phase 3b: geometric-cost kernel vs plain twin at the geom band "
            "shape")
        geom_out = phase_geom_cost(data, scene, params, band_rows,
                                   src_depths, state)
        del state, src_depths
    if not args.quick:
        log("phase 7: the sorted path (key, fused and raw-samples kernels) "
            "and the reference semantics")
        sorted_out = phase_sorted(data, scene, params)
    del data
    torch.cuda.empty_cache()
    if not args.quick:
        log("phase 4: photometric path through Pipeline")
        phase_pipeline(scene, params)
    paint_sky(scene)
    log("phase 5: bilateral kernel (both forms) vs plain")
    bil = phase_bilateral(scene)
    if args.quick:
        log(f"quick: NCC worst mismatch {worst:.3e}, max err {max_err:.3e}; "
            f"bilateral max err {bil['max_abs_err']:.3e}")
        return 0
    torch.cuda.empty_cache()
    log("phase 6: full path (photometric, geom_0 + prior, geom_1, sky, "
        "fusion) through Pipeline")
    ncc_launches, geom_launches, bil_forms, table_builds = phase_full_path(
        scene, params)
    del scene
    torch.cuda.empty_cache()
    log("phase 8: from files: COLMAP model -> mpmvs_torch.preprocess.convert "
        "-> mpmvs_torch.cli.main (default schedule, sky, previews)")
    with tempfile.TemporaryDirectory(prefix="mpmvs_files_") as root:
        files = phase_files(params, root)
        log("phase 9: multi-GPU: phase 8's workspace through cli.main "
            "--devices all (one process per card, NCCL)")
        dummy = phase_dummy_source(files, params)
        multi = phase_multi_gpu(files, root)
    for k in ("images", "cameras", "gt_depth"):
        del files[k]

    # bounds at the timed shapes: the NCC kernel at phase 2's K=9 band
    # (scale 0, default cap), the bilateral kernel over view 0's in-image
    # taps, the sorted kernels per view at phase 7's init field
    P = band_rows * (W_FULL // 2)
    k9_bound = ncc_bound(9, N_SRC, P, len(params.tap_offsets(0)),
                         4 * N_SRC * H_FULL * W_FULL, True)
    bil_bound = bilateral_bound(H_FULL, W_FULL, bilateral_cuda.RADIUS)
    tab_bound = table_bound(bilateral_cuda.TABLE_SIZE)
    so, go = sorted_out, geom_out
    log(f"bounds (ms, set by) vs measured: NCC kernel K=9 band "
        f"{k9_bound[0]:.3f} ({k9_bound[1]}) vs {ms_k:.3f}; bilateral "
        f"{bil_bound[0]:.3f} ({bil_bound[1]}) vs {bil['ms']['table']:.3f} "
        f"(table form), {bil['ms']['float']:.3f} (float form); fused sorted "
        f"kernel {so['fused_bound'][0]:.3f} ({so['fused_bound'][1]}) vs "
        f"{so['fused_ms']:.3f} per view; raw-samples form "
        f"{so['samples_bound'][0]:.3f} vs {so['samples_ms']:.3f}; key "
        f"kernel {so['keys_bound'][0]:.3f} vs {so['keys_kernel_ms']:.3f}; "
        f"geometric cost K=9 {go['bound'][9][0]:.4f} "
        f"({go['bound'][9][1]}) vs {go['ms'][9]:.4f}, K=5 "
        f"{go['bound'][5][0]:.4f} vs {go['ms'][5]:.4f}, K=1 "
        f"{go['bound'][1][0]:.4f} vs {go['ms'][1]:.4f}")
    # the codec (host decode and encode, the IDCT and colour kernels, the
    # encoder's colour and DCT kernels, PNG reads): no TPU kernel's
    # counterpart; the details on a line of their own
    enc, png, rast, webp, ll, tj, jc, rare = (
        files["enc"], files["png"], files["raster"], files["webp"],
        files["lossless"], files["tiff_jpeg"], files["jpeg_coding"],
        files["rare"])
    jp2 = files["jp2"]
    codec_kernel = lambda k: {
        "source": "mpmvs_torch/csrc/jpeg_codec.cu",
        "launches": files[f"{k}_launches"], "ms": files[f"{k}_ms"],
        "plain_ms": files[f"{k}_plain_ms"],
        "bound_ms": files[f"{k}_bound_ms"], "bound_by": "bytes",
        "differing_entries": [e[0] for e in files[f"{k}_vs_plain"]],
        "max_abs_err": max(e[1] for e in files[f"{k}_vs_plain"])}
    enc_kernel = lambda k, n: {
        "source": "mpmvs_torch/csrc/jpeg_codec.cu", "launches": n,
        "ms": enc[f"{k}_ms"], "plain_ms": enc[f"{k}_plain_ms"],
        "bound_ms": enc[f"{k}_bound"][0], "bound_by": enc[f"{k}_bound"][1],
        "differing_entries": [e[0] for e in enc[f"{k}_vs_plain"]],
        "max_abs_err": max(e[1] for e in enc[f"{k}_vs_plain"])}
    log(json.dumps({"codec": {
        "decode_ms_per_image": files["dec_ms"],
        "encode_ms_per_image": files["enc_ms"],
        "encode_parts_ms": {k: enc[k] for k in ("copy_ms", "huffman_ms",
                                                "encode_ms")},
        "png_read_ms": png["read_ms"], "png_unfilter_ms": png["unfilter_ms"],
        "raster_reads": {k: {f: v for f, v in r.items() if f != "form"}
                         for k, r in files["raster"].items()},
        "ycck_read": files["ycck"], "ycck_vs_cv2": files["ycck_read"],
        "webp_read": webp, "tiff_jpeg_read": {
            k: v for k, v in tj.items() if k not in (
                "idct_chunks", "ycc_to_bgr_chunks", "raster_ycbcr",
                "raster_bgr", "raster_bmp16")},
        "chunked_fixtures_kernel_equal_plain":
            fixture_facts["chunked_colour_equal_plain"],
        "lossless_webp_read": {
            k: v for k, v in ll.items() if k not in (
                "vp8l_predictor", "vp8l_colour", "webp_argb_to_bgr")},
        "four_component_fixtures_equal_cv2":
            fixture_facts["four_component_equal_cv2"],
        "jpeg_coding_read": {k: v for k, v in jc.items() if k != "forms"},
        "rare_read": {k: v for k, v in rare.items()
                      if k != "jpeg_smooth"},
        "jp2_read": jp2,
        "jpeg_coding_fixtures_equal_cv2":
            fixture_facts["jpeg_coding_fixtures"],
        "image": [W_FULL, H_FULL], "calls_phase8": files["codec"],
        "idct_islow": codec_kernel("idct"),
        "ycc_to_bgr": codec_kernel("ycc"),
        "bgr_to_ycc": enc_kernel("ycc", files["enc_launches"][0]),
        "fdct_islow_quant": enc_kernel("fdct", files["enc_launches"][1]),
        "fixtures_vs_cv2": fixtures, "encoder_fixtures_equal_bytes":
            fixture_facts["encoded_equal"],
        "refused": fixture_facts["refused"],
        "raster_fixtures_kernel_equal_plain":
            fixture_facts["raster_kernel_equal_plain"], "nvidia_smi": smi}}))
    log(json.dumps({"multi_gpu": {
        "ranks": multi["ranks"], "backend": "nccl", "wall_s": multi["wall_s"],
        "median_rel_err": multi["rel"], "depth_digests": multi["digests"],
        "points": multi["points"], "per_rank": multi["per_rank"],
        "zero_extent_source_vs_plain": {
            k: {"differing": d, "entries": n}
            for k, (d, n) in dummy.items()}, "nvidia_smi": smi}}))
    leaked = [m for m in ("cv2", "yaml", "jax", "mpmvs_tpu")
              if m in sys.modules]
    if leaked:
        raise AssertionError(f"modules the card's machine need not have "
                             f"were imported: {leaked}")
    log(smi)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              **extra):
        return dict({"name": name, "route": "cuda",
                     "source": f"mpmvs_torch/csrc/{source}",
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": None, "share_of_bound": bnd[0] / ms,
                     "nvidia_smi": smi}, **extra)

    fused_launches = so["solves"]["sorted"][2][0]
    no_tpu = ("none: the JAX package codes images with OpenCV "
              "(mpmvs_tpu/pipeline.py:60 cv2.imread, "
              "mpmvs_tpu/preprocess/convert.py:161 cv2.imwrite)")
    # library_ms: no single PyTorch call computes any of these functions
    # (PERF.md section 6). Launches: the NCC kernel, the geometric cost, the
    # bilateral kernel and its table builder in phase 6, the sorted kernels
    # in phase 7(d), the codec's five kernels in phase 8 (the converter, the
    # pipeline's reads, the previews);
    # a form that path does not take is listed with its launches there, 0.
    log(json.dumps({"kernels": [
        entry("ncc_eval_multi", "ncc_eval.cu",
              "mpmvs_tpu/ops/pallas_ncc.py:94", ncc_launches, max_err, ms_k,
              ms_p, k9_bound),
        entry("bilateral_refine", "bilateral_refine.cu",
              "mpmvs_tpu/ops/pallas_bilateral.py:41",
              sum(bil_forms.values()), bil["max_abs_err"], bil["ms"]["table"],
              bil["ms"]["plain 8-bit"], bil_bound, form="table", forms=[
                  {"form": form, "launches": bil_forms.get(form, 0),
                   "ms": bil["ms"][form], "plain_ms": bil["ms"][plain],
                   "share_of_bound": bil_bound[0] / bil["ms"][form],
                   "equal_entries": bil["equal"][form]}
                  for form, plain in (("table", "plain 8-bit"),
                                      ("float", "plain"))]),
        entry("bilateral_colour_table", "bilateral_refine.cu",
              "mpmvs_tpu/ops/pallas_bilateral.py:41 (the colour factor of "
              "its weights)", table_builds, bil["table_max_abs_err"],
              bil["ms"]["table build"],
              bil["ms"]["plain table"], tab_bound),
        entry("ncc_sorted", "ncc_samples.cu",
              "mpmvs_tpu/ops/pallas_ncc.py:733", fused_launches,
              max(so["fused_max_abs_err"], so["samples_max_abs_err"]),
              so["fused_ms"], so["fused_plain_ms"], so["fused_bound"],
              form="fused", scope="one view, given its order and the "
              "record: the kernel alone; plain: raw samples, un-permute and "
              "ZNCC", forms=[
                  {"form": "fused", "launches": fused_launches,
                   "ms": so["fused_ms"], "plain_ms": so["fused_plain_ms"],
                   "bound_ms": so["fused_bound"][0],
                   "max_abs_err": so["fused_max_abs_err"]},
                  {"form": "samples",
                   "launches": so["solves"]["sorted"][2][1],
                   "ms": so["samples_ms"], "plain_ms": so["samples_plain_ms"],
                   "bound_ms": so["samples_bound"][0],
                   "max_abs_err": so["samples_max_abs_err"]}]),
        entry("ncc_bucket_keys", "ncc_samples.cu",
              "mpmvs_tpu/ops/pallas_ncc.py:867 (the sort keys of "
              "ncc_eval_pallas_sorted, XLA ops)",
              so["solves"]["sorted"][2][3], so["keys_max_abs_err"],
              so["keys_kernel_ms"],
              so["keys_plain_ms"], so["keys_bound"]),
        entry("geom_consistency_cost", "geom_cost.cu",
              "mpmvs_tpu/ops/geom_cost.py:22 (XLA gathers: no Pallas "
              "kernel)", geom_launches, go["max_abs_err"], go["ms"][9],
              go["plain_ms"][9], go["bound"][9], scope="K=9 at the geom "
              "band shape, the candidates' call; K=5 (the trials') and K=1 "
              "beside it", registers=go["registers"][9],
              **{f"k{K}": {"ms": go["ms"][K], "plain_ms": go["plain_ms"][K],
                           "bound_ms": go["bound"][K][0],
                           "registers": go["registers"][K]}
                 for K in (5, 1)}),
        entry("idct_islow", "jpeg_codec.cu", no_tpu, files["idct_launches"],
              max(e[1] for e in files["idct_vs_plain"]), files["idct_ms"],
              files["idct_plain_ms"], (files["idct_bound_ms"], "bytes"),
              scope="the three components of a 3200x2130 4:2:0 JPEG",
              arithmetic_reads_launches=jc["launches"]["idct_islow"][0]),
        entry("ycc_to_bgr", "jpeg_codec.cu", no_tpu, files["ycc_launches"],
              max(e[1] for e in files["ycc_vs_plain"]), files["ycc_ms"],
              files["ycc_plain_ms"], (files["ycc_bound_ms"], "bytes"),
              scope="a 3200x2130 4:2:0 JPEG, the YCbCr form",
              phase8e_launches=jc["launches"]["colour"][0],
              phase8e_forms=jc["launches"]["colour"][2]),
        entry("bgr_to_ycc", "jpeg_codec.cu", no_tpu,
              files["enc_launches"][0],
              max(e[1] for e in enc["ycc_vs_plain"]), enc["ycc_ms"],
              enc["ycc_plain_ms"], enc["ycc_bound"],
              scope="a 3200x2130 BGR image to 4:2:0 planes"),
        entry("fdct_islow_quant", "jpeg_codec.cu", no_tpu,
              files["enc_launches"][1],
              max(e[1] for e in enc["fdct_vs_plain"]), enc["fdct_ms"],
              enc["fdct_plain_ms"], enc["fdct_bound"],
              scope="the three planes of a 3200x2130 4:2:0 encode (three "
              "launches)"),
        entry("cmyk_to_bgr", "jpeg_codec.cu", no_tpu, files["cmyk_launches"],
              max(e[1] for k in ("file_ycck", "file_cmyk", "1x1_ycck",
                                 "1x1_cmyk")
                  for e in files["ycck"][k]["vs_plain"]),
              files["ycck"]["file_ycck"]["ms"],
              files["ycck"]["file_ycck"]["plain_ms"],
              (files["ycck"]["file_ycck"]["bound_ms"],
               files["ycck"]["file_ycck"]["bound_by"]), form="ycck",
              scope="a 3200x2130 YCCK JPEG (Y, K at 2x2, Cb, Cr at 1x1: "
              "phase 8's source), grey and BGR in one launch; the same "
              "planes at 1x1 and the CMYK form beside it",
              forms={k: {f: files["ycck"][k][f] for f in (
                  "ms", "plain_ms", "bound_ms")}
                  for k in ("file_cmyk", "1x1_ycck", "1x1_cmyk")}),
        entry("raster_to_bgr", "jpeg_codec.cu", no_tpu,
              files["raster_launches"],
              max(e[1] for e in rast["tif"]["vs_plain"]),
              rast["tif"]["kernel_ms"], rast["tif"]["plain_ms"],
              (rast["tif"]["bound_ms"], rast["tif"]["bound_by"]),
              scope="the samples of a 3200x2130 8-bit RGB TIFF (LZW, "
              "predictor 2); the 16-bit RGB PNG's beside it",
              png16={k: rast["png16"][k] for k in (
                  "kernel_ms", "plain_ms", "bound_ms")} | {
                  "max_abs_err": max(e[1] for e in
                                     rast["png16"]["vs_plain"])})] + [
        entry(name, "jpeg_codec.cu", no_tpu + f"; the arithmetic in "
              f"mpmvs_torch/csrc/{header}", webp["launches"][k][0],
              webp[name]["max_abs_err"], webp[name]["ms"],
              webp[name]["plain_ms"], (webp[name]["bound_ms"],
                                       webp[name]["bound_by"]),
              scope=f"the {webp['size'][0]}x{webp['size'][1]} lossy WebP "
              f"source (phase 8b), one launch; launches: the converter's "
              f"read and the pipeline's")
        for k, (name, header) in enumerate((
            ("vp8_reconstruct", "vp8_recon.h"),
            ("vp8_loop_filter", "vp8_filter.h"),
            ("webp_yuv_to_bgr", "webp_colour.h")))] + [
        entry(name, "jpeg_codec.cu", "none: cv2.imread (of a lossless or "
              "animated WebP: mpmvs_tpu/pipeline.py:60, "
              "mpmvs_tpu/preprocess/convert.py:161); the arithmetic in "
              "mpmvs_torch/csrc/vp8l_transform.h", ll["launches"][name][0],
              ll[name]["max_abs_err"], ll[name]["ms"], ll[name]["plain_ms"],
              (ll[name]["bound_ms"], ll[name]["bound_by"]),
              scope=f"the {ll['size'][0]}x{ll['size'][1]} lossless WebP "
              f"source (phase 8c), one launch{scope}; launches: the "
              f"converter's read and the pipeline's",
              **({"forms": [{k: r[k] for k in ("form", "ms", "plain_ms",
                                               "bound_ms", "max_abs_err")}
                            for r in ll[name]["forms"]]}
                 if "forms" in ll[name] else {}))
        for name, scope in (
            ("vp8l_predictor", ""),
            ("vp8l_colour", " a run of element-wise transforms (the "
             "cross-colour run; the add-green run beside it)"),
            ("webp_argb_to_bgr", ""))] + [
        entry(name, "jpeg_codec.cu", "none: cv2.imread (of a JPEG-"
              "compressed, YCbCr or signed TIFF, a BMP or a PNM: "
              f"mpmvs_tpu/pipeline.py:60, "
              f"mpmvs_tpu/preprocess/convert.py:161); the arithmetic in "
              f"mpmvs_torch/csrc/{header}", launches,
              tj[key]["max_abs_err"], tj[key]["ms"], tj[key]["plain_ms"],
              (tj[key]["bound_ms"], tj[key]["bound_by"]), form=form,
              graph_ms=tj[key]["graph_ms"], scope=scope)
        for name, key, form, header, launches, scope in (
            ("idct_islow", "idct_chunks", "every chunk at once",
             "jpeg_idct.h", tj["launches"]["idct"][0],
             f"the three components of phase 8d's {tj['size'][0]}x"
             f"{tj['size'][1]} JPEG TIFF, every one of its "
             f"{tj['chunks']['count']} strips in one launch a component "
             f"(three launches); launches: the converter's read and the "
             f"pipeline's"),
            ("ycc_to_bgr", "ycc_to_bgr_chunks", "chunks", "jpeg_colour.h",
             tj["launches"]["colour"][2].get("chunks", 0),
             "phase 8d's JPEG TIFF, each strip upsampled on its own, grey "
             "and BGR in one launch"),
            ("raster_to_bgr", "raster_ycbcr", "ycbcr", "raster_bgr.h",
             tj["launches"]["raster"][2].get("ycbcr", 0),
             "3200x2130 YCbCr data units at (2, 2) made from a seed; "
             "launches: phase 8d's YCbCr TIFF source"),
            ("raster_to_bgr", "raster_bgr", "bgr", "raster_bgr.h",
             tj["launches"]["raster"][2].get("bgr", 0),
             "3200x2130 B, G, R samples made from a seed; launches: phase "
             "8d's 24-bit BMP source"),
            ("raster_to_bgr", "raster_bmp16", "bmp16", "raster_bgr.h",
             tj["launches"]["raster"][2].get("bmp16", 0),
             "3200x2130 5-6-5 pixels made from a seed; launches: phase "
             "8d's 16-bit BMP source"))] + [
        entry(name, "jpeg_codec.cu", "none: cv2.imread (of a lossless JPEG: "
              "mpmvs_tpu/pipeline.py:60, mpmvs_tpu/preprocess/convert.py:161)"
              "; the arithmetic in mpmvs_torch/csrc/jpeg_lossless_pred.h",
              jc["launches"]["ljpeg"][2].get(form, 0),
              jc["forms"][key]["max_abs_err"], jc["forms"][key]["ms"],
              jc["forms"][key]["plain_ms"], (jc["forms"][key]["bound_ms"],
                                             jc["forms"][key]["bound_by"]),
              form=form, graph_ms=jc["forms"][key]["graph_ms"], scope=scope)
        for name, key, form, scope in (
            ("ljpeg_scan", "lossless_p1_restart16", "scan",
             "the three planes of phase 8e's 3200x2130 lossless RGB stream, "
             "predictor 1, a restart every 16 rows (134 bands): both passes "
             "(two launches); launches: the converter's read"),
            ("ljpeg_wavefront", "lossless_p7", "wavefront",
             "the three planes of phase 8e's 3200x2130 lossless RGB stream, "
             "predictor 7, no restart: one launch; launches: the "
             "converter's read"))] + [
        entry("jpeg_smooth", "jpeg_codec.cu", "none: cv2.imread (of a "
              "progressive JPEG cut short, or whose scans stop before the "
              "last bit: mpmvs_tpu/pipeline.py:60, "
              "mpmvs_tpu/preprocess/convert.py:161); the arithmetic in "
              "mpmvs_torch/csrc/jpeg_smooth.h",
              rare["launches"]["jpeg_smooth"][0],
              rare["jpeg_smooth"]["max_abs_err"], rare["jpeg_smooth"]["ms"],
              rare["jpeg_smooth"]["plain_ms"],
              (rare["jpeg_smooth"]["bound_ms"],
               rare["jpeg_smooth"]["bound_by"]),
              graph_ms=rare["jpeg_smooth"]["graph_ms"],
              scope=f"the three components of phase 8f's "
              f"{rare['size'][0]}x{rare['size'][1]} progressive 4:2:0 JPEG "
              f"cut inside its sixth scan, a launch each (three launches); "
              f"launches: the converter's read and the pipeline's"),
        entry("raster_to_bgr", "jpeg_codec.cu", "none: cv2.imread (of a "
              "CIELab TIFF: mpmvs_tpu/pipeline.py:60, "
              "mpmvs_tpu/preprocess/convert.py:161); the arithmetic in "
              "mpmvs_torch/csrc/raster_bgr.h",
              rare["launches"]["raster"][2].get("cielab", 0),
              rare["lab_3200x2130.tif"]["max_abs_err"],
              rare["lab_3200x2130.tif"]["ms"],
              rare["lab_3200x2130.tif"]["plain_ms"],
              (rare["lab_3200x2130.tif"]["bound_ms"],
               rare["lab_3200x2130.tif"]["bound_by"]), form="cielab",
              graph_ms=rare["lab_3200x2130.tif"]["graph_ms"],
              scope="the samples of phase 8f's 3200x2130 8-bit CIELab "
              "TIFF, one launch; launches: the converter's read and the "
              "pipeline's")] + [
        entry(name, "jpeg_codec.cu", "none: cv2.imread (of a JPEG 2000 "
              "file: mpmvs_tpu/pipeline.py:60, mpmvs_tpu/preprocess/convert."
              f"py:161); the arithmetic in mpmvs_torch/csrc/{header}",
              sum(jp2["launches"]["j2k"][2].get(f, 0)
                  for f in {f for f, _ in forms}),
              max(jp2[k][part]["max_abs_err"] for k in JP2_SOURCES),
              jp2["97_rpcl"][part]["ms"], jp2["97_rpcl"][part]["plain_ms"],
              (jp2["97_rpcl"][part]["bound_ms"],
               jp2["97_rpcl"][part]["bound_by"]), form=forms[1][0],
              graph_ms=jp2["97_rpcl"][part]["graph_ms"], scope=scope,
              forms=[{"form": f, "source": JP2_SOURCES[k],
                      "launches": jp2["launches"]["j2k"][2].get(f, 0),
                      **{m: jp2[k][part][m] for m in (
                          "ms", "graph_ms", "plain_ms", "bound_ms",
                          "bound_by", "max_abs_err")}}
                     for f, k in forms])
        for name, part, header, forms, scope in (
            ("j2k_idwt", "idwt", "j2k_idwt.h",
             (("53", "lossless"), ("97", "97_rpcl"), ("53", "53_rct")),
             "every level of phase 8g's 3200x2130 9/7 source (12 tiles of 3 "
             "components, 5 levels: 10 launches, rows then columns a "
             "level); the 5/3 sources' beside it (a form's launches count "
             "both 5/3 sources); launches: the converter's reads and the "
             "pipeline's"),
            ("j2k_colour", "colour", "j2k_colour.h",
             (("none", "lossless"), ("ict", "97_rpcl"), ("rct", "53_rct")),
             "phase 8g's 3200x2130 9/7 source (ICT), grey and BGR in one "
             "launch; the lossless source's (no colour transform: cv2's "
             "writer sets none) and the 5/3 RCT source's beside it; "
             "launches: the converter's reads and the pipeline's"))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
