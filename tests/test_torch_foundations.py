"""Foundations of mpmvs_torch against mpmvs_tpu on the same numpy inputs:
camera, geometry, sampling, packing, the median filter, view selection,
and the io writers (byte-identical files).

Tolerances: geometry chains a few float32 ops whose rounding differs by
an ulp between XLA (fused multiply-adds on the CPU) and eager PyTorch:
rtol 1e-5. Integer/bit/selection results and pure data movement (packing,
shifts, sorting) must match exactly. Bilinear samples at the same
coordinates: atol 1e-4 on 0..255 intensities."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu import geometry as jgeo
from mpmvs_tpu.io import cams as jcams, dmb as jdmb, ply as jply
from mpmvs_tpu.ops import filters as jfilt, packing as jpack
from mpmvs_tpu.ops import sampling as jsamp, view_selection as jvs
from mpmvs_tpu.utils.synthetic import make_plane_scene
from mpmvs_torch import geometry as tgeo
from mpmvs_torch.camera import Camera
from mpmvs_torch.io import cams as tcams, dmb as tdmb, ply as tply
from mpmvs_torch.ops import filters as tfilt, packing as tpack
from mpmvs_torch.ops import sampling as tsamp, threefry as tf
from mpmvs_torch.ops import view_selection as tvs

from torch_parity import cams, n, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    return make_plane_scene(num_views=3, height=40, width=56, seed=11)


def test_camera_stack(scene):
    jc, tc = scene.cameras, cams(scene.cameras)
    np.testing.assert_allclose(n(tc.C), np.asarray(jc.C), rtol=1e-5, atol=1e-6)
    v = tc.view(1)
    np.testing.assert_array_equal(n(v.K), np.asarray(jc.view(1).K))
    np.testing.assert_allclose(n(v.C), np.asarray(jc.view(1).C), rtol=1e-5,
                               atol=1e-6)
    r = v.rescale(0.5, 0.25, 28, 10)
    rj = jc.view(1).rescale(0.5, 0.25, 28, 10)
    np.testing.assert_array_equal(n(r.K), np.asarray(rj.K))
    assert float(r.width) == 28 and float(r.height) == 10
    restacked = type(tc).stack([tc.view(i) for i in range(3)])
    np.testing.assert_array_equal(n(restacked.R), n(tc.R))


def test_geometry_functions(scene):
    rng = np.random.default_rng(1)
    jc = scene.cameras
    K, R = np.asarray(jc.K[0]), np.asarray(jc.R[0])
    x, y = jgeo.pixel_grid(12, 16)
    depth = rng.uniform(2.0, 6.0, (12, 16)).astype(np.float32)
    nrm = rng.normal(size=(12, 16, 3)).astype(np.float32)
    nrm[..., 2] = -np.abs(nrm[..., 2]) - 0.5
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    xt, yt = tgeo.pixel_grid(12, 16)
    np.testing.assert_array_equal(n(xt), np.asarray(x))
    np.testing.assert_array_equal(n(yt), np.asarray(y))
    close = lambda a, b: np.testing.assert_allclose(n(a), np.asarray(b),
                                                    rtol=1e-5, atol=1e-5)
    close(tgeo.view_direction(t(K), xt, yt), jgeo.view_direction(K, x, y))
    close(tgeo.backproject_cam(t(K), xt, yt, t(depth)),
          jgeo.backproject_cam(K, x, y, depth))
    plane_j = jgeo.plane_from_depth_normal(K, x, y, depth, nrm)
    plane_t = tgeo.plane_from_depth_normal(t(K), xt, yt, t(depth), t(nrm))
    close(plane_t, plane_j)
    close(tgeo.depth_from_plane(t(K), plane_t, xt, yt),
          jgeo.depth_from_plane(K, plane_j, x, y))
    close(tgeo.normal_cam_to_world(t(R), t(nrm)),
          jgeo.normal_cam_to_world(R, nrm))
    close(tgeo.normal_world_to_cam(t(R), t(nrm)),
          jgeo.normal_world_to_cam(R, nrm))
    close(tgeo.K_inv_pinhole(t(K)), jgeo.K_inv_pinhole(K))
    tc = cams(jc)
    Aj, bj = jgeo.homography_terms(jc.K[0], jc.R[0], jc.view(0).C,
                                   jc.K[1:], jc.R[1:], jc.C[1:])
    At, bt = tgeo.homography_terms(tc.K[0], tc.R[0], tc.view(0).C,
                                   tc.K[1:], tc.R[1:], tc.C[1:])
    close(At, Aj)
    close(bt, bj)
    Rr_j, tr_j = jgeo.relative_pose(jc.R[0], jc.view(0).C, jc.R[1:], jc.C[1:])
    Rr_t, tr_t = tgeo.relative_pose(tc.R[0], tc.view(0).C, tc.R[1:], tc.C[1:])
    close(Rr_t, Rr_j)
    close(tr_t, tr_j)
    pj = jgeo.homography_apply(Aj[0], bj[0], K, plane_j, x, y)
    pt = tgeo.homography_apply(At[0], bt[0], t(K), plane_t, xt, yt)
    for a, b in zip(pt, pj):
        close(a, b)
    Xw_j = jgeo.backproject_world(K, R, jc.view(0).C, x, y, depth)
    Xw_t = tgeo.backproject_world(t(K), t(R), tc.view(0).C, xt, yt, t(depth))
    close(Xw_t, Xw_j)
    for a, b in zip(tgeo.project_camera(tc.K[1], tc.R[1], tc.t[1], Xw_t),
                    jgeo.project_camera(jc.K[1], jc.R[1], jc.t[1], Xw_j)):
        close(a, b)
    close(tgeo.plane_to_origin(t(K), xt, yt, t(depth), t(nrm)),
          jgeo.plane_to_origin(K, x, y, depth, nrm))
    assert [np.asarray(v).item() for v in jgeo.intrinsics_parts(K)] == \
        [v.item() for v in tgeo.intrinsics_parts(t(K))]


def test_sampling(scene):
    rng = np.random.default_rng(2)
    imgs = scene.images                                  # (3, 40, 56)
    view = rng.integers(0, 3, (30, 20)).astype(np.int32)
    x = rng.uniform(-8, 64, (30, 20)).astype(np.float32)
    y = rng.uniform(-8, 48, (30, 20)).astype(np.float32)
    widths = np.array([56, 50, 40], np.float32)
    heights = np.array([40, 33, 40], np.float32)
    ref = jsamp.bilinear_sample_batched(jnp.asarray(imgs), view, x, y,
                                        widths, heights)
    got = tsamp.bilinear_sample_batched(t(imgs), t(view, torch.int64), t(x),
                                        t(y), t(widths), t(heights))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        n(tsamp.bilinear_sample(t(imgs[0]), t(x), t(y), 50, 33)),
        np.asarray(jsamp.bilinear_sample(jnp.asarray(imgs[0]), x, y, 50, 33)),
        atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        n(tsamp.nearest_sample_batched(t(imgs), t(view, torch.int64), t(x),
                                       t(y), t(widths), t(heights))),
        np.asarray(jsamp.nearest_sample_batched(jnp.asarray(imgs), view, x,
                                                y, widths, heights)))
    for dx, dy in ((0, 0), (3, -2), (-5, 7), (11, 0)):
        for fill in (None, np.inf, 0.0):
            np.testing.assert_array_equal(
                n(tsamp.shift_2d(t(imgs), dx, dy, fill)),
                np.asarray(jsamp.shift_2d(jnp.asarray(imgs), dx, dy, fill)))


def test_sampling_far_coordinates():
    """Finite coordinates far outside the image (float->int conversion out
    of range) pick the same texels as the JAX package."""
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    x = np.array([-1e30, -3e9, -2.5, 3.999, 3e9, 1e30, 7.5], np.float32)
    y = np.array([1.5, -1e20, 0.25, 2.0, 1e20, 0.5, 9.0], np.float32)
    np.testing.assert_array_equal(
        n(tsamp.bilinear_sample(t(img), t(x), t(y))),
        np.asarray(jsamp.bilinear_sample(jnp.asarray(img), x, y)))


@pytest.mark.parametrize("phase", [0, 1])
def test_packing(phase):
    rng = np.random.default_rng(phase)
    F = rng.normal(size=(2, 10, 14)).astype(np.float32)
    like = rng.normal(size=(2, 10, 14)).astype(np.float32)
    P = np.asarray(jpack.pack_quincunx(jnp.asarray(F), phase))
    np.testing.assert_array_equal(n(tpack.pack_quincunx(t(F), phase)), P)
    np.testing.assert_array_equal(
        n(tpack.unpack_quincunx(t(P), phase, t(like))),
        np.asarray(jpack.unpack_quincunx(jnp.asarray(P), phase,
                                         jnp.asarray(like))))
    for a, b in zip(tpack.packed_coords(6, 10, 7, phase),
                    jpack.packed_coords(6, 10, 7, phase)):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_median_filter(scene):
    rng = np.random.default_rng(4)
    depth = scene.gt_depth[0] + rng.normal(0, 0.05, scene.gt_depth[0].shape)
    depth = depth.astype(np.float32)
    cost = rng.uniform(0, 0.01, depth.shape).astype(np.float32)
    np.testing.assert_array_equal(
        n(tfilt.checkerboard_median_filter(t(depth), t(cost))),
        np.asarray(jfilt.checkerboard_median_filter(jnp.asarray(depth),
                                                    jnp.asarray(cost))))


def test_view_selection_bits_and_init():
    rng = np.random.default_rng(5)
    mask = rng.integers(0, 1 << 6, (9, 11)).astype(np.int32)
    bits = np.asarray(jvs.decode_bits(jnp.asarray(mask), 6))
    np.testing.assert_array_equal(n(tvs.decode_bits(t(mask), 6)), bits)
    np.testing.assert_array_equal(n(tvs.encode_bits(t(bits))),
                                  np.asarray(jvs.encode_bits(bits)))
    costs = rng.uniform(0, 2.2, (6, 9, 11)).astype(np.float32)
    costs[:, 0, 0] = 2.0                      # no valid view
    costs = np.minimum(costs, 2.0)
    cj, sj = jvs.initial_cost_and_views(jnp.asarray(costs), 4, 2.0)
    ct, st = tvs.initial_cost_and_views(t(costs), 4, 2.0)
    np.testing.assert_allclose(n(ct), np.asarray(cj), rtol=1e-6)
    np.testing.assert_array_equal(n(st), np.asarray(sj))


def test_monte_carlo_view_weights_same_key():
    """Same key -> same 15 draws -> same integer weights. A draw that lands
    within an ulp of a CDF step could flip one bin, so the fraction of
    pixels whose weights differ is bounded (measured 0) rather than 0."""
    rng = np.random.default_rng(6)
    S, H, W = 5, 12, 10
    cost = rng.uniform(0, 2.0, (8, S, H, W)).astype(np.float32)
    valid = rng.uniform(size=(8, H, W)) > 0.2
    nsel = rng.integers(0, 1 << S, (4, H, W)).astype(np.int32)
    kj = jax.random.PRNGKey(8)
    for it in (0, 2):
        wj, nj, sj = jvs.monte_carlo_view_weights(
            kj, jnp.asarray(cost), jnp.asarray(valid), jnp.asarray(nsel),
            jnp.asarray(valid[:4]), jnp.int32(it), 15)
        wt, nt, st = tvs.monte_carlo_view_weights(
            tf.PRNGKey(8), t(cost), t(valid), t(nsel), t(valid[:4]), it, 15)
        differ = (np.asarray(wj) != n(wt)).any(-1)
        assert differ.mean() <= 0.01, differ.mean()
        np.testing.assert_array_equal(n(nt)[~differ], np.asarray(nj)[~differ])
        np.testing.assert_array_equal(n(st)[~differ], np.asarray(sj)[~differ])


def test_io_writers_byte_identical(tmp_path, scene):
    rng = np.random.default_rng(7)
    for arr in (rng.normal(size=(5, 7)).astype(np.float32),
                rng.normal(size=(5, 7, 3)).astype(np.float32)):
        jdmb.write_dmb(str(tmp_path / "j.dmb"), arr)
        tdmb.write_dmb(str(tmp_path / "t.dmb"), arr)
        assert (tmp_path / "j.dmb").read_bytes() == \
            (tmp_path / "t.dmb").read_bytes()
        np.testing.assert_array_equal(tdmb.read_dmb(str(tmp_path / "j.dmb")),
                                      arr)
    jcams.write_cam_txt(str(tmp_path / "j_cam.txt"), scene.cameras.view(2))
    tcams.write_cam_txt(str(tmp_path / "t_cam.txt"), cams(scene.cameras).view(2))
    assert (tmp_path / "j_cam.txt").read_bytes() == \
        (tmp_path / "t_cam.txt").read_bytes()
    back = tcams.read_cam_txt(str(tmp_path / "j_cam.txt"))
    assert isinstance(back, Camera)
    np.testing.assert_array_equal(
        n(back.K), np.asarray(jcams.read_cam_txt(str(tmp_path / "j_cam.txt")).K))
    sel = [[(1, 10.0), (2, 3.0)], [(0, 5.0)], []]
    jcams.write_pair_txt(str(tmp_path / "j_pair.txt"), sel)
    tcams.write_pair_txt(str(tmp_path / "t_pair.txt"), sel)
    assert (tmp_path / "j_pair.txt").read_bytes() == \
        (tmp_path / "t_pair.txt").read_bytes()
    assert tcams.read_pair_txt(str(tmp_path / "j_pair.txt")) == \
        [tcams.Scene(s.ref_id, s.src_ids, s.estimate)
         for s in jcams.read_pair_txt(str(tmp_path / "j_pair.txt"))]
    pts = rng.normal(size=(9, 3)).astype(np.float32)
    pts[3, 1] = np.nan
    col = rng.uniform(0, 255, (9, 3)).astype(np.float32)
    jply.write_ply_binary(str(tmp_path / "j.ply"), pts, pts, col)
    tply.write_ply_binary(str(tmp_path / "t.ply"), pts, pts, col)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()


@pytest.mark.parametrize("kind", ["plane", "shapes"])
def test_synthetic_scenes_identical(kind):
    """The port's numpy scene generators give the JAX package's scenes
    exactly: same images, depths, normals and cameras from the same seed."""
    from mpmvs_tpu.utils import synthetic as jsyn
    from mpmvs_torch.utils import synthetic as tsyn
    from torch_parity import CAMERA_FIELDS

    make = f"make_{kind}_scene"
    kw = dict(num_views=3, height=24, width=32, seed=5)
    js, ts = getattr(jsyn, make)(**kw), getattr(tsyn, make)(**kw)
    for f in ("images", "colors", "gt_depth", "gt_normal_world",
              "gt_normal_maps"):
        a, b = getattr(ts, f), getattr(js, f)
        assert (a is None) == (b is None) == (f == "gt_normal_maps"
                                              and kind == "plane")
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(n(getattr(ts.cameras, f)),
                                      np.asarray(getattr(js.cameras, f)))
    np.testing.assert_array_equal(tsyn.gt_point_cloud(ts),
                                  jsyn.gt_point_cloud(js))


def test_ground_truth_readers_match(tmp_path):
    """ETH3D raw ground truth and COLMAP depth maps: the port reads what the
    JAX package writes and reads, exactly."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 9.0, (6, 8)).astype(np.float32)
    jdmb.write_eth3d_gt(str(tmp_path / "j.gt"), depth)
    tdmb.write_eth3d_gt(str(tmp_path / "t.gt"), depth)
    assert (tmp_path / "j.gt").read_bytes() == (tmp_path / "t.gt").read_bytes()
    np.testing.assert_array_equal(
        tdmb.read_eth3d_gt(str(tmp_path / "j.gt"), 6, 8), depth)
    for shape in ((6, 8), (6, 8, 3)):
        payload = rng.normal(size=shape).astype("<f4")
        d = shape[2] if len(shape) == 3 else 1
        (tmp_path / "m.dmap").write_bytes(
            f"{shape[1]}&{shape[0]}&{d}&".encode() + payload.tobytes())
        got = tdmb.read_colmap_dmap(str(tmp_path / "m.dmap"))
        np.testing.assert_array_equal(
            got, jdmb.read_colmap_dmap(str(tmp_path / "m.dmap")))
        np.testing.assert_array_equal(got, payload)
