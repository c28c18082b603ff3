"""The port's native bindings (``mpmvs_torch.native``) and the port's fusion
held to them, as tests/test_native.py does for the JAX package; and the
port's ``fuse_exact`` against the JAX package's on the same input. Skipped
only where no ``g++`` exists (the library is built into
``mpmvs_torch/_build/`` at the first test)."""

import shutil

import numpy as np
import pytest
import torch

from mpmvs_torch import native
from mpmvs_torch.fusion import run_fusion
from mpmvs_torch.io.cams import Scene
from mpmvs_torch.utils.synthetic import make_plane_scene

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native library")


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available() or native.build(), "native build failed"


def _all_pairs(V):
    return [Scene(ref_id=i, src_ids=[i] + [j for j in range(V) if j != i])
            for i in range(V)]


class TestDelaunay:
    def test_triangle_count_close_to_scipy(self):
        from scipy.spatial import Delaunay
        rng = np.random.default_rng(1)
        pts = rng.uniform(0, 50, (120, 2))
        ours = native.delaunay(torch.as_tensor(pts))
        ref = Delaunay(pts)
        assert abs(len(ours) - len(ref.simplices)) <= 3

    def test_delaunay_empty_circumcircles(self):
        """Delaunay property: no point strictly inside any circumcircle."""
        rng = np.random.default_rng(2)
        pts = rng.uniform(0, 10, (60, 2))
        tris = native.delaunay(pts)
        for t in tris[:50]:
            a, b, c = pts[t]
            d = 2 * (a[0] * (b[1] - c[1]) + b[0] * (c[1] - a[1])
                     + c[0] * (a[1] - b[1]))
            ux = ((a @ a) * (b[1] - c[1]) + (b @ b) * (c[1] - a[1])
                  + (c @ c) * (a[1] - b[1])) / d
            uy = ((a @ a) * (c[0] - b[0]) + (b @ b) * (a[0] - c[0])
                  + (c @ c) * (b[0] - a[0])) / d
            r2 = (a[0] - ux) ** 2 + (a[1] - uy) ** 2
            dist2 = (pts[:, 0] - ux) ** 2 + (pts[:, 1] - uy) ** 2
            assert (dist2 >= r2 * (1 - 1e-9)).sum() >= len(pts) - 3

    def test_collinear_points_no_crash(self):
        pts = np.stack([np.arange(10.0), np.zeros(10)], 1)
        tris = native.delaunay(pts)
        assert len(tris) == 0  # degenerate: no valid triangles


class TestExactFusion:
    def test_matches_port_fusion_on_gt(self):
        scene = make_plane_scene(num_views=3, height=48, width=64, seed=6)
        V = 3
        normals = np.broadcast_to(scene.gt_normal_world,
                                  (V, 48, 64, 3)).copy()
        scenes = _all_pairs(V)
        p1, n1, c1 = native.fuse_exact(scene.gt_depth, normals, scene.colors,
                                       scene.cameras, scenes)
        p2, n2, c2 = run_fusion(scene.gt_depth, normals, scene.colors,
                                scene.cameras, scenes, device="cpu")
        # on consistent GT input the ordering relaxation is a no-op
        assert len(p1) == len(p2)
        d1 = np.abs(p1 @ scene.gt_normal_world)
        assert np.percentile(d1, 99) < 1e-3

    def test_sky_mask_and_static_mode(self):
        scene = make_plane_scene(num_views=3, height=32, width=48, seed=7)
        V = 3
        normals = np.broadcast_to(scene.gt_normal_world,
                                  (V, 32, 48, 3)).copy()
        scenes = _all_pairs(V)
        sky = torch.ones((V, 32, 48), dtype=torch.uint8)
        p, _, _ = native.fuse_exact(scene.gt_depth, normals, scene.colors,
                                    scene.cameras, scenes, sky_masks=sky)
        assert len(p) == 0
        p2, _, _ = native.fuse_exact(scene.gt_depth, normals, scene.colors,
                                     scene.cameras, scenes, use_dynamic=False)
        assert len(p2) > 0

    def test_same_points_as_jax_native(self):
        """The port's binding and the JAX package's (``make -C native``,
        -O3 -march=native) on noisy depths: the same points, within float
        rounding of the two builds' flags."""
        from mpmvs_tpu import native as jax_native
        from mpmvs_tpu.io.cams import Scene as JaxScene

        assert jax_native.available() or jax_native.build()
        scene = make_plane_scene(num_views=4, height=40, width=56, seed=2)
        rng = np.random.default_rng(0)
        depths = scene.gt_depth.copy()
        bump = rng.uniform(size=depths.shape) < 0.15
        depths[bump] *= rng.choice([0.95, 1.05], size=int(bump.sum()))
        normals = np.broadcast_to(scene.gt_normal_world,
                                  depths.shape + (3,)).copy()
        scenes = _all_pairs(4)
        ours = native.fuse_exact(torch.as_tensor(depths), normals,
                                 scene.colors, scene.cameras, scenes)
        cams = type("Cams", (), {f: getattr(scene.cameras, f).numpy()
                                 for f in "KRt"})
        theirs = jax_native.fuse_exact(
            depths, normals, scene.colors, cams,
            [JaxScene(ref_id=s.ref_id, src_ids=s.src_ids) for s in scenes])
        assert len(ours[0]) > 100
        for a, b in zip(ours, theirs):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
