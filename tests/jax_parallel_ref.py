"""The JAX package's scale-out on 4 virtual CPU devices, as references for
tests/test_torch_parallel.py, run in a process of its own (its programs
compile for minutes; the tests start it first and read its files later).

    python tests/jax_parallel_ref.py sharded WORKSPACE OUTPUT BAND_ROWS
        ShardedPipeline (photometric with a prior sub-run, geom_0; FAST
        params) on WORKSPACE; writes OUTPUT/MPMVS/...
    python tests/jax_parallel_ref.py spatial OUT.npz HEIGHT WIDTH SEED \
            BAND_ROWS
        solve_view_spatial of make_plane_scene(3, HEIGHT, WIDTH, SEED) with
        PRNGKey(1), photometric, rows over 4 devices; writes depth, normal,
        cost.

Without a persistent compile cache, as the tests marked ``nocache``.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

from mpmvs_tpu.params import ConfigParams, PatchMatchParams  # noqa: E402


def fast(band_rows: int) -> PatchMatchParams:
    return PatchMatchParams(max_iterations=1, geom_iterations=1, max_scale=0,
                            band_rows=band_rows)


def sharded(ws: str, out: str, band_rows: int) -> None:
    from mpmvs_tpu.parallel.view_sharding import ShardedPipeline

    cfg = ConfigParams(input_folder=ws, output_folder=out, geom_iterations=1,
                       planar_prior=True, geom_planar_prior=False,
                       sky_seg=False)
    ShardedPipeline(cfg, fast(band_rows), devices=jax.devices()[:4]).run(
        log=lambda *a: None)


def spatial(out: str, height: int, width: int, seed: int,
            band_rows: int) -> None:
    from jax.sharding import Mesh
    from mpmvs_tpu.parallel.tile_sharding import solve_view_spatial
    from mpmvs_tpu.utils.synthetic import make_plane_scene

    scene = make_plane_scene(num_views=3, height=height, width=width,
                             seed=seed)
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("tile",))
    res = solve_view_spatial(jnp.asarray(scene.images), scene.cameras,
                             jax.random.PRNGKey(1), fast(band_rows),
                             "photometric", mesh)
    np.savez(out, depth=np.asarray(res.depth), normal=np.asarray(res.normal),
             cost=np.asarray(res.cost))


if __name__ == "__main__":
    kind, *args = sys.argv[1:]
    if kind == "sharded":
        sharded(args[0], args[1], int(args[2]))
    else:
        spatial(args[0], *map(int, args[1:]))
