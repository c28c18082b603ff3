"""Import hygiene and device discipline of mpmvs_torch.

* A fresh interpreter imports the package and every module of the port
  (sky net, planar prior, geometric cost, the sorted NCC path, eval and
  the measurement tools included) without pulling in
  JAX, OpenCV or PyYAML (the H100 machine has neither OpenCV nor PyYAML,
  and the port must not depend on JAX).
* A CUDA device that is not there raises instead of running on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpmvs_torch import interop
from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.params import ConfigParams, PatchMatchParams
from mpmvs_torch.pipeline import Pipeline
from mpmvs_torch.solver import PatchMatchSolver, solve_view
from mpmvs_torch.utils.synthetic import make_plane_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_MODULES = [
    "mpmvs_torch", "mpmvs_torch.params", "mpmvs_torch.camera",
    "mpmvs_torch.geometry", "mpmvs_torch.io", "mpmvs_torch.io.dmb",
    "mpmvs_torch.io.cams", "mpmvs_torch.io.ply", "mpmvs_torch.ops.sampling",
    "mpmvs_torch.ops.packing", "mpmvs_torch.ops.threefry",
    "mpmvs_torch.ops.random", "mpmvs_torch.ops.ncc",
    "mpmvs_torch.ops.ncc_cuda", "mpmvs_torch.ops.nvcc",
    "mpmvs_torch.ops.bilateral_cuda", "mpmvs_torch.ops.geom_cost",
    "mpmvs_torch.models", "mpmvs_torch.models.ncnn", "mpmvs_torch.models.sky",
    "mpmvs_torch.prior", "mpmvs_torch.ops.view_selection",
    "mpmvs_torch.ops.filters", "mpmvs_torch.ops.propagation",
    "mpmvs_torch.solver", "mpmvs_torch.fusion", "mpmvs_torch.pipeline",
    "mpmvs_torch.cli", "mpmvs_torch.interop", "mpmvs_torch.utils.synthetic",
    "mpmvs_torch.utils.workspace", "mpmvs_torch.utils.trace",
    "mpmvs_torch.utils.visualize", "mpmvs_torch.ops.ncc_sorted",
    "mpmvs_torch.eval", "mpmvs_torch.tools",
    "mpmvs_torch.tools.ab_deviations", "mpmvs_torch.tools.synthetic_eval",
    "mpmvs_torch.tools.kernel_bench", "mpmvs_torch.utils.roofline",
]


def test_import_pulls_in_no_jax_cv2_or_yaml():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'cv2', 'yaml', 'mpmvs_tpu')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_missing_cuda_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    scene = make_plane_scene(num_views=2, height=16, width=24, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pipeline(ConfigParams(input_folder="x", output_folder="x"),
                 device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_view(scene.images, scene.cameras, tf.PRNGKey(0),
                   PatchMatchParams(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PatchMatchSolver(PatchMatchParams(), device="cuda")


def test_interop_round_trip():
    cam_arrays = {"K": np.eye(3, dtype=np.float32)[None].repeat(2, 0),
                  "R": np.eye(3, dtype=np.float32)[None].repeat(2, 0),
                  "t": np.zeros((2, 3), np.float32),
                  "width": np.array([8, 8], np.float32),
                  "height": np.array([6, 6], np.float32),
                  "depth_min": np.array([1, 1], np.float32),
                  "depth_max": np.array([5, 5], np.float32)}
    cams = interop.camera_stack_from_numpy(cam_arrays)
    assert cams.K.dtype == torch.float32 and cams.num_views == 2
    params = interop.params_from_jax_fields(
        {"max_iterations": 2, "sampler": "xla", "dispatch": "auto",
         "src_quant8": True, "debug_skip_ncc": False})
    assert params.max_iterations == 2
    with pytest.raises(ValueError, match="unknown"):
        interop.params_from_jax_fields({"no_such_knob": 1})
    st = interop.state_from_numpy(np.zeros((4, 6, 4)), np.ones((4, 6)),
                                  np.zeros((4, 6)), np.full((4, 6), 3))
    assert st.sel.dtype == torch.int32 and st.plane.dtype == torch.float32
    res = interop.result_from_numpy(np.ones((4, 6)), np.zeros((4, 6, 3)),
                                    np.zeros((4, 6)), np.zeros((4, 6)))
    assert res.normal.shape == (4, 6, 3)
    key = interop.key_from_numpy(np.array([1, 2], np.uint32))
    assert key.tolist() == [1, 2]
    with pytest.raises(ValueError):
        interop.key_from_numpy(np.array([1, 2], np.int32))
