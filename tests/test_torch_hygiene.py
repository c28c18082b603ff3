"""Import hygiene and device discipline of mpmvs_torch.

* A fresh interpreter imports the package and every module of the port
  (sky net, planar prior, geometric cost and its kernel's wrapper, the
  sorted NCC path, eval, the image codec, the COLMAP converter, the
  multi-GPU modules, the native bindings and the measurement tools
  included) without pulling in
  JAX, OpenCV or PyYAML (the H100 machine has neither OpenCV nor PyYAML,
  and the port must not depend on JAX).
* A CUDA device that is not there raises instead of running on the CPU.
* An install carries what the port reads at run time: every header the
  CUDA sources include and the sky net's weights are package data, and
  no path in the port names a file of the JAX package.
"""

import os
import re
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
    "mpmvs_torch.io.images", "mpmvs_torch.ops.resize",
    "mpmvs_torch.preprocess", "mpmvs_torch.preprocess.colmap",
    "mpmvs_torch.preprocess.convert", "mpmvs_torch.tools.fusion_diagnose",
    "mpmvs_torch.tools.solve_trace", "mpmvs_torch.parallel",
    "mpmvs_torch.parallel.mesh", "mpmvs_torch.parallel.view_sharding",
    "mpmvs_torch.parallel.tile_sharding", "mpmvs_torch.parallel.multihost",
    "mpmvs_torch.parallel.dryrun", "mpmvs_torch.native",
    "mpmvs_torch.tools.scaling_bench", "mpmvs_torch.bench",
    "mpmvs_torch.tools.prior_stages", "mpmvs_torch.ops.geom_cost_cuda",
    "mpmvs_torch.tools.bench_spread", "mpmvs_torch.tools.jpeg_host_ab",
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


def test_csrc_links_no_library_kernels():
    """The port's CUDA sources call no package of finished kernels: no
    nvJPEG header or call is left (the encoder's first form), and no source
    asks to link a library."""
    import re

    from mpmvs_torch.io import images
    from mpmvs_torch.ops import nvcc

    for name in os.listdir(nvcc.CSRC):
        with open(os.path.join(nvcc.CSRC, name)) as f:
            assert not re.search(r"<nvjpeg|\bnvjpeg[A-Z_]|NVJPEG_", f.read()), \
                name
    assert not any(f.startswith("-l") for f in images.NVCC_FLAGS)


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


def _package_data_globs():
    """The package-data globs of ``mpmvs_torch`` and its subpackages in
    pyproject.toml, as paths under the repository."""
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    block = text.split("[tool.setuptools.package-data]", 1)[1].split(
        "\n[", 1)[0]
    out = []
    for pkg, globs in re.findall(r'^"?([\w.]+)"?\s*=\s*\[(.*?)\]', block,
                                 re.M):
        if pkg.split(".")[0] == "mpmvs_torch":
            out += [os.path.join(*pkg.split("."), g)
                    for g in re.findall(r'"([^"]+)"', globs)]
    return out


def test_package_data_ships_every_included_header():
    """Each ``#include "..."`` of a CUDA or C source under
    mpmvs_torch/csrc, and the sky net's weights, is matched by a
    package-data glob: a non-editable install can build every kernel and
    load the weights."""
    import fnmatch

    from mpmvs_torch.models import sky
    from mpmvs_torch.ops import nvcc

    globs = _package_data_globs()
    need = set()
    for name in os.listdir(nvcc.CSRC):
        need.add(name)
        with open(os.path.join(nvcc.CSRC, name)) as f:
            need.update(re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(),
                                   re.M))
    rel = [os.path.join("mpmvs_torch", "csrc", n) for n in sorted(need)]
    rel.append(os.path.relpath(sky.VENDORED_NPZ, REPO))
    missing = [p for p in rel if not any(fnmatch.fnmatch(p, g)
                                         for g in globs)]
    assert not missing, (missing, globs)
    assert all(os.path.exists(os.path.join(REPO, p)) for p in rel)


def test_sky_weights_are_the_ports_own_copy():
    """The port's sky weights are a copy of the JAX package's file, byte
    for byte, read from the port's own tree."""
    import hashlib

    from mpmvs_torch.models import sky

    theirs = os.path.join(REPO, "mpmvs_tpu", "models", "weights",
                          "skyseg_fp16.npz")
    digest = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    assert os.path.dirname(sky.VENDORED_NPZ).startswith(
        os.path.join(REPO, "mpmvs_torch"))
    assert digest(sky.VENDORED_NPZ) == digest(theirs)


PATH_CALLS = {"join", "Path", "open", "exists", "isfile", "isdir", "listdir",
              "load", "abspath", "realpath", "dirname"}


def test_port_names_no_path_in_the_jax_package():
    """No string outside comments and docstrings of mpmvs_torch/ names a
    path in mpmvs_tpu: neither a literal with a separator after the name
    nor the name as an argument of a path-building or file call (the name
    alone is allowed as a module name, as the bench's foreign-module check
    uses it)."""
    import ast

    bad = []
    root = os.path.join(REPO, "mpmvs_torch")
    for folder, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(folder, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            docs = {id(n.body[0].value) for n in ast.walk(tree)
                    if isinstance(n, (ast.Module, ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.ClassDef))
                    and n.body and isinstance(n.body[0], ast.Expr)
                    and isinstance(n.body[0].value, ast.Constant)}
            for node in ast.walk(tree):
                if isinstance(node, ast.Constant) and isinstance(
                        node.value, str) and id(node) not in docs and \
                        re.search(r"mpmvs_tpu[/\\]", node.value):
                    bad.append((path, node.lineno, node.value))
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                fname = fn.attr if isinstance(fn, ast.Attribute) else \
                    getattr(fn, "id", "")
                if fname in PATH_CALLS and any(
                        isinstance(a, ast.Constant) and isinstance(
                            a.value, str) and "mpmvs_tpu" in a.value
                        for a in node.args):
                    bad.append((path, node.lineno, fname))
    assert not bad, bad
