"""Build the port's CUDA sources with ``nvcc`` into shared libraries.

Every kernel of the port is a ``.cu`` file under ``mpmvs_torch/csrc/`` with a
plain C launch function, compiled for sm_90a into ``mpmvs_torch/_build/``
(gitignored) at first use and bound with ctypes. A library is named by the
hash of its source, the ``csrc/*.cuh`` headers it includes and its flags,
so an edited source or header builds anew. Nothing here runs at import time:
the CPU tests import every module on a host without ``nvcc``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


@dataclasses.dataclass
class LaunchCounts:
    """Calls that reached a kernel's wrapper (``kernel``: launches, and
    ``forms``: launches by the kernel's form where it has several) and its
    plain version (``plain``, and ``plain_forms`` by form where the plain
    version counts them) since the last reset."""

    kernel: int = 0
    plain: int = 0
    forms: Dict[str, int] = dataclasses.field(default_factory=dict)
    plain_forms: Dict[str, int] = dataclasses.field(default_factory=dict)

    def launched(self, form: str = None):
        """Count one launch, of ``form`` if named."""
        self.kernel += 1
        if form is not None:
            self.forms[form] = self.forms.get(form, 0) + 1

    def reset(self):
        self.kernel = 0
        self.plain = 0
        self.forms.clear()
        self.plain_forms.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels cannot be built")
    return path


def build(source: str, flags: Sequence[str] = (), verbose: bool = False) -> str:
    """Compile ``csrc/<source>`` with ``BASE_FLAGS + flags`` (once per
    content of the source and of the ``csrc/`` headers it includes, and
    flags) and return the library's path. ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's report of registers and
    spills with the build time."""
    path = os.path.join(CSRC, source)
    all_flags = BASE_FLAGS + list(flags)
    digest = hashlib.sha256(" ".join(all_flags).encode())
    with open(path, "rb") as f:
        text = f.read()
    digest.update(text)
    for name in _INCLUDE.findall(text):
        with open(os.path.join(CSRC, name.decode()), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib) and not verbose:
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{time.monotonic_ns()}.tmp"
    cmd = [_nvcc()] + all_flags + (["-Xptxas", "-v"] if verbose else []) + [
        "-o", tmp, path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    if verbose:
        print(f"{proc.stderr.strip()}\nbuilt {os.path.basename(lib)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    return lib


def build_all(sources: Dict[str, Sequence[str]],
              verbose: bool = False) -> Dict[str, str]:
    """Build several sources at once, one ``nvcc`` process each, all started
    together. ``sources`` maps a file under ``csrc/`` to its extra flags.
    Returns {source: library path}; the first failure raises."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {src: pool.submit(build, src, flags, verbose)
                   for src, flags in sources.items()}
        return {src: fut.result() for src, fut in futures.items()}

