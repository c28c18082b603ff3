"""Fuzz the host JPEG 2000 decoder under AddressSanitizer and UBSan.

    python tests/data/jp2/fuzz_host_jp2.py [--files N] [--seed S]

Makes ``N`` mutants of the fixtures here with a seeded generator (a few
bytes overwritten, a run of bytes dropped, or the file cut short), then:

* reads each through ``check_host_jp2.py``'s host build (``j2k_decode.h``,
  ``j2k_t1.h`` and the kernels' arithmetic run thread by thread) compiled
  with ``-fsanitize=address,undefined``, in a child process that preloads
  the sanitizer runtime: each mutant is read, or refused with a named code;
* reads each with ``cv2.imread`` from a file, in this process;
* counts the mutants both read, those whose grey or BGR differ from
  cv2's, those only one of the two reads, and the sanitizers' reports.

Exit code 0 when the sanitizers report nothing and every mutant that both
read is cv2's to the entry. Needs g++ with its sanitizer runtimes and
OpenCV.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import check_host_jp2 as tool  # noqa: E402


def mutants(count: int, seed: int) -> list:
    """(name, bytes) of ``count`` mutants of the fixtures."""
    rng = np.random.default_rng(seed)
    sources = []
    for name in tool.NAMES:
        with open(os.path.join(HERE, name), "rb") as f:
            sources.append((name, f.read()))
    out = []
    for k in range(count):
        name, data = sources[rng.integers(len(sources))]
        b = bytearray(data)
        op = rng.integers(3)
        if op == 0:  # overwrite 1-4 bytes
            for _ in range(rng.integers(1, 5)):
                b[rng.integers(len(b))] = rng.integers(256)
        elif op == 1:  # drop a run of 1-16 bytes
            at = rng.integers(len(b))
            del b[at:at + rng.integers(1, 17)]
        else:  # cut short
            del b[rng.integers(1, len(b)):]
        out.append((f"{k:05d}_{name}", bytes(b)))
    return out


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def child(folder: str, lib_path: str, out: str) -> int:
    """Read every file of ``folder`` through the sanitized host build:
    {name: [grey sha, BGR sha] or the refusal's text}."""
    from mpmvs_torch.io import images

    lib = tool.load(lib_path)
    got = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            data = f.read()
        try:
            grey, bgr = tool.read(lib, data)
            got[name] = [_sha(grey), _sha(bgr)]
        except ValueError as e:
            got[name] = str(e)
            if not any(t in str(e) for t in images._CODE_ERRORS.values()):
                got[name] = f"unnamed: {e}"
    with open(out, "w") as f:
        json.dump(got, f)
    return 0


def build_sanitized(out_dir: str) -> str:
    src = os.path.join(out_dir, "j2k_host.cpp")
    with open(src, "w") as f:
        f.write(tool.SHIM)
    lib = os.path.join(out_dir, "libj2k_host_san.so")
    subprocess.run(["g++", "-O1", "-g", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-fsanitize=address,undefined",
                    "-fno-omit-frame-pointer", "-I", tool.CSRC, "-o", lib,
                    src], check=True)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(*args.child)
    import cv2

    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_sanitized(tmp)
        folder = os.path.join(tmp, "mutants")
        os.makedirs(folder)
        want = {}
        for name, data in mutants(args.files, args.seed):
            path = os.path.join(folder, name)
            with open(path, "wb") as f:
                f.write(data)
            bgr = cv2.imread(path, cv2.IMREAD_COLOR)
            grey = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            want[name] = None if bgr is None or grey is None else \
                [_sha(grey), _sha(bgr)]
        runtime = subprocess.run(["g++", "-print-file-name=libasan.so"],
                                 capture_output=True, text=True,
                                 check=True).stdout.strip()
        env = dict(os.environ, LD_PRELOAD=runtime,
                   ASAN_OPTIONS="detect_leaks=0",
                   UBSAN_OPTIONS="print_stacktrace=1",
                   PYTHONPATH=tool.REPO)
        out = os.path.join(tmp, "got.json")
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", folder, lib, out],
                             capture_output=True, text=True, env=env)
        reports = run.stderr.count("runtime error") + \
            run.stderr.count("ERROR: AddressSanitizer")
        if run.returncode != 0 or not os.path.exists(out):
            print(run.stderr[-4000:])
            print(f"the sanitized read stopped (rc {run.returncode})")
            return 1
        with open(out) as f:
            got = json.load(f)
    tally = {"both read, equal": 0, "both read, differ": 0,
             "host read, cv2 refused": 0, "host refused, cv2 read": 0,
             "both refused": 0, "refused without a named code": 0}
    for name, w in want.items():
        g = got[name]
        host_read = isinstance(g, list)
        if isinstance(g, str) and g.startswith("unnamed"):
            tally["refused without a named code"] += 1
        if host_read and w is not None:
            tally["both read, equal" if g == w else "both read, differ"] += 1
        elif host_read:
            tally["host read, cv2 refused"] += 1
            print(f"{name}: the host reads it, cv2 refuses it")
        elif w is not None:
            tally["host refused, cv2 read"] += 1
            print(f"{name}: the host refuses it ({g}), cv2 reads it")
        else:
            tally["both refused"] += 1
    if reports:
        print(run.stderr[-4000:])
    print(f"{len(want)} mutants (seed {args.seed}): {tally}; sanitizer "
          f"reports {reports}")
    return 1 if reports or tally["both read, differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
