"""Time the host half of a JPEG read, ``images.host_decode`` (the parse and
entropy decode; the handle freed after each), of the package at each of
several checkouts, one process a checkout, in the order given, so that two
versions are compared on one machine in one run:

    python -m mpmvs_torch.tools.jpeg_host_ab --roots OLD,NEW,NEW,OLD \\
        --reps 20 --out jpeg_host_ab.json FILE...

Each root is a checkout's top directory; its ``mpmvs_torch`` builds its own
codec library (``nvcc``, so this runs where the card is). Prints, and writes
to ``--out``, each root's ms per file, every repetition after a first
untimed one.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def child(files, reps: int) -> dict:
    """ms of each repetition of each file's host decode, in this process's
    ``mpmvs_torch``."""
    from mpmvs_torch.io import images

    lib = images._library()
    out = {}
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        lib.jpeg_host_free(images.host_decode(data)[0])  # untimed, warm
        ms = []
        for _ in range(reps):
            t = time.perf_counter()
            handle, _ = images.host_decode(data)
            ms.append((time.perf_counter() - t) * 1e3)
            lib.jpeg_host_free(handle)
        out[os.path.basename(path)] = ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--roots", default=".",
                    help="checkouts, comma-separated, run in this order")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    files = [os.path.abspath(f) for f in args.files]
    if args.child:
        print(json.dumps(child(files, args.reps)))
        return 0
    runs = []
    for root in args.roots.split(","):
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--reps",
             str(args.reps), *files], cwd=root, env=env, check=True,
            capture_output=True, text=True)
        runs.append({"root": root, "ms": json.loads(
            res.stdout.strip().splitlines()[-1])})
        for name, ms in runs[-1]["ms"].items():
            print(f"{root}: {name}: median {sorted(ms)[len(ms) // 2]:.3f} "
                  f"ms, min {min(ms):.3f} ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
