"""Run a command and sample the resident memory of its process tree.

    python -m mpmvs_torch.tools.tree_memory --out mem.json -- CMD [ARGS...]

Every ``--every`` seconds (0.5) reads ``/proc`` for the command's process
and all its descendants: the tree's total resident set, and each
process's largest, with its command line. Writes (and prints) one JSON
object: the command's exit code and seconds, the tree's peak total (GiB)
and when it came, and the ``--top`` processes by their own peak. Linux
only; a process that starts and ends between two samples is not seen.
It exits with the command's code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _children() -> dict:
    """parent pid -> [child pids], from /proc/<pid>/stat."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        out.setdefault(ppid, []).append(int(name))
    return out


def _rss_and_cmd(pid: int):
    """(resident bytes, command line) of a process, or None once it is
    gone."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE"), cmd.strip()


def sample_tree(cmd, every: float = 0.5, top: int = 15) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd)
    peak, peak_at, seen = 0, 0.0, {}
    while proc.poll() is None:
        kids, tree, total = _children(), [proc.pid], 0
        for pid in tree:
            tree.extend(kids.get(pid, []))
        now = time.perf_counter() - t0
        for pid in tree:
            got = _rss_and_cmd(pid)
            if got is None:
                continue
            rss, line = got
            total += rss
            rec = seen.setdefault(pid, {"cmd": line[:200], "peak_gib": 0.0,
                                        "first_s": now})
            rec["peak_gib"] = max(rec["peak_gib"], rss / 2 ** 30)
            rec["last_s"] = now
        if total > peak:
            peak, peak_at = total, now
        time.sleep(every)
    return {"command": cmd, "rc": proc.returncode,
            "seconds": time.perf_counter() - t0,
            "peak_total_gib": peak / 2 ** 30, "peak_at_s": peak_at,
            "top": sorted(seen.values(), key=lambda r: -r["peak_gib"])[:top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--every", type=float, default=0.5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command")
    rec = sample_tree(cmd, args.every, args.top)
    text = json.dumps(rec, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return rec["rc"]


if __name__ == "__main__":
    sys.exit(main())
