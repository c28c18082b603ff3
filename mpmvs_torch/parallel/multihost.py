"""Multi-host runs: one process per GPU, on as many hosts as the job spans.

Counterpart of ``mpmvs_tpu.parallel.multihost``. The JAX package starts one
process per host with ``jax.distributed`` and one global mesh over every
host's chips; the port starts one process per card, each a rank of one
``torch.distributed`` job (NCCL between cards, across hosts included), and
runs ``view_sharding.ShardedPipeline`` in each. Every process loads the
(shared) workspace; each writes its views' checkpoints, and the final
results are gathered to rank 0 over the job's collectives, so a shared
filesystem is not required. Rank 0 runs the sky masks and fusion.

Launch one command per process:

    python -m mpmvs_torch.parallel.multihost \\
        --coordinator HOST:PORT --num-processes N --process-id I \\
        --input WORKSPACE [--preset fast]

or under ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) with the first three flags left out:

    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-endpoint HOST:PORT \\
        -m mpmvs_torch.parallel.multihost --input WORKSPACE

``--device cpu`` (the JAX package's ``--cpu-devices K``) runs the ranks on
the CPU over gloo, for testing. The JAX runner's warm-up psum is not
ported: it worked around a rendezvous deadline of the JAX runtime, and
``torch.distributed`` rendezvous at ``init_process_group`` itself.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import torch

from mpmvs_torch.parallel import mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> mesh.RankGroup:
    """Join the job: NCCL on this host's card ``LOCAL_RANK`` (torchrun's),
    else the process id modulo the host's card count; gloo on the CPU with
    ``device="cpu"``. Arguments left out are read from torchrun's
    environment."""
    env = os.environ
    if coordinator is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(f"no --coordinator and no {', '.join(missing)} "
                               f"in the environment")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of {num_processes}")
    if "LOCAL_RANK" in env:
        local_rank = int(env["LOCAL_RANK"])
    elif device == "cuda":
        local_rank = process_id % max(torch.cuda.device_count(), 1)
    else:
        local_rank = 0
    dev = mesh.rank_device(local_rank, device)
    return mesh.init_group("nccl" if dev.type == "cuda" else "gloo",
                           f"tcp://{coordinator}", num_processes, process_id,
                           dev)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpmvs-torch-multihost",
        description="Multi-host MP-MVS on PyTorch: one process per GPU")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (default: MASTER_ADDR and "
                        "MASTER_PORT, as torchrun sets them)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="ranks in the job (default: WORLD_SIZE)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (default: RANK)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cpu': ranks on the CPU over gloo (tests)")
    p.add_argument("--input", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--geom-iterations", type=int, default=None)
    p.add_argument("--preset", choices=["full", "fast"], default="full")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--planar-prior", action="store_true",
                   help="enable the planar-prior schedule (main.cpp:20-41)")
    p.add_argument("--geom-planar-prior", action="store_true",
                   help="prior sub-runs inside geometric passes")
    p.add_argument("--sky-seg", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mpmvs_torch.params import ConfigParams, PatchMatchParams
    from mpmvs_torch.parallel.view_sharding import ShardedPipeline

    cfg = ConfigParams(input_folder=args.input,
                       output_folder=args.output or args.input,
                       planar_prior=args.planar_prior,
                       geom_planar_prior=args.geom_planar_prior,
                       sky_seg=args.sky_seg, seed=args.seed)
    if args.geom_iterations is not None:
        cfg.geom_iterations = args.geom_iterations
    params = None
    if args.preset == "fast":
        params = PatchMatchParams(max_iterations=1, geom_iterations=1,
                                  max_scale=0,
                                  max_image_size=cfg.max_image_size)
    group = initialize(args.coordinator, args.num_processes,
                       args.process_id, args.device)
    try:
        ply = ShardedPipeline(cfg, params, group=group).run(
            log=lambda msg: print(msg, flush=True))
    finally:
        mesh.destroy_group()
    if ply:
        print(f"point cloud: {ply}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
