"""Command-line entry point of the PyTorch port.

``python -m mpmvs_torch.cli --input <workspace> --device cuda`` (or
``mpmvs-torch``), with the flags of ``python -m mpmvs_tpu.cli``; flags
override YAML keys. The defaults run the reference's schedule: the
photometric pass, two geometric passes with a planar-prior sub-run in the
first, then fusion; ``--sky-seg 1`` adds sky masks before fusion.
``--devices all`` (or ``0,2,3``) shards the views over those cards of this
host, one process per card over NCCL (``parallel.view_sharding``); a list
naming a card that is not there raises.
"""

from __future__ import annotations

import argparse
import sys

from mpmvs_torch.params import ConfigParams, PatchMatchParams
from mpmvs_torch.pipeline import Pipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpmvs-torch",
        description="PatchMatch Multi-View Stereo on PyTorch/CUDA")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config (reference config.yaml schema)")
    p.add_argument("--input", dest="input_folder", type=str, default=None,
                   help="dense workspace (images/, cams/, pair.txt)")
    p.add_argument("--output", dest="output_folder", type=str, default=None)
    p.add_argument("--geom-iterations", type=int, default=None)
    p.add_argument("--planar-prior", type=int, choices=[0, 1], default=None)
    p.add_argument("--geom-planar-prior", type=int, choices=[0, 1],
                   default=None)
    p.add_argument("--sky-seg", type=int, choices=[0, 1], default=None)
    p.add_argument("--dynamic-consistency", type=int, choices=[0, 1],
                   default=None)
    p.add_argument("--max-source-images", type=int, default=None)
    p.add_argument("--max-image-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="reuse existing per-view .dmb results")
    p.add_argument("--save-jpg", action="store_true",
                   help="write depth/cost/normal visualizations")
    p.add_argument("--devices", type=str, default=None,
                   help="shard the views over these CUDA cards of this host, "
                        "one process each: 'all' or a list such as 0,2,3")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    p.add_argument("--preset", choices=["full", "fast"], default="full",
                   help="'fast': single scale, 1 iteration — smoke tests")
    return p


def config_from_args(args) -> ConfigParams:
    cfg = ConfigParams.from_yaml(args.config) if args.config else ConfigParams()
    overrides = {
        "input_folder": args.input_folder,
        "output_folder": args.output_folder,
        "geom_iterations": args.geom_iterations,
        "max_source_images": args.max_source_images,
        "max_image_size": args.max_image_size,
        "seed": args.seed,
    }
    for k, v in overrides.items():
        if v is not None:
            setattr(cfg, k, v)
    if args.planar_prior is not None:
        cfg.planar_prior = bool(args.planar_prior)
    if args.geom_planar_prior is not None:
        cfg.geom_planar_prior = bool(args.geom_planar_prior)
    if args.sky_seg is not None:
        cfg.sky_seg = bool(args.sky_seg)
    if args.dynamic_consistency is not None:
        cfg.use_dynamic_consistency = bool(args.dynamic_consistency)
    if args.save_jpg:
        cfg.save_dmb = cfg.save_cost_dmb = cfg.save_normal_dmb = True
    if not cfg.input_folder:
        raise SystemExit("error: --input (or Input-folder in --config) is required")
    if not cfg.output_folder:
        cfg.output_folder = cfg.input_folder
    return cfg


def device_list(spec: str) -> list:
    """The card indices of ``--devices``: 'all' or a comma list; raises
    where a card is not there or is named twice."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ids = list(range(count)) if spec == "all" else [
        int(x) for x in spec.split(",")]
    if not ids:
        raise RuntimeError("--devices all: this host has no CUDA device")
    bad = [i for i in ids if not 0 <= i < count]
    if bad or len(set(ids)) != len(ids):
        raise ValueError(f"--devices {spec}: this host has {count} CUDA "
                         f"device(s), and each may be named once")
    return ids


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    params = None
    if args.preset == "fast":
        params = PatchMatchParams(max_iterations=1, geom_iterations=1,
                                  max_scale=0,
                                  max_image_size=cfg.max_image_size)
    if args.devices:
        from mpmvs_torch.parallel.view_sharding import launch

        if args.device != "cuda":
            raise ValueError("--devices names CUDA cards; drop --device")
        ply = launch(cfg, params, device_ids=device_list(args.devices),
                     resume=args.resume)
    else:
        pipe = Pipeline(cfg, params=params, device=args.device)
        ply = pipe.run(resume=args.resume)
    print(f"point cloud: {ply}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
