"""Process groups of the port's scale-out: one process per GPU.

Counterpart of ``mpmvs_tpu.parallel.mesh``. The JAX package puts every
device of a host (or a pod) in one ``Mesh`` and lets XLA place the
collectives. Here each GPU is driven by a process of its own, and the
processes talk through ``torch.distributed``:

  * the data group carries tensors: NCCL between cards, gloo on the CPU
    (which only the tests use); a tensor on another device than the
    group's backend serves raises;
  * the control group is gloo on every backend and carries only small
    Python objects and barriers. Rank 0 fuses and writes for minutes while
    the others wait at the last barrier; an NCCL barrier would time out
    there, so the control group waits up to ``CONTROL_TIMEOUT`` (30 min,
    the JAX package's coordination-service barrier, multihost.py:111-124).

Work is split in contiguous slots (``view_slots``): views over ranks for
the view-sharded pipeline, row bands over ranks for the row-sharded solve.
``spawn`` starts one process per card of this host; ``multihost``
initialises one process of a job that spans hosts.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

CONTROL_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass
class RankGroup:
    """One process's view of a group: its rank, the group's size, the
    device it computes on, the data group ``pg`` and the control group
    ``ctrl``."""

    rank: int
    size: int
    device: torch.device
    pg: object
    ctrl: object

    @property
    def backend(self) -> str:
        return dist.get_backend(self.pg)


def rank_device(local_rank: int, device_type: str = "cuda") -> torch.device:
    """The device of a rank: ``cuda:<local_rank>``, or the CPU when the
    caller asks for it. A card that is not there raises."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unknown device type {device_type!r}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= local_rank < count:
        raise RuntimeError(f"rank needs cuda:{local_rank}, but this host has "
                           f"{count} CUDA device(s)")
    return torch.device("cuda", local_rank)


def init_group(backend: str, init_method: str, world_size: int, rank: int,
               device: torch.device) -> RankGroup:
    """Join the default process group (``backend`` "nccl" with a CUDA
    ``device``, "gloo" with the CPU) and make the gloo control group."""
    if (backend == "nccl") != (device.type == "cuda"):
        raise ValueError(f"backend {backend} cannot carry tensors on {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=CONTROL_TIMEOUT)
    ctrl = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    # NCCL makes its communicator at the first collective: make it now, so
    # a broken transport fails here and the set-up stays out of the first
    # pass's timings
    dist.all_reduce(torch.zeros(1, device=device))
    return RankGroup(rank=rank, size=world_size, device=device,
                     pg=dist.group.WORLD, ctrl=ctrl)


def subgroup(group: RankGroup, ranks: Sequence[int]) -> Optional[RankGroup]:
    """A group of some of ``group``'s ranks (every rank of ``group`` must
    call this); None on the ranks left out."""
    ranks = list(ranks)
    pg = dist.new_group(ranks, backend=group.backend,
                        timeout=CONTROL_TIMEOUT)
    ctrl = dist.new_group(ranks, backend="gloo", timeout=CONTROL_TIMEOUT)
    if group.rank not in ranks:
        return None
    return RankGroup(rank=ranks.index(group.rank), size=len(ranks),
                     device=group.device, pg=pg, ctrl=ctrl)


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def view_slots(n: int, ranks: int) -> List[List[int]]:
    """Items 0..n-1 in contiguous slots over ``ranks`` ranks, the first
    ``n % ranks`` slots one item longer; a rank may get none."""
    base, extra = divmod(n, ranks)
    slots, lo = [], 0
    for r in range(ranks):
        hi = lo + base + (r < extra)
        slots.append(list(range(lo, hi)))
        lo = hi
    return slots


def barrier(group: RankGroup) -> None:
    """Control-plane barrier (gloo; waits up to ``CONTROL_TIMEOUT``)."""
    dist.barrier(group=group.ctrl)


def all_gather_object(group: RankGroup, obj) -> list:
    """Every rank's ``obj`` (small, picklable), in rank order, over the
    control group."""
    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.ctrl)
    return out


def _check_device(group: RankGroup, t: Tensor) -> None:
    if t.device.type != group.device.type:
        raise ValueError(f"a {t.device} tensor on a {group.backend} group "
                         f"of {group.device} ranks")


Spec = Sequence[Tuple[Tuple[int, ...], torch.dtype]]


def _pack(leaves: Sequence[Tensor]) -> Tensor:
    """The bytes of ``leaves``, concatenated (bit for bit, any dtype)."""
    return torch.cat([leaf.contiguous().reshape(-1).view(torch.uint8)
                      for leaf in leaves])


def _unpack(buf: Tensor, spec: Spec) -> Tuple[Tensor, ...]:
    out, lo = [], 0
    for shape, dtype in spec:
        n = item_bytes([(shape, dtype)])
        out.append(buf[lo:lo + n].clone().view(dtype).reshape(shape))
        lo += n
    return tuple(out)


def item_bytes(spec: Spec) -> int:
    """Bytes of one item of ``spec``."""
    return sum(torch.Size(s).numel() * torch.empty((), dtype=d).element_size()
               for s, d in spec)


def _local_buffer(group: RankGroup, slots: List[List[int]],
                  local: Sequence[Sequence[Tensor]], spec: Spec) -> Tensor:
    """This rank's items as rows of bytes, padded to the longest slot."""
    per = max(len(s) for s in slots)
    buf = torch.zeros((per, item_bytes(spec)), dtype=torch.uint8,
                      device=group.device)
    for j, item in enumerate(local):
        buf[j] = _pack(item)
    _check_device(group, buf)
    return buf


def _items(parts: List[Tensor], slots: List[List[int]],
           spec: Spec) -> List[Tuple[Tensor, ...]]:
    """Every rank's buffer back into items, in item order."""
    return [_unpack(parts[r][j], spec)
            for r, slot in enumerate(slots) for j in range(len(slot))]


def all_gather_items(group: RankGroup, slots: List[List[int]],
                     local: Sequence[Sequence[Tensor]],
                     spec: Spec) -> List[Tuple[Tensor, ...]]:
    """Every item of every rank, in item order. ``local`` holds this rank's
    items (``slots[rank]``), each a tuple of tensors of the shapes and
    dtypes ``spec`` gives; the items travel as bytes in one all-gather
    over the data group, so they arrive bit for bit."""
    buf = _local_buffer(group, slots, local, spec)
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.pg)
    return _items(parts, slots, spec)


def map_items(group: Optional[RankGroup], n: int,
              fn: Callable[[int], Sequence[Tensor]],
              spec: Spec) -> List[Tuple[Tensor, ...]]:
    """``[fn(i) for i in range(n)]``; with a group, each rank computes its
    slot of the items and the results are all-gathered, so every rank
    returns the same list (``spec`` gives each item's leaves)."""
    if group is None:
        return [tuple(fn(i)) for i in range(n)]
    slots = view_slots(n, group.size)
    local = [tuple(fn(i)) for i in slots[group.rank]]
    return all_gather_items(group, slots, local, spec)


def gather_items_to_root(group: RankGroup, slots: List[List[int]],
                         local: Sequence[Sequence[Tensor]], spec: Spec
                         ) -> Optional[List[Tuple[Tensor, ...]]]:
    """As :func:`all_gather_items`, but only rank 0 keeps the items; None
    on the other ranks. One broadcast from each rank over the data group's
    communicator: NCCL's gather is made of point-to-point sends, whose
    communicators NCCL sets up at their first use, ~0.35-0.5 s a peer on
    H100s (PERF.md section 6); the other ranks hold one rank's items
    at a time."""
    buf = _local_buffer(group, slots, local, spec)
    parts = []
    for r in range(group.size):
        part = buf if r == group.rank else torch.empty_like(buf)
        dist.broadcast(part, src=dist.get_global_rank(group.pg, r),
                       group=group.pg)
        if group.rank == 0:
            parts.append(part)
    return _items(parts, slots, spec) if group.rank == 0 else None


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn: Callable, args: tuple, world_size: int,
          device_type: str = "cuda",
          device_ids: Optional[Sequence[int]] = None) -> None:
    """Run ``fn(group, *args)`` in ``world_size`` new processes on this
    host, one per card ``device_ids[rank]`` (default 0..world_size-1) over
    NCCL, or on the CPU over gloo with ``device_type="cpu"``. Returns when
    every rank has returned; a rank that raises or dies ends the others
    and raises here (torch.multiprocessing's ``ProcessRaisedException`` or
    ``ProcessExitedException``)."""
    ids = list(device_ids) if device_ids is not None else list(
        range(world_size))
    if len(ids) != world_size:
        raise ValueError(f"{world_size} ranks but devices {ids}")
    if device_type == "cuda":
        for i in ids:   # raise here, not in the children
            rank_device(i, "cuda")
    init = f"tcp://localhost:{free_port()}"
    # CPU ranks share this process's thread budget
    threads = max(1, torch.get_num_threads() // world_size)
    torch.multiprocessing.start_processes(
        _rank_entry, args=(world_size, init, device_type, ids, threads, fn,
                           args),
        nprocs=world_size, join=True, start_method="spawn")


def _rank_entry(rank: int, world_size: int, init_method: str,
                device_type: str, ids: List[int], threads: int,
                fn: Callable, args: tuple):
    device = rank_device(ids[rank], device_type)
    if device.type == "cpu":
        torch.set_num_threads(threads)
    group = init_group("nccl" if device.type == "cuda" else "gloo",
                       init_method, world_size, rank, device)
    try:
        fn(group, *args)
    finally:
        destroy_group()
