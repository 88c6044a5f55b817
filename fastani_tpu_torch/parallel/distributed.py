"""Processes, devices and collectives of a sharded run (counterpart of
``fastani_tpu/parallel/distributed.py``).

The reference scales past one node by hand: a shell script splits the
reference list, the user runs one process per part and concatenates the
outputs (scripts/splitDatabase.sh:14-39).  Here one run spans the
processes of a ``torch.distributed`` group, one device each, and an
(r, q) grid of cells:

* r, the reference shards (``mesh.shard_files``): a shard is built only by
  the processes that run one of its cells;
* q, the slices of each fragment batch.

``plan`` gives the cells to the processes in row-major blocks, so a
process holds as few shards as it can.  With one process, that process
runs every cell in turn on its device: that is how ``--mesh 2x2`` runs on
one card, and how the CPU tests run it.

The collectives replace the JAX package's ``lax.pmax`` and
``process_allgather``: ``q_max`` is the q-merge of the device CGI at each
finalize (``all_reduce`` MAX over the processes that run a shard's cells),
``gather`` brings every shard's results to process 0, which assembles them
and writes the files, and ``all_gather`` shares what every process needs
(the shards' sanity checks and contigs, the query genomes to redo).  They
run whenever a process group exists, one process
included, so a one-process NCCL run does go through NCCL; a collective that
fails raises.  The backend follows the device: NCCL for ``cuda``, gloo for
``cpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from fastani_tpu_torch.ops.cuda import resolve_device


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> int:
    """Join the process group of a run; returns this process's rank.

    Nothing to do (rank 0) for one process without a coordinator.  Else
    ``init_process_group`` with ``init_method=tcp://{coordinator}``, the
    world size and the rank given, and the backend of ``device``: NCCL for
    ``cuda`` (which needs a card: ``resolve_device`` raises without one),
    gloo for ``cpu``.  A ``cuda`` process drives card ``rank % count``."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank()
    world = num_processes or 1
    if not coordinator:
        if world > 1:
            raise ValueError(f"a run of {world} processes needs a "
                             f"coordinator address (--coordinator host:port)")
        return 0
    if world > 1 and process_id is None:
        raise ValueError("each of several processes needs its id (--procid)")
    rank = process_id or 0
    if dev.type == "cuda":
        torch.cuda.set_device(_card(dev, rank))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return rank


def _card(dev: torch.device, rank: int) -> torch.device:
    if dev.index is not None:
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


@contextlib.contextmanager
def session(coordinator: Optional[str], num_processes: Optional[int],
            process_id: Optional[int], device):
    """``initialize``, then yield the device this process drives (without
    a process group, ``device`` itself); the process group is destroyed on
    exit if this call created it."""
    created = not dist.is_initialized()
    rank = initialize(coordinator, num_processes, process_id, device)
    created = created and dist.is_initialized()
    dev = resolve_device(device)
    try:
        yield (_card(dev, rank) if dev.type == "cuda" and dist.is_initialized()
               else dev)
    finally:
        if created:
            dist.destroy_process_group()


def backend() -> str:
    """The process group's backend, or "none" without one."""
    return dist.get_backend() if dist.is_initialized() else "none"


def world() -> Tuple[int, int]:
    """(rank, world size) of this process."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def mesh_shape(n_r: Optional[int], n_q: Optional[int],
               dev: torch.device) -> Tuple[int, int]:
    """The (r, q) shape; ``None`` for both is ``--mesh auto``: one shard row
    a process and the devices left over along q (the JAX package's
    ``multihost_mesh`` default), over ``torch.cuda.device_count()`` cards
    on ``cuda``; on ``cpu`` each process counts as one device, so one
    process runs 1x1."""
    if n_r is not None and n_q is not None:
        return n_r, n_q
    _, size = world()
    devices = torch.cuda.device_count() if dev.type == "cuda" else size
    return size, max(1, devices // size)


@dataclasses.dataclass
class Plan:
    """This process's part of an (r, q) run."""
    n_r: int
    n_q: int
    rank: int
    owner: Dict[Tuple[int, int], int]   # cell (r, q) -> the rank running it
    # row r -> the process group of the ranks running its cells (rows this
    # rank runs a cell of; absent without a process group)
    groups: Dict[int, object]

    @property
    def cells(self) -> List[Tuple[int, int]]:
        return sorted(c for c, o in self.owner.items() if o == self.rank)

    @property
    def rows(self) -> List[int]:
        return sorted({r for r, _ in self.cells})

    def cells_of(self, r: int) -> List[int]:
        """The q of this rank's cells in shard row r."""
        return [q for rr, q in self.cells if rr == r]

    def reports(self, r: int) -> bool:
        """Whether this rank's results stand for shard r (it runs (r, 0);
        every process of a row folds the same merged rows)."""
        return self.owner[(r, 0)] == self.rank


def plan(n_r: int, n_q: int) -> Plan:
    """The cells of an n_r x n_q run: cell (r, q) in row-major order goes
    to the rank of its block, so a rank's cells share as few shard rows as
    they can (the JAX package's ``plan``, whose mesh orders each process's
    devices together).  Every process calls this, in the same order, as it
    creates one group per shard row."""
    rank, size = world()
    n_cells = n_r * n_q
    if n_r < 1 or n_q < 1 or n_cells < size:
        raise ValueError(f"a {n_r}x{n_q} mesh has {n_cells} cells for "
                         f"{size} processes")
    owner = {(r, q): (r * n_q + q) * size // n_cells
             for r in range(n_r) for q in range(n_q)}
    groups = {}
    if dist.is_initialized():
        for r in range(n_r):
            ranks = sorted({owner[(r, q)] for q in range(n_q)})
            g = dist.group.WORLD if len(ranks) == size else dist.new_group(
                ranks)
            if rank in ranks:
                groups[r] = g
    return Plan(n_r, n_q, rank, owner, groups)


def q_max(p: Plan, r: int):
    """The cross-process part of shard r's q-merge: a function replacing a
    tensor in place by its elementwise max over the processes that run r's
    cells; None without a process group."""
    group = p.groups.get(r)
    if group is None:
        return None
    return lambda t: dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)


def all_gather(obj) -> list:
    """Every process's ``obj`` (picklable; here numpy arrays and dicts this
    program made), in rank order; ``[obj]`` without a process group."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def gather(obj) -> Optional[list]:
    """Every process's ``obj`` on process 0, in rank order (None on the
    other processes); ``[obj]`` without a process group."""
    if not dist.is_initialized():
        return [obj]
    rank = dist.get_rank()
    out = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out
