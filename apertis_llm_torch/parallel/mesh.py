"""The device mesh over the ranks of a ``torch.distributed`` process group
(``apertis_llm_tpu/parallel/mesh.py``).

One mesh, the JAX package's four named axes ``AXES = ("data", "model",
"expert", "seq")``; the ranks are laid out on them row-major, so the ``seq``
neighbours of a rank are consecutive ranks. Every axis longer than one gets
one process group per line of ranks along it, and each rank keeps the group
of its own line: the ``data`` group carries nothing in the port (gradients
are summed over the whole world), the ``seq`` group the sequence-parallel
scan's summaries and the conv halo.

``initialize_distributed`` starts the process group from torchrun's
environment; ``spawn`` starts N ranks from one process (gloo, a
``FileStore`` in a given directory: no TCP port to choose), which the tests
and ``chip_smoke.py`` use.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

AXES = ("data", "model", "expert", "seq")


def rank_and_world() -> tuple:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def normalize_shape(shape: Optional[Sequence[int]], world: int = 1) -> tuple:
    """``shape`` as a 4-tuple over :data:`AXES`: None is every rank on
    ``data``, a 3-tuple gets a trailing ``seq = 1`` (as the JAX mesh)."""
    if shape is None:
        return (world, 1, 1, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) == 3:
        shape = shape + (1,)
    if len(shape) != 4 or min(shape) < 1:
        raise ValueError(f"mesh shape must have 3 or 4 positive axes, got {shape}")
    return shape


class Mesh:
    """This rank's place on the mesh: ``shape`` (axis -> size, as
    ``jax.sharding.Mesh.shape``), its ``index`` on each axis and the process
    group of its line along each axis longer than one."""

    def __init__(self, shape: Sequence[int], rank: int, groups: Dict[str, Any]):
        self.shape = dict(zip(AXES, shape))
        self.rank = rank
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, tuple(shape)))))
        self._groups = groups

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if self.shape[axis] == 1:
            raise ValueError(f"mesh axis {axis!r} has one rank: it has no group")
        return self._groups[axis]


def create_mesh(shape: Optional[Sequence[int]] = None) -> Mesh:
    """Build the mesh over the process group's ranks (one rank without a
    process group). The default puts every rank on ``data``; ``shape`` must
    multiply to the number of ranks (``ValueError`` otherwise, as
    ``mesh.py:50-51``). Every rank must call it, with the same shape: the
    groups are created collectively, in one order."""
    rank, world = rank_and_world()
    shape = normalize_shape(shape, world)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} ranks")
    grid = np.arange(world).reshape(shape)
    groups = {}
    for i, axis in enumerate(AXES):
        if shape[i] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]).tolist():
            group = dist.new_group(line)
            if rank in line:
                groups[axis] = group
    return Mesh(shape, rank, groups)


def initialize_distributed() -> Optional[str]:
    """Start the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``), the counterpart of ``mesh.py:60``. Each rank goes on
    ``cuda:{LOCAL_RANK % device_count}``; the backend is NCCL when every
    local rank has a card of its own and gloo otherwise (NCCL does not put
    two ranks on one card). Returns the backend, logged; None, doing
    nothing, for a single process. A process group that is already up is
    kept."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = "gloo"
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % count)
        if local_world <= count:
            backend = "nccl"
    logger.info("rank %d of %d: process group over %s", rank, world, backend)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return backend


def _rank_main(rank: int, fn: Callable, world: int, store: str, workdir: str,
               timeout: float) -> None:
    torch.set_num_threads(1)
    with open(Path(workdir) / "args.pkl", "rb") as f:
        args = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.save(fn(rank, *args), Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, workdir, args: tuple = (),
          timeout: float = 300.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` processes started with
    ``torch.multiprocessing`` (``spawn``), each a rank of a gloo process
    group over a ``FileStore`` in ``workdir``, on ``cuda:{rank %
    device_count}`` where there is a card (ranks share it), with one CPU
    thread. ``fn`` and ``args`` must pickle (``args`` go through a file in
    ``workdir``); ``fn`` is imported by name in each child. Returns each rank's return value, in rank order. A rank that
    raises or dies raises here and the others are stopped; so are all of
    them after ``timeout`` seconds (also the process group's timeout for
    one collective)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = str(workdir / f"store-{uuid.uuid4().hex}")
    # The arguments go through a file: passed to the processes themselves,
    # a large one would hold each start until the child before had read it.
    with open(workdir / "args.pkl", "wb") as f:
        pickle.dump(tuple(args), f)
    ctx = torch.multiprocessing.spawn(
        _rank_main, args=(fn, world, store, str(workdir), timeout), nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn: {world} ranks did not finish in {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=30)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]
