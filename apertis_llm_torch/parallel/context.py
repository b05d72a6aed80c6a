"""The parallel context that routes the model's SSM mixer through the
sequence-parallel scan (``apertis_llm_tpu/parallel/context.py``).

The mesh and its axis names do not belong in the serialisable
``ApertisConfig``. The trainer enters :func:`parallel_context` around a
train or eval step; ``ApertisForCausalLM.forward`` reads :func:`current`
once, in the caller's thread, and hands the context to its layers as an
argument, so that a layer rematerialised during the backward (which autograd
runs in a thread of its own on the card) takes the same route.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import NamedTuple, Optional

from apertis_llm_torch.parallel.mesh import Mesh


class ParallelContext(NamedTuple):
    mesh: Optional[Mesh] = None
    sp_axis: Optional[str] = None     # sequence axis name (None = SP off)
    batch_axis: Optional[str] = None  # the batch axis (rows split over it)

    @property
    def active(self) -> bool:
        """Sequence parallelism on: the ``seq`` axis has more than one rank."""
        return (self.mesh is not None and self.sp_axis is not None
                and self.mesh.shape.get(self.sp_axis, 1) > 1)


_LOCAL = threading.local()


def current() -> ParallelContext:
    return getattr(_LOCAL, "ctx", None) or ParallelContext()


@contextmanager
def parallel_context(mesh: Mesh, sp_axis: Optional[str] = "seq",
                     batch_axis: Optional[str] = "data"):
    """Route the model calls made inside through ``mesh`` (in this thread)."""
    prev = getattr(_LOCAL, "ctx", None)
    _LOCAL.ctx = ParallelContext(mesh, sp_axis, batch_axis)
    try:
        yield _LOCAL.ctx
    finally:
        _LOCAL.ctx = prev
