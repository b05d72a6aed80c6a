"""Data and sequence parallelism over ``torch.distributed``
(``apertis_llm_tpu/parallel/``).

``mesh.py`` lays the process group's ranks out on the JAX package's four
named axes and starts ranks (``initialize_distributed`` under torchrun,
``spawn`` from one process); ``collectives.py`` holds the two collectives the
port uses, a differentiable all-gather and a bucketed all-reduce;
``context.py`` routes the model's SSM mixer through ``sequence.py``'s
chunk-composed scan while a mesh with a ``seq`` axis is active.
"""

from apertis_llm_torch.parallel.context import ParallelContext, current, parallel_context
from apertis_llm_torch.parallel.mesh import (
    AXES, Mesh, create_mesh, initialize_distributed, spawn)

__all__ = ["AXES", "Mesh", "ParallelContext", "create_mesh", "current",
           "initialize_distributed", "parallel_context", "spawn"]
