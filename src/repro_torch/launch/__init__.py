"""Meshes over ``torch.distributed`` ranks, a launcher for a world of
local processes, and the training steps."""

from .local import init_rank, run_local_world
from .mesh import Mesh, make_host_mesh, make_mesh
from .steps import (StepBundle, build_mlfabric_train_step, build_step,
                    build_train_step)

__all__ = ["init_rank", "run_local_world", "Mesh", "make_host_mesh",
           "make_mesh", "StepBundle",
           "build_mlfabric_train_step", "build_step", "build_train_step"]
