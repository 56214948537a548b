"""Meshes over ``torch.distributed`` ranks, a launcher for a world of
local processes, the training and serving steps, and the serving driver
(``launch.serve``)."""

from .local import init_rank, run_local_world
from .mesh import (Mesh, batch_axes, make_host_mesh, make_mesh,
                   make_production_mesh)
from .steps import (StepBundle, build_decode_step, build_mlfabric_train_step,
                    build_prefill_step, build_step, build_train_step)

__all__ = ["init_rank", "run_local_world", "Mesh", "batch_axes",
           "make_host_mesh", "make_mesh", "make_production_mesh", "StepBundle",
           "build_decode_step", "build_mlfabric_train_step",
           "build_prefill_step", "build_step", "build_train_step"]
