from .checkpoint import (Checkpointer, BoundedDivergenceReplica,
                         save_pytree, load_pytree)

__all__ = ["Checkpointer", "BoundedDivergenceReplica", "save_pytree",
           "load_pytree"]
