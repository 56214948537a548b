from .sgd import (MomentumState, momentum_sgd_init, momentum_sgd_update,
                  update_norm)

__all__ = ["MomentumState", "momentum_sgd_init", "momentum_sgd_update",
           "update_norm"]
