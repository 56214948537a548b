from .sgd import (MomentumState, momentum_sgd_init, momentum_sgd_update,
                  momentum_sgd_update_, update_norm)
from .adamw import AdamWState, adamw_init, adamw_update
from .schedule import (constant_lr, cosine_schedule, step_decay_schedule,
                       wsd_schedule)

__all__ = [
    "MomentumState", "momentum_sgd_init", "momentum_sgd_update",
    "momentum_sgd_update_", "update_norm",
    "AdamWState", "adamw_init", "adamw_update",
    "constant_lr", "cosine_schedule", "step_decay_schedule", "wsd_schedule",
]
