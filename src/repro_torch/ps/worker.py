"""Worker: computes gradient updates against a (stale) pulled model (eq. 1).

    u_t^j = -eta * dL(D_j, w_{t-tau})/dw   (+ regularization)

The delay-adaptive learning rate (AdaDelay, §3.1) is applied at the worker
when enabled; the update's norm is computed here and shipped with push()
(Table 1) for the scheduler's divergence bound.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..core.delay import adadelay_lr
from ..models.api import value_and_grad
from ..obs.trace import region
from ..optim.sgd import update_norm
from ..tree import tree_map

Params = Any


class Worker:
    def __init__(self, worker_id: str, loss_fn: Callable, *,
                 base_lr: float = 0.1, delay_adaptive: bool = False,
                 weight_decay: float = 0.0, has_aux: bool = False):
        self.worker_id = worker_id
        self.base_lr = base_lr
        self.delay_adaptive = delay_adaptive
        self.weight_decay = weight_decay
        self._loss_fn = loss_fn
        self._has_aux = has_aux

    def compute_update(self, params: Params, batch: Dict[str, Any], *,
                       version: int, t: int, observed_delay: int = 0,
                       ) -> Tuple[Params, float]:
        """Returns (update tree u = -eta*grad in f32, ||u||)."""
        with region("mlfabric.fwd_bwd"):
            _, grads = value_and_grad(self._loss_fn, params, batch,
                                      has_aux=self._has_aux)
        if self.delay_adaptive:
            eta = adadelay_lr(self.base_lr, max(t, 1), observed_delay)
        else:
            eta = self.base_lr
        with torch.no_grad():
            update = tree_map(
                lambda g, p: -eta * (g.to(torch.float32) + self.weight_decay
                                     * p.to(torch.float32)), grads, params)
        norm = update_norm(update)
        with region("mlfabric.sync", read="update_norm"):
            norm = float(norm)
        return update, norm
