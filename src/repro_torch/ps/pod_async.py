"""Pod-asynchronous training: the paper's delay-bounded async SGD at pod
granularity (the PyTorch twin of ``repro/ps/pod_async.py``).

Each *pod* (not worker) runs ``local_steps`` of SGD from its last pulled
global model, then pushes the accumulated delta ``w_local - w_pulled``
through the MLfabric scheduler — ordering, delay bounds (tau_max counts
*pod-level* model versions), aggregation and drops all apply unchanged.
The global server applies pod deltas with the paper's momentum rule
(eq. 2), which at this granularity doubles as the outer optimizer.

This is how MLfabric's core insight scales past a single pod: the slow
cross-pod links see only one (delay-bounded, optionally int8-compressed)
delta per pod per round instead of per-step gradient traffic.  With
``compress`` each delta goes through the flat int8 wire once: one
``quantize`` and one ``dequant_aggregate`` launch per pod delta on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..core.network import mb
from ..core.simulator import BandwidthModel, N_STATIC, StragglerModel, C1
from ..dist.flatbuf import flat_compress_roundtrip
from ..models.api import value_and_grad
from ..optim.sgd import update_norm
from ..tree import tree_map
from .async_trainer import AsyncTrainer

Params = Any


class PodAsyncTrainer(AsyncTrainer):
    """AsyncTrainer where each "worker" is a pod running local steps.

    ``compress`` routes every pod delta through the int8 block-quantization
    kernels — the update size on the wire drops ~4x, which the simulator's
    transfer times reflect.
    """

    def __init__(self, init_params: Params, loss_fn: Callable,
                 data_fn: Callable, *, n_pods: int = 4, local_steps: int = 4,
                 inner_lr: float = 0.2, tau_max: Optional[int] = 4,
                 gamma: float = 0.6, update_size: float = mb(100),
                 compute_time: float = 0.4,
                 straggler: StragglerModel = C1,
                 bandwidth: BandwidthModel = N_STATIC,
                 compress: bool = False, seed: int = 0,
                 scenario=None, replicate: bool = False, div_max: float = 2.0,
                 eval_fn: Optional[Callable] = None, has_aux: bool = False,
                 callbacks=(), hooks=None, device=None):
        self.local_steps = local_steps
        self.inner_lr = inner_lr
        self.compression_ratio = 4.0 if compress else 1.0
        self._has_aux = has_aux
        super().__init__(init_params, loss_fn, data_fn, n_workers=n_pods,
                         tau_max=tau_max, base_lr=inner_lr, gamma=gamma,
                         delay_adaptive=False,
                         update_size=update_size / self.compression_ratio,
                         compute_time=compute_time, straggler=straggler,
                         bandwidth=bandwidth, aggregators=0, seed=seed,
                         scenario=scenario, replicate=replicate,
                         div_max=div_max, eval_fn=eval_fn, has_aux=has_aux,
                         callbacks=callbacks, hooks=hooks, device=device)
        # after super().__init__: the pod round-trips its *delta* itself in
        # _on_compute, so base-class compress must stay off (the wire
        # already carries the compressed size via update_size above)
        self.compress = compress

    # a pod's "compute" = local_steps of SGD; the update is the delta
    def _on_compute(self, pod: str, version: int) -> Tuple[float, float]:
        params, v = self.server.pull()
        w = params
        for _ in range(self.local_steps):
            batch = self.data_fn(pod, self._t)
            self._t += 1
            _, g = value_and_grad(self._loss_fn, w, batch,
                                  has_aux=self._has_aux)
            with torch.no_grad():
                w = tree_map(lambda p, gg: (p.to(torch.float32)
                                            - self.inner_lr
                                            * gg.to(torch.float32)
                                            ).to(p.dtype), w, g)
        with torch.no_grad():
            delta = tree_map(lambda a, b: a.to(torch.float32)
                             - b.to(torch.float32), w, params)
        w = g = None        # free both before the wire's buffers exist
        if self.compress:
            # the flat-bucket wire: the whole delta packed into ONE flat
            # buffer, int8-quantized once, decoded by the fused
            # dequantize+norm pass, which also yields ||u||
            delta, norm = flat_compress_roundtrip(delta)
        else:
            norm = float(update_norm(delta))
        if pod in self._payloads:
            raise RuntimeError(f"{pod} already has an update in flight")
        self._payloads[pod] = (delta, v)
        return self.wire_size, norm
