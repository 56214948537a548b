"""Elastic training sessions: device loss -> rebuild -> resume.

The PyTorch twin of ``repro/dist/elastic.py``.  The paper's recovery story
(§3.3, §7.3): training state is protected by the *bounded-divergence
replica* (``repro_torch.checkpoint``) instead of synchronous checkpoints;
on failure the session rebuilds its device grid over the surviving
devices, restores the replica model, and the (few) updates the replica
trails by are simply regenerated by workers.

The reference's grid is a ``jax.sharding.Mesh``; here it is a ``Grid``:
``devices``, a ``[data, model]`` array of devices, and ``shape``, a dict of
the same two names.  That is all the session and its step builders read: a
builder splits its batch over ``grid.shape["data"]`` and places work on
``grid.devices``.  A session lives in one process, so there is no process
group to rebuild.  The session hands the replica the live params; the
replica copies them to the host only when it syncs (the reference copies
every step to the host first).  Promotion copies the replica's host
params back to the device of the params they replace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import BoundedDivergenceReplica
from ..core.harness import HookBus, StepLoop, make_bus
from ..core.scenario import (Scenario, ScenarioEvent, ServerFail, WorkerJoin,
                             WorkerLeave)
from ..device import DeviceLike, resolve_device
from ..tree import tree_leaves, tree_map

State = Any


@dataclass(frozen=True)
class Grid:
    """A ``(data, model)`` grid of devices."""
    devices: np.ndarray              # [data, model], dtype object

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.devices.shape[0], "model": self.devices.shape[1]}


def surviving_mesh(devices: Sequence[Any], *, data: int = 1,
                   model: int = 1) -> Grid:
    """A ``(data, model)`` grid over whatever devices remain.

    The model axis is preserved (tensor-parallel groups must stay whole —
    a partial group holds unusable weight shards); the data axis absorbs
    the loss, shrinking to the largest size the surviving device count
    supports.
    """
    n = len(devices)
    if n == 0:
        raise ValueError("no surviving devices")
    model = max(1, model)
    if n < model:
        raise ValueError(f"{n} surviving devices cannot preserve "
                         f"model={model} tensor-parallel groups")
    data = max(1, min(data, n // model))
    devs = np.empty(data * model, dtype=object)
    devs[:] = list(devices[:data * model])
    return Grid(devs.reshape(data, model))


def _default_devices(device: DeviceLike) -> List[torch.device]:
    """Every visible card where ``device`` is None (the reference takes
    ``jax.devices()``), else ``[device]``."""
    dev = resolve_device(device)
    if device is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class ElasticSession:
    """Owns a step function bound to a device grid and rebuilds it on
    failure.

    ``step_fn_builder(grid)`` must return ``step(state, batch) ->
    (state, metrics)`` where ``metrics["update_norm"]`` is the norm of
    the applied update — that is what the replica's divergence accounting
    consumes (Table 1: norms ride along with every push).  ``devices``
    defaults to every visible card (raising on a host without one), or to
    ``[device]`` when ``device`` is given, e.g. ``[cpu]``.
    """

    def __init__(self, *, step_fn_builder: Callable[[Grid], Callable],
                 init_state: State, data_axis: int = 1, model_axis: int = 1,
                 replica: Optional[BoundedDivergenceReplica] = None,
                 devices: Optional[Sequence[Any]] = None,
                 callbacks: Sequence[Any] = (),
                 hooks: Optional[HookBus] = None,
                 device: DeviceLike = None):
        self.hooks = hooks if hooks is not None else make_bus(callbacks)
        self.builder = step_fn_builder
        self.replica = replica
        self.devices: List[Any] = list(devices if devices is not None
                                       else _default_devices(device))
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.state = init_state
        self._init_opt = init_state[1] if isinstance(init_state, tuple) \
            and len(init_state) == 2 else None
        self.rebuilds = 0
        self.step_idx = 0
        self._spare_devices: List[Any] = []
        self.mesh = surviving_mesh(self.devices, data=data_axis,
                                   model=model_axis)
        self.step_fn = step_fn_builder(self.mesh)
        # one loop for the session's lifetime: its step counter is the
        # harness-visible step index across every run_steps call
        self._loop = StepLoop(self._harness_step, bus=self.hooks, source=self)
        self._last_metrics: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ #
    def _params(self) -> Any:
        return self.state[0] if isinstance(self.state, tuple) else self.state

    def _harness_step(self, idx: int, batch: Any) -> Optional[Dict[str, Any]]:
        self.state, metrics = self.step_fn(self.state, batch)
        self._last_metrics = metrics
        self.step_idx += 1
        if self.replica is not None:
            norm = float(metrics.get("update_norm", 0.0)) \
                if isinstance(metrics, dict) else 0.0
            self.replica.offer(self.step_idx, self._params(), norm)
        return metrics if isinstance(metrics, dict) else None

    def run_steps(self, batches: Sequence[Any]) -> Optional[Dict[str, Any]]:
        self._last_metrics = None
        self._loop.run(batches, fire_run_hooks=False)
        return self._last_metrics

    # ------------------------------------------------------------------ #
    def fail(self, *, n_lost_devices: int = 0) -> Dict[str, Any]:
        """Simulate losing ``n_lost_devices``: shrink the grid, rebuild the
        step function, restore state from the replica.

        Returns an info dict (``restored_from``, ``lost_updates``, the
        surviving device count) for the caller's logging.
        """
        self.hooks.on_failover(self, float(self.step_idx),
                               {"lost_devices": n_lost_devices})
        keep = max(self.model_axis, len(self.devices) - n_lost_devices)
        self.devices = self.devices[:keep]
        self.mesh = surviving_mesh(self.devices, data=self.data_axis,
                                   model=self.model_axis)
        self.step_fn = self.builder(self.mesh)
        self.rebuilds += 1
        return self._promote_from_replica()

    def _promote_from_replica(self) -> Dict[str, Any]:
        """Shared §3.3 promotion path (``repro_torch.ps.replica.
        promote_replica`` — the same protocol the PS trainers use): the
        replica model becomes the primary state and its lead (the
        ``lost_updates``) is the caller's regenerate-list — fresh updates
        from the promoted model, never a replay."""
        from ..ps.replica import promote_replica   # lazy: avoid pkg cycle

        restored_from, lost = "live-state", 0
        if self.replica is not None and self.replica.replica is not None:
            params, replica_step, lost = promote_replica(self.replica)
            live = tree_leaves(self._params())
            dev = live[0].device if live and torch.is_tensor(live[0]) \
                else self.devices[0]
            params = tree_map(lambda x: torch.as_tensor(x).to(dev, copy=True),
                              params)
            self.state = (params, self._init_opt) \
                if isinstance(self.state, tuple) else params
            self.step_idx = replica_step
            restored_from = f"replica:step_{replica_step}"
        self.hooks.on_replica_promote(self, float(self.step_idx), lost)
        return {"restored_from": restored_from, "lost_updates": lost,
                "devices": len(self.devices),
                "mesh_shape": dict(self.mesh.shape)}

    # ------------------------------------------------------------------ #
    def apply_event(self, ev: ScenarioEvent, *,
                    devices_per_worker: int = 1) -> Optional[Dict[str, Any]]:
        """Interpret one cluster event for a real-tensor session.

        ``WorkerLeave`` loses that worker's devices (grid rebuild + replica
        restore); ``ServerFail`` loses the primary's live state but no
        devices — the replica is promoted in place on the unchanged grid;
        other event kinds are control-plane-only and ignored here
        (the simulator interprets them).  Returns the ``fail()`` info dict
        when a rebuild happened.
        """
        self.hooks.on_event(self, float(self.step_idx), ev)
        if isinstance(ev, WorkerLeave):
            return self.fail(n_lost_devices=devices_per_worker)
        if isinstance(ev, ServerFail):
            self.hooks.on_failover(self, float(self.step_idx),
                                   {"server": ev.server})
            return self._promote_from_replica()
        if isinstance(ev, WorkerJoin) and self._spare_devices:
            self.devices.append(self._spare_devices.pop(0))
            self.mesh = surviving_mesh(self.devices, data=self.data_axis,
                                       model=self.model_axis)
            self.step_fn = self.builder(self.mesh)
            self.rebuilds += 1
            return {"restored_from": "live-state", "lost_updates": 0,
                    "devices": len(self.devices),
                    "mesh_shape": dict(self.mesh.shape)}
        return None

    def run_scenario(self, scenario: Scenario, batches: Sequence[Any], *,
                     devices_per_worker: int = 1,
                     spare_devices: Optional[Sequence[Any]] = None,
                     ) -> List[Dict[str, Any]]:
        """Drive the session through a dynamic-cluster scenario.

        Event times are reinterpreted as *step indices* (the session's
        clock is its step counter): an event with ``time=k`` fires before
        the k-th batch of this call.  ``spare_devices`` (if given) back
        ``WorkerJoin`` events — real hardware cannot be conjured the way
        the simulator mints hosts.  Returns the info dicts of every grid
        rebuild, in order.
        """
        self._spare_devices = list(spare_devices or [])
        pending = sorted(scenario.events, key=lambda e: e.time)
        infos: List[Dict[str, Any]] = []
        self.hooks.on_run_start(self)
        for k, batch in enumerate(batches):
            while pending and pending[0].time <= k:
                info = self.apply_event(pending.pop(0),
                                        devices_per_worker=devices_per_worker)
                if info is not None:
                    infos.append(info)
            self.run_steps([batch])
        self.hooks.on_run_end(self, infos)
        return infos
