"""The system under test, driven through its own entry points: the port's
``repro_torch`` package (never the JAX package ``repro``).

* ``"step"`` cells call the donated in-graph MLfabric step,
  ``build_step(cfg, shape, mesh, grad_path="mlfabric", compress_inter=...)
  .donating()``, on the ``(pod=1, data=1)`` mesh of ``make_host_mesh``.
* ``"async"`` cells run MLfabric-A, ``AsyncTrainer.run``, under its
  simulated control plane.

Each runner builds one object in set-up, drives it through the first
``FIRST`` updates (the first call builds the kernels: set-up), reads the
numbers the comparison needs from its state, and hands the same object to
the measured window.  ``Ranges`` puts ``torch.profiler`` ranges from this
file around the program's calls into each layer, by replacing the names
where the callers look them up, for the traced runs.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from . import traffic as tr
from .weights import leaf_specs, make_flat, make_leaf, nest

FIRST = 3                # updates the reference follows


def model_config(s: Dict, name: str):
    """The port's ``ModelConfig`` of the sizes ``s``."""
    from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
    m = s["moe"]
    moe = MoEConfig(n_experts=m["n_experts"], top_k=m["top_k"],
                    d_expert=m["d_expert"], n_shared=m["n_shared"],
                    capacity_factor=m["capacity_factor"], moe_layers="all")
    kw = dict(name=name, family="moe", n_layers=s["n_layers"],
              d_model=s["d_model"], n_heads=s["n_heads"],
              n_kv_heads=s["n_kv_heads"], vocab_size=s["vocab_size"],
              rope=True, rope_theta=s["rope_theta"], norm="rmsnorm",
              act="silu", tie_embeddings=s["tie"], moe=moe)
    kw.update(d_ff=s["d_ff"], d_head=s["d_head"])
    if s["kind"] == "mla":
        return ModelConfig(layer_pattern="l", mla=MLAConfig(**s["mla"]),
                           **kw)
    return ModelConfig(layer_pattern="a", **kw)


def check_program(cfg, s: Dict) -> None:
    """The program's own param tree (``params_specs``, no draws) holds the
    leaves the benchmark draws, shape and type, and its MoE groups and
    loss weight are the configuration's."""
    from repro_torch.models.api import params_specs
    from repro_torch.models import transformer
    from repro_torch.tree import tree_flatten_with_path
    want = {"/".join(sp.path): (sp.shape, sp.dtype) for sp in leaf_specs(s)}
    have = {n: (tuple(t.shape), t.dtype)
            for n, t in tree_flatten_with_path(params_specs(cfg))[0]}
    if want != have:
        raise RuntimeError(f"the program's param tree differs: {have} "
                           f"against the benchmark's {want}")
    if transformer.AUX_LOSS_COEF != s["aux_coef"]:
        raise RuntimeError("the program's aux-loss weight is "
                           f"{transformer.AUX_LOSS_COEF}, not "
                           f"{s['aux_coef']}")


def norms(leaves: List[torch.Tensor], scale: float = 1.0) -> List[float]:
    return [float(torch.linalg.vector_norm(t.float() if t.dtype !=
                                           torch.float32 else t)) * scale
            for t in leaves]


def change_norms(leaves: List[torch.Tensor], s: Dict, seed: int, device
                 ) -> List[float]:
    """Each leaf's distance from its draw from ``seed``, drawn again."""
    from .reference.train import distance
    out = []
    for i, (spec, t) in enumerate(zip(leaf_specs(s), leaves)):
        p0 = make_leaf(spec, i, seed, device)
        out.append(distance(t, p0))
        del p0
    return out


# --------------------------------------------------------------------------- #
# ranges (traced runs)
# --------------------------------------------------------------------------- #
class Ranges:
    """``torch.profiler.record_function`` ranges around the program's
    layers, installed by replacing module attributes and undone on
    ``restore``.  ``wire`` lists the bytes each wire kernel launch reads and
    writes, in launch order (the benchmark's own count: inputs read once,
    outputs written once)."""

    def __init__(self):
        self._undo = []
        self.wire: List[Dict] = []

    def wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)

        def ranged(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        ranged.launches = getattr(fn, "launches", 0)
        setattr(owner, attr, ranged)
        self._undo.append((owner, attr, fn))

    def wire_kernels(self) -> None:
        """Count the bytes of each ``quantize`` and ``dequant_aggregate``
        call where the program looks the wrappers up."""
        from repro_torch.dist import collectives
        from repro_torch.kernels import ops
        q_op, d_op = ops.quantize_op, ops.dequant_aggregate_op

        def quantize(x, **kw):
            n = x.shape[0] + (-x.shape[0]) % kw.get("block", 256)
            self.wire.append({"kernel": "quantize", "bytes":
                              4 * n + n + 4 * (n // 256)})
            return q_op(x, **kw)

        def dequant(q, scales, w, **kw):
            n, dp = q.shape
            out = kw.get("orig_len") or dp
            self.wire.append({"kernel": "dequant_aggregate", "bytes":
                              n * dp + 4 * scales.numel() + 4 * n + 4 * out
                              + 4})
            return d_op(q, scales, w, **kw)
        for mod in (ops, collectives):
            for attr, fn in (("quantize_op", quantize),
                             ("dequant_aggregate_op", dequant)):
                orig = getattr(mod, attr)
                fn.launches = 0
                setattr(mod, attr, fn)
                self._undo.append((mod, attr, orig))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


class RouteLog:
    """The routes the program's MoE layers take in set-up's first updates:
    each call of ``models/moe.py:router_topk`` (the top-k expert ids a
    token group's router chose, ``[G, T, k]``) under the update's key, the
    first ``n_layers`` of them (the forward; a rematerialised layer routes
    again in the backward).  Recording stops, and the program is left as
    it was, at ``stop``."""

    def __init__(self, n_layers: int):
        from repro_torch.models import moe
        self.n, self.by_key, self.key = n_layers, {}, None
        self._moe, self._orig = moe, moe.router_topk
        log = self

        def router_topk(probs, k):
            vals, idx = log._orig(probs, k)
            got = log.by_key.get(log.key)
            if got is not None and len(got) < log.n:
                got.append(idx.detach())
            return vals, idx
        moe.router_topk = router_topk

    def start(self, key) -> None:
        self.key = key
        self.by_key[key] = []

    def stop(self) -> None:
        self._moe.router_topk = self._orig
        self.key = None

    def routes(self, keys) -> List[List[torch.Tensor]]:
        return [self.by_key[k] for k in keys]


# --------------------------------------------------------------------------- #
# the in-graph step
# --------------------------------------------------------------------------- #
class StepRunner:
    """The donated MLfabric step of ``cfg`` at the traffic's shape."""

    def __init__(self, cfg, s: Dict, traffic: Dict, seed: int, device,
                 ranges: Optional[Ranges] = None, dtype=torch.bfloat16):
        from repro_torch.configs.shapes import ShapeConfig
        from repro_torch.launch import build_step, make_host_mesh, steps
        from repro_torch.optim import momentum_sgd_init
        self.s, self.t, self.seed, self.dev = s, traffic, seed, device
        self.vocab = s["vocab_size"]
        if ranges is not None:
            ranges.wrap(steps, "value_and_grad", "portbench.fwd_bwd")
            ranges.wrap(steps, "pack_leaves", "portbench.reduce")
            ranges.wrap(steps, "reduce_packed", "portbench.reduce")
            ranges.wrap(steps, "unpack_reduced", "portbench.reduce")
            ranges.wrap(steps, "momentum_sgd_update_", "portbench.update")
            ranges.wire_kernels()
        shape = ShapeConfig("portbench", traffic["seq_len"], traffic["rows"],
                            "train")
        self.mesh = make_host_mesh(device=device)
        flat = make_flat(s, seed, device)
        if dtype != torch.bfloat16:
            flat = {k: v.to(dtype) if v.dtype == torch.bfloat16 else v
                    for k, v in flat.items()}
        self.params = nest(flat)
        del flat
        self.opt = momentum_sgd_init(self.params)
        self.lr, self.gamma = traffic["lr"], traffic["gamma"]
        self.step = build_step(
            cfg, shape, self.mesh, grad_path="mlfabric",
            compress_inter=traffic["compress_inter"], lr=self.lr,
            gamma=self.gamma, remat=traffic["remat"],
            bucket_bytes=traffic["bucket_bytes"]).donating()
        self.k = 0
        self.losses: List[torch.Tensor] = []
        self.log = RouteLog(s["n_layers"])

    def batch(self, k: int) -> Dict[str, torch.Tensor]:
        with torch.profiler.record_function("portbench.data"):
            return tr.make_batch(self.t, self.vocab, self.seed, (k,),
                                 self.dev)

    def one(self) -> None:
        b = self.batch(self.k)
        with torch.profiler.record_function("portbench.step"):
            self.params, self.opt, m = self.step(self.params, self.opt, b)
        self.losses.append(m["loss"])
        self.k += 1

    def first(self) -> Dict:
        """The first updates, and what the comparison reads of them."""
        from repro_torch.tree import tree_leaves
        grad = None
        for i in range(FIRST):
            self.log.start(i)
            self.one()
            if i == 0:
                grad = norms(tree_leaves(self.opt.history), 1.0 / self.lr)
        self.log.stop()
        losses = [float(x) for x in self.losses[:FIRST]]
        change = change_norms(tree_leaves(self.params), self.s, self.seed,
                              self.dev)
        return {"losses": losses, "first_grad": grad, "change": change}

    def window(self, seconds: float, clock: Callable[[], float]) -> Dict:
        """Steps until ``seconds`` have passed on ``clock``; the window ends
        when the last step's work is done."""
        done, t0 = 0, clock()
        while clock() - t0 < seconds:
            self.one()
            done += 1
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = clock()
        bad = sum(int(~torch.isfinite(x)) for x in self.losses[FIRST:])
        return {"seconds": t1 - t0, "updates": done, "failed": bad,
                "attempted": done,
                "tokens": done * tr.tokens_per_batch(self.t)}

    def close(self) -> None:
        import torch.distributed as dist
        self.log.stop()
        del self.params, self.opt, self.step, self.losses
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_args(self) -> Dict:
        return {"batch_fn": lambda i: tr.make_batch(
                    self.t, self.vocab, self.seed, (i,), self.dev),
                "lr": self.lr, "gamma": self.gamma, "layout": "buckets",
                "versions": None, "routes": self.log.routes(range(FIRST))}


# --------------------------------------------------------------------------- #
# MLfabric-A
# --------------------------------------------------------------------------- #
class AsyncRunner:
    """MLfabric-A over ``cfg``: ``n_workers`` workers computing updates of
    the traffic's rows against the version they pulled, committed in the
    order the simulated control plane decides.  One ``run`` covers set-up's
    first commits and the window: a trainer cannot be run twice."""

    def __init__(self, cfg, s: Dict, traffic: Dict, seed: int, device,
                 ranges: Optional[Ranges] = None, dtype=torch.bfloat16):
        from repro_torch.core import N_STATIC
        from repro_torch.models import build_model
        from repro_torch.dist.flatbuf import padded_size
        from repro_torch.ps import AsyncTrainer, async_trainer, worker
        from repro_torch.tree import tree_leaves
        self.s, self.t, self.seed, self.dev = s, traffic, seed, device
        self.vocab = s["vocab_size"]
        if ranges is not None:
            ranges.wrap(worker, "value_and_grad", "portbench.fwd_bwd")
            ranges.wrap(async_trainer, "flat_compress_roundtrip",
                        "portbench.reduce")
            ranges.wire_kernels()
        model = build_model(cfg, dtype=dtype, device=device)
        flat = make_flat(s, seed, device)
        if dtype != torch.bfloat16:
            flat = {k: v.to(dtype) if v.dtype == torch.bfloat16 else v
                    for k, v in flat.items()}
        params = nest(flat)
        del flat
        self.flat_len = padded_size([p.numel() for p in tree_leaves(params)])
        self.computes: Dict[str, tuple] = {}
        self.commits: List[tuple] = []        # (batch key, version used)
        self.ce: Dict[tuple, torch.Tensor] = {}
        self.readings: Dict = {}
        self.host = {"callbacks_s": 0.0}
        self.window_state: Optional[Dict] = None
        self.computed_in_window = 0
        self.log = RouteLog(s["n_layers"])
        self.lr = traffic["lr"]
        runner = self

        def loss_fn(p, batch):
            out = model.loss_fn(p, batch, remat=traffic["remat"])
            runner.ce[runner._key] = out[1]["loss"].detach()
            return out

        def data_fn(worker_id, t):
            w = int(worker_id.removeprefix("worker"))
            runner._key = (w, t)
            runner.computes[worker_id] = (w, t)
            if runner.window_state is None:
                runner.log.start((w, t))
            with torch.profiler.record_function("portbench.data"):
                return tr.make_batch(traffic, runner.vocab, seed, (w, t),
                                     device)

        class Trainer(AsyncTrainer):
            def _on_compute(self, worker_id, version):
                t0 = time.perf_counter()
                w = runner.window_state
                if w is not None and "t1" not in w:
                    runner.computed_in_window += 1
                try:
                    return super()._on_compute(worker_id, version)
                finally:
                    runner.host["callbacks_s"] += time.perf_counter() - t0

            def _on_commit(self, rec):
                t0 = time.perf_counter()
                key = runner.computes[rec.worker]
                used = self._payloads[rec.worker][1]
                with torch.profiler.record_function("portbench.update"):
                    super()._on_commit(rec)
                runner.host["callbacks_s"] += time.perf_counter() - t0
                runner.on_commit(self, key, used)

        self.trainer = Trainer(
            params, loss_fn, data_fn, n_workers=traffic["n_workers"],
            tau_max=traffic["tau_max"], base_lr=self.lr,
            gamma=traffic["gamma"], delay_adaptive=False,
            update_size=4.0 * self.flat_len, bandwidth=N_STATIC,
            aggregators=traffic["aggregators"], has_aux=True,
            seed=traffic["schedule_seed"], compress=traffic["compress"],
            device=device)
        del params
        self.gamma = traffic["gamma"]

    # -- what set-up reads, and the window's clock ------------------------- #
    def on_commit(self, trainer, key, used) -> None:
        from repro_torch.tree import tree_leaves
        n = len(self.commits) + 1
        if n <= FIRST:
            self.commits.append((key, used, trainer.server.version))
        if n == 1:
            self.readings["first_grad"] = norms(
                tree_leaves(trainer.server.history), 1.0 / self.lr)
        if n == FIRST:
            self.readings["change"] = change_norms(
                tree_leaves(trainer.server.params), self.s, self.seed,
                self.dev)
            self.readings["losses"] = [float(self.ce[k]) for k, _, _ in
                                       self.commits]
            self.log.stop()
            self._sync()
            if self.on_window_start is not None:
                self.on_window_start()
            self.window_state = {"t0": self.clock(), "commits": 0,
                                 "callbacks0": self.host["callbacks_s"],
                                 "drops0": trainer.sim.scheduler.n_dropped}
            return
        w = self.window_state
        if w is None or "t1" in w:
            return
        w["commits"] += 1
        if self.clock() - w["t0"] >= self.seconds:
            self._sync()
            w["t1"] = self.clock()
            w["callbacks1"] = self.host["callbacks_s"]
            w["drops1"] = trainer.sim.scheduler.n_dropped
            trainer.sim._events.clear()       # ends ClusterSim.run's loop

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def run(self, seconds: float, clock: Callable[[], float],
            on_window_start: Callable[[], None] = None) -> None:
        """Set-up's first commits, then the window, in one ``run``."""
        self.seconds, self.clock = seconds, clock
        self.on_window_start = on_window_start
        self.trainer.run(until_commits=10 ** 9)
        if self.window_state is None or "t1" not in self.window_state:
            raise RuntimeError("the control plane stopped before the window "
                               "ended")

    def first(self) -> Dict:
        r = self.readings
        return {"losses": r["losses"], "first_grad": r["first_grad"],
                "change": r["change"]}

    def window(self) -> Dict:
        w = self.window_state
        secs = w["t1"] - w["t0"]
        drops = w["drops1"] - w["drops0"]
        return {"seconds": secs, "updates": w["commits"],
                "attempted": w["commits"] + drops, "failed": drops,
                "tokens": w["commits"] * tr.tokens_per_batch(self.t),
                "control_plane_s": secs - (w["callbacks1"]
                                           - w["callbacks0"])}

    def schedule_ok(self) -> bool:
        """The control plane's first commits keep its bound: each update
        computed against a version at most ``tau_max`` behind the one it
        was committed to, and no version from the future."""
        return all(0 <= cur - used <= self.t["tau_max"] + 1
                   for _, used, cur in self.commits)

    def close(self) -> None:
        self.log.stop()
        del self.trainer, self.ce
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_args(self) -> Dict:
        keys = [k for k, _, _ in self.commits]
        return {"batch_fn": lambda i: tr.make_batch(
                    self.t, self.vocab, self.seed, keys[i], self.dev),
                "lr": self.lr, "gamma": self.gamma, "layout": "leaf_padded",
                "versions": [u for _, u, _ in self.commits],
                "routes": self.log.routes(keys)}
