"""End-to-end training driver: the PyTorch twin of
``repro/launch/train.py``.

Trains any ported arch (reduced or full config) on the synthetic LM
stream with the paper's optimizer (momentum SGD, eq. 2), checkpoint and
restart, and the bounded-divergence replica.  The step is plain autograd
plus eq. 2, as in the reference.  Runs on the card unless ``--device cpu``
is given, and raises on a host without a card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 200 --batch 8 --seq 128 --reduced --ckpt-dir runs/ckpt

The flags and the printed lines are the reference's.  As there, the
learning-rate schedules are built from ``--steps``: a run restarted from a
checkpoint replays the same learning rates only when it is given the same
``--steps``.  ``--reduced`` is ``store_true`` with ``default=True``;
``--full`` turns it off.  Where the last step is a ``--ckpt-every``
multiple, the reference saves that step twice (in the loop and after
it), the second time with the same state; this driver saves it once.
The initial params come from the port's seeded init (``torch.Generator``
seed 0), not from ``jax.random.key(0)``: a run that must start from the
reference's params restores a checkpoint the reference wrote (the
formats are one).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import torch

from ..checkpoint import BoundedDivergenceReplica, Checkpointer
from ..configs import get_config
from ..data import DataPipeline, SyntheticLM
from ..device import resolve_device
from ..models import build_model
from ..models.api import Model, value_and_grad
from ..optim import (constant_lr, cosine_schedule, momentum_sgd_init,
                     momentum_sgd_update, wsd_schedule)
from ..optim.sgd import update_norm
from ..tree import tree_leaves


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--gamma", type=float, default=0.9)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--div-max", type=float, default=0.0,
                    help=">0 enables the bounded-divergence replica")
    ap.add_argument("--schedule", choices=["wsd", "cosine", "const"],
                    default="cosine")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def make_step_fn(model: Model, gamma: float) -> Callable:
    """The CLI's step: ``step(params, opt, batch, lr) -> (params, opt,
    loss, ||grad||)``, autograd and one eq.-2 update (new tensors; the
    inputs are left as they are)."""
    def step(params, opt, batch, lr: float):
        (_, metrics), grads = value_and_grad(model.loss_fn, params, batch,
                                             has_aux=True)
        with torch.no_grad():
            gnorm = update_norm(grads)
        new_p, new_o = momentum_sgd_update(params, grads, opt, lr=lr,
                                           gamma=gamma)
        return new_p, new_o, metrics["loss"].detach(), gnorm
    return step


@dataclass
class TrainRun:
    """What one CLI run leaves behind, for callers driving it from code:
    the final params and momentum, the replica, the loss of every step
    run, and host seconds (each ending in a synchronization) per step,
    per checkpoint save and for the restore."""
    params: Any
    opt: Any
    replica: Optional[BoundedDivergenceReplica]
    start_step: int
    losses: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    save_seconds: List[float] = field(default_factory=list)
    restore_seconds: Optional[float] = None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(argv=None) -> TrainRun:
    """The CLI's body: parse ``argv``, train, print the reference's lines,
    and return the run."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=dev)

    if args.schedule == "wsd":  # MiniCPM's schedule
        lr_fn = wsd_schedule(args.lr, args.steps // 10, args.steps // 2,
                             args.steps // 3)
    elif args.schedule == "cosine":
        lr_fn = cosine_schedule(args.lr, args.steps // 10, args.steps)
    else:
        lr_fn = constant_lr(args.lr)

    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq, seed=0)
    pipe = DataPipeline(src, global_batch=args.batch)

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = momentum_sgd_init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} lr={args.lr}")

    start_step = 0
    restore_s = None
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and ck.latest_step() is not None:
        t0 = time.perf_counter()
        start_step, state, meta = ck.restore({"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        _sync(dev)
        restore_s = time.perf_counter() - t0
        pipe.load_state_dict(meta["data"])
        print(f"restored from step {start_step}")

    replica = (BoundedDivergenceReplica(div_max=args.div_max,
                                        gamma=args.gamma)
               if args.div_max > 0 else None)
    step_fn = make_step_fn(model, args.gamma)
    run = TrainRun(params=None, opt=None, replica=replica,
                   start_step=start_step, restore_seconds=restore_s)

    def save(step: int) -> None:
        t0 = time.perf_counter()
        ck.save(step, {"params": params, "opt": opt},
                metadata={"data": pipe.state_dict()})
        run.save_seconds.append(time.perf_counter() - t0)

    t0 = time.time()
    last_saved = None
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        np_batch = pipe.next_batch()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
        lr = lr_fn(step)
        params, opt, loss, gnorm = step_fn(params, opt, batch, float(lr))
        if replica is not None:
            replica.offer(step, params, float(gnorm) * float(lr))
        run.losses.append(float(loss))
        _sync(dev)
        run.step_seconds.append(time.perf_counter() - t_step)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(loss):.4f}  "
                  f"lr {float(lr):.2e}  |u| {float(gnorm):.3f}  "
                  f"({time.time()-t0:.1f}s)")
        if ck and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
            last_saved = step + 1
    if ck and last_saved != args.steps:
        save(args.steps)
    if replica is not None:
        print(f"replica syncs={replica.syncs} "
              f"savings={replica.replication_savings:.1%}")
    run.params, run.opt = params, opt
    return run


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
