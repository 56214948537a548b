"""Bounded-consistency replication (paper §7.3 / Fig. 9) at laptop scale,
in the PyTorch port.

Trains a small model while replicating through the bounded-divergence
replica; sweeps Div_max to reproduce the replication-savings curve, then
kills the primary and recovers from the replica.

    PYTHONPATH=src python examples_torch/bounded_replication.py \
        [--device cpu]

``--device`` defaults to ``cuda`` and raises on a host without a card.
The params are drawn by ``torch``, so the update norms the replica reads
(and with them its syncs) are not the JAX example's.
"""

import argparse
import sys
sys.path.insert(0, "src")

import torch

from repro_torch.checkpoint import BoundedDivergenceReplica
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.api import value_and_grad
from repro_torch.optim import momentum_sgd_init, momentum_sgd_update
from repro_torch.optim.sgd import update_norm
from repro_torch.tree import tree_leaves


def train_with_replica(div_max: float, device, steps: int = 40):
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, device=device)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt = momentum_sgd_init(params)
    replica = BoundedDivergenceReplica(div_max=div_max, gamma=0.9)

    def step_fn(params, opt, batch):
        (_, m), grads = value_and_grad(model.loss_fn, params, batch,
                                       has_aux=True)
        gn = update_norm(grads)
        p, o = momentum_sgd_update(params, grads, opt, lr=0.2, gamma=0.9)
        return p, o, m["loss"].detach(), gn

    loss = None
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in src.batch(step, 4).items()}
        params, opt, loss, gn = step_fn(params, opt, batch)
        replica.offer(step, params, float(gn) * 0.2)
    return replica, float(loss), params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args().device)
    print(f"{'Div_max':>8s} {'syncs':>6s} {'bytes saved':>12s}  "
          "(paper Fig. 9)")
    for div_max in (0.01, 0.5, 2.0, 8.0, 32.0):
        replica, loss, params = train_with_replica(div_max, device)
        print(f"{div_max:8.2f} {replica.syncs:6d} "
              f"{replica.replication_savings:11.1%}")

    # failure + recovery, through the §3.3 promotion helper for snapshot
    # replicas (the same path ElasticSession uses — DESIGN.md §9)
    from repro_torch.ps.replica import promote_replica
    replica, loss, params = train_with_replica(2.0, device)
    rec_params, rec_step, lost = promote_replica(replica)
    print(f"\nprimary failed at step 39; replica at step {rec_step}, "
          f"{lost} updates to regenerate (paper: 'fresh worker updates "
          f"using the latest model at the replica')")
    drift = sum(float(torch.sum(torch.abs(
        a.to(torch.float32) - torch.as_tensor(b).to(a.device, torch.float32))))
        for a, b in zip(tree_leaves(params), tree_leaves(rec_params)))
    print(f"L1 drift primary vs replica: {drift:.3f} (bounded by Div_max)")


if __name__ == "__main__":
    main()
