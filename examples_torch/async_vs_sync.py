"""The paper's headline experiment at laptop scale (Figs. 7a-b, Table 2),
in the PyTorch port.

Trains the same model under: MLfabric-A (delay-bounded async, aggregated),
vanilla Async (fair-shared network, unbounded delay), and RR-Sync
(ring-AllReduce synchronous) — across straggler settings, comparing
time-to-loss.  Real PyTorch gradients on the card; network/compute timing
from the discrete-event simulator.

    PYTHONPATH=src python examples_torch/async_vs_sync.py [--quick] \
        [--device cpu]

``--device`` defaults to ``cuda`` and raises on a host without a card.
Each worker's batches are seeded by its index (``hash()`` is salted per
process), and the params are drawn by ``torch``: the losses are not the
JAX example's, the schedule is.
"""

import argparse
import sys
sys.path.insert(0, "src")

import torch

from repro_torch.core import C1, C2, N_STATIC, mb
from repro_torch.core.baselines import SyncSim
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.ps import AsyncTrainer


def make_problem(device, seq=32, batch=4):
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, device=device)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, seed=0)

    def to_dev(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def data_fn(worker, t):
        return to_dev(src.batch(int(worker.removeprefix("worker")) * 997
                                + t, batch))

    eval_batch = to_dev(src.batch(99999, 8))

    def eval_fn(params):
        with torch.no_grad():
            return model.loss_fn(params, eval_batch)[0]

    params = model.init(torch.Generator(device=device).manual_seed(0))
    return params, model.loss_fn, data_fn, eval_fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--commits", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)
    commits = args.commits or (60 if args.quick else 200)

    settings = [("C1 (10%/2x stragglers)", C1), ("C2 (10%/4x)", C2)]
    print(f"{'setting':26s} {'variant':16s} {'commits':>7s} {'time(s)':>8s} "
          f"{'loss':>7s} {'max delay':>9s} {'drops':>6s}")
    for name, straggler in settings:
        for variant, tau in (("MLfabric-A-30", 30), ("Async (vanilla)", None)):
            params, loss_fn, data_fn, eval_fn = make_problem(device)
            tr = AsyncTrainer(params, loss_fn, data_fn, n_workers=8,
                              tau_max=tau, base_lr=0.4, gamma=0.0,
                              delay_adaptive=(tau is not None),
                              update_size=mb(20), compute_time=0.05,
                              straggler=straggler,
                              bandwidth=N_STATIC, aggregators=2 if tau else 0,
                              eval_fn=eval_fn, has_aux=True, seed=1,
                              device=device)
            res = tr.run(until_commits=commits)
            print(f"{name:26s} {variant:16s} {res.commits:7d} "
                  f"{res.sim_time:8.1f} {res.final_loss:7.3f} "
                  f"{res.delay_stats['max']:9.0f} {res.drops:6d}")
        # RR-Sync timing (same workload, same per-iteration grad quality
        # as one aggregated batch): report the wall-clock for the same
        # number of model updates / n_workers iterations.
        sync = SyncSim(8, update_size=mb(20), compute_time=0.05,
                       straggler=straggler, seed=1).run(commits // 8)
        print(f"{name:26s} {'RR-Sync (model)':16s} {commits:7d} "
              f"{sync.total_time:8.1f} {'—':>7s} {'0':>9s} {'0':>6s}")


if __name__ == "__main__":
    main()
