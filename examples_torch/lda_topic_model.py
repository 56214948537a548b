"""Distributed LDA via collapsed variational updates through MLfabric
(paper §7.1, Figs. 7c-d), in the PyTorch port.

Each worker holds a document shard and computes an update to the global
word-topic matrix from its shard on the card; updates flow through the
MLfabric scheduler (delay-bounded async) or synchronously.  Convergence
is measured by held-out log-likelihood, as in the paper.

    PYTHONPATH=src python examples_torch/lda_topic_model.py [--quick] \
        [--device cpu]

``--device`` defaults to ``cuda`` and raises on a host without a card.
"""

import argparse
import sys
sys.path.insert(0, "src")

import math

import numpy as np
import torch

from repro_torch.core import C1, N_STATIC, mb
from repro_torch.data import lda_corpus
from repro_torch.device import resolve_device
from repro_torch.ps import AsyncTrainer


def lda_problem(device, n_docs=64, vocab=200, topics=8, doc_len=80,
                n_workers=8):
    docs, _, _ = lda_corpus(n_docs, vocab, topics, doc_len, seed=0)
    shards = np.array_split(docs, n_workers)
    test = docs[: n_docs // 4].astype(np.float32)

    # model: log of the word-topic matrix (rows ~ topics), plus doc mixes
    # handled locally; workers compute a gradient of the ELBO-ish objective
    def loss_fn(params, batch):
        logphi = torch.log_softmax(params["logphi"], dim=-1)    # [K, V]
        counts = batch["counts"]                                 # [D, V]
        # marginal likelihood under uniform doc-topic mixing (simplified
        # collapsed objective; same comm/compute structure as PLDA)
        doc_ll = torch.logsumexp(
            counts @ logphi.T - math.log(logphi.shape[0]), dim=-1)
        return -torch.mean(doc_ll)

    shard_t = [torch.from_numpy(s.astype(np.float32)).to(device)
               for s in shards]

    def data_fn(worker, t):
        i = int(worker.replace("worker", ""))
        return {"counts": shard_t[i % len(shard_t)]}

    test_batch = {"counts": torch.from_numpy(test).to(device)}

    def eval_fn(params):
        with torch.no_grad():
            return -loss_fn(params, test_batch)  # held-out log-likelihood

    params = {"logphi": torch.zeros((topics, vocab), dtype=torch.float32,
                                    device=device)}
    return params, loss_fn, data_fn, eval_fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)
    commits = 80 if args.quick else 240

    print(f"{'variant':18s} {'commits':>7s} {'time(s)':>8s} "
          f"{'test loglik':>12s} {'max delay':>9s}")
    for variant, tau, aggs in (("MLfabric-A-30", 30, 2),
                               ("MLfabric-A-60", 60, 2),
                               ("Async vanilla", None, 0)):
        params, loss_fn, data_fn, eval_fn = lda_problem(device)
        tr = AsyncTrainer(params, loss_fn, data_fn, n_workers=8,
                          tau_max=tau, base_lr=5.0, gamma=0.0,
                          delay_adaptive=False, update_size=mb(50),
                          compute_time=0.18, straggler=C1,
                          bandwidth=N_STATIC, aggregators=aggs,
                          eval_fn=eval_fn, seed=2, device=device)
        res = tr.run(until_commits=commits)
        print(f"{variant:18s} {res.commits:7d} {res.sim_time:8.1f} "
              f"{res.final_loss:12.4f} {res.delay_stats['max']:9.0f}")


if __name__ == "__main__":
    main()
