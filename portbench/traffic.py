"""The one generator of the benchmark's traffic.

A traffic mix is a JSON file of parameters under ``portbench/traffic/``:
the entry it drives (``"step"``: the in-graph MLfabric step; ``"async"``:
MLfabric-A), the sequence length and the rows of a batch (a step's global
batch, or one worker's update), and the entry's settings (learning rate,
momentum, the wire, the trainer's workers and staleness bound, the
control plane's schedule seed).

A batch is drawn on the device from a generator seeded by the run's seed
and the batch's key (a step index, or a worker's update index): one
``randint`` of ``[rows, seq_len + 1]`` token ids in ``[0, vocab_size)``,
the tokens its first ``seq_len`` columns and the labels its last.  Every
seed gives every run the same sizes; rows differ from batch to batch and
from seed to seed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def batch_seed(seed: int, key: Tuple[int, ...]) -> int:
    h = int(seed) % (2 ** 62)
    for k in key:
        h = (h * 6_364_136_223_846_793_005 + 1_442_695_040_888_963_407
             + int(k)) % (2 ** 63)
    return h


def make_batch(traffic: Dict, vocab_size: int, seed: int,
               key: Tuple[int, ...], device, rows: int = None
               ) -> Dict[str, torch.Tensor]:
    rows = traffic["rows"] if rows is None else rows
    gen = torch.Generator(device=device).manual_seed(batch_seed(seed, key))
    x = torch.randint(0, vocab_size, (rows, traffic["seq_len"] + 1),
                      generator=gen, device=device, dtype=torch.int64)
    return {"tokens": x[:, :-1], "labels": x[:, 1:]}


def tokens_per_batch(traffic: Dict) -> int:
    return traffic["rows"] * traffic["seq_len"]
