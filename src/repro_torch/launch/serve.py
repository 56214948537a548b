"""Serving driver: the reference's batched decode loop
(``repro/launch/serve.py``) over the port's models.

Requests are batched FIFO up to ``--batch``; each batch gets a fresh cache
of ``prompt_len + max_new`` positions and is decoded from the first prompt
token: the rest of the prompt is teacher-forced one step at a time, then
the argmax over the padded vocab is fed back until the cache is full.  As
in the reference, decoder-only models take no prefill here; an
encoder-decoder (whisper) prefills each batch once for the cross-attention
keys and values of its stub audio frames.  Runs on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --requests 4 --batch 2 --max-new 16

``--reduced`` is the reference's flag as it is: ``store_true`` with
``default=True``, so it cannot be turned off from the command line.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model
from ..models.api import Model
from ..models.layers import Params


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    output: List[int] = field(default_factory=list)


def serve(model: Model, params: Params, requests: Sequence[Request],
          batch: int, max_len: int, rng: Optional[np.random.Generator] = None
          ) -> Tuple[List[Request], int, float]:
    """Decode every request, ``batch`` at a time, to ``max_len`` positions;
    generated tokens land in each request's ``output``.  All prompts have
    one length.  An encoder-decoder model first prefills each batch's
    whole prompts beside ``(batch, n_frames, d_model)`` stub frames drawn
    as normals from ``rng`` (the generator that drew the prompts, so the
    two packages' ``main`` draw the same frames) and cast to bf16 whatever
    the model's dtype, as the reference does; the decode loop then reads
    the prefill's ``cross_kv``.  Returns (requests in the order served,
    decode steps, seconds on the host clock, ending in a
    synchronisation)."""
    cfg = model.config
    if cfg.encoder is not None and rng is None:
        raise ValueError(f"{cfg.name}: serving an encoder-decoder draws its "
                         "stub frames from `rng`")
    dev = model.device
    queue = list(requests)
    done: List[Request] = []
    steps = 0
    t0 = time.perf_counter()
    while queue:
        batch_reqs, queue = queue[:batch], queue[batch:]
        prompts = np.stack([r.prompt for r in batch_reqs])
        bsz, prompt_len = prompts.shape
        cache = model.init_cache(bsz, max_len)
        if cfg.encoder is not None:
            frames = rng.normal(size=(bsz, cfg.encoder.n_frames, cfg.d_model))
            _, pre = model.prefill(params, {
                "tokens": torch.from_numpy(prompts).to(dev),
                "frontend_embeds": torch.from_numpy(frames).to(
                    device=dev, dtype=torch.bfloat16)})
            cache["cross_kv"] = pre["cross_kv"]
            del pre
        tok = torch.from_numpy(prompts[:, :1]).to(dev)
        for pos in range(max_len - 1):
            logits, cache = model.decode_step(params, cache, tok, pos)
            steps += 1
            if pos + 1 < prompt_len:
                tok = torch.from_numpy(prompts[:, pos + 1: pos + 2]).to(dev)
            else:
                tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
                for i, t in enumerate(tok[:, 0].tolist()):
                    batch_reqs[i].output.append(t)
        done.extend(batch_reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return done, steps, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    rng = np.random.default_rng(0)
    queue = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len)
                     .astype(np.int32)) for i in range(args.requests)]
    done, steps, dt = serve(model, params, queue, args.batch,
                            args.prompt_len + args.max_new, rng)
    print(f"arch={cfg.name} served {len(done)} requests, "
          f"{steps} decode steps in {dt:.1f}s "
          f"({steps / dt:.1f} steps/s on {dev.type})")
    for r in done:
        print(f"  req{r.rid}: {r.prompt[:6].tolist()}... -> {r.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
