"""Serving example: batched prefill + decode with the KV cache paths, in
the PyTorch port.

Runs a reduced model end-to-end on the card: prefill a batch of prompts,
then decode greedily — the same serve_step the decode_32k/long_500k
dry-run cells trace at production shapes.

    PYTHONPATH=src python examples_torch/serve_decode.py --arch rwkv6-1.6b \
        [--device cpu]

``--device`` defaults to ``cuda`` and raises on a host without a card.
The params are drawn by ``torch``, so the generated tokens are not the
JAX example's.
"""

import argparse
import sys
sys.path.insert(0, "src")

import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.new_tokens
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)

    cache = model.init_cache(args.batch, max_len)
    if cfg.encoder is not None:
        batch = {"tokens": torch.from_numpy(prompts).to(device),
                 "frontend_embeds": torch.from_numpy(
                     rng.normal(size=(args.batch, cfg.encoder.n_frames,
                                      cfg.d_model))).to(device,
                                                        torch.bfloat16)}
        _, pre_cache = model.prefill(params, batch)
        cache["cross_kv"] = pre_cache["cross_kv"]

    # teacher-forced prefill via decode steps (exercises the cache path),
    # then greedy generation
    t0 = time.time()
    tok = torch.from_numpy(prompts[:, :1]).to(device)
    out_tokens = [prompts[:, :1]]
    for pos in range(max_len - 1):
        logits, cache = model.decode_step(params, cache, tok, pos)
        if pos + 1 < args.prompt_len:
            tok = torch.from_numpy(prompts[:, pos + 1: pos + 2]).to(device)
        else:
            tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
        out_tokens.append(tok.cpu().numpy())
    dt = time.time() - t0

    gen = np.concatenate(out_tokens, axis=1)
    print(f"arch={cfg.name}  batch={args.batch}  "
          f"{max_len-1} steps in {dt:.1f}s "
          f"({(max_len-1)*args.batch/dt:.1f} tok/s on {device.type})")
    for b in range(args.batch):
        print(f"  seq{b}: prompt={gen[b,:args.prompt_len].tolist()} "
              f"-> generated={gen[b, args.prompt_len:].tolist()}")
    assert torch.isfinite(logits.to(torch.float32)).all()


if __name__ == "__main__":
    main()
