#!/usr/bin/env python3
"""Per-rank param bytes of every config under the partition rules.

    python3 scripts/sharding_bytes.py

For each of the ten configs at published width, and for the two cuts the
four-card cell is sized from (one jamba-v0.1-52b group of 8 layers, one
deepseek-v2-236b layer), prints one JSON line with the bytes one rank
holds under ``dist.sharding.param_shardings`` on the meshes ``(16, 16)``,
``(2, 16, 16)``, ``(data=1, model=4)`` and ``(data=2, model=2)``, and the
whole tree's bytes, from ``models.api.params_specs`` (``meta`` tensors:
no storage, no card).  Leaves keep their config's dtypes (bf16, with f32
routers and recurrent states).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
CUTS = {"jamba-v0.1-52b": 8, "deepseek-v2-236b": 1}


def main() -> int:
    from repro_torch.configs import get_config, list_configs
    from repro_torch.dist import sharding as shd
    from repro_torch.models.api import params_specs

    rows = [(a, None) for a in list_configs()] + list(CUTS.items())
    for arch, layers in rows:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        abstract = params_specs(cfg)
        whole = shd.param_bytes_per_rank(
            cfg, shd.MeshShape(("data", "model"), {"data": 1, "model": 1}),
            abstract)
        per_rank = {name: shd.param_bytes_per_rank(
            cfg, shd.MeshShape(axes, dict(zip(axes, shape))), abstract)
            for name, (shape, axes) in MESHES.items()}
        print(json.dumps({"arch": arch, "layers": cfg.n_layers,
                          "bytes": whole, "per_rank_bytes": per_rank}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
