"""Checkpoint / restart + the paper's bounded-divergence replica (§3.3).

The PyTorch twin of ``repro/checkpoint/checkpoint.py``, two
fault-tolerance mechanisms, matching the paper's comparison (§7.3):

* ``Checkpointer`` — classic periodic full-state snapshots (the baseline
  the paper measures against): a flat npz of any tree + JSON metadata
  (step, data cursor).  Keeps N most recent.
* ``BoundedDivergenceReplica`` — the paper's alternative: a replica copy of
  the model trails the primary by at most ``Div_max`` in update-norm space.
  Updates are *offered* after every step with their norms (cheap); the
  replica only copies tensors when the divergence bound forces it (or spare
  time allows), so replication bytes shrink exactly like Fig. 9.  Recovery
  returns the replica model plus the count of lost updates (to be
  regenerated by workers).  Promotion goes through
  ``repro_torch.ps.replica.promote_replica``, the path ``ElasticSession``
  uses.

The files are the reference's, byte for byte in layout: one ``.npz`` per
state entry, each leaf named by its key path as ``jax.tree_util`` prints
it (``layers/wq``; a NamedTuple field as ``.history``; see ``tree.py``), so
a checkpoint written by either package restores in the other.  numpy has
no bfloat16, so bf16 is stored as f32 (exact both ways); a restore casts
each leaf back to the like-tree's dtype and places it on the like-tree
leaf's device.  A leaf on the card is widened to f32 there, before its
copy to the host.

The replica keeps its copy on the host, as the reference's
``np.asarray(x).copy()`` does: a replica on the same card as the primary
would not survive the card.  It copies only when it syncs.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.replication import divergence_bound
from ..tree import (tree_flatten_with_path, tree_leaves, tree_map,
                    tree_unflatten)


# --------------------------------------------------------------------------- #
# flat (de)serialization of trees
# --------------------------------------------------------------------------- #
def _host_array(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:   # npz has no bf16: store as f32
            t = t.to(torch.float32)
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten_with_names(tree: Any) -> List[Tuple[str, np.ndarray]]:
    named, _ = tree_flatten_with_path(tree)
    return [(name, _host_array(leaf)) for name, leaf in named]


def save_pytree(path: str, tree: Any) -> None:
    arrays = dict(_flatten_with_names(tree))
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def _restore_leaf(arr: np.ndarray, like: Any) -> Any:
    if torch.is_tensor(like):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            dtype=like.dtype).to(like.device)
    if hasattr(like, "dtype"):
        return arr.astype(like.dtype)
    return arr


def load_pytree(path: str, like: Any) -> Any:
    with np.load(path) as data:
        named, treedef = tree_flatten_with_path(like)
        leaves = [_restore_leaf(data[n], l) for n, l in named]
    return tree_unflatten(treedef, leaves)


# --------------------------------------------------------------------------- #
# periodic checkpointing
# --------------------------------------------------------------------------- #
class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None) -> str:
        d = self._step_dir(step)
        os.makedirs(d + ".tmp", exist_ok=True)
        for name, tree in state.items():
            save_pytree(os.path.join(d + ".tmp", f"{name}.npz"), tree)
        meta = {"step": step, "time": time.time(), **(metadata or {})}
        with open(os.path.join(d + ".tmp", "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(d + ".tmp", d)      # atomic publish
        self._gc()
        return d

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_state: Dict[str, Any],
                step: Optional[int] = None) -> Tuple[int, Dict[str, Any],
                                                     Dict[str, Any]]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        state = {name: load_pytree(os.path.join(d, f"{name}.npz"), like)
                 for name, like in like_state.items()}
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return step, state, meta


# --------------------------------------------------------------------------- #
# bounded-divergence replica (the paper's §3.3 as a checkpointing mode)
# --------------------------------------------------------------------------- #
def _nbytes(leaf: Any) -> int:
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def _host_copy(leaf: Any) -> Any:
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf).copy()


@dataclass
class BoundedDivergenceReplica:
    """Replica model trailing the primary by <= div_max (update-norm units).

    ``offer(step, params, update_norm)`` is called after every optimizer
    step with the norm of the applied update (cheap — no tensor copies).
    The replica copies tensors only when the accumulated divergence bound
    would exceed ``div_max`` (forced sync) or when ``opportunistic`` is set
    by the caller (spare-capacity sync, mirroring §5.3 scheduling).  The
    copy lands on the host, in the params' own dtypes.
    """

    div_max: float
    gamma: float = 0.9
    replica: Any = None
    replica_step: int = -1
    h_norm_ub: float = 0.0
    pending_norms: List[float] = field(default_factory=list)
    bytes_replicated: int = 0
    bytes_offered: int = 0
    syncs: int = 0

    def divergence(self) -> float:
        return divergence_bound(self.h_norm_ub, self.pending_norms, self.gamma)

    def _tree_bytes(self, tree: Any) -> int:
        return sum(_nbytes(l) for l in tree_leaves(tree))

    def offer(self, step: int, params: Any, update_norm: float, *,
              opportunistic: bool = False) -> bool:
        """Returns True if the replica synced at this step."""
        self.pending_norms.append(float(update_norm))
        self.bytes_offered += self._tree_bytes(params)
        next_div = self.divergence()
        if next_div > self.div_max or opportunistic or self.replica is None:
            self.replica = tree_map(_host_copy, params)
            self.replica_step = step
            for n in self.pending_norms:
                self.h_norm_ub = self.gamma * self.h_norm_ub + n
            self.pending_norms.clear()
            self.bytes_replicated += self._tree_bytes(params)
            self.syncs += 1
            return True
        return False

    def recover(self) -> Tuple[Any, int, int]:
        """(replica params on the host, replica step, number of lost
        updates)."""
        if self.replica is None:
            raise RuntimeError("no replica available")
        return self.replica, self.replica_step, len(self.pending_norms)

    @property
    def replication_savings(self) -> float:
        """Fraction of bytes NOT shipped vs per-step chain replication."""
        if self.bytes_offered == 0:
            return 0.0
        return 1.0 - self.bytes_replicated / self.bytes_offered
