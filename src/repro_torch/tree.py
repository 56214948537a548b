"""Parameter trees in the reference's leaf order.

The port keeps parameters as nested dicts of tensors, the same tree the
JAX package builds.  ``jax.tree_util`` flattens a dict in sorted-key order
(``torch.utils._pytree`` keeps insertion order instead), and the flat wire
layout, its per-leaf padding and every bucket plan depend on that order, so
every flatten in the port goes through this module.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any
TreeDef = Any  # nested dicts of None, or None for a leaf


def tree_flatten(tree: Tree) -> Tuple[List[Any], TreeDef]:
    """Leaves in sorted-key order, and the structure to rebuild the tree."""
    if isinstance(tree, dict):
        leaves: List[Any] = []
        treedef = {}
        for k in sorted(tree):
            sub, sub_def = tree_flatten(tree[k])
            leaves.extend(sub)
            treedef[k] = sub_def
        return leaves, treedef
    return [tree], None


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Tree:
    it = iter(leaves)

    def build(d):
        if isinstance(d, dict):
            return {k: build(d[k]) for k in sorted(d)}
        return next(it)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])

