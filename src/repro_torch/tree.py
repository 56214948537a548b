"""Parameter and optimizer-state trees in the reference's leaf order.

The port keeps parameters as nested dicts of tensors, the same tree the
JAX package builds, and optimizer states as the same NamedTuples
(``MomentumState``, ``AdamWState``).  ``jax.tree_util`` walks

* a dict in sorted-key order (``torch.utils._pytree`` keeps insertion
  order instead),
* a NamedTuple field by field, in field order,
* a tuple or list entry by entry,
* ``None`` as an empty subtree (no leaf),

and treats everything else as a leaf.  The flat wire layout, its per-leaf
padding, every bucket plan and the checkpoint's leaf names depend on that
order, so every flatten in the port goes through this module.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

Tree = Any


class TreeDef(NamedTuple):
    """One node: ``kind`` is "leaf", "none", "dict", "namedtuple", "tuple"
    or "list"; ``meta`` the sorted keys of a dict or the NamedTuple's
    class; ``children`` the children's defs in flatten order."""
    kind: str
    meta: Any = None
    children: Tuple["TreeDef", ...] = ()


_LEAF = TreeDef("leaf")
_NONE = TreeDef("none")


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree: Tree) -> Optional[Tuple[str, Any, List[Tuple[str, Any]]]]:
    """(kind, meta, [(path entry, child), ...]) of a node, None for a leaf.
    The path entries are the names ``jax.tree_util``'s key paths print:
    a dict key as itself, a NamedTuple field as ``.field``, a sequence
    index as the number."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict", tuple(keys), [(str(k), tree[k]) for k in keys]
    if _is_namedtuple(tree):
        return "namedtuple", type(tree), [(f".{f}", getattr(tree, f))
                                         for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return kind, None, [(str(i), c) for i, c in enumerate(tree)]
    return None


def tree_flatten_with_path(tree: Tree
                           ) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """[(name, leaf)] in flatten order, and the structure to rebuild the
    tree.  A leaf's name joins its path entries with "/" exactly as the
    reference's checkpoint names them: ``layers/wq``, ``.history/embed``,
    ``.step``."""
    if tree is None:
        return [], _NONE
    node = _children(tree)
    if node is None:
        return [("", tree)], _LEAF
    kind, meta, kids = node
    out: List[Tuple[str, Any]] = []
    defs = []
    for entry, child in kids:
        sub, sub_def = tree_flatten_with_path(child)
        out.extend((f"{entry}/{n}" if n else entry, leaf) for n, leaf in sub)
        defs.append(sub_def)
    return out, TreeDef(kind, meta, tuple(defs))


def tree_flatten(tree: Tree) -> Tuple[List[Any], TreeDef]:
    """Leaves in the reference's order, and the structure to rebuild the
    tree."""
    named, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in named], treedef


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Tree:
    it = iter(leaves)
    sentinel = object()

    def build(d: TreeDef):
        if d.kind == "leaf":
            leaf = next(it, sentinel)
            if leaf is sentinel:
                raise ValueError("fewer leaves than the tree has slots")
            return leaf
        if d.kind == "none":
            return None
        kids = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.meta, kids))
        if d.kind == "namedtuple":
            return d.meta(*kids)
        return tuple(kids) if d.kind == "tuple" else kids

    out = build(treedef)
    if next(it, sentinel) is not sentinel:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map over trees of {len(leaves)} and "
                             f"{len(o)} leaves")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
