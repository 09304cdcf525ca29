"""Parameter trees: the (possibly nested) dicts of tensors that hold a
layer's parameters, gradients, updater state and layer state.

Most layers' trees are flat (`{"W", "b", "peep"}`); a
GravesBidirectionalLSTM's is nested (`{"fwd": {...}, "bwd": {...}}`), as
in the JAX package. Every walk over a tree goes through these helpers, in
the sorted-key-path order of JAX's `_flat_leaves` / `_unflatten_like`
(`params_flat`, `set_params_flat`, the gradient check, the zip).
`tree_map` and `flat_leaves` also take a whole model's tree: a
MultiLayerNetwork's tuple of layer trees (in order, as JAX's pytrees) or a
ComputationGraph's dict of vertex trees.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

__all__ = ["tree_map", "flat_leaves", "leaf_paths", "unflatten_like",
           "flatten_tree"]


def tree_map(f: Callable, tree, *rest):
    """`f` over the leaves of one or more trees of the same shape (dicts,
    tuples and lists recurse; anything else is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return f(tree, *rest)


def flat_leaves(tree) -> list:
    """The leaves of a tree in sorted-key-path order (tuples and lists in
    order)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in flat_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in flat_leaves(t)]
    return [tree]


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """[(path, leaf)] in sorted-key-path order, paths joined by "/" (a
    BiLSTM's `fwd/W`)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaf_paths(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def unflatten_like(tree, vec, pos: int, to_leaf: Callable):
    """A tree shaped like `tree` from `vec[pos:]`; `to_leaf(chunk, leaf)`
    makes one leaf from its flat chunk. Returns (new tree, new pos)."""
    if not isinstance(tree, dict):
        n = tree.numel()
        return to_leaf(vec[pos:pos + n], tree), pos + n
    out = {}
    for k in sorted(tree):
        out[k], pos = unflatten_like(tree[k], vec, pos, to_leaf)
    return out, pos


def flatten_tree(tree):
    """(leaves, rebuild): the leaves of a tree in `tree_map`'s order (None
    leaves included), and a function that rebuilds a tree of the same
    shape from a list of as many values. The rebuild keeps the tree's
    shape, not its leaves."""
    leaves = []
    skeleton = tree_map(leaves.append, tree)

    def rebuild(values):
        it = iter(values)
        return tree_map(lambda _: next(it), skeleton)

    return leaves, rebuild
