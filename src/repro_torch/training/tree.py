"""Nested containers of tensors (dicts, lists, tuples) handled as the JAX
package handles its pytrees: leaves in its order (dict keys sorted), and a
leaf's path as its ``"/"``-joined checkpoint key (dict keys, then list or
tuple indices), so ``(params, opt_state)`` keys ``0/w0``, ``1/m/w0``,
``1/count`` in both packages."""

from __future__ import annotations

from typing import Callable


def map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, in a container of its structure; ``path`` is the leaf's
    checkpoint key."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), prefix=f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, *(r[i] for r in rest), prefix=f"{prefix}{i}/")
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(prefix[:-1], tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a container of ``tree``'s structure."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def flatten_with_paths(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` in the JAX package's flattening order."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    flat: dict = {}
    for key, child in items:
        flat.update(flatten_with_paths(child, f"{prefix}{key}/"))
    return flat


def leaves(tree) -> list:
    """The leaves in the JAX package's flattening order."""
    return list(flatten_with_paths(tree).values())
