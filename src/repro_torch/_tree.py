"""Nested dicts and lists of tensors ("trees"), walked as JAX walks pytrees.

Dict keys are visited in sorted order and list or tuple items in order, so
a tree's leaves and their paths come out in the order
``jax.tree_util.tree_flatten_with_path`` gives the same structure; a
path is the keys joined by ``/`` (``"opt/m/stack/0/attn/wq"``), the form
the checkpoint manifests use.  ``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(tree: Any) -> Iterator[tuple[str, Any]] | None:
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ((str(i), x) for i, x in enumerate(tree))
    return None


def flatten_with_path(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in JAX's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out.extend(flatten_with_path(sub, f"{prefix}/{key}" if prefix else key))
    return out


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Any, new_leaves: list[Any]) -> Any:
    """``like``'s structure with ``new_leaves`` in its leaves' places."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (each of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
