"""Nested-container helpers for state trees (the port's ``jax.tree_util``).

A state tree is made of dicts, NamedTuples, tuples and lists, with
tensors (or numpy arrays / Python scalars) at the leaves. Leaf names are
spelled exactly as ``jax.tree_util.keystr`` spells the matching JAX
pytree path — ``['params']['layers']['attn']['wq']``,
``['opt_state'][0].mu['tok_emb']`` — because those names are the keys of
the snapshot manifest both packages read. Dict children come in sorted
key order, as JAX flattens them.
"""

from __future__ import annotations

from typing import Any, Callable


def _children(node) -> list[tuple[str, Any]] | None:
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(keystr name, leaf), ...]`` in JAX's flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for key, child in kids:
        out.extend(flatten_with_names(child, prefix + key))
    return out


def map_with_names(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """Rebuild ``tree`` with every leaf replaced by ``fn(name, leaf)``,
    visiting leaves in :func:`flatten_with_names` order."""
    if isinstance(tree, dict):
        return {k: map_with_names(fn, tree[k], f"{prefix}[{k!r}]")
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_names(fn, getattr(tree, f),
                                           f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_names(fn, c, f"{prefix}[{i}]")
                          for i, c in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree):
    return map_with_names(lambda _name, leaf: fn(leaf), tree)
