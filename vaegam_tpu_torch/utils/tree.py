"""Nested-dict parameter trees: the port's stand-in for JAX pytrees."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple


def tree_items(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) pairs in sorted-key order, paths joined with '/'."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(tree_items(v, path + "/"))
        else:
            out.append((path, v))
    return out


def tree_leaves(tree) -> list:
    return [v for _, v in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest) -> Dict:
    """Apply fn leafwise over trees of the same structure."""
    return {
        k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)))
        for k, v in tree.items()
    }
