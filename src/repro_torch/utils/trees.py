"""Helpers over the port's parameter trees (the counterpart of
``repro.utils.trees``): nested dicts of tensors, walked in ``repro``'s
order (``jax.tree`` flattens a dict by sorted keys), with ``repro``'s
``/``-joined path names."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``/``-joined path, leaf) of every leaf, in ``repro``'s order (dict
    keys sorted, as ``jax.tree`` flattens them)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``repro``'s order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_count(tree) -> int:
    """Total number of scalar elements of a tree of tensors (or of anything
    with a ``shape``)."""
    total = 0
    for leaf in tree_leaves(tree):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        total += n
    return total


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors."""
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree))


def tree_global_norm(tree) -> torch.Tensor:
    """Global L2 norm across every leaf, computed in f32 (a 0-d f32 tensor on
    the leaves' device)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)
    return torch.sqrt(sq)


def tree_paths(tree) -> List[str]:
    """The ``/``-joined path names of every leaf, in tree order."""
    return [name for name, _ in tree_items(tree)]
