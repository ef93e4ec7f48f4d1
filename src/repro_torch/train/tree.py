"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, flattened
in the JAX package's order and named by its ``keystr`` paths.

A dict's children come in sorted key order, a NamedTuple's in field order,
a list's or tuple's by position; ``None`` is an empty subtree, and a
tuple type marked ``tree_leaf`` (``launch.mesh.P``, a PartitionSpec) is a
leaf.  A leaf's name is the concatenation of ``['key']``, ``.field`` and
``[i]`` along its path, so a train state's leaves are named
``"['opt'].mu['blocks'][0]['wq']"``, ``"['opt'].step"``,
``"['params']['item_emb']"`` as in a JAX checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(path part, child)] of an inner node, or None for a leaf."""
    if node is None:
        return []
    if getattr(node, "tree_leaf", False):
        return None
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _walk(node, prefix: str) -> Iterator[Tuple[str, Any]]:
    kids = _children(node)
    if kids is None:
        yield prefix, node
        return
    for part, child in kids:
        yield from _walk(child, prefix + part)


def named_leaves(tree) -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in the JAX package's flattening order."""
    return list(_walk(tree, ""))


def leaves(tree) -> list:
    return [leaf for _, leaf in _walk(tree, "")]


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in flattening
    order, by ``new_leaves``; dicts keep the template's key order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if getattr(node, "tree_leaf", False):
            return next(it)
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    own = leaves(tree)
    if any(len(o) != len(own) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*args) for args in zip(own, *others)])


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad`` for a loss of a tree of tensors: returns
    ``(loss, grads)``, the loss detached and the grads a tree of the params'
    structure (zeros for a leaf the loss does not use).  The params are not
    modified."""

    def wrapped(params, *args, **kwargs):
        own = leaves(params)
        req = [p.detach().requires_grad_(True) for p in own]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, req), *args, **kwargs)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(own, grads)]
        return loss.detach(), unflatten(params, grads)

    return wrapped
