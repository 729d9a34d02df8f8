"""Trees of tensors: the port's counterpart of ``jax.tree`` for the training
state.

A tree is nested dicts, lists, tuples and named tuples (``TrainStateT``,
``AdamWState``) whose leaves are tensors or ``None``. ``None`` is an empty
subtree, as in JAX: it is no leaf, and maps to ``None``. Paths are named as
``jax.tree_util.keystr`` names them (``.params['embed']``,
``.opt.mu['blocks'][3]['pos0']['attn']['wq']``); the port's ``blocks`` is a
list, so its paths carry the cycle's index where the reference's stacked
arrays have none.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def leaf_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, in the tree's order (dicts in
    insertion order); ``None`` subtrees yield nothing."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from leaf_paths(value, f"{prefix}[{key!r}]")
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from leaf_paths(getattr(tree, field), f"{prefix}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from leaf_paths(value, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaf_paths(tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  prefix: str = "") -> Any:
    """A tree of ``fn(path, leaf)`` with ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: map_with_path(fn, value, f"{prefix}[{key!r}]")
                for key, value in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, value, f"{prefix}[{i}]")
                          for i, value in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """A tree of ``fn(leaf)`` with ``tree``'s structure."""
    return map_with_path(lambda _, leaf: fn(leaf), tree)


def unflatten(tree: Any, values: List[Any]) -> Any:
    """``tree``'s structure with its leaves replaced, in order, by
    ``values``."""
    it = iter(values)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
