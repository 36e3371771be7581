"""Nested-dict parameter trees: the port's counterpart of the ``jax.tree``
calls the training stack makes.  A tree is nested ``dict``s whose leaves
are tensors (or numpy arrays); key paths join with ``|`` as the
reference's checkpointer joins them."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

SEP = "|"


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of each leaf and of what ``rest`` holds at the same path (a
    leaf there, or a subtree: an int8 moment record), in ``tree``'s
    nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, the path's keys joined with ``|``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, prefix + (str(k),))
    else:
        yield SEP.join(prefix), tree


def tree_leaves(tree: Any) -> List[Any]:
    """Every leaf, in the tree's order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s nesting over ``leaves`` (in :func:`tree_leaves`'s
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
