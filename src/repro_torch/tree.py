"""Trees of the port: nested dicts and lists (or tuples) whose leaves are
tensors, arrays or numbers, as the port keeps parameters, optimizer states
and caches.  They are walked in JAX's pytree order (dict keys sorted,
sequences in order), so a sum over leaves runs in JAX's order and a leaf's
path key ("layers/0/wq") is what JAX's ``tree_flatten_with_path`` would
name it in a tree of the same shape."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path key, leaf)] in JAX's order; keys join dict keys and sequence
    indices with '/'."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), x) for i, x in enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += flatten_with_paths(sub, f"{prefix}/{key}" if prefix else key)
    return out


def path_tree(tree: Any, prefix: str = "") -> Any:
    """A tree of ``tree``'s structure whose leaves are their path keys."""
    if isinstance(tree, dict):
        return {k: path_tree(v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [path_tree(v, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return prefix


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """A tree of ``tree``'s shape with fn(leaf, *matching leaves of rest)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def unflatten(like: Any, values: List[Any]) -> Any:
    """A tree of ``like``'s structure from its leaves in ``leaves()``
    order (e.g. the gradients ``torch.autograd.grad`` returns for them)."""
    by_path = dict(zip((k for k, _ in flatten_with_paths(like)), values))
    return tree_map(lambda path: by_path[path], path_tree(like))
