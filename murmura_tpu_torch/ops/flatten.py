"""Pytree <-> flat-vector utilities (the PyTorch counterpart of
murmura_tpu/ops/flatten.py).

The flat order is ``jax.flatten_util.ravel_pytree``'s: dict keys sorted,
lists in order, each leaf in C order.  For the CNN family that is
``convs`` before ``fcs`` and ``b`` before ``w`` inside each layer.  Krum's
distances and ``selected_index`` are comparable with the JAX package's only
because the two orders agree element for element.

The round program keeps the node-stacked flat ``[N, P]`` tensor as the one
copy of the parameters; :func:`unravel` hands out views into it.
"""

from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ravel_pytree order (dict keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping the dict/list structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(template: Any, leaves) -> Any:
    """The pytree of ``template``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    return rebuild(template)


def make_flatteners(
    template: Any,
) -> Tuple[Callable[[Any], torch.Tensor], Callable[[torch.Tensor], Any], int]:
    """(ravel, unravel, dim) for a single-node param pytree.

    Both work on node-stacked inputs too: ``ravel`` flattens every leaf's
    trailing dims after ``batch_dims`` leading ones, and ``unravel`` maps
    ``[..., P]`` to views of shape ``[..., *leaf_shape]``.
    """
    shapes = [tuple(l.shape) for l in tree_leaves(template)]
    sizes = [int(np.prod(s)) for s in shapes]
    dim = int(sum(sizes))

    def ravel(tree: Any, batch_dims: int = 0) -> torch.Tensor:
        leaves = tree_leaves(tree)
        lead = tuple(leaves[0].shape[:batch_dims])
        return torch.cat([l.reshape(lead + (-1,)) for l in leaves], dim=-1)

    def unravel(flat: torch.Tensor) -> Any:
        lead = tuple(flat.shape[:-1])
        views, off = [], 0
        for shape, size in zip(shapes, sizes):
            views.append(flat[..., off:off + size].view(lead + shape))
            off += size
        return tree_unflatten(template, views)

    return ravel, unravel, dim


def model_dimension(template: Any) -> int:
    """Total float parameter count."""
    return sum(int(np.prod(tuple(l.shape))) for l in tree_leaves(template))


def tree_to_torch(tree: Any, device="cpu", dtype=None) -> Any:
    """Weight carry-over: a pytree of numpy arrays (e.g. the JAX package's
    params after ``np.asarray``) -> the same pytree of tensors."""
    return tree_map(
        lambda a: torch.as_tensor(np.array(a), dtype=dtype).to(device), tree
    )


def tree_to_numpy(tree: Any) -> Any:
    """The reverse carry-over: tensors -> numpy arrays (float32 on the host)."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)
