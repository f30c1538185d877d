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
    return _rebuild(template, iter(leaves))


def _rebuild(node: Any, it) -> Any:
    # A module-level function, not a recursive closure: a closure that calls
    # itself sits in a reference cycle, which would keep the iterator, and
    # with it every leaf (views into a round's [N, P] tensor), alive until
    # the cycle collector ran.
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, it) for v in node)
    return next(it)


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


# Copy of padded_dim and make_sharded_flatteners from
# murmura_tpu/ops/flatten.py.
def padded_dim(dim: int, multiple: int) -> int:
    """``dim`` rounded up to a whole multiple of ``multiple``: the padded
    flat width of a param-sharded program, which lets the param axis split
    the flat vector into equal column blocks for any model size."""
    if multiple < 1:
        raise ValueError(f"pad multiple must be >= 1, got {multiple}")
    return -(-int(dim) // int(multiple)) * int(multiple)


def make_sharded_flatteners(
    template: Any, param_shards: int
) -> Tuple[Callable[..., torch.Tensor], Callable[[torch.Tensor], Any], int, int]:
    """(ravel, unravel, dim, flat_dim) with the flat vector zero-padded so
    ``param_shards`` divides its width.

    ``ravel`` emits rows whose last ``flat_dim - dim`` columns are exact
    zeros; ``unravel`` views the first ``dim`` columns, so local training
    never writes the pad.  Exact-zero padding is inert through every
    consumer: distances add (0-0)^2, means of zeros stay zero.  Where the
    shard count divides the dimension this is :func:`make_flatteners`
    exactly (flat_dim == dim)."""
    ravel0, unravel, dim = make_flatteners(template)
    flat_dim = padded_dim(dim, param_shards)
    if flat_dim == dim:
        return ravel0, unravel, dim, dim
    pad = flat_dim - dim

    def ravel(tree: Any, batch_dims: int = 0) -> torch.Tensor:
        return torch.nn.functional.pad(ravel0(tree, batch_dims), (0, pad))

    return ravel, unravel, dim, flat_dim


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
