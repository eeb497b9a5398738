r"""Parameter trees of the learnable systems (PyTorch).

The JAX package passes every system's parameters as a pytree. The port's
experiment layer needs three things of them: the leaf tensors in a fixed
order (the optimizer's list, a checkpoint), the same structure with a
function applied to every leaf (a snapshot, a cast to the loss dtype), and
the structure rebuilt from stored leaves (resume).
:class:`~dair_pll_tpu_torch.multibody.model.MultibodyParams` has the first
two; :class:`ParamTree` gives them to nested dictionaries and lists of
tensors, such as the deep and the residual systems' parameters, which may
hold a ``MultibodyParams`` as a node. :func:`tree_from_leaves` rebuilds
either from leaves, :func:`tree_from_numpy` from a JAX pytree's numpy
arrays.

Leaves come in the order of JAX's ``tree_leaves``: dictionary keys sorted,
lists in order, a ``MultibodyParams`` as its ``parameters()``. So a leaf
list compares one to one with the JAX package's, and the JAX package's
flattened parameters load into the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor


def tree_leaves(tree) -> List[Tensor]:
    """The tensors of nested dictionaries, lists and tuples (``None``
    skipped), dictionary keys sorted, as ``jax.tree_util.tree_leaves``
    orders them; a parameter object (one with ``parameters()``, such as
    ``MultibodyParams``) gives its ``parameters()``."""
    if tree is None:
        return []
    if hasattr(tree, "parameters"):
        return tree.parameters()
    if isinstance(tree, Mapping):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on the tensors of nested dictionaries, lists and tuples
    (``None`` kept); a parameter object maps itself (its ``map``)."""
    if tree is None:
        return None
    if hasattr(tree, "parameters"):
        return tree.map(fn)
    if isinstance(tree, Mapping):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, item) for item in tree)
    return fn(tree)


class ParamTree(dict):
    """A dictionary of parameter subtrees (dictionaries, lists, tensors or a
    ``MultibodyParams``) with the parameter protocol of the experiment
    layer: :meth:`parameters` and :meth:`map`."""

    def parameters(self) -> List[Tensor]:
        """The leaf tensors, dictionary keys sorted (JAX's order)."""
        return [leaf for key in sorted(self)
                for leaf in tree_leaves(self[key])]

    def map(self, fn) -> "ParamTree":
        """The tree with ``fn`` applied to every leaf tensor."""
        return ParamTree({key: tree_map(fn, value)
                          for key, value in self.items()})


def _as_leaf(value, like: Tensor, where: str) -> Tensor:
    # A float64 copy first: stored leaves may be read-only numpy views.
    if isinstance(value, Tensor):
        value = value.detach().cpu().numpy()
    tensor = torch.as_tensor(np.array(value, dtype=np.float64),
                             device=like.device).to(like.dtype)
    if tensor.shape != like.shape:
        raise ValueError(f"{where} has shape {tuple(tensor.shape)}, "
                         f"expected {tuple(like.shape)}")
    return tensor


def _fill(template: Any, leaves: Iterator, where: str) -> Any:
    if template is None:
        return None
    if dataclasses.is_dataclass(template):
        # A parameter dataclass (``MultibodyParams``): its fields in
        # declaration order, the order of its ``parameters()``.
        return type(template)(**{
            field.name: _fill(getattr(template, field.name), leaves,
                              f"{where}.{field.name}")
            for field in dataclasses.fields(template)})
    if isinstance(template, Mapping):
        filled = {key: _fill(template[key], leaves, f"{where}.{key}")
                  for key in sorted(template)}
        return ParamTree(filled) if isinstance(template, ParamTree) \
            else filled
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(item, leaves, f"{where}[{i}]")
                              for i, item in enumerate(template))
    value = next(leaves, None)
    if value is None:
        raise ValueError(f"too few leaves: none left for {where}")
    return _as_leaf(value, template, where)


def tree_from_leaves(template: Any, leaves: Sequence) -> Any:
    """The inverse of ``tree_leaves``: arrays (a checkpoint's numpy
    leaves, or a JAX run's flattened parameters) in the structure, dtype
    and device of ``template``; every shape is checked."""
    iterator = iter(list(leaves))
    tree = _fill(template, iterator, "params")
    if next(iterator, None) is not None:
        raise ValueError(f"{len(leaves)} leaves; the parameters have "
                         f"{len(tree_leaves(template))}")
    return tree


def tree_from_numpy(template: Any, given: Any, where: str = "params") -> Any:
    """A nested numpy tree (a JAX pytree's dictionaries and lists, as
    numpy arrays) in the structure, dtype and device of ``template``; keys,
    list lengths and shapes are checked."""
    if template is None:
        if given is not None and not (isinstance(given, Mapping) and
                                      not given):
            raise ValueError(f"{where} takes no parameters")
        return None
    if isinstance(template, Mapping):
        if not isinstance(given, Mapping) or set(given) != set(template):
            raise ValueError(f"{where} needs keys {sorted(template)}")
        filled = {key: tree_from_numpy(template[key], given[key],
                                       f"{where}.{key}")
                  for key in sorted(template)}
        return ParamTree(filled) if isinstance(template, ParamTree) \
            else filled
    if isinstance(template, (list, tuple)):
        if not isinstance(given, (list, tuple)) or \
                len(given) != len(template):
            raise ValueError(f"{where} needs a list of {len(template)}")
        return type(template)(tree_from_numpy(t, g, f"{where}[{i}]")
                              for i, (t, g) in enumerate(zip(template,
                                                             given)))
    return _as_leaf(given, template, where)


def dtype_device(params: Any, default_dtype=torch.float32
                 ) -> Tuple[torch.dtype, Optional[torch.device]]:
    """The dtype and device of a parameter tree's first leaf;
    ``(default_dtype, None)`` when it has none (a host simulator's
    ``None``)."""
    leaves = tree_leaves(params)
    if not leaves:
        return default_dtype, None
    return leaves[0].dtype, leaves[0].device
