"""O1 per-op casting — what consumes :mod:`apex_tpu_torch.amp.lists`.

Counterpart of ``apex_tpu/amp/o1.py``.  The reference implements O1 by
patching every function of ``apex/amp/lists/*`` on the torch namespace;
the port, as the JAX package, casts explicitly and patches nothing:

- :func:`cast_op` runs one op with its inputs cast by the op's class
  ("half" / "fp32" / "promote").
- :func:`o1_intercept` is a context manager that applies the same
  classification to whole module calls, keyed on the module's class:
  Dense/Conv/attention/MLP classes run in half, norms, softmaxes,
  losses and embeddings in fp32.  It installs torch's global module
  forward hooks (``register_module_forward_pre_hook`` and
  ``register_module_forward_hook``) and removes them on exit.  The
  pre-hook casts the call's positional floating tensors to the target
  dtype; a module whose ``dtype`` is ``None`` (it promotes with its
  inputs, as flax's ``dtype=None``) computes in the target dtype for
  that call — the JAX interceptor's clone with ``dtype=target`` — and
  gets ``None`` back when the call returns.

A module's class is the one the JAX interceptor gives its flax
counterpart: :data:`FLAX_COUNTERPARTS` names the counterpart of each
port class whose name differs from it, and every other class is
classified by its own name.  Keyword arguments are not cast (torch's
global pre-hooks do not see them); the port's modules take by keyword
only masks, RoPE tables, seeds and decode state.  A module method other
than ``forward`` that the JAX interceptor would cast reads its dtype
with :func:`module_dtype` (``VocabParallelEmbedding.attend``).
Recomputed regions (``torch.utils.checkpoint``) rerun under the intercept
that was active when they first ran: pass :func:`checkpoint_context_fn`
as their ``context_fn``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.nn.modules import module as _module

from apex_tpu_torch.amp.lists import classify_op
from apex_tpu_torch.core.precision import tree_cast, tree_leaves

__all__ = ["cast_op", "o1_intercept", "classify_module", "module_class",
           "module_dtype", "checkpoint_context_fn", "FLAX_COUNTERPARTS"]


def _widest_float(tree: Any):
    dtypes = [t.dtype for t in tree_leaves(tree)
              if torch.is_floating_point(t)]
    if not dtypes:
        return None
    return functools.reduce(torch.promote_types, dtypes)


def cast_op(name: str, fn: Callable, *args: Any,
            half_dtype=torch.bfloat16, **kwargs: Any) -> Any:
    """Run ``fn(*args, **kwargs)`` with O1 input casting for op ``name``:
    "half" ops get half inputs, "fp32" ops fp32 inputs (and so fp32
    outputs), "promote" ops every floating input in the widest floating
    dtype present; other ops run as given."""
    kind = classify_op(name)
    if kind == "half":
        args = tree_cast(args, half_dtype)
        kwargs = tree_cast(kwargs, half_dtype)
    elif kind == "fp32":
        args = tree_cast(args, torch.float32)
        kwargs = tree_cast(kwargs, torch.float32)
    elif kind == "promote":
        widest = _widest_float((args, kwargs))
        if widest is not None:
            args = tree_cast(args, widest)
            kwargs = tree_cast(kwargs, widest)
    return fn(*args, **kwargs)


# class-name fragments of the JAX interceptor (apex_tpu/amp/o1.py:83-91),
# the fp32 ones tried first
_HALF_MODULES = ("dense", "conv", "linear", "einsum", "attention",
                 "densegeneral", "mlp",
                 "lstm", "gru", "mgucell", "simplecell", "rnncell")
_FP32_MODULES = ("layernorm", "batchnorm", "groupnorm", "rmsnorm",
                 "norm", "softmax", "crossentropy", "loss", "embed")

#: the flax class of each port module class whose name differs from it:
#: the transformer's pre-norm (the JAX ``_norm()``'s ``_Norm``), ResNet's
#: convs and classifier (flax ``nn.Conv`` / ``nn.Dense``).  BERT's
#: ``mlm_dense`` and ``pooler`` are flax ``Dense`` and the port's
#: ``ColumnParallelLinear``: both classes are "half".
FLAX_COUNTERPARTS: Dict[str, str] = {
    "Norm": "_Norm",
    "_Conv": "Conv",
    "_Dense": "Dense",
}


def classify_module(cls_name: str) -> str:
    """Classify a module class name for O1 ("half" / "fp32" /
    "passthrough"), as the JAX package classifies a flax class name."""
    low = cls_name.lower()
    for frag in _FP32_MODULES:
        if frag in low:
            return "fp32"
    for frag in _HALF_MODULES:
        if frag in low:
            return "half"
    return "passthrough"


def module_class(module: torch.nn.Module) -> str:
    """The O1 class of ``module``: that of its flax counterpart's name."""
    name = type(module).__name__
    return classify_module(FLAX_COUNTERPARTS.get(name, name))


# the half dtypes of the intercepts entered and not yet left (innermost
# last), the hooks' handles while any is, and per module call in flight
# whether the pre-hook set the module's dtype
_ACTIVE: List[Any] = []
_HANDLES: List[Any] = []
_SET_DTYPE: Dict[int, List[bool]] = {}


def module_dtype(module: torch.nn.Module) -> Optional[Any]:
    """The dtype an active :func:`o1_intercept` casts a call of
    ``module`` to (its half dtype, or fp32), or None: no intercept, or a
    "passthrough" class."""
    if not _ACTIVE:
        return None
    kind = module_class(module)
    if kind == "half":
        return _ACTIVE[-1]
    return torch.float32 if kind == "fp32" else None


def _pre_hook(module, args):
    target = module_dtype(module)
    promotes = (target is not None
                and getattr(module, "dtype", torch.float32) is None)
    if promotes:
        module.dtype = target
    _SET_DTYPE.setdefault(id(module), []).append(promotes)
    return None if target is None else tree_cast(args, target)


def _post_hook(module, args, output):
    stack = _SET_DTYPE.get(id(module))
    if not stack:
        return None
    if stack.pop():
        module.dtype = None
    if not stack:
        del _SET_DTYPE[id(module)]
    return None


@contextlib.contextmanager
def o1_intercept(half_dtype=torch.bfloat16):
    """Context manager applying O1 per-op casting to module calls.

    Usage::

        with amp.o1.o1_intercept(torch.bfloat16):
            logits, _ = model(ids)

    Scoped and explicit, as the JAX package's flax interceptor: it acts
    only inside the block, and patches nothing of ``torch``.  Nested
    intercepts take the innermost half dtype.
    """
    if not _ACTIVE:
        _HANDLES.append(_module.register_module_forward_pre_hook(_pre_hook))
        _HANDLES.append(_module.register_module_forward_hook(
            _post_hook, always_call=True))
    _ACTIVE.append(half_dtype)
    try:
        yield
    finally:
        _ACTIVE.pop()
        if not _ACTIVE:
            while _HANDLES:
                _HANDLES.pop().remove()


def checkpoint_context_fn() -> Callable:
    """A ``context_fn`` for ``torch.utils.checkpoint.checkpoint`` (non-
    reentrant) that reruns the recomputed forward under the intercept
    active now, if any: the backward runs outside the ``with`` block."""
    if not _ACTIVE:
        from torch.utils.checkpoint import noop_context_fn
        return noop_context_fn
    half = _ACTIVE[-1]
    return lambda: (contextlib.nullcontext(), o1_intercept(half))
