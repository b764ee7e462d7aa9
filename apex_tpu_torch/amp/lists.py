"""O1 per-op cast classification (reference: ``apex/amp/lists/``).

Counterpart of ``apex_tpu/amp/lists.py``: the port keeps its own copy of
the three tables per namespace — ``FUNCTIONAL_*`` (``torch.nn.
functional``: convs, rnn cells, losses, norms, activations),
``TORCH_*`` (``torch.*``: blas, reductions, transcendentals) and
``TENSOR_*`` (``torch.Tensor`` methods) — of the user registry and of
:func:`classify_op`, whose answers equal the JAX module's for every name,
registrations included.  The tables name ops by their JAX spellings, and
``TORCH_ALIASES`` maps the reference's torch spellings onto them, so
``classify_op("mm")`` and ``classify_op("matmul")`` agree.

:mod:`apex_tpu_torch.amp.o1` consumes them: ``cast_op`` casts one op's
inputs, and ``o1_intercept`` classifies whole module calls.  Nothing here
patches the torch namespace.
"""

from __future__ import annotations

from typing import Literal

__all__ = [
    "HALF_FUNCS", "FP32_FUNCS", "PROMOTE_FUNCS",
    "register_half_function", "register_float_function",
    "register_promote_function", "deregister_function",
    "FUNCTIONAL_HALF", "FUNCTIONAL_FP32", "FUNCTIONAL_PROMOTE",
    "TORCH_HALF", "TORCH_FP32", "TORCH_PROMOTE",
    "TENSOR_HALF", "TENSOR_FP32", "TENSOR_PROMOTE",
    "TORCH_ALIASES", "classify_op",
]

# ---------------------------------------------------------------------------
# functional_overrides ≙ torch.nn.functional — layer-shaped ops
# ---------------------------------------------------------------------------

# MXU-friendly layer ops: run in half under O1 (reference FP16_FUNCS:
# conv1d/2d/3d, conv_transpose1d/2d/3d, conv_tbc, linear, prelu, rnn
# cells via rnn_compat).
FUNCTIONAL_HALF = frozenset({
    # dense / linear family
    "linear", "dense", "dense_general", "bilinear_layer",
    # convolutions (jax: one general op; torch spellings via aliases)
    "conv", "conv1d", "conv2d", "conv3d", "conv_general_dilated",
    "conv_transpose", "conv_transpose1d", "conv_transpose2d",
    "conv_transpose3d", "conv_tbc", "local_conv", "depthwise_conv",
    # attention cores (MXU matmuls inside)
    "attention", "scaled_dot_product_attention", "dot_product_attention",
    "multi_head_attention", "fused_attention",
    # recurrent cells (reference rnn_compat casts RNN compute to fp16)
    "rnn_tanh_cell", "rnn_relu_cell", "lstm_cell", "gru_cell",
    "rnn", "lstm", "gru",
    # cheap activations that ride the fused epilogue
    "prelu", "relu", "relu6", "leaky_relu", "elu", "celu", "selu",
    "hardtanh", "hardswish", "hardsigmoid", "glu", "silu", "swish",
    "gelu", "mish", "sigmoid", "tanh_act",
    # pooling / resampling (bandwidth ops, safe in half)
    "avg_pool", "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool", "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool2d", "adaptive_max_pool2d",
    "interpolate", "upsample", "upsample_nearest", "upsample_bilinear",
    "grid_sample", "pixel_shuffle", "pad_layer", "unfold", "fold",
    "embedding_lookup", "dropout_half",
})

# Numerically sensitive layer ops: always fp32 under O1 (reference
# FP32_FUNCS: every loss, every norm, softmaxes, cosine similarity…).
FUNCTIONAL_FP32 = frozenset({
    # softmaxes
    "softmax", "log_softmax", "softmin", "gumbel_softmax", "softplus",
    "logsigmoid",
    # norms
    "layer_norm", "rms_norm", "batch_norm", "group_norm",
    "instance_norm", "local_response_norm", "normalize",
    "weight_norm", "spectral_norm", "sync_batch_norm",
    # losses (reference lists every one of these in FP32_FUNCS)
    "cross_entropy", "nll_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "softmax_cross_entropy",
    "softmax_cross_entropy_with_integer_labels",
    "kl_div", "kl_divergence", "mse_loss", "l1_loss", "smooth_l1_loss",
    "huber_loss", "ctc_loss", "hinge_embedding_loss",
    "margin_ranking_loss", "multilabel_margin_loss",
    "multilabel_soft_margin_loss", "multi_margin_loss",
    "soft_margin_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "cosine_embedding_loss",
    "poisson_nll_loss", "gaussian_nll_loss", "focal_loss",
    "transducer_loss", "sigmoid_binary_cross_entropy",
    # similarity / distance
    "cosine_similarity", "pairwise_distance", "pdist",
    # sensitive transcendental-shaped layers
    "erf_act", "log_softmax_2d", "gelu_fp32",
})

FUNCTIONAL_PROMOTE = frozenset({
    "bilinear", "embedding_bag",
})

# ---------------------------------------------------------------------------
# torch_overrides ≙ torch.* namespace fns — in JAX terms jnp.* / lax.*
# ---------------------------------------------------------------------------

# BLAS-shaped namespace ops → half (reference FP16_FUNCS: addmm, addmv,
# addr, matmul, mm, mv, bmm, baddbmm, chain_matmul, …).  Note:
# ``tensordot`` is classified half here (it is an MXU contraction like
# matmul/einsum) where earlier revisions had it in the promote list —
# a deliberate change, O1 exists to route contractions to the MXU.
TORCH_HALF = frozenset({
    "dot", "dot_general", "matmul", "einsum", "tensordot", "vdot",
    "inner", "outer", "kron", "mm", "mv", "bmm", "addmm", "addmv",
    "addr", "baddbmm", "addbmm", "chain_matmul", "matvec", "vecmat",
    "conv_general", "correlate", "convolve",
})

# Transcendentals / reductions → fp32 (reference FP32_FUNCS: acos, asin,
# cosh, erfinv, exp, expm1, log*, reciprocal, rsqrt, sinh, tan, pow,
# prod, sum, norm, cumprod, cumsum, dist, mean, renorm, std, var, …).
TORCH_FP32 = frozenset({
    # transcendentals
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
    "pow", "power", "float_power", "sqrt_sensitive", "rsqrt",
    "reciprocal", "acos", "arccos", "asin", "arcsin", "atan", "arctan",
    "acosh", "arccosh", "asinh", "arcsinh", "atanh", "arctanh",
    "cosh", "sinh", "tan", "erf", "erfc", "erfinv", "lgamma",
    "digamma", "polygamma", "mvlgamma", "i0", "logit", "xlogy",
    # reductions / accumulations
    "sum", "mean", "prod", "cumsum", "cumprod", "logcumsumexp",
    "logsumexp", "var", "std", "var_mean", "std_mean", "norm",
    "linalg_norm", "vector_norm", "matrix_norm", "renorm", "dist",
    "trace", "nansum", "nanmean",
    # softmax-family namespace spellings
    "log_softmax_fn", "softmax_fn",
})

# Multi-arg namespace ops that promote to the widest floating input
# (reference casts.py promote list: add, sub, mul, div, addcmul,
# addcdiv, atan2, cat, cross, dot-1d, equal, stack, …).
TORCH_PROMOTE = frozenset({
    "add", "sub", "subtract", "mul", "multiply", "div", "divide",
    "true_divide", "floor_divide", "addcdiv", "addcmul", "atan2",
    "arctan2", "hypot", "cross", "dot_1d", "cat", "concatenate",
    "stack", "hstack", "vstack", "dstack", "where", "equal",
    "allclose", "isclose", "maximum", "minimum", "fmax", "fmin",
    "remainder", "fmod", "lerp", "clip_by_tree",
})

# ---------------------------------------------------------------------------
# tensor_overrides ≙ torch.Tensor methods — array-method spellings
# ---------------------------------------------------------------------------

TENSOR_HALF = frozenset({
    "__matmul__", "t_matmul", "t_mm", "t_mv", "t_bmm", "t_addmm",
    "t_addmv", "t_addr",
})

TENSOR_FP32 = frozenset({
    "t_exp", "t_log", "t_pow", "t_sum", "t_mean", "t_prod", "t_cumsum",
    "t_cumprod", "t_var", "t_std", "t_norm", "t_softmax",
    "t_log_softmax", "t_erf", "t_rsqrt", "t_reciprocal",
})

TENSOR_PROMOTE = frozenset({
    "__add__", "__radd__", "__iadd__", "__sub__", "__rsub__", "__isub__",
    "__mul__", "__rmul__", "__imul__", "__truediv__", "__rtruediv__",
    "__itruediv__", "__mod__", "__eq__", "t_add", "t_sub", "t_mul",
    "t_div", "t_addcdiv", "t_addcmul", "t_atan2", "t_where",
})

# ---------------------------------------------------------------------------
# merged tables (the public surface most callers use)
# ---------------------------------------------------------------------------

HALF_FUNCS = FUNCTIONAL_HALF | TORCH_HALF | TENSOR_HALF
FP32_FUNCS = FUNCTIONAL_FP32 | TORCH_FP32 | TENSOR_FP32
PROMOTE_FUNCS = FUNCTIONAL_PROMOTE | TORCH_PROMOTE | TENSOR_PROMOTE

# Reference (torch) spelling → canonical name used in the tables above.
# classify_op consults this first, so code migrated from the reference
# can keep its op names verbatim.
TORCH_ALIASES = {
    # blas / functional-conv / activation spellings that coincide with
    # the canonical names (mm, bmm, conv2d, silu, …) are present in the
    # tables literally and need no entry here
    # torch tensor methods → t_-prefixed canonical names
    "Tensor.matmul": "t_matmul", "Tensor.mm": "t_mm",
    "Tensor.mv": "t_mv", "Tensor.bmm": "t_bmm",
    "Tensor.addmm": "t_addmm", "Tensor.addmv": "t_addmv",
    "Tensor.addr": "t_addr", "Tensor.exp": "t_exp",
    "Tensor.log": "t_log", "Tensor.pow": "t_pow",
    "Tensor.sum": "t_sum", "Tensor.mean": "t_mean",
    "Tensor.prod": "t_prod", "Tensor.cumsum": "t_cumsum",
    "Tensor.cumprod": "t_cumprod", "Tensor.var": "t_var",
    "Tensor.std": "t_std", "Tensor.norm": "t_norm",
    "Tensor.softmax": "t_softmax", "Tensor.log_softmax": "t_log_softmax",
    "Tensor.erf": "t_erf", "Tensor.rsqrt": "t_rsqrt",
    "Tensor.reciprocal": "t_reciprocal", "Tensor.add": "t_add",
    "Tensor.sub": "t_sub", "Tensor.mul": "t_mul",
    "Tensor.div": "t_div", "Tensor.addcdiv": "t_addcdiv",
    "Tensor.addcmul": "t_addcmul", "Tensor.atan2": "t_atan2",
    "Tensor.where": "t_where",
    # common jax.nn spellings
    "log_sigmoid": "logsigmoid", "one_hot": "embedding_lookup",
    # torch loss-module spellings → functional names
    "CrossEntropyLoss": "cross_entropy", "NLLLoss": "nll_loss",
    "BCELoss": "binary_cross_entropy",
    "BCEWithLogitsLoss": "binary_cross_entropy_with_logits",
    "MSELoss": "mse_loss", "L1Loss": "l1_loss",
    "SmoothL1Loss": "smooth_l1_loss", "HuberLoss": "huber_loss",
    "KLDivLoss": "kl_div", "CTCLoss": "ctc_loss",
}


# ---------------------------------------------------------------------------
# user registration (reference: apex.amp.register_half_function /
# register_float_function / register_promote_function — the public
# extension points for classifying custom ops under O1)
# ---------------------------------------------------------------------------

_REGISTERED: dict = {}
_REGISTERED_SOURCE: dict = {}


def _register(kind: str, module_or_name, function_name=None) -> None:
    """Accepts the reference's ``(module, "fn_name")`` form or a bare
    op-name string; registrations take precedence over the built-in
    tables (matching the reference, whose registrations patch last).

    Unlike the reference (which patches each module object
    independently), classification here is keyed by bare op name — so
    two *different* modules registering the same function name with
    conflicting kinds is ambiguous and raises instead of silently
    letting the last registration win."""
    name = (function_name if function_name is not None
            else module_or_name)
    if not isinstance(name, str):
        raise TypeError(
            f"register_*_function takes (module, 'fn_name') or a "
            f"name string, got {type(name).__name__}")
    source = (getattr(module_or_name, "__name__", repr(module_or_name))
              if function_name is not None else None)
    key = TORCH_ALIASES.get(name, name)
    prev_kind = _REGISTERED.get(key)
    prev_src = _REGISTERED_SOURCE.get(key)
    if prev_kind is not None and prev_kind != kind:
        # any kind change is ambiguous — including re-registration from
        # the same module or two bare-name (source=None) registrations
        raise ValueError(
            f"conflicting O1 registration for '{key}': "
            f"{prev_kind!r} (from {prev_src}) vs {kind!r} (from "
            f"{source}) — classification is keyed by op name; "
            f"deregister_function('{key}') first if the override is "
            f"intended")
    _REGISTERED[key] = kind
    _REGISTERED_SOURCE[key] = source


def register_half_function(module_or_name, function_name=None) -> None:
    """Classify an op as MXU/half under O1 (reference:
    ``apex.amp.register_half_function(module, 'fn')``)."""
    _register("half", module_or_name, function_name)


def register_float_function(module_or_name, function_name=None) -> None:
    """Classify an op as always-fp32 under O1 (reference:
    ``apex.amp.register_float_function``)."""
    _register("fp32", module_or_name, function_name)


def register_promote_function(module_or_name, function_name=None) -> None:
    """Classify an op as widest-input-promoting under O1 (reference:
    ``apex.amp.register_promote_function``)."""
    _register("promote", module_or_name, function_name)


def deregister_function(module_or_name, function_name=None) -> None:
    """Remove a user registration (tests/teardown; the built-in tables
    are untouched)."""
    name = (function_name if function_name is not None
            else module_or_name)
    key = TORCH_ALIASES.get(name, name)
    _REGISTERED.pop(key, None)
    _REGISTERED_SOURCE.pop(key, None)


def classify_op(name: str) -> Literal["half", "fp32", "promote", "passthrough"]:
    """Classify an op name for O1 casting, defaulting to passthrough
    (reference: ops absent from every list keep their input dtype).

    Accepts canonical JAX-centric names, reference torch spellings (via
    ``TORCH_ALIASES``), and ``Tensor.<method>`` spellings.  User
    registrations (:func:`register_half_function` et al.) take
    precedence over the built-in tables.
    """
    name = TORCH_ALIASES.get(name, name)
    reg = _REGISTERED.get(name)
    if reg is not None:
        return reg
    if name in HALF_FUNCS:
        return "half"
    if name in FP32_FUNCS:
        return "fp32"
    if name in PROMOTE_FUNCS:
        return "promote"
    return "passthrough"
