"""Load the JAX package's parameters into the port's models.

:func:`params_from_jax` turns the flax parameter tree of an
``apex_tpu.models.GPTModel`` / ``LlamaModel`` / ``BertModel`` — numpy
leaves, as ``jax.device_get`` gives them — into a ``state_dict`` for
the port's model of the same class under the same config.  Both
layer layouts load: the scanned stack (``scan_layers=True``: one
``transformer/layers/layer`` subtree whose leaves carry a leading layer
axis) and the unrolled one (``transformer/layer_<i>`` subtrees).  Dense
kernels are stored ``(in, out)`` by flax and ``(out, in)`` by PyTorch,
so they are transposed.  No JAX import is needed: the tree is plain
nested mappings of arrays (boxed leaves with an ``unbox`` method, as
flax's partitioning metadata, are unboxed).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax"]

_LINEARS = {
    "attention": ("qkv_proj", "out_proj"),
    "mlp": ("dense_h_to_4h", "dense_h_to_4h_gate", "dense_4h_to_h"),
}
_NORMS = ("input_norm", "post_attention_norm")


def _arr(leaf) -> np.ndarray:
    if hasattr(leaf, "unbox"):
        leaf = leaf.unbox()
    return np.asarray(leaf)


def _layer_trees(transformer: Mapping, num_layers: int):
    """Per-layer subtrees, from either the scanned or unrolled layout."""
    if "layers" in transformer:
        stacked = transformer["layers"]["layer"]

        def take(tree, i):
            return {k: (take(v, i) if isinstance(v, Mapping)
                        else _arr(v)[i]) for k, v in tree.items()}
        return [take(stacked, i) for i in range(num_layers)]
    return [transformer[f"layer_{i}"] for i in range(num_layers)]


def _norm(out: Dict[str, Any], prefix: str, tree: Mapping) -> None:
    out[f"{prefix}.weight"] = _arr(tree["scale"])
    if "bias" in tree:
        out[f"{prefix}.bias"] = _arr(tree["bias"])


def _linear(out: Dict[str, Any], prefix: str, tree: Mapping) -> None:
    out[f"{prefix}.weight"] = _arr(tree["kernel"]).T
    if "bias" in tree:
        out[f"{prefix}.bias"] = _arr(tree["bias"])


def params_from_jax(params_np: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """State dict for ``GPTModel(cfg)`` or ``BertModel(cfg)`` (a tree
    with ``emb_norm_scale``) from the JAX model's params.

    ``params_np``: the ``params`` collection (or a dict holding it under
    ``"params"``) with array leaves.  Returns CPU tensors in the JAX
    arrays' dtypes; ``load_state_dict`` casts them to the module's.
    """
    p = params_np.get("params", params_np)
    out: Dict[str, Any] = {
        "embedding.weight": _arr(p["embedding"]["embedding"])}
    if "position_embedding" in p:
        out["position_embedding"] = _arr(p["position_embedding"])
    for i, layer in enumerate(_layer_trees(p["transformer"],
                                           cfg.num_layers)):
        pre = f"transformer.layers.{i}"
        for name in _NORMS:
            _norm(out, f"{pre}.{name}", layer[name])
        for block, names in _LINEARS.items():
            for name in names:
                if name in layer[block]:
                    _linear(out, f"{pre}.{block}.{name}",
                            layer[block][name])
    if "emb_norm_scale" in p:                   # BERT
        for name in ("token_type_embedding", "emb_norm_scale",
                     "emb_norm_bias", "mlm_bias"):
            if name in p:
                out[name] = _arr(p[name])
        _linear(out, "mlm_dense", p["mlm_dense"])
        _norm(out, "mlm_norm", p["mlm_norm"])
        _linear(out, "pooler", p["pooler"])
    else:
        _norm(out, "final_norm", p["final_norm"])
    if "lm_head" in p:
        _linear(out, "lm_head", p["lm_head"])
    # numpy has no native bfloat16: such leaves load through fp32
    return {k: torch.from_numpy(np.array(
        v, dtype=np.float32 if v.dtype.name == "bfloat16" else v.dtype))
        for k, v in out.items()}
