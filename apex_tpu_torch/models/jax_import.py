"""Load the JAX package's parameters into the port's models.

:func:`params_from_jax` turns the flax parameter tree of an
``apex_tpu.models.GPTModel`` / ``LlamaModel`` / ``BertModel`` /
``ViTModel`` — numpy leaves, as ``jax.device_get`` gives them, MoE
layers included — into a ``state_dict`` for the port's model of the
same class under the same config.  Both
layer layouts load: the scanned stack (``scan_layers=True``: one
``transformer/layers/layer`` subtree whose leaves carry a leading layer
axis) and the unrolled one (``transformer/layer_<i>`` subtrees).  Dense
kernels are stored ``(in, out)`` by flax and ``(out, in)`` by PyTorch,
so they are transposed.  :func:`resnet_params_from_jax` does the same
for ``apex_tpu.models.ResNet`` (params and ``batch_stats``; conv
kernels go from HWIO to OIHW).  :func:`group_norm_params_from_jax`,
:func:`mha_params_from_jax` and :func:`mlp_params_from_jax` do it for the
``ops`` modules (``GroupNorm``; ``SelfMultiheadAttn`` /
``EncdecMultiheadAttn``, whose DenseGeneral kernels ``(E, 3, H, d)``,
``(E, 2, H, d)`` and ``(E, H, d)`` become Linear weights with rows in
that order; ``FusedDense``, ``FusedDenseGeluDense`` and ``MLP``).  No JAX import is needed: the tree is plain
nested mappings of arrays (boxed leaves with an ``unbox`` method, as
flax's partitioning metadata, are unboxed).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "shard_state_dict", "shard_paged_pool",
           "resnet_params_from_jax",
           "stage_params_from_jax", "closure_params_from_jax",
           "named_leaves_from_jax", "group_norm_params_from_jax",
           "mha_params_from_jax", "mlp_params_from_jax"]

_LINEARS = {
    "attention": ("qkv_proj", "out_proj"),
    "mlp": ("dense_h_to_4h", "dense_h_to_4h_gate", "dense_4h_to_h"),
}
_NORMS = ("input_norm", "post_attention_norm")
#: MoE leaves, in the JAX module's layout on both sides
_MOE = ("gate", "w1", "w2", "wg", "b1", "b2")
#: the stacked ``(E, ...)`` leaves an expert axis shards
_MOE_EXPERT_LEAVES = ("w1", "w2", "wg", "b1", "b2")


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


#: tensor-parallel layout of the transformer models' parameters: the dim
#: a rank's shard is cut along (column layers and the vocabulary: the
#: rows of the torch weight; row layers: its columns; biases of row
#: layers, norms and positions whole)
_TP_DIMS = (("qkv_proj.weight", 0), ("qkv_proj.bias", 0),
            ("dense_h_to_4h.weight", 0), ("dense_h_to_4h.bias", 0),
            ("dense_h_to_4h_gate.weight", 0), ("dense_h_to_4h_gate.bias", 0),
            ("out_proj.weight", 1), ("dense_4h_to_h.weight", 1),
            ("embedding.weight", 0), ("lm_head.weight", 0),
            ("mlm_dense.weight", 0), ("mlm_dense.bias", 0),
            ("pooler.weight", 0), ("pooler.bias", 0))


def _layer(out: Dict[str, Any], pre: str, layer: Mapping) -> None:
    """One ``ParallelTransformerLayer``'s leaves under ``pre``."""
    for name in _NORMS:
        _norm(out, f"{pre}.{name}", layer[name])
    for block, names in _LINEARS.items():
        for name in names:
            if name in layer.get(block, {}):
                _linear(out, f"{pre}.{block}.{name}", layer[block][name])
    for name in _MOE:
        if name in layer.get("moe_mlp", {}):
            out[f"{pre}.moe_mlp.{name}"] = _arr(layer["moe_mlp"][name])


def shard_state_dict(sd: Mapping[str, Any], tp_rank: int, tp_size: int, *,
                     experts: Optional[Tuple[int, int]] = None
                     ) -> Dict[str, Any]:
    """Tensor-parallel rank ``tp_rank``'s part of a whole ``GPTModel`` /
    ``BertModel`` state dict: each column layer's rows, each row layer's
    columns and the embedding's vocabulary block, as the layers of a
    model built on a mesh with ``tp_size`` tensor ranks hold them
    (:mod:`apex_tpu_torch.transformer.layers`); the rest whole.
    ``experts`` ``(rank, n)``: the MoE expert leaves (``moe_mlp.w1``,
    ``w2``, ``wg``, ``b1``, ``b2``) are cut on their expert dim into
    ``n`` blocks and block ``rank`` kept, as a layer whose
    ``expert_axis`` has ``n`` ranks holds them; default ``(tp_rank,
    tp_size)`` (the expert axis is the tensor axis), ``(0, 1)`` keeps
    them whole."""
    out = {}
    e_rank, e_size = (tp_rank, tp_size) if experts is None else experts
    for name, t in sd.items():
        dim = next((d for suffix, d in _TP_DIMS
                    if name == suffix or name.endswith("." + suffix)), None)
        rank, size = tp_rank, tp_size
        if dim is None and any(name.endswith(f".moe_mlp.{leaf}")
                               for leaf in _MOE_EXPERT_LEAVES):
            dim, rank, size = 0, e_rank, e_size
        if dim is None or size == 1:
            out[name] = t
            continue
        if t.shape[dim] % size:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does "
                             f"not split into {size}")
        part = t.shape[dim] // size
        out[name] = t.narrow(dim, rank * part, part).clone()
    return out


def shard_paged_pool(cache: Mapping[str, Any], tp_rank: int,
                     tp_size: int) -> Dict[str, Any]:
    """Tensor-parallel rank ``tp_rank``'s part of a whole paged pool
    (:func:`~apex_tpu_torch.models.generate.init_paged_cache`'s dict):
    its block of the kv heads of ``key`` / ``value`` ``(layers,
    kv_heads, ...)`` and of their ``key_scales`` / ``value_scales``, as
    the layers of a model serving at ``tp_size`` tensor ranks hold them;
    the tables and cursors whole (every rank keeps the same ones)."""
    out = {}
    for name, t in cache.items():
        if name in ("key", "value", "key_scales", "value_scales") \
                and tp_size > 1:
            if t.shape[1] % tp_size:
                raise ValueError(
                    f"{name}: kv heads ({t.shape[1]}) must be divisible by "
                    f"the tensor-parallel degree ({tp_size})")
            part = t.shape[1] // tp_size
            t = t.narrow(1, tp_rank * part, part).clone()
        out[name] = t
    return out


def params_from_jax(params_np: Mapping, cfg, *, tp_rank: int = 0,
                    tp_size: int = 1) -> Dict[str, torch.Tensor]:
    """State dict for ``GPTModel(cfg)``, ``BertModel(cfg)`` (a tree
    with ``emb_norm_scale``) or ``ViTModel(cfg)`` (a tree with
    ``patch_embed``: the conv kernel HWIO → OIHW, the class token,
    positions and head) from the JAX model's params.  A layer's
    ``moe_mlp`` leaves (``gate``, ``w1``, ``w2``, ``wg``, ``b1``, ``b2``)
    keep their layout.

    ``params_np``: the ``params`` collection (or a dict holding it under
    ``"params"``) with array leaves.  Returns CPU tensors in the JAX
    arrays' dtypes; ``load_state_dict`` casts them to the module's.
    ``tp_rank`` / ``tp_size``: the shard of tensor-parallel rank
    ``tp_rank`` (:func:`shard_state_dict`).
    """
    p = params_np.get("params", params_np)
    out: Dict[str, Any] = {}
    if "patch_embed" in p:                      # ViT
        kernel = _arr(p["patch_embed"]["kernel"])
        out["patch_embed.weight"] = (kernel.transpose(3, 2, 0, 1)
                                     if kernel.ndim == 4 else kernel)
        out["patch_embed.bias"] = _arr(p["patch_embed"]["bias"])
        out["cls_token"] = _arr(p["cls_token"])
        _linear(out, "head", p["head"])
    else:
        out["embedding.weight"] = _arr(p["embedding"]["embedding"])
    if "position_embedding" in p:
        out["position_embedding"] = _arr(p["position_embedding"])
    for i, layer in enumerate(_layer_trees(p["transformer"],
                                           cfg.num_layers)):
        _layer(out, f"transformer.layers.{i}", layer)
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
    return shard_state_dict(_tensors(out), tp_rank, tp_size)


def stage_params_from_jax(stacked_np: Mapping, cfg=None, *, stage: int,
                          chunk: int = 0, tp_rank: int = 0,
                          tp: int = 1) -> Dict[str, torch.Tensor]:
    """State dict of one pipe rank's chunk of layers — the
    ``nn.ModuleList`` that ``apex_tpu_torch.transformer.pipeline_parallel.
    build_model`` makes on rank ``stage`` — from the stacked parameters of
    the JAX ``build_model``: leaves ``(pp, per_stage, ...)``, or ``(V,
    pp, per_stage, ...)`` interleaved (then ``chunk`` picks the row).
    Keys ``"<j>.<name>"`` for the chunk's ``j``-th layer, under the
    :func:`params_from_jax` names of a ``ParallelTransformerLayer``;
    ``tp_rank`` / ``tp``: that tensor rank's shard.  ``cfg`` is accepted
    for the signature of :func:`params_from_jax`; the layout is read
    from the leaves.  The same call turns the JAX schedule's stage
    gradients, which have the parameters' layout, into the port's."""
    del cfg
    p = stacked_np.get("params", stacked_np)
    lead = _arr(p["input_norm"]["scale"]).ndim - 1   # 2, or 3 with V
    if lead not in (2, 3):
        raise ValueError(f"expected (pp, per_stage, ...) or (V, pp, "
                         f"per_stage, ...) leaves, got {lead} leading dims")
    row = (stage,) if lead == 2 else (chunk, stage)

    def take(tree, j):
        return {k: (take(v, j) if isinstance(v, Mapping)
                    else _arr(v)[row + (j,)]) for k, v in tree.items()}
    per = _arr(p["input_norm"]["scale"]).shape[lead - 1]
    out: Dict[str, Any] = {}
    for j in range(per):
        _layer(out, str(j), take(p, j))
    return shard_state_dict(_tensors(out), tp_rank, tp)


def closure_params_from_jax(params_np: Mapping, *, tp_rank: int = 0,
                            tp: int = 1) -> Dict[str, torch.Tensor]:
    """State dict of the pipeline closure — a ``GPTModel`` with
    ``num_layers=0`` and an untied head, whose ``embed`` / ``head`` run
    before and after the stages — from the closure leaves of the JAX
    pipelined GPT train step (``bench_configs.bench_gpt2_3d_full_step``):
    ``embed`` ``(V, H)``, ``pos`` ``(S, H)``, ``head`` ``(H, V)``,
    ``fln_scale`` and ``fln_bias`` (a dict holding them, other keys
    ignored).  ``tp_rank`` / ``tp``: that tensor rank's shard."""
    out = {"embedding.weight": _arr(params_np["embed"]),
           "position_embedding": _arr(params_np["pos"]),
           "final_norm.weight": _arr(params_np["fln_scale"]),
           "final_norm.bias": _arr(params_np["fln_bias"]),
           "lm_head.weight": _arr(params_np["head"]).T}
    return shard_state_dict(_tensors(out), tp_rank, tp)


def _is_fp8_leaf(v) -> bool:
    return isinstance(v, Mapping) and set(v) == {"q", "scale"}


def named_leaves_from_jax(tree: Mapping, cfg) -> Dict[str, Any]:
    """The leaves of a tree shaped like a ``GPTModel`` / ``BertModel``'s
    params — an optimizer moment, say — keyed by the port's parameter
    names, as they are: no transpose, no cast.  An fp8 moment's
    ``{"q", "scale"}`` is one leaf.  The unrolled layout only: a scanned
    stack keeps one leaf (one fp8 buffer) for all its layers."""
    p = tree.get("params", tree)
    if "layers" in p.get("transformer", {}):
        raise ValueError(
            "a scanned layer stack holds one leaf for all layers; take "
            "the state of a model built with scan_layers=False")
    leaves = []

    def mark(t):
        if _is_fp8_leaf(t) or not isinstance(t, Mapping):
            leaves.append(t)
            return np.asarray(len(leaves) - 1, np.int64)
        return {k: mark(v) for k, v in t.items()}
    names = params_from_jax(mark(p), cfg)
    return {n: leaves[int(i)] for n, i in names.items()}


_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "mean",
              "var": "var"}


def _flat(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), _arr(v)


def resnet_params_from_jax(params_np: Mapping, batch_stats_np: Mapping,
                           cfg) -> Dict[str, torch.Tensor]:
    """State dict for ``ResNet(cfg)`` from the JAX ResNet's ``params``
    and ``batch_stats`` collections (either may be wrapped in a dict
    under its collection name; ``batch_stats`` may be empty, as for a
    gradient tree).

    Conv ``kernel`` (HWIO) → ``weight`` (OIHW); ``*/SyncBatchNorm_0/
    {scale, bias}`` → ``weight`` / ``bias`` and ``{mean, var}`` → the
    running-statistics buffers; ``fc/kernel`` transposed, ``fc/bias``.
    Raises when the tree's blocks are not ``cfg.stage_sizes``'.
    """
    p = params_np.get("params", params_np)
    bs = batch_stats_np.get("batch_stats", batch_stats_np)
    want = {f"stage{i}_block{j}" for i, n in enumerate(cfg.stage_sizes)
            for j in range(n)}
    have = {k for k in p if k.startswith("stage")}
    if have != want:
        raise ValueError(
            f"the JAX tree's blocks {sorted(have)} are not those of "
            f"stage_sizes={cfg.stage_sizes}")
    out: Dict[str, Any] = {}
    for path, v in list(_flat(p)) + list(_flat(bs)):
        if "SyncBatchNorm_0" in path:
            name = ".".join(q for q in path[:-1] if q != "SyncBatchNorm_0")
            out[f"{name}.{_BN_LEAVES[path[-1]]}"] = v
        elif path[-1] == "kernel":
            out[".".join(path[:-1]) + ".weight"] = (
                v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T)
        else:
            out[".".join(path)] = v
    return _tensors(out)


def _tensors(out: Mapping) -> Dict[str, torch.Tensor]:
    # numpy has no native bfloat16: such leaves load through fp32
    return {k: torch.from_numpy(np.array(
        v, dtype=np.float32 if v.dtype.name == "bfloat16" else v.dtype))
        for k, v in out.items()}


def group_norm_params_from_jax(params_np: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """State dict for ``ops.GroupNorm`` from the JAX ``GroupNorm``'s
    params: ``scale`` and ``bias`` as they are."""
    p = params_np.get("params", params_np)
    return _tensors({k: _arr(p[k]) for k in ("scale", "bias") if k in p})


def mha_params_from_jax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``ops.SelfMultiheadAttn`` / ``EncdecMultiheadAttn``
    from the JAX module's params.  A DenseGeneral kernel ``(E, *feat)``
    becomes a Linear weight ``(prod(feat), E)`` with its rows in the
    order of ``feat`` — ``(3, H, d)`` for ``qkv_proj``, ``(2, H, d)`` for
    ``kv_proj``, ``(H, d)`` for ``q_proj`` — and its bias is flattened
    the same way."""
    p = params_np.get("params", params_np)
    out: Dict[str, Any] = {}
    for name in ("qkv_proj", "q_proj", "kv_proj", "out_proj"):
        if name not in p:
            continue
        kernel = _arr(p[name]["kernel"])
        out[f"{name}.weight"] = kernel.reshape(kernel.shape[0], -1).T
        if "bias" in p[name]:
            out[f"{name}.bias"] = _arr(p[name]["bias"]).reshape(-1)
    for name in ("ln_scale", "ln_bias"):
        if name in p:
            out[name] = _arr(p[name])
    return _tensors(out)


def mlp_params_from_jax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``ops.FusedDense`` / ``FusedDenseGeluDense`` /
    ``MLP`` from the JAX module's params: the same names, every
    ``(in, out)`` kernel transposed to ``(out, in)``."""
    p = params_np.get("params", params_np)
    return _tensors({k: (_arr(v).T if k.startswith("kernel") else _arr(v))
                     for k, v in p.items()})
