"""Autoregressive generation over the KV-cached decoder models.

Counterpart of ``apex_tpu/models/generate.py``: :func:`init_cache` (an
all-zero dense KV cache), :func:`apply_decode` (one decode-mode model
application), :func:`prefill_tokens` (single-call or chunked prefill),
:func:`sample_logits` (greedy / temperature / top-k / nucleus) and
:func:`generate`.  The serving engine composes the first three, so the
two inference surfaces share one prefill definition.

Randomness is explicit: ``rng`` is a threefry key tensor
(:func:`apex_tpu_torch.ops.fused_sampling.prng_key`), split exactly as
the JAX loop splits its key, so sampled continuations equal the JAX
package's for the same key.  PyTorch runs eagerly: the loop is a Python
loop with no host round trip per token beyond the kernel launches.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from apex_tpu_torch.ops.fused_sampling import gumbel, prng_key, split

__all__ = ["init_cache", "init_paged_cache", "apply_decode",
           "prefill_tokens", "sample_logits", "generate"]

_NEG_INF = -1e30


def _kv_heads(model) -> int:
    """The kv heads each layer of ``model`` holds: its rank's share when
    built on a mesh with a tensor axis (``ParallelAttention.kv_heads``),
    else the config's."""
    for mod in model.modules():
        if hasattr(mod, "kv_heads") and hasattr(mod, "tp_size"):
            return int(mod.kv_heads)
    return int(model.cfg.kv_heads)


def init_cache(model, batch_size: int) -> Dict[str, torch.Tensor]:
    """An all-zero dense KV cache on the model's device: ``key`` and
    ``value`` ``(layers, batch, max_seq_len, kv_heads, head_dim)`` in
    ``cfg.dtype``, and the per-row ``index`` ``(batch,)`` int32.

    With a ``sliding_window`` below ``max_seq_len`` the cache is a ring
    of that many slots: ``key`` / ``value`` ``(layers, batch, window,
    kv_heads, head_dim)`` and ``slot_positions`` ``(batch, window)``
    int32, each slot's position + 1 (0 = empty; one table for every
    layer, which all write the same slots)."""
    cfg = model.cfg
    ring = cfg.ring_window
    b = int(batch_size)
    shape = (cfg.num_layers, b, ring or cfg.max_seq_len, _kv_heads(model),
             cfg.head_dim)
    dev = model.device
    cache = {
        "key": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "value": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "index": torch.zeros((b,), dtype=torch.int32, device=dev),
    }
    if ring is not None:
        cache["slot_positions"] = torch.zeros((b, ring), dtype=torch.int32,
                                              device=dev)
    return cache


def init_paged_cache(model, batch_size: int, *,
                     block_size: Optional[int] = None,
                     num_blocks: Optional[int] = None,
                     kv_dtype: Optional[str] = "config"
                     ) -> Dict[str, torch.Tensor]:
    """The paged pool of ``model`` on its device (the counterpart of the
    JAX ``cache_shapes`` under the paged layout), sized by the config's
    ``kv_block_size`` / ``kv_pool_blocks`` / ``kv_dtype`` unless the
    arguments say otherwise (the serving engine passes its own):
    ``key`` / ``value`` ``(layers, kv_heads, kv_pool_blocks,
    kv_block_size, head_dim)`` (a tensor-parallel model's share of the
    kv heads) in ``cfg.dtype`` or the ``kv_dtype``
    codes, plus ``key_scales`` / ``value_scales`` ``(layers, kv_heads,
    kv_pool_blocks)`` fp32 when quantized; and per row ``block_tables``
    ``(batch, ceil(max_seq_len / kv_block_size))``, ``cursors`` and
    ``chunk_lens`` (every lane real: ``max_seq_len``), int32.  Block 0
    of every pool is the null page; all-zero tables point at it."""
    from apex_tpu_torch.ops.paged_attention import kv_quant_spec

    cfg = model.cfg
    bs = int(cfg.kv_block_size if block_size is None else block_size)
    nb = int(cfg.kv_pool_blocks if num_blocks is None else num_blocks)
    if bs < 1 or nb < 2:
        raise ValueError(
            f"a paged pool needs block_size >= 1 and num_blocks >= 2 (block "
            f"0 is the null page), got {bs} and {nb}")
    store_dt, _ = kv_quant_spec(cfg.kv_dtype if kv_dtype == "config"
                                else kv_dtype)
    dev = model.device
    b = int(batch_size)
    pool = (cfg.num_layers, _kv_heads(model), nb, bs, cfg.head_dim)
    dt = cfg.dtype if store_dt is None else store_dt
    out = {
        "key": torch.zeros(pool, dtype=dt, device=dev),
        "value": torch.zeros(pool, dtype=dt, device=dev),
        "block_tables": torch.zeros(
            (b, -(-cfg.max_seq_len // bs)),
            dtype=torch.int32, device=dev),
        "cursors": torch.zeros((b,), dtype=torch.int32, device=dev),
        "chunk_lens": torch.full((b,), cfg.max_seq_len, dtype=torch.int32,
                                 device=dev),
    }
    if store_dt is not None:
        out["key_scales"] = torch.zeros(pool[:3], device=dev)
        out["value_scales"] = torch.zeros(pool[:3], device=dev)
    return out


@torch.no_grad()
def apply_decode(model, cache, ids, kv_len: Optional[int] = None):
    """One decode-mode application of ``ids`` (b, s) over ``cache``
    (updated in place).  Returns ``(logits, cache)``.  ``kv_len`` is the
    host-side bound ``max(index) + s`` on the cache slots any row can
    see after the call (default: the whole cache)."""
    return model(ids, cache=cache, kv_len=kv_len), cache


@torch.no_grad()
def prefill_tokens(model, cache, prompt_ids, prefill_chunk: int = 0, *,
                   start: int = 0):
    """Run ``prompt_ids`` (b, plen) through the decode chunk path.

    Returns ``(last_logits, cache)``, ``last_logits`` ``(b, vocab)``.
    With ``prefill_chunk`` > 0 and a longer prompt, the prompt runs as
    a leading remainder chunk then fixed-size chunks, as in the JAX
    function.  ``start`` is the cache index the rows start at (host
    side, for the attention bound).
    """
    b, plen = prompt_ids.shape
    if prefill_chunk and plen > prefill_chunk:
        C = prefill_chunk
        r = plen % C or C
        logits, cache = apply_decode(model, cache, prompt_ids[:, :r],
                                     kv_len=start + r)
        for off in range(r, plen, C):
            logits, cache = apply_decode(
                model, cache, prompt_ids[:, off:off + C],
                kv_len=start + off + C)
        return logits[:, -1], cache
    logits, cache = apply_decode(model, cache, prompt_ids,
                                 kv_len=start + plen)
    return logits[:, -1], cache


def sample_logits(logits, key, *, temperature: float,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
    """Sample next tokens from last-position ``logits`` (b, vocab) with
    one threefry ``key`` (2,) for the batch — ``jax.random.categorical``
    over the truncated ``logits / temperature``; ``temperature <= 0`` is
    the fp32 argmax.  Filter order as in the JAX function: top-k, then
    the nucleus over the truncated distribution."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temperature
    asc = None
    if top_k is not None:
        asc = torch.sort(scaled, dim=-1).values
        kth = asc[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, _NEG_INF),
                             scaled)
    if top_p is not None and top_p < 1.0:
        if asc is None:
            desc = torch.sort(scaled, dim=-1).values.flip(-1)
        else:
            rev = asc.flip(-1)
            desc = torch.where(rev < kth, torch.full_like(rev, _NEG_INF),
                               rev)
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        thresh = torch.where(keep, desc, torch.full_like(desc, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        scaled = torch.where(scaled < thresh,
                             torch.full_like(scaled, _NEG_INF), scaled)
    b, vocab = scaled.shape
    noise = gumbel(key.reshape(1, 2), b * vocab).reshape(b, vocab)
    return torch.argmax(noise + scaled, dim=-1).to(torch.int32)


@torch.no_grad()
def generate(model, prompt_ids, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             rng: Optional[torch.Tensor] = None,
             eos_id: Optional[int] = None,
             prefill_chunk: Optional[int] = None):
    """Generate ``max_new_tokens`` continuations of ``prompt_ids``
    ``(batch, prompt_len)`` (one shared length).  Returns
    ``(batch, prompt_len + max_new_tokens)`` int32 ids on the model's
    device.  After ``eos_id`` is produced a row keeps emitting it.
    ``prefill_chunk=None`` is single-call prefill up to 8k prompts and
    2048-token chunks above."""
    cfg = model.cfg
    if cfg.kv_cache == "paged":
        raise ValueError(
            "generate() drives the dense KV cache; a kv_cache='paged' "
            "model needs the block tables the serving engine owns — serve "
            "it through apex_tpu_torch.serving.PagedEngine, or build the "
            "dense twin with dataclasses.replace(cfg, kv_cache='dense')")
    dev = model.device
    prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.int32).to(dev)
    b, prompt_len = prompt_ids.shape
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt_len + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt_len ({prompt_len}) + max_new_tokens "
            f"({max_new_tokens}) exceeds the model's max_seq_len "
            f"({cfg.max_seq_len}) — the KV cache cannot hold the sequence")
    if temperature > 0.0 and rng is None:
        raise ValueError("sampling (temperature>0) needs an rng key")
    if top_k is not None and not 1 <= top_k <= cfg.vocab_size:
        raise ValueError(
            f"top_k must be in [1, vocab_size={cfg.vocab_size}], "
            f"got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if prefill_chunk is None:
        prefill_chunk = 2048 if prompt_len > 8192 else 0
    elif prefill_chunk < 0:
        raise ValueError(
            f"prefill_chunk must be >= 0, got {prefill_chunk}")
    rng = prng_key(0, dev) if rng is None else rng.to(dev)
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p)

    cache = init_cache(model, b)
    last, cache = prefill_tokens(model, cache, prompt_ids, prefill_chunk)
    rng, key = split(rng)
    tok = sample_logits(last, key, **sample)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = [prompt_ids]
    for i in range(max_new_tokens - 1):
        logits, cache = apply_decode(model, cache, tok[:, None],
                                     kv_len=prompt_len + i + 1)
        rng, key = split(rng)
        nxt = sample_logits(logits[:, -1], key, **sample)
        if eos_id is not None:
            done = done | (tok == eos_id)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        out.append(tok[:, None])
        tok = nxt
    out.append(tok[:, None])
    return torch.cat(out, dim=1)
