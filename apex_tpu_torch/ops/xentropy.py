"""Memory-saving softmax cross-entropy with label smoothing.

Counterpart of ``apex_tpu/ops/xentropy.py`` (apex ``contrib/xentropy``):
the forward computes the loss from a logsumexp in fp32 whatever the
logits' dtype and saves only the ``(N,)`` logsumexp beside the logits;
the backward recomputes ``softmax(logits)`` from it instead of keeping
an ``(N, V)`` softmax.  The JAX package computes it in XLA; here it is
plain PyTorch.

Loss (label smoothing ε, vocab V):
    loss_i = (1-ε) * (lse_i - logit_i[y_i]) + ε * (lse_i - mean_v logit_iv)
Backward:
    dlogit_iv = softmax_iv - (1-ε)·1[v=y_i] - ε/V
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["softmax_cross_entropy", "softmax_cross_entropy_reference",
           "mean_cross_entropy"]


def softmax_cross_entropy_reference(logits, labels, *,
                                    smoothing: float = 0.0,
                                    ignore_index: Optional[int] = None):
    """Plain composition through ``log_softmax`` (materialises it)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if smoothing > 0.0:
        loss = (1.0 - smoothing) * nll + smoothing * (-logp.mean(-1))
    else:
        loss = nll
    if ignore_index is not None:
        loss = torch.where(labels == ignore_index, torch.zeros_like(loss),
                           loss)
    return loss


class _XentFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, smoothing, ignore_index):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        safe = labels.clamp(0, logits.shape[-1] - 1).long()
        nll = lse - lf.gather(-1, safe[..., None])[..., 0]
        if smoothing > 0.0:
            loss = (1.0 - smoothing) * nll + smoothing * (lse - lf.mean(-1))
        else:
            loss = nll
        if ignore_index is not None:
            loss = torch.where(labels == ignore_index, torch.zeros_like(loss),
                               loss)
        # memory-saving residuals: the logits themselves, labels, (N,) lse
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing, ctx.ignore_index = smoothing, ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        v = logits.shape[-1]
        grad = torch.exp(logits.float() - lse[..., None])
        safe = labels.clamp(0, v - 1).long()
        grad.scatter_add_(-1, safe[..., None], torch.full_like(
            grad[..., :1], -(1.0 - ctx.smoothing)))
        if ctx.smoothing > 0.0:
            grad = grad - ctx.smoothing / v
        if ctx.ignore_index is not None:
            grad = torch.where((labels == ctx.ignore_index)[..., None],
                               torch.zeros_like(grad), grad)
        return (grad * g[..., None]).to(logits.dtype), None, None, None


def softmax_cross_entropy(logits, labels, smoothing: float = 0.0,
                          ignore_index: Optional[int] = None):
    """Per-example cross-entropy, fp32, shape ``labels.shape``; the
    backward recomputes the softmax from the saved ``(N,)`` logsumexp.
    Reduce at the call site, as upstream."""
    return _XentFn.apply(logits, labels, float(smoothing), ignore_index)


def mean_cross_entropy(logits, labels, *, smoothing: float = 0.0,
                       ignore_index: int = -100):
    """CE averaged over valid (non-ignored) tokens, fp32 — the shared
    LM/MLM reduction: padding must not dilute the loss or its gradient."""
    per_tok = softmax_cross_entropy(logits, labels, smoothing, ignore_index)
    n = (labels != ignore_index).sum().clamp(min=1)
    return per_tok.sum() / n
