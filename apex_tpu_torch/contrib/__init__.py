"""apex_tpu_torch.contrib — the reference's contrib entry points whose
implementations live in the port's core package.

Counterpart of the re-exports of ``apex_tpu/contrib/__init__.py``: only
the aliases that resolve onto ported ops (``clip_grad_norm``: ``optim.
clip``), and the class-shaped ``SoftmaxCrossEntropyLoss``.  The contrib
submodules themselves (bottleneck, conv_bias_relu, fmha, focal_loss,
groupbn, index_mul_2d, peer_memory, sparsity, transducer) are not ported
yet (ROADMAP item 12).  The JAX contrib exports no ``group_norm``
alias (its docstring points at ``ops.group_norm``), so neither does this
one.
"""

from apex_tpu_torch.ops.attention import fused_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm as fast_layer_norm
from apex_tpu_torch.ops.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy
from apex_tpu_torch.optim.clip import clip_grad_norm


class SoftmaxCrossEntropyLoss:
    """Class-shaped alias (``apex.contrib.xentropy.
    SoftmaxCrossEntropyLoss``): memory-saving cross entropy with label
    smoothing, per example, fp32."""

    def __init__(self, smoothing: float = 0.0, ignore_index: int = -100):
        self.smoothing = smoothing
        self.ignore_index = ignore_index

    def __call__(self, logits, labels):
        return softmax_cross_entropy(logits, labels, smoothing=self.smoothing,
                                     ignore_index=self.ignore_index)


__all__ = ["fused_attention", "fast_layer_norm", "softmax_cross_entropy",
           "SoftmaxCrossEntropyLoss", "SelfMultiheadAttn",
           "EncdecMultiheadAttn", "clip_grad_norm"]
