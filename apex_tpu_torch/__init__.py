"""apex_tpu_torch — the PyTorch/CUDA port of ``apex_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout.  The
JAX package is the reference: every op here ships a plain-PyTorch
composition that the tests hold against the JAX function, and, where
the JAX package has a Pallas TPU kernel, a CUDA kernel written by hand
for ``sm_90a`` (``apex_tpu_torch/csrc``) that is held against that
composition on the card.

Slice 1 ports dense continuous-batching serving: the Llama/GPT decoder
(``models``), the slotted engine, scheduler and threaded server
(``serving``), and the kernels that path launches — RMSNorm/LayerNorm
forward, RoPE and fused decode-step sampling.  Slice 2 ports BERT-Large
amp O2 training: ``amp`` and ``core`` (precision policy, loss scaling,
train state), ``optim.fused_adam``, the cross-entropy, the
full-sequence transformer and ``models.bert``, with kernels for the
LayerNorm backward and flash attention (forward, dq, dk/dv).

Entry points take ``device=`` and default to ``"cuda"``; they raise
when CUDA is unavailable unless the caller passes ``device="cpu"``.
The package imports ``torch`` and numpy only, never ``jax``.
"""

from apex_tpu_torch.ops._dispatch import resolve_device, resolve_impl

__all__ = ["resolve_device", "resolve_impl"]
