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
LayerNorm backward and flash attention (forward, dq, dk/dv).  Slice 3
ports paged serving: the ``PagedEngine`` behind
``InferenceServer(kv_cache="paged")`` (block allocator, prefix trie,
chunked prefill, preemption, speculative decoding, int8/fp8 pages) and
the paged decode path of the models, with kernels for paged attention
and the fused paged decode step.  Slice 4 ports ResNet-50 amp O2
training: ``models.resnet`` (fused BN, space-to-depth stem),
``parallel.SyncBatchNorm`` on one card, ``optim.fused_sgd`` and
``ops.batch_norm``, with kernels for the four fused BatchNorm(+add+ReLU)
passes.  Slice 5 ports fp8 block-scaled Adam moments
(``optim.fused_adam(moment_format="fp8_block_scaled")``, one kernel a
step over every leaf) and Megatron's attention-score softmax
(``ops.fused_scale_mask_softmax``, ``transformer.FusedScaleMaskSoftmax``),
with kernels for the fp8 Adam step and the softmax forward and backward.
Slice 6 ports the rest of ``ops``: the fused GroupNorm(+SiLU)
(``ops.group_norm``, ``GroupNorm``) with kernels for its forward and
backward, the multi-head-attention modules over the flash kernels
(``SelfMultiheadAttn``, ``EncdecMultiheadAttn``), the fused dense and
MLP modules, and the ``contrib`` aliases that resolve onto ported ops.
With it every Pallas kernel of the JAX package has a Hopper
counterpart.  Later slices port amp O1 and the rest of ``optim``, the
remat policies, the ring cache, MoE, ViT and the importers, and (item
10a of ``ROADMAP.md``) data and tensor parallelism on
``torch.distributed``: the mesh of process groups (``core.mesh``),
``parallel.launch``, ``transformer.{parallel_state,mappings,layers,
cross_entropy,random}`` with sequence parallelism, DDP with half and
int8 all-reduces, ZeRO-1/2 and SyncBatchNorm across processes; and
(item 10b's first half) pipeline parallelism: the microbatch
calculators, ``transformer.data.broadcast_data``, the 1F1B and
interleaved schedules over point-to-point exchange
(``transformer.pipeline_parallel``) and the train step on a data × pipe
(× tensor) mesh with stage-local ZeRO (``parallel.pipeline``); (its
second half) context parallelism — ring attention and Ulysses
(``parallel.ring_attention``, ``parallel.ulysses``) — and MoE experts
sharded over a mesh axis; and tensor-parallel paged serving
(``serving.tp_mesh``, ``PagedEngine(mesh=)``, ``InferenceServer(tp=)``).

Entry points take ``device=`` and default to ``"cuda"``; they raise
when CUDA is unavailable unless the caller passes ``device="cpu"``.
The package imports ``torch`` and numpy only, never ``jax``.
"""

from apex_tpu_torch.core.loss_scale import (
    DynamicLossScale,
    LossScaleState,
    NoOpLossScale,
    StaticLossScale,
    all_finite,
)
from apex_tpu_torch.core.precision import PrecisionPolicy
from apex_tpu_torch.ops._dispatch import resolve_device, resolve_impl

__all__ = ["PrecisionPolicy", "LossScaleState", "DynamicLossScale",
           "StaticLossScale", "NoOpLossScale", "all_finite",
           "resolve_device", "resolve_impl"]
