"""Rank functions of the port's multi-process CPU tests.

Each function runs on every rank of a gloo group started by
``apex_tpu_torch.transformer.testing.commons.run_on_ranks`` and returns
what the test compares against the JAX package.  This module imports
only torch, numpy and the port, so that a spawned rank stays light;
the JAX side lives in the test files.
"""

import functools

import numpy as np
import torch
import torch.nn as nn

from apex_tpu_torch.transformer.testing import commons

F32 = torch.float32


def _t(a, dtype=F32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _grad_of(fn, *xs):
    """``(fn(*xs), grads)`` of ``fn``'s output summed (or the scalar)."""
    xs = [x.clone().requires_grad_(True) for x in xs]
    y = fn(*xs)
    (y if y.dim() == 0 else y.sum()).backward()
    return y.detach(), [x.grad for x in xs]


# --------------------------------------------------------------------- #
# tensor parallelism: mappings, layers, cross entropy, keys (tp = world)
# --------------------------------------------------------------------- #
def tensor_parallel_checks(rank, world, d):
    from apex_tpu_torch.ops.fused_sampling import prng_key
    from apex_tpu_torch.transformer import mappings as M
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.cross_entropy import (
        vocab_parallel_cross_entropy,
    )
    from apex_tpu_torch.transformer.layers import (
        column_parallel_linear,
        row_parallel_linear,
        vocab_parallel_embedding,
    )
    from apex_tpu_torch.transformer.random import model_parallel_rng_key

    commons.initialize_distributed(tensor_model_parallel_size=world,
                                   device="cpu")
    out = {"tp_size": ps.get_tensor_model_parallel_world_size(),
           "tp_rank": ps.get_tensor_model_parallel_rank(),
           "dp_size": ps.get_data_parallel_world_size()}
    x = _t(d["x"])                                    # (8, 16)

    def chunk(t, dim):
        n = t.shape[dim] // world
        return t.narrow(dim, rank * n, n).contiguous()

    # the seven mappings: forward and the input's gradient of a loss
    # weighting each output element by w (so no gradient is trivial)
    def fwd_bwd(fn, x_in, w):
        _, (g,) = _grad_of(lambda t: (fn(t) * w).sum(), x_in)
        return fn(x_in.detach()), g
    wt = _t(d["w_out"])                               # (8, 16) weights
    out["copy"] = fwd_bwd(M.copy_to_tensor_parallel_region, x, wt)
    out["reduce"] = fwd_bwd(M.reduce_from_tensor_parallel_region,
                            x * (rank + 1), wt)
    out["scatter"] = fwd_bwd(M.scatter_to_tensor_parallel_region, x,
                             chunk(wt, 1))
    out["gather"] = fwd_bwd(M.gather_from_tensor_parallel_region,
                            chunk(x, 1), wt)
    out["rs_seq"] = fwd_bwd(
        lambda t: M.reduce_scatter_to_sequence_parallel_region(t, dim=0),
        x * (rank + 1), chunk(wt, 0))
    out["gather_seq"] = fwd_bwd(
        lambda t: M.gather_from_sequence_parallel_region(t, dim=0),
        chunk(x, 0), wt)
    out["scatter_seq"] = fwd_bwd(
        lambda t: M.scatter_to_sequence_parallel_region(t, dim=0), x,
        chunk(wt, 0))

    # column -> relu -> row against dense, forward and weight gradients
    w1, w2 = _t(d["w1"]), _t(d["w2"])                 # torch (out, in)

    def block(w1s, w2s, sp):
        xin = chunk(x, 0) if sp else x
        h = torch.relu(column_parallel_linear(xin, w1s,
                                              sequence_parallel=sp,
                                              seq_dim=0))
        y = row_parallel_linear(h, w2s, sequence_parallel=sp, seq_dim=0)
        return (y ** 2).sum(), y
    for sp in (False, True):
        w1s = chunk(w1, 0).requires_grad_(True)
        w2s = chunk(w2, 1).requires_grad_(True)
        loss, y = block(w1s, w2s, sp)
        # the loss of each rank's (sequence) part; summed over ranks it
        # is the whole loss under SP, the whole loss itself without
        loss.backward()
        out[f"col_row_sp{int(sp)}"] = (y.detach(), w1s.grad, w2s.grad)

    # vocab-parallel embedding and cross entropy
    table = _t(d["table"])                            # (64, 8)
    ids = torch.from_numpy(d["ids"]).long()
    out["embedding"] = vocab_parallel_embedding(ids, chunk(table, 0))
    logits, labels = _t(d["logits"]), torch.from_numpy(d["labels"]).long()
    for sm in (0.0, 0.1):
        ls = chunk(logits, 1).requires_grad_(True)
        nll = vocab_parallel_cross_entropy(ls, labels, smoothing=sm)
        nll.mean().backward()
        out[f"xent_{sm}"] = (nll.detach(), ls.grad)
    out["key"] = model_parallel_rng_key(prng_key(d["seed"]))
    out["mha"] = _mha_checks(d)
    return out


def _mha_checks(d):
    """``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` built on the mesh
    and without one from the same weights: outputs, input and weight
    gradients of a loss weighting the output."""
    from apex_tpu_torch.ops.multihead_attn import (
        EncdecMultiheadAttn,
        SelfMultiheadAttn,
    )

    q, kv, w = _t(d["mha_q"]), _t(d["mha_kv"]), _t(d["mha_w"])
    out = {}
    for name, cls, kw, args in (
            ("self", SelfMultiheadAttn,
             dict(bias=True, include_norm_add=True, causal=True), (q,)),
            ("encdec", EncdecMultiheadAttn, dict(bias=True), (q, kv))):
        torch.manual_seed(3)
        with commons.without_mesh():
            whole = cls(64, 4, device="cpu", **kw)
        sharded = cls(64, 4, device="cpu", **kw)
        sharded.load_state_dict(whole.state_dict())
        for tag, mod in (("mesh", sharded), ("whole", whole)):
            xs = [a.clone().requires_grad_(True) for a in args]
            y = mod(*xs)
            (y * w).sum().backward()
            out[f"{name}_{tag}"] = dict(
                y=y.detach(), dx=[x.grad for x in xs],
                grads={n: p.grad for n, p in mod.named_parameters()})
    return out


# --------------------------------------------------------------------- #
# a tiny GPT, tensor- (and data-) parallel
# --------------------------------------------------------------------- #
def _gpt_loss_and_grads(model, ids, labels, dropout_seed=None):
    from apex_tpu_torch.models.gpt import gpt_loss_fn

    logits = model(ids, deterministic=dropout_seed is None,
                   dropout_seed=dropout_seed)
    loss = gpt_loss_fn(logits.float(), labels)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def gpt_tp_checks(rank, world, d, tp, sequence_parallel):
    """Loss and this rank's gradients of the tiny GPT at ``tp`` tensor
    ranks (data parallel over the rest, the gradients averaged by the
    DDP all-reduce), from the whole weights ``d["sd"]``; with
    ``d["dropout"]`` also the same with dropout, at tp and without a
    mesh."""
    from apex_tpu_torch.parallel.ddp import all_reduce_mean_grads
    from apex_tpu_torch.transformer import parallel_state as ps

    commons.initialize_distributed(tensor_model_parallel_size=tp,
                                   device="cpu")
    sd = {k: _t(v) for k, v in d["sd"].items()}
    ids = torch.from_numpy(d["ids"]).long()
    labels = torch.from_numpy(d["labels"]).long()
    dp, dp_rank = ps.get_data_parallel_world_size(), ps.get_data_parallel_rank()
    b = ids.shape[0] // dp
    mine = slice(dp_rank * b, (dp_rank + 1) * b)
    kw = dict(device="cpu", state_dict=sd, sequence_parallel=sequence_parallel,
              **d["cfg"])
    model = commons.standalone_gpt(**kw)
    loss, grads = _gpt_loss_and_grads(model, ids[mine], labels[mine])
    names = list(grads)
    grads = dict(zip(names, all_reduce_mean_grads(
        [grads[n] for n in names], "data")))
    loss = all_reduce_mean_grads(loss, "data")
    out = {"loss": loss, "grads": grads, "tp_rank": ps.get_tensor_model_parallel_rank()}
    if d.get("dropout"):
        cfg = dict(d["cfg"], attention_dropout=0.1, hidden_dropout=0.1)
        kw = dict(device="cpu", state_dict=sd,
                  sequence_parallel=sequence_parallel, **cfg)
        model = commons.standalone_gpt(**kw)
        out["drop_loss"], out["drop_grads"] = _gpt_loss_and_grads(
            model, ids, labels, dropout_seed=1234)
        with commons.without_mesh():
            whole = commons.standalone_gpt(**kw)
            out["drop_loss_tp1"], out["drop_grads_tp1"] = \
                _gpt_loss_and_grads(whole, ids, labels, dropout_seed=1234)
    if d.get("bert"):
        out.update(_bert_tp(ids, labels, sequence_parallel))
    for cf, sd_moe in d.get("moe", {}).items():
        out[f"moe_{cf}"] = _moe_tp(ids, labels, sequence_parallel, cf,
                                   sd_moe, d["cfg"])
    if "moe_nosp" in d:
        out["moe_nosp"] = _moe_tp(ids, labels, False, 4.0, d["moe_nosp"],
                                  d["cfg"])
    if "moe_data" in d:
        out["moe_data"] = _moe_data_axis(d["moe_data"])
    if "moe_sp_data" in d:
        out["moe_sp_data"] = _moe_gpt_data_axis(ids, labels,
                                                d["moe_sp_data"], d["cfg"])
    if "serve" in d:
        out["serve"] = serving_checks(rank, d["serve"], d["sd"], d["cfg"])
    if d.get("pipe"):
        out["broadcast"] = _broadcast_checks(rank)
        out["pipe"] = pipeline_checks(rank, world, d["pipe"])
    if "cp" in d:
        out["cp"] = context_parallel_checks(rank, world, d["cp"])
    return out


def _broadcast_data_of(rank):
    """The batch rank ``rank`` passes to ``broadcast_data``."""
    return {"text": torch.arange(12).reshape(3, 4) + 100 * rank,
            "mask": torch.arange(6).reshape(2, 3) % 2 + rank}


def _broadcast_checks(rank):
    """``broadcast_data`` over this rank's tensor group: every rank
    passes its own batch and keeps the group's first rank's."""
    from apex_tpu_torch.transformer.data import broadcast_data

    return broadcast_data(["text", "mask"], _broadcast_data_of(rank),
                          torch.int64)


def _moe_tp(ids, labels, sequence_parallel, cf, sd, cfg):
    """The tiny GPT with MoE layers (4 experts, top 2, capacity factor
    ``cf``) on the mesh and without one, from the whole weights ``sd``:
    the CE loss, the aux term and every gradient."""
    from apex_tpu_torch.models import moe_aux_loss

    kw = dict(cfg, device="cpu", state_dict={k: _t(v) for k, v in sd.items()},
              sequence_parallel=sequence_parallel, num_moe_experts=4,
              moe_top_k=2, moe_capacity_factor=cf)

    def run(model):
        from apex_tpu_torch.models.gpt import gpt_loss_fn

        ce = gpt_loss_fn(model(ids).float(), labels)
        aux = moe_aux_loss(model)
        (ce + aux).backward()
        return dict(loss=ce.detach(), aux=aux.detach(), grads={
            n: p.grad for n, p in model.named_parameters()})
    out = run(commons.standalone_gpt(**kw))
    with commons.without_mesh():
        out["whole"] = run(commons.standalone_gpt(**kw))
    return out


def _bert_tp(ids, labels, sequence_parallel):
    """A tiny BERT (key padding, masked positions, dropout) on the mesh
    against the same BERT without one: logits, pooled, loss, gradients."""
    from apex_tpu_torch.models.bert import bert_mlm_loss_fn

    cfg = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               max_seq_len=32, attention_dropout=0.1, hidden_dropout=0.1,
               sequence_parallel=sequence_parallel)
    with commons.without_mesh():
        whole = commons.standalone_bert(7, device="cpu", **cfg)
    sd = whole.state_dict()
    mask = torch.ones_like(ids)
    mask[0, 10:] = 0
    pos = torch.arange(4).repeat(ids.shape[0], 1) * 3 + 1
    mlm_labels = torch.gather(labels, 1, pos)

    def run(model):
        logits, pooled = model(ids, attention_mask=mask, mlm_positions=pos,
                               deterministic=False, dropout_seed=55)
        loss = bert_mlm_loss_fn(logits.float(), mlm_labels)
        loss.backward()
        return dict(logits=logits.detach(), pooled=pooled.detach(),
                    loss=loss.detach(),
                    grads={n: p.grad for n, p in model.named_parameters()})
    out = {"bert": run(commons.standalone_bert(device="cpu", state_dict=sd,
                                               **cfg))}
    with commons.without_mesh():
        out["bert_tp1"] = run(commons.standalone_bert(
            device="cpu", state_dict=sd, **cfg))
    return out


# --------------------------------------------------------------------- #
# data parallelism: DDP all-reduce, SyncBatchNorm, mesh bookkeeping
# --------------------------------------------------------------------- #
def ddp_checks(rank, world, d):
    from apex_tpu_torch.parallel import ddp
    from apex_tpu_torch.transformer import parallel_state as ps

    mesh = commons.initialize_distributed(device="cpu")
    out = {"world": ps.get_data_parallel_world_size(),
           "rank": ps.get_data_parallel_rank(),
           "line": mesh.line("data")}
    grads = [_t(g[rank]) for g in d["grads"]]
    for name, kw in (("mean", {}), ("sum", dict(average=False)),
                     ("bf16", dict(allreduce_dtype=torch.bfloat16)),
                     ("int8", dict(allreduce_dtype="int8")),
                     ("int8_sum", dict(allreduce_dtype="int8",
                                       average=False))):
        out[name] = ddp.all_reduce_mean_grads(grads, "data", **kw)
    special = [_t(g[rank]) for g in d["special"]]
    out["int8_special"] = ddp.all_reduce_mean_grads(
        special, "data", allreduce_dtype="int8")
    # replicate: every rank ends with rank 0's tensors
    p = torch.full((3,), float(rank))
    ddp.replicate([p])
    out["replicated"] = p
    out["shard"] = ddp.shard_batch(torch.arange(8 * world).view(-1, 1) * 1.0)
    return out


def syncbn_checks(rank, world, d):
    """SyncBatchNorm over the data axis, fused and not: outputs, running
    statistics and the gradients of a loss weighting the output."""
    from apex_tpu_torch.ops.batch_norm import batch_norm_train
    from apex_tpu_torch.parallel.sync_batchnorm import (
        SyncBatchNorm,
        convert_syncbn_model,
        sync_batch_norm_stats,
    )

    commons.initialize_distributed(device="cpu")
    x = _t(d["x"][rank])                          # (N, H, W, C) local
    dy = _t(d["dy"][rank])
    res = _t(d["res"][rank])
    w, b = _t(d["w"]), _t(d["b"])
    out = {"stats": sync_batch_norm_stats(x, ("data",),
                                          reduce_dims=(0, 1, 2))}
    for fused in (False, True):
        bn = SyncBatchNorm(x.shape[-1], axis_names=("data",), fused=fused,
                           act="relu", device="cpu")
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        xi = x.clone().requires_grad_(True)
        ri = res.clone().requires_grad_(True)
        y = bn(xi, residual=ri)
        (y * dy).sum().backward()
        out[f"module_{int(fused)}"] = dict(
            y=y.detach(), dx=xi.grad, dres=ri.grad, dw=bn.weight.grad,
            db=bn.bias.grad, mean=bn.mean.clone(), var=bn.var.clone())
    xi = x.clone().requires_grad_(True)
    y, mean, var = batch_norm_train(xi, w, b, axis_names=("data",))
    (y * dy).sum().backward()
    out["op"] = dict(y=y.detach(), mean=mean, var=var, dx=xi.grad)
    # convert_syncbn_model turns a local BN into the data group's
    model = nn.Sequential(SyncBatchNorm(x.shape[-1], device="cpu"))
    convert_syncbn_model(model)
    out["converted"] = model(x).detach()
    return out


# --------------------------------------------------------------------- #
# ZeRO
# --------------------------------------------------------------------- #
class TinyMLP(nn.Module):
    """The JAX tests' MLP: tanh(x w1 + b1) w2 + b2."""

    def __init__(self):
        super().__init__()
        self.l1 = nn.Linear(16, 33)
        self.l2 = nn.Linear(33, 1)

    def forward(self, x):
        return self.l2(torch.tanh(self.l1(x)))


def zero_checks(rank, world, d, steps=3):
    """Three zero-mode steps of each optimizer on the MLP over the data
    axis, each rank on its slice of the batch; the params after, and the
    reduce-scatter of raw gradients."""
    from apex_tpu_torch.core.train_state import MixedPrecisionTrainState
    from apex_tpu_torch.optim import fused_adam
    from apex_tpu_torch.parallel import distributed_optim as Z

    commons.initialize_distributed(device="cpu")
    x = _t(d["x"][rank])
    y = _t(d["y"][rank])
    out = {}
    g = [_t(a[rank]) for a in d["grads"]]
    for stage in (1, 2):
        for rd in (None, "int8"):
            out[f"rs_{stage}_{rd}"] = Z.reduce_scatter_mean_grads(
                g, "data", reduce_dtype=rd, stage=stage)
    opts = {
        "adam_s2": (lambda: Z.distributed_fused_adam(1e-2), 2, None),
        "adam_s1": (lambda: Z.distributed_fused_adam(1e-2), 1, None),
        "adam_int8": (lambda: fused_adam(1e-2), 2, "int8"),
        "lamb_s2": (lambda: Z.distributed_fused_lamb(
            1e-2, shard_axis="data"), 2, None),
    }
    for name, (make, stage, rd) in opts.items():
        model = TinyMLP()
        model.load_state_dict({k: _t(v) for k, v in d["params"].items()})
        state = MixedPrecisionTrainState.create(
            model=model, optimizer=make(),
            zero=Z.ZeroConfig(axis="data", stage=stage, reduce_dtype=rd))
        for _ in range(steps):
            loss = torch.mean((model(x) - y) ** 2)
            state.scale_loss(loss).backward()
            state.apply_gradients()
        out[name] = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
        out[name + "_masters"] = state.master_params()
    return out


# --------------------------------------------------------------------- #
# pipeline parallelism (run after the tensor-parallel checks, on a pipe
# mesh built in their place)
# --------------------------------------------------------------------- #
class ToyStage(nn.Module):
    """The JAX tests' residual MLP stage, x + tanh(x w1 + b1) w2, over a
    stack of such layers when the weights lead with a layer axis."""

    def __init__(self, w1, b1, w2):
        super().__init__()
        self.w1, self.b1, self.w2 = (nn.Parameter(_t(a)) for a in (w1, b1, w2))


def toy_stage_fn(stage, x):
    if stage.w1.dim() == 2:
        return x + torch.tanh(x @ stage.w1 + stage.b1) @ stage.w2
    for w1, b1, w2 in zip(stage.w1, stage.b1, stage.w2):
        x = x + torch.tanh(x @ w1 + b1) @ w2
    return x


def _toy_grads(stage):
    return [stage.w1.grad, stage.b1.grad, stage.w2.grad]


def _pipe_mesh(**kw):
    """Tear down the current mesh and build ``kw``'s (a collective)."""
    from apex_tpu_torch.core import mesh as mesh_lib

    mesh_lib.destroy_mesh()
    return mesh_lib.initialize_mesh(**kw)


def _mean_sq(y, i):
    return torch.mean(y ** 2)


def pipeline_checks(rank, world, d):
    """The schedules on a pipe mesh of ``world`` ranks: 1F1B at each M
    of ``d["ms"]``; with ``d["toy_v"]`` also the interleaved schedule at
    V = 2, ``spmd_pipeline`` and the overflow sync; with ``d["gpt"]``
    the GPT closure at pipe 2 (tensor 2 with ``d["tp"]``); with
    ``d["zero"]`` the ZeRO-2 step at pipe 2 x data 2."""
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as S

    out = {}
    toy = d["toy"]
    batch = _t(d["toy_batch"])
    mesh = _pipe_mesh(pipeline_model_parallel_size=world)
    r = mesh.axis_rank("pipe")
    for m in d["ms"]:
        stage = ToyStage(*(a[r] for a in toy))
        loss, _ = S.forward_backward_pipelining_without_interleaving(
            toy_stage_fn, _mean_sq, stage, batch[:m * d["mb"]],
            num_microbatches=m)
        out[f"1f1b_{m}"] = dict(loss=loss, grads=_toy_grads(stage),
                                peak=S.last_run["peak_live"])
    if "toy_v" in d:
        m = 2 * world
        chunks = [ToyStage(*(a[c, r] for a in d["toy_v"]))
                  for c in range(2)]
        loss, _ = S.forward_backward_pipelining_with_interleaving(
            toy_stage_fn, _mean_sq, chunks, batch[:m * d["mb"]],
            num_microbatches=m)
        out["interleaved"] = dict(loss=loss, grads=[
            _toy_grads(c) for c in chunks])
        stage = ToyStage(*(a[r] for a in toy))
        mbs = batch[:3 * d["mb"]].reshape(3, d["mb"], *batch.shape[1:])
        outs = S.spmd_pipeline(toy_stage_fn, stage, mbs)
        torch.mean(outs ** 2).backward()
        out["spmd"] = dict(outs=outs.detach(), grads=_toy_grads(stage))
        chunks = [ToyStage(*(a[c, r] for a in d["toy_v"]))
                  for c in range(2)]
        mbs = batch[:2 * world * d["mb"]].reshape(2 * world, d["mb"],
                                                  *batch.shape[1:])
        outs = S.spmd_pipeline_interleaved(toy_stage_fn, chunks, mbs)
        torch.mean(outs ** 2).backward()
        out["spmd_interleaved"] = dict(outs=outs.detach(), grads=[
            _toy_grads(c) for c in chunks])
        out["overflow"] = _overflow_checks(r)
        out["p2p"] = _p2p_checks(r)
    if "gpt" in d:
        tp = 2 if d.get("tp") else 1
        mesh = _pipe_mesh(pipeline_model_parallel_size=2,
                          tensor_model_parallel_size=tp)
        out["gpt"] = _gpt_pipeline(d["gpt"], mesh.axis_rank("pipe"), tp,
                                   mesh.axis_rank("tensor"))
        out["gpt"]["coords"] = (mesh.axis_rank("pipe"),
                                mesh.axis_rank("tensor"))
    if "zero" in d:
        out["zero"] = _zero_pipeline_step(
            d["zero"], _pipe_mesh(pipeline_model_parallel_size=2))
    return out


def _overflow_checks(r):
    """``sync_grad_overflow``: an inf on rank 1 makes every rank's
    gradients NaN; finite gradients come back unchanged."""
    from apex_tpu_torch.parallel.pipeline import sync_grad_overflow

    g = {"g": torch.arange(4.0) + r}
    kept = sync_grad_overflow(g)["g"].clone()
    bad = torch.ones(4)
    if r == 1:
        bad[0] = float("inf")
    return dict(finite=kept, poisoned=sync_grad_overflow([bad])[0])


P2P_ACT = torch.arange(6.0).reshape(2, 3) + 10
P2P_GRAD = -torch.arange(6.0).reshape(2, 3)


def _p2p_checks(r):
    """The unfused helpers at pipe 2: rank 0's activation reaches rank
    1, rank 1's gradient reaches rank 0; the end with no neighbour
    receives None and sends nothing; a receive with no device named is
    a CUDA one, so on the CPU it raises before posting anything."""
    from apex_tpu_torch.transformer.pipeline_parallel import p2p

    out = {}
    shape, f32 = (2, 3), torch.float32
    try:
        (p2p.recv_forward if r else p2p.recv_backward)(shape, f32)
    except RuntimeError:
        out["default_device_raises"] = True
    if r == 0:
        p2p.send_forward(P2P_ACT)
        out["recv_backward"] = p2p.recv_backward(shape, f32, device="cpu")
        out["recv_forward"] = p2p.recv_forward(shape, f32, device="cpu")
        p2p.send_backward(P2P_GRAD)
    else:
        out["recv_forward"] = p2p.recv_forward(shape, f32, device="cpu")
        p2p.send_backward(P2P_GRAD)
        out["recv_backward"] = p2p.recv_backward(shape, f32, device="cpu")
        p2p.send_forward(P2P_ACT)
    return out


def _gpt_pipeline(d, r, tp, tp_rank):
    """A tiny GPT through the 1F1B schedule: the stage built by
    ``build_model`` from the JAX stack, the embedding, positions, final
    norm and head closed over the pipelined region
    (``gpt_pipeline_forward_backward``).  Returns the loss and every
    gradient of this rank."""
    import functools

    from apex_tpu_torch.models import (
        GPTConfig,
        GPTModel,
        gpt_pipeline_forward_backward,
    )
    from apex_tpu_torch.models.jax_import import (
        closure_params_from_jax,
        stage_params_from_jax,
    )
    from apex_tpu_torch.models.transformer import ParallelTransformerLayer
    from apex_tpu_torch.transformer.pipeline_parallel import build_model

    cfg = GPTConfig.tiny(**d["cfg"], num_layers=0, tie_embeddings=False,
                         causal=True, sequence_parallel=tp > 1)
    closure = GPTModel(cfg, device="cpu")
    closure.load_state_dict(closure_params_from_jax(
        d["closure"], tp_rank=tp_rank, tp=tp))
    stage_fn, chunks = build_model(
        functools.partial(ParallelTransformerLayer, cfg), d["layers"], 2,
        device="cpu")
    stage = chunks[0]
    stage.load_state_dict(stage_params_from_jax(
        d["stacked"], stage=r, tp_rank=tp_rank, tp=tp))
    loss, _ = gpt_pipeline_forward_backward(
        closure, stage_fn, stage, torch.from_numpy(d["ids"]).long(),
        torch.from_numpy(d["labels"]).long(), num_microbatches=d["m"])
    return dict(loss=loss, stage={
        n: p.grad for n, p in stage.named_parameters()}, closure={
        n: p.grad for n, p in closure.named_parameters()})


def _zero_pipeline_step(d, mesh):
    """Two steps of ``wrap_pipeline_step``: 1F1B over this rank's two
    layers of the toy stack, the overflow sync, and the stage-local
    ZeRO-2 FusedAdam update over the data group.  Returns the data-mean
    losses and the stage's parameters after."""
    from apex_tpu_torch.core.train_state import MixedPrecisionTrainState
    from apex_tpu_torch.optim import fused_adam
    from apex_tpu_torch.parallel import pipeline as pl
    from apex_tpu_torch.parallel.ddp import all_reduce_mean_grads
    from apex_tpu_torch.parallel.distributed_optim import ZeroConfig

    r = mesh.axis_rank("pipe")
    staged = pl.stage_split([_t(a) for a in d["params"]], 2)
    model = nn.Module()
    model.stages = ToyStage(*pl.local_stage(staged))
    state = pl.stage_local_zero(MixedPrecisionTrainState.create(
        model=model, optimizer=fused_adam(1e-2),
        zero=ZeroConfig(axis="data", stage=2)), num_stages=2)

    def body(state, mbs, labels):
        def loss_fn(y, i):
            return torch.mean((y - labels[i]) ** 2)
        loss, _ = pl.run_1f1b(toy_stage_fn, loss_fn, state.model.stages, mbs)
        pl.sync_grad_overflow(state.model)
        state.apply_gradients()
        return all_reduce_mean_grads(loss, "data")

    step = pl.wrap_pipeline_step(body, state=state)
    losses = [step(_t(d["x"]), _t(d["y"])) for _ in range(2)]
    return dict(losses=torch.stack(losses), stage=r,
                params=[p.detach() for p in model.stages.parameters()],
                layout=pl.pipeline_state_layout(state))


# --------------------------------------------------------------------- #
# the MoE expert axis over data, context parallelism
# --------------------------------------------------------------------- #
def _moe_data_axis(d):
    """An MoE layer with ``expert_axis="data"`` on the current mesh
    (tensor 2 x data 2): this data rank's batch rows, its block of the
    experts; the output, the aux term and the gradients after the DDP
    mean (the experts left out of it), the parameters after a ZeRO-2
    FusedAdam step over data, and the same layer without a mesh on the
    whole batch, its loss the data mean of the ranks', with a plain
    FusedAdam step."""
    from apex_tpu_torch.core import mesh as mesh_lib
    from apex_tpu_torch.core.train_state import MixedPrecisionTrainState
    from apex_tpu_torch.optim import fused_adam
    from apex_tpu_torch.parallel.ddp import all_reduce_mean_grads
    from apex_tpu_torch.parallel.distributed_optim import ZeroConfig
    from apex_tpu_torch.transformer.moe import MoEConfig, MoEMLP

    cfg = MoEConfig(**d["cfg"], expert_axis="data")
    mesh = mesh_lib.get_mesh()
    dp, r = mesh.axis_size("data"), mesh.axis_rank("data")
    x, w = _t(d["x"]), _t(d["w"])

    def run(layer, rows, n):
        sd = {k: _t(v) for k, v in d["params"].items()}
        if layer.ep_size > 1:
            e = layer.w1.shape[0]
            sd = {k: (v if k == "gate" else v[r * e:(r + 1) * e])
                  for k, v in sd.items()}
        layer.load_state_dict(sd)
        y, aux = layer(x[rows])
        ((y * w[rows]).sum() / n + aux).backward()
        return y.detach(), aux.detach()

    b = x.shape[0] // dp
    layer = MoEMLP(cfg, device="cpu")
    y, aux = run(layer, slice(r * b, (r + 1) * b), 1)
    params = [p for _, p in layer.named_parameters()]
    grads = all_reduce_mean_grads([p.grad for p in params], "data",
                                  params=params)
    names = [n for n, _ in layer.named_parameters()]
    out = dict(y=y, aux=aux, grads=dict(zip(names, grads)),
               ep=(layer.ep_size, layer.ep_rank),
               axes=[getattr(p, "expert_axis", None) for p in params])
    # one ZeRO-2 FusedAdam step over data: the experts stay out of the
    # shards, updated whole from their mean gradient
    state = MixedPrecisionTrainState.create(
        model=layer, optimizer=fused_adam(1e-2),
        zero=ZeroConfig(axis="data", stage=2))
    state.apply_gradients()
    out["zero_params"] = {n: p.detach().clone()
                          for n, p in layer.named_parameters()}
    with commons.without_mesh():
        whole = MoEMLP(cfg, device="cpu")
        wy, waux = run(whole, slice(None), dp)
        out["whole"] = dict(y=wy, aux=waux, grads={
            n: p.grad for n, p in whole.named_parameters()})
        state = MixedPrecisionTrainState.create(
            model=whole, optimizer=fused_adam(1e-2))
        state.apply_gradients()
        out["whole"]["params"] = {n: p.detach().clone()
                                  for n, p in whole.named_parameters()}
    return out


def _moe_gpt_data_axis(ids, labels, sd, cfg):
    """The tiny MoE GPT at tp 2 + SP with its experts over the data axis
    (tensor 2 x data 2; the layer's whole-expert branch under SP): this
    data rank's batch rows, the gradients averaged over data by
    ``DistributedDataParallel.mean_grads([p.grad ...])`` as its
    docstring calls it (no ``params=``) and the same reduction without
    parameters refused; the unsharded model on the whole batch."""
    from apex_tpu_torch.models import moe_aux_loss
    from apex_tpu_torch.models.gpt import gpt_loss_fn
    from apex_tpu_torch.parallel.ddp import (
        DistributedDataParallel,
        all_reduce_mean_grads,
    )
    from apex_tpu_torch.transformer import parallel_state as ps

    kw = dict(cfg, device="cpu", state_dict={k: _t(v) for k, v in sd.items()},
              sequence_parallel=True, num_moe_experts=4, moe_top_k=2,
              moe_capacity_factor=1.25, moe_expert_axis="data")

    def run(model, rows):
        ce = gpt_loss_fn(model(ids[rows]).float(), labels[rows])
        aux = moe_aux_loss(model)
        (ce + aux).backward()
        return dict(loss=ce.detach(), aux=aux.detach())

    dp, r = ps.get_data_parallel_world_size(), ps.get_data_parallel_rank()
    b = ids.shape[0] // dp
    model = commons.standalone_gpt(**kw)
    ddp = DistributedDataParallel()
    ddp.replicate(model)
    out = run(model, slice(r * b, (r + 1) * b))
    names, params = zip(*model.named_parameters())
    try:
        all_reduce_mean_grads([p.grad for p in params], "data")
    except ValueError as e:
        out["refused"] = str(e)
    out["grads"] = dict(zip(names, ddp.mean_grads([p.grad for p in params])))
    out["axes"] = {n: getattr(p, "expert_axis", None)
                   for n, p in zip(names, params)}
    with commons.without_mesh():
        whole = commons.standalone_gpt(**kw)
        out["whole"] = run(whole, slice(None))
        out["whole"]["grads"] = {n: p.grad
                                 for n, p in whole.named_parameters()}
    return out


def _cp_run(fn, q, k, v, w, **kw):
    """``fn(q, k, v, **kw)`` and the gradients of ``sum(o * w)``."""
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fn(*xs, **kw)
    (o * w).sum().backward()
    return o.detach(), [t.grad for t in xs]


def context_parallel_checks(rank, world, d):
    """Ring attention and Ulysses on a context mesh of ``world`` ranks
    (and, on 4 ranks, context 2 x data 2): outputs and the whole inputs'
    gradients of a weighted sum, causal and not, GQA, uneven lengths,
    remat, windows, dropout on the local chunks, and the divisibility
    errors."""
    from apex_tpu_torch.parallel import (
        ring_self_attention,
        ulysses_attention,
        ulysses_self_attention,
    )

    q, k, v, w = (_t(d[n]) for n in ("q", "k", "v", "w"))
    mesh = _pipe_mesh(context_parallel_size=world)
    run = functools.partial(_cp_run, q=q, k=k, v=v, w=w, mesh=mesh)
    out = {}
    for causal in (False, True):
        out[f"ring_{causal}"] = run(ring_self_attention, causal=causal)
        out[f"uly_{causal}"] = run(ulysses_self_attention, causal=causal)
    out["ring_remat"] = run(ring_self_attention, causal=True, remat=True)
    half = k.shape[1] // 2
    out["ring_uneven"] = _cp_run(ring_self_attention, q, k[:, :half],
                                 v[:, :half], w, mesh=mesh, causal=True)
    out["uly_window"] = run(ulysses_self_attention, causal=True, window=5)
    s = q.shape[1] // world
    mine = slice(rank * s, (rank + 1) * s)
    out["uly_dropout"] = ulysses_attention(
        q[:, mine], k[:, mine], v[:, mine], "context", causal=True,
        dropout_rate=d["rate"], dropout_seed=d["seed"], mesh=mesh)
    errors = []
    for qq, kk in ((q[:, :, :3], k[:, :, :1]), (q, k[:, :, :1].repeat(
            1, 1, 3, 1))):
        try:
            ulysses_attention(qq[:, mine], kk[:, mine], kk[:, mine],
                              mesh=mesh)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    if world == 4:
        mesh = _pipe_mesh(context_parallel_size=2, data_parallel_size=2)
        for name, fn in (("ring", ring_self_attention),
                         ("uly", ulysses_self_attention)):
            out[f"{name}_dp"] = _cp_run(fn, q, k, v, w, mesh=mesh,
                                        causal=True, batch_spec="data")
    return out


# --------------------------------------------------------------------- #
# tensor-parallel paged serving (tp = world = 2)
# --------------------------------------------------------------------- #
def _paged_op_checks(mesh, cases):
    """Each case through the paged op twice: on this rank's shard, as a
    tensor-parallel layer calls it (its q heads from ``tp_head_shards``,
    its kv heads of the pool and of the new rows), and on the whole
    pool; returns ``(sharded, whole)`` pairs of the rank's output heads
    and, for the fused decode step, of its written pages and scales."""
    from apex_tpu_torch.models.jax_import import shard_paged_pool
    from apex_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_decode_fused,
        tp_head_shards,
    )

    tp, r = mesh.axis_size("tensor"), mesh.axis_rank("tensor")
    names = dict(k_pages="key", v_pages="value", k_scales="key_scales",
                 v_scales="value_scales")
    out = {}
    for name, c in cases.items():
        c = {k: (torch.from_numpy(np.ascontiguousarray(v))
                 if isinstance(v, np.ndarray) else v)
             for k, v in c.items()}
        h, hk = c["q"].shape[2], c["k_pages"].shape[0]
        (qlo, qhi), (klo, khi) = tp_head_shards(h, hk, tp)[r]
        # the rank's share of a one-layer pool, as an engine's cache
        pool = shard_paged_pool({names[k]: c[k][None] for k in names
                                 if k in c}, r, tp)
        local = dict(c, **{k: pool[names[k]][0] for k in names if k in c})
        local["q"] = c["q"][:, :, qlo:qhi]
        for k in ("k_new", "v_new"):
            if k in c:
                local[k] = c[k][:, :, klo:khi]
        whole = dict(c, **{k: c[k].clone() for k in names if k in c})
        if "k_new" in c:
            def op(a):
                extra = {k: a[k] for k in ("k_scales", "v_scales",
                                           "chunk_lens") if k in a}
                return paged_decode_fused(
                    a["q"], a["k_new"], a["v_new"], a["k_pages"],
                    a["v_pages"], a["tables"], a["lengths"],
                    max_seq_len=a["max_seq_len"], **extra)
            got, want = op(local), op(whole)
            out[name] = dict(o=(got[0], want[0][:, :, qlo:qhi]),
                             pools=[(g, w[klo:khi])
                                    for g, w in zip(got[1:], want[1:])])
        else:
            def op(a):
                extra = {k: a[k] for k in ("k_scales", "v_scales") if k in a}
                return paged_attention(a["q"], a["k_pages"], a["v_pages"],
                                       a["tables"], a["lengths"], **extra)
            out[name] = dict(o=(op(local), op(whole)[:, :, qlo:qhi]))
    return out


def _engine_tokens(model, requests, **kw):
    """Greedy tokens of ``requests`` through a ``PagedEngine`` driven by
    a scheduler to the end, and the engine's gauges."""
    from apex_tpu_torch.serving import PagedEngine, Request, Scheduler

    eng = PagedEngine(model, **kw)
    sched = Scheduler(eng)
    reqs = [sched.submit(Request(prompt=p, max_new_tokens=n))
            for p, n in requests]
    sched.drain()
    return dict(tokens=[list(r.tokens) for r in reqs],
                chips=eng.chips_per_replica, mesh_shape=eng.mesh_shape,
                blocks_in_use=eng.blocks_in_use, cow_forks=eng.cow_forks,
                spec_proposed=eng.spec_proposed,
                pool_heads=tuple(eng.cache["key"].shape[1:2]))


def serving_checks(rank, d, sd, cfg):
    """The sharded paged op against the unsharded one; the tiny GPT's
    ``PagedEngine`` at tp 2 (prefix sharing and drafts on; bf16-free,
    int8 pages) and the single-chip engine; ``InferenceServer(tp=2)``
    serving a few requests (rank 0 schedules, rank 1 follows)."""
    from apex_tpu_torch.serving import InferenceServer, tp_mesh

    mesh = tp_mesh(2)
    out = {"ops": _paged_op_checks(mesh, d["ops"])}
    sd = {k: _t(v) for k, v in sd.items()}
    model = commons.standalone_gpt(device="cpu", state_dict=sd, **cfg)
    with commons.without_mesh():
        single = commons.standalone_gpt(device="cpu", state_dict=sd, **cfg)
    reqs = [(np.asarray(p, np.int32), n) for p, n in d["requests"]]
    for name, kw in d["engines"].items():
        out[name] = _engine_tokens(model, reqs, mesh=mesh, **kw)
        out[name + "_single"] = _engine_tokens(single, reqs, **kw)
    srv = InferenceServer(model, kv_cache="paged", tp=2, max_slots=2,
                          block_size=4, prefill_chunk=4,
                          share_prefixes=True, spec_tokens=2)
    srv.start()
    if srv.tp_rank == 0:
        handles = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
        out["server"] = [h.result(timeout=120) for h in handles]
    else:
        try:
            srv.submit(reqs[0][0], max_new_tokens=1)
        except ValueError as e:
            out["follower_submit"] = str(e)
    srv.shutdown()
    out["health"] = {k: v for k, v in srv.health().items()
                     if k in ("chips_per_replica", "mesh_shape", "status",
                              "blocks_in_use", "steps", "error")}
    return out
