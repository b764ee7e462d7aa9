"""The fused sampler (B-11), the softmax forward and backward (B-4, B-5)
and RoPE (B-3) held against their plain versions on a card; BERT's
token-type lookup rerunning bitwise there (fault C-12).

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so on a machine without it run it alone with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest``.
Sampled tokens equal the plain version's except on a nucleus-boundary
tie (the exclusive cumulative mass at the boundary within 1e-5 of
top_p, as ``chip_smoke.py`` allows); a rerun is bitwise.  The softmax is
within 2e-6 in fp32 and one ulp in the half types (the backward plus
what another order of its row sum moves dx by), and reruns bitwise.
RoPE equals its plain version bit for bit.
"""

import math

import pytest
import torch

from apex_tpu_torch.ops import fused_sampling as fs
from apex_tpu_torch.ops import rope as R
from apex_tpu_torch.ops import softmax as S

_MANT = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
_SUB = {torch.float32: 2.0 ** -149, torch.bfloat16: 2.0 ** -133,
        torch.float16: 2.0 ** -24}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _nucleus_tie(row, cfg):
    temp, top_k, top_p = cfg
    if not 0 < top_p < 1:
        return False
    s = torch.sort(row.double() / max(temp, 1e-6), descending=True).values
    if 0 < top_k < s.numel():
        s = s[:top_k]
    pr = torch.softmax(s, 0)
    return bool(((torch.cumsum(pr, 0) - pr - top_p).abs().min()) <= 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,vocab,dtype", [
    (8, 128256, torch.bfloat16), (16, 32000, torch.bfloat16),
    (4, 50257, torch.float32), (40, 128256, torch.float32),
    (3, 999, torch.float16), (1, 10 ** 6, torch.float32),
    (200, 32000, torch.bfloat16)])
def test_sampler_matches_plain(rows, vocab, dtype, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    logits = (2 * torch.randn(rows, vocab, generator=g,
                              device=cuda_device)).to(dtype)
    kinds = [(0.0, 0, 0.0), (0.8, 40, 0.0), (1.0, 0, 0.9), (0.7, 50, 0.8)]
    cfgs = [kinds[i % 4] for i in range(rows)]
    t, k, p = (torch.tensor(c, device=cuda_device) for c in zip(*cfgs))
    keys = fs.split(torch.stack([fs.prng_key(i, cuda_device)
                                 for i in range(rows)]))[:, 0]
    got = fs.fused_sample(logits, keys, t, k.int(), p)
    again = fs.fused_sample(logits, keys, t, k.int(), p)
    ref = fs.fused_sample(logits, keys, t, k.int(), p,
                          implementation="torch")
    assert torch.equal(got, again)
    for i in (got != ref).nonzero().flatten().tolist():
        assert _nucleus_tie(logits[i], cfgs[i])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mshape,causal", [
    ((16, 16, 512, 512), (16, 1, 1, 512), False),
    ((4, 16, 1024, 1024), None, True),
    ((2, 4, 64, 256), (2, 1, 64, 256), True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_forward_reruns_bitwise(shape, mshape, causal, dtype,
                                        cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = (3 * torch.randn(shape, generator=g, device=cuda_device)).to(dtype)
    m = None if mshape is None else torch.rand(
        mshape, generator=g, device=cuda_device) < 0.3
    y = S.softmax_fwd_kernel(x, m, 0.125, causal)
    assert torch.equal(y, S.softmax_fwd_kernel(x, m, 0.125, causal))
    ref = S.scale_mask_softmax_reference(x, m, 0.125, causal)
    if dtype == torch.float32:
        assert bool(((y - ref).abs() <= 2e-6).all())
    else:
        r = ref.float().abs().clamp_min(1e-38)
        ulp = torch.exp2(torch.floor(torch.log2(r)) - _MANT[dtype])
        assert bool(((y.float() - ref.float()).abs()
                     <= ulp.clamp_min(_SUB[dtype])).all())


def _within(got, ref, dtype, extra=0.0):
    """fp32 within 2e-6, half types within one ulp, plus ``extra``."""
    if dtype == torch.float32:
        return bool(((got - ref).abs() <= 2e-6 + extra).all())
    r = ref.float().abs().clamp_min(1e-38)
    ulp = torch.exp2(torch.floor(torch.log2(r)) - _MANT[dtype])
    return bool(((got.float() - ref.float()).abs()
                 <= ulp.clamp_min(_SUB[dtype]) + extra).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mshape,causal", [
    ((4, 16, 128, 512), None, False),
    ((2, 4, 64, 1024), None, False),
    ((2, 8, 64, 320), None, True),
    ((2, 4, 16, 200), (2, 1, 16, 200), True),
    ((3, 2, 16, 77), (16, 77), False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_softmax_backward_reruns_bitwise(shape, mshape, causal, dtype,
                                         cuda_device):
    """At the main-path widths (512, 1024: the kernel formula) and at the
    where() widths (sk % 128 != 0: zeros at every masked position), in
    16-byte vectors and one element a lane (sk 77)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = (3 * torch.randn(shape, generator=g, device=cuda_device)).to(dtype)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    m = None if mshape is None else torch.rand(
        mshape, generator=g, device=cuda_device) < 0.3
    y = S.scale_mask_softmax_reference(x, m, 0.125, causal)
    zero = S._zero_masked(shape[-1])
    bm, bc = (m, causal) if zero else (None, False)
    dx = S.softmax_bwd_kernel(dy, y, 0.125, bm, bc)
    assert torch.equal(dx, S.softmax_bwd_kernel(dy, y, 0.125, bm, bc))
    ref = S.softmax_bwd_reference(dy, y, 0.125, bm, bc)
    mag = (dy.float() * y.float()).abs().sum(-1, keepdim=True)
    order = (2 * math.ceil(math.log2(shape[-1])) * 2.0 ** -24 * mag
             * y.float().abs() * 0.125)
    assert _within(dx, ref, dtype, order)
    if zero:
        dead = S._masked(shape, bm, bc, cuda_device).expand(shape)
        assert bool((dx[dead] == 0).all())


def _packed_qk(g, b, s, h, hk, d, dtype, grouped, dev):
    """A packed projection leaf and q, k as ``ParallelAttention._qkv``
    views them: q is ``(b, s, hk, h / hk, d)`` in the grouped layout."""
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=g, device=dev).to(
        dtype).requires_grad_()
    if grouped:
        gv = qkv.view(b, s, hk, h // hk + 2, d)
        return qkv, gv[..., :h // hk, :], gv[..., h // hk, :]
    return (qkv, qkv[..., :h * d].view(b, s, h, d),
            qkv[..., h * d:(h + hk) * d].view(b, s, hk, d))


@pytest.mark.cuda
@pytest.mark.parametrize("h,hk,d,rot,grouped,per_row", [
    (32, 32, 128, 128, True, True),
    (32, 8, 128, 128, False, True),
    (4, 1, 128, 64, True, False),
    (6, 2, 80, 48, True, True),
    (8, 2, 72, 72, False, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,s", [(3, 19), (8, 150)])
def test_rope_kernel_equals_plain_on_strided_views(h, hk, d, rot, grouped,
                                                   per_row, dtype, b, s,
                                                   cuda_device):
    """q and k read through their strides from a packed projection, both
    layouts, GQA, a partial span, a tail of whole vectors (d 80, rot 48)
    and a span of 36 (one element a thread), at few positions (the heads
    spread over the grid) and many: forward and backward equal the plain
    version, and ``_rope_qk`` two ``fused_rope`` calls."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    ct, st = R.rope_cos_sin(256, rot, device=cuda_device)
    if per_row:
        pos = torch.randint(0, 256 - s, (b, 1), generator=g,
                            device=cuda_device) + torch.arange(
                                s, device=cuda_device)
        c, sn = ct[pos], st[pos]
    else:
        c, sn = ct[5:5 + s], st[5:5 + s]
    dq = torch.randn(b, s, h, d, generator=g, device=cuda_device).to(dtype)
    dk = torch.randn(b, s, hk, d, generator=g, device=cuda_device).to(dtype)
    outs = []
    for impl in ("kernel", "torch"):
        qkv, q, k = _packed_qk(torch.Generator(device=cuda_device).manual_seed(
            8), b, s, h, hk, d, dtype, grouped, cuda_device)
        yq, yk = R._rope_qk(q, k, c, sn, implementation=impl)
        torch.autograd.backward((yq, yk), (dq, dk))
        outs.append((yq.detach(), yk.detach(), qkv.grad))
        if impl == "kernel":
            with torch.no_grad():
                assert torch.equal(yq, R.fused_rope(
                    q.reshape(b, s, h, d), c, sn))
                assert torch.equal(yk, R.fused_rope(k, c, sn))
    for got, ref in zip(*outs):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_bert_token_type_gradient_reruns_bitwise_on_card(cuda_device):
    """BERT-Large's token-type lookup (16 x 512 ids, all 0, a 2 x 1024
    bf16 table): the table's gradient is the same bits on 30 reruns.
    ``F.embedding``'s backward at this shape differed in 10 of 30 on an
    H100 (fault C-12)."""
    from apex_tpu_torch.models.bert import _TypeRows

    g = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.zeros(16, 512, dtype=torch.long, device=cuda_device)
    table = torch.randn(2, 1024, generator=g, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    dy = torch.randn(16, 512, 1024, generator=g, device=cuda_device).to(
        torch.bfloat16)
    grads = [torch.autograd.grad(_TypeRows.apply(ids, table), table, dy)[0]
             for _ in range(30)]
    assert all(torch.equal(x, grads[0]) for x in grads[1:])
