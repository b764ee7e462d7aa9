"""The fused sampler (B-11) and the softmax forward (B-4) held against
their plain versions on a card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so on a machine without it run it alone with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest``.
Sampled tokens equal the plain version's except on a nucleus-boundary
tie (the exclusive cumulative mass at the boundary within 1e-5 of
top_p, as ``chip_smoke.py`` allows); a rerun is bitwise.  The softmax is
within 2e-6 in fp32 and one ulp in the half types, and reruns bitwise.
"""

import pytest
import torch

from apex_tpu_torch.ops import fused_sampling as fs
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
