"""The port's ops (``apex_tpu_torch.ops``) held against the JAX package.

Inputs are made with numpy from fixed seeds and go through both the JAX
function and the port's counterpart on the CPU, where the port runs its
plain PyTorch composition.  The JAX side runs as its own tests run it
here: the Pallas kernels in interpret mode, or the XLA composition.
Tolerances: fp32 results within rtol 1e-5 (the two frameworks sum in
different orders); threefry bits and sampled tokens exact.

Tests marked ``cuda`` hold the CUDA kernels against the plain versions
on a GPU and skip without one.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.generate import sample_logits as jax_sample_logits
from apex_tpu.ops.fused_sampling import (
    fused_sample_reference as jax_sample_reference,
)
from apex_tpu.ops.layer_norm import (
    fused_layer_norm as jax_layer_norm,
    fused_rms_norm as jax_rms_norm,
)
from apex_tpu.ops.mlp import resolve_activation as jax_activation
from apex_tpu.ops.rope import fused_rope as jax_rope
from apex_tpu.ops.rope import rope_cos_sin as jax_cos_sin
from apex_tpu_torch import _build
from apex_tpu_torch.models.generate import sample_logits
from apex_tpu_torch.ops import (
    fused_layer_norm,
    fused_rms_norm,
    fused_rope,
    fused_sample,
    fused_sample_reference,
    prng_key,
    random_bits,
    resolve_activation,
    resolve_device,
    resolve_impl,
    rope_cos_sin,
    split,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_IMPLS = ("pallas_interpret", "xla")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


# ------------------------------------------------------------------ #
# dispatch and devices
# ------------------------------------------------------------------ #
class TestDispatch:
    def test_auto_takes_plain_path_on_cpu(self):
        x = torch.zeros(2)
        assert resolve_impl(None, x) == "torch"
        assert resolve_impl("auto", x) == "torch"
        assert resolve_impl("torch", x) == "torch"

    def test_kernel_on_cpu_tensor_raises(self):
        with pytest.raises(ValueError, match="CUDA tensor"):
            resolve_impl("kernel", torch.zeros(2))
        with pytest.raises(ValueError, match="CUDA tensor"):
            fused_rms_norm(torch.zeros(2, 8), implementation="kernel")

    def test_unknown_implementation_raises(self):
        with pytest.raises(ValueError, match="not in"):
            resolve_impl("pallas", torch.zeros(2))

    def test_default_device_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA is available here")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        assert resolve_device("cpu").type == "cpu"

    def test_port_imports_no_jax(self):
        code = (
            "import sys, pkgutil, importlib, apex_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "apex_tpu_torch.__path__, 'apex_tpu_torch.')]\n"
            "for name in mods:\n"
            "    importlib.import_module(name)\n"
            "bad = [n for n in sys.modules if n == 'jax' "
            "or n.startswith('jax.') or n == 'apex_tpu' "
            "or n.startswith('apex_tpu.')]\n"
            "print(len(mods))\n"
            "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout.split()[-1]) >= 15

    def test_chip_smoke_imports_no_jax(self):
        import ast

        with open(os.path.join(REPO, "chip_smoke.py")) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        bad = [m for m in names if m.split(".")[0] in ("jax", "apex_tpu")]
        assert not bad, bad
        assert "apex_tpu_torch" in {m.split(".")[0] for m in names}

    def test_every_kernel_source_names_the_tpu_kernel_it_replaces(self):
        notes = {"layer_norm": "_ln_bwd_dx_kernel", "rope": "_rope_kernel",
                 "fused_sampling": "_sampling_kernel",
                 "flash_attention": "_fa_bwd_dkv_kernel"}
        for name, src in _build.SOURCES.items():
            path = os.path.join(REPO, "apex_tpu_torch", "csrc", src)
            with open(path) as f:
                text = f.read()
            assert notes[name] in text and "bound" in text
            assert 'extern "C"' in text and "cudaGetLastError" in text


# ------------------------------------------------------------------ #
# layer norm / rms norm
# ------------------------------------------------------------------ #
class TestNorms:
    @pytest.mark.parametrize("impl", JAX_IMPLS)
    @pytest.mark.parametrize("shape", [(4, 256), (2, 3, 384)])
    def test_rms_norm_matches_jax(self, impl, shape):
        rng = np.random.default_rng(1)
        x = rng.normal(size=shape).astype(np.float32)
        w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
        ref = jax_rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6,
                           implementation=impl)
        _close(fused_rms_norm(_t(x), _t(w), eps=1e-6), ref)

    @pytest.mark.parametrize("impl", JAX_IMPLS)
    @pytest.mark.parametrize("affine", [True, False])
    def test_layer_norm_matches_jax(self, impl, affine):
        rng = np.random.default_rng(2)
        x = (3 + rng.normal(size=(6, 256))).astype(np.float32)
        w = (1 + 0.1 * rng.normal(size=256)).astype(np.float32)
        b = (0.1 * rng.normal(size=256)).astype(np.float32)
        jw, jb = (jnp.asarray(w), jnp.asarray(b)) if affine else (None, None)
        tw, tb = (_t(w), _t(b)) if affine else (None, None)
        ref = jax_layer_norm(jnp.asarray(x), jw, jb, eps=1e-5,
                             implementation=impl)
        _close(fused_layer_norm(_t(x), tw, tb, eps=1e-5), ref)

    def test_half_input_keeps_dtype_and_stats_in_fp32(self):
        rng = np.random.default_rng(3)
        x = rng.normal(size=(4, 128)).astype(np.float32)
        w = np.ones(128, np.float32)
        y = fused_rms_norm(_t(x).to(torch.bfloat16), _t(w))
        assert y.dtype == torch.bfloat16
        ref = jax_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                           implementation="xla")
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------------ #
# rope
# ------------------------------------------------------------------ #
class TestRope:
    def test_tables_match_jax(self):
        c, s = rope_cos_sin(64, 32, base=500000.0)
        jc, js = jax_cos_sin(64, 32, base=500000.0)
        _close(c, jc)
        _close(s, js)

    @pytest.mark.parametrize("impl", JAX_IMPLS)
    @pytest.mark.parametrize("shape,rot", [((2, 8, 4, 256), 256),
                                           ((2, 8, 4, 256), 128),
                                           ((8, 4, 256), 256),
                                           ((3, 8, 256), 256)])
    def test_shared_tables_match_jax(self, impl, shape, rot):
        rng = np.random.default_rng(4)
        x = rng.normal(size=shape).astype(np.float32)
        seq = 8
        jc, js = jax_cos_sin(32, rot)
        jc, js = jc[5:5 + seq], js[5:5 + seq]
        ref = jax_rope(jnp.asarray(x), jc, js, implementation=impl)
        _close(fused_rope(_t(x), _t(jc), _t(js)), ref)

    def test_per_row_tables_match_jax_row_by_row(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(3, 1, 4, 128)).astype(np.float32)
        pos = np.array([0, 17, 40])
        jc, js = jax_cos_sin(64, 128)
        c, s = _t(jc)[pos][:, None], _t(js)[pos][:, None]     # (b, 1, half)
        got = fused_rope(_t(x), c, s)
        for i, p in enumerate(pos):
            ref = jax_rope(jnp.asarray(x[i:i + 1]), jc[p:p + 1],
                           js[p:p + 1], implementation="xla")
            _close(got[i:i + 1], ref)

    def test_mismatched_tables_raise(self):
        with pytest.raises(ValueError, match="do not match"):
            fused_rope(torch.zeros(2, 8, 4, 64), torch.zeros(7, 32),
                       torch.zeros(7, 32))


# ------------------------------------------------------------------ #
# threefry keys and sampling
# ------------------------------------------------------------------ #
def _keys(seeds):
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    tk = torch.stack([prng_key(int(s)) for s in seeds])
    return jk, tk


# (temperature, top_k, top_p) per row: greedy, temperature only, top-k,
# top-p and both, with a disabled filter (top_k = vocab, top_p = 1)
GRID = [(0.0, 0, 0.0), (0.9, 0, 0.0), (1.0, 5, 0.0), (0.7, 0, 0.9),
        (1.3, 50, 0.6), (0.0, 3, 0.5), (1.0, 1024, 1.0), (0.5, 1, 0.0),
        (1.1, 0, 0.3), (0.8, 200, 0.95)]


class TestThreefry:
    def test_prng_key_split_and_bits_match_jax(self):
        seeds = np.array([0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1], np.uint64)
        jk, tk = _keys(seeds)
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(jax.random.split)(jk)), split(tk).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(lambda k: jax.random.bits(k, (1000,)))(jk)),
            random_bits(tk, 1000).numpy())

    def test_split_of_split_chain_matches_jax(self):
        jk, tk = _keys([42])
        for _ in range(3):
            jk = jax.vmap(jax.random.split)(jk)[:, 1]
            tk = split(tk)[:, 1]
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())


class TestSampling:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_reference_tokens_match_jax_on_grid(self, seed):
        rng = np.random.default_rng(seed)
        V = 1024
        logits = (2.5 * rng.normal(size=(len(GRID), V))).astype(np.float32)
        t, k, p = (np.array(c, dt) for c, dt in zip(
            zip(*GRID), (np.float32, np.int32, np.float32)))
        jk, tk = _keys(rng.integers(0, 2 ** 32, size=len(GRID),
                                    dtype=np.uint64))
        ref = jax_sample_reference(jnp.asarray(logits), jk, jnp.asarray(t),
                                   jnp.asarray(k), jnp.asarray(p), V)
        got = fused_sample(_t(logits), tk, _t(t), _t(k), _t(p),
                           vocab_size=V)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            fused_sample_reference(_t(logits), tk, _t(t), _t(k), _t(p),
                                   V).numpy(), np.asarray(ref))

    def test_greedy_rows_ignore_the_key(self):
        rng = np.random.default_rng(9)
        logits = _t(rng.normal(size=(3, 256)).astype(np.float32))
        zeros = torch.zeros(3)
        z_i = torch.zeros(3, dtype=torch.int32)
        a = fused_sample(logits, torch.stack([prng_key(1)] * 3), zeros, z_i,
                         zeros)
        b = fused_sample(logits, torch.stack([prng_key(2)] * 3), zeros, z_i,
                         zeros)
        assert torch.equal(a, b)
        assert torch.equal(a, logits.argmax(-1).to(torch.int32))

    def test_validation(self):
        z = torch.zeros(2)
        with pytest.raises(ValueError, match="keys shape"):
            fused_sample(torch.zeros(2, 8), torch.zeros(3, 2), z, z, z)
        with pytest.raises(ValueError, match="vocab_size"):
            fused_sample(torch.zeros(2, 8), torch.zeros(2, 2), z, z, z,
                         vocab_size=9)
        with pytest.raises(ValueError, match="top_p shape"):
            fused_sample(torch.zeros(2, 8), torch.zeros(2, 2), z, z,
                         torch.zeros(3))

    @pytest.mark.parametrize("temp,top_k,top_p", [
        (0.0, None, None), (0.8, None, None), (1.0, 7, None),
        (0.9, None, 0.8), (1.2, 20, 0.7)])
    def test_static_sample_logits_match_jax(self, temp, top_k, top_p):
        rng = np.random.default_rng(11)
        logits = (2 * rng.normal(size=(3, 512))).astype(np.float32)
        key = jax.random.PRNGKey(123)
        ref = jax_sample_logits(jnp.asarray(logits), key, temperature=temp,
                                top_k=top_k, top_p=top_p)
        got = sample_logits(_t(logits), prng_key(123), temperature=temp,
                            top_k=top_k, top_p=top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "sigmoid"])
def test_activations_match_jax(name):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = jax_activation(name, gelu_approximate=True)(jnp.asarray(x))
    _close(resolve_activation(name, gelu_approximate=True)(_t(x)), ref)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        resolve_activation(None)


# ------------------------------------------------------------------ #
# the CUDA kernels against their plain versions (GPU only)
# ------------------------------------------------------------------ #
@pytest.mark.cuda
class TestKernelsOnCard:
    def test_norms(self, cuda_device):
        g = torch.Generator(device=cuda_device).manual_seed(0)
        x = torch.randn(64, 4096, generator=g, device=cuda_device)
        w = torch.randn(4096, generator=g, device=cuda_device)
        b = torch.randn(4096, generator=g, device=cuda_device)
        torch.testing.assert_close(
            fused_rms_norm(x, w), fused_rms_norm(x, w, implementation="torch"),
            rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(
            fused_layer_norm(x, w, b),
            fused_layer_norm(x, w, b, implementation="torch"),
            rtol=1e-5, atol=1e-5)

    def test_rope(self, cuda_device):
        g = torch.Generator(device=cuda_device).manual_seed(1)
        x = torch.randn(2, 16, 8, 128, generator=g, device=cuda_device)
        c, s = rope_cos_sin(16, 96, device=cuda_device)
        torch.testing.assert_close(
            fused_rope(x, c, s), fused_rope(x, c, s, implementation="torch"),
            rtol=1e-5, atol=1e-5)

    def test_sampling(self, cuda_device):
        g = torch.Generator(device=cuda_device).manual_seed(2)
        rows = len(GRID)
        logits = 2 * torch.randn(rows, 1024, generator=g, device=cuda_device)
        t, k, p = (torch.tensor(c, device=cuda_device) for c in zip(*GRID))
        keys = split(torch.stack([prng_key(i, cuda_device)
                                  for i in range(rows)]))[:, 0]
        got = fused_sample(logits, keys, t, k.int(), p)
        ref = fused_sample(logits, keys, t, k.int(), p,
                           implementation="torch")
        assert torch.equal(got, ref)
