"""Public names of ported modules that the JAX package has (ROADMAP C-9).

Each name exists in the port and behaves as the JAX package's does:
``rope_cos_sin(dtype=)`` (tables in fp32, then cast: bf16 within one bf16
ulp of the JAX tables, fp32 exactly), ``fused_sample(block_v=)`` (a tile
hint, taken and ignored: the tokens do not change), ``Engine.paged``,
``PagedEngine.blocks_free``, ``BlockAllocator.tokens_free`` (equal to the
JAX allocator's after the same allocations) and ``amp.PrecisionPolicy``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jax_amp
from apex_tpu.ops.rope import rope_cos_sin as jax_rope_cos_sin
from apex_tpu.serving import cache as jax_cache
from apex_tpu_torch import amp
from apex_tpu_torch.core.precision import PrecisionPolicy
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.ops import fused_sampling as fs
from apex_tpu_torch.ops.rope import rope_cos_sin
from apex_tpu_torch.serving import Engine, PagedEngine
from apex_tpu_torch.serving import cache as port_cache


def _bf16_ulp(x):
    """One bf16 ulp of each entry of the fp32 array ``x``."""
    a = np.abs(x).astype(np.float64)
    e = np.floor(np.log2(np.maximum(a, 1e-30)))
    return np.where(a > 0, 2.0 ** (e - 7), 1e-30)


class TestRopeTablesDtype:
    @pytest.mark.parametrize("seq,rot", [(64, 128), (37, 80), (4096, 64)])
    def test_bf16_tables_within_one_ulp_of_jax(self, seq, rot):
        cos, sin = rope_cos_sin(seq, rot, dtype=torch.bfloat16)
        jcos, jsin = jax_rope_cos_sin(seq, rot, dtype=jnp.bfloat16)
        for got, ref in ((cos, jcos), (sin, jsin)):
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == (seq, rot // 2)
            r = np.asarray(ref, np.float32)
            err = np.abs(got.float().numpy() - r)
            assert (err <= _bf16_ulp(r)).all(), float(err.max())

    def test_fp32_default_equals_jax(self):
        cos, sin = rope_cos_sin(128, 64)
        jcos, jsin = jax_rope_cos_sin(128, 64)
        assert cos.dtype == torch.float32
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0,
                                   atol=1e-6)

    def test_cast_of_the_fp32_tables(self):
        c32, s32 = rope_cos_sin(50, 32)
        c16, s16 = rope_cos_sin(50, 32, dtype=torch.float16)
        assert torch.equal(c16, c32.to(torch.float16))
        assert torch.equal(s16, s32.to(torch.float16))


class TestFusedSampleTileHint:
    @pytest.mark.parametrize("block_v", [0, 128, 512, 1000])
    def test_block_v_is_taken_and_ignored(self, block_v):
        g = torch.Generator().manual_seed(3)
        logits = 2.0 * torch.randn(4, 1024, generator=g)
        keys = fs.split(torch.stack([fs.prng_key(s, "cpu")
                                     for s in (1, 2, 3, 4)]))[:, 0]
        t = torch.tensor([0.0, 0.8, 1.0, 0.9])
        k = torch.tensor([0, 0, 40, 0], dtype=torch.int32)
        p = torch.tensor([0.0, 0.0, 0.0, 0.9])
        want = fs.fused_sample(logits, keys, t, k, p)
        got = fs.fused_sample(logits, keys, t, k, p, block_v=block_v)
        assert torch.equal(got, want)

    def test_negative_block_v_raises(self):
        logits = torch.zeros(1, 256)
        keys = fs.split(fs.prng_key(0, "cpu")[None])[:, 0]
        with pytest.raises(ValueError, match="block_v"):
            fs.fused_sample(logits, keys, torch.zeros(1),
                            torch.zeros(1, dtype=torch.int32),
                            torch.zeros(1), block_v=-1)


class TestServingGauges:
    def test_engine_paged_flags(self):
        assert Engine.paged is False
        assert PagedEngine.paged is True

    def test_blocks_free_tracks_the_pool(self):
        cfg = GPTConfig.tiny(position_embedding="learned")
        model = GPTModel(cfg, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        eng = PagedEngine(model, max_slots=2, block_size=8, prefill_chunk=4)
        assert eng.blocks_free == eng.blocks_total
        taken = eng._alloc.alloc(3)
        assert eng.blocks_free == eng.blocks_total - 3
        assert eng.blocks_free + eng.blocks_in_use == eng.blocks_total
        eng._alloc.free(taken)
        assert eng.blocks_free == eng.blocks_total

    @pytest.mark.parametrize("num_blocks,block_size", [(9, 8), (33, 16)])
    def test_tokens_free_equals_jax(self, num_blocks, block_size):
        mine = port_cache.BlockAllocator(num_blocks, block_size)
        ref = jax_cache.BlockAllocator(num_blocks, block_size)
        assert mine.tokens_free == ref.tokens_free
        a, b = mine.alloc(3), ref.alloc(3)
        assert mine.tokens_free == ref.tokens_free
        mine.incref(a[0])
        ref.incref(b[0])
        mine.free(a)
        ref.free(b)
        assert mine.tokens_free == ref.tokens_free
        assert mine.tokens_free == mine.blocks_free * block_size


class TestAmpNames:
    def test_precision_policy_is_reexported(self):
        assert amp.PrecisionPolicy is PrecisionPolicy
        assert "PrecisionPolicy" in amp.__all__
        assert "PrecisionPolicy" in jax_amp.__all__


class TestModelZooNames:
    """The names of the ViT, MoE and importer modules, exported where
    the JAX package exports them, and the Mistral / Mixtral presets
    field for field."""

    @pytest.mark.parametrize("name", [
        "ViTConfig", "ViTModel", "moe_aux_loss", "load_torch_gpt2",
        "load_torch_llama", "generate", "init_cache"])
    def test_models_exports(self, name):
        import apex_tpu.models as jax_models
        import apex_tpu_torch.models as models

        assert name in jax_models.__all__
        assert name in models.__all__ and hasattr(models, name)

    @pytest.mark.parametrize("name", ["moe", "MoEConfig", "MoEMLP"])
    def test_transformer_exports(self, name):
        import apex_tpu.transformer as jax_transformer
        import apex_tpu_torch.transformer as transformer

        assert name in jax_transformer.__all__
        assert name in transformer.__all__ and hasattr(transformer, name)

    @pytest.mark.parametrize("preset", ["mistral_7b", "mixtral_8x7b"])
    def test_presets_equal_jax(self, preset):
        import dataclasses

        from apex_tpu.models import LlamaConfig as JaxLlamaConfig
        from apex_tpu_torch.models import LlamaConfig

        mine, ref = (getattr(c, preset)() for c in (LlamaConfig,
                                                    JaxLlamaConfig))
        shared = {f.name for f in dataclasses.fields(mine)} & {
            f.name for f in dataclasses.fields(ref)}
        shared -= {"dtype", "param_dtype"}
        assert len(shared) > 30
        for name in sorted(shared):
            assert getattr(mine, name) == getattr(ref, name), name
