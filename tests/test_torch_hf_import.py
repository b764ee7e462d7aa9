"""The port's HF / torchvision importers held against HF and the JAX
package.

Tiny GPT-2, Llama (GQA and MHA), Mistral (window 4 over 16 tokens) and
Mixtral (4 experts, top-2, drop-free capacity) built by ``transformers``
from in-code configs (random weights, no download): the port's logits
after ``load_torch_*`` equal HF's within 2e-4 and the JAX model's after
the JAX importer within 1e-4.  ResNet state dicts are built by
torchvision's key names (torchvision is not installed here): the port's
eval logits after ``load_torch_resnet`` equal the JAX ResNet's after its
importer, on both stems.  BERT is refused, as the JAX importer refuses
it: HF BERT is post-LN.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import torch_import as jax_import
from apex_tpu.models.resnet import ResNet as JaxResNet
from apex_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    GPTConfig,
    GPTModel,
    LlamaConfig,
    ResNet,
    ResNetConfig,
    load_torch_gpt2,
    load_torch_llama,
    load_torch_resnet,
)

transformers = pytest.importorskip("transformers")

HF_TOL, JAX_TOL = 2e-4, 1e-4


def _ids(seed, vocab=128, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _check(model, hf, jm, jcfg_params, ids):
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
        got = model(torch.from_numpy(ids.astype(np.int32))).numpy()
    np.testing.assert_allclose(got, want, rtol=HF_TOL, atol=HF_TOL)
    jl = jax.jit(jm.apply)(jcfg_params, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(jl), rtol=JAX_TOL,
                               atol=JAX_TOL)


def _jax_model(cfg_cls, **kw):
    jm = JaxGPTModel(cfg_cls(**kw))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 4), jnp.int32))
    return jm, params


def test_gpt2_logits_match_hf_and_jax():
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=2,
        activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0)).eval()
    kw = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
              max_seq_len=32, position_embedding="learned")
    model = GPTModel(GPTConfig(**kw), device="cpu")
    sd = load_torch_gpt2(model, hf.state_dict())
    assert set(sd) == set(model.state_dict())
    jm, params = _jax_model(JaxGPTConfig, **kw)
    params = jax_import.load_torch_gpt2(params, hf.state_dict(),
                                        num_heads=2)
    _check(model, hf, jm, params, _ids(0))


def _llama_family(kind, kv_heads=2):
    common = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=kv_heads, max_position_embeddings=32,
                  attention_dropout=0.0, tie_word_embeddings=False)
    port = dict(vocab_size=128, hidden_size=64, ffn_hidden_size=96,
                num_layers=2, num_heads=4, num_kv_heads=kv_heads,
                max_seq_len=32)
    if kind == "llama":
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            rope_theta=10000.0, **common))
    elif kind == "mistral":
        hf = transformers.MistralForCausalLM(transformers.MistralConfig(
            sliding_window=4, attn_implementation="eager", **common))
        port.update(sliding_window=4)
    else:
        hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
            num_local_experts=4, num_experts_per_tok=2, rope_theta=1e6,
            rms_norm_eps=1e-5, attn_implementation="eager", **common))
        port.update(num_moe_experts=4, moe_top_k=2, moe_capacity_factor=2.0,
                    rope_base=1e6, layernorm_eps=1e-5)
    return hf.eval(), port


@pytest.mark.parametrize("kind,kv_heads", [
    ("llama", 2), ("llama", 4), ("mistral", 2), ("mixtral", 2)])
def test_llama_family_logits_match_hf_and_jax(kind, kv_heads):
    torch.manual_seed(3)
    hf, kw = _llama_family(kind, kv_heads)
    model = GPTModel(LlamaConfig(**kw), device="cpu")
    sd = load_torch_llama(model, hf.state_dict())
    assert set(sd) == set(model.state_dict())
    jm, params = _jax_model(JaxLlamaConfig, **kw)
    params = jax_import.load_torch_llama(params, hf.state_dict(),
                                         num_heads=4, num_kv_heads=kv_heads)
    _check(model, hf, jm, params, _ids(3))


def test_mixtral_experts_land_in_the_jax_layout():
    torch.manual_seed(5)
    hf, kw = _llama_family("mixtral")
    model = GPTModel(LlamaConfig(**kw), device="cpu")
    sd = load_torch_llama(model, hf.state_dict())
    hsd = hf.state_dict()
    moe = "model.layers.1.block_sparse_moe."
    assert torch.equal(sd["transformer.layers.1.moe_mlp.gate"],
                       hsd[moe + "gate.weight"].T)
    assert torch.equal(sd["transformer.layers.1.moe_mlp.wg"][3],
                       hsd[moe + "experts.3.w3.weight"].T)
    assert torch.equal(sd["transformer.layers.1.moe_mlp.w2"][2],
                       hsd[moe + "experts.2.w2.weight"].T)


def test_import_errors_name_the_problem():
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=64, n_positions=16, n_embd=32, n_layer=4, n_head=2))
    model = GPTModel(GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                               num_heads=2, max_seq_len=16,
                               position_embedding="learned"), device="cpu")
    with pytest.raises(ValueError, match="refusing"):
        load_torch_gpt2(model, hf.state_dict())
    with pytest.raises(KeyError, match="wte"):
        load_torch_gpt2(model, {})
    hf, kw = _llama_family("llama")
    dense_into_moe = GPTModel(LlamaConfig(**kw, num_moe_experts=4),
                              device="cpu")
    with pytest.raises(ValueError, match="MLP form mismatch"):
        load_torch_llama(dense_into_moe, hf.state_dict())


def _torchvision_resnet(rng, stage_sizes=(1, 2), width=8, num_classes=5):
    """A state dict with torchvision's bottleneck-ResNet key names."""
    sd = {}

    def w(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * 0.1)

    def bn(prefix, c):
        sd[prefix + ".weight"] = 1.0 + w(c)
        sd[prefix + ".bias"] = w(c)
        sd[prefix + ".running_mean"] = w(c)
        sd[prefix + ".running_var"] = torch.from_numpy(
            rng.random(size=(c,)).astype(np.float32) + 0.5)
        sd[prefix + ".num_batches_tracked"] = torch.tensor(3)

    sd["conv1.weight"] = w(width, 3, 7, 7)
    bn("bn1", width)
    cin = width
    for i, nb in enumerate(stage_sizes):
        f = width * 2 ** i
        for j in range(nb):
            p = f"layer{i + 1}.{j}"
            sd[p + ".conv1.weight"] = w(f, cin, 1, 1)
            bn(p + ".bn1", f)
            sd[p + ".conv2.weight"] = w(f, f, 3, 3)
            bn(p + ".bn2", f)
            sd[p + ".conv3.weight"] = w(4 * f, f, 1, 1)
            bn(p + ".bn3", 4 * f)
            if (j == 0 and i > 0) or cin != 4 * f:
                sd[p + ".downsample.0.weight"] = w(4 * f, cin, 1, 1)
                bn(p + ".downsample.1", 4 * f)
            cin = 4 * f
    sd["fc.weight"] = w(num_classes, cin)
    sd["fc.bias"] = w(num_classes)
    return sd


@pytest.mark.parametrize("stem", ["conv", "s2d"])
def test_resnet_logits_match_jax_importer(stem):
    rng = np.random.default_rng(0)
    sd = _torchvision_resnet(rng)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JaxResNet(JaxResNetConfig(stage_sizes=(1, 2), width=8,
                                   num_classes=5, stem=stem))
    variables = jax.jit(lambda k, a: jm.init(k, a, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax_import.load_torch_resnet(variables, sd, stem=stem)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    model = ResNet(ResNetConfig(stage_sizes=(1, 2), width=8, num_classes=5,
                                stem=stem), device="cpu")
    load_torch_resnet(model, sd)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=JAX_TOL,
                               atol=JAX_TOL)
    with pytest.raises(ValueError, match="refusing"):
        load_torch_resnet(ResNet(ResNetConfig(
            stage_sizes=(1, 1), width=8, num_classes=5, stem=stem),
            device="cpu"), sd)


def test_bert_is_refused():
    model = BertModel(BertConfig.tiny(num_layers=1), device="cpu")
    with pytest.raises(ValueError, match="post-LN"):
        load_torch_gpt2(model, {})
    with pytest.raises(ValueError, match="post-LN"):
        load_torch_llama(GPTModel(LlamaConfig.tiny(num_layers=1),
                                  device="cpu"),
                         {"bert.embeddings.word_embeddings.weight":
                          torch.zeros(2, 2)})
