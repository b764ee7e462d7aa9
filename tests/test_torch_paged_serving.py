"""The port's paged serving stack held against the JAX package's.

The same tiny models (weights carried over with ``params_from_jax``)
serve the same numpy-made prompts through the JAX ``PagedEngine`` and
the port's ``PagedEngine`` / ``InferenceServer(kv_cache="paged")`` on
the CPU: greedy and sampled tokens must be identical, and greedy tokens
equal the port's ``generate()`` across page and chunk boundaries, under
preemption, prefix sharing with copy-on-write forks and speculative
decoding.  The host logic (allocator, digests, trie, drafter) is held
against the JAX package's unit for unit, and the quantized chunk
scatter's pages and scales against the JAX model's.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.ops.fused_sampling import fused_sample_reference as jax_sample
from apex_tpu.serving import PagedEngine as JaxPagedEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import Scheduler as JaxScheduler
from apex_tpu.serving import cache as jax_cache
from apex_tpu.serving import prompt_lookup_draft as jax_draft
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    LlamaConfig,
    generate,
    init_paged_cache,
    params_from_jax,
)
from apex_tpu_torch.ops import fused_sampling as fs
from apex_tpu_torch.serving import (
    BlockAllocator,
    BlockExhausted,
    InferenceServer,
    PagedEngine,
    PrefixTrie,
    Request,
    Scheduler,
    chain_digests,
    prompt_lookup_draft,
)
from apex_tpu_torch.serving import cache as slot_cache
from apex_tpu_torch.utils import MetricsWriter

VOCAB = 1024
ENGINE = dict(max_slots=3, block_size=8, prefill_chunk=4)

# prompt length (straddling pages of 8 and chunks of 4), max_new_tokens,
# temperature, top_k, top_p, seed
TRAFFIC = [(7, 6, 0.0, None, None, 0), (8, 4, 0.9, None, None, 3),
           (9, 5, 1.2, 20, None, 5), (16, 5, 0.8, None, 0.7, 7),
           (17, 3, 1.0, 10, 0.9, 9), (3, 6, 0.0, None, None, 0),
           (23, 4, 0.0, None, None, 0), (4, 7, 0.0, None, None, 0)]


def _requests():
    rng = np.random.default_rng(0)
    return [dict(prompt=rng.integers(0, VOCAB, n).astype(np.int32),
                 max_new_tokens=m, temperature=t, top_k=k, top_p=p, seed=s)
            for n, m, t, k, p, s in TRAFFIC]


def _pair(jcfg, cfg):
    jm = JaxGPTModel(jcfg)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    variables = {"params": variables["params"]}
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, flax.core.meta.unbox(variables)), cfg))
    return jm, variables, model


def _jax_tokens(jm, variables, **kw):
    sched = JaxScheduler(JaxPagedEngine(jm, variables, **{**ENGINE, **kw}))
    reqs = [sched.submit(JaxRequest(**r)) for r in _requests()]
    sched.drain()
    return [list(r.tokens) for r in reqs]


def _port_tokens(model, **kw):
    eng = PagedEngine(model, **{**ENGINE, **kw})
    sched = Scheduler(eng)
    reqs = [sched.submit(Request(**r)) for r in _requests()]
    sched.drain()
    assert eng.blocks_in_use == 0
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def gpt():
    kw = dict(position_embedding="learned")
    jm, variables, model = _pair(JaxGPTConfig.tiny(scan_layers=True, **kw),
                                 GPTConfig.tiny(**kw))
    return jm, variables, model, _jax_tokens(jm, variables)


@pytest.fixture(scope="module")
def llama():
    jm, variables, model = _pair(JaxLlamaConfig.tiny(scan_layers=True),
                                 LlamaConfig.tiny())
    return jm, variables, model, _jax_tokens(jm, variables)


def _ref(model, prompt, n):
    return generate(model, torch.from_numpy(prompt)[None],
                    max_new_tokens=n)[0, len(prompt):].tolist()


def _prompt(rng, n):
    return rng.integers(0, VOCAB, size=(n,)).astype(np.int32)


# --------------------------------------------------------------------- #
# host logic, unit for unit against the JAX package
# --------------------------------------------------------------------- #
class TestBlockAllocator:
    def test_null_page_reserved_and_sizes(self):
        alloc = BlockAllocator(9, 4)
        assert (alloc.blocks_total, alloc.tokens_total) == (8, 32)
        got = alloc.alloc(8)
        assert 0 not in got and len(set(got)) == 8
        assert alloc.blocks_free == 0

    def test_lifo_order_equals_jax(self):
        a, j = BlockAllocator(17, 8), jax_cache.BlockAllocator(17, 8)
        for n, free in ((5, None), (7, None), (0, slice(1, 4)), (3, None)):
            if free is not None:
                a.free(held[free])
                j.free(held[free])
                continue
            held = a.alloc(n)
            assert held == j.alloc(n)
        assert a.blocks_free == j.blocks_free

    def test_exhaustion_is_atomic(self):
        alloc = BlockAllocator(5, 2)
        alloc.alloc(3)
        with pytest.raises(BlockExhausted):
            alloc.alloc(2)
        assert alloc.blocks_free == 1
        assert alloc.alloc(1)

    def test_double_free_and_bad_range_raise(self):
        alloc = BlockAllocator(5, 2)
        got = alloc.alloc(2)
        alloc.free(got)
        with pytest.raises(ValueError, match="double free"):
            alloc.free([got[0]])
        with pytest.raises(ValueError, match="range"):
            alloc.free([0])
        assert slot_cache.blocks_for(8, 8) == 1
        assert slot_cache.blocks_for(9, 8) == 2

    def test_refcounts_defer_free(self):
        alloc = BlockAllocator(6, 4)
        a = alloc.alloc(2)
        assert alloc.incref(a[0]) == 2
        assert (alloc.shared_blocks, alloc.blocks_saved) == (1, 1)
        assert alloc.free(a) == [a[1]]        # a[0] still referenced
        assert alloc.blocks_in_use == 1
        assert alloc.free([a[0]]) == [a[0]]
        assert alloc.blocks_in_use == 0
        with pytest.raises(ValueError, match="not allocated"):
            alloc.incref(a[0])


class TestPrefixTrieAndDrafts:
    @pytest.mark.parametrize("bs", [4, 8, 16])
    def test_chain_digests_byte_equal_to_jax(self, bs):
        tokens = np.random.default_rng(bs).integers(0, 32000, 53)
        assert chain_digests(tokens, bs) == jax_cache.chain_digests(tokens,
                                                                    bs)

    def test_register_match_forget(self):
        t = PrefixTrie()
        d = chain_digests(np.arange(24), 8)
        assert t.register(d[0], 5) and t.register(d[1], 7)
        assert not t.register(d[0], 9)          # first writer wins
        assert t.match(d) == [5, 7]
        t.forget(5)
        assert t.match(d) == [] and t.holds_block(7)
        assert len(t) == 1

    def test_prompt_lookup_draft_equals_jax(self):
        rng = np.random.default_rng(3)
        contexts = [np.array([1, 2, 3, 9, 1, 2, 3]), np.array([5]),
                    np.tile(rng.integers(0, 50, 4), 4),
                    rng.integers(0, 6, 40), rng.integers(0, 1000, 30)]
        for ctx in contexts:
            for k in (1, 3, 5):
                np.testing.assert_array_equal(prompt_lookup_draft(ctx, k),
                                              jax_draft(ctx, k))

    def test_width_axis_sampling_equals_jax(self):
        rng = np.random.default_rng(4)
        rows, width, vocab = 3, 4, 256
        logits = rng.normal(size=(rows, width, vocab)).astype(np.float32)
        keys = rng.integers(0, 2 ** 32, (rows, width, 2), dtype=np.uint32)
        t = np.array([0.0, 0.9, 1.2], np.float32)
        k = np.array([0, 20, 0], np.int32)
        p = np.array([0.0, 0.0, 0.8], np.float32)
        got = fs.fused_sample(torch.from_numpy(logits),
                              torch.from_numpy(keys.astype(np.int64)),
                              *(torch.from_numpy(a) for a in (t, k, p)))
        ref = jax_sample(jnp.asarray(logits.reshape(-1, vocab)),
                         jnp.asarray(keys.reshape(-1, 2)),
                         *(jnp.repeat(jnp.asarray(a), width)
                           for a in (t, k, p)), vocab)
        assert got.shape == (rows, width)
        np.testing.assert_array_equal(got.numpy().ravel(), np.asarray(ref))


# --------------------------------------------------------------------- #
# the engine against the JAX engine and generate()
# --------------------------------------------------------------------- #
class TestEngineParity:
    @pytest.mark.parametrize("which", ["gpt", "llama"])
    def test_tokens_equal_the_jax_paged_engine(self, which, request):
        """Greedy and sampled chains, prompts straddling pages and
        chunks, requests queueing behind the first wave."""
        _, _, model, ref = request.getfixturevalue(which)
        assert _port_tokens(model) == ref

    @pytest.mark.parametrize("which", ["gpt", "llama"])
    def test_greedy_equals_generate(self, which, request):
        _, _, model, _ = request.getfixturevalue(which)
        rng = np.random.default_rng(3)
        prompts = [_prompt(rng, n) for n in (7, 8, 9, 3, 4, 5, 15, 16, 17)]
        eng = PagedEngine(model, **ENGINE)
        sched = Scheduler(eng)
        reqs = [sched.submit(Request(prompt=p, max_new_tokens=5))
                for p in prompts]
        sched.drain()
        for p, r in zip(prompts, reqs):
            assert r.tokens == _ref(model, p, 5), len(p)
        assert eng.blocks_in_use == 0

    def test_tenant_near_max_seq_len_survives_cotenant_prefill(self):
        """A tenant within a chunk of max_seq_len rides a wide step: its
        pad positions past the cache go to the null page, never into
        its last live page."""
        cfg = GPTConfig.tiny(position_embedding="learned", max_seq_len=16)
        model = GPTModel(cfg, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(5)
        pa, pb = _prompt(rng, 2), _prompt(rng, 10)
        eng = PagedEngine(model, max_slots=2, block_size=8, prefill_chunk=4)
        sched = Scheduler(eng)
        ra = sched.submit(Request(prompt=pa, max_new_tokens=14))
        for _ in range(10):
            sched.run_step()
        rb = sched.submit(Request(prompt=pb, max_new_tokens=2))
        sched.drain()
        assert ra.tokens == _ref(model, pa, 14)
        assert rb.tokens == _ref(model, pb, 2)

    def test_eos_stops_early(self, gpt):
        _, _, model, _ = gpt
        prompt = _prompt(np.random.default_rng(5), 9)
        ref = _ref(model, prompt, 8)
        sched = Scheduler(PagedEngine(model, max_slots=1, block_size=8,
                                      prefill_chunk=4))
        req = sched.submit(Request(prompt=prompt, max_new_tokens=8,
                                   eos_id=ref[2]))
        sched.drain()
        assert req.tokens == ref[:ref.index(ref[2]) + 1]

    def test_sampled_chain_independent_of_cotenants(self, gpt):
        _, _, model, _ = gpt
        rng = np.random.default_rng(7)
        prompt = _prompt(rng, 6)

        def run(extra):
            sched = Scheduler(PagedEngine(model, max_slots=2, block_size=8,
                                          prefill_chunk=4))
            req = sched.submit(Request(prompt=prompt, max_new_tokens=5,
                                       temperature=0.9, top_k=20, seed=123))
            for i in range(extra):
                sched.submit(Request(prompt=_prompt(rng, 4 + i),
                                     max_new_tokens=4, temperature=1.3,
                                     seed=i))
            sched.drain()
            return req.tokens

        assert run(0) == run(3)


class TestPreemptionAndSharing:
    def test_preemption_stays_token_identical_and_drains(self, gpt):
        _, _, model, _ = gpt
        eng = PagedEngine(model, max_slots=2, block_size=8, pool_tokens=64,
                          prefill_chunk=4, admit_headroom=0)
        sched = Scheduler(eng)
        rng = np.random.default_rng(7)
        p1, p2 = _prompt(rng, 20), _prompt(rng, 22)
        r1 = sched.submit(Request(prompt=p1, max_new_tokens=30))
        r2 = sched.submit(Request(prompt=p2, max_new_tokens=28))
        sched.drain()
        assert sched.preempts >= 1
        assert r1.tokens == _ref(model, p1, 30)
        assert r2.tokens == _ref(model, p2, 28)
        assert eng.blocks_in_use == 0

    def test_eviction_releases_blocks(self, gpt):
        _, _, model, _ = gpt
        eng = PagedEngine(model, max_slots=2, block_size=8, prefill_chunk=4)
        sched = Scheduler(eng)
        sched.submit(Request(prompt=np.zeros(12, np.int32),
                             max_new_tokens=50))
        for _ in range(6):
            sched.run_step()
        assert eng.blocks_in_use >= 2
        sched.evict(0)
        assert eng.blocks_in_use == 0 and sched.active_count == 0

    def test_shared_prefix_parity_and_refcounts(self, gpt):
        _, _, model, _ = gpt
        rng = np.random.default_rng(31)
        pref = _prompt(rng, 16)
        pa = np.concatenate([pref, _prompt(rng, 3)])
        pb = np.concatenate([pref, _prompt(rng, 5)])
        eng = PagedEngine(model, max_slots=2, block_size=8, prefill_chunk=4,
                          share_prefixes=True)
        sched = Scheduler(eng)
        ra = sched.submit(Request(prompt=pa, max_new_tokens=6))
        for _ in range(6):
            sched.run_step()
        assert eng.trie_blocks == 2
        before = eng.blocks_in_use
        rb = sched.submit(Request(prompt=pb, max_new_tokens=6))
        sched.run_step()
        assert (eng.shared_blocks, eng.blocks_saved) == (2, 2)
        assert eng.blocks_in_use <= before + 1 and eng.cow_forks == 0
        sched.drain()
        assert ra.tokens == _ref(model, pa, 6)
        assert rb.tokens == _ref(model, pb, 6)
        assert eng.blocks_in_use == 0 and eng.shared_blocks == 0

    def test_whole_prompt_hit_cow_forks_and_stays_identical(self, gpt):
        _, _, model, _ = gpt
        prompt = _prompt(np.random.default_rng(37), 16)
        eng = PagedEngine(model, max_slots=2, block_size=8, prefill_chunk=4,
                          share_prefixes=True)
        sched = Scheduler(eng)
        ra = sched.submit(Request(prompt=prompt, max_new_tokens=8))
        for _ in range(5):
            sched.run_step()
        rb = sched.submit(Request(prompt=prompt.copy(), max_new_tokens=8))
        sched.run_step()
        assert eng.cow_forks == 1 and eng.shared_blocks == 1
        sched.drain()
        ref = _ref(model, prompt, 8)
        assert ra.tokens == ref and rb.tokens == ref
        assert eng.blocks_in_use == 0

    def test_can_admit_discounts_trie_resident_prefix(self, gpt):
        _, _, model, _ = gpt
        rng = np.random.default_rng(41)
        pref = _prompt(rng, 16)
        eng = PagedEngine(model, max_slots=3, block_size=8, pool_tokens=48,
                          prefill_chunk=4, admit_headroom=8,
                          share_prefixes=True)
        sched = Scheduler(eng)
        sched.submit(Request(prompt=np.concatenate([pref, _prompt(rng, 2)]),
                             max_new_tokens=4))
        for _ in range(6):
            sched.run_step()
        fresh = _prompt(rng, 18)
        shared = np.concatenate([pref, fresh[:2]])
        assert not eng.can_admit(18, 8, prompt=fresh)
        assert eng.can_admit(18, 8, prompt=shared)
        assert eng.prefix_hit_blocks(shared) == 2
        assert eng.prefix_hit_blocks(fresh) == 0

    def test_preempt_requeue_reshares_and_drains(self, gpt):
        _, _, model, _ = gpt
        rng = np.random.default_rng(43)
        pref = _prompt(rng, 16)
        p1 = np.concatenate([pref, _prompt(rng, 4)])
        p2 = np.concatenate([pref, _prompt(rng, 6)])
        eng = PagedEngine(model, max_slots=2, block_size=8, pool_tokens=64,
                          prefill_chunk=4, admit_headroom=0,
                          share_prefixes=True)
        sched = Scheduler(eng)
        r1 = sched.submit(Request(prompt=p1, max_new_tokens=28))
        r2 = sched.submit(Request(prompt=p2, max_new_tokens=26))
        sched.drain()
        assert sched.preempts >= 1
        assert r1.tokens == _ref(model, p1, 28)
        assert r2.tokens == _ref(model, p2, 26)
        assert eng.blocks_in_use == 0


class TestSpeculativeDecoding:
    def test_greedy_equals_generate_with_spec_on(self, gpt):
        _, _, model, _ = gpt
        rng = np.random.default_rng(47)
        prompts = [np.tile(_prompt(rng, 4), 4)] + [
            _prompt(rng, n) for n in (4, 7, 8, 9, 16, 17)]
        eng = PagedEngine(model, max_slots=2, block_size=8, prefill_chunk=4,
                          spec_tokens=3)
        sched = Scheduler(eng)
        reqs = [sched.submit(Request(prompt=p, max_new_tokens=6))
                for p in prompts]
        sched.drain()
        for p, r in zip(prompts, reqs):
            assert r.tokens == _ref(model, p, 6), len(p)
        assert eng.spec_proposed > 0 and eng.blocks_in_use == 0

    def test_sampled_chains_are_acceptance_invariant(self, gpt):
        _, _, model, _ = gpt
        prompt = np.tile(_prompt(np.random.default_rng(53), 5), 3)

        def run(k, drafter=None):
            eng = PagedEngine(model, max_slots=1, block_size=8,
                              prefill_chunk=4, spec_tokens=k)
            if drafter is not None:
                eng._drafter = drafter
            sched = Scheduler(eng)
            req = sched.submit(Request(prompt=prompt, max_new_tokens=7,
                                       temperature=0.9, top_k=20, seed=123))
            sched.drain()
            return req.tokens, eng.spec_proposed, eng.spec_accepted

        base, _, _ = run(0)

        def oracle(context, k, ngram):
            pos = context.size - prompt.size
            return np.asarray(base[pos:pos + k], np.int32)

        def hostile(context, k, ngram):
            return np.full((k,), (int(context[-1]) + 1) % VOCAB, np.int32)

        toks, proposed, accepted = run(3, oracle)
        assert toks == base and proposed > 0 and accepted > 0
        toks, proposed, _ = run(3, hostile)
        assert toks == base and proposed > 0

    def test_eos_inside_accepted_run_stops_exactly(self, gpt):
        _, _, model, _ = gpt
        prompt = np.tile(_prompt(np.random.default_rng(59), 3), 4)
        ref = _ref(model, prompt, 8)
        eos = ref[3]
        eng = PagedEngine(model, max_slots=1, block_size=8, prefill_chunk=4,
                          spec_tokens=4)
        sched = Scheduler(eng)
        req = sched.submit(Request(prompt=prompt, max_new_tokens=8,
                                   eos_id=eos))
        sched.drain()
        assert req.tokens == ref[:ref.index(eos) + 1]
        assert eng.blocks_in_use == 0


class TestQuantizedPool:
    @pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
    def test_chunk_scatter_pages_and_scales_equal_jax(self, gpt, kv_dtype):
        """Two chunks (with pad lanes) and a decode step through the JAX
        model's paged path and the port's, on tables over shuffled
        pages: the logits agree, and so do the pools' scales (1e-5) and
        codes on live pages.  The two frameworks' projections round K/V
        differently in the last bit, so a value on a rounding boundary
        may take the neighbouring code: at most 0.1% of the codes, one
        step apart.  A broken scale discipline (no reset, no running
        max, a pad lane's amax in a page) moves whole pages."""
        jm, variables, model, _ = gpt
        cfg = model.cfg
        bs, nb, b = 8, 12, 2
        jcfg = dataclasses.replace(jm.cfg, kv_cache="paged",
                                   kv_block_size=bs, kv_pool_blocks=nb,
                                   kv_dtype=kv_dtype)
        jpaged = JaxGPTModel(jcfg)
        rng = np.random.default_rng(61)
        mb = cfg.max_seq_len // bs
        tables = np.zeros((b, mb), np.int32)
        tables[0, :3] = [7, 2, 9]
        tables[1, :3] = [4, 11, 1]
        live = np.array([7, 2, 9, 4, 11, 1])
        jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                              jax.eval_shape(lambda: jpaged.init(
                                  jax.random.PRNGKey(0),
                                  jnp.zeros((b, 1), jnp.int32),
                                  decode=True)["cache"]))
        pool = init_paged_cache(model, b, block_size=bs, num_blocks=nb,
                                kv_dtype=kv_dtype)
        cursors = np.array([0, 0], np.int32)
        for width, lens in ((5, [5, 3]), (6, [6, 6]), (1, [1, 1])):
            ids = rng.integers(0, VOCAB, (b, width)).astype(np.int32)
            cl = np.asarray(lens, np.int32)
            jcache = jax_cache.set_paged_leaves(jcache, tables, cursors, cl)
            jlog, upd = jpaged.apply({**variables, "cache": jcache},
                                     jnp.asarray(ids), decode=True,
                                     mutable=["cache"])
            jcache = upd["cache"]
            pool["block_tables"] = torch.from_numpy(tables)
            pool["cursors"] = torch.from_numpy(cursors)
            pool["chunk_lens"] = torch.from_numpy(cl)
            with torch.no_grad():
                logits = model(torch.from_numpy(ids), cache=pool)
            for r in range(b):
                n = lens[r]
                got = logits[r, :n].numpy()
                ref = np.asarray(jlog)[r, :n]
                assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
            cursors = cursors + cl
        layers = jcache["transformer"]["layers"]["layer"]["attention"]
        for name, port in (("key_scales", "key_scales"),
                           ("value_scales", "value_scales")):
            np.testing.assert_allclose(
                pool[port][:, :, live].numpy(),
                np.asarray(layers[name])[:, :, live], rtol=1e-5, atol=0)
        for name, port in (("paged_key", "key"), ("paged_value", "value")):
            ref = np.ascontiguousarray(np.asarray(layers[name])[:, :, live])
            got = pool[port][:, :, live].contiguous().view(
                torch.uint8).numpy().astype(np.int16)
            diff = np.abs(got - ref.view(np.uint8).astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3

    @pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
    def test_deterministic_and_in_the_jax_band(self, gpt, kv_dtype):
        """Coded pools reproduce themselves on rerun and agree with the
        JAX engine's coded tokens (the rounding of a code can flip a
        near-tie of these random weights, so agreement, not identity)."""
        jm, variables, model, _ = gpt
        first = _port_tokens(model, kv_dtype=kv_dtype)
        assert first == _port_tokens(model, kv_dtype=kv_dtype)
        ref = _jax_tokens(jm, variables, kv_dtype=kv_dtype)
        same = sum(a == b for f, r in zip(first, ref) for a, b in zip(f, r))
        assert same >= 0.95 * sum(len(r) for r in ref)

    def test_equal_hbm_default_pool_and_validation(self, gpt):
        _, _, model, _ = gpt
        base = PagedEngine(model, max_slots=2, block_size=8)
        quant = PagedEngine(model, max_slots=2, block_size=8,
                            kv_dtype="int8")
        assert quant.pool_tokens >= 3.9 * base.pool_tokens   # fp32 model
        assert (base.kv_bits, quant.kv_bits) == (32, 8)
        assert quant.cache["key"].dtype == torch.int8
        assert PagedEngine(model, max_slots=1, kv_dtype="auto",
                           block_size=0).kv_dtype is None
        with pytest.raises(ValueError, match="kv_dtype"):
            PagedEngine(model, kv_dtype="int4")
        with pytest.raises(ValueError, match="needs 2 devices"):
            PagedEngine(model, mesh=2)
        with pytest.raises(ValueError, match="pool"):
            PagedEngine(model, max_slots=1, block_size=8, pool_tokens=64,
                        prefill_chunk=4).validate_request(60, 20)


class TestPagedServer:
    def test_stream_equals_generate_with_gauges(self, llama):
        _, _, model, ref = llama
        rows = []
        writer = MetricsWriter(sink=lambda step, row: rows.append(row))
        with InferenceServer(model, kv_cache="paged", max_slots=3,
                             block_size=8, prefill_chunk=4, spec_tokens=2,
                             share_prefixes=True, metrics=writer,
                             metrics_interval=2) as srv:
            handles = [srv.submit(**r) for r in _requests()]
            streamed = list(handles[0].stream(timeout=60))
            got = [h.result(timeout=60) for h in handles]
            health = srv.health()
        assert got == ref and streamed == ref[0]
        assert health["blocks_in_use"] == 0
        assert health["blocks_total"] == srv.engine.blocks_total
        assert health["kv_dtype"] is None and health["kv_bits"] == 32
        for key in ("live_tokens", "shared_blocks", "cow_forks",
                    "spec_accept_rate", "preempts"):
            assert key in health
        merged = {k: v for row in rows for k, v in row.items()}
        assert {"blocks_in_use", "blocks_total", "kv_bits",
                "tokens_per_sec"} <= set(merged)
        assert srv.prefix_hit_blocks(_requests()[0]["prompt"]) == 0

    def test_knobs(self, gpt):
        _, _, model, _ = gpt
        with pytest.raises(ValueError, match="prompt_buckets"):
            InferenceServer(model, kv_cache="paged", prompt_buckets=(8,))
        for kw in (dict(share_prefixes=True), dict(spec_tokens=2),
                   dict(kv_dtype="int8")):
            with pytest.raises(ValueError, match="paged"):
                InferenceServer(model, **kw)
        for kw, match in ((dict(tp=2), "needs 2 devices"),
                          (dict(mesh=object()), "no 'tensor' axis"),
                          (dict(tp=4, mesh=2), "disagrees with mesh")):
            with pytest.raises(ValueError, match=match):
                InferenceServer(model, kv_cache="paged", **kw)
        with pytest.raises(ValueError, match="require kv_cache='paged'"):
            InferenceServer(model, tp=2)
        srv = InferenceServer(model, kv_cache="paged", prefill_chunk=0)
        assert srv.engine._chunk == 32 and srv.engine.block_size == 16
        with pytest.raises(ValueError, match="kv_cache"):
            InferenceServer(model, kv_cache="sparse")
        paged_cfg = dataclasses.replace(model.cfg, kv_cache="paged",
                                        kv_pool_blocks=4)
        with pytest.raises(ValueError, match="generate"):
            generate(GPTModel(paged_cfg, device="cpu"),
                     torch.zeros((1, 2), dtype=torch.int32),
                     max_new_tokens=1)
