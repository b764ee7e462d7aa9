"""The port's dense serving stack held against the JAX package's.

The same tiny models (weights carried over with ``params_from_jax``)
serve the same numpy-made prompts through the JAX ``Engine`` and the
port's ``Engine`` / ``InferenceServer`` on the CPU: greedy AND sampled
tokens must be identical (the port replays jax's threefry keys).  Small
prompt buckets keep the JAX compiles short.  The rest covers the slot
pool, the scheduler's queue, fault recovery, deadlines and metrics.
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
from apex_tpu.serving import Engine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import Scheduler as JaxScheduler
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    LlamaConfig,
    generate,
    init_cache,
    params_from_jax,
)
from apex_tpu_torch.ops import prng_key
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.serving import (
    Engine,
    InferenceServer,
    QueueFull,
    Request,
    RequestFailed,
    Scheduler,
    ServerClosed,
)
from apex_tpu_torch.serving import cache as slot_cache
from apex_tpu_torch.utils import MetricsWriter, percentile_summary

BUCKETS = (8, 16)

# prompt length, max_new_tokens, temperature, top_k, top_p, seed
TRAFFIC = [(5, 6, 0.0, None, None, 0), (11, 4, 0.9, None, None, 3),
           (3, 7, 1.2, 20, None, 5), (14, 5, 0.8, None, 0.7, 7),
           (9, 3, 1.0, 10, 0.9, 9), (2, 6, 0.0, None, None, 0)]


def _requests(vocab=1024):
    rng = np.random.default_rng(0)
    return [dict(prompt=rng.integers(0, vocab, n).astype(np.int32),
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


def _jax_tokens(jm, variables):
    sched = JaxScheduler(JaxEngine(jm, variables, max_slots=3,
                                   prompt_buckets=BUCKETS))
    reqs = [sched.submit(JaxRequest(**r)) for r in _requests()]
    sched.drain()
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def llama():
    jm, variables, model = _pair(JaxLlamaConfig.tiny(), LlamaConfig.tiny())
    return model, _jax_tokens(jm, variables)


def _port_tokens(model):
    sched = Scheduler(Engine(model, max_slots=3, prompt_buckets=BUCKETS))
    reqs = [sched.submit(Request(**r)) for r in _requests()]
    sched.drain()
    return [list(r.tokens) for r in reqs]


class TestEngineParity:
    def test_llama_tokens_match_jax_engine(self, llama):
        model, ref = llama
        assert _port_tokens(model) == ref

    def test_gpt_learned_positions_match_jax_engine(self):
        kw = dict(position_embedding="learned", num_layers=1)
        jm, variables, model = _pair(JaxGPTConfig.tiny(**kw),
                                     GPTConfig.tiny(**kw))
        assert _port_tokens(model) == _jax_tokens(jm, variables)

    def test_server_streams_the_jax_engine_tokens(self, llama):
        model, ref = llama
        metrics = MetricsWriter(sink=lambda step, row: None)
        with InferenceServer(model, max_slots=3, prompt_buckets=BUCKETS,
                             metrics=metrics, metrics_interval=2) as srv:
            handles = [srv.submit(**r) for r in _requests()]
            streamed = list(handles[0].stream(timeout=60))
            got = [h.result(timeout=60) for h in handles]
            health = srv.health()
        assert got == ref
        assert streamed == ref[0]
        assert health["status"] == "serving"
        assert health["tokens_emitted"] == sum(map(len, ref))
        assert metrics.history and "tokens_per_sec" in metrics.history[-1][1]
        assert srv.health()["status"] == "stopped"
        assert "ttft_p50_s" in srv.latency_summary()

    def test_greedy_engine_equals_generate(self, llama):
        model, _ = llama
        eng = Engine(model, max_slots=2, prompt_buckets=BUCKETS)
        sched = Scheduler(eng)
        prompts = [r["prompt"] for r in _requests()[:3]]
        reqs = [sched.submit(Request(prompt=p, max_new_tokens=5))
                for p in prompts]
        sched.drain()
        for p, r in zip(prompts, reqs):
            ref = generate(model, torch.from_numpy(p)[None],
                           max_new_tokens=5)[0, len(p):].tolist()
            assert r.tokens == ref

    def test_eos_stops_a_request(self, llama):
        model, ref = llama
        eos = ref[0][2]
        sched = Scheduler(Engine(model, max_slots=1, prompt_buckets=BUCKETS))
        req = sched.submit(Request(prompt=_requests()[0]["prompt"],
                                   max_new_tokens=6, eos_id=eos))
        sched.drain()
        assert req.tokens == ref[0][:ref[0].index(eos) + 1]


class TestSlotPool:
    def test_write_reset_rewind(self, llama):
        model, _ = llama
        pool = init_cache(model, 3)
        one = init_cache(model, 1)
        one["key"].fill_(1.0)
        one["value"].fill_(2.0)
        slot_cache.rewind_index(one, 7)
        slot_cache.write_slot(pool, 1, one)
        assert pool["index"].tolist() == [0, 7, 0]
        assert bool((pool["key"][:, 1] == 1).all())
        assert float(pool["key"][:, 0].abs().sum()) == 0.0
        slot_cache.reset_slot(pool, 1)
        assert float(pool["value"].abs().sum()) == 0.0
        assert pool["index"].tolist() == [0, 0, 0]

    def test_admit_and_release_state(self):
        st = slot_cache.init_slot_state(2)
        slot_cache.admit_slot(st, 1, tok=5, budget=3, temperature=0.5,
                              top_k=4, top_p=0.9, eos_id=2, seed=11)
        assert st.active.tolist() == [False, True]
        assert st.rng[1].tolist() == prng_key(11).tolist()
        assert st.top_k.tolist() == [0, 4]
        slot_cache.release_slot(st, 1)
        assert not bool(st.active.any())

    def test_validation(self, llama):
        model, _ = llama
        with pytest.raises(ValueError, match="max_seq_len"):
            Engine(model, prompt_buckets=(256,))
        eng = Engine(model, max_slots=1, prompt_buckets=BUCKETS)
        with pytest.raises(ValueError, match="bucket"):
            eng.validate_request(17, 4)
        with pytest.raises(ValueError, match="top_k"):
            eng.validate_request(4, 4, 1.0, top_k=5000)
        with pytest.raises(ValueError, match="top_p"):
            eng.validate_request(4, 4, 1.0, top_p=1.5)
        with pytest.raises(ValueError, match="prompt_buckets"):
            InferenceServer(model, kv_cache="paged", prompt_buckets=BUCKETS)
        with pytest.raises(ValueError, match="needs 2 devices"):
            InferenceServer(model, kv_cache="paged", tp=2)


class TestSchedulerAndServer:
    def test_queue_full(self, llama):
        model, _ = llama
        sched = Scheduler(Engine(model, max_slots=1, prompt_buckets=BUCKETS),
                          queue_capacity=1)
        sched.submit(Request(prompt=np.array([1, 2]), max_new_tokens=1))
        with pytest.raises(QueueFull):
            sched.submit(Request(prompt=np.array([1, 2]), max_new_tokens=1))

    def test_submit_to_stopped_server_raises(self, llama):
        model, _ = llama
        srv = InferenceServer(model, max_slots=1, prompt_buckets=BUCKETS)
        with pytest.raises(ServerClosed):
            srv.submit([1, 2, 3], max_new_tokens=2)

    def test_transient_step_fault_requeues_and_completes(self, llama):
        model, ref = llama
        plan = faults.FaultPlan([faults.FaultSpec(
            site="serving.step", kind="transient", step=2)])
        with faults.active(plan), InferenceServer(
                model, max_slots=3, prompt_buckets=BUCKETS) as srv:
            handles = [srv.submit(**r) for r in _requests()]
            got = [h.result(timeout=60) for h in handles]
            health = srv.health()
        assert plan.fire_count(0) == 1
        assert health["requeues"] >= 1 and health["failed_requests"] == 0
        assert [len(g) for g in got] == [len(r) for r in ref]
        # greedy continuations resume from the streamed prefix
        assert got[0] == ref[0] and got[5] == ref[5]

    def test_admission_faults_fail_the_request(self, llama):
        model, _ = llama
        plan = faults.FaultPlan([faults.FaultSpec(
            site="serving.admit", kind="transient")])
        with faults.active(plan), InferenceServer(
                model, max_slots=1, prompt_buckets=BUCKETS) as srv:
            h = srv.submit([1, 2, 3], max_new_tokens=2)
            with pytest.raises(RequestFailed, match="admission"):
                h.result(timeout=60)

    def test_deadline_expires(self, llama):
        model, _ = llama
        with InferenceServer(model, max_slots=1,
                             prompt_buckets=BUCKETS) as srv:
            h = srv.submit([1, 2, 3], max_new_tokens=4, deadline=0.0)
            with pytest.raises(RequestFailed, match="deadline"):
                h.result(timeout=60)
            assert srv.health()["deadline_expired"] == 1

    def test_fault_plan_is_deterministic(self):
        spec = faults.FaultSpec(site="s", kind="transient", prob=0.5)
        fired = [spec.matches("s", i, 3, 0) for i in range(64)]
        assert fired == [spec.matches("s", i, 3, 0) for i in range(64)]
        assert 0 < sum(fired) < 64
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.FaultSpec(site="s", kind="boom")


def test_metrics_writer_orders_merges_and_dedupes():
    seen = []
    w = MetricsWriter(sink=lambda step, row: seen.append((step, row)))
    w(2, {"a": 1})
    w(1, {"a": 0})
    w(2, {"a": 9, "b": 2})
    assert [s for s, _ in w.drain()] == [1, 2]
    assert seen[1] == (2, {"a": 1.0, "b": 2.0})
    w(2, {"a": 5})
    assert w.drain() == []
    assert percentile_summary([], "p50", "p99") == {}
    out = percentile_summary([1.0, 2.0, 3.0], "p50", "p99", scale=10)
    assert out["p50"] == 20.0
