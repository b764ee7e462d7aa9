"""The port's paged attention held against the JAX package's.

The same numpy-made pools, tables and queries go through
``apex_tpu.ops.paged_attention`` (its XLA reference and its Pallas
kernels in interpret mode, as the JAX package's own tests run them on
the CPU) and through ``apex_tpu_torch.ops.paged_attention``'s plain
versions.  Written pages, codes and scales must be bitwise equal on live
pages; attention outputs agree within 1e-5 of each output's largest
entry in fp32 (the sums run in another order: XLA's einsum, the Pallas
online softmax over pages and PyTorch's einsum each add the keys in
their own order, and nothing else differs).  ``TestChunkEdges`` holds
the plain ``paged_attention`` at the shapes where the Hopper chunk
kernel changes its course — 9, 16, 64, 65, 128 and 129 query lanes per
kv head (one lane past the decode kernel's 8, a GQA verify, one and two
warpgroups, one lane into a second warpgroup or item), d 64 and 128,
pages of 8 and 16 and lengths 0, page - 1 and page — in fp32 (1e-5, as
above), bf16 and fp16 (both sides round the same fp32 result: one ulp,
2^-7 of the largest entry; the Pallas kernel's q pre-scaled in q's
dtype and P rounded to it stay within that too) and on int8 / e4m3
pools (1e-5).
``TestSplitModel`` holds ``paged_attention_splits`` and
``paged_decode_fused_splits``, the plain model of the split-K kernels
for up to 8 query lanes per kv head (each split's online softmax, then
the merge in split order), against the JAX function through its XLA
reference and its Pallas kernel in interpret mode: splits of 1 page, 3
pages and more than the row, lengths 0, 1, page - 1, page and page + 1,
a 256-page table with 3 live pages, 1, 4, 5 and 8 lanes, GQA 32/8 at s =
1 and 2, int8 and e4m3 pools, and the fused step with RoPE where the
written row opens a page and where the row is at max_seq_len (1e-5 of
the largest output entry in fp32, as above: only the order of the sums
differs; the written pages, codes and scales bitwise).
``TestEnvelope`` holds ``paged_kernel_ok`` (ROADMAP C-8) against the JAX
functions' own ``pallas_ok`` (their call of ``resolve_impl`` intercepted)
at head dims 36-264, GQA groups 1-16 and pool dtypes: equal up to head
dim 256, the plain route above it; the log line once per shape and the
error of an explicit ``implementation="kernel"``.  ``TestWideHeads``
holds the plain versions at head dims 80, 96 and 256 and GQA groups 12
and 16 against the XLA reference (1e-5; pages, codes, scales bitwise).
``cuda``-marked tests hold the CUDA kernels against the plain versions
and skip without a card (``TestWideKernels``: head dims 72-256 and
groups above 8).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules (both packages' ops namespaces export the functions)
J = importlib.import_module("apex_tpu.ops.paged_attention")
P = importlib.import_module("apex_tpu_torch.ops.paged_attention")

REL = 1e-5
KV_DTYPES = ["int8", "fp8"]


def to_torch(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def bits(x):
    """Raw bytes of a jax array or torch tensor, for bitwise checks."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def bits_t(t):
    return t.contiguous().view(torch.uint8)


def close(got, ref, rel=REL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), err


def pool(rng, *, b, hk, d, NB, BS, MB, lengths, s, garbage=0.0):
    """Pool + disjoint per-row tables covering ``lengths[i] + s`` tokens
    (block 0 is the null page); pages no table maps, and the null page,
    hold ``garbage``-scaled noise when it is set."""
    kp = rng.normal(size=(hk, NB, BS, d)).astype(np.float32)
    vp = rng.normal(size=(hk, NB, BS, d)).astype(np.float32)
    tables = np.zeros((b, MB), np.int32)
    free = list(range(1, NB))
    for i, L in enumerate(lengths):
        for j in range(-(-(L + s) // BS)):
            tables[i, j] = free.pop()
    if garbage:
        dead = np.setdiff1d(np.arange(NB), tables[tables > 0])
        kp[:, dead] *= garbage
        vp[:, dead] *= garbage
    return kp, vp, tables


class TestHelpers:
    def test_kv_quant_spec_and_bytes(self):
        assert P.kv_quant_spec(None) == (None, None)
        assert P.kv_quant_spec("int8") == (torch.int8, 127.0)
        assert P.kv_quant_spec("fp8") == (torch.float8_e4m3fn, 448.0)
        with pytest.raises(ValueError, match="kv_dtype"):
            P.kv_quant_spec("int4")
        for kv in (None, "int8", "fp8"):
            for bs in (8, 16):
                assert P.kv_store_bytes_per_token(
                    128, bs, kv, dtype=torch.bfloat16) == \
                    J.kv_store_bytes_per_token(128, bs, kv,
                                               dtype=jnp.bfloat16)
        with pytest.raises(ValueError, match="dtype is required"):
            P.kv_store_bytes_per_token(128, 16)
        assert P._TINY_SCALE == J._TINY_SCALE

    def test_tp_head_shards(self):
        for h, hk, tp in ((32, 8, 2), (32, 32, 4), (8, 2, 1)):
            assert P.tp_head_shards(h, hk, tp) == J.tp_head_shards(h, hk, tp)
        with pytest.raises(ValueError, match="divisible"):
            P.tp_head_shards(8, 2, 3)

    @pytest.mark.parametrize("kv_dtype", KV_DTYPES)
    def test_quantize_kv_and_pages_bitwise(self, kv_dtype):
        rng = np.random.default_rng(0)
        kp = rng.normal(size=(2, 6, 8, 64)).astype(np.float32)
        vp = 3 * rng.normal(size=(2, 6, 8, 64)).astype(np.float32)
        kp[:, 2] = 0.0                              # an all-zero page
        vp[:, 3, :, :5] = 1e-40                     # below the tiny guard
        got = P.quantize_kv_pages(torch.from_numpy(kp),
                                  torch.from_numpy(vp), kv_dtype)
        ref = J.quantize_kv_pages(jnp.asarray(kp), jnp.asarray(vp), kv_dtype)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(bits(g), bits(r))
        # row scales, one of them stale-small (the clamp engages)
        x = rng.normal(size=(5, 64)).astype(np.float32)
        sc = np.abs(x).max(-1) * np.array([1, 1, 0.5, 0, 2], np.float32)
        store, qmax = P.kv_quant_spec(kv_dtype)
        g = P.quantize_kv(torch.from_numpy(x), torch.from_numpy(sc), qmax,
                          store)
        r = J.quantize_kv(jnp.asarray(x), jnp.asarray(sc), qmax,
                          J.kv_quant_spec(kv_dtype)[0])
        np.testing.assert_array_equal(bits(g), bits(r))


class TestPagedAttention:
    @pytest.mark.parametrize("s,h,hk", [
        (1, 4, 4),        # decode, MHA
        (1, 8, 2),        # decode, GQA 4:1
        (4, 4, 4),        # speculative verify, 1 + 3 drafts
        (8, 8, 2),        # chunk, GQA
    ])
    @pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
    def test_plain_matches_jax(self, s, h, hk, impl):
        rng = np.random.default_rng(1)
        b, d, NB, BS, MB = 3, 64, 24, 8, 6
        lengths = [9, 0, 31]                # mid-page, empty, page end
        kp, vp, tables = pool(rng, b=b, hk=hk, d=d, NB=NB, BS=BS, MB=MB,
                              lengths=lengths, s=s, garbage=1e4)
        q = rng.normal(size=(b, s, h, d)).astype(np.float32)
        lens = np.asarray(lengths, np.int32)
        ref = J.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                jnp.asarray(lens), implementation=impl)
        got = P.paged_attention(*(torch.from_numpy(a) for a in (
            q, kp, vp, tables, lens)))
        close(got, ref)

    @pytest.mark.parametrize("kv_dtype", KV_DTYPES)
    @pytest.mark.parametrize("s,h,hk", [(1, 4, 4), (1, 8, 2), (5, 4, 2)])
    def test_quantized_matches_jax(self, kv_dtype, s, h, hk):
        rng = np.random.default_rng(2)
        b, d, NB, BS, MB = 3, 64, 24, 8, 6
        lengths = [15, 16, 0]
        kp, vp, tables = pool(rng, b=b, hk=hk, d=d, NB=NB, BS=BS, MB=MB,
                              lengths=lengths, s=s)
        kq, vq, ks, vs = J.quantize_kv_pages(jnp.asarray(kp),
                                             jnp.asarray(vp), kv_dtype)
        q = rng.normal(size=(b, s, h, d)).astype(np.float32)
        lens = np.asarray(lengths, np.int32)
        for impl in ("xla", "pallas_interpret"):
            ref = J.paged_attention(jnp.asarray(q), kq, vq,
                                    jnp.asarray(tables), jnp.asarray(lens),
                                    k_scales=ks, v_scales=vs,
                                    implementation=impl)
            got = P.paged_attention(
                torch.from_numpy(q), to_torch(kq), to_torch(vq),
                torch.from_numpy(tables), torch.from_numpy(lens),
                k_scales=to_torch(ks), v_scales=to_torch(vs))
            close(got, ref)

    def test_bf16_matches_jax(self):
        rng = np.random.default_rng(3)
        b, s, h, hk, d, NB, BS, MB = 2, 4, 4, 2, 64, 16, 8, 4
        kp, vp, tables = pool(rng, b=b, hk=hk, d=d, NB=NB, BS=BS, MB=MB,
                              lengths=[7, 20], s=s)
        args = [jnp.asarray(a, jnp.bfloat16) for a in (
            rng.normal(size=(b, s, h, d)), kp, vp)]
        lens = np.asarray([7, 20], np.int32)
        ref = J.paged_attention(*args, jnp.asarray(tables),
                                jnp.asarray(lens), implementation="xla")
        got = P.paged_attention(*(to_torch(a) for a in args),
                                torch.from_numpy(tables),
                                torch.from_numpy(lens))
        assert got.dtype == torch.bfloat16
        # both round the same fp32 result to bf16: within one bf16 ulp
        close(got, ref, rel=2 ** -7)

    def test_garbage_and_placement_never_reach_the_output(self):
        rng = np.random.default_rng(4)
        b, s, h, hk, d, NB, BS, MB = 2, 3, 4, 2, 64, 30, 8, 5
        kp, vp, tables = pool(rng, b=b, hk=hk, d=d, NB=NB, BS=BS, MB=MB,
                              lengths=[10, 3], s=s)
        q = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(
            np.float32))
        lens = torch.tensor([10, 3], dtype=torch.int32)
        base = P.paged_attention(q, torch.from_numpy(kp),
                                 torch.from_numpy(vp),
                                 torch.from_numpy(tables), lens)
        live = sorted({int(t) for t in tables.ravel() if t})
        dest = {blk: i + 1 for i, blk in enumerate(live)}
        kp2 = rng.normal(size=kp.shape).astype(np.float32) * 1e30
        vp2 = rng.normal(size=vp.shape).astype(np.float32) * 1e30
        for src, dst in dest.items():
            kp2[:, dst], vp2[:, dst] = kp[:, src], vp[:, src]
        tables2 = np.vectorize(lambda t: dest.get(t, 0))(tables).astype(
            np.int32)
        moved = P.paged_attention(q, torch.from_numpy(kp2),
                                  torch.from_numpy(vp2),
                                  torch.from_numpy(tables2), lens)
        assert torch.equal(base, moved)

    def test_validation(self):
        q = torch.zeros(2, 1, 4, 64)
        kp = torch.zeros(2, 5, 8, 64)
        tables = torch.zeros(2, 3, dtype=torch.int32)
        lens = torch.zeros(2, dtype=torch.int32)
        with pytest.raises(ValueError, match="head_dim"):
            P.paged_attention(q, kp[..., :32], kp[..., :32], tables, lens)
        with pytest.raises(ValueError, match="do not match"):
            P.paged_attention(q, kp, kp, tables[:1], lens)
        with pytest.raises(ValueError, match="need k_scales"):
            P.paged_attention(q, kp.to(torch.int8), kp.to(torch.int8),
                              tables, lens)
        with pytest.raises(ValueError, match="only apply"):
            P.paged_attention(q, kp, kp, tables, lens,
                              k_scales=torch.zeros(2, 5),
                              v_scales=torch.zeros(2, 5))
        # a tensor-parallel rank passes its heads: a q slice that does
        # not cover whole kv groups of its pool shard is refused
        with pytest.raises(ValueError, match="must divide num_heads"):
            P.paged_attention(q[:, :, :3], kp, kp, tables, lens)
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            P.paged_attention(q, kp, kp, tables, lens,
                              implementation="kernel")


def fused_case(rng, *, b=5, h=8, hk=4, d=64, BS=8, S=64, kv_dtype=None,
               lengths=(5, 8, 23, 0, 64), rope=True, pad_rows=()):
    """Pool, tables and the new rows of one decode step: a mid-page
    append, a fresh page at offset 0, a page-end append, an empty row
    and a row at max_seq_len; ``pad_rows`` get chunk_lens 0."""
    MB = S // BS
    NB = b * MB + 3
    kp = rng.normal(size=(hk, NB, BS, d)).astype(np.float32)
    vp = rng.normal(size=(hk, NB, BS, d)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)[:b]
    tables = np.zeros((b, MB), np.int32)
    used = rng.permutation(np.arange(1, NB))[: b * MB].reshape(b, MB)
    for r in range(b):
        n = min(MB, -(-int(min(lengths[r], S - 1) + 1) // BS))
        tables[r, :n] = used[r, :n]
    jx = dict(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp))
    if kv_dtype is not None:
        kq, vq, ks, vs = J.quantize_kv_pages(jx["k_pages"], jx["v_pages"],
                                             kv_dtype)
        cl = np.ones((b,), np.int32)
        cl[list(pad_rows)] = 0
        jx = dict(k_pages=kq, v_pages=vq, k_scales=ks, v_scales=vs,
                  chunk_lens=jnp.asarray(cl))
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    nk = rng.normal(size=(b, 1, hk, d)).astype(np.float32)
    nv = rng.normal(size=(b, 1, hk, d)).astype(np.float32)
    if rope:
        inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
        pos = np.minimum(lengths, S - 1).astype(np.float32)
        ang = np.outer(pos, inv).astype(np.float32)
        jx["cos_b"] = jnp.asarray(np.cos(ang)[:, None, None, :])
        jx["sin_b"] = jnp.asarray(np.sin(ang)[:, None, None, :])
    live = tables.ravel()
    return (q, nk, nv, tables, lengths, jx, S, np.unique(live[live > 0]))


def run_fused(case, impl):
    q, nk, nv, tables, lengths, jx, S, _live = case
    if impl == "torch":
        kw = {k: to_torch(v) for k, v in jx.items()}
        kp, vp = kw.pop("k_pages"), kw.pop("v_pages")
        return P.paged_decode_fused(
            torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
            kp, vp, torch.from_numpy(tables), torch.from_numpy(lengths),
            max_seq_len=S, **kw)
    # eager, op by op: under jit XLA's CPU compiler contracts the
    # rotation's x1*cos - x2*sin into one fma, where the port (and its
    # CUDA kernel) round each product and the difference on their own
    kw = dict(jx)
    kp, vp = kw.pop("k_pages"), kw.pop("v_pages")
    return J.paged_decode_fused(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), kp, vp,
        jnp.asarray(tables), jnp.asarray(lengths), max_seq_len=S,
        implementation=impl, **kw)


# the Hopper chunk kernel's edges: s, h, hk, d, page size; lanes (h //
# hk * s) 9, 16, 64, 65, 128 and 129
CHUNK_EDGES = [
    (9, 2, 2, 64, 8),
    (4, 8, 2, 128, 16),
    (16, 8, 2, 64, 16),
    (65, 2, 2, 64, 8),
    (32, 8, 2, 128, 8),
    (43, 6, 2, 64, 16),
]
EDGE_IDS = [f"lanes{h // hk * s}-d{d}-bs{bs}"
            for s, h, hk, d, bs in CHUNK_EDGES]


def edge_case(rng, geom, lengths=None, garbage=1e4):
    """Pool, tables, lengths 0 / page - 1 / page (or ``lengths``) and
    fp32 queries of one CHUNK_EDGES geometry, as numpy arrays."""
    s, h, hk, d, BS = geom
    lengths = [0, BS - 1, BS] if lengths is None else lengths
    MB = max(-(-(n + s) // BS) for n in lengths)
    NB = 1 + sum(-(-(n + s) // BS) for n in lengths) + 4
    kp, vp, tables = pool(rng, b=len(lengths), hk=hk, d=d, NB=NB, BS=BS,
                          MB=MB, lengths=lengths, s=s, garbage=garbage)
    q = rng.normal(size=(len(lengths), s, h, d)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


class TestChunkEdges:
    @pytest.mark.parametrize("geom", CHUNK_EDGES, ids=EDGE_IDS)
    @pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
    def test_fp32_matches_jax(self, geom, impl):
        rng = np.random.default_rng(20)
        arrays = edge_case(rng, geom)
        ref = J.paged_attention(*(jnp.asarray(a) for a in arrays),
                                implementation=impl)
        close(P.paged_attention(*(torch.from_numpy(a) for a in arrays)),
              ref)

    @pytest.mark.parametrize("geom", CHUNK_EDGES, ids=EDGE_IDS)
    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    @pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
    def test_half_matches_jax(self, geom, dtype, impl):
        rng = np.random.default_rng(21)
        q, kp, vp, tables, lens = edge_case(rng, geom, garbage=0.0)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float16
        args = [jnp.asarray(a, jdt) for a in (q, kp, vp)]
        ref = J.paged_attention(*args, jnp.asarray(tables),
                                jnp.asarray(lens), implementation=impl)
        got = P.paged_attention(*(to_torch(a) for a in args),
                                torch.from_numpy(tables),
                                torch.from_numpy(lens))
        assert got.dtype == getattr(torch, dtype)
        close(got, ref, rel=2 ** -7)

    @pytest.mark.parametrize("kv_dtype", KV_DTYPES)
    @pytest.mark.parametrize("geom", CHUNK_EDGES[1::2], ids=EDGE_IDS[1::2])
    def test_coded_matches_jax(self, kv_dtype, geom):
        rng = np.random.default_rng(22)
        q, kp, vp, tables, lens = edge_case(rng, geom, garbage=0.0)
        kq, vq, ks, vs = J.quantize_kv_pages(jnp.asarray(kp),
                                             jnp.asarray(vp), kv_dtype)
        for impl in ("xla", "pallas_interpret"):
            ref = J.paged_attention(jnp.asarray(q), kq, vq,
                                    jnp.asarray(tables), jnp.asarray(lens),
                                    k_scales=ks, v_scales=vs,
                                    implementation=impl)
            got = P.paged_attention(
                torch.from_numpy(q), to_torch(kq), to_torch(vq),
                torch.from_numpy(tables), torch.from_numpy(lens),
                k_scales=to_torch(ks), v_scales=to_torch(vs))
            close(got, ref)


class TestPagedDecodeFused:
    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("rope", [True, False])
    @pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
    def test_plain_matches_jax(self, kv_dtype, rope, impl):
        rng = np.random.default_rng(5)
        case = fused_case(rng, kv_dtype=kv_dtype, rope=rope,
                          pad_rows=(2,) if kv_dtype else ())
        live = case[-1]
        ref = run_fused(case, impl)
        got = run_fused(case, "torch")
        assert len(got) == len(ref) == (3 if kv_dtype is None else 5)
        close(got[0], ref[0])
        # pages, codes and scales bitwise on live pages — but the Pallas
        # kernel's own rotation is contracted into an fma even in
        # interpret mode, so its unquantized rotated keys may differ by
        # the rounding of one product (an fp32 ulp of values below 8, so
        # 2^-20; the codes round that away)
        for i, (g, r) in enumerate(zip(got[1:], ref[1:])):
            g, r = g[:, live], np.asarray(r[:, live])
            if impl == "pallas_interpret" and rope and kv_dtype is None \
                    and i == 0:
                np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                           atol=2.0 ** -20)
                continue
            np.testing.assert_array_equal(bits(g), bits(r))

    def test_gqa_bf16_pages_bitwise(self):
        rng = np.random.default_rng(6)
        q, nk, nv, tables, lengths, jx, S, live = fused_case(
            rng, b=3, h=8, hk=2, lengths=(9, 16, 0))
        jx = {k: (v.astype(jnp.bfloat16) if k.endswith("pages") else v)
              for k, v in jx.items()}
        qb, nkb, nvb = (np.asarray(jnp.asarray(a, jnp.bfloat16))
                        for a in (q, nk, nv))
        case = (qb, nkb, nvb, tables, lengths, jx, S, live)
        ref = run_fused(case, "xla")
        kw = {k: to_torch(v) for k, v in jx.items()}
        got = P.paged_decode_fused(
            to_torch(qb), to_torch(nkb), to_torch(nvb), kw.pop("k_pages"),
            kw.pop("v_pages"), torch.from_numpy(tables),
            torch.from_numpy(lengths), max_seq_len=S, **kw)
        close(got[0], ref[0], rel=2 ** -7)
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(bits(g[:, live]),
                                          bits(r[:, live]))

    def test_pad_rows_never_touch_a_live_scale(self):
        rng = np.random.default_rng(7)
        case = fused_case(rng, kv_dtype="int8", pad_rows=(0, 1, 2))
        got = run_fused(case, "torch")
        jx = case[5]
        pages = case[3][:3].ravel()
        pages = pages[pages > 0]                 # the pad rows' own pages
        for name, out in (("k_pages", got[1]), ("k_scales", got[3]),
                          ("v_scales", got[4])):
            assert torch.equal(bits_t(out[:, pages]),
                               bits_t(to_torch(jx[name])[:, pages]))

    def test_updates_the_pool_in_place(self):
        rng = np.random.default_rng(8)
        q, nk, nv, tables, lengths, jx, S, _ = fused_case(rng)
        kp, vp = to_torch(jx["k_pages"]), to_torch(jx["v_pages"])
        o, kp2, vp2 = P.paged_decode_fused(
            torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
            kp, vp, torch.from_numpy(tables), torch.from_numpy(lengths),
            max_seq_len=S)
        assert kp2 is kp and vp2 is vp
        r = 0
        phys, off = tables[r, lengths[r] // 8], lengths[r] % 8
        assert not torch.equal(kp[:, phys, off],
                               to_torch(jx["k_pages"])[:, phys, off])

    def test_validation(self):
        rng = np.random.default_rng(9)
        q, nk, nv, tables, lengths, jx, S, _ = fused_case(rng)
        t = [torch.from_numpy(a) for a in (q, nk, nv)]
        kp, vp = to_torch(jx["k_pages"]), to_torch(jx["v_pages"])
        tl = (torch.from_numpy(tables), torch.from_numpy(lengths))
        with pytest.raises(ValueError, match="width-1"):
            P.paged_decode_fused(torch.cat([t[0], t[0]], 1), *t[1:], kp, vp,
                                 *tl, max_seq_len=S)
        with pytest.raises(ValueError, match="need k_scales"):
            P.paged_decode_fused(*t, kp.to(torch.int8), vp.to(torch.int8),
                                 *tl, max_seq_len=S)
        with pytest.raises(ValueError, match="only apply"):
            P.paged_decode_fused(*t, kp, vp, *tl, max_seq_len=S,
                                 chunk_lens=torch.ones(5, dtype=torch.int32))
        with pytest.raises(ValueError, match="come together"):
            P.paged_decode_fused(*t, kp, vp, *tl, max_seq_len=S,
                                 cos_b=torch.zeros(5, 1, 1, 32))
        # a rank's shard of the pool takes its own kv heads' new rows
        with pytest.raises(ValueError, match="k_new shape"):
            P.paged_decode_fused(*t, kp[:2], vp[:2], *tl, max_seq_len=S)


# --------------------------------------------------------------------- #
# the plain model of the split-K kernels (up to 8 lanes per kv head)
# --------------------------------------------------------------------- #
# s, h, hk: lanes (h // hk * s) 1, 4 (the MHA verify), 5, 8, and GQA
# 32/8 at s = 1 and 2
SPLIT_GEOMS = [(1, 4, 4), (4, 4, 4), (5, 2, 2), (2, 8, 2), (1, 32, 8),
               (2, 32, 8)]
SPLIT_IDS = ["lanes1", "verify4", "lanes5", "gqa-lanes8", "gqa32-8-s1",
             "gqa32-8-s2"]
SPLIT_PAGES = [1, 3, 100]          # 100 pages: more than any row


def split_case(rng, s, h, hk, *, BS=8, MB=None, lengths=None, garbage=1e4,
               d=32):
    """Pool, tables, fp32 queries and lengths 0 / 1 / page - 1 / page /
    page + 1 (or ``lengths``), as numpy arrays; tables ``MB`` pages wide
    (default: as wide as the longest row needs)."""
    lengths = [0, 1, BS - 1, BS, BS + 1] if lengths is None else lengths
    need = [-(-(n + s) // BS) for n in lengths]
    MB = max(need) if MB is None else MB
    NB = 1 + sum(need) + 4
    kp, vp, tables = pool(rng, b=len(lengths), hk=hk, d=d, NB=NB, BS=BS,
                          MB=MB, lengths=lengths, s=s, garbage=garbage)
    q = rng.normal(size=(len(lengths), s, h, d)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


class TestSplitModel:
    @pytest.mark.parametrize("split_pages", SPLIT_PAGES)
    @pytest.mark.parametrize("geom", SPLIT_GEOMS, ids=SPLIT_IDS)
    @pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
    def test_matches_jax(self, geom, split_pages, impl):
        rng = np.random.default_rng(30)
        arrays = split_case(rng, *geom)
        ref = J.paged_attention(*(jnp.asarray(a) for a in arrays),
                                implementation=impl)
        got = P.paged_attention_splits(
            *(torch.from_numpy(a) for a in arrays), split_pages=split_pages)
        close(got, ref)

    @pytest.mark.parametrize("split_pages", [1, 3, 100])
    @pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
    def test_wide_table_few_live_pages(self, split_pages, impl):
        """The engine's tables: 256 pages a row, 3 of them live (the
        rest point at the null page, full of garbage)."""
        rng = np.random.default_rng(31)
        arrays = split_case(rng, 1, 4, 2, MB=256, lengths=[17, 23, 9])
        ref = J.paged_attention(*(jnp.asarray(a) for a in arrays),
                                implementation=impl)
        got = P.paged_attention_splits(
            *(torch.from_numpy(a) for a in arrays), split_pages=split_pages)
        close(got, ref)

    @pytest.mark.parametrize("kv_dtype", KV_DTYPES)
    @pytest.mark.parametrize("split_pages", [1, 3])
    @pytest.mark.parametrize("geom", [SPLIT_GEOMS[0], SPLIT_GEOMS[3]],
                             ids=[SPLIT_IDS[0], SPLIT_IDS[3]])
    def test_coded_matches_jax(self, geom, split_pages, kv_dtype):
        rng = np.random.default_rng(32)
        q, kp, vp, tables, lens = split_case(rng, *geom, garbage=0.0)
        kq, vq, ks, vs = J.quantize_kv_pages(jnp.asarray(kp),
                                             jnp.asarray(vp), kv_dtype)
        for impl in ("xla", "pallas_interpret"):
            ref = J.paged_attention(jnp.asarray(q), kq, vq,
                                    jnp.asarray(tables), jnp.asarray(lens),
                                    k_scales=ks, v_scales=vs,
                                    implementation=impl)
            got = P.paged_attention_splits(
                torch.from_numpy(q), to_torch(kq), to_torch(vq),
                torch.from_numpy(tables), torch.from_numpy(lens),
                split_pages=split_pages, k_scales=to_torch(ks),
                v_scales=to_torch(vs))
            close(got, ref)

    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("split_pages", [1, 3, 100])
    @pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
    def test_fused_matches_jax(self, kv_dtype, split_pages, impl):
        """The fused step with RoPE: rows writing mid-page, opening a page
        (length 8 at pages of 8), at a page's end, empty, and at
        max_seq_len (nothing written)."""
        rng = np.random.default_rng(33)
        case = fused_case(rng, kv_dtype=kv_dtype, rope=True,
                          pad_rows=(2,) if kv_dtype else ())
        q, nk, nv, tables, lengths, jx, S, live = case
        ref = run_fused(case, impl)
        kw = {k: to_torch(v) for k, v in jx.items()}
        got = P.paged_decode_fused_splits(
            torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
            kw.pop("k_pages"), kw.pop("v_pages"), torch.from_numpy(tables),
            torch.from_numpy(lengths), split_pages=split_pages,
            max_seq_len=S, **kw)
        close(got[0], ref[0])
        plain = run_fused(case, "torch")
        for g, r in zip(got[1:], plain[1:]):
            np.testing.assert_array_equal(bits(g[:, live]), bits(r[:, live]))

    def test_split_sizes_agree(self):
        """Every split size gives the plain version's output within 1e-5,
        on a long row whose balanced splits end mid-way."""
        rng = np.random.default_rng(34)
        q, kp, vp, tables, lens = (torch.from_numpy(a) for a in split_case(
            rng, 2, 8, 2, BS=16, lengths=[300, 5, 47]))
        ref = P.paged_attention_reference(q, kp, vp, tables, lens)
        for sp in (1, 2, 3, 5, 8, 19, 64):
            close(P.paged_attention_splits(q, kp, vp, tables, lens,
                                           split_pages=sp), ref.numpy())


# --------------------------------------------------------------------- #
# the CUDA kernels against the plain versions (on a card only)
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernels:
    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("s,h,hk,d", [(1, 32, 32, 128), (1, 32, 8, 128),
                                          (4, 8, 8, 64), (20, 8, 2, 128)])
    def test_paged_attention(self, cuda_device, kv_dtype, s, h, hk, d):
        rng = np.random.default_rng(10)
        b, NB, BS, MB = 3, 40, 16, 8
        kp, vp, tables = pool(rng, b=b, hk=hk, d=d, NB=NB, BS=BS, MB=MB,
                              lengths=[40, 0, 81], s=s, garbage=1e30)
        dev = cuda_device
        kpt, vpt = torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)
        kw = {}
        if kv_dtype:
            kpt, vpt, ks, vs = P.quantize_kv_pages(kpt, vpt, kv_dtype)
            kw = dict(k_scales=ks, v_scales=vs)
        q = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(
            np.float32)).to(dev)
        args = (q, kpt, vpt, torch.from_numpy(tables).to(dev),
                torch.tensor([40, 0, 81], dtype=torch.int32, device=dev))
        got = P.paged_attention(*args, **kw)
        ref = P.paged_attention(*args, implementation="torch", **kw)
        close(got.cpu(), ref.cpu().numpy())

    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("rope", [True, False])
    def test_paged_decode_fused(self, cuda_device, kv_dtype, rope):
        rng = np.random.default_rng(11)
        q, nk, nv, tables, lengths, jx, S, live = fused_case(
            rng, kv_dtype=kv_dtype, rope=rope, d=128,
            pad_rows=(3,) if kv_dtype else ())
        outs = []
        for impl in ("kernel", "torch"):
            kw = {k: to_torch(v).to(cuda_device) for k, v in jx.items()}
            outs.append(P.paged_decode_fused(
                *(torch.from_numpy(a).to(cuda_device) for a in (q, nk, nv)),
                kw.pop("k_pages"), kw.pop("v_pages"),
                torch.from_numpy(tables).to(cuda_device),
                torch.from_numpy(lengths).to(cuda_device), max_seq_len=S,
                implementation=impl, **kw))
        got, ref = outs
        close(got[0].cpu(), ref[0].cpu().numpy())
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(bits(g[:, live].cpu()),
                                          bits(r[:, live].cpu()))


@pytest.mark.cuda
class TestChunkKernel:
    """The Hopper chunk kernel (bf16 / fp16 q, pages of 8-64) and the tile
    kernel it leaves pages of 128 to, against the plain version: o within
    2^-7 of its largest entry (``chip_smoke.py``'s tolerance: P enters the
    value product in q's dtype), and a rerun bit for bit."""

    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    @pytest.mark.parametrize("geom", CHUNK_EDGES + [
        (24, 4, 4, 128, 32), (20, 8, 2, 64, 64), (16, 4, 4, 128, 128)],
        ids=EDGE_IDS + ["bs32", "bs64", "bs128-tile"])
    def test_matches_plain_and_reruns_bitwise(self, cuda_device, geom,
                                               dtype, kv_dtype):
        rng = np.random.default_rng(12)
        BS = geom[-1]
        q, kp, vp, tables, lens = edge_case(
            rng, geom, lengths=[0, BS - 1, BS, 3 * BS + 5], garbage=1e4)
        dev = cuda_device
        kpt, vpt = (torch.from_numpy(a).to(dev).to(dtype) for a in (kp, vp))
        kw = {}
        if kv_dtype:
            kpt, vpt, ks, vs = P.quantize_kv_pages(kpt, vpt, kv_dtype)
            kw = dict(k_scales=ks, v_scales=vs)
        args = (torch.from_numpy(q).to(dev).to(dtype), kpt, vpt,
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(lens).to(dev))
        got = P.paged_attention(*args, **kw)
        ref = P.paged_attention(*args, implementation="torch", **kw)
        close(got.cpu(), ref.cpu().float().numpy(), rel=2 ** -7)
        assert torch.equal(got, P.paged_attention(*args, **kw))


@pytest.mark.cuda
class TestSplitKernels:
    """The split-K kernels (up to 8 lanes per kv head: ``paged_attention``
    at decode and verify widths, and ``paged_decode_fused``) against their
    plain versions at the shapes of ``TestSplitModel``, d 64 and 128, fp32
    (1e-5 of the largest output entry), bf16 (2^-7) and on int8 / e4m3
    pools: a rerun bit for bit, and the fused step's written pages, codes
    and scales bitwise on live pages."""

    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("geom", SPLIT_GEOMS, ids=SPLIT_IDS)
    @pytest.mark.parametrize("width", [None, 256])
    def test_attention(self, cuda_device, geom, dtype, kv_dtype, width):
        rng = np.random.default_rng(40)
        q, kp, vp, tables, lens = split_case(
            rng, *geom, BS=16, MB=width, d=128,
            lengths=[0, 1, 15, 16, 17, 300, 4000 if width else 70])
        dev = cuda_device
        kpt, vpt = (torch.from_numpy(a).to(dev).to(dtype) for a in (kp, vp))
        kw = {}
        if kv_dtype:
            kpt, vpt, ks, vs = P.quantize_kv_pages(kpt, vpt, kv_dtype)
            kw = dict(k_scales=ks, v_scales=vs)
        args = (torch.from_numpy(q).to(dev).to(dtype), kpt, vpt,
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(lens).to(dev))
        got = P.paged_attention(*args, **kw)
        ref = P.paged_attention(*args, implementation="torch", **kw)
        rel = REL if dtype == torch.float32 else 2 ** -7
        close(got.cpu(), ref.cpu().float().numpy(), rel=rel)
        assert torch.equal(got, P.paged_attention(*args, **kw))

    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [64, 128])
    def test_fused(self, cuda_device, kv_dtype, dtype, d):
        rng = np.random.default_rng(41)
        case = fused_case(rng, kv_dtype=kv_dtype, rope=True, d=d,
                          pad_rows=(3,) if kv_dtype else ())
        q, nk, nv, tables, lengths, jx, S, live = case

        def run(impl):
            kw = {k: to_torch(v).to(cuda_device) for k, v in jx.items()}
            kw["k_pages"] = kw["k_pages"].to(
                dtype if kv_dtype is None else kw["k_pages"].dtype)
            kw["v_pages"] = kw["v_pages"].to(
                dtype if kv_dtype is None else kw["v_pages"].dtype)
            return P.paged_decode_fused(
                *(torch.from_numpy(a).to(cuda_device).to(dtype)
                  for a in (q, nk, nv)),
                kw.pop("k_pages"), kw.pop("v_pages"),
                torch.from_numpy(tables).to(cuda_device),
                torch.from_numpy(lengths).to(cuda_device), max_seq_len=S,
                implementation=impl, **kw)
        got, again, ref = run("kernel"), run("kernel"), run("torch")
        rel = REL if dtype == torch.float32 else 2 ** -7
        close(got[0].cpu(), ref[0].cpu().float().numpy(), rel=rel)
        for a, b in zip(got, again):
            assert torch.equal(bits_t(a.cpu()), bits_t(b.cpu()))
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(bits(g[:, live].cpu()),
                                          bits(r[:, live].cpu()))


# --------------------------------------------------------------------- #
# the kernels' envelope (ROADMAP C-8) and the widened shapes
# --------------------------------------------------------------------- #
ENVELOPE_DIMS = [36, 64, 80, 96, 128, 256, 264]
GQA_GROUPS = [1, 4, 8, 16]


class _Stop(Exception):
    pass


def reference_pallas_ok(monkeypatch, fn, *args, **kw):
    """The ``pallas_ok`` of the JAX function ``fn`` for these inputs: its
    call of ``resolve_impl`` is intercepted, and the call ends there."""
    seen = {}

    def spy(implementation, *, pallas_ok=True, auto_default="pallas"):
        seen["ok"] = pallas_ok
        raise _Stop

    monkeypatch.setattr(J, "resolve_impl", spy)
    with pytest.raises(_Stop):
        fn(*args, **kw)
    return seen["ok"]


def envelope_inputs(d, group, *, bs=16, half=None, pages=jnp.bfloat16):
    """Zero JAX inputs of one decode step: 2 rows, 2 kv heads, ``group``
    query heads each, head dim ``d``; RoPE tables of ``half`` (default d
    // 2)."""
    hk, b, nb, mb = 2, 2, 6, 2
    half = d // 2 if half is None else half
    q = jnp.zeros((b, 1, hk * group, d), jnp.bfloat16)
    kp = jnp.zeros((hk, nb, bs, d), pages)
    new = jnp.zeros((b, 1, hk, d), jnp.bfloat16)
    tables = jnp.asarray(np.arange(1, 1 + b * mb).reshape(b, mb), jnp.int32)
    lens = jnp.asarray([3, 9], jnp.int32)
    cos = jnp.ones((b, 1, 1, half), jnp.float32)
    return q, kp, new, tables, lens, cos


class TestEnvelope:
    """``paged_kernel_ok`` routes every shape as the JAX package's
    ``pallas_ok`` does, for head dims up to 256 (the port's widest; above
    it the port routes to its plain version and says so), GQA groups of
    1-16 and both ops; pages and rotary halves that are not multiples of
    8, which the JAX package composes, stay on the port's kernels (they
    took them before the envelope)."""

    @pytest.mark.parametrize("group", GQA_GROUPS)
    @pytest.mark.parametrize("d", ENVELOPE_DIMS)
    def test_attention_routes_as_reference(self, monkeypatch, d, group):
        q, kp, _, tables, lens, _ = envelope_inputs(d, group)
        ref = reference_pallas_ok(monkeypatch, J.paged_attention, q, kp, kp,
                                  tables, lens)
        got = P.paged_kernel_ok(d, torch.bfloat16, torch.bfloat16)
        assert got == (ref and d <= P.MAX_HEAD_DIM)
        assert ref == (d % 8 == 0)

    @pytest.mark.parametrize("group", GQA_GROUPS)
    @pytest.mark.parametrize("d", ENVELOPE_DIMS)
    def test_fused_routes_as_reference(self, monkeypatch, d, group):
        q, kp, new, tables, lens, cos = envelope_inputs(d, group)
        ref = reference_pallas_ok(
            monkeypatch, J.paged_decode_fused, q, new, new, kp, kp, tables,
            lens, max_seq_len=32, cos_b=cos, sin_b=cos)
        got = P.paged_kernel_ok(d, torch.bfloat16, torch.bfloat16)
        if d <= P.MAX_HEAD_DIM:
            assert got == ref
        else:
            assert not got

    @pytest.mark.parametrize("pages,want", [
        (jnp.float32, False), (jnp.int8, True), (jnp.float8_e4m3fn, True)])
    def test_pool_dtype_routes_as_reference(self, monkeypatch, pages, want):
        q, kp, _, tables, lens, _ = envelope_inputs(64, 4, pages=pages)
        kw = {}
        if pages != jnp.float32:
            kw = dict(k_scales=jnp.ones((2, 6), jnp.float32),
                      v_scales=jnp.ones((2, 6), jnp.float32))
        ref = reference_pallas_ok(monkeypatch, J.paged_attention, q, kp, kp,
                                  tables, lens, **kw)
        tdt = {jnp.float32: torch.float32, jnp.int8: torch.int8,
               jnp.float8_e4m3fn: torch.float8_e4m3fn}[pages]
        assert ref == want
        assert P.paged_kernel_ok(64, torch.bfloat16, tdt) == want

    @pytest.mark.parametrize("bs,half", [(4, 32), (12, 32), (16, 4)])
    def test_kernels_keep_pages_and_halves_the_reference_composes(
            self, monkeypatch, bs, half):
        q, kp, new, tables, lens, cos = envelope_inputs(64, 2, bs=bs,
                                                        half=half)
        ref = reference_pallas_ok(
            monkeypatch, J.paged_decode_fused, q, new, new, kp, kp, tables,
            lens, max_seq_len=32, cos_b=cos, sin_b=cos)
        assert not ref
        assert P.paged_kernel_ok(64, torch.bfloat16, torch.bfloat16)

    @pytest.mark.parametrize("op", ["paged_attention", "paged_decode_fused"])
    def test_route_logs_once_and_an_explicit_kernel_raises(self, caplog,
                                                           op):
        import types

        q = types.SimpleNamespace(is_cuda=True, device="cuda:0",
                                  shape=(3, 1, 8, 36), dtype=torch.bfloat16)
        pages = types.SimpleNamespace(dtype=torch.bfloat16)
        with caplog.at_level("INFO", logger="apex_tpu_torch.ops"):
            assert P._route(None, q, pages, op) == "torch"
            assert P._route("auto", q, pages, op) == "torch"
        lines = [r.getMessage() for r in caplog.records]
        assert len(lines) == 1 and lines[0].startswith(
            f"{op}: falling back to the plain composition")
        assert "head_dim 36" in lines[0]
        with pytest.raises(ValueError, match="no kernel takes"):
            P._route("kernel", q, pages, op)
        q.shape = (3, 1, 8, 96)
        assert P._route(None, q, pages, op) == "kernel"
        assert P._route("torch", q, pages, op) == "torch"


class TestWideHeads:
    """The plain versions at the head dims and GQA groups the widened
    kernels take (80, 96, 256; 16 query heads per kv head) against the
    JAX XLA reference, fp32 within 1e-5 of the largest output entry and
    the fused step's pages, codes and scales bitwise."""

    @pytest.mark.parametrize("d", [80, 96, 256])
    @pytest.mark.parametrize("s,h,hk", [(1, 4, 2), (4, 4, 4), (20, 8, 2),
                                        (1, 32, 2)])
    def test_attention_matches_jax(self, d, s, h, hk):
        rng = np.random.default_rng(60 + d)
        b, NB, BS, MB = 3, 24, 8, 6
        lengths = [9, 0, 23]
        kp, vp, tables = pool(rng, b=b, hk=hk, d=d, NB=NB, BS=BS, MB=MB,
                              lengths=lengths, s=s, garbage=1e4)
        q = rng.normal(size=(b, s, h, d)).astype(np.float32)
        lens = np.asarray(lengths, np.int32)
        ref = J.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                jnp.asarray(lens), implementation="xla")
        got = P.paged_attention(*(torch.from_numpy(a) for a in (
            q, kp, vp, tables, lens)))
        close(got, ref)

    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("d,h,hk", [(80, 8, 4), (96, 8, 4),
                                        (256, 8, 4), (64, 32, 2),
                                        (128, 24, 2)])
    def test_fused_matches_jax(self, kv_dtype, d, h, hk):
        rng = np.random.default_rng(70 + d + h)
        case = fused_case(rng, h=h, hk=hk, d=d, kv_dtype=kv_dtype,
                          rope=True, pad_rows=(2,) if kv_dtype else ())
        live = case[-1]
        ref = run_fused(case, "xla")
        got = run_fused(case, "torch")
        close(got[0], ref[0])
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(bits(g[:, live]),
                                          bits(np.asarray(r[:, live])))


@pytest.mark.cuda
class TestWideKernels:
    """The widened kernels against their plain versions on the card: head
    dims 72 (int8 rows not of whole 16-byte vectors), 80 (guarded
    channels), 96 and 256 through the split (decode, verify), tile (chunk)
    kernels, and the fused decode step with 12 and 16 query heads per kv
    head (two lane groups; the written page once); fp32 within 1e-5 and
    bf16 within 2^-7 of the largest output entry, reruns bit for bit, the
    fused step's pages, codes and scales bitwise."""

    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [72, 80, 96, 256])
    @pytest.mark.parametrize("s,h,hk", [(1, 8, 4), (4, 4, 4), (20, 8, 2)])
    def test_attention(self, cuda_device, s, h, hk, d, dtype, kv_dtype):
        rng = np.random.default_rng(80)
        q, kp, vp, tables, lens = split_case(
            rng, s, h, hk, BS=16, d=d, lengths=[0, 1, 15, 16, 17, 300])
        dev = cuda_device
        kpt, vpt = (torch.from_numpy(a).to(dev).to(dtype) for a in (kp, vp))
        kw = {}
        if kv_dtype:
            kpt, vpt, ks, vs = P.quantize_kv_pages(kpt, vpt, kv_dtype)
            kw = dict(k_scales=ks, v_scales=vs)
        args = (torch.from_numpy(q).to(dev).to(dtype), kpt, vpt,
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(lens).to(dev))
        got = P.paged_attention(*args, **kw)
        ref = P.paged_attention(*args, implementation="torch", **kw)
        rel = REL if dtype == torch.float32 else 2 ** -7
        close(got.cpu(), ref.cpu().float().numpy(), rel=rel)
        assert torch.equal(got, P.paged_attention(*args, **kw))

    @pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d,h,hk", [(96, 8, 4), (256, 8, 4),
                                        (80, 8, 4), (128, 64, 4),
                                        (64, 24, 2)])
    def test_fused(self, cuda_device, d, h, hk, dtype, kv_dtype):
        rng = np.random.default_rng(81)
        case = fused_case(rng, h=h, hk=hk, kv_dtype=kv_dtype, rope=True,
                          d=d, pad_rows=(3,) if kv_dtype else ())
        q, nk, nv, tables, lengths, jx, S, live = case

        def run(impl):
            kw = {k: to_torch(v).to(cuda_device) for k, v in jx.items()}
            if kv_dtype is None:
                kw["k_pages"] = kw["k_pages"].to(dtype)
                kw["v_pages"] = kw["v_pages"].to(dtype)
            return P.paged_decode_fused(
                *(torch.from_numpy(a).to(cuda_device).to(dtype)
                  for a in (q, nk, nv)),
                kw.pop("k_pages"), kw.pop("v_pages"),
                torch.from_numpy(tables).to(cuda_device),
                torch.from_numpy(lengths).to(cuda_device), max_seq_len=S,
                implementation=impl, **kw)
        got, again, ref = run("kernel"), run("kernel"), run("torch")
        rel = REL if dtype == torch.float32 else 2 ** -7
        close(got[0].cpu(), ref[0].cpu().float().numpy(), rel=rel)
        for a, b in zip(got, again):
            assert torch.equal(bits_t(a.cpu()), bits_t(b.cpu()))
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(bits(g[:, live].cpu()),
                                          bits(r[:, live].cpu()))
