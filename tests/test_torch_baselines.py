"""Port parity of the paper's baselines on the CPU: Quest, StreamingLLM (the
``slm`` policy) and the eviction family, plus the metadata refresh they
share with FIER and the deprecated kernel shims.

Inputs are numpy-seeded and fed to both packages; model weights cross over
with ``params_from_jax``.  Tolerances:

* Quest page metadata equal bit for bit (a bf16 max/min is exact); page
  scores within 1e-6·max|s| (an f32 sum over D in another order); the token
  indices equal when both sides rank the same scores (ties to the lower
  page, as ``lax.top_k`` breaks them); ``quest_attention_decode`` within
  1e-5·max|out|.
* Eviction: alive sets equal; attention outputs and probs within 1e-6
  (f32 einsum order).
* Incremental metadata refresh on a bf16 slab equal to a rebuild bit for
  bit, and to the JAX package's refresh; ``commit_mask`` rows left False
  keep their old block.
* Greedy tokens of quest (page 8) and slm engines on reduced olmo-1b with the
  ``reference`` pipeline identical to the JAX package's, through
  ``generate`` and through the scheduler (chunked = monolithic = JAX).  Prompts from numpy
  seed 0, which has no near-tie: over the 12 greedy steps the smallest
  top-1/top-2 logit gap is 0.39% (quest) and 0.15% (slm) of max|logit|,
  an order above the ~1e-4 relative gap between the two packages' logits
  (``tests/test_torch_model.py``).
* Each deprecated shim equals its ``CacheView`` call bit for bit and warns
  exactly once.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import eviction as jev
from repro.core import policy as jpol
from repro.core import quantize as jqz
from repro.core import quest as jquest
from repro.kvcache import cache as jcache
from repro.models import build_model as j_build_model
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import Request as JRequest
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import eviction as ev
from repro_torch.core import policy as pol
from repro_torch.core import quantize as qz
from repro_torch.core import quest
from repro_torch.kernels import ops
from repro_torch.kvcache import cache as kvcache
from repro_torch.models import build_model
from repro_torch.serving import ContinuousScheduler, Engine, Request


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _pair(x, dtype=np.float32):
    """The same numpy array as a JAX array and a CPU tensor (bf16 values
    pass exactly through f32)."""
    x = np.asarray(x, np.float32)
    if dtype == "bf16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _qk(seed, B=2, S=64, Hkv=2, rep=1, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv * rep, D))
    K = rng.standard_normal((B, S, Hkv, D))
    V = rng.standard_normal((B, S, Hkv, D))
    return _pair(q), _pair(K, "bf16"), _pair(V, "bf16")


# ------------------------------------------------------------------ Quest

@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("rep", [1, 2])
def test_page_scores(reduce, rep):
    (jq, q), (jK, K), _ = _qk(0, rep=rep)
    jm, m = jquest.build_page_meta(jK, 8), quest.build_page_meta(K, 8)
    for f in m.FIELDS:
        np.testing.assert_array_equal(_np(getattr(m, f)), _np(getattr(jm, f)))
    want = _np(jquest.page_scores(jq, jm, reduce=reduce))
    got = _np(quest.page_scores(q, m, reduce=reduce))
    assert got.shape == want.shape == (2, 2 * rep, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_quant_page_scores():
    (jq, q), (jK, K), _ = _qk(1, rep=2)
    want = _np(jquest.quant_page_scores(jq, jqz.quantize(jK, 8), 8))
    got = _np(quest.quant_page_scores(q, qz.quantize(K, 8), 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("budget,page,lengths", [
    (32, 8, [64, 20]),   # length < budget: masked pages tie at NEG_INF
    (24, 8, [64, 1]),    # one valid page
    (4, 8, [64, 30]),    # budget < page: one page, 8 > budget indices
    (16, 16, [40, 64]),
])
def test_quest_token_indices(budget, page, lengths):
    rng = np.random.default_rng(budget + page)
    s = rng.standard_normal((2, 3, 64 // page)).astype(np.float32)
    s[0, 1, :] = 0.5  # an all-tied row
    js, ts = _pair(s)
    jl, tl = jnp.asarray(lengths, jnp.int32), torch.tensor(lengths, dtype=torch.int32)
    want = np.asarray(jquest.quest_token_indices(js, budget, page, jl))
    got = quest.quest_token_indices(ts, budget, page, tl).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        quest.quest_token_indices(ts, budget, page).numpy(),
        np.asarray(jquest.quest_token_indices(js, budget, page)))


@pytest.mark.parametrize("rep", [1, 2])
def test_quest_attention_decode(rep):
    (jq, q), (jK, K), (jV, V) = _qk(2, rep=rep)
    jl, tl = jnp.asarray([64, 37], jnp.int32), torch.tensor([64, 37], dtype=torch.int32)
    want = _np(jquest.quest_attention_decode(
        jq, jK, jV, jquest.build_page_meta(jK, 8), 16, jl))
    got = _np(quest.quest_attention_decode(q, K, V, quest.build_page_meta(K, 8), 16, tl))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------- eviction

def _ev_qkv(seed=0, B=2, S=64, Hkv=2, Hq=4, D=16):
    rng = np.random.default_rng(100 + seed)
    return (_pair(rng.standard_normal((B, Hq, D))), _pair(rng.standard_normal((B, S, Hkv, D))),
            _pair(rng.standard_normal((B, S, Hkv, D))))


def _lens(xs):
    return jnp.asarray(xs, jnp.int32), torch.tensor(xs, dtype=torch.int32)


def test_streaming_llm_mask_and_state():
    jl, tl = _lens([60, 30])
    want = np.asarray(jev.streaming_llm_mask(64, jl, budget=16, sink=4))
    got = ev.streaming_llm_mask(64, tl, budget=16, sink=4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum(-1).tolist() == [16, 16]
    jl, tl = _lens([3, 40])  # a length shorter than the sink
    st, jst = ev.streaming_llm_state(2, 2, 64, tl, 16, 4), jev.streaming_llm_state(
        2, 2, 64, jl, 16, 4)
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))


def test_masked_attention_and_h2o_step():
    (jq, q), (jK, K), (jV, V) = _ev_qkv()
    jl, tl = _lens([64, 64])
    jst, st = jev.init_state(2, 2, 64, jl), ev.init_state(2, 2, 64, tl)
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))
    jout, jprobs = jev.masked_attention_decode(jq, jK, jV, jst.alive)
    out, probs = ev.masked_attention_decode(q, K, V, st.alive)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(probs), _np(jprobs), rtol=0, atol=1e-6)
    jst2 = jev.h2o_step(jst, jprobs, jl, budget=32, recent=8)
    st2 = ev.h2o_step(st, torch.from_numpy(np.array(_np(jprobs))), tl, budget=32, recent=8)
    np.testing.assert_array_equal(st2.alive.numpy(), np.asarray(jst2.alive))
    assert (st2.alive.sum(-1) == 63).all()
    victims = (st.alive & ~st2.alive).nonzero()[:, 2]
    assert (victims < 56).all()  # outside the recent window


def test_tova_steps_match():
    (jq, q), (jK, K), (jV, V) = _ev_qkv(1)
    jl, tl = _lens([64, 64])
    jst, st = jev.init_state(2, 2, 64, jl), ev.init_state(2, 2, 64, tl)
    for _ in range(3):
        _, jprobs = jev.masked_attention_decode(jq, jK, jV, jst.alive)
        _, probs = ev.masked_attention_decode(q, K, V, st.alive)
        jst, st = jev.tova_step(jst, jprobs, jl, budget=60), ev.tova_step(st, probs, tl, 60)
        np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))
    assert (st.alive.sum(-1) >= 60).all()


def test_argmin_ties_pick_the_first_index():
    """``jnp.argmin`` gives a tie to the first index; the port's eviction
    step does too (here on the CPU; ``chip_smoke.py`` phase 7 on the card)."""
    alive = torch.ones((1, 2, 8), dtype=torch.bool)
    probs = torch.tensor([[[3.0, 1.0, 2.0, 1.0, 1.0, 5.0, 6.0, 7.0],
                           [0.0] * 8]])
    length = torch.tensor([8], dtype=torch.int32)
    st = ev.tova_step(ev.EvictionState(alive, torch.zeros_like(probs)), probs, length, 6)
    assert (~st.alive).nonzero().tolist() == [[0, 0, 1], [0, 1, 0]]
    jst = jev.tova_step(jev.EvictionState(jnp.asarray(alive.numpy()), jnp.zeros((1, 2, 8))),
                        jnp.asarray(probs.numpy()), jnp.asarray([8], jnp.int32), 6)
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))


@pytest.mark.parametrize("pool", [7, 4])
def test_snapkv_state(pool):
    """Odd and even pools: reduce_window's SAME padding is (pool-1)//2 on the
    left and pool//2 on the right."""
    rng = np.random.default_rng(2)
    (jqw, qw), (jK, K) = _pair(rng.standard_normal((1, 4, 8, 16))), _pair(
        rng.standard_normal((1, 64, 2, 16)))
    jl, tl = _lens([48])
    jst = jev.snapkv_state(jqw, jK, jl, budget=16, window=8, pool=pool)
    st = ev.snapkv_state(qw, K, tl, budget=16, window=8, pool=pool)
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))
    a = st.alive.numpy()
    assert not a[:, :, 48:].any() and a[:, :, 40:48].all() and (a.sum(-1) <= 17).all()


def test_append_alive():
    jl, tl = _lens([10, 20])
    jst = jev.append_alive(jev.init_state(2, 2, 64, jl), jl)
    st = ev.append_alive(ev.init_state(2, 2, 64, tl), tl)
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))
    assert st.alive[0, :, 10].all() and st.alive[1, :, 20].all()


# ------------------------------------------------------- metadata refresh

@pytest.mark.parametrize("kind,kw", [("fier", {"group": 8}), ("quest", {"page": 8})])
def test_incremental_refresh_matches_rebuild_and_jax(kind, kw):
    """Append tokens one at a time (the cases of tests/test_policies.py) to a
    bf16 slab, the dtype the caches hold: the in-place refresh equals a
    rebuild from the full slab and the JAX package's refresh at every step,
    per row (``append_token_metadata``) and batch-uniform
    (``update_metadata``).  (On an f32 slab both packages' per-row refresh
    tests the sign bit against the unrounded midpoint and may differ from a
    rebuild, which rounds it to bf16 first.)"""
    cfg, jcfg = pol.PolicyConfig(kind=kind, budget=16, **kw), jpol.PolicyConfig(
        kind=kind, budget=16, **kw)
    B, S, H, D = 2, 64, 2, 16
    jK, tK = _pair(np.random.default_rng(3).standard_normal((B, S, H, D)), "bf16")
    prefix = 24
    slab = torch.zeros((B, S, H, D), dtype=torch.bfloat16)
    jslab = jnp.zeros((B, S, H, D), jnp.bfloat16)
    slab[:, :prefix] = tK[:, :prefix]
    jslab = jslab.at[:, :prefix].set(jK[:, :prefix])
    meta, jmeta = pol.build_metadata(slab, cfg), jpol.build_metadata(jslab, jcfg)
    umeta = pol.build_metadata(slab, cfg)
    lengths = torch.tensor([prefix, prefix], dtype=torch.int32)
    for t in range(prefix, 40):
        slab[:, t] = tK[:, t]
        jslab = jslab.at[:, t].set(jK[:, t])
        kvcache.append_token_metadata(meta, slab, lengths, cfg)
        pol.update_metadata(umeta, slab, t, cfg)
        jmeta = jcache.append_token_metadata(jmeta, jslab, jnp.asarray(lengths.numpy()), jcfg)
        lengths = lengths + 1
        rebuilt = pol.build_metadata(slab, cfg)
        for f in meta.FIELDS:
            for m in (meta, umeta):
                assert torch.equal(getattr(m, f), getattr(rebuilt, f)), (t, f)
            np.testing.assert_array_equal(_np(getattr(meta, f)), _np(getattr(jmeta, f)))


@pytest.mark.parametrize("pos_form", ["per_row", "scalar_tensor"])
@pytest.mark.parametrize("kind,kw", [("fier", {"group": 8}), ("quest", {"page": 8})])
def test_update_metadata_takes_scalar_or_per_row_pos(kind, kw, pos_form):
    """``update_metadata`` takes ``pos`` as the reference does, a scalar or
    [B]: rows at their own positions (24 and 37, in different blocks) are
    each refreshed to a rebuild of the bf16 slab, bit for bit."""
    cfg = pol.PolicyConfig(kind=kind, budget=16, **kw)
    B, S, H, D = 2, 64, 2, 16
    K = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, H, D)).astype(
        np.float32)).to(torch.bfloat16)
    pos = [24, 37] if pos_form == "per_row" else [30, 30]
    slab = torch.zeros_like(K)
    for b, p in enumerate(pos):
        slab[b, :p] = K[b, :p]
    meta = pol.build_metadata(slab, cfg)
    for b, p in enumerate(pos):
        slab[b, p] = K[b, p]
    arg = torch.tensor(pos) if pos_form == "per_row" else torch.tensor(pos[0])
    assert pol.update_metadata(meta, slab, arg, cfg) is meta
    rebuilt = pol.build_metadata(slab, cfg)
    for f in meta.FIELDS:
        assert torch.equal(getattr(meta, f), getattr(rebuilt, f)), f


def test_decode_attention_without_side_car_attends_densely_on_cpu():
    """A FIER plan over a CPU view with no side-car attends densely, as the
    reference's ``needs_metadata`` backends do (on the card it raises)."""
    (_, q), (_, K), (_, V) = _qk(8)
    length = torch.tensor([50, 64], dtype=torch.int32)
    view = pol.CacheView.slab(K, V, None, length)
    out = pol.decode_attention(q, view, pol.DecodePlan.build(
        pol.PolicyConfig(kind="fier", budget=16, group=8)))
    dense = pol.decode_attention(q, view, pol.DecodePlan.build(pol.PolicyConfig(kind="full")))
    assert torch.equal(out, dense)


@pytest.mark.parametrize("kind,kw", [("fier", {"group": 8}), ("quest", {"page": 8})])
def test_commit_mask_keeps_old_blocks(kind, kw):
    cfg, jcfg = pol.PolicyConfig(kind=kind, budget=16, **kw), jpol.PolicyConfig(
        kind=kind, budget=16, **kw)
    K = np.random.default_rng(4).standard_normal((2, 64, 2, 16)).astype(np.float32)
    meta = pol.build_metadata(torch.from_numpy(K), cfg)
    old = {f: getattr(meta, f).clone() for f in meta.FIELDS}
    K2 = K.copy()
    K2[:, 10] = 99.0
    jm = jcache.append_token_metadata(
        jpol.build_metadata(jnp.asarray(K), jcfg), jnp.asarray(K2),
        jnp.asarray([10, 10], jnp.int32), jcfg, commit_mask=jnp.asarray([True, False]))
    kvcache.append_token_metadata(meta, torch.from_numpy(K2), torch.tensor([10, 10]), cfg,
                                  commit_mask=torch.tensor([True, False]))
    first = meta.FIELDS[1]  # scale / kmin
    assert not torch.equal(getattr(meta, first)[0], old[first][0])   # row 0 sees the 99
    for f in meta.FIELDS:
        assert torch.equal(getattr(meta, f)[1], old[f][1])           # row 1 untouched
        np.testing.assert_array_equal(_np(getattr(meta, f)), _np(getattr(jm, f)))


# ------------------------------------------------------ engines end to end

CAPACITY, LENGTHS = 128, np.array([80, 57], np.int32)


@pytest.fixture(scope="module")
def reduced_models():
    jc, tc = j_reduced_config("olmo-1b"), reduced_config("olmo-1b")
    jparams = JEngine.build(jc, n_slots=2, capacity=CAPACITY).bundle.init(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tc, device="cpu")
    prompts = np.random.default_rng(0).integers(0, 512, (2, 80)).astype(np.int32)
    return jc, tc, jparams, params, prompts


@pytest.mark.parametrize("kind,kw", [("quest", {"page": 8}), ("slm", {})])
def test_baseline_engine_greedy_tokens_match_jax(reduced_models, kind, kw):
    jc, tc, jparams, params, prompts = reduced_models
    pk = dict(kind=kind, budget=32, skip_layers=1, pipeline="reference", **kw)
    je = JEngine.build(jc, n_slots=2, capacity=CAPACITY, policy=jpol.PolicyConfig(**pk))
    te = Engine.build(tc, n_slots=2, capacity=CAPACITY, policy=pol.PolicyConfig(**pk),
                      device="cpu")
    want = np.asarray(je.generate(jparams, jnp.asarray(prompts), jnp.asarray(LENGTHS), 12))
    got = te.generate(params, torch.from_numpy(prompts).long(), torch.from_numpy(LENGTHS), 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert te.degradable == (kind == "quest")


@pytest.mark.parametrize("kind,kw", [("quest", {"page": 8}), ("slm", {})])
def test_baseline_scheduler_chunked_matches_jax(reduced_models, kind, kw):
    """quest and slm through ``ContinuousScheduler``: chunked prefill (the
    final chunk rebuilds quest's page metadata over the logical row) gives
    monolithic admission's tokens and the JAX scheduler's."""
    jc, tc, jparams, params, _ = reduced_models
    pk = dict(kind=kind, budget=16, skip_layers=1, pipeline="reference", **kw)
    reqs = lambda cls: [cls(rid=i, tokens=list(range(3 + i, 40 + 3 * i)), max_new=6)
                        for i in range(3)]
    jeng = JEngine(j_build_model(jc, jpol.PolicyConfig(**pk)), n_slots=2, capacity=64)
    want = JScheduler(jeng, jparams, chunk_tokens=8).run(reqs(JRequest))
    eng = Engine(build_model(tc, pol.PolicyConfig(**pk), device="cpu"), n_slots=2, capacity=64)
    mono = ContinuousScheduler(eng, params).run(reqs(Request))
    got = ContinuousScheduler(eng, params, chunk_tokens=8).run(reqs(Request))
    assert got == mono == {rid: [int(t) for t in toks] for rid, toks in want.items()}


# ----------------------------------------------------------------- shims

def _shim_inputs():
    (_, q), (_, K), (_, V) = _qk(5, B=2, S=64, Hkv=2, rep=2, D=16)
    qk = qz.quantize(K, 8)
    length = torch.tensor([64, 41], dtype=torch.int32)
    # a paged pool: the slab's blocks (bs 16) scattered into a permuted pool
    perm = torch.randperm(8, generator=torch.Generator().manual_seed(0)) + 1
    table = perm.reshape(2, 4).to(torch.int32)
    def pool(a):
        p = torch.zeros((9, a.shape[1] // 4, *a.shape[2:]), dtype=a.dtype)
        p[perm] = a.reshape(8, a.shape[1] // 4, *a.shape[2:])
        return p
    pmeta = qz.QuantizedKeys(pool(qk.codes), pool(qk.scale), pool(qk.zero), 8)
    return q, K, V, qk, length, table, pool(K), pool(V), pmeta


SHIMS = {
    "fused_retrieve": (
        lambda a: ops.fused_retrieve(a[0], a[3], 16, a[4], sink=2, return_stats=True),
        lambda a: ops.retrieve(a[0], pol.CacheView.slab(None, None, a[3], a[4]), 16, sink=2,
                               return_stats=True)),
    "fused_sparse_attention": (
        lambda a: ops.fused_sparse_attention(a[0], a[1], a[2], a[9], a[4]),
        lambda a: ops.attend_selected(a[0], pol.CacheView.slab(a[1], a[2], length=a[4]), a[9])),
    "fused_fier_attention_decode": (
        lambda a: ops.fused_fier_attention_decode(a[0], a[1], a[2], a[3], 16, a[4], recent=4),
        lambda a: ops.fier_decode_one_pass(a[0], pol.CacheView.slab(a[1], a[2], a[3], a[4]), 16,
                                           recent=4)),
    "paged_fused_retrieve": (
        lambda a: ops.paged_fused_retrieve(a[0], a[8], a[5], 16, a[4], return_stats=True),
        lambda a: ops.retrieve(a[0], pol.CacheView.paged(None, None, a[8], a[5], a[4]), 16,
                               return_stats=True)),
    "paged_fused_sparse_attention": (
        lambda a: ops.paged_fused_sparse_attention(a[0], a[6], a[7], a[5], a[9], a[4]),
        lambda a: ops.attend_selected(a[0], pol.CacheView.paged(a[6], a[7], None, a[5], a[4]),
                                      a[9])),
    "paged_fused_fier_attention_decode": (
        lambda a: ops.paged_fused_fier_attention_decode(a[0], a[6], a[7], a[8], a[5], 16, a[4]),
        lambda a: ops.fier_decode_one_pass(a[0], pol.CacheView.paged(a[6], a[7], a[8], a[5],
                                                                     a[4]), 16)),
}


@pytest.mark.parametrize("name", sorted(SHIMS))
def test_deprecated_shim_equals_cacheview_call_and_warns_once(name):
    a = list(_shim_inputs())
    a.append(ops.retrieve(a[0], pol.CacheView.slab(None, None, a[3], a[4]), 16))  # a[9]: idx
    shim, new = SHIMS[name]
    pol._warned.discard(f"kernels.ops.{name}")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got, got2 = shim(a), shim(a)
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and name in str(dep[0].message)
    want = new(a)
    for g in (got, got2):
        for x, y in zip(g if isinstance(g, tuple) else (g,), want if isinstance(want, tuple)
                        else (want,)):
            assert torch.equal(x, y)


def test_decode_attention_paged_shim_and_skip_layer():
    """The deprecated flat paged entry point: one warning; ``layer`` below
    ``skip_layers`` attends densely, past it through the plan."""
    q, K, V, qk, length, table, kp, vp, pmeta = _shim_inputs()
    cfg = dataclasses.replace(pol.PolicyConfig(kind="fier", budget=16, group=8, skip_layers=2),
                              layout="paged", block_size=16)
    pol._warned.discard(
        "decode_attention_paged(q, k_pool, v_pool, meta, block_table, cfg, length)")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        dense = pol.decode_attention_paged(q, kp, vp, pmeta, table, cfg, length, layer=0)
        sparse = pol.decode_attention_paged(q, kp, vp, pmeta, table, cfg, length, layer=2)
    assert sum(issubclass(w.category, DeprecationWarning) for w in rec) == 1
    view = pol.CacheView.paged(kp, vp, pmeta, table, length)
    full = pol.decode_attention(q, view, pol.DecodePlan.build(pol.PolicyConfig(
        kind="full", layout="paged", block_size=16)))
    assert torch.equal(dense, full)
    assert torch.equal(sparse, pol.decode_attention(q, view, pol.DecodePlan.build(cfg)))
    assert not torch.equal(sparse, dense)
