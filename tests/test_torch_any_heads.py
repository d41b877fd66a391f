"""Port parity at the shapes the generic kernel layout takes: every d_head
that is a multiple of 8 from 8 to 256, at every rep (query heads per kv
head), through the kernels' plain PyTorch versions (what a wrapper runs on
a CPU tensor; the CUDA kernels themselves run only on the card, in
``chip_smoke.py`` phase 2's ``check_any_heads`` and phase 15).

* K1/K3/K6, K2/K4/K8 and K5 against the JAX package's Pallas kernels in
  interpret mode, from numpy-seeded inputs, at (d_head, rep) = (24, 3),
  (80, 5), (96, 7), (256, 8), (64, 32) and (128, 71): K1/K3 the same index
  set except positions whose score lies within ε of τ (ε as in
  ``test_torch_kernels.py``: XLA keeps the dequantized key in f32), K1
  under the group max and the group sum, K3 bitwise K1 under both and held
  to the reference under the max; K6 within (2^-9 + D·2^-23)·rep·Σ|q|·
  max|a| of ``fier_score_hm``; K2/K4/K8 within 1e-5·max|out|; K5 bit for bit.
* The admission rule: every d_head in 8·{1..32} at every rep in {1..128}
  passes the CUDA wrappers' checks, d_head 12, 100 and 264 are refused
  with the reason; the plans (``smem_static`` + ``retrieval_plan``,
  ``attend_plan``) fit sm_90's 232,448 bytes over that grid, and the plans
  of the fixed instantiations are what they were.
* ``Engine.generate`` of reduced olmo-1b at (n_heads 6, n_kv 2, d_head 24)
  and (8, 1, 40), slab and paged, weights through ``params_from_jax``:
  greedy tokens equal to the JAX engine's; the first decode step from the
  reference's prefill cache within 1e-4·max|logit| (``test_torch_model.py``'s
  teacher-forced tolerance).
* ``packed_nbytes``, ``load_ratio``, ``registered_backends`` and
  ``DecodePlan.with_pipeline`` equal to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import policy as jpolicy
from repro.core import quantize as jqz
from repro.core.quantize import quantize as jquantize
from repro.kernels.fier_score import fier_score_hm
from repro.kernels.fused_retrieval import fused_retrieve_hm, paged_fused_retrieve_hm
from repro.kernels.pack_quantize import pack_quantize_hm
from repro.kernels.sparse_attention import (
    fused_sparse_attention_hm, paged_fused_sparse_attention_hm, sparse_attention_hm,
)
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import serving_policy as j_serving_policy
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import policy as tpolicy
from repro_torch.core import quantize as tqz
from repro_torch.core.retrieval import gather_kv
from repro_torch.kernels import fier_score as fs
from repro_torch.kernels import fused_retrieval as fr
from repro_torch.kernels import launch_counts
from repro_torch.kernels import pack_quantize as pq
from repro_torch.kernels import sparse_attention as sa
from repro_torch.kernels.check import selection_agrees
from repro_torch.kvcache.paged import gather_block_rows
from repro_torch.serving import Engine, serving_policy

# (d_head, rep): the generic layout's classes 32, 64, 128 and 256, reps
# that no fixed instantiation takes, and multi-query rep 71
SHAPES = [(24, 3), (80, 5), (96, 7), (256, 8), (64, 32), (128, 71)]


def _t(a):
    """jax/numpy array → torch tensor (bf16 via f32, exact)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _case(B, S, Hkv, rep, D, g, seed):
    rng = np.random.default_rng(seed)
    ch = np.exp(rng.standard_normal(D)).astype(np.float32)
    bf = lambda a: jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16)
    K = bf(rng.standard_normal((B, S, Hkv, D)) * ch)
    V = bf(rng.standard_normal((B, S, Hkv, D)))
    q = bf(rng.standard_normal((B, Hkv, rep, D)))
    return q, K, V, jquantize(K, g), rng


def _hm(a, B, Hkv, D):
    return jnp.moveaxis(a, 2, 1).reshape(B * Hkv, a.shape[1], D)


def _bound(q, qk, rep):
    amax = float(jnp.max(jnp.abs(qk.scale.astype(jnp.float32))
                         + jnp.abs(qk.zero.astype(jnp.float32))))
    return rep * float(jnp.max(jnp.sum(jnp.abs(q.astype(jnp.float32)), -1))) * amax


def _pool(a, table, N):
    """The slab a [B, rows, ...] scattered into an N-block pool through
    table [B, n_btab] (the null block 0 and the spare blocks hold noise)."""
    pb = a.shape[1] // table.shape[1]
    shape = (N, pb, *a.shape[2:])
    pool = (torch.randint(1, 256, shape, dtype=torch.uint8) if a.dtype == torch.uint8
            else torch.randn(shape).to(a.dtype))
    pool[table.reshape(-1).long()] = a.reshape(-1, *shape[1:])
    return pool


@pytest.mark.parametrize("reduce", ["max", "sum"])
@pytest.mark.parametrize("D,rep", SHAPES)
def test_k1_k3_k6_plain_match_reference(D, rep, reduce):
    B, S, g, budget, bs = 2, 128, 16, 32, 32
    Hkv = 1 if rep > 16 else 2
    q, _, _, qk, rng = _case(B, S, Hkv, rep, D, g, seed=D + rep)
    lengths = jnp.asarray([S, 77], jnp.int32)
    sel = dict(group=g, group_reduce=reduce, sink=4, recent=8)
    tq, tl = _t(q), _t(lengths)
    codes, scale, zero = _t(qk.codes), _t(qk.scale), _t(qk.zero)
    fs.check_kernel_shape(D, rep)  # the CUDA kernels take the shape too
    idx, tau, m = fr.fier_retrieve(tq, codes, scale, zero, tl, budget, **sel)
    assert launch_counts()["fier_retrieve"] == 0  # CPU tensors run the plain version
    s = fr.retrieval_scores(tq, codes, scale, zero, group=g)
    kv = fr.masked_kv(s, tl, 4, 8, reduce).reshape(B * Hkv, S)
    bound = _bound(q, qk, rep)
    eps = 2 * (2.0**-9 + D * 2.0**-23) * bound

    r_idx, r_tau, r_m = fused_retrieve_hm(
        q.reshape(B * Hkv, rep, D), _hm(qk.codes, B, Hkv, D), _hm(qk.scale, B, Hkv, D),
        _hm(qk.zero, B, Hkv, D), jnp.repeat(lengths, Hkv), budget, interpret=True, **sel)
    ok, ndiff = selection_agrees(idx.reshape(B * Hkv, budget), _t(r_idx), tau.reshape(-1),
                                 _t(r_tau), m.reshape(-1), _t(r_m), kv, eps)
    assert ok, f"K1: {ndiff} indices differ outside the ε={eps:.3g} band around τ"

    # K3: a permuted pool with spare blocks; its plain version gathers the
    # pool and runs K1's, so it equals K1 bit for bit (held to the reference's
    # paged kernel under the max; K6, which has no reduction, there too)
    N = 1 + B * (S // bs) + 2
    table = torch.from_numpy((1 + rng.permutation(N - 1)[: B * (S // bs)]).reshape(B, S // bs)
                             .astype(np.int32))
    pools = [_pool(a, table, N) for a in (codes, scale, zero)]
    got3 = fr.fier_retrieve(tq, *pools, tl, budget, block_table=table, **sel)
    assert launch_counts()["fier_retrieve_paged"] == 0
    assert all(torch.equal(a, b) for a, b in zip(got3, (idx, tau, m)))
    if reduce == "sum":
        return
    j3 = paged_fused_retrieve_hm(q, *(jnp.asarray(p.float().numpy()).astype(a.dtype)
                                      for p, a in zip(pools, (qk.codes, qk.scale, qk.zero))),
                                 jnp.asarray(table.numpy()), lengths, budget, block_size=bs,
                                 interpret=True, **sel)
    ok, ndiff = selection_agrees(idx.reshape(B * Hkv, budget), _t(j3[0]).reshape(B * Hkv, -1),
                                 tau.reshape(-1), _t(j3[1]).reshape(-1), m.reshape(-1),
                                 _t(j3[2]).reshape(-1), kv, eps)
    assert ok, f"K3: {ndiff} indices differ outside the ε band"

    # K6: per-head scores
    got6 = fs.fier_score_scan(tq, codes, scale, zero, group=g)
    assert launch_counts()["fier_score"] == 0
    want6 = np.asarray(fier_score_hm(q.reshape(B * Hkv, rep, D), _hm(qk.codes, B, Hkv, D),
                                     _hm(qk.scale, B, Hkv, D), _hm(qk.zero, B, Hkv, D),
                                     group=g, interpret=True))
    np.testing.assert_allclose(got6.reshape(B * Hkv, rep, S).numpy(), want6, rtol=0,
                               atol=(2.0**-9 + D * 2.0**-23) * bound)


@pytest.mark.parametrize("D,rep", SHAPES)
def test_k2_k4_k8_plain_match_reference(D, rep):
    B, S, budget, bs = 2, 64, 32, 16
    Hkv = 1 if rep > 16 else 2
    q, K, V, _, rng = _case(B, S, Hkv, rep, D, 8, seed=budget + rep + D)
    idx = np.stack([rng.permutation(S)[:budget] for _ in range(B * Hkv)]).reshape(B, Hkv, budget)
    lengths = np.array([S, S // 2 + 3], np.int32)  # row 1: masked slots
    valid = idx < lengths[:, None, None]
    assert not valid.all()
    ti, tl = torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(lengths)
    sa.check_kernel_shape(D, rep)
    got = sa.fier_attend_selected(_t(q), _t(K), _t(V), ti, tl)
    assert got.dtype == torch.float32 and launch_counts()["fier_attend_selected"] == 0
    want = np.asarray(fused_sparse_attention_hm(
        q, K, V, jnp.asarray(idx, jnp.int32), jnp.asarray(valid[:, :, None, :].astype(np.int8)),
        interpret=True))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)

    N = 1 + B * (S // bs) + 2
    table = torch.from_numpy((1 + rng.permutation(N - 1)[: B * (S // bs)]).reshape(B, S // bs)
                             .astype(np.int32))
    kp, vp = _pool(_t(K), table, N), _pool(_t(V), table, N)
    got4 = sa.fier_attend_selected(_t(q), kp, vp, ti, tl, block_table=table)
    assert torch.equal(got4, sa.fier_attend_selected_plain(
        _t(q), gather_block_rows(kp, table), gather_block_rows(vp, table), ti, tl))
    want4 = np.asarray(paged_fused_sparse_attention_hm(
        q, *(jnp.asarray(p.float().numpy()).astype(jnp.bfloat16) for p in (kp, vp)),
        jnp.asarray(table.numpy()), jnp.asarray(idx, jnp.int32),
        jnp.asarray(valid[:, :, None, :].astype(np.int8)), block_size=bs, interpret=True))
    np.testing.assert_allclose(got4.numpy(), want4, rtol=0, atol=1e-5 * np.abs(want4).max())

    k_sel, v_sel = gather_kv(_t(K), _t(V), ti)
    mask = torch.from_numpy(valid.astype(np.int8))
    got8 = sa.fier_attend_gathered(_t(q), k_sel, v_sel, mask)
    assert torch.equal(got8, got)  # K8 on K2's gathered rows is K2
    jk, jv = (_hm(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16), B, Hkv, D)
              for a in (k_sel, v_sel))
    want8 = np.asarray(sparse_attention_hm(
        q.reshape(B * Hkv, rep, D), jk, jv, jnp.asarray(mask.numpy().reshape(B * Hkv, 1, budget)),
        interpret=True)).reshape(B, Hkv, rep, D)
    np.testing.assert_allclose(got8.numpy(), want8, rtol=0, atol=1e-5 * np.abs(want8).max())


@pytest.mark.parametrize("D", sorted({d for d, _ in SHAPES}))
def test_k5_plain_matches_reference(D):
    B, S, Hkv, g = 2, 64, 2, 16
    rng = np.random.default_rng(D)
    K = jnp.asarray(rng.standard_normal((B, S, Hkv, D)).astype(np.float32)).astype(jnp.bfloat16)
    codes, scale, zero = pack_quantize_hm(_hm(K, B, Hkv, D), group=g, interpret=True)
    back = lambda a: _t(jnp.moveaxis(a.reshape(B, Hkv, a.shape[1], D), 1, 2))
    got = pq.fier_pack_quantize(_t(K), g)
    assert launch_counts()["pack_quantize"] == 0
    for name, x, want in zip(("codes", "scale", "zero"), got, (codes, scale, zero)):
        assert torch.equal(x, back(want)), name


# ------------------------------------------------------- admission and plans

@pytest.mark.parametrize("klass", [32, 64, 128, 256])
def test_every_shape_of_the_rule_is_admitted_and_planned(klass):
    """Each d_head of the layout class (multiples of 8 up to it, above the
    class below) at every rep 1..128: the wrappers' checks admit it, and
    the K1/K3 split (slab and pool, short rows, the serving row and a long
    row) and K2's plan fit sm_90's 232,448 bytes and cover their ranges."""
    for D in range(klass // 2 + 8 if klass > 32 else 8, klass + 1, 8):
        for rep in range(1, 129):
            fs.check_kernel_shape(D, rep)
            sa.check_kernel_shape(D, rep)
            static = fr.smem_static(D, rep)
            for S, bs, rows in ((264, 8, 16), (8192, None, 4 * 16), (8192, 32, 4),
                                (65536, None, 1)):
                plan = fr.retrieval_plan(S, rows, 132, bs, d_head=D, rep=rep)
                assert plan.smem_keys and static + plan.smem_bytes <= fr.SMEM_LIMIT
            for budget, rows in ((32, 4), (1024, 4), (1024, 64), (8192, 1)):
                plan = sa.attend_plan(budget, rows, 132, rep, D)
                assert plan.smem_bytes <= sa.SMEM_LIMIT
                blocks = -(-rep // sa.head_block(D, rep))
                assert plan.cluster == 1 or rows * blocks * plan.cluster <= 132
                covered = np.concatenate([np.arange(a, b) for a, b in plan.ranges(budget)])
                np.testing.assert_array_equal(covered, np.arange(budget))
    pq.check_head_dim(klass)


@pytest.mark.parametrize("D", [12, 100, 264, 0])
def test_other_head_dims_are_refused_with_the_reason(D):
    for check in (lambda: fs.check_kernel_shape(D, 1), lambda: sa.check_kernel_shape(D, 1),
                  lambda: pq.check_head_dim(D)):
        with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
            check()
    with pytest.raises(ValueError, match="at least 1"):
        sa.check_kernel_shape(64, 0)
    if D:  # the plain versions on the CPU take any shape
        q = torch.zeros((1, 1, 2, D), dtype=torch.bfloat16)
        K = torch.zeros((1, 16, 1, D), dtype=torch.bfloat16)
        out = sa.fier_attend_selected(q, K, K, torch.zeros((1, 1, 4), dtype=torch.int32))
        assert tuple(out.shape) == (1, 1, 2, D)


def _old_smem_static(d_head, rep):
    """fused_retrieval.smem_static as it was for the fixed instantiations."""
    rep_slots = 8 if d_head == 128 and rep <= 8 else 16
    lane_channels = 1 if d_head <= 32 else 2 if d_head == 64 else 4
    floats = rep_slots * d_head + 16 * 32 * 2**lane_channels + 4 * 256 + 256 + 16 + 4
    return -(-4 * floats // 1024) * 1024


def _old_attend_plan(budget, rows, n_sm, rep, d_head):
    lanes = 8 if d_head <= 64 else 16
    step = 4 * (256 // lanes) // (2 if rep > 8 else 1)
    c = 1
    while c < sa.MAX_CLUSTER and rows * 2 * c <= n_sm and budget >= 2 * c * step:
        c *= 2
    chunk = min(-(-budget // c), sa.MAX_CHUNK)
    return sa.AttendPlan(c, chunk, sa.RING_BYTES + c * rep * (d_head + 2) * 4 + 4 * chunk)


@pytest.mark.parametrize("D", fs.KERNEL_HEAD_DIMS)
def test_fixed_instantiations_keep_their_plans(D):
    """The shapes that ran before the generic layout keep their fixed
    instantiations and their plans: the same static shared memory, K1/K3
    split, K2 step and K2 plan as before."""
    for rep in range(1, fs.KERNEL_MAX_REP + 1):
        assert fs.fixed_shape(D, rep)
        assert fr.smem_static(D, rep) == _old_smem_static(D, rep)  # so the K1/K3 split too
    for rep in sa.KERNEL_REPS_AT.get(D, sa.KERNEL_REPS):
        assert sa.fixed_shape(D, rep) and sa.head_block(D, rep) == rep
        assert sa.row_stride(D, rep) == D
        for budget, rows in ((512, 64), (1000, 64), (1024, 8), (8192, 16)):
            assert sa.attend_plan(budget, rows, 132, rep, D) == _old_attend_plan(
                budget, rows, 132, rep, D)
    assert not fs.fixed_shape(D, fs.KERNEL_MAX_REP + 1)
    assert not sa.fixed_shape(D, 3)


# ------------------------------------------------------------ the engines

GEOMETRIES = [(6, 2, 24), (8, 1, 40)]
CAPACITY = 128
LENGTHS = np.array([80, 57], np.int32)


def _engines(geometry, layout):
    n_heads, n_kv, d_head = geometry
    geo = dict(n_heads=n_heads, n_kv_heads=n_kv, d_head=d_head)
    jc = dataclasses.replace(j_reduced_config("olmo-1b"), **geo)
    tc = dataclasses.replace(reduced_config("olmo-1b"), **geo)
    pol = dict(budget=32, skip_layers=1, sink=4, recent=8)
    kw = dict(n_slots=2, capacity=CAPACITY, layout=layout)
    je = JEngine.build(jc, policy=j_serving_policy(**pol), **kw)
    te = Engine.build(tc, policy=serving_policy(**pol), device="cpu", **kw)
    jp = je.bundle.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return je, jp, te, tp


def _cache_from_reference(tc, jc):
    """The port's slab cache ``tc`` with the reference cache ``jc``'s
    contents (as ``test_torch_model.py`` copies it)."""
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    like = lambda a, t: torch.from_numpy(f32(a)).to(t.dtype)
    out = {**tc, "front": dict(tc["front"]), "rest": dict(tc["rest"])}
    for part in ("front", "rest"):
        for name in ("k", "v"):
            out[part][name] = like(jc[part][name], tc[part][name])
    jm, tm = jc["rest"]["meta"], tc["rest"]["meta"]
    out["rest"]["meta"] = dataclasses.replace(
        tm, codes=torch.from_numpy(np.asarray(jm.codes)), scale=like(jm.scale, tm.scale),
        zero=like(jm.zero, tm.zero))
    out["length"] = torch.from_numpy(np.asarray(jc["length"])).to(tc["length"].dtype)
    return out


def _paged_run(eng, params, prompts, steps, to_host, to_tok):
    """Insert each prompt into its slot, then ``steps`` greedy decode steps
    (``advance_slot`` for every slot first): the tokens [B, 1 + steps]."""
    cache = eng.new_cache()
    first = []
    for slot, n in enumerate(LENGTHS):
        lg, cache = eng.insert(params, cache, prompts[slot:slot + 1, :n], int(n), slot)
        first.append(int(to_host(lg).argmax(-1)[0]))
    tok, out = np.array(first, np.int32), [np.array(first, np.int32)]
    for _ in range(steps):
        for slot in range(len(LENGTHS)):
            ok, cache = eng.advance_slot(cache, slot)
            assert ok
        nxt, _, cache = eng.decode(params, to_tok(tok), cache)
        tok = to_host(nxt).astype(np.int32)
        out.append(tok)
    return np.stack(out, 1)


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["h6_kv2_d24", "h8_kv1_d40"])
def test_engine_generate_matches_reference(geometry, layout):
    je, jp, te, tp = _engines(geometry, layout)
    rng = np.random.default_rng(sum(geometry))
    P = rng.integers(0, 512, (2, int(LENGTHS.max()))).astype(np.int32)
    if layout == "paged":
        want = _paged_run(je, jp, jnp.asarray(P), 8, np.asarray, jnp.asarray)
        got = _paged_run(te, tp, torch.from_numpy(P), 8, lambda t: t.float().numpy(),
                         torch.from_numpy)
        np.testing.assert_array_equal(got, want)
        te.audit()
        return
    want = je.generate(jp, jnp.asarray(P), jnp.asarray(LENGTHS), 8)
    got = te.generate(tp, torch.from_numpy(P), torch.from_numpy(LENGTHS), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the first decode step from the reference's prefill cache
    batch = {"tokens": P, "lengths": LENGTHS}
    jl, jc = je.prefill_batch(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tc = te.prefill_batch(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    tc = _cache_from_reference(tc, jc)  # before the reference's decode donates jc
    _, jlog, _ = je.decode(jp, jnp.asarray(tok), jc)
    _, tlog, _ = te.decode(tp, torch.from_numpy(tok), tc)
    want = np.asarray(jlog)[:, :512]
    np.testing.assert_allclose(tlog.numpy()[:, :512], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# ------------------------------------------------- the four public functions

@pytest.mark.parametrize("group", [8, 32, 128, 256])
def test_packed_nbytes_and_load_ratio_match_reference(group):
    assert tqz.load_ratio(group) == jqz.load_ratio(group)
    for S, H, D in ((1024, 2, 64), (8192, 16, 128), (4096, 1, 256)):
        assert tqz.packed_nbytes(S, H, D, group) == jqz.packed_nbytes(S, H, D, group)
        assert tqz.packed_nbytes(S, H, D, group) / (S * H * D * 2) == pytest.approx(
            tqz.load_ratio(group), rel=1e-9)


def test_registered_backends_match_reference():
    assert tpolicy.registered_backends() == jpolicy.registered_backends() == (
        "full", "fier", "quest", "slm")


@pytest.mark.parametrize("layout,pipeline", [("slab", "two_pass"), ("slab", "reference"),
                                             ("paged", "one_pass"), ("paged", "two_pass")])
def test_with_pipeline_matches_reference(layout, pipeline):
    """The plan re-resolved with another pipeline: the same fields as the
    reference's, the same refusal where the backend does not support it,
    and a shard's ``plan_rows`` kept."""
    kw = dict(kind="fier", budget=32, group=8, block_size=8, layout=layout,
              pipeline="one_pass")
    jplan = jpolicy.DecodePlan.build(jpolicy.PolicyConfig(**kw))
    tplan = tpolicy.DecodePlan.build(tpolicy.PolicyConfig(**kw))
    try:
        want = jplan.with_pipeline(pipeline)
    except jpolicy.UnsupportedPlanError as e:
        with pytest.raises(tpolicy.UnsupportedPlanError, match="does not support"):
            tplan.with_pipeline(pipeline)
        assert "does not support" in str(e)
        return
    got = dataclasses.replace(tplan, plan_rows=64).with_pipeline(pipeline)
    assert (got.layout, got.pipeline) == (want.layout, want.pipeline) == (layout, pipeline)
    assert got.plan_rows == 64 and got.shard is None
