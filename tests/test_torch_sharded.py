"""Port parity of mesh-sharded serving (``launch/mesh.py``,
``core/distributed.py``, ``kvcache/sharded.py`` and the engine's mesh path),
on the CPU in one process: every shard of a mesh sits on ``cpu``.

* ``ShardSpec``, ``DecodePlan.build(shard=)`` and ``Engine.build(mesh=)``
  refuse what the JAX package refuses, with its messages (the reference
  gets ``jax.make_mesh((1, 1), ...)``, or a stand-in mesh object where it
  needs more devices than this process has: its checks read only
  ``axis_names`` and ``shape``).
* ``ShardedBlockAllocator`` against the JAX package's, driven by one seeded
  op sequence (alloc, free, register, lookup, peek, TTL expiry, fail_next,
  drop_key, audits with and without drift): equal global ids, ``stats()``,
  ``shard_stats()``, evictions and audit outcomes after every op.
* ``fier_decode_sharded`` (``local``, ``exact``) and ``full_decode_sharded``
  against the reference's, whose shard bodies run under
  ``jax.vmap(body, axis_name="model")`` (``lax.pmax``/``psum``/
  ``all_gather`` bind the vmapped axis), at 1, 2 and 4 shards with GQA:
  the attended index sets equal the reference's up to scores within
  ``EPS_TIE`` of the threshold, outputs within ``OUT_TOL``·max|out|.
* exact-mode selection = the single-device top-k (the property of
  ``tests/test_sharded.py``, on the port's ``select_sharded``).
* olmo-1b and granite-moe-1b-a400m (reduced, 4 layers) served by paged
  engines on ``tp2``, ``dp2`` and ``tp2×dp2`` meshes, reference and one_pass
  pipelines, monolithic and chunked prefill: prefill and decode logits bit
  for bit the unsharded port engine's, tokens the JAX package's
  single-device paged engine's.
* a seeded chaos run on a ``dp2`` engine audits clean; the slab model decode
  with ``DistConfig(seq_axes=("model",), mode="exact")`` at a budget covering
  the cache equals dense decode within ``DENSE_TOL``·max|logit|;
  ``serve --paged --model-axis 2`` serves.
"""
import dataclasses
import random
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from repro.configs import reduced_config as j_reduced_config
from repro.core import distributed as jdist
from repro.core import policy as jpolicy
from repro.core import quantize as jqz
from repro.core import retrieval as jrt
from repro.kvcache.paged import AllocatorAuditError as JAuditError
from repro.kvcache.sharded import ShardedBlockAllocator as JShardedAlloc
from repro.kvcache.sharded import ShardSpec as JShardSpec
from repro.serving import Engine as JEngine
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import distributed as dist
from repro_torch.core import policy as tpolicy
from repro_torch.core import retrieval as rt
from repro_torch.core.policy import PolicyConfig, UnsupportedPlanError
from repro_torch.core.quantize import QuantizedKeys
from repro_torch.kvcache.paged import AllocatorAuditError
from repro_torch.kvcache.sharded import ShardedBlockAllocator, ShardSpec
from repro_torch.launch import serve
from repro_torch.core.placement import axis_coords
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_mesh
from repro_torch.models import build_model
from repro_torch.models import attention
from repro_torch.models.attention import DistConfig
from repro_torch.serving import ContinuousScheduler, Engine, Request, ServingFaultInjector

EPS_TIE = 1e-4  # |score − τ| under which two selections may differ (summation order)
OUT_TOL = 1e-2  # attention outputs (bf16) against the reference's, × max|out|
DENSE_TOL = 2e-2  # seq-sharded FIER at a full budget against dense decode, × max|logit|


def _tmesh(shape, axes):
    return make_mesh(shape, axes, device="cpu")


def _jpol(cls, kind="fier", layout="paged", pipeline="reference", block_size=8):
    return cls(kind=kind, budget=16, group=8, skip_layers=1, sink=2, recent=4,
               pipeline=pipeline, layout=layout, block_size=block_size)


def _raises_alike(port_fn, ref_fn, port_exc=ValueError, ref_exc=ValueError):
    with pytest.raises(port_exc) as got:
        port_fn()
    with pytest.raises(ref_exc) as want:
        ref_fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


# ------------------------------------------------------------------ validation

@pytest.mark.parametrize("kwargs", [
    dict(tp_axes=("model",), mode="approx"),
    dict(tp_axes=("expert",)),
    dict(tp_axes=("model",), dp_axes=("model",)),
    dict(),
])
def test_shard_spec_validation_matches_reference(kwargs):
    tmesh, jmesh = _tmesh((1, 1), ("data", "model")), jax.make_mesh((1, 1), ("data", "model"))
    _raises_alike(lambda: ShardSpec(mesh=tmesh, **kwargs),
                  lambda: JShardSpec(mesh=jmesh, **kwargs))
    spec = ShardSpec(mesh=tmesh, tp_axes=("model",), dp_axes=("data",))
    assert (spec.n_tp, spec.n_dp, spec.mode) == (1, 1, "exact")


def test_plan_sharding_validation_matches_reference():
    tspec = ShardSpec(mesh=_tmesh((1, 1), ("data", "model")), tp_axes=("model",),
                      dp_axes=("data",))
    jspec = JShardSpec(mesh=jax.make_mesh((1, 1), ("data", "model")), tp_axes=("model",),
                       dp_axes=("data",))
    for kind in ("fier", "full"):
        plan = tpolicy.DecodePlan.build(_jpol(PolicyConfig, kind=kind), shard=tspec)
        assert plan.shard is tspec
    assert tpolicy.DecodePlan.build(_jpol(PolicyConfig)).shard is None
    msg = _raises_alike(
        lambda: tpolicy.DecodePlan.build(_jpol(PolicyConfig, layout="slab"), shard=tspec),
        lambda: jpolicy.DecodePlan.build(_jpol(jpolicy.PolicyConfig, layout="slab"), shard=jspec),
        UnsupportedPlanError, jpolicy.UnsupportedPlanError)
    assert "requires layout='paged'" in msg
    # a backend without sharding modes: the message names the axes and modes
    name = "_testonly_unsharded"
    common = dict(name=name, supports=frozenset({("paged", "reference")}),
                  build_metadata=lambda K, cfg: None,
                  update_metadata=lambda meta, K, pos, cfg: meta,
                  decode=lambda q, view, plan: q, needs_metadata=False)
    tpolicy.register_backend(tpolicy.AttentionBackend(**common))
    jpolicy.register_backend(jpolicy.AttentionBackend(**common))
    try:
        msg = _raises_alike(
            lambda: tpolicy.DecodePlan.build(_jpol(PolicyConfig, kind=name), shard=tspec),
            lambda: jpolicy.DecodePlan.build(_jpol(jpolicy.PolicyConfig, kind=name),
                                             shard=jspec),
            UnsupportedPlanError, jpolicy.UnsupportedPlanError)
        assert "('model', 'data')" in msg and "sharding modes: -" in msg
    finally:
        del tpolicy._REGISTRY[name], jpolicy._REGISTRY[name]
        jpolicy.POLICIES = tuple(jpolicy._REGISTRY)
    bad = dict(common, name="_testonly_badmode", supports_sharding=frozenset({"approximate"}))
    _raises_alike(lambda: tpolicy.register_backend(tpolicy.AttentionBackend(**bad)),
                  lambda: jpolicy.register_backend(jpolicy.AttentionBackend(**bad)))


def test_engine_build_mesh_validation_matches_reference():
    tcfg, jcfg = reduced_config("olmo-1b"), j_reduced_config("olmo-1b")

    def both(tmesh, jmesh, layout="paged"):
        return _raises_alike(
            lambda: Engine.build(tcfg, n_slots=2, capacity=64,
                                 policy=_jpol(PolicyConfig, layout=layout), mesh=tmesh,
                                 device="cpu"),
            lambda: JEngine.build(jcfg, n_slots=2, capacity=64,
                                  policy=_jpol(jpolicy.PolicyConfig, layout=layout), mesh=jmesh))

    assert "layout='paged'" in both(_tmesh((1, 1), ("data", "model")),
                                    jax.make_mesh((1, 1), ("data", "model")), layout="slab")
    assert "must be named" in both(_tmesh((1,), ("expert",)), jax.make_mesh((1,), ("expert",)))
    # TP 3 over 4 kv heads: the reference's check reads only the mesh's names
    # and shape, so a stand-in mesh object serves it on one device
    stand_in = types.SimpleNamespace(axis_names=("model",), shape={"model": 3})
    msg = both(_tmesh((3,), ("model",)), stand_in)
    assert "divisible" in msg and "model" in msg


def test_mesh_and_collectives():
    m = Mesh((2, 3), ("data", "model"), [f"cpu"] * 6)
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert axis_coords(m, ("data", "model"), 4) == {"data": 1, "model": 1}
    assert axis_coords(m, ("model",), 2) == {"model": 2}
    with pytest.raises(ValueError, match="needs 6 devices"):
        Mesh((2, 3), ("data", "model"), ["cpu"])
    local = make_local_mesh(2, device="cpu")
    assert local.shape == {"data": 1, "model": 2} and local.axis_names == ("data", "model")
    # the reduction order is fixed: shard 0 first
    xs = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]), torch.tensor([-1e8])]
    assert [float(x) for x in dist.psum(xs)] == [float((xs[0] + xs[1]) + xs[2])] * 3
    assert float(dist.pmax(xs)[2]) == 1e8
    cat = dist.all_gather([torch.zeros(2, 1), torch.ones(2, 2)], dim=-1)
    assert cat[0].shape == (2, 3) and torch.equal(cat[0], cat[1])


# ------------------------------------------------------------------ allocator

def _alloc_state(a):
    return a.stats(), a.shard_stats(), sorted(a._free), a.n_free, a.usable, a.n_parked


def test_sharded_allocator_matches_reference():
    rng = random.Random(0)
    t = [0.0]
    A = ShardedBlockAllocator(16, 8, n_shards=2, park_ttl=6.0)
    J = JShardedAlloc(16, 8, n_shards=2, park_ttl=6.0)
    for a in (A, J):
        a.set_clock(lambda: t[0])
        a.record_evictions = True
    owners: dict[int, int] = {}
    kinds = ["alloc"] * 5 + ["free"] * 3 + ["register"] * 3 + ["lookup"] * 2 + [
        "peek", "tick", "fail", "drop", "audit"]
    n_ops = {k: 0 for k in set(kinds)}
    for step in range(400):
        op = rng.choice(kinds)
        n_ops[op] += 1
        shard = rng.randrange(2)
        key = rng.randrange(24)
        if op == "alloc":
            got, want = A.alloc(shard), J.alloc(shard)
            assert got == want, step
            if got is not None:
                owners[got] = owners.get(got, 0) + 1
        elif op == "free" and owners:
            gid = rng.choice(sorted(owners))
            A.free(gid), J.free(gid)
            owners[gid] -= 1
            if not owners[gid]:
                del owners[gid]
        elif op == "register" and owners:
            gid = rng.choice(sorted(owners))
            parent = rng.choice([None, rng.randrange(24)])
            A.register(gid, key, parent), J.register(gid, key, parent)
        elif op == "lookup":
            got, want = A.lookup(key, shard), J.lookup(key, shard)
            assert got == want, step
            if got is not None:
                owners[got] = owners.get(got, 0) + 1
        elif op == "peek":
            keys = [rng.randrange(24) for _ in range(3)]
            for sh in (None, shard):
                assert A.peek(keys, sh) == J.peek(keys, sh)
                assert A.peek_prefix(keys, sh) == J.peek_prefix(keys, sh)
                assert A.blocks_needed(20, keys, sh) == J.blocks_needed(20, keys, sh)
            assert A.key_resident(key) == J.key_resident(key)
        elif op == "tick":
            t[0] += rng.choice([1.0, 4.0, 7.0])
            assert A.expire_parked() == J.expire_parked()
        elif op == "fail":
            A.fail_next(1), J.fail_next(1)
        elif op == "drop":
            assert A.drop_key(key) == J.drop_key(key)
        elif op == "audit":
            A.audit(dict(owners)), J.audit(dict(owners))
            if owners:
                drift = dict(owners)
                drift[rng.choice(sorted(owners))] += 1
                with pytest.raises(AllocatorAuditError) as got:
                    A.audit(drift)
                with pytest.raises(JAuditError) as want:
                    J.audit(drift)
                assert str(got.value) == str(want.value) and "drift" in str(got.value)
        assert [(e.bid, e.key, e.parent_key, e.reason) for e in A.take_evicted()] == [
            (e.bid, e.key, e.parent_key, e.reason) for e in J.take_evicted()], step
        assert _alloc_state(A) == _alloc_state(J), (step, op)
        assert all(A.ref[g] == J.ref[g] for g in owners)
    assert all(n_ops[k] > 5 for k in n_ops), n_ops
    assert A.stats()["pool_injected_alloc_failures"] > 0 and A.ttl_evictions > 0


# ---------------------------------------------------- sequence-sharded decode

B_D, S_D, HKV_D, HQ_D, D_D, G_D = 2, 256, 2, 4, 32, 8


def _decode_case(seed=0):
    rng = np.random.default_rng(seed)
    ch = np.exp(rng.standard_normal(D_D)).astype(np.float32)
    K = (rng.standard_normal((B_D, S_D, HKV_D, D_D)) * ch).astype(np.float32)
    V = rng.standard_normal((B_D, S_D, HKV_D, D_D)).astype(np.float32)
    q = rng.standard_normal((B_D, HQ_D, D_D)).astype(np.float32)
    Kj = jnp.asarray(K).astype(jnp.bfloat16)
    Vj = jnp.asarray(V).astype(jnp.bfloat16)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    qk = jqz.quantize(Kj, G_D)
    length = np.array([256, 200], np.int32)
    return qj, Kj, Vj, qk, length


def _t(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _split(a, n, axis=1):
    return [_t(x) for x in jnp.split(jnp.asarray(a), n, axis=axis)]


def _ref_sharded(kind, n, budget, qj, Kj, Vj, qk, length):
    """The reference's shard bodies under vmap over a stacked shard axis."""
    S_loc = S_D // n
    args = [jnp.stack(jnp.split(x, n, axis=1)) for x in (Kj, Vj, qk.codes, qk.scale, qk.zero)]
    length = jnp.asarray(length)

    def body(i, K_l, V_l, c_l, s_l, z_l):
        start = i * S_loc
        if kind == "full":
            return jdist.full_decode_sharded(qj, K_l, V_l, length, axis="model",
                                             shard_start=start)
        return jdist.fier_decode_sharded(
            qj, K_l, V_l, jqz.QuantizedKeys(c_l, s_l, z_l, G_D), budget, length,
            axis="model", shard_start=start, n_shards=n, mode=kind)

    out = jax.jit(jax.vmap(body, axis_name="model"))(jnp.arange(n, dtype=jnp.int32), *args)
    return np.asarray(out.astype(jnp.float32))


def _ref_mask(kind, n, budget, kv, length):
    """The attended global positions of the reference's selection, mirrored
    in numpy from ``repro/core/distributed.py`` on the reference's scores."""
    S_loc = S_D // n
    local_budget = max(budget // n, 1)
    mask = np.zeros(kv.shape, bool)
    cands = []
    for j in range(n):
        s = kv[:, :, j * S_loc:(j + 1) * S_loc].copy()
        loc = np.clip(length - j * S_loc, 0, S_loc)
        s = np.where(np.arange(S_loc)[None, None, :] >= loc[:, None, None], rt.NEG_INF, s)
        order = np.argsort(-s, axis=-1, kind="stable")
        k = min(local_budget, S_loc) if kind == "local" else min(
            max(local_budget * 2, 1) if n > 1 else budget, S_loc)
        cands.append((order[..., :k], np.take_along_axis(s, order[..., :k], -1)))
    kth = None
    if kind == "exact":
        all_s = np.concatenate([c for _, c in cands], axis=-1)
        kth = -np.sort(-all_s, axis=-1)[..., min(budget, all_s.shape[-1]) - 1]
    for j, (idx, cs) in enumerate(cands):
        g = idx + j * S_loc
        keep = g < length[:, None, None]
        if kth is not None:
            keep &= (cs >= kth[..., None]) & (cs > rt.NEG_INF)
        for b, h, i in zip(*np.nonzero(keep)):
            mask[b, h, g[b, h, i]] = True
    return mask, kth


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["local", "exact", "full"])
def test_sharded_decode_matches_reference(kind, n):
    budget = 64
    qj, Kj, Vj, qk, length = _decode_case()
    want = _ref_sharded(kind, n, budget, qj, Kj, Vj, qk, length)
    q, lens = _t(qj), torch.from_numpy(length)
    K_l, V_l = _split(Kj, n), _split(Vj, n)
    starts = [i * (S_D // n) for i in range(n)]
    if kind == "full":
        got = dist.full_decode_sharded([q] * n, K_l, V_l, [lens] * n, shard_start=starts)
    else:
        qk_l = [QuantizedKeys(c, s, z, G_D) for c, s, z in zip(
            _split(qk.codes, n), _split(qk.scale, n), _split(qk.zero, n))]
        got = dist.fier_decode_sharded([q] * n, K_l, V_l, qk_l, budget, [lens] * n,
                                       shard_start=starts, n_shards=n, mode=kind)
        # the attended index set, against the reference's up to near-τ ties
        kv_j = np.asarray(jrt.reduce_over_query_group(jrt.approx_scores(qj, qk), HKV_D))
        want_mask, kth = _ref_mask(kind, n, budget, kv_j, length)
        kv_t = [rt.reduce_over_query_group(rt.approx_scores(q, c), HKV_D) for c in qk_l]
        sel = dist.select_sharded(kv_t, budget, [lens] * n, shard_start=starts,
                                  n_shards=n, mode=kind)
        diff = dist.selected_mask(sel, starts, lens, S_D).numpy() ^ want_mask
        if kth is None:  # local: each shard's own k-th score is its threshold
            assert not diff.any()
        else:
            assert np.all(np.abs(kv_j - kth[..., None])[diff] <= EPS_TIE), int(diff.sum())
    for o in got:
        assert torch.equal(o, got[0])
    out = got[0].to(torch.float32).numpy()
    for w in want:
        np.testing.assert_allclose(out, w, atol=OUT_TOL * np.abs(w).max(), rtol=0)


def _selection_cases():
    @st.composite
    def cases(draw):
        n_shards = draw(st.sampled_from([1, 2, 4]))
        hq, hkv = draw(st.sampled_from([(4, 4), (4, 2), (8, 2)]))
        s_loc = draw(st.integers(2, 10))
        S = n_shards * s_loc
        budget = draw(st.integers(1, S))
        length = draw(st.integers(1, S))
        ties = draw(st.booleans())
        if ties:
            flat = draw(st.lists(st.integers(0, 4), min_size=hq * S, max_size=hq * S))
        else:
            flat = draw(st.permutations(list(range(hq * S))))
        scores = np.asarray(flat, np.float32).reshape(1, hq, S)
        return n_shards, hkv, s_loc, budget, length, scores, ties

    return cases()


@settings(max_examples=40, deadline=None)
@given(_selection_cases())
def test_exact_mode_selection_matches_single_device_topk(case):
    """``tests/test_sharded.py``'s property on the port: exact-mode sharded
    selection attends the single-device ``select_topk`` index set — exactly
    under distinct scores (given the nomination condition), up to ties at τ
    otherwise."""
    n_shards, hkv, s_loc, budget, length, scores, ties = case
    S = n_shards * s_loc
    kv = rt.reduce_over_query_group(torch.from_numpy(scores), hkv)
    lens = torch.tensor([length], dtype=torch.int32)
    idx = rt.select_topk(kv, min(budget, S), lens)
    oracle = np.zeros((1, hkv, S), bool)
    for h in range(hkv):
        for i in idx[0, h].tolist():
            oracle[0, h, i] = i < length
    local_budget = max(budget // n_shards, 1)
    k_cand = min(max(local_budget * 2, 1) if n_shards > 1 else budget, s_loc)
    kvn = kv.numpy()
    for h in range(hkv):
        tau = -np.sort(-kvn[0, h, :length])[min(budget, length) - 1]
        for j in range(n_shards):
            lo, hi = j * s_loc, min((j + 1) * s_loc, length)
            assume(int((kvn[0, h, lo:hi] >= tau).sum()) <= k_cand)
    starts = [j * s_loc for j in range(n_shards)]
    sel = dist.select_sharded(list(torch.split(kv, s_loc, dim=-1)), budget,
                              [lens] * n_shards, shard_start=starts, n_shards=n_shards,
                              mode="exact")
    got = dist.selected_mask(sel, starts, lens, S).numpy()
    # the global threshold: the budget-th of every shard's top k_cand valid scores
    cand = []
    for j in range(n_shards):
        s = kvn[0, :, j * s_loc:(j + 1) * s_loc].copy()
        s[:, max(min(length - j * s_loc, s_loc), 0):] = rt.NEG_INF
        cand.append(-np.sort(-s, axis=1)[:, :k_cand])
    all_s = np.concatenate(cand, axis=1)
    kth = -np.sort(-all_s, axis=1)[:, min(budget, all_s.shape[1]) - 1][None]
    diff = got ^ oracle
    if not ties:
        assert not diff.any()
    else:
        for h in range(hkv):
            assert np.all(kvn[0, h][diff[0, h]] == kth[0, h]), (h, np.nonzero(diff[0, h]))


# -------------------------------------------------------------- the engines

MESHES = {"tp2": ((2,), ("model",)), "dp2": ((2,), ("data",)),
          "tp2xdp2": ((2, 2), ("data", "model"))}
ARCHS = ("olmo-1b", "granite-moe-1b-a400m")
N_PROMPT, N_STEPS = 50, 6
# the prompt: with this one the JAX package's top two logits lie ≥ 0.0686 of
# max|logit| apart at every decode step of granite-moe (0.0068 with ·7 % 97,
# where the packages part on the first token), so equal tokens do not rest
# on a near-tie
PROMPT = [int(t) for t in np.arange(N_PROMPT) * 5 % 97]


def _engine_pol(cls, pipeline):
    return dataclasses.replace(
        cls(kind="fier", budget=64, group=8, skip_layers=1, sink=4, recent=32,
            pipeline=pipeline, layout="paged"), block_size=32, pool_blocks=40)


@pytest.fixture(scope="module")
def engines():
    """Per config: the JAX package's single-device paged tokens, and the
    port's params and unsharded runs (reference and one_pass, monolithic
    and chunked)."""
    out = {}
    toks = np.asarray(PROMPT, np.int32)
    for arch in ARCHS:
        jcfg = dataclasses.replace(j_reduced_config(arch), n_layers=4)
        cfg = dataclasses.replace(reduced_config(arch), n_layers=4)
        jeng = JEngine.build(jcfg, n_slots=4, capacity=256,
                             policy=_engine_pol(jpolicy.PolicyConfig, "reference"))
        jparams = jeng.bundle.init(jax.random.PRNGKey(0))
        cache = jeng.new_cache()
        pre, cache = jeng.insert(jparams, cache, jnp.asarray(toks[None]), N_PROMPT, 0)
        tok = int(jnp.argmax(pre[0]))
        ref = [tok]
        active = jnp.zeros((4,), bool).at[0].set(True)
        for _ in range(N_STEPS):
            ok, cache = jeng.advance_slot(cache, 0)
            assert ok
            nxt, _, cache = jeng.decode(jparams, jnp.zeros((4,), jnp.int32).at[0].set(tok),
                                        cache, active=active)
            tok = int(nxt[0])
            ref.append(tok)
        cache = jeng.release_slot(cache, 0)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        base = {(p, c): _serve(cfg, params, None, p, 0, c)
                for p in ("reference", "one_pass") for c in (False, True)}
        out[arch] = (cfg, params, ref, base)
    return out


def _serve(cfg, params, mesh, pipeline, slot, chunked):
    eng = Engine.build(cfg, n_slots=4, capacity=256, policy=_engine_pol(PolicyConfig, pipeline),
                       mesh=mesh, device="cpu")
    cparams = eng.compute_params(params)
    cache = eng.new_cache()
    toks = PROMPT
    if chunked:
        pos, cache = eng.begin_chunked(cache, slot, toks)
        while pos < N_PROMPT:
            n = min(24, N_PROMPT - pos)
            ok, pre, cache = eng.prefill_chunk(cparams, cache, slot, toks, pos, n)
            assert ok
            pos += n
    else:
        pre, cache = eng.insert(cparams, cache, torch.tensor([toks]), N_PROMPT, slot)
    tok = int(pre[0].argmax())
    outs, logits = [tok], [pre[0]]
    active = torch.zeros(4, dtype=torch.bool)
    active[slot] = True
    for _ in range(N_STEPS):
        ok, cache = eng.advance_slot(cache, slot)
        assert ok
        t = torch.zeros(4, dtype=torch.int32)
        t[slot] = tok
        nxt, lg, cache = eng.decode(cparams, t, cache, active=active)
        tok = int(nxt[slot])
        outs.append(tok)
        logits.append(lg[slot].clone())
    cache = eng.release_slot(cache, slot)
    eng.audit()
    assert eng.allocator.n_in_use == 0
    return outs, torch.stack(logits)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engine_bitwise_unsharded(engines, arch, mesh_name):
    """A slot homed on the last DP shard: prefill and decode logits bit for
    bit the unsharded engine's (slot 0), tokens the JAX package's."""
    cfg, params, ref, base = engines[arch]
    mesh = _tmesh(*MESHES[mesh_name])
    for (pipeline, chunked), (b_toks, b_logits) in base.items():
        assert b_toks == ref, (pipeline, chunked)
        toks, logits = _serve(cfg, params, mesh, pipeline, 3, chunked)
        assert toks == b_toks, (pipeline, chunked)
        assert torch.equal(logits, b_logits), (pipeline, chunked)


def test_sharded_chaos_audits_clean():
    """Seeded fault schedules against a dp2 engine: the scheduler drains,
    every request retires with a structured outcome, and the per-shard
    allocators audit clean with no block leaked."""
    cfg = reduced_config("olmo-1b")
    pol = PolicyConfig(kind="fier", budget=16, group=8, skip_layers=1, sink=2, recent=4,
                       pipeline="reference", layout="paged", block_size=8, pool_blocks=40)
    eng = Engine.build(cfg, n_slots=4, capacity=64, policy=pol,
                       mesh=_tmesh((2,), ("data",)), device="cpu")
    params = eng.bundle.init(0)
    reqs = [Request(rid=i, tokens=list(range(2 + i, 12 + i)), max_new=12) for i in range(4)]
    for seed in (0, 1):
        inj = ServingFaultInjector.random(seed, rids=[0, 1, 2, 3], n_faults=3, step_lo=1,
                                          step_hi=8)
        sched = ContinuousScheduler(eng, params, injector=inj, audit_every=3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = sched.run(reqs)
        assert sorted(res.outcomes) == [0, 1, 2, 3]
        assert all(o.status in ("finished", "cancelled", "quarantined", "rejected")
                   for o in res.outcomes.values())
        eng.audit()
        assert eng.allocator.n_in_use == 0, seed
    # a downshifted budget keeps the sharding (the rebuilt bundle's step meets
    # the sharded pool): a slot on DP shard 1 decodes and audits clean
    cache = eng.new_cache()
    eng.degrade_floor = 8
    assert eng.downshift_budget() and eng.current_budget == 8
    lg, cache = eng.insert(params, cache, torch.arange(3, 20)[None], 17, 3)
    ok, cache = eng.advance_slot(cache, 3)
    tok = torch.zeros(4, dtype=torch.int32)
    tok[3] = int(lg[0].argmax())
    _, lg, cache = eng.decode(params, tok, cache, active=torch.tensor([0, 0, 0, 1]).bool())
    assert ok and torch.isfinite(lg[3, :cfg.vocab]).all()
    cache = eng.release_slot(cache, 3)
    eng.audit()


@pytest.mark.parametrize("mode", ["exact", "local"])
def test_seq_sharded_slab_decode_equals_dense(mode):
    """The slab model decode with the cache sequence-sharded over 'model'
    (and the batch over 'data'): at a budget covering the cache every token
    is attended, so the logits equal dense decode's within DENSE_TOL, and
    the first sharded layer writes the unsharded decode's cache rows bit for
    bit."""
    cfg = dataclasses.replace(reduced_config("olmo-1b"), n_layers=4)
    pol = PolicyConfig(kind="fier", budget=64, group=8, skip_layers=1)
    mesh = _tmesh((2, 2), ("data", "model"))
    plain = build_model(cfg, pol, device="cpu")
    sharded = build_model(cfg, pol, DistConfig(mesh=mesh, seq_axes=("model",),
                                               batch_axes=("data",), mode=mode), device="cpu")
    dense = build_model(cfg, PolicyConfig(kind="full"), device="cpu")
    params = plain.compute_params(plain.init(0))
    toks = torch.from_numpy((np.arange(64).reshape(2, 32) * 5 % 89).astype(np.int64))
    batch = {"tokens": toks, "lengths": torch.full((2,), 32, dtype=torch.int32)}
    logits, cache = plain.prefill(params, batch, capacity=64)
    tok = logits.argmax(-1).to(torch.int32)
    clone = lambda c: {k: ({n: (dataclasses.replace(v, **{f: getattr(v, f).clone()
                                                          for f in v.FIELDS})
                                if hasattr(v, "FIELDS") else v.clone())
                            for n, v in c[k].items()} if isinstance(c[k], dict)
                           else c[k].clone()) for k in c}
    c_plain, c_sh = clone(cache), clone(cache)
    l_plain, c_plain = plain.decode_step(params, tok, c_plain)
    l_sh, c_sh = sharded.decode_step(params, tok, c_sh)
    l_dense, _ = dense.decode_step(params, tok, dense.prefill(params, batch, capacity=64)[1])
    scale = l_dense[:, :cfg.vocab].abs().max()
    assert (l_sh - l_dense)[:, :cfg.vocab].abs().max() <= DENSE_TOL * scale
    assert (l_sh - l_plain)[:, :cfg.vocab].abs().max() <= DENSE_TOL * scale
    # the first sharded layer appends from the same input as the unsharded
    # one: its K/V and side-car are equal bit for bit; later layers read
    # hidden states within DENSE_TOL, so their appended rows agree closely
    for part, n in (("front", 1), ("rest", 1)):
        for name in ("k", "v"):
            assert torch.equal(c_sh[part][name][:n], c_plain[part][name][:n])
            torch.testing.assert_close(c_sh[part][name].float(), c_plain[part][name].float(),
                                       atol=1e-2 * c_plain[part][name].abs().max(), rtol=0)
    for f in QuantizedKeys.FIELDS:
        assert torch.equal(getattr(c_sh["rest"]["meta"], f)[0],
                           getattr(c_plain["rest"]["meta"], f)[0])
    # a paged cache refuses the sequence sharding, as in the reference
    lp = {k: v[1] for k, v in params["layers"]["attn"].items()}
    with pytest.raises(ValueError, match="sequence-sharded"):
        attention.decode_self_attention(
            lp, torch.zeros((2, 1, cfg.d_model), dtype=torch.bfloat16), {},
            torch.zeros(2, dtype=torch.int32), cfg, plain.plan,
            DistConfig(mesh=mesh, seq_axes=("model",)),
            block_table=torch.zeros((2, 2), dtype=torch.int32))


def test_serve_cli_model_axis_paged(capsys):
    report = serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--paged",
                         "--model-axis", "2", "--n-requests", "3", "--max-new", "4"])
    assert report["mesh"] == {"data": 1, "model": 2}
    assert report["tokens"] == 12 and report["pool_blocks_in_use"] == 0
    plain = serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--paged",
                        "--n-requests", "3", "--max-new", "4"])
    assert plain["tokens"] == report["tokens"]
    with pytest.raises(ValueError, match="--model-axis 2 shards the paged pool only"):
        serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--model-axis", "2"])
