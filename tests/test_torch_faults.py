"""Port parity of the serving robustness layer on the CPU: the fault
injector, the host offload tier with TTL, and the retrieval introspector,
each run through the port's ``ContinuousScheduler`` and the JAX package's on
the same trace, with weights carried across by ``params_from_jax``.

* The chaos matrix of ``tests/test_fault.py`` (layouts slab, paged and
  offload × the five fault kinds) and its seeded runs (seeds 0–2): the same
  structured outcomes, the same ``fired_log`` and the same tokens for every
  request, the victim included — every fault is deterministic, the
  metadata corruption too (bit for bit: codes ^ 0xA5, -scale - 1,
  -zero + 1 in bf16).  Paged runs audit clean across the device pool and
  the host tier, with no block in use at the end.
* The offload round trip: blocks saved by a TTL sweep and recalled through
  ``begin_chunked`` read back bit-identical in every pool leaf.
* The offload engine gives the plain paged engine's tokens (and the JAX
  offload engine's) while recomputing fewer prefill tokens
  (``tests/test_prefix_tree.py:257-330``); the TTL sweep demotes exactly the
  blocks the JAX engine's does.
* ``ProbeRecord``s of ``Observability(introspect=True)``: step, slot, length
  and budget equal; τ within 1e-5 relative; oracle overlap equal; the
  recaptured mass within 1e-5.

Every JAX reference run happens once, in a module-scoped fixture.
"""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core.policy import PolicyConfig as JPolicy
from repro.models import build_model as j_build_model
from repro.obs import Observability as JObservability
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import Engine as JEngine
from repro.serving import FaultSpec as JFaultSpec
from repro.serving import Request as JRequest
from repro.serving import ServingFaultInjector as JInjector
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import PolicyConfig
from repro_torch.kvcache.paged import block_hash_chain
from repro_torch.models import build_model
from repro_torch.obs import Observability
from repro_torch.serving import (
    FAULT_KINDS,
    ContinuousScheduler,
    Engine,
    FaultSpec,
    Request,
    ServingFaultInjector,
)

LAYOUTS = ("slab", "paged", "offload")


def _policy(cls, layout, pool_blocks=0):
    return cls(kind="fier", budget=16, group=8, skip_layers=1, sink=2, recent=4,
               pipeline="reference", layout=layout, block_size=8, pool_blocks=pool_blocks)


def _engine_kwargs(layout):
    # the offload engine: a host tier and an aggressive TTL so the chaos trace
    # really demotes blocks (offload_drop has something to lose)
    return dict(offload_blocks=16, prefix_ttl=25.0) if layout == "offload" else {}


def _sched_kwargs(layout):
    # host-tier recall happens on the chunked resume path only
    return {"chunk_tokens": 4} if layout == "offload" else {}


def _chaos_reqs(cls):
    return [cls(rid=i, tokens=list(range(2 + i, 12 + i)), max_new=12) for i in range(3)]


def _ints(res):
    return {rid: [int(t) for t in toks] for rid, toks in res.items()}


def _outcomes(res):
    return {rid: oc.status for rid, oc in res.outcomes.items()}


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = j_reduced_config("olmo-1b"), reduced_config("olmo-1b")
    jbundles = {
        "slab": j_build_model(jcfg, _policy(JPolicy, "slab")),
        "paged": j_build_model(jcfg, _policy(JPolicy, "paged", pool_blocks=40)),
    }
    jparams = jbundles["slab"].init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    bundles = {
        "slab": build_model(cfg, _policy(PolicyConfig, "slab"), device="cpu"),
        "paged": build_model(cfg, _policy(PolicyConfig, "paged", pool_blocks=40), device="cpu"),
    }
    jengines, engines = {}, {}
    for layout in LAYOUTS:
        key = "slab" if layout == "slab" else "paged"
        jengines[layout] = JEngine(jbundles[key], n_slots=3, capacity=64,
                                   **_engine_kwargs(layout))
        engines[layout] = Engine(bundles[key], n_slots=3, capacity=64, **_engine_kwargs(layout))
    return jcfg, cfg, jparams, params, jengines, engines


def _chaos_run(sched_cls, req_cls, eng, params, injector, layout, audit_every):
    sched = sched_cls(eng, params, injector=injector, audit_every=audit_every,
                      **_sched_kwargs(layout))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return sched.run(_chaos_reqs(req_cls))


@pytest.fixture(scope="module")
def jax_chaos(setup):
    """The JAX scheduler's runs: fault-free, every (layout, kind) cell of the
    matrix, and the seeded schedules."""
    _, _, jparams, _, jengines, _ = setup
    out = {}
    for layout in LAYOUTS:
        eng = jengines[layout]
        out[layout, None] = (_chaos_run(JScheduler, JRequest, eng, jparams, None, layout, 4), [])
        for kind in FAULT_KINDS:
            inj = JInjector([JFaultSpec(kind, step=3, rid=1, count=2)])
            res = _chaos_run(JScheduler, JRequest, eng, jparams, inj, layout, 4)
            out[layout, kind] = (res, list(inj.fired_log))
        for seed in (0, 1, 2):
            inj = JInjector.random(seed, rids=[0, 1, 2], n_faults=3, step_lo=1, step_hi=8)
            res = _chaos_run(JScheduler, JRequest, eng, jparams, inj, layout, 3)
            out[layout, seed] = (res, list(inj.fired_log))
    return out


def _check_drained(eng):
    if eng.paged:
        eng.audit()  # device pool and host tier: no leaked or double-owned block
        assert eng.allocator.n_in_use == 0


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_chaos_matrix_matches_jax(setup, jax_chaos, layout, kind):
    _, _, _, params, _, engines = setup
    eng = engines[layout]
    want, want_log = jax_chaos[layout, kind]
    inj = ServingFaultInjector([FaultSpec(kind, step=3, rid=1, count=2)])
    res = _chaos_run(ContinuousScheduler, Request, eng, params, inj, layout, 4)
    assert inj.all_fired, f"{kind} never fired: {inj.fired_log}"
    assert inj.fired_log == want_log
    assert _outcomes(res) == _outcomes(want)
    assert _ints(res) == _ints(want)  # every request, the victim included
    ref, _ = jax_chaos[layout, None]
    for rid in (0, 2):  # requests no fault targeted: the fault-free tokens
        assert _ints(res)[rid] == _ints(ref)[rid]
    _check_drained(eng)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_chaos_matches_jax(setup, jax_chaos, seed):
    _, _, _, params, _, engines = setup
    for layout in LAYOUTS:
        eng = engines[layout]
        inj = ServingFaultInjector.random(seed, rids=[0, 1, 2], n_faults=3, step_lo=1,
                                          step_hi=8)
        want, want_log = jax_chaos[layout, seed]
        res = _chaos_run(ContinuousScheduler, Request, eng, params, inj, layout, 3)
        assert inj.fired_log == want_log, layout
        assert _outcomes(res) == _outcomes(want), layout
        assert _ints(res) == _ints(want), layout
        _check_drained(eng)


def test_seeded_schedule_equals_jax():
    for seed in range(4):
        a = ServingFaultInjector.random(seed, rids=[1, 2, 3])
        b = JInjector.random(seed, rids=[1, 2, 3])
        assert [(s.kind, s.step, s.rid, s.count) for s in a.specs] == [
            (s.kind, s.step, s.rid, s.count) for s in b.specs]


def test_corrupt_metadata_bit_for_bit(setup):
    """The scrambled side-car row equals the JAX engine's on the same
    contents: codes ^ 0xA5, -scale - 1, -zero + 1, all in bf16."""
    _, _, _, params, jengines, engines = setup
    eng, jeng = engines["slab"], jengines["slab"]
    cache = eng.new_cache()
    toks = torch.arange(3, 30, dtype=torch.int64)[None]
    _, cache = eng.insert(params, cache, toks, 27, slot=1)
    meta = cache["rest"]["meta"]
    jc = jeng.new_cache()
    from repro.core.quantize import QuantizedKeys as JQ

    jm = JQ(*(jnp.asarray(getattr(meta, f).to(torch.float32).numpy()).astype(
        jnp.uint8 if f == "codes" else jnp.bfloat16) for f in meta.FIELDS), meta.group)
    jc = dict(jc, rest=dict(jc["rest"], meta=jm))
    ok, jc = jeng.corrupt_slot_metadata(jc, 1)
    ok2, cache = eng.corrupt_slot_metadata(cache, 1)
    assert ok and ok2
    for f in meta.FIELDS:
        got = getattr(cache["rest"]["meta"], f).to(torch.float32).numpy()
        want = np.asarray(getattr(jc["rest"]["meta"], f).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


def _paged_policy(pool_blocks):
    return PolicyConfig(kind="fier", budget=16, group=8, skip_layers=1, sink=2, recent=4,
                        pipeline="reference", layout="paged", block_size=8,
                        pool_blocks=pool_blocks)


def test_offload_roundtrip_bit_identical(setup):
    """Insert a prompt, park its blocks, age them onto the host tier by TTL,
    recall them through ``begin_chunked``: every recalled pool row equals
    its pre-eviction snapshot byte for byte, in every leaf."""
    _, cfg, _, params, _, _ = setup
    clock = [0.0]
    eng = Engine(build_model(cfg, _paged_policy(14), device="cpu"), n_slots=2, capacity=64,
                 offload_blocks=8, prefix_ttl=5.0)
    eng.set_pool_clock(lambda: clock[0])
    cache = eng.new_cache()
    toks = list(range(1, 21))                       # 20 tokens, 3 blocks
    keys = block_hash_chain(toks, eng.block_size)
    _, cache = eng.insert(params, cache, torch.tensor([toks]), len(toks), slot=0)
    snap = {k: eng._read_block(cache, b) for k, b in zip(keys, eng._seq[0].blocks)}
    cache = eng.release_slot(cache, 0)              # every block parks
    clock[0] = 10.0                                 # past the TTL
    swept, cache = eng.sweep_parked(cache)
    assert swept == len(keys) and set(keys) <= eng.offload.keys()
    for k in keys:  # the host copy equals the pre-eviction device rows
        for a, b in zip(eng.offload._store[k].payload, snap[k]):
            assert torch.equal(a, b)
    resume, cache = eng.begin_chunked(cache, 0, toks)
    n_full = (len(toks) - 1) // eng.block_size      # the final chunk computes
    assert resume == n_full * eng.block_size and eng.blocks_recalled == n_full
    assert eng.take_recall_units() == pytest.approx(eng.recall_cost * n_full)
    for j, bid in enumerate(eng._seq[0].blocks):
        for a, b in zip(eng._read_block(cache, bid), snap[keys[j]]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert not (eng.offload.keys() & set(keys[:n_full]))  # exactly one owner
    eng.audit()
    cache = eng.abort_chunked(cache, 0)
    eng.audit()
    assert eng.allocator.n_in_use == 0


def _prefix_trace(cls):
    shared = list(range(7, 23))                     # 16-token prefix
    reqs = [cls(rid=i, tokens=shared + [40 + i] * 4, max_new=6) for i in range(2)]
    for i in range(2, 6):                           # distinct fillers age the prefix out
        base = 60 + 10 * i
        reqs.append(cls(rid=i, tokens=list(range(base, base + 20)), max_new=6))
    reqs += [cls(rid=i, tokens=shared + [50 + i] * 4, max_new=6) for i in (6, 7)]
    return reqs


def test_offload_engine_matches_baseline_with_fewer_recomputed_tokens(setup):
    jcfg, cfg, jparams, params, _, _ = setup
    outs, recomputed, recalled = {}, {}, {}
    for name, kw in (("base", dict(prefix_ttl=8.0)),
                     ("offload", dict(prefix_ttl=8.0, offload_blocks=12))):
        eng = Engine(build_model(cfg, _paged_policy(10), device="cpu"), n_slots=2,
                     capacity=64, **kw)
        outs[name] = _ints(ContinuousScheduler(eng, params, chunk_tokens=8).run(
            _prefix_trace(Request)))
        recomputed[name], recalled[name] = eng.tokens_recomputed, eng.blocks_recalled
        _check_drained(eng)
    assert outs["offload"] == outs["base"]
    assert 0 < recomputed["offload"] < recomputed["base"] and recalled["offload"] > 0
    jpol = JPolicy(kind="fier", budget=16, group=8, skip_layers=1, sink=2, recent=4,
                   pipeline="reference", layout="paged", block_size=8, pool_blocks=10)
    jeng = JEngine(j_build_model(jcfg, jpol), n_slots=2, capacity=64, prefix_ttl=8.0,
                   offload_blocks=12)
    want = JScheduler(jeng, jparams, chunk_tokens=8).run(_prefix_trace(JRequest))
    assert outs["offload"] == _ints(want)
    assert (recomputed["offload"], recalled["offload"]) == (
        jeng.tokens_recomputed, jeng.blocks_recalled)


def test_ttl_sweep_matches_jax(setup):
    """Park two prompts' blocks at different virtual times and sweep at
    several clocks: the port expires exactly the blocks the JAX engine does,
    each sweep demotes them into the host tier, and the audit stays clean."""
    jcfg, cfg, jparams, params, _, _ = setup
    jpol = JPolicy(kind="fier", budget=16, group=8, skip_layers=1, sink=2, recent=4,
                   pipeline="reference", layout="paged", block_size=8, pool_blocks=14)
    jeng = JEngine(j_build_model(jcfg, jpol), n_slots=2, capacity=64, prefix_ttl=5.0,
                   offload_blocks=8)
    eng = Engine(build_model(cfg, _paged_policy(14), device="cpu"), n_slots=2, capacity=64,
                 prefix_ttl=5.0, offload_blocks=8)
    clock = [0.0]
    for e in (jeng, eng):
        e.set_pool_clock(lambda: clock[0])
    caches = [jeng.new_cache(), eng.new_cache()]
    prompts = [list(range(1, 21)), list(range(30, 47))]
    swept = {0: [], 1: []}
    for i, (e, mk) in enumerate(((jeng, lambda t: jnp.asarray([t], jnp.int32)),
                                 (eng, lambda t: torch.tensor([t])))):
        clock[0] = 0.0
        c = caches[i]
        for slot, toks in enumerate(prompts):
            _, c = e.insert(jparams if i == 0 else params, c, mk(toks), len(toks), slot=slot)
        c = e.release_slot(c, 0)                    # parks at t = 0
        clock[0] = 3.0
        c = e.release_slot(c, 1)                    # parks at t = 3
        for t in (4.0, 6.0, 9.0):
            clock[0] = t
            n, c = e.sweep_parked(c)
            swept[i].append((n, len(e.offload), e.allocator.stats()["pool_ttl_evictions"]))
        e.audit()
    assert swept[1] == swept[0]
    assert swept[1][-1][0] > 0 and swept[1][1][0] > 0


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_probe_records_match_jax(setup, layout):
    jcfg, cfg, jparams, params, _, _ = setup
    reqs = lambda cls: [cls(rid=i, tokens=list(range(3 + 5 * i, 33 + 5 * i)), max_new=8)
                        for i in range(2)]
    pool = 40 if layout == "paged" else 0
    jobs = JObservability(introspect=True)
    jeng = JEngine(j_build_model(jcfg, _policy(JPolicy, layout, pool)), n_slots=2,
                   capacity=64, obs=jobs)
    JScheduler(jeng, jparams).run(reqs(JRequest))
    obs = Observability(introspect=True)
    eng = Engine(build_model(cfg, _policy(PolicyConfig, layout, pool), device="cpu"),
                 n_slots=2, capacity=64, obs=obs)
    ContinuousScheduler(eng, params).run(reqs(Request))
    got, want = obs.introspector.records, jobs.introspector.records
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.step, g.slot, g.length, g.budget, g.budget_utilization) == (
            w.step, w.slot, w.length, w.budget, w.budget_utilization)
        assert abs(g.tau - w.tau) <= 1e-5 * max(1.0, abs(w.tau))
        assert g.oracle_overlap == w.oracle_overlap
        assert abs(g.recaptured_mass - w.recaptured_mass) <= 1e-5
        for v in (g.budget_utilization, g.oracle_overlap, g.recaptured_mass):
            assert 0.0 <= v <= 1.0 + 1e-6
        assert np.isfinite(g.tau)
