"""Port parity of the paged serving path: the engine's paged lifecycle and
``ContinuousScheduler``, on reduced olmo-1b on the CPU.

Weights cross over from the JAX package with ``params_from_jax``; prompts
are fixed token lists.  Greedy decoding throughout, so "equal" means equal
token lists:

* paged scheduler tokens = slab scheduler tokens = the JAX package's paged
  scheduler tokens (mirrors ``tests/test_paged.py::test_paged_scheduler_matches_slab``);
* chunked admission = monolithic admission on both layouts (mirrors
  ``tests/test_serving.py::test_chunked_prefill_matches_monolithic``);
* preemption under > 2x oversubscription = an unconstrained pool, audits
  clean; prefix sharing with copy-on-write divergence = cold single runs;
  a chunked admission aborted by a dry pool resumes from its boundary and
  gives the uncontended tokens;
* admission look-ahead past a blocked head, rejection, cancel, deadlines
  and the budget ladder behave as the JAX package's tests require;
* the smoke trace of ``benchmarks/bench_serve_trace.py`` replayed through the
  port's scheduler reproduces the committed ``BENCH_serve_trace.json``
  virtual-clock metrics exactly (the clock counts tokens, so this checks
  every host-side scheduling decision).
"""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import json
import os
from collections import deque

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core.policy import PolicyConfig as JPolicy
from repro.models import build_model as j_build_model
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import PolicyConfig
from repro_torch.models import build_model
from repro_torch.obs import Observability, derive_serving_metrics
from repro_torch.serving import ContinuousScheduler, Engine, Request
from repro_torch.serving import engine as engine_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _policy(cls, layout, pool_blocks=0):
    return cls(kind="fier", budget=16, group=8, skip_layers=1, pipeline="one_pass",
               layout=layout, block_size=8, pool_blocks=pool_blocks)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = j_reduced_config("olmo-1b"), reduced_config("olmo-1b")
    jparams = j_build_model(jcfg, _policy(JPolicy, "slab")).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")

    def engine(layout, pool_blocks=0, *, n_slots, capacity=64):
        bundle = build_model(cfg, _policy(PolicyConfig, layout, pool_blocks), device="cpu")
        return Engine(bundle, n_slots=n_slots, capacity=capacity)

    return jcfg, jparams, params, engine


def _reqs(cls=Request, n=4, max_new=5):
    return [cls(rid=i, tokens=list(range(3 + i, 11 + i)), max_new=max_new) for i in range(n)]


def test_paged_scheduler_matches_slab_and_reference(setup):
    jcfg, jparams, params, engine = setup
    eng = engine("paged", n_slots=3)
    paged = ContinuousScheduler(eng, params, pad_prompt_to=16).run(_reqs())
    slab = ContinuousScheduler(engine("slab", n_slots=3), params, pad_prompt_to=16).run(_reqs())
    assert paged == slab
    assert eng.allocator.n_in_use == 0
    eng.audit()
    jeng = JEngine(j_build_model(jcfg, _policy(JPolicy, "paged")), n_slots=3, capacity=64)
    want = JScheduler(jeng, jparams, pad_prompt_to=16).run(_reqs(JRequest))
    assert paged == {k: [int(t) for t in v] for k, v in want.items()}


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_chunked_prefill_matches_monolithic(setup, layout):
    _, _, params, engine = setup

    def reqs():
        return [Request(rid=i, tokens=list(range(3 + i, 20 + 3 * i)), max_new=6)
                for i in range(4)]

    mono = ContinuousScheduler(engine(layout, 40, n_slots=2), params).run(reqs())
    eng = engine(layout, 40, n_slots=2)
    sched = ContinuousScheduler(eng, params, chunk_tokens=5)
    assert sched.run(reqs()) == mono
    assert sched.prefill_chunks > 4
    eng.audit()


def test_preemption_roundtrip_under_2x_oversubscription(setup):
    """capacity 64 / bs 8 → 8 blocks worst case per request; 3 requests =
    24 blocks against 9 usable: preemption, then the unconstrained tokens."""
    _, _, params, engine = setup
    eng = engine("paged", 10, n_slots=3)
    sched = ContinuousScheduler(eng, params, pad_prompt_to=16, audit_every=1)
    out = sched.run(_reqs(n=3, max_new=25))
    assert sched.preemptions > 0 and sched.health.audits_run > 0
    assert all(len(v) == 25 for v in out.values())
    assert eng.allocator.n_in_use == 0
    big = ContinuousScheduler(engine("paged", n_slots=3), params, pad_prompt_to=16)
    assert out == big.run(_reqs(n=3, max_new=25))


def test_prefix_shared_blocks_and_cow_divergence(setup):
    """Two identical prompts: the second admission shares every block (one
    prefill), its first decode write copies the shared partial tail, and
    both outputs equal a cold single run."""
    _, _, params, engine = setup
    eng = engine("paged", n_slots=2)
    twin = [Request(rid=i, tokens=[5, 6, 7, 8, 9], max_new=6) for i in range(2)]
    out = ContinuousScheduler(eng, params, pad_prompt_to=16).run(twin)
    st = eng.pool_stats()
    assert st["engine_prefills"] == 1 and st["engine_prefix_hits"] == 1, st
    assert st["pool_cow_copies"] >= 1, st
    assert out[0] == out[1]
    solo = ContinuousScheduler(engine("paged", n_slots=1), params, pad_prompt_to=16)
    assert out[0] == solo.run([Request(rid=0, tokens=[5, 6, 7, 8, 9], max_new=6)])[0]


def test_chunked_preemption_resumes_from_boundary(setup):
    """A half-prefilled request that finds the pool dry aborts itself,
    re-queues, resumes from its completed-chunk boundary (not token 0) and
    still produces the uncontended output (mirrors the JAX package's test)."""
    _, _, params, engine = setup

    def reqs():
        return [Request(rid=0, tokens=list(range(2, 42)), max_new=8),
                Request(rid=1, tokens=list(range(5, 53)), max_new=4)]

    want = ContinuousScheduler(engine("paged", 32, n_slots=2), params).run(reqs())
    eng = engine("paged", 9, n_slots=2)
    sched = ContinuousScheduler(eng, params, chunk_tokens=16)
    calls, aborts = [], []
    chunk, abort = eng.prefill_chunk, eng.abort_chunked

    def chunk_spy(p, c, slot, toks, start, n):
        calls.append((sched._prefilling.req.rid, start))
        return chunk(p, c, slot, toks, start, n)

    def abort_spy(cache, slot):
        aborts.append((sched._prefilling.req.rid, len(calls)))
        return abort(cache, slot)

    eng.prefill_chunk, eng.abort_chunked = chunk_spy, abort_spy
    assert sched.run(reqs()) == want
    assert sched.prefill_aborts >= 1
    resumes = [next((s for r, s in calls[i:] if r == rid), None) for rid, i in aborts]
    assert any(s is not None and s > 0 for s in resumes), (calls, aborts)


def test_admission_skips_blocked_head_and_rejects_inadmissible(setup):
    """A queued request that cannot get blocks yet does not block a later
    one that fits; a prompt longer than capacity is retired ``rejected``
    while the rest are served."""
    _, _, params, engine = setup
    eng = engine("paged", 9, n_slots=2)
    sched = ContinuousScheduler(eng, params)
    sched.start()
    hold = Request(rid=0, tokens=list(range(2, 26)), max_new=20)
    sched.submit(hold)
    sched.step()
    big = Request(rid=1, tokens=list(range(3, 50)), max_new=4)    # 6 blocks
    small = Request(rid=2, tokens=list(range(4, 12)), max_new=4)  # 1 block
    sched.submit(big)
    sched.submit(small)
    sched.step()
    assert small in sched.running.values() and not big.out
    while sched.busy:
        sched.step()
    assert [len(r.out) for r in (hold, big, small)] == [20, 4, 4]
    with pytest.warns(UserWarning, match="exceeds engine capacity"):
        out = ContinuousScheduler(engine("paged", n_slots=2), params).run(
            [Request(rid=0, tokens=list(range(1, 100)), max_new=4),
             Request(rid=1, tokens=[3, 4, 5], max_new=3)])
    assert out[0] == [] and len(out[1]) == 3
    assert out.outcomes[0].status == "rejected" and out.outcomes[1].status == "finished"


def test_deadline_and_cancel_release_blocks(setup):
    """A request cancelled mid-decode and one whose virtual-clock deadline
    passes while queued leave with structured outcomes and no held block."""
    _, _, params, engine = setup
    eng = engine("paged", n_slots=1)
    sched = ContinuousScheduler(eng, params)
    sched.start()
    a = Request(rid=0, tokens=list(range(2, 20)), max_new=30)
    b = Request(rid=1, tokens=list(range(3, 9)), max_new=3, deadline=5.0)
    sched.submit(a)
    sched.submit(b)
    sched.step()
    sched.step()
    assert sched.cancel(0) and not sched.cancel(0)
    while sched.busy:
        sched.step()
    assert sched.outcomes[0].status == "cancelled"
    assert sched.outcomes[1].status == "deadline_exceeded" and b.out == []
    assert eng.allocator.n_in_use == 0
    eng.audit()


def test_budget_ladder_sheds_and_restores(setup, monkeypatch):
    """A downshift halves the budget and sheds a running slot's middle
    blocks (their table entries become the null block); the next decode
    step still runs, and the restore brings the full budget back."""
    _, _, params, engine = setup
    monkeypatch.setattr(engine_mod, "DEGRADE_FLOOR", 4)
    eng = engine("paged", n_slots=1, capacity=128)
    cache = eng.new_cache()
    toks = torch.arange(3, 3 + 70).reshape(1, -1)
    lg, cache = eng.insert(params, cache, toks, 70, 0)
    assert eng.downshift_budget() and eng.current_budget == 8
    freed, cache = eng.shed_middle_blocks(cache, 0)
    assert freed > 0 and (cache["block_table"][0, 1:freed + 1] == 0).all()
    ok, cache = eng.advance_slot(cache, 0)
    tok, lg, cache = eng.decode(params, torch.argmax(lg, -1).to(torch.int32), cache)
    assert ok and torch.isfinite(lg).all() and int(cache["length"][0]) == 71
    assert eng.maybe_restore_budget() and eng.current_budget == 16
    cache = eng.release_slot(cache, 0)
    eng.audit()
    assert eng.engine_stats()["engine_blocks_shed"] == freed


def test_trace_replay_reproduces_committed_vtime_metrics():
    """``bursty_trace`` and the smoke engine of ``bench_serve_trace.py``
    (reduced olmo-1b, capacity 1024, 4 slots, 34 pool blocks, bs 32; fier
    budget 64, group 32, skip 1, sink 4, recent 32), replayed on one port
    engine chunked (256) and then monolithic, as the bench does; each run's
    ``start`` restarts the pool.  The virtual-clock metrics and counters
    equal the committed ``BENCH_serve_trace.json`` values exactly."""
    from benchmarks.bench_serve_trace import SMOKE_ENGINE, build_serving, bursty_trace

    jcfg, jparams, _ = build_serving("reference", **SMOKE_ENGINE)
    cfg = reduced_config("olmo-1b")
    pol = PolicyConfig(kind="fier", budget=64, group=32, skip_layers=1, sink=4, recent=32,
                       pipeline="reference", layout="paged",
                       block_size=SMOKE_ENGINE["block_size"],
                       pool_blocks=SMOKE_ENGINE["pool_blocks"])
    eng = Engine(build_model(cfg, pol, device="cpu"), n_slots=SMOKE_ENGINE["n_slots"],
                 capacity=SMOKE_ENGINE["capacity"], obs=Observability())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    trace = bursty_trace(0, cfg.vocab)
    doc = json.load(open(os.path.join(REPO, "BENCH_serve_trace.json")))
    want = {m["name"]: m["value"] for m in doc["metrics"]}
    for mode, chunk in (("chunked", 256), ("mono", None)):
        sched = ContinuousScheduler(eng, params, chunk_tokens=chunk)
        sched.start()
        pending = deque((t, Request(**spec)) for t, spec in trace)
        while pending or sched.busy:
            while pending and pending[0][0] <= sched.vtime:
                t, r = pending.popleft()
                sched.submit(r, arrival=t)
            if not sched.busy or not sched.step():
                assert pending, "trace replay stalled"
                sched.idle_until(pending[0][0])
        d = derive_serving_metrics(eng.obs.tracer)
        pool = eng.pool_stats()
        got = {
            "vt_ttft_p50": d["ttft_p50"], "vt_ttft_p99": d["ttft_p99"],
            "vt_itl_p50": d["itl_p50"], "vt_itl_p99": d["itl_p99"],
            "vt_tokens_per_kunit": d["tokens_per_kunit"],
            "preemptions": sched.preemptions, "mean_occupancy": sched.mean_occupancy,
            "peak_blocks": pool["pool_peak_in_use"],
            "prefix_block_hits": pool["pool_prefix_block_hits"],
        }
        if chunk:
            got["prefill_chunks"] = sched.prefill_chunks
            got["prefill_aborts"] = sched.prefill_aborts
        for name, value in got.items():
            assert value == want[f"{mode}_{name}"], (mode, name, value)
        eng.audit()
        assert eng.allocator.n_in_use == 0


def test_paged_entry_points_default_to_cuda_and_not_ported_hooks():
    cfg = reduced_config("olmo-1b")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine.build(cfg, n_slots=1, capacity=64, layout="paged")
    eng = Engine.build(cfg, n_slots=1, capacity=64, layout="paged", device="cpu")
    assert eng.paged and eng.pool_blocks == 64 // 32 + 1
    # the fault hooks and the introspector (ROADMAP Queue 1 item 8) are ported
    from repro_torch.serving import ServingFaultInjector

    inj = ServingFaultInjector([])
    assert ContinuousScheduler(eng, {}, injector=inj).injector is inj
    assert Observability(introspect=True).introspector is not None
    cache = eng.new_cache()
    ok, same = eng.corrupt_slot_metadata(cache, 0)
    assert not ok and same is cache  # the slot holds no block yet
    # mesh sharding (ROADMAP Queue 1 item 10's serving part) is ported: a mesh
    # builds a sharded engine, and a mesh axis other than data/model raises
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert Engine.build(cfg, n_slots=1, capacity=64, layout="paged", mesh=mesh,
                        device="cpu").shard.mesh is mesh
    with pytest.raises(ValueError, match="must be named"):
        Engine.build(cfg, n_slots=1, capacity=64, layout="paged",
                     mesh=make_mesh((1,), ("expert",), device="cpu"), device="cpu")
