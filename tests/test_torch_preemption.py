"""Preemption under faults at the size of ``chip_smoke.py``'s chaos trace,
on the CPU, in both packages.

The trace is ``chip_smoke.chaos_requests`` (4346- and 4352-token prompts
sharing a 4096-token prefix, 3000- and 1500-token prompts; 16 tokens each)
on reduced olmo-1b with 4 layers, served by a paged engine of the chaos
run's shape (8 slots × 8192, 621 blocks of 32, a host tier of 256 blocks,
TTL 4, the ladder off, chunks of 2048) with the ``reference`` pipeline, once
without faults and once under ``ServingFaultInjector.random(0)``.  Weights
cross over with ``params_from_jax``.

Both packages fire the same faults at the same steps, preempt the same
requests in the same order and end each request the same way.  In each
package, a request that no fault names and nothing preempted gives its
fault-free tokens, and a preempted request that no fault names gives them
up to its first preemption.  After it, the request recomputes its generated
tokens' K/V in prefill chunks, which attend densely where the decode steps
attended to the selected tokens, so its later tokens are not held to the
fault-free run: on this trace the JAX scheduler's own request 2 leaves its
fault-free tokens after preemption (run with ``-rP`` to see each package's
readings).  The two packages' tokens are not compared with each other:
greedy decoding at this size has near-ties across packages.
"""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import dataclasses
import importlib.util
import os
import warnings

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as j_reduced_config
from repro.core.policy import PolicyConfig as JPolicy
from repro.models import build_model as j_build_model
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServingFaultInjector as JInjector
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import PolicyConfig
from repro_torch.models import build_model
from repro_torch.serving import ContinuousScheduler, Engine, Request, ServingFaultInjector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LAYERS = 4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _policy(cls):
    return cls(kind="fier", budget=1024, group=32, skip_layers=2, sink=4, recent=64,
               pipeline="reference", layout="paged", block_size=32, pool_blocks=621)


@pytest.fixture(scope="module")
def runs():
    cs = _chip_smoke()
    jcfg = dataclasses.replace(j_reduced_config("olmo-1b"), n_layers=N_LAYERS)
    cfg = dataclasses.replace(reduced_config("olmo-1b"), n_layers=N_LAYERS)
    jbundle = j_build_model(jcfg, _policy(JPolicy))
    jparams = jbundle.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    bundle = build_model(cfg, _policy(PolicyConfig), device="cpu")
    packages = {
        "jax": (JEngine, JScheduler, JRequest, JInjector, jbundle, jparams),
        "torch": (Engine, ContinuousScheduler, Request, ServingFaultInjector, bundle, params),
    }
    out = {}
    for pkg, (eng_cls, sched_cls, req_cls, inj_cls, b, p) in packages.items():
        for name in ("fault-free", "chaos"):
            eng = eng_cls(b, n_slots=8, capacity=8192, offload_blocks=256, prefix_ttl=4.0,
                          degrade_floor=1024)
            reqs = [req_cls(rid=r.rid, tokens=list(r.tokens), max_new=r.max_new)
                    for r in cs.chaos_requests(cfg.vocab)]
            inj = None
            if name == "chaos":
                inj = inj_cls.random(0, rids=[r.rid for r in reqs], n_faults=5,
                                     step_lo=1, step_hi=8)
            sched = sched_cls(eng, p, chunk_tokens=2048, injector=inj, audit_every=4)
            marks = cs.preempt_marks(sched, reqs)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res = sched.run(reqs)
            eng.audit()
            out[pkg, name] = dict(
                tokens={rid: [int(t) for t in toks] for rid, toks in res.items()},
                status={rid: oc.status for rid, oc in res.outcomes.items()},
                events=[(e["kind"], e["rid"]) for e in sched.health.events
                        if e["kind"] in ("preempt", "prefill_abort")],
                fired=list(inj.fired_log) if inj else [],
                named={s.rid for s in inj.specs} if inj else set(),
                marks=marks, steps=sched.steps, in_use=eng.allocator.n_in_use,
            )
    return out


def test_both_packages_fault_and_preempt_alike(runs):
    for name in ("fault-free", "chaos"):
        j, t = runs["jax", name], runs["torch", name]
        for key in ("status", "events", "fired", "marks", "steps"):
            assert t[key] == j[key], (name, key)
        assert t["in_use"] == j["in_use"] == 0
    assert not runs["torch", "fault-free"]["events"]
    assert runs["torch", "chaos"]["events"], "the trace must preempt"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_preempted_requests_keep_fault_free_tokens_until_preempted(runs, pkg):
    ff, ch = runs[pkg, "fault-free"]["tokens"], runs[pkg, "chaos"]
    marks, named = ch["marks"], ch["named"]
    untouched = sorted(set(ff) - named - set(marks))
    hit = sorted(set(marks) - named)
    assert untouched and hit
    for rid in untouched:
        assert ch["tokens"][rid] == ff[rid], rid
    for rid in hit:
        n = marks[rid]
        assert ch["tokens"][rid][:n] == ff[rid][:n], rid
    after = {}
    for rid in hit:
        diff = [i for i, (a, b) in enumerate(zip(ch["tokens"][rid], ff[rid])) if a != b]
        after[rid] = diff[0] if diff else None
    print(f"{pkg}: preempted with tokens generated then {marks}; faults name {sorted(named)}; "
          f"first token that leaves the fault-free run, per preempted request no fault "
          f"names: {after}")
