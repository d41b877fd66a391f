"""Port parity of the whole slice: olmo-1b (reduced) served by both engines.

The reference's parameters cross over with ``params_from_jax``, prompts are
numpy-seeded, and both engines run the default one-pass pipeline with one
skip layer (the reduced model has two layers), sink 4 and recent 8.

* Prefill: logits within 1e-4 (f32 head, other summation order); the K/V
  cache and its side-car equal except for at most 1% of elements, each
  within 2^-5·max|x| — an f32 summation order that flips one bf16 rounding
  upstream moves the few elements downstream of it by a few bf16 steps.
* Teacher-forced decode with the budget at the full capacity, so every
  valid token is selected: the reference's prefill cache is copied into the
  port's first, so both decode from equal caches; 8 steps fed the
  reference's greedy tokens, logits within 1e-4·max|logit|.  (Chained on the
  port's own prefill cache, one bf16 element that the prefill check admits
  can move a row's logits past that tolerance.)  The port's own chained
  decode still gives the reference's greedy tokens in those 8 steps.
* Greedy ``Engine.generate`` with budget 32 < prompt lengths (selection
  active): tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import serving_policy as j_serving_policy
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.serving import Engine, serving_policy

CAPACITY = 128
LENGTHS = np.array([80, 57], np.int32)


def _cfgs(n_kv):
    jc, tc = j_reduced_config("olmo-1b"), reduced_config("olmo-1b")
    if n_kv is not None:
        jc, tc = (dataclasses.replace(c, n_kv_heads=n_kv) for c in (jc, tc))
    return jc, tc


def _engines(n_kv, budget):
    jc, tc = _cfgs(n_kv)
    pol = dict(budget=budget, skip_layers=1, sink=4, recent=8)
    je = JEngine.build(jc, n_slots=2, capacity=CAPACITY, policy=j_serving_policy(**pol))
    te = Engine.build(tc, n_slots=2, capacity=CAPACITY, policy=serving_policy(**pol),
                      device="cpu")
    jp = je.bundle.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return je, jp, te, tp


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (2, int(LENGTHS.max()))).astype(np.int32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_bf16(got, want, what):
    got, want = _f32(got), _f32(want)
    diff = np.abs(got - want)
    off = diff > 0
    assert off.mean() <= 0.01, f"{what}: {off.mean():.2%} of elements differ"
    assert diff.max() <= 2.0**-5 * np.abs(want).max(), f"{what}: max gap {diff.max():.3g}"


def _to_torch(a, like):
    """A reference array as a CPU tensor of ``like``'s dtype (bf16 values
    pass exactly through f32)."""
    return torch.from_numpy(_f32(a)).to(like.dtype)


def _cache_from_reference(tc, jc):
    """The port's cache ``tc`` with the reference cache ``jc``'s contents:
    front/rest k and v, the rest side-car's codes, scale and zero, and
    length."""
    out = {**tc, "front": dict(tc["front"]), "rest": dict(tc["rest"])}
    for part in ("front", "rest"):
        for name in ("k", "v"):
            out[part][name] = _to_torch(jc[part][name], tc[part][name])
    jm, tm = jc["rest"]["meta"], tc["rest"]["meta"]
    out["rest"]["meta"] = dataclasses.replace(
        tm, codes=torch.from_numpy(np.asarray(jm.codes)).to(tm.codes.dtype),
        scale=_to_torch(jm.scale, tm.scale), zero=_to_torch(jm.zero, tm.zero),
    )
    out["length"] = torch.from_numpy(np.asarray(jc["length"])).to(tc["length"].dtype)
    return out


@pytest.mark.parametrize("n_kv", [None, 2], ids=["mha", "gqa"])
def test_prefill_and_teacher_forced_decode(n_kv):
    je, jp, te, tp = _engines(n_kv, budget=CAPACITY)
    P = _prompts()
    jl, jc = je.prefill_batch(jp, {"tokens": jnp.asarray(P), "lengths": jnp.asarray(LENGTHS)})
    tl, tc = te.prefill_batch(tp, {"tokens": torch.from_numpy(P), "lengths": torch.from_numpy(LENGTHS)})
    V = 512
    np.testing.assert_allclose(tl.numpy()[:, :V], np.asarray(jl)[:, :V], rtol=0, atol=1e-4)
    assert (tl.numpy()[:, V:] <= -1e29).all()  # padded vocab columns masked
    for part in ("front", "rest"):
        for name in ("k", "v"):
            _close_bf16(tc[part][name], jc[part][name], f"{part}.{name}")
    jm, tm = jc["rest"]["meta"], tc["rest"]["meta"]
    assert (tm.codes.numpy() != np.asarray(jm.codes)).mean() <= 0.01
    _close_bf16(tm.scale, jm.scale, "scale")
    _close_bf16(tm.zero, jm.zero, "zero")
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))

    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    own = tc  # the port's own prefill cache, for the chained greedy run
    tc = _cache_from_reference(tc, jc)
    greedy = []
    for step in range(8):
        jn, jlog, jc = je.decode(jp, jnp.asarray(tok), jc)
        _, tlog, tc = te.decode(tp, torch.from_numpy(tok), tc)
        want = np.asarray(jlog)[:, :V]
        np.testing.assert_allclose(
            tlog.numpy()[:, :V], want, rtol=0, atol=1e-4 * np.abs(want).max(),
            err_msg=f"decode step {step}",
        )
        tok = np.asarray(jn).astype(np.int32)
        greedy.append(tok)
    np.testing.assert_array_equal(tc["length"].numpy(), LENGTHS + 8)

    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(8):
        nxt, _, own = te.decode(tp, torch.from_numpy(tok), own)
        tok = nxt.numpy().astype(np.int32)
        np.testing.assert_array_equal(tok, greedy[step], err_msg=f"chained step {step}")
    np.testing.assert_array_equal(own["length"].numpy(), LENGTHS + 8)


@pytest.mark.parametrize("n_kv", [None, 2], ids=["mha", "gqa"])
def test_greedy_generate_tokens_identical(n_kv):
    je, jp, te, tp = _engines(n_kv, budget=32)
    P = _prompts(seed=1)
    want = je.generate(jp, jnp.asarray(P), jnp.asarray(LENGTHS), 8)
    got = te.generate(tp, torch.from_numpy(P), torch.from_numpy(LENGTHS), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_insert_and_active_decode():
    """insert() fills one slot exactly as a batch prefill of that prompt
    would, and an inactive slot does not advance."""
    _, tc = _cfgs(None)
    te = Engine.build(tc, n_slots=2, capacity=CAPACITY,
                      policy=serving_policy(budget=32, skip_layers=1), device="cpu")
    params = te.bundle.init(0)
    P = torch.from_numpy(_prompts(seed=2)).long()
    cache = te.new_cache()
    lg, cache = te.insert(params, cache, P[1:, :57], 57, 1)
    single_lg, single = te.prefill_batch(params, {"tokens": P[1:, :57],
                                                  "lengths": torch.tensor([57], dtype=torch.int32)})
    assert torch.equal(lg, single_lg)
    assert torch.equal(cache["rest"]["meta"].codes[:, 1], single["rest"]["meta"].codes[:, 0])
    assert cache["length"].tolist() == [0, 57]
    tok = torch.argmax(lg, -1).repeat(2).to(torch.int32)
    nxt, _, cache = te.decode(params, tok, cache, active=torch.tensor([False, True]))
    assert cache["length"].tolist() == [0, 58] and nxt.dtype == torch.int32
