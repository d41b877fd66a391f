"""Port parity of the transformer families: every dense, moe and vlm arch of
the config registry at ``reduced_config`` (2 layers, d 64, 4 heads of 16,
2 or 4 kv heads; moe 4 experts top-2) against the JAX package.

Weights cross over with ``params_from_jax``; prompts are numpy-seeded
(seed 0).  Policy fier / one_pass / budget 16 / group 8 / skip 1 (one FIER
layer), capacity 64, block size 8.  For each arch:

* prefill logits of two prompts (32 and 24 tokens) within 1e-2·max|logit|
  (measured 6e-8 to 5.7e-3 with seed 0): the f32 head over bf16 hidden
  states, a few of whose roundings flip where a bf16 matmul sums a row in
  another f32 order than XLA's (which rows depends on the GEMM's tiling);
* ``Engine.generate`` of 6 greedy tokens on the slab cache, the paged
  ``ContinuousScheduler`` and the chunked one (``prefill_chunk``, 8-token
  chunks, slab) each give the JAX package's tokens exactly;
* llava-next-mistral-7b also prefills with 8 seeded vision embeddings
  before its tokens (lengths count them): logits within the same
  tolerance, then 4 greedy ``decode_step``s equal.

With seed 0 the first step's top two logits lie 0.5% to 9.7% of max|logit|
apart, above every gap measured, so equal tokens do not rest on a near-tie.
The JAX engines are compiled once per arch in a module-scoped fixture.
"""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
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
from repro_torch.serving import ContinuousScheduler, Engine, Request

ARCHS = ["olmo-1b", "minicpm-2b", "starcoder2-3b", "command-r-plus-104b",
         "granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "llava-next-mistral-7b"]
CAP = 64
LENS = np.array([32, 24], np.int32)
MAX_NEW = 6
LOGIT_REL_TOL = 1e-2


def _policy(cls, layout):
    return cls(kind="fier", budget=16, group=8, skip_layers=1, pipeline="one_pass",
               layout=layout, block_size=8)


def _engines(arch, layout):
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    je = JEngine(j_build_model(jcfg, _policy(JPolicy, layout)), n_slots=2, capacity=CAP)
    te = Engine(build_model(cfg, _policy(PolicyConfig, layout), device="cpu"),
                n_slots=2, capacity=CAP)
    return je, te


@pytest.fixture(scope="module")
def models():
    """{arch: (JAX slab engine, port slab engine, jax params, port params)}."""
    out = {}
    for arch in ARCHS:
        je, te = _engines(arch, "slab")
        jp = je.bundle.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), te.bundle.cfg, device="cpu")
        out[arch] = (je, te, jp, tp)
    return out


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return rng.integers(0, vocab, (2, int(LENS.max()))).astype(np.int32)


def _close_logits(got, want, vocab):
    got = got.to(torch.float32).numpy()[:, :vocab]
    want = np.asarray(want)[:, :vocab]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_REL_TOL * scale, np.abs(got - want).max() / scale


def _reqs(cls, vocab):
    P = _prompts(vocab)
    return [cls(rid=i, tokens=[int(t) for t in P[i, :n]], max_new=MAX_NEW)
            for i, n in enumerate(LENS)]


def _tokens(out):
    return {k: [int(t) for t in v] for k, v in out.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_family_matches_reference(models, arch):
    je, te, jp, tp = models[arch]
    cfg = te.bundle.cfg
    assert cfg.family in ("dense", "moe", "vlm")
    P = _prompts(cfg.vocab)

    # ---- prefill logits and static-batch greedy generate (slab one_pass)
    jl, _ = je.prefill_batch(jp, {"tokens": jnp.asarray(P), "lengths": jnp.asarray(LENS)})
    tl, _ = te.prefill_batch(tp, {"tokens": torch.from_numpy(P),
                                  "lengths": torch.from_numpy(LENS)})
    _close_logits(tl, jl, cfg.vocab)
    want = np.asarray(je.generate(jp, jnp.asarray(P), jnp.asarray(LENS), MAX_NEW))
    got = te.generate(tp, torch.from_numpy(P), torch.from_numpy(LENS), MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), want)

    # ---- the paged scheduler, and the chunked one on the slab (prefill_chunk)
    jpg, tpg = _engines(arch, "paged")
    want = _tokens(JScheduler(jpg, jp, pad_prompt_to=32).run(_reqs(JRequest, cfg.vocab)))
    assert ContinuousScheduler(tpg, tp, pad_prompt_to=32).run(_reqs(Request, cfg.vocab)) == want
    tpg.audit()
    want = _tokens(JScheduler(je, jp, chunk_tokens=8).run(_reqs(JRequest, cfg.vocab)))
    sched = ContinuousScheduler(te, tp, chunk_tokens=8)
    assert sched.run(_reqs(Request, cfg.vocab)) == want
    assert sched.prefill_chunks > 2

    if cfg.family != "vlm":
        return
    # ---- vision embeddings before the tokens; lengths count them
    nv = cfg.n_vision_tokens
    ve = np.random.default_rng(1).standard_normal((2, nv, cfg.d_model)).astype(np.float32)
    vej = jnp.asarray(ve).astype(jnp.bfloat16)
    vet = torch.from_numpy(np.array(vej.astype(jnp.float32))).to(torch.bfloat16)
    lens = LENS + nv
    jb, tb = je.bundle, te.bundle
    jl, jc = jax.jit(jb.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(P), "lengths": jnp.asarray(lens), "vision_embeds": vej}, CAP)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(P), "lengths": torch.from_numpy(lens),
                             "vision_embeds": vet}, CAP)
    _close_logits(tl, jl, cfg.vocab)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1).to(torch.int32)
    jstep = jax.jit(jb.decode_step)
    for _ in range(4):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jstep(jp, jtok, jc)
        tl, tc = tb.decode_step(tp, ttok, tc)
        _close_logits(tl, jl, cfg.vocab)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_vlm_generate_with_extras(models):
    """llava-next-mistral-7b through ``Engine.generate(..., extras=
    {"vision_embeds": ...})``: the port's engine merges the vision
    embeddings into the prefill batch as the reference's does, and the 6
    greedy tokens equal the reference engine's (the same embeddings as the
    bundle-level check above, lengths counting them)."""
    je, te, jp, tp = models["llava-next-mistral-7b"]
    cfg = te.bundle.cfg
    P = _prompts(cfg.vocab)
    nv = cfg.n_vision_tokens
    ve = np.random.default_rng(1).standard_normal((2, nv, cfg.d_model)).astype(np.float32)
    vej = jnp.asarray(ve).astype(jnp.bfloat16)
    vet = torch.from_numpy(np.array(vej.astype(jnp.float32))).to(torch.bfloat16)
    lens = LENS + nv
    want = np.asarray(je.generate(jp, jnp.asarray(P), jnp.asarray(lens), MAX_NEW,
                                  extras={"vision_embeds": vej}))
    got = te.generate(tp, torch.from_numpy(P), torch.from_numpy(lens), MAX_NEW,
                      extras={"vision_embeds": vet})
    np.testing.assert_array_equal(got.numpy(), want)
