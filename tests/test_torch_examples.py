"""The port's examples (``examples/*_torch.py``) against their JAX
counterparts, on the CPU.

Weights cross over from the JAX package with ``params_from_jax`` (each
JAX bundle's ``init`` at ``PRNGKey(0)``); prompts and requests are the
port's token lists, handed to both sides.  Greedy decoding throughout, so
"equal" means equal token lists:

* ``quickstart_torch.run`` gives ``examples/quickstart.py``'s ``generate``
  tokens (loaded by path, unedited) for the FIER reference pipeline and for
  Full-KV, token for token up to a near-tie: the two packages' decode
  logits differ by up to ~0.7% of max|logit| (a prefill cache element may
  round to another bf16 value; tests/test_torch_model.py), so where a row
  first differs the reference's top-2 logit margin there must lie below
  ``NEAR_TIE`` = 1% of max|logit|;
* ``serve_longcontext_torch.run`` (one_pass: the kernels' plain versions
  here) gives the JAX ``ContinuousScheduler``'s outputs on a shorter
  request list (five requests of at most 7 new tokens, so the run stays
  short while a request still waits for a slot).  The JAX side runs the
  ``reference`` pipeline: its one_pass kernels in interpret mode would take
  minutes, and the reference pipeline's tokens equal one_pass's (tests/
  test_backends.py);
* ``passkey_demo_torch``'s four policies (full, slm, quest, fier) decode
  the digits ``benchmarks/common.py``'s ``policy_bundle`` decodes, on
  untrained weights (no training here), and each reduced cache's digits
  differ from Full-KV's, so the comparison tells the policies apart;
* ``train_tiny_lm_torch``'s command runs the port's train CLI in-process
  for 6 steps with one injected crash and ends with ``restarts: 1``; the
  final checkpoint's held-out loss lies below the initial weights', as the
  example requires after its 60 steps.
"""
import importlib.util
import os
import sys

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
from repro_torch.serving import Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmarks import common as bench_common  # noqa: E402


def _load(name):
    """``examples/<name>.py`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(jbundle, cfg):
    jparams = jbundle.init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


NEAR_TIE = 0.01  # top-2 logit margins below this fraction of max|logit| may flip


def _margins(jbundle, jparams, prompt, toks):
    """The reference's top-2 logit margin [B, n] at each step of a greedy
    run fed ``toks`` [B, n], as a fraction of max|logit|."""
    B, S = prompt.shape
    cap = -(-(S + toks.shape[1]) // 16) * 16
    pre = {"tokens": jnp.asarray(prompt), "lengths": jnp.full((B,), S, jnp.int32)}
    logits, cache = jax.jit(lambda p, b: jbundle.prefill(p, b, capacity=cap))(jparams, pre)
    decode = jax.jit(jbundle.decode_step)
    out = []
    for i in range(toks.shape[1]):
        out.append(np.asarray(logits.astype(jnp.float32)))
        logits, cache = decode(jparams, jnp.asarray(toks[:, i]), cache)
    lg = np.stack(out, 1)
    top = np.sort(lg, -1)
    return (top[..., -1] - top[..., -2]) / np.abs(lg).max()


def test_quickstart_matches_jax_example():
    jq, tq = _load("quickstart"), _load("quickstart_torch")
    jcfg, cfg = j_reduced_config("olmo-1b"), reduced_config("olmo-1b")
    jfier = j_build_model(jcfg, JPolicy(kind="fier", budget=16, group=8, skip_layers=1,
                                        pipeline="reference"))
    jfull = j_build_model(jcfg, JPolicy(kind="full"))
    jparams, params = _params(jfier, cfg)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 48)).astype(np.int32)
    full, fier, agree = tq.run("cpu", prompt=torch.from_numpy(prompt), params=params)
    assert agree == float((full == fier).float().mean())
    for name, got, jbundle in (("full", full, jfull), ("fier", fier, jfier)):
        want = np.asarray(jq.generate(jbundle, jparams, jnp.asarray(prompt)))
        assert got.shape == want.shape == (2, 12)
        margin = _margins(jbundle, jparams, prompt, want)
        for r in range(2):
            diff = np.flatnonzero(got[r].numpy() != want[r])
            if diff.size:  # a flipped near-tie; the rows may go apart after it
                assert margin[r, diff[0]] < NEAR_TIE, (name, r, diff[0], margin[r, diff[0]])


def test_serve_longcontext_matches_jax_scheduler():
    ts = _load("serve_longcontext_torch")
    jcfg, cfg = j_reduced_config("llava-next-mistral-7b"), reduced_config("llava-next-mistral-7b")
    jbundle = j_build_model(jcfg, JPolicy(kind="fier", budget=24, group=8, skip_layers=1,
                                          pipeline="reference"))
    jparams, params = _params(jbundle, cfg)
    reqs = [Request(rid=r.rid, tokens=r.tokens, max_new=3 + r.rid)
            for r in ts.requests(cfg.vocab, n=5)]
    outs, sched, _ = ts.run("cpu", reqs=reqs, params=params)
    assert sched.engine.bundle.policy.pipeline == "one_pass"
    jsched = JScheduler(JEngine(jbundle, n_slots=4, capacity=128), jparams, pad_prompt_to=32)
    want = jsched.run([JRequest(rid=r.rid, tokens=r.tokens, max_new=r.max_new) for r in reqs])
    assert dict(outs) == dict(want)
    assert [len(outs[r.rid]) for r in reqs] == [r.max_new for r in reqs]
    assert sched.steps == jsched.steps


def test_passkey_policies_match_jax_bundles():
    tp = _load("passkey_demo_torch")
    jcfg, cfg = bench_common.bench_model_cfg(), tp.bench_model_cfg()
    assert (jcfg.n_layers, jcfg.d_model, jcfg.d_head, jcfg.vocab) == (
        cfg.n_layers, cfg.d_model, cfg.d_head, cfg.vocab)
    jparams, params = _params(j_build_model(jcfg), cfg)
    batch, _ = tp.make_passkey_batch(cfg, 4, tp.SEQ, seed=7, step=0, depth=0.3, device="cpu")
    prompt = batch["tokens"][:, : tp.SEQ - tp.N_DIGITS]
    jprompt = jnp.asarray(prompt.numpy())
    digits = {}
    for kind in tp.POLICIES:
        got = tp.answer(tp.policy_bundle(cfg, kind, "cpu"), params, prompt)
        digits[kind] = got
        jb = bench_common.policy_bundle(jcfg, kind, tp.BUDGET)
        pre = {"tokens": jprompt, "lengths": jnp.full((4,), jprompt.shape[1], jnp.int32)}
        logits, cache = jax.jit(lambda p, b: jb.prefill(p, b, capacity=tp.CAPACITY))(
            jparams, pre)
        decode = jax.jit(jb.decode_step)
        want = []
        for _ in range(tp.N_DIGITS):
            tok = jnp.argmax(logits[:, :10], axis=-1).astype(jnp.int32)
            want.append(np.asarray(tok))
            logits, cache = decode(jparams, tok, cache)
        np.testing.assert_array_equal(got.numpy(), np.stack(want, 1), err_msg=kind)
    # the comparison tells the policies apart: each reduced cache decodes
    # other digits than Full-KV's somewhere (the first digit, from the full
    # prefill, is every policy's)
    for kind in tp.POLICIES[1:]:
        assert not torch.equal(digits[kind], digits["full"]), kind
        assert torch.equal(digits[kind][:, 0], digits["full"][:, 0]), kind


def test_train_tiny_lm_command_recovers(tmp_path):
    tt = _load("train_tiny_lm_torch")
    cmd = tt.command("cpu", str(tmp_path / "ckpt"), steps=6, fail_at=(3,), ckpt_every=2,
                     log_every=1)
    assert cmd[:4] == ["--arch", "olmo-1b", "--reduced", "--steps"]
    res = tt.run(cmd)
    assert res["done"] and res["restarts"] == 1 and res["resumed_from"] == [2]
    assert np.isfinite(res["first_loss"]) and np.isfinite(res["last_loss"])
    before, after = tt.held_losses("cpu", str(tmp_path / "ckpt"))
    assert np.isfinite(before) and np.isfinite(after) and after < before


@pytest.mark.parametrize("name", ["quickstart_torch", "serve_longcontext_torch",
                                  "passkey_demo_torch", "train_tiny_lm_torch"])
def test_examples_import_no_jax(name):
    """The port's examples import ``torch`` and ``repro_torch`` only."""
    src = open(os.path.join(REPO, "examples", f"{name}.py")).read()
    imports = [ln.split()[1] for ln in src.splitlines()
               if ln.startswith(("import ", "from "))]
    assert not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
                   for m in imports), imports
    assert "--device" in src
    if name != "train_tiny_lm_torch":  # the train CLI seeds its own generator
        assert "torch.Generator" in src
