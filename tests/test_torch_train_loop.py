"""Port parity of the training loop: ``make_train_step`` (AdamW, the cosine
schedule, gradient accumulation) against the JAX package's, and the
reference's own system recipe (``tests/test_system.py``: train a small
model, then serve it through FIER, quest and slm) run by the port on the
CPU, where every kernel wrapper runs its plain version.

Tolerances: the moments and metrics after one step (f32 compute) within
1e-5 of their largest magnitude, and so the parameters wherever the
reference's gradient is at least 1e-6 in magnitude.  Below that, AdamW's
first step g/(|g| + 1e-8) turns the f32 rounding noise of a near-zero
gradient (~1e-9) into a visible change of the step; there a parameter
need only lie within the step's bound, 2·lr, of the reference's.  Per-step losses of five steps of reduced olmo-1b (bf16
compute, the config's default) within 2e-3 absolute of the reference's
(measured up to 1.5e-4: a loss of about 6.8 computed from bf16 activations,
which XLA's and torch's CPU matmuls round differently in a few elements).
"""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import make_train_batch as j_make_train_batch
from repro.launch.steps import TrainHParams as JHParams
from repro.launch.steps import init_train_state as j_init_train_state
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.core.policy import PolicyConfig
from repro_torch.data.pipeline import lm_tokens, make_train_batch
from repro_torch.launch.steps import TrainHParams, init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.optim.tree import leaves

from test_torch_train import torch_batch


def _max_rel(j_tree, t_tree) -> float:
    js = jax.tree.leaves(j_tree)
    ts = leaves(t_tree)
    assert len(js) == len(ts)
    return max(float(np.abs(np.asarray(a, np.float32) - b.to(torch.float32).numpy()).max()
                     / max(np.abs(np.asarray(a, np.float32)).max(), 1e-30)) for a, b in zip(js, ts))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """One ``make_train_step`` step (clip, cosine lr, AdamW; 1 or 2
    microbatches) from the reference's state on its batch: params, moments
    and metrics as the reference's."""
    jcfg = dataclasses.replace(j_reduced_config("olmo-1b"), compute_dtype="float32")
    cfg = dataclasses.replace(reduced_config("olmo-1b"), compute_dtype="float32")
    kw = dict(peak_lr=1e-2, warmup=0, total_steps=10, microbatches=microbatches)
    jb = j_build_model(jcfg)
    jstate = j_init_train_state(jb, jax.random.PRNGKey(0), JHParams(**kw))
    batch = j_make_train_batch(jcfg, ShapeConfig("t", 32, 4, "train"), 0, seed=0)
    jstate2, jm = jax.jit(j_make_train_step(jb, JHParams(**kw)))(jstate, batch)

    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    state2, m = make_train_step(build_model(cfg, device="cpu"), TrainHParams(**kw))(
        state, torch_batch(batch))
    assert _max_rel(jstate2["opt"].mu, state2["opt"].mu) <= 1e-5
    assert _max_rel(jstate2["opt"].nu, state2["opt"].nu) <= 1e-5
    assert int(state2["opt"].step) == int(jstate2["opt"].step) == 1
    for k in ("loss", "grad_norm", "lr", "tokens"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1.0), k
    for jp, tp, jmu in zip(jax.tree.leaves(jstate2["params"]), leaves(state2["params"]),
                           jax.tree.leaves(jstate2["opt"].mu)):
        ref, diff = np.asarray(jp), np.abs(np.asarray(jp) - tp.numpy())
        stable = np.abs(np.asarray(jmu)) >= 1e-7  # mu = 0.1·(clipped g) after one step
        assert diff[stable].max(initial=0) <= 1e-5 * np.abs(ref).max()
        assert diff.max() <= 2 * kw["peak_lr"]


def test_microbatches_equal_one_batch():
    """Two microbatches of equal token counts give the one-batch step's
    gradient (the mean of two means is the mean), up to f32 summation
    order: the first moments, loss and gradient norm agree."""
    cfg = dataclasses.replace(reduced_config("olmo-1b"), compute_dtype="float32")
    bundle = build_model(cfg, device="cpu")
    batch = make_train_batch(cfg, TShapeConfig("t", 32, 4, "train"), 0, device="cpu")
    out = []
    for n in (1, 2):
        hp = TrainHParams(peak_lr=1e-2, warmup=0, total_steps=10, microbatches=n)
        state = init_train_state(bundle, torch.Generator().manual_seed(0), hp)
        out.append(make_train_step(bundle, hp)(state, batch))
    (s1, m1), (s2, m2) = out
    for a, b in zip(leaves(s1["opt"].mu), leaves(s2["opt"].mu)):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    for k in ("loss", "grad_norm"):
        assert abs(float(m1[k]) - float(m2[k])) <= 1e-5 * float(m1[k]), k


def test_five_steps_track_reference():
    """Five steps of reduced olmo-1b (bf16 compute) from one shared init on
    the reference's batches: every step's loss within 2e-3 of the
    reference's."""
    jcfg, cfg = j_reduced_config("olmo-1b"), reduced_config("olmo-1b")
    kw = dict(peak_lr=3e-3, warmup=1, total_steps=5)
    jb = j_build_model(jcfg)
    jstate = j_init_train_state(jb, jax.random.PRNGKey(0), JHParams(**kw))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    jstep = jax.jit(j_make_train_step(jb, JHParams(**kw)))
    step = make_train_step(build_model(cfg, device="cpu"), TrainHParams(**kw))
    gaps = []
    for s in range(5):
        batch = j_make_train_batch(jcfg, ShapeConfig("t", 32, 4, "train"), s, seed=0)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, torch_batch(batch))
        gaps.append(abs(float(m["loss"]) - float(jm["loss"])))
    assert max(gaps) <= 2e-3, gaps


# ------------------------------------------------- the reference's system test

@pytest.fixture(scope="module")
def trained():
    """tests/test_system.py's model and recipe (3 layers, d 96, 4 heads of
    24, vocab 256; 150 steps, lr 2e-3, warmup 10, B 8 x S 128, data seed
    11), trained by the port from its own seeded init on its own pipeline."""
    cfg = dataclasses.replace(
        reduced_config("olmo-1b"), n_layers=3, d_model=96, n_heads=4,
        n_kv_heads=4, d_head=24, d_ff=192, vocab=256,
    )
    bundle = build_model(cfg, device="cpu")
    hp = TrainHParams(peak_lr=2e-3, warmup=10, total_steps=150)
    state = init_train_state(bundle, torch.Generator().manual_seed(0), hp)
    step = make_train_step(bundle, hp)
    shape = TShapeConfig("sys", 128, 8, "train")
    losses = []
    for s in range(150):
        state, m = step(state, make_train_batch(cfg, shape, s, seed=11, device="cpu"))
        losses.append(float(m["loss"]))
    return cfg, state["params"], losses


def greedy(bundle, params, prompt, n=16):
    B, S = prompt.shape
    logits, cache = bundle.prefill(params, {"tokens": prompt, "lengths": torch.full(
        (B,), S, dtype=torch.int32)}, capacity=S + n + 8)
    toks = []
    tok = logits.argmax(-1).to(torch.int32)
    for _ in range(n):
        toks.append(tok)
        logits, cache = bundle.decode_step(params, tok, cache)
        tok = logits.argmax(-1).to(torch.int32)
    return torch.stack(toks, 1)


def teacher_forced_nll(cfg, params, toks, pol):
    """Mean NLL of the 24 gold tokens after a 128-token prefill."""
    bundle = build_model(cfg, pol, device="cpu")
    logits, cache = bundle.prefill(params, {"tokens": toks[:, :128], "lengths": torch.full(
        (4,), 128, dtype=torch.int32)}, capacity=160)
    tot = 0.0
    for t in range(24):
        gold = toks[:, 128 + t]
        lp = torch.log_softmax(logits, -1)
        tot += float(-lp.gather(1, gold[:, None].to(torch.int64)).mean())
        logits, cache = bundle.decode_step(params, gold, cache)
    return tot / 24


@torch.no_grad()
def test_system_recipe_on_the_port(trained):
    """The gates of tests/test_system.py: training learns (last loss below
    0.7 x the first); FIER at budget >= length reproduces full-KV's greedy
    tokens exactly; at budget 24 / group 8 / skip 1 FIER agrees with full
    more than quest and slm do, and at least 0.4; FIER's teacher-forced NLL
    gap to full stays below half of slm's, plus 0.05."""
    cfg, params, losses = trained
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])
    prompt = lm_tokens(11, 999, 4, 96, cfg.vocab)[:, :96]
    full = greedy(build_model(cfg, PolicyConfig(kind="full"), device="cpu"), params, prompt)

    def agree(pol):
        return float((full == greedy(build_model(cfg, pol, device="cpu"), params, prompt))
                     .to(torch.float32).mean())

    assert agree(PolicyConfig(kind="fier", budget=112, group=8, skip_layers=1)) == 1.0
    a_fier = agree(PolicyConfig(kind="fier", budget=24, group=8, skip_layers=1))
    a_quest = agree(PolicyConfig(kind="quest", budget=24, page=8, skip_layers=1))
    a_slm = agree(PolicyConfig(kind="slm", budget=24, skip_layers=1))
    assert a_fier > a_quest and a_fier > a_slm and a_fier >= 0.4, (a_fier, a_quest, a_slm)

    toks = lm_tokens(11, 500, 4, 160, cfg.vocab)
    nll = {kind: teacher_forced_nll(cfg, params, toks, None if kind == "full" else PolicyConfig(
        kind=kind, budget=24, group=8, page=8, skip_layers=1)) for kind in ("full", "fier", "slm")}
    assert nll["fier"] - nll["full"] < 0.5 * max(nll["slm"] - nll["full"], 1e-9) + 0.05, nll
