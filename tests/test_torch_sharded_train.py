"""Port parity of training over a device mesh (``launch/sharding.py``,
``core/placement.py``, ``models/sharded_train.py``, ``moe.moe_apply_ep``,
``compressed_psum``, ``CheckpointManager.restore(sharding=)``,
``runtime/elastic.py``, ``train --model-axis``), on the CPU in one process:
every shard of a mesh sits on ``cpu``.

* ``param_pspec`` equals the reference's for every (path, rank) of every
  arch's full parameter tree (``jax.eval_shape``), and each spec divides
  its leaf on both production mesh shapes (port meshes of 256 / 512 CPU
  shards).  The port's param trees have the reference's ``_path_str`` set
  for every arch at ``reduced_config``.
* ``compressed_psum`` against the reference's under ``jax.vmap(...,
  axis_name="data")`` over 2 and 4 shards: within 1e-6 of max|out| (f32
  summation order).
* ``moe_apply_ep`` against the reference's on a (2, 2) mesh — 4 CPU
  devices, so the reference runs once, in one subprocess, for every value
  here — at the reduced config's capacity factor (tokens drop) with
  FSDP-stored experts: y within 2e-4, aux within 1e-5, the gradients of a
  scalar of y within 1e-4 of each one's max|g| (f32).
* The sharded train step (f32 compute, 2 steps, AdamW at lr 1e-2) of
  reduced olmo and reduced granite-moe on dp2, tp2 and (2, 2), and of
  mamba2 and whisper on dp2, against the reference's one-device
  ``make_train_step`` on the same weights (``train_state_from_jax``):
  every step's loss and grad norm within 1e-5 relative; after the first
  step AdamW's moments within 1e-5 of their leaf's largest magnitude (at
  least 1e-2 of the tree's largest: a key bias has a zero gradient in exact
  arithmetic, a softmax ignoring a shift of every score, so f32 noise) and
  the params within 2e-5 of the largest wherever the reference's first
  moment is ≥ 1e-7; after every step every param within the steps' bound,
  2·lr per step (AdamW's first step moves an element by about lr·sign(g),
  and a near-zero gradient's sign may flip on f32 summation order; the
  second step's gradient then differs through those params).  After the
  second step — AdamW with non-zero moments — the params within 1e-3 of
  the leaf's largest wherever the reference's first moment was ≥ 1e-7 at
  both steps (read ≤ 2.7e-4: the first step's flipped elements, 2·lr off,
  move the second step's gradients).  Against the
  port's own one-device step: loss and grad norm within 3e-6 relative.
  granite on (2, 2) runs EP with 2 token shards: its capacity is raised to
  8.0 (nothing drops, so y is the one-device y) but its aux is the pmean of
  the shards' estimates — another estimator than the reference's global
  one (within 10% of it: 64 tokens a shard read 6.7%; the reference's own
  EP test allows 5% at 64 tokens in all), and within 1e-6 of the estimator
  recomputed from the same routing — so the router's gradient
  differs by 0.01·∇Δaux: loss within 1e-4, grad norm within 5e-3, params
  within the 2·lr bound.
* Each shard holds exactly ``tree_bytes / n`` of every leaf split n ways.
* Checkpoints cross packages both ways (a sharded port save read by the
  reference's manager; a reference checkpoint restored onto a mesh), and
  ``reshard_tree`` moves a state between meshes, bit for bit.
* ``train --model-axis 2 --device cpu --fail-at 3`` resumes onto the mesh
  and ends on the uninterrupted run's loss, bit for bit.
"""
import _torch_threads
import dataclasses
import json
import math
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.compat import abstract_mesh
from repro.configs import ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import make_train_batch as j_make_train_batch
from repro.launch import sharding as jshard
from repro.launch.steps import TrainHParams as JHParams
from repro.launch.steps import init_train_state as j_init_train_state
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import build_model as j_build_model
from repro.optim.grad_compress import compressed_psum as j_compressed_psum
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.convert import train_state_from_jax
from repro_torch.core import placement as pl
from repro_torch.launch import sharding as shard
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import Mesh, batch_axes, make_mesh
from repro_torch.launch.steps import TrainHParams, make_train_step
from repro_torch.models import build_model, moe
from repro_torch.models.attention import DistConfig
from repro_torch.optim import compressed_psum
from repro_torch.optim.tree import leaves
from repro_torch.runtime import replicated, reshard_tree

from conftest import run_in_subprocess
from test_torch_train import torch_batch

MESHES = {"dp2": ((2,), ("data",)), "tp2": ((2,), ("model",)),
          "2x2": ((2, 2), ("data", "model"))}
STEPS, LR = 2, 1e-2
REL = 1e-5          # metrics and first-step moments against the reference
PARAM_REL = 2e-5    # first-step params where |mu| >= 1e-7, × max|p| (mamba2 reads 8.1e-6)
LATER_PARAM_REL = 1e-3  # second-step params where every step's |mu| >= 1e-7 (read ≤ 2.7e-4)
MOMENT_FLOOR = 1e-2  # a moment leaf's scale: at least this × the tree's largest
SELF_REL = 3e-6     # loss and grad norm against the port's one-device step (read ≤ 1.2e-6)
EP_LOSS_REL, EP_GN_REL = 1e-4, 5e-3  # granite (2, 2) EP: read 5.2e-5 and 2.3e-3
EP_AUX_REL = 0.1  # its aux, another estimator than the global one: read 0.067


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, device="cpu")


def _norm_spec(spec):
    """A partition spec as a tuple of (names tuple | None)."""
    return tuple(None if d is None else ((d,) if isinstance(d, str) else tuple(d))
                 for d in spec)


# ------------------------------------------------------------- param specs

@pytest.fixture(scope="module")
def full_shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            bundle = j_build_model(j_get_config(arch), max_positions=64)
            shapes = jax.eval_shape(bundle.init, jax.random.key(0))
            cache[arch] = [(jshard._path_str(p), tuple(leaf.shape))
                           for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")),
                                        ((2, 16, 16), ("pod", "data", "model"))],
                         ids=["1pod", "2pod"])
def test_param_pspec_matches_reference(arch, shape, axes, full_shapes):
    """Every (path, rank) of the full tree: the port's spec is the
    reference's, and it divides the leaf on the production mesh shape."""
    mesh = Mesh(shape, axes, ["cpu"] * math.prod(shape))
    fsdp = ("data",)
    flat = full_shapes(arch)
    assert flat
    for path, shp in flat:
        spec = shard.param_pspec(path, len(shp), fsdp)
        assert _norm_spec(spec) == _norm_spec(jshard.param_pspec(path, len(shp), fsdp)), path
        pl.NamedSharding(mesh, spec).grid(shp)  # raises unless it divides


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_paths_match_reference(arch):
    """The port's param tree at ``reduced_config`` has the reference's
    ``_path_str`` set, and ``param_shardings`` gives each path the
    reference's spec on a (2, 2) mesh."""
    jcfg = j_reduced_config(arch)
    jb = j_build_model(jcfg, max_positions=64)
    jshapes = jax.eval_shape(jb.init, jax.random.key(0))
    jflat = {jshard._path_str(p): leaf.shape
             for p, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    params = build_model(reduced_config(arch), device="cpu", max_positions=64).init(0)
    tflat = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            walk(v, path + (k,)) if isinstance(v, dict) else tflat.setdefault(
                shard._path_str(path + (k,)), tuple(v.shape))

    walk(params)
    assert tflat == {k: tuple(v) for k, v in jflat.items()}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    sh = shard.param_shardings(params, mesh, ("data",))
    jsh = jshard.param_shardings(jshapes, abstract_mesh((2, 2), ("data", "model")), ("data",))
    jspecs = {jshard._path_str(p): s.spec for p, s in jax.tree_util.tree_flatten_with_path(jsh)[0]}

    def check(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                check(v, path + (k,))
            else:
                assert _norm_spec(v.spec) == _norm_spec(jspecs[shard._path_str(path + (k,))])

    check(sh)


# --------------------------------------------------------- compressed_psum

@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_matches_reference(n):
    """The 1-bit all-reduce over n shards, against the reference's body
    under ``jax.vmap(..., axis_name="data")``: every shard's result within
    1e-6 of max|out|, and each shard gets the same tensor."""
    x = np.random.default_rng(n).standard_normal((n, 5, 7)).astype(np.float32)
    x[0, 0, 0] = 0.0  # sign of zero: +1, as the reference's (x >= 0)
    ref = np.asarray(jax.vmap(lambda v: j_compressed_psum(v, "data"), axis_name="data")(x))
    got = compressed_psum([torch.from_numpy(v) for v in x])
    for r, g in zip(ref, got):
        assert g.shape == (5, 7) and g.dtype == torch.float32
        assert float(np.abs(r - g.numpy()).max()) <= 1e-6 * float(np.abs(ref).max())
    assert all(torch.equal(got[0], g) for g in got[1:])


# ------------------------------------------------------------------ EP MoE

EP_T = 64


def _ep_inputs():
    cfg = reduced_config("granite-moe-1b-a400m")
    rng = np.random.default_rng(5)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * d**-0.5,
         "w1": rng.standard_normal((E, d, ff)).astype(np.float32) * d**-0.5,
         "w3": rng.standard_normal((E, d, ff)).astype(np.float32) * d**-0.5,
         "w2": rng.standard_normal((E, ff, d)).astype(np.float32) * ff**-0.5}
    x = rng.standard_normal((EP_T, d)).astype(np.float32)
    w = rng.standard_normal((EP_T, d)).astype(np.float32)
    # a router leaning on expert 0, so its bucket overflows at capacity 1.25
    x += 0.5 * p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
    p["router"][:, 0] *= 3.0
    return cfg, p, x, w


@pytest.fixture(scope="module")
def ep_reference(tmp_path_factory):
    """The reference's ``moe_apply_ep`` on a (2, 2) mesh of 4 CPU devices
    with FSDP-stored experts, at the reduced config's capacity factor: y,
    aux and the gradients of sum(y·w) + 0.01·aux, in one subprocess."""
    out = tmp_path_factory.mktemp("ep") / "ref.npz"
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {tests_dir!r})
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.configs import reduced_config
        from repro.models import moe as moe_mod
        from test_torch_sharded_train import _ep_inputs
        _, p, x, w = _ep_inputs()
        cfg = reduced_config("granite-moe-1b-a400m")
        mesh = jax.make_mesh((2, 2), ("data", "model"))
        sh = {{"router": P(), "w1": P("model", "data", None), "w3": P("model", "data", None),
              "w2": P("model", None, "data")}}
        p = {{k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, sh[k])) for k, v in p.items()}}
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None)))
        def f(p, x):
            return moe_mod.moe_apply_ep(x, p, cfg, mesh=mesh, token_axes=("data",),
                                        model_axis="model", fsdp_axes=("data",))
        y, aux = jax.jit(f)(p, xs)
        def loss(p, x):
            y, aux = f(p, x)
            return jnp.sum(y * jnp.asarray(w)) + 0.01 * aux
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, xs)
        np.savez({str(out)!r}, y=np.asarray(y), aux=np.asarray(aux), gx=np.asarray(gx),
                 **{{"g_" + k: np.asarray(v) for k, v in gp.items()}})
    """)
    with _torch_threads.subprocess_threads():
        run_in_subprocess(code, n_devices=4)
    return dict(np.load(out))


def test_moe_apply_ep_matches_reference(ep_reference):
    """EP on a (2, 2) CPU mesh, experts placed FSDP-stored as the reference
    places them, at capacity factor 1.25 (tokens drop: asserted): y, aux
    and the gradients of sum(y·w) + 0.01·aux as the reference's."""
    cfg, p, x, w = _ep_inputs()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    specs = {"router": pl.P(), "w1": pl.P("model", "data", None),
             "w3": pl.P("model", "data", None), "w2": pl.P("model", None, "data")}
    tp = {k: pl.place(torch.from_numpy(v), pl.NamedSharding(mesh, specs[k]))
          for k, v in p.items()}
    assert all(len(tp[k].pieces) == 4 for k in ("w1", "w3", "w2"))
    tracked = {k: v.map_pieces(lambda a: a.detach().requires_grad_()) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply_ep(xt, tracked, cfg, mesh=mesh, token_axes=("data",),
                              model_axis="model")
    (torch.sum(y * torch.from_numpy(w)) + 0.01 * aux).backward()
    ref = ep_reference
    assert float(np.abs(y.detach().numpy() - ref["y"]).max()) <= 2e-4
    assert abs(float(aux.detach()) - float(ref["aux"])) <= 1e-5
    # tokens drop at this capacity: some (token, k) slot of a token shard's
    # routing lands past its expert's capacity
    drops = 0
    for xl in torch.from_numpy(x).chunk(2):
        _, eidx, _ = moe._route(xl, {"router": torch.from_numpy(p["router"])}, cfg.topk_experts)
        _, keep = moe.dispatch_slots(eidx, cfg.n_experts, moe.capacity(xl.shape[0], cfg))
        drops += int((~keep).sum())
    assert drops > 0
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    assert rel(xt.grad.numpy(), ref["gx"]) <= 1e-4
    for k, v in tracked.items():
        g = pl.Sharded(v.sharding, v.shape, [q.grad for q in v.pieces]).full()
        assert rel(g.numpy(), ref["g_" + k]) <= 1e-4, k


def test_moe_apply_ep_without_drops_equals_moe_apply():
    """With nothing dropped (capacity 8.0, the reference's test setting), EP
    on tp2 with plain (unsplit) weights gives moe_apply's y within 1e-6 and
    its aux exactly: one token shard sees every token."""
    cfg, p, x, _ = _ep_inputs()
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y, aux = moe.moe_apply(torch.from_numpy(x), tp, cfg)
    ye, auxe = moe.moe_apply_ep(torch.from_numpy(x), tp, cfg,
                                mesh=make_mesh((2,), ("model",), device="cpu"),
                                token_axes=("data",), model_axis="model")
    assert float((y - ye).abs().max()) <= 1e-6 and float(aux) == float(auxe)


# ------------------------------------------------------- the train step

_REF = {}  # arch -> the reference's run
_ONE = {}  # arch -> the port's one-device metrics


def _cfgs(arch):
    jcfg = dataclasses.replace(j_reduced_config(arch), compute_dtype="float32")
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32")
    if jcfg.family == "moe":
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return jcfg, cfg


def _hp(cls):
    return cls(peak_lr=LR, warmup=0, total_steps=10)


def _batches(jcfg):
    shape = JShapeConfig("t", 32 if jcfg.family != "encdec" else 16, 4, "train")
    return [j_make_train_batch(jcfg, shape, s, seed=0) for s in range(STEPS)]


def _reference(arch):
    """The reference's one-device ``make_train_step`` for STEPS steps: (its
    initial state, the states after each step, the metrics)."""
    if arch not in _REF:
        jcfg, _ = _cfgs(arch)
        max_pos = 64 if jcfg.family == "encdec" else None
        jb = j_build_model(jcfg, max_positions=max_pos)
        st = j_init_train_state(jb, jax.random.PRNGKey(0), _hp(JHParams))
        step = jax.jit(j_make_train_step(jb, _hp(JHParams)))
        states, ms = [st], []
        for b in _batches(jcfg):
            st, m = step(st, b)
            states.append(jax.tree.map(np.asarray, st))
            ms.append({k: float(v) for k, v in m.items()})
        _REF[arch] = (jax.tree.map(np.asarray, states[0]), states[1:], ms)
    return _REF[arch]


def _port_run(arch, mesh_name):
    """The port's STEPS steps from the reference's initial state: on one
    device (mesh_name None) or placed on the mesh.  Returns (the state
    after each step, as logical tensors; the metrics; the last placed
    state)."""
    jcfg, cfg = _cfgs(arch)
    init, _, _ = _reference(arch)
    max_pos = 64 if cfg.family == "encdec" else None
    state = train_state_from_jax(init, cfg, device="cpu", max_positions=max_pos)
    dcfg = None
    if mesh_name is not None:
        mesh = _mesh(mesh_name)
        ep = "model" if cfg.family == "moe" and mesh.shape.get("model", 1) > 1 else None
        dcfg = DistConfig(mesh=mesh, batch_axes=batch_axes(mesh), ep_axis=ep)
        psh = shard.param_shardings(state["params"], mesh, ("data",))
        state = pl.place_tree(state, {"params": psh,
                                         "opt": shard.opt_shardings(state["opt"], psh, mesh)})
    bundle = build_model(cfg, None, dcfg, device="cpu", max_positions=max_pos)
    step = make_train_step(bundle, _hp(TrainHParams))
    out, ms = [], []
    for b in _batches(jcfg):
        state, m = step(state, torch_batch(b))
        out.append(pl.gather_tree(state))
        ms.append({k: float(v) for k, v in m.items()})
    return out, ms, state


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


CASES = [("olmo-1b", "dp2"), ("olmo-1b", "tp2"), ("olmo-1b", "2x2"),
         ("granite-moe-1b-a400m", "dp2"), ("granite-moe-1b-a400m", "tp2"),
         ("granite-moe-1b-a400m", "2x2"), ("mamba2-370m", "dp2"), ("whisper-small", "dp2")]


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_sharded_train_step_matches_reference(arch, mesh_name):
    """STEPS steps on the mesh against the reference's one-device step and
    the port's own (tolerances in the module docstring)."""
    _, jstates, jms = _reference(arch)
    got, ms, placed = _port_run(arch, mesh_name)
    if arch not in _ONE:
        _ONE[arch] = _port_run(arch, None)[1]
    one_ms = _ONE[arch]
    ep_dp = arch.startswith("granite") and mesh_name == "2x2"
    loss_tol, gn_tol = (EP_LOSS_REL, EP_GN_REL) if ep_dp else (REL, REL)
    for s in range(STEPS):
        for k, tol in (("loss", loss_tol), ("grad_norm", gn_tol), ("lr", REL), ("tokens", 0)):
            assert abs(ms[s][k] - jms[s][k]) <= tol * max(abs(jms[s][k]), 1.0), (s, k)
        if ep_dp:  # the per-shard estimator (module docstring)
            assert abs(ms[s]["moe_aux"] - jms[s]["moe_aux"]) <= EP_AUX_REL * jms[s]["moe_aux"]
            continue
        assert abs(ms[s]["moe_aux"] - jms[s]["moe_aux"]) <= REL * max(jms[s]["moe_aux"], 1.0)
        for k in ("loss", "grad_norm"):
            assert abs(ms[s][k] - one_ms[s][k]) <= SELF_REL * abs(one_ms[s][k]), (s, k)
    for s, (st, jst) in enumerate(zip(got, jstates)):
        assert int(st["opt"].step) == s + 1
        for a, b in zip(leaves(st["params"]), jax.tree.leaves(jst["params"])):
            assert np.abs(a.numpy() - b).max() <= 2 * LR * (s + 1)
    if not ep_dp:  # the moments after the first step; the params where they are clearly non-zero
        first, jfirst = got[0], jstates[0]
        for name in ("mu", "nu"):
            ref = jax.tree.leaves(getattr(jfirst["opt"], name))
            floor = MOMENT_FLOOR * max(np.abs(b).max() for b in ref)
            for a, b in zip(leaves(getattr(first["opt"], name)), ref):
                assert np.abs(a.numpy() - b).max() <= REL * max(np.abs(b).max(), floor), name
        # the params where every step so far had a clearly non-zero moment
        masks = [np.abs(mu) >= 1e-7 for mu in jax.tree.leaves(jfirst["opt"].mu)]
        for s, (st, jst) in enumerate(zip(got, jstates)):
            if s:
                masks = [m & (np.abs(mu) >= 1e-7)
                         for m, mu in zip(masks, jax.tree.leaves(jst["opt"].mu))]
            tol = PARAM_REL if s == 0 else LATER_PARAM_REL
            for a, b, m in zip(leaves(st["params"]), jax.tree.leaves(jst["params"]), masks):
                diff = np.abs(a.numpy() - b)[m]
                assert diff.max(initial=0) <= tol * np.abs(b).max(), s
    # each shard holds exactly tree_bytes / n of a leaf split n ways
    for x in leaves(placed["params"]):
        if isinstance(x, pl.Sharded):
            n = len(x.pieces)
            assert pl.shard_bytes(x) == [shard.tree_bytes(x) // n] * n


def test_ep_aux_is_the_per_shard_estimator():
    """granite-moe on (2, 2) with EP: the first step's moe_aux is the mean
    over the layers of the pmean of each token shard's Switch estimate,
    recomputed here from the same routing (one-device forward of the same
    weights, split per token shard), within 1e-6."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    init, _, _ = _reference("granite-moe-1b-a400m")
    params = train_state_from_jax(init, cfg, device="cpu")["params"]
    batch = torch_batch(_batches(jcfg)[0])
    _, ms, _ = _port_run("granite-moe-1b-a400m", "2x2")
    # the per-shard estimate of each layer from the one-device activations
    bundle = build_model(cfg, device="cpu", remat=False)
    seen = []
    orig = moe.moe_apply

    def spy(x, p, c):
        halves = x.reshape(4, -1, x.shape[-1]).chunk(2)
        est = [moe._aux(*moe._route(h.reshape(-1, x.shape[-1]), p, c.topk_experts)[:2],
                        c.n_experts, c.topk_experts) for h in halves]
        seen.append(torch.stack(est).mean())
        return orig(x, p, c)

    moe.moe_apply = spy
    try:
        with torch.no_grad():
            bundle.train_loss(params, batch)
    finally:
        moe.moe_apply = orig
    assert abs(ms[0]["moe_aux"] - float(torch.stack(seen).mean())) <= 1e-6


# ------------------------------------------------- checkpoints and elastic

def test_checkpoints_cross_packages_on_a_mesh(tmp_path):
    """A (2, 2)-sharded port state saved by the port's manager restores
    through the reference's, leaf for leaf; a reference checkpoint restores
    onto the mesh through ``restore(sharding=)``; ``reshard_tree`` moves the
    state from (2, 2) to dp2 and back to one replicated copy — all bit for
    bit."""
    jcfg, cfg = _cfgs("olmo-1b")
    init, jstates, _ = _reference("olmo-1b")
    _, _, placed = _port_run("olmo-1b", "2x2")
    logical = pl.gather_tree(placed)
    CheckpointManager(str(tmp_path / "port")).save(2, placed)
    jlike = jax.tree.map(jnp.asarray, jstates[-1])
    back = JCheckpointManager(str(tmp_path / "port")).restore(2, jlike)
    for a, b in zip(leaves(logical), jax.tree.leaves(back)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    JCheckpointManager(str(tmp_path / "ref")).save(5, jlike)
    mesh = _mesh("2x2")
    psh = shard.param_shardings(placed["params"], mesh, ("data",))
    sh = {"params": psh, "opt": shard.opt_shardings(placed["opt"], psh, mesh)}
    restored = CheckpointManager(str(tmp_path / "ref")).restore(5, placed, sharding=sh)
    assert isinstance(restored["params"]["layers"]["attn"]["wq"], pl.Sharded)
    for a, b in zip(leaves(pl.gather_tree(restored)), jax.tree.leaves(jstates[-1])):
        assert np.array_equal(a.numpy(), np.asarray(b))
    dp2 = _mesh("dp2")
    psh2 = shard.param_shardings(placed["params"], dp2, ("data",))
    moved = reshard_tree(placed, {"params": psh2,
                                  "opt": shard.opt_shardings(placed["opt"], psh2, dp2)})
    wq = moved["params"]["layers"]["attn"]["wq"]
    assert wq.mesh is dp2 and len(wq.pieces) == 2
    one = reshard_tree(moved, replicated(dp2))
    for a, b, c in zip(leaves(logical), leaves(pl.gather_tree(moved)), leaves(one)):
        assert torch.equal(a, b)
        assert torch.equal(a, c.full() if isinstance(c, pl.Sharded) else c)


def test_train_cli_model_axis_resumes_onto_the_mesh(tmp_path, capsys):
    """``train --model-axis 2 --device cpu``: a fault at step 3 restarts
    from the step-2 checkpoint onto the mesh (``on_restore``), and the last
    loss equals the uninterrupted mesh run's bit for bit."""
    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--model-axis", "2",
            "--steps", "6", "--batch", "4", "--seq", "32", "--ckpt-every", "2",
            "--log-every", "1"]
    runs = []
    for extra, d in ((["--fail-at", "3"], "a"), ([], "b")):
        train_cli.main(argv + extra + ["--ckpt-dir", str(tmp_path / d)])
        runs.append([json.loads(x) for x in capsys.readouterr().out.splitlines()])
    done = runs[0][-1]
    assert done["restarts"] == 1 and done["resumed_from"] == [2]
    assert [x["step"] for x in runs[0][:-1]] == [0, 1, 2, 2, 3, 4, 5]
    assert runs[0][-2]["loss"] == runs[1][-2]["loss"] and runs[0][-2]["step"] == 5
