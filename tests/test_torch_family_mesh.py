"""The ssm, hybrid and encdec families served on a mesh, on the CPU (every
shard on ``cpu``): ``build_model(cfg, pol, DistConfig(mesh, seq_axes=
("model",), batch_axes=("data",), mode="exact"))`` decoding a cache placed
by ``launch.sharding.cache_shardings``.

* mamba2-370m, zamba2-7b (5 layers: two application points of the shared
  block and one tail layer) and whisper-small (4 decoder layers, skip 1) at
  reduced width, on (1, 4) and (2, 2) ``data`` × ``model`` meshes, from
  one one-device prefill: STEPS decode steps teacher-forced with the
  one-device bundle's tokens, against that bundle's steps.  mamba2's
  logits equal them bit for bit (its state steps row by row).  The
  hybrid's and whisper's FIER layers (exact mode) attend, in every layer
  and step (``kernels.check.ShardedSelections``; the budget is half the
  capacity, so each sequence shard nominates all its positions), the plain
  top-k of the same scores on the joined side-car up to scores within
  EPS_TIE of its τ, and K1's index set on the same query and side-car up to
  scores within 2δ + EPS_TIE of K1's τ (δ: the largest gap between the two
  score expressions); their logits lie within LOGIT_TOL · max|logit|.  After the steps the
  lengths equal the one-device cache's, the Mamba2 states bit for bit
  where their inputs are (mamba2's; the hybrid's before its first
  attention), and every K/V row is written where one device writes it,
  the first attention layer's bit for bit.  Every slab, state and cross K/V piece has a
  storage of its own, and on (2, 2) a planted fault (each batch shard
  stepping the next shard's state rows, or attending the next shard's
  cross K/V) reads beyond the gate.  A planted selection fault (each
  sequence shard selecting from the next shard's scores) reads outside
  both selection bands.
* On fake devices the same decode cell copies no storage of a slab, state
  or cross K/V piece to another device.
* The eight serving cells of these families that the dry run refused
  before (whisper-small ``prefill_32k`` / ``decode_32k``; mamba2-370m and
  zamba2-7b ``prefill_32k`` / ``decode_32k`` / ``long_500k``) build and
  trace at cost depth 1 on a (2, 2) fake mesh with the reduced configs.
"""
import dataclasses
import pickle
import textwrap

import _torch_threads
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import run_in_subprocess
from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import placement
from repro_torch.core.placement import gather_tree, place_tree
from repro_torch.core.policy import PolicyConfig
from repro_torch.kernels.check import ShardedSelections
from repro_torch.launch import dryrun
from repro_torch.launch.accounting import tree_tensors
from repro_torch.launch.mesh import make_fake_mesh, make_mesh
from repro_torch.launch.sharding import cache_batch_axes, cache_shardings
from repro_torch.launch.specs import build_cell
from repro_torch.models import build_model, encdec, mamba2
from repro_torch.models.attention import DistConfig

from test_torch_dryrun import _Copies, _port_leaves

STEPS = 4
CAPACITY, BUDGET = 64, 32  # exact mode nominates 2·budget/n_shards ≥ S_loc per shard
LENGTHS = (56, 41)
EPS_TIE = 1e-4    # |score − τ| under which two selections may also differ (summation order)
# the sharded steps' logits vs the one-device steps', × max|logit|: test_torch_sharded's
# DENSE_TOL.  The sharded decode's plain attention rounds the softmax weights to
# bf16 as the reference's sparse_attention does, K2 keeps them f32 (ROADMAP,
# Reference caveats); sound readings reach 0.0135 over 4 steps here
LOGIT_TOL = 2e-2
MESHES = [(1, 4), (2, 2)]
# against the reference's sharded decode (each side's own prefill): the
# hybrid's and whisper's slabs, states, cross K/V and side-car scales are a
# few bf16 roundings apart, as each side's bf16 GEMMs sum in another order
# (measured ≤ 0.0129 · max), and so a key component near 0 may take the
# other sign bit (measured 117 of 24576 bits, whisper's); mamba2's SSM state
# is f32 in another summation order (measured 2.7e-7 · max)
CACHE_REL_TOL = 2e-2
CODE_BIT_TOL = 1e-2
F32_REL_TOL = 1e-5
CONFIGS = {
    "mamba2-370m": {},
    "zamba2-7b": {"n_layers": 5},
    "whisper-small": {"n_layers": 4},
}
FORMER_FAILURES = [("whisper-small", "prefill_32k"), ("whisper-small", "decode_32k"),
                   ("mamba2-370m", "prefill_32k"), ("mamba2-370m", "decode_32k"),
                   ("mamba2-370m", "long_500k"), ("zamba2-7b", "prefill_32k"),
                   ("zamba2-7b", "decode_32k"), ("zamba2-7b", "long_500k")]


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), **CONFIGS[arch])


def _inputs(cfg) -> dict:
    """The prompts (and whisper's frames) that every test here prefills."""
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab, (2, CAPACITY)),
           "lengths": np.array(LENGTHS, np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((2, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    return out


def _policy(cfg):
    if cfg.attention_free:
        return None
    return PolicyConfig(kind="fier", budget=BUDGET, group=8, skip_layers=1, pipeline="one_pass")


def _rotated(x):
    """``row_blocks`` with each batch shard handed the next shard's pieces
    (a planted fault)."""
    blocks = placement.row_blocks(x)
    return [(rows, blocks[(i + 1) % len(blocks)][1]) for i, (rows, _) in enumerate(blocks)]


def _decode(bundle, params, tok0, cache, tokens=None):
    """STEPS decode steps from ``cache`` (updated in place), fed ``tokens``
    or, without them, each step's argmax; returns (logits per step, the
    tokens fed)."""
    out, fed, tok = [], [], tok0
    for i in range(STEPS):
        tok = tokens[i] if tokens is not None else tok
        fed.append(tok)
        lg, cache = bundle.decode_step(params, tok, cache)
        out.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    return out, fed


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_family_resident_decode(arch, mesh_shape, monkeypatch):
    cfg, n_b = _cfg(arch), mesh_shape[0]
    pol = _policy(cfg)
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    kw = {"max_positions": cfg.max_target_positions} if cfg.family == "encdec" else {}
    plain = build_model(cfg, pol, device="cpu", **kw)
    sharded = build_model(cfg, pol, DistConfig(mesh=mesh, seq_axes=("model",),
                                               batch_axes=("data",), mode="exact"),
                          device="cpu", **kw)
    params = plain.compute_params(plain.init(0))
    batch = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    lg0, cache = plain.prefill(params, batch, capacity=CAPACITY)
    tok0 = lg0.argmax(-1).to(torch.int32)
    sh = cache_shardings(cache, mesh, ("data",), ("model",),
                         cache_batch_axes(sharded.init_cache, CAPACITY))
    placed = place_tree(cache, sh)
    for path, leaf in _port_leaves(placed):  # a slab's pieces per shard, a state's per data shard
        if path != "length":
            seq = ("model",) in leaf.sharding.dim_axes(leaf.ndim)
            assert len(leaf.pieces) == (mesh.size if seq else n_b), path
            assert len({p.untyped_storage().data_ptr() for p in leaf.pieces}) == len(leaf.pieces)

    sel = ShardedSelections(lambda q4, qk: EPS_TIE)
    one = placement.map_tree(torch.clone, cache)
    lg_one, tokens = _decode(plain, params, tok0, one)
    with sel:
        lg_sh, _ = _decode(sharded, params, tok0, placed, tokens)
    after = gather_tree(placed)
    assert torch.equal(after["length"], one["length"])
    if cfg.family != "encdec":  # the Mamba2 states step row by row: bit for bit where
        # their inputs are (every mamba2 layer; the hybrid's before its first attention)
        key, n = ("layers", cfg.n_layers) if cfg.family == "ssm" else ("mamba", 1)
        for name in ("conv", "ssm"):
            assert torch.equal(after[key][name][:n], one[key][name][:n]), name
    scale = max(float(lg[:, :cfg.vocab].abs().max()) for lg in lg_one)
    gap = max(float((a - b)[:, :cfg.vocab].abs().max()) for a, b in zip(lg_sh, lg_one))
    if cfg.family == "ssm":
        assert gap == 0.0
    else:
        tot = sel.totals()
        assert tot["outside"] == 0 and tot["k1_outside"] == 0, tot
        assert gap <= LOGIT_TOL * scale, (gap, scale)
        stacks = ["attn"] if cfg.family == "hybrid" else ["front", "rest"]
        written = lambda x: (x != 0).any(-1).any(-1)  # [L, B, S]
        for key in stacks:  # each step's K/V row written where one device writes it
            for name in ("k", "v"):
                assert torch.equal(written(after[key][name]), written(one[key][name]))
        first = after[stacks[0]]  # the first attention layer's rows bit for bit
        assert all(torch.equal(first[n][0], one[stacks[0]][n][0]) for n in ("k", "v"))
        sel.calls.clear()  # each sequence shard selecting from the next shard's scores
        sel.fault = True
        with sel:
            sharded.decode_step(params, tok0, place_tree(cache, sh))
        tot = sel.totals()
        assert tot["outside"] > 0 and tot["k1_outside"] > 0, tot

    if n_b > 1:  # each batch shard fed the next shard's state rows or cross K/V
        monkeypatch.setattr(mamba2, "row_blocks", _rotated)
        monkeypatch.setattr(encdec, "row_blocks", _rotated)
        lg_f, _ = sharded.decode_step(params, tok0, place_tree(cache, sh))
        fault = float((lg_f - lg_one[0])[:, :cfg.vocab].abs().max())
        assert fault > (0.0 if cfg.family == "ssm" else LOGIT_TOL * scale), (fault, scale)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_family_decode_moves_no_cache_piece(arch, mesh_shape):
    """On fake devices the decode cell (params, cache and token placed by the
    reference's shardings) copies no storage of a slab, state or cross K/V
    piece; only per-row values cross."""
    cfg = _cfg(arch)
    with FakeTensorMode():
        mesh = make_fake_mesh(mesh_shape, ("data", "model"))
        # capacity 128: the cell's group of 32 leaves 4 scale rows to split 4 ways
        cell = build_cell(arch, ShapeConfig("d", 128, 4, "decode"), mesh, cfg=cfg,
                          budget=BUDGET)
        pieces = {k: v for k, v in cell.args[2].items() if k != "length"}
        keys = {t.untyped_storage()._cdata for t in tree_tensors(pieces)}
        watch = _Copies()
        with watch:
            cell.fn(*cell.args)
    assert watch.sources and not watch.sources & keys


@pytest.mark.parametrize("arch,shape", FORMER_FAILURES)
def test_formerly_refused_cells_trace(arch, shape):
    cfg = reduced_config(arch)
    with FakeTensorMode():
        cell = build_cell(arch, shape, make_fake_mesh((2, 2), ("data", "model")), cfg=cfg,
                          cost_depth=1)
        rec = dryrun.record_of(dryrun.trace(cell))
    assert cell.kind == SHAPES[shape].kind
    assert rec["argument_size_in_bytes"] > 0 and rec["flops"] > 0


# the reference's sequence-sharded decode in a child with 4 CPU devices: the
# same configs, prompts and cache layout on a (2, 2) mesh, ``decode_step``
# of a bundle built with the same DistConfig, under jit.  A Mesh with the
# default axis types: under the installed jax ``jax.make_mesh``'s explicit
# axes refuse the reference's slab append (ROADMAP, Reference caveats)
REFERENCE = """
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import reduced_config
from repro.core.policy import PolicyConfig
from repro.launch import sharding as shard
from repro.models import DistConfig, build_model

def norm(path):
    out = []
    for k in path:
        for a in ("key", "name", "idx"):
            if hasattr(k, a):
                out.append(str(getattr(k, a)))
                break
    return "/".join(out)

with open(PATH, "rb") as f:
    inputs = pickle.load(f)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
res = {}
for arch, over in CONFIGS.items():
    cfg = dataclasses.replace(reduced_config(arch), **over)
    pol = None if cfg.attention_free else PolicyConfig(kind="fier", budget=BUDGET, group=8,
                                                       skip_layers=1, pipeline="one_pass")
    kw = {"max_positions": cfg.max_target_positions} if cfg.family == "encdec" else {}
    plain = build_model(cfg, pol, **kw)
    sharded = build_model(cfg, pol, DistConfig(mesh=mesh, seq_axes=("model",),
                                               batch_axes=("data",), mode="exact"), **kw)
    params = plain.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
             for k, v in inputs[arch].items()}
    lg, cache = jax.jit(lambda p, b: plain.prefill(p, b, capacity=CAPACITY))(params, batch)
    sh = shard.cache_shardings(jax.eval_shape(lambda: cache), mesh, ("data",), ("model",),
                               shard.cache_batch_axes(sharded.init_cache))
    cache = jax.tree.map(jax.device_put, cache, sh)
    step = jax.jit(sharded.decode_step)
    tok, toks, lgs = jnp.argmax(lg, -1).astype(jnp.int32), [], []
    for _ in range(STEPS):
        toks.append(np.asarray(tok))
        lg, cache = step(params, tok, cache)
        lgs.append(np.asarray(lg, np.float32))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    res[arch] = dict(params=jax.tree.map(np.asarray, params), tokens=toks, logits=lgs,
                     cache={norm(p): np.asarray(x, np.float32) for p, x in
                            jax.tree_util.tree_leaves_with_path(cache)})
with open(PATH, "wb") as f:
    pickle.dump(res, f)
"""


@pytest.fixture(scope="module")
def reference_mesh(tmp_path_factory):
    """{arch: the reference's params, its tokens and logits per step, and its
    cache after the steps (gathered, leaves as f32 by path)}."""
    path = tmp_path_factory.mktemp("reference_mesh") / "io.pkl"
    with open(path, "wb") as f:
        pickle.dump({arch: _inputs(_cfg(arch)) for arch in CONFIGS}, f)
    head = (f"PATH = {str(path)!r}\nCONFIGS = {CONFIGS!r}\nBUDGET = {BUDGET}\n"
            f"CAPACITY = {CAPACITY}\nSTEPS = {STEPS}\n")
    with _torch_threads.subprocess_threads():
        run_in_subprocess(head + textwrap.dedent(REFERENCE), n_devices=4)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_family_mesh_matches_reference(arch, reference_mesh):
    """The port's placed decode on a (2, 2) CPU mesh against the reference's
    sharded decode on a (2, 2) mesh of 4 devices: the reference's weights
    (``params_from_jax``) and prompts, each side's own prefill, then STEPS
    steps fed the reference's tokens.  Every step's logits within
    LOGIT_TOL · max|logit|; then the gathered caches leaf by leaf: the
    lengths equal, mamba2's conv states bit for bit and its SSM states
    within F32_REL_TOL · max (f32 in another summation order, as the
    one-device parity in test_torch_ssm_hybrid_encdec holds them), every
    K/V row written where the reference writes it, the other leaves within
    CACHE_REL_TOL · max and the side-car's sign bits within CODE_BIT_TOL."""
    ref = reference_mesh[arch]
    cfg, pol = _cfg(arch), _policy(_cfg(arch))
    kw = {"max_positions": cfg.max_target_positions} if cfg.family == "encdec" else {}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    plain = build_model(cfg, pol, device="cpu", **kw)
    sharded = build_model(cfg, pol, DistConfig(mesh=mesh, seq_axes=("model",),
                                               batch_axes=("data",), mode="exact"),
                          device="cpu", **kw)
    params = plain.compute_params(params_from_jax(ref["params"], cfg, device="cpu", **kw))
    _, cache = plain.prefill(params, {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()},
                             capacity=CAPACITY)
    placed = place_tree(cache, cache_shardings(cache, mesh, ("data",), ("model",),
                                               cache_batch_axes(sharded.init_cache, CAPACITY)))
    for i, (tok, want) in enumerate(zip(ref["tokens"], ref["logits"])):
        lg, placed = sharded.decode_step(params, torch.from_numpy(tok), placed)
        got, want = lg[:, :cfg.vocab].numpy(), want[:, :cfg.vocab]
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max(), i
    after = {p: x.float().numpy() for p, x in _port_leaves(gather_tree(placed))}
    assert sorted(after) == sorted(ref["cache"])
    written = lambda x: (x != 0).any(-1).any(-1)  # [L, B, S]
    for path, want in ref["cache"].items():
        got = after[path]
        if path == "length" or (cfg.family == "ssm" and path.endswith("conv")):
            assert np.array_equal(got, want), path
        elif cfg.family == "ssm":
            assert np.abs(got - want).max() <= F32_REL_TOL * np.abs(want).max(), path
        elif path.endswith("meta/0"):  # the packed sign bits
            flips = np.unpackbits(got.astype(np.uint8)) != np.unpackbits(want.astype(np.uint8))
            assert flips.mean() <= CODE_BIT_TOL, (path, flips.mean())
        else:
            assert np.abs(got - want).max() <= CACHE_REL_TOL * np.abs(want).max(), path
            if path.endswith(("/k", "/v")):  # each step's row written where the reference's is
                assert np.array_equal(written(got), written(want)), path
