"""The transformer family served on placed params (``core.placement.
place_tree(params, launch.sharding.param_shardings(params, mesh,
("data",)))``): Megatron-parallel prefill, chunked prefill and decode
(``models/placed_serving.py``) on a (2, 2) ``data`` × ``model`` CPU mesh,
held to the reference's steps.

* The reference's side runs in a child with 4 CPU devices (a
  ``jax.sharding.Mesh`` with the default axis types): reduced olmo-1b,
  granite-moe-1b-a400m and llava-next-mistral-7b at LAYERS layers (skip 1,
  FIER budget BUDGET of CAPACITY), under ``jax.jit``: the prefill of a
  bundle built with ``DistConfig(mesh, batch_axes=("data",)[,
  ep_axis="model", fsdp_axes=("data",)])``, STEPS decode steps of one built
  with ``seq_axes=("model",)`` (exact mode) on that cache placed by
  ``cache_shardings``, and its ``Engine`` (paged, block 8): four inserts,
  STEPS decode steps, then a chunked insert of the first prompt in
  CHUNK-token chunks and one step.  It runs all of them twice: on params
  placed by its ``param_shardings`` (the installed jax takes them, no
  ``ShardingTypeError``) and on plain params, fed the placed run's tokens.
  Its own placed steps lie up to 0.158 of max|logit| from its plain ones
  (granite-moe's engine; GSPMD partitions the bf16 products and sums).
* The port's side takes the same weights (``convert.params_from_jax``),
  placed by its ``param_shardings``: its placed prefill, its placed decode
  on the sequence-sharded slab (fed the reference's tokens), and its
  ``Engine.build(mesh=)`` (TP × DP paged pool) with the same inserts, steps
  (teacher-forced) and chunked insert.  Every logits row lies within
  LOGIT_TOL · max|logit| of the reference's plain run and within LOGIT_TOL
  plus the reference's own placed-vs-plain gap of its placed run; the
  caches leaf by leaf against the plain run's as ``test_torch_family_mesh``
  holds them.
* The MoE prefill with ``dcfg.ep_axis`` (unplaced params) routes through
  ``moe_apply_ep``, capacity per token shard, as the reference's ``_ffn``:
  its logits and cache against the reference's on the same mesh.  The
  prompts open with a run of one token, so the first layer's router sends
  those positions to the same experts and the per-shard capacity drops
  other (token, expert) slots than one capacity over the call would.
* Collectives, on fake devices: one placed decode step and one placed
  prefill recorded (``dist.recording``): no all-gather joins a leaf's
  pieces across both mesh axes (a leaf that ``param_pspec`` splits over
  'model' gathered whole would), every device's weight all-gather bytes
  equal the FSDP gather of its TP slice of every data-split leaf, and
  every other all-gather carries per-row activations.
* On a one-device cache (a bundle or slab engine without a mesh) placed
  params serve too: prefill, decode and chunked prefill against the plain
  params' in f32 compute.
* A placed tree that cannot take the layout raises naming the leaf: heads
  that do not divide where a step runs whole heads per model shard
  (chunked prefill), a leaf split over 'model' on another dim than its TP
  dim, params on another mesh than the engine's.
"""
import _torch_threads
import dataclasses
import pickle
import textwrap
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import run_in_subprocess
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import distributed as dist
from repro_torch.core.placement import NamedSharding, P, Sharded, gather_tree, place, place_tree
from repro_torch.core.policy import PolicyConfig
from repro_torch.launch.mesh import make_fake_mesh, make_mesh
from repro_torch.launch.sharding import param_shardings
from repro_torch.launch.specs import build_cell
from repro_torch.models import build_model
from repro_torch.models.attention import DistConfig
from repro_torch.serving import Engine

from test_torch_dryrun import _port_leaves

ARCHS = ("olmo-1b", "granite-moe-1b-a400m", "llava-next-mistral-7b")
LAYERS, CAPACITY, BUDGET, STEPS, CHUNK = 3, 64, 32, 3, 16
PROMPTS = (40, 33, 20, 50)
# the port's placed steps against the reference's, × max|logit|.  Each side
# rounds its bf16 products in its own order (XLA's partitioned dots, the
# port's f32 partials summed once), and the rounding carries through the
# layers and into the cache
LOGIT_TOL = 3e-2
CACHE_REL_TOL = 2e-2   # test_torch_family_mesh's: bf16 caches a few roundings apart
CODE_BIT_TOL = 1e-2    # the side-car's sign bits that a near-zero key component flips


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), n_layers=LAYERS)


def _pol(layout="slab"):
    pol = PolicyConfig(kind="fier", budget=BUDGET, group=8, skip_layers=1, pipeline="one_pass")
    return dataclasses.replace(pol, layout="paged", block_size=8) if layout == "paged" else pol


def _inputs(arch):
    cfg = reduced_config(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    toks[:, :20] = 7  # one token: the first layer routes it to the same experts
    lengths = np.array([32, 29, 24, 32], np.int32)
    batch = {"tokens": toks, "lengths": lengths}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (4, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        batch["lengths"] = lengths + cfg.n_vision_tokens
    prompts = [rng.integers(0, cfg.vocab, (1, n)).astype(np.int32) for n in PROMPTS]
    return dict(batch=batch, prompts=prompts)


REFERENCE = """
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import reduced_config
from repro.core.policy import PolicyConfig
from repro.launch import sharding as shard
from repro.models import DistConfig, build_model
from repro.serving import Engine

def norm(path):
    out = []
    for k in path:
        for a in ("key", "name", "idx"):
            if hasattr(k, a):
                out.append(str(getattr(k, a)))
                break
    return "/".join(out)

def flat(tree):
    return {norm(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}

with open(PATH, "rb") as f:
    inputs = pickle.load(f)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
res = {}
for arch, inp in inputs.items():
    cfg = dataclasses.replace(reduced_config(arch), n_layers=LAYERS)
    pol = PolicyConfig(kind="fier", budget=BUDGET, group=8, skip_layers=1, pipeline="one_pass")
    ep = dict(ep_axis="model", fsdp_axes=("data",)) if cfg.family == "moe" else {}
    pre_b = build_model(cfg, pol, DistConfig(mesh=mesh, batch_axes=("data",), **ep))
    dec_b = build_model(cfg, pol, DistConfig(mesh=mesh, seq_axes=("model",),
                                             batch_axes=("data",), mode="exact", **ep))
    params = pre_b.init(jax.random.PRNGKey(0))
    psh = shard.param_shardings(jax.eval_shape(lambda: params), mesh, ("data",))
    placed = jax.tree.map(jax.device_put, params, psh)
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    prefill = jax.jit(lambda p, b: pre_b.prefill(p, b, capacity=CAPACITY))
    step = jax.jit(dec_b.decode_step)
    csh = None
    eng = Engine.build(cfg, n_slots=4, capacity=CAPACITY,
                       policy=dataclasses.replace(pol, layout="paged", block_size=8))

    def run(pp, forced):
        # the prefill, STEPS slab decode steps, the engine's inserts and
        # STEPS steps, a chunked insert and one step; fed ``forced``'s
        # tokens when given (the placed run's)
        global csh
        out = {}
        lg, cache = prefill(pp, batch)
        out.update(prefill_logits=np.asarray(lg, np.float32), prefill_cache=flat(cache))
        csh = csh or shard.cache_shardings(jax.eval_shape(lambda: cache), mesh, ("data",),
                                           ("model",), shard.cache_batch_axes(dec_b.init_cache))
        cache = jax.tree.map(jax.device_put, cache, csh)
        tok, toks, lgs = jnp.argmax(lg, -1).astype(jnp.int32), [], []
        for i in range(STEPS):
            tok = jnp.asarray(forced["decode_tokens"][i]) if forced else tok
            toks.append(np.asarray(tok))
            lg, cache = step(pp, tok, cache)
            lgs.append(np.asarray(lg, np.float32))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
        out.update(decode_tokens=toks, decode_logits=lgs, decode_cache=flat(cache))
        pc = eng.new_cache()
        pre, first = [], []
        for slot, p in enumerate(inp["prompts"]):
            l, pc = eng.insert(pp, pc, jnp.asarray(p), p.shape[1], slot)
            pre.append(np.asarray(l, np.float32))
            first.append(int(jnp.argmax(l, -1)[0]))
        tok, etoks, elgs = jnp.asarray(first, jnp.int32), [], []
        for i in range(STEPS):
            for slot in range(4):
                ok, pc = eng.advance_slot(pc, slot)
            tok = jnp.asarray(forced["engine_tokens"][i]) if forced else tok
            etoks.append(np.asarray(tok))
            tok, l, pc = eng.decode(pp, tok, pc)
            elgs.append(np.asarray(l, np.float32))
        out.update(engine_prefill=np.concatenate(pre), engine_tokens=etoks, engine_logits=elgs)
        p0 = [int(t) for t in inp["prompts"][0][0]]
        pc = eng.new_cache()
        start, pc = eng.begin_chunked(pc, 0, p0)
        while start < len(p0):
            n = min(CHUNK, len(p0) - start)
            ok, l, pc = eng.prefill_chunk(pp, pc, 0, p0, start, n)
            start += n
        ok, pc = eng.advance_slot(pc, 0)
        t0 = forced["chunk_token"] if forced else int(jnp.argmax(l, -1)[0])
        _, l2, pc = eng.decode(pp, jnp.zeros((4,), jnp.int32).at[0].set(t0), pc)
        out.update(chunk_logits=np.asarray(l, np.float32), chunk_token=t0,
                   chunk_step=np.asarray(l2, np.float32))
        return out

    out = dict(params=jax.tree.map(np.asarray, params), placed=run(placed, None))
    out["plain"] = run(params, out["placed"])
    res[arch] = out
with open(PATH, "wb") as f:
    pickle.dump(res, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("placed_serving") / "io.pkl"
    with open(path, "wb") as f:
        pickle.dump({arch: _inputs(arch) for arch in ARCHS}, f)
    head = (f"PATH = {str(path)!r}\nLAYERS = {LAYERS}\nCAPACITY = {CAPACITY}\n"
            f"BUDGET = {BUDGET}\nSTEPS = {STEPS}\nCHUNK = {CHUNK}\n")
    with _torch_threads.subprocess_threads():
        run_in_subprocess(head + textwrap.dedent(REFERENCE), n_devices=4)
    with open(path, "rb") as f:
        return pickle.load(f)


def _mesh():
    return make_mesh((2, 2), ("data", "model"), device="cpu")


def _params(ref, arch, mesh=None):
    cfg = _cfg(arch)
    one = build_model(cfg, _pol(), device="cpu")
    params = one.compute_params(params_from_jax(ref[arch]["params"], cfg, device="cpu"))
    if mesh is None:
        return params
    return place_tree(params, param_shardings(params, mesh, ("data",)))


def _batch(arch):
    return {k: torch.from_numpy(v) for k, v in _inputs(arch)["batch"].items()}


def _ep(cfg):
    return {"ep_axis": "model"} if cfg.family == "moe" else {}


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _held(got, ref, key, what, i=None, rows=slice(None)):
    """The port's placed logits ``got`` against the reference's: within
    LOGIT_TOL of its plain-params run, and within LOGIT_TOL plus the
    reference's own placed-vs-plain gap of its placed run."""
    pick = (lambda r: r[key]) if i is None else (lambda r: r[key][i])
    placed, plain = (pick(ref[k])[rows, :got.shape[1]] for k in ("placed", "plain"))
    own = _gap(placed, plain)
    g_plain, g_placed = _gap(got, plain), _gap(got, placed)
    assert g_plain <= LOGIT_TOL and g_placed <= own + LOGIT_TOL, (what, g_plain, g_placed, own)


def _caches_close(got_tree, ref, key):
    """The gathered cache leaf by leaf against the reference's plain-params
    run's: lengths equal, the side-car's sign bits within CODE_BIT_TOL, the
    rest within CACHE_REL_TOL · max."""
    want = ref["plain"][key]
    got = {p: x.float().numpy() for p, x in _port_leaves(gather_tree(got_tree))}
    assert sorted(got) == sorted(want) == sorted(ref["placed"][key])
    for path, w in want.items():
        g = got[path]
        if path == "length":
            assert np.array_equal(g, w), path
        elif path.endswith("meta/0"):  # the packed sign bits
            flips = np.unpackbits(g.astype(np.uint8)) != np.unpackbits(w.astype(np.uint8))
            assert flips.mean() <= CODE_BIT_TOL, (path, flips.mean())
        else:
            assert np.abs(g - w).max() <= CACHE_REL_TOL * np.abs(w).max(), path


def test_moe_prefill_is_expert_parallel(reference):
    """granite-moe's prefill with ``DistConfig(mesh, batch_axes=("data",),
    ep_axis="model")`` on unplaced params: logits and cache as the
    reference's expert-parallel prefill (capacity per token shard) on the
    same unplaced params."""
    arch = "granite-moe-1b-a400m"
    ref, cfg = reference[arch], _cfg(arch)
    bundle = build_model(cfg, _pol(), DistConfig(mesh=_mesh(), batch_axes=("data",), **_ep(cfg)),
                         device="cpu")
    V = cfg.vocab
    lg, cache = bundle.prefill(_params(reference, arch), _batch(arch), capacity=CAPACITY)
    assert _gap(lg[:, :V], ref["plain"]["prefill_logits"][:, :V]) <= LOGIT_TOL
    _caches_close(cache, ref, "prefill_cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_prefill_and_decode_match_reference(arch, reference):
    """The placed prefill (its cache placed by ``cache_shardings`` over
    batch × sequence) and STEPS placed decode steps on the
    sequence-sharded slab, fed the reference's tokens."""
    ref, cfg = reference[arch], _cfg(arch)
    mesh = _mesh()
    V = cfg.vocab
    pre = build_model(cfg, _pol(), DistConfig(mesh=mesh, batch_axes=("data",), **_ep(cfg)),
                      device="cpu")
    dec = build_model(cfg, _pol(), DistConfig(mesh=mesh, seq_axes=("model",),
                                              batch_axes=("data",), mode="exact", **_ep(cfg)),
                      device="cpu")
    params = _params(reference, arch, mesh)
    lg, cache = pre.prefill(params, _batch(arch), capacity=CAPACITY)
    assert isinstance(cache["rest"]["k"], Sharded) and cache["rest"]["k"].grid == (1, 2, 2, 1, 1)
    _held(lg[:, :V], ref, "prefill_logits", "prefill logits")
    _caches_close(cache, ref, "prefill_cache")
    for i, tok in enumerate(ref["placed"]["decode_tokens"]):
        lg, cache = dec.decode_step(params, torch.from_numpy(tok), cache)
        _held(lg[:, :V], ref, "decode_logits", f"decode step {i}", i)
    _caches_close(cache, ref, "decode_cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_engine_matches_reference(arch, reference):
    """``Engine.build(mesh=)`` on the TP × DP paged pool with placed params
    against the reference's engine on the same weights: the four inserts'
    logits, STEPS decode steps teacher-forced with its tokens, then a
    chunked insert (CHUNK tokens a chunk) and one step."""
    ref, cfg = reference[arch], _cfg(arch)
    mesh = _mesh()
    V = cfg.vocab
    eng = Engine.build(cfg, n_slots=4, capacity=CAPACITY, policy=_pol("paged"), mesh=mesh,
                       device="cpu")
    params = _params(reference, arch, mesh)
    cache = eng.new_cache()
    pre = []
    for slot, p in enumerate(_inputs(arch)["prompts"]):
        lg, cache = eng.insert(params, cache, torch.from_numpy(p), p.shape[1], slot)
        pre.append(lg)
    _held(torch.cat(pre)[:, :V], ref, "engine_prefill", "insert logits")
    for i, tok in enumerate(ref["placed"]["engine_tokens"]):
        for slot in range(4):
            ok, cache = eng.advance_slot(cache, slot)
            assert ok
        _, lg, cache = eng.decode(params, torch.from_numpy(tok), cache)
        _held(lg[:, :V], ref, "engine_logits", f"decode step {i}", i)
    eng.audit()
    p0 = [int(t) for t in _inputs(arch)["prompts"][0][0]]
    cache = eng.new_cache()
    start, cache = eng.begin_chunked(cache, 0, p0)
    while start < len(p0):
        n = min(CHUNK, len(p0) - start)
        ok, lg, cache = eng.prefill_chunk(params, cache, 0, p0, start, n)
        assert ok
        start += n
    _held(lg[:, :V], ref, "chunk_logits", "chunked prefill logits")
    ok, cache = eng.advance_slot(cache, 0)
    tok = torch.zeros(4, dtype=torch.int32)
    tok[0] = ref["placed"]["chunk_token"]
    _, lg, cache = eng.decode(params, tok, cache)
    _held(lg[:1, :V], ref, "chunk_step", "the step after the chunked insert", rows=slice(0, 1))
    eng.audit()


def _gathers(fn):
    """Run ``fn``, recording per device the bytes of the weight all-gathers
    (``Sharded.view``'s, through ``dist.gathered``) and the bytes of every
    other all-gather (``dist.gather`` outside a weight's)."""
    gathered, gather = dist.gathered, dist.gather
    weights, acts = defaultdict(int), []

    def weight(f, n, piece_bytes, device):
        weights[device] += n * piece_bytes
        return gathered(f, n, piece_bytes, device)

    def act(xs, dim, device):
        out = gather(xs, dim, device)
        if not dist._compound[0] and len(xs) > 1:
            acts.append(out.numel() * out.element_size())
        return out

    dist.gathered, dist.gather = weight, act
    try:
        with dist.recording() as rec:
            fn()
    finally:
        dist.gathered, dist.gather = gathered, gather
    return weights, acts, rec


@pytest.mark.parametrize("arch", ("olmo-1b", "granite-moe-1b-a400m"))
@pytest.mark.parametrize("kind", ("decode", "prefill"))
def test_placed_steps_gather_tp_slices_only(arch, kind):
    """One placed step on a fake (2, 2) mesh: each device's weight
    all-gathers sum to the FSDP gather of its TP slice of every data-split
    leaf (none gathered whole over 'model'), and every other all-gather
    carries at most the batch's rows of activations or logits."""
    cfg = _cfg(arch)
    B, S = 4, 64
    with FakeTensorMode():
        mesh = make_fake_mesh((2, 2), ("data", "model"))
        cell = build_cell(arch, ShapeConfig("c", S, B, kind), mesh, cfg=cfg, budget=BUDGET)
        weights, acts, rec = _gathers(lambda: cell.fn(*cell.args))
    want = 0
    for _, leaf in _port_leaves(cell.args[0]):
        axes = leaf.sharding.dim_axes(leaf.ndim)
        n_model = mesh.shape["model"] if any("model" in a for a in axes) else 1
        if any("data" in a for a in axes):
            want += leaf.numel() * leaf.dtype.itemsize // n_model
    # a leaf split over 'data' and 'model' gathered whole would join all 4
    # pieces; a TP slice's FSDP gather joins 2, as every activation gather does
    groups = [n for k, _, n, _ in rec.summary() if k == "all-gather"]
    assert groups and max(groups) == 2
    assert set(weights) == set(mesh.devices)
    assert all(w == want for w in weights.values()), (dict(weights), want)
    widest = max(cfg.n_heads * cfg.d_head, 256 * -(-cfg.vocab // 256))
    assert acts and max(acts) <= B * widest * 4, (max(acts), B * widest * 4)


# placed vs plain params in f32 compute, × max|logit|: the sums run in another
# order, and the bf16 cache rounds a K/V element the two sum an f32 ulp apart
# to neighbouring values (measured ≤ 7.3e-5 over the steps, 4.6e-7 at prefill)
F32_REL_TOL = 2e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_params_serve_a_one_device_cache(arch):
    """A bundle built without a mesh, or a slab engine, fed placed params:
    the prefill's cache comes back whole on the bundle's device, decode
    gathers each step's q/k/v rows onto it, chunked prefill runs each
    model shard's heads of the slab; in f32 compute every logits row lies
    within F32_REL_TOL · max|logit| of the plain params'."""
    cfg = dataclasses.replace(_cfg(arch), compute_dtype="float32")
    V = cfg.vocab
    mesh = _mesh()
    eng = Engine.build(cfg, n_slots=4, capacity=CAPACITY, policy=_pol(), device="cpu")
    params = eng.bundle.init(0)
    placed = place_tree(params, param_shardings(params, mesh, ("data",)))
    runs = {}
    for name, p in (("plain", params), ("placed", placed)):
        lg, cache = eng.bundle.prefill(p, _batch(arch), capacity=CAPACITY)
        assert not isinstance(cache["rest"]["k"], Sharded)
        out = [lg]
        tok = lg.argmax(-1).to(torch.int32)
        for _ in range(2):
            tok, lg, cache = eng.decode(p, tok, cache)
            out.append(lg)
        cache = eng.new_cache()
        p0 = [int(t) for t in _inputs(arch)["prompts"][3][0]]
        start, cache = eng.begin_chunked(cache, 1, p0)
        while start < len(p0):
            ok, lg, cache = eng.prefill_chunk(p, cache, 1, p0, start, min(CHUNK, len(p0) - start))
            start += CHUNK
        out.append(lg)
        runs[name] = out
    for i, (a, b) in enumerate(zip(runs["placed"], runs["plain"])):
        assert _gap(a[:, :V], b[:, :V]) <= F32_REL_TOL, i


def test_unplaceable_trees_raise():
    """Heads that do not divide over the model shards where a step runs
    whole heads per shard (chunked prefill), a leaf split over 'model' on
    another dim, and params placed on another mesh than the engine's: each
    raises naming what cannot take the layout."""
    cfg = _cfg("olmo-1b")  # 4 heads of 16
    one = build_model(cfg, _pol(), device="cpu")
    params = one.init(0)
    batch = _batch("olmo-1b")
    wide = make_mesh((1, 8), ("data", "model"), device="cpu")
    placed = place_tree(params, param_shardings(params, wide, ("data",)))
    chunk = {"tokens": batch["tokens"][:1, :8], "start": 0, "slot": 0, "total": 8}
    with pytest.raises(ValueError, match="layers/attn/wq: n_heads 4 does not divide over 8"):
        one.prefill_chunk(placed, chunk, one.init_cache(2, CAPACITY), final=True)
    mesh = _mesh()
    bundle = build_model(cfg, _pol(), DistConfig(mesh=mesh, batch_axes=("data",)), device="cpu")
    placed = place_tree(params, param_shardings(params, mesh, ("data",)))
    wq = params["layers"]["attn"]["wq"]
    placed["layers"]["attn"]["wq"] = place(wq, NamedSharding(mesh, P(None, "model", "data")))
    with pytest.raises(ValueError, match="layers/attn/wq: split over 'model' on dim 1"):
        bundle.prefill(placed, batch, capacity=CAPACITY)
    eng = Engine.build(cfg, n_slots=4, capacity=CAPACITY, policy=_pol("paged"),
                       mesh=make_mesh((1, 2), ("data", "model"), device="cpu"), device="cpu")
    placed = place_tree(params, param_shardings(params, mesh, ("data",)))
    p = torch.from_numpy(_inputs("olmo-1b")["prompts"][0])
    with pytest.raises(ValueError, match="the pool's mesh .* is not the params' mesh"):
        eng.insert(placed, eng.new_cache(), p, p.shape[1], 0)
