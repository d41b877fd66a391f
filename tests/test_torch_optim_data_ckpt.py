"""Port parity of the training substrate: AdamW, gradient clipping, the
schedules and 1-bit compression against the JAX package on the same
inputs; the data pipeline's properties and the tokenizer; the checkpoint
manager (round trip, async + GC, atomic publish, mismatch, and a
checkpoint the JAX package wrote restored into the port); resume after
injected faults bit for bit; and the train CLI on the CPU.

Tolerances: AdamW and clipping 1e-6 of the largest magnitude (f32; XLA's
and torch's pow/sqrt may differ in the last bit), the schedules 1e-6
relative, compression exact up to one f32 rounding of the mean (1e-6).
"""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import tokenizer as jtok
from repro.data.pipeline import make_train_batch as j_make_train_batch
from repro.launch.steps import TrainHParams as JHParams
from repro.launch.steps import init_train_state as j_init_train_state
from repro.models import build_model as j_build_model
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.data import tokenizer
from repro_torch.data.passkey import MARK_OPEN, N_DIGITS, QUERY, make_passkey_batch
from repro_torch.data.pipeline import BRANCH, lm_tokens, make_train_batch
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.core.placement import Sharded
from repro_torch.launch.steps import TrainHParams, init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.optim.tree import leaves
from repro_torch.runtime import FaultInjector, StragglerMonitor, replicated, run_with_recovery


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": {"x": rng.standard_normal((16,)).astype(np.float32) * 1e-3}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _close(j_tree, t_tree, tol=1e-6):
    for a, b in zip(jax.tree.leaves(j_tree), leaves(t_tree)):
        a = np.asarray(a, np.float32)
        assert np.abs(a - b.numpy()).max() <= tol * max(np.abs(a).max(), 1e-30)


# ------------------------------------------------------------------- optim

def test_adamw_update_matches_reference():
    """Three AdamW steps on the same grads, params and lr: params and both
    moments as the reference's, the step count int32."""
    p, g = _tree(0), _tree(1)
    jp, jo = _j(p), joptim.adamw_init(_j(p))
    tp, to = _t(p), optim.adamw_init(_t(p))
    for lr in (1e-2, 3e-3, 1e-3):
        jp, jo = joptim.adamw_update(_j(g), jo, jp, jnp.float32(lr), weight_decay=0.1)
        tp, to = optim.adamw_update(_t(g), to, tp, torch.tensor(lr), weight_decay=0.1)
    _close(jp, tp)
    _close(jo.mu, to.mu)
    _close(jo.nu, to.nu)
    assert to.step.dtype == torch.int32 and int(to.step) == int(jo.step) == 3


def test_clip_by_global_norm_matches_reference():
    g = _tree(2)
    for max_norm in (0.5, 1e3):
        jc, jn = joptim.clip_by_global_norm(_j(g), max_norm)
        tc, tn = optim.clip_by_global_norm(_t(g), max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        _close(jc, tc)


@pytest.mark.parametrize("name", ["cosine_schedule", "wsd_schedule"])
def test_schedules_match_reference(name):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 50, 89, 90, 91, 99, 100, 120):
        ref = float(getattr(joptim, name)(step, **kw))
        got = getattr(optim, name)(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        assert abs(float(got) - ref) <= 1e-6 * max(abs(ref), 1e-12), (step, float(got), ref)


def test_compress_decompress_matches_reference():
    """Two steps of sign·mean|·| with error feedback: the compressed grads
    and the residual carried over as the reference's."""
    g1, g2 = _tree(3), _tree(4)
    jef, tef = joptim.ef_state_init(_j(g1)), optim.ef_state_init(_t(g1))
    for g in (g1, g2):
        jc, jef = joptim.compress_decompress(_j(g), jef)
        tc, tef = optim.compress_decompress(_t(g), tef)
        _close(jc, tc)
        _close(jef, tef)
    assert optim.compressed_wire_bytes(1000, 4) == 129
    # the collective: two shards' tensors, against the reference's body
    # under jax.vmap over a named axis (f32 summation order: 1e-6)
    x = np.stack([g1["w"], g2["w"]])
    ref = np.asarray(jax.vmap(lambda v: joptim.compressed_psum(v, "data"), axis_name="data")(x))
    for r, t in zip(ref, optim.compressed_psum([torch.from_numpy(v) for v in x])):
        assert float(np.abs(r - t.numpy()).max()) <= 1e-6 * float(np.abs(ref).max())


# -------------------------------------------------------------------- data

def test_data_pipeline_properties():
    """Every batch a pure function of (seed, step); process slices of one
    global batch disjoint; tokens in range; the bigram chain learnable (at
    most 8 successors a token); the vlm and encdec batches shaped as the
    reference's, targets masked over the vision prefix."""
    shape = ShapeConfig("t", 32, 8, "train")
    cfg = reduced_config("olmo-1b")
    a = make_train_batch(cfg, shape, 7, seed=3, device="cpu")
    b = make_train_batch(cfg, shape, 7, seed=3, device="cpu")
    c = make_train_batch(cfg, shape, 8, seed=3, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])
    p0 = make_train_batch(cfg, shape, 0, process_index=0, process_count=2, device="cpu")
    p1 = make_train_batch(cfg, shape, 0, process_index=1, process_count=2, device="cpu")
    assert p0["tokens"].shape == (4, 32) and not torch.equal(p0["tokens"], p1["tokens"])

    toks = lm_tokens(0, 0, 4, 128, 512)
    assert toks.shape == (4, 129) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    succ = {}
    for row in toks.tolist():
        for x, y in zip(row[:-1], row[1:]):
            succ.setdefault(x, set()).add(y)
    assert max(len(v) for v in succ.values()) <= BRANCH

    for arch in ("llava-next-mistral-7b", "whisper-small", "granite-moe-1b-a400m"):
        ref = j_make_train_batch(j_reduced_config(arch), JShapeConfig("t", 32, 4, "train"), 0)
        got = make_train_batch(reduced_config(arch), ShapeConfig("t", 32, 4, "train"), 0,
                               device="cpu")
        assert set(got) == set(ref), arch
        for k, v in ref.items():
            assert tuple(got[k].shape) == v.shape, (arch, k)
            assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), (arch, k)
        if arch.startswith("llava"):
            np.testing.assert_array_equal(got["loss_mask"].numpy(), np.asarray(ref["loss_mask"]))
            nv = reduced_config(arch).n_vision_tokens
            assert torch.equal(got["targets"][:, nv:nv + 23], got["tokens"][:, 1:])


def test_passkey_structure():
    cfg = reduced_config("olmo-1b")
    batch, answers = make_passkey_batch(cfg, 4, 128, seed=0, step=0, depth=0.4, device="cpu")
    toks = batch["tokens"].numpy()
    for b in range(4):
        pos = int(np.where(toks[b] == MARK_OPEN)[0][0])
        np.testing.assert_array_equal(toks[b, pos + 1:pos + 1 + N_DIGITS], answers[b].numpy())
        assert QUERY in toks[b]
        np.testing.assert_array_equal(toks[b, -N_DIGITS:], answers[b].numpy())
    assert float(batch["loss_mask"].sum(dim=1)[0]) == N_DIGITS


def test_tokenizer_equals_reference():
    for text in ("FIER retrieves 1-bit keys — ünïcode too.", "", "a\nb\tc", "日本語 ✓"):
        for bos in (True, False):
            for eos in (True, False):
                ids = tokenizer.encode(text, bos=bos, eos=eos)
                assert ids == jtok.encode(text, bos=bos, eos=eos)
                assert tokenizer.decode(ids) == jtok.decode(ids) == text
    assert (tokenizer.PAD, tokenizer.BOS, tokenizer.EOS, tokenizer.VOCAB_SIZE) == (
        jtok.PAD, jtok.BOS, jtok.EOS, jtok.VOCAB_SIZE)


# -------------------------------------------------------------- checkpoint

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((8, 16), generator=g), "b": torch.zeros((16,)),
              "h": torch.randn((4,), generator=g).to(torch.bfloat16)}
    return {"params": params, "opt": optim.adamw_init(params)}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    st["opt"] = st["opt"]._replace(step=torch.tensor(7, dtype=torch.int32))
    mgr.save(3, st)
    assert mgr.latest_step() == 3
    back = mgr.restore(3, _state(1))
    assert int(back["opt"].step) == 7 and back["opt"].step.dtype == torch.int32
    for a, b in zip(leaves(st), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async_gc_atomic_and_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    st = _state()
    for step in (1, 2, 3, 4):
        mgr.save_async(step, st)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    with open(tmp_path / "step_000000004" / "manifest.json") as f:
        assert json.load(f)["step"] == 4
    with pytest.raises(ValueError, match="tree mismatch"):
        mgr.restore(4, {"different": torch.zeros(3)})
    # onto a mesh: one sharding for every leaf (a 0-dim leaf stays a tensor)
    mesh = make_mesh((2,), ("data",), device="cpu")
    back = mgr.restore(4, st, sharding=replicated(mesh))
    for a, b in zip(leaves(st), leaves(back)):
        assert torch.equal(a, b.full() if isinstance(b, Sharded) else b)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A train state the JAX package's CheckpointManager wrote (reduced
    olmo-1b, AdamW moments and step) restores through the port's manager
    into the structure ``train_state_from_jax`` gives, every leaf equal."""
    jcfg = j_reduced_config("olmo-1b")
    jstate = j_init_train_state(j_build_model(jcfg), jax.random.PRNGKey(0),
                                JHParams(compress_grads=True))
    jstate["opt"] = jstate["opt"]._replace(
        step=jnp.int32(5), mu=jax.tree.map(lambda a: a + 0.25, jstate["opt"].mu))
    JCheckpointManager(str(tmp_path)).save(5, jstate)
    like = train_state_from_jax(jax.tree.map(np.asarray, jstate), reduced_config("olmo-1b"),
                                device="cpu")
    back = CheckpointManager(str(tmp_path)).restore(5, like)
    assert int(back["opt"].step) == 5 and set(back) == {"params", "opt", "ef"}
    for a, b, c in zip(jax.tree.leaves(jstate), leaves(back), leaves(like)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, c)


# ---------------------------------------------------------------- recovery

def _train_setup(steps=12):
    cfg = reduced_config("olmo-1b")
    bundle = build_model(cfg, device="cpu")
    hp = TrainHParams(peak_lr=1e-3, warmup=2, total_steps=steps)
    state = init_train_state(bundle, torch.Generator().manual_seed(0), hp)
    step_fn = make_train_step(bundle, hp)
    shape = ShapeConfig("t", 32, 4, "train")

    def one_step(st, step):
        return step_fn(st, make_train_batch(cfg, shape, step, seed=0, device="cpu"))[0]

    return state, one_step


def test_resume_is_bit_exact(tmp_path):
    """Uninterrupted vs failing at steps 5 and 9 and resuming from the
    checkpoints: the final state equal bit for bit."""
    state, one_step = _train_setup()
    ref = state
    for s in range(12):
        ref = one_step(ref, s)
    injector = FaultInjector([5, 9])

    def faulty_step(st, step):
        injector.maybe_fail(step)
        return one_step(st, step)

    out, stats = run_with_recovery(faulty_step, state, 12, CheckpointManager(str(tmp_path),
                                                                            keep_n=3),
                                   ckpt_every=4, state_like=state)
    assert stats == {"restarts": 2, "resumed_from": [4, 8]}
    for a, b in zip(leaves(ref), leaves(out)):
        assert torch.equal(a, b)


def test_too_many_restarts_raises_and_straggler_flagged(tmp_path):
    state, _ = _train_setup()

    def always_fail(st, step):
        raise RuntimeError("permafault")

    with pytest.raises(RuntimeError, match="too many restarts"):
        run_with_recovery(always_fail, state, 5, CheckpointManager(str(tmp_path)),
                          max_restarts=2, state_like=state)
    mon = StragglerMonitor(alpha=0.5, threshold=2.0)
    for i, dt in enumerate([0.01] * 5 + [0.5]):
        mon.start()
        mon._t0 -= dt
        mon.stop(i)
    assert [e[0] for e in mon.events] == [5]


def test_train_cli_recovers_from_an_injected_fault(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu
    --fail-at 6``: one restart from the step-4 checkpoint, finite losses,
    the reference's JSON log lines; with ``--model-axis 2`` the same run
    trains over a (1, 2) mesh and logs the same keys."""
    train_cli.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "10",
                    "--batch", "4", "--seq", "32", "--ckpt-every", "4", "--fail-at", "6",
                    "--log-every", "1", "--ckpt-dir", str(tmp_path)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    done = lines[-1]
    assert done["done"] and done["restarts"] == 1 and done["resumed_from"] == [4]
    steps = [x for x in lines if "step" in x and "done" not in x]
    assert [x["step"] for x in steps] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9]
    assert all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"]) for x in steps)
    assert {"loss", "moe_aux", "tokens", "grad_norm", "lr", "total", "dt_s"} <= set(steps[0])
    train_cli.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "3",
                    "--batch", "4", "--seq", "32", "--log-every", "1", "--model-axis", "2",
                    "--ckpt-dir", str(tmp_path / "mesh")])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[-1]["done"] and [x["step"] for x in lines[:-1]] == [0, 1, 2]
    assert set(lines[0]) == set(steps[0]) and np.isfinite(lines[-2]["loss"])


def test_train_cli_without_ckpt_dir_leaves_nothing_to_resume(tmp_path, monkeypatch, capsys):
    """Without ``--ckpt-dir`` the CLI checkpoints into a fresh temporary
    directory and removes it at exit, so a second run starts from step 0
    again and nothing is left behind."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt-every", "1", "--log-every", "1"]
    for _ in range(2):
        train_cli.main(argv)
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert [x["step"] for x in lines if "done" not in x] == [0, 1, 2]
        assert lines[-1]["restarts"] == 0 and lines[-1]["resumed_from"] == []
        assert list(tmp_path.iterdir()) == []
