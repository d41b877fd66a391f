"""Rules of the port that hold for the package as a whole: it stands alone
(no ``jax``, no ``repro``) and runs on CUDA unless asked for the CPU."""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = list(_port_files())
    assert len(files) > 15
    bad = [
        (os.path.relpath(p, REPO), name)
        for p in files for name in _imports(p)
        if name.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, bad


def test_entry_points_default_to_cuda():
    from repro_torch.configs import reduced_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model
    from repro_torch.serving import Engine

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    cfg = reduced_config("olmo-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine.build(cfg, n_slots=1, capacity=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({}, cfg)
    assert Engine.build(cfg, n_slots=1, capacity=64, device="cpu").device.type == "cpu"


def test_modes_not_ported_raise():
    from repro_torch.configs import reduced_config
    from repro_torch.core.policy import DecodePlan, PolicyConfig, UnsupportedPlanError
    from repro_torch.serving import Engine, serving_policy

    from repro_torch.kvcache.sharded import ShardSpec
    from repro_torch.launch.mesh import make_mesh

    # mesh-sharded plans (ROADMAP Queue 1 item 10's serving part) are ported,
    # on the paged layout only, as in the JAX package
    spec = ShardSpec(mesh=make_mesh((1, 1), ("data", "model"), device="cpu"),
                     tp_axes=("model",), dp_axes=("data",))
    assert DecodePlan.build(PolicyConfig(kind="fier", layout="paged"), shard=spec).shard is spec
    with pytest.raises(UnsupportedPlanError, match="requires layout='paged'"):
        DecodePlan.build(PolicyConfig(kind="fier"), shard=spec)
    # the host tier and TTL (ROADMAP Queue 1 item 8) are ported: they build
    eng = Engine.build(reduced_config("olmo-1b"), n_slots=1, capacity=64, layout="paged",
                       offload_blocks=4, prefix_ttl=8.0, device="cpu")
    assert eng.offload.capacity_blocks == 4 and eng.allocator.park_ttl == 8.0
    # two_pass builds on a slab; the paged layout lacks it, as in the JAX matrix
    assert DecodePlan.build(PolicyConfig(kind="fier", pipeline="two_pass")).pipeline == "two_pass"
    with pytest.raises(UnsupportedPlanError, match="two_pass"):
        DecodePlan.build(PolicyConfig(kind="fier", pipeline="two_pass", layout="paged"))
    # the baselines (item 7b) are ported, on the slab layout only, as in the
    # JAX matrix
    assert DecodePlan.build(PolicyConfig(kind="quest")).policy.kind == "quest"
    assert DecodePlan.build(PolicyConfig(kind="slm")).policy.kind == "slm"
    with pytest.raises(UnsupportedPlanError, match="quest"):
        DecodePlan.build(PolicyConfig(kind="quest", layout="paged"))
    # every family of item 9 builds: moe and vlm, and ssm, hybrid and
    # encdec, whose paged layout stays refused, as in the reference
    eng = Engine.build(reduced_config("granite-moe-1b-a400m"), n_slots=1, capacity=64,
                       device="cpu")
    assert "moe" in eng.bundle.init(0)["layers"]
    for arch, leaf in (("mamba2-370m", "layers"), ("zamba2-7b", "shared"),
                       ("whisper-small", "enc_layers")):
        eng = Engine.build(reduced_config(arch), n_slots=1, capacity=64,
                           policy=serving_policy(budget=16, group=8, skip_layers=1),
                           device="cpu")
        assert leaf in eng.bundle.init(0)
        with pytest.raises(ValueError, match="only supported for transformer families"):
            Engine.build(reduced_config(arch), n_slots=1, capacity=64, layout="paged",
                         device="cpu")
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        Engine.build(reduced_config("olmo-1b"), n_slots=1, capacity=64,
                     policy=serving_policy(budget=128), device="cpu")
