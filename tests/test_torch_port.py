"""Rules of the port that hold for the package as a whole: it stands alone
(no ``jax``, no ``repro``) and runs on CUDA unless asked for the CPU."""
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

    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        DecodePlan.build(PolicyConfig(kind="fier", layout="paged"), shard=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        Engine.build(reduced_config("olmo-1b"), n_slots=1, capacity=64, layout="paged",
                     offload_blocks=4, device="cpu")
    # two_pass builds on a slab; the paged layout lacks it, as in the JAX matrix
    assert DecodePlan.build(PolicyConfig(kind="fier", pipeline="two_pass")).pipeline == "two_pass"
    with pytest.raises(UnsupportedPlanError, match="two_pass"):
        DecodePlan.build(PolicyConfig(kind="fier", pipeline="two_pass", layout="paged"))
    with pytest.raises(NotImplementedError, match="quest.*item 7b"):
        PolicyConfig(kind="quest")
    with pytest.raises(NotImplementedError, match="item 9"):
        Engine.build(reduced_config("granite-moe-1b-a400m"), n_slots=1, capacity=64,
                     device="cpu")
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        Engine.build(reduced_config("olmo-1b"), n_slots=1, capacity=64,
                     policy=serving_policy(budget=128), device="cpu")
