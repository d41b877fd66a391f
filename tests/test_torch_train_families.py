"""Port parity of every family's ``train_loss`` and its gradient against
``jax.value_and_grad`` of the JAX package's, at ``reduced_config`` on the
reference's own batch (B 2, S 32, fed to both as numpy) and weights
(``params_from_jax``), in f32 and bf16 compute.

Tolerances, each relative to the largest magnitude of the reference tensor
it is held to:

* f32: ``train_loss`` 1e-6 and each gradient leaf 2e-5 (measured up to
  5.1e-6, mamba2's conv) — the two packages' f32 matmuls sum in other
  orders;
* bf16: the loss 1e-4 and each gradient leaf 5e-2 (measured up to 2.9e-2,
  zamba2's conv weight: a few bf16 steps where XLA's CPU matmul and torch's
  round a product differently and the difference runs through two layers
  of backward).

A leaf's scale is floored at 1e-2 of the largest gradient of the tree: the
key-projection biases get exactly zero gradient in exact arithmetic
(softmax ignores a constant added to every key's score), so both packages
read rounding noise there.
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
from repro.models import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model

from test_torch_train import _paths, torch_batch

ARCHS = ["olmo-1b", "starcoder2-3b", "granite-moe-1b-a400m", "llava-next-mistral-7b",
         "mamba2-370m", "zamba2-7b", "whisper-small"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, dtype):
    """Each family's ``train_loss`` (remat on, as built by default) and the
    gradient of every parameter leaf against ``jax.value_and_grad`` of the
    reference's, on the reference's batch (B 2, S 32) and weights."""
    jcfg = dataclasses.replace(j_reduced_config(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype=dtype)
    jb = j_build_model(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    batch = j_make_train_batch(jcfg, ShapeConfig("t", 32, 2, "train"), 0, seed=0)
    (j_loss, j_m), j_g = jax.jit(jax.value_and_grad(jb.train_loss, has_aux=True))(jp, batch)

    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    leaves = {path: t.requires_grad_() for path, t in _paths(params)}
    loss, m = build_model(cfg, device="cpu").train_loss(params, torch_batch(batch))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss = loss.detach()

    loss_tol, grad_tol = (1e-6, 2e-5) if dtype == "float32" else (1e-4, 5e-2)
    assert abs(float(loss) - float(j_loss)) <= loss_tol * abs(float(j_loss))
    assert abs(float(m["moe_aux"].detach()) - float(j_m["moe_aux"])) <= loss_tol * 10
    assert float(m["tokens"]) == float(j_m["tokens"])
    j_leaves = {tuple(k.key for k in path): np.asarray(g, np.float32)
                for path, g in jax.tree_util.tree_flatten_with_path(j_g)[0]}
    assert set(j_leaves) == set(grads)
    floor = 1e-2 * max(np.abs(g).max() for g in j_leaves.values())
    bad = {}
    for path, ref in j_leaves.items():
        err = np.abs(ref - grads[path].to(torch.float32).numpy()).max()
        if err > grad_tol * max(np.abs(ref).max(), floor):
            bad[path] = float(err)
    assert not bad, bad
