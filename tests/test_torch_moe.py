"""Port parity of the MoE FFN (``repro_torch.models.moe``) with the JAX
package's ``repro.models.moe`` on reduced granite-moe-1b-a400m (d 64, 4
experts, top-2, d_ff 64) and, for ``moe_apply`` and ``moe_apply_masked``,
on reduced qwen3-moe-235b-a22b with its published 128 experts and top-8
(``E128``: d 64, d_ff 64).

Inputs are numpy-seeded [T, d] rows rounded to bf16, weights come from the
reference's ``init_moe`` (numpy), and the reference runs jitted, as its
serving path does.  Seed 0 keeps every token's k-th and (k+1)-th router
logits more than 1e-3 apart in both configs (asserted), so both packages
route alike.

* ``moe_apply`` at capacity factor 1.25 and at 0.5 (slots drop; at 128
  experts, capacity 4, slots drop at 1.25 too): the set of dropped (token,
  expert) slots is equal, y within one bf16 step of the largest output
  (2^-7·max|y|) with at most 1% of elements differing (the expert matmuls
  sum in another order), aux within 1e-6.
* ``moe_apply_masked`` the same way; its three-operand einsum is taken as
  (h1·gate) then one contraction over (e, f), another order than XLA's.
* With nothing dropped, the port's scatter and masked paths agree within
  one bf16 step of max|y| (about half the elements differ by a step, as the
  reference's own two paths do).
* ``init_moe``'s tree has the reference's keys and shapes, stacked per layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models import transformer

ARCH = "granite-moe-1b-a400m"
E128 = "qwen3-moe-235b-a22b"  # at its published 128 experts, top-8
T = 48


def _cfgs(cf, arch=ARCH):
    over = dict(capacity_factor=cf)
    if arch == E128:
        over.update(n_experts=128, topk_experts=8)
    return tuple(dataclasses.replace(c, **over)
                 for c in (j_reduced_config(arch), reduced_config(arch)))


@pytest.fixture(scope="module")
def inputs():
    return _inputs(ARCH)


@pytest.fixture(scope="module")
def inputs_e128():
    return _inputs(E128)


def _inputs(arch):
    jc, _ = _cfgs(1.25, arch)
    p = jmoe.init_moe(jax.random.PRNGKey(1), jc)
    x = np.random.default_rng(0).standard_normal((T, jc.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    logits = np.asarray(xj.astype(jnp.float32) @ p["router"])
    top = np.sort(logits, -1)[:, ::-1]
    k = jc.topk_experts
    assert (top[:, k - 1] - top[:, k]).min() > 1e-3  # no near-tie at the k-th expert
    return xj, p, xt, pt


def _ref_dropped(xj, p, cfg):
    """The reference's dropped (token, expert) slots, by its own formula
    (``repro/models/moe.py:42-57``)."""
    E, k = cfg.n_experts, cfg.topk_experts
    C = max(int(T * k / E * cfg.capacity_factor + 0.999), 1)
    _, eidx = jax.lax.top_k(xj.astype(jnp.float32) @ p["router"], k)
    e_flat = eidx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1, e_flat[:, None], axis=1)[:, 0]
    drop = np.asarray(pos >= C)
    return {(i // k, int(e)) for i, e in enumerate(np.asarray(e_flat)) if drop[i]}


def _port_dropped(xt, pt, cfg):
    _, eidx, _ = moe._route(xt, pt, cfg.topk_experts)
    _, keep = moe.dispatch_slots(eidx, cfg.n_experts, moe.capacity(T, cfg))
    k = cfg.topk_experts
    e_flat = eidx.reshape(-1)
    return {(i // k, int(e_flat[i])) for i in range(e_flat.numel()) if not bool(keep[i])}


def _close(got, want):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got - want)
    assert diff.max() <= 2.0**-7 * np.abs(want).max(), diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()


@pytest.mark.parametrize("cf, arch", [
    pytest.param(1.25, ARCH, id="1.25"), pytest.param(0.5, ARCH, id="0.5"),
    pytest.param(1.25, E128, id="1.25-e128"), pytest.param(0.5, E128, id="0.5-e128"),
])
def test_moe_apply_matches_reference(request, cf, arch):
    xj, p, xt, pt = request.getfixturevalue("inputs" if arch == ARCH else "inputs_e128")
    jc, tc = _cfgs(cf, arch)
    yj, auxj = jax.jit(lambda x, p: jmoe.moe_apply(x, p, jc))(xj, p)
    yt, auxt = moe.moe_apply(xt, pt, tc)
    dropped = _port_dropped(xt, pt, tc)
    assert dropped == _ref_dropped(xj, p, jc)
    # granite: 0.5 drops slots, 1.25 none here; 128 experts drop at both
    assert (len(dropped) > 0) == (cf < 1 or arch == E128)
    _close(yt, yj)
    assert abs(float(auxt) - float(auxj)) <= 1e-6


def _masked_matches(inputs, arch, cf=1.25):
    xj, p, xt, pt = inputs
    jc, tc = _cfgs(cf, arch)
    yj, auxj = jax.jit(lambda x, p: jmoe.moe_apply_masked(x, p, jc))(xj, p)
    yt, auxt = moe.moe_apply_masked(xt, pt, tc)
    _close(yt, yj)
    assert abs(float(auxt) - float(auxj)) <= 1e-6


def test_moe_apply_masked_matches_reference(inputs):
    _masked_matches(inputs, ARCH)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_masked_matches_reference_e128(inputs_e128, cf):
    """``moe_apply_masked`` at 128 experts, top-8, at both capacity factors
    (the masked path drops nothing: its output is the same at both)."""
    _masked_matches(inputs_e128, E128, cf)


def test_masked_equals_scatter_when_nothing_drops(inputs):
    _, _, xt, pt = inputs
    _, tc = _cfgs(1.25)
    assert not _port_dropped(xt, pt, tc)
    ys, auxs = moe.moe_apply(xt, pt, tc)
    ym, auxm = moe.moe_apply_masked(xt, pt, tc)
    # each element within one bf16 step of the largest output; about half
    # of them differ by a step, as the reference's own two paths do on these
    # inputs (the gate multiplies before or after the expert's last matmul)
    diff = (ys.float() - ym.float()).abs()
    assert float(diff.max()) <= 2.0**-7 * float(ys.float().abs().max())
    assert float(auxs) == float(auxm)


def test_init_moe_tree_matches_reference():
    jc, tc = _cfgs(1.25)
    L = tc.n_layers
    jtree = jax.eval_shape(lambda r: jax.vmap(lambda k: jmoe.init_moe(k, jc))(
        jax.random.split(r, L)), jax.random.PRNGKey(0))
    ttree = moe.init_moe(torch.Generator().manual_seed(0), tc, n=L, device="cpu")
    assert {k: tuple(v.shape) for k, v in ttree.items()} == {
        k: tuple(v.shape) for k, v in jtree.items()}
    assert all(v.dtype == torch.float32 for v in ttree.values())
    # the whole model tree too: "moe" where a dense layer has "mlp"
    jp = jax.eval_shape(jtransformer.build(jc).init, jax.random.PRNGKey(0))
    bundle = transformer.build(tc, device="cpu")
    tp = bundle.init(0)
    shapes = lambda tree, f: {k: shapes(v, f) if isinstance(v, dict) else f(v)
                              for k, v in tree.items()}
    assert shapes(tp, lambda a: tuple(a.shape)) == shapes(jp, lambda a: tuple(a.shape))
    # the compute copy casts the experts to bf16 and keeps the router f32
    cm = bundle.compute_params(tp)["layers"]["moe"]
    assert cm["router"].dtype == torch.float32 and cm["w1"].dtype == torch.bfloat16
    # expert parallelism over two expert shards of a CPU mesh, on layer 0's
    # weights: with nothing dropped (capacity 8.0) moe_apply's y within
    # 1e-6 (f32 sum order) and its aux exactly (one token shard)
    jc8, tc8 = _cfgs(8.0)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((24, tc8.d_model))
                         .astype(np.float32))
    p0 = {k: v[0] for k, v in ttree.items()}
    y, aux = moe.moe_apply(x, p0, tc8)
    ye, auxe = moe.moe_apply_ep(x, p0, tc8, mesh=make_mesh((2,), ("model",), device="cpu"),
                                token_axes=("data",))
    assert float((y - ye).abs().max()) <= 1e-6 and float(aux) == float(auxe)
