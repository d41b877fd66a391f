"""Port parity of the training path's layers: the GeLU repair, flash
attention's forward and blockwise backward against the JAX package, and
rematerialisation (``tests/test_torch_train_families.py`` holds every
family's ``train_loss`` and gradients to the reference's).

Inputs are made from a seed with numpy; weights cross with
``params_from_jax``.  Flash attention's tolerance, relative to the largest
magnitude of the reference tensor: 5e-6 in f32 (measured up to 6.6e-7; the
two packages' f32 matmuls sum in other orders), 1e-2 in bf16 (measured up
to 8.7e-4: a dq/dk element one bf16 step apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import make_train_batch as j_make_train_batch
from repro.models import build_model as j_build_model
from repro.models import layers as jl
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import layers as tl

_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(ref, got) -> float:
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.detach().to(torch.float32).numpy()
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


# --------------------------------------------------------------------- GeLU

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_mlp_matches_reference(dtype):
    """``mlp_apply(act="gelu")`` is the reference's tanh-form GeLU MLP: bit
    for bit in bf16, within 1e-6 of max|out| in f32 (the erf form missed by
    up to 4.7e-4 in f32 and on about half of the bf16 outputs)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    p = {"w1": (rng.standard_normal((64, 128)) * 64**-0.5).astype(np.float32),
         "w2": (rng.standard_normal((128, 64)) * 128**-0.5).astype(np.float32)}
    ref = jax.jit(jl.mlp_apply, static_argnums=2)(
        jnp.asarray(x, _J[dtype]), {k: jnp.asarray(v) for k, v in p.items()}, "gelu")
    got = tl.mlp_apply(torch.from_numpy(x).to(_T[dtype]),
                       {k: torch.from_numpy(v) for k, v in p.items()}, "gelu")
    if dtype == "bfloat16":
        np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)),
                                      got.to(torch.float32).numpy())
    else:
        assert _rel(ref, got) <= 1e-6


# ---------------------------------------------------------- flash attention

# (B, Sq, Sk, Hkv, rep, D, causal, bias_mask, q_offset, block_k)
FLASH_CASES = {
    "causal": (2, 96, 96, 2, 1, 16, True, False, 0, 32),
    "bias_mask_rep2_ragged_offset": (2, 96, 100, 2, 2, 16, True, True, 4, 32),
    "sq_over_512": (1, 600, 600, 1, 2, 16, True, False, 0, 128),
    "cross_ragged": (2, 40, 70, 2, 2, 16, False, True, 0, 32),
}


def _flash_inputs(B, Sq, Sk, Hkv, rep, D, bias):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, Sq, Hkv * rep, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hkv * rep, D)).astype(np.float32)
    bm = (np.arange(Sk)[None] < np.array([Sk, Sk - 5])[:B, None]) if bias else None
    return q, k, v, do, bm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_reference_vjp(case, dtype):
    """Output and (dq, dk, dv) against ``jax.vjp`` of the reference's
    ``flash_attention`` (its custom VJP): causal, a key-padding mask, GQA
    rep 2, a ragged key count (not a multiple of block_k), a query offset,
    more than one 512-row query block, and non-causal cross-attention."""
    B, Sq, Sk, Hkv, rep, D, causal, bias, q_offset, block_k = FLASH_CASES[case]
    q, k, v, do, bm = _flash_inputs(B, Sq, Sk, Hkv, rep, D, bias)
    kw = dict(causal=causal, block_k=block_k, q_offset=q_offset)
    out, vjp = jax.vjp(
        lambda a, b, c: jl.flash_attention(a, b, c, bias_mask=None if bm is None else
                                           jnp.asarray(bm), **kw),
        *(jnp.asarray(x, _J[dtype]) for x in (q, k, v)))
    refs = (out,) + tuple(vjp(jnp.asarray(do, _J[dtype])))
    tq, tk, tv = (torch.from_numpy(x).to(_T[dtype]).requires_grad_() for x in (q, k, v))
    tout = tl.flash_attention(tq, tk, tv, bias_mask=None if bm is None else torch.from_numpy(bm),
                              **kw)
    got = (tout,) + torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do).to(_T[dtype]))
    tol = 5e-6 if dtype == "float32" else 1e-2
    errs = [_rel(r, g) for r, g in zip(refs, got)]
    assert max(errs) <= tol, errs


def test_flash_backward_matches_dense_oracle_and_sees_a_planted_fault():
    """In the port alone: the Function's gradients equal autograd through
    ``attention_ref`` (f32, 1e-5), and dropping the softmax backward's
    diagonal term Dterm (a planted fault) is caught far above that."""
    q, k, v, do, bm = _flash_inputs(2, 80, 90, 2, 2, 16, True)
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    kw = dict(causal=True, q_offset=10, bias_mask=torch.from_numpy(bm))
    g_flash = torch.autograd.grad(tl.flash_attention(*args, block_k=32, **kw), args,
                                  torch.from_numpy(do))
    g_ref = torch.autograd.grad(tl.attention_ref(*args, **kw), args, torch.from_numpy(do))
    for a, b in zip(g_ref, g_flash):
        assert float((a - b).abs().max() / a.abs().max()) <= 1e-5
    orig = tl._flash_bwd_block

    def no_dterm(q_, k_, v_, out, *rest):
        return orig(q_, k_, v_, torch.zeros_like(out), *rest)

    tl._flash_bwd_block = no_dterm
    try:
        g_bad = torch.autograd.grad(tl.flash_attention(*args, block_k=32, **kw), args,
                                    torch.from_numpy(do))
    finally:
        tl._flash_bwd_block = orig
    assert float((g_ref[0] - g_bad[0]).abs().max() / g_ref[0].abs().max()) > 1e-2


# --------------------------------------------------------------- train_loss

def torch_batch(batch: dict, device="cpu") -> dict:
    """A JAX batch as torch tensors (bf16 leaves via f32, exactly)."""
    out = {}
    for key, v in batch.items():
        a = np.asarray(jnp.asarray(v).astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
        t = torch.from_numpy(np.array(a))
        out[key] = (t.to(torch.bfloat16) if v.dtype == jnp.bfloat16 else t).to(device)
    return out


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, pre + (k,))
    else:
        yield pre, tree


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m", "mamba2-370m",
                                  "zamba2-7b", "whisper-small"])
def test_remat_on_equals_remat_off(arch):
    """Rematerialising each layer changes what the backward keeps, not what
    it computes: the loss and every gradient equal bit for bit."""
    cfg = reduced_config(arch)
    jb = j_build_model(j_reduced_config(arch))
    batch = torch_batch(j_make_train_batch(j_reduced_config(arch), ShapeConfig("t", 32, 2,
                                                                                "train"), 0))
    np_params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(1)))
    out = []
    for remat in (True, False):
        params = params_from_jax(np_params, cfg, device="cpu")
        leaves = [t.requires_grad_() for _, t in _paths(params)]
        loss, _ = build_model(cfg, device="cpu", remat=remat).train_loss(params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
