"""Port parity of the two kernels on the main path, through their plain
PyTorch versions (what a wrapper runs on a CPU tensor).

K1 ``fier_retrieve`` is held three ways:

* its per-token scores to the reference ``score_block`` expression,
  evaluated op by op (dequantized key rounded to bf16, f32 dot):
  |Δ| <= D·2^-23·Σ_d|q_d|·max|a| (the same exact products, summed in
  another order);
* its selection to the reference threshold select (``topk_threshold_hm``
  + ``compact_indices``, interpret mode) over the *same* masked scores:
  idx, τ and m exactly equal;
* end to end to ``fused_retrieve_hm(interpret=True)``: the same index set
  except positions whose score lies within ε of τ.  Compiled for the CPU,
  XLA keeps the kernel's dequantized key in f32 instead of rounding it to
  bf16 (ROADMAP Queue 3), which moves a score by at most
  2^-9·Σ_d|q_d|·|a_d|; ε is twice that bound.

K2 ``fier_attend_selected`` is held to ``fused_sparse_attention_hm``
(interpret mode) within 1e-5·max|out| (f32 softmax, other summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import CacheView as JView
from repro.core.quantize import quantize as jquantize
from repro.kernels import ops as jops
from repro.kernels.fier_score import score_block as jscore_block
from repro.kernels.fused_retrieval import fused_retrieve_hm
from repro.kernels.sparse_attention import fused_sparse_attention_hm
from repro_torch.core.policy import CacheView
from repro_torch.core.quantize import QuantizedKeys
from repro_torch.kernels import fused_retrieval as fr
from repro_torch.kernels import launch_counts, ops, sparse_attention as sa
from repro_torch.kernels.check import selection_agrees
from repro_torch.kernels.topk_select import _sortable_keys, _unsortable


def _t(a):
    """jax/numpy array → torch tensor (bf16 via f32, exact)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _case(B, S, Hkv, rep, D, g, seed):
    rng = np.random.default_rng(seed)
    ch = np.exp(rng.standard_normal(D)).astype(np.float32)
    K = jnp.asarray((rng.standard_normal((B, S, Hkv, D)) * ch).astype(np.float32)).astype(jnp.bfloat16)
    V = jnp.asarray(rng.standard_normal((B, S, Hkv, D)).astype(np.float32)).astype(jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((B, Hkv, rep, D)).astype(np.float32)).astype(jnp.bfloat16)
    return q, K, V, jquantize(K, g)


def _hm(a, B, Hkv, D):
    return jnp.moveaxis(a, 2, 1).reshape(B * Hkv, a.shape[1], D)


def _bound(q, qk, rep):
    """max over rows of rep · Σ_d |q_d| · max|a| — bounds Σ |q_d a_d|."""
    amax = float(jnp.max(jnp.abs(qk.scale.astype(jnp.float32)) + jnp.abs(qk.zero.astype(jnp.float32))))
    return rep * float(jnp.max(jnp.sum(jnp.abs(q.astype(jnp.float32)), -1))) * amax


# B, S, Hkv, rep, D, g, budget, lengths, reduce, sink, recent
K1_CASES = [
    (2, 256, 2, 1, 16, 32, 64, (256, 150), "max", 4, 8),
    (2, 128, 2, 2, 32, 16, 32, (128, 100), "sum", 0, 0),
    (1, 128, 1, 4, 32, 32, 128, (128,), "max", 0, 0),        # budget == S
    (2, 128, 2, 4, 16, 8, 64, (40, 128), "sum", 4, 16),      # budget > length
    (1, 192, 3, 2, 16, 32, 48, (192,), "max", 2, 0),
]


@pytest.mark.parametrize("B,S,Hkv,rep,D,g,budget,lens,reduce,sink,recent", K1_CASES)
def test_k1_plain_matches_reference(B, S, Hkv, rep, D, g, budget, lens, reduce, sink, recent):
    q, K, V, qk = _case(B, S, Hkv, rep, D, g, seed=S + rep + D)
    lengths = jnp.asarray(lens, jnp.int32)
    tq, tcodes, tscale, tzero = _t(q), _t(qk.codes), _t(qk.scale), _t(qk.zero)
    sel = dict(group=g, group_reduce=reduce, sink=sink, recent=recent)
    idx, tau, m = fr.fier_retrieve(tq, tcodes, tscale, tzero, _t(lengths), budget, **sel)
    assert launch_counts()["fier_retrieve"] == 0  # CPU tensors run the plain version
    bound = _bound(q, qk, rep)

    # (1) scores: the score_block expression, op by op
    s = fr.retrieval_scores(tq, tcodes, tscale, tzero, group=g)  # [B, Hkv, rep, S]
    want = jscore_block(
        q.reshape(B * Hkv, rep, D)[0], _hm(qk.codes, B, Hkv, D)[0],
        _hm(qk.scale, B, Hkv, D)[0], _hm(qk.zero, B, Hkv, D)[0], group=g,
    )
    np.testing.assert_allclose(
        s[0, 0].numpy(), np.asarray(want), rtol=0, atol=D * 2.0**-23 * bound
    )

    # (2) selection over the same masked scores: exactly the reference's
    kv = fr.masked_kv(s, _t(lengths), sink, recent, reduce)
    j_idx = jops.topk_select(jnp.asarray(kv.numpy()), budget)  # kv already masked
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))

    # (3) end to end against the interpret-mode kernel
    lens_bh = jnp.repeat(lengths, Hkv)
    r_idx, r_tau, r_m = fused_retrieve_hm(
        q.reshape(B * Hkv, rep, D), _hm(qk.codes, B, Hkv, D), _hm(qk.scale, B, Hkv, D),
        _hm(qk.zero, B, Hkv, D), lens_bh, budget, interpret=True, **sel,
    )
    eps = 2 * (2.0**-9 + D * 2.0**-23) * bound
    ok, ndiff = selection_agrees(
        idx.reshape(B * Hkv, budget), torch.from_numpy(np.array(r_idx)),
        tau.reshape(-1), torch.from_numpy(np.array(r_tau)),
        m.reshape(-1), torch.from_numpy(np.array(r_m)), kv.reshape(B * Hkv, S), eps,
    )
    assert ok, f"{ndiff} indices differ outside the ε={eps:.3g} band around τ"


def test_sortable_keys_roundtrip_and_order():
    x = torch.tensor([-np.inf, -1e30, -2.5, -0.0, 0.0, 1e-38, 3.0, np.inf], dtype=torch.float32)
    k = _sortable_keys(x)
    assert bool((k[1:] >= k[:-1]).all()) and int(k[3]) == int(k[4])  # -0 == +0
    back = _unsortable(k)
    np.testing.assert_array_equal(back.numpy(), torch.where(x == 0, 0.0, x).numpy())


@pytest.mark.parametrize("B,S,Hkv,rep,D,budget", [(2, 128, 2, 1, 32, 32), (2, 64, 2, 4, 16, 64)])
def test_k2_plain_matches_reference(B, S, Hkv, rep, D, budget):
    q, K, V, _ = _case(B, S, Hkv, rep, D, 8, seed=budget + rep)
    rng = np.random.default_rng(rep)
    idx = np.stack([rng.permutation(S)[:budget] for _ in range(B * Hkv)]).reshape(B, Hkv, budget)
    lengths = np.array([S, S // 2 + 3][:B], np.int32)  # row 1: masked slots
    valid = idx < lengths[:, None, None]
    assert not valid.all()
    want = fused_sparse_attention_hm(
        q, K, V, jnp.asarray(idx, jnp.int32),
        jnp.asarray(valid[:, :, None, :].astype(np.int8)), interpret=True,
    )
    got = sa.fier_attend_selected(
        _t(q), _t(K), _t(V), torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(lengths)
    )
    assert got.dtype == torch.float32 and launch_counts()["fier_attend_selected"] == 0
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("Hkv,rep,reduce", [(2, 1, "max"), (1, 4, "sum")])
def test_fier_decode_one_pass_matches_reference(Hkv, rep, reduce):
    """The slab pipeline against ``repro.kernels.ops.fier_decode_one_pass``:
    the retrieved sets agree up to the ε band of K1's test; attending the
    port's selection with the reference's kernel gives the port's output to
    within one bf16 rounding."""
    B, S, D, g, budget = 2, 128, 32, 32, 32
    q4, K, V, qk = _case(B, S, Hkv, rep, D, g, seed=7 + rep)
    q = q4.reshape(B, Hkv * rep, D)
    length = jnp.asarray([S, 77], jnp.int32)
    jview = JView.slab(K, V, qk, length)
    tmeta = QuantizedKeys(_t(qk.codes), _t(qk.scale), _t(qk.zero), g)
    view = CacheView.slab(_t(K), _t(V), tmeta, _t(length))
    sel = dict(group_reduce=reduce, sink=4, recent=8)
    out = ops.fier_decode_one_pass(_t(q), view, budget, **sel)
    idx, tau, m = ops.retrieve(_t(q), view, budget, return_stats=True, **sel)
    r_idx, r_tau, r_m = jops.retrieve(q, jview, budget, return_stats=True, **sel)
    s = fr.retrieval_scores(_t(q4), tmeta.codes, tmeta.scale, tmeta.zero, group=g)
    kv = fr.masked_kv(s, _t(length), 4, 8, reduce)
    eps = 2 * (2.0**-9 + D * 2.0**-23) * _bound(q4, qk, rep)
    ok, _ = selection_agrees(
        idx.reshape(B * Hkv, budget), _t(r_idx).reshape(B * Hkv, budget),
        tau.reshape(-1), _t(r_tau).reshape(-1), m.reshape(-1), _t(r_m).reshape(-1),
        kv.reshape(B * Hkv, S), eps,
    )
    assert ok
    want = jops.attend_selected(q, jview, jnp.asarray(idx.numpy()))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, Hkv * rep, D)
    got, want = out.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=1e-6)


def test_wrappers_check_shapes():
    q = torch.zeros((1, 2, 1, 32), dtype=torch.bfloat16)
    codes = torch.zeros((1, 8, 2, 32), dtype=torch.uint8)
    sz = torch.zeros((1, 2, 2, 32), dtype=torch.bfloat16)
    lens = torch.tensor([64], dtype=torch.int32)
    with pytest.raises(ValueError, match="budget"):
        fr.fier_retrieve(q, codes, sz, sz, lens, 65, group=32)
    with pytest.raises(ValueError, match="scale"):
        fr.fier_retrieve(q, codes, sz[:, :1], sz, lens, 8, group=32)
    K = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="idx"):
        sa.fier_attend_selected(q, K, K, torch.zeros((1, 2, 8), dtype=torch.int64), lens)
