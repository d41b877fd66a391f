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
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
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
from repro_torch.kernels import pack_quantize as pq
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
    (2, 128, 2, 2, 64, 32, 32, (128, 90), "max", 4, 8),     # d_head 64 (granite-moe)
    (1, 128, 1, 12, 64, 32, 48, (128,), "max", 0, 0),       # rep 12 (starcoder2)
    (2, 64, 1, 16, 16, 16, 16, (64, 40), "sum", 4, 4),      # rep 16 (qwen3-moe)
    (2, 128, 2, 1, 112, 32, 32, (128, 90), "max", 4, 8),    # d_head 112 (zamba2-7b)
    (1, 128, 2, 4, 112, 32, 48, (128,), "sum", 0, 0),       # d_head 112, a GQA rep
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


@pytest.mark.parametrize("B,S,Hkv,rep,D,budget", [
    (2, 128, 2, 1, 32, 32), (2, 64, 2, 4, 16, 64),
    (2, 64, 2, 2, 64, 32),      # d_head 64
    (2, 64, 1, 12, 16, 32),     # rep 12
    (2, 64, 1, 16, 32, 48),     # rep 16
    (2, 64, 2, 1, 112, 32),     # d_head 112 (zamba2-7b)
])
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


def _keys_fit(S, C, bs):
    """Whether a C-CTA split of an S-token row keeps its keys in shared memory."""
    T = -(-(-(-S // 32)) // C) * 32
    table = 4 * ((T + bs - 1) // bs + 1) if bs else 0
    return fr.smem_static(128, 1) + 4 * T + table <= fr.SMEM_LIMIT


@pytest.mark.parametrize("bs", [None, 32, 8])
@pytest.mark.parametrize("rows", [1, 16, 64])
@pytest.mark.parametrize("S", [32, 96, 8160, 8192, 65536, 367392, 378880, 378912, 524288])
def test_retrieval_plan_splits_rows(S, rows, bs):
    """K1/K3's split of a row over a cluster: the CTAs' token ranges cover
    [0, S) in rank order without overlap or an empty CTA, each CTA's shared
    memory fits the 232,448 bytes of sm_90, the grid runs in one wave of
    one CTA per SM on 132 SMs and fills them as far as a power of two up to
    4 allows, and the long-row path (keys in device memory) is taken exactly
    when 8 CTAs cannot hold the row's keys."""
    plan = fr.retrieval_plan(S, rows, 132, bs, d_head=128, rep=1)
    C, T = plan.cluster, plan.cta_tokens
    assert C in (1, 2, 4, 8) and T % 32 == 0 and C * T >= S
    ranges = plan.ranges(S)
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(t0 % 32 == 0 and t0 < t1 for t0, t1 in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert fr.smem_static(128, 1) + plan.smem_bytes <= 232448
    assert plan.smem_keys == _keys_fit(S, 8, bs)
    if plan.smem_keys:
        assert plan.smem_bytes >= 4 * T
    if plan.smem_keys and rows * C > 132:  # more than one wave only where memory needs it
        assert C == 1 or not _keys_fit(S, C // 2, bs)
    if rows * 2 * C <= 132 and C < fr.FILL_CLUSTER:  # narrower only where wider leaves a CTA empty
        assert (2 * C - 1) * (-(-(-(-S // 32)) // (2 * C)) * 32) >= S


def test_wrapper_takes_rows_beyond_one_block():
    """Rows longer than one CTA's shared memory (once a ~56k-token limit)
    pass the wrapper's checks: S = 65,536 runs (here, on the CPU, through
    the plain version) and plans a shared-memory split; long_500k plans the
    long-row path."""
    assert not hasattr(fr, "MAX_ROW_TOKENS")
    S, D = 65536, 16
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 1, 1, D)).astype(np.float32)).to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, 256, (1, S // 8, 1, D), dtype=np.uint8))
    scale = torch.from_numpy(rng.random((1, S // 32, 1, D)).astype(np.float32) + 0.5)
    zero = torch.from_numpy(rng.standard_normal((1, S // 32, 1, D)).astype(np.float32))
    scale, zero = scale.to(torch.bfloat16), zero.to(torch.bfloat16)
    lens = torch.tensor([S - 5], dtype=torch.int32)
    sel = dict(group=32, sink=4, recent=64)
    idx, tau, m = fr.fier_retrieve(q, codes, scale, zero, lens, 4096, **sel)
    want = fr.fier_retrieve_plain(q, codes, scale, zero, lens, 4096, **sel)
    assert all(torch.equal(a, b) for a, b in zip((idx, tau, m), want))
    assert tuple(idx.shape) == (1, 1, 4096) and int(idx.max()) < S - 5
    assert fr.retrieval_plan(S, 64, 132, d_head=128, rep=1).smem_keys
    assert fr.retrieval_plan(S, 64, 132, 32, d_head=128, rep=1).smem_keys
    assert not fr.retrieval_plan(524288, 16, 132, d_head=128, rep=1).smem_keys


@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("budget", [32, 512, 1000, 1024, 4096])
@pytest.mark.parametrize("rows", [1, 16, 64])
def test_attend_plan_splits_slots(rows, budget, rep):
    """K2/K4/K8's split of a row's slots over a cluster: the CTAs' ranges
    cover [0, budget) exactly once in rank order, no CTA is empty unless
    budget < C, C ≤ 8, the grid runs in one wave of one CTA per SM on 132
    SMs wherever it splits, each CTA's shared memory fits the 232,448 bytes
    of sm_90 and holds its chunk's rows, and nothing of the address policy
    enters the plan: the same arguments give the same plan, whether K2, K4
    or K8 asks."""
    import inspect

    plan = sa.attend_plan(budget, rows, 132, rep, 128)
    C = plan.cluster
    assert C in (1, 2, 4, 8) and C <= sa.MAX_CLUSTER
    ranges = plan.ranges(budget)
    assert len(ranges) == C and ranges[0][0] == 0 and ranges[-1][1] == budget
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    covered = np.concatenate([np.arange(s0, s1) for s0, s1 in ranges])
    np.testing.assert_array_equal(covered, np.arange(budget))
    assert budget < C or all(s1 > s0 for s0, s1 in ranges)
    assert plan.smem_bytes <= sa.SMEM_LIMIT
    assert plan.chunk == min(max(s1 - s0 for s0, s1 in ranges), sa.MAX_CHUNK)
    assert plan.smem_bytes == sa.RING_BYTES + C * rep * (128 + 2) * 4 + 4 * plan.chunk
    assert C == 1 or rows * C <= 132  # one wave wherever it splits
    step = sa.step(128, rep)
    assert all(s1 - s0 >= step for s0, s1 in ranges) or C == 1
    if C < sa.MAX_CLUSTER and budget >= 2 * C * step:  # wider only beyond one wave
        assert rows * 2 * C > 132
    assert list(inspect.signature(sa.attend_plan).parameters) == [
        "budget", "rows", "n_sm", "rep", "d_head"]
    assert sa.attend_plan(budget, rows, 132, rep, 128) == plan


@pytest.mark.parametrize("rep", [1, 2, 4, 8, 3, 5, 16])
def test_attend_kernel_admits_reps(rep):
    """The CUDA kernel has one fixed instantiation per (d_head, rep) in
    KERNEL_HEAD_DIMS x KERNEL_REPS (rep 16 and d_heads 64, 32, 16 among
    them); any other rep (3, 5) takes a generic instantiation whose block of
    query heads is the next power of two.  The wrapper's operand check
    admits every rep and every d_head that is a multiple of 8 up to 256
    (96 among them), and refuses d_head 100 with the reason (the plain
    version on the CPU takes it)."""
    q = torch.zeros((1, 2, rep, 128), dtype=torch.float32)
    K = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16)
    for D in (128, 64, 32, 16):
        sa.check_kernel_operands(q[..., :D], K[..., :D], K[..., :D])
        C = sa.attend_plan(64, 2, 132, rep, D).cluster  # each CTA a whole step
        assert C == 1 or C * sa.step(D, rep) <= 64
        assert sa.fixed_shape(D, rep) == (rep in sa.KERNEL_REPS)
        assert sa.head_block(D, rep) == (rep if rep in sa.KERNEL_REPS
                                         else 1 << (rep - 1).bit_length())
    sa.check_kernel_operands(q[..., :96], K[..., :96], K[..., :96])
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
        sa.check_kernel_operands(q[..., :100], K[..., :100], K[..., :100])
    with pytest.raises(ValueError, match="bf16"):
        sa.check_kernel_operands(q, K.float(), K)
    idx = torch.zeros((1, 2, 8), dtype=torch.int32)
    out = sa.fier_attend_selected(q, K, K, idx, torch.tensor([64], dtype=torch.int32))
    assert tuple(out.shape) == (1, 2, rep, 128)


@pytest.mark.parametrize("d_head,rep", [(64, 1), (64, 2), (64, 16), (128, 12), (128, 16)])
@pytest.mark.parametrize("rows", [8, 32, 144])
def test_plans_fit_new_shapes(d_head, rep, rows):
    """K1/K3's and K2/K4/K8's plans at the d_heads and reps this slice
    instantiates: each CTA's shared memory (the instantiation's static part,
    ``smem_static``, plus the plan's dynamic part) fits sm_90's 232,448
    bytes; the serving instantiation's static count stays 43,008; K2's step
    follows d_head (2048/d_head lane groups x 4 slots, halved above rep 8,
    where two lane groups share a slot's rows) while its ring stays 96 KiB;
    and the split still covers every slot once."""
    assert fr.smem_static(128, 1) == fr.smem_static(128, 8) == 43008
    assert fr.smem_static(d_head, rep) > fr.smem_static(d_head, 1) or d_head == 64
    for S, bs in ((8192, None), (8192, 32), (65536, None)):
        plan = fr.retrieval_plan(S, rows, 132, bs, d_head=d_head, rep=rep)
        assert plan.smem_keys and fr.smem_static(d_head, rep) + plan.smem_bytes <= fr.SMEM_LIMIT
    assert sa.step(d_head, rep) == 4 * (2048 // d_head) // (2 if rep > 8 else 1)
    assert sa.step(64, 1) == 2 * sa.step(128, 1) == 128
    for budget in (512, 1000, 1024, 8192):
        plan = sa.attend_plan(budget, rows, 132, rep, d_head)
        recv = plan.cluster * rep * (d_head + 2) * 4
        assert plan.smem_bytes == sa.RING_BYTES + recv + 4 * plan.chunk <= sa.SMEM_LIMIT
        covered = np.concatenate([np.arange(a, b) for a, b in plan.ranges(budget)])
        np.testing.assert_array_equal(covered, np.arange(budget))
    fr.check_kernel_shape(96, 1)  # generic layouts: any multiple of 8 up to 256, any rep
    fr.check_kernel_shape(128, 17)
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
        fr.check_kernel_shape(100, 1)
    with pytest.raises(ValueError, match="at least 1"):
        fr.check_kernel_shape(128, 0)


@pytest.mark.parametrize("rows", [8, 128, 144])
def test_plans_fit_d112(rows):
    """d_head 112 (zamba2-7b's shared attention block): K1/K3/K6 take any
    rep up to 16 (the scoring warp's 28 active lanes own 4 channels each, so
    the static shared memory counts 128's 16-entry tables: 46,080 B at
    every rep), while K2/K4/K8 have a fixed instantiation at rep 1 only, on
    16-lane row groups (two lanes idle), so their step and ring are 128's;
    another rep there takes the generic layout of class 128."""
    assert fr.smem_static(112, 1) == fr.smem_static(112, 16) == 46080
    for S, bs in ((8192, None), (8192, 32), (65536, None)):
        for rep in (1, 4, 16):
            plan = fr.retrieval_plan(S, rows, 132, bs, d_head=112, rep=rep)
            assert plan.smem_keys and 46080 + plan.smem_bytes <= fr.SMEM_LIMIT
    fr.check_kernel_shape(112, 4)
    assert sa.lanes_per_row(112) == sa.lanes_per_row(128) == 16 == 2 * sa.lanes_per_row(64)
    assert sa.step(112, 1) == sa.step(128, 1) == 64
    for budget in (512, 1000, 1024, 8192):
        plan = sa.attend_plan(budget, rows, 132, 1, 112)
        assert plan == sa.attend_plan(budget, rows, 132, 1, 128)._replace(
            smem_bytes=plan.smem_bytes)
        assert plan.smem_bytes == sa.RING_BYTES + plan.cluster * 114 * 4 + 4 * plan.chunk
    plan = sa.attend_plan(1024, rows, 132, 2, 112)
    assert not sa.fixed_shape(112, 2) and sa.row_stride(112, 2) == 128
    assert plan.smem_bytes == sa.RING_BYTES + plan.cluster * 2 * 130 * 4 + 4 * plan.chunk
    q = torch.zeros((1, 2, 4, 112))
    K = torch.zeros((1, 64, 2, 112), dtype=torch.bfloat16)
    sa.check_kernel_operands(q, K, K)
    sa.check_kernel_operands(q[:, :, :1], K, K)


@pytest.mark.parametrize("rep", [1, 2, 16])
@pytest.mark.parametrize("d_head", [16, 32])
def test_plans_fit_small_heads(d_head, rep):
    """d_head 16 (every reduced config) and 32 (reduced zamba2-7b, the
    examples' bench model): the scoring warp's lanes own one channel each
    (2-entry tables; at 16 lanes 16-31 idle), so K1/K3/K6's static shared
    memory counts 12,288 B at 32 and 11,264 at 16 at every rep, as the .cu
    asserts; K1/K3's split covers [0, S) once at the examples' S 64 and 264
    and the main path's 8192 and fits sm_90; K2/K4/K8 take 8-lane row groups
    as at 64, so their step is 64's and their split covers every slot once;
    every CUDA wrapper admits the shape."""
    static = {16: 11264, 32: 12288}[d_head]
    assert fr.smem_static(d_head, rep) == fr.smem_static(d_head, 1) == static
    fr.check_kernel_shape(d_head, rep)
    sa.check_kernel_shape(d_head, rep)
    pq.check_head_dim(d_head)
    for S, bs in ((64, None), (64, 8), (264, None), (264, 8), (8192, None), (8192, 32)):
        for rows in (1, 8, 64):
            plan = fr.retrieval_plan(S, rows, 132, bs, d_head=d_head, rep=rep)
            assert plan.smem_keys and fr.smem_static(d_head, rep) + plan.smem_bytes <= fr.SMEM_LIMIT
            covered = np.concatenate([np.arange(a, b) for a, b in plan.ranges(S)])
            np.testing.assert_array_equal(covered, np.arange(S))
    assert sa.lanes_per_row(d_head) == sa.lanes_per_row(64) == 8
    assert sa.step(d_head, rep) == sa.step(64, rep) == (128 if rep <= 8 else 64)
    for budget in (16, 24, 32, 512, 1024, 8192):
        for rows in (4, 8, 64):
            plan = sa.attend_plan(budget, rows, 132, rep, d_head)
            recv = plan.cluster * rep * (d_head + 2) * 4
            assert plan.smem_bytes == sa.RING_BYTES + recv + 4 * plan.chunk <= sa.SMEM_LIMIT
            covered = np.concatenate([np.arange(a, b) for a, b in plan.ranges(budget)])
            np.testing.assert_array_equal(covered, np.arange(budget))
