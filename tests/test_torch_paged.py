"""Port parity of the paged KV pool and its two kernels, through their plain
PyTorch versions (what a wrapper runs on a CPU tensor).

* ``paged_append_kv`` + ``paged_append_token_metadata`` against
  ``repro.kvcache.paged``'s: the pools are equal bit for bit.
* scratch writes of several slots that share one null-block row: the
  last slot's token wins, as in the reference.
* K3 (``fier_retrieve`` with a ``block_table``) on a permuted pool with a
  null-block hole inside a row's length: *identical* (idx, τ, m) to K1's plain version on
  the table-gathered slab, and, against the interpret-mode
  ``paged_fused_retrieve_hm``, the same index set except positions whose
  score lies within ε of τ — XLA keeps the dequantized key in f32 where
  ``score_block`` rounds it to bf16 (ROADMAP Queue 3), ε as in
  ``test_torch_kernels.py``.
* K4 (``fier_attend_selected`` with a ``block_table``): bit for bit K2's
  plain version on the gathered slab, and within 1e-5·max|out| of
  ``paged_fused_sparse_attention_hm`` (f32 softmax, other summation order).
* ``BlockAllocator`` + ``PrefixTree`` against the JAX package's, driven by
  one seeded sequence of alloc/free/register/lookup/TTL-expiry operations:
  equal ``stats()`` after every operation and clean audits.
"""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import PolicyConfig as JPolicy
from repro.core.quantize import QuantizedKeys as JQK
from repro.core.quantize import quantize as jquantize
from repro.kernels.fused_retrieval import paged_fused_retrieve_hm
from repro.kernels.sparse_attention import paged_fused_sparse_attention_hm
from repro.kvcache import paged as jpaged
from repro_torch.core.policy import CacheView, PolicyConfig
from repro_torch.core.quantize import QuantizedKeys
from repro_torch.kernels import fused_retrieval as fr
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import sparse_attention as sa
from repro_torch.kernels.check import selection_agrees
from repro_torch.kvcache import paged


def _t(a):
    """jax/numpy array → torch tensor (bf16 via f32, exact)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pool_case(B, S, Hkv, rep, D, g, bs, seed, hole=True):
    """Random slab contents scattered into a permuted pool with spare blocks;
    with ``hole``, one table entry of row 0 (inside its length) points at
    the null block 0, which holds non-zero data.  Returns (q, pools, table,
    gathered slabs) as jax arrays."""
    rng = np.random.default_rng(seed)
    ch = np.exp(rng.standard_normal(D)).astype(np.float32)
    K = jnp.asarray((rng.standard_normal((B, S, Hkv, D)) * ch).astype(np.float32)).astype(jnp.bfloat16)
    V = jnp.asarray(rng.standard_normal((B, S, Hkv, D)).astype(np.float32)).astype(jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((B, Hkv, rep, D)).astype(np.float32)).astype(jnp.bfloat16)
    qk = jquantize(K, g)
    nb = S // bs
    N = 1 + B * nb + 3
    perm = 1 + rng.permutation(N - 1)[: B * nb]
    table = perm.reshape(B, nb).astype(np.int32)
    if hole:
        table[0, nb // 2] = 0

    def to_pool(a, fill):
        pb = a.shape[1] // nb
        pool = np.zeros((N, pb, *a.shape[2:]), np.float32 if a.dtype == jnp.bfloat16 else a.dtype)
        pool[0] = fill(pool[0].shape)
        pool[perm] = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a).reshape(
            B * nb, pb, *a.shape[2:])
        return jnp.asarray(pool).astype(a.dtype)

    noise = lambda shape: rng.standard_normal(shape).astype(np.float32)
    pools = dict(
        k=to_pool(K, noise), v=to_pool(V, noise),
        codes=to_pool(qk.codes, lambda shape: rng.integers(1, 256, shape).astype(np.uint8)),
        scale=to_pool(qk.scale, lambda shape: np.abs(noise(shape)) + 0.5),
        zero=to_pool(qk.zero, noise),
    )
    tab = jnp.asarray(table)
    g_ = lambda a: jpaged.gather_block_rows(a, tab)
    slab = dict(k=g_(pools["k"]), v=g_(pools["v"]),
                meta=JQK(g_(pools["codes"]), g_(pools["scale"]), g_(pools["zero"]), g))
    return q, pools, tab, slab


def _bound(q, meta, rep):
    amax = float(jnp.max(jnp.abs(meta.scale.astype(jnp.float32)) + jnp.abs(meta.zero.astype(jnp.float32))))
    return rep * float(jnp.max(jnp.sum(jnp.abs(q.astype(jnp.float32)), -1))) * amax


def test_paged_append_bitwise_equal_to_reference():
    """One token appended through the table (and its group refreshed): the
    whole pools equal the reference's bit for bit, with one slot past the
    table routed to the null block."""
    B, S, H, D, g, bs = 3, 64, 2, 16, 8, 16
    _, pools, tab, _ = _pool_case(B, S, H, 1, D, g, bs, seed=3, hole=False)
    rng = np.random.default_rng(4)
    kn = jnp.asarray(rng.standard_normal((B, 1, H, D)).astype(np.float32)).astype(jnp.bfloat16)
    vn = jnp.asarray(rng.standard_normal((B, 1, H, D)).astype(np.float32)).astype(jnp.bfloat16)
    length = jnp.asarray([17, 40, S], jnp.int32)  # slot 2 is full: null block
    meta = JQK(pools["codes"], pools["scale"], pools["zero"], g)
    jcfg, tcfg = JPolicy(kind="fier", group=g), PolicyConfig(kind="fier", group=g)

    jk, jv = jpaged.paged_append_kv(pools["k"], pools["v"], kn, vn, tab, length)
    jm = jpaged.paged_append_token_metadata(meta, jk, tab, length, jcfg)

    tk, tv = _t(pools["k"]), _t(pools["v"])
    tmeta = QuantizedKeys(_t(pools["codes"]), _t(pools["scale"]), _t(pools["zero"]), g)
    out_k, out_v = paged.paged_append_kv(tk, tv, _t(kn), _t(vn), _t(tab), _t(length))
    out_m = paged.paged_append_token_metadata(tmeta, tk, _t(tab), _t(length), tcfg)
    assert out_k is tk and out_m is tmeta  # in place
    for got, want in ((tk, jk), (tv, jv), (tmeta.codes, jm.codes), (tmeta.scale, jm.scale),
                      (tmeta.zero, jm.zero)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_paged_append_repeated_null_writes_last_wins():
    """Three slots whose scratch writes share one null-block row (two full,
    one with a zeroed table row): the row holds the last slot's token, as
    in the reference's serial scatter, and the pools equal the reference's."""
    B, S, H, D, g, bs = 4, 32, 2, 16, 8, 16
    _, pools, tab, _ = _pool_case(B, S, H, 1, D, g, bs, seed=5, hole=False)
    tab = tab.at[3].set(0)  # a released slot: every entry is the null block
    rng = np.random.default_rng(6)
    kn = jnp.asarray(rng.standard_normal((B, 1, H, D)).astype(np.float32)).astype(jnp.bfloat16)
    vn = jnp.asarray(rng.standard_normal((B, 1, H, D)).astype(np.float32)).astype(jnp.bfloat16)
    length = jnp.asarray([5, S, S, 0], jnp.int32)  # slots 1-3 → null block row 0
    meta = JQK(pools["codes"], pools["scale"], pools["zero"], g)
    jk, jv = jpaged.paged_append_kv(pools["k"], pools["v"], kn, vn, tab, length)
    jm = jpaged.paged_append_token_metadata(meta, jk, tab, length, JPolicy(kind="fier", group=g))

    tk, tv = _t(pools["k"]), _t(pools["v"])
    tmeta = QuantizedKeys(_t(pools["codes"]), _t(pools["scale"]), _t(pools["zero"]), g)
    paged.paged_append_kv(tk, tv, _t(kn), _t(vn), _t(tab), _t(length))
    paged.paged_append_token_metadata(tmeta, tk, _t(tab), _t(length),
                                      PolicyConfig(kind="fier", group=g))
    assert torch.equal(tk[0, 0], _t(kn)[3, 0]) and torch.equal(tv[0, 0], _t(vn)[3, 0])
    for got, want in ((tk, jk), (tv, jv), (tmeta.codes, jm.codes), (tmeta.scale, jm.scale),
                      (tmeta.zero, jm.zero)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# B, S, Hkv, rep, D, g, bs, budget, lengths, reduce, sink, recent
PAGED_CASES = [
    (2, 256, 2, 1, 16, 32, 32, 64, (256, 150), "max", 4, 8),
    (2, 128, 2, 2, 32, 16, 16, 32, (128, 100), "sum", 0, 0),
    (1, 192, 3, 2, 16, 8, 24, 48, (192,), "max", 2, 0),      # bs not a power of two
    (2, 128, 2, 4, 16, 8, 64, 64, (100, 40), "sum", 4, 16),  # budget > length
]


@pytest.mark.parametrize("B,S,Hkv,rep,D,g,bs,budget,lens,reduce,sink,recent", PAGED_CASES)
def test_k3_plain_matches_k1_and_reference(B, S, Hkv, rep, D, g, bs, budget, lens, reduce,
                                           sink, recent):
    q, pools, tab, slab = _pool_case(B, S, Hkv, rep, D, g, bs, seed=S + rep + bs)
    lengths = jnp.asarray(lens, jnp.int32)
    sel = dict(group=g, group_reduce=reduce, sink=sink, recent=recent)
    tq, tl = _t(q), _t(lengths)
    got = fr.fier_retrieve(
        tq, _t(pools["codes"]), _t(pools["scale"]), _t(pools["zero"]), tl, budget,
        block_table=_t(tab), **sel,
    )
    assert launch_counts()["fier_retrieve_paged"] == 0  # CPU tensors run the plain version
    m = slab["meta"]
    want = fr.fier_retrieve_plain(tq, _t(m.codes), _t(m.scale), _t(m.zero), tl, budget, **sel)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    r_idx, r_tau, r_m = paged_fused_retrieve_hm(
        q, pools["codes"], pools["scale"], pools["zero"], tab, lengths, budget,
        block_size=bs, interpret=True, **sel,
    )
    s = fr.retrieval_scores(tq, _t(m.codes), _t(m.scale), _t(m.zero), group=g)
    kv = fr.masked_kv(s, tl, sink, recent, reduce)
    eps = 2 * (2.0**-9 + D * 2.0**-23) * _bound(q, m, rep)
    ok, ndiff = selection_agrees(
        got[0].reshape(B * Hkv, budget), _t(r_idx).reshape(B * Hkv, budget),
        got[1].reshape(-1), _t(r_tau).reshape(-1), got[2].reshape(-1), _t(r_m).reshape(-1),
        kv.reshape(B * Hkv, S), eps,
    )
    assert ok, f"{ndiff} indices differ outside the ε={eps:.3g} band around τ"


@pytest.mark.parametrize("B,S,Hkv,rep,D,bs,budget", [(2, 128, 2, 1, 32, 32, 32),
                                                     (2, 64, 2, 4, 16, 8, 64)])
def test_k4_plain_matches_k2_and_reference(B, S, Hkv, rep, D, bs, budget):
    q, pools, tab, slab = _pool_case(B, S, Hkv, rep, D, 8, bs, seed=budget + rep)
    rng = np.random.default_rng(rep)
    idx = np.stack([rng.permutation(S)[:budget] for _ in range(B * Hkv)]).reshape(B, Hkv, budget)
    lengths = np.array([S, S // 2 + 3][:B], np.int32)  # row 1: masked slots
    valid = idx < lengths[:, None, None]
    assert not valid.all()
    ti, tl = torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(lengths)
    got = sa.fier_attend_selected(_t(q), _t(pools["k"]), _t(pools["v"]), ti, tl,
                                  block_table=_t(tab))
    assert got.dtype == torch.float32 and launch_counts()["fier_attend_selected_paged"] == 0
    k2 = sa.fier_attend_selected_plain(_t(q), _t(slab["k"]), _t(slab["v"]), ti, tl)
    assert torch.equal(got, k2)
    want = paged_fused_sparse_attention_hm(
        q, pools["k"], pools["v"], tab, jnp.asarray(idx, jnp.int32),
        jnp.asarray(valid[:, :, None, :].astype(np.int8)), block_size=bs, interpret=True,
    )
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_paged_view_dispatch_matches_slab():
    """``ops.fier_decode_one_pass`` on a paged ``CacheView`` equals the slab
    view of the gathered contents bit for bit, and ``logical()`` gathers."""
    B, S, Hkv, rep, D, g, bs = 2, 128, 2, 2, 16, 16, 32
    q, pools, tab, slab = _pool_case(B, S, Hkv, rep, D, g, bs, seed=11)
    length = torch.tensor([128, 77], dtype=torch.int32)
    tq = _t(q).reshape(B, Hkv * rep, D)
    pmeta = QuantizedKeys(_t(pools["codes"]), _t(pools["scale"]), _t(pools["zero"]), g)
    m = slab["meta"]
    smeta = QuantizedKeys(_t(m.codes), _t(m.scale), _t(m.zero), g)
    pview = CacheView.paged(_t(pools["k"]), _t(pools["v"]), pmeta, _t(tab), length)
    sview = CacheView.slab(_t(slab["k"]), _t(slab["v"]), smeta, length)
    K, V, meta = pview.logical()
    assert torch.equal(K, sview.k) and torch.equal(meta.codes, smeta.codes)
    sel = dict(group_reduce="max", sink=4, recent=8)
    assert torch.equal(ops.fier_decode_one_pass(tq, pview, 32, **sel),
                       ops.fier_decode_one_pass(tq, sview, 32, **sel))


def test_paged_wrappers_check_shapes():
    q = torch.zeros((1, 2, 1, 32), dtype=torch.bfloat16)
    codes = torch.zeros((3, 4, 2, 32), dtype=torch.uint8)   # bs 32
    sz = torch.zeros((3, 1, 2, 32), dtype=torch.bfloat16)
    tab = torch.zeros((1, 2), dtype=torch.int32)
    lens = torch.tensor([64], dtype=torch.int32)
    with pytest.raises(ValueError, match="budget"):
        fr.fier_retrieve(q, codes, sz, sz, lens, 65, group=32, block_table=tab)
    with pytest.raises(ValueError, match="block_table"):
        fr.fier_retrieve(q, codes, sz, sz, lens, 8, group=32, block_table=tab.long())
    with pytest.raises(ValueError, match="dividing block_size"):
        fr.fier_retrieve(q, codes, sz, sz, lens, 8, group=64, block_table=tab)
    K = torch.zeros((3, 32, 2, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="idx"):
        sa.fier_attend_selected(q, K, K, torch.zeros((1, 2, 8), dtype=torch.int64), lens,
                                block_table=tab)
    with pytest.raises(ValueError, match="null block"):
        paged.init_paged_pool(1, 1, 32, 2, 8, PolicyConfig(kind="fier"), device="cpu")
    with pytest.raises(ValueError, match="divisible by group"):
        paged.init_paged_pool(1, 4, 16, 2, 8, PolicyConfig(kind="fier", group=32), device="cpu")


def test_allocator_and_prefix_tree_match_reference():
    """One seeded operation sequence through both allocators (with a TTL on
    a shared virtual clock): equal ``stats()`` and clean audits throughout."""
    rng = np.random.default_rng(0)
    clock = [0.0]
    allocs = [m.BlockAllocator(24, 8, park_ttl=30.0) for m in (jpaged, paged)]
    for a in allocs:
        a.set_clock(lambda: clock[0])
    held: list[int] = []          # block ids with a reference this test holds
    chains = [paged.block_hash_chain(rng.integers(0, 50, 40).tolist(), 8) for _ in range(6)]
    assert chains[0] == jpaged.block_hash_chain(
        [int(t) for t in np.random.default_rng(0).integers(0, 50, 40)], 8)
    for step in range(400):
        clock[0] += float(rng.integers(0, 4))
        op = rng.choice(["alloc", "free", "register", "lookup", "expire"], p=[.3, .3, .15, .2, .05])
        if op == "alloc":
            got = [a.alloc() for a in allocs]
            assert got[0] == got[1]
            if got[0] is not None:
                held.append(got[0])
        elif op == "free" and held:
            b = held.pop(int(rng.integers(len(held))))
            for a in allocs:
                a.free(b)
        elif op == "register" and held:
            b = held[int(rng.integers(len(held)))]
            chain = chains[int(rng.integers(len(chains)))]
            j = int(rng.integers(len(chain)))
            for a in allocs:
                a.register(b, chain[j], parent_key=chain[j - 1] if j else None)
        elif op == "lookup":
            chain = chains[int(rng.integers(len(chains)))]
            key = chain[int(rng.integers(len(chain)))]
            got = [a.lookup(key) for a in allocs]
            assert got[0] == got[1]
            if got[0] is not None:
                held.append(got[0])
        elif op == "expire":
            assert allocs[0].expire_parked() == allocs[1].expire_parked()
        assert allocs[0].stats() == allocs[1].stats(), step
        owners = {b: held.count(b) for b in set(held)}
        for a in allocs:
            a.audit(owners)
    st = allocs[1].stats()
    assert st["pool_prefix_block_hits"] > 0 and st["pool_ttl_evictions"] > 0
