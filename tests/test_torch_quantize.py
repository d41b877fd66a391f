"""Port parity: 1-bit key quantization and the per-token side-car refresh.

The same numpy-seeded inputs go through ``repro`` (JAX, CPU) and
``repro_torch`` (PyTorch, CPU).  Tolerance: none — codes, scale and zero
must be bitwise equal (both packages round the same bf16 values the same
way).
"""
import _torch_threads  # noqa: F401  (sizes torch's threads under xdist)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.core.policy import PolicyConfig as JPolicy
from repro.kvcache import cache as jcache
from repro_torch.core import quantize as tq
from repro_torch.core.policy import PolicyConfig
from repro_torch.kvcache import cache as tcache


def _keys(B, S, H, D, seed, dtype):
    rng = np.random.default_rng(seed)
    K = (rng.standard_normal((B, S, H, D)) * np.exp(rng.standard_normal(D))).astype(np.float32)
    jK = jnp.asarray(K).astype(dtype)
    tK = torch.from_numpy(np.asarray(jK.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    )
    return jK, tK


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,S,H,D,g", [(2, 128, 2, 16, 32), (1, 64, 3, 32, 8), (2, 96, 1, 8, 16)])
def test_quantize_bitwise(B, S, H, D, g, dtype):
    jK, tK = _keys(B, S, H, D, seed=S + D, dtype=dtype)
    want = jq.quantize(jK, g)
    got = tq.quantize(tK, g)
    assert got.codes.dtype == torch.uint8 and got.scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got.codes), _np(want.codes))
    np.testing.assert_array_equal(_np(got.scale), _np(want.scale))
    np.testing.assert_array_equal(_np(got.zero), _np(want.zero))
    np.testing.assert_array_equal(_np(tq.dequantize(got)), _np(jq.dequantize(want)))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (2, 64, 3, 8)).astype(np.uint8)
    packed = tq.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(tq.unpack_bits(packed).numpy(), bits)


@pytest.mark.parametrize("g", [8, 32])
def test_append_token_metadata_bitwise(g):
    """After a 1-token append at each row's own position, the refreshed
    side-car group equals the reference's, bit for bit (bf16 midpoint)."""
    B, S, H, D = 3, 128, 2, 16
    jK, tK = _keys(B, S, H, D, seed=g, dtype=jnp.bfloat16)
    pol_j = JPolicy(kind="fier", group=g)
    pol_t = PolicyConfig(kind="fier", group=g)
    meta_j = jq.quantize(jK, g)
    meta_t = tq.quantize(tK, g)
    length = np.array([5, 64, 127], np.int32)
    rng = np.random.default_rng(g)
    new = (rng.standard_normal((B, 1, H, D)) * 4).astype(np.float32)
    jnew = jnp.asarray(new).astype(jnp.bfloat16)
    tnew = torch.from_numpy(new).to(torch.bfloat16)
    jk, _ = jcache.append_kv(jK, jK, jnew, jnew, jnp.asarray(length))
    tk, _ = tcache.append_kv(tK, tK.clone(), tnew, tnew, torch.from_numpy(length))
    np.testing.assert_array_equal(_np(tk), _np(jk))
    want = jcache.append_token_metadata(meta_j, jk, jnp.asarray(length), pol_j)
    got = tcache.append_token_metadata(meta_t, tk, torch.from_numpy(length), pol_t)
    np.testing.assert_array_equal(_np(got.codes), _np(want.codes))
    np.testing.assert_array_equal(_np(got.scale), _np(want.scale))
    np.testing.assert_array_equal(_np(got.zero), _np(want.zero))


def test_init_layer_cache_shapes_match():
    pol_j = JPolicy(kind="fier", group=32)
    pol_t = PolicyConfig(kind="fier", group=32)
    want = jcache.init_layer_cache(3, 2, 64, 4, 16, pol_j)
    got = tcache.init_layer_cache(3, 2, 64, 4, 16, pol_t, device="cpu")
    assert tuple(got["k"].shape) == want["k"].shape
    for name in ("codes", "scale", "zero"):
        assert tuple(getattr(got["meta"], name).shape) == getattr(want["meta"], name).shape
    with pytest.raises(ValueError):
        tcache.init_layer_cache(1, 1, 60, 1, 8, dataclasses.replace(pol_t, group=32), device="cpu")
