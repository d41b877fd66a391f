"""Mamba2 (SSD — state-space duality) blocks and the attention-free LM: the
port of ``repro.models.mamba2``.

* ``train_loss`` runs every block over the whole sequence (each
  rematerialised in the backward when ``remat``), then the chunked
  cross-entropy against the tied embedding.
* Prefill runs the chunked SSD scan (``ssd_chunked``: the intra-chunk
  quadratic term, then the state recurrence as a loop over the chunks) and
  keeps each layer's final state; decode is the O(1) recurrent step.
* FIER does not apply: the model has no KV cache, so its decode launches no
  FIER kernel (DESIGN.md §5).
* Precision follows the reference's source as XLA compiles it: prefill's
  causal conv in bf16 (``conv_w`` cast to the activation dtype, its bias
  f32), decode's conv in f32 over the bf16 ring; softplus, A, the SSD and
  the state in f32; silu(z) in bf16.  Where a bf16 result only feeds an f32
  operation, compiled XLA keeps it unrounded (excess precision), and so
  does the port: the conv's last add (the f32 bias follows) and the gate
  product y·silu(z) (the rms_norm reads it in f32).
* The cache is {"layers": {"conv": [L, B, K-1, Ch] bf16 (the raw pre-conv
  inputs at each row's last K-1 valid positions), "ssm": [L, B, H, P, N]
  f32}, "length": [B]}, updated in place by every decode step.
* On a mesh the cache is placed by ``launch.sharding.cache_shardings``
  (the states split over the batch axes only) and each batch shard steps
  its own rows where they lie (``decode_layer``); params and batch are
  read at home (``core.placement.at_home``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.core.placement import (Sharded, at_home, home_params, index_layer, map_leaf,
                                         row_blocks)
from repro_torch.kvcache import cache as kvcache

from .layers import init_embedding, init_linear, rms_norm, silu
from .transformer import (_DTYPES, ModelBundle, _masked_logits, checkpointed, lm_loss,
                          tree_map, unstack)


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, *, n: int, device="cuda") -> dict:
    """Mamba2 block params stacked over ``n`` layers (fp32)."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    K, ch = cfg.conv_kernel, conv_dim(cfg)
    ones = lambda *s: torch.ones((n, *s), device=device)
    a = torch.rand((n, H), generator=gen, device=device) * 15.0 + 1.0  # U[1, 16)
    return {
        "in_proj": init_linear(gen, d, 2 * di + 2 * N + H, n=n, device=device),
        "conv_w": torch.randn((n, K, ch), generator=gen, device=device) * K**-0.5,
        "conv_b": torch.zeros((n, ch), device=device),
        "A_log": torch.log(a),
        "D": ones(H),
        "dt_bias": ones(H) * math.log(math.expm1(0.01)),
        "norm_w": ones(di),
        "out_proj": init_linear(gen, di, d, n=n, device=device),
        "pre_norm": ones(d),
    }


def _split_proj(z_all: torch.Tensor, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    return z_all[..., :di], z_all[..., di:2 * di + 2 * N], z_all[..., 2 * di + 2 * N:]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` forms it (logaddexp(x, 0)), with
    no large-x cut-off."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, Ch], kernel [K, Ch]: the products
    and their running sum in xBC's dtype, except the last add, which the f32
    bias that follows keeps in f32 (compiled, the reference rounds it no
    more), then the silu in f32."""
    K, S = w.shape[0], xBC.shape[1]
    xp = torch.nn.functional.pad(xBC, (0, 0, K - 1, 0))
    terms = [xp[:, i:i + S] * w[i] for i in range(K)]
    out = terms[0]
    for t in terms[1:-1]:
        out = out + t
    return silu(out.to(torch.float32) + terms[-1].to(torch.float32) + b)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rms_norm(y · silu(z)) in y's dtype: silu in bf16 op by op, the
    product kept in f32 for the norm (XLA's excess precision)."""
    return rms_norm(y.to(torch.float32) * silu(z).to(torch.float32), w).to(y.dtype)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x [B,S,H,P], dt [B,S,H] (post-softplus), A [H] (negative), Bm/Cm [B,S,N]
    (ngroups = 1) → (y [B,S,H,P], h_last [B,H,P,N]), all f32.  The chunk is
    min(chunk, S), halved while it does not divide S, as the reference picks
    it.  The decay tensor [B, nc, c, c, H] is built in place (exp, mask,
    then the products in the reference's order)."""
    B_, S, H, Pd = x.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    while S % c:
        c //= 2
    nc = S // c
    xc = x.reshape(B_, nc, c, H, Pd)
    dtc = dt.reshape(B_, nc, c, H)
    Bc = Bm.reshape(B_, nc, c, N)
    Cc = Cm.reshape(B_, nc, c, N)

    dA = dtc * A                                        # [B,nc,c,H] (≤ 0)
    cum = torch.cumsum(dA, dim=2)                       # inclusive
    # intra-chunk: y[t] += Σ_{s≤t} exp(cum_t − cum_s)·dt_s·(C_t·B_s)·x_s
    G = torch.einsum("bztn,bzsn->bzts", Cc, Bc)         # [B,nc,c,c]
    M = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,c,c,H]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    if M.requires_grad:  # the same ops out of place, so autograd keeps its inputs
        M = torch.exp(M).masked_fill(~tri[None, None, :, :, None], 0.0)
        M = M * G[..., None] * dtc[:, :, None, :, :]
    else:
        M.exp_()
        M.masked_fill_(~tri[None, None, :, :, None], 0.0)
        M.mul_(G[..., None]).mul_(dtc[:, :, None, :, :])  # dt at source s
    y = torch.einsum("bztsh,bzshp->bzthp", M, xc)
    del M, G
    # chunk-final states and the inter-chunk recurrence
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # [B,nc,c,H]
    S_z = torch.einsum("bzsh,bzsn,bzshp->bzhpn", decay_to_end * dtc, Bc, xc)
    chunk_decay = torch.exp(dA.sum(dim=2))              # [B,nc,H]
    h = h0 if h0 is not None else torch.zeros((B_, H, Pd, N), device=x.device)
    h_prev = torch.empty((B_, nc, H, Pd, N), device=x.device)
    for z in range(nc):                                 # the state *before* each chunk
        h_prev[:, z] = h
        h = h * chunk_decay[:, z, :, None, None] + S_z[:, z]
    y_inter = torch.einsum("bztn,bzhpn->bzthp", Cc, h_prev) * torch.exp(cum)[..., None]
    return (y + y_inter).reshape(B_, S, H, Pd), h


def _block(hc, lp, cfg: ModelConfig, valid):
    """One Mamba2 block over the whole sequence: (hc + the block's output,
    the pre-conv xBC [B, S, Ch], the final SSD state).  ``valid`` [B, S]
    (or None: every position) zeroes dt at the prompt padding, so the state
    stops at each row's length."""
    B, S, _ = hc.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    xn = rms_norm(hc, lp["pre_norm"])
    z, xBC, dt_raw = _split_proj(xn @ lp["in_proj"].to(xn.dtype), cfg)
    xBC_c = _causal_conv(xBC, lp["conv_w"].to(xn.dtype), lp["conv_b"])
    xs = xBC_c[..., :di].reshape(B, S, H, Pd).to(torch.float32)
    Bm = xBC_c[..., di:di + N].to(torch.float32)
    Cm = xBC_c[..., di + N:].to(torch.float32)
    del xBC_c
    dt = softplus(dt_raw.to(torch.float32) + lp["dt_bias"])
    # padded positions must not advance the state: dt → 0 there makes the
    # decay 1 and the update 0, so h_last is exactly the state at `length`
    if valid is not None:
        dt = dt * valid[:, :, None]
    A = -torch.exp(lp["A_log"])
    y, h_last = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + lp["D"][None, None, :, None] * xs
    y = _gated_norm(y.reshape(B, S, di).to(hc.dtype), z, lp["norm_w"])
    return hc + y @ lp["out_proj"].to(hc.dtype), xBC, h_last


def mamba_block_train(hc, lp, cfg: ModelConfig):
    """Pre-norm residual Mamba2 block over a full sequence (training)."""
    return _block(hc, lp, cfg, None)[0]


def mamba_prefill_step(hc, lp, cfg: ModelConfig, lengths, valid):
    """One Mamba2 layer over the whole sequence, with its final state: the
    forward of the reference's mamba2 prefill layer and of the hybrid's
    ``_mamba_prefill_step``.  hc [B, S, d] (bf16); valid [B, S] masks the
    prompt padding.  Returns (hc, {"conv": [B, K-1, Ch] bf16, "ssm":
    [B, H, P, N] f32})."""
    B, S, _ = hc.shape
    hc, xBC, h_last = _block(hc, lp, cfg, valid)
    # conv state: the raw (pre-conv) inputs at each row's last K-1 valid
    # positions; the start clamped into [0, S-(K-1)] as dynamic_slice clamps it
    # (rows S long take the last K-1: the reference's ``uniform_full`` slice)
    K = cfg.conv_kernel
    start = torch.clamp(lengths.to(torch.int64) - (K - 1), min=0).clamp(max=S - (K - 1))
    pos = start[:, None] + torch.arange(K - 1, device=hc.device)[None, :]
    tail = xBC[torch.arange(B, device=hc.device)[:, None], pos]
    return hc, {"conv": tail.to(torch.bfloat16), "ssm": h_last}


def _state_step(xBC: torch.Tensor, dt_raw: torch.Tensor, p: dict, conv: torch.Tensor,
                ssm: torch.Tensor, cfg: ModelConfig):
    """The recurrent state update of one decode step over some rows: the new
    pre-conv inputs xBC [b, Ch] and dt_raw [b, H], the rows' state conv
    [b, K-1, Ch] bf16 and ssm [b, H, P, N] f32, and the layer's conv_w,
    conv_b, dt_bias, A_log and D.  Row by row, so a batch shard steps its
    own rows alone.  Returns (y [b, H, P] f32, the new conv, the new ssm)."""
    b = xBC.shape[0]
    H, Pd, N, di = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    window = torch.cat([conv, xBC[:, None]], dim=1)  # [b, K, Ch] bf16
    conv_out = torch.einsum("bkc,kc->bc", window.to(torch.float32), p["conv_w"])
    xBC = silu(conv_out + p["conv_b"]).to(xBC.dtype)
    xs = xBC[:, :di].reshape(b, H, Pd).to(torch.float32)
    Bm = xBC[:, di:di + N].to(torch.float32)
    Cm = xBC[:, di + N:].to(torch.float32)
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # [b, H]
    A = -torch.exp(p["A_log"])
    dec = torch.exp(dt * A)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm, xs)
    h_new = ssm * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, h_new) + p["D"][None, :, None] * xs
    return y, window[:, 1:], h_new


STEP_LEAVES = ("conv_w", "conv_b", "dt_bias", "A_log", "D")  # what ``_state_step`` reads


def decode_layer(h: torch.Tensor, p: dict, conv, ssm, cfg: ModelConfig) -> torch.Tensor:
    """One-token recurrent step of one layer, its state updated in place.
    h [B, 1, d] (on the bundle's device, with the layer's params p);
    conv [B, K-1, Ch] / ssm [B, H, P, N]: views into the stacked cache, or
    a placed cache's layer (``Sharded``, split over the batch axes).  The
    projections and the gated output run on h's device over the whole
    batch.  On a placed state each batch shard's rows of xBC and dt go to
    the device of its state pieces, which step there in place, and only
    the rows' y [b, H, P] comes back: no state piece moves.  Returns
    out [B, 1, d]."""
    B, di = h.shape[0], cfg.d_inner
    xn = rms_norm(h, p["pre_norm"])
    z, xBC, dt_raw = _split_proj(xn @ p["in_proj"].to(xn.dtype), cfg)
    xBC, dt_raw = xBC[:, 0], dt_raw[:, 0]
    if isinstance(conv, Sharded):
        y = torch.empty((B, cfg.n_ssm_heads, cfg.ssm_head_dim), device=h.device)
        for (rows, conv_l), (_, ssm_l) in zip(row_blocks(conv), row_blocks(ssm)):
            dev = conv_l.device
            y_l, conv_new, ssm_new = _state_step(
                xBC[rows].to(dev), dt_raw[rows].to(dev), {k: p[k].to(dev) for k in STEP_LEAVES},
                conv_l, ssm_l, cfg)
            conv_l.copy_(conv_new), ssm_l.copy_(ssm_new)
            y[rows] = y_l.to(h.device)
    else:
        y, conv_new, ssm_new = _state_step(xBC, dt_raw, p, conv, ssm, cfg)
        conv.copy_(conv_new), ssm.copy_(ssm_new)
    y = _gated_norm(y.reshape(B, 1, di).to(h.dtype), z, p["norm_w"])
    return h + y @ p["out_proj"].to(h.dtype)


def init_mamba_state(lead: tuple, B: int, cfg: ModelConfig, device) -> dict:
    """Zero decode state with leading axes ``lead`` (the stacked layers)."""
    return {
        "conv": torch.zeros((*lead, B, cfg.conv_kernel - 1, conv_dim(cfg)),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((*lead, B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


# f32 leaves a compute copy keeps: decode's conv reads conv_w in f32, and the
# SSD parameters and norms are f32 in both prefill and decode
MATMUL_LEAVES = ("in_proj", "out_proj")


def compute_block(p: dict, cdt: torch.dtype) -> dict:
    """A Mamba2 block's params with its two projections in the compute dtype
    (what each call would cast them to); every other leaf stays f32."""
    return {k: (v.to(cdt) if k in MATMUL_LEAVES else v) for k, v in p.items()}


# ----------------------------------------------------------------- LM build

def build(cfg: ModelConfig, dcfg=None, *, device="cuda", remat: bool = True,
          loss_chunk: int = 1024) -> ModelBundle:
    """``dcfg`` (``attention.DistConfig``) is kept on the bundle: the state
    needs no mesh switch, since ``decode_step`` steps a placed cache
    (``launch.sharding.cache_shardings``) where it lies and an unplaced one
    on the bundle's device; prefill and decode read placed params and a
    placed batch at home (``core.placement.at_home``)."""
    device = torch.device(device)
    Vp = padded_vocab(cfg)
    cdt, pdt = _DTYPES[cfg.compute_dtype], _DTYPES[cfg.param_dtype]
    L = cfg.n_layers

    def init(gen: torch.Generator | int) -> dict:
        if isinstance(gen, int):
            gen = torch.Generator(device=device).manual_seed(gen)
        params = {
            "embed": init_embedding(gen, Vp, cfg.d_model, device=device),
            "layers": init_mamba_block(gen, cfg, n=L, device=device),
            "final_norm": torch.ones((cfg.d_model,), device=device),
        }
        return tree_map(lambda a: a.to(pdt), params)

    def compute_params(params: dict) -> dict:
        return dict(params, layers=compute_block(params["layers"], cdt))

    block_train = checkpointed(lambda h, lp: mamba_block_train(h, lp, cfg), remat)

    def train_hidden(params, batch):
        """(the final-normed hidden states, the tied head, aux 0) over
        {tokens}."""
        h = params["embed"][batch["tokens"]].to(cdt)
        for lp in unstack(params["layers"], L):
            h = block_train(h, lp)
        h = rms_norm(h, params["final_norm"])
        return h, params["embed"].T, torch.zeros((), device=h.device)

    def train_loss(params, batch):
        """(loss, {loss, moe_aux: 0, tokens}) over {tokens, targets, loss_mask}."""
        return lm_loss(*train_hidden(params, batch), batch, cfg.vocab, Vp, loss_chunk)

    def prefill(params, batch, capacity: int | None = None):
        """Sequential-state prefill (``capacity`` unused: the state is O(1)).
        Returns (last-token logits [B, Vp] f32, the cache on the bundle's
        device)."""
        batch = {k: at_home(v, device) for k, v in batch.items()}
        params = home_params(params, device)
        lengths = batch["lengths"].to(torch.int32)
        h = params["embed"][batch["tokens"]].to(cdt)
        B, S, _ = h.shape
        valid = kvcache.valid_mask(S, lengths)
        cache = init_cache(B, 0)
        cache["length"] = lengths.clone()
        st = cache["layers"]
        for l in range(L):
            lp = tree_map(lambda a: at_home(a, device, l), params["layers"])
            h, s = mamba_prefill_step(h, lp, cfg, lengths, valid)
            st["conv"][l], st["ssm"][l] = s["conv"], s["ssm"]
        rows = torch.arange(B, device=h.device)
        last = rms_norm(h[rows, lengths.to(torch.int64) - 1], params["final_norm"])
        return _masked_logits(last, params["embed"].T, cfg.vocab, Vp), cache

    def decode_step(params, token, cache):
        """One token per sequence; the state is updated in place (on a
        placed cache each batch shard's pieces where they lie,
        ``decode_layer``) and the cache returned with ``length + 1``."""
        params = home_params(params, device)
        h = params["embed"][at_home(token, device)][:, None, :].to(cdt)
        st = cache["layers"]
        for l in range(L):
            lp = tree_map(lambda a: at_home(a, device, l), params["layers"])
            h = decode_layer(h, lp, index_layer(st["conv"], l), index_layer(st["ssm"], l), cfg)
        h = rms_norm(h, params["final_norm"])[:, 0]
        logits = _masked_logits(h, params["embed"].T, cfg.vocab, Vp)
        return logits, dict(cache, length=map_leaf(lambda n: n + 1, cache["length"]))

    def init_cache(B: int, capacity: int, length: int = 0, *, device=None) -> dict:
        dev = device if device is not None else bundle.device
        return {"layers": init_mamba_state((L,), B, cfg, dev),
                "length": torch.full((B,), length, dtype=torch.int32, device=dev)}

    bundle = ModelBundle(
        cfg=cfg, init=init, prefill=prefill, decode_step=decode_step, init_cache=init_cache,
        param_count=cfg.param_count, compute_params=compute_params, device=device,
        train_loss=train_loss, dcfg=dcfg,
        train_hidden=train_hidden,
        loss_chunk=loss_chunk,
    )
    return bundle
