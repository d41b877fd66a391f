"""Training over a device mesh, single-controller: what the reference gets
from GSPMD when ``launch/train.py`` places the state with
``param_shardings`` and jits the one-device ``train_step``.

A bundle built with ``DistConfig(mesh=...)`` gets one of these losses as
its ``train_loss``; ``launch/steps.make_train_step`` runs it unchanged (its
optimizer maps over the pieces of ``core.placement.Sharded`` leaves).
Params may be Sharded (``core.placement.place_tree``) or plain tensors
(read as replicated).  The whole step is one autograd graph, so the
collectives' transposes come from autograd: a gather before use
(``Sharded.view``) sends each piece the sum of its users' gradients (the
FSDP reduce-scatter), and a psum hands every shard the whole gradient.

* The batch splits over the data shards (``core.placement.split_batch``:
  every leaf's leading dim; a VLM's ``vision_embeds`` too).
* The loss is the global one: psum(NLL sums) / psum(mask sums).
* FSDP: a layer's pieces are gathered inside its remat scope, so at most
  one layer's weights sit gathered above the stored pieces.
* The readers of TP pieces (``Shards``, ``Views``, ``row_sum``,
  ``vocab_parallel_embed``) live in ``models/tensor_parallel.py``, shared
  with the placed serving steps.

The transformer families (dense, moe, vlm) run Megatron TP over 'model'
(:func:`transformer_mesh_loss`): column-parallel wq/wk/wv/bq/bk/bv/w1/w3
(each model shard runs the one-device layer code on a config with
``n_heads``, ``n_kv_heads`` and ``d_ff`` divided by the model degree),
row-parallel wo and w2 with a psum, and a vocab-parallel embedding and
head whose cross-entropy takes a pmax of the shards' row maxima and psums
of their exp-sums and target logits.  MoE takes ``moe.moe_apply_ep`` when
``DistConfig.ep_axis`` is set (capacity per token shard, the aux loss the
pmean of the shards' estimates), else the one-device ``moe_apply`` over
the tokens of every data shard (GSPMD's semantics).  The residual stream
of a data shard is not split over 'model': one copy, on the data shard's
first model shard, read by the others.  The reference gives XLA a
sequence-parallel placement hint there ([batch→batch axes, seq→'model'],
``repro/models/attention.py`` ``seq_shard_constraint``); a single
controller has no such hint to give.  The cost is activation memory —
``B·S·d / data`` per data shard where the reference holds ``/ (data·model)``
— not results.

The ssm, hybrid and encdec families shard over the data axes only
(:func:`data_parallel_loss`: DP + FSDP): with 'model' above 1 their
model-axis pieces are gathered as well, because their splits do not fall
on head boundaries — Mamba2's ``in_proj`` [d, 2·di+2N+H] is split on its
flattened output dim, across the z / x / B / C / dt sections — and the
reference leaves that resharding to GSPMD (``repro/launch/sharding.py:
10-15``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.core import distributed as dist
from repro_torch.core.placement import AtUse, as_sharded, split_batch
from repro_torch.launch.mesh import batch_axes

from . import attention as attn
from . import moe as moe_mod
from . import tensor_parallel as tp
from .tensor_parallel import Shards, Views
from .layers import apply_norm, mlp_apply
from .transformer import (_DTYPES, MOE_AUX_COEF, _vocab_col_mask, ce_chunk_size,
                          checkpointed, chunked_ce_sum, unstack)

# the stacked layer subtrees of each family's params (gathered per layer)
STACKED = ("layers", "mamba", "mamba_tail", "enc_layers", "dec_layers")


def _vp_ce_chunk(hs, Ws, cms, ts, ms):
    """One sequence chunk of the vocab-parallel cross-entropy: each model
    shard's logits over its columns (padded ones at −1e30), a pmax of the
    row maxima, psums of the exp-sums and of the target logit (from the
    shard holding the target's column)."""
    Vl = Ws[0].shape[1]
    logits = [hs.to(W.device).to(torch.float32) @ W + cm for W, cm in zip(Ws, cms)]
    M = dist.pmax([lg.amax(-1).detach() for lg in logits])
    se = dist.psum([torch.exp(lg - Mi[..., None]).sum(-1) for lg, Mi in zip(logits, M)])
    tg = []
    for m, lg in enumerate(logits):
        local = ts.to(lg.device) - m * Vl
        ok = (local >= 0) & (local < Vl)
        tg.append(torch.where(ok, lg.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0], 0.0))
    tgt = dist.psum(tg)
    nll = (torch.log(se[0]) + M[0] - tgt[0]).to(hs.device) * ms
    return nll.sum(), ms.sum()


def vocab_parallel_ce_sum(h: torch.Tensor, Ws: list[torch.Tensor], targets: torch.Tensor,
                          mask: torch.Tensor, vocab: int, Vp: int, chunk: int):
    """``transformer.chunked_ce_sum`` with the head's columns split over
    the model shards (``Ws``: shard m's [d, Vp/n] columns, on its device):
    (NLL summed over the mask, the mask's sum), sequence-chunked, each
    chunk recomputed in the backward."""
    S = h.shape[1]
    chunk = ce_chunk_size(S, chunk)
    Vl = Vp // len(Ws)
    col = _vocab_col_mask(vocab, Vp, h.device)
    cms = [col[m * Vl:(m + 1) * Vl].to(W.device) for m, W in enumerate(Ws)]
    Wf = [W.to(torch.float32) for W in Ws]
    targets, mask = targets.to(torch.int64), mask.to(torch.float32)
    tot = cnt = torch.zeros((), device=h.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        nll, n = checkpoint(_vp_ce_chunk, h[:, sl], Wf, cms, targets[:, sl], mask[:, sl],
                            use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    return tot, cnt


def _global_loss(tots, cnts, auxs, is_moe: bool):
    tot, cnt = dist.psum(tots)[0], dist.psum(cnts)[0]
    loss = tot / torch.clamp(cnt, min=1.0)
    aux = (torch.stack([a.to(loss.device) for a in auxs]).mean() if is_moe
           else torch.zeros((), device=loss.device))
    return loss + MOE_AUX_COEF * aux, {"loss": loss, "moe_aux": aux, "tokens": cnt}


def transformer_mesh_loss(cfg: ModelConfig, dcfg, *, remat: bool = True,
                          loss_chunk: int = 1024):
    """``train_loss(params, batch)`` of a dense / moe / vlm bundle over
    ``dcfg.mesh``: Megatron TP over 'model', DP (+ FSDP by the params'
    storage) over ``dcfg.batch_axes`` (the mesh's batch axes when empty)."""
    mesh = dcfg.mesh
    sh = Shards(mesh, dcfg.batch_axes or batch_axes(mesh))
    n_tp = sh.n_tp
    # checked when the loss is called: a bundle built on this mesh may only
    # serve (its prefill and decode need no head split)
    undivided = [f"{name} {n}" for name, n in (("n_heads", cfg.n_heads),
                                               ("n_kv_heads", cfg.n_kv_heads),
                                               ("d_ff", cfg.d_ff)) if n % n_tp]
    cfg_tp = dataclasses.replace(cfg, n_heads=cfg.n_heads // n_tp,
                                 n_kv_heads=cfg.n_kv_heads // n_tp, d_ff=cfg.d_ff // n_tp)
    cdt = _DTYPES[cfg.compute_dtype]
    Vp = padded_vocab(cfg)
    is_moe = cfg.family == "moe"

    def _ffn(lp, views, rs, xns):
        """Each data shard's FFN output (``transformer._ffn_block``'s
        counterpart over the shards) and the layer's MoE aux."""
        if not is_moe:
            return [tp.row_sum([mlp_apply(xn.to(sh.dev(t, m)),
                                          views.tree(lp["mlp"], "layers/mlp", t, m), cfg.act)
                                for m in range(n_tp)], "w2").to(cdt)
                    for t, xn in enumerate(xns)], None
        flat = [xn.reshape(-1, cfg.d_model) for xn in xns]
        if dcfg.ep_axis is not None:
            ys, aux = moe_mod.moe_apply_ep(flat, lp["moe"], cfg, mesh=mesh, token_axes=sh.b_axes,
                                           model_axis=dcfg.ep_axis)
        else:
            # GSPMD's semantics of the one-device step: one capacity over
            # the tokens of every data shard, the weights whole
            home = sh.dev(0)
            p = {k: as_sharded(v, mesh).view(sh.coords(0), {}, home) for k, v in lp["moe"].items()}
            y, aux = moe_mod.moe_apply(dist.gather(flat, 0, home), p, cfg)
            ys = [part.to(x.device) for part, x in zip(y.split([x.shape[0] for x in flat]), flat)]
        return [y.reshape(xn.shape) for y, xn in zip(ys, xns)], aux

    def _layer(hs, lp):
        views = Views(sh)
        rs, xns = [], []
        for t, h in enumerate(hs):
            xn = apply_norm(h, views.tree(lp["norm1"], "layers/norm1", t, 0), cfg.norm)
            a = tp.row_sum([attn.attention_train(views.tree(lp["attn"], "layers/attn", t, m),
                                                  xn.to(sh.dev(t, m)), cfg_tp)
                            for m in range(n_tp)], "wo").to(cdt)
            r = h.to(torch.float32) + a.to(torch.float32)
            rs.append(r)
            xns.append(apply_norm(r, views.tree(lp["norm2"], "layers/norm2", t, 0),
                                  cfg.norm).to(cdt))
        ys, aux = _ffn(lp, views, rs, xns)
        hs = [r.to(cdt) + y for r, y in zip(rs, ys)]
        return hs, (torch.zeros((), device=hs[0].device) if aux is None else aux)

    layer = checkpointed(_layer, remat)

    def train_loss(params, batch):
        """(loss + MOE_AUX_COEF · mean aux, {loss, moe_aux, tokens}), the
        one-device ``train_loss``'s contract, over the mesh."""
        if undivided:
            raise ValueError(f"{', '.join(undivided)} does not divide over {n_tp} model "
                             f"shards")
        views = Views(sh)
        E = params["embed"]
        slices = split_batch(batch, mesh, sh.b_axes)
        hs = []
        for t, b in enumerate(slices):
            h = tp.vocab_parallel_embed([views.tp(E, "embed", t, m) for m in range(n_tp)],
                                      b["tokens"]).to(cdt)
            if b.get("vision_embeds") is not None:
                h = torch.cat([b["vision_embeds"].to(h.device, cdt), h], dim=1)
            hs.append(h)
        auxs = []
        for lp in unstack(params["layers"], cfg.n_layers):
            hs, aux = layer(hs, lp)
            auxs.append(aux)
        tots, cnts = [], []
        for t, (h, b) in enumerate(zip(hs, slices)):
            h = apply_norm(h, views.tree(params["final_norm"], "final_norm", t, 0), cfg.norm)
            Ws = [views.tp(E, "embed", t, m).T if cfg.tie_embeddings
                  else views.tp(params["lm_head"], "lm_head", t, m) for m in range(n_tp)]
            nll, n = vocab_parallel_ce_sum(h, Ws, b["targets"], b["loss_mask"], cfg.vocab, Vp,
                                           loss_chunk)
            tots.append(nll)
            cnts.append(n)
        return _global_loss(tots, cnts, auxs, is_moe)

    return train_loss


def data_parallel_loss(bundle, dcfg):
    """``train_loss(params, batch)`` of an ssm / hybrid / encdec bundle over
    ``dcfg.mesh``: each data shard runs the bundle's ``train_hidden`` on its
    slice of the batch, on the device of its first model shard, with its
    layers' pieces gathered whole inside each layer's remat scope
    (``core.placement.AtUse``) and the other leaves gathered once; the
    model axis splits no compute (see the module docstring)."""
    mesh, cfg = dcfg.mesh, bundle.cfg
    sh = Shards(mesh, dcfg.batch_axes or batch_axes(mesh))
    Vp = padded_vocab(cfg)

    def bind(params: dict, t: int, memo: dict) -> dict:
        coords, dev = sh.coords(t), sh.dev(t)

        def leaf(x, lazy):
            xs = as_sharded(x, mesh)
            if lazy:
                return AtUse(xs, coords, dev)
            key = (id(x), t)
            if key not in memo:
                memo[key] = xs.view(coords, {}, dev)
            return memo[key]

        def walk(tree, lazy):
            if isinstance(tree, dict):
                return {k: walk(v, lazy) for k, v in tree.items()}
            return leaf(tree, lazy)

        return {k: walk(v, k in STACKED) for k, v in params.items()}

    def train_loss(params, batch):
        memo: dict = {}
        tots, cnts = [], []
        for t, b in enumerate(split_batch(batch, mesh, sh.b_axes)):
            h, W, _ = bundle.train_hidden(bind(params, t, memo), b)
            nll, n = chunked_ce_sum(h, W, b["targets"], b["loss_mask"], cfg.vocab, Vp,
                                    bundle.loss_chunk)
            tots.append(nll)
            cnts.append(n)
        return _global_loss(tots, cnts, (), False)

    return train_loss


__all__ = ["STACKED", "data_parallel_loss", "transformer_mesh_loss",
           "vocab_parallel_ce_sum"]
