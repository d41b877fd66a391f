"""Dry-run cells: (arch × shape × mesh) → the port's step and its placed
arguments (port of ``repro.launch.specs``).

The reference builds ``ShapeDtypeStruct``s with shardings and lowers its
jitted step; the port builds its own step (``launch.steps``) and places
every argument by the reference's shardings (``launch.sharding``) as a
``core.placement.Sharded`` value whose pieces are made on their shards'
devices (``core.placement.place_new``).  Shapes come from ``meta``
tensors (``bundle.init`` and ``init_cache`` on ``device="meta"``), so
nothing is drawn from a generator.  Under ``FakeTensorMode`` on a fake
mesh (``launch.mesh.make_production_mesh``) the pieces are fake and the
step can be traced (``launch/dryrun.py``); with ``fill=True`` on a real
mesh the same cell runs for real (zeros, the lengths full), which is how
the card checks the dry run's figures.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.placement import NamedSharding, P, map_tree, place_new
from repro_torch.core.policy import PolicyConfig
from repro_torch.models import build_model
from repro_torch.models.attention import DistConfig
from repro_torch.optim import adamw_init

from . import sharding as shard
from .mesh import Mesh
from .mesh import batch_axes as mesh_batch_axes
from .mesh import fsdp_axes as mesh_fsdp_axes
from .steps import TrainHParams, make_serve_step, make_train_step


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                 # train | prefill | decode
    fn: Callable              # the step
    args: tuple               # placed arguments
    cfg: ModelConfig
    mesh: Any
    notes: str = ""


def decode_policy(cfg: ModelConfig, budget: int = 4096,
                  use_kernels: bool = False) -> PolicyConfig | None:
    if cfg.attention_free:
        return None  # FIER inapplicable (DESIGN.md §5)
    return PolicyConfig(kind="fier", budget=budget, group=32, skip_layers=2,
                        use_kernels=use_kernels)


def seq_axes_for(shape: ShapeConfig, mesh: Mesh) -> tuple[str, ...]:
    """KV sequence sharding at decode: 'model' normally; for batch=1
    long-context everything shards the sequence."""
    if shape.global_batch == 1:
        return tuple(mesh.axis_names)
    return ("model",)


def batch_meta(cfg: ModelConfig, kind: str, B: int, S: int) -> dict:
    """The shapes and dtypes of ``data.pipeline``'s train or prefill batch of
    ``B`` rows and ``S`` positions, as ``meta`` tensors."""
    m = lambda *shape, dt=torch.int32: torch.empty(shape, dtype=dt, device="meta")
    if kind == "train":
        St = S - cfg.n_vision_tokens if cfg.family == "vlm" else S
        batch = {"tokens": m(B, St), "targets": m(B, S),
                 "loss_mask": m(B, S, dt=torch.float32)}
    else:
        batch = {"tokens": m(B, S), "lengths": m(B)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = m(B, cfg.n_vision_tokens, cfg.d_model, dt=torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = m(B, cfg.enc_ctx, cfg.d_model, dt=torch.bfloat16)
    return batch


def _placer(fill: bool, values: dict[str, float]) -> Callable:
    """``(path, meta leaf, sharding) -> placed leaf``: fake or empty pieces,
    or (``fill``) pieces holding zeros, or ``values[name]`` for a leaf whose
    last path key is ``name``."""
    def put(path, leaf, sh):
        return place_new(leaf, sh, fill=values.get(path[-1] if path else "", 0) if fill else None)

    return put


def _place(tree: Any, shardings: Any, put: Callable) -> Any:
    return shard.map_with_path(put, tree, shardings)


def build_cell(
    arch: str,
    shape: str | ShapeConfig,
    mesh: Mesh,
    *,
    policy_kind: str = "fier",
    budget: int = 4096,
    hp: TrainHParams | None = None,
    remat: bool = True,
    dist_mode: str = "local",
    cost_depth: int | None = None,
    cost_depth_enc: int | None = None,
    strategy: str = "tp",
    fill: bool = False,
    cfg: ModelConfig | None = None,
) -> Cell:
    """The cell's step and placed arguments (module docstring).

    ``shape`` is a name in ``SHAPES`` or a ``ShapeConfig``.  ``cost_depth``
    rebuilds the arch at that many (super)layers with ``microbatches=1`` and
    ``skip_layers=0`` (the reference also unrolls its layer scan there; the
    port's depth is a Python loop already).  ``cfg`` replaces the
    registry's config of ``arch``."""
    cfg = cfg or get_config(arch)
    sh_cfg = SHAPES[shape] if isinstance(shape, str) else shape
    shape_name = shape if isinstance(shape, str) else sh_cfg.name
    home = mesh.devices[0]
    if cost_depth is not None:
        depth = cost_depth * cfg.attn_every if cfg.family == "hybrid" else cost_depth
        repl = {"n_layers": depth}
        if cfg.family == "encdec":
            repl["n_enc_layers"] = cost_depth_enc or 1
        cfg = dataclasses.replace(cfg, **repl)
        hp = hp or TrainHParams(microbatches=1)
    b_axes = mesh_batch_axes(mesh)
    itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
    pbytes = cfg.param_count() * itemsize
    f_axes = mesh_fsdp_axes(mesh, pbytes)
    notes = []
    if strategy == "fsdp_pure":
        # ZeRO-3 over the whole mesh; the batch spans as many axes as divide it
        f_axes = tuple(mesh.axis_names)
        b_axes = ()
        n = 1
        for a in ("data", "model", "pod"):
            if a in mesh.axis_names and sh_cfg.global_batch % (n * mesh.shape[a]) == 0:
                b_axes += (a,)
                n *= mesh.shape[a]
        notes.append("strategy=fsdp_pure")
    max_pos = sh_cfg.seq_len if cfg.family == "encdec" else None
    B, S = sh_cfg.global_batch, sh_cfg.seq_len

    if sh_cfg.kind == "train":
        if hp is None:
            # the reference's choice: 100B+ cells accumulate 8 microbatches in
            # bf16, the hybrid 4; fsdp_pure would regather every weight per
            # microbatch, so 1
            big = pbytes > 50e9
            mb = 8 if big else (4 if cfg.family == "hybrid" else 1)
            if strategy == "fsdp_pure":
                mb = 1
            hp = TrainHParams(schedule="wsd" if "minicpm" in arch else "cosine",
                              microbatches=mb,
                              accum_dtype="bfloat16" if big else "float32")
        dcfg = DistConfig(mesh=mesh, batch_axes=b_axes,
                          ep_axis="model" if cfg.family == "moe" else None)
        bundle = build_model(cfg, None, dcfg, device=home, remat=remat, max_positions=max_pos)
        step_fn = make_train_step(bundle, hp)
        params = build_model(cfg, None, device="meta", max_positions=max_pos).init(
            torch.Generator())
        params_sh = shard.param_shardings(params, mesh, f_axes, strategy)
        opt = adamw_init(params)
        opt_sh = shard.opt_shardings(opt, params_sh, mesh)
        put = _placer(fill, {"loss_mask": 1.0})
        state = {"params": _place(params, params_sh, put),
                 "opt": map_tree(lambda leaf, sh: place_new(leaf, sh, fill=0 if fill else None),
                                 opt, opt_sh)}
        batch = batch_meta(cfg, "train", B, S)
        batch = _place(batch, shard.batch_shardings(batch, mesh, b_axes), put)
        return Cell(arch, shape_name, "train", step_fn, (state, batch), cfg, mesh,
                    "; ".join(notes))

    pol = decode_policy(cfg, budget) if policy_kind == "fier" else (
        None if policy_kind == "full" or cfg.attention_free
        else PolicyConfig(kind=policy_kind, budget=budget, skip_layers=2))
    if cost_depth is not None and pol is not None:
        pol = dataclasses.replace(pol, skip_layers=0)
    # a batch of 1 (long_500k) cannot split its batch dim: everything shards
    # the sequence instead
    cell_b_axes = b_axes if B > 1 else ()
    s_axes = seq_axes_for(sh_cfg, mesh) if sh_cfg.kind == "decode" else ()
    dcfg = DistConfig(mesh=mesh, seq_axes=s_axes, mode=dist_mode, batch_axes=cell_b_axes,
                      ep_axis="model" if cfg.family == "moe" else None)
    bundle = build_model(cfg, pol, dcfg, device=home, remat=remat, max_positions=max_pos)
    params = build_model(cfg, pol, device="meta", max_positions=max_pos).init(torch.Generator())
    # serving: no optimizer; params TP over 'model' + FSDP over the data axes
    params = _place(params, shard.param_shardings(params, mesh, f_axes), _placer(fill, {}))

    if sh_cfg.kind == "prefill":
        batch = batch_meta(cfg, "prefill", B, _text_len(cfg, S))
        batch = _place(batch, shard.batch_shardings(batch, mesh, cell_b_axes),
                       _placer(fill, {"lengths": S}))
        step_fn = lambda params, batch: bundle.prefill(params, batch, capacity=S)
        return Cell(arch, shape_name, "prefill", step_fn, (params, batch), cfg, mesh,
                    "; ".join(notes))

    # decode: the cache at capacity S holding S - 1 positions, one new token
    cache = bundle.init_cache(B, S, S - 1, device="meta")
    cache_sh = shard.cache_shardings(cache, mesh, cell_b_axes, s_axes,
                                     shard.cache_batch_axes(bundle.init_cache, S))
    cache = _place(cache, cache_sh, _placer(fill, {"length": S - 1}))
    token = place_new(torch.empty((B,), dtype=torch.int32, device="meta"),
                      NamedSharding(mesh, P(cell_b_axes or None)), fill=0 if fill else None)
    return Cell(arch, shape_name, "decode", make_serve_step(bundle), (params, token, cache),
                cfg, mesh, "; ".join(notes))


def _text_len(cfg: ModelConfig, S: int) -> int:
    return S - cfg.n_vision_tokens if cfg.family == "vlm" else S


__all__ = ["Cell", "batch_meta", "build_cell", "decode_policy", "seq_axes_for"]
