"""The port's dry run (``launch/specs.py``, ``launch/dryrun.py``,
``launch/accounting.py``, the collective record of ``core/distributed.py``,
the sharding functions of ``launch/sharding.py``) on fake devices, on the
CPU.

* Argument bytes: the reference's ``build_cell`` on a (2, 2, 4)
  pod/data/model mesh and a (4, 4) one (16 forced host devices, one
  subprocess, no lowering), each leaf's ``NamedSharding.shard_shape``
  bytes per device, against the port's placed fake pieces on the same mesh
  shapes: olmo-1b ``train_4k`` (tp and fsdp_pure), qwen3-moe ``train_4k``,
  olmo-1b, granite-moe, zamba2-7b and whisper-small ``decode_32k``,
  command-r-plus and mamba2-370m ``long_500k``, granite-moe and qwen3-moe
  ``prefill_32k`` (the MoE prefill cells, expert-parallel), all at full size (the
  hybrid's stacked slabs and Mamba2 states, whisper's cross K/V).  Leaf by leaf the block a device computes with has the
  reference's shape and bytes, with the same dtype (no leaf differs).  The
  port stores a block the spec replicates once, on the first shard of its
  replica group (``core.placement``): per device, the bytes it stores plus
  the bytes of the replicated blocks it reads from their one owner equal
  the reference's, device 0 stores exactly the reference's, and no device
  stores more.
* ``model_flops_global`` / ``model_flops_per_device`` equal the
  reference's ``_finish_model_flops`` (its source, run here without
  importing ``repro.launch.dryrun``, which sets the 512-device flag) for
  every arch × shape on both production meshes.
* The MoE prefill cells run the reference's expert-parallel MoE: a reduced
  granite-moe ``prefill`` cell on a (2, 2) fake mesh calls
  ``moe.moe_apply_ep`` once per layer, over the data shards' tokens, and
  never the one-capacity ``moe_apply``.
* The accountant: a view does not count twice, a freed tensor leaves, an
  in-place op allocates nothing, bytes go to the right device, FLOPs equal
  ``FlopCounterMode``'s.
* The collective record: a reduced tp2×dp2 train step run for real on a
  CPU mesh and traced on fake devices give identical records; a 2-shard
  psum of known size gives the ring model's bytes.
* The resident decode: a reduced olmo on (1, 4) and (2, 2) CPU meshes with
  the whole cache placed by ``cache_shardings`` appends the plain
  decode's rows bit for bit in its first layer and stays within
  ``test_torch_sharded``'s DENSE_TOL of dense decode; its fake-device
  trace copies no piece of the cache to another device.
* The CLI: ``python -m repro_torch.launch.dryrun --arch olmo-1b --shape
  decode_32k --cost-depth 1 --json`` on the production mesh prints every
  field (it runs in the background while the tests above run).
"""
import _torch_threads
import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from conftest import SRC, run_in_subprocess
from repro_torch.configs import ARCHS, SHAPES, reduced_config, shape_cells
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import distributed as dist
from repro_torch.core.placement import Sharded, gather_tree, place_tree
from repro_torch.core.policy import PolicyConfig
from repro_torch.launch import dryrun
from repro_torch.launch.accounting import DeviceAccountant, tree_tensors
from repro_torch.launch.mesh import Mesh, make_fake_mesh, make_mesh, make_production_mesh
from repro_torch.launch.sharding import cache_batch_axes, cache_shardings
from repro_torch.launch.specs import build_cell
from repro_torch.models import build_model
from repro_torch.models.attention import DistConfig

DENSE_TOL = 2e-2  # test_torch_sharded's: seq-sharded FIER at a full budget vs dense decode

PARITY_CELLS = [("olmo-1b", "train_4k", "tp"), ("olmo-1b", "train_4k", "fsdp_pure"),
                ("qwen3-moe-235b-a22b", "train_4k", "tp"), ("olmo-1b", "decode_32k", "tp"),
                ("granite-moe-1b-a400m", "decode_32k", "tp"),
                ("command-r-plus-104b", "long_500k", "tp"), ("zamba2-7b", "decode_32k", "tp"),
                ("whisper-small", "decode_32k", "tp"), ("mamba2-370m", "long_500k", "tp"),
                ("granite-moe-1b-a400m", "prefill_32k", "tp"),
                ("qwen3-moe-235b-a22b", "prefill_32k", "tp")]
PARITY_MESHES = {"2x2x4": ((2, 2, 4), ("pod", "data", "model")),
                 "4x4": ((4, 4), ("data", "model"))}
CLI = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b",
       "--shape", "decode_32k", "--cost-depth", "1", "--json"]


@pytest.fixture(scope="module")
def cli_run():
    """The CLI run, started once and read by the last test."""
    with _torch_threads.subprocess_threads():
        proc = subprocess.Popen(CLI, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=dict(os.environ, PYTHONPATH=SRC))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference_bytes():
    code = textwrap.dedent(f"""
        import json, math, jax, numpy as np
        from jax.sharding import Mesh
        from repro.launch.specs import build_cell

        def norm(path):
            out = []
            for k in path:
                for a in ("key", "name", "idx"):
                    if hasattr(k, a):
                        out.append(str(getattr(k, a)))
                        break
            return "/".join(out)

        devs = np.array(jax.devices()[:16])
        out = {{}}
        for name, (shape, axes) in {PARITY_MESHES!r}.items():
            mesh = Mesh(devs.reshape(shape), axes)
            for arch, cell_shape, strategy in {PARITY_CELLS!r}:
                cell = build_cell(arch, cell_shape, mesh, strategy=strategy)
                out[f"{{name}}|{{arch}}|{{cell_shape}}|{{strategy}}"] = {{
                    norm(p): [math.prod(s.sharding.shard_shape(s.shape)) * s.dtype.itemsize,
                              str(s.dtype).replace("jnp.", "")]
                    for p, s in jax.tree_util.tree_leaves_with_path(cell.args)}}
        print(json.dumps(out))
    """)
    with _torch_threads.subprocess_threads():
        out = run_in_subprocess(code, n_devices=16)
    return json.loads(out.strip().splitlines()[-1])


def _port_leaves(tree, path=()):
    """(path, leaf) of a cell's placed arguments, paths as the reference's."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _port_leaves(getattr(tree, f), path + (f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (str(i),))
    elif dataclasses.is_dataclass(tree) and hasattr(tree, "FIELDS"):
        # the reference's side-car flattens as a tuple of its fields
        for i, f in enumerate(tree.FIELDS):
            yield from _port_leaves(getattr(tree, f), path + (str(i),))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("mesh_name", sorted(PARITY_MESHES))
@pytest.mark.parametrize("arch,shape,strategy", PARITY_CELLS)
def test_argument_bytes_equal_reference(reference_bytes, mesh_name, arch, shape, strategy,
                                        cli_run):
    ref = reference_bytes[f"{mesh_name}|{arch}|{shape}|{strategy}"]
    mesh_shape, axes = PARITY_MESHES[mesh_name]
    with FakeTensorMode():
        mesh = make_fake_mesh(mesh_shape, axes)
        cell = build_cell(arch, shape, mesh, strategy=strategy)
        leaves = dict(_port_leaves(cell.args))
        assert sorted(leaves) == sorted(ref)
        index = {d: i for i, d in enumerate(mesh.devices)}
        stored = np.zeros(mesh.size, dtype=np.int64)
        read = np.zeros(mesh.size, dtype=np.int64)  # replicated blocks held by another shard
        for path, x in leaves.items():
            want_bytes, want_dtype = ref[path]
            assert str(x.dtype).replace("torch.", "") == want_dtype, path
            if not isinstance(x, Sharded):  # a 0-dim leaf: one copy, on device 0
                assert x.dim() == 0 and x.numel() * x.element_size() == want_bytes, path
                stored[index[x.device]] += want_bytes
                read += want_bytes
                read[index[x.device]] -= want_bytes
                continue
            block = x.pieces[0].numel() * x.pieces[0].element_size()
            assert block == want_bytes, path
            for p, owner in zip(x.pieces, x.owners):
                assert index[p.device] == owner
                stored[owner] += block
            read += block
            for owner in x.owners:
                read[owner] -= block
    total = sum(b for b, _ in ref.values())
    assert (stored + read == total).all()
    assert stored[0] == total and (stored <= total).all()


def _reference_finish_model_flops():
    """The reference's ``_finish_model_flops``, compiled from its source
    (importing its module would set the 512-device flag)."""
    path = os.path.join(SRC, "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_finish_model_flops")
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["_finish_model_flops"]


def test_model_flops_equal_reference():
    ref_fn = _reference_finish_model_flops()
    for multi_pod in (False, True):
        n = 512 if multi_pod else 256
        mesh = type("M", (), {"size": n, "devices": np.empty(n)})()
        for arch in ARCHS:
            for shape in shape_cells(arch):
                cell = type("C", (), {"kind": SHAPES[shape].kind})()
                got, want = {}, {}
                dryrun._finish_model_flops(got, arch, shape, cell, mesh)
                ref_fn(want, arch, shape, cell, mesh)
                assert got == want, (arch, shape)


def test_moe_prefill_cell_is_expert_parallel():
    from repro_torch.models import moe

    cfg = _small_cfg("granite-moe-1b-a400m")
    calls = []
    ep, plain = moe.moe_apply_ep, moe.moe_apply

    def counted(x, p, cfg_, **kw):
        calls.append((len(x) if isinstance(x, list) else 1, kw["token_axes"]))
        return ep(x, p, cfg_, **kw)

    def refused(*a, **k):
        raise AssertionError("the one-capacity moe_apply ran in an EP prefill")

    moe.moe_apply_ep, moe.moe_apply = counted, refused
    try:
        with FakeTensorMode():
            cell = build_cell("granite-moe-1b-a400m", ShapeConfig("p", 64, 4, "prefill"),
                              make_fake_mesh((2, 2), ("data", "model")), cfg=cfg,
                              cost_depth=None)
            cell.fn(*cell.args)
    finally:
        moe.moe_apply_ep, moe.moe_apply = ep, plain
    assert calls == [(2, ("data",))] * cfg.n_layers


def test_accountant_unit_cases():
    with FakeTensorMode():
        a = torch.empty(256, 256, device="cpu:1")
        acc = DeviceAccountant()
        held = acc.hold({"a": a})
        assert held[acc.dev("cpu:1")] == 256 * 256 * 4
        with acc:
            v = a.view(-1)[:100]           # a view: no bytes
            a.add_(1.0)                    # in place: no bytes
            assert acc.live[acc.dev("cpu:1")] == 256 * 256 * 4
            b = a.to("meta:3")             # a copy: bytes on the receiving device
            d3 = acc.dev("meta:3")
            assert acc.live[d3] == 256 * 256 * 4 and acc.copy_in[d3] == 256 * 256 * 4
            assert acc.other_count[d3] == 1
            c = b @ b
            assert acc.live[d3] == 2 * 256 * 256 * 4
            del b, c                       # freed: they leave, the peak stays
            assert acc.live[d3] == 0 and acc.peak[d3] == 2 * 256 * 256 * 4
            del v
        assert acc.flops[d3] == 2 * 256 ** 3
        with FlopCounterMode(display=False) as fc:
            (a @ a).sum()
    assert fc.get_total_flops() == 2 * 256 ** 3


def test_psum_record_is_ring_model():
    xs = [torch.ones(1000, dtype=torch.float32), torch.ones(1000, dtype=torch.float32)]
    with dist.recording() as rec:
        out = dist.psum(xs)
    assert [o.tolist() for o in out] == [[2.0] * 1000] * 2
    assert rec.summary() == [("all-reduce", 4000, 2, "forward")]
    with FakeTensorMode():  # the same psum with its two shards on two devices
        xs = [torch.empty(1000, device="cpu:0"), torch.empty(1000, device="cpu:1")]
        with dist.recording() as rec:
            dist.psum(xs)
    wire = dryrun.wire_bytes(rec.entries, lambda d: d.index)
    for d in (0, 1):  # the ring all-reduce: 2·X·(n−1)/n on each shard
        assert wire[d]["bytes"]["all-reduce"] == 2 * 4000 * (2 - 1) / 2
        assert wire[d]["counts"]["all-reduce"] == 1


def _small_cfg(arch="olmo-1b"):
    return dataclasses.replace(reduced_config(arch), n_layers=2)


def test_collective_record_real_equals_fake():
    """tp2×dp2 training of a reduced olmo: the record of a real step on a
    CPU mesh equals the fake trace's, entry for entry, backward included;
    FLOPs agree too."""
    cfg, shape = _small_cfg(), ShapeConfig("t", 32, 4, "train")
    real = build_cell("olmo-1b", shape, make_mesh((2, 2), ("data", "model"), device="cpu"),
                      cfg=cfg, fill=True)
    t_real = dryrun.trace(real)
    with FakeTensorMode():
        fake = build_cell("olmo-1b", shape, make_fake_mesh((2, 2), ("data", "model")), cfg=cfg)
        t_fake = dryrun.trace(fake)
    assert t_real["record"].summary() == t_fake["record"].summary()
    phases = {ph for *_, ph in t_fake["record"].summary()}
    assert phases == {"forward", "backward"}
    assert sum(t_real["acc"].flops.values()) == sum(t_fake["acc"].flops.values())
    # the four shards, and host scalars (the schedule's step) on plain "cpu"
    peak = t_fake["acc"].peak
    assert set(range(4)) <= set(peak) and all(peak[d] < 1024 for d in set(peak) - set(range(4)))


class _Copies(TorchDispatchMode):
    """The storages cross-device copies read from."""

    def __init__(self):
        super().__init__()
        self.sources = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._to_copy.default and out.device != args[0].device:
            self.sources.add(args[0].untyped_storage()._cdata)
        return out


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_resident_decode(mesh_shape):
    cfg = dataclasses.replace(reduced_config("olmo-1b"), n_layers=4)
    pol = PolicyConfig(kind="fier", budget=64, group=8, skip_layers=1)
    dcfg = lambda mesh: DistConfig(mesh=mesh, seq_axes=("model",), batch_axes=("data",))
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    plain = build_model(cfg, pol, device="cpu")
    sharded = build_model(cfg, pol, dcfg(mesh), device="cpu")
    dense = build_model(cfg, PolicyConfig(kind="full"), device="cpu")
    params = plain.compute_params(plain.init(0))
    toks = torch.from_numpy((np.arange(64).reshape(2, 32) * 5 % 89).astype(np.int64))
    batch = {"tokens": toks, "lengths": torch.full((2,), 32, dtype=torch.int32)}
    logits, cache = plain.prefill(params, batch, capacity=64)
    tok = logits.argmax(-1).to(torch.int32)
    sh = cache_shardings(cache, mesh, ("data",), ("model",), cache_batch_axes(sharded.init_cache, 64))
    placed = place_tree(cache, sh)
    for leaf in (placed["front"]["k"], placed["rest"]["v"], placed["rest"]["meta"].codes):
        assert len({p.data_ptr() for p in leaf.pieces}) == mesh.size
    l_plain, c_plain = plain.decode_step(params, tok, cache)
    l_sh, c_sh = sharded.decode_step(params, tok, placed)
    c_sh = gather_tree(c_sh)
    l_dense, _ = dense.decode_step(params, tok, dense.prefill(params, batch, capacity=64)[1])
    scale = l_dense[:, :cfg.vocab].abs().max()
    assert (l_sh - l_dense)[:, :cfg.vocab].abs().max() <= DENSE_TOL * scale
    for name in ("k", "v"):  # the first sequence-sharded layer's append
        assert torch.equal(c_sh["front"][name][:1], c_plain["front"][name][:1])
    assert torch.equal(c_sh["length"], c_plain["length"])
    # on fake devices: no copy reads a storage of a slab (the lengths move)
    with FakeTensorMode():
        fmesh = make_fake_mesh(mesh_shape, ("data", "model"))
        cell = build_cell("olmo-1b", ShapeConfig("d", 256, 2, "decode"), fmesh, cfg=cfg, budget=64)
        slabs = {k: v for k, v in cell.args[2].items() if k != "length"}  # K, V, side-car
        cache_keys = {t.untyped_storage()._cdata for t in tree_tensors(slabs)}
        watch = _Copies()
        with dist.recording() as rec, watch:
            cell.fn(*cell.args)
    assert watch.sources and not watch.sources & cache_keys
    B_loc, Hq, D = 2 // mesh_shape[0], cfg.n_heads, cfg.d_head
    merges = [b for k, b, n, _, _ in rec.entries if k == "all-reduce"]
    assert merges and max(merges) <= B_loc * Hq * D * 4  # the LSE merge's partials


def test_dryrun_cli_prints_every_field(cli_run):
    out, err = cli_run.communicate(timeout=600)
    assert cli_run.returncode == 0, err[-3000:]
    rec = json.loads(out.strip().splitlines()[-1])
    for field in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                  "per_device_bytes", "flops", "bytes_accessed", "collectives",
                  "model_flops_global", "model_flops_per_device", "trace_s",
                  "busiest_device", "peak_sum_bytes"):
        assert field in rec, field
    assert rec["mesh"] == "16x16" and rec["devices"] == 256 and rec["kind"] == "decode"
    coll = rec["collectives"]
    assert {"all-reduce", "all-gather", "counts", "total", "other", "other_count"} <= set(coll)
    # one layer's K/V per device: 8 rows x 2048 positions x 16 heads x 128 x bf16, twice
    kv = 2 * 8 * 2048 * 16 * 128 * 2
    assert kv < rec["argument_size_in_bytes"] < 4 * kv
    assert rec["per_device_bytes"] == rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
