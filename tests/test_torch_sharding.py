"""The port's logical-axis layer (`repro_torch.sharding`, `launch.mesh`,
`models.param_pspecs`, `train.batch_pspecs` / `state_pspecs`) against the
reference's (`repro.sharding`, `repro.launch.mesh`, ...).

  * `resolve`: every ParamDef of all 10 archs at full size, with and
    without `profile_rules`, on the (16, 16) and (2, 16, 16) production
    meshes and on (2, 2, 2), equals the reference's PartitionSpec entry
    for entry; so do hand-picked shapes the divisibility rule drops
    axes from, `batch_group_count` and the batch specs;
  * `state_pspecs` for AdamW, Adafactor (the factored states) and Muon
    on every arch;
  * placements on a 2 x 2 x 2 mesh: each rank's block (offsets and
    sizes) equals the index of the reference's addressable shard on
    device r, and the block DTensor computes for the port's placements
    on that rank (over a fake process group of 8 ranks);
  * `use_rules` / `use_mesh` restore the rules; the active mesh is
    process-wide (autograd's device thread sees it).

The reference side runs in one subprocess with 512 forced host devices
(the production meshes need them)."""
import json
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as TM  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch import sharding as TS  # noqa: E402
from repro_torch import train as TT  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
OPTIMIZERS = ("adamw", "adafactor", "muon")
# (logical axes, shape): shapes the divisibility rule drops axes from
DROPS = [(("tensor",), (9,)), (("batch", None), (1, 7)),
         (("batch", None), (6, 3)), (("batch", "seq"), (16, 4)),
         (("fsdp", "tensor"), (576, 1536)), (("vocab", "fsdp"), (49152, 9)),
         (("fsdp_pod", "tensor"), (3, 32)), (("expert", None, "tensor"),
                                             (128, 4, 30)),
         (("kv_batch", "seq_kv", "tensor", None), (4, 8, 3, 64)),
         (("batch", "batch"), (8, 8)), (("none", "unknown"), (4, 4))]
GROUP_NS = (1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 256, 512, 1000)
PLACE = [(("pod", "data"), None), (("pod", "data"), "model"),
         (None, ("data", "model")), (("pod", "data", "model"),),
         ("model", "data"), (None, "pod", None), ()]
PLACE_SHAPE = {1: (16,), 2: (8, 12), 3: (4, 6, 8)}


def _place_shape(spec):
    return PLACE_SHAPE.get(len(spec), (8, 12))


_REF = r"""
import os, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import models, optim, sharding, train
from repro.configs.registry import ARCH_IDS, get_config
from repro.launch.mesh import make_production_mesh, make_mesh
MESHES = json.loads(%r)
DROPS = json.loads(%r)
NS = json.loads(%r)
PLACE = json.loads(%r)
OPTS = json.loads(%r)

def enc(spec):
    return [None if e is None else (e if isinstance(e, str) else list(e))
            for e in spec]

def flat(tree):
    return {k: enc(v) for k, v in optim.flatten_with_paths(tree).items()}

meshes = {"pod16x16": make_production_mesh(),
          "multipod": make_production_mesh(multi_pod=True),
          "2x2x2": make_mesh((2, 2, 2), ("pod", "data", "model"))}
out = {"params": {}, "state": {}, "drops": {}, "groups": {}, "place": {}}
for mname, mesh in meshes.items():
    assert tuple(mesh.devices.shape) == tuple(MESHES[mname][0])
    for a in ARCH_IDS:
        cfg = get_config(a)
        for prof in (False, True):
            rules = sharding.profile_rules(cfg) if prof else None
            with sharding.use_mesh(mesh, rules):
                out["params"][f"{mname}|{a}|{prof}"] = flat(
                    models.param_pspecs(cfg))
                out["groups"][f"{mname}|{a}|{prof}"] = [
                    sharding.batch_group_count(n) for n in NS]
                if mname != "pod16x16" and not prof:
                    for o in OPTS:
                        c = dataclasses.replace(cfg, optimizer=o)
                        out["state"][f"{mname}|{a}|{o}"] = flat(
                            train.state_pspecs(c))
    with sharding.use_mesh(mesh):
        out["drops"][mname] = [enc(sharding.resolve(*ax, shape=sh))
                               for ax, sh in DROPS]
        with sharding.use_rules({"batch": ("data",)}):
            out["drops"][mname + "|data_batch"] = [
                enc(sharding.resolve(*ax, shape=sh)) for ax, sh in DROPS]
mesh = meshes["2x2x2"]
devs = list(mesh.devices.flat)
for i, (spec, shape) in enumerate(PLACE):
    idx = NamedSharding(mesh, P(*[tuple(e) if isinstance(e, list) else e
                                  for e in spec])).devices_indices_map(
        tuple(shape))
    out["place"][str(i)] = [
        [[s.start or 0, (s.stop if s.stop is not None else n) - (s.start or 0)]
         for s, n in zip(idx[d], shape)] for d in devs]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    place = [[list(e) if isinstance(e, tuple) else e for e in spec]
             for spec in PLACE]
    place = [(s, _place_shape(s)) for s in place]
    script = _REF % (json.dumps({k: [list(v[0]), list(v[1])]
                                 for k, v in MESHES.items()}),
                     json.dumps(DROPS), json.dumps(GROUP_NS),
                     json.dumps(place), json.dumps(OPTIMIZERS))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _enc(spec):
    return [None if e is None else (e if isinstance(e, str) else list(e))
            for e in spec]


def _flat(tree):
    return {k: _enc(v) for k, v in TO.flatten_with_paths(tree).items()}


def _mesh(name):
    if name == "pod16x16":
        return TMESH.make_production_mesh()
    if name == "multipod":
        return TMESH.make_production_mesh(multi_pod=True)
    return TS.Mesh(("pod", "data", "model"), (2, 2, 2))


@pytest.mark.parametrize("mname", tuple(MESHES))
def test_param_specs_equal_reference(ref, mname):
    mesh = _mesh(mname)
    assert mesh.shape == MESHES[mname][0]
    n = 0
    for a in TR.ARCH_IDS:
        cfg = TR.get_config(a)
        for prof in (False, True):
            rules = TS.profile_rules(cfg) if prof else None
            with TS.use_mesh(mesh, rules):
                got = _flat(TM.param_pspecs(cfg))
                groups = [TS.batch_group_count(k) for k in GROUP_NS]
            assert got == ref["params"][f"{mname}|{a}|{prof}"], (a, prof)
            assert groups == ref["groups"][f"{mname}|{a}|{prof}"], (a, prof)
            n += len(got)
    assert n > 400
    assert TM.param_pspecs(TR.get_config("smollm-135m"))["lm_head"] == ()


@pytest.mark.parametrize("mname", ("multipod", "2x2x2"))
def test_state_specs_equal_reference(ref, mname):
    import dataclasses
    mesh = _mesh(mname)
    seen_factored = False
    for a in TR.ARCH_IDS:
        for o in OPTIMIZERS:
            cfg = dataclasses.replace(TR.get_config(a), optimizer=o)
            with TS.use_mesh(mesh):
                got = _flat(TT.state_pspecs(cfg))
            assert got == ref["state"][f"{mname}|{a}|{o}"], (a, o)
            seen_factored |= any(k.endswith("/vr") for k in got)
    assert seen_factored


@pytest.mark.parametrize("mname", tuple(MESHES))
def test_divisibility_dropping_and_rules_equal_reference(ref, mname):
    with TS.use_mesh(_mesh(mname)):
        got = [_enc(TS.resolve(*ax, shape=sh)) for ax, sh in DROPS]
        with TS.use_rules({"batch": ("data",)}):
            got2 = [_enc(TS.resolve(*ax, shape=sh)) for ax, sh in DROPS]
    assert got == ref["drops"][mname]
    assert got2 == ref["drops"][mname + "|data_batch"]
    if mname == "pod16x16":
        assert got[0] == [None]                # 9 heads on a 16-way axis


def test_batch_specs_split_pod_major():
    mesh = TS.Mesh(("pod", "data", "model"), (2, 2, 1))
    cfg = TR.get_config("smollm-135m")
    batch = {"inputs": torch.zeros(8, 16, dtype=torch.int64),
             "targets": torch.zeros(8, 16, dtype=torch.int32)}
    with TS.use_mesh(mesh):
        specs = TT.batch_pspecs(cfg, batch)
    assert specs == {"inputs": (("pod", "data"), None),
                     "targets": (("pod", "data"), None)}
    sh = TS.spec_tree_to_shardings(mesh, specs)
    x = torch.arange(8)[:, None].expand(8, 16)
    for r in range(4):
        coord = {"pod": r // 2, "data": r % 2, "model": 0}
        rows = sh["inputs"].local(x, coord)
        assert rows[:, 0].tolist() == [2 * r, 2 * r + 1]


def _fake_rank_blocks(mesh_shape, names, cases):
    """DTensor's local shape and offset for the port's placements, for
    every rank of a fake process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = int(np.prod(mesh_shape))
    out = []
    for r in range(n):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=n)
        try:
            dm = DeviceMesh("cpu", torch.arange(n).reshape(mesh_shape),
                            mesh_dim_names=names)
            mesh = TS.Mesh(names, mesh_shape, dm)
            row = []
            for spec, shape in cases:
                sh = TS.NamedSharding(mesh, spec)
                size, off = compute_local_shape_and_global_offset(
                    shape, dm, sh.placements)
                row.append((tuple(off), tuple(size), sh.local_block(shape)))
            out.append(row)
        finally:
            dist.destroy_process_group()
    return out


def test_placements_equal_reference_shards(ref):
    names, shape3 = ("pod", "data", "model"), (2, 2, 2)
    mesh = TS.Mesh(names, shape3)
    cases = [(spec, _place_shape(spec)) for spec in PLACE]
    dtensor = _fake_rank_blocks(shape3, names, cases)
    for i, (spec, shape) in enumerate(cases):
        sh = TS.NamedSharding(mesh, spec)
        assert len(sh.placements) == 3
        for r in range(8):
            coord = dict(zip(names, np.unravel_index(r, shape3)))
            offs, lens = sh.local_block(shape, coord)
            want = ref["place"][str(i)][r]
            assert [[o, n] for o, n in zip(offs, lens)] == want, (spec, r)
            d_off, d_len, own = dtensor[r][i]
            assert (d_off, d_len) == (offs, lens) == own, (spec, r)
    from torch.distributed.tensor import Replicate, Shard
    assert TS.NamedSharding(mesh, (("pod", "data"), "model")).placements \
        == (Shard(0), Shard(0), Shard(1))
    assert TS.NamedSharding(mesh, ()).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        TS.NamedSharding(mesh, (("data", "pod"),)).placements


def test_no_mesh_and_rules_restore():
    assert TS.resolve("batch", None) == ()
    assert TS.named_sharding("batch") is None
    assert TS.batch_group_count(8) == 1
    x = torch.ones(3)
    assert TS.shard(x, "batch") is x
    prev = dict(TS._STATE.rules)
    mesh = TMESH.make_production_mesh(multi_pod=True)
    with TS.use_mesh(mesh, {"batch": ("data",)}):
        assert TS.active_mesh() is mesh
        assert TS._STATE.rules["batch"] == ("data",)
        with TS.use_rules({"batch": ("pod",)}):
            assert TS.resolve("batch", shape=(4,)) == ("pod",)
        assert TS.resolve("batch", shape=(32,)) == ("data",)
        assert TS.shard(x, "batch") is x        # a rank-local tensor
        assert TS.named_sharding("batch", None, shape=(32, 3)).spec == \
            ("data", None)
        seen = {}
        t = threading.Thread(target=lambda: seen.update(
            mesh=TS.active_mesh(), rules=dict(TS._STATE.rules)))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        # process-wide: the autograd engine's device thread (a CUDA
        # backward, a checkpoint's recompute) sees the forward's mesh
        assert seen == {"mesh": mesh,
                        "rules": {**TS.DEFAULT_RULES, "batch": ("data",)}}
    assert TS.active_mesh() is None and TS._STATE.rules == prev


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        TMESH.make_mesh((2, 1, 1), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="shape-only"):
        TMESH.make_production_mesh().coordinate()
