"""The weight axes of the mesh (`sharding.distribute`, DTensor params and
optimizer state placed by `train.state_pspecs`, `shard` at the
reference's 17 model call sites), held over gloo on the CPU against the
port's one-process forms (themselves held against the reference in
tests/test_torch_{train,moe,ssm,hybrid,serve}.py; the reference's own
sharded step raises on the installed jax):

  * the 17 sites: a spy on the reference's `shard` and one on the port's
    record the same (logical axes, shape) sequence through a reduced
    forward of each family (dense, MoE, SSM, hybrid);
  * placement on (1, 2, 2), (1, 1, 4) and (2, 2, 1): every param and
    optimizer-state leaf's local block bitwise its `local_block` of the
    unsharded draw;
  * step parity (f32, AdamW) on (1, 2, 2) and (1, 1, 4) for reduced
    granite-8b, qwen3-moe (the expert axis), mamba2-130m (its "2d"
    profile set on both sides: "dp" replicates every weight) and jamba:
    the loss, every gradient and the params after one step within rtol
    1e-5 (atol 1e-5 x max) of the one-process step (run under the
    mesh's shape, so that the MoE dispatch keeps the same batch groups);
  * SGD-M, Muon and Adafactor on DTensor leaves against the same update
    on plain tensors (granite, (1, 2, 2); Muon's steps, orthogonalized in
    bfloat16, within 5 % in norm, its momentum within rtol 1e-5);
  * Uno on (2, 1, 2): each rank's synced local blocks bitwise the stacked
    `_pod_ring_psum` fed the pods' blocks; the step within the
    reference's 5e-4 params and 1e-2 loss of the baseline on the mesh;
  * serving reduced qwen2.5-3b (f32) on (1, 2, 2): the no-mesh engine's
    greedy tokens;
  * the elastic reshard (the reference's tests/test_ft.py:157-193):
    saved on a (2, 2) data x model mesh, restored onto (4,) model and
    onto one process bitwise; a checkpoint the reference writes on its
    forced 4-device (2, 2) mesh restored bitwise onto the port's sharded
    state; `ft.Supervisor(state_shardings=)` restores onto the
    placements;
  * `launch.train --mesh 1x2x2` (granite, bf16) within 1e-2 of the
    no-group run's losses, every rank alike.

All ranks are one spawned gloo group of 4."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding as TS  # noqa: E402
from repro_torch import train as TT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.core import uno_collectives as TU  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

BATCH, SEQ = 8, 32
RUN = TB.RunConfig(uno_chunks=4, learning_rate=1e-3, warmup_steps=2)
NAMES = ("pod", "data", "model")
ARCHS = ("granite-8b", "qwen3-moe-235b-a22b", "mamba2-130m",
         "jamba-1.5-large-398b")
STEP_MESHES = ((1, 2, 2), (1, 1, 4))
PLACE_MESHES = ((1, 2, 2), (1, 1, 4), (2, 2, 1))
OPTS = ("sgdm", "muon", "adafactor")
CLI = ["--device", "cpu", "--reduced", "--arch", "granite-8b", "--steps",
       "3", "--batch", str(BATCH), "--seq", str(SEQ), "--log-every", "100"]
SERVE = dict(n=4, prompt=12, gen=5, batch=4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def f32_cfg(arch, **kw):
    """The reduced config in float32, AdamW, the "2d" sharding profile."""
    return dataclasses.replace(TB.reduced(TR.get_config(arch)),
                               param_dtype="float32",
                               compute_dtype="float32", optimizer="adamw",
                               sharding_profile="2d", **kw)


def f32_state(cfg):
    """The seeded one-process train state, params cast to float32."""
    st = TT.make_train_state(cfg, seed=0, device="cpu")
    leaves, treedef = TP.flatten(st["params"])
    st["params"] = TP.unflatten(treedef, [l.float() for l in leaves])
    st["opt"] = TT.optim.init_opt_state(st["params"], cfg)
    return st


def leaves_np(tree):
    return [t.detach().float().numpy() for t in TP.flatten(tree)[0]]


def flat_np(tree):
    return np.concatenate([l.reshape(-1) for l in leaves_np(tree)])


def one_process_step(cfg, shape):
    """(loss, grads, params after one update) of the one-process step on
    the whole batch, under the mesh's shape (the MoE batch groups)."""
    step = TT.make_train_step(cfg, RUN, device="cpu")
    state = f32_state(cfg)
    mesh = TS.Mesh(NAMES, shape)
    with TS.use_mesh(mesh, TS.profile_rules(cfg)):
        loss, grads = step.grads(state["params"], synth_batch(cfg, 0, BATCH,
                                                              SEQ))
    new = step.update(state, grads, 0)
    return loss, grads, new["params"]


def close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()),
                                               1e-30), err_msg=what)


# ------------------------------------------------------------ gloo ranks

_RANK = r"""
import datetime, sys
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
torch.set_num_threads(1)
rank, init, out, work = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[5]
dist.init_process_group("gloo", init_method=init, world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=300))
import test_torch_weight_axes as T
from repro_torch import ckpt, ft, optim, sharding, train
from repro_torch.configs import base as B, registry as R
from repro_torch.launch import mesh as M
from repro_torch.launch import serve
from repro_torch.launch import train as cli
from repro_torch.models import params as P
W = dist.group.WORLD
res = {}


def full(tree):
    return [t.full_tensor().detach().float().numpy()
            if sharding.is_dtensor(t) else t.detach().float().numpy()
            for t in P.flatten(tree)[0]]


def placed(cfg, mesh, st):
    sh = train.state_shardings(cfg, mesh)
    return {"params": sharding.distribute(st["params"], sh["params"]),
            "opt": dict(sharding.distribute(
                {k: v for k, v in st["opt"].items() if k != "step"},
                sh["opt"]), step=st["opt"]["step"])}


def rows(cfg, mesh, batch):
    sh = train.batch_shardings(cfg, mesh, batch)
    return {k: sh[k].local(v) for k, v in batch.items()}


def blocks_ok(tree, whole, shs) -> bool:
    flat_t = optim.flatten_with_paths(tree)
    flat_w = optim.flatten_with_paths(whole)
    for path, sh in optim.flatten_with_paths(shs).items():
        mine = flat_t[path]
        if tuple(mine.placements) != sh.placements:
            return False
        want = sh.local(flat_w[path]).contiguous()
        if not torch.equal(mine.to_local().view(torch.uint8)
                           if mine.dtype == torch.bfloat16 else
                           mine.to_local(), want.view(torch.uint8)
                           if want.dtype == torch.bfloat16 else want):
            return False
    return True


# placement: every leaf's block of the unsharded draw
cfg = B.reduced(R.get_config("granite-8b"))
whole = train.make_train_state(cfg, seed=0, device="cpu")
for shape in T.PLACE_MESHES:
    mesh = M.make_mesh(shape, T.NAMES)
    st = train.make_train_state(cfg, seed=0, device="cpu", mesh=mesh)
    res[f"place/{shape}"] = np.array(
        blocks_ok(st, whole, train.state_shardings(cfg, mesh))
        and st["opt"]["step"].equal(whole["opt"]["step"]))

# step parity, every family, two meshes
for arch in T.ARCHS:
    cfg = T.f32_cfg(arch)
    batch = T.synth_batch(cfg, 0, T.BATCH, T.SEQ)
    for shape in T.STEP_MESHES:
        mesh = M.make_mesh(shape, T.NAMES)
        state = placed(cfg, mesh, T.f32_state(cfg))
        step = train.make_train_step(cfg, T.RUN, device="cpu", mesh=mesh)
        loss, grads = step.mesh_grads(state["params"], rows(cfg, mesh, batch))
        new = step.update(state, grads, 0)
        key = f"{arch}/{shape}"
        res[f"{key}/loss"] = loss.numpy()
        for i, g in enumerate(full(grads)):
            res[f"{key}/g{i}"] = g
        for i, p in enumerate(full(new["params"])):
            res[f"{key}/p{i}"] = p
        res[f"{key}/placed"] = np.array(all(
            tuple(a.placements) == tuple(b.placements) for a, b in
            zip(P.flatten(new["params"])[0], P.flatten(state["params"])[0])))

# the other optimizers on DTensor leaves, granite on (1, 2, 2)
mesh = M.make_mesh((1, 2, 2), T.NAMES)
for opt in T.OPTS:
    cfg = T.f32_cfg("granite-8b")
    cfg = T.dataclasses.replace(cfg, optimizer=opt)
    st = T.f32_state(cfg)
    grads = T.grad_like(st["params"])
    state = placed(cfg, mesh, st)
    gd = sharding.distribute(grads, train.state_shardings(cfg, mesh)["params"])
    p2, o2 = optim.apply_updates(state["params"], gd, state["opt"], cfg, 1e-3)
    for i, p in enumerate(full(p2)):
        res[f"opt/{opt}/p{i}"] = p
    for i, p in enumerate(full({k: v for k, v in o2.items() if k != "step"})):
        res[f"opt/{opt}/o{i}"] = p

# Uno on (2, 1, 2): the pod ring on each rank's local blocks
cfg = T.f32_cfg("granite-8b")
mesh = M.make_mesh((2, 1, 2), T.NAMES)
batch = T.synth_batch(cfg, 0, T.BATCH, T.SEQ)
news = {}
for key, pods in (("base", 1), ("uno", 2)):
    state = placed(cfg, mesh, T.f32_state(cfg))
    step = train.make_train_step(cfg, T.RUN, n_pods=pods, device="cpu",
                                 mesh=mesh)
    mine = rows(cfg, mesh, batch)
    if pods > 1:
        _, pre = step.pod_mesh_grads(state["params"], mine)
        res["uno/pre"] = T.flat_np(sharding.local_tree(pre))
    loss, grads = step.mesh_grads(state["params"], mine)
    if pods > 1:
        res["uno/post"] = T.flat_np(sharding.local_tree(grads))
    res[f"{key}/loss"] = loss.numpy()
    new = step.update(state, grads, 0)
    for i, p in enumerate(full(new["params"])):
        res[f"{key}/p{i}"] = p

# serving on (1, 2, 2)
cfg = T.f32_cfg("qwen2.5-3b")
mesh = M.make_mesh((1, 2, 2), T.NAMES)
reqs = T.requests(cfg)
serve.serve(cfg, reqs, batch=T.SERVE["batch"],
            max_len=T.SERVE["prompt"] + T.SERVE["gen"], mesh=mesh,
            params=T.f32_state(cfg)["params"], device="cpu")
res["serve/tokens"] = np.array([r.out for r in reqs])

# the elastic reshard: (2, 2) data x model -> (4,) model and one process
cfg = B.reduced(R.get_config("granite-8b"))
mesh_a = M.make_mesh((2, 2), ("data", "model"))
st = train.make_train_state(cfg, seed=0, device="cpu", mesh=mesh_a)
step = train.make_train_step(cfg, T.RUN, device="cpu", mesh=mesh_a)
batch = T.synth_batch(cfg, 0, T.BATCH, T.SEQ)
loss, grads = step.mesh_grads(st["params"], rows(cfg, mesh_a, batch))
st = step.update(st, grads, 0)
host = ckpt.to_host(st)
if rank == 0:
    ckpt.write(work + "/ck", 1, host)
    np.savez(work + "/saved.npz", **{k: a for k, (a, _) in host.items()})
dist.barrier()
mesh_b = M.make_mesh((4,), ("model",))
sh_b = train.state_shardings(cfg, mesh_b)
tmpl = train.make_train_state(cfg, seed=1, device="cpu", mesh=mesh_b)
restored = ckpt.restore(work + "/ck", 1, tmpl, sh_b)
saved = {k: torch.from_numpy(a) for k, (a, _) in host.items()}
saved = {k: v.view(torch.bfloat16) if host[k][1] == "bfloat16" else v
         for k, v in ((k, v.view(torch.int16) if host[k][1] == "bfloat16"
                       else v) for k, v in saved.items())}
res["elastic/4"] = np.array(blocks_ok(restored, optim.unflatten_like(
    restored, saved), sh_b))
sup = ft.Supervisor(ft.FTConfig(ckpt_dir=work + "/ck"), state_template=tmpl,
                    state_shardings=sh_b, group=W)
back, start = sup.try_resume(tmpl, 0)
res["elastic/sup"] = np.array(start == 2 and blocks_ok(
    back, optim.unflatten_like(back, saved), sh_b))

# the reference's (2, 2) checkpoint onto the port's sharded state
rcfg = B.reduced(R.get_config("smollm-135m"))
with sharding.use_mesh(mesh_a):
    rsh = sharding.spec_tree_to_shardings(mesh_a, train.state_pspecs(rcfg))
rsh["opt"] = {k: v for k, v in rsh["opt"].items() if k != "step"}
plain = train.make_train_state(rcfg, seed=0, device="cpu")
ref = ckpt.restore(work + "/refck", 1, plain, rsh)
want = dict(np.load(work + "/ref_state.npz"))
res["elastic/ref"] = np.array(blocks_ok(ref, optim.unflatten_like(plain, {
    k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        if v.dtype == np.uint16 else torch.from_numpy(v))
    for k, v in want.items()}), rsh))

# the CLI over a 1x2x2 mesh
res["cli/losses"] = np.array(cli.main(T.CLI + ["--mesh", "1x2x2"])["losses"])
np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
print("ok")
"""

_REF_CKPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro import ckpt, optim, sharding, train
from repro.configs.base import reduced
from repro.configs.registry import get_config
cfg = reduced(get_config("smollm-135m"))
mesh_a = jax.make_mesh((2, 2), ("data", "model"))
with sharding.use_mesh(mesh_a):
    state = train.make_train_state(cfg, jax.random.PRNGKey(0))
    specs = train.state_pspecs(cfg)
    sh = sharding.spec_tree_to_shardings(mesh_a, specs)
    state = jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh)
    ckpt.save(sys.argv[1] + "/refck", 1, state)
flat = optim.flatten_with_paths(state)
np.savez(sys.argv[1] + "/ref_state.npz", **{
    k: (np.asarray(v).view(np.uint16) if np.asarray(v).dtype.name ==
        "bfloat16" else np.asarray(v)) for k, v in flat.items()})
print("ok")
"""


def grad_like(params):
    """A seeded gradient tree shaped as `params` (float32)."""
    rng = np.random.default_rng(7)
    leaves, treedef = TP.flatten(params)
    return TP.unflatten(treedef, [torch.tensor(rng.normal(
        size=tuple(l.shape)).astype(np.float32) * 1e-2) for l in leaves])


def requests(cfg):
    rng = np.random.default_rng(3)
    return [TSV.Request(i, rng.integers(0, cfg.vocab, SERVE["prompt"],
                                        dtype=np.int32), SERVE["gen"])
            for i in range(SERVE["n"])]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("weight_ranks")
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", _REF_CKPT, str(d)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert ref.returncode == 0, ref.stderr[-2000:]
    init = f"file://{d / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init, str(d / f"r{r}.npz"),
         here, str(d)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), errs
    out = [dict(np.load(d / f"r{r}.npz")) for r in range(4)]
    out.append(d)
    return out


# ------------------------------------------------------------ the 17 sites

FAMILIES = {"dense": "granite-8b", "moe": "qwen3-moe-235b-a22b",
            "ssm": "mamba2-130m", "hybrid": "jamba-1.5-large-398b"}


def _spy(monkeypatch, modules, calls):
    def make(orig):
        def spy(x, *axes):
            calls.append((tuple(axes), tuple(int(n) for n in x.shape)))
            return orig(x, *axes)
        return spy
    for m in modules:
        monkeypatch.setattr(m, "shard", make(m.shard))


@pytest.mark.parametrize("family", tuple(FAMILIES))
def test_shard_sites_match_the_reference(monkeypatch, family):
    """Both packages' `shard` calls through one loss forward (one layer,
    or one hybrid period; one loss chunk): the same logical axes on the
    same shapes, in the same order.  The reference's scans trace each
    body once, the port's loops run it once at this depth."""
    import jax
    import jax.numpy as jnp
    from repro import models as RM
    from repro.configs import base as RB
    from repro.configs import registry as RR
    from repro.models import (hybrid as rh, layers as rl, mamba2 as rm2,
                              moe as rmo, ssm as rs, transformer as rt)
    from repro_torch import models as PM
    from repro_torch.models import (hybrid as ph, layers as pl,
                                    mamba2 as pm2, moe as pmo, ssm as ps,
                                    transformer as pt)
    arch = FAMILIES[family]
    depth = 2 if family == "hybrid" else 1
    rcfg = dataclasses.replace(RB.reduced(RR.get_config(arch)),
                               n_layers=depth)
    tcfg = dataclasses.replace(TB.reduced(TR.get_config(arch)),
                               n_layers=depth)
    ref_calls, port_calls = [], []
    _spy(monkeypatch, (rl, rt, rmo, rm2, rs, rh), ref_calls)
    _spy(monkeypatch, (pl, pt, pmo, pm2, ps, ph), port_calls)
    batch = synth_batch(tcfg, 0, 2, 16)
    rbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    RM.loss_fn(params, rbatch, rcfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        PM.loss_fn(PM.init_params(tcfg, gen), batch, tcfg)
    assert ref_calls == port_calls
    sites = {"dense": 7, "moe": 10, "ssm": 4, "hybrid": 13}[family]
    assert len(port_calls) == sites


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("shape", PLACE_MESHES)
def test_every_block_is_its_local_block_of_the_draw(ranks, shape):
    for r in range(4):
        assert bool(ranks[r][f"place/{shape}"]), r


@pytest.mark.parametrize("shape", STEP_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_process(ranks, arch, shape):
    cfg = f32_cfg(arch)
    loss, grads, params = one_process_step(cfg, shape)
    key = f"{arch}/{shape}"
    res = ranks[0]
    close(res[f"{key}/loss"], loss.numpy(), f"{key} loss")
    for i, g in enumerate(leaves_np(grads)):
        close(res[f"{key}/g{i}"], g, f"{key} grad {i}")
    for i, p in enumerate(leaves_np(params)):
        close(res[f"{key}/p{i}"], p, f"{key} param {i}")
    for r in range(4):
        assert bool(ranks[r][f"{key}/placed"]), r
        assert np.array_equal(ranks[r][f"{key}/loss"], res[f"{key}/loss"])


@pytest.mark.parametrize("opt", OPTS)
def test_optimizers_on_dtensor_leaves(ranks, opt):
    cfg = dataclasses.replace(f32_cfg("granite-8b"), optimizer=opt)
    st = f32_state(cfg)
    p2, o2 = TT.optim.apply_updates(st["params"], grad_like(st["params"]),
                                    st["opt"], cfg, 1e-3)
    for i, (p, p0) in enumerate(zip(leaves_np(p2),
                                    leaves_np(st["params"]))):
        got = ranks[0][f"opt/{opt}/p{i}"]
        if opt == "muon":
            # Newton-Schulz runs its five iterations in bfloat16, and
            # DTensor sums a sharded product in another order: the
            # orthogonalized steps agree in norm to bfloat16's few bits
            step = p - p0
            gap = float(np.linalg.norm(got - p0 - step) /
                        np.linalg.norm(step))
            assert gap <= 5e-2, (i, gap)
        else:
            close(got, p, f"{opt} param {i}")
    for i, o in enumerate(leaves_np({k: v for k, v in o2.items()
                                     if k != "step"})):
        close(ranks[0][f"opt/{opt}/o{i}"], o, f"{opt} state {i}")


def test_uno_ring_on_local_blocks_2x1x2(ranks):
    """Ranks 0, 1 are pod 0's model shards, 2, 3 pod 1's: the ring pairs
    rank m with rank 2 + m, on their blocks."""
    for m in (0, 1):
        pre = np.stack([ranks[m]["uno/pre"], ranks[2 + m]["uno/pre"]])
        ring = TU._pod_ring_psum(torch.tensor(pre), RUN, 2).numpy()
        assert not np.array_equal(ring[0], ring[1])
        assert np.array_equal(ranks[m]["uno/post"], ring[0]), m
        assert np.array_equal(ranks[2 + m]["uno/post"], ring[1]), m
    res = ranks[0]
    assert abs(float(res["uno/loss"]) - float(res["base/loss"])) <= 1e-2
    n = len([k for k in res if k[5:].isdigit() and k.startswith("uno/p")])
    assert n and n == len([k for k in res if k.startswith("base/p")])
    for i in range(n):
        assert float(np.max(np.abs(res[f"uno/p{i}"] - res[f"base/p{i}"]))) \
            <= 5e-4, i


def test_serving_on_a_mesh_gives_the_no_mesh_tokens(ranks):
    cfg = f32_cfg("qwen2.5-3b")
    reqs = requests(cfg)
    TSV.serve(cfg, reqs, batch=SERVE["batch"],
              max_len=SERVE["prompt"] + SERVE["gen"],
              params=f32_state(cfg)["params"], device="cpu")
    want = np.array([r.out for r in reqs])
    for r in range(4):
        assert np.array_equal(ranks[r]["serve/tokens"], want), r


def test_elastic_reshard(ranks):
    from repro_torch import ckpt
    d = ranks[4]
    for r in range(4):
        assert bool(ranks[r]["elastic/4"]), r
        assert bool(ranks[r]["elastic/sup"]), r
        assert bool(ranks[r]["elastic/ref"]), r
    cfg = TB.reduced(TR.get_config("granite-8b"))
    tmpl = TT.make_train_state(cfg, seed=1, device="cpu")
    one = ckpt.restore(d / "ck", 1, tmpl)
    saved = dict(np.load(d / "saved.npz"))
    for path, leaf in TT.optim.flatten_with_paths(one).items():
        got = leaf.view(torch.int16).numpy().view(np.uint16) \
            if leaf.dtype == torch.bfloat16 else leaf.numpy()
        assert np.array_equal(got, saved[path]), path


def test_train_cli_on_a_1x2x2_mesh(ranks):
    base = train_cli.main(CLI)["losses"]
    for r in range(4):
        got = ranks[r]["cli/losses"]
        assert got.shape == (3,) and np.all(np.isfinite(got))
        assert float(np.max(np.abs(got - np.array(base)))) <= 1e-2, r
        assert np.array_equal(got, ranks[0]["cli/losses"])
