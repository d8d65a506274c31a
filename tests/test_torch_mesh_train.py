"""The train step over pod x data ranks (`train.TrainStep(mesh=)`,
`launch.mesh.make_mesh`, `data.ShardedPipeline(shardings=)`,
`ft.Supervisor(group=)`, `launch.train --mesh PxDx1` in a process group)
and UnoRC's ring over ranks (`uno_collectives`, ``group=``), held over
gloo on the CPU against the port's one-process forms (themselves held
against the reference in tests/test_torch_train.py and
test_torch_unorc.py; the reference's own sharded train step raises on
the installed jax):

  * the Uno ring at p = 2 and p = 4 ranks on a reduced smollm gradient:
    rank i's result bitwise row i of the stacked `_pod_ring_psum`, and
    `make_uno_grad_sync(group=)` on rank 0 bitwise the stacked sync;
  * `1x2x1` baseline (f32): loss and gradients within rtol 1e-5 of the
    one-process step on the whole batch;
  * `2x1x1` Uno (f32): rank 0's first step (loss, gradients, updated
    params) bitwise the one-card Uno step;
  * `2x2x1` Uno (f32): each pod's gradients over its data ranks (the
    DTensor reduction of `pod_mesh_grads`) within rtol 1e-5 of that
    pod's row of the one-process `pod_grads`, and every rank's
    `mesh_grads` bitwise its pod's row of the stacked ring fed those
    blocks;
  * `2x2x1` Uno through the CLI, 3 steps: losses within 1e-2 of the
    one-process baseline's (tests/test_collectives.py's bar), the same on
    every rank (a set-up check: the warm-up lr barely moves the weights);
  * a 2-rank restart drill: rank 0 writes, both ranks restore the saved
    state bitwise and finish bitwise where an uninterrupted run ends;
  * `sharding.shard` redistributes a DTensor to the resolved placements;
  * the refusals: no group, too few ranks; a model axis builds its
    step, and on the CLI it needs torchrun's ranks.

All ranks are one spawned gloo group of 4 (~15 s)."""
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
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

BATCH, SEQ = 8, 32
RUN = TB.RunConfig(uno_chunks=4, learning_rate=1e-3, warmup_steps=2)
NAMES = ("pod", "data", "model")
CLI = ["--device", "cpu", "--reduced", "--steps", "3", "--batch", str(BATCH),
       "--seq", str(SEQ), "--log-every", "100"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def f32_cfg():
    return dataclasses.replace(TB.reduced(TR.get_config("smollm-135m")),
                               param_dtype="float32",
                               compute_dtype="float32")


def f32_state(cfg, mesh=None):
    """The seeded train state (on a mesh: DTensors, each rank's blocks of
    rank 0's draw), params cast to float32."""
    st = TT.make_train_state(cfg, seed=0, device="cpu", mesh=mesh)
    leaves, treedef = TP.flatten(st["params"])
    st["params"] = TP.unflatten(treedef, [l.float() for l in leaves])
    return st


def grad_tree(p: int):
    """A pod-stacked reduced-smollm gradient (bf16 leaves), seeded."""
    cfg = TB.reduced(TR.get_config("smollm-135m"))
    rng = np.random.default_rng(p)
    leaves, treedef = TP.flatten(TT.models.abstract_params(cfg))
    return TP.unflatten(treedef, [torch.tensor(
        rng.normal(size=(p,) + tuple(l.shape)).astype(np.float32) * 1e-2
    ).to(l.dtype) for l in leaves])


def global_batch(cfg, step=0):
    return synth_batch(cfg, step, BATCH, SEQ)


def leaves_np(tree):
    """Every leaf as a float32 array (a DTensor gathered whole: every rank
    of its mesh calls it)."""
    return [(t.full_tensor() if TS.is_dtensor(t) else t).detach().float()
            .numpy() for t in TP.flatten(tree)[0]]


def flat_np(tree):
    """Every leaf, flattened in leaf order into one float32 vector (the
    order of `uno_collectives._flatten`)."""
    return np.concatenate([l.reshape(-1) for l in leaves_np(tree)])


# ------------------------------------------------------------ gloo ranks

_RANK = r"""
import datetime, sys
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
torch.set_num_threads(1)
rank, init, out, ckdir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[5]
dist.init_process_group("gloo", init_method=init, world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
import test_torch_mesh_train as T
from repro_torch import data, ft, sharding, train
from repro_torch.core import uno_collectives as U
from repro_torch.launch import mesh as M
from repro_torch.launch import train as cli
from repro_torch.models import params as P
W = dist.group.WORLD
g01 = dist.new_group([0, 1])
res = {}
cfg = T.f32_cfg()

# the Uno ring over ranks
for p, grp in ((2, g01), (4, W)):
    if rank < p:
        stacked = T.grad_tree(p)
        flat, _ = U._flatten(stacked, p)
        res[f"ring{p}"] = U._pod_ring_psum(flat[rank:rank + 1].clone(), T.RUN,
                                           p, group=grp).numpy()[0]
        mine = P.unflatten(P.flatten(stacked)[1],
                           [l[rank] for l in P.flatten(stacked)[0]])
        sync = U.make_uno_grad_sync(cfg, T.RUN, p, "cpu", group=grp)
        for i, l in enumerate(T.leaves_np(sync(mine))):
            res[f"sync{p}/{i}"] = l


def local(mesh, batch):
    sh = train.batch_shardings(cfg, mesh, batch)
    return {k: sh[k].local(v) for k, v in batch.items()}, sh


# 1x2x1 baseline and 2x1x1 Uno, on the first two ranks
for key, shape, pods in (("base", (1, 2, 1), 1), ("uno", (2, 1, 1), 2)):
    mesh = M.make_mesh(shape, T.NAMES)
    if rank < 2:
        state = T.f32_state(cfg, mesh)
        step = train.make_train_step(cfg, T.RUN, n_pods=pods, device="cpu",
                                     mesh=mesh)
        batch, _ = local(mesh, T.global_batch(cfg))
        loss, grads = step.mesh_grads(state["params"], batch)
        new = step.update(state, grads, 0)
        res[f"{key}/loss"] = loss.numpy()
        for i, l in enumerate(T.leaves_np(grads)):
            res[f"{key}/g{i}"] = l
        for i, l in enumerate(T.leaves_np(new["params"])):
            res[f"{key}/p{i}"] = l

# 2x2x1 Uno: this rank's own gradients (one process, no collective), its
# pod's gradients (the in-pod DTensor reduction) and mesh_grads
mesh4 = M.make_mesh((2, 2, 1), T.NAMES)
state = T.f32_state(cfg, mesh4)
step = train.make_train_step(cfg, T.RUN, n_pods=2, device="cpu", mesh=mesh4)
batch, _ = local(mesh4, T.global_batch(cfg))
own_loss, own = train.make_train_step(cfg, T.RUN, device="cpu").grads(
    T.f32_state(cfg)["params"], batch)
_, pre = step.pod_mesh_grads(state["params"], batch)
loss, grads = step.mesh_grads(state["params"], batch)
res["pd/own_loss"], res["pd/loss"] = own_loss.numpy(), loss.numpy()
res["pd/own"] = T.flat_np(own)
res["pd/pre"] = T.flat_np(sharding.local_tree(pre))
res["pd/grads"] = T.flat_np(sharding.local_tree(grads))

# sharding.shard redistributes a DTensor over the 2x2x1 mesh
from torch.distributed.tensor import Replicate, distribute_tensor
dt = distribute_tensor(torch.arange(32.0).reshape(8, 4), mesh4.device_mesh,
                       [Replicate()] * 3)
with sharding.use_mesh(mesh4):
    placed = sharding.shard(dt, "batch", None)
    want = sharding.named_sharding("batch", None, shape=(8, 4))
res["dt/ok"] = np.array(tuple(placed.placements) == want.placements)
res["dt/local"] = placed.to_local().numpy()
res["dt/want"] = want.local(torch.arange(32.0).reshape(8, 4)).numpy()

# 2x2x1 Uno through the CLI, every rank
res["cli/losses"] = np.array(cli.main(T.CLI + ["--mesh", "2x2x1", "--uno"])[
    "losses"])

# the restart drill on the 1x2x1 mesh
mesh = M.make_mesh((1, 2, 1), T.NAMES)
if rank < 2:
    step = train.make_train_step(cfg, T.RUN, device="cpu", mesh=mesh)
    _, sh = local(mesh, T.global_batch(cfg))

    def run(sup, n, start=0, state=None, inject=None):
        with data.ShardedPipeline(cfg, batch=T.BATCH, seq=T.SEQ,
                                  shardings=sh, device="cpu",
                                  start_step=start) as pipe:
            return sup.run(T.f32_state(cfg, mesh) if state is None else state,
                           step, iter(pipe), n_steps=n, start_step=start,
                           inject=inject)[0]

    plain = ft.Supervisor(ft.FTConfig(), group=mesh.group)
    whole, four = run(plain, 6), run(plain, 4)
    fcfg = ft.FTConfig(ckpt_dir=ckdir, ckpt_every=2, async_ckpt=False)
    try:
        run(ft.Supervisor(fcfg, group=mesh.group), 6, inject=ft.fail_at(5))
        res["drill/failed"] = np.array(False)
    except ft.InjectedFailure:
        res["drill/failed"] = np.array(True)
    sup = ft.Supervisor(fcfg, state_template=T.f32_state(cfg, mesh),
                        group=mesh.group)
    restored, start = sup.try_resume(T.f32_state(cfg, mesh), 0)
    res["drill/start"] = np.array(start)
    bits = lambda t: train._bits(P.flatten(sharding.local_tree(t))[0])  # noqa: E731
    res["drill/restored_eq"] = np.array(bits(restored).equal(bits(four)))
    final = run(sup, 6, start=start, state=restored)
    res["drill/final_eq"] = np.array(bits(final).equal(bits(whole)))

# too few ranks
try:
    M.make_mesh((2, 4, 1), T.NAMES)
    res["few_raised"] = np.array(False)
except RuntimeError:
    res["few_raised"] = np.array(True)
np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
print("ok")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ranks")
    init = f"file://{d / 'rendezvous'}"
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init, str(d / f"r{r}.npz"),
         here, str(d / "ckpt")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append(err[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), errs
    return [dict(np.load(d / f"r{r}.npz")) for r in range(4)]


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("p", (2, 4))
def test_uno_ring_over_ranks_bitwise_stacked_rows(ranks, p):
    cfg = f32_cfg()
    stacked = grad_tree(p)
    flat, _ = TU._flatten(stacked, p)
    rows = TU._pod_ring_psum(flat.clone(), RUN, p).numpy()
    for r in range(p):
        assert np.array_equal(ranks[r][f"ring{p}"], rows[r]), (p, r)
    assert not np.array_equal(rows[0], rows[1])    # each keeps its own row
    want = leaves_np(TU.make_uno_grad_sync(cfg, RUN, p, "cpu")(stacked))
    for i, w in enumerate(want):
        assert np.array_equal(ranks[0][f"sync{p}/{i}"], w), (p, i)


def test_1x2x1_baseline_matches_one_process(ranks):
    cfg = f32_cfg()
    step = TT.make_train_step(cfg, RUN, device="cpu")
    state = f32_state(cfg)
    loss, grads = step.grads(state["params"], global_batch(cfg))
    for r in (0, 1):
        res = ranks[r]
        np.testing.assert_allclose(res["base/loss"], loss.numpy(), rtol=1e-5)
        for i, g in enumerate(leaves_np(grads)):
            np.testing.assert_allclose(res[f"base/g{i}"], g, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(g).max()))
    for i in range(len(leaves_np(grads))):     # the mean is replicated
        assert np.array_equal(ranks[0][f"base/g{i}"], ranks[1][f"base/g{i}"])


def test_2x1x1_uno_rank0_bitwise_one_card(ranks):
    cfg = f32_cfg()
    step = TT.make_train_step(cfg, RUN, n_pods=2, device="cpu")
    state = f32_state(cfg)
    new, m = step(state, global_batch(cfg), 0)
    lvals, stacked = step.pod_grads(f32_state(cfg)["params"],
                                    global_batch(cfg))
    _, grads = step.sync_and_update(f32_state(cfg), stacked, 0)
    res = ranks[0]
    assert np.array_equal(res["uno/loss"], m["loss"].numpy())
    for i, g in enumerate(leaves_np(grads)):
        assert np.array_equal(res[f"uno/g{i}"], g), i
    for i, p in enumerate(leaves_np(new["params"])):
        assert np.array_equal(res[f"uno/p{i}"], p), i


def test_2x2x1_uno_mesh_grads_data_mean_then_ring(ranks):
    """Each pod's gradients over its data ranks (the two ranks' own
    gradients averaged, and the DTensor reduction each rank of the pod
    holds) within the 1x2x1 bar of that pod's row of the one-process
    `pod_grads`; every rank's `mesh_grads` bitwise its pod's row of the
    stacked ring fed those blocks; the loss the whole batch's."""
    cfg = f32_cfg()
    step = TT.make_train_step(cfg, RUN, n_pods=2, device="cpu")
    lvals, stacked = step.pod_grads(f32_state(cfg)["params"],
                                    global_batch(cfg))
    rows = TU._flatten(stacked, 2)[0].numpy()
    means = []
    for pod in (0, 1):
        a, b = (ranks[2 * pod + d]["pd/own"] for d in (0, 1))
        assert not np.array_equal(a, b)           # each rank its own rows
        mean = (a + b) / np.float32(2)
        np.testing.assert_allclose(mean, rows[pod], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(rows[pod]).max()))
        pre = ranks[2 * pod]["pd/pre"]
        assert np.array_equal(pre, ranks[2 * pod + 1]["pd/pre"])
        np.testing.assert_allclose(pre, rows[pod], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(rows[pod]).max()))
        means.append(pre)
    assert not np.array_equal(means[0], means[1])
    ring = TU._pod_ring_psum(torch.tensor(np.stack(means)), RUN, 2).numpy()
    assert not np.array_equal(ring[0], ring[1])   # each pod keeps its row
    for r in range(4):
        assert np.array_equal(ranks[r]["pd/grads"], ring[r // 2]), r
        np.testing.assert_allclose(ranks[r]["pd/loss"],
                                   lvals.mean().numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        np.mean([ranks[r]["pd/own_loss"] for r in range(4)]),
        lvals.mean().numpy(), rtol=1e-5)


def test_2x2x1_uno_cli_tracks_baseline(ranks):
    """The CLI drives the 2x2x1 Uno step end to end (group, mesh, data
    shard, the step) and every rank logs the same losses.  At the CLI's
    warm-up lr the weights barely move in 3 steps, so this holds the
    set-up, not the gradients: those are held by the test above."""
    base = train_cli.main(CLI)["losses"]
    for r in range(4):
        got = ranks[r]["cli/losses"]
        assert got.shape == (3,) and np.all(np.isfinite(got))
        assert float(np.max(np.abs(got - np.array(base)))) <= 1e-2, r
        assert np.array_equal(got, ranks[0]["cli/losses"])


def test_restart_drill_two_ranks(ranks):
    for r in (0, 1):
        res = ranks[r]
        assert bool(res["drill/failed"])
        assert int(res["drill/start"]) == 4
        assert bool(res["drill/restored_eq"]) and bool(res["drill/final_eq"])
    assert all(bool(res["few_raised"]) for res in ranks)


def test_shard_redistributes_a_dtensor(ranks):
    for r, res in enumerate(ranks):
        assert bool(res["dt/ok"]), r
        assert np.array_equal(res["dt/local"], res["dt/want"]), r
        assert res["dt/local"].shape == (2, 4)
        assert res["dt/local"][0, 0] == 8 * r      # rank r: rows 2r, 2r+1


def test_refusals():
    cfg = f32_cfg()
    with pytest.raises(ValueError, match="process groups"):
        TT.make_train_step(cfg, RUN, device="cpu",
                           mesh=TS.Mesh(NAMES, (2, 1, 1)))
    step = TT.make_train_step(cfg, RUN, device="cpu",
                              mesh=TS.Mesh(NAMES, (1, 1, 2), group=object()))
    assert step.pod_mesh.axis_names == ("data", "model")
    assert step.pod_mesh.shape == (1, 2)
    with pytest.raises(ValueError, match="start 4 ranks with torchrun"):
        train_cli.main(["--device", "cpu", "--reduced", "--mesh", "2x2x1"])
    with pytest.raises(ValueError, match="start 2 ranks with torchrun"):
        train_cli.main(["--device", "cpu", "--reduced", "--mesh", "1x1x2"])
