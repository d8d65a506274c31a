"""The port's GPipe pipeline (`repro_torch.sharding.pipeline`) against the
reference's (`repro.sharding.pipeline`), on the reference test's own
inputs (tests/test_pipeline.py: L 8, D 16, MB 4, M 8, S 4, a tanh(h @ w)
layer):

  * the stacked form and a 4-rank gloo run each within the reference
    test's bars of the reference's `pipeline_apply` on 4 forced host
    devices (forward 1e-5, gradients 1e-4), and bitwise equal to the
    layers run one microbatch after another and to each other (outputs,
    every stage's gradients, the microbatches' gradient on every rank);
  * `bubble_fraction`, `split_stack` and the shape checks;
  * `transformer.loss_fn` with its layer stack through `pipeline_layers`
    on a reduced 4-layer smollm (f32 and bf16): loss and every gradient bitwise the one-stage run, the loss
    within rtol 1e-4 of `loss_fn` on the whole batch; over the 4 gloo
    ranks bitwise the stacked run.

One subprocess runs the reference (~10 s); the gloo run is one spawned
group of 4 ranks (~10 s)."""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sharding.pipeline import PipelineConfig as RefPipelineConfig  # noqa: E402

from repro_torch import train as TT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.sharding.pipeline import (PipelineConfig,  # noqa: E402
                                           pipeline_apply, pipeline_layers,
                                           split_stack)

L, D, MB, M, S = 8, 16, 4, 8, 4
LM_LAYERS, LM_BATCH, LM_SEQ = 4, 8, 32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(L, D, D)).astype(np.float32) * 0.2
    x = rng.normal(size=(M, MB, D)).astype(np.float32)
    return W, x


def stage_fn(w_stage, h):
    """The reference test's stage: its layers' tanh(h @ w) in order."""
    for w in torch.unbind(w_stage, 0):
        h = torch.tanh(h @ w)
    return h


def sequential(W, x):
    outs = []
    for m in range(x.shape[0]):
        h = x[m]
        for w in torch.unbind(W, 0):
            h = torch.tanh(h @ w)
        outs.append(h)
    return torch.stack(outs)


def grads_of(fn, W0, x0):
    """(outputs, dW, dx) of sum(fn(W, x) ** 2), the reference test's loss."""
    W = torch.tensor(W0, requires_grad=True)
    x = torch.tensor(x0, requires_grad=True)
    y = fn(W, x)
    (y ** 2).sum().backward()
    return y.detach().numpy(), W.grad.numpy(), x.grad.numpy()


def _lm_cfg(f32: bool):
    cfg = TB.reduced(TR.get_config("smollm-135m"), n_layers=LM_LAYERS)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    return cfg


def lm_grads(cfg, n_stages, group=None, whole=False):
    """(loss, grads) of the reduced LM's pipeline loss (or `loss_fn` on the
    whole batch), params from seed 0."""
    params = TT.make_train_state(cfg, seed=0, device="cpu")["params"]
    leaves, treedef = TP.flatten(params)
    leaves = [l.to(cfg.pdtype()).detach().requires_grad_() for l in leaves]
    tree = TP.unflatten(treedef, leaves)
    batch = synth_batch(cfg, 0, LM_BATCH, LM_SEQ)
    if whole:
        loss = TF.loss_fn(tree, batch, cfg)
    else:
        loss = TF.loss_fn(tree, batch, cfg, layers_fn=pipeline_layers(
            PipelineConfig(n_stages, LM_BATCH),
            functools.partial(TF.run_layers, cfg=cfg), group))
    return loss.detach(), torch.autograd.grad(loss, leaves)


# ------------------------------------------------------------ reference

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.sharding import set_mesh
from repro.sharding.pipeline import PipelineConfig, pipeline_apply, split_stack
inp = np.load(sys.argv[1])
W, x = jnp.asarray(inp["W"]), jnp.asarray(inp["x"])
L, S, M = W.shape[0], 4, x.shape[0]
mesh = jax.make_mesh((4,), ("pipe",))

def stage_fn(w_stage, h):
    def body(h, w):
        return jnp.tanh(h @ w), None
    return jax.lax.scan(body, h, w_stage)[0]

cfg = PipelineConfig(n_stages=S, n_microbatches=M)
Wst = split_stack(W, S)

def loss_pipe(Wst, x):
    return jnp.sum(pipeline_apply(cfg, mesh, stage_fn, Wst, x) ** 2)

with set_mesh(mesh):
    y = jax.jit(lambda Wst, x: pipeline_apply(cfg, mesh, stage_fn, Wst,
                                              x))(Wst, x)
    g = jax.jit(jax.grad(loss_pipe))(Wst, x)
np.savez(sys.argv[2], y=np.asarray(y), g=np.asarray(g).reshape(W.shape))
print("ok")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe_ref")
    W, x = _inputs()
    np.savez(d / "in.npz", W=W, x=x)
    res = subprocess.run([sys.executable, "-c", _REF, str(d / "in.npz"),
                          str(d / "out.npz")], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


# ------------------------------------------------------------ gloo ranks

_RANK = r"""
import datetime, sys
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
torch.set_num_threads(1)
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
import test_torch_pipeline as T
from repro_torch.sharding.pipeline import PipelineConfig, pipeline_apply, split_stack
W0, x0 = T._inputs()
cfg = PipelineConfig(T.S, T.M)
g = dist.group.WORLD

def ranked(W, x):
    return pipeline_apply(cfg, T.stage_fn, split_stack(W, T.S)[rank:rank + 1],
                          x, group=g)

y, dW, dx = T.grads_of(ranked, W0, x0)
res = {"y": y, "dW": dW, "dx": dx}
for f32 in (True, False):
    loss, grads = T.lm_grads(T._lm_cfg(f32), 4, group=g)
    res[f"lm{int(f32)}/loss"] = loss.float().numpy()
    for i, t in enumerate(grads):
        res[f"lm{int(f32)}/{i}"] = t.float().numpy()
try:                         # 4 stages on a group of 4: 2 stages raise
    pipeline_apply(PipelineConfig(2, T.M), T.stage_fn,
                   split_stack(torch.tensor(W0), 2)[:1], torch.tensor(x0),
                   group=g)
    res["raised"] = np.array(False)
except ValueError:
    res["raised"] = np.array(True)
np.savez(out, **res)
dist.destroy_process_group()
print("ok")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe_ranks")
    init = f"file://{d / 'rendezvous'}"
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init, str(d / f"r{r}.npz"),
         here], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
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

def test_bubble_fraction():
    cfg = PipelineConfig(n_stages=4, n_microbatches=12)
    assert cfg.n_ticks == 15
    assert abs(cfg.bubble_fraction - 3 / 15) < 1e-9
    for s, m in ((2, 8), (5, 8), (4, 4), (1, 3)):
        a, b = PipelineConfig(s, m), RefPipelineConfig(s, m)
        assert (a.n_ticks, a.bubble_fraction) == (b.n_ticks,
                                                  b.bubble_fraction)


def test_stacked_matches_reference_and_sequential(ref):
    W, x = _inputs()
    cfg = PipelineConfig(S, M)
    y, dW, dx = grads_of(lambda W, x: pipeline_apply(
        cfg, stage_fn, split_stack(W, S), x), W, x)
    assert float(np.max(np.abs(y - ref["y"]))) < 1e-5
    assert float(np.max(np.abs(dW - ref["g"]))) < 1e-4
    ys, dWs, dxs = grads_of(sequential, W, x)
    assert np.array_equal(y, ys)
    assert np.array_equal(dW, dWs) and np.array_equal(dx, dxs)
    # one stage is the sequential run; every stage count gives its bits
    for s in (1, 2, 8):
        y2, dW2, _ = grads_of(lambda W, x: pipeline_apply(
            PipelineConfig(s, M), stage_fn, split_stack(W, s), x), W, x)
        assert np.array_equal(y2, ys) and np.array_equal(dW2, dWs), s


def test_ranks_match_reference_and_stacked(ref, ranks):
    W, x = _inputs()
    ys, dWs, dxs = grads_of(sequential, W, x)
    per = L // S
    for r, res in enumerate(ranks):
        assert np.array_equal(res["y"], ys), r     # every rank: all outputs
        assert float(np.max(np.abs(res["y"] - ref["y"]))) < 1e-5
        own = slice(r * per, (r + 1) * per)
        assert np.array_equal(res["dW"][own], dWs[own]), r
        assert float(np.max(np.abs(res["dW"][own] - ref["g"][own]))) < 1e-4
        others = np.ones(L, bool)
        others[own] = False
        assert not np.any(res["dW"][others])       # other stages' slices
        assert np.array_equal(res["dx"], dxs), r   # summed over the ranks
        assert bool(res["raised"])


@pytest.mark.parametrize("f32", (True, False))
def test_lm_pipeline_bitwise_sequential(f32):
    cfg = _lm_cfg(f32)
    l1, g1 = lm_grads(cfg, 1)
    for s in (2, 4):
        ls, gs = lm_grads(cfg, s)
        assert torch.equal(ls, l1), s
        assert all(torch.equal(a, b) for a, b in zip(gs, g1)), s
    lw, _ = lm_grads(cfg, 1, whole=True)
    assert abs(float(l1) - float(lw)) <= 1e-4 * abs(float(lw))


@pytest.mark.parametrize("f32", (True, False))
def test_lm_pipeline_over_ranks_bitwise_stacked(ranks, f32):
    cfg = _lm_cfg(f32)
    loss, grads = lm_grads(cfg, 4)
    leaves, treedef = TP.flatten(TF.param_defs(cfg))
    marks = TP.unflatten(treedef, list(range(len(leaves))))
    layer = set(TP.flatten(marks["layers"])[0])
    per = LM_LAYERS // 4
    for r, res in enumerate(ranks):
        assert np.array_equal(res[f"lm{int(f32)}/loss"],
                              loss.float().numpy()), r
        for i, g in enumerate(grads):
            got, g = res[f"lm{int(f32)}/{i}"], g.float().numpy()
            if i in layer:                       # each rank its stage
                own = slice(r * per, (r + 1) * per)
                assert np.array_equal(got[own], g[own]), (i, r)
            else:                                # embed / head / norm
                assert np.array_equal(got, g), (i, r)


def test_split_stack_and_shape_checks():
    W = torch.arange(24.0).reshape(6, 2, 2)
    st = split_stack({"w": W}, 3)["w"]
    assert st.shape == (3, 2, 2, 2) and torch.equal(st.reshape(6, 2, 2), W)
    with pytest.raises(ValueError, match="do not split"):
        split_stack({"w": W}, 4)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(PipelineConfig(3, 4), stage_fn, st, torch.ones(3, 2,
                                                                    2))
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_layers(PipelineConfig(1, 2), stage_fn)(W, torch.ones(3, 2))
