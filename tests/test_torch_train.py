"""The port's training path (`repro_torch.optim`, `repro_torch.train`, the
CLIs `launch.train` and `launch.cross_pod`) against the JAX reference.

Bars: AdamW bitwise the jitted reference over 3 updates, bf16 params
(the port follows XLA's rewrites, see `repro_torch.optim`); SGD-M and
Adafactor within 1e-6 (normalized) over 3 updates in float32; Muon's
Newton–Schulz runs its products in bf16, so its params hold 1e-3
normalized (measured 9.6e-5) and its momentum 1e-6; `lr_schedule`
bitwise the jitted reference.  The baseline step holds the jitted
`make_train_step` over 3 steps in float32 (loss rtol 1e-5, params atol
2 x lr x steps: AdamW's first steps move an element by ~lr whatever its
gradient's size, so a gradient near zero can flip sign between two
correct computations).  The Uno step: the reference's per-pod gradients,
its `make_uno_grad_sync` on a ("pod",) mesh and its jitted
`apply_updates` run in one subprocess with four forced host devices
(the device count must be fixed before jax initializes; the reference's
own Uno train step cannot run on jax 0.9, see ROADMAP), and the port's
`sync_and_update` on the same stacked gradients matches it bitwise,
params and optimizer state, at p = 2 and 4 over two steps.  The port's
own Uno step stays within the reference's bars of its baseline step
(`tests/test_collectives.py:52-53`: params 5e-4, loss 1e-2)."""
import dataclasses
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import models as RM  # noqa: E402
from repro import optim as RO  # noqa: E402
from repro import train as RT  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.configs import registry as RR  # noqa: E402

from repro_torch import optim as TO  # noqa: E402
from repro_torch import train as TT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.launch import cross_pod as cross_pod_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch="smollm-135m", **kw):
    return (dataclasses.replace(RB.reduced(RR.get_config(arch)), **kw),
            dataclasses.replace(TB.reduced(TR.get_config(arch)), **kw))


def _tree(cfg, rng, scale, dtype):
    return jax.tree.map(lambda l: np.asarray(jnp.asarray(
        (rng.normal(size=l.shape) * scale).astype(np.float32)).astype(dtype)),
        RM.abstract_params(cfg))


def _bits(a):
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else np.asarray(a)
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    return a.view(np.uint8)


def _rel(port, want):
    got = port.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


# --------------------------------------------------------------- optimizers

def test_adamw_bitwise_jitted_reference():
    rcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    params = _tree(rcfg, rng, 0.05, jnp.bfloat16)
    state = RO.init_opt_state(params, rcfg)
    tp = TP.tree_from_arrays(params, "cpu")
    ts = TO.init_opt_state(tp, tcfg)
    upd = jax.jit(lambda p, g, s, lr: RO.apply_updates(p, g, s, rcfg, lr))
    for i in range(3):
        g = _tree(rcfg, rng, 1e-3, jnp.bfloat16)
        lr = TO.lr_schedule(i + 1, 1e-3, 2)
        params, state = upd(params, g, state, jnp.float32(lr))
        tp, ts = TO.apply_updates(tp, TP.tree_from_arrays(g, "cpu"), ts,
                                  tcfg, lr)
        for a, b in zip(TP.flatten({"p": tp, "m": ts["m"], "v": ts["v"]})[0],
                        jax.tree.leaves({"p": params, "m": state["m"],
                                         "v": state["v"]})):
            assert np.array_equal(_bits(a), _bits(b))
        assert int(ts["step"]) == int(state["step"]) == i + 1


@pytest.mark.parametrize("opt,p_rtol,s_rtol", [
    ("sgdm", 1e-6, 1e-6), ("adafactor", 1e-6, 1e-6), ("muon", 1e-3, 1e-6)])
def test_other_optimizers_match_jitted_reference(opt, p_rtol, s_rtol):
    rcfg, tcfg = _cfgs(optimizer=opt)
    rng = np.random.default_rng(1)
    params = _tree(rcfg, rng, 0.05, np.float32)
    state = RO.init_opt_state(params, rcfg)
    tp = TP.tree_from_arrays(params, "cpu")
    ts = TO.init_opt_state(tp, tcfg)
    upd = jax.jit(lambda p, g, s, lr: RO.apply_updates(p, g, s, rcfg, lr))
    for i in range(3):
        g = _tree(rcfg, rng, 1e-3, np.float32)
        lr = TO.lr_schedule(i + 1, 1e-3, 2)
        params, state = upd(params, g, state, jnp.float32(lr))
        tp, ts = TO.apply_updates(tp, TP.tree_from_arrays(g, "cpu"), ts,
                                  tcfg, lr)
        for a, b in zip(TP.flatten(tp)[0], jax.tree.leaves(params)):
            assert _rel(a, b) <= p_rtol, opt
        strip = lambda s: {k: v for k, v in s.items() if k != "step"}
        for a, b in zip(TP.flatten(strip(ts))[0],
                        jax.tree.leaves(strip(state))):
            assert _rel(a, b) <= s_rtol, opt


@pytest.mark.parametrize("opt", ["adamw", "sgdm", "muon", "adafactor"])
def test_donated_update_is_the_same_update(opt):
    """`apply_updates(donate=True)` writes bitwise the values of the
    functional update into the given params and state, and returns those
    same tensors; a donated train step matches an undonated one."""
    _, tcfg = _cfgs(optimizer=opt)
    rng = np.random.default_rng(5)
    rcfg = RB.reduced(RR.get_config("smollm-135m"))
    tp = TP.tree_from_arrays(_tree(rcfg, rng, 0.05, jnp.bfloat16), "cpu")
    ts = TO.init_opt_state(tp, tcfg)
    for i in range(2):
        g = TP.tree_from_arrays(_tree(rcfg, rng, 1e-3, jnp.bfloat16), "cpu")
        want_p, want_s = TO.apply_updates(tp, g, ts, tcfg, 1e-3)
        keep = TP.flatten({"p": tp, "s": ts})[0]
        got_p, got_s = TO.apply_updates(tp, g, ts, tcfg, 1e-3, donate=True)
        got = TP.flatten({"p": got_p, "s": got_s})[0]
        want = TP.flatten({"p": want_p, "s": want_s})[0]
        for a, b, k in zip(got, want, keep):
            assert a.dtype == b.dtype and torch.equal(a, b)
            assert a is k or a.ndim == 0         # the step counter is new
        tp, ts = got_p, got_s
    step = TT.make_train_step(tcfg, TB.RunConfig(), device="cpu")
    donated = TT.make_train_step(tcfg, TB.RunConfig(), device="cpu",
                                 donate=True)
    s0 = TT.make_train_state(tcfg, seed=0, device="cpu")
    s1 = TT.make_train_state(tcfg, seed=0, device="cpu")
    batch = synth_batch(tcfg, 0, 4, 32)
    a, _ = step(s0, batch, 1)
    b, _ = donated(s1, batch, 1)
    assert b["params"]["lm_head"] is s1["params"]["lm_head"]
    for x, y in zip(TP.flatten(a)[0], TP.flatten(b)[0]):
        assert torch.equal(x, y)


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest the rational x, ties to even."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        key = (d, int(np.array(c).view(np.uint32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return best[1]


def test_fma32_rounds_once():
    """`fma32` (addcmul) and `fma32_exact` equal the exact rational
    a * b + c rounded once, on random triples and on triples whose float64
    sum lands on a float32 midpoint (where a second rounding breaks the
    tie the wrong way: the plain float64 route fails those)."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=400).astype(np.float32)
    b = rng.normal(size=400).astype(np.float32)
    c = rng.normal(size=400).astype(np.float32)
    # a * b = +-2^-24 (1 - 2^-46): the float64 sum with c = 1 + 2^-23
    # rounds onto the float32 midpoint 1 + 3 * 2^-24 (or 1 + 2^-24),
    # while the exact sum lies 2^-70 below (above) it; scaled by 2^k
    k = np.array([0, 0, 5, -7, 20, -20], np.float64)
    sign = np.array([1, -1, 1, -1, 1, -1], np.float64)
    a = np.concatenate([a, (sign * 2.0 ** -24 * (1 + 2.0 ** -23) * 2.0 ** k)
                        .astype(np.float32)])
    b = np.concatenate([b, np.full(6, 1 - 2.0 ** -23, np.float32)])
    c = np.concatenate([c, ((1 + 2.0 ** -23) * 2.0 ** k).astype(np.float32)])
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) +
                                Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    assert np.array_equal(TO.fma32_exact(ta, tb, tc).numpy(), want)
    assert np.array_equal(TO.fma32(ta, tb, tc).numpy(), want)
    twice = (ta.double() * tb.double() + tc.double()).float().numpy()
    assert not np.array_equal(twice, want)


@pytest.mark.parametrize("base,warmup,total", [
    (3e-4, 100, 100_000), (1e-3, 10, 300), (3e-4, 0, 50), (5e-4, 3, 1000),
    (1e-2, 1000, 5000)])
def test_lr_schedule_bitwise_jitted_reference(base, warmup, total):
    steps = np.arange(0, 6000, 7, dtype=np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: RO.lr_schedule(s, base, warmup, total)))(steps))
    got = np.array([TO.lr_schedule(int(s), base, warmup, total)
                    for s in steps], np.float32)
    assert np.array_equal(got, want)


# ------------------------------------------------------------ train steps

def _f32_params(rcfg, seed):
    """float32 params: norms near 1, weights at 1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(l):
        if len(l.shape) == 1 or l.shape == (rcfg.n_layers, rcfg.d_model):
            return (1 + rng.normal(size=l.shape) * 0.1).astype(np.float32)
        return (rng.normal(size=l.shape) * l.shape[-2] ** -0.5).astype(
            np.float32)

    return jax.tree.map(leaf, RM.abstract_params(rcfg))


def test_baseline_step_matches_jitted_reference():
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    rcfg, tcfg = _cfgs("granite-8b", **f32)
    run_kw = dict(learning_rate=1e-3, warmup_steps=2)
    rrun, trun = RB.RunConfig(**run_kw), TB.RunConfig(**run_kw)
    params = _f32_params(rcfg, 3)
    rstate = {"params": params, "opt": RO.init_opt_state(params, rcfg)}
    tparams = TP.tree_from_arrays(params, "cpu")
    tstate = {"params": tparams, "opt": TO.init_opt_state(tparams, tcfg)}
    rstep = jax.jit(RT.make_train_step(rcfg, rrun))
    tstep = TT.make_train_step(tcfg, trun, device="cpu")
    for i in range(3):
        batch = synth_batch(tcfg, i, 4, 32)
        rstate, rm = rstep(rstate, {k: v.numpy() for k, v in batch.items()},
                           jnp.int32(i))
        tstate, tm = tstep(tstate, batch, i)
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= \
            1e-5 * abs(float(rm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
            1e-4 * float(rm["grad_norm"])
    atol = 2 * 1e-3 * 3
    for a, b in zip(TP.flatten(tstate["params"])[0],
                    jax.tree.leaves(rstate["params"])):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= atol
    assert int(tstate["opt"]["step"]) == 3


_REF_UNO = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro import data, models, optim, train
from repro.configs.base import RunConfig, reduced
from repro.configs.registry import get_config
from repro.core.uno_collectives import make_uno_grad_sync
from repro.sharding import set_mesh
cfg = reduced(get_config("smollm-135m"))
run = RunConfig(uno_chunks=2, learning_rate=1e-3, warmup_steps=2)
state0 = train.make_train_state(cfg, jax.random.PRNGKey(0))
loss = lambda p, b: models.loss_fn(p, b, cfg)
res = {}
leaves = lambda t: jax.tree.leaves(t)
def pod0(a):
    # every pod ends with its own copy of the synced gradients (each
    # received the others' quantized chunks); the step goes on with pod
    # 0's, as one program per pod would on its pod
    return np.asarray(sorted(a.addressable_shards,
                             key=lambda s: s.device.id)[0].data)
def put(key, tree):
    for i, a in enumerate(leaves(tree)):
        a = np.asarray(a)
        res[f"{key}_{i}"] = a.view(np.uint16) if a.dtype.name == "bfloat16" \
            else a
for i, a in enumerate(leaves(state0["params"])):
    res[f"init_{i}"] = np.asarray(a).view(np.uint16)
for p in (2, 4):
    mesh = jax.make_mesh((p,), ("pod",), devices=jax.devices()[:p])
    sync = jax.jit(make_uno_grad_sync(mesh, cfg, run))
    upd = jax.jit(lambda prm, g, s, lr: optim.apply_updates(prm, g, s, cfg,
                                                            lr))
    lr_fn = jax.jit(lambda s: optim.lr_schedule(s, run.learning_rate,
                                                run.warmup_steps))
    grads_fn = jax.jit(jax.vmap(jax.value_and_grad(loss), in_axes=(None, 0)))
    state = state0
    for step in (1, 2):
        b = data.synth_batch(cfg, step, 8, 32)
        bb = jax.tree.map(lambda x: x.reshape((p, 8 // p) + x.shape[1:]), b)
        lvals, stacked = grads_fn(state["params"], bb)
        with set_mesh(mesh):
            grads = jax.tree.map(pod0, sync(stacked))
        prm, opt = upd(state["params"], grads, state["opt"],
                       lr_fn(jnp.float32(step)))
        state = jax.tree.map(np.asarray, {"params": prm, "opt": opt})
        put(f"p{p}_s{step}_stacked", stacked)
        put(f"p{p}_s{step}_params", prm)
        put(f"p{p}_s{step}_m", opt["m"])
        put(f"p{p}_s{step}_v", opt["v"])
        res[f"p{p}_s{step}_lvals"] = np.asarray(lvals)
np.savez(sys.argv[1], **res)
print("ok")
"""


@pytest.fixture(scope="module")
def ref_uno(tmp_path_factory):
    """The reference's Uno pieces composed as its train step composes them
    (per-pod `vmap(value_and_grad)`, `make_uno_grad_sync` (leaf_local) on
    a ("pod",) mesh, `lr_schedule`, `apply_updates`, each jitted) on
    reduced smollm-135m, RunConfig(uno_chunks=2, lr 1e-3, warmup 2), two
    steps (step_idx 1 and 2) at p = 2 and 4; one subprocess."""
    path = tmp_path_factory.mktemp("uno_train") / "ref.npz"
    out = subprocess.run([sys.executable, "-c", _REF_UNO, str(path)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def _load(ref, key, like):
    leaves, treedef = TP.flatten(like)
    out = []
    for i, l in enumerate(leaves):
        a = ref[f"{key}_{i}"]
        if l.dtype == torch.bfloat16:
            a = a.view(ml_dtypes.bfloat16)
        out.append(a.reshape(tuple(a.shape)))
    return TP.tree_from_arrays(TP.unflatten(treedef, out), "cpu")


def _init_state(ref, tcfg):
    like = TP.init_params(TP.param_defs(tcfg), torch.Generator())
    params = _load(ref, "init", like)
    return {"params": params, "opt": TO.init_opt_state(params, tcfg)}


@pytest.mark.parametrize("p", [2, 4])
def test_uno_sync_and_update_bitwise_reference(ref_uno, p):
    """The reference's stacked per-pod gradients through the port's
    `sync_and_update`: params, m and v bitwise the reference's after each
    of two steps; the port's own per-pod losses (bf16) within 5e-3 of
    the reference's, as in `test_torch_models`."""
    _, tcfg = _cfgs()
    run = TB.RunConfig(uno_chunks=2, learning_rate=1e-3, warmup_steps=2)
    step = TT.make_train_step(tcfg, run, n_pods=p, device="cpu")
    state = _init_state(ref_uno, tcfg)
    for s in (1, 2):
        lvals, own = step.pod_grads(state["params"],
                                    synth_batch(tcfg, s, 8, 32))
        np.testing.assert_allclose(lvals.numpy(), ref_uno[f"p{p}_s{s}_lvals"],
                                   rtol=0, atol=5e-3)
        stacked = _load(ref_uno, f"p{p}_s{s}_stacked", own)
        state, _ = step.sync_and_update(state, stacked, s)
        for key, tree in (("params", state["params"]),
                          ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
            for i, leaf in enumerate(TP.flatten(tree)[0]):
                want = ref_uno[f"p{p}_s{s}_{key}_{i}"]
                assert np.array_equal(_bits(leaf), want.view(np.uint8)), \
                    (p, s, key, i)


def test_uno_step_tracks_baseline(ref_uno):
    """The port's own Uno step (p = 2, its own per-pod gradients) against
    its baseline step from the same state, 3 steps: loss within 1e-2 on
    every step, params within 5e-4 after step 1."""
    _, tcfg = _cfgs()
    run = TB.RunConfig(uno_chunks=2, learning_rate=1e-3, warmup_steps=10)
    base = TT.make_train_step(tcfg, run, device="cpu")
    uno = TT.make_train_step(tcfg, run, n_pods=2, device="cpu")
    sb = su = _init_state(ref_uno, tcfg)
    for i in range(3):
        batch = synth_batch(tcfg, i, 8, 32)
        sb, mb = base(sb, batch, i)
        su, mu = uno(su, batch, i)
        assert abs(float(mb["loss"]) - float(mu["loss"])) <= 1e-2
        if i == 1:
            delta = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(TP.flatten(sb["params"])[0],
                                        TP.flatten(su["params"])[0]))
            assert 0 < delta <= 5e-4, delta


_REF_DRIFT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro import data, models, optim, train
from repro.configs.base import RunConfig, reduced
from repro.configs.registry import get_config
from repro.core.uno_collectives import make_uno_grad_sync
from repro.sharding import set_mesh
P, STEPS, B, S = 4, int(sys.argv[2]), 8, int(sys.argv[3])
cfg = reduced(get_config("smollm-135m"))
run = RunConfig(learning_rate=1e-3, warmup_steps=10)
state0 = train.make_train_state(cfg, jax.random.PRNGKey(0))
loss = lambda p, b: models.loss_fn(p, b, cfg)
batches = [data.synth_batch(cfg, i, B, S) for i in range(STEPS)]
base = jax.jit(train.make_train_step(cfg, run))
state, base_losses = state0, []
for i, b in enumerate(batches):
    state, m = base(state, b, jnp.int32(i))
    base_losses.append(float(m["loss"]))
def pod0(a):
    return np.asarray(sorted(a.addressable_shards,
                             key=lambda s: s.device.id)[0].data)
mesh = jax.make_mesh((P,), ("pod",), devices=jax.devices()[:P])
sync = jax.jit(make_uno_grad_sync(mesh, cfg, run))
upd = jax.jit(lambda prm, g, s, lr: optim.apply_updates(prm, g, s, cfg, lr))
lr_fn = jax.jit(lambda s: optim.lr_schedule(s, run.learning_rate,
                                            run.warmup_steps))
grads_fn = jax.jit(jax.vmap(jax.value_and_grad(loss), in_axes=(None, 0)))
state, uno_losses = state0, []
for i, b in enumerate(batches):
    bb = jax.tree.map(lambda x: x.reshape((P, B // P) + x.shape[1:]), b)
    lvals, stacked = grads_fn(state["params"], bb)
    with set_mesh(mesh):
        grads = jax.tree.map(pod0, sync(stacked))
    prm, opt = upd(state["params"], grads, state["opt"],
                   lr_fn(jnp.float32(i)))
    state = {"params": prm, "opt": opt}
    uno_losses.append(float(lvals.mean()))
res = {"base": np.array(base_losses), "uno": np.array(uno_losses)}
for i, a in enumerate(jax.tree.leaves(state0["params"])):
    res[f"init_{i}"] = np.asarray(a).view(np.uint16)
np.savez(sys.argv[1], **res)
print("ok")
"""
DRIFT_STEPS, DRIFT_SEQ = 23, 64


@pytest.fixture(scope="module")
def ref_drift(tmp_path_factory):
    """The reference's baseline step (jitted `make_train_step`) and its
    composed Uno step (as `ref_uno` composes it) at p = 4 on reduced
    smollm-135m, RunConfig(learning_rate=1e-3, warmup_steps=10), 23
    steps of synth_batch(step, 8, 64) from the reference's seeded state;
    one subprocess."""
    path = tmp_path_factory.mktemp("uno_drift") / "ref.npz"
    out = subprocess.run([sys.executable, "-c", _REF_DRIFT, str(path),
                          str(DRIFT_STEPS), str(DRIFT_SEQ)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def test_uno_drift_at_lr_1e3_p4_matches_reference(ref_drift):
    """The p = 4 Uno step's loss drift from the baseline's at lr 1e-3
    (warmup 10, 23 steps, bf16) on the port and on the reference, from
    the same seeded params over the same batches.  The drift is the
    largest |Uno loss - baseline loss| over the steps.  The port may
    drift more than the reference by no more than the two baselines'
    largest difference (the spread of bf16 arithmetic between the
    packages); the reference's own drift is what the int8 + RS sync does
    to AdamW at this rate."""
    _, tcfg = _cfgs()
    run = TB.RunConfig(learning_rate=1e-3, warmup_steps=10)
    base = TT.make_train_step(tcfg, run, device="cpu")
    uno = TT.make_train_step(tcfg, run, n_pods=4, device="cpu")
    sb = su = _init_state(ref_drift, tcfg)
    port_base, port_uno = [], []
    for i in range(DRIFT_STEPS):
        batch = synth_batch(tcfg, i, 8, DRIFT_SEQ)
        sb, mb = base(sb, batch, i)
        su, mu = uno(su, batch, i)
        port_base.append(float(mb["loss"]))
        port_uno.append(float(mu["loss"]))
    port_drift = float(np.max(np.abs(np.subtract(port_uno, port_base))))
    ref_drift_v = float(np.max(np.abs(ref_drift["uno"] - ref_drift["base"])))
    spread = float(np.max(np.abs(np.subtract(port_base, ref_drift["base"]))))
    assert np.all(np.isfinite(port_uno + port_base))
    assert port_drift - ref_drift_v <= spread, \
        (port_drift, ref_drift_v, spread)


# ------------------------------------------------------------------ the CLIs

def test_train_cli_baseline_and_uno_on_cpu():
    base = train_cli.main(["--device", "cpu", "--reduced", "--steps", "3",
                           "--batch", "4", "--seq", "32"])
    uno = train_cli.main(["--device", "cpu", "--reduced", "--steps", "3",
                          "--batch", "4", "--seq", "32", "--uno", "--pods",
                          "2"])
    assert base["last_step"] == uno["last_step"] == 3
    assert base["n_pods"] == 1 and uno["n_pods"] == 2
    assert all(np.isfinite(base["losses"] + uno["losses"]))
    assert abs(base["losses"][0] - uno["losses"][0]) <= 1e-5
    mesh = train_cli.main(["--device", "cpu", "--reduced", "--steps", "1",
                           "--batch", "4", "--seq", "32", "--uno", "--mesh",
                           "2x1x1"])
    assert mesh["n_pods"] == 2
    with pytest.raises(ValueError, match="start 4 ranks with torchrun"):
        train_cli.main(["--device", "cpu", "--reduced", "--mesh", "2x2x1"])
    with pytest.raises(ValueError, match="start 2 ranks with torchrun"):
        train_cli.main(["--device", "cpu", "--reduced", "--mesh", "2"])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.make_train_state(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.make_train_step(tcfg, TB.RunConfig(), n_pods=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cross_pod_cli.main(["--steps", "1"])


def test_cross_pod_drill_on_cpu():
    """The reference example's drill: Uno within 1e-2 of the baseline's
    loss until the restore at step 20, the step-12 flap collapses the
    window (QA) and re-routes, and the window recovers afterwards."""
    out = cross_pod_cli.main(["--device", "cpu", "--steps", "22"])
    assert max(out["drifts"][:20]) <= 1e-2
    log = out["log"]
    assert log[12]["reroute"] and out["n_reroutes"] >= 1
    assert out["n_qa"] >= 1
    assert log[-1]["n_chunks"] >= 1
