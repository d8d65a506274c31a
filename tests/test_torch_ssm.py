"""The port's SSM family (`repro_torch.models.mamba2`, `.ssm`) against the
jitted JAX reference on the same numpy-seeded parameters and inputs
(helpers in tests/family_parity.py), and reduced mamba2-130m through the
port's training and serving entry points.

Bars, those of the dense family: `_causal_conv`, `mamba_block` (S a
multiple of the chunk and S padded, with and without its state) and
`mamba_decode_step` in float32 within rtol 1e-5 normalized; the loss and
every gradient leaf within 1e-4, remat "none" and "full" (the two
bitwise equal); bf16 within the dense bf16 bars; prefill logits, the
conv / SSD states and 8 decode steps within 1e-5; `serve`'s greedy
completions token for token.  The train step at p = 2: the port's sync
of the mixed bf16 / float32 gradient bitwise the reference's
`make_uno_grad_sync` (one subprocess with two forced host devices) and
the plain backend; the Uno step within 1e-2 (loss) and 5e-4 (params
after step 1) of the baseline step; over 23 steps at lr 1e-3 the Uno
step's loss drift from the baseline's no larger than the reference's
composed Uno step's plus the two baselines' spread, and within 1e-2."""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import family_parity as FP  # noqa: E402
from repro import models as RM  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro.models import mamba2 as RMa  # noqa: E402

from repro_torch import models as TM  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch import train as TT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import uno_collectives as TU  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import mamba2 as TMa  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

ARCH = "mamba2-130m"
LAYER_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _layer(seed):
    """Reduced mamba2 (d 64, d_inner 128, 8 heads of 16, state 32, chunk
    16) in float32 and layer 0 of a seeded tree."""
    rcfg, tcfg = FP.cfgs(ARCH)
    lp = {k: v[0] for k, v in FP.params(rcfg, tcfg, seed)["layers"].items()}
    return rcfg, tcfg, lp


def _t(tree):
    return {k: FP.to_torch(v) for k, v in tree.items()}


def test_causal_conv_matches_reference():
    rcfg, tcfg, lp = _layer(60)
    _, _, _, _, conv_ch, _ = TMa.ssm_dims(tcfg)
    x = np.random.default_rng(61).normal(size=(2, 11, conv_ch)).astype(
        np.float32)
    want = jax.jit(RMa._causal_conv)(x, lp["conv_w"], lp["conv_b"])
    got = TMa._causal_conv(FP.to_torch(x), FP.to_torch(lp["conv_w"]),
                           FP.to_torch(lp["conv_b"]))
    FP.close(got, want, LAYER_RTOL, "causal conv")


@pytest.mark.parametrize("S,return_state", [
    (32, False), (32, True),     # two whole chunks of 16
    (20, True),                  # padded to 32: padded steps are identity
    (2, True),                   # one chunk of 2, conv tail left-padded
])
def test_mamba_block_matches_reference(S, return_state):
    rcfg, tcfg, lp = _layer(62)
    h = np.random.default_rng(63).normal(size=(2, S, tcfg.d_model)).astype(
        np.float32)
    want = jax.jit(lambda h, p: RMa.mamba_block(
        h, p, rcfg, return_state=return_state))(h, lp)
    with torch.inference_mode():
        got = TMa.mamba_block(FP.to_torch(h), _t(lp), tcfg,
                              return_state=return_state)
    if not return_state:
        FP.close(got, want, LAYER_RTOL, "mamba_block")
        return
    (out, (tail, state)), (w_out, (w_tail, w_state)) = got, want
    FP.close(out, w_out, LAYER_RTOL, "mamba_block")
    assert tuple(tail.shape) == (2, tcfg.ssm_conv_width - 1,
                                 TMa.ssm_dims(tcfg)[4])
    FP.close(tail, w_tail, LAYER_RTOL, "conv tail")
    FP.close(state, w_state, LAYER_RTOL, "ssd state")
    if S < tcfg.ssm_conv_width - 1:
        assert not tail[:, :tcfg.ssm_conv_width - 1 - S].any()


def test_mamba_block_grads_through_checkpointed_chunks():
    """The chunk bodies run checkpointed: the gradients of a block equal
    those of the same block with the checkpoints' recompute off."""
    _, tcfg, lp = _layer(64)
    h = FP.to_torch(np.random.default_rng(65).normal(
        size=(2, 32, tcfg.d_model)).astype(np.float32))

    def grads():
        hh = h.clone().requires_grad_()
        ps = {k: v.clone().requires_grad_() for k, v in _t(lp).items()}
        out = TMa.mamba_block(hh, ps, tcfg)
        return torch.autograd.grad(out.square().sum(), [hh, *ps.values()])

    a = grads()
    orig = TMa.checkpointed
    TMa.checkpointed = lambda fn: fn
    try:
        b = grads()
    finally:
        TMa.checkpointed = orig
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_mamba_decode_step_matches_reference():
    rcfg, tcfg, lp = _layer(66)
    d_in, H, N, P, conv_ch, _ = TMa.ssm_dims(tcfg)
    rng = np.random.default_rng(67)
    h = rng.normal(size=(3, 1, tcfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, tcfg.ssm_conv_width - 1, conv_ch)).astype(
        np.float32)
    ssm = rng.normal(size=(3, H, N, P)).astype(np.float32)
    want, (w_conv, w_ssm) = jax.jit(lambda h, c, s, p: RMa.mamba_decode_step(
        h, (c, s), p, rcfg))(h, conv, ssm, lp)
    got, (g_conv, g_ssm) = TMa.mamba_decode_step(
        FP.to_torch(h), (FP.to_torch(conv), FP.to_torch(ssm)), _t(lp), tcfg)
    FP.close(got, want, LAYER_RTOL, "decode out")
    FP.close(g_conv, w_conv, LAYER_RTOL, "decode conv")
    FP.close(g_ssm, w_ssm, LAYER_RTOL, "decode ssm")


# ---------------------------------------------------------- the whole model

@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_reference_f32(remat):
    FP.check_loss_and_grads(ARCH, remat, seed=68)


def test_loss_and_grads_match_reference_bf16():
    """The float32 leaves (dt_bias, A_log, D) keep float32 gradients."""
    FP.check_loss_and_grads_bf16(ARCH, seed=69)


def test_prefill_and_decode_match_reference_f32():
    cache = FP.check_serving(ARCH, seed=70)
    assert sorted(cache) == ["conv", "ssm"]
    assert cache["ssm"].dtype == torch.float32


def test_cache_is_constant_in_max_len():
    _, tcfg = FP.cfgs(ARCH, f32=False)
    a, b = TM.abstract_cache(tcfg, 2, 16), TM.abstract_cache(tcfg, 2, 524_288)
    assert {k: (tuple(v.shape), v.dtype) for k, v in a.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in b.items()}
    assert a["conv"].dtype == torch.bfloat16 and a["ssm"].dtype == \
        torch.float32


def test_serve_completions_match_reference(monkeypatch):
    """Reduced mamba2 in float32, 6 requests of 24 + 10 in waves of 4 (the
    second wave of 2 left-padded as the first): the reference's `serve`
    (its params from `models.init_params`, here the numpy-seeded tree)
    and the port's on the same params, token for token."""
    rcfg, tcfg = FP.cfgs(ARCH)
    params = FP.params(rcfg, tcfg, seed=71)
    monkeypatch.setattr(RM, "init_params", lambda key, cfg: jax.tree.map(
        jnp.asarray, params))
    rng = np.random.default_rng(72)
    prompts = [rng.integers(0, rcfg.vocab, 24 - (i % 3), dtype=np.int32)
               for i in range(6)]
    ref_reqs = [RS.Request(i, p, 10) for i, p in enumerate(prompts)]
    port_reqs = [TS.Request(i, p, 10) for i, p in enumerate(prompts)]
    want = RS.serve(rcfg, ref_reqs, batch=4, max_len=34)
    got = TS.serve(tcfg, port_reqs, batch=4, max_len=34,
                   params=TP.tree_from_arrays(params, "cpu"), device="cpu")
    assert got["tokens"] == want["tokens"] == 60
    assert [r.out for r in port_reqs] == [r.out for r in ref_reqs]


# ---------------------------------------------------------- training

_REF_SYNC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro import models
from repro.configs.base import RunConfig, reduced
from repro.configs.registry import get_config
from repro.core.uno_collectives import make_uno_grad_sync
from repro.sharding import set_mesh
cfg = reduced(get_config("mamba2-130m"))
run = RunConfig(uno_chunks=2)
rng = np.random.default_rng(5)
stacked = jax.tree.map(lambda l: jnp.asarray((rng.normal(
    size=(2,) + l.shape) * 1e-3).astype(np.float32)).astype(l.dtype),
    models.abstract_params(cfg))
mesh = jax.make_mesh((2,), ("pod",), devices=jax.devices()[:2])
with set_mesh(mesh):
    out = jax.jit(make_uno_grad_sync(mesh, cfg, run))(stacked)
res = {}
for i, (a, b) in enumerate(zip(jax.tree.leaves(stacked),
                               jax.tree.leaves(out))):
    pod0 = sorted(b.addressable_shards, key=lambda s: s.device.id)[0].data
    res[f"in_{i}"] = np.asarray(a).view(np.uint8)
    res[f"out_{i}"] = np.asarray(pod0).view(np.uint8)
    res[f"dtype_{i}"] = np.array(str(a.dtype))
np.savez(sys.argv[1], **res)
print("ok")
"""


@pytest.fixture(scope="module")
def ref_sync(tmp_path_factory):
    """The reference's `make_uno_grad_sync` on reduced mamba2's stacked
    gradients (bf16 leaves and the float32 dt_bias / A_log / D) at p = 2,
    RunConfig(uno_chunks=2), pod 0's output; one subprocess."""
    path = tmp_path_factory.mktemp("ssm_sync") / "ref.npz"
    out = subprocess.run([sys.executable, "-c", _REF_SYNC, str(path)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def _from_bytes(ref, key, i):
    dt = str(ref[f"dtype_{i}"])
    return ref[f"{key}_{i}"].view(ml_dtypes.bfloat16 if dt == "bfloat16"
                                  else np.dtype(dt))


def test_uno_sync_of_mixed_dtypes_matches_reference(ref_sync):
    """The f32 leaves ride in the same int8 wire frame as the bf16 ones:
    every synced leaf bitwise the reference's, in its own dtype, and the
    plain backend bitwise the same."""
    _, tcfg = _cfgs_bf16()
    run = TB.RunConfig(uno_chunks=2)
    like, treedef = TP.flatten(TP.param_defs(tcfg))
    stacked = TP.tree_from_arrays(TP.unflatten(
        treedef, [_from_bytes(ref_sync, "in", i) for i in range(len(like))]),
        "cpu")
    assert {str(d.dtype) for d in like} == {"torch.bfloat16", "torch.float32"}
    out = TU.make_uno_grad_sync(tcfg, run, 2, device="cpu")(stacked)
    plain = TU.make_uno_grad_sync(tcfg, run, 2, device="cpu",
                                  backend="plain")(stacked)
    for i, (leaf, pl, d) in enumerate(zip(TP.flatten(out)[0],
                                          TP.flatten(plain)[0], like)):
        assert leaf.dtype == d.dtype and torch.equal(leaf, pl), i
        got = TP.tree_to_arrays({"x": leaf})["x"]
        assert np.array_equal(got.view(np.uint8), ref_sync[f"out_{i}"]), i


def _cfgs_bf16():
    return FP.cfgs(ARCH, f32=False)


def test_uno_step_tracks_baseline():
    """Reduced mamba2 in its own dtypes, AdamW: the Uno step at p = 2
    against the baseline step from the same seeded state over 3 steps of
    8 x 32 tokens: the loss within 1e-2 on every step, the params within
    5e-4 after step 1; the Uno step's `sync_and_update` on the plain
    backend bitwise the default one."""
    _, tcfg = _cfgs_bf16()
    run = TB.RunConfig(uno_chunks=2, learning_rate=1e-3, warmup_steps=10)
    base = TT.make_train_step(tcfg, run, device="cpu")
    uno = TT.make_train_step(tcfg, run, n_pods=2, device="cpu")
    plain = TT.make_train_step(tcfg, run, n_pods=2, device="cpu",
                               backend="plain")
    sb = su = TT.make_train_state(tcfg, seed=0, device="cpu")
    for i in range(3):
        batch = synth_batch(tcfg, i, 8, 32)
        sb, mb = base(sb, batch, i)
        su, mu = uno(su, batch, i)
        assert np.isfinite(float(mu["loss"]))
        assert abs(float(mb["loss"]) - float(mu["loss"])) <= 1e-2
        if i == 1:
            delta = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(TP.flatten(sb["params"])[0],
                                        TP.flatten(su["params"])[0]))
            assert 0 < delta <= 5e-4, delta
    _, stacked = uno.pod_grads(su["params"], synth_batch(tcfg, 3, 8, 32))
    s_k, g_k = uno.sync_and_update(su, stacked, 3)
    s_p, g_p = plain.sync_and_update(su, stacked, 3)
    for a, b in zip(TP.flatten({"s": s_k, "g": g_k})[0],
                    TP.flatten({"s": s_p, "g": g_p})[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert g_k["layers"]["A_log"].dtype == torch.float32


_REF_DRIFT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro import data, models, optim, train
from repro.configs.base import RunConfig, reduced
from repro.configs.registry import get_config
from repro.core.uno_collectives import make_uno_grad_sync
from repro.sharding import set_mesh
P, STEPS, B, S = 2, int(sys.argv[2]), 8, int(sys.argv[3])
cfg = reduced(get_config("mamba2-130m"))
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
    res[f"init_{i}"] = np.asarray(a).view(np.uint8)
    res[f"dtype_{i}"] = np.array(str(a.dtype))
np.savez(sys.argv[1], **res)
print("ok")
"""
DRIFT_STEPS, DRIFT_SEQ = 23, 64


@pytest.fixture(scope="module")
def ref_drift(tmp_path_factory):
    """The reference's baseline step (jitted `make_train_step`) and its
    Uno step at p = 2 composed from its jitted pieces (per-pod
    `value_and_grad` of the mixed bf16 / float32 params, the
    `make_uno_grad_sync` of that gradient, `apply_updates`, the
    `lr_schedule`) on reduced mamba2, RunConfig(learning_rate=1e-3,
    warmup_steps=10), 23 steps of synth_batch(step, 8, 64) from the
    reference's seeded state; one subprocess with two forced host
    devices (the reference's own Uno train step raises on jax 0.9)."""
    path = tmp_path_factory.mktemp("ssm_drift") / "ref.npz"
    out = subprocess.run([sys.executable, "-c", _REF_DRIFT, str(path),
                          str(DRIFT_STEPS), str(DRIFT_SEQ)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def test_uno_drift_at_lr_1e3_p2_matches_reference(ref_drift):
    """The p = 2 Uno step's loss drift from the baseline's (the largest
    |Uno loss - baseline loss| over the 23 steps) on the port and on the
    reference, from the reference's seeded params over the same batches.
    The port may drift more than the reference by no more than the two
    baselines' largest difference (the spread of bf16 arithmetic between
    the packages), and stays within the 1e-2 bar."""
    _, tcfg = _cfgs_bf16()
    run = TB.RunConfig(learning_rate=1e-3, warmup_steps=10)
    base = TT.make_train_step(tcfg, run, device="cpu")
    uno = TT.make_train_step(tcfg, run, n_pods=2, device="cpu")
    like, treedef = TP.flatten(TP.param_defs(tcfg))
    params = TP.tree_from_arrays(TP.unflatten(
        treedef, [_from_bytes(ref_drift, "init", i)
                  for i in range(len(like))]), "cpu")
    sb = su = {"params": params, "opt": TO.init_opt_state(params, tcfg)}
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
    assert port_drift <= 1e-2, (port_drift, ref_drift_v, spread)


def test_train_and_serve_clis_on_cpu():
    out = train_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                          "--steps", "2", "--batch", "4", "--seq", "32",
                          "--uno", "--pods", "2"])
    assert out["last_step"] == 2 and out["n_pods"] == 2
    assert all(np.isfinite(out["losses"]))
    stats = TS.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                     "--requests", "3", "--prompt-len", "12", "--gen", "4",
                     "--batch", "2"])
    assert stats["tokens"] == 12


def test_grads_stay_finite_at_the_full_chunk():
    """mamba2-130m's chunk of 256 with its initial decays (A_log and
    dt_bias zero, dt ~ 0.7): above the chunk's diagonal cum_q - cum_k
    reaches ~180 and exp overflows.  The reference masks after the exp
    and its gradients are NaN (a reference caveat); the port masks the
    exponent, and its gradients are finite and within 1e-4 of the
    reference's at a chunk of 16 (the same function, chunked finer, where
    the reference's are finite)."""
    import dataclasses
    rcfg, tcfg = FP.cfgs(ARCH, ssm_chunk=256)
    params = FP.params(rcfg, tcfg, seed=73)
    params["layers"]["A_log"][:] = 0.0
    params["layers"]["dt_bias"][:] = 0.0
    batch = FP.batch(rcfg, seed=74, s=256)
    _, ref_grads = FP.ref_value_and_grad(params, batch, rcfg)
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref_grads)
    loss, grads = FP.port_value_and_grad(params, batch, tcfg)
    want, wgrads = FP.ref_value_and_grad(
        params, batch, dataclasses.replace(rcfg, ssm_chunk=16))
    FP.close(loss, want, 1e-4, "loss")
    for i, (g, w) in enumerate(zip(grads, wgrads)):
        assert bool(torch.isfinite(g).all()), i
        FP.close(g, w, 1e-4, f"grad leaf {i}")
