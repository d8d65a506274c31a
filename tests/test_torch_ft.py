"""The port's host side of training — the stateful `UnoCC`, the chunk
window scheduler, the data pipeline, checkpoints and the fault-tolerance
supervisor — against the JAX reference (`tests/test_ft.py`,
`tests/test_collectives.py` and `tests/test_unocc.py` are the reference's
own counterparts).

Every comparison here is exact: UnoCC and the scheduler are plain Python
floats in the reference's order (every state field and every decision
equal), `synth_batch` is bitwise, and a checkpoint written by either
package restores bitwise into the other, bf16 leaves included."""
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import ckpt as RC  # noqa: E402
from repro import data as RD  # noqa: E402
from repro import train as RT  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.configs import registry as RR  # noqa: E402
from repro.core import unocc as RU  # noqa: E402
from repro.core import window_scheduler as RW  # noqa: E402

from repro_torch import ckpt as TC  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch import ft as TF  # noqa: E402
from repro_torch import train as TT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.core import unocc as TU  # noqa: E402
from repro_torch.core import window_scheduler as TW  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

RCFG = RB.reduced(RR.get_config("smollm-135m"))
TCFG = TB.reduced(TR.get_config("smollm-135m"))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    return np.asarray(a).reshape(-1).view(np.uint8)


# ----------------------------------------------------------- UnoCC

def _state(cc):
    return {k: v for k, v in vars(cc).items() if k != "p"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unocc_replay_matches_reference(seed):
    """A numpy-seeded event trace — ACKs with ECN marks and jittered RTTs,
    loss signals and QA ticks, a blackout (no ACKs for 20 ticks) — drives
    the reference's and the port's UnoCC; every field equal after every
    event."""
    rng = np.random.default_rng(seed)
    kw = dict(bdp=float(rng.uniform(1e5, 1e7)), intra_bdp=1.25e5,
              intra_rtt=10_000.0, cwnd0=float(rng.choice([0.0, 5e4])))
    ref, port = RU.UnoCC(RU.UnoParams(**kw)), TU.UnoCC(TU.UnoParams(**kw))
    now, n_events = 0.0, 0
    for tick in range(300):
        blackout = 100 <= tick < 120
        for _ in range(0 if blackout else int(rng.integers(1, 12))):
            now += float(rng.exponential(800.0))
            rtt = float(kw["intra_rtt"] * rng.uniform(1.0, 3.0))
            ev = dict(bytes_acked=float(rng.choice([4096.0, 1500.0])),
                      ecn=bool(rng.random() < 0.3), rtt=rtt,
                      send_time=now - rtt, now=now)
            ref.on_ack(**ev)
            port.on_ack(**ev)
            n_events += 1
            assert _state(ref) == _state(port), (tick, ev)
        if rng.random() < 0.05:
            ref.on_loss_signal(now)
            port.on_loss_signal(now)
        now += kw["intra_rtt"]
        inflight = float(rng.uniform(0, 2) * port.cwnd)
        assert ref.on_qa_tick(now, inflight) == port.on_qa_tick(now, inflight)
        assert _state(ref) == _state(port), tick
    assert n_events > 1000 and port.n_epochs > 0 and port.n_md > 0


# ------------------------------------------------------ window scheduler

def _trace(rng, n_steps=60):
    """Per-step chunk latency lists: jittered around 3 ms, a few dropped
    chunks, inflation spells, and the DCI flap at step 12 (3/4 of the
    chunks never complete) — the reference example's event."""
    steps = []
    for i in range(n_steps):
        n = int(rng.integers(4, 17))
        lat = list(3e-3 * rng.uniform(0.9, 1.1, n))
        if i == 12:
            lat = lat[:n // 4] + [None] * (n - n // 4)
        elif rng.random() < 0.1:
            lat[int(rng.integers(0, n))] = None
        if 30 <= i < 36:
            lat = [None if x is None else x * 2.5 for x in lat]
        steps.append(lat)
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_window_scheduler_decisions_match_reference(seed):
    chunk = float(np.random.default_rng(seed + 100).choice([1e6, 1 << 18]))
    ref = RW.ChunkWindowScheduler(RW.SchedulerConfig(chunk_bytes=chunk))
    port = TW.ChunkWindowScheduler(TW.SchedulerConfig(chunk_bytes=chunk))
    for lat in _trace(np.random.default_rng(seed)):
        assert ref.on_step(list(lat)) == port.on_step(list(lat))
        assert ref.n_chunks == port.n_chunks
    assert ref.window_log == port.window_log
    assert (ref.n_reroutes, ref.cc.n_qa) == (port.n_reroutes, port.cc.n_qa)
    assert port.window_log[12]["reroute"]


def test_window_scheduler_qa_and_recovery():
    """Counterparts of the reference's straggler / recovery tests."""
    sched = TW.ChunkWindowScheduler(TW.SchedulerConfig(chunk_bytes=1e6))
    for _ in range(10):
        sched.on_step([2.1e-3] * 8)
    healthy = sched.n_chunks
    for _ in range(4):
        dec = sched.on_step([2.1e-3] * 2 + [None] * 6)
    assert sched.cc.n_qa >= 1 and sched.n_chunks < healthy and dec["reroute"]
    low = sched.n_chunks
    for _ in range(200):
        sched.on_step([2.1e-3] * max(sched.n_chunks, 1))
    assert sched.n_chunks >= low


# --------------------------------------------------------------- data

@pytest.mark.parametrize("arch,compute", [
    ("smollm-135m", "bfloat16"), ("musicgen-large", "bfloat16"),
    ("musicgen-large", "float32")])
def test_synth_batch_bitwise(arch, compute):
    import dataclasses
    rcfg = dataclasses.replace(RB.reduced(RR.get_config(arch)),
                               compute_dtype=compute)
    tcfg = dataclasses.replace(TB.reduced(TR.get_config(arch)),
                               compute_dtype=compute)
    for step, seed in ((0, 0), (5, 1), (123, 7)):
        want = RD.synth_batch(rcfg, step, 4, 32, seed=seed)
        got = TD.synth_batch(tcfg, step, 4, 32, seed=seed)
        for k in ("inputs", "targets"):
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[1] == want[k].dtype.name
            assert np.array_equal(_bits(got[k]), _bits(want[k])), (k, step)


def test_pipeline_order_and_restart():
    p1 = TD.ShardedPipeline(TCFG, batch=2, seq=16, device="cpu")
    steps = [next(p1)[0] for _ in range(4)]
    p1.close()
    assert steps == [0, 1, 2, 3]
    with TD.ShardedPipeline(TCFG, batch=2, seq=16, start_step=2,
                            device="cpu") as p2:
        s, b = next(p2)
    assert s == 2
    assert np.array_equal(b["inputs"].numpy(),
                          RD.synth_batch(RCFG, 2, 2, 16)["inputs"])


def test_pipeline_close_all_backstop():
    p = TD.ShardedPipeline(TCFG, batch=2, seq=16, device="cpu")
    assert p._thread.is_alive()
    TD._close_all_pipelines()
    p._thread.join(timeout=5)
    assert not p._thread.is_alive()
    p.close()                     # explicit close after the hook is a no-op


def test_leaked_pipeline_exits_cleanly():
    """Pipelines never closed: the atexit backstop stops their threads and
    the interpreter exits 0."""
    code = """
from repro_torch import data
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
cfg = reduced(get_config("smollm-135m"))
pipes = [data.ShardedPipeline(cfg, batch=2, seq=16, device="cpu")
         for _ in range(3)]
for p in pipes:
    next(p)
print("ran")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    assert "terminate called" not in out.stderr and "ran" in out.stdout


# -------------------------------------------------------------- checkpoints

def _ref_state():
    return RT.make_train_state(RCFG, jax.random.PRNGKey(0))


def _port_state(seed=0):
    return TT.make_train_state(TCFG, seed=seed, device="cpu")


def _assert_same(port_state, ref_state):
    pl, _ = TP.flatten(port_state)
    rl = jax.tree.leaves(ref_state)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        assert tuple(a.shape) == np.shape(b)
        assert np.array_equal(_bits(a), _bits(np.asarray(b)))


def test_reference_checkpoint_restores_bitwise(tmp_path):
    ref = _ref_state()
    RC.save(tmp_path, 4, ref)
    got = TC.restore(tmp_path, 4, _port_state())
    assert got["params"]["lm_head"].dtype == torch.bfloat16
    assert got["opt"]["step"].device.type == "cpu"
    _assert_same(got, ref)


def test_port_checkpoint_restores_bitwise_in_reference(tmp_path):
    state = _port_state(seed=3)
    state["opt"]["step"] = state["opt"]["step"] + 7
    TC.save(tmp_path, 9, state)
    meta = json.loads((tmp_path / "step_9" / "meta.json").read_text())
    assert meta["leaves"]["params/lm_head"]["dtype"] == "bfloat16"
    restored = RC.restore(tmp_path, 9, _ref_state())
    _assert_same(state, restored)
    assert int(restored["opt"]["step"]) == 7
    assert restored["params"]["lm_head"].dtype == ml_dtypes.bfloat16


def test_ckpt_roundtrip_gc_tmp_and_async(tmp_path):
    state = _port_state()
    for s in (1, 2, 3, 4, 5):
        TC.save(tmp_path / "gc", s, state, keep=2)
    assert sorted(int(p.name.split("_")[1])
                  for p in (tmp_path / "gc").glob("step_*")) == [4, 5]
    (tmp_path / "gc" / "step_9.tmp").mkdir()
    assert TC.latest_step(tmp_path / "gc") == 5
    assert TC.latest_step(tmp_path / "none") is None
    t = TC.save(tmp_path / "async", 11, state, background=True)
    t.join(timeout=30)
    assert not t.is_alive()
    assert TC.latest_step(tmp_path / "async") == 11
    back = TC.restore(tmp_path / "async", 11, state)
    for a, b in zip(TP.flatten(back)[0], TP.flatten(state)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -------------------------------------------------------------- supervisor

def _step():
    return TT.make_train_step(TCFG, TB.RunConfig(), device="cpu")


def test_restart_drill(tmp_path):
    """Kill training mid-run; a fresh supervisor resumes from the latest
    checkpoint (bitwise the state saved there) and finishes with the same
    losses as an uninterrupted run."""
    step = _step()
    ftc = lambda: TF.FTConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                              async_ckpt=False)
    saved = {}

    def keep(state, batch, i):
        state, m = step(state, batch, i)
        if i == 5:
            saved["state"] = TP.flatten(state)[0]
        return state, m

    losses = {}
    on = lambda tag: (lambda i, m, w: losses.setdefault(tag, {}).update(
        {i: float(m["loss"])}))
    with TD.ShardedPipeline(TCFG, batch=2, seq=16, device="cpu") as pipe:
        sup = TF.Supervisor(ftc(), state_template=_port_state())
        with pytest.raises(TF.InjectedFailure):
            sup.run(_port_state(), keep, iter(pipe), n_steps=10,
                    inject=TF.fail_at(7), on_metrics=on("a"))
    assert TC.latest_step(tmp_path) == 5          # ckpts at steps 2 and 5
    restored = TC.restore(tmp_path, 5, _port_state())
    for a, b in zip(TP.flatten(restored)[0], saved["state"]):
        assert torch.equal(a, b)
    with TD.ShardedPipeline(TCFG, batch=2, seq=16, start_step=6,
                            device="cpu") as pipe:
        sup2 = TF.Supervisor(ftc(), state_template=_port_state())
        _, last = sup2.run(_port_state(), step, iter(pipe), n_steps=10,
                           on_metrics=on("b"))
    assert last == 10
    assert any(e["kind"] == "resume" and e["step"] == 5 for e in sup2.events)
    with TD.ShardedPipeline(TCFG, batch=2, seq=16, device="cpu") as pipe:
        TF.Supervisor(TF.FTConfig()).run(_port_state(), step, iter(pipe),
                                         n_steps=10, on_metrics=on("c"))
    for i in range(6, 10):
        assert losses["b"][i] == losses["c"][i], i


def test_straggler_qa_event():
    sup = TF.Supervisor(TF.FTConfig())
    with TD.ShardedPipeline(TCFG, batch=2, seq=16, device="cpu") as pipe:
        _, last = sup.run(_port_state(), _step(), iter(pipe), n_steps=8,
                          inject=TF.slow_at(5, 0.6))
    assert last == 8
    assert any(e["kind"] == "straggler_qa" for e in sup.events)


def test_nan_quarantine_resumes_from_checkpoint(tmp_path):
    """A step whose loss is NaN is dropped; the supervisor restarts from
    the last checkpoint and counts the restart."""
    step = _step()
    poisoned = {"done": False}

    def flaky(state, batch, i):
        state, m = step(state, batch, i)
        if i == 4 and not poisoned["done"]:
            poisoned["done"] = True
            m = {**m, "loss": torch.tensor(float("nan"))}
        return state, m

    sup = TF.Supervisor(TF.FTConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                                    async_ckpt=False),
                        state_template=_port_state())
    with TD.ShardedPipeline(TCFG, batch=2, seq=16, device="cpu") as pipe:
        _, last = sup.run(_port_state(), flaky, iter(pipe), n_steps=6)
    assert last == 6 and sup.restarts == 1
    kinds = [(e["kind"], e["step"]) for e in sup.events]
    assert ("nan", 4) in kinds and ("resume", 3) in kinds
