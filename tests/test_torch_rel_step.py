"""The reliability phase of the epoch step on the CPU: `reliability.rel_step`
(the recovery split, the NACK machine, the EC ladder and the goodput
split in one call) against the composition the step ran before it.

  * `rel_step`'s plain version is bitwise `rel_epoch` + `effective_eff` +
    the goodput line, with no ladder, a shared ladder and per-cell ladder
    tables, on one path and on four; `fleet_cuda.rel_epoch` given CPU
    tensors runs that plain version;
  * whole fleetsim runs with reliability (a multipath dumbbell with churn,
    the EC ladder and faults; a fault grid with per-cell ladders; a
    recovery grid with static EC) give, bit for bit, what they give with
    the step's reliability phase put back to that composition;
  * the state it is given is never written.

This file imports no JAX.  The kernel itself is held against the plain
version on the card in test_torch_kernels_gpu.py."""
import functools
import hashlib

import pytest

torch = pytest.importorskip("torch")

import rel_cases as RC  # noqa: E402
import repro_torch.fleetsim as TF  # noqa: E402
import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import reliability as TR  # noqa: E402
from repro_torch.fleetsim import sweeps as TSW  # noqa: E402
from repro_torch.kernels import fleet_cuda  # noqa: E402

US, MS = 1e3, 1e6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _digest(x) -> str:
    """sha256 over every tensor of a (nested) result, in field order."""
    h = hashlib.sha256()

    def walk(v, name):
        if isinstance(v, torch.Tensor):
            h.update(f"{name}:{v.dtype}:{tuple(v.shape)}".encode())
            h.update(v.contiguous().numpy().tobytes())
        elif hasattr(v, "_fields"):
            for f in v._fields:
                walk(getattr(v, f), f"{name}.{f}")
        elif isinstance(v, dict):
            for k in sorted(v):
                walk(v[k], f"{name}.{k}")
        elif isinstance(v, (tuple, list)):
            for i, w in enumerate(v):
                walk(w, f"{name}[{i}]")
    walk(x, "")
    return h.hexdigest()


# ------------------------------------------------------------ whole runs

def _multipath_ladder_churn_faults():
    spec = TS.dumbbell_scenario(
        4, 6, n_bottleneck=2, multipath=True, n_wan=4, wan_p_loss=1e-3,
        seed=1, intra_churn=TS.ChurnSpec(50 * 14 * US, 50 * 14 * US),
        inter_churn=TS.ChurnSpec(1 * MS, 1 * MS),
        inter_rel=TS.RelSpec(**RC.LADDER),
        faults=(TS.FaultSpec("wan0", "down", t_start=1 * MS, t_end=3 * MS),
                TS.FaultSpec("wan1", "burst", loss_rate=2e-2, burst=0.3)))
    fs = TS.to_fleetsim(spec, device="cpu")
    return TF.simulate(fs.net, fs.params, n_epochs=400, record=True,
                       is_inter=fs.is_inter, lb=fs.lb, churn=fs.churn,
                       rel=fs.rel, fault=fs.fault, seed=fs.seed)


def _fault_grid_ladders():
    out = TSW.fault_sweep([1e6, 3e6], ["down", "burst"],
                          [((8, 2),), ((8, 1), (8, 2), (8, 4))], n_inter=32,
                          n_warm=300, n_meas=100, device="cpu")
    return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}


def _recovery_grid_static():
    out = TSW.recovery_sweep([1.0, 2.0], [(4, 1), (8, 2)], [0.0, 1.0],
                             n_inter=32, n_warm=300, n_meas=100, device="cpu")
    return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}


GOLDEN_RUNS = {"multipath_ladder_churn_faults": _multipath_ladder_churn_faults,
               "fault_grid_ladders": _fault_grid_ladders,
               "recovery_grid_static": _recovery_grid_static}


@pytest.mark.parametrize("run", sorted(GOLDEN_RUNS))
def test_runs_with_reliability_unchanged_bitwise(run, monkeypatch):
    """Whole runs through `make_step` with reliability (churn and faults
    too, where the run has them) give the same state and outputs, bit for
    bit, as the same runs with the step's reliability phase put back to
    the composition it ran before `rel_step` (`rel_cases.old_composition`)."""
    got = _digest(GOLDEN_RUNS[run]())
    made = []

    def old_make_rel_step(rel, *, plain=False):
        made.append(rel)
        return functools.partial(RC.old_composition, rel)
    monkeypatch.setattr(TR, "make_rel_step", old_make_rel_step)
    assert got == _digest(GOLDEN_RUNS[run]()) and made


def _clone(st):
    return type(st)(*(t.clone() for t in st))


def _same(a, b, what):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{what}.{f}"


@pytest.mark.parametrize("n_paths", [1, 4])
@pytest.mark.parametrize("form", RC.FORMS)
def test_rel_step_is_the_old_composition_bitwise(form, n_paths):
    """`rel_step` (plain, and through the kernel's wrapper on CPU tensors)
    is bitwise the composition the step ran before; the state it is given
    is left as it was."""
    args = RC.rel_inputs(form, n_paths, n=480, cells=4, seed=7)
    st0 = _clone(args[1])
    want = RC.old_composition(*args)
    launches = dict(fleet_cuda.LAUNCHES)
    for got in (TR.rel_step(*args, plain=True), TR.rel_step(*args),
                fleet_cuda.rel_epoch(*args)):
        _same(got[0], want[0], form)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    _same(args[1], st0, "input state")
    assert dict(fleet_cuda.LAUNCHES) == launches
    new, cut, _ = want
    assert bool(cut.any()) and bool((new.nacks != st0.nacks).any())
    if form != "static":
        assert bool((new.rung != st0.rung).any())


def test_rel_step_on_the_shared_zero_state_leaves_it_zero():
    """`init_rel_state` hands one zero tensor to a dozen fields: a step
    from it writes none of them."""
    rel, _, rate, rtx, split, sub_loss, sc, dt, rtt = RC.rel_inputs(
        "shared", 1, n=64, seed=3)
    st = TR.init_rel_state(rel)
    new, _, _ = TR.rel_step(rel, st, rate, rtx, split, sub_loss, sc, dt, rtt)
    assert st.pending is st.lost_bytes and float(st.pending.abs().sum()) == 0
    assert float(new.lost_bytes.sum()) > 0.0


def test_rel_epoch_rejects_bad_operands():
    args = list(RC.rel_inputs("per_cell", 1, n=64, cells=4, seed=1))
    rel, st = args[0], args[1]
    bad = [
        (1, st._replace(ack_cd=st.ack_cd.float()), TypeError),
        (2, args[2][::2], ValueError),
        (5, args[5][:, :1].expand(-1, 2), ValueError),
        (0, rel._replace(coef=rel.coef[:, :9].contiguous()), ValueError),
        (0, rel._replace(ladder_up=rel.ladder_up[:, :2].contiguous()),
         ValueError),
        (0, rel._replace(adapt_on=None), ValueError),
    ]
    for i, v, err in bad:
        with pytest.raises(err):
            fleet_cuda.rel_epoch(*args[:i], v, *args[i + 1:])
    cut = {f: v[:63] for f, v in rel._asdict().items()
           if v is not None and f not in TR.LADDER_SHARED}
    with pytest.raises(ValueError, match="cells"):
        fleet_cuda.rel_epoch(rel._replace(**cut),
                             type(st)(*(t[:63] for t in st)),
                             *(x[:63] if x.dim() else x for x in args[2:]))


def test_rel_epoch_raises_without_a_card_instead_of_falling_back(
        monkeypatch):
    """Operands on the card (here: taken for it) go to the kernel and
    raise where it cannot be built or run; nothing slides to the plain
    version; the default device of the reliability knobs is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel runs")
    args = RC.rel_inputs("static", 1, n=64, seed=2)
    monkeypatch.setattr(fleet_cuda, "_on_cuda", lambda *ts, **kw: True)
    launches = dict(fleet_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.rel_step(*args)
    assert dict(fleet_cuda.LAUNCHES) == launches
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.make_rel_params(4)
