"""The epoch step's LB phase on the CPU: `cc.lb_update_plain` (the
per-path mark filter, the repath count, the multiplicative weights and
the simplex projection in one call) against the composition the step ran
before it.

  * `fleet_cuda.LbUpdate` given CPU tensors runs the plain version, and
    it is bitwise the filter followed by `update_split`, on 1 to 8 paths,
    with empty slots, repaths, zero-sum rows and per-flow knobs
    (`lb_cases`); the operands it is given are never written;
  * whole fleetsim runs with `lb` (a k=4 fat tree with a WAN link down,
    through `make_step`; a stacked grid of fat-tree what-ifs through
    `run_grid`; two stacked shards through `make_step_halves`), on a
    plain backend and on a kernel backend (whose wrappers run their plain
    versions here), give, bit for bit, what they give with the LB phase
    put back to that composition;
  * bad operands and a path count with no kernel instance raise, and
    operands on the card go to the kernel or raise.

This file imports no JAX.  The kernel itself is held against the plain
version on the card in test_torch_kernels_gpu.py."""
import functools
import hashlib

import pytest

torch = pytest.importorskip("torch")

import lb_cases as LC  # noqa: E402
import repro_torch.fleetsim as TF  # noqa: E402
import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import cc as TC  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402
from repro_torch.fleetsim import shard as TSH  # noqa: E402
from repro_torch.kernels import fleet_cuda  # noqa: E402

PATHS = (1, 2, 3, 4, 6, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def old_composition(lb, fb, mask, split, path_frac, sub_frac, bad_count):
    """The LB lines of the epoch step's receive half as they stood before
    `lb_update_plain`: the filter among the CC's, then `update_split`."""
    path_frac = path_frac + fb[:, None] * (sub_frac - path_frac)
    split, bad_count = TF.update_split(split, path_frac, bad_count, mask, lb)
    return path_frac, split, bad_count


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
        elif isinstance(v, (tuple, list)):
            for i, w in enumerate(v):
                walk(w, f"{name}[{i}]")
    walk(x, "")
    return h.hexdigest()


# ------------------------------------------------------------ one call

@pytest.mark.parametrize("n_paths", PATHS)
def test_lb_update_is_the_old_composition_bitwise(n_paths):
    """`LbUpdate` on CPU tensors and `lb_update_plain` are bitwise the
    old composition; the edge rows do what `lb_cases` says; nothing it
    is given is written and nothing is launched."""
    lb, fb, mask, *rows = LC.lb_inputs(1_000, n_paths, seed=n_paths)
    before = [t.clone() for t in (fb, mask, *rows, *lb)]
    want = old_composition(lb, fb, mask, *rows)
    launches = dict(fleet_cuda.LAUNCHES)
    for got in (fleet_cuda.LbUpdate(lb, fb, mask)(*rows),
                TC.lb_update_plain(lb, fb, mask, *rows),
                TC.make_lb_step(lb, fb, mask, plain=True)(*rows)):
        for g, w, what in zip(got, want, ("path_frac", "split",
                                          "bad_count")):
            assert g.dtype == w.dtype and torch.equal(g, w), what
    assert dict(fleet_cuda.LAUNCHES) == launches
    for a, b in zip((fb, mask, *rows, *lb), before):
        assert torch.equal(a, b), "an operand was written"
    path_frac, split, bad_count = want
    m = mask.float()
    assert torch.equal(split * (1 - m), torch.zeros_like(split))
    real = mask.any(dim=1)
    assert torch.allclose(split[real].sum(dim=1), torch.ones(()), atol=1e-5)
    assert bool((path_frac[1::16] == lb.repath_thresh[1::16, None]).all())
    fired = (rows[3] > 0) & (bad_count == 0) & mask
    assert bool(fired[2::16].any())
    uni = m / m.sum(dim=1, keepdim=True).clamp(min=1.0)
    for off in (3, 4):
        assert torch.equal(split[off::16], uni[off::16])


# ------------------------------------------------------------ whole runs

def _fat_tree_fault():
    spec = TS.fat_tree_spec(k=4, n_wan=4, n_flows=40, n_paths=4, seed=2)
    wan = [l.name for l in spec.links if l.wan]
    spec = spec._replace(faults=(TS.FaultSpec(wan[0], "down", t_start=2e5,
                                              t_end=9e5),))
    return TS.to_fleetsim(spec, device="cpu")


def _fat_tree_run(backend):
    fs = _fat_tree_fault()
    return TF.simulate(fs.net, fs.params, n_epochs=300, record=True,
                       is_inter=fs.is_inter, lb=fs.lb, fault=fs.fault,
                       seed=fs.seed, backend=backend)


def _grid_run(backend):
    fs = TS.to_fleetsim(TS.fat_tree_spec(k=4, n_wan=4, n_flows=40, n_paths=4,
                                         seed=3), device="cpu")
    cells = [fs, fs._replace(net=fs.net._replace(drain=fs.net.drain * 0.9)),
             fs._replace(net=fs.net._replace(cap=fs.net.cap * 0.5))]
    return TF.run_grid(cells, n_warm=200, n_meas=50, backend=backend)


def _sharded_run(backend):
    fs = TS.to_fleetsim(TS.fat_tree_spec(k=4, n_wan=4, n_flows=40, n_paths=4,
                                         seed=5), device="cpu")
    return TSH.steady_state_sharded(
        fs.net, fs.params, n_warm=200, n_meas=50, n_shards=2,
        is_inter=fs.is_inter, lb=fs.lb, link_tier=fs.link_tier,
        backend=backend)


RUNS = {"fat_tree_fault": _fat_tree_run, "grid": _grid_run,
        "sharded": _sharded_run}


@pytest.mark.parametrize("backend", ["auto", "cuda"])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_runs_with_lb_unchanged_bitwise(run, backend, monkeypatch):
    """Whole runs with the lb axis, on the CPU's plain backend (`auto`)
    and on the flat kernel backend (`cuda`, whose LB phase goes through
    `fleet_cuda.LbUpdate`), give the same states and rates, bit for bit,
    as the same runs with the LB phase put back to the old composition;
    repaths fire in them."""
    got = RUNS[run](backend)
    made = []

    def old_make_lb_step(lb, fb, mask, *, plain=False):
        made.append(plain)
        return functools.partial(old_composition, lb, fb, mask)
    monkeypatch.setattr(TC, "make_lb_step", old_make_lb_step)
    assert _digest(got) == _digest(RUNS[run](backend))
    assert made and all(p == (backend == "auto") for p in made)
    split = got[0].split                 # the floor keeps valid paths > 0
    valid = (split > 0).float()
    uniform = valid / valid.sum(dim=-1, keepdim=True).clamp(min=1.0)
    assert not torch.equal(split, uniform), "the split never moved"


# ------------------------------------------------------------ operands

def test_lb_update_rejects_bad_operands():
    lb, fb, mask, *rows = LC.lb_inputs(64, 4, seed=1)
    step = fleet_cuda.LbUpdate(lb, fb, mask)
    bad_rows = [
        (3, rows[3].float(), TypeError),               # bad_count dtype
        (0, rows[0].double(), TypeError),              # split dtype
        (1, rows[1][:, :3].contiguous(), ValueError),  # shape
        (2, rows[2].t().contiguous().t(), ValueError),  # not contiguous
        (0, rows[0][:32], ValueError),                 # rows
    ]
    for i, v, err in bad_rows:
        with pytest.raises(err):
            step(*rows[:i], v, *rows[i + 1:])
    with pytest.raises(TypeError):
        fleet_cuda.LbUpdate(lb._replace(repath_patience=lb.eta), fb, mask)
    with pytest.raises(ValueError, match="rows"):
        fleet_cuda.LbUpdate(lb._replace(eta=lb.eta[:63]), fb, mask)
    with pytest.raises(ValueError, match="rows"):
        fleet_cuda.LbUpdate(lb, fb[:63], mask)
    with pytest.raises(TypeError):
        fleet_cuda.LbUpdate(lb, fb, mask.int())
    lb9, fb9, mask9, *_ = LC.lb_inputs(64, fleet_cuda.LB_MAX_PATHS + 1)
    with pytest.raises(ValueError, match="paths"):
        fleet_cuda.LbUpdate(lb9, fb9, mask9)


def test_make_step_raises_once_for_a_path_count_with_no_instance():
    """A kernel backend refuses a net of more paths than the kernel is
    built for when the step is made, not at its first epoch; the plain
    backend runs it."""
    n_wan = fleet_cuda.LB_MAX_PATHS + 1
    fs = TS.to_fleetsim(TS.dumbbell_scenario(2, 4, multipath=True,
                                             n_wan=n_wan), device="cpu")
    assert fs.net.n_paths == n_wan and fs.lb is not None
    with pytest.raises(ValueError, match="paths"):
        TF.make_step(fs.net, fs.params, lb=fs.lb, backend="cuda")
    step = TF.make_step(fs.net, fs.params, lb=fs.lb, backend="reference")
    step(TF.init_state(fs.params, fs.net.n_links, n_paths=n_wan,
                       split0=TL.uniform_split(fs.net)))


def test_lb_update_raises_without_a_card_instead_of_falling_back(
        monkeypatch):
    """Operands on the card (here: taken for it) go to the kernel and
    raise where it cannot be built or run; nothing slides to the plain
    version.  Rows not aligned for the kernel's vector loads are refused
    first."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel runs")
    lb, fb, mask, *rows = LC.lb_inputs(64, 8, seed=2)
    monkeypatch.setattr(fleet_cuda, "_on_cuda", lambda *ts, **kw: True)
    launches = dict(fleet_cuda.LAUNCHES)
    step = fleet_cuda.LbUpdate(lb, fb, mask)
    shifted = torch.empty(rows[0].numel() + 1)[1:].view_as(rows[0])
    with pytest.raises(ValueError, match="aligned"):
        step(shifted.copy_(rows[0]), *rows[1:])
    with pytest.raises(RuntimeError, match="CUDA"):
        step(*rows)
    assert dict(fleet_cuda.LAUNCHES) == launches
