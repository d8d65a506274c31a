"""The plain reference against the program at a tiny size on the CPU: the
same compiled scenario and fresh state, and the same epochs within the
comparison's tolerances, not one element off (the CPU runs the program's
plain kernels); the bfloat16 control fails the cell's limit.  On the card (`gpu`), the control at a small size."""
from __future__ import annotations

import pytest
import torch

from bench.harness import checks as C
from bench.harness import config, program, traffic
from bench.reference import compile as RC
from bench.tests.conftest import TINY, tiny


def _setup(cell, seed, device):
    c = tiny(cell)
    gen = traffic.generate(c.config, c.traffic, seed)
    return c, gen, program.build(gen, device), RC.compile_generated(gen,
                                                                    device)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_compile_and_fresh_state_equal(cell):
    _, _, prog, ref = _setup(cell, 2 ** 31 + 5, torch.device("cpu"))
    assert C.compile_mismatches(prog, ref) == {}
    assert C.exact_mismatches(program.as_dict(prog.state0),
                              RC.init_state(ref)) == {}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_epochs_equal_and_control_fails(cell):
    c, gen, prog, ref = _setup(cell, 11, torch.device("cpu"))
    limit = c.knobs["limits"]["step_off_share"]
    state, rstate = prog.state0, RC.init_state(ref)
    for _ in range(40):
        new, gp = prog.step(state)
        want, want_gp = C.reference_step(ref, program.as_dict(state),
                                         gen.scheme)
        assert max(C.step_shares(program.as_dict(new), gp, want,
                                 want_gp).values()) == 0.0
        rstate, _ = C.reference_step(ref, rstate, gen.scheme)
        state = new
    # the reference stepped on its own from its own fresh state agrees too
    z = torch.zeros(1)
    assert max(C.step_shares(program.as_dict(state), z, rstate,
                             z).values()) == 0.0
    cb, cg = C.reference_step(ref, program.as_dict(state), gen.scheme,
                              dtype=torch.bfloat16)
    want, want_gp = C.reference_step(ref, program.as_dict(state), gen.scheme)
    assert max(C.step_shares(cb, cg, want, want_gp).values()) > 10 * limit


def test_off_share_tolerances():
    w = torch.tensor([1000.0, 1.0, 0.0, float("inf")])
    assert C.off_share(w.clone(), w) == 0.0
    assert C.off_share(w + torch.tensor([0.05, 0.0, 0.0, 0.0]), w) == 0.0
    assert C.off_share(w + torch.tensor([0.2, 0.0, 0.0, 0.0]), w) == 0.25
    assert C.off_share(torch.tensor([1, 2]), torch.tensor([1, 3])) == 0.5
    assert C.off_share(torch.zeros(3), torch.zeros(4)) == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_on_the_card(cell, cuda_device):
    """At a small size on the card: the program's kernels within the
    limit of the reference, the bfloat16 control outside it."""
    c, gen, prog, ref = _setup(cell, 5, cuda_device)
    limit = c.knobs["limits"]["step_off_share"]
    assert C.compile_mismatches(prog, ref) == {}
    state = prog.state0
    for _ in range(30):
        new, gp = prog.step(state)
        want, want_gp = C.reference_step(ref, program.as_dict(state),
                                         gen.scheme)
        assert max(C.step_shares(program.as_dict(new), gp, want,
                                 want_gp).values()) <= limit
        state = new
    want, want_gp = C.reference_step(ref, program.as_dict(state), gen.scheme)
    cb, cg = C.reference_step(ref, program.as_dict(state), gen.scheme,
                              dtype=torch.bfloat16)
    assert max(C.step_shares(cb, cg, want, want_gp).values()) > limit
