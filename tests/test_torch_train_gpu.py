"""The training path's pieces that the CPU tests hold against the
reference, run on the card at small sizes and held at the CPU tests'
bars against the port on the CPU (or against themselves):

  * the CLIs `launch.train` (reduced, 3 steps, baseline and Uno) and
    `launch.cross_pod` (its drill: Uno within 1e-2 of the baseline's
    loss until the restore, the step-12 flap re-routes), each as a
    subprocess;
  * the remat policies "full" and "dots": loss and gradients bitwise
    those of "none";
  * SGD-M, Muon and Adafactor: one step on the card against the same
    step on the CPU (params and state within 1e-6 normalized; Muon's
    params within 1e-3, its bf16 Newton-Schulz);
  * the `embeddings` input mode: loss and gradients within 1e-4
    normalized of the CPU's in float32 (TF32 off);
  * a checkpoint in the reference's on-disk format, bf16 leaves
    included, written from the CPU and restored onto the card bitwise.

This file imports no JAX, so that it runs on the machine with the card:

    python3 -m pytest -q -m gpu tests/test_torch_train_gpu.py

Every test is marked `gpu` and skips without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ckpt, models, optim, train  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.models import params as P  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _run_cli(module: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _rel(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _value_and_grad(params, batch, cfg):
    leaves, treedef = P.flatten(params)
    leaves = [l.detach().clone().requires_grad_() for l in leaves]
    loss = models.loss_fn(P.unflatten(treedef, leaves), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _f32_params(cfg, seed, device):
    gen = torch.Generator().manual_seed(seed)
    params = models.init_params(cfg, gen)
    leaves, treedef = P.flatten(params)
    return P.unflatten(treedef, [l.float().to(device) for l in leaves])


@pytest.mark.gpu
def test_train_cli_on_card(dev):
    """`python -m repro_torch.launch.train --reduced --steps 3`, baseline
    and Uno at 2 pods: 3 steps, finite losses."""
    for extra in ((), ("--uno", "--pods", "2")):
        out = _run_cli("repro_torch.launch.train", "--reduced", "--steps",
                       "3", "--batch", "4", "--seq", "32", *extra)
        m = re.search(r"done: (\d+) steps .* on cuda.*loss (\S+) -> "
                      r"(\S+);", out)
        assert m, out[-2000:]
        assert int(m.group(1)) == 3
        assert np.isfinite(float(m.group(2))) and \
            np.isfinite(float(m.group(3)))


@pytest.mark.gpu
def test_cross_pod_cli_on_card(dev):
    """`python -m repro_torch.launch.cross_pod`: the drill's printed
    drifts within 1e-2 before the restore at step 20, a QA event and a
    re-route."""
    out = _run_cli("repro_torch.launch.cross_pod")
    assert "cross-pod example OK" in out and "on cuda" in out
    drifts = [(int(s), float(d)) for s, d in re.findall(
        r"step +(\d+) loss=\S+ drift_vs_baseline=(\S+)", out)]
    assert drifts and max(d for s, d in drifts if s < 20) <= 1e-2
    m = re.search(r"scheduler: (\d+) QA events, (\d+) re-routes", out)
    assert m and int(m.group(1)) >= 1 and int(m.group(2)) >= 1
    assert "restored from step-15 checkpoint" in out


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_same_grads_on_card(dev, policy):
    cfg = dataclasses.replace(reduced(get_config("granite-8b")), **F32)
    params = _f32_params(cfg, 14, dev)
    batch = {k: v.to(dev) for k, v in synth_batch(cfg, 0, 2, 32).items()}
    base = _value_and_grad(params, batch,
                           dataclasses.replace(cfg, remat_policy="none"))
    got = _value_and_grad(params, batch,
                          dataclasses.replace(cfg, remat_policy=policy))
    assert torch.equal(base[0], got[0])
    for a, b in zip(base[1], got[1]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("opt,p_rtol,s_rtol", [
    ("sgdm", 1e-6, 1e-6), ("adafactor", 1e-6, 1e-6), ("muon", 1e-3, 1e-6)])
def test_other_optimizers_on_card_match_cpu(dev, opt, p_rtol, s_rtol):
    cfg = dataclasses.replace(reduced(get_config("smollm-135m")),
                              optimizer=opt)
    gen = torch.Generator().manual_seed(1)
    like = P.flatten(models.init_params(cfg, gen))
    params = P.unflatten(like[1], [torch.randn(l.shape, generator=gen) * 0.05
                                   for l in like[0]])
    grads = P.unflatten(like[1], [torch.randn(l.shape, generator=gen) * 1e-3
                                  for l in like[0]])
    to = lambda t: P.unflatten(P.flatten(t)[1], [  # noqa: E731
        l.to(dev) for l in P.flatten(t)[0]])
    lr = optim.lr_schedule(1, 1e-3, 2)
    cpu_p, cpu_s = optim.apply_updates(params, grads,
                                       optim.init_opt_state(params, cfg),
                                       cfg, lr)
    gp = to(params)
    card_p, card_s = optim.apply_updates(gp, to(grads),
                                         optim.init_opt_state(gp, cfg),
                                         cfg, lr)
    for a, b in zip(P.flatten(card_p)[0], P.flatten(cpu_p)[0]):
        assert a.device.type == "cuda" and _rel(a, b) <= p_rtol, opt
    strip = lambda s: {k: v for k, v in s.items() if k != "step"}  # noqa
    for a, b in zip(P.flatten(strip(card_s))[0], P.flatten(strip(cpu_s))[0]):
        assert _rel(a, b) <= s_rtol, opt


@pytest.mark.gpu
def test_embeddings_input_mode_on_card_matches_cpu(dev):
    """Reduced musicgen (frame embeddings as inputs), float32: the loss
    and every gradient leaf within 1e-4 normalized of the CPU's."""
    cfg = dataclasses.replace(reduced(get_config("musicgen-large")), **F32)
    params = _f32_params(cfg, 15, "cpu")
    batch = synth_batch(cfg, 0, 2, 32)
    assert batch["inputs"].dim() == 3
    want = _value_and_grad(params, batch, cfg)
    got = _value_and_grad(
        P.unflatten(P.flatten(params)[1],
                    [l.to(dev) for l in P.flatten(params)[0]]),
        {k: v.to(dev) for k, v in batch.items()}, cfg)
    assert _rel(got[0], want[0]) <= 1e-4
    for a, b in zip(got[1], want[1]):
        assert _rel(a, b) <= 1e-4


@pytest.mark.gpu
def test_reference_format_checkpoint_restores_on_card_bitwise(dev, tmp_path):
    """A train state written from the CPU in the reference's on-disk
    format (bf16 params, f32 moments, the host step counter) restores
    onto a card template bit for bit; the step counter stays on the
    host."""
    cfg = reduced(get_config("smollm-135m"))
    state = train.make_train_state(cfg, seed=3, device="cpu")
    state["opt"]["step"] = state["opt"]["step"] + 7
    ckpt.save(tmp_path, 9, state)
    template = train.make_train_state(cfg, seed=0, device=dev)
    got = ckpt.restore(tmp_path, 9, template)
    assert got["params"]["lm_head"].dtype == torch.bfloat16
    assert got["params"]["lm_head"].device.type == "cuda"
    assert got["opt"]["step"].device.type == "cpu"
    for a, b in zip(P.flatten(got)[0], P.flatten(state)[0]):
        assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
        assert torch.equal(a.cpu(), b)
    assert int(got["opt"]["step"]) == 7
