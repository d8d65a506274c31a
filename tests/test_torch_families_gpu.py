"""The MoE, SSM and hybrid families on the card at small sizes, held at
the CPU tests' bars against the port on the CPU (or against themselves):

  * the loss and every gradient leaf of reduced qwen3-moe, kimi-k2,
    mamba2-130m and jamba in float32 (TF32 off) within 1e-4 normalized
    of the CPU's;
  * `moe_ffn` with its capacity binding (dropped slots all written to one
    dump row, in no set order on the card): two calls bitwise equal, and
    within 1e-5 of the CPU in float32;
  * `apply_updates(donate=True)` (AdamW, Muon) bitwise the functional
    update on the card, written into the given tensors;
  * the train CLI on mamba2 (baseline and Uno at 2 pods, K3-K5 in the
    step) and jamba, reduced, as subprocesses.

This file imports no JAX, so that it runs on the machine with the card:

    python3 -m pytest -q -m gpu tests/test_torch_families_gpu.py

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

from repro_torch import models, optim  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import params as P  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS_9B = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "mamba2-130m",
            "jamba-1.5-large-398b"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _to(tree, device):
    leaves, treedef = P.flatten(tree)
    return P.unflatten(treedef, [l.to(device) for l in leaves])


def _value_and_grad(params, batch, cfg):
    leaves, treedef = P.flatten(params)
    leaves = [l.detach().clone().requires_grad_() for l in leaves]
    loss = models.loss_fn(P.unflatten(treedef, leaves), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS_9B)
def test_loss_and_grads_on_card_match_cpu(dev, arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), **F32)
    leaves, treedef = P.flatten(models.init_params(
        cfg, torch.Generator().manual_seed(16)))
    params = P.unflatten(treedef, [l.float() for l in leaves])
    batch = synth_batch(cfg, 0, 2, 32)
    want = _value_and_grad(params, batch, cfg)
    got = _value_and_grad(_to(params, dev),
                          {k: v.to(dev) for k, v in batch.items()}, cfg)
    assert _rel(got[0], want[0]) <= 1e-4, arch
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert a.device.type == "cuda" and bool(torch.isfinite(a).all())
        assert _rel(a, b) <= 1e-4, (arch, i)


@pytest.mark.gpu
def test_moe_ffn_with_binding_capacity_on_card(dev):
    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-235b-a22b")),
                              capacity_factor=0.5, **F32)
    assert moe.capacity(64, cfg) == 8
    gen = torch.Generator().manual_seed(17)
    p = {k: v[0].float() for k, v in models.init_params(
        cfg, gen)["layers"]["moe"].items()}
    h = torch.randn(2, 32, cfg.d_model, generator=gen)
    want = moe.moe_ffn(h, p, cfg, cfg.d_ff_expert)
    pd = {k: v.to(dev) for k, v in p.items()}
    a = moe.moe_ffn(h.to(dev), pd, cfg, cfg.d_ff_expert)
    b = moe.moe_ffn(h.to(dev), pd, cfg, cfg.d_ff_expert)
    assert torch.equal(a, b)
    assert _rel(a, want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("opt", ["adamw", "muon"])
def test_donated_update_on_card_is_the_same_update(dev, opt):
    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-235b-a22b")),
                              optimizer=opt)
    gen = torch.Generator(device=dev).manual_seed(18)
    params = models.init_params(cfg, gen)
    grads = P.unflatten(P.flatten(params)[1], [
        (torch.randn(l.shape, generator=gen, device=dev) * 1e-3).to(l.dtype)
        for l in P.flatten(params)[0]])
    state = optim.init_opt_state(params, cfg)
    want_p, want_s = optim.apply_updates(params, grads, state, cfg, 1e-3)
    keep = P.flatten(params)[0]
    got_p, got_s = optim.apply_updates(params, grads, state, cfg, 1e-3,
                                       donate=True)
    for a, b, k in zip(P.flatten(got_p)[0], P.flatten(want_p)[0], keep):
        assert a is k and torch.equal(a, b)
    for a, b in zip(P.flatten(got_s["m"])[0], P.flatten(want_s["m"])[0]):
        assert torch.equal(a, b)


def _run_cli(*args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("arch,extra", [
    ("mamba2-130m", ()), ("mamba2-130m", ("--uno", "--pods", "2")),
    ("jamba-1.5-large-398b", ())])
def test_train_cli_on_card(dev, arch, extra):
    out = _run_cli("--arch", arch, "--reduced", "--steps", "3", "--batch",
                   "4", "--seq", "32", *extra)
    m = re.search(r"done: (\d+) steps .* on cuda.*loss (\S+) -> (\S+);", out)
    assert m, out[-2000:]
    assert int(m.group(1)) == 3
    assert np.isfinite(float(m.group(2))) and np.isfinite(float(m.group(3)))
