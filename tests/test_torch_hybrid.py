"""The port's hybrid family (`repro_torch.models.hybrid`, jamba) against
the jitted JAX reference on the same numpy-seeded parameters and inputs
(helpers in tests/family_parity.py); the meta-device trees of the four
families that 9b added at full size; a reference-format checkpoint of a
hybrid training state restored by the port.

Reduced jamba (n_layers 2, attn_period 2, moe_every 2) has one period:
pos0 = attention + dense MLP, pos1 = Mamba + MoE, every branch of the
family.  Bars, those of the dense family: the loss and every gradient
leaf in float32 within rtol 1e-4 normalized, remat "none" and "full"
(the two bitwise equal); prefill logits, the K/V and conv / SSD caches
and 8 decode steps within 1e-5; `serve`'s greedy completions token for
token.  At full size, shapes and dtypes of `abstract_params`,
`abstract_cache` and the input specs, and `param_count`, equal the
reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import family_parity as FP  # noqa: E402
from repro import ckpt as RC  # noqa: E402
from repro import models as RM  # noqa: E402
from repro import optim as RO  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.configs import registry as RR  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro.models import api as RA  # noqa: E402

from repro_torch import ckpt as TC  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

ARCH = "jamba-1.5-large-398b"
FAMILIES_9B = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "mamba2-130m",
               ARCH]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_reduced_period_holds_every_branch():
    _, tcfg = FP.cfgs(ARCH)
    layers = TM.param_defs(tcfg)["layers"]
    assert sorted(layers) == ["pos0", "pos1"]
    assert sorted(layers["pos0"]) == ["attn", "ffn"]
    assert sorted(layers["pos1"]) == ["ffn", "mamba"]
    assert "w_up" in layers["pos0"]["ffn"] and \
        "router" not in layers["pos0"]["ffn"]
    assert layers["pos1"]["ffn"]["router"].dtype == torch.float32
    with pytest.raises(ValueError, match="attn_period"):
        TM.param_defs(TB.reduced(TR.get_config(ARCH), n_layers=3))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_reference_f32(remat):
    FP.check_loss_and_grads(ARCH, remat, seed=80)


def test_prefill_and_decode_match_reference_f32():
    cache = FP.check_serving(ARCH, seed=81)
    assert sorted(cache) == ["conv", "k", "ssm", "v"]
    _, tcfg = FP.cfgs(ARCH)
    assert tuple(cache["ssm"].shape[:2]) == (1, 1)   # (NP, n_mamba)
    assert tuple(cache["k"].shape) == (1, 3, 16, tcfg.n_kv_heads,
                                       tcfg.head_dim)


def test_serve_completions_match_reference(monkeypatch):
    """Reduced jamba in float32, 5 requests of 20 + 8 in waves of 2."""
    rcfg, tcfg = FP.cfgs(ARCH)
    params = FP.params(rcfg, tcfg, seed=82)
    monkeypatch.setattr(RM, "init_params", lambda key, cfg: jax.tree.map(
        jnp.asarray, params))
    rng = np.random.default_rng(83)
    prompts = [rng.integers(0, rcfg.vocab, 20 - (i % 2), dtype=np.int32)
               for i in range(5)]
    ref_reqs = [RS.Request(i, p, 8) for i, p in enumerate(prompts)]
    port_reqs = [TS.Request(i, p, 8) for i, p in enumerate(prompts)]
    want = RS.serve(rcfg, ref_reqs, batch=2, max_len=28)
    got = TS.serve(tcfg, port_reqs, batch=2, max_len=28,
                   params=TP.tree_from_arrays(params, "cpu"), device="cpu")
    assert got["tokens"] == want["tokens"] == 40
    assert [r.out for r in port_reqs] == [r.out for r in ref_reqs]


def _meta_like(port, ref):
    p_leaves, r_leaves = TP.flatten(port)[0], jax.tree.leaves(ref)
    assert len(p_leaves) == len(r_leaves)
    for p, r in zip(p_leaves, r_leaves):
        assert p.device.type == "meta"
        assert tuple(p.shape) == r.shape
        assert str(p.dtype).removeprefix("torch.") == str(r.dtype)


@pytest.mark.parametrize("arch", FAMILIES_9B)
def test_full_size_abstract_trees_match_reference(arch):
    """Full size, nothing allocated: the params, the cache of the
    decode_32k cell, the three cells' input specs; param_count and
    param_bytes equal the reference's (mamba2-130m: 128,835,456)."""
    rcfg, tcfg = RR.get_config(arch), TR.get_config(arch)
    _meta_like(TM.abstract_params(tcfg), RM.abstract_params(rcfg))
    _meta_like(TM.abstract_cache(tcfg, 128, 32_768),
               RM.abstract_cache(rcfg, 128, 32_768))
    defs = TM.param_defs(tcfg)
    assert TP.param_count(defs) == RA.param_count(RM.param_defs(rcfg))
    assert TP.param_bytes(defs) == RA.param_bytes(RM.param_defs(rcfg))
    if arch == "mamba2-130m":
        assert TP.param_count(defs) == 128_835_456
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        rshape, tshape = RB.SHAPES[name], TB.SHAPES[name]
        _meta_like(TM.train_input_specs(tcfg, tshape),
                   RM.train_input_specs(rcfg, rshape))
        _meta_like({"x": TM.prefill_input_specs(tcfg, tshape)},
                   {"x": RM.prefill_input_specs(rcfg, rshape)})
        _meta_like({"x": TM.decode_input_specs(tcfg, tshape)},
                   {"x": RM.decode_input_specs(rcfg, rshape)})


def test_reference_checkpoint_of_a_hybrid_state_restores(tmp_path):
    """The reference's `ckpt.save` of reduced jamba's training state (bf16
    params, the float32 router / dt_bias / A_log / D, Muon's bf16
    momentum, the step) restores through the port's `ckpt.restore` into
    the port's template, every leaf bitwise in its dtype; and back."""
    rcfg, tcfg = FP.cfgs(ARCH, f32=False)
    params = FP.params(rcfg, tcfg, seed=84, f32=False)
    state = {"params": params, "opt": RO.init_opt_state(
        jax.tree.map(jnp.asarray, params), rcfg)}
    RC.save(tmp_path, 7, state)
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    template = {"params": tparams, "opt": TO.init_opt_state(tparams, tcfg)}
    got = TC.restore(tmp_path, 7, template)
    for a, b in zip(TP.flatten(got)[0], jax.tree.leaves(state)):
        b = np.atleast_1d(np.asarray(b))
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        a = np.atleast_1d(TP.tree_to_arrays({"x": a})["x"])
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    TC.save(tmp_path, 8, got)
    back = RC.restore(tmp_path, 8, state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert np.array_equal(np.atleast_1d(np.asarray(a)).view(np.uint8),
                              np.atleast_1d(np.asarray(b)).view(np.uint8))
