"""The port's MoE family (`repro_torch.models.moe` and the transformer's
MoE branch) against the jitted JAX reference on the same numpy-seeded
parameters and inputs (helpers in tests/family_parity.py).

Bars, those of the dense family: `moe_ffn` and `aux_load_balance_loss`
in float32 within rtol 1e-5 normalized, with the capacity free (reduced
qwen3-moe: cap 24 for 64 tokens x top-2 over 8 experts) and binding
(capacity_factor 0.5: cap 8, tokens dropped), the gradients through the
gates and both scatters too; the loss and every gradient leaf of reduced
qwen3-moe and kimi-k2 within 1e-4 in float32, remat "none" and "full"
(the two bitwise equal); bf16 within the dense bf16 bars; prefill
logits, the cache and 8 decode steps within 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import family_parity as FP  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402

from repro_torch.models import moe as TMoE  # noqa: E402

LAYER_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _layer_inputs(rcfg, tcfg, seed, b=2, s=32):
    """One MoE layer's params (layer 0 of the model tree) and an input."""
    p = FP.params(rcfg, tcfg, seed)["layers"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    h = np.random.default_rng(seed + 1).normal(
        size=(b, s, rcfg.d_model)).astype(np.float32)
    return p, h


@pytest.mark.parametrize("capacity_factor,cap", [(1.25, 24), (0.5, 8)])
def test_moe_ffn_matches_reference(capacity_factor, cap):
    """Output and the gradients of h, the router and the expert weights
    (cotangent fixed), capacity free and binding."""
    rcfg, tcfg = FP.cfgs("qwen3-moe-235b-a22b",
                         capacity_factor=capacity_factor)
    assert TMoE.capacity(64, tcfg) == cap
    p, h = _layer_inputs(rcfg, tcfg, seed=40)
    ct = np.random.default_rng(42).normal(size=h.shape).astype(np.float32)

    def ref(h, p):
        return jnp.sum(RMoE.moe_ffn(h, p, rcfg, rcfg.d_ff_expert) * ct)

    out = jax.jit(lambda h, p: RMoE.moe_ffn(h, p, rcfg,
                                             rcfg.d_ff_expert))(h, p)
    gh, gp = jax.jit(jax.grad(ref, argnums=(0, 1)))(h, p)
    th = FP.to_torch(h).requires_grad_()
    tp = {k: FP.to_torch(v).requires_grad_() for k, v in p.items()}
    got = TMoE.moe_ffn(th, tp, tcfg, tcfg.d_ff_expert)
    FP.close(got, out, LAYER_RTOL, "moe_ffn")
    names = [k for k in sorted(tp) if k != "norm"]   # the block's, unread
    grads = torch.autograd.grad((got * FP.to_torch(ct)).sum(),
                                [th] + [tp[k] for k in names])
    FP.close(grads[0], gh, LAYER_RTOL, "dh")
    for k, g in zip(names, grads[1:]):
        FP.close(g, gp[k], LAYER_RTOL, f"d{k}")
    # routing as the port computes it: tokens dropped only when binding
    x = FP.to_torch(h).reshape(-1, tcfg.d_model)
    probs = torch.softmax(x @ tp["router"].detach(), dim=-1)
    ids = torch.topk(probs, tcfg.top_k).indices.reshape(-1)
    dropped = int(torch.clamp(torch.bincount(ids, minlength=8) - cap,
                              min=0).sum())
    assert (dropped > 0) == (capacity_factor < 1)


def test_moe_ffn_drops_deterministically_in_bf16():
    """bf16, capacity binding: two calls give bitwise the same output
    (the dump row is written several times and sliced away)."""
    _, tcfg = FP.cfgs("qwen3-moe-235b-a22b", f32=False, capacity_factor=0.5)
    rcfg, _ = FP.cfgs("qwen3-moe-235b-a22b", capacity_factor=0.5)
    p, h = _layer_inputs(rcfg, tcfg, seed=43)
    tp = {k: FP.to_torch(v).to(torch.float32 if k == "router"
                               else torch.bfloat16) for k, v in p.items()}
    th = FP.to_torch(h).to(torch.bfloat16)
    a = TMoE.moe_ffn(th, tp, tcfg, tcfg.d_ff_expert)
    b = TMoE.moe_ffn(th, tp, tcfg, tcfg.d_ff_expert)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_aux_load_balance_loss_matches_reference():
    rcfg, tcfg = FP.cfgs("qwen3-moe-235b-a22b")
    p, h = _layer_inputs(rcfg, tcfg, seed=44)
    want = jax.jit(lambda h, w: RMoE.aux_load_balance_loss(h, w, rcfg))(
        h, p["router"])
    got = TMoE.aux_load_balance_loss(FP.to_torch(h), FP.to_torch(p["router"]),
                                     tcfg)
    FP.close(got, want, LAYER_RTOL, "aux loss")
    assert float(got) >= 1.0 - 1e-6          # E * sum(frac * imp) >= 1


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"])
def test_loss_and_grads_match_reference_f32(arch, remat):
    FP.check_loss_and_grads(arch, remat, seed=45)


def test_loss_and_grads_capacity_binding_f32():
    """Reduced qwen3-moe with capacity_factor 0.5 (cap 8: the drop path
    inside the whole model's backward pass)."""
    FP.check_loss_and_grads("qwen3-moe-235b-a22b", "none", seed=47,
                            capacity_factor=0.5)


def test_loss_and_grads_match_reference_bf16():
    FP.check_loss_and_grads_bf16("qwen3-moe-235b-a22b", seed=48)


def test_prefill_and_decode_match_reference_f32():
    cache = FP.check_serving("qwen3-moe-235b-a22b", seed=50)
    assert sorted(cache) == ["k", "v"]


def test_param_defs_hold_a_float32_router():
    _, tcfg = FP.cfgs("qwen3-moe-235b-a22b", f32=False)
    from repro_torch import models as TM
    defs = TM.param_defs(tcfg)["layers"]["moe"]
    assert defs["router"].dtype == torch.float32
    assert all(defs[k].dtype == torch.bfloat16
               for k in ("w_gate", "w_up", "w_down", "norm"))
    gen = torch.Generator().manual_seed(0)
    tree = TM.init_params(tcfg, gen)
    assert tree["layers"]["moe"]["router"].dtype == torch.float32
    assert tuple(tree["layers"]["moe"]["w_gate"].shape) == (
        tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert)


def test_muon_on_stacked_expert_leaves_matches_reference():
    """qwen3-moe's optimizer on its reduced tree in float32, 2 updates:
    Newton–Schulz batched over the (L, E) axes of the 4-D expert leaves
    (and the 3-D attention ones), the router and norms normalized; the
    jitted reference's `apply_updates` within test_torch_train.py's Muon
    bars (params 1e-3, momentum 1e-6 normalized)."""
    from repro import optim as RO
    from repro_torch import optim as TO
    from repro_torch.models import params as TP
    rcfg, tcfg = FP.cfgs("qwen3-moe-235b-a22b", opt_state_dtype="float32")
    assert tcfg.optimizer == "muon"
    rng = np.random.default_rng(51)
    params = FP.params(rcfg, tcfg, seed=52)
    state = RO.init_opt_state(params, rcfg)
    tp = TP.tree_from_arrays(params, "cpu")
    ts = TO.init_opt_state(tp, tcfg)
    upd = jax.jit(lambda p, g, s, lr: RO.apply_updates(p, g, s, rcfg, lr))
    for i in range(2):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(
            np.float32), params)
        params, state = upd(params, g, state, jnp.float32(1e-3))
        tp, ts = TO.apply_updates(tp, TP.tree_from_arrays(g, "cpu"), ts,
                                  tcfg, 1e-3)
        for a, b in zip(TP.flatten(tp)[0], jax.tree.leaves(params)):
            FP.close(a, b, 1e-3, f"muon params step {i}")
        for a, b in zip(TP.flatten(ts["m"])[0], jax.tree.leaves(state["m"])):
            FP.close(a, b, 1e-6, f"muon momentum step {i}")
    assert tp["layers"]["moe"]["w_gate"].ndim == 4
