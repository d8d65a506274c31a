"""The port's dense LM (`repro_torch.models`: layers, transformer, family
dispatch, parameter init) against the JAX reference on the same
numpy-seeded inputs.

Layers match at rtol 1e-5 in float32.  `loss_fn` and its gradients match
`jax.value_and_grad` (jitted) at rtol 1e-4, normalized by each leaf's
largest reference value, in float32: the config's compute dtype set to
float32 and every parameter carried across as float32 (the reference's
ParamDefs are bfloat16 whatever `param_dtype` says).  In bfloat16 the
two packages round the activations in different places (XLA keeps fused
intermediates in float32), so the bf16 case holds the loss within 5e-3
and each gradient leaf within 5e-2 normalized (measured: 4.2e-4 and at
most 1.9e-2)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.configs import registry as RR  # noqa: E402
from repro.models import layers as RL  # noqa: E402

from repro_torch import models as TM  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["smollm-135m", "granite-8b", "qwen2.5-3b", "nemotron-4-340b",
         "musicgen-large"]
LAYER_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(port, want, rtol, what=""):
    got = port.detach().float().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rtol, (what, err)
    return err


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _cfgs(arch, f32=True, **kw):
    ref = RB.reduced(RR.get_config(arch), **kw)
    port = TB.reduced(TR.get_config(arch), **kw)
    if f32:
        ref = dataclasses.replace(ref, param_dtype="float32",
                                  compute_dtype="float32")
        port = dataclasses.replace(port, param_dtype="float32",
                                   compute_dtype="float32")
    return ref, port


def _params(cfg, seed, dtype=np.float32):
    """A reference parameter tree of numpy arrays (norms near 1, weights
    at 1/sqrt(fan_in) scale)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if len(s.shape) == 1 or s.shape[-1] == cfg.d_model and \
                len(s.shape) == 2 and s.shape[0] == cfg.n_layers:
            return (1.0 + _normal(rng, s.shape, 0.1)).astype(dtype)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return np.asarray(jnp.asarray(_normal(rng, s.shape, fan_in ** -0.5))
                          .astype(dtype))

    return jax.tree.map(leaf, RM.abstract_params(cfg))


def _batch(cfg, seed, b=2, s=32, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        inputs = np.asarray(jnp.asarray(_normal(rng, (b, s, cfg.d_model)))
                            .astype(dtype))
    else:
        inputs = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    targets = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    targets[0, :3] = -1
    return {"inputs": inputs, "targets": targets}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# ------------------------------------------------------------------ layers

def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x, w = _normal(rng, (2, 8, 3, 16)), 1 + _normal(rng, (16,), 0.1)
    _close(TL.rms_norm(_to_torch(x), _to_torch(w), 1e-6),
           RL.rms_norm(x, w, 1e-6), LAYER_RTOL, "rms_norm")
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).astype(np.int32)
    cos, sin = TL.rope_cos_sin(torch.from_numpy(pos.copy()), 16, 1e4,
                               torch.float32)
    rc, rs = RL.rope_cos_sin(jnp.asarray(pos), 16, 1e4, jnp.float32)
    _close(cos, rc, LAYER_RTOL, "cos")
    _close(sin, rs, LAYER_RTOL, "sin")
    _close(TL.apply_rope(_to_torch(x), cos, sin),
           RL.apply_rope(jnp.asarray(x), rc, rs), LAYER_RTOL, "rope")


@pytest.mark.parametrize("causal,kv_block,kv_len", [
    (True, 8, None),          # 4 KV blocks: the online softmax crosses them
    (False, 16, None),
    (True, 32, None),         # one block
    (False, 8, 19),           # a padded cache: positions >= 19 masked
])
def test_flash_attention_matches(causal, kv_block, kv_len):
    """GQA (6 query heads over 2 KV heads, G = 3)."""
    rng = np.random.default_rng(1)
    q = _normal(rng, (2, 32, 6, 16))
    k, v = _normal(rng, (2, 32, 2, 16)), _normal(rng, (2, 32, 2, 16))
    got = TL.flash_attention(_to_torch(q), _to_torch(k), _to_torch(v),
                             causal=causal, kv_block=kv_block, kv_len=kv_len)
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, kv_block=kv_block, kv_len=kv_len)
    _close(got, want, LAYER_RTOL, "flash")


def test_flash_attention_grads_match():
    rng = np.random.default_rng(2)
    q = _normal(rng, (1, 32, 4, 8))
    k, v = _normal(rng, (1, 32, 2, 8)), _normal(rng, (1, 32, 2, 8))
    ct = _normal(rng, (1, 32, 4, 8))
    f = lambda q, k, v: jnp.sum(RL.flash_attention(
        q, k, v, causal=True, kv_block=8) * ct)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [_to_torch(a).requires_grad_() for a in (q, k, v)]
    out = TL.flash_attention(*ts, causal=True, kv_block=8)
    got = torch.autograd.grad((out * _to_torch(ct)).sum(), ts)
    for g, w, n in zip(got, want, "qkv"):
        _close(g, w, LAYER_RTOL, f"d{n}")


@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches(act):
    rng = np.random.default_rng(3)
    h = _normal(rng, (2, 8, 16))
    p = {"w_up": _normal(rng, (16, 32), 0.25),
         "w_down": _normal(rng, (32, 16), 0.2)}
    if act == "swiglu":
        p["w_gate"] = _normal(rng, (16, 32), 0.25)
    got = TL.mlp(_to_torch(h), {k: _to_torch(v) for k, v in p.items()}, act)
    _close(got, RL.mlp(jnp.asarray(h), jax.tree.map(jnp.asarray, p), act),
           LAYER_RTOL, act)


@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_xent_matches(chunk):
    """-1 labels masked; 4 chunks or one."""
    rng = np.random.default_rng(4)
    h, w = _normal(rng, (2, 32, 16)), _normal(rng, (16, 50), 0.25)
    y = rng.integers(0, 50, (2, 32), dtype=np.int32)
    y[0, :5] = -1
    y[1, 30:] = -1
    th, tw = _to_torch(h).requires_grad_(), _to_torch(w).requires_grad_()
    got = TL.chunked_softmax_xent(th, tw, torch.from_numpy(y), chunk=chunk)
    f = lambda h, w: RL.chunked_softmax_xent(h, w, jnp.asarray(y),
                                             chunk=chunk)
    want, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    _close(got, want, LAYER_RTOL, "xent")
    dh, dw = torch.autograd.grad(got, (th, tw))
    _close(dh, gh, LAYER_RTOL, "dh")
    _close(dw, gw, LAYER_RTOL, "dw")


# ---------------------------------------------------------- the whole model

def _port_value_and_grad(params_np, batch_np, cfg):
    tree = TP.tree_from_arrays(params_np, "cpu")
    leaves, treedef = TP.flatten(tree)
    leaves = [l.requires_grad_() for l in leaves]
    batch = {k: _to_torch(v) for k, v in batch_np.items()}
    loss = TM.loss_fn(TP.unflatten(treedef, leaves), batch, cfg)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    """Reduced configs (2 layers, d_model 64, S 32): smollm (tied
    embeddings), granite, qwen2.5 (QKV bias), nemotron (squared ReLU),
    musicgen (frame embeddings, GELU)."""
    rcfg, tcfg = _cfgs(arch)
    params = _params(rcfg, seed=10)
    batch = _batch(rcfg, seed=11)
    loss, grads = _port_value_and_grad(params, batch, tcfg)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, rcfg)))(params, batch)
    _close(loss, want, GRAD_RTOL, "loss")
    for i, (g, w) in enumerate(zip(grads, jax.tree.leaves(wgrads))):
        _close(g, w, GRAD_RTOL, f"{arch} grad leaf {i}")


def test_loss_and_grads_match_reference_bf16():
    """smollm reduced in its own dtypes (bf16 params and activations)."""
    rcfg, tcfg = _cfgs("smollm-135m", f32=False)
    params = _params(rcfg, seed=12, dtype=jnp.bfloat16)
    params["final_norm"] = params["final_norm"].astype(jnp.bfloat16)
    batch = _batch(rcfg, seed=13)
    loss, grads = _port_value_and_grad(params, batch, tcfg)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, rcfg)))(params, batch)
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= 5e-3, (loss, float(want))
    for i, (g, w) in enumerate(zip(grads, jax.tree.leaves(wgrads))):
        assert g.dtype == torch.bfloat16
        _close(g, w, 5e-2, f"bf16 grad leaf {i}")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_same_grads(policy):
    """Recomputation changes memory, not the arithmetic: "full" and
    "dots" give bitwise the gradients of "none"."""
    rcfg, tcfg = _cfgs("granite-8b")
    params = _params(rcfg, seed=14)
    batch = _batch(rcfg, seed=15)
    base = _port_value_and_grad(params, batch,
                                dataclasses.replace(tcfg, remat_policy="none"))
    got = _port_value_and_grad(params, batch,
                               dataclasses.replace(tcfg, remat_policy=policy))
    assert torch.equal(base[0], got[0])
    for a, b in zip(base[1], got[1]):
        assert torch.equal(a, b)


def test_transformer_module_is_the_functional_model():
    """`Transformer` holds the tree as parameters under the reference's
    names; its loss is `loss_fn` on the same tree."""
    rcfg, tcfg = _cfgs("qwen2.5-3b")
    params = TP.tree_from_arrays(_params(rcfg, seed=16), "cpu")
    model = TT.Transformer(tcfg, params)
    names = {n for n, _ in model.named_parameters()}
    assert {"layers.attn.wq", "layers.attn.bq", "layers.mlp.w_gate",
            "final_norm", "lm_head", "embed"} <= names
    assert len(names) == len(TP.flatten(params)[0])
    batch = {k: _to_torch(v) for k, v in _batch(rcfg, seed=17).items()}
    assert torch.equal(model.loss(batch), TM.loss_fn(params, batch, tcfg))
    assert model.tree()["layers"]["attn"]["wq"] is \
        model.get_parameter("layers.attn.wq")


def test_init_params_shapes_dtypes_and_seed():
    cfg = TB.reduced(TR.get_config("smollm-135m"))
    gen = lambda s: torch.Generator().manual_seed(s)
    a, b = TM.init_params(cfg, gen(0)), TM.init_params(cfg, gen(0))
    c = TM.init_params(cfg, gen(1))
    ref = RM.abstract_params(RB.reduced(RR.get_config("smollm-135m")))
    for (la, lb, lc, lr) in zip(TP.flatten(a)[0], TP.flatten(b)[0],
                                TP.flatten(c)[0], jax.tree.leaves(ref)):
        assert tuple(la.shape) == lr.shape and la.dtype == torch.bfloat16
        assert torch.equal(la, lb)
    assert torch.all(a["layers"]["attn"]["norm"] == 1)
    assert not torch.equal(a["lm_head"], c["lm_head"])
    std = float(a["lm_head"].float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "mamba2-130m",
                                  "jamba-1.5-large-398b"])
def test_unported_families_raise(arch):
    """The MoE, SSM and hybrid families (ROADMAP item 9b) build through
    the dispatch: their ParamDef tree has the reference's leaf paths,
    shapes and dtypes (float32 router / dt_bias / A_log / D in a bf16
    tree), `init_params` draws it, and the float32 loss on a seeded tree
    equals the jitted reference's within 1e-4 (their gradients:
    tests/test_torch_{moe,ssm,hybrid}.py)."""
    import family_parity as FP
    rcfg, tcfg = _cfgs(arch, f32=False)
    want = jax.tree_util.tree_flatten_with_path(RM.abstract_params(rcfg))[0]
    defs = TP.flatten(TM.param_defs(tcfg))[0]
    assert len(defs) == len(want)
    for d, (_, w) in zip(defs, want):
        assert d.shape == w.shape
        assert str(d.dtype).removeprefix("torch.") == str(w.dtype)
    tree = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert [l.dtype for l in TP.flatten(tree)[0]] == [d.dtype for d in defs]
    rcfg, tcfg = _cfgs(arch)
    params = FP.params(rcfg, tcfg, seed=18)
    batch = _batch(rcfg, seed=19)
    with torch.no_grad():
        loss = TM.loss_fn(TP.tree_from_arrays(params, "cpu"),
                          {k: _to_torch(v) for k, v in batch.items()}, tcfg)
    want = jax.jit(lambda p, b: RM.loss_fn(p, b, rcfg))(params, batch)
    _close(loss, want, GRAD_RTOL, "loss")
