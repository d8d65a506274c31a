"""The port's serving path (`models.layers.decode_attention`, the
transformer's `prefill` / `decode_step` / `cache_defs`, the dispatch and
its meta-device specs, `train.make_prefill_step` / `make_decode_step`,
`launch.serve` and `launch.serve_batched`) against the jitted JAX
reference on the same numpy-seeded parameters and inputs.

Bars: in float32 (the config's dtypes set to float32, the parameters
carried across as float32) `decode_attention`, the prefill logits and
the whole padded cache, and the logits of 8 successive decode steps
within rtol 1e-5, normalized by the reference's largest value; in
bfloat16 the prefill logits within 5e-3 normalized (the bf16 bar of
tests/test_torch_models.py); greedy completions of `serve` on the
serving example's reduced qwen2.5 in float32 equal to the reference's
token for token.  Configs: reduced smollm-135m (tied embeddings), the
example's reduced qwen2.5 (QKV bias) and reduced musicgen-large (frame
embeddings as inputs)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.configs import registry as RR  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro.models import layers as RL  # noqa: E402

from repro_torch import models as TM  # noqa: E402
from repro_torch import train as TT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import serve_batched  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import transformer as TX  # noqa: E402

RTOL = 1e-5
BF16_RTOL = 5e-3
QWEN_EXAMPLE = dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
                    head_dim=32, d_ff=512, vocab=4096)
CASES = {
    "smollm": ("smollm-135m", {}),
    "qwen_example": ("qwen2.5-3b", QWEN_EXAMPLE),
    "musicgen": ("musicgen-large", {}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(port, want, rtol, what=""):
    got = port.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rtol, (what, err)
    return err


def _cfgs(case, f32=True):
    arch, kw = CASES[case]
    ref = RB.reduced(RR.get_config(arch), **kw)
    port = TB.reduced(TR.get_config(arch), **kw)
    if f32:
        f = dict(param_dtype="float32", compute_dtype="float32")
        ref, port = (dataclasses.replace(ref, **f),
                     dataclasses.replace(port, **f))
    return ref, port


def _params(cfg, seed, dtype=np.float32):
    """A reference parameter tree of numpy arrays: norms near 1, weights
    at 1/sqrt(fan_in), QKV biases small."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if len(s.shape) == 1 or len(s.shape) == 2 and \
                s.shape == (cfg.n_layers, cfg.d_model):
            x = 1.0 + rng.normal(size=s.shape) * 0.1
        elif len(s.shape) == 2 and s.shape[0] == cfg.n_layers:
            x = rng.normal(size=s.shape) * 0.02             # biases
        else:
            x = rng.normal(size=s.shape) * s.shape[-2] ** -0.5
        return np.asarray(jnp.asarray(x.astype(np.float32)).astype(dtype))

    return jax.tree.map(leaf, RM.abstract_params(cfg))


def _inputs(cfg, rng, b, s, dtype=np.float32):
    if cfg.input_mode == "embeddings":
        x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        return np.asarray(jnp.asarray(x).astype(dtype))
    return rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _ref_steps(rcfg, max_len):
    pre = jax.jit(lambda p, x: RM.prefill(p, x, rcfg, max_len))
    dec = jax.jit(lambda p, c, x, pos: RM.decode_step(p, c, x, pos, rcfg))
    return pre, dec


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("kv_len", [1, 13, 24])
def test_decode_attention_matches(kv_len):
    """GQA with G = 3 (6 query heads over 2 KV heads), a padded cache of
    24 with `kv_len` valid entries."""
    rng = np.random.default_rng(kv_len)
    q = rng.normal(size=(2, 1, 6, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jax.jit(RL.decode_attention)(q, k, v, jnp.int32(kv_len))
    _close(TL.decode_attention(_t(q), _t(k), _t(v), kv_len), want, RTOL,
           "decode_attention")


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_logits_and_cache_match_reference_f32(case):
    rcfg, tcfg = _cfgs(case)
    params = _params(rcfg, seed=20)
    x = _inputs(rcfg, np.random.default_rng(21), 2, 16)
    pre, _ = _ref_steps(rcfg, 24)
    logits, cache, pos = pre(params, x)
    with torch.inference_mode():
        tl, tc, tpos = TM.prefill(TP.tree_from_arrays(params, "cpu"), _t(x),
                                  tcfg, 24)
    assert tpos == int(pos) == 16
    assert tl.dtype == torch.float32
    _close(tl, logits, RTOL, f"{case} logits")
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == cache[k].shape == \
            (tcfg.n_layers, 2, 24, tcfg.n_kv_heads, tcfg.head_dim)
        _close(tc[k], cache[k], RTOL, f"{case} cache {k}")
        assert bool((tc[k][:, :, 16:] == 0).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_steps_match_reference_f32(case):
    """8 successive decode steps from a prefill of 8 (left-padded prompts
    as the engine builds them), the same inputs on both sides: each
    step's logits, and the cache at the end."""
    rcfg, tcfg = _cfgs(case)
    params = _params(rcfg, seed=22)
    rng = np.random.default_rng(23)
    x = _inputs(rcfg, rng, 3, 8)
    if rcfg.input_mode == "tokens":
        x[1, :3] = 0                                    # left padding
    steps = [_inputs(rcfg, rng, 3, 1) for _ in range(8)]
    pre, dec = _ref_steps(rcfg, 16)
    tparams = TP.tree_from_arrays(params, "cpu")
    _, cache, pos = pre(params, x)
    with torch.inference_mode():
        _, tcache, tpos = TM.prefill(tparams, _t(x), tcfg, 16)
        for i, s in enumerate(steps):
            logits, cache = dec(params, cache, s, pos)
            tl, tcache = TM.decode_step(tparams, tcache, _t(s), tpos, tcfg)
            pos, tpos = pos + 1, tpos + 1
            _close(tl, logits, RTOL, f"{case} decode step {i}")
    for k in ("k", "v"):
        _close(tcache[k], cache[k], RTOL, f"{case} cache {k}")


def test_prefill_logits_match_reference_bf16():
    """Reduced smollm in its own dtypes (bf16 params and activations)."""
    rcfg, tcfg = _cfgs("smollm", f32=False)
    params = _params(rcfg, seed=24, dtype=jnp.bfloat16)
    x = _inputs(rcfg, np.random.default_rng(25), 2, 16)
    logits, _, _ = _ref_steps(rcfg, 24)[0](params, x)
    with torch.inference_mode():
        tl, tc, _ = TM.prefill(TP.tree_from_arrays(params, "cpu"), _t(x),
                               tcfg, 24)
    assert tc["k"].dtype == torch.bfloat16
    _close(tl, logits, BF16_RTOL, "bf16 logits")


def test_module_and_step_factories_are_the_functional_model():
    """`Transformer.prefill` / `.decode` and `make_prefill_step` /
    `make_decode_step` compute exactly the functional `prefill` /
    `decode_step`."""
    rcfg, tcfg = _cfgs("qwen_example")
    params = TP.tree_from_arrays(_params(rcfg, seed=26), "cpu")
    x = torch.from_numpy(_inputs(rcfg, np.random.default_rng(27), 2, 8))
    tok = x[:, :1]
    model = TX.Transformer(tcfg, params)
    pre, dec = TT.make_prefill_step(tcfg, 12), TT.make_decode_step(tcfg)
    with torch.inference_mode():
        want_l, want_c, pos = TM.prefill(params, x, tcfg, 12)
        want_d, _ = TM.decode_step(params, want_c, tok, pos, tcfg)
        for run_pre, run_dec in (
                (lambda: model.prefill(x, 12),
                 lambda c, p: model.decode(c, tok, p)),
                (lambda: pre(params, x),
                 lambda c, p: dec(params, c, tok, p))):
            got_l, got_c, got_pos = run_pre()
            assert got_pos == pos and torch.equal(got_l, want_l)
            got_d, _ = run_dec(got_c, got_pos)
            assert torch.equal(got_d, want_d)


def test_forward_collect_kv_keeps_the_training_path():
    """`forward(collect_kv=True)` returns the same hidden states as the
    training call, and its (k, v) stacked per layer; with gradients off
    (no checkpoints) the hidden states are the same."""
    rcfg, tcfg = _cfgs("smollm")
    params = TP.tree_from_arrays(_params(rcfg, seed=28), "cpu")
    x = torch.from_numpy(_inputs(rcfg, np.random.default_rng(29), 2, 8))
    h = TX.forward(params, x, tcfg)
    h2, (ks, vs) = TX.forward(params, x, tcfg, collect_kv=True)
    assert torch.equal(h, h2)
    assert tuple(ks.shape) == tuple(vs.shape) == (
        tcfg.n_layers, 2, 8, tcfg.n_kv_heads, tcfg.head_dim)
    with torch.inference_mode():
        assert torch.equal(TX.forward(params, x, tcfg), h)


# ------------------------------------------------------------------ specs

def _meta_like(port, ref):
    p_leaves, r_leaves = TP.flatten(port)[0], jax.tree.leaves(ref)
    assert len(p_leaves) == len(r_leaves)
    for p, r in zip(p_leaves, r_leaves):
        assert p.device.type == "meta"
        assert tuple(p.shape) == r.shape
        assert str(p.dtype).split(".")[-1] == str(r.dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_abstract_params_cache_and_input_specs_match_reference(case):
    arch, kw = CASES[case]
    rcfg = RB.reduced(RR.get_config(arch), **kw)
    tcfg = TB.reduced(TR.get_config(arch), **kw)
    _meta_like(TM.abstract_params(tcfg), RM.abstract_params(rcfg))
    _meta_like(TM.abstract_cache(tcfg, 3, 40), RM.abstract_cache(rcfg, 3, 40))
    from repro.models import api as RA
    assert TP.param_bytes(TM.param_defs(tcfg)) == \
        RA.param_bytes(RM.param_defs(rcfg))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        rshape, tshape = RB.SHAPES[name], TB.SHAPES[name]
        for rf, tf in ((RM.train_input_specs, TM.train_input_specs),
                       (RM.prefill_input_specs, TM.prefill_input_specs),
                       (RM.decode_input_specs, TM.decode_input_specs)):
            want, got = rf(rcfg, rshape), tf(tcfg, tshape)
            if isinstance(want, dict):
                _meta_like(got, want)
            else:
                _meta_like({"x": got}, {"x": want})


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "mamba2-130m"])
def test_unported_families_raise_in_serving(arch):
    """The MoE and SSM families (ROADMAP item 9b) serve through the
    dispatch: the cache has the reference's leaves, shapes and dtypes
    (the SSM's O(1) in max_len: conv tails and float32 states), and the
    float32 prefill logits equal the jitted reference's within 1e-5
    (decoding: tests/test_torch_moe.py, tests/test_torch_ssm.py)."""
    import family_parity as FP
    rcfg, tcfg = FP.cfgs(arch, f32=False)
    _meta_like(TM.abstract_cache(tcfg, 1, 8), RM.abstract_cache(rcfg, 1, 8))
    rcfg, tcfg = FP.cfgs(arch)
    params = FP.params(rcfg, tcfg, seed=32)
    x = _inputs(rcfg, np.random.default_rng(33), 2, 8)
    logits, cache, _ = _ref_steps(rcfg, 8)[0](params, x)
    with torch.inference_mode():
        tl, tc, pos = TM.prefill(TP.tree_from_arrays(params, "cpu"), _t(x),
                                 tcfg, 8)
    assert pos == 8 and sorted(tc) == sorted(cache)
    _close(tl, logits, RTOL, f"{arch} prefill logits")


# ------------------------------------------------------------------ engine

def test_serve_completions_match_reference(monkeypatch):
    """The serving example's reduced qwen2.5 in float32, its 12 requests
    of 48 + 24 in waves of 4: the reference's `serve` (its params drawn
    by `models.init_params`, here returning the numpy-seeded tree) and
    the port's on the same params complete every request with the same
    tokens; 12 x 24 tokens."""
    rcfg, tcfg = _cfgs("qwen_example")
    params = _params(rcfg, seed=30)
    monkeypatch.setattr(RM, "init_params", lambda key, cfg: jax.tree.map(
        jnp.asarray, params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, rcfg.vocab, 48, dtype=np.int32)
               for _ in range(12)]
    ref_reqs = [RS.Request(i, p, 24) for i, p in enumerate(prompts)]
    port_reqs = [TS.Request(i, p, 24) for i, p in enumerate(prompts)]
    want = RS.serve(rcfg, ref_reqs, batch=4, max_len=72)
    got = TS.serve(tcfg, port_reqs, batch=4, max_len=72,
                   params=TP.tree_from_arrays(params, "cpu"), device="cpu")
    assert got["tokens"] == want["tokens"] == 12 * 24
    assert [r.out for r in port_reqs] == [r.out for r in ref_reqs]
    assert got["completions"] == want["completions"]
    assert list(got) == list(want)
    assert got["ttft_p50_ms"] > 0 and got["itl_p50_ms"] > 0


def test_serve_embeddings_mode_matches_reference(monkeypatch):
    """Reduced musicgen (frame embeddings from default_rng(0), zeros as
    decode inputs): the same completions as the reference's `serve`."""
    rcfg, tcfg = _cfgs("musicgen")
    params = _params(rcfg, seed=31)
    monkeypatch.setattr(RM, "init_params", lambda key, cfg: jax.tree.map(
        jnp.asarray, params))
    mk = lambda R: [R.Request(i, np.zeros(12, np.int32), 6)  # noqa: E731
                    for i in range(4)]
    ref_reqs, port_reqs = mk(RS), mk(TS)
    RS.serve(rcfg, ref_reqs, batch=2, max_len=18)
    TS.serve(tcfg, port_reqs, batch=2, max_len=18,
             params=TP.tree_from_arrays(params, "cpu"), device="cpu")
    assert [r.out for r in port_reqs] == [r.out for r in ref_reqs]


def test_engine_refuses_a_mesh_and_defaults_to_cuda():
    """A mesh engine (here one rank of a fake group: every placement
    whole) serves the no-mesh engine's tokens; the default device is
    cuda, which raises without a card."""
    from repro_torch.launch import mesh as TMesh
    rcfg, tcfg = _cfgs("smollm")
    params = _params(rcfg, seed=5)
    mk = lambda: [TS.Request(i, np.arange(3 + i, dtype=np.int32) % 7, 4)  # noqa: E731
                  for i in range(2)]
    plain, meshed = mk(), mk()
    TS.serve(tcfg, plain, batch=2, max_len=8,
             params=TP.tree_from_arrays(params, "cpu"), device="cpu")
    mesh = TMesh.make_fake_mesh((1, 1, 1), ("pod", "data", "model"))
    try:
        TS.serve(tcfg, meshed, batch=2, max_len=8, mesh=mesh,
                 params=TP.tree_from_arrays(params, "cpu"), device="cpu")
    finally:
        TMesh.destroy_fake_mesh()
    assert [r.out for r in meshed] == [r.out for r in plain]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.Engine(tcfg, batch=1, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.main(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_batched.main([])


def test_serve_clis_on_cpu():
    out = TS.main(["--device", "cpu", "--reduced", "--requests", "5",
                   "--prompt-len", "16", "--gen", "6", "--batch", "2"])
    assert out["requests"] == 5 and out["tokens"] == 5 * 6
    assert len(out["completions"]) == 2 and out["tok_per_s"] > 0
    ex = serve_batched.main(["--device", "cpu"])
    assert ex["tokens"] == 12 * 24
