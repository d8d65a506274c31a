"""The port's UnoRC path (GF(2^8) Reed-Solomon, int8 quantization, the
protected pod exchange and the gradient sync) against the JAX reference,
on the same numpy-seeded inputs.  The bar is bitwise throughout.

The reference always runs jitted (the train step and the shard_map are),
and XLA rewrites two things there that the port therefore follows: a
division by a Python constant becomes a multiply by its f32 reciprocal
(`amax / 127.0`, `/ n_pods`), and a multiply feeding an add becomes one
fused multiply-add (the receiver's dequantize-then-add).  The reference
functions are called under `jax.jit` here for that reason; the tests that
pin each rewrite also show that the eager form differs.

On the CPU the kernel wrappers run their plain versions.  The reference's
multi-pod sync runs in one subprocess with four forced host devices (the
device count must be fixed before jax initializes)."""
import dataclasses
import itertools
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.configs import registry as RR  # noqa: E402
from repro.core import uno_collectives as RU  # noqa: E402
from repro.kernels import gf as RG  # noqa: E402
from repro.kernels import ops as RO  # noqa: E402
from repro.kernels import quant_pallas, rs_pallas  # noqa: E402
from repro.kernels import ref as RK  # noqa: E402

from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.core import uno_collectives as TU  # noqa: E402
from repro_torch.kernels import gf as TG  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TK  # noqa: E402
from repro_torch.kernels import fleet_cuda, unorc_cuda  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

DENSE = [a for a in RR.ARCH_IDS if RR.get_config(a).family == "dense"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eq(port, want, what=""):
    got = port.numpy() if isinstance(port, torch.Tensor) else port
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.array_equal(got, want), (what, int((got != want).sum()))


def _bytes(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------- field algebra

def _patterns(k, r):
    """(missing, parity_avail) for every decodable erasure pattern."""
    for m in range(1, r + 1):
        for missing in itertools.combinations(range(k), m):
            for n_par in range(m, r + 1):
                for avail in itertools.combinations(range(r), n_par):
                    yield missing, avail


@pytest.mark.parametrize("k,r", [(4, 1), (8, 2), (10, 3)])
def test_gf_tables_and_rs_coefficients_match(k, r):
    _eq(TG.EXP, RG.EXP, "EXP")
    _eq(TG.LOG, RG.LOG, "LOG")
    for a in range(256):
        assert TG.gf_pow_int(a, 7) == RG.gf_pow_int(a, 7)
        if a:
            assert TG.gf_inv_int(a) == RG.gf_inv_int(a)
    assert TG.rs_generator_rows(k, r) == RG.rs_generator_rows(k, r)
    n = 0
    for missing, avail in _patterns(k, r):
        assert TG.rs_decode_matrix(k, r, missing, avail) == \
            RG.rs_decode_matrix(k, r, missing, avail), (missing, avail)
        n += 1
    assert n > 0
    assert TG.rs_decode_matrix(k, r, (), tuple(range(r))) == ()


# ------------------------------------------------------------- RS coding

@pytest.mark.parametrize("k,r,missing,avail", [
    (8, 2, None, None),               # encode
    (8, 2, (0, 1), (0, 1)),           # the receiver's designated decode
    (8, 2, (3, 6), (0, 1)),
    (10, 3, None, None),
    (10, 3, (2, 5, 9), (0, 1, 2)),
])
def test_gf_matmul_matches_reference_and_pallas(k, r, missing, avail):
    """Plain rs_encode / rs_decode (through the wrappers, CPU tensors) at
    B = 4,096 bitwise equal to `ref` and to `rs_pallas` in interpret
    mode."""
    b = 4096
    if missing is None:
        x = _bytes(k * 10 + r, (k, b))
        port = TO.rs_encode(torch.from_numpy(x), r)
        want_ref = RK.rs_encode_ref(jnp.asarray(x), r)
        want_pallas = rs_pallas.rs_encode(jnp.asarray(x), r, interpret=True)
    else:
        x = _bytes(len(missing), (k - len(missing) + len(avail), b))
        port = TO.rs_decode(torch.from_numpy(x), k, r, missing, avail)
        want_ref = RK.rs_decode_ref(jnp.asarray(x), k, r, missing, avail)
        want_pallas = rs_pallas.rs_decode(jnp.asarray(x), k, r, missing,
                                          avail, interpret=True)
    _eq(port, want_ref, "ref")
    _eq(port, want_pallas, "pallas")
    coeffs = (RG.rs_generator_rows(k, r) if missing is None
              else RG.rs_decode_matrix(k, r, missing, avail))
    _eq(TK.gf_matmul_ref(coeffs, torch.from_numpy(x)), want_ref, "gf_matmul")


def test_rs_decode_with_lost_parity():
    """Erasures of data rows while a parity row is lost too (the
    reference's tests/test_kernels.py case): lose data rows {2, 5} and
    parity row 0, decode from parity {1, 2}."""
    k, r = 8, 3
    data = _bytes(9, (k, 512))
    parity = TO.rs_encode(torch.from_numpy(data), r)
    _eq(parity, RO.rs_encode(jnp.asarray(data), r), "parity")
    present = [i for i in range(k) if i not in (2, 5)]
    surv = torch.cat([torch.from_numpy(data[present]), parity[1:]])
    rec = TO.rs_decode(surv, k, r, (5, 2), (2, 1))
    _eq(rec, RO.rs_decode(jnp.asarray(surv.numpy()), k, r, (2, 5), (1, 2)))
    _eq(rec, data[[2, 5]], "recovered")
    assert TO.rs_decode(surv, k, r, (), (0,)).shape == (0, 512)


def test_every_erasure_pattern_of_rs_8_2_recovers():
    """All 55 patterns of one or two lost rows among the 10 of RS(8, 2)
    (data and parity alike) through `rs_block_roundtrip`: every lost data
    row comes back bitwise, and each decode equals the reference's
    `rs_decode_ref` on the same survivors."""
    k, r = 8, 2
    data = torch.from_numpy(_bytes(55, (k, 1000)))
    n = 0
    for m in (1, 2):
        for lost in itertools.combinations(range(k + r), m):
            missing = tuple(i for i in lost if i < k)
            avail = tuple(j for j in range(r) if k + j not in lost)
            parity, rec = TO.rs_block_roundtrip(data, r, missing, avail)
            assert rec.shape == (len(missing), 1000)
            for row, i in enumerate(missing):
                assert torch.equal(rec[row], data[i]), (lost, i)
            if missing:
                present = [i for i in range(k) if i not in missing]
                surv = np.concatenate([data.numpy()[present],
                                       parity.numpy()[list(avail)]])
                _eq(rec, RK.rs_decode_ref(jnp.asarray(surv), k, r, missing,
                                          avail), lost)
            n += 1
    assert n == 55


# ---------------------------------------------------------- int8 quant

def _grads(seed, n, zero_blocks=(1, 7)):
    x = (np.random.default_rng(seed).normal(size=n) * 1e-3).astype(
        np.float32)
    for b in zero_blocks:
        x[b * 256:(b + 1) * 256] = 0.0
    return x


def test_quant_matches_jitted_reference_and_pallas():
    """65,536 values with zero blocks: q and scales bitwise equal to
    `jax.jit(ref.quant_int8_ref)` and to `quant_pallas` in interpret mode;
    dequant bitwise equal to both.  The eager reference divides by 127
    (no reciprocal rewrite) and differs: the jitted form is the pinned
    contract."""
    x = _grads(0, 65_536)
    q, s, n0 = TO.quant_int8(torch.from_numpy(x))
    assert n0 == x.size
    qj, sj = jax.jit(RK.quant_int8_ref)(jnp.asarray(x))
    _eq(q, qj, "q vs jit ref")
    _eq(s, sj, "scales vs jit ref")
    qp, sp = quant_pallas.quant_int8(jnp.asarray(x), 256, interpret=True)
    _eq(q, qp, "q vs pallas")
    _eq(s, sp, "scales vs pallas")
    assert (s.numpy()[[1, 7]] == 1.0).all() and (q.numpy()[256:512] == 0).all()
    out = TO.dequant_int8(q, s, n0)
    _eq(out, jax.jit(RK.dequant_int8_ref)(qj, sj), "dequant vs ref")
    _eq(out, quant_pallas.dequant_int8(qp, sp, 256, interpret=True),
        "dequant vs pallas")
    _, s_eager = RK.quant_int8_ref(jnp.asarray(x))
    assert (np.asarray(s_eager) != s.numpy()).sum() > 0
    np.testing.assert_array_equal(
        s.numpy(), np.where(np.abs(x.reshape(-1, 256)).max(1) > 0,
                            np.abs(x.reshape(-1, 256)).max(1)
                            * np.float32(1 / 127), np.float32(1)))


def test_quant_ragged_length_through_ops(monkeypatch):
    """A length that is no multiple of 256 pads to the next block only:
    (q, scales, n0) equal the reference's ref-mode `_quant` under jit, and
    the dequantized values lie within half a quant step."""
    monkeypatch.setenv("REPRO_UNO_KERNELS", "ref")
    x = _grads(1, 70_000, zero_blocks=(3,))
    q, s, n0 = TO.quant_int8(torch.from_numpy(x))
    qj, sj, nj = jax.jit(RU._quant)(jnp.asarray(x))
    nj = int(nj)
    assert (n0, q.shape[0]) == (nj, 70_144)
    _eq(q, qj, "q")
    _eq(s, sj, "scales")
    out = TO.dequant_int8(q, s, n0).numpy()
    _eq(out, jax.jit(RU._dequant, static_argnums=2)(qj, sj, nj), "dequant")
    step = np.repeat(s.numpy(), 256)[:n0]
    assert (np.abs(out - x) <= 0.5 * step * (1 + 1e-6)).all()


def test_dequant_add_is_one_fused_multiply_add():
    """The receiver's `c + dequant(q, s)` under jit is XLA's fused
    multiply-add: one rounding, not two.  `fma_f32_ref` is that rounding,
    and the eager (unfused) form differs."""
    rng = np.random.default_rng(5)
    n = 1 << 14
    q = rng.integers(-127, 128, n).astype(np.int8)
    s = np.repeat((np.abs(rng.normal(size=n // 256)) * 1e-5).astype(
        np.float32), 256)
    c = (rng.normal(size=n) * 1e-3).astype(np.float32)
    want = jax.jit(lambda q, s, c: c + q.astype(jnp.float32) * s)(q, s, c)
    got = TK.fma_f32_ref(torch.from_numpy(q).float(), torch.from_numpy(s),
                         torch.from_numpy(c))
    _eq(got, want, "fma")
    qt, st = torch.from_numpy(q), torch.from_numpy(s[::256].copy())
    _eq(unorc_cuda.dequant_int8(qt, st, torch.from_numpy(c)), want, "K5 acc")
    assert (np.asarray(want) != c + q.astype(np.float32) * s).sum() > 0


def test_f32_bytes_rows_match_reference():
    """RS packet framing of a float32 vector: rows bitwise equal to the
    reference's, and the bytes read back to the same floats."""
    x = np.random.default_rng(11).normal(size=1000).astype(np.float32)
    rows, n0 = TO.f32_to_bytes_rows(torch.from_numpy(x), 8)
    want, want_n0 = RO.f32_to_bytes_rows(jnp.asarray(x), 8)
    assert n0 == want_n0 == 4000
    _eq(rows, want, "rows")
    _eq(TO.bytes_rows_to_f32(rows, n0), x, "floats")


# ------------------------------------------------------- wire format

@pytest.mark.parametrize("mode,n", [("ref", 8 * 256 * 4 + 100),
                                    ("ref", 8 * 256 * 3),
                                    ("pallas", 65_536 * 2)])
def test_protect_unprotect_match_reference(monkeypatch, mode, n):
    """`_protect` (rows, scales, parity) and `_unprotect` bitwise equal to
    the reference's under jit, in its ref mode and its Pallas mode
    (interpret); the Pallas mode's tile padding is invisible at a length
    that is a multiple of its 65,536-value tile."""
    monkeypatch.setenv("REPRO_UNO_KERNELS", mode)
    run = RB.RunConfig()
    x = _grads(n, n)
    rows, scales, parity, n0 = jax.jit(RU._protect, static_argnums=1)(
        jnp.asarray(x), run)
    t_rows, t_scales, t_parity, t_n0 = TU._protect(torch.from_numpy(x),
                                                   TB.RunConfig())
    assert t_n0 == int(n0) == n
    _eq(t_rows, rows, "rows")
    _eq(t_scales, scales, "scales")
    _eq(t_parity, parity, "parity")
    out = jax.jit(RU._unprotect, static_argnums=(3, 4))(rows, scales,
                                                        parity, n, run)
    t_out = TU._unprotect(t_rows, t_scales, t_parity, t_n0, TB.RunConfig())
    _eq(t_out, out, "unprotect")
    plain = TU._unprotect(*TU._protect(torch.from_numpy(x), TB.RunConfig(),
                                       backend="plain"), TB.RunConfig(),
                          backend="plain")
    _eq(plain, out, "plain backend")


# ------------------------------------------------ configs and params

def test_configs_match_reference():
    assert TR.ARCH_IDS == RR.ARCH_IDS
    for arch in RR.ARCH_IDS:
        want, got = RR.get_config(arch), TR.get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert dataclasses.asdict(TB.reduced(got)) == \
            dataclasses.asdict(RB.reduced(want)), arch
        assert got.pdtype() == torch.bfloat16 and got.cdtype() == \
            torch.bfloat16
        for shape in RB.SHAPES.values():
            assert TR.cell_supported(got, TB.SHAPES[shape.name]) == \
                RR.cell_supported(want, shape)
    assert dataclasses.asdict(TB.RunConfig()) == \
        dataclasses.asdict(RB.RunConfig())
    with pytest.raises(KeyError):
        TR.get_config("nope")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}['{k}']")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_param_defs_match_reference(arch):
    """Shapes, dtypes and leaf order (JAX's: dict keys sorted at every
    level) equal `repro.models.abstract_params`; nothing is allocated."""
    want = jax.tree_util.tree_flatten_with_path(
        RM.abstract_params(RR.get_config(arch)))[0]
    defs = TP.param_defs(TR.get_config(arch))
    leaves, _ = TP.flatten(defs)
    got = list(_paths(defs))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert [d for _, d in got] == leaves
    for (_, d), (_, w) in zip(got, want):
        assert d.shape == w.shape
        assert str(d.dtype).removeprefix("torch.") == str(w.dtype)
    assert TP.param_count(defs) == sum(int(np.prod(w.shape))
                                       for _, w in want)
    if arch == "smollm-135m":
        assert TP.param_count(defs) == 134_515_008
    if arch == "mamba2-130m":
        assert TP.param_count(defs) == 128_835_456


def test_param_defs_other_families_raise():
    """Beyond the dense family every tree builds (ROADMAP item 9b); its
    float32 leaves, which the sync's flat vector carries beside the bf16
    ones, are the reference's: the MoE router, the SSM's dt_bias, A_log
    and D."""
    for arch in RR.ARCH_IDS:
        if arch in DENSE:
            continue
        want = [jax.tree_util.keystr(p) for p, w in
                jax.tree_util.tree_flatten_with_path(RM.abstract_params(
                    RR.get_config(arch)))[0] if w.dtype == jnp.float32]
        got = [p for p, d in _paths(TP.param_defs(TR.get_config(arch)))
               if d.dtype == torch.float32]
        assert got == want and got, arch
        assert {p.split("['")[-1] for p in got} <= {
            "router']", "dt_bias']", "A_log']", "D']"}, arch


def test_tree_from_arrays_round_trips_bf16():
    cfg = RB.reduced(RR.get_config("smollm-135m"))
    rng = np.random.default_rng(2)
    tree = jax.tree.map(
        lambda l: np.asarray(jnp.asarray(rng.normal(size=l.shape).astype(
            np.float32)).astype(l.dtype)), RM.abstract_params(cfg))
    tree["final_norm"] = tree["final_norm"].astype(np.float32)
    port = TP.tree_from_arrays(tree, "cpu")
    assert port["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert port["final_norm"].dtype == torch.float32
    back = TP.tree_to_arrays(port)
    for (pa, a), (pb, b) in zip(_paths(tree), _paths(back)):
        assert pa == pb and a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), pa
    w = np.asarray(tree["lm_head"]).astype(np.float32)
    _eq(port["lm_head"].float(), w, "bf16 values")


# ------------------------------------------- the sync against the reference

_REF_SYNC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import models
from repro.configs.base import RunConfig, reduced
from repro.configs.registry import get_config
from repro.core.uno_collectives import make_uno_grad_sync, _pod_ring_psum
from repro.sharding import set_mesh, shard_map
cfg = reduced(get_config("smollm-135m"))
run = RunConfig(uno_chunks=2)
res = {}
for p in (2, 4):
    rng = np.random.default_rng(p)
    stacked = jax.tree.map(lambda l: jnp.asarray((rng.normal(
        size=(p,) + l.shape) * 1e-3).astype(np.float32)).astype(l.dtype),
        models.abstract_params(cfg))
    mesh = jax.make_mesh((p,), ("pod",), devices=jax.devices()[:p])
    with set_mesh(mesh):
        out = jax.jit(make_uno_grad_sync(mesh, cfg, run))(stacked)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(stacked),
                                   jax.tree.leaves(out))):
        res[f"p{p}_in_{i}"] = np.asarray(a).view(np.uint16)
        res[f"p{p}_out_{i}"] = np.asarray(b).view(np.uint16)
        shards = sorted(b.addressable_shards, key=lambda s: s.device.id)
        for j, s in enumerate(shards):
            res[f"p{p}_pod{j}_{i}"] = np.asarray(s.data).view(np.uint16)
p = 3
x = (np.random.default_rng(3).normal(size=(p, 90_432)) * 1e-3).astype(
    np.float32)
mesh = jax.make_mesh((p,), ("pod",), devices=jax.devices()[:p])
f = shard_map(lambda v: _pod_ring_psum(v[0], run, p)[None], mesh=mesh,
              in_specs=P("pod"), out_specs=P("pod"), axis_names={"pod"},
              check_vma=False)
with set_mesh(mesh):
    res["p3_out"] = np.asarray(jax.jit(f)(jnp.asarray(x)))
res["p3_in"] = x
np.savez(sys.argv[1], **res)
print("ok")
"""


@pytest.fixture(scope="module")
def ref_sync(tmp_path_factory):
    """The reference's `make_uno_grad_sync` (leaf_local) on a ("pod",) mesh
    of reduced smollm-135m grads with RunConfig(uno_chunks=2) at p = 2 and
    4, and its `_pod_ring_psum` under shard_map at p = 3 (three of the
    four devices), every pod's copy of each output; one subprocess."""
    path = tmp_path_factory.mktemp("uno_ref") / "ref.npz"
    out = subprocess.run([sys.executable, "-c", _REF_SYNC, str(path)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def _bf16(a):
    return a.view(ml_dtypes.bfloat16)


@pytest.mark.parametrize("p", [2, 4])
def test_uno_sync_matches_reference(ref_sync, p):
    """The port's CPU `uno_sync` on the reference's own bf16 inputs
    (carried across by `tree_from_arrays`) returns bitwise the
    reference's output (pod 0's copy, the one its replicated output
    reads), and `_pod_ring_psum` bitwise every pod's copy."""
    cfg = TB.reduced(TR.get_config("smollm-135m"))
    run = TB.RunConfig(uno_chunks=2)
    _, treedef = TP.flatten(TP.param_defs(cfg))
    n = len(TP.flatten(TP.param_defs(cfg))[0])
    stacked = TP.tree_from_arrays(TP.unflatten(
        treedef, [_bf16(ref_sync[f"p{p}_in_{i}"]) for i in range(n)]), "cpu")
    out = TU.make_uno_grad_sync(cfg, run, p, device="cpu")(stacked)
    for i, leaf in enumerate(TP.flatten(TP.tree_to_arrays(out))[0]):
        assert leaf.dtype == ml_dtypes.bfloat16
        _eq(leaf.view(np.uint16), ref_sync[f"p{p}_out_{i}"], f"leaf {i}")
    flat, meta = TU._flatten(stacked, p)
    every = TU._pod_ring_psum(flat, run, p)
    for j in range(p):
        pod = TP.flatten(TU._unflatten(every[j], meta))[0]
        for i, leaf in enumerate(pod):
            _eq(leaf.view(torch.int16).numpy().view(np.uint16),
                ref_sync[f"p{p}_pod{j}_{i}"], f"pod {j} leaf {i}")


def test_pod_ring_psum_three_pods_matches_reference(ref_sync):
    """p = 3: the ring with an uneven split (each 47,104-value chunk pads
    to 47,106 = 3 x 15,702, each part to 15,872 for the quant blocks),
    every pod's copy bitwise.  The reference's `/ 3` is a multiply by
    f32(1/3) under jit; a true division would differ in the last bit."""
    run = TB.RunConfig(uno_chunks=2)
    x = torch.from_numpy(ref_sync["p3_in"])
    got = TU._pod_ring_psum(x, run, 3)
    _eq(got, ref_sync["p3_out"], "p3")
    plain = TU._pod_ring_psum(x, run, 3, backend="plain")
    _eq(plain, ref_sync["p3_out"], "p3 plain backend")
    mean = ref_sync["p3_in"].astype(np.float64).mean(axis=0)
    assert np.abs(got.numpy() - mean).max() <= 0.05 * np.abs(mean).max()


# ------------------------------------------------------- the device rule

def test_uno_sync_device_rule_and_plain_backend():
    """CPU leaves run the plain versions (no launch counted); p = 1 returns
    pod 0's gradients untouched; leaves on another device, a missing pod
    axis or an unknown backend raise."""
    cfg = TB.reduced(TR.get_config("smollm-135m"), n_layers=1)
    run = TB.RunConfig(uno_chunks=3)
    g = torch.Generator().manual_seed(0)
    for p in (1, 2, 3):
        stacked = {k: (torch.randn((p, *d.shape), generator=g) * 1e-3
                       ).to(d.dtype)
                   for k, d in zip("abcdefghijk",
                                   TP.flatten(TP.param_defs(cfg))[0])}
        unorc_cuda.reset_launches()
        out = TU.make_uno_grad_sync(cfg, run, p, device="cpu")(stacked)
        plain = TU.make_uno_grad_sync(cfg, run, p, device="cpu",
                                      backend="plain")(stacked)
        assert not unorc_cuda.LAUNCHES
        for k, v in out.items():
            assert v.dtype == stacked[k].dtype
            assert v.shape == stacked[k].shape[1:]
            assert torch.equal(v, plain[k])
            if p == 1:
                assert torch.equal(v, stacked[k][0])
            mean = stacked[k].double().mean(0)
            assert float((v.double() - mean).abs().max()) <= \
                0.05 * float(mean.abs().max()) + 1e-6
    bad = {"w": torch.zeros(3, 256)}
    with pytest.raises(ValueError, match="pod axis"):
        TU.make_uno_grad_sync(cfg, run, 2, device="cpu")(bad)
    with pytest.raises(ValueError, match="meta"):
        TU.make_uno_grad_sync(cfg, run, 3, device="cpu")(
            {"w": torch.zeros(3, 256, device="meta")})
    with pytest.raises(ValueError, match="backend"):
        TU.make_uno_grad_sync(cfg, run, 2, device="cpu", backend="pallas")


def test_unorc_wrappers_reject_bad_operands():
    with pytest.raises(TypeError):
        unorc_cuda.gf_matmul(torch.zeros((8, 16), dtype=torch.int32),
                             RG.rs_generator_rows(8, 2))
    with pytest.raises(ValueError, match="K=8"):
        unorc_cuda.gf_matmul(torch.zeros((8, 16), dtype=torch.uint8),
                             ((1, 2),))
    with pytest.raises(ValueError, match="M <= 4"):
        unorc_cuda.gf_matmul(torch.zeros((2, 16), dtype=torch.uint8),
                             ((1, 1),) * 5)
    with pytest.raises(ValueError, match="bytes"):
        unorc_cuda.gf_matmul(torch.zeros((2, 16), dtype=torch.uint8),
                             ((1, 256),))
    with pytest.raises(ValueError, match="contiguous"):
        unorc_cuda.gf_matmul(torch.zeros((8, 32), dtype=torch.uint8)[:, ::2],
                             RG.rs_generator_rows(8, 2))
    with pytest.raises(ValueError, match="multiple of 256"):
        unorc_cuda.quant_int8(torch.zeros(300))
    with pytest.raises(TypeError):
        unorc_cuda.quant_int8(torch.zeros(256, dtype=torch.float64))
    with pytest.raises(ValueError, match="blocks"):
        unorc_cuda.dequant_int8(torch.zeros(512, dtype=torch.int8),
                                torch.ones(1))
    with pytest.raises(ValueError, match="acc"):
        unorc_cuda.dequant_int8(torch.zeros(256, dtype=torch.int8),
                                torch.ones(1), torch.zeros(255))
    with pytest.raises(ValueError, match="devices"):
        unorc_cuda.dequant_int8(torch.zeros(256, dtype=torch.int8),
                                torch.ones(1, device="meta"))
    # meta tensors take the custom ops' fakes (the dry run); the fleet
    # kernels' device rule still refuses them
    q, s = unorc_cuda.quant_int8(torch.zeros(256, device="meta"))
    assert q.device.type == "meta" and q.dtype == torch.int8
    with pytest.raises(ValueError, match="unsupported device"):
        fleet_cuda._on_cuda(torch.zeros(256, device="meta"))
