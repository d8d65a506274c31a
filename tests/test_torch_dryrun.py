"""The port's cost and roofline tools (`repro_torch.launch.op_costs`,
`.roofline`, `.dryrun`, `.roofline_report`) against the reference's
(`repro.launch.hlo_costs`, `.hlo_analysis`, `.dryrun`).

  * `analytic_model_flops` equals the reference's with ``==`` on all 10
    archs x 4 shapes, and the param counts and bytes equal its
    ``models.api`` figures (the reference's dryrun module forces 512 host
    devices when imported, so it runs in one subprocess);
  * `roofline_terms` with the reference's V5E constants equals the
    reference's to 1 ulp on a grid; the H100's per-dtype pricing;
  * flops against the reference's HLO cost model on reduced smollm,
    mamba2, qwen3-moe and jamba at B = 2, S = 64: prefill and decode
    exact; the baseline train step equal product for product once each
    named difference is taken out at its exact size (`train_gaps`);
  * bytes and memory on a hand-built sequence, exact;
  * the baseline step on meta and on the CPU: the same ops, flops and
    bytes but for the CPU's float64 sqrt in AdamW, at its exact size;
  * the Uno step at 2 pods on meta: K3-K5 as custom ops with the counts
    the card's LAUNCHES records, no plain-version op, the DCI frames
    (`uno_collectives.wire_bytes`);
    on CPU tensors the same step runs the plain versions;
  * the CLI, the record schema, the reference's skip reasons, one
    full-size cell and the report."""
import json
import math
import re
import subprocess
import sys
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as RM  # noqa: E402
from repro import train as RT  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.configs import registry as RR  # noqa: E402
from repro.launch import hlo_analysis, hlo_costs  # noqa: E402

from repro_torch import models as TM  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch import train as TT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.core import uno_collectives as TU  # noqa: E402
from repro_torch.kernels import ref as TK  # noqa: E402
from repro_torch.kernels import unorc_cuda  # noqa: E402
from repro_torch.launch import dryrun, op_costs, roofline  # noqa: E402
from repro_torch.launch import roofline_report  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode, flop_registry  # noqa: E402

B, S = 2, 64
FAMILIES = ("smollm-135m", "mamba2-130m", "qwen3-moe-235b-a22b",
            "jamba-1.5-large-398b")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------- analytic model flops

_REF_SCRIPT = r"""
import json
from repro.launch import dryrun
from repro.configs.base import SHAPES
from repro.configs.registry import ARCH_IDS, get_config
from repro.models import api
out = {}
for a in ARCH_IDS:
    cfg = get_config(a)
    defs = dryrun.models.param_defs(cfg)
    out[a] = {"flops": {s: repr(dryrun.analytic_model_flops(cfg, SHAPES[s]))
                        for s in SHAPES},
              "count": api.param_count(defs), "bytes": api.param_bytes(defs)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_cells():
    """The reference dryrun module's figures for every cell, from a
    subprocess (it sets XLA_FLAGS to 512 devices when imported)."""
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_analytic_model_flops_and_params_equal_the_reference(reference_cells):
    assert sorted(reference_cells) == sorted(TR.ARCH_IDS)
    for arch in TR.ARCH_IDS:
        cfg = TR.get_config(arch)
        ref = reference_cells[arch]
        for name, shape in TB.SHAPES.items():
            got = dryrun.analytic_model_flops(cfg, shape)
            assert got == float(ref["flops"][name]), (arch, name)
            assert type(got) is type(eval(ref["flops"][name])), (arch, name)
        defs = TM.param_defs(cfg)
        assert TP.param_count(defs) == ref["count"], arch
        assert TP.param_bytes(defs) == ref["bytes"], arch


# ------------------------------------------------------------ roofline

def test_roofline_terms_equal_the_reference_with_its_chip():
    for flops in (0.0, 1.0, 3.3e9, 7.77e14, 1.944486313721856e15, 2.9e18):
        for hbm in (0.0, 12.0, 5.5e9, 2.445e14, 9.1e17):
            for coll in (0.0, 3.0e6, 1.7e11):
                for chips in (1, 256, 512):
                    want = hlo_analysis.roofline_terms(flops, hbm, coll,
                                                       chips)
                    got = roofline.roofline_terms(
                        flops, hbm, coll, chips, chip=hlo_analysis.V5E)
                    assert got["dominant"] == want["dominant"]
                    for k in ("t_compute_s", "t_memory_s", "t_collective_s"):
                        assert abs(got[k] - want[k]) <= math.ulp(want[k])


def test_h100_prices_each_dtype_at_its_peak():
    chip = roofline.H100_SXM
    assert chip["peak_by_dtype"] == {"bfloat16": 989e12, "float16": 989e12,
                                     "tf32": 495e12, "float32": 67e12}
    assert (chip["hbm_bw"], chip["hbm_bytes"]) == (3.35e12, 80e9)
    t = roofline.roofline_terms(2e12, 0.0, 0.0, 1, flops_by_dtype={
        "bfloat16": 989e12, "float32": 67e12})
    assert t["t_compute_s"] == 2.0 and t["dominant"] == "compute"
    one_peak = roofline.roofline_terms(989e12 + 67e12, 0.0, 0.0, 1)
    assert one_peak["t_compute_s"] == pytest.approx(1056 / 989)
    with pytest.raises(KeyError, match="float64"):
        roofline.roofline_terms(1.0, 0.0, 0.0, 1,
                                flops_by_dtype={"float64": 1.0})


# ------------------------------------------ flops against the HLO model

def _ref_steps(arch):
    """(train, prefill, decode) HLO texts of the reference's jitted steps
    on the reduced config."""
    cfg = RB.reduced(RR.get_config(arch))
    i32 = jax.ShapeDtypeStruct((), jnp.int32)
    state = RT.make_train_state(cfg, abstract=True)
    batch = RM.train_input_specs(cfg, RB.ShapeSpec("t", S, B, "train"))
    train = jax.jit(RT.make_train_step(cfg, RB.RunConfig())).lower(
        state, batch, i32).compile().as_text()
    params = RM.abstract_params(cfg)
    prefill = jax.jit(RT.make_prefill_step(cfg, S)).lower(
        params, RM.prefill_input_specs(cfg, RB.ShapeSpec("p", S, B,
                                                         "prefill"))
    ).compile().as_text()
    decode = jax.jit(RT.make_decode_step(cfg)).lower(
        params, RM.abstract_cache(cfg, B, S),
        RM.decode_input_specs(cfg, RB.ShapeSpec("d", S, B, "decode")),
        i32).compile().as_text()
    return train, prefill, decode


def _ref_products(text) -> Counter:
    """flops of each dot the HLO cost model counts -> times it runs (its
    loop multipliers applied), the multiset behind its `flops`."""
    comps = hlo_costs.parse_module(text)
    mult = hlo_costs._multipliers(comps)
    out = Counter()
    for comp in comps.values():
        m = mult.get(comp.name, 0.0)
        for op in comp.ops.values():
            if not m or op.kind != "dot":
                continue
            res = sum(n for _, n in hlo_costs._parse_shapes(op.result_type))
            lhs = comp.ops[op.operands[0]]
            dims = [int(d) for d in hlo_costs._SHAPE_RE.findall(
                lhs.result_type)[0][1].split(",") if d]
            cd = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", op.line)
            contract = math.prod(dims[int(c)] for c in cd.group(1).split(",")
                                 if c) if cd else 1
            out[2 * res * contract] += int(m)
    return out


class _Products(op_costs.CostMode):
    """CostMode that also keeps each counted product's flops."""

    def __init__(self):
        super().__init__()
        self.products = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func._overloadpacket in flop_registry and self.flops > before:
            self.products[self.flops - before] += 1
        return out


def _port_products(fn, *args):
    mode = _Products()
    with mode:
        fn(*args)
    return mode.products


def _port_steps(arch):
    cfg = TB.reduced(TR.get_config(arch))
    params = TM.abstract_params(cfg)
    state = {"params": params, "opt": TO.init_opt_state(params, cfg)}
    batch = TM.train_input_specs(cfg, TB.ShapeSpec("t", S, B, "train"))
    train = _port_products(
        TT.make_train_step(cfg, TB.RunConfig(), device="meta"), state,
        batch, 0)
    with torch.inference_mode():
        prefill = _port_products(
            TT.make_prefill_step(cfg, S), params,
            TM.prefill_input_specs(cfg, TB.ShapeSpec("p", S, B, "prefill")))
        decode = _port_products(
            TT.make_decode_step(cfg), params, TM.abstract_cache(cfg, B, S),
            TM.decode_input_specs(cfg, TB.ShapeSpec("d", S, B, "decode")),
            S - 1)
    return cfg, train, prefill, decode


def _total(products: Counter) -> int:
    return sum(k * v for k, v in products.items())


def train_gaps(cfg) -> Counter:
    """Port products minus reference products of the baseline train
    step at B x S on the reduced config, each named, at its exact size.

    1. The loss chunk's checkpoint recompute (`layers._xent_chunk`):
       with S <= 1,024 the loss runs one chunk, XLA's one-trip loop is
       inlined and the recomputed head product is CSE'd with the
       forward's; the port recomputes it.  One 2·T·d·V product.  (At two
       chunks the reference recomputes too: equal, see the test below.)
    2. The same at one KV block (S <= 1,024) inside a checkpointed layer
       (remat "full": qwen3-moe, jamba's attention layers): the block's
       score product, recomputed by the layer's recompute and again by
       the block's, once in the reference.  One 2·B·Hq·S·S·D product per
       attention layer.
    3. The SSD chunk body (`mamba2._chunk_body`, each chunk checkpointed
       inside a checkpointed layer), per SSM layer over its nc chunks:
       a. torch's checkpoint recomputes the body up to its last saved
          tensor, so it recomputes y_in (2·B·H·Q·Q·P) and contrib
          (2·B·H·N·Q·P), whose results no gradient reads; JAX's partial
          evaluation drops both from the inner recompute: +nc each;
       b. the reference's scan transposes every chunk alike: it computes
          the state gradient into chunk 0 (the zero initial state needs
          none) and both gradients through the last chunk's contrib
          (the final state feeds no loss); autograd skips the three:
          -3 contrib-sized products per layer;
       c. the reference's three-operand einsums keep two broadcast
          products (CB x seg, 2·B·Q·Q·H; and y_x's exp(cum) factor,
          2·B·Q·H·P) as dot_generals without a contracted dimension in
          its backward pass, which hlo_costs counts; the port multiplies
          elementwise, which no flop counter counts: -nc each.
    4. Muon's Newton–Schulz on a stacked leaf whose matrix has a size-1
       side (jamba's one-period stacks: (1, n) norms and vectors): both
       count X·Xᵀ (a vector dot in the reference), but XLA's simplifier
       turns A·A ((1,1)·(1,1)) and B·X ((1,1)·(1,n)) into multiplies
       that hlo_costs does not count: +5 of each per leaf (5 iterations).
    """
    gaps = Counter()
    T, d, V = B * S, cfg.d_model, cfg.vocab
    gaps[2 * T * d * V] += 1                                         # 1
    n_attn = {"dense": 0, "moe": cfg.n_layers, "ssm": 0,
              "hybrid": cfg.n_layers // max(cfg.attn_period, 1)}[cfg.family]
    if cfg.remat_policy == "full" and cfg.n_heads:
        gaps[2 * B * cfg.n_heads * S * S * cfg.head_dim] += n_attn   # 2
    n_ssm = {"ssm": cfg.n_layers,
             "hybrid": cfg.n_layers - n_attn}.get(cfg.family, 0)
    if n_ssm:
        Q = min(cfg.ssm_chunk, S)
        nc, H, N, P = S // Q, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        y_in, contrib = 2 * B * H * Q * Q * P, 2 * B * H * N * Q * P
        gaps[y_in] += n_ssm * nc                                     # 3a
        gaps[contrib] += n_ssm * nc - 3 * n_ssm                      # 3a, b
        gaps[2 * B * Q * Q * H] -= n_ssm * nc                        # 3c
        gaps[2 * B * Q * H * P] -= n_ssm * nc
    if cfg.optimizer == "muon":                                      # 4
        for path, leaf in TO.flatten_with_paths(TM.param_defs(cfg)).items():
            if path.startswith("layers/") and len(leaf.shape) >= 2 \
                    and min(leaf.shape[-2:]) == 1:
                batch = math.prod(leaf.shape[:-2])
                gaps[2 * batch] += 5
                gaps[2 * batch * max(leaf.shape[-2:])] += 5
    return gaps


@pytest.fixture(scope="module")
def flop_parity():
    return {a: (_ref_steps(a), _port_steps(a)) for a in FAMILIES}


@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_flops_equal_the_hlo_cost_model(flop_parity, arch):
    (_, ref_prefill, ref_decode), (_, _, prefill, decode) = flop_parity[arch]
    for text, port in ((ref_prefill, prefill), (ref_decode, decode)):
        assert _total(port) == hlo_costs.analyze(text)["flops"]
        assert port == _ref_products(text)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_flops_equal_the_hlo_cost_model_after_named_gaps(
        flop_parity, arch):
    (ref_train, _, _), (cfg, train, _, _) = flop_parity[arch]
    ref = _ref_products(ref_train)
    assert _total(ref) == hlo_costs.analyze(ref_train)["flops"]
    diff = Counter(train)
    diff.subtract(ref)
    diff = Counter({k: v for k, v in diff.items() if v})
    want = Counter({k: v for k, v in train_gaps(cfg).items() if v})
    assert diff == want, (arch, diff, want)
    assert _total(train) - _total(ref) == _total(want)


def test_loss_chunk_gap_closes_at_two_chunks():
    """Gap 1 of `train_gaps` is the one-trip loop: at S = 2,048 (two
    loss chunks, two KV blocks) the reference recomputes the head
    product too, and the two counts are equal."""
    seq, n = 2048, 1
    cfg = TB.reduced(TR.get_config("smollm-135m"))
    rcfg = RB.reduced(RR.get_config("smollm-135m"))
    text = jax.jit(RT.make_train_step(rcfg, RB.RunConfig())).lower(
        RT.make_train_state(rcfg, abstract=True),
        RM.train_input_specs(rcfg, RB.ShapeSpec("t", seq, n, "train")),
        jax.ShapeDtypeStruct((), jnp.int32)).compile().as_text()
    params = TM.abstract_params(cfg)
    state = {"params": params, "opt": TO.init_opt_state(params, cfg)}
    _, costs = op_costs.analyze(
        TT.make_train_step(cfg, TB.RunConfig(), device="meta"), state,
        TM.train_input_specs(cfg, TB.ShapeSpec("t", seq, n, "train")), 0)
    assert costs["flops"] == hlo_costs.analyze(text)["flops"]


def test_flops_agree_with_flop_counter_mode():
    cfg = TB.reduced(TR.get_config("qwen3-moe-235b-a22b"))
    state = TT.make_train_state(cfg, seed=0, device="cpu")
    batch = {"inputs": torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32),
             "targets": torch.randint(0, cfg.vocab, (B, S),
                                      dtype=torch.int32)}
    step = TT.make_train_step(cfg, TB.RunConfig(), device="cpu")
    with FlopCounterMode(display=False) as fc:
        step(state, batch, 0)
    _, costs = op_costs.analyze(step, state, batch, 0)
    assert costs["flops"] == fc.get_total_flops() > 0
    assert sum(costs["flops_by_dtype"].values()) == costs["flops"]


# ---------------------------------------------------- bytes and memory

def test_bytes_and_memory_of_a_hand_built_sequence():
    a, b = torch.ones(4, 8), torch.ones(8, 16)      # 128 + 512 bytes

    def f(a, b):
        c = a @ b                   # mm: 128 + 512 in, 256 out
        t = c + 1.0                 # add: 256 in, 256 out
        del c                       # a freed temporary
        v = t.view(-1)              # a view: no bytes
        return v * 2.0              # mul: 256 in, 256 out

    for dev in ("cpu", "meta"):
        out, c = op_costs.analyze(f, a.to(dev), b.to(dev))
        assert out.shape == (64,)
        assert c["flops"] == 2 * 4 * 8 * 16
        assert c["flops_by_dtype"] == {"float32": 1024.0}
        assert c["hbm_bytes"] == 896 + 512 + 512
        assert c["ops"] == {"aten::add.Tensor": 1, "aten::mm": 1,
                            "aten::mul.Tensor": 1, "aten::view": 1}
        assert c["argument_bytes"] == 640
        # live: args 640 + c 256 + t 256 = 1152; c freed before the mul
        assert c["peak_bytes"] == 1152 and c["temp_bytes"] == 512
        assert c["output_bytes"] == 256
        assert c["top_ops_by_bytes"][0] == ["aten::mm", 896]
        assert (c["collective_bytes"], c["collective_by_op"],
                c["collective_sites"]) == (0.0, {}, 0)


# --------------------------------------------- meta against the CPU

def _smollm_state(dev):
    cfg = TB.reduced(TR.get_config("smollm-135m"))
    if dev == "meta":
        params = TM.abstract_params(cfg)
        state = {"params": params, "opt": TO.init_opt_state(params, cfg)}
        batch = TM.train_input_specs(cfg, TB.ShapeSpec("t", S, 4, "train"))
    else:
        state = TT.make_train_state(cfg, seed=0, device="cpu")
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab, (4, S), generator=g,
                                  dtype=torch.int32)
                 for k in ("inputs", "targets")}
    return cfg, state, batch


def _sqrt_gap(cfg):
    """What the CPU's correctly rounded float32 sqrt (`optim._sqrt32`:
    through float64) adds to a step's trace per AdamW leaf of n values:
    two casts, and 8n bytes on the sqrt; 32n bytes in all."""
    n = [math.prod(d.shape) for d in TP.flatten(TM.param_defs(cfg))[0]]
    return Counter({"aten::_to_copy": 2 * len(n)}), 32 * sum(n)


@pytest.mark.parametrize("n_pods", [1, 2])
def test_step_on_meta_and_on_the_cpu_count_alike(n_pods):
    traces = {}
    calls = Counter()
    for dev in ("meta", "cpu"):
        cfg, state, batch = _smollm_state(dev)
        step = TT.make_train_step(cfg, TB.RunConfig(), n_pods=n_pods,
                                  device=dev)
        with _count_plain(calls, dev):
            traces[dev] = op_costs.analyze(step, state, batch, 0)[1]
    meta, cpu = traces["meta"], traces["cpu"]
    ops, n_bytes = _sqrt_gap(cfg)
    diff = Counter(cpu["ops"])
    diff.subtract(meta["ops"])
    assert +diff == ops and not -diff
    assert cpu["flops"] == meta["flops"] > 0
    assert cpu["flops_by_dtype"] == meta["flops_by_dtype"]
    assert cpu["hbm_bytes"] - meta["hbm_bytes"] == n_bytes
    assert cpu["kernel_launches"] == meta["kernel_launches"]
    if n_pods == 1:
        assert not meta["kernel_launches"] and not calls
        return
    # the Uno step: K3-K5 as custom ops, the launches the card records
    # (8 chunks, one protected send each at p = 2; PERF.md §6)
    want = {"quant_int8": 8, "gf_matmul/encode": 8, "gf_matmul/decode": 8,
            "dequant_int8/acc": 8}
    assert meta["kernel_launches"] == want
    for op, key in (("quant_int8", "quant_int8"),
                    ("gf_matmul", "gf_matmul/encode"),
                    ("dequant_int8", "dequant_int8/acc")):
        n = want[key] * (2 if op == "gf_matmul" else 1)
        assert meta["ops"][f"repro_torch::{op}"] == n
    # the meta trace reached no plain version; the CPU ran them
    assert calls["meta"] == 0
    assert calls["cpu"] == 32
    # the frames that crossed between pods, one pod's wire bytes a sync:
    # what `uno_collectives.wire_bytes` (the dry run's `dci_bytes`) gives
    frames = _Frames()
    cfg, state, batch = _smollm_state("meta")
    with frames:
        TT.make_train_step(cfg, TB.RunConfig(), n_pods=2,
                           device="meta")(state, batch, 0)
    n_params = TP.param_count(TM.param_defs(cfg))
    assert frames.roll_bytes / 2 == TU.wire_bytes(n_params, TB.RunConfig(),
                                                  2)


class _Frames(op_costs.CostMode):
    """CostMode that also sums the operand bytes of ``aten.roll``: on one
    card the Uno step moves each protected frame (int8 rows, scales, RS
    parity) from pod to pod with a roll along the pod axis."""

    def __init__(self):
        super().__init__()
        self.roll_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket is torch.ops.aten.roll:
            self.roll_bytes += args[0].numel() * args[0].element_size()
        return super().__torch_dispatch__(func, types, args, kwargs)


class _count_plain:
    """Counts the calls of K3-K5's plain versions (under `dev`)."""

    def __init__(self, calls, dev):
        self.calls, self.dev = calls, dev
        self.saved = {}

    def __enter__(self):
        for name in ("gf_matmul_ref", "quant_int8_ref", "dequant_int8_ref"):
            fn = self.saved[name] = getattr(TK, name)

            def wrapped(*a, _fn=fn, **kw):
                self.calls[self.dev] += 1
                return _fn(*a, **kw)
            setattr(TK, name, wrapped)

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(TK, name, fn)


def test_wire_bytes_follow_the_frames():
    run = TB.RunConfig()
    # one p = 2 chunk of smollm-135m: 16,816,128 values (PERF.md §4)
    n = 134_515_008
    chunk = 16_816_128
    assert TU.wire_bytes(n, run, 2) == 8 * (chunk + chunk // 8 * 2
                                            + 4 * chunk // 256)
    part = chunk // 4
    assert TU.wire_bytes(n, run, 4) == 8 * 6 * (part + part // 8 * 2
                                                + 4 * part // 256)


def test_custom_op_fakes_match_the_plain_versions():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 512, generator=g)
    q, s = unorc_cuda.quant_int8(x)
    out = unorc_cuda.dequant_int8(q, s, acc=x)
    data = torch.randint(0, 256, (2, 8, 40), generator=g, dtype=torch.uint8)
    par = unorc_cuda.gf_matmul(data, [[1, 2, 3, 4, 5, 6, 7, 8],
                                      [9, 8, 7, 6, 5, 4, 3, 2]])
    mq, ms = unorc_cuda.quant_int8(x.to("meta"))
    mout = unorc_cuda.dequant_int8(mq, ms, acc=x.to("meta"))
    mplain = unorc_cuda.dequant_int8(mq, ms)
    mpar = unorc_cuda.gf_matmul(data.to("meta"), [[1] * 8, [2] * 8],
                                use="decode")
    for cpu, meta in ((q, mq), (s, ms), (out, mout), (out, mplain),
                      (par, mpar)):
        assert meta.device.type == "meta"
        assert (meta.shape, meta.dtype) == (cpu.shape, cpu.dtype)
    assert not unorc_cuda.LAUNCHES
    assert unorc_cuda.launch_key("aten::mm", (), {}) is None


# ------------------------------------------------------ CLI and schema

REF_KEYS = {"arch", "shape", "multi_pod", "uno", "chips", "skipped",
            "costs", "model_flops", "param_bytes_total", "param_count",
            "roofline", "useful_flops_ratio", "temp_size_in_bytes",
            "argument_size_in_bytes", "output_size_in_bytes"}
REF_COST_KEYS = {"flops", "hbm_bytes", "collective_bytes",
                 "collective_by_op", "dci_bytes", "collective_sites"}


def test_skips_carry_the_reference_reasons():
    for arch in TR.ARCH_IDS:
        ref_ok, ref_why = RR.cell_supported(RR.get_config(arch),
                                            RB.SHAPES["long_500k"])
        rec = dryrun.cost_cell(arch, "long_500k") if not ref_ok else None
        if ref_ok:
            assert TR.get_config(arch).subquadratic
            continue
        assert rec["skipped"] and rec["reason"] == ref_why
        assert {"arch", "shape", "multi_pod", "skipped", "reason"} <= set(rec)
    with pytest.raises(ValueError, match="train cell"):
        dryrun.cost_cell("smollm-135m", "decode_32k", uno=True)


def test_full_size_decode_cell_and_the_report(tmp_path, capsys):
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "smollm-135m__decode_32k__card.json")
                     .read_text())
    assert REF_KEYS <= set(rec) and REF_COST_KEYS <= set(rec["costs"])
    assert rec["trace_s"] < 10
    assert (rec["multi_pod"], rec["uno"], rec["chips"], rec["skipped"]) == \
        (False, False, 1, False)
    cfg = TR.get_config("smollm-135m")
    shape = TB.SHAPES["decode_32k"]
    assert rec["model_flops"] == dryrun.analytic_model_flops(cfg, shape)
    c = rec["costs"]
    assert c["flops"] > 0 and c["hbm_bytes"] > 0 and c["dci_bytes"] == 0
    # the arguments are the params, the (B, S) KV cache and the (B, 1)
    # int32 tokens
    cache = TP.param_bytes(TM.cache_defs(cfg, shape.global_batch,
                                         shape.seq_len))
    assert rec["argument_size_in_bytes"] == \
        rec["param_bytes_total"] + cache + 4 * shape.global_batch
    assert rec["peak_bytes"] == rec["argument_size_in_bytes"] + \
        rec["temp_size_in_bytes"]
    assert rec["fits_one_card"] == (rec["peak_bytes"] <= 80e9)
    r = rec["roofline"]
    assert r == roofline.roofline_terms(
        c["flops"], c["hbm_bytes"], 0.0, 1,
        flops_by_dtype=c["flops_by_dtype"])
    assert r["dominant"] == "memory"
    assert rec["useful_flops_ratio"] == rec["model_flops"] / c["flops"]
    capsys.readouterr()
    roofline_report.main(["--dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "| smollm-135m | decode_32k |" in text
    assert "**memory**" in text and "hillclimb candidates" in text
    assert "cells costed: 1 (+1 documented skips)" in text
    frac = roofline_report.fraction(rec)
    assert frac == (rec["model_flops"] / 989e12) / max(
        r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                        "--multipod", "--out", str(tmp_path)]) == 0
    multi = json.loads((tmp_path / "smollm-135m__decode_32k__multipod.json")
                       .read_text())
    assert multi["multi_pod"] is True and multi["chips"] == 512
    assert set(multi["collectives"]) >= {"total_bytes", "by_op",
                                         "dci_bytes", "count"}
