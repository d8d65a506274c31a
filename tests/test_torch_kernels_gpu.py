"""K2 (the fleet link -> flow gathers), K3 (the UnoRC GF(2^8) product)
and K5 (the UnoRC dequant) on the card, against their plain versions,
bitwise; K1 / K2 flat at the shapes of a sweep grid (8 x 100k-flow
dumbbells as one block-diagonal net); and K6, K1 stage 1 and the
PathTable gathers at shard 0 of the sharded grid (two k=8, 100k-flow fat
trees under cell 0's plan lifted to the grid); the reliability kernel
(`rel_epoch`) bitwise `reliability.rel_step`'s plain version in its three
ladder forms, at both benchmark cells' shapes, at shard 0 of the sharded
fault grid and on 3 to 8 paths; UnoLB's split update kernel
(`fleet_cuda.LbUpdate`) bitwise `cc.lb_update_plain` on 1 to 8 paths, at
wan_derate16's LB tables, and as the LB phase of a fat tree's step.

This file imports no JAX, so that it runs on the machine with the card:

    python3 -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Every test is marked `gpu` and skips without a CUDA device.  K2 is held
at unrolled hop counts and on the runtime loop, over a link table small
enough for L1 and one that lives in L2; K3 at every M and K from 1 to
16, on its 16-byte path and its byte path; K5 at block counts on either
side of its per-warp span, both uses; K3-K5 as the custom ops
``torch.ops.repro_torch.*`` at one p = 2 chunk, with their fakes.  The
CPU tests
(test_torch_gathers.py, test_torch_unorc.py, test_torch_gf.py) hold the
plain versions, and K3's arithmetic, against the JAX reference.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lb_cases as LC  # noqa: E402
import rel_cases as RC  # noqa: E402
from repro_torch.fleetsim import cc as TC  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402
from repro_torch.fleetsim import reliability as TR  # noqa: E402
from repro_torch.fleetsim import shard as TSH  # noqa: E402
from repro_torch.kernels import fleet_cuda, unorc_cuda  # noqa: E402
from repro_torch.kernels import ref as TK  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _no_sync(fn):
    """fn() with any host sync an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{what} output {i}"


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1, 2, 5, 9, 16, 17])
@pytest.mark.parametrize("n_links", [50, 60_000])
def test_gathers_match_plain_versions_on_card(dev, h, n_links):
    """Flat K2 and the PathTable kernel: bitwise equal to the plain
    versions for unrolled hop counts and the runtime loop (h = 17);
    scratch-only rows read the identity; two runs equal; no host sync."""
    rng = np.random.default_rng(h * 131 + n_links)
    idx = rng.integers(0, n_links + 1, (3001, 1, h)).astype(np.int32)
    idx[:400] = n_links                              # scratch-only rows
    idx = torch.from_numpy(idx).to(dev)
    vals = [torch.from_numpy(v.astype(np.float32)).to(dev) for v in (
        rng.uniform(0.05, 1.0, n_links), rng.uniform(0.9, 1.0, n_links),
        rng.uniform(0.0, 1e3, n_links))]
    got = _no_sync(lambda: fleet_cuda.link_gathers(idx, *vals))
    _equal(got, TK.link_gathers_ref(idx, *vals), "flat")
    _equal(fleet_cuda.link_gathers(idx, *vals), got, "flat twice")
    assert bool((got[0][:400] == 1.0).all() and (got[1][:400] == 0.0).all()
                and (got[2][:400] == 0.0).all())
    seg_idx = idx[:, 0].contiguous()
    ids = [torch.from_numpy(rng.integers(0, seg_idx.shape[0], (4099, 3))
                            .astype(np.int32)).to(dev) for _ in range(2)]
    pt = TL.PathTable(*ids, seg_idx, *(None,) * 4)
    got = _no_sync(lambda: fleet_cuda.path_table_gathers(pt, *vals))
    _equal(got, TK.pt_gathers_ref(*ids, seg_idx, *vals), "path table")
    _equal(fleet_cuda.path_table_gathers(pt, *vals), got, "path table twice")


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks", [1, 2, 3, 4, 5, 7, 9, 4099])
def test_dequant_matches_plain_version_on_card(dev, n_blocks):
    """K5, both uses, bitwise equal to the plain version at block counts
    on either side of the kernel's per-warp span (4 blocks), the
    addend's rows strided; no host sync."""
    rng = np.random.default_rng(n_blocks)
    n = 256 * n_blocks
    q = torch.from_numpy(rng.integers(-127, 128, (3, n)).astype(np.int8))
    s = torch.from_numpy((np.abs(rng.normal(size=(3, n_blocks))) * 1e-4
                          ).astype(np.float32))
    wide = torch.from_numpy((rng.normal(size=(3, n + 64)) * 1e-3
                             ).astype(np.float32))
    q, s, wide = q.to(dev), s.to(dev), wide.to(dev)
    acc = wide[:, 32:32 + n]
    plain = _no_sync(lambda: unorc_cuda.dequant_int8(q, s))
    fused = _no_sync(lambda: unorc_cuda.dequant_int8(q, s, acc))
    assert torch.equal(plain, TK.dequant_int8_ref(q, s))
    assert torch.equal(fused, TK.dequant_int8_ref(q, s, acc=acc))


def _gf_coeffs(rng, m, k):
    c = rng.integers(0, 256, (m, k))
    c[rng.random((m, k)) < 0.2] = 0
    return tuple(map(tuple, c.tolist()))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 7, 8, 9, 16])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_gf_matmul_matches_plain_version_on_card(dev, m, k):
    """K3 bitwise equal to the plain version at every M and at K around
    the path's 8: on the 16-byte path (three groups, 4,097 columns), and
    on the byte path, at a width = 5 (mod 16) and on a view one byte past
    an aligned buffer; two runs equal; no host sync; one launch each."""
    rng = np.random.default_rng(10 * m + k)
    coeffs = _gf_coeffs(rng, m, k)
    start = unorc_cuda.LAUNCHES["gf_matmul/encode"]
    for width in (16 * 4097, 16 * 64 + 5):
        x = torch.from_numpy(rng.integers(0, 256, (3, k, width),
                                          dtype=np.uint8)).to(dev)
        got = _no_sync(lambda: unorc_cuda.gf_matmul(x, coeffs))
        assert got.shape == (3, m, width)
        assert torch.equal(got, TK.gf_matmul_ref(coeffs, x)), width
        assert torch.equal(unorc_cuda.gf_matmul(x, coeffs), got), width
    buf = torch.from_numpy(rng.integers(0, 256, 2 * k * 4096 + 1,
                                        dtype=np.uint8)).to(dev)
    x = buf[1:].view(2, k, 4096)
    assert x.is_contiguous() and x.data_ptr() % 16 == 1
    got = _no_sync(lambda: unorc_cuda.gf_matmul(x, coeffs))
    assert torch.equal(got, TK.gf_matmul_ref(coeffs, x)), "unaligned"
    assert unorc_cuda.LAUNCHES["gf_matmul/encode"] == start + 5


@pytest.mark.gpu
def test_gf_matmul_more_groups_than_the_grid_on_card(dev):
    """K3 over 70,000 groups, more than one grid row per group allows
    (65,535): the blocks loop over the rest, bitwise equal."""
    rng = np.random.default_rng(70_000)
    coeffs = _gf_coeffs(rng, 2, 8)
    x = torch.from_numpy(rng.integers(0, 256, (70_000, 8, 32),
                                      dtype=np.uint8)).to(dev)
    got = _no_sync(lambda: unorc_cuda.gf_matmul(x, coeffs, use="decode"))
    assert torch.equal(got, TK.gf_matmul_ref(coeffs, x))


P2_CHUNK = 16_816_128      # one p = 2 chunk of smollm-135m's gradient


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["quant_int8", "gf_matmul/encode",
                                "gf_matmul/decode", "dequant_int8",
                                "dequant_int8/acc"])
def test_custom_ops_match_plain_versions_and_fakes_on_card(dev, op):
    """K3-K5 called as ``torch.ops.repro_torch.*`` at one p = 2 chunk of
    smollm-135m's gradient (2 pods x 16,816,128 f32, 8 RS rows): bitwise
    the plain versions, one launch counted under the wrapper's key; the
    op's fake on meta copies of the operands gives the kernel's output
    shapes and dtypes."""
    from repro_torch.kernels import gf
    rng = np.random.default_rng(len(op))
    x = torch.from_numpy(rng.normal(size=(2, P2_CHUNK)).astype(np.float32)
                         * 1e-3).to(dev)
    q, s = TK.quant_int8_ref(x)
    rows = q.view(torch.uint8).reshape(2, 8, -1)
    survivors = torch.cat([rows[:, 2:], TK.rs_encode_ref(rows, 2)], dim=1)
    decode = gf.rs_decode_matrix(8, 2, (0, 1), (0, 1))
    encode = gf.rs_generator_rows(8, 2)
    flat = lambda c: [int(v) for r in c for v in r]  # noqa: E731
    calls = {
        "quant_int8": (torch.ops.repro_torch.quant_int8, (x,),
                       lambda: TK.quant_int8_ref(x)),
        "gf_matmul/encode": (torch.ops.repro_torch.gf_matmul,
                             (rows, flat(encode), 2, "encode"),
                             lambda: TK.gf_matmul_ref(encode, rows)),
        "gf_matmul/decode": (torch.ops.repro_torch.gf_matmul,
                             (survivors, flat(decode), 2, "decode"),
                             lambda: TK.gf_matmul_ref(decode, survivors)),
        "dequant_int8": (torch.ops.repro_torch.dequant_int8, (q, s, None),
                         lambda: TK.dequant_int8_ref(q, s)),
        "dequant_int8/acc": (torch.ops.repro_torch.dequant_int8, (q, s, x),
                             lambda: TK.dequant_int8_ref(q, s, acc=x)),
    }
    fn, args, plain = calls[op]
    start = unorc_cuda.LAUNCHES[op]
    got = _no_sync(lambda: fn(*args))
    assert unorc_cuda.LAUNCHES[op] == start + 1
    want = plain()
    got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    _equal(got, want, op)
    meta = fn(*(a.to("meta") if torch.is_tensor(a) else a for a in args))
    meta = (meta,) if torch.is_tensor(meta) else meta
    for m, g in zip(meta, got):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (g.shape, g.dtype), op
    assert unorc_cuda.LAUNCHES[op] == start + 1


@pytest.fixture(scope="module")
def fault_grid_net():
    """The block-diagonal net of the fault sweep's grid: 8 cells of the
    lossy 100k-flow dumbbell (`sweeps.stack_scenarios`), 800,000 flows
    over 800,016 links."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.fleetsim import sweeps
    from repro_torch.scenarios import dumbbell_scenario, to_fleetsim
    fs = to_fleetsim(dumbbell_scenario(
        0, 100_000, qcap=64 * 1024, phantom=False, red_lo_frac=0.85,
        red_hi_frac=0.98), device="cuda")
    return sweeps.stack_scenarios([fs] * 8).net


@pytest.mark.gpu
def test_grid_k1_k2_flat_match_plain_versions_on_card(fault_grid_net):
    """K1 and K2 flat at the grid's shapes (8 segments of 100,000 entries
    on the bottlenecks in one CSR): K1 within 1e-6 per link of the
    float64 plain sum and bitwise the tiled plain version on integer
    values, K2 bitwise its plain version; two runs equal; no host sync."""
    net = fault_grid_net
    lay, nl = net.layout, net.n_links
    dev = net.device
    counts = lay.link_ptr[1:nl + 1] - lay.link_ptr[:nl]
    assert int((counts >= 100_000).sum()) >= 8
    n, p, _ = lay.pad_idx.shape
    g = torch.Generator(device=dev).manual_seed(8)
    rates = torch.rand(n, device=dev, generator=g) * 12.5
    split = TL.normalize_split(torch.rand(n, p, device=dev, generator=g),
                               lay.path_mask)
    sub = rates[:, None] * split
    csr = (lay.sort_sub, lay.link_ptr)
    got = _no_sync(lambda: fleet_cuda.link_scatter(lay.pad_idx, sub, nl,
                                                   csr=csr))
    assert torch.equal(fleet_cuda.link_scatter(lay.pad_idx, sub, nl,
                                               csr=csr), got)
    truth = TK.fleet_offered_load_ref(TL._routes3(net), rates.double(),
                                      split.double(), nl)[:nl]
    nz = truth != 0
    assert bool((got[:nl][~nz] == 0).all())
    rel = (got[:nl][nz].double() - truth[nz]).abs() / truth[nz].abs()
    assert float(rel.max()) <= 1e-6
    v_int = torch.randint(0, 16, (n * p + 1,), generator=g, device=dev,
                          dtype=torch.int32).float()
    v_int[-1] = 0.0
    assert torch.equal(
        fleet_cuda.segment_sum(v_int, lay.sort_sub, lay.link_ptr),
        TK.csr_segment_sum_tiled_ref(v_int, lay.sort_sub, lay.link_ptr))
    vals = (0.05 + 0.95 * torch.rand(nl, device=dev, generator=g),
            1.0 - 0.05 * torch.rand(nl, device=dev, generator=g),
            1_000.0 * torch.rand(nl, device=dev, generator=g))
    out = _no_sync(lambda: fleet_cuda.link_gathers(lay.pad_idx, *vals))
    _equal(out, TK.link_gathers_ref(lay.pad_idx, *vals), "K2 at the grid")
    _equal(fleet_cuda.link_gathers(lay.pad_idx, *vals), out, "K2 twice")


@pytest.fixture(scope="module")
def fat_tree_grid_shard():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return lifted_grid_shard()


def lifted_grid_shard():
    """Shard 0 of the sharded drain what-if grid: two cells of the k=8,
    100k-flow fat tree on 2 shards under cell 0's plan lifted to the grid
    (`sweeps.shard_grid`), its PathTable and its boundary count."""
    from repro_torch.fleetsim import sweeps
    from repro_torch.scenarios import fat_tree_spec, to_fleetsim
    fs = to_fleetsim(fat_tree_spec(k=8, n_wan=8, n_flows=100_000,
                                   n_paths=8, seed=1), device="cuda")
    cells = [fs, fs._replace(net=fs.net._replace(drain=fs.net.drain * 0.9))]
    sf = sweeps.shard_grid(sweeps.stack_scenarios(cells, layout=False),
                           n_shards=2, link_tier=fs.link_tier)
    net = sf.shard_net(0)
    assert net.layout.path_table is not None
    return net, sf.plan.n_boundary


def _grid_sub(net, seed):
    lay = net.layout
    n, p, _ = lay.pad_idx.shape
    g = torch.Generator(device=net.device).manual_seed(seed)
    rates = torch.rand(n, device=net.device, generator=g) * 12.5
    split = TL.normalize_split(torch.rand(n, p, device=net.device,
                                          generator=g), lay.path_mask)
    return fleet_cuda.sub_vals_ext(rates[:, None] * split), g


@pytest.mark.gpu
def test_lifted_grid_k6_matches_plain_versions_on_card(fat_tree_grid_shard):
    """K6 at the lifted grid's shard (boundary = 2 x the cell's): the
    flat CSR and PathTable stage 2, each tile pair within 1e-6 per link
    of the float64 plain sum and bitwise K1 on the same CSR, bitwise the
    tiled plain version on integer values; two runs equal; no host
    sync."""
    net, halo = fat_tree_grid_shard
    lay, pt = net.layout, net.layout.path_table
    assert 0 < halo < net.n_links and halo % 2 == 0
    vals, g = _grid_sub(net, 19)
    seg = fleet_cuda.path_rates(pt, vals[:-1].reshape(lay.path_mask.shape))
    for use, gather, ptr, v in (
            ("flat", lay.sort_sub, lay.link_ptr, vals),
            ("pt_stage2", pt.lcsr_gather.reshape(-1), pt.llink_ptr, seg)):
        priv, bnd = _no_sync(lambda: fleet_cuda.segment_sum_tiles(
            v, gather, ptr, halo, use=use))
        k1 = fleet_cuda.segment_sum(v, gather, ptr, use=use)
        k = ptr.shape[0] - 2
        got = torch.cat([priv, bnd])
        truth = TK.csr_segment_sum_ref(v.double(), gather, ptr)[:k]
        nz = truth != 0
        assert bool((got[:k][~nz] == 0).all()), use
        assert float(((got[:k][nz].double() - truth[nz]).abs()
                      / truth[nz].abs()).max()) <= 1e-6, use
        assert float(bnd[-1]) == 0.0, use
        assert torch.equal(got[:k], k1[:k]), use
        again = fleet_cuda.segment_sum_tiles(v, gather, ptr, halo, use=use)
        assert torch.equal(torch.cat(again), got), use
        v_int = torch.randint(0, 16, v.shape, generator=g, device=v.device,
                              dtype=torch.int32).float()
        assert torch.equal(
            torch.cat(fleet_cuda.segment_sum_tiles(v_int, gather, ptr,
                                                   halo, use=use)),
            TK.csr_segment_sum_tiled_ref(v_int, gather, ptr)), use


@pytest.mark.gpu
def test_lifted_grid_k1_pt_gathers_match_plain_versions_on_card(
        fat_tree_grid_shard):
    """K1 stage 1 within 1e-6 per segment of the float64 plain sum and
    bitwise the tiled plain version on integer values; `uno_pt_gathers`
    bitwise its plain version; two runs equal; no host sync."""
    net, _ = fat_tree_grid_shard
    pt = net.layout.path_table
    vals, g = _grid_sub(net, 23)
    gather = pt.seg_gather.reshape(-1)
    got = _no_sync(lambda: fleet_cuda.segment_sum(vals, gather, pt.seg_ptr,
                                                  use="pt_stage1"))
    k = pt.seg_ptr.shape[0] - 2
    truth = TK.csr_segment_sum_ref(vals.double(), gather, pt.seg_ptr)[:k]
    nz = truth != 0
    assert bool((got[:k][~nz] == 0).all())
    assert float(((got[:k][nz].double() - truth[nz]).abs()
                  / truth[nz].abs()).max()) <= 1e-6
    assert torch.equal(fleet_cuda.segment_sum(vals, gather, pt.seg_ptr,
                                              use="pt_stage1"), got)
    v_int = torch.randint(0, 16, vals.shape, generator=g, device=vals.device,
                          dtype=torch.int32).float()
    assert torch.equal(
        fleet_cuda.segment_sum(v_int, gather, pt.seg_ptr, use="pt_stage1"),
        TK.csr_segment_sum_tiled_ref(v_int, gather, pt.seg_ptr))
    nl = net.n_links
    link_vals = (0.05 + 0.95 * torch.rand(nl, device=vals.device,
                                          generator=g),
                 1.0 - 0.05 * torch.rand(nl, device=vals.device, generator=g),
                 1_000.0 * torch.rand(nl, device=vals.device, generator=g))
    out = _no_sync(lambda: fleet_cuda.path_table_gathers(pt, *link_vals))
    _equal(out, TK.pt_gathers_ref(pt.pre_id, pt.suf_id, pt.seg_idx,
                                  *link_vals), "pt_gathers at the grid")
    _equal(fleet_cuda.path_table_gathers(pt, *link_vals), out,
           "pt_gathers twice")


# ---------------------------------------------------------------- rel_epoch

# name: (ladder form, paths, flows, cells[, static EC]); the two benchmark
# shapes, a flow count that leaves a 3-flow tail (its state rows
# unaligned: the kernel's one-flow-at-a-time access), 3, 4, 6 and 8
# paths a flow (each lane count of the kernel's path sum, one or two paths
# a lane), and the widest EC window, r = 16, whose last term shares a lane
REL_CASES = {
    "per_cell@fault_sweep128": ("per_cell", 1, 128 * 100_000, 128),
    "static@recovery_sweep64": ("static", 1, 64 * 100_000, 64),
    "shared:tail": ("shared", 1, 100_003, 1),
    "shared:4paths": ("shared", 4, 40_000, 1),
    "per_cell:4paths": ("per_cell", 4, 12 * 1_001, 12),
    "static:4paths:tail": ("static", 4, 9_999, 1),
    "static:3paths": ("static", 3, 30_000, 1),
    "per_cell:6paths": ("per_cell", 6, 12 * 2_000, 12),
    "shared:8paths": ("shared", 8, 20_000, 1),
    "static:r16": ("static", 1, 50_000, 1, (16, 16)),
}


def _rel_against_plain(args, got, what):
    """The kernel's (RelState', cut, goodput) against the plain version's
    on the same card inputs: every field of every flow bitwise equal, as
    the dynamics runs of chip_smoke.py need for a kernel backend and a
    plain one to take the same NACK and rung decisions (the kernel sums
    in torch.sum's order, fleet_kernels.cu).  A loss-free flow's
    recovered bytes stay exactly what they were."""
    rel, st, rate, rtx, split, sub_loss, sc, dt, rtt = args
    want = TR.rel_step(*args, plain=True)
    (new, cut, gp), (w_new, w_cut, w_gp) = got, want
    for f, g, w in [*zip(new._fields, new, w_new), ("cut", cut, w_cut),
                    ("goodput", gp, w_gp)]:
        if not torch.equal(g, w):
            g, w = g.double(), w.double()
            rel_err = float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
            pytest.fail(f"{what}: {f} differs on {int((g != w).sum())} of "
                        f"{g.numel()} flows, {rel_err:.3g} relative at most")
    lf = split[:, 0] * sub_loss[:, 0] if split.shape[1] == 1 else \
        torch.sum(split * sub_loss, dim=1)
    zero = lf == 0.0
    assert bool(zero.any()) and torch.equal(new.rec_bytes[zero],
                                            st.rec_bytes[zero]), what
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(REL_CASES))
def test_rel_epoch_matches_plain_version_on_card(dev, case):
    """The reliability kernel bitwise `rel_step`'s plain version on the
    same card inputs (`_rel_against_plain`), at the benchmark's shapes
    and on the edge rows of `rel_cases`; dt as a number refused; the
    state it was given is left bitwise as it was; one launch a call,
    counted under its form; no host sync; two runs bitwise equal."""
    form, n_paths, n, cells, *ec = REL_CASES[case]
    args = RC.rel_inputs(form, n_paths, n, cells, seed=n, device=dev,
                         **dict(zip(["ec"], ec)))
    st0 = type(args[1])(*(t.clone() for t in args[1]))
    key = "rel_epoch/" + ("static" if form == "static" else "ladder")
    before = fleet_cuda.LAUNCHES[key]
    got = _no_sync(lambda: TR.rel_step(*args))
    assert fleet_cuda.LAUNCHES[key] == before + 1
    _rel_against_plain(args, got, case)
    for f, a, b in zip(st0._fields, args[1], st0):
        assert torch.equal(a, b), f"{case}: input {f} written"
    again = TR.rel_step(*args)
    for a, b in zip((*got[0], *got[1:]), (*again[0], *again[1:])):
        assert torch.equal(a, b), case
    if form == "static":
        assert got[0].rung is args[1].rung
    # from the fresh state, whose fields share one zero tensor
    fresh = TR.init_rel_state(args[0])
    got = TR.rel_step(args[0], fresh, *args[2:])
    _rel_against_plain((args[0], fresh, *args[2:]), got, case + ":fresh")
    assert float(fresh.pending.abs().max()) == 0.0
    assert fresh.pending is fresh.lost_bytes
    # the kernel reads dt on the card: a number is refused, not rounded
    # otherwise than the plain version rounds it
    with pytest.raises(ValueError, match="dt"):
        TR.rel_step(*args[:7], float(args[7]), args[8])


@pytest.mark.gpu
def test_rel_epoch_matches_plain_version_at_a_grid_shard_on_card(dev):
    """Shard 0 of fault_sweep128's grid on two shards: each cell's flows
    dealt round-robin (a dumbbell flow's every hop is a hub), its rows
    cell-major and its last row a padding row (`shard._take_rel`), so
    the per-cell tables are read at 50,000 rows a cell."""
    n, cells = 128 * 100_000, 128
    args = RC.rel_inputs("per_cell", 1, n, cells, seed=5, device=dev)
    f = n // cells
    idx = (torch.arange(cells, device=dev)[:, None] * f +
           torch.arange(0, f, 2, device=dev)[None, :]).reshape(-1)
    real = torch.ones(idx.numel(), dtype=torch.bool, device=dev)
    real[f // 2 - 1::f // 2] = False
    rel = TSH._take_rel(args[0], idx, real)
    st = type(args[1])(*(t[idx] for t in args[1]))
    rest = [t[idx] if t.dim() else t for t in args[2:]]
    got = _no_sync(lambda: TR.rel_step(rel, st, *rest))
    _rel_against_plain((rel, st, *rest), got, "fault_sweep128:shard0")


# ------------------------------------------------------------- lb_update

LB_CASES = {   # name: (n_paths, flows)
    "1path:tail": (1, 100_003),
    "2paths": (2, 100_000),
    "3paths": (3, 50_001),
    "4paths": (4, 60_000),
    "6paths:tail": (6, 30_001),
    "8paths:tail": (8, 200_003),
}


def _lb_against_plain(args, got, what):
    """The kernel's (path_frac', split', bad_count') against the plain
    version's on the same card inputs: every slot bitwise equal (the
    kernel rounds each operation alone and sums in torch.sum's order,
    fleet_kernels.cu)."""
    want = TC.lb_update_plain(*args)
    for name, g, w in zip(("path_frac", "split", "bad_count"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        if not torch.equal(g, w):
            ulps = (g.view(torch.int32).long() - w.view(torch.int32).long())
            pytest.fail(f"{what}: {name} differs in {int((g != w).sum())} "
                        f"of {g.numel()} slots, {int(ulps.abs().max())} "
                        f"ulps at most")


def _lb_call(args, what):
    """One kernel call on `args` checked as `_lb_against_plain`, plus: one
    launch, no host sync, the inputs unwritten, two runs equal."""
    lb, fb, mask, *rows = args
    before = [t.clone() for t in (fb, mask, *rows, *lb)]
    step = fleet_cuda.LbUpdate(lb, fb, mask)
    launches = fleet_cuda.LAUNCHES["lb_update"]
    got = _no_sync(lambda: step(*rows))
    assert fleet_cuda.LAUNCHES["lb_update"] == launches + 1, what
    _lb_against_plain(args, got, what)
    for a, b in zip((fb, mask, *rows, *lb), before):
        assert torch.equal(a, b), f"{what}: an input was written"
    _equal(step(*rows), got, what + " twice")
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(LB_CASES))
def test_lb_update_matches_plain_version_on_card(dev, case):
    """UnoLB's split update kernel bitwise its plain version on 1 to 8
    path slots, on the edge rows of `lb_cases` (empty slots, marks on the
    threshold, repaths, zero-sum rows, exp underflow), with tails past
    the last full block."""
    p, n = LB_CASES[case]
    args = LC.lb_inputs(n, p, seed=n + p, device=dev)
    _, split, bad_count = _lb_call(args, case)
    mask, old_bad = args[2], args[6]
    assert bool(((old_bad > 0) & (bad_count == 0) & mask)[2::16].any())
    assert torch.equal(split * ~mask, torch.zeros_like(split))


@pytest.mark.gpu
def test_lb_update_matches_plain_version_at_wan_derate16_on_card(dev):
    """wan_derate16's LB tables: 16 cells x 500,000 flows x 8 slots, the
    cells' knobs drawn apart, the grid-stride loop many times round."""
    args = LC.lb_inputs(16 * 500_000, 8, seed=16, device=dev)
    _lb_call(args, "wan_derate16")


@pytest.mark.gpu
def test_lb_phase_of_a_fat_tree_step_on_card(dev, monkeypatch):
    """A k=4 fat tree's step on `pt_cuda` with the kernel as its LB phase,
    one launch an epoch, against the same step with the plain LB phase:
    states bitwise equal after 300 epochs, repaths and all."""
    import repro_torch.fleetsim as TF
    import repro_torch.scenarios as TS
    fs = TS.to_fleetsim(TS.fat_tree_spec(k=4, n_wan=4, n_flows=40,
                                         n_paths=4, seed=2), device=dev)
    net = TL.with_layout(fs.net, path_table=True)
    run = dict(n_epochs=300, is_inter=fs.is_inter, lb=fs.lb,
               backend="pt_cuda")
    launches = fleet_cuda.LAUNCHES["lb_update"]
    kernel, _ = TF.simulate(net, fs.params, **run)
    assert fleet_cuda.LAUNCHES["lb_update"] == launches + 300
    make = TC.make_lb_step
    monkeypatch.setattr(TC, "make_lb_step",
                        lambda *a, plain=False: make(*a, plain=True))
    want, _ = TF.simulate(net, fs.params, **run)
    assert fleet_cuda.LAUNCHES["lb_update"] == launches + 300
    for f in ("split", "path_frac", "bad_count", "cwnd", "q_phys"):
        assert torch.equal(getattr(kernel, f), getattr(want, f)), f
    assert not torch.equal(kernel.split, TL.uniform_split(net))
