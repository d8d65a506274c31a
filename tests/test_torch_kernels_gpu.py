"""K2 (the fleet link -> flow gathers), K3 (the UnoRC GF(2^8) product)
and K5 (the UnoRC dequant) on the card, against their plain versions,
bitwise; K1 / K2 flat at the shapes of a sweep grid (8 x 100k-flow
dumbbells as one block-diagonal net); and K6, K1 stage 1 and the
PathTable gathers at shard 0 of the sharded grid (two k=8, 100k-flow fat
trees under cell 0's plan lifted to the grid).

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

from repro_torch.fleetsim import links as TL  # noqa: E402
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
