"""The tiled decomposition of the fleet segmented sum (K1/K6) on the CPU.

`repro_torch.kernels.ref.csr_segment_sum_tiled_ref` computes K1's function
the way the CUDA kernels decompose it: tiles of consecutive entries, a
piece per (segment, tile), owner writes for segments inside one tile,
carries and head pieces at the tile edges added in tile order.  These
tests hold it bitwise against the plain `csr_segment_sum_ref` on CSRs
built to hit the edges, with integer-valued float32 values so that every
summation order is exact.  The card test runs the same cases through the
kernels; it skips without a CUDA device.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fleet_cuda  # noqa: E402
from repro_torch.kernels import ref as TK  # noqa: E402

N_VALS = 64


def _csr(rng, lens, tail: int = 0, pad: int = 0):
    """(vals, gather, ptr) for segment lengths `lens`, a trailing
    (sentinel) segment of `tail` entries and `pad` entries past it; the
    ids past ptr[K] point at non-zero values."""
    lens = np.asarray(lens, np.int64)
    ptr = np.concatenate([[0], np.cumsum(lens)])
    live = int(ptr[-1])
    ptr = np.concatenate([ptr, [live + tail]]).astype(np.int32)
    vals = rng.integers(1, 16, N_VALS).astype(np.float32)
    gather = rng.integers(0, N_VALS, live + tail + pad).astype(np.int32)
    return (torch.from_numpy(vals), torch.from_numpy(gather),
            torch.from_numpy(ptr))


def _cases(t: int):
    """Adversarial segment-length lists for tiles of t entries."""
    rng = np.random.default_rng(t)
    return {
        # empty segments on every tile edge and after the last live entry
        "empty_at_edges": [t, 0, 0, t - 1, 1, 0, t, 0, 2 * t, 0, 0],
        # one segment over many tiles between short ones (the dumbbell's
        # WAN links)
        "spanning": [3, 7 * t + 5, 1, 1, 4 * t, 2],
        # one segment, starting and ending on tile edges
        "single": [5 * t],
        "single_short": [1],
        # segments ending exactly on tile edges, and one tile exactly
        "tile_edges": [t, t, t // 2, t - t // 2, 1, t - 1],
        "all_empty": [0, 0, 0, 0],
        "random": list(rng.integers(0, 3 * t, 40)
                       * (rng.random(40) < 0.7)),
    }


CASE_NAMES = list(_cases(8))


def _eq(got, want, what):
    assert torch.equal(got, want), f"{what}:\n{got}\nvs\n{want}"
    assert not torch.signbit(got).any(), f"{what}: a -0.0"


@pytest.mark.parametrize("tile", [4, 7, TK.SEGSUM_TILE])
@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("tail,pad", [(0, 0), (3, 0), (0, 5), (2, 9)])
def test_tiled_ref_matches_plain_sum(tile, name, tail, pad):
    """Tile ownership, carries and head pieces give the plain segment
    sums bitwise; empty segments (at tile edges, after the last live
    entry) are +0.0, the scratch slot 0.0, and entries past ptr[K]
    (non-zero values) are never read."""
    rng = np.random.default_rng(len(name) * 31 + tail + pad)
    vals, gather, ptr = _csr(rng, _cases(tile)[name], tail, pad)
    want = TK.csr_segment_sum_ref(vals, gather, ptr)
    got = TK.csr_segment_sum_tiled_ref(vals, gather, ptr, tile=tile)
    _eq(got, want, f"{name} tile={tile}")
    assert got[-1] == 0.0
    k = ptr.shape[0] - 2
    empty = (ptr[1:k + 1] == ptr[:k])
    assert bool((got[:k][empty] == 0.0).all())
    # the entries past ptr[K] do not reach the sums
    scrambled = gather.clone()
    scrambled[int(ptr[k]):] = torch.randint(0, N_VALS,
                                            scrambled[int(ptr[k]):].shape,
                                            dtype=torch.int32)
    _eq(TK.csr_segment_sum_tiled_ref(vals, scrambled, ptr, tile=tile), got,
        f"{name}: entries past ptr[K] read")


@pytest.mark.parametrize("tile", [4, 7])
def test_tiled_ref_float_values_within_rounding(tile):
    """On non-integer values the tiled order differs from the plain one
    only by float32 rounding (the kernels' SCATTER_TOL)."""
    rng = np.random.default_rng(tile)
    vals, gather, ptr = _csr(rng, _cases(tile)["random"], 2, 3)
    vals = torch.from_numpy(rng.uniform(0, 12.5, N_VALS).astype(np.float32))
    got = TK.csr_segment_sum_tiled_ref(vals, gather, ptr, tile=tile)
    want = TK.csr_segment_sum_ref(vals.double(), gather, ptr)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["empty_at_edges", "spanning"])
def test_k6_cut_at_every_position(name):
    """K6's cut at every position of a small CSR: the tiles concatenated
    are the tiled sum, the scratch slot last in the boundary tile."""
    tile = 4
    rng = np.random.default_rng(7)
    vals, gather, ptr = _csr(rng, _cases(tile)[name], 2, 3)
    k = ptr.shape[0] - 2
    whole = TK.csr_segment_sum_tiled_ref(vals, gather, ptr, tile=tile)
    for nb in range(1, k):
        priv, bnd = fleet_cuda.segment_sum_tiles(vals, gather, ptr, nb)
        assert priv.shape == (k - nb,) and bnd.shape == (nb + 1,)
        _eq(torch.cat([priv, bnd]), whole, f"cut {nb}")
        assert bnd[-1] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASE_NAMES)
def test_kernels_match_tiled_ref_on_card(name):
    """K1 and K6 on the card: bitwise equal to the tiled plain version on
    integer values at the kernels' own tile, K6 to K1, two runs equal,
    and no host sync in either wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    vals, gather, ptr = (x.to(dev) for x in
                         _csr(rng, _cases(TK.SEGSUM_TILE)[name], 3, 17))
    k = ptr.shape[0] - 2
    want = TK.csr_segment_sum_tiled_ref(vals, gather, ptr)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k1 = fleet_cuda.segment_sum(vals, gather, ptr)
        again = fleet_cuda.segment_sum(vals, gather, ptr)
        tiles = [fleet_cuda.segment_sum_tiles(vals, gather, ptr, nb)
                 for nb in sorted({1, k // 2, k - 1}) if 0 < nb < k]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _eq(k1, want, f"{name}: K1")
    _eq(again, k1, f"{name}: K1 twice")
    for priv, bnd in tiles:
        _eq(torch.cat([priv, bnd]), k1, f"{name}: K6")
