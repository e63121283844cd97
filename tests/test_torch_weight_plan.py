"""The launch plan of the port's ``decompress_matmul`` kernel
(``repro_torch.kernels.decompress_matmul.plan``), on the CPU: pure
Python, no card.

The plan picks the kernel's route from (M, K, N, k), sizes the decode
route's split-K grid and picks the prefill route's tile.  These tests
hold it to what the kernel assumes (every K row in exactly one split,
splits aligned to the ring's chunk; every output in exactly one prefill
tile, a grid and shared memory the card takes) and to what it promises:
a grid that fills an H100 at qwen3-4b's decode shapes, and f32 partials
that stay a small share of the packed W.
"""

import math

import pytest

from repro_torch.configs import _MODULES, get_config
from repro_torch.core import weights
from repro_torch.kernels import decompress_matmul as D
from repro_torch.models import lm, params as PM

# (K, N) of qwen3-4b's weights: wq, wk/wv, wo, w_gate/w_up, w_down, lm_head
QWEN3_4B = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728),
            (9728, 2560), (2560, 151936)]


def _check_prefill_cover(p, m, kk, n, k):
    """A prefill tile the kernel has, all K in the CTA's loop, every output
    (row, column) in exactly one tile of the (M tiles, N tiles) grid, the
    grid and the tile's shared memory within an H100's limits."""
    assert (p.mrows, p.bn) in D.PREFILL_TILES
    assert (p.splits, p.depth, p.rows) == (1, kk, D.PREFILL_BK)
    gx, gy, gz = p.grid(m, n)
    assert gz == 1 and gy <= D.MAX_GRID_YZ and gx < 1 << 31
    for extent, tile, tiles in ((m, p.mrows, gx), (n, p.bn, gy)):
        covered = [0] * extent
        for t in range(tiles):
            for i in range(t * tile, min(extent, (t + 1) * tile)):
                covered[i] += 1
        assert covered == [1] * extent
        assert (tiles - 1) * tile < max(extent, 1)    # no empty tile
    assert p.ctas(m, n) == gx * gy
    assert D.prefill_smem_bytes(p.mrows, p.bn, k) <= D.MAX_SMEM


def _check_cover(p, m, kk, n, k=5):
    """Every K row in exactly one split, splits a whole number of chunks,
    and the shapes the kernel's layout takes."""
    if p.route == "prefill":
        _check_prefill_cover(p, m, kk, n, k)
        return
    assert p.bn in (32, 64, 128) and p.rows == D.chunk_rows(p.bn)
    assert p.rows % 16 == 0 and p.depth % p.rows == 0 and p.depth >= p.rows
    assert p.splits >= 1
    assert (p.splits - 1) * p.depth < max(kk, 1) <= p.splits * p.depth
    covered = [0] * kk
    for s in range(p.splits):
        for r in range(s * p.depth, min(kk, (s + 1) * p.depth)):
            covered[r] += 1
    assert covered == [1] * kk
    assert 8 <= p.mrows <= D.MAX_CTA_ROWS and p.mrows % 8 == 0
    assert p.grid(m, n)[2] == math.ceil(m / p.mrows)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 15, 16, 17, 33, 64, 65,
                               128, 129, 1024])
@pytest.mark.parametrize("kk,n", [(1, 32), (40, 32), (63, 64), (64, 128),
                                  (300, 160), (1000, 1056), (4095, 96)]
                         + QWEN3_4B)
def test_plan_covers_every_row_once(m, kk, n):
    for k in (1, 5, 8):
        _check_cover(D.plan(m, kk, n, k), m, kk, n, k)


@pytest.mark.parametrize("kk,n", QWEN3_4B,
                         ids=[f"{a}x{b}" for a, b in QWEN3_4B])
def test_plan_fills_the_card_at_qwen3_decode(kk, n):
    """At least two CTAs per SM (264) at every M of the decode route
    (every slot count, up to its threshold), every k."""
    for k in range(1, 9):
        for m in range(1, D.DECODE_MAX_M + 1):
            p = D.plan(m, kk, n, k)
            assert p.route == "decode"
            assert p.ctas(m, n) >= D.TARGET_CTAS >= 2 * 132, (m, k, p)


def test_plan_routes_by_m():
    assert D.DECODE_MAX_M >= 64             # every slot count the engine uses
    for m in (1, 4, 63, D.DECODE_MAX_M):
        assert D.plan(m, 2560, 1024, 5).route == "decode"
    for m in (D.DECODE_MAX_M + 1, 1024, 8192):
        assert D.plan(m, 2560, 1024, 5).route == "prefill"
    assert D.plan(1024, 2560, 1024, 5, "decode").route == "decode"
    assert D.plan(4, 2560, 1024, 5, "prefill").route == "prefill"
    with pytest.raises(ValueError, match="route"):
        D.plan(4, 2560, 1024, 5, "split")


@pytest.mark.parametrize("m", [129, 200, 256, 1000, 1024, 4096])
@pytest.mark.parametrize("kk,n", QWEN3_4B, ids=[f"{a}x{b}" for a, b in QWEN3_4B])
def test_prefill_tile_per_qwen3_shape(m, kk, n):
    """At every prefill M and code width, the tile of least cost, each
    output in one tile; at M = 1024 the tiles measured fastest on the
    H100: 128 x 128 for wk/wv (N = 1024: 64 CTAs, one wave), 256 x 128
    for the rest."""
    for k in range(1, 9):
        p = D.plan(m, kk, n, k)
        assert p.route == "prefill"
        _check_prefill_cover(p, m, kk, n, k)
        assert D.prefill_cost(m, n, p.mrows, p.bn) == min(
            D.prefill_cost(m, n, *t) for t in D.PREFILL_TILES)
    if m == 1024:
        assert (D.plan(m, kk, n, 5).mrows, D.plan(m, kk, n, 5).bn) == \
            ((128, 128) if n == 1024 else (256, 128))


def test_prefill_smem_and_grid_limits():
    """Every tile at every code width within a CTA's 232,448 B of shared
    memory (with the kernel's static 512 B dictionary and 64 B of
    mbarriers); the largest vocabulary's column tiles within the grid's
    y limit; the prefill route forced at tiny M still covers it."""
    for bm, bn in D.PREFILL_TILES:
        for k in range(1, 9):
            assert D.prefill_smem_bytes(bm, bn, k) + 512 + 64 <= D.MAX_SMEM
    assert D.prefill_smem_bytes(256, 128, 8) > D.prefill_smem_bytes(
        128, 128, 8) > D.prefill_smem_bytes(128, 128, 1)
    p = D.plan(1024, 2560, 151936, 5)
    assert p.grid(1024, 151936)[1] == 1187 <= D.MAX_GRID_YZ
    for m in (1, 4, 64):
        p = D.plan(m, 300, 96, 5, "prefill")
        _check_prefill_cover(p, m, 300, 96, 5)
        assert p.grid(m, 96) == (1, 1, 1)


def test_plan_small_shapes():
    """K = 1, N = 32 and K below one chunk: one split of one chunk, one
    CTA per column tile, no workspace."""
    for kk, n in ((1, 32), (1, 4096), (40, 32), (63, 2560)):
        p = D.plan(4, kk, n, 5)
        assert p.route == "decode" and p.splits == 1
        assert p.depth == p.rows >= kk
        assert p.workspace_floats(4, n) == 0 and p.counters(4, n) == 0
    assert D.plan(1, 1, 32, 1).ctas(1, 32) == 1
    assert D.plan(4, 0, 64, 5).splits == 1


def _weight_shapes(cfg):
    """The 2-D (per layer) shapes of the leaves that pack: from the
    port's parameter table where the family is ported, else the dense
    projections the config's widths define."""
    try:
        table = lm.lm_table(cfg)
    except NotImplementedError:
        d, hd = cfg.d_model, cfg.head_dim
        dims = [cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff,
                cfg.padded_vocab(1)]
        return {s for f in dims if f > 0 for s in ((d, f), (f, d))}
    shapes = set()

    def walk(t, path):
        if isinstance(t, PM.PDef):
            stacked = path[:1] == ("blocks",)
            per_layer = t.shape[1:] if stacked else t.shape
            if len(per_layer) == 2 and "embed" not in path[-1] \
                    and per_layer[0] * per_layer[1] >= \
                    weights.MIN_COMPRESS_SIZE and per_layer[1] % 32 == 0:
                shapes.add(tuple(per_layer))
            return
        for key, v in t.items():
            walk(v, path + (key,))

    walk(table, ())
    return shapes


@pytest.mark.parametrize("name", list(_MODULES))
def test_plan_workspace_is_a_small_share_of_w(name):
    """The f32 partials of splits 1.. stay within 1/8 of the packed W's
    bytes, at every decode M, code width and weight shape of the config;
    the counters are one int per (column tile, M-group)."""
    shapes = _weight_shapes(get_config(name))
    assert shapes
    for kk, n in sorted(shapes):
        if n % 32:
            continue
        for k in range(1, 9):
            for m in (1, 2, 4, 8, 16, 17, 32, 33, 48, 64, 65, 96, 128):
                p = D.plan(m, kk, n, k)
                assert 4 * p.workspace_floats(m, n) <= \
                    D.packed_bytes(kk, n, k) / D.WS_SHARE, (kk, n, k, m, p)
                if p.splits > 1:
                    assert p.counters(m, n) == \
                        p.grid(m, n)[0] * p.grid(m, n)[2]
