"""The launch plan of the fused conv's tensor-core body (``fused_conv.
conv_plan``) and the index arithmetic that ``csrc/fused_conv.cu``'s
``conv_tc`` builds on it, on the CPU.

The geometry: at ResNet-50's 16 batch-256 shapes, every ``chip_smoke.py``
``CONV_EXTRA`` case and a 224-wide image, the plan fits in a block's
shared memory, its slab holds every tap's window of every row of the tile
within one TMA box, its statistics partials have one row per row tile, and
images wider than 63 take the per-tap mode.

The walk: a numpy model of the body (for each tile and column block, each
64-channel step's slab or per-tap window gathered with zero fill outside
[0, M) and past C, the prologue applied once to the staged rows inside
[0, M), each tap's shifted window under the edge mask, the tap products
summed in f32; per-tile statistics partials) against the plain
``_eval_ref``, ``_conv_stats_ref`` and ``_conv_stats_pre_ref`` in fp32:
atol 1e-4, rtol 1e-5 (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.kernels import fused_conv as tfc

SMEM_MAX = 232448   # shared bytes a block may take on sm_90
MAX_BOX = 256       # rows of one TMA box
KC = 64             # channels a step

RESNET50 = [(chip_smoke.RESNET_BATCH, h, h, c, k, ks)
            for h, c, k, ks, *_ in chip_smoke.RESNET50_CONVS]
EXTRA = [case[1:] for case in chip_smoke.CONV_EXTRA]
WIDE = [(2, 3, 224, 64, 64, 3), (1, 2, 70, 8, 16, 3)]
GEOMETRY = RESNET50 + EXTRA + WIDE


@pytest.mark.parametrize("n,h,w,c,k,ks", GEOMETRY)
def test_plan_fits_and_its_slab_covers_every_tap(n, h, w, c, k, ks):
    plan = tfc.conv_plan(n, h, w, c, k, ks)
    if c % 8:
        assert plan.body == "simt" and plan.tile_rows == 64
        return
    assert plan.body == "tc" and plan.tile_rows == 128
    assert plan.smem <= SMEM_MAX
    assert plan.a_rows <= MAX_BOX
    assert 2 <= plan.a_stages <= 4 and 2 <= plan.w_stages <= 4
    assert plan.tn == (256 if k >= 256 else 128 if k > 64 else 64)
    pad = (ks - 1) // 2
    halo = w + 1 if ks == 3 else 0
    rows = np.arange(plan.tile_rows)
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            # the stage row each tile row reads for this tap
            if plan.mode == "slab":
                src = halo + dy * w + dx + rows
            else:
                src = rows
            assert src.min() >= 0 and src.max() < plan.a_rows


@pytest.mark.parametrize("n,h,w,c,k,ks", GEOMETRY)
def test_statistics_tiles_are_the_grid_row_tiles(n, h, w, c, k, ks):
    plan = tfc.conv_plan(n, h, w, c, k, ks)
    m = n * h * w
    assert plan.tiles == plan.grid[1] == -(-m // plan.tile_rows)
    assert plan.grid[0] == -(-k // plan.tn)


@pytest.mark.parametrize("w,mode", [(7, "slab"), (56, "slab"), (63, "slab"),
                                    (64, "tap"), (224, "tap")])
def test_wide_images_take_the_per_tap_mode(w, mode):
    assert tfc.conv_plan(2, 3, w, 64, 64, 3).mode == mode
    # 1x1: the tile's own rows at any width
    assert tfc.conv_plan(2, 3, w, 64, 64, 1).mode == "slab"


def test_fp32_and_odd_channels_take_the_plain_body():
    assert tfc.conv_plan(2, 8, 8, 16, 32, 3, bf16=False).body == "simt"
    assert tfc.conv_plan(2, 8, 8, 6, 8, 3).body == "simt"


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def _walk(x, w, plan, pre=None):
    """conv_tc's arithmetic in numpy: (out [M, K], part1, part2 [tiles,
    K]) for NHWC x and OIHW w in fp32; ``pre``: (ps, pb, relu_in)."""
    n, h, wd, c = x.shape
    k, _, ks, _ = w.shape
    m_rows, hw = n * h * wd, h * wd
    pad = (ks - 1) // 2
    halo = wd + 1 if ks == 3 else 0
    xf = x.reshape(m_rows, c)
    w_t = w.transpose(2, 3, 0, 1).reshape(ks * ks, k, c)
    tm, tn = plan.tile_rows, plan.tn
    out = np.zeros((m_rows, k), np.float32)
    part1 = np.zeros((plan.tiles, k), np.float32)
    part2 = np.zeros_like(part1)
    taps = [(dy, dx) for dy in range(-pad, pad + 1)
            for dx in range(-pad, pad + 1)]

    def stage(r0, c0):
        rows = r0 + np.arange(plan.a_rows)
        inside = (rows >= 0) & (rows < m_rows)
        st = np.zeros((plan.a_rows, KC), np.float32)
        cw = min(KC, c - c0)
        st[inside, :cw] = xf[rows[inside], c0:c0 + cw]
        if pre is not None:  # once per staged element, rows in [0, M)
            ps, pb, relu_in = pre
            v = st[inside, :cw] * ps[c0:c0 + cw] + pb[c0:c0 + cw]
            st[inside, :cw] = np.maximum(v, 0) if relu_in else v
        return st

    for tile in range(plan.tiles):
        m0 = tile * tm
        m = m0 + np.arange(tm)
        i = np.where(m < m_rows, (m % hw) // wd, -(1 << 30))
        j = m % wd
        for cb in range(plan.grid[0]):
            n0 = cb * tn
            acc = np.zeros((tm, tn), np.float32)
            for c0 in range(0, c, KC):
                slab = stage(m0 - halo, c0) if plan.mode == "slab" else None
                for t, (dy, dx) in enumerate(taps):
                    if slab is None:
                        win = stage(m0 + dy * wd + dx, c0)[:tm]
                    else:
                        off = halo + dy * wd + dx
                        win = slab[off:off + tm]
                    valid = ((i + dy >= 0) & (i + dy < h)
                             & (j + dx >= 0) & (j + dx < wd))
                    a = np.where(valid[:, None], win, 0)
                    b = np.zeros((tn, KC), np.float32)
                    kw, cw = min(tn, k - n0), min(KC, c - c0)
                    b[:kw, :cw] = w_t[t, n0:n0 + kw, c0:c0 + cw]
                    acc += a @ b.T
            rows, cols = min(tm, m_rows - m0), min(tn, k - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
            part1[tile, n0:n0 + cols] = acc[:, :cols].sum(0)
            part2[tile, n0:n0 + cols] = (acc[:, :cols] ** 2).sum(0)
    return out, part1, part2


WALK = [((2, 9, 9, 16), 8, 3),      # two row tiles crossing images
        ((1, 3, 70, 8), 16, 3),     # the per-tap mode
        ((3, 5, 7, 72), 300, 1),    # two channel steps, two column blocks
        ((2, 6, 5, 24), 40, 3),     # ragged channel step and K
        ((8, 1, 1, 64), 64, 3)]     # 1x1 images under a 3x3 kernel
TOL = dict(atol=1e-4, rtol=1e-5)


def _case(seed, shape, k, ks):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(k, shape[-1], ks, ks) * 0.1).astype(np.float32)
    return rng, x, w


@pytest.mark.parametrize("kind", ["eval", "stats", "pre"])
@pytest.mark.parametrize("shape,k,ks", WALK)
def test_walk_of_the_plan_matches_the_plain_versions(shape, k, ks, kind):
    rng, x, w = _case(sum(shape) + k, shape, k, ks)
    n, h, wd, c = shape
    plan = tfc.conv_plan(n, h, wd, c, k, ks)
    assert plan.body == "tc"
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    count = n * h * wd
    if kind == "eval":
        scale = (rng.rand(k) + 0.5).astype(np.float32)
        shift = rng.randn(k).astype(np.float32)
        acc, _, _ = _walk(x, w, plan)
        got = np.maximum(acc * scale + shift, 0).reshape(n, h, wd, k)
        want = tfc._eval_ref(tx, tw, torch.from_numpy(scale),
                             torch.from_numpy(shift), True)
        np.testing.assert_allclose(got, want.numpy(), **TOL)
        return
    if kind == "stats":
        acc, p1, p2 = _walk(x, w, plan)
        want = tfc._conv_stats_ref(tx, tw)
    else:
        m_p = (rng.randn(c) * 0.1).astype(np.float32)
        v_p = (rng.rand(c) + 0.5).astype(np.float32)
        gp = (rng.rand(c) + 0.5).astype(np.float32)
        bp = (rng.randn(c) * 0.1).astype(np.float32)
        args = [torch.from_numpy(a) for a in (m_p, v_p, gp, bp)]
        ps, pb = (t.numpy() for t in tfc._fold_bn(*args, 1e-5))
        acc, p1, p2 = _walk(x, w, plan, pre=(ps, pb, True))
        want = tfc._conv_stats_pre_ref(tx, *args, tw, True, 1e-5)
    mean = p1.sum(0) / count
    var = np.maximum(p2.sum(0) / count - mean * mean, 0)
    np.testing.assert_allclose(acc.reshape(n, h, wd, k), want[0].numpy(),
                               **TOL)
    np.testing.assert_allclose(mean, want[1].numpy(), **TOL)
    np.testing.assert_allclose(var, want[2].numpy(), atol=1e-4, rtol=1e-4)
