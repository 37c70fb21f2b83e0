"""The port's ROIPool stage profiler (odwscl_tpu_torch/ops/roi_pool_stages.py)
against the TPU stage variants, on the CPU.

The TPU variants are rebuilt here from the v5 blocks of
``odwscl_tpu/ops/roi_pool_pallas.py`` (``_prep(..., bwd=False)``,
``_build_table``, ``_rowbins_tbl``, ``_colbins``, ``_finalize``) as
``tools/profile_pool_stages.py:35-79`` assembles them, and run in Pallas
interpret mode with ``CHUNK`` patched to 2 inside this file only:

- ``write``, ``rows``, ``full``: ``make_kernel``'s stages;
- ``rows_col0``: ``tools/profile_pool.py:_fwd_rows_only`` (:71-72), with
  ``_rowbins_tbl`` standing in for v3's ``_rowbins``, which no longer
  exists (both give the exact row-bin maxima);
- ``cols``: ``_fwd_cols_only``'s strip fill (:97-101), then ``_colbins``.

Tolerance: bit-exact (atol 0, rtol 0). Max pooling selects one of its
inputs and does no arithmetic on them; the windows and bin edges are
integer arithmetic. Only live rois are compared: the TPU variants leave
the output of masked rois unwritten.

The CUDA kernel runs only on the card: chip_smoke.py holds it against
``roi_pool_stage_plain`` there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import odwscl_tpu.ops.roi_pool_pallas as jrp
from odwscl_tpu_torch.ops import roi_pool as rp
from odwscl_tpu_torch.ops import roi_pool_stages as rs

torch.set_num_threads(1)

SCALE = 0.125

# a 24x120 map (padded width 120: windows of 24, 40, 88 and 120 columns)
ROIS = np.array([
    [16.0, 8.0, 100.0, 90.0],        # 24-column window
    [80.0, 20.0, 320.0, 150.0],      # 40-column window
    [40.0, 0.0, 600.0, 120.0],       # 88-column window
    [0.0, 0.0, 959.0, 191.0],        # the full padded width
    [0.0, 0.0, 1990.0, 1480.0],      # far beyond the map (full width)
    [900.0, 10.0, 1100.0, 60.0],     # past the right edge: window clipped
    [-50.0, -30.0, 100.0, 80.0],     # hangs off the top-left corner
    [130.0, 90.0, 120.0, 80.0],      # malformed (x2 < x1) -> 1x1
    [56.0, 56.0, 56.0, 56.0],        # single cell
    [5.0, 5.0, 60.0, 500.0],         # tall, past the bottom edge
    [3000.0, 3000.0, 3100.0, 3100.0],  # off the map: every bin empty
    [300.0, 40.0, 700.0, 70.0],      # wide and 4 rows high: bins share rows
], dtype=np.float32)


def _inputs(seed=0, h=24, w=120, c=8, dtype=np.float32):
    rng = np.random.RandomState(seed)
    feat = rng.randn(1, h, w, c).astype(dtype)
    rois = ROIS[None].copy()
    mask = np.ones(rois.shape[:2], bool)
    mask[0, 4] = mask[0, 8] = False
    return feat, rois, mask


@pytest.fixture
def chunk2(monkeypatch):
    monkeypatch.setattr(jrp, "CHUNK", 2)


def _tpu_kernel(stage, wp, cws, nl):
    """tools/profile_pool_stages.py:make_kernel with the stages of
    tools/profile_pool.py added."""
    def kern(meta_ref, feat_ref, out_ref, tbl_ref, rb_ref):
        @pl.when(pl.program_id(2) == 0)
        def _():
            jrp._build_table(feat_ref, tbl_ref, nl)

        ct = feat_ref.shape[-1]
        dtype = feat_ref.dtype

        def body(r, _):
            cls = jrp._ms(meta_ref, r, jrp._M_CLS)
            valid = jrp._ms(meta_ref, r, jrp._M_VALID) > 0

            def run(cw, xs_slot):
                xs = (pl.multiple_of(jrp._ms(meta_ref, r, xs_slot), 8)
                      if xs_slot is not None else 0)
                if stage in ("rows", "rows_col0", "full"):
                    jrp._rowbins_tbl(meta_ref, feat_ref, tbl_ref, rb_ref, r,
                                     xs, cw, nl, dtype)
                elif stage == "cols":
                    for ph in range(7):
                        rb_ref[ph, :cw] = feat_ref[0, ph, pl.ds(xs, cw), :]\
                            .reshape(cw, ct).astype(dtype)
                if stage in ("cols", "full"):
                    res = jrp._colbins(meta_ref, rb_ref, r, xs, cw)
                elif stage == "rows":
                    rowred = jnp.max(rb_ref[:, 0:8, :], axis=1)
                    res = jnp.broadcast_to(rowred[:, None, :], (7, 7, ct))
                elif stage == "rows_col0":
                    res = jnp.broadcast_to(rb_ref[:, 0:1, :], (7, 7, ct))
                else:
                    res = jnp.zeros((7, 7, ct), dtype)
                out_ref[0, r] = jrp._finalize(res, valid).astype(
                    out_ref.dtype)

            for ci, (cw, slot) in enumerate(
                    zip(cws, (jrp._M_XSS, jrp._M_XSN, jrp._M_XSM))):
                if cw < wp:
                    @pl.when(valid & (cls == ci))
                    def _(cw=cw, slot=slot):
                        run(cw, slot)

            @pl.when(valid & (cls == 3))
            def _():
                run(wp, None)

            return 0

        jax.lax.fori_loop(0, jrp.CHUNK, body, 0)
    return kern


def _tpu_variant(stage, feat, rois, mask):
    feat_p, meta, hp, wp, cws, nl, ct, p, _ = jrp._prep(
        jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(mask), SCALE,
        bwd=False)
    b, _, _, c = feat_p.shape
    out = pl.pallas_call(
        _tpu_kernel(stage, wp, cws, nl),
        grid=(b, c // ct, meta.shape[1] // jrp.CHUNK),
        in_specs=[
            pl.BlockSpec((1, jrp.CHUNK, jrp.META_N),
                         lambda bi, ci, ri: (bi, ri, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((1, hp, wp, ct), lambda bi, ci, ri: (bi, 0, 0, ci),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, jrp.CHUNK, 7, 7, ct),
                               lambda bi, ci, ri: (bi, ri, 0, 0, ci),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, meta.shape[1], 7, 7, c),
                                       feat_p.dtype),
        scratch_shapes=[pltpu.VMEM((max(nl - 1, 1), hp, wp, ct),
                                   feat_p.dtype),
                        pltpu.VMEM((7, wp, ct), feat_p.dtype)],
        interpret=True,
    )(meta, feat_p)
    return np.asarray(out)[:, :p]


def _port(stage, feat, rois, mask, dtype=torch.float32):
    return rs.roi_pool_stage(torch.from_numpy(feat).to(dtype),
                             torch.from_numpy(rois), torch.from_numpy(mask),
                             SCALE, stage)


@pytest.mark.parametrize("stage", rs.STAGES)
def test_stage_matches_tpu_variant(stage, chunk2):
    feat, rois, mask = _inputs()
    _, cw = rs.tpu_windows(torch.from_numpy(rois), torch.from_numpy(mask),
                           SCALE, 24, 120)
    assert set(cw[torch.from_numpy(mask)].tolist()) == {24, 40, 88, 120}
    want = _tpu_variant(stage, feat, rois, mask)
    got = _port(stage, feat, rois, mask)
    assert got.shape == (1, len(ROIS), 7, 7, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[mask], want[mask])
    if stage != "write":
        assert np.count_nonzero(want[mask]) > 0


def _naive_rects(stage, rois, mask, h, w):
    """Each stage's definition: yields, per live roi (bi, pi) and bin (ph,
    pw), the rows and columns of the zero-padded map whose max it is."""
    xs_all, cw_all = (t.numpy() for t in rs.tpu_windows(
        torch.from_numpy(rois), torch.from_numpy(mask), SCALE, h, w))
    for bi, pi in zip(*np.nonzero(mask)):
        x1, y1, x2, y2 = (int(v) for v in np.floor(
            rois[bi, pi] * np.float32(SCALE) + np.float32(0.5)))
        rw, rh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
        xs, cw = int(xs_all[bi, pi]), int(cw_all[bi, pi])
        for ph in range(7):
            hs = min(max(ph * rh // 7 + y1, 0), h)
            he = min(max(-(-(ph + 1) * rh // 7) + y1, 0), h)
            for pw in range(7):
                ws = min(max(pw * rw // 7 + x1, 0), w)
                we = min(max(-(-(pw + 1) * rw // 7) + x1, 0), w)
                if stage == "full":
                    ys, xr = range(hs, he), range(ws, we)
                elif stage == "rows":
                    ys, xr = range(hs, he), range(xs, xs + 8)
                elif stage == "rows_col0":
                    ys, xr = range(hs, he), range(xs, xs + 1)
                elif stage == "cols":
                    ys, xr = [ph], range(max(ws, xs), min(we, xs + cw))
                else:
                    ys, xr = [], []
                yield bi, pi, ph, pw, ys, xr


def _naive(stage, feat, rois, mask):
    """Each stage's definition, one roi, bin and cell at a time, over the
    zero-padded map."""
    b, h, w, c = feat.shape
    hp, wp = jrp._padded_dims(h, w)
    padded = np.zeros((b, hp, wp, c), feat.dtype)
    padded[:, :h, :w] = feat
    out = np.zeros(rois.shape[:2] + (7, 7, c), feat.dtype)
    for bi, pi, ph, pw, ys, xr in _naive_rects(stage, rois, mask, h, w):
        cells = [padded[bi, y, x] for y in ys for x in xr]
        if cells:
            out[bi, pi, ph, pw] = np.max(cells, axis=0)
    return out


@pytest.mark.parametrize("h,w", [(24, 120), (5, 100), (13, 17), (11, 6)])
def test_plain_matches_definition_on_padded_maps(h, w):
    """Maps whose width is not a multiple of 8, lower than 7 rows (zero
    rows in cols) or narrower than 8 columns (zero columns in the rows
    stage's [xs, xs + 8))."""
    feat, rois, mask = _inputs(seed=1, h=h, w=w)
    for stage in rs.STAGES:
        got = _port(stage, feat, rois, mask).numpy()
        np.testing.assert_array_equal(got, _naive(stage, feat, rois, mask),
                                      err_msg=stage)


def test_tpu_windows_match_roi_meta():
    """cls, valid and the window start of each class, as _roi_meta plans
    them, on random and edge rois over several map widths."""
    rng = np.random.RandomState(2)
    edge = np.array([[0, 0, 0, 0], [-80, -80, -1, -1], [5000, 0, 6000, 50],
                     [190, 0, 191, 7], [183, 0, 200, 7], [0, 0, 5000, 8],
                     [700, 0, 100, 8], [64, 0, 255, 8], [64, 0, 256, 8]],
                    np.float32)
    for h, w in ((24, 120), (20, 100), (13, 17), (104, 168), (200, 260)):
        hp, wp = jrp._padded_dims(h, w)
        assert rs.padded_dims(h, w) == (hp, wp)
        x1y1 = rng.uniform(-100, 8 * w + 100, (2, 40, 2))
        wh = rng.uniform(-20, 8 * w, (2, 40, 2))
        rois = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
        rois = np.concatenate([rois, np.stack([edge, edge])], 1)
        mask = rng.uniform(size=rois.shape[:2]) > 0.2
        meta = np.asarray(jrp._roi_meta(
            jnp.asarray(rois), jnp.asarray(mask), SCALE, h, w, hp, wp,
            jrp._cws(wp), jrp._nl_full(hp)))
        xs, cw = (t.numpy() for t in rs.tpu_windows(
            torch.from_numpy(rois), torch.from_numpy(mask), SCALE, h, w))
        assert xs.dtype == cw.dtype == np.int32
        cls = meta[..., 0]
        np.testing.assert_array_equal(meta[..., 1], mask.astype(np.int32))
        widths = np.array(list(jrp._cws(wp)) + [wp])[cls]
        starts = np.where(cls == 3, 0, np.take_along_axis(
            meta[..., 2:5], np.minimum(cls, 2)[..., None], -1)[..., 0])
        np.testing.assert_array_equal(cw, np.where(mask, widths, 0))
        np.testing.assert_array_equal(xs, np.where(mask, starts, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_is_roi_pool_plain(dtype):
    feat, rois, mask = _inputs(seed=3)
    f = torch.from_numpy(feat).to(dtype)
    r, m = torch.from_numpy(rois), torch.from_numpy(mask)
    got = rs.roi_pool_stage(f, r, m, SCALE, "full")
    assert got.dtype == dtype
    assert torch.equal(got, rp.roi_pool_plain(f, r, m, SCALE))
    # the other stages in bf16 select the same values as in f32
    for stage in rs.STAGES:
        want = rs.roi_pool_stage(f.float(), r, m, SCALE, stage)
        assert torch.equal(rs.roi_pool_stage(f, r, m, SCALE, stage).float(),
                           want), stage


def test_masked_rois_give_zero_in_every_stage():
    feat, rois, mask = _inputs(seed=4)
    feat = np.abs(feat) + 1.0            # every live bin is non-zero
    for stage in rs.STAGES:
        out = _port(stage, feat, rois, mask).numpy()
        assert not out[~mask].any(), stage


@pytest.mark.parametrize("h,w", [(24, 120), (5, 100), (13, 17), (11, 6)])
def test_stage_edges_match_definition(h, w):
    """The kernel's spec: each bin's rectangle on the unpadded map holds
    the definition's in-map cells, and where it is non-empty the pad flag
    says whether the definition also reads the zero pad (then the max
    starts at +0; where it is empty, both give 0)."""
    _, rois, mask = _inputs(h=h, w=w)
    n = rois.shape[0] * rois.shape[1]
    pads = 0
    for stage in rs.STAGES:
        r0, r1, c0, c1, pad = (t.numpy() for t in rs.stage_edges(
            torch.from_numpy(rois), torch.from_numpy(mask), SCALE, h, w,
            stage))
        assert r0.shape == c1.shape == (n, 7) and pad.shape == (n,)
        for bi, pi, ph, pw, ys, xr in _naive_rects(stage, rois, mask, h, w):
            i = bi * rois.shape[1] + pi
            want = {(y, x) for y in ys for x in xr if y < h and x < w}
            got = {(y, x) for y in range(r0[i, ph], r1[i, ph])
                   for x in range(c0[i, pw], c1[i, pw])}
            assert got == want, (stage, pi, ph, pw)
            if got:
                reads_pad = any(y >= h or x >= w for y in ys for x in xr)
                assert pad[i] == reads_pad, (stage, pi, ph, pw)
                pads += reads_pad
    assert pads > 0 if w < 8 else pads == 0


def test_stage_plan_reads_nothing_back(monkeypatch):
    """The plan stays on the rois' device: no value goes to the host."""
    feat, rois, mask = (torch.from_numpy(a) for a in _inputs())

    def refuse(*_):
        raise AssertionError("stage_plan read a tensor back to the host")

    for name in ("item", "tolist", "numpy", "__int__", "__float__",
                 "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    plan = rs.stage_plan(feat, rois, mask, SCALE)
    monkeypatch.undo()
    xs, cw = rs.tpu_windows(rois, mask, SCALE, 24, 120)
    assert plan._fields == ("xs", "cw")
    assert torch.equal(plan.xs, xs) and torch.equal(plan.cw, cw)
    assert plan.xs.is_contiguous() and plan.cw.dtype == torch.int32


def test_cpu_dispatch_counts_no_launch():
    feat, rois, mask = _inputs()
    before = dict(rs.roi_pool_stage.launches)
    for stage in rs.STAGES:
        _port(stage, feat, rois, mask)
    assert rs.roi_pool_stage.launches == before
    with pytest.raises(ValueError, match="unknown stage"):
        _port("bins", feat, rois, mask)


def test_non_cpu_tensor_never_takes_plain_path():
    """A tensor off the CPU goes to the kernel wrapper, which refuses what
    is not a CUDA tensor instead of pooling it another way."""
    feat = torch.empty((1, 4, 4, 8), device="meta")
    rois = torch.empty((1, 2, 4), device="meta")
    mask = torch.empty((1, 2), dtype=torch.bool, device="meta")
    for stage in rs.STAGES:
        with pytest.raises(ValueError, match="neither a CPU tensor"):
            rs.roi_pool_stage(feat, rois, mask, SCALE, stage)
