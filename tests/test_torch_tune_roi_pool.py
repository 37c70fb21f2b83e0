"""The ROIPool kernel tuner's variants stay in step with the kernel sources.

Each variant of ``odwscl_tpu_torch.tools.tune_roi_pool`` is a copy of a
kernel source with constants or one pattern replaced; a pattern that no
longer matches the source exactly once raises before anything is built.
Building and timing need the card; these tests only make the sources.
"""

import pytest

from odwscl_tpu_torch.ops import roi_pool as rp
from odwscl_tpu_torch.tools import tune_roi_pool as tune

VARIANTS = ([("roi_pool_fwd", k, v, False)
             for k, v in tune.FWD_VARIANTS.items()]
            + [("roi_pool_fwd", k, v, True)
               for k, v in tune.ORDERED_VARIANTS.items()]
            + [("roi_pool_bwd", k, v, False)
               for k, v in tune.BWD_VARIANTS.items()])


@pytest.mark.parametrize("base,name,subs,ordered", VARIANTS,
                         ids=[f"{v[0]}:{v[1]}" for v in VARIANTS])
def test_variant_source_applies_once(base, name, subs, ordered, tmp_path,
                                     monkeypatch):
    monkeypatch.setattr(tune, "BUILD_DIR", tmp_path)
    extra = ((tune.Path(tune.__file__).parent
              / "roi_pool_fwd_ordered.cu").read_text() if ordered else "")
    lib = tune._variant(base, name, subs, rp._bind, extra)
    src = lib.source.read_text()
    shipped = (tune.CSRC_DIR / f"{base}.cu").read_text() + extra
    assert lib.source.parent == tmp_path / "variants"
    assert src != shipped or not subs
    if ordered:
        assert "roi_pool_fwd_ordered_bf16" in src


def test_variant_pattern_missing_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tune, "BUILD_DIR", tmp_path)
    with pytest.raises(ValueError, match="found 0 times"):
        tune._variant("roi_pool_fwd", "none", {"kNoSuchConstant": 1},
                      rp._bind)


def test_step_shapes_cover_the_train_scales():
    """One shape per train scale; the largest is profile_train's batch
    (1280x1664 padded, a 160x208 map, rois up to 720 px)."""
    shapes = tune._step_shapes()
    assert list(shapes) == [f"step{s}" for s in
                            (480, 576, 688, 864, 1000, 1200)]
    (hw, xy, wh, clip) = shapes["step1200"]
    assert hw == (160, 208)
    assert wh == (20, 720.0) and clip == (1599, 1199) and xy == (1560, 1160)
    feat, rois, mask = tune._inputs("step480", tune.torch.device("cpu"))
    assert tuple(feat.shape) == (8, 64, 80, 512)
    assert rois.shape == (8, 2048, 4) and bool(mask.all())
    assert float(rois[..., 2].max()) <= 639 and float(rois[..., 3].max()) <= 479
