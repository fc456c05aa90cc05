"""Port parity: the device pipeline (fake corpus on the device, planar).

The JAX pipeline runs on the CPU in its device-cache planar mode. There its
warp is the einsum "fast" path and its HSV the XLA ``hsv_batch`` (the
Pallas kernels are gated to a TPU); the port's step runs K2, K5 and K4's
plain versions. Tolerances:
  * epoch plan, corpus bytes, sizes and target arrays: exact;
  * one gather-and-augment step given JAX's draws: boxes 1e-4, labels,
    masks and overflow exact; pixels against the JAX package's Pallas
    composition (warp and HSV kernels in interpret mode) differ on < 0.2%
    of pixels, by <= 9/255: the warp's class is one unit where M, inverted
    by two libraries, moves a tap by an ulp, and HSV's gains (up to 1.7)
    and hue sector turn one unit into a few (measured: <= 5/255 on <= 0.09%
    of pixels); against the JAX package's default CPU path (einsum warp,
    y/x sums in another order, then HSV) > 85% of pixels equal;
  * one step under ``warp_pallas=False`` (the port's dense bf16 warp)
    against that JAX default CPU path, the same dense bf16 products: boxes,
    labels, masks and overflow exact, pixels in the recipes' gates below;
  * the recipes (a sampler, mixup, no mosaic, a general affine, the exact
    warp): epoch plans, ``consumed_plan_log`` and ``letterbox_center``
    exact; one whole step given JAX's draws, f32 feed: boxes 1e-4, labels,
    masks and overflow exact; with HSV off, pixels <= 1/255 apart and
    >= 99% equal per blended image (the warp's class: a sample coordinate
    on the other side of a .5 boundary); with HSV on, which turns one unit
    into a few, <= 9/255 on < 1% of pixels per blended image;
  * the flat corpus (``corpus_layout="flat"``: NHWC rows gathered by K3's
    plain version) against the JAX package's flat pipeline, three steps
    of the mosaic, mixup and no-mosaic recipes with JAX's draws fed in:
    the corpus and each gathered group exact; the batch within the
    recipes' gates above and exact against the port's planar pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.data import device_pipeline as tdp
from object_detection_cib_torch.data import samplers as tsamplers
from object_detection_cib_torch.data.host_augment import (
    AffineParams as TAffine,
    AugParams as TAug,
    HSVParams as THSV,
)
from object_detection_cib_torch.data.synthetic import build_fake_manifest as t_manifest
from object_detection_cib_torch.ops import augment as ta
from object_detection_cib_torch.ops import warp as t_warp
from object_detection_cib_tpu.data import device_pipeline as jdp
from object_detection_cib_tpu.data import samplers as jsamplers
from object_detection_cib_tpu.data.host_augment import (
    AffineParams as JAffine,
    AugParams as JAug,
    HSVParams as JHSV,
)
from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest
from object_detection_cib_tpu.ops import augment as ja
from object_detection_cib_tpu.ops import pallas_hsv, pallas_warp

S, B, N, MAXT = 64, 4, 24, 40


def _sampler(mod, info, kind):
    if kind is None:
        return None
    return {"class_aware": lambda: mod.ClassAwareSampler(info, seed=0),
            "repeat_factor": lambda: mod.RepeatFactorSampler(info),
            "repeat_factor_max": lambda: mod.RepeatFactorSampler(info, reduction="max"),
            "shuffle": lambda: mod.ShuffleSampler(info, seed=1)}[kind]()


def _aug(Aug, Affine, HSV, affine=None, hsv=True):
    return Aug(affine_params=Affine(**(affine or {})),
               hsv_params=HSV() if hsv else HSV.no_aug())


def _jax_pipe(seed=3, max_targets=MAXT, sampler=None, affine=None, hsv=True, **kw):
    info = j_manifest(num_images=N, num_classes=3, image_size=S, seed=2)
    return jdp.DeviceDataPipeline(info, target_size=S, batch_size=B,
                                  aug_params=_aug(JAug, JAffine, JHSV, affine, hsv),
                                  max_targets=max_targets, seed=seed, fake_mode=True,
                                  device_cache=True, corpus_layout="planar",
                                  sampler=_sampler(jsamplers, info, sampler), **kw)


def _port_pipe(seed=3, max_targets=MAXT, sampler=None, affine=None, hsv=True, **kw):
    info = t_manifest(num_images=N, num_classes=3, image_size=S, seed=2)
    return tdp.DeviceDataPipeline(info, S, B, _aug(TAug, TAffine, THSV, affine, hsv),
                                  max_targets=max_targets, seed=seed, device="cpu",
                                  sampler=_sampler(tsamplers, info, sampler), **kw)


@pytest.fixture(scope="module")
def pipes():
    return _jax_pipe(), _port_pipe()


def test_corpus_and_targets_match_jax(pipes):
    jp, tp = pipes
    assert jp.planar
    np.testing.assert_array_equal(tp.corpus.numpy(), np.asarray(jp._ds_images))
    np.testing.assert_array_equal(tp.sizes.numpy(), np.asarray(jp._ds_sizes))
    np.testing.assert_array_equal(tp.t_boxes.numpy(), np.asarray(jp._ds_tb))
    np.testing.assert_array_equal(tp.t_labels.numpy(), np.asarray(jp._ds_tl))
    np.testing.assert_array_equal(tp.t_mask.numpy(), np.asarray(jp._ds_tm))
    assert len(tp) == len(jp) == N // B


@pytest.mark.parametrize("seed", [0, 3, 2023])
def test_epoch_plan_matches_jax(seed):
    jp, tp = _jax_pipe(seed), _port_pipe(seed)
    for _ in range(3):  # consecutive epochs: pyrng advances alike
        groups, _, _ = jp._epoch_plan()
        np.testing.assert_array_equal(tp._epoch_plan()[0], groups)


def _jax_draws(key, G, affine=None, hsv=True, use_mosaic=True):
    """The draws the JAX ``augment_group`` makes from ``key`` for G output images."""
    k_m, k_a, k_h, k_f = jax.random.split(key, 4)
    centers = jax.random.randint(k_m, (G, 2), S // 2, 2 * S - S // 2)
    values = ja.sample_affine_values_batch(k_a, G, **{**dict(translate=0.1, scale=0.5),
                                                      **(affine or {})})
    r = ja.hsv_gains(k_h, G, 0.015, 0.7, 0.4)
    do = jax.random.uniform(k_f, (G,)) < 0.5
    return tdp.AugmentDraws(
        torch.from_numpy(np.array(centers)).int() if use_mosaic else None,
        ta.AffineBatchValues(*(torch.from_numpy(np.array(v)) for v in values)),
        torch.from_numpy(np.array(do)), torch.from_numpy(np.array(r)) if hsv else None)


def _jax_mixup_draws(key, G, prob, **kw):
    """The JAX mixup function splits the step key in four: primary group,
    secondary group, the beta(32, 32) ratio, the per-image coin."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    r = jax.random.beta(k3, 32.0, 32.0, (G, 1, 1, 1))
    do = jax.random.uniform(k4, (G,)) < prob
    return _jax_draws(k1, G, **kw)._replace(
        secondary=_jax_draws(k2, G, **kw), mix_r=torch.from_numpy(np.array(r)),
        mix_do=torch.from_numpy(np.array(do)))


def _pallas_interpret(monkeypatch):
    """Route the JAX augment through its Pallas kernels in interpret mode."""
    warp, hsv = pallas_warp.warp_quadrants, pallas_hsv.hsv_planar
    monkeypatch.setattr(pallas_warp, "warp_quadrants",
                        lambda *a, **k: warp(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(pallas_hsv, "hsv_planar",
                        lambda *a, **k: hsv(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("max_targets,seed", [(MAXT, 0), (MAXT, 1), (6, 2)])
def test_gather_augment_step_matches_jax(monkeypatch, max_targets, seed):
    jp, tp = _jax_pipe(max_targets=max_targets), _port_pipe(max_targets=max_targets)
    groups, _, keys = jp._epoch_plan()
    idx = np.asarray(groups[seed], np.int32)
    key = jnp.asarray(keys[seed])
    ds = (jp._ds_images, jp._ds_sizes, jp._ds_tb, jp._ds_tl, jp._ds_tm)
    jb, jovf = jax.jit(jp._gather_augment_raw)(*ds, jnp.asarray(idx), key)
    tb, tovf = tp.gather_augment(torch.from_numpy(idx), _jax_draws(key, B))

    np.testing.assert_allclose(tb.boxes.numpy(), np.asarray(jb.boxes), atol=1e-4)
    np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    assert int(tovf) == int(jovf)
    assert tb.images.shape == (B, S, S, 3) and tb.images.dtype == torch.bfloat16
    default = np.abs(tb.images.float().numpy() - np.asarray(jb.images, np.float32))
    assert (default == 0).mean() > 0.85, (default == 0).mean()

    _pallas_interpret(monkeypatch)
    fn = jdp.build_device_augment_fn(S, JAug(), max_targets=max_targets, warp_precision="fast",
                                     planar=True, hsv_pallas=True, warp_pallas=True)
    sample = ja.DeviceSample(jp._gather(jp._ds_images, jnp.asarray(idx)),
                             *(a[jnp.asarray(idx)] for a in ds[1:]))
    kb, _ = fn(sample, key)
    diff = np.abs(tb.images.float().numpy() - np.asarray(kb.images, np.float32))
    assert diff.max() <= 9.0 / 255, diff.max()
    assert (diff > 0).mean() < 0.002, (diff > 0).mean()
    np.testing.assert_allclose(tb.boxes.numpy(), np.asarray(kb.boxes), atol=1e-4)


@pytest.mark.parametrize("hsv", [False, True], ids=["hsv_off", "hsv_on"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_warp_step_matches_jax(seed, hsv):
    """One whole step under ``warp_pallas=False`` against the JAX
    pipeline's, whose warp on the CPU is the same dense bf16 branch."""
    jp = _jax_pipe(hsv=hsv, warp_pallas=False)
    tp = _port_pipe(hsv=hsv, warp_pallas=False)
    assert not jp.warp_pallas and tp.warp_precision == "fast_dense"
    groups, _, keys = jp._epoch_plan()
    idx = np.asarray(groups[seed], np.int32)
    key = jnp.asarray(keys[seed])
    ds = (jp._ds_images, jp._ds_sizes, jp._ds_tb, jp._ds_tl, jp._ds_tm)
    jb, jovf = jax.jit(jp._gather_augment_raw)(*ds, jnp.asarray(idx), key)
    tb, tovf = tp.gather_augment(torch.from_numpy(idx), _jax_draws(key, B, hsv=hsv))
    np.testing.assert_array_equal(tb.boxes.numpy(), np.asarray(jb.boxes))
    np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    assert int(tovf) == int(jovf)
    # the composed path's gates (module docstring): the same dense products
    # on both sides, a rounding apart where a sum sits on a .5 boundary
    diff = np.abs(tb.images.float().numpy() - np.asarray(jb.images, np.float32)) * 255
    if hsv:
        assert diff.max() <= 9.0 + 1e-3 and (diff > 1e-3).mean() < 0.01, (diff.max(), (diff > 1e-3).mean())
    else:
        assert diff.max() <= 1.0 + 1e-3 and (diff <= 1e-3).mean() >= 0.99, (diff.max(), (diff <= 1e-3).mean())


def test_epoch_iterator_runs_every_step():
    tp = _port_pipe(seed=5, max_targets=6)
    steps = list(tp.epoch())
    assert len(steps) == N // B
    for batch, ovf in steps:
        assert batch.images.shape == (B, S, S, 3)
        assert batch.boxes.shape == (B, 6, 4) and batch.mask.shape == (B, 6)
        assert float(batch.images.float().max()) <= 1.0
    assert tp.overflow_total == sum(int(o) for _, o in steps) > 0
    assert len(list(tp.epoch(max_steps=2))) == 2


def test_draws_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    d = tdp.draw_augment(gen, 64, 416, TAug())
    assert d.centers.shape == (64, 2) and d.centers.dtype == torch.int32
    assert int(d.centers.min()) >= 208 and int(d.centers.max()) < 624
    assert float(d.values.scale.min()) >= 0.5 and float(d.values.scale.max()) <= 1.5
    assert float(d.values.translate_x.min()) >= 0.4 and float(d.values.translate_x.max()) <= 0.6
    assert (d.values.degrees == 0).all() and (d.values.perspective_x == 0).all()
    assert d.flip.dtype == torch.bool and d.hsv_r.shape == (64, 3)
    assert float((d.hsv_r[:, 1] - 1).abs().max()) <= 0.7
    off = tdp.draw_augment(gen, 8, 64, TAug.no_aug())
    assert off.flip is None and off.hsv_r is None


# ------------------------------------------------------------- the recipes

GENERAL = dict(degrees=10.0, shear=2.0, perspective=5e-4)

RECIPES = {
    "mixup": dict(mixup_prob=0.5),
    "no_mosaic": dict(use_mosaic=False),
    "general_affine": dict(affine=GENERAL),
    "exact": dict(warp_precision="exact"),
    "mixup_general_affine": dict(mixup_prob=0.5, affine=GENERAL),
    "class_aware": dict(sampler="class_aware"),
    "repeat_factor": dict(sampler="repeat_factor"),
    "shuffle": dict(sampler="shuffle"),
    "no_aug_no_mosaic": dict(use_mosaic=False, hsv=False,
                             affine=dict(degrees=0.0, translate=0.0, scale=0.0)),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_recipe_settings_run_an_epoch(recipe):
    """Every setting that once raised NotImplementedError yields finite batches."""
    tp = _port_pipe(seed=1, **RECIPES[recipe])
    steps = list(tp.epoch(max_steps=2))
    assert len(steps) == 2
    cap = (2 if tp.mixup_prob else 1) * (4 if tp.use_mosaic else 1) * tp.src_T
    for batch, _ in steps:
        assert batch.images.shape == (B, S, S, 3) and batch.images.dtype == torch.bfloat16
        assert torch.isfinite(batch.images.float()).all()
        assert 0.0 <= float(batch.images.float().min()) and float(batch.images.float().max()) <= 1.0
        assert batch.boxes.shape == (B, MAXT, 4) and int(batch.mask.sum(1).max()) <= cap
        assert float(batch.boxes.min()) >= 0 and float(batch.boxes.max()) <= S - 1
    assert (tp.draw().secondary is not None) == bool(tp.mixup_prob)
    assert len(tp.consumed_plan_log) == 1 and tp.consumed_plan_log[0].shape[0] == N // B


def test_mixup_without_mosaic_is_refused():
    with pytest.raises(ValueError, match="mixup requires mosaic"):
        _port_pipe(mixup_prob=0.5, use_mosaic=False)
    with pytest.raises(ValueError, match="warp_precision"):
        _port_pipe(warp_precision="bf16")
    tp = _port_pipe(mixup_prob=0.5)
    idx = torch.zeros(4 * B, dtype=torch.int32)
    with pytest.raises(ValueError, match="idx2"):
        tp.gather_augment(idx, tp.draw())
    with pytest.raises(ValueError, match="idx2"):
        _port_pipe().gather_augment(idx, tp.draw(), idx)


@pytest.mark.parametrize("mode", ["mosaic", "no_mosaic", "mixup"])
@pytest.mark.parametrize("sampler", [None, "class_aware", "repeat_factor", "repeat_factor_max",
                                     "shuffle"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epoch_plan_recipes_match_jax(seed, sampler, mode):
    kw = {"mosaic": {}, "no_mosaic": dict(use_mosaic=False), "mixup": dict(mixup_prob=0.5)}[mode]
    jp, tp = _jax_pipe(seed, sampler=sampler, **kw), _port_pipe(seed, sampler=sampler, **kw)
    for _ in range(2):  # consecutive epochs: sampler, pool and pyrng advance alike
        jg, jsec, _ = jp._epoch_plan()
        tg, tsec = tp._epoch_plan()
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tsec, jsec)
    assert tg.shape == (N // B, B if mode == "no_mosaic" else 4 * B)
    assert tsec.shape == (N // B, 4 * B if mode == "mixup" else 0)
    assert len(tp.consumed_plan_log) == len(jp.consumed_plan_log) == 2
    for got, want in zip(tp.consumed_plan_log, jp.consumed_plan_log):
        np.testing.assert_array_equal(got, want)


def test_consumed_plan_log_keeps_eight_epochs():
    tp = _port_pipe(seed=0, use_mosaic=False)
    plans = [tp._epoch_plan()[0] for _ in range(10)]
    assert len(tp.consumed_plan_log) == 8
    np.testing.assert_array_equal(tp.consumed_plan_log[0], plans[2])
    np.testing.assert_array_equal(tp.consumed_plan_log[-1], plans[9])


def _jax_letterbox_center():
    """The ``letterbox_center`` closure inside the JAX ``build_device_augment_fn``."""
    fn = jdp.build_device_augment_fn(S, JAug(), use_mosaic=False)
    inner = fn.__wrapped__
    group = inner.__closure__[inner.__code__.co_freevars.index("augment_group")].cell_contents
    return group.__closure__[group.__code__.co_freevars.index("letterbox_center")].cell_contents


def test_letterbox_center_matches_jax():
    jp, tp = _jax_pipe(use_mosaic=False), _port_pipe(use_mosaic=False)
    assert not jp.planar  # the JAX package keeps an NHWC corpus off the fused path
    np.testing.assert_array_equal(tp.corpus.permute(0, 2, 3, 1).numpy(), np.asarray(jp._ds_images))
    idx = np.asarray([0, 5, 9, 23, 5], np.int32)
    ji = jnp.asarray(idx)
    want = _jax_letterbox_center()(ja.DeviceSample(jp._ds_images[ji], jp._ds_sizes[ji], jp._ds_tb[ji],
                                                   jp._ds_tl[ji], jp._ds_tm[ji]))
    got = tdp.letterbox_center(tp.gather(torch.from_numpy(idx)), S)
    assert got.images.dtype == torch.uint8
    np.testing.assert_array_equal(got.images.permute(0, 2, 3, 1).numpy(), np.asarray(want.images))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    assert (got.sizes == S).all()
    # the content really moved to the centre: the border rows and columns are FILL
    h, w = tp.sizes[0].tolist()
    top, left = (S - h) // 2, (S - w) // 2
    np.testing.assert_array_equal(got.images[0, :, top:top + h, left:left + w].numpy(),
                                  tp.corpus[0, :, :h, :w].numpy())
    assert (got.images[0, :, :top] == 114).all() and (got.images[0, :, :, :left] == 114).all()


STEP_RECIPES = {
    "mixup_exact": dict(mixup_prob=0.5, warp_precision="exact"),
    "no_mosaic": dict(use_mosaic=False),
    "general_affine": dict(affine=GENERAL),
    "mixup_general_affine": dict(mixup_prob=0.5, affine=GENERAL),
}


@pytest.mark.parametrize("hsv", [False, True])
@pytest.mark.parametrize("recipe", list(STEP_RECIPES))
def test_recipe_step_matches_jax(recipe, hsv):
    kw = dict(STEP_RECIPES[recipe], hsv=hsv, feed_dtype=jnp.float32, sampler="class_aware")
    jp = _jax_pipe(**kw)
    tp = _port_pipe(**{**kw, "feed_dtype": torch.float32})
    groups, secs, keys = jp._epoch_plan()
    mixup, mosaic, affine = kw.get("mixup_prob", 0.0), kw.get("use_mosaic", True), kw.get("affine")
    key = jnp.asarray(keys[1])
    idx = np.asarray(groups[1], np.int32)
    ds = (jp._ds_images, jp._ds_sizes, jp._ds_tb, jp._ds_tl, jp._ds_tm)
    dkw = dict(affine=affine, hsv=hsv, use_mosaic=mosaic)
    if mixup:
        idx2 = np.asarray(secs[1], np.int32)
        jb, jovf = jax.jit(jp._gather_augment_raw)(*ds, jnp.asarray(idx), jnp.asarray(idx2), key)
        tb, tovf = tp.gather_augment(torch.from_numpy(idx), _jax_mixup_draws(key, B, mixup, **dkw),
                                     torch.from_numpy(idx2))
    else:
        jb, jovf = jax.jit(jp._gather_augment_raw)(*ds, jnp.asarray(idx), key)
        tb, tovf = tp.gather_augment(torch.from_numpy(idx), _jax_draws(key, B, **dkw))
    np.testing.assert_allclose(tb.boxes.numpy(), np.asarray(jb.boxes), atol=1e-4)
    np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    assert int(tovf) == int(jovf)
    assert int(tb.mask.sum()) > 0
    assert tb.images.shape == (B, S, S, 3) and tb.images.dtype == torch.float32
    diff = np.abs(tb.images.numpy() - np.asarray(jb.images))
    blended = 2 if mixup else 1
    if hsv:
        assert diff.max() <= 9.0 / 255 + 1e-6, diff.max() * 255
        assert (diff > 1e-6).mean() < 0.01 * blended, (diff > 1e-6).mean()
    else:
        assert diff.max() <= 1.0 / 255 + 1e-6, diff.max() * 255
        assert (diff <= 1e-6).mean() >= 1 - 0.01 * blended, (diff <= 1e-6).mean()


def _fault_tap_order(monkeypatch):
    """The composed path's bilinear blend with the x and y fractions exchanged
    (v01 and v10 swapped); the fused path's two taps of a row exchanged."""
    sample, scalars = ta._bilinear_sample, ta._tap_scalars_windowed

    def swapped_sample(imgs, xs, ys):
        x0, y0 = torch.floor(xs), torch.floor(ys)
        return sample(imgs, x0 + (ys - y0), y0 + (xs - x0))

    def swapped_scalars(s, lo, hi):
        i0, w0, w1 = scalars(s, lo, hi)
        return i0, w1, w0

    monkeypatch.setattr(ta, "_bilinear_sample", swapped_sample)
    monkeypatch.setattr(ta, "_tap_scalars_windowed", swapped_scalars)


def _fault_no_fill(monkeypatch):
    """Out-of-bounds taps and the canvas border read 0 instead of FILL."""
    monkeypatch.setattr(ta, "FILL", 0.0)
    monkeypatch.setattr(t_warp, "FILL", 0.0)


def _fault_half_pixel(monkeypatch):
    """Every sample coordinate half a pixel off along x."""
    sample, scalars = ta._bilinear_sample, ta._tap_scalars_windowed
    monkeypatch.setattr(ta, "_bilinear_sample", lambda imgs, xs, ys: sample(imgs, xs + 0.5, ys))
    monkeypatch.setattr(ta, "_tap_scalars_windowed", lambda s, lo, hi: scalars(s + 0.5, lo, hi))


FAULTS = {"tap_order": _fault_tap_order, "no_fill": _fault_no_fill, "half_pixel": _fault_half_pixel}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("recipe", ["general_affine", "mixup"])
def test_hsv_on_pixel_gate_catches_planted_faults(monkeypatch, capsys, recipe, fault):
    """The control for the gate that holds two sound runs of one step together
    with HSV on (9/255 at most, on under 0.1% of pixels, 0.2% under mixup):
    the same step with a fault planted in the warp reads outside it."""
    kw = dict(RECIPES[recipe], feed_dtype=torch.float32)
    tp = _port_pipe(**kw)
    groups, secs = tp._epoch_plan()
    idx = torch.from_numpy(groups[0].astype(np.int32))
    idx2 = torch.from_numpy(secs[0].astype(np.int32)) if secs.size else None
    draws = tp.draw()
    sound, _ = tp.gather_augment(idx, draws, idx2)
    again, _ = tp.gather_augment(idx, draws, idx2)
    assert torch.equal(sound.images, again.images)
    FAULTS[fault](monkeypatch)
    faulty, _ = tp.gather_augment(idx, draws, idx2)
    diff = (sound.images - faulty.images).abs() * 255.0
    worst, share = float(diff.max()), float((diff > 1e-3).float().mean())
    with capsys.disabled():
        print(f"\n[planted fault] {recipe}, {fault}, 64 px B=4 f32, HSV on: max pixel difference "
              f"{worst:.4f}/255 on {share:.6f} of pixels")
    assert worst > 9.0 + 1e-3 and share >= 0.001 * (2 if idx2 is not None else 1), (worst, share)


def test_mixup_fast_step_matches_jax_pallas_path(monkeypatch):
    """Mixup on the production fused path (K5 and K4's plain versions, bf16
    stage, f32 blend) against the JAX Pallas composition in interpret mode."""
    kw = dict(mixup_prob=0.5, feed_dtype=jnp.float32, sampler="repeat_factor")
    jp, tp = _jax_pipe(**kw), _port_pipe(**{**kw, "feed_dtype": torch.float32})
    groups, secs, keys = jp._epoch_plan()
    key = jnp.asarray(keys[0])
    idx, idx2 = jnp.asarray(groups[0], jnp.int32), jnp.asarray(secs[0], jnp.int32)
    draws = _jax_mixup_draws(key, B, 0.5)
    assert draws.mix_do.any() and not draws.mix_do.all()
    tb, tovf = tp.gather_augment(torch.from_numpy(np.array(idx)), draws,
                                 torch.from_numpy(np.array(idx2)))
    _pallas_interpret(monkeypatch)
    fn = jdp.build_device_augment_fn(S, JAug(), mixup_prob=0.5, max_targets=MAXT,
                                     warp_precision="fast", planar=True, hsv_pallas=True,
                                     warp_pallas=True, feed_dtype=jnp.float32)
    ds = (jp._ds_images, jp._ds_sizes, jp._ds_tb, jp._ds_tl, jp._ds_tm)
    pick = lambda i: ja.DeviceSample(jp._gather(ds[0], i), *(a[i] for a in ds[1:]))
    kb, kovf = fn(pick(idx), pick(idx2), key)
    diff = np.abs(tb.images.numpy() - np.asarray(kb.images))
    assert diff.max() <= 9.0 / 255 + 1e-6, diff.max() * 255
    assert (diff > 1e-6).mean() < 0.004, (diff > 1e-6).mean()
    np.testing.assert_allclose(tb.boxes.numpy(), np.asarray(kb.boxes), atol=1e-4)
    np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(kb.labels))
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(kb.mask))
    assert int(tovf) == int(kovf)
    # a blended row holds both groups' targets, a plain row only the primary's
    T4 = 4 * tp.src_T
    assert 2 * T4 <= MAXT  # capacity holds both groups: to_batch keeps the slot order
    assert tb.mask[draws.mix_do][:, T4:].any() and not tb.mask[~draws.mix_do][:, T4:].any()
    # blended pixels are not multiples of 1/255: the blend ran in f32, not bf16
    frac = (tb.images[draws.mix_do] * 255.0) % 1.0
    assert float(((frac > 0.01) & (frac < 0.99)).float().mean()) > 0.5


def test_mixup_draws_and_device_move():
    gen = torch.Generator().manual_seed(0)
    d = tdp.draw_augment(gen, 16, 64, TAug(), mixup_prob=0.5)
    assert d.secondary is not None and d.secondary.secondary is None
    assert d.mix_r.shape == (16, 1, 1, 1) and d.mix_do.shape == (16,)
    assert not torch.equal(d.centers, d.secondary.centers)
    plain = tdp.draw_augment(gen, 16, 64, TAug())
    assert plain.secondary is None and plain.mix_r is None and plain.mix_do is None
    flat = tdp.draw_augment(gen, 16, 64, TAug(), use_mosaic=False)
    assert flat.centers is None and flat.values.scale.shape == (16,)
    moved = d.to("cpu")
    assert isinstance(moved, tdp.AugmentDraws) and isinstance(moved.values, ta.AffineBatchValues)
    assert torch.equal(moved.secondary.hsv_r, d.secondary.hsv_r) and torch.equal(moved.mix_r, d.mix_r)
    assert tdp.draw_augment(gen, 4, 64, TAug.no_aug()).to("cpu").flip is None


def test_pipelines_share_one_corpus():
    a = _port_pipe()
    b = _port_pipe(use_mosaic=False, corpus=None)
    shared = tdp.DeviceDataPipeline(a.info, S, B, TAug(), max_targets=MAXT, mixup_prob=0.5,
                                    device="cpu", corpus=a.device_corpus)
    assert shared.corpus is a.corpus and shared.t_boxes is a.t_boxes
    assert b.corpus is not a.corpus and torch.equal(b.corpus, a.corpus)
    with pytest.raises(ValueError, match="another dataset"):
        tdp.DeviceDataPipeline(b.info, S, B, TAug(), device="cpu", corpus=a.device_corpus)
    with pytest.raises(ValueError, match="another dataset"):
        tdp.DeviceDataPipeline(a.info, 32, B, TAug(), device="cpu", corpus=a.device_corpus)


@pytest.mark.parametrize("recipe", ["class_aware_mixup", "repeat_factor_no_mosaic",
                                    "shuffle_general_affine_exact_off"])
def test_trainer_runs_recipe_and_counts_sampler_stats(recipe):
    from object_detection_cib_torch.train.trainer import Trainer, plan_instance_counts

    info = t_manifest(num_images=N, num_classes=3, image_size=S, seed=2, zipf_a=1.01)
    val = t_manifest(num_images=4, num_classes=3, image_size=S, seed=9)
    kw = {
        "class_aware_mixup": dict(sampler=tsamplers.ClassAwareSampler(info, seed=0), mixup_prob=0.5),
        "repeat_factor_no_mosaic": dict(sampler=tsamplers.RepeatFactorSampler(info), use_mosaic=False),
        "shuffle_general_affine_exact_off": dict(
            sampler=tsamplers.ShuffleSampler(info, seed=0),
            aug_params=TAug(affine_params=TAffine(**GENERAL))),
    }[recipe]
    trainer = Trainer(info, val, size="n", image_size=S, batch_size=B, max_targets=MAXT, seed=0,
                      dtype=None, device="cpu", **kw)
    assert trainer.sampler_stats() is None  # nothing planned yet
    # the sampler's own twin: what the trainer's sampler will draw this epoch
    twin = {"class_aware_mixup": lambda: tsamplers.ClassAwareSampler(info, seed=0),
            "repeat_factor_no_mosaic": lambda: tsamplers.RepeatFactorSampler(info),
            "shuffle_general_affine_exact_off": lambda: tsamplers.ShuffleSampler(info, seed=0)}[recipe]()
    first_epoch = np.asarray(twin.epoch_indices())
    trainer.fit(max_epochs=1, epoch_steps=2)
    assert np.isfinite(trainer.epoch_metrics[-1]["total"]).all()
    plan = trainer.pipeline.consumed_plan_log[0]
    stats = trainer.sampler_stats(2)
    assert stats == plan_instance_counts(info, plan[:2]) and sum(stats.values()) > 0
    width = {"class_aware_mixup": 8 * B, "repeat_factor_no_mosaic": B,
             "shuffle_general_affine_exact_off": 4 * B}[recipe]
    assert plan.shape == (N // B, width)
    # every primary of the two steps is among the plan's rows, step by step
    for step in range(2):
        assert set(first_epoch[step * B:(step + 1) * B]) <= set(plan[step])
    # counting did not draw the sampler: its next epoch is the twin's second
    assert trainer.sampler_stats(2) == stats  # the log is empty: the last plan again
    np.testing.assert_array_equal(trainer.pipeline.sampler.epoch_indices(), twin.epoch_indices())
    by_hand = {c: 0 for c in info.classes}
    for i in plan[:2].ravel():
        for t in info.samples[int(i)].targets:
            by_hand[t.class_name] += 1
    assert stats == by_hand


# ---------------------------------------------------------- the flat corpus

FLAT_RECIPES = {  # the JAX CPU warp is the dense bf16 one: the port's too (warp_pallas=False)
    "mosaic": dict(warp_pallas=False),
    "mixup": dict(mixup_prob=0.5, warp_pallas=False),
    "no_mosaic": dict(use_mosaic=False),
}


@pytest.mark.parametrize("recipe", list(FLAT_RECIPES))
def test_flat_pipeline_matches_jax_flat_pipeline(recipe):
    """The port's flat pipeline against the JAX package's
    ``DeviceDataPipeline(corpus_layout="flat")`` (NHWC corpus, its plain
    row gather on the CPU), three steps with JAX's draws fed in: the corpus
    and each gathered group bitwise (K3's rows, viewed back as images);
    the augmented batch within the recipe tests' gates (module docstring),
    and bitwise the port's planar pipeline given the same draws."""
    kw = dict(FLAT_RECIPES[recipe], feed_dtype=jnp.float32, sampler="class_aware")
    info = j_manifest(num_images=N, num_classes=3, image_size=S, seed=2)
    jp = jdp.DeviceDataPipeline(info, target_size=S, batch_size=B, aug_params=JAug(), max_targets=MAXT, seed=3,
                                fake_mode=True, device_cache=True, corpus_layout="flat",
                                sampler=_sampler(jsamplers, info, "class_aware"),
                                **{k: v for k, v in kw.items() if k != "sampler"})
    tkw = {**kw, "feed_dtype": torch.float32}
    tp, planar = _port_pipe(**tkw, corpus_layout="flat"), _port_pipe(**tkw)
    assert not jp.planar and tp.device_corpus.layout == "flat"
    np.testing.assert_array_equal(tp.corpus.numpy(), np.asarray(jp._ds_images))
    assert tuple(tp.corpus.shape) == (N, S, S, 3)
    groups, secs, keys = jp._epoch_plan()
    tg, tsec = tp._epoch_plan()
    np.testing.assert_array_equal(tg, groups)
    np.testing.assert_array_equal(tsec, secs)
    mixup, mosaic = kw.get("mixup_prob", 0.0), kw.get("use_mosaic", True)
    ds = (jp._ds_images, jp._ds_sizes, jp._ds_tb, jp._ds_tl, jp._ds_tm)
    for step in range(3):
        key = jnp.asarray(keys[step])
        idx = [np.asarray(groups[step], np.int32)] + ([np.asarray(secs[step], np.int32)] if mixup else [])
        for i in idx:  # the gathered groups, bitwise
            got, ji = tp.gather(torch.from_numpy(i)), jnp.asarray(i)
            np.testing.assert_array_equal(got.images.permute(0, 2, 3, 1).numpy(), np.asarray(jp._gather(ds[0], ji)))
            for g, j in zip(got[1:], ds[1:]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(j[ji]))
        ti = [torch.from_numpy(i) for i in idx]
        draws = (_jax_mixup_draws(key, B, mixup) if mixup else _jax_draws(key, B, use_mosaic=mosaic))
        jb, jovf = jax.jit(jp._gather_augment_raw)(*ds, *map(jnp.asarray, idx), key)
        tb, tovf = tp.gather_augment(ti[0], draws, *ti[1:])
        pb, povf = planar.gather_augment(ti[0], draws, *ti[1:])
        for name in ("images", "boxes", "labels", "mask"):
            assert torch.equal(getattr(tb, name), getattr(pb, name)), name
        assert int(tovf) == int(povf) == int(jovf)
        np.testing.assert_allclose(tb.boxes.numpy(), np.asarray(jb.boxes), atol=1e-4)
        np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
        np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
        diff = np.abs(tb.images.numpy() - np.asarray(jb.images))
        assert diff.max() <= 9.0 / 255 + 1e-6, diff.max() * 255
        assert (diff > 1e-6).mean() < 0.01 * (2 if mixup else 1), (diff > 1e-6).mean()


def test_flat_layout_host_fed_is_accepted():
    """With the corpus not on the card the layout changes nothing (JAX:
    ``planar`` needs ``device_cache``): the same batches as planar."""
    got = _port_pipe(seed=2, device_cache=False, corpus_layout="flat")
    want = _port_pipe(seed=2, device_cache=False)
    assert got.corpus is None and got.corpus_layout == "flat"
    for (a, _), (b, _) in zip(got.epoch(max_steps=2), want.epoch(max_steps=2), strict=True):
        for name in ("images", "boxes", "labels", "mask"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_flat_corpus_refusals():
    """A shared corpus of the other layout raises, naming both; a row that
    is not whole (8, 128) tiles raises, naming S; an unknown layout raises."""
    planar, flat = _port_pipe(), _port_pipe(corpus_layout="flat")
    with pytest.raises(ValueError, match="'planar' layout .* corpus_layout='flat'"):
        tdp.DeviceDataPipeline(planar.info, S, B, TAug(), device="cpu", corpus=planar.device_corpus,
                               corpus_layout="flat")
    with pytest.raises(ValueError, match="'flat' layout .* corpus_layout='planar'"):
        tdp.DeviceDataPipeline(flat.info, S, B, TAug(), device="cpu", corpus=flat.device_corpus)
    shared = tdp.DeviceDataPipeline(flat.info, S, B, TAug(), device="cpu", corpus=flat.device_corpus,
                                    corpus_layout="flat")
    assert shared.corpus is flat.corpus
    info = t_manifest(num_images=4, num_classes=3, image_size=40, seed=2)
    with pytest.raises(ValueError, match="S=40"):
        tdp.DeviceDataPipeline(info, 40, 2, TAug(), device="cpu", corpus_layout="flat")
    with pytest.raises(ValueError, match="S=48"):
        tdp.DeviceCorpus.fake(t_manifest(num_images=4, num_classes=3, image_size=48, seed=2), 48, "cpu", "flat")
    tdp.DeviceDataPipeline(info, 40, 2, TAug(), device="cpu")  # the planar layout takes any size
    with pytest.raises(ValueError, match="corpus_layout"):
        _port_pipe(corpus_layout="nhwc")
