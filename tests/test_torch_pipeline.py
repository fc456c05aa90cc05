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
    y/x sums in another order, then HSV) > 85% of pixels equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.data import device_pipeline as tdp
from object_detection_cib_torch.data.host_augment import (
    AffineParams as TAffine,
    AugParams as TAug,
)
from object_detection_cib_torch.data.synthetic import build_fake_manifest as t_manifest
from object_detection_cib_torch.ops import augment as ta
from object_detection_cib_tpu.data import device_pipeline as jdp
from object_detection_cib_tpu.data.host_augment import AugParams as JAug
from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest
from object_detection_cib_tpu.ops import augment as ja
from object_detection_cib_tpu.ops import pallas_hsv, pallas_warp

S, B, N, MAXT = 64, 4, 24, 40


def _jax_pipe(seed=3, max_targets=MAXT):
    info = j_manifest(num_images=N, num_classes=3, image_size=S, seed=2)
    return jdp.DeviceDataPipeline(info, target_size=S, batch_size=B, aug_params=JAug(),
                                  max_targets=max_targets, seed=seed, fake_mode=True,
                                  device_cache=True, corpus_layout="planar")


def _port_pipe(seed=3, max_targets=MAXT):
    info = t_manifest(num_images=N, num_classes=3, image_size=S, seed=2)
    return tdp.DeviceDataPipeline(info, S, B, TAug(), max_targets=max_targets, seed=seed,
                                  device="cpu")


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
        np.testing.assert_array_equal(tp._epoch_plan(), groups)


def _jax_draws(key, G):
    k_m, k_a, k_h, k_f = jax.random.split(key, 4)
    centers = jax.random.randint(k_m, (G, 2), S // 2, 2 * S - S // 2)
    values = ja.sample_affine_values_batch(k_a, G, translate=0.1, scale=0.5)
    r = ja.hsv_gains(k_h, G, 0.015, 0.7, 0.4)
    do = jax.random.uniform(k_f, (G,)) < 0.5
    return tdp.AugmentDraws(
        torch.from_numpy(np.array(centers)).int(),
        ta.AffineBatchValues(*(torch.from_numpy(np.array(v)) for v in values)),
        torch.from_numpy(np.array(do)), torch.from_numpy(np.array(r)))


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
    tp._epoch_plan()
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


@pytest.mark.parametrize("kw,item", [
    (dict(mixup_prob=0.5), "A5"),
    (dict(use_mosaic=False), "A4"),
    (dict(aug_params=TAug(affine_params=TAffine(degrees=10.0))), "A4"),
    (dict(warp_precision="exact"), "A4"),
    (dict(sampler=object()), "A3"),
    (dict(fake_mode=False), "A3"),
    (dict(device_cache=False), "A3"),
    (dict(corpus_layout="flat"), "not ported"),
])
def test_unported_settings_raise(kw, item):
    info = t_manifest(num_images=8, num_classes=3, image_size=S, seed=2)
    args = dict(aug_params=TAug(), device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match=item):
        tdp.DeviceDataPipeline(info, S, B, **args)
