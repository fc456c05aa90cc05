"""Port parity: the feeds that start from JPEG files, and the trainer over them.

On a small synthetic JPEG corpus (16 images at 80 px, written by the port's
``build_synthetic_dataset``), on the CPU:
  * the JPEG ``DeviceCorpus`` equals the JAX package's ``_build_device_cache``
    canvases, transposed, byte for byte; a corrupt JPEG raises;
  * the host-fed ``_load_group`` equals the JAX package's (fake and JPEG, RAM
    cache on and off), and with the RAM cache each image is decoded once;
  * one host-fed step given JAX's draws against the JAX package's NHWC
    host-fed step, at ``tests/test_torch_pipeline.py``'s gates for its
    default CPU path: boxes 1e-4, labels, masks and overflow exact, > 85% of
    pixels equal;
  * host-fed and device-cache pipelines give the same batches, bit for bit;
  * the host feed and the ``ValDeviceCache`` give the same mAP dict on the
    same canvases;
  * a tiny ``Trainer`` (yolov5n) trains and validates through each feed;
  * the lr horizon is the trainer's ``max_epochs`` (the JAX schedule, f32,
    exact), and each epoch records the targets dropped by ``max_targets``
    with nothing left pending on the pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.data import device_pipeline as tdp
from object_detection_cib_torch.data import native_loader as t_native
from object_detection_cib_torch.data import pipeline as tpl
from object_detection_cib_torch.data import samplers as tsamplers
from object_detection_cib_torch.data.host_augment import AugParams as TAug
from object_detection_cib_torch.data.host_augment import ValidationSampleAugmentor
from object_detection_cib_torch.data.reader import AugmentedSample, SampleReader
from object_detection_cib_torch.data.synthetic import build_fake_manifest as t_manifest
from object_detection_cib_torch.data.synthetic import build_synthetic_dataset
from object_detection_cib_torch.data.val_cache import ValDeviceCache
from object_detection_cib_torch.ops import augment as ta
from object_detection_cib_torch.train import optim as topt
from object_detection_cib_torch.train.trainer import Evaluator, Trainer
from object_detection_cib_tpu.data import device_pipeline as jdp
from object_detection_cib_tpu.data.host_augment import AugParams as JAug
from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest
from object_detection_cib_tpu.ops import augment as ja
from object_detection_cib_tpu.train import optim as jopt

S, B, MAXT = 64, 4, 40


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """(root, train manifest, val manifest): crowded images, so that a small
    ``max_targets`` drops some."""
    root = tmp_path_factory.mktemp("jpeg")
    train = build_synthetic_dataset(root, "synthetic-hard-zipf", num_classes=4, num_images=16,
                                    image_size=80, max_objects=12, seed=3)
    val = build_synthetic_dataset(root, "synthetic-hard-zipf-val", num_classes=4, num_images=6,
                                  image_size=80, seed=4)
    return root, train, val


def _port(info, root, **kw):
    kw.setdefault("aug_params", TAug())
    return tdp.DeviceDataPipeline(info, S, B, max_targets=kw.pop("max_targets", MAXT), seed=3,
                                  device="cpu", root_dir=root, **kw)


def _jax(info, root, **kw):
    return jdp.DeviceDataPipeline(info, target_size=S, batch_size=B, aug_params=JAug(),
                                  max_targets=MAXT, seed=3, root_dir=root, **kw)


def test_jpeg_corpus_matches_jax(jpegs):
    root, info, _ = jpegs
    tp = _port(info, root, fake_mode=False)
    jp = _jax(info, root, fake_mode=False, device_cache=True, corpus_layout="planar")
    assert jp.planar
    np.testing.assert_array_equal(tp.corpus.numpy(), np.asarray(jp._ds_images))
    np.testing.assert_array_equal(tp.sizes.numpy(), np.asarray(jp._ds_sizes))
    for name, jname in (("t_boxes", "_ds_tb"), ("t_labels", "_ds_tl"), ("t_mask", "_ds_tm")):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, jname)))
    # and the CPU's own pack_batch, transposed
    bufs = [(root / s.image_path).read_bytes() for s in info.samples]
    canv, sizes, fails = t_native.pack_batch(bufs, S)
    assert fails == 0
    np.testing.assert_array_equal(tp.corpus.numpy(), canv.transpose(0, 3, 1, 2))
    same = tdp.DeviceCorpus.from_canvases(info, canv, sizes, "cpu")
    assert torch.equal(same.images, tp.corpus) and torch.equal(same.t_boxes, tp.t_boxes)


@pytest.mark.parametrize("device_cache", [True, False])
def test_corrupt_jpeg_raises(tmp_path, jpegs, device_cache):
    root, info, _ = jpegs
    bad = tmp_path / info.samples[5].image_path
    bad.parent.mkdir(parents=True)
    bad.write_bytes(b"\xff\xd8 not a jpeg")
    for s in info.samples:
        if s is not info.samples[5]:
            dst = tmp_path / s.image_path
            dst.write_bytes((root / s.image_path).read_bytes())
    with pytest.raises(ValueError, match="1 of .* JPEG files failed to decode"):
        p = _port(info, tmp_path, fake_mode=False, device_cache=device_cache)
        p.load_augment(np.arange(16, dtype=np.int64), p.draw())


@pytest.mark.parametrize("mode", ["fake", "jpeg", "jpeg_ram_cache"])
def test_load_group_matches_jax(jpegs, mode):
    root, info, _ = jpegs
    if mode == "fake":
        info = t_manifest(num_images=12, num_classes=3, image_size=S, seed=2)
        jinfo = j_manifest(num_images=12, num_classes=3, image_size=S, seed=2)
    else:
        jinfo = info
    kw = dict(fake_mode=mode == "fake", enable_ram_cache=mode.endswith("ram_cache"))
    tp = _port(info, root, device_cache=False, **kw)
    jp = _jax(jinfo, root, device_cache=False, **kw)
    decodes = []
    real = t_native.pack_batch

    def counting(bufs, *a, **k):
        decodes.append(len(bufs))
        return real(bufs, *a, **k)

    groups, _, _ = jp._epoch_plan()
    for group in list(groups) * 2:  # the epoch twice: the RAM cache is warm the second time
        orig = t_native.pack_batch
        t_native.pack_batch = counting
        try:
            got = tp._load_group(group)
        finally:
            t_native.pack_batch = orig
        want = jp._load_group(group)
        np.testing.assert_array_equal(got.images.numpy(), np.asarray(want.images))
        np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
        rows = torch.from_numpy(np.asarray(group, np.int64))
        up = tp.upload(got, rows)
        np.testing.assert_array_equal(up.images.numpy(), np.asarray(want.images).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(up.boxes.numpy(), np.asarray(want.boxes))
        np.testing.assert_array_equal(up.labels.numpy(), np.asarray(want.labels))
        np.testing.assert_array_equal(up.mask.numpy(), np.asarray(want.mask))
    if mode == "jpeg":
        assert sum(decodes) == 2 * groups.size
    elif mode == "jpeg_ram_cache":
        assert sum(decodes) == len(np.unique(groups)) <= len(info.samples)
    else:
        assert not decodes


def _jax_draws(key, G):
    """The draws the JAX ``augment_group`` makes from ``key`` for G output images
    (``tests/test_torch_pipeline.py:_jax_draws``, at this file's size)."""
    k_m, k_a, k_h, k_f = jax.random.split(key, 4)
    centers = jax.random.randint(k_m, (G, 2), S // 2, 2 * S - S // 2)
    values = ja.sample_affine_values_batch(k_a, G, translate=0.1, scale=0.5)
    r = ja.hsv_gains(k_h, G, 0.015, 0.7, 0.4)
    do = jax.random.uniform(k_f, (G,)) < 0.5
    return tdp.AugmentDraws(torch.from_numpy(np.array(centers)).int(),
                            ta.AffineBatchValues(*(torch.from_numpy(np.array(v)) for v in values)),
                            torch.from_numpy(np.array(do)), torch.from_numpy(np.array(r)))


@pytest.mark.parametrize("step", [0, 2])
def test_host_fed_step_matches_jax_nhwc_step(jpegs, step):
    root, info, _ = jpegs
    tp = _port(info, root, fake_mode=False, device_cache=False)
    jp = _jax(info, root, fake_mode=False, device_cache=False)
    assert not jp.planar  # the JAX host-fed feed is NHWC
    groups, _, keys = jp._epoch_plan()
    key = jnp.asarray(keys[step])
    jb, jovf = jp.augment_fn(jp._load_group(groups[step]), key)
    tb, tovf = tp.load_augment(groups[step], _jax_draws(key, B))
    np.testing.assert_allclose(tb.boxes.numpy(), np.asarray(jb.boxes), atol=1e-4)
    np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    assert int(tovf) == int(jovf)
    assert tb.images.shape == (B, S, S, 3) and tb.images.dtype == torch.bfloat16
    same = np.abs(tb.images.float().numpy() - np.asarray(jb.images, np.float32)) == 0
    assert same.mean() > 0.85, same.mean()


@pytest.mark.parametrize("recipe", [dict(), dict(mixup_prob=0.5, sampler="class_aware"),
                                    dict(use_mosaic=False, enable_ram_cache=True)])
def test_host_fed_equals_device_cache(jpegs, recipe):
    root, info, _ = jpegs
    kw = dict(recipe)
    if kw.pop("sampler", None):
        samplers = [tsamplers.ClassAwareSampler(info, seed=0) for _ in range(2)]
    else:
        samplers = [None, None]
    cached = _port(info, root, fake_mode=False, sampler=samplers[0], **kw)
    fed = _port(info, root, fake_mode=False, device_cache=False, prefetch=1, sampler=samplers[1], **kw)
    for _ in range(2):
        a, b = list(cached.epoch()), list(fed.epoch())
        assert len(a) == len(b) == len(info.samples) // B
        for (ba, oa), (bb, ob) in zip(a, b):
            for x, y in zip(ba, bb):
                assert torch.equal(x, y)
            assert int(oa) == int(ob)
    assert cached.overflow_total == fed.overflow_total
    assert all(np.array_equal(x, y) for x, y in zip(cached.consumed_plan_log, fed.consumed_plan_log))


def test_host_fed_producer_error_reaches_consumer(jpegs):
    root, info, _ = jpegs
    fed = _port(info, root, fake_mode=False, device_cache=False)

    def broken(indices, keep=slice(None)):
        raise OSError("disk gone")

    fed._load_group = broken
    with pytest.raises(OSError, match="disk gone"):
        list(fed.epoch())
    with pytest.raises(RuntimeError, match="device_cache=True"):
        fed.gather(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="device_cache=True"):
        _port(info, root, device_cache=False, corpus=_port(info, root).device_corpus)


class _CanvasReader:
    """A reader that hands out a val cache's centered canvases and targets."""

    def __init__(self, cache, info):
        self.cache, self.index = cache, {s.id: j for j, s in enumerate(info.samples)}

    def __call__(self, sample, letter_box=True):
        j = self.index[sample.id]
        m = self.cache.gt_mask[j]
        return AugmentedSample(self.cache.canvases[j], self.cache.gt_boxes[j][m],
                               self.cache.gt_labels[j][m].astype(np.int64))


@pytest.mark.parametrize("fake", [True, False])
def test_host_feed_validation_equals_val_device_cache(jpegs, fake):
    root, _, val = jpegs
    if fake:
        val = t_manifest(num_images=7, num_classes=4, image_size=S, seed=1)
    from object_detection_cib_torch.core.types import default_anchors
    from object_detection_cib_torch.models.yolov5 import build_network

    net = build_network(len(val.classes), "n", device="cpu", seed=2)
    ev = Evaluator(net, default_anchors(), val.classes, batch_size=3, device="cpu", conf_thres=0.0005)
    cache = ValDeviceCache(val, range(len(val.samples)), S, MAXT, fake_mode=fake, root_dir=root)
    ds = tpl.DetectionDataset(val, _CanvasReader(cache, val), ValidationSampleAugmentor())
    feed = tpl.Prefetcher(ds, 3, MAXT, num_threads=2, drop_last=False, device=None)
    want = ev.validate(cache)
    got = ev.validate_batches(feed)
    assert got == want
    assert set(got) >= {"map", "map50"} and all(np.isfinite(v) for v in got.values())
    assert got["map"] > 0  # detections to score: the comparison is not of two empty dicts
    if not fake:  # the reader's own decode gives canvases of the same geometry
        reader = SampleReader(S, val.classes, root_dir=root)
        for j, s in enumerate(val.samples):
            r = reader(s)
            assert r.image.shape == cache.canvases[j].shape
            np.testing.assert_allclose(r.bboxes, cache.gt_boxes[j][cache.gt_mask[j]], atol=1e-4)


FEEDS = {
    "device_cache": dict(pipeline="device"),
    "host_fed": dict(pipeline="device", device_cache=False, enable_ram_cache=True),
    "host": dict(pipeline="host", num_workers=2),
}


@pytest.mark.parametrize("feed", list(FEEDS))
def test_tiny_trainer_trains_from_jpegs(jpegs, feed):
    root, train, val = jpegs
    t = Trainer(train, val, size="n", image_size=S, batch_size=B, dtype=None, device="cpu",
                root_dir=root, max_epochs=1, max_targets=MAXT, **FEEDS[feed])
    before = [p.detach().clone() for p in t.net.parameters()]
    m = t.fit(epoch_steps=2)
    em = t.epoch_metrics[-1]
    assert len(em["total"]) == 2 and np.isfinite(em["total"]).all()
    assert sum(not torch.equal(a, b) for a, b in zip(before, t.net.parameters())) > 0
    assert all(np.isfinite(v) for v in m.values())
    assert (t.val_cache is None) == (feed != "device_cache")
    assert t.fake_mode is False
    with pytest.raises(ValueError, match="horizon"):
        t.fit(max_epochs=2)
    assert t.sampler_stats(2) is not None


def test_trainer_arguments_are_checked(jpegs):
    root, train, val = jpegs
    kw = dict(size="n", image_size=S, batch_size=B, dtype=None, device="cpu", root_dir=root)
    with pytest.raises(ValueError, match="set once"):
        Trainer(train, val, optimizer=topt.OptimizerConfig(max_epochs=10), max_epochs=3, **kw)
    with pytest.raises(ValueError, match="pipeline must be"):
        Trainer(train, val, pipeline="tpu", **kw)
    with pytest.raises(ValueError, match="train_augmentor"):
        Trainer(train, val, train_augmentor=ValidationSampleAugmentor(), **kw)
    fake = t_manifest(num_images=8, num_classes=3, image_size=S, seed=0)
    assert Trainer(fake, fake, pipeline="host", num_workers=1, **kw).fake_mode  # named fake*


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_lr_horizon_is_the_trainers_max_epochs(schedule):
    """C1: three epochs decay the lr over three epochs, not over 300."""
    info = t_manifest(num_images=8, num_classes=3, image_size=S, seed=0)
    cfg = topt.OptimizerConfig(schedule=schedule, warmup=None)
    t = Trainer(info, info, size="n", image_size=S, batch_size=B, dtype=None, device="cpu",
                optimizer=cfg, max_epochs=3)
    assert t.optimizer.config.max_epochs == 3
    t.fit()
    assert t.epoch == 3 and len(t.epoch_metrics) == 3
    jsgd = jopt.SmartSGD(jopt.OptimizerConfig(schedule=schedule, warmup=None, max_epochs=3),
                         steps_per_epoch=t.steps_per_epoch)
    for e, em in enumerate(t.epoch_metrics):
        want = [np.float32(jsgd.hyperparams(jnp.asarray(e * t.steps_per_epoch + i, jnp.int32))[1])
                for i in range(t.steps_per_epoch)]
        np.testing.assert_array_equal(em["lr"], np.asarray(want, np.float32))
    assert t.epoch_metrics[-1]["lr"][0] < t.epoch_metrics[0]["lr"][0]
    assert t.fit() == {}  # at the horizon: nothing left to train


def _dropped_by_hand(info, root, feed, epochs):
    """Per epoch, the valid targets beyond ``max_targets`` in that epoch's
    batches, counted on the host from a twin feed of the same seed whose
    capacity drops nothing."""
    big = 4096
    if feed == "host":
        from object_detection_cib_torch.data.host_augment import TrainSampleAugmentor
        ds = tpl.DetectionDataset(info, SampleReader(S, info.classes, root_dir=root),
                                  TrainSampleAugmentor(TAug()), use_mosaic=True,
                                  mosaic_target_size=S, seed=0)
        pf = tpl.Prefetcher(ds, B, big, sampler=tsamplers.ShuffleSampler(info, seed=0),
                            num_threads=1, device="cpu")
        per_epoch = [[b.mask.sum(1) for b in pf] for _ in range(epochs)]
    else:
        twin = tdp.DeviceDataPipeline(info, S, B, TAug(), max_targets=big, seed=0, device="cpu",
                                      root_dir=root, fake_mode=False, device_cache=feed == "device_cache",
                                      feed_dtype=torch.float32)
        per_epoch = [[b.mask.sum(1) for b, _ in twin.epoch()] for _ in range(epochs)]
    return [int(sum((torch.clamp(n - 6, min=0)).sum() for n in rows)) for rows in per_epoch]


@pytest.mark.parametrize("feed", list(FEEDS))
def test_fit_records_targets_dropped_per_epoch(jpegs, feed):
    """C2: the overflow comes back with the losses, once per epoch, and the
    pipeline keeps no device scalar pending."""
    root, train, val = jpegs
    kw = dict(FEEDS[feed])
    if feed == "host":
        kw["num_workers"] = 1  # the dataset's stream is reproducible with one thread
    t = Trainer(train, val, size="n", image_size=S, batch_size=B, dtype=None, device="cpu",
                root_dir=root, max_epochs=3, max_targets=6, **kw)
    t.fit()
    want = _dropped_by_hand(train, root, feed, 3)
    got = [int(em["targets_dropped"]) for em in t.epoch_metrics]
    assert got == want and sum(got) > 0
    if t.pipeline is not None:
        assert len(t.pipeline._overflow_pending) == 0
        assert t.pipeline.overflow_total == sum(want)
    else:
        assert t.prefetcher.overflow_total == sum(want)
