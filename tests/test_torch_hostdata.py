"""Port parity: the host data modules (numpy, cv2 and Pillow on the host).

``data/{synthetic,reader,host_augment,augmentor,pipeline}.py`` of the port
are copies of the JAX package's; the same seed goes through both in one
process. Everything here is exact: byte-identical JPEG files and equal
manifests, equal arrays from the reader, from every host augmentation and
from both augmentor chains, the same ``DetectionDataset`` items over two
epochs, and ``collate_fixed`` batches whose images, normalized as the
device does it (``u8.float() / 255.0``), are bitwise the JAX package's f32
host division. ``Prefetcher`` runs with one thread: the dataset shares its
generators across threads (in both packages), so only one thread gives a
reproducible stream.
"""

import numpy as np
import pytest
import torch

from object_detection_cib_torch.data import augmentor as t_albu
from object_detection_cib_torch.data import host_augment as tha
from object_detection_cib_torch.data import pipeline as tpl
from object_detection_cib_torch.data import reader as trd
from object_detection_cib_torch.data import samplers as tsamplers
from object_detection_cib_torch.data.synthetic import build_synthetic_dataset as t_build
from object_detection_cib_tpu.data import augmentor as j_albu
from object_detection_cib_tpu.data import host_augment as jha
from object_detection_cib_tpu.data import pipeline as jpl
from object_detection_cib_tpu.data import reader as jrd
from object_detection_cib_tpu.data import samplers as jsamplers
from object_detection_cib_tpu.data.synthetic import build_synthetic_dataset as j_build

S = 64


def _strip(info):
    """A manifest without its build time."""
    return info._replace(date=None)


def _same_sample(a, b):
    np.testing.assert_array_equal(a.image, b.image)
    assert a.image.dtype == b.image.dtype
    np.testing.assert_array_equal(a.bboxes, b.bboxes)
    assert a.bboxes.dtype == b.bboxes.dtype
    np.testing.assert_array_equal(a.labels, b.labels)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A hard synthetic corpus written by the port (byte-identical to JAX's)."""
    root = tmp_path_factory.mktemp("syn")
    info = t_build(root, "synthetic-hard-zipf", num_classes=4, num_images=16, image_size=80, seed=3)
    return root, info


@pytest.mark.parametrize("name,size", [("synthetic-zipf", 64), ("synthetic-hard-zipf", 96),
                                       ("synthetic-hard-zipf-val", 72)])
def test_build_synthetic_dataset_matches_jax(tmp_path, name, size):
    kw = dict(name=name, num_images=12, image_size=size, seed=5, path_prefix="pre")
    ti = t_build(tmp_path / "t", **kw)
    ji = j_build(tmp_path / "j", **kw)
    assert _strip(ti) == _strip(ji)
    files = sorted((tmp_path / "t" / name).iterdir())
    assert len(files) == 12
    for f in files:
        assert f.read_bytes() == (tmp_path / "j" / name / f.name).read_bytes(), f.name
    assert ti.samples[0].image_path == f"pre/{name}/img_00000.jpg"


@pytest.mark.parametrize("letter_box", [True, False])
@pytest.mark.parametrize("fake", [False, True])
def test_reader_matches_jax(corpus, letter_box, fake):
    root, info = corpus
    classes = info.classes
    tr = trd.SampleReader(S, classes, fake_mode=fake, root_dir=root)
    jr = jrd.SampleReader(S, classes, fake_mode=fake, root_dir=root)
    for s in info.samples[:6]:
        img_t = trd.read_image(root, s, fake)
        np.testing.assert_array_equal(img_t, jrd.read_image(root, s, fake))
        boxes = np.asarray([[1.5, 2.0, 30.0, 41.0], [0.0, 0.0, 79.0, 79.0]], np.float32)
        for fn in ("longest_max_size",):
            a, ab = getattr(trd, fn)(img_t, boxes, S)
            b, bb = getattr(jrd, fn)(img_t, boxes, S)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ab, bb)
        a, ab = trd.letterbox_pad(img_t[:50, :37], boxes, S)
        b, bb = jrd.letterbox_pad(img_t[:50, :37], boxes, S)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ab, bb)
        _same_sample(tr(s, letter_box), jr(s, letter_box))


def _samples(seed, n=4, size=S, max_boxes=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(size // 2, size + 1)), int(rng.integers(size // 2, size + 1))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        k = int(rng.integers(0, max_boxes + 1))
        xy = rng.uniform(0, min(h, w) / 2, (k, 2))
        wh = rng.uniform(2, min(h, w) / 2, (k, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        out.append((img, boxes, rng.integers(0, 3, k).astype(np.int64)))
    return out


def _pair(seed, n=4, size=S):
    raw = _samples(seed, n, size)
    return [tha.AugmentedSample(*r) for r in raw], [jha.AugmentedSample(*r) for r in raw]


def _affine(mod, general):
    if general:
        return mod.AffineParams(degrees=10.0, translate=0.1, scale=0.5, shear=2.0, perspective=5e-4)
    return mod.AffineParams()


HOST_FUNCS = ["box_candidates", "mosaic4_random", "mosaic4_center", "sample_affine_values",
              "affine_matrix", "transform_boxes", "transform_boxes_perspective",
              "random_perspective", "random_perspective_general", "augment_hsv",
              "random_color_transforms", "horizontal_flip", "mixup"]


@pytest.mark.parametrize("fn", HOST_FUNCS)
@pytest.mark.parametrize("seed", [0, 1])
def test_host_augment_function_matches_jax(fn, seed):
    ts, js = _pair(seed)
    rt, rj = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    if fn == "box_candidates":
        a = np.random.default_rng(seed).uniform(0, 60, (4, 9))
        b = a + np.random.default_rng(seed + 1).uniform(-3, 3, (4, 9))
        np.testing.assert_array_equal(tha.box_candidates(a, b), jha.box_candidates(a, b))
    elif fn.startswith("mosaic4"):
        center = (70, 50) if fn.endswith("center") else None
        (a, ba), (b, bb) = tha.mosaic4(ts, S, rt, center), jha.mosaic4(js, S, rj, center)
        _same_sample(a, b)
        assert ba == bb
    elif fn == "sample_affine_values":
        for general in (False, True):
            assert (tuple(tha.sample_affine_values(_affine(tha, general), rt))
                    == tuple(jha.sample_affine_values(_affine(jha, general), rj)))
    elif fn == "affine_matrix":
        v = jha.sample_affine_values(_affine(jha, True), rj)
        for border in ((0, 0), (-32, -32)):
            a = tha.affine_matrix(tha.AffineValues(*v), 2 * S, 2 * S, border)
            b = jha.affine_matrix(v, 2 * S, 2 * S, border)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
    elif fn.startswith("transform_boxes"):
        persp = fn.endswith("perspective")
        v = jha.sample_affine_values(_affine(jha, persp), rj)
        M, w, h = jha.affine_matrix(v, 2 * S, 2 * S, (-32, -32))
        boxes = ts[0].bboxes if len(ts[0].bboxes) else np.asarray([[1, 2, 30, 40]], np.float32)
        np.testing.assert_array_equal(tha.transform_boxes(boxes, M, w, h, persp),
                                      jha.transform_boxes(boxes, M, w, h, persp))
    elif fn.startswith("random_perspective"):
        general = fn.endswith("general")
        v = jha.sample_affine_values(_affine(jha, general), rj)
        for border in ((0, 0), (-S // 2, -S // 2)):
            _same_sample(tha.random_perspective(ts[1], tha.AffineValues(*v), border),
                         jha.random_perspective(js[1], v, border))
    elif fn == "augment_hsv":
        for p in (tha.HSVParams(), tha.HSVParams(0.5, 0.9, 0.9), tha.HSVParams.no_aug()):
            np.testing.assert_array_equal(tha.augment_hsv(ts[2].image, p, rt),
                                          jha.augment_hsv(js[2].image, jha.HSVParams(*p), rj))
    elif fn == "random_color_transforms":
        for p in (1.0, 0.5, 0.01):
            np.testing.assert_array_equal(tha.random_color_transforms(ts[3].image, rt, p),
                                          jha.random_color_transforms(js[3].image, rj, p))
    elif fn == "horizontal_flip":
        for a, b in zip(ts, js):
            _same_sample(tha.horizontal_flip(a), jha.horizontal_flip(b))
    else:
        ts, js = _pair(seed, size=S)
        same = [t._replace(image=np.resize(t.image, (S, S, 3))) for t in ts]
        jsame = [j._replace(image=np.resize(j.image, (S, S, 3))) for j in js]
        _same_sample(tha.mixup(same[0], same[1], rt), jha.mixup(jsame[0], jsame[1], rj))


@pytest.mark.parametrize("recipe", ["default", "color_transforms", "general_affine", "no_aug"])
def test_train_sample_augmentor_matches_jax(recipe):
    def params(mod):
        return {"default": mod.AugParams(),
                "color_transforms": mod.AugParams(image_color_transforms=True),
                "general_affine": mod.AugParams(affine_params=_affine(mod, True)),
                "no_aug": mod.AugParams.no_aug()}[recipe]

    ta, ja = tha.TrainSampleAugmentor(params(tha), rng_seed=7), jha.TrainSampleAugmentor(params(jha), rng_seed=7)
    ts, js = _pair(4, n=6)
    for a, b in zip(ts, js):
        border = (-S // 4, -S // 4)
        _same_sample(ta(a, border), ja(b, border))
    _same_sample(tha.ValidationSampleAugmentor()(ts[0]), jha.ValidationSampleAugmentor()(js[0]))


ALBU = ["BlurAugmentation", "MedianBlurAugmentation", "ToGrayAugmentation", "CLAHEAugmentation",
        "HSVAugmentation", "HorizontalFlipAugmentation"]


@pytest.mark.parametrize("name", ALBU + ["composed"])
def test_albu_augmentor_matches_jax(name):
    names = ALBU if name == "composed" else [name]
    p = 0.6 if name == "composed" else 1.0
    ta = t_albu.TrainSampleAugmentor([getattr(t_albu, n)(p=p) for n in names], seed=3)
    ja = j_albu.TrainSampleAugmentor([getattr(j_albu, n)(p=p) for n in names], seed=3)
    ts, js = _pair(6, n=6)
    for a, b in zip(ts, js):
        _same_sample(ta(a), ja(b))


# ------------------------------------------------------- dataset and collate

DATASETS = {
    "mosaic": dict(use_mosaic=True),
    "mosaic_mixup": dict(use_mosaic=True, mixup_prob=0.5),
    "class_aware_mixup": dict(use_mosaic=True, mixup_prob=0.5, sampler="class_aware"),
    "repeat_factor": dict(use_mosaic=True, sampler="repeat_factor"),
    "no_mosaic": dict(use_mosaic=False),
    "no_mosaic_ram_cache": dict(use_mosaic=False, enable_ram_cache=True),
    "mosaic_ram_cache_fake": dict(use_mosaic=True, enable_ram_cache=True, fake=True),
}


def _datasets(corpus, recipe, seed=2):
    root, info = corpus
    kw = dict(DATASETS[recipe])
    sampler = kw.pop("sampler", None)
    fake = kw.pop("fake", False)
    out = []
    for rd, ha, pl, sm in ((trd, tha, tpl, tsamplers), (jrd, jha, jpl, jsamplers)):
        smp = None
        if sampler == "class_aware":
            smp = sm.ClassAwareSampler(info, seed=0)
        elif sampler == "repeat_factor":
            smp = sm.RepeatFactorSampler(info)
        out.append(pl.DetectionDataset(
            info, rd.SampleReader(S, info.classes, fake_mode=fake, root_dir=root),
            ha.TrainSampleAugmentor(ha.AugParams(), rng_seed=9), mosaic_target_size=S,
            sampler=smp, seed=seed, **kw))
    return out


@pytest.mark.parametrize("recipe", list(DATASETS))
def test_detection_dataset_matches_jax_over_two_epochs(corpus, recipe):
    td, jd = _datasets(corpus, recipe)
    assert len(td) == len(jd) == 16
    for epoch in range(2):
        order = np.random.default_rng(epoch).permutation(len(td))
        for i in order:
            a, b = td[int(i)], jd[int(i)]
            _same_sample(a, b)
            assert a.image.dtype == np.uint8
    assert td.pyrng.getstate() == jd.pyrng.getstate()


def test_detection_dataset_refuses_mixup_without_mosaic(corpus):
    root, info = corpus
    with pytest.raises(ValueError, match="mixup requires mosaic"):
        tpl.DetectionDataset(info, trd.SampleReader(S, info.classes, root_dir=root),
                             tha.ValidationSampleAugmentor(), mixup_prob=0.5)


@pytest.mark.parametrize("max_targets", [3, 40])
def test_collate_fixed_matches_jax(corpus, max_targets):
    td, jd = _datasets(corpus, "mosaic_mixup")
    items = [(td[i], jd[i]) for i in range(5)]
    tb, tovf = tpl.collate_fixed([a for a, _ in items], max_targets)
    jb, jovf = jpl.collate_fixed([b for _, b in items], max_targets)
    assert tb.images.dtype == torch.uint8 and tb.images.shape == (5, S, S, 3)
    up = tpl.upload(tb, torch.device("cpu"))
    assert up.images.dtype == torch.float32
    np.testing.assert_array_equal(up.images.numpy(), np.asarray(jb.images))  # bitwise
    for name in ("boxes", "labels", "mask"):
        got, want = getattr(up, name).numpy(), np.asarray(getattr(jb, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)
    assert tovf == jovf
    assert (tovf > 0) == (max_targets == 3)
    assert tpl.upload(tb, torch.device("cpu"), torch.bfloat16).images.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="uint8"):
        tpl.collate_fixed([items[0][0]._replace(image=items[0][0].image.astype(np.float32))], 4)


@pytest.mark.parametrize("drop_last", [True, False])
def test_prefetcher_matches_jax(corpus, drop_last):
    td, jd = _datasets(corpus, "class_aware_mixup")
    root, info = corpus
    kw = dict(num_threads=1, drop_last=drop_last)
    tp = tpl.Prefetcher(td, 3, 4, sampler=tsamplers.ShuffleSampler(info, seed=1), device="cpu", **kw)
    jp = jpl.Prefetcher(jd, 3, 4, sampler=jsamplers.ShuffleSampler(info, seed=1), **kw)
    assert len(tp) == len(jp) == (5 if drop_last else 6)
    for epoch in range(2):
        got, want = list(tp), list(jp)
        assert len(got) == len(want) == len(tp)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.images.numpy(), np.asarray(b.images))
            np.testing.assert_array_equal(a.boxes.numpy(), np.asarray(b.boxes))
            np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))
            np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        assert tp.overflow_total == jp.overflow_total > 0
        np.testing.assert_array_equal(tp.consumed_plan_log[-1], jp.consumed_plan_log[-1])
    assert len(tp.consumed_plan_log) == 2


def test_prefetcher_host_batches_and_worker_errors(corpus):
    root, info = corpus
    ds = tpl.DetectionDataset(info, trd.SampleReader(S, info.classes, root_dir=root),
                              tha.ValidationSampleAugmentor())
    host = list(tpl.Prefetcher(ds, 5, 8, num_threads=2, drop_last=False, device=None))
    assert [b.images.shape[0] for b in host] == [5, 5, 5, 1]
    assert all(b.images.dtype == torch.uint8 for b in host)

    class Broken(tpl.DetectionDataset):
        def __getitem__(self, idx):
            if idx == 7:
                raise RuntimeError("worker failed on item 7")
            return super().__getitem__(idx)

    bad = Broken(info, trd.SampleReader(S, info.classes, root_dir=root), tha.ValidationSampleAugmentor())
    it = iter(tpl.Prefetcher(bad, 4, 8, num_threads=3, device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="item 7"):
        list(it)
    # a consumer that stops early lets the producer go
    pf = tpl.Prefetcher(ds, 2, 8, num_threads=1, prefetch=1, device="cpu")
    first = iter(pf)
    next(first)
    first.close()
    assert pf.overflow_total == 0


def test_to_unit_is_the_jax_host_division():
    from object_detection_cib_torch.utils.device import to_unit

    want = np.arange(256).astype(np.float32) / 255.0  # jax data/pipeline.py:132
    for dt in (torch.uint8, torch.bfloat16, torch.float32):
        got = to_unit(torch.arange(256).to(dt))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
