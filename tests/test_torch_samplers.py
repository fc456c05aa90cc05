"""Port parity: the imbalance-aware samplers and the two small data modules.

The port's ``data/samplers.py``, ``data/filter.py`` and ``data/enums.py`` are
copies of the JAX package's numpy-only modules over the port's own
``data/cache.py``. Everything here is exact: the same seed gives the same
index stream, number for number, over three consecutive epochs, and the
attributes the pipeline reads for mosaic co-sampling (``sampler_indices``,
``image_repeat_factors``) are equal.
"""

import numpy as np
import pytest

from object_detection_cib_torch.data import enums as t_enums
from object_detection_cib_torch.data import samplers as ts
from object_detection_cib_torch.data.filter import filter_dataset as t_filter
from object_detection_cib_torch.data.synthetic import build_fake_manifest as t_manifest
from object_detection_cib_tpu.data import enums as j_enums
from object_detection_cib_tpu.data import samplers as js
from object_detection_cib_tpu.data.filter import filter_dataset as j_filter
from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest

MANIFEST = dict(num_images=60, num_classes=6, image_size=64, seed=4, zipf_a=1.01)

SAMPLERS = {
    "class_aware_seed0": ("ClassAwareSampler", dict(seed=0)),
    "class_aware_seed7": ("ClassAwareSampler", dict(seed=7)),
    "repeat_factor_default": ("RepeatFactorSampler", dict()),
    "repeat_factor_max": ("RepeatFactorSampler", dict(reduction="max")),
    "repeat_factor_mean_no_sqrt": ("RepeatFactorSampler", dict(reduction="mean", use_sqrt=False,
                                                                threshold=0.5)),
    "shuffle_seed3": ("ShuffleSampler", dict(seed=3)),
}


def _pair(kind):
    cls, kw = SAMPLERS[kind]
    return (getattr(js, cls)(j_manifest(**MANIFEST), **kw),
            getattr(ts, cls)(t_manifest(**MANIFEST), **kw))


@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_three_epochs_equal_jax(kind):
    j, t = _pair(kind)
    assert len(j) == len(t) == MANIFEST["num_images"]
    for _ in range(3):
        want, got = np.asarray(j.epoch_indices()), np.asarray(t.epoch_indices())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        # the class-aware sampler replaces its co-sampling pool every epoch
        assert getattr(t, "sampler_indices", None) == getattr(j, "sampler_indices", None)
    assert got.min() >= 0 and got.max() < MANIFEST["num_images"]


@pytest.mark.parametrize("kind", ["repeat_factor_default", "repeat_factor_max",
                                  "repeat_factor_mean_no_sqrt"])
def test_repeat_factors_equal_jax(kind):
    j, t = _pair(kind)
    assert t.class_repeat_factor == j.class_repeat_factor
    assert t.image_repeat_factors == j.image_repeat_factors
    assert min(t.image_repeat_factors) > 0
    # the long tail is drawn more often than the head
    head, tail = t.dataset_info.classes[0], t.dataset_info.classes[-1]
    assert t.class_repeat_factor[tail] > t.class_repeat_factor[head]
    np.testing.assert_array_equal(np.asarray(list(iter(t))), np.asarray(list(iter(j))))


def test_class_aware_is_flatter_than_the_corpus():
    info = t_manifest(**MANIFEST)
    counts = info.get_instance_count()
    sampler = ts.ClassAwareSampler(info, seed=0)
    drawn = {c: 0 for c in info.classes}
    for i in np.concatenate([sampler.epoch_indices() for _ in range(3)]):
        for t in info.samples[int(i)].targets:
            drawn[t.class_name] += 1
    populated = [c for c in info.classes if counts[c]]
    ratio = lambda d: max(d[c] for c in populated) / min(d[c] for c in populated)
    assert ratio(drawn) < ratio(counts)
    assert list(iter(sampler)) == sampler.sampler_indices


def test_class_aware_skips_empty_classes():
    info = t_manifest(num_images=12, num_classes=3, image_size=64, seed=1)
    info = info._replace(classes=info.classes + ["never_seen"])
    jinfo = j_manifest(num_images=12, num_classes=3, image_size=64, seed=1)
    jinfo = jinfo._replace(classes=jinfo.classes + ["never_seen"])
    t, j = ts.ClassAwareSampler(info, seed=5), js.ClassAwareSampler(jinfo, seed=5)
    assert sorted(t.per_class_cycles) == sorted(j.per_class_cycles) == [0, 1, 2]
    np.testing.assert_array_equal(t.epoch_indices(), j.epoch_indices())


def test_random_cycle_fixed_and_shards_equal_jax():
    data = [5, 9, 2, 7]
    t = ts.RandomCycleSampler(data, np.random.default_rng(11))
    j = js.RandomCycleSampler(data, np.random.default_rng(11))
    assert len(t) == len(j) == 4 and iter(t) is t
    got = [next(t) for _ in range(14)]
    assert got == [next(j) for _ in range(14)]
    for k in range(0, 12, 4):  # every full pass is a permutation
        assert sorted(got[k:k + 4]) == sorted(data)
    idx = np.arange(17) * 3
    fixed = ts.FixedSampler(idx)
    assert len(fixed) == 17
    np.testing.assert_array_equal(fixed.epoch_indices(), js.FixedSampler(idx).epoch_indices())
    np.testing.assert_array_equal(fixed.epoch_indices(), fixed.epoch_indices())
    for host in range(4):
        np.testing.assert_array_equal(ts.shard_indices(idx, host, 4), js.shard_indices(idx, host, 4))
    np.testing.assert_array_equal(np.sort(np.concatenate([ts.shard_indices(idx, h, 4) for h in range(4)])),
                                  idx)


def test_filter_and_enums_equal_jax():
    tinfo, jinfo = t_manifest(**MANIFEST), j_manifest(**MANIFEST)
    keep = tinfo.classes[1:3]
    got, want = t_filter(tinfo, "kept", keep), j_filter(jinfo, "kept", keep)
    assert got.name == want.name == "kept" and got.classes == want.classes == keep
    assert [s.id for s in got.samples] == [s.id for s in want.samples]
    assert [[tuple(t.bounding_box) + (t.class_name,) for t in s.targets] for s in got.samples] == \
        [[tuple(t.bounding_box) + (t.class_name,) for t in s.targets] for s in want.samples]
    assert 0 < len(got.samples) < len(tinfo.samples)
    with pytest.raises(ValueError, match="not in the original"):
        t_filter(tinfo, "bad", ["no_such_class"])
    assert {m.name: m.value for m in t_enums.DatasetName} == \
        {m.name: m.value for m in j_enums.DatasetName}
