"""Port parity: ``test_utils`` (the VOC anchors, ``get_test_sample`` and
``get_test_batch``) against the JAX package's, array for array, exact. Both
fake readers seed an image by ``hash`` of its id, the same for both packages
in one process."""

import jax
import numpy as np
import pytest

from object_detection_cib_torch import test_utils as tu
from object_detection_cib_tpu import test_utils as ju


def test_voc_anchors_match_jax():
    for t, j in zip(tu.voc_anchors().levels(), ju.voc_anchors().levels(), strict=True):
        assert t.stride == j.stride
        np.testing.assert_array_equal(t.as_array(), j.as_array())
    for name in ("VOC_BOXES_LL", "VOC_BOXES_ML", "VOC_BOXES_HL"):
        assert tuple(getattr(tu, name).boxes_wh) == tuple(getattr(ju, name).boxes_wh)


@pytest.mark.parametrize("image_size,seed", [(416, 0), (64, 3)])
def test_get_test_sample_matches_jax(image_size, seed):
    t, j = tu.get_test_sample(image_size, seed=seed), ju.get_test_sample(image_size, seed=seed)
    assert t._fields == j._fields
    for name in t._fields:
        np.testing.assert_array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)), err_msg=name)


@pytest.mark.parametrize("batch_size,max_targets", [(2, 40), (5, 3)])
def test_get_test_batch_matches_jax(batch_size, max_targets):
    t = tu.get_test_batch(batch_size, image_size=64, max_targets=max_targets, seed=1)
    j = ju.get_test_batch(batch_size, image_size=64, max_targets=max_targets, seed=1)
    for name in j._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(jax.device_get(getattr(j, name))),
                                      err_msg=name)
