"""Port parity: the eval step end to end, the val cache, and the mAP evaluator.

The eval step runs from converted weights in f32 on the CPU (the plain NMS
mask). Decoded detections are compared within the forward's tolerance
carried through decode; the NMS stage is compared EXACTLY on shared inputs
(JAX's decoded detections into both). The end-to-end NMS outputs are not
compared element by element: a 1e-6 difference in a decoded score may
legitimately reorder two near-tied candidates, and then a different box of
the pair survives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.core.nms import NMSResult as TNMSResult
from object_detection_cib_torch.core.nms import non_max_suppression as t_nms
from object_detection_cib_torch.core.types import default_anchors as t_anchors
from object_detection_cib_torch.data.synthetic import build_fake_manifest as t_manifest
from object_detection_cib_torch.data.val_cache import ValDeviceCache as TCache
from object_detection_cib_torch.eval.coco_map import MeanAveragePrecisionEvaluator as TEval
from object_detection_cib_torch.eval.decode import decode_predictions as t_decode
from object_detection_cib_torch.models.convert import flax_to_torch
from object_detection_cib_torch.models.yolov5 import build_network as t_build
from object_detection_cib_torch.train.steps import make_eval_step as t_make_eval_step
from object_detection_cib_torch.train.trainer import Evaluator
from object_detection_cib_tpu.core.nms import NMSResult as JNMSResult
from object_detection_cib_tpu.core.nms import non_max_suppression as j_nms
from object_detection_cib_tpu.core.types import default_anchors as j_anchors
from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest
from object_detection_cib_tpu.data.val_cache import ValDeviceCache as JCache
from object_detection_cib_tpu.eval.coco_map import MeanAveragePrecisionEvaluator as JEval
from object_detection_cib_tpu.eval.decode import decode_predictions as j_decode
from object_detection_cib_tpu.models.yolov5 import build_network as j_build
from object_detection_cib_tpu.train.steps import make_eval_step as j_make_eval_step

NC, IMG, BATCH = 3, 64, 2


@pytest.fixture(scope="module")
def models():
    jnet = j_build(NC, "n")
    variables = jax.jit(lambda k, x: jnet.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, IMG, IMG, 3))
    )
    variables = jax.tree.map(np.asarray, variables)
    tnet = t_build(NC, "n", device="cpu")
    tnet.load_state_dict(flax_to_torch(variables), strict=True)
    return jnet, variables, tnet


def test_eval_step_matches_jax(models):
    jnet, variables, tnet = models
    images = np.random.default_rng(2).random((BATCH, IMG, IMG, 3), np.float32)

    out_j = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, images)
    det_j = np.asarray(j_decode(out_j, j_anchors()))
    with torch.no_grad():
        det_t = t_decode(tnet.eval()(torch.from_numpy(images)), t_anchors()).numpy()
    # the forward's tolerance (atol/rtol 1e-4), here on decoded pixels/scores
    np.testing.assert_allclose(det_t, det_j, atol=1e-4, rtol=1e-4)

    # NMS stage exactly, on JAX's decoded detections
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=2048)
    want = j_nms(jnp.asarray(det_j), impl="xla", **kw)
    got = t_nms(torch.from_numpy(det_j.copy()), **kw)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6, rtol=0)
    assert int(got.num_valid.min()) > 0

    # the steps themselves: same shapes and dtypes, and the same count of
    # survivors up to near-tie reorderings
    res_j = jax.jit(j_make_eval_step(jnet, j_anchors()))(
        variables["params"], variables["batch_stats"], images
    )
    res_t = t_make_eval_step(tnet, t_anchors())(torch.from_numpy(images))
    for a, b in zip(res_t, res_j):
        assert tuple(a.shape) == b.shape
        assert a.numpy().dtype == np.asarray(b).dtype
    np.testing.assert_allclose(res_t.num_valid.numpy(), np.asarray(res_j.num_valid), atol=3)


def test_val_cache_matches_jax():
    kw = dict(num_classes=4, num_images=7, image_size=80, seed=3, zipf_a=1.01)
    ti, ji = t_manifest(**kw), j_manifest(**kw)
    assert ti.classes == ji.classes
    assert [tuple(s) for s in ti.samples] == [tuple(s) for s in ji.samples]
    tc = TCache(ti, np.arange(7), 64, 16, fake_mode=True)
    jc = JCache(ji, np.arange(7), 64, 16, fake_mode=True)
    for name in ("canvases", "gt_boxes", "gt_labels", "gt_mask", "indices"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name), err_msg=name)
    assert len(tc) == len(jc) == 7


def _synthetic_results(cache, seed, max_det=20):
    """NMS-shaped detections near the GT (jittered), plus false positives."""
    rng = np.random.default_rng(seed)
    n = len(cache)
    boxes = np.zeros((n, max_det, 4), np.float32)
    scores = np.zeros((n, max_det), np.float32)
    classes = np.full((n, max_det), -1, np.int32)
    valid = np.zeros((n, max_det), bool)
    for i in range(n):
        gt = cache.gt_boxes[i][cache.gt_mask[i]]
        gl = cache.gt_labels[i][cache.gt_mask[i]]
        k = min(len(gt) + 3, max_det)
        for d in range(k):
            if d < len(gt):
                boxes[i, d] = gt[d] + rng.normal(0, 2.0, 4)
                classes[i, d] = gl[d] if rng.random() < 0.8 else (gl[d] + 1) % 4
            else:
                xy = rng.uniform(0, 48, 2)
                boxes[i, d] = np.concatenate([xy, xy + rng.uniform(4, 16, 2)])
                classes[i, d] = rng.integers(0, 4)
            scores[i, d] = rng.uniform(0.05, 1.0)
            valid[i, d] = True
    return boxes, scores, classes, valid, valid.sum(1).astype(np.int32)


def test_map_evaluator_matches_jax():
    info = t_manifest(num_classes=4, num_images=12, image_size=64, seed=4)
    cache = TCache(info, np.arange(12), 64, 16, fake_mode=True)
    fields = _synthetic_results(cache, 5)
    te, je = TEval(4, class_names=info.classes), JEval(4, class_names=info.classes)
    for lo, hi in ((0, 7), (7, 12)):
        sl = slice(lo, hi)
        gt = (cache.gt_boxes[sl], cache.gt_labels[sl], cache.gt_mask[sl])
        te.add_batch(TNMSResult(*(f[sl] for f in fields)), *gt)
        je.add_batch(JNMSResult(*(f[sl] for f in fields)), *gt)
    got, want = te.results_dict(), je.results_dict()
    assert got == want
    assert got["map"] > 0.1


def test_evaluator_validate_and_predict(models):
    """Evaluator.validate == the JAX evaluator fed the same blocks' results."""
    _, _, tnet = models
    info = t_manifest(num_classes=NC, num_images=11, image_size=IMG, seed=6)
    cache = TCache(info, np.arange(11), IMG, 16, fake_mode=True)
    ev = Evaluator(tnet, t_anchors(), info.classes, batch_size=4, device="cpu")
    ref = JEval(NC, class_names=info.classes)
    n_rows = []
    for bi, res in ev.run_blocks(cache):
        rows = res.boxes.shape[0]
        n_rows.append(rows)
        sl = slice(bi * 4, bi * 4 + rows)
        ref.add_batch(JNMSResult(*res), cache.gt_boxes[sl], cache.gt_labels[sl], cache.gt_mask[sl])
    assert n_rows == [4, 4, 3]
    metrics = ev.validate(cache)
    assert metrics == ref.results_dict()
    assert all(np.isfinite(v) for v in metrics.values())
    preds = ev.predict(cache)
    assert len(preds) == 11
    assert all(set(p) == {"boxes", "scores", "classes"} for p in preds)
    assert all(c in info.classes for p in preds for c in p["classes"])
