"""Port parity: validation at trained weights, the whole path from the
network through decode, NMS and matching to the mAP dict.

At random weights a detector finds almost nothing, so the mAP path is
compared there on next to no true positives. Here the JAX package trains
yolov5n (nc=3, 64 px, f32, SmartSGD at lr0 0.03 without warm-up) for 150
steps on the eight images of a ``build_fake_manifest`` validation cache
(fake content, the cache's own boxes), until it finds them: its mAP at 0.5
must reach 0.1 first, so the comparison cannot pass on empty results. The
weights are converted into the port, and the two validate the same
``ValDeviceCache`` in blocks of four: JAX by its jitted ``make_eval_step``
into ``MeanAveragePrecisionEvaluator``, the port by ``Evaluator.validate``.

Tolerances:
  * per-image survivor counts within 3, as ``test_eval_step_matches_jax``
    allows: a score that differs by an ulp may reorder two near-tied
    candidates, and then a different box of the pair survives;
  * every key of the mAP dict within 0.02 absolute. One such reordering
    can swap which detection is matched to a ground-truth box: that moves
    one class's AP at one IoU threshold by up to 1 / (its boxes) on the
    precision envelope, and ``map`` averages ten thresholds over three
    classes, so one swap moves ``map`` by less than 0.02 and a per-class
    AP at 0.5 by more. The per-class keys carry the same bound because the
    measured gap is 0 on every key (the two dicts are equal at these
    weights): the bound is the room for one swap in ``map``, not a measured
    spread;
  * ``predict``'s confident detections (score >= 0.02: greedy NMS decides
    a box by the boxes scored above it, so the survivors above a score
    depend on nothing below it), set against set on the images whose
    confident scores have no near-ties (consecutive scores more than 1e-4
    apart): the same classes, boxes within 1e-3 px, scores within 1e-4
    (the forward's f32 tolerance carried through decode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.core.types import default_anchors as t_anchors
from object_detection_cib_torch.data.synthetic import build_fake_manifest as t_manifest
from object_detection_cib_torch.data.val_cache import ValDeviceCache as TCache
from object_detection_cib_torch.models.convert import flax_to_torch
from object_detection_cib_torch.models.yolov5 import build_network as t_build
from object_detection_cib_torch.train.trainer import Evaluator
from object_detection_cib_tpu.core.types import FeatureShape, default_anchors as j_anchors
from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest
from object_detection_cib_tpu.data.val_cache import ValDeviceCache as JCache
from object_detection_cib_tpu.eval.coco_map import MeanAveragePrecisionEvaluator as JEval
from object_detection_cib_tpu.models.yolov5 import build_network as j_build
from object_detection_cib_tpu.train.optim import OptimizerConfig, SmartSGD
from object_detection_cib_tpu.train.steps import Batch, create_train_state, make_eval_step, make_train_step

NC, IMG, N, MAXT, BLOCK = 3, 64, 8, 16, 4
STEPS, LR0 = 150, 0.03
MAP_ATOL = 0.02


@pytest.fixture(scope="module")
def trained():
    """JAX's trained variables, its validation of the cache, and both caches."""
    kw = dict(num_classes=NC, num_images=N, image_size=IMG, seed=0)
    jinfo, tinfo = j_manifest(**kw), t_manifest(**kw)
    jcache = JCache(jinfo, np.arange(N), IMG, MAXT, fake_mode=True)
    tcache = TCache(tinfo, np.arange(N), IMG, MAXT, fake_mode=True)
    net = j_build(NC, "n")
    shape = FeatureShape(IMG, IMG)
    opt = SmartSGD(OptimizerConfig(lr0=LR0, max_epochs=100, warmup=None), steps_per_epoch=10)
    state = create_train_state(net, jax.random.PRNGKey(0), shape, opt)
    step = jax.jit(make_train_step(net, j_anchors(), shape, opt))
    batch = Batch(jnp.asarray(jcache.canvases, jnp.float32) / 255.0, jnp.asarray(jcache.gt_boxes),
                  jnp.asarray(jcache.gt_labels), jnp.asarray(jcache.gt_mask))
    for _ in range(STEPS):
        state, _ = step(state, batch)
    variables = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    eval_step = jax.jit(make_eval_step(net, j_anchors()))
    ev = JEval(NC, class_names=jinfo.classes)
    results = []
    for lo in range(0, N, BLOCK):
        sl = slice(lo, lo + BLOCK)
        res = jax.tree.map(np.asarray, eval_step(state.params, state.batch_stats, batch.images[sl]))
        ev.add_batch(res, jcache.gt_boxes[sl], jcache.gt_labels[sl], jcache.gt_mask[sl])
        results.append(res)
    jres = jax.tree.map(lambda *a: np.concatenate(a), *results)
    return dict(variables=variables, jmap=ev.results_dict(), jres=jres, jcache=jcache, tcache=tcache,
                classes=tinfo.classes)


@pytest.fixture(scope="module")
def evaluator(trained):
    tnet = t_build(NC, "n", device="cpu")
    tnet.load_state_dict(flax_to_torch(trained["variables"]), strict=True)
    return Evaluator(tnet, t_anchors(), trained["classes"], batch_size=BLOCK, device="cpu")


def test_caches_are_the_same_images(trained):
    for name in ("canvases", "gt_boxes", "gt_labels", "gt_mask"):
        np.testing.assert_array_equal(getattr(trained["tcache"], name), getattr(trained["jcache"], name))


def test_map_at_trained_weights_matches_jax(trained, evaluator, capsys):
    want = trained["jmap"]
    assert want["map50"] >= 0.1, want  # JAX found the boxes: the comparison is not vacuous
    got = evaluator.validate(trained["tcache"])
    assert set(got) == set(want)
    gap = {k: abs(got[k] - want[k]) for k in want}
    with capsys.disabled():
        print(f"\n[trained eval] JAX map50 {want['map50']:.4f} map {want['map']:.4f}; "
              f"largest |port - JAX| over the mAP dict {max(gap.values()):.6f} ({max(gap, key=gap.get)})")
    assert max(gap.values()) <= MAP_ATOL, gap
    counts = np.concatenate([res.num_valid for _, res in evaluator.run_blocks(trained["tcache"])])
    np.testing.assert_allclose(counts, trained["jres"].num_valid, atol=3)
    assert int(counts.sum()) > 0


CONFIDENT = 0.02


def _no_near_ties(scores: np.ndarray) -> bool:
    s = np.sort(scores[scores >= CONFIDENT - 1e-4])
    return bool(np.diff(s).min(initial=np.inf) > 1e-4)


def test_predict_at_trained_weights_matches_jax(trained, evaluator):
    jres, classes = trained["jres"], trained["classes"]
    preds = evaluator.predict(trained["tcache"])
    assert len(preds) == N
    compared = 0
    for i, p in enumerate(preds):
        n = int(jres.num_valid[i])
        jscores, tscores = jres.scores[i][:n], np.asarray(p["scores"], np.float32)
        if not (_no_near_ties(jscores) and _no_near_ties(tscores)):
            continue
        keep_j, keep_t = np.flatnonzero(jscores >= CONFIDENT), np.flatnonzero(tscores >= CONFIDENT)
        assert len(keep_t) == len(keep_j), i
        order_t = keep_t[np.argsort(tscores[keep_t])]
        order_j = keep_j[np.argsort(jscores[keep_j])]
        np.testing.assert_allclose(tscores[order_t], jscores[order_j], atol=1e-4)
        np.testing.assert_allclose(np.asarray(p["boxes"]).reshape(-1, 4)[order_t], jres.boxes[i][order_j], atol=1e-3)
        assert [p["classes"][k] for k in order_t] == [classes[int(c)] for c in jres.classes[i][order_j]]
        compared += len(order_t)
    assert compared >= 2 * N, compared  # two confident detections an image, on average
