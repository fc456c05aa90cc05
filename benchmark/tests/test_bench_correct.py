"""``correct`` on the CPU at a size a test holds: the program computed in
float32 agrees with the reference to rounding, and the control (the
reference in fp8 in the program's place) and every planted fault come out
not correct under the cells' own limits. The harness's look for a card is
skipped; the rest of a run is driven as on the card."""

import time

import pytest
import torch

from _tiny import infer_cell, train4_cell, train_cell
from harness import faults, infer_cell as infer, judge, registry, train_cell as train

CPU = torch.device("cpu")
SEED = 2**31 + 17


@pytest.fixture
def float32_program(monkeypatch):
    """The program built in float32 (its ``dtype=None``), where the
    configurations state bf16."""
    from object_detection_cib_torch.models import yolov5
    from object_detection_cib_torch.train.trainer import Trainer

    init, build = Trainer.__init__, yolov5.build_network
    monkeypatch.setattr(Trainer, "__init__", lambda self, *a, **k: init(self, *a, **{**k, "dtype": torch.float32}))
    monkeypatch.setattr(yolov5, "build_network", lambda *a, **k: build(*a, **{**k, "dtype": None}))


def _train(hook=None, seconds=0.1, **recipe):
    cell = dict(train_cell(), **recipe)
    return cell, train.run(cell, SEED, seconds, False, CPU, time.perf_counter(), hook=hook)


@pytest.mark.parametrize("recipe", [
    {},
    {"aug": {"translate": 0.2, "scale": 0.25, "hue": 0.0, "saturation": 0.5, "value": 0.2, "flip_lr_prob": 0.9},
     "program": {"fused_epoch": False}},
], ids=["as_configured", "own_recipe_step_loop"])
def test_float32_program_agrees_with_the_reference(float32_program, recipe):
    """Both sides follow the cell's recipe: the program computed in float32
    is the reference to rounding, with a cell's own augment ranges and
    loop as with the configured ones."""
    cell, out = _train(**recipe)
    assert out["numbers"]["loss_gap"] < 1e-5 and out["numbers"]["grad_gap"] < 1e-3
    assert out["numbers"]["update_gap"] < 1e-3 and out["failed"] == 0
    assert judge.verdict(out["numbers"], cell["limits"])


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_faults_are_not_correct(fault):
    cell, out = _train(faults.TRAIN[fault])
    assert not judge.verdict(out["numbers"], cell["limits"]), out["numbers"]


def test_training_control_is_not_correct():
    cell = train_cell()
    cfg = cell["model"]
    m = train.manifest(cell, SEED)
    state = registry.family(cfg).weights(SEED, cfg, CPU)
    ctl = train.reference_steps(cell, SEED, CPU, m, state, cell["judged_steps"], quant=True)
    ref = train.reference_steps(cell, SEED, CPU, m, state, cell["judged_steps"])
    numbers = train.judge_steps(ctl, ref, state)
    assert not judge.verdict(numbers, cell["limits"]), numbers


def test_float32_program_over_ranks_agrees_with_the_reference(few_threads):
    """Two gloo ranks, each on its rows of the global batch with BatchNorm
    and the gradient summed over them, read as the reference at the
    global batch in one piece does (the program in float32)."""
    numbers, = train.readings(train4_cell(), [(SEED, None, "float32_program")], CPU)
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-3 and numbers["update_gap"] < 1e-3, numbers


@pytest.mark.parametrize("fault", sorted({**faults.TRAIN, **faults.MESH}))
def test_training_faults_over_ranks_are_not_correct(few_threads, fault):
    """A run over two gloo ranks, each with the fault planted, is judged
    not correct: an unchanged state, half of each rank's rows, the
    gradient's exchange left out, BatchNorm's statistics a rank's own (at
    this size; at the cell's, 64 images a card, that one reads as sound
    runs do)."""
    cell = train4_cell()
    out = train.run(cell, SEED, 0.1, False, CPU, time.perf_counter(), hook={**faults.TRAIN, **faults.MESH}[fault])
    assert not judge.verdict(out["numbers"], cell["limits"]), out["numbers"]


def _infer(hook=None):
    cell = infer_cell()
    return cell, infer.run(cell, SEED, 0.5, False, CPU, time.perf_counter(), hook=hook)


def test_float32_eval_agrees_with_the_reference(float32_program):
    cell, out = _infer()
    assert out["numbers"]["det_gap"] < 1e-3 and out["numbers"]["set_miss"] == 0
    assert judge.verdict(out["numbers"], cell["limits"]), out["numbers"]
    assert out["attempted"] >= 1 and out["e2e"]["infer_img_s"] > 0


@pytest.mark.parametrize("fault", sorted(faults.INFER))
def test_inference_faults_are_not_correct(fault):
    cell, out = _infer(faults.INFER[fault])
    assert not judge.verdict(out["numbers"], cell["limits"]), out["numbers"]


def test_inference_control_is_not_correct():
    cell = infer_cell()
    ev, batches, state = infer.build(cell, SEED, CPU)
    answers = infer.reference_answers(cell, state, batches, [0, 1], CPU, quant=True)
    numbers = infer.judge_requests(cell, state, batches, answers, CPU)
    assert not judge.verdict(numbers, cell["limits"]), numbers
