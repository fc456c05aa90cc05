"""Tiny copies of the benchmark's cells, for runs on the CPU: the same
files, the same limits, widths and sizes cut so that a test holds them."""

import copy

from harness import registry


def train_cell(name: str = "train.yolov5s.416.b64") -> dict:
    cell = copy.deepcopy(registry.workload(name))
    cell["model"].update(depth_multiple=0.33, width_multiple=0.25)
    cell["model"]["assumed"]["corpus_images"] = 32
    cell.update(image_size=64, batch=8, window_epochs=1)
    return cell


def infer_cell(name: str = "infer.yolov5s.640.b32") -> dict:
    cell = copy.deepcopy(registry.workload(name))
    cell["model"].update(depth_multiple=0.33, width_multiple=0.25)
    cell.update(image_size=128, batch=4, pool_images=16, max_nms=256, judged_from_first=4, judged_requests=2)
    return cell


def train4_cell(ranks: int = 2) -> dict:
    """The four-card cell at the tiny training sizes over ``ranks`` ranks,
    its global batch ``ranks`` times the one-card copy's."""
    cell = train_cell("train4.yolov5s.416.b256")
    cell.update(chips=ranks, batch=4 * ranks)
    return cell
