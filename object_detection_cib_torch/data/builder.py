"""Offline dataset builders: COCO-format JSON -> manifest, zipf subsetting.

A copy of ``object_detection_cib_tpu/data/builder.py``; the same JSON gives
the same manifest.

Capability parity: kod/data/builder.py:110-398. The reference builds its
datasets through FiftyOne + MongoDB + the COCO zoo (network); this
environment has zero egress, so the builder consumes a standard on-disk
COCO layout instead (images dir + instances_*.json) and produces the same
pickled manifest (data/cache.py). The coco-zipf recipe is preserved:

  * keep images with <`max_detections_per_image` detections
                                             (ref builder.py:119-134)
  * rank classes by instance count, keep the top `num_classes`
                                             (ref builder.py:136-152)
  * target per-class instance budget from a Zipf(a=1.01) pmf over ranks
                                             (ref builder.py:110-116)
  * greedy fill rarest-class-first until each budget is met
                                             (ref builder.py:164-206)

`do_analysis` exports per-class instance/image statistics (the
data-gradients report analog) as JSON + matplotlib histograms (matplotlib
is imported inside ``utils/plots.py``'s functions).
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from object_detection_cib_torch.data.cache import (
    DatasetInfo,
    ImageMetadata,
    SampleInfo,
    TargetInfo,
    XYXYBox,
    serialize_cached_dataset,
)
from object_detection_cib_torch.data.synthetic import zipf_counts


def load_coco_json(
    annotations_json: Path,
    images_root: str = "",
) -> DatasetInfo:
    """Convert a COCO instances JSON into a DatasetInfo manifest.

    Boxes converted from COCO [x, y, w, h] to absolute xyxy (the reference
    stores VOC-style absolute coords, builder.py:59-108).
    """
    with open(annotations_json) as fp:
        coco = json.load(fp)

    cat_by_id = {c["id"]: c["name"] for c in coco["categories"]}
    classes = [c["name"] for c in sorted(coco["categories"], key=lambda c: c["id"])]

    anns_by_img: Dict[int, list] = {}
    for a in coco.get("annotations", []):
        if a.get("iscrowd"):
            continue
        anns_by_img.setdefault(a["image_id"], []).append(a)

    samples: List[SampleInfo] = []
    for im in coco["images"]:
        targets = []
        for a in anns_by_img.get(im["id"], []):
            x, y, w, h = a["bbox"]
            if w <= 0 or h <= 0:
                continue
            targets.append(
                TargetInfo(
                    bounding_box=XYXYBox(float(x), float(y), float(x + w), float(y + h)),
                    class_name=cat_by_id[a["category_id"]],
                )
            )
        samples.append(
            SampleInfo(
                id=str(im["id"]),
                image_path=str(Path(images_root) / im["file_name"]),
                image_metadata=ImageMetadata(
                    width=int(im["width"]),
                    height=int(im["height"]),
                    num_channels=3,
                    mime_type="image/jpeg",
                    size_bytes=0,
                ),
                targets=targets,
            )
        )
    return DatasetInfo(
        name=Path(annotations_json).stem, date=datetime.now(), classes=classes,
        samples=samples,
    )


def make_zipf_subset(
    info: DatasetInfo,
    num_classes: int = 10,
    max_detections_per_image: int = 10,
    zipf_a: float = 1.01,
    budget_scale: float = 1.0,
    seed: int = 51,
) -> DatasetInfo:
    """The coco-zipf recipe on an arbitrary manifest (ref builder.py:233-284)."""
    # 1. images with < max detections (ref builder.py:119-134)
    eligible = [s for s in info.samples if 0 < len(s.targets) < max_detections_per_image]

    # 2. top-N classes by instance count among eligible images
    counts: Dict[str, int] = {}
    for s in eligible:
        for t in s.targets:
            counts[t.class_name] = counts.get(t.class_name, 0) + 1
    top = sorted(counts, key=counts.get, reverse=True)[:num_classes]

    filtered = DatasetInfo(
        name=info.name, date=info.date, classes=list(info.classes),
        samples=eligible,
    ).filter(f"{info.name}-top{num_classes}", top)

    # 3. zipf per-class budgets over popularity ranks
    total = sum(filtered.get_instance_count().values())
    budgets_arr = zipf_counts(num_classes, int(total * budget_scale), zipf_a)
    budgets = {c: int(b) for c, b in zip(top, budgets_arr)}

    # 4. greedy fill rarest-first (ref builder.py:164-206): walk classes from
    # rarest target budget up; add images whose rarest class still needs fill
    rng = np.random.default_rng(seed)
    have = {c: 0 for c in top}
    chosen: List[SampleInfo] = []
    order = rng.permutation(len(filtered.samples))
    rank = {c: i for i, c in enumerate(top)}
    for idx in order:
        s = filtered.samples[int(idx)]
        rarest = max(s.targets, key=lambda t: rank[t.class_name]).class_name
        if have[rarest] >= budgets[rarest]:
            continue
        chosen.append(s)
        for t in s.targets:
            have[t.class_name] += 1
    return DatasetInfo(
        name=f"{info.name.replace('instances_', '')}-zipf",
        date=datetime.now(),
        classes=top,
        samples=chosen,
    )


def gen_cache(
    info: DatasetInfo,
    split: str,
    cache_dir: Optional[Path] = None,
    dataset_name: Optional[str] = None,
) -> Path:
    """Write the manifest pickle (ref builder.py:287-331)."""
    if dataset_name:
        info = info._replace(name=dataset_name)
    return serialize_cached_dataset(info, split, cache_dir)


def do_analysis(info: DatasetInfo, out_dir: Path) -> Dict[str, dict]:
    """Dataset statistics export (ref builder.py:334-398 analog)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    inst = info.get_instance_count()
    img_count = {c: 0 for c in info.classes}
    sizes = []
    for s in info.samples:
        present = {t.class_name for t in s.targets}
        for c in present:
            img_count[c] += 1
        for t in s.targets:
            bb = t.bounding_box
            sizes.append((bb.x_max - bb.x_min) * (bb.y_max - bb.y_min))
    stats = {
        "instances_per_class": inst,
        "images_per_class": img_count,
        "num_samples": len(info.samples),
        "box_area_quantiles": {
            q: float(np.quantile(sizes, q / 100.0)) for q in (10, 50, 90)
        }
        if sizes
        else {},
    }
    (out_dir / f"{info.name}-analysis.json").write_text(json.dumps(stats, indent=2))
    try:
        from object_detection_cib_torch.utils.plots import plot_instance_histogram

        plot_instance_histogram(inst, out_dir / f"{info.name}-instances.png")
    except Exception:
        pass
    return stats
