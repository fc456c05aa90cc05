"""Dataset manifest schema + cache (de)serialization.

Capability parity: kod/data/cache.py:21-160. The pickle layout is kept
drop-in compatible with caches generated by the reference
(``kod-{dataset}-{split}.pkl``): NamedTuples pickle as (class, field values),
so a module-remapping unpickler loads reference caches directly into these
classes. Our own caches pickle natively.

Env: KOD_DATA_ROOT_DIR overrides the root dir (parity: kod/utils/fs.py:8).
"""

from __future__ import annotations

import pickle
from datetime import datetime
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

from object_detection_cib_torch.utils.fs import get_default_dataset_cache_dir


class XYXYBox(NamedTuple):
    """Scalar xyxy box (pickle-compatible with kod XYXYBoundingBox fields)."""

    x_min: float
    y_min: float
    x_max: float
    y_max: float


class ImageMetadata(NamedTuple):
    width: int
    height: int
    num_channels: int
    mime_type: str
    size_bytes: int


class TargetInfo(NamedTuple):
    bounding_box: XYXYBox
    class_name: str


class SampleInfo(NamedTuple):
    id: str
    image_path: str
    image_metadata: ImageMetadata
    targets: List[TargetInfo]


class DatasetInfo(NamedTuple):
    name: str
    date: datetime
    classes: List[str]
    samples: List[SampleInfo]

    def subset(self, num_samples: int) -> "DatasetInfo":
        return self._replace(
            classes=self.classes[:num_samples], samples=self.samples[:num_samples]
        )

    def filter(self, new_name: str, classes_to_include: List[str]) -> "DatasetInfo":
        """Keep only listed classes; drop samples left without targets
        (ref cache.py:55-91 / filter.py:10-46)."""
        for c in classes_to_include:
            if c not in self.classes:
                raise ValueError(f"{c} is not in the original dataset!")
        keep = set(classes_to_include)
        filtered: List[SampleInfo] = []
        for s in self.samples:
            ts = [t for t in s.targets if t.class_name in keep]
            if ts:
                filtered.append(s._replace(targets=ts))
        return DatasetInfo(
            name=new_name, date=self.date, classes=list(classes_to_include),
            samples=filtered,
        )

    def get_instance_count(self) -> Dict[str, int]:
        counts = {c: 0 for c in self.classes}
        for s in self.samples:
            for t in s.targets:
                counts[t.class_name] += 1
        return counts

    def summarize(self, extra_title: Optional[str] = None) -> str:
        lines = [f"dataset: {self.name}" + (f" [{extra_title}]" if extra_title else "")]
        lines.append(f"  classes: {len(self.classes)}  samples: {len(self.samples)}")
        no_tgt = sum(1 for s in self.samples if not s.targets)
        lines.append(f"  samples w/o target: {no_tgt}")
        for c, n in self.get_instance_count().items():
            lines.append(f"  {c}: {n}")
        text = "\n".join(lines)
        print(text)
        return text


# Module paths used by reference-generated pickles -> our classes.
_COMPAT_CLASSES = {
    ("kod.data.cache", "ImageMetadata"): ImageMetadata,
    ("kod.data.cache", "TargetInfo"): TargetInfo,
    ("kod.data.cache", "SampleInfo"): SampleInfo,
    ("kod.data.cache", "DatasetInfo"): DatasetInfo,
    ("kod.core.bbox.boxes", "XYXYBoundingBox"): XYXYBox,
}


class _CompatUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _COMPAT_CLASSES:
            return _COMPAT_CLASSES[(module, name)]
        return super().find_class(module, name)


def deserialize_cached_dataset(
    dataset: str, split: str, cache_dir: Optional[Path] = None
) -> DatasetInfo:
    """Load ``kod-{dataset}-{split}.pkl`` (ref cache.py:144-160)."""
    if split not in ("train", "validation"):
        raise ValueError("split can only be train or validation")
    if cache_dir is None:
        cache_dir = get_default_dataset_cache_dir()
    cache_file = Path(cache_dir) / f"kod-{dataset}-{split}.pkl"
    with open(cache_file, "rb") as fp:
        return _CompatUnpickler(fp).load()


def serialize_cached_dataset(
    info: DatasetInfo, split: str, cache_dir: Optional[Path] = None
) -> Path:
    if cache_dir is None:
        cache_dir = get_default_dataset_cache_dir()
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    out = cache_dir / f"kod-{info.name}-{split}.pkl"
    with open(out, "wb") as fp:
        pickle.dump(info, fp)
    return out
