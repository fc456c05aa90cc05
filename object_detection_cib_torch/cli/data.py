"""Dataset CLI, a copy of ``object_detection_cib_tpu/cli/data.py`` writing the
same manifests (parity: kod/cli/data.py — make-coco-zipf / make-coco-2017 /
gen-cache / do-analysis), argparse-based (typer not in this image).

The reference pulls COCO through the FiftyOne zoo (network+MongoDB); here
the commands consume a standard on-disk COCO layout or generate synthetic
corpora (zero-egress environment):

  python -m object_detection_cib_torch.cli.data gen-cache \
      --annotations instances_val2017.json --split validation --name coco-2017
  python -m object_detection_cib_torch.cli.data make-coco-zipf \
      --annotations instances_train2017.json --split train
  python -m object_detection_cib_torch.cli.data make-synthetic --name synthetic-zipf
  python -m object_detection_cib_torch.cli.data do-analysis --name coco-zipf --split train
"""

from __future__ import annotations

import argparse
from pathlib import Path

from object_detection_cib_torch.data.builder import (
    do_analysis,
    gen_cache,
    load_coco_json,
    make_zipf_subset,
)
from object_detection_cib_torch.data.cache import deserialize_cached_dataset
from object_detection_cib_torch.data.synthetic import build_synthetic_dataset
from object_detection_cib_torch.utils.fs import (
    get_default_dataset_cache_dir,
    get_default_datasets_dir,
)


def main(argv=None):
    p = argparse.ArgumentParser(prog="object_detection_cib_torch.cli.data")
    sub = p.add_subparsers(dest="cmd", required=True)

    gc = sub.add_parser("gen-cache", help="COCO JSON -> manifest pickle")
    gc.add_argument("--annotations", type=Path, required=True)
    gc.add_argument("--images-root", default="")
    gc.add_argument("--split", choices=["train", "validation"], required=True)
    gc.add_argument("--name", default=None)
    gc.add_argument("--cache-dir", type=Path, default=None)

    mz = sub.add_parser("make-coco-zipf", help="long-tailed top-10 zipf subset")
    mz.add_argument("--annotations", type=Path, required=True)
    mz.add_argument("--images-root", default="")
    mz.add_argument("--split", choices=["train", "validation"], required=True)
    mz.add_argument("--num-classes", type=int, default=10)
    mz.add_argument("--max-dets", type=int, default=10)
    mz.add_argument("--zipf-a", type=float, default=1.01)
    mz.add_argument("--name", default="coco-zipf")
    mz.add_argument("--cache-dir", type=Path, default=None)

    ms = sub.add_parser("make-synthetic", help="synthetic shapes corpus")
    ms.add_argument("--name", default="synthetic-zipf")
    ms.add_argument("--num-images", type=int, default=500)
    ms.add_argument("--image-size", type=int, default=320)
    ms.add_argument("--split", choices=["train", "validation"], default="train")
    ms.add_argument("--seed", type=int, default=0)

    da = sub.add_parser("do-analysis", help="dataset statistics + plots")
    da.add_argument("--name", required=True)
    da.add_argument("--split", choices=["train", "validation"], default="train")
    da.add_argument("--out-dir", type=Path, default=Path("analysis"))
    da.add_argument("--cache-dir", type=Path, default=None)

    args = p.parse_args(argv)

    if args.cmd == "gen-cache":
        info = load_coco_json(args.annotations, args.images_root)
        out = gen_cache(info, args.split, args.cache_dir, args.name)
        print(f"wrote {out} ({len(info.samples)} samples)")
    elif args.cmd == "make-coco-zipf":
        info = load_coco_json(args.annotations, args.images_root)
        zipf = make_zipf_subset(
            info,
            num_classes=args.num_classes,
            max_detections_per_image=args.max_dets,
            zipf_a=args.zipf_a,
        )
        zipf.summarize()
        out = gen_cache(zipf, args.split, args.cache_dir, args.name)
        print(f"wrote {out} ({len(zipf.samples)} samples)")
    elif args.cmd == "make-synthetic":
        from object_detection_cib_torch.utils.fs import get_root_dir

        out_dir = get_default_datasets_dir()
        info = build_synthetic_dataset(
            out_dir,
            name=args.name,
            num_images=args.num_images,
            image_size=args.image_size,
            seed=args.seed,
            path_prefix=str(out_dir.relative_to(get_root_dir())),
        )
        out = gen_cache(info, args.split, get_default_dataset_cache_dir())
        info.summarize()
        print(f"wrote {out}")
    elif args.cmd == "do-analysis":
        info = deserialize_cached_dataset(args.name, args.split, args.cache_dir)
        stats = do_analysis(info, args.out_dir)
        print(f"analysis written to {args.out_dir}: "
              f"{stats['num_samples']} samples")


if __name__ == "__main__":
    main()
