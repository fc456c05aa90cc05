"""object_detection_cib_torch — the PyTorch/CUDA port of object_detection_cib_tpu.

The JAX package stays the reference; this package mirrors its layout and
names so each module's counterpart is found at the same relative path. It
imports ``torch`` and never JAX, flax or the JAX package.

Ported so far (the serving and validation path, the production training
path, the imbalance recipes on it: samplers, mixup, the no-mosaic
letterbox, a general affine, the exact warp; training and validation
from JPEG files through the three feeds, with the data CLI; and the
runtime: config composition, the trainer from a config, checkpoints,
loggers and the training CLI; data-parallel training over the cards
of one host):

- ``core``    box math, the IoU family, batched NMS (``non_max_suppression``)
              and the YOLOv5 label assigner
- ``models``  YOLOv5 n/s/m/l as ``nn.Module``s, and the flax->torch weight
              converter (``models/convert.py``)
- ``ops``     every TPU kernel of the JAX package as CUDA C++ for sm_90a
              (``ops/csrc/*.cu``, built by ``ops/build.py``), each beside its
              plain PyTorch version: greedy-NMS keep mask (``nms.py``),
              corpus row gather (``gather.py``), HSV jitter (``hsv.py``),
              fused mosaic warp (``warp.py``); and the device augment
              (``augment.py``: the fused and the composed path, mixup)
- ``eval``    head decode and the numpy COCO-style mAP evaluator
- ``data``    dataset manifests and their builders (fake, synthetic JPEG,
              COCO JSON), the native JPEG loader bindings, the
              device-resident validation cache, the imbalance-aware
              samplers (``samplers.py``), the device training pipeline
              (corpus on the card or host-fed) and the host pipeline
              (``reader.py``, ``host_augment.py``, ``augmentor.py``,
              ``pipeline.py``; cv2 and Pillow imported where used)
- ``config``  the YAML composition and ``instantiate`` engine over the repo's
              ``configs/`` (a copy of the JAX package's)
- ``cli``     ``python -m object_detection_cib_torch.cli.{train,data,
              inspect_sampler,visualize}``
- ``train``   loss, SmartSGD, the train and eval steps, the ``Evaluator``
              (validate / predict), the ``Trainer`` (from arguments or
              ``Trainer.from_config``; ``fit``), ``train(cfg)``, and
              ``torch.save`` checkpoints (``checkpoint.py``)
- ``utils``   the metric loggers (CSV, TensorBoard, W&B, MLflow)
- ``parallel`` data parallelism over the cards of one host: the rank layout
              (``mesh.py``), process groups, the collectives and the
              launcher of one process per card (``distributed.py``)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``trainer=cpu`` for the CLI).
"""

__version__ = "0.1.0"
