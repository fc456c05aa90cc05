"""object_detection_cib_torch — the PyTorch/CUDA port of object_detection_cib_tpu.

The JAX package stays the reference; this package mirrors its layout and
names so each module's counterpart is found at the same relative path. It
imports ``torch`` and never JAX, flax or the JAX package.

Ported so far (the serving and validation path, the production training
path, the imbalance recipes on it: samplers, mixup, the no-mosaic
letterbox, a general affine, the exact warp; and training and validation
from JPEG files through the three feeds, with the data CLI):

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
- ``cli``     ``python -m object_detection_cib_torch.cli.data``
- ``train``   loss, SmartSGD, the train and eval steps, the ``Evaluator``
              (validate / predict) and the ``Trainer`` (``fit``)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
