"""object_detection_cib_torch — the PyTorch/CUDA port of object_detection_cib_tpu.

The JAX package stays the reference; this package mirrors its layout and
names so each module's counterpart is found at the same relative path. It
imports ``torch`` and never JAX, flax or the JAX package.

Ported so far (the serving and validation path):

- ``core``    box math, the IoU family, batched NMS (``non_max_suppression``)
- ``models``  YOLOv5 n/s/m/l as ``nn.Module``s, and the flax->torch weight
              converter (``models/convert.py``)
- ``ops``     the greedy-NMS keep-mask kernel: CUDA C++ for sm_90a
              (``ops/csrc/nms.cu``) beside its plain PyTorch version
- ``eval``    head decode and the numpy COCO-style mAP evaluator
- ``data``    dataset manifests, the fake manifest builder, the native JPEG
              loader bindings and the device-resident validation cache
- ``train``   ``make_eval_step`` and the ``Evaluator`` (validate / predict)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
