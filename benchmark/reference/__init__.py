"""The plain float32 references that decide a run's ``correct``.

Plain PyTorch, NCHW inside, float32 with TF32 off (``plain_math``), no
kernel and no CUDA graph. It imports neither ``jax`` nor any package of
this repository: what it shares with the measured program (the layer
equations, the epoch plan's draws, the augment's arithmetic, the
assignment, the loss and the optimizer) is written out here or held as a
frozen copy, so a change to the program cannot move it.

Shared by every network:

  * ``feed``: the fused epoch's plan and draws, worked out again from the
    seed, and the mosaic, affine warp, HSV, flip and normalisation;
  * ``detect``: ``Decoded`` (boxes, objectness, class scores), candidate
    selection and greedy NMS, and YOLOv5's anchor decode.

Of one network family, reached only through its module in ``networks/``
(``networks/__init__.py`` gives the names it defines):

  * ``network``: YOLOv5 n/s/m/l with the program's parameter names, and the
    lower-precision control (fp8 e4m3 operands in every convolution);
  * ``train``: YOLOv5's assignment, loss, SmartSGD, and the steps that
    follow the program's first steps.

A new network adds its reference here as files of its own (its network in
float32 with ``set_quant`` for the control, images (B, S, S, 3) in [0, 1]
in; its assignment, loss and training steps; its decode into ``Decoded``)
and its family module in ``networks/``; nothing here needs an edit.
"""

import contextlib

import torch


@contextlib.contextmanager
def plain_math():
    """Float32 matrix products and convolutions in float32, not TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
