"""The plain float32 reference that decides a run's ``correct``.

Plain PyTorch, NCHW, float32 with TF32 off (``plain_math``), no kernel and
no CUDA graph. It imports neither ``jax`` nor any package of this
repository: what it shares with the measured program (the YOLOv5 layer
equations, the epoch plan's draws, the augment's arithmetic, the
assignment, the loss and SmartSGD) is written out here or held as a frozen
copy, so a change to the program cannot move it.

  * ``network``: YOLOv5 n/s/m/l with the program's parameter names, and the
    lower-precision control (fp8 e4m3 operands in every convolution);
  * ``feed``: the fused epoch's plan and draws, worked out again from the
    seed, and the mosaic, affine warp, HSV, flip and normalisation;
  * ``train``: assignment, loss, SmartSGD, and the steps that follow the
    program's first steps;
  * ``detect``: decode, candidate selection and greedy NMS.
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
