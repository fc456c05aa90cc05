#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (an Orbax directory) into one of
the PyTorch port (one ``torch.save`` file), the whole training state carried:
parameters, BatchNorm statistics, SmartSGD's momentum buffers and the step.

    python tools/orbax_to_torch.py <jax run>/checkpoints/last <port run>/checkpoints/last
    python tools/orbax_to_torch.py <jax run>/checkpoints/best <port run>/checkpoints/best

Run it where the JAX package's dependencies (jax, orbax) are installed, from
the root of a checkout. Copy the files it writes to the machine with the
card and resume there through the port's entry points with
``paths.output_dir=<port run> ckpt_path=<port run>/checkpoints/last``: the
port's trainer goes on at epoch ``step // steps_per_epoch`` with the same
learning rates and momentum (functions of the step) as the JAX trainer.

The directory is restored by ``orbax.checkpoint.StandardCheckpointer().
restore(path)`` without a target, so no config or model is needed to build
one: Orbax hands back the ``TrainState`` as nested dicts, ``{"params",
"batch_stats", "opt_state": {"momentum_buf"}, "step"}``. It logs an absl
warning that restoring without a target is unsafe unless the topology is
the one the checkpoint was saved under; that warning is Orbax's, left as
it is. The training state is replicated on every device under data
parallelism, and under DP x SP (a (data, model) mesh) as well, so each
array restores whole on one host. The space-to-depth stem keeps the plain
(6, 6, 3, C) kernel and remat adds no parameter, so a checkpoint of any
training option (the stem, remat, data parallelism, DP x SP) converts
unchanged. ``models/convert.py:flax_state_to_torch`` maps every leaf and
raises on one it does not know; ``train/checkpoint.py:save_state`` writes
the file as the port's trainer writes its own.

For a directory named ``best``, the ``meta.json`` beside it (the best value
and its metric) is written beside the output file, so that the port's
``CheckpointManager`` tracks the best value on from where the JAX run left it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", type=Path, help="an Orbax checkpoint directory of the JAX package")
    ap.add_argument("out", type=Path, help="the port's checkpoint file to write")
    args = ap.parse_args(argv)

    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from object_detection_cib_torch.models.convert import flax_state_to_torch
    from object_detection_cib_torch.train.checkpoint import save_meta, save_state

    src = args.src.absolute()
    if not src.is_dir():
        raise NotADirectoryError(f"{src} is not an Orbax checkpoint directory")
    state = jax.tree.map(np.asarray, ocp.StandardCheckpointer().restore(src))
    ckpt = flax_state_to_torch(state)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    save_state(args.out, ckpt)
    meta = src.parent / "meta.json"
    carried = src.name == "best" and meta.is_file()
    if carried:
        m = json.loads(meta.read_text())
        save_meta(args.out.parent, m["best_value"], m.get("monitor", "map"))
    print(f"{src} -> {args.out}: {len(ckpt['net'])} tensors, {len(ckpt['optimizer']['momentum'])} momentum "
          f"buffers, step {ckpt['optimizer']['step_count']}"
          + (f"; meta.json carried (best_value {m['best_value']})" if carried else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
