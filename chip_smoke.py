#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py [--baseline DIR ...]
    python3 chip_smoke.py --phase ddp   # phases 1, 2 and 13 alone (on 2-4 cards for 13 (c))
    python3 chip_smoke.py --phase hosts # phases 1, 2 and 14 alone (on 4 cards for 14 (b))
    python3 chip_smoke.py --phase rest  # phases 1, 2 and 15 alone (15 (e) on every card visible)
    python3 chip_smoke.py --phase spatial  # phases 1, 2 and 16 alone ((b) on 2 cards, (c) on 4)
    python3 chip_smoke.py --phase jpeg  # phases 1, 2, 7's letterbox, 10 and 17 alone (the JPEG feeds)
    python3 chip_smoke.py --phase flat  # phases 1, 2 and 18 alone (the flat corpus)
    python3 chip_smoke.py --phase carry # phases 1, 2 and 19 alone (a run carried across the JAX layout)
    python3 chip_smoke.py --phase sizes # phases 1, 2 and 20 alone (yolov5m and yolov5l at full width)
    python3 chip_smoke.py --phase bn_silu  # phases 1, 2, 7's BatchNorm + SiLU and a fused fit of 10 steps

``--baseline DIR`` (repeatable) also builds the four kernel sources
(``nms.cu``, ``gather.cu``, ``hsv.cu``, ``warp.cu``) of another checkout at
DIR (for example the parent commit, unpacked with ``git archive`` into a
git-ignored directory), holds each bitwise against the plain version in
phases 3 and 7, and times it in turns with this checkout's kernel on the
same inputs, called straight through ctypes. Each checkout's ``nms.cu`` is
called by the interface it has: a library that exports
``odcib_nms_workspace_bytes`` takes a workspace pointer and its capacity in
images after ``keep``; one that does not takes the earlier seven arguments.
Without ``--baseline``, one card and nothing else is needed.

Every kernel is timed two ways: ``ms``, CUDA events around 30 calls in a
row (the kernel's device time, as long as the host enqueues a call faster
than the card runs it; ``--baseline .`` times the same kernels called
without the Python wrapper), and ``call_ms``, one call between two events
from an idle stream, median of 30 (the wrapper's host path included, as a
host-bound step sees it).

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. device: require CUDA, print the card's name and power limit
   (``nvidia-smi``), set and print the TF32 switches;
2. build: compile every kernel source of ``object_detection_cib_torch/ops/
   csrc`` (one ``nvcc`` per source, all at once; printed as set-up time,
   with ptxas' register report);
3. kernels: hold each kernel BITWISE against its plain PyTorch version on
   the card (greedy-NMS keep mask: the chain case, K=256 random, K=2048 with
   900 live, a ragged K=1000, K=64 and K=65, the validation batch of 64 at
   K=2048, one image alone, an image with no live box, one where every box
   is kept and one where box 0 suppresses all others, and the batch of 32 at
   K=2048 from a real yolov5s output), then time kernel and plain version in
   turns with CUDA events (median of repeats), at the batch of 32 and for
   its first image alone, and compute the kernel's bound from this run's
   inputs, beside the dependency depth of the timed case (the sweeps the
   plain version needs to its fixpoint: the chain no parallel design can
   cut). Greedy NMS has no single PyTorch call (there is no torchvision
   here), so there is no library yardstick: ``library_ms`` is null;
4. serving: yolov5s, nc=10, 640x640, batch 32, bf16, channels_last, random
   weights from a seed, through ``make_eval_step`` (forward -> decode -> NMS
   at conf 0.001 / IoU 0.6 / max_nms 2048 / max_det 300) for 200 steps;
   launch counts are zeroed just before and read just after; img/s over the
   200 steps, the host's time to enqueue one step, and ms per stage; a small
   f32 input checked against the CPU run of the same port;
5. validation: a fake 320-image val set at 416 (``build_fake_manifest``,
   coco-zipf top-10 shape), ``ValDeviceCache`` on the card, batch 64,
   ``Evaluator.validate``; the mAP dict must be finite;
6. training set-up: the repo's training recipe (yolov5s, nc=10, 416x416,
   batch 64, bf16 over f32 parameters, mosaic, translate 0.1, scale 0.5,
   HSV 0.015/0.7/0.4, flip 0.5, max_targets 120) as a ``Trainer`` over the
   fake 4,992-image corpus of ``bench.py:bench_sustained`` (the same image
   bytes, sizes and boxes; the class labels follow the coco-zipf long tail
   of the val set, so that the samplers of phase 9 have an imbalance to
   flatten), held on the card as planar uint8 (2.59 GB), with the phase-5
   val set;
7. training kernels: the corpus gather (K2 planar at a mosaic step's 256
   rows and at a no-mosaic step's 64, K3 on the planar corpus's bytes
   viewed flat; phase 18 holds it on the NHWC corpus), HSV (K4,
   bf16 and f32, integral and non-integral, extreme gains, a plane that is
   not a multiple of 8, a base 2 bytes off 16-byte alignment, and pixels
   that read entries 0, 1 and 255 of both division tables) and the mosaic
   warp (K5: taps of a real draw at 416, random windowed taps at 416 and
   640, a quadrant wholly outside its window) held BITWISE against their
   plain versions on the card, then timed in turns against them (and the
   gather against ``torch.index_select``), with bounds from this run's
   inputs. Then the letterbox (``csrc/letterbox.cu``, the port's own kernel:
   it ports ``native/loader.cpp:75-118``, the JAX package's host resize and
   pack) held BITWISE against its plain version on batches of 256 seeded
   raw images (COCO-like and extreme sizes with a failed file, and the main
   path's 640 x 640), at S = 416 and 640, top-left and centred, planar and
   NHWC; each batch at 416 timed in turns with its plain version, beside
   ``F.interpolate`` + pad and the bytes bound. Then the training BatchNorm +
   SiLU (``csrc/bn_silu.cu``, the port's own kernels: the JAX package leaves
   it to XLA) at every layer shape of yolov5s and yolov5l at 416, B=64:
   held to its plain version within ``test_utils/bn_silu.py``'s limits (y
   within one bf16 unit of the plain version from the kernels' own
   statistics; the statistics and gradients relative to their scale), the
   op through autograd bitwise the kernels, then a captured graph of one
   forward and backward timed in turns with the plain layers', beside
   ``F.batch_norm(training=True)`` + ``F.silu`` and the bound of 10 B an
   element; its kernels-line numbers are yolov5s's layers a step.
   ``--phase bn_silu`` runs phases 1, 2, this and a 10-step fused fit of
   yolov5s (launches zeroed just before: BS 57 a step by replay);
8. training: the step loop (``Trainer(fused_epoch=False)``),
   ``Trainer.fit(max_epochs=1, epoch_steps=40)`` with the
   launch counts zeroed just before and read just after (K2, K4, K5 once
   per step, BS once a training BatchNorm a step; K1 five times in the
   epoch-end validation); finite losses,
   every parameter moved, a finite mAP; img/s over the last 30 steps, ms
   per stage and the host's time to enqueue one step; then two f32 steps
   of yolov5n at 64 px from the same weights and draws on the CPU and the
   card, losses within 1e-3 relative;
9. recipes: the imbalance recipes at the width of phase 8 (yolov5s, nc=10,
   416x416, batch 64, bf16), each a ``Trainer`` over phase 6's corpus on the
   card (built once, shared), stepped through ``pipeline.epoch`` and
   ``train_step`` with the launch counts zeroed just before and read just
   after: class-aware sampling with mixup 0.5 for 10 steps (K2, K4 and K5
   twice per step; both outcomes of the mixup coin; a row with more valid
   targets than one group holds; ``sampler_stats`` flatter than the same
   steps without a sampler), repeat-factor sampling without mosaic for 10
   steps (K2 with 64 rows and K4 once per step, K5 never), a rotating,
   shearing, perspective affine for 5 steps (K5 never; integer pixels in
   [0, 255] before the normalize), the exact warp against the fast one on
   the same rows and draws (4/255 at most, 1/255 on 99% of pixels, HSV
   off; boxes, labels and masks equal), and one composed-path step and one
   mixup step at 64 px on the CPU and the card (1/255, boxes 1e-4, HSV
   off; with HSV on, 9/255; both on under 0.1% of pixels, 0.2% under
   mixup). Each recipe prints
   img/s after a warm-up step, its augment stage's ms, the host's time to
   enqueue one step and its launches: observations, not claims;
10. jpeg: training and validation from JPEG files at the width of phase 8
    (yolov5s, nc=10, 416x416, batch 64, bf16, ``aug_params.yaml``). First a
    probe of the host libraries: cv2 and Pillow (the host pipeline; Pillow
    decodes every feed's files), which the phase fails without, and, as
    information, libjpeg (the JAX package's native loader, which the port
    does not use). ``build_synthetic_dataset`` writes ``synthetic-hard-
    zipf``, 640 train and 128 val JPEG files, into a temporary directory.
    (a) ``Trainer(pipeline="device", device_cache=True)``: the corpus and
    the validation cache decoded from the files on the host and letterboxed
    on the card (the letterbox 3 + 1 times), the first 128 corpus rows and
    the whole cache held byte for byte against the CPU path (Pillow and the
    plain letterbox, which takes ~0.07 s an image there); ``fit`` over one
    epoch with its validation (K2, K4, K5 10 times each, K1 twice). (b)
    ``device_cache=False``: 5 steps with the groups decoded by a host
    thread and letterboxed on the card (K2 never; K4, K5 and the letterbox
    5 times), bitwise equal to the device-cache pipeline's batches of the
    same seed; with the RAM cache a second epoch decodes only images not
    seen before, and what the cache holds is printed. (c)
    ``pipeline="host"``, 8 worker threads, 5 steps and the host-fed
    validation (no training kernel; K1 once per val batch). Last the two
    validation feeds on the same canvases give the same mAP dict. Each part
    prints img/s and the host's enqueue time, (c) the time the consumer
    waited on its queue: observations, not claims. A part that needs a
    library the machine lacks fails the phase;
11. cli: the normal entry point, ``object_detection_cib_torch.cli.train.
    main([...])`` on the card (``trainer.platform`` null), in a temporary
    output directory with ``hydra=static``, ``extras.enforce_tags=False``,
    no config print and ``logger=csv``. (a) ``experiment=yv5s`` (yolov5s@416,
    B=64, bf16) over a fake 640-image set on the device pipeline with the
    corpus on the card, two epochs validated once
    (``check_val_every_n_epoch=2``), on the fused epoch by the config's
    defaults (a CUDA graph a step, the second epoch enqueued ahead of the
    first's fetch): K2, K4, K5 20 times each, counted by replay, K1 10 (one
    validation of 640 images); finite losses and mAP; ``checkpoints/{best,
    last,meta.json}``, ``csv/metrics.csv``, ``hparams.json``; then ``train=
    False test=True ckpt_path=<run>/checkpoints/last``: the restored
    parameters, statistics and momentum buffers bitwise those saved, the
    test mAP the last validation's within 1e-6. (b) the repo's default data
    config (the host pipeline) under ``trainer.fast_dev_run``: no training
    kernel, K1 once. (c) ``experiment=imbalance/class_aware/default`` with
    mixup 0.5 on the device pipeline, ``limit_train_batches=0.5`` and
    ``limit_val_batches=0.2``: K2, K4, K5 10 times each (5 steps, two groups
    a step), K1 twice, and the sampler's instance counts. (a) and (b) print
    img/s: observations, not claims;
12. fused: the fused epoch (``fused_epoch``, ``fused_pipelined``,
    ``fused_dispatch_ahead``, the config defaults) at phase 8's width over
    phase 6's corpus. First a probe: the first 6 batches of a fused epoch
    (pipelined, a CUDA graph after 2 eager warm-up steps, so 3 batches made
    inside the graph), recorded by the step itself, bitwise equal to the
    step loop's iterator from the same seed. Then two trainers of the same
    seed, the step loop and the fused epoch, each fitted to epoch 2 and on
    to epoch 4 in epochs of 40 steps (of the corpus's 78, a depth cut to
    make room for phase 20), validated at epochs 2 and 4, in turns
    (step, fused, fused, step): each fit launches K2, K4, K5 80 times
    (counted by replay for the fused loop), BS 80 x 57, and K1 5; finite losses and
    mAP, the fused trainer's parameters moved. Printed: img/s of each fit's
    second epoch (host clock; fetch to fetch for the fused loop), the
    device epoch walls (the last stage stamps), the first three losses of both loops,
    the peak memory; for one fused epoch of 40 steps from an idle card the host's
    enqueue and the time a step; the graph's nodes and kernels per step
    (libcuda's ``cuGraphGetNodes``); over a 10-step fused epoch the profiler's kernel time
    and the card's busy time (the union of the kernels' intervals: two
    streams overlap) and idle share. Observations, not claims;
13. ddp: data parallelism through the launcher
    (``parallel/distributed.py:launch``, one process a rank), each rank
    counting its own launches. (a) A one-rank NCCL group over the fused
    epoch (yolov5s@416, B=64, bf16, 640 fake images, 10 steps, validation
    of 128): K2/K4/K5 10 each by replay, K1 2; the all-reduces issued equal
    the step bodies run in Python (2 warm-up steps and one capture per
    graph) times (3 per BatchNorm + the compaction's counts + the loss's
    counts + the gradient bucket) + the epoch's metric sum; the graph's kernel nodes read by
    name (``cuFuncGetName``) and those of NCCL counted; finite losses and
    mAP. (b) Two gloo ranks sharing this card, the step loop at a global
    B=64 (32 a rank), 10 steps and one validation: K2/K4/K5 10 on each
    rank, K1 twice on each rank's 64-image shard (a rank validates at its
    share of the batch, 32); the ranks' weights bitwise equal; the first
    three losses within rtol 1e-3 of one process of the same seed; the
    merged mAP dict equal to one process's over the whole val set with the
    ranks' weights, in batches of the ranks' 32. (c) With two or more cards,
    N = min(count, 4) NCCL ranks over the config ``cli.train trainer=mesh``
    composes (yolov5s@416, 64 images a card, 1,280 fake images a card, two
    fused epochs, a quarter of the val set), the replicated and then the
    sharded corpus, beside one card alone: img/s over both epochs' windows
    and its ratio to the one card's, launches, collectives issued, NCCL
    kernel nodes in the graph, a profiled 10-step epoch's NCCL kernel ms a
    step and each rank's idle share, peak memory per rank; with one card it
    prints that (c) needs two. (d) With two or more cards, N NCCL ranks
    over the sharded corpus of (a)'s 640 images in each layout, planar and
    flat (NHWC rows, K3), three steps of the step loop's batches under
    mixup 0.5 at a global B=64: every rank's batches bitwise equal, K3
    twice a step in the flat run and K2 never, K2 twice a step in the
    planar one; with one card it is not run. ``--phase ddp`` runs phases 1,
    2 and 13 alone (its last lines: the ranks' launches, the card, the
    result);
14. hosts: several hosts joined from the environment, each host a process
    tree of its own (this script run with ``--hosts-child``, its children
    the host's ranks). (a) Two hosts under ``KOD_*``, one gloo rank each on
    this card, a host's batch of 32 (global 64), over phase 13's 640 fake
    images: 10 steps of the step loop, then 10 of the fused epoch (run
    eagerly: a gloo group cannot be captured), each validated: K2/K4/K5 10
    on each rank for each loop and K1 twice a validation (a rank's 64
    images in batches of its host's 32); the ranks' weights
    bitwise equal; each host's first plan equal to ``_epoch_plan`` on the
    CPU for that host, the two different; the first three fused losses
    within rtol 1e-3 of one process at B=64 started from rank 0's state
    after the step loop (every gap printed); both ranks reading the
    one-process mAP dict (in batches of 32, the ranks' own). (b) With four cards, phase 13 (c)'s config at a
    host's batch of 128 (64 a card, global 256): one host of four cards
    (``launch``), then two hosts of two (``CUDA_VISIBLE_DEVICES`` 0,1 and
    2,3) by ``KOD_*`` and by ``torch.distributed.run`` (c10d rendezvous on
    127.0.0.1): launches, the weights bitwise the one host's (else the
    largest difference, and the phase fails), img/s over the fit's windows and over a
    profiled 10-step epoch, NCCL kernel ms a step, idle share and peak
    memory per rank; with fewer cards it prints that (b) needs four.
    ``--phase hosts`` runs phases 1, 2 and 14 alone;
15. rest: what the port ran last on one host, at phase 8's width over a
    640-image fake corpus on the card. (a) Each ``model.remat_policy``
    (``conv_out``, ``conv_out_bn_stats``, ``nothing``) against none, run
    twice for the card's own run-to-run gap, with
    ``cudnn.deterministic``: a fused fit of 4 steps at 416 B=64, then a
    timed fused epoch of 10 replays (K2/K4/K5 10 each by replay), and the
    step loop at 640 B=32 (JAX's remat resolution): the gradients, the
    parameters after SmartSGD and the running statistics of each policy
    bitwise those of ``nothing``, the fullest recompute (else the largest
    gap, which may be no more than twice the run-to-run gap without
    remat); remat keeps the plain BatchNorm + SiLU where no remat takes
    BS, so the gap to no remat is printed, not held; peak memory (``max_memory_allocated`` above what
    was allocated before) and ms a step; then, over NCCL ranks (one, or
    two where two cards are visible; the global BatchNorm, its all-reduces
    captured in the graph), a fused
    fit of 4 steps of each policy against none (twice): bitwise as above,
    K2/K4/K5 4 each and K1 1 on each rank, and the all-reduces issued a step body
    3 x BN + 3, plus 2 x BN under ``conv_out`` and ``nothing`` (the
    recompute reissues the statistics' sums). (b) ``data.warp_pallas=False``:
    one fused epoch (K5 0, K2 and K4 once a step) beside K5's, img/s each;
    the dense warp's pixels on the same rows and draws (HSV off) within
    JAX's fast class of K5's (<= 2 units, >= 85% equal), boxes, labels and
    masks equal. (c) Two gloo ranks on this card, the step loop at a
    global B=64 in f32 under a planted overflow
    (``assign_compact_slots=2``), against one process: ``assign_drop``
    equal step for step, the first three losses within rtol 1e-5, K2/K4/K5
    3 each and K1 1 on each rank; and the loss's forward and backward at
    a rank's static table over four cards, before (128 x B_local slots a
    level) and after (min(128 x B_global, K)). (d) The same two ranks on
    the host pipeline (fake canvases), one epoch: the batches made by each
    rank (rank 0 every step, rank 1 none) and the feed's img/s. (e)
    ``entry.dryrun_multichip`` on every card visible: the step, the fused
    epoch and the sharded corpus's fused epoch, with rank 0's launches.
    ``--phase rest`` runs phases 1, 2 and 15 alone;
16. spatial: DP x SP spatial sharding, yolov5s (nc=10) at 1280 px, each
    rank a ``(data, model)`` mesh's band of half its images' rows, the row
    halos of every conv and pool exchanged by hand, the heads gathered, the
    BatchNorms over every rank. (a) Two gloo ranks on this card as a
    ``(1, 2)`` mesh (the halos staged through the CPU): three steps at a
    global B=8 against one process taking the same steps from the same
    weights (seed 0, random boxes from seed 0). In f32 the losses within
    rtol 1e-5 and ``assign_drop`` equal; in f64 the parameters and running
    statistics within 1e-10; in f32 those reported against one process and
    against the f64 step beside one process's own distance to it, not held
    to JAX's ``test_dp_sp_matches_single_device`` bound (1e-4): a max
    pool's argmax flips at near-ties under any other f32 rounding, and one
    process in f32 lies ~1.2e-4 from the f64 step itself (PERF.md, section 6);
    the guard at heights 64 and 96 raising "rows per shard" and 128 running;
    one step under ``remat_policy="conv_out"`` against none (twice, under
    ``cudnn.deterministic``: no larger than twice the run-to-run gap); the
    halo bytes sent a step. (b) With two cards, NCCL ranks on cards 0-1 as
    ``(1, 2)``: the checks of (a), then the bf16 step at a global B=16: ms a
    step, peak memory per rank against one process at the same global
    batch on one card, the halo bytes a step and one profiled step's NCCL
    kernel ms by kernel (send/receive: the halos; all-gather: the heads;
    all-reduce: BatchNorm and the gradient) and idle share. (c) With four
    cards, ``(2, 2)`` with the checks of (b), and
    ``entry.dryrun_multichip(4)`` (dry runs 1-4). Fewer cards print that
    (b) or (c) is not run. K1-K5 are not on this path: their launches read
    0 and are reported. ``--phase spatial`` runs phases 1, 2 and 16 alone;
17. corpus: the main path from a JPEG corpus at full width:
    ``cli.train.main`` with ``experiment=yv5s`` (yolov5s, nc=10, 416, B=64,
    bf16), ``data.pipeline=device data.device_cache=True`` and the fused
    epoch, over 2,496 train (half ``bench.py:237``'s count, a depth cut to
    make room for phase 20) and 320 val JPEG files at 640 x 640 written
    from seeds by ``build_synthetic_dataset`` in 8 processes, two epochs,
    validated once: the letterbox once a chunk of 256 files at decode (10 +
    2), K2/K4/K5 78 each by replay, K1 5; finite
    losses and mAP; the first 64 corpus rows against the CPU path. Printed:
    the corpus's decode img/s and seconds, the decode threads, the bytes
    copied up, img/s over both epochs' windows, the val cache's decode
    time, the mAP dict; then the same command over the fake corpus of the
    same size (no validation) beside it, an observation, not a claim;
18. flat: ``data.corpus_layout=flat``, the corpus held on the card as the
    NHWC rows the host makes and gathered by K3 on their (N, 8, D/8) view,
    at phase 8's width beside phase 6's planar corpus. Set-up: the same
    canvases copied up in each layout, in turns (the planar one transposed
    on the card, the NHWC one as it is), the NHWC rows equal to phase 6's
    corpus transposed. K3 held BITWISE against its plain version on the
    NHWC corpus's view at a mosaic step's 256 rows and a no-mosaic step's
    64, and timed in turns against it and ``torch.index_select`` (the
    ``kernels`` line's K3 numbers), and a step's flat gather (K3 and the
    permute-copy to planar) beside K2. Under ``cudnn.deterministic``: (a)
    four fused fits of 40 steps from the same weights and seed, in turns
    over the planar, flat, flat and planar corpus (no validation): the
    weights after every fit bitwise equal; launches zeroed just before and
    read just after each fit, K3 40 and K2 0 over the flat corpus (K2 40
    and K3 0 over the planar), K4 and K5 40, K1 0; each fit's img/s over
    the epoch's window (an observation); (b) the
    repeat-factor recipe without mosaic on the step loop, 10 steps of 64
    rows in each layout: batches and weights bitwise equal, K3 (or K2) and
    K4 10, K5 0. Then (c) ``cli.train experiment=yv5s data.pipeline=device
    data.device_cache=True data.corpus_layout=flat`` over 640 fake images,
    one fused epoch without validation: K3, K4, K5 10 each by replay, K2
    and K1 0, finite losses. ``--phase flat`` runs phases 1, 2 and 18 alone;
19. carry: the training state carried across the JAX package's layout
    on the main path (yolov5s, nc=10, 416, B=64, bf16, the fused epoch over
    640 fake images on the card, 10 steps an epoch, ``cudnn.deterministic``),
    all through ``Trainer.from_config(compose(...))``: (a) one epoch from
    seed 0, which saves the port's own ``last``; (b) that file through
    ``models/convert.py:torch_to_flax_state`` (nested numpy dicts in the
    layout Orbax restores the JAX ``TrainState`` in, what
    ``tools/orbax_to_torch.py`` hands over) and (c) back through
    ``flax_state_to_torch`` and ``train/checkpoint.py:save_state``, bitwise
    the port's own file; (d) a trainer resumed from the converted file with
    ``ckpt_path=``: its parameters, BatchNorm statistics, momentum buffers
    and step bitwise those (a)'s trainer holds at the end of its epoch, it
    starts at epoch 1, and it fits the second epoch with validation: its
    first step's hyperparameter row (and its ``lr``) equal to
    ``SmartSGD.hyperparams(10)``, K2/K4/K5 10 each by replay and K1 once a
    validation batch (launches zeroed just before and read just after the
    fit), finite losses and mAP; each part's seconds. A resumed run draws
    the first epoch's data plan again (the sampler and the generators are
    not in a checkpoint, in either package), so it is not compared with
    (a)'s trainer going on.
    ``--phase carry`` runs phases 1, 2 and 19 alone;
20. sizes: yolov5m (``model.net.deepen_factor=0.67
    model.net.widen_factor=0.75``) and yolov5l (the default network of
    ``configs/nn/networks/yv5.yaml``, no ``experiment=``) at full width,
    nc=10, bf16, over fake corpora of 12 steps an epoch on the card: (a) m
    at 640, B=96 through ``Trainer.from_config``, (b) l at 640, B=128 (under
    the remat policy ``SIZES_RUNS`` names, measured by
    ``tools/remat_peaks.py`` to fit the card) and at 416, B=64 without
    remat, both through ``cli.train.main``; each a fused fit of 3 epochs
    validated after the last: the parameter count of the size, img/s over
    the fit's epoch windows summed (the first holds the set-up: cuDNN's
    first calls at these shapes, the warm-up steps, the capture) and over
    the device's walls of epochs 2 and 3 (marks), ``max_memory_allocated``, K2/K4/K5 3 x 12 by replay and K1 once a
    validation batch (launches zeroed just before and read just after),
    finite losses and mAP. (c) one more
    ``validate`` of l over its 640 val cache (K1 a batch), K2, K5 and K4
    held BITWISE against their plain versions at l's 640 B=128 step (the
    plain versions 16 groups a call), and
    serving l at 640, B=32 through ``make_eval_step`` (K1 held bitwise on
    its candidates; img/s over 60 steps, K1 once a step, peak memory). (d)
    under ``cudnn.deterministic``, at m and l, 5 fused steps at 640, B=16
    graphed bitwise the eager ones (state and losses; K2/K4/K5 5 in the
    graphed run), and the first bf16 step's losses against the card's own
    f32 step from the same weights on the same batch, each within
    ``BF16_LOSS_RTOL`` (5%, the reasoning at the constant) and above 0.
    ``--phase sizes`` runs phases 1, 2 and 20 alone;
21. the ``kernels`` JSON line (with each path's launches; K3's
    ``launches`` are phase 18 (a)'s, BS's phase 12's fused fit's), the card line, and the result line
    last.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
NMS_OPS_PER_PAIR = 14  # 4 min/max, 2 sub, 2 clamp, 1 mul, 2 add/sub, +eps, div, cmp
HSV_OPS_PER_PIXEL = 75  # per pixel position, 3 channels: csrc/hsv.cu counted op by op
WARP_OPS_PER_TAP_ROW = 12  # per live (quadrant, row), output pixel and channel

SERVE_B, SERVE_S, NC = 32, 640, 10
SERVE_STEPS = 200  # a window of seconds, so host jitter averages out of img/s
VAL_B, VAL_S, VAL_N = 64, 416, 320
CONF, IOU, MAX_NMS, MAX_DET = 0.001, 0.6, 2048, 300
TRAIN_N, TRAIN_B, TRAIN_S, MAX_TARGETS = 4992, 64, 416, 120  # bench.py:237 corpus
TRAIN_STEPS, TIMED_STEPS = 40, 30
RECIPE_STEPS, AFFINE_STEPS = 10, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check_err(err: int) -> None:
    if err:
        fail(f"baseline kernel launch failed: cudaError {err}")


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn()``, from CUDA events around ``reps`` calls
    in a row: the host enqueues ahead of the card, so the launch overhead of
    a call does not show between two kernels."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain, reps_kernel: int, reps_plain: int):
    """ms per call of kernel and plain, each a run of calls in a row, timed in
    turns (plain, kernel, kernel, plain); the median of each one's turns."""
    for _ in range(3):
        kernel()
    plain()
    turns = {"plain": [], "kernel": []}
    for who in ("plain", "kernel", "kernel", "plain"):
        fn, reps = (kernel, reps_kernel) if who == "kernel" else (plain, reps_plain)
        turns[who].append(run_ms(fn, reps))
    return statistics.median(turns["kernel"]), statistics.median(turns["plain"]), turns


def bound(n_bytes: float, n_ops: float):
    """(bound ms, what sets it) from bytes at 3.35 TB/s and f32 ops at 67 TFLOP/s."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def check_equal(name: str, got, want) -> float:
    """Fail unless bitwise equal; returns the max abs difference (0)."""
    eq = torch.equal(got, want)
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    log(f"[kernels] {name}: bitwise_equal={eq} max_abs_err={err}")
    if not eq:
        fail(f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return err


def used_lines(j, w0, w1, S):
    """Per (group, quadrant): source rows (or columns) that carry a non-zero tap."""
    G, Q, _ = j.shape
    used = torch.zeros(G, Q, S, dtype=torch.int8, device=j.device)
    for k, w in enumerate((w0, w1)):
        jj = j.long() + k
        ok = ((w != 0) & (jj >= 0) & (jj < S)).to(torch.int8)
        used.scatter_reduce_(2, jj.clamp(0, S - 1), ok, "amax")
    return used.sum(-1).double()


def nms_pairs_needed(keep, live) -> int:
    """Pair tests any exact greedy NMS must make on these inputs.

    A kept box must be tested against every kept box before it; a suppressed
    live box needs at least one test (against the box that suppresses it).
    """
    k = keep.to(torch.int64)
    kept_before = k.cumsum(dim=1) - k
    pairs = (kept_before * k).sum() + (live & ~keep).sum()
    return int(pairs)


LB_N = 256  # images a letterbox batch: DECODE_ROWS, a chunk of the corpus decode
LB_SIZES = [(480, 640), (640, 480), (427, 640), (375, 500), (1, 517), (517, 1), (1203, 97)]  # (h, w)
LETTERBOX_OPS_PER_PIXEL = 48  # per content pixel, 3 channels: csrc/letterbox.cu counted op by op (an FMA 2)
# phase 17: JPEG files at 640 px, half bench.py:237's count of 4,992 (cut to make room for phase 20)
CORPUS_N, CORPUS_VAL, CORPUS_PX = 2496, 320, 640
CORPUS_NAME, CORPUS_EPOCHS, CORPUS_SHARDS = "synthetic-hard-zipf-640", 2, 8


def _raw_batch(sizes, seed: int):
    """Seeded (h, w, 3) uint8 images (None: a failed file) as ``RawImages``."""
    import numpy as np

    from object_detection_cib_torch.data.native_loader import RawImages

    rng = np.random.default_rng(seed)
    return RawImages.from_arrays([None if hw is None else rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                                  for hw in sizes])


def phase_letterbox(card, dev, resources):
    """The letterbox kernel (``csrc/letterbox.cu``, the port's own: it ports
    ``native/loader.cpp:75-118``) against its plain version, bitwise, on
    batches of 256 seeded raw images: COCO-like and extreme sizes with a
    failed file, and the main path's 640 x 640, each at S = 416 and 640, top
    left and centred, planar and (the validation cache's) NHWC. Then each
    batch at 416 timed in turns with its plain version, beside
    ``F.interpolate`` + pad (bilinear, align_corners=False; it does not round
    as loader.cpp does, so its bytes are only compared) and the bytes bound.
    Returns (max abs err, (ms, plain ms, library ms, bound ms, bound by) and
    (call ms, library call ms) of the main path's batch)."""
    import numpy as np
    import torch.nn.functional as F

    from object_detection_cib_torch.ops import letterbox as lb

    mixed = [None if i == 5 else LB_SIZES[i % len(LB_SIZES)] for i in range(LB_N)]
    batches = {"COCO-like and extreme sizes, a failed file": (mixed, 1),
               f"the main path's {CORPUS_PX}x{CORPUS_PX}": ([(CORPUS_PX, CORPUS_PX)] * LB_N, 2)}
    err, out = 0.0, None
    for name, (sizes, seed) in batches.items():
        raw = [t.to(dev) for t in _raw_batch(sizes, seed)[:3]]
        hw = raw[2].cpu().tolist()
        for S in (416, 640):
            for center, nhwc in ((False, False), (True, False), (True, True)):
                shape = (LB_N, S, S, 3) if nhwc else (LB_N, 3, S, S)
                got, want = (torch.zeros(shape, dtype=torch.uint8, device=dev) for _ in range(2))
                view = (lambda t: t.permute(0, 3, 1, 2)) if nhwc else (lambda t: t)
                got_sizes = lb.letterbox(*raw, view(got), center)
                torch.cuda.synchronize()
                want_sizes = lb.letterbox_plain(*raw, view(want), center)
                tag = f"letterbox {name} S={S} {'centred' if center else 'top-left'}{' NHWC' if nhwc else ''}"
                err = max(err, check_equal(tag, got, want), check_equal(tag + " sizes", got_sizes, want_sizes))
        # timed at the training size, 416, top-left into planar rows
        S = 416
        rows = torch.empty((LB_N, 3, S, S), dtype=torch.uint8, device=dev)
        spare = torch.empty_like(rows)
        kernel = lambda: lb.letterbox(*raw, rows)  # noqa: E731
        plain = lambda: lb.letterbox_plain(*raw, spare)  # noqa: E731
        sizes_out = kernel().cpu().tolist()
        if sizes_out[0] == [0, 0]:
            fail("letterbox: the first image has no content")
        if hw.count([0, 0]) != sum(s is None for s in sizes):
            fail("letterbox: the failed file's size is not (0, 0)")
        if len({tuple(h) for h in hw}) == 1:  # one size: one library call for the batch
            h0, w0 = hw[0]
            src = raw[0].view(LB_N, h0, w0, 3).permute(0, 3, 1, 2)
            nh, nw = sizes_out[0]

            def library():
                y = F.interpolate(src.float(), size=(nh, nw), mode="bilinear", align_corners=False)
                return F.pad(y.round_().clamp_(0, 255).to(torch.uint8), (0, S - nw, 0, S - nh), value=lb.FILL)
        else:  # a call per image
            imgs = [(raw[0][off:off + h * w * 3].view(1, h, w, 3).permute(0, 3, 1, 2), sz)
                    for (h, w), off, sz in zip(hw, raw[1].cpu().tolist(), sizes_out) if h]

            def library():
                return [F.pad(F.interpolate(x.float(), size=tuple(sz), mode="bilinear", align_corners=False)
                              .round_().clamp_(0, 255).to(torch.uint8), (0, S - sz[1], 0, S - sz[0]), value=lb.FILL)
                        for x, sz in imgs]

        k_ms, p_ms, turns = in_turns(kernel, plain, 30, 2)
        lib_ms = statistics.median([run_ms(library, 10) for _ in range(2)])
        lib_out = library()
        lib_out = lib_out if torch.is_tensor(lib_out) else None
        n_bytes = (raw[0].numel() + 8 * raw[1].numel() + 4 * raw[2].numel() + rows.numel()
                   + 4 * 2 * LB_N)
        n_ops = float(sum(nh * nw for nh, nw in sizes_out)) * LETTERBOX_OPS_PER_PIXEL
        b_ms, b_by = bound(n_bytes, n_ops)
        call = cuda_ms(kernel, 30), cuda_ms(library, 30)
        log(f"[kernels] letterbox {name} ({LB_N} images, {raw[0].numel()} B decoded) -> {LB_N}x3x{S}x{S}: "
            f"kernel {k_ms:.4f} ms (30 in a row), plain {p_ms:.4f} ms (turns {turns}), F.interpolate + pad "
            f"{lib_ms:.4f} ms ({'one call' if lib_out is not None else 'a call per image'}); bound "
            f"{b_ms:.6f} ms ({b_by}: {n_bytes} B, {n_ops:.0f} ops), {b_ms / k_ms:.4f} of the bound, "
            f"{n_bytes / k_ms / 1e6:.1f} GB/s | {card}")
        log(f"[kernels] letterbox one call from an idle stream, host launch path included (median of 30): "
            f"kernel {call[0]:.4f} ms, F.interpolate + pad {call[1]:.4f} ms | {card}")
        if lib_out is not None:
            same = float((lib_out == rows).float().mean())
            log(f"[kernels] letterbox: F.interpolate + pad equals the kernel on {same:.6f} of the bytes "
                f"(another rounding: not a substitute)")
            out = (err, (k_ms, p_ms, lib_ms, b_ms, b_by), call)
    log(f"[kernels] letterbox.cu: {resources('letterbox_kernel', 0)}")
    return out


BS_REPS = 20  # phase 7's BatchNorm + SiLU: replays of a captured call in a turn
BS_FIT_N, BS_FIT_VAL, BS_FIT_STEPS = 640, 64, 10  # --phase bn_silu's fused fit: images, val images, steps


def _graphed(fn):
    """``fn`` captured as a CUDA graph (after two calls on a side stream);
    its replay enqueues the card's work without the host's dispatch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g.replay


def phase_bn_silu(card, dev, resources):
    """Phase 7's training BatchNorm + SiLU (``ops/bn_silu.py``) at every
    layer shape of yolov5s and yolov5l at 416, B = 64: the kernels held to
    their plain versions within ``test_utils/bn_silu.py``'s limits, the op
    through autograd bitwise the kernels it calls, then timed in turns with
    the plain layers (a captured graph of one forward and backward each,
    the kernels called as the op calls them),
    beside ``F.batch_norm(training=True)`` + ``F.silu`` and the bound of 10
    B an element at 3.35 TB/s. Returns (y's largest gap from the plain
    version of the kernels' own statistics, (ms, plain_ms, library_ms,
    bound_ms, "bytes") over yolov5s's layers a step, (call_ms,
    library_call_ms) of one forward and backward at yolov5s's stem)."""
    import torch.nn.functional as F

    from object_detection_cib_torch.models.layers import BatchNorm
    from object_detection_cib_torch.ops import bn_silu as bn_ops
    from object_detection_cib_torch.test_utils import bn_silu as bn_cases

    y_err, a_step, calls = 0.0, {}, None
    for net, shapes in bn_cases.LAYERS.items():
        total = dict(ms=0.0, plain=0.0, library=0.0, bound=0.0)
        for side, C, count in shapes:
            x, dy, w, b, rm, rv = bn_cases.layer_inputs(dev, TRAIN_B, C, side, side, seed=side * 7 + C)
            M = x.numel() // C
            gaps = bn_cases.against_plain(x, dy, w, b, rm, rv)
            over = bn_cases.exceeded(gaps)
            if over:
                fail(f"[bn_silu] yolov5{net} ({M} rows, {C}): beyond the limits {over}; gaps {gaps}")
            y_err = max(y_err, gaps["y_own_abs"])
            rk, vk = rm.clone(), rv.clone()

            def leaves(*ts):
                """Fresh leaves for each use: the autograd engine syncs a
                leaf's first stream into every later backward through it,
                which a capture on another stream cannot take."""
                return [t.detach().clone().requires_grad_(True) for t in ts]

            def kernel():  # the kernels the op launches, forward then backward
                y, st = bn_ops._forward_kernels(x, w, b, rk, vk, 0.03, 1e-3)
                return y, bn_ops._backward_kernels(x, dy, w, b, st)

            xo, wo, bo = leaves(x, w, b)

            def op():  # the same through autograd, as a training step calls it
                return torch.autograd.grad(bn_ops.bn_silu_train(xo, wo, bo, rk, vk, 0.03, 1e-3), (xo, wo, bo), dy)

            with torch.enable_grad():
                got = (bn_ops.bn_silu_train(xo, wo, bo, rm.clone(), rv.clone(), 0.03, 1e-3),)
                got += torch.autograd.grad(got[0], (xo, wo, bo), dy)
            y_k, stats = bn_ops._forward_kernels(x, w, b, rm.clone(), rv.clone(), 0.03, 1e-3)
            if not all(torch.equal(a, c) for a, c in zip(got, (y_k,) + bn_ops._backward_kernels(x, dy, w, b, stats))):
                fail(f"[bn_silu] yolov5{net} ({M} rows, {C}): the op through autograd differs from its kernels")
            bn = BatchNorm(C).to(dev)
            with torch.no_grad():
                bn.weight.copy_(w)
                bn.bias.copy_(b)
            (xp,) = leaves(x)

            def plain():
                return torch.autograd.grad(F.silu(bn(xp)), (xp, bn.weight, bn.bias), dy)

            rl, vl = rm.clone(), rv.clone()
            xl, wl, bl = leaves(x, w, b)

            def library():
                y = F.silu(F.batch_norm(xl, rl, vl, wl, bl, training=True, momentum=0.03, eps=1e-3))
                return torch.autograd.grad(y, (xl, wl, bl), dy)

            with torch.enable_grad():
                k_ms, p_ms, turns = in_turns(_graphed(kernel), _graphed(plain), BS_REPS, BS_REPS)
                lib_replay = _graphed(library)
                lib_ms = statistics.median([run_ms(lib_replay, BS_REPS) for _ in range(2)])
                if calls is None:  # the stem of yolov5s, one eager call from an idle stream
                    xl, wl, bl = leaves(x, w, b)
                    calls = (cuda_ms(op, 30), cuda_ms(library, 30))
            b_ms = bound(10 * M * C, 0)[0]
            for key, v in (("ms", k_ms), ("plain", p_ms), ("library", lib_ms), ("bound", b_ms)):
                total[key] += count * v
            log(f"[bn_silu] yolov5{net} {M} rows x {C} ({count} layers): kernels {k_ms:.4f} ms, plain layers "
                f"{p_ms:.4f} ms (turns {turns}), F.batch_norm + F.silu {lib_ms:.4f} ms, bound {b_ms:.6f} ms "
                f"(bytes: {10 * M * C} B), {b_ms / k_ms:.4f} of it; gaps "
                f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} } | {card}")
            del x, dy, xo, xp, xl, bn, got, y_k, stats, lib_replay
            torch.cuda.empty_cache()
        a_step[net] = total
        log(f"[bn_silu] yolov5{net}'s {sum(c for *_, c in shapes)} layers a step at 416 B={TRAIN_B}: kernels "
            f"{total['ms']:.4f} ms, plain layers {total['plain']:.4f}, F.batch_norm + F.silu {total['library']:.4f}, "
            f"bound {total['bound']:.6f} ({total['bound'] / total['ms']:.4f} of it) | {card}")
    log(f"[bn_silu] one forward and backward at yolov5s's stem from an idle stream, host launch path included "
        f"(median of 30): the op {calls[0]:.4f} ms, F.batch_norm + F.silu {calls[1]:.4f} ms | {card}")
    log(f"[kernels] bn_silu.cu: {resources('bn_silu_', 0)}")
    s = a_step["s"]
    return y_err, (s["ms"], s["plain"], s["library"], s["bound"], "bytes"), calls


def bn_silu_fit(card, dev):
    """``--phase bn_silu``'s main-path fit: the fused epoch (the config's
    default loop) of yolov5s at 416, B = 64, bf16 over BS_FIT_N fake images,
    BS_FIT_STEPS steps and a validation, launches zeroed just before and read
    just after: BS once a training BatchNorm a step (by replay), K2, K4, K5
    once a step. Returns the launches."""
    import numpy as np

    from object_detection_cib_torch.data.host_augment import AugParams
    from object_detection_cib_torch.data.synthetic import build_fake_manifest
    from object_detection_cib_torch.models.layers import ConvBnAct
    from object_detection_cib_torch.train.trainer import Trainer

    train_info = build_fake_manifest(num_classes=NC, num_images=BS_FIT_N, seed=0, zipf_a=1.01)
    val_info = build_fake_manifest(num_classes=NC, num_images=BS_FIT_VAL, image_size=VAL_S, zipf_a=1.01, seed=0)
    t = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B, aug_params=AugParams(),
                max_targets=MAX_TARGETS, seed=0, dtype=torch.bfloat16, device=dev, max_epochs=1)
    n_bn = sum(isinstance(m, ConvBnAct) for m in t.net.modules())
    _zero_kernels()
    m = t.fit(max_epochs=1, epoch_steps=BS_FIT_STEPS)
    torch.cuda.synchronize()
    got = _read_kernels()
    want = {"bn_silu_train": BS_FIT_STEPS * n_bn, "gather_rows_planar": BS_FIT_STEPS,
            "hsv_planar": BS_FIT_STEPS, "warp_quadrants": BS_FIT_STEPS}
    if n_bn != 57 or t._fused_fn is None or {k: got[k] for k in want} != want:
        fail(f"[bn_silu] fused fit: {n_bn} training BatchNorms, launches {got}, want {want}")
    losses = t.epoch_metrics[0]["total"]
    if not np.isfinite(losses).all() or not finite_map(m):
        fail(f"[bn_silu] fused fit: losses or mAP not finite: {losses}, {m}")
    log(f"[bn_silu] fused fit of yolov5s at {TRAIN_S}, B={TRAIN_B}, {BS_FIT_STEPS} steps: launches {got} "
        f"({n_bn} training BatchNorms x {BS_FIT_STEPS} steps); losses {losses[0]:.4f}->{losses[-1]:.4f} | {card}")
    return got


JPEG_TRAIN_N, JPEG_VAL_N, JPEG_STEPS = 640, 128, 5
CLI_N = 640  # data.fake_num_images: the train and the val set of phase 11


def host_libraries(native_loader):
    """({library: version}, {library: why it is missing}) for phase 10: cv2
    and Pillow (the host pipeline; Pillow also decodes the device feeds'
    JPEG files), and, as information only, libjpeg (the JAX package's
    native loader, built in place: the port does not use it)."""
    import importlib

    have, missing = {}, {}
    for mod, label in (("cv2", "cv2"), ("PIL", "Pillow")):
        try:
            have[label] = getattr(importlib.import_module(mod), "__version__", "?")
        except ImportError as e:
            missing[label] = f"{label} is not installed on this machine ({e})"
    try:
        have["libjpeg"] = str(native_loader.build())
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        why = ("jpeglib.h, libjpeg's header, is not installed on this machine" if "jpeglib.h" in str(e)
               else f"the build failed: {str(e).strip().splitlines()[-1]}")
        missing["libjpeg"] = (f"the JAX package's native loader (native/loader.cpp, -ljpeg) does not build: "
                              f"{why} (information only: the port decodes with Pillow)")
    return have, missing


class CanvasReader:
    """A sample reader that hands out a val cache's centered canvases and
    targets: the host feed then validates on the cache's very pixels."""

    def __init__(self, cache, info):
        self.cache, self.index = cache, {s.id: j for j, s in enumerate(info.samples)}

    def __call__(self, sample, letter_box=True):
        from object_detection_cib_torch.data.reader import AugmentedSample

        j = self.index[sample.id]
        m = self.cache.gt_mask[j]
        return AugmentedSample(self.cache.canvases[j].cpu().numpy(), self.cache.gt_boxes[j][m],
                               self.cache.gt_labels[j][m].astype("int64"))


def finite_map(m) -> bool:
    """Every summary of an mAP dict finite (a class without ground truth in
    the val set reads NaN, as in the JAX package)."""
    return all(math.isfinite(v) for k, v in m.items() if "_class_" not in k)


def one_process_map(t, eval_batch: int) -> dict:
    """The mAP dict of ``t``, a trainer of one process, over its whole
    validation set in batches of ``eval_batch``: the batch each rank of the
    run it is held against validates at."""
    from object_detection_cib_torch.train.trainer import Evaluator

    t.evaluator = Evaluator(t.net, t.anchors, t.classes, eval_batch, **t.evaluator.nms, device=t.device)
    return t.validate()


def same_map(a, b) -> bool:
    """Equal mAP dicts, NaN equal to NaN."""
    return a.keys() == b.keys() and all(a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def whole_steps_enqueue(step, reps: int = 5):
    """Host ms to enqueue ``step()`` from an idle card: median and runs."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        runs.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(runs), [round(t, 4) for t in runs]


def phase_jpeg(card, dev, aug, counted, zero_counts, read_counts):
    """Phase 10: train and validate from JPEG files at the training width
    (yolov5s, nc=10, 416, batch 64, bf16) through the three feeds. Returns
    each part's launch counts. Without Pillow or cv2 it fails; everything
    else raises on failure too."""
    import numpy as np

    from object_detection_cib_torch.data import device_pipeline as dp
    from object_detection_cib_torch.data import native_loader
    from object_detection_cib_torch.data.device_pipeline import DeviceCorpus, DeviceDataPipeline
    from object_detection_cib_torch.data.host_augment import ValidationSampleAugmentor
    from object_detection_cib_torch.data.pipeline import DetectionDataset, Prefetcher
    from object_detection_cib_torch.data.synthetic import build_synthetic_dataset
    from object_detection_cib_torch.data.val_cache import ValDeviceCache
    from object_detection_cib_torch.train.trainer import Trainer

    have, missing = host_libraries(native_loader)
    log("[jpeg] probe: " + "; ".join([f"{k} {v}" for k, v in have.items()] + list(missing.values())))
    for lib in ("Pillow", "cv2"):
        if lib in missing:
            fail(f"[jpeg] {missing[lib]}: phase 10 needs it")
    kw = dict(size="s", image_size=TRAIN_S, batch_size=TRAIN_B, aug_params=aug, max_targets=MAX_TARGETS,
              seed=0, dtype=torch.bfloat16, device=dev, max_epochs=1)
    steps = JPEG_TRAIN_N // TRAIN_B
    counts = {}

    def expect(part, got, want):
        for k, n in want.items():
            if got[k] != n:
                fail(f"[jpeg] ({part}) launched {k} {got[k]} times, want {n}")

    with tempfile.TemporaryDirectory(prefix="jpeg-corpus-") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        train_info = build_synthetic_dataset(root, "synthetic-hard-zipf", num_images=JPEG_TRAIN_N,
                                             image_size=TRAIN_S, seed=0)
        val_info = build_synthetic_dataset(root, "synthetic-hard-zipf-val", num_images=JPEG_VAL_N,
                                           image_size=TRAIN_S, seed=1)
        n_bytes = sum((root / s.image_path).stat().st_size for s in train_info.samples + val_info.samples)
        log(f"[jpeg] setup: synthetic-hard-zipf {JPEG_TRAIN_N} train + {JPEG_VAL_N} val JPEG files at "
            f"{TRAIN_S} px ({n_bytes} B) written by build_synthetic_dataset in "
            f"{time.perf_counter() - t0:.2f} s")

        # (a) the corpus on the card, decoded from the files, fit over one epoch
        t0 = time.perf_counter()
        zero_counts()
        tr_a = Trainer(train_info, val_info, fake_mode=False, root_dir=root, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        counts["a_decode"] = read_counts()
        chunks = -(-JPEG_TRAIN_N // dp.DECODE_ROWS) + -(-JPEG_VAL_N // dp.DECODE_ROWS)
        expect("a_decode", counts["a_decode"], {"letterbox": chunks, "gather_rows_planar": 0})
        corpus = tr_a.pipeline.device_corpus
        t0 = time.perf_counter()
        head = train_info._replace(samples=train_info.samples[:JPEG_VAL_N])  # the plain letterbox is slow
        cpu = DeviceCorpus.decode(head, TRAIN_S, "cpu", root)
        if not (torch.equal(corpus.images[:JPEG_VAL_N].cpu(), cpu.images)
                and torch.equal(corpus.sizes[:JPEG_VAL_N].cpu(), cpu.sizes)):
            fail("[jpeg] (a) the corpus decoded on the card differs from the CPU path's")
        cpu_val = ValDeviceCache(val_info, tr_a.val_indices, TRAIN_S, MAX_TARGETS, root_dir=root)
        if not torch.equal(tr_a.val_cache.canvases.cpu(), cpu_val.canvases):
            fail("[jpeg] (a) the validation cache decoded on the card differs from the CPU path's")
        cpu_s = time.perf_counter() - t0
        log(f"[jpeg] (a) corpus {tuple(corpus.images.shape)} uint8 = {corpus.images.numel()} B and the "
            f"{JPEG_VAL_N}-image validation cache decoded from the JPEG files on the card (letterbox "
            f"launches {counts['a_decode']['letterbox']}); the first {JPEG_VAL_N} corpus rows and the whole "
            f"validation cache equal the CPU path's (Pillow + the plain letterbox, {cpu_s:.2f} s there) byte "
            f"for byte; trainer set-up {setup_s:.2f} s")
        del cpu, cpu_val
        before = [p.detach().clone() for p in tr_a.net.parameters()]
        marks = {}

        def on_step(epoch, i, m):
            if i in (0, steps - 1):
                torch.cuda.synchronize()
                marks[i] = time.perf_counter()

        zero_counts()
        m_a = tr_a.fit(max_epochs=1, on_step=on_step)
        counts["a"] = read_counts()
        n_val = math.ceil(JPEG_VAL_N / TRAIN_B)
        expect("a", counts["a"], {"gather_rows_planar": steps, "hsv_planar": steps, "warp_quadrants": steps,
                                  "greedy_nms_mask": n_val, "letterbox": 0})
        em = tr_a.epoch_metrics[-1]
        if not np.isfinite(em["total"]).all() or not finite_map(m_a):
            fail(f"[jpeg] (a) losses or mAP not finite: {em['total']}, {m_a}")
        unmoved = sum(torch.equal(a, b) for a, b in zip(before, tr_a.net.parameters()))
        if unmoved:
            fail(f"[jpeg] (a) {unmoved} of {len(before)} parameters did not move")
        del before
        pa = tr_a.pipeline
        idx = torch.from_numpy(pa._epoch_plan()[0][0].astype(np.int32)).to(dev)
        pa.consumed_plan_log.pop()  # drawn for timing only
        enq, runs = whole_steps_enqueue(lambda: tr_a.train_step(pa.gather_augment(idx, pa.draw())[0]))
        ips = (steps - 1) * TRAIN_B / (marks[steps - 1] - marks[0])
        log(f"[jpeg] (a) device_cache=True: fit over one epoch ({steps} steps) and validation of "
            f"{JPEG_VAL_N} images; launches {counts['a']}; losses {em['total'][0]:.4f}->{em['total'][-1]:.4f}, "
            f"all parameters moved, targets dropped {int(em['targets_dropped'])}; {ips:.2f} img/s over steps "
            f"2-{steps}; host enqueue of one whole step (median of 5) {enq:.4f} ms (runs {runs}) | {card}")
        log("[jpeg] (a) validation " + json.dumps(m_a))

        # (b) host-fed: the same augment on the card, the groups decoded by a
        # host thread and letterboxed on the card
        tr_b = Trainer(train_info, val_info, device_cache=False, fake_mode=False, root_dir=root,
                       enable_ram_cache=True, **kw)
        pb = tr_b.pipeline
        decoded = []
        real_decode = native_loader.decode_images

        def counting_decode(bufs, *a, **k):
            decoded.append(len(bufs))
            return real_decode(bufs, *a, **k)

        native_loader.decode_images = counting_decode
        try:
            kept, totals = [], []
            zero_counts()
            for i, (batch, _) in enumerate(pb.epoch(JPEG_STEPS)):
                totals.append(tr_b.train_step(batch).total)
                kept.append(batch)
                if i == 0:
                    torch.cuda.synchronize()
                    t_first = time.perf_counter()
            torch.cuda.synchronize()
            t_last = time.perf_counter()
            counts["b"] = read_counts()
            first_decoded = sum(decoded)
            seen = set(pb.consumed_plan_log[-1][:JPEG_STEPS].ravel().tolist())
            decoded.clear()
            for _ in pb.epoch(JPEG_STEPS):  # a second epoch decodes only the images the first did not
                pass
            new = set(pb.consumed_plan_log[-1][:JPEG_STEPS].ravel().tolist()) - seen
            if sum(decoded) != len(new):
                fail(f"[jpeg] (b) the second epoch decoded {sum(decoded)} images, want the {len(new)} "
                     f"its first {JPEG_STEPS} steps had not seen")
            held, held_bytes = pb.ram_cache_held()
            cache_note = (f"RAM cache: epoch 1 decoded {first_decoded} images in {JPEG_STEPS} steps, "
                          f"epoch 2 decoded {sum(decoded)}, exactly the {len(new)} not seen before; the cache "
                          f"holds {held} decoded images, {held_bytes} B")
        finally:
            native_loader.decode_images = real_decode
        expect("b", counts["b"], {"gather_rows_planar": 0, "hsv_planar": JPEG_STEPS,
                                  "warp_quadrants": JPEG_STEPS, "letterbox": JPEG_STEPS})
        losses = torch.stack(totals).tolist()
        if not all(math.isfinite(v) for v in losses):
            fail(f"[jpeg] (b) losses not finite: {losses}")
        ref = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS, seed=0,
                                 device=dev, corpus=corpus)
        for i, (want, _) in enumerate(ref.epoch(JPEG_STEPS)):
            if not all(torch.equal(x, y) for x, y in zip(kept[i], want)):
                fail(f"[jpeg] (b) step {i}: the host-fed batch differs from the device-cache one")
        equal_note = f"all {JPEG_STEPS} batches bitwise equal to the device-cache pipeline's (same seed)"
        g0 = pb._epoch_plan()[0][0]
        pb.consumed_plan_log.pop()  # drawn for timing only
        enq, runs = whole_steps_enqueue(lambda: tr_b.train_step(pb.load_augment(g0, pb.draw())[0]))
        log(f"[jpeg] (b) device_cache=False, {JPEG_STEPS} steps: launches {counts['b']}; losses "
            f"{losses[0]:.4f}->{losses[-1]:.4f}; {(JPEG_STEPS - 1) * TRAIN_B / (t_last - t_first):.2f} img/s "
            f"over steps 2-{JPEG_STEPS}; host enqueue of one whole step, its group loaded on the host "
            f"(median of 5) {enq:.4f} ms (runs {runs}); {cache_note}; {equal_note} | {card}")
        del kept, tr_b, pb

        # (c) the host pipeline (the repo's default config), and its validation feed
        # the host augmentor also runs aug_params.yaml's colour extras (p=0.01 each),
        # which the device augment has not
        tr_c = Trainer(train_info, val_info, pipeline="host", num_workers=8, fake_mode=False,
                       root_dir=root, **{**kw, "aug_params": aug._replace(image_color_transforms=True)})
        marks.clear()

        def on_step_c(epoch, i, m):
            if i in (0, JPEG_STEPS - 1):
                torch.cuda.synchronize()
                marks[i] = time.perf_counter()

        zero_counts()
        m_c = tr_c.fit(max_epochs=1, epoch_steps=JPEG_STEPS, on_step=on_step_c)
        counts["c"] = read_counts()
        expect("c", counts["c"], {"gather_rows_planar": 0, "hsv_planar": 0, "warp_quadrants": 0,
                                  "greedy_nms_mask": n_val, "letterbox": 0})
        em = tr_c.epoch_metrics[-1]
        if not np.isfinite(em["total"]).all() or not finite_map(m_c):
            fail(f"[jpeg] (c) losses or mAP not finite: {em['total']}, {m_c}")
        wait = tr_c.prefetcher.wait_seconds
        feed = iter(tr_c.prefetcher)
        batch = next(feed)
        feed.close()
        enq, runs = whole_steps_enqueue(lambda: tr_c.train_step(batch))
        log(f"[jpeg] (c) pipeline='host', num_workers=8, {JPEG_STEPS} steps and validation over "
            f"{JPEG_VAL_N} JPEG files: launches {counts['c']}; losses {em['total'][0]:.4f}->"
            f"{em['total'][-1]:.4f}, targets dropped {int(em['targets_dropped'])}; "
            f"{(JPEG_STEPS - 1) * TRAIN_B / (marks[JPEG_STEPS - 1] - marks[0]):.2f} img/s over steps "
            f"2-{JPEG_STEPS}; consumer waited on the queue {wait:.4f} s in all "
            f"({wait / JPEG_STEPS * 1e3:.4f} ms a step); host enqueue of one train step (median of 5) "
            f"{enq:.4f} ms (runs {runs}) | {card}")
        log("[jpeg] (c) validation " + json.dumps(m_c))
        del tr_c, batch

        # the two validation feeds on the same canvases
        vcache = tr_a.val_cache
        ds = DetectionDataset(val_info, CanvasReader(vcache, val_info), ValidationSampleAugmentor())
        host_feed = Prefetcher(ds, TRAIN_B, MAX_TARGETS, num_threads=8, drop_last=False, device=None)
        zero_counts()
        m_dev = tr_a.evaluator.validate(vcache)
        m_host = tr_a.evaluator.validate_batches(host_feed)
        val_counts = read_counts()["greedy_nms_mask"]
        if not same_map(m_dev, m_host) or val_counts != 2 * n_val:
            fail(f"[jpeg] validation feeds differ on the same canvases: {m_dev} against {m_host} "
                 f"(NMS launches {val_counts}, want {2 * n_val})")
        log(f"[jpeg] ValDeviceCache and the host feed over the same {len(vcache)} canvases: the same mAP "
            f"dict (map {m_dev['map']:.6g}); NMS launches {val_counts}")
    return counts


def phase_cli(card, counted, zero_counts, read_counts):
    """Phase 11: train, test and run recipes through ``cli.train.main`` on the
    card. Returns each run's launch counts."""
    import numpy as np

    from object_detection_cib_torch.cli.train import main as cli_main
    from object_detection_cib_torch.train import trainer as trainer_mod
    from object_detection_cib_torch.train.checkpoint import load_state

    made = []  # the Trainer of each run, to look inside
    from_config = trainer_mod.Trainer.from_config.__func__

    def recording(cls, cfg, mesh=None):
        made.append(from_config(cls, cfg, mesh))
        return made[-1]

    trainer_mod.Trainer.from_config = classmethod(recording)
    t_phase = time.perf_counter()
    common = ["hydra=static", "extras.enforce_tags=False", "print_config=False", "extras.print_config=False",
              "logger=csv"]
    counts = {}

    def run(part, out, *overrides):
        zero_counts()
        t0 = time.perf_counter()
        metrics = cli_main([*common, f"paths.output_dir={out}", *overrides])
        counts[part] = read_counts()
        return metrics, made[-1], time.perf_counter() - t0

    def expect(part, want):
        got = counts[part]
        for k, n in want.items():
            if got[k] != n:
                fail(f"[cli] ({part}) launched {k} {got[k]} times, want {n}")

    def close(a, b, tol=1e-6):
        return a.keys() == b.keys() and all(
            abs(a[k] - b[k]) <= tol or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)

    try:
        with tempfile.TemporaryDirectory(prefix="cli-runs-") as tmp:
            # configs/logger/many_loggers.yaml (the default) adds TensorBoard:
            # does its writer exist on this machine, or does it warn and no-op?
            import warnings

            from object_detection_cib_torch.utils.loggers import build_loggers, tensorboard_without_tensorflow

            tensorboard_without_tensorflow()  # as the CLI's program entry does
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                (tb,) = build_loggers({"tensorboard": {"save_dir": str(Path(tmp) / "tb")}})
            log(f"[cli] probe: logger 'tensorboard' -> {type(tb).__name__}"
                + "".join(f"; warned: {w.message}" for w in caught))
            getattr(tb, "finalize", lambda: None)()
            run_a = Path(tmp) / "a"
            device = ["data.pipeline=device", "data.device_cache=True", "dataset_name=fake",
                      f"data.fake_num_images={CLI_N}"]
            m_a, t_a, wall_a = run("a", run_a, "experiment=yv5s", *device, "trainer.max_epochs=2",
                                   "trainer.check_val_every_n_epoch=2")
            B = t_a.batch_size
            steps, blocks = CLI_N // B, -(-CLI_N // B)
            expect("a", {"gather_rows_planar": 2 * steps, "hsv_planar": 2 * steps, "warp_quadrants": 2 * steps,
                         "greedy_nms_mask": blocks})
            losses = np.concatenate([em["total"] for em in t_a.epoch_metrics])
            if len(losses) != 2 * steps or not np.isfinite(losses).all() or not finite_map(m_a):
                fail(f"[cli] (a) losses or mAP not finite: {losses}, {m_a}")
            files = ["checkpoints/best", "checkpoints/last", "checkpoints/meta.json", "csv/metrics.csv",
                     "hparams.json"]
            missing = [f for f in files if not (run_a / f).is_file()]
            if missing:
                fail(f"[cli] (a) run files missing: {missing}")
            ips_a = t_a.epoch_imgs[-1] / t_a.epoch_walls[-1]
            log(f"[cli] (a) experiment=yv5s yolov5s@{t_a.image_shape.width} B={B} compute dtype {t_a.net.dtype}: "
                f"{len(t_a.epoch_metrics)} epochs of {steps} "
                f"steps, one validation of {CLI_N} images; launches {counts['a']}; losses {losses[0]:.4f}->"
                f"{losses[-1]:.4f}; run files {files}; epoch 2: {ips_a:.2f} img/s ({t_a.epoch_imgs[-1]} images "
                f"in {t_a.epoch_walls[-1]:.4f} s, host clock); whole command {wall_a:.2f} s | {card}")
            log("[cli] (a) validation " + json.dumps(m_a))

            last = run_a / "checkpoints" / "last"
            saved = load_state(last)
            m_t, t_t, _ = run("a_test", Path(tmp) / "a_test", "experiment=yv5s", *device, "train=False",
                              "test=True", f"ckpt_path={last}")
            expect("a_test", {"gather_rows_planar": 0, "hsv_planar": 0, "warp_quadrants": 0,
                              "greedy_nms_mask": blocks})
            net_ok = all(torch.equal(v.cpu(), saved["net"][k]) for k, v in t_t.net.state_dict().items())
            mom_ok = all(torch.equal(v.cpu(), saved["optimizer"]["momentum"][k])
                         for k, v in t_t.optimizer.buffers.items())
            fit_val = {k: v for k, v in m_a.items() if k != "images_per_sec"}
            if not (net_ok and mom_ok and t_t.optimizer.step_count == 2 * steps):
                fail(f"[cli] (a) restored state differs from the checkpoint: net {net_ok}, momentum {mom_ok}, "
                     f"step {t_t.optimizer.step_count}")
            if not close(m_t, fit_val):
                fail(f"[cli] (a) test mAP {m_t} differs from the last validation {fit_val}")
            log(f"[cli] (a) train=False test=True ckpt_path=<run>/checkpoints/last: {len(saved['net'])} tensors "
                f"and {len(saved['optimizer']['momentum'])} momentum buffers restored bitwise, step_count "
                f"{t_t.optimizer.step_count}; test mAP equals the last validation's within 1e-6 (map "
                f"{m_t['map']:.6g}); launches {counts['a_test']}")

            m_b, t_b, wall_b = run("b", Path(tmp) / "b", "experiment=yv5s", "dataset_name=fake",
                                   "trainer.fast_dev_run=True")
            expect("b", {"gather_rows_planar": 0, "hsv_planar": 0, "warp_quadrants": 0, "greedy_nms_mask": 1})
            if t_b.prefetcher is None or not finite_map(m_b) or not np.isfinite(t_b.epoch_metrics[0]["total"]).all():
                fail(f"[cli] (b) not the host pipeline, or losses / mAP not finite: {m_b}")
            log(f"[cli] (b) data.pipeline=host (configs/data/default.yaml), trainer.fast_dev_run=True: one step "
                f"and one validation batch; launches {counts['b']}; loss {float(t_b.epoch_metrics[0]['total'][0]):.4f}; "
                f"{t_b.epoch_imgs[0] / t_b.epoch_walls[0]:.2f} img/s over its one step ({t_b.epoch_imgs[0]} "
                f"images in {t_b.epoch_walls[0]:.4f} s, the first host batch included); whole command "
                f"{wall_b:.2f} s | {card}")

            m_c, t_c, _ = run("c", Path(tmp) / "c", "experiment=imbalance/class_aware/default",
                              "data.mixup_prob=0.5", *device, "trainer.max_epochs=1",
                              "trainer.limit_train_batches=0.5", "trainer.limit_val_batches=0.2")
            n_c = max(int(steps * 0.5), 1)
            expect("c", {"gather_rows_planar": 2 * n_c, "hsv_planar": 2 * n_c, "warp_quadrants": 2 * n_c,
                         "greedy_nms_mask": max(int(blocks * 0.2), 1)})
            stats = t_c.sampler_stats(n_c)
            if not finite_map(m_c) or not np.isfinite(t_c.epoch_metrics[0]["total"]).all() or not sum(stats.values()):
                fail(f"[cli] (c) losses or mAP not finite, or no instance counted: {m_c}, {stats}")
            log(f"[cli] (c) experiment=imbalance/class_aware/default data.mixup_prob=0.5, limit_train_batches=0.5, "
                f"limit_val_batches=0.2: {len(t_c.epoch_metrics[0]['total'])} steps; launches {counts['c']}; "
                f"sampler_stats over the steps trained {stats}")
        log(f"[cli] phase 11: four commands in {time.perf_counter() - t_phase:.2f} s")
    finally:
        trainer_mod.Trainer.from_config = classmethod(from_config)
    return counts


def _write_shard(job):
    """One shard of phase 17's corpus, in a process of its own."""
    from object_detection_cib_torch.data.synthetic import build_synthetic_dataset

    root, name, n, seed = job
    return build_synthetic_dataset(Path(root), name, num_images=n, image_size=CORPUS_PX, seed=seed)


def write_corpus(root: Path, split: str, n: int, seed0: int):
    """``n`` synthetic-hard-zipf JPEG files at ``CORPUS_PX`` under ``root``,
    written by ``CORPUS_SHARDS`` processes (shard k from seed ``seed0 + k``),
    as one manifest named ``CORPUS_NAME`` cached for ``split`` where the
    data root ``root`` finds it; the manifest."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from object_detection_cib_torch.data.cache import DatasetInfo, serialize_cached_dataset

    tag = "val" if split == "validation" else "train"  # "val" in a name draws the val scale range
    per = -(-n // CORPUS_SHARDS)
    jobs = [(str(root), f"{CORPUS_NAME}/{tag}-{k}", min(per, n - k * per), seed0 + k)
            for k in range(CORPUS_SHARDS) if k * per < n]
    with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(_write_shard, jobs))
    samples = [smp._replace(id=f"syn-{tag}-{k}-{smp.id}") for k, part in enumerate(parts) for smp in part.samples]
    info = DatasetInfo(name=CORPUS_NAME, date=parts[0].date, classes=parts[0].classes, samples=samples)
    serialize_cached_dataset(info, split)
    return info


def phase_corpus(card, zero_counts, read_counts):
    """Phase 17: the slice's path at full width from a JPEG corpus:
    ``cli.train.main`` with ``experiment=yv5s`` (yolov5s, nc=10, 416, B=64,
    bf16), ``data.pipeline=device data.device_cache=True`` and the fused
    epoch, over 4,992 train and 320 val JPEG files at 640 px written from
    seeds (``build_synthetic_dataset``, 8 processes), two epochs, validated
    once. Then the same command over the fake corpus of the same size.
    Returns the launch counts of both runs."""
    import numpy as np

    from object_detection_cib_torch.cli.train import main as cli_main
    from object_detection_cib_torch.data import device_pipeline as dp
    from object_detection_cib_torch.data import native_loader
    from object_detection_cib_torch.data import val_cache as vc
    from object_detection_cib_torch.data.device_pipeline import DeviceCorpus
    from object_detection_cib_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    made, decodes, uploads = [], [], []
    from_config = trainer_mod.Trainer.from_config.__func__
    real_decode, real_raw = dp.decode_canvases, native_loader.decode_raw

    def recording(cls, cfg, mesh=None):
        made.append(from_config(cls, cfg, mesh))
        return made[-1]

    def timed_decode(info, indices, *a, **k):  # the corpus's and the val cache's decode
        t0 = time.perf_counter()
        out = real_decode(info, indices, *a, **k)
        torch.cuda.synchronize()
        decodes.append((len(indices), time.perf_counter() - t0))
        return out

    def counted_raw(*a, **k):  # each chunk's host decode: seconds, and the bytes it copies up
        t0 = time.perf_counter()
        raw = real_raw(*a, **k)
        uploads.append((time.perf_counter() - t0, sum(t.numel() * t.element_size() for t in raw[:3])))
        return raw

    common = ["hydra=static", "extras.enforce_tags=False", "print_config=False", "extras.print_config=False",
              "logger=csv", "experiment=yv5s", "data.pipeline=device", "data.device_cache=True",
              f"trainer.max_epochs={CORPUS_EPOCHS}", f"trainer.check_val_every_n_epoch={CORPUS_EPOCHS}"]
    counts, old_root = {}, os.environ.get("KOD_DATA_ROOT_DIR")
    trainer_mod.Trainer.from_config = classmethod(recording)
    dp.decode_canvases = vc.decode_canvases = timed_decode
    native_loader.decode_raw = counted_raw
    try:
        with tempfile.TemporaryDirectory(prefix="jpeg-640-") as tmp:
            root = Path(tmp)
            os.environ["KOD_DATA_ROOT_DIR"] = tmp  # the data root: the manifests and their files
            t0 = time.perf_counter()
            train_info = write_corpus(root, "train", CORPUS_N, 0)
            val_info = write_corpus(root, "validation", CORPUS_VAL, 100)
            n_bytes = sum((root / s.image_path).stat().st_size for s in train_info.samples + val_info.samples)
            log(f"[corpus] setup: {CORPUS_NAME}, {CORPUS_N} train + {CORPUS_VAL} val JPEG files at "
                f"{CORPUS_PX}x{CORPUS_PX} ({n_bytes} B) written by build_synthetic_dataset in "
                f"{CORPUS_SHARDS} processes in {time.perf_counter() - t0:.2f} s")
            zero_counts()
            t0 = time.perf_counter()
            m_j = cli_main([*common, f"paths.output_dir={root / 'run'}", f"dataset_name={CORPUS_NAME}"])
            wall = time.perf_counter() - t0
            counts["jpeg"] = read_counts()
            t = made[-1]
            steps = CORPUS_N // t.batch_size
            chunks = -(-CORPUS_N // dp.DECODE_ROWS) + -(-CORPUS_VAL // dp.DECODE_ROWS)
            want = {"letterbox": chunks, "gather_rows_planar": CORPUS_EPOCHS * steps,
                    "hsv_planar": CORPUS_EPOCHS * steps, "warp_quadrants": CORPUS_EPOCHS * steps,
                    "greedy_nms_mask": -(-CORPUS_VAL // t.evaluator.batch_size)}
            for k, n in want.items():
                if counts["jpeg"][k] != n:
                    fail(f"[corpus] launched {k} {counts['jpeg'][k]} times, want {n}")
            losses = np.concatenate([em["total"] for em in t.epoch_metrics])
            if len(losses) != CORPUS_EPOCHS * steps or not np.isfinite(losses).all() or not finite_map(m_j):
                fail(f"[corpus] losses or mAP not finite: {losses}, {m_j}")
            corpus = t.pipeline.device_corpus
            if corpus.images.shape != (CORPUS_N, 3, t.image_shape.height, t.image_shape.width):
                fail(f"[corpus] the corpus on the card is {tuple(corpus.images.shape)}")
            head = DeviceCorpus.decode(train_info._replace(samples=train_info.samples[:LB_N // 4]),
                                       t.image_shape.height, "cpu", root)
            if not torch.equal(corpus.images[:LB_N // 4].cpu(), head.images):
                fail(f"[corpus] the first {LB_N // 4} corpus rows differ from the CPU path's")
            (n_tr, s_tr), (n_va, s_va) = decodes[:2]
            host_s, h2d = (sum(u[i] for u in uploads[:chunks]) for i in (0, 1))
            ips = sum(t.epoch_imgs) / sum(t.epoch_walls)
            log(f"[corpus] cli.train experiment=yv5s dataset_name={CORPUS_NAME} data.pipeline=device "
                f"data.device_cache=True, fused epoch, {CORPUS_EPOCHS} epochs of {steps} steps, one validation: "
                f"launches {counts['jpeg']}; losses {losses[0]:.4f}->{losses[-1]:.4f}; whole command "
                f"{wall:.2f} s | {card}")
            log(f"[corpus] decode: {n_tr} train files into the corpus on the card in {s_tr:.3f} s "
                f"({n_tr / s_tr:.2f} img/s), {n_va} val files into the validation cache in {s_va:.3f} s; "
                f"{native_loader.pool_threads()} decode threads, {host_s:.3f} s of it decoding on the host "
                f"(Pillow, then the pinned blob), {h2d} B of decoded images copied up in {chunks} chunks of "
                f"{dp.DECODE_ROWS}; the first {LB_N // 4} rows equal the CPU path's | {card}")
            log(f"[corpus] fused epochs over the JPEG corpus: {ips:.2f} img/s over the {CORPUS_EPOCHS} epochs' "
                f"summed windows ({sum(t.epoch_imgs)} images in {[round(w, 4) for w in t.epoch_walls]} s, host "
                f"clock) | {card}")
            log("[corpus] validation " + json.dumps(m_j))
            del t, corpus, head
            made.clear()
            torch.cuda.empty_cache()

            # the same command over the fake corpus of the same size (an observation)
            zero_counts()
            cli_main([*common, f"paths.output_dir={root / 'fake'}", "dataset_name=fake",
                      f"data.fake_num_images={CORPUS_N}", "data.val_device_cache=False",
                      f"trainer.check_val_every_n_epoch={CORPUS_EPOCHS + 1}"])
            counts["fake"] = read_counts()
            f = made[-1]
            if counts["fake"]["letterbox"] or counts["fake"]["gather_rows_planar"] != CORPUS_EPOCHS * steps:
                fail(f"[corpus] the fake run launched {counts['fake']}")
            log(f"[corpus] the same epochs over the fake corpus of {CORPUS_N} images (no validation): "
                f"{sum(f.epoch_imgs) / sum(f.epoch_walls):.2f} img/s ({[round(w, 4) for w in f.epoch_walls]} s); "
                f"launches {counts['fake']}: an observation, not a claim | {card}")
            del f
            made.clear()
    finally:
        trainer_mod.Trainer.from_config = classmethod(from_config)
        dp.decode_canvases = vc.decode_canvases = real_decode
        native_loader.decode_raw = real_raw
        if old_root is None:
            os.environ.pop("KOD_DATA_ROOT_DIR", None)
        else:
            os.environ["KOD_DATA_ROOT_DIR"] = old_root
    log(f"[corpus] phase 17 {time.perf_counter() - t_phase:.2f} s | {card}")
    return counts


FUSED_EPOCHS = 4  # phase 12: two fits of two epochs per loop, in turns
FUSED_STEPS = 40  # phase 12: steps an epoch (of the corpus's 78), cut to make room for phase 20
PROBE_STEPS = 6  # phase 12's batch probe: 3 batches made eagerly, 3 inside the graph
PROF_STEPS = 10  # phase 12's profiler window of replays


def _graph_nodes(graph):
    """(libcuda, node handles, node types) of a kept ``torch.cuda.CUDAGraph``
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            fail("cuGraphNodeGetType failed")
        kinds.append(kind.value)
    return cuda, list(nodes), kinds


def graph_nodes(graph):
    """(nodes, kernel nodes) of a kept ``torch.cuda.CUDAGraph``."""
    _, nodes, kinds = _graph_nodes(graph)
    return len(nodes), kinds.count(0)  # CU_GRAPH_NODE_TYPE_KERNEL = 0


def phase_fused(card, dev, aug, train_info, val_info, corpus, zero_counts, read_counts):
    """Phase 12: the fused epoch (the JAX package's default device-cache
    loop) at phase 8's width over phase 6's corpus, beside the step loop.
    Returns the fused fits' launch counts."""
    import numpy as np

    from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline
    from object_detection_cib_torch.models.layers import ConvBnAct
    from object_detection_cib_torch.train.trainer import Trainer

    steps = FUSED_STEPS
    t_phase = time.perf_counter()

    # the batches: the fused epoch (pipelined, a CUDA graph) against the step loop's iterator
    ref = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS, seed=0, device=dev,
                             corpus=corpus)
    probe = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS, seed=0, device=dev,
                               corpus=corpus)
    want = [b for b, _ in ref.epoch(PROBE_STEPS)]
    rec = [torch.empty((PROBE_STEPS,) + tuple(x.shape), dtype=x.dtype, device=dev) for x in want[0]]
    k = torch.zeros((), dtype=torch.int64, device=dev)

    def record(batch, *rows):
        for buf, x in zip(rec, batch):
            buf.index_copy_(0, k.view(1), x[None])
        k.add_(1)
        return batch.images.float().sum()

    fn = probe.build_fused_epoch_fn(record, pipelined=True, stack_metrics=True)
    fn(probe.epoch_host_arrays(PROBE_STEPS))
    torch.cuda.synchronize()
    for i, batch in enumerate(want):
        if not all(torch.equal(buf[i], x) for buf, x in zip(rec, batch)):
            fail(f"[fused] batch {i} of the fused epoch (CUDA graph) differs from the step loop's")
    made_in_graph = PROBE_STEPS - 1 - fn.WARMUP_STEPS
    log(f"[fused] batches: the first {PROBE_STEPS} of the fused epoch (pipelined, captured after "
        f"{fn.WARMUP_STEPS} eager warm-up steps; the last {made_in_graph} made inside the graph) bitwise "
        f"equal to the step loop's (images, boxes, labels, mask); graphs {sorted(fn.graphs)}")
    del ref, probe, want, rec, fn

    # the two loops in turns: step, fused, fused, step
    kw = dict(size="s", image_size=TRAIN_S, batch_size=TRAIN_B, aug_params=aug, max_targets=MAX_TARGETS,
              seed=0, dtype=torch.bfloat16, device=dev, corpus=corpus, max_epochs=FUSED_EPOCHS)
    loops = {"step": Trainer(train_info, val_info, fused_epoch=False, **kw),
             "fused": Trainer(train_info, val_info, **kw)}
    for t in loops.values():
        t.loop = t.loop._replace(check_val_every_n_epoch=2)
    t_f = loops["fused"]
    n_bn = sum(isinstance(m, ConvBnAct) for m in t_f.net.modules())
    before = [p.detach().clone() for p in t_f.net.parameters()]
    n_val = math.ceil(len(val_info.samples) / TRAIN_B)
    counts, turns = {}, []
    for turn, (name, stop) in enumerate((("step", 2), ("fused", 2), ("fused", 4), ("step", 4))):
        t = loops[name]
        if name == "fused" and stop == 2:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        m = t.fit(max_epochs=stop, epoch_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        want_n = {"gather_rows_planar": 2 * steps, "hsv_planar": 2 * steps, "warp_quadrants": 2 * steps,
                  "greedy_nms_mask": n_val, "bn_silu_train": 2 * steps * n_bn}
        for kname, nw in want_n.items():
            if got[kname] != nw:
                fail(f"[fused] turn {turn} ({name}) launched {kname} {got[kname]} times, want {nw}")
        if name == "fused" and stop == 2:
            peak = torch.cuda.max_memory_allocated()
            counts = got
            unmoved = sum(torch.equal(a, b) for a, b in zip(before, t_f.net.parameters()))
            if unmoved:
                fail(f"[fused] {unmoved} of {len(before)} parameters did not move")
        losses = np.concatenate([em["total"] for em in t.epoch_metrics[-2:]])
        if not np.isfinite(losses).all() or not finite_map(m):
            fail(f"[fused] turn {turn} ({name}): losses or mAP not finite: {losses}, {m}")
        ips = sum(t.epoch_imgs[-2:]) / sum(t.epoch_walls[-2:])
        turns.append((name, ips))
        walls = t.device_epoch_walls() if name == "fused" else {}
        log(f"[fused] turn {turn} {name} loop, fit to epoch {stop}: {ips:.2f} img/s over its two epochs "
            f"(host clock, the epochs' walls summed: {[round(w, 4) for w in t.epoch_walls[-2:]]} s, "
            f"{'fetch to fetch' if name == 'fused' else 'start to fetch'}); epoch {stop} alone "
            f"{t.epoch_imgs[-1] / t.epoch_walls[-1]:.2f} img/s; device epoch walls (stage stamps) "
            f"{ {e: round(w, 4) for e, w in walls.items()} } s; whole fit {wall:.2f} s with one validation; "
            f"launches {got}; losses {losses[0]:.4f}->{losses[-1]:.4f}; map {m['map']:.6g} | {card}")
    first = [loops[n].epoch_metrics[0]["total"][:3] for n in ("step", "fused")]
    log(f"[fused] first three losses, step loop {first[0].tolist()} vs fused {first[1].tolist()} "
        f"(same weights, batches and order; equal where the card's kernels are deterministic)")
    log(f"[fused] peak memory of the first fused fit {peak / 2**30:.3f} GiB (max_memory_allocated, all "
        f"trainers alive) | {card}")

    # the fused epoch alone: host enqueue, device time, profiler, graph nodes
    fn = t_f._fused_fn
    pipe = t_f.pipeline
    opt = t_f.optimizer

    def epoch(n):
        xs = pipe.epoch_host_arrays(n)
        step0 = opt.step_count
        out = fn(xs, opt.hyper_table(step0, xs[0].shape[0]))
        opt.step_count = step0 + xs[0].shape[0]
        return out

    body = fn.graphs["body"]
    replay_ms = []
    real_replay = body.replay

    def timed_replay():
        t = time.perf_counter()
        real_replay()
        replay_ms.append((time.perf_counter() - t) * 1e3)

    body.replay = timed_replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch(steps)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del body.replay
    enq_ms, dev_ms = (t1 - t0) / steps * 1e3, (t2 - t0) / steps * 1e3
    wait = statistics.median(replay_ms[2:])
    log(f"[fused] one whole epoch of {steps} steps from an idle card: the host returns from the enqueue "
        f"after {enq_ms:.4f} ms a step, done in {dev_ms:.4f} ms a step ({TRAIN_B * 1e3 / dev_ms:.2f} img/s, "
        f"host clock); one replay's call takes {replay_ms[0]:.4f} ms from the idle card, then "
        f"{replay_ms[1]:.4f}, then a median {wait:.4f} ms (replays 3-{len(replay_ms)}): the host waits on "
        f"the card's queue, ahead of it by about one step | {card}")
    nodes, kernels = graph_nodes(fn.graphs["body"].graph)
    last_nodes, last_kernels = graph_nodes(fn.graphs["last"].graph)
    log(f"[fused] graph of one step (make batch i+1 beside train step i): {nodes} nodes, {kernels} kernels; "
        f"the last step's (train only): {last_nodes} nodes, {last_kernels} kernels; launches held "
        f"{ {e.__name__: n for e, n in fn.graphs['body'].launches.items()} }")

    from torch.profiler import ProfilerActivity, profile

    epoch(PROF_STEPS)  # the same shapes once more, untraced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(PROF_STEPS)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(getattr(e, "self_device_time_total", 0) for e in dev_events) / 1e3 / PROF_STEPS
    per_step = sum(e.count for e in dev_events) / PROF_STEPS
    # two streams overlap: the busy time is the union of the kernels' intervals, not their sum
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, None
    for a, b in spans:
        if reach is None or a > reach:
            busy_us += b - a
            reach = b
        elif b > reach:
            busy_us += b - reach
            reach = b
    if spans:
        window = max(b for _, b in spans) - spans[0][0]
        log(f"[fused] profiler over a {PROF_STEPS}-step fused epoch: kernels {per_step:.0f} a step taking "
            f"{kernel_ms:.4f} ms a step summed; the card busy (union of kernel intervals, two streams) "
            f"{busy_us / 1e3 / PROF_STEPS:.4f} ms a step of the window's {window / 1e3 / PROF_STEPS:.4f}: "
            f"device idle share {1 - busy_us / window:.4f} | {card}")
    else:
        log("[fused] profiler: no device time in the trace of the replays; busy and idle share not measured")
    ips = {n: [v for m_, v in turns if m_ == n] for n in ("step", "fused")}
    log(f"[fused] in turns (step, fused, fused, step): img/s step {ips['step']}, fused {ips['fused']}; "
        f"phase 12 {time.perf_counter() - t_phase:.2f} s | {card}")
    del loops, t_f, fn
    return counts


# ------------------------------------------------------------ 13 ddp
DDP_N, DDP_VAL, DDP_STEPS = 640, 128, 10  # phase 13 (a) and (b): 640 train images, 10 steps of B=64
MESH_PER_CARD = 1280  # phase 13 (c): fake images a card (20 steps an epoch at 64 a card)


def _kernel_entries():
    from object_detection_cib_torch.ops import bn_silu as bn_ops
    from object_detection_cib_torch.ops import gather as gather_ops
    from object_detection_cib_torch.ops import hsv as hsv_ops
    from object_detection_cib_torch.ops import letterbox as lb_ops
    from object_detection_cib_torch.ops import nms as nms_ops
    from object_detection_cib_torch.ops import warp as warp_ops

    return (gather_ops.gather_rows_planar, gather_ops.gather_rows_flat, hsv_ops.hsv_planar,
            warp_ops.warp_quadrants, nms_ops.greedy_nms_mask, lb_ops.letterbox, bn_ops.bn_silu_train)


def kernel_entry(name, file, replaces, launches, err, timing, calls, by_path) -> dict:
    """One kernel of the ``kernels`` JSON line: ``timing`` (ms, plain_ms,
    library_ms, bound_ms, bound_by), ``calls`` (call_ms, library_call_ms)."""
    k_ms, p_ms, lib_ms, b_ms, b_by = timing
    return {"name": name, "route": "cuda", "source": "object_detection_cib_torch/ops/csrc/" + file,
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "call_ms": calls[0],
            "library_call_ms": calls[1], "launches_by_path": by_path}


def _zero_kernels():
    for fn in _kernel_entries():
        fn.launches = 0


def _read_kernels():
    return {fn.__name__: fn.launches for fn in _kernel_entries()}


def graph_kernel_names(graph):
    """The function name of every kernel node of a kept ``torch.cuda.CUDAGraph``
    (``cuGraphKernelNodeGetParams_v2``, then ``cuFuncGetName`` or
    ``cuKernelGetName``); None where libcuda gives no name."""

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                    ("shared", ctypes.c_uint), ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cuda, nodes, kinds = _graph_nodes(graph)
    names = []
    for node, kind in zip(nodes, kinds):
        if kind != 0:
            continue
        p, name = Params(), ctypes.c_char_p()
        if cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)):
            names.append(None)
        elif p.func and not cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)):
            names.append(name.value.decode())
        elif p.kern and not cuda.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)):
            names.append(name.value.decode())
        else:
            names.append(None)
    return names


def _ddp_infos(n_train: int, n_val: int):
    from object_detection_cib_torch.data.synthetic import build_fake_manifest

    return (build_fake_manifest(num_images=n_train, num_classes=NC, image_size=TRAIN_S, seed=0),
            build_fake_manifest(num_images=n_val, num_classes=NC, image_size=TRAIN_S, seed=1))


def _ddp_card():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _ddp_fused_rank(mesh):
    """Phase 13 (a), in a one-rank NCCL group: one fused epoch of 10 steps
    with its validation."""
    import numpy as np

    from object_detection_cib_torch.models.layers import BatchNorm
    from object_detection_cib_torch.parallel.distributed import all_reduce_sum_
    from object_detection_cib_torch.train.trainer import Trainer

    _ddp_card()
    train_info, val_info = _ddp_infos(DDP_N, DDP_VAL)
    t = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B, max_targets=MAX_TARGETS,
                seed=0, dtype=torch.bfloat16, device=mesh.device, mesh=mesh, max_epochs=1)
    n_bn = sum(isinstance(m, BatchNorm) for m in t.net.modules())
    _zero_kernels()
    calls = all_reduce_sum_.calls
    t0 = time.perf_counter()
    m = t.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_kernels()
    fn = t._fused_fn
    names = {g: graph_kernel_names(fn.graphs[g].graph) for g in fn.graphs}
    return dict(counts=counts, calls=all_reduce_sum_.calls - calls, n_bn=n_bn, graphs=sorted(fn.graphs),
                warmup=fn.WARMUP_STEPS, losses=np.asarray(t.epoch_metrics[0]["total"]).tolist(), map=m,
                kernel_nodes={g: len(v) for g, v in names.items()},
                unnamed={g: sum(x is None for x in v) for g, v in names.items()},
                nccl={g: sorted({x for x in v if x and "nccl" in x.lower()}) for g, v in names.items()},
                nccl_nodes={g: sum(1 for x in v if x and "nccl" in x.lower()) for g, v in names.items()},
                wall=wall, peak=torch.cuda.max_memory_allocated(mesh.device))


def _ddp_gloo_rank(mesh):
    """Phase 13 (b), one of two gloo ranks on one card: 10 steps of the step
    loop at a global batch of 64 and one validation of this rank's shard."""
    import hashlib

    import numpy as np

    from object_detection_cib_torch.train.trainer import Trainer

    _ddp_card()
    train_info, val_info = _ddp_infos(DDP_N, DDP_VAL)
    t = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B, max_targets=MAX_TARGETS,
                seed=0, dtype=torch.bfloat16, device=mesh.device, mesh=mesh, max_epochs=1, fused_epoch=False)
    _zero_kernels()
    t0 = time.perf_counter()
    m = t.fit(max_epochs=1, epoch_steps=DDP_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_kernels()
    state = {k: v.detach().cpu() for k, v in t.net.state_dict().items()}
    digest = hashlib.sha256(b"".join(v.float().numpy().tobytes() for v in state.values())).hexdigest()
    return dict(counts=counts, losses=np.asarray(t.epoch_metrics[0]["total"]).tolist(), map=m, digest=digest,
                state=state if mesh.is_main else None, val_images=len(t.val_cache), wall=wall,
                ips=t.epoch_imgs[0] / t.epoch_walls[0])


def _busy_idle(prof):
    """(device busy ms, window ms, NCCL kernels' ms) of a profiler trace: the
    busy time is the union of the kernels' intervals (streams overlap)."""
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, reach = 0.0, None
    for a, b in spans:
        if reach is None or a > reach:
            busy, reach = busy + b - a, b
        elif b > reach:
            busy, reach = busy + b - reach, b
    nccl = sum(e.time_range.end - e.time_range.start for e in evs if "nccl" in e.name.lower())
    window = (max(b for _, b in spans) - spans[0][0]) if spans else 0.0
    return busy / 1e3, window / 1e3, nccl / 1e3


def _ddp_mesh_run(mesh, cfg, keep_state=False):
    """Phase 13 (c), one rank of ``cli.train``'s data-parallel run of ``cfg``
    (``train(cfg, mesh)``'s trainer; no mesh: one card alone): two fused
    epochs validated once, then a profiled 10-step fused epoch. With
    ``keep_state`` a digest of the weights at the end and, on rank 0, the
    weights (phase 14 (b))."""
    from torch.profiler import ProfilerActivity, profile

    from object_detection_cib_torch.parallel.distributed import all_reduce_sum_, reduce_scatter_sum
    from object_detection_cib_torch.train.trainer import Trainer

    _ddp_card()
    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    t = Trainer.from_config(cfg, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_kernels()
    calls = (all_reduce_sum_.calls, reduce_scatter_sum.calls)
    t0 = time.perf_counter()
    m = t.fit()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = _read_kernels()
    calls = (all_reduce_sum_.calls - calls[0], reduce_scatter_sum.calls - calls[1])
    peak = torch.cuda.max_memory_allocated(dev)
    fn, pipe, opt = t._fused_fn, t.pipeline, t.optimizer
    names = graph_kernel_names(fn.graphs["body"].graph)

    def epoch(n):
        xs = pipe.epoch_host_arrays(n)
        step0 = opt.step_count
        fn(xs, opt.hyper_table(step0, xs[0].shape[0]))
        opt.step_count = step0 + xs[0].shape[0]

    epoch(PROF_STEPS)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(PROF_STEPS)
        torch.cuda.synchronize(dev)
    busy, window, nccl = _busy_idle(prof)
    kept = {}
    if keep_state:
        import hashlib

        state = {k: v.detach().cpu() for k, v in t.net.state_dict().items()}
        kept = dict(digest=hashlib.sha256(b"".join(v.float().numpy().tobytes() for v in state.values())).hexdigest(),
                    state=state if mesh is None or mesh.is_main else None,
                    layout=None if mesh is None else (mesh.size, mesh.rank, mesh.hosts, str(mesh.device)))
    return dict(**kept, counts=counts, calls=calls, map=m, peak=peak, wall=wall,
                ips_epochs=[i / w for i, w in zip(t.epoch_imgs, t.epoch_walls)],
                ips=sum(t.epoch_imgs) / sum(t.epoch_walls), device_walls=t.device_epoch_walls(),
                kernel_nodes=len(names), nccl_nodes=sum(1 for x in names if x and "nccl" in x.lower()),
                nccl_names=sorted({x for x in names if x and "nccl" in x.lower()}),
                prof_steps=PROF_STEPS, busy_ms=busy, window_ms=window, nccl_ms=nccl,
                batch=t.batch_size, steps=t.steps_per_epoch, held_rows=int(pipe.corpus.shape[0]))


def phase_ddp(card):
    """Phase 13: data-parallel training through the launcher: (a) a
    one-rank NCCL group over the fused epoch, (b) two gloo ranks on one
    card over the step loop against one process, (c) with two or more
    cards, ``cli.train trainer=mesh`` on N = min(count, 4) NCCL ranks
    against one card. Returns the ranks' launch counts."""
    import numpy as np

    from object_detection_cib_torch.config import compose
    from object_detection_cib_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    out = {}
    # (a) one NCCL rank, the fused epoch
    (a,) = launch_logged("ddp", _ddp_fused_rank, 1, device_type="cuda", timeout_s=300, join_timeout_s=600)
    steps = DDP_N // TRAIN_B
    want = {"gather_rows_planar": steps, "hsv_planar": steps, "warp_quadrants": steps,
            "greedy_nms_mask": -(-DDP_VAL // TRAIN_B)}
    for k, n in want.items():
        if a["counts"][k] != n:
            fail(f"[ddp] (a) launched {k} {a['counts'][k]} times, want {n}")
    per_step = 3 * a["n_bn"] + 3  # BatchNorm: 2 forward, 1 backward; compaction and loss counts; the gradient
    python_steps = a["warmup"] + len(a["graphs"])  # eager warm-up steps, then one capture per graph
    if a["calls"] != python_steps * per_step + 1:
        fail(f"[ddp] (a) {a['calls']} all-reduces issued, want {python_steps} x {per_step} + 1 (the epoch's metrics)")
    if not (np.isfinite(a["losses"]).all() and finite_map(a["map"])):
        fail(f"[ddp] (a) losses or mAP not finite: {a['losses']}, {a['map']}")
    log(f"[ddp] (a) launch(1 rank, NCCL) fused epoch yolov5s@{TRAIN_S} B={TRAIN_B} bf16, {DDP_N} fake images, "
        f"{steps} steps + validation of {DDP_VAL}: launches {a['counts']} (training kernels by replay); "
        f"graphs {a['graphs']} captured after {a['warmup']} eager steps; all-reduces issued {a['calls']} = "
        f"{python_steps} step bodies run in Python (warm-up and captures) x {per_step} ({a['n_bn']} BatchNorms "
        f"x 3 + compaction counts + loss counts + gradient bucket) + 1 epoch metric sum; kernel nodes {a['kernel_nodes']}, "
        f"of them named nccl {a['nccl_nodes']} {a['nccl']}, unnamed {a['unnamed']}; losses {a['losses'][0]:.4f}->"
        f"{a['losses'][-1]:.4f}; map {a['map']['map']:.6g}; fit {a['wall']:.2f} s; peak {a['peak'] / 2**30:.3f} "
        f"GiB | {card}")
    out["a"] = a["counts"]

    # (b) two gloo ranks on this card, the step loop, against one process
    ranks = launch_logged("ddp", _ddp_gloo_rank, 2, device_type="cuda", backend="gloo", devices=[0, 0],
                          timeout_s=300, join_timeout_s=600)
    shard_blocks = -(-(DDP_VAL // 2) // (TRAIN_B // 2))  # each rank validates at its share of the batch
    for r, res in enumerate(ranks):
        want = {"gather_rows_planar": DDP_STEPS, "hsv_planar": DDP_STEPS, "warp_quadrants": DDP_STEPS,
                "greedy_nms_mask": shard_blocks}
        for k, n in want.items():
            if res["counts"][k] != n:
                fail(f"[ddp] (b) rank {r} launched {k} {res['counts'][k]} times, want {n}")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        fail("[ddp] (b) the two ranks' weights differ after the steps")
    train_info, val_info = _ddp_infos(DDP_N, DDP_VAL)
    one = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B, max_targets=MAX_TARGETS,
                  seed=0, dtype=torch.bfloat16, device="cuda", max_epochs=1, fused_epoch=False)
    one.fit(max_epochs=1, epoch_steps=3)
    first = np.asarray(one.epoch_metrics[0]["total"][:3])
    got = np.asarray(ranks[0]["losses"][:3])
    if not np.allclose(got, first, rtol=1e-3, atol=0):
        fail(f"[ddp] (b) first three losses {got.tolist()} vs one process {first.tolist()} beyond rtol 1e-3")
    one.net.load_state_dict(ranks[0]["state"])
    whole = one_process_map(one, TRAIN_B // 2)
    merged = {k: v for k, v in ranks[0]["map"].items() if k != "images_per_sec"}
    if not (same_map(merged, whole) and same_map(merged, {k: v for k, v in ranks[1]["map"].items()
                                                          if k != "images_per_sec"})):
        fail(f"[ddp] (b) the merged mAP dict {merged} differs from one process's {whole}")
    log(f"[ddp] (b) launch(2 ranks, gloo, both on cuda:0) step loop yolov5s@{TRAIN_S} global B={TRAIN_B} "
        f"({TRAIN_B // 2} a rank) bf16, {DDP_STEPS} steps + validation: launches rank 0 {ranks[0]['counts']}, "
        f"rank 1 {ranks[1]['counts']} (K1 over each rank's {ranks[0]['val_images']} of {DDP_VAL} val images); "
        f"weights equal on both ranks; first three losses {got.tolist()} vs one process {first.tolist()} "
        f"(rtol 1e-3); merged mAP dict equal to one process's on the same weights (map {whole['map']:.6g}); "
        f"{ranks[0]['ips']:.2f} img/s (two processes sharing one card over gloo: not a rate to compare) | {card}")
    out["b"] = {k: ranks[0]["counts"][k] + ranks[1]["counts"][k] for k in ranks[0]["counts"]}
    del one

    # (c) N cards over cli.train trainer=mesh
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[ddp] (c) needs 2 cards, this machine shows {count}: not run")
    else:
        n = min(count, 4)
        with tempfile.TemporaryDirectory(prefix="ddp-mesh-") as tmp:
            def cfg(ranks_, *extra):
                return compose(Path(__file__).resolve().parent / "configs", "train", [
                    "experiment=yv5s", "trainer=mesh", f"trainer.num_devices={ranks_}", "data.pipeline=device",
                    "data.device_cache=True", "dataset_name=fake", f"data.fake_num_images={MESH_PER_CARD * ranks_}",
                    f"data.batch_size={TRAIN_B * ranks_}", "trainer.max_epochs=2",
                    "trainer.check_val_every_n_epoch=2", "trainer.limit_val_batches=0.25", "logger=csv",
                    "hydra=static", "extras.enforce_tags=False", "print_config=False", "extras.print_config=False",
                    f"paths.output_dir={tmp}/{ranks_}-{len(extra)}", *extra])

            runs = {}
            runs["1 card"] = [_ddp_mesh_run(None, cfg(1))]
            torch.cuda.empty_cache()  # rank 0 shares card 0 with this process
            runs[f"{n} cards"] = launch_logged("ddp", _ddp_mesh_run, n, (cfg(n),), timeout_s=600,
                                               join_timeout_s=1200)
            runs[f"{n} cards, sharded"] = launch_logged("ddp", _ddp_mesh_run, n,
                                                        (cfg(n, "data.corpus_sharding=sharded"),),
                                                        timeout_s=600, join_timeout_s=1200)
        base = runs["1 card"][0]["ips"]
        for name, rs in runs.items():
            r0 = rs[0]
            steps_c = 2 * r0["steps"]
            for r, res in enumerate(rs):
                for k in ("gather_rows_planar", "hsv_planar", "warp_quadrants"):
                    if res["counts"][k] != steps_c:
                        fail(f"[ddp] (c) {name} rank {r} launched {k} {res['counts'][k]} times, want {steps_c}")
                if not finite_map(res["map"]):
                    fail(f"[ddp] (c) {name} rank {r}: mAP not finite {res['map']}")
            maps = {json.dumps({k: v for k, v in res["map"].items() if k != "images_per_sec"}) for res in rs}
            if len(maps) != 1:
                fail(f"[ddp] (c) {name}: the ranks read different mAP dicts")
            idle = [round(1 - res["busy_ms"] / res["window_ms"], 4) if res["window_ms"] else None for res in rs]
            log(f"[ddp] (c) {name}: yolov5s@{TRAIN_S} global B={r0['batch']} bf16 fused epoch, {r0['steps']} steps an "
                f"epoch x 2: {r0['ips']:.2f} img/s over both epochs' windows (rank 0, host clock; per epoch "
                f"{[round(x, 2) for x in r0['ips_epochs']]}), {r0['ips'] / base:.4f}x the one card's; device epoch "
                f"walls {r0['device_walls']}; launches rank 0 {r0['counts']}; collectives issued (all-reduce, "
                f"reduce-scatter) {r0['calls']}; graph kernel nodes {r0['kernel_nodes']}, NCCL {r0['nccl_nodes']} "
                f"{r0['nccl_names'][:3]}; profiled {r0['prof_steps']} steps: NCCL kernels {r0['nccl_ms'] / r0['prof_steps']:.4f} "
                f"ms a step, busy {r0['busy_ms'] / r0['prof_steps']:.4f} of {r0['window_ms'] / r0['prof_steps']:.4f} ms "
                f"a step; idle share per rank {idle}; peak memory per rank "
                f"{[round(res['peak'] / 2**30, 3) for res in rs]} GiB, corpus rows held {r0['held_rows']}; "
                f"map {r0['map']['map']:.6g} | {card}")
        out["c"] = {k: sum(res["counts"][k] for res in runs[f"{n} cards"]) for k in runs[f"{n} cards"][0]["counts"]}

        out["d"] = ddp_flat(card, n)
    log(f"[ddp] phase 13 {time.perf_counter() - t_phase:.2f} s | {card}")
    return out


# ------------------------------------------------------------ 14 hosts
HOSTS_B = 32  # phase 14 (a): the batch of one host (a global batch of 64 over two)
HOSTS_MESH_B = 128  # phase 14 (b): the batch of one host of two cards (64 a card)


def _hosts_rank_a(mesh):
    """Phase 14 (a), the one gloo rank of a host of two: 10 steps of the
    step loop, then 10 of the fused epoch (eager: a gloo group cannot be
    captured in a CUDA graph), each epoch validated."""
    import hashlib

    import numpy as np

    from object_detection_cib_torch.train.trainer import Trainer

    _ddp_card()
    train_info, val_info = _ddp_infos(DDP_N, DDP_VAL)
    t = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=HOSTS_B, max_targets=MAX_TARGETS,
                seed=0, dtype=torch.bfloat16, device=mesh.device, mesh=mesh, max_epochs=2, fused_epoch=False)
    _zero_kernels()
    m_step = t.fit(max_epochs=1, epoch_steps=DDP_STEPS)
    counts_step = _read_kernels()
    plan = t.pipeline.consumed_plan_log[0]
    after_step = ({k: v.detach().cpu().clone() for k, v in t.net.state_dict().items()},
                  {"step_count": t.optimizer.step_count,
                   "momentum": {k: v.detach().cpu().clone() for k, v in t.optimizer.buffers.items()}})
    t.fused_epoch = True
    _zero_kernels()
    m = t.fit(max_epochs=2, epoch_steps=DDP_STEPS)
    torch.cuda.synchronize()
    counts_fused = _read_kernels()
    state = {k: v.detach().cpu() for k, v in t.net.state_dict().items()}
    digest = hashlib.sha256(b"".join(v.float().numpy().tobytes() for v in state.values())).hexdigest()
    return dict(layout=(mesh.size, mesh.rank, mesh.hosts, mesh.host, mesh.local_rank), plan=plan,
                counts_step=counts_step, counts_fused=counts_fused, map_step=m_step, map=m,
                losses_step=np.asarray(t.epoch_metrics[0]["total"]).tolist(),
                losses=np.asarray(t.epoch_metrics[1]["total"]).tolist(), digest=digest,
                after_step=after_step if mesh.is_main else None, state=state if mesh.is_main else None,
                val_images=len(t.val_cache), fused_graph=t._fused_fn.graph)


def _hosts_cfg(root: Path, out: Path, ranks_a_host: int, hosts: int, *extra):
    """Phase 14 (b)'s config (phase 13 (c)'s at ``hosts * ranks_a_host``
    cards): yolov5s@416 bf16, 64 images and 1,280 fake images a card, two
    fused epochs validated once on a quarter of the val set."""
    from object_detection_cib_torch.config import compose

    cards = hosts * ranks_a_host
    return compose(root / "configs", "train", [
        "experiment=yv5s", "trainer=mesh", f"trainer.num_devices={ranks_a_host}", "data.pipeline=device",
        "data.device_cache=True", "dataset_name=fake", f"data.fake_num_images={MESH_PER_CARD * cards}",
        f"data.batch_size={TRAIN_B * ranks_a_host}", "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=2",
        "trainer.limit_val_batches=0.25", "logger=csv", "hydra=static", "extras.enforce_tags=False",
        "print_config=False", "extras.print_config=False", f"paths.output_dir={out}", *extra])


SWEEP_KEY, SWEEP_VALUES = "model.assign_compact_slots", ("2", "128")  # phase 14 (a): a planted overflow, none
SWEEP_N, SWEEP_B = 256, 32  # phase 14 (a)'s sweep: fake images, the batch of one host (4 steps an epoch)


def _sweep_argv() -> list:
    """Phase 14 (a)'s sweep: yolov5s@416 bf16 on the step loop (gloo is not
    captured), one epoch of 4 steps over two hosts, validated on a quarter
    of the val set."""
    return ["experiment=yv5s", "dataset_name=fake",
            f"data.fake_num_images={SWEEP_N}", f"data.batch_size={SWEEP_B}", "data.pipeline=device",
            "data.device_cache=True", "data.fused_epoch=False", "trainer.num_devices=1", "trainer.max_epochs=1",
            "trainer.limit_val_batches=0.25", "logger=csv", "hydra=static", "extras.enforce_tags=False",
            "print_config=False", "extras.print_config=False"]


def hosts_child(kind: str, out: Path) -> None:
    """A host of phase 14, run in its own process tree with its
    environment: ``a``, the launcher of one gloo rank on card 0 under
    ``KOD_*``; ``a-sweep``, a two-job ``-m`` sweep of ``cli.train`` under
    ``KOD_*``, then each job alone over the coordinators of
    ``PHASE14_ALONE``, each host's one rank on card 0 over gloo;
    ``b-kod``, the launcher of two NCCL ranks under ``KOD_*``;
    ``b-torchrun``, one rank under torchrun's variables. Writes its ranks'
    results to ``out`` (a pickle; torchrun: one file a rank)."""
    import os
    import pickle

    from object_detection_cib_torch.parallel import distributed

    layout = distributed.env_layout()
    if layout is None:
        fail(f"hosts child {kind}: neither torchrun's nor the KOD_* variables are set")
    root = Path(__file__).resolve().parent
    if kind == "a":
        res = distributed.launch(_hosts_rank_a, 1, device_type="cuda", backend="gloo", devices=[0],
                                 hosts=layout.hosts, host=layout.host, coordinator=layout.address, timeout_s=300,
                                 join_timeout_s=900)
    elif kind == "a-sweep":
        from object_detection_cib_torch.cli import train as cli

        # both hosts' ranks share card 0, which NCCL refuses: the CLI's launcher takes gloo
        distributed.backend_for = lambda device_type: "gloo"
        argv = _sweep_argv()
        res = dict(sweep=cli.main(["-m", *argv, f"{SWEEP_KEY}={','.join(SWEEP_VALUES)}",
                                   f"paths.output_dir={out.parent / 'sweep'}"]), alone=[])
        for i, (v, addr) in enumerate(zip(SWEEP_VALUES, os.environ["PHASE14_ALONE"].split(","), strict=True)):
            os.environ["KOD_COORDINATOR_ADDRESS"] = addr
            res["alone"].append(cli.main([*argv, f"{SWEEP_KEY}={v}", f"paths.output_dir={out.parent / f'alone{i}'}"]))
    elif kind == "b-kod":
        cfg = _hosts_cfg(root, out.parent / f"kod{layout.host}", 2, layout.hosts)
        res = distributed.launch(_ddp_mesh_run, 2, (cfg, True), hosts=layout.hosts, host=layout.host,
                                 coordinator=layout.address, timeout_s=600, join_timeout_s=1200)
    elif kind == "b-torchrun":
        mesh = distributed.join_torchrun(layout, "cuda", timeout_s=600)
        cfg = _hosts_cfg(root, out.parent / f"torchrun{layout.host}", layout.local_size, layout.hosts)
        res = [_ddp_mesh_run(mesh, cfg, True)]
        distributed.barrier(mesh)
        distributed.leave_group(mesh.device)
        out = out.parent / f"{out.stem}{layout.rank}.pkl"
    else:
        fail(f"hosts child: unknown kind {kind!r}")
    out.write_bytes(pickle.dumps(res))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_trees(name: str, cmds, timeout: float):
    """Start every (argv, environment) at once, wait for all; fail unless
    each exits 0 within ``timeout`` seconds. Every process is ended."""
    import os

    procs, t0 = [], time.perf_counter()
    try:
        for argv, env in cmds:
            log_path = Path(tempfile.mkstemp(prefix="hosts-", suffix=".log")[1])
            procs.append((subprocess.Popen(argv, env={**os.environ, **env}, stdout=log_path.open("w"),
                                           stderr=subprocess.STDOUT, start_new_session=True), log_path))
        for proc, log_path in procs:
            left = max(timeout - (time.perf_counter() - t0), 1.0)
            try:
                code = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                fail(f"[hosts] {name}: a process tree did not end within {timeout} s:\n"
                     f"{log_path.read_text()[-3000:]}")
            if code != 0:
                fail(f"[hosts] {name}: a process tree exited {code}:\n{log_path.read_text()[-6000:]}")
    finally:
        import signal

        for proc, log_path in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
            log_path.unlink(missing_ok=True)
    return time.perf_counter() - t0


def phase_hosts(card):
    """Phase 14: several hosts joined from the environment. (a) two hosts of
    one gloo rank each on this card, through ``KOD_*``: the step loop, then
    the fused epoch, against one process at the same global batch; (b) with
    four cards, two hosts of two NCCL cards each (``CUDA_VISIBLE_DEVICES``
    0,1 and 2,3), through ``KOD_*`` and through ``torch.distributed.run``,
    against phase 13 (c)'s four cards on one host at the same global batch.
    Returns the ranks' launch counts."""
    import pickle

    import numpy as np

    from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline
    from object_detection_cib_torch.data.host_augment import AugParams
    from object_detection_cib_torch.parallel.mesh import DataMesh
    from object_detection_cib_torch.train.checkpoint import load_state
    from object_detection_cib_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    me = str(Path(__file__).resolve())
    out = {}
    with tempfile.TemporaryDirectory(prefix="hosts-") as tmp:
        tmp = Path(tmp)
        # (a) two hosts of one gloo rank on this card, KOD_*
        addr = f"127.0.0.1:{_free_port()}"
        cmds = [([sys.executable, me, "--hosts-child", "a", str(tmp / f"a{h}.pkl")],
                 {"KOD_COORDINATOR_ADDRESS": addr, "KOD_NUM_PROCESSES": "2", "KOD_PROCESS_ID": str(h)})
                for h in range(2)]
        wall = _run_trees("(a)", cmds, 900)
        ranks = [pickle.loads((tmp / f"a{h}.pkl").read_bytes())[0] for h in range(2)]
        # (a) a two-job -m sweep over the same two hosts, then each job alone
        addrs = [f"127.0.0.1:{_free_port()}" for _ in range(1 + len(SWEEP_VALUES))]
        cmds = [([sys.executable, me, "--hosts-child", "a-sweep", str(tmp / f"s{h}.pkl")],
                 {"KOD_COORDINATOR_ADDRESS": addrs[0], "KOD_NUM_PROCESSES": "2", "KOD_PROCESS_ID": str(h),
                  "PHASE14_ALONE": ",".join(addrs[1:])}) for h in range(2)]
        sweep_wall = _run_trees("(a) sweep", cmds, 900)
        sweeps = [pickle.loads((tmp / f"s{h}.pkl").read_bytes()) for h in range(2)]
        summary = json.loads((tmp / "sweep" / "multirun" / "summary.json").read_text())
        gaps = [_same_state(load_state(tmp / "sweep" / "multirun" / str(i) / "checkpoints" / "last")["net"],
                            load_state(tmp / f"alone{i}" / "checkpoints" / "last")["net"])
                for i in range(len(SWEEP_VALUES))]
    for h, res in enumerate(sweeps):
        if [r["job"] for r in res["sweep"]] != list(range(len(SWEEP_VALUES))) or any("error" in r for r in res["sweep"]):
            fail(f"[hosts] (a) sweep, host {h}: jobs {res['sweep']}")
        for i, (r, alone) in enumerate(zip(res["sweep"], res["alone"], strict=True)):
            got, want = ({k: v for k, v in m.items() if k != "images_per_sec"} for m in (r["metrics"], alone))
            if not same_map(got, want):
                fail(f"[hosts] (a) sweep, host {h}, job {i} ({r['overrides']}): metrics {got} differ from the job "
                     f"run alone {want}")
    if [r["overrides"] for r in summary] != [[f"{SWEEP_KEY}={v}"] for v in SWEEP_VALUES]:
        fail(f"[hosts] (a) sweep: summary.json {summary}")
    log(f"[hosts] (a) -m sweep of {SWEEP_KEY}={','.join(SWEEP_VALUES)} (cli.train, yolov5s@416 bf16, host batch "
        f"{SWEEP_B}, {SWEEP_N // (2 * SWEEP_B)} steps of the step loop, validated) over the same 2 hosts x 1 gloo rank "
        f"on cuda:0 (KOD_*, one group for the sweep): each job's metric dict equal to the job run alone over the two "
        f"hosts (map {[r['metrics']['map'] for r in sweeps[0]['sweep']]}); weights of each swept job against the job "
        f"alone, largest difference {gaps}; one summary.json; "
        f"{sweep_wall:.2f} s for the sweep and both jobs alone | {card}")
    val_blocks = -(-(DDP_VAL // 2) // HOSTS_B)  # each rank validates at its share of its host's batch
    for r, res in enumerate(ranks):
        if res["layout"] != (2, r, 2, r, 0):
            fail(f"[hosts] (a) rank {r}: layout (size, rank, hosts, host, local rank) {res['layout']}")
        want = {"gather_rows_planar": DDP_STEPS, "hsv_planar": DDP_STEPS, "warp_quadrants": DDP_STEPS,
                "greedy_nms_mask": val_blocks}
        for loop in ("counts_step", "counts_fused"):
            for k, n in want.items():
                if res[loop][k] != n:
                    fail(f"[hosts] (a) rank {r} {loop} launched {k} {res[loop][k]} times, want {n}")
        if not (np.isfinite(res["losses"]).all() and finite_map(res["map"])):
            fail(f"[hosts] (a) rank {r}: losses or mAP not finite")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        fail("[hosts] (a) the two ranks' weights differ")
    train_info, val_info = _ddp_infos(DDP_N, DDP_VAL)
    for h, res in enumerate(ranks):  # each host's first plan is _epoch_plan's for that host, on the CPU
        cpu = DeviceDataPipeline(train_info, TRAIN_S, HOSTS_B, AugParams(), max_targets=MAX_TARGETS, seed=0,
                                 device="cpu", device_cache=False,
                                 mesh=DataMesh(2, h, torch.device("cpu"), object(), "gloo", 2))
        if not np.array_equal(res["plan"], cpu._epoch_plan()[0]):
            fail(f"[hosts] (a) host {h}'s first plan differs from _epoch_plan on the CPU")
    if np.array_equal(ranks[0]["plan"], ranks[1]["plan"]):
        fail("[hosts] (a) the two hosts ran the same plan")
    # one process at the global batch: its own step loop (its plan is not the
    # hosts'), then rank 0's state, then the fused epoch: the same batches
    one = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=2 * HOSTS_B,
                  max_targets=MAX_TARGETS, seed=0, dtype=torch.bfloat16, device="cuda", max_epochs=2,
                  fused_epoch=False)
    one.fit(max_epochs=1, epoch_steps=DDP_STEPS)
    net_state, opt_state = ranks[0]["after_step"]
    one.net.load_state_dict(net_state)
    one.optimizer.load_state_dict(opt_state)
    one.fused_epoch = True
    one.fit(max_epochs=2, epoch_steps=DDP_STEPS)
    want = np.asarray(one.epoch_metrics[1]["total"])
    got = np.asarray(ranks[0]["losses"])
    gaps = np.abs(got - want) / np.abs(want)
    if not np.allclose(got[:3], want[:3], rtol=1e-3, atol=0):  # phase 13 (b)'s rule: bf16 drifts step by step
        fail(f"[hosts] (a) fused losses {got.tolist()} vs one process {want.tolist()}: the first three beyond "
             "rtol 1e-3")
    one.net.load_state_dict(ranks[0]["state"])
    whole = one_process_map(one, HOSTS_B)
    for r, res in enumerate(ranks):
        merged = {k: v for k, v in res["map"].items() if k != "images_per_sec"}
        if not same_map(merged, whole):
            fail(f"[hosts] (a) rank {r}'s mAP dict {merged} differs from one process's {whole}")
    log(f"[hosts] (a) 2 hosts x 1 gloo rank on cuda:0 via KOD_* (two process trees), yolov5s@{TRAIN_S} bf16, "
        f"host batch {HOSTS_B} (global {2 * HOSTS_B}), {DDP_STEPS} steps of the step loop then {DDP_STEPS} of the "
        f"fused epoch (graph {ranks[0]['fused_graph']}: gloo is not captured), each validated: launches step loop "
        f"rank 0 {ranks[0]['counts_step']}, rank 1 {ranks[1]['counts_step']}; fused rank 0 "
        f"{ranks[0]['counts_fused']}, rank 1 {ranks[1]['counts_fused']} (K1 over each rank's "
        f"{ranks[0]['val_images']} of {DDP_VAL} val images); each host's first plan = _epoch_plan on the CPU for "
        f"that host, the two plans differ; weights bitwise equal on both ranks; fused losses {got.tolist()} vs "
        f"one process at B={2 * HOSTS_B} {want.tolist()}: relative gaps {gaps.tolist()} (the first three within rtol "
        f"1e-3); both ranks "
        f"read the one-process mAP dict (map {whole['map']:.6g}); {wall:.2f} s for both trees | {card}")
    out["a"] = {k: sum(res[loop][k] for res in ranks for loop in ("counts_step", "counts_fused"))
                for k in ranks[0]["counts_step"]}
    del one

    # (b) two hosts of two NCCL cards
    count = torch.cuda.device_count()
    if count < 4:
        log(f"[hosts] (b) needs 4 cards, this machine shows {count}: not run")
    else:
        out.update(_phase_hosts_b(card, me))
    log(f"[hosts] phase 14 {time.perf_counter() - t_phase:.2f} s | {card}")
    return out


def _phase_hosts_b(card, me):
    """Phase 14 (b): 2 x 2 NCCL cards through KOD_* and torchrun against
    4 cards on one host, each at a global batch of 256."""
    import pickle

    root = Path(__file__).resolve().parent
    runs = {}
    with tempfile.TemporaryDirectory(prefix="hosts-b-") as tmp:
        tmp = Path(tmp)
        torch.cuda.empty_cache()
        runs["1 host x 4"] = launch_logged("hosts", _ddp_mesh_run, 4, (_hosts_cfg(root, tmp / "one", 4, 1), True),
                                           timeout_s=600, join_timeout_s=1200)
        trees = {}
        addr = f"127.0.0.1:{_free_port()}"
        cmds = [([sys.executable, me, "--hosts-child", "b-kod", str(tmp / f"kod{h}.pkl")],
                 {"CUDA_VISIBLE_DEVICES": f"{2 * h},{2 * h + 1}", "KOD_COORDINATOR_ADDRESS": addr,
                  "KOD_NUM_PROCESSES": "2", "KOD_PROCESS_ID": str(h)}) for h in range(2)]
        trees["2 hosts x 2, KOD_*"] = _run_trees("(b) KOD_*", cmds, 1500)
        runs["2 hosts x 2, KOD_*"] = [x for h in range(2) for x in pickle.loads((tmp / f"kod{h}.pkl").read_bytes())]
        port = _free_port()
        cmds = [([sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--nproc-per-node", "2",
                  "--node-rank", str(h), "--rdzv-backend", "c10d", "--rdzv-endpoint", f"127.0.0.1:{port}",
                  "--rdzv-id", "phase14", "--rdzv-conf", f"is_host={1 - min(h, 1)}", "--max-restarts", "0",
                  me, "--hosts-child", "b-torchrun", str(tmp / "torchrun.pkl")],
                 {"CUDA_VISIBLE_DEVICES": f"{2 * h},{2 * h + 1}"}) for h in range(2)]
        trees["2 hosts x 2, torchrun"] = _run_trees("(b) torchrun", cmds, 1500)
        runs["2 hosts x 2, torchrun"] = [pickle.loads((tmp / f"torchrun{r}.pkl").read_bytes())[0] for r in range(4)]
    base = runs["1 host x 4"]
    ref = base[0]["state"]
    counts = {}
    for name, rs in runs.items():
        r0 = rs[0]
        steps_c = 2 * r0["steps"]
        if (r0["batch"] != TRAIN_B * (4 if name.startswith("1 host") else 2)
                or r0["steps"] != MESH_PER_CARD // TRAIN_B):
            fail(f"[hosts] (b) {name}: host batch {r0['batch']}, {r0['steps']} steps an epoch")
        for r, res in enumerate(rs):
            for k in ("gather_rows_planar", "hsv_planar", "warp_quadrants"):
                if res["counts"][k] != steps_c:
                    fail(f"[hosts] (b) {name} rank {r} launched {k} {res['counts'][k]} times, want {steps_c}")
            if not finite_map(res["map"]):
                fail(f"[hosts] (b) {name} rank {r}: mAP not finite {res['map']}")
        if len({res["digest"] for res in rs}) != 1:
            fail(f"[hosts] (b) {name}: the ranks' weights differ")
        if len({json.dumps({k: v for k, v in res["map"].items() if k != "images_per_sec"}) for res in rs}) != 1:
            fail(f"[hosts] (b) {name}: the ranks read different mAP dicts")
        if rs[0]["digest"] != base[0]["digest"]:
            gap = max(float((rs[0]["state"][k].float() - v.float()).abs().max()) for k, v in ref.items())
            fail(f"[hosts] (b) {name}: weights not bitwise those of 1 host x 4 (largest difference {gap:.6g})")
        weights = "bitwise equal to 1 host x 4"
        idle = [round(1 - res["busy_ms"] / res["window_ms"], 4) if res["window_ms"] else None for res in rs]
        tree = f"; {trees[name]:.2f} s for both trees" if name in trees else ""
        prof_ips = 4 * TRAIN_B * r0["prof_steps"] / r0["window_ms"] * 1e3 if r0["window_ms"] else float("nan")
        log(f"[hosts] (b) {name}: yolov5s@{TRAIN_S} bf16 global B={4 * TRAIN_B} fused epoch, {r0['steps']} steps an "
            f"epoch x 2, layouts (size, rank, hosts, card) {[res['layout'] for res in rs]}: {r0['ips']:.2f} img/s over "
            f"both epochs' windows (rank 0, host clock; per epoch {[round(x, 2) for x in r0['ips_epochs']]}); "
            f"profiled {r0['prof_steps']} steps: {prof_ips:.2f} img/s, NCCL kernels "
            f"{r0['nccl_ms'] / r0['prof_steps']:.4f} ms a step, busy {r0['busy_ms'] / r0['prof_steps']:.4f} of "
            f"{r0['window_ms'] / r0['prof_steps']:.4f} ms a step; idle share per rank {idle}; peak memory per rank "
            f"{[round(res['peak'] / 2**30, 3) for res in rs]} GiB; launches rank 0 {r0['counts']}; NCCL graph nodes "
            f"{r0['nccl_nodes']}; weights {weights}; map {r0['map']['map']:.6g}{tree} | {card}")
        if name != "1 host x 4":
            counts[name] = {k: sum(res["counts"][k] for res in rs) for k in r0["counts"]}
    return {"b_kod": counts["2 hosts x 2, KOD_*"], "b_torchrun": counts["2 hosts x 2, torchrun"]}


# ------------------------------------------------------------ 15 rest
REST_STEPS = 4  # phase 15 (a): the fused fit of each policy (2 eager warm-up steps, then 2 replays)
REST_TIMED = 10  # phase 15 (a): the timed fused epoch of each policy (replays)
REMAT_S, REMAT_B, REMAT_N = 640, 32, 96  # phase 15 (a): the step loop at 640 (JAX's remat resolution)
OVERFLOW_SLOTS = 2  # phase 15 (c): assign_compact_slots an image, a planted overflow
OVERFLOW_STEPS = 3  # phase 15 (c): step-loop steps under the overflow
LOSS_REPS = 10  # phase 15 (c): the loss's forward and backward timed this many times
TRAINING_KERNELS = ("gather_rows_planar", "hsv_planar", "warp_quadrants")


def _same_state(a: dict, b: dict) -> float:
    """The largest absolute difference between two tensor dicts (0 when bitwise equal)."""
    return max(float((a[k].double() - b[k].double()).abs().max()) if a[k].numel() else 0.0 for k in a)


def _worst_key(a: dict, b: dict) -> str:
    """Where two tensor dicts differ most: the key, the gap and the largest
    magnitude of ``b[key]``."""
    gap, k = max((float((a[k].double() - b[k].double()).abs().max()), k) for k in a if a[k].numel())
    return f"{k} (gap {gap:.3e}, largest |value| {float(b[k].double().abs().max()):.4g})"


def _rest_rank(mesh):
    """Phase 15 (c) and (d), one of two gloo ranks on one card: the step loop
    under a planted overflow (3 steps, f32), then one epoch of the host
    feed (bf16)."""
    import numpy as np

    from object_detection_cib_torch.train.trainer import Trainer

    _ddp_card()
    train_info, val_info = _ddp_infos(DDP_N, TRAIN_B)
    kw = dict(size="s", image_size=TRAIN_S, batch_size=TRAIN_B, max_targets=MAX_TARGETS, seed=0,
              dtype=torch.bfloat16, device=mesh.device, mesh=mesh, max_epochs=1)
    t = Trainer(train_info, val_info, fused_epoch=False, assign_compact_slots=OVERFLOW_SLOTS,
                **{**kw, "dtype": None})
    _zero_kernels()
    m = t.fit(max_epochs=1, epoch_steps=OVERFLOW_STEPS)
    torch.cuda.synchronize()
    em = t.epoch_metrics[0]
    c2 = dict(losses=np.asarray(em["total"]).tolist(), drops=np.asarray(em["assign_drop"]).tolist(),
              counts=_read_kernels(), map=m)
    del t
    h = Trainer(train_info, val_info, pipeline="host", fake_mode=True, num_workers=8, **kw)
    _zero_kernels()
    t0 = time.perf_counter()
    m = h.fit(max_epochs=1)
    wall = time.perf_counter() - t0
    return dict(c2=c2, made=h.prefetcher.batches_made, steps=h.steps_per_epoch, counts=_read_kernels(),
                ips=h.epoch_imgs[0] / h.epoch_walls[0], wait=h.prefetcher.wait_seconds, wall=wall, map=m)


def _rest_remat_rank(mesh):
    """Phase 15 (a), one rank of an NCCL group: a fused fit of each remat
    policy (no remat twice) with the global BatchNorm, whose all-reduces the
    recompute reissues inside the captured graph under ``conv_out`` and
    ``nothing`` and leaves alone under ``conv_out_bn_stats``."""
    from object_detection_cib_torch.models.layers import BatchNorm
    from object_detection_cib_torch.parallel.distributed import all_reduce_sum_
    from object_detection_cib_torch.train.steps import REMAT_SAVES
    from object_detection_cib_torch.train.trainer import Trainer

    _ddp_card()
    torch.backends.cudnn.deterministic = True
    train_info, val_info = _ddp_infos(DDP_N, TRAIN_B)
    runs = {}
    for name in ("none", "none again", *sorted(REMAT_SAVES)):
        t = Trainer(train_info, val_info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B, max_targets=MAX_TARGETS,
                    seed=0, dtype=torch.bfloat16, device=mesh.device, mesh=mesh, max_epochs=1,
                    remat_policy=None if name.startswith("none") else name)
        _zero_kernels()
        calls = all_reduce_sum_.calls
        t.fit(max_epochs=1, epoch_steps=REST_STEPS)
        torch.cuda.synchronize()
        fn = t._fused_fn
        runs[name] = dict(calls=all_reduce_sum_.calls - calls, counts=_read_kernels(),
                          python_steps=fn.WARMUP_STEPS + len(fn.graphs),
                          n_bn=sum(isinstance(m, BatchNorm) for m in t.net.modules()),
                          state={k: v.detach().cpu() for k, v in t.net.state_dict().items()},
                          grads={n: p.grad.detach().cpu() for n, p in t.net.named_parameters()})
        del t, fn
        gc.collect()  # the trainer's CUDA graphs hold NCCL work and sit in reference cycles
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    floor = {k: _same_state(runs["none again"][k], runs["none"][k]) for k in ("grads", "state")}
    return {name: dict(calls=r["calls"], counts=r["counts"], python_steps=r["python_steps"], n_bn=r["n_bn"],
                       floor=floor, rank=mesh.rank, gap={k: _same_state(r[k], runs["none"][k]) for k in ("grads", "state")})
            for name, r in runs.items()}


def phase_rest(card):
    """Phase 15: what the port ran last on one host. (a) the remat
    policies, (b) the dense bf16 warp, (c) the overflow compaction over
    ranks, (d) one decode a host, (e) the entry's dry runs. Returns the
    launch counts of its paths."""
    import numpy as np

    from object_detection_cib_torch.core.assigner import Assignment, assign_targets, compact_level_assignment
    from object_detection_cib_torch.core.types import FeatureShape, default_anchors
    from object_detection_cib_torch.data.device_pipeline import DeviceCorpus, DeviceDataPipeline
    from object_detection_cib_torch.data.host_augment import AugParams, HSVParams
    from object_detection_cib_torch.data.synthetic import build_fake_manifest
    from object_detection_cib_torch.entry import dryrun_multichip
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.train.loss import yolov5_loss
    from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
    from object_detection_cib_torch.train.steps import REMAT_SAVES, make_train_step
    from object_detection_cib_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    _ddp_card()
    aug = AugParams()  # configs/data/augmentations/aug_params.yaml
    train_info, val_info = _ddp_infos(DDP_N, TRAIN_B)
    corpus = DeviceCorpus.fake(train_info, TRAIN_S, dev)
    steps = DDP_N // TRAIN_B
    kw = dict(size="s", image_size=TRAIN_S, batch_size=TRAIN_B, aug_params=aug, max_targets=MAX_TARGETS,
              seed=0, dtype=torch.bfloat16, device=dev, corpus=corpus, max_epochs=1)
    out = {}
    policies = ("none", "none again", *sorted(REMAT_SAVES))

    # (a) remat: each policy against none (twice, for the card's own run-to-run gap)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    fused, looped = {}, {}
    for name in policies:
        policy = None if name.startswith("none") else name
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = Trainer(train_info, val_info, remat_policy=policy, **kw)
        t.fit(max_epochs=1, epoch_steps=REST_STEPS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        state = {k: v.detach().clone() for k, v in t.net.state_dict().items()}
        grads = {n: p.grad.detach().clone() for n, p in t.net.named_parameters()}
        fn, pipe, opt = t._fused_fn, t.pipeline, t.optimizer
        xs = pipe.epoch_host_arrays(REST_TIMED)
        table = opt.hyper_table(opt.step_count, REST_TIMED)
        _zero_kernels()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        flat = fn(xs, table)
        ev[1].record()
        torch.cuda.synchronize()
        counts = _read_kernels()
        for k in TRAINING_KERNELS:
            if counts[k] != REST_TIMED:
                fail(f"[rest] (a) {name}: the fused epoch launched {k} {counts[k]} times, want {REST_TIMED}")
        if not torch.isfinite(flat[0]).all():
            fail(f"[rest] (a) {name}: losses not finite {flat[0].tolist()}")
        fused[name] = dict(state=state, grads=grads, peak=peak, ms=ev[0].elapsed_time(ev[1]) / REST_TIMED,
                           counts=counts, losses=t.epoch_metrics[0]["total"].tolist())
        out[f"a {name}"] = counts
        del t, fn, pipe, opt, flat
        gc.collect()  # the trainer's CUDA graphs sit in reference cycles
        torch.cuda.empty_cache()
    info640 = build_fake_manifest(num_images=REMAT_N, num_classes=NC, image_size=REMAT_S, seed=0)
    pipe640 = DeviceDataPipeline(info640, REMAT_S, REMAT_B, aug, max_targets=MAX_TARGETS, seed=0, device=dev)
    batches = [b for b, _ in pipe640.epoch(3)]
    for name in policies:
        policy = None if name.startswith("none") else name
        net = build_network(NC, "s", dtype=torch.bfloat16, device=dev, seed=0)
        opt = SmartSGD(net, OptimizerConfig(), len(pipe640))
        step = make_train_step(net, default_anchors(), FeatureShape(REMAT_S, REMAT_S), opt, remat_policy=policy)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(batches[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        state = {k: v.detach().clone() for k, v in net.state_dict().items()}
        grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
        t0 = time.perf_counter()
        for b in batches[1:]:
            step(b)
        torch.cuda.synchronize()
        looped[name] = dict(state=state, grads=grads, peak=peak,
                            ms=(time.perf_counter() - t0) * 1e3 / (len(batches) - 1))
        del net, opt, step
        torch.cuda.empty_cache()
    del pipe640, batches
    torch.backends.cudnn.deterministic = deterministic
    for where, runs in (("fused epoch 416 B=64", fused), ("step loop 640 B=32", looped)):
        ref = runs["none"]
        floor = {k: _same_state(runs["none again"][k], ref[k]) for k in ("grads", "state")}
        for name in policies[1:]:
            r = runs[name]
            gap = {k: _same_state(r[k], ref[k]) for k in ("grads", "state")}
            # remat runs the plain BatchNorm + SiLU and no remat the BS op: the
            # policies are held to each other (to ``nothing``), each gap no
            # larger than twice the gap of a second run without remat
            other = "nothing" if name in REMAT_SAVES else "none"
            held = {k: _same_state(r[k], runs[other][k]) for k in ("grads", "state")}
            if any(held[k] > 2 * floor[k] for k in held):
                fail(f"[rest] (a) {where} {name}: gap to remat {other} {held} beyond twice the run-to-run gap {floor}")
            log(f"[rest] (a) remat {name}, {where} (yolov5s bf16, cudnn.deterministic): gradients, parameters "
                f"and running statistics {'bitwise equal' if not any(held.values()) else held} to remat {other}; "
                f"to no remat (BS) gradients "
                f"{'bitwise equal' if gap['grads'] == 0 else 'max gap %.3e' % gap['grads']}, "
                f"state {'bitwise equal' if gap['state'] == 0 else 'max gap %.3e' % gap['state']} (run-to-run gap "
                f"{floor}); peak memory (max_memory_allocated above what was "
                f"allocated before {'the trainer was built' if 'fused' in where else 'the first step'}) "
                f"{r['peak'] / 2**30:.3f} GiB (none {ref['peak'] / 2**30:.3f}); "
                f"{'step' if 'fused' not in where else 'fused step'} {r['ms']:.4f} ms (none {ref['ms']:.4f})"
                + (f"; launches by replay {r['counts']}" if "counts" in r else "") + f" | {card}")
    # the same under a process group of NCCL ranks (one, or two where two
    # cards are visible): the global BatchNorm's all-reduces captured in the
    # graph, reissued by the recompute
    n_g = min(torch.cuda.device_count(), 2)
    gs = launch_logged("rest", _rest_remat_rank, n_g, device_type="cuda", timeout_s=300, join_timeout_s=600)
    for name, r in ((name, r) for g in gs for name, r in g.items()):
        extra = 0 if name in ("none", "none again", "conv_out_bn_stats") else 2 * r["n_bn"]
        per_step = 3 * r["n_bn"] + 3 + extra
        want = {k: REST_STEPS for k in TRAINING_KERNELS} | {"greedy_nms_mask": 1}
        for k, n in want.items():
            if r["counts"][k] != n:
                fail(f"[rest] (a) {r['rank']} of {n_g} NCCL ranks, {name}: launched {k} {r['counts'][k]} times, "
                     f"want {n}")
        if r["calls"] != r["python_steps"] * per_step + 1:
            fail(f"[rest] (a) {r['rank']} of {n_g} NCCL ranks, {name}: {r['calls']} all-reduces issued, want "
                 f"{r['python_steps']} x {per_step} + 1")
        if any(r["gap"][k] > 2 * r["floor"][k] for k in r["gap"]):
            fail(f"[rest] (a) {r['rank']} of {n_g} NCCL ranks, {name}: gap to no remat {r['gap']} beyond twice "
                 f"the run-to-run gap {r['floor']}")
        log(f"[rest] (a) remat {name}, launch({n_g} NCCL ranks) rank {r['rank']}, fused fit of {REST_STEPS} steps "
            f"at {TRAIN_S} global B={TRAIN_B} (yolov5s bf16, global BatchNorm, cudnn.deterministic): gradients, "
            f"parameters and running statistics "
            f"{'bitwise equal' if not any(r['gap'].values()) else 'max gap %s' % r['gap']} to no remat (run-to-run "
            f"gap {r['floor']}); all-reduces issued {r['calls']} = {r['python_steps']} step bodies run in Python x "
            f"{per_step} ({r['n_bn']} BatchNorms x 3 + 3 + {extra} reissued by the recompute) + 1; launches "
            f"{r['counts']} | {card}")
    out["a NCCL"] = {k: sum(r["counts"][k] for g in gs for r in g.values()) for k in gs[0]["none"]["counts"]}

    # (b) the dense bf16 warp, one fused epoch, beside K5
    ips = {}
    for name, wp in (("K5", "auto"), ("dense", False)):
        t = Trainer(train_info, val_info, warp_pallas=wp, **kw)
        _zero_kernels()
        m = t.fit(max_epochs=1)
        torch.cuda.synchronize()
        counts = _read_kernels()
        want = {"gather_rows_planar": steps, "hsv_planar": steps, "warp_quadrants": steps if name == "K5" else 0}
        for k, n in want.items():
            if counts[k] != n:
                fail(f"[rest] (b) {name} warp: launched {k} {counts[k]} times, want {n}")
        if not (np.isfinite(t.epoch_metrics[0]["total"]).all() and finite_map(m)):
            fail(f"[rest] (b) {name} warp: losses or mAP not finite")
        ips[name] = t.epoch_imgs[0] / t.epoch_walls[0]
        out[f"b {name}"] = counts
        log(f"[rest] (b) {name} warp (data.warp_pallas={wp}): one fused epoch of {steps} steps at yolov5s@"
            f"{TRAIN_S} B={TRAIN_B} bf16, {ips[name]:.2f} img/s (host clock, capture included); launches "
            f"{counts} | {card}")
        del t
        torch.cuda.empty_cache()
    plain = aug._replace(hsv_params=HSVParams.no_aug())
    pk, pd = (DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, plain, max_targets=MAX_TARGETS, seed=0, device=dev,
                                 corpus=corpus, feed_dtype=torch.float32, warp_pallas=wp) for wp in ("auto", False))
    groups, _ = pk._epoch_plan()
    idx = torch.from_numpy(groups[0].astype(np.int32)).to(dev)
    d = pk.draw()
    _zero_kernels()
    bk, _ = pk.gather_augment(idx, d)
    n_k5 = _read_kernels()["warp_quadrants"]
    bd, _ = pd.gather_augment(idx, d)
    n_dense = _read_kernels()["warp_quadrants"] - n_k5
    diff = (bk.images - bd.images).abs() * 255.0
    worst, equal = float(diff.max()), float((diff < 1e-3).float().mean())
    if n_k5 != 1 or n_dense != 0:
        fail(f"[rest] (b) warp launches: K5 path {n_k5} (want 1), dense {n_dense} (want 0)")
    if worst > 2.0 + 1e-3 or equal < 0.85:
        fail(f"[rest] (b) dense warp vs K5 beyond the fast class: max {worst}/255, {equal} equal")
    if not (torch.equal(bk.boxes, bd.boxes) and torch.equal(bk.labels, bd.labels) and torch.equal(bk.mask, bd.mask)):
        fail("[rest] (b) dense warp vs K5: boxes, labels or mask differ")
    log(f"[rest] (b) dense vs K5 warp on the same rows and draws, HSV off: max pixel difference {worst:.4f}/255, "
        f"{equal:.6f} of pixels equal (gate: <= 2, >= 0.85); boxes, labels, mask equal; img/s dense "
        f"{ips['dense']:.2f} beside K5 {ips['K5']:.2f} | {card}")
    del pk, pd, bk, bd

    # (c) and (d): two gloo ranks on this card against one process
    ranks = launch_logged("rest", _rest_rank, 2, device_type="cuda", backend="gloo", devices=[0, 0],
                          timeout_s=300, join_timeout_s=900)
    # each rank validates its half of the 64 val images at its share of the batch
    want_c = {"gather_rows_planar": OVERFLOW_STEPS, "hsv_planar": OVERFLOW_STEPS,
              "warp_quadrants": OVERFLOW_STEPS, "greedy_nms_mask": -(-(TRAIN_B // 2) // (TRAIN_B // 2))}
    # in f32: with a few slots a level kept, the loss averages few terms, and
    # bf16's rounding (which differs with the rows a card holds) would no
    # longer average out of the comparison of the compaction
    one = Trainer(train_info, val_info, fused_epoch=False, assign_compact_slots=OVERFLOW_SLOTS,
                  **{**kw, "dtype": None})
    one.fit(max_epochs=1, epoch_steps=OVERFLOW_STEPS)
    em = one.epoch_metrics[0]
    want_drops, want_losses = np.asarray(em["assign_drop"]), np.asarray(em["total"])
    for r, res in enumerate(ranks):
        got = res["c2"]
        if not np.array_equal(np.asarray(got["drops"]), want_drops) or not want_drops.sum() > 0:
            fail(f"[rest] (c) rank {r}: assign_drop {got['drops']} vs one process {want_drops.tolist()}")
        # f32: sound runs read relative gaps of 2.3e-7 at most (PERF.md, section 6)
        if not np.allclose(got["losses"], want_losses, rtol=1e-5, atol=0):
            fail(f"[rest] (c) rank {r}: losses {got['losses']} vs one process {want_losses.tolist()} beyond rtol 1e-5")
        for k, n in want_c.items():
            if got["counts"][k] != n:
                fail(f"[rest] (c) rank {r}: launched {k} {got['counts'][k]} times, want {n}")
        if not finite_map(got["map"]):
            fail(f"[rest] (c) rank {r}: mAP not finite {got['map']}")
    gap_c = max(float(np.max(np.abs(np.asarray(res["c2"]["losses"]) / want_losses - 1))) for res in ranks)
    del one
    # the loss's cost at the static table size over four cards, before (the per-rank cap) and after
    net = build_network(NC, "s", dtype=torch.bfloat16, device=dev, seed=0)
    pipe = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS, seed=0, device=dev,
                              corpus=corpus)
    batch, _ = next(iter(pipe.epoch(1)))
    with torch.no_grad():
        heads = net.train()(batch.images)
    assignment = assign_targets(batch.boxes, batch.labels, batch.mask, FeatureShape(TRAIN_S, TRAIN_S),
                                default_anchors())
    K = int(assignment.ll.valid.shape[0])
    loss_ms = {}
    for name, size in (("before: 128 x B_local", 128 * TRAIN_B), ("after: min(128 x B_global, K)",
                                                                  min(128 * TRAIN_B * 4, K))):
        a = Assignment(*(compact_level_assignment(lv, size) for lv in assignment.levels()))
        leaves = type(heads)(*(h._replace(raw=h.raw.detach().requires_grad_()) for h in heads.levels()))

        def loss_step():
            yolov5_loss(leaves, a, FeatureShape(TRAIN_S, TRAIN_S)).total.backward()

        loss_ms[name] = cuda_ms(loss_step, LOSS_REPS)
    del net, pipe, heads, leaves
    log(f"[rest] (c) two gloo ranks on cuda:0, step loop yolov5s@{TRAIN_S} global B={TRAIN_B} f32, "
        f"assign_compact_slots={OVERFLOW_SLOTS} (a planted overflow): assign_drop a step {ranks[0]['c2']['drops']} "
        f"equal to one process's {want_drops.tolist()}; losses {ranks[0]['c2']['losses']} vs "
        f"{want_losses.tolist()} (largest relative gap {gap_c:.3e}, gate rtol 1e-5); launches rank 0 "
        f"{ranks[0]['c2']['counts']}, rank 1 {ranks[1]['c2']['counts']}; the loss's forward and backward at a "
        f"rank's static table of four cards (B=64 a card, K={K}): {loss_ms} ms | {card}")
    made = [res["made"] for res in ranks]
    if made != [ranks[0]["steps"], 0]:
        fail(f"[rest] (d) batches made per rank {made}, want [{ranks[0]['steps']}, 0]: one decode a host")
    for r, res in enumerate(ranks):
        if any(res["counts"][k] for k in TRAINING_KERNELS) or not finite_map(res["map"]):
            fail(f"[rest] (d) rank {r}: training kernels on the host feed {res['counts']} or mAP not finite")
    log(f"[rest] (d) two gloo ranks on cuda:0, host pipeline (fake canvases, 8 threads) yolov5s@{TRAIN_S} "
        f"global B={TRAIN_B}, one epoch of {ranks[0]['steps']} steps: batches made rank 0 {made[0]}, rank 1 "
        f"{made[1]} (1x a host); {ranks[0]['ips']:.2f} img/s, rank 0 waited {ranks[0]['wait']:.2f} s on its "
        f"queue; launches rank 0 {ranks[0]['counts']} | {card}")
    out["c"] = {k: ranks[0]["c2"]["counts"][k] + ranks[1]["c2"]["counts"][k] for k in ranks[0]["counts"]}
    out["d"] = {k: ranks[0]["counts"][k] + ranks[1]["counts"][k] for k in ranks[0]["counts"]}
    del corpus
    torch.cuda.empty_cache()

    # (e) the entry's dry runs on the cards visible
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    r0 = dryrun_multichip(n, device_type="cuda")
    log(f"[rest] (e) entry.dryrun_multichip({n}) on {n} cards: (1) loss {r0['loss']:.4f}; (3) fused epoch "
        f"{len(r0['fused']['losses'])} steps, launches rank 0 {r0['fused']['launches']}; (4) sharded corpus "
        f"{r0['sharded']['held_rows']} rows a rank, launches rank 0 {r0['sharded']['launches']}; weights equal "
        f"on every rank; {time.perf_counter() - t0:.2f} s | {card}")
    out["e"] = {k: r0["fused"]["launches"].get(k, 0) + r0["sharded"]["launches"].get(k, 0)
                for k in ranks[0]["counts"]}
    log(f"[rest] phase 15 {time.perf_counter() - t_phase:.2f} s | {card}")
    return out


# ------------------------------------------------------------ 16 spatial
SP_S, SP_B, SP_STEPS = 1280, 8, 3  # phase 16: yolov5s@1280 f32, global B=8, 3 spatial steps
SP_BF16_B, SP_PROF_STEPS = 16, 3  # phase 16 (b), (c): the bf16 step's global batch; steps timed
SP_GUARD = ((64, True), (96, True), (128, False))  # (image height over two bands, the guard raises)
SP_T = 16  # target slots an image


def _sp_batch(B: int, S: int, seed: int, dev):
    """A global batch of ``B`` images at ``S`` px: images drawn on the card
    from ``seed`` (the same on every card), up to ``SP_T`` random boxes an
    image from numpy's ``seed``."""
    import numpy as np

    from object_detection_cib_torch.train.steps import Batch

    rng = np.random.default_rng(seed)
    boxes = np.zeros((B, SP_T, 4), np.float32)
    labels = np.zeros((B, SP_T), np.int64)
    mask = np.zeros((B, SP_T), bool)
    for b in range(B):
        for t in range(rng.integers(1, SP_T)):
            x, y = rng.uniform(0, S * 0.8, 2)
            w, h = rng.uniform(S / 80, S / 4, 2)
            boxes[b, t] = [x, y, min(x + w, S - 1), min(y + h, S - 1)]
            labels[b, t] = rng.integers(0, NC)
            mask[b, t] = True
    images = torch.rand((B, S, S, 3), generator=torch.Generator(dev).manual_seed(seed), device=dev)
    return Batch(images, *(torch.from_numpy(a).to(dev) for a in (boxes, labels, mask)))


def _sp_steps(mesh, dtype, B: int, S: int, steps: int, remat_policy=None, keep_state=False):
    """``steps`` steps of yolov5s (seed 0) at ``S`` px and a global batch of
    ``B`` on this rank's rows and band (``mesh`` None: one process, whole
    images): the metrics summed over the data ranks a step, the halo
    exchanges' bytes, the state (on the CPU) where asked."""
    import numpy as np

    from object_detection_cib_torch.core.types import FeatureShape, default_anchors
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.parallel.distributed import all_reduce_sum_
    from object_detection_cib_torch.parallel.mesh import shard_batch_pytree
    from object_detection_cib_torch.parallel.spatial import HaloCounts
    from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
    from object_detection_cib_torch.train.steps import make_train_step

    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    net = build_network(NC, "s", dtype=torch.bfloat16 if dtype == torch.bfloat16 else None, device=dev, seed=0)
    net = net.to(torch.float64) if dtype == torch.float64 else net  # f64: the parameters too
    step = make_train_step(net, default_anchors(), FeatureShape(S, S), SmartSGD(net, OptimizerConfig(), 10),
                           mesh=mesh, remat_policy=remat_policy)
    metrics, sent = [], HaloCounts.bytes_sent
    for i in range(steps):
        batch = _sp_batch(B, S, i, dev)
        batch = batch._replace(images=batch.images.to(torch.float64)) if dtype == torch.float64 else batch
        if mesh is not None:
            batch = shard_batch_pytree(batch, mesh, spatial=True)
        m = step(batch)
        v = torch.stack([m.total, m.box, m.obj, m.cls, m.assign_drop.to(m.total.dtype)]).double()
        if mesh is not None:
            all_reduce_sum_(v, mesh.group)
        metrics.append(v.cpu().numpy())
    torch.cuda.synchronize(dev)
    out = dict(metrics=np.array(metrics), halo_bytes=(HaloCounts.bytes_sent - sent) / steps)
    if keep_state:
        out["state"] = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    return out


def _nccl_ms(prof) -> dict:
    """NCCL kernel ms of a profiler trace by kernel name (its arguments cut;
    the ``nccl:*`` ranges the profiler also draws on the card's timeline are
    not kernels)."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name.startswith("nccl") and "Kernel" in e.name:
            name = e.name.split("(")[0]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


def _sp_profiled(mesh, B: int):
    """The bf16 step at ``SP_S`` and a global batch of ``B`` (``mesh`` None:
    one process): after a warm-up step, ms a step over ``SP_PROF_STEPS``
    (host clock to a synchronise), peak memory (``max_memory_allocated``),
    the halo bytes sent a step, and one profiled step's busy time, window and
    NCCL kernel ms by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from object_detection_cib_torch.core.types import FeatureShape, default_anchors
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.parallel.mesh import shard_batch_pytree
    from object_detection_cib_torch.parallel.spatial import HaloCounts
    from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
    from object_detection_cib_torch.train.steps import make_train_step

    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    net = build_network(NC, "s", dtype=torch.bfloat16, device=dev, seed=0)
    step = make_train_step(net, default_anchors(), FeatureShape(SP_S, SP_S), SmartSGD(net, OptimizerConfig(), 10),
                           mesh=mesh)
    batch = _sp_batch(B, SP_S, 0, dev)
    if mesh is not None:
        batch = shard_batch_pytree(batch, mesh, spatial=True)
    step(batch)
    torch.cuda.synchronize(dev)
    sent = HaloCounts.bytes_sent
    t0 = time.perf_counter()
    for _ in range(SP_PROF_STEPS):
        step(batch)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / SP_PROF_STEPS
    halo = (HaloCounts.bytes_sent - sent) / SP_PROF_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize(dev)
    busy, window, _ = _busy_idle(prof)
    return dict(ms=ms, peak=torch.cuda.max_memory_allocated(dev), halo_bytes=halo, busy_ms=busy, window_ms=window,
                nccl=_nccl_ms(prof))


def _spatial_rank(mesh, num_data: int, profiled: bool):
    """Phase 16, one rank of a ``(num_data, 2)`` mesh over the launched
    group: three f32 and three f64 steps at 1280 px (global B=8), the guard's three
    heights, one step under ``conv_out`` against none (twice, for the card's
    own run-to-run gap, under ``cudnn.deterministic``), and with
    ``profiled`` the bf16 step at global B=16."""
    from object_detection_cib_torch.parallel.mesh import make_mesh

    _ddp_card()
    sp = make_mesh(num_data, 2, device=mesh.device)
    main = sp.is_main
    _zero_kernels()
    out = dict(layout=(sp.size, sp.rank, sp.model_size, sp.model_rank, str(sp.device)),
               steps=_sp_steps(sp, torch.float32, SP_B, SP_S, SP_STEPS, keep_state=main),
               f64=_sp_steps(sp, torch.float64, SP_B, SP_S, SP_STEPS, keep_state=main))
    guard = {}
    for h, _ in SP_GUARD:
        try:
            _sp_steps(sp, torch.float32, 2 * num_data, h, 1)
            guard[h] = "ran"
        except ValueError as e:
            if "rows per shard" not in str(e):
                raise
            guard[h] = str(e)
    out["guard"] = guard
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out["remat"] = {name: _sp_steps(sp, torch.float32, SP_B, SP_S, 1, remat_policy=policy, keep_state=True)
                    for name, policy in (("none", None), ("none again", None), ("conv_out", "conv_out"))}
    torch.backends.cudnn.deterministic = deterministic
    if profiled:
        out["bf16"] = _sp_profiled(sp, SP_BF16_B)
    out["counts"] = _read_kernels()
    if not main:
        for r in out["remat"].values():
            r.pop("state")
    return out


def phase_spatial(card):
    """Phase 16: DP x SP spatial sharding (module docstring). Returns the
    ranks' launch counts of K1-K5, which this path does not launch."""
    import numpy as np

    from object_detection_cib_torch.entry import dryrun_multichip

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    runs = {"a": ("two gloo ranks on cuda:0", 2, 1, dict(backend="gloo", devices=[0, 0]), False)}
    for part, need, nd in (("b", 2, 1), ("c", 4, 2)):
        if count >= need:
            runs[part] = (f"{need} NCCL ranks on cards 0-{need - 1}", need, nd, {}, True)
        else:
            log(f"[spatial] ({part}) needs {need} cards, this machine shows {count}: not run")
    got = {part: launch_logged("spatial", _spatial_rank, n, (nd, prof), device_type="cuda", timeout_s=300,
                               join_timeout_s=900, **kw)
           for part, (_, n, nd, kw, prof) in runs.items()}
    torch.cuda.empty_cache()
    one = _sp_steps(None, torch.float32, SP_B, SP_S, SP_STEPS, keep_state=True)
    one64 = _sp_steps(None, torch.float64, SP_B, SP_S, SP_STEPS, keep_state=True)
    truth = _same_state(one["state"], one64["state"])  # the one-process f32 step's own distance to f64
    one_bf16 = _sp_profiled(None, SP_BF16_B) if len(runs) > 1 else None
    torch.cuda.empty_cache()
    counts = {}
    for part, ranks in got.items():
        what, n, nd, _, _ = runs[part]
        r0 = ranks[0]
        # (a) the spatial steps against one process
        for r, res in enumerate(ranks):
            m, want = res["steps"]["metrics"], one["metrics"]
            if not np.array_equal(m[:, 4], want[:, 4]):
                fail(f"[spatial] ({part}) rank {r}: assign_drop {m[:, 4].tolist()} vs one process {want[:, 4].tolist()}")
            if not np.allclose(m[:, :4], want[:, :4], rtol=1e-5, atol=0):
                fail(f"[spatial] ({part}) rank {r}: losses {m[:, 0].tolist()} vs one process {want[:, 0].tolist()} "
                     "beyond rtol 1e-5")
            for h, raises in SP_GUARD:
                said = res["guard"][h]
                if (said != "ran") != raises:
                    fail(f"[spatial] ({part}) rank {r}: the guard at H={h} over two bands: {said}")
            if any(res["counts"].values()):
                fail(f"[spatial] ({part}) rank {r}: the spatial path launched K1-K5 {res['counts']}")
        gap = _same_state(r0["steps"]["state"], one["state"])
        gap64 = _same_state(r0["f64"]["state"], one64["state"])
        exact = _same_state(r0["steps"]["state"], one64["state"])  # the spatial f32 step against the f64 step
        if not gap64 <= 1e-10:
            fail(f"[spatial] ({part}) f64 parameters or running statistics {gap64:.3e} from one process (bound "
                 f"1e-10), most at {_worst_key(r0['f64']['state'], one64['state'])}")
        # in f32 the state is reported, not gated: a max pool's argmax flips at near-ties under any other
        # rounding, so one process in f32 itself lies ~1e-4 from the f64 step at 1280 px (PERF.md, section 6)
        rel = float(np.max(np.abs(r0["steps"]["metrics"][:, :4] / one["metrics"][:, :4] - 1)))
        rm = r0["remat"]
        floor, remat_gap = (_same_state(rm[k]["state"], rm["none"]["state"]) for k in ("none again", "conv_out"))
        if remat_gap > 2 * floor:
            fail(f"[spatial] ({part}) conv_out gap {remat_gap:.3e} to no remat beyond twice the run-to-run gap "
                 f"{floor:.3e}")
        log(f"[spatial] ({part}) {what}, mesh (data {nd}, model 2), layouts (data size, data rank, model size, model "
            f"rank, card) {[res['layout'] for res in ranks]}: yolov5s@{SP_S} f32 global B={SP_B}, {SP_STEPS} "
            f"spatial steps against one process: losses {r0['steps']['metrics'][:, 0].tolist()} vs "
            f"{one['metrics'][:, 0].tolist()} (largest relative gap {rel:.3e}, gate rtol 1e-5), assign_drop "
            f"{r0['steps']['metrics'][:, 4].tolist()} equal; parameters and running statistics {gap:.3e} from one "
            f"process in f32 (most at {_worst_key(r0['steps']['state'], one['state'])}), {exact:.3e} from one process "
            f"in f64, where one process in f32 lies {truth:.3e} from it (not gated: argmax flips); in f64 "
            f"{gap64:.3e} from one process (gate 1e-10); halo bytes sent a step by rank 0 {r0['steps']['halo_bytes']:.0f}; the guard at H=64, 96 "
            f"raised 'rows per shard', H=128 ran; conv_out against no remat (cudnn.deterministic) "
            f"{'bitwise equal' if remat_gap == 0 else 'max gap %.3e' % remat_gap} (run-to-run gap {floor:.3e}); "
            f"K1-K5 launched {r0['counts']} (none on this path) | {card}")
        if part != "a":
            b = [res["bf16"] for res in ranks]
            idle = [round(1 - x["busy_ms"] / x["window_ms"], 4) if x["window_ms"] else None for x in b]
            log(f"[spatial] ({part}) {what}, yolov5s@{SP_S} bf16 global B={SP_BF16_B}: {b[0]['ms']:.4f} ms a step "
                f"(host clock, mean of {SP_PROF_STEPS}) against one card alone {one_bf16['ms']:.4f}; peak memory "
                f"per rank {[round(x['peak'] / 2**30, 3) for x in b]} GiB against one card alone "
                f"{one_bf16['peak'] / 2**30:.3f} GiB; halo bytes sent a step per rank "
                f"{[int(x['halo_bytes']) for x in b]}; one profiled step: NCCL kernel ms by kernel per rank "
                f"{[{k: round(v, 4) for k, v in x['nccl'].items()} for x in b]}, busy "
                f"{[round(x['busy_ms'], 4) for x in b]} of window {[round(x['window_ms'], 4) for x in b]} ms, idle "
                f"share per rank {idle} (one card alone {one_bf16['busy_ms']:.4f} of {one_bf16['window_ms']:.4f}) "
                f"| {card}")
        counts[part] = {k: sum(res["counts"][k] for res in ranks) for k in r0["counts"]}
    if count >= 4:
        t0 = time.perf_counter()
        r0 = dryrun_multichip(4, device_type="cuda")
        log(f"[spatial] (c) entry.dryrun_multichip(4): dry runs 1-4, DP x SP loss {r0['spatial']['loss']:.4f} over "
            f"mesh (data 2, model 2); {time.perf_counter() - t0:.2f} s | {card}")
    log(f"[spatial] phase 16 {time.perf_counter() - t_phase:.2f} s | {card}")
    return counts


# ------------------------------------------------------------ 18 flat
FLAT_STEPS = 40  # phase 18 (a): the fused fit of each layout
FLAT_RECIPE_STEPS = 10  # phase 18 (b): the no-mosaic recipe's step loop
FLAT_DDP_STEPS = 3  # phase 13 (d): steps of the sharded corpus's batches in each layout


def phase_flat(card, dev, aug, train_info, val_info, corpus):
    """Phase 18: the flat corpus (``data.corpus_layout=flat``: the NHWC rows
    on the card, gathered by K3 on their (N, 8, D/8) view) at phase 8's
    width beside phase 6's planar ``corpus``. Returns the launch counts of
    its paths and K3's numbers on the NHWC corpus: (max abs error, timing,
    call_ms) as phase 7 keeps them."""
    import numpy as np

    from object_detection_cib_torch.cli.train import main as cli_main
    from object_detection_cib_torch.data.device_pipeline import DeviceCorpus, DeviceDataPipeline, fake_canvases
    from object_detection_cib_torch.data.samplers import RepeatFactorSampler
    from object_detection_cib_torch.ops import gather as gather_ops
    from object_detection_cib_torch.train import trainer as trainer_mod
    from object_detection_cib_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    out = {}
    # set-up: the same canvases into each layout, in turns (planar, flat)
    t0 = time.perf_counter()
    canvases, sizes = fake_canvases(train_info, TRAIN_S)
    draw_s = time.perf_counter() - t0
    setup, flat = {}, None
    for layout in ("planar", "flat"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = DeviceCorpus.from_canvases(train_info, canvases, sizes, dev, layout)
        torch.cuda.synchronize()
        setup[layout] = time.perf_counter() - t0
        if layout == "planar":
            if not torch.equal(c.images, corpus.images):
                fail("[flat] the planar corpus from the canvases differs from phase 6's")
            del c
        else:
            flat = c
    del canvases
    torch.cuda.empty_cache()
    if not torch.equal(flat.images.permute(0, 3, 1, 2), corpus.images):
        fail("[flat] the NHWC corpus is not phase 6's planar corpus transposed")
    log(f"[flat] set-up: {tuple(flat.images.shape)} uint8 = {flat.images.numel()} B on the card, the same canvases "
        f"(drawn on the host in {draw_s:.2f} s) copied up as NHWC rows in {setup['flat']:.3f} s against "
        f"{setup['planar']:.3f} s for the planar corpus (copied up, transposed on the card); the NHWC rows equal "
        f"phase 6's planar corpus transposed | {card}")

    # K3 at the main path's rows: a mosaic step's 4B and a no-mosaic step's B
    view = gather_ops.flat_view(flat.images)
    K = 4 * TRAIN_B
    idx_np = np.random.default_rng(1).integers(0, TRAIN_N, K).astype(np.int32)
    idx_np[:4] = idx_np[4]  # repeated rows, as phase 7
    idx = torch.from_numpy(idx_np).to(dev)
    plan = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS, use_mosaic=False,
                              sampler=RepeatFactorSampler(train_info), seed=0, device=dev, corpus=flat,
                              corpus_layout="flat")._epoch_plan()[0]
    idx_b = torch.from_numpy(plan[0].astype(np.int32)).to(dev)
    if idx_b.numel() != TRAIN_B:
        fail(f"[flat] the no-mosaic plan holds {idx_b.numel()} rows a step, want {TRAIN_B}")
    err = 0.0
    for rows in (idx, idx_b):
        err = max(err, check_equal(f"gather_rows_flat {tuple(view.shape)}[{rows.numel()}] (the NHWC corpus's view)",
                                   gather_ops.gather_rows_flat(view, rows), gather_ops.gather_rows_plain(view, rows)))
        if not torch.equal(gather_ops.gather_rows_nhwc(flat.images, rows), flat.images[rows.long()]):
            fail("[flat] gather_rows_nhwc differs from the corpus's rows")
    row_bytes = view[0].numel()
    k_ms, p_ms, turns = in_turns(lambda: gather_ops.gather_rows_flat(view, idx),
                                 lambda: gather_ops.gather_rows_plain(view, idx), 30, 10)
    lib_ms = statistics.median([run_ms(lambda: torch.index_select(view, 0, idx.long()), 30) for _ in range(2)])
    timing = (k_ms, p_ms, lib_ms, *bound(2 * K * row_bytes, 0))
    calls = (cuda_ms(lambda: gather_ops.gather_rows_flat(view, idx), 30),
             cuda_ms(lambda: torch.index_select(view, 0, idx.long()), 30))
    log(f"[flat] gather_rows_flat K={K} rows of {row_bytes} B (the NHWC corpus's view): kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, torch.index_select {lib_ms:.4f} ms, bound {timing[3]:.6f} ms ({timing[4]}), "
        f"{timing[3] / k_ms:.4f} of the byte bound (turns {turns}); one call from an idle stream: kernel "
        f"{calls[0]:.4f} ms, torch.index_select {calls[1]:.4f} ms | {card}")
    rows_nhwc = gather_ops.gather_rows_nhwc(flat.images, idx)
    step_ms = cuda_ms(lambda: gather_ops.gather_rows_nhwc(flat.images, idx).permute(0, 3, 1, 2).contiguous(), 30)
    permute_ms = cuda_ms(lambda: rows_nhwc.permute(0, 3, 1, 2).contiguous(), 30)
    log(f"[flat] one flat gather of a step (K3 + the permute-copy to planar, K={K}) {step_ms:.4f} ms against K2 "
        f"alone {cuda_ms(lambda: gather_ops.gather_rows_planar(corpus.images, idx), 30):.4f} ms; the permute-copy "
        f"alone {permute_ms:.4f} ms for {2 * K * row_bytes} B moved (bytes bound {bound(2 * K * row_bytes, 0)[0]:.6f} "
        f"ms) (CUDA events, one call each, median of 30) | {card}")
    del rows_nhwc

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # two runs of the same steps bitwise equal
    try:
        kw = dict(size="s", image_size=TRAIN_S, batch_size=TRAIN_B, aug_params=aug, max_targets=MAX_TARGETS,
                  seed=0, dtype=torch.bfloat16, device=dev)
        # (a) fused fits of each layout from the same weights and seed, in
        # turns (planar, flat, flat, planar): the first fit of a process
        # pays for cuDNN's and the allocator's first calls
        fits = {}
        for turn, layout in enumerate(("planar", "flat", "flat", "planar")):
            c = corpus if layout == "planar" else flat
            t = Trainer(train_info, val_info, corpus=c, corpus_layout=layout, **kw)
            t.loop = t.loop._replace(check_val_every_n_epoch=2)  # one epoch, no validation
            _zero_kernels()
            t0 = time.perf_counter()
            t.fit(max_epochs=1, epoch_steps=FLAT_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _read_kernels()
            want = {"gather_rows_planar": FLAT_STEPS if layout == "planar" else 0,
                    "gather_rows_flat": FLAT_STEPS if layout == "flat" else 0,
                    "hsv_planar": FLAT_STEPS, "warp_quadrants": FLAT_STEPS, "greedy_nms_mask": 0}
            for k, n in want.items():
                if got[k] != n:
                    fail(f"[flat] (a) {layout} fused fit launched {k} {got[k]} times, want {n}")
            losses = t.epoch_metrics[0]["total"]
            if t._fused_fn is None or not np.isfinite(losses).all():
                fail(f"[flat] (a) {layout}: not the fused epoch, or losses not finite {losses}")
            fits[turn] = dict(layout=layout, state={k: v.detach().clone() for k, v in t.net.state_dict().items()},
                              ips=sum(t.epoch_imgs) / sum(t.epoch_walls), walls=list(t.epoch_walls), counts=got,
                              losses=losses, wall=wall)
            out[f"a {layout}"] = got
            del t
            gc.collect()  # the trainer's CUDA graphs sit in reference cycles
            torch.cuda.empty_cache()
        for turn, f in fits.items():
            gap = max((f["state"][k].double() - v.double()).abs().max().item() for k, v in fits[0]["state"].items())
            if gap != 0.0:
                fail(f"[flat] (a) turn {turn} ({f['layout']}): the weights differ from turn 0's (planar) by {gap}")
            log(f"[flat] (a) turn {turn}, {f['layout']} corpus, fused fit of {FLAT_STEPS} steps (yolov5s@{TRAIN_S} "
                f"B={TRAIN_B} bf16, cudnn.deterministic): {f['ips']:.2f} img/s over the epoch's window (host clock, "
                f"fetch to fetch, {[round(w, 4) for w in f['walls']]} s); whole fit {f['wall']:.2f} s; launches "
                f"{f['counts']}; losses {f['losses'][0]:.4f}->{f['losses'][-1]:.4f} | {card}")
        ips = {n: [round(f["ips"], 2) for f in fits.values() if f["layout"] == n] for n in ("planar", "flat")}
        log(f"[flat] (a) weights after every fit bitwise equal ({len(fits[0]['state'])} tensors); img/s in turns "
            f"(planar, flat, flat, planar): planar {ips['planar']}, flat {ips['flat']} (an observation, not a "
            f"claim) | {card}")
        del fits

        # (b) the repeat-factor recipe without mosaic on the step loop
        runs = {}
        for layout, c in (("planar", corpus), ("flat", flat)):
            t = Trainer(train_info, val_info, corpus=c, corpus_layout=layout, sampler=RepeatFactorSampler(train_info),
                        use_mosaic=False, fused_epoch=False, **kw)
            rp = t.pipeline
            _zero_kernels()
            batches = []
            for batch, _ in rp.epoch(FLAT_RECIPE_STEPS):
                batches.append(tuple(x.clone() for x in batch))
                t.train_step(batch)
            torch.cuda.synchronize()
            got = _read_kernels()
            want = {"gather_rows_planar": FLAT_RECIPE_STEPS if layout == "planar" else 0,
                    "gather_rows_flat": FLAT_RECIPE_STEPS if layout == "flat" else 0,
                    "hsv_planar": FLAT_RECIPE_STEPS, "warp_quadrants": 0}
            for k, n in want.items():
                if got[k] != n:
                    fail(f"[flat] (b) {layout} launched {k} {got[k]} times in {FLAT_RECIPE_STEPS} steps, want {n}")
            width = rp.consumed_plan_log[-1].shape[1]
            if width != TRAIN_B:
                fail(f"[flat] (b) {layout}: {width} rows a step, want {TRAIN_B}")
            runs[layout] = dict(batches=batches, counts=got,
                                state={k: v.detach().clone() for k, v in t.net.state_dict().items()})
            out[f"b {layout}"] = got
            del t, rp
            gc.collect()
        for i, (a, b) in enumerate(zip(runs["flat"]["batches"], runs["planar"]["batches"], strict=True)):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail(f"[flat] (b) batch {i} of the flat corpus differs from the planar corpus's")
        if not all(torch.equal(runs["flat"]["state"][k], v) for k, v in runs["planar"]["state"].items()):
            fail("[flat] (b) the weights after the steps differ between the layouts")
        log(f"[flat] (b) repeat-factor sampler without mosaic, step loop, {FLAT_RECIPE_STEPS} steps of {TRAIN_B} rows: "
            f"batches (images, boxes, labels, mask) and weights bitwise equal; launches flat {runs['flat']['counts']}, "
            f"planar {runs['planar']['counts']} | {card}")
        del runs
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()

    # (c) the normal entry point with the flat layout
    made = []
    from_config = trainer_mod.Trainer.from_config.__func__

    def recording(cls, cfg, mesh=None):
        made.append(from_config(cls, cfg, mesh))
        return made[-1]

    trainer_mod.Trainer.from_config = classmethod(recording)
    try:
        with tempfile.TemporaryDirectory(prefix="flat-cli-") as tmp:
            _zero_kernels()
            t0 = time.perf_counter()
            cli_main(["hydra=static", "extras.enforce_tags=False", "print_config=False", "extras.print_config=False",
                      "logger=csv", f"paths.output_dir={tmp}", "experiment=yv5s", "data.pipeline=device",
                      "data.device_cache=True", "data.corpus_layout=flat", "dataset_name=fake",
                      f"data.fake_num_images={CLI_N}", "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=2"])
            wall = time.perf_counter() - t0
            got = _read_kernels()
    finally:
        trainer_mod.Trainer.from_config = classmethod(from_config)
    t = made[-1]
    steps = CLI_N // t.batch_size
    want = {"gather_rows_planar": 0, "gather_rows_flat": steps, "hsv_planar": steps, "warp_quadrants": steps,
            "greedy_nms_mask": 0}
    for k, n in want.items():
        if got[k] != n:
            fail(f"[flat] (c) cli.train launched {k} {got[k]} times, want {n}")
    losses = t.epoch_metrics[0]["total"]
    if t.pipeline.device_corpus.layout != "flat" or t._fused_fn is None or not np.isfinite(losses).all():
        fail(f"[flat] (c) not the flat corpus on the fused epoch, or losses not finite {losses}")
    log(f"[flat] (c) cli.train experiment=yv5s data.pipeline=device data.device_cache=True data.corpus_layout=flat "
        f"over {CLI_N} fake images, one epoch of {steps} steps (fused, a CUDA graph a step): launches {got}; losses "
        f"{losses[0]:.4f}->{losses[-1]:.4f}; {t.epoch_imgs[0] / t.epoch_walls[0]:.2f} img/s over its one epoch "
        f"(the capture included); whole command {wall:.2f} s | {card}")
    out["c"] = got
    del t, made, flat, view
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[flat] phase 18 {time.perf_counter() - t_phase:.2f} s | {card}")
    return out, (err, timing, calls)


# ------------------------------------------------------------ 19 carry
CARRY_N = 640  # phase 19: fake train and val images (10 steps an epoch at B=64)
CARRY_CFG = ["experiment=yv5s", "data.pipeline=device", "data.device_cache=True", "dataset_name=fake", "seed=0",
             f"data.fake_num_images={CARRY_N}", "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=2",
             "logger=csv", "hydra=static", "extras.enforce_tags=False", "print_config=False",
             "extras.print_config=False", "callbacks.model_summary=null"]


def phase_carry(card):
    """Phase 19: a run carried across the JAX package's layout and resumed
    on the main path (the module docstring). Returns each fit's launches."""
    import numpy as np

    from object_detection_cib_torch.config import compose
    from object_detection_cib_torch.models.convert import flax_state_to_torch, torch_to_flax_state
    from object_detection_cib_torch.train.checkpoint import load_state, save_state
    from object_detection_cib_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    counts, seconds = {}, {}

    def trainer(out: Path, *extra) -> Trainer:
        return Trainer.from_config(compose(root / "configs", "train", [*CARRY_CFG, f"paths.output_dir={out}",
                                                                         *extra]))

    def same(a: dict, b: dict) -> bool:
        return a.keys() == b.keys() and all(torch.equal(v, b[k]) for k, v in a.items())

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # two runs of the same steps bitwise equal
    try:
        with tempfile.TemporaryDirectory(prefix="carry-") as tmp:
            tmp = Path(tmp)
            # (a) one epoch from seed 0: the port's own checkpoint
            t0 = time.perf_counter()
            t = trainer(tmp / "a")
            spe = t.steps_per_epoch
            _zero_kernels()
            t.fit(max_epochs=1)
            torch.cuda.synchronize()
            counts["a"] = _read_kernels()
            seconds["a"] = time.perf_counter() - t0
            want = {"gather_rows_planar": spe, "hsv_planar": spe, "warp_quadrants": spe, "greedy_nms_mask": 0}
            if {k: counts["a"][k] for k in want} != want or t._fused_fn is None or t.optimizer.step_count != spe:
                fail(f"[carry] (a) not one fused epoch of {spe} steps: launches {counts['a']}, step "
                     f"{t.optimizer.step_count}")
            losses_a = t.epoch_metrics[0]["total"]
            first = t  # its live state is (d)'s reference
            own = tmp / "a" / "checkpoints" / "last"

            # (b) through the JAX layout, (c) back, written as the trainer writes
            t0 = time.perf_counter()
            saved = load_state(own)
            jax_layout = torch_to_flax_state(saved, len(t.classes))
            leaves = [v for tree in (jax_layout["params"], jax_layout["batch_stats"],
                                     jax_layout["opt_state"]["momentum_buf"]) for v in _leaves(tree)]
            if not all(isinstance(v, np.ndarray) for v in leaves) or jax_layout["step"].dtype != np.int32 \
                    or int(jax_layout["step"]) != spe:
                fail(f"[carry] (b) the JAX layout is not numpy arrays with an int32 step {spe}")
            back = flax_state_to_torch(jax_layout)
            converted = tmp / "b" / "checkpoints" / "last"
            converted.parent.mkdir(parents=True)
            save_state(converted, back)
            reread = load_state(converted)
            if not (same(reread["net"], saved["net"]) and same(reread["optimizer"]["momentum"],
                                                                  saved["optimizer"]["momentum"])
                    and reread["optimizer"]["step_count"] == saved["optimizer"]["step_count"]):
                fail("[carry] (c) the state back from the JAX layout differs from the port's own checkpoint")
            seconds["bc"] = time.perf_counter() - t0
            log(f"[carry] (a) one fused epoch of {spe} steps (yolov5s@416 B=64 bf16, {CARRY_N} fake images on the "
                f"card, seed 0, cudnn.deterministic): launches {counts['a']}; losses {losses_a[0]:.4f}->"
                f"{losses_a[-1]:.4f}; {seconds['a']:.2f} s with set-up | {card}")
            log(f"[carry] (b)+(c) the port's last -> torch_to_flax_state ({len(leaves)} numpy leaves: "
                f"{len(_leaves(jax_layout['params']))} params, {len(_leaves(jax_layout['batch_stats']))} batch stats, "
                f"{len(_leaves(jax_layout['opt_state']['momentum_buf']))} momentum; step int32 "
                f"{int(jax_layout['step'])}) -> flax_state_to_torch -> save_state: {len(back['net'])} tensors and "
                f"{len(back['optimizer']['momentum'])} momentum buffers bitwise the port's own file; "
                f"{seconds['bc']:.2f} s | {card}")
            del saved, jax_layout, back, reread

            # (d) a trainer resumed from the converted file through ckpt_path=
            t0 = time.perf_counter()
            t = trainer(tmp / "d", f"ckpt_path={converted}")
            start = (t.epoch, t.optimizer.step_count)
            if start != (1, spe):
                fail(f"[carry] (d) resumed at (epoch, step) {start}, want (1, {spe})")
            if not (same(t.net.state_dict(), first.net.state_dict())
                    and same(t.optimizer.buffers, first.optimizer.buffers)):
                fail("[carry] (d) the resumed trainer's state differs from (a)'s at the end of its epoch")
            n_state, n_mom = len(t.net.state_dict()), len(t.optimizer.buffers)
            del first
            gc.collect()  # the trainer's CUDA graphs sit in reference cycles
            torch.cuda.empty_cache()
            rows = []
            real = t.optimizer.hyper_table

            def spy(first_step, steps, device=None):
                table = real(first_step, steps)
                rows.append((first_step, table[0].tolist()))
                return table if device is None else table.to(device, non_blocking=True)

            t.optimizer.hyper_table = spy
            _zero_kernels()
            t1 = time.perf_counter()
            m = t.fit(max_epochs=2)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t1
            counts["d"] = _read_kernels()
            seconds["d"] = time.perf_counter() - t0
            blocks = -(-len(t.val_indices) // t.batch_size)
            want = {"gather_rows_planar": spe, "hsv_planar": spe, "warp_quadrants": spe, "greedy_nms_mask": blocks}
            hp10 = list(t.optimizer.hyperparams(spe))
            lr0 = float(t.epoch_metrics[0]["lr"][0])
            losses = t.epoch_metrics[0]["total"]
            if {k: counts["d"][k] for k in want} != want:
                fail(f"[carry] (d) launches {counts['d']}, want {want}")
            if not rows or rows[0] != (spe, hp10) or lr0 != hp10[1]:
                fail(f"[carry] (d) the first resumed step's hyperparameters {rows[:1]}, lr {lr0}; "
                     f"want step {spe} with {hp10}")
            if t._fused_fn is None or not t._fused_fn.graph or not np.isfinite(losses).all() or not finite_map(m):
                fail(f"[carry] (d) not the graphed fused epoch, or losses / mAP not finite: {losses}")
            replays = {k: g.replays for k, g in t._fused_fn.graphs.items()}
            log(f"[carry] (d) resumed from the converted checkpoint through ckpt_path=: epoch {start[0]}, step "
                f"{start[1]}; {n_state} parameters and statistics and {n_mom} momentum buffers bitwise (a)'s "
                f"trainer's at the end of its epoch; the first row of the epoch's hyperparameter table at step "
                f"{rows[0][0]}: (lr_bias, lr_other, momentum) {rows[0][1]} = hyperparams({spe}) (hyperparams(0) "
                f"would be {list(t.optimizer.hyperparams(0))}); launches {counts['d']} (graph replays {replays}); "
                f"losses {losses[0]:.4f}->{losses[-1]:.4f}; map {m.get('map', float('nan')):.6g}; fit {fit_s:.2f} "
                f"s, with set-up {seconds['d']:.2f} s | {card}")
            del t, spy
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[carry] phase 19 {time.perf_counter() - t_phase:.2f} s | {card}")
    return counts


# ------------------------------------------------------------ 20 sizes
SIZES_STEPS = 12  # phase 20: steps an epoch of each fused fit (fake train and val images: 12 x B)
SIZES_EPOCHS = 3  # phase 20: epochs of each fit, validated after the last (the device times epochs 2 and 3)
SIZES_CHUNK = 16  # phase 20 (c): groups a call of a plain version takes, beside l's trainer on the card
# phase 20: run -> (overrides of the default network, image size, batch, remat policy). m and l at the
# JAX bench's size_m and size_l shapes (bench.py:431-447); l at 640 and B=128 under the policy measured
# to fit one card (tools/remat_peaks.py, PERF.md), l at the yv5s recipe's 416 and B=64 without remat
SIZES_RUNS = {
    "m": (("model.net.deepen_factor=0.67", "model.net.widen_factor=0.75"), 640, 96, None),
    "l": ((), 640, 128, "conv_out_bn_stats"),
    "l416": ((), 416, 64, None),
}
SIZES_PARAMS = {"m": 20_907_687, "l": 46_186_759}  # nc=10, tests/test_torch_sizes.py holds them to JAX's
SIZES_SERVE_B, SIZES_SERVE_STEPS = 32, 60  # (c) serving yolov5l at 640: a window of steps
SIZES_EQ_B, SIZES_EQ_STEPS = 16, 5  # (d) the graphed fused steps against the eager ones
SIZES_GAP_B = 16  # (d) the first bf16 step against the card's own f32 step
# (d) each loss of the first bf16 step within 5% of the f32 step's: bf16 keeps 8 significant bits (one
# rounding <= 2**-9 = 0.2%); the forward rounds each of its ~100-150 layers' outputs once, the errors of
# a layer's elements are near independent and the losses are means over the batch, the cells and the
# targets, so their gap stays a small multiple of one rounding; 5% is 25 roundings, and the gap must be
# above 0, so the step did round to bf16
BF16_LOSS_RTOL = 0.05
SIZES_CFG = ["dataset_name=fake", "data.pipeline=device", "data.device_cache=True", "seed=0",
             f"trainer.max_epochs={SIZES_EPOCHS}", f"trainer.check_val_every_n_epoch={SIZES_EPOCHS}", "logger=csv",
             "hydra=static",
             "extras.enforce_tags=False", "print_config=False", "extras.print_config=False",
             "callbacks.model_summary=null"]


def _sizes_overrides(run: str, steps: int = SIZES_STEPS, batch=None) -> list:
    """The overrides of phase 20's ``run`` at ``steps`` steps an epoch of
    ``batch`` (the run's own by default)."""
    net, S, B, policy = SIZES_RUNS[run]
    B = batch or B
    return [*SIZES_CFG, *net, f"data.target_image_size={S}", f"data.batch_size={B}",
            f"data.fake_num_images={steps * B}", f"model.remat_policy={'null' if policy is None else policy}"]


def _free_card():
    gc.collect()  # a trainer's CUDA graphs sit in reference cycles
    torch.cuda.empty_cache()


def phase_sizes(card, dev):
    """Phase 20: yolov5m and yolov5l, the default network, trained, validated
    and served at full width (the module docstring). Returns each part's
    launches."""
    import numpy as np

    from object_detection_cib_torch.cli.train import main as cli_main
    from object_detection_cib_torch.config import compose
    from object_detection_cib_torch.core.nms import select_candidates
    from object_detection_cib_torch.core.types import default_anchors
    from object_detection_cib_torch.data.device_pipeline import draw_augment
    from object_detection_cib_torch.data.host_augment import AugParams
    from object_detection_cib_torch.eval.decode import decode_predictions
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.ops import augment as aug_ops
    from object_detection_cib_torch.ops import gather as gather_ops
    from object_detection_cib_torch.ops import hsv as hsv_ops
    from object_detection_cib_torch.ops import nms as nms_ops
    from object_detection_cib_torch.ops import warp as warp_ops
    from object_detection_cib_torch.train import trainer as trainer_mod
    from object_detection_cib_torch.train.steps import make_eval_step

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    counts = {}
    made = []  # the Trainer of each cli.train run, to look inside
    from_config = trainer_mod.Trainer.from_config.__func__

    def recording(cls, cfg, mesh=None):
        made.append(from_config(cls, cfg, mesh))
        return made[-1]

    def built(overrides):  # not recorded: the trainer dies with its caller
        return from_config(trainer_mod.Trainer, compose(root / "configs", "train", overrides))

    def fit(run: str, tmp: Path, via_cli: bool):
        """One fused fit of ``SIZES_EPOCHS`` epochs with one validation:
        checks, prints and returns the trainer."""
        _, S, B, policy = SIZES_RUNS[run]
        overrides = [*_sizes_overrides(run), f"paths.output_dir={tmp / run}"]
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_kernels()
        t0 = time.perf_counter()
        if via_cli:
            m = cli_main(overrides)
            t = made.pop()
        else:
            t = built(overrides)
            m = t.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[run] = got = _read_kernels()
        peak = torch.cuda.max_memory_allocated()
        steps, blocks = SIZES_STEPS, -(-len(t.val_indices) // t.batch_size)
        n = SIZES_EPOCHS * steps
        want = {"gather_rows_planar": n, "hsv_planar": n, "warp_quadrants": n, "greedy_nms_mask": blocks,
                "gather_rows_flat": 0}
        if {k: got[k] for k in want} != want:
            fail(f"[sizes] {run}: launches {got}, want {want}")
        size = "m" if run == "m" else "l"
        n_params = sum(p.numel() for p in t.net.parameters())
        if n_params != SIZES_PARAMS[size] or t.steps_per_epoch != steps or t.batch_size != B:
            fail(f"[sizes] {run}: {n_params} parameters (want yolov5{size}'s {SIZES_PARAMS[size]}), "
                 f"{t.steps_per_epoch} steps of {t.batch_size}")
        losses = np.concatenate([em["total"] for em in t.epoch_metrics])
        if t._fused_fn is None or not t._fused_fn.graph or len(losses) != n \
                or not np.isfinite(losses).all() or not finite_map(m):
            fail(f"[sizes] {run}: not the graphed fused epoch, or losses / mAP not finite: {losses}, {m}")
        # the fit's windows hold its set-up (cuDNN's first calls at these
        # shapes, two eager steps, the capture) in the first epoch's; the
        # device's epoch walls (between the epochs' last stage stamps)
        # time epochs 2 and 3 alone. The host windows of those two
        # do not: the host enqueues an epoch ahead and each replay waits for
        # room in the card's queue, so the windows shift by about an epoch
        ips = sum(t.epoch_imgs) / sum(t.epoch_walls)
        walls = t.device_epoch_walls()
        ips_device = sum(t.epoch_imgs[e] for e in walls) / sum(walls.values()) if walls else math.nan
        corpus = t.pipeline.corpus
        replays = {k: g.replays for k, g in t._fused_fn.graphs.items()}
        log(f"[sizes] ({run}) yolov5{size} ({n_params} parameters, nc={len(t.classes)}) at {S} B={B} bf16, remat "
            f"{policy}, {'cli.train.main, no experiment=' if via_cli else 'Trainer.from_config'}: fused fit of "
            f"{SIZES_EPOCHS} epochs of {steps} steps, {ips:.2f} img/s over the fit's epoch windows summed (host "
            f"clock, fetch to fetch, the set-up in the first: {[round(w, 4) for w in t.epoch_walls]} s); "
            f"{ips_device:.2f} img/s over the device's walls of epochs 2-{SIZES_EPOCHS} (stage stamps: "
            f"{ {e + 1: round(w, 4) for e, w in walls.items()} } s); peak "
            f"{peak / 2**30:.3f} GiB (max_memory_allocated, {held / 2**30:.3f} GiB of it held before the run "
            f"began; corpus {corpus.numel() / 2**30:.3f} GiB and val cache on the card); launches {got} (graph replays {replays}); losses {losses[0]:.4f}->"
            f"{losses[-1]:.4f}; whole {'command' if via_cli else 'fit with set-up'} {wall:.2f} s | {card}")
        log(f"[sizes] ({run}) validation of {len(t.val_indices)} images " + json.dumps(m))
        return t, dict(img_s_fit=ips, img_s_device=ips_device, peak_gib=peak / 2**30, policy=policy, launches=got)

    def chunked(plain, *args):
        """``plain`` over ``SIZES_CHUNK`` groups a call (its f32 temporaries
        at B=128 and 640 px do not fit beside l's trainer), concatenated."""
        return torch.cat([plain(*(a[i:i + SIZES_CHUNK] for a in args))
                          for i in range(0, args[0].shape[0], SIZES_CHUNK)])

    def hold_kernels(t):
        """K2, K5 and K4 on a step of ``t``'s pipeline, each one call at its
        shapes held bitwise against its plain version."""
        pipe, S, B = t.pipeline, t.image_shape.width, t.batch_size
        corpus = pipe.corpus
        idx = torch.from_numpy(pipe._epoch_plan()[0][0].astype(np.int32)).to(dev)
        errs = [check_equal(f"[sizes] gather_rows_planar {tuple(corpus.shape)}[{idx.numel()}]",
                            gather_ops.gather_rows_planar(corpus, idx), gather_ops.gather_rows_plain(corpus, idx))]
        draws = draw_augment(torch.Generator(device=dev).manual_seed(7), B, S, AugParams())
        sample = pipe.gather(idx)
        placement = aug_ops._mosaic_placement(sample.sizes.reshape(B, 4, 2), draws.centers, S)
        M = aug_ops._affine_matrices(draws.values, 2 * S, 2 * S, S, S)
        taps = aug_ops.mosaic_warp_taps(M, placement, S, draws.flip)
        imgs = sample.images.reshape(B, 4, 3, S, S)
        warped = warp_ops.warp_quadrants(imgs, *taps, out_dtype=torch.bfloat16)
        errs.append(check_equal(
            f"[sizes] warp_quadrants real draw {tuple(imgs.shape)} -> bf16", warped,
            chunked(lambda *a: warp_ops.warp_quadrants_plain(*a, out_dtype=torch.bfloat16), imgs, *taps)))
        errs.append(check_equal(f"[sizes] hsv_planar real warp output {tuple(warped.shape)} bf16",
                                hsv_ops.hsv_planar(warped, draws.hsv_r),
                                chunked(hsv_ops.hsv_planar_plain, warped, draws.hsv_r)))
        return max(errs)

    def graphed_vs_eager(run: str, tmp: Path):
        """(d) ``SIZES_EQ_STEPS`` fused steps at ``SIZES_EQ_B``, eager and
        graphed, from the same weights and seed: the state and the losses
        after them bitwise equal; K2/K4/K5 once a step in the graphed run."""
        def one(graph):
            _free_card()
            t = built([*_sizes_overrides(run, SIZES_EQ_STEPS, SIZES_EQ_B), f"paths.output_dir={tmp / 'eq'}"])
            fn = t.pipeline.build_fused_epoch_fn(lambda b, hp: t.train_step(b, hp), pipelined=True,
                                                 stack_metrics=True, graph=graph)
            _zero_kernels()
            flat = fn(t.pipeline.epoch_host_arrays(), t.optimizer.hyper_table(0, SIZES_EQ_STEPS))
            torch.cuda.synchronize()
            got = _read_kernels()
            state = [v.detach().cpu().clone() for v in
                     list(t.net.state_dict().values()) + list(t.optimizer.buffers.values())]
            if fn.graph != graph:
                fail(f"[sizes] (d) {run}: asked graph={graph}, the fused epoch ran graph={fn.graph}")
            return state, flat.cpu(), got

        eager, graphed = one(False), one(True)
        want = {"gather_rows_planar": SIZES_EQ_STEPS, "hsv_planar": SIZES_EQ_STEPS, "warp_quadrants": SIZES_EQ_STEPS}
        if {k: graphed[2][k] for k in want} != want:
            fail(f"[sizes] (d) {run}: graphed launches {graphed[2]}, want {want}")
        same = torch.equal(graphed[1], eager[1]) and all(torch.equal(a, b) for a, b in zip(graphed[0], eager[0]))
        if not same:
            err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(graphed[0], eager[0]))
            again = one(False)
            spread = max(float((a.double() - b.double()).abs().max()) for a, b in zip(again[0], eager[0]))
            fail(f"[sizes] (d) {run}: the graphed fused steps differ from the eager ones by {err} (two eager runs "
                 f"by {spread})")
        log(f"[sizes] (d) {run} at {SIZES_RUNS[run][1]} B={SIZES_EQ_B}, remat {SIZES_RUNS[run][3]}, "
            f"cudnn.deterministic: {SIZES_EQ_STEPS} fused steps graphed (2 eager warm-up steps, then replays) "
            f"bitwise_equal=True to the eager ones ({len(eager[0])} parameters, statistics and momentum buffers, "
            f"the losses {eager[1][0].tolist()}); graphed launches {graphed[2]} | {card}")

    def bf16_gap(run: str, tmp: Path) -> float:
        """(d) the first bf16 step's losses against the card's own f32 step
        from the same weights on the same batch (module constants)."""
        _free_card()
        base = [*_sizes_overrides(run, 2, SIZES_GAP_B), "data.fused_epoch=False", f"paths.output_dir={tmp / 'gap'}"]
        t16, t32 = built(base), built([*base, "model.net.dtype=null"])
        if t16.net.dtype != torch.bfloat16 or t32.net.dtype is not None:
            fail(f"[sizes] (d) {run}: compute dtypes {t16.net.dtype} and {t32.net.dtype}")
        if not all(torch.equal(a, b) for a, b in zip(t16.net.state_dict().values(), t32.net.state_dict().values())):
            fail(f"[sizes] (d) {run}: the bf16 and f32 trainers start from other weights")
        (b16, _), (b32, _) = next(iter(t16.pipeline.epoch(1))), next(iter(t32.pipeline.epoch(1)))
        if not (torch.equal(b16.images, b32.images.to(torch.bfloat16)) and torch.equal(b16.boxes, b32.boxes)
                and torch.equal(b16.labels, b32.labels) and torch.equal(b16.mask, b32.mask)):
            fail(f"[sizes] (d) {run}: the two trainers' first batches differ beyond the feed's bf16 rounding")
        m16, m32 = t16.train_step(b16), t32.train_step(b32)
        gaps = {}
        for k in ("total", "box", "obj", "cls"):
            a, b = float(getattr(m16, k)), float(getattr(m32, k))
            gaps[k] = (a, b, abs(a - b) / abs(b))
        worst = max(g for _, _, g in gaps.values())
        ok = worst <= BF16_LOSS_RTOL and gaps["total"][2] > 0
        log(f"[sizes] (d) {run} at {SIZES_RUNS[run][1]} B={SIZES_GAP_B}, the first step (step loop) in bf16 against "
            f"the card's own f32 step, same weights, same batch (the f32 feed's images rounded to bf16 in the bf16 "
            f"feed): (bf16, f32, relative gap) " + ", ".join(f"{k} ({a:.6f}, {b:.6f}, {g:.3e})" for k, (a, b, g) in
                                                              gaps.items())
            + f"; worst {worst:.3e}, tolerance {BF16_LOSS_RTOL} and above 0: {ok} | {card}")
        if not ok:
            fail(f"[sizes] (d) {run}: bf16 against f32 gaps {gaps}, tolerance {BF16_LOSS_RTOL} and above 0")
        return worst

    res = {}
    trainer_mod.Trainer.from_config = classmethod(recording)
    try:
        with tempfile.TemporaryDirectory(prefix="sizes-") as tmp:
            tmp = Path(tmp)
            # (a) yolov5m at 640, B=96
            t, res["m"] = fit("m", tmp, via_cli=False)
            del t
            # (b) yolov5l, the default network, at 640, B=128 and at 416, B=64
            t, res["l"] = fit("l", tmp, via_cli=True)
            # (c) one more validation of l over its 640 val cache, then K2/K5/K4 at its shapes
            _zero_kernels()
            t0 = time.perf_counter()
            m = t.validate()
            torch.cuda.synchronize()
            val_s = time.perf_counter() - t0
            counts["l validate"] = got = _read_kernels()
            blocks = -(-len(t.val_indices) // t.batch_size)
            if got["greedy_nms_mask"] != blocks or got["gather_rows_planar"] or not finite_map(m):
                fail(f"[sizes] (c) validate: launches {got}, want K1 {blocks} and no training kernel; map {m}")
            log(f"[sizes] (c) Evaluator.validate of yolov5l over {len(t.val_indices)} images at {t.image_shape.width} "
                f"B={t.batch_size} "
                f"on the card: {val_s:.3f} s ({len(t.val_indices) / val_s:.1f} img/s incl. host mAP), launches "
                f"{got} | {card}")
            res["kernels_max_abs_err"] = hold_kernels(t)
            del t
            t, res["l416"] = fit("l416", tmp, via_cli=True)
            del t
            _free_card()

            # (c) serving yolov5l at 640, B=32 through make_eval_step
            anchors = default_anchors()
            net = build_network(NC, "l", dtype=torch.bfloat16, device=dev, seed=0).eval()
            images = torch.rand(SIZES_SERVE_B, 640, 640, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
            with torch.inference_mode():
                cand = select_candidates(decode_predictions(net(images), anchors), CONF, max_nms=MAX_NMS)
            res["kernels_max_abs_err"] = max(res["kernels_max_abs_err"], check_equal(
                f"[sizes] greedy_nms_mask yolov5l@640 B={SIZES_SERVE_B} K={cand.live.shape[1]}",
                nms_ops.greedy_nms_mask(cand.offset_boxes, cand.live, IOU),
                nms_ops.greedy_nms_mask_plain(cand.offset_boxes, cand.live, IOU)))
            del cand
            estep = make_eval_step(net, anchors, conf_thres=CONF, iou_thres=IOU, max_det=MAX_DET, max_nms=MAX_NMS)
            for _ in range(2):
                estep(images)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_kernels()
            t0 = time.perf_counter()
            for _ in range(SIZES_SERVE_STEPS):
                out = estep(images)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            counts["l serving"] = got = _read_kernels()
            if got["greedy_nms_mask"] != SIZES_SERVE_STEPS or got["gather_rows_planar"]:
                fail(f"[sizes] (c) serving: launches {got}, want K1 {SIZES_SERVE_STEPS} and no training kernel")
            if tuple(out.boxes.shape) != (SIZES_SERVE_B, MAX_DET, 4) or not torch.isfinite(out.boxes).all() \
                    or not (out.num_valid > 0).all():
                fail(f"[sizes] (c) serving result: boxes {tuple(out.boxes.shape)}, detections {out.num_valid.tolist()}")
            res["serve_img_s"] = SIZES_SERVE_B * SIZES_SERVE_STEPS / serve_s
            log(f"[sizes] (c) serving yolov5l nc={NC} 640x640 B={SIZES_SERVE_B} bf16 through make_eval_step: "
                f"{SIZES_SERVE_STEPS} steps in {serve_s:.4f} s = {res['serve_img_s']:.2f} img/s; launches {got} "
                f"(K1 once a step); peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; detections per image "
                f"{out.num_valid.min().item()}..{out.num_valid.max().item()} | {card}")
            del net, estep, out, images
            _free_card()

            # (d) correctness at m and l on the card
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True  # two runs of the same steps bitwise equal
            try:
                for run in ("m", "l"):
                    graphed_vs_eager(run, tmp)
            finally:
                torch.backends.cudnn.deterministic = deterministic
            res["bf16_gap"] = {run: bf16_gap(run, tmp) for run in ("m", "l")}
            _free_card()
    finally:
        trainer_mod.Trainer.from_config = classmethod(from_config)
    log(f"[sizes] summary: " + json.dumps({k: v for k, v in res.items()}) + f" | {card}")
    log(f"[sizes] phase 20 {time.perf_counter() - t_phase:.2f} s | {card}")
    return counts


def _leaves(tree: dict) -> list:
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _ddp_flat_rank(mesh):
    """Phase 13 (d), one NCCL rank: the sharded corpus in each layout, the
    step loop's batches for ``FLAT_DDP_STEPS`` steps under mixup 0.5 (two
    exchanges a step) at a global B=64."""
    from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline
    from object_detection_cib_torch.data.host_augment import AugParams

    _ddp_card()
    train_info, _ = _ddp_infos(DDP_N, TRAIN_B)
    res, batches = {}, {}
    for layout in ("planar", "flat"):
        pipe = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, AugParams(), max_targets=MAX_TARGETS, seed=0,
                                  mixup_prob=0.5, device=mesh.device, mesh=mesh, corpus_sharding="sharded",
                                  corpus_layout=layout)
        _zero_kernels()
        batches[layout] = [tuple(x.clone() for x in b) for b, _ in pipe.epoch(FLAT_DDP_STEPS)]
        torch.cuda.synchronize()
        res[layout] = dict(counts=_read_kernels(), held=tuple(pipe.corpus.shape))
        del pipe
    res["equal"] = all(torch.equal(x, y) for a, b in zip(batches["flat"], batches["planar"], strict=True)
                       for x, y in zip(a, b))
    return res


def ddp_flat(card, n: int) -> dict:
    """Phase 13 (d): ``n`` NCCL ranks over the sharded corpus in each
    layout (``_ddp_flat_rank``); fails unless every rank's batches are
    bitwise equal and each gather ran twice a step in its own layout and
    never in the other. Returns the flat runs' launches summed over the
    ranks."""
    flat = launch_logged("ddp", _ddp_flat_rank, n, timeout_s=300, join_timeout_s=600)
    per = -(-DDP_N // n)
    for r, res in enumerate(flat):
        if not res["equal"]:
            fail(f"[ddp] (d) rank {r}: the flat sharded corpus's batches differ from the planar one's")
        for layout, gather in (("planar", "gather_rows_planar"), ("flat", "gather_rows_flat")):
            other = "gather_rows_flat" if layout == "planar" else "gather_rows_planar"
            got = res[layout]["counts"]
            if got[gather] != 2 * FLAT_DDP_STEPS or got[other]:
                fail(f"[ddp] (d) rank {r} {layout}: launches {got}, want {gather} {2 * FLAT_DDP_STEPS}, {other} 0")
        if res["flat"]["held"] != (per, TRAIN_S, TRAIN_S, 3) or res["planar"]["held"] != (per, 3, TRAIN_S, TRAIN_S):
            fail(f"[ddp] (d) rank {r} holds {res['flat']['held']} (flat), {res['planar']['held']} (planar)")
    log(f"[ddp] (d) launch({n} ranks, NCCL) sharded corpus of {DDP_N} images at {per} rows a rank, flat "
        f"{flat[0]['flat']['held']} against planar {flat[0]['planar']['held']}: {FLAT_DDP_STEPS} steps of the step "
        f"loop under mixup 0.5 at a global B={TRAIN_B}, every rank's batches bitwise equal; launches rank 0 flat "
        f"{flat[0]['flat']['counts']}, planar {flat[0]['planar']['counts']} | {card}")
    return {k: sum(res["flat"]["counts"][k] for res in flat) for k in flat[0]["flat"]["counts"]}


def launch_logged(tag: str, *args, **kw):
    """``parallel.distributed.launch``, its warnings (a rank terminated
    after handing back its result) printed under ``[tag]``."""
    import warnings

    from object_detection_cib_torch.parallel import distributed

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = distributed.launch(*args, **kw)
    for w in caught:
        log(f"[{tag}] launcher warning: {w.message}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="root of another checkout whose four kernel sources are timed beside")
    ap.add_argument("--phase", choices=["all", "ddp", "hosts", "rest", "spatial", "jpeg", "flat", "carry", "sizes",
                                        "bn_silu"],
                    default="all",
                    help="bn_silu: phases 1, 2, 7's BatchNorm + SiLU and a fused fit (the training BatchNorm "
                         "kernels); sizes: phases 1, 2 and 20 alone (yolov5m and yolov5l at full width); "
                         "carry: phases 1, 2 and 19 alone (a run carried across the JAX layout); "
                         "flat: phases 1, 2 and 18 alone (the flat corpus, over a planar corpus built for it); "
                         "jpeg: phases 1, 2, the letterbox kernel of 7, 10 and 17 alone (the JPEG feeds); "
                         "ddp: phases 1, 2 and 13 alone (data parallelism; (c) needs two or more cards); "
                         "hosts: phases 1, 2 and 14 alone (several hosts; (b) needs four cards); "
                         "rest: phases 1, 2 and 15 alone; spatial: phases 1, 2 and 16 alone (DP x SP; (b) needs "
                         "two cards, (c) four)")
    ap.add_argument("--hosts-child", nargs=2, metavar=("KIND", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    # ---------------------------------------------------------------- 1 device
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    root = Path(__file__).resolve().parent
    if not (root / "object_detection_cib_torch").is_dir():
        fail(f"object_detection_cib_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(root))
    if args.hosts_child:  # a host of phase 14, started by phase_hosts
        hosts_child(args.hosts_child[0], Path(args.hosts_child[1]))
        return

    import numpy as np

    from object_detection_cib_torch.core.nms import non_max_suppression, select_candidates
    from object_detection_cib_torch.core.types import FeatureShape, default_anchors
    from object_detection_cib_torch.data.device_pipeline import (
        DeviceDataPipeline,
        augment_group,
        draw_augment,
    )
    from object_detection_cib_torch.data.host_augment import AugParams, HSVParams
    from object_detection_cib_torch.data.samplers import ClassAwareSampler, RepeatFactorSampler
    from object_detection_cib_torch.data.synthetic import build_fake_manifest
    from object_detection_cib_torch.data.val_cache import ValDeviceCache
    from object_detection_cib_torch.eval.decode import decode_predictions
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.ops import augment as aug_ops
    from object_detection_cib_torch.ops import gather as gather_ops
    from object_detection_cib_torch.ops import hsv as hsv_ops
    from object_detection_cib_torch.ops import nms as nms_ops
    from object_detection_cib_torch.ops import warp as warp_ops
    from object_detection_cib_torch.ops.build import REPORTS, build_all, kernel_usage
    from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
    from object_detection_cib_torch.train.steps import make_eval_step, make_train_step
    from object_detection_cib_torch.train.trainer import Evaluator, Trainer, plan_instance_counts

    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda")
    anchors = default_anchors()

    # ----------------------------------------------------------------- 2 build
    t0 = time.perf_counter()
    libs = build_all(verbose=True)
    log(f"[build] setup: nvcc {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    baselines = {}  # checkout dir -> {source: library}
    for b in args.baseline:
        t0 = time.perf_counter()
        built = build_all(["gather", "hsv", "nms", "warp"],
                          csrc=b / "object_detection_cib_torch" / "ops" / "csrc")
        baselines[b] = {n: ctypes.CDLL(str(p)) for n, p in built.items()}
        log(f"[build] baseline {b}: {', '.join(built)} in {time.perf_counter() - t0:.2f} s")
    usage = {}  # kernel entry -> (registers per thread, static shared bytes), from ptxas
    for report in REPORTS.values():
        usage.update(kernel_usage(report))

    def resources(entry_part: str, dynamic: int) -> str:
        found = [(e, u) for e, u in usage.items() if entry_part in e]
        if not found:
            return f"registers not reported, shared memory {dynamic} B dynamic per block"
        return "; ".join(f"{e}: {r} registers per thread, {st + dynamic} B shared memory per block "
                         f"({st} static + {dynamic} dynamic)" for e, (r, st) in found)

    if args.phase == "jpeg":
        lb_err, lb_timing, _ = phase_letterbox(card, dev, resources)
        jpeg = phase_jpeg(card, dev, AugParams(), _kernel_entries(), _zero_kernels, _read_kernels)
        corpus_counts = phase_corpus(card, _zero_kernels, _read_kernels)
        print(json.dumps({"letterbox": {"max_abs_err": lb_err, "timing": lb_timing},
                          "jpeg_launches": jpeg, "corpus_launches": corpus_counts}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.phase == "bn_silu":
        err, bs_timing, bs_calls = phase_bn_silu(card, dev, resources)
        launches = bn_silu_fit(card, dev)
        print(json.dumps({"kernels": [kernel_entry(
            "bn_silu_train", "bn_silu.cu", "models/layers.py BatchNorm + SiLU (the port's own kernels; no pallas_call)",
            launches["bn_silu_train"], err, bs_timing, bs_calls, {"fused": launches["bn_silu_train"]})]}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.phase == "sizes":
        print(json.dumps({"sizes_launches": phase_sizes(card, dev)}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.phase == "carry":
        print(json.dumps({"carry_launches": phase_carry(card)}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.phase == "flat":
        from object_detection_cib_torch.data.device_pipeline import DeviceCorpus

        train_info = build_fake_manifest(num_classes=NC, num_images=TRAIN_N, seed=0, zipf_a=1.01)
        info = build_fake_manifest(num_classes=NC, num_images=VAL_N, image_size=VAL_S, zipf_a=1.01, seed=0)
        flat, (err, k3_timing, k3_calls) = phase_flat(card, dev, AugParams(), train_info, info,
                                                      DeviceCorpus.fake(train_info, TRAIN_S, dev))
        print(json.dumps({"flat_launches": flat, "gather_rows_flat": {
            "max_abs_err": err, "ms": k3_timing[0], "plain_ms": k3_timing[1], "library_ms": k3_timing[2],
            "bound_ms": k3_timing[3], "bound_by": k3_timing[4], "call_ms": k3_calls[0],
            "library_call_ms": k3_calls[1]}}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.phase == "spatial":
        spatial = phase_spatial(card)
        print(json.dumps({"spatial_launches": spatial}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.phase == "rest":
        rest = phase_rest(card)
        print(json.dumps({"rest_launches": rest}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.phase == "hosts":
        hosts = phase_hosts(card)
        print(json.dumps({"hosts_launches": hosts}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.phase == "ddp":
        ddp = phase_ddp(card)
        print(json.dumps({"ddp_launches": ddp}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return

    # -------------------------------------------------- 3 kernels vs plain
    def rand_case(K, n_real, seed, span, wh):
        g = torch.Generator().manual_seed(seed)
        boxes = torch.zeros(1, K, 4)
        xy = torch.rand(n_real, 2, generator=g) * span
        sz = wh[0] + torch.rand(n_real, 2, generator=g) * (wh[1] - wh[0])
        boxes[0, :n_real] = torch.cat([xy, xy + sz], -1)
        live = torch.zeros(1, K, dtype=torch.bool)
        live[0, :n_real] = True
        return boxes.to(dev), live.to(dev)

    chain = torch.zeros(1, 256, 4)
    chain[0, :3] = torch.tensor([[0, 0, 10, 10], [3, 0, 13, 10], [6, 0, 16, 10]], dtype=torch.float32)
    chain_live = torch.zeros(1, 256, dtype=torch.bool)
    chain_live[0, :3] = True

    net = build_network(NC, "s", dtype=torch.bfloat16, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand(SERVE_B, SERVE_S, SERVE_S, 3, device=dev, generator=g)
    with torch.inference_mode():
        det = decode_predictions(net.eval()(images), anchors)
        cand = select_candidates(det, CONF, max_nms=MAX_NMS)
    n_pass = (cand.live.sum(dim=1)).tolist()
    log(f"[kernels] yolov5s@640 candidates past conf {CONF}: min {min(n_pass)} max {max(n_pass)} "
        f"of K={cand.live.shape[1]} (detections per image {det.shape[1] * NC})")

    def batch_case(B, K, seed):
        """Random boxes of three classes (offset 4096 apart), ~90% live."""
        g = torch.Generator().manual_seed(seed)
        xy = torch.rand(B, K, 2, generator=g) * 300.0
        sz = 5.0 + torch.rand(B, K, 2, generator=g) * 85.0
        cls = torch.randint(0, 3, (B, K, 1), generator=g).float() * 4096.0
        live = torch.rand(B, K, generator=g) > 0.1
        return (torch.cat([xy, xy + sz], -1) + cls).to(dev), live.to(dev)

    # image 0: no live box; image 1: disjoint boxes, all kept; image 2: equal
    # boxes, box 0 suppresses all others
    edge = torch.zeros(3, 300, 4)
    edge[:2, :, 0] = torch.arange(300.0) * 20.0
    edge[:2, :, 2] = edge[:2, :, 0] + 10.0
    edge[:2, :, 3] = 10.0
    edge[2] = torch.tensor([0.0, 0.0, 100.0, 100.0])
    edge_live = torch.ones(3, 300, dtype=torch.bool)
    edge_live[0] = False

    cases = {
        "chain K=256": (chain.to(dev), chain_live.to(dev), 0.45),
        "random K=256": (*rand_case(256, 200, 0, 200, (10, 80)), 0.45),
        "random K=2048 900 live": (*rand_case(2048, 900, 5, 400, (10, 90)), 0.5),
        "random K=1000 ragged": (*rand_case(1000, 700, 6, 300, (10, 80)), 0.45),
        "random K=64 (one word)": (*batch_case(2, 64, 7), 0.45),
        "random K=65 (one word and one box)": (*batch_case(2, 65, 8), 0.45),
        "random B=64 K=2048 (the validation batch)": (*batch_case(VAL_B, 2048, 9), IOU),
        "none live / all kept / box 0 suppresses all, K=300": (edge.to(dev), edge_live.to(dev), 0.5),
        "yolov5s@640 B=1 K=2048": (cand.offset_boxes[:1], cand.live[:1], IOU),
        "yolov5s@640 B=32 K=2048": (cand.offset_boxes, cand.live, IOU),
    }
    max_err = 0
    for name, (boxes, live, thr) in cases.items():
        got = nms_ops.greedy_nms_mask(boxes, live, thr)
        torch.cuda.synchronize()
        want = nms_ops.greedy_nms_mask_plain(boxes, live, thr)
        err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
        max_err = max(max_err, err)
        log(f"[kernels] greedy_nms_mask {name}: kept {int(got.sum())}/{int(live.sum())} "
            f"bitwise_equal={torch.equal(got, want)}")
        if not torch.equal(got, want):
            fail(f"greedy_nms_mask disagrees with its plain version on {name}")
        if name.startswith("chain") and got[0, :3].tolist() != [True, False, True]:
            fail("chain case: greedy NMS must keep {A, C}")
        if name.startswith("none live") and (
                got[0].any() or not got[1].all() or got[2].nonzero().flatten().tolist() != [0]):
            fail("edge cases: want nothing kept, everything kept, only box 0 kept")
        del want

    boxes, live, thr = cases["yolov5s@640 B=32 K=2048"]
    keep = nms_ops.greedy_nms_mask(boxes, live, thr)
    nms_ms, plain_ms, turns = in_turns(lambda: nms_ops.greedy_nms_mask(boxes, live, thr),
                                       lambda: nms_ops.greedy_nms_mask_plain(boxes, live, thr), 30, 5)
    B, K = live.shape
    nms_bytes = B * K * (16 + 1 + 1)  # boxes f32x4 + live u8 in, keep u8 out
    pairs = nms_pairs_needed(keep, live)
    bound_ms, bound_by = bound(nms_bytes, pairs * NMS_OPS_PER_PAIR)
    log(f"[kernels] greedy_nms_mask B={B} K={K}: kernel {nms_ms:.4f} ms (turns {turns['kernel']}), "
        f"plain {plain_ms:.4f} ms (turns {turns['plain']}) | {card}")
    _, sweeps = nms_ops.greedy_nms_mask_plain(boxes, live, thr, with_sweeps=True)
    kept_n = keep.sum(dim=1)
    log(f"[kernels] bound: {nms_bytes} B at 3.35 TB/s, {pairs} pair tests x {NMS_OPS_PER_PAIR} ops "
        f"at 67 TFLOP/s -> {bound_ms:.6f} ms ({bound_by}); dependency depth: the plain version "
        f"reaches its fixpoint in {sweeps} sweeps; kept per image min {int(kept_n.min())} max "
        f"{int(kept_n.max())} of {int(live.sum(dim=1).min())}..{int(live.sum(dim=1).max())} live")
    call_ms = {"greedy_nms_mask": (cuda_ms(lambda: nms_ops.greedy_nms_mask(boxes, live, thr), 30), None)}
    log(f"[kernels] greedy_nms_mask one call from an idle stream, host launch path included (median "
        f"of 30): {call_ms['greedy_nms_mask'][0]:.4f} ms | {card}")
    one_ms, one_plain_ms, turns = in_turns(
        lambda: nms_ops.greedy_nms_mask(boxes[:1], live[:1], thr),
        lambda: nms_ops.greedy_nms_mask_plain(boxes[:1], live[:1], thr), 30, 5)
    log(f"[kernels] greedy_nms_mask B=1 K={K} (the batch's first image alone), in a row: kernel "
        f"{one_ms:.4f} ms, plain {one_plain_ms:.4f} ms (turns {turns}) | {card}")
    log(f"[kernels] nms.cu at K={K}: {resources('pair_kernel', 0)}; "
        f"{resources('scan_kernel', nms_ops.scan_smem_bytes(K))}")

    def nms_direct(lib, bx, lv):
        """A checkout's nms.cu called straight through ctypes, by the
        interface it has: (call, keep buffer)."""
        nb, nk = lv.shape
        out = torch.zeros_like(lv)
        fn = lib.odcib_greedy_nms_mask
        args = [bx.data_ptr(), lv.data_ptr(), out.data_ptr()]
        types = [ctypes.c_void_p] * 3
        ws = None
        if hasattr(lib, "odcib_nms_workspace_bytes"):
            lib.odcib_nms_workspace_bytes.argtypes = [ctypes.c_int]
            lib.odcib_nms_workspace_bytes.restype = ctypes.c_longlong
            ws = torch.empty(nb * lib.odcib_nms_workspace_bytes(nk), dtype=torch.uint8, device=dev)
            args += [ws.data_ptr(), nb]
            types += [ctypes.c_void_p, ctypes.c_int]
        args += [nb, nk, float(thr), torch.cuda.current_stream().cuda_stream]
        fn.argtypes = types + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]

        def call(ws=ws):  # the workspace lives as long as the call does
            check_err(fn(*args))

        return call, out

    for b, blibs in baselines.items():
        for bx, lv, want in ((boxes, live, keep), (boxes[:1], live[:1], keep[:1])):
            base_nms, got = nms_direct(blibs["nms"], bx, lv)
            base_nms()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"baseline {b} greedy_nms_mask disagrees at B={lv.shape[0]}")
            k_ms, b_ms, turns = in_turns(lambda: nms_ops.greedy_nms_mask(bx, lv, thr), base_nms, 30, 30)
            log(f"[kernels] greedy_nms_mask B={lv.shape[0]} K={K}, in a row: this checkout {k_ms:.4f} ms, "
                f"baseline {b} {b_ms:.4f} ms, bitwise_equal=True (turns {turns}) | {card}")

    # ------------------------------------------------------------- 4 serving
    estep = make_eval_step(net, anchors, conf_thres=CONF, iou_thres=IOU,
                           max_det=MAX_DET, max_nms=MAX_NMS)
    for _ in range(2):
        estep(images)
    torch.cuda.synchronize()
    steps = SERVE_STEPS
    nms_ops.greedy_nms_mask.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        res = estep(images)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = nms_ops.greedy_nms_mask.launches
    if serve_launches != steps:
        fail(f"serving path launched the NMS kernel {serve_launches} times in {steps} steps")
    if tuple(res.boxes.shape) != (SERVE_B, MAX_DET, 4) or not torch.isfinite(res.boxes).all():
        fail(f"serving result: bad boxes {tuple(res.boxes.shape)}")
    if not (res.num_valid > 0).all() or not (res.scores[res.valid] > CONF).all():
        fail("serving result: an image without detections, or a score below conf")
    img_s = SERVE_B * steps / serve_s
    log(f"[serving] yolov5s nc={NC} {SERVE_S}x{SERVE_S} B={SERVE_B} bf16: {steps} eval steps in "
        f"{serve_s:.4f} s = {img_s:.2f} img/s; NMS launches {serve_launches} "
        f"({serve_launches / steps:g} per step); detections per image "
        f"{res.num_valid.min().item()}..{res.num_valid.max().item()} | {card}")

    # host time to enqueue one step from an idle card: above the device time,
    # the step is bound by the host's launches, not by the card
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        estep(images)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    log(f"[serving] host enqueue of one eval step (median of 5): {statistics.median(enqueue):.4f} ms "
        f"(runs {[round(t, 4) for t in enqueue]}) | {card}")

    with torch.inference_mode():
        out = net(images)
        det = decode_predictions(out, anchors)
        stage = {
            "forward": cuda_ms(lambda: net(images), 10),
            "decode": cuda_ms(lambda: decode_predictions(out, anchors), 10),
            "nms": cuda_ms(lambda: non_max_suppression(det, CONF, IOU, max_det=MAX_DET,
                                                       max_nms=MAX_NMS), 10),
        }
    log("[serving] ms per stage (CUDA events, median of 10): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage.items()) + f" | {card}")

    # the same port on the CPU agrees on a small f32 input
    small = build_network(3, "n", device="cpu", seed=1).eval()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        det_cpu = decode_predictions(small(x), anchors)
        det_gpu = decode_predictions(small.to(dev)(x.to(dev)), anchors)
        if not torch.allclose(det_gpu.cpu(), det_cpu, atol=1e-3, rtol=1e-3):
            fail("small f32 forward+decode: CUDA and CPU disagree beyond 1e-3")
        r_gpu = non_max_suppression(det_gpu, CONF, IOU)
        r_cpu = non_max_suppression(det_gpu.cpu(), CONF, IOU)
    for a, b in zip(r_gpu, r_cpu):
        if not torch.equal(a.cpu(), b):
            fail("small input: NMS on CUDA (kernel) and CPU (plain) differ")
    log(f"[serving] small f32 check: CUDA vs CPU decode within 1e-3, NMS identical "
        f"({r_cpu.num_valid.tolist()} kept)")

    # ---------------------------------------------------------- 5 validation
    info = build_fake_manifest(num_classes=NC, num_images=VAL_N, image_size=VAL_S,
                               zipf_a=1.01, seed=0)
    t0 = time.perf_counter()
    cache = ValDeviceCache(info, range(VAL_N), VAL_S, 120, fake_mode=True)
    ev = Evaluator(net, anchors, info.classes, batch_size=VAL_B, device=dev)
    ev.device_blocks(cache)
    torch.cuda.synchronize()
    log(f"[validation] setup: {VAL_N} canvases at {VAL_S} on the card in {time.perf_counter() - t0:.2f} s")
    nms_ops.greedy_nms_mask.launches = 0
    t0 = time.perf_counter()
    metrics = ev.validate(cache)
    val_s = time.perf_counter() - t0
    val_launches = nms_ops.greedy_nms_mask.launches
    n_blocks = math.ceil(VAL_N / VAL_B)
    if val_launches != n_blocks:
        fail(f"validation launched the NMS kernel {val_launches} times, want {n_blocks}")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"validation mAP not finite: {metrics}")
    log(f"[validation] {VAL_N} images B={VAL_B}: {val_s:.3f} s ({VAL_N / val_s:.1f} img/s incl. "
        f"host mAP), NMS launches {val_launches} | {card}")
    log("[validation] " + json.dumps(metrics))

    # ------------------------------------------------------- 6 training set-up
    aug = AugParams()  # configs/data/augmentations/aug_params.yaml, mixup 0
    train_info = build_fake_manifest(num_classes=NC, num_images=TRAIN_N, seed=0, zipf_a=1.01)
    t0 = time.perf_counter()
    trainer = Trainer(train_info, info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B,
                      aug_params=aug, max_targets=MAX_TARGETS, seed=0, dtype=torch.bfloat16,
                      device=dev, fused_epoch=False)  # phase 8 is the step loop; phase 12 the fused
    torch.cuda.synchronize()
    pipe = trainer.pipeline
    corpus = pipe.corpus
    log(f"[train] setup: fake corpus {tuple(corpus.shape)} uint8 = {corpus.numel()} B on the "
        f"card, net, pipeline and val cache in {time.perf_counter() - t0:.2f} s; "
        f"{trainer.steps_per_epoch} steps per epoch, warmup {trainer.optimizer.nw} steps")

    # ------------------------------------------- 7 training kernels vs plain
    K = 4 * TRAIN_B
    idx_np = np.random.default_rng(1).integers(0, TRAIN_N, K).astype(np.int32)
    idx_np[:4] = idx_np[4]  # repeated rows
    idx = torch.from_numpy(idx_np).to(dev)
    row_bytes = corpus[0].numel()
    flat = corpus.view(TRAIN_N, 8, row_bytes // 8)
    errs = {}
    errs["gather_rows_planar"] = max(
        check_equal(f"gather_rows_planar {tuple(corpus.shape)}[{K}]",
                    gather_ops.gather_rows_planar(corpus, idx), gather_ops.gather_rows_plain(corpus, idx)),
        check_equal("gather_rows_planar byte path (7,3,13,7)[5]",
                    gather_ops.gather_rows_planar(corpus[:7, :, :13, :7].contiguous(), idx[4:9] % 7),
                    gather_ops.gather_rows_plain(corpus[:7, :, :13, :7].contiguous(), idx[4:9] % 7)))
    bad = idx[:8].clone()
    bad[[1, 5]] = torch.tensor([-1, TRAIN_N], dtype=torch.int32, device=dev)
    want = gather_ops.gather_rows_plain(corpus, torch.where((bad >= 0) & (bad < TRAIN_N), bad, 0))
    want[[1, 5]] = 0
    errs["gather_rows_planar"] = max(errs["gather_rows_planar"], check_equal(
        "gather_rows_planar out-of-range rows come out zero", gather_ops.gather_rows_planar(corpus, bad),
        want))
    # without mosaic a step gathers B rows, not 4B: the first row of that
    # recipe's own plan (phase 9 drives it), sampler and all
    flat_plan = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS,
                                   use_mosaic=False, sampler=RepeatFactorSampler(train_info), seed=0,
                                   device=dev, corpus=pipe.device_corpus)._epoch_plan()[0]
    idx_b = torch.from_numpy(flat_plan[0].astype(np.int32)).to(dev)
    if idx_b.numel() != TRAIN_B:
        fail(f"the no-mosaic plan holds {idx_b.numel()} rows a step, want {TRAIN_B}")
    errs["gather_rows_planar"] = max(errs["gather_rows_planar"], check_equal(
        f"gather_rows_planar {tuple(corpus.shape)}[{TRAIN_B}] (a no-mosaic step's rows)",
        gather_ops.gather_rows_planar(corpus, idx_b), gather_ops.gather_rows_plain(corpus, idx_b)))
    errs["gather_rows_flat"] = check_equal(
        f"gather_rows_flat {tuple(flat.shape)}[{K}]",
        gather_ops.gather_rows_flat(flat, idx), gather_ops.gather_rows_plain(flat, idx))
    timing = {}
    for name, fn, src in (("gather_rows_planar", gather_ops.gather_rows_planar, corpus),
                          ("gather_rows_flat", gather_ops.gather_rows_flat, flat)):
        k_ms, p_ms, turns = in_turns(lambda: fn(src, idx), lambda: gather_ops.gather_rows_plain(src, idx),
                                     30, 10)
        lib_ms = statistics.median([run_ms(lambda: torch.index_select(src, 0, idx.long()), 30)
                                    for _ in range(2)])
        timing[name] = (k_ms, p_ms, lib_ms, *bound(2 * K * row_bytes, 0))
        log(f"[kernels] {name} K={K} rows of {row_bytes} B: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"torch.index_select {lib_ms:.4f} ms, bound {timing[name][3]:.6f} ms ({timing[name][4]}) "
            f"(turns {turns}) | {card}")
        log(f"[kernels] {name}: {2 * K * row_bytes / k_ms / 1e6:.1f} GB/s moved (index_select "
            f"{2 * K * row_bytes / lib_ms / 1e6:.1f}), {timing[name][3] / k_ms:.4f} of the byte bound | {card}")
        call_ms[name] = (cuda_ms(lambda: fn(src, idx), 30),
                         cuda_ms(lambda: torch.index_select(src, 0, idx.long()), 30))
        log(f"[kernels] {name} one call from an idle stream, host launch path included (median of 30): "
            f"kernel {call_ms[name][0]:.4f} ms, torch.index_select {call_ms[name][1]:.4f} ms | {card}")
    log(f"[kernels] gather.cu with 16-byte rows: {resources('gather_rows_kernelI5uint4', 0)}")
    want = gather_ops.gather_rows_plain(corpus, idx)
    for b, blibs in baselines.items():
        fn = blibs["gather"].odcib_gather_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_void_p]
        got = torch.zeros_like(want)
        stream = torch.cuda.current_stream().cuda_stream

        def base_gather():
            check_err(fn(corpus.data_ptr(), idx.data_ptr(), got.data_ptr(), TRAIN_N, K, row_bytes, stream))

        base_gather()
        check_equal(f"baseline {b} gather_rows_planar", got, want)
        k_ms, b_ms, turns = in_turns(lambda: gather_ops.gather_rows_planar(corpus, idx), base_gather, 30, 30)
        log(f"[kernels] gather_rows_planar K={K}, in a row: this checkout {k_ms:.4f} ms, baseline {b} "
            f"{b_ms:.4f} ms (turns {turns}) | {card}")
    del want

    # a real step's warp and HSV inputs, drawn from a generator of their own
    gen = torch.Generator(device=dev).manual_seed(7)
    draws = draw_augment(gen, TRAIN_B, TRAIN_S, aug)
    sample = pipe.gather(torch.from_numpy(pipe._epoch_plan()[0][0].astype(np.int32)).to(dev))
    G = TRAIN_B
    placement = aug_ops._mosaic_placement(sample.sizes.reshape(G, 4, 2), draws.centers, TRAIN_S)
    M = aug_ops._affine_matrices(draws.values, 2 * TRAIN_S, 2 * TRAIN_S, TRAIN_S, TRAIN_S)
    taps = aug_ops.mosaic_warp_taps(M, placement, TRAIN_S, draws.flip)
    imgs = sample.images.reshape(G, 4, 3, TRAIN_S, TRAIN_S)

    def rand_taps(G_, S_, seed):
        gt = torch.Generator(device=dev).manual_seed(seed)
        out = [torch.randint(0, 256, (G_, 4, 3, S_, S_), generator=gt, device=dev, dtype=torch.uint8)]
        for _ in range(2):
            j0 = torch.randint(-3, S_ + 1, (G_, 4, S_), generator=gt, device=dev, dtype=torch.int32)
            w = [torch.rand(G_, 4, S_, generator=gt, device=dev) for _ in range(2)]
            w = [torch.where(torch.rand(G_, 4, S_, generator=gt, device=dev) < 0.2, 0.0, x) for x in w]
            out += [j0, *w]
        return out

    dead = [t.clone() for t in taps]
    for t in dead[1:3] + dead[4:6]:
        t[:, 2] = 0.0  # quadrant 2 wholly outside its window: every weight zero
    warp_cases = {
        f"real draw {tuple(imgs.shape)}": (imgs, *taps),
        "random windowed taps G=16 S=416": tuple(rand_taps(16, 416, 1)),
        "random windowed taps G=16 S=640": tuple(rand_taps(16, 640, 2)),
        "real draw, quadrant 2 outside its window": (imgs, *dead),
    }
    errs["warp_quadrants"] = 0.0
    for name, args in warp_cases.items():
        for od in (torch.bfloat16, torch.float32):
            errs["warp_quadrants"] = max(errs["warp_quadrants"], check_equal(
                f"warp_quadrants {name} -> {od}", warp_ops.warp_quadrants(*args, out_dtype=od),
                warp_ops.warp_quadrants_plain(*args, out_dtype=od)))
    warped = warp_ops.warp_quadrants(imgs, *taps, out_dtype=torch.bfloat16)
    k_ms, p_ms, turns = in_turns(lambda: warp_ops.warp_quadrants(imgs, *taps, out_dtype=torch.bfloat16),
                                 lambda: warp_ops.warp_quadrants_plain(imgs, *taps, out_dtype=torch.bfloat16),
                                 30, 5)
    jx0, wx0, wx1, jy0, wy0, wy1 = taps
    src_bytes = float((used_lines(jy0, wy0, wy1, TRAIN_S) * used_lines(jx0, wx0, wx1, TRAIN_S)).sum() * 3)
    tap_bytes = sum(t.numel() * t.element_size() for t in taps)
    out_bytes = warped.numel() * warped.element_size()
    live_rows = float(((wy0 != 0) | (wy1 != 0)).sum())
    warp_ops_n = live_rows * TRAIN_S * 3 * WARP_OPS_PER_TAP_ROW + warped.numel() * 2
    timing["warp_quadrants"] = (k_ms, p_ms, None, *bound(src_bytes + tap_bytes + out_bytes, warp_ops_n))
    log(f"[kernels] warp_quadrants G={G} S={TRAIN_S} bf16 out: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
        f"(turns {turns}); bytes needed: source {src_bytes:.0f} (of {imgs.numel()} held) + taps "
        f"{tap_bytes} + out {out_bytes}; ops {warp_ops_n:.0f} (live quadrant rows {live_rows:.0f} of "
        f"{wy0.numel()}) -> bound {timing['warp_quadrants'][3]:.6f} ms ({timing['warp_quadrants'][4]}) | {card}")
    log(f"[kernels] warp_quadrants: {(src_bytes + tap_bytes + out_bytes) / k_ms / 1e6:.1f} GB/s of needed "
        f"bytes, {timing['warp_quadrants'][3] / k_ms:.4f} of the bound | {card}")
    call_ms["warp_quadrants"] = (
        cuda_ms(lambda: warp_ops.warp_quadrants(imgs, *taps, out_dtype=torch.bfloat16), 30), None)
    log(f"[kernels] warp_quadrants one call from an idle stream, host launch path included (median of "
        f"30): {call_ms['warp_quadrants'][0]:.4f} ms | {card}")
    for b, blibs in baselines.items():
        fn = blibs["warp"].odcib_warp_quadrants_bf16
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        got = torch.zeros_like(warped)
        ptrs = [imgs.data_ptr(), *(t.data_ptr() for t in taps), got.data_ptr()]
        stream = torch.cuda.current_stream().cuda_stream

        def base_warp():
            check_err(fn(*ptrs, G, TRAIN_S, TRAIN_S, stream))

        base_warp()
        check_equal(f"baseline {b} warp_quadrants", got, warped)
        k_ms, b_ms, turns = in_turns(lambda: warp_ops.warp_quadrants(imgs, *taps, out_dtype=torch.bfloat16),
                                     base_warp, 30, 30)
        log(f"[kernels] warp_quadrants G={G} S={TRAIN_S}, in a row: this checkout {k_ms:.4f} ms, baseline "
            f"{b} {b_ms:.4f} ms (turns {turns}) | {card}")
    log(f"[kernels] warp.cu at S=So={TRAIN_S}: "
        f"{resources('warp_quadrants_kernel', warp_ops.smem_bytes(TRAIN_S, TRAIN_S))}")

    gh = torch.Generator(device=dev).manual_seed(3)
    extreme = torch.tensor([[0.985, 0.3, 0.6], [1.015, 1.7, 1.4], [1.0, 1.0, 1.0], [0.99, 1.69, 0.61]],
                           device=dev).repeat(G // 4, 1)
    hsv_cases = {
        "real warp output bf16": (warped, draws.hsv_r),
        "real warp output f32": (warped.float(), draws.hsv_r),
        "integral bf16, extreme gains": (torch.randint(0, 256, warped.shape, generator=gh, device=dev)
                                         .to(torch.bfloat16), extreme),
        "non-integral f32, extreme gains": (torch.rand(warped.shape, generator=gh, device=dev) * 255.0,
                                            extreme),
    }
    # every (v, diff) pair twice over: entries 0, 1 and 255 of both tables
    vv, dd = torch.meshgrid(torch.arange(256), torch.arange(256), indexing="ij")
    vv, dd = vv.flatten()[None], torch.minimum(vv, dd).flatten()[None]
    lut = torch.stack([torch.cat([vv, vv - dd], 1), torch.cat([vv - dd, vv], 1),
                       torch.cat([vv - dd // 2, vv - dd], 1)], 1).view(1, 3, 256, 512)
    odd = torch.randint(0, 256, (5, 3, 13, 7), generator=gh, device=dev)
    buf = torch.randint(0, 256, (4 * 3 * 16 * 64 + 1,), generator=gh, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        off = buf.to(dt)[1:].view(4, 3, 16, 64)  # 2 or 4 bytes past a 16-byte boundary
        if off.data_ptr() % 16 == 0:
            fail("the offset view is 16-byte aligned: the case tests nothing")
        hsv_cases.update({
            f"every (v, diff) pair {dt}": (lut.to(dev, dt), extreme[1:2]),
            f"plane of 91, not a multiple of 8, {dt}": (odd.to(dt), extreme[:5]),
            f"base {off.data_ptr() % 16} bytes off 16-byte alignment {dt}": (off, extreme[:4]),
        })
    errs["hsv_planar"] = 0.0
    for name, (x, r) in hsv_cases.items():
        errs["hsv_planar"] = max(errs["hsv_planar"], check_equal(
            f"hsv_planar {name} {tuple(x.shape)}", hsv_ops.hsv_planar(x, r), hsv_ops.hsv_planar_plain(x, r)))
    k_ms, p_ms, turns = in_turns(lambda: hsv_ops.hsv_planar(warped, draws.hsv_r),
                                 lambda: hsv_ops.hsv_planar_plain(warped, draws.hsv_r), 30, 5)
    n_pos = warped.numel() // 3
    timing["hsv_planar"] = (k_ms, p_ms, None,
                            *bound(2 * warped.numel() * warped.element_size() + draws.hsv_r.numel() * 4,
                                   n_pos * HSV_OPS_PER_PIXEL))
    log(f"[kernels] hsv_planar {tuple(warped.shape)} bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
        f"(turns {turns}), bound {timing['hsv_planar'][3]:.6f} ms ({timing['hsv_planar'][4]}) | {card}")
    call_ms["hsv_planar"] = (cuda_ms(lambda: hsv_ops.hsv_planar(warped, draws.hsv_r), 30), None)
    log(f"[kernels] hsv_planar one call from an idle stream, host launch path included (median of 30): "
        f"{call_ms['hsv_planar'][0]:.4f} ms | {card}")
    hsv_bytes = 2 * warped.numel() * warped.element_size()
    log(f"[kernels] hsv_planar: {hsv_bytes / k_ms / 1e6:.1f} GB/s moved, "
        f"{timing['hsv_planar'][3] / k_ms:.4f} of the bound | {card}")
    log(f"[kernels] hsv.cu: {resources('hsv_planar_kernel', 0)}")
    hsv_want = hsv_ops.hsv_planar(warped, draws.hsv_r)
    for b, blibs in baselines.items():
        fn = blibs["hsv"].odcib_hsv_planar_bf16
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        got = torch.zeros_like(warped)
        stream = torch.cuda.current_stream().cuda_stream

        def base_hsv():
            check_err(fn(warped.data_ptr(), draws.hsv_r.data_ptr(), got.data_ptr(), G,
                         TRAIN_S * TRAIN_S, stream))

        base_hsv()
        check_equal(f"baseline {b} hsv_planar", got, hsv_want)
        k_ms, b_ms, turns = in_turns(lambda: hsv_ops.hsv_planar(warped, draws.hsv_r), base_hsv, 30, 30)
        log(f"[kernels] hsv_planar {tuple(warped.shape)} bf16, in a row: this checkout {k_ms:.4f} ms, "
            f"baseline {b} {b_ms:.4f} ms (turns {turns}) | {card}")
    timing["greedy_nms_mask"] = (nms_ms, plain_ms, None, bound_ms, bound_by)
    errs["greedy_nms_mask"] = max_err
    errs["letterbox"], timing["letterbox"], call_ms["letterbox"] = phase_letterbox(card, dev, resources)
    errs["bn_silu_train"], timing["bn_silu_train"], call_ms["bn_silu_train"] = phase_bn_silu(card, dev, resources)

    # ------------------------------------------------------------- 8 training
    net = trainer.net
    before = [p.detach().clone() for p in net.parameters()]
    marks = {}

    def on_step(epoch, i, m):
        if i in (TRAIN_STEPS - TIMED_STEPS - 1, TRAIN_STEPS - 1):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()

    counted = _kernel_entries()
    _zero_kernels()
    t0 = time.perf_counter()
    train_map = trainer.fit(max_epochs=1, epoch_steps=TRAIN_STEPS, on_step=on_step)
    fit_s = time.perf_counter() - t0
    train_launches = _read_kernels()
    log(f"[train] fit(max_epochs=1, epoch_steps={TRAIN_STEPS}) incl. validation: {fit_s:.2f} s; "
        f"launches {train_launches}")
    for name in ("gather_rows_planar", "hsv_planar", "warp_quadrants"):
        if train_launches[name] != TRAIN_STEPS:
            fail(f"training launched {name} {train_launches[name]} times in {TRAIN_STEPS} steps")
    if train_launches["greedy_nms_mask"] != n_blocks:
        fail(f"epoch-end validation launched NMS {train_launches['greedy_nms_mask']} times, want {n_blocks}")
    from object_detection_cib_torch.models.layers import ConvBnAct

    n_bn = sum(isinstance(m, ConvBnAct) for m in net.modules())
    if train_launches["bn_silu_train"] != TRAIN_STEPS * n_bn:
        fail(f"training launched bn_silu_train {train_launches['bn_silu_train']} times, want {TRAIN_STEPS} steps "
             f"x {n_bn} training BatchNorms")
    em = trainer.epoch_metrics[-1]
    if not all(np.isfinite(v).all() for v in em.values()):
        fail(f"training losses not finite: {em}")
    if pipe._overflow_pending:
        fail(f"fit left {len(pipe._overflow_pending)} overflow counts pending on the pipeline")
    unmoved = sum(torch.equal(a, b) for a, b in zip(before, net.parameters()))
    if unmoved:
        fail(f"{unmoved} of {len(before)} parameters did not move in {TRAIN_STEPS} steps")
    if not all(math.isfinite(v) for v in train_map.values()):
        fail(f"epoch-end mAP not finite: {train_map}")
    t_lo, t_hi = marks[TRAIN_STEPS - TIMED_STEPS - 1], marks[TRAIN_STEPS - 1]
    train_ips = TIMED_STEPS * TRAIN_B / (t_hi - t_lo)
    log(f"[train] yolov5s nc={NC} {TRAIN_S}x{TRAIN_S} B={TRAIN_B} bf16: {TIMED_STEPS} steps "
        f"(steps {TRAIN_STEPS - TIMED_STEPS + 1}-{TRAIN_STEPS}) in {t_hi - t_lo:.4f} s = {train_ips:.2f} img/s; "
        f"epoch wall {trainer.epoch_walls[-1]:.3f} s for {trainer.epoch_imgs[-1]} images | {card}")
    log("[train] per step: " + ", ".join(f"{k} {em[k][0]:.4g}->{em[k][-1]:.4g}"
                                         for k in ("total", "box", "obj", "cls", "lr"))
        + f"; all {len(before)} parameters moved; assign_drop total {em['assign_drop'].sum():.0f}; "
        f"targets dropped by max_targets {int(em['targets_dropped'])} (pipeline total "
        f"{pipe.overflow_total}, none pending)")
    log("[train] epoch-end validation " + json.dumps(train_map))

    plan_idx = torch.from_numpy(pipe._epoch_plan()[0][1].astype(np.int32)).to(dev)
    fixed = pipe.gather(plan_idx)
    batch, _ = pipe.augment_fn(fixed, draws)
    stage = {
        "gather (K2 + sizes/targets)": cuda_ms(lambda: pipe.gather(plan_idx), 10),
        "augment (K5, K4, boxes, to_batch)": cuda_ms(lambda: pipe.augment_fn(fixed, draws), 10),
        "draws": cuda_ms(lambda: draw_augment(gen, TRAIN_B, TRAIN_S, aug), 10),
        "forward+assign+loss+backward+SGD": cuda_ms(lambda: trainer.train_step(batch), 10),
        "whole step": cuda_ms(lambda: trainer.train_step(pipe.gather_augment(
            plan_idx, draw_augment(gen, TRAIN_B, TRAIN_S, aug))[0]), 10),
    }
    log("[train] ms per stage (CUDA events, median of 10): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage.items()) + f" | {card}")
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(pipe.gather_augment(plan_idx, draw_augment(gen, TRAIN_B, TRAIN_S, aug))[0])
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    log(f"[train] host enqueue of one whole step (median of 5): {statistics.median(enqueue):.4f} ms "
        f"(runs {[round(t, 4) for t in enqueue]}) | {card}")

    # device busy time per step and kernels launched per step, from a trace
    # of 3 whole steps; the idle share compares that busy time with the
    # untraced pipelined step time of the fit above
    from torch.profiler import ProfilerActivity, profile

    n_prof = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            trainer.train_step(pipe.gather_augment(plan_idx, draw_augment(gen, TRAIN_B, TRAIN_S, aug))[0])
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, "self_device_time_total", 0) for e in dev_events) / 1e3 / n_prof
    launches_per_step = sum(e.count for e in dev_events) / n_prof
    step_ms = (t_hi - t_lo) / TIMED_STEPS * 1e3
    if busy_ms > 0:
        log(f"[train] profiler: device busy {busy_ms:.4f} ms per step, {launches_per_step:.0f} kernels per "
            f"step; pipelined step {step_ms:.4f} ms -> device idle share {1 - busy_ms / step_ms:.4f} | {card}")
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]
        log("[train] top kernels by device time per step (ms): " + "; ".join(
            f"{e.key[:60]} x{e.count // n_prof} {e.self_device_time_total / 1e3 / n_prof:.3f}" for e in top))
    else:
        log("[train] profiler: no device time in the trace; idle share not measured")

    # two f32 yolov5n steps at 64 px from the same weights and draws, CPU vs card
    small_info = build_fake_manifest(num_classes=3, num_images=16, image_size=64, seed=0)
    g_cpu = torch.Generator().manual_seed(5)
    small_draws = [draw_augment(g_cpu, 4, 64, aug) for _ in range(2)]

    def small_run(device):
        snet = build_network(3, "n", device=device, seed=1)
        spipe = DeviceDataPipeline(small_info, 64, 4, aug, max_targets=20, seed=0,
                                   feed_dtype=torch.float32, device=device)
        sstep = make_train_step(snet, anchors, FeatureShape(64, 64),
                                SmartSGD(snet, OptimizerConfig(max_epochs=10), 4))
        plan, _ = spipe._epoch_plan()
        losses = []
        for i in range(2):
            b, _ = spipe.gather_augment(torch.from_numpy(plan[i].astype(np.int32)).to(device),
                                        small_draws[i].to(device))
            losses.append(float(sstep(b).total))
        return losses

    l_cpu, l_gpu = small_run(torch.device("cpu")), small_run(dev)
    if not all(abs(a - b) <= 1e-3 * abs(a) for a, b in zip(l_cpu, l_gpu)):
        fail(f"small f32 train steps: CPU losses {l_cpu} vs card {l_gpu} beyond 1e-3 relative")
    log(f"[train] small f32 check: yolov5n@64 B=4, 2 steps, loss CPU {l_cpu} vs card {l_gpu} "
        f"(within 1e-3 relative)")

    # -------------------------------------------------------------- 9 recipes
    shared = pipe.device_corpus
    T4 = 4 * pipe.src_T  # target slots of one mosaic group
    torch.cuda.reset_peak_memory_stats()

    zero_counts, read_counts = _zero_kernels, _read_kernels

    def run_recipe(name, steps, want, **kw):
        """``steps`` train steps of one recipe; launches counted over all of
        them, img/s over all but the first. No value is read on the host
        inside a step; the one synchronisation marks the end of the warm-up."""
        tr = Trainer(train_info, info, size="s", image_size=TRAIN_S, batch_size=TRAIN_B,
                     aug_params=kw.pop("aug_params", aug), max_targets=MAX_TARGETS, seed=0,
                     dtype=torch.bfloat16, device=dev, corpus=shared, **kw)
        rp = tr.pipeline
        if rp.corpus.data_ptr() != corpus.data_ptr():
            fail(f"{name}: the recipe did not share phase 6's corpus")
        totals, rows_valid = [], []
        zero_counts()
        for i, (batch, _) in enumerate(rp.epoch(steps)):
            totals.append(tr.train_step(batch).total)
            rows_valid.append(batch.mask.sum(1))
            if i == 0:
                torch.cuda.synchronize()
                t_first = time.perf_counter()
        torch.cuda.synchronize()
        t_last = time.perf_counter()
        got = read_counts()
        ips = (steps - 1) * TRAIN_B / (t_last - t_first)
        for k, n in want.items():
            if got[k] != n:
                fail(f"{name}: {k} launched {got[k]} times in {steps} steps, want {n}")
        losses = torch.stack(totals).tolist()
        if not all(math.isfinite(v) for v in losses):
            fail(f"{name}: losses not finite: {losses}")
        # the stages of one step, on fixed rows and draws
        groups, secs = rp._epoch_plan()
        rp.consumed_plan_log.pop()  # a plan drawn for timing only: not an epoch trained
        idx = torch.from_numpy(groups[0].astype(np.int32)).to(dev)
        idx2 = torch.from_numpy(secs[0].astype(np.int32)).to(dev) if secs.size else None
        draws_r = rp.draw()
        fixed = rp.gather(idx)
        fixed2 = rp.gather(idx2) if idx2 is not None else None
        aug_ms = cuda_ms(lambda: rp.augment_fn(fixed, draws_r, fixed2), 10)
        enq = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(rp.gather_augment(idx, rp.draw(), idx2)[0])
            enq.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        log(f"[recipes] {name}: {steps} steps, losses {losses[0]:.4f}->{losses[-1]:.4f}, launches {got}; "
            f"{(steps - 1) * TRAIN_B} images (steps 2-{steps}) in {t_last - t_first:.4f} s = {ips:.2f} img/s; "
            f"augment stage {aug_ms:.4f} ms (CUDA events, median of 10); K2 rows per launch {idx.numel()}; "
            f"host enqueue of one whole step (median of 5) {statistics.median(enq):.4f} ms | {card}")
        return tr, torch.stack(rows_valid), (fixed, draws_r)

    def spread(counts):
        """Largest over smallest per-class instance count."""
        return max(counts.values()) / max(min(counts.values()), 1)

    # class-aware sampling + mixup
    n2 = 2 * RECIPE_STEPS
    tr, rows_valid, _ = run_recipe(
        "class-aware + mixup 0.5", RECIPE_STEPS,
        {"gather_rows_planar": n2, "hsv_planar": n2, "warp_quadrants": n2},
        sampler=ClassAwareSampler(train_info, seed=0), mixup_prob=0.5)
    plain_pipe = DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, aug, max_targets=MAX_TARGETS,
                                    mixup_prob=0.5, seed=0, device=dev, corpus=shared)
    # the per-image coins of those steps, drawn again by a pipeline of the
    # same seed; the run's batches must bear them out: a row whose coin is
    # false holds no more than one group's targets
    coins = torch.stack([plain_pipe.draw().mix_do for _ in range(RECIPE_STEPS)])
    n_true, n_all = int(coins.sum()), coins.numel()
    if not 0 < n_true < n_all:
        fail(f"mixup coin true for {n_true} of {n_all} images: want some of each")
    most = int(rows_valid.max())
    if most <= T4:
        fail(f"no batch row holds more than one group's {T4} target slots (most {most})")
    unmixed = int(torch.where(coins, 0, rows_valid).max())
    if unmixed > T4:
        fail(f"a row whose mixup coin is false holds {unmixed} targets, more than one group's {T4}")
    stats = tr.sampler_stats(RECIPE_STEPS)
    plain_stats = plan_instance_counts(train_info, np.concatenate(plain_pipe._epoch_plan(), 1)[:RECIPE_STEPS])
    log(f"[recipes] class-aware + mixup: coin true for {n_true} of {n_all} images; most valid targets in "
        f"a row {most} (one group holds {T4}); instances per class over {RECIPE_STEPS} steps: "
        f"class-aware {stats} (largest/smallest {spread(stats):.3f}), no sampler {plain_stats} "
        f"({spread(plain_stats):.3f}), corpus {train_info.get_instance_count()}")
    if sum(stats.values()) <= 0 or spread(stats) >= spread(plain_stats):
        fail("class-aware sampling is not flatter than no sampler over the same steps")
    del tr, plain_pipe

    # repeat-factor sampling, no mosaic
    tr, _, (fixed, _) = run_recipe(
        "repeat-factor, no mosaic", RECIPE_STEPS,
        {"gather_rows_planar": RECIPE_STEPS, "hsv_planar": RECIPE_STEPS, "warp_quadrants": 0},
        sampler=RepeatFactorSampler(train_info), use_mosaic=False)
    if fixed.images.shape[0] != TRAIN_B:
        fail(f"no-mosaic step gathered {fixed.images.shape[0]} rows, want {TRAIN_B}")
    log(f"[recipes] repeat-factor, no mosaic: instances per class over {RECIPE_STEPS} steps "
        f"{tr.sampler_stats(RECIPE_STEPS)}")
    del tr, fixed

    # a rotating, shearing, perspective affine on the mosaic canvas
    general = aug._replace(affine_params=aug.affine_params._replace(degrees=10.0, shear=2.0,
                                                                     perspective=0.0005))
    tr, _, (fixed, draws_r) = run_recipe(
        "general affine (degrees 10, shear 2, perspective 0.0005)", AFFINE_STEPS,
        {"gather_rows_planar": AFFINE_STEPS, "hsv_planar": AFFINE_STEPS, "warp_quadrants": 0},
        aug_params=general)
    staged = augment_group(fixed, draws_r, TRAIN_S, general).images
    lo, hi = float(staged.min()), float(staged.max())
    if staged.dtype != torch.float32 or not torch.equal(staged, staged.round()) or lo < 0 or hi > 255:
        fail(f"general affine: pixels before normalize are not integers in [0, 255] ({lo}..{hi})")
    log(f"[recipes] general affine: pixels before normalize {tuple(staged.shape)} {staged.dtype}, "
        f"integers in [{lo:.0f}, {hi:.0f}]")
    del tr, fixed, staged

    # the exact warp beside the fast one: same rows, same draws
    def warp_pipe(hsv, precision):
        a = aug if hsv else aug._replace(hsv_params=HSVParams.no_aug())
        return DeviceDataPipeline(train_info, TRAIN_S, TRAIN_B, a, max_targets=MAX_TARGETS, seed=0,
                                  warp_precision=precision, feed_dtype=torch.float32, device=dev,
                                  corpus=shared)

    for hsv in (False, True):
        fast_p, exact_p = warp_pipe(hsv, "fast"), warp_pipe(hsv, "exact")
        d = fast_p.draw()
        zero_counts()
        fb, _ = fast_p.gather_augment(plan_idx, d)
        n_fast = read_counts()["warp_quadrants"]
        eb, _ = exact_p.gather_augment(plan_idx, d)
        n_exact = read_counts()["warp_quadrants"] - n_fast
        diff = (fb.images - eb.images).abs() * 255.0
        worst, within1 = float(diff.max()), float((diff <= 1.0 + 1e-3).float().mean())
        ex_ms = cuda_ms(lambda: exact_p.gather_augment(plan_idx, d), 5)
        fa_ms = cuda_ms(lambda: fast_p.gather_augment(plan_idx, d), 5)
        log(f"[recipes] exact vs fast warp, HSV {'on' if hsv else 'off'}: max pixel difference "
            f"{worst:.4f}/255, {within1:.6f} of pixels within 1/255; K5 launches fast {n_fast} exact "
            f"{n_exact}; gather+augment exact {ex_ms:.4f} ms, fast {fa_ms:.4f} ms | {card}")
        if n_fast != 1 or n_exact != 0:
            fail(f"warp launches: fast {n_fast} (want 1), exact {n_exact} (want 0)")
        if not (torch.equal(fb.boxes, eb.boxes) and torch.equal(fb.labels, eb.labels)
                and torch.equal(fb.mask, eb.mask)):
            fail("exact and fast warp disagree on boxes, labels or mask")
        if not hsv and (worst > 4.0 + 1e-3 or within1 < 0.99):
            fail(f"exact vs fast warp outside the contract: max {worst}/255, {within1} within 1/255")
    del fast_p, exact_p, fb, eb
    log(f"[recipes] torch.cuda.max_memory_allocated over the recipes: "
        f"{torch.cuda.max_memory_allocated()} B | {card}")

    # one composed-path step and one mixup step at 64 px, CPU against card
    for name, kw in (("composed path (general affine)", dict(affine=True)),
                     ("mixup 0.5", dict(mixup_prob=0.5))):
        for hsv in (False, True):
            a = general if kw.get("affine") else aug
            if not hsv:
                a = a._replace(hsv_params=HSVParams.no_aug())
            pkw = {k: v for k, v in kw.items() if k != "affine"}
            pair = [DeviceDataPipeline(small_info, 64, 4, a, max_targets=40, seed=0,
                                       feed_dtype=torch.float32, device=d, **pkw)
                    for d in ("cpu", dev)]
            groups, secs = pair[0]._epoch_plan()
            d_cpu = pair[0].draw()
            outs = []
            for sp in pair:
                i1 = torch.from_numpy(groups[0].astype(np.int32)).to(sp.device)
                i2 = torch.from_numpy(secs[0].astype(np.int32)).to(sp.device) if secs.size else None
                outs.append(sp.gather_augment(i1, d_cpu.to(sp.device), i2)[0])
            diff = (outs[0].images - outs[1].images.cpu()).abs() * 255.0
            worst, share = float(diff.max()), float((diff > 1e-3).float().mean())
            box_err = float((outs[0].boxes - outs[1].boxes.cpu()).abs().max())
            log(f"[recipes] CPU vs card, {name}, 64 px B=4 f32, HSV {'on' if hsv else 'off'}: max pixel "
                f"difference {worst:.4f}/255 on {share:.6f} of pixels, boxes {box_err:.2e}")
            # HSV multiplies a one-unit warp difference, so with HSV on the
            # limit is 9 units; either way on at most 0.1% of pixels (0.2%
            # where two groups are blended)
            limit = 9.0 if hsv else 1.0
            if worst > limit + 1e-3 or share >= 0.001 * (2 if pkw else 1) or box_err > 1e-4:
                fail(f"CPU vs card, {name}: pixels {worst}/255 on {share}, boxes {box_err}")
            if not (torch.equal(outs[0].labels, outs[1].labels.cpu())
                    and torch.equal(outs[0].mask, outs[1].mask.cpu())):
                fail(f"CPU vs card, {name}: labels or mask differ")

    # ---------------------------------------------------------------- 10 jpeg
    jpeg = phase_jpeg(card, dev, aug, counted, zero_counts, read_counts)

    # ----------------------------------------------------------------- 11 cli
    cli = phase_cli(card, counted, zero_counts, read_counts)

    # --------------------------------------------------------------- 12 fused
    fused = phase_fused(card, dev, aug, train_info, info, shared, zero_counts, read_counts)
    torch.cuda.empty_cache()  # the ranks of phase 13 are other processes on this card

    # ----------------------------------------------------------------- 13 ddp
    ddp = phase_ddp(card)
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 14 hosts
    hosts = phase_hosts(card)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 15 rest
    rest = phase_rest(card)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 16 spatial
    spatial = phase_spatial(card)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 17 corpus
    corpus_counts = phase_corpus(card, zero_counts, read_counts)

    # ------------------------------------------------------------------ 18 flat
    # K3's row takes its numbers on the NHWC corpus's view, the flat path's own
    flat_counts, (flat_err, timing["gather_rows_flat"], call_ms["gather_rows_flat"]) = phase_flat(
        card, dev, aug, train_info, info, shared)
    errs["gather_rows_flat"] = max(errs["gather_rows_flat"], flat_err)
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 19 carry
    carry = phase_carry(card)
    _free_card()

    # ----------------------------------------------------------------- 20 sizes
    sizes = phase_sizes(card, dev)

    # -------------------------------------------------------------- 21 report
    rows = [
        ("greedy_nms_mask", "nms.cu", "object_detection_cib_tpu/ops/pallas_nms.py:131", serve_launches),
        ("gather_rows_planar", "gather.cu", "object_detection_cib_tpu/ops/pallas_gather.py:98",
         train_launches["gather_rows_planar"]),
        # the flat corpus's path: phase 18 (a)'s fused fit
        ("gather_rows_flat", "gather.cu", "object_detection_cib_tpu/ops/pallas_gather.py:62",
         flat_counts["a flat"]["gather_rows_flat"]),
        ("hsv_planar", "hsv.cu", "object_detection_cib_tpu/ops/pallas_hsv.py:132",
         train_launches["hsv_planar"]),
        ("warp_quadrants", "warp.cu", "object_detection_cib_tpu/ops/pallas_warp.py:208",
         train_launches["warp_quadrants"]),
        # the port's own kernel: no Pallas counterpart, it ports the JAX
        # package's host letterbox; its main path is phase 17's decode
        ("letterbox", "letterbox.cu", "native/loader.cpp:75-118 (the port's own kernel; no pallas_call)",
         corpus_counts["jpeg"]["letterbox"]),
        # the port's own training BatchNorm + SiLU (the JAX package leaves
        # it to XLA); its main path is phase 12's fused fit
        ("bn_silu_train", "bn_silu.cu", "models/layers.py BatchNorm + SiLU (the port's own kernels; no pallas_call)",
         fused["bn_silu_train"]),
    ]
    kernels = []
    for name, file, replaces, launches in rows:
        by_path = {"serving": serve_launches if name == "greedy_nms_mask" else 0,
                   "validation": val_launches if name == "greedy_nms_mask" else 0,
                   "train": train_launches[name],
                   **{f"jpeg_{part}": n[name] for part, n in jpeg.items()},
                   "cli": {part: n[name] for part, n in cli.items()},
                   "fused": fused[name],
                   "ddp": {part: n[name] for part, n in ddp.items()},
                   "hosts": {part: n[name] for part, n in hosts.items()},
                   "rest": {part: n[name] for part, n in rest.items()},
                   "spatial": {part: n[name] for part, n in spatial.items()},
                   "corpus": {part: n[name] for part, n in corpus_counts.items()},
                   "flat": {part: n[name] for part, n in flat_counts.items()},
                   "carry": {part: n[name] for part, n in carry.items()},
                   "sizes": {part: n[name] for part, n in sizes.items()}}
        kernels.append(kernel_entry(name, file, replaces, launches, errs[name], timing[name], call_ms[name], by_path))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
