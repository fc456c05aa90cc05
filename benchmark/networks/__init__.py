"""Network families: each ``networks/<network>.py`` is the one place that
knows a family of networks, and a configuration names its family by its
``network`` key. ``harness/registry.py`` loads the module from its file and
the windows, ``counts`` and the metric readers take everything of the
network from it, under the names every family module gives:

  * ``KEYS``: the keys of a configuration this family reads (``nc``, the
    number of classes, among them: the windows read it too);
  * ``reference(cfg)``: the plain float32 reference network (images (B, S,
    S, 3) in [0, 1] in, its heads out), whose ``set_quant(True)`` makes it
    the fp8 control;
  * ``weights(seed, cfg, device)``: the seed's float32 state with the
    configuration's ``assumed`` scales, drawn on ``device``;
  * ``calibrated(cfg, state, images)``: ``state`` with BatchNorm's running
    statistics set from ``images`` in the reference;
  * ``trainer_keywords(cfg)``: the keywords that make the program's
    ``Trainer`` build this network;
  * ``eval_network(cfg, device)``: the program's eval network in bf16 and
    its anchors, as its ``Evaluator`` takes them;
  * ``train_steps(cfg, net, batches, steps_per_epoch, size)``: the
    reference's judged training steps (assignment, loss, optimizer):
    -> (each step's total loss, the first gradient as the optimizer takes
    it);
  * ``decode(cfg, heads)``: the reference decode, a ``reference.detect.
    Decoded``;
  * ``conv_flops(cfg, size)``, ``bn_elements(cfg, size)``,
    ``parameters(cfg)``: the counts of one (size x size) image.

What runs in the reference imports neither the program nor JAX; what
builds the program's objects imports the program inside the function.
A new network is added as files: its family module here, its reference
beside ``reference/``, a configuration naming it and its cells.
"""
