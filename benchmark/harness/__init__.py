"""The benchmark's harness: it finds cells, configurations and metric
readers by name, makes every input from the seed, drives the measured
program (``object_detection_cib_torch``) through its public entry points,
times it, traces it, and judges what it produced against ``reference/``."""
