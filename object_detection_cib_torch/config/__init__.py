"""Config composition (see ``engine.py``)."""

from object_detection_cib_torch.config.engine import (
    compose,
    instantiate,
    load_yaml,
    resolve_interpolations,
)

__all__ = ["compose", "instantiate", "load_yaml", "resolve_interpolations"]
