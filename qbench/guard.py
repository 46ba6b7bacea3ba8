"""The check that no JAX module, and nothing of the JAX package, was
loaded into the process that prints a result.

Module names are compared by their top-level part, the text before the
first dot, as whole words: ``quiver_tpu_torch`` is the port and passes,
``quiver_tpu`` is the JAX package and fails.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "quiver_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded module names whose top-level part is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
