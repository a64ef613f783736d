"""The process may hold nothing of JAX or of the JAX package.

Compared by whole top-level module names (the part before the first dot): the port,
``triplaneturbo_torch``, begins with the JAX package's name, so a prefix match would be
wrong.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "triplaneturbo_tpu", "bench",
                       "benchmarks"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
