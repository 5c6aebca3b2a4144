"""The import guard: no run may load JAX or the JAX package.

Names are compared by their top-level part (before the first dot), whole:
the port `cactus_tpu_torch` begins with the JAX package's name
`cactus_tpu` and is allowed.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cactus_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
