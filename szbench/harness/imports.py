"""The check that the process holds nothing of JAX or of the JAX package.

Names are compared by their top-level part (before the first dot), whole:
``sz3_tpu_torch`` is not ``sz3_tpu``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "sz3_tpu")


def found(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among `modules` (default: sys.modules)."""
    tops = {m.split(".", 1)[0] for m in (list(sys.modules) if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))
