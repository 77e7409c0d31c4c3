"""The run must not load JAX or the JAX package: top-level module names
are compared whole, because the port's name, openjph_tpu_torch, begins
with the JAX package's."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

BANNED = frozenset({'jax', 'jaxlib', 'flax', 'openjph_tpu'})


def banned_in(names: Iterable[str]) -> List[str]:
    """The names whose top-level part is banned."""
    return sorted({n for n in names if n.split('.')[0] in BANNED})


def loaded_banned(modules: Optional[dict] = None) -> List[str]:
    """Banned modules in ``sys.modules`` (or ``modules``)."""
    return banned_in(list(sys.modules if modules is None else modules))
