"""Seeds derived from ``--seed``: any whole number, 2**31 and larger included."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from ``seed`` and ``tags``."""
    text = "/".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def derive32(seed: int, *tags) -> int:
    """A 32-bit seed, for ``numpy.random.RandomState``."""
    return derive(seed, *tags) & 0xFFFFFFFF
