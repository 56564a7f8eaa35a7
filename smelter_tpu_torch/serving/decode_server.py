"""Per-slot request state of the continuous-batching decode servers.

The port's counterpart of `smelter_tpu/serving/decode_server.py`, with
`_Slot` only; DecodeServer, SpecDecodeServer and BucketedDecodeServer are
not ported yet. The JAX package's `_heal_caches` has no counterpart: the
port's servers update their caches in place instead of donating them, so a
failed step leaves no consumed buffer to replace.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field


@dataclass
class _Slot:
    active: bool = False
    prompt: list[int] = field(default_factory=list)
    fed: int = 0                 # tokens of the prompt already consumed
    generated: list[int] = field(default_factory=list)
    n_new: int = 0
    last_token: int = 0
    pos: int = 0
    future: Future | None = None
