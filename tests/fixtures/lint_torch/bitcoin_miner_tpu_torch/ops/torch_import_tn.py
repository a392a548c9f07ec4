"""TRUE NEGATIVE: device-claiming-import — torch in the port's ops/
(a device layer, not import-safe), the port's own package imported
absolutely and relatively, and the JAX package named only under
``TYPE_CHECKING``."""
from typing import TYPE_CHECKING

import torch

from bitcoin_miner_tpu_torch.core import sha256

from ..core import target

if TYPE_CHECKING:
    from bitcoin_miner_tpu.core.header import BlockHeader  # noqa: F401


def zeros(n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int64)


def difficulty_one() -> int:
    return target.nbits_to_target(0x1D00FFFF)


def digest(data: bytes) -> bytes:
    return sha256.sha256d(data)
