"""The lowest word of one shard's scan outputs.

Counterpart of ``jnp.min(mins)`` and ``jnp.min(buf)`` in the ``shard_map``
bodies of ``bitcoin_miner_tpu/parallel/mesh.py``: :func:`shard_min` runs the
plain version (:func:`shard_min_plain`) for a CPU tensor and the CUDA kernel
of ``csrc/shard_min.cu`` for a CUDA one.
"""

from __future__ import annotations

import torch

from . import csrc
from .sha256_torch import MASK32

#: Launches of ``csrc/shard_min.cu::shard_min_kernel``.
SHARD_MIN = csrc.launch_counter("shard_min")


def shard_min_plain(x: torch.Tensor) -> torch.Tensor:
    """The least word of a uint32 tensor, as a 0-d uint32 tensor on its
    device; 0xFFFFFFFF for an empty one. The minimum is taken in int64:
    this torch's CPU uint32 has no ``min``."""
    words = x.reshape(-1).cpu().to(torch.int64)
    least = int(words.min()) if words.numel() else MASK32
    return torch.tensor(least, dtype=torch.int64).to(torch.uint32).to(x.device)


def shard_min(x: torch.Tensor) -> torch.Tensor:
    """:func:`shard_min_plain`'s contract on the tensor's device. A CPU
    tensor takes the plain version; a CUDA tensor (uint32, contiguous)
    launches ``shard_min_kernel`` on the current stream, one block,
    without synchronising.

    Replaces ``jnp.min`` in ``bitcoin_miner_tpu/parallel/mesh.py``'s shard
    bodies (``:164``, ``:220``, ``:291``). Bound: bytes, 4 per word read
    and 4 written; at the main path's few thousand words the launch is the
    cost. Design in ``csrc/shard_min.cu``."""
    device = x.device
    if device.type == "cpu":
        return shard_min_plain(x)
    csrc.check_tensor(x, device, torch.uint32, tuple(x.shape))
    out = torch.empty((), dtype=torch.uint32, device=device)
    lib = csrc.load("shard_min")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        csrc.check(lib.shard_min_launch(x.data_ptr(), x.numel(),
                                        out.data_ptr(), stream), "shard_min")
        SHARD_MIN.add()
    return out
