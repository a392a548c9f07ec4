"""The pool frontend: a Stratum v1 server for downstream miners, with
per-session extranonce slices, CPU share validation, jobs from a local
template stream or upstream pools, and an internal worker that mines
the server's own slice. Counterpart of ``bitcoin_miner_tpu/poolserver``
but for the sharded frontend (``shard.py``)."""

from .jobs import (
    FabricUpstreamProxy,
    FrontendJob,
    LocalTemplateSource,
    UpstreamProxy,
)
from .runner import PoolFrontend
from .server import ClientSession, InternalWorker, StratumPoolServer
from .space import PrefixAllocator, SpaceExhausted

__all__ = [
    "ClientSession",
    "FabricUpstreamProxy",
    "FrontendJob",
    "InternalWorker",
    "LocalTemplateSource",
    "PoolFrontend",
    "PrefixAllocator",
    "SpaceExhausted",
    "StratumPoolServer",
    "UpstreamProxy",
]
