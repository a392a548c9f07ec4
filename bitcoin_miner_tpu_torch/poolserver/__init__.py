"""The pool frontend: a Stratum v1 server for downstream miners, with
per-session extranonce slices, CPU share validation, jobs from a local
template stream or upstream pools, and an internal worker that mines
the server's own slice, and its sharded form: N acceptor processes on one
port, each over a static range of the prefix space (``shard.py``).
Counterpart of ``bitcoin_miner_tpu/poolserver``."""

# miner-lint: import-safe

from .jobs import (
    FabricUpstreamProxy,
    FrontendJob,
    LocalTemplateSource,
    UpstreamProxy,
)
from .runner import PoolFrontend
from .server import ClientSession, InternalWorker, StratumPoolServer
from .shard import ShardConfig, ShardSupervisor, make_shard_configs
from .space import PrefixAllocator, SpaceExhausted

__all__ = [
    "ClientSession",
    "FabricUpstreamProxy",
    "FrontendJob",
    "InternalWorker",
    "LocalTemplateSource",
    "PoolFrontend",
    "PrefixAllocator",
    "ShardConfig",
    "ShardSupervisor",
    "SpaceExhausted",
    "StratumPoolServer",
    "UpstreamProxy",
    "make_shard_configs",
]
