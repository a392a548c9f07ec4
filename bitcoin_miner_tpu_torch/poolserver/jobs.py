"""Job records and job sources of the pool frontend.

Counterpart of ``bitcoin_miner_tpu/poolserver/jobs.py``. A
:class:`FrontendJob` is the server's record of a job it announced
downstream, the shape of ``testing/mock_pool.py``'s ``PoolJob``. Two
kinds of source feed the server:

- :class:`LocalTemplateSource`: a deterministic stream of synthetic
  templates, internally consistent (coinbase → merkle → header), with no
  upstream and no node;
- proxy mode: :class:`UpstreamProxy` fans one upstream Stratum session
  out to every downstream session, :class:`FabricUpstreamProxy` several
  through the multi-pool fabric. The upstream extranonce2 space is
  carved per client by prefix (``space.py``): downstream ``extranonce1 =
  upstream_e1 ‖ prefix`` and ``e2_size = upstream_e2_size −
  prefix_bytes``, so a downstream coinbase is an upstream one with
  ``e2_up = prefix ‖ e2_down``, and an accepted downstream share that
  meets the upstream target is forwarded with that mapping, unhashed.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
from dataclasses import dataclass
from functools import cached_property
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Set

from ..core.sha256 import sha256d
from ..core.target import difficulty_to_target
from ..miner.dispatcher import Share
from ..miner.job import StratumJobParams, swap32_words
from ..telemetry.lifecycle import share_key

if TYPE_CHECKING:
    from ..miner.job import Job
    from ..miner.multipool import PoolFabric, PoolSlot
    from ..protocol.stratum import StratumClient
    from .server import ClientSession, StratumPoolServer

logger = logging.getLogger(__name__)

#: compact separators: fewer bytes and less encode time per line.
_JSON_SEPARATORS = (",", ":")


def encode_line(obj: Dict[str, Any]) -> bytes:
    """One wire line of the frontend's line-JSON dialect."""
    return (json.dumps(obj, separators=_JSON_SEPARATORS) + "\n").encode()


@dataclass(frozen=True)
class FrontendJob:
    """One job the frontend announced downstream (its validation copy)."""

    job_id: str
    prevhash_internal: bytes
    coinb1: bytes
    coinb2: bytes
    merkle_branch: List[bytes]
    version: int
    nbits: int
    ntime: int
    clean: bool = True

    def notify_params(self) -> List[Any]:
        return [
            self.job_id,
            swap32_words(self.prevhash_internal).hex(),
            self.coinb1.hex(),
            self.coinb2.hex(),
            [h.hex() for h in self.merkle_branch],
            f"{self.version:08x}",
            f"{self.nbits:08x}",
            f"{self.ntime:08x}",
            self.clean,
        ]

    @cached_property
    def notify_line(self) -> bytes:
        """The ``mining.notify`` push, encoded once per job: every session
        gets the same bytes (what differs per session, extranonce1, is
        never in a notify)."""
        return encode_line({
            "id": None,
            "method": "mining.notify",
            "params": self.notify_params(),
        })

    @classmethod
    def from_stratum(cls, params: StratumJobParams) -> "FrontendJob":
        """An upstream ``mining.notify`` re-announced downstream as it is
        (the upstream job id kept, so a forwarded share maps back)."""
        return cls(
            job_id=params.job_id,
            prevhash_internal=swap32_words(bytes.fromhex(params.prevhash)),
            coinb1=bytes.fromhex(params.coinb1),
            coinb2=bytes.fromhex(params.coinb2),
            merkle_branch=[bytes.fromhex(h) for h in params.merkle_branch],
            version=int(params.version, 16),
            nbits=int(params.nbits, 16),
            ntime=int(params.ntime, 16),
            clean=params.clean_jobs,
        )


class LocalTemplateSource:
    """Deterministic synthetic jobs: internally consistent, not
    consensus-valid, which is all share validation needs. ``ntime``
    advances per job, so each announcement is distinct work."""

    def __init__(
        self,
        version: int = 0x20000000,
        nbits: int = 0x1D00FFFF,
        ntime: int = 0x66000000,
        tag: bytes = b"tpu-miner poolserver",
    ) -> None:
        self.version = version
        self.nbits = nbits
        self.ntime = ntime
        self.tag = tag
        self._ids = itertools.count(1)

    def next_job(self, clean: bool = True) -> FrontendJob:
        n = next(self._ids)
        return FrontendJob(
            job_id=f"t{n:x}",
            prevhash_internal=sha256d(self.tag + b" prev %d" % n),
            coinb1=bytes.fromhex("01000000") + self.tag,
            coinb2=b"/" + self.tag + bytes.fromhex("00000000"),
            merkle_branch=[sha256d(self.tag + b" tx %d" % n)],
            version=self.version,
            nbits=self.nbits,
            ntime=self.ntime + n,
            clean=clean,
        )


def _forward_share(session: "ClientSession", base: bytes, job_id: str,
                   extranonce2: bytes, ntime: int, nonce: int,
                   version_bits: Optional[int], hash_int: int) -> Share:
    """The upstream form of a downstream share: the session's prefix (its
    extranonce1 past the upstream ``base``) before its extranonce2."""
    return Share(
        job_id=job_id,
        extranonce2=session.extranonce1[len(base):] + extranonce2,
        ntime=ntime,
        nonce=nonce,
        header80=b"",
        hash_int=hash_int,
        is_block=False,
        version_bits=version_bits,
    )


class UpstreamProxy:
    """Proxy mode: one upstream Stratum session serving every downstream
    client. It republishes the upstream's jobs and difficulty through the
    server and forwards each accepted downstream share that also meets
    the upstream target (with the server's difficulty tied to the
    upstream's, every accepted share). Forwards run as tracked tasks,
    cancelled on stop: an upstream round trip never stalls a downstream
    read loop."""

    def __init__(
        self, server: "StratumPoolServer", client: "StratumClient",
    ) -> None:
        self.server = server
        self.client = client
        self.forwarded = 0
        self.upstream_accepted = 0
        self.upstream_rejected = 0
        self._tasks: Set["asyncio.Task[None]"] = set()
        self._stopping = False
        client.on_job = self._on_upstream_job
        client.on_difficulty = self._on_upstream_difficulty
        server.on_share_accepted = self._on_downstream_accept

    async def _on_upstream_job(self, params: StratumJobParams) -> None:
        # The upstream session's extranonce geometry is known (and may
        # change) per connection: re-base on every job, which re-carves
        # live sessions and pushes mining.set_extranonce.
        await self.server.rebase_extranonce(
            self.client.extranonce1, self.client.extranonce2_size
        )
        await self.server.set_job(FrontendJob.from_stratum(params))

    async def _on_upstream_difficulty(self, difficulty: float) -> None:
        await self.server.set_difficulty(difficulty)

    async def _on_downstream_accept(
        self,
        session: "ClientSession",
        job: FrontendJob,
        extranonce2: bytes,
        ntime: int,
        nonce: int,
        version_bits: Optional[int],
        hash_int: int,
    ) -> None:
        if hash_int > difficulty_to_target(self.client.difficulty):
            return  # valid downstream, below the upstream bar
        share = _forward_share(session, self.client.extranonce1, job.job_id,
                               extranonce2, ntime, nonce, version_bits,
                               hash_int)
        task = asyncio.current_task()
        if task is not None:
            # The server runs this hook as a task it tracks; stop()
            # cancels the upstream submits in flight through this set.
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
        self.forwarded += 1
        # The lifecycle record is the downstream share's (the one the
        # validate hop closed), re-opened until the upstream answers.
        lc = self.server.telemetry.lifecycle
        lc_key = share_key(job.job_id, extranonce2, nonce)
        upstream = f"{getattr(self.client, 'host', '?')}:" \
                   f"{getattr(self.client, 'port', '?')}"
        lc.hop(lc_key, "upstream_forward", pool=upstream, terminal=False)
        try:
            ok = await self.client.submit_share(share)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # StratumError, ConnectionError
            self.upstream_rejected += 1
            lc.hop(lc_key, "upstream_ack", result="error")
            logger.warning("upstream submit failed: %s", e)
            return
        if ok:
            self.upstream_accepted += 1
        else:
            self.upstream_rejected += 1
        lc.hop(lc_key, "upstream_ack",
               result="accepted" if ok else "rejected")

    async def run(self) -> None:
        await self.client.run()

    def stop(self) -> None:
        self._stopping = True
        self.client.stop()
        for task in list(self._tasks):
            task.cancel()


class FabricUpstreamProxy:
    """Proxy mode over the multi-pool fabric: several upstream Stratum
    sessions behind one frontend, so the downstream fleet outlives an
    upstream. The fabric (``miner/multipool.py``) owns the sessions, the
    routing and the failover; this proxy is its sink through the hooks
    ``on_active_job`` and ``owner_of``:

    - on every install (job update, rebalance, failover) the downstream
      space is re-based onto the active upstream's extranonce geometry
      and the job announced under its fabric id (``p<slot>/<id>``);
    - an accepted downstream share that meets its upstream's target goes
      to the slot that owns its job, through the slot (whose in-flight
      count and window the stall rule and the weights read). A share of
      a superseded upstream is dropped, never sent to another pool: its
      extranonce carve no longer matches."""

    def __init__(self, server: "StratumPoolServer",
                 fabric: "PoolFabric") -> None:
        self.server = server
        self.fabric = fabric
        self.forwarded = 0
        self.upstream_accepted = 0
        self.upstream_rejected = 0
        self.dropped_cross_upstream = 0
        self._gen = itertools.count(1)
        self._tasks: Set["asyncio.Task[None]"] = set()
        self._stopping = False
        fabric.on_active_job = self._on_active_job
        server.on_share_accepted = self._on_downstream_accept

    async def _on_active_job(self, slot: "PoolSlot", job: "Job") -> int:
        """The fabric's sink: ``job`` is the active slot's namespaced
        miner ``Job``, which carries the whole notify."""
        client = slot.client
        await self.server.rebase_extranonce(
            client.extranonce1, client.extranonce2_size
        )
        if client.difficulty != self.server.difficulty:
            await self.server.set_difficulty(client.difficulty)
        await self.server.set_job(FrontendJob(
            job_id=job.job_id,
            prevhash_internal=job.prevhash_internal,
            coinb1=job.coinb1,
            coinb2=job.coinb2,
            merkle_branch=list(job.merkle_branch),
            version=job.version,
            nbits=job.nbits,
            ntime=job.ntime,
            clean=job.clean,
        ))
        return next(self._gen)

    async def _on_downstream_accept(
        self,
        session: "ClientSession",
        job: FrontendJob,
        extranonce2: bytes,
        ntime: int,
        nonce: int,
        version_bits: Optional[int],
        hash_int: int,
    ) -> None:
        lc = self.server.telemetry.lifecycle
        lc_key = share_key(job.job_id, extranonce2, nonce)
        slot = self.fabric.owner_of(job.job_id)
        _p, sep, orig_id = job.job_id.partition("/")
        if slot is None or not sep:
            self.dropped_cross_upstream += 1
            lc.hop(lc_key, "upstream_drop", reason="unroutable")
            return
        client = slot.client
        if (slot is not self.fabric.active
                or client.extranonce1 != self.server.extranonce1_base):
            # The session was re-based since: the share cannot be mapped
            # into that upstream's space, and no other pool announced it.
            self.dropped_cross_upstream += 1
            lc.hop(lc_key, "upstream_drop", reason="superseded_upstream",
                   pool=slot.label)
            return
        if hash_int > difficulty_to_target(client.difficulty):
            return  # valid downstream, below the upstream bar
        share = _forward_share(session, client.extranonce1, orig_id,
                               extranonce2, ntime, nonce, version_bits,
                               hash_int)
        task = asyncio.current_task()
        if task is not None:
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
        self.forwarded += 1
        lc.hop(lc_key, "upstream_forward", pool=slot.label, terminal=False)
        # The upstream share carries the prefixed extranonce2, so a key
        # derived from it would split the verdict onto another record:
        # key it to the downstream share's.
        verdict = await slot.submit(share, lifecycle_key=lc_key)
        if verdict == "accepted":
            self.upstream_accepted += 1
        elif verdict is not None:
            self.upstream_rejected += 1
        lc.hop(lc_key, "upstream_ack",
               result=verdict if verdict is not None else "dropped",
               pool=slot.label)

    async def run(self) -> None:
        await self.fabric.start()
        try:
            # Parked until PoolFrontend cancels it; the fabric's own tasks
            # do the work.
            await asyncio.Event().wait()
        finally:
            await self.fabric.stop()

    def stop(self) -> None:
        self._stopping = True
        self.fabric._stopping = True
        for task in list(self._tasks):
            task.cancel()
