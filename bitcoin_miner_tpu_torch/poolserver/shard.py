"""The sharded pool frontend: N acceptor processes on one port.

Counterpart of ``bitcoin_miner_tpu/poolserver/shard.py``. One asyncio
process carries every session of ``--serve-pool``; ``--serve-shards N``
spreads them over N processes the way TCP frontends do:

- every child binds the same ``host:port`` with ``SO_REUSEPORT``, and the
  kernel spreads incoming connections over the listeners: no proxy hop,
  no shared accept loop;
- every child serves a disjoint static range of the extranonce prefix
  space, :meth:`~.space.PrefixAllocator.partition` of ``(space, n, i)``:
  two sessions of two processes never share a prefix, with no message
  between processes on the submit path, and a respawned shard computes
  its exact range back from its index;
- every child owns its job source: local-template children build the
  same deterministic stream (the same tag gives the same job ids), and
  upstream-proxy children each hold their own upstream session.

The parent never sees a share. It owns the children's lifecycle (spawn,
liveness, SIGTERM to all, a dead shard respawned at its range) and their
observability: child ``i`` serves ``/metrics`` and ``/healthz`` on
``status_port + 1 + i``; the parent relabels their samples
``shard=<i>`` into its own ``/metrics``, sets each shard's state on the
``tpu_miner_frontend_shard_state`` gauge, and the health model's
``frontend_shard`` rule reads it: a shard off serving is DEGRADED, all
shards down is STALLED (503). The survivors' ranges are untouched, so a
dead shard costs capacity, not service.

Children are started with the ``spawn`` method: the parent may hold a
CUDA context, which a forked child must not inherit. Nothing on a
child's import path imports ``torch`` (and so this module imports
nothing of ``cli``): a child starts in about a second.
"""

# miner-lint: import-safe

from __future__ import annotations

import asyncio
import logging
import multiprocessing
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ..telemetry.pipeline import FRONTEND_SHARD_LEVELS
from .space import PrefixAllocator

logger = logging.getLogger(__name__)

#: seconds a child's ``/healthz`` or ``/metrics`` may take to answer the
#: supervisor's liveness probe or scrape.
SCRAPE_TIMEOUT_S = 1.0


@dataclass(frozen=True)
class ShardConfig:
    """Everything one acceptor child needs, picklable for ``spawn``.

    ``index`` and ``n_shards`` alone give the prefix range: the config
    carries no allocator state, so a respawn is the same child again."""

    index: int
    n_shards: int
    host: str
    port: int
    prefix_bytes: int
    extranonce2_size: int
    difficulty: float
    job_interval_s: float
    status_port: Optional[int]
    health_interval_s: float = 1.0
    vardiff_target_spm: float = 0.0
    vardiff_interval_s: float = 0.0
    upstream_host: Optional[str] = None
    upstream_port: int = 3333
    upstream_tls: bool = False
    upstream_tls_verify: bool = True
    username: str = ""
    password: str = "x"
    #: the operator's SLO objectives file: the parent validates it before
    #: the spawn, each child loads it again (a path pickles, an engine
    #: does not).
    slo_objectives_path: Optional[str] = None
    #: each child's ``StratumPoolServer`` validator: None probes the
    #: native library in the child (it is built once, under a digest
    #: name, and the children may probe it at once) and falls back to
    #: the hashlib oracle, False forces the oracle, True requires the
    #: native library or fails the child at its start.
    native_validation: Optional[bool] = None


async def _child_serve(frontend) -> None:  # pragma: no cover — child
    import signal

    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, frontend.stop)
        except (NotImplementedError, RuntimeError):
            pass
    await frontend.run()


def child_template_source():
    """A child's local job source, its ``ntime`` counted from the child's
    start. A respawned child announces the job ids of its first life and
    hands out the first extranonce1 of its range again: with the fixed
    ``ntime`` of the reference's, a miner reconnecting to it would mine
    the dead child's headers again, and be paid twice for them. Children
    started in one second announce the same jobs, as the reference's
    all do."""
    from .jobs import LocalTemplateSource

    return LocalTemplateSource(ntime=int(time.time()))


def shard_child_main(cfg: ShardConfig) -> None:  # pragma: no cover — child
    """One acceptor process, the ``spawn`` target (a fresh interpreter).

    It builds the one-process serving stack over its partition of the
    prefix space (server, job source, health watchdog, SLO engine, status
    endpoint) and serves until SIGTERM. It imports no ``torch``: the
    frontend is protocol and accounting on the host."""
    from ..telemetry import (
        HealthModel,
        HealthWatchdog,
        SloEngine,
        get_telemetry,
    )
    from ..utils.status import StatusServer, serve_status_in_thread
    from .jobs import UpstreamProxy
    from .runner import PoolFrontend
    from .server import StratumPoolServer

    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s shard{cfg.index} %(levelname)s %(message)s",
    )
    telemetry = get_telemetry()
    allocator = PrefixAllocator(cfg.prefix_bytes).partition(
        cfg.n_shards, cfg.index)
    server = StratumPoolServer(
        extranonce2_size=cfg.extranonce2_size,
        prefix_bytes=cfg.prefix_bytes,
        difficulty=cfg.difficulty,
        telemetry=telemetry,
        allocator=allocator,
        vardiff_interval_s=cfg.vardiff_interval_s,
        vardiff_target_spm=cfg.vardiff_target_spm or 6.0,
        native_validation=cfg.native_validation,
    )
    proxy = None
    local_source = None
    if cfg.upstream_host:
        from ..protocol.stratum import StratumClient

        proxy = UpstreamProxy(server, StratumClient(
            cfg.upstream_host, cfg.upstream_port,
            cfg.username, cfg.password,
            use_tls=cfg.upstream_tls,
            tls_verify=cfg.upstream_tls_verify,
        ))
    else:
        local_source = child_template_source()
    frontend = PoolFrontend(
        server, cfg.host, cfg.port,
        proxy=proxy,
        local_source=local_source,
        job_interval_s=cfg.job_interval_s,
        reuse_port=True,
    )
    if cfg.slo_objectives_path:
        from ..telemetry import load_objectives

        slo = SloEngine(telemetry, load_objectives(cfg.slo_objectives_path),
                        frontend=server)
    else:
        slo = SloEngine(telemetry, frontend=server)
    health = HealthModel(telemetry, slo=slo)
    watchdog = (
        HealthWatchdog(health, interval=cfg.health_interval_s).start()
        if cfg.health_interval_s > 0 else None
    )
    stop_status = None
    if cfg.status_port is not None:
        stop_status = serve_status_in_thread(StatusServer(
            frontend.stats, cfg.status_port,
            registry=telemetry.registry, telemetry=telemetry,
            health=health, slo=slo,
        ))
    try:
        asyncio.run(_child_serve(frontend))
    except KeyboardInterrupt:
        pass
    finally:
        if watchdog is not None:
            watchdog.stop()
        if stop_status is not None:
            stop_status()


class _ShardState:
    """The parent's record of one acceptor child."""

    __slots__ = ("cfg", "process", "state", "restarts", "served_once")

    def __init__(self, cfg: ShardConfig, process) -> None:
        self.cfg = cfg
        self.process = process
        self.state = "starting"
        self.restarts = 0
        self.served_once = False


class ShardSupervisor:
    """The parent of the sharded frontend: lifecycle and one view.

    It has the ``run()`` / ``stop()`` / ``stats`` surface that
    ``cli.run_session`` drives for every session mode, so ``--serve-pool
    --serve-shards N`` gets the reporter, the watchdog and the status
    server of any session; ``start()`` and ``shutdown()`` are the
    synchronous halves for tests and embedders.

    Liveness runs on a daemon thread: a dead child is marked ``down`` on
    one tick (the gauge the ``frontend_shard`` rule reads as DEGRADED)
    and respawned at its exact prefix range on the next. Detection and
    respawn are separate ticks, so a poller sees the degraded window."""

    def __init__(
        self,
        configs: List[ShardConfig],
        *,
        telemetry=None,
        liveness_interval_s: float = 1.0,
        respawn: bool = True,
    ) -> None:
        if not configs:
            raise ValueError("need at least one shard config")
        if telemetry is None:
            from ..telemetry import get_telemetry

            telemetry = get_telemetry()
        self.telemetry = telemetry
        self.configs = list(configs)
        self.liveness_interval_s = liveness_interval_s
        self.respawn = respawn
        self._ctx = multiprocessing.get_context("spawn")
        self._shards: Dict[int, _ShardState] = {}
        self._lock = threading.Lock()
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self._stop_event: Optional[asyncio.Event] = None
        self._stopping = False
        self._stats = None
        #: what ``cli.run_session`` looks up: the supervisor is its own
        #: shard view for the status server and the observatory.
        self.shard_supervisor = self

    # ------------------------------------------------------------ stats
    @property
    def stats(self):
        """Idle ``MinerStats`` for the reporter line: the parent hashes
        nothing, and each shard's counters are on its own port."""
        if self._stats is None:
            from ..miner.dispatcher import MinerStats

            self._stats = MinerStats(telemetry=self.telemetry)
        return self._stats

    # -------------------------------------------------------- lifecycle
    def _set_state(self, index: int, state: str) -> None:
        shard = self._shards[index]
        if shard.state != state:
            logger.info("shard %d: %s -> %s", index, shard.state, state)
        shard.state = state
        self.telemetry.frontend_shard_state.labels(
            shard=str(index)).set(FRONTEND_SHARD_LEVELS[state])

    def _spawn(self, cfg: ShardConfig) -> None:
        proc = self._ctx.Process(
            target=shard_child_main, args=(cfg,),
            name=f"pool-shard-{cfg.index}", daemon=True,
        )
        proc.start()
        prev = self._shards.get(cfg.index)
        state = _ShardState(cfg, proc)
        if prev is not None:
            state.restarts = prev.restarts + 1
        self._shards[cfg.index] = state
        self._set_state(cfg.index, "starting")

    def start(self) -> None:
        """Spawn every shard and the liveness monitor."""
        with self._lock:
            for cfg in self.configs:
                self._spawn(cfg)
        self._monitor_stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="shard-monitor", daemon=True,
        )
        self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(self.liveness_interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the monitor must survive
                logger.exception("shard monitor tick failed")

    def tick(self) -> None:
        """One liveness pass (tests call it without the thread): dead
        → down; down → respawned (the next tick); alive → classified by
        the child's ``/healthz``."""
        with self._lock:
            if self._stopping:
                return
            for index, shard in self._shards.items():
                if not shard.process.is_alive():
                    if shard.state != "down":
                        self._set_state(index, "down")
                    elif self.respawn:
                        logger.warning(
                            "shard %d (pid %s) died; respawning with "
                            "prefix range %s", index, shard.process.pid,
                            PrefixAllocator(shard.cfg.prefix_bytes)
                            .partition(shard.cfg.n_shards, index)
                            .prefix_range)
                        self._spawn(shard.cfg)
                    continue
                self._classify_alive(index, shard)

    def _classify_alive(self, index: int, shard: _ShardState) -> None:
        if shard.cfg.status_port is None:
            self._set_state(index, "serving")
            return
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{shard.cfg.status_port}/healthz",
                timeout=SCRAPE_TIMEOUT_S,
            ):
                pass
            status = 200
        except urllib.error.HTTPError as e:
            status = e.code
        except OSError:
            # Not answering: still starting, or wedged after serving.
            self._set_state(
                index, "degraded" if shard.served_once else "starting")
            return
        if status == 200:
            shard.served_once = True
            self._set_state(index, "serving")
        else:
            self._set_state(index, "degraded")

    def shutdown(self, timeout_s: float = 5.0) -> None:
        """SIGTERM to every child, a bounded join, SIGKILL for the
        ones still alive."""
        self._stopping = True
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=timeout_s)
            self._monitor = None
        with self._lock:
            procs = [(i, s.process) for i, s in self._shards.items()]
            for _i, proc in procs:
                if proc.is_alive():
                    proc.terminate()
            for _i, proc in procs:
                proc.join(timeout=timeout_s)
            for index, proc in procs:
                if proc.is_alive():
                    logger.warning("shard %d ignored SIGTERM; killing",
                                   index)
                    proc.kill()
                    proc.join(timeout=2.0)
                self._set_state(index, "down")

    # -------------------------------------------- the session's surface
    async def run(self) -> None:
        self._stop_event = asyncio.Event()
        if self._stopping:
            self._stop_event.set()
        self.start()
        try:
            await self._stop_event.wait()
        finally:
            await asyncio.get_running_loop().run_in_executor(
                None, self.shutdown)

    def stop(self) -> None:
        self._stopping = True
        if self._stop_event is not None:
            self._stop_event.set()

    # ---------------------------------------------------- observability
    def snapshot(self) -> dict:
        """The parent's view (``/telemetry`` ``frontend_shards``): each
        shard's pid, state, restarts, prefix range and status port. The
        pid is what a harness kills one acceptor by."""
        with self._lock:
            shards = []
            for index in sorted(self._shards):
                s = self._shards[index]
                lo, hi = PrefixAllocator(s.cfg.prefix_bytes).partition(
                    s.cfg.n_shards, index).prefix_range
                shards.append({
                    "shard": index,
                    "pid": s.process.pid,
                    "state": s.state,
                    "restarts": s.restarts,
                    "prefix_range": [lo, hi],
                    "status_port": s.cfg.status_port,
                })
            return {
                "n_shards": len(self.configs),
                "host": self.configs[0].host,
                "port": self.configs[0].port,
                "shards": shards,
            }

    def metrics_text(self) -> str:
        """The live children's ``/metrics`` samples, relabelled
        ``shard=<index>``: one parent scrape sees every acceptor. Comments
        are dropped (the parent's own block carries HELP and TYPE of the
        shared families); a child that does not answer is skipped, its
        absence shown by the shard-state gauge.

        A sample whose relabelled (name, labels) identity is a series of
        the parent's own registry, or one already taken from an earlier
        line, is dropped: the aggregated scrape never holds a series
        twice."""
        from ..telemetry.tsdb import sample_key

        seen: Set[Tuple[str, Tuple[Tuple[str, str], ...]]] = set()
        registry = getattr(self.telemetry, "registry", None)
        if registry is not None:
            for line in registry.render().splitlines():
                key = sample_key(line)
                if key is not None:
                    seen.add(key)
        out: List[str] = []
        for index, port in self.scrape_targets():
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics",
                    timeout=SCRAPE_TIMEOUT_S,
                ) as resp:
                    text = resp.read().decode("utf-8", "replace")
            except OSError:
                continue
            if not out:
                out.append("# aggregated from shard /metrics "
                           "(shard label added by the supervisor)")
            for line in text.splitlines():
                if not line or line.startswith("#"):
                    continue
                relabeled = _relabel_sample(line, index)
                key = sample_key(relabeled)
                if key is not None:
                    if key in seen:
                        continue
                    seen.add(key)
                out.append(relabeled)
        return "\n".join(out) + "\n" if out else ""

    def scrape_targets(self) -> List[Tuple[int, int]]:
        """(shard index, status port) of every live child: the discovery
        source the observatory's ``ScrapeFederator`` polls."""
        with self._lock:
            return [
                (i, s.cfg.status_port) for i, s in
                sorted(self._shards.items())
                if s.cfg.status_port is not None
                and s.process.is_alive()
            ]


def _relabel_sample(line: str, shard: int) -> str:
    """``name{a="b"} v`` → ``name{a="b",shard="i"} v``; an unlabelled
    sample gains the label set."""
    series, sep, value = line.rpartition(" ")
    if not sep:
        return line
    if series.endswith("}"):
        series = series[:-1] + f',shard="{shard}"}}'
    else:
        series = series + f'{{shard="{shard}"}}'
    return series + " " + value


def make_shard_configs(
    n_shards: int,
    host: str,
    port: int,
    *,
    prefix_bytes: int,
    extranonce2_size: int,
    difficulty: float,
    job_interval_s: float,
    status_port: Optional[int],
    health_interval_s: float = 1.0,
    vardiff_target_spm: float = 0.0,
    vardiff_interval_s: float = 0.0,
    upstream_host: Optional[str] = None,
    upstream_port: int = 3333,
    upstream_tls: bool = False,
    upstream_tls_verify: bool = True,
    username: str = "",
    password: str = "x",
    slo_objectives_path: Optional[str] = None,
    native_validation: Optional[bool] = None,
) -> List[ShardConfig]:
    """One config per shard. Child ``i``'s status port is ``status_port +
    1 + i``, none when the parent serves none. The partition is checked
    here, so a bad ``n_shards`` fails at the command line, not in a
    child."""
    if n_shards < 1:
        raise ValueError(f"need n_shards >= 1 (got {n_shards})")
    # Raises if a slice would be empty (more shards than prefixes).
    for i in range(n_shards):
        PrefixAllocator(prefix_bytes).partition(n_shards, i)
    return [
        ShardConfig(
            index=i,
            n_shards=n_shards,
            host=host,
            port=port,
            prefix_bytes=prefix_bytes,
            extranonce2_size=extranonce2_size,
            difficulty=difficulty,
            job_interval_s=job_interval_s,
            status_port=(status_port + 1 + i
                         if status_port is not None else None),
            health_interval_s=health_interval_s,
            vardiff_target_spm=vardiff_target_spm,
            vardiff_interval_s=vardiff_interval_s,
            upstream_host=upstream_host,
            upstream_port=upstream_port,
            upstream_tls=upstream_tls,
            upstream_tls_verify=upstream_tls_verify,
            username=username,
            password=password,
            slo_objectives_path=slo_objectives_path,
            native_validation=native_validation,
        )
        for i in range(n_shards)
    ]
