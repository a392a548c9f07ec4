"""Load probe of the pool frontend: N synthetic downstream miners.

Counterpart of ``benchmarks/load_probe.py``, run as ``python -m
bitcoin_miner_tpu_torch.probes.load_probe``. It measures the frontend on
the host, with no card: the mock pool turned around (scripted clients
against a real server). It prints one JSON line per measurement::

    {"metric": "frontend_load", "value": <validated shares/s>,
     "unit": "ops/s", "backend": "poolserver", "bench": "load_probe",
     "sessions": N, "jobs": J,
     "broadcast_ms_p50": ..., "broadcast_ms_p99": ...,
     "accepted": ..., "invalid": ..., ...}

Modes:

- in process (the default): N sessions against a ``StratumPoolServer``
  of this process, J job broadcasts, S pipelined submits per client and
  job at a difficulty every hash meets, so the headline is the
  validator's throughput (each submit rebuilt coinbase → merkle → header
  and double-SHA-256'd by the server). ``broadcast_ms_p99`` is the p99
  over every (client, job) of announce-to-arrival on one monotonic
  clock. ``--scales N1,N2,...`` repeats the measurement per session
  count, one line and one ledger row each (``sessions`` is part of the
  ledger's like-for-like key): how one process's knee is found;
- ``--connect HOST:PORT``: honest miners against a running ``--serve-pool``
  frontend: they wait for its job, mine real shares with hashlib at its
  difficulty and submit them. With ``--shards N`` (the frontend's
  ``--serve-shards``) each session is attributed, by its extranonce
  prefix, to the shard whose partition issued it (``sessions_per_shard``);
  ``--assert-unique-e1`` fails the run on an extranonce1 shared by two
  sessions. Its line adds ``submit_window``, the start and end of its
  submits in epoch seconds (not in the reference's): several probes run
  at once are summed as all their shares over the union of their
  windows, not as the sum of their rates.

``--ledger`` appends each line as a ``tpu-miner-perfledger/1`` row;
``--assert-p99-ms``, ``--assert-no-invalid`` and ``--assert-unique-e1``
exit 1 when broken.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from ..poolserver import LocalTemplateSource, StratumPoolServer

#: trivially-easy share difficulty: the share target exceeds the whole
#: 2^256 hash range (DIFF1/1e-12 > 2^256), so EVERY (extranonce2,
#: nonce) the clients submit passes oracle validation — the probe
#: measures the validator's throughput, not share luck.
EASY_DIFFICULTY = 1e-12

#: the server's pre-encoded submit-accept reply, as the read loop's
#: suffix match + the shared parsed form it resolves to (read-only —
#: consumers only .get() from it).
_ACCEPT_SUFFIX = b',"result":true,"error":null}\n'
_ACCEPT_CUT = len(_ACCEPT_SUFFIX)
_ACCEPT_MSG: dict = {"result": True, "error": None}

#: serialize-once broadcast means every ``mining.notify`` line is
#: byte-identical across sessions AND starts with this exact prefix
#: (compact-separator json, job_id first param) — the read loop stamps
#: the arrival straight off the prefix instead of json-parsing a
#: ~400-byte line (branch array included) per (client, job).
_NOTIFY_PREFIX = b'{"id":null,"method":"mining.notify","params":["'
_NOTIFY_SKIP = len(_NOTIFY_PREFIX)


class ProbeClient:
    """One scripted downstream miner: subscribe, authorize, time every
    notify, submit shares on demand."""

    def __init__(self, idx: int, port: int) -> None:
        self.idx = idx
        self.port = port
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.extranonce1 = b""
        self.extranonce2_size = 0
        self.difficulty = 1.0
        #: job_id → monotonic receive time of its mining.notify.
        self.notified_at: Dict[str, float] = {}
        self.notify_seen = asyncio.Event()
        self.accepted = 0
        self.rejected = 0
        self._ids = 0
        self._pending: Dict[int, asyncio.Future] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._e2_counter = 0
        #: newest mining.notify, raw line + lazily-parsed params: only
        #: the external-server smoke (mine_and_submit) ever needs the
        #: full params, so the in-process probe never pays the parse.
        self._notify_raw: Optional[bytes] = None
        self._notify_params: Optional[list] = None
        #: pipelined-burst accounting (see submit_shares): replies
        #: outstanding, and the future the burst awaits instead of one
        #: future per share.
        self._burst_left = 0
        self._burst_done: Optional[asyncio.Future] = None

    @property
    def last_notify(self) -> Optional[list]:
        """Params of the newest ``mining.notify`` (parsed on demand)."""
        if self._notify_params is None and self._notify_raw is not None:
            self._notify_params = json.loads(self._notify_raw)["params"]
        return self._notify_params

    async def connect(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port
        )
        self._reader_task = asyncio.create_task(
            self._read_loop(), name=f"probe-client-{self.idx}"
        )
        sub = await self._request("mining.subscribe",
                                  [f"load-probe/{self.idx}"])
        self.extranonce1 = bytes.fromhex(sub[1])
        self.extranonce2_size = int(sub[2])
        ok = await self._request("mining.authorize",
                                 [f"worker{self.idx}", "x"])
        assert ok, f"client {self.idx} failed authorization"

    async def _read_loop(self) -> None:
        assert self.reader is not None
        while True:
            line = await self.reader.readline()
            if not line:
                return
            # Burst fast path: while a pipelined submit burst is
            # outstanding, every id-carrying reply line IS a submit
            # verdict (the phases never overlap a handshake), so the
            # harness counts it without parsing — not even the id. The
            # `n` guard keeps `{"id":null,...}` pushes (notify/vardiff)
            # out of the count.
            if (self._burst_left and line.startswith(b'{"id":')
                    and line[6:7] != b"n"):
                if line.endswith(_ACCEPT_SUFFIX):
                    self.accepted += 1
                else:
                    self.rejected += 1
                self._burst_left -= 1
                if not self._burst_left \
                        and self._burst_done is not None \
                        and not self._burst_done.done():
                    self._burst_done.set_result(None)
                continue
            # Notify fast path: serialize-once broadcast makes every
            # notify line byte-stable with the job_id as the first
            # param — stamp arrival off a prefix match and defer the
            # full parse until someone actually reads last_notify.
            if line.startswith(_NOTIFY_PREFIX):
                end = line.index(b'"', _NOTIFY_SKIP)
                jid = line[_NOTIFY_SKIP:end]
                if b"\\" not in jid:  # never for our own hex job ids
                    self.notified_at[jid.decode()] = time.perf_counter()
                    self._notify_raw = line
                    self._notify_params = None
                    self.notify_seen.set()
                    continue
            # Submit-accept fast path: the server's template replies
            # are byte-stable, so the harness spends its per-response
            # budget on the measurement, not on re-json-parsing the
            # same 36 bytes 250k times. Anything else (rejects,
            # notifies, handshake replies) takes the full parse.
            if line.endswith(_ACCEPT_SUFFIX) and line.startswith(b'{"id":'):
                fut = self._pending.pop(int(line[6:-_ACCEPT_CUT]), None)
                if fut is not None and not fut.done():
                    fut.set_result(_ACCEPT_MSG)
                continue
            msg = json.loads(line)
            method = msg.get("method")
            if method == "mining.notify":
                self.notified_at[msg["params"][0]] = time.perf_counter()
                self._notify_raw = None
                self._notify_params = msg["params"]
                self.notify_seen.set()
            elif method == "mining.set_difficulty":
                self.difficulty = float(msg["params"][0])
            elif method is None:
                fut = self._pending.pop(msg.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)

    async def _request(self, method: str, params: list,
                       timeout: float = 30.0):
        assert self.writer is not None
        self._ids += 1
        req_id = self._ids
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        self.writer.write((json.dumps(
            {"id": req_id, "method": method, "params": params}
        ) + "\n").encode())
        await self.writer.drain()
        msg = await asyncio.wait_for(fut, timeout)
        if msg.get("error"):
            return msg["error"]
        return msg.get("result")

    async def submit_shares(
        self, job_id: str, ntime: int, count: int,
        corrupt: bool = False,
    ) -> None:
        """``count`` submits for ``job_id``; unique (extranonce2, nonce)
        per share so nothing dedups. ``corrupt`` submits a stale job id
        instead — the probe's deliberate-invalid knob.

        The burst is pipelined, as real miners do (Stratum replies carry
        ids so that a client need not wait on each): every request goes
        out in one write, and the replies are awaited as one counted
        future for the burst, which the read loop counts off the wire.
        A future, gather and timer per share would measure the probe's
        own scheduling rather than the frontend."""
        assert self.writer is not None
        if count <= 0:
            return
        frames = []
        for _ in range(count):
            self._e2_counter += 1
            e2 = self._e2_counter.to_bytes(self.extranonce2_size, "little")
            self._ids += 1
            # Direct %-format of the submit frame: every field is
            # self-generated (no escaping to do), and json.dumps per
            # share was a measurable slice of the harness's own cost.
            frames.append(
                '{"id":%d,"method":"mining.submit","params":'
                '["worker%d","%s","%s","%08x","%08x"]}\n'
                % (self._ids, self.idx,
                   "no-such-job" if corrupt else job_id,
                   e2.hex(), ntime, self._e2_counter)
            )
        self._burst_left = count
        done: asyncio.Future = asyncio.get_running_loop().create_future()
        self._burst_done = done
        self.writer.write("".join(frames).encode())
        await self.writer.drain()
        await asyncio.wait_for(done, 30.0)
        self._burst_done = None

    async def mine_and_submit(self, count: int) -> None:
        """The honest-miner leg: brute-force a REAL share client-side
        (plain hashlib over the notify's own job material) and submit it
        — what the 10-client serve-pool smoke drives, at a difficulty
        where validation is meaningful instead of trivially true."""
        assert self.last_notify is not None
        for _ in range(count):
            self._e2_counter += 1
            e2 = self._e2_counter.to_bytes(self.extranonce2_size, "little")
            ntime, nonce = mine_valid_share(
                self.last_notify, self.extranonce1, e2, self.difficulty
            )
            reply = await self._request("mining.submit", [
                f"worker{self.idx}", self.last_notify[0],
                e2.hex(), f"{ntime:08x}", f"{nonce:08x}",
            ])
            if reply is True:
                self.accepted += 1
            else:
                self.rejected += 1

    def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self.writer is not None:
            self.writer.close()


def mine_valid_share(
    notify_params: list, extranonce1: bytes, extranonce2: bytes,
    difficulty: float, max_iters: int = 1 << 24,
) -> Tuple[int, int]:
    """(ntime, nonce) meeting the share target, found with plain
    hashlib from the notify params — the same independent rebuild the
    server's validator does, so accept parity is end-to-end."""
    from ..core.header import merkle_root_from_branch
    from ..core.sha256 import sha256d
    from ..core.target import difficulty_to_target
    from ..miner.job import swap32_words

    (_job_id, prevhash_hex, coinb1_hex, coinb2_hex, branch,
     version_hex, nbits_hex, ntime_hex) = notify_params[:8]
    coinbase = (bytes.fromhex(coinb1_hex) + extranonce1 + extranonce2
                + bytes.fromhex(coinb2_hex))
    merkle = merkle_root_from_branch(
        sha256d(coinbase), [bytes.fromhex(h) for h in branch]
    )
    header76 = (
        int(version_hex, 16).to_bytes(4, "little")
        + swap32_words(bytes.fromhex(prevhash_hex))
        + merkle
        + int(ntime_hex, 16).to_bytes(4, "little")
        + int(nbits_hex, 16).to_bytes(4, "little")
    )
    target = difficulty_to_target(difficulty)
    for nonce in range(max_iters):
        digest = sha256d(header76 + nonce.to_bytes(4, "little"))
        if int.from_bytes(digest, "little") <= target:
            return int(ntime_hex, 16), nonce
    raise RuntimeError(f"no share under difficulty {difficulty} in "
                       f"{max_iters} nonces")


def _shard_of(
    extranonce1: bytes, prefix_bytes: int, shards: int
) -> Optional[int]:
    """Which static partition issued this session's prefix — the SAME
    arithmetic ``PrefixAllocator.partition`` carves with, so the probe
    attributes sessions to shards without any side channel."""
    if shards <= 1 or len(extranonce1) < prefix_bytes:
        return None
    prefix = int.from_bytes(extranonce1[-prefix_bytes:], "big")
    space = 256 ** prefix_bytes
    for i in range(shards):
        if (space * i) // shards <= prefix < (space * (i + 1)) // shards:
            return i
    return None


async def drive_external(
    host: str, port: int, clients: int, shares_per_client: int,
    shards: int = 1, prefix_bytes: int = 2,
) -> dict:
    """N honest synthetic miners against a running ``--serve-pool``
    frontend: wait for its job push, mine real shares client-side,
    submit, report the verdict counts.
    With ``shards > 1`` the target is a sharded frontend: sessions are
    attributed to their issuing partition and the payload carries the
    per-shard session spread (the kernel's SO_REUSEPORT balancing)."""
    fleet = [ProbeClient(i, port) for i in range(clients)]
    try:
        await asyncio.gather(*(c.connect() for c in fleet))
        deadline = time.monotonic() + 30.0
        while any(c.last_notify is None for c in fleet):
            if time.monotonic() > deadline:
                raise TimeoutError("server never announced a job")
            await asyncio.sleep(0.05)
        start = time.time()
        t0 = time.perf_counter()
        await asyncio.gather(*(
            c.mine_and_submit(shares_per_client) for c in fleet
        ))
        wall = time.perf_counter() - t0
        accepted = sum(c.accepted for c in fleet)
        rejected = sum(c.rejected for c in fleet)
        e1s = {c.extranonce1 for c in fleet}
        payload = {
            "metric": "frontend_load",
            "value": round(accepted / wall, 2) if wall else 0.0,
            "unit": "ops/s",
            "backend": "poolserver",
            "bench": "serve_pool_smoke",
            "sessions": clients,
            "unique_extranonce1": len(e1s),
            "accepted": accepted,
            "invalid": rejected,
            # The submit window on the host's clock: probes run side by
            # side give their total over the union of their windows.
            "submit_window": [start, start + wall],
        }
        if shards > 1:
            spread: Dict[str, int] = {}
            for c in fleet:
                idx = _shard_of(c.extranonce1, prefix_bytes, shards)
                key = str(idx) if idx is not None else "unattributed"
                spread[key] = spread.get(key, 0) + 1
            payload["shards"] = shards
            payload["sessions_per_shard"] = dict(sorted(spread.items()))
        return payload
    finally:
        for c in fleet:
            c.close()


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
    return s[int(idx)]


async def run_probe(
    clients: int,
    jobs: int,
    shares_per_client: int,
    difficulty: float = EASY_DIFFICULTY,
    invalid_every: int = 0,
    prefix_bytes: int = 2,
    telemetry=None,
) -> dict:
    """The measurement: N sessions, J job broadcasts, S submits per
    client per job. Returns the result payload (no printing)."""
    server = StratumPoolServer(
        difficulty=difficulty,
        prefix_bytes=prefix_bytes,
        telemetry=telemetry,
        # A 10k-session connect storm takes longer than the 10s
        # slow-loris deadline tuned for production churn; the probe is
        # measuring the steady state, not its own ramp.
        pre_auth_timeout_s=max(10.0, clients / 100.0),
    )
    source = LocalTemplateSource()
    await server.start()
    fleet = [ProbeClient(i, server.port) for i in range(clients)]
    broadcast_ms: List[float] = []
    submit_wall = 0.0
    try:
        # Bounded connect waves: the listener's accept backlog is not
        # sized for a single 10k-connection burst.
        for lo in range(0, clients, 500):
            await asyncio.gather(*(
                c.connect() for c in fleet[lo:lo + 500]
            ))
        assert server.downstream_sessions == clients
        e1s = {c.extranonce1 for c in fleet}
        assert len(e1s) == clients, "extranonce1 collision across clients"
        for j in range(jobs):
            job = source.next_job()
            t0 = time.perf_counter()
            await server.set_job(job)
            # Every client stamps the notify on arrival; wait for all.
            deadline = time.monotonic() + 30.0
            while any(job.job_id not in c.notified_at for c in fleet):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"job {job.job_id} not seen by every client"
                    )
                await asyncio.sleep(0.005)
            broadcast_ms.extend(
                (c.notified_at[job.job_id] - t0) * 1e3 for c in fleet
            )
            t1 = time.perf_counter()
            await asyncio.gather(*(
                c.submit_shares(
                    job.job_id, job.ntime, shares_per_client,
                    corrupt=bool(invalid_every)
                    and j % invalid_every == invalid_every - 1,
                )
                for c in fleet
            ))
            submit_wall += time.perf_counter() - t1
        accepted = sum(c.accepted for c in fleet)
        rejected = sum(c.rejected for c in fleet)
        shares_per_s = (
            (accepted + rejected) / submit_wall if submit_wall else 0.0
        )
        snap = server.snapshot()
        return {
            "metric": "frontend_load",
            "value": round(shares_per_s, 2),
            "unit": "ops/s",
            "backend": "poolserver",
            "bench": "load_probe",
            "sessions": clients,
            "jobs": jobs,
            "shares_per_client": shares_per_client,
            "accepted": accepted,
            "invalid": rejected,
            "broadcast_ms_p50": round(_percentile(broadcast_ms, 0.50), 3),
            "broadcast_ms_p99": round(_percentile(broadcast_ms, 0.99), 3),
            "broadcast_ms_max": round(max(broadcast_ms), 3),
            "prefixes_in_use": snap["prefixes_in_use"],
        }
    finally:
        for c in fleet:
            c.close()
        await server.stop()


def _parse_scales(text: str) -> List[int]:
    try:
        scales = [int(s) for s in text.split(",") if s.strip()]
    except ValueError:
        raise SystemExit(f"--scales must be comma-separated ints: {text!r}")
    if not scales or any(s < 1 for s in scales):
        raise SystemExit(f"--scales needs positive session counts: {text!r}")
    return scales


def _raise_fd_limit(needed: int) -> int:
    """One probe process holds ~2 FDs per session (client + server
    side); lift the soft RLIMIT_NOFILE toward the hard cap so a 10k
    scale doesn't die on EMFILE mid-ramp. Returns the session budget
    the lifted limit can actually hold — callers clamp to it LOUDLY
    (a silent truncation would read as \"measured 50k\" when it
    wasn't), instead of crashing the accept loop mid-measurement."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want = needed * 2 + 256
        if soft < want:
            try:
                resource.setrlimit(
                    resource.RLIMIT_NOFILE,
                    (min(want, hard) if hard != resource.RLIM_INFINITY
                     else want, hard),
                )
            except (OSError, ValueError):
                pass  # capped below want: the budget below says so
            soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
        return max(1, (soft - 256) // 2)
    except ImportError:
        return needed  # non-POSIX: no visibility, run as asked


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clients", type=int, default=100,
                   help="concurrent downstream sessions (default 100)")
    p.add_argument("--scales", metavar="N1,N2,...", default=None,
                   help="in-process scale sweep: run the measurement "
                        "once per session count (one JSON line + one "
                        "ledger row each; overrides --clients) — the "
                        "knee-finding mode")
    p.add_argument("--connect", metavar="HOST:PORT", default=None,
                   help="drive a running `--serve-pool` frontend "
                        "instead of an in-process server: honest-miner "
                        "mode — wait for its job push, mine real shares "
                        "client-side with hashlib, submit (--jobs/"
                        "--invalid-every do not apply)")
    p.add_argument("--shards", type=int, default=1,
                   help="with --connect: the target frontend's "
                        "--serve-shards count — sessions are attributed "
                        "to their issuing prefix partition and the "
                        "payload reports the per-shard spread")
    p.add_argument("--assert-unique-e1", action="store_true",
                   help="exit 1 unless every session holds a distinct "
                        "extranonce1 (the zero cross-shard-collision "
                        "contract)")
    p.add_argument("--jobs", type=int, default=5,
                   help="job broadcasts measured (default 5)")
    p.add_argument("--shares", type=int, default=5,
                   help="submits per client per job (default 5)")
    p.add_argument("--invalid-every", type=int, default=0,
                   help="every Nth job, clients submit stale-job shares "
                        "instead (exercises the reject path; 0 = never)")
    p.add_argument("--prefix-bytes", type=int, default=2,
                   help="per-session extranonce prefix width")
    p.add_argument("--assert-p99-ms", type=float, default=None,
                   help="exit 1 when the job-broadcast p99 exceeds this")
    p.add_argument("--assert-no-invalid", action="store_true",
                   help="exit 1 when any share failed validation")
    p.add_argument("--ledger", metavar="PATH", default=None,
                   help="append the emitted line to this perf ledger "
                        "(tpu-miner-perfledger/1)")
    p.add_argument("--ledger-id", metavar="ID", default=None,
                   help="pin the ledger row id")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    payloads: List[dict]
    if args.connect:
        host, _, port = args.connect.rpartition(":")
        payloads = [asyncio.run(drive_external(
            host or "127.0.0.1", int(port),
            clients=args.clients, shares_per_client=args.shares,
            shards=args.shards, prefix_bytes=args.prefix_bytes,
        ))]
    else:
        scales = (_parse_scales(args.scales) if args.scales
                  else [args.clients])
        budget = _raise_fd_limit(max(scales))
        clamped: List[int] = []
        for scale in scales:
            if scale > budget:
                print(f"load_probe: clamping {scale}-session scale to "
                      f"{budget} (RLIMIT_NOFILE bounds this process to "
                      f"~{budget} sessions)", file=sys.stderr)
                scale = budget
            if scale not in clamped:  # two scales clamping to the same
                clamped.append(scale)  # count are ONE experiment
        scales = clamped
        payloads = []
        for scale in scales:
            # Full collection between scales: a sweep's earlier runs
            # leave millions of dead session/stream objects behind, and
            # letting the NEXT scale's measurement inherit those gen2
            # scans made in-sweep rows read measurably below standalone
            # runs of the same scale (cross-scale interference, not
            # frontend cost).
            gc.collect()
            payloads.append(asyncio.run(run_probe(
                clients=scale,
                jobs=args.jobs,
                shares_per_client=args.shares,
                invalid_every=args.invalid_every,
                prefix_bytes=args.prefix_bytes,
            )))
    rc = 0
    for payload in payloads:
        print(json.dumps(payload), flush=True)
        if (args.assert_p99_ms is not None
                and payload.get("broadcast_ms_p99", 0.0)
                > args.assert_p99_ms):
            print(f"load_probe: broadcast p99 "
                  f"{payload.get('broadcast_ms_p99')}ms "
                  f"> bound {args.assert_p99_ms}ms "
                  f"({payload['sessions']} sessions)", file=sys.stderr)
            rc = 1
        if args.assert_no_invalid and payload["invalid"] > 0:
            print(f"load_probe: {payload['invalid']} shares failed "
                  "validation", file=sys.stderr)
            rc = 1
        if (args.assert_unique_e1
                and payload.get("unique_extranonce1",
                                payload["sessions"])
                != payload["sessions"]):
            print(f"load_probe: extranonce1 collision — "
                  f"{payload['unique_extranonce1']} unique across "
                  f"{payload['sessions']} sessions", file=sys.stderr)
            rc = 1
    if args.ledger:
        try:
            from ..telemetry.perfledger import PerfLedger, env_fingerprint

            ledger = PerfLedger(args.ledger)
            for n, payload in enumerate(payloads):
                ledger.append(
                    dict(payload),
                    fingerprint=env_fingerprint(platform="cpu"),
                    row_id=(args.ledger_id if len(payloads) == 1
                            else (f"{args.ledger_id}-{n}"
                                  if args.ledger_id else None)),
                )
        except Exception as e:  # noqa: BLE001 — ledger is downstream
            print(f"load_probe: ledger append failed: {e}",
                  file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
