"""In-process bitcoind stand-in: getblocktemplate, getwork and submitblock
over HTTP JSON-RPC, for regtest-style solo mining without a real node.

Its validation is independent of the miner: ``submitblock`` decodes the
block, recomputes the merkle root from the raw transactions, checks the
header's prevhash and nbits against the served template and the proof of
work with hashlib, sharing no code with the miner's hot path beyond the
``core`` consensus helpers. Its verdicts are those of the JAX package's
fake node. Two options go beyond it:

- ``advance_tip``: an accepted block becomes the new tip, as on a regtest
  node: its hash is the next template's prevhash, at height + 1, and
  parked long polls return;
- ``getwork_ntime_roll``: a getwork solve may carry an ntime up to that
  many seconds past the served one (a server that lets miners roll
  ntime); 0 holds a solve to the served header exactly.
"""

from __future__ import annotations

import asyncio
import json
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..core.header import merkle_root_from_txids, unpack_header
from ..core.sha256 import sha256d
from ..core.target import nbits_to_target
from ..core.tx import WITNESS_RESERVED, decode_varint
from ..miner.job import swap32_words

#: An easy regtest nbits: target = 0x7fffff << 8·(0x20 − 3), so about half
#: of all hashes qualify.
REGTEST_NBITS = 0x207FFFFF

_CHUNK2_PADDING = b"\x80" + b"\x00" * 39 + (640).to_bytes(8, "big")


@dataclass
class SubmittedBlock:
    block_hex: str
    accepted: bool
    reason: Optional[str]
    #: the tip (display hex) the node held when the block arrived.
    tip: str = ""


@dataclass
class SubmittedWork:
    header80: bytes
    accepted: bool
    #: the ntime the node served for this work.
    served_ntime: int = 0


def _tx_entries(blobs: List[bytes]) -> List[dict]:
    return [{"data": blob.hex(), "txid": sha256d(blob)[::-1].hex(),
             "hash": sha256d(blob)[::-1].hex()} for blob in blobs]


class FakeNode:
    """Serves one template at a time; records and validates submissions."""

    def __init__(
        self,
        prevhash_display: str = "00" * 32,
        nbits: int = REGTEST_NBITS,
        height: int = 1,
        coinbasevalue: int = 50 * 100_000_000,
        transactions: Optional[List[bytes]] = None,
        curtime: int = 1_700_000_000,
        version: int = 0x20000000,
        witness_commitment: bool = False,
        workid: Optional[str] = None,
        advance_tip: bool = False,
        getwork_ntime_roll: int = 0,
    ) -> None:
        #: BIP 22: with a workid, submitblock must echo it in its params
        #: object or be rejected.
        self.workid = workid
        self.advance_tip = advance_tip
        self.getwork_ntime_roll = getwork_ntime_roll
        # A bitcoind-style default_witness_commitment scriptPubKey
        # (OP_RETURN ‖ push36 ‖ magic ‖ 32-byte commitment). Its presence
        # and the coinbase's witness form are checked, not the committed
        # wtxid root itself.
        self.witness_commitment = (
            b"\x6a\x24\xaa\x21\xa9\xed" + sha256d(b"wc-fixture")
            if witness_commitment else None)
        self.template = {
            "version": version,
            "previousblockhash": prevhash_display,
            "height": height,
            "coinbasevalue": coinbasevalue,
            "curtime": curtime,
            "bits": f"{nbits:08x}",
            "target": f"{nbits_to_target(nbits):064x}",
            "transactions": _tx_entries(transactions or []),
            "rules": ["segwit"],
        }
        if self.witness_commitment is not None:
            self.template["default_witness_commitment"] = (
                self.witness_commitment.hex())
        if self.workid is not None:
            self.template["workid"] = self.workid
        self._lp_seq = 0
        self.template["longpollid"] = self._longpollid()
        self._template_changed = asyncio.Event()
        self.blocks: List[SubmittedBlock] = []
        self.block_seen = asyncio.Event()
        #: the header76s handed out by getwork, each with the work it was
        #: served under.
        self.getwork_headers: List[bytes] = []
        self.getwork_submits: List[SubmittedWork] = []
        self._server: Optional[asyncio.AbstractServer] = None
        self.port = 0

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._serve, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Release parked long polls: wait_closed() waits for active
            # handlers, which would otherwise sit out their 30 s bound.
            self._template_changed.set()
            await self._server.wait_closed()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    # ------------------------------------------------------- template updates
    def _longpollid(self) -> str:
        return f"{self.template['previousblockhash']}-{self._lp_seq}"

    def update_template(
        self,
        transactions: Optional[List[bytes]] = None,
        prevhash_display: Optional[str] = None,
        coinbasevalue: Optional[int] = None,
        curtime: Optional[int] = None,
    ) -> None:
        """Change the served template (a new transaction set, a new tip at
        height + 1, …), bump the longpollid and release every parked long
        poll: the BIP22 long-polling contract."""
        if transactions is not None:
            self.template["transactions"] = _tx_entries(transactions)
        if prevhash_display is not None:
            self.template["previousblockhash"] = prevhash_display
            self.template["height"] = int(self.template["height"]) + 1
        if coinbasevalue is not None:
            self.template["coinbasevalue"] = coinbasevalue
        if curtime is not None:
            self.template["curtime"] = curtime
        self._lp_seq += 1
        self.template["longpollid"] = self._longpollid()
        self._template_changed.set()
        self._template_changed = asyncio.Event()

    @property
    def tips(self) -> List[str]:
        """The distinct tips that accepted blocks were built on."""
        return sorted({b.tip for b in self.blocks if b.accepted})

    # ------------------------------------------------------------- transport
    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            header = await reader.readuntil(b"\r\n\r\n")
            length = 0
            for line in header.split(b"\r\n"):
                if line.lower().startswith(b"content-length:"):
                    length = int(line.split(b":", 1)[1])
            body = await reader.readexactly(length) if length else b""
            try:
                reply = await self._dispatch(json.loads(body))
            except (json.JSONDecodeError, KeyError) as e:
                reply = {"id": None, "result": None,
                         "error": {"code": -32700, "message": str(e)}}
            payload = json.dumps(reply).encode()
            writer.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                + f"Content-Length: {len(payload)}\r\n".encode()
                + b"Connection: close\r\n\r\n" + payload)
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def _dispatch(self, msg: dict) -> dict:
        method = msg.get("method")
        params = msg.get("params") or []
        req_id = msg.get("id")

        def ok(result):
            return {"id": req_id, "result": result, "error": None}

        def err(code, message):
            return {"id": req_id, "result": None,
                    "error": {"code": code, "message": message}}

        if method == "getblocktemplate":
            opts = params[0] if params and isinstance(params[0], dict) else {}
            lpid = opts.get("longpollid")
            if lpid and lpid == self.template.get("longpollid"):
                # BIP22 long polling: park until the template changes
                # (bounded, so a fixture cannot hang a test).
                try:
                    await asyncio.wait_for(self._template_changed.wait(), 30)
                except asyncio.TimeoutError:
                    pass
            return ok(self.template)
        if method == "submitblock":
            if not params:
                return err(-1, "missing block hex")
            reason = None
            if self.workid is not None:
                extra = params[1] if len(params) > 1 else None
                sent = extra.get("workid") if isinstance(extra, dict) else None
                if sent != self.workid:
                    reason = "workid-mismatch"
            if reason is None:
                reason = self._validate_block(params[0])
            tip = self.template["previousblockhash"]
            self.blocks.append(SubmittedBlock(params[0], reason is None,
                                              reason, tip=tip))
            self.block_seen.set()
            if reason is None and self.advance_tip:
                header80 = bytes.fromhex(params[0][:160])
                self.update_template(
                    prevhash_display=sha256d(header80)[::-1].hex())
            return ok(reason)  # bitcoind: null = accepted, else the reason
        if method == "getwork":
            if params:  # a submission
                return ok(self._validate_getwork(params[0]))
            return ok(self._serve_getwork())
        return err(-32601, f"method not found: {method}")

    # ------------------------------------------------------------ validation
    def _validate_block(self, block_hex: str) -> Optional[str]:
        """bitcoind-style: None when accepted, else the reason."""
        try:
            raw = bytes.fromhex(block_hex)
        except ValueError:
            return "decode-failed"
        if len(raw) < 81:
            return "decode-failed"
        header = unpack_header(raw[:80])
        if bytes.fromhex(header.prevhash) != bytes.fromhex(
                self.template["previousblockhash"]):
            return "inconclusive-not-best-prevblk"
        if header.nbits != int(self.template["bits"], 16):
            return "bad-diffbits"
        if int.from_bytes(sha256d(raw[:80]), "little") > nbits_to_target(
                header.nbits):
            return "high-hash"
        n_tx, consumed = decode_varint(raw, 80)
        body = raw[80 + consumed:]
        expected = [bytes.fromhex(t["data"])
                    for t in self.template["transactions"]]
        # The coinbase's length is not parsed: the known non-coinbase txs
        # are split off the end.
        tail = b"".join(expected)
        if expected and not body.endswith(tail):
            return "bad-txns"
        coinbase = body[:len(body) - len(tail)] if tail else body
        if n_tx != 1 + len(expected):
            return "bad-txnmrklroot"
        if self.witness_commitment is not None:
            # A segwit block: the coinbase in witness form with the BIP141
            # reserved value, carrying the commitment output.
            if coinbase[4:6] != b"\x00\x01":
                return "bad-witness-nonce-size"
            if coinbase[-4 - len(WITNESS_RESERVED):-4] != WITNESS_RESERVED:
                return "bad-witness-nonce-size"
            if self.witness_commitment not in coinbase:
                return "bad-witness-merkle-match"
            # The txid is over the legacy form: marker, flag and witness
            # stack stripped.
            coinbase = (coinbase[:4] + coinbase[6:-4 - len(WITNESS_RESERVED)]
                        + coinbase[-4:])
        elif coinbase[4:6] == b"\x00\x01":
            return "unexpected-witness"
        txids = [sha256d(coinbase)] + [sha256d(b) for b in expected]
        if merkle_root_from_txids(txids) != bytes.fromhex(
                header.merkle_root)[::-1]:
            return "bad-txnmrklroot"
        return None

    def _serve_getwork(self) -> dict:
        """A fixed-merkle header from the template (the merkle root is made
        up: getwork callers never see the transactions). Repeated polls of
        one template return the same work."""
        merkle = sha256d(b"getwork-merkle-"
                         + self.template["previousblockhash"].encode()
                         + self.template["bits"].encode())
        header76 = (
            struct.pack("<I", self.template["version"])
            + bytes.fromhex(self.template["previousblockhash"])[::-1]
            + merkle
            + struct.pack("<II", self.template["curtime"],
                          int(self.template["bits"], 16)))
        self.getwork_headers.append(header76)
        data = (swap32_words(header76 + b"\x00" * 4)
                + swap32_words(_CHUNK2_PADDING))
        target = nbits_to_target(int(self.template["bits"], 16))
        return {"data": data.hex(),
                "target": target.to_bytes(32, "little").hex()}

    def _served_ntime(self, header76: bytes) -> Optional[int]:
        """The ntime this node served for ``header76``'s work: the header
        itself, or with ``getwork_ntime_roll`` one that differs only by an
        ntime up to that many seconds later. None if it served no such
        work."""
        if header76 in self.getwork_headers:
            return struct.unpack_from("<I", header76, 68)[0]
        ntime = struct.unpack_from("<I", header76, 68)[0]
        for served in self.getwork_headers:
            if served[:68] + served[72:] != header76[:68] + header76[72:]:
                continue
            served_ntime = struct.unpack_from("<I", served, 68)[0]
            if 0 <= ntime - served_ntime <= self.getwork_ntime_roll:
                return served_ntime
        return None

    def _validate_getwork(self, data_hex: str) -> bool:
        raw = swap32_words(bytes.fromhex(data_hex)[:80])
        served_ntime = self._served_ntime(raw[:76])
        ok = served_ntime is not None and int.from_bytes(
            sha256d(raw), "little") <= nbits_to_target(
                int(self.template["bits"], 16))
        self.getwork_submits.append(SubmittedWork(raw, ok, served_ntime or 0))
        return ok
