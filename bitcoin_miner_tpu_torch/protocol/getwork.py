"""getwork and getblocktemplate clients: HTTP JSON-RPC polling.

Two solo-mining protocols over one transport:

- **getwork**: the node hands out a 128-byte padded header blob whose
  4-byte words are big-endian. ``decode_getwork_data`` swaps each word to
  recover the little-endian header; a submission applies the swap again,
  with the solved nonce in place.
- **getblocktemplate** (BIP 22/23): the node hands out a whole template;
  the miner builds the coinbase with an extranonce slot (so the
  dispatcher's extranonce2 axis applies), the merkle branch, mines, and
  submits the serialized block with ``submitblock``.

The HTTP layer is a minimal asyncio HTTP/1.1 POST client with one
connection per call: polls come seconds apart.
"""

from __future__ import annotations

import asyncio
import base64
import json
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple
from urllib.parse import urlparse

from ..core.header import merkle_branch_for_coinbase, unpack_header
from ..core.target import nbits_to_target
from ..core.tx import (
    OP_TRUE_SCRIPT,
    CoinbaseSplit,
    build_coinbase_split,
    serialize_block,
)
from ..miner.job import Job, job_from_template_fields, swap32_words


class JsonRpcError(Exception):
    def __init__(self, code: Any, message: str) -> None:
        super().__init__(f"json-rpc error {code}: {message}")
        self.code = code
        self.message = message


class JsonRpcHttpClient:
    """POSTs {"method": ..., "params": ...} to a bitcoind-style endpoint."""

    def __init__(
        self,
        url: str,
        username: str = "",
        password: str = "",
        timeout: float = 30.0,
    ) -> None:
        parsed = urlparse(url if "//" in url else f"http://{url}")
        if parsed.scheme not in ("", "http"):
            raise ValueError(f"only http:// endpoints supported, got {url!r}")
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 8332
        self.path = parsed.path or "/"
        self.timeout = timeout
        self._auth: Optional[str] = None
        if username or password:
            token = base64.b64encode(f"{username}:{password}".encode()).decode()
            self._auth = f"Basic {token}"
        self._ids = 0

    async def call(
        self,
        method: str,
        params: Optional[list] = None,
        timeout: Optional[float] = None,
    ) -> Any:
        self._ids += 1
        body = json.dumps({"jsonrpc": "1.0", "id": self._ids,
                           "method": method, "params": params or []}).encode()
        headers = [
            f"POST {self.path} HTTP/1.1",
            f"Host: {self.host}:{self.port}",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}",
            "Connection: close",
        ]
        if self._auth:
            headers.append(f"Authorization: {self._auth}")
        request = ("\r\n".join(headers) + "\r\n\r\n").encode() + body

        async def roundtrip() -> bytes:
            reader, writer = await asyncio.open_connection(self.host,
                                                           self.port)
            try:
                writer.write(request)
                await writer.drain()
                return await reader.read()
            finally:
                writer.close()

        raw = await asyncio.wait_for(roundtrip(), timeout or self.timeout)
        header, _, payload = raw.partition(b"\r\n\r\n")
        status_line = header.split(b"\r\n", 1)[0].decode(errors="replace")
        if " 401 " in status_line:
            raise JsonRpcError(401, "unauthorized (check rpcuser/rpcpassword)")
        try:
            msg = json.loads(payload)
        except json.JSONDecodeError as e:
            raise JsonRpcError(None, f"bad response ({status_line}): {e}") from e
        if msg.get("error"):
            err = msg["error"]
            raise JsonRpcError(err.get("code"), err.get("message", str(err)))
        return msg.get("result")


# ----------------------------------------------------------------- getwork
GETWORK_DATA_LEN = 128  # 80-byte header + SHA-256 padding, word-swapped

#: The fixed padding of the header's second SHA-256 chunk: 0x80, zeros and
#: the 64-bit bit length 640.
_CHUNK2_PADDING = b"\x80" + b"\x00" * 39 + (640).to_bytes(8, "big")


def decode_getwork_data(data_hex: str) -> bytes:
    """The 128-byte getwork blob → the 80 little-endian header bytes."""
    blob = bytes.fromhex(data_hex)
    if len(blob) != GETWORK_DATA_LEN:
        raise ValueError(f"getwork data must be {GETWORK_DATA_LEN} bytes")
    return swap32_words(blob[:80])


def encode_getwork_submit(header80: bytes) -> str:
    """A solved 80-byte header → the 128-byte blob getwork takes back: the
    per-word swap again, with the canonical padding."""
    if len(header80) != 80:
        raise ValueError("header must be 80 bytes")
    return (swap32_words(header80) + swap32_words(_CHUNK2_PADDING)).hex()


def decode_getwork_target(target_hex: str) -> int:
    """getwork's ``target``: the 256-bit share target, little-endian hex."""
    return int.from_bytes(bytes.fromhex(target_hex), "little")


# ------------------------------------------------------------------- GBT
@dataclass
class GbtJob:
    """A getblocktemplate work unit: the dispatcher's :class:`Job` and what
    a solve needs to become a whole block."""

    job: Job
    coinbase: CoinbaseSplit
    tx_blobs: List[bytes]  # the non-coinbase raw txs, in template order
    template: dict

    def block_hex(self, extranonce2: bytes, header80: bytes) -> str:
        # The coinbase in its witness form when the template commits to
        # witnesses; the merkle root always used the legacy txid.
        coinbase = self.coinbase.serialize_for_block(extranonce2)
        return serialize_block(header80, [coinbase] + self.tx_blobs).hex()


def job_from_template(
    template: dict,
    job_id: str,
    extranonce2_size: int = 4,
    script_pubkey: bytes = OP_TRUE_SCRIPT,
    share_target: Optional[int] = None,
) -> GbtJob:
    """A BIP 22/23 template → :class:`GbtJob`. The coinbase scriptSig holds
    the extranonce slot, so the search space is the Stratum path's:
    extranonce2 × 2^32 nonces."""
    nbits = int(template["bits"], 16)
    wc_hex = template.get("default_witness_commitment")
    split = build_coinbase_split(
        int(template["height"]), int(template["coinbasevalue"]),
        extranonce2_size, script_pubkey,
        witness_commitment=bytes.fromhex(wc_hex) if wc_hex else None)
    txs = template.get("transactions", [])
    # txid where the node sends it (BIP141 nodes send both; before segwit
    # hash == txid).
    txids = [bytes.fromhex(t.get("txid") or t["hash"])[::-1] for t in txs]
    job = Job(
        job_id=job_id,
        prevhash_internal=bytes.fromhex(template["previousblockhash"])[::-1],
        coinb1=split.coinb1,
        coinb2=split.coinb2,
        extranonce1=b"",
        extranonce2_size=extranonce2_size,
        merkle_branch=merkle_branch_for_coinbase(txids) if txids else [],
        version=int(template["version"]),
        nbits=nbits,
        ntime=int(template["curtime"]),
        share_target=(share_target if share_target is not None
                      else nbits_to_target(nbits)),
        clean=True,
    )
    return GbtJob(job=job, coinbase=split,
                  tx_blobs=[bytes.fromhex(t["data"]) for t in txs],
                  template=template)


class GbtClient:
    """Polls ``getblocktemplate`` and submits solved blocks."""

    def __init__(
        self,
        url: str,
        username: str = "",
        password: str = "",
        extranonce2_size: int = 4,
        script_pubkey: bytes = OP_TRUE_SCRIPT,
        rules: Optional[List[str]] = None,
    ) -> None:
        self.rpc = JsonRpcHttpClient(url, username, password)
        self.extranonce2_size = extranonce2_size
        self.script_pubkey = script_pubkey
        self.rules = rules or ["segwit"]
        self._job_seq = 0
        #: the last template's longpollid, when the node offers BIP22 long
        #: polling (else None).
        self.last_longpollid: Optional[str] = None

    async def fetch_job(
        self, longpoll: bool = False, longpoll_timeout: float = 120.0
    ) -> GbtJob:
        """One ``getblocktemplate``. With ``longpoll`` and a longpollid
        from the node, the request waits on the node until the template
        changes (a new tip or a new transaction set)."""
        req: dict = {"rules": self.rules}
        timeout = None
        if longpoll and self.last_longpollid is not None:
            req["longpollid"] = self.last_longpollid
            timeout = longpoll_timeout
        template = await self.rpc.call("getblocktemplate", [req],
                                       timeout=timeout)
        self.last_longpollid = template.get("longpollid")
        self._job_seq += 1
        return job_from_template(
            template, job_id=f"gbt-{template.get('height')}-{self._job_seq}",
            extranonce2_size=self.extranonce2_size,
            script_pubkey=self.script_pubkey)

    async def submit_block(
        self, gbt: GbtJob, extranonce2: bytes, header80: bytes
    ) -> Optional[str]:
        """``submitblock``: None when the node accepts, else its reason.
        BIP 22: a template's ``workid`` goes back in the parameters
        object."""
        params: list = [gbt.block_hex(extranonce2, header80)]
        workid = gbt.template.get("workid")
        if workid is not None:
            params.append({"workid": workid})
        return await self.rpc.call("submitblock", params)


class GetworkClient:
    """Polls ``getwork`` and submits solved headers."""

    def __init__(self, url: str, username: str = "",
                 password: str = "") -> None:
        self.rpc = JsonRpcHttpClient(url, username, password)
        self._job_seq = 0

    async def fetch_work(self) -> Tuple[Job, bytes]:
        """(the fixed-merkle job, the served header76) of one getwork."""
        result = await self.rpc.call("getwork", [])
        header80 = decode_getwork_data(result["data"])
        target = decode_getwork_target(result["target"])
        self._job_seq += 1
        hdr = unpack_header(header80)
        job = job_from_template_fields(
            job_id=f"getwork-{self._job_seq}",
            prevhash_display_hex=hdr.prevhash,
            merkle_root_internal=bytes.fromhex(hdr.merkle_root)[::-1],
            version=hdr.version,
            nbits=hdr.nbits,
            ntime=hdr.ntime,
            share_target=target,
        )
        return job, header80[:76]

    async def submit(self, header80: bytes) -> bool:
        return bool(await self.rpc.call("getwork",
                                        [encode_getwork_submit(header80)]))
