"""Fault injection around the validating mock Stratum pool.

Counterpart of ``bitcoin_miner_tpu/testing/chaos_pool.py``:
:class:`ChaosStratumPool` is :class:`~.mock_pool.MockStratumPool` with
every upstream failure the multi-pool fabric must survive, scripted (not
random, so a test replays it exactly):

======================  ===============================================
knob / method           the failure it injects
======================  ===============================================
``kill()``              pool death: refuse new connections and sever
                        every live one
``revive()``            the pool comes back (half-open probes succeed)
``drop_clients()``      every live connection severed, the listener
                        still accepting
``mute = True``         half-open socket: connections stay up and are
                        read, but no request is ever answered
``reply_delay_s``       every reply delayed (a slow pool)
``abort_replies``       the connection severed instead of the next
                        replies (an int counts them down, True: all)
``reject_submits``      every submit answered "low difficulty share"
                        (code 23): an accept-rate collapse with no
                        transport fault
``flap_difficulty()``   ``mining.set_difficulty`` oscillating
======================  ===============================================

Every knob is a plain attribute: ``pool.mute = True`` … assert the
failover … ``pool.mute = False``.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .mock_pool import MockStratumPool

__all__ = ["ChaosStratumPool"]


class ChaosStratumPool(MockStratumPool):
    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        #: refuse fresh connections (with ``kill()``: the pool is dead).
        self.refuse_connections = False
        #: half-open: read every request, answer none.
        self.mute = False
        #: seconds to wait before each reply (0: none).
        self.reply_delay_s = 0.0
        #: sever the connection instead of replying (an int: that many
        #: times; True: every time).
        self.abort_replies: "bool | int" = 0
        #: answer every mining.submit with a rejection.
        self.reject_submits = False

    # ------------------------------------------------------------ scripting
    def kill(self) -> None:
        """Pool death: refuse new connections, sever the live ones."""
        self.refuse_connections = True
        self.drop_clients()

    def revive(self) -> None:
        self.refuse_connections = False
        self.mute = False

    def drop_clients(self) -> None:
        """Sever every live connection: clients read EOF and reconnect,
        unless ``refuse_connections`` keeps them out."""
        for w in list(self._clients):
            w.close()
        self._clients.clear()

    async def flap_difficulty(
        self, low: float, high: float, flips: int, period_s: float = 0.05
    ) -> None:
        """Set the share difficulty ``flips`` times, alternating."""
        for i in range(flips):
            await self.set_difficulty(high if i % 2 else low)
            await asyncio.sleep(period_s)

    # ------------------------------------------------------------ injection
    async def _accept(self, writer: asyncio.StreamWriter) -> bool:
        return not self.refuse_connections

    async def _send_reply(
        self, writer: asyncio.StreamWriter, reply: dict
    ) -> None:
        if self.mute:
            return  # half-open: the request was read, and is never answered
        if self.abort_replies:
            if isinstance(self.abort_replies, int) and not isinstance(
                    self.abort_replies, bool):
                self.abort_replies -= 1
            writer.close()
            if writer in self._clients:
                self._clients.remove(writer)
            return
        if self.reply_delay_s > 0:
            await asyncio.sleep(self.reply_delay_s)
        await super()._send_reply(writer, reply)

    def _dispatch(self, msg: dict) -> Optional[dict]:
        if self.reject_submits and msg.get("method") == "mining.submit":
            # The base validator records the share (tests read
            # ``pool.shares``); its verdict is then overruled.
            super()._dispatch(msg)
            if self.shares:
                self.shares[-1].accepted = False
                self.shares[-1].reason = "low difficulty share"
            return {"id": msg.get("id"), "result": None,
                    "error": [23, "low difficulty share", None]}
        return super()._dispatch(msg)
