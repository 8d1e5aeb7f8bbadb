"""Shared asyncio-transport scaffolding: connection-handler tracking and
shutdown that drops open connections.

The reference aborts its transport tasks on shutdown (main.rs:154-169), so
idle connections never delay exit.  asyncio's Server.wait_closed() (3.12+)
instead waits for every connection handler — these helpers give the HTTP
and RESP transports the reference behavior from one implementation.
"""

from __future__ import annotations

import asyncio


class ConnTrackingMixin:
    """Tracks live connection-handler tasks so stop() can cancel them."""

    def _init_conn_tracking(self) -> None:
        self._conn_tasks: set = set()

    async def drain(self) -> None:
        """Graceful-drain hook: stop accepting NEW connections while
        established ones keep serving (they see OverloadError once the
        engine drains; stop() later drops them).  No-op for transports
        without a closable listener."""
        server = getattr(self, "_server", None)
        if server is not None:
            server.close()

    def _track_conn(self):
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        return task

    def _untrack_conn(self, task) -> None:
        self._conn_tasks.discard(task)

    async def _stop_dropping_conns(self, server) -> None:
        """Close the listener, then cancel handlers until wait_closed()
        returns.  Cancelling in a retry loop covers two races: a handler
        task created just before close() that has not registered yet, and
        a handler re-entering an awaitable (writer.wait_closed) after a
        first cancellation."""
        server.close()
        while True:
            for task in list(self._conn_tasks):
                task.cancel()
            try:
                await asyncio.wait_for(server.wait_closed(), timeout=0.2)
                return
            except asyncio.TimeoutError:
                continue
