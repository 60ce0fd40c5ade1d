"""etcd service registration, go-micro compatible.

The port's own copy of `speaksense_tpu/registry/etcd.py`,
with the same names and behaviour.

Mirror of the reference's src/registry/etcd.rs: lease grant (TTL 10 s), PUT
`/micro/registry/{service}/{node_id}` with the lease, 3 s keep-alive loop,
deregister deletes the key and revokes the lease. Liveness therefore works
the same way: a crashed server's registration expires with its lease.

Implementation uses etcd's v3 JSON/gRPC-gateway over aiohttp (the reference
uses the etcd-client gRPC crate; the gateway writes the same keyspace, so
go-micro clients resolve nodes identically). etcd being unreachable raises —
callers decide whether that is fatal (GrpcServer logs and continues;
config.etcd_required restores the reference's hard-fail).
"""

from __future__ import annotations

import abc
import asyncio
import base64
import json
import logging

import aiohttp

log = logging.getLogger(__name__)

MICRO_PREFIX = "/micro/registry"


class Registry(abc.ABC):
    """reference trait Registry (registry/mod.rs:29-41)."""

    @abc.abstractmethod
    async def register(self, service_info: dict) -> None: ...

    @abc.abstractmethod
    async def deregister(self) -> None: ...

    @abc.abstractmethod
    async def start_heartbeat(self) -> None: ...

    @abc.abstractmethod
    async def stop_heartbeat(self) -> None: ...


def _b64(s: str | bytes) -> str:
    if isinstance(s, str):
        s = s.encode()
    return base64.b64encode(s).decode()


class EtcdRegistry(Registry):
    def __init__(self, endpoint: str = "http://localhost:2379", lease_ttl: int = 10,
                 heartbeat_interval: float = 3.0, timeout: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self.lease_ttl = lease_ttl
        self.heartbeat_interval = heartbeat_interval
        self.timeout = aiohttp.ClientTimeout(total=timeout)
        self.lease_id: int | None = None
        self.key: str | None = None
        self._hb_task: asyncio.Task | None = None
        self._service_info: dict | None = None  # for lease-loss re-register
        self.reregistrations = 0
        # True only after BOTH lease grant and KV put succeeded; the
        # heartbeat loop keeps retrying register() while False, so a put
        # that fails mid-recovery can't leave us heartbeating a keyless
        # lease forever
        self._registered = False
        self._session: aiohttp.ClientSession | None = None

    async def _post(self, path: str, payload: dict) -> dict:
        # one long-lived session: the keepalive fires every 3 s forever, and
        # a per-request ClientSession pays pool + TCP setup each time
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(timeout=self.timeout)
        async with self._session.post(f"{self.endpoint}{path}", json=payload) as resp:
            resp.raise_for_status()
            return await resp.json()

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
        self._session = None

    async def register(self, service_info: dict) -> None:
        self._service_info = service_info
        self._registered = False
        grant = await self._post("/v3/lease/grant", {"TTL": str(self.lease_ttl), "ID": "0"})
        self.lease_id = int(grant["ID"])
        node_id = service_info["nodes"][0]["id"]
        self.key = f"{MICRO_PREFIX}/{service_info['name']}/{node_id}"
        await self._post("/v3/kv/put", {
            "key": _b64(self.key),
            "value": _b64(json.dumps(service_info)),
            "lease": str(self.lease_id),
        })
        self._registered = True
        log.info("registered %s (lease %x)", self.key, self.lease_id)

    async def deregister(self) -> None:
        try:
            if self.key:
                try:
                    await self._post("/v3/kv/deleterange", {"key": _b64(self.key)})
                finally:
                    if self.lease_id:
                        await self._post("/v3/lease/revoke", {"ID": str(self.lease_id)})
        finally:
            self.key = None
            self.lease_id = None
            self._registered = False
            await self.close()

    async def start_heartbeat(self) -> None:
        if self._hb_task is not None:
            return
        self._hb_task = asyncio.create_task(self._heartbeat_loop())

    async def stop_heartbeat(self) -> None:
        if self._hb_task is not None:
            self._hb_task.cancel()
            try:
                await self._hb_task
            except asyncio.CancelledError:
                pass
            self._hb_task = None

    async def _heartbeat_loop(self) -> None:
        """3 s lease keep-alive (etcd.rs:89-122). A missed beat is logged and
        retried; when the lease has EXPIRED (an etcd outage longer than the
        TTL — the keepalive then reports TTL 0), the node re-registers with
        a fresh lease instead of heartbeating a dead one forever (the
        reference never recovers from this)."""
        while True:
            await asyncio.sleep(self.heartbeat_interval)
            if self.lease_id is None:
                continue
            try:
                if not self._registered and self._service_info is not None:
                    # a previous recovery granted a lease but the KV put
                    # failed — finish the registration before heartbeating
                    # the keyless lease (its TTL>0 would otherwise mask the
                    # missing key forever)
                    await self.register(self._service_info)
                    self.reregistrations += 1
                    continue
                resp = await self._post("/v3/lease/keepalive",
                                        {"ID": str(self.lease_id)})
                result = resp.get("result", resp)
                ttl = int(result.get("TTL", 0) or 0)
                if ttl <= 0 and self._service_info is not None:
                    log.warning("etcd lease %x expired; re-registering",
                                self.lease_id)
                    await self.register(self._service_info)
                    self.reregistrations += 1
            except Exception as e:
                log.warning("etcd keepalive failed: %s", e)
