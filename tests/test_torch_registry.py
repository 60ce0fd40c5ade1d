"""The port's etcd registry against the JAX package's, each on its own fake
etcd v3 JSON gateway on loopback (as tests/test_registry.py fakes it):
registration under the go-micro key with a lease, keep-alives, deregistration,
re-registration after the lease expired, and an unreachable etcd, with equal
gateway traffic and state."""

import asyncio
import base64
import importlib
import json

import pytest
from aiohttp import web

from test_torch_schedule import PACKAGES


class FakeEtcd:
    """The etcd v3 gateway routes the registry uses, recording each call."""

    def __init__(self):
        self.kv: dict[str, tuple[dict, int]] = {}
        self.leases: dict[int, int] = {}
        self.calls: list[str] = []
        self._next_lease = 100

    def app(self) -> web.Application:
        app = web.Application()
        for route in ("lease/grant", "lease/revoke", "lease/keepalive", "kv/put",
                      "kv/deleterange"):
            app.router.add_post(f"/v3/{route}", self.handle)
        return app

    async def handle(self, req):
        body = await req.json()
        route = req.path.removeprefix("/v3/")
        self.calls.append(route)
        if route == "lease/grant":
            self.leases[self._next_lease] = int(body["TTL"])
            self._next_lease += 1
            return web.json_response({"ID": str(self._next_lease - 1), "TTL": body["TTL"]})
        if route == "lease/revoke":
            self.leases.pop(int(body["ID"]), None)
        elif route == "lease/keepalive":
            ttl = self.leases.get(int(body["ID"]))
            result = {"ID": body["ID"]} if ttl is None else {"ID": body["ID"], "TTL": str(ttl)}
            return web.json_response({"result": result})
        elif route == "kv/put":
            self.kv[base64.b64decode(body["key"]).decode()] = (
                json.loads(base64.b64decode(body["value"])), int(body["lease"]))
        elif route == "kv/deleterange":
            self.kv.pop(base64.b64decode(body["key"]).decode(), None)
        return web.json_response({})


INFO = {"name": "asr", "version": "latest", "metadata": {}, "endpoints": [],
        "nodes": [{"id": "asr-node-1", "address": "1.2.3.4:7300", "metadata": {}}]}


async def _lifecycle(registry_cls) -> dict:
    """Register, heartbeat, lose the lease, recover, deregister."""
    fake = FakeEtcd()
    runner = web.AppRunner(fake.app())
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    endpoint = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    trace = {}
    try:
        reg = registry_cls(endpoint, lease_ttl=10, heartbeat_interval=0.05)
        await reg.register(INFO)
        trace["registered"] = (reg.key, reg.lease_id, dict(fake.kv), dict(fake.leases))
        await reg.start_heartbeat()
        while fake.calls.count("lease/keepalive") < 2:
            await asyncio.sleep(0.01)
        del fake.leases[reg.lease_id]  # the lease expires server-side
        fake.kv.clear()
        while reg.reregistrations == 0:
            await asyncio.sleep(0.01)
        await reg.stop_heartbeat()
        trace["recovered"] = (reg.key, reg.lease_id, dict(fake.kv), dict(fake.leases))
        await reg.deregister()
        trace["deregistered"] = (reg.key, reg.lease_id, dict(fake.kv), dict(fake.leases))
        # the calls up to the loss of the lease, and from the recovery on
        trace["calls"] = (fake.calls[:3], fake.calls[-4:])
    finally:
        await runner.cleanup()
    return trace


def test_registry_lifecycle_matches_jax():
    traces = [asyncio.wait_for(_lifecycle(importlib.import_module(
        f"{name}.registry.etcd").EtcdRegistry), 20) for name in PACKAGES]
    want, got = (asyncio.run(t) for t in traces)
    assert got == want
    key = "/micro/registry/asr/asr-node-1"
    assert got["registered"] == (key, 100, {key: (INFO, 100)}, {100: 10})
    assert got["recovered"] == (key, 101, {key: (INFO, 101)}, {101: 10})
    assert got["deregistered"] == (None, None, {}, {})
    assert got["calls"] == (["lease/grant", "kv/put", "lease/keepalive"],
                            ["lease/grant", "kv/put", "kv/deleterange", "lease/revoke"])


@pytest.mark.parametrize("package", PACKAGES)
def test_unreachable_etcd_raises(package):
    """Registration fails loudly; the server decides whether that is fatal."""
    mod = importlib.import_module(f"{package}.registry.etcd")

    async def flow():
        reg = mod.EtcdRegistry("http://127.0.0.1:1", timeout=0.3)
        try:
            await reg.register(INFO)
        finally:
            await reg.close()

    with pytest.raises(Exception) as excinfo:
        asyncio.run(flow())
    assert not isinstance(excinfo.value, AssertionError)
