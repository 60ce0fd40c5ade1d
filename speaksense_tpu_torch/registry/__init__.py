"""Service registry (reference src/registry/): the Registry interface and a
go-micro-compatible etcd implementation.

The port's own copy of `speaksense_tpu/registry/__init__.py`,
with the same names and behaviour."""

from speaksense_tpu_torch.registry.etcd import EtcdRegistry, Registry  # noqa: F401
