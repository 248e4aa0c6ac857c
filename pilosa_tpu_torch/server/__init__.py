"""The port's server: API facade, protobuf surface, query coalescer, HTTP
routes, and the wire codec between nodes.

``API``, ``ApiError``, ``make_server`` and ``serve`` load on first use,
so the node-to-node client (``parallel/client.py``) can import
``server/wire.py`` without the API, which imports the client."""

_EXPORTS = {"API": "api", "ApiError": "api", "make_server": "http",
            "serve": "http"}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(
            f"pilosa_tpu_torch.server.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
