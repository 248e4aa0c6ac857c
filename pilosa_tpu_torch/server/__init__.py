"""The port's single-node server: API facade, protobuf surface, query
coalescer and HTTP routes."""

from pilosa_tpu_torch.server.api import API, ApiError  # noqa: F401
from pilosa_tpu_torch.server.http import make_server, serve  # noqa: F401
