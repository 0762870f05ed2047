"""The HTTP binding of the service seam (counterpart of ``sda_tpu/rest``):
the asyncio server, the ``http.client`` client proxy, the client's token
store and the negotiated binary wire codec the hot routes ride
(``wire``)."""

from . import wire
from .client import SdaHttpClient
from .server import (
    listen,
    make_handler,
    serve_background,
    serve_background_multi,
    serve_forever,
)
from .tokenstore import TokenStore

__all__ = [
    "SdaHttpClient",
    "TokenStore",
    "listen",
    "make_handler",
    "serve_background",
    "serve_background_multi",
    "serve_forever",
    "wire",
]
