"""Error types of the SDA protocol (copy of ``sda_tpu/protocol/errors.py``).

The error kinds of the SDA wire protocol, which the REST layer maps onto
HTTP 401/403/400/500:
``InvalidCredentials``, ``PermissionDenied``, ``Invalid(reason)``, and a
catch-all internal error.
"""

from __future__ import annotations


class SdaError(Exception):
    """Base class for all SDA protocol errors."""


class InvalidCredentialsError(SdaError):
    """Authentication failed (wire: HTTP 401)."""


class PermissionDeniedError(SdaError):
    """Caller is authenticated but not allowed (wire: HTTP 403)."""


class InvalidRequestError(SdaError):
    """Malformed or inconsistent request (wire: HTTP 400)."""


class ServerError(SdaError):
    """Internal server failure (wire: HTTP 500)."""
