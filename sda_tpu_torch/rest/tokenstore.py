"""Client-side auth token store (copy of ``sda_tpu/rest/tokenstore.py``).

As the SDA HTTP client's tokenstore.rs:8-23 does: a random 32-char
alphanumeric token is generated on first use and persisted; the server
records it on first ``create_agent`` (trust-on-first-use) and demands it on
every later request. The file is ``sda_tpu``'s (``<dir>/http_token``), so
an identity directory made by either package works with the other.
"""

from __future__ import annotations

import os
import secrets
import string


class TokenStore:
    def __init__(self, path):
        self.path = os.path.join(str(path), "http_token")
        os.makedirs(str(path), mode=0o700, exist_ok=True)

    def get(self) -> str:
        try:
            with open(self.path) as f:
                return f.read().strip()
        except FileNotFoundError:
            alphabet = string.ascii_letters + string.digits
            token = "".join(secrets.choice(alphabet) for _ in range(32))
            fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "w") as f:
                f.write(token)
            return token
