"""Shared-secret HMAC envelope (reference
``horovod/runner/common/util/secret.py``); the port's copy of
``horovod_tpu/run/secret.py``, with the same environment name and
digest, so either package's launcher can sign for the other's workers.

Every rendezvous/notification message between launcher and workers is
signed with a per-job secret so a stray process on the same network
segment cannot impersonate the driver.  The secret travels only through
the worker environment (the launcher sets it when spawning), never over
the wire.
"""

from __future__ import annotations

import hmac
import hashlib
import secrets as _secrets

SECRET_ENV = "HVD_TPU_SECRET_KEY"
DIGEST = hashlib.sha256


def make_secret_key() -> str:
    """New per-job secret (hex, 256-bit)."""
    return _secrets.token_hex(32)


def compute_digest(secret_key: str, payload: bytes) -> str:
    return hmac.new(secret_key.encode(), payload, DIGEST).hexdigest()


def check_digest(secret_key: str, payload: bytes, digest: str) -> bool:
    want = compute_digest(secret_key, payload)
    return hmac.compare_digest(want, digest)
