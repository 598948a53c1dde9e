"""HS256 JWT encode/decode over the standard library (the port's copy of
``opsagent_tpu/server/jwtauth.py``): tokens carry ``username``, ``iat`` and
``exp`` (24 hours), signed with the key the server keeps in the global
store; the same key, claims and ``iat`` give the JAX package's bytes.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any


class JWTError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _unb64url(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def encode(payload: dict[str, Any], key: str) -> str:
    header = {"alg": "HS256", "typ": "JWT"}
    signing_input = (
        _b64url(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url(json.dumps(payload, separators=(",", ":")).encode())
    )
    sig = hmac.new(key.encode(), signing_input.encode(), hashlib.sha256).digest()
    return signing_input + "." + _b64url(sig)


def decode(token: str, key: str) -> dict[str, Any]:
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
    except ValueError as e:
        raise JWTError("malformed token") from e
    signing_input = f"{header_b64}.{payload_b64}"
    expected = hmac.new(key.encode(), signing_input.encode(), hashlib.sha256).digest()
    if not hmac.compare_digest(expected, _unb64url(sig_b64)):
        raise JWTError("invalid signature")
    try:
        header = json.loads(_unb64url(header_b64))
        payload = json.loads(_unb64url(payload_b64))
    except (ValueError, json.JSONDecodeError) as e:
        raise JWTError("malformed token body") from e
    if header.get("alg") != "HS256":
        raise JWTError(f"unsupported alg {header.get('alg')}")
    exp = payload.get("exp")
    if exp is not None and time.time() > float(exp):
        raise JWTError("token expired")
    return payload


def issue_token(username: str, key: str, ttl_seconds: int = 24 * 3600) -> str:
    now = int(time.time())
    return encode({"username": username, "iat": now, "exp": now + ttl_seconds}, key)
