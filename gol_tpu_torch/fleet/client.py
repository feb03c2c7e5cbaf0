"""Stdlib HTTP JSON client: the port's copy of ``gol_tpu/fleet/client.py``.

``submit`` speaks to a server through it. Everything here is urllib over
persistent-nothing (one request per connection). HTTP errors come back as
(status, payload) so callers branch on codes, while genuine connection
trouble (refused, reset, timeout) raises ``OSError``/``URLError`` for the
caller's liveness logic to classify.
"""

from __future__ import annotations

import http.client
import json
import urllib.error
import urllib.request


def http_exchange(
    method: str,
    url: str,
    body: dict | None = None,
    *,
    raw: bytes | None = None,
    timeout: float = 30.0,
    headers: dict | None = None,
    content_type: str | None = None,
):
    """One HTTP exchange -> (status, response content type, body bytes).

    The format-agnostic primitive under ``http_json``: the packed wire
    paths (io/wire.py) ride it directly — a packed result relay must hand
    the frame bytes through untouched, and a packed submit forward must
    carry its own Content-Type. ``content_type`` overrides the request
    body's type (default ``application/json``, byte-identical to the
    pre-wire client for every JSON caller). HTTP error statuses return
    normally; connection-level failures raise (URLError/OSError)."""
    if body is not None and raw is not None:
        raise ValueError("pass body or raw, not both")
    data = raw
    hdrs = {"Accept": "application/json"}
    if body is not None:
        data = json.dumps(body).encode("utf-8")
    if data is not None:
        hdrs["Content-Type"] = content_type or "application/json"
    if headers:
        hdrs.update(headers)
    req = urllib.request.Request(url, data=data, headers=hdrs, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read()
    except urllib.error.HTTPError as e:
        try:
            data = e.read()
        except http.client.HTTPException as torn:
            # An error response truncated mid-body: e.read() raises from
            # INSIDE this handler, where the sibling HTTPException clause
            # below cannot see it — normalize here too or the raw
            # IncompleteRead escapes every caller's classification.
            if isinstance(torn, OSError):
                raise
            raise ConnectionError(f"{type(torn).__name__}: {torn}") from torn
        return e.code, e.headers.get("Content-Type", ""), data
    except http.client.HTTPException as e:
        # Torn/garbled HTTP that is NOT already an OSError — a response
        # truncated mid-body raises IncompleteRead (an HTTPException
        # only), which every caller's transient-failure classification
        # would otherwise miss and crash on. A truncation IS connection
        # trouble: normalize it so liveness logic treats it like a reset.
        # RemoteDisconnected (HTTPException AND ConnectionResetError)
        # re-raises untouched — it already speaks OSError.
        if isinstance(e, OSError):
            raise
        raise ConnectionError(f"{type(e).__name__}: {e}") from e


def http_json(
    method: str,
    url: str,
    body: dict | None = None,
    *,
    raw: bytes | None = None,
    timeout: float = 30.0,
    headers: dict | None = None,
    content_type: str | None = None,
):
    """One JSON exchange -> (status, payload).

    ``raw`` forwards pre-encoded bytes verbatim (the router's submit path:
    the client's body was already parsed for placement; re-encoding a 17 MB
    board a second time would be pure tax). ``headers`` adds/overrides
    request headers (the router's trace-context stamp, obs/propagate.py —
    receivers that don't know a header ignore it). ``content_type``
    overrides the body's Content-Type (the packed wire forward). HTTP
    error statuses return normally; connection-level failures raise
    (URLError/OSError).
    """
    status, _ctype, data = http_exchange(
        method, url, body, raw=raw, timeout=timeout, headers=headers,
        content_type=content_type,
    )
    return status, _parse(data)


def _parse(raw: bytes):
    try:
        return json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return {"error": raw[:200].decode("utf-8", "replace")}


def probe(url: str, path: str = "/healthz", timeout: float = 2.0) -> dict | None:
    """GET url+path -> payload dict, or None when unreachable/unhealthy —
    the liveness primitive the health loop and manifest reattach share."""
    try:
        status, payload = http_json("GET", url.rstrip("/") + path,
                                    timeout=timeout)
    except (urllib.error.URLError, ConnectionError, OSError, ValueError):
        return None
    if status != 200 or not isinstance(payload, dict):
        return None
    return payload
