"""A small HTTP client over the standard library.

The JAX package's LlamaParse and OpenAI clients call ``httpx``; the port
uses ``urllib.request`` so that it needs no package beyond torch. What the
two clients need of it:

- :class:`Client` sends one request and returns a :class:`Response` for
  every status (a 4xx or 5xx is a response, not an exception); redirects
  are not followed, as ``httpx`` does not follow them by default; proxies
  come from the environment, as in ``httpx``;
- :class:`TransportError` is a request that got no response: a refused or
  reset connection, a timeout, a malformed reply;
- :class:`HTTPStatusError` is raised by the callers on a 5xx they retry;
- :func:`encode_multipart` writes a ``multipart/form-data`` body with the
  form fields ``httpx`` writes for ``data=`` and ``files=`` (fields first,
  then files; HTML5 escaping of names).

The clients take any object with :class:`Client`'s ``get``/``post`` in its
place.
"""

from __future__ import annotations

import json
import os
import re
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from http.client import HTTPException
from typing import Mapping, Optional, Sequence, Tuple


class HTTPError(Exception):
    """Base of the transport's errors."""


class TransportError(HTTPError):
    """No response: connect, timeout, reset or protocol failure."""


class HTTPStatusError(HTTPError):
    """A response whose status the caller treats as a failure."""

    def __init__(self, message: str, response: "Response"):
        super().__init__(message)
        self.response = response


@dataclass
class Response:
    status_code: int
    content: bytes = b""

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    @property
    def is_error(self) -> bool:
        return self.status_code >= 400

    def json(self):
        return json.loads(self.content)


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None  # the 3xx comes back as a response


class Client:
    """Blocking requests with one timeout (seconds) for connect and read."""

    def __init__(self, timeout: float = 120.0):
        self.timeout = timeout
        self._opener = urllib.request.build_opener(_NoRedirect)

    def request(
        self,
        method: str,
        url: str,
        headers: Optional[Mapping[str, str]] = None,
        body: Optional[bytes] = None,
    ) -> Response:
        req = urllib.request.Request(url, data=body, headers=dict(headers or {}),
                                     method=method)
        try:
            with self._opener.open(req, timeout=self.timeout) as resp:
                return Response(resp.status, resp.read())
        except urllib.error.HTTPError as e:
            try:
                content = e.read()
            except (OSError, HTTPException):
                content = b""
            return Response(e.code, content)
        except urllib.error.URLError as e:
            raise TransportError(str(e.reason)) from e
        except (OSError, HTTPException) as e:
            raise TransportError(str(e) or type(e).__name__) from e

    def get(
        self,
        url: str,
        headers: Optional[Mapping[str, str]] = None,
        params: Optional[Mapping[str, str]] = None,
    ) -> Response:
        if params:
            url = f"{url}{'&' if '?' in url else '?'}{urllib.parse.urlencode(params)}"
        return self.request("GET", url, headers)

    def post(
        self,
        url: str,
        headers: Optional[Mapping[str, str]] = None,
        body: Optional[bytes] = None,
    ) -> Response:
        return self.request("POST", url, headers, body)


def encode_json(payload) -> bytes:
    """A JSON request body, compact and UTF-8, as ``httpx``'s ``json=``."""
    return json.dumps(payload, ensure_ascii=False, separators=(",", ":"),
                      allow_nan=False).encode("utf-8")


_FORM_ESCAPES = {'"': "%22", "\\": "\\\\"}
_FORM_ESCAPES.update({chr(c): f"%{c:02X}" for c in range(0x20) if c != 0x1B})
_FORM_ESCAPE_RE = re.compile("|".join(re.escape(c) for c in _FORM_ESCAPES))


def _form_param(name: str, value: str) -> bytes:
    return f'{name}="{_FORM_ESCAPE_RE.sub(lambda m: _FORM_ESCAPES[m.group(0)], value)}"'.encode()


def encode_multipart(
    data: Mapping[str, str],
    files: Sequence[Tuple[str, str, bytes, str]],
) -> Tuple[bytes, str]:
    """(body, content type) of a form with text fields ``data`` and file
    fields ``(field name, filename, bytes, MIME type)``."""
    boundary = os.urandom(16).hex()
    sep = f"--{boundary}\r\n".encode()
    parts = []
    for name, value in data.items():
        parts += [sep, b"Content-Disposition: form-data; ", _form_param("name", name),
                  b"\r\n\r\n", value.encode("utf-8"), b"\r\n"]
    for name, filename, content, mime in files:
        parts += [sep, b"Content-Disposition: form-data; ", _form_param("name", name),
                  b"; ", _form_param("filename", filename),
                  f"\r\nContent-Type: {mime}\r\n\r\n".encode(), content, b"\r\n"]
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"
