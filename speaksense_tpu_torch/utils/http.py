"""HTTP helpers: response envelope + audio download.

The port's own copy of `speaksense_tpu/utils/http.py`,
with the same names and behaviour.

Mirror of the reference's src/utils/http.rs: the `HttpResponse{code, message,
body}` envelope used by the REST /asr routes and `download_audio` (filename
from the last URL path segment, GET, write to the audio dir)."""

from __future__ import annotations

import logging
import urllib.request
from dataclasses import dataclass
from pathlib import Path
from typing import Any
from urllib.parse import urlparse

log = logging.getLogger(__name__)


@dataclass
class HttpResponse:
    code: int
    message: str
    body: Any

    def to_dict(self) -> dict:
        return {"code": self.code, "message": self.message, "body": self.body}


def urlopen(request: urllib.request.Request, timeout: float):
    """`urllib.request.urlopen` limited to what `requests` opens: http and
    https (urllib alone would also read file: and ftp: URLs). A status of
    400 or more raises `urllib.error.HTTPError`."""
    scheme = urlparse(request.full_url).scheme
    if scheme not in ("http", "https"):
        raise ValueError(f"unsupported URL scheme {scheme!r}: {request.full_url}")
    return urllib.request.urlopen(request, timeout=timeout)


def download_audio(url: str, dest_dir: str | Path, timeout: float = 120.0,
                   prefix: str = "") -> Path:
    """Download `url` into dest_dir, named by the last path segment
    (reference http.rs:21-58). Raises on HTTP errors.

    prefix: caller-supplied uniquifier (e.g. the task id). Without it,
    concurrent task workers downloading URLs that share a basename
    overwrite/delete each other's files mid-read (the reference has the
    same hazard but runs a single worker)."""
    name = urlparse(url).path.rstrip("/").rsplit("/", 1)[-1]
    if not name:
        raise ValueError(f"invalid URL, no filename found: {url}")
    if prefix:
        name = f"{prefix}_{name}"
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / name
    log.info("downloading %s -> %s", url, dest)
    with urlopen(urllib.request.Request(url), timeout) as resp:
        dest.write_bytes(resp.read())
    return dest
