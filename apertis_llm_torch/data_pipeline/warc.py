"""Minimal WARC reader — pure Python, replaces the warcio dependency.

Reads (possibly gzipped) WARC files record-by-record and yields the HTML
payloads of ``response`` records, which is all the clean stage needs
(reference: src/data_pipeline/clean.py:15-67 via warcio's ArchiveIterator).

The port's copy of ``apertis_llm_tpu/data_pipeline/warc.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import gzip
import io
import logging
from typing import BinaryIO, Dict, Iterator, Optional, Tuple

logger = logging.getLogger(__name__)


def _read_headers(stream: BinaryIO) -> Optional[Dict[str, str]]:
    """Read a CRLF-terminated header block; None at EOF."""
    headers: Dict[str, str] = {}
    first = True
    while True:
        line = stream.readline()
        if not line:
            return None
        text = line.decode("utf-8", errors="replace").rstrip("\r\n")
        if first:
            if not text.strip():
                continue  # skip inter-record blank lines
            headers["__version__"] = text
            first = False
            continue
        if not text:
            return headers
        if ":" in text:
            key, _, value = text.partition(":")
            headers[key.strip().lower()] = value.strip()


def iter_warc_records(path: str) -> Iterator[Tuple[Dict[str, str], bytes]]:
    """Yield (warc_headers, raw_content) for each record."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        stream = io.BufferedReader(f)  # type: ignore[arg-type]
        while True:
            headers = _read_headers(stream)
            if headers is None:
                return
            if not headers.get("__version__", "").startswith("WARC/"):
                continue
            try:
                length = int(headers.get("content-length", "0"))
            except ValueError:
                length = 0
            content = stream.read(length)
            yield headers, content


def _split_http_payload(content: bytes) -> bytes:
    """Strip the HTTP response head from a response record's content."""
    sep = content.find(b"\r\n\r\n")
    if sep == -1:
        sep = content.find(b"\n\n")
        return content[sep + 2:] if sep != -1 else content
    return content[sep + 4:]


def iter_html_responses(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (target_uri, html_bytes) for each HTTP response record."""
    for headers, content in iter_warc_records(path):
        if headers.get("warc-type") != "response":
            continue
        uri = headers.get("warc-target-uri", "")
        yield uri, _split_http_payload(content)


def write_warc_response(stream: BinaryIO, uri: str, html: bytes) -> None:
    """Write one response record (used by tests/fixtures)."""
    http = (b"HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n\r\n" + html)
    head = (f"WARC/1.0\r\nWARC-Type: response\r\nWARC-Target-URI: {uri}\r\n"
            f"Content-Length: {len(http)}\r\n\r\n").encode()
    stream.write(head)
    stream.write(http)
    stream.write(b"\r\n\r\n")
