"""Registry server: a sha256-sealed catalog of DB epochs over HTTP (port
of gamesmanmpi_tpu/registry/server.py: the same routes, bodies, status
codes, catalog and root layout, so either package's pull client installs
from the other's registry).

Stdlib ``ThreadingHTTPServer``, one thread per connection:

    GET  /catalog               the sealed catalog: every published DB's
                                name, epoch (sha256 of its manifest.json)
                                and per-file digests; ``seal`` is the
                                sha256 of the canonical ``dbs`` JSON
    GET  /db/<name>/manifest    one DB's registry record (files with
                                size, sha256 and crc32)
    GET  /db/<name>/blob/<file> payload bytes; honors ``Range:
                                bytes=N-[M]`` so an interrupted pull
                                resumes
    POST /publish               {"name": ..., "dir": ...}: install a
                                server-local DB directory as a new epoch
                                (payload first, ``catalog.json`` replaced
                                last)
    POST /solve                 {"spec": ..., "name": ...}: enqueue a
                                solve-on-demand job (registry/jobs.py);
                                429 with ``Retry-After`` when admission
                                refuses
    GET  /jobs                  job-queue snapshot
    GET  /healthz               liveness + catalog summary

Registry root layout::

    root/
      catalog.json              sealed catalog (atomic tmp+replace)
      dbs/<name>/<epoch12>/     one immutable payload per epoch
      jobs.jsonl                solve-on-demand ledger (when enabled)

No torch: the server only hashes and streams files.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import shutil
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gamesmanmpi_tpu_torch.db.format import (
    MANIFEST_NAME,
    DbFormatError,
    file_sha256,
    read_manifest,
)
from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.resilience import faults

#: Same routing-key shape as serve/manifest.py: a name must survive a
#: URL path segment (and a directory name) un-escaped.
_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]+$")

CATALOG_NAME = "catalog.json"
CATALOG_VERSION = 1

#: One ranged read per loop iteration when streaming a blob.
_BLOB_CHUNK = 1 << 20


def _file_crc32(path, chunk: int = 1 << 22) -> int:
    """Streaming crc32 (cheap second witness next to the sha256 — a
    pull client can spot a torn range without re-hashing the prefix)."""
    crc = 0
    with open(path, "rb") as fh:  # store-io: registry digests raw payload bytes
        while True:
            block = fh.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def catalog_seal(dbs: dict) -> str:
    """sha256 of the canonical ``dbs`` JSON — the catalog's seal.

    Canonical = sorted keys, no whitespace variance; the client recomputes
    this over the ``dbs`` object it parsed and refuses a catalog whose
    seal disagrees (a truncated or hand-edited catalog must not drive a
    pull)."""
    blob = json.dumps(dbs, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def load_catalog(root) -> dict:
    """Read the sealed catalog (empty catalog when none exists yet)."""
    path = pathlib.Path(root) / CATALOG_NAME
    if not path.exists():
        return {"version": CATALOG_VERSION, "dbs": {}, "seal": catalog_seal({})}
    doc = json.loads(path.read_text())
    if doc.get("version") != CATALOG_VERSION:
        raise ValueError(
            f"{path}: catalog version {doc.get('version')!r}, expected "
            f"{CATALOG_VERSION}"
        )
    return doc


def _catalog_doc(dbs: dict) -> dict:
    return {"version": CATALOG_VERSION, "dbs": dbs,
            "seal": catalog_seal(dbs)}


def _seal_catalog(root, dbs: dict) -> dict:
    """Atomically replace the catalog with a freshly sealed one."""
    root = pathlib.Path(root)
    doc = _catalog_doc(dbs)
    tmp = root / f"{CATALOG_NAME}.{os.getpid()}.tmp"
    tmp.write_text(json.dumps(doc, indent=1, sort_keys=True))
    os.replace(tmp, root / CATALOG_NAME)
    return doc


def publish_db(root, name: str, src_dir, registry=None) -> dict:
    """Install ``src_dir`` (a finalized export-db directory) as epoch
    ``sha256(manifest.json)`` of DB ``name`` and seal the catalog.

    Write-then-seal (GM801/GM802 discipline): the payload directory is
    copied to a tmp sibling and renamed into place FIRST; the catalog —
    the only thing readers trust — is replaced LAST. A crash between the
    two leaves an orphan payload the next publish of the same epoch
    adopts, and the old catalog stays authoritative. Publishing an epoch
    the catalog already names is a no-op (returns the existing record).

    Returns the catalog record for ``name``. Raises ``ValueError`` /
    ``DbFormatError`` on a bad name or a directory that is not a
    finalized DB.
    """
    root = pathlib.Path(root)
    src = pathlib.Path(src_dir)
    if not _NAME_RE.match(name or ""):
        raise ValueError(f"registry DB name {name!r} is not a url-safe token")
    read_manifest(src)  # refuse anything that is not a finalized DB
    epoch = file_sha256(src / MANIFEST_NAME)
    dbs = load_catalog(root)["dbs"]
    existing = dbs.get(name)
    if existing is not None and existing["epoch"] == epoch:
        return existing
    rel = f"dbs/{name}/{epoch[:12]}"
    final = root / rel
    if not final.is_dir():
        tmp_payload = root / "dbs" / name / f".tmp-{epoch[:12]}-{os.getpid()}"
        if tmp_payload.exists():
            shutil.rmtree(tmp_payload)
        tmp_payload.mkdir(parents=True)
        for entry in sorted(src.iterdir()):
            if entry.is_file():
                shutil.copyfile(entry, tmp_payload / entry.name)
        os.replace(tmp_payload, final)
    files = []
    for entry in sorted(final.iterdir()):
        if not entry.is_file():
            continue
        files.append({
            "name": entry.name,
            "size": entry.stat().st_size,
            "sha256": file_sha256(entry),
            "crc32": _file_crc32(entry),
        })
    record = {
        "epoch": epoch,
        "path": rel,
        "files": files,
        "published_time": time.time(),
    }
    # The chaos seam: payload is fully installed, the catalog still
    # names the OLD epoch. A kill here must leave a working registry.
    faults.fire("registry.publish", name=name, epoch=epoch[:12])
    dbs[name] = record
    _seal_catalog(root, dbs)
    (registry or default_registry()).counter(
        "gamesman_registry_publishes_total",
        "DB epochs published into the registry catalog",
    ).inc()
    return record


# wire: 429-retry-after
class _RegistryHandler(BaseHTTPRequestHandler):
    server_version = "gamesman-registry/1"
    protocol_version = "HTTP/1.1"
    timeout = 30

    def log_message(self, fmt, *args):
        pass

    # self.server is the _RegistryHTTPServer below.

    def _send_json(self, code: int, payload: dict, headers=None) -> None:
        body = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def _read_body(self) -> dict | None:
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if not 0 < length <= (1 << 20):
                return None
            return json.loads(self.rfile.read(length))
        except (ValueError, OSError):
            return None

    def do_GET(self):  # noqa: N802 - http.server API
        srv = self.server.registry_server
        if self.path == "/catalog":
            self._send_json(200, load_catalog(srv.root))
        elif self.path == "/healthz":
            catalog = load_catalog(srv.root)
            self._send_json(200, {
                "status": "ok",
                "kind": "registry",
                "dbs": sorted(catalog["dbs"]),
                "jobs": srv.queue.snapshot() if srv.queue else None,
            })
        elif self.path == "/jobs":
            if srv.queue is None:
                self._send_json(404, {"error": "no job queue configured"})
            else:
                self._send_json(200, srv.queue.snapshot())
        elif self.path.startswith("/db/"):
            self._get_db(srv)
        else:
            self._send_json(404, {"error": f"no such path {self.path!r}"})

    def _get_db(self, srv) -> None:
        parts = self.path.split("/")  # ['', 'db', name, what, (file)]
        if len(parts) < 4 or not _NAME_RE.match(parts[2]):
            self._send_json(404, {"error": f"no such path {self.path!r}"})
            return
        name = parts[2]
        record = load_catalog(srv.root)["dbs"].get(name)
        if record is None:
            self._send_json(404, {
                "error": f"no such DB {name!r}",
                "solve_hint": "POST /solve {\"name\": ..., \"spec\": ...} "
                "to queue an on-demand solve" if srv.queue else None,
            })
            return
        if parts[3] == "manifest" and len(parts) == 4:
            self._send_json(200, {"name": name, **record})
        elif parts[3] == "blob" and len(parts) == 5:
            self._send_blob(srv, record, parts[4])
        else:
            self._send_json(404, {"error": f"no such path {self.path!r}"})

    def _send_blob(self, srv, record: dict, filename: str) -> None:
        # Only files the sealed record names are reachable — the record
        # is the allowlist, so traversal is impossible by construction.
        rec = next(
            (f for f in record["files"] if f["name"] == filename), None
        )
        if rec is None:
            self._send_json(404, {"error": f"no such file {filename!r}"})
            return
        path = pathlib.Path(srv.root) / record["path"] / filename
        size = rec["size"]
        start, end = 0, size
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            lo, _, hi = rng[len("bytes="):].partition("-")
            try:
                start = int(lo) if lo else 0
                end = int(hi) + 1 if hi else size
            except ValueError:
                start, end = 0, size
            if not 0 <= start <= end <= size:
                self._send_json(416, {"error": f"bad range {rng!r}"})
                return
        try:
            self.send_response(206 if (start, end) != (0, size) else 200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Length", str(end - start))
            if (start, end) != (0, size):
                self.send_header(
                    "Content-Range", f"bytes {start}-{end - 1}/{size}"
                )
            self.end_headers()
            sent = 0
            # store-io: registry streams raw payload bytes to pull clients
            with open(path, "rb") as fh:
                fh.seek(start)
                remaining = end - start
                while remaining > 0:
                    block = fh.read(min(_BLOB_CHUNK, remaining))
                    if not block:
                        break
                    self.wfile.write(block)
                    sent += len(block)
                    remaining -= len(block)
            srv.registry.counter(
                "gamesman_registry_blob_bytes_total",
                "payload bytes streamed to pull clients",
            ).inc(sent)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def do_POST(self):  # noqa: N802 - http.server API
        srv = self.server.registry_server
        body = self._read_body()
        self.close_connection = True
        if body is None:
            self._send_json(400, {"error": "body must be a small JSON object"})
            return
        if self.path == "/publish":
            try:
                record = publish_db(
                    srv.root, str(body.get("name") or ""), body.get("dir"),
                    registry=srv.registry,
                )
            except (ValueError, DbFormatError, OSError, TypeError) as e:
                self._send_json(400, {"error": str(e)})
                return
            self._send_json(200, {"ok": True, "epoch": record["epoch"]})
        elif self.path == "/solve":
            if srv.queue is None:
                self._send_json(404, {"error": "no job queue configured"})
                return
            from gamesmanmpi_tpu_torch.registry.jobs import QueueRefused
            try:
                job = srv.queue.enqueue(
                    str(body.get("spec") or ""),
                    name=str(body.get("name") or "") or None,
                )
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            except QueueRefused as e:
                # Refusal is load shedding, not failure: tell pull
                # clients when to come back instead of letting them
                # hammer a full queue.
                self._send_json(429, {"error": str(e)},
                                headers={"Retry-After": "5"})
                return
            self._send_json(202, {"ok": True, **job})
        else:
            self._send_json(404, {"error": f"no such path {self.path!r}"})


class _RegistryHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, registry_server):
        super().__init__(addr, _RegistryHandler)
        self.registry_server = registry_server


class RegistryServer:
    """One registry root served over HTTP (see module docstring)."""

    def __init__(self, root, host: str = "127.0.0.1", port: int = 0,
                 queue=None, registry=None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.queue = queue
        self.registry = registry or default_registry()
        self._httpd = _RegistryHTTPServer((host, port), self)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "RegistryServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="gamesman-registry", daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
