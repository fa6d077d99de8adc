"""Crash-safe replica pull: registry DB -> verified local install (port
of gamesmanmpi_tpu/registry/pull.py and its command tools/pull_db.py,
which is this module's :func:`main`).

    python -m gamesmanmpi_tpu_torch.registry.pull URL NAME... \
        [--dest DIR] [--fleet-manifest F [--control-url URL]] \
        [--solve SPEC] [--timeout S] [--json]

A replica never serves bytes it has not proved. Every pull stages into a
quarantine directory, resumes interrupted transfers with ranged fetches,
verifies every file's sha256 + crc32 against the registry manifest
before install, renames the staged directory into place, and runs the
serving workers' admission gate (``db.check.verify_for_serving``). Each
failure has one degrade path:

* transient transport errors (5xx, 429, connection reset/refused) -
  bounded exponential retry (resilience/retry.py), resuming from the
  bytes already staged;
* checksum mismatch - the staged file is quarantined ``*.corrupt`` and
  only it is fetched again; a second mismatch aborts the pull;
* death mid-pull (``registry.fetch``) - the staging dir survives and the
  next pull resumes from its verified prefix;
* death mid-install (``registry.install``) - the rename never happened,
  the fleet keeps its old epoch;
* failed admission - the install is quarantined ``*.corrupt`` and the
  fleet manifest is untouched.

``sync_fleet`` pulls every routed DB, lands the fleet manifest
(validated by ``load_fleet_manifest`` first), drives the supervisor's
rolling ``POST /reload`` and reports to its ``POST /registry-sync``
(serve/supervisor.py), so fleet ``/status`` shows the epochs.

The command returns 0 on success, 1 when a pull or the reload failed (the
fleet keeps its old epoch) and 2 on a usage error; an interrupted run is
safe to repeat. No torch: the admission gate hashes files with numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
import urllib.error
import urllib.request

from gamesmanmpi_tpu_torch.db.check import verify_for_serving
from gamesmanmpi_tpu_torch.db.format import DbFormatError, MANIFEST_NAME, file_sha256
from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.registry.server import _file_crc32, catalog_seal
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.resilience.retry import retry_call
from gamesmanmpi_tpu_torch.utils.env import env_float


class PullError(RuntimeError):
    """A pull failed for a non-transient reason (rot, bad registry)."""


def _timeout(timeout):
    return (
        env_float("GAMESMAN_REGISTRY_TIMEOUT_SECS", 30.0)
        if timeout is None else float(timeout)
    )


def _reclassify(e: urllib.error.HTTPError, url: str):
    """HTTP status -> the retry layer's transient/fatal vocabulary."""
    if e.code >= 500 or e.code == 429:
        # The retry classifier keys on message markers; "unavailable"
        # is the transport-hiccup word (resilience/retry.py).
        return RuntimeError(f"registry unavailable (HTTP {e.code}): {url}")
    return PullError(f"registry refused {url}: HTTP {e.code}")


def _get_json(url: str, timeout: float) -> dict:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raise _reclassify(e, url) from None


def fetch_catalog(registry_url: str, timeout=None, attempts=None,
                  registry=None) -> dict:
    """GET /catalog + seal verification: refuse a catalog whose ``seal``
    disagrees with the ``dbs`` object actually parsed."""
    timeout = _timeout(timeout)
    doc = retry_call(
        lambda: _get_json(f"{registry_url.rstrip('/')}/catalog", timeout),
        point="registry.fetch", attempts=attempts, registry=registry,
    )
    if doc.get("seal") != catalog_seal(doc.get("dbs", {})):
        raise PullError(
            f"{registry_url}: catalog seal mismatch — refusing to pull "
            "from an unverifiable catalog"
        )
    return doc


# Every staged byte is sha256/crc32-verified against the registry
# manifest before the atomic rename-install (pull_db), so a torn write
# here is caught, quarantined, and re-fetched — never installed.
# sealed-write: quarantine staging download, verified before install
def _fetch_ranged(url: str, tmp_path: pathlib.Path, expect_size: int,
                  timeout: float, registry) -> int:
    """One resumable transfer attempt: append from the staged offset.

    Returns bytes fetched this attempt. Raises the retry layer's
    transient/fatal vocabulary on transport errors.
    """
    have = tmp_path.stat().st_size if tmp_path.exists() else 0
    if have > expect_size:
        tmp_path.unlink()  # over-long stray: restart clean
        have = 0
    fetched = 0
    if have < expect_size:
        req = urllib.request.Request(url)
        if have:
            req.add_header("Range", f"bytes={have}-")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                if have and resp.status != 206:
                    # Server ignored the range — restart from zero.
                    tmp_path.unlink()
                    have = 0
                mode = "ab" if have else "wb"
                with open(tmp_path, mode) as fh:
                    while True:
                        block = resp.read(1 << 20)
                        if not block:
                            break
                        fh.write(block)
                        fetched += len(block)
        except urllib.error.HTTPError as e:
            raise _reclassify(e, url) from None
    if registry is not None and fetched:
        registry.counter(
            "gamesman_registry_fetch_bytes_total",
            "payload bytes fetched from the registry",
        ).inc(fetched)
    # The chaos seam: bytes are staged but unverified. torn truncates
    # the staged file and dies — the next pull's verify catches it.
    faults.fire("registry.fetch", path=str(tmp_path), file=tmp_path.name)
    return fetched


def _digests_ok(path: pathlib.Path, rec: dict) -> bool:
    if not path.exists() or path.stat().st_size != int(rec["size"]):
        return False
    if _file_crc32(path) != int(rec["crc32"]):
        return False
    return file_sha256(path) == rec["sha256"]


def _pull_file(blob_url: str, rec: dict, tmp_dir: pathlib.Path, *,
               timeout: float, attempts, registry, stats: dict) -> None:
    """Fetch + verify ONE file into the staging dir (resume, retry,
    quarantine-and-refetch on mismatch; second mismatch is fatal)."""
    tmp_path = tmp_dir / rec["name"]
    if _digests_ok(tmp_path, rec):
        stats["resumed_files"] += 1
        return  # fully staged and verified by a previous attempt
    for trial in (1, 2):
        retry_call(
            lambda: _fetch_ranged(
                blob_url, tmp_path, int(rec["size"]), timeout, registry
            ),
            point="registry.fetch", attempts=attempts, registry=registry,
        )
        if _digests_ok(tmp_path, rec):
            return
        # Checksum mismatch is FATAL for these bytes: quarantine the
        # staged copy and re-fetch this one file from scratch.
        registry.counter(
            "gamesman_registry_corrupt_files_total",
            "staged files that failed checksum verification",
        ).inc()
        quarantine = tmp_dir / f"{rec['name']}.corrupt"
        if quarantine.exists():
            quarantine.unlink()
        if tmp_path.exists():
            os.replace(tmp_path, quarantine)
        if trial == 1:
            stats["refetched_files"] += 1
    raise PullError(
        f"{rec['name']}: checksum mismatch twice (quarantined as "
        f"{rec['name']}.corrupt) — the registry is serving rot"
    )


def pull_db(registry_url: str, name: str, dest_root, *, timeout=None,
            attempts=None, registry=None, log=None) -> dict:
    """Pull DB ``name`` into ``dest_root/<name>@<epoch12>`` (see module
    docstring for the failure contract). Idempotent: an already
    installed, manifest-sha-verified epoch returns immediately; a
    damaged install is quarantined and re-pulled.

    -> {"name", "epoch", "db", "installed", "resumed_files",
        "refetched_files", "secs"}
    """
    t0 = time.monotonic()
    timeout = _timeout(timeout)
    reg = registry or default_registry()
    base = registry_url.rstrip("/")
    dest_root = pathlib.Path(dest_root)
    man = retry_call(
        lambda: _get_json(f"{base}/db/{name}/manifest", timeout),
        point="registry.fetch", attempts=attempts, registry=reg,
    )
    epoch = man["epoch"]
    final = dest_root / f"{name}@{epoch[:12]}"
    record = {
        "name": name, "epoch": epoch, "db": str(final),
        "installed": False, "resumed_files": 0, "refetched_files": 0,
    }

    def _done(result: str) -> dict:
        reg.counter(
            "gamesman_registry_pulls_total",
            "replica pulls by outcome", result=result,
        ).inc()
        record["secs"] = round(time.monotonic() - t0, 3)
        if log is not None:
            log({"phase": "registry_pull", "result": result, **record})
        return record

    if final.is_dir():
        manifest_path = final / MANIFEST_NAME
        if manifest_path.is_file() and file_sha256(manifest_path) == epoch:
            return _done("already_installed")
        # A directory squatting on the install name that is NOT the
        # sealed epoch: quarantine it and pull fresh.
        corrupt = pathlib.Path(f"{final}.corrupt")
        if corrupt.exists():
            import shutil
            shutil.rmtree(corrupt)
        os.replace(final, corrupt)
    tmp_dir = dest_root / ".registry_tmp" / f"{name}@{epoch[:12]}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    stats = {"resumed_files": 0, "refetched_files": 0}
    try:
        for rec in man["files"]:
            _pull_file(
                f"{base}/db/{name}/blob/{rec['name']}", rec, tmp_dir,
                timeout=timeout, attempts=attempts, registry=reg,
                stats=stats,
            )
    except PullError:
        _done("corrupt")
        raise
    record.update(stats)
    for stray in tmp_dir.glob("*.corrupt"):
        stray.unlink()  # quarantined copies were re-fetched clean
    # The chaos seam: every byte verified, nothing installed yet. A
    # kill here leaves only the staging dir; the re-pull finds it.
    faults.fire("registry.install", name=name, epoch=epoch[:12])
    os.replace(tmp_dir, final)
    record["installed"] = True
    # Admission gate — the same check a serving worker warm start runs.
    # A failed gate quarantines the install; the caller's fleet keeps
    # serving whatever it was serving.
    try:
        if file_sha256(final / MANIFEST_NAME) != epoch:
            raise DbFormatError(
                f"{final}: installed manifest sha != catalog epoch"
            )
        verify_for_serving(final)
    except DbFormatError as e:
        corrupt = pathlib.Path(f"{final}.corrupt")
        if corrupt.exists():
            import shutil
            shutil.rmtree(corrupt)
        os.replace(final, corrupt)
        record["installed"] = False
        _done("quarantined")
        raise PullError(
            f"{name}@{epoch[:12]}: admission gate failed, install "
            f"quarantined: {e}"
        ) from e
    reg.counter(
        "gamesman_registry_installs_total",
        "verified replica installs",
    ).inc()
    return _done("ok")


def _post_json(url: str, payload: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raise _reclassify(e, url) from None


def ensure_db(registry_url: str, name: str, spec: str | None = None, *,
              dest_root=None, timeout=None, attempts=None, registry=None,
              log=None) -> dict:
    """GET the DB's registry manifest; a 404 with a ``spec`` in hand
    becomes a solve-on-demand enqueue instead of a failure.

    -> {"status": "available", **manifest} (the DB is also pulled into
    ``dest_root`` when one is given — the result rides along as
    ``"pulled"``) or {"status": "queued"/"pending"/"running", **job
    record} — the caller polls until "available"."""
    timeout = _timeout(timeout)
    base = registry_url.rstrip("/")
    try:
        man = _get_json(f"{base}/db/{name}/manifest", timeout)
    except PullError:
        if not spec:
            raise
        job = _post_json(
            f"{base}/solve", {"name": name, "spec": spec}, timeout
        )
        return {"status": job.get("state", "queued"), **job}
    out = {"status": "available", **man}
    if dest_root is not None:
        out["pulled"] = pull_db(
            registry_url, name, dest_root, timeout=timeout,
            attempts=attempts, registry=registry, log=log,
        )
    return out


def sync_fleet(registry_url: str, names: list, fleet_manifest, dest_root,
               *, control_url: str | None = None, timeout=None,
               attempts=None, registry=None, log=None) -> dict:
    """Pull every DB in ``names``, land the fleet manifest atomically,
    and drive the supervisor's rolling reload (see module docstring).

    The new manifest is validated with ``load_fleet_manifest`` BEFORE it
    replaces the live one — a half-landed install fails validation and
    the old manifest (old epoch) stays in place. Reload + sync-state
    reporting are best-effort against ``control_url`` (the supervisor's
    control endpoint); without one, the caller owns the reload.
    """
    from gamesmanmpi_tpu_torch.serve.manifest import load_fleet_manifest

    timeout = _timeout(timeout)
    fleet_manifest = pathlib.Path(fleet_manifest)
    pulled, failed = [], []
    for name in names:
        try:
            pulled.append(
                pull_db(registry_url, name, dest_root, timeout=timeout,
                        attempts=attempts, registry=registry, log=log)
            )
        except (PullError, OSError, RuntimeError, KeyError) as e:
            failed.append({"name": name, "error": str(e)})
    result = {
        "pulled": pulled, "failed": failed, "rolled": False,
        "manifest": str(fleet_manifest),
    }
    if not pulled:
        result["status"] = "nothing_pulled"
        _report_sync(control_url, result, timeout)
        return result
    games = {}
    if fleet_manifest.exists():
        try:
            for rec in json.loads(fleet_manifest.read_text())["games"]:
                games[rec["name"]] = rec
        except (ValueError, KeyError, OSError):
            games = {}  # junk manifest: rebuild from the pulls alone
    for rec in pulled:
        games[rec["name"]] = {"name": rec["name"], "db": rec["db"]}
    doc = {"version": 1, "games": sorted(games.values(),
                                         key=lambda r: r["name"])}
    tmp = fleet_manifest.with_name(
        f"{fleet_manifest.name}.{os.getpid()}.tmp"
    )
    tmp.write_text(json.dumps(doc, indent=1))
    try:
        load_fleet_manifest(tmp)  # fail BEFORE any worker is touched
    except ValueError as e:
        tmp.unlink()
        result["status"] = "manifest_rejected"
        result["error"] = str(e)
        _report_sync(control_url, result, timeout)
        raise PullError(
            f"pulled manifest failed validation, fleet untouched: {e}"
        ) from e
    os.replace(tmp, fleet_manifest)
    result["status"] = "manifest_landed"
    if control_url:
        try:
            _post_json(f"{control_url.rstrip('/')}/reload", {}, timeout)
            result["rolled"] = True
            result["status"] = "rolled"
        except (OSError, RuntimeError, ValueError) as e:
            result["status"] = "reload_failed"
            result["error"] = str(e)
    _report_sync(control_url, result, timeout)
    return result


def _report_sync(control_url: str | None, result: dict,
                 timeout: float) -> None:
    """Best-effort sync-state report to the supervisor's control
    endpoint (shows up in fleet /status as ``registry_sync``)."""
    if not control_url:
        return
    payload = {
        "status": result.get("status"),
        "epochs": {p["name"]: p["epoch"][:12] for p in result["pulled"]},
        "failed": [f["name"] for f in result["failed"]],
        "wall_time": time.time(),
    }
    try:
        _post_json(
            f"{control_url.rstrip('/')}/registry-sync", payload, timeout
        )
    except (OSError, RuntimeError, ValueError):
        pass  # status reporting must never fail a sync


# ------------------------------------------------------- the command line


def _log(record):
    sys.stderr.write(json.dumps(record, default=str) + "\n")
    sys.stderr.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m gamesmanmpi_tpu_torch.registry.pull",
        description="pull verified DB epochs from a gamesman registry",
    )
    ap.add_argument("registry", help="registry base URL, e.g. http://host:9200")
    ap.add_argument("names", nargs="+", help="DB names to pull")
    ap.add_argument("--dest", default="dbs",
                    help="install root; DBs land as <dest>/<name>@<epoch>")
    ap.add_argument("--fleet-manifest", default=None,
                    help="fleet manifest to rewrite with the pulled epochs")
    ap.add_argument("--control-url", default=None,
                    help="supervisor control URL to POST /reload after a "
                         "manifest landing (requires --fleet-manifest)")
    ap.add_argument("--solve", metavar="SPEC", default=None,
                    help="if the (single) name is not in the catalog, queue "
                         "a solve-on-demand job for this game spec instead "
                         "of failing")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-request timeout (default "
                         "GAMESMAN_REGISTRY_TIMEOUT_SECS)")
    ap.add_argument("--json", action="store_true",
                    help="print the result record as JSON on stdout")
    args = ap.parse_args(argv)

    if args.control_url and not args.fleet_manifest:
        ap.error("--control-url requires --fleet-manifest")
    if args.solve and len(args.names) != 1:
        ap.error("--solve takes exactly one name")

    try:
        if args.fleet_manifest:
            result = sync_fleet(
                args.registry, args.names, args.fleet_manifest, args.dest,
                control_url=args.control_url, timeout=args.timeout,
                log=_log,
            )
            ok = result["status"] in ("rolled", "manifest_landed") or (
                result["status"] == "nothing_pulled" and not result["failed"]
            )
        elif args.solve:
            result = ensure_db(
                args.registry, args.names[0], spec=args.solve,
                dest_root=args.dest, timeout=args.timeout, log=_log,
            )
            ok = True
        else:
            pulls = []
            ok = True
            for name in args.names:
                try:
                    pulls.append(
                        pull_db(args.registry, name, args.dest,
                                timeout=args.timeout, log=_log)
                    )
                except PullError as e:
                    _log({"phase": "registry_pull", "name": name,
                          "error": str(e)})
                    ok = False
            result = {"pulled": pulls}
    except PullError as e:
        _log({"phase": "registry_pull", "error": str(e)})
        result, ok = {"error": str(e)}, False

    if args.json:
        print(json.dumps(result, indent=2, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
