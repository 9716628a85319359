"""Self-update: signed release check / download / stage / apply.

Role of the reference's update path (cmd/update.go:587 applyUpdate +
getUpdateReaderFromURL): fetch a release, verify a detached Ed25519
signature over the release info (the minisign role; same curve), and apply
it atomically with rollback. This build's "binary" is a Python package, so
apply = swap a staged release directory into place with os.replace and ask
for a restart (the reference also requires a restart after Apply).

Release layout at a base URL (https:// or file:// for air-gapped mirrors):

    RELEASE.json        {"version": ..., "sha256": ..., "archive": name}
    RELEASE.json.sig    Ed25519 signature over the exact RELEASE.json bytes
    <archive>           tar.gz with a single top-level directory

The public key (MINIO_TPU_UPDATE_PUBKEY, base64 raw 32 bytes) gates
everything: with it set, an unsigned or tampered release is rejected before
any byte of the archive is trusted; without it, check/download refuse
unless allow_unsigned=True was passed explicitly (the reference verifies
only when MINIO_UPDATE_MINISIGN_PUBKEY is configured, but defaulting open
would make the verification trivially skippable by deleting one env var).
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import os
import tarfile
import time
from dataclasses import dataclass

from ..utils import errors

PUBKEY_ENV = "MINIO_TPU_UPDATE_PUBKEY"


class UpdateError(errors.StorageError):
    pass


@dataclass
class ReleaseInfo:
    version: str
    sha256: str
    archive: str
    base_url: str

    @property
    def archive_url(self) -> str:
        return self.base_url.rstrip("/") + "/" + self.archive


def _fetch(url: str, max_bytes: int = 512 << 20) -> bytes:
    """Bounded fetch over https/http/file (file:// serves air-gapped
    mirrors; this environment has zero egress)."""
    if url.startswith("file://"):
        path = url[len("file://"):]
        try:
            with open(path, "rb") as f:
                data = f.read(max_bytes + 1)
        except OSError as e:
            raise UpdateError(f"fetch {url}: {e}") from e
    elif url.startswith(("http://", "https://")):
        from urllib.request import Request, urlopen

        try:
            with urlopen(Request(url, headers={"User-Agent": "minio_tpu-update"}), timeout=30) as r:
                data = r.read(max_bytes + 1)
        except OSError as e:
            raise UpdateError(f"fetch {url}: {e}") from e
    else:
        raise UpdateError(f"unsupported URL scheme: {url!r}")
    if len(data) > max_bytes:
        raise UpdateError(f"release object exceeds {max_bytes} bytes")
    return data


def _verify_signature(payload: bytes, signature: bytes, pubkey_b64: str) -> None:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

    try:
        raw = base64.b64decode(pubkey_b64)
        key = Ed25519PublicKey.from_public_bytes(raw)
    except Exception as e:  # noqa: BLE001 - malformed key config
        raise UpdateError(f"bad update public key: {e}") from e
    try:
        key.verify(signature, payload)
    except InvalidSignature:
        raise UpdateError("release signature verification FAILED")


def check_update(
    base_url: str, pubkey_b64: str | None = None, allow_unsigned: bool = False
) -> ReleaseInfo:
    """Fetch + verify RELEASE.json; -> ReleaseInfo. Verification is
    mandatory unless allow_unsigned is passed explicitly."""
    pubkey_b64 = pubkey_b64 if pubkey_b64 is not None else os.environ.get(PUBKEY_ENV, "")
    manifest = _fetch(base_url.rstrip("/") + "/RELEASE.json", max_bytes=1 << 20)
    if pubkey_b64:
        sig = _fetch(base_url.rstrip("/") + "/RELEASE.json.sig", max_bytes=4096)
        _verify_signature(manifest, sig, pubkey_b64)
    elif not allow_unsigned:
        raise UpdateError(
            f"no update public key configured ({PUBKEY_ENV}); "
            "refusing unsigned release (pass allow_unsigned to override)"
        )
    try:
        doc = json.loads(manifest)
        info = ReleaseInfo(
            version=str(doc["version"]),
            sha256=str(doc["sha256"]),
            archive=str(doc["archive"]),
            base_url=base_url,
        )
    except (ValueError, KeyError, TypeError) as e:
        raise UpdateError(f"bad RELEASE.json: {e}") from e
    # Both fields land in filesystem paths (archive in the URL join,
    # version in the staging dir name): a mirror must not be able to steer
    # rmtree/os.replace outside the staging root.
    import re

    if "/" in info.archive or info.archive.startswith("."):
        raise UpdateError(f"unsafe archive name {info.archive!r}")
    if not re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}", info.version):
        raise UpdateError(f"unsafe version string {info.version!r}")
    return info


def download_and_stage(info: ReleaseInfo, stage_root: str) -> str:
    """Fetch the archive, pin its sha256 against the (signed) manifest,
    and extract into stage_root/<version>/ with traversal-safe paths.
    Returns the staged release directory."""
    blob = _fetch(info.archive_url)
    digest = hashlib.sha256(blob).hexdigest()
    if digest != info.sha256.lower():
        raise UpdateError(
            f"archive sha256 mismatch: manifest {info.sha256}, got {digest}"
        )
    dest = os.path.join(stage_root, f"minio_tpu-{info.version}")
    tmp = dest + ".staging"
    if os.path.exists(tmp):
        import shutil

        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tf:
            for m in tf.getmembers():
                # Path-traversal / link-escape guard: every entry must land
                # strictly inside the staging dir, and symlinks are refused
                # outright (a link to /etc would survive the prefix check).
                target = os.path.realpath(os.path.join(tmp, m.name))
                if not target.startswith(os.path.realpath(tmp) + os.sep):
                    raise UpdateError(f"archive entry escapes staging dir: {m.name!r}")
                if m.issym() or m.islnk():
                    raise UpdateError(f"archive contains a link entry: {m.name!r}")
                if not (m.isfile() or m.isdir()):
                    raise UpdateError(f"unsupported archive entry type: {m.name!r}")
            tf.extractall(tmp, filter="data")
    except (tarfile.TarError, OSError) as e:
        raise UpdateError(f"archive extraction failed: {e}") from e
    if os.path.exists(dest):
        import shutil

        shutil.rmtree(dest)
    os.replace(tmp, dest)
    return dest


def apply_staged(staged_dir: str, install_dir: str) -> str:
    """Swap the staged release tree into install_dir, keeping the previous
    tree as a .previous rollback (the selfupdate.Apply/Rollback role).
    Returns the backup path; a restart loads the new code.

    The incoming tree is first materialized as a SIBLING of install_dir
    (same filesystem — the stage dir often lives on another mount, where a
    direct os.replace would fail with EXDEV every time; copytree covers
    that), so both renames in the swap are same-fs and the rollback path
    stays valid until the new tree is in place."""
    if not os.path.isdir(staged_dir):
        raise UpdateError(f"staged release missing: {staged_dir}")
    import shutil

    install_dir = install_dir.rstrip("/")
    backup = install_dir + ".previous"
    incoming = install_dir + ".incoming"
    if os.path.exists(incoming):
        shutil.rmtree(incoming)
    try:
        os.replace(staged_dir, incoming)
    except OSError:  # cross-device stage dir
        shutil.copytree(staged_dir, incoming)
    if os.path.exists(backup):
        shutil.rmtree(backup)  # stale rollback; the incoming tree is ready
    os.replace(install_dir, backup)
    try:
        os.replace(incoming, install_dir)
    except OSError:
        os.replace(backup, install_dir)  # rollback
        raise
    return backup


def update_status() -> dict:
    import minio_tpu_torch

    return {
        "version": getattr(minio_tpu_torch, "__version__", "dev"),
        "pubkey_configured": bool(os.environ.get(PUBKEY_ENV, "")),
        "checked_at": time.time(),
    }
