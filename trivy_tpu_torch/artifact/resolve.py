"""Image reference resolution chain (reference:
``trivy_tpu/artifact/resolve.py``, after trivy's
pkg/fanal/image/image.go:47-105 — tryDockerd → tryPodman →
tryContainerd → tryRemote).

``resolve_image(ref)`` walks the same fallback order:

1. archive/layout — a path to a docker-save tar, OCI tar, or OCI dir,
2. daemon — a Docker/Podman socket exporting the image as a tarball
   (``docker save`` over the HTTP API; probed, clean error when no
   socket is up),
3. containerd — the containerd socket, exported through the ``ctr``
   CLI into an OCI archive (CONTAINERD_ADDRESS/NAMESPACE honored),
4. registry — a ``RegistryClient`` implementing
   ``pull(ref) -> ImageSource`` over ``registry.DistributionClient``;
   a pull that fails says that a remote registry needs network
   egress. A fake client injects in tests.

The per-target ingest budget rides every leg. Host only: the card
sees the image only once it is loaded, through the walk and the
sieve.
"""

from __future__ import annotations

import atexit
import http.client
import logging
import os
import socket
import tempfile
from typing import Optional

from .image import ImageSource, load_image

log = logging.getLogger("trivy_tpu_torch.artifact.resolve")

def _default_sockets() -> tuple:
    """Docker then podman, system then rootless (the reference's
    tryDockerd → tryPodman order; podman honors XDG_RUNTIME_DIR for
    rootless sockets, ref pkg/fanal/image/daemon/podman.go)."""
    out = ["/var/run/docker.sock", "/run/podman/podman.sock"]
    xdg = os.environ.get("XDG_RUNTIME_DIR")
    if xdg:
        out.append(os.path.join(xdg, "podman", "podman.sock"))
    try:
        out.append(f"/run/user/{os.getuid()}/podman/podman.sock")
    except AttributeError:       # pragma: no cover - non-posix
        pass
    return tuple(out)


DOCKER_SOCKETS = _default_sockets()


class ResolveError(ValueError):
    pass


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, sock_path: str, timeout: float = 60.0):
        super().__init__("localhost", timeout=timeout)
        self._sock_path = sock_path

    def connect(self):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self._sock_path)
        self.sock = s


class DaemonClient:
    """Docker-API image export (the tryDockerd/tryPodman legs).
    ``GET /images/<ref>/get`` streams a docker-save tarball."""

    def __init__(self, sockets=DOCKER_SOCKETS):
        self.sockets = sockets

    def available_socket(self) -> Optional[str]:
        for path in self.sockets:
            if os.path.exists(path):
                return path
        return None

    def export(self, ref: str) -> str:
        sock_path = self.available_socket()
        if sock_path is None:
            raise ResolveError("no container daemon socket found")
        conn = _UnixHTTPConnection(sock_path)
        try:
            conn.request("GET", f"/images/{ref}/get")
            resp = conn.getresponse()
            if resp.status != 200:
                detail = resp.read(512).decode("utf-8", "replace")
                raise ResolveError(
                    f"daemon export failed ({resp.status}): "
                    f"{detail}")
            fd, tmp = tempfile.mkstemp(suffix=".tar",
                                       prefix="trivy-tpu-daemon-")
            try:
                with os.fdopen(fd, "wb") as f:
                    while True:
                        chunk = resp.read(1 << 20)
                        if not chunk:
                            break
                        f.write(chunk)
            except (OSError, http.client.HTTPException):
                os.unlink(tmp)
                raise
            return tmp
        except (OSError, http.client.HTTPException) as e:
            raise ResolveError(f"daemon error: {e}")
        finally:
            conn.close()


class ContainerdClient:
    """The tryContainerd leg (ref
    pkg/fanal/image/daemon/containerd.go): containerd's socket
    speaks gRPC, so instead of a protobuf client this exports the
    image through the stock ``ctr images export`` CLI into an OCI
    archive — same socket probe (CONTAINERD_ADDRESS, default
    /run/containerd/containerd.sock), same CONTAINERD_NAMESPACE
    default, same observable result (an archive the image loader
    reads)."""

    DEFAULT_SOCKET = "/run/containerd/containerd.sock"

    def __init__(self, address: Optional[str] = None,
                 namespace: str = ""):
        # None = env/default probing; "" = leg disabled (the
        # injection seam, like DaemonClient(sockets=()))
        if address is None:
            address = os.environ.get("CONTAINERD_ADDRESS",
                                     self.DEFAULT_SOCKET)
        self.address = address
        self.namespace = namespace or os.environ.get(
            "CONTAINERD_NAMESPACE", "default")

    def available(self) -> bool:
        return bool(self.address) and os.path.exists(self.address)

    def export(self, ref: str) -> str:
        import shutil
        import subprocess
        ctr = shutil.which("ctr")
        if ctr is None:
            raise ResolveError(
                "containerd socket is up but the 'ctr' CLI is not "
                "installed (needed to export the image)")
        fd, tmp = tempfile.mkstemp(suffix=".tar",
                                   prefix="trivy-tpu-containerd-")
        os.close(fd)
        cmd = [ctr, "--address", self.address,
               "--namespace", self.namespace,
               "images", "export", tmp, ref]
        try:
            proc = subprocess.run(cmd, capture_output=True,
                                  text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            os.unlink(tmp)
            raise ResolveError(f"containerd export failed: {e}")
        if proc.returncode != 0:
            os.unlink(tmp)
            raise ResolveError(
                "containerd export failed: "
                f"{proc.stderr.strip()[:300]}")
        return tmp


class RegistryClient:
    """The tryRemote leg: the real OCI distribution client
    (artifact/registry.py — token auth, platform select, blob
    pulls). Loopback registries work anywhere; remote hosts
    additionally need network egress, and the error says so."""

    def __init__(self, **kwargs):
        from .registry import DistributionClient
        self._client = DistributionClient(**kwargs)

    def pull(self, ref: str, budget=None) -> ImageSource:
        from .registry import RegistryError
        try:
            return self._client.pull(ref, budget=budget)
        except (RegistryError, KeyError, ValueError, OSError) as e:
            # KeyError/ValueError: malformed or schema-1 manifests
            # (no 'config' key, non-JSON body); OSError: temp layout
            raise ResolveError(
                f"cannot pull {ref!r}: {e!r} (no egress here? "
                f"provide --input <tarball> or an OCI layout "
                f"directory)")


def _loaded_tmp(tmp: str, ref: str, name: Optional[str],
                budget=None) -> ImageSource:
    """Load an exported archive whose layers are read lazily during
    the scan — the file must outlive this call. ``cli.scan_image``
    calls src.cleanup() when done; atexit is the backstop for
    library users who forget."""
    src = load_image(tmp, name=name or ref, budget=budget)
    src.cleanup = lambda: (os.path.exists(tmp) and os.unlink(tmp))
    atexit.register(src.cleanup)
    return src


def resolve_image(ref: str, name: Optional[str] = None,
                  daemon: Optional[DaemonClient] = None,
                  containerd: Optional[ContainerdClient] = None,
                  registry: Optional[RegistryClient] = None,
                  budget=None) -> ImageSource:
    """image.go:66-105's fallback chain: tryDockerd → tryPodman →
    tryContainerd → tryRemote. ``budget`` (a guard ResourceBudget)
    rides every leg — a registry pull is the MOST untrusted input
    this tool handles, so the bomb/traversal guards must hold there
    exactly as on --input archives."""
    # 1. local archive / layout
    if os.path.exists(ref):
        return load_image(ref, name=name, budget=budget)

    # 2. daemon export (docker + podman sockets)
    daemon = daemon or DaemonClient()
    leg_errs = []
    if daemon.available_socket():
        try:
            tmp = daemon.export(ref)
        except ResolveError as e:
            leg_errs.append(f"daemon: {e}")
            log.warning("daemon resolution failed: %s", e)
        else:
            return _loaded_tmp(tmp, ref, name, budget)

    # 3. containerd export
    containerd = containerd or ContainerdClient()
    if containerd.available():
        try:
            tmp = containerd.export(ref)
        except ResolveError as e:
            leg_errs.append(f"containerd: {e}")
            log.warning("containerd resolution failed: %s", e)
        else:
            return _loaded_tmp(tmp, ref, name, budget)

    # 4. registry pull
    registry = registry or RegistryClient()
    try:
        return registry.pull(ref, budget=budget)
    except ResolveError as e:
        if leg_errs:
            raise ResolveError(f"{e} ({'; '.join(leg_errs)})")
        raise
