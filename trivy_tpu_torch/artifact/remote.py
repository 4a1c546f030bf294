"""Remote repository (git) artifact (copied from
``trivy_tpu/artifact/remote.py``; reference:
pkg/fanal/artifact/remote/git.go).

``python -m trivy_tpu_torch repo <url|path>`` shallow-clones into a
temp dir (with optional branch/tag/commit selection) and delegates to
the local filesystem artifact. Local paths and ``file://`` URLs clone
the same way, so the zero-egress environment exercises the full path;
network URLs work wherever egress exists (the reference authenticates
via GITHUB_TOKEN — forwarded through git's own credential machinery
here).
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile
from typing import Optional

from .artifact import ArtifactOption, LocalFSArtifact

log = logging.getLogger("trivy_tpu_torch.artifact.remote")


class GitError(ValueError):
    pass


def clone(url: str, *, branch: str = "", tag: str = "",
          commit: str = "", no_progress: bool = True) -> tuple:
    """→ (checkout_dir, cleanup_fn). Shallow unless a commit is
    pinned (git.go:52-66)."""
    tmp = tempfile.mkdtemp(prefix="trivy-tpu-remote-")

    def cleanup():
        shutil.rmtree(tmp, ignore_errors=True)

    cmd = ["git", "clone"]
    if not commit:
        cmd += ["--depth", "1"]
    if branch:
        cmd += ["--branch", branch, "--single-branch"]
    elif tag:
        cmd += ["--branch", tag, "--single-branch"]
    if no_progress:
        cmd += ["--quiet"]
    cmd += [url, tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        cleanup()
        raise GitError(f"git clone failed: {e}")
    if proc.returncode != 0:
        cleanup()
        raise GitError(f"git clone failed: "
                       f"{proc.stderr.strip() or proc.stdout.strip()}")
    if commit:
        proc = subprocess.run(
            ["git", "-C", tmp, "checkout", "--quiet", commit],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            cleanup()
            raise GitError(f"git checkout {commit} failed: "
                           f"{proc.stderr.strip()}")
    return tmp, cleanup


class RemoteRepoArtifact:
    """Clone → LocalFSArtifact (git.go:25-88's shape)."""

    def __init__(self, url: str, cache,
                 option: Optional[ArtifactOption] = None,
                 branch: str = "", tag: str = "", commit: str = ""):
        self.url = url
        self.cache = cache
        self.option = option
        self.branch, self.tag, self.commit = branch, tag, commit
        self._cleanup = lambda: None

    def inspect(self):
        src = self.url
        if os.path.isdir(src) and not os.path.isdir(
                os.path.join(src, ".git")) and \
                not src.endswith(".git"):
            if self.branch or self.tag or self.commit:
                raise GitError(
                    f"{src} is not a git repository; "
                    "--branch/--tag/--commit need one")
            # a plain directory needs no clone
            checkout = src
        else:
            checkout, self._cleanup = clone(
                src, branch=self.branch, tag=self.tag,
                commit=self.commit)
            # the clone's .git adds nothing to the scan
            shutil.rmtree(os.path.join(checkout, ".git"),
                          ignore_errors=True)
        ref = LocalFSArtifact(checkout, self.cache,
                              option=self.option).inspect()
        ref.name = self.url
        return ref

    def clean(self):
        self._cleanup()
