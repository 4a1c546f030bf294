"""Image and filesystem artifacts (reference:
pkg/fanal/artifact/image/image.go + artifact/local/fs.go).

Inspect flow (image.go:75-257): compute content-addressed cache keys
per layer → ask the cache which are missing → analyze only those →
PutBlob. The reference analyzes layers in parallel goroutines with a
per-file semaphore; here every missing layer's files are analyzed on
the host (parsers are irregular), while ALL layers' secret candidates
go to the card in one batched sieve dispatch — the batch dimension
replaces the goroutine pool.

The reference also records trace events and phase spans here
(``inspect``, ``layer_analyze``, ``layer_analyzed``); the tracer comes
with ROADMAP A.8. The ``config`` and ``license`` checks are refused
by ``scan/local.py::check_security_checks`` until A.9.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Optional

from ..analyzer import AnalyzerGroup
from ..analyzer.analyzer import AnalysisResult
from ..handler import handler_versions, post_handle
from ..types import ArtifactInfo, ArtifactReference, ImageMetadata
from .cache import calc_key
from .image import ImageSource, guess_base_layers
from .walker import collect_layer_tar, walk_fs


@dataclass
class ArtifactOption:
    skip_dirs: list = field(default_factory=list)
    skip_files: list = field(default_factory=list)
    file_patterns: dict = field(default_factory=dict)
    secret_scanner: object = None      # BatchSecretScanner (shared)
    scan_secrets: bool = True
    # ingest guards (guard/): ON by default with DEFAULT_LIMITS;
    # --no-ingest-guards turns them off (the differential baseline).
    # ``ingest_limits`` overrides the limits; the per-target
    # ResourceBudget itself is created fresh per scan (never shared
    # across targets).
    ingest_guards: bool = True
    ingest_limits: object = None       # ResourceLimits or None
    # secret rule-set fingerprint (secret.batch.rules_fingerprint):
    # cached blob CONTENT includes secret findings, so two rule
    # configurations must never share blob cache keys. Empty =
    # derive from ``secret_scanner`` (builtin when None); the batch
    # runner stamps its shared sieve's (runtime/batch.py)
    secret_rules_fp: str = ""


def _secret_scanner(opt: ArtifactOption):
    if opt.secret_scanner is None:
        from ..secret.batch import BatchSecretScanner
        opt.secret_scanner = BatchSecretScanner()
    return opt.secret_scanner


def _effective_disabled() -> list:
    """The config and license collectors: off until the ``config`` and
    ``license`` checks come (ROADMAP A.9), as the reference has them
    without its misconf and license options."""
    from ..analyzer.config import CONFIG_ANALYZER_TYPES
    from ..analyzer.licensing import LICENSE_ANALYZER_TYPES
    return [*CONFIG_ANALYZER_TYPES, *LICENSE_ANALYZER_TYPES]


class ImageArtifact:
    def __init__(self, image: ImageSource, cache,
                 option: Optional[ArtifactOption] = None,
                 budget=None):
        self.image = image
        self.cache = cache
        self.opt = option or ArtifactOption()
        self.missing_layers = 0      # layers the last inspect() analyzed
        # one ResourceBudget per target: prefer an explicit one, then
        # the budget the image was loaded under (so layer reads and
        # the walk charge the SAME counters), else a fresh one when
        # guards are on
        if budget is None:
            budget = getattr(image, "ingest_budget", None)
        if budget is None and self.opt.ingest_guards:
            from ..guard.budget import make_budget
            budget = make_budget(self.opt.ingest_limits,
                                 name=getattr(image, "name", ""))
        self.budget = budget
        image.ingest_budget = budget
        arch = getattr(image, "archive", None)
        if arch is not None and budget is not None and \
                arch.budget is None:
            # the image was loaded unguarded: retrofit the budget
            # onto the shared archive handle so layer blob reads and
            # gzip decompression charge it too
            arch.budget = budget
        self.group = AnalyzerGroup(
            disabled=_effective_disabled(),
            file_patterns=self.opt.file_patterns)

    def cache_keys(self) -> tuple:
        """``(artifact_id, blob_ids, base)`` — the content-addressed
        cache keys :meth:`inspect` scans under. Needs only the image
        *metadata* (id, config, diff_ids), never a layer byte."""
        img = self.image
        opts_key = {"skip_dirs": self.opt.skip_dirs,
                    "skip_files": self.opt.skip_files,
                    "patterns": sorted(self.opt.file_patterns),
                    # guards change which entries of a HOSTILE layer
                    # survive the walk, so guarded and unguarded
                    # blobs must never share cache keys (clean
                    # layers produce identical content either way)
                    "ingest_guards": self.budget is not None,
                    "secrets": self.opt.scan_secrets,
                    # the rule set decides which secret findings a
                    # blob carries — a trivy-secret.yaml custom set
                    # must never share cached blobs with the builtin
                    # corpus
                    "secret_rules": self._rules_fp()
                    if self.opt.scan_secrets else "",
                    # the config and license checks: A.9
                    "misconfig": False,
                    "licenses": False,
                    # the rekor URL changes analyzer/handler output
                    # (different servers hold different
                    # attestations), so it keys cached blobs
                    "rekor": os.environ.get("TRIVY_REKOR_URL", ""),
                    # likewise the APK index URL decides what
                    # history_packages the artifact record holds
                    "apk_index": os.environ.get(
                        "TRIVY_APK_INDEX_ARCHIVE_URL",
                        os.environ.get(
                            "FANAL_APK_INDEX_ARCHIVE_URL", ""))}
        versions = dict(self.group.versions())
        versions.update({f"handler/{k}": v
                         for k, v in handler_versions().items()})
        # base-image layers skip secret scanning (image.go:215-218),
        # so a layer's blob CONTENT depends on whether this image
        # treats it as base — the flag must be in the key, or a
        # shared cache would serve base-stripped secrets to an image
        # that owns the layer (and vice versa). The reference keys
        # all layers alike (image.go:152-169) and accepts that
        # asymmetry; our keys never interoperate with its anyway.
        base = set(guess_base_layers(img.diff_ids, img.config)) \
            if self.opt.scan_secrets else set()
        blob_ids = [
            calc_key(d, versions,
                     options=dict(opts_key, base_layer=True)
                     if d in base else opts_key)
            for d in img.diff_ids]
        artifact_id = calc_key(img.id, versions, options=opts_key)
        return artifact_id, blob_ids, base

    def inspect(self) -> ArtifactReference:
        img = self.image
        artifact_id, blob_ids, base = self.cache_keys()

        try:
            missing_artifact, missing = self.cache.missing_blobs(
                artifact_id, blob_ids)
            todo = [i for i, b in enumerate(blob_ids)
                    if b in missing]
            self.missing_layers = len(todo)
            if todo:
                self._inspect_layers(todo, blob_ids, base)
            if missing_artifact and \
                    getattr(self, "_os_found", None) is None:
                # OS layer may be a cache hit while the artifact
                # record is being (re)built — read it from the
                # cached blobs so the history analyzer still knows
                # the distro/version
                for b in blob_ids:
                    blob = self.cache.get_blob(b)
                    if blob is not None and blob.os is not None:
                        self._os_found = blob.os
                        break
        finally:
            # layer reads are done — release the shared archive
            # handle now rather than at GC, including on the
            # fully-cached path where nothing was read
            img.close()
        if missing_artifact:
            self.cache.put_artifact(artifact_id,
                                    self._artifact_info())

        return ArtifactReference(
            name=img.name,
            type="container_image",
            id=artifact_id,
            blob_ids=blob_ids,
            image_metadata=ImageMetadata(
                id=img.id,
                diff_ids=img.diff_ids,
                repo_tags=img.repo_tags,
                repo_digests=img.repo_digests,
                image_config=img.config,
            ),
        )

    def _rules_fp(self) -> str:
        """Secret rule-set fingerprint for the blob cache key: an
        explicit fingerprint wins (the batch runner stamps its
        shared sieve's), else the option's scanner, else builtin."""
        if self.opt.secret_rules_fp:
            return self.opt.secret_rules_fp
        from ..secret.batch import rules_fingerprint
        return rules_fingerprint(self.opt.secret_scanner)

    # --- analysis ---

    def _inspect_layers(self, todo: list, blob_ids: list,
                        base: set) -> None:
        # secret scanning is skipped on base-image layers — their
        # "secrets" belong to the base image's publisher, not this
        # image (ref image.go:215-218); `base` also marked these
        # layers' cache keys in inspect()
        layer_results = []
        all_candidates = []        # (layer_idx, path, content)
        budget = self.budget
        ctx = budget.activate() if budget is not None \
            else contextlib.nullcontext()
        with ctx:
            self._analyze_layers(todo, layer_results, all_candidates,
                                 base)
        if budget is not None:
            budget.flush_metrics()

        secrets_by_layer = self._batch_secrets(all_candidates)

        for i, result, opq_dirs, wh_files in layer_results:
            result.secrets = secrets_by_layer.get(i, [])
            blob = result.to_blob_info(diff_id=self.image.diff_ids[i])
            blob.opaque_dirs = opq_dirs
            blob.whiteout_files = wh_files
            post_handle(blob)
            self.cache.put_blob(blob_ids[i], blob)

    def _analyze_layers(self, todo: list, layer_results: list,
                        all_candidates: list, base: set) -> None:
        for i in todo:
            layer = self.image.layers[i]
            result = AnalysisResult()
            with layer.open() as tf:
                files, opq_dirs, wh_files = collect_layer_tar(
                    tf, budget=self.budget)
                for path, size, read in files:
                    if self._skipped(path):
                        continue
                    self.group.analyze_file(result, path, read, size)
            layer_results.append((i, result, opq_dirs, wh_files))
            if result.os is not None:
                # feeds the image-config history analyzer, like the
                # reference's osFound (image.go:206-250)
                self._os_found = result.os
            if self.image.diff_ids[i] in base:
                continue
            for path, content in result.secret_candidates:
                all_candidates.append((i, path, content))

    def _batch_secrets(self, candidates: list) -> dict:
        """ONE kernel dispatch across every missing layer's files.
        Image paths get a leading '/' (secret.go:97-101). The same
        path can exist in several layers with different contents —
        results map back by the entry INDEX scan_files returns,
        never by path."""
        if not candidates or not self.opt.scan_secrets:
            return {}
        scanner = _secret_scanner(self.opt)
        files = [("/" + path, content)
                 for _, path, content in candidates]
        out: dict = {}
        for idx, s in scanner.scan_files(files):
            out.setdefault(candidates[idx][0], []).append(s)
        return out

    def _skipped(self, path: str) -> bool:
        for d in self.opt.skip_dirs:
            d = d.strip("/")
            if path == d or path.startswith(d + "/"):
                return True
        return ("/" + path if not path.startswith("/") else path)\
            in self.opt.skip_files or path in self.opt.skip_files

    def _artifact_info(self) -> ArtifactInfo:
        """inspectConfig analog (ref image.go:349-376): image
        metadata plus packages reconstructed from RUN history for
        --removed-pkgs scanning."""
        from ..analyzer.imgconf import analyze_image_config
        cfg = self.image.config
        os_found = getattr(self, "_os_found", None)
        return ArtifactInfo(
            architecture=cfg.get("architecture", ""),
            created=cfg.get("created", ""),
            docker_version=cfg.get("docker_version", ""),
            os=cfg.get("os", ""),
            history_packages=analyze_image_config(
                os_found.family if os_found else "",
                os_found.name if os_found else "", cfg),
        )


class LocalFSArtifact:
    """Directory tree → ONE blob (reference: artifact/local/fs.go)."""

    def __init__(self, root: str, cache,
                 option: Optional[ArtifactOption] = None):
        self.root = root
        self.cache = cache
        self.opt = option or ArtifactOption()
        self.group = AnalyzerGroup(
            disabled=_effective_disabled(),
            file_patterns=self.opt.file_patterns)

    def inspect(self) -> ArtifactReference:
        result = AnalysisResult()
        files = walk_fs(self.root, skip_dirs=self.opt.skip_dirs,
                        skip_files=self.opt.skip_files)
        for path, size, read in files:
            self.group.analyze_file(result, path, read, size)

        if result.secret_candidates and self.opt.scan_secrets:
            scanner = _secret_scanner(self.opt)
            result.secrets = [s for _, s in scanner.scan_files(
                [(p, c) for p, c in result.secret_candidates])]

        blob = result.to_blob_info()
        post_handle(blob)
        # NOTE: blob.diff_id stays empty — filesystem scans report
        # Layer: {} (reference: local artifacts have no layers); the
        # content hash is only the cache key.
        raw = json.dumps(blob.to_dict(), sort_keys=True).encode()
        blob_id = "sha256:" + hashlib.sha256(raw).hexdigest()
        self.cache.put_blob(blob_id, blob)
        return ArtifactReference(
            name=self.root, type="filesystem", id=blob_id,
            blob_ids=[blob_id])
