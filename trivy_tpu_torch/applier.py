"""Layer squashing (reference: pkg/fanal/applier/docker.go:89-236).

Reconstructs final-container state from per-layer BlobInfos: apply
whiteouts/opaque dirs via a nested path map, last-layer-wins for OS /
package files, merge secrets across layers with origin attribution,
aggregate per-file installed packages (python-pkg/gemspec/node-pkg/
jar), and attribute each surviving package to the layer that
introduced it.
"""

from __future__ import annotations

from typing import Optional

from .types import (Application, ArtifactDetail, BlobInfo, Layer,
                    PackageInfo, Secret)

_AGGREGATE_TYPES = ("python-pkg", "gemspec", "node-pkg", "jar")


class _Nested:
    """Nested path map with subtree deletion (applier's nested.Nested)."""

    def __init__(self):
        self.root: dict = {}

    def set(self, key: str):
        parts = [p for p in key.split("/") if p]
        node = self.root
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        return node, parts[-1]

    def set_value(self, key: str, value) -> None:
        node, leaf = self.set(key)
        node[leaf] = value

    def delete(self, key: str) -> None:
        parts = [p for p in key.split("/") if p]
        if not parts:
            return
        node = self.root
        for p in parts[:-1]:
            node = node.get(p)
            if not isinstance(node, dict):
                return
        node.pop(parts[-1], None)

    def walk(self):
        def rec(node):
            for k in sorted(node):
                v = node[k]
                if isinstance(v, dict):
                    yield from rec(v)
                else:
                    yield v
        yield from rec(self.root)


def apply_layers(layers: list) -> ArtifactDetail:
    nested = _Nested()
    merged = ArtifactDetail()

    for layer in layers:
        if layer is None:
            continue
        for opq in layer.opaque_dirs:
            nested.delete(opq.rstrip("/"))
        for wh in layer.whiteout_files:
            nested.delete(wh)

        if layer.os is not None:
            merged.os = layer.os if merged.os is None \
                else merged.os.merge(layer.os)
        if layer.repository is not None:
            merged.repository = layer.repository

        for pkg_info in layer.package_infos:
            nested.set_value(f"{pkg_info.file_path}/type:ospkg",
                             pkg_info)
        for app in layer.applications:
            nested.set_value(f"{app.file_path}/type:{app.type}", app)
        for config in layer.misconfigurations:
            config.layer = Layer(digest=layer.digest,
                                 diff_id=layer.diff_id)
            nested.set_value(f"{config.file_path}/type:config", config)
        for lic in layer.licenses:
            lic.layer = Layer(digest=layer.digest,
                              diff_id=layer.diff_id)
            nested.set_value(
                f"{lic.file_path}/type:license,{lic.type}", lic)
        for cr in layer.custom_resources:
            cr.layer = Layer(digest=layer.digest,
                             diff_id=layer.diff_id)
            nested.set_value(f"{cr.file_path}/custom:{cr.type}", cr)

    for value in nested.walk():
        if isinstance(value, PackageInfo):
            merged.packages.extend(value.packages)
        elif isinstance(value, Application):
            merged.applications.append(value)
        elif value.__class__.__name__ == "Misconfiguration":
            merged.misconfigurations.append(value)
        elif value.__class__.__name__ == "LicenseFile":
            merged.licenses.append(value)
        elif value.__class__.__name__ == "CustomResource":
            merged.custom_resources.append(value)

    merged.secrets = merge_layer_secrets(layers)

    # dpkg license files merge into package records (docker.go:188-)
    dpkg_licenses = {}
    kept = []
    for lic in merged.licenses:
        if lic.type == "dpkg-license":
            dpkg_licenses[lic.pkg_name] = [f.name for f in
                                           lic.findings]
        else:
            kept.append(lic)
    merged.licenses = kept

    # single-layer artifacts (SBOMs, fs scans) need no search: every
    # merged record can only come from that one layer
    real = [l for l in layers if l is not None]
    single = real[0] if len(real) == 1 else None

    if single is None:
        # first-layer-wins origin index: the per-package linear
        # scan over every layer's package lists was quadratic and
        # dominated fleet-squash host time
        origin_idx: dict = {}
        for i, layer in enumerate(real):
            for pkg_info in layer.package_infos:
                for p in pkg_info.packages:
                    origin_idx.setdefault(
                        (p.name, p.version, p.release),
                        (layer.digest, layer.diff_id, i))

    for pkg in merged.packages:
        if single is not None:
            # SBOM-decoded packages carry the ORIGINAL image layer
            # they came from (spdx attributionTexts / cyclonedx
            # properties); the rescan keeps it rather than
            # attributing to the sbom blob (centos-7 sbom goldens)
            if pkg.layer is None or pkg.layer.empty():
                pkg.layer = Layer(digest=single.digest,
                                  diff_id=single.diff_id)
            pkg.build_info = single.build_info
        else:
            digest, diff_id, idx = origin_idx.get(
                (pkg.name, pkg.version, pkg.release), ("", "", -1))
            pkg.build_info = _lookup_build_info(idx, real)
            pkg.layer = Layer(digest=digest, diff_id=diff_id)
        if pkg.name in dpkg_licenses:
            pkg.licenses = dpkg_licenses[pkg.name]

    for app in merged.applications:
        for lib in app.libraries:
            if single is not None:
                if lib.layer is not None and \
                        not lib.layer.empty():
                    continue      # SBOM-decoded origin layer kept
                digest, diff_id = single.digest, single.diff_id
            else:
                digest, diff_id = _origin_layer_lib(
                    app.file_path, lib, layers)
            lib.layer = Layer(digest=digest, diff_id=diff_id)

    _aggregate(merged)
    return merged


def _lookup_build_info(index: int, layers: list):
    """Red Hat content sets from the package's origin layer
    (docker.go:48-70 lookupBuildInfo): the layer's own record wins;
    the base layer (index 0) shares layer 1's; customer layers on
    top of a Red Hat image share the nearest earlier Red Hat
    layer's. The backward scan deliberately stops before index 0
    (docker.go:65 ``for i := index - 1; i >= 1; i--``): Red Hat
    base layers carry no content manifest of their own in real
    images, so index 0 is never a source."""
    if index < 0:
        return None
    if layers[index].build_info is not None:
        return layers[index].build_info
    if index == 0:
        return layers[1].build_info if len(layers) > 1 else None
    for i in range(index - 1, 0, -1):
        if layers[i].build_info is not None:
            return layers[i].build_info
    return None


def _origin_layer_lib(file_path, lib, layers) -> tuple:
    for layer in layers:
        if layer is None:
            continue
        for app in layer.applications:
            if app.file_path != file_path:
                continue
            for p in app.libraries:
                if (p.name, p.version) == (lib.name, lib.version):
                    return layer.digest, layer.diff_id
    return "", ""


def merge_layer_secrets(layers: list) -> list:
    """Stand-alone secret merge across layers, identical to the one
    apply_layers performs inline (whiteouts never delete secrets).
    Lets the batch runner re-derive detail.secrets AFTER a deferred
    sieve collect, without re-applying whole layers."""
    secrets_map: dict = {}
    for layer in layers:
        if layer is None:
            continue
        for secret in layer.secrets:
            _merge_secret(secrets_map, secret,
                          Layer(digest=layer.digest,
                                diff_id=layer.diff_id))
    return [secrets_map[k] for k in sorted(secrets_map)]


def _merge_secret(secrets_map: dict, new: Secret, layer) -> None:
    findings = []
    for f in new.findings:
        f.layer = layer
        findings.append(f)
    prev = secrets_map.get(new.file_path)
    if prev is not None:
        have = {f.rule_id for f in findings}
        for f in prev.findings:
            if f.rule_id not in have:
                findings.append(f)
    secrets_map[new.file_path] = Secret(file_path=new.file_path,
                                        findings=findings)


def _aggregate(detail: ArtifactDetail) -> None:
    """pip/gem/npm/jar per-file installs merge into one Application
    per type (docker.go:240-267)."""
    apps = []
    buckets = {t: Application(type=t) for t in _AGGREGATE_TYPES}
    for app in detail.applications:
        if app.type in buckets:
            buckets[app.type].libraries.extend(app.libraries)
        else:
            apps.append(app)
    for t in _AGGREGATE_TYPES:
        if buckets[t].libraries:
            apps.append(buckets[t])
    detail.applications = apps
