"""Package URL (purl) conversion, both directions.

Re-design of the reference's pkg/purl/purl.go (NewPackageURL
purl.go:120-168, FromString purl.go:28-37, Package purl.go:39-77,
purlType purl.go:289-316) plus the subset of packageurl-go string
encoding the reference relies on.  Host-side metadata plumbing — purls
are identity strings for SBOM interchange, so exactness matters more
than speed here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from urllib.parse import quote, unquote

from .types.artifact import OS, Package
from .types.common import format_pkg_version

TYPE_APK = "apk"
TYPE_DEB = "deb"
TYPE_RPM = "rpm"
TYPE_MAVEN = "maven"
TYPE_NPM = "npm"
TYPE_PYPI = "pypi"
TYPE_GEM = "gem"
TYPE_NUGET = "nuget"
TYPE_COMPOSER = "composer"
TYPE_GOLANG = "golang"
TYPE_CARGO = "cargo"
TYPE_CONAN = "conan"
TYPE_OCI = "oci"

# analyzer/application type -> purl type (ref purl.go:289-316 purlType)
_APP_TO_PURL = {
    # "gradle" deliberately keeps its own type but gets maven-style
    # namespace splitting (ref purl.go:146, purlType has no gradle case).
    "jar": TYPE_MAVEN, "pom": TYPE_MAVEN,
    "bundler": TYPE_GEM, "gemspec": TYPE_GEM,
    "nuget": TYPE_NUGET, "dotnet-core": TYPE_NUGET,
    "python-pkg": TYPE_PYPI, "pip": TYPE_PYPI, "pipenv": TYPE_PYPI,
    "poetry": TYPE_PYPI,
    "gobinary": TYPE_GOLANG, "gomod": TYPE_GOLANG,
    "npm": TYPE_NPM, "node-pkg": TYPE_NPM, "yarn": TYPE_NPM,
    "pnpm": TYPE_NPM,
    "composer": TYPE_COMPOSER,
    "cargo": TYPE_CARGO,
    "conan": TYPE_CONAN,
}

_DEB_FAMILIES = {"debian", "ubuntu"}
_RPM_FAMILIES = {
    "redhat", "centos", "rocky", "alma", "amazon", "fedora", "oracle",
    "opensuse", "opensuse.leap", "opensuse.tumbleweed", "suse linux "
    "enterprise server", "photon", "cbl-mariner",
}

# purl type -> application type for SBOM decode (ref purl.go:80-100)
_PURL_TO_APP = {
    TYPE_COMPOSER: "composer",
    TYPE_MAVEN: "jar",
    TYPE_GEM: "gemspec",
    TYPE_PYPI: "python-pkg",
    TYPE_GOLANG: "gobinary",
    TYPE_NPM: "node-pkg",
    TYPE_CARGO: "rustbinary",
    TYPE_NUGET: "nuget",
    TYPE_CONAN: "conan",
}

_OS_PURL_TYPES = {TYPE_APK, TYPE_DEB, TYPE_RPM}


def _quote_segment(s: str) -> str:
    return quote(s, safe="")


def _quote_version(s: str) -> str:
    # Go url.PathEscape keeps the pchar set; ':' matters for rpm epochs.
    return quote(s, safe=":@&=+$,")


@dataclass
class PackageURL:
    """pkg:type/namespace/name@version?qualifiers#subpath"""

    type: str = ""
    namespace: str = ""
    name: str = ""
    version: str = ""
    qualifiers: list = field(default_factory=list)  # [(key, value)]
    subpath: str = ""
    file_path: str = ""  # carried out-of-band for BOMRef uniqueness

    def qualifier(self, key: str, default: str = "") -> str:
        for k, v in self.qualifiers:
            if k == key:
                return v
        return default

    def to_string(self) -> str:
        parts = ["pkg:", self.type]
        if self.namespace:
            parts.append("/")
            parts.append("/".join(_quote_segment(seg)
                                  for seg in self.namespace.split("/")))
        parts.append("/")
        parts.append(_quote_segment(self.name))
        if self.version:
            parts.append("@")
            parts.append(_quote_version(self.version))
        quals = [(k, v) for k, v in self.qualifiers if v]
        if quals:
            quals.sort(key=lambda kv: kv[0])
            parts.append("?")
            parts.append("&".join(
                f"{k}={quote(v, safe='')}" for k, v in quals))
        if self.subpath:
            parts.append("#")
            parts.append(quote(self.subpath, safe="/"))
        return "".join(parts)

    def bom_ref(self) -> str:
        """'bom-ref' must be unique within a BOM; disambiguate identical
        purls by file path (ref purl.go:102-118)."""
        if not self.file_path:
            return self.to_string()
        p = PackageURL(type=self.type, namespace=self.namespace,
                       name=self.name, version=self.version,
                       qualifiers=list(self.qualifiers) +
                       [("file_path", self.file_path)],
                       subpath=self.subpath)
        return p.to_string()

    # ---- decode direction -------------------------------------------

    def app_type(self) -> str:
        """Application type this purl's ecosystem maps to
        (ref purl.go:80-100 AppType)."""
        return _PURL_TO_APP.get(self.type, self.type)

    def is_os_pkg(self) -> bool:
        return self.type in _OS_PURL_TYPES

    def package(self) -> Package:
        """Back-convert into a fanal Package (ref purl.go:39-77)."""
        pkg = Package(name=self.name, version=self.version)
        for k, v in self.qualifiers:
            if k == "arch":
                pkg.arch = v
            elif k == "modularitylabel":
                pkg.modularity_label = v
            elif k == "epoch":
                try:
                    pkg.epoch = int(v)
                except ValueError:
                    pass
        if self.type == TYPE_RPM:
            epoch, ver, rel = _split_rpm_evr(self.version)
            pkg.epoch = pkg.epoch or epoch
            pkg.version, pkg.release = ver, rel
        if (not self.namespace or self.type in
                (TYPE_RPM, TYPE_DEB, TYPE_APK)):
            return pkg
        if self.type == TYPE_MAVEN:
            # Maven/Gradle join groupId:artifactId with ':'
            pkg.name = f"{self.namespace}:{self.name}"
        else:
            pkg.name = f"{self.namespace}/{self.name}"
        return pkg


def _split_rpm_evr(v: str):
    epoch = 0
    if ":" in v:
        e, v = v.split(":", 1)
        try:
            epoch = int(e)
        except ValueError:
            pass
    release = ""
    if "-" in v:
        v, release = v.rsplit("-", 1)
    return epoch, v, release


def _unq(x: str) -> str:
    # unquote only when an escape is present: the common purl has
    # none, and the function-call + scan cost shows up at 10k-SBOM
    # decode scale
    return unquote(x) if "%" in x else x


_parse_lru = None


def _parse_cache():
    """Lazy so the module import stays light (purl is imported by
    the types layer; detect.ccache pulls in the metrics module)."""
    global _parse_lru
    if _parse_lru is None:
        from .detect.ccache import KeyedLRU
        _parse_lru = KeyedLRU(65536, "purl_cache_hits",
                              "purl_cache_misses")
    return _parse_lru


def from_string(s: str) -> PackageURL:
    """Parse `pkg:type/namespace/name@version?quals#subpath`.

    Parses are memoized per input string: SBOM fleets repeat the
    same purls across documents (every member depends on the same
    lodash), so re-validating each occurrence is pure waste at 10k
    scale (docs/performance.md). Callers MUTATE the returned object
    (``file_path``, qualifier lists), so every call hands out a
    fresh shallow copy, never the cached instance. Parse errors are
    cached too and re-raised fresh (detect.ccache.KeyedLRU)."""
    p = _parse_cache().lookup(s, _from_string_uncached)
    return PackageURL(
        type=p.type, namespace=p.namespace, name=p.name,
        version=p.version, qualifiers=list(p.qualifiers),
        subpath=p.subpath, file_path=p.file_path)


def _from_string_uncached(s: str) -> PackageURL:
    if not s.startswith("pkg:"):
        raise ValueError(f"purl must start with 'pkg:': {s!r}")
    if "%" not in s and "?" not in s and "#" not in s:
        # fast path for the overwhelmingly common shape — no
        # escapes, qualifiers, or subpath (exact same semantics as
        # the general parse below, minus the unquote calls)
        rest = s[4:].lstrip("/")
        head, at, tail = rest.rpartition("@")
        if at and "/" not in tail:
            rest, version = head, tail
        else:
            version = ""
        segs = rest.split("/")
        if len(segs) < 2 or not segs[-1]:
            raise ValueError(f"purl is missing a name: {s!r}")
        return PackageURL(
            type=segs[0].lower(),
            namespace="/".join(segs[1:-1]) if len(segs) > 2 else "",
            name=segs[-1], version=version, qualifiers=[],
            subpath="")
    rest = s[4:].lstrip("/")
    subpath = ""
    if "#" in rest:
        rest, subpath = rest.split("#", 1)
        subpath = _unq(subpath)
    qualifiers = []
    if "?" in rest:
        rest, qs = rest.split("?", 1)
        for pair in qs.split("&"):
            if not pair:
                continue
            k, _, v = pair.partition("=")
            qualifiers.append((k.lower(), _unq(v)))
    version = ""
    if "@" in rest:
        # '@' in scoped npm namespaces is %40-encoded, so the first raw
        # '@' after the last '/' is the version separator.
        head, _, tail = rest.rpartition("@")
        if "/" not in tail:
            rest, version = head, _unq(tail)
    segs = rest.split("/")
    ptype = segs[0].lower()
    if len(segs) < 2 or not segs[-1]:
        raise ValueError(f"purl is missing a name: {s!r}")
    name = _unq(segs[-1])
    if len(segs) == 2:
        namespace = ""
    else:
        namespace = "/".join(_unq(x) for x in segs[1:-1])
    return PackageURL(type=ptype, namespace=namespace, name=name,
                      version=version, qualifiers=qualifiers,
                      subpath=subpath)


def _split_ns(name: str):
    if "/" in name:
        ns, _, base = name.rpartition("/")
        return ns, base
    return "", name


def new_package_url(pkg_type: str, pkg: Package, os: OS = None,
                    repo_digests=None, arch: str = "") -> PackageURL:
    """Build a purl for an OS or application package
    (ref purl.go:120-168 NewPackageURL).

    ``pkg_type`` is an OS family (for C.OSPKG results) or an
    application/analyzer type string (for language results).
    """
    qualifiers = []
    if os is not None and pkg.arch:
        qualifiers.append(("arch", pkg.arch))

    ptype = _purl_type(pkg_type)
    name = pkg.name
    version = format_pkg_version(pkg)
    namespace = ""

    if ptype == TYPE_RPM:
        if os is not None:
            family = os.family
            if family == "suse linux enterprise server":
                family = "sles"
            namespace = family
            qualifiers.append(("distro", f"{family}-{os.name}"))
        if pkg.modularity_label:
            qualifiers.append(("modularitylabel", pkg.modularity_label))
    elif ptype == TYPE_DEB:
        if os is not None:
            namespace = os.family
            qualifiers.append(("distro", f"{os.family}-{os.name}"))
    elif ptype == TYPE_APK:
        if os is not None:
            namespace = os.family
            qualifiers.append(("distro", os.name))
    elif ptype in (TYPE_MAVEN, "gradle"):
        # groupId:artifactId -> namespace/name
        namespace, name = _split_ns(name.replace(":", "/"))
    elif ptype == TYPE_PYPI:
        name = name.lower().replace("_", "-")
    elif ptype in (TYPE_COMPOSER, TYPE_CONAN):
        namespace, name = _split_ns(name)
    elif ptype in (TYPE_GOLANG, TYPE_NPM):
        namespace, name = _split_ns(name.lower())

    return PackageURL(type=ptype, namespace=namespace, name=name,
                      version=version, qualifiers=qualifiers,
                      file_path=pkg.file_path)


def oci_package_url(repo_digests, architecture: str = "") -> PackageURL:
    """purl for a container image by repo digest (ref purl.go:170-199)."""
    if not repo_digests:
        return PackageURL()
    ref = repo_digests[0]
    repo, sep, digest = ref.partition("@")
    if not sep or not digest.startswith("sha256:"):
        raise ValueError(f"failed to parse digest: {ref!r}")
    repo = repo.lower()
    # a colon after the last '/' is a tag, before it a registry port
    base = repo.rsplit("/", 1)[-1]
    if ":" in base:
        repo = repo[: len(repo) - len(base)] + base.split(":", 1)[0]
    if "/" not in repo:
        repo = f"index.docker.io/library/{repo}"
    elif "." not in repo.split("/", 1)[0] and \
            ":" not in repo.split("/", 1)[0]:
        repo = f"index.docker.io/{repo}"
    name = repo.rsplit("/", 1)[-1]
    qualifiers = [("repository_url", repo)]
    if architecture:
        qualifiers.append(("arch", architecture))
    return PackageURL(type=TYPE_OCI, name=name, version=digest,
                      qualifiers=qualifiers)


def _purl_type(t: str) -> str:
    if t in _APP_TO_PURL:
        return _APP_TO_PURL[t]
    if t == "alpine":
        return TYPE_APK
    if t in _DEB_FAMILIES:
        return TYPE_DEB
    if t in _RPM_FAMILIES:
        return TYPE_RPM
    return t
