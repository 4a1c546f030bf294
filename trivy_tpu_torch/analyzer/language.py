"""Language lockfile analyzers (reference: go-dep-parser via
pkg/fanal/analyzer/language/* — SURVEY.md §2.2).

Each analyzer parses one lockfile format into an Application with
Libraries; detection runs later against the ecosystem buckets.
"""

from __future__ import annotations

import json
import posixpath
import re

from ..types import Application, Package
from ..types.artifact import Location
from .analyzer import AnalysisResult, Analyzer, register_analyzer


def _app(app_type: str, path: str, pkgs: list) -> AnalysisResult:
    if not pkgs:
        return None
    return AnalysisResult(applications=[
        Application(type=app_type, file_path=path, libraries=pkgs)])


def _lib(name: str, version: str, indirect: bool = False) -> Package:
    return Package(id=f"{name}@{version}", name=name, version=version,
                   indirect=indirect)


@register_analyzer
class NpmLockAnalyzer(Analyzer):
    """package-lock.json (reference: go-dep-parser npm).

    v1 semantics: every entry in the ``dependencies`` tree is emitted
    with Indirect=true (v1 cannot distinguish direct deps), Locations
    is the source-line span of the entry, and DependsOn lists each
    ``requires`` entry resolved to the version visible in scope
    (nested dependencies shadow ancestor scopes)."""

    type = "npm"
    version = 1

    basenames = frozenset({"package-lock.json"})

    def analyze(self, path, content):
        from ..utils.jsonloc import parse_with_lines
        try:
            data, spans = parse_with_lines(content)
        except ValueError:
            return None
        if not isinstance(data, dict):
            return None
        pkgs: dict = {}
        if "packages" in data:           # lockfile v2/v3
            for p, meta in data["packages"].items():
                if not p or not isinstance(meta, dict):
                    continue
                name = meta.get("name") or p.split("node_modules/")[-1]
                ver = meta.get("version", "")
                if not (name and ver):
                    continue
                lib = _lib(name, ver, indirect=bool(meta.get("dev")))
                span = spans.get(("packages", p))
                if span:
                    lib.locations = [Location(*span)]
                prev = pkgs.get((name, ver))
                if prev is None:
                    pkgs[(name, ver)] = lib
                else:
                    prev.locations.extend(lib.locations)
        else:                            # v1: dependencies tree
            self._walk_v1(data.get("dependencies"), ("dependencies",),
                          [data.get("dependencies") or {}],
                          spans, pkgs)
        return _app("npm", path, list(pkgs.values()))

    def _walk_v1(self, deps, path, scopes, spans, pkgs) -> None:
        for name, meta in (deps or {}).items():
            if not isinstance(meta, dict):
                continue
            ver = meta.get("version", "")
            if not ver:
                continue
            lib = _lib(name, ver, indirect=True)
            span = spans.get(path + (name,))
            if span:
                lib.locations = [Location(*span)]
            nested = meta.get("dependencies") or {}
            depends = []
            for req in sorted(meta.get("requires") or {}):
                rv = self._resolve_v1(req, [nested] + scopes)
                if rv:
                    depends.append(f"{req}@{rv}")
            lib.depends_on = depends
            prev = pkgs.get((name, ver))
            if prev is None:
                pkgs[(name, ver)] = lib
            elif lib.locations:
                prev.locations.extend(lib.locations)
            if nested:
                self._walk_v1(nested,
                              path + (name, "dependencies"),
                              [nested] + scopes, spans, pkgs)

    @staticmethod
    def _resolve_v1(name, scopes) -> str:
        for scope in scopes:
            meta = scope.get(name)
            if isinstance(meta, dict) and meta.get("version"):
                return meta["version"]
        return ""


_YARN_HEADER = re.compile(r'^"?(?P<name>(?:@[^@/"]+/)?[^@/"]+)@')
_YARN_VERSION = re.compile(r'^\s+version:?\s+"?([^"\s]+)"?')


@register_analyzer
class YarnLockAnalyzer(Analyzer):
    type = "yarn"
    version = 1

    basenames = frozenset({"yarn.lock"})

    def analyze(self, path, content):
        pkgs: dict = {}
        name, header_line = None, 0
        for ln, line in enumerate(
                content.decode("utf-8", "replace").splitlines(), 1):
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            if not line.startswith((" ", "\t")):
                m = _YARN_HEADER.match(line.strip())
                name = m.group("name") if m else None
                header_line = ln
                continue
            m = _YARN_VERSION.match(line)
            if m and name:
                lib = Package(name=name, version=m.group(1),
                              locations=[Location(header_line,
                                                  header_line)])
                pkgs.setdefault((name, m.group(1)), lib)
        return _app("yarn", path, list(pkgs.values()))


@register_analyzer
class PipfileLockAnalyzer(Analyzer):
    type = "pipenv"
    version = 1

    basenames = frozenset({"Pipfile.lock"})

    def analyze(self, path, content):
        try:
            data = json.loads(content)
        except ValueError:
            return None
        pkgs = []
        for section in ("default", "develop"):
            for name, meta in (data.get(section) or {}).items():
                ver = (meta.get("version") or "").lstrip("=")
                if ver:
                    pkgs.append(_lib(name, ver))
        return _app("pipenv", path, pkgs)


@register_analyzer
class PoetryLockAnalyzer(Analyzer):
    type = "poetry"
    version = 1

    basenames = frozenset({"poetry.lock"})

    def analyze(self, path, content):
        import tomllib
        try:
            data = tomllib.loads(content.decode("utf-8", "replace"))
        except tomllib.TOMLDecodeError:
            return None
        pkgs = [_lib(p.get("name", ""), str(p.get("version", "")))
                for p in data.get("package", [])
                if p.get("name") and p.get("version")]
        return _app("poetry", path, pkgs)


@register_analyzer
class RequirementsAnalyzer(Analyzer):
    """requirements.txt with pinned versions (reference: pip)."""

    type = "pip"
    version = 1

    _LINE = re.compile(
        r"^(?P<name>[A-Za-z0-9._-]+)\s*==\s*(?P<ver>[^\s;#]+)")

    basenames = frozenset({"requirements.txt"})

    def analyze(self, path, content):
        # reference pip parser emits bare name/version (no ID)
        pkgs = []
        for line in content.decode("utf-8", "replace").splitlines():
            m = self._LINE.match(line.strip())
            if m:
                pkgs.append(Package(name=m.group("name"),
                                    version=m.group("ver")))
        return _app("pip", path, pkgs)


_GEM_SPEC_LINE = re.compile(r"^    (\S+) \(([^)]+)\)$")


@register_analyzer
class GemfileLockAnalyzer(Analyzer):
    type = "bundler"
    version = 1

    basenames = frozenset({"Gemfile.lock"})

    def analyze(self, path, content):
        pkgs = []
        in_specs = False
        for line in content.decode("utf-8", "replace").splitlines():
            if line.strip() == "specs:":
                in_specs = True
                continue
            if in_specs:
                if line and not line.startswith(" "):
                    in_specs = False
                    continue
                m = _GEM_SPEC_LINE.match(line)
                if m:
                    pkgs.append(_lib(m.group(1), m.group(2)))
        return _app("bundler", path, pkgs)


@register_analyzer
class ComposerLockAnalyzer(Analyzer):
    type = "composer"
    version = 1

    basenames = frozenset({"composer.lock"})

    def analyze(self, path, content):
        try:
            data = json.loads(content)
        except ValueError:
            return None
        pkgs = []
        for section, indirect in (("packages", False),
                                  ("packages-dev", True)):
            for p in data.get(section) or []:
                name, ver = p.get("name", ""), p.get("version", "")
                if name and ver:
                    pkgs.append(_lib(name, ver.lstrip("v"), indirect))
        return _app("composer", path, pkgs)


@register_analyzer
class CargoLockAnalyzer(Analyzer):
    type = "cargo"
    version = 1

    basenames = frozenset({"Cargo.lock"})

    def analyze(self, path, content):
        import tomllib
        try:
            data = tomllib.loads(content.decode("utf-8", "replace"))
        except tomllib.TOMLDecodeError:
            return None
        # no package ID: this reference vintage's cargo parser sets
        # none (go-dep-parser cargo; busybox-with-lockfile golden
        # carries no PkgID), unlike npm/yarn/pnpm
        pkgs = [Package(name=p["name"], version=str(p["version"]))
                for p in data.get("package", [])
                if p.get("name") and p.get("version")]
        return _app("cargo", path, pkgs)


@register_analyzer
class PnpmLockAnalyzer(Analyzer):
    """pnpm-lock.yaml (reference: go-dep-parser pnpm). Package keys
    are '/name/version' (v5) or '/name@version' (v6); top-level
    dependencies/devDependencies are the direct set."""

    type = "pnpm"
    version = 1

    basenames = frozenset({"pnpm-lock.yaml"})

    def analyze(self, path, content):
        try:
            import yaml
            data = yaml.safe_load(content)
        except Exception:
            return None
        if not isinstance(data, dict):
            return None
        direct = set()
        for sec in ("dependencies", "devDependencies",
                    "optionalDependencies"):
            direct.update((data.get(sec) or {}).keys())
        try:
            lock_ver = float(str(data.get("lockfileVersion", "5")))
        except ValueError:
            lock_ver = 5.0
        pkgs = []
        for key in (data.get("packages") or {}):
            name, ver = self._split_key(key, lock_ver)
            if name and ver:
                pkgs.append(_lib(name, ver,
                                 indirect=name not in direct))
        return _app("pnpm", path, pkgs)

    @staticmethod
    def _split_key(key: str, lock_ver: float) -> tuple:
        """The lockfileVersion field picks the key syntax (as in
        go-dep-parser): v5 '/name/ver_peersuffix' — the peer suffix
        can itself contain '@' ('/react-dom/17.0.2_react@17.0.2') —
        vs v6 '/name@ver(peer)(peer)'."""
        if not key.startswith("/"):
            return "", ""
        if lock_ver >= 6:
            body = key[1:].split("(")[0]
            name, _, ver = body.rpartition("@")
            return name, ver
        base, _, ver = key[1:].rpartition("/")
        return base, ver.split("_")[0]


@register_analyzer
class ConanLockAnalyzer(Analyzer):
    """conan.lock v1 graph_lock (reference: go-dep-parser conan).
    Node "0" is the consumer; its requires are the direct deps.
    DependsOn preserves the node's requires order."""

    type = "conan"
    version = 1

    basenames = frozenset({"conan.lock"})

    def analyze(self, path, content):
        try:
            data = json.loads(content)
        except ValueError:
            return None
        nodes = ((data.get("graph_lock") or {}).get("nodes")) or {}
        refs = {}
        for nid, node in nodes.items():
            ref = (node.get("ref") or "").split("@")[0]
            if "/" in ref:
                name, _, ver = ref.partition("/")
                refs[nid] = (f"{name}/{ver}", name, ver)
        direct = {nid for nid in (nodes.get("0", {}).get("requires")
                                  or [])}
        pkgs = []
        for nid, (pid, name, ver) in refs.items():
            depends = [refs[r][0] for r in
                       (nodes[nid].get("requires") or [])
                       if r in refs]
            pkgs.append(Package(id=pid, name=name, version=ver,
                                indirect=nid not in direct,
                                depends_on=depends))
        return _app("conan", path, pkgs)


_POM_NS = r"\{http://maven\.apache\.org/POM/4\.0\.0\}"


@register_analyzer
class PomAnalyzer(Analyzer):
    """pom.xml (reference: go-dep-parser pom, minimal slice: local
    properties interpolation + dependencies; no parent resolution or
    remote repository lookups — those need network)."""

    type = "pom"
    version = 1

    basenames = frozenset({"pom.xml"})

    def analyze(self, path, content):
        import xml.etree.ElementTree as ET
        try:
            root = ET.fromstring(content)
        except ET.ParseError:
            return None

        def strip(tag):
            return tag.rpartition("}")[2]

        props = {}
        project = {}
        for child in root:
            t = strip(child.tag)
            if t == "properties":
                for p in child:
                    props[strip(p.tag)] = (p.text or "").strip()
            elif t in ("groupId", "artifactId", "version"):
                project[t] = (child.text or "").strip()
        props.setdefault("project.groupId",
                         project.get("groupId", ""))
        props.setdefault("project.version",
                         project.get("version", ""))

        def interp(s):
            return re.sub(r"\$\{([^}]+)\}",
                          lambda m: props.get(m.group(1), ""), s or "")

        def dep_fields(dep):
            fields = {strip(c.tag): (c.text or "").strip()
                      for c in dep}
            return (interp(fields.get("groupId")),
                    interp(fields.get("artifactId")),
                    interp(fields.get("version")))

        def deps_of(parent):
            for child in parent:
                if strip(child.tag) == "dependencies":
                    return [d for d in child
                            if strip(d.tag) == "dependency"]
            return []

        # dependencyManagement pins versions but declares nothing
        managed = {}
        for child in root:
            if strip(child.tag) == "dependencyManagement":
                for dep in deps_of(child):
                    g, a, v = dep_fields(dep)
                    if g and a and v:
                        managed[(g, a)] = v

        pkgs = []
        for dep in deps_of(root):      # project-level only — never
            g, a, v = dep_fields(dep)  # plugins/profiles/dep-mgmt
            v = v or managed.get((g, a), "")
            if g and a and v:
                pkgs.append(Package(name=f"{g}:{a}", version=v))
        return _app("pom", path, pkgs)


@register_analyzer
class GradleLockAnalyzer(Analyzer):
    """gradle.lockfile (reference: go-dep-parser gradle):
    ``group:artifact:version=configurations`` lines."""

    type = "gradle"
    version = 1

    def required(self, path, size=None):
        return posixpath.basename(path).endswith("gradle.lockfile")

    def analyze(self, path, content):
        pkgs: dict = {}
        for line in content.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            coords = line.split("=")[0]
            parts = coords.split(":")
            if len(parts) != 3:
                continue
            group, artifact, ver = parts
            pkgs[(group, artifact, ver)] = Package(
                name=f"{group}:{artifact}", version=ver)
        return _app("gradle", path, list(pkgs.values()))


_GOMOD_REQUIRE = re.compile(
    r"^\s*(?P<mod>[^\s]+)\s+(?P<ver>v[^\s/]+)(?:\s*//.*)?$")


@register_analyzer
class GoModAnalyzer(Analyzer):
    """go.mod + go.sum (reference: analyzer/language/golang/mod —
    both files parse to 'gomod' applications; the gomod-merge post
    handler folds go.sum into pre-1.17 go.mod results)."""

    type = "gomod"
    version = 2

    def required(self, path, size=None):
        return posixpath.basename(path) in ("go.mod", "go.sum")

    def analyze(self, path, content):
        if posixpath.basename(path) == "go.sum":
            return self._gosum(path, content)
        pkgs = []
        in_require = False
        for line in content.decode("utf-8", "replace").splitlines():
            stripped = line.strip()
            if stripped.startswith("require ("):
                in_require = True
                continue
            if in_require and stripped == ")":
                in_require = False
                continue
            m = None
            if in_require:
                m = _GOMOD_REQUIRE.match(stripped)
            elif stripped.startswith("require "):
                m = _GOMOD_REQUIRE.match(
                    stripped[len("require "):])
            if m:
                indirect = "// indirect" in line
                ver = m.group("ver")
                ver = ver[1:] if ver.startswith("v") else ver
                pkgs.append(Package(name=m.group("mod"), version=ver,
                                    indirect=indirect))
        return _app("gomod", path, pkgs)

    def _gosum(self, path, content):
        # go.sum sorts versions ascending; the last entry per module
        # wins (go-dep-parser sum semantics)
        mods: dict = {}
        for line in content.decode("utf-8", "replace").splitlines():
            parts = line.split()
            if len(parts) < 2:
                continue
            ver = parts[1]
            ver = ver[1:] if ver.startswith("v") else ver
            if ver.endswith("/go.mod"):
                ver = ver[:-len("/go.mod")]
            mods[parts[0]] = ver
        return _app("gomod", path,
                    [Package(name=n, version=v)
                     for n, v in mods.items()])


@register_analyzer
class NugetLockAnalyzer(Analyzer):
    """packages.lock.json (reference: go-dep-parser nuget/lock):
    per-framework dependency maps with resolved versions."""

    type = "nuget"
    version = 1

    def required(self, path, size=None):
        return posixpath.basename(path) in ("packages.lock.json",
                                            "packages.config")

    def analyze(self, path, content):
        if path.endswith("packages.config"):
            return self._analyze_config(path, content)
        try:
            doc = json.loads(content)
        except ValueError:
            return None
        pkgs: dict = {}
        for framework in (doc.get("dependencies") or {}).values():
            for name, meta in (framework or {}).items():
                if not isinstance(meta, dict):
                    continue
                version = meta.get("resolved", "")
                if not version:
                    continue
                indirect = meta.get("type", "") == "Transitive"
                key = (name, version)
                if key not in pkgs:
                    pkgs[key] = _lib(name, version, indirect)
        return _app("nuget", path, list(pkgs.values()))

    def _analyze_config(self, path, content):
        """packages.config XML (legacy NuGet): <package id= version=>;
        development-only dependencies are skipped."""
        import xml.etree.ElementTree as ET
        try:
            root = ET.fromstring(content)
        except ET.ParseError:
            return None
        pkgs = []
        for el in root.iter("package"):
            name = el.get("id") or ""
            version = el.get("version") or ""
            if not name or not version:
                continue
            if (el.get("developmentDependency") or "").lower() == \
                    "true":
                continue
            pkgs.append(_lib(name, version))
        return _app("nuget", path, pkgs)


@register_analyzer
class DotNetDepsAnalyzer(Analyzer):
    """*.deps.json (reference: go-dep-parser dotnet/core_deps):
    published .NET runtime dependency manifests."""

    type = "dotnet-core"
    version = 1

    def required(self, path, size=None):
        return path.endswith(".deps.json")

    def analyze(self, path, content):
        try:
            doc = json.loads(content)
        except ValueError:
            return None
        libraries = doc.get("libraries") or {}
        pkgs = []
        for key, meta in libraries.items():
            if not isinstance(meta, dict) or \
                    meta.get("type") != "package":
                continue
            name, _, version = key.partition("/")
            if name and version:
                pkgs.append(_lib(name, version))
        return _app("dotnet-core", path, pkgs)
