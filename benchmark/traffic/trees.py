"""Seeded OS roots, lockfiles and ``docker save`` images.

Copies of ``chip_smoke.py``'s ``fs_tree_files``, ``layer_tar``,
``image_config`` and ``write_docker_save``, with one change:
``tree_files`` also returns what it wrote, the packages of each file
(the truth the reference checks the program's inventory against).
Package names and versions are the advisory database's own
(``advisories.installed_version``), so the joins hit.
"""

from __future__ import annotations

import hashlib
import io
import json
import tarfile

from .advisories import installed_version


def zipf_unique(rng, n: int, count: int) -> list:
    """``count`` distinct package numbers below ``n``, drawn with a Zipf
    skew, in the order first drawn."""
    seen: dict = {}
    while len(seen) < min(count, n):
        for p in (rng.zipf(1.3, count) - 1) % n:
            if len(seen) < count:
                seen.setdefault(int(p), None)
    return list(seen)


def tree_files(tree: dict, n_pkgs: dict, rng) -> tuple:
    """The files of one image's OS root and lockfiles under ``tree``
    (a ``trees`` entry of a workload: ``family``, ``version``,
    ``bucket``, ``grammar``, ``os_packages``, ``apps``), drawn from
    ``rng``: ([(rel_path, bytes)] of the OS, [(rel_path, bytes)] of
    the lockfiles, {"os": [(name, version, p)], "apps": [(app type,
    path, bucket, grammar, [(name, version, p)])], "src": {package:
    its source package, where the two differ}})."""
    family, os_ver = tree["family"], tree["version"]
    bucket, grammar = tree["bucket"], tree["grammar"]
    os_files, app_files = [], []

    def put(rel: str, data, into=os_files) -> None:
        into.append((rel, data.encode() if isinstance(data, str)
                     else data))

    def draw(bkt: str, gr: str, n: int, prefix: str) -> list:
        return [(f"{prefix}-{gr}-{p}",
                 installed_version(gr, bkt, p, int(rng.integers(0, 4))),
                 p) for p in zipf_unique(rng, n_pkgs[bkt], n)]

    pkgs = draw(bucket, grammar, tree["os_packages"], "os")
    truth = {"os": pkgs, "apps": [], "src": {}}
    if family == "debian":
        put("etc/os-release", f'PRETTY_NAME="Debian GNU/Linux {os_ver} '
            f'(bookworm)"\nNAME="Debian GNU/Linux"\n'
            f'VERSION_ID="{os_ver}"\nVERSION="{os_ver} (bookworm)"\n'
            f"ID=debian\n")
        put("etc/debian_version", f"{os_ver}.5\n")
        paras = []
        for i, (name, ver, p) in enumerate(pkgs):
            lines = [f"Package: {name}", "Status: install ok installed",
                     "Priority: optional", "Architecture: amd64"]
            if p % 4 == 0:
                lines.append(f"Source: {name}-src ({ver})")
                truth["src"][name] = f"{name}-src"
            lines.append(f"Version: {ver}")
            if i and p % 3 == 0:
                lines.append(f"Depends: {pkgs[i - 1][0]} (>= 1.0), "
                             f"libc6")
            lines.append(f"Description: package {p}")
            paras.append("\n".join(lines))
        put("var/lib/dpkg/status", "\n\n".join(paras) + "\n")
    elif family == "alpine":
        put("etc/alpine-release", os_ver + "\n")
        put("etc/os-release", f'NAME="Alpine Linux"\nID=alpine\n'
            f"VERSION_ID={os_ver}\n")
        put("etc/apk/repositories", "https://dl-cdn.alpinelinux.org/"
            f"alpine/v{os_ver.rsplit('.', 1)[0]}/main\n")
        paras = []
        for i, (name, ver, p) in enumerate(pkgs):
            dep = f"D:so:lib{pkgs[i - 1][2]}.so\n" if i and p % 3 == 0 \
                else ""
            paras.append(f"C:Q1{p:027d}=\nP:{name}\nV:{ver}\nA:x86_64\n"
                         f"o:{name}\nL:MIT\n{dep}p:so:lib{p}.so\n"
                         f"F:usr/lib\nR:lib{p}.so\n")
        put("lib/apk/db/installed", "\n".join(paras))
    else:
        raise ValueError(f"no OS root for family {family!r}")
    for app in tree["apps"]:
        atype, path = app["type"], app["path"]
        abucket, agrammar = app["bucket"], app["grammar"]
        libs = draw(abucket, agrammar, app["packages"], "lib")
        truth["apps"].append((atype, path, abucket, agrammar, libs))
        if atype == "npm":
            packages = {"": {"name": "app", "version": "1.0.0"}}
            for name, ver, p in libs:
                meta = {"version": ver, "resolved": "https://registry."
                        f"example/{name}/-/{name}-{ver}.tgz"}
                if p % 5 == 0:
                    meta["dev"] = True
                packages[f"node_modules/{name}"] = meta
            put(path, json.dumps({"name": "app", "version": "1.0.0",
                                  "lockfileVersion": 2, "requires": True,
                                  "packages": packages}, indent=2),
                app_files)
        elif atype == "pip":
            put(path, "".join(f"{name}=={ver}\n"
                              for name, ver, _ in libs), app_files)
        elif atype == "gomod":
            put(path, "module example.com/app\n\ngo 1.20\n\nrequire (\n"
                + "".join(f"\t{name} {ver}"
                          + (" // indirect" if p % 3 == 0 else "") + "\n"
                          for name, ver, p in libs) + ")\n", app_files)
        else:
            raise ValueError(f"no lockfile for app type {atype!r}")
    return os_files, app_files, truth


def layer_tar(files) -> bytes:
    """[(path, content)] → an uncompressed layer tar."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for path, content in files:
            info = tarfile.TarInfo(path)
            info.size = len(content)
            info.mtime = 1700000000
            tf.addfile(info, io.BytesIO(content))
    return buf.getvalue()


def image_config(diff_ids: list, history) -> dict:
    """An image config over ``diff_ids`` with ``history`` ((created_by,
    empty_layer) pairs)."""
    cfg = {"architecture": "amd64", "os": "linux",
           "created": "2026-10-01T00:00:00Z",
           "config": {"Env": ["PATH=/usr/local/sbin:/usr/local/bin:"
                              "/usr/sbin:/usr/bin:/sbin:/bin"],
                      "Cmd": ["/srv/app/run"]},
           "rootfs": {"type": "layers", "diff_ids": diff_ids}}
    if history:
        cfg["history"] = [
            {"created": "2026-10-01T00:00:00Z", "created_by": by,
             **({"empty_layer": True} if empty else {})}
            for by, empty in history]
    return cfg


def _add(tf, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    info.mtime = 1700000000
    tf.addfile(info, io.BytesIO(data))


def write_docker_save(path: str, layers: list, history,
                      repo_tag: str) -> list:
    """A ``docker save`` tarball of ``layers`` ([[(path, content)]],
    bottom first): ``manifest.json``, the config and one uncompressed
    ``layer.tar`` per layer. Returns the layers' DiffIDs."""
    blobs = [layer_tar(files) for files in layers]
    diff_ids = ["sha256:" + hashlib.sha256(b).hexdigest() for b in blobs]
    config = json.dumps(image_config(diff_ids, history)).encode()
    cname = hashlib.sha256(config).hexdigest() + ".json"
    names = [f"{d[7:]}/layer.tar" for d in diff_ids]
    with tarfile.open(path, "w") as tf:
        _add(tf, cname, config)
        for name, blob in zip(names, blobs):
            _add(tf, name, blob)
        _add(tf, "manifest.json", json.dumps([{
            "Config": cname, "RepoTags": [repo_tag] if repo_tag else [],
            "Layers": names}]).encode())
    return diff_ids
