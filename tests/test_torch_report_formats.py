"""The port's report writers against the reference's: every case of
``tests/test_report_formats.py`` (sarif, cyclonedx, spdx, spdx-json,
github, cosign-vuln, template, the dependency tree) writes the same
seeded report through both packages, and the outputs are equal after
the random UUIDs and the wall-clock timestamps are numbered in order
of appearance."""

import io
import json
import re

import numpy as np
import pytest

import trivy_tpu.cli as rcli
import trivy_tpu.report as rreport
import trivy_tpu.report.writer as rwriter
import trivy_tpu.sbom as rsbom
import trivy_tpu.types as rtypes
import trivy_tpu.types.artifact as rart
import trivy_tpu.types.report as rrep
import trivy_tpu_torch.cli as tcli
import trivy_tpu_torch.report as treport
import trivy_tpu_torch.report.writer as twriter
import trivy_tpu_torch.sbom as tsbom
import trivy_tpu_torch.types as ttypes
import trivy_tpu_torch.types.artifact as tart
import trivy_tpu_torch.types.report as trep

REF = dict(types=rtypes, art=rart, rep=rrep, report=rreport,
           writer=rwriter, sbom=rsbom, cli=rcli)
PORT = dict(types=ttypes, art=tart, rep=trep, report=treport,
            writer=twriter, sbom=tsbom, cli=tcli)

_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}")
_TIME = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?(Z|[+-]\d\d:\d\d)")


def _numbered(text: str) -> str:
    """Random UUIDs and timestamps → their order of first appearance."""
    for rx, tag in ((_UUID, "UUID"), (_TIME, "TIME")):
        seen: dict = {}
        text = rx.sub(lambda m: seen.setdefault(
            m.group(0), f"<{tag}{len(seen)}>"), text)
    return text


def _report(pkg, seed: int = 0):
    """``tests/test_report_formats.py::_report`` with ``seed`` extra
    packages and vulnerabilities drawn with numpy."""
    t, art, rep = pkg["types"], pkg["art"], pkg["rep"]
    rng = np.random.default_rng(seed)
    vuln = t.DetectedVulnerability(
        vulnerability_id="CVE-2019-14697", pkg_name="musl",
        installed_version="1.1.20-r4", fixed_version="1.1.20-r5",
        severity_source="nvd",
        primary_url="https://avd.aquasec.com/nvd/cve-2019-14697",
        data_source=t.DataSource(id="alpine", name="Alpine SecDB",
                                 url="https://secdb.alpinelinux.org/"),
        vulnerability=t.Vulnerability(
            title="musl x87 stack imbalance",
            description="x87 floating-point stack adjustment bug",
            severity="CRITICAL", vendor_severity={"nvd": "CRITICAL"},
            cvss={"nvd": {"V3Score": 9.8,
                          "V3Vector": "CVSS:3.1/AV:N/AC:L"}},
            references=["https://example.com/ref"],
            cwe_ids=["CWE-787"]))
    secret = t.SecretFinding(
        rule_id="aws-access-key-id", category="AWS",
        severity="CRITICAL", title="AWS Access Key ID",
        start_line=3, end_line=3, match="AKIA****************")
    pkgs = [art.Package(name="musl", version="1.1.20", release="r4",
                        arch="x86_64", src_name="musl",
                        src_version="1.1.20", src_release="r4",
                        licenses=["MIT"])]
    vulns = [vuln]
    sevs = ["CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN"]
    for i in range(seed):
        name = f"lib{i}"
        ver = f"{int(rng.integers(0, 9))}.{int(rng.integers(0, 30))}"
        pkgs.append(art.Package(name=name, version=ver, release="r0",
                                arch="x86_64", src_name=name,
                                src_version=ver, src_release="r0",
                                licenses=["GPL-2.0"]))
        score = float(rng.integers(10, 100)) / 10
        vulns.append(t.DetectedVulnerability(
            vulnerability_id=f"CVE-2020-{int(rng.integers(1000, 9999))}",
            pkg_name=name, installed_version=f"{ver}-r0",
            fixed_version=f"{ver}-r1",
            vulnerability=t.Vulnerability(
                title=f"bug {i}", severity=sevs[int(rng.integers(0, 5))],
                cvss={"nvd": {"V3Score": score}})))
    return t.Report(
        artifact_name="test/alpine:3.9", artifact_type="container_image",
        metadata=t.Metadata(
            os=art.OS(family="alpine", name="3.9.4"),
            image_id="sha256:abcd", repo_tags=["test/alpine:3.9"],
            repo_digests=["test/alpine@sha256:" + "ab" * 32],
            image_config={"architecture": "amd64"}),
        results=[
            t.Result(target="test/alpine:3.9 (alpine 3.9.4)",
                     class_=rep.ResultClass.OSPKG, type="alpine",
                     packages=pkgs, vulnerabilities=vulns),
            t.Result(target="app/config.env",
                     class_=rep.ResultClass.SECRET, type="secret",
                     secrets=[secret])])


def _write(pkg, fmt, report=None, seed=0, **kw) -> str:
    buf = io.StringIO()
    pkg["report"].write_report(report or _report(pkg, seed), fmt=fmt,
                               output=buf, **kw)
    return buf.getvalue()


def _dup_vuln(pkg, seed):
    report = _report(pkg, seed)
    report.results[0].vulnerabilities.append(
        report.results[0].vulnerabilities[0])
    return _write(pkg, "sarif", report)


def _sbom_rescan(pkg, seed):
    report = _report(pkg, seed)
    report.artifact_type = "cyclonedx"
    report.cyclonedx = {
        "serialNumber": "urn:uuid:abc", "version": 1,
        "metadata": {"component": {"name": "orig", "version": "1",
                                   "type": "container"}}}
    report.results[0].vulnerabilities[0].ref = \
        "pkg:apk/alpine/musl@1.1.20-r4"
    return _write(pkg, "cyclonedx", report)


def _tv_parsed(pkg, seed):
    tv = _write(pkg, "spdx", seed=seed)
    out = pkg["sbom"].decode(tv.encode(), "spdx-tv")
    return json.dumps({"os": out.os.to_dict(),
                       "packages": [p.to_dict() for p in out.packages]},
                      sort_keys=True) + tv


def _junit(pkg, seed, tmp_path):
    tpl = """{{- range . -}}
<testsuite name="{{ .Target }}" tests="{{ .Vulnerabilities | len }}">
{{- range .Vulnerabilities }}
  <testcase name="{{ .VulnerabilityID }}[{{ .Severity }}]"/>
{{- end }}
</testsuite>
{{ end }}"""
    p = tmp_path / "junit.tpl"
    p.write_text(tpl)
    return _write(pkg, "template", seed=seed, output_template=f"@{p}")


def _trim(pkg, seed):
    from importlib import import_module
    name = pkg["report"].__name__ + ".template"
    tpl = import_module(name).Template
    return "|".join([tpl("a\n{{- .X }}").render({"X": "b"}),
                     tpl("{{ .X -}}  \n c").render({"X": "b"}),
                     tpl("{{- range . }}x{{ end -}}\n").render([1, 2])])


def _error(pkg, seed, template):
    with pytest.raises(ValueError) as e:
        _write(pkg, "template", seed=seed, output_template=template)
    return str(e.value)


def _list_all(pkg, seed):
    out = []
    for fmt in ("cyclonedx", "spdx", "spdx-json", "github", "json",
                "table", "sarif"):
        args = pkg["cli"].build_parser().parse_args(
            ["fs", ".", "--format", fmt])
        if pkg is REF:
            out.append(pkg["cli"]._scan_options(args).list_all_packages)
        else:
            out.append(pkg["cli"]._list_all(args))
    return json.dumps(out)


def _src_version(pkg, seed):
    report = _report(pkg, seed)
    p = report.results[0].packages[0]
    p.version, p.release = "1.2-3+b1", ""
    p.src_version, p.src_release = "1.2-3", ""
    report.results[0].vulnerabilities[0].installed_version = "1.2-3"
    return _write(pkg, "cyclonedx", report)


def _empty_report(pkg, seed):
    report = pkg["types"].Report(artifact_name="x",
                                 artifact_type="filesystem", results=[])
    return "".join(_write(pkg, fmt, report) for fmt in (
        "sarif", "cyclonedx", "spdx", "spdx-json", "github",
        "cosign-vuln"))


def _tree_report(pkg):
    t, art = pkg["types"], pkg["art"]
    pkgs = [art.Package(id="app@1.0.0", name="app", version="1.0.0",
                        depends_on=["widget-kit@2.0.0"]),
            art.Package(id="widget-kit@2.0.0", name="widget-kit",
                        version="2.0.0", depends_on=["jquery@3.4.1"]),
            art.Package(id="jquery@3.4.1", name="jquery",
                        version="3.4.1")]
    vuln = t.DetectedVulnerability(
        vulnerability_id="CVE-2020-11022", pkg_id="jquery@3.4.1",
        pkg_name="jquery", installed_version="3.4.1",
        fixed_version=">=3.5.0",
        vulnerability=t.Vulnerability(title="xss", severity="MEDIUM"))
    return t.Report(results=[t.Result(target="package-lock.json",
                                      packages=pkgs,
                                      vulnerabilities=[vuln])])


# the 22 cases of tests/test_report_formats.py, by its test names
CASES = {
    "sarif_structure": lambda p, s, tmp: _write(p, "sarif", seed=s),
    "sarif_results_and_regions": lambda p, s, tmp: _write(
        p, "sarif", seed=s, app_version="0.1"),
    "sarif_rule_dedup_keeps_index": lambda p, s, tmp: _dup_vuln(p, s),
    "cyclonedx_structure": lambda p, s, tmp: _write(p, "cyclonedx",
                                                    seed=s),
    "cyclonedx_dependencies_and_vulns": lambda p, s, tmp: _write(
        p, "cyclonedx", seed=s, app_version="0.1"),
    "cyclonedx_sbom_rescan_exports_vuln_refs_only":
        lambda p, s, tmp: _sbom_rescan(p, s),
    "spdx_json": lambda p, s, tmp: _write(p, "spdx-json", seed=s),
    "spdx_tag_value_parses_back": lambda p, s, tmp: _tv_parsed(p, s),
    "github_snapshot": lambda p, s, tmp: _write(p, "github", seed=s),
    "cosign_vuln_predicate": lambda p, s, tmp: _write(
        p, "cosign-vuln", seed=s),
    "template_inline": lambda p, s, tmp: _write(
        p, "template", seed=s,
        output_template='{{ range . }}{{ .Target }}:'
                        '{{ len .Vulnerabilities }};{{ end }}'),
    "template_nested_range_and_funcs": lambda p, s, tmp: _write(
        p, "template", seed=s,
        output_template='{{ range . }}{{ range .Vulnerabilities }}'
                        '{{ .VulnerabilityID }}|{{ .Severity | toLower }}|'
                        '{{ escapeXML .Title }}\n{{ end }}{{ end }}'),
    "template_if_else_and_vars": lambda p, s, tmp: _write(
        p, "template", seed=s,
        output_template='{{ $n := 0 }}{{ range . }}'
                        '{{ if .Vulnerabilities }}V{{ else }}-{{ end }}'
                        '{{ end }}'),
    "template_junit_like": _junit,
    "template_trim_markers": lambda p, s, tmp: _trim(p, s),
    "template_missing_template_flag": lambda p, s, tmp: _error(p, s, ""),
    "template_missing_template_file": lambda p, s, tmp: _error(
        p, s, "@/nonexistent.tpl"),
    "sbom_formats_list_all_packages": lambda p, s, tmp: _list_all(p, s),
    "cyclonedx_links_vuln_by_source_version":
        lambda p, s, tmp: _src_version(p, s),
    "title_missing_fields_dont_crash":
        lambda p, s, tmp: _empty_report(p, s),
    "dependency_tree_rendered": lambda p, s, tmp: p[
        "writer"].render_table(_tree_report(p), dependency_tree=True),
    "dependency_tree_off_by_default": lambda p, s, tmp: p[
        "writer"].render_table(_tree_report(p)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_writer_equals_reference(case, tmp_path):
    for seed in (0, 3):
        want = CASES[case](REF, seed, tmp_path)
        got = CASES[case](PORT, seed, tmp_path)
        assert want
        assert _numbered(got) == _numbered(want), (case, seed)


def test_formats_equal_reference():
    """Every format of the reference is a choice of the port's CLI,
    and ``--template``/``-t`` is a flag of every scan subcommand."""
    assert twriter.FORMATS == rwriter.FORMATS
    for cmd in (["image", "x.tar"], ["fs", "."], ["rootfs", "."],
                ["config", "."], ["sbom", "b.json"]):
        args = tcli.build_parser().parse_args(
            cmd + ["-f", "template", "-t", "{{ . }}"])
        assert (args.format, args.template) == ("template", "{{ . }}")
