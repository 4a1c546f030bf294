"""Batched secret scanning: on-device multi-pattern DFA sieve +
windowed host verify.

Pipeline (a batched re-design of the reference's per-file scan loop,
pkg/fanal/secret/scanner.go:341):

  1. files → fixed-size overlapping segments in one [B, L] uint8 buffer;
  2. ONE sieve dispatch scans every segment against the compiled
     multi-pattern table (trivy_tpu_torch.ops.dfa): full-length gate
     keywords, anchor literals, and each rule's mandatory fixed
     byte-class chain — per-(segment, pattern) position bitmasks,
     compacted on the device to the rows that hit. Class-run gates
     (trivy_tpu_torch.ops.runs) ride the same dispatch;
  3. host decodes hits: a rule is *gated in* for a file iff one of its
     keywords hit (reference MatchKeywords semantics) AND its compiled
     chain hit (a chain miss is a PROOF the regex cannot match — the
     rule resolves fully on-device); for rules whose regex is provably
     anchor-bounded (rx.anchor), a preliminary regex over small
     windows around anchor hits decides whether the rule can match;
  4. files with surviving rules get a CPU-exact scan restricted to
     those rules — byte-identical findings, because every rule that
     could contribute findings (or censoring) survives the sieve.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.dfa import compact, dfa_masks_host, full_sieve
from ..ops.keywords import MAX_CODE_LEN, N_BLOCKS, pad_batch
from ..ops.runs import run_hits_host
from .plan import ScanPlan, build_scan_plan
from .scanner import Scanner, new_scanner

SEG_LEN = 2048       # segment length in bytes
BACKENDS = ("cuda", "cpu", "cpu-ref")
OVERLAP = 16         # floor; raised to the plan's min_overlap

_BUILTIN_RULES_FP = [None]


def rules_fingerprint(scanner=None) -> str:
    """Content hash of a secret rule SET: two rule configurations
    (builtin vs a trivy-secret.yaml custom set) never share one.
    ``scanner`` is a BatchSecretScanner, a bare Scanner, or None (the
    builtin corpus, hashed once per process)."""
    inner = getattr(scanner, "scanner", scanner)
    rules = getattr(inner, "rules", None)
    if rules is None:
        if _BUILTIN_RULES_FP[0] is None:
            _BUILTIN_RULES_FP[0] = rules_fingerprint(new_scanner())
        return _BUILTIN_RULES_FP[0]
    cached = getattr(inner, "_rules_fp", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    for r in rules:
        h.update(repr((
            r.id, r.category, r.severity,
            r.regex.pattern if r.regex is not None else "",
            tuple(r.keywords),
            r.path.pattern if r.path is not None else "",
            tuple((a.id, a.regex.pattern if a.regex is not None
                   else "", a.path.pattern if a.path is not None
                   else "") for a in r.allow_rules),
            r.secret_group_name)).encode())
    # global allow rules / exclude blocks change findings too
    for a in getattr(inner, "allow_rules", ()):
        h.update(repr((a.id,
                       a.regex.pattern if a.regex is not None
                       else "",
                       a.path.pattern if a.path is not None
                       else "")).encode())
    fp = h.hexdigest()[:16]
    try:
        inner._rules_fp = fp     # rule sets are static after build
    except AttributeError:
        pass
    return fp


@dataclass
class _FileEntry:
    path: str
    content: bytes
    index: int


class BatchSecretScanner:
    """Scans many files per sieve dispatch. API mirrors Scanner.scan
    but over a batch; results are CPU-engine-identical.

    ``backend`` (the reference's ``tpu``/``cpu``/``cpu-ref``): ``cuda``
    (the default) runs the fused kernel launch on the card, ``cpu``
    the plain PyTorch sieve on the CPU, ``cpu-ref`` the numpy sieve."""

    def __init__(self, scanner: Optional[Scanner] = None,
                 seg_len: int = SEG_LEN, backend: str = "cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown secret backend {backend!r} "
                             f"(one of {', '.join(BACKENDS)})")
        self.device = resolve_device(backend) if backend == "cuda" \
            else torch.device("cpu")
        self.backend = backend
        self.scanner = scanner if scanner is not None else new_scanner()
        self.plan: ScanPlan = build_scan_plan(self.scanner.rules)
        self.table = self.plan.table
        # overlap ≥ the longest compiled pattern (full-length
        # keywords, chains, class runs) so nothing straddles an
        # uncovered segment boundary — plan.validate_overlap makes a
        # violation a loud build error, not a silent false negative
        self.overlap = max(OVERLAP, MAX_CODE_LEN,
                           self.plan.min_overlap)
        # the kernel needs L % 128 == 0
        self.seg_len = max(seg_len, 4 * self.overlap, 128)
        self.seg_len = ((self.seg_len + 127) // 128) * 128
        self.plan.validate_overlap(self.overlap)
        self.stats: dict = {}

    # --- segmenting ---

    def _n_segs(self, n: int) -> int:
        """Segment count for an ``n``-byte file: positions advance by
        ``seg_len - overlap`` until one window reaches the end."""
        L, step = self.seg_len, self.seg_len - self.overlap
        if n <= L:
            return 1
        return 1 + -(-(n - L) // step)

    def _fill_rows(self, buf: np.ndarray, row0: int, content: bytes,
                   n_segs: int) -> None:
        """Pack one file's overlapping segments into ``buf`` rows
        [row0, row0+n_segs) with ONE bulk strided copy."""
        L, step = self.seg_len, self.seg_len - self.overlap
        n = len(content)
        arr = np.frombuffer(content, np.uint8)
        if n_segs == 1:
            buf[row0, :n] = arr
            return
        total = (n_segs - 1) * step + L
        tmp = np.zeros(total, np.uint8)
        tmp[:n] = arr
        # zero-copy sliding view over the padded file image; the
        # single assignment below is the only copy that happens
        view = np.lib.stride_tricks.as_strided(
            tmp, (n_segs, L), (step, 1))
        buf[row0:row0 + n_segs] = view

    def _layout(self, metas: list) -> dict:
        """Row layout for a batch: files back to back. Returns
        {B, layout: [(row0, meta idx)], seg_file, seg_pos}; rows of
        ``seg_file == -1`` are inert (all-zero segments) and the
        decoder skips them."""
        step = self.seg_len - self.overlap
        B = sum(m[2] for m in metas)
        layout, row = [], 0
        for mi, m in enumerate(metas):
            layout.append((row, mi))
            row += m[2]
        seg_file = [-1] * B
        seg_pos = [0] * B
        for row0, mi in layout:
            fe, _n, n_segs = metas[mi]
            for k in range(n_segs):
                seg_file[row0 + k] = fe.index
                seg_pos[row0 + k] = k * step
        return {"B": B, "layout": layout, "seg_file": seg_file,
                "seg_pos": seg_pos}

    def _metas(self, files: list) -> list:
        return [(fe, len(fe.content), self._n_segs(len(fe.content)))
                for fe in files if len(fe.content) > 0]

    def _segment(self, files: list) -> tuple:
        """Flatten files into [B, L] uint8 with per-file overlap
        chaining. Returns (buffer, seg_file, seg_pos). Row filling is
        bulk strided copies into disjoint rows, fanned over the host
        pool when the batch is large enough to amortize it
        (reference ``secret/batch.py:253-277``)."""
        # imported here: the runtime package imports this module
        from ..runtime.hostpool import map_in_pool
        metas = self._metas(files)
        if not metas:
            return np.zeros((0, self.seg_len), np.uint8), [], []
        lay = self._layout(metas)
        buf = np.zeros((lay["B"], self.seg_len), np.uint8)

        def fill(task) -> None:
            row0, mi = task
            fe, _n, n_segs = metas[mi]
            self._fill_rows(buf, row0, fe.content, n_segs)

        map_in_pool(fill, lay["layout"])
        return buf, lay["seg_file"], lay["seg_pos"]

    # --- the public API ---

    def scan_files(self, files: Iterable) -> list:
        """``files``: iterable of (path, content-bytes).
        Returns list of ``(entry_index, types.Secret)`` pairs, only for
        entries with findings. Callers MUST map results back by the
        returned index, never by path: the same path can appear in
        several entries.

        ``self.stats`` afterwards holds the sieve selectivity and the
        host/device time split for this call."""
        return self.collect(self.dispatch_files(files))

    def dispatch_files(self, files: Iterable) -> dict:
        """Async half of scan_files: build the segment buffer, upload
        it and ENQUEUE the sieve without waiting for its results."""
        entries = [
            _FileEntry(path=p, content=c, index=i)
            for i, (p, c) in enumerate(files)
        ]
        t0 = time.perf_counter()
        handle = self._dispatch(entries)
        handle["dispatch_s"] = time.perf_counter() - t0
        return handle

    def collect(self, handle: dict) -> list:
        """Blocking half of scan_files: fetch sieve outputs, decode
        candidates, run the windowed/whole-file exact verify."""
        entries = handle["entries"]
        t0 = time.perf_counter()
        candidates = self._decode(handle)
        sieve_s = handle["dispatch_s"] + time.perf_counter() - t0

        t0 = time.perf_counter()
        results = []
        rules_verified = windowed = wholefile = 0
        for fe in entries:
            chosen = candidates.get(fe.index)
            if not chosen:
                continue
            rules_verified += len(chosen)
            idxs = sorted(chosen)
            rules = [self.scanner.rules[i] for i in idxs]
            regions = [chosen[i] for i in idxs]
            sub = Scanner(rules, self.scanner.allow_rules,
                          self.scanner.exclude_block)
            secret = sub.scan(fe.path, fe.content, regions=regions)
            # count AFTER the scan: multibyte files silently fall
            # back whole-file inside Scanner.scan
            if sub.used_regions:
                windowed += sum(1 for r in regions if r is not None)
                wholefile += sum(1 for r in regions if r is None)
            else:
                wholefile += len(regions)
            if secret.findings:
                results.append((fe.index, secret))
        verify_s = time.perf_counter() - t0

        self.stats = {
            "files_total": len(entries),
            "bytes_total": sum(len(fe.content) for fe in entries),
            "segments": handle.get("segments", 0),
            "files_gated": len(candidates),
            "rules_verified": rules_verified,
            "rules_windowed": windowed,
            "rules_wholefile": wholefile,
            "rules_chain_gated": handle.get("chain_gated", 0),
            "files_with_findings": len(results),
            "overflow": handle.get("overflow", False),
            "sieve_s": round(sieve_s, 4),
            "pack_s": round(handle.get("pack_s", 0.0), 4),
            "h2d_s": round(handle.get("h2d_s", 0.0), 4),
            "device_s": round(handle["device_s"], 4),
            "decode_s": round(handle.get("decode_s", 0.0), 4),
            "verify_s": round(verify_s, 4),
            "mode": handle.get("mode", ""),
        }
        return results

    # --- sieve stages ---

    def _dispatch(self, entries: list) -> dict:
        """Segment, upload and enqueue the sieve. Returns the handle
        ``_decode`` consumes; its tensors may still be computing."""
        handle = {"entries": entries, "device_s": 0.0}
        t0 = time.perf_counter()
        buf, seg_file, seg_pos = self._segment(entries)
        handle.update(buf=buf, seg_file=seg_file, seg_pos=seg_pos,
                      pack_s=time.perf_counter() - t0,
                      segments=int(buf.shape[0]))
        if buf.shape[0] == 0:
            handle["mode"] = "empty"
            return handle
        if self.backend == "cpu-ref":
            t0 = time.perf_counter()
            handle["masks"] = dfa_masks_host(buf, self.table)
            handle["mode"] = "host"
            handle["device_s"] += time.perf_counter() - t0
            return handle
        # the segment buffer crosses to the device ONCE; pattern
        # blockmasks + run hits come out of a single dispatch against
        # the resident table, and the mask fetch is compacted to the
        # hit rows (the >CAP fallback fetches all)
        t0 = time.perf_counter()
        specs = tuple(self.plan.run_specs)
        tbl = self.table.device_tables(self.device)
        dev = torch.from_numpy(pad_batch(buf)).to(self.device)
        handle["h2d_s"] = time.perf_counter() - t0
        masks, h = full_sieve(dev, self.table, tbl, specs)
        nhit, idx, cm = compact(masks)
        handle.update(mode="fused", masks=masks, nhit=nhit, idx=idx,
                      cm=cm, h=h)
        handle["device_s"] += time.perf_counter() - t0
        return handle

    def _decode(self, handle: dict) -> dict:
        """file index → {rule index: verify spans or None}.

        A rule maps to merged byte spans when its window proof is
        extraction-exact (the host then regexes only those spans); to
        None when it needs the reference's whole-file scan."""
        if handle["mode"] == "empty":
            return {}
        entries = handle["entries"]
        buf = handle["buf"]
        seg_file = handle["seg_file"]
        seg_pos = handle["seg_pos"]
        t0 = time.perf_counter()
        run_fetch = None
        if handle["mode"] == "host":
            # the numpy sieve already ran at dispatch; this nonzero
            # walk is decode work
            masks = handle["masks"]
            seg_nz, code_nz = np.nonzero(masks)
            hit_vals = masks[seg_nz, code_nz]
        else:
            B = buf.shape[0]
            K = self.table.n_patterns
            nhit = int(handle["nhit"])          # waits for the sieve
            cm = handle["cm"]
            if nhit > cm.shape[0]:
                # more hit rows than the compacted fetch holds: fetch
                # the full mask array the same launch produced
                handle["overflow"] = True
                masks = handle["masks"][:B, :K].cpu().numpy()
                seg_nz, code_nz = np.nonzero(masks)
                hit_vals = masks[seg_nz, code_nz]
            else:
                rows = cm[:nhit, :K].cpu().numpy()
                ridx = handle["idx"][:nhit].cpu().numpy()
                rnz, code_nz = np.nonzero(rows)
                # padded rows (index ≥ B) never hit: zero segments
                seg_nz = ridx[rnz]
                hit_vals = rows[rnz, code_nz]
            run_fetch = handle["h"][:B].cpu().numpy()
            handle["device_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()

        # run-hits decode is lazy: it happens at most once per batch,
        # and only when a run-gated rule survives its keyword gate
        runs_cache: dict = {}
        runs_ready = [False]

        def file_runs(fidx) -> set:
            if not runs_ready[0]:
                hits = run_fetch if run_fetch is not None \
                    else self._host_run_hits(buf, handle)
                for si, sp in zip(*np.nonzero(hits)):
                    if seg_file[int(si)] < 0:
                        continue
                    runs_cache.setdefault(
                        seg_file[int(si)], set()).add(int(sp))
                runs_ready[0] = True
            return runs_cache.get(fidx, set())

        # per file: pattern column → merged list of
        # (segment file-offset, bitmask)
        file_codes: dict = {}
        for si, ci, mv in zip(seg_nz.tolist(), code_nz.tolist(),
                              hit_vals.tolist()):
            if seg_file[si] < 0:
                continue
            fc = file_codes.setdefault(seg_file[si], {})
            fc.setdefault(ci, []).append((seg_pos[si], int(mv)))

        out = self._choose(handle, entries, file_codes, file_runs)
        handle["decode_s"] = time.perf_counter() - t0
        return out

    def _choose(self, handle: dict, entries: list, file_codes: dict,
                file_runs) -> dict:
        """Rule selection over decoded pattern hits: keyword gate ∧
        chain gate ∧ run gate ∧ (for anchored rules) anchor windows.
        A chain miss resolves the rule on-device — no host regex."""
        by_index = {fe.index: fe for fe in entries}
        blk = self.seg_len // N_BLOCKS
        out: dict = {}
        chain_gated = 0

        def runs_pass(rp, fidx) -> bool:
            return not rp.run_gate or \
                set(rp.run_gate) <= file_runs(fidx)

        # rules with no keyword gate and no anchor run everywhere
        # (reference: empty keyword list passes MatchKeywords),
        # unless their DFA chain or a mandatory class-run is
        # provably absent
        always = [rp for rp in self.plan.rules
                  if not rp.gate and not rp.anchored]
        if always:
            for fe in entries:
                codes = file_codes.get(fe.index, {})
                sel = {}
                for rp in always:
                    if rp.chain is not None and rp.chain not in codes:
                        chain_gated += 1
                        continue
                    if runs_pass(rp, fe.index):
                        sel[rp.rule_index] = None
                if sel:
                    out[fe.index] = sel

        for fidx, codes in file_codes.items():
            fe = by_index[fidx]
            hit = set(codes)
            chosen = dict(out.get(fidx, ()))
            for rp in self.plan.rules:
                if rp.gate and not (hit & rp.gate):
                    continue
                if rp.chain is not None and rp.chain not in hit:
                    if rp.gate:
                        chain_gated += 1
                    continue
                if not rp.anchored:
                    if rp.gate and runs_pass(rp, fidx):
                        chosen[rp.rule_index] = None
                    continue
                anchor_hits = [h for a in rp.anchors
                               for h in codes.get(a, ())]
                if not anchor_hits:
                    continue
                spans = self._windows(fe, rp, anchor_hits, blk)
                if rp.exact:
                    # extraction-exact: verify scans only these spans
                    chosen[rp.rule_index] = spans
                elif self._prelim(fe, rp, spans):
                    chosen[rp.rule_index] = None
            if chosen:
                out[fidx] = chosen
        handle["chain_gated"] = chain_gated
        return out

    def _host_run_hits(self, buf: np.ndarray, handle: dict) \
            -> np.ndarray:
        """[B, n_specs] class-run hits from the numpy run detector over
        the segment buffer the sieve used (the cpu-ref backend; the
        fused launch returns them itself). Overlap ≥ max runlen keeps
        it sound."""
        t0 = time.perf_counter()
        hits = run_hits_host(buf, tuple(self.plan.run_specs))
        handle["device_s"] += time.perf_counter() - t0
        return hits

    def _windows(self, fe: _FileEntry, rp, anchor_hits: list,
                 blk: int) -> list:
        """Merged byte spans around anchor hit blocks: every possible
        match of the rule lies entirely inside one span, with ≥8 bytes
        of slack past any match edge (window = max match len, plus
        MAX_CODE_LEN for the anchor literal body crossing a block
        edge — anchors are ≤ MAX_CODE_LEN by rx construction)."""
        w = rp.window + MAX_CODE_LEN
        spans = []
        for pos, mask in anchor_hits:
            m = mask
            while m:
                lsb = m & -m
                j = lsb.bit_length() - 1
                m ^= lsb
                a = pos + j * blk - w
                b = pos + (j + 1) * blk + w
                spans.append((max(0, a), min(len(fe.content), b)))
        spans.sort()
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    def _prelim(self, fe: _FileEntry, rp, merged: list) -> bool:
        """Windowed existence check for rules whose window proof is
        sound for detection but not extraction (elastic edges, ^/$):
        a hit here still requires the reference whole-file scan."""
        rule = self.scanner.rules[rp.rule_index]
        for a, b in merged:
            # decode mirrors Scanner.scan; edge-partial codepoints sit
            # in the ≥8-byte margin outside any possible match span
            window = fe.content[a:b].decode("utf-8", "surrogateescape")
            if rule.regex.search(window):
                return True
        return False
