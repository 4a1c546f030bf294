"""The per-layer readers' arithmetic on a synthetic trace, and the
bounds they divide by."""

import pytest

from benchmark import metrics, roofline
from benchmark.profile import breakdown, clock_map
from benchmark.spans import SpanRecord, TraceData

SHAPE = {"literals": [b"akia", b"ghp_"], "seg_len": 2048,
         "chains": [[("lit", b"xoxb-"), ("run", ((48, 57),), 10)]],
         "specs": [(((65, 90),), 16)], "n_patterns": 3, "desc_bytes": 400}


def _trace(**kw) -> TraceData:
    spans = [
        SpanRecord("layer_analyze", 0.0, 1.5, {"layer": 0}),
        SpanRecord("layer_analyze", 1.0, 2.0, {"layer": 1}),
        SpanRecord("pack", 2.0, 2.25, {"files": 10, "segments": 40}),
        SpanRecord("pack", 2.0, 2.5, {"jobs": 2000, "unique": 900}),
        SpanRecord("pack", 2.1, 2.2, {"rows": 512}),
        SpanRecord("report", 3.0, 3.4, {}),
        SpanRecord("report", 4.0, 4.2, {}),
        SpanRecord("dfa_scan", 2.3, 2.4, {"segments": 40, "patterns": 3,
                                          "clock": "cuda_event"}),
        SpanRecord("dfa_scan", 2.3, 2.31, {"fetch": True}),
        SpanRecord("device_compute", 2.5, 2.5001,
                   {"kind": "interval", "rows": 8192,
                    "clock": "cuda_event"}),
        SpanRecord("device_compute", 2.6, 2.6001,
                   {"kind": "interval", "rows": 4096}),
    ]
    base = dict(spans=spans, sched=[
        (None, {"batch": {"count": 2, "items_total": 5}}),
        ({"batch": {"count": 1, "items_total": 8}},
         {"batch": {"count": 3, "items_total": 12}})],
        kernels=[("dfa_sieve_kernel", 0.0, 500.0),
                 ("vectorized_elementwise_kernel", 600.0, 10.0)],
        # the match's kernels inside its spans; the sieve's inside one
        # too, and one kernel outside every span
        kernels_mono=[("index_kernel", 2.50002, 2.50004),
                      ("vectorized_elementwise_kernel", 2.50005,
                       2.50006),
                      ("dfa_sieve_kernel", 2.50001, 2.50009),
                      ("index_kernel", 2.60002, 2.60003),
                      ("reduce_kernel", 2.9, 2.95)],
        busy_s=0.25, window_s=10.0, completed=4, db_load_s=31.5,
        sieve=SHAPE)
    base.update(kw)
    return TraceData(**base)


def read(name, **kw):
    return metrics.load(name).read(_trace(**kw))


def test_batch_items_count_the_window_only():
    # (5 + 12 - 8) items over (2 + 3 - 1) batches
    assert read("batch_images.sweep") == pytest.approx(9 / 4)
    assert read("batch_boms.sbom") == pytest.approx(9 / 4)
    assert read("batch_boms.sbom", sched=[]) is None


def test_span_sums_per_item():
    assert read("layer_analyze_s_per_image.sweep") == pytest.approx(2.5 / 4)
    assert read("secret_pack_s_per_image.sweep") == pytest.approx(0.25 / 4)
    assert read("report_s_per_bom.sbom") == pytest.approx(0.6 / 4)
    # pack spans of waves (rows=) are inside a jobs= span: not summed
    assert read("match_pack_s_per_kjob.sbom") == pytest.approx(0.5 / 2)
    assert read("report_s_per_bom.sbom", completed=0) is None


def test_interval_roofline_reads_event_stamped_spans():
    # the event-stamped span's rows over the 30 us of the match's
    # kernels inside it; the span without the clock, the sieve's kernel
    # and the kernel outside every span count for nothing
    bound = 8192 * 77 / 3.35e12
    want = 100 * bound / 3e-5
    assert read("interval_match_roofline.sweep") == pytest.approx(want,
                                                                  rel=1e-3)
    assert read("interval_match_roofline.sbom") == pytest.approx(want,
                                                                 rel=1e-3)
    assert read("interval_match_roofline.sbom", spans=[]) is None
    # nothing to read where the trace is not tied to the host clock
    assert read("interval_match_roofline.sbom", kernels_mono=[]) is None


def test_interval_roofline_counts_a_kernel_once():
    spans = [SpanRecord("device_compute", 1.0, 1.001,
                        {"kind": "interval", "rows": 1000,
                         "clock": "cuda_event"}),
             SpanRecord("device_compute", 1.0005, 1.002,
                        {"kind": "interval", "rows": 1000,
                         "clock": "cuda_event"})]
    got = read("interval_match_roofline.sbom", spans=spans,
               kernels_mono=[("k", 1.0006, 1.0007)])
    assert got == pytest.approx(100 * 2000 * 77 / 3.35e12 / 1e-4,
                                rel=1e-3)


def test_clock_map_takes_the_drift_out():
    to_mono = clock_map([1e6, 11e6], [100.0, 110.001])
    assert to_mono(1e6) == pytest.approx(100.0)
    assert to_mono(6e6) == pytest.approx(105.0005)
    assert clock_map([1e6], [100.0, 110.0])(2e6) == pytest.approx(101.0)
    assert clock_map([], [100.0]) is None


def test_sieve_roofline_over_kernel_time():
    ms, by = roofline.sieve_bound_ms(40, SHAPE)
    assert by == "operations"
    assert read("dfa_blockmask_roofline.sweep") == \
        pytest.approx(100 * ms / 0.5)
    # no kernel in the trace: nothing to read, never 0
    assert read("dfa_blockmask_roofline.sweep", kernels=[]) is None


def test_sieve_ops_by_hand():
    # one row: 2048 positions, 64 words
    n, w = 2048.0, 64.0
    # akia, ghp_: one full compare each, and an OR
    lits = (1 + 1) + (1 + 1)
    # xoxb-: a full compare, a masked one (AND, compare), an AND of the
    # two, and an OR; tested where the chain of 5 + 10 bytes can start
    first = (2048 - 15 + 1) * (4 + 1)
    sets = n * 1 + w * 2
    chains = first + w * (2 * len(roofline.erosion_steps(10)) + 2 * 2 + 2)
    specs = w * (2 * len(roofline.erosion_steps(16)) + 1)
    assert roofline.literal_ops(b"xoxb-") == 4
    assert roofline.sieve_ops(1, SHAPE) == pytest.approx(
        4 * n + n * lits + sets + chains + specs)


def test_idle_and_db_load():
    assert read("device_idle_pct.sweep") == pytest.approx(97.5)
    assert read("device_idle_pct.sbom", busy_s=0.0) is None
    assert read("db_load_s") == 31.5


def test_breakdown_names_gaps_by_host_spans():
    spans = _trace().spans
    dev = {"ops": {"k1": 0.2, "k2": 0.05}, "gaps": [(0.2, 1.4), (2.0, 2.1)]}
    out = breakdown(dev, spans)
    assert out["device_ops"] == [["k1", 0.2], ["k2", 0.05]]
    assert out["idle_gaps"][0] == ["layer_analyze", pytest.approx(1.2)]
    assert out["idle_gaps"][1][0] == "pack"
