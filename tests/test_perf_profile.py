"""scripts/perf_profile.py's trace reading, on synthetic Perfetto events."""

import gzip
import importlib.util
import json
import os

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "scripts", "perf_profile.py")
_spec = importlib.util.spec_from_file_location("perf_profile", _PATH)
pp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pp)


def _meta(kind, pid, name, tid=None):
    e = {"ph": "M", "name": kind, "pid": pid, "args": {"name": name}}
    if tid is not None:
        e["tid"] = tid
    return e


def _op(pid, tid, ts, dur, name):
    return {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "name": name}


GPU_EVENTS = [
    _meta("process_name", 1, "/host:CPU"),
    _meta("process_name", 2, "/device:GPU:0"),
    _meta("thread_name", 2, "Stream #13(Compute)", tid=13),
    _meta("thread_name", 2, "XLA Ops", tid=99),
    _op(1, 5, 0.0, 100.0, "python"),
    _op(2, 13, 10.0, 20.0, "bvh_traverse"),
    _op(2, 13, 25.0, 10.0, "sort_fusion"),
    _op(2, 13, 50.0, 5.0, "loop_gather_fusion"),
    _op(2, 99, 10.0, 45.0, "whole module"),
]


def test_device_ops_keeps_stream_kernels_only():
    ops, source = pp.device_ops(GPU_EVENTS)
    assert source == "device streams"
    assert [e["name"] for e in ops] == [
        "bvh_traverse", "sort_fusion", "loop_gather_fusion"]


def test_device_ops_falls_back_to_host_xla_threads():
    events = [
        _meta("process_name", 1, "/host:CPU"),
        _meta("thread_name", 1, "tf_XLAEigen/1", tid=7),
        _meta("thread_name", 1, "python", tid=8),
        _op(1, 7, 0.0, 3.0, "sort.1"),
        _op(1, 8, 0.0, 9.0, "render"),
    ]
    ops, source = pp.device_ops(events)
    assert [e["name"] for e in ops] == ["sort.1"]
    assert source.startswith("host XLA threads")


@pytest.mark.parametrize("ivs,busy,span", [
    ([], 0.0, 0.0),
    ([(0.0, 5.0)], 5.0, 5.0),
    ([(0.0, 10.0), (2.0, 3.0), (20.0, 5.0)], 15.0, 25.0),
    ([(10.0, 20.0), (25.0, 10.0), (50.0, 5.0)], 30.0, 45.0),
])
def test_busy_time_merges_overlaps(ivs, busy, span):
    ops = [{"ts": ts, "dur": dur} for ts, dur in ivs]
    assert pp.busy_time(ops) == (busy, span)


def test_summarize_and_classes(tmp_path):
    run = tmp_path / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    with gzip.open(run / "perfetto_trace.json.gz", "wt") as f:
        json.dump({"traceEvents": GPU_EVENTS}, f)
    ops, _ = pp.device_ops(pp.load_trace(str(tmp_path)))
    s = pp.summarize(ops)
    assert s["by_class"] == {"traversal kernel": 20.0, "sort": 10.0,
                             "gather/scatter": 5.0}
    assert s["by_name"]["bvh_traverse"] == [20.0, 1]
    assert (s["busy_us"], s["span_us"]) == (30.0, 45.0)
    with pytest.raises(FileNotFoundError):
        pp.load_trace(str(tmp_path / "empty"))
