"""The port's host-side observability held against the JAX package on
synthetic logs: event JSONL and its schema, lifecycle spans, the exporter's
Prometheus text, the series ring and its artifact, and the ``/metrics``
endpoint (bound to 127.0.0.1, port 0)."""
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.obs import events as JEV
from repro.obs import export as JX
from repro.obs import schema as JS
from repro.obs import trace as JT
from repro_torch.obs import events as TEV
from repro_torch.obs import export as TX
from repro_torch.obs import schema as TS
from repro_torch.obs import trace as TT
from repro_torch.obs.httpd import MetricsServer
from repro_torch.obs.series import SeriesBuffer, load_series, record_step, save_series


def _log(mod):
    """A request and a fault lifecycle, on either package's EventLog."""
    log = mod.EventLog(clock=lambda: 1.5)
    log.emit("scan.bist", confirmed=0)
    log.emit("request.enqueue", step=2, rid=7, prompt_len=5)
    log.emit("request.admit", step=4, rid=7, slot=1)
    log.emit("request.first_token", step=6, rid=7)
    log.emit("request.complete", step=11, rid=7, reason="done", tokens=5)
    log.emit("request.enqueue", step=3, rid=8, prompt_len=2)
    log.emit("request.complete", step=9, rid=8, reason="expired", tokens=0)
    log.emit("fault.injected", step=3, row=1, col=2, bit=30, val=1)
    log.emit("fault.suspect", step=5, row=1, col=2)
    log.emit("fault.confirmed", step=6, row=1, col=2)
    log.emit("fault.remapped", step=6, row=1, col=2)
    log.emit("fault.remapped", step=7, row=0, col=3)
    log.emit("repair.plan", step=8, mode="remap", n_remapped=2, remapped_cols=[2, 3],
             quality_fraction=0.75, retrained=False)
    return log


def test_eventlog_jsonl_roundtrip_and_schema(tmp_path):
    tlog, jlog = _log(TEV), _log(JEV)
    assert tlog.dumps() == jlog.dumps()
    path = tmp_path / "ev.jsonl"
    tlog.to_jsonl(str(path))
    assert TS.validate_jsonl(str(path)) == JS.validate_jsonl(str(path)) == len(tlog)
    back = TEV.EventLog.from_jsonl(str(path))
    assert [e.to_json() for e in back.events] == [e.to_json() for e in tlog.events]
    assert back.events[0].step is None
    assert TEV.detection_records(back) == JEV.detection_records(JEV.EventLog.from_jsonl(str(path)))
    recs = TEV.repair_records(back)
    assert recs == JEV.repair_records(jlog) and [r["latency"] for r in recs] == [2, 1]
    assert TS.main([str(path)]) == 0


BAD_EVENTS = [
    ({"ts": 1.0, "step": 0, "kind": "not.a.kind", "data": {}}, "unknown event kind"),
    ({"ts": 1.0, "step": 0, "kind": "fault.injected", "data": {"row": 1}}, "missing required data field"),
    ({"ts": 1.0, "step": 0, "kind": "chaos.injected", "data": {"n": "three"}}, "must be int"),
    ({"ts": 1.0, "step": 0, "kind": "chaos.injected", "data": {"n": True}}, "must be int"),
    ({"ts": 1.0, "step": 0, "kind": "repair.plan", "data": {
        "mode": "remap", "n_remapped": 1, "remapped_cols": [1], "quality_fraction": 1.0, "retrained": 1}},
     "must be bool"),
    ({"ts": "x", "step": 0, "kind": "scan.bist", "data": {"confirmed": 0}}, "ts must be a number"),
    ({"ts": 1.0, "step": 1.5, "kind": "scan.bist", "data": {"confirmed": 0}}, "step must be an int"),
    ({"step": 0, "kind": "scan.bist", "data": {}}, "missing envelope field"),
]


@pytest.mark.parametrize("event,match", BAD_EVENTS)
def test_schema_rejects_what_the_reference_rejects(event, match):
    msgs = []
    for mod in (TS, JS):
        with pytest.raises(ValueError, match=match) as e:
            mod.validate_event(event)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    TS.validate_event({"ts": 1.0, "step": None, "kind": "scan.bist", "data": {"confirmed": 0}})


def test_schema_cli_names_the_bad_line(tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"ts": 1.0, "step": 0, "kind": "nope", "data": {}}\n')
    with pytest.raises(ValueError, match="bad.jsonl:1"):
        TS.validate_jsonl(str(bad))
    assert TS.main([str(bad)]) == 1 and "FAIL" in capsys.readouterr().err
    assert TS.main([]) == 2


def _spans(mod, log):
    return [s.to_json() for t in mod.build_traces(log) for s in t.spans]


def test_spans_match_jax_and_validate(tmp_path):
    tlog, jlog = _log(TEV), _log(JEV)
    spans = _spans(TT, tlog)
    assert spans == _spans(JT, jlog)
    names = {(s["name"], s["status"]) for s in spans}
    assert {("request", "ok"), ("request", "error"), ("decode", "ok"), ("repair", "ok")} <= names
    (tr,) = [t for t in TT.fault_traces(tlog) if t.entity == "fault:1:2"]
    assert tr.root.attributes["detect_latency"] == 3 and tr.root.attributes["repair_latency"] == 2
    good = spans[0]
    for mutate, match in [({"trace_id": "xyz"}, "32 lowercase hex"), ({"span_id": good["span_id"][:-1]}, "16"),
                          ({"status": "weird"}, "status"), ({"start_step": 99}, "end_step"),
                          ({"attributes": []}, "attributes"), ({"name": ""}, "name")]:
        with pytest.raises(ValueError, match=match):
            TT.validate_span({**good, **mutate})
    events = tmp_path / "ev.jsonl"
    tlog.to_jsonl(str(events))
    out = tmp_path / "spans.jsonl"
    assert TT.main([str(events), "-o", str(out)]) == 0
    assert TT.validate_spans_jsonl(str(out)) == len(spans) and TT.main(["--check", str(out)]) == 0
    out.write_text(out.read_text().replace('"ok"', '"weird"', 1))
    assert TT.main(["--check", str(out)]) == 1


SUMMARIES = [
    ({"steps": 10, "nested": {"a": 1.5}, "skip_me": None, "name": "x", "flag": True}, {"arch": "m1"}, "hyca"),
    ({"steps": 1}, {"arch": 'q"1.5\\b\nx', "ok": "plain"}, "hyca"),
    ({"2xx": 5, "lat-ms": 1.0}, {"0bad": "v"}, "9p"),
    ({"injection_steps": [3, 7, 9], "empty": []}, None, "hyca"),
    ({"a": {"b": 1.0}, "a_b": 2.0}, None, "hyca"),
]


@pytest.mark.parametrize("summary,labels,prefix", SUMMARIES)
def test_prometheus_text_byte_equal(summary, labels, prefix):
    txt = TX.prometheus_text(summary, prefix=prefix, labels=labels)
    assert txt == JX.prometheus_text(summary, prefix=prefix, labels=labels)
    names = [line.split("{")[0].split()[0] for line in txt.splitlines() if not line.startswith("#")]
    assert len(names) == len(set(names)) and not any(n[0].isdigit() for n in names)
    hists = {"b": [1, 3, 100], "a": [], "c": [2]}
    assert TX.histograms_text(hists, labels=labels, buckets=(2.0, 64.0)) == \
        JX.histograms_text(hists, labels=labels, buckets=(2.0, 64.0))


def test_write_metrics_out_pair(tmp_path):
    log = _log(TEV)
    out = tmp_path / "deep" / "m.jsonl"
    path, prom = TX.write_metrics_out(str(out), {"steps": 3}, log, histograms={"ttft_steps": [1, 2]})
    assert TS.validate_jsonl(path) == len(log)
    text = (tmp_path / "deep" / "m.jsonl.prom").read_text()
    assert "hyca_steps 3" in text and 'hyca_ttft_steps_bucket{le="2"} 2' in text


def test_series_ring_semantics_and_artifact(tmp_path):
    buf = SeriesBuffer.create(4, {"x": ((), torch.int32), "f": ((2,), torch.float32)})
    assert buf.data["x"].dtype == torch.int32 and buf.data["f"].shape == (4, 2)
    for i in range(6):
        buf = record_step(buf, {"x": i, "f": [i / 3, -i]})
    assert buf.written == 6 and buf.capacity == 4
    got = buf.harvest(start=2)
    assert got["x"].dtype == np.int32 and got["x"].tolist() == [2, 3, 4, 5]
    assert got["f"].dtype == np.float32 and np.array_equal(got["f"][:, 0], np.float32([2 / 3, 1, 4 / 3, 5 / 3]))
    assert torch.equal(buf.data["x"], torch.tensor([4, 5, 2, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match="capacity"):
        buf.harvest(start=0)
    with pytest.raises(ValueError, match="past cursor"):
        buf.harvest(start=9)
    with pytest.raises(ValueError, match="channels mismatch"):
        buf.record({"y": 1})
    with pytest.raises(ValueError, match="not int32 or float32"):
        SeriesBuffer.create(2, {"x": ((), torch.float64)})
    with pytest.raises(ValueError, match="capacity"):
        SeriesBuffer.create(0, {"x": ((), torch.int32)})
    path = save_series(str(tmp_path / "s"), got, meta={"start_step": 2})
    series, meta = load_series(path)
    assert path.endswith(".npz") and meta == {"start_step": 2, "channels": ["f", "x"], "length": 4}
    assert all(np.array_equal(series[k], got[k]) for k in got)


def test_metrics_httpd_scrape():
    state = {"text": "hyca_x 1\n", "boom": False}

    def supplier():
        if state["boom"]:
            raise RuntimeError("exporter broke")
        return state["text"]

    with MetricsServer(supplier) as srv:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        resp = urllib.request.urlopen(url, timeout=5)
        assert resp.status == 200 and resp.read() == b"hyca_x 1\n"
        assert resp.headers["Content-Type"].startswith("text/plain")
        state["text"] = "hyca_x 2\n"
        assert urllib.request.urlopen(url, timeout=5).read() == b"hyca_x 2\n"
        with pytest.raises(urllib.error.HTTPError) as e404:
            urllib.request.urlopen(url.replace("/metrics", "/nope"), timeout=5)
        assert e404.value.code == 404
        state["boom"] = True
        with pytest.raises(urllib.error.HTTPError) as e500:
            urllib.request.urlopen(url, timeout=5)
        assert e500.value.code == 500 and b"exporter broke" in e500.value.read()
    with pytest.raises(RuntimeError, match="not started"):
        MetricsServer(supplier).port
