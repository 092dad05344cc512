"""PyTorch port: the program's host spans (utils/profiling.span).

Under torch.profiler the encode path marks its host work with `dmmt.`
ranges, which the exported chrome trace holds beside the torch ops. Each
test wraps the encoder module's calls in ranges of their own (`start`,
`finish`, `jpeg`, `upload`, as a tracer outside the program would) and
checks that every program span lies inside the call that owns it. With no profiler, `span` is one shared no-op and opens no
range: encodes with both of torch's range contexts made to raise give the
same bytes. The capture and replay spans, the pinned ring's
`dmmt.fill_staged` and `dmmt.fill_wait` inside `dmmt.fill`, and the word
fetch's wait for its copy, `dmmt.fetch_wait`, exist only on a card; their
test skips without one (on a card: `python -m pytest --noconftest
tests/test_torch_spans.py`)."""

import json

import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import programs
from dmmt_jpeg_encoder_tpu_torch.utils import profiling

SHAPE = (16, 24)
# the program span -> the encoder call it belongs to
FINISH_SPANS = ("dmmt.bits_wait", "dmmt.spec_decode", "dmmt.word_fetch", "dmmt.stuff",
                "dmmt.release")
OWNER = {"dmmt.fill": "start", "dmmt.stage_fill": "upload", "dmmt.container": "jpeg",
         **{name: "finish" for name in FINISH_SPANS}}
WRAPPED = {"start_one_dispatch": "start", "start_one_dispatch_slab": "start",
           "finish_one_dispatch": "finish", "_jpeg": "jpeg", "_upload": "upload"}


def frames(n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(19)
    return [rng.integers(0, 256, (*SHAPE, 3), dtype=np.uint8) for _ in range(n)]


def traced_annotations(monkeypatch, tmp_path, encode) -> list[dict]:
    """The program's spans and the wrappers' ranges in encode()'s chrome
    trace, the encoder's calls wrapped in ranges named as in WRAPPED."""
    for name, outer in WRAPPED.items():
        def wrapped(*a, _fn=getattr(tenc, name), _outer=outer, **kw):
            with torch.profiler.record_function(_outer):
                return _fn(*a, **kw)
        monkeypatch.setattr(tenc, name, wrapped)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        encode()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op")
            and (e["name"].startswith("dmmt.") or e["name"] in WRAPPED.values())]


def inside(inner: dict, outers: list[dict]) -> bool:
    return any(o["tid"] == inner["tid"] and o["ts"] <= inner["ts"]
               and inner["ts"] + inner["dur"] <= o["ts"] + o["dur"] for o in outers)


def assert_nested(annotations: list[dict], spans, owner: dict = OWNER) -> None:
    for name in spans:
        found = [e for e in annotations if e["name"] == name]
        owners = [e for e in annotations if e["name"] == owner[name]]
        assert found, f"no {name} in the trace"
        assert all(inside(e, owners) for e in found), f"{name} outside {owner[name]}"


def test_encode_array_spans_nest_in_their_calls(monkeypatch, tmp_path):
    (px,) = frames(1)
    annotations = traced_annotations(monkeypatch, tmp_path,
                                     lambda: dt.encode_array(px, 255, device="cpu"))
    assert_nested(annotations, ("dmmt.fill", *FINISH_SPANS, "dmmt.container"))


def test_encode_batch_spans_nest_in_their_calls(monkeypatch, tmp_path):
    images = frames(3)
    annotations = traced_annotations(monkeypatch, tmp_path,
                                     lambda: dt.encode_batch(images, 255, device="cpu"))
    assert_nested(annotations, ("dmmt.stage_fill", "dmmt.fill", *FINISH_SPANS, "dmmt.container"))
    assert sum(e["name"] == "dmmt.container" for e in annotations) == 3


def test_span_is_one_shared_noop_without_a_profiler():
    assert profiling.span("dmmt.fill") is profiling.span("dmmt.stuff") is profiling._NO_SPAN
    with profiling.span("dmmt.fill"):
        pass


def test_spans_off_never_call_record_function(monkeypatch):
    images = frames(3)
    want_one = dt.encode_array(images[0], 255, device="cpu")
    want_batch = dt.encode_batch(images, 255, device="cpu")

    def refuse(name, *a, **kw):
        raise AssertionError(f"a profiler range {name!r} opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert dt.encode_array(images[0], 255, device="cpu") == want_one
    assert dt.encode_batch(images, 255, device="cpu") == want_batch


def test_capture_and_replay_spans_on_a_card(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: capture and replay exist only there")
    # a shape no other test encodes, so the first call captures its program;
    # so small a frame takes the pinned ring only below its usual threshold
    monkeypatch.setattr(programs, "RING_MIN_BYTES", 0)
    px = np.random.default_rng(23).integers(0, 256, (40, 72, 3), dtype=np.uint8)
    want = dt.encode_array(px, 255, device="cpu")
    jpegs = []

    def twice():
        jpegs.extend(dt.encode_array(px, 255, device="cuda") for _ in range(2))
        torch.cuda.synchronize()

    annotations = traced_annotations(monkeypatch, tmp_path, twice)
    assert jpegs == [want, want]
    names = [e["name"] for e in annotations]
    assert names.count("dmmt.capture") == 1 and names.count("dmmt.replay") == 2
    assert names.count("dmmt.fill_staged") == 2
    assert names.count("dmmt.fill_wait") == 2 * len(programs.band_plan(px.shape, 1))  # one a band
    leases = [e for e in annotations if e["name"] == "dmmt.lease"]
    assert inside(next(e for e in annotations if e["name"] == "dmmt.capture"), leases)
    assert names.count("dmmt.fetch_wait") == 2  # one a finish, inside its word fetch
    assert_nested(annotations, ("dmmt.lookup", "dmmt.lease", "dmmt.fill", "dmmt.replay",
                                "dmmt.fill_staged", "dmmt.fill_wait", *FINISH_SPANS,
                                "dmmt.fetch_wait", "dmmt.container"),
                  {**OWNER, "dmmt.lookup": "start", "dmmt.lease": "start", "dmmt.replay": "start",
                   "dmmt.fill_staged": "dmmt.fill", "dmmt.fill_wait": "dmmt.fill_staged",
                   "dmmt.fetch_wait": "dmmt.word_fetch"})
