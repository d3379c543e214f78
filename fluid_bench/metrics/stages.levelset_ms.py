"""Device ms a step of the level set (`surface/levelset.py`): the
program's span `levelset`, timed by the event-record nodes inside the
replayed step graph, its device ms over the window's replays read
(`loops/stream_spans.py` puts the program's report in
`Window.program_spans`).  None where the window holds no such span: a
loop that reads no program spans, or a program without the span."""


def read(run):
    spans = getattr(run.window, "program_spans", None) or {}
    r = spans.get("levelset")
    if not r or not r["device_calls"]:
        return None
    return r["device_ms"] / r["device_calls"]
