"""Host ms of `render_frame` and `to_host` a frame, mean over the window's
untraced frames: the copy waits for the frame, so the span holds its
device work too."""


def read(run):
    times = run.window.spans.get("render")
    return sum(times) / len(times) * 1e3 if times else None
