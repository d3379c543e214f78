"""The view's loop lets each frame's host image go before the next frame
copies its own, as a viewer does: an image held through the next copy
made some processes' frames on the card 10-20% slower than others'."""

from __future__ import annotations

import time
import weakref

from fluid_bench.run import run_cell


def test_the_previous_image_is_let_go_before_the_next_copy(tiny,
                                                           monkeypatch):
    import tpu_fluid_torch.render.export as export
    real = export.to_host
    made = []
    held = []

    def to_host(array):
        held.append(bool(made) and made[-1]() is not None)
        out = real(array)
        made.append(weakref.ref(out))
        return out
    monkeypatch.setattr(export, "to_host", to_host)
    r = run_cell(tiny, "tiny.view", 2 ** 31 + 5, 0.5, False, "cpu",
                 time.perf_counter())
    assert r["correct"]
    # only the images the check keeps outlive the next copy: the start's
    # and the frame drawn from the seed
    assert len(held) >= 8
    assert sum(held) <= 2
