"""What decides `correct`: the program's outputs against the plain
reference (`fluid_bench/reference/`), number by number, each against its
limit.

A sample is one step the timed path took: the state it read and the state
it wrote, the number of steps the run had made up to it (and, in the
viewer's loop, the frame it drew and the mesh that frame was drawn from).  The reference steps the same input state and draws
its own frame from its own result.  The reference follows the program step
by step from the program's state; the start is checked by itself, from the
seeded state both sides were given.

The numbers:
  state_gap      the widest gap of a float field (velocity, positions,
                 the two blur buffers) over that field's largest reference
                 magnitude, worst over fields and samples
  state_mismatch elements of the integer and flag fields (cell types,
                 inertia, occupancy, active flags, step, dropped) that
                 differ, plus float elements finite on one side only
  frame_pixels   pixels of the program's frame that differ from the
                 reference's (viewer's loop)
  mesh_mismatch  triangle slots whose validity, vertices or normals
                 differ (viewer's loop)
  window_mismatch how far the state's step counter lies from the number
                 of steps the run made, plus the elements of the active
                 flags and the dropped counter that differ from the seeded
                 state's (no step changes them): what the window's
                 unsampled calls leave behind, such as a replay that left
                 its state as it was

LIMITS holds each number's limit; `PERF.md` gives the readings each was
set from.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_bench.reference import frame as ref_frame
from fluid_bench.reference import step as ref_step
from fluid_bench.state import initial

LIMITS = {
    "state_gap": 1e-5,
    "state_mismatch": 0,
    "frame_pixels": 0,
    "mesh_mismatch": 0,
    "window_mismatch": 0,
}


def _to(state: dict, device) -> dict:
    return {k: v.to(device) for k, v in state.items()}


def state_numbers(out: dict, ref: dict) -> tuple:
    """(state_gap, state_mismatch) of a program state against the
    reference's."""
    gap, mismatch = 0.0, 0
    for k in ref_step.FIELDS:
        a, b = out[k], ref[k]
        if a.shape != b.shape:
            mismatch += max(a.numel(), b.numel())
            continue
        if k in ref_step.FLOAT_FIELDS:
            a, b = a.float(), b.float()
            fa, fb = torch.isfinite(a), torch.isfinite(b)
            both_nan = torch.isnan(a) & torch.isnan(b)
            same_inf = (~fa) & (~fb) & (a == b)
            mismatch += int(((fa != fb) | ((~fa) & (~fb) & ~both_nan
                                           & ~same_inf)).sum())
            both = fa & fb
            if bool(both.any()):
                scale = float(b[both].abs().max())
                diff = float((a[both] - b[both]).abs().max())
                gap = max(gap, diff / scale if scale > 0 else diff)
        else:
            mismatch += int((a != b).sum())
    return gap, mismatch


def window_numbers(out: dict, steps: int, seeded: dict) -> int:
    """window_mismatch of one sample's output state."""
    return (abs(int(out["step"]) - steps)
            + int((out["active"] != seeded["active"]).sum())
            + int((out["dropped"] != seeded["dropped"]).sum()))


def mesh_numbers(mesh, ref_mesh) -> int:
    verts, normals, valid = mesh
    rverts, rnormals, rvalid = ref_mesh
    if verts.shape != rverts.shape:
        return max(valid.numel(), rvalid.numel())
    both = valid & rvalid
    differ = (~torch.isclose(verts, rverts, rtol=0, atol=0,
                             equal_nan=True)).flatten(1).any(1)
    differ |= (~torch.isclose(normals, rnormals, rtol=0, atol=0,
                              equal_nan=True)).any(1)
    return int((valid != rvalid).sum()) + int((both & differ).sum())


def judge(samples: list, fields: dict, traffic: dict, device,
          substitute=None) -> dict:
    """The numbers over every sample.  `substitute(input state)`, where
    given, stands in the program's place (the control): its state, and the
    reference's frame of its state, are judged instead of the program's."""
    scene = ref_step.Scene(fields)
    view = traffic["loop"] == "view"
    numbers = {"state_gap": 0.0, "state_mismatch": 0}
    if view:
        numbers.update(frame_pixels=0, mesh_mismatch=0)
    numbers["window_mismatch"] = 0
    failed = 0
    seeded = None
    for sample in samples:
        if sample["input"] is None:
            # the start: the seeded state both sides were given
            inp = initial(fields, sample["seed"], device)
            seeded = {k: inp[k] for k in ("active", "dropped")}
        else:
            inp = _to(sample["input"], device)
        ref = ref_step.step(inp, scene)
        if substitute is None:
            out = _to(sample["output"], device)
        else:
            out = {k: (v.float() if k in ref_step.FLOAT_FIELDS else v)
                   for k, v in substitute(inp).items()}
        gap, mismatch = state_numbers(out, ref)
        drift = window_numbers(out, sample["steps"], seeded)
        bad = (gap > LIMITS["state_gap"]
               or mismatch > LIMITS["state_mismatch"]
               or drift > LIMITS["window_mismatch"])
        numbers["state_gap"] = max(numbers["state_gap"], gap)
        numbers["state_mismatch"] += mismatch
        numbers["window_mismatch"] += drift
        if view:
            w, h = traffic["width"], traffic["height"]
            img, mesh = ref_frame.frame(ref, fields, w, h)
            if substitute is None:
                prog_img = torch.as_tensor(np.asarray(sample["image"]))
                prog_mesh = tuple(t.to(device) for t in sample["mesh"])
            else:
                prog_img, prog_mesh = ref_frame.frame(out, fields, w, h)
            pixels = int((prog_img.to(img.device) != img).any(-1).sum())
            meshes = mesh_numbers(prog_mesh, mesh)
            bad = (bad or pixels > LIMITS["frame_pixels"]
                   or meshes > LIMITS["mesh_mismatch"])
            numbers["frame_pixels"] += pixels
            numbers["mesh_mismatch"] += meshes
        failed += int(bad)
        del inp, ref, out
    return {"numbers": numbers, "failed": failed,
            "correct": failed == 0 and len(samples) > 0}


def control(fields: dict):
    """The control: the reference put in the program's place, computed in
    bfloat16, the next precision below the configuration's float32."""
    scene = ref_step.Scene(fields)
    return lambda inp: ref_step.step(inp, scene, dtype=torch.bfloat16)
