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

The reference is the configuration's (`manifest.Cell.reference`, the module
`fluid_bench/reference/<name>.py`; `step` where the configuration names
none), handed to `judge` and `control`.  A new reference is a new file
there and a `"reference"` key in the configuration file.  One that sets
`SHARDED = True` is called on every rank of a multi-card cell with the
rank's process group (`group=`) and only that rank's part of each sample:
the seeded state's part is `part(initial(..., x_range=<the rank's
slab>), scene, group)`, and `window_mismatch` then holds the step
counter, the dropped counter and the number of active particles summed
over the ranks (particles may change ranks).  Any other reference judges
a multi-card cell's samples gathered whole on rank 0 (`fluid_bench/ranks.py`).

The seed (`state.initial`) takes every configuration the program takes;
the reference a configuration names decides what can be judged.  Its
`Scene(fields)` refuses an option it does not implement, and
`run.run_cell` builds that `Scene` before any set-up or rank
(`run.judged_by`), so a configuration its reference refuses ends in
seconds with no result line.  `step` refuses domain-sharded particles,
volume correction, the level set and the red-black solver, among others
(its `SUPPORTED`): a configuration that uses one brings its own reference
file and names it, new files and entries only.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_bench.reference import frame as ref_frame
from fluid_bench.reference import step as ref_step
from fluid_bench.state import initial, slab

LIMITS = {
    "state_gap": 1e-5,
    "state_mismatch": 0,
    "frame_pixels": 0,
    "mesh_mismatch": 0,
    "window_mismatch": 0,
}


# elements of a field compared at a time: a boolean index makes int64
# coordinates (six times a float32 field's bytes) and a sum over a mask an
# int64 copy, so a whole blur buffer of one card's slab of a 768^3 scene
# (906M elements) took 20 GiB more than the card had beside the samples
BLOCK = 1 << 24


def _to(state: dict, device) -> dict:
    return {k: v.to(device) for k, v in state.items()}


def state_numbers(out: dict, ref: dict, reference=ref_step) -> tuple:
    """(state_gap, state_mismatch) of a program state against the
    reference's, taken a block of `BLOCK` elements at a time: the same
    numbers (counts add up, the widest gap and magnitude are the largest
    of the blocks'), in memory that does not grow with the field."""
    gap, mismatch = 0.0, 0
    for k in reference.FIELDS:
        a, b = out[k], ref[k]
        if a.shape != b.shape:
            mismatch += max(a.numel(), b.numel())
            continue
        blocks = zip(a.reshape(-1).split(BLOCK), b.reshape(-1).split(BLOCK))
        if k not in reference.FLOAT_FIELDS:
            mismatch += sum(int((x != y).sum()) for x, y in blocks)
            continue
        scale = diff = None
        for x, y in blocks:
            x, y = x.float(), y.float()
            fx, fy = torch.isfinite(x), torch.isfinite(y)
            both_nan = torch.isnan(x) & torch.isnan(y)
            same_inf = (~fx) & (~fy) & (x == y)
            mismatch += int(((fx != fy) | ((~fx) & (~fy) & ~both_nan
                                           & ~same_inf)).sum())
            both = fx & fy
            if bool(both.any()):
                s = float(y[both].abs().max())
                d = float((x[both] - y[both]).abs().max())
                scale = s if scale is None else max(scale, s)
                diff = d if diff is None else max(diff, d)
        if scale is not None:
            gap = max(gap, diff / scale if scale > 0 else diff)
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


def sharded_window_numbers(out: dict, steps: int, seeded: dict,
                           group) -> int:
    """window_mismatch of one rank's part of a sample's output state: the
    step counter, the dropped counter, and the active particles of every
    rank against the seeded state's."""
    import torch.distributed as dist
    active = out["active"].sum(dtype=torch.int64).reshape(1)
    dist.all_reduce(active, group=group)
    return (abs(int(out["step"]) - steps)
            + abs(int(active) - seeded["count"])
            + int((out["dropped"] != seeded["dropped"]).sum()))


def _seeded(fields: dict, seed: int, device, reference, scene, group):
    """The seeded state both sides were given, whole, or this rank's part
    of it where the reference is sharded; and what `window_mismatch`
    compares with."""
    if group is None:
        inp = initial(fields, seed, device)
        return inp, {k: inp[k] for k in ("active", "dropped")}
    import torch.distributed as dist
    x_range = slab(fields, dist.get_rank(group), dist.get_world_size(group))
    whole = initial(fields, seed, device, x_range=x_range)
    seeded = {"count": int(whole["active"].sum()),
              "dropped": whole["dropped"]}
    return reference.part(whole, scene, group), seeded


def judge(samples: list, fields: dict, traffic: dict, device,
          substitute=None, reference=ref_step, group=None) -> dict:
    """The numbers over every sample.  `substitute(input state)`, where
    given, stands in the program's place (the control): its state, and the
    reference's frame of its state, are judged instead of the program's.
    `group`, for a `SHARDED` reference only, is this rank's process
    group: the samples are then this rank's parts.  `bad` flags each
    failed sample in order."""
    sharded = getattr(reference, "SHARDED", False)
    if sharded != (group is not None):
        raise ValueError("a SHARDED reference judges with its group, any "
                         "other without one")
    scene = reference.Scene(fields)
    view = traffic["loop"] == "view"
    numbers = {"state_gap": 0.0, "state_mismatch": 0}
    if view:
        numbers.update(frame_pixels=0, mesh_mismatch=0)
    numbers["window_mismatch"] = 0
    bad = []
    seeded = None
    for sample in samples:
        if sample["input"] is None:
            # the start: the seeded state both sides were given
            inp, seeded = _seeded(fields, sample["seed"], device,
                                  reference, scene, group)
        else:
            inp = _to(sample["input"], device)
        if sharded:
            ref = reference.step(inp, scene, group=group)
        else:
            ref = reference.step(inp, scene)
        if substitute is None:
            out = _to(sample["output"], device)
        else:
            out = {k: (v.float() if k in reference.FLOAT_FIELDS else v)
                   for k, v in substitute(inp).items()}
        gap, mismatch = state_numbers(out, ref, reference)
        if sharded:
            drift = sharded_window_numbers(out, sample["steps"], seeded,
                                           group)
        else:
            drift = window_numbers(out, sample["steps"], seeded)
        failed = (gap > LIMITS["state_gap"]
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
            failed = (failed or pixels > LIMITS["frame_pixels"]
                      or meshes > LIMITS["mesh_mismatch"])
            numbers["frame_pixels"] += pixels
            numbers["mesh_mismatch"] += meshes
        bad.append(bool(failed))
        del inp, ref, out
    return {"numbers": numbers, "failed": sum(bad), "bad": bad,
            "correct": not any(bad) and len(samples) > 0}


def merge_verdicts(verdicts: list) -> dict:
    """Several ranks' verdicts on the same samples as one: `state_gap` the
    widest over the ranks, every count summed, a sample failed where it
    failed on any rank."""
    numbers = {}
    for v in verdicts:
        for k, x in v["numbers"].items():
            if k not in numbers:
                numbers[k] = x
            elif k == "state_gap":
                numbers[k] = max(numbers[k], x)
            else:
                numbers[k] += x
    bad = [any(flags) for flags in zip(*(v["bad"] for v in verdicts))]
    return {"numbers": numbers, "failed": sum(bad), "bad": bad,
            "correct": bool(verdicts) and not any(bad)}


def control(fields: dict, reference=ref_step, group=None):
    """The control: the reference put in the program's place, computed in
    bfloat16, the next precision below the configuration's float32."""
    scene = reference.Scene(fields)
    if group is not None:
        return lambda inp: reference.step(inp, scene, dtype=torch.bfloat16,
                                          group=group)
    return lambda inp: reference.step(inp, scene, dtype=torch.bfloat16)
