"""Host-side exporters (`tpu_fluid.render.export`): PNG frames, OBJ/PLY
meshes, GIF/MP4 videos, particle clouds.

The reference presents to a GLFW swapchain (`main.cpp:209`); headless
rendering dumps frames and meshes to disk instead.  `write_png` needs only
the standard library (zlib and struct); the video writers import PIL or
OpenCV when called, as the JAX package's do.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_host(array) -> np.ndarray:
    """A numpy array of a numpy array, a tensor on any device, or a list."""
    if hasattr(array, "detach"):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image) -> None:
    """image: (H, W, 3) uint8 -> an 8-bit RGB PNG (no filtering)."""
    img = np.ascontiguousarray(to_host(image), dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # each scanline starts with filter type 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_obj(path: str, tris, normals=None) -> None:
    """Triangle soup (T,3,3) -> Wavefront OBJ (flat normals optional)."""
    tris = to_host(tris)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# tpu_fluid surface mesh\n")
        for t in tris:
            for v in t:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if normals is not None:
            for n in to_host(normals):
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for i in range(len(tris)):
            a, b, c = 3 * i + 1, 3 * i + 2, 3 * i + 3
            if normals is not None:
                f.write(f"f {a}//{i+1} {b}//{i+1} {c}//{i+1}\n")
            else:
                f.write(f"f {a} {b} {c}\n")


def write_ply(path: str, tris) -> None:
    """Binary-less ASCII PLY triangle soup."""
    tris = to_host(tris).astype(np.float32)
    nv = tris.shape[0] * 3
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {nv}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {tris.shape[0]}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for t in tris:
            for v in t:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for i in range(tris.shape[0]):
            f.write(f"3 {3*i} {3*i+1} {3*i+2}\n")


def write_gif(path: str, frames, fps: int = 20) -> None:
    """Assemble (H, W, 3) uint8 frames into an animated GIF (needs PIL)."""
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = [Image.fromarray(to_host(f), mode="RGB") for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(1, 1000 // fps), loop=0)


def write_mp4(path: str, frames, fps: int = 25) -> None:
    """Assemble (H, W, 3) uint8 RGB frames into an mp4 (OpenCV's mp4v
    codec)."""
    import cv2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f0 = to_host(frames[0])
    h, w = f0.shape[:2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                          float(fps), (w, h))
    if not out.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path}")
    for f in frames:
        # RGB -> BGR
        out.write(np.ascontiguousarray(to_host(f)[:, :, ::-1]))
    out.release()


def write_video(path: str, frames, fps: int = 25) -> None:
    """Dispatch on extension: .mp4 via OpenCV, anything else animated GIF."""
    if path.lower().endswith(".mp4"):
        write_mp4(path, frames, fps=fps)
    else:
        write_gif(path, frames, fps=fps)


def write_particles_csv(path: str, positions, active) -> None:
    pos = to_host(positions)[to_host(active)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, pos, fmt="%.6f", delimiter=",", header="x,y,z")
