// Native z-buffered software rasterizer, multithreaded.
//
// The reference renders through Vulkan's native raster pipeline: 1M point
// sprites sized min(base/depth, max) drawn as circles
// (30_render_particles/render.vert:28-45, render.frag:20-26) and the
// marching-cubes triangle stream with flat Lambert shading
// (31_render_surface).  On TPU there is no raster unit, so exact-parity
// frames are produced host-side by this C++ rasterizer (the device splat
// renderer in render/splat.py remains as the fully-on-device alternative).
//
// Parallel structure (deterministic): phase 1 transforms every primitive to
// screen space in parallel over primitives (independent scratch writes);
// phase 2 splits the framebuffer into horizontal bands, one thread per
// band — every thread walks all primitives in order but only touches
// pixels of its band, so there are no write conflicts and the output is
// bitwise-identical to the serial rasterization (including depth ties,
// which resolve to the first primitive in submission order either way).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -shared -fPIC -pthread rasterizer.cpp -o librasterizer.so
// (driven by tpu_fluid/native/__init__.py or the repo Makefile).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Vec4 { float x, y, z, w; };

inline Vec4 mvp_mul(const float* m, float x, float y, float z) {
    // m is row-major 4x4
    return Vec4{
        m[0] * x + m[1] * y + m[2] * z + m[3],
        m[4] * x + m[5] * y + m[6] * z + m[7],
        m[8] * x + m[9] * y + m[10] * z + m[11],
        m[12] * x + m[13] * y + m[14] * z + m[15],
    };
}

inline void put(float* depth, uint8_t* rgb, int width, int px, int py,
                float d, float r, float g, float b) {
    int idx = py * width + px;
    if (d < depth[idx]) {
        depth[idx] = d;
        rgb[3 * idx + 0] = (uint8_t)std::min(255.f, std::max(0.f, r * 255.f));
        rgb[3 * idx + 1] = (uint8_t)std::min(255.f, std::max(0.f, g * 255.f));
        rgb[3 * idx + 2] = (uint8_t)std::min(255.f, std::max(0.f, b * 255.f));
    }
}

inline int n_threads() {
    unsigned hw = std::thread::hardware_concurrency();
    return (int)std::min(16u, hw ? hw : 1u);
}

// Run fn(lo, hi) over [0, n) split into contiguous chunks, one per thread.
// `min_n` is the serial cutoff: primitive-transform phases use the default
// (per-unit work is tiny), framebuffer-band phases pass a small value
// (each unit is a whole scanline across ~10^6 primitives).
template <typename F>
void parallel_ranges(long n, F fn, long min_n = 4096) {
    int nt = n_threads();
    if (nt <= 1 || n < min_n) { fn(0L, n); return; }
    std::vector<std::thread> ts;
    long chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        long lo = t * chunk, hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(fn, lo, hi);
    }
    for (auto& th : ts) th.join();
}

struct TriScreen {
    float sx[3], sy[3], sd[3];
    int x0, x1, y0, y1;
    float ax, ay, bx, by, inv_det;
    bool ok;
};

struct PtScreen {
    float sx, sy, w, rad;
    int x0, x1, y0, y1;
    bool ok;
};

}  // namespace

extern "C" {

// Triangles: verts = n*3*3 world floats, colors = n*3 flat RGB.
void rasterize_triangles(const float* verts, const float* colors,
                         long n_tris, const float* mvp,
                         int width, int height,
                         float* depth, uint8_t* rgb) {
    if (n_threads() <= 1) {
        // single-core: the fused one-pass loop avoids the scratch pass
        for (long t = 0; t < n_tris; ++t) {
            const float* v = verts + t * 9;
            Vec4 c[3];
            bool ok = true;
            float sx[3], sy[3], sd[3];
            for (int k = 0; k < 3; ++k) {
                c[k] = mvp_mul(mvp, v[3 * k], v[3 * k + 1], v[3 * k + 2]);
                if (c[k].w <= 1e-6f) { ok = false; break; }
                float inv = 1.0f / c[k].w;
                sx[k] = (c[k].x * inv * 0.5f + 0.5f) * width;
                sy[k] = (c[k].y * inv * 0.5f + 0.5f) * height;
                sd[k] = c[k].w;
            }
            if (!ok) continue;
            int x0 = std::max(0, (int)std::floor(
                std::min({sx[0], sx[1], sx[2]})));
            int x1 = std::min(width - 1, (int)std::ceil(
                std::max({sx[0], sx[1], sx[2]})));
            int y0 = std::max(0, (int)std::floor(
                std::min({sy[0], sy[1], sy[2]})));
            int y1 = std::min(height - 1, (int)std::ceil(
                std::max({sy[0], sy[1], sy[2]})));
            if (x0 > x1 || y0 > y1) continue;
            float ax = sx[1] - sx[0], ay = sy[1] - sy[0];
            float bx = sx[2] - sx[0], by = sy[2] - sy[0];
            float det = ax * by - ay * bx;
            if (std::fabs(det) < 1e-12f) continue;
            float inv_det = 1.0f / det;
            float cr = colors[3 * t], cg = colors[3 * t + 1],
                  cb = colors[3 * t + 2];
            for (int py = y0; py <= y1; ++py) {
                for (int px = x0; px <= x1; ++px) {
                    float qx = px + 0.5f - sx[0], qy = py + 0.5f - sy[0];
                    float u = (qx * by - qy * bx) * inv_det;
                    float w = (ax * qy - ay * qx) * inv_det;
                    if (u < 0.f || w < 0.f || u + w > 1.f) continue;
                    float d = sd[0] + u * (sd[1] - sd[0])
                              + w * (sd[2] - sd[0]);
                    put(depth, rgb, width, px, py, d, cr, cg, cb);
                }
            }
        }
        return;
    }
    std::vector<TriScreen> scr(n_tris);

    parallel_ranges(n_tris, [&](long lo, long hi) {
        for (long t = lo; t < hi; ++t) {
            TriScreen& s = scr[t];
            s.ok = false;
            const float* v = verts + t * 9;
            for (int k = 0; k < 3; ++k) {
                Vec4 c = mvp_mul(mvp, v[3 * k], v[3 * k + 1], v[3 * k + 2]);
                if (c.w <= 1e-6f) goto next;
                {
                    float inv = 1.0f / c.w;
                    s.sx[k] = (c.x * inv * 0.5f + 0.5f) * width;
                    s.sy[k] = (c.y * inv * 0.5f + 0.5f) * height;
                    s.sd[k] = c.w;  // view depth
                }
            }
            {
                s.x0 = std::max(0, (int)std::floor(
                    std::min({s.sx[0], s.sx[1], s.sx[2]})));
                s.x1 = std::min(width - 1, (int)std::ceil(
                    std::max({s.sx[0], s.sx[1], s.sx[2]})));
                s.y0 = std::max(0, (int)std::floor(
                    std::min({s.sy[0], s.sy[1], s.sy[2]})));
                s.y1 = std::min(height - 1, (int)std::ceil(
                    std::max({s.sy[0], s.sy[1], s.sy[2]})));
                if (s.x0 > s.x1 || s.y0 > s.y1) goto next;
                s.ax = s.sx[1] - s.sx[0];
                s.ay = s.sy[1] - s.sy[0];
                s.bx = s.sx[2] - s.sx[0];
                s.by = s.sy[2] - s.sy[0];
                float det = s.ax * s.by - s.ay * s.bx;
                if (std::fabs(det) < 1e-12f) goto next;
                s.inv_det = 1.0f / det;
                s.ok = true;
            }
        next:;
        }
    });

    parallel_ranges((long)height, [&](long band_lo, long band_hi) {
        for (long t = 0; t < n_tris; ++t) {
            const TriScreen& s = scr[t];
            if (!s.ok) continue;
            int y0 = std::max(s.y0, (int)band_lo);
            int y1 = std::min(s.y1, (int)band_hi - 1);
            if (y0 > y1) continue;
            float cr = colors[3 * t], cg = colors[3 * t + 1],
                  cb = colors[3 * t + 2];
            for (int py = y0; py <= y1; ++py) {
                for (int px = s.x0; px <= s.x1; ++px) {
                    float qx = px + 0.5f - s.sx[0];
                    float qy = py + 0.5f - s.sy[0];
                    float u = (qx * s.by - qy * s.bx) * s.inv_det;
                    float w = (s.ax * qy - s.ay * qx) * s.inv_det;
                    if (u < 0.f || w < 0.f || u + w > 1.f) continue;
                    float d = s.sd[0] + u * (s.sd[1] - s.sd[0])
                              + w * (s.sd[2] - s.sd[0]);
                    put(depth, rgb, width, px, py, d, cr, cg, cb);
                }
            }
        }
    }, /*min_n=*/2);
}

// Point sprites: circles of radius min(base/depth, max)/2 pixels, matching
// the reference's gl_PointSize = min(base / scr_pos.z, max).
void rasterize_points(const float* pos, const uint8_t* active, long n_pts,
                      const float* mvp, float base_size, float max_size,
                      float cr, float cg, float cb,
                      int width, int height,
                      float* depth, uint8_t* rgb) {
    if (n_threads() <= 1) {
        for (long i = 0; i < n_pts; ++i) {
            if (!active[i]) continue;
            Vec4 c = mvp_mul(mvp, pos[3 * i], pos[3 * i + 1],
                             pos[3 * i + 2]);
            if (c.w <= 1e-6f) continue;
            float inv = 1.0f / c.w;
            float sx = (c.x * inv * 0.5f + 0.5f) * width;
            float sy = (c.y * inv * 0.5f + 0.5f) * height;
            float size = std::min(base_size / c.w, max_size);
            float rad = std::max(0.75f, size * 0.5f);
            int x0 = std::max(0, (int)std::floor(sx - rad));
            int x1 = std::min(width - 1, (int)std::ceil(sx + rad));
            int y0 = std::max(0, (int)std::floor(sy - rad));
            int y1 = std::min(height - 1, (int)std::ceil(sy + rad));
            float r2 = rad * rad;
            for (int py = y0; py <= y1; ++py) {
                for (int px = x0; px <= x1; ++px) {
                    float dx = px + 0.5f - sx, dy = py + 0.5f - sy;
                    if (dx * dx + dy * dy > r2) continue;
                    put(depth, rgb, width, px, py, c.w, cr, cg, cb);
                }
            }
        }
        return;
    }
    std::vector<PtScreen> scr(n_pts);

    parallel_ranges(n_pts, [&](long lo, long hi) {
        for (long i = lo; i < hi; ++i) {
            PtScreen& s = scr[i];
            s.ok = false;
            if (!active[i]) continue;
            Vec4 c = mvp_mul(mvp, pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]);
            if (c.w <= 1e-6f) continue;
            float inv = 1.0f / c.w;
            s.sx = (c.x * inv * 0.5f + 0.5f) * width;
            s.sy = (c.y * inv * 0.5f + 0.5f) * height;
            s.w = c.w;
            float size = std::min(base_size / c.w, max_size);
            // >= sqrt(0.5): the nearest pixel center is always covered
            s.rad = std::max(0.75f, size * 0.5f);
            s.x0 = std::max(0, (int)std::floor(s.sx - s.rad));
            s.x1 = std::min(width - 1, (int)std::ceil(s.sx + s.rad));
            s.y0 = std::max(0, (int)std::floor(s.sy - s.rad));
            s.y1 = std::min(height - 1, (int)std::ceil(s.sy + s.rad));
            if (s.x0 > s.x1 || s.y0 > s.y1) continue;
            s.ok = true;
        }
    });

    parallel_ranges((long)height, [&](long band_lo, long band_hi) {
        for (long i = 0; i < n_pts; ++i) {
            const PtScreen& s = scr[i];
            if (!s.ok) continue;
            int y0 = std::max(s.y0, (int)band_lo);
            int y1 = std::min(s.y1, (int)band_hi - 1);
            if (y0 > y1) continue;
            float r2 = s.rad * s.rad;
            for (int py = y0; py <= y1; ++py) {
                for (int px = s.x0; px <= s.x1; ++px) {
                    float dx = px + 0.5f - s.sx, dy = py + 0.5f - s.sy;
                    if (dx * dx + dy * dy > r2) continue;
                    put(depth, rgb, width, px, py, s.w, cr, cg, cb);
                }
            }
        }
    }, /*min_n=*/2);
}

// Fill helpers so callers need not ship numpy loops.
void clear_buffers(float* depth, uint8_t* rgb, long n_px,
                   uint8_t bg_r, uint8_t bg_g, uint8_t bg_b) {
    for (long i = 0; i < n_px; ++i) {
        depth[i] = 3.0e38f;
        rgb[3 * i] = bg_r;
        rgb[3 * i + 1] = bg_g;
        rgb[3 * i + 2] = bg_b;
    }
}

}  // extern "C"
