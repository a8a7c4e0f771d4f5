"""Headless offscreen renderer — the framework's counterpart of the
reference's VTK widget (/root/reference/ui/vtk_widget.py).

The reference embeds a VTK window in Qt: point cloud as point-size-1
vertex glyphs with a ~500k random display subsample (:114-118), towers
as line actors built from point-pair edge arrays (:176-227) or box
dicts (:229-284), and a camera auto-fitted along the scene bounds
diagonal (:286-322).  A device pipeline is headless, so this module
renders the same scene to a PNG instead: a numpy z-buffer point
splatter + line rasterizer behind the exact same scene inputs
(points + tower_display_geometries linesets).  No GUI toolkit, no GL.
"""

from __future__ import annotations

import numpy as np

from pointcloudhookup_tpu.viz.boxes import subsample_indices

# Matches the reference's VTK display cap (ui/vtk_widget.py:115-118).
DISPLAY_CAP = 500_000


class Camera:
    """Perspective camera auto-fitted along the bounds diagonal.

    Mirrors VTKPointCloudWidget's camera fit (ui/vtk_widget.py:286-322):
    focal point = bounds center, position = center + diagonal-scaled
    offset along a fixed view direction, view-up = +z.
    """

    def __init__(self, position, focal, up=(0.0, 0.0, 1.0), fov_deg=30.0):
        self.position = np.asarray(position, np.float64)
        self.focal = np.asarray(focal, np.float64)
        self.up = np.asarray(up, np.float64)
        self.fov_deg = float(fov_deg)

    @classmethod
    def fit_bounds(cls, mins, maxs, *, azimuth_deg=-60.0, elevation_deg=25.0,
                   distance_scale=1.8, fov_deg=30.0):
        mins = np.asarray(mins, np.float64)
        maxs = np.asarray(maxs, np.float64)
        center = (mins + maxs) / 2.0
        diag = float(np.linalg.norm(maxs - mins))
        diag = diag if diag > 0 else 1.0
        az = np.radians(azimuth_deg)
        el = np.radians(elevation_deg)
        direction = np.array(
            [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
        )
        pos = center + direction * diag * distance_scale
        return cls(pos, center, fov_deg=fov_deg)

    def basis(self):
        fwd = self.focal - self.position
        fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
        right = np.cross(fwd, self.up)
        nr = np.linalg.norm(right)
        if nr < 1e-9:  # looking straight along up: pick any right
            right = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
            nr = np.linalg.norm(right)
        right = right / nr
        true_up = np.cross(right, fwd)
        return right, true_up, fwd


def _project(pts, camera: Camera, width: int, height: int):
    """World points -> (ix, iy, depth, in_front) pixel coords."""
    right, up, fwd = camera.basis()
    rel = pts.astype(np.float64) - camera.position
    x = rel @ right
    y = rel @ up
    z = rel @ fwd  # camera-space depth
    in_front = z > 1e-6
    zs = np.where(in_front, z, 1.0)
    f = (height / 2.0) / np.tan(np.radians(camera.fov_deg) / 2.0)
    ix = np.round(width / 2.0 + f * x / zs).astype(np.int64)
    iy = np.round(height / 2.0 - f * y / zs).astype(np.int64)
    return ix, iy, z, in_front


def height_colormap(z: np.ndarray) -> np.ndarray:
    """Blue->cyan->green->yellow->red by normalized height, u8[N,3]."""
    z = np.asarray(z, np.float64)
    lo, hi = np.nanmin(z), np.nanmax(z)
    t = (z - lo) / max(hi - lo, 1e-9)
    # piecewise-linear jet-like ramp without matplotlib
    r = np.clip(np.minimum(4 * t - 2, 1.0), 0.0, 1.0)
    g = np.clip(np.minimum(4 * t, 4 - 4 * t), 0.0, 1.0)
    b = np.clip(np.minimum(2 - 4 * t, 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], axis=1) * 255).astype(np.uint8)


def render_scene(
    points: np.ndarray,
    geometries=(),
    *,
    width: int = 1280,
    height: int = 960,
    camera: Camera | None = None,
    point_colors: np.ndarray | None = None,
    background=(12, 12, 20),
    display_cap: int = DISPLAY_CAP,
    seed: int = 0,
) -> np.ndarray:
    """Rasterize points + wireframe geometries to u8[H, W, 3].

    points: [N,3] float; geometries: iterable of dicts as produced by
    viz.boxes.tower_display_geometries — each with a "lines" array of
    point PAIRS [(2E), 3] (the reference widget's wire format,
    ui/vtk_widget.py:176-227) and optional "color" (r,g,b floats 0-1).
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    # subsample via indices so caller-supplied per-point colors stay
    # aligned with the displayed subset
    sub = subsample_indices(len(pts), display_cap, seed)
    pts = pts[sub]
    # normalize geometry inputs: accept the (lines, color) tuples that
    # tower_display_geometries emits, or {"lines": ..., "color": ...}
    geometries = [
        g if isinstance(g, dict) else {"lines": g[0], "color": g[1]}
        for g in geometries
    ]
    if point_colors is None and len(pts):
        point_colors = height_colormap(pts[:, 2])
    elif point_colors is not None:
        point_colors = np.asarray(point_colors, np.uint8).reshape(-1, 3)[sub]

    # scene bounds over points AND geometry, like the widget's auto-fit
    all_min = pts.min(axis=0) if len(pts) else np.zeros(3)
    all_max = pts.max(axis=0) if len(pts) else np.ones(3)
    for g in geometries:
        ln = np.asarray(g["lines"], np.float64).reshape(-1, 3)
        if len(ln):
            all_min = np.minimum(all_min, ln.min(axis=0))
            all_max = np.maximum(all_max, ln.max(axis=0))
    if camera is None:
        camera = Camera.fit_bounds(all_min, all_max)

    img = np.empty((height, width, 3), np.uint8)
    img[:] = np.asarray(background, np.uint8)
    zbuf = np.full((height, width), np.inf, np.float64)

    if len(pts):
        ix, iy, z, ok = _project(pts, camera, width, height)
        ok &= (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        ix, iy, z = ix[ok], iy[ok], z[ok]
        col = point_colors[ok]
        # z-buffer resolve: sort far->near, later (nearer) writes win
        order = np.argsort(-z, kind="stable")
        ix, iy, z, col = ix[order], iy[order], z[order], col[order]
        img[iy, ix] = col
        flat = iy * width + ix
        np.minimum.at(zbuf.reshape(-1), flat, z)

    # wireframes: sample each edge densely (~1 sample/pixel), draw with
    # a small depth bias so boxes stay visible over their own points
    for g in geometries:
        lines = np.asarray(g["lines"], np.float64).reshape(-1, 2, 3)
        color = np.asarray(g.get("color", (1.0, 0.2, 0.2)), np.float64)
        cu8 = (np.clip(color, 0, 1) * 255).astype(np.uint8)
        for a, b in lines:
            pa = _project(a[None], camera, width, height)
            pb = _project(b[None], camera, width, height)
            if not (pa[3][0] and pb[3][0]):
                continue
            npx = int(
                max(abs(pb[0][0] - pa[0][0]), abs(pb[1][0] - pa[1][0]), 1)
            )
            npx = min(npx + 1, 8192)
            t = np.linspace(0.0, 1.0, npx)[:, None]
            seg = a[None] * (1 - t) + b[None] * t
            ix, iy, z, ok = _project(seg, camera, width, height)
            ok &= (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
            ix, iy, z = ix[ok], iy[ok], z[ok]
            vis = z <= zbuf[iy, ix] * 1.02 + 1e-3  # depth bias
            img[iy[vis], ix[vis]] = cu8
    return img


def save_png(img: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(img, np.uint8), "RGB").save(path)


def render_to_png(
    points,
    geometries=(),
    path: str = "scene.png",
    **kwargs,
) -> str:
    """One-call equivalent of display_full_scene (ui/vtk_widget.py:41):
    points + tower geometries -> PNG file on disk."""
    save_png(render_scene(points, geometries, **kwargs), path)
    return path
