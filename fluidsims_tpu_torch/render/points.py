"""Terminal point-cloud renderer for the graph layouts (a NumPy copy of
fluidsims_tpu.render.points, for the port's `nbody --render`).

Behavioral spec: number_fluid2d.c — the 16-color palette (kPalette16
:163-180), the five color schemes (point_color :692-724: mint, index
bands, log buckets, radius bands, xy xor), auto-fit camera
(camera_fit :668-689: center the bbox, zoom 0.88*fit), later-drawn
points overwriting earlier ones (draw_points_fast_xy :727-767), the
pan/zoom camera of the live loop (:805-888), and the orange root
marker; for dims=3, the orbit camera + cached perspective projection of
number_fluid3d.c (orbit_to_camera/fit_orbit :723-761,
projector_project :768-798).  The raylib pixel loop becomes a
half-block ANSI truecolor raster: each character cell holds two
vertically stacked subpixels (fg = top, bg = bottom).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["PALETTE16", "SCHEMES", "color_index", "render_points",
           "Camera2D", "camera_fit", "OrbitCamera", "fit_orbit",
           "project_3d", "render_points_3d"]

# kPalette16 (number_fluid2d.c:163-180), alpha dropped
PALETTE16 = np.array([
    (123, 236, 178), (102, 216, 238), (167, 139, 250), (244, 114, 182),
    (248, 113, 113), (251, 146, 60), (250, 204, 21), (163, 230, 53),
    (74, 222, 128), (45, 212, 191), (34, 211, 238), (96, 165, 250),
    (129, 140, 248), (192, 132, 252), (244, 114, 182), (251, 191, 36),
], np.uint8)

_MINT = np.array((123, 236, 178), np.uint8)
_ROOT = np.array((236, 178, 123), np.uint8)

SCHEMES = ("mint", "index", "log", "radius", "xor")


def color_index(i, x, y, scheme: str, z=None):
    """Per-body palette index (point_color, number_fluid2d.c:692-724;
    3-D variants point_color_3d, number_fluid3d.c:806-831); 'mint'
    returns -1 (fixed color)."""
    i = np.asarray(i)
    if scheme == "mint":
        return np.full(i.shape, -1, np.int32)
    if scheme == "index":
        return (i & 15).astype(np.int32)
    if scheme == "log":
        return (np.floor(np.log2(np.maximum(i + 1, 1))).astype(np.int32)
                & 15)
    if scheme == "radius":
        d2 = x * x + y * y + (0 if z is None else z * z)
        return ((d2 * 0.00006).astype(np.uint32) & 15).astype(np.int32)
    if scheme == "xor":
        ax = np.abs(x * 0.035).astype(np.int32).astype(np.uint32)
        ay = np.abs(y * 0.035).astype(np.int32).astype(np.uint32)
        az = (np.zeros_like(ax) if z is None
              else np.abs(z * 0.035).astype(np.int32).astype(np.uint32))
        return ((ax ^ ay ^ az) & 15).astype(np.int32)
    raise ValueError(f"unknown color scheme {scheme!r}; one of {SCHEMES}")


@dataclass
class Camera2D:
    """Pan/zoom camera of the 2-D live view (number_fluid2d.c:805-888):
    world point (tx, ty) maps to the screen center; zoom in subpixels
    per world unit."""
    tx: float = 0.0
    ty: float = 0.0
    zoom: float = 1.0


def camera_fit(pos, W: int, H: int) -> Camera2D:
    """bbox center, zoom 0.88 * fit (camera_fit, number_fluid2d.c:668-689)."""
    pos = np.asarray(pos)[:, :2]
    lo = pos.min(0)
    hi = pos.max(0)
    bw = max(hi[0] - lo[0], 1e-6)
    bh = max(hi[1] - lo[1], 1e-6)
    zoom = 0.88 * min(W / bw, 2 * H / bh)
    return Camera2D(tx=0.5 * (lo[0] + hi[0]), ty=0.5 * (lo[1] + hi[1]),
                    zoom=zoom)


@dataclass
class OrbitCamera:
    """Orbit camera of the 3-D viewer (OrbitCamera + orbit_to_camera,
    number_fluid3d.c:716-737): position = target + distance *
    (cos p sin y, sin p, cos p cos y), up = +Y, perspective fov."""
    target: np.ndarray = field(default_factory=lambda: np.zeros(3))
    yaw: float = 0.6
    pitch: float = 0.35
    distance: float = 100.0
    fov_deg: float = 60.0


def fit_orbit(pos) -> OrbitCamera:
    """bbox-diagonal framing (fit_orbit, number_fluid3d.c:739-761)."""
    pos = np.asarray(pos)[:, :3]
    lo = pos.min(0)
    hi = pos.max(0)
    diag = max(float(np.linalg.norm(hi - lo)), 1.0)
    fov = np.deg2rad(60.0)
    return OrbitCamera(target=0.5 * (lo + hi), yaw=0.6, pitch=0.35,
                       distance=0.65 * diag / np.tan(0.5 * fov),
                       fov_deg=60.0)


def project_3d(pos, cam: OrbitCamera, W: int, H: int):
    """Perspective view-projection to subpixel coords, y-up
    (projector_make/projector_project, number_fluid3d.c:768-798).
    Returns (sx, sy, visible); a terminal half-block subpixel is treated
    as square (aspect = W / 2H)."""
    pos = np.asarray(pos, np.float64)[:, :3]
    cp, sp = np.cos(cam.pitch), np.sin(cam.pitch)
    cy, sy_ = np.cos(cam.yaw), np.sin(cam.yaw)
    eye = np.asarray(cam.target, np.float64) + cam.distance * np.array(
        [cp * sy_, sp, cp * cy])
    fwd = np.asarray(cam.target, np.float64) - eye
    fwd /= max(np.linalg.norm(fwd), 1e-12)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= max(np.linalg.norm(right), 1e-12)
    up2 = np.cross(right, fwd)

    rel = pos - eye
    xv = rel @ right
    yv = rel @ up2
    zv = rel @ fwd                      # looking down +fwd
    visible = zv > 1e-3                 # near-plane cull (:786)

    SH = 2 * H
    f = 1.0 / np.tan(0.5 * np.deg2rad(cam.fov_deg))
    aspect = W / max(SH, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ndcx = (f / aspect) * xv / zv
        ndcy = f * yv / zv
    sx = ((ndcx + 1.0) * 0.5 * W).astype(np.int64)
    sy = ((ndcy + 1.0) * 0.5 * SH).astype(np.int64)
    return sx, sy, visible


def _splat_offsets(zoom: float):
    """Zoom-LOD point sizing (draw_points_fast_xy, number_fluid2d.c:
    738-760): below 1.5 subpix/world-unit a point is one subpixel, below
    5.0 a 2x2 block, beyond that a disc of radius max(1, 0.35*zoom)
    subpixels — the terminal analog of the reference's pixel / 2x2 rect /
    world-radius circle tiers."""
    if zoom < 1.5:
        return ((0, 0),)
    if zoom < 5.0:
        return ((0, 0), (1, 0), (0, 1), (1, 1))
    r = min(8, max(1, int(round(0.35 * zoom))))
    return tuple((dx, dy) for dy in range(-r, r + 1)
                 for dx in range(-r, r + 1) if dx * dx + dy * dy <= r * r)


def _raster_frame(n, sx, sy, ok, x, y, z, W, H, scheme, color,
                  offsets=((0, 0),)):
    """Shared winner-takes-highest-index rasterizer + ANSI assembly."""
    SH = 2 * H
    winner = np.full(SH * W, -1, np.int64)
    for dx, dy in offsets:
        qx, qy = sx + dx, sy + dy
        okq = ok & (qx >= 0) & (qx < W) & (qy >= 0) & (qy < SH)
        flat = (qy * W + qx)[okq]
        np.maximum.at(winner, flat, np.arange(n)[okq])

    idx = winner.reshape(SH, W)
    occupied = idx >= 0
    wi = np.maximum(idx, 0)
    ci = color_index(wi, x[wi], y[wi], scheme,
                     z=None if z is None else z[wi])
    rgb = np.where(
        (ci < 0)[..., None], _MINT[None, None, :], PALETTE16[ci & 15])
    rgb = np.where((idx == 0)[..., None], _ROOT[None, None, :], rgb)

    if not color:
        chars = np.where(occupied[0::2] & occupied[1::2], "█",
                         np.where(occupied[0::2], "▀",
                                  np.where(occupied[1::2], "▄", " ")))
        return "\n".join("".join(r) for r in chars[::-1])

    lines = []
    for row in range(H - 1, -1, -1):  # y up -> screen down
        top = 2 * row + 1
        bot = 2 * row
        parts = []
        for cx in range(W):
            t_on, b_on = occupied[top, cx], occupied[bot, cx]
            if not t_on and not b_on:
                parts.append("\x1b[0m ")
                continue
            tr, tg, tb = rgb[top, cx]
            br, bg_, bb = rgb[bot, cx]
            if t_on and b_on:
                parts.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                             f"\x1b[48;2;{br};{bg_};{bb}m▀")
            elif t_on:
                parts.append(f"\x1b[0m\x1b[38;2;{tr};{tg};{tb}m▀")
            else:
                parts.append(f"\x1b[0m\x1b[38;2;{br};{bg_};{bb}m▄")
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


def render_points(pos, W: int, H: int, scheme: str = "mint",
                  color: bool = True, camera: Camera2D | None = None) -> str:
    """Rasterize a (n, 2+) point cloud to a W x H character frame with 2x
    vertical subpixel resolution.  `camera` pans/zooms (the live loop's
    raylib Camera2D analog, number_fluid2d.c:805-888); None auto-fits.
    Body 0 (the root) gets the reference's orange marker; among
    overlapping bodies the highest index wins (the reference draws in
    index order, later pixels overwriting)."""
    pos = np.asarray(pos)[:, :2]
    n = pos.shape[0]
    x, y = pos[:, 0].astype(np.float64), pos[:, 1].astype(np.float64)
    cam = camera or camera_fit(pos, W, H)
    SH = 2 * H
    sx = ((x - cam.tx) * cam.zoom + W * 0.5).astype(np.int64)
    sy = ((y - cam.ty) * cam.zoom + SH * 0.5).astype(np.int64)
    return _raster_frame(n, sx, sy, np.ones(n, bool), x, y, None,
                         W, H, scheme, color,
                         offsets=_splat_offsets(cam.zoom))


def render_points_3d(pos, W: int, H: int, scheme: str = "mint",
                     color: bool = True,
                     camera: OrbitCamera | None = None) -> str:
    """Rasterize a (n, 3) point cloud through the orbit camera's
    perspective projection (draw_points_3d, number_fluid3d.c:833-861)."""
    pos = np.asarray(pos)[:, :3]
    n = pos.shape[0]
    cam = camera or fit_orbit(pos)
    sx, sy, visible = project_3d(pos, cam, W, H)
    x, y, z = (pos[:, k].astype(np.float64) for k in range(3))
    return _raster_frame(n, sx, sy, visible, x, y, z, W, H, scheme, color)
