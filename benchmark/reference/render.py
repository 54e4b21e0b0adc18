"""A plain PyTorch Gaussian splatting renderer: the published 3D Gaussian
Splatting rasterizer's rules (Kerbl et al. 2023, ``diff-gaussian-rasterization``),
written for clarity and checked by nothing but its own arithmetic.

- Projection: view z at or below 0.2 is culled; the 2D covariance is
  J W Sigma W^T J^T with the camera-space point clamped to 1.3 x the field
  of view, plus 0.3 on the diagonal; the radius is ceil(3 sqrt(lambda_max))
  with lambda_max = mid + sqrt(max(mid^2 - det, 0.1)); the pixel centre
  goes through the OpenGL projection (near 0.01, far 100) and
  ((ndc + 1) size - 1) / 2.
- Binning: 16 x 16 pixel tiles; a Gaussian touches the tiles of its
  radius's rectangle, cut to its top-left ``max_span`` x ``max_span``
  tiles; a tile blends its Gaussians front to back by view z (ties by id).
- Blending, per pixel at integer coordinates: power = -(a dx^2 + c dy^2) / 2
  - b dx dy; power > 0 is skipped; alpha = min(0.99, opacity exp(power));
  alpha < 1/255 is skipped; the entry that would take the transmittance
  below 1e-4 stops the pixel and is not drawn. The 0.99 clamp passes the
  gradient through, as the published backward does.

Tiles are blended in chunks of similar entry count, so that memory stays
bounded at any image size. ``render`` gives the image without a graph;
``backward`` replays each chunk with a graph and pushes the image's
gradient through it, which gives the gradient of any quantity the
Gaussians' fields were computed from. ``value_dtype`` computes alphas,
weights and colours in another float type (the lower-precision control);
positions and conics stay in float32.
"""

from __future__ import annotations

import dataclasses

import torch

TILE = 16
ALPHA_MAX, ALPHA_MIN, T_MIN = 0.99, 1.0 / 255.0, 1e-4
NEAR_Z, DILATION, FOV_CLAMP = 0.2, 0.3, 1.3
CHUNK_PAIRS = 1 << 25  # (pixel, entry) pairs per chunk


@dataclasses.dataclass
class Camera:
    w2c: torch.Tensor  # (4, 4)
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def rig_camera(rig, v: int, device) -> Camera:
    return Camera(torch.as_tensor(rig.w2c[v], device=device), float(rig.fx[v]), float(rig.fy[v]),
                  float(rig.cx[v]), float(rig.cy[v]), rig.width, rig.height)


def quat_rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) quaternions (w, x, y, z), normalised here -> (N, 3, 3)."""
    w, x, y, z = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def project(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor, cam: Camera):
    """-> (xy (N, 2), depth (N,), conic (N, 3) as (a, b, c), radius (N,), visible (N,))."""
    w2c = cam.w2c
    pc = means @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[:, 2]
    visible = z > NEAR_Z
    zs = torch.where(visible, z, torch.ones_like(z))
    w, h, n, f = cam.width, cam.height, 0.01, 100.0
    proj = torch.tensor([
        [2 * cam.fx / w, 0.0, -(w - 2 * cam.cx) / w, 0.0],
        [0.0, 2 * cam.fy / h, -(h - 2 * cam.cy) / h, 0.0],
        [0.0, 0.0, f / (f - n), -(f * n) / (f - n)],
        [0.0, 0.0, 1.0, 0.0],
    ], dtype=torch.float32, device=means.device) @ w2c
    hom = means @ proj[:, :3].T + proj[:, 3]
    inv_w = 1.0 / (hom[:, 3] + 1e-7)
    xy = torch.stack([((hom[:, 0] * inv_w + 1.0) * w - 1.0) * 0.5, ((hom[:, 1] * inv_w + 1.0) * h - 1.0) * 0.5], -1)

    lim_x, lim_y = FOV_CLAMP * w / (2 * cam.fx), FOV_CLAMP * h / (2 * cam.fy)
    tx = torch.clamp(pc[:, 0] / zs, -lim_x, lim_x) * zs
    ty = torch.clamp(pc[:, 1] / zs, -lim_y, lim_y) * zs
    zero = torch.zeros_like(zs)
    jac = torch.stack([
        torch.stack([cam.fx / zs, zero, -cam.fx * tx / (zs * zs)], -1),
        torch.stack([zero, cam.fy / zs, -cam.fy * ty / (zs * zs)], -1),
    ], -2)  # (N, 2, 3)
    m = quat_rotation(quats) * scales[:, None, :]
    sigma = m @ m.transpose(1, 2)
    t = jac @ w2c[:3, :3]
    cov = t @ sigma @ t.transpose(1, 2)
    ca, cb, cc = cov[:, 0, 0] + DILATION, cov[:, 0, 1], cov[:, 1, 1] + DILATION
    det = ca * cc - cb * cb
    visible = visible & (det != 0)
    inv = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
    conic = torch.stack([cc * inv, -cb * inv, ca * inv], -1)
    mid = 0.5 * (ca + cc)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1)))).detach()
    on = (xy[:, 0] + radius >= 0) & (xy[:, 0] - radius < w) & (xy[:, 1] + radius >= 0) & (xy[:, 1] - radius < h)
    visible = (visible & on).detach()
    return xy, z, conic, torch.where(visible, radius, torch.zeros_like(radius)), visible


@dataclasses.dataclass
class Bins:
    gid: torch.Tensor  # (E,) Gaussian of each entry, tile-major and front to back
    tile: torch.Tensor  # (E,) its tile
    start: torch.Tensor  # (T,) each tile's first entry
    count: torch.Tensor  # (T,) its number of entries
    tiles_x: int
    tiles_y: int


@torch.no_grad()
def bin_tiles(xy, depth, radius, visible, width: int, height: int, max_span: int) -> Bins:
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    n = xy.shape[0]
    r = radius.to(torch.float32)
    x0 = torch.clamp(torch.floor((xy[:, 0] - r) / TILE), 0, tiles_x).long()
    y0 = torch.clamp(torch.floor((xy[:, 1] - r) / TILE), 0, tiles_y).long()
    x1 = torch.clamp(torch.floor((xy[:, 0] + r + TILE - 1) / TILE), 0, tiles_x).long()
    y1 = torch.clamp(torch.floor((xy[:, 1] + r + TILE - 1) / TILE), 0, tiles_y).long()
    k = torch.arange(max_span * max_span, device=xy.device)
    di, dj = k // max_span, k % max_span
    ok = visible[:, None] & (di[None] < (y1 - y0)[:, None]) & (dj[None] < (x1 - x0)[:, None])
    tile = ((y0[:, None] + di[None]) * tiles_x + x0[:, None] + dj[None])[ok]
    gid = torch.arange(n, device=xy.device)[:, None].expand_as(ok)[ok]
    rank = torch.empty(n, dtype=torch.long, device=xy.device)
    rank[torch.argsort(torch.where(visible, depth.detach(), torch.full_like(depth, float("inf"))), stable=True)] = (
        torch.arange(n, device=xy.device))
    order = torch.argsort(tile * n + rank[gid])
    tile, gid = tile[order], gid[order]
    t = tiles_x * tiles_y
    count = torch.bincount(tile, minlength=t)
    start = torch.cumsum(count, 0) - count
    return Bins(gid=gid, tile=tile, start=start, count=count, tiles_x=tiles_x, tiles_y=tiles_y)


def chunks(bins: Bins):
    """The occupied tiles, fullest first, in groups of at most
    ``CHUNK_PAIRS`` padded pairs -> [(tile ids, padded count)]."""
    occupied = torch.nonzero(bins.count > 0).flatten()
    counts = bins.count[occupied]
    order = torch.argsort(counts, descending=True, stable=True)
    occupied, counts = occupied[order], counts[order].tolist()
    out, i = [], 0
    while i < len(counts):
        m = counts[i]
        rows = max(1, CHUNK_PAIRS // (TILE * TILE * m))
        out.append((occupied[i:i + rows], m))
        i += rows
    return out


def tile_alpha(bins: Bins, tiles: torch.Tensor, m: int, xy, conic, opacity, value_dtype=torch.float32):
    """Alphas of the (tile, pixel, entry) pairs of ``tiles``, each padded to
    ``m`` entries, with the skip rules -> (alpha (R, 256, m), gid (R, m), valid (R, m))."""
    dev = xy.device
    j = torch.arange(m, device=dev)
    valid = j[None] < bins.count[tiles][:, None]
    e = torch.where(valid, bins.start[tiles][:, None] + j[None], torch.zeros_like(j[None]))
    g = bins.gid[e]
    p = torch.arange(TILE * TILE, device=dev)
    px = ((tiles % bins.tiles_x) * TILE)[:, None].float() + (p % TILE).float()[None]  # (R, 256)
    py = ((tiles // bins.tiles_x) * TILE)[:, None].float() + (p // TILE).float()[None]
    dx = xy[g, 0][:, None, :] - px[:, :, None]
    dy = xy[g, 1][:, None, :] - py[:, :, None]
    a, b, c = (conic[g, i][:, None, :] for i in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    raw = (opacity[g][:, None, :] * torch.exp(power)).to(value_dtype)
    alpha = raw + (torch.clamp(raw, max=ALPHA_MAX) - raw).detach()
    keep = (power <= 0) & (alpha >= ALPHA_MIN) & valid[:, None, :]
    return torch.where(keep, alpha, torch.zeros_like(alpha)), g, valid


def blend_chunk(bins: Bins, tiles, m, xy, conic, opacity, colors, value_dtype=torch.float32):
    """Front-to-back blend of ``tiles`` -> rgb (R, 256, 3) in ``value_dtype``."""
    alpha, g, _ = tile_alpha(bins, tiles, m, xy, conic, opacity, value_dtype)
    t_after = torch.cumprod(1.0 - alpha, dim=-1)
    t_before = torch.cat([torch.ones_like(t_after[..., :1]), t_after[..., :-1]], -1)
    weight = alpha * t_before * (t_after >= T_MIN).to(alpha.dtype)
    return torch.einsum("rpm,rmc->rpc", weight, colors[g].to(value_dtype))


def _place(image, bins: Bins, tiles, rgb):
    """Write tile rows ``rgb`` (R, 256, 3) into the padded image (3, ty*16, tx*16)."""
    r = tiles.shape[0]
    ty, tx = tiles // bins.tiles_x, tiles % bins.tiles_x
    view = image.view(3, bins.tiles_y, TILE, bins.tiles_x, TILE)
    view[:, ty, :, tx, :] = rgb.reshape(r, TILE, TILE, 3).permute(0, 3, 1, 2).to(image.dtype)


@torch.no_grad()
def render(bins: Bins, xy, conic, opacity, colors, width: int, height: int, value_dtype=torch.float32):
    """The image (3, H, W) on a black background."""
    image = torch.zeros((3, bins.tiles_y * TILE, bins.tiles_x * TILE), dtype=value_dtype, device=xy.device)
    for tiles, m in chunks(bins):
        _place(image, bins, tiles, blend_chunk(bins, tiles, m, xy, conic, opacity, colors, value_dtype))
    return image[:, :height, :width]


def backward(bins: Bins, grad_image, xy, conic, opacity, colors, value_dtype=torch.float32):
    """Push d(loss)/d(image) (3, H, W) through every chunk's blend into the
    ``.grad`` of whichever of ``conic``, ``opacity``, ``colors`` require it."""
    h, w = grad_image.shape[1:]
    padded = torch.zeros((3, bins.tiles_y * TILE, bins.tiles_x * TILE), dtype=grad_image.dtype,
                         device=grad_image.device)
    padded[:, :h, :w] = grad_image
    view = padded.view(3, bins.tiles_y, TILE, bins.tiles_x, TILE)
    for tiles, m in chunks(bins):
        g = view[:, tiles // bins.tiles_x, :, tiles % bins.tiles_x, :]  # (R, 3, 16, 16)
        g = g.permute(0, 2, 3, 1).reshape(tiles.shape[0], TILE * TILE, 3)
        rgb = blend_chunk(bins, tiles, m, xy, conic, opacity, colors, value_dtype)
        rgb.backward(g.to(rgb.dtype))
