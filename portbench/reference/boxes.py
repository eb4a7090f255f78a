"""Box geometry of the plain reference, written from det3d's definitions
(box_np_ops.py, box_torch_ops.py, odious.py of Vegeta2020/SE-SSD):

- boxes are [x, y, z, w, l, h, ry] lidar boxes, z at the gravity center;
- SECOND's anchor-offset code: centers over the anchor's BEV diagonal (z
  over its height), log size ratios, the angle's difference;
- BEV corners: the unit square's corners (-.5, -.5), (-.5, .5), (.5, .5),
  (.5, -.5) scaled by (w, l), then p @ [[c, -s], [s, c]] plus the center;
- the rotated BEV intersection as a polygon: the corners of each box that
  lie in the other and the crossings of their edges, ordered by angle
  about their mean, summed by the shoelace formula. The area is a
  differentiable function of the corners wherever the vertex set is
  stable, so autograd gives its gradient.

Everything is float32 PyTorch and broadcasts over leading dims.
"""
from __future__ import annotations

import numpy as np
import torch

_UNIT = ((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5))


def decode(enc: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """[..., 7] codes against [..., 7] anchors -> boxes."""
    diag = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
    xy = enc[..., :2] * diag[..., None] + anchors[..., :2]
    z = enc[..., 2:3] * anchors[..., 5:6] + anchors[..., 2:3]
    size = torch.exp(enc[..., 3:6]) * anchors[..., 3:6]
    return torch.cat([xy, z, size, enc[..., 6:7] + anchors[..., 6:7]], -1)


def sin_pair(a: torch.Tensor, b: torch.Tensor):
    """The pair with angles replaced by sin(ra) cos(rb) and cos(ra) sin(rb),
    so that their difference is sin(ra - rb)."""
    ra, rb = a[..., 6:7], b[..., 6:7]
    return (torch.cat([a[..., :6], torch.sin(ra) * torch.cos(rb)], -1),
            torch.cat([b[..., :6], torch.cos(ra) * torch.sin(rb)], -1))


def corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] -> [..., 4, 2] BEV corners in det3d's order."""
    unit = torch.tensor(_UNIT, dtype=boxes.dtype, device=boxes.device)
    local = unit * boxes[..., None, 3:5]
    c = torch.cos(boxes[..., 6])[..., None]
    s = torch.sin(boxes[..., 6])[..., None]
    x = local[..., 0] * c + local[..., 1] * s
    y = local[..., 1] * c - local[..., 0] * s
    return torch.stack([x, y], -1) + boxes[..., None, :2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _inside(p: torch.Tensor, poly: torch.Tensor, tol: float) -> torch.Tensor:
    """[..., P, 2] points in the convex counter-clockwise [..., 4, 2]
    polygon (its boundary within ``tol`` included) -> [..., P]."""
    e = torch.roll(poly, -1, -2) - poly                  # [..., 4, 2]
    rel = p[..., :, None, :] - poly[..., None, :, :]     # [..., P, 4, 2]
    return (_cross(e[..., None, :, :], rel) >= -tol).all(-1)


def bev_overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection area of the BEV rectangles of [..., 7] boxes."""
    a, b = torch.broadcast_tensors(a, b)
    # det3d's corners run clockwise: reversed, counter-clockwise
    pa = corners(a).flip(-2)
    pb = corners(b).flip(-2)
    # a point within a millionth of a box's size of its boundary is on it
    def tol(box):
        size = box[..., 3:5].amax(-1).detach()
        return (1e-6 * size * size)[..., None, None]

    in_a = _inside(pa, pb, tol(b))
    in_b = _inside(pb, pa, tol(a))
    # crossings of edge i of a with edge j of b: a_i + t da_i = b_j + u db_j
    da = torch.roll(pa, -1, -2) - pa
    db = torch.roll(pb, -1, -2) - pb
    ai, dai = pa[..., :, None, :], da[..., :, None, :]   # [..., 4, 1, 2]
    bj, dbj = pb[..., None, :, :], db[..., None, :, :]   # [..., 1, 4, 2]
    den = _cross(dai, dbj)
    par = den.abs() < 1e-12
    safe = torch.where(par, torch.ones_like(den), den)
    t = _cross(bj - ai, dbj) / safe
    u = _cross(bj - ai, dai) / safe
    hit = ~par & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    xs = (ai + t[..., None] * dai).flatten(-3, -2)        # [..., 16, 2]
    verts = torch.cat([pa, pb, xs], -2)                  # [..., 24, 2]
    ok = torch.cat([in_a, in_b, hit.flatten(-2)], -1)    # [..., 24]
    n = ok.sum(-1)
    w = ok.to(verts.dtype)
    mean = ((verts * w[..., None]).sum(-2)
            / n.clamp_min(1)[..., None].to(verts.dtype)).detach()
    rel = (verts - mean[..., None, :]).detach()
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    ang = torch.where(ok, ang, torch.full_like(ang, 10.0))
    order = ang.argsort(-1)
    v = verts.gather(-2, order[..., None].expand_as(verts))
    oks = ok.gather(-1, order)
    # slots past the last vertex repeat the first: their edges are empty
    v = torch.where(oks[..., None], v, v[..., :1, :])
    area = 0.5 * _cross(v, torch.roll(v, -1, -2)).sum(-1)
    return torch.where(n >= 3, area, torch.zeros_like(area)).clamp_min(0.0)


def height_overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    top = torch.minimum(a[..., 2] + a[..., 5] / 2, b[..., 2] + b[..., 5] / 2)
    bot = torch.maximum(a[..., 2] - a[..., 5] / 2, b[..., 2] - b[..., 5] / 2)
    return (top - bot).clamp_min(0.0)


def iou_bev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    inter = bev_overlap(a, b)
    union = a[..., 3] * a[..., 4] + b[..., 3] * b[..., 4] - inter
    return inter / union.clamp_min(1e-7)


def iou_3d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    inter = bev_overlap(a, b) * height_overlap(a, b)
    union = (a[..., 3] * a[..., 4] * a[..., 5]
             + b[..., 3] * b[..., 4] * b[..., 5] - inter)
    return inter / union.clamp_min(1e-7)


def iou_bev_matrix(a: torch.Tensor, b: torch.Tensor,
                   rows: int = 128) -> torch.Tensor:
    """[N, 7] x [M, 7] -> [N, M] BEV IoU, ``rows`` rows at a time."""
    return torch.cat([iou_bev(a[i:i + rows, None], b[None])
                      for i in range(0, len(a), rows)] or
                     [a.new_zeros(0, len(b))])


def _hull_edges(pts: np.ndarray) -> list:
    """(i, j) of each counter-clockwise edge of the convex hull of [P, 2]
    points (Andrew's monotone chain; collinear points dropped)."""
    idx = sorted(range(len(pts)), key=lambda k: (pts[k, 0], pts[k, 1]))

    def turn(o, a, b):
        return ((pts[a, 0] - pts[o, 0]) * (pts[b, 1] - pts[o, 1])
                - (pts[a, 1] - pts[o, 1]) * (pts[b, 0] - pts[o, 0]))

    def chain(seq):
        out = []
        for k in seq:
            while len(out) >= 2 and turn(out[-2], out[-1], k) <= 0:
                out.pop()
            out.append(k)
        return out

    lower, upper = chain(idx), chain(idx[::-1])
    ring = lower[:-1] + upper[:-1]
    return [(ring[k], ring[(k + 1) % len(ring)]) for k in range(len(ring))
            if len(ring) > 1]


def mbr_diag(points: torch.Tensor) -> torch.Tensor:
    """det3d's bounding-rectangle diagonal of [N, P, 2] points
    (odious.py:597-648): one candidate per convex-hull edge, its direction
    folded to |fmod(angle, pi / 2)|; of the rectangles aligned to the
    candidates the one of least area, and its diagonal."""
    host = points.detach().cpu().double().numpy()
    edges = [_hull_edges(p) for p in host]
    width = max([len(e) for e in edges] + [1])
    ii = np.zeros((len(edges), width), np.int64)
    jj = np.zeros((len(edges), width), np.int64)
    mask = np.zeros((len(edges), width), bool)
    for r, e in enumerate(edges):
        for k, (i, j) in enumerate(e):
            ii[r, k], jj[r, k], mask[r, k] = i, j, True
    dev = points.device
    ii, jj = torch.from_numpy(ii).to(dev), torch.from_numpy(jj).to(dev)
    mask = torch.from_numpy(mask).to(dev)

    def at(idx):
        return points.gather(-2, idx[..., None].expand(*idx.shape, 2))

    e = at(jj) - at(ii)                                   # [N, C, 2]
    ex = torch.where(mask, e[..., 0], torch.ones_like(e[..., 0]))
    ey = torch.where(mask, e[..., 1], torch.zeros_like(e[..., 1]))
    ang = torch.abs(torch.fmod(torch.atan2(ey, ex), np.pi / 2))
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    px, py = points[:, None, :, 0], points[:, None, :, 1]  # [N, 1, P]
    u = px * c + py * s
    v = py * c - px * s
    w = u.amax(-1) - u.amin(-1)
    h = v.amax(-1) - v.amin(-1)
    area = torch.where(mask, w * h, torch.full_like(w, float("inf")))
    best = area.argmin(-1, keepdim=True)
    return torch.sqrt(w.gather(-1, best) ** 2
                      + h.gather(-1, best) ** 2)[..., 0]


def odiou(g: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """SE-SSD's orientation-aware distance-IoU of aligned [N, 7] pairs
    (odious.py:845-900): 1 - IoU3d + |c_g - c_q|^2 / diag^2 + 1.25 (1 -
    |cos(r_q - r_g)|), diag^2 = the bounding rectangle's diagonal of the
    eight BEV corners squared plus the height overlap squared plus 1e-7;
    boxes clipped to +-200 first, IoU3d to [0, 1]; 0 for a pair with a
    size that is not positive."""
    ok = (g[..., 3:6] > 0).all(-1) & (q[..., 3:6] > 0).all(-1)
    g, q = g.clamp(-200.0, 200.0), q.clamp(-200.0, 200.0)
    hov = height_overlap(g, q)
    inter = bev_overlap(g, q) * hov
    union = (g[..., 3] * g[..., 4] * g[..., 5]
             + q[..., 3] * q[..., 4] * q[..., 5] - inter)
    iou = (inter / union.clamp_min(1e-7)).clamp(0.0, 1.0)
    dist2 = ((g[..., :3] - q[..., :3]) ** 2).sum(-1)
    pts = torch.cat([corners(g), corners(q)], -2)
    if len(pts):
        diag2 = mbr_diag(pts) ** 2 + hov ** 2 + 1e-7
    else:
        diag2 = hov + 1.0
    od = (1.0 - iou + dist2 / diag2
          + 1.25 * (1.0 - torch.abs(torch.cos(q[..., 6] - g[..., 6]))))
    return torch.where(ok, od, torch.zeros_like(od))
