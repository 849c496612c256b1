"""Plain reference of the 6DGS pose stack below the backbone, in PyTorch.

Written from the 6DGS reference's equations (pose_estimation/sampling.py,
quadricell.py, identification_module.py, ray_preprocessor.py,
our_multihead_attention.py, camera_direction_network.py,
distance_based_loss.py, test.py, train.py) and frozen here, so that the
benchmark's verdict does not move when the program does. It imports nothing
of the program and takes none of its weights or tables: the benchmark hands
it the same raw inputs it hands the program (scene, images, weights in the
6DGS checkpoint layout, random draws) and it works everything out again.

Every matrix product goes through ``mm`` / ``linear`` / ``conv`` with a
dtype: float32 (TF32 off) for the reference, bfloat16 for the control that
shows the comparison can fail. Everything else stays float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -9e15
EPS = 1e-12
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def worse(a, b):
    """The larger of two readings, NaN if either is NaN."""
    return a if a != a or a > b else b


def mm(a, b, dt=torch.float32):
    return (a.to(dt) @ b.to(dt)).to(torch.float32)


def linear(x, p, dt=torch.float32):
    """x @ w + b with w [in, out] (the 6DGS checkpoint layout)."""
    return mm(x, p["w"], dt) + p["b"]


def conv(x, w, b, dt=torch.float32, **kw):
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv2d(x.to(dt), w.to(dt), b.to(dt), **kw).to(torch.float32)


# ------------------------------------------------------------- preprocessing


def _resize(x, size, mode):
    return F.interpolate(x[None], size=size, mode=mode, antialias=True,
                         align_corners=False)[0]


def _shorter_to(x, target, mode):
    h, w = x.shape[1], x.shape[2]
    size = (target, max(1, round(target * w / h))) if h < w else \
        (max(1, round(target * h / w)), target)
    return _resize(x, size, mode)


def _crop(x, size):
    top, left = (x.shape[1] - size) // 2, (x.shape[2] - size) // 2
    return x[:, top:top + size, left:left + size]


def preprocess(img, mask, grid):
    """[H, W, 3] image in [0, 1] and [H, W] mask -> normalised [3, 224, 224]
    and the [grid * grid] patch mask (backbone.py: shorter side 256, centre
    crop 224, ImageNet normalisation; mask resized the same, then to the
    patch grid, threshold 0.1)."""
    x = _crop(_shorter_to(img.permute(2, 0, 1), 256, "bicubic"), 224)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    m = _crop(_shorter_to(mask.to(torch.float32)[None], 256, "bilinear"), 224)
    m = _resize(m, (grid, grid), "bilinear")
    return (x - mean) / std, m[0].reshape(-1) > 0.1


def position_encoding(grid, device):
    """[grid * grid, 14]: raw yx on [-1, 1] and sin/cos at 3 octaves."""
    lin = torch.linspace(-1.0, 1.0, grid, device=device)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(-1, 2)
    pts = (pos[..., None] * 2.0 ** torch.arange(3.0, device=device)).reshape(-1, 6)
    return torch.cat([pos, torch.sin(pts), torch.cos(pts)], -1)


# ---------------------------------------------------------------------- rays


def quat_to_rotmat(q):
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), EPS)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def ellipse_perimeter(b, c):
    return math.pi * ((b + c) + 3 * (b - c) ** 2
                      / (10 * (b + c) + torch.sqrt(b * b + 14 * b * c + c * c)))


def ring_layout(a, b, c, target):
    p = 1.6075
    surface = 4 * math.pi * (((a * b) ** p + (a * c) ** p + (b * c) ** p) / 3.0) ** (1 / p)
    side = torch.sqrt(surface / float(target))
    rings = ((torch.floor(ellipse_perimeter(a, b) / (2 * side))
              + torch.floor(ellipse_perimeter(a, c) / (2 * side))) * 0.5).to(torch.int32)
    return rings, side


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def smallest_eigvec(A):
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3]
    matrices: Cardano's trigonometric eigenvalue, then the largest cross
    product of two rows of (A - lam I), with the fallbacks for rank <= 1."""
    eye = torch.eye(3, device=A.device)
    A = 0.5 * (A + A.transpose(-1, -2))
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, EPS * EPS))
    detB = torch.sum(B[..., 0, :] * _cross(B[..., 1, :], B[..., 2, :]), -1)
    phi = torch.arccos(torch.clamp(detB / (2.0 * p ** 3), -1.0, 1.0)) / 3.0
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    iso = p2 <= EPS * torch.clamp_min(q * q, 1.0)
    lam0 = torch.where(iso, q, lam0)
    M = A - lam0[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01, n02, n12 = (c01 * c01).sum(-1), (c02 * c02).sum(-1), (c12 * c12).sum(-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    nbest = torch.maximum(n01, torch.maximum(n02, n12))
    rn0, rn1, rn2 = (r0 * r0).sum(-1), (r1 * r1).sum(-1), (r2 * r2).sum(-1)
    big = torch.where(((rn0 >= rn1) & (rn0 >= rn2))[..., None], r0,
                      torch.where((rn1 >= rn2)[..., None], r1, r2))
    rn = torch.maximum(rn0, torch.maximum(rn1, rn2))
    ez, ex = torch.zeros_like(big), torch.zeros_like(big)
    ez[..., 2], ex[..., 0] = 1.0, 1.0
    row = torch.where((rn > EPS)[..., None],
                      big / torch.sqrt(torch.clamp_min(rn, EPS))[..., None], ez)
    helper = torch.where((torch.abs(row[..., 0]) > 0.9)[..., None], ez, ex)
    w = _cross(row, helper)
    fallback = w / torch.clamp_min(torch.linalg.norm(w, dim=-1, keepdim=True), EPS)
    v = torch.where((nbest > EPS)[..., None], best, fallback)
    v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), EPS)
    return torch.where(iso[..., None], ex, v)


def normals(points, valid, k, dt=torch.float32):
    """k-NN (the point itself included) PCA normals, flipped towards the
    majority of the neighbourhood offsets (sampling.py:28-113)."""
    pts = torch.where(valid[:, None], points, torch.full_like(points, 1e12))
    sq = (pts * pts).sum(-1)
    d = sq[:, None] + sq[None, :] - 2.0 * mm(pts, pts.T, dt)
    idx = torch.topk(-d, k, dim=-1).indices
    nb = pts[idx]
    centred = nb - nb.mean(-2, keepdim=True)
    vec = smallest_eigvec(torch.einsum("nki,nkj->nij", centred, centred))
    n_pos = ((vec[:, None, :] * centred).sum(-1) > 0).to(torch.float32).sum(-1, keepdim=True)
    vec = (1.0 - 2.0 * (n_pos < 0.5 * k).to(torch.float32)) * vec
    return vec / torch.clamp_min(torch.linalg.norm(vec, dim=-1, keepdim=True), EPS)


def sh3_color(sh, d):
    """Degree-3 SH [N, 16, 3] at unit directions [N, 3], + 0.5, clamped at 0."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [SH_C0 + 0 * x, -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
             SH_C2[3] * xz, SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
             SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3 * yy)]
    out = sum(b * sh[:, i, :] for i, b in enumerate(basis))
    return torch.clamp_min(out + 0.5, 0.0)


def cast_rays(scene, select_draw, slot_draw, pose, dt=torch.float32):
    """Rays from the ellipsoid surfaces of a Gaussian scene with a fixed
    budget (sampling.py:127-267, quadricell.py:322-386). ``scene`` holds
    xyz, log scales, quaternions, SH [C, 16, 3]; ``select_draw`` [C] and
    ``slot_draw`` [E * rings * points] are the uniform draws that pick the
    ellipsoids and the rays. Returns dict(ori, dir, rgb, valid, gidx)."""
    target, r_max, p_max = pose["quadricell_targets"], pose["ring_slots"], pose["ring_points"]
    scale = torch.exp(scene["scaling"])
    a, b, c = scale[:, 0], scale[:, 1], scale[:, 2]
    rings, _ = ring_layout(a, b, c, target)
    ok = rings < target
    sel = torch.argsort(select_draw + (~ok).to(torch.float32) * 1e9,
                        stable=True)[:pose["max_ellipsoids"]]
    e_ok, centres, s = ok[sel], scene["xyz"][sel], scale[sel]
    rots = quat_to_rotmat(scene["rotation"][sel])
    nrm = normals(centres, e_ok, pose["knn_normals"], dt)

    a, b, c = s[:, 0], s[:, 1], s[:, 2]
    rings, side = ring_layout(a, b, c, target)
    ring = torch.arange(r_max, device=a.device, dtype=torch.float32)
    dz = 2.0 * a[:, None] / torch.clamp_min(rings.to(torch.float32), 1.0)[:, None]
    z = 0.5 * dz + dz * ring[None] - a[:, None]
    shrink = torch.sqrt(torch.clamp_min(1.0 - (z / a[:, None]) ** 2, 0.0))
    br, cr = b[:, None] * shrink, c[:, None] * shrink
    ppr = torch.clamp_max(torch.floor(ellipse_perimeter(br, cr) / side[:, None]), float(p_max))
    pt = torch.arange(p_max, device=a.device, dtype=torch.float32)
    theta = (2.0 * math.pi / torch.clamp_min(ppr, 1.0))[..., None] * pt
    local = torch.stack([br[..., None] * torch.cos(theta), cr[..., None] * torch.sin(theta),
                         z[..., None].expand(theta.shape)], -1)
    valid = ((ring[None] < rings.to(torch.float32)[:, None])[..., None]
             & (pt < ppr[..., None])).reshape(len(sel), -1) & e_ok[:, None]
    local = local.reshape(len(sel), -1, 3)
    world = torch.einsum("eij,esj->esi", rots, local)
    valid = valid & (torch.einsum("ei,esi->es", nrm, world) > 0)
    dirs = world / torch.clamp_min(torch.linalg.norm(world, dim=-1, keepdim=True), EPS)
    oris = world + centres[:, None, :]

    flat = valid.reshape(-1)
    order = torch.argsort(slot_draw + (~flat).to(torch.float32) * 1e9,
                          stable=True)[:pose["ray_budget"]]
    keep = flat[order]
    ray_dir = dirs.reshape(-1, 3)[order]
    gidx = sel[order // local.shape[1]]
    sh = torch.cat([scene["features_dc"], scene["features_rest"]], 1)[gidx]
    rgb = sh3_color(sh, -ray_dir)
    k = keep[:, None]
    return {"ori": torch.where(k, oris.reshape(-1, 3)[order], 0.0),
            "dir": torch.where(k, ray_dir, 0.0), "rgb": torch.where(k, rgb, 0.0),
            "valid": keep, "gidx": torch.where(keep, gidx, -1)}


def match_rays(got, want):
    """Order-free matching of two ray sets: each valid wanted ray is looked
    up among the valid rays got by (parent Gaussian, direction). Returns
    (the larger of the shares of wanted rays without an equal got ray and of
    got rays left over, index into ``got`` per wanted ray, -1 where
    unmatched). Equal: same parent, origin and direction within 1e-5."""
    def keys(r):
        mix = torch.tensor([0.7548776662, 0.5698402910, 0.3], dtype=torch.float64,
                           device=r["dir"].device)
        return r["gidx"].to(torch.float64) * 8.0 + 4.0 + r["dir"].to(torch.float64) @ mix

    gv = torch.nonzero(got["valid"]).reshape(-1)
    wv = torch.nonzero(want["valid"]).reshape(-1)
    gk, order = torch.sort(keys(got)[gv])
    gv = gv[order]
    wk = keys(want)[wv]
    pos = torch.searchsorted(gk, wk).clamp(0, max(len(gk) - 1, 0))
    idx = torch.full((len(want["valid"]),), -1, dtype=torch.long, device=wk.device)
    if len(gk) == 0 or len(wk) == 0:
        return (1.0 if len(wk) else 0.0), idx
    def equal(g):
        return ((got["gidx"][g] == want["gidx"][wv])
                & ((got["ori"][g] - want["ori"][wv]).abs().amax(-1) <= 1e-5)
                & ((got["dir"][g] - want["dir"][wv]).abs().amax(-1) <= 1e-5))

    right, left = gv[pos], gv[(pos - 1).clamp_min(0)]
    best = torch.where(equal(right), right, torch.where(equal(left), left, -1))
    idx[wv] = best
    hits = int((best >= 0).sum())
    return max(1.0 - hits / len(wv), 1.0 - hits / len(gv)), idx


# ---------------------------------------------------------------- id module


def ray_features(idm, rays, dt=torch.float32):
    """Ray MLP (ray_preprocessor.py): positional encodings of origin (8),
    direction (8) and colour (6) octaves beside the raw values, 141 wide;
    141 -> 512 -> 512, skip concat, 653 -> 512 -> D, ReLU between."""
    def pe(x, n):
        pts = (x[..., None] * 2.0 ** torch.arange(float(n), device=x.device)).reshape(len(x), -1)
        return torch.cat([torch.sin(pts), torch.cos(pts)], -1)

    o, d, c = rays["ori"], rays["dir"], rays["rgb"]
    x = torch.cat([o, d, c, pe(o, 8), pe(d, 8), pe(c, 6)], -1)
    p = idm["ray_mlp"]
    h = F.relu(linear(x, p["l1"], dt))
    h = F.relu(linear(h, p["l2"], dt))
    h = F.relu(linear(torch.cat([h, x], -1), p["l3"], dt))
    return linear(h, p["l4"], dt)


def ray_scores(idm, feats_pe, ray_feats, patch_mask, valid, dt=torch.float32):
    """Single-head attention of patches over rays: softmax over rays of
    q k^T / sqrt(D), invalid rays at -9e15, summed over the masked patches."""
    q = linear(feats_pe, idm["attention"]["q"], dt)
    k = linear(ray_feats, idm["attention"]["k"], dt)
    logits = mm(q, k.T, dt) / math.sqrt(q.shape[-1])
    logits = torch.where(valid[None, :], logits, torch.full_like(logits, NEG))
    return (torch.softmax(logits, -1) * patch_mask[:, None].to(torch.float32)).sum(0)


def cam_up(idm, fmap, dt=torch.float32):
    """Three valid 5x5 convolutions and a valid 4x4, ReLU each, flattened,
    MLP to 256 and 3 (camera_direction_network.py); unit length."""
    p = idm["cam_up"]
    x = fmap[None]
    for layer in (*p["conv1"], *p["conv2"]):
        x = F.relu(conv(x, layer["w"], layer["b"], dt))
    h = F.relu(linear(x.reshape(1, -1), p["mlp1"], dt))
    up = linear(h, p["mlp2"], dt)[0]
    return up / torch.clamp_min(torch.linalg.norm(up), EPS)


def score_image(backbone, bweights, idm, img, mask, rays, ray_feats=None, dt=torch.float32):
    """Backbone features with the position encoding, per-ray scores and the
    unit camera-up of one image: (scores [N], cam_up [3], patch count)."""
    x, pmask = preprocess(img, mask, backbone.GRID)
    feats = backbone.features(bweights, x, dt)
    fp = torch.cat([feats, position_encoding(backbone.GRID, feats.device)], -1)
    fmap = feats.reshape(backbone.GRID, backbone.GRID, -1).permute(2, 0, 1)
    if ray_feats is None:
        ray_feats = ray_features(idm, rays, dt)
    scores = ray_scores(idm, fp, ray_feats, pmask, rays["valid"], dt)
    return scores, cam_up(idm, fmap, dt), pmask.sum()


# -------------------------------------------------------------------- losses


def target_scores(c2w, rays, n_patches):
    """1 - tanh(distance of the camera centre to the ray), 0 behind the
    camera plane and for invalid rays, scaled to sum to the patch count."""
    o, d, v = rays["ori"], rays["dir"], rays["valid"]
    pos = c2w[:3, 3]
    proj = ((pos - o) * d).sum(-1, keepdim=True)
    closest = torch.where(proj < 0, o, o + proj * d)
    t = 1.0 - torch.tanh(torch.linalg.norm(closest - pos, dim=-1))
    side = ((o - pos) * c2w[:3, 2]).sum(-1)
    t = t * torch.where(side == 0, 0.0, (torch.sign(side) + 1.0) * 0.5)
    t = torch.where(v, t, 0.0)
    return torch.where(v, t * n_patches.to(torch.float32) / t.sum(), 0.0)


def score_loss(scores, c2w, rays, n_patches):
    t = target_scores(c2w, rays, n_patches)
    v = rays["valid"]
    return torch.where(v, (scores - t) ** 2, 0.0).sum() / torch.clamp_min(v.sum(), 1)


def up_loss(model_up, up):
    mu = model_up / torch.clamp_min(torch.linalg.norm(model_up), EPS)
    cu = up / torch.clamp_min(torch.linalg.norm(up), EPS)
    return 0.5 - 0.5 * (mu * cu).sum()


# -------------------------------------------------------------------- solver


def _line_intersection(o, d, w, dt):
    eye = torch.eye(3, device=o.device)
    pw = (eye - d[:, :, None] * d[:, None, :]) * w[:, None, None]
    R = pw.sum(0)
    q = mm(pw, o[:, :, None], dt).sum(0)[:, 0]
    det = torch.dot(R[0], _cross(R[1], R[2]))
    adj = torch.stack([_cross(R[:, 1], R[:, 2]), _cross(R[:, 2], R[:, 0]),
                       _cross(R[:, 0], R[:, 1])])
    p = mm(adj, q, dt) / torch.where(det.abs() < 1e-30, torch.ones_like(det), det)
    return torch.where(det < 1e-7, torch.full_like(p, float("nan")), p)


def solve(scores, rays, up, k, dt=torch.float32):
    """Top-k rays, the loose duplicate-origin filter of test.py:157-162, an
    unweighted least-squares intersection, the watch direction from the
    normalised weights of the rays in front, the rotation from it and the
    camera up; identity on a singular rotation or a NaN (test.py:85-218)."""
    w, idx = torch.topk(torch.where(rays["valid"], scores, float("-inf")), k)
    o, d = rays["ori"][idx], rays["dir"][idx]
    fin = torch.isfinite(w)
    same = ((o[:, None] - o[None]).abs() == 0).all(-1)
    single = ((same & fin[None]).sum(-1) == 1) & fin
    flat = o.reshape(-1)
    pos = torch.arange(len(flat), device=o.device)
    eq = (flat[:, None] == flat[None]) & fin.repeat_interleave(3)[None]
    later = (eq & (pos[None] > pos[:, None])).any(1)
    pool = (eq & single.repeat_interleave(3)[None]).any(1)
    keep = (later | pool).reshape(-1, 3).any(1) & fin
    wk = torch.where(keep, w, 0.0)
    wk = wk / wk.sum()
    centre = _line_intersection(o, d, keep.to(torch.float32), dt)
    wk = wk * (((centre - o) * d).sum(-1) > 0).to(torch.float32)
    wk = wk / wk.sum()
    watch = (d * wk[:, None]).sum(0)
    watch = watch / torch.linalg.norm(watch)
    x = _cross(up, -watch)
    x = x / torch.linalg.norm(x)
    y = _cross(-watch, x)
    y = y / torch.linalg.norm(y)
    R = torch.stack([x, y, -watch])
    eye4 = torch.eye(4, device=o.device)
    if torch.dot(R[0], _cross(R[1], R[2])) < 1e-7:
        R = torch.eye(3, device=o.device)
    c2w = eye4.clone()
    c2w[:3, :3] = R.T
    c2w[:3, 3] = centre
    return eye4 if torch.isnan(c2w).any() else c2w


# ----------------------------------------------------------------- Adafactor


def adafactor(p, g, st):
    """One update of the 6DGS pose stage's Adafactor (HF defaults: relative
    step min(1e-2, 1/sqrt(t)), decay 1 - t^-0.8, eps 1e-30, factored over
    the two largest axes when the second has >= 128 entries, clip by block
    RMS 1, times max(rms(p), 1e-3)). Returns the new parameter."""
    t = float(st.get("step", 0))
    decay = 1.0 - (t + 1.0) ** -0.8
    g2 = g * g + 1e-30
    dims = np.argsort(p.shape) if p.dim() >= 2 else None
    if dims is None or p.shape[dims[-2]] < 128:
        st["v"] = decay * st.get("v", torch.zeros_like(p)) + (1 - decay) * g2
        u = g / torch.sqrt(st["v"])
    else:
        d1, d0 = int(dims[-2]), int(dims[-1])
        st["r"] = decay * st.get("r", torch.zeros_like(g2.mean(d0))) + (1 - decay) * g2.mean(d0)
        st["c"] = decay * st.get("c", torch.zeros_like(g2.mean(d1))) + (1 - decay) * g2.mean(d1)
        rd = d1 - 1 if d1 > d0 else d1
        row = (st["r"] / st["r"].mean(rd, keepdim=True)) ** -0.5
        u = g * row.unsqueeze(d0) * (st["c"] ** -0.5).unsqueeze(d1)
    u = u / torch.clamp_min(torch.sqrt((u * u).mean()), 1.0)
    u = min(1e-2, 1.0 / math.sqrt(t + 1.0)) * u
    rms = torch.sqrt((p * p).mean())
    st["step"] = t + 1
    return p - u * torch.clamp_min(rms, 1e-3)
