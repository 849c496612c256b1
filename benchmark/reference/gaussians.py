"""Plain reference of one 3DGS training step (arXiv:2308.04079), in float32
PyTorch with TF32 off. It imports nothing of the program.

One step on one camera: EWA projection of every Gaussian (world to camera,
the perspective Jacobian with the 1.3 tan(fov / 2) frustum clamp, the 2D
covariance with the 0.3-pixel low-pass dilation, its conic and the 3-sigma
radius ceil(3 sqrt(lambda_max))), the view-dependent SH colour of degree
<= 3 plus 0.5 clamped at 0, sigmoid opacity; the tiles each Gaussian's
screen rectangle covers; every tile's pairs sorted by depth; front-to-back
compositing of each pixel: alpha = min(0.99, opacity exp(power)), a pair
with power > 0 or alpha < 1/255 skipped, the pixel stopped at the first
pair that would take its transmittance under 1e-4 (that pair does not
contribute), then the background; the loss 0.8 L1 + 0.2 (1 - SSIM) (11 x
11 Gaussian window, sigma 1.5, zero padding); gradients by autograd; one
Adam step (beta 0.9 / 0.999, eps 1e-15, bias-corrected) at the step's
learning rates (the position rate decayed log-linearly from 1.6e-4 to
1.6e-6 times the scene's extent over 30,000 iterations).

Where the port departs from the published rasterizer, this follows it:

- visibility: view depth > 0.2, a positive 2D determinant and the
  rectangle mean +- radius overlapping the image (the published one drops
  a Gaussian whose tile rectangle is empty, nearly the same test);
- the tile rectangle: floor((m - r) / 16) to ceil((m + r + 1) / 16),
  clipped to the grid (the published getRect truncates (m - r) / 16 and
  (m + r + 15) / 16, one tile narrower at some positions);
- the tile budgets (``tiers``: t_max, mid_k, t_max_mid, overflow_k,
  t_max_big): the ``overflow_k`` largest rectangles of more than t_max
  tiles keep up to t_max_big tiles, the next ``mid_k`` up to t_max_mid, all
  others up to t_max; a capped Gaussian keeps a sub-rectangle of width
  min(w, budget) and height max(min(h, budget // width), 1) centred on its
  mean's tile and shifted inside its rectangle (ties of area go to the
  nearer Gaussian);
- the background gets no gradient.

The port also drops pairs whose tile lies wholly where alpha < 1/255 (a
conic cull): such pairs contribute nothing, so the reference keeps them.

The compositor runs in two passes over tiles, so that it fits beside the
scene: a walk of every tile in chunks of depth slots, carrying
transmittance and stop, finds how many slots each tile needs; then tiles
are composited in dense blocks of those slots, once without gradients for
the image and the loss, and once more under autograd, block by block, with
the loss's gradient of each block's pixels. ``dt`` computes the products
alpha = opacity exp(power) and colour x weight in that precision (the
control at bfloat16; None: the inputs' own); everything else stays in the
inputs' precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

TILE = 16
NPIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
LOW_PASS = 0.3
NEAR = 0.2
CHUNK = 64  # depth slots per round of the walk
BLOCK = 1 << 25  # pixel-pair evaluations per dense block
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
PARAMS = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sh_basis(deg, d):
    """The real SH basis up to ``deg`` (<= 3) at unit directions d [P, 3]:
    [P, (deg + 1)^2] (the published sh_utils.eval_sh's terms)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    out = [torch.full_like(x, SH_C0)]
    if deg > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
                SH_C2[3] * x * z, SH_C2[4] * (xx - yy)]
    if deg > 2:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=1)


def rotation(q):
    """[P, 4] (w, x, y, z) quaternions, normalised -> [P, 3, 3]."""
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    r, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], 1).reshape(-1, 3, 3)


def _row(xyz, M, k):
    """Row k of M [4, 4] applied to the points, summed in the published
    order x m0 + y m1 + z m2 + m3, so that depth ties break alike."""
    return xyz[:, 0] * M[k, 0] + xyz[:, 1] * M[k, 1] + xyz[:, 2] * M[k, 2] + M[k, 3]


def _screen(xyz, cam, width, height):
    """View coordinates [P, 3] and pixel means."""
    t = torch.stack([_row(xyz, cam["view"], k) for k in range(3)], 1)
    w = 1.0 / (_row(xyz, cam["full_proj"], 3) + 1e-7)
    mx = ((_row(xyz, cam["full_proj"], 0) * w + 1.0) * width - 1.0) * 0.5
    my = ((_row(xyz, cam["full_proj"], 1) * w + 1.0) * height - 1.0) * 0.5
    return t, mx, my


def project(params, cam, width, height, sh_degree):
    """(records [V, 9]: mean x, y, conic a, b, c, colour r, g, b, opacity;
    radii [V]; idx [V]) of the visible Gaussians in depth order, records
    differentiable in ``params``."""
    xyz = params["xyz"]
    tanx, tany = cam["tan_fovx"], cam["tan_fovy"]
    fx, fy = width / (2.0 * tanx), height / (2.0 * tany)

    def cov2d(xyz, scaling, rot):
        t, mx, my = _screen(xyz, cam, width, height)
        tz = t[:, 2]
        limx, limy = 1.3 * tanx, 1.3 * tany
        tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
        ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
        zero = torch.zeros_like(tz)
        J = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                         zero, fy / tz, -fy * ty / (tz * tz)], 1).reshape(-1, 2, 3)
        T = J @ cam["view"][:3, :3]
        M = rotation(rot) * torch.exp(scaling)[:, None, :]
        S = T @ M
        cov = S @ S.transpose(1, 2)
        return tz, mx, my, cov[:, 0, 0] + LOW_PASS, cov[:, 0, 1], cov[:, 1, 1] + LOW_PASS

    with torch.no_grad():
        tz, mx, my, a, b, c = cov2d(xyz, params["scaling"], params["rotation"])
        det = a * c - b * b
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius = torch.ceil(3.0 * torch.sqrt(lam))
        visible = ((tz > NEAR) & (det > 0) & (mx + radius > 0) & (mx - radius < width)
                   & (my + radius > 0) & (my - radius < height))
        idx = torch.nonzero(visible).flatten()
        idx = idx[torch.argsort(tz[idx], stable=True)]
        radius = radius[idx]

    tz, mx, my, a, b, c = cov2d(xyz[idx], params["scaling"][idx], params["rotation"][idx])
    det = a * c - b * b
    p = xyz[idx]
    d = p - cam["campos"]
    d = d / d.norm(dim=1, keepdim=True).clamp_min(1e-12)
    n = (sh_degree + 1) ** 2
    sh = torch.cat([params["features_dc"][idx], params["features_rest"][idx]], 1)[:, :n]
    colour = torch.clamp_min((sh_basis(sh_degree, d)[:, :, None] * sh).sum(1) + 0.5, 0.0)
    opacity = torch.sigmoid(params["opacity"][idx, 0])
    rec = torch.stack([mx, my, c / det, -b / det, a / det, colour[:, 0], colour[:, 1],
                       colour[:, 2], opacity], 1)
    return rec, radius, idx


def tile_rects(mx, my, radius, nx, ny):
    """Clipped tile rectangles [x0, x1) x [y0, y1) and the mean's tile."""
    def clip(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int64)

    x0 = clip(torch.floor((mx - radius) / TILE), nx)
    y0 = clip(torch.floor((my - radius) / TILE), ny)
    x1 = clip(torch.ceil((mx + radius + 1) / TILE), nx)
    y1 = clip(torch.ceil((my + radius + 1) / TILE), ny)
    cx = torch.minimum(torch.maximum((mx / TILE).to(torch.int64), x0), torch.maximum(x1 - 1, x0))
    cy = torch.minimum(torch.maximum((my / TILE).to(torch.int64), y0), torch.maximum(y1 - 1, y0))
    return x0, y0, x1, y1, cx, cy


def budgets(area, t_max, mid_k, t_max_mid, overflow_k, t_max_big):
    """Each depth-ordered Gaussian's tile budget under the port's tiers."""
    out = torch.full_like(area, t_max)
    big = torch.nonzero(area > t_max).flatten()
    order = big[torch.argsort(-area[big], stable=True)]
    out[order[:overflow_k]] = t_max_big
    out[order[overflow_k:overflow_k + mid_k]] = t_max_mid
    return out


def pairs(rec, radius, width, height, tiers):
    """Every (tile, depth rank) pair, sorted by tile then depth: (tile [N],
    rank [N], per-tile starts [n_tiles + 1])."""
    nx, ny = -(-width // TILE), -(-height // TILE)
    x0, y0, x1, y1, cx, cy = tile_rects(rec[:, 0], rec[:, 1], radius, nx, ny)
    rw, rh = (x1 - x0).clamp_min(0), (y1 - y0).clamp_min(0)
    budget = budgets(rw * rh, *tiers)
    w = torch.minimum(rw, budget)
    h = torch.clamp_min(torch.minimum(rh, budget // w.clamp_min(1)), 1)
    n = torch.where((rw > 0) & (rh > 0), w * h, torch.zeros_like(w))
    sx = torch.minimum(torch.maximum(cx - w // 2, x0), torch.maximum(x1 - w, x0))
    sy = torch.minimum(torch.maximum(cy - h // 2, y0), torch.maximum(y1 - h, y0))
    rank = torch.repeat_interleave(torch.arange(rec.shape[0], device=rec.device), n)
    k = torch.arange(rank.shape[0], device=rec.device) - (torch.cumsum(n, 0) - n)[rank]
    wr = w[rank]
    tile = (sy[rank] + k // wr) * nx + sx[rank] + k % wr
    order = torch.argsort(tile * rec.shape[0] + rank)
    tile, rank = tile[order], rank[order]
    starts = torch.searchsorted(tile, torch.arange(nx * ny + 1, device=rec.device))
    return tile, rank, starts


def _pixels(tiles, nx, device):
    lin = torch.arange(NPIX, device=device)
    px = (tiles % nx * TILE)[:, None] + lin % TILE
    py = (tiles // nx * TILE)[:, None] + lin // TILE
    return px.to(torch.float32), py.to(torch.float32)


def _alpha(rec, px, py, live, dt):
    """alpha [A, K, NPIX] of records [A, K, 9] at pixels [A, NPIX]; ``live``
    [A, K] marks real pairs."""
    dx = px[:, None, :] - rec[..., 0, None]
    dy = py[:, None, :] - rec[..., 1, None]
    power = (-0.5 * (rec[..., 2, None] * dx * dx + rec[..., 4, None] * dy * dy)
             - rec[..., 3, None] * dx * dy)
    g = torch.exp(power)
    o = rec[..., 8, None]
    prod = o * g if dt is None else (o.to(dt) * g.to(dt)).to(o.dtype)
    alpha = torch.clamp_max(prod, ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & live[..., None]
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def _weights(alpha, T0, done0):
    """Front-to-back weights alpha T of a run of slots [A, K, NPIX] after
    carries T0, done0 [A, NPIX]: (weights, T after, done after, the slot
    each pixel stopped at or K)."""
    one = 1.0 - alpha
    cum = torch.cumprod(one, dim=1)
    before = T0[:, None] * torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], 1)
    stop = torch.cumsum((before * one < T_EPS).to(torch.int32), 1) > 0
    dead = stop | done0[:, None]
    w = torch.where(dead, torch.zeros_like(alpha), alpha * before)
    T = T0 * torch.prod(torch.where(dead, torch.ones_like(one), one), 1)
    first = torch.where(stop.any(1), torch.argmax(stop.to(torch.int8), 1),
                        torch.full_like(T0, alpha.shape[1], dtype=torch.int64))
    return w, T, dead[:, -1], first


def _blend(w, rec, dt):
    """sum over slots of weight x colour: [A, NPIX, 3]."""
    col = rec[..., 5:8]
    if dt is None:
        return torch.einsum("akp,akc->apc", w, col)
    return (w.to(dt)[..., None] * col.to(dt)[:, :, None, :]).to(w.dtype).sum(1)


def walk(rec, rank, starts, nx, dt=None, counted=None):
    """The compositor's walk over every tile in chunks of CHUNK slots, no
    gradient: (slots each tile needs [n_tiles], work). A tile needs its
    slots up to the last of its pixels' stops (all of them where a pixel
    never stops). ``counted`` [N] bool marks the pairs whose evaluations
    are counted: work = (real pairs, evaluations of counted pairs up to
    and with each pixel's stop, contributing pairs)."""
    dev = rec.device
    n_tiles = starts.shape[0] - 1
    counts = starts[1:] - starts[:-1]
    stop_at = counts[:, None].expand(n_tiles, NPIX).clone()  # slots each pixel needs
    T = torch.ones(n_tiles, NPIX, dtype=rec.dtype, device=dev)
    done = torch.zeros(n_tiles, NPIX, dtype=torch.bool, device=dev)
    lane = torch.arange(CHUNK, device=dev)
    evals = contribs = torch.zeros((), dtype=torch.int64, device=dev)
    real = int(counts.sum()) if counted is None else int(counted.sum())
    with torch.no_grad():
        for k0 in range(0, int(counts.max()) if n_tiles else 0, CHUNK):
            act = torch.nonzero((counts > k0) & ~done.all(1)).flatten()
            if act.numel() == 0:
                break
            live = (k0 + lane)[None, :] < counts[act, None]
            at = torch.clamp_max(starts[act, None] + k0 + lane[None, :], rank.shape[0] - 1)
            px, py = _pixels(act, nx, dev)
            alpha = _alpha(rec[rank[at]], px, py, live, dt)
            w, T_after, done_after, first = _weights(alpha, T[act], done[act])
            open_ = ~done[act]
            stop_at[act] = torch.where(open_ & (first < CHUNK), k0 + first + 1, stop_at[act])
            reach = torch.where(open_, torch.clamp_max(first + 1, CHUNK),
                                torch.zeros_like(first))  # slots each pixel evaluates
            ok = live if counted is None else live & counted[at]
            evals = evals + (ok[:, :, None] & (lane[None, :, None] < reach[:, None, :])).sum()
            contribs = contribs + (w > 0).sum()
            T[act], done[act] = T_after, done_after
    # a margin of slots: the dense passes' own products may stop a pixel later
    need = torch.minimum(stop_at.max(1).values + 16, counts) if n_tiles else counts
    return need, (real, int(evals), int(contribs))


def _blocks(need):
    """Tiles in order of slots needed, cut into blocks of at most BLOCK
    evaluations: [(tiles, slots)]."""
    order = torch.argsort(need, descending=True)
    n = need[order].tolist()
    out, i = [], 0
    while i < len(n) and n[i] > 0:
        k = n[i]
        j = min(len(n), i + max(1, BLOCK // (k * NPIX)))
        out.append((order[i:j], k))
        i = j
    return out


def _dense(rec, rank, starts, tiles, k, nx, bg, dt):
    """The composited pixels [A, NPIX, 3] of ``tiles``, their first k slots."""
    dev = rec.device
    counts = (starts[1:] - starts[:-1])[tiles]
    lane = torch.arange(k, device=dev)
    live = lane[None, :] < counts[:, None]
    at = torch.clamp_max(starts[tiles, None] + lane[None, :], rank.shape[0] - 1)
    px, py = _pixels(tiles, nx, dev)
    alpha = _alpha(rec[rank[at]], px, py, live, dt)
    T0 = torch.ones(tiles.shape[0], NPIX, dtype=rec.dtype, device=dev)
    w, T, _, _ = _weights(alpha, T0, torch.zeros_like(T0, dtype=torch.bool))
    return _blend(w, rec[rank[at]], dt) + T[..., None] * bg


def _to_image(tiles_px, nx, ny, width, height):
    img = tiles_px.reshape(ny, nx, TILE, TILE, 3).permute(4, 0, 2, 1, 3)
    return img.reshape(3, ny * TILE, nx * TILE)[:, :height, :width]


def _from_image(img, nx, ny):
    pad = torch.zeros(3, ny * TILE, nx * TILE, dtype=img.dtype, device=img.device)
    pad[:, :img.shape[1], :img.shape[2]] = img
    return pad.reshape(3, ny, TILE, nx, TILE).permute(1, 3, 2, 4, 0).reshape(nx * ny, NPIX, 3)


def ssim(img1, img2):
    c = img1.shape[0]
    g = torch.exp(-((torch.arange(11, dtype=torch.float64) - 5) ** 2) / (2 * 1.5 ** 2))
    g = (g / g.sum()).to(img1.dtype)
    win = (g[:, None] @ g[None, :]).expand(c, 1, 11, 11).contiguous().to(img1.device)

    def blur(x):
        return F.conv2d(x[None], win, padding=5, groups=c)[0]

    mu1, mu2 = blur(img1), blur(img2)
    s11 = blur(img1 * img1) - mu1 * mu1
    s22 = blur(img2 * img2) - mu2 * mu2
    s12 = blur(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def loss_fn(img, gt, lambda_dssim=0.2):
    return (1.0 - lambda_dssim) * (img - gt).abs().mean() + lambda_dssim * (1.0 - ssim(img, gt))


def render(params, cam, width, height, sh_degree, tiers, bg, dt=None):
    """(image [3, H, W], the binned layout) without gradients."""
    with torch.no_grad():
        rec, radius, idx = project(params, cam, width, height, sh_degree)
        tile, rank, starts = pairs(rec, radius, width, height, tiers)
        nx, ny = -(-width // TILE), -(-height // TILE)
        need, work = walk(rec, rank, starts, nx, dt)
        px = torch.zeros(nx * ny, NPIX, 3, dtype=rec.dtype, device=rec.device) + bg
        for tiles, k in _blocks(need):
            px[tiles] = _dense(rec, rank, starts, tiles, k, nx, bg, dt)
    return _to_image(px, nx, ny, width, height), (rec, rank, starts, need, work)


def position_lr(iteration, extent, opt):
    t = min(max(iteration / opt["position_lr_max_steps"], 0.0), 1.0)
    return math.exp(math.log(opt["position_lr_init"]) * (1 - t)
                    + math.log(opt["position_lr_final"]) * t) * extent


def learning_rates(iteration, extent, opt):
    return {"xyz": position_lr(iteration, extent, opt), "features_dc": opt["feature_lr"],
            "features_rest": opt["feature_lr"] / 20.0, "opacity": opt["opacity_lr"],
            "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"]}


def adam(params, grads, m, v, step, lrs):
    """One bias-corrected Adam step: (params, m, v) after it; ``step`` is
    the count after the step."""
    bc1, bc2 = 1.0 - BETA1 ** step, 1.0 - BETA2 ** step
    out = ({}, {}, {})
    for k in params:
        mk = BETA1 * m[k] + (1.0 - BETA1) * grads[k]
        vk = BETA2 * v[k] + (1.0 - BETA2) * grads[k] * grads[k]
        out[0][k] = params[k] - lrs[k] * (mk / bc1) / (torch.sqrt(vk / bc2) + EPS)
        out[1][k], out[2][k] = mk, vk
    return out


def train_step(params, m, v, step, cam, gt, width, height, sh_degree, tiers, lrs, bg,
               lambda_dssim=0.2, dt=None):
    """One training step from (params, Adam m, v after ``step`` - 1 steps):
    {"image", "loss", "grads", "params", "m", "v"}."""
    no_tf32()
    img, (_, rank, starts, need, _) = render(params, cam, width, height, sh_degree, tiers,
                                             bg, dt)
    img = img.detach().requires_grad_(True)
    loss = loss_fn(img, gt, lambda_dssim)
    (d_img,) = torch.autograd.grad(loss, img)
    nx, ny = -(-width // TILE), -(-height // TILE)
    d_px = _from_image(d_img, nx, ny)
    leaves = {k: params[k].detach().requires_grad_(True) for k in PARAMS}
    rec, _, _ = project(leaves, cam, width, height, sh_degree)
    rec_leaf = rec.detach().requires_grad_(True)
    for tiles, k in _blocks(need):
        out = _dense(rec_leaf, rank, starts, tiles, k, nx, bg, dt)
        torch.autograd.backward(out, d_px[tiles])
    grads = dict(zip(PARAMS, torch.autograd.grad(rec, [leaves[k] for k in PARAMS],
                                                 rec_leaf.grad, allow_unused=True)))
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
    with torch.no_grad():
        new, m2, v2 = adam({k: params[k].detach() for k in PARAMS}, grads, m, v, step, lrs)
    return {"image": img.detach(), "loss": float(loss.detach()), "grads": grads, "params": new,
            "m": m2, "v": v2}
