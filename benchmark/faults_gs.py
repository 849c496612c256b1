"""Faults planted in the 3DGS training path, each a function that plants
it and returns its undo: for the control readings on the card
(``control_gs.py``) and the benchmark's own tests on the CPU.

- ``state_unchanged``: Adam returns the parameters and moments it got;
- ``half_image``: the loss over the top half of the image only, its mean
  taken over that half (one camera a step: the pixels are the batch);
- ``render_altered``: one pixel of the rendered image moved by 0.05 where
  it is produced;
- ``tier_grads_zeroed``: the gradients of the Gaussians in the mid tier of
  the binning (those the tiers give up to t_max_mid tiles) zeroed.
"""

from __future__ import annotations


def _swap(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    return lambda: setattr(module, name, original)


def state_unchanged():
    from sixdgs_torch.train import gs_trainer

    return _swap(gs_trainer, "adam_update", lambda f: lambda p, g, st, lrs: (dict(p), st))


def half_image():
    from sixdgs_torch.train import gs_trainer

    def make(f):
        def loss(img, gt, *a, **k):
            h = img.shape[1] // 2
            return f(img[:, :h], gt[:, :h], *a, **k)
        return loss
    return _swap(gs_trainer, "dssim_l1_loss", make)


def render_altered():
    from sixdgs_torch.train import gs_trainer

    def make(f):
        def render(*a, **k):
            out = f(*a, **k)
            img = out[0].clone()
            img[0, img.shape[1] // 2, img.shape[2] // 2] += 0.05
            return (img,) + tuple(out[1:])
        return render
    return _swap(gs_trainer, "_render_params", make)


def tier_grads_zeroed():
    from sixdgs_torch.ops.rasterizer import pallas_tiles, tiles

    mid = {}

    def select(f):
        def pick(*a, **k):
            out = f(*a, **k)
            mid["idx"] = out[2][out[3]]
            return out
        return pick

    def gather(f):
        def records(lay, gidx):
            if lay.records.requires_grad and mid.get("idx") is not None:
                idx = mid["idx"]
                lay.records.register_hook(lambda g: g.index_fill(0, idx, 0.0))
            return f(lay, gidx)
        return records

    undo = [_swap(tiles, "_select_tiers", select), _swap(pallas_tiles, "_gather_records", gather)]
    return lambda: [u() for u in reversed(undo)]


FAULTS = {f.__name__: f for f in (state_unchanged, half_image, render_altered,
                                   tier_grads_zeroed)}
