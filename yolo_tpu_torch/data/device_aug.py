"""Training augmentation on the device: mosaic, affine, HSV and flip (the
port's counterpart of ``yolo_tpu/data/device_aug.py``, behind ``train
--device-aug``).

The host only decodes and letterboxes one image a sample; the batch, NHWC
f32 in [0, 1] on the device, goes through one random augmentation:

- mosaic: the batch and three copies rolled by drawn offsets tile a 2s x
  2s canvas, each output image mixing four images; the affine stage then
  takes an s window of it at a drawn jitter of +-s/2 (the host mosaic's
  random centre);
- affine: rotation, scale, shear and translation as one inverse bilinear
  warp with the grey border, or, at zero degrees and shear, the separable
  resampling of ``jax.image.scale_and_translate`` (antialiased when it
  shrinks: the per-axis weight matrices of JAX's ``compute_weight_mat``);
  boxes follow the warp and keep the reference's candidate filter (w, h >
  4 px, area ratio > 0.2, aspect < 10);
- HSV jitter in float, one draw a batch; left-right flips, one an image.

The draws and the arithmetic are apart: ``DeviceAugment.draw`` takes every
random number from one ``torch.Generator`` on the batch's device, and
``DeviceAugment.apply`` is a pure function of the batch and the draws.
Nothing in either reads a device value on the host. Labels ride through as
the capacity-padded (T, 6) [img, cls, xywh normalised] targets with their
valid mask; a dropped box clears its bit, and the mosaic's 4T rows are
compacted back to T, valid rows first.

Across processes the ranks augment the global batch alike (the same
draws) and each keeps its own block (``rows_of``), as the JAX package
augments its global batch and the mosaic rolls images across it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

PAD = 114.0 / 255.0


# ---------------------------------------------------------------- colour

def rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.where(d == 0, 1.0, d)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0)) / 6.0
    h = torch.where(d == 0, 0.0, h)
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):          # vals[k] where i == k
        out = vals[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def hsv_jitter(img, u, hgain, sgain, vgain):
    """HSV gains 1 + u * gain from the (3,) uniforms ``u`` in [-1, 1)."""
    g = [u[k] * gain + 1.0 for k, gain in enumerate((hgain, sgain, vgain))]
    hsv = rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    h = torch.remainder(hsv[..., 0] * g[0], 1.0)
    s = torch.clamp(hsv[..., 1] * g[1], 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] * g[2], 0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


# ---------------------------------------------------------------- affine

def _affine_matrix(aff, src_hw, border):
    """Forward (bs, 3, 3) matrices S @ T @ R from the drawn values ``aff``
    (bs, 8): angle, scale, x and y translation, x and y shear, x and y
    window jitter. Returns (M, scale (bs,))."""
    a, sc, tx, ty, shx, shy, wx, wy = aff.unbind(1)
    rad = -a * math.pi / 180.0       # cv2's rotation is ccw for +angle
    ca, sa = torch.cos(rad) * sc, torch.sin(rad) * sc
    cx, cy = src_hw[1] / 2.0, src_hw[0] / 2.0
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    R = torch.stack([
        torch.stack([ca, sa, (1 - ca) * cx - sa * cy], 1),
        torch.stack([-sa, ca, sa * cx + (1 - ca) * cy], 1),
        torch.stack([zero, zero, one], 1)], 1)
    T = torch.stack([
        torch.stack([one, zero, tx * src_hw[0] + border + wx], 1),
        torch.stack([zero, one, ty * src_hw[1] + border + wy], 1),
        torch.stack([zero, zero, one], 1)], 1)
    S = torch.stack([
        torch.stack([one, torch.tan(shx * math.pi / 180.0), zero], 1),
        torch.stack([torch.tan(shy * math.pi / 180.0), one, zero], 1),
        torch.stack([zero, zero, one], 1)], 1)
    return S @ T @ R, sc


def _weight_mat(in_size, out_size, scale, translation):
    """(bs, in_size, out_size) linear resampling weights of JAX's
    ``compute_weight_mat`` (antialiased): the triangle kernel widened by
    1/scale when it shrinks, each output column normalised, and zero where
    the sample lies outside the input."""
    dev, dt = scale.device, scale.dtype
    inv_scale = (1.0 / scale)[:, None, None]
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=dt, device=dev) + 0.5)
                * inv_scale - translation[:, None, None] * inv_scale - 0.5)
    x = (torch.abs(sample_f
                   - torch.arange(in_size, dtype=dt, device=dev)[:, None])
         / kernel_scale)
    w = torch.clamp_min(1 - torch.abs(x), 0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, w, 0.0)


def _warp_scale_translate(imgs, sc, bx, by, out_hw):
    """The warp dst = sc * src + b of each image as a separable resampling
    (``jax.image.scale_and_translate``, method 'linear'); the grey border
    by resampling img - PAD with a zero fill and adding PAD back."""
    oh, ow = out_hw
    wy = _weight_mat(imgs.shape[1], oh, sc, by)
    wx = _weight_mat(imgs.shape[2], ow, sc, bx)
    return torch.einsum('bhwc,bhy,bwx->byxc', imgs - PAD, wy, wx) + PAD


def _warp(imgs, M_inv, out_hw):
    """Inverse-map bilinear warp with the constant grey border."""
    bs, h, w = imgs.shape[:3]
    oh, ow = out_hw
    dev, dt = imgs.device, imgs.dtype
    ys = torch.arange(oh, dtype=dt, device=dev)[:, None].expand(oh, ow)
    xs = torch.arange(ow, dtype=dt, device=dev)[None, :].expand(oh, ow)
    m = M_inv[:, :2, :, None, None]                  # (bs, 2, 3, 1, 1)
    sx = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    sy = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    bi = torch.arange(bs, device=dev)[:, None, None]
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            xi_c = torch.clamp(xi, 0, w - 1).to(torch.long)
            yi_c = torch.clamp(yi, 0, h - 1).to(torch.long)
            val = torch.where(inside[..., None], imgs[bi, yi_c, xi_c], PAD)
            wgt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy))[..., None]
            out = out + wgt * val
    return out


# ---------------------------------------------------------------- the program

@dataclass(frozen=True)
class DeviceAugment:
    """The augmentation of ``img_size`` batches under ``hyp`` (degrees,
    translate, scale, shear, hsv_h, hsv_s, hsv_v).

    ``aug(imgs (bs, s, s, 3) f32 [0, 1], targets (T, 6), valid (T,),
    generator) -> (imgs, targets (T, 6), valid (T,))``: ``draw`` then
    ``apply``."""
    img_size: int
    degrees: float = 0.0
    translate: float = 0.0
    scale: float = 0.0
    shear: float = 0.0
    hgain: float = 0.0
    sgain: float = 0.0
    vgain: float = 0.0
    mosaic: bool = True
    flip_lr: bool = True

    def draw(self, bs: int, generator: torch.Generator) -> dict:
        """Every random number of one batch, on the generator's device:
        ``offs`` (3,) the mosaic's roll offsets in [1, max(bs, 2)),
        ``affine`` (bs, 8) each image's angle, scale, x/y translation
        (fractions), x/y shear (degrees) and x/y window jitter (px),
        ``hsv`` (3,) uniforms in [-1, 1), ``flips`` (bs,) bool."""
        dev = generator.device
        s = self.img_size
        jitter = s / 2.0 if self.mosaic else 0.0
        # the ranges are host floats: a tensor made from them on the device
        # would be a synchronising copy
        lo = (-self.degrees, 1 - self.scale, -self.translate, -self.translate,
              -self.shear, -self.shear, -jitter, -jitter)
        hi = (self.degrees, 1 + self.scale, self.translate, self.translate,
              self.shear, self.shear, jitter, jitter)
        u = torch.rand((bs, 8), generator=generator, device=dev)
        return {
            'offs': torch.randint(1, max(bs, 2), (3,), generator=generator,
                                  device=dev),
            'affine': torch.stack([a + u[:, k] * (b - a) for k, (a, b)
                                   in enumerate(zip(lo, hi))], 1),
            'hsv': torch.rand(3, generator=generator, device=dev) * 2 - 1,
            'flips': torch.rand(bs, generator=generator, device=dev) < 0.5}

    def apply(self, imgs, targets, valid, draws):
        """The augmentation of one batch given its ``draws``."""
        s = self.img_size
        bs, T = imgs.shape[0], targets.shape[0]
        dev = imgs.device
        if self.mosaic:
            offs = draws['offs']
            ar = torch.arange(bs, device=dev)
            quads = [imgs] + [imgs[(ar + offs[q]) % bs] for q in range(3)]
            canvas = torch.cat([torch.cat(quads[:2], 2),
                                torch.cat(quads[2:], 2)], 1)
            reps = []
            for q, (dy, dx) in enumerate(((0, 0), (0, s), (s, 0), (s, s))):
                img_i = (targets[:, 0] if q == 0 else
                         torch.remainder(targets[:, 0] - offs[q - 1], bs))
                t = targets
                reps.append(torch.stack([img_i, t[:, 1], t[:, 2] * s + dx,
                                         t[:, 3] * s + dy, t[:, 4] * s,
                                         t[:, 5] * s], 1))
            tgt_pix = torch.cat(reps, 0)                    # (4T, 6) canvas px
            val = valid.repeat(4)
            src_hw, border = (2 * s, 2 * s), -s // 2
        else:
            canvas = imgs
            t = targets
            tgt_pix = torch.stack([t[:, 0], t[:, 1], t[:, 2] * s, t[:, 3] * s,
                                   t[:, 4] * s, t[:, 5] * s], 1)
            val = valid
            src_hw, border = (s, s), 0

        Ms, ss = _affine_matrix(draws['affine'], src_hw, border)
        if self.degrees == 0.0 and self.shear == 0.0:
            out = _warp_scale_translate(canvas, Ms[:, 0, 0], Ms[:, 0, 2],
                                        Ms[:, 1, 2], (s, s))
        else:
            out = _warp(canvas, torch.linalg.inv_ex(Ms).inverse, (s, s))

        # the labels through their image's matrix
        img_i = torch.clamp(tgt_pix[:, 0].to(torch.long), 0, bs - 1)
        M_t, s_t = Ms[img_i], ss[img_i]
        x, y, w, h = tgt_pix[:, 2], tgt_pix[:, 3], tgt_pix[:, 4], tgt_pix[:, 5]
        x1, y1, x2, y2 = x - w / 2, y - h / 2, x + w / 2, y + h / 2
        cxs = torch.stack([x1, x2, x1, x2], 1)
        cys = torch.stack([y1, y2, y2, y1], 1)
        px = M_t[:, 0, 0:1] * cxs + M_t[:, 0, 1:2] * cys + M_t[:, 0, 2:3]
        py = M_t[:, 1, 0:1] * cxs + M_t[:, 1, 1:2] * cys + M_t[:, 1, 2:3]
        bx1 = torch.clamp(px.amin(1), 0, s)
        bx2 = torch.clamp(px.amax(1), 0, s)
        by1 = torch.clamp(py.amin(1), 0, s)
        by2 = torch.clamp(py.amax(1), 0, s)
        nw, nh = bx2 - bx1, by2 - by1
        ar = torch.maximum(nw / (nh + 1e-16), nh / (nw + 1e-16))
        keep = ((nw > 4) & (nh > 4)
                & (nw * nh / (w * h * s_t + 1e-16) > 0.2) & (ar < 10))
        val = val & keep

        # one HSV draw a batch; none for gray inputs
        if (self.hgain or self.sgain or self.vgain) and out.shape[-1] == 3:
            out = hsv_jitter(out, draws['hsv'], self.hgain, self.sgain,
                             self.vgain)

        if self.flip_lr:
            flips = draws['flips']
            out = torch.where(flips[:, None, None, None],
                              torch.flip(out, dims=[2]), out)
            f_t = flips[img_i]
            bx1, bx2 = (torch.where(f_t, s - bx2, bx1),
                        torch.where(f_t, s - bx1, bx2))

        new_t = torch.stack([tgt_pix[:, 0], tgt_pix[:, 1],
                             (bx1 + bx2) / 2 / s, (by1 + by2) / 2 / s,
                             (bx2 - bx1) / s, (by2 - by1) / s], 1)
        new_t = torch.where(val[:, None], new_t, 0.0)
        if self.mosaic:
            # back to the input's capacity T, valid rows first (the
            # truncation contract of pad_targets)
            order = torch.argsort((~val).to(torch.int8), stable=True)[:T]
            new_t, val = new_t[order], val[order]
        return out, new_t, val

    def __call__(self, imgs, targets, valid, generator):
        return self.apply(imgs, targets, valid,
                          self.draw(imgs.shape[0], generator))


def rows_of(imgs, targets, valid, start: int, n: int):
    """Images ``start`` to ``start + n`` of an augmented global batch with
    their targets (image indices shifted to the block, the others' rows
    masked; the capacity stays the global one): a rank's block after the
    augmentation of the global batch."""
    b = targets[:, 0]
    mine = valid & (b >= start) & (b < start + n)
    t = torch.cat([targets[:, :1] - start, targets[:, 1:]], 1)
    return imgs[start:start + n], t, mine


def make_device_augment(img_size: int, hyp: dict, *, mosaic: bool = True,
                        flip_lr: bool = True) -> DeviceAugment:
    """The augmentation for ``img_size`` under the hyp dict's gains."""
    return DeviceAugment(
        int(img_size), degrees=float(hyp.get('degrees', 0.0)),
        translate=float(hyp.get('translate', 0.0)),
        scale=float(hyp.get('scale', 0.0)), shear=float(hyp.get('shear', 0.0)),
        hgain=float(hyp.get('hsv_h', 0.0)), sgain=float(hyp.get('hsv_s', 0.0)),
        vgain=float(hyp.get('hsv_v', 0.0)), mosaic=mosaic, flip_lr=flip_lr)
