"""Plain reference of the CHORE field and its training step.

The published CHORE network (xiexh20/CHORE, ``model/`` and ``trainer/``)
written out in plain PyTorch over a dict of parameters named as the
published module's state dict: a 7x7 stride-2 stem, ConvBlocks (three 3x3
convolutions after GroupNorm and ReLU, concatenated, plus the input or its
1x1 projection), depth-2 hourglasses (average pool down, bicubic
align-corners up), ``num_stack`` stacks with intermediate outputs; four
per-point heads (df 2, pca 9, parts 14, centers 6) over the bilinearly
sampled features of each stack, the xyz depth feature and the stem's skip
feature; the six training losses averaged over the stacks; Adam.

Precision follows the configuration: ``"float32"`` computes every
convolution in float32; ``"mixed"`` computes every convolution of the
encoder in bfloat16 (inputs, weights and bias rounded to it) with the
GroupNorm statistics, the samples and the heads in float32. ``conv_round``
replaces the rounding of the encoder's convolution operands (the control
of the next lower precision, ``control.py``).

Imports nothing of the program under test.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# normalized Kinect colour intrinsics (BEHAVE's calibration, by the
# 2048-pixel image width)
KINECT = dict(fx=979.7844 / 2048.0, fy=979.840 / 2048.0,
              cx=1018.952 / 2048.0, cy=779.486 / 2048.0, size=2048)
LOSS_NAMES = ("df_h", "df_o", "parts", "pca", "smpl_center", "obj_center")
# the per-point heads' leaves, which both precisions compute in float32
HEADS = ("df.", "pca_predictor.", "part_predictor.", "center_predictor.")


def encoder_dtype(cfg):
    return torch.bfloat16 if cfg["precision"] == "mixed" else torch.float32


# the hourglasses' width; ``hourglass_dim`` is that of each stack's output
FEATURES = 256


def block_widths(cfg):
    """[(module prefix, in, out)] of every ConvBlock, the stem's first."""
    f = FEATURES
    out = [("image_filter.conv2", 64, 128), ("image_filter.conv3", 128, 128),
           ("image_filter.conv4", 128, f)]
    for i in range(cfg["num_stack"]):
        for lv in range(cfg["num_hourglass"], 0, -1):
            names = ["b1", "b2"] + (["b2_plus"] if lv == 1 else []) + ["b3"]
            out += [(f"image_filter.m{i}.{n}_{lv}", f, f) for n in names]
        out.append((f"image_filter.top_m_{i}", f, f))
    return out


def param_shapes(cfg):
    """{name: shape} of every parameter of the published field (the
    ``bn4`` of width-keeping ConvBlocks, which nothing uses, left out)."""
    f, o, h = FEATURES, cfg["hourglass_dim"], cfg["hidden_dim"]
    s = {"image_filter.conv1.weight": (64, cfg["input_channels"], 7, 7),
         "image_filter.conv1.bias": (64,),
         "image_filter.bn1.weight": (64,), "image_filter.bn1.bias": (64,)}
    for pre, cin, cout in block_widths(cfg):
        half, quarter = cout // 2, cout // 4
        s[f"{pre}.conv1.weight"] = (half, cin, 3, 3)
        s[f"{pre}.conv2.weight"] = (quarter, half, 3, 3)
        s[f"{pre}.conv3.weight"] = (quarter, quarter, 3, 3)
        for n, c in (("bn1", cin), ("bn2", half), ("bn3", quarter)):
            s[f"{pre}.{n}.weight"] = (c,)
            s[f"{pre}.{n}.bias"] = (c,)
        if cin != cout:
            s[f"{pre}.bn4.weight"] = (cin,)
            s[f"{pre}.bn4.bias"] = (cin,)
            s[f"{pre}.downsample.2.weight"] = (cout, cin, 1, 1)
    for i in range(cfg["num_stack"]):
        for n, cin, cout in (("conv_last", f, f), ("l", f, o),
                             ("bl", f, f), ("al", o, f)):
            if n in ("bl", "al") and i == cfg["num_stack"] - 1:
                continue
            s[f"image_filter.{n}{i}.weight"] = (cout, cin, 1, 1)
            s[f"image_filter.{n}{i}.bias"] = (cout,)
        s[f"image_filter.bn_end{i}.weight"] = (f,)
        s[f"image_filter.bn_end{i}.bias"] = (f,)
    feat = o + 3 + 64
    for head, out in (("df", 2), ("pca_predictor", 9),
                      ("part_predictor", cfg["num_parts"]),
                      ("center_predictor", 6)):
        for k, (cin, cout) in enumerate(((feat, h), (h, h), (h, h),
                                         (h, out))):
            s[f"{head}.{2 * k}.weight"] = (cout, cin, 1)
            s[f"{head}.{2 * k}.bias"] = (cout,)
    return s


def make_params(cfg, seed, device):
    """The benchmark's weights from ``seed``, made on ``device`` in one
    draw: every convolution weight N(0, 0.02) (PIFu's init, which CHORE
    uses), biases 0, GroupNorm scales 1 and shifts 0."""
    shapes = param_shapes(cfg)
    is_weight = {k: k.endswith(".weight") and len(v) > 1
                 for k, v in shapes.items()}
    total = sum(math.prod(v) for k, v in shapes.items() if is_weight[k])
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device) * 0.02
    out, at = {}, 0
    for k, shape in shapes.items():
        if is_weight[k]:
            n = math.prod(shape)
            out[k] = flat[at:at + n].view(shape).clone()
            at += n
        elif k.endswith(".weight"):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


# ---------------------------------------------------------------- encoder
class Encoder:
    """The stacked-hourglass encoder over a parameter dict ``p``."""

    def __init__(self, cfg, p, conv_round=None):
        self.cfg, self.p = cfg, p
        self.dt = encoder_dtype(cfg)
        self.round = conv_round or (lambda t: t.to(self.dt))
        self.mats = {}

    def conv(self, x, name, stride=1, padding=0):
        w = self.p[name + ".weight"]
        b = self.p.get(name + ".bias")
        return F.conv2d(self.round(x), self.round(w),
                        None if b is None else self.round(b), stride, padding)

    def gn(self, x, name):
        c = x.shape[1]
        return F.group_norm(x.float(), min(32, c), self.p[name + ".weight"],
                            self.p[name + ".bias"], 1e-5)

    def block(self, x, pre):
        o1 = self.conv(F.relu(self.gn(x, pre + ".bn1")), pre + ".conv1",
                       padding=1)
        o2 = self.conv(F.relu(self.gn(o1, pre + ".bn2")), pre + ".conv2",
                       padding=1)
        o3 = self.conv(F.relu(self.gn(o2, pre + ".bn3")), pre + ".conv3",
                       padding=1)
        res = x
        if pre + ".downsample.2.weight" in self.p:
            res = self.conv(F.relu(self.gn(x, pre + ".bn4")),
                            pre + ".downsample.2")
        return torch.cat([o1, o2, o3], 1) + res

    def upsample(self, x):
        """Bicubic (a = -0.75) x2, align_corners, edges replicated: float32
        by ``F.interpolate``, a lower precision by the two interpolation
        matrices in that precision."""
        if x.dtype == torch.float32:
            return F.interpolate(x, scale_factor=2, mode="bicubic",
                                 align_corners=True)
        H, W = x.shape[-2:]
        key = (H, W, x.dtype, x.device)
        if key not in self.mats:
            self.mats[key] = tuple(
                torch.as_tensor(bicubic_matrix(n, 2 * n)).to(x.device,
                                                              x.dtype)
                for n in (H, W))
        wh, ww = self.mats[key]
        x = torch.einsum("oh,bchw->bcow", wh, x)
        return torch.einsum("ow,bchw->bcho", ww, x)

    def hourglass(self, x, i, lv):
        pre = f"image_filter.m{i}."
        up1 = self.block(x, f"{pre}b1_{lv}")
        low1 = self.block(F.avg_pool2d(x, 2, 2), f"{pre}b2_{lv}")
        low2 = (self.hourglass(low1, i, lv - 1) if lv > 1
                else self.block(low1, f"{pre}b2_plus_{lv}"))
        return up1 + self.upsample(self.block(low2, f"{pre}b3_{lv}"))

    def __call__(self, images):
        """(B, H, W, 5) uint8 or float -> (stack outputs, stem feature),
        NCHW."""
        if not torch.is_floating_point(images):
            images = images.float() / 255.0
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.gn(self.conv(x, "image_filter.conv1", 2, 3),
                           "image_filter.bn1"))
        tmpx = x
        x = F.avg_pool2d(self.block(x, "image_filter.conv2"), 2, 2)
        x = self.block(self.block(x, "image_filter.conv3"),
                       "image_filter.conv4")
        prev, outs = x, []
        n = self.cfg["num_stack"]
        for i in range(n):
            hg = self.hourglass(prev, i, self.cfg["num_hourglass"])
            ll = self.conv(self.block(hg, f"image_filter.top_m_{i}"),
                           f"image_filter.conv_last{i}")
            ll = F.relu(self.gn(ll, f"image_filter.bn_end{i}"))
            out = self.conv(ll, f"image_filter.l{i}")
            outs.append(out)
            if i < n - 1:
                prev = (prev + self.conv(ll, f"image_filter.bl{i}")
                        + self.conv(out, f"image_filter.al{i}"))
        return outs, tmpx.detach()


def bicubic_matrix(n_in, n_out, a=-0.75):
    """(n_out, n_in) bicubic align-corners interpolation, edges
    replicated."""
    w = np.zeros((n_out, n_in), np.float64)
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        fl = int(np.floor(src))
        t = src - fl
        for off in (-1, 0, 1, 2):
            d = abs(off - t)
            k = ((a + 2) * d ** 3 - (a + 3) * d ** 2 + 1 if d <= 1 else
                 a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a if d < 2
                 else 0.0)
            w[i, min(max(fl + off, 0), n_in - 1)] += k
    return w.astype(np.float32)


# ------------------------------------------------------------------ heads
def project(cfg, points, crop_center):
    """Camera-space points (B, N, 3) -> crop-normalized (x, y) in [-1, 1]
    of the ``loadSize`` crop around ``crop_center`` (B, 2)."""
    size, crop = KINECT["size"], cfg["loadSize"]
    z = points[..., 2:3]
    z = torch.where(z.abs() < 1e-6,
                    torch.where(z < 0, -1e-6, 1e-6).to(z.dtype), z)
    px = KINECT["fx"] * size * points[..., 0:1] / z + KINECT["cx"] * size
    py = KINECT["fy"] * size * points[..., 1:2] / z + KINECT["cy"] * size
    px = crop / 2.0 + px - crop_center[:, None, 0:1]
    py = crop / 2.0 + py - crop_center[:, None, 1:2]
    return torch.cat([2.0 * px / crop - 1.0, 2.0 * py / crop - 1.0], -1)


def sample(feat, xy, dtype):
    """Bilinear (align-corners, zero padding) samples (B, N, C) of an NCHW
    map rounded to the encoder's precision."""
    out = F.grid_sample(feat.to(dtype).float(), xy[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[:, :, 0].transpose(1, 2)


def head(p, name, x):
    for k in range(4):
        w = p[f"{name}.{2 * k}.weight"]
        x = F.linear(x, w[..., 0], p[f"{name}.{2 * k}.bias"])
        if k < 3:
            x = F.relu(x)
    return x


def query(cfg, p, feats, tmpx, points, crop_center):
    """One head dict per stack at the points."""
    dt = encoder_dtype(cfg)
    xy = project(cfg, points, crop_center)
    z = torch.cat([points[..., 0:2], points[..., 2:3] - cfg["z_0"]], -1)
    inside = (xy.abs() <= 1.0).all(-1, keepdim=True)
    skip = sample(tmpx, xy, dt)
    out = []
    for f in feats:
        x = torch.cat([sample(f, xy, dt), z, skip], -1)
        df = head(p, "df", x)
        pca = head(p, "pca_predictor", x)
        out.append({"df": torch.where(inside, df,
                                      torch.full_like(df, cfg["out_dist"])),
                    "pca": pca.reshape(*pca.shape[:-1], 3, 3),
                    "parts": head(p, "part_predictor", x),
                    "centers": head(p, "center_predictor", x)})
    return out


def losses(cfg, preds, batch):
    """The six training terms, each weighted and averaged over the
    stacks; (total, terms)."""
    w = cfg["loss_weights"]
    clamp, leak = cfg["clamp_thres"], cfg["df_leak"]
    gt_h = batch["df_h"].clamp(max=clamp)
    gt_o = batch["df_o"].clamp(max=clamp)
    mask_o = (batch["df_o"] < 0.05).float()
    mask_h = (batch["df_h"] < 0.05).float()
    pca_gt = batch["pca"][:, None]
    labels = batch["parts"].long()
    onehot = F.one_hot(labels, cfg["num_parts"]).float()

    def clip(x):
        return torch.clamp(x, max=clamp) + leak * F.relu(x - clamp)

    def l1(r):
        return torch.where(r >= 0, r, -r)

    terms = dict.fromkeys(LOSS_NAMES, 0.0)
    for pr in preds:
        df = pr["df"]
        terms["df_h"] += w["df_h"] * l1(clip(df[..., 0]) - gt_h).sum(-1).mean()
        terms["df_o"] += w["df_o"] * l1(clip(df[..., 1]) - gt_o).sum(-1).mean()
        ce = -(F.log_softmax(pr["parts"], -1) * onehot).sum(-1)
        terms["parts"] += w["parts"] * ce.sum(-1).mean()
        terms["pca"] += w["pca"] * ((pr["pca"] - pca_gt) ** 2
                                    * mask_o[..., None, None]).mean()
        terms["obj_center"] += w["obj_center"] * (
            (pr["centers"][..., 3:] - batch["obj_center"][:, None]) ** 2
            * mask_o[..., None]).mean()
        terms["smpl_center"] += w["smpl_center"] * (
            (pr["centers"][..., :3] - batch["body_center"][:, None]) ** 2
            * mask_h[..., None]).mean()
    terms = {k: v / len(preds) for k, v in terms.items()}
    return sum(terms.values()), terms


def loss_and_grads(cfg, p, batch, rows=None, conv_round=None):
    """The batch's loss and its gradient for every parameter, computed over
    blocks of ``rows`` images (the loss is a mean over the images, so the
    blocks' losses and gradients add up weighted by their share). Returns
    (loss, {name: grad}); a parameter the loss does not reach gets none."""
    B = batch["images"].shape[0]
    rows = rows or B
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    total, grads = 0.0, {}
    for s in range(0, B, rows):
        part = {k: v[s:s + rows] for k, v in batch.items()}
        share = part["images"].shape[0] / B
        feats, tmpx = Encoder(cfg, leaves, conv_round)(part["images"])
        loss, _ = losses(cfg, query(cfg, leaves, feats, tmpx, part["points"],
                                    part["crop_center"]), part)
        names = list(leaves)
        gs = torch.autograd.grad(loss * share, [leaves[k] for k in names],
                                 allow_unused=True)
        for k, g in zip(names, gs):
            if g is not None:
                grads[k] = grads[k] + g if k in grads else g
        total += float(loss.detach()) * share
    return total, grads


class Adam:
    """Adam (Kingma & Ba) with bias correction, the moments' rates and eps
    as the configuration states them (float32-rounded rates, as the
    published training's optimizer holds them)."""

    def __init__(self, lr, b1, b2, eps):
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        self.lr, self.b1, self.b2, self.eps = lr, f32(b1), f32(b2), eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, p, grads):
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = math.sqrt(1 - self.b2 ** self.t)
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v.sqrt() / bc2).add_(self.eps)
            p[k] = p[k] - (self.lr / bc1) * m / denom
