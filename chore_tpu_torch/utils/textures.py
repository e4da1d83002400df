"""Textured OBJ IO, texture sampling, and lighting.

Counterpart of ``chore_tpu/utils/textures.py``:

  * ``load_obj_textured``   -- parse OBJ + MTL, load the texture atlas (as
                               ``cv2.imread`` reads it, BGR to RGB).
  * ``sample_face_textures`` -- atlas + per-face UVs -> per-face (ts, ts, 3)
                               texture patches by bilinear, border-clamped
                               lookups (``ops.grid_sample``).
  * ``atlas_from_face_textures`` -- the inverse packing of per-face patches
                               into one atlas image + UVs.
  * ``save_obj_textured``   -- OBJ + MTL + PNG export.
  * ``lighting``            -- ambient + directional per-face intensities.
  * ``render_textured``     -- hard z-buffer render with a per-pixel
                               texture lookup (``ops.rasterizer``).

UV convention: OBJ ``vt`` origin is bottom-left; image row 0 is top-left.
Both loaders and savers apply v_img = 1 - vt_v, so round trips are exact.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from chore_tpu_torch import resolve_device
from chore_tpu_torch.data.imageio import imwrite, read_bgr_or_none
from chore_tpu_torch.ops.grid_sample import bilinear_sample


# --------------------------------------------------------------------- #
# OBJ / MTL IO (host)
def _parse_mtl(path):
    """Material name -> texture image filename (map_Kd)."""
    out = {}
    cur = None
    if not os.path.isfile(path):
        return out
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "newmtl":
                cur = t[1]
            elif t[0] == "map_Kd" and cur is not None:
                out[cur] = t[-1]
    return out


def load_obj_textured(path):
    """Parse an OBJ with UVs and its MTL texture.

    Returns dict: verts (V, 3) f32, faces (F, 3) i32, uv_faces (F, 3, 2) f32
    in image coords (u right, v DOWN -- ready for sampling), texture
    (H, W, 3) f32 in [0, 1] or None when the OBJ has no material or its
    image is missing or unreadable. Polygons are fan-triangulated.
    """
    verts, vts, faces, uv_idx = [], [], [], []
    mtl_file, tex_name = None, None
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                vts.append([float(t[1]), float(t[2])])
            elif t[0] == "mtllib":
                mtl_file = t[1]
            elif t[0] == "usemtl":
                tex_name = t[1]
            elif t[0] == "f":
                idx = [p.split("/") for p in t[1:]]
                for k in range(1, len(idx) - 1):
                    tri = [idx[0], idx[k], idx[k + 1]]
                    faces.append([int(p[0]) - 1 for p in tri])
                    if all(len(p) > 1 and p[1] for p in tri):
                        uv_idx.append([int(p[1]) - 1 for p in tri])
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    texture, uv_faces = None, None
    if vts and len(uv_idx) == len(faces):
        vts = np.asarray(vts, np.float32)
        uv = vts[np.asarray(uv_idx, np.int32)]  # (F, 3, 2) in OBJ coords
        uv_faces = np.stack([uv[..., 0], 1.0 - uv[..., 1]], -1)  # v down
        if mtl_file and tex_name:
            mats = _parse_mtl(os.path.join(os.path.dirname(path), mtl_file))
            img_file = mats.get(tex_name)
            if img_file:
                img = read_bgr_or_none(os.path.join(os.path.dirname(path),
                                                    img_file))
                if img is not None:
                    texture = img[..., ::-1].astype(np.float32) / 255.0
    return {"verts": verts, "faces": faces, "uv_faces": uv_faces,
            "texture": texture}


def save_obj_textured(path, verts, faces, uv_faces=None, texture=None):
    """Write OBJ (+MTL +png when textured); inverse of load_obj_textured
    (the atlas is taken as-is; use atlas_from_face_textures first when
    starting from per-face patches)."""
    base = os.path.splitext(path)[0]
    name = os.path.basename(base)
    lines = []
    if texture is not None:
        imwrite(f"{base}.png",
                (np.clip(texture, 0, 1)[..., ::-1] * 255).astype(np.uint8))
        with open(f"{base}.mtl", "w") as f:
            f.write(f"newmtl material_1\nmap_Kd {name}.png\n")
        lines.append(f"mtllib {name}.mtl")
    for v in np.asarray(verts):
        lines.append(f"v {v[0]} {v[1]} {v[2]}")
    faces = np.asarray(faces)
    if uv_faces is not None:
        uv = np.asarray(uv_faces).reshape(-1, 2)  # (F*3, 2) image coords
        for u in uv:
            lines.append(f"vt {u[0]} {1.0 - u[1]}")  # back to OBJ coords
        if texture is not None:
            lines.append("usemtl material_1")
        for i, f3 in enumerate(faces):
            t = [f"{f3[k] + 1}/{3 * i + k + 1}" for k in range(3)]
            lines.append("f " + " ".join(t))
    else:
        for f3 in faces:
            lines.append(f"f {f3[0] + 1} {f3[1] + 1} {f3[2] + 1}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# --------------------------------------------------------------------- #
# per-face texture patches <-> atlas
def _lattice(ts):
    """(ts, ts) barycentric lattice over a UV triangle: b1 right, b2 down,
    clamped to the triangle (the upper-right half folds onto the
    diagonal)."""
    i, j = np.meshgrid(np.arange(ts), np.arange(ts), indexing="ij")
    b1 = j / max(ts - 1, 1)
    b2 = i / max(ts - 1, 1)
    s = np.maximum(b1 + b2, 1.0)
    return (b1 / s).astype(np.float32), (b2 / s).astype(np.float32)


def _atlas_lookup(texture, p):
    """Bilinear, border-clamped lookup of a (H, W, 3) atlas at (N, 2) image
    coords in [0, 1] (v down) -> (N, 3) tensor, on the atlas' device."""
    H, W = texture.shape[:2]
    px = torch.clamp(p[:, 0] * W - 0.5, 0, W - 1)
    py = torch.clamp(p[:, 1] * H - 0.5, 0, H - 1)
    # max(., 1): a 1-pixel-wide/tall texture would divide by zero (the
    # clamp above already pins the coordinate there)
    g = torch.stack([2.0 * px / max(W - 1, 1) - 1.0,
                     2.0 * py / max(H - 1, 1) - 1.0], -1)
    return bilinear_sample(texture[None], g[None])[0]


def sample_face_textures(texture, uv_faces, texture_size=8, device=None):
    """Atlas -> per-face texture patches.

    Args:
      texture: (H, W, 3) atlas in [0, 1].
      uv_faces: (F, 3, 2) per-face UVs in image coords ([0,1], v down).
      texture_size: patch resolution ts.
      device: where the lookups run (the card unless "cpu").

    Returns (F, ts, ts, 3) tensor; entry (i, j) holds the colour at
    barycentric (1-b1-b2, b1, b2) with b1 = j/(ts-1), b2 = i/(ts-1).
    """
    device = resolve_device(device)
    texture = torch.as_tensor(np.asarray(texture, np.float32), device=device)
    uv = torch.as_tensor(np.asarray(uv_faces, np.float32), device=device)
    b1, b2 = (torch.as_tensor(b.reshape(-1), device=device)
              for b in _lattice(texture_size))
    p = (uv[:, None, 0]
         + b1[None, :, None] * (uv[:, None, 1] - uv[:, None, 0])
         + b2[None, :, None] * (uv[:, None, 2] - uv[:, None, 0]))
    F = uv.shape[0]
    out = _atlas_lookup(texture, p.reshape(-1, 2))
    return out.reshape(F, texture_size, texture_size, 3)


def atlas_from_face_textures(face_tex):
    """Per-face patches -> one atlas image + UVs (row-major tile packing).

    Args:
      face_tex: (F, ts, ts, 3) patches (lattice layout of
        sample_face_textures).

    Returns (atlas (R*ts, C*ts, 3) numpy, uv_faces (F, 3, 2) image coords)
    such that ``sample_face_textures(atlas, uv_faces, ts)`` reproduces
    ``face_tex`` on the triangle lattice.
    """
    face_tex = np.asarray(face_tex)
    F, ts = face_tex.shape[0], face_tex.shape[1]
    cols = int(np.ceil(np.sqrt(F)))
    rows = int(np.ceil(F / cols))
    atlas = np.zeros((rows * ts, cols * ts, 3), np.float32)
    uv = np.zeros((F, 3, 2), np.float32)
    H, W = atlas.shape[:2]
    for f in range(F):
        r, c = divmod(f, cols)
        atlas[r * ts:(r + 1) * ts, c * ts:(c + 1) * ts] = face_tex[f]
        # pixel centres of the patch corners: v0 top-left, v1 top-right
        # (b1=1), v2 bottom-left (b2=1) -- matching the lattice layout
        x0, y0 = c * ts + 0.5, r * ts + 0.5
        uv[f] = [
            [x0 / W, y0 / H],
            [(x0 + ts - 1) / W, y0 / H],
            [x0 / W, (y0 + ts - 1) / H],
        ]
    return atlas, uv


# --------------------------------------------------------------------- #
# lighting + textured rendering
def sample_uv_colors(texture, uv):
    """Bilinear, border-clamped atlas lookup at (..., 2) UV image coords
    ([0,1], v down), on the host. Returns (..., 3) colours as numpy."""
    shape = np.shape(uv)[:-1]
    p = torch.from_numpy(np.asarray(uv, np.float32).reshape(-1, 2))
    out = _atlas_lookup(torch.from_numpy(np.asarray(texture, np.float32)), p)
    return out.numpy().reshape(*shape, 3)


def face_normals(verts, faces):
    v = np.asarray(verts)
    f = np.asarray(faces)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    return n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-12)


def lighting(normals, light_dir=(0.0, 1.0, 0.0), ambient=0.5,
             directional=0.5, two_sided=True):
    """Per-face light intensity: ambient + directional * <n, l>_+.
    two_sided uses |<n, l>| (the meshes are not consistently wound)."""
    l = np.asarray(light_dir, np.float32)
    l = l / (np.linalg.norm(l) + 1e-12)
    cos = np.asarray(normals) @ l
    cos = np.abs(cos) if two_sided else np.maximum(cos, 0.0)
    return ambient + directional * cos


def render_textured(verts, faces, uv_faces, texture, K, image_size=512,
                    light_dir=(0.3, -0.5, -0.8), ambient=0.4,
                    directional=0.6, background=None, device=None):
    """Z-buffered textured render under unit-coord intrinsics K.

    Per pixel: face index + barycentric from the rasterizer (on
    ``device``, the card unless "cpu"), UV by barycentric interpolation,
    colour by bilinear atlas lookup, modulated by the per-face lighting
    intensity.

    Returns (image (S, S, 3) float [0, 1], mask (S, S) bool).
    """
    from chore_tpu_torch.utils.render import rasterize_unit_k

    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    fi, bary = rasterize_unit_k(verts, faces, K, image_size, device)
    mask = fi >= 0
    safe = np.clip(fi, 0, len(faces) - 1)
    uv_pix = np.einsum("hwk,hwkc->hwc", bary, np.asarray(uv_faces)[safe])
    colors = sample_uv_colors(texture, uv_pix)
    shade = lighting(face_normals(verts, faces), light_dir, ambient,
                     directional)
    img = (np.zeros((image_size, image_size, 3), np.float32)
           if background is None else background.copy())
    img[mask] = (colors * shade[safe][..., None])[mask]
    return img, mask
