"""BEHAVE preprocessing: depth-normalise the GT fits and boundary-sample
them (the counterpart of ``chore_tpu/preprocess/preprocess_scale.py``).

Per frame and kinect: move the GT SMPL and object fits into the kinect's
colour frame, rescale the scene by z_0 / z(pelvis) so the SMPL centre sits
at the fixed depth (scales outside [0.6, 1.5] are skipped), run boundary
sampling, and write ``{frame}_k{kid}_{data_name}.npz`` (``_flip`` for the
mirrored variant) with the JAX package's keys and layout, so its training
reader reads the port's files.
"""
from __future__ import annotations

import os
from os.path import isfile, join

import numpy as np

from chore_tpu_torch.behave.readers import FrameDataReader, KinectTransform
from chore_tpu_torch.preprocess.boundary_sampler import BoundarySampler
from chore_tpu_torch.smpl.assets import load_landmark_regressors
from chore_tpu_torch.smpl.const import BODY25_PELVIS

SCALE_MIN, SCALE_MAX = 0.6, 1.5


def process_scale_frame(reader: FrameDataReader, kin_transform, sampler,
                        idx, kid, outdir, data_name="scale",
                        smpl_name="fit02", obj_name="fit01",
                        sigmas=(0.08, 0.02, 0.003),
                        ratios=(0.01, 0.49, 0.5), sample_num=100000,
                        grid_ratio=0.01, smpl_depth=2.2, flip=False,
                        redo=False, assets_dir=None):
    """Process one (frame, kinect) pair; returns the npz path or None."""
    smpl_fit = reader.get_smplfit(idx, smpl_name)
    obj_fit = reader.get_objfit(idx, obj_name)
    if smpl_fit is None or obj_fit is None:
        return None
    frame = reader.frames[idx]
    outfolder = join(outdir, reader.seq_name, frame)
    os.makedirs(outfolder, exist_ok=True)
    suffix = "_flip" if flip else ""
    outfile = join(outfolder, f"{frame}_k{kid}_{data_name}{suffix}.npz")
    if isfile(outfile) and not redo:
        return outfile

    smpl_v, smpl_f = smpl_fit
    obj_v, obj_f = obj_fit
    smpl_v = kin_transform.world2local(smpl_v, kid)
    obj_v = kin_transform.world2local(obj_v, kid)
    if flip:
        smpl_v = KinectTransform.flip_verts(smpl_v)
        obj_v = KinectTransform.flip_verts(obj_v)

    # depth-aware scaling
    body25 = load_landmark_regressors(assets_dir)["body25"]
    center = body25 @ smpl_v
    scale = smpl_depth / center[BODY25_PELVIS, 2]
    if scale < SCALE_MIN or scale > SCALE_MAX:
        print(f"warning: scale {scale:.3f} out of range, skipped {outfile}")
        return None
    smpl_v = smpl_v * scale
    obj_v = obj_v * scale

    data = sampler.boundary_sample_all(
        smpl_v.astype(np.float32), smpl_f, obj_v.astype(np.float32), obj_f,
        sigmas, ratios, sample_num, grid_ratio=grid_ratio, flip=flip)
    if not abs(data["smpl_center"][2] - smpl_depth) < 1e-4:
        raise RuntimeError(f"SMPL centre at z={data['smpl_center'][2]} "
                           f"after scaling to {smpl_depth}")
    data["image_file"] = reader.get_color_files(idx, [kid])[0]
    data["sigmas"] = np.asarray(sigmas)
    np.savez(outfile, **data)
    return outfile


def process_scale_seq(seq_folder, outdir, kids=None, start=0, end=None,
                      interval=1, backend="auto", device=None, **kw):
    """All frames of a sequence. kids=None uses the sequence's own kinect
    ids; backend and device go to the ``BoundarySampler``."""
    reader = FrameDataReader(seq_folder)
    kin = KinectTransform(seq_folder)
    sampler = BoundarySampler(backend=backend, device=device)
    end = reader.cvt_end(end)
    seq_kids = reader.seq_info.kids
    kids = seq_kids if kids is None else [k for k in kids if k in seq_kids]
    out = []
    for idx in range(start, end, interval):
        for kid in kids:
            f = process_scale_frame(reader, kin, sampler, idx, kid, outdir,
                                    **kw)
            if f:
                out.append(f)
    return out
