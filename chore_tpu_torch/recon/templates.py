"""Object template registry and reconstruction output saving.

Counterpart of ``chore_tpu/recon/templates.py``: the 20 BEHAVE object
categories -> simplified template ply, centred loading, and the per-frame
output layout RECON/SEQ/<frame>/<save_name>/k{tid}.smpl.ply + .object.ply
with their parameter pickles (the same files and pickle keys).
"""
from __future__ import annotations

import os
import pickle
from os.path import join

import numpy as np

from chore_tpu_torch.utils.meshio import load_ply, save_ply

# simplified registration templates per category
MESH_TEMPLATES = {
    "backpack": "backpack/backpack_f1000.ply",
    "basketball": "basketball/basketball_f1000.ply",
    "boxlarge": "boxlarge/boxlarge_f1000.ply",
    "boxtiny": "boxtiny/boxtiny_f1000.ply",
    "boxlong": "boxlong/boxlong_f1000.ply",
    "boxsmall": "boxsmall/boxsmall_f1000.ply",
    "boxmedium": "boxmedium/boxmedium_f1000.ply",
    "chairblack": "chairblack/chairblack_f2500.ply",
    "chairwood": "chairwood/chairwood_f2500.ply",
    "monitor": "monitor/monitor_closed_f1000.ply",
    "keyboard": "keyboard/keyboard_f1000.ply",
    "plasticcontainer": "plasticcontainer/plasticcontainer_f1000.ply",
    "stool": "stool/stool_f1000.ply",
    "tablesquare": "tablesquare/tablesquare_f2000.ply",
    "toolbox": "toolbox/toolbox_f1000.ply",
    "suitcase": "suitcase/suitcase_f1000.ply",
    "tablesmall": "tablesmall/tablesmall_f1000.ply",
    "yogamat": "yogamat/yogamat_f1000.ply",
    "yogaball": "yogaball/yogaball_f1000.ply",
    "trashbin": "trashbin/trashbin_f1000.ply",
}


def get_template_path(objects_path, obj_name):
    return join(objects_path, MESH_TEMPLATES[obj_name])


def load_template(objects_path, obj_name, center=True):
    """-> (verts, faces), centred around the origin."""
    verts, faces = load_ply(get_template_path(objects_path, obj_name))
    if center:
        verts = verts - verts.mean(0)
    return verts, faces


def output_paths(outpath, image_paths, save_name, tid):
    """Per-frame output files. Pure path computation -- directories are
    created by save_outputs, so the is_done resume check has no side
    effect."""
    smpl_files, obj_files = [], []
    for p in image_paths:
        parts = str(p).split(os.sep)
        seq, frame = parts[-3], parts[-2]
        folder = join(outpath, seq, frame, save_name)
        smpl_files.append(join(folder, f"k{tid}.smpl.ply"))
        obj_files.append(join(folder, f"k{tid}.object.ply"))
    return smpl_files, obj_files


def save_outputs(outpath, image_paths, save_name, tid, smpl_verts,
                 smpl_faces, smpl_pose, smpl_betas, smpl_trans,
                 obj_verts, obj_faces, obj_rot, obj_trans, obj_scale):
    """Write the SMPL mesh + params and the posed object mesh + params of
    every frame of ``image_paths`` (numpy inputs, batch first)."""
    smpl_files, obj_files = output_paths(outpath, image_paths, save_name, tid)
    B = len(smpl_files)
    for i in range(B):
        os.makedirs(os.path.dirname(smpl_files[i]), exist_ok=True)
        save_ply(smpl_files[i], np.asarray(smpl_verts[i]), smpl_faces)
        with open(smpl_files[i].replace(".ply", ".pkl"), "wb") as f:
            pickle.dump({
                "pose": np.asarray(smpl_pose[i]),
                "betas": np.asarray(smpl_betas[i]),
                "trans": np.asarray(smpl_trans[i]),
                "score": 0.0,
            }, f)
        save_ply(obj_files[i], np.asarray(obj_verts[i]), obj_faces)
        with open(obj_files[i].replace(".ply", ".pkl"), "wb") as f:
            pickle.dump({
                "rot": np.asarray(obj_rot[i]),
                "trans": np.asarray(obj_trans[i]),
                "scale": np.asarray(obj_scale[i]),
            }, f)
    return smpl_files, obj_files


def is_done(outpath, image_paths, save_name, tid):
    """Every output file of the frames exists (resume check)."""
    smpl_files, obj_files = output_paths(outpath, image_paths, save_name, tid)
    return all(os.path.isfile(f) for f in smpl_files + obj_files)
