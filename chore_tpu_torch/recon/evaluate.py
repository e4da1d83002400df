"""Reconstruction evaluation: Procrustes-aligned bidirectional Chamfer (the
counterpart of ``chore_tpu/recon/evaluate.py``).

Per frame: gate on object occlusion (visible/full mask ratio >= 0.30), load
the GT SMPL and object fits and the reconstruction, sample 10k surface
points per mesh with the native sampler (seeds 0-3), Procrustes-align the
reconstruction on the combined vertices (SMPL only when the vertex counts
differ), and compute the square-root bidirectional Chamfer of each mesh.
Aggregation: overall, per sequence and per object category mean and std,
written as a timestamped JSON.

The alignment and the Chamfer run on the evaluator's device (the card
unless ``device="cpu"``): one Procrustes solve (a 3x3 SVD) and one
``chamfer_eval_multi`` call per frame, whose four 1-NN problems (SMPL and
object, both directions) are one launch of the kernel K1. Frames of a
sequence are evaluated by a 4-thread pool, so file IO and sampling overlap
the device work. ``timer`` holds the per-frame stages: ``io_sampling``,
``procrustes`` and ``chamfer`` (under a profiler, ``chore.eval.*``
ranges).
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from os.path import basename, isfile, join

import numpy as np
import torch

from chore_tpu_torch import native, resolve_device
from chore_tpu_torch.behave.readers import FrameDataReader
from chore_tpu_torch.ops.chamfer import chamfer_eval_multi
from chore_tpu_torch.ops.procrustes import (
    apply_transform,
    similarity_transform,
)
from chore_tpu_torch.utils.meshio import load_ply
from chore_tpu_torch.utils.profiling import StepTimer


class ReconDataReader(FrameDataReader):
    """Reader for reconstruction outputs layered on FrameDataReader. Output
    convention: RECON_ROOT/SEQ/<frame>/<save_name>/k{tid}.smpl.ply and
    .object.ply."""

    def __init__(self, recon_path, seq, **kw):
        super().__init__(seq, **kw)
        self.recon_path = recon_path

    def get_recon_paths(self, idx, save_name, tid=1):
        folder = join(self.recon_path, self.seq_name,
                      self.frames[idx] if isinstance(idx, int) else idx,
                      save_name)
        return (join(folder, f"k{tid}.smpl.ply"),
                join(folder, f"k{tid}.object.ply"))

    def get_recon(self, idx, save_name, tid=1):
        smpl_f, obj_f = self.get_recon_paths(idx, save_name, tid)
        smpl = load_ply(smpl_f) if isfile(smpl_f) else None
        obj = load_ply(obj_f) if isfile(obj_f) else None
        return smpl, obj


def _aligned_chamfer(gt_smpl, gt_obj, rec_smpl, rec_obj, gt_verts, rec_verts,
                    timer=None):
    """Align the reconstruction onto the GT through the corresponding vertex
    arrays (GT fits and reconstructions share mesh topology), then the
    Chamfer of each mesh's surface samples. Tensors on one device; returns
    (err_smpl, err_obj) as 0-d tensors."""
    timer = timer or StepTimer("eval")
    with timer.phase("procrustes"):
        r, t, s = similarity_transform(rec_verts, gt_verts)
        rec_smpl_a = apply_transform(rec_smpl, r, t, s)
        rec_obj_a = apply_transform(rec_obj, r, t, s)
        if rec_smpl_a.is_cuda:
            torch.cuda.synchronize(rec_smpl_a.device)
    with timer.phase("chamfer"):
        err_smpl, err_obj = chamfer_eval_multi(
            [(gt_smpl, rec_smpl_a), (gt_obj, rec_obj_a)])
        if err_smpl.is_cuda:
            torch.cuda.synchronize(err_smpl.device)
    return err_smpl, err_obj


class ReconEvaluator:
    def __init__(self, recon_path, behave_path, sample_num=10000,
                 outdir="results", smpl_only=False, occ_ratio=0.30,
                 device=None):
        self.recon_path = recon_path
        self.behave_path = behave_path
        self.sample_num = sample_num
        self.outdir = outdir
        self.smpl_only = smpl_only
        self.occ_ratio = occ_ratio
        self.device = resolve_device(device)
        self.errors_dict = {}
        self.timer = StepTimer("eval")  # per-frame stages, see the module doc

    # ------------------------------------------------------------------ #
    def _sample(self, mesh, seed):
        v, f = mesh
        if f is None or len(f) == 0:
            idx = np.random.RandomState(seed).choice(len(v), self.sample_num)
            return v[idx]
        return native.sample_surface(v, f, self.sample_num, seed=seed)

    def eval_frame(self, reader: ReconDataReader, i, save_name, tid):
        with self.timer.phase("io_sampling"):
            obj_mask = reader.get_mask(i, tid, "obj")
            mask_full = reader.get_mask_full(i, tid)
            if obj_mask is None or mask_full is None or mask_full.sum() == 0:
                return None
            if obj_mask.sum() / mask_full.sum() < self.occ_ratio:
                return None
            smpl_fit = reader.get_smplfit(i, "fit02")
            obj_fit = reader.get_objfit(i, "fit01")
            rec_smpl, rec_obj = reader.get_recon(i, save_name, tid)
            if any(m is None for m in (smpl_fit, obj_fit, rec_smpl,
                                       rec_obj)):
                return None
            gs, go = self._sample(smpl_fit, 0), self._sample(obj_fit, 1)
            rs, ro = self._sample(rec_smpl, 2), self._sample(rec_obj, 3)
            same_counts = (smpl_fit[0].shape == rec_smpl[0].shape
                           and obj_fit[0].shape == rec_obj[0].shape)
            if same_counts and not self.smpl_only:
                # combined SMPL + object vertex alignment
                gt_verts = np.concatenate([smpl_fit[0], obj_fit[0]], 0)
                rec_verts = np.concatenate([rec_smpl[0], rec_obj[0]], 0)
            else:
                # SMPL-only fallback (vertex counts differ)
                gt_verts, rec_verts = smpl_fit[0], rec_smpl[0]
            dev = lambda a: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a, np.float32)).to(self.device)
            args = [dev(a) for a in (gs, go, rs, ro, gt_verts, rec_verts)]
        err_s, err_o = _aligned_chamfer(*args, timer=self.timer)
        return float(err_s), float(err_o)

    def _seq_errors(self, seq, save_name, tid=1):
        """All gated frame errors of one sequence (list of (smpl, obj))."""
        reader = ReconDataReader(self.recon_path, seq, check_image=False)
        errors = []
        with ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(self.eval_frame, reader, i, save_name, tid)
                    for i in range(len(reader))]
            for f in futs:
                r = f.result()
                if r is not None:
                    errors.append(r)
        print(f"{seq} done: {len(errors)} frames")
        return errors

    def eval_seq(self, seq, save_name, tid=1):
        errors = self._seq_errors(seq, save_name, tid)
        if errors:
            self.errors_dict[basename(seq.rstrip("/"))] = np.asarray(errors)

    def eval_seqs(self, seqs, save_name, tid=1, seq_workers=1):
        """Evaluate sequences; ``seq_workers`` > 1 overlaps the IO of several
        sequences in threads."""
        self.errors_dict = {}  # fresh per run; repeated calls must not mix
        if seq_workers <= 1:
            for seq in seqs:
                self.eval_seq(seq, save_name, tid)
        else:
            with ThreadPoolExecutor(seq_workers) as pool:
                futs = [(seq, pool.submit(self._seq_errors, seq, save_name,
                                          tid)) for seq in seqs]
                for seq, fut in futs:
                    errors = fut.result()
                    if errors:
                        self.errors_dict[basename(seq.rstrip("/"))] = (
                            np.asarray(errors))
        return self.collect_results(save_name, tid)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _extract_objname(seq_name):
        parts = seq_name.split("_")
        return parts[2] if len(parts) > 2 else seq_name

    @staticmethod
    def _format(errors):
        return {
            "smpl": {"mean": float(np.mean(errors[:, 0])),
                     "std": float(np.std(errors[:, 0]))},
            "obj": {"mean": float(np.mean(errors[:, 1])),
                    "std": float(np.std(errors[:, 1]))},
            "total": int(len(errors)),
        }

    def collect_results(self, save_name, tid):
        """Aggregate and write the timestamped JSON (the reference's
        layout)."""
        if not self.errors_dict:
            return None
        all_errors = np.concatenate(list(self.errors_dict.values()), 0)
        per_seq = {s: self._format(e) for s, e in self.errors_dict.items()}
        per_obj = {}
        for s, e in self.errors_dict.items():
            name = self._extract_objname(s)
            per_obj.setdefault(name, []).append(e)
        result = self._format(all_errors)
        result["separate"] = per_seq
        result["save_name"] = save_name
        ts = datetime.now().isoformat().replace(":", "-")
        result["time"] = ts
        for name, errs in sorted(per_obj.items()):
            result[name] = self._format(np.concatenate(errs, 0))
        os.makedirs(self.outdir, exist_ok=True)
        outfile = join(self.outdir, f"{save_name}_k{tid}_{ts}.json")
        with open(outfile, "w") as f:
            json.dump(result, f, indent=2)
        print(f"evaluation saved to {outfile}")
        return result
