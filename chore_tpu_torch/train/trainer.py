"""Data-parallel trainer of the CHORE field.

Counterpart of ``chore_tpu/train/trainer.py``:
  * optax's Adam (or Adadelta, RMSprop) at lr 1e-3 with the MultiStep
    schedule [15, 25] x 0.3, set per epoch (``train/optim.py``),
  * one ``train_step`` per batch; with several processes the field is
    wrapped in ``DistributedDataParallel``, whose gradient all-reduce is
    the collective ``chore_tpu``'s sharded jit inserts,
  * periodic wall-clock validation and checkpointing with the best-val
    pointer, written by rank 0 in ``chore_tpu``'s checkpoint format,
  * scalar metrics to JSONL (and TensorBoard where it imports).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from chore_tpu_torch.data.loader import prefetch_to_device
from chore_tpu_torch.models.chore import chore_losses
from chore_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
    trained_names,
)
from chore_tpu_torch.parallel import (
    all_mean,
    is_main_process,
    local_batch_slice,
    process_count,
    shard_batch,
    sync_decision,
)
from chore_tpu_torch.train import checkpoints as ckpt
from chore_tpu_torch.train import optim
from chore_tpu_torch.train.torch_import import (
    adam_state_by_name,
    load_torch_checkpoint,
)
from chore_tpu_torch.utils.profiling import StepTimer, trace

LOSS_NAMES = ("df_h", "df_o", "parts", "pca", "smpl_center", "obj_center")


def multistep_lr(base_lr, milestones=(15, 25), gamma=0.3):
    """Per-epoch LR (MultiStepLR semantics)."""

    def lr_for_epoch(epoch):
        factor = 1.0
        for m in milestones:
            if epoch >= m:
                factor *= gamma
        return base_lr * factor

    return lr_for_epoch


class MetricsLogger:
    """JSONL scalar log (EXP/metrics.jsonl), and TensorBoard events when
    ``torch.utils.tensorboard`` imports."""

    def __init__(self, exp_dir, enabled=True):
        self.enabled = enabled
        self.path = os.path.join(exp_dir, "metrics.jsonl")
        self.tb = None
        if enabled:
            os.makedirs(exp_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(exp_dir, "tb"))
            except Exception:  # noqa: BLE001 - TensorBoard is optional
                self.tb = None

    def log(self, step, **scalars):
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v
                                                 in scalars.items()}})
                    + "\n")
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)


class Trainer:
    """Epoch loop over ``train_step``.

    Args:
      model: a trainable CHOREField on its device
        (``build_field(..., trainable=True)``); with several processes
        (``parallel.init_distributed``) each holds a replica.
      exp_dir: experiment directory (checkpoints/, val_min pointer,
        metrics).
      ck_period_min: wall-clock minutes between validation + checkpoint.
      profile_dir: write a ``torch.profiler`` trace of steps
        2..2+profile_steps there.

    ``timer`` times each step's phases (``forward``, ``loss``,
    ``backward``, ``optimizer``) and, with several processes, the
    ``DistributedDataParallel`` construction (``ddp_init``); under a
    profiler each is the range ``chore.train.<phase>``.
    """

    def __init__(self, model, exp_dir, base_lr=1e-3, milestones=(15, 25),
                 gamma=0.3, optimizer="adam", ck_period_min=60.0,
                 profile_dir=None, profile_steps=20):
        self.model = model
        self.cfg = model.cfg
        self.device = next(model.parameters()).device
        self.exp_dir = exp_dir
        self.lr_fn = multistep_lr(base_lr, milestones, gamma)
        self.ck_period = ck_period_min * 60.0
        self.optimizer_name = optimizer
        self.named_params = [(n, p) for n, p in model.named_parameters()
                             if p.requires_grad]
        if not self.named_params:
            raise ValueError("the model has no trainable parameters; build "
                             "it with build_field(..., trainable=True)")
        self.opt = optim.make_optimizer(
            optimizer, [p for _, p in self.named_params], base_lr)
        if self.device.type == "cuda":
            # cuDNN picks each convolution's algorithm by timing them on the
            # first use of a shape (a training step's shapes repeat); its
            # heuristic choice for float32 without TF32 is ~6x slower at the
            # release shape. The flag is the process's: convolutions run
            # later in it (a fit) time theirs too.
            torch.backends.cudnn.benchmark = True
        self.timer = StepTimer("train")
        self.net = model
        if process_count() > 1:
            # creates the communicators and broadcasts the parameters
            with self.timer.phase("ddp_init"):
                self.net = torch.nn.parallel.DistributedDataParallel(
                    model, device_ids=([self.device.index]
                                       if self.device.type == "cuda"
                                       else None))
        self.epoch = 0
        self.training_time = 0.0
        self.global_step = 0
        self.logger = MetricsLogger(exp_dir, enabled=is_main_process())
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps

    def set_epoch_lr(self, epoch):
        lr = self.lr_fn(epoch)
        optim.set_lr(self.opt, lr)
        return lr

    def train_step(self, batch):
        """One optimizer step on this process's shard of the global batch
        (numpy or tensors). Returns (loss, parts) as device scalars,
        averaged over the processes (the global batch's loss)."""
        timer = self.timer
        with timer.phase("forward"):
            batch = shard_batch(batch, self.device)
            preds = self.net(batch["images"], batch["points"],
                             batch["crop_center"])
        with timer.phase("loss"):
            loss, parts = chore_losses(preds, batch, self.cfg)
            # autograd keeps what the backward pass needs; the rest of the
            # predictions are freed here, not held through it
            del preds
        with timer.phase("backward"):
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        with timer.phase("optimizer"):
            self.opt.step()
            self.global_step += 1
            stats = all_mean(torch.stack(
                [loss.detach()] + [parts[k].detach() for k in LOSS_NAMES]))
        return stats[0], dict(zip(LOSS_NAMES, stats[1:]))

    @torch.no_grad()
    def compute_val_loss(self, val_batches):
        """The mean loss over host batches. Runs on EVERY process (each
        evaluates its slice of every batch, then the ranks average), as
        ``chore_tpu``'s evaluation over the mesh does. A batch whose size
        the process count does not divide is wrap-padded (cyclic
        repetition, exact when the real size divides the padded one); the
        average weights each batch by its real size."""
        n_dev = process_count()
        losses, weights = [], []
        for batch in val_batches:
            batch = {k: np.asarray(v) for k, v in batch.items()}
            n_real = next(iter(batch.values())).shape[0]
            pad = (-n_real) % n_dev
            if pad:
                batch = {k: np.concatenate(
                    [v, v[np.arange(pad) % n_real]], axis=0)
                    for k, v in batch.items()}
            part = local_batch_slice(n_real + pad)
            local = shard_batch({k: v[part] for k, v in batch.items()},
                                self.device)
            loss, _ = chore_losses(
                self.model(local["images"], local["points"],
                           local["crop_center"]), local, self.cfg)
            losses.append(float(all_mean(loss)))
            weights.append(n_real)
        if not losses:
            return float("inf")
        return float(np.average(losses, weights=weights))

    def state(self):
        """{params, opt_state} in ``chore_tpu``'s checkpoint layout."""
        return {"params": params_to_jax(self.model.state_dict()),
                "opt_state": optim.optax_state(
                    self.opt, self.optimizer_name, self.named_params)}

    def save(self):
        if not is_main_process():
            return None
        return ckpt.save_checkpoint(
            os.path.join(self.exp_dir, "checkpoints"), self.state(),
            self.training_time, self.epoch, global_step=self.global_step)

    def load(self, resume="latest"):
        """Resume from a checkpoint (this package's or ``chore_tpu``'s); the
        LR comes from the schedule, not from the checkpoint.
        resume='latest': the newest checkpoint by training time;
        'best': the val_min pointer's when there is one, else the newest."""
        if resume not in ("latest", "best"):
            raise ValueError(f"resume must be 'latest' or 'best': {resume!r}")
        path = ckpt.find_checkpoint(
            self.exp_dir, prefer="val_min" if resume == "best" else "latest")
        if path is None:
            return False
        (state, self.epoch, self.training_time,
         self.global_step) = ckpt.load_checkpoint(path)
        self.model.load_state_dict(params_from_jax(state["params"]))
        optim.load_optax_state(self.opt, self.optimizer_name,
                               self.named_params, state["opt_state"])
        return True

    def import_torch(self, path):
        """Continue training from a reference torch ``.tar`` checkpoint:
        weights, the Adam moments (by parameter name, zeros where a
        parameter has none), epoch and training time; global_step is the
        Adam step count. The LR comes from the schedule. Returns the
        checkpoint's keys that are no parameter of ``chore_tpu``'s field."""
        data = load_torch_checkpoint(path)
        sd = data["model_state_dict"]
        trained = trained_names(sd)
        own = self.model.state_dict()
        missing = [k for k in trained_names(own) if k not in sd]
        if missing:
            raise KeyError(f"torch checkpoint missing {missing[0]}")
        self.model.load_state_dict({k: sd.get(k, v) for k, v in own.items()})
        count = 0
        if "optimizer_state_dict" in data:
            if self.optimizer_name != "adam":
                raise ValueError(
                    "optimizer-state import is only defined for Adam "
                    f"(trainer built with {self.optimizer_name!r})")
            by_name, count, no_state = adam_state_by_name(data)
            for n, p in self.named_params:
                mu, nu = by_name[n] or (torch.zeros_like(p),
                                        torch.zeros_like(p))
                self.opt.state[p] = {"step": torch.tensor(float(count)),
                                     "exp_avg": mu.to(p.device, p.dtype),
                                     "exp_avg_sq": nu.to(p.device, p.dtype)}
            if no_state and is_main_process():
                print(f"torch Adam state missing for {len(no_state)} params "
                      f"(never stepped); zero-initialized: {no_state[:3]}...")
        self.epoch = int(data.get("epoch", 0))
        self.training_time = float(data.get("training_time", 0.0))
        self.global_step = int(count)
        return [k for k in sd if k not in set(trained)]

    def train_model(self, train_batches_fn, num_epochs, val_batches_fn=None,
                    resume="latest"):
        """train_batches_fn(epoch) -> iterable of host batches (this
        process's shards); val_batches_fn() -> iterable of host batches.
        resume: checkpoint selection on restart, see ``load``."""
        self.load(resume=resume)
        last_ck = time.time()
        self._seg_start = time.time()
        tracer = None
        try:
            while self.epoch < num_epochs:
                lr = self.set_epoch_lr(self.epoch)
                epoch_losses = []
                # the next batches are copied to the device while this
                # step runs
                for batch in prefetch_to_device(
                        iter(train_batches_fn(self.epoch)),
                        device=self.device):
                    # a trace of steps 2..2+profile_steps (after warm-up)
                    if (self.profile_dir and tracer is None
                            and self.global_step == 2 and is_main_process()):
                        tracer = trace(self.profile_dir)
                        tracer.__enter__()
                    loss, parts = self.train_step(batch)
                    if (tracer is not None and
                            self.global_step >= 2 + self.profile_steps):
                        tracer.__exit__(None, None, None)
                        tracer, self.profile_dir = None, None
                    # kept on the device: a readback per step would make
                    # the host wait for every step
                    epoch_losses.append(loss)
                    if self.global_step % 50 == 0:
                        self.logger.log(
                            self.global_step, loss=float(loss), lr=lr,
                            **{k: float(v) for k, v in parts.items()})
                        # every rank must agree: validation runs
                        # collectives
                        if sync_decision(time.time() - last_ck
                                         > self.ck_period):
                            self._validate_and_save(val_batches_fn)
                            last_ck = time.time()
                self.epoch += 1
                # one readback for the whole epoch
                self.logger.log(
                    self.global_step, epoch=self.epoch,
                    epoch_loss=(float(torch.stack(epoch_losses).mean())
                                if epoch_losses else 0.0))
        finally:
            if tracer is not None:
                tracer.__exit__(None, None, None)
        self._validate_and_save(val_batches_fn)

    def _validate_and_save(self, val_batches_fn):
        now = time.time()
        self.training_time += now - self._seg_start
        self._seg_start = now
        name = self.save()
        if val_batches_fn is not None:
            # every process takes part; rank 0 logs and moves the pointer
            val_loss = self.compute_val_loss(val_batches_fn())
            if is_main_process() and name is not None:
                self.logger.log(self.global_step, val_loss=val_loss)
                ckpt.update_val_min(self.exp_dir, self.epoch, val_loss, name)
