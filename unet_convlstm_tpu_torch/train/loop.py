"""The epoch loop (counterpart of unet_convlstm_tpu/train/loop.py).

dataset → deterministic train/val split → model init (type-dispatched) →
clip + AdamW (frozen-encoder mask) → per epoch: train steps on batches
prefetched to the card, eval with padded tail batches, denormalized
MAE/RMSE/ME lines → ReduceLROnPlateau on the val loss → the best-val
checkpoint, an optional periodic ``_last`` checkpoint and the final one.

* The step runs the hand-written kernels on the card (K1 forward and
  backward, K2) whatever ``use_pallas`` says; their plain versions serve the
  CPU (``train/config.py``).
* Loss and metric sums stay on the device; the host reads them once per
  epoch (one synchronisation for the train pass, one for eval), unless the
  non-finite skip is on, which decides on the host each step.
* Checkpoints carry the optimizer, scheduler and guard state: true resume
  (``resume_from``), with the loader's shuffle continuing at the resumed
  epoch.
* ``profile_dir``: a ``torch.profiler`` trace of steps 10-20
  (``trace.json``) and the program's spans of the same steps
  (``spans.json``: Chrome trace events in microseconds on
  ``time.perf_counter``, the profiler's start in the file), best-effort.
* Unlike the JAX loop (ADVICE.md r5 "medium", its ``loop.py:447``), the
  periodic ``_last`` checkpoint records the best val loss after this
  epoch's best-val update.
* The run computes under ``core.determinism.deterministic``: cuDNN and
  torch's kernels in their deterministic modes, so a run on the card is
  the same bits each time (the hand-written kernels add in fixed orders).
* ``mesh_data`` > 1: data parallel over a ``torch.distributed`` group of
  that many processes (torchrun's, or ``group``). Every rank reads the
  global batches in one card's order and takes its rows; the steps reduce
  over the group (train/steps.py), so the history and the checkpoints are
  one card's, up to the order of the sums. ``zero1`` splits the AdamW
  moments over the ranks. Only rank 0 writes checkpoints, history.csv and
  the log; every rank runs the same epochs, decisions included, since each
  reads the same reduced numbers.
* ``mesh_model`` > 1: tensor parallel, as the JAX ``fit`` builds it: the
  mesh is ``mesh_data x mesh_model`` processes, the model's state is
  sharded by ``MeshRules(shard_model_channels=True, shard_opt_state_data=
  zero1).tree_sharding`` (each conv kernel and its AdamW moments split by
  output channel over the model ranks, ZeRO-1 on top), and the train and
  eval steps take that sharding. Checkpoints stay one process's: the
  shards and moments are gathered before global rank 0 writes, and a
  resume (or a guard rollback) narrows them again.
"""

from __future__ import annotations

import csv
import functools
import os
import time
import warnings
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..core import trace
from ..core.determinism import deterministic
from ..core.dtypes import resolve_device
from ..data.npz_dataset import NPZSequenceDataset
from ..data.pipeline import SequenceLoader, pad_batch, prefetch_to_device
from ..models.registry import build_model
from ..parallel.mesh import MeshRules, make_mesh
from ..parallel.tensor import (full_state_dict, load_full_state_dict,
                               shard_model)
from .checkpoint import restore_checkpoint, save_checkpoint
from .config import TrainConfig, check_mesh
from .metrics import MetricSums, metric_sums_finalize, metric_sums_init
from .optim import (ReduceLROnPlateau, make_optimizer, nonfinite_step_count,
                    set_learning_rate)
from .steps import make_eval_step, make_train_step

PROFILE_STEPS = (10, 20)   # global steps traced with profile_dir


def _map_tensors(obj, fn: Callable):
    """``obj`` with ``fn`` applied to every tensor inside dicts, lists and
    tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _clone(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone()


def _snap_take(model, opt, mode: str, mesh=None):
    """The guard's rollback snapshot of the model and optimizer state, as
    one process's (tensor-parallel shards gathered). ``device``: copies on
    the card (one more state in device memory). ``host``: copies in host
    memory."""
    fn = _clone if mode == "device" else (
        lambda t: t.detach().to("cpu", copy=True))
    return (_map_tensors(full_state_dict(model, mesh), fn),
            _map_tensors(opt.state_dict(), fn))


def _snap_restore(model, opt, snap, mesh=None) -> None:
    load_full_state_dict(model, snap[0], mesh)
    # copy again: the optimizer updates its moments in place, and the
    # snapshot must survive for a possible second rollback
    opt.load_state_dict(_map_tensors(snap[1], _clone))


def _append_history_csv(ckpt_dir: str, row: Dict[str, Any],
                        filename: str = "history.csv") -> None:
    """The persistent per-epoch metrics log. On resume the existing header
    wins, so appended rows stay column-aligned: unknown keys are dropped,
    missing ones left blank."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, filename)
    fieldnames = list(row)
    header = None
    if os.path.exists(path):
        with open(path, newline="") as f:
            header = next(csv.reader(f), None)
        if header:
            fieldnames = header
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames,
                                extrasaction="ignore", restval="")
        if header is None:
            writer.writeheader()
        writer.writerow(row)


def _checkpoint_config(cfg: TrainConfig) -> Dict[str, Any]:
    """The config dict embedded in checkpoints. For the resnet18 family the
    saved weights already embody the pretrained init: the embedded model
    config drops ``pretrained_path`` and records ``pretrained_resolved``."""
    d = cfg.to_dict()
    model = dict(d.get("model") or {})
    if model.get("type") == "resnet18":
        model.pop("pretrained_path", None)
        model["pretrained_resolved"] = True
        d["model"] = model
    return d


def _trainable_mask(model: torch.nn.Module, model_cfg: Dict[str, Any]
                    ) -> Optional[Dict[str, bool]]:
    """The frozen-encoder filter: with ``freeze_encoder`` (the resnet18
    family's default) the ``encoder.*`` parameters get no update and no
    weight decay; None when nothing is frozen."""
    default_freeze = model_cfg.get("type") == "resnet18"
    if not model_cfg.get("freeze_encoder", default_freeze):
        return None
    return {n: n.split(".")[0] != "encoder"
            for n, _ in model.named_parameters()}


def _add_sums(a: MetricSums, b: MetricSums) -> MetricSums:
    return MetricSums(*(x + y for x, y in zip(a, b)))


def _read(loss_sum: torch.Tensor, sums: MetricSums):
    """One host synchronisation: (loss sum, metrics dict)."""
    vals = torch.stack([loss_sum.float(), *sums]).tolist()
    return vals[0], metric_sums_finalize(MetricSums(*vals[1:]))


class _Profiler:
    """A best-effort ``torch.profiler`` trace of a window of steps
    (``trace.json``), and the program's spans of the same window
    (``spans.json``, ``core/trace.py``)."""

    def __init__(self, out_dir: Optional[str], device, log):
        self.out_dir, self.device, self.log = out_dir, device, log
        self.prof = None
        self.t0 = 0.0

    def step(self, global_step: int) -> None:
        if self.out_dir and global_step == PROFILE_STEPS[0]:
            act = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                act.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                self.prof = torch.profiler.profile(activities=act)
                self.prof.start()
                self.t0 = time.perf_counter()
            except Exception as e:  # profiling is best-effort
                self.log(f"[profiler] start failed: {e}")
                self.prof, self.out_dir = None, None
        elif self.prof is not None and global_step >= PROFILE_STEPS[1]:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        prof, self.prof, out_dir, self.out_dir = self.prof, None, \
            self.out_dir, None
        try:
            t1 = time.perf_counter()
            prof.stop()
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            trace.write_chrome_trace(
                os.path.join(out_dir, "spans.json"), self.t0, t1)
        except Exception as e:
            self.log(f"[profiler] stop failed: {e}")


def _run_mesh(cfg: TrainConfig, group):
    """The ``(mesh_data, mesh_model)`` mesh of the run, or None for one
    process."""
    check_mesh(cfg)
    n_data, n_model = cfg.mesh_data or 1, cfg.mesh_model
    n = n_data * n_model
    world = os.environ.get("WORLD_SIZE")
    if world is not None and int(world) != n:
        raise ValueError(f"WORLD_SIZE={world} but mesh_data="
                         f"{cfg.mesh_data} x mesh_model={n_model}: launch "
                         f"one process a rank (torchrun --nproc-per-node "
                         f"{n})")
    if group is None and n > 1:
        if not dist.is_initialized():
            raise ValueError(f"mesh_data={n_data} x mesh_model={n_model} "
                             f"needs a torch.distributed process group of "
                             f"{n} ranks: launch the run under torchrun")
        group = dist.group.WORLD
    return None if group is None else make_mesh(n_data, n_model,
                                                group=group)


def fit(cfg: TrainConfig, dataset: Optional[NPZSequenceDataset] = None,
        epochs: Optional[int] = None, verbose: bool = True,
        profile_dir: Optional[str] = None,
        resume_from: Optional[str] = None, device=None,
        group=None) -> Dict[str, Any]:
    """Train per config; returns {'model', 'optimizer', 'history',
    'best_val_loss', 'apply_fn', 'dataset', 'mesh'}.

    ``resume_from``: a training checkpoint (``.pt``) — restores weights, BN
    stats, optimizer, scheduler and guard state and continues from the
    saved epoch. Runs on the card unless ``device`` names another.
    ``group``: the process group of a parallel run (``mesh_data x
    mesh_model`` ranks; torchrun's default group when None). The returned
    model holds this rank's shards under tensor parallelism
    (``parallel.tensor.full_state_dict`` gathers it)."""
    dev = resolve_device(device)
    mesh = _run_mesh(cfg, group)
    with deterministic(dev):
        return _fit(cfg, dataset, epochs, verbose, profile_dir, resume_from,
                    dev, mesh)


def _fit(cfg, dataset, epochs, verbose, profile_dir, resume_from, dev,
         mesh) -> Dict[str, Any]:
    rank0 = mesh is None or mesh.rank == 0
    log = print if verbose and rank0 else (lambda *a, **k: None)
    n_data = mesh.data if mesh is not None else 1

    if dataset is None:
        dataset = NPZSequenceDataset(cfg.npz_path, min_y=cfg.min_y,
                                     max_y=cfg.max_y,
                                     mask_threshold=cfg.mask_threshold)
    train_idx, val_idx = dataset.train_val_split(cfg.train_frac,
                                                 cfg.split_seed)
    log(f"Dataset: N={len(dataset)} T={dataset.T} {dataset.H}x{dataset.W} "
        f"-> train {len(train_idx)} / val {len(val_idx)}")
    if len(val_idx) == 0:
        raise ValueError(
            f"empty validation split (train_frac={cfg.train_frac}, "
            f"N={len(dataset)}) — lower train_frac or add data")
    if cfg.batch_size % n_data:
        raise ValueError(f"batch {cfg.batch_size} not divisible by "
                         f"data-parallel degree {n_data}")
    if cfg.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {cfg.accum_steps}")
    if cfg.batch_size % cfg.accum_steps:
        raise ValueError(f"batch {cfg.batch_size} not divisible by "
                         f"accum_steps {cfg.accum_steps}")
    if (cfg.batch_size // cfg.accum_steps) % n_data:
        raise ValueError(
            f"microbatch {cfg.batch_size // cfg.accum_steps} "
            f"(batch {cfg.batch_size} / accum_steps {cfg.accum_steps}) not "
            f"divisible by data-parallel degree {n_data}")
    if cfg.guard_snapshot not in ("device", "host"):
        raise ValueError(f"guard_snapshot must be 'device' or 'host', "
                         f"got {cfg.guard_snapshot!r}")

    # ``pretrained_resolved`` marks a config embedded in a trained
    # checkpoint: honour it only when this fit restores those weights
    if resume_from:
        cfg.model.pop("pretrained_path", None)
        cfg.model["pretrained_resolved"] = True
    elif cfg.model.pop("pretrained_resolved", None):
        warnings.warn(
            "model config carried pretrained_resolved=True into a FRESH "
            "initialization (no resume_from) — ignoring it and re-resolving "
            "pretrained weights; that marker is only valid when checkpoint "
            "weights will overwrite the init", stacklevel=2)

    _, init_fn, apply_fn, _ = build_model(cfg.model)
    # flat_layout "auto": batch-major on a data mesh, as the JAX fit picks
    # it (there it keeps XLA's reshapes device-local; models/layout.py)
    flat_layout = cfg.flat_layout
    if flat_layout == "auto":
        flat_layout = "batch" if n_data > 1 else "time"
    apply_fn = functools.partial(apply_fn, use_pallas=True,
                                 use_fused_doubleconv=True,
                                 unroll=cfg.unroll, remat=cfg.remat,
                                 flat_layout=flat_layout)
    model = init_fn(torch.Generator().manual_seed(cfg.seed), device=dev)
    sharding = None
    if mesh is not None and mesh.model > 1:
        # every rank draws the same init; each keeps its shards
        sharding = MeshRules(mesh, shard_model_channels=True,
                             shard_opt_state_data=cfg.zero1
                             ).tree_sharding(model.state_dict())
        shard_model(model, sharding)
    opt = make_optimizer(model.named_parameters(), cfg.lr, cfg.weight_decay,
                         cfg.grad_clip,
                         trainable_mask=_trainable_mask(model, cfg.model),
                         skip_nonfinite=cfg.skip_nonfinite_updates,
                         mesh=mesh, zero1=cfg.zero1)
    train_step = make_train_step(
        apply_fn, dataset.stats, use_mask=cfg.use_mask,
        guard_nonfinite_stats=cfg.skip_nonfinite_updates is not None,
        accum_steps=cfg.accum_steps, mesh=mesh, state_sharding=sharding)
    eval_step = make_eval_step(apply_fn, dataset.stats, use_mask=cfg.use_mask,
                               mesh=mesh, variables_sharding=sharding)
    scheduler = ReduceLROnPlateau(cfg.lr, cfg.plateau_factor,
                                  cfg.plateau_patience, min_lr=cfg.min_lr)
    guard = None
    if cfg.guard:
        from .guard import TrainingGuard

        guard = TrainingGuard(cfg.guard_spike_factor,
                              max_events=cfg.guard_max_events)

    start_epoch = 1
    best_val = float("inf")
    if resume_from:
        model_state, meta = restore_checkpoint(resume_from)
        if "optimizer" not in meta:
            raise ValueError(f"{resume_from}: not a training checkpoint (no "
                             "optimizer state to resume)")
        load_full_state_dict(model, model_state, mesh)
        opt.load_state_dict(meta["optimizer"])
        if "scheduler" in meta:
            scheduler.load_state_dict(meta["scheduler"])
            set_learning_rate(opt, scheduler.lr)
        if guard is not None and "guard" in meta:
            guard.load_state_dict(meta["guard"])
        start_epoch = int(meta.get("epoch", 0)) + 1
        best_val = float(meta.get("val_loss", float("inf")))
        log(f"resumed from {resume_from} at epoch {start_epoch} "
            f"(best val {best_val:.4f}, lr {scheduler.lr:.2e})")

    # the last healthy end-of-epoch (state, scheduler, epoch) for rollback
    snapshot = ((*_snap_take(model, opt, cfg.guard_snapshot, mesh),
                 scheduler.state_dict(), start_epoch - 1)
                if guard is not None else None)

    train_loader = SequenceLoader(dataset, train_idx, cfg.batch_size,
                                  shuffle=True, seed=cfg.seed,
                                  drop_remainder=True)
    # resume continues the per-epoch shuffle sequence
    train_loader.epoch = start_epoch - 1
    val_loader = SequenceLoader(dataset, val_idx, cfg.batch_size,
                                shuffle=False)
    rows = mesh.rows(cfg.batch_size) if mesh is not None else slice(None)

    def local(batches):
        """This rank's rows of each global batch (numpy, before the copy
        to the device)."""
        for x_np, y_np in batches:
            yield x_np[rows], y_np[rows]

    tb_writer = None
    if cfg.tensorboard_dir and rank0:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(cfg.tensorboard_dir)
        except Exception as e:  # logging is best-effort
            log(f"[tensorboard] unavailable: {e}")

    model_name = cfg.model.get("type", "custom")
    norm_dict = dataset.stats.to_dict()

    def save(tag, model_state, opt_state, epoch, sched_state, guard_state):
        extra = {"optimizer": opt_state, "val_loss": best_val,
                 "epoch": epoch, "scheduler": sched_state}
        if guard_state is not None:
            extra["guard"] = guard_state
        if not rank0:
            return
        save_checkpoint(
            os.path.join(cfg.checkpoint_dir, f"{model_name}_{tag}.pt"),
            model_state, _checkpoint_config(cfg), norm_dict, **extra)

    def save_now(tag, epoch):
        # every rank: the state dicts gather the shards and ZeRO-1's moments
        save(tag, full_state_dict(model, mesh), opt.state_dict(), epoch,
             scheduler.state_dict(),
             guard.state_dict() if guard is not None else None)

    history = []
    n_epochs = epochs if epochs is not None else cfg.epochs
    last_completed = start_epoch - 1   # advanced per healthy epoch
    global_step = 0
    profiler = _Profiler(profile_dir if rank0 else None, dev, log)

    try:
        for epoch in range(start_epoch, n_epochs + 1):
            # ---- train ----
            t0 = time.time()
            loss_sum = torch.zeros((), device=dev)
            sums, n_seen = metric_sums_init(dev), 0
            for x_raw, y_raw in prefetch_to_device(local(train_loader), 2,
                                                   dev):
                profiler.step(global_step)
                loss, s = train_step(model, opt, x_raw, y_raw)
                loss_sum = loss_sum + loss * x_raw.shape[0] * n_data
                sums = _add_sums(sums, s)
                n_seen += x_raw.shape[0] * n_data
                global_step += 1
            if not n_seen:
                raise ValueError(
                    f"no train batches: {len(train_idx)} train samples with "
                    f"batch_size {cfg.batch_size} (drop_remainder) — lower "
                    f"the batch size or add data")
            tr_loss, tr = _read(loss_sum, sums)
            tr_loss /= n_seen
            tr_time = time.time() - t0

            # ---- eval (tail batches padded to the full batch size) ----
            loss_sum = torch.zeros((), device=dev)
            sums, n_seen = metric_sums_init(dev), 0
            for x_np, y_np in val_loader:
                x_np, y_np, n_real = pad_batch(x_np, y_np, cfg.batch_size)
                x_np, y_np = x_np[rows], y_np[rows]
                loss, s = eval_step(model, torch.from_numpy(x_np).to(dev),
                                    torch.from_numpy(y_np).to(dev), n_real)
                loss_sum = loss_sum + loss * n_real
                sums = _add_sums(sums, s)
                n_seen += int(n_real)
            val_loss, va = _read(loss_sum, sums)
            val_loss /= max(n_seen, 1)

            # ---- failure detection: roll back a poisoned/exploded epoch ----
            if guard is not None:
                reason = guard.check(tr_loss, val_loss)
                if reason is not None:
                    try:
                        guard.record_event(epoch, reason)
                    except RuntimeError:
                        # budget exhausted: persist the LAST HEALTHY state
                        # (the snapshot), stamped with its epoch, the
                        # compounded LR cut and a fresh rollback budget, so
                        # it resumes with the guard on
                        if cfg.checkpoint_dir:
                            sched = dict(snapshot[2])
                            sched["lr"] = max(
                                snapshot[2]["lr"]
                                * cfg.plateau_factor ** guard.consecutive,
                                cfg.min_lr)
                            save("last", snapshot[0], snapshot[1],
                                 snapshot[3], sched,
                                 {"recent": [], "n_events": 0,
                                  "consecutive": 0})
                        raise
                    _snap_restore(model, opt, snapshot, mesh)
                    scheduler.load_state_dict(snapshot[2])
                    # compound the cut across CONSECUTIVE rollbacks
                    scheduler.lr = max(
                        snapshot[2]["lr"]
                        * cfg.plateau_factor ** guard.consecutive,
                        scheduler.min_lr)
                    set_learning_rate(opt, scheduler.lr)
                    row = {"epoch": epoch, "lr": scheduler.lr,
                           "train_loss": tr_loss, "val_loss": val_loss,
                           "train_time_s": tr_time, "guard_event": reason}
                    history.append(row)
                    if cfg.checkpoint_dir and rank0:
                        _append_history_csv(cfg.checkpoint_dir, row,
                                            "guard_events.csv")
                    log(f"Epoch {epoch}/{n_epochs}: GUARD — {reason}; "
                        f"rolled back to last healthy state, lr -> "
                        f"{scheduler.lr:.2e} (event {guard.n_events}/"
                        f"{guard.max_events})")
                    continue

            lr = scheduler.step(val_loss)
            set_learning_rate(opt, lr)

            last_completed = epoch
            row = {"epoch": epoch, "lr": lr, "train_loss": tr_loss,
                   "val_loss": val_loss, "train_time_s": tr_time,
                   **{f"train_{k}": v for k, v in tr.items()},
                   **{f"val_{k}": v for k, v in va.items()}}
            if cfg.skip_nonfinite_updates is not None:
                row["nonfinite_steps"] = nonfinite_step_count(opt)
            history.append(row)
            if cfg.checkpoint_dir and rank0:
                _append_history_csv(cfg.checkpoint_dir, row)
            if tb_writer is not None:
                for k, v in row.items():
                    if k != "epoch":
                        tb_writer.add_scalar(k, v, epoch)
                tb_writer.flush()
            log(f"Epoch {epoch}/{n_epochs}: "
                f"Train Loss={tr_loss:.4f} MAE={tr['mae']:.4f} "
                f"RMSE={tr['rmse']:.4f} ME={tr['me']:.4f} | "
                f"Val Loss={val_loss:.4f} MAE={va['mae']:.4f} "
                f"RMSE={va['rmse']:.4f} ME={va['me']:.4f} "
                f"| lr={lr:.2e} ({tr_time:.1f}s)")

            if guard is not None:  # a healthy epoch: the new rollback point
                snapshot = (*_snap_take(model, opt, cfg.guard_snapshot,
                                        mesh),
                            scheduler.state_dict(), epoch)

            if val_loss < best_val:
                best_val = val_loss
                if cfg.checkpoint_dir:
                    save_now("best", epoch)
                    log("   -> new best; checkpoint saved")

            # the periodic crash-recovery point, after this epoch's best-val
            # update: a resume from it must know this epoch's best
            if (cfg.checkpoint_dir and cfg.save_last_every
                    and epoch % cfg.save_last_every == 0):
                save_now("last", epoch)
    finally:
        # one teardown for every exit: no open SummaryWriter or trace left
        if tb_writer is not None:
            tb_writer.close()
        profiler.stop()

    if cfg.checkpoint_dir and last_completed >= start_epoch:
        # stamp the last COMPLETED epoch, never the requested horizon
        save_now("last", last_completed)
    elif cfg.checkpoint_dir:
        log(f"no epochs ran (resumed at {start_epoch}, horizon "
            f"{n_epochs}); leaving the existing _last checkpoint alone")
    return {"model": model, "optimizer": opt, "history": history,
            "best_val_loss": best_val, "apply_fn": apply_fn,
            "dataset": dataset, "mesh": mesh}
