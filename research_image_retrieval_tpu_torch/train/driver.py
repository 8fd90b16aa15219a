"""End-to-end training driver (port of
``research_image_retrieval_tpu/train/driver.py``).

Registry model, the per-family optimizer (with the AdamW -> SGD hand-off
of ``adamw_then_sgd`` at ``switch_epoch``), warmup-cosine per-update
learning rate, gradient accumulation and clipping, per-epoch validation
with top-1/5 errors, rolling checkpoints with best tracking, JSONL
metrics, the preemption guard, and exact resume (model, optimizer, step
generator and data-iterator state, mid-epoch included).  Data: a packed
``.rirrec`` record file, the GLDv2 CSV layout, or the synthetic
procedural classes.

One process per device (``cfg.device``, default CUDA: raises without a
card).  Under ``torchrun`` or SLURM (``WORLD_SIZE`` / ``SLURM_NTASKS``
in the environment) the driver starts ``torch.distributed``
(``parallel.init_distributed_mode``: NCCL on CUDA, gloo on the CPU) and
trains over the ``cfg.data_parallel x cfg.model_parallel`` layout of
ranks (None: every rank on that axis, JAX's "all devices"): each rank
reads its rows of the single-device run's global batch
(``ShardedBatchIterator(row_shard=...)``), the steps run with JAX's
global-batch semantics (``train/loop.py``), and rank 0 alone writes the
checkpoints (the sharded classifier gathered whole, so they load at any
world size), the JSONL history, TensorBoard and ``curves.png``.  A layout
that is not the world size and ``data_parallel`` / ``model_parallel``
> 1 in one process raise instead of training something else.  The
models whose training couples the batch's samples (SPECTRUM, IRIS,
AdaptiveHybrid, SPARSE with a teacher) see the global batch there
(``utils.collectives.data_gather_grad``).
``compute_dtype="bfloat16"`` builds a model with a ``dtype`` field at
bf16, as the JAX driver does (an explicit
``model_overrides["dtype"]`` wins; a model without the field gets a
note); fp32 stays the default here, as in the JAX driver on every
platform but the TPU.  ``teacher=True`` builds the distillation teacher's
table once on the host (``build_teacher_table``) for the models that
take ``text_features`` (sparse, hamlet); the steps gather it on the
device.  Every ``plot_freq`` epochs the driver redraws
``<directory>/curves.png`` (``train/plots.py``); where matplotlib is
missing it prints why once and stops plotting, as the JAX driver does.

Resume is exact on the CPU.  On CUDA it is bit-exact only when both the
interrupted run and the resumed one execute inside
``utils.profiling.deterministic_mode()`` (which needs
``CUBLAS_WORKSPACE_CONFIG`` set before the process's first cuBLAS call);
outside it cuDNN may pick nondeterministic algorithms.
"""

from __future__ import annotations

import dataclasses
import inspect
import os

import numpy as np
import torch
import torch.distributed as dist

from research_image_retrieval_tpu_torch.data import (
    EvalTransform,
    ShardedBatchIterator,
    SyntheticRetrievalDataset,
    TrainTransform,
    build_gldv2_train_val,
)
from research_image_retrieval_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from research_image_retrieval_tpu_torch.models import (
    MODEL_REGISTRY,
    TABLE1_TO_MODEL_MAPPING,
    get_model,
)
from research_image_retrieval_tpu_torch.parallel import (
    init_distributed_mode,
    is_main_process,
    local_device,
    make_mesh,
)
from research_image_retrieval_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from research_image_retrieval_tpu_torch.train.loop import (
    create_train_state,
    make_eval_step,
    make_train_step,
    shard_train_state,
)
from research_image_retrieval_tpu_torch.train.metrics import (
    DeferredUpdate,
    JsonlWriter,
    MetricLogger,
    TensorBoardWriter,
)
from research_image_retrieval_tpu_torch.train.optimizer import (
    make_adamw_optimizer,
    make_sgd_optimizer,
)
from research_image_retrieval_tpu_torch.train.preemption import (
    PreemptionGuard,
)
from research_image_retrieval_tpu_torch.train.schedule import (
    warmup_cosine_schedule,
)
from research_image_retrieval_tpu_torch.utils.collectives import (
    all_reduce_,
)
from research_image_retrieval_tpu_torch.utils.config import TrainConfig
from research_image_retrieval_tpu_torch.utils.device import resolve_device

__all__ = ["build_datasets", "build_optimizer",
           "build_teacher_table", "check_config", "model_kwargs",
           "resolve_layout", "train"]

def _launched_world() -> int:
    """The world size of this run: the process group's, else what a
    launcher put in the environment (``WORLD_SIZE``, then SLURM's, in
    ``init_distributed_mode``'s order), else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    if "SLURM_NTASKS" in os.environ and "SLURM_PROCID" in os.environ:
        return int(os.environ["SLURM_NTASKS"])
    return 1


def check_config(cfg: TrainConfig) -> None:
    """Raise on what the port cannot run as asked (never a quiet
    substitute)."""
    if cfg.compute_dtype not in ("", "float32", "bfloat16"):
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: '', "
                         "'float32' or 'bfloat16'")


def resolve_layout(cfg: TrainConfig):
    """The ``parallel.Mesh`` to train over, or None for one process
    outside ``torch.distributed``.  Starts the process group when the
    environment holds a launcher's world (``WORLD_SIZE`` or SLURM's)."""
    if not dist.is_initialized() and _launched_world() > 1:
        init_distributed_mode(device=cfg.device)
    data, model = cfg.data_parallel, cfg.model_parallel or 1
    if not dist.is_initialized():
        if (data or 1) * model > 1:
            n = (data or 1) * model
            raise ValueError(
                f"data_parallel={data} x model_parallel={model} needs {n} "
                "processes, one per GPU, and this is one process outside "
                "torch.distributed; launch it with torchrun --nproc_per_node="
                f"{n} -m research_image_retrieval_tpu_torch.cli.train "
                f"--data-parallel {data or 1} --model-parallel {model} ...")
        return None
    return make_mesh(data=data, model=model)


def build_teacher_table(cfg: TrainConfig, model, num_classes: int):
    """``[num_classes, text_dim]`` float32 teacher embeddings for a
    distillation model (one that takes ``text_features``): the class
    texts (``cfg.teacher_texts``, one per line, or the synthetic
    template) through ``data/teacher.TextTeacher`` once, on the host.
    Raises for a model without ``text_features`` and for a table whose
    width is not the model's ``text_dim``."""
    from research_image_retrieval_tpu_torch.data.teacher import (
        TextTeacher,
        default_label_texts,
        load_label_texts,
    )

    if "text_features" not in inspect.signature(model.forward).parameters:
        raise ValueError(
            f"--teacher set but model {cfg.model!r} takes no text_features; "
            "distillation models: sparse, hamlet")
    texts = (load_label_texts(cfg.teacher_texts, num_classes)
             if cfg.teacher_texts else default_label_texts(num_classes))
    teacher = TextTeacher(cfg.teacher_model,
                          max_length=cfg.teacher_max_length,
                          allow_random_init=cfg.teacher_allow_random)
    table = teacher.class_table(texts)
    want = getattr(model, "text_dim", None)
    if want is not None and table.shape[1] != want:
        raise ValueError(
            f"teacher text_dim {table.shape[1]} != model text_dim {want}; "
            f"set model_overrides text_dim={table.shape[1]} or pick a "
            "matching teacher")
    print(f">> teacher table: {table.shape[0]} classes x {table.shape[1]} "
          f"dims ({'pretrained' if teacher.pretrained else 'random-init'} "
          f"{cfg.teacher_model})")
    return table


def model_kwargs(cfg: TrainConfig) -> dict:
    """``cfg.model_overrides`` plus the compute dtype, as the JAX driver
    passes it: ``dtype`` for a model that has the field (an explicit
    ``model_overrides["dtype"]`` wins), a note for one that has not."""
    kwargs = dict(cfg.model_overrides)
    if cfg.compute_dtype in ("", "float32") or "dtype" in kwargs:
        return kwargs
    builder = MODEL_REGISTRY[TABLE1_TO_MODEL_MAPPING.get(cfg.model,
                                                        cfg.model)].builder
    if "dtype" in inspect.signature(builder).parameters:
        kwargs["dtype"] = cfg.compute_dtype
    else:
        print(f"note: {cfg.model} has no compute-dtype knob; "
              f"ignoring compute_dtype={cfg.compute_dtype}")
    return kwargs


def build_datasets(cfg: TrainConfig):
    """(train, val, num_classes): a ``.rirrec`` record file with a seeded
    per-class val split, the GLDv2 CSV layout, or the synthetic classes
    (val shares the class signatures, ``signature_seed``)."""
    raw = bool(cfg.raw_input)
    if cfg.data_root and cfg.data_root.endswith(".rirrec"):
        from research_image_retrieval_tpu_torch.data import (
            RecordDataset,
            RecordReader,
        )

        labels = RecordReader(cfg.data_root).labels()
        n_cls = int(labels.max()) + 1
        rng = np.random.default_rng(cfg.seed)
        val_idx = []
        for c in range(n_cls):
            members = np.flatnonzero(labels == c)
            take = min(cfg.val_per_class, max(len(members) - 1, 0))
            if take:
                val_idx.extend(rng.choice(members, take, replace=False))
        val_mask = np.zeros(len(labels), bool)
        val_mask[np.asarray(val_idx, int)] = True
        train = RecordDataset(
            cfg.data_root, indices=np.flatnonzero(~val_mask),
            transform=TrainTransform(cfg.imsize, seed=cfg.seed,
                                     raw_uint8=raw))
        val = RecordDataset(
            cfg.data_root, indices=np.flatnonzero(val_mask),
            transform=EvalTransform(cfg.imsize, raw_uint8=raw))
        return train, val, n_cls
    if cfg.data_root and cfg.csv_path:
        return build_gldv2_train_val(
            cfg.data_root, cfg.csv_path, val_per_class=cfg.val_per_class,
            seed=cfg.seed,
            train_transform=TrainTransform(cfg.imsize, seed=cfg.seed,
                                           raw_uint8=raw),
            val_transform=EvalTransform(cfg.imsize, raw_uint8=raw))
    n_cls = cfg.synthetic_classes
    u8 = bool(cfg.synthetic_uint8)
    train = SyntheticRetrievalDataset(
        num_classes=n_cls, samples_per_class=cfg.synthetic_samples,
        image_size=cfg.imsize, seed=cfg.seed, uint8=u8)
    val = SyntheticRetrievalDataset(
        num_classes=n_cls, samples_per_class=cfg.synthetic_val_samples,
        image_size=cfg.imsize, seed=cfg.seed + 1, uint8=u8,
        signature_seed=cfg.seed)
    return train, val, n_cls


def build_optimizer(cfg: TrainConfig, iter_per_epoch: int,
                    phase: str = "main"):
    """The ``Transform`` of a training phase: ``adamw_then_sgd`` runs
    AdamW at a constant ``base_lr`` until ``switch_epoch`` ("warm"),
    then SGD on a cosine schedule ("main")."""
    if cfg.optimizer == "adamw_then_sgd":
        if phase == "warm":
            return make_adamw_optimizer(
                cfg.base_lr, weight_decay=cfg.weight_decay,
                clip_max_norm=cfg.clip_max_norm,
                update_every=cfg.update_every)
        sched = warmup_cosine_schedule(
            0, cfg.base_lr, cfg.num_epochs - cfg.switch_epoch, 1e-2,
            cfg.final_lr, iter_per_epoch)
        return make_sgd_optimizer(
            sched, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
            clip_max_norm=cfg.clip_max_norm, update_every=cfg.update_every)
    sched = warmup_cosine_schedule(
        cfg.warmup_epochs,
        cfg.warmup_lr * cfg.update_every,
        cfg.num_epochs,
        cfg.base_lr * cfg.update_every,
        cfg.final_lr * cfg.update_every,
        max(iter_per_epoch // cfg.update_every, 1))
    if cfg.optimizer == "adamw":
        return make_adamw_optimizer(
            sched, weight_decay=cfg.weight_decay,
            clip_max_norm=cfg.clip_max_norm, update_every=cfg.update_every)
    return make_sgd_optimizer(
        sched, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        clip_max_norm=cfg.clip_max_norm, update_every=cfg.update_every)


def _resume_target(cfg: TrainConfig, mgr: CheckpointManager):
    """(manager, epoch) of the checkpoint ``cfg.resume`` names."""
    if isinstance(cfg.resume, str) and cfg.resume not in ("latest", "true"):
        base = os.path.basename(os.path.normpath(cfg.resume))
        stem = os.path.splitext(base)[0]
        if not stem.startswith("epoch_"):
            raise ValueError(f"--resume expects 'latest' or a "
                             f".../epoch_NNNNN.pt path, got {cfg.resume!r}")
        return (CheckpointManager(os.path.dirname(os.path.abspath(cfg.resume)),
                                  keep_every=cfg.keep_every),
                int(stem.split("_")[1]))
    epoch = mgr.latest_epoch()
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints in {cfg.directory}")
    return mgr, epoch


def train(cfg: TrainConfig, max_steps_per_epoch: int | None = None):
    """Run the training loop on ``cfg.device`` (this rank's device in a
    distributed run); returns (state, history), the same on every rank.
    ``history["preempted"]`` is True when the guard stopped the run
    after a checkpoint."""
    check_config(cfg)
    mesh = resolve_layout(cfg)
    device = (resolve_device(cfg.device) if mesh is None
              else local_device(cfg.device))
    main = is_main_process()
    train_ds, val_ds, num_classes = build_datasets(cfg)

    kwargs = model_kwargs(cfg)

    def new_model():
        return get_model(cfg.model, num_classes=num_classes, **kwargs)

    def new_state(phase: str):
        st = create_train_state(new_model(), cfg.seed,
                                build_optimizer(cfg, ipe, phase), device)
        return st if mesh is None else shard_train_state(st, mesh)

    rows = (None if mesh is None
            else (mesh.coords["data"], mesh.shape["data"]))
    train_it = ShardedBatchIterator(train_ds, cfg.batch_size, seed=cfg.seed,
                                    num_workers=cfg.num_workers,
                                    row_shard=rows)
    val_it = ShardedBatchIterator(val_ds, cfg.batch_size, seed=cfg.seed,
                                  shuffle=False, num_workers=cfg.num_workers,
                                  row_shard=rows)
    ipe = train_it.steps_per_epoch()
    if max_steps_per_epoch:
        ipe = min(ipe, max_steps_per_epoch)

    os.makedirs(cfg.directory, exist_ok=True)
    mgr = CheckpointManager(cfg.directory, keep_every=cfg.keep_every)
    jsonl = (JsonlWriter(os.path.join(cfg.directory, "metrics.jsonl"))
             if main else None)
    tb = (TensorBoardWriter(os.path.join(cfg.directory, "tb"))
          if cfg.tensorboard and main else None)

    def write_metrics(step: int, **metrics):
        for w in (jsonl, tb):
            if w is not None:
                w.write(step, **metrics)

    def close_writers():
        for w in (jsonl, tb):
            if w is not None:
                w.close()

    def save(epoch: int, metric=None):
        """Every rank gathers the state (a collective); rank 0 writes."""
        payload = snapshot()
        if main:
            mgr.save(epoch, payload, metric=metric)
        if mesh is not None:
            dist.barrier()

    # the guard's flag goes through a host-side gloo group: a CPU
    # collective does not wait for the card's queue
    flag_group = (None if mesh is None
                  else dist.new_group(backend="gloo")
                  if dist.get_backend() == "nccl" else dist.group.WORLD)

    def stop_requested() -> bool:
        """The guard's flag, set on any rank, seen by all."""
        if mesh is None:
            return guard.should_stop
        flag = torch.tensor([float(guard.should_stop)])
        return bool(all_reduce_(flag, flag_group)[0] > 0)

    # uint8 items: ship uint8 and normalize on the device in the steps
    input_norm = None
    if np.asarray(train_ds[0][0]).dtype == np.uint8:
        input_norm = (IMAGENET_MEAN, IMAGENET_STD)
        print(">> raw uint8 input: normalization runs in the train step on "
              "the device")

    def phase_for(epoch: int) -> str:
        if cfg.optimizer != "adamw_then_sgd":
            return "main"
        return "warm" if epoch < cfg.switch_epoch else "main"

    def snapshot():
        """Model, optimizer, step and generator state, the data iterator's
        state and the loop epoch to resume at (mid-epoch included)."""
        return {**state.state_dict(), "it": train_it.state_dict(),
                "loop_epoch": train_it.epoch, "phase": phase}

    start_epoch = 0
    if not cfg.resume:
        phase = phase_for(0)
        state = new_state(phase)
    else:
        resume_mgr, resume_epoch = _resume_target(cfg, mgr)
        payload, ep = resume_mgr.restore(epoch=resume_epoch)
        # the optimizer state's structure depends on the phase it was
        # saved under (warm vs main around the hand-off): try each
        # phase's optimizer, as the JAX driver tries each template
        phases = (("warm", "main") if cfg.optimizer == "adamw_then_sgd"
                  else ("main",))
        state, last_err = None, None
        for ph in phases:
            try_state = new_state(ph)
            try:
                try_state.load_state_dict(payload)
            except (ValueError, KeyError, RuntimeError) as e:
                last_err = e  # another phase's optimizer state
                continue
            state, phase = try_state, ph
            break
        if state is None:
            raise last_err
        train_it.load_state_dict(payload["it"])
        start_epoch = int(payload["loop_epoch"])
        print(f">> resumed from checkpoint {ep} (optimizer phase '{phase}') "
              f"at loop epoch {start_epoch}, data step {train_it.step}")

    teacher_table = (build_teacher_table(cfg, state.model, num_classes)
                     if cfg.teacher else None)
    train_step = make_train_step(input_norm, teacher_table=teacher_table,
                                 mesh=mesh)
    eval_step = make_eval_step(input_norm, teacher_table=teacher_table,
                               mesh=mesh)

    history = {"train_loss": [], "val_loss": [], "val_top1_err": [],
               "preempted": False}
    switched = phase == "main"
    guard = PreemptionGuard()  # SIGTERM -> checkpoint and exit cleanly

    for epoch in range(start_epoch, cfg.num_epochs):
        if (cfg.optimizer == "adamw_then_sgd" and not switched
                and epoch >= cfg.switch_epoch):
            phase = "main"
            opt = build_optimizer(cfg, ipe, phase).init(state.model)
            opt.set_sharding({p: state.shards[n] for n, p
                              in state.model.named_parameters()
                              if n in state.shards}, state.shard_group)
            state.optimizer = opt
            state.step = 0
            switched = True
            print(f">> optimizer hand-off to SGD at epoch {epoch}")

        logger = MetricLogger()
        # read each step's device scalars one step late, so the host
        # prepares batch N+1 while the card runs step N
        dlog = DeferredUpdate(logger)
        header = f">> Train Epoch: [{epoch}]"
        for i, (imgs, labels) in enumerate(
                logger.log_every(train_it.epoch_batches(), cfg.print_freq,
                                 header)):
            state, m = train_step(state, imgs, labels)
            dlog.update(loss=m["loss"], top1_err=m["top1_err"],
                        top5_err=m["top5_err"])
            if stop_requested():
                save(epoch + 1)
                print(f">> preemption checkpoint at epoch {epoch}, step "
                      f"{state.step} (data step {train_it.step}); exiting")
                guard.restore()
                close_writers()
                history["preempted"] = True
                return state, history
            if max_steps_per_epoch and i + 1 >= max_steps_per_epoch:
                train_it.epoch += 1
                train_it.step = 0
                break
        dlog.flush()
        history["train_loss"].append(logger.meters["loss"].avg)
        write_metrics(state.step, epoch=epoch,
                      train_loss=logger.meters["loss"].avg)

        val_metric = None
        if (epoch + 1) % cfg.val_epoch == 0:
            vlog = MetricLogger()
            dvlog = DeferredUpdate(vlog)
            for j, (imgs, labels) in enumerate(val_it.epoch_batches()):
                m = eval_step(state, imgs, labels)
                dvlog.update(loss=m["loss"], top1_err=m["top1_err"])
                if max_steps_per_epoch and j + 1 >= max_steps_per_epoch:
                    val_it.epoch += 1
                    val_it.step = 0
                    break
            dvlog.flush()
            history["val_loss"].append(vlog.meters["loss"].avg)
            history["val_top1_err"].append(vlog.meters["top1_err"].avg)
            print(f">> Val Epoch: [{epoch}] {vlog}")
            val_metric = vlog.meters["top1_err"].avg

        if (epoch + 1) % cfg.save_freq == 0:
            save(epoch + 1, metric=val_metric)

        if main and cfg.plot_freq and (epoch + 1) % cfg.plot_freq == 0:
            try:
                from research_image_retrieval_tpu_torch.train.plots import (
                    plot_curves,
                )

                plot_curves(history,
                            os.path.join(cfg.directory, "curves.png"),
                            title=f"{cfg.model} training")
            except Exception as e:  # matplotlib is an optional channel
                print(f">> curve plotting unavailable: {e}")
                cfg = dataclasses.replace(cfg, plot_freq=0)

    guard.restore()
    close_writers()
    return state, history
