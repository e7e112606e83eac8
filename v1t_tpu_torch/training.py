"""Training and serving engine of the port: ``Trainer`` (``train_step``,
``validation_step``, ``predict``), the epoch loop ``train_epoch`` with its
device prefetch, ``validate``, ``log_metrics``, ``inference``, ``evaluate``
(which writes ``evaluation.yaml``) and ``restore_best``.

Mirrors ``v1t_tpu/training.py`` (reference train.py:42-190): a batch is cut
into micro-batches of ``config.effective_micro_batch_size``, the last one
padded to that size (``pad_batch``) with a 0/1 sample mask so every call
sees one shape. A training step sums the gradients of its micro-batches
(the loss ds-scaled by the FULL batch size, the regularizer weighted by
micro / batch) into the parameters' ``.grad``, accumulates across the mice
of a cycle while ``update`` is false, and takes one AdamW step when it is
true. Every micro-batch is one step of the run's counter: its seed,
``ops.dropout.step_seed(config.seed, step)``, keys every dropout site of the
kernels and seeds the generator of the patch dropout and the readout noise.
The module is put in train or eval mode by each call.

A batch reaches the device at its fields' wire dtypes: the image as bf16
when the loaders send the bf16 wire (uint16 bits, viewed as
``torch.bfloat16``), so the cropper computes in the JAX package's type;
everything else float32. ``train_epoch`` stages the next batches on the
host in a producer thread (padded, in pinned memory on a CUDA device) and
copies them on the consumer's stream, the one the step runs on.

``--deterministic`` (``config.deterministic``): PyTorch's deterministic
mode is the entry point's to set (``train.set_deterministic``), and the
hand-written backward kernels key off it: under it, the flash one pass
adds dq's partial sums in key order (``ops.flash_attention.fixed_order``);
their other sums (dscale, the LayerNorm's column sums, the sampling's
d(table) and d(grid)) run in a fixed order always. So every configuration
trains bit for bit on the card. ``fixed_order_kernels`` names the backward
kernels whose fixed-order form a training step takes, decided by the
model's own dispatch gates; ``check_deterministic`` refuses a CUDA step of
a ``deterministic`` config only when PyTorch's mode is off, since the
kernels would then add dq as their blocks finish. Serving launches no
backward kernel and is never refused.

Data and sequence parallelism (``mesh``, a ``parallel.DataParallel``; one
rank a card, every rank running the same loop on the same host batches):
the model is broadcast from the grid's first rank when the trainer is
built; each data rank keeps its rows of every padded micro-batch
(``DataParallel.shard_batch``); the gradients are summed over the data axis
once, before the AdamW step (the loss is a sum over samples, so the sum is
the one-device gradient), with the regularizer, which every rank computes
from the same parameters, entering on data rank 0 alone; the metrics are
summed over the data axis, and validation and ``predict`` return the
global predictions, gathered in rank order. The trainer registers its grid
(``parallel/context.py``) around each step, so BatchNorm takes global batch
statistics and the ViT shards its attention over a seq axis; seq ranks hold
the same rows and end each backward with the same gradients. The step's
seed folds in the data rank (``step_seed``). Without a grid nothing of
this runs: a one-device run is bit for bit what it was.

Not ported: the whole-cycle dispatch fusion ``train_cycle``. Its
counterpart on the card is a CUDA graph of the cycle; ``train_epoch`` takes
the JAX loop's per-step branch, which ``tests/test_fused_cycle.py`` pins as
numerically identical to the fused cycle; in JAX it is single-process only
too (``v1t_tpu/training.py:264-273``).
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import typing as t

import numpy as np
import torch

from v1t_tpu_torch import losses
from v1t_tpu_torch.configs import Config
from v1t_tpu_torch.data.cards import DataCard, micro_batching
from v1t_tpu_torch.data.loaders import BatchLoader, CycleLoaders
from v1t_tpu_torch.metrics import Metrics
from v1t_tpu_torch.models.model import Model, model_regularizer
from v1t_tpu_torch.ops.dropout import step_seed
from v1t_tpu_torch.optim import build_optimizer
from v1t_tpu_torch.parallel import context


FIELDS = ("image", "response", "behavior", "pupil_center")

# the backward kernels whose sums across blocks take a fixed order, by wrapper
FIXED_ORDER_KERNELS = {
    "attention_bwd": "attention_bwd (row 2's core: dq in the one pass of "
                     "csrc/flash_attention_bwd.cu, in key order under the mode; dscale in "
                     "csrc/attention_bwd.cu, by block)",
    "ln_linear_bwd": "ln_linear_bwd (the fused projections' and MLP's backward: dbrow, dgamma, "
                     "dbeta in csrc/ln_linear_bwd.cu, by block)",
    "flash_attention_bwd": "flash_attention_bwd (row 8: dq in csrc/flash_attention_bwd.cu, in "
                           "key order under the mode; past padded head width 256 the column "
                           "groups', in key order a (plane, group, query tile))",
    "bilinear_sample_cm_bwd": "bilinear_sample_cm_bwd (row 6: d(table) in fixed point, d(grid) "
                              "by chunk, in csrc/bilinear_sample.cu)",
}


def _core_tokens(config: Config) -> int:
    """The token count of a vit or cct core under ``config``: the
    cropper's output shape through the core's patching."""
    from v1t_tpu_torch.models.cores.cct import tokenizer_grid
    from v1t_tpu_torch.models.cropper import ImageCropper
    from v1t_tpu_torch.ops.common import unfold_output_size

    _, h, w = ImageCropper(config.input_shape, (), center_crop=config.center_crop,
                           resize_image=config.resize_image, ds_name=config.ds_name).output_shape
    p, s = config.patch_size, config.patch_stride
    if config.core == "cct":
        gh, gw = tokenizer_grid(h, w, p, s)
        return gh * gw
    return unfold_output_size(h, p, s) * unfold_output_size(w, p, s) + 1


def fixed_order_kernels(config: Config, device: t.Union[str, torch.device],
                        core_frozen: bool = False) -> t.List[str]:
    """The backward kernels with fixed-order sums across blocks (their
    wrappers' names, keys of ``FIXED_ORDER_KERNELS``) that a training step
    of ``config`` launches on ``device``, decided by the model's dispatch
    gates: vit's ``_fused_attention_eligible`` (the fused sublayers' backward
    kernels, the flash backward in place of ``attention_bwd``'s own past
    its head widths; else the flash kernels' where ``multi_head_attention``
    takes them), the MLP's (``fused_mlp`` in bf16), ``multi_head_attention``'s
    (cct: flash from ``MIN_FLASH_N`` tokens) and the readout's ``impl``.
    A frozen core (``core_frozen``, the ``Trainer``'s) runs none: no module
    that trains feeds it (the image shifter's shifts move the cropper's
    nearest-neighbour grid, which passes no gradient).
    A CPU device runs the plain versions: none. ``config.input_shape`` (set
    by the data layer) gives vit's and cct's token counts."""
    from v1t_tpu_torch.models.cores.vit import _fused_attention_eligible
    from v1t_tpu_torch.models.model import compute_dtype
    from v1t_tpu_torch.ops.attention import MIN_FLASH_N
    from v1t_tpu_torch.ops.fused_mha import KERNEL_HEAD_PADS
    from v1t_tpu_torch.ops.ln_linear import padded_head_dim

    if torch.device(device).type != "cuda":
        return []
    names = []
    impl, dtype = config.attention_impl, compute_dtype(config)
    # the random readout's output does not depend on the core's map, so no
    # gradient flows back through the core's kernels; nor does one into a
    # frozen core, which no trained module feeds
    through_core = config.readout != "random" and not core_frozen
    if config.core in ("vit", "cct") and impl != "xla" and through_core:
        n = _core_tokens(config)
        if config.core == "vit" and _fused_attention_eligible(dtype, impl, n, device):
            # heads (emb_dim wide) past attention.cu's widths: attention_bwd
            # hands its core to flash_bwd
            wide = padded_head_dim(config.emb_dim) not in KERNEL_HEAD_PADS
            names += ["flash_attention_bwd" if wide else "attention_bwd", "ln_linear_bwd"]
        elif impl == "pallas" or n >= MIN_FLASH_N:
            names.append("flash_attention_bwd")
        if dtype == torch.bfloat16:
            names.append("ln_linear_bwd")
    if config.readout == "gaussian2d" and config.readout_impl != "xla":
        names.append("bilinear_sample_cm_bwd")
    return list(dict.fromkeys(names))


def check_deterministic(config: Config, device: t.Union[str, torch.device],
                        core_frozen: bool = False) -> t.List[str]:
    """Under ``config.deterministic``, the kernels whose fixed-order form a
    training step on ``device`` takes (``fixed_order_kernels``; none
    otherwise). Raises ``RuntimeError`` where such a kernel would run
    outside PyTorch's deterministic mode (``train.set_deterministic`` turns
    it on), which the kernels' dq sums key off: the step would not be
    reproducible."""
    if not config.deterministic:
        return []
    kernels = fixed_order_kernels(config, device, core_frozen)
    if kernels and not torch.are_deterministic_algorithms_enabled():
        raise RuntimeError(
            f"--deterministic: PyTorch's deterministic mode is off, so "
            f"{', '.join(kernels)} would add their sums in no fixed order on {device}; "
            "turn it on first (v1t_tpu_torch.train.set_deterministic)")
    return kernels


class PreparedBatch(t.NamedTuple):
    """One training batch as tensors, staged on the host or on the device:
    [(fields, mask, n_real), ...] per micro-batch, padded to the
    micro-batch size, plus the true (unpadded) batch size
    (``v1t_tpu/training.py`` ``PreparedBatch``)."""

    micros: list
    total: int


def as_tensor(array: np.ndarray) -> torch.Tensor:
    """A host field as a CPU tensor at its wire dtype: uint16 bf16 bits
    (the bf16 image wire) as ``torch.bfloat16``, everything else float32."""
    if array.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(array)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))


def pad_batch(batch: t.Dict[str, np.ndarray], batch_size: int):
    """Pad every array in the batch to ``batch_size`` rows and return the
    0/1 sample mask (``v1t_tpu/training.py:53``)."""
    n = len(batch["image"])
    mask = np.zeros(batch_size, np.float32)
    mask[:n] = 1.0
    if n == batch_size:
        return batch, mask
    padded = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == n:
            pad_width = [(0, batch_size - n)] + [(0, 0)] * (v.ndim - 1)
            padded[k] = np.pad(v, pad_width)
        else:
            padded[k] = v
    return padded, mask


class Trainer:
    """Owns the model on ``device``, its AdamW optimizer and criterion, and
    runs them on host batches (``v1t_tpu/training.py`` ``Trainer``)."""

    def __init__(self, config: Config, model: Model, data_card: DataCard,
                 device: t.Union[str, torch.device] = "cuda", core_frozen: bool = False,
                 trainable_modules: t.Optional[t.List[str]] = None,
                 weight_decay: float = 0.0, regularizer_fn=None, mesh=None):
        """``regularizer_fn(model, mouse_id)``, if given, replaces
        ``model_regularizer`` (the ensemble has none, reference
        ensemble.py:128-129). ``mesh``: the grid of ranks (a
        ``parallel.DataParallel``), None on one device."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: device 'cuda' requested but no CUDA device is visible")
        self.config, self.data_card = config, data_card
        self.core_frozen, self.regularizer_fn = core_frozen, regularizer_fn
        self.model = model.to(self.device).eval()
        self.criterion = losses.get_criterion(config, data_card.ds_sizes)
        self.optimizer = build_optimizer(config, self.model, core_frozen=core_frozen,
                                         trainable_modules=trainable_modules,
                                         weight_decay=weight_decay)
        self._step_count = 0
        self._determinism_checked = False
        self.mesh = mesh
        if mesh is not None:
            micro = config.effective_micro_batch_size
            if micro % mesh.data_size:
                raise ValueError(f"micro batch size {micro} must be divisible by the "
                                 f"data-parallel size {mesh.data_size}")
            mesh.replicate(self.model)
        # the data rank: its seeds, and whether its step adds the regularizer
        self._data_rank = 0 if mesh is None else mesh.data.index

    def _scope(self):
        """The grid registered for the modules while a step runs."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return context.activate(self.mesh, self.config.sequence_parallel_impl)

    def _local(self, padded: dict, mask: np.ndarray):
        """This data rank's rows of a padded micro-batch and its mask."""
        if self.mesh is None:
            return padded, mask
        fields = {k: v for k, v in padded.items() if k in FIELDS}
        return self.mesh.shard_batch(fields), self.mesh.shard_mask(mask)

    def _global(self, y_pred: torch.Tensor) -> torch.Tensor:
        """The data ranks' predictions of a micro-batch, in rank order."""
        return y_pred if self.mesh is None else self.mesh.gather_rows(y_pred)

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return as_tensor(array).to(self.device)

    def _loss_terms(self, mouse_id: str, fields: t.Dict[str, torch.Tensor],
                    mask: torch.Tensor, batch_size: int, reg_weight: float,
                    seed: t.Optional[int] = None, sample: t.Optional[bool] = None):
        """One micro-batch's (loss, weighted regularizer, predictions) from
        its fields on the device; ``batch_size`` is the FULL batch size for
        the ds scaling and ``reg_weight`` the micro / batch fraction
        (reference train.py:65-72). Under a grid the regularizer enters on
        data rank 0 alone (every rank's is the same)."""
        y_pred, _, _ = self.model(
            fields["image"], mouse_id, behaviors=fields["behavior"],
            pupil_centers=fields["pupil_center"], seed=seed, sample=sample,
        )
        loss = self.criterion(y_true=fields["response"], y_pred=y_pred, mouse_id=mouse_id,
                              batch_size=batch_size, mask=mask)
        if self._data_rank:
            reg = loss.new_zeros(())
        elif self.regularizer_fn is not None:
            reg = self.regularizer_fn(self.model, mouse_id)
        else:
            reg = model_regularizer(self.config, self.model, mouse_id,
                                    core_frozen=self.core_frozen)
        return loss, reg_weight * reg, y_pred

    def stage_batch(self, batch: t.Dict[str, np.ndarray]) -> PreparedBatch:
        """Host side of ``prepare_batch``: each micro-batch padded to the
        static size, as CPU tensors at their wire dtypes, pinned when the
        trainer's device is CUDA (so the copy can be asynchronous). Safe to
        call from a producer thread: it touches no device."""
        micro = self.config.effective_micro_batch_size
        pin = self.device.type == "cuda"
        micros = []
        for micro_batch in micro_batching(batch, micro):
            padded, mask = self._local(*pad_batch(micro_batch, micro))
            fields = {k: as_tensor(padded[k]) for k in FIELDS}
            mask = torch.from_numpy(mask)
            if pin:
                fields, mask = {k: v.pin_memory() for k, v in fields.items()}, mask.pin_memory()
            micros.append((fields, mask, len(micro_batch["image"])))
        return PreparedBatch(micros=micros, total=len(batch["image"]))

    def to_device(self, staged: PreparedBatch) -> PreparedBatch:
        """Device side of ``prepare_batch``: the staged tensors copied to
        the device on the calling thread's current stream (``non_blocking``
        from pinned memory), the stream the step that reads them runs on."""
        micros = [({k: v.to(self.device, non_blocking=True) for k, v in fields.items()},
                   mask.to(self.device, non_blocking=True), n)
                  for fields, mask, n in staged.micros]
        return PreparedBatch(micros=micros, total=staged.total)

    def prepare_batch(self, batch: t.Dict[str, np.ndarray]) -> PreparedBatch:
        """A host batch padded per micro-batch and moved to the device
        (``v1t_tpu/training.py`` ``prepare_batch``)."""
        return self.to_device(self.stage_batch(batch))

    def train_step(self, mouse_id: str, batch: t.Union[t.Dict[str, np.ndarray], PreparedBatch],
                   acc_grads, update: bool, *, sample: t.Optional[bool] = None):
        """Gradient step over one mouse's batch (reference train_step,
        train.py:42-81), a host batch or a ``PreparedBatch`` already on the
        device. The gradients of its micro-batches are added to those
        accumulated so far (``acc_grads`` None: start from zero); with
        ``update`` AdamW steps on the sum and None is returned for the next
        cycle, otherwise the accumulated gradients (the parameters' ``.grad``
        by name). ``sample`` switches the readout's grid noise (default on).
        Returns (acc_grads, metrics summed over the micro-batches, as 0-dim
        tensors on the device). Under a grid the metrics are summed over the
        data ranks, the accumulated gradients are the rank's own, and the
        update sums them over the data axis first."""
        if not self._determinism_checked:
            config = self.config
            if config.input_shape is None:
                config = config.replace(input_shape=self.data_card.input_shape,
                                        ds_name=config.ds_name or self.data_card.ds_name)
            check_deterministic(config, self.device, self.core_frozen)
            self._determinism_checked = True
        if not isinstance(batch, PreparedBatch):
            batch = self.prepare_batch(batch)
        self.model.train()
        if acc_grads is None:
            self.optimizer.zero_grad(set_to_none=True)
        true_total = batch.total
        metrics: t.Dict[str, torch.Tensor] = {}
        for fields, mask, n in batch.micros:
            self._step_count += 1
            with self._scope():
                loss, reg_loss, _ = self._loss_terms(
                    mouse_id, fields, mask, true_total, n / true_total,
                    seed=step_seed(self.config.seed, self._step_count, self._data_rank),
                    sample=sample,
                )
                total = loss + reg_loss
                total.backward()
            for key, value in (("loss/loss", loss), ("loss/reg_loss", reg_loss),
                               ("loss/total_loss", total)):
                metrics[key] = metrics.get(key, 0.0) + value.detach()
        if self.mesh is not None:
            metrics = dict(zip(metrics, self.mesh.sum_values(list(metrics.values()))))
        if not update:
            return {name: p.grad for name, p in self.model.named_parameters()
                    if p.grad is not None}, metrics
        # a parameter this cycle did not reach steps with a zero gradient, as
        # optax's does (its moments decay)
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            self.mesh.sum_gradients([p for group in self.optimizer.param_groups
                                     for p in group["params"]])
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return None, metrics

    @torch.no_grad()
    def validation_step(self, mouse_id: str, batch: t.Dict[str, np.ndarray]):
        """Eval-mode losses over one mouse's batch: (metrics as floats,
        targets, predictions)."""
        self.model.eval()
        micro = self.config.effective_micro_batch_size
        true_total = len(batch["image"])
        sums: t.Dict[str, float] = {}
        targets, predictions = [], []
        for micro_batch in micro_batching(batch, micro):
            n = len(micro_batch["image"])
            padded, mask = self._local(*pad_batch(micro_batch, micro))
            fields = {k: self._tensor(padded[k]) for k in FIELDS}
            with self._scope():
                loss, reg_loss, y_pred = self._loss_terms(mouse_id, fields, self._tensor(mask),
                                                          true_total, n / true_total)
            values = (loss, reg_loss, loss + reg_loss)
            if self.mesh is not None:
                values = self.mesh.sum_values(values)
            for key, value in zip(("loss/loss", "loss/reg_loss", "loss/total_loss"), values):
                sums[key] = sums.get(key, 0.0) + float(value)
            targets.append(micro_batch["response"])
            predictions.append(self._global(y_pred)[:n].cpu().numpy())
        return sums, np.concatenate(targets), np.concatenate(predictions)

    @torch.inference_mode()
    def predict(self, mouse_id: str, batch: t.Dict[str, np.ndarray]) -> np.ndarray:
        """(B, N) float32 responses for a host batch with ``image``,
        ``behavior`` and ``pupil_center``."""
        self.model.eval()
        micro = self.config.effective_micro_batch_size
        outs = []
        for micro_batch in micro_batching(batch, micro):
            n = len(micro_batch["image"])
            padded, _ = self._local(*pad_batch(micro_batch, micro))
            with self._scope():
                y_pred, _, _ = self.model(
                    self._tensor(padded["image"]), mouse_id,
                    behaviors=self._tensor(padded["behavior"]),
                    pupil_centers=self._tensor(padded["pupil_center"]),
                )
            outs.append(self._global(y_pred)[:n].cpu().numpy())
        return np.concatenate(outs)


def restore_best(scheduler, trainer: Trainer) -> None:
    """Reload the best checkpoint into the trainer's model before the final
    test evaluation: parameters and buffers (BatchNorm's running statistics
    with the weights, as ``v1t_tpu/training.py`` insists), as the
    reference's full state_dict restore (reference scheduler.py:122-136).
    Under a grid the scheduler's first rank reads the checkpoint and every
    rank loads what it read (``Scheduler(mesh=...)``)."""
    scheduler.restore(trainer.model)


def compute_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    """Per-epoch validation metrics (reference train.py:28-39)."""
    m = float(np.sum(np.square(y_true - y_pred)))
    pl = float(np.sum(y_pred - y_true * np.log(y_pred + 1e-12)))
    corr = losses.correlation(y_pred, y_true, dim=0)
    return {
        "metrics/msse": m,
        "metrics/poisson_loss": pl,
        "metrics/single_trial_correlation": float(np.mean(corr)),
    }


def _device_prefetch(trainer: Trainer, iterator, depth: int = 2):
    """Stage batches ahead of the consumer: a producer thread pads each
    batch into (pinned) host tensors ``depth`` batches ahead; the consumer
    copies each to the device on its own stream as it takes it, so the
    step that reads the batch is ordered after its copy. The producer gives
    up once the consumer is gone (an abandoned epoch: NaN abort, interrupt)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    errors: list = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for mouse_id, batch in iterator:
                if stop.is_set() or not _put((mouse_id, trainer.stage_batch(batch))):
                    return
        except BaseException as exc:  # surfaced in the consumer
            errors.append(exc)
        finally:
            _put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            mouse_id, staged = item
            yield mouse_id, trainer.to_device(staged)
    finally:
        stop.set()
        try:  # release the batches still staged in the queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def train_epoch(trainer: Trainer, ds: t.Dict[str, BatchLoader], epoch: int,
                summary=None) -> dict:
    """One epoch over ``CycleLoaders`` with cross-mouse gradient
    accumulation and one update a cycle (reference train, train.py:84-116;
    the JAX loop's per-step branch). The step metrics stay on the device
    until ``log_metrics`` pulls them in one transfer."""
    mouse_ids = list(ds.keys())
    results: dict = {m: {} for m in mouse_ids}
    update_frequency = len(mouse_ids)
    acc = None
    for i, (mouse_id, batch) in enumerate(_device_prefetch(trainer, iter(CycleLoaders(ds)))):
        acc, metrics = trainer.train_step(mouse_id, batch, acc_grads=acc,
                                          update=(i + 1) % update_frequency == 0)
        for k, v in metrics.items():
            results[mouse_id].setdefault(k, []).append(v)
    return log_metrics(results, epoch=epoch, summary=summary, mode=0)


def validate(trainer: Trainer, ds: t.Dict[str, BatchLoader], epoch: int,
             summary=None) -> dict:
    """Validation epoch (reference validate, train.py:158-190)."""
    results = {}
    for mouse_id, loader in ds.items():
        mouse_result: dict = {}
        y_true, y_pred = [], []
        for batch in loader:
            metrics, targets, predictions = trainer.validation_step(mouse_id, batch)
            for k, v in metrics.items():
                mouse_result.setdefault(k, []).append(v)
            y_true.append(targets)
            y_pred.append(predictions)
        mouse_result.update(compute_metrics(y_true=np.vstack(y_true), y_pred=np.vstack(y_pred)))
        results[mouse_id] = mouse_result
    return log_metrics(results, epoch=epoch, summary=summary, mode=1)


def _materialize_metrics(results: dict) -> dict:
    """Every metric still on the device, pulled to the host in ONE stacked
    transfer (one sync an epoch, not one a step)."""
    leaves, paths = [], []
    for mouse_id, metrics in results.items():
        for key, value in metrics.items():
            if isinstance(value, list):
                for i, item in enumerate(value):
                    if torch.is_tensor(item):
                        paths.append((mouse_id, key, i))
                        leaves.append(item.float())
    if leaves:
        values = torch.stack(leaves).cpu().tolist()
        for (mouse_id, key, i), val in zip(paths, values):
            results[mouse_id][key][i] = float(val)
    return results


def log_metrics(results: dict, epoch: int, summary=None, mode: int = 0) -> dict:
    """Mean metrics per mouse, then across mice (reference
    utils/utils.py:340-387), with the metric-group prefix stripped."""
    results = _materialize_metrics(results)
    mouse_ids = list(results.keys())
    metrics = list(results[mouse_ids[0]].keys())
    for mouse_id in mouse_ids:
        for metric in metrics:
            value = results[mouse_id][metric]
            if isinstance(value, list):
                results[mouse_id][metric] = float(np.mean(value))
            if summary is not None:
                summary.scalar(f"{metric}/mouse{mouse_id}", value=results[mouse_id][metric],
                               step=epoch, mode=mode)
    overall = {}
    for metric in metrics:
        value = float(np.mean([results[m][metric] for m in mouse_ids]))
        overall[metric[metric.find("/") + 1:]] = value
        if summary is not None:
            summary.scalar(metric, value=value, step=epoch, mode=mode)
    return overall


def inference(trainer: Trainer, batches: t.Iterable[dict], mouse_id: str) -> t.Dict[str, np.ndarray]:
    """Forward pass over every batch of a loader (reference
    utils/utils.py:59-100): predictions, plus the batches' targets, image
    and trial ids where the batches carry them."""
    results: dict = {"predictions": [], "targets": [], "trial_ids": [], "image_ids": []}
    sources = {"targets": "response", "trial_ids": "trial_id", "image_ids": "image_id"}
    for batch in batches:
        results["predictions"].append(trainer.predict(mouse_id, batch))
        for key, field in sources.items():
            if field in batch:
                results[key].append(batch[field])
    return {k: np.concatenate(v, axis=0) for k, v in results.items() if v}


def evaluate(config: Config, trainer: Trainer, ds: t.Dict[str, BatchLoader], epoch: int = 0,
             summary=None, mode: int = 1, print_result: bool = False,
             save_result: t.Optional[str] = None) -> dict:
    """Challenge metrics per mouse and their averages; writes
    ``evaluation.yaml`` into ``save_result`` (reference
    utils/utils.py:103-199)."""
    metric_names = ["single_trial_correlation", "correlation_to_average", "feve"]
    results: dict = {k: {} for k in metric_names}
    for mouse_id, loader in ds.items():
        if mouse_id in ("S0", "S1") and loader.dataset.tier == "test":
            continue
        outputs = inference(trainer, loader, mouse_id)
        mouse_metric = Metrics(outputs, neuron_ids=loader.dataset.neuron_ids,
                               tier=loader.dataset.tier, hashed=loader.dataset.hashed)
        results["single_trial_correlation"][mouse_id] = (
            mouse_metric.single_trial_correlation(per_neuron=True))
        if mouse_metric.repeat_image and not mouse_metric.hashed:
            results["correlation_to_average"][mouse_id] = (
                mouse_metric.correlation_to_average(per_neuron=True))
            results["feve"][mouse_id] = mouse_metric.feve(per_neuron=True)

    for metric in metric_names:
        for mouse_id in results[metric]:
            results[metric][mouse_id] = float(np.mean(results[metric][mouse_id]))
            if summary is not None:
                summary.scalar(f"{metric}/mouse{mouse_id}", value=results[metric][mouse_id],
                               step=epoch, mode=mode)

    if getattr(config, "verbose", 1) and print_result:
        statement = ""
        for metric in metric_names:
            if results[metric]:
                statement += f"\n{metric}\n"
                statement += "".join(f"{k}: {v:.04f}\t" for k, v in results[metric].items())
        if statement:
            print(statement)

    overall = {}
    for metric in metric_names:
        values = list(results[metric].values())
        if values:
            average = float(np.mean(values))
            overall[metric] = average
            results[metric]["average"] = average
            if summary is not None:
                summary.scalar(f"{metric}/average", value=average, step=epoch, mode=mode)

    if save_result is not None:
        from v1t_tpu_torch.utils import yamlfile

        os.makedirs(save_result, exist_ok=True)
        yamlfile.dump(results, os.path.join(save_result, "evaluation.yaml"))
    return overall
