"""Surrogate-gradient SNN classifier on the train substrate (DESIGN.md §17).

The port of the reference package's ``diff/classify.py``: rate-coded input
spike trains -> one hidden layer of the LIF dynamics the simulator
integrates (:func:`repro_torch.core.snn.lif_step` with the surrogate spike
of :mod:`repro_torch.diff.surrogate`) -> a linear readout of hidden spike
counts.  The model exposes the ``init(generator, dtype)`` /
``loss(params, batch)`` interface that
:func:`repro_torch.train.loop.make_train_step` takes, so AdamW and
gradient clipping come from :mod:`repro_torch.train`.

* Signed input weights split into the excitatory and inhibitory channels
  (``relu(w)`` -> ``input_ex``, ``relu(-w)`` -> ``input_in``); both are
  filtered by the LIF synapse.
* The reference ``vmap``s one sample's time loop over the batch.  Here the
  whole batch steps at once as one flat ``(B * n_hidden,)`` LIF state
  (every neuron in group 0): ``lif_step`` is elementwise, so each sample's
  neurons follow their own trajectory.
* The readout takes mean hidden spike counts - surrogate floats, so the
  cross-entropy's gradient reaches ``w_in`` through every hidden spike.

The synthetic task (noisy class prototypes, rate-coded) needs no data
files; chance is ``1 / n_classes``.  Draws come from a
``torch.Generator`` where the reference splits keys, so the port's
dataset and init are its own; the parity tests carry the reference's
across (:mod:`repro_torch.convert`).  :func:`train_classifier` draws them
on the CPU from its seed and moves them to the model's device, so a run on
the card starts from the data and init of a run on the CPU.

Data parallelism is the reference's batch sharding over a 1-D
``("data",)`` mesh of every device, run as a process mesh
(:class:`~repro_torch.launch.mesh.ProcessMesh`): every process of an
initialised ``torch.distributed`` world draws the same data, init and
epoch order from the seed, trains on its contiguous block of each batch
(``launch.train.batch_block``), and the train step averages the
gradients over ``data`` (``train.loop``'s replicated leaves), so every
process holds the same parameters.  The backend is the world's: gloo
where processes share a card (or on the CPU), nccl where each has its
own.  One process driving several cards is not ported (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as tdist

from repro_torch.configs.base import TrainConfig
from repro_torch.core import snn
from repro_torch.core.device import resolve_device
from repro_torch.diff import surrogate as surrogate_mod
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.launch.train import batch_block
from repro_torch.sharding import rules
from repro_torch.train import loop as loop_mod

__all__ = ["SNNClassifier", "make_prototypes", "make_dataset",
           "data_mesh", "train_classifier"]


@dataclasses.dataclass(frozen=True)
class SNNClassifier:
    """Rate-coded spike train -> LIF hidden layer -> spike-count softmax.

    ``init`` returns the params (a dict of tensors), ``loss(params,
    batch)`` returns ``(loss, {"loss", "accuracy"})`` (0-d tensors) for
    batches ``{"spikes": (B, T, n_in), "label": (B,)}``.  The parameter
    table lives on ``device`` (the card unless ``device="cpu"``).
    """

    n_in: int = 40
    n_hidden: int = 64
    n_classes: int = 8
    n_steps: int = 60
    dt: float = 1.0
    surrogate: str = "fast_sigmoid"
    #: input-weight init scale [pA]; sized so a typical rate-coded sample
    #: drives hidden neurons at tens-to-hundreds of Hz from init
    w_in_scale: float = 150.0
    #: readout input gain: mean spike counts live in [0, ~0.3], so a
    #: fixed O(10) gain puts readout activations at O(1) from init
    readout_gain: float = 6.0
    lif: snn.LIFParams = dataclasses.field(
        default_factory=lambda: snn.LIFParams(
            tau_m=10.0, c_m=250.0, e_l=-65.0, v_th=-50.0, v_reset=-65.0,
            t_ref=1.0, tau_syn_ex=2.0, tau_syn_in=2.0))
    device: str = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "_dev", dev)
        object.__setattr__(self, "_table", snn.make_param_table(
            [self.lif], dt=self.dt, device=dev))
        object.__setattr__(
            self, "_spike_fn", surrogate_mod.get_surrogate(self.surrogate))

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Params from ``generator`` (on any device), placed on the model's:
        ``w_in`` (n_in, n_hidden), ``w_out`` (n_hidden, n_classes),
        ``b_out`` (n_classes,)."""
        draw = lambda *shape: torch.randn(shape, generator=generator,
                                          device=generator.device)
        w_in = self.w_in_scale * draw(self.n_in, self.n_hidden)
        w_out = draw(self.n_hidden, self.n_classes) / math.sqrt(
            self.n_hidden)
        return {"w_in": w_in.to(self._dev, dtype),
                "w_out": w_out.to(self._dev, dtype),
                "b_out": torch.zeros((self.n_classes,), dtype=dtype,
                                     device=self._dev)}

    def apply(self, params, spikes):
        """Logits ``(B, n_classes)`` for rasters ``(B, n_steps, n_in)``."""
        w_in = params["w_in"].to(torch.float32)
        w_ex, w_inh = torch.relu(w_in), torch.relu(-w_in)
        b = spikes.shape[0]
        n = b * self.n_hidden
        f32 = lambda v: torch.full((n,), v, dtype=torch.float32,
                                   device=self._dev)
        zi = torch.zeros((n,), dtype=torch.int32, device=self._dev)
        state = snn.NeuronState(v_m=f32(self.lif.e_l), syn_ex=f32(0.0),
                                syn_in=f32(0.0), ref_count=zi,
                                spike=f32(0.0), group_id=zi)
        hidden = []
        for t in range(spikes.shape[1]):
            x_t = spikes[:, t].to(torch.float32)
            state = snn.lif_step(state, self._table,
                                 input_ex=(x_t @ w_ex).reshape(-1),
                                 input_in=(x_t @ w_inh).reshape(-1),
                                 spike_fn=self._spike_fn)
            hidden.append(state.spike)
        # surrogate floats: the counts carry the gradient
        counts = torch.stack(hidden).mean(dim=0).reshape(b, self.n_hidden)
        return (self.readout_gain * counts
                @ params["w_out"].to(torch.float32)
                + params["b_out"].to(torch.float32))

    def loss(self, params, batch):
        logits = self.apply(params, batch["spikes"])
        labels = batch["label"].long()
        logp = torch.log_softmax(logits, dim=1)
        nll = -torch.take_along_dim(logp, labels[:, None], dim=1).mean()
        acc = (torch.argmax(logits, dim=1) == labels).to(
            torch.float32).mean()
        return nll, {"loss": nll, "accuracy": acc}


def make_prototypes(generator: torch.Generator,
                    model: SNNClassifier) -> torch.Tensor:
    """Class intensity prototypes ``(n_classes, n_in)`` in ``[0, 1)``,
    drawn once and shared by every split (train and eval must code the same
    classes); on the generator's device."""
    return torch.rand((model.n_classes, model.n_in), generator=generator,
                      device=generator.device)


def make_dataset(generator: torch.Generator, model: SNNClassifier,
                 n_samples: int, protos, *, noise: float = 0.15,
                 max_p: float = 0.35):
    """Synthetic rate-coding task: a sample jitters its class prototype
    (from :func:`make_prototypes`) with Gaussian noise and draws Bernoulli
    spikes at ``intensity * max_p`` per step.  Labels are round-robin
    (balanced).  Returns ``{"spikes": (n, T, n_in) float32, "label": (n,)
    int32}`` on the generator's device."""
    dev = generator.device
    labels = torch.arange(n_samples, dtype=torch.int32,
                          device=dev) % model.n_classes
    x = torch.clamp(protos[labels.long()] + noise * torch.randn(
        (n_samples, model.n_in), generator=generator, device=dev), 0.0, 1.0)
    u = torch.rand((n_samples, model.n_steps, model.n_in),
                   generator=generator, device=dev)
    spikes = (u < (max_p * x)[:, None, :]).to(torch.float32)
    return {"spikes": spikes, "label": labels}


def data_mesh(device: torch.device):
    """The process mesh a data-parallel run lays its batches over: the
    current ``rules.use_mesh`` process mesh where it has a ``data`` axis,
    else ``("data",)`` over the whole world; None with no world or a world
    of one process (where one process driving several cards raises)."""
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    if world == 1:
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            raise NotImplementedError(
                "data_parallel from one process over more than one card is "
                "not ported (ROADMAP Queue 1 item 9); run one process a "
                "card as a torch.distributed world")
        return None
    ctx = rules.current_mesh()
    if (ctx is not None and hasattr(ctx.mesh, "members")
            and "data" in ctx.mesh.axis_names):
        return ctx.mesh
    return ProcessMesh(("data",), (world,))


def train_classifier(model: SNNClassifier, tcfg: TrainConfig, *,
                     n_train: int = 512, n_eval: int = 256,
                     batch_size: int = 64, epochs: int = 1, seed: int = 0,
                     data_parallel: bool = False):
    """Train on the synthetic task, on the model's device; returns
    ``(params, history)``, ``history`` a list of per-epoch dicts ending
    with the held-out ``eval_accuracy``.

    ``data_parallel=True`` is the reference's batch sharding over every
    device: in a ``torch.distributed`` world of more than one process
    each process trains on its block of every batch over
    :func:`data_mesh` (module docstring), and evaluates the whole eval
    set, so ``history`` is the same on every process; with no world it
    changes nothing, as the reference's does on one device.  A
    ``batch_size`` that the batch axes do not divide raises."""
    if n_train % batch_size:
        raise ValueError(f"n_train={n_train} must be a multiple of "
                         f"batch_size={batch_size}")
    dev = model._dev
    mesh = data_mesh(dev) if data_parallel else None
    gen = torch.Generator()     # on the CPU: the same draws on any device
    gen.manual_seed(int(seed))
    params, opt_state = loop_mod.init_train_state(model, tcfg, gen)
    protos = make_prototypes(gen, model)
    to_dev = lambda d: {k: v.to(dev) for k, v in d.items()}
    train = to_dev(make_dataset(gen, model, n_train, protos))
    evald = to_dev(make_dataset(gen, model, n_eval, protos))
    step_fn = loop_mod.make_train_step(model, tcfg)

    history = []
    n_batches = n_train // batch_size
    for epoch in range(epochs):
        order = torch.randperm(n_train, generator=gen).to(dev)
        losses, accs = [], []
        for b in range(n_batches):
            idx = order[b * batch_size:(b + 1) * batch_size]
            batch = {k: v[idx] for k, v in train.items()}
            if mesh is not None:     # a batch_size the mesh cannot cut raises
                batch = {k: batch_block(v, mesh) for k, v in batch.items()}
            with (contextlib.nullcontext() if mesh is None
                  else rules.use_mesh(mesh)):
                params, opt_state, metrics = step_fn(
                    params, opt_state, batch, epoch * n_batches + b)
            losses.append(float(metrics["loss"]))
            accs.append(float(metrics["accuracy"]))
        with torch.no_grad():
            _, eval_metrics = model.loss(params, evald)
        history.append({
            "epoch": epoch,
            "train_loss": sum(losses) / len(losses),
            "train_accuracy": sum(accs) / len(accs),
            "eval_accuracy": float(eval_metrics["accuracy"]),
        })
    return params, history
