"""Parameter inversion: fit brunel ``(g, eta)`` from PSTH targets
(DESIGN.md §17).

The port of the reference package's ``diff/inverse.py``.  Given
per-neuron PSTH profiles recorded from a brunel network at unknown
``(g, eta)`` (inhibition/excitation weight ratio and external-drive
ratio), recover both by gradient descent on a differentiable rate loss
through the whole simulator: :func:`repro_torch.diff.rollout.rollout` on
the ``"flat"`` backend (the gradient path; the port's default backend is
``"cuda"``, whose kernels have no backward), with ``cfg.surrogate`` set and
the Poisson drive replaced by its diffusion re-parameterization, so that
the loss is differentiable in the drive rate too.

The reference's modelling choices, kept as they are:

* **Asynchronous operating point.**  The fit network runs brunel's
  topology at weaker coupling (``je = 16`` by default, the external rate
  rescaled through the ``nu_thr`` formula so that eta keeps its meaning):
  at the paper's coupling the quick geometry bursts in near-synchrony and
  gradients through hundreds of steps of it are chaotic.
* **Two drive conditions**, fitted with the same parameters: one profile
  leaves a flat valley where an eta shift compensates a g shift.
* **Per-neuron PSTH**: g acts through each neuron's inhibitory indegree,
  so the cross-neuron profile carries most of its information.

Every evaluation replays one noise array per condition (common random
numbers, as the reference replays one key): drawn once from the seed on
the CPU, so that a run on the card uses a CPU run's noise, or given
(``noise=``, how the parity tests inject the reference's draws).

Optimization is two-stage: Adam (the :mod:`repro_torch.train` AdamW with a
host-side cosine lr) in log-parameter space into the basin, then an
eta-profiled g scan: for each candidate g, re-minimize eta with a
multi-resolution 1-D scan, then compare the minima.  The scans need no
gradient and run under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import builder, engine, models, snn
from repro_torch.core.device import resolve_device
from repro_torch.diff import rollout as rollout_mod
from repro_torch.train import optimizer as opt_mod

__all__ = ["BrunelInversion", "InversionResult", "invert_brunel",
           "DEFAULT_JE"]

#: default fit-network coupling [pA]; weaker than the paper's 32 pA on
#: purpose - see the module docstring (asynchronous operating point).
DEFAULT_JE = 16.0


@dataclasses.dataclass(frozen=True)
class InversionResult:
    """Outcome of :meth:`BrunelInversion.fit`."""

    g: float
    eta: float
    true_g: float
    true_eta: float
    init_g: float
    init_eta: float
    final_loss: float
    loss_history: tuple[float, ...]
    n_evals: int

    @property
    def rel_error(self) -> dict[str, float]:
        return {"g": abs(self.g - self.true_g) / abs(self.true_g),
                "eta": abs(self.eta - self.true_eta) / abs(self.true_eta)}


class BrunelInversion:
    """Differentiable brunel forward model + targets + two-stage fitter.

    Builds the quick-geometry brunel graph once on ``device`` (the card
    unless ``device="cpu"``); ``observe`` re-weights the same connectivity
    from ``(log_g, log_eta)`` (``weights = +-exp(log_g) * je`` by source
    channel, ``ext_rate = exp(log_eta) * nu_thr * cond``), so one build
    serves every evaluation.  ``noise`` is one ``(n_steps, n_local)``
    array of the diffusion drive's normal draws, used for every condition,
    or a mapping from condition to such an array; by default one array is
    drawn from ``seed`` by a CPU generator, a step at a time as the engine
    draws it.
    """

    def __init__(self, *, scale: float = 0.02, dt: float = 0.1,
                 n_steps: int = 600, n_bins: int = 6,
                 je: float = DEFAULT_JE,
                 conditions: tuple[float, ...] = (1.0, 1.6),
                 surrogate: str = "fast_sigmoid",
                 checkpoint_every: int | None = 25,
                 true_g: float = 5.0, true_eta: float = 2.0, seed: int = 0,
                 noise=None, device="cuda"):
        if n_steps % n_bins:
            raise ValueError(f"n_steps={n_steps} must divide into "
                             f"n_bins={n_bins} equal PSTH bins")
        dev = resolve_device(device)
        self.device = dev
        spec, _ = models.brunel(scale=scale, g=true_g, eta=true_eta)
        graph = builder.build_shards(
            spec, builder.decompose(spec, 1))[0].to(dev)
        self.graph = graph
        self.table = snn.make_param_table(list(spec.groups), dt, device=dev)
        self.state0 = engine.init_state(graph, list(spec.groups), seed,
                                        device=dev)
        self.cfg = engine.EngineConfig(
            dt=dt, sweep="flat", surrogate=surrogate,
            external_drive_mode="diffusion")
        self.n_steps, self.n_bins = n_steps, n_bins
        self.je, self.conditions = je, tuple(conditions)
        self.true_g, self.true_eta = true_g, true_eta
        self.checkpoint_every = checkpoint_every
        lif = spec.groups[0]
        # rate that drives a free LIF to threshold; eta is in these units
        self.nu_thr_hz = (1e3 * (lif.v_th - lif.e_l) * lif.c_m
                          / (je * lif.tau_m * lif.tau_syn_ex))
        self._valid = graph.delay > 0        # padding rows carry delay 0
        self._inh = graph.channel == 1
        if noise is None:
            gen = torch.Generator()
            gen.manual_seed(int(seed))
            noise = torch.stack([
                torch.randn((graph.n_local,), generator=gen)
                for _ in range(n_steps)])
        if not isinstance(noise, dict):
            noise = dict.fromkeys(self.conditions, noise)
        self.noise = {c: torch.as_tensor(noise[c], dtype=torch.float32,
                                         device=dev)
                      for c in self.conditions}
        true = self._pack(true_g, true_eta)
        with torch.no_grad():
            self.targets = {c: self.observe(true, c)
                            for c in self.conditions}

    def _pack(self, g: float, eta: float) -> dict[str, torch.Tensor]:
        f = lambda x: torch.tensor(math.log(x), dtype=torch.float32,
                                   device=self.device)
        return {"log_g": f(g), "log_eta": f(eta)}

    def observe(self, params, cond: float) -> torch.Tensor:
        """Per-neuron PSTH ``(n_bins, n_local)`` [Hz] at drive multiplier
        ``cond``; differentiable in ``params``."""
        g_ratio = torch.exp(params["log_g"])
        eta = torch.exp(params["log_eta"])
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        w = torch.where(self._valid,
                        torch.where(self._inh, -g_ratio * self.je,
                                    torch.full_like(zero, self.je)),
                        zero)
        graph = dataclasses.replace(
            self.graph,
            ext_rate=(cond * eta * self.nu_thr_hz).expand(
                self.graph.n_local))
        state = dataclasses.replace(self.state0,
                                    weights=w.to(torch.float32))
        _, spikes = rollout_mod.rollout(
            state, graph, self.table, self.cfg, self.n_steps,
            checkpoint_every=self.checkpoint_every,
            drive_noise=self.noise[cond], device=self.device)
        binned = spikes.reshape(
            self.n_bins, self.n_steps // self.n_bins, -1).mean(dim=1)
        return binned * (1e3 / self.cfg.dt)

    def _loss(self, params) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for cond in self.conditions:
            target = self.targets[cond]
            diff = self.observe(params, cond) - target
            total = total + (torch.mean(torch.square(diff))
                             / torch.mean(torch.square(target)))
        return total

    def loss_and_grad(self, params):
        """``(loss, {"log_g": d/dlog_g, "log_eta": d/dlog_eta})``."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = self._loss(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    @torch.no_grad()
    def _loss_only(self, params) -> float:
        return float(self._loss(params))

    def loss(self, g: float, eta: float) -> float:
        return self._loss_only(self._pack(g, eta))

    def _profile_eta(self, log_g, log_eta0,
                     radii: tuple[float, ...], points: int):
        """Minimize the loss over eta at FIXED g: a multi-resolution 1-D
        scan in log-eta, re-centered and shrunk each round.  Returns
        ``(profiled_loss, log_eta*, n_evals)``."""
        best_e = log_eta0
        best_l = self._loss_only({"log_g": log_g, "log_eta": log_eta0})
        n_evals = 1
        for radius in radii:
            center = best_e
            for off in torch.linspace(-radius, radius, points,
                                      device=self.device):
                cand_e = center + off
                loss = self._loss_only({"log_g": log_g, "log_eta": cand_e})
                n_evals += 1
                if loss < best_l:
                    best_l, best_e = loss, cand_e
        return best_l, best_e, n_evals

    def fit(self, init_g: float, init_eta: float, *,
            adam_iters: int = 40, lr: float = 0.04,
            g_rounds: tuple[tuple[float, int], ...] = ((0.15, 7),
                                                       (0.04, 5)),
            eta_radii: tuple[float, ...] = (0.004, 0.0012, 0.0004),
            eta_points: int = 5) -> InversionResult:
        """Two-stage fit; see the module docstring.  ``g_rounds`` are
        ``(log_radius, points)`` for the successive profiled g scans (pass
        ``()`` to skip profiling); ``eta_radii``/``eta_points`` control the
        eta re-minimization run for every g candidate.  The incumbent is
        always kept, so the polish is monotone in loss."""
        params = self._pack(init_g, init_eta)
        tcfg = TrainConfig(optimizer="adamw", lr=lr, weight_decay=0.0,
                           grad_clip=0.0)
        opt_state = opt_mod.init_opt_state(tcfg, params)
        history: list[float] = []
        best_loss, best = float("inf"), dict(params)
        n_evals = 0
        for i in range(adam_iters):
            loss, grads = self.loss_and_grad(params)
            loss = float(loss)
            n_evals += 1
            history.append(loss)
            if loss < best_loss:
                best_loss, best = loss, dict(params)
            # host-side cosine decay; apply_updates itself has a fixed lr
            lr_i = lr * 0.5 * (1.0 + math.cos(math.pi * i / adam_iters))
            params, opt_state = opt_mod.apply_updates(
                dataclasses.replace(tcfg, lr=lr_i), params, grads,
                opt_state, i)
        for radius, points in g_rounds:
            center = dict(best)
            for dg in torch.linspace(-radius, radius, points,
                                     device=self.device):
                if float(dg) == 0.0:
                    continue     # the incumbent is already scored
                cand_g = center["log_g"] + dg
                loss, cand_e, evals = self._profile_eta(
                    cand_g, center["log_eta"], eta_radii, eta_points)
                n_evals += evals
                if loss < best_loss:
                    best_loss = loss
                    best = {"log_g": cand_g, "log_eta": cand_e}
            history.append(best_loss)
        return InversionResult(
            g=float(torch.exp(best["log_g"])),
            eta=float(torch.exp(best["log_eta"])),
            true_g=self.true_g, true_eta=self.true_eta,
            init_g=init_g, init_eta=init_eta,
            final_loss=best_loss, loss_history=tuple(history),
            n_evals=n_evals)


def invert_brunel(init_g: float = 4.0, init_eta: float = 2.5,
                  **kwargs) -> InversionResult:
    """One-call inversion on the quick geometry: build, target, fit.

    ``kwargs`` split between :class:`BrunelInversion` (geometry, loss,
    ``noise``, ``device``) and :meth:`~BrunelInversion.fit` (optimization)
    by name.  The default init is the >= 20 % perturbed point of the
    reference's acceptance fit.
    """
    fit_keys = {"adam_iters", "lr", "g_rounds", "eta_radii", "eta_points"}
    fit_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in fit_keys}
    problem = BrunelInversion(**kwargs)
    return problem.fit(init_g, init_eta, **fit_kwargs)
