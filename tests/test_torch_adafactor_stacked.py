"""Adafactor on a port ``DecoderLM`` (and ``EncDecLM``) against the
reference's update of its stacked tree, on the CPU.

The reference stacks each period slot's layers ``(n_periods, ...)`` (an
encoder-decoder each stack's, ``(L, ...)``);
``train.optimizer.update_module`` updates the port's per-layer leaves of
one slot as that stacked leaf (its moments factored over the stacked
shape's last two dims, the RMS clip over every layer of the slot) and
keeps the state in the stacked shapes (``init_opt_state`` on the module).

Both packages start from the reference's ``m.init(key, dtype=float32)``
tree (carried across by ``convert.lm_params_from_numpy`` or
``encdec_params_from_numpy``) and take two
steps on the same seeded gradient trees (renamed the same way).  The
parameters and every ``v_row`` / ``v_col`` leaf must agree within
``1e-6`` relative (of each leaf's max).  The second step's gradients are
ten times the first's, so the update's RMS passes 1 and the clip binds;
a case at a tenth keeps it below 1.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models.model import build_model as ref_build_model
from repro.train import optimizer as ref_opt
from repro_torch import configs, convert
from repro_torch.configs.base import TrainConfig
from repro_torch.models import encdec, transformer
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_mod

CPU = "cpu"
REL = 1e-6
LR = 1e-2
ARCHS = ("qwen3-moe-30b-a3b", "qwen2.5-3b", "whisper-tiny")


def _ref_setup(arch):
    cfg = ref_configs.get_smoke(arch)
    m = ref_build_model(cfg)
    params = m.init(jax.random.key(0), dtype=jnp.float32)
    return cfg, params


def _to_port(tree, cfg):
    """A reference tree shaped like the parameters, by the port's names."""
    conv = (convert.encdec_params_from_numpy if cfg.family == "audio"
            else convert.lm_params_from_numpy)
    return conv(jax.tree.map(np.asarray, tree), cfg, device=CPU,
                dtype=torch.float32)


def _port_module(arch, ref_params):
    cfg = configs.get_smoke(arch)
    ctor = encdec.EncDecLM if cfg.family == "audio" else \
        transformer.DecoderLM
    mod = ctor(cfg, device=CPU, dtype=torch.float32)
    mod.load_state_dict(_to_port(ref_params, cfg))
    return cfg, mod


def _grads(ref_params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
        ref_params)


def _state_leaves(cfg, state_part) -> dict:
    """The reference's ``v_row`` / ``v_col`` tree by the port's names: a
    period slot's stacked leaf as ``period.{j}.<leaf>``, a prefix layer's
    as ``layers.{i}.<leaf>``."""
    out = {}
    if cfg.family == "audio":
        return convert._flatten(state_part, "", out)
    for key in ("embed", "final_norm", "unembed"):
        if key in state_part:
            convert._flatten(state_part[key], key + ".", out)
    for i, layer in enumerate(state_part.get("prefix", [])):
        convert._flatten(layer, f"layers.{i}.", out)
    for j, slot in enumerate(state_part["period"]):
        convert._flatten(slot, f"period.{j}.", out)
    return out


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().cpu().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, (what, err, scale)


def _two_steps(arch, second_scale):
    rcfg, rparams = _ref_setup(arch)
    cfg, mod = _port_module(arch, rparams)
    rt = RefTrainConfig(optimizer="adafactor", lr=LR, weight_decay=0.0)
    tcfg = TrainConfig(optimizer="adafactor", lr=LR, weight_decay=0.0)
    rstate = ref_opt.init_opt_state(rt, rparams)
    state = opt_mod.init_opt_state(tcfg, mod)
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    for step, scale in enumerate((1.0, second_scale)):
        g = _grads(rparams, 10 + step, scale)
        if step == 1:
            before = {k: v.clone() for k, v in mod.state_dict().items()}
        rparams, rstate = ref_opt.apply_updates(
            rt, rparams, jax.tree.map(jnp.asarray, g), rstate,
            jnp.asarray(step))
        pg = _to_port(g, cfg)
        opt_mod.update_module(tcfg, mod, pg, state, step)
        assert not pg, "update_module leaves no gradient behind"
    return cfg, mod, state, rparams, rstate, before


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("second_scale", (10.0, 0.1),
                         ids=("clip_binds", "clip_free"))
def test_two_adafactor_steps_equal_reference(arch, second_scale):
    cfg, mod, state, rparams, rstate, before = _two_steps(arch,
                                                          second_scale)
    want = _to_port(rparams, cfg)
    got = mod.state_dict()
    assert want.keys() == got.keys()
    for name in want:
        _close(got[name], want[name].numpy(), name)
    for part in ("v_row", "v_col"):
        ref_leaves = _state_leaves(cfg, jax.tree.map(np.asarray,
                                                     rstate[part]))
        assert ref_leaves.keys() == state[part].keys(), part
        for name, arr in ref_leaves.items():
            _close(state[part][name], arr, f"{part} {name}")
    # the second step's clip: the stacked update's RMS is lr exactly
    # where the clip binds, below it everywhere where it does not
    rms = {}
    for slot, names in mod.period_slots().items():
        d = torch.stack([got[n] - before[n] for n in names])
        rms[slot] = float(torch.sqrt(torch.mean(d.double() ** 2))) / LR
    if second_scale > 1:
        bound = [s for s, r in rms.items() if abs(r - 1.0) < 1e-4]
        assert len(bound) == len(rms), rms
    else:
        assert max(rms.values()) < 0.99, rms


def test_module_state_is_stacked():
    """``init_opt_state`` on a module gives the reference's stacked
    shapes; on its flat tree it keeps one leaf per layer, which the
    module's update refuses."""
    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    mod = transformer.DecoderLM(cfg, device=CPU, dtype=torch.float32)
    tcfg = TrainConfig(optimizer="adafactor")
    state = opt_mod.init_opt_state(tcfg, mod)
    _, _, n_periods = transformer.period_structure(cfg)
    assert state["v_row"]["period.0.norm1.scale"].shape == (n_periods,)
    assert state["v_col"]["period.0.norm1.scale"].shape == (cfg.d_model,)
    e = cfg.moe
    assert state["v_row"]["period.0.moe.wi_gate"].shape == (
        n_periods, e.n_experts, cfg.d_model)
    assert state["v_col"]["period.0.moe.wi_gate"].shape == (
        n_periods, e.n_experts, e.expert_ff)
    assert not any(k.startswith("layers.") for k in state["v_row"])
    flat = opt_mod.init_opt_state(tcfg, loop.param_tree(mod))
    grads = {k: torch.zeros_like(v) for k, v in mod.named_parameters()}
    with pytest.raises(ValueError, match="stacked state"):
        opt_mod.update_module(tcfg, mod, grads, flat, 0)
