"""The port's entry points (``repro_torch.examples``) against the
repository's scripts (``examples/*.py``), on the CPU at small sizes.

Each reference script is loaded from ``examples/`` by path, its ``main``
run with ``sys.argv`` patched and its standard output captured; the
port's module runs the same flags with ``--device cpu``.

* flags: every flag of each script, with its name and default, in the
  port's parser (``--sweep``'s default and the added ``--device`` and
  ``--grid`` excepted);
* ``run_scenario --model izhikevich | adex``: the drive-free demo
  networks are deterministic over 120 steps, so the printed population
  counts equal the reference's;
* the Potjans-Diesmann microcircuit stepped 120 steps against the
  reference with its Poisson draws injected: identical rasters;
* ``run_scenario`` adds nothing to ``engine.run``: its counts equal the
  run's for the same seed, bitwise; on a grid of shards the demo
  networks' per-neuron counts equal the one-shard run's;
* ``simulate_marmoset`` at 1x1 and on a 2x2 grid: the checkpoints kept
  match the reference's manager, the restore is bitwise;
* ``serve_snn`` with and without eviction: statuses and ``stats()`` as
  the reference prints them;
* ``serve_lm``, ``train_lm`` and ``quickstart``'s ``lm_demo`` on the
  reference's ``m.init(jax.random.key(0))`` carried across by
  ``repro_torch.convert``: the same tokens, losses within 1e-5;
* ``fit_brunel`` hands ``invert_brunel`` the reference's arguments;
* no module of the port, and not ``chip_smoke.py``, imports JAX or the
  reference package.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import argparse
import contextlib
import dataclasses
import importlib
import io
import re
import runpy
import sys
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ModelConfig as RefModelConfig
from repro.core import engine as ref_engine
from repro.core import models as ref_models
from repro.diff import inverse as ref_inverse
from repro.models.model import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.checkpoint.manager import state_items
from repro_torch.core import builder, engine, models, neuron_models
from repro_torch.diff import inverse
from repro_torch.models import transformer

from test_torch_engine import (_port_graph, _ref_leaves, _ref_setup,
                               _reference_drives)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
NAMES = ("quickstart", "run_scenario", "simulate_marmoset", "serve_snn",
         "fit_brunel", "serve_lm", "train_lm")
#: flags the port adds, with their defaults
ADDED = {"--device": "cuda", "--grid": (1, 1)}
#: defaults the port changes: the hand-written kernels' backend
CHANGED = {"--sweep": ("flat", "cuda")}


def port(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def ref_main(name):
    """The reference script's ``main``, its module run under another name
    than ``__main__`` (its globals are ``main.__globals__``)."""
    return runpy.run_path(str(EXAMPLES / f"{name}.py"),
                          run_name=f"reference_{name}")["main"]


def run_ref(name, argv, **patch):
    """Run the reference script's ``main`` with ``argv``; ``patch``
    replaces names in its globals.  Returns (stdout, return value)."""
    main = ref_main(name)
    main.__globals__.update(patch)
    buf = io.StringIO()
    with mock.patch.object(sys, "argv", [f"{name}.py", *argv]), \
            contextlib.redirect_stdout(buf):
        rc = main()
    return buf.getvalue(), rc


def run_port(name, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = port(name).main([*argv, "--device", CPU], **kw)
    return buf.getvalue(), rec


# --------------------------------------------------------------------------
# flags
# --------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def ref_parser(name):
    """The script's ``ArgumentParser`` as its ``main`` builds it (None for
    a script without flags)."""
    if "ArgumentParser" not in (EXAMPLES / f"{name}.py").read_text():
        return None
    got = []

    def grab(self, args=None, namespace=None):
        got.append(self)
        raise _Parsed

    main = ref_main(name)
    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab), \
            mock.patch.object(sys, "argv", [name]):
        with pytest.raises(_Parsed):
            main()
    return got[0]


def flags(parser) -> dict:
    """``{longest option string: (default, choices, nargs, takes value)}``."""
    if parser is None:
        return {}
    return {max(a.option_strings, key=len): (a.default, a.choices, a.nargs,
                                             a.nargs != 0)
            for a in parser._actions
            if a.option_strings and not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("name", NAMES)
def test_flags_match_reference(name):
    ref, got = flags(ref_parser(name)), flags(port(name).build_parser())
    for flag, want in ref.items():
        assert flag in got, f"{name}: {flag} missing"
        if flag in CHANGED:
            assert (want[0], got[flag][0]) == CHANGED[flag]
            assert got[flag][1:] == want[1:], flag
        else:
            assert got[flag] == want, flag
    extra = set(got) - set(ref)
    assert extra <= set(ADDED), f"{name}: unexpected flags {extra}"
    assert "--device" in extra
    for flag in extra:
        assert got[flag][0] == ADDED[flag], flag
    # each port module is a CLI: its --help exits 0
    with pytest.raises(SystemExit) as e, \
            contextlib.redirect_stdout(io.StringIO()):
        port(name).build_parser().parse_args(["--help"])
    assert e.value.code == 0


@pytest.mark.parametrize("name", NAMES)
def test_cuda_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"fit_brunel": ["--smoke"]}.get(name, [])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"), \
            contextlib.redirect_stdout(io.StringIO()):
        port(name).main(argv)


# --------------------------------------------------------------------------
# run_scenario
# --------------------------------------------------------------------------

def _rate_lines(out: str) -> list:
    """The population and total lines of ``run_scenario``'s output."""
    return [ln for ln in out.splitlines()
            if re.match(r"  \S+\s+n=\s*\d+ rate=", ln)
            or ln.startswith("  total:")]


@pytest.mark.parametrize("model", ["izhikevich", "adex"])
def test_model_demo_counts_equal_reference(model):
    argv = ["--model", model, "--scale", "0.02", "--steps", "120",
            "--sweep", "flat"]
    ref_out, _ = run_ref("run_scenario", argv)
    out, rec = run_port("run_scenario", argv)
    assert rec["total_spikes"] > 100, "vacuous: the demo net barely spiked"
    assert _rate_lines(out) == _rate_lines(ref_out)
    assert len(_rate_lines(out)) == 3
    assert out.endswith("ok\n") and ref_out.endswith("ok\n")


@pytest.mark.parametrize("sweep", ["flat", "cuda"])
def test_microcircuit_matches_reference_with_injected_drive(sweep):
    """``microcircuit(0.02)``, 120 steps from one random state around
    threshold (from rest the column is silent for about 110 steps), the
    reference's own Poisson draws injected: identical rasters, voltages
    within fp32 tolerance."""
    ref_spec, _ = ref_models.microcircuit(0.02)
    g_ref, table_ref, st_ref = _ref_setup(ref_spec)
    v0 = np.random.default_rng(5).uniform(-56.0, -49.5, g_ref.n_local)
    st_ref = dataclasses.replace(st_ref, neurons=dataclasses.replace(
        st_ref.neurons, v_m=jnp.asarray(v0, jnp.float32)))
    n = 120
    gd = g_ref.device_arrays()
    cfg_ref = ref_engine.EngineConfig(dt=0.1, sweep="flat")
    fin_ref, sp_ref = jax.jit(
        lambda s: ref_engine.run(s, gd, table_ref, cfg_ref, n))(st_ref)

    spec, stdp = models.microcircuit(0.02)
    assert stdp is None and spec.n_neurons == ref_spec.n_neurons
    g = _port_graph(g_ref)
    st = convert.state_from_numpy(_ref_leaves(st_ref), g, sweep=sweep,
                                  device=CPU)
    drive = torch.from_numpy(_reference_drives(g_ref, st_ref, n))
    table = torch.from_numpy(np.array(table_ref))
    cfg = engine.EngineConfig(dt=0.1, sweep=sweep)
    fin, sp = engine.run(st, g, table, cfg, n, drive=drive, device=CPU)

    sp_ref = np.asarray(sp_ref)
    assert sp_ref.sum() > 100 and drive.abs().sum() > 0, "vacuous"
    np.testing.assert_array_equal(sp.numpy(), sp_ref)
    np.testing.assert_allclose(fin.neurons.v_m.numpy(),
                               np.asarray(fin_ref.neurons.v_m), atol=1e-4)
    np.testing.assert_allclose(fin.neurons.syn_ex.numpy(),
                               np.asarray(fin_ref.neurons.syn_ex),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("scenario,scale,sweep", [
    ("brunel", 0.02, "cuda"),
    ("hpc_benchmark", 0.02, "cuda"),
    ("microcircuit", 0.01, "cuda"),
    ("brunel", 0.02, "flat"),
])
def test_run_scenario_counts_equal_engine_run(scenario, scale, sweep):
    steps = 300
    _, rec = run_port("run_scenario", [
        "--scenario", scenario, "--scale", str(scale), "--steps",
        str(steps), "--sweep", sweep])
    spec, stdp = models.get_scenario(scenario, scale=scale)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = neuron_models.get_model(spec.neuron_model).make_param_table(
        list(spec.groups), dt=models.DT_MS, device=CPU)
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep=sweep,
                              neuron_model=spec.neuron_model)
    st = engine.init_state(g, list(spec.groups), 0, sweep=sweep,
                           neuron_model=spec.neuron_model, device=CPU)
    _, spikes = engine.run(st, g, table, cfg, steps, device=CPU)
    want = spikes[:, :spec.n_neurons].sum(0, dtype=torch.int64).numpy()
    assert want.sum() > 0, "vacuous: nothing spiked"
    np.testing.assert_array_equal(rec["counts"], want)
    assert rec["total_spikes"] == want.sum()
    # the windows' rates (250 steps, then the 50 left) add up to the run's
    off = spec.pop_offsets()
    for i, p in enumerate(spec.populations):
        w = rec["populations"][p.name]["per_window_hz"]
        spk = np.dot(w, [250, steps - 250]) * p.n * models.DT_MS * 1e-3
        assert round(spk) == want[off[i]:off[i + 1]].sum()


@pytest.mark.parametrize("grid", ["2x2", "4x1", "1x4"])
def test_run_scenario_grid_counts_equal_reference(grid):
    """The drive-free Izhikevich demo network on a grid of stacked shards:
    every neuron's count equals the one-shard run's, so the shard rows
    land on their global ids, and the printed lines equal the reference
    script's (one device).  (The AdEx demo's neurons each spike once in
    these 120 steps: a permutation would not show.)"""
    argv = ["--model", "izhikevich", "--scale", "0.02", "--steps", "120",
            "--sweep", "flat"]
    ref_out, _ = run_ref("run_scenario", argv)
    one_out, one = run_port("run_scenario", argv)
    out, rec = run_port("run_scenario", [*argv, "--grid", grid])
    rows, width = map(int, grid.split("x"))
    assert f"{rows * width} shard(s)" in out.splitlines()[0]
    assert len(np.unique(one["counts"])) > 1, "vacuous: uniform counts"
    np.testing.assert_array_equal(rec["counts"], one["counts"])
    assert _rate_lines(out) == _rate_lines(ref_out) == _rate_lines(one_out)
    assert out.endswith("ok\n")


def test_run_scenario_grid_runs_every_shard():
    """``--grid 2x2`` steps four shards of hpc_benchmark; with the drive's
    per-shard generators the raster is another one, but every neuron is
    counted once and the run is not silent."""
    out, rec = run_port("run_scenario", [
        "--scenario", "hpc_benchmark", "--scale", "0.02", "--steps", "300",
        "--grid", "2x2"])
    assert "4 shard(s)" in out.splitlines()[0]
    assert rec["counts"].shape == (rec["neurons"],)
    assert rec["total_spikes"] > 0 and out.endswith("ok\n")


# --------------------------------------------------------------------------
# simulate_marmoset
# --------------------------------------------------------------------------

MARMOSET = ["--scale", "0.002", "--areas", "4", "--steps", "60",
            "--save-every", "20"]


def _kept(directory: Path) -> list:
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if re.fullmatch(r"step_\d+", p.name))


@pytest.fixture(scope="module")
def marmoset_reference_kept(tmp_path_factory):
    d = tmp_path_factory.mktemp("marmoset_ref")
    out, _ = run_ref("simulate_marmoset", [*MARMOSET, "--ckpt", str(d)])
    assert "restored checkpoint @ step 60 ok" in out
    return _kept(d)


@pytest.mark.parametrize("grid", ["1x1", "2x2"])
def test_marmoset_checkpoints_and_restore(tmp_path, grid,
                                          marmoset_reference_kept):
    out, rec = run_port("simulate_marmoset", [
        *MARMOSET, "--ckpt", str(tmp_path), "--grid", grid])
    assert _kept(tmp_path) == marmoset_reference_kept == [40, 60]
    assert rec["last_step"] == 60
    assert "restored checkpoint @ step 60 ok" in out
    assert out.endswith("ok\n")
    # every leaf as the manager writes it, and the static markers
    saved, restored = state_items(rec["state"]), state_items(rec["restored"])
    assert saved.keys() == restored.keys() and len(saved) > 8
    assert saved[".weights_layout"] == "flat"
    for k, a in saved.items():
        assert np.asarray(restored[k]).dtype == np.asarray(a).dtype, k
        np.testing.assert_array_equal(restored[k], a, err_msg=k)
    if grid == "1x1":
        assert rec["metadata"] == {"step": 60}
        assert out.count("checkpoint saved") == 3
    else:
        assert "wire bytes/step (area)" in out
        assert rec["split"]["intra"] + rec["split"]["inter"] > 0


# --------------------------------------------------------------------------
# serve_snn
# --------------------------------------------------------------------------

def _session_lines(out: str) -> list:
    """Statuses and engine stats as printed; the rates (other random
    numbers) and the backend's name cut."""
    keep = []
    for ln in out.splitlines():
        ln = re.sub(r"rate=\s*[\d.]+ Hz", "rate=", ln)
        ln = re.sub(r"backend=\S+", "backend=", ln)
        keep.append(ln)
    return keep


@pytest.mark.parametrize("evict", [False, True])
def test_serve_snn_statuses_and_stats_equal_reference(tmp_path, evict):
    # the script steps session 0 by 80 before the tails: fewer than 80
    # steps make a negative tail in the reference and the port alike
    argv = ["--sessions", "4", "--steps", "100"]
    extra = lambda d: (["--slots", "2", "--ckpt-dir", str(tmp_path / d)]
                       if evict else [])
    ref_out, _ = run_ref("serve_snn", [*argv, *extra("ref")])
    out, rec = run_port("serve_snn", [*argv, *extra("port")])
    assert _session_lines(out) == _session_lines(ref_out)
    want = dict(slots=2, resident=2, evicted=2, queued=0) if evict else \
        dict(slots=4, resident=4, evicted=0, queued=0)
    assert {k: rec["stats"][k] for k in want} == want
    assert [c["status"] for c in rec["created"]] == (
        ["resident"] * 2 + ["queued"] * 2 if evict else ["resident"] * 4)


# --------------------------------------------------------------------------
# the LM drivers, on the reference's parameters
# --------------------------------------------------------------------------

def _port_module(tree, cfg):
    mod = transformer.DecoderLM(cfg, device=CPU, dtype=torch.float32)
    mod.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), tree), cfg,
        device=CPU, dtype=torch.float32))
    return mod


class _RecordingJax(types.SimpleNamespace):
    """The ``jax`` name of a script's globals: ``jax.jit`` of the train
    step also records each step's loss."""

    def __init__(self, losses):
        super().__init__()
        self.losses = losses

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        f = jax.jit(fn, **kw)

        def step(*a):
            out = f(*a)
            self.losses.append(float(out[2]["loss"]))
            return out
        return step


def test_serve_lm_tokens_equal_reference():
    served = []
    ref_server = ref_main("serve_lm").__globals__["BatchServer"]

    class Recording(ref_server):
        def serve(self, *a, **k):
            outs, stats = super().serve(*a, **k)
            served.append(outs)
            return outs, stats

    ref_out, _ = run_ref("serve_lm", [], BatchServer=Recording)
    cfg = configs.get_smoke("qwen2.5-3b")
    tree = ref_build_model(ref_configs.get_smoke("qwen2.5-3b")).init(
        jax.random.key(0))
    out, rec = run_port("serve_lm", [], params=_port_module(tree, cfg))
    assert rec["outputs"] == served[0]
    assert len(served[0]) == 4 and all(len(o) == 24 for o in served[0])
    prompts = lambda s: [ln for ln in s.splitlines() if ln.startswith("req")]
    assert prompts(out) == prompts(ref_out)


def test_train_lm_losses_equal_reference(tmp_path):
    argv = ["--d-model", "64", "--layers", "2", "--vocab", "512", "--seq",
            "32", "--steps", "3"]
    losses = []
    run_ref("train_lm", [*argv, "--ckpt", str(tmp_path / "ref")],
            jax=_RecordingJax(losses))
    args = port("train_lm").build_parser().parse_args(argv)
    cfg = port("train_lm").model_config(args)
    rcfg = RefModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)
                             if f.name in {g.name for g in
                                           dataclasses.fields(RefModelConfig)}})
    tree = ref_build_model(rcfg).init(jax.random.key(0))
    out, rec = run_port("train_lm", [*argv, "--ckpt", str(tmp_path / "port")],
                        params=_port_module(tree, cfg))
    assert len(losses) == 3
    np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5)
    assert out.splitlines()[0] == "model lm-64d2L: ~0.2M params"


def test_quickstart_lm_demo_losses_equal_reference():
    losses = []
    lm_demo = runpy.run_path(str(EXAMPLES / "quickstart.py"),
                             run_name="reference_quickstart")["lm_demo"]
    lm_demo.__globals__["jax"] = _RecordingJax(losses)
    with contextlib.redirect_stdout(io.StringIO()):
        lm_demo()
    cfg = configs.get_smoke("qwen2.5-3b")
    tree = ref_build_model(ref_configs.get_smoke("qwen2.5-3b")).init(
        jax.random.key(0))
    with contextlib.redirect_stdout(io.StringIO()):
        rec = port("quickstart").lm_demo(CPU, params=_port_module(tree, cfg))
    assert len(losses) == 3
    np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5)


# --------------------------------------------------------------------------
# fit_brunel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--smoke"], ["--init-eta", "2.2"]])
def test_fit_brunel_hands_invert_brunel_the_reference_arguments(argv,
                                                                monkeypatch):
    calls = {}
    fake = types.SimpleNamespace(true_g=5.0, true_eta=2.0, g=5.1, eta=2.01,
                                 rel_error={"g": 0.02, "eta": 0.005},
                                 loss_history=(1.0, 0.25), final_loss=0.25,
                                 n_evals=7)

    def record(who):
        def invert(*a, **k):
            calls[who] = (a, k)
            return fake
        return invert

    monkeypatch.setattr(ref_inverse, "invert_brunel", record("ref"))
    monkeypatch.setattr(inverse, "invert_brunel", record("port"))
    ref_out, rc = run_ref("fit_brunel", argv)
    out, rec = run_port("fit_brunel", argv)
    (ra, rk), (pa, pk) = calls["ref"], calls["port"]
    assert pa == ra
    assert pk.pop("device") == CPU
    assert pk == rk
    assert bool(rk) == ("--smoke" in argv)
    assert out == ref_out and rc == 0 and rec["ok"]


# --------------------------------------------------------------------------
# the port stands alone
# --------------------------------------------------------------------------

_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)"
    r"|import_module\(\s*[\"'](?:jax|repro)[\"'.]", re.M)


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 60
    for f in files:
        hits = _IMPORT.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
