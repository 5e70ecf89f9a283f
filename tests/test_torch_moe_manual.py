"""The port's expert-parallel dispatch (``repro_torch.models.moe_manual``)
over gloo ranks on the CPU, against the reference's ``moe_apply_manual``
and its single-device ``moe_apply``.

Four port ranks (``ProcessMesh`` over a gloo world, started once for the
module) and one reference process (4 forced host devices, the same
meshes, ``jax.jit`` under ``rules.use_mesh``) run every case on the same
seeded inputs:

* a (2, 2) ``("data", "model")`` mesh with E = 8 (experts over both axes)
  and with E = 2 (over ``model`` only, replicated over ``data``);
* a (2, 1, 2) ``("pod", "data", "model")`` mesh with E = 8;
* B = 1 decode on (2, 2): the batch does not split, so every rank holds
  it and the tokens are sliced over ``data`` and ``model``;
* capacity factor 1.0 on (2, 2), where tokens drop: the port's manual
  dispatch against the reference's manual dispatch only (capacity is
  counted per slice there and per chunk on one device).

Each rank holds its batch block (the whole batch at B = 1) and its
expert block, and differentiates ``n_blocks * sum(y_block^2) + 0.01 *
aux``: the mean of these over the batch blocks is the reference's
``sum(y^2) + 0.01 * aux`` of the whole batch.  The rank averages the
router's gradient over the batch axes and sums its experts' over the axes
that do not own them (divided by the batch blocks), as the mesh train
step does.  Held at the reference test's tolerance: y,
``load_balance_loss`` and ``drop_frac`` within 1e-4; the router's, the
experts' and the input's gradients within 1e-4 of each leaf's norm.  The
ranks along ``model`` must hold the same router gradient bit for bit.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
D, FF = 32, 16
CASES = {
    # name: (mesh dims, axis names, E, top-k, capacity factor, x shape)
    "2x2_e8": ((2, 2), ("data", "model"), 8, 2, 16.0, (4, 16)),
    "2x2_e2": ((2, 2), ("data", "model"), 2, 2, 16.0, (4, 16)),
    "2x1x2_e8": ((2, 1, 2), ("pod", "data", "model"), 8, 2, 16.0, (4, 16)),
    "decode_b1": ((2, 2), ("data", "model"), 8, 2, 16.0, (1, 1)),
    "drop_cf1": ((2, 2), ("data", "model"), 8, 2, 1.0, (4, 16)),
}
DROPLESS = ("2x2_e8", "2x2_e2", "2x1x2_e8", "decode_b1")
ATOL = 1e-4
GRAD_REL = 1e-4


def _inputs(name):
    dims, axes, e, k, cf, (b, s) = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f32 = np.float32
    return {"router": (rng.standard_normal((D, e)) / np.sqrt(D)).astype(f32),
            "wi_gate": (rng.standard_normal((e, D, FF)) / np.sqrt(D)
                        ).astype(f32),
            "wi_up": (rng.standard_normal((e, D, FF)) / np.sqrt(D)
                      ).astype(f32),
            "wo": (rng.standard_normal((e, FF, D)) / np.sqrt(FF)).astype(f32),
            "x": rng.standard_normal((b, s, D)).astype(f32)}


REF_CODE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs.base import MoEConfig
    from repro.models import moe as moe_mod
    from repro.sharding import rules
    cases = json.loads(sys.argv[2])
    out = {}
    for name, (dims, axes, e, k, cf, _) in cases.items():
        inp = dict(np.load(os.path.join(sys.argv[1], name + ".npz")))
        cfg = MoEConfig(n_experts=e, top_k=k, expert_ff=%(ff)d,
                        capacity_factor=cf)
        p = {"router": {"w": jnp.asarray(inp["router"])},
             **{n: jnp.asarray(inp[n]) for n in ("wi_gate", "wi_up", "wo")}}
        x = jnp.asarray(inp["x"])
        mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(dims),
                                 tuple(axes))

        def loss(p, x, mesh):
            if mesh is None:
                y, aux = moe_mod.moe_apply(p, cfg, "swiglu", x, jnp.float32)
            else:
                with rules.use_mesh(mesh):
                    y, aux = moe_mod.moe_apply(p, cfg, "swiglu", x,
                                               jnp.float32)
            return (jnp.sum(y ** 2) + 0.01 * aux["load_balance_loss"],
                    (y, aux))

        for tag, m in (("manual", mesh), ("single", None)):
            fn = jax.jit(jax.value_and_grad(lambda p, x: loss(p, x, m),
                                            argnums=(0, 1), has_aux=True))
            (_, (y, aux)), (gp, gx) = fn(p, x)
            res = {"y": y, "lb": aux["load_balance_loss"],
                   "drop": aux["drop_frac"], "g_router": gp["router"]["w"],
                   "g_wi_gate": gp["wi_gate"], "g_wi_up": gp["wi_up"],
                   "g_wo": gp["wo"], "g_x": gx}
            np.savez(os.path.join(sys.argv[1], f"ref_{tag}_{name}.npz"),
                     **{k_: np.asarray(v, np.float32)
                        for k_, v in res.items()})
    print("ok")
""") % {"ff": FF}

RANK_CODE = textwrap.dedent("""
    import os, sys, json
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models import moe
    from repro_torch.models.moe_manual import expert_block, local_experts
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding import rules
    rank, addr, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    cases = json.loads(sys.argv[4])
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://{addr}",
                             world_size=4, rank=rank)
    for name, (dims, axes, e, k, cf, _) in cases.items():
        inp = dict(np.load(os.path.join(out_dir, name + ".npz")))
        mesh = ProcessMesh(axes, dims)
        cfg = MoEConfig(n_experts=e, top_k=k, expert_ff=%(ff)d,
                        capacity_factor=cf)
        n_loc = local_experts(mesh, e)
        blk = expert_block(mesh, e)
        p = moe.MoE(%(d)d, "swiglu", cfg, dtype=torch.float32, device="cpu",
                    n_local=n_loc)
        with torch.no_grad():
            p.router.w.copy_(torch.from_numpy(inp["router"]))
            for n in ("wi_gate", "wi_up", "wo"):
                getattr(p, n).copy_(torch.from_numpy(
                    inp[n][blk * n_loc:(blk + 1) * n_loc]))
        x = torch.from_numpy(inp["x"])
        batch_ax = tuple(a for a in ("pod", "data") if a in axes)
        n_b = mesh.axis_size(batch_ax)
        replicated = x.shape[0] %% n_b != 0
        if replicated:
            blocks = 1
        else:
            blocks = n_b
            bl = x.shape[0] // n_b
            i = mesh.axis_index(batch_ax)
            x = x[i * bl:(i + 1) * bl]
        x = x.clone().requires_grad_(True)
        leaves = [p.router.w, p.wi_gate, p.wi_up, p.wo]
        for t in leaves:
            t.requires_grad_(True)
        with rules.use_mesh(mesh, replicated_batch=replicated):
            y, aux = moe.moe_apply(p, cfg, "swiglu", x, torch.float32)
        loss = blocks * torch.sum(y ** 2) + 0.01 * aux["load_balance_loss"]
        g_router, g_wg, g_wu, g_wo, g_x = torch.autograd.grad(
            loss, leaves + [x])
        g_router_local = g_router.clone()
        g_router = coll.all_reduce_sum(g_router, mesh, batch_ax) / n_b
        exp_ax = rules.expert_axes_for(mesh, e)
        other = tuple(a for a in axes if a not in exp_ax)
        g_exp = [coll.all_reduce_sum(g, mesh, other) / blocks
                 for g in (g_wg, g_wu, g_wo)]
        np.savez(os.path.join(out_dir, f"port_{name}_rank{rank}.npz"),
                 y=y.detach().numpy(), lb=aux["load_balance_loss"].detach(),
                 drop=aux["drop_frac"], g_router=g_router.numpy(),
                 g_router_local=g_router_local.numpy(),
                 g_wi_gate=g_exp[0].numpy(), g_wi_up=g_exp[1].numpy(),
                 g_wo=g_exp[2].numpy(), g_x=(g_x / blocks).numpy(),
                 block=blk, n_loc=n_loc, replicated=replicated,
                 batch_index=mesh.axis_index(batch_ax),
                 model_index=mesh.coords["model"])
    tdist.barrier()
    tdist.destroy_process_group()
""") % {"ff": FF, "d": D}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through four gloo ranks and through the reference."""
    out = tmp_path_factory.mktemp("moe_manual")
    for name in CASES:
        np.savez(out / f"{name}.npz", **_inputs(name))
    cases = json.dumps(CASES)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, str(r), addr, str(out), cases],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", REF_CODE, str(out), cases], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return out


def _load(out, name):
    ranks = [dict(np.load(out / f"port_{name}_rank{r}.npz"))
             for r in range(4)]
    ref = {tag: dict(np.load(out / f"ref_{tag}_{name}.npz"))
           for tag in ("manual", "single")}
    return ranks, ref


def _blocks(ranks, key, ref_shape):
    """The ranks' batch blocks of ``key`` put back into the global batch
    (every rank holds it whole where the batch does not split)."""
    if bool(ranks[0]["replicated"]):
        return ranks[0][key]
    n_b = 1 + max(int(r["batch_index"]) for r in ranks)
    out = np.zeros(ref_shape, np.float32)
    bl = ref_shape[0] // n_b
    for r in ranks:
        i = int(r["batch_index"])
        out[i * bl:(i + 1) * bl] = r[key]
    return out


def _grad_close(got, want, what):
    err = float(np.linalg.norm(got - want))
    assert err <= GRAD_REL * float(np.linalg.norm(want)), (what, err)


def _check(ranks, ref, tag):
    want = ref[tag]
    y = _blocks(ranks, "y", want["y"].shape)
    np.testing.assert_allclose(y, want["y"], atol=ATOL, rtol=0)
    for r in ranks:
        np.testing.assert_allclose(float(r["lb"]), float(want["lb"]),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(float(r["drop"]), float(want["drop"]),
                                   atol=ATOL, rtol=0)
        _grad_close(r["g_router"], want["g_router"], "router")
        n, b = int(r["n_loc"]), int(r["block"])
        for leaf in ("g_wi_gate", "g_wi_up", "g_wo"):
            _grad_close(r[leaf], want[leaf][b * n:(b + 1) * n], leaf)
    _grad_close(_blocks(ranks, "g_x", want["g_x"].shape), want["g_x"], "x")


@pytest.mark.parametrize("name", list(CASES))
def test_manual_equals_reference_manual(runs, name):
    ranks, ref = _load(runs, name)
    _check(ranks, ref, "manual")


@pytest.mark.parametrize("name", DROPLESS)
def test_manual_equals_single_device_when_dropless(runs, name):
    """Where nothing drops the dispatch is the single-device one's: y and
    the experts' gradients (the load-balance loss, and so the router's and
    the input's gradients, differ: a mesh counts it per slice)."""
    ranks, ref = _load(runs, name)
    want = ref["single"]
    assert float(want["drop"]) == 0.0 and float(ranks[0]["drop"]) == 0.0
    y = _blocks(ranks, "y", want["y"].shape)
    np.testing.assert_allclose(y, want["y"], atol=ATOL, rtol=0)
    for r in ranks:
        n, b = int(r["n_loc"]), int(r["block"])
        for leaf in ("g_wi_gate", "g_wi_up", "g_wo"):
            _grad_close(r[leaf], want[leaf][b * n:(b + 1) * n], leaf)


def test_drop_case_drops(runs):
    ranks, ref = _load(runs, "drop_cf1")
    assert float(ref["manual"]["drop"]) > 0.05
    assert float(ranks[0]["drop"]) > 0.05


@pytest.mark.parametrize("name", list(CASES))
def test_router_grad_equal_along_model(runs, name):
    """The ranks of one batch block (along ``model``) hold the same
    router gradient bit for bit, before and after the batch average."""
    ranks, _ = _load(runs, name)
    by_block = {}
    for r in ranks:
        by_block.setdefault(int(r["batch_index"]), []).append(r)
    for group in by_block.values():
        for r in group[1:]:
            assert np.array_equal(r["g_router_local"],
                                  group[0]["g_router_local"])
            assert np.array_equal(r["g_router"], group[0]["g_router"])


def test_local_specs_cut_only_the_expert_stacks():
    """The port's mesh layout: an expert stack cut over the expert axes
    on its expert dim (dim 1 of a stacked Adafactor slot), every other
    leaf whole; and the rank's block of a global tree."""
    import torch
    from repro_torch import configs, convert
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import ProcessMesh, make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.sharding import rules
    from repro_torch.train import optimizer as opt_mod
    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    mod = transformer.DecoderLM(cfg, device="meta", dtype=torch.float32)
    mesh = make_test_mesh((2, 2))
    specs = rules.local_specs(mesh, dict(mod.named_parameters()),
                              cfg.moe.n_experts)
    assert specs["layers.0.moe.wi_gate"] == rules.P(("model", "data"))
    assert specs["layers.0.moe.router.w"] == rules.P()
    assert specs["layers.0.attn.wq.w"] == rules.P()
    state = opt_mod.init_opt_state(TrainConfig(optimizer="adafactor"), mod)
    sspec = rules.local_specs(mesh, state, cfg.moe.n_experts)
    assert sspec["v_row"]["period.0.moe.wo"] == rules.P(None,
                                                        ("model", "data"))
    one = ProcessMesh(("data", "model"), (1, 1))       # no world needed
    assert one.rank == 0 and one.axis_index(("model", "data")) == 0
    assert one.group(("data",)) is None
    tree = {"layers.0.moe.wo": torch.arange(8.0).reshape(8, 1, 1),
            "embed.table": torch.ones(3, 2)}
    assert convert.mesh_local(tree, one, 8)["layers.0.moe.wo"].shape == (
        8, 1, 1)
