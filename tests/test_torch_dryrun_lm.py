"""The port's LM dry run (``configs/shapes.py``, the spec half of
``sharding/rules.py``, ``launch/dryrun.py``, ``launch/roofline.py``)
against the reference, on the CPU.

* ``SHAPES``, ``LONG_OK_FAMILIES`` and ``shape_applicable``: equal;
* ``param_specs``: every leaf of the ten smoke archs on an abstract 4x4
  mesh equals the reference's through ``convert.py``'s name map (a
  stacked period leaf's spec less its leading ``None``); the per-device
  bytes of every arch's parameters, batch, cache and AdamW state equal
  those the reference's own specs give its own tree on 16x16 and
  2x16x16 (each leaf at the port's dtype), and an Adafactor state's specs
  equal the reference's ``param_specs`` of the port's tree;
* ``cache_specs``, including the kv-head fallback to the sequence dim;
* ``input_specs``: keys, global shapes, dtypes and specs for every arch
  x shape on both meshes;
* the count: the trip-count shortcut equals a whole count exactly (calls,
  FLOPs, bytes, op by op) on a smoke config of each family; a share
  counted on ``meta`` equals the same share run on the CPU op for op;
  a bf16 prefill on ``meta`` takes the card's GEMMs (no fp32 operand)
  and holds one K8 op per attention layer, charged ``flash_work``;
  ``_unsafe_view`` is free;
* the program count of the collectives holds the FSDP traffic in a
  closed form worked by hand for qwen2.5-3b's smoke config on 2x2 and
  2x2x2 (``test_torch_mesh_traffic`` holds the whole count to gloo
  ranks);
* ``dryrun.main`` and ``roofline.main`` write a well-formed record for
  one fast cell.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported;
its ``input_specs`` is imported inside the one test that compares it, as
``tests/test_sharding_and_dryrun.py`` does, with ``XLA_FLAGS`` restored.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models.model import build_model as ref_build_model
from repro.sharding import rules as ref_rules
from repro.train.optimizer import init_opt_state as ref_init_opt_state
from repro.utils.jax_compat import abstract_mesh
from repro_torch import configs, convert
from repro_torch.configs import shapes
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import transformer
from repro_torch.sharding import rules
from repro_torch.utils import op_costs

MESHES = {"16x16": False, "2x16x16": True}
#: the families' smoke configs the shortcut is held on
FAMILY_ARCHS = {"dense": "qwen2.5-3b", "moe": "deepseek-v3-671b",
                "hybrid": "jamba-v0.1-52b", "ssm": "rwkv6-3b",
                "audio": "whisper-tiny", "vlm": "internvl2-1b"}
#: small cells: a train step of 4 microbatches of 1 row, a prefill and a
#: decode of 4 rows, on a 2x2 mesh
SMALL = {"train": ShapeConfig("t", "train", 4, 8, 4),
         "prefill": ShapeConfig("p", "prefill", 4, 8),
         "decode": ShapeConfig("d", "decode", 4, 8)}


def _ref_mesh(mesh):
    return abstract_mesh(mesh.dims, mesh.axis_names)


def _spec(sharding) -> tuple:
    return tuple(sharding.spec)


def _ref_leaves(tree) -> dict:
    """path -> leaf of a reference tree (keys joined by ``/``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: hasattr(x, "spec")):
        out[ref_rules._path_str(path)] = leaf
    return out


def _port_leaves(tree) -> dict:
    out = {}
    rules.tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _port_names(cfg, path: str) -> list:
    """The port leaves (``/`` paths) a reference parameter or cache leaf
    becomes, by ``convert.py``'s map: a stacked leaf one per layer."""
    head, _, rest = path.partition("/")
    if cfg.family == "audio":
        if head in ("encoder", "decoder"):
            n = cfg.encoder_layers if head == "encoder" else cfg.n_layers
            return [f"{head}/{i}/{rest}" for i in range(n)]
        if head in ("self", "cross_kv"):
            return [f"{head}/{i}/{rest}" for i in range(cfg.n_layers)]
        return [path]
    prefix, period, n_periods = transformer.period_structure(cfg)
    if head == "prefix":
        i, _, rest = rest.partition("/")
        return [f"layers/{i}/{rest}"]
    if head == "period":
        j, _, rest = rest.partition("/")
        return [f"layers/{len(prefix) + p * len(period) + int(j)}/{rest}"
                for p in range(n_periods)]
    return [path]


def _local_numel(shape, spec, mesh) -> int:
    return math.prod(rules.shard_shape(tuple(shape), rules.P(*spec), mesh))


# --------------------------------------------------------------------------
# shapes and specs
# --------------------------------------------------------------------------

def test_shapes_match_reference():
    assert shapes.SHAPES.keys() == ref_shapes.SHAPES.keys()
    for name, got in shapes.SHAPES.items():
        assert dataclasses.astuple(got) == dataclasses.astuple(
            ref_shapes.SHAPES[name])
    assert shapes.LONG_OK_FAMILIES == ref_shapes.LONG_OK_FAMILIES
    families = {configs.get(a).family for a in configs.ARCH_NAMES}
    for fam in families | {"ssm", "hybrid"}:
        for name in shapes.SHAPES:
            assert shapes.shape_applicable(fam, name) \
                == ref_shapes.shape_applicable(fam, name)


def _fill_ids(sds_tree):
    """The reference tree's leaves as fp32 arrays holding their own leaf
    number (times 1000, plus the stacked index), to follow each leaf
    through ``convert.py``."""
    leaves, treedef = jax.tree_util.tree_flatten(sds_tree)
    arrays = []
    for k, s in enumerate(leaves):
        a = np.full(s.shape, 1000.0 * k, np.float32)
        if a.ndim:
            a += np.arange(a.shape[0], dtype=np.float32).reshape(
                (-1,) + (1,) * (a.ndim - 1))
        arrays.append(a)
    return jax.tree_util.tree_unflatten(treedef, arrays), leaves


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_match_reference_per_leaf(arch):
    """Every port parameter's spec on an abstract 4x4 mesh equals the
    reference's for the leaf ``convert.py`` makes it from, less the
    stacked dim's ``None``."""
    cfg = configs.get_smoke(arch)
    mesh = make_test_mesh((4, 4))
    m = ref_build_model(ref_configs.get_smoke(arch))
    sds = jax.eval_shape(lambda: m.init(jax.random.key(0)))
    ref_specs = jax.tree_util.tree_leaves(
        ref_rules.param_specs(_ref_mesh(mesh), sds),
        is_leaf=lambda x: hasattr(x, "spec"))
    ids, ref_sds = _fill_ids(sds)
    to_port = (convert.encdec_params_from_numpy if cfg.family == "audio"
               else convert.lm_params_from_numpy)
    state = to_port(ids, cfg, device="cpu", dtype=torch.float32)
    ctor = (dryrun.encdec.EncDecLM if cfg.family == "audio"
            else transformer.DecoderLM)
    port = rules.param_specs(mesh, ctor(cfg, device="meta"))
    assert set(port) == set(state)
    for name, t in state.items():
        k = int(t.reshape(-1)[0]) // 1000
        want = _spec(ref_specs[k])
        stacked = t.dim() < len(ref_sds[k].shape)
        if stacked:
            assert want[:1] in ((), (None,)), (name, want)
            want = want[1:]
        assert tuple(port[name]) == want, (arch, name)


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, dtype: str):
    """The reference's parameter tree of ``arch`` (published config) as
    shapes, stored in ``dtype``."""
    m = ref_build_model(ref_configs.get(arch))
    return jax.eval_shape(lambda: m.init(jax.random.key(0),
                                         dtype=jnp.dtype(dtype)))


@functools.lru_cache(maxsize=None)
def _ref_cache(arch: str, batch: int, seq: int):
    m = ref_build_model(ref_configs.get(arch))
    return jax.eval_shape(lambda: m.init_cache(batch, seq))


def _ref_tree_bytes(cfg, sds, specs, port_dtypes, mesh) -> int:
    """Per-device bytes of a reference tree under the reference's specs,
    each leaf at the dtype of the port leaves it becomes."""
    total = 0
    leaves = _ref_leaves(sds)
    for path, sh in _ref_leaves(specs).items():
        names = _port_names(cfg, path)
        sizes = {port_dtypes[n].itemsize for n in names}
        assert len(sizes) == 1, path
        total += _local_numel(leaves[path].shape, _spec(sh),
                              mesh) * sizes.pop()
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_argument_bytes_match_reference(mesh_name):
    """For every arch and shape on the production mesh, the per-device
    bytes of the parameters, the batch, the cache and (AdamW) the
    optimizer state equal what the reference's specs give its own tree;
    an Adafactor state (the MoE archs) is held per leaf instead (next
    test)."""
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    rmesh = _ref_mesh(mesh)
    param_bytes = {}
    for arch in configs.ARCH_NAMES:
        cfg = configs.get(arch)
        for name, shape in shapes.SHAPES.items():
            if not shapes.shape_applicable(cfg.family, name):
                continue
            cell = dryrun.build_cell(cfg, shape, mesh)
            roles = dryrun.memory_record(cell)["argument_bytes_by_role"]
            dtypes = {k: a.dtype for k, a in
                      _port_leaves(cell.args["params"]).items()}
            dt = (dryrun.train_config_for(cfg).param_dtype
                  if shape.kind == "train" else cfg.dtype)
            sds = _ref_params(arch, dt)
            if (arch, dt) not in param_bytes:
                param_bytes[arch, dt] = _ref_tree_bytes(
                    cfg, sds, ref_rules.param_specs(rmesh, sds), dtypes,
                    mesh)
            assert roles["params"] == param_bytes[arch, dt], (arch, name)
            batch = sum(math.prod(_ref_batch_shape(a, mesh))
                        * a.dtype.itemsize
                        for a in dryrun.input_specs(cfg, shape,
                                                    mesh).values())
            assert roles["batch"] == batch
            if shape.kind == "train":
                tcfg = dryrun.train_config_for(cfg)
                if tcfg.optimizer == "adamw":
                    opt = jax.eval_shape(lambda p: ref_init_opt_state(
                        RefTrainConfig(optimizer="adamw"), p), sds)
                    f32 = {n: torch.float32 for n in dtypes}
                    ospecs = ref_rules.param_specs(rmesh, opt)
                    assert roles["opt_state"] == sum(
                        _ref_tree_bytes(cfg, opt[part], ospecs[part], f32,
                                        mesh) for part in ("m", "v"))
                continue
            seq = shape.seq_len + (cfg.n_prefix_embeds
                                   if cfg.family == "vlm" else 0)
            csds = _ref_cache(arch, shape.global_batch, seq)
            cspecs = ref_rules.cache_specs(
                rmesh, csds, seq_shard=shape.global_batch == 1)
            cdt = {k: a.dtype for k, a in
                   _port_leaves(cell.args["cache"]).items()}
            assert roles["cache"] == _ref_tree_bytes(
                cfg, csds, cspecs, cdt, mesh), (arch, name)


def _ref_batch_shape(a, mesh):
    return rules.shard_shape(a.shape, a.spec, mesh)


def test_adafactor_state_specs_match_reference():
    """A MoE arch's Adafactor state (stacked per period slot, as the
    reference's): leaf for leaf, the paths, shapes and specs of the
    reference's ``init_opt_state`` on its own tree under its
    ``param_specs``, and the per-device bytes of each leaf and of the
    whole state, on both meshes."""
    for arch in ("qwen3-moe-30b-a3b", "jamba-v0.1-52b", "deepseek-v3-671b"):
        cfg = configs.get(arch)
        tcfg = dryrun.train_config_for(cfg)
        assert tcfg.optimizer == "adafactor"
        sds = _ref_params(arch, tcfg.param_dtype)
        opt = jax.eval_shape(lambda p: ref_init_opt_state(
            RefTrainConfig(optimizer="adafactor"), p), sds)
        for mp in MESHES.values():
            mesh = make_production_mesh(multi_pod=mp)
            cell = dryrun.build_cell(cfg, shapes.SHAPES["train_4k"], mesh)
            port = _port_leaves(cell.args["opt_state"])
            ref_specs = _ref_leaves(ref_rules.param_specs(_ref_mesh(mesh),
                                                          opt))
            ref_sds = _ref_leaves(opt)
            ref = {}
            for path, sh in ref_specs.items():
                part, head, rest = path.split("/", 2)
                if head == "prefix":
                    path_p = f"{part}/layers/{rest}"
                else:
                    path_p = path
                ref[path_p] = (tuple(ref_sds[path].shape), _spec(sh))
            assert port.keys() == ref.keys(), (arch, sorted(
                port.keys() ^ ref.keys())[:5])
            total = 0
            for path, a in port.items():
                shape, spec = ref[path]
                assert tuple(a.shape) == shape, (arch, path)
                assert tuple(a.spec) == spec, (arch, path)
                assert a.dtype == torch.float32, (arch, path)
                nbytes = _local_numel(shape, spec, mesh) * 4
                assert a.local_bytes(mesh) == nbytes, (arch, path)
                total += nbytes
            roles = dryrun.memory_record(cell)["argument_bytes_by_role"]
            assert roles["opt_state"] == total, arch


def test_cache_specs_head_vs_seq_fallback():
    """The reference's case: kv heads = 2 cannot shard over model = 8, so
    the sequence dim takes "model"; and each smoke arch's cache on 2x8,
    leaf by leaf, against the reference's rules on the same tree."""
    mesh = make_test_mesh((2, 8))
    cache = {"period": {"k": torch.empty((4, 16, 64, 2, 8), device="meta"),
                        "v": torch.empty((4, 16, 64, 2, 8), device="meta")}}
    spec = rules.cache_specs(mesh, cache)["period"]["k"]
    assert spec[2] in ("model", ("model",)), spec
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_smoke(arch)
        model = dryrun.build_model(cfg)
        for seq_shard, batch in ((False, 4), (True, 1)):
            port = model.init_cache(batch, 64, device="meta")
            got = _port_leaves(rules.cache_specs(mesh, port,
                                                 seq_shard=seq_shard))
            tree = jax.tree_util.tree_map(
                lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                port)
            ref = _ref_leaves(ref_rules.cache_specs(
                _ref_mesh(mesh), tree, seq_shard=seq_shard))
            assert {p: tuple(s) for p, s in got.items()} == {
                p: _spec(s) for p, s in ref.items()}, arch


def test_input_specs_match_reference():
    """Keys, global shapes, dtypes and specs of every arch x shape's
    inputs on both meshes."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import input_specs as ref_input_specs
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    for mp in MESHES.values():
        mesh = make_production_mesh(multi_pod=mp)
        for arch in configs.ARCH_NAMES:
            cfg = configs.get(arch)
            for name, shape in shapes.SHAPES.items():
                got = dryrun.input_specs(cfg, shape, mesh)
                ref = ref_input_specs(ref_configs.get(arch),
                                      ref_shapes.SHAPES[name],
                                      _ref_mesh(mesh))
                assert got.keys() == ref.keys(), (arch, name)
                for k, a in got.items():
                    r = ref[k]
                    assert a.shape == tuple(r.shape), (arch, name, k)
                    assert str(a.dtype).split(".")[1] == str(r.dtype)
                    assert tuple(a.spec) == _spec(r.sharding)


# --------------------------------------------------------------------------
# the count
# --------------------------------------------------------------------------

def _deep(arch: str):
    """The smoke config with 3 periods after its dense prefix, so that the
    shortcut extrapolates past both of its points (jamba's with one
    attention layer in 2, not 8, and DeepSeek's with one dense prefix
    layer, not 3, so that the counts stay short: the same kinds of
    layer)."""
    cfg = configs.get_smoke(arch)
    if cfg.family == "audio":      # 8 frames: the count, not the widths
        return dataclasses.replace(cfg, encoder_seq=8)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, attn_every=2, attn_offset=1)
    if cfg.moe is not None and cfg.moe.dense_first_n:   # one dense layer
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dense_first_n=1))
    prefix, period, _ = transformer.period_structure(cfg)
    return dataclasses.replace(cfg, n_layers=len(prefix) + 3 * len(period))


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_shortcut_equals_full_count(family):
    """Counted at two depths and two microbatch counts and solved, a
    share's calls, FLOPs and bytes equal its whole count, op by op, and
    its mesh program's collectives their whole tally, kind by kind.  The
    hybrid's train step has 3 microbatches (counted as they are: its
    depth alone is solved; the MoE family, whose counts also start at one
    period, solves both)."""
    cfg = _deep(FAMILY_ARCHS[family])
    mesh = make_test_mesh((2, 2))
    cells = dict(SMALL)
    if family == "hybrid":
        cells["train"] = ShapeConfig("t", "train", 4, 6, 3)
    for kind, shape in cells.items():
        fast, info = dryrun.count_share(cfg, shape, mesh)
        full, _ = dryrun.count_share(cfg, shape, mesh, shortcut=False)
        assert fast == full, (family, kind)
        # the collectives, solved the same way, against the whole program
        solved = dryrun.count_collectives(cfg, shape, mesh)
        whole = dryrun._tally_share(cfg, shape, mesh, None, None)
        assert solved["calls_by_kind"] == {k: v[0] for k, v in
                                           whole.items()}, (family, kind)
        assert solved["by_kind"] == {k: v[1] for k, v in whole.items()}
        assert solved["ring_by_kind"] == {k: v[2] for k, v in
                                          whole.items()}
        if kind == "train":
            assert len(info["counted_at"]) == (2 if family in ("audio",
                                                               "hybrid")
                                               else 4)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b"])
def test_meta_count_equals_a_cpu_run(arch):
    """The share counted on ``meta`` is the count of the same share run
    on the CPU with values (parameters and inputs from the seed), op for
    op: the check the card's phase makes against the card."""
    cfg = configs.get_smoke(arch)
    mesh = make_test_mesh((2, 2))
    for shape in (ShapeConfig("t", "train", 4, 4, 2), SMALL["prefill"],
                  SMALL["decode"]):
        meta, _ = dryrun.count_share(cfg, shape, mesh)
        cell = dryrun.build_cell(cfg, shape, mesh, device="cpu", seed=1)
        cell.run()                          # the caches a first call fills
        with op_costs.OpCounter() as c:
            cell.run()
        assert {k: list(v) for k, v in c.by_op.items()} == meta, shape.kind


def _attention_layers(cfg) -> int:
    if cfg.family == "audio":       # encoder self, decoder self and cross
        return cfg.encoder_layers + 2 * cfg.n_layers
    return sum(k[0] in ("attn", "mla") for k in transformer.layer_kinds(cfg))


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_meta_prefill_counts_k8_and_the_cards_gemms(arch):
    """A bf16 prefill on ``meta``: one ``repro_torch::flash_attention`` op
    per attention layer, charged ``flash_work`` for its shapes; every
    2-d GEMM but the MoE router's (fp32 by design) takes bf16 operands,
    as on the card, never the CPU's upcast; so does every batched one
    outside the Mamba and RWKV recurrences (fp32 by design)."""
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="bfloat16")
    mesh = make_test_mesh((2, 2))
    cell = dryrun.build_cell(cfg, SMALL["prefill"], mesh)
    calls = []

    class Log(op_costs.OpCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.name() in op_costs.DOT_OPS:
                calls.append((func.name(), args))
            return out

    with Log() as c:
        cell.run()
    k8 = [a for n, a in calls if n == "repro_torch::flash_attention"]
    assert len(k8) == _attention_layers(cfg) == c.by_op[
        "repro_torch::flash_attention"][0]
    flops = nbytes = 0
    for q, k, v, causal, *_ in k8:
        b, s, h, dh = q.shape
        nb, ops = op_costs.flash_work(b, s, k.shape[1], h, k.shape[2], dh,
                                      v.shape[3], causal, 2)
        flops, nbytes = flops + ops, nbytes + nb
    assert c.by_op["repro_torch::flash_attention"][1:] == [flops, nbytes]
    recurrent = cfg.family in ("ssm", "hybrid")
    gemms = 0
    for name, args in calls:
        mats = [a for a in args if isinstance(a, torch.Tensor)][-2:]
        if name == "repro_torch::flash_attention" or (
                recurrent and "bmm" in name):
            continue
        if cfg.moe and mats[1].shape[-1] == cfg.moe.n_experts:
            assert [m.dtype for m in mats] == [torch.float32] * 2
            continue                        # the fp32 router
        assert [m.dtype for m in mats] == [torch.bfloat16] * 2, (arch, name)
        gemms += 1
    assert gemms > 0


def test_f32_products_take_the_cards_overload_on_meta():
    """``matmul_f32`` and ``bmm_f32`` on bf16 ``meta`` operands dispatch
    the fp32-output ``mm`` / ``bmm`` on the bf16 operands, one op each,
    with grad on and off, as on the card; on the CPU they upcast."""
    from repro_torch.models import layers
    for dev, want in (("meta", {"aten::mm.dtype", "aten::bmm.dtype"}),
                      ("cpu", {"aten::mm", "aten::bmm", "aten::_to_copy"})):
        for grad in (False, True):
            a = torch.ones(2, 3, 4, dtype=torch.bfloat16, device=dev,
                           requires_grad=grad)
            w = torch.ones(4, 5, dtype=torch.bfloat16, device=dev)
            e = torch.ones(2, 4, 5, dtype=torch.bfloat16, device=dev)
            with op_costs.OpCounter() as c:
                y = layers.matmul_f32(a, w)
                z = layers.bmm_f32(a, e)
            assert y.dtype == z.dtype == torch.float32
            assert set(c.by_op) == want, (dev, grad, dict(c.by_op))


def test_unsafe_view_and_partial_writes_cost_what_they_move():
    """``_unsafe_view`` (after a 3-d @ 2-d product) is free; ``copy_``,
    ``index`` and ``index_put_`` are charged their rows, not their whole
    buffers."""
    a, b = torch.ones(2, 3, 4), torch.ones(4, 5)
    buf = torch.zeros(8, 100, 16)
    rows = torch.tensor([3, 7])
    with op_costs.OpCounter() as c:
        torch.matmul(a, b)
        buf[:, :4] = torch.ones(8, 4, 16)
        got = buf[rows]
        buf[torch.arange(8), torch.zeros(8, dtype=torch.long)] = 1.0
    assert "aten::_unsafe_view" not in c.by_op
    assert c.by_op["aten::mm"] == [1, 2 * 6 * 4 * 5,
                                   4 * (6 * 4 + 4 * 5 + 6 * 5)]
    assert c.by_op["aten::copy_"][2] == 2 * 4 * (8 * 4 * 16)
    assert c.by_op["aten::index.Tensor"][2] == 2 * got.numel() * 4 + 16
    # values (a 0-d fp32), two int64 indices of 8, 8 rows of 16 written
    assert c.by_op["aten::index_put_"][2] == 4 + 2 * 64 + 8 * 16 * 4


def test_parameter_collectives_closed_form():
    """qwen2.5-3b's smoke config (d 64, 4 heads of 16, 2 kv heads, ff
    128, vocab 512 tied, 2 layers, QKV biases, fp32) on data 2 x model 2:
    the matrices shard over both axes (a quarter each a device), biases
    over "model", norms not at all.  The program count
    (``count_collectives``) of a ``gather_once`` train step of four
    microbatches holds the FSDP traffic in closed form: one all-gather of
    each data-sharded matrix's other half, of the bf16 copy
    ``gather_once`` differentiates (15 leaves: the table and 7 matrices
    a layer), and one reduce-scatter of its gradient, the same bytes,
    with or without a ``pod`` axis (only gradient sums cross it).  A
    prefill gathers at every use: each matrix once and the tied table
    twice (the lookup and the unembedding), in fp32, and the logits'
    vocab blocks once over "model".

    The gradient sums (all-reduce: ``(n - 1) |x|`` sent, a ring's
    ``2 (n - 1) / n |x|``).  On data 2 x model 1, where no tensor-parallel
    sum is issued: each replicated leaf's gradient (biases and norms,
    whole) once over "data", the loss and its two metrics (``ce``,
    ``load_balance_loss``), and the norm's two partial sums of the
    data-cut groups.  Adding ``pod`` at the same rows a device (the
    model's sums unchanged): every matrix's gradient shard once over
    ``pod`` (15 calls), and the replicated leaves and the three scalars
    summed over (pod, data), four parts in place of two."""
    cfg = configs.get_smoke("qwen2.5-3b")
    d, h, hk, dh, ff, v = 64, 4, 2, 16, 128, 512
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.n_layers) == (d, h, hk, dh, ff,
                                                        v, 2)
    per_layer = (d * h * dh + 2 * d * hk * dh + h * dh * d + 3 * d * ff)
    matrices = v * d + 2 * per_layer            # 106 496 elements
    leaves = 1 + 2 * 7
    f32, bf16 = 4, 2
    for dims, names in (((2, 2), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        mesh = make_test_mesh(dims, names)
        tcfg = dataclasses.replace(dryrun.train_config_for(cfg),
                                   gather_once=True)
        train = dryrun.count_collectives(
            cfg, ShapeConfig("t", "train", 8, 16, 4), mesh, tcfg=tcfg)
        assert train["collective_model"] == "program"
        for kind in ("all-gather", "reduce-scatter"):
            assert train["by_kind"][kind] == matrices // 4 * bf16, kind
            assert train["calls_by_kind"][kind] == leaves, kind
        assert train["total_bytes"] == sum(train["by_kind"].values())
        rows = 16 // math.prod(dims[:-1])
        serve = dryrun.count_collectives(
            cfg, ShapeConfig("p", "prefill", 8, 16), mesh)
        assert serve["by_kind"]["all-gather"] == (
            (matrices + v * d) // 4 * f32 + rows * (v // 2) * f32)
        assert serve["calls_by_kind"]["all-gather"] == leaves + 2
        assert "reduce-scatter" not in serve["by_kind"]

    def all_reduce(dims, names, batch):
        rec = dryrun.count_collectives(
            cfg, ShapeConfig("t", "train", 8, batch, 4),
            make_test_mesh(dims, names), tcfg=tcfg)
        return (rec["calls_by_kind"]["all-reduce"],
                rec["by_kind"]["all-reduce"],
                rec["ring_by_kind"]["all-reduce"])

    biases = h * dh + 2 * hk * dh
    whole = 2 * (biases + 2 * d) + d            # 576 elements, 11 leaves
    assert all_reduce((2, 1), ("data", "model"), 8) == (
        11 + 3 + 2, (whole + 3 + 2) * f32, (whole + 3 + 2) * f32)
    # biases halved over "model"
    replicated = 2 * (biases // 2 + 2 * d) + d
    calls, sent, ring = (
        a - b for a, b in zip(
            all_reduce((2, 2, 2), ("pod", "data", "model"), 16),
            all_reduce((2, 2), ("data", "model"), 8)))
    assert calls == leaves
    assert sent == matrices // 4 * f32 + (3 - 1) * (replicated + 3) * f32
    assert ring == (matrices // 4 * f32
                    + (replicated + 3) * (2 * 3 * f32 // 4 - f32))


def test_main_writes_a_record(tmp_path, monkeypatch):
    """``dryrun.main`` and ``roofline.main`` for one fast cell
    (qwen2.5-3b's decode_32k on 16x16): the reference's record keys and
    the port's."""
    monkeypatch.chdir(tmp_path)
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k"])
    recs = json.loads((tmp_path / "experiments" /
                       "dryrun_torch_single.json").read_text())
    (rec,) = recs
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    for key in ("build_s", "count_s", "memory", "cost", "collectives",
                "compute_s", "memory_s", "collective_s", "dominant",
                "model_flops", "useful_fraction", "roofline_fraction"):
        assert key in rec, key
    mem = rec["memory"]
    assert mem["temp_bytes"] is None and mem["temp_reason"]
    assert mem["resident_bytes"] == (mem["argument_bytes"]
                                     + mem["output_bytes"]
                                     - mem["alias_bytes"])
    assert rec["collectives"]["collective_model"] == "program"
    assert rec["collectives"]["total_bytes"] == sum(
        rec["collectives"]["by_kind"].values())
    # the roofline prices the ring volume, at most the bytes sent
    assert rec["collectives"]["roofline_bytes"] == "ring_total_bytes"
    assert rec["collective_s"] == (rec["collectives"]["ring_total_bytes"]
                                   / roofline.NVLINK_BW)
    assert 0 < (rec["collectives"]["ring_total_bytes"]
                <= rec["collectives"]["total_bytes"])
    assert rec["cost"]["flops"] * 16 == rec["cost"]["share_flops"]
    assert rec["memory_s"] == rec["cost"]["bytes_accessed"] / roofline.HBM_BW
    skipped = dryrun.run_cell("qwen2.5-3b", "long_500k")
    assert skipped["status"] == "skipped" and "500k" in skipped["reason"]
    out = tmp_path / "roof.json"
    roofline.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                   "--out", str(out)])
    (roof,) = json.loads(out.read_text())
    assert roof["status"] == "ok" and roof["dominant"] in (
        "compute", "memory", "collective")
    for key in ("flops_per_chip", "dot_flops_per_chip",
                "traffic_bytes_per_chip", "collective_bytes_per_chip",
                "collective_by_kind", "lever"):
        assert key in roof, key


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_every_arch_decode_cell_ends_ok(arch, mesh_name):
    """Every arch's decode_32k cell on the reference's production meshes
    ends ``ok``: its mesh program (``count_collectives``) builds and runs
    on the stand-in mesh, so a layout the port refuses (rwkv6-3b's 40
    heads on the 16-wide ``model`` until the cut inside a head was
    ported) shows here as an ``error`` with its message."""
    rec = dryrun.run_cell(arch, "decode_32k", multi_pod=MESHES[mesh_name])
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == mesh_name
    assert rec["collectives"]["calls_by_kind"]
