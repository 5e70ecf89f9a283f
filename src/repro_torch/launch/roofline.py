"""Roofline analysis per (arch x shape x mesh) from the LM dry run.

Terms, per device, at an H100 SXM's published rates (NVIDIA H100 Tensor
Core GPU datasheet; the port's one definition of them):

    compute_term    = FLOPs_per_device / 989 TFLOP/s (bf16 dense)
    memory_term     = traffic_per_device / 3.35 TB/s (HBM3)
    collective_term = collective_bytes_per_device / 450 GB/s (NVLink 4:
                      900 GB/s per GPU in both directions together)

FLOPs and traffic are the dry run's count of one device's share on
``meta`` (:mod:`repro_torch.launch.dryrun`: per aten op, and K8 charged
its own work), split evenly over the ``model`` axis; the collective
bytes are the ring volume of the collectives one device's share of the
cell's mesh program calls (the record's ``ring_total_bytes``; the bytes
the port sends over gloo, larger for its all-reduces, are its
``total_bytes``).  MODEL_FLOPS =
6*N_active*tokens (train) or 2*N_active*tokens (prefill/decode); the ratio
MODEL_FLOPS/counted FLOPs exposes remat and dispatch overhead
("useful-compute fraction").

The reference (``src/repro/launch/roofline.py``) prices XLA's analysis of
the partitioned HLO at TPU v5e rates; this is the same record for the
port's eager step on the card's rates.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline [--arch A]
        [--shape S] [--out experiments/roofline_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os

PEAK_FLOPS = 989e12      # bf16 dense, tensor cores / card
HBM_BW = 3.35e12         # bytes/s / card
NVLINK_BW = 450e9        # bytes/s into one card

__all__ = ["roofline_cell", "roofline_terms", "model_flops", "lever_hint",
           "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "main"]


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs for the whole step (global, all devices)."""
    _, active = cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence + KV-cache attention reads are
    # memory-side, not FLOPs-side
    return 2.0 * active * shape.global_batch


def lever_hint(dominant: str, cfg, shape) -> str:
    if dominant == "collective":
        return ("reduce resharding: overlap the parameter all-gathers with "
                "the GEMMs (FSDP prefetch over NVLink) or widen "
                "per-collective payloads")
    if dominant == "memory":
        if shape.kind == "decode":
            return ("decode is cache-bandwidth bound: shrink KV bytes "
                    "(MLA/GQA compression, quantized cache) or batch more "
                    "sequences per card")
        return ("HBM-bound: fuse elementwise chains and casts, remat less, "
                "stream weights once")
    return ("compute-bound: raise tensor-core utilization (bf16 GEMMs "
            "instead of fp32 ones, bigger per-card tiles)")


def roofline_terms(flops: float, traffic_bytes: float,
                   collective_bytes: float, mf: float,
                   n_devices: int) -> dict:
    """The three terms of one device, the dominant one, and the useful and
    roofline fractions of a step whose devices each count ``flops`` and
    ``traffic_bytes`` and move ``collective_bytes``; ``mf`` is the step's
    :func:`model_flops`."""
    terms = {"compute": flops / PEAK_FLOPS,
             "memory": traffic_bytes / HBM_BW,
             "collective": collective_bytes / NVLINK_BW}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = flops * n_devices
    return dict(
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], dominant=dominant,
        model_flops=mf,
        useful_fraction=mf / total if total else 0.0,
        # roofline fraction: useful work over the time the dominant
        # bottleneck imposes (per device)
        roofline_fraction=((mf / n_devices / PEAK_FLOPS) / bound
                           if bound else 0.0))


def roofline_cell(arch: str, shape_name: str, mesh, *,
                  mesh_name: str = "16x16") -> dict:
    """One cell's roofline record, from its dry run (which counts it)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape_name, multi_pod=mesh_name != "16x16",
                          mesh=mesh)
    out = {"arch": arch, "shape": shape_name, "mesh": rec["mesh"],
           "status": rec["status"]}
    if rec["status"] != "ok":
        out.update({k: rec[k] for k in ("reason", "error") if k in rec})
        return out
    cost, coll = rec["cost"], rec["collectives"]
    out.update(
        analyze_s=round(rec["build_s"] + rec["count_s"], 1),
        flops_per_chip=cost["flops"],
        dot_flops_per_chip=cost["dot_flops"],
        traffic_bytes_per_chip=cost["bytes_accessed"],
        collective_bytes_per_chip=coll["ring_total_bytes"],
        collective_by_kind=coll["ring_by_kind"],
        **{k: rec[k] for k in ("compute_s", "memory_s", "collective_s",
                               "dominant", "model_flops", "useful_fraction",
                               "roofline_fraction")},
        lever=lever_hint(rec["dominant"], configs.get(arch),
                         dryrun.SHAPES[shape_name]))
    return out


def main(argv=None) -> None:
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="experiments/roofline_torch.json")
    args = ap.parse_args(argv)
    mesh = make_production_mesh()  # roofline table is single-pod (spec)
    archs = [args.arch] if args.arch else list(configs.ARCH_NAMES)
    shapes = [args.shape] if args.shape else list(SHAPES)
    results = []
    for arch in archs:
        for shape in shapes:
            try:
                rec = roofline_cell(arch, shape, mesh)
            except Exception as e:  # noqa: BLE001 - report, don't crash
                rec = {"arch": arch, "shape": shape, "status": "error",
                       "error": str(e)[:300]}
            results.append(rec)
            if rec["status"] == "ok":
                print(f"{arch:22s} {shape:12s} dom={rec['dominant']:10s} "
                      f"c={rec['compute_s']*1e3:9.2f}ms "
                      f"m={rec['memory_s']*1e3:9.2f}ms "
                      f"n={rec['collective_s']*1e3:9.2f}ms "
                      f"useful={rec['useful_fraction']:.2f} "
                      f"roofline={rec['roofline_fraction']:.2f}", flush=True)
            else:
                print(f"{arch:22s} {shape:12s} {rec['status']} "
                      f"{rec.get('error', rec.get('reason', ''))[:60]}",
                      flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"-> {args.out}")
    if any(r["status"] == "error" for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
