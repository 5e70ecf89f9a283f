"""The cost of a process mesh sharing one card, before anything is run
on it: N worker processes that each import ``chip_smoke`` (as the
``lm_mesh`` workers do), take the card, join a gloo world as a (1, N)
``("data", "model")`` mesh, sum one small CUDA tensor over ``model``
(one all-reduce through gloo's host route) and exit.

    python3 scripts/mesh_spawn_probe.py [N ...]

N defaults to 4 and 16 (``chip_smoke.py``'s (1, 4) and (1, 16) meshes),
spawned one after the other.  For each N, one JSON line: the wall
seconds from the first start to the last exit, and each process's
seconds to import, to take the card, to join the world, for the
all-reduce, the card's free and total bytes once every process holds
it, and each process's peak RSS.  Every line also writes to
``build/mesh_spawn_probe.json``.  Needs a CUDA device; imports no
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build")

WORKER = """
import json, resource, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
from repro_torch.launch.mesh import join_process_mesh
from repro_torch.sharding import collectives as coll
import torch.distributed as tdist
t_import = time.perf_counter()
torch.cuda.set_device(0)
x = torch.ones(16, device="cuda")
torch.cuda.synchronize()
t_card = time.perf_counter()
mesh = join_process_mesh((1, int(sys.argv[2])), ("data", "model"),
                         device=torch.device("cuda"))
t_join = time.perf_counter()
y = coll.all_reduce_sum(x, mesh, ("model",))
torch.cuda.synchronize()
t_sum = time.perf_counter()
tdist.barrier()
free, total = torch.cuda.mem_get_info()
print(json.dumps({"rank": mesh.rank, "import_s": t_import - t0,
                  "card_s": t_card - t_import, "join_s": t_join - t_card,
                  "all_reduce_s": t_sum - t_join, "sum": float(y[0]),
                  "card_free_bytes": free, "card_total_bytes": total,
                  "peak_rss_kib": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss}), flush=True)
tdist.destroy_process_group()
"""


def spawn(n: int) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.multihost import _free_port
    env = dict(os.environ, REPRO_COORD_ADDR=f"127.0.0.1:{_free_port()}",
               REPRO_NUM_PROC=str(n), LOCAL_WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, ROOT, str(n)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=dict(env, REPRO_PROC_ID=str(r)))
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    bad = [(r, p.returncode, err[-2000:]) for r, (p, (_, err))
           in enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise SystemExit(f"mesh_spawn_probe: processes failed: {bad}")
    per = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    if any(p["sum"] != n for p in per):
        raise SystemExit(f"mesh_spawn_probe: the all-reduce gave {per}")
    return {"processes": n, "wall_s": wall,
            **{k: [p[k] for p in per] for k in (
                "import_s", "card_s", "join_s", "all_reduce_s",
                "card_free_bytes", "peak_rss_kib")},
            "card_total_bytes": per[0]["card_total_bytes"]}


def main(argv) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mesh_spawn_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    os.makedirs(OUT, exist_ok=True)
    recs = []
    for n in [int(a) for a in argv] or [4, 16]:
        rec = {"device": smi, "cpus": os.cpu_count(), **spawn(n)}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    with open(os.path.join(OUT, "mesh_spawn_probe.json"), "w") as f:
        json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
