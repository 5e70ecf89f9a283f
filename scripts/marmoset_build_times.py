"""Host build times of ``marmoset(scale, n_areas=8)`` at a few scales: the
1-shard build and the 4x2 stacked build, each timed on its own.

    python3 scripts/marmoset_build_times.py [SCALE ...]

``chip_smoke.py``'s ``dist_marmoset`` builds both at ``MARMOSET_SCALE``;
this script is how that scale was chosen (the largest whose two builds
take under about 15 s together on the card's host).  Prints one JSON line
per scale: neurons, live synapses, and the two build times in seconds.
Host only: it needs neither a card nor JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import builder, models  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402


def main(scales) -> None:
    for scale in scales:
        spec = models.marmoset(scale, n_areas=8)
        t0 = time.perf_counter()
        g = builder.build_shards(spec, dist.mesh_decompose(spec, 1, 1))[0]
        t1 = time.perf_counter()
        dist.prepare_stacked(spec, dist.mesh_decompose(spec, 4, 2), 4, 2)
        t2 = time.perf_counter()
        print(json.dumps({"scale": scale, "neurons": spec.n_neurons,
                          "synapses": int((g.delay > 0).sum()),
                          "build_1_shard_s": t1 - t0,
                          "build_4x2_s": t2 - t1}), flush=True)
        del g


if __name__ == "__main__":
    main([float(x) for x in sys.argv[1:]] or [0.02, 0.03, 0.04])
