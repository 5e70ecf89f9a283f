"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the paper's verification case (§IV.A): NEST's
``hpc_benchmark`` with pl-STDP at scale 1 (11 250 neurons, 12.66 M
synapses), built on one shard and stepped by ``engine.run`` through the
``"cuda"`` backend, whose kernels are hand-written CUDA C++ for Hopper
(``src/repro_torch/kernels/csrc/``): K1 with the LIF step as its epilogue
(K1 + K2 in one launch) and K3.  Phases, one JSON line each:

1. device   - the card (``nvidia-smi``), the kernels' build time and the
              registers and spills of K1's four instantiations (``ptxas``:
              K1 alone and with the LIF, Izhikevich and AdEx epilogues);
2. kernel   - K1, K2, K3 and K1 + K2 fused at the main path's shapes on
              seeded random inputs: each against its plain-torch twin
              (tolerance printed), the fused kernel also bitwise against
              K1 -> add -> K2 with the drive on and off, twice for bitwise
              determinism, timed with CUDA events (one call, and per launch
              over many; the fused kernel against K1 alone in turns);
3. lockstep - 120 steps of scale 1 where the ``"cuda"`` and ``"flat"``
              backends start every step from the same state and drive;
4. mixed    - 120 free-running steps of a small mixed network, drive off:
              identical spike rasters on both backends;
5. main     - 2000 steps of scale 1 through ``engine.run``: the fused
              kernel and K3 launched once per step and no other kernel,
              weights bounded, state finite, rate in the
              asynchronous-irregular band, E's and I's rates per 250
              steps from step 500 on in the band of the JAX reference's
              six keys (``keyed_band``); then a profiled window.

The neuron-model zoo, on the same card (``python3 chip_smoke.py`` runs
every phase; each path's launch counts are set to 0 just before it and
read just after):

6. kernel       - K4 ``izhikevich_step`` and K5 ``adex_step`` at 10 000
                  neurons, the ``model_demo`` tables: against their plain
                  twins, deterministic, timed; then K1 + K4 and K1 + K5
                  fused at ``model_demo("izhikevich"|"adex", 1.0)``'s
                  shapes, as K1 + K2 above;
7. zoo_lockstep - ``model_demo("izhikevich"|"adex", 1.0, stdp=True)``, 120
                  steps where the ``"cuda"`` and ``"flat"`` backends start
                  every step from the same state: identical spikes away
                  from ``v_peak``;
8. zoo_main     - the same two networks, 2000 steps each through
                  ``engine.run``: K1 + K4 or K1 + K5 fused, and K3, once
                  per step, state finite, the rate per 250 steps inside a
                  band around the JAX reference's own CPU run
                  (``scripts/reference_zoo_rates.json``, written by
                  ``scripts/reference_zoo_rates.py``, which also sets each
                  network's scale and length here); then each network
                  through ``"cuda:sparse"`` (``zoo_gate``: K6, the
                  standalone K4 or K5, K3 or K7), bitwise equal to the
                  fused run;
9. composite    - ``brunel(1.0, poisson_input=True)`` ("lif+poisson"),
                  2000 steps on the port's own emitter draws: K1 and K2
                  once per step, the emitter rate within 4 sigma, E and I
                  rates inside a band around the reference's, emitter
                  state frozen.

The activity gate (``"cuda:sparse"``, kernels K6 and K7):

10. kernel        - K6 ``blocked_reduce_sweep`` and K7
                    ``stdp_update_worklist`` at the main path's shapes, on
                    a worklist of 8 random blocks of 44 with sentinel
                    padding, the empty list, the identity list, a saturated
                    list and (K6) no list: each against its plain twin,
                    twice for bitwise determinism, K6 bitwise equal to K1's
                    sums and K7 to K3's weights on the listed blocks,
                    timed;
11. gate_main     - ``hpc_benchmark(1.0, stdp=True)``, 2000 steps of
                    ``engine.run`` with ``"cuda:sparse"`` (capacity 44: the
                    dense reduce, no branch) and with
                    ``"cuda:sparse:1e-7"`` (capacity 8), from the ``main``
                    phase's seed: spikes, ``v_m`` and weights bitwise equal
                    to the ``main`` run; ``gate_overflow`` equal to the
                    saturated steps recomputed from the raster, with steps
                    on both branches and K7 updating live blocks;
12. gate_activity - the reference's area-localized gate geometry
                    (``benchmarks/bench_snn.py::_area_localized_layout``)
                    widened to NB 64 x EB 196 608 (12.58 M slots): dense
                    ``"cuda"`` (K1 + K3) against ``"cuda:sparse"`` (pre-pass
                    + K6 + K7) at active fractions 1 to 1/32, bitwise
                    equal, timed.

The LM face's serving path (dense GQA, kernel K8), after the zoo:

13. kernel   - K8 ``flash_attention``: first the built library's SASS,
               counted for HGMMA (``wgmma``) instructions; then qwen2.5-3b's
               prefill shape (q (4, 512, 16, 128), k / v (4, 512, 2, 128),
               bf16, causal), the four fp32 cases of
               ``tests/test_flash_attention.py`` and six bf16 cases (ragged,
               internvl2-1b's heads, cross, dv < dh, no grouping, S = T =
               4096), and qwen2.5-3b's prefill_32k share (B 2, S = T =
               32 768; its twin timed over 5 calls): each through the
               route its dtype must take (bf16 on the tensor cores, fp32
               on the CUDA cores), against its plain
               twin (tolerance printed), twice for bitwise determinism,
               timed, beside one call of PyTorch's
               ``scaled_dot_product_attention`` (a yardstick the port never
               calls);
14. lm_serve - ``qwen2.5-3b`` at its full published config (36 layers, no
               cut), weights drawn on the card in bf16 from the seed:
               ``BatchServer(slots=4, max_len=1024)`` serves one wave of
               prompts of 512, 448, 320 and 200 seeded tokens, 32 new tokens
               each.  K8 launches once per layer in the prefill, all on the
               tensor-core route, and never in decode; logits finite; the prefill's logits against the same
               model with K8's plain twin swapped in; a 4-token decode chain
               against ``forward`` over prompt + tokens at those positions;
               a second wave gives the same tokens.  Prints prefill and
               decode times, peak memory and two profiled windows.

The LM face's other families (MoE, MLA, Mamba, RWKV-6, the encoder-decoder),
after ``lm_serve``, each at its published width, built, checked and freed
before the next:

14b. lm_families - ``deepseek-v3-671b`` cut to 4 of 61 layers (the 3 dense
                   MLA layers and one MoE layer: 256 experts, top 8, one
                   shared, capacity factor 1.25) served through
                   ``BatchServer`` as ``lm_serve`` serves qwen2.5-3b, a
                   second wave identical and the wave's MoE drop fraction;
                   ``qwen3-moe-30b-a3b`` (12 of 48 layers),
                   ``jamba-v0.1-52b`` (8 of 32: one period), ``rwkv6-3b``
                   (4 of 32) and ``whisper-tiny`` (4 + 4, 1500 frames drawn
                   from the seed) through ``Model.prefill`` and
                   ``Model.decode``.  For each: K8's launches per prefill,
                   all on ``"wgmma"`` (MLA at dh 192, dv 128, 128 KV
                   heads), and per decode step (Whisper's cross-attention
                   only); the prefill's last logits against K8's twin
                   swapped in; a decode chain against the teacher-forced
                   forward (the MoE archs on a dropless copy of the config,
                   its drop fraction 0); prefill and decode tokens/s, peak
                   memory, init seconds and profiled windows by kernel
                   class; then the fp32-output GEMMs (``matmul_f32``,
                   ``bmm_f32``) at qwen3's and DeepSeek-V3's expert shapes
                   against an fp64 product.

LM training (``Model.loss``, ``train.loop``, ``launch/train.py``), after
``lm_families``; attention takes its train route there (the reference's
``_sdpa`` in torch ops), so no train step launches K8:

14c. lm_train - (a) ``matmul_f32`` / ``bmm_f32`` differentiated with bf16
                operands at the unembedding's shape (4096 x 2048 x
                151 936, the tied table's transposed view) and at
                qwen3-moe's expert shape: the product and both gradients
                against fp64 within the fp32 sum's bound (and the
                gradients' one bf16 rounding); (b) qwen2.5-3b's smoke
                config in fp32 and in bf16 on fp32 parameters: one step's
                loss and gradients on the card against the port on the CPU
                from the same parameters (tolerances printed), K8 0 times
                in the step, then a ``BatchServer`` wave of the same model
                launching K8 once per layer; (c) every arch's smoke config,
                fp32 and bf16: one AdamW step, loss finite, gradient norm
                nonzero; (d) the cell: ``launch/train.py --full`` for
                qwen2.5-3b at full width and depth (36 layers, remat
                "dots"), B 4, S 1024, fp32 parameters, AdamW, 10 steps:
                the loss falls, s/step, tokens/s, peak memory, and one
                more step profiled by kernel class; (e) qwen3-moe-30b-a3b
                at full width cut to 4 of 48 layers, 5 steps: s/step, peak
                memory, the MoE drop fraction; (f) the launcher in this
                process, deterministic mode: 10 steps uninterrupted and 5
                + ``--resume`` + 5 of qwen3-moe's smoke config, the
                step-10 checkpoints bitwise equal.

The LM dry run (``launch/dryrun.py``), after ``lm_train``: one device's
share of three 16x16 cells of qwen2.5-3b at full width and depth,
parameters and inputs drawn on the card from the seed:

14d. lm_dryrun - ``prefill_32k`` (B 2, S 32 768), ``decode_32k`` (B 8,
                 one token against a 32 768-row cache) and ``train_4k``
                 (16 microbatches of B 1, S 4 096, fp32 AdamW; depth
                 cut to 14 of 36 layers; 80 GB holds 28); each share
                 counted on ``meta`` by the dry run (by trip count), timed
                 on the card without the counter (peak memory), then
                 counted on the card under ``OpCounter``: the two counts
                 equal op for op (calls, FLOPs, bytes); K8's launches equal
                 the count's K8 calls (36 per prefill at S = T = 32 768);
                 the output finite; ms against the roofline bound
                 ``max(FLOPs / 989e12, bytes / 3.35e12)``.

The LM face on a process mesh (``launch.mesh.ProcessMesh``,
``models.moe_manual``, the mesh train step), after ``lm_dryrun``: four
processes sharing the card over gloo (``core.multihost.initialize``),
``qwen3-moe-30b-a3b`` at published width, a (2, 2) ``("data", "model")``
mesh (experts 4-way over ``("model", "data")``, every dense leaf its
``param_specs`` block: FSDP over ``data``, tensor parallelism over
``model``), each process drawing the single-device model's weights from
the seed and keeping its blocks:

14e. lm_mesh - (a) a prefill of 4 x 128 seeded tokens and 4 seeded
               decode steps at capacity factor 16 (nothing drops), depth
               cut to LM_MESH_LAYERS, in fp32 (logits within 1e-3 of the
               single-process run's largest) and bf16 (within 0.1), the
               routes of the single-process run replayed on the mesh and
               the share whose own top-k differs reported; K8 once per
               layer in each process's prefill; (b) at the published
               capacity factor: the drop fraction, prefill and decode
               tokens/s per process, and one ``all_to_all`` of the
               prefill's dispatch buffer alone, by CUDA events, with its
               bytes; (c) LM_MESH_TRAIN_LAYERS layers: 3 AdamW steps on
               fp32 parameters (capacity factor 16) held to the
               single-process run, a checkpoint of global leaves, one
               Adafactor step and a loss after it; then the checkpoint
               restored onto a (1, 2) mesh of two processes and 2 more
               steps, held to one process resumed from it; (d)
               ``qwen2.5-3b`` at published width,
               LM_MESH_DENSE_TRAIN_LAYERS deep: 3 AdamW steps of 4 x 512 seeded tokens, fp32 parameters
               and bf16 compute, held to one process (the first loss
               within 1e-3, all within 1e-2); per-process peak memory,
               s a step, and one reduce-scatter of the largest leaf's
               gradient alone, by CUDA events, with its bytes; (e)
               ``jamba-v0.1-52b`` (8 layers) and ``deepseek-v3-671b``
               (4) at published width in bf16, MoE dropless (capacity
               factor at least E / k), a prefill of 4 x 128 and 2 decode
               steps held to one process (the routes replayed; within
               0.1, or twice the one-process run's distance from itself
               run row by row), K8 on each process's local heads, and
               no token dropped, each cache the reference's
               ``cache_specs`` blocks (a quarter of one process's bytes;
               deepseek-v3's c_kv and k_rope a block of the sequence over
               model, its decode the distributed softmax);
               deepseek-v3's MLA in fp32 (1 dense layer, a prefill and 2
               decode steps) within 1e-3 of one process's largest
               logit; on the same parameters a batch-1 serve
               (``replicated_batch``, ``seq_shard``) against one process,
               2 decode steps: jamba into 524 288 rows (the GQA layer's
               sequence over data, its kv heads over model), gated as
               the bf16 leg, and deepseek-v3's fp32 MLA into 132 rows
               (c_kv and k_rope over ("data", "model")) within 1e-3; (f)
               ``rwkv6-3b`` at published width, 1 layer, 3 AdamW steps
               held to one process as (d); (g) ``whisper-tiny`` at
               published width and depth (4 + 4 layers, 3 of 6 heads a
               process, the 51 865-row table cut over data on d): a
               prefill of 4 x 128 seeded tokens and (4, 1500, 384) seeded
               frames into 132 rows and 2 decode steps, fp32 within 1e-3
               of one process's largest logit and bf16 as (e), K8 12 times
               a prefill and 4 a decode token in each process, each
               ``self`` and ``cross_kv`` leaf the reference's
               ``cache_specs`` block (the kv heads over model: a quarter
               of one process's bytes); the same at batch 1
               (``seq_shard``, ``replicated_batch``: the rows and frames
               also over data, 66 of 132 and 750 of 1 500), K8 12 times a
               prefill and 0 a decode token (the cross-attention the
               distributed softmax); 3 AdamW steps held to one process as
               (d), no K8 launch; (h)
               ``qwen2.5-3b`` at published width, LM_MESH_DENSE_LAYERS
               deep, on a (1, 4) mesh of four processes: its 2 kv heads
               do not divide model, so the cache holds every kv head on a
               quarter of the sequence and the decode is the distributed
               softmax; fp32: 4 x 128 seeded tokens into 136 rows (34 a
               block), 4 decode steps, logits within 1e-3 of one
               process's largest; bf16: into 32 768 rows (0.40 GB a
               process of 1.61 GB), 2 decode steps, within 0.1, the
               decode's peak memory rise below 5 % of the whole cache;
               the cache's bytes, peak memory and s a decode step a
               process against one process's; K8 12 times a prefill on
               4 of 16 heads, never in a decode step; and whisper-tiny
               served as (g) at batch 4 on the same (1, 4): 6 heads do
               not divide 4, so every process attends with every head and
               holds every head on a quarter of the rows and frames (33
               of 132, 375 of 1 500), K8 12 times a prefill on 6 heads
               and 0 a decode token, gated as (g); (i)
               ``rwkv6-3b`` at published width, 1 layer, fp32, on a
               (1, 16) mesh of sixteen processes: the reference's 16-wide
               model axis cuts its 40 heads of 64 inside a head (160
               channels a process), so every process gathers ``wr``,
               ``wk``, ``wv`` and ``wg`` over model and runs all 40
               heads; a prefill of 2 x 32 seeded tokens and 2 decode
               steps within 1e-3 of one process's largest logit, one
               AdamW step at lr 1e-5 whose loss (and the loss after it)
               is within 1e-5 of one process's, every leaf its
               ``param_specs`` block, the state cache whole (all 40
               heads, the bytes of one process's).  Every task's
               processes record the collectives they call
               (``collectives.tally``); for (g), (h) and (i) each
               prefill's, each decode step's and the first train step's
               of (g) and (i) must equal
               ``launch.dryrun.count_collectives``' count on ``meta`` of
               the same arch, mesh, batch and length (the prompt's, or the
               cache's rows), kind by kind, in bytes and in calls.  Every
               mesh's processes are forked by one fork server that
               imported this script and ``torch._dynamo`` once, without
               taking the card.

The distributed step (``repro_torch.core.distributed``: the two-tier spike
exchange and its wire codecs, shards stacked on the card), after the gate:

15. dist_main     - ``hpc_benchmark(1.0, stdp=True)``, one drive array
                    (2000 x 11 250) drawn on the card from the seed: 2000
                    steps of 1 shard (``engine.run``) and of 1x2 and 2x2
                    stacked shards (``distributed.run``, ``"cuda"``, area
                    mode, packed wire, overlap), each fed its slices by
                    global id; spikes, final ``v_m`` and final weights
                    (each post neuron's incoming edges in builder order)
                    bitwise equal to the 1-shard run's, K1 + K2 and K3
                    launched once per shard per step and nothing else;
                    steps/s per shard count, peak memory, wire bytes per
                    codec and mode;
    dist_grid     - at 2x2, from the packed run's state at step 1000, 200
                    steps of every wire pair (packed, f32, u8, sparse,
                    sparse:0.5, packed intra + sparse remote) in both comm
                    modes with overlap on and off: spikes equal, no wire
                    overflow; a starved sparse wire (capacity 1) reports
                    overflow; ``"cuda:sparse"`` (K6, K2, K3 or K7 per
                    shard) bitwise equal, ``gate_overflow`` per shard;
    dist_profile  - a profiled window at 2x2: device ms per step by kernel
                    and by exchange tier, launches per step, idle share,
                    and the exchange alone timed with CUDA events;
    dist_marmoset - ``marmoset(0.02, n_areas=8)`` on 4x2 (the boundary
                    tier between areas): 500 steps stacked equal to 1 shard
                    in spikes, area traffic below global, boundary sets
                    below the shard width.

The multi-host path (``repro_torch.core.multihost`` through
``repro_torch.launch.multihost.run_launcher``: two worker processes on the
card, gloo, ``"cuda"``, area mode, overlap, each process building and
stepping whole rows of a procedural net), after ``dist_marmoset``:

16. mh_build    - ``hpc_benchmark(1.0, stdp=True)`` procedural, not cut, on
                  2x2 (one row a process): each worker's rows equal, field
                  by field (per-field hashes), those rows of the
                  single-process ``prepare_stacked``; host build seconds
                  and RSS (before the build, peak during it) of each worker
                  against a fresh process's global build;
    mh_main     - the same net, 2000 steps, each shard drawing its drive
                  from its own generator: the global raster, final ``v_m``
                  and final weights bitwise equal to the single-process
                  2x2 stacked run; K1 + K2 and K3 twice a step in each
                  process and nothing else; spikes above a floor; steps/s
                  and the remote tier alone by CUDA events;
    mh_marmoset - ``marmoset(0.02, n_areas=8)`` procedural on 4x2 (two rows
                  a process), 500 steps with packed on both tiers and with
                  packed intra + ``sparse:0.25`` remote (launched
                  together): both bitwise equal to the single-process 4x2
                  run, no wire overflow, the inter-process bytes below
                  ``comm_bytes_global``.

Checkpointing and the fault-tolerant runtime
(``repro_torch.checkpoint.manager``, ``repro_torch.runtime``), after
``mh_marmoset``:

17. ckpt_main     - ``hpc_benchmark(1.0, stdp=True)`` on one shard,
                    ``"cuda"``, the drive on, 2000 steps of
                    ``engine_step`` under ``SimulationSupervisor`` with an
                    in-process ``restore_fn``: an async checkpoint every
                    500 steps, ``ckpt-corrupt@1600,kill@1700`` injected
                    (raise mode), so the restore walks back past the
                    corrupted step-1500 checkpoint to step 1000 and
                    replays; raster, ``v_m`` and weights bitwise the
                    ``main`` run's; K1 + K2 and K3 once per step actually
                    run (replays included); each save's blocking copy and
                    bytes, its background write, the restore;
18. mh_supervised - the launcher's supervised mode, two processes on the
                    card (gloo), the two legs launched together: (a) the
                    ``mh_main`` cell plus ``--save-every 500 --fault-inject
                    kill@1100#1``: one same-topology gang restart from step
                    1000, raster, ``v_m`` and weights bitwise ``mh_main``'s;
                    (b) ``model_demo("lif", 1.0)`` procedural,
                    ``--no-stdp --elastic``, a kill on rank 1 at step 600:
                    the gang shrinks from two processes (2x2) to one (1x2),
                    resumes from step 500 and equals the single-process
                    2x2 run bitwise; each final incarnation launched K1 +
                    K2 (and K3 in (a)) once per shard per step it ran;
                    each incarnation's wall, build and restore seconds.

The multi-tenant sessions (``repro_torch.serve.snn.SessionEngine`` over
``engine.make_session_step_fn``: each active slot stepped in turn through
the kernels of a solo run), after ``ckpt_main``:

19. sessions - ``hpc_benchmark(1.0, stdp=True)`` through ``"cuda"``, not
               cut, sessions of seeds 0, 1, 2, each held bitwise (raster,
               flat weights, ``v_m``, traces, ring) against its solo
               ``engine.run`` of the same seed: (a) 4 slots, an interleave
               of solo steps, a wave of two and a wave of three, 1000 steps
               a session, K1 + K2 and K3 once per session-step and nothing
               else; (b) 2 slots and 3 sessions, 300 steps a call, every
               call past the second evicting the LRU (each save's bytes and
               blocking ms, each restore's ms); (c) ``run_supervised(300,
               save_every=100)`` of two residents, clean and with
               ``kill@170`` (restored from 100; the restart cost against
               the clean run); then ``step_wave``'s aggregate
               session-steps/s at 1, 2 and 4 residents beside ``main``'s
               steps/s, and device memory per resident slot.

Differentiable simulation (``repro_torch.diff``, ``repro_torch.train``),
after ``sessions``:

20. diff - (a) ``hpc_benchmark(1.0, stdp=True)``, 2000 steps through
           ``"cuda"`` with ``surrogate="fast_sigmoid"`` from ``main``'s
           seed: inference's route (K1 with its LIF epilogue, K3), the
           spike cast to float; raster, flat weights, ``v_m`` and traces
           bitwise ``main``'s, the fused K1 and K3 2000 launches each and
           nothing else, steps/s beside ``main``'s; (b) ``brunel(1.0)``
           on ``"flat"`` (the gradient path; no kernel launches),
           diffusion drive, the membrane drawn from the seed:
           ``d mean(spikes) / d weights`` through
           ``rollout.rollout``, naive over 100 steps twice and
           checkpointed (chunks of 25) over 100 and 200 steps (a naive run
           over 200 steps peaks near 73 GB): rasters, generator states
           and gradients equal (gradients to rtol 1e-5), gradients finite
           and non-zero, each peak from ``grad_peak_memory_bytes`` with
           the checkpointed ones below the naive, wall and s per
           simulated step; (c) the reference's reduced brunel inversion
           fit with its bars (g within 0.25, eta within 0.05, the loss
           descending), its wall and evaluations, run as ``examples``'
           fit_brunel leg (phase 25: the same fit); (d) the SNN classifier,
           10 epochs, held-out accuracy at least 3x chance.  The
           reference's full fit (5 % bars, minutes) is
           ``phase_full_inversion()``, run on its own.

The (PB, EB) block shapes (``repro_torch.core.autotune``), after
``gate_main``, on ``main``'s graph:

21. shape_tune - (a) at each candidate PB (128, 256, 512, 1024, each with
                 the tuner's EB) the graph laid out again on the host: K1 +
                 K2 as in phase 2 (against K1 -> add -> K2 and its twin,
                 timed alone and in turns with K1), K3 against its twin,
                 K6 and K7 as in phase 10 (worklists of 8, 0 and NB
                 blocks), each timed (median of 25); one line a PB, and
                 the ``shape_tune/<signature>/pb{PB}xeb{EB}`` records
                 (``us_per_call`` = K1 + K2 + K3) written to
                 ``build/shape_tune.json``;
    shapes     - (b) 2000 steps through ``"cuda:auto"`` from ``main``'s
                 seed: the tuned shape, raster, flat weights, ``v_m`` and
                 traces bitwise ``main``'s, K1 + K2 and K3 2000 launches
                 each, steps/s beside ``main``'s; (c)
                 ``"measured:build/shape_tune.json"`` resolves to the
                 fastest measured candidate, and 200 steps through
                 ``CudaBackend(block_shapes=<that>)`` are bitwise a 200-step
                 ``"cuda"`` run; (d) the gate at the tuned shape,
                 ``CudaSparseBackend(block_shapes="auto")`` at the default
                 rate and at 1e-7, 2000 steps each, bitwise ``main``,
                 ``gate_overflow`` against the raster, steps/s beside
                 ``gate_main``'s.

The lockstep phase (3) also steps the plain ``"bucketed"`` backend beside
``"flat"`` from the same states.

The SNN dry run (``repro_torch.launch.dryrun_snn`` over the raw
distributed step), after ``mh_supervised``:

22. dryrun - (a) the 24 cells of its ``main`` (16x16 and 2x16x16 meshes,
             scales 1 and 4, six wire / dtype / overlap variants), one
             shard's step each on ``meta``, counted per aten op: every cell
             completes with its gathered bytes equal to the wire model's,
             one line each with the three roofline terms at an H100 SXM's
             rates and the dominant one; (b) shard 0 of the 16x16 cells at
             scales 1 and 4 (14.8 M and 59.4 M edges, D = 64) materialized
             on the card from the seed, in int32 and compact dtypes: one
             ``"flat"`` step (peak memory beside the arguments' bytes) and
             200 steps through ``"cuda"`` over blocked consts from the
             port's layout code (K1 + K2 and K3 once a step, the shard
             firing, the two dtypes' rasters equal; ms a step, the host
             relayout's seconds), then 20 steps of ``"cuda"`` against
             ``"flat"`` from the same state and drive each step (spikes
             may differ only near the threshold, as in phase 3), and K1 +
             K2 and K3 against their twins at those shapes; (c) the firing probe at ``hpc_benchmark(1.0)``, 400
             steps, 4x2 rows, through ``"cuda"`` (K1 + K2 400 times).

The repository's entry points (``repro_torch.examples``, the port of
``examples/*.py``), after ``diff``, each driver's ``main`` in this process
at the script's defaults, its launches pinned:

25. examples - run_scenario: brunel 0.02 (K1 + K2 a step), with
               ``--poisson-input`` (K1, then K2), ``--model izhikevich``
               (K1 + K4), on a 2x2 grid (four K1 + K2 a step) and the
               microcircuit at 0.25 for 2000 steps (K1 + K2 a step, no
               K3), its per-population rates from step 500 on in the
               band of the reference's six keys (``keyed_band``) and its
               device ms a step over its last 200 steps; quickstart (rate
               under 10 Hz, plastic weights in bounds, three finite
               losses); simulate_marmoset at 1x1 and 2x2 (the checkpoints
               kept, the restore bitwise, static markers too); serve_snn
               with and without eviction (statuses and ``stats()`` those
               of the CPU's ``"flat"`` run of the same flags); serve_lm
               (K8 once a layer on ``simt``, the tokens the CPU's under
               the margin rule); train_lm at its defaults, then a
               ``--resume`` from its step-50 checkpoint to 60, bitwise the
               whole run; fit_brunel ``--smoke --init-eta 2.2`` (phase
               20's (c)).  The phase's seconds are on its line.

Then one line with every kernel's numbers, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero without that last line.  Without a CUDA device
it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import io
import json
import math
import os
import re
import select
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# cuBLAS reads its workspace setting when the process first uses it: the
# deterministic blocks (lm_train (f), examples' train_lm) need this one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
             "is False")

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import backends, builder, engine, models, snn  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import neuron_models  # noqa: E402
from repro_torch.core import wire as wire_mod  # noqa: E402
from repro_torch.core import stdp as stdp_mod_core  # noqa: E402
from repro_torch.core.decomposition import AreaSpec  # noqa: E402
from repro_torch.core.layout import BlockedGraph  # noqa: E402
from repro_torch import kernels as kernels_pkg  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import adex_step as adex_mod  # noqa: E402
from repro_torch.kernels import izhikevich_step as izh_mod  # noqa: E402
from repro_torch.kernels import lif_step as lif_mod  # noqa: E402
from repro_torch.kernels import stdp_update as stdp_mod  # noqa: E402
from repro_torch.kernels import synaptic_gather as gather_mod  # noqa: E402
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.models import attention as lm_attn  # noqa: E402
from repro_torch.models import encdec as lm_encdec  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import moe_manual as lm_moe_manual  # noqa: E402
from repro_torch import convert as lm_convert  # noqa: E402
from repro_torch.sharding import collectives as lm_coll  # noqa: E402
from repro_torch.sharding import rules as lm_rules  # noqa: E402
from repro_torch.models import transformer as lm_tr  # noqa: E402
from repro_torch.models.layers import bmm_f32, matmul_f32  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import BatchServer  # noqa: E402
from repro_torch.launch import multihost as mh_launch  # noqa: E402
from repro_torch.checkpoint.manager import (  # noqa: E402
    CheckpointManager, network_metadata, state_items)
from repro_torch.runtime.fault import RestartPolicy  # noqa: E402
from repro_torch.runtime.inject import FaultInjector, parse_specs  # noqa: E402
from repro_torch.runtime.supervisor import SimulationSupervisor  # noqa: E402
from repro_torch.serve.snn import SessionEngine  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.diff import classify as diff_classify  # noqa: E402
from repro_torch.diff import rollout as diff_rollout  # noqa: E402
from repro_torch.launch import dryrun as lm_dryrun  # noqa: E402
from repro_torch.launch import dryrun_snn  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import optimizer as train_opt  # noqa: E402
from repro_torch.configs.shapes import SHAPES as LM_SHAPES  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    MeshShape, make_production_mesh)
from repro_torch.utils import op_costs  # noqa: E402
from repro_torch.examples import fit_brunel as ex_fit_brunel  # noqa: E402
from repro_torch.examples import quickstart as ex_quickstart  # noqa: E402
from repro_torch.examples import run_scenario as ex_run_scenario  # noqa: E402
from repro_torch.examples import serve_lm as ex_serve_lm  # noqa: E402
from repro_torch.examples import serve_snn as ex_serve_snn  # noqa: E402
from repro_torch.examples import simulate_marmoset as ex_marmoset  # noqa: E402
from repro_torch.examples import train_lm as ex_train_lm  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16, dense tensor cores
SEED = 0
SLEEP_CYCLES = 10_000_000      # ~5 ms at H100 clocks: covers one enqueue
#: each kernel wrapper, counting its launches in ``.launches``
KERNEL_FNS = {"synaptic_gather": gather_mod.synaptic_gather,
              "lif_step": lif_mod.lif_step,
              "stdp_update": stdp_mod.stdp_update,
              "izhikevich_step": izh_mod.izhikevich_step,
              "adex_step": adex_mod.adex_step,
              "blocked_reduce_sweep": gather_mod.blocked_reduce_sweep,
              "stdp_update_worklist": stdp_mod.stdp_update_worklist,
              "flash_attention": fa_mod.flash_attention}
#: K1 with a neuron epilogue: one wrapper, its launches counted by epilogue
FUSED = gather_mod.synaptic_gather_update
FUSED_KERNELS = {"synaptic_gather_lif": "lif",
                 "synaptic_gather_izhikevich": "izhikevich",
                 "synaptic_gather_adex": "adex"}
REPLACES = {"synaptic_gather": "src/repro/kernels/synaptic_gather.py:106",
            "lif_step": "src/repro/kernels/lif_step.py:71",
            "stdp_update": "src/repro/kernels/stdp_update.py:66",
            "izhikevich_step": "src/repro/kernels/izhikevich_step.py:101",
            "adex_step": "src/repro/kernels/adex_step.py:108",
            "blocked_reduce_sweep":
                "src/repro/kernels/synaptic_gather.py:195",
            "stdp_update_worklist": "src/repro/kernels/stdp_update.py:137",
            "flash_attention": "src/repro/kernels/flash_attention.py:80",
            "synaptic_gather_lif": "src/repro/kernels/synaptic_gather.py:106"
                                   " + src/repro/kernels/lif_step.py:71",
            "synaptic_gather_izhikevich":
                "src/repro/kernels/synaptic_gather.py:106"
                " + src/repro/kernels/izhikevich_step.py:101",
            "synaptic_gather_adex": "src/repro/kernels/synaptic_gather.py:106"
                                    " + src/repro/kernels/adex_step.py:108"}
#: the fields a fused kernel must equal its plain twin in bitwise, by
#: epilogue (the membrane, and u, do not depend on this step's sums; AdEx's
#: expf may differ from torch's exp by ulps)
EXACT_FIELDS = {"lif": ("v", "ref_count", "spike"),
                "izhikevich": ("v", "u", "ref_count", "spike"),
                "adex": ("ref_count", "spike")}
#: the kernels of the hpc_benchmark main path (phase 5)
MAIN_KERNELS = ("synaptic_gather_lif", "stdp_update")
#: the counted run whose launches the kernels line reports for a kernel:
#: a path that runs it once per step (K1, K2, K4 and K5 standalone are off
#: the fused main paths: K1 stays before K2 in the composite, K2, K4 and
#: K5 run after K6)
LAUNCHES_FROM = {"synaptic_gather": "composite",
                 "lif_step": "gate_main cuda:sparse:1e-7",
                 "stdp_update": "main",
                 "izhikevich_step": "zoo_gate izhikevich",
                 "adex_step": "zoo_gate adex",
                 "blocked_reduce_sweep": "gate_main cuda:sparse:1e-7",
                 "stdp_update_worklist": "gate_main cuda:sparse:1e-7",
                 "flash_attention": "lm_serve",
                 "synaptic_gather_lif": "dist_main 2x2",
                 "synaptic_gather_izhikevich": "zoo_main izhikevich",
                 "synaptic_gather_adex": "zoo_main adex"}
#: the kernels of the gated main path (phase 11), by backend: the
#: full-capacity gate reduces densely through K6 and updates through K3,
#: the forced gate (capacity 8 of 44) runs K6 and K7 on every step
GATE_KERNELS = {"cuda:sparse": ("blocked_reduce_sweep", "lif_step",
                                "stdp_update"),
                "cuda:sparse:1e-7": ("blocked_reduce_sweep", "lif_step",
                                     "stdp_update_worklist")}
#: the zoo's two-variable kernels: model -> (kernel module, its wrapper)
ZOO_KERNELS = {"izhikevich": (izh_mod, izh_mod.izhikevich_step),
               "adex": (adex_mod, adex_mod.adex_step)}
#: the kernels of each zoo network's main path (phase 8): K1 + K4 or
#: K1 + K5 in one launch, then K3
ZOO_MAIN_KERNELS = {"izhikevich": ("synaptic_gather_izhikevich",
                                   "stdp_update"),
                    "adex": ("synaptic_gather_adex", "stdp_update")}
#: the distributed cell (phase 15): hpc_benchmark at scale 1 on these
#: (rows, row_width) grids of shards stacked on the card, DIST_STEPS
#: steps each from one drive array, against the 1-shard run; then at 2x2
#: DIST_GRID_STEPS steps of every wire pair in both comm modes with overlap
#: on and off, a starved sparse wire and the gate; then marmoset on
#: MARMOSET_GRID for the boundary tier
DIST_GRIDS = ((1, 2), (2, 2))
DIST_STEPS = 2000
DIST_GRID_STEPS = 200
DIST_WIRES = (("packed", None), ("f32", None), ("u8", None),
              ("sparse", None), ("sparse:0.5", None), ("packed", "sparse"))
#: the largest marmoset scale whose two host builds (1 shard, 4x2) take
#: under about 15 s together (``scripts/marmoset_build_times.py``): 20 000
#: neurons, 7.0 M synapses, max delay 106 steps; it fires from step ~250
MARMOSET_SCALE = 0.02
MARMOSET_GRID = (4, 2)
MARMOSET_STEPS = 500
#: the multi-host cell (phase 16): two worker processes on the card
#: (``repro_torch.launch.multihost``, gloo, ``"cuda"``, area, overlap),
#: each building and stepping its own rows of a procedural net: hpc at
#: scale 1 on MH_GRID (one row a process) for MH_STEPS steps, the drive
#: from each shard's own generator; then marmoset on MARMOSET_GRID (two
#: rows a process) for MH_MARMOSET_STEPS steps on two wire pairs
MH_PROCESSES = 2
MH_GRID = (2, 2)
MH_STEPS = 2000
MH_MARMOSET_STEPS = 500
#: the remote tier's sparse wire provisioned for 25 % of a shard's 400
#: boundary neurons a step (100 ids): at the default 2 % (8 ids) the
#: boundary payload saturated 95 times in 500 steps on the card (NVIDIA
#: H100 80GB HBM3), a lossy run by design; the line prints the measured
#: peak beside the capacity
MH_MARMOSET_WIRES = (("packed", "packed"), ("packed", "sparse:0.25"))
#: hpc at scale 1 fires about 18 000 spikes in 2000 steps (3-15 Hz from
#: step 500, near silence before): fewer than this means a silent run
MH_SPIKE_FLOOR = 5000
#: where the workers write their records and arrays (git-ignored)
MH_DIR = os.path.join(ROOT, "build", "multihost")
#: the in-process checkpoint cell (phase 17): hpc at scale 1 on one shard,
#: CKPT_STEPS steps saved every CKPT_SAVE_EVERY with CKPT_FAULTS injected;
#: the corrupted step-1500 checkpoint sends the restore back to
#: CKPT_RESTORED; CKPT_KEEP checkpoints kept on disk under CKPT_DIR
CKPT_STEPS = 2000
CKPT_SAVE_EVERY = 500
CKPT_FAULTS = "ckpt-corrupt@1600,kill@1700"
CKPT_RESTORED = 1000
CKPT_KEEP = 2
CKPT_DIR = os.path.join(ROOT, "build", "ckpt_main")
#: the supervised launcher's legs (phase 18): (a) mh_main's cell with a
#: kill of rank 1, resumed on the same grid; (b) model_demo("lif", 1.0),
#: procedural, STDP off, a kill of rank 1 and an elastic shrink to one
#: process
MH_SUP_SAVE_EVERY = 500
MH_SUP_FAULT = "kill@1100#1"
MH_SUP_RESUMED = 1000
MH_SHRINK_STEPS = 1000
MH_SHRINK_SAVE_EVERY = 250
MH_SHRINK_FAULT = "kill@600#1"
MH_SHRINK_RESUMED = 500
#: the session cell (phase 19): hpc at scale 1 through "cuda" in
#: ``SessionEngine``, sessions of seeds 0, 1, 2.  (a) SESS_PLAN on 4 slots,
#: each session SESS_STEPS steps; (b) 3 sessions on SESS_EVICT_SLOTS
#: slots, SESS_EVICT_CHUNK steps a call, so that every call past the
#: second evicts the LRU; (c) ``run_supervised(SESS_SUP_STEPS,
#: save_every=SESS_SUP_SAVE_EVERY)`` of two residents, clean and with
#: SESS_SUP_FAULT, restored from SESS_SUP_RESUMED; then step_wave's
#: aggregate rate at SESS_RATE_RESIDENTS residents over SESS_RATE_STEPS
#: steps.  Checkpoints under SESS_DIR, removed after.
SESS_SCALE = 1.0
SESS_SEEDS = (0, 1, 2)
SESS_PLAN = ((0, 200), ((0, 1), 300), (1, 200), ((0, 1, 2), 500), (2, 500))
SESS_STEPS = 1000
SESS_EVICT_SLOTS = 2
SESS_EVICT_CHUNK = 300
SESS_SUP_STEPS = 300
SESS_SUP_SAVE_EVERY = 100
SESS_SUP_FAULT = "kill@170"
SESS_SUP_RESUMED = 100
SESS_RATE_RESIDENTS = (1, 2, 4)
SESS_RATE_STEPS = 200
SESS_DIR = os.path.join(ROOT, "build", "sessions")
#: the differentiable slice (phase 20): the surrogate of the main path's
#: surrogate forward and of every gradient; the kernels the surrogate
#: forward launches once a step: inference's (K1 with its LIF epilogue, K3)
DIFF_SURROGATE = "fast_sigmoid"
DIFF_KERNELS = MAIN_KERNELS
#: (b): the rollout's horizons and chunk at brunel(1.0).  A naive step
#: keeps 23 bytes an edge for the backward (the int64 gather index, the two
#: index_add_ sources, the arrivals, three masks): 15.6 M edges x 200 steps
#: peaked at 72.9 GB of the card's 80, so the naive runs take 100 steps and
#: the checkpointed run both 100 and 200
DIFF_GRAD_STEPS = 100
DIFF_GRAD_LONG = 200
DIFF_GRAD_CHUNK = 25
#: (c): the reference's reduced inversion fit and its bars
#: (tests/test_diff.py::test_brunel_inversion_smoke)
DIFF_INVERSION_SMOKE = dict(init_g=4.0, init_eta=2.2, n_steps=300,
                            adam_iters=8, g_rounds=((0.12, 5),),
                            eta_radii=(0.003, 0.001), eta_points=4)
DIFF_INVERSION_BARS = {"g": 0.25, "eta": 0.05}
#: the reference's full acceptance fit: invert_brunel(4.0, 2.5), 5 % bars
#: (phase_full_inversion, run on its own: it takes minutes)
DIFF_FULL_BARS = {"g": 0.05, "eta": 0.05}
DIFF_CLASSIFIER_EPOCHS = 10
# the shapes phase: the records it writes for "measured:", and the length
# of the measured run
SHAPES_FILE = os.path.join(ROOT, "build", "shape_tune.json")
SHAPES_MEASURED_STEPS = 200
#: the dry run (phase 22): one shard of the 16x16 cells at these scales
#: materialized on the card (the scale-1 and scale-4 shards: 14.8 M and
#: 59.4 M edges, D = 64), DRYRUN_CUDA_STEPS steps through "cuda" in each
#: dtype, then DRYRUN_LOCKSTEP steps of "cuda" against "flat" in lockstep;
#: the firing probe at hpc_benchmark(DRYRUN_PROBE["scale"])
DRYRUN_SHARD_SCALES = (1.0, 4.0)
DRYRUN_CUDA_STEPS = 200
DRYRUN_LOCKSTEP = 20
DRYRUN_PROBE = dict(scale=1.0, steps=400, n_rows=4, row_width=2)
#: the profiled window's labels for the exchange, by tier
EXCHANGE_LABELS = {"_issue_remote": "exchange.remote",
                   "_finish_remote": "exchange.remote",
                   "_issue_intra": "exchange.intra",
                   "_finish_intra": "exchange.intra",
                   "_exchange_issue": "exchange",
                   "_exchange_finish": "exchange"}
#: launches a run of many launches times, per kernel (``loop_ms``)
LOOP_LAUNCHES = 1000
#: SM clock the sleep ahead of a timed run is sized with (H100 SXM boost);
#: ``loop_ms`` checks that the sleep outlasted the host's enqueue anyway
SLEEP_HZ = 2.0e9
#: the JAX reference's own run of each zoo network on the CPU, by network:
#: its scale, steps, rate window, and per population the rate [Hz] per
#: window and from ``mean_from_step`` on (written by
#: ``scripts/reference_zoo_rates.py``: flat backend, jax.random.key(0),
#: drive off)
with open(os.path.join(ROOT, "scripts", "reference_zoo_rates.json")) as f:
    ZOO_REFERENCE = json.load(f)
#: the card's rates against the reference's: each 250-step window within
#: [0.5, 2] x the reference's (the first windows are transients whose
#: timing may shift by a few steps), the mean rate within 10 % for the
#: deterministic model_demo networks and 15 % for the composite, whose
#: emitters draw other random numbers than the reference's
WINDOW_BAND = (0.5, 2.0)
MEAN_BAND = {"izhikevich": 0.10, "adex": 0.10, "lif+poisson": 0.15}
#: the driven networks (hpc_benchmark, microcircuit) have records of six
#: keys, whose drives differ from each other and from the port's: from
#: ``mean_from_step`` on, each 250-step window within WINDOW_BAND of the
#: keys' range, and the mean within KEYED_MEAN_BAND of the keys' mean, or
#: within the keys' own relative spread where that is wider.  The onset
#: windows before it are the first volley's timing, which the reference's
#: own keys do not share (microcircuit's L2/3I: 29 Hz in keys 0 and 1,
#: 1.2-9.6 Hz in keys 2-5), and two keys were too few: keys 2-5 leave the
#: band of keys 0 and 1 (PERF.md §6)
KEYED_MEAN_BAND = 0.15
#: K8's cases (phase 13): (b, s, t, h, hk, dh, dv, causal, dtype); the
#: first is qwen2.5-3b's prefill of the lm_serve wave, then the four fp32
#: cases of tests/test_flash_attention.py (the SIMT route), then bf16 cases
#: of the tensor-core route: qwen2.5-3b's heads at a ragged length (masks
#: in the tail tile), internvl2-1b's LLM heads (14 over 2, dh 64), cross
#: attention with S != T, dh 64 against dv 32, no grouping, a long
#: causal prefill whose 64 key tiles pass many times through the ring,
#: and the shapes phase 14b gives it: DeepSeek-V3's MLA prefill (128 heads
#: over 128, dh 192 against dv 128), Whisper's encoder (S = T = 1500,
#: ragged against 64-key tiles) and its cross-attention at decode (one
#: query row against 1500 frames)
FLASH_CASES = {
    "qwen2.5-3b_prefill": (4, 512, 512, 16, 2, 128, 128, True,
                           torch.bfloat16),
    "gqa_ragged": (2, 300, 300, 8, 2, 32, 32, True, torch.float32),
    "mha": (1, 128, 128, 4, 4, 16, 16, True, torch.float32),
    "cross": (2, 100, 150, 4, 4, 16, 16, False, torch.float32),
    "dv_ne_dh": (1, 257, 257, 2, 1, 64, 32, True, torch.float32),
    "qwen_heads_ragged": (2, 300, 300, 16, 2, 128, 128, True,
                          torch.bfloat16),
    "internvl2-1b_heads": (2, 333, 333, 14, 2, 64, 64, True,
                           torch.bfloat16),
    "cross_bf16": (2, 100, 150, 4, 4, 64, 64, False, torch.bfloat16),
    "dv_lt_dh_bf16": (1, 257, 257, 2, 1, 64, 32, True, torch.bfloat16),
    "mha_bf16": (1, 200, 200, 8, 8, 128, 128, True, torch.bfloat16),
    "long_causal": (1, 4096, 4096, 16, 2, 128, 128, True, torch.bfloat16),
    "deepseek-v3_mla_prefill": (4, 512, 512, 128, 128, 192, 128, True,
                                torch.bfloat16),
    "whisper_encoder": (4, 1500, 1500, 6, 6, 64, 64, False, torch.bfloat16),
    "whisper_cross_decode": (4, 1, 1500, 6, 6, 64, 64, False,
                             torch.bfloat16),
    "qwen2.5-3b_prefill_32k": (2, 32_768, 32_768, 16, 2, 128, 128, True,
                               torch.bfloat16),
}
#: cases this long time the twin over fewer calls (each is about a second)
FLASH_LONG_PAIRS, FLASH_LONG_REPS = 2 ** 28, 5
#: the route each dtype's cases must take (``flash_attention._route``)
FLASH_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "simt"}
#: K8 against its twin: fp32 sums in another order; bf16 adds the output's
#: one rounding (one ulp, 2^-7 relative at most)
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
#: the lm_serve cell (phase 14): qwen2.5-3b at its full published config
LM_ARCH = "qwen2.5-3b"
LM_SLOTS, LM_MAX_LEN, LM_NEW_TOKENS = 4, 1024, 32
LM_PROMPT_LENS = (512, 448, 320, 200)
LM_CHAIN = 4
#: bf16 logits (of order 1) of two orders of the same sums through 36
#: layers: the K8/twin swap and the decode chain against forward
LM_LOGIT_ATOL = 0.1
#: the K8/twin swap with the model in fp32: fp32 sums in another order
LM_LOGIT_ATOL_F32 = 1e-3
#: the lm_families cell (phase 14b): each arch at its published width,
#: the depth run (None: all of it; a cut where 80 GB forces one, and
#: rwkv6-3b's, whose prefill steps a Python loop over time per layer, to
#: 4 of 32 layers for the script's time: all 32 took 76-93 s of it, 8
#: took 18.4 s and 4 9.7 s, and the phases before lm_mesh vary by 127 s
#: between cards of one name and power limit),
#: K8's launches per prefill and per decode step at that depth, and
#: whether the decode chain is held against forward in fp32 (its bf16
#: chain measured, not held: rounding moves these two random-weight
#: networks' bf16 logits past LM_LOGIT_ATOL at the decode steps, jamba's
#: to 0.101, rwkv6-3b's to 0.99, while their fp32 chains agree)
LM_FAMILIES = {
    "deepseek-v3-671b": dict(layers=4, k8_prefill=4, k8_decode=0),
    "qwen3-moe-30b-a3b": dict(layers=12, k8_prefill=12, k8_decode=0),
    "jamba-v0.1-52b": dict(layers=8, k8_prefill=1, k8_decode=0,
                           chain_fp32=True),
    "rwkv6-3b": dict(layers=4, k8_prefill=0, k8_decode=0,
                     chain_fp32=True, cut="the script's time (a Python "
                     "loop over time per layer)"),
    "whisper-tiny": dict(layers=None, k8_prefill=12, k8_decode=4),
}
#: the arch served through ``BatchServer`` (twice, the second wave
#: identical); the others run ``Model.prefill`` and ``Model.decode``
LM_FAMILY_SERVED = "deepseek-v3-671b"
#: the reference's ``_dropless``: capacity factor 16 for the decode chain
#: against forward, whose tokens compete differently
LM_DROPLESS_CF = 16.0
#: the chain against forward may differ by this many times the distance
#: of forward from itself run row by row (another rounding of the same
#: function), where that is above the tolerance: rwkv6-3b's random
#: weights part its bf16 forward from itself so by 0.62-1.24 on an H100
LM_CHAIN_FLOOR_FACTOR = 2.0
#: fp32-output GEMMs against fp64: (M, K, N) per expert and experts, at
#: qwen3-moe's and DeepSeek-V3's expert shapes (M = the served wave's
#: capacity: 160 and 80 rows)
GEMM_F32_CASES = {"qwen3-moe-30b-a3b": (160, 2048, 768, 8),
                  "deepseek-v3-671b": (80, 7168, 2048, 8)}


def emit(record: dict) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    record.setdefault("t_s", time.perf_counter() - T_START)
    print(json.dumps(record), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` over ``reps`` calls.

    CUDA events bracket each call; a sleep kernel ahead of them keeps the
    stream busy while the host validates and enqueues the call, so the
    events time the device work and not the Python in front of it.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_ms(fn, count: int = LOOP_LAUNCHES, batch: int = 500,
            warmup: int = 3) -> float:
    """Device time per launch of ``fn`` over ``count`` back-to-back
    launches (a small kernel is timed this way because one launch alone is
    shorter than the host's launch overhead): in batches, CUDA events around each batch, and a sleep kernel
    ahead of it sized to outlast the host's enqueue of the whole batch, so
    that the events see the launches run back to back and not the host's
    pace.  A batch whose sleep ended before the host had enqueued it (the
    host was slower than estimated, or the launch queue filled) is not
    counted: it is run again at half the size, down to 50 launches, and
    then the call raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    per_call_s = (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    total, left = 0.0, count
    while left > 0:
        k = min(batch, left)
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(int(3 * k * per_call_s * SLEEP_HZ))
        a.record()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if enqueue_ms >= e0.elapsed_time(a):
            check(batch > 50, f"loop_ms: the host took {enqueue_ms} ms to "
                  f"enqueue {k} launches, longer than the sleep of "
                  f"{e0.elapsed_time(a)} ms ahead of them")
            batch //= 2
            continue
        total += a.elapsed_time(b)
        left -= k
    return total / count


def in_turns(fns: dict, rounds: int = 2, count: int = 200) -> dict:
    """``loop_ms`` of each of ``fns`` (two), in turns A B B A per round;
    returns each one's median per-launch ms over its runs."""
    (na, fa), (nb_, fb) = fns.items()
    got = {na: [], nb_: []}
    for _ in range(rounds):
        for name, fn in ((na, fa), (nb_, fb), (nb_, fb), (na, fa)):
            got[name].append(loop_ms(fn, count=count))
    return {k: statistics.median(v) for k, v in got.items()}


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    kernels_pkg.reset_launch_counts()


def read_launches() -> dict:
    """Every kernel's launch count, the fused kernel's by epilogue."""
    return kernels_pkg.launch_counts()


def check_launches(what: str, launches: dict, want: dict) -> None:
    """Each kernel of ``want`` launched exactly that often, every other
    kernel never."""
    for k, c in launches.items():
        check(c == want.get(k, 0), f"{what}: {k} launched {c} times, "
              f"expected {want.get(k, 0)}")


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = _build.build_all()
    # registers and spills of K1's four instantiations (none, LIF,
    # Izhikevich, AdEx epilogue): an epilogue's registers can cost K1
    # occupancy
    regs = k1_registers(built["ptxas"]["synaptic_gather"])
    check(sorted(regs) == sorted((*FUSED_KERNELS, "synaptic_gather")),
          f"ptxas reported K1's entry functions as {sorted(regs)}")
    emit({"phase": "device", "card": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": built["seconds"], "synaptic_gather_ptxas": regs})
    return smi


def k1_registers(log: str) -> dict:
    """Registers and spill bytes of each of K1's entry functions in its
    ``nvcc -Xptxas -v`` log, by ``read_launches`` name: the epilogue's
    struct names the fused instantiation."""
    by_struct = {"LifStep": "synaptic_gather_lif",
                 "IzhikevichStep": "synaptic_gather_izhikevich",
                 "AdexStep": "synaptic_gather_adex"}
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = next((v for k, v in by_struct.items() if k in m.group(1)),
                        "synaptic_gather")
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[name]["spill_store_bytes"] = int(m.group(1))
                out[name]["spill_load_bytes"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


# --------------------------------------------------------------------------
# phase 2: each kernel at the main path's shapes
# --------------------------------------------------------------------------

def phase_kernels(g) -> dict:
    rng = np.random.default_rng(SEED)
    bg = g.blocked
    nb, eb, pb, d, m = bg.nb, bg.eb, bg.pb, g.max_delay, g.n_mirror
    out = {}
    live = int((bg.delay > 0).sum())

    # K1: the edge pass on the built layout, random weights/ring/fresh
    bounds = gather_mod.segment_bounds(bg.post_rel, bg.delay, pb=pb,
                                       max_delay=d)
    w = torch.from_numpy(rng.normal(0, 50, (nb, eb)).astype(np.float32)
                         ).to(DEV)
    ring = torch.from_numpy((rng.uniform(size=(d, m)) < 0.05)
                            .astype(np.float32)).to(DEV)
    fresh = torch.from_numpy((rng.uniform(size=m) < 0.05)
                             .astype(np.float32)).to(DEV)
    t = torch.tensor(7, dtype=torch.int32, device=DEV)   # t < D: floor-mod
    args = (bg.pre_idx, bg.post_rel, w, bg.delay, bg.channel, ring, t)
    errs = {}
    for name, fr in (("no_fresh", None), ("fresh", fresh)):
        k1 = gather_mod.synaptic_gather(*args, max_delay=d, pb=pb, fresh=fr,
                                        bounds=bounds)
        k2 = gather_mod.synaptic_gather(*args, max_delay=d, pb=pb, fresh=fr,
                                        bounds=bounds)
        pl = gather_mod.synaptic_gather_plain(*args, max_delay=d, pb=pb,
                                              fresh=fr)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              f"K1 ({name}) not bitwise deterministic")
        check(torch.equal(k1[2], pl[2]), f"K1 ({name}) arrivals differ")
        errs[name] = max(max_abs(k1[0], pl[0]), max_abs(k1[1], pl[1]))
        check(errs[name] <= 1e-2, f"K1 ({name}) sums differ by "
              f"{errs[name]}")
    k_ms = median_ms(lambda: gather_mod.synaptic_gather(
        *args, max_delay=d, pb=pb, bounds=bounds))
    p_ms = median_ms(lambda: gather_mod.synaptic_gather_plain(
        *args, max_delay=d, pb=pb))
    nbytes = (live * 12 + bounds.numel() * 4 + d * m * 4 + 4
              + 2 * nb * pb * 4 + nb * eb * 4)
    b_ms, b_by = bound(nbytes, 2 * live)
    out["synaptic_gather"] = dict(max_abs_err=max(errs.values()), ms=k_ms,
                                  plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, bytes=nbytes,
                                  ms_per_launch=None)
    emit({"phase": "kernel", "name": "synaptic_gather", "nb": nb, "eb": eb,
          "pb": pb, "d": d, "m": m, "live_slots": live,
          "max_abs_err": errs, "tolerance": "arrivals exact; sums atol 1e-2",
          "deterministic": True, "kernel_ms": k_ms, "plain_ms": p_ms,
          "bound_ms": b_ms, "bytes": nbytes})

    # K2: the LIF update over the main path's n_local neurons
    n = g.n_local
    f32 = lambda lo, hi: torch.from_numpy(
        rng.uniform(lo, hi, n).astype(np.float32)).to(DEV)
    table = snn.make_param_table([snn.LIFParams(t_ref=0.5),
                                  snn.LIFParams(tau_m=8.0)], models.DT_MS,
                                 device=DEV)
    largs = (f32(-52, -48), f32(0, 100), f32(0, 100),
             torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(DEV),
             torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(DEV),
             f32(0, 500), f32(0, 50), table)
    errs = {}
    for cond in (False, True):
        k1 = lif_mod.lif_step(*largs, cond=cond)
        k2 = lif_mod.lif_step(*largs, cond=cond)
        pl = lif_mod.lif_step_plain(*largs, cond=cond)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              "K2 not bitwise deterministic")
        check(k1[4].any(), "K2 inputs spiked nowhere - vacuous")
        check(all(torch.equal(a, b) for a, b in zip(k1, pl)),
              f"K2 (cond={cond}) differs from its twin")
        errs[f"cond={cond}"] = max(max_abs(a.float(), b.float())
                                   for a, b in zip(k1, pl))
    k_ms = median_ms(lambda: lif_mod.lif_step(*largs))
    l_ms = loop_ms(lambda: lif_mod.lif_step(*largs))
    p_ms = median_ms(lambda: lif_mod.lif_step_plain(*largs))
    nbytes = n * (5 * 4 + 2 * 4) + table.numel() * 4 + n * (4 * 4 + 1)
    b_ms, b_by = bound(nbytes, 15 * n)
    out["lif_step"] = dict(max_abs_err=max(errs.values()), ms=k_ms,
                           plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           bytes=nbytes, ms_per_launch=l_ms)
    emit({"phase": "kernel", "name": "lif_step", "n": n,
          "max_abs_err": errs, "tolerance": "bitwise equal",
          "deterministic": True, "kernel_ms": k_ms,
          "kernel_ms_per_launch_over_many": l_ms,
          "launches_timed": LOOP_LAUNCHES, "plain_ms": p_ms,
          "bound_ms": b_ms, "bytes": nbytes})

    out["stdp_update"] = kernel_stdp(g, rng)

    # K1 + K2: the main path's fused kernel, on the same layout
    table = snn.make_param_table([snn.LIFParams(t_ref=0.5),
                                  snn.LIFParams(tau_m=8.0)], models.DT_MS,
                                 device=DEV)
    out.update(phase_fused_kernel("lif", g, table, rng, drive_on=True))
    out["synaptic_gather"]["ms_per_launch"] = out.pop("_k1_ms_per_launch")
    return out


def kernel_stdp(g, rng, label: str = "kernel") -> dict:
    """K3, the blocked pl-STDP update over every slot of ``g``'s layout,
    on seeded inputs: deterministic, against its twin, timed; its line
    under the phase name ``label``."""
    bg = g.blocked
    nb, eb, pb, m, n = bg.nb, bg.eb, bg.pb, g.n_mirror, g.n_local
    e = nb * eb
    n_plastic = int(bg.plastic.sum())
    sargs = (torch.from_numpy(rng.uniform(1, 100, e).astype(np.float32)
                              ).to(DEV),
             bg.pre_idx.reshape(-1), bg.post_rel.reshape(-1),
             bg.plastic.reshape(-1),
             torch.from_numpy((rng.uniform(size=e) < 0.05)
                              .astype(np.float32)).to(DEV),
             (torch.rand(n, device=DEV) < 0.05).float(),
             torch.rand(m, device=DEV) * 3, torch.rand(n, device=DEV) * 3)
    params = (models.HPC_STDP.lam, models.HPC_STDP.alpha, models.HPC_STDP.mu,
              models.HPC_STDP.w0, models.HPC_STDP.w_min,
              models.HPC_STDP.w_max)
    k1 = stdp_mod.stdp_update(*sargs, params=params, eb=eb, pb=pb)
    k2 = stdp_mod.stdp_update(*sargs, params=params, eb=eb, pb=pb)
    pl = stdp_mod.stdp_update_plain(*sargs, params=params, eb=eb, pb=pb)
    check(torch.equal(k1, k2), "K3 not bitwise deterministic")
    check(not torch.equal(k1, sargs[0]), "K3 changed nothing - vacuous")
    err = max_abs(k1, pl)
    check(torch.allclose(k1, pl, rtol=2e-6, atol=0),
          f"K3 differs from its twin by {err}")
    k_ms = median_ms(lambda: stdp_mod.stdp_update(*sargs, params=params,
                                                  eb=eb, pb=pb))
    p_ms = median_ms(lambda: stdp_mod.stdp_update_plain(
        *sargs, params=params, eb=eb, pb=pb))
    nbytes = (n_plastic * 17 + (e - n_plastic) * 5 + e * 4
              + (2 * n + m) * 4)
    b_ms, b_by = bound(nbytes, 20 * n_plastic)
    emit({"phase": label, "name": "stdp_update", "pb": pb, "slots": e,
          "plastic_slots": n_plastic, "max_abs_err": err,
          "tolerance": "rtol 2e-6 (expf/logf vs torch exp/log)",
          "deterministic": True, "kernel_ms": k_ms, "plain_ms": p_ms,
          "bound_ms": b_ms, "bytes": nbytes})
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes)


def phase_fused_kernel(neuron: str, g, table, rng, *, drive_on: bool,
                       label: str = "kernel"):
    """K1 with the ``neuron`` epilogue at network ``g``'s shapes (its
    layout, ``n_local`` and group ids, with ``table``) on seeded inputs.
    Each case (LIF: current and conductance; drive off and on) bitwise
    against K1 -> add -> the standalone K2, K4 or K5 on the card and twice
    for determinism, and against the plain twin: arrivals, spikes and
    ref_count exact, the membrane (and u, w_ad) as the standalone kernel's
    own check holds it, the synaptic state within K1's sums tolerance.
    Timed in the path's case (``drive_on``: the drive as the path has it)
    alone and in turns with K1 alone, per launch over many:
    ``epilogue_ms`` = fused - K1.  Its line goes under the phase name
    ``label``.  Returns the kernels-line record, and K1's per-launch time
    under ``_k1_ms_per_launch``."""
    bg = g.blocked
    nb, eb, pb, d, m, n = bg.nb, bg.eb, bg.pb, g.max_delay, g.n_mirror, \
        g.n_local
    bounds = gather_mod.segment_bounds(bg.post_rel, bg.delay, pb=pb,
                                       max_delay=d)
    w = torch.from_numpy(rng.normal(0, 50, (nb, eb)).astype(np.float32)
                         ).to(DEV)
    ring = torch.from_numpy((rng.uniform(size=(d, m)) < 0.05)
                            .astype(np.float32)).to(DEV)
    t = torch.tensor(7, dtype=torch.int32, device=DEV)
    edge = (bg.pre_idx, bg.post_rel, w, bg.delay, bg.channel, ring, t)
    f32 = lambda lo, hi: torch.from_numpy(
        rng.uniform(lo, hi, n).astype(np.float32)).to(DEV)
    rc = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(DEV)
    if neuron == "lif":
        state = (f32(-52, -48), f32(0, 100), f32(0, 100), rc)
        standalone, conds, ops = lif_mod.lif_step, (False, True), 15
    elif neuron == "izhikevich":
        # up to v_peak
        state = (f32(-70, 30), f32(-16, 0), f32(0, 30), f32(-30, 0), rc)
        standalone, conds, ops = izh_mod.izhikevich_step, (False,), 25
    else:
        # up to the exponential's clamp, v_t + 10 delta_t
        state = (f32(-60, -30), f32(0, 100), f32(0, 300), f32(-300, 0), rc)
        standalone, conds, ops = adex_mod.adex_step, (False,), 35
    gid = g.group_id
    drive = f32(0, 500)
    name = f"synaptic_gather_{neuron}"
    errs = {}
    for cond in conds:
        for drv in (None, drive):
            case = f"cond={cond},drive={drv is not None}"
            kw = dict(neuron=neuron, cond=cond, max_delay=d, pb=pb,
                      drive=drv)
            (a1, o1), (a2, o2) = (FUSED(*edge, state, gid, table,
                                        bounds=bounds, **kw)
                                  for _ in range(2))
            check(torch.equal(a1, a2)
                  and all(torch.equal(x, y) for x, y in zip(o1, o2)),
                  f"{name} ({case}) not bitwise deterministic")
            ex, inh, ak = gather_mod.synaptic_gather(
                *edge, max_delay=d, pb=pb, bounds=bounds)
            ex = ex[:n] if drv is None else ex[:n] + drv
            comp = standalone(*state, gid, ex, inh[:n], table,
                              **({"cond": cond} if neuron == "lif" else {}))
            check(torch.equal(a1, ak)
                  and all(torch.equal(x, y) for x, y in zip(o1, comp)),
                  f"{name} ({case}) differs from K1 -> add -> "
                  f"{standalone.__name__}")
            check(bool(o1[-1].any()) and bool((rc > 0).any()),
                  f"{name} ({case}): vacuous inputs")
            ap, op = gather_mod.synaptic_gather_update_plain(
                *edge, state, gid, table, **kw)
            check(torch.equal(a1, ap), f"{name} ({case}) arrivals differ")
            names = gather_mod.NEURON_STATE[neuron][0] + ("spike",)
            errs[case] = {}
            for field, x, y in zip(names, o1, op):
                errs[case][field] = max_abs(x.float(), y.float())
                ulps = (8 * 2.0 ** -23 * float(y.abs().max())
                        if y.is_floating_point() else 0.0)
                if field in EXACT_FIELDS[neuron]:
                    ok = torch.equal(x, y)
                else:
                    lim = ulps + (1e-2 if field.startswith("syn") else 0)
                    ok = errs[case][field] <= lim
                check(ok, f"{name} ({case}) {field} differs from the twin "
                      f"by {errs[case][field]}")
    kw = dict(neuron=neuron, max_delay=d, pb=pb,
              drive=drive if drive_on else None)
    fused = lambda: FUSED(*edge, state, gid, table, bounds=bounds, **kw)
    k1 = lambda: gather_mod.synaptic_gather(*edge, max_delay=d, pb=pb,
                                            bounds=bounds)
    k_ms = median_ms(fused)
    p_ms = median_ms(lambda: gather_mod.synaptic_gather_update_plain(
        *edge, state, gid, table, **kw))
    turns = in_turns({"synaptic_gather": k1, name: fused})
    live = int((bg.delay > 0).sum())
    n_state = len(state)
    nbytes = (live * 12 + bounds.numel() * 4 + d * m * 4 + 4 + nb * eb * 4
              + table.numel() * 4
              + n * (n_state * 4 + 4 + (4 if drive_on else 0))
              + n * (n_state * 4 + 1))
    b_ms, b_by = bound(nbytes, 2 * live + ops * n)
    worst = max(max(e.values()) for e in errs.values())
    emit({"phase": label, "name": name, "nb": nb, "eb": eb, "pb": pb,
          "d": d, "m": m, "n_local": n, "live_slots": live,
          "max_abs_err": errs,
          "tolerance": "bitwise equal to K1 -> add -> "
                       f"{standalone.__name__}; against the twin: arrivals "
                       "and "
                       + ", ".join(EXACT_FIELDS[neuron])
                       + " exact, other floats within 8 ulp of max |x|, "
                       "syn also within K1's atol 1e-2",
          "deterministic": True, "timed_drive": drive_on,
          "kernel_ms": k_ms, "plain_ms": p_ms,
          "in_turns_ms_per_launch": turns,
          "epilogue_ms": turns[name] - turns["synaptic_gather"],
          "bound_ms": b_ms, "bytes": nbytes})
    return {name: dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                       bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                       ms_per_launch=turns[name],
                       epilogue_ms=turns[name] - turns["synaptic_gather"]),
            "_k1_ms_per_launch": turns["synaptic_gather"]}


# --------------------------------------------------------------------------
# phase 3: lockstep parity of the two backends at scale 1
# --------------------------------------------------------------------------

def phase_lockstep(spec, stdp, g, table, n_steps: int = 120) -> None:
    """``"cuda"`` against ``"flat"`` from the same state and drive every
    step (spikes may differ only within ``v_tol`` of the threshold); the
    plain ``"bucketed"`` backend beside ``"flat"`` from the flat state:
    identical spikes."""
    cb, fb = backends.get_backend("cuda"), backends.get_backend("flat")
    bb = backends.get_backend("bucketed")
    lc, lf, lb = cb.prepare(g), fb.prepare(g), bb.prepare(g)
    cfg_c = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda")
    cfg_f = dataclasses.replace(cfg_c, sweep="flat")
    cfg_b = dataclasses.replace(cfg_c, sweep="bucketed")
    st = engine.init_state(g, list(spec.groups), SEED, sweep="cuda",
                           device=DEV)
    # from rest the network is nearly silent for ~250 steps: start from a
    # seeded random membrane state around threshold instead
    v0 = np.random.default_rng(SEED + 1).uniform(-56.0, -49.5, g.n_local)
    st = dataclasses.replace(st, neurons=dataclasses.replace(
        st.neurons, v_m=torch.from_numpy(v0.astype(np.float32)).to(DEV)))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 1)
    col = lambda name: table[0, snn.COL[name]]
    v_tol, n_near, n_flip, n_spk = 1e-3, 0, 0, 0
    worst = dict(i_ex=0.0, i_in=0.0, v_m=0.0, weights=0.0, k_pre=0.0,
                 k_post=0.0)
    worst_b = dict(i_ex=0.0, i_in=0.0, v_m=0.0, weights=0.0)
    n_spk_b = 0
    real = g.delay > 0
    reset_launches()
    for _ in range(n_steps):
        stf = engine.state_with_weights_layout(st, g, "flat")
        drive = g.ext_weight * torch.poisson(g.ext_rate * (models.DT_MS
                                                           * 1e-3),
                                             generator=gen)
        ex_c, in_c, _ = cb.sweep(lc, st.weights, st.ring, st.t)
        ex_f, in_f, _ = fb.sweep(lf, stf.weights, stf.ring, stf.t)
        ex_b, in_b, _ = bb.sweep(lb, stf.weights, stf.ring, stf.t)
        new_c, sp_c = engine.engine_step(st, g, table, cfg_c, drive=drive)
        new_f, sp_f = engine.engine_step(stf, g, table, cfg_f, drive=drive)
        new_b, sp_b = engine.engine_step(stf, g, table, cfg_b, drive=drive)
        check(torch.equal(sp_b, sp_f),
              "lockstep: bucketed spikes differ from flat's")
        n_spk_b += int(sp_b.sum())
        for key, a, b in (
                ("i_ex", ex_b, ex_f), ("i_in", in_b, in_f),
                ("v_m", new_b.neurons.v_m, new_f.neurons.v_m),
                ("weights", new_b.weights[real], new_f.weights[real])):
            worst_b[key] = max(worst_b[key], max_abs(a, b))
        nv = st.neurons
        v_prop = (nv.v_m * col("p_vv") + nv.syn_ex * col("p_ve")
                  + nv.syn_in * col("p_vi") + col("p_vconst"))
        near = ((v_prop - col("v_th")).abs() < v_tol) & (nv.ref_count == 0)
        flip = sp_c != sp_f
        check(not bool((flip & ~near).any()),
              "lockstep: spikes differ away from the threshold")
        n_near += int(near.sum())
        n_flip += int(flip.sum())
        n_spk += int(sp_c.sum())
        same = ~flip
        wc = engine.state_with_weights_layout(new_c, g, "flat").weights
        for key, a, b in (
                ("i_ex", ex_c, ex_f), ("i_in", in_c, in_f),
                ("v_m", new_c.neurons.v_m[same], new_f.neurons.v_m[same]),
                ("weights", wc[real], new_f.weights[real]),
                ("k_pre", new_c.traces.k_pre, new_f.traces.k_pre),
                ("k_post", new_c.traces.k_post, new_f.traces.k_post)):
            worst[key] = max(worst[key], max_abs(a, b))
        st = new_c          # continue from the kernel path's state
    # the kernel backend's steps took the fused route; the plain K1 ran
    # only for the comparison sums above
    launches = read_launches()
    check_launches("lockstep", launches,
                   {"synaptic_gather_lif": n_steps, "synaptic_gather": n_steps,
                    "stdp_update": n_steps})
    tol = dict(i_ex=1e-2, i_in=1e-2, v_m=1e-4, weights=1e-4, k_pre=1e-5,
               k_post=1e-5)
    for key, lim in tol.items():
        check(worst[key] <= lim, f"lockstep: {key} differs by {worst[key]}"
              f" > {lim}")
    check(n_spk > 0, "lockstep: nothing spiked - vacuous")
    tol_b = dict(i_ex=1e-2, i_in=1e-2, v_m=1e-4, weights=1e-4)
    for key, lim in tol_b.items():
        check(worst_b[key] <= lim, f"lockstep: bucketed {key} differs from "
              f"flat's by {worst_b[key]} > {lim}")
    emit({"phase": "lockstep", "steps": n_steps, "spikes": n_spk,
          "near_threshold": n_near, "flipped": n_flip,
          "v_threshold_tol_mV": v_tol, "max_abs_err": worst,
          "tolerance": tol,
          "bucketed_vs_flat": {"spikes": n_spk_b, "spikes_identical": True,
                               "max_abs_err": worst_b, "tolerance": tol_b},
          "launches": {k: v for k, v in launches.items() if v}})


# --------------------------------------------------------------------------
# phase 4: free-running parity on a small mixed network
# --------------------------------------------------------------------------

def mixed_backend_spec():
    """Copy of tests/test_snn_engine.py::mixed_backend_spec: two groups,
    mixed channels, heterogeneous delays, plastic E->E edges, padding."""
    ne, ni = 24, 9
    area = AreaSpec("a", ne + ni, positions=np.zeros((ne + ni, 3)))
    exc = snn.LIFParams(i_e=800.0, t_ref=1.0)
    inh = snn.LIFParams(i_e=800.0, t_ref=1.0, tau_m=8.0)
    pops = [builder.Population("E", 0, 0, ne),
            builder.Population("I", 0, 1, ni)]
    projections = [
        builder.Projection(0, 0, 5, 45.0, 5.0, 1, 5, channel=0,
                           plastic=True),
        builder.Projection(0, 1, 3, 45.0, 5.0, 1, 3, channel=0),
        builder.Projection(1, 0, 4, -200.0, 10.0, 2, 6, channel=1),
        builder.Projection(1, 1, 2, -200.0, 10.0, 1, 2, channel=1),
    ]
    return builder.NetworkSpec(areas=[area], groups=[exc, inh],
                               populations=pops, projections=projections,
                               max_delay=8, seed=3)


def phase_mixed(n_steps: int = 120) -> None:
    spec = mixed_backend_spec()
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(DEV)
    table = snn.make_param_table(list(spec.groups), models.DT_MS,
                                 device=DEV)
    res = {}
    for sweep in ("cuda", "flat"):
        cfg = engine.EngineConfig(dt=models.DT_MS, stdp=models.HPC_STDP,
                                  sweep=sweep, external_drive=False)
        st = engine.init_state(g, list(spec.groups), SEED, device=DEV)
        res[sweep] = engine.run(st, g, table, cfg, n_steps, device=DEV)
    (fc, sc), (ff, sf) = res["cuda"], res["flat"]
    check(int(sf.sum()) > 10, "mixed: nothing spiked - vacuous")
    check(bool((g.delay == 0).any()), "mixed: no padding edges - vacuous")
    check(torch.equal(sc, sf), "mixed: spike rasters differ")
    err = max_abs(fc.weights, ff.weights)
    check(err <= 1e-4, f"mixed: weights differ by {err}")
    emit({"phase": "mixed", "steps": n_steps, "spikes": int(sc.sum()),
          "rasters_identical": True, "weights_max_abs_err": err,
          "tolerance": 1e-4})


# --------------------------------------------------------------------------
# phase 5: the main path
# --------------------------------------------------------------------------

def _profile(g, table, cfg, spec, n_steps: int = 50) -> dict:
    """Device time by kernel over a short steady window."""
    from torch.profiler import ProfilerActivity, profile
    st = engine.init_state(g, list(spec.groups), SEED + 2, sweep=cfg.sweep,
                           neuron_model=cfg.neuron_model, device=DEV)
    st, _ = engine.run(st, g, table, cfg, 5, device=DEV)   # warm
    st = engine.state_with_weights_layout(
        st, g, "blocked", backend=backends.get_backend(cfg.sweep))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            st, _ = engine.engine_step(st, g, table, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue     # CPU ops: their kernels are listed on their own
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        name = ev.key.replace("(anonymous namespace)::", "")[:60]
        by_name[name] = by_name.get(name, 0.0) + dt / 1e3
    busy = sum(by_name.values())
    check(busy > 0, "profile: no device time traced")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n_steps,
            "wall_ms_per_step_profiled": wall * 1e3 / n_steps,
            "device_ms_per_step": busy / n_steps,
            "device_idle_share": 1 - busy / (wall * 1e3),
            "kernels_per_step": sum(
                e.count for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")) / n_steps,
            "ms_per_step_by_kernel": {k: v / n_steps for k, v in top}}


def run_counted(what, spec, g, table, cfg, n_steps, kernels):
    """``engine.run`` of ``cfg`` (the kernel backend) from a fresh state,
    with every launch count set to 0 just before and read just after: each
    kernel of ``kernels`` (``read_launches`` names, the fused kernel by
    epilogue) must have launched once per step and every other kernel
    never.  Plastic weights must stay in [w_min, w_max], every other
    weight unchanged, and the state finite.  Returns the initial neurons,
    the final state, the spikes and the run's numbers."""
    st = engine.init_state(g, list(spec.groups), SEED,
                           neuron_model=cfg.neuron_model, device=DEV)
    init = st.neurons
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    fin, spikes = engine.run(st, g, table, cfg, n_steps, device=DEV)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check_launches(what, launches, dict.fromkeys(kernels, n_steps))
    real, w = g.delay > 0, fin.weights
    fixed = real & ~g.plastic if cfg.stdp is not None else real
    check(torch.equal(w[fixed], g.weight_init[fixed]),
          f"{what}: a non-plastic weight changed")
    leaves = [("v_m", fin.neurons.v_m), ("syn_ex", fin.neurons.syn_ex),
              ("syn_in", fin.neurons.syn_in), ("weights", w),
              ("ring", fin.ring), *fin.neurons.extra.items()]
    if cfg.stdp is not None:
        plastic = real & g.plastic
        check(bool(((w[plastic] >= cfg.stdp.w_min)
                    & (w[plastic] <= cfg.stdp.w_max)).all()),
              f"{what}: plastic weights left [w_min, w_max]")
        leaves += [("k_pre", fin.traces.k_pre), ("k_post", fin.traces.k_post)]
    for name, x in leaves:
        check(bool(torch.isfinite(x).all()), f"{what}: {name} not finite")
    return init, fin, spikes, dict(
        steps=n_steps, wall_s=wall, steps_per_s=n_steps / wall,
        peak_device_mem_bytes=peak, launches=launches)


def phase_main(spec, stdp, g, table, n_steps: int = 2000):
    """Returns the launches, and on the host the spikes, final ``v_m`` and
    final weights (the gated runs of phase 11 must reproduce them
    bitwise; kept off the card so as not to count in their peak memory)."""
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda")
    _, fin, spikes, rec = run_counted("main", spec, g, table, cfg, n_steps,
                                      MAIN_KERNELS)
    w = fin.weights
    plastic = g.plastic & (g.delay > 0)
    fixed = ~g.plastic & (g.delay > 0)
    rate = models.firing_rate_hz(spikes[500:], spec.n_neurons)
    check(3.0 <= rate <= 15.0, f"main: rate {rate} Hz outside [3, 15]")
    windows = [models.firing_rate_hz(spikes[i:i + 250], spec.n_neurons)
               for i in range(0, n_steps, 250)]
    # E and I per window from step 500 on against the reference's keys
    ref = ZOO_REFERENCE["hpc_benchmark"]
    rates = population_rates(spec, spikes, ref)
    band = check_keyed_rates("main", rates, ref)
    prof = _profile(g, table, cfg, spec)
    emit({"phase": "main", "neurons": spec.n_neurons,
          "synapses": int((g.delay > 0).sum()),
          "plastic_synapses": int(plastic.sum()),
          "rate_hz_500_2000": rate, "rate_hz_per_250_steps": windows,
          "rates_hz": rates, "rate_band": band,
          "plastic_w_min": float(w[plastic].min()),
          "plastic_w_max": float(w[plastic].max()),
          "inhibitory_w": float(w[fixed].min()), **rec, "profile": prof})
    return rec["launches"], {"spikes": spikes.cpu(),
                             "v_m": fin.neurons.v_m.cpu(),
                             "weights": fin.weights.cpu(),
                             "k_pre": fin.traces.k_pre.cpu(),
                             "k_post": fin.traces.k_post.cpu(),
                             "wall_s": rec["wall_s"]}


# --------------------------------------------------------------------------
# phase 15: the distributed step on shards stacked on the card
# --------------------------------------------------------------------------

def drive_array(spec, n_steps: int, seed: int = SEED):
    """One Poisson drive array (n_steps, n_neurons) by global id, drawn on
    the card: ``ext_weight * poisson(ext_rate * dt)``, the engine's own
    draw."""
    rate, weight = (torch.as_tensor(a, device=DEV) for a in spec.ext_arrays())
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    lam = (rate * (models.DT_MS * 1e-3)).expand(n_steps, -1).contiguous()
    return weight * torch.poisson(lam, generator=gen)


def drive_by_id(drive, global_id):
    """``drive`` (T, N) by global id -> the rows ``global_id`` names (any
    shape; -1, padding, reads 0)."""
    n = drive.shape[1]
    padded = torch.nn.functional.pad(drive, (0, 1))
    idx = torch.where(global_id >= 0, global_id, n).long()
    return padded[:, idx.reshape(-1)].reshape(drive.shape[0],
                                              *global_id.shape)


def edge_table(weights, post_idx, delay, global_id, pre_gid, max_delay):
    """The real edges of (S, E) flat arrays ordered by (global post id,
    delay), stable (so each post neuron's incoming edges stay in builder
    order): ``(weights, pre global ids)``."""
    live = delay > 0
    post = torch.gather(global_id, 1, post_idx.long())
    key = (post.long() * (max_delay + 1) + delay)[live]
    order = torch.sort(key, stable=True).indices
    return weights[live][order], pre_gid[live][order]


def first_divergence(a, b) -> str:
    """Where two (T, ...) tensors first differ: the step and the count."""
    bad = (a != b).reshape(a.shape[0], -1).any(dim=1)
    if not bool(bad.any()):
        return "equal"
    t = int(bad.nonzero()[0])
    return f"first differs at step {t} ({int((a[t] != b[t]).sum())} entries)"


def _labelled(fn, label):
    def wrapped(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return wrapped


def _label_ms(prof, label: str) -> float:
    """Device ms of the kernels launched under a ``record_function``
    label: its host event's device time, children included."""
    return sum(getattr(ev, "device_time_total",
                       getattr(ev, "cuda_time_total", 0))
               for ev in prof.key_averages()
               if ev.key == label
               and not str(ev.device_type).endswith("CUDA")) / 1e3


def _dist_profile(net, table, cfg, spec, drive, n_steps: int = 50) -> dict:
    """Device time by kernel and by exchange tier over a steady window of
    the stacked step (the exchange's functions labelled for the window
    only)."""
    from torch.profiler import ProfilerActivity, profile
    st = dist.init_stacked_state(net, list(spec.groups), SEED + 2,
                                 sweep=cfg.engine.sweep, device=DEV)
    step = dist.make_distributed_step(net, table, cfg, device=DEV)
    carry = step.carry_from(st)
    for i in range(5):                                       # warm
        step.advance(carry, drive[i])
    torch.cuda.synchronize()
    saved = {name: getattr(dist, name) for name in EXCHANGE_LABELS}
    try:
        for name, label in EXCHANGE_LABELS.items():
            setattr(dist, name, _labelled(saved[name], label))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n_steps):
                step.advance(carry, drive[5 + i])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    # the exchange alone, CUDA events around it, on the window's last bits
    ex = step.exchange
    bits = carry.prev_bits
    alone = {"exchange": median_ms(lambda: dist._exchange(bits, ex)),
             "exchange.remote": median_ms(lambda: dist._finish_remote(
                 dist._issue_remote(bits, ex)[0], ex, bits.dtype)),
             "exchange.intra": median_ms(lambda: dist._finish_intra(
                 dist._issue_intra(bits, ex)[0], ex, bits.dtype))}
    labels = set(EXCHANGE_LABELS.values())
    by_name, count = {}, 0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA") or ev.key in labels:
            continue
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        name = ev.key.replace("(anonymous namespace)::", "")[:60]
        by_name[name] = by_name.get(name, 0.0) + dt / 1e3
        count += ev.count
    busy = sum(by_name.values())
    check(busy > 0, "dist profile: no device time traced")
    tiers = {}
    for label in sorted(labels):
        ms = _label_ms(prof, label)
        check(ms > 0, f"dist profile: no device time under {label}")
        tiers[label] = {"device_ms_per_step": ms / n_steps,
                        "alone_ms": alone[label]}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": n_steps, "shards": net.n_shards,
            "wall_ms_per_step_profiled": wall * 1e3 / n_steps,
            "device_ms_per_step": busy / n_steps,
            "device_idle_share": 1 - busy / (wall * 1e3),
            "kernels_per_step": count / n_steps,
            "exchange": tiers,
            "ms_per_step_by_kernel": {k: v / n_steps for k, v in top}}


def wire_bytes(net) -> dict:
    """Per-shard exchange bytes per step of each wire pair and mode, by
    tier (the codecs' own ``bytes_per_step``)."""
    out = {}
    for mode in ("area", "global"):
        for w, rw in DIST_WIRES + (("sparse", None),):
            name = w if rw is None else f"{w}+{rw}"
            split = dist.wire_bytes_split(
                mode, w, rw, n_shards=net.n_shards, row_width=net.row_width,
                n_local=net.n_local, b_pad=net.b_pad)
            out[f"{mode} {name}"] = {**split,
                                     "total": split["intra"] + split["inter"]}
    return out


def dist_run(what, net, spec, table, cfg, drive, n_steps, want=None,
             state=None):
    """``dist.run`` from ``state`` (a fresh native state if None) with
    every launch count set to 0 just before and read just after (``want``:
    the launches each kernel must have made, every other kernel none);
    returns the final state, the spikes by global id (on the card) and the
    run's numbers."""
    st = state if state is not None else dist.init_stacked_state(
        net, list(spec.groups), SEED, sweep=cfg.engine.sweep, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    fin, spikes = dist.run(st, net, table, cfg, n_steps, drive=drive,
                           device=DEV)
    wall = time.perf_counter() - t0
    launches = read_launches()
    if want is not None:
        check_launches(what, launches, want)
    for name in ("v_m", "syn_ex", "syn_in", "weights", "ring", "k_pre",
                 "k_post"):
        check(bool(torch.isfinite(getattr(fin, name)).all()),
              f"{what}: {name} not finite")
    return fin, dist.global_spikes(spikes, net, spec.n_neurons), dict(
        steps=n_steps, shards=net.n_shards, wall_s=wall,
        steps_per_s=n_steps / wall,
        peak_device_mem_bytes=torch.cuda.max_memory_allocated(),
        launches={k: v for k, v in launches.items() if v})


def phase_dist(spec, stdp, g, table) -> dict:
    """The distributed step at hpc_benchmark scale 1 (``dist_main``):
    stacked 1x2 and 2x2 runs equal to the 1-shard run bitwise in spikes,
    ``v_m`` and weights, launching the fused K1 + K2 and K3 once per shard
    per step; the 2x2 wire grid; the marmoset boundary case.  Returns the
    2x2 run's launches."""
    n, d = spec.n_neurons, g.max_delay
    drive = drive_array(spec, DIST_STEPS)
    ecfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda")

    # the 1-shard run on the same drive
    st = engine.init_state(g, list(spec.groups), SEED, device=DEV)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fin1, sp1 = engine.run(st, g, table, ecfg, DIST_STEPS,
                           drive=drive_by_id(drive, g.global_id), device=DEV)
    wall = time.perf_counter() - t0
    check_launches("dist_main 1-shard", read_launches(),
                   dict.fromkeys(MAIN_KERNELS, DIST_STEPS))
    ref_spikes = sp1[:, :n]
    rate = models.firing_rate_hz(ref_spikes[500:], n)
    check(3.0 <= rate <= 15.0, f"dist_main: 1-shard rate {rate} Hz")
    live1 = g.global_id >= 0
    ref_v = torch.empty(n, device=DEV)
    ref_v[g.global_id[live1].long()] = fin1.neurons.v_m[live1]
    pre1 = g.global_id[g.mirror_src_idx.long()]
    ref_w, ref_pre = edge_table(fin1.weights[None], g.post_idx[None],
                                g.delay[None], g.global_id[None],
                                pre1[g.pre_idx.long()][None], d)
    del st, fin1
    runs = {"1x1": {"steps": DIST_STEPS, "shards": 1, "wall_s": wall,
                    "steps_per_s": DIST_STEPS / wall}}
    out = {"phase": "dist_main", "neurons": n,
           "synapses": int((g.delay > 0).sum()), "steps": DIST_STEPS,
           "rate_hz_500_2000": rate, "drive": "one array (2000, 11250) "
           "drawn on the card from the seed, sliced by global id"}
    net22 = sd22 = None
    for rows, width in DIST_GRIDS:
        what = f"dist_main {rows}x{width}"
        t0 = time.perf_counter()
        net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, rows,
                                                             width),
                                   rows, width).to(DEV)
        build_s = time.perf_counter() - t0
        S = net.n_shards
        sd = drive_by_id(drive, net.graph["global_id"])
        cfg = dist.DistributedConfig(engine=ecfg, comm_mode="area",
                                     overlap=True, spike_wire="packed")
        # in two halves: the grid below starts from the state at the
        # middle, where the network fires (its first 250 steps are near
        # silent)
        half = DIST_STEPS // 2
        want = dict.fromkeys(MAIN_KERNELS, S * half)
        mid, sp_a, rec = dist_run(what, net, spec, table, cfg, sd[:half],
                                  half, want)
        fin, sp_b, rec_b = dist_run(what, net, spec, table, cfg, sd[half:],
                                    half, want, state=mid)
        spikes = torch.cat([sp_a, sp_b])
        rec["steps"] = DIST_STEPS
        rec["wall_s"] += rec_b["wall_s"]
        rec["steps_per_s"] = DIST_STEPS / rec["wall_s"]
        rec["peak_device_mem_bytes"] = max(rec["peak_device_mem_bytes"],
                                           rec_b["peak_device_mem_bytes"])
        rec["launches"] = {k: c + rec_b["launches"][k]
                           for k, c in rec["launches"].items()}
        check(torch.equal(spikes, ref_spikes),
              f"{what}: spikes differ from the 1-shard run's: "
              f"{first_divergence(spikes, ref_spikes)}")
        gid = net.graph["global_id"]
        v = torch.empty(n, device=DEV)
        v[gid[gid >= 0].long()] = fin.v_m[gid >= 0]
        check(torch.equal(v, ref_v), f"{what}: final v_m differs from the "
              f"1-shard run's in {int((v != ref_v).sum())} neurons")
        pre = gid[net.mirror_src_flat.long(),
                  net.graph["mirror_src_idx"].long()]
        w, pre_e = edge_table(fin.weights, net.graph["post_idx"],
                              net.graph["delay"], gid,
                              torch.gather(pre, 1,
                                           net.graph["pre_idx"].long()), d)
        check(torch.equal(pre_e, ref_pre),
              f"{what}: edges do not map onto the 1-shard run's")
        check(torch.equal(w, ref_w), f"{what}: final weights differ from "
              f"the 1-shard run's in {int((w != ref_w).sum())} edges")
        check(int(fin.wire_overflow.sum()) == 0, f"{what}: wire overflow")
        rec.update(host_build_s=build_s, n_local=net.n_local,
                   n_mirror=net.n_mirror, b_pad=net.b_pad,
                   nb_eb_pb=list(net.blocked_meta),
                   launches_per_step={k: c / DIST_STEPS
                                      for k, c in rec["launches"].items()},
                   bitwise_equal_to_1_shard={"spikes": True, "v_m": True,
                                             "weights": True},
                   wire_bytes_per_step=wire_bytes(net))
        runs[f"{rows}x{width}"] = rec
        del fin, spikes, sp_a, sp_b
        if (rows, width) == (2, 2):
            net22, sd22, mid22 = net, sd, mid
        else:
            del net, sd, mid
    out["runs"] = runs
    emit(out)
    half = DIST_STEPS // 2
    phase_dist_grid(spec, stdp, table, net22, mid22,
                    sd22[half:half + DIST_GRID_STEPS],
                    ref_spikes[half:half + DIST_GRID_STEPS])
    prof = _dist_profile(net22, table, dist.DistributedConfig(
        engine=ecfg, comm_mode="area", overlap=True, spike_wire="packed"),
        spec, sd22)
    emit({"phase": "dist_profile", "grid": "2x2", "wire": "packed",
          "comm_mode": "area", "overlap": True, **prof})
    del net22, sd22, mid22, drive
    phase_dist_marmoset()
    return runs["2x2"]["launches"]


def phase_dist_grid(spec, stdp, table, net, mid, sd, ref_spikes) -> None:
    """At 2x2, from the packed run's state ``mid`` at its middle, on the
    drive ``sd`` that follows: every wire pair, both comm modes, overlap
    on and off, DIST_GRID_STEPS steps equal to the 1-shard run's
    (``ref_spikes``) with no overflow; a starved wire reports overflow;
    the gate (``"cuda:sparse"``) equals the kernel route bitwise."""
    n_steps, S = DIST_GRID_STEPS, net.n_shards
    rate = models.firing_rate_hz(ref_spikes, spec.n_neurons)
    check(rate > 1.0, f"dist_grid: {rate} Hz in the window")
    ecfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda")
    want = dict.fromkeys(MAIN_KERNELS, S * n_steps)
    cases = {}
    for mode in ("area", "global"):
        for overlap in (True, False):
            for w, rw in DIST_WIRES:
                what = (f"dist_grid {mode} overlap={overlap} "
                        f"{w if rw is None else f'{w}+{rw}'}")
                cfg = dist.DistributedConfig(
                    engine=ecfg, comm_mode=mode, overlap=overlap,
                    spike_wire=w, spike_wire_remote=rw)
                fin, spikes, rec = dist_run(what, net, spec, table, cfg, sd,
                                            n_steps, want, state=mid)
                check(torch.equal(spikes, ref_spikes),
                      f"{what}: spikes differ from packed's: "
                      f"{first_divergence(spikes, ref_spikes)}")
                ov = int(fin.wire_overflow.sum())
                check(ov == 0, f"{what}: wire overflow {ov}")
                cases[what[len("dist_grid "):]] = rec["steps_per_s"]
    starved = wire_mod.SparseWire(max_rate=0.0, min_capacity=1,
                                  name="starved")
    fin, _, _ = dist_run("dist_grid starved", net, spec, table,
                         dist.DistributedConfig(engine=ecfg,
                                                spike_wire=starved),
                         sd, n_steps, want, state=mid)
    starved_ov = fin.wire_overflow.tolist()
    check(sum(starved_ov) > 0, "dist_grid: a starved sparse wire (capacity "
          "1) reported no overflow")
    gcfg = dist.DistributedConfig(engine=dataclasses.replace(
        ecfg, sweep="cuda:sparse"))
    fin, spikes, rec = dist_run("dist_grid cuda:sparse", net, spec, table,
                                gcfg, sd, n_steps, state=mid)
    gl = rec["launches"]
    check(gl.get("blocked_reduce_sweep") == S * n_steps
          and gl.get("lif_step") == S * n_steps
          and "synaptic_gather_lif" not in gl
          and "synaptic_gather" not in gl,
          f"dist_grid cuda:sparse: launches {gl}")
    check(torch.equal(spikes, ref_spikes),
          f"dist_grid cuda:sparse: spikes differ from cuda's: "
          f"{first_divergence(spikes, ref_spikes)}")
    check(tuple(fin.gate_overflow.shape) == (S,),
          f"dist_grid: gate_overflow is {tuple(fin.gate_overflow.shape)}")
    backend = backends.get_backend("cuda:sparse")
    cap = backend.gate_capacity(backend.prepare(net.shard_graphs[0]))
    emit({"phase": "dist_grid", "grid": "2x2", "steps": n_steps,
          "from_step": DIST_STEPS // 2, "spikes": int(ref_spikes.sum()),
          "cases_equal_to_packed": len(cases), "steps_per_s": cases,
          "starved_wire_overflow": starved_ov,
          "gate": {"capacity": cap, "nb": net.blocked_meta[0],
                   "gate_overflow": fin.gate_overflow.tolist(),
                   "bitwise_equal_to_cuda": True, **rec}})


def phase_dist_marmoset() -> None:
    """The boundary tier on a multi-area net: marmoset on MARMOSET_GRID,
    stacked equal to 1 shard in spikes, with area traffic below global
    and boundary sets below the shard width."""
    spec = models.marmoset(MARMOSET_SCALE, n_areas=8)
    rows, width = MARMOSET_GRID
    t0 = time.perf_counter()
    # one shard: a 1x1 grid (the atlas mapping wants a device per area)
    g = builder.build_shards(spec, dist.mesh_decompose(spec, 1, 1))[0].to(
        DEV)
    build1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, rows, width),
                               rows, width).to(DEV)
    build_s = time.perf_counter() - t0
    check(net.comm_bytes_area < net.comm_bytes_global,
          f"marmoset: area traffic {net.comm_bytes_area} not below global "
          f"{net.comm_bytes_global}")
    check(net.b_pad < net.n_local,
          f"marmoset: b_pad {net.b_pad} not below n_local {net.n_local}")
    table = snn.make_param_table(list(spec.groups), models.DT_MS, device=DEV)
    drive = drive_array(spec, MARMOSET_STEPS)
    ecfg = engine.EngineConfig(dt=models.DT_MS, sweep="cuda")
    st = engine.init_state(g, list(spec.groups), SEED, device=DEV)
    _, sp1 = engine.run(st, g, table, ecfg, MARMOSET_STEPS,
                        drive=drive_by_id(drive, g.global_id), device=DEV)
    ref = sp1[:, :spec.n_neurons]
    check(int(ref.sum()) > MARMOSET_STEPS,
          f"marmoset: {int(ref.sum())} spikes in {MARMOSET_STEPS} steps")
    S = net.n_shards
    fin, spikes, rec = dist_run(
        "dist_marmoset", net, spec, table,
        dist.DistributedConfig(engine=ecfg, comm_mode="area", overlap=True),
        drive_by_id(drive, net.graph["global_id"]), MARMOSET_STEPS,
        want={"synaptic_gather_lif": S * MARMOSET_STEPS})
    check(torch.equal(spikes, ref), f"dist_marmoset: spikes differ from the "
          f"1-shard run's: {first_divergence(spikes, ref)}")
    emit({"phase": "dist_marmoset", "scale": MARMOSET_SCALE, "n_areas": 8,
          "grid": f"{rows}x{width}", "neurons": spec.n_neurons,
          "synapses": int((g.delay > 0).sum()), "max_delay": g.max_delay,
          "host_build_s": {"1_shard": build1_s, "stacked": build_s},
          "n_local": net.n_local, "b_pad": net.b_pad,
          "comm_bytes_area": net.comm_bytes_area,
          "comm_bytes_global": net.comm_bytes_global,
          "spikes": int(ref.sum()), "bitwise_equal_to_1_shard": True,
          "wire_bytes_per_step": wire_bytes(net), **rec})


# --------------------------------------------------------------------------
# phase 16: the multi-host path, two processes on the card
# --------------------------------------------------------------------------

#: a fresh process building the global net (``prepare_stacked``), as a
#: worker would (torch, the card's context, then the build): its build
#: seconds, host RSS before it and its peak during it
GLOBAL_BUILD_CODE = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core import distributed as dist
from repro_torch.launch import multihost as mh_launch
torch.cuda.set_device(0)
args = mh_launch.build_parser().parse_args(json.loads(sys.argv[2]))
spec, _, _ = mh_launch._build_spec(args)
rows = args.processes * args.devices_per_process // args.row_width
with mh_launch.PeakRss() as rss:
    t0 = time.perf_counter()
    dist.prepare_stacked(spec, dist.mesh_decompose(spec, rows,
                                                   args.row_width),
                         rows, args.row_width)
    build_s = time.perf_counter() - t0
print(json.dumps({"host_build_s": build_s,
                  "rss_before_build_bytes": rss.before,
                  "peak_rss_during_build_bytes": rss.peak}))
"""


def mh_argv(name: str, scenario: str, scale: float, grid, steps: int,
            wire: str, wire_remote: str, *extra) -> list:
    """The launcher's command line for a cell: MH_PROCESSES processes of
    whole rows of ``grid``, procedural, the drive as published."""
    rows, width = grid
    return ["--processes", str(MH_PROCESSES), "--devices-per-process",
            str(rows * width // MH_PROCESSES), "--row-width", str(width),
            "--steps", str(steps), "--scenario", scenario, "--scale",
            str(scale), "--drive-boost", "1.0", "--connectivity",
            "procedural", "--sweep", "cuda", "--wire", wire,
            "--wire-remote", wire_remote, "--comm-mode", "area",
            "--seed", str(SEED), "--timeout", "600",
            "--out", os.path.join(MH_DIR, f"{name}.json"), *extra]


def mh_global_build(args):
    """The launcher's cell ``args`` built by one process
    (``prepare_stacked``): the host net and the build seconds."""
    spec, _, _ = mh_launch._build_spec(args)
    rows = args.processes * args.devices_per_process // args.row_width
    t0 = time.perf_counter()
    host = dist.prepare_stacked(spec, dist.mesh_decompose(
        spec, rows, args.row_width), rows, args.row_width)
    return host, time.perf_counter() - t0


def mh_reference(what: str, args, host, want_launches: dict):
    """The single-process stacked run of the launcher's cell ``args`` on
    its global build ``host`` (``distributed.run`` through
    ``StackedExchange``, every shard its own generator from the seed):
    its global-order arrays and steps/s."""
    spec, stdp, _ = mh_launch._build_spec(args)
    net = host.to(DEV)
    cfg = dist.DistributedConfig(
        engine=engine.EngineConfig(dt=models.DT_MS,
                                   stdp=None if args.no_stdp else stdp,
                                   sweep="cuda"),
        comm_mode=args.comm_mode, overlap=True, spike_wire=args.wire,
        spike_wire_remote=args.wire_remote)
    table = snn.make_param_table(list(spec.groups), models.DT_MS,
                                 device=DEV)
    st = dist.init_stacked_state(net, list(spec.groups), args.seed,
                                 sweep="cuda", device=DEV)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fin, spikes = dist.run(st, net, table, cfg, args.steps, device=DEV)
    wall = time.perf_counter() - t0
    check_launches(what, read_launches(), want_launches)
    arrays = mh_launch.global_order(
        spikes.cpu().numpy(), fin.v_m.cpu().numpy(),
        fin.weights.cpu().numpy(), host.graph, spec.n_neurons,
        spec.max_delay)
    return arrays, args.steps / wall


def check_same_arrays(what: str, rec: dict, got, want: dict) -> None:
    """The workers' arrays ``got`` (their npz) equal the single-process
    run's ``want`` bitwise: raster by step (``first_divergence``), final
    ``v_m`` and weights; the record's hashes are those arrays'."""
    r_got = torch.from_numpy(got["raster"])
    r_want = torch.from_numpy(want["raster"])
    check(torch.equal(r_got, r_want), f"{what}: raster differs from the "
          f"single-process run's: {first_divergence(r_got, r_want)}")
    for k in ("v_m", "weights"):
        bad = np.flatnonzero(got[k] != want[k])
        check(got[k].shape == want[k].shape and bad.size == 0,
              f"{what}: final {k} differs from the single-process run's in "
              f"{bad.size} entries (first at {bad[:1].tolist()})")
    for k, h in (("raster", "bits_sha256"), ("v_m", "vm_sha256"),
                 ("weights", "weights_sha256")):
        check(mh_launch._sha(want[k]) == rec[h], f"{what}: {h} is not the "
              "hash of the single-process run's arrays")


def mh_launch_run(what: str, argv: list, want_per_process: dict):
    """One launch of the workers; every process's launches checked."""
    t0 = time.perf_counter()
    rec = mh_launch.run_launcher(mh_launch.build_parser().parse_args(argv))
    rec["launch_wall_s"] = time.perf_counter() - t0
    check(rec["dist_backend"] == "gloo" and len(rec["per_process"])
          == MH_PROCESSES, f"{what}: backend {rec['dist_backend']}, "
          f"{len(rec['per_process'])} processes")
    for p in rec["per_process"]:
        check(p["device"].startswith("cuda"), f"{what}: process "
              f"{p['process_id']} ran on {p['device']}")
        check_launches(f"{what} process {p['process_id']}",
                       {**dict.fromkeys(read_launches(), 0),
                        **p["launches"]}, want_per_process)
    return rec, np.load(rec["arrays"])


def phase_multihost():
    """The multi-host path through ``run_launcher``, two processes on the
    card: ``mh_build`` (each worker's rows equal the global build's),
    ``mh_main`` (hpc scale 1, bitwise the single-process run) and
    ``mh_marmoset`` (two wire pairs, bitwise).  Returns mh_main's
    launches per process, and its record (hashes, arrays, wall)."""
    os.makedirs(MH_DIR, exist_ok=True)
    argv = mh_argv("mh_main", "hpc_benchmark", 1.0, MH_GRID, MH_STEPS,
                   "packed", "packed", "--bench")
    args = mh_launch.build_parser().parse_args(argv)
    s_loc = MH_GRID[0] * MH_GRID[1] // MH_PROCESSES
    want = {"synaptic_gather_lif": s_loc * MH_STEPS,
            "stdp_update": s_loc * MH_STEPS}
    # the workers start (about 8 s to reach the card, then their builds)
    # while this process and a fresh one build the global net; the
    # single-process run comes after theirs
    with ThreadPoolExecutor(1) as pool:
        launched = pool.submit(mh_launch_run, "mh_main", argv, want)
        glob = subprocess.Popen(
            [sys.executable, "-c", GLOBAL_BUILD_CODE,
             os.path.join(ROOT, "src"), json.dumps(argv)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            host, build_s = mh_global_build(args)
            out, err = glob.communicate(timeout=600)
            check(glob.returncode == 0, f"mh_build: the global build "
                  f"failed: {err[-2000:]}")
        finally:
            if glob.poll() is None:
                glob.kill()
                glob.wait()
        rec, got = launched.result()
    global_build = json.loads(out.strip().splitlines()[-1])
    ref, ref_steps_per_s = mh_reference(
        "mh_main single process", args, host,
        {k: MH_PROCESSES * c for k, c in want.items()})

    # mh_build: each worker's rows equal those rows of the global build
    workers = []
    for p in rec["per_process"]:
        lo, hi = p["shards"]
        check(p["net_sha256"] == mh_launch.net_field_hashes(
            host.select_shards(lo, hi)), f"mh_build: process "
              f"{p['process_id']}'s rows {lo}..{hi - 1} differ from the "
              "global build's")
        workers.append({k: p[k] for k in ("process_id", "device", "shards",
                                          "host_build_s",
                                          "rss_before_build_bytes",
                                          "peak_rss_during_build_bytes")})
    emit({"phase": "mh_build", "network": "hpc_benchmark(1.0, stdp=True), "
          "procedural", "grid": "x".join(map(str, MH_GRID)),
          "fields_equal": len(rec["per_process"][0]["net_sha256"]),
          "workers": workers, "global_build_fresh_process": global_build,
          "global_build_in_this_process_s": build_s})
    del host

    # mh_main: bitwise the single-process run
    check_same_arrays("mh_main", rec, got, ref)
    check(rec["spiked"] > MH_SPIKE_FLOOR, f"mh_main: {rec['spiked']} spikes"
          f" in {MH_STEPS} steps, not above the floor {MH_SPIKE_FLOOR}")
    check(rec["overflow"] == 0, f"mh_main: wire overflow {rec['overflow']}")
    emit({"phase": "mh_main", "grid": "x".join(map(str, MH_GRID)),
          "processes": MH_PROCESSES, "steps": MH_STEPS,
          "spikes": rec["spiked"], "spike_floor": MH_SPIKE_FLOOR,
          "bitwise_equal_to_single_process": {"raster": True, "v_m": True,
                                              "weights": True},
          "dist_backend": rec["dist_backend"],
          "remote_route": rec["remote_route"],
          "steps_per_s": rec["steps_per_s"],
          "bench": [p["bench"] for p in rec["per_process"]],
          "launches_per_step_per_process": [
              {k: c / MH_STEPS for k, c in p["launches"].items()}
              for p in rec["per_process"]],
          "single_process_steps_per_s": ref_steps_per_s,
          "wire_bytes_intra": rec["wire_bytes_intra"],
          "wire_bytes_inter": rec["wire_bytes_inter"],
          "launch_wall_s": rec["launch_wall_s"]})
    del ref, got

    # mh_marmoset: the boundary tier between areas, two wire pairs, each
    # against the single-process run (packed); the two launches run
    # together, beside the single-process build and run (the procedural
    # builds take most of the time)
    argvs = [mh_argv(f"mh_marmoset_{i}", "marmoset", MARMOSET_SCALE,
                     MARMOSET_GRID, MH_MARMOSET_STEPS, wire, remote)
             for i, (wire, remote) in enumerate(MH_MARMOSET_WIRES)]
    s_loc = MARMOSET_GRID[0] * MARMOSET_GRID[1] // MH_PROCESSES
    whats = [f"mh_marmoset {w}+{r}" for w, r in MH_MARMOSET_WIRES]
    want = {"synaptic_gather_lif": s_loc * MH_MARMOSET_STEPS}
    with ThreadPoolExecutor(len(argvs)) as pool:
        futures = [pool.submit(mh_launch_run, what, argv, want)
                   for what, argv in zip(whats, argvs)]
        margs = mh_launch.build_parser().parse_args(argvs[0])
        host, _ = mh_global_build(margs)
        ref, ref_steps_per_s = mh_reference(
            "mh_marmoset single process", margs, host,
            {"synaptic_gather_lif": MH_PROCESSES * s_loc
             * MH_MARMOSET_STEPS})
        launched = [f.result() for f in futures]
    gid = host.graph["global_id"]
    slots = host.boundary_slots
    per_shard = [ref["raster"][:, gid[s][slots[s][slots[s] < host.n_local]]]
                 .sum(axis=1) for s in range(host.n_shards)]
    net_bytes = {"comm_bytes_global": host.comm_bytes_global,
                 "comm_bytes_area": host.comm_bytes_area,
                 "n_local": host.n_local, "b_pad": host.b_pad,
                 "boundary_spikes_per_shard_step_max":
                     int(max(c.max() for c in per_shard))}
    del host
    m_runs = {}
    for what, (wire, remote), (mrec, mgot) in zip(whats, MH_MARMOSET_WIRES,
                                                  launched):
        check_same_arrays(what, mrec, mgot, ref)
        check(mrec["spiked"] > MH_MARMOSET_STEPS, f"{what}: "
              f"{mrec['spiked']} spikes in {MH_MARMOSET_STEPS} steps")
        check(mrec["wire_bytes_inter"] < net_bytes["comm_bytes_global"],
              f"{what}: inter-process bytes {mrec['wire_bytes_inter']} not "
              f"below comm_bytes_global {net_bytes['comm_bytes_global']}")
        check(mrec["overflow"] == 0, f"{what}: wire overflow")
        m_runs[f"{wire}+{remote}"] = {
            "remote_capacity": wire_mod.get_wire(remote).capacity(
                net_bytes["b_pad"]) if remote.startswith("sparse") else None,
            **{k: mrec[k] for k in ("spiked", "wire_bytes_intra",
                                    "wire_bytes_inter", "steps_per_s",
                                    "launch_wall_s")}}
    emit({"phase": "mh_marmoset", "scale": MARMOSET_SCALE, "n_areas": 8,
          "grid": "x".join(map(str, MARMOSET_GRID)),
          "processes": MH_PROCESSES, "steps": MH_MARMOSET_STEPS,
          "bitwise_equal_to_single_process": True, **net_bytes,
          "single_process_steps_per_s": ref_steps_per_s,
          "runs_launched_together": True, "runs": m_runs})
    return [p["launches"] for p in rec["per_process"]], rec


# --------------------------------------------------------------------------
# phases 17-18: checkpointing and the fault-tolerant runtime
# --------------------------------------------------------------------------

class Settled:
    """An injector whose faults fire only once the manager's in-flight
    save has committed: ``ckpt-corrupt`` then always damages the newest
    save, however long its background write takes."""

    def __init__(self, injector, mgr):
        self.injector, self.mgr = injector, mgr

    def fire(self, step: int) -> None:
        if any(f.step == step for f in self.injector.specs):
            self.mgr.wait()
        self.injector.fire(step)


def phase_ckpt_main(spec, stdp, g, table, main_out: dict) -> dict:
    """The main path under ``SimulationSupervisor`` in process: async saves,
    a corrupted checkpoint, a kill, a walk-back restore and the replay,
    bitwise the ``main`` run (``main_out``, on the host).  Returns the
    launches."""
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda")
    backend = backends.get_backend("cuda")
    layout = backend.prepare(g)
    model = neuron_models.get_model("lif")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    mgr = CheckpointManager(CKPT_DIR, keep=CKPT_KEEP)
    s0 = engine.init_state(g, list(spec.groups), SEED, sweep="cuda",
                           device=DEV)
    spikes = torch.empty((CKPT_STEPS, g.n_local), dtype=torch.bool,
                         device=DEV)
    restores = []

    def step_fn(st, i):
        st, spikes[i] = engine.engine_step(st, g, table, cfg,
                                           backend=backend, layout=layout,
                                           model=model)
        return st, None

    def restore_fn(_state):
        # structure, dtypes and devices from the initial state (whose
        # values no step has changed: "cuda" updates out of place), values
        # and the generator's state from the file
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, md = mgr.restore(s0)
        torch.cuda.synchronize()
        restores.append({"step": int(md["step"]),
                         "restore_s": time.perf_counter() - t0})
        return st, int(md["step"])

    fault_specs = parse_specs(CKPT_FAULTS)
    sup = SimulationSupervisor(
        mgr, save_every=CKPT_SAVE_EVERY,
        policy=RestartPolicy(max_restarts=1, backoff_s=0.01),
        injector=Settled(FaultInjector(fault_specs, mode="raise",
                                       ckpt_dir=CKPT_DIR), mgr),
        metadata_fn=lambda s, _: network_metadata(
            spec, seed=SEED, extra={"step": s, "sweep": "cuda"}),
        restore_fn=restore_fn)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fin, end = sup.run(s0, step_fn, CKPT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    kill = next(f.step for f in fault_specs if f.kind == "kill")
    steps_run = CKPT_STEPS + kill - CKPT_RESTORED
    check(end == CKPT_STEPS and [r["step"] for r in restores]
          == [CKPT_RESTORED] and f"restore@{CKPT_RESTORED}" in sup.events,
          f"ckpt_main: restores {restores}, events {sup.events}")
    check(f"save@{CKPT_RESTORED + CKPT_SAVE_EVERY}" in sup.events[
        :sup.events.index(f"fail@{kill}:SimulatedFault")],
          f"ckpt_main: no newer save to walk back past: {sup.events}")
    check_launches("ckpt_main", launches, {"synaptic_gather_lif": steps_run,
                                           "stdp_update": steps_run})
    flat = engine.state_with_weights_layout(fin, g, "flat", backend=backend)
    for name, a in (("spikes", spikes), ("v_m", flat.neurons.v_m),
                    ("weights", flat.weights)):
        check(torch.equal(a.cpu(), main_out[name]), f"ckpt_main: {name} "
              "differ from the uninterrupted main run's")
    emit({"phase": "ckpt_main", "network": "hpc_benchmark(1.0, stdp=True), "
          "1 shard", "steps": CKPT_STEPS, "save_every": CKPT_SAVE_EVERY,
          "faults": CKPT_FAULTS, "keep": CKPT_KEEP,
          "bitwise_equal_to_main": {"raster": True, "v_m": True,
                                    "weights": True},
          "events": sup.events, "delays": sup.delays, "steps_run": steps_run,
          "launches": {k: c for k, c in launches.items() if c},
          "saves": mgr.timings, "restores": restores, "wall_s": wall,
          "steps_per_s_run": steps_run / wall,
          "main_wall_s": main_out["wall_s"],
          "restart_cost_s": wall - main_out["wall_s"]})
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return launches


def _solo_legs(eng, seed: int, ends) -> dict:
    """Seed ``seed``'s uninterrupted solo run on ``eng``'s graph, table
    and cfg (``engine.run`` in legs ending at each step of ``ends``): the
    raster and, at each end, the flat state's values, on the host."""
    st = eng.ctx.init_state(list(eng.spec.groups), seed)
    spikes, at, done = [], {}, 0
    for end in ends:
        st, sp = engine.run(st, eng.graph, eng.param_table, eng.cfg,
                            end - done, device=DEV)
        spikes.append(sp.cpu())
        at[end] = _state_values(st)
        done = end
    return {"spikes": torch.cat(spikes).numpy(), "at": at}


def _state_values(st) -> dict:
    """A flat state's compared values, copied to the host."""
    return {"v_m": st.neurons.v_m.cpu(), "weights": st.weights.cpu(),
            "k_pre": st.traces.k_pre.cpu(), "k_post": st.traces.k_post.cpu(),
            "ring": st.ring.cpu()}


def check_session(what: str, eng, sid: int, solo: dict, steps: int) -> None:
    """Session ``sid``'s whole recorded raster and its snapshot at
    ``steps`` bitwise its solo run's."""
    info = eng.session_info(sid)
    check(info["step"] == steps, f"{what}: session at step {info['step']}, "
          f"expected {steps}")
    first, bits = eng.spikes(sid)
    check(first == 0 and bits.shape[0] == steps,
          f"{what}: log holds steps {first}..{first + bits.shape[0]}")
    check(bool((bits == solo["spikes"][:steps]).all()),
          f"{what}: raster differs from the solo run's")
    st, md = eng.snapshot(sid)
    check(st.weights_layout == "flat" and md["session"]["step"] == steps,
          f"{what}: snapshot {st.weights_layout} at {md['session']}")
    for name, x in _state_values(st).items():
        check(torch.equal(x, solo["at"][steps][name]),
              f"{what}: {name} differs from the solo run's")


def _timed_method(eng, name: str, out: list) -> None:
    """Wrap ``eng.<name>(rec | sid, ...)`` to append its session (None for
    another first argument) and synchronised wall ms to ``out``."""
    fn = getattr(eng, name)

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*args)
        torch.cuda.synchronize()
        sid = getattr(args[0], "sid", args[0])
        out.append({"sid": sid if isinstance(sid, int) else None,
                    "ms": (time.perf_counter() - t0) * 1e3})
        return got
    setattr(eng, name, timed)


def phase_sessions(main_steps_per_s: float) -> dict:
    """The multi-tenant session engine at full width: interleaving,
    eviction, a supervised crash, each session bitwise its solo run; then
    the aggregate rate by residency.  Returns the launches of (a), (b) and
    (c)'s faulted run."""
    shutil.rmtree(SESS_DIR, ignore_errors=True)
    kernels = MAIN_KERNELS
    scen = dict(scale=SESS_SCALE, stdp=True)
    t0 = time.perf_counter()
    eng = SessionEngine(max_sessions=4, sweep="cuda", spike_window=SESS_STEPS,
                        device=DEV)
    sid = {SESS_SEEDS[0]: eng.create("hpc_benchmark", seed=SESS_SEEDS[0],
                                     **scen)}           # binds the graph
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    sid.update({s: eng.create("hpc_benchmark", seed=s, **scen)
                for s in SESS_SEEDS[1:]})
    torch.cuda.synchronize()
    slot_bytes = (torch.cuda.memory_allocated() - base) / (len(SESS_SEEDS)
                                                           - 1)
    launches = {}

    # (a) interleaving: solo steps, a partial wave, a full wave
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for who, n in SESS_PLAN:
        if isinstance(who, tuple):
            eng.step_wave([sid[s] for s in who], n)
        else:
            eng.step(sid[who], n)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches["interleave"] = read_launches()
    steps_a = sum(n * (len(w) if isinstance(w, tuple) else 1)
                  for w, n in SESS_PLAN)
    check(steps_a == SESS_STEPS * len(SESS_SEEDS), f"plan: {steps_a} steps")
    check_launches("sessions (a)", launches["interleave"],
                   dict.fromkeys(kernels, steps_a))
    ends = (SESS_SUP_STEPS, 2 * SESS_EVICT_CHUNK, SESS_STEPS)
    solo = {s: _solo_legs(eng, s, ends) for s in SESS_SEEDS}
    spikes = {}
    for s in SESS_SEEDS:
        check_session(f"sessions (a) seed {s}", eng, sid[s], solo[s],
                      SESS_STEPS)
        spikes[s] = int(solo[s]["spikes"].sum())
        check(spikes[s] > 0, f"sessions (a) seed {s}: no spike")

    # throughput by residency: step_wave of k fresh residents
    for s in SESS_SEEDS:
        eng.close(sid[s])
    fresh = [eng.create("hpc_benchmark", seed=10 + k, **scen)
             for k in range(max(SESS_RATE_RESIDENTS))]
    rates = {}
    for k in SESS_RATE_RESIDENTS:
        eng.step_wave(fresh[:k], 10)                        # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.step_wave(fresh[:k], SESS_RATE_STEPS)
        wall = time.perf_counter() - t0                     # bits on host
        rates[k] = {"session_steps_per_s": k * SESS_RATE_STEPS / wall,
                    "wall_s": wall,
                    "peak_device_mem_bytes": torch.cuda.max_memory_allocated()}
    del eng, fresh

    # (b) eviction: 3 sessions on 2 slots, every call past the second
    #     evicts the LRU through the checkpoint manager
    evict_dir = os.path.join(SESS_DIR, "evict")
    eng = SessionEngine(max_sessions=SESS_EVICT_SLOTS, sweep="cuda",
                        ckpt_dir=evict_dir, spike_window=SESS_STEPS,
                        keep=1, device=DEV)
    sid = {s: eng.create("hpc_benchmark", seed=s, **scen)
           for s in SESS_SEEDS}
    check(eng.session_info(sid[2])["status"] == "queued",
          "sessions (b): the third session is not queued")
    evicts, restores = [], []
    _timed_method(eng, "_evict", evicts)
    _timed_method(eng, "_restore_into", restores)
    order = (0, 1, 2, 0, 1, 2)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for s in order:
        eng.step(sid[s], SESS_EVICT_CHUNK)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches["eviction"] = read_launches()
    check_launches("sessions (b)", launches["eviction"],
                   dict.fromkeys(kernels, SESS_EVICT_CHUNK * len(order)))
    check([e["sid"] for e in evicts] == [sid[s] for s in (0, 1, 2, 0)]
          and [r["sid"] for r in restores] == [sid[s] for s in (0, 1, 2)],
          f"sessions (b): evictions {evicts}, restores {restores}")
    check(eng.session_info(sid[0])["status"] == "evicted",
          "sessions (b): seed 0 not evicted at the end")
    for s in SESS_SEEDS:
        check_session(f"sessions (b) seed {s}", eng, sid[s], solo[s],
                      2 * SESS_EVICT_CHUNK)
    saves = [dict(t, sid=k) for k, m in eng._mgrs.items() for t in m.timings]
    del eng

    # (c) supervised residency: two residents, clean, then a kill
    sup_runs = {}
    eng = SessionEngine(max_sessions=2, sweep="cuda",
                        ckpt_dir=os.path.join(SESS_DIR, "supervised"),
                        spike_window=SESS_STEPS, device=DEV)
    sup_restores = []
    _timed_method(eng, "_restore_resident", sup_restores)
    for fault in (None, SESS_SUP_FAULT):
        sids = [eng.create("hpc_benchmark", seed=s, **scen)
                for s in SESS_SEEDS[:2]]
        inj = (None if fault is None else
               FaultInjector(parse_specs(fault), mode="raise"))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        sup = eng.run_supervised(
            SESS_SUP_STEPS, save_every=SESS_SUP_SAVE_EVERY, injector=inj,
            policy=RestartPolicy(max_restarts=1, backoff_s=0.01))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        what = f"sessions (c) {fault or 'clean'}"
        replayed = 0
        if fault is not None:
            kill = parse_specs(fault)[0].step
            replayed = kill - SESS_SUP_RESUMED
            check(f"restore@{SESS_SUP_RESUMED}" in sup.events
                  and len(sup_restores) == 1,
                  f"{what}: events {sup.events}")
        check_launches(what, got, dict.fromkeys(
            kernels, len(sids) * (SESS_SUP_STEPS + replayed)))
        for s, i in zip(SESS_SEEDS, sids):
            check_session(f"{what} seed {s}", eng, i, solo[s],
                          SESS_SUP_STEPS)
        sup_runs[fault or "clean"] = {"wall_s": wall, "events": sup.events,
                                      "launches": got}
        for i in sids:
            eng.close(i)
    launches["supervised"] = sup_runs[SESS_SUP_FAULT]["launches"]
    del eng
    shutil.rmtree(SESS_DIR, ignore_errors=True)
    emit({"phase": "sessions", "network": f"hpc_benchmark({SESS_SCALE}, "
          "stdp=True), 1 shard, \"cuda\"", "seeds": list(SESS_SEEDS),
          "bind_and_create_s": bind_s,
          "bitwise_equal_to_solo": {"raster": True, "weights": True,
                                    "v_m": True, "traces": True,
                                    "ring": True},
          "spikes_per_session_1000_steps": spikes,
          "interleave": {"plan": [[list(w) if isinstance(w, tuple) else w,
                                   n] for w, n in SESS_PLAN],
                         "session_steps": steps_a, "wall_s": wall_a,
                         "session_steps_per_s": steps_a / wall_a,
                         "launches": {k: c for k, c in
                                      launches["interleave"].items() if c}},
          "eviction": {"order": list(order), "chunk": SESS_EVICT_CHUNK,
                       "wall_s": wall_b, "saves": saves,
                       "evict_ms": evicts, "restore_ms": restores},
          "supervised": {"steps": SESS_SUP_STEPS,
                         "save_every": SESS_SUP_SAVE_EVERY,
                         "fault": SESS_SUP_FAULT,
                         "clean_wall_s": sup_runs["clean"]["wall_s"],
                         "fault_wall_s": sup_runs[SESS_SUP_FAULT]["wall_s"],
                         "events": sup_runs[SESS_SUP_FAULT]["events"],
                         "restore_all_ms": [r["ms"] for r in sup_restores],
                         "restart_cost_s":
                             sup_runs[SESS_SUP_FAULT]["wall_s"]
                             - sup_runs["clean"]["wall_s"]},
          "step_wave_by_residents": rates,
          "main_steps_per_s": main_steps_per_s,
          "resident_slot_bytes": slot_bytes,
          "note": "slots are stepped one after the other through the solo "
                  "kernels: no batching gain is expected"})
    return {k: {n: c for n, c in v.items() if c} for k, v in
            launches.items()}

# --------------------------------------------------------------------------
# phase 20: differentiable simulation (surrogate spikes, the rollout)
# --------------------------------------------------------------------------

def _diff_grad_run(what: str, st, g, table, cfg, n_steps: int, chunk):
    """One forward and backward of ``mean(spikes)`` over the rollout with
    respect to the weights, through ``rollout.grad_peak_memory_bytes``
    (the peak above what was allocated before); the gradient is taken off
    the leaf by a hook.  No kernel may launch (the flat backend)."""
    got = {}

    def loss_fn(w):
        w.register_hook(lambda gr: got.__setitem__("grad", gr.detach()
                                                   .clone()))
        fin, spikes = diff_rollout.rollout(
            dataclasses.replace(st, weights=w), g, table, cfg, n_steps,
            checkpoint_every=chunk, device=DEV)
        got["spikes"] = spikes.detach().to(torch.bool)
        got["generator"] = fin.generator.get_state()
        return spikes.mean()

    reset_launches()
    t0 = time.perf_counter()
    peak = diff_rollout.grad_peak_memory_bytes(loss_fn, st.weights)
    wall = time.perf_counter() - t0
    check_launches(what, read_launches(), {})
    grad = got["grad"]
    check(bool(torch.isfinite(grad).all()), f"{what}: gradient not finite")
    check(float(grad.abs().max()) > 0, f"{what}: zero gradient")
    return dict(peak_bytes=peak, wall_s=wall, s_per_step=wall / n_steps,
                spikes=got["spikes"], grad=grad,
                generator=got["generator"])


def phase_diff(spec, stdp, g, table, main_out: dict) -> dict:
    """Differentiable simulation: (a) the surrogate forward of the main
    path through ``"cuda"`` (inference's fused K1 and K3, the spike cast
    to float), bitwise the ``main`` run; (b) the gradient of
    ``mean(spikes)`` through the rollout at ``brunel(1.0)`` on ``"flat"``,
    naive twice and checkpointed; (d) the SNN classifier.  (c), the
    reference's reduced inversion fit, is the same fit as ``fit_brunel
    --smoke --init-eta 2.2`` and runs once, as that leg of
    :func:`phase_examples`, with (c)'s bars.  Returns (a)'s launches."""
    n_steps = len(main_out["spikes"])
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda",
                              surrogate=DIFF_SURROGATE)
    _, fin, spikes, rec = run_counted("diff surrogate", spec, g, table, cfg,
                                      n_steps, DIFF_KERNELS)
    check(spikes.dtype == torch.float32, "diff: surrogate spikes not float")
    same = {"raster": torch.equal(spikes.cpu(),
                                  main_out["spikes"].to(torch.float32)),
            "weights": torch.equal(fin.weights.cpu(), main_out["weights"]),
            "v_m": torch.equal(fin.neurons.v_m.cpu(), main_out["v_m"]),
            "k_pre": torch.equal(fin.traces.k_pre.cpu(), main_out["k_pre"]),
            "k_post": torch.equal(fin.traces.k_post.cpu(),
                                  main_out["k_post"])}
    for k, ok in same.items():
        check(ok, f"diff surrogate: {k} differs from the main run")
    surrogate_rec = dict(
        network=f"hpc_benchmark(1.0, stdp=True), \"cuda\", surrogate="
                f"{DIFF_SURROGATE!r}", steps=n_steps,
        spikes=int(spikes.sum()), bitwise_equal_to_main=same,
        steps_per_s=rec["steps_per_s"],
        main_steps_per_s=n_steps / main_out["wall_s"],
        wall_s=rec["wall_s"],
        peak_device_mem_bytes=rec["peak_device_mem_bytes"],
        launches={k: c for k, c in rec["launches"].items() if c})
    del fin, spikes

    # (b) the gradient rollout at brunel(1.0)
    bspec, _ = models.brunel(1.0)
    t0 = time.perf_counter()
    host = builder.build_shards(bspec, builder.decompose(bspec, 1))[0]
    bgr = host.to(DEV)
    del host
    build_s = time.perf_counter() - t0
    btable = snn.make_param_table(list(bspec.groups), models.DT_MS,
                                  device=DEV)
    gcfg = engine.EngineConfig(dt=models.DT_MS, sweep="flat",
                               surrogate=DIFF_SURROGATE,
                               external_drive_mode="diffusion")
    # from rest brunel's first spikes come after about 140 steps: every
    # run starts from one membrane state drawn uniformly in [e_l, v_th)
    # from the seed, as NEST's brunel example draws V_m
    gen = torch.Generator()
    gen.manual_seed(SEED)
    gid = bgr.group_id.long().cpu()
    e_l, v_th = (torch.tensor([getattr(p, k) for p in bspec.groups])[gid]
                 for k in ("e_l", "v_th"))
    v0 = (e_l + (v_th - e_l) * torch.rand(bgr.n_local, generator=gen)).to(
        DEV)

    def fresh():
        # a fresh state for each run: the drive's generator is the state's,
        # and a run advances it
        st = engine.init_state(bgr, list(bspec.groups), SEED, device=DEV)
        return dataclasses.replace(st, neurons=dataclasses.replace(
            st.neurons, v_m=v0.clone()))

    runs = {name: _diff_grad_run(f"diff grad {name}", fresh(), bgr, btable,
                                 gcfg, n, chunk)
        for name, n, chunk in (
            ("naive", DIFF_GRAD_STEPS, None),
            ("naive_again", DIFF_GRAD_STEPS, None),
            ("checkpointed", DIFF_GRAD_STEPS, DIFF_GRAD_CHUNK),
            ("checkpointed_long", DIFF_GRAD_LONG, DIFF_GRAD_CHUNK))}
    a, a2, c = runs["naive"], runs["naive_again"], runs["checkpointed"]
    cl = runs["checkpointed_long"]
    check(int(a["spikes"].sum()) > 0, "diff grad: silent raster - vacuous")
    check(torch.equal(cl["spikes"][:DIFF_GRAD_STEPS], a["spikes"]),
          "diff grad: the long checkpointed run's first steps differ from "
          "the naive run's")
    check(int(cl["spikes"][DIFF_GRAD_STEPS:].sum()) > 0,
          "diff grad: the long run's second half is silent")
    check(cl["peak_bytes"] < a["peak_bytes"],
          f"diff grad: the long checkpointed peak {cl['peak_bytes']} not "
          f"below the naive {a['peak_bytes']} at half its steps")
    for name in ("naive_again", "checkpointed"):
        r = runs[name]
        check(torch.equal(r["spikes"], a["spikes"]),
              f"diff grad: {name}'s raster differs from the naive run's")
        check(torch.equal(r["generator"], a["generator"]),
              f"diff grad: {name}'s generator state differs")
        check(torch.allclose(r["grad"], a["grad"], rtol=1e-5, atol=1e-8),
              f"diff grad: {name}'s gradient differs from the naive run's "
              f"by {max_abs(r['grad'], a['grad'])}")
    check(c["peak_bytes"] < a["peak_bytes"],
          f"diff grad: checkpointed peak {c['peak_bytes']} not below the "
          f"naive {a['peak_bytes']}")
    grad_rec = dict(
        network="brunel(1.0), \"flat\", diffusion drive, surrogate="
                f"{DIFF_SURROGATE!r}, v_m uniform in [e_l, v_th) from the "
                "seed", neurons=bspec.n_neurons,
        synapses=int((bgr.delay > 0).sum()), max_delay=bgr.max_delay,
        host_build_s=build_s, steps=DIFF_GRAD_STEPS,
        steps_long=DIFF_GRAD_LONG, checkpoint_every=DIFF_GRAD_CHUNK,
        spikes=int(a["spikes"].sum()),
        spikes_long=int(cl["spikes"].sum()),
        rasters_bitwise_equal=True,
        grad_bitwise_naive_twice=torch.equal(a["grad"], a2["grad"]),
        grad_bitwise_checkpointed=torch.equal(c["grad"], a["grad"]),
        grad_max_abs_diff_checkpointed=max_abs(c["grad"], a["grad"]),
        grad_max_abs=float(a["grad"].abs().max()),
        grad_nonzero=int((a["grad"] != 0).sum()),
        **{f"{k}_{f}": runs[k][f] for k in runs
           for f in ("peak_bytes", "wall_s", "s_per_step")})
    del runs, a, a2, c, cl, bgr, btable, v0

    # (d) the SNN classifier, the reference's acceptance case
    model = diff_classify.SNNClassifier(device=DEV)
    tcfg = TrainConfig(optimizer="adamw", lr=0.05, weight_decay=0.0)
    reset_launches()
    t0 = time.perf_counter()
    _, hist = diff_classify.train_classifier(
        model, tcfg, epochs=DIFF_CLASSIFIER_EPOCHS, data_parallel=True)
    cls_wall = time.perf_counter() - t0
    check_launches("diff classifier", read_launches(), {})
    chance = 1.0 / model.n_classes
    check(hist[-1]["eval_accuracy"] >= 3.0 * chance,
          f"diff classifier: eval accuracy {hist[-1]['eval_accuracy']} "
          f"below 3x chance")
    check(hist[-1]["train_loss"] < hist[0]["train_loss"],
          "diff classifier: train loss did not fall")
    emit({"phase": "diff", "surrogate_forward": surrogate_rec,
          "grad_rollout": grad_rec,
          "inversion_smoke": "the examples phase's fit_brunel leg",
          "classifier": {"epochs": DIFF_CLASSIFIER_EPOCHS,
                         "eval_accuracy": [h["eval_accuracy"] for h in hist],
                         "train_loss": [h["train_loss"] for h in hist],
                         "chance": chance, "wall_s": cls_wall}})
    return {k: c for k, c in rec["launches"].items() if c}


def phase_full_inversion() -> dict:
    """The reference's acceptance fit, ``invert_brunel(4.0, 2.5)`` with its
    defaults, on the card: both parameters within 5 %.  Not part of
    :func:`main` (it takes minutes); run it as
    ``python3 -c "import chip_smoke as c; c.phase_device();
    c.phase_full_inversion()"``."""
    reset_launches()
    t0 = time.perf_counter()
    res = ex_fit_brunel.main(["--device", str(DEV)])   # the script's fit
    wall = time.perf_counter() - t0
    check_launches("full inversion", read_launches(), {})
    out = {"phase": "full_inversion", "g": res["g"], "eta": res["eta"],
           "rel_error": res["rel_error"], "bars": DIFF_FULL_BARS,
           "final_loss": res["final_loss"],
           "loss_history": res["loss_history"], "n_evals": res["n_evals"],
           "wall_s": wall}
    emit(out)
    check(res["ok"], f"full inversion: missed the script's {res['bar']:.0%} "
          "bar")
    for k, bar in DIFF_FULL_BARS.items():
        check(res["rel_error"][k] <= bar, f"full inversion: relative error "
              f"in {k} {res['rel_error'][k]} above {bar}")
    return out


def mh_sup_run(what: str, argv: list):
    """One supervised launch: its record (plus the launcher's wall) and
    its arrays."""
    t0 = time.perf_counter()
    rec = mh_launch.run_launcher(mh_launch.build_parser().parse_args(argv))
    rec["launch_wall_s"] = time.perf_counter() - t0
    return rec, np.load(rec["arrays"])


def check_final_incarnation(what: str, rec: dict, resumed: int,
                            kernels) -> list:
    """The final incarnation resumed from ``resumed``, and each of its
    processes launched each of ``kernels`` once per shard per step it ran
    on the card, and nothing else.  Returns the launches per process."""
    check(rec["resumed_from"] == resumed and rec["incarnation"] == 1,
          f"{what}: resumed from {rec['resumed_from']} in incarnation "
          f"{rec['incarnation']}, expected {resumed} in 1")
    for p in rec["per_process"]:
        s_loc = p["shards"][1] - p["shards"][0]
        check(p["device"].startswith("cuda") and p["steps_run"]
              == rec["steps"] - resumed, f"{what}: process "
              f"{p['process_id']} on {p['device']} ran {p['steps_run']}")
        check_launches(f"{what} process {p['process_id']}",
                       {**dict.fromkeys(read_launches(), 0),
                        **p["launches"]},
                       dict.fromkeys(kernels, s_loc * p["steps_run"]))
    return [p["launches"] for p in rec["per_process"]]


def sup_summary(rec: dict) -> dict:
    """A supervised record's numbers for the phase line."""
    sup = rec["supervision"]
    return {"resumed_from": rec["resumed_from"], "events": sup["events"],
            "tiers": sup["tiers"], "delays": sup["delays"],
            "incarnations": [
                {"processes": inc["processes"], "wall_s": inc["wall_s"],
                 "failed": inc["failed"],
                 "host_build_s": [w["host_build_s"]
                                  for w in inc["workers"].values()],
                 "restore_s": [w["restore_s"]
                               for w in inc["workers"].values()]}
                for inc in sup["per_incarnation"]],
            "launch_wall_s": rec["launch_wall_s"],
            "final_steps_per_s": rec["steps_per_s"],
            "ckpt_events": rec["ckpt_events"],
            "saves": rec["ckpt_timings"], "spikes": rec["spiked"]}


def phase_mh_supervised(mh_main_rec: dict) -> dict:
    """The launcher's supervised mode, two legs launched together: (a) a
    same-grid gang restart bitwise ``mh_main``, (b) an elastic shrink from
    two processes to one, bitwise the single-process 2x2 run of its net.
    Returns the final incarnations' launches per leg and process."""
    os.makedirs(MH_DIR, exist_ok=True)
    argv_a = mh_argv("mh_sup_same", "hpc_benchmark", 1.0, MH_GRID, MH_STEPS,
                     "packed", "packed", "--save-every",
                     str(MH_SUP_SAVE_EVERY), "--fault-inject", MH_SUP_FAULT,
                     "--keep-ckpts", "2")
    argv_b = mh_argv("mh_sup_shrink", "hpc_benchmark", 1.0, MH_GRID,
                     MH_SHRINK_STEPS, "packed", "packed", "--model", "lif",
                     "--no-stdp", "--elastic", "--save-every",
                     str(MH_SHRINK_SAVE_EVERY), "--fault-inject",
                     MH_SHRINK_FAULT, "--keep-ckpts", "2")
    args_b = mh_launch.build_parser().parse_args(argv_b)
    for argv in (argv_a, argv_b):
        a = mh_launch.build_parser().parse_args(argv)
        shutil.rmtree(a.out + ".ckpt", ignore_errors=True)
    with ThreadPoolExecutor(2) as pool:
        fut_a = pool.submit(mh_sup_run, "mh_supervised same", argv_a)
        fut_b = pool.submit(mh_sup_run, "mh_supervised shrink", argv_b)
        host, _ = mh_global_build(args_b)
        rec_a, got_a = fut_a.result()
        rec_b, got_b = fut_b.result()
    s_loc = MH_GRID[0] * MH_GRID[1]
    ref_b, ref_steps_per_s = mh_reference(
        "mh_supervised shrink single process", args_b, host,
        {"synaptic_gather_lif": s_loc * MH_SHRINK_STEPS})
    del host

    # (a) same grid: bitwise mh_main, one gang restart, backoff recorded
    want_a = dict(np.load(mh_main_rec["arrays"]))
    check_same_arrays("mh_supervised same", rec_a, got_a, want_a)
    for k in ("bits_sha256", "vm_sha256", "weights_sha256"):
        check(rec_a[k] == mh_main_rec[k], f"mh_supervised same: {k} is not "
              "mh_main's")
    sup_a = rec_a["supervision"]
    check(sup_a["tiers"] == {"same": 1, "shrink": 0} and sup_a["delays"]
          and rec_a["processes"] == MH_PROCESSES and rec_a["dist_backend"]
          == "gloo", f"mh_supervised same: {sup_a}")
    launches_a = check_final_incarnation(
        "mh_supervised same", rec_a, MH_SUP_RESUMED,
        ("synaptic_gather_lif", "stdp_update"))

    # (b) elastic: 2 processes (2x2) -> 1 process (1x2), bitwise 2x2
    check_same_arrays("mh_supervised shrink", rec_b, got_b, ref_b)
    sup_b = rec_b["supervision"]
    check(sup_b["tiers"] == {"same": 0, "shrink": 1}
          and sup_b["processes_final"] == 1 and rec_b["processes"] == 1
          and (rec_b["n_rows"], rec_b["row_width"]) == (1, MH_GRID[1])
          and any(e.startswith(f"shrink:{MH_PROCESSES}->1(mesh 1x"
                               f"{MH_GRID[1]})") for e in sup_b["events"]),
          f"mh_supervised shrink: {sup_b}")
    check(rec_b["spiked"] > MH_SHRINK_STEPS and rec_b["overflow"] == 0,
          f"mh_supervised shrink: {rec_b['spiked']} spikes, overflow "
          f"{rec_b['overflow']}")
    launches_b = check_final_incarnation(
        "mh_supervised shrink", rec_b, MH_SHRINK_RESUMED,
        ("synaptic_gather_lif",))
    emit({"phase": "mh_supervised", "launched_together": True,
          "same": {"network": "hpc_benchmark(1.0, stdp=True), procedural",
                   "grid": "x".join(map(str, MH_GRID)), "steps": MH_STEPS,
                   "save_every": MH_SUP_SAVE_EVERY, "fault": MH_SUP_FAULT,
                   "bitwise_equal_to_mh_main": True,
                   "mh_main_launch_wall_s": mh_main_rec["launch_wall_s"],
                   "restart_cost_s": rec_a["launch_wall_s"]
                   - mh_main_rec["launch_wall_s"],
                   "final_launches_per_process": launches_a,
                   **sup_summary(rec_a)},
          "shrink": {"network": 'model_demo("lif", 1.0), procedural, '
                                "no STDP",
                     "grid": f"{'x'.join(map(str, MH_GRID))} -> 1x"
                             f"{MH_GRID[1]}", "steps": MH_SHRINK_STEPS,
                     "save_every": MH_SHRINK_SAVE_EVERY,
                     "fault": MH_SHRINK_FAULT,
                     "bitwise_equal_to_single_process_2x2": True,
                     "single_process_steps_per_s": ref_steps_per_s,
                     "final_launches_per_process": launches_b,
                     **sup_summary(rec_b)}})
    for rec in (rec_a, rec_b):
        shutil.rmtree(os.path.splitext(rec["arrays"])[0] + ".json.ckpt",
                      ignore_errors=True)
    return {"same": launches_a, "shrink": launches_b}


# --------------------------------------------------------------------------
# phase 22: the dry run
# --------------------------------------------------------------------------

def dryrun_lockstep(cuda, flat, st, table, tag: str) -> dict:
    """DRYRUN_LOCKSTEP steps of a shard's ``"cuda"`` step against its
    ``"flat"`` step (both :class:`~repro_torch.core.distributed.
    DistributedStep` bindings of one consts dict) from the same state and
    drive every step, continuing from ``"cuda"``'s, as
    :func:`phase_lockstep` checks the single-shard engine: spikes may
    differ only within ``v_tol`` of the threshold; the synaptic currents,
    ``k_pre``, and ``v_m``, ``k_post`` and the weights of the neurons (and
    the edges onto them) whose spikes agree within its tolerances.
    Returns the counts and the worst differences."""
    g = flat.graphs[0]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 24)
    col = lambda name: table[g.group_id, snn.COL[name]]
    real = g.delay > 0
    v_tol, n_near, n_flip, n_spk = 1e-3, 0, 0, 0
    tol = dict(syn_ex=1e-2, syn_in=1e-2, v_m=1e-4, weights=1e-4,
               k_pre=1e-5, k_post=1e-5)
    worst = dict.fromkeys(tol, 0.0)
    for _ in range(DRYRUN_LOCKSTEP):
        drive = engine._poisson_drive(gen, g, models.DT_MS,
                                      torch.float32)[None]
        new_c, sp_c = cuda(st, drive)
        new_f, sp_f = flat(st, drive)
        v_prop = (st.v_m * col("p_vv") + st.syn_ex * col("p_ve")
                  + st.syn_in * col("p_vi") + col("p_vconst"))
        near = ((v_prop - col("v_th")).abs() < v_tol) & (st.ref_count == 0)
        flip = sp_c != sp_f
        check(not bool((flip & ~near).any()), f"dryrun lockstep {tag}: "
              "spikes differ away from the threshold")
        n_near += int(near.sum())
        n_flip += int(flip.sum())
        n_spk += int(sp_c.sum())
        same = ~flip[0]
        edges = real & same[g.post_idx]
        for key, a, b in (
                ("syn_ex", new_c.syn_ex, new_f.syn_ex),
                ("syn_in", new_c.syn_in, new_f.syn_in),
                ("k_pre", new_c.k_pre, new_f.k_pre),
                ("v_m", new_c.v_m[0][same], new_f.v_m[0][same]),
                ("k_post", new_c.k_post[0][same], new_f.k_post[0][same]),
                ("weights", new_c.weights[0][edges],
                 new_f.weights[0][edges])):
            worst[key] = max(worst[key], max_abs(a, b))
        st = new_c
    for key, lim in tol.items():
        check(worst[key] <= lim, f"dryrun lockstep {tag}: {key} differs by "
              f"{worst[key]} > {lim}")
    check(n_spk > 0, f"dryrun lockstep {tag}: no spike in "
          f"{DRYRUN_LOCKSTEP} steps")
    return {"lockstep_steps": DRYRUN_LOCKSTEP, "lockstep_spikes": n_spk,
            "lockstep_near_threshold": n_near, "lockstep_flips": n_flip,
            "lockstep_max_abs_err": worst, "lockstep_tolerance": tol}


def dryrun_shard(scale: float, card: str) -> dict:
    """Shard 0 of the 16x16 cell at ``scale``, its consts drawn from the
    seed (``dryrun_snn.state_and_consts_meta`` on the card) and laid out
    by the port's own layout code: per dtype (int32, compact) one
    ``"flat"`` step (its peak memory beside the arguments' bytes),
    DRYRUN_CUDA_STEPS steps through ``"cuda"`` (K1 + K2 and K3 once a
    step, ms a step; the shard fires, the raster equal to int32's), then
    ``"cuda"`` against ``"flat"`` in lockstep from there
    (:func:`dryrun_lockstep`); K1 + K2 and K3 against their twins at
    these shapes (D = 64).  Returns the launches of each ``"cuda"``
    run."""
    mesh = dryrun_snn.make_production_mesh()
    S, rw = mesh.size, mesh.shape["model"]
    dims = dryrun_snn.shard_dims(int(1_000_000 * scale),
                                 int(3_800_000_000 * scale), S, rw)
    groups = list(dryrun_snn.GROUPS)
    table = snn.make_param_table(groups, models.DT_MS, device=DEV)
    kw = dict(max_delay=dims["max_delay"], n_local=dims["n_local"],
              n_mirror=dims["n_mirror"], shards=(0,),
              exchange=dist.StandInExchange, device=DEV)
    cfg = lambda sweep: dist.DistributedConfig(
        engine=engine.EngineConfig(dt=models.DT_MS, stdp=models.HPC_STDP,
                                   sweep=sweep),
        comm_mode="area", spike_wire="packed")
    launches, rasters = {}, {}
    blk = None
    for compact in (False, True):
        tag = f"scale {scale:g} {'compact' if compact else 'i32'}"
        # one "flat" step: the allocator's peak above what was held before
        # its arguments were made, beside the arguments' bytes
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        st0, consts = dryrun_snn.state_and_consts_meta(
            dims, mesh, compact=compact, device=DEV, seed=SEED)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t1
        arg_bytes = dryrun_snn.argument_bytes(st0, consts)
        flat = dist.make_raw_distributed_step(
            mesh, groups, cfg("flat"), **kw).bind(consts)
        reset_launches()
        fin, _ = flat(st0, None)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        check_launches(f"dryrun flat {tag}", read_launches(), {})
        check(bool(torch.isfinite(fin.v_m).all()), f"dryrun {tag}: flat "
              "step not finite")
        del fin
        # DRYRUN_CUDA_STEPS steps through "cuda" on the blocked consts
        if blk is None:   # laid out once, from the int32 consts
            blk, blocked_meta, relayout_s = dryrun_snn.blocked_consts(
                consts, dims)
        t1 = time.perf_counter()
        step = dist.make_raw_distributed_step(
            mesh, groups, cfg("cuda"), blocked_meta=blocked_meta,
            **kw).bind({**consts, **blk})
        torch.cuda.synchronize()
        bind_s = time.perf_counter() - t1
        # the flat step drew from st0's generators: the same stream anew
        st = dataclasses.replace(st0, generators=dist.shard_generators(
            SEED, (0,), DEV))
        reset_launches()
        t1 = time.perf_counter()
        fin, spikes = step.run(st, DRYRUN_CUDA_STEPS)
        wall = time.perf_counter() - t1
        launches[tag] = read_launches()
        check_launches(f"dryrun cuda {tag}", launches[tag],
                       {k: DRYRUN_CUDA_STEPS for k in MAIN_KERNELS})
        check(bool(torch.isfinite(fin.v_m).all())
              and bool(torch.isfinite(fin.weights).all()),
              f"dryrun {tag}: state not finite")
        n_spikes = int(spikes.sum())
        check(n_spikes > 0, f"dryrun {tag}: the shard did not fire in "
              f"{DRYRUN_CUDA_STEPS} steps")
        rasters[tag] = spikes
        check(torch.equal(spikes, rasters[f"scale {scale:g} i32"]),
              f"dryrun {tag}: the cuda raster differs from int32's")
        lock = dryrun_lockstep(step, flat, fin, table, tag)
        if not compact:
            g = step.graphs[0]   # the int32 shard, for the twins below
        emit({"phase": "dryrun_shard", "cell": f"16x16 {tag}", **dims,
              "blocked_meta": blocked_meta, "draw_s": draw_s,
              "relayout_s": relayout_s, "argument_gib": arg_bytes / 2**30,
              "flat_step_peak_gib": peak / 2**30,
              "cuda_bind_s": bind_s, "cuda_steps": DRYRUN_CUDA_STEPS,
              "cuda_ms_per_step": wall / DRYRUN_CUDA_STEPS * 1e3,
              "spikes": n_spikes, **lock, "card": card})
        del step, flat, st, fin, consts, st0
    # K1 + K2 and K3 against their twins at the shard's shapes
    rng = np.random.default_rng(SEED + 22)
    label = f"dryrun_kernel scale {scale:g}"
    phase_fused_kernel("lif", g, table, rng, drive_on=True, label=label)
    kernel_stdp(g, rng, label=label)
    return launches


def phase_dryrun(card: str) -> dict:
    """The SNN dry run (``repro_torch.launch.dryrun_snn``): (a) the 24
    cells of its ``main`` on ``meta``, each with its gathered bytes equal
    to the wire model; (b) one shard of the 16x16 cells at scales 1 and 4
    materialized on the card (:func:`dryrun_shard`); (c) the firing probe
    at hpc_benchmark(1.0), 400 steps, 4x2 rows, through ``"cuda"``.
    Returns the launches of each counted run."""
    t_phase = t0 = time.perf_counter()
    for multi_pod in (False, True):
        for scale in (1.0, 4.0):
            for w, rw, compact, overlap in dryrun_snn.VARIANTS:
                rec = dryrun_snn.run_cell(scale, multi_pod, w,
                                          compact=compact, overlap=overlap,
                                          wire_remote=rw)
                check(rec["collective_bytes"] == rec["wire_model_bytes"],
                      f"dryrun cell {rec['mesh']} {scale} {w}+{rw}: "
                      f"gathered {rec['collective_bytes']} B against the "
                      f"wire model's {rec['wire_model_bytes']}")
                print(dryrun_snn.cell_line(rec, card), flush=True)
    emit({"phase": "dryrun_meta", "cells": 24,
          "seconds": time.perf_counter() - t0})
    launches = {}
    for scale in DRYRUN_SHARD_SCALES:
        launches.update(dryrun_shard(scale, card))
    reset_launches()
    t0 = time.perf_counter()
    probe = dryrun_snn.measure_firing_rates(seed=SEED, device=DEV,
                                            **DRYRUN_PROBE)
    launches["probe"] = read_launches()
    check_launches("dryrun probe", launches["probe"],
                   {"synaptic_gather_lif": DRYRUN_PROBE["steps"]})
    n = models.hpc_benchmark(DRYRUN_PROBE["scale"])[0].n_neurons
    check(sum(r["n"] for r in probe["rows"]) == n and probe["frac_peak"] > 0
          and probe["recommended_gate"].startswith("cuda:sparse:"),
          f"dryrun probe: {probe}")
    emit({"phase": "dryrun_probe", "seconds": time.perf_counter() - t0,
          **probe})
    emit({"phase": "dryrun", "seconds": time.perf_counter() - t_phase})
    return launches


# --------------------------------------------------------------------------
# phases 6-9: the neuron-model zoo
# --------------------------------------------------------------------------

def phase_zoo_kernels(n: int = 10_000) -> dict:
    """K4 and K5 at a zoo network's width, on the model_demo tables."""
    rng = np.random.default_rng(SEED + 3)
    ranges = {"izhikevich": ((-70, 25), (-16, 0), (0, 30), (-30, 0),
                             (0, 20), (-20, 0)),
              "adex": ((-75, -35), (0, 100), (0, 300), (-300, 0), (0, 50),
                       (-50, 0))}
    out = {}
    for model, (mod, kernel) in ZOO_KERNELS.items():
        spec, _ = models.model_demo(model, 1.0)
        table = neuron_models.get_model(model).make_param_table(
            list(spec.groups), models.DT_MS, device=DEV)
        f32 = [torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))
               .to(DEV) for lo, hi in ranges[model]]
        rc = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(DEV)
        gid = torch.from_numpy(rng.integers(0, table.shape[0], n)
                               .astype(np.int32)).to(DEV)
        args = (*f32[:4], rc, gid, *f32[4:], table)
        plain = getattr(mod, f"{model}_step_plain")
        k1, k2, pl = kernel(*args), kernel(*args), plain(*args)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              f"{model}: kernel not bitwise deterministic")
        check(k1[5].any() and (rc > 0).any(), f"{model}: vacuous inputs")
        check(torch.equal(k1[4], pl[4]) and torch.equal(k1[5], pl[5]),
              f"{model}: ref_count or spikes differ from the twin")
        errs = {name: max_abs(a, b) for name, a, b in zip(
            ("v", "x", "syn_ex", "syn_in"), k1[:4], pl[:4])}
        if model == "izhikevich":
            tol = "bitwise equal"
            check(all(torch.equal(a, b) for a, b in zip(k1, pl)),
                  f"izhikevich differs from its twin: {errs}")
        else:
            tol = "spikes, ref_count exact; floats within 8 ulp of max |x|"
            for a, b in zip(k1[:4], pl[:4]):
                lim = 8 * 2.0 ** -23 * float(b.abs().max())
                check(max_abs(a, b) <= lim, f"adex differs from its twin: "
                      f"{errs}")
        k_ms = median_ms(lambda: kernel(*args))
        l_ms = loop_ms(lambda: kernel(*args))
        p_ms = median_ms(lambda: plain(*args))
        nbytes = n * (6 * 4 + 2 * 4) + table.numel() * 4 + n * (4 * 4 + 5)
        b_ms, b_by = bound(nbytes, (25 if model == "izhikevich" else 35) * n)
        name = f"{model}_step"
        out[name] = dict(max_abs_err=max(errs.values()), ms=k_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, ms_per_launch=l_ms)
        emit({"phase": "kernel", "name": name, "n": n,
              "groups": table.shape[0], "max_abs_err": errs,
              "tolerance": tol, "deterministic": True, "kernel_ms": k_ms,
              "kernel_ms_per_launch_over_many": l_ms,
              "launches_timed": LOOP_LAUNCHES, "plain_ms": p_ms,
              "bound_ms": b_ms, "bytes": nbytes})
    return out


def build_network(spec, what: str, ref: dict):
    """One shard of ``spec`` on the card and its model's table; ``spec``
    must be the network of the reference record ``ref``."""
    t0 = time.perf_counter()
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(DEV)
    check(spec.neuron_model == ref["network"]
          and spec.n_neurons == ref["neurons"]
          and int((g.delay > 0).sum()) == ref["synapses"],
          f"{what}: not the network of the reference record")
    table = neuron_models.get_model(spec.neuron_model).make_param_table(
        list(spec.groups), models.DT_MS, device=DEV)
    emit({"phase": "build", "network": what, "neurons": spec.n_neurons,
          "n_local": g.n_local, "edges": int((g.delay > 0).sum()),
          "nb": g.blocked.nb, "eb": g.blocked.eb, "max_delay": g.max_delay,
          "host_build_s": time.perf_counter() - t0})
    return g, table


def phase_zoo_lockstep(model, spec, stdp, g, table, n_steps: int = 120):
    """The kernel and flat backends step from one state every step: the
    same spikes except within ``v_tol`` of ``v_peak``."""
    mod, _ = ZOO_KERNELS[model]
    (x_name,) = neuron_models.get_model(model).extra_fields
    cb, fb = backends.get_backend("cuda"), backends.get_backend("flat")
    lc, lf = cb.prepare(g), fb.prepare(g)
    cfg_c = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda",
                                external_drive=False, neuron_model=model)
    cfg_f = dataclasses.replace(cfg_c, sweep="flat")
    st = engine.init_state(g, list(spec.groups), SEED, sweep="cuda",
                           neuron_model=model, device=DEV)
    # the proposed membrane (before threshold and reset) is what the twin
    # returns when nothing can spike: v_peak at infinity, ref_count 0
    no_peak = table.clone()
    no_peak[:, mod.COL["v_peak"]] = float("inf")
    v_peak = table[g.group_id.long(), mod.COL["v_peak"]]
    plain = getattr(mod, f"{model}_step_plain")
    v_tol, n_near, n_flip, n_spk = 1e-3, 0, 0, 0
    worst = dict(i_ex=0.0, i_in=0.0, v_m=0.0, x=0.0, weights=0.0,
                 k_pre=0.0, k_post=0.0)
    real = g.delay > 0
    reset_launches()
    for _ in range(n_steps):
        stf = engine.state_with_weights_layout(st, g, "flat")
        ex_c, in_c, _ = cb.sweep(lc, st.weights, st.ring, st.t)
        ex_f, in_f, _ = fb.sweep(lf, stf.weights, stf.ring, stf.t)
        new_c, sp_c = engine.engine_step(st, g, table, cfg_c)
        new_f, sp_f = engine.engine_step(stf, g, table, cfg_f)
        nv = st.neurons
        v_prop = plain(nv.v_m, nv.extra[x_name], nv.syn_ex, nv.syn_in,
                       torch.zeros_like(nv.ref_count), nv.group_id, ex_c,
                       in_c, no_peak)[0]
        near = ((v_prop - v_peak).abs() < v_tol) & (nv.ref_count == 0)
        flip = sp_c != sp_f
        check(not bool((flip & ~near).any()),
              f"zoo_lockstep {model}: spikes differ away from v_peak")
        n_near += int(near.sum())
        n_flip += int(flip.sum())
        n_spk += int(sp_c.sum())
        same = ~flip
        wc = engine.state_with_weights_layout(new_c, g, "flat").weights
        # a row sums hundreds of same-signed inputs in another order on
        # each backend: its error scales with the sum, so it is relative
        for key, a, b in (("i_ex", ex_c, ex_f), ("i_in", in_c, in_f)):
            rel = max_abs(a, b) / max(1.0, float(b.abs().max()))
            worst[key] = max(worst[key], rel)
        for key, a, b in (
                ("v_m", new_c.neurons.v_m[same], new_f.neurons.v_m[same]),
                ("x", new_c.neurons.extra[x_name][same],
                 new_f.neurons.extra[x_name][same]),
                ("weights", wc[real], new_f.weights[real]),
                ("k_pre", new_c.traces.k_pre, new_f.traces.k_pre),
                ("k_post", new_c.traces.k_post, new_f.traces.k_post)):
            worst[key] = max(worst[key], max_abs(a, b))
        st = new_c
    # the kernel backend's steps (ZOO_MAIN_KERNELS) beside the plain K1 of
    # the comparison sums above
    launches = read_launches()
    want = dict.fromkeys(ZOO_MAIN_KERNELS[model], n_steps)
    want["synaptic_gather"] = want.get("synaptic_gather", 0) + n_steps
    check_launches(f"zoo_lockstep {model}", launches, want)
    tol = dict(i_ex=1e-5, i_in=1e-5, v_m=1e-4, x=1e-4, weights=1e-4,
               k_pre=1e-5, k_post=1e-5)
    for key, lim in tol.items():
        check(worst[key] <= lim, f"zoo_lockstep {model}: {key} differs by "
              f"{worst[key]} > {lim}")
    check(n_spk > 0, f"zoo_lockstep {model}: nothing spiked - vacuous")
    emit({"phase": "zoo_lockstep", "model": model, "steps": n_steps,
          "spikes": n_spk, "near_v_peak": n_near, "flipped": n_flip,
          "v_peak_tol_mV": v_tol, "extra_variable": x_name,
          "max_err": worst, "tolerance": tol,
          "relative": ["i_ex", "i_in"],
          "launches": {k: v for k, v in launches.items() if v}})


def population_rates(spec, spikes, ref: dict) -> dict:
    """Per population, in the reference record's windows: the rate per
    window and from ``mean_from_step`` on."""
    sp, win, start = spikes.cpu(), ref["window_steps"], ref["mean_from_step"]
    off = spec.pop_offsets()
    out = {}
    for i, pop in enumerate(spec.populations):
        s = sp[:, off[i]:off[i + 1]]
        out[pop.name] = {"per_window_hz": [
            models.firing_rate_hz(s[j:j + win])
            for j in range(0, s.shape[0], win)],
            "mean_hz": models.firing_rate_hz(s[start:])}
    return out


def check_rates(what: str, rates: dict, ref: dict, mean_band: float) -> None:
    lo, hi = WINDOW_BAND
    for pop, want in ref["populations"].items():
        got = rates[pop]
        for i, (a, b) in enumerate(zip(got["per_window_hz"],
                                       want["per_window_hz"])):
            check(lo * b <= a <= hi * b, f"{what}: {pop} rate {a} Hz in "
                  f"window {i} outside [{lo}, {hi}] x the reference's {b}")
        a, b = got["mean_hz"], want["mean_hz"]
        check(abs(a - b) <= mean_band * b, f"{what}: {pop} mean rate {a} Hz "
              f"is not within {mean_band:.0%} of the reference's {b}")


def keyed_band(ref: dict) -> dict:
    """Per population of a record of several keys: the band ``[lo x min,
    hi x max]`` over the keys of each window from ``mean_from_step`` on
    (None before it), and the mean's centre and relative tolerance
    (:data:`KEYED_MEAN_BAND` or the keys' spread)."""
    lo, hi = WINDOW_BAND
    first = ref["mean_from_step"] // ref["window_steps"]
    keys = list(ref["by_key"].values())
    out = {}
    for pop in keys[0]["populations"]:
        per = [k["populations"][pop] for k in keys]
        wins = list(zip(*(p["per_window_hz"] for p in per)))
        means = [p["mean_hz"] for p in per]
        centre = sum(means) / len(means)
        spread = (max(means) - min(means)) / centre if centre else 0.0
        out[pop] = {"windows": [None if i < first else
                                [lo * min(w), hi * max(w)]
                                for i, w in enumerate(wins)],
                    "mean": centre, "mean_tol": max(KEYED_MEAN_BAND, spread)}
    return out


def check_keyed_rates(what: str, rates: dict, ref: dict) -> dict:
    """The port's per-population rates (``population_rates``' form) inside
    :func:`keyed_band` of a record of several keys; returns the band."""
    band = keyed_band(ref)
    for pop, b in band.items():
        got = rates[pop]
        for i, (a, w) in enumerate(zip(got["per_window_hz"], b["windows"])):
            if w is None:
                continue
            lo, hi = w
            check(lo <= a <= hi, f"{what}: {pop} rate {a} Hz in window {i} "
                  f"outside the reference keys' band [{lo}, {hi}]")
        a = got["mean_hz"]
        check(abs(a - b["mean"]) <= b["mean_tol"] * b["mean"],
              f"{what}: {pop} mean rate {a} Hz is not within "
              f"{b['mean_tol']:.1%} of the reference keys' {b['mean']}")
    return band


def phase_zoo_main(model, spec, stdp, g, table, ref: dict):
    """Returns the run's launches, and on the host its spikes and final
    state (the network's gated run must reproduce them bitwise)."""
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda",
                              external_drive=False, neuron_model=model)
    _, fin, spikes, rec = run_counted(
        f"zoo_main {model}", spec, g, table, cfg, ref["steps"],
        ZOO_MAIN_KERNELS[model])
    rates = population_rates(spec, spikes, ref)
    check_rates(f"zoo_main {model}", rates, ref, MEAN_BAND[model])
    emit({"phase": "zoo_main", "model": model, "neurons": spec.n_neurons,
          "synapses": int((g.delay > 0).sum()),
          "mean_from_step": ref["mean_from_step"],
          "mean_rate_hz": models.firing_rate_hz(
              spikes[ref["mean_from_step"]:], spec.n_neurons),
          "rates_hz": rates,
          "rate_band": {"window": WINDOW_BAND, "mean": MEAN_BAND[model]},
          **rec, "profile": _profile(g, table, cfg, spec)})
    return rec["launches"], {"spikes": spikes.cpu(),
                             "weights": fin.weights.cpu(),
                             **{k: x.cpu() for k, x in (
                                 ("v_m", fin.neurons.v_m),
                                 *fin.neurons.extra.items())}}


def phase_zoo_gate(model, spec, stdp, g, table, ref: dict,
                   main_out: dict) -> dict:
    """The ``model`` network through the activity gate (``"cuda:sparse"``):
    K6, then the standalone K4 or K5 (the gated backend keeps the composed
    route), then K3 or K7.  Spikes, ``v_m``, the model's extra variable
    (``u``, ``w_ad``) and weights must equal the fused ``zoo_main`` run's
    bitwise: K6 sums as K1 does, and the standalone kernel and K1's
    epilogue share one source.  Returns the run's launches."""
    sweep = "cuda:sparse"
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep=sweep,
                              external_drive=False, neuron_model=model)
    backend = backends.get_backend(sweep)
    cap = backend.gate_capacity(backend.prepare(g))
    kernels = ("blocked_reduce_sweep", f"{model}_step",
               "stdp_update" if cap >= g.blocked.nb
               else "stdp_update_worklist")
    _, fin, spikes, rec = run_counted(f"zoo_gate {model} {sweep}", spec, g,
                                      table, cfg, ref["steps"], kernels)
    (x_name,) = neuron_models.get_model(model).extra_fields
    for name, a in (("spikes", spikes), ("weights", fin.weights),
                    ("v_m", fin.neurons.v_m),
                    (x_name, fin.neurons.extra[x_name])):
        check(torch.equal(a.cpu(), main_out[name]),
              f"zoo_gate {model}: {name} differ from the fused run's")
    emit({"phase": "zoo_gate", "model": model, "sweep": sweep,
          "capacity": cap, "nb": g.blocked.nb,
          "bitwise_equal_to_zoo_main": True, **rec,
          "profile": _profile(g, table, cfg, spec)})
    return rec["launches"]


def phase_composite(spec, g, table, ref: dict) -> dict:
    """brunel + Poisson emitter population on the port's own draws; returns
    the run's launches."""
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=None, sweep="cuda",
                              external_drive=False,
                              neuron_model=spec.neuron_model)
    # "lif+poisson" keeps the composed route: K1, then the standalone K2
    init, fin, spikes, rec = run_counted(
        "composite", spec, g, table, cfg, ref["steps"],
        ("synaptic_gather", "lif_step"))
    n_steps = ref["steps"]
    off = spec.pop_offsets()
    emit_rows = slice(off[2], off[3])
    p = float(table[spec.populations[2].group, -1])
    n = spikes[:, emit_rows].numel()
    got = int(spikes[:, emit_rows].sum())
    sigma = float(np.sqrt(n * p * (1 - p)))
    check(abs(got - n * p) <= 4 * sigma, f"composite: {got} emitter "
          f"spikes, expected {n * p} +- 4 x {sigma}")
    for name in ("v_m", "syn_ex", "syn_in", "ref_count"):
        check(torch.equal(getattr(fin.neurons, name)[emit_rows],
                          getattr(init, name)[emit_rows]),
              f"composite: emitter {name} changed")
    rates = population_rates(spec, spikes, ref)
    check_rates("composite", rates, ref, MEAN_BAND[spec.neuron_model])
    emit({"phase": "composite", "model": spec.neuron_model,
          "neurons": spec.n_neurons, "synapses": int((g.delay > 0).sum()),
          "emitters": n // n_steps, "emitter_spikes": got,
          "emitter_expected": n * p, "emitter_sigma": sigma,
          "mean_from_step": ref["mean_from_step"], "rates_hz": rates,
          "rate_band": {"window": WINDOW_BAND,
                        "mean": MEAN_BAND[spec.neuron_model]},
          **rec, "profile": _profile(g, table, cfg, spec)})
    return rec["launches"]


def zoo():
    """Phases 6-9, each network at the scale and length of the reference's
    record; returns (kernel numbers, launches by path)."""
    kern = phase_zoo_kernels()
    launches = {}
    for model in ZOO_KERNELS:
        ref = ZOO_REFERENCE[model]
        spec, stdp = models.model_demo(model, ref["scale"], stdp=True)
        g, table = build_network(spec, f"model_demo {model}", ref)
        kern.update(phase_fused_kernel(
            model, g, table, np.random.default_rng(SEED + 4),
            drive_on=False))      # zoo_main runs without a drive
        del kern["_k1_ms_per_launch"]
        phase_zoo_lockstep(model, spec, stdp, g, table)
        launches[f"zoo_main {model}"], main_out = phase_zoo_main(
            model, spec, stdp, g, table, ref)
        launches[f"zoo_gate {model}"] = phase_zoo_gate(
            model, spec, stdp, g, table, ref, main_out)
        del g, table, main_out
    ref = ZOO_REFERENCE["lif+poisson"]
    spec, _ = models.brunel(ref["scale"], poisson_input=True)
    g, table = build_network(spec, "brunel poisson_input", ref)
    launches["composite"] = phase_composite(spec, g, table, ref)
    return kern, launches


# --------------------------------------------------------------------------
# phases 10-12: the activity gate (K6, K7)
# --------------------------------------------------------------------------

def _lists(nb: int, rng) -> dict:
    """The worklists of phase 10, each ``(worklist, n_active)``: 8 random
    blocks of ``nb`` with sentinel padding (capacity 12), the empty list,
    the identity list, and a saturated list (n_active > capacity: every
    block is walked)."""
    cap = 12
    wl8 = np.full(cap, nb, np.int32)
    wl8[:8] = np.sort(rng.choice(nb, 8, replace=False))
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=DEV)
    return {"worklist_8": (i32(wl8), i32(8)),
            "empty": (i32(np.full(cap, nb)), i32(0)),
            "identity": (i32(np.arange(nb)), i32(nb)),
            "saturated": (i32(wl8), i32(max(nb, cap + 1)))}


def phase_gate_kernels(g) -> dict:
    """K6 and K7 at the main path's shapes against their twins, K1 and
    K3."""
    rng = np.random.default_rng(SEED + 5)
    bg = g.blocked
    nb, eb, pb, d, m, n = bg.nb, bg.eb, bg.pb, g.max_delay, g.n_mirror, \
        g.n_local
    bounds = gather_mod.segment_bounds(bg.post_rel, bg.delay, pb=pb,
                                       max_delay=d)
    w = torch.from_numpy(rng.normal(0, 50, (nb, eb)).astype(np.float32)
                         ).to(DEV)
    ring = torch.from_numpy((rng.uniform(size=(d, m)) < 0.05)
                            .astype(np.float32)).to(DEV)
    t = torch.tensor(7, dtype=torch.int32, device=DEV)
    # K1's sums and arrivals: the arrivals are what the gate's pre-pass
    # hands K6, and K6 must reproduce K1's sums bitwise
    ex1, in1, arrived = gather_mod.synaptic_gather(
        bg.pre_idx, bg.post_rel, w, bg.delay, bg.channel, ring, t,
        max_delay=d, pb=pb, bounds=bounds)
    live_per_block = (bg.delay > 0).sum(dim=1)
    plastic_per_block = (bg.plastic & (bg.delay > 0)).sum(dim=1)
    lists = _lists(nb, rng)
    out, lines = {}, {}

    # K6
    rargs = (bg.post_rel, bg.delay, w, arrived, bg.channel)
    for name, (wl, na) in [("no_list", (None, None)), *lists.items()]:
        kw = dict(max_delay=d, pb=pb, worklist=wl, n_active=na,
                  bounds=bounds)
        k1, k2 = (gather_mod.blocked_reduce_sweep(*rargs, **kw)
                  for _ in range(2))
        pl = gather_mod.blocked_reduce_sweep_plain(
            bg.post_rel, w, arrived, bg.channel, pb=pb, worklist=wl,
            n_active=na)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              f"K6 ({name}) not bitwise deterministic")
        err = max(max_abs(k1[0], pl[0]), max_abs(k1[1], pl[1]))
        check(err <= 1e-2, f"K6 ({name}) differs from its twin by {err}")
        listed = (torch.ones(nb, dtype=torch.bool, device=DEV) if wl is None
                  else gather_mod.listed_blocks(wl, na, nb))
        rows = listed.repeat_interleave(pb)
        check(torch.equal(k1[0][rows], ex1[rows])
              and torch.equal(k1[1][rows], in1[rows]),
              f"K6 ({name}) sums differ from K1's")
        check(not bool(k1[0][~rows].any() or k1[1][~rows].any()),
              f"K6 ({name}) wrote an unlisted block")
        k_ms = median_ms(lambda: gather_mod.blocked_reduce_sweep(*rargs,
                                                                 **kw))
        p_ms = median_ms(lambda: gather_mod.blocked_reduce_sweep_plain(
            bg.post_rel, w, arrived, bg.channel, pb=pb, worklist=wl,
            n_active=na))
        live = int(live_per_block[listed].sum())
        n_listed = int(listed.sum())
        nbytes = (live * 12 + n_listed * (d * pb + 1) * 4 + 2 * nb * pb * 4
                  + (0 if wl is None else wl.numel() * 4 + 4))
        b_ms, b_by = bound(nbytes, 2 * live)
        lines[name] = dict(blocks_walked=n_listed, live_slots=live,
                           max_abs_err=err, kernel_ms=k_ms, plain_ms=p_ms,
                           bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        if name == "no_list":   # the full-capacity gate's shape
            out["blocked_reduce_sweep"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes)
    emit({"phase": "kernel", "name": "blocked_reduce_sweep", "nb": nb,
          "eb": eb, "pb": pb, "d": d, "capacity": 12,
          "tolerance": "twin atol 1e-2; K1's sums bitwise; unlisted rows 0",
          "deterministic": True, "lists": lines})

    # K7
    e = nb * eb
    w0 = torch.from_numpy(rng.uniform(1, 100, e).astype(np.float32)).to(DEV)
    sargs = (bg.pre_idx.reshape(-1), bg.post_rel.reshape(-1),
             bg.plastic.reshape(-1), arrived.reshape(-1))
    sp = (torch.rand(n, device=DEV) < 0.05).float()
    k_pre, k_post = torch.rand(m, device=DEV) * 3, torch.rand(n, device=DEV) * 3
    params = (models.HPC_STDP.lam, models.HPC_STDP.alpha, models.HPC_STDP.mu,
              models.HPC_STDP.w0, models.HPC_STDP.w_min,
              models.HPC_STDP.w_max)
    kw = dict(params=params, eb=eb, pb=pb)
    w3 = stdp_mod.stdp_update(w0, *sargs, sp, k_pre, k_post, **kw)
    lines = {}
    for name, (wl, na) in lists.items():
        ka, kb, wp = w0.clone(), w0.clone(), w0.clone()
        for x in (ka, kb):
            check(stdp_mod.stdp_update_worklist(x, *sargs, wl, na, sp, k_pre,
                                                k_post, **kw) is x,
                  "K7 did not update in place")
        stdp_mod.stdp_update_worklist_plain(wp, *sargs, wl, na, sp, k_pre,
                                            k_post, **kw)
        check(torch.equal(ka, kb), f"K7 ({name}) not bitwise deterministic")
        err = max_abs(ka, wp)
        check(torch.allclose(ka, wp, rtol=2e-6, atol=0),
              f"K7 ({name}) differs from its twin by {err}")
        listed = gather_mod.listed_blocks(wl, na, nb)
        slots = listed.repeat_interleave(eb)
        check(torch.equal(ka[slots], w3[slots]),
              f"K7 ({name}) weights differ from K3's on listed blocks")
        check(torch.equal(ka[~slots], w0[~slots]),
              f"K7 ({name}) touched an unlisted block")
        check(name == "empty" or not torch.equal(ka, w0),
              f"K7 ({name}) changed nothing - vacuous")
        scratch = w0.clone()
        k_ms = median_ms(lambda: stdp_mod.stdp_update_worklist(
            scratch, *sargs, wl, na, sp, k_pre, k_post, **kw))
        p_ms = median_ms(lambda: stdp_mod.stdp_update_worklist_plain(
            scratch, *sargs, wl, na, sp, k_pre, k_post, **kw))
        n_listed = int(listed.sum())
        n_slots = n_listed * eb
        n_plastic = int(plastic_per_block[listed].sum())
        nbytes = (n_slots + n_plastic * 20 + (2 * n + m) * 4
                  + wl.numel() * 4 + 4)
        b_ms, b_by = bound(nbytes, 20 * n_plastic)
        lines[name] = dict(blocks_walked=n_listed,
                           plastic_slots=n_plastic, max_abs_err=err,
                           kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes)
        if name == "saturated":   # the forced gate's step once ignited
            out["stdp_update_worklist"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes)
    emit({"phase": "kernel", "name": "stdp_update_worklist", "nb": nb,
          "eb": eb, "pb": pb, "capacity": 12,
          "tolerance": "twin rtol 2e-6; K3's weights bitwise on listed "
                       "blocks; others untouched",
          "deterministic": True, "in_place": True, "lists": lines})
    return out


def gate_branches(g, spikes, cap: int) -> dict:
    """The gate's decisions of a run, recomputed on the host from its
    raster: per step the blocks with an arrival (a pre spike ``delay``
    steps earlier, read through the blocked layout) and, for plasticity,
    also those with a post spike; a step saturates when more blocks than
    ``cap`` are active.  (On the host, so that the check's matrix product
    leaves no cuBLAS workspace on the card to count in later phases' peak
    memory.)"""
    bg = g.blocked
    delay, pre = bg.delay.cpu(), bg.pre_idx.cpu().long()
    spikes = spikes.cpu()
    nb, pb, n_steps = bg.nb, bg.pb, spikes.shape[0]
    bits = spikes[:, g.mirror_src_idx.cpu().long()].float()     # (T, M)
    hits = torch.zeros(n_steps, nb)
    blk = torch.arange(nb)[:, None].expand(nb, bg.eb)
    for dly in torch.unique(delay[delay > 0]).tolist():
        sel = delay == dly
        a = torch.zeros(nb, g.n_mirror)
        a[blk[sel], pre[sel]] = 1.0
        if dly < n_steps:
            hits[dly:] += bits[:-dly] @ a.t()
    arr = hits > 0
    post = torch.nn.functional.pad(spikes, (0, nb * pb - g.n_local)
                                   ).reshape(n_steps, nb, pb).any(dim=2)
    n_sweep, n_stdp = arr.sum(dim=1), (arr | post).sum(dim=1)
    return {"sweep_saturated": int((n_sweep > cap).sum()),
            "sweep_gated": int((n_sweep <= cap).sum()),
            "sweep_gated_live": int(((n_sweep > 0) & (n_sweep <= cap)).sum()),
            "stdp_saturated": int((n_stdp > cap).sum()),
            "stdp_gated_live": int(((n_stdp > 0) & (n_stdp <= cap)).sum())}


def phase_gate_main(spec, stdp, g, table, main_out: dict,
                    n_steps: int = 2000) -> dict:
    """The gate on the main path: both runs must give the ``main`` run's
    spikes, voltages and weights (``main_out``, on the host) bitwise.
    Returns the forced run's launches and each run's steps/s."""
    launches, rates = {}, {}
    for sweep, kernels in GATE_KERNELS.items():
        cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep=sweep)
        backend = backends.get_backend(sweep)
        cap = backend.gate_capacity(backend.prepare(g))
        _, fin, spikes, rec = run_counted(f"gate_main {sweep}", spec, g,
                                          table, cfg, n_steps, kernels)
        for name, a in (("spikes", spikes), ("v_m", fin.neurons.v_m),
                        ("weights", fin.weights)):
            check(torch.equal(a.cpu(), main_out[name]),
                  f"gate_main {sweep}: {name} differ from the cuda run's")
        branches = gate_branches(g, spikes, cap)
        overflow = int(fin.gate_overflow)
        if cap >= g.blocked.nb:
            check(overflow == 0, f"gate_main {sweep}: overflow {overflow} "
                  "at full capacity")
        else:
            check(overflow == branches["sweep_saturated"],
                  f"gate_main {sweep}: gate_overflow {overflow} != "
                  f"{branches['sweep_saturated']} saturated steps in the "
                  "raster")
            check(overflow > 0 and branches["sweep_gated"] > 0,
                  f"gate_main {sweep}: a branch never ran: {branches}")
            check(branches["stdp_gated_live"] > 0,
                  f"gate_main {sweep}: K7 never updated a live block on "
                  f"the gated branch: {branches}")
        rec["launches_per_step"] = {k: v / n_steps
                                    for k, v in rec["launches"].items() if v}
        emit({"phase": "gate_main", "sweep": sweep, "capacity": cap,
              "nb": g.blocked.nb, "gate_overflow": overflow,
              "steps_by_branch": branches, "bitwise_equal_to_main": True,
              **rec, "profile": _profile(g, table, cfg, spec)})
        launches = rec["launches"]
        rates[sweep] = rec["steps_per_s"]
    return launches, rates


# --------------------------------------------------------------------------
# phase 21: the (PB, EB) block shapes
# --------------------------------------------------------------------------

def phase_shape_tune(g) -> dict:
    """(a) K1 + K2, K3, K6 and K7 at each candidate (PB, EB) of ``g``,
    the graph laid out again by ``CudaBackend(block_shapes=(PB, EB))``:
    each against its twin and timed.  Writes the ``shape_tune/`` records
    to :data:`SHAPES_FILE` and returns them by PB."""
    rng = np.random.default_rng(SEED + 7)
    cands = autotune._candidates([g], autotune.DEFAULT_PB_CANDIDATES,
                                 autotune.DEFAULT_EB_MULTIPLE,
                                 autotune.DEFAULT_DEVICE_BUDGET)
    sig = autotune.degree_signature(autotune.degrees_from_graphs([g]))
    table = snn.make_param_table([snn.LIFParams(t_ref=0.5),
                                  snn.LIFParams(tau_m=8.0)], models.DT_MS,
                                 device=DEV)
    out, records = {}, []
    for c in cands:
        check(c.feasible, f"shape_tune: pb={c.pb} infeasible: {c}")
        t0 = time.perf_counter()
        lay = backends.CudaBackend(block_shapes=c.as_tuple()).prepare(g)
        torch.cuda.synchronize()
        relayout_s = time.perf_counter() - t0
        bg = lay.blocked
        check((bg.pb, bg.eb, bg.nb) == (c.pb, c.eb, c.nb),
              f"shape_tune: laid out {(bg.pb, bg.eb, bg.nb)} for {c}")
        check(int((bg.delay > 0).sum()) == int((g.delay > 0).sum()),
              f"shape_tune: pb={c.pb} lost edges in the relayout")
        gp = dataclasses.replace(g, blocked=bg)
        fused = phase_fused_kernel("lif", gp, table, rng, drive_on=True)
        k12 = fused["synaptic_gather_lif"]
        k3 = kernel_stdp(gp, rng)
        gate = phase_gate_kernels(gp)
        us = (k12["ms"] + k3["ms"]) * 1e3
        rec = {"pb": c.pb, "eb": c.eb, "nb": c.nb,
               "padded_slots": c.padded_slots,
               "live_slots": int((bg.delay > 0).sum()),
               "bounds_bytes": lay.seg_bounds.numel() * 4,
               "device_bytes_model": c.device_bytes,
               "relayout_s": relayout_s,
               "k1k2_ms": k12["ms"], "k1k2_ms_per_launch":
                   k12["ms_per_launch"],
               "k1_ms_per_launch": fused["_k1_ms_per_launch"],
               "k1k2_bound_ms": k12["bound_ms"], "k3_ms": k3["ms"],
               "k3_bound_ms": k3["bound_ms"],
               "k6_ms": gate["blocked_reduce_sweep"]["ms"],
               "k7_saturated_ms": gate["stdp_update_worklist"]["ms"],
               "max_abs_err": {"k1k2": k12["max_abs_err"],
                               "k3": k3["max_abs_err"],
                               "k6": gate["blocked_reduce_sweep"][
                                   "max_abs_err"],
                               "k7": gate["stdp_update_worklist"][
                                   "max_abs_err"]},
               "us_per_call": us}
        emit({"phase": "shape_tune", "signature": sig, **rec})
        records.append({"name": f"shape_tune/{sig}/pb{c.pb}xeb{c.eb}",
                        **rec})
        out[c.pb] = rec
        del lay, bg, gp
    os.makedirs(os.path.dirname(SHAPES_FILE), exist_ok=True)
    with open(SHAPES_FILE, "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0),
                   "records": records}, f, indent=1)
    return out


def _check_same_run(what: str, fin, spikes, want: dict) -> None:
    """Raster, flat weights, ``v_m`` and traces bitwise ``want``'s (on
    the host)."""
    for name, a in (("spikes", spikes), ("v_m", fin.neurons.v_m),
                    ("weights", fin.weights), ("k_pre", fin.traces.k_pre),
                    ("k_post", fin.traces.k_post)):
        check(torch.equal(a.cpu(), want[name]),
              f"{what}: {name} differ from the reference run's")


def phase_shapes(spec, stdp, g, table, main_out: dict, tuned: dict,
                 gate_rates: dict) -> dict:
    """(b) ``"cuda:auto"``, (c) ``"measured:"`` and (d) the gate at the
    tuned shape, each bitwise its dense PB-256 run.  Returns each run's
    launches."""
    launches = {}
    n_steps = len(main_out["spikes"])
    main_rate = n_steps / main_out["wall_s"]

    # (b) the tuner's choice, laid out before the timed run
    auto = backends.get_backend("cuda:auto")
    t0 = time.perf_counter()
    bg = auto.prepare(g).blocked
    torch.cuda.synchronize()
    relayout_s = time.perf_counter() - t0
    want = autotune.autotune_block_shapes(g)
    check((bg.pb, bg.eb) == want.as_tuple(),
          f"shapes: cuda:auto laid out {(bg.pb, bg.eb)}, tuner {want}")
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda:auto")
    _, fin, spikes, rec = run_counted("shapes cuda:auto", spec, g, table,
                                      cfg, n_steps, MAIN_KERNELS)
    _check_same_run("shapes cuda:auto", fin, spikes, main_out)
    launches["auto"] = rec["launches"]
    emit({"phase": "shapes", "part": "auto", "pb": bg.pb, "eb": bg.eb,
          "nb": bg.nb, "padded_slots": bg.nb * bg.eb,
          "device_bytes_model": want.device_bytes, "relayout_s": relayout_s,
          "bitwise_equal_to_main": True, "main_steps_per_s": main_rate,
          **rec, "profile": _profile(g, table, cfg, spec)})

    # (c) the measured records of (a)
    measured = autotune.load_measured_timings(SHAPES_FILE)
    sig = autotune.degree_signature(autotune.degrees_from_graphs([g]))
    fastest = min((r for r in tuned.values()),
                  key=lambda r: (r["us_per_call"], -r["pb"]))
    check(len(measured) == len(tuned)
          and all(k[0] == sig for k in measured),
          f"shapes: {SHAPES_FILE} holds {sorted(measured)}")
    spec_m = f"measured:{SHAPES_FILE}"
    got = autotune.resolve_block_shapes(g, spec_m)
    check((got.pb, got.eb) == (fastest["pb"], fastest["eb"]),
          f"shapes: measured: resolved {got.as_tuple()}, fastest "
          f"{(fastest['pb'], fastest['eb'])}")
    short = {}
    for name, sweep in (("cuda", "cuda"),
                        ("measured", backends.CudaBackend(
                            block_shapes=spec_m))):
        cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep=sweep)
        _, fin, sp, rec = run_counted(f"shapes {name}", spec, g, table, cfg,
                                      SHAPES_MEASURED_STEPS, MAIN_KERNELS)
        short[name] = {"spikes": sp.cpu(), "v_m": fin.neurons.v_m.cpu(),
                       "weights": fin.weights.cpu(),
                       "k_pre": fin.traces.k_pre.cpu(),
                       "k_post": fin.traces.k_post.cpu()}
        if name == "measured":
            launches[name] = rec["launches"]
    for name in ("spikes", "v_m", "weights", "k_pre", "k_post"):
        check(torch.equal(short["measured"][name], short["cuda"][name]),
              f"shapes measured: {name} differ from the 200-step cuda run")
    check(torch.equal(short["cuda"]["spikes"],
                      main_out["spikes"][:SHAPES_MEASURED_STEPS]),
          "shapes: the 200-step cuda run is not main's first 200 steps")
    emit({"phase": "shapes", "part": "measured", "file": SHAPES_FILE,
          "pb": got.pb, "eb": got.eb, "us_per_call": fastest["us_per_call"],
          "steps": SHAPES_MEASURED_STEPS, "bitwise_equal_to_cuda": True})

    # (d) the gate at the tuned shape, at gate_main's rates
    for gate_name, kernels in GATE_KERNELS.items():
        backend = backends.CudaSparseBackend(
            gate_rate=backends.get_backend(gate_name).gate_rate,
            block_shapes="auto")
        lay = backend.prepare(g)
        cap = backend.gate_capacity(lay)
        cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep=backend)
        what = f"shapes gate {backend.name}"
        _, fin, spikes, rec = run_counted(what, spec, g, table, cfg,
                                          n_steps, kernels)
        _check_same_run(what, fin, spikes, main_out)
        gp = dataclasses.replace(g, blocked=lay.blocked)
        branches = gate_branches(gp, spikes, cap)
        overflow = int(fin.gate_overflow)
        if cap >= lay.blocked.nb:
            check(overflow == 0, f"{what}: overflow {overflow} at full "
                  "capacity")
        else:
            check(overflow == branches["sweep_saturated"],
                  f"{what}: gate_overflow {overflow} != "
                  f"{branches['sweep_saturated']} saturated steps")
            check(branches["sweep_gated"] > 0
                  and branches["stdp_gated_live"] > 0,
                  f"{what}: the gated branch never ran: {branches}")
        launches[f"gate {backend.name}"] = rec["launches"]
        emit({"phase": "shapes", "part": "gate", "sweep": backend.name,
              "pb": lay.blocked.pb, "eb": lay.blocked.eb,
              "nb": lay.blocked.nb, "capacity": cap,
              "gate_overflow": overflow, "steps_by_branch": branches,
              "bitwise_equal_to_main": True,
              "gate_main_steps_per_s": gate_rates[gate_name],
              **rec})
        del backend, lay, gp
    return launches


def area_localized_graph(nb=64, pb=256, eb=196_608, *, max_delay=8,
                         pres_per_block=32, seed=0):
    """The reference's gate geometry (``benchmarks/bench_snn.py::
    _area_localized_layout``, same draws): block b's edges come only from
    its own area's ``pres_per_block`` mirrors, a ragged tail block, 16
    padding slots a block.  Each block's slots are then sorted by
    (delay, post), padding at the tail, weights alongside, so that the run
    table of K1 and K6 applies.  Returns a one-shard graph on the card."""
    rng = np.random.default_rng(seed)
    n_local = nb * pb - pb // 2
    names = ("pre", "post", "delay", "channel", "plastic", "weight")
    a = {k: np.zeros((nb, eb), dt) for k, dt in zip(
        names, (np.int32, np.int32, np.int32, np.int32, bool, np.float32))}
    for b in range(nb):
        ne = eb - 16
        a["pre"][b, :ne] = rng.integers(b * pres_per_block,
                                        (b + 1) * pres_per_block, ne)
        hi = pb if (b + 1) * pb <= n_local else n_local - b * pb
        a["post"][b, :ne] = rng.integers(0, hi, ne)
        a["delay"][b, :ne] = rng.integers(1, max_delay + 1, ne)
        a["channel"][b, :ne] = rng.integers(0, 2, ne)
        a["plastic"][b, :ne] = rng.uniform(size=ne) < 0.7
        a["weight"][b, :ne] = rng.uniform(1.0, 50.0, ne)
    t = {k: torch.from_numpy(v).to(DEV) for k, v in a.items()}
    key = torch.where(t["delay"] > 0, t["delay"] * pb + t["post"],
                      (max_delay + 1) * pb)
    order = torch.sort(key, dim=1, stable=True).indices
    t = {k: torch.gather(v, 1, order) for k, v in t.items()}
    bg = BlockedGraph(nb=nb, eb=eb, pb=pb, n_local=n_local,
                      pre_idx=t["pre"], post_rel=t["post"],
                      delay=t["delay"], channel=t["channel"],
                      plastic=t["plastic"],
                      edge_perm=torch.arange(nb * eb, dtype=torch.int32,
                                             device=DEV).reshape(nb, eb),
                      weight=None)
    flat = lambda k: t[k].reshape(-1)
    return engine.ShardGraph(
        n_local=n_local, n_mirror=nb * pres_per_block, max_delay=max_delay,
        pre_idx=flat("pre"), post_idx=flat("post"), delay=flat("delay"),
        channel=flat("channel"), plastic=flat("plastic"),
        weight_init=flat("weight"), bucket_ptr=None, mirror_src_shard=None,
        mirror_src_idx=None, group_id=None, blocked=bg)


def phase_gate_activity(nb=64, pb=256, eb=196_608,
                        fracs=(1.0, 0.25, 0.0625, 0.03125)) -> None:
    """Dense against gated sweep + STDP where the gate has leverage, at the
    reference's active fractions (``bench_snn.py::bench_gate_activity``:
    ~3 % of an active area's neurons fire per step, 5 % of its post rows
    spike, capacity ~1.5x the active blocks, floor 2)."""
    t0 = time.perf_counter()
    g = area_localized_graph(nb, pb, eb)
    bg = g.blocked
    nb, pb, eb, d, m, n = bg.nb, bg.pb, bg.eb, g.max_delay, g.n_mirror, \
        g.n_local
    dense = backends.get_backend("cuda")
    ld = dense.prepare(g)
    w = g.weight_init
    params = models.HPC_STDP
    rng = np.random.default_rng(3)
    traces = stdp_mod_core.TraceState(
        k_pre=torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32)
                               ).to(DEV),
        k_post=torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)
                                ).to(DEV))
    t5 = torch.tensor(5, dtype=torch.int32, device=DEV)
    ppb = m // nb
    build_s = time.perf_counter() - t0
    rows = []
    for frac in fracs:
        n_act = max(int(np.ceil(frac * nb)), 1)
        act = rng.choice(nb, size=n_act, replace=False)
        pre_mask = np.zeros(m, np.float32)
        post_mask = np.zeros(n, np.float32)
        for b in act:
            pre_mask[b * ppb:(b + 1) * ppb] = 1.0
            post_mask[b * pb:min((b + 1) * pb, n)] = 1.0
        ring = torch.from_numpy((rng.uniform(size=(d, m)) < 0.03)
                                .astype(np.float32) * pre_mask).to(DEV)
        spk = torch.from_numpy((rng.uniform(size=n) < 0.05)
                               .astype(np.float32) * post_mask).to(DEV)
        cap_target = min(max(int(np.ceil(1.5 * frac * nb)), 2), nb)
        k = (nb * eb) / nb
        rate = float(1.0 - (1.0 - min(cap_target / nb, 1.0 - 1e-9))
                     ** (1.0 / k))
        gated = backends.CudaSparseBackend(gate_rate=max(rate, 1e-9),
                                           min_capacity=2)
        lg = gated.prepare(g)
        cap = gated.gate_capacity(lg)
        ex_d, in_d, ar_d = dense.sweep(ld, w, ring, t5)
        ex_s, in_s, ar_s, ovf = gated.sweep_with_stats(lg, w, ring, t5)
        _, n_active, _ = gated.gate_stats(lg, ring, t5)
        check(torch.equal(ex_d, ex_s) and torch.equal(in_d, in_s)
              and torch.equal(ar_d, ar_s),
              f"gate_activity {frac}: gated sweep differs from dense")
        w_d = dense.stdp_update(ld, w, ar_d, spk, traces, params)
        w_s = gated.stdp_update(lg, w.clone(), ar_s, spk, traces, params)
        check(torch.equal(w_d, w_s),
              f"gate_activity {frac}: gated STDP differs from dense")
        check(not torch.equal(w_d, w), f"gate_activity {frac}: STDP "
              "changed nothing - vacuous")
        # the oracle: blocks with a slot whose pre fired ``delay`` steps
        # ago (an active area may draw no spike at all)
        fired = ring[torch.remainder(5 - bg.delay.long(), d),
                     bg.pre_idx.long()] > 0
        want = int((fired & (bg.delay > 0)).any(dim=1).sum())
        n_active, ovf = int(n_active), int(ovf)
        check(n_active == want and 0 < want <= n_act and ovf == 0,
              f"gate_activity {frac}: n_active {n_active} (want {want} of "
              f"{n_act} active areas), overflow {ovf}")
        scratch = w.clone()
        ms = {}
        for name, be, lay in (("dense", dense, ld), ("gated", gated, lg)):
            sweep = lambda: be.sweep(lay, w, ring, t5)
            stdp_ = lambda: be.stdp_update(lay, scratch, ar_d, spk, traces,
                                           params)

            def both():
                arr = be.sweep(lay, w, ring, t5)[2]
                be.stdp_update(lay, scratch, arr, spk, traces, params)
            ms[name] = {"sweep": median_ms(sweep), "stdp": median_ms(stdp_),
                        "sweep_plus_stdp": median_ms(both)}
        rows.append(dict(active_fraction=frac, active_areas=n_act,
                         n_active=n_active,
                         capacity=cap, overflow=ovf, ms=ms,
                         gated_over_dense=ms["gated"]["sweep_plus_stdp"]
                         / ms["dense"]["sweep_plus_stdp"]))
    emit({"phase": "gate_activity", "nb": nb, "pb": pb, "eb": eb,
          "slots": nb * eb, "live_slots": int((bg.delay > 0).sum()),
          "n_local": n, "n_mirror": m, "max_delay": d,
          "host_build_s": build_s, "bitwise_equal": True,
          "fractions": rows})


# --------------------------------------------------------------------------
# phases 13-14: the LM face's serving path (K8)
# --------------------------------------------------------------------------

def _flash_work(b, s, t, h, hk, dh, dv, causal, dtype):
    """Bytes (each input read once, the output written once) and
    operations (both products over the unmasked pairs) of one call, as
    the dry run charges it (``utils.op_costs.flash_work``), and the rate
    of its dtype."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes, ops = op_costs.flash_work(b, s, t, h, hk, dh, dv, causal, size)
    return nbytes, ops, (BF16_OPS_PER_S if dtype == torch.bfloat16
                         else F32_OPS_PER_S)


def _sass_hgmma() -> int:
    """HGMMA instructions (``wgmma`` in SASS) in the built K8 library."""
    tool = next((c for c in (shutil.which("cuobjdump"),
                             "/usr/local/cuda/bin/cuobjdump")
                 if c and os.path.exists(c)), None)
    check(tool is not None, "cuobjdump not found")
    sass = subprocess.run(
        [tool, "--dump-sass", str(_build.BUILD_DIR / "libflash_attention.so")],
        capture_output=True, text=True, timeout=120, check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def phase_flash_kernels() -> dict:
    """K8 on every case of FLASH_CASES against its twin, each through the
    route its dtype must take; the prefill case's numbers go into the
    kernels line."""
    hgmma = _sass_hgmma()
    emit({"phase": "sass", "library": "build/libflash_attention.so",
          "hgmma_instructions": hgmma, "holds_hgmma": hgmma > 0})
    check(hgmma > 0, "K8's library holds no HGMMA instruction")
    rng = np.random.default_rng(SEED + 9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lines, out = {}, {}
    for name, (b, s, t, h, hk, dh, dv, causal, dtype) in FLASH_CASES.items():
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(DEV, dtype) for shape in
            ((b, s, h, dh), (b, t, hk, dh), (b, t, hk, dv)))
        route = fa_mod._route(q, k, v)
        check(route == FLASH_ROUTE[dtype], f"K8 ({name}) routed to {route}")
        before = dict(fa_mod.flash_attention.launches_by_route)
        k1 = fa_mod.flash_attention(q, k, v, causal=causal)
        k2 = fa_mod.flash_attention(q, k, v, causal=causal)
        check(fa_mod.flash_attention.launches_by_route[route]
              == before[route] + 2, f"K8 ({name}) did not launch {route}")
        pl = fa_mod.flash_attention_plain(q, k, v, causal=causal)
        check(torch.equal(k1, k2), f"K8 ({name}) not bitwise deterministic")
        check(k1.shape == (b, s, h * dv) and k1.dtype == dtype,
              f"K8 ({name}) returned {tuple(k1.shape)} {k1.dtype}")
        err = max_abs(k1, pl)
        check(torch.allclose(k1.float(), pl.float(), **FLASH_TOL[dtype]),
              f"K8 ({name}) differs from its twin by {err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_err = max_abs(lib().transpose(1, 2).reshape(b, s, h * dv), pl)
        k_ms = median_ms(lambda: fa_mod.flash_attention(q, k, v,
                                                        causal=causal))
        p_ms = median_ms(lambda: fa_mod.flash_attention_plain(
            q, k, v, causal=causal),
            reps=FLASH_LONG_REPS if s * t >= FLASH_LONG_PAIRS else 25)
        l_ms = median_ms(lib)
        nbytes, ops, rate = _flash_work(b, s, t, h, hk, dh, dv, causal,
                                        dtype)
        b_ms, b_by = bound(nbytes, ops, rate)
        lines[name] = dict(shape=dict(b=b, s=s, t=t, h=h, hk=hk, dh=dh,
                                      dv=dv, causal=causal,
                                      dtype=str(dtype)),
                           route=route,
                           max_abs_err=err, tolerance=FLASH_TOL[dtype],
                           kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                           library_max_abs_err=lib_err, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes, ops=ops,
                           kernel_over_library=k_ms / l_ms)
        if name == "qwen2.5-3b_prefill":
            out["flash_attention"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=l_ms, bytes=nbytes)
    emit({"phase": "kernel", "name": "flash_attention",
          "library": "torch.nn.functional.scaled_dot_product_attention "
                     "(is_causal, enable_gqa), timed only",
          "deterministic": True, "hgmma_instructions": hgmma,
          "cases": lines})
    return out


def _lm_profile(fn, n_steps: int = 1, cpu: bool = True) -> dict:
    """Device time of ``fn`` by kernel class (K8, GEMMs, the rest), kernel
    launches per step and the device's idle share over the window.  With
    ``cpu`` off the host's ops are not traced (the numbers read only the
    device's events): a window of 100 000 launches then costs seconds to
    reduce, not minutes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, launches = {}, 0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        by_name[ev.key] = by_name.get(ev.key, 0.0) + dt / 1e3
        launches += ev.count
    busy = sum(by_name.values())
    check(busy > 0, "lm profile: no device time traced")
    gemm_words = ("gemm", "xmma", "nvjet", "cutlass", "cublas", "splitk")
    classes = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for key, ms in by_name.items():
        low = key.lower()
        cls = ("flash_attention" if "flash_attention_kernel" in low
               else "gemm" if any(w in low for w in gemm_words) else "other")
        classes[cls] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": n_steps, "wall_ms": wall * 1e3, "device_ms": busy,
            "device_ms_by_class": classes,
            "device_idle_share": 1 - busy / (wall * 1e3),
            "launches_per_step": launches / n_steps,
            "top_kernels_ms": {k.replace("(anonymous namespace)::", "")[:70]:
                               v for k, v in top}}


@contextlib.contextmanager
def _k8_twin():
    """The model's attention through K8's plain twin while in use."""
    lm_attn.flash_attention = fa_mod.flash_attention_plain
    try:
        yield
    finally:
        lm_attn.flash_attention = fa_mod.flash_attention


def _clear_margin(ref, tol: float):
    """Rows whose top-2 logits are further apart than twice ``tol``: there
    two sides within ``tol`` of each other must pick the same token."""
    top2 = torch.topk(ref, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > 2 * tol


def phase_lm_serve() -> int:
    """qwen2.5-3b at full width and depth through ``BatchServer``; returns
    K8's launches in the counted wave."""
    cfg = lm_configs.get(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype)
          == (36, 2048, 16, 2, 128, 11008, 151_936, "bfloat16"),
          f"lm_serve: {LM_ARCH} is not the published config")
    m = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = m.init(SEED, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    srv = BatchServer(m, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      eos_id=-1, device=DEV)
    rng = np.random.default_rng(SEED + 11)
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in LM_PROMPT_LENS]
    srv.serve(reqs, max_new_tokens=2)          # warm: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, stats = srv.serve(reqs, max_new_tokens=LM_NEW_TOKENS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for k, c in launches.items():
        want = cfg.n_layers if k == "flash_attention" else 0
        check(c == want, f"lm_serve: {k} launched {c} times in one wave")
    check(all(len(o) == LM_NEW_TOKENS for o in outs)
          and stats.tokens_out == LM_SLOTS * LM_NEW_TOKENS,
          f"lm_serve: {stats.tokens_out} tokens out")
    again, _ = srv.serve(reqs, max_new_tokens=LM_NEW_TOKENS)
    check(again == outs, "lm_serve: a second wave gave other tokens")

    # the wave by hand: prefill counted alone, then the decode chain
    tokens = srv._pad_batch(reqs)
    cache = m.init_cache(LM_SLOTS, LM_MAX_LEN, dtype=torch.bfloat16,
                         device=DEV)
    fa_mod.flash_attention.launches = 0
    by_route = fa_mod.flash_attention.launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    logits, cache = m.prefill(params, {"tokens": tokens}, cache)
    check(fa_mod.flash_attention.launches == cfg.n_layers,
          f"lm_serve: prefill launched K8 "
          f"{fa_mod.flash_attention.launches} times")
    prefill_routes = dict(by_route)
    check(prefill_routes == {"wgmma": cfg.n_layers, "simt": 0},
          f"lm_serve: prefill took K8's routes {prefill_routes}")
    last = logits[:, -1]
    check(bool(torch.isfinite(last).all()), "lm_serve: prefill logits")
    with _k8_twin():
        plain_last = m.prefill(params, {"tokens": tokens}, m.init_cache(
            LM_SLOTS, LM_MAX_LEN, dtype=torch.bfloat16,
            device=DEV))[0][:, -1]
    swap_err = max_abs(last, plain_last)
    check(swap_err <= LM_LOGIT_ATOL, f"lm_serve: prefill logits with K8 "
          f"differ from the plain twin's by {swap_err}")
    clear = _clear_margin(plain_last, LM_LOGIT_ATOL)
    check(torch.equal(last.argmax(-1)[clear], plain_last.argmax(-1)[clear]),
          "lm_serve: K8 and its twin pick other tokens")
    tok = last.argmax(-1)
    pos = torch.full((LM_SLOTS,), tokens.shape[1], dtype=torch.int64,
                     device=DEV)
    fed, dec_logits = [], [last]
    fa_mod.flash_attention.launches = 0
    for i in range(LM_CHAIN):
        fed.append(tok)
        lg, cache = m.decode(params, cache, tok, pos + i)
        check(bool(torch.isfinite(lg).all()), "lm_serve: decode logits")
        dec_logits.append(lg)
        tok = lg.argmax(-1)
    check(fa_mod.flash_attention.launches == 0,
          "lm_serve: decode launched K8")
    check(torch.stack(fed + [tok], 1).tolist()
          == [o[:LM_CHAIN + 1] for o in outs], "lm_serve: the hand-driven "
          "chain left the served tokens")
    slot = LM_SLOTS - 1                          # the shortest prompt
    seq = torch.cat([tokens[slot], torch.stack(fed)[:, slot]])[None]
    s0 = tokens.shape[1] - 1
    hid = lm_tr.hidden_states(params, cfg, seq)[:, s0:s0 + LM_CHAIN + 1]
    fwd = lm_tr._unembed(params, cfg, hid)[0]    # (LM_CHAIN + 1, vocab)
    chain = torch.stack([x[slot] for x in dec_logits])
    chain_err = max_abs(chain, fwd)
    check(chain_err <= LM_LOGIT_ATOL, f"lm_serve: decode chain differs "
          f"from forward by {chain_err}")
    clear_f = _clear_margin(fwd, LM_LOGIT_ATOL)
    check(torch.equal(chain.argmax(-1)[clear_f], fwd.argmax(-1)[clear_f]),
          "lm_serve: decode chain and forward pick other tokens")

    # the same swap in fp32 at full depth: K8 and its twin then differ by
    # fp32 summation order alone, so a fault in K8 would show here above
    # bf16's rounding noise
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(cfg32)
    params32 = m32.init(SEED, device=DEV)
    with _k8_twin():
        want32 = m32.prefill(params32, {"tokens": tokens}, m32.init_cache(
            LM_SLOTS, LM_MAX_LEN, dtype=torch.float32, device=DEV))[0]
    got32 = m32.prefill(params32, {"tokens": tokens}, m32.init_cache(
        LM_SLOTS, LM_MAX_LEN, dtype=torch.float32, device=DEV))[0]
    swap_err32 = max_abs(got32, want32)
    check(swap_err32 <= LM_LOGIT_ATOL_F32, f"lm_serve: fp32 prefill logits "
          f"with K8 differ from the plain twin's by {swap_err32}")
    del m32, params32, got32, want32

    def decode_steps(n=4):
        t, c, p = last.argmax(-1), cache, pos + LM_CHAIN
        for i in range(n):
            lg, c = m.decode(params, c, t, p + i)
            t = lg.argmax(-1)
            t.cpu()
    prof_prefill = _lm_profile(lambda: m.prefill(params, {"tokens": tokens},
                                                 cache))
    prof_decode = _lm_profile(decode_steps, n_steps=4)
    n_pad = LM_SLOTS * tokens.shape[1]
    emit({"phase": "lm_serve", "arch": LM_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n_params,
          "weight_bytes": weight_bytes, "init_s": init_s,
          "slots": LM_SLOTS, "max_len": LM_MAX_LEN,
          "prompt_lens": list(LM_PROMPT_LENS), "new_tokens": LM_NEW_TOKENS,
          "launches": {k: v for k, v in launches.items() if v},
          "prefill_k8_routes": prefill_routes,
          "prefill_ms": stats.prefill_s * 1e3,
          "prefill_tok_per_s_padded": n_pad / stats.prefill_s,
          "prefill_tok_per_s_real": sum(LM_PROMPT_LENS) / stats.prefill_s,
          "decode_ms_per_step": stats.decode_s * 1e3 / LM_NEW_TOKENS,
          "decode_tok_per_s": stats.decode_tok_per_s,
          "peak_device_mem_bytes": peak,
          "k8_vs_twin_logits_max_abs_err": swap_err,
          "k8_vs_twin_rows_argmax_checked": int(clear.sum()),
          "k8_vs_twin_logits_max_abs_err_fp32": swap_err32,
          "logit_tolerance_fp32": LM_LOGIT_ATOL_F32,
          "chain_vs_forward_logits_max_abs_err": chain_err,
          "chain_vs_forward_positions_argmax_checked": int(clear_f.sum()),
          "logit_tolerance": LM_LOGIT_ATOL,
          "logit_abs_max": float(last.abs().max()),
          "logit_std": float(last.std()),
          "second_wave_identical": True,
          "first_tokens": [o[:8] for o in outs],
          "profile_prefill": prof_prefill, "profile_decode": prof_decode})
    return launches["flash_attention"]


# --------------------------------------------------------------------------
# phase 14b: the LM face's other families
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _moe_drops():
    """Yields a list that gathers the drop fraction of every ``moe_apply``
    call made while in use (the calls' results pass through)."""
    drops, inner = [], lm_moe.moe_apply

    def recording(*args, **kwargs):
        y, aux = inner(*args, **kwargs)
        drops.append(aux["drop_frac"])
        return y, aux
    lm_moe.moe_apply = recording
    try:
        yield drops
    finally:
        lm_moe.moe_apply = inner


@contextlib.contextmanager
def _moe_routes(replay=None):
    """Yields ``{"idx": [...], "moved": n}``: each MoE dispatch block's
    top-k experts, in call order.  With ``replay`` (such a list) every
    block takes the experts recorded for it instead of its own, gated by
    its own probabilities there, and ``moved`` counts the rows whose own
    top-k would have differed.  With the routes pinned, a comparison of
    two runs measures what differs between them and not the top-k's
    jumps: a hidden state one bf16 ulp away can pick another expert."""
    out, inner = {"idx": [], "moved": 0}, lm_moe._route
    pinned = iter(replay) if replay is not None else None

    def route(p, e, xt):
        probs, gate, idx = inner(p, e, xt)
        if pinned is not None:
            own, idx = idx, next(pinned)
            out["moved"] += int((own.sort(-1).values
                                 != idx.sort(-1).values).any(-1).sum())
            gate = probs.gather(-1, idx)
            gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
        out["idx"].append(idx)
        return probs, gate, idx
    lm_moe._route = route
    try:
        yield out
    finally:
        lm_moe._route = inner


def _reset_k8_routes() -> dict:
    by_route = fa_mod.flash_attention.launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    return by_route


def _family_batch(cfg, rng):
    """The lm_serve mix as one left-aligned padded batch (and the
    requests), with ``encoder_seq`` seeded frames for the audio stub."""
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in LM_PROMPT_LENS]
    toks = np.zeros((LM_SLOTS, max(LM_PROMPT_LENS)), np.int64)
    for i, r in enumerate(reqs):
        toks[i, :len(r)] = r
    batch = {"tokens": torch.from_numpy(toks).to(DEV)}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (LM_SLOTS, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)).to(DEV)
    return reqs, batch


def _serve_wave(arch, m, params, reqs, k8_prefill: int) -> dict:
    """Two ``BatchServer`` waves of the mix: K8 in the prefill only, the
    second wave's tokens identical; the wave's MoE drop fractions."""
    srv = BatchServer(m, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      eos_id=-1, device=DEV)
    srv.serve(reqs, max_new_tokens=2)          # warm: cuBLAS, allocator
    torch.cuda.synchronize()
    reset_launches()
    with _moe_drops() as drops:
        outs, stats = srv.serve(reqs, max_new_tokens=LM_NEW_TOKENS)
    launches = read_launches()
    check_launches(f"lm_families {arch} wave", launches,
                   {"flash_attention": k8_prefill})
    check(all(len(o) == LM_NEW_TOKENS for o in outs)
          and stats.tokens_out == LM_SLOTS * LM_NEW_TOKENS,
          f"lm_families {arch}: {stats.tokens_out} tokens out")
    again, _ = srv.serve(reqs, max_new_tokens=LM_NEW_TOKENS)
    check(again == outs, f"lm_families {arch}: a second wave gave other "
          "tokens")
    n_moe = sum(k[1] == "moe" for k in lm_tr.layer_kinds(m.cfg))
    return {"launches": launches, "served": {
        "prefill_ms": stats.prefill_s * 1e3,
        "decode_tok_per_s": stats.decode_tok_per_s,
        "prefill_drop_frac_per_moe_layer": [float(d) for d in drops[:n_moe]],
        "decode_drop_frac_max": max(float(d) for d in drops[n_moe:]),
        "second_wave_identical": True,
        "first_tokens": [o[:8] for o in outs]}}


def _chain_vs_forward(cfg, params, batch, atol: float = LM_LOGIT_ATOL,
                      gate: bool = True) -> dict:
    """A LM_CHAIN-step decode chain against the teacher-forced forward
    over every row's prompt + fed tokens, the whole batch at once (so the
    prompt positions take the prefill's own kernels, and the two part only
    at the decode steps), on a dropless copy of the config (a capacity
    factor of at least E / k, so that capacity covers every token, and at
    least the reference's 16); the forward takes the chain's MoE routes.
    At each position the chain must stay within ``atol`` of forward, or
    within LM_CHAIN_FLOOR_FACTOR times the distance between forward and
    the same forward run row by row, where that is larger: a network
    whose logits move by more than the tolerance under another rounding
    of its own forward cannot be held closer than that.  With ``gate``
    off the distances are measured and returned, not checked (the drop
    fraction is checked either way)."""
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=max(
                LM_DROPLESS_CF, cfg.moe.n_experts / cfg.moe.top_k)))
    m = build_model(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    pos = torch.full((b,), s, dtype=torch.int64, device=DEV)
    with _moe_drops() as drops, _moe_routes() as chain_routes:
        logits, cache = m.prefill(params, batch, m.init_cache(
            b, LM_MAX_LEN, dtype=getattr(torch, cfg.dtype), device=DEV))
        tok, fed, dec = logits[:, -1].argmax(-1), [], [logits[:, -1]]
        for i in range(LM_CHAIN):
            fed.append(tok)
            lg, cache = m.decode(params, cache, tok, pos + i)
            dec.append(lg)
            tok = lg.argmax(-1)
    # each row's routes: its prefill rows, then its row of each step
    idx = chain_routes["idx"]
    n_moe = len(idx) // (1 + LM_CHAIN)
    replay = [torch.cat([idx[j].reshape(b, s, -1)] + [
        idx[n_moe * (1 + i) + j][:, None] for i in range(LM_CHAIN)],
        dim=1).reshape(b * (s + LM_CHAIN), -1) for j in range(n_moe)]
    seq = torch.cat([tokens, torch.stack(fed, 1)], 1)

    def forward(rows, routes):
        """The teacher-forced logits at the chain's positions."""
        with _moe_routes(routes) as pinned:
            if cfg.family == "audio":
                out = lm_encdec.forward(params, cfg, seq[rows],
                                        batch["frames"][rows])[0][:, s - 1:]
            else:
                hid = lm_tr.hidden_states(params, cfg, seq[rows])[:, s - 1:]
                out = lm_tr._unembed(params, cfg, hid)
        return out, pinned["moved"]

    def row_routes(r):
        n = s + LM_CHAIN
        return [x[r * n:(r + 1) * n] for x in replay]

    with _moe_drops() as fwd_drops:
        fwd, moved = forward(slice(None), replay)
        # the same forward row by row: other GEMM shapes, so another
        # rounding of the same function; their distance is this
        # network's noise floor at these positions
        alone = torch.cat([forward(slice(r, r + 1), row_routes(r))[0]
                           for r in range(b)])
    chain = torch.stack(dec, 1)                  # (B, LM_CHAIN + 1, vocab)
    dist = lambda a, c: (a.double() - c.double()).abs().amax((0, 2))
    by_pos, floor = dist(chain, fwd), dist(alone, fwd)
    limit = torch.clamp_min(LM_CHAIN_FLOOR_FACTOR * floor, atol)
    clear = _clear_margin(fwd, float(limit.max()))
    if gate:
        check(bool((by_pos <= limit).all()), f"lm_families {cfg.name} "
              f"{cfg.dtype}: decode chain differs from forward by "
              f"{by_pos.tolist()}, limits {limit.tolist()}")
        check(torch.equal(chain.argmax(-1)[clear], fwd.argmax(-1)[clear]),
              f"lm_families {cfg.name} {cfg.dtype}: decode chain and "
              "forward pick other tokens")
    drop = max((float(d) for d in drops + fwd_drops), default=None)
    check(drop in (None, 0.0), f"lm_families {cfg.name}: the dropless "
          f"copy dropped {drop}")
    return {"dtype": cfg.dtype, "gated": gate,
            "chain_vs_forward_logits_max_abs_err": float(by_pos.max()),
            "chain_vs_forward_err_by_position": by_pos.tolist(),
            "forward_by_row_vs_batch_err_by_position": floor.tolist(),
            "chain_limit_by_position": limit.tolist(),
            "chain_vs_forward_positions_argmax_checked": int(clear.sum()),
            "chain_forward_route_rows_moved": moved if n_moe else None,
            "dropless_capacity_factor": (cfg.moe.capacity_factor
                                         if cfg.moe else None),
            "dropless_drop_frac": drop}


def lm_family(arch: str) -> dict:
    """One family of phase 14b; returns its kernel launches (the served
    wave's, else the counted prefill's and decode's)."""
    t_family = time.perf_counter()
    spec = LM_FAMILIES[arch]
    pub = lm_configs.get(arch)
    cfg = (pub if spec["layers"] is None
           else dataclasses.replace(pub, n_layers=spec["layers"]))
    check(cfg.dtype == "bfloat16" and cfg.moe == pub.moe,
          f"lm_families: {arch} is not at its published width")
    m = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = m.init(SEED, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 13)
    reqs, batch = _family_batch(cfg, rng)
    rec = {}
    if arch == LM_FAMILY_SERVED:
        rec = _serve_wave(arch, m, params, reqs, spec["k8_prefill"])

    # the wave by hand: the prefill counted alone, then the decode steps
    new_cache = lambda: m.init_cache(LM_SLOTS, LM_MAX_LEN,   # noqa: E731
                                     dtype=torch.bfloat16, device=DEV)
    cache = new_cache()
    m.prefill(params, batch, cache)            # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    by_route = _reset_k8_routes()
    t0 = time.perf_counter()
    logits, cache = m.prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches, prefill_routes = read_launches(), dict(by_route)
    k8 = spec["k8_prefill"]
    check_launches(f"lm_families {arch} prefill", prefill_launches,
                   {"flash_attention": k8})
    check(prefill_routes == {"wgmma": k8, "simt": 0},
          f"lm_families {arch}: prefill took K8's routes {prefill_routes}")
    last = logits[:, -1]
    check(bool(torch.isfinite(last).all()), f"lm_families {arch}: logits")
    pos = torch.full((LM_SLOTS,), batch["tokens"].shape[1],
                     dtype=torch.int64, device=DEV)
    reset_launches()
    _reset_k8_routes()
    tok = last.argmax(-1)
    t0 = time.perf_counter()
    for i in range(LM_NEW_TOKENS):
        lg, cache = m.decode(params, cache, tok, pos + i)
        tok = lg.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(lg).all()), f"lm_families {arch}: decode")
    decode_launches, decode_routes = read_launches(), dict(by_route)
    k8_dec = spec["k8_decode"] * LM_NEW_TOKENS
    check_launches(f"lm_families {arch} decode", decode_launches,
                   {"flash_attention": k8_dec})
    check(decode_routes == {"wgmma": k8_dec, "simt": 0},
          f"lm_families {arch}: decode took K8's routes {decode_routes}")

    if k8:           # K8 against its twin, in the same model
        with _moe_routes() as k8_routes:
            again = m.prefill(params, batch, new_cache())[0][:, -1]
        check(torch.equal(again, last),
              f"lm_families {arch}: the prefill is not deterministic")
        with _k8_twin(), _moe_routes(k8_routes["idx"]) as pinned:
            plain_last = m.prefill(params, batch, new_cache())[0][:, -1]
        swap_err = max_abs(last, plain_last)
        check(swap_err <= LM_LOGIT_ATOL, f"lm_families {arch}: prefill "
              f"logits with K8 differ from the twin's by {swap_err}")
        clear = _clear_margin(plain_last, LM_LOGIT_ATOL)
        check(torch.equal(last.argmax(-1)[clear],
                          plain_last.argmax(-1)[clear]),
              f"lm_families {arch}: K8 and its twin pick other tokens")
        rec.update(k8_vs_twin_logits_max_abs_err=swap_err,
                   k8_vs_twin_rows_argmax_checked=int(clear.sum()))
        if k8_routes["idx"]:   # the same swap with the twin's own routes
            with _k8_twin():
                free = m.prefill(params, batch, new_cache())[0][:, -1]
            rec.update(k8_vs_twin_route_rows_moved=pinned["moved"],
                       k8_vs_twin_unpinned_logits_max_abs_err=max_abs(
                           last, free))
    rec["chain"] = _chain_vs_forward(cfg, params, batch,
                                     gate=not spec.get("chain_fp32"))

    def decode_steps(n=4):
        t, c, p = last.argmax(-1), cache, pos + LM_NEW_TOKENS
        for i in range(n):
            lg, c = m.decode(params, c, t, p + i)
            t = lg.argmax(-1)
            t.cpu()
    prof_prefill = _lm_profile(lambda: m.prefill(params, batch, cache),
                               cpu=False)
    prof_decode = _lm_profile(decode_steps, n_steps=4, cpu=False)
    n_pad = LM_SLOTS * batch["tokens"].shape[1]
    launches = rec.pop("launches", None) or {
        k: prefill_launches[k] + decode_launches[k] for k in prefill_launches}
    rec.update(params=sum(p.numel() for p in params.parameters()),
               weight_bytes=sum(p.numel() * p.element_size()
                                for p in params.parameters()),
               logit_abs_max=float(last.abs().max()))
    del m, params, cache, logits, last, lg
    gc.collect()
    torch.cuda.empty_cache()
    if spec.get("chain_fp32"):
        # the decode path held where rounding is 2^16 finer: the same
        # arch and prompts in fp32, weights drawn anew from the seed
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params = build_model(cfg32).init(SEED, device=DEV)
        rec["chain_fp32"] = _chain_vs_forward(cfg32, params, batch,
                                              atol=LM_LOGIT_ATOL_F32)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "lm_families", "arch": arch, "layers": cfg.n_layers,
          "published_layers": pub.n_layers,
          "depth_cut": (None if cfg.n_layers == pub.n_layers else
                        f"{cfg.n_layers} of {pub.n_layers} layers: "
                        + spec.get("cut", "the published depth does not "
                                   "fit 80 GB")),
          "layer_kinds": sorted({"+".join(k) for k in
                                 lm_tr.layer_kinds(cfg)}) if
          cfg.family != "audio" else ["encoder", "decoder"],
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab_size,
          "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
          "mla": dataclasses.asdict(cfg.mla) if cfg.mla else None,
          "encoder_seq": cfg.encoder_seq or None, "init_s": init_s, "slots": LM_SLOTS, "max_len": LM_MAX_LEN,
          "prompt_lens": list(LM_PROMPT_LENS), "new_tokens": LM_NEW_TOKENS,
          "prefill_k8_launches": prefill_launches["flash_attention"],
          "prefill_k8_routes": prefill_routes,
          "decode_k8_launches_per_step":
              decode_launches["flash_attention"] / LM_NEW_TOKENS,
          "decode_k8_routes": decode_routes,
          "prefill_ms": prefill_s * 1e3,
          "prefill_tok_per_s_padded": n_pad / prefill_s,
          "prefill_tok_per_s_real": sum(LM_PROMPT_LENS) / prefill_s,
          "decode_ms_per_step": decode_s * 1e3 / LM_NEW_TOKENS,
          "decode_tok_per_s": LM_SLOTS * LM_NEW_TOKENS / decode_s,
          "peak_device_mem_bytes": peak, "logit_tolerance": LM_LOGIT_ATOL,
          "launches": {k: v for k, v in launches.items() if v}, **rec,
          "profile_prefill": prof_prefill, "profile_decode": prof_decode,
          "family_s": time.perf_counter() - t_family})
    return launches


def gemm_f32_check() -> None:
    """``bmm_f32`` and ``matmul_f32`` (cuBLAS with an fp32 output) at the
    expert shapes against an fp64 product: an fp32 reduction over K
    stays within K * 2^-24 of the scale sum |a| |b| (a split-K sum
    reduced in bf16 would reach 2^-9 of it)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rows = {}
    for arch, (m_, k_, n_, e) in GEMM_F32_CASES.items():
        a = torch.randn((e, m_, k_), generator=gen, device=DEV).to(
            torch.bfloat16)
        b = (torch.randn((e, k_, n_), generator=gen, device=DEV)
             / np.sqrt(k_)).to(torch.bfloat16)
        want = torch.bmm(a.double(), b.double())
        scale = float(torch.bmm(a.double().abs(), b.double().abs()).max())
        got = {"bmm_f32": bmm_f32(a, b), "matmul_f32": matmul_f32(a[0], b[0])}
        rel = {}
        for name, y in got.items():
            check(y.dtype == torch.float32, f"{name} returned {y.dtype}")
            rel[name] = max_abs(y, want if y.dim() == 3 else want[0]) / scale
        limit = k_ * 2.0 ** -24
        check(all(r <= limit for r in rel.values()),
              f"gemm_f32 {arch}: errors {rel} above the fp32 bound {limit}")
        rows[arch] = {"m": m_, "k": k_, "n": n_, "experts": e,
                      "max_abs_err_over_scale": rel, "fp32_bound": limit,
                      "scale": scale}
    emit({"phase": "gemm_f32", "reference": "torch.bmm in float64",
          "cases": rows})


def phase_lm_families() -> dict:
    """Phase 14b; returns each family's kernel launches."""
    out = {arch: lm_family(arch) for arch in LM_FAMILIES}
    gemm_f32_check()
    return out


# --------------------------------------------------------------------------
# phase 14c: LM training
# --------------------------------------------------------------------------

#: the fp32-output GEMMs' gradients against fp64: (M, K, N, experts) at
#: the lm_train cell's unembedding (B * S = 4096 rows, d 2048, the tied
#: vocab of 151 936, the table's transposed view) and at qwen3-moe's
#: expert GEMM (the served wave's capacity of 160 rows per expert)
TRAIN_GEMM_CASES = {"unembed": (4096, 2048, 151_936, None),
                    "qwen3-moe-30b-a3b_experts": (160, 2048, 768, 8)}
#: one step on the card against the port on the CPU from the same fp32
#: parameters: in fp32 the two differ by summation order (each leaf's
#: max |diff| within this share of its max |grad|); in bf16 every
#: activation rounds to 8 bits (the gradients' global relative L2)
TRAIN_CPU_TOL = {"float32": dict(loss_rtol=1e-5, leaf_rel=1e-4),
                 "bfloat16": dict(loss_rtol=1e-2, grad_rel_l2=5e-2)}
TRAIN_SMOKE_SEQ, TRAIN_SMOKE_BATCH = 64, 4
#: the lm_train cell: qwen2.5-3b at full width and depth through the
#: launcher, fp32 parameters and AdamW
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 10
#: qwen3-moe-30b-a3b at full width, cut to 4 of its 48 layers (80 GB
#: holds fp32 parameters, gradients and AdamW's two moments of about
#: 3.1 B parameters, not of 30.5 B)
TRAIN_MOE_ARCH, TRAIN_MOE_LAYERS, TRAIN_MOE_STEPS = "qwen3-moe-30b-a3b", 4, 5
#: the resume check: a smoke config whose backward sums by atomics on
#: CUDA unless deterministic (the embedding's gather and the MoE token
#: gather), run in deterministic mode
TRAIN_RESUME_ARCH = "qwen3-moe-30b-a3b"
TRAIN_RESUME_DIR = os.path.join(ROOT, "build", "lm_train_resume")


def _gemm_grads(name, m_, k_, n_, e, gen) -> dict:
    """One case of :func:`train_gemm_check`."""
    bf = torch.bfloat16
    if e is None:       # the tied unembedding: x @ table.t()
        a = torch.randn((m_, k_), generator=gen, device=DEV).to(bf)
        b = (torch.randn((n_, k_), generator=gen, device=DEV) * 0.02).to(bf)
        a.requires_grad_(True)
        b.requires_grad_(True)
        y = matmul_f32(a, b.t())
        mm = torch.mm
    else:
        a = torch.randn((e, m_, k_), generator=gen, device=DEV).to(bf)
        b = (torch.randn((e, k_, n_), generator=gen, device=DEV)
             / np.sqrt(k_)).to(bf)
        a.requires_grad_(True)
        b.requires_grad_(True)
        y = bmm_f32(a, b)
        mm = torch.bmm
    g = torch.randn(y.shape, generator=gen, device=DEV)
    ga, gb = torch.autograd.grad(y, (a, b), g)
    check(y.dtype == torch.float32 and ga.dtype == bf and gb.dtype == bf,
          f"lm_train gemm {name}: dtypes {y.dtype} {ga.dtype} {gb.dtype}")
    tr = lambda x: x.transpose(-1, -2)                  # noqa: E731
    a64, g64 = a.detach().double(), g.double()
    b64 = b.detach().double()
    if e is None:
        b64 = b64.t()                                   # (K, N)
        gb = gb.t()
    del g
    rows = {}
    # (got, fp64 product, its scale sum |x| |y|, reduction length, and
    # whether the result was rounded to bf16 after the fp32 sum)
    for what, got, x, w, red, rounded in (
            ("y", y.detach(), a64, b64, k_, False),
            ("grad_a", ga, g64, tr(b64), n_, True),
            ("grad_b", gb, tr(a64), g64, m_, True)):
        want = mm(x, w)
        scale = float(mm(x.abs(), w.abs()).max())
        err = (got.double() - want).abs()
        # the fp32 sum's bound, and for a gradient its one rounding to
        # bf16: half an ulp of the fp32 value, at most 2^-8 of it
        bound = red * 2.0 ** -24 * scale
        limit = (bound * (1 + 2.0 ** -8) + 2.0 ** -8 * want.abs()
                 if rounded else bound)
        ratio = float((err / limit).max())
        rows[what] = {"max_abs_err": float(err.max()), "scale": scale,
                      "fp32_bound": bound,
                      "bf16_rounding": rounded,
                      "max_err_over_limit": ratio}
        check(ratio <= 1.0, f"lm_train gemm {name} {what}: error "
              f"{float(err.max())} beyond its limit (ratio {ratio})")
        del want, err, limit
    return {"m": m_, "k": k_, "n": n_, "experts": e, **rows}


def train_gemm_check() -> dict:
    """(a) ``matmul_f32`` / ``bmm_f32`` differentiated on the card (bf16
    operands, the fp32-output GEMM through ``F32Product``): the product
    and both gradients against fp64."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    out = {name: _gemm_grads(name, *case, gen)
           for name, case in TRAIN_GEMM_CASES.items()}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _smoke_batch(cfg, step: int = 0) -> dict:
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SMOKE_SEQ,
                         global_batch=TRAIN_SMOKE_BATCH, seed=SEED)
    return launch_train.make_batch(cfg, pipe, step, DEV)


def train_vs_cpu(dtype: str) -> dict:
    """(b) qwen2.5-3b's smoke config computing in ``dtype``: one step's
    loss and gradients on the card against the port on the CPU from the
    same fp32 parameters (K8 never launched in the step), then a
    ``BatchServer`` wave of the same model (K8 once per layer in the
    prefill)."""
    cfg = dataclasses.replace(lm_configs.get_smoke(TRAIN_ARCH), dtype=dtype)
    m = build_model(cfg)
    host = m.init(SEED, device="cpu", dtype=torch.float32)
    params = m.init(SEED, device=DEV, dtype=torch.float32)
    params.load_state_dict(host.state_dict())
    batch = _smoke_batch(cfg)
    reset_launches()
    loss, met, grads = train_loop._value_and_grad(m, params, batch)
    torch.cuda.synchronize()
    check_launches(f"lm_train {dtype} step", read_launches(), {})
    c_loss, c_met, c_grads = train_loop._value_and_grad(
        m, host, {k: v.cpu() for k, v in batch.items()})
    tol = TRAIN_CPU_TOL[dtype]
    loss_rel = abs(float(loss) - float(c_loss)) / abs(float(c_loss))
    check(loss_rel <= tol["loss_rtol"], f"lm_train {dtype}: loss "
          f"{float(loss)} on the card, {float(c_loss)} on the CPU")
    leaf_rel = max(float((grads[k].cpu() - g).abs().max())
                   / float(g.abs().max()) for k, g in c_grads.items())
    num = sum(float(torch.sum((grads[k].cpu() - g) ** 2))
              for k, g in c_grads.items())
    den = sum(float(torch.sum(g ** 2)) for g in c_grads.values())
    rel_l2 = float(np.sqrt(num / den))
    if "leaf_rel" in tol:
        check(leaf_rel <= tol["leaf_rel"], f"lm_train {dtype}: a gradient "
              f"leaf differs from the CPU's by {leaf_rel} of its max")
    else:
        check(rel_l2 <= tol["grad_rel_l2"], f"lm_train {dtype}: gradients "
              f"differ from the CPU's by a relative L2 of {rel_l2}")
    srv = BatchServer(m, params, slots=2, max_len=32, eos_id=-1, device=DEV)
    by_route = _reset_k8_routes()
    reset_launches()
    outs, _ = srv.serve([[5, 6, 7], [8, 9]], max_new_tokens=4)
    serve_launches = read_launches()
    check_launches(f"lm_train {dtype} serve", serve_launches,
                   {"flash_attention": cfg.n_layers})
    return {"dtype": dtype, "loss_card": float(loss),
            "loss_cpu": float(c_loss), "loss_rel_err": loss_rel,
            "ce_card": float(met["ce"]),
            "grad_leaf_max_err_over_max": leaf_rel,
            "grad_rel_l2_err": rel_l2, "tolerance": tol,
            "step_k8_launches": 0,
            "serve_k8_launches": serve_launches["flash_attention"],
            "serve_k8_routes": dict(by_route),
            "served_tokens": outs}


def train_every_arch() -> dict:
    """(c) one AdamW step of every arch's smoke config on the card, in
    its fp32 and in bf16: a finite loss, a nonzero gradient norm, no K8;
    the step's peak memory (the recurrences save a state a time step)."""
    out = {}
    for arch in lm_configs.ARCH_NAMES:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(lm_configs.get_smoke(arch),
                                      dtype=dtype)
            m = build_model(cfg)
            tcfg = TrainConfig(lr=1e-3)
            params = m.init(SEED, device=DEV, dtype=torch.float32)
            opt = train_opt.init_opt_state(tcfg, train_loop.param_tree(
                params))
            step = train_loop.make_train_step(m, tcfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            params, opt, met = step(params, opt, _smoke_batch(cfg), 0)
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            check_launches(f"lm_train {arch} {dtype}", read_launches(), {})
            check(np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0,
                  f"lm_train {arch} {dtype}: loss {loss}, grad norm {gnorm}")
            out[f"{arch} {dtype}"] = {
                "loss": loss, "grad_norm": gnorm,
                "peak_device_mem_bytes": torch.cuda.max_memory_allocated()}
    return out


def train_cell() -> dict:
    """(d) the lm_train cell: ``launch/train.py --full`` for qwen2.5-3b at
    full width and depth, B 4, S 1024, 10 AdamW steps on fp32 parameters;
    the loss must fall.  Then one step profiled."""
    cfg = lm_configs.get(TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype)
          == (36, 2048, 151_936, "bfloat16"),
          f"lm_train: {TRAIN_ARCH} is not the published config")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = launch_train.main(["--arch", TRAIN_ARCH, "--full", "--steps",
                             str(TRAIN_STEPS), "--seq", str(TRAIN_SEQ),
                             "--batch", str(TRAIN_BATCH), "--device",
                             str(DEV)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("lm_train cell", read_launches(), {})
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"lm_train: the loss went from {losses[0]} to {losses[-1]}")
    steady = statistics.median(out["step_s"][1:])
    params, opt = out.pop("params"), out.pop("opt_state")
    n_params = sum(p.numel() for p in params.parameters())
    # one more step (the launcher's step 10) profiled, by kernel class
    step = train_loop.make_train_step(build_model(cfg), TrainConfig(lr=1e-3))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=0)
    batch = launch_train.make_batch(cfg, pipe, TRAIN_STEPS, DEV)
    prof = _lm_profile(lambda: step(params, opt, batch, TRAIN_STEPS),
                       cpu=False)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": TRAIN_ARCH, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "remat": cfg.remat, "compute_dtype": cfg.dtype,
            "param_dtype": "float32", "optimizer": "adamw", "lr": 1e-3,
            "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "loss_first": losses[0],
            "loss_last": losses[-1], "losses": losses,
            "grad_norms": out["grad_norms"], "step_s": out["step_s"],
            "s_per_step_median_after_first": steady,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
            "wall_s": wall, "peak_device_mem_bytes": peak,
            "profile_step": prof}


def train_moe_cell() -> dict:
    """(e) qwen3-moe-30b-a3b at full width cut to TRAIN_MOE_LAYERS layers:
    TRAIN_MOE_STEPS AdamW steps on fp32 parameters, B 4, S 1024."""
    pub = lm_configs.get(TRAIN_MOE_ARCH)
    cfg = dataclasses.replace(pub, n_layers=TRAIN_MOE_LAYERS)
    m = build_model(cfg)
    tcfg = TrainConfig(lr=1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = m.init(SEED, device=DEV, dtype=torch.float32)
    opt = train_opt.init_opt_state(tcfg, train_loop.param_tree(params))
    step = train_loop.make_train_step(m, tcfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=0)
    losses, step_s = [], []
    reset_launches()
    with _moe_drops() as drops:
        for i in range(TRAIN_MOE_STEPS):
            batch = launch_train.make_batch(cfg, pipe, i, DEV)
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch, i)
            losses.append(float(met["loss"]))
            step_s.append(time.perf_counter() - t0)
    check_launches("lm_train moe", read_launches(), {})
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"lm_train moe: losses {losses}")
    # each step's forward dispatches once a layer (a backward's
    # recomputation stops inside the dispatch, once its last saved tensor
    # is back, and records nothing)
    drop = [float(d) for d in drops]
    check(len(drop) == TRAIN_MOE_STEPS * cfg.n_layers,
          f"lm_train moe: {len(drop)} dispatches recorded")
    by_step = np.asarray(drop).reshape(TRAIN_MOE_STEPS, -1).mean(1)
    n_params = sum(p.numel() for p in params.parameters())
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    steady = statistics.median(step_s[1:])
    return {"arch": TRAIN_MOE_ARCH, "layers": cfg.n_layers,
            "published_layers": pub.n_layers,
            "depth_cut": f"{cfg.n_layers} of {pub.n_layers} layers: fp32 "
                         "parameters, gradients and AdamW moments of the "
                         "published depth do not fit 80 GB",
            "moe": dataclasses.asdict(cfg.moe), "remat": cfg.remat,
            "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "losses": losses, "step_s": step_s,
            "s_per_step_median_after_first": steady,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
            "peak_device_mem_bytes": peak,
            "drop_frac_mean": float(np.mean(drop)),
            "drop_frac_by_step": by_step.tolist()}


def _ckpt_arrays(directory: str, step: int) -> dict:
    """The arrays of checkpoint ``step`` by leaf key."""
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return {rec["key"]: np.load(os.path.join(d, rec["file"]))
            for rec in leaves}


def train_resume() -> dict:
    """(f) ``launch.train.main`` on the card in deterministic mode, in this
    process: 10 steps uninterrupted, and 5 steps, a resume and 5 more; the
    step-10 checkpoints (parameters and AdamW state) equal bitwise."""
    shutil.rmtree(TRAIN_RESUME_DIR, ignore_errors=True)
    dirs, logs = {}, {}
    t0 = time.perf_counter()
    with _deterministic():
        for leg, runs in (("uninterrupted", (["--steps", "10"],)),
                          ("resumed", (["--steps", "5"],
                                       ["--steps", "10", "--resume"]))):
            dirs[leg] = os.path.join(TRAIN_RESUME_DIR, leg)
            argv = ["--arch", TRAIN_RESUME_ARCH, "--seq",
                    str(TRAIN_SMOKE_SEQ), "--batch", str(TRAIN_SMOKE_BATCH),
                    "--save-every", "5", "--ckpt", dirs[leg], "--device",
                    str(DEV)]
            logs[leg] = "".join(_quiet(launch_train.main, argv + extra)[1]
                                for extra in runs)
    check("resumed @ 5" in logs["resumed"], "lm_train resume: the second "
          "run did not resume from step 5")
    a, b = (_ckpt_arrays(dirs[leg], 10) for leg in ("uninterrupted",
                                                       "resumed"))
    check(a.keys() == b.keys(), "lm_train resume: other checkpoint leaves")
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    check(not differ, f"lm_train resume: {len(differ)} leaves differ, "
          f"e.g. {differ[:3]}")
    return {"arch": TRAIN_RESUME_ARCH, "leaves": len(a),
            "bitwise_equal": True, "deterministic_algorithms": True,
            "wall_s": time.perf_counter() - t0}


def phase_lm_train() -> dict:
    """Phase 14c; returns K8's launches in each part (0 in every train
    step, one per layer in the serving waves)."""
    t_phase = time.perf_counter()
    gc.collect()                # the cell needs 62 of the card's 80 GB
    torch.cuda.empty_cache()
    rec = {"gemm_grads": train_gemm_check()}
    vs_cpu = {d: train_vs_cpu(d) for d in ("float32", "bfloat16")}
    rec["step_vs_cpu"] = vs_cpu
    rec["every_arch"] = train_every_arch()
    rec["cell"] = train_cell()
    rec["moe_cell"] = train_moe_cell()
    rec["resume"] = train_resume()
    emit({"phase": "lm_train", **rec,
          "phase_s": time.perf_counter() - t_phase})
    return {"train_steps": 0,
            **{f"serve {d}": r["serve_k8_launches"]
               for d, r in vs_cpu.items()}}


#: the lm_dryrun cell: one device's share of three 16x16 cells of
#: qwen2.5-3b at full width and depth (the dry run's per-device record)
DRYRUN_LM_ARCH = "qwen2.5-3b"
DRYRUN_LM_SHAPES = ("prefill_32k", "decode_32k", "train_4k")
#: the train share's depth: 80 GB does not hold fp32 parameters, their
#: gradients, the microbatch accumulator and AdamW's two moments of all
#: 36 layers with S 4 096's activations (the first call ran out at 74 GB
#: allocated), so width stays and depth is cut, on the card and on meta:
#: to 14 for the script's time (28, which 80 GB holds, took 41.6 s of the
#: phase)
DRYRUN_LM_TRAIN_LAYERS = 14
#: timed runs of a serving share (the train share's one step is timed once)
DRYRUN_LM_SERVE_RUNS = 3


def _first_diffs(a: dict, b: dict, n: int = 5) -> list:
    return [(k, a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
            if a.get(k) != b.get(k)][:n]


def lm_dryrun_share(shape_name: str) -> dict:
    """One device's share of ``shape_name`` (16x16 mesh): counted on
    ``meta`` by the dry run (by trip count), then built on the card from
    the seed, (b) timed without the counter with its peak memory, (a)
    counted under ``OpCounter``, which must equal the ``meta`` count op
    for op, (c) set against the roofline of its count, (d) K8's launches
    against the count's K8 calls."""
    pub = lm_configs.get(DRYRUN_LM_ARCH)
    shape = LM_SHAPES[shape_name]
    cfg = (dataclasses.replace(pub, n_layers=DRYRUN_LM_TRAIN_LAYERS)
           if shape.kind == "train" else pub)
    mesh = make_production_mesh()
    t0 = time.perf_counter()
    meta_ops, info = lm_dryrun.count_share(cfg, shape, mesh)
    meta_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cell = lm_dryrun.build_cell(cfg, shape, mesh, device=DEV, seed=SEED)
    runs = 1 if shape.kind == "train" else DRYRUN_LM_SERVE_RUNS
    reset_launches()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cell.run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    with op_costs.OpCounter() as counter:
        out = cell.run()
        torch.cuda.synchronize()
    card_ops = {k: list(v) for k, v in counter.by_op.items()}
    check(card_ops == meta_ops, f"lm_dryrun {shape_name}: the card's count "
          f"differs from meta's: {_first_diffs(card_ops, meta_ops)}")
    k8 = card_ops.get("repro_torch::flash_attention", [0, 0, 0])
    check_launches(f"lm_dryrun {shape_name}", launches,
                   {"flash_attention": runs * k8[0]})
    if shape.kind == "prefill":
        check(k8[0] == cfg.n_layers, f"lm_dryrun prefill: {k8[0]} K8 calls")
        logits = out[0]
        want = (cell.share_batch, 1, cfg.vocab_size)
    elif shape.kind == "decode":
        logits = out[0]
        want = (cell.share_batch, cfg.vocab_size)
    else:
        logits = torch.stack([out[2]["loss"], out[2]["grad_norm"]])
        want = (2,)
    check(tuple(logits.shape) == want
          and bool(torch.isfinite(logits).all()),
          f"lm_dryrun {shape_name}: output {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    flops = sum(v[1] for v in card_ops.values())
    nbytes = sum(v[2] for v in card_ops.values())
    bound_ms = max(flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    ms = statistics.median(times)
    rec = {"arch": DRYRUN_LM_ARCH, "mesh": "16x16", "shape": shape_name,
           "layers": cfg.n_layers, "published_layers": pub.n_layers,
           "batch_rows": cell.share_batch, "seq": shape.seq_len,
           "microbatches": cell.microbatches,
           "meta_count": info, "meta_count_s": meta_s,
           "ops": sum(v[0] for v in card_ops.values()),
           "counts_equal_op_for_op": True, "flops": flops, "bytes": nbytes,
           "flops_bound_ms": flops / BF16_OPS_PER_S * 1e3,
           "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_ms": bound_ms, "ms": ms, "ms_runs": times,
           "roofline_fraction": bound_ms / ms,
           "peak_device_mem_bytes": peak,
           "k8_calls": k8[0], "k8_launches": launches["flash_attention"],
           "k8_flops": k8[1], "k8_bytes": k8[2],
           "top_ops_by_bytes": dict(sorted(
               card_ops.items(), key=lambda kv: -kv[1][2])[:6])}
    del cell, out, logits
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_lm_dryrun() -> dict:
    """Phase 14d: the LM dry run's three qwen2.5-3b shares on the card;
    returns K8's launches in each."""
    t_phase = time.perf_counter()
    launches = {}
    for name in DRYRUN_LM_SHAPES:
        rec = lm_dryrun_share(name)
        emit({"phase": "lm_dryrun", "share": name, **rec})
        launches[name] = rec["k8_launches"]
    emit({"phase": "lm_dryrun", "phase_s": time.perf_counter() - t_phase})
    return launches


#: the lm_mesh cell (phase 14e): qwen3-moe-30b-a3b at published width on
#: a (2, 2) ("data", "model") mesh of four processes sharing the card
#: over gloo; its experts 4-way over ("model", "data"), 32 a process, its
#: dense leaves as their param_specs blocks (FSDP over data, TP over
#: model)
LM_MESH_ARCH = "qwen3-moe-30b-a3b"
LM_MESH_DIMS, LM_MESH_AXES = (2, 2), ("data", "model")
LM_MESH_RESTART_DIMS = (1, 2)
#: (a)/(b) depth: the fp32 leg's single-process run holds 2.5 GB of
#: embeddings and 2.5 GB a layer (fp32); 1 layer (2 until the
#: sequence-cut leg (h) and (e)'s batch-1 serves took 106 s of the
#: phase; 4 until the encoder-decoder leg (g) came, with the script at 17
#: min 15 s; 16 until the dense leg (d) took its time: every decode step
#: gathers the dense blocks over data through gloo's host route)
LM_MESH_LAYERS = 1
#: (c) depth: fp32 parameters, their gradients and AdamW's two moments
#: (4 x 4 bytes a parameter): one process holds 10 GB of embeddings and
#: 2.7 GB a layer, a mesh process its quarter of the dense leaves and of
#: the experts; 1 layer keeps the single-process run and the script's
#: time where they were
LM_MESH_TRAIN_LAYERS = 1
LM_MESH_BATCH, LM_MESH_SEQ, LM_MESH_DECODE = 4, 128, 4
LM_MESH_TRAIN_STEPS, LM_MESH_RESTART_STEPS = 3, 2
LM_MESH_LR = 1e-3
#: fp32 logits against the single-process run's, relative to their
#: largest magnitude; bf16 logits absolute (the families gate)
LM_MESH_F32_RTOL = 1e-3
#: train losses against one process: a mesh counts the load-balance loss
#: per token slice (the reference's moe_apply_manual), so the two part
#: by 0.01 x its difference, and bf16 GEMMs of other shapes round
#: otherwise: the first step (the same parameters and batch), and all
LM_MESH_TRAIN_FIRST_RTOL, LM_MESH_TRAIN_RTOL = 1e-2, 3e-2
#: the dense leg (d): qwen2.5-3b at published width, fp32 parameters and
#: bf16 compute, LM_MESH_DENSE_STEPS AdamW steps of B x S seeded tokens
#: on the (2, 2) mesh against one process at the same depth: 2 of 36
#: layers, 0.41 B parameters x 16 B (parameter, gradient, AdamW's m and
#: v) = 6.5 GB whole, a process its block; the depth is cut for the
#: script's time (all 36, 49.4 GB, ran at 14-18 s a step).  The serving
#: leg (h) runs LM_MESH_DENSE_LAYERS of the same arch
LM_MESH_DENSE_ARCH = "qwen2.5-3b"
LM_MESH_DENSE_TRAIN_LAYERS = 2
LM_MESH_DENSE_LAYERS = 12
LM_MESH_DENSE_BATCH, LM_MESH_DENSE_SEQ, LM_MESH_DENSE_STEPS = 4, 512, 3
#: (d)'s losses against one process: a mesh sums its bf16 products in
#: other groups (the row-parallel partials over model, the gradients'
#: bf16 parts over data): the first loss, and all three
LM_MESH_DENSE_FIRST_RTOL, LM_MESH_DENSE_RTOL = 1e-3, 1e-2
#: the training legs on the (2, 2) mesh against one process, each at its
#: published width, fp32 parameters and bf16 compute, LM_MESH_DENSE_STEPS
#: AdamW steps of B x S seeded tokens, gated as (d): (d) qwen2.5-3b at
#: LM_MESH_DENSE_TRAIN_LAYERS; (f) rwkv6-3b (d 2560, 40 heads of 64,
#: d_ff 8960, vocab 65536) at 1 of 32 layers: 0.42 B parameters x 16 B =
#: 6.8 GB whole, each process its FSDP x TP blocks, 20 heads a process
#: over model; cut for the script's time, as its recurrence steps one
#: token at a time under autograd (2 layers until the sequence-cut leg
#: (h) came; 8 layers took 20 s on the mesh and left the script at 17
#: min 17 s; 4 took 11.4 s, and the script 16-17.5 min with (a)/(b) at 4
#: layers).  (f) trains at lr 1e-5: its random weights
#: jump at LM_MESH_LR (``scripts/rwkv_mesh_probe.py lr``, one process at
#: 8 layers: losses 11.72, 24.67, 18.46 at 1e-3; 11.72, 15.49, 11.84,
#: 11.08 at 1e-4; 11.72, 8.72, 10.57, 8.52 at 3e-5), and after such a
#: jump the mesh and one process part by more than rounding moves a
#: descending run; at 1e-5 they descend (11.72, 10.65, 9.56, 9.01)
LM_MESH_TRAIN_LEGS = {
    "dense": dict(arch=LM_MESH_DENSE_ARCH, layers=LM_MESH_DENSE_TRAIN_LAYERS,
                  batch=LM_MESH_DENSE_BATCH, seq=LM_MESH_DENSE_SEQ),
    "rwkv": dict(arch="rwkv6-3b", layers=1, batch=4, seq=128, lr=1e-5),
}
#: the served families leg (e): each arch at its published width in bf16,
#: MoE dropless (``_family_cfg``), LM_MESH_BATCH x LM_MESH_SEQ seeded
#: prompts and ``decode`` decode tokens on the (2, 2) mesh against one
#: process at the same depth, the routes of the one-process run replayed
#: (as (a)), the logits within LM_LOGIT_ATOL or LM_CHAIN_FLOOR_FACTOR
#: times the one-process run's distance from itself run row by row
#: where that is larger (``_chain_vs_forward``'s rule: jamba's random
#: bf16 network moves its logits past 0.1 under another rounding);
#: K8's launches a process a prefill (its attention layers), on the
#: local heads.  jamba at 8 of 32 layers, one period (7 Mamba, 1 GQA
#: of 32 / 8 heads, 4 MoE layers of 16 experts, 4 a process); deepseek-v3
#: at 4 of 61 (3 dense MLA + MLP, then MLA + MoE of 256 experts and the
#: shared expert, 64 a process; 128 MLA heads, 64 a process), its
#: parameters drawn one process at a time (``in_turn``).  And
#: deepseek-v3's MLA in fp32, 1 dense layer (MLA + MLP: ``dense`` sets
#: the config's dense prefix, which it builds whatever ``n_layers``
#: says; its 3 until the encoder-decoder's batch-1 and (1, 4) legs took
#: the script's time, 65.5 s of the phase), a prefill: within
#: LM_MESH_F32_RTOL of one process's largest logit, as (a), so that a
#: wrong cut of the heads fails whatever bf16 rounding does (the bf16
#: prefill's distance read 0.69 in one card run and 0.042 in the next,
#: its decode steps bitwise the same in both: PERF.md §6)
#: Each cache is the reference's cache_specs layout: deepseek-v3's c_kv
#: and k_rope a block of the sequence over model (65 of 130 rows), and
#: the MLA decode the distributed softmax over it; its fp32 leg also
#: decodes 2 tokens.  ``b1``: on the same parameters, a batch-1 serve
#: under ``use_mesh(replicated_batch=True)`` (``seq_shard``): the first
#: prompt into a cache of ``b1`` rows, a prefill and ``decode`` decode
#: tokens against one process's (its routes replayed), gated as the leg
#: (fp32 within LM_MESH_F32_RTOL of one process's largest logit, bf16 by
#: the leg's limits by position): jamba's 524 288 rows (long_500k's; the
#: GQA layer's sequence over data, its 8 kv heads over model: a quarter
#: of 2.15 GB a process), deepseek-v3's 132 (c_kv and k_rope over
#: ("data", "model"): 33 rows a process)
LM_MESH_FAMILIES = {
    "jamba-v0.1-52b": dict(arch="jamba-v0.1-52b", layers=8, k8_prefill=1,
                           heads=16, dtype="bfloat16", decode=2,
                           in_turn=True, b1=524_288),
    "deepseek-v3-671b": dict(arch="deepseek-v3-671b", layers=4,
                             k8_prefill=4, heads=64, dtype="bfloat16",
                             decode=2, in_turn=True),
    "deepseek-v3-671b-fp32": dict(arch="deepseek-v3-671b", layers=1,
                                  dense=1, k8_prefill=1, heads=64,
                                  dtype="float32",
                                  decode=2, in_turn=False, b1=132),
}
#: the sequence-cut leg (h): qwen2.5-3b at published width,
#: LM_MESH_DENSE_LAYERS deep, on a (1, 4) mesh of four processes: its 2
#: kv heads do not divide model, so cache_specs cuts the cache's sequence
#: over model (every kv head, a quarter of the rows a process) and the
#: decode is the distributed softmax; the 16 query heads 4 a process.
#: fp32: LM_MESH_BATCH x LM_MESH_SEQ seeded prompts into ``rows`` = 136
#: (34 a block, so the prompt lies in all four blocks), ``decode`` = 4
#: steps, logits within LM_MESH_F32_RTOL of one process's largest; bf16:
#: the same prompts into decode_32k's 32 768 rows (0.40 GB a process of
#: 1.61 GB whole), 2 steps, logits within LM_LOGIT_ATOL; the decode's
#: peak memory rise over what was allocated before it below
#: LM_MESH_SEQCUT_RISE of the whole cache's bytes; K8 LM_MESH_DENSE_LAYERS
#: times a prefill on 4 of 16 heads, never in a decode step
LM_MESH_SEQCUT_DIMS = (1, 4)
LM_MESH_SEQCUT = {"float32": dict(rows=136, decode=4, heads=4),
                  "bfloat16": dict(rows=32_768, decode=2, heads=4)}
LM_MESH_SEQCUT_RISE = 0.05
#: the encoder-decoder leg (g): whisper-tiny at published width and depth
#: (4 + 4 layers, d 384, 6 heads, 3 a process over model, d_ff 1536, vocab
#: 51 865, which model cannot cut: the table is cut over data on d, the
#: tied unembedding whole over model; 1 500 frames) on the (2, 2) mesh
#: against one process: LM_MESH_BATCH x LM_MESH_SEQ seeded prompts and
#: seeded frames, a prefill and LM_MESH_ENCDEC_DECODE decode tokens, in
#: fp32 (within LM_MESH_F32_RTOL of one process's largest logit, as (a))
#: and bf16 (within LM_LOGIT_ATOL, or LM_CHAIN_FLOOR_FACTOR times one
#: process's distance from itself row by row, as (e)); K8's launches a
#: process pinned (LM_MESH_ENCDEC_K8: a prefill's 4 encoder, 4 causal
#: self and 4 cross-attentions, a decode token's 4 cross-attentions at
#: S = 1, each on 3 of the 6 heads); and LM_MESH_DENSE_STEPS AdamW steps
#: of fp32 parameters and bf16 compute on B x S seeded tokens and the
#: launcher's frames, gated as (d), with no K8 launch (the train route)
LM_MESH_ENCDEC_ARCH = "whisper-tiny"
LM_MESH_ENCDEC_DECODE = 2
LM_MESH_ENCDEC_K8 = {"prefill": 12, "decode": 4, "heads": 3, "train": 0}
#: (g)'s cache rows: the prompt and the decode tokens (130) rounded up to
#: a multiple of 4, so that every layout below cuts the rows as it cuts
#: the 1 500 frames
LM_MESH_ENCDEC_ROWS = 132
#: (g)'s served layouts, each against one process at its batch (fp32
#: within LM_MESH_F32_RTOL of the largest logit, bf16 within the b4
#: leg's limits by position): the spawn, the global batch, the spec every
#: ``self`` and ``cross_kv`` leaf carries (the reference's
#: ``cache_specs``; each a quarter of one process's cache), K8's
#: launches a decode token and its query heads a process (a prefill's
#: are LM_MESH_ENCDEC_K8's 12).  b4 on (2, 2): the kv heads over model,
#: the cross-attention on K8 at S = 1; b1 (``seq_shard``,
#: ``replicated_batch``): also the rows and frames over data, so the
#: decode's cross-attention is the distributed softmax in torch ops; m14
#: on (1, 4), where 6 heads do not divide 4: every head on a quarter of
#: the rows and frames, the cross-attention the distributed softmax
LM_MESH_ENCDEC_LAYOUTS = {
    "b4": dict(spawn="mesh", dims=(2, 2), batch=4,
               spec="P('data', None, 'model')", k8_decode=4, heads=3),
    "b1": dict(spawn="mesh", dims=(2, 2), batch=1,
               spec="P(None, 'data', 'model')", k8_decode=0, heads=3),
    "m14": dict(spawn="mesh14", dims=(1, 4), batch=4,
                spec="P('data', 'model')", k8_decode=0, heads=6),
}
#: the head-cut leg (i): rwkv6-3b at published width (d 2560, 40 heads of
#: 64, d_ff 8960, vocab 65 536), 1 of 32 layers, fp32 parameters and
#: compute, on a (1, 16) ("data", "model") mesh of sixteen processes
#: sharing the card: the reference's production model axis, and the one
#: mesh here on which param_specs cuts its heads inside a head (wr, wk, wv
#: and wg 160 of 2 560 columns a process, 2.5 heads; wo 160 rows), so that
#: every process gathers the four projections over model and runs all 40
#: heads (``models/rwkv.py``), and the state cache holds every head, whole
#: over model (cache_specs).  Against one process at the same depth: a
#: prefill of ``batch`` x ``seq`` seeded tokens and ``decode`` decode
#: tokens, logits within LM_MESH_F32_RTOL of one process's largest; one
#: AdamW step at the (f) leg's lr on ``batch`` x ``seq`` seeded tokens,
#: its loss and the loss after it within LM_MESH_HEADCUT_LOSS_RTOL
#: relative of one process's; every leaf its param_specs block and ``s``
#: whole; the cache's bytes a process against one process's (the same:
#: nothing of it is cut over model, and data is 1 wide); every
#: process's tally of the prefill, of each decode step and of the train
#: step equal to ``launch.dryrun.count_collectives`` of the same cell on
#: a (1, 16) stand-in, in calls, bytes and ring volume
LM_MESH_HEADCUT_DIMS = (1, 16)
LM_MESH_HEADCUT = dict(arch="rwkv6-3b", layers=1, batch=2, seq=32,
                       decode=2, heads=40, lr=LM_MESH_TRAIN_LEGS["rwkv"]["lr"])
LM_MESH_HEADCUT_LOSS_RTOL = 1e-5
LM_MESH_RS_REPS = 3
LM_MESH_A2A_REPS = 20
LM_MESH_DIR = os.path.join(ROOT, "build", "lm_mesh")
#: the fork server of the lm_mesh spawns (``_lm_mesh_spawn``): one
#: process that imports this module and torch._dynamo (which the train
#: steps' selective checkpointing imports at its first step) once, without
#: taking the card (``torch.cuda.is_available`` by NVML), and forks each
#: spawn's processes, each of which then takes the card and joins its
#: mesh.  A fresh process pays those imports itself, on the card's 8-core
#: host: torch and this module 8.5 s each with four at once and 20-23 s
#: with sixteen (``scripts/mesh_spawn_probe.py``), torch._dynamo 8.8 s
#: alone and 22 s each with sixteen (leg (i)'s ``dynamo_import_s``)
LM_MESH_FORK_SERVER = """
import importlib, json, os, sys, traceback
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
importlib.import_module("torch._dynamo")
if torch.cuda.is_initialized():
    sys.exit("lm_mesh fork server: the card was taken before the fork")
# its threads: its own, and NVML's from the availability check, which
# leaves the card untaken, so that forked processes take it themselves
print("ready", len(os.listdir("/proc/self/task")), flush=True)
for line in sys.stdin:
    req = json.loads(line)
    pids = []
    for r, log in enumerate(req["logs"]):
        pid = os.fork()
        if pid == 0:
            code = 1
            try:
                os.environ.update(req["env"], REPRO_PROC_ID=str(r))
                fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
                os.dup2(fd, 1)
                os.dup2(fd, 2)
                chip_smoke.lm_mesh_worker(req["job"])
                code = 0
            except BaseException:
                traceback.print_exc()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        pids.append(pid)
    print(json.dumps([os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1])
                      for pid in pids]), flush=True)
"""
#: the running fork server (``_lm_mesh_fork_server``): its process,
#: whether it has said it is ready, and the threads it then ran
_LM_MESH_FORKS = {}


def _lm_mesh_cfg(dtype: str, layers: int, cf: float | None = 16.0):
    pub = lm_configs.get(LM_MESH_ARCH)
    moe = pub.moe if cf is None else dataclasses.replace(
        pub.moe, capacity_factor=cf)
    return dataclasses.replace(pub, n_layers=layers, dtype=dtype, moe=moe)


def _lm_mesh_tokens(cfg):
    """The global prompts (B, S) and decode tokens (B, LM_MESH_DECODE)."""
    rng = np.random.default_rng(SEED)
    return (torch.from_numpy(rng.integers(1, cfg.vocab_size, (
        LM_MESH_BATCH, LM_MESH_SEQ))).to(DEV),
            torch.from_numpy(rng.integers(1, cfg.vocab_size, (
                LM_MESH_BATCH, LM_MESH_DECODE))).to(DEV))


def _block(t, mesh):
    return t if mesh is None else launch_train.batch_block(t, mesh)


@contextlib.contextmanager
def _mesh_routes(replay, mesh, t_loc: list, replicated: bool = False):
    """The manual dispatch's routes replaced by ``replay`` (the
    single-process run's, one (T, k) array a call): a process's slice
    takes the rows of its tokens (``t_loc[0]`` tokens in its block,
    ``d * t_loc + j`` globally; ``replicated``: every process the whole
    batch, sliced over ``("data", "model")``), its pad rows keep their
    own; ``moved`` counts the tokens whose own top-k set differs."""
    inner, calls = lm_moe_manual._route, iter(replay)
    out = {"moved": 0, "tokens": 0}
    batch_ax = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    d = mesh.axis_index(batch_ax)
    m = mesh.coords["model"]
    if replicated:
        d, m = 0, mesh.axis_index(("data", "model"))

    def route(router, e, x_slice):
        probs, gate, idx = inner(router, e, x_slice)
        want = next(calls).to(idx.device)
        t_s, n = x_slice.shape[0], t_loc[0]
        j = torch.arange(m * t_s, (m + 1) * t_s, device=idx.device)
        real = j < n
        rep = idx.clone()
        rep[real] = want[d * n + j[real]]
        out["moved"] += int((idx[real].sort(-1).values
                             != rep[real].sort(-1).values).any(-1).sum())
        out["tokens"] += int(real.sum())
        g = probs.gather(-1, rep)
        return probs, g / torch.clamp_min(g.sum(-1, keepdim=True),
                                          1e-9), rep
    lm_moe_manual._route = route
    try:
        yield out
    finally:
        lm_moe_manual._route = inner


def _init_in_turn(cfg, mesh):
    """``init_params`` on ``mesh``, one process at a time: each draws
    every piece whole (a layer, the embedding) and keeps its blocks, and
    deepseek-v3's MoE layer is 22.5 GB whole in bf16, which four
    processes at once would not hold beside their blocks."""
    params = None
    for r in range(mesh.size):
        if mesh.rank == r:
            params = lm_tr.init_params(cfg, SEED, device=DEV, mesh=mesh)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
        lm_coll.all_reduce_sum(torch.zeros((), device=DEV), mesh,
                               mesh.axis_names)
    return params


@contextlib.contextmanager
def _k8_heads():
    """Yields the query heads of each K8 call from the attention layers
    (the local heads on a tensor-parallel mesh)."""
    heads, inner = [], lm_attn.flash_attention

    def fa(q, k, v, **kw):
        heads.append(int(q.shape[2]))
        return inner(q, k, v, **kw)
    lm_attn.flash_attention = fa
    try:
        yield heads
    finally:
        lm_attn.flash_attention = inner


def _cache_record(cache) -> dict:
    """A cache's bytes, and the specs its GQA and MLA leaves carry (on a
    process mesh: ``rules.cache_blocks``' layout); a decoder's
    ``layers`` or the encoder-decoder's ``self`` and ``cross_kv``."""
    leaves = [(k, x) for part in cache.values() for c in part
              for k, x in c.items()]
    return {"cache_bytes": sum(x.numel() * x.element_size()
                               for _, x in leaves),
            "cache_specs": sorted({repr(lm_rules.spec_of(x)) for k, x in leaves
                                   if k in ("k", "v", "c_kv", "k_rope")})}


def _lm_mesh_b1(params, cfg, mesh, rows: int, n_decode: int,
                replay=None) -> dict:
    """(e)'s batch-1 serve (LM_MESH_FAMILIES' ``b1``): the first prompt
    into a cache of ``rows`` rows, a prefill and ``n_decode`` decode steps,
    on a mesh under ``use_mesh(replicated_batch=True)`` (``seq_shard``;
    the routes of ``replay`` taken) or in one process (its routes
    recorded); the logits (1 + n_decode, 1, V), K8's launches and heads,
    the cache's bytes and specs, seconds."""
    prompts, dec = (t[:1] for t in _lm_mesh_tokens(cfg))
    ctx = (lm_rules.use_mesh(mesh, replicated_batch=True) if mesh is not None
           else contextlib.nullcontext())
    t_loc = [LM_MESH_SEQ]
    routes = (_mesh_routes(replay, mesh, t_loc, replicated=True)
              if mesh is not None else _moe_routes())
    with ctx, routes as r, _k8_heads() as heads:
        cache = lm_tr.init_cache(cfg, 1, rows, getattr(torch, cfg.dtype),
                                 device=DEV)
        rec = _cache_record(cache)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm_tr.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
        rec.update(prefill_s=time.perf_counter() - t0,
                   k8_prefill=read_launches()["flash_attention"])
        out, t_dec = [logits[:, 0]], []
        t_loc[0] = 1
        for i in range(n_decode):
            pos = torch.full((1,), LM_MESH_SEQ + i, dtype=torch.int64,
                             device=DEV)
            t0 = time.perf_counter()
            lg, cache = lm_tr.decode_step(params, cfg, dec[:, i], pos, cache)
            torch.cuda.synchronize()
            t_dec.append(time.perf_counter() - t0)
            out.append(lg)
    rec.update(logits=torch.stack(out).float().cpu(), rows=rows,
               k8_heads=sorted(set(heads)), decode_step_s=t_dec)
    if mesh is None:
        rec["routes"] = [x.cpu() for x in r["idx"]]
    else:
        rec.update(routes_moved=r["moved"], routes_tokens=r["tokens"])
    del cache
    return rec


def lm_mesh_forward(dtype: str, mesh=None, replay=None, cfg=None,
                    n_decode: int = LM_MESH_DECODE, floor: bool = False,
                    in_turn: bool = False, b1: int | None = None,
                    replay_b1=None) -> dict:
    """(a), and (e) with ``cfg``: the prefill's last logits and each of
    ``n_decode`` decode steps', of the whole batch (``mesh`` None:
    recorded routes in ``routes``, and with ``floor`` the same logits
    with each row run alone in ``rows_alone`` and the prefill's probes,
    :func:`_prefill_probes`, in ``probes``) or of this process's block (the routes of
    ``replay`` taken; ``in_turn``: the parameters drawn one process at a
    time); K8's launches in the prefill and its query heads; the largest
    MoE drop fraction; the prefill's and each decode step's seconds; peak
    memory from the parameters on, the parameters' bytes, the cache's
    bytes and specs; with ``b1``, :func:`_lm_mesh_b1` on the same
    parameters into ``b1`` rows (the routes of ``replay_b1`` taken)."""
    cfg = cfg or _lm_mesh_cfg(dtype, LM_MESH_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = (_init_in_turn(cfg, mesh) if in_turn
              else lm_tr.init_params(cfg, SEED, device=DEV, mesh=mesh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prompts, dec = (_block(t, mesh) for t in _lm_mesh_tokens(cfg))
    b = prompts.shape[0]
    t_loc = [b * LM_MESH_SEQ]
    ctx = (lm_rules.use_mesh(mesh) if mesh is not None
           else contextlib.nullcontext())
    routes = (_mesh_routes(replay, mesh, t_loc) if mesh is not None
              else _moe_routes())
    with ctx, routes as r, _k8_heads() as heads, _moe_drops() as drops:
        # a mesh process's cache holds the heads and channels it runs
        cache = lm_tr.init_cache(cfg, b, LM_MESH_SEQ + n_decode,
                                 getattr(torch, dtype), device=DEV)
        cache_rec = _cache_record(cache)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm_tr.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        k8 = read_launches()["flash_attention"]
        out, t_dec = [logits[:, 0]], []
        t_loc[0] = b
        for i in range(n_decode):
            pos = torch.full((b,), LM_MESH_SEQ + i, dtype=torch.int64,
                             device=DEV)
            t0 = time.perf_counter()
            lg, cache = lm_tr.decode_step(params, cfg, dec[:, i], pos, cache)
            torch.cuda.synchronize()
            t_dec.append(time.perf_counter() - t0)
            out.append(lg)
    torch.cuda.synchronize()
    rec = {"logits": torch.stack(out).float().cpu(), "k8_prefill": k8,
           "k8_heads": sorted(set(heads)), "prefill_s": t_pre,
           "drop_frac_max": max((float(x) for x in drops), default=None),
           "prefill_tokens_per_s": b * LM_MESH_SEQ / t_pre,
           "decode_step_s": t_dec,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "peak_device_mem_bytes": torch.cuda.max_memory_allocated(),
           **cache_rec}
    del cache
    if mesh is None:
        rec["routes"] = [x.cpu() for x in r["idx"]]
        if floor:
            rec["rows_alone"] = _rows_alone(params, cfg, prompts, dec,
                                            n_decode, r["idx"])
            rec["probes"] = _prefill_probes(params, cfg, prompts, r["idx"])
    else:
        rec.update(routes_moved=r["moved"], routes_tokens=r["tokens"])
    if b1:
        rec["b1"] = _lm_mesh_b1(params, cfg, mesh, b1, n_decode, replay_b1)
    del params
    return rec


def _seqcut_cfg(dtype: str):
    return dataclasses.replace(lm_configs.get(LM_MESH_DENSE_ARCH),
                               n_layers=LM_MESH_DENSE_LAYERS, dtype=dtype)


def lm_mesh_seqcut(dtype: str, mesh=None) -> dict:
    """(h): qwen2.5-3b (``_seqcut_cfg``) serving LM_MESH_BATCH x
    LM_MESH_SEQ seeded prompts into LM_MESH_SEQCUT[dtype]'s rows and
    decode steps, in one process or on ``mesh``'s (1, 4) (this process's
    block of the cache: every kv head, a quarter of the sequence): the
    logits, K8's launches (prefill, decode) and heads, the cache's bytes
    and specs, the collectives tally of the prefill and of each decode
    step, the prefill's and each decode step's seconds, the peak
    memory from the parameters on, the memory allocated before the
    decode and the decode's peak over it."""
    cfg = _seqcut_cfg(dtype)
    spec = LM_MESH_SEQCUT[dtype]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm_tr.init_params(cfg, SEED, device=DEV, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prompts, dec = (_block(t, mesh) for t in _lm_mesh_tokens(cfg))
    b = prompts.shape[0]
    ctx = (lm_rules.use_mesh(mesh) if mesh is not None
           else contextlib.nullcontext())
    with ctx, _k8_heads() as heads:
        cache = lm_tr.init_cache(cfg, b, spec["rows"], getattr(torch, dtype),
                                 device=DEV)
        rec = _cache_record(cache)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with lm_coll.tally() as tl:
            logits, cache = lm_tr.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
        rec["tally_prefill"] = tl.record()
        k8 = read_launches()["flash_attention"]
        peak_pre = torch.cuda.max_memory_allocated()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, t_dec, tallies = [logits[:, 0]], [], []
        for i in range(spec["decode"]):
            pos = torch.full((b,), LM_MESH_SEQ + i, dtype=torch.int64,
                             device=DEV)
            t0 = time.perf_counter()
            with lm_coll.tally() as tl:
                lg, cache = lm_tr.decode_step(params, cfg, dec[:, i], pos,
                                              cache)
            torch.cuda.synchronize()
            t_dec.append(time.perf_counter() - t0)
            tallies.append(tl.record())
            out.append(lg)
        rec["tally_decode"] = tallies
        peak_dec = torch.cuda.max_memory_allocated()
    rec.update(logits=torch.stack(out).float().cpu(), k8_prefill=k8,
               k8_decode=read_launches()["flash_attention"] - k8,
               k8_heads=sorted(set(heads)), decode_step_s=t_dec,
               mem_before_decode_bytes=before,
               decode_peak_rise_bytes=peak_dec - before,
               peak_device_mem_bytes=max(peak_pre, peak_dec),
               param_bytes=sum(p.numel() * p.element_size()
                               for p in params.parameters()))
    del params, cache
    return rec


def _rows_alone(params, cfg, prompts, dec, n_decode, routes):
    """The logits of :func:`lm_mesh_forward`'s one-process run with each
    row run alone (the batch run's routes taken): other GEMM shapes, so
    another rounding of the same function, whose distance from the
    batch run is this network's noise floor (the rule of
    ``_chain_vs_forward``)."""
    b, s = prompts.shape
    out = []
    for i in range(b):
        rows = [x[i * s:(i + 1) * s] if x.shape[0] == b * s else x[i:i + 1]
                for x in routes]
        with _moe_routes(rows):
            cache = lm_tr.init_cache(cfg, 1, s + n_decode,
                                     getattr(torch, cfg.dtype), device=DEV)
            lg, cache = lm_tr.prefill(params, cfg, prompts[i:i + 1], cache)
            row = [lg[:, 0]]
            for j in range(n_decode):
                pos = torch.full((1,), s + j, dtype=torch.int64, device=DEV)
                lg, cache = lm_tr.decode_step(params, cfg, dec[i:i + 1, j],
                                              pos, cache)
                row.append(lg)
        out.append(torch.stack(row).float().cpu())
    return torch.cat(out, dim=1)


def _prefill_probes(params, cfg, prompts, routes):
    """The one-process prefill of :func:`lm_mesh_forward` (its routes
    taken) three times more, each's last logits: ``again`` as it ran (is
    it deterministic), ``twin`` with K8's twin in its place, ``cf16`` at
    LM_DROPLESS_CF (dropless only where E / k <= 16; deepseek-v3's 256 /
    8 is 32) with its largest drop fraction."""
    b, s = prompts.shape
    pre = [x for x in routes if x.shape[0] == b * s]
    cf16 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=LM_DROPLESS_CF))
    out = {}
    for name, c, swap in (("again", cfg, contextlib.nullcontext()),
                          ("twin", cfg, _k8_twin()),
                          ("cf16", cf16, contextlib.nullcontext())):
        with swap, _moe_routes(pre), _moe_drops() as drops:
            cache = lm_tr.init_cache(c, b, s, getattr(torch, c.dtype),
                                     device=DEV)
            lg, _ = lm_tr.prefill(params, c, prompts, cache)
        out[name] = lg[:, 0].float().cpu()
        if name == "cf16":
            out["cf16_drop_frac_max"] = max(float(x) for x in drops)
    return out


def _family_cfg(leg: str):
    """(e)'s config of LM_MESH_FAMILIES' ``leg``: its arch published, cut
    to its depth (and its dense prefix to ``dense`` layers where the leg
    names it), in its dtype, MoE dropless (``_chain_vs_forward``'s
    capacity factor: at least E / k, so that capacity covers every token,
    and at least LM_DROPLESS_CF)."""
    spec = LM_MESH_FAMILIES[leg]
    pub = lm_configs.get(spec["arch"])
    dense = ({"dense_first_n": spec["dense"]} if "dense" in spec else {})
    return dataclasses.replace(
        pub, n_layers=spec["layers"], dtype=spec["dtype"],
        moe=dataclasses.replace(pub.moe, capacity_factor=max(
            LM_DROPLESS_CF, pub.moe.n_experts / pub.moe.top_k), **dense))


def lm_mesh_published(mesh) -> dict:
    """(b): the published capacity factor on the mesh (bf16, routes its
    own): the drop fraction, prefill and decode tokens/s of this process,
    and one ``all_to_all`` of the prefill's dispatch buffer alone."""
    cfg = _lm_mesh_cfg("bfloat16", LM_MESH_LAYERS, cf=None)
    e = cfg.moe
    gc.collect()
    torch.cuda.empty_cache()
    params = lm_tr.init_params(cfg, SEED, device=DEV, mesh=mesh)
    prompts, dec = (_block(t, mesh) for t in _lm_mesh_tokens(cfg))
    b = prompts.shape[0]
    rec = {"capacity_factor": e.capacity_factor}
    with lm_rules.use_mesh(mesh), _moe_drops() as drops:
        for rep in range(2):          # the second one timed
            cache = lm_tr.init_cache(cfg, b, LM_MESH_SEQ + LM_MESH_DECODE,
                                     torch.bfloat16, device=DEV)
            drops.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_tr.prefill(params, cfg, prompts, cache)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            pre_drops = [float(x) for x in drops]
            t0 = time.perf_counter()
            for i in range(LM_MESH_DECODE):
                pos = torch.full((b,), LM_MESH_SEQ + i, dtype=torch.int64,
                                 device=DEV)
                lm_tr.decode_step(params, cfg, dec[:, i], pos, cache)
            torch.cuda.synchronize()
            t_dec = (time.perf_counter() - t0) / LM_MESH_DECODE
    rec.update(prefill_s=t_pre, prefill_tokens_per_s=b * LM_MESH_SEQ / t_pre,
               decode_step_s=t_dec, decode_tokens_per_s=b / t_dec,
               prefill_drop_frac_mean=float(np.mean(pre_drops)),
               decode_drop_frac_mean=float(np.mean(
                   [float(x) for x in drops[len(pre_drops):]])))
    del params
    # the dispatch buffer of one prefill layer: (E, cap, d) over the
    # expert axes, from this process's token slice
    exp_ax = lm_rules.expert_axes_for(mesh, e.n_experts)
    t_s = b * LM_MESH_SEQ // mesh.axis_size(("model",))
    cap = max(4, int(np.ceil(t_s * e.top_k / e.n_experts
                             * e.capacity_factor)))
    send = torch.randn((e.n_experts, cap, cfg.d_model), device=DEV).to(
        torch.bfloat16)
    for _ in range(3):
        lm_coll.all_to_all(send, mesh, exp_ax)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LM_MESH_A2A_REPS):
        lm_coll.all_to_all(send, mesh, exp_ax)
    end.record()
    torch.cuda.synchronize()
    rec.update(a2a_ms=start.elapsed_time(end) / LM_MESH_A2A_REPS,
               a2a_bytes=send.numel() * send.element_size(),
               a2a_shape=list(send.shape), a2a_route=lm_coll.route(mesh, send),
               a2a_axes=list(exp_ax))
    return rec


def _mesh_mean(t, mesh):
    if mesh is None:
        return float(t)
    batch_ax = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return float(lm_coll.all_reduce_sum(t.detach(), mesh, batch_ax)
                 / mesh.axis_size(batch_ax))


def _train_batch(cfg, step: int, mesh):
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=LM_MESH_SEQ,
                         global_batch=LM_MESH_BATCH, seed=SEED)
    return {"tokens": _block(torch.as_tensor(pipe.batch(step)["tokens"],
                                             device=DEV), mesh)}


def lm_mesh_train(mesh=None) -> dict:
    """(c): LM_MESH_TRAIN_STEPS AdamW steps, the checkpoint (on a mesh:
    global leaves, written by process 0), one Adafactor step and the loss
    after it."""
    cfg = _lm_mesh_cfg("bfloat16", LM_MESH_TRAIN_LAYERS)
    m = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = m.init(SEED, device=DEV, dtype=torch.float32, mesh=mesh)
    tcfg = TrainConfig(lr=LM_MESH_LR)
    opt = train_opt.init_opt_state(tcfg, params)
    step = train_loop.make_train_step(m, tcfg)
    ctx = (lm_rules.use_mesh(mesh) if mesh is not None
           else contextlib.nullcontext())
    losses, ce, step_s = [], [], []
    with ctx:
        for i in range(LM_MESH_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, _train_batch(cfg, i, mesh),
                                    i)
            losses.append(float(met["loss"]))
            ce.append(float(met["ce"]))
            step_s.append(time.perf_counter() - t0)
        rec = {"losses": losses, "ce": ce, "step_s": step_s}
        if mesh is not None:
            t0 = time.perf_counter()
            state = lm_convert.mesh_global(
                (train_loop.param_tree(params), opt), mesh,
                cfg.moe.n_experts, 0)
            if mesh.rank == 0:
                shutil.rmtree(os.path.join(LM_MESH_DIR, "ckpt"),
                              ignore_errors=True)
                mgr = CheckpointManager(os.path.join(LM_MESH_DIR, "ckpt"))
                mgr.save(LM_MESH_TRAIN_STEPS, state,
                         metadata={"step": LM_MESH_TRAIN_STEPS})
                rec["ckpt_bytes"] = mgr.timings[-1]["bytes"]
            del state
            lm_coll.all_reduce_sum(torch.zeros((), device=DEV), mesh,
                                   mesh.axis_names)    # the save is done
            rec["ckpt_s"] = time.perf_counter() - t0
        del opt
        af = TrainConfig(optimizer="adafactor", lr=LM_MESH_LR)
        opt = train_opt.init_opt_state(af, params)
        i = LM_MESH_TRAIN_STEPS
        params, opt, met = train_loop.make_train_step(m, af)(
            params, opt, _train_batch(cfg, i, mesh), i)
        rec["adafactor_loss"] = float(met["loss"])
        with torch.no_grad():
            loss, _ = m.loss(params, _train_batch(cfg, i + 1, mesh))
        rec["loss_after_adafactor"] = _mesh_mean(loss, mesh)
    rec["peak_device_mem_bytes"] = torch.cuda.max_memory_allocated()
    del params, opt
    return rec


def lm_mesh_restart(mesh=None) -> dict:
    """(c): the step-3 checkpoint restored (on a mesh: cut for it) and
    LM_MESH_RESTART_STEPS more AdamW steps."""
    cfg = _lm_mesh_cfg("bfloat16", LM_MESH_TRAIN_LAYERS)
    m = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm_tr.DecoderLM(cfg, device=DEV, dtype=torch.float32,
                             mesh=mesh)
    tcfg = TrainConfig(lr=LM_MESH_LR)
    target = (train_loop.param_tree(params),
              train_opt.init_opt_state(tcfg, params))
    sh = None
    if mesh is not None:
        sh = lm_rules.tree_map_with_path(
            lambda _, sp: lm_rules.NamedSharding(mesh, sp),
            lm_rules.local_specs(mesh, target, cfg.moe.n_experts))
    t0 = time.perf_counter()
    (tree, opt), meta = CheckpointManager(os.path.join(
        LM_MESH_DIR, "ckpt")).restore(target, shardings=sh)
    restore_s = time.perf_counter() - t0
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(tree[name])
    del tree, target
    step = train_loop.make_train_step(m, tcfg)
    ctx = (lm_rules.use_mesh(mesh) if mesh is not None
           else contextlib.nullcontext())
    losses = []
    with ctx:
        for i in range(meta["step"], meta["step"] + LM_MESH_RESTART_STEPS):
            params, opt, met = step(params, opt, _train_batch(cfg, i, mesh),
                                    i)
            losses.append(float(met["loss"]))
    rec = {"start": meta["step"], "losses": losses, "restore_s": restore_s,
           "peak_device_mem_bytes": torch.cuda.max_memory_allocated()}
    del params, opt
    return rec


def lm_mesh_dense(mesh=None, leg: str = "dense") -> dict:
    """A training leg of LM_MESH_TRAIN_LEGS ((d) qwen2.5-3b, (f)
    rwkv6-3b) at published width, fp32 parameters with bf16 compute,
    LM_MESH_DENSE_STEPS AdamW steps on seeded tokens; on a mesh each
    process holds its blocks of every leaf, and in (d) one reduce-scatter
    of the largest leaf's gradient (the embedding table's, over data, as
    its gather's backward runs it) is timed alone by CUDA events."""
    spec = LM_MESH_TRAIN_LEGS[leg]
    cfg = dataclasses.replace(lm_configs.get(spec["arch"]),
                              n_layers=spec["layers"])
    m = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = m.init(SEED, device=DEV, dtype=torch.float32, mesh=mesh)
    tcfg = TrainConfig(lr=spec.get("lr", LM_MESH_LR))
    opt = train_opt.init_opt_state(tcfg, params)
    torch.cuda.synchronize()
    rec = {"init_s": time.perf_counter() - t0,
           "param_bytes_per_process": sum(
               p.numel() * p.element_size() for p in params.parameters())}
    step = train_loop.make_train_step(m, tcfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                         global_batch=spec["batch"], seed=SEED)
    ctx = (lm_rules.use_mesh(mesh) if mesh is not None
           else contextlib.nullcontext())
    losses, gnorms, step_s = [], [], []
    with ctx:
        for i in range(LM_MESH_DENSE_STEPS):
            batch = {"tokens": _block(torch.as_tensor(
                pipe.batch(i)["tokens"], device=DEV), mesh)}
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch, i)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            step_s.append(time.perf_counter() - t0)
    rec.update(losses=losses, grad_norms=gnorms, step_s=step_s,
               peak_device_mem_bytes=torch.cuda.max_memory_allocated())
    if leg != "dense":
        del params, opt
        return rec
    table = params.embed.table
    rec["largest_leaf"] = {"name": "embed.table",
                           "global_shape": list(lm_rules.global_shape(table)),
                           "block_shape": list(table.shape),
                           "spec": repr(lm_rules.spec_of(table))}
    rows, cols = table.shape
    del params, opt, table
    gc.collect()
    torch.cuda.empty_cache()
    if mesh is not None:
        # the cotangent of the table gathered over data: (V / model, d)
        # in the compute dtype, reduce-scattered on d
        g = torch.randn((rows, cols * mesh.shape["data"]),
                        device=DEV).to(torch.bfloat16)
        lm_coll.reduce_scatter_sum(g, mesh, ("data",), 1)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LM_MESH_RS_REPS):
            lm_coll.reduce_scatter_sum(g, mesh, ("data",), 1)
        end.record()
        torch.cuda.synchronize()
        rec["reduce_scatter"] = {
            "ms": start.elapsed_time(end) / LM_MESH_RS_REPS,
            "bytes": g.numel() * g.element_size(), "shape": list(g.shape),
            "dtype": "bfloat16", "axes": ["data"],
            "route": lm_coll.route(mesh, g)}
        del g
    return rec


def _encdec_inputs(cfg):
    """(g)'s global prompts (B, S), frames (B, encoder_seq, d) and decode
    tokens (B, LM_MESH_ENCDEC_DECODE), seeded."""
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(1, cfg.vocab_size, (LM_MESH_BATCH, LM_MESH_SEQ))
    frames = rng.standard_normal((LM_MESH_BATCH, cfg.encoder_seq,
                                  cfg.d_model)).astype(np.float32)
    dec = rng.integers(1, cfg.vocab_size,
                       (LM_MESH_BATCH, LM_MESH_ENCDEC_DECODE))
    return tuple(torch.from_numpy(a).to(DEV) for a in (prompts, frames, dec))


def _encdec_serve(m, params, prompts, frames, dec) -> dict:
    """A prefill of ``prompts`` and ``frames`` into a cache of
    LM_MESH_ENCDEC_ROWS rows and a decode step of each column of ``dec``:
    the logits (1 + decode, B, V), K8's launches, the seconds and the
    collectives tally (``collectives.tally``) of the prefill and of each
    decode step, and the cache's bytes and specs."""
    b, s = prompts.shape
    cache = m.init_cache(b, LM_MESH_ENCDEC_ROWS, getattr(torch, m.cfg.dtype),
                         device=DEV)
    rec = _cache_record(cache)
    out, k8, secs, tallies = [], [], [], []
    for i in range(1 + dec.shape[1]):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with lm_coll.tally() as tl:
            if i == 0:
                lg, cache = m.prefill(params, {"tokens": prompts,
                                               "frames": frames}, cache)
                lg = lg[:, 0]
            else:
                lg, cache = m.decode(params, cache, dec[:, i - 1], torch.full(
                    (b,), s + i - 1, dtype=torch.int64, device=DEV))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out.append(lg)
        k8.append(read_launches()["flash_attention"])
        tallies.append(tl.record())
    rec.update(logits=torch.stack(out).float().cpu(), k8=k8, secs=secs,
               tallies=tallies)
    return rec


def lm_mesh_encdec(dtype: str, mesh=None, floor: bool = False,
                   batch: int = LM_MESH_BATCH) -> dict:
    """(g) served: the prefill's last logits and each decode step's, of
    the whole batch (``mesh`` None; with ``floor`` also each row run alone
    in ``rows_alone``) or of this process's block; at ``batch`` 1 the
    first prompt and its frames, on a mesh under ``use_mesh(
    replicated_batch=True)`` (``seq_shard``); K8's launches in the
    prefill and in each decode step, and their query heads; the cache's
    bytes and specs; the collectives tally of the prefill and of each
    decode step; the prefill's and each decode step's seconds; peak
    memory from the parameters on, and the parameters' bytes."""
    cfg = dataclasses.replace(lm_configs.get(LM_MESH_ENCDEC_ARCH),
                              dtype=dtype)
    m = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = m.init(SEED, device=DEV, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if batch == 1:
        prompts, frames, dec = (t[:1] for t in _encdec_inputs(cfg))
    else:
        prompts, frames, dec = (_block(t, mesh)
                                for t in _encdec_inputs(cfg))
    b = prompts.shape[0]
    ctx = (lm_rules.use_mesh(mesh, replicated_batch=batch == 1)
           if mesh is not None else contextlib.nullcontext())
    with ctx, _k8_heads() as heads:
        # warm: the gloo groups and the kernels' first launches
        _encdec_serve(m, params, prompts[:, :8], frames, dec[:, :1])
        heads.clear()
        run = _encdec_serve(m, params, prompts, frames, dec)
        if floor:
            alone = torch.cat([_encdec_serve(
                m, params, prompts[i:i + 1], frames[i:i + 1],
                dec[i:i + 1])["logits"] for i in range(b)], dim=1)
    k8, secs = run["k8"], run["secs"]
    rec = {"logits": run["logits"], "k8_prefill": k8[0],
           "k8_decode": k8[1:], "k8_heads": sorted(set(heads)),
           "cache_bytes": run["cache_bytes"],
           "cache_specs": run["cache_specs"],
           "tally_prefill": run["tallies"][0],
           "tally_decode": run["tallies"][1:], "prefill_s": secs[0],
           "prefill_tokens_per_s": b * LM_MESH_SEQ / secs[0],
           "decode_step_s": secs[1:],
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "peak_device_mem_bytes": torch.cuda.max_memory_allocated()}
    if floor:
        rec["rows_alone"] = alone
    del params
    return rec


def lm_mesh_encdec_train(mesh=None) -> dict:
    """(g) trained: LM_MESH_DENSE_STEPS AdamW steps of whisper-tiny at
    published width and depth, fp32 parameters and bf16 compute, on B x
    S seeded tokens and the launcher's frames (``launch.train.
    make_batch``); K8's launches in the steps, each step's collectives
    tally, peak memory, s a step."""
    cfg = lm_configs.get(LM_MESH_ENCDEC_ARCH)
    m = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = m.init(SEED, device=DEV, dtype=torch.float32, mesh=mesh)
    tcfg = TrainConfig(lr=LM_MESH_LR)
    opt = train_opt.init_opt_state(tcfg, params)
    step = train_loop.make_train_step(m, tcfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=LM_MESH_SEQ,
                         global_batch=LM_MESH_BATCH, seed=SEED)
    ctx = (lm_rules.use_mesh(mesh) if mesh is not None
           else contextlib.nullcontext())
    losses, gnorms, step_s, tallies = [], [], [], []
    with ctx:
        reset_launches()
        for i in range(LM_MESH_DENSE_STEPS):
            batch = {k: _block(v, mesh) for k, v in launch_train.make_batch(
                cfg, pipe, i, DEV).items()}
            t0 = time.perf_counter()
            with lm_coll.tally() as tl:
                params, opt, met = step(params, opt, batch, i)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            step_s.append(time.perf_counter() - t0)
            tallies.append(tl.record())
        k8 = read_launches()["flash_attention"]
    rec = {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
           "k8_train": k8, "tally_steps": tallies,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "peak_device_mem_bytes": torch.cuda.max_memory_allocated()}
    del params, opt
    return rec


def _headcut_cfg():
    spec = LM_MESH_HEADCUT
    return dataclasses.replace(lm_configs.get(spec["arch"]),
                               n_layers=spec["layers"], dtype="float32")


def _headcut_layout(params, cache, mesh) -> dict:
    """Every leaf against its param_specs block on ``mesh`` (the leaves
    that differ, in ``wrong``), how many ``model`` cuts, ``wr``'s block,
    and the state cache's spec and shape."""
    whole = {n: torch.empty(lm_rules.global_shape(p), device="meta")
             for n, p in params.named_parameters()}
    want = lm_rules.param_specs(mesh, whole)
    wrong, cut = [], 0
    for n, p in params.named_parameters():
        spec = lm_rules.spec_of(p)
        cut += any("model" in lm_rules._axes(e) for e in spec)
        if spec != want[n] or tuple(p.shape) != lm_rules.shard_shape(
                tuple(whole[n].shape), want[n], mesh):
            wrong.append([n, list(p.shape), repr(spec), repr(want[n])])
    s = cache["layers"][0]["s"]
    return {"leaves": len(whole), "leaves_cut_over_model": cut,
            "wrong": wrong, "wr_block": list(params.layers[0].rwkv.wr.w.shape),
            "s_spec": repr(lm_rules.spec_of(s)), "s_shape": list(s.shape)}


def lm_mesh_headcut(mesh=None) -> dict:
    """(i): rwkv6-3b (``_headcut_cfg``) in one process or on ``mesh``'s
    (1, 16): the prefill's last logits and each decode step's, their
    seconds and collectives tallies, the cache's bytes, K8's launches
    (none: attention-free); on a mesh the layout (``_headcut_layout``);
    then one AdamW step (``LM_MESH_HEADCUT``'s lr) on seeded tokens: its
    loss, gradient norm, seconds and tally, and the loss after it; peak
    memory and the parameters' bytes."""
    spec = LM_MESH_HEADCUT
    cfg = _headcut_cfg()
    m = build_model(cfg)
    # the train step's selective checkpointing (``cfg.remat``) imports
    # torch._dynamo: in a fresh process the first step's largest part
    t0 = time.perf_counter()
    importlib.import_module("torch._dynamo")
    dynamo_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = m.init(SEED, device=DEV, dtype=torch.float32, mesh=mesh)
    rng = np.random.default_rng(SEED)
    prompts, dec = (_block(torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (spec["batch"], n))).to(DEV), mesh)
        for n in (spec["seq"], spec["decode"]))
    b = prompts.shape[0]
    ctx = (lm_rules.use_mesh(mesh) if mesh is not None
           else contextlib.nullcontext())
    rec = {"dynamo_import_s": dynamo_s}
    with ctx:
        cache = lm_tr.init_cache(cfg, b, spec["seq"] + spec["decode"],
                                 torch.float32, device=DEV)
        rec.update(_cache_record(cache))
        if mesh is not None:
            rec["layout"] = _headcut_layout(params, cache, mesh)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with lm_coll.tally() as tl:
            logits, cache = lm_tr.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
        rec.update(prefill_s=time.perf_counter() - t0,
                   tally_prefill=tl.record())
        out, t_dec, tallies = [logits[:, 0]], [], []
        for i in range(spec["decode"]):
            pos = torch.full((b,), spec["seq"] + i, dtype=torch.int64,
                             device=DEV)
            t0 = time.perf_counter()
            with lm_coll.tally() as tl:
                lg, cache = lm_tr.decode_step(params, cfg, dec[:, i], pos,
                                              cache)
            torch.cuda.synchronize()
            t_dec.append(time.perf_counter() - t0)
            tallies.append(tl.record())
            out.append(lg)
        rec.update(logits=torch.stack(out).float().cpu(), decode_step_s=t_dec,
                   tally_decode=tallies,
                   k8_serve=read_launches()["flash_attention"])
        del cache
        tcfg = TrainConfig(lr=spec["lr"])
        opt = train_opt.init_opt_state(tcfg, params)
        step = train_loop.make_train_step(m, tcfg)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                             global_batch=spec["batch"], seed=SEED)
        batch = {"tokens": _block(torch.as_tensor(pipe.batch(0)["tokens"],
                                                  device=DEV), mesh)}
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with lm_coll.tally() as tl:
            params, opt, met = step(params, opt, batch, 0)
        rec.update(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                   step_s=time.perf_counter() - t0, tally_train=tl.record(),
                   k8_train=read_launches()["flash_attention"])
        with torch.no_grad():
            loss, _ = m.loss(params, batch)
        rec["loss_after"] = _mesh_mean(loss, mesh)
    rec.update(param_bytes=sum(p.numel() * p.element_size()
                               for p in params.parameters()),
               peak_device_mem_bytes=torch.cuda.max_memory_allocated())
    del params, opt
    return rec


def _lm_mesh_task(task: str, mesh, arrays: dict) -> dict:
    """One task of :func:`lm_mesh_worker` on ``mesh``: its record, its
    logits put in ``arrays``."""
    if task.startswith("forward_"):
        dtype = task.split("_", 1)[1]
        replay = [torch.from_numpy(a) for a in np.load(os.path.join(
            LM_MESH_DIR, f"routes_{dtype}.npz")).values()]
        out = lm_mesh_forward(dtype, mesh, replay)
        arrays[f"logits_{dtype}"] = out.pop("logits").numpy()
    elif task == "published":
        out = lm_mesh_published(mesh)
    elif task == "train":
        out = lm_mesh_train(mesh)
    elif task == "dense":
        out = lm_mesh_dense(mesh)
    elif task == "rwkv_train":
        out = lm_mesh_dense(mesh, "rwkv")
    elif task == "encdec_train":
        out = lm_mesh_encdec_train(mesh)
    elif task.startswith("encdec:"):
        _, layout, dtype = task.split(":")
        out = lm_mesh_encdec(
            dtype, mesh, batch=LM_MESH_ENCDEC_LAYOUTS[layout]["batch"])
        arrays[task] = out.pop("logits").numpy()
    elif task.startswith("family:"):
        leg = task.split(":", 1)[1]
        spec = LM_MESH_FAMILIES[leg]
        replay = [torch.from_numpy(a) for a in np.load(os.path.join(
            LM_MESH_DIR, f"routes_{leg}.npz")).values()]
        replay_b1 = None
        if spec.get("b1"):
            replay_b1 = [torch.from_numpy(a) for a in np.load(
                os.path.join(LM_MESH_DIR,
                             f"routes_{leg}_b1.npz")).values()]
        out = lm_mesh_forward(spec["dtype"], mesh, replay,
                              _family_cfg(leg), spec["decode"],
                              in_turn=spec["in_turn"], b1=spec.get("b1"),
                              replay_b1=replay_b1)
        arrays[f"logits_{leg}"] = out.pop("logits").numpy()
        if "b1" in out:
            arrays[f"logits_{leg}_b1"] = out["b1"].pop("logits").numpy()
    elif task.startswith("seqcut_"):
        out = lm_mesh_seqcut(task.split("_", 1)[1], mesh)
        arrays[task] = out.pop("logits").numpy()
    elif task == "headcut":
        out = lm_mesh_headcut(mesh)
        arrays[task] = out.pop("logits").numpy()
    else:
        out = lm_mesh_restart(mesh)
    return out


def lm_mesh_worker(job_json: str) -> None:
    """One process of the mesh (started by :func:`_lm_mesh_spawn`):
    joins through the launch environment, runs the job's tasks, writes
    its record and arrays."""
    from repro_torch.launch.mesh import join_process_mesh
    import torch.distributed as tdist
    job = json.loads(job_json)
    if DEV.type == "cuda":
        torch.cuda.set_device(0)
    mesh = join_process_mesh(tuple(job["dims"]), tuple(job["axes"]),
                             device=DEV)
    rec = {"rank": mesh.rank, "coords": mesh.coords,
           "backend": mesh.backend, "device": str(DEV)}
    arrays = {}
    for task in job["tasks"]:
        t0 = time.perf_counter()
        with lm_coll.tally() as whole:
            out = _lm_mesh_task(task, mesh, arrays)
        out["collectives_task"] = whole.record()
        out["task_s"] = time.perf_counter() - t0
        print(json.dumps({"task": task, "s": out["task_s"]}), flush=True)
        rec[task] = out
        gc.collect()
        torch.cuda.empty_cache()
    rec["rss_kib"] = _proc_kib("/proc/self/status",
                               ("VmHWM", "VmRSS", "RssAnon", "RssFile"))
    name = f"{job['name']}_rank{mesh.rank}"
    np.savez(os.path.join(LM_MESH_DIR, name + ".npz"), **arrays)
    with open(os.path.join(LM_MESH_DIR, name + ".json"), "w") as f:
        json.dump(rec, f)
    tdist.barrier()
    tdist.destroy_process_group()


def _proc_kib(path: str, keys) -> dict:
    """Fields of a ``/proc`` status file (``MemAvailable``, ``VmRSS``,
    ...) in KiB."""
    out = {}
    with open(path) as f:
        for line in f:
            k, _, v = line.partition(":")
            if k in keys:
                out[k] = int(v.split()[0])
    return out


#: each spawn's least ``MemAvailable`` of the host while its processes ran
LM_MESH_HOST_MEM = {}


def _lm_mesh_fork_server():
    """The fork server (LM_MESH_FORK_SERVER), started on the first call
    in a session of its own, with its log in LM_MESH_DIR."""
    if not _LM_MESH_FORKS:
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTORCH_NVML_BASED_CUDA_CHECK="1",
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        with open(os.path.join(LM_MESH_DIR, "fork_server.log"), "w") as log:
            _LM_MESH_FORKS.update(ready=False, proc=subprocess.Popen(
                [sys.executable, "-c", LM_MESH_FORK_SERVER, ROOT], cwd=ROOT,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
                text=True, env=env, start_new_session=True))
    return _LM_MESH_FORKS


def _lm_mesh_stop_forks() -> None:
    """The fork server and every process it forked, ended."""
    proc = _LM_MESH_FORKS.pop("proc", None)
    _LM_MESH_FORKS.clear()
    if proc is not None:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
        proc.wait()


def _lm_mesh_spawn(name: str, dims, tasks) -> list:
    """``prod(dims)`` worker processes on the card, forked by the fork
    server and joined as a mesh; their records, in rank order (the
    host's least available memory while they ran in LM_MESH_HOST_MEM).
    A process that fails, or a spawn that outlasts 900 s, fails the
    check (the fork server and its processes ended)."""
    size = int(np.prod(dims))
    env = {"REPRO_COORD_ADDR": f"127.0.0.1:{mh_launch._free_port()}",
           "REPRO_NUM_PROC": str(size), "LOCAL_WORLD_SIZE": str(size)}
    job = json.dumps({"name": name, "dims": list(dims),
                      "axes": list(LM_MESH_AXES), "tasks": list(tasks)})
    logs = [os.path.join(LM_MESH_DIR, f"{name}_rank{r}.log")
            for r in range(size)]
    forks = _lm_mesh_fork_server()
    server = forks["proc"]
    deadline = time.monotonic() + 900
    avail = []

    def read_line():
        while time.monotonic() < deadline and server.poll() is None:
            if select.select([server.stdout], [], [], 0.2)[0]:
                return server.stdout.readline().strip()
            avail.append(_proc_kib("/proc/meminfo", ("MemAvailable",))[
                "MemAvailable"])
        return None

    if not forks["ready"]:
        ready = (read_line() or "").split()
        forks.update(ready=ready[:1] == ["ready"], threads=ready[1:])
    rcs = None
    if forks["ready"]:
        server.stdin.write(json.dumps({"job": job, "env": env,
                                       "logs": logs}) + "\n")
        server.stdin.flush()
        rcs = read_line()
    if not rcs:
        _lm_mesh_stop_forks()
        with open(os.path.join(LM_MESH_DIR, "fork_server.log")) as f:
            tail = f.read()[-3000:]
        check(False, f"lm_mesh {name}: the fork server did not run the "
              f"spawn in 900 s\n{tail}")
    for r, rc in enumerate(json.loads(rcs)):
        if rc != 0:
            with open(logs[r]) as f:
                tail = f.read()[-3000:]
            check(False, f"lm_mesh {name}: process {r} exited {rc}\n{tail}")
    LM_MESH_HOST_MEM[name] = 1024 * min(avail, default=0)
    return [json.load(open(os.path.join(LM_MESH_DIR,
                                        f"{name}_rank{r}.json")))
            for r in range(size)]


def _rel_first(got, want, first_tol, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want) / np.abs(want)
    check(rel[0] <= first_tol and rel.max() <= tol,
          f"lm_mesh {what}: losses {got.tolist()} against one process's "
          f"{want.tolist()}")
    return float(rel.max())


@functools.lru_cache(maxsize=None)
def _dry_count(cfg, kind: str, seq: int, batch: int, dims,
               tcfg=None) -> dict:
    """``launch.dryrun.count_collectives`` of a cell, counted once."""
    return lm_dryrun.count_collectives(
        cfg, ShapeConfig("lm_mesh", kind, seq, batch),
        MeshShape(LM_MESH_AXES, tuple(dims)), tcfg=tcfg)


def _check_tally(what: str, got: dict, cfg, kind: str, seq: int,
                 batch: int, dims, tcfg=None) -> dict:
    """A process's collectives tally of one call against the dry run's
    count on ``meta`` of the same cell (``launch.dryrun.
    count_collectives``: the arch, the mesh, the global batch, the prompt
    length of a prefill or the cache's rows of a decode step), kind by
    kind, in bytes, ring volumes and calls; the count."""
    want = _dry_count(cfg, kind, seq, batch, tuple(dims), tcfg)
    check(got["calls_by_kind"] == want["calls_by_kind"]
          and got["by_kind"] == want["by_kind"]
          and got["ring_by_kind"] == want["ring_by_kind"],
          f"lm_mesh {what}: a process ran {got} against the dry run's "
          f"count {want}")
    return {k: want[k] for k in ("calls_by_kind", "by_kind", "total_bytes",
                                 "ring_total_bytes")}


def _check_call_tallies(what: str, per: list, cfg, seq: int, rows: int,
                        batch: int, dims) -> dict:
    """Every process's prefill tally and each decode step's (``per``: the
    processes' records) against the dry run's counts of the prefill cell
    (``seq`` tokens) and of the decode cell (``rows`` of cache); the
    counts."""
    out = {}
    for p in per:
        out["prefill"] = _check_tally(f"{what} prefill", p["tally_prefill"],
                                      cfg, "prefill", seq, batch, dims)
        for t in p["tally_decode"]:
            out["decode"] = _check_tally(f"{what} decode", t, cfg, "decode",
                                         rows, batch, dims)
    return out


def _encdec_tasks(spawn: str) -> list:
    """The served (g) tasks of the spawn ``spawn``: each layout of
    LM_MESH_ENCDEC_LAYOUTS it holds, in fp32 and bf16."""
    return [f"encdec:{layout}:{dtype}"
            for layout, lay in LM_MESH_ENCDEC_LAYOUTS.items()
            if lay["spawn"] == spawn for dtype in ("float32", "bfloat16")]


def _check_encdec(ranks, ranks14, single) -> dict:
    """(g): in each layout of LM_MESH_ENCDEC_LAYOUTS each process's
    served logits against its rows of one process's (fp32 within
    LM_MESH_F32_RTOL of the largest logit, bf16 within LM_LOGIT_ATOL or
    LM_CHAIN_FLOOR_FACTOR times one process's distance from itself row by
    row, the b4 leg's limits), the processes of a batch block bit for bit
    the same, each cache a quarter of one process's and every leaf of it
    the layout's spec, K8's launches and heads a process pinned, each
    call's collectives tally the dry run's count; the train steps gated
    as (d), the first step's tally the dry run's count; its record."""
    want_k8 = LM_MESH_ENCDEC_K8
    out = {"arch": LM_MESH_ENCDEC_ARCH, "seq": LM_MESH_SEQ,
           "rows": LM_MESH_ENCDEC_ROWS,
           "decode_steps": LM_MESH_ENCDEC_DECODE}
    limits = {}
    for layout, lay in LM_MESH_ENCDEC_LAYOUTS.items():
        procs = ranks if lay["spawn"] == "mesh" else ranks14
        bsz = lay["batch"]
        rows = bsz // lay["dims"][0] if bsz > 1 else 1
        out[layout] = {"mesh": list(lay["dims"]), "batch": bsz}
        for dtype in ("float32", "bfloat16"):
            one = single["b1" if bsz == 1 else "b4"][dtype]
            task = f"encdec:{layout}:{dtype}"
            what = f"encdec {layout} {dtype}"
            want = one["logits"]                  # (1 + decode, B, V)
            got = torch.zeros_like(want)
            seen = set()
            for r in procs:
                d = r["coords"]["data"] if bsz > 1 else 0
                arr = torch.from_numpy(np.load(os.path.join(
                    LM_MESH_DIR, f"{lay['spawn']}_rank{r['rank']}.npz"))[
                        task])
                if d not in seen:
                    got[:, d * rows:(d + 1) * rows] = arr
                    seen.add(d)
                else:  # the processes of one block agree bit for bit
                    check(torch.equal(got[:, d * rows:(d + 1) * rows], arr),
                          f"lm_mesh {what}: the processes of batch block "
                          f"{d} differ")
            err = (got - want).abs().amax((1, 2))
            per = [r[task] for r in procs]
            k8 = [[p["k8_prefill"]] + p["k8_decode"] for p in per]
            heads = [p["k8_heads"] for p in per]
            decode = [want_k8["decode"]] * LM_MESH_ENCDEC_DECODE
            check(k8 == [[want_k8["prefill"]] + [lay["k8_decode"]]
                         * LM_MESH_ENCDEC_DECODE] * len(procs)
                  and [one["k8_prefill"]] + one["k8_decode"]
                  == [want_k8["prefill"]] + decode,
                  f"lm_mesh {what}: K8 launched {k8} times a process, "
                  f"prefill then each decode token (one process: "
                  f"{one['k8_prefill']}, {one['k8_decode']})")
            check(heads == [[lay["heads"]]] * len(procs)
                  and one["k8_heads"] == [2 * want_k8["heads"]],
                  f"lm_mesh {what}: K8 ran on {heads} heads a process "
                  f"(one process: {one['k8_heads']})")
            check([p["cache_bytes"] for p in per]
                  == [one["cache_bytes"] // 4] * len(procs)
                  and all(p["cache_specs"] == [lay["spec"]] for p in per),
                  f"lm_mesh {what}: caches "
                  f"{[(p['cache_bytes'], p['cache_specs']) for p in per]},"
                  f" one process {one['cache_bytes']}")
            cfg = dataclasses.replace(lm_configs.get(LM_MESH_ENCDEC_ARCH),
                                      dtype=dtype)
            counts = _check_call_tallies(what, per, cfg, LM_MESH_SEQ,
                                         LM_MESH_ENCDEC_ROWS, bsz,
                                         lay["dims"])
            leg = {"max_abs_err_prefill": float(err[0]),
                   "max_abs_err_decode": err[1:].tolist(),
                   "max_abs_logit": float(want.abs().max()),
                   "k8_per_process": k8, "k8_heads_per_process": heads,
                   "cache_bytes_single": one["cache_bytes"],
                   "collectives_counted": counts,
                   "single": {k: one[k] for k in (
                       "prefill_s", "prefill_tokens_per_s", "decode_step_s",
                       "param_bytes", "peak_device_mem_bytes")},
                   **{f"{k}_per_process": [p[k] for p in per]
                      for k in ("cache_bytes", "cache_specs", "prefill_s",
                                "prefill_tokens_per_s", "decode_step_s",
                                "param_bytes", "peak_device_mem_bytes",
                                "task_s")}}
            if dtype == "float32":
                limit = LM_MESH_F32_RTOL * leg["max_abs_logit"]
                check(bool((err <= limit).all()), f"lm_mesh {what}: "
                      f"logits differ from one process's by "
                      f"{err.tolist()}, limit {limit}")
                leg["tolerance_rel"] = LM_MESH_F32_RTOL
            else:
                if layout == "b4":
                    floor_ = (one["rows_alone"] - want).abs().amax((1, 2))
                    limits[dtype] = torch.clamp_min(
                        LM_CHAIN_FLOOR_FACTOR * floor_, LM_LOGIT_ATOL)
                    leg["rows_alone_vs_batch_err"] = floor_.tolist()
                limit = limits[dtype]
                check(bool((err <= limit).all()), f"lm_mesh {what}: "
                      f"logits differ from one process's by "
                      f"{err.tolist()}, limits {limit.tolist()}")
                leg.update(limit_by_position=limit.tolist(),
                           tolerance_abs=LM_LOGIT_ATOL)
            out[layout][dtype] = leg
    tr, one = ranks[0]["encdec_train"], single["train"]
    check(all(r["encdec_train"]["losses"] == tr["losses"] for r in ranks),
          "lm_mesh encdec train: the processes report other losses")
    check(all(np.isfinite(tr["losses"])),
          f"lm_mesh encdec train: {tr['losses']}")
    rel = np.abs(np.asarray(tr["losses"]) - one["losses"]) / np.abs(
        one["losses"])
    check(rel[0] <= LM_MESH_DENSE_FIRST_RTOL
          and rel.max() <= LM_MESH_DENSE_RTOL,
          f"lm_mesh encdec train: losses {tr['losses']} against one "
          f"process's {one['losses']}")
    k8 = [r["encdec_train"]["k8_train"] for r in ranks]
    check(k8 == [want_k8["train"]] * len(ranks) and one["k8_train"]
          == want_k8["train"], f"lm_mesh encdec train: K8 launched {k8} "
          f"times a process (one process: {one['k8_train']})")
    for r in ranks:
        counted = _check_tally(
            "encdec train", r["encdec_train"]["tally_steps"][0],
            lm_configs.get(LM_MESH_ENCDEC_ARCH), "train", LM_MESH_SEQ,
            LM_MESH_BATCH, LM_MESH_DIMS, TrainConfig(lr=LM_MESH_LR))
    out["train"] = {
        "steps": LM_MESH_DENSE_STEPS, "single": one, "mesh_rank0": tr,
        "losses_rel_err": rel.tolist(),
        "tolerance_rel": [LM_MESH_DENSE_FIRST_RTOL, LM_MESH_DENSE_RTOL],
        "k8_per_process": k8, "collectives_counted": counted,
        **{f"{k}_per_process": [r["encdec_train"][k] for r in ranks]
           for k in ("peak_device_mem_bytes", "param_bytes", "step_s",
                     "task_s")}}
    return out


def _check_b1(leg: str, spec: dict, ranks, one: dict, limit) -> dict:
    """(e)'s batch-1 serve: every process's logits bit for bit the same,
    within LM_MESH_F32_RTOL of one process's largest logit (fp32) or the
    leg's ``limit`` by position (bf16); K8's launches and heads a process
    pinned; its record."""
    task = f"family:{leg}"
    want = one["logits"]                          # (1 + decode, 1, V)
    arrs = [torch.from_numpy(np.load(os.path.join(
        LM_MESH_DIR, f"mesh_rank{r['rank']}.npz"))[f"logits_{leg}_b1"])
        for r in ranks]
    check(all(torch.equal(a, arrs[0]) for a in arrs), f"lm_mesh {leg} b1: "
          "the processes differ")
    err = (arrs[0] - want).abs().amax((1, 2))
    if limit is None:
        limit = torch.full_like(err, LM_MESH_F32_RTOL
                                * float(want.abs().max()))
    check(bool((err <= limit).all()), f"lm_mesh {leg} b1: logits differ "
          f"from one process's by {err.tolist()}, limits {limit.tolist()}")
    k8 = [r[task]["b1"]["k8_prefill"] for r in ranks]
    heads = [r[task]["b1"]["k8_heads"] for r in ranks]
    check(k8 == [spec["k8_prefill"]] * len(ranks) and one["k8_prefill"]
          == spec["k8_prefill"] and heads == [[spec["heads"]]] * len(ranks),
          f"lm_mesh {leg} b1: K8 launched {k8} times on {heads} heads a "
          f"process (one process: {one['k8_prefill']})")
    return {"rows": spec["b1"], "max_abs_err": err.tolist(),
            "limit_by_position": limit.tolist(),
            "max_abs_logit": float(want.abs().max()),
            "k8_prefill_per_process": k8, "k8_heads_per_process": heads,
            "cache_bytes_single": one["cache_bytes"],
            "cache_bytes_per_process": [r[task]["b1"]["cache_bytes"]
                                        for r in ranks],
            "cache_specs_per_process": [r[task]["b1"]["cache_specs"]
                                        for r in ranks],
            "single": {k: one[k] for k in ("prefill_s", "decode_step_s")},
            **{f"{k}_per_process": [r[task]["b1"][k] for r in ranks]
               for k in ("prefill_s", "decode_step_s")},
            "routes_moved": sum(r[task]["b1"]["routes_moved"]
                                for r in ranks)}


def _check_seqcut(ranks, single) -> dict:
    """(h): every process's logits bit for bit the same (one batch block)
    and against one process's (fp32 within LM_MESH_F32_RTOL of the
    largest logit, bf16 within LM_LOGIT_ATOL); a process's cache a
    quarter of one process's, every kv head on a block of the sequence;
    K8 LM_MESH_DENSE_LAYERS times a prefill on 4 of 16 heads and never in
    a decode step; in bf16 the decode's peak rise a process below
    LM_MESH_SEQCUT_RISE of the whole cache's bytes; its record."""
    out = {}
    for dtype, spec in LM_MESH_SEQCUT.items():
        one, task = single[dtype], f"seqcut_{dtype}"
        want = one["logits"]                      # (1 + decode, B, V)
        arrs = [torch.from_numpy(np.load(os.path.join(
            LM_MESH_DIR, f"mesh14_rank{r['rank']}.npz"))[task])
            for r in ranks]
        check(all(torch.equal(a, arrs[0]) for a in arrs),
              f"lm_mesh seqcut {dtype}: the processes differ")
        err = (arrs[0] - want).abs().amax((1, 2))
        scale = float(want.abs().max())
        limit = (LM_MESH_F32_RTOL * scale if dtype == "float32"
                 else LM_LOGIT_ATOL)
        check(bool((err <= limit).all()), f"lm_mesh seqcut {dtype}: logits "
              f"differ from one process's by {err.tolist()}, limit {limit}")
        per = [r[task] for r in ranks]
        k8 = [p["k8_prefill"] for p in per]
        check(k8 == [LM_MESH_DENSE_LAYERS] * len(ranks)
              and one["k8_prefill"] == LM_MESH_DENSE_LAYERS
              and [p["k8_decode"] for p in per] == [0] * len(ranks)
              and [p["k8_heads"] for p in per] == [[spec["heads"]]]
              * len(ranks) and one["k8_heads"] == [4 * spec["heads"]],
              f"lm_mesh seqcut {dtype}: K8 launched {k8} times a prefill "
              f"and {[p['k8_decode'] for p in per]} in the decode on "
              f"{[p['k8_heads'] for p in per]} heads a process")
        whole = one["cache_bytes"]
        check([p["cache_bytes"] for p in per] == [whole // 4] * len(ranks)
              and all(p["cache_specs"] == ["P('data', 'model')"]
                      for p in per), f"lm_mesh seqcut {dtype}: caches "
              f"{[(p['cache_bytes'], p['cache_specs']) for p in per]}, "
              f"one process {whole}")
        counts = _check_call_tallies(f"seqcut {dtype}", per,
                                     _seqcut_cfg(dtype), LM_MESH_SEQ,
                                     spec["rows"], LM_MESH_BATCH,
                                     LM_MESH_SEQCUT_DIMS)
        rise = [p["decode_peak_rise_bytes"] for p in per]
        if dtype == "bfloat16":
            check(max(rise) < LM_MESH_SEQCUT_RISE * whole, f"lm_mesh seqcut "
                  f"bf16: the decode's peak rose {rise} bytes a process "
                  f"over what was allocated before it, limit "
                  f"{LM_MESH_SEQCUT_RISE} x {whole}")
        out[dtype] = {
            "arch": LM_MESH_DENSE_ARCH, "layers": LM_MESH_DENSE_LAYERS,
            "mesh": list(LM_MESH_SEQCUT_DIMS), "rows": spec["rows"],
            "batch": LM_MESH_BATCH, "prompt": LM_MESH_SEQ,
            "decode_steps": spec["decode"],
            "max_abs_err": err.tolist(), "max_abs_logit": scale,
            "limit": limit, "k8_prefill_per_process": k8,
            "collectives_counted": counts,
            "cache_bytes_single": whole,
            "single": {k: one[k] for k in (
                "prefill_s", "decode_step_s", "peak_device_mem_bytes",
                "decode_peak_rise_bytes", "mem_before_decode_bytes",
                "param_bytes")},
            **{f"{k}_per_process": [p[k] for p in per] for k in (
                "cache_bytes", "cache_specs", "prefill_s", "decode_step_s",
                "peak_device_mem_bytes", "decode_peak_rise_bytes",
                "mem_before_decode_bytes", "param_bytes", "task_s")}}
    return out


def _check_headcut(ranks, one) -> dict:
    """(i): every process's logits bit for bit the same (one batch block)
    and within LM_MESH_F32_RTOL of one process's largest logit; the step's
    loss and the loss after it within LM_MESH_HEADCUT_LOSS_RTOL of one
    process's, the same in every process; every leaf its param_specs
    block, ``s`` whole over model (all 40 heads); a process's cache bytes
    equal to one process's; no K8 launch; every process's tallies equal
    to the dry run's counts; its record."""
    spec = LM_MESH_HEADCUT
    cfg, dims = _headcut_cfg(), LM_MESH_HEADCUT_DIMS
    per = [r["headcut"] for r in ranks]
    arrs = [torch.from_numpy(np.load(os.path.join(
        LM_MESH_DIR, f"mesh16_rank{r['rank']}.npz"))["headcut"])
        for r in ranks]
    check(all(torch.equal(a, arrs[0]) for a in arrs),
          "lm_mesh headcut: the processes' logits differ")
    want = one["logits"]                          # (1 + decode, B, V)
    err = (arrs[0] - want).abs().amax((1, 2))
    scale = float(want.abs().max())
    limit = LM_MESH_F32_RTOL * scale
    check(bool((err <= limit).all()), f"lm_mesh headcut: logits differ from "
          f"one process's by {err.tolist()}, limit {limit}")
    losses = {k: [p[k] for p in per] for k in ("loss", "loss_after")}
    rel = {k: abs(v[0] - one[k]) / abs(one[k]) for k, v in losses.items()}
    check(all(v == [v[0]] * len(v) for v in losses.values())
          and all(np.isfinite(v[0]) for v in losses.values())
          and max(rel.values()) <= LM_MESH_HEADCUT_LOSS_RTOL,
          f"lm_mesh headcut: losses {losses} against one process's "
          f"{one['loss']}, {one['loss_after']}")
    lay = [p["layout"] for p in per]
    check(all(x["wrong"] == [] for x in lay)
          and all(x["s_spec"] == repr(lm_rules.P("data"))
                  and x["s_shape"][1] == spec["heads"] for x in lay)
          and all(x["wr_block"] == [cfg.d_model, cfg.d_model // dims[1]]
                  for x in lay),
          f"lm_mesh headcut: layouts {lay}")
    check([p["cache_bytes"] for p in per] == [one["cache_bytes"]] * len(per),
          f"lm_mesh headcut: caches {[p['cache_bytes'] for p in per]} "
          f"bytes a process, one process {one['cache_bytes']}")
    k8 = [p["k8_serve"] + p["k8_train"] for p in per]
    check(k8 == [0] * len(per) and one["k8_serve"] + one["k8_train"] == 0,
          f"lm_mesh headcut: K8 launched {k8} times a process")
    counts = _check_call_tallies("headcut", per, cfg, spec["seq"],
                                 spec["seq"] + spec["decode"], spec["batch"],
                                 dims)
    tcfg = TrainConfig(lr=spec["lr"])
    for p in per:
        counts["train"] = _check_tally("headcut train", p["tally_train"],
                                       cfg, "train", spec["seq"],
                                       spec["batch"], dims, tcfg)
    return {
        **spec, "mesh": list(dims),
        "published_layers": lm_configs.get(spec["arch"]).n_layers,
        "max_abs_err": err.tolist(), "max_abs_logit": scale,
        "limit": limit, "losses_rel_err": rel,
        "tolerance_loss_rel": LM_MESH_HEADCUT_LOSS_RTOL,
        "collectives_counted": counts, "layout_rank0": lay[0],
        "k8_per_process": k8, "cache_bytes_single": one["cache_bytes"],
        "single": {k: one[k] for k in (
            "loss", "loss_after", "grad_norm", "prefill_s", "decode_step_s",
            "step_s", "param_bytes", "peak_device_mem_bytes")},
        **{f"{k}_per_process": [p[k] for p in per] for k in (
            "dynamo_import_s", "grad_norm", "cache_bytes", "prefill_s",
            "decode_step_s", "step_s", "param_bytes",
            "peak_device_mem_bytes", "task_s")}}


def phase_lm_mesh() -> dict:
    """Phase 14e; returns K8's launches per process in (a) and (e)."""
    t_phase = time.perf_counter()
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    os.makedirs(LM_MESH_DIR)
    # the fork server imports while the single-process runs go
    _lm_mesh_fork_server()
    try:
        return _phase_lm_mesh(t_phase)
    finally:
        _lm_mesh_stop_forks()


def _phase_lm_mesh(t_phase: float) -> dict:
    """:func:`phase_lm_mesh` once its directory and fork server are
    set up."""
    gc.collect()
    torch.cuda.empty_cache()
    pub = lm_configs.get(LM_MESH_ARCH)
    check((pub.d_model, pub.n_layers, pub.moe.n_experts, pub.moe.top_k,
           pub.vocab_size) == (2048, 48, 128, 8, 151_936),
          f"lm_mesh: {LM_MESH_ARCH} is not the published config")
    for arch, want in (
            ("jamba-v0.1-52b", (4096, 32, 32, 8, 14_336, 65_536, 16)),
            ("deepseek-v3-671b", (7168, 61, 128, 128, 18_432, 129_280,
                                  256)),
            ("rwkv6-3b", (2560, 32, 40, 40, 8960, 65_536, None))):
        c = lm_configs.get(arch)
        check((c.d_model, c.n_layers, c.n_heads, c.n_kv_heads, c.d_ff,
               c.vocab_size, c.moe.n_experts if c.moe else None) == want,
              f"lm_mesh: {arch} is not the published config")
    dense = lm_configs.get(LM_MESH_DENSE_ARCH)
    check((dense.d_model, dense.n_layers, dense.n_heads, dense.n_kv_heads,
           dense.d_ff, dense.vocab_size, dense.tie_embeddings)
          == (2048, 36, 16, 2, 11_008, 151_936, True),
          f"lm_mesh: {LM_MESH_DENSE_ARCH} is not the published config")
    wh = lm_configs.get(LM_MESH_ENCDEC_ARCH)
    check((wh.encoder_layers, wh.n_layers, wh.d_model, wh.n_heads,
           wh.n_kv_heads, wh.d_ff, wh.vocab_size, wh.encoder_seq)
          == (4, 4, 384, 6, 6, 1536, 51_865, 1500),
          f"lm_mesh: {LM_MESH_ENCDEC_ARCH} is not the published config")
    # the single-process runs first (the card cannot hold both at once)
    single, single_s = {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        single[dtype] = lm_mesh_forward(dtype)
        np.savez(os.path.join(LM_MESH_DIR, f"routes_{dtype}.npz"),
                 *[x.numpy() for x in single[dtype].pop("routes")])
        gc.collect()
        torch.cuda.empty_cache()
        single_s[f"forward_{dtype}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    single_train = lm_mesh_train()
    gc.collect()
    torch.cuda.empty_cache()
    single_s["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    single_dense = lm_mesh_dense()
    gc.collect()
    torch.cuda.empty_cache()
    single_s["dense"] = time.perf_counter() - t0
    # (e) and (f) in one process, the routes of (e) for the mesh to replay
    single_fam = {}
    for leg, spec in LM_MESH_FAMILIES.items():
        t0 = time.perf_counter()
        single_fam[leg] = lm_mesh_forward(
            spec["dtype"], cfg=_family_cfg(leg), n_decode=spec["decode"],
            floor=spec["dtype"] == "bfloat16", b1=spec.get("b1"))
        np.savez(os.path.join(LM_MESH_DIR, f"routes_{leg}.npz"),
                 *[x.numpy() for x in single_fam[leg].pop("routes")])
        if spec.get("b1"):
            np.savez(os.path.join(LM_MESH_DIR, f"routes_{leg}_b1.npz"),
                     *[x.numpy() for x in single_fam[leg]["b1"].pop(
                         "routes")])
        gc.collect()
        torch.cuda.empty_cache()
        single_s[f"family:{leg}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    single_rwkv = lm_mesh_dense(leg="rwkv")
    gc.collect()
    torch.cuda.empty_cache()
    single_s["rwkv_train"] = time.perf_counter() - t0
    # (g) in one process, at batch 4 and at batch 1
    single_enc = {"b4": {}, "b1": {}}
    for dtype in ("float32", "bfloat16"):
        for b in (4, 1):
            t0 = time.perf_counter()
            single_enc[f"b{b}"][dtype] = lm_mesh_encdec(
                dtype, floor=dtype == "bfloat16" and b == 4, batch=b)
            gc.collect()
            torch.cuda.empty_cache()
            single_s[f"encdec_b{b}_{dtype}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    single_enc["train"] = lm_mesh_encdec_train()
    gc.collect()
    torch.cuda.empty_cache()
    single_s["encdec_train"] = time.perf_counter() - t0
    # (h) in one process
    single_seq = {}
    for dtype in LM_MESH_SEQCUT:
        t0 = time.perf_counter()
        single_seq[dtype] = lm_mesh_seqcut(dtype)
        gc.collect()
        torch.cuda.empty_cache()
        single_s[f"seqcut_{dtype}"] = time.perf_counter() - t0
    # (i) in one process
    t0 = time.perf_counter()
    single_headcut = lm_mesh_headcut()
    gc.collect()
    torch.cuda.empty_cache()
    single_s["headcut"] = time.perf_counter() - t0
    print(json.dumps({"lm_mesh single-process s": single_s,
                      "device_mem_allocated_bytes":
                          torch.cuda.memory_allocated()}), flush=True)
    t0 = time.perf_counter()
    ranks = _lm_mesh_spawn("mesh", LM_MESH_DIMS, (
        "forward_float32", "forward_bfloat16", "published", "train",
        "dense", *(f"family:{a}" for a in LM_MESH_FAMILIES), "rwkv_train",
        *_encdec_tasks("mesh"), "encdec_train"))
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks14 = _lm_mesh_spawn("mesh14", LM_MESH_SEQCUT_DIMS,
                             [f"seqcut_{d}" for d in LM_MESH_SEQCUT]
                             + _encdec_tasks("mesh14"))
    mesh14_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks16 = _lm_mesh_spawn("mesh16", LM_MESH_HEADCUT_DIMS, ("headcut",))
    mesh16_s = time.perf_counter() - t0
    rec = {"arch": LM_MESH_ARCH, "mesh": list(LM_MESH_DIMS),
           "axes": list(LM_MESH_AXES), "processes": len(ranks),
           "backend": ranks[0]["backend"], "layers": LM_MESH_LAYERS,
           "train_layers": LM_MESH_TRAIN_LAYERS,
           "published_layers": pub.n_layers, "batch": LM_MESH_BATCH,
           "seq": LM_MESH_SEQ, "decode_steps": LM_MESH_DECODE,
           "single_process_s": single_s, "mesh_processes_s": mesh_s,
           "mesh14_processes_s": mesh14_s, "mesh16_processes_s": mesh16_s,
           "host_mem_available_min_bytes": dict(LM_MESH_HOST_MEM),
           "fork_server_threads": _LM_MESH_FORKS.get("threads"),
           "rss_kib_rank0": {n: r[0]["rss_kib"] for n, r in (
               ("mesh", ranks), ("mesh14", ranks14), ("mesh16", ranks16))}}
    check(rec["backend"] == "gloo" and all(
        r["device"].startswith("cuda") for r in ranks),
        f"lm_mesh: backend {rec['backend']}")
    # (a) each process's logits against its rows of the single run's
    for dtype in ("float32", "bfloat16"):
        want = single[dtype]["logits"]            # (1 + decode, B, V)
        got = torch.zeros_like(want)
        rows = LM_MESH_BATCH // LM_MESH_DIMS[0]
        for r in ranks:
            d = r["coords"]["data"]
            arr = np.load(os.path.join(LM_MESH_DIR, f"mesh_rank{r['rank']}"
                                       ".npz"))[f"logits_{dtype}"]
            if r["coords"]["model"] == 0:
                got[:, d * rows:(d + 1) * rows] = torch.from_numpy(arr)
            else:      # the processes of one block agree bit for bit
                check(torch.equal(got[:, d * rows:(d + 1) * rows],
                                  torch.from_numpy(arr)),
                      f"lm_mesh {dtype}: the processes of batch block {d} "
                      "differ")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        moved = sum(r[f"forward_{dtype}"]["routes_moved"] for r in ranks)
        tokens = sum(r[f"forward_{dtype}"]["routes_tokens"] for r in ranks)
        k8 = [r[f"forward_{dtype}"]["k8_prefill"] for r in ranks]
        leg = {"max_abs_err": err, "max_abs_logit": scale,
               "routes_moved": moved, "routes_tokens": tokens,
               "routes_moved_share": moved / tokens,
               "k8_prefill_per_process": k8,
               "peak_device_mem_bytes_single":
                   single[dtype]["peak_device_mem_bytes"],
               "peak_device_mem_bytes_per_process": [
                   r[f"forward_{dtype}"]["peak_device_mem_bytes"]
                   for r in ranks],
               "task_s_per_process": [r[f"forward_{dtype}"]["task_s"]
                                      for r in ranks]}
        if dtype == "float32":
            leg["tolerance_rel"] = LM_MESH_F32_RTOL
            check(err <= LM_MESH_F32_RTOL * scale, f"lm_mesh fp32: logits "
                  f"differ by {err} (largest {scale})")
        else:
            leg["tolerance_abs"] = LM_LOGIT_ATOL
            check(err <= LM_LOGIT_ATOL, f"lm_mesh bf16: logits differ by "
                  f"{err}")
        check(k8 == [LM_MESH_LAYERS] * len(ranks), f"lm_mesh {dtype}: K8 "
              f"launched {k8} times in the processes' prefills")
        rec[f"forward_{dtype}"] = leg
    rec["published"] = [r["published"] for r in ranks]
    # (c) the mesh's train steps against one process's
    tr = ranks[0]["train"]
    check(all(r["train"]["losses"] == tr["losses"] for r in ranks),
          "lm_mesh train: the processes report other losses")
    rec["train"] = {
        "single": single_train, "mesh_rank0": tr,
        "peak_device_mem_bytes_per_process": [
            r["train"]["peak_device_mem_bytes"] for r in ranks],
        "losses_max_rel_err": _rel_first(
            tr["losses"] + [tr["adafactor_loss"], tr["loss_after_adafactor"]],
            single_train["losses"] + [single_train["adafactor_loss"],
                                      single_train["loss_after_adafactor"]],
            LM_MESH_TRAIN_FIRST_RTOL, LM_MESH_TRAIN_RTOL, "train"),
        "ce_first_rel_err": abs(tr["ce"][0] - single_train["ce"][0])
        / single_train["ce"][0]}
    check(all(np.isfinite(tr["losses"])), f"lm_mesh train: {tr['losses']}")
    # (d) the dense model's sharded steps against one process's
    dn = ranks[0]["dense"]
    check(all(r["dense"]["losses"] == dn["losses"] for r in ranks),
          "lm_mesh dense: the processes report other losses")
    check(all(np.isfinite(dn["losses"])), f"lm_mesh dense: {dn['losses']}")
    rel = (np.abs(np.asarray(dn["losses"]) - single_dense["losses"])
           / np.abs(single_dense["losses"]))
    check(rel[0] <= LM_MESH_DENSE_FIRST_RTOL
          and rel.max() <= LM_MESH_DENSE_RTOL,
          f"lm_mesh dense: losses {dn['losses']} against one process's "
          f"{single_dense['losses']}")
    rec["dense"] = {
        **LM_MESH_TRAIN_LEGS["dense"],
        "published_layers": dense.n_layers, "single": single_dense,
        "mesh_rank0": dn,
        "losses_rel_err": rel.tolist(),
        "tolerance_rel": [LM_MESH_DENSE_FIRST_RTOL, LM_MESH_DENSE_RTOL],
        "peak_device_mem_bytes_per_process": [
            r["dense"]["peak_device_mem_bytes"] for r in ranks],
        "param_bytes_per_process": [r["dense"]["param_bytes_per_process"]
                                    for r in ranks],
        "step_s_per_process": [r["dense"]["step_s"] for r in ranks],
        "reduce_scatter_ms_per_process": [
            r["dense"]["reduce_scatter"]["ms"] for r in ranks],
        "task_s_per_process": [r["dense"]["task_s"] for r in ranks]}
    # (e) the served families against one process, routes replayed
    rec["families"] = {}
    for leg, spec in LM_MESH_FAMILIES.items():
        one, task = single_fam[leg], f"family:{leg}"
        want = one["logits"]                      # (1 + decode, B, V)
        got = torch.zeros_like(want)
        rows = LM_MESH_BATCH // LM_MESH_DIMS[0]
        for r in ranks:
            d = r["coords"]["data"]
            arr = torch.from_numpy(np.load(os.path.join(
                LM_MESH_DIR, f"mesh_rank{r['rank']}.npz"))[f"logits_{leg}"])
            if r["coords"]["model"] == 0:
                got[:, d * rows:(d + 1) * rows] = arr
            else:      # the processes of one block agree bit for bit
                check(torch.equal(got[:, d * rows:(d + 1) * rows], arr),
                      f"lm_mesh {leg}: the processes of batch block {d} "
                      "differ")
        err = (got - want).abs().amax((1, 2))
        k8 = [r[task]["k8_prefill"] for r in ranks]
        heads = [r[task]["k8_heads"] for r in ranks]
        check(k8 == [spec["k8_prefill"]] * len(ranks) and one["k8_prefill"]
              == spec["k8_prefill"], f"lm_mesh {leg}: K8 launched {k8} "
              f"times a process (one process: {one['k8_prefill']})")
        check(heads == [[spec["heads"]]] * len(ranks), f"lm_mesh {leg}: "
              f"K8 ran on {heads} heads a process")
        fam = {"arch": spec["arch"], "layers": spec["layers"],
               "dtype": spec["dtype"], "decode_steps": spec["decode"],
               "max_abs_err_prefill": float(err[0]),
               "max_abs_err_decode": err[1:].tolist(),
               "max_abs_logit": float(want.abs().max())}
        if spec["dtype"] == "float32":
            limit = LM_MESH_F32_RTOL * float(want.abs().max())
            check(bool((err <= limit).all()), f"lm_mesh {leg}: logits "
                  f"differ from one process's by {err.tolist()}, limit "
                  f"{limit}")
            fam.update(tolerance_rel=LM_MESH_F32_RTOL)
        else:
            floor_ = (one["rows_alone"] - want).abs().amax((1, 2))
            vs_rows = (got - one["rows_alone"]).abs().amax((1, 2))
            limit = torch.clamp_min(LM_CHAIN_FLOOR_FACTOR * floor_,
                                    LM_LOGIT_ATOL)
            drops = [one["drop_frac_max"]] + [r[task]["drop_frac_max"]
                                              for r in ranks]
            check(drops == [0.0] * len(drops), f"lm_mesh {leg}: the "
                  f"dropless runs dropped {drops} (one process, then each "
                  "process)")
            check(bool((err <= limit).all()), f"lm_mesh {leg}: prefill and "
                  f"decode logits differ from one process's by "
                  f"{err.tolist()}, limits {limit.tolist()}")
            probes = one["probes"]
            fam.update(
                capacity_factor=_family_cfg(leg).moe.capacity_factor,
                drop_frac_max=drops,
                rows_alone_vs_batch_err=floor_.tolist(),
                mesh_vs_rows_alone_err=vs_rows.tolist(),
                limit_by_position=limit.tolist(),
                tolerance_abs=LM_LOGIT_ATOL,
                one_process_prefill_probes={
                    "again_max_abs_err": float(
                        (probes["again"] - want[0]).abs().max()),
                    "k8_twin_max_abs_err": float(
                        (probes["twin"] - want[0]).abs().max()),
                    "cf16_capacity_factor": LM_DROPLESS_CF,
                    "cf16_drop_frac_max": probes["cf16_drop_frac_max"],
                    "cf16_max_abs_err": float(
                        (probes["cf16"] - want[0]).abs().max())},
                routes_moved=sum(r[task]["routes_moved"] for r in ranks),
                routes_tokens=sum(r[task]["routes_tokens"] for r in ranks))
        fam.update({
            "k8_prefill_per_process": k8, "k8_heads_per_process": heads,
            "k8_heads_single": one["k8_heads"],
            "single": {k: one[k] for k in (
                "prefill_s", "prefill_tokens_per_s", "decode_step_s",
                "param_bytes", "peak_device_mem_bytes")},
            **{f"{k}_per_process": [r[task][k] for r in ranks] for k in (
                "prefill_s", "prefill_tokens_per_s", "decode_step_s",
                "param_bytes", "peak_device_mem_bytes", "task_s")},
            "cache_bytes_single": one["cache_bytes"],
            "cache_bytes_per_process": [r[task]["cache_bytes"]
                                        for r in ranks],
            "cache_specs_per_process": [r[task]["cache_specs"]
                                        for r in ranks]})
        check(fam["cache_bytes_per_process"] == [one["cache_bytes"] // 4]
              * len(ranks), f"lm_mesh {leg}: the processes hold "
              f"{fam['cache_bytes_per_process']} bytes of cache, one "
              f"process {one['cache_bytes']}")
        if spec.get("b1"):
            fam["b1"] = _check_b1(leg, spec, ranks, one["b1"],
                                  None if spec["dtype"] == "float32"
                                  else limit)
        rec["families"][leg] = fam
    # (f) rwkv6-3b's sharded steps against one process's
    rw = ranks[0]["rwkv_train"]
    check(all(r["rwkv_train"]["losses"] == rw["losses"] for r in ranks),
          "lm_mesh rwkv: the processes report other losses")
    check(all(np.isfinite(rw["losses"])), f"lm_mesh rwkv: {rw['losses']}")
    rel = (np.abs(np.asarray(rw["losses"]) - single_rwkv["losses"])
           / np.abs(single_rwkv["losses"]))
    check(rel[0] <= LM_MESH_DENSE_FIRST_RTOL
          and rel.max() <= LM_MESH_DENSE_RTOL,
          f"lm_mesh rwkv: losses {rw['losses']} against one process's "
          f"{single_rwkv['losses']}")
    rec["rwkv_train"] = {
        **LM_MESH_TRAIN_LEGS["rwkv"],
        "published_layers": lm_configs.get("rwkv6-3b").n_layers,
        "single": single_rwkv, "mesh_rank0": rw,
        "losses_rel_err": rel.tolist(),
        "tolerance_rel": [LM_MESH_DENSE_FIRST_RTOL, LM_MESH_DENSE_RTOL],
        "peak_device_mem_bytes_per_process": [
            r["rwkv_train"]["peak_device_mem_bytes"] for r in ranks],
        "param_bytes_per_process": [
            r["rwkv_train"]["param_bytes_per_process"] for r in ranks],
        "step_s_per_process": [r["rwkv_train"]["step_s"] for r in ranks],
        "task_s_per_process": [r["rwkv_train"]["task_s"] for r in ranks]}
    rec["encdec"] = _check_encdec(ranks, ranks14, single_enc)
    rec["seqcut"] = _check_seqcut(ranks14, single_seq)
    check(all(r["device"].startswith("cuda") for r in ranks16),
          "lm_mesh headcut: a process is not on the card")
    rec["headcut"] = _check_headcut(ranks16, single_headcut)
    # (c) the elastic restart onto (1, 2), against one process resumed
    t0 = time.perf_counter()
    restart = _lm_mesh_spawn("restart", LM_MESH_RESTART_DIMS, ("restart",))
    restart_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single_restart = lm_mesh_restart()
    single_restart["s"] = time.perf_counter() - t0
    got = restart[0]["restart"]
    check(got["start"] == LM_MESH_TRAIN_STEPS and all(
        r["restart"]["losses"] == got["losses"] for r in restart),
        f"lm_mesh restart: {[r['restart'] for r in restart]}")
    rec["restart"] = {
        "mesh": list(LM_MESH_RESTART_DIMS), "processes": len(restart),
        "mesh_rank0": got, "single": single_restart,
        "peak_device_mem_bytes_per_process": [
            r["restart"]["peak_device_mem_bytes"] for r in restart],
        "processes_s": restart_s,
        "losses_max_rel_err": _rel_first(
            got["losses"], single_restart["losses"],
            LM_MESH_TRAIN_FIRST_RTOL, LM_MESH_TRAIN_RTOL, "restart")}
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lm_mesh", **rec,
          "phase_s": time.perf_counter() - t_phase})
    return {"per_process": rec["forward_bfloat16"]["k8_prefill_per_process"],
            "float32_per_process":
                rec["forward_float32"]["k8_prefill_per_process"],
            **{f"family {arch} per_process": fam["k8_prefill_per_process"]
               for arch, fam in rec["families"].items()},
            **{f"encdec {layout} {dtype} per_process":
               rec["encdec"][layout][dtype]["k8_per_process"]
               for layout in LM_MESH_ENCDEC_LAYOUTS
               for dtype in ("float32", "bfloat16")},
            **{f"family {arch} b1 per_process": fam["b1"][
                "k8_prefill_per_process"] for arch, fam
               in rec["families"].items() if "b1" in fam},
            **{f"seqcut {dtype} per_process": leg["k8_prefill_per_process"]
               for dtype, leg in rec["seqcut"].items()},
            "headcut per_process": rec["headcut"]["k8_per_process"]}


# --------------------------------------------------------------------------
# phase 25: the repository's entry points (repro_torch.examples)
# --------------------------------------------------------------------------

#: the microcircuit leg: ``run_scenario --scenario microcircuit`` at the
#: scale and length of the reference's two-key record (19 292 neurons,
#: 17.8 M synapses; microcircuit(1.0), about 285 M, is left to a benchmark)
EX_MICROCIRCUIT = ZOO_REFERENCE["microcircuit"]
#: the microcircuit's device time: its last steps under the profiler, a
#: steady window past the onset, the build and the other steps untraced
EX_PROFILE_STEPS = 200
#: run_scenario's legs: (name, argv, launches a step by kernel)
EX_SCENARIOS = (
    ("brunel", [], {"synaptic_gather_lif": 1}),
    ("brunel_poisson_input", ["--poisson-input"],
     {"synaptic_gather": 1, "lif_step": 1}),
    ("izhikevich", ["--model", "izhikevich"],
     {"synaptic_gather_izhikevich": 1}),
    ("brunel_grid_2x2", ["--grid", "2x2"], {"synaptic_gather_lif": 4}),
    ("microcircuit", ["--scenario", "microcircuit", "--scale",
                      str(EX_MICROCIRCUIT["scale"]), "--steps",
                      str(EX_MICROCIRCUIT["steps"])],
     {"synaptic_gather_lif": 1}),
)
#: simulate_marmoset's legs (its defaults: 2000 steps, a save every 500)
EX_MARMOSET = (("marmoset", []), ("marmoset_grid_2x2", ["--grid", "2x2"]))
#: serve_snn's legs; each session-step is one K1 + K2 launch
EX_SESSIONS = (("sessions", ["--sessions", "4", "--steps", "400"]),
               ("sessions_evict", ["--sessions", "4", "--steps", "400",
                                   "--slots", "2"]))
#: train_lm: the defaults (60 steps, a save every 25, 2 kept), then a
#: ``--resume`` from its step-50 checkpoint to 60
EX_TRAIN_CUT = 50
#: fit_brunel: --smoke from phase_diff (c)'s init (the reference's
#: tests/test_diff.py::test_brunel_inversion_smoke): the same fit as
#: DIFF_INVERSION_SMOKE, through the entry point, held to the script's own
#: 25 % bar and to (c)'s bars
EX_FIT_ARGV = ["--smoke", "--init-eta", str(DIFF_INVERSION_SMOKE["init_eta"])]


def _quiet(fn, *a, **kw):
    """``fn``'s result with its standard output kept (returned too)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def _counted(what: str, fn, want: dict, *a, **kw):
    """``fn(*a, **kw)`` with every launch count set to 0 just before and
    read just after; each kernel of ``want`` launched that often and every
    other kernel never.  Returns (result, stdout, launches, wall s)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, text = _quiet(fn, *a, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_launches(what, launches, want)
    return out, text, {k: c for k, c in launches.items() if c}, wall


def _profiling_last(make_step_fn, prof, first: int, window: dict):
    """``make_step_fn`` whose steps from ``first`` on (0-based) run under
    ``prof``, started on an idle device; ``window`` gets the time the
    driver asked for its step (its build done), the time profiling began
    and the steps profiled."""
    def make(*a, **kw):
        window["t_make"] = time.perf_counter()
        step, n = make_step_fn(*a, **kw), 0

        def profiled(state):
            nonlocal n
            if n == first:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()
            out = step(state)
            n += 1
            if n > first:
                window["steps"] = n - first
            return out
        return profiled
    return make


def _ex_run_scenario() -> dict:
    recs = {}
    for name, argv, per_step in EX_SCENARIOS:
        steps = ex_run_scenario.build_parser().parse_args(argv).steps
        want = {k: c * steps for k, c in per_step.items()}
        prof, window = None, {}
        if name == "microcircuit":
            # the last EX_PROFILE_STEPS steps profiled; the driver's read
            # of its counts after them is the window's end
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            make = engine.make_step_fn
            engine.make_step_fn = _profiling_last(
                make, prof, steps - EX_PROFILE_STEPS, window)
            t_leg = time.perf_counter()
            try:
                rec, text, launches, wall = _counted(
                    f"examples {name}", ex_run_scenario.main, want,
                    [*argv, "--device", str(DEV)])
            finally:
                engine.make_step_fn = make
            window["s"] = time.perf_counter() - window["t0"]
            prof.stop()
        else:
            rec, text, launches, wall = _counted(
                f"examples {name}", ex_run_scenario.main, want,
                [*argv, "--device", str(DEV)])
        check(text.endswith("ok\n"), f"examples {name}: no ok line")
        check(rec["total_spikes"] > 0, f"examples {name}: silent")
        for pop, r in rec["populations"].items():
            check(all(math.isfinite(x) for x in r["per_window_hz"]),
                  f"examples {name}: {pop} rate not finite")
        out = {"argv": argv, "steps": steps, "neurons": rec["neurons"],
               "mean_hz": rec["mean_hz"], "wall_s": wall,
               "driver_wall_s": rec["wall_s"], "launches": launches,
               "rates_hz": {p: r["rate_hz"]
                            for p, r in rec["populations"].items()}}
        if name == "microcircuit":
            ref = EX_MICROCIRCUIT
            w0 = ref["mean_from_step"] // ref["window_steps"]
            rates = {p: {"per_window_hz": r["per_window_hz"],
                         "mean_hz": sum(r["per_window_hz"][w0:])
                         / len(r["per_window_hz"][w0:])}
                     for p, r in rec["populations"].items()}
            out["rate_band"] = check_keyed_rates("examples microcircuit",
                                                 rates, ref)
            out["rates_by_window_hz"] = rates
            busy = sum(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
                       for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA")) / 1e3
            check(window.get("steps") == EX_PROFILE_STEPS and busy > 0,
                  f"examples microcircuit: {window.get('steps')} steps "
                  f"profiled, {busy} ms of device time")
            out["profiled_steps"] = EX_PROFILE_STEPS
            out["device_ms_per_step"] = busy / EX_PROFILE_STEPS
            # the window holds the driver's final read of its counts too
            out["profiled_wall_ms_per_step"] = window["s"] * 1e3 / \
                EX_PROFILE_STEPS
            out["device_idle_share"] = 1 - busy / (window["s"] * 1e3)
            # the host build (network, its move to the card, the initial
            # state) against the stepping
            out["build_s"] = window["t_make"] - t_leg
            out["steps_s"] = wall - out["build_s"]
            out["synapses"] = ref["synapses"]
        recs[name] = out
    return recs


def _ex_quickstart() -> dict:
    snn_want = {k: 2000 for k in MAIN_KERNELS}
    rec, text, launches, wall = _counted("examples quickstart snn_demo",
                                         ex_quickstart.snn_demo, snn_want,
                                         str(DEV))
    check(rec["rate_hz"] < 10.0, f"examples quickstart: rate "
          f"{rec['rate_hz']} Hz not below the paper's 10 Hz")
    lo, hi = rec["w_bounds"]
    check(lo <= rec["plastic_w_min"] and rec["plastic_w_max"] <= hi,
          f"examples quickstart: plastic weights [{rec['plastic_w_min']}, "
          f"{rec['plastic_w_max']}] left [{lo}, {hi}]")
    check(rec["finite"], "examples quickstart: v_m not finite")
    lm, _, lm_launches, lm_wall = _counted("examples quickstart lm_demo",
                                           ex_quickstart.lm_demo, {},
                                           str(DEV))
    check(all(math.isfinite(x) for x in lm["losses"]),
          f"examples quickstart: losses {lm['losses']}")
    return {"snn": dict(rec, wall_s=wall, launches=launches),
            "lm": dict(lm, wall_s=lm_wall, launches=lm_launches)}


def _ex_marmoset(tmp: str) -> dict:
    recs = {}
    for name, argv in EX_MARMOSET:
        args = ex_marmoset.build_parser().parse_args(argv)
        steps, every = args.steps, args.save_every
        ckpt = os.path.join(tmp, name)
        rec, text, launches, wall = _counted(
            f"examples {name}", ex_marmoset.main,
            {"synaptic_gather_lif": math.prod(args.grid) * steps},
            [*argv, "--ckpt", ckpt, "--device", str(DEV)])
        check(rec["last_step"] == steps,
              f"examples {name}: latest checkpoint {rec['last_step']}")
        kept = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt)
                      if re.fullmatch(r"step_\d+", d))
        check(kept == [steps - every, steps],
              f"examples {name}: kept {kept} (keep 2)")
        # every leaf as the manager writes it, and the static markers
        saved, restored = state_items(rec["state"]), state_items(
            rec["restored"])
        check(saved.keys() == restored.keys(),
              f"examples {name}: restored leaves differ")
        for k, a in saved.items():
            b = restored[k]
            same = (a.dtype == b.dtype and np.array_equal(a, b)
                    if isinstance(a, np.ndarray) else a == b)
            check(same, f"examples {name}: restored {k} differs from the "
                  "state saved")
        check(text.endswith("ok\n"), f"examples {name}: no ok line")
        recs[name] = {"argv": argv, "neurons": rec["neurons"],
                      "mean_hz": rec["mean_hz"], "spikes": rec["spikes"],
                      "kept_steps": kept, "leaves": len(saved),
                      "restore_bitwise": True, "wall_s": wall,
                      "launches": launches,
                      **{k: rec[k] for k in ("wire_bytes_per_step", "split",
                                             "wire_overflow") if k in rec}}
    return recs


def _ex_sessions(tmp: str) -> dict:
    recs = {}
    for name, argv in EX_SESSIONS:
        evict = "--slots" in argv
        extra = lambda d: ["--ckpt-dir", os.path.join(tmp, d)] if evict \
            else []
        rec, _, launches, wall = _counted(
            f"examples {name}", ex_serve_snn.main,
            {"synaptic_gather_lif": 4 * 400},
            [*argv, *extra(name), "--device", str(DEV)])
        cpu, _ = _quiet(ex_serve_snn.main,
                        [*argv, *extra(name + "_cpu"), "--device", "cpu",
                         "--sweep", "flat"])
        same = {"created": rec["created"] == cpu["created"],
                "refused": rec["refused"] == cpu["refused"],
                "stats": rec["stats"] == cpu["stats"],
                "sessions": {s: (r["step"], r["status"])
                             for s, r in rec["sessions"].items()}
                == {s: (r["step"], r["status"])
                    for s, r in cpu["sessions"].items()}}
        for k, ok in same.items():
            check(ok, f"examples {name}: {k} differ from the CPU's flat run")
        recs[name] = {"argv": argv, "stats": rec["stats"],
                      "statuses": {s: r["status"]
                                   for s, r in rec["sessions"].items()},
                      "rates_hz": {s: r["rate_hz"]
                                   for s, r in rec["sessions"].items()},
                      "equal_to_cpu_flat": same, "wall_s": wall,
                      "launches": launches}
    return recs


def _ex_serve_lm() -> dict:
    cfg = lm_configs.get_smoke("qwen2.5-3b")
    params = build_model(cfg).init(SEED, device=DEV)
    by_route = _reset_k8_routes()
    rec, text, launches, wall = _counted(
        "examples serve_lm", ex_serve_lm.main,
        {"flash_attention": cfg.n_layers}, ["--device", str(DEV)],
        params=params)
    routes = dict(by_route)
    check(routes == {"wgmma": 0, "simt": cfg.n_layers},
          f"examples serve_lm: K8 routes {routes}")
    cpu_params = lm_tr.DecoderLM(cfg, device="cpu")
    cpu_params.load_state_dict({k: v.cpu()
                                for k, v in params.state_dict().items()})
    cpu, _ = _quiet(ex_serve_lm.main, ["--device", "cpu"],
                    params=cpu_params)
    # the margin rule: where the CPU's logits at a generated position have
    # a clear top-2 margin, the card must pick its token; past the first
    # unclear position the two chains may part
    n_new = len(cpu["outputs"][0])
    reqs = [list(r) for r in ex_serve_lm.REQUESTS]
    s = max(len(r) for r in reqs)
    rows = torch.zeros((len(reqs), s + n_new - 1), dtype=torch.int64)
    for i, (r, o) in enumerate(zip(reqs, cpu["outputs"])):
        rows[i, :len(r)] = torch.tensor(r)
        rows[i, s:] = torch.tensor(o[:-1])
    with torch.no_grad():
        hid = lm_tr.hidden_states(cpu_params, cfg, rows)[:, s - 1:]
        logits = lm_tr._unembed(cpu_params, cfg, hid)
    clear = _clear_margin(logits, LM_LOGIT_ATOL_F32)
    compared = parted = 0
    for i in range(len(reqs)):
        for j, (a, b) in enumerate(zip(rec["outputs"][i],
                                       cpu["outputs"][i])):
            if not bool(clear[i, j]):
                parted += a != b
                break
            check(a == b, f"examples serve_lm: request {i} token {j}: card "
                  f"{a}, CPU {b} at a clear margin")
            compared += 1
    check(text.endswith("ok\n"), "examples serve_lm: no ok line")
    return {"tokens_out": rec["tokens_out"], "prefill_s": rec["prefill_s"],
            "decode_tok_per_s": rec["decode_tok_per_s"],
            "tokens_equal_to_cpu": rec["outputs"] == cpu["outputs"],
            "tokens_compared": compared, "unclear_parted": parted,
            "k8_routes": routes, "wall_s": wall, "launches": launches}


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` for a block (the
    embedding's backward sums by atomics otherwise); cuBLAS's
    deterministic workspace is set at the script's top, before its first
    handle."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _ex_train_lm(tmp: str) -> dict:
    runs = {}
    with _deterministic():
        # the uninterrupted run's step-50 checkpoint is what a run to step
        # 50 writes: batch i is a pure function of i
        ckpt = os.path.join(tmp, "train_lm")
        for name, argv in (("defaults", ["--ckpt", ckpt]),
                           ("resumed", ["--resume", "--ckpt", ckpt])):
            rec, text, launches, wall = _counted(
                f"examples train_lm {name}", ex_train_lm.main, {},
                [*argv, "--device", str(DEV)])
            check(all(math.isfinite(x) for x in rec["losses"]),
                  f"examples train_lm {name}: a loss is not finite")
            check(text.endswith("ok\n"), f"examples train_lm {name}: no ok")
            runs[name] = dict(rec, wall_s=wall)
    whole, resumed = runs["defaults"], runs["resumed"]
    check(resumed["start"] == EX_TRAIN_CUT,
          f"examples train_lm: resumed from {resumed['start']}")
    steps = ex_train_lm.build_parser().get_default("steps")
    check(len(whole["losses"]) == steps, "examples train_lm: steps")
    check(whole["losses"][-1] < whole["losses"][0],
          "examples train_lm: the loss did not fall")
    a = dict(whole["params"].named_parameters())
    b = dict(resumed["params"].named_parameters())
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    check(not diff, f"examples train_lm: resumed parameters differ from "
          f"the uninterrupted run's: {diff[:5]}")
    check(resumed["losses"] == whole["losses"][EX_TRAIN_CUT:],
          "examples train_lm: the resumed losses differ")
    return {"model": whole["name"], "params": whole["params_count"],
            "loss_first": whole["losses"][0], "loss_last": whole["losses"][-1],
            "s_per_step": whole["wall_s"] / steps,
            "resume_bitwise": True,
            "wall_s": {k: r["wall_s"] for k, r in runs.items()}}


def _ex_fit_brunel() -> dict:
    argv = [*EX_FIT_ARGV, "--device", str(DEV)]
    rec, text, launches, wall = _counted("examples fit_brunel",
                                         ex_fit_brunel.main, {}, argv)
    fit = dict(init_g=4.0, init_eta=float(EX_FIT_ARGV[-1]), **rec["fit"])
    check(fit == DIFF_INVERSION_SMOKE, f"examples fit_brunel: the fit "
          f"{fit} is not phase_diff (c)'s {DIFF_INVERSION_SMOKE}")
    check(rec["ok"], f"examples fit_brunel: missed the script's "
          f"{rec['bar']:.0%} bar: {rec['rel_error']}")
    check(rec["final_loss"] < rec["loss_history"][0],
          f"examples fit_brunel: loss did not descend {rec['loss_history']}")
    for k, bar in DIFF_INVERSION_BARS.items():
        check(rec["rel_error"][k] <= bar, f"examples fit_brunel: relative "
              f"error in {k} {rec['rel_error'][k]} above {bar}")
    return {"argv": argv, "g": rec["g"], "eta": rec["eta"],
            "rel_error": rec["rel_error"], "bars": DIFF_INVERSION_BARS,
            "script_bar": rec["bar"], "final_loss": rec["final_loss"],
            "loss_history": rec["loss_history"], "n_evals": rec["n_evals"],
            "wall_s": wall}


def phase_examples() -> dict:
    """The seven entry points' ``main`` on the card, in this process: each
    leg's launches counted (set to 0 just before, read just after) and
    pinned, and the script's own checks plus the ones named in each leg.
    Returns the launches by leg."""
    t_phase = time.perf_counter()
    tmp = os.path.join(ROOT, "build", "examples")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        out = {"run_scenario": _ex_run_scenario(),
               "quickstart": _ex_quickstart(),
               "simulate_marmoset": _ex_marmoset(tmp),
               "serve_snn": _ex_sessions(tmp),
               "serve_lm": _ex_serve_lm(),
               "train_lm": _ex_train_lm(tmp),
               "fit_brunel": _ex_fit_brunel()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    launches = {}
    for driver, legs in out.items():
        if not isinstance(legs, dict):
            continue
        for leg, r in legs.items():
            if isinstance(r, dict) and "launches" in r:
                launches[f"{driver} {leg}"] = r["launches"]
        if "launches" in legs:
            launches[driver] = legs["launches"]
    emit({"phase": "examples", **out})
    return launches


def main() -> None:
    t_main = time.perf_counter()
    smi = phase_device()
    t0 = time.perf_counter()
    spec, stdp = models.hpc_benchmark(1.0, stdp=True)
    g_host = builder.build_shards(spec, builder.decompose(spec, 1))[0]
    g = g_host.to(DEV)
    del g_host
    table = snn.make_param_table(list(spec.groups), models.DT_MS, device=DEV)
    emit({"phase": "build", "neurons": spec.n_neurons, "n_local": g.n_local,
          "edges": int((g.delay > 0).sum()), "nb": g.blocked.nb,
          "eb": g.blocked.eb, "pb": g.blocked.pb, "max_delay": g.max_delay,
          "host_build_s": time.perf_counter() - t0})
    kern = phase_kernels(g)
    phase_lockstep(spec, stdp, g, table)
    phase_mixed()
    runs = {}
    runs["main"], main_out = phase_main(spec, stdp, g, table)
    kern.update(phase_gate_kernels(g))
    runs["gate_main cuda:sparse:1e-7"], gate_rates = phase_gate_main(
        spec, stdp, g, table, main_out)
    shapes_launches = phase_shapes(spec, stdp, g, table, main_out,
                                   phase_shape_tune(g), gate_rates)
    runs["dist_main 2x2"] = phase_dist(spec, stdp, g, table)
    mh_launches, mh_main_rec = phase_multihost()
    sup_launches = {"ckpt_main": phase_ckpt_main(spec, stdp, g, table,
                                                 main_out)}
    sess_launches = phase_sessions(len(main_out["spikes"])
                                   / main_out["wall_s"])
    diff_launches = phase_diff(spec, stdp, g, table, main_out)
    examples_launches = phase_examples()
    del main_out
    sup_launches.update(phase_mh_supervised(mh_main_rec))
    del g, table
    dryrun_launches = phase_dryrun(smi)
    phase_gate_activity()
    zoo_kern, zoo_runs = zoo()
    kern.update(zoo_kern)
    runs.update(zoo_runs)
    kern.update(phase_flash_kernels())
    runs["lm_serve"] = {"flash_attention": phase_lm_serve()}
    lm_fam_launches = phase_lm_families()
    lm_train_launches = phase_lm_train()
    lm_dryrun_launches = phase_lm_dryrun()
    lm_mesh_launches = phase_lm_mesh()
    emit({"phase": "total", "script_s": time.perf_counter() - t_main})
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/"
                   f"{'synaptic_gather' if name in FUSED_KERNELS else name}"
                   ".cu",
         "replaces": REPLACES[name],
         "launches": runs[LAUNCHES_FROM[name]][name],
         "launches_from": LAUNCHES_FROM[name],
         "launches_multihost_per_process": [p.get(name, 0)
                                            for p in mh_launches],
         "launches_supervised": {
             "ckpt_main": sup_launches["ckpt_main"].get(name, 0),
             **{f"mh_supervised {leg}": [p.get(name, 0) for p in ps]
                for leg, ps in sup_launches.items() if leg != "ckpt_main"}},
         "launches_sessions": {part: got.get(name, 0)
                               for part, got in sess_launches.items()},
         "launches_diff": diff_launches.get(name, 0),
         "launches_examples": {leg: got.get(name, 0)
                               for leg, got in examples_launches.items()},
         "launches_shapes": {part: got.get(name, 0)
                             for part, got in shapes_launches.items()},
         "launches_dryrun": {part: got.get(name, 0)
                             for part, got in dryrun_launches.items()},
         "launches_lm_families": {arch: got.get(name, 0) for arch, got
                                  in lm_fam_launches.items()},
         "launches_lm_train": {
             part: got if name == "flash_attention" else 0
             for part, got in lm_train_launches.items()},
         "launches_lm_dryrun": {
             part: got if name == "flash_attention" else 0
             for part, got in lm_dryrun_launches.items()},
         "launches_lm_mesh": {
             part: got if name == "flash_attention" else [0] * len(got)
             for part, got in lm_mesh_launches.items()},
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "ms_per_launch": kern[name].get("ms_per_launch"),
         "epilogue_ms": kern[name].get("epilogue_ms"),
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name].get("library_ms")}
        for name in (*KERNEL_FNS, *FUSED_KERNELS)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
