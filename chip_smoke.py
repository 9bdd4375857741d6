"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

In order, each phase failing the run with a non-zero exit:

1. the card: name and power limit (nvidia-smi); TF32 is turned off for
   matrix products and cuDNN for the whole run, so every comparison below
   is float32 against float32 (phase 20's spawned ranks start with
   PyTorch's defaults, as any spawned rank does, and turn TF32 off where
   they are held against this process);
2. builds the CUDA kernels from ``mtad_gat_tpu_torch/csrc`` (one nvcc per
   source, all at once) and reports the seconds;
3. K1, the fused GATv2 attention forward, against its plain PyTorch version
   at the shapes of the scoring path (feature and temporal layer, batch 256,
   float32 and bfloat16, with and without bias: the whole-graph kernel,
   launched twice for identical bits, and the tiled kernel forced once at
   each layer), at N = 160 (E 128, D 64: half a graph's rows a block, timed
   beside the tiled kernel), at N = 2048 and 4096 (the tiled kernel, where it
   also checks that a call allocates less than one (N, N) float32 matrix)
   and at window 1200 (N 38, E 2400, D 1200: the tiled kernel with E and D
   in chunks); each layer's time
   by CUDA events and by a CUDA graph of 20 calls for both kernels (at the
   temporal layer also the whole-graph kernel with the rows over two
   blocks), beside the plain time and the bound, each planned tiled case's
   by CUDA graph; then the tiled forward's merge alone at the route's
   partials against its plain version, twice for identical bits, timed;
4. K3, the fused GRU scan forward, against its plain version at batch 256,
   100 steps, hidden 150 (float32 and bfloat16 inputs; the cluster variant
   with ragged unit slices), at 1024 steps, at one step, at batch 1 and at a
   batch that leaves a ragged tile, at a width the cluster divides (64), at
   one that takes the larger cluster (200) and at one that takes the
   streaming variant (512), each record naming the variant and cluster size
   that ran; with ``torch.nn.GRU`` (cuDNN) and the input projection alone
   timed on the same data as yardsticks;
5. the scoring path through its entry point: a synthetic SMD entity (2000
   rows, 38 features) and a run directory with a seeded random model at the
   reference's SMD widths; ``predict_cli.main`` with ``--device cuda`` and
   both kernels on, in float32 and in bfloat16, asserting the summary, the
   kernels' launch counts (each scoring batch launches K1 twice and K3
   twice), that the float32 scores equal those of the same run scored
   with the plain paths (``attention_impl="dense"``, ``gru_impl="xla"``)
   and that the bfloat16 scores lie within a bfloat16 tolerance of them;
   then scoring windows/s in float32 and bfloat16, and device time by
   kernel over one profiled float32 scoring pass;
6. K1-res (the training forward, residuals and hash dropout) and the
   attention backward against their plain versions at the training shapes
   (feature and temporal layer, batch 256): float32 with dropout 0 and 0.3,
   with and without bias, bfloat16 at dropout 0.3 with bias. K1-res runs the
   variant ``gat_fwd_plan`` names (the whole-graph kernel at both layers,
   launched twice for identical bits) and the tiled kernel forced once at
   each layer. The backward
   runs the variant ``gat_bwd_plan`` names: K2ab (the whole-graph kernel) at
   both layers, dbias summed in the same launch wherever there is a bias,
   launched twice for identical bits (dbias included), its planned shared
   memory and batch groups (``dbias_groups``) equal to the built library's,
   with the partials' bytes and each instantiation's blocks a
   multiprocessor; K2a then K2b (the tiled kernels, K2b summing dbias in
   its own pass wherever there is a bias) forced twice at each layer, and
   planned at N = 2048 and N = 4096, each twice for identical bits (dbias
   included), with the plan of each call (``gat_tiled_bwd_plan``: K2b's
   batch group ``tiled_dbias_groups`` and its partials' bytes equal to the
   built library's, K2b's blocks a multiprocessor with and without dbias),
   where each launch of one forward-and-backward also has to allocate no
   more than its outputs, its planned partial sums (K2b's dbias partials
   included) and 1 MiB, and 1 MiB for each of those tensors of 1 MiB or
   more (the caching allocator's unsplit blocks); K2c (no longer on
   any path) forced wherever there is a bias, as the yardstick of the fold.
   At the feature layer's window 235 (the WIDE tile), 300, 1024 and 1200
   (where the tiled plan names the CHUNKED tile and ``gat_bwd_route`` the
   streamed backward: that runs, dbias from it, twice for identical bits,
   its plan equal to the built library's layout, its occupancy reported; at
   window 300 also at dropout 0 without bias and in bfloat16; the CHUNKED
   K2a and K2b, the tiled K1-res and K2c's chunked staging forced there
   too, each twice for identical bits; each timed by CUDA graph beside its
   bound, the CHUNKED pair beside the streamed backward); at the shapes of
   ``long_complete``'s batch-64 run, float32, dropout 0.3, bias: its
   temporal layer (64, 1024, 76, 38: the tiled K1-res, the FAST K2a and K2b
   with dbias in groups of one batch element, 64 partials summed), with the
   memory check above and K2b with dbias forced at twice the planned group
   beside the planned one (its errors, bits, partials' bytes and device
   time), and its feature layer (window 1024 above, with the memory check,
   the streamed backward's scratch its plan's); and the tiled K2b's weights
   against the tiled K1-res's, bit for bit, at each tile, with and without
   dbias, and the streamed backward's at E 2400. Each
   kernel's time at both layers is a wrapper call by CUDA events and its
   device time from a CUDA graph of 20 calls, beside its bound and its plain
   version; K2ab's also without dbias, followed by K2c, and the sum of its
   partials alone; the tiled K2b's with and without dbias, and followed by
   K2c;
7. K4, the GRU backward through time, against its plain version and against
   autograd of the plain forward at batch 256, 100 steps, hidden 150
   (float32 and bfloat16 ``gi``; a dense cotangent and one that is zero
   except at the last step), at 1024 steps, at one step, at batch 1 and at a
   batch that leaves a ragged tile, at widths 64, 176 (the larger cluster)
   and 384 (the streaming variant), two launches giving identical bits and
   each record naming the variant and cluster size that ran; its time beside its
   bound, its plain version and the backward of ``torch.nn.GRU`` (cuDNN);
   the weights product (``gru_weight_grads``) alone at the flagship chain
   against its plain version, its time by CUDA events and by a CUDA graph
   beside its bound and ``torch.mm(hprev.T, dgh)`` with the db column sum;
   then the window at which the GRU kernels overtake the plain loop, for
   scoring and for training (the table behind ``GRU_PALLAS_MIN_WINDOW``);
8. the training paths through their entry point: ``train_cli.main`` with
   ``--device cuda --attention_impl pallas`` at the SMD flagship widths
   (lookback 100, batch 256, dropout 0.3) on the synthetic entity, float32
   then bfloat16: 1 epoch with ``--gru_impl xla`` (the plain GRU loop) and 2
   epochs with ``--gru_impl pallas`` (every kernel on), asserting finite
   losses and summary, the launch counts (per training step K1-res, K2ab
   summing dbias (K2a, K2b none at these widths, K2c none on any path) and,
   with the GRU
   kernels, K3, K4's scan and K4's weights product twice each; per batch scored without
   gradient K1 and, with the GRU kernels, K3 twice; K1 and K1-res through
   the whole-graph kernel only) and that
   ``predict_cli`` on the written run reproduces its summary; the float32
   run with every kernel on also takes ``--profile_dir``: one trace file, of
   its second epoch, in which each kernel of ``TRACED_KERNELS`` (K1-res,
   K2ab, K3, K4's scan and weights product) shows as many kernel events as
   its launch counters counted over the traced epoch, with the file's size,
   the device's busy share over it and the trace's seconds; and its loss
   plots written (or, where matplotlib is not installed, skipped);
9. three one-epoch runs at dropout 0 from one seed: all plain, attention
   through the kernels, and attention and GRU through the kernels; per-step
   losses and final parameters of each kernel run must agree with the plain
   one. Then training windows/s in float32 and bfloat16 (all the steps of
   some epochs after a warm-up one, and each epoch's own rate) with the
   plain GRU loop and with every kernel on, and device time by kernel over
   one profiled float32 epoch of each; then ``reporting``:
   ``visualize_cli`` on phase 5's float32 kernel run, the files the root
   ``visualize.py`` writes (the .png plots only where matplotlib is
   installed), and the thresholds' host time on that run's scores
   (epsilon, POT, the best-F1 search; ``utils/profiling.timed``, each
   result equal to the run's summary);
10. ``long_window``: the port's ``Trainer`` at lookback 1024 on a band:128
    temporal graph with the band-stored score bias (the block scan), batch
    64, float32, dropout 0.3, ``gru_impl auto``: 2 epochs of 4 steps, finite
    losses, K3 and K4 launch counts exact, windows/s and peak memory; then
    the block scan and the unrolled banded path against the COO path at a
    small size, forward and gradients;
11. ``graph_cli``: ``train_cli --feature_graph knn:5 --temporal_graph
    band:10`` (1 epoch) on the synthetic entity and ``predict_cli`` on its
    run, the same summary; K3 and K4 launch as on the main path, the
    attention kernels never (the graph variants run plain ops);
12. ``wide_window``: ``train_cli --lookback 300 --attention_impl pallas
    --gru_impl pallas`` at dropout 0 on a short synthetic entity (700 rows,
    batch 32, 2 epochs): launch counts exact by kernel and variant (the
    feature layer's streamed backward, the temporal layer's tiled K1,
    K1-res and merge and K2a and K2b, dbias from the streamed backward and
    K2b, the CHUNKED tile and K2c never), training windows/s and peak
    memory, and per-epoch losses equal to the ``--attention_impl dense``
    run's within a stated tolerance; then the feature layer at window 1200
    in one training call, exact counts (the tiled K1-res and merge, the
    streamed backward with dbias), against the dense layer;
13. ``dense_route``: ``attention_impl="dense"`` on complete GATv2 graphs.
    At the flagship (batch 256, both layers) it stays dense, with no kernel
    launch; with the route's threshold pinned to 1 byte the layer runs K1
    (eval) or K1-res and K2ab (training) once a call and matches the dense
    layer, output and gradients; at the first N the byte model routes on
    this card (batch 1, e 76, d 38) it runs the tiled K1 in eval, and the
    tiled K1-res, K2a and K2b (with dbias) in training at dropout 0.3, with
    exact counts and peak memory; the output and the gradients (dp, dq, da,
    dbias, dv) of both calls are held against the plain attention computed
    by chunks of query rows on the same inputs; each tiled kernel's time by
    CUDA graph beside its bound, K2b with dbias beside K2b followed by K2c
    and the whole tiled backward both ways; then dense at the largest N
    below the route, its peak memory within the byte model, its time beside
    the kernels';
14. ``long_complete``: ``train_cli --lookback 1024 --attention_impl pallas
    --gru_impl pallas --bs 64 --dropout 0.3`` on complete feature and
    temporal graphs, float32, 2 epochs on a synthetic entity of 1,700 rows
    (10 steps an epoch): finite losses and summary, launch counts exact by
    kernel and variant (the temporal layer's tiled K1, K1-res and merge,
    FAST K2a and K2b with dbias; the feature layer's tiled forward with E
    and D in chunks and the streamed backward with dbias; K3, K4's scan and
    weights twice a step; the CHUNKED tile and K2c never), training
    windows/s by epoch, peak
    memory above the baseline, device time by kernel over one profiled
    epoch; then the same entry point at ``--bs 8 --dropout 0`` for 1 epoch,
    ``--attention_impl pallas`` and ``dense`` from one seed, per-epoch
    losses within ``WIDE_LOSS_TOL`` (dense at batch 64 is not run: its byte
    model, reported, holds the temporal layer alone near 68 GB);
15. ``serving``: ``serve_cli`` on phase 5's run directory (the synthetic
    entity, the seeded model at the SMD widths, both kernels on, float32).
    K1 at batch 1 (one point's forward) at both layers against its plain
    version, twice for identical bits, by CUDA graph beside its bound (K3
    at batch 1 is phase 4's "batch 1" record). ``serve_cli.main --device
    cuda`` streams the test split from a CSV at ``--chunk 1`` and ``--chunk
    128`` with ``--threshold_method epsilon``, at 128 with spot, and with
    dspot on a copy of the run without cached train scores (so it scores
    the training split to calibrate), ``--flush_ms 0``: record i scores test
    point i (the train-tail priming); the scores equal ``get_score`` on
    ``train[-w:] ++ test`` within ``SCORE_ATOL``, and chunk 1 equals chunk
    128; epsilon alarms are ``score > threshold``, spot and dspot alarms and
    thresholds those of the offline ``run`` over the served scores; each
    forward launches K1 (whole graph) twice and K3 twice, the priming's and
    the calibration's included, no other kernel and no plain attention or
    GRU call runs; the same stream through the plain paths' run (``dense``,
    ``xla``) gives the same scores. Kill and resume at chunks 1 and 128: a
    state file, the first half of a file, then the grown file under another
    spelling of its path, which skips the rows served; the two runs'
    records equal the uninterrupted run's, bit for bit at chunk 1. Then
    points/s at chunks 1, 8, 32, 128 and 512, the time per chunk from its
    yield to its written records (p50, p99) at 1 and 128, and device time by
    kernel over one profiled pass at each;
16. ``fleet_serving``: K1 and K3 with an entity axis at G 28 (SMD's
    machines), 1 and 128 rows a group: K1's whole-graph kernel and its
    tiled one forced at both flagship layers, K3's cluster variant at
    hidden 150 and its streaming one at 384, each equal to its G ungrouped
    launches bit for bit (the tiled K1 may differ where the two plans'
    slices do, then within ``K1_TOL``) and within its tolerance of the
    grouped plain version, timed by CUDA graph beside the G launches, with
    its bound; the host cost of the K1 and K3 custom ops had the solo path
    called them (it calls the wrappers direct); then 28 synthetic SMD
    machines (``write_smd`` from seeds 1-28, 500 rows each, a seeded
    flagship model each, both kernels on, no cached train scores) served by
    ``serve_cli.main --group 1-1,...,3-11 --input a.csv,...`` at chunk 128
    (calibrating by scoring each training split) and chunk 1, epsilon:
    every point served, K1 (whole graph) and K3 launched exactly twice a fleet forward
    (besides the calibration's), each vmap rule once a layer a forward, no
    plain call; three groups' records equal to their solo ``serve_cli``
    runs (scores within ``FLEET_ATOL``, thresholds and alarms equal); then
    all-entity points/s at chunks 128 and 1, p50 and p99 a dispatch, peak
    memory, a profiled pass at each, and 28 solo scorers in this process
    fed the same chunks;
17. ``fleet_training``: K4 with an entity axis at G 28, 64 and 256 rows a
    group, T 100 (the scan's cluster variant at hidden 150 and its streaming
    one at 384, the weights product at 150), each equal to its G ungrouped
    launches bit for bit (the weights product at the grouped launch's
    chunks a group) and within ``K4_TOL`` of the grouped plain version,
    timed by CUDA graph beside the G launches; K3 under gradients:
    ``vmap(grad(...))`` of a GRU-scan loss over 28 entities' stacked weights
    launching K3, K4's scan and K4's weights once each, states and dgi equal
    to 28 solo ``grad`` calls bit for bit, dW_hh and db_hh within
    ``K4_TOL``, timed beside them; K1-res and K2ab with an entity axis at
    G 28, 64 and 256 rows a group, both layers, dropout 0.3 with a seed an
    entity (float32, and bfloat16 at the feature layer's 64 rows), each
    equal to its 28 ungrouped launches bit for bit (K2ab with dbias, da and
    dbias an entity's) and within ``TRAIN_TOL`` of the grouped plain
    version, the grouped and ungrouped K2ab's blocks a multiprocessor equal,
    timed by CUDA graph beside the 28 launches; the attention under
    gradients: ``vmap(grad(...))`` over 28 entities launching K1-res and
    K2ab once each a layer, within ``TRAIN_TOL`` of 28 solo ``grad`` calls;
    the dense layers' byte model for the fleet at batch 64 and 256; then 28
    synthetic SMD machines (``write_smd`` from seeds 1-28, 400-600 rows)
    trained by ``sweep_cli.main --batched`` at the flagship widths, dropout
    0.3, 1 epoch, float32, with dense attention at batch 64 and with
    ``--attention_impl pallas --gru_impl pallas`` at batch 64 and 256:
    exactly two K3, K4 scan and K4 weights launches a fleet step and each
    GRU rule twice a step, dense: no attention kernel and the keep-mask
    rule once at each of 5 dropout sites, kernels: two K1-res (whole graph)
    and two K2ab with dbias a step, their rules twice, the keep-mask rule at
    3 sites and the seed rule at 2, no plain attention call; no plain GRU
    call, every entity's summary finite, ``predict_cli`` reproducing one;
    three machines (700, 620 and 780 rows) against their solo ``Trainer``s
    at dropout 0 and 0.3, dense and through the kernels (losses within
    ``FLEET_PARITY_TOL``, params at dropout 0; at 0.3 the keep masks and the
    hash seeds bit for bit); then all-entity windows/s, step p50 and p99 on
    the device's clock, peak memory and a profiled epoch of the dense fleet
    at batch 64 and the kernel fleet at 64 and 256, and ``sweep_cli.main``
    without ``--batched`` on the same data (28 solo trainers one after
    another) for its windows/s;
18. ``fleet_wide_window``: the lookback-300 layers at G 28 and 64 rows an
    entity, float32, bias, dropout 0.3 with a seed an entity: the temporal
    layer's tiled K1-res and FAST K2a and K2b with dbias, the feature
    layer's whole-graph K1-res on two row blocks and streamed backward with
    dbias, each grouped launch equal to its 28 ungrouped launches bit for
    bit (those at the grouped plan's slices and K2b's batch group) and
    within ``TRAIN_TOL`` of the grouped plain version, timed by CUDA graph
    beside the 28 launches and its bound, with each new instantiation's
    blocks a multiprocessor beside the ungrouped one's; then phase 17's 28
    machines trained by ``sweep_cli.main --batched --attention_impl pallas
    --gru_impl pallas --lookback 300 --bs 64`` (1 epoch, dropout 0.3): a
    fleet step's launches exact by kernel and variant (two K1-res, one
    merge, one FAST K2a, one FAST K2b with dbias, one streamed backward with
    dbias, the GRU's), no plain call, every summary finite, ``predict_cli``
    reproducing one; three machines against their solo trainers at lookback
    300 and dropout 0 within ``FLEET_PARITY_TOL``; then the fleet's
    windows/s, step p50 and p99 on the device's clock, peak memory and a
    profiled epoch's busy share;
19. ``fleet_wide_features``: the CHUNKED tiled K2a and K2b with dbias at G
    28 and 64 rows an entity, N 65 and 128, E 600, D 300, float32, bias,
    dropout 0.3 with a seed an entity, each grouped launch equal to its 28
    ungrouped launches bit for bit (those at the grouped plan's slices and
    K2b's batch group) and within ``TRAIN_TOL`` of the grouped plain
    version, timed by CUDA graph beside the 28 launches and its bound, with
    each new instantiation's blocks a multiprocessor beside the ungrouped
    one's; path (a), ``MultiEntityTrainer.fit`` over 28 synthetic machines
    of 65 features at window 300, batch 64, dropout 0.3, every kernel on
    (depth cut to 5 steps an epoch): a fleet step's launches exact (two
    tiled K1-res and merges, the feature layer's CHUNKED K2a and K2b with
    dbias, the temporal layer's FAST pair, the GRU's), no plain call, its
    windows/s, step p50 and p99 on the device's clock, peak memory and busy
    share; path (b), the 28 machines of ``write_fleet`` (800 rows each)
    trained by ``sweep_cli.main --batched --lookback 300 --temporal_graph
    band:64 --bias_storage band --attention_impl dense --gru_impl pallas
    --bs 64`` (the temporal layer the block scan under ``vmap(grad)``):
    launches exact, no plain GRU call, every summary finite,
    ``predict_cli`` reproducing one; three machines against their solo
    trainers at dropout 0 within ``FLEET_PARITY_TOL``; its numbers as path
    (a)'s, its peak memory within half the card's; then each phase's
    seconds;
20. ``multi_device``: two ranks of a mesh as processes sharing the card
    over gloo (NCCL refuses two ranks on one device), spawned by
    ``parallel.multihost.spawn`` as ``train_cli --mesh_devices 2`` spawns
    them. (a) The data axis: each rank runs ``train_cli.train_rank`` (what
    every rank of ``train_cli --mesh_devices 2 --model_parallel 1`` runs)
    at the flagship through every kernel, batch 256 (128 a rank), dropout
    0.3, 1 epoch on the synthetic entity: each rank's launches exact by
    kernel (those of one device's run, every batch on both ranks), no
    plain attention or GRU call, one metrics line, a finite summary
    written once, and ``predict_cli.main --mesh_devices 2 --model_parallel
    1`` reproducing it; on a (data 2) mesh one step's gradients at dropout
    0 on each rank within ``MESH_GRAD_TOL`` of the single device's; the
    ranks' parameters equal bit for bit after each run; all-rank windows/s
    of a timed epoch beside one device's in this process, peak memory per
    rank, the backend; the run takes ``--profile_dir``, and each rank
    writes its own trace of the epoch (two files, a rank's name in each),
    its kernel events equal to its launch counters over the epoch, with its
    busy share and its host time in collectives. (b) The model axis: ``train_rank`` of
    ``--mesh_devices 2 --model_parallel 2 --attention_impl ring
    --gru_impl pallas --lookback 300 --bs 64`` at dropout 0, 1 epoch on a
    700-row entity (temporal N 300, 150 a rank; feature N 38, 19 a rank):
    the ring twice a forward, K3 and K4 as one device's, no attention
    kernel; epoch and step losses within ``WIDE_LOSS_TOL`` of
    ``--attention_impl dense`` on one device; the ranks' parameters equal;
    peak memory per rank beside the dense run's. (c) The banded halo
    exchange: ``train_rank`` of ``--mesh_devices 2 --model_parallel 2
    --attention_impl ring --gru_impl pallas`` at phase ``long_window``'s
    configuration (lookback 1024, band:128, band-stored bias, batch 64) at
    dropout 0, 1 epoch (temporal N 1024, 512 a rank, W 128: the halo;
    feature N 38, 19 a rank: the ring): the halo and the ring each once a
    forward, K3 and K4 as one device's, no attention kernel and no plain
    GRU call; epoch and step losses within ``WIDE_LOSS_TOL`` of
    ``--attention_impl dense`` (the single-device block scan) on one
    device; then an epoch at dropout 0.3 on the same mesh, finite; the
    ranks' parameters equal; peak memory per rank beside the single
    device's, windows/s. (d) The fleet over data ranks: a second spawn of
    three ranks, each running ``sweep_cli.main --batched --mesh_devices 3
    --attention_impl pallas --gru_impl pallas --bs 64`` as a rank of a
    group started elsewhere (``--num_processes 3``) over phase
    ``fleet_training``'s 28 machines, dropout 0.3, 1 epoch: the entities
    in blocks of 10, 9 and 9, each rank's grouped K1-res, K2ab, K3 and
    K4 launches those of its block (``expect_fleet_epoch``, each grouped
    launch's G its block's), no plain call, each entity scored over the 3
    ranks at batch 64 (which 3 does not divide), every summary finite and
    written once; then a fleet at dropout 0 on the 3 ranks (cuDNN
    deterministic, TF32 off), its parameters and losses equal bit for bit
    to one device's fleets of the same blocks, its losses within
    ``FLEET_PARITY_TOL`` of one device's fleet of 28 and its parameters'
    distance from that reported, with a probe of the ops that round by the
    entity count; the ``fleet_state.pt`` the ranks wrote
    resumed on one device to the parameters the sweep wrote; all-rank
    windows/s beside phase ``fleet_training``'s one-device fleet, peak
    memory per rank, each path's seconds;
21. ``bench_scripts``: the root bench scripts' H100 counterparts, imported
    and called in this process at the flagship widths and reduced depth,
    each a counted run: (a) ``bench_edges_torch``'s table (bf16, E 256, D
    128, at ``BENCH_EDGES_ITERS``) and crossover at N 8,192 and 65,536
    (1 iteration), K1's and its merge's launches equal to the script's
    calls, every dense row out of memory marked ``oom``, every kernel row
    a rate; K1 on the same inputs against its plain version at (8, 128),
    (8, 512) and (4, 2048) and against ``chunked_plain_attention`` at N
    8,192 (every row, with and without bias) and 65,536 (three blocks of
    128 rows), within ``BENCH_K1_TOL``; beside each case its time, bound
    and the dense path's, and the N at which ``nn/gat.dense_gatv2_bytes``
    puts dense beyond the card; (b) ``bench_long_torch.bench_config(8192,
    256, 8, 4, epochs=1)``, its launches (K3, K4's scan and weights twice
    a step), then at (8, 8192, 150) in bfloat16 and float32 K3 against its
    plain version within ``K3_TOL``, and K4 (scan and weights product, and
    the weights product alone) against theirs within ``K4_TOL``; (c)
    ``bench_entities_torch.bench(4, batches_per_epoch=2, epochs=1)``: each
    solo epoch's and each fleet epoch's launches (grouped K3 and K4 twice a
    fleet step, ``expect_fleet_epoch``); (d) ``bench_attrib_torch`` at
    ``BENCH_ATTRIB_STEPS`` steps: the capture's traced block counted, its
    parse giving K3's and K4's kernels as many events as their counters,
    all in ``gru scan body``, the modules summing within 1% to the busy
    time measured apart from the parser, as many kernel events as
    correlation ids, and each traced module some device time; the phase
    fails past ``BENCH_SECONDS_LIMIT`` seconds;
22. ``remat``: ``remat_attention`` (both attention layers recomputed in
    the backward pass, ``nn/remat.py``) against the same run without it,
    float32, dropout 0.3, cuDNN deterministic: (a) the flagship ``Trainer``
    through every kernel and with dense attention, 4 steps of 256 from one
    seed, each step's losses, the final parameters and each step's dropout
    generator state identical in bits, the launches exact
    (``step_launches(..., remat=True)``: K1-res twice a layer a step, the
    forward's and the recompute's); (b) windows/s over the last 3 steps and
    peak memory over them, with and without remat, for those two, for
    lookback 300 with dense attention at batch 64, and for phase
    ``fleet_training``'s 28 machines as one dense ``MultiEntityTrainer``
    at batch 64 (4 fleet steps under ``vmap(grad_and_value)``, parameters,
    losses and keep-mask draws identical in bits); (c) that fleet with
    remat at ``REMAT_WITNESS_BS`` for two steps, its peak memory beside
    the batch-64 run's slope and that slope's batch 256 (ROADMAP item 2);
    the phase fails past ``REMAT_SECONDS_LIMIT`` seconds;
23. one JSON line ``{"kernels": [...]}`` (with each kernel's launches by
    path, serving's, fleet serving's, fleet training's, the wide fleet's,
    the wide-feature fleet's and long_complete's included, the tiled kernels' times at the route's
    N, K2b's with and without dbias, K2c's forced times and where dbias now
    comes from, and K1's and K3's serving launches and
    batch-1 times, and their grouped launches at G 28, K1-res's and K2ab's
    fleet-training launches and grouped times, and the grouped tiled K1-res,
    K2a, K2b and streamed backward's at lookback 300; the merge, the
    CHUNKED K2a and K2b (their grouped launches and path (a)'s launches
    with them), the chunked K2c and the streamed backward as rows of their
    own; ``launches_by_path["multi_device"]`` rank 0's on phase 20's path
    (a), ``"multi_device_halo"`` on path (c) and ``"multi_device_fleet"``
    on path (d); ``"bench_scripts"`` phase 21's, K1's cases there under
    ``bench_edges`` and K3's long chain under ``bench_long``; ``"remat"``
    phase 22's) and, last,
    ``{"ok": true, ...}``.

It imports nothing of JAX or of ``mtad_gat_tpu``, and runs on the first
visible card only. Without a CUDA device it exits non-zero before printing
any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_F32_OPS = 67e12          # float32 outside the tensor cores, FLOP/s
H100_BYTES = 3.35e12          # HBM3, bytes/s
# Tolerances, kernel against its plain version on the same inputs:
# - float32: both sum the same float32 terms in another order; outputs are
#   sigmoids in (0, 1) or GRU states in (-1, 1), so a few 1e-7 apart;
# - bfloat16 K1 output: both round the same float32 value (a few 1e-7
#   apart) to bfloat16, so they can land one step apart; a step below 1.0
#   is at most 2**-8 = 0.0039;
# - scores through the whole model, float32, kernels against plain paths:
#   the per-kernel 1e-7 differences carried through the GRU chains and heads;
# - scores through the whole model, bfloat16 kernels run against the float32
#   plain paths: every layer rounds its input to bfloat16 (2**-9 relative);
#   1.7e-3 to 2.0e-3 measured on an H100 at seeds 0-2 (PERF.md), so 4e-3. It catches a
#   layer whose output is lost or cast below bfloat16 (float8 in one GRU
#   fails it), not one extra bfloat16 rounding.
K1_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-3}
# Training kernels against their plain versions on the same inputs:
# - K1-res: out and u as K1, and m, all absolute (3.1e-6 measured for m on
#   an H100, PERF.md); l, a sum of up to N terms, relative (3.0e-6 measured);
# - K2ab, K2a-c: max abs error over the plain gradient's max abs value.
#   float32: sums of up to B * N * N terms in another order, 1.1e-6 measured
#   for K2a-c; K2ab also sums each score in two interleaved parts, so its
#   weights are a few ulp from the forward's instead of equal, 2.9e-6
#   measured for it on an H100 (PERF.md), so 1e-5 for all;
#   bfloat16: dp, dq and dv are written in bfloat16, one rounding is up to
#   2**-8 of a value, so 8e-3 (da and dbias stay float32).
TRAIN_TOL = {
    torch.float32: {"forward": {"out": 2e-5, "u": 2e-5, "m": 2e-5, "l_rel": 1e-5},
                    "grad": 1e-5},
    torch.bfloat16: {"forward": {"out": 4e-3, "u": 2e-5, "m": 2e-5, "l_rel": 1e-5},
                     "grad": 8e-3},
}
# The feature layer at windows 1024 and 1200, float32: each score is a chain
# of 2,048 or 2,400 float32 terms (27 or 32 times the temporal layer's 76) in
# the tiled kernels and a pairwise sum in the plain version, and its rounding
# grows with the chain: m, u and l measured up to 8.8e-6, 7.6e-6 and 7.6e-6
# relative at window 1200, batch 8, on an H100 (PERF.md, section 6), so 4e-5
# for them; out and the gradients as at the model's widths (4.2e-7 and
# 2.5e-6 measured)
WIDE_TRAIN_TOL = {"forward": {"out": 2e-5, "u": 4e-5, "m": 4e-5, "l_rel": 4e-5}, "grad": 1e-5}
WIDE_TRAIN_CASES = ("window 1024", "window 1200")
# One epoch (7 Adam steps) at dropout 0, float32, attention through the
# kernels, or attention and GRU through theirs, against the plain paths. Per-step losses: 6.0e-8 apart on an H100
# (two runs, PERF.md), so 1e-5. Params: 3.2e-6 and 6.6e-5 apart in two runs;
# Adam divides each gradient by its running RMS, so where a gradient sits
# near 0 (entries of the score biases) a difference in its last bits can
# move that parameter by up to lr = 1e-3 a step. 1e-3 keeps a factor 15
# over the measured and still fails a wrong gradient, which moves the
# losses.
TRAIN_PATH_TOL = {"loss": 1e-5, "param": 1e-3}
K3_TOL = 2e-5
# K4 against its plain version on the same inputs (gi, saved states,
# cotangent), max abs error over the plain gradient's max abs value, float32
# arithmetic on both sides whatever gi's type. dgi: the same terms in another
# order, carried back through up to 8192 steps. dW_hh and db_hh: sums over
# B * T rows (25,600; 65,536 at (8, 8192); 262,144 at (256, 1024)), by step
# on the plain side, by row chunk in the kernel: about sqrt(rows) * 6e-8 of
# the largest term.
K4_TOL = 5e-5
SCORE_ATOL = 1e-4
BF16_SCORE_ATOL = 4e-3

def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of one call, by CUDA events around ``iters`` calls."""
    from mtad_gat_tpu_torch.utils.benchtime import pass_seconds

    for _ in range(warmup):
        fn()
    return pass_seconds(fn, iters, "cuda") * 1e3 / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of one call of fn: ``calls`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events. The
    host launches the graph once a replay, so no Python runs between the
    kernels, as it does under ``time_ms``; besides the kernels the time holds
    the call's small device work (such as a sum of partials) and the gaps
    between a graph's nodes. Outputs are allocated at capture, in the
    graph's own pool."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def ptxas_summary(log: str) -> list:
    """One line per kernel of nvcc's -Xptxas -v output: its (mangled) name,
    registers and spills."""
    lines, name = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}; {spill}")
            name = None
    return lines


def bound(ops: float, nbytes: float) -> tuple:
    """Least time on the card (ms) and what sets it."""
    t_ops, t_bytes = ops / H100_F32_OPS * 1e3, nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gat_case(gen, dev, B, N, E, D, dtype, with_bias):
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    p, q, v = r(B, N, E, scale=0.5), r(B, N, E, scale=0.5), r(B, N, D)
    a = r(E, scale=(6.0 / (E + 1)) ** 0.5)
    bias = r(N, N, scale=0.1) if with_bias else None
    return [t.to(dtype) for t in (p, q, a)] + [bias, v.to(dtype)]


def check_k1(gen, dev):
    """K1 against its plain version; returns ({dtype: worst error}, {layer:
    times of the float32 case with bias})."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    # (case, B, N, E, D, the variant and row blocks gat_fwd_plan must pick)
    cases = [("feature", 256, 38, 200, 100, "graph", 1),
             ("temporal", 256, 100, 76, 38, "graph", 1),
             ("half the rows a block", 64, 160, 128, 64, "graph", 2),
             ("many_key_tiles", 1, 2048, 32, 16, "tiled", 0),
             ("many_key_tiles", 1, 4096, 32, 16, "tiled", 0),
             ("window 1200", 2, 38, 2400, 1200, "tiled", 0)]
    path_ms = {}
    errs = []
    for name, B, N, E, D, want_variant, want_blocks in cases:
        flagship = name in ("feature", "temporal")
        for dtype in (torch.float32, torch.bfloat16):
            for with_bias in (True, False):
                if not flagship and (dtype, with_bias) != (torch.float32, True):
                    continue
                p, q, a, bias, v = gat_case(gen, dev, B, N, E, D, dtype, with_bias)
                got = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)
                launch = dict(kg.gatv2_attention_fwd.last_launch)
                again = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)
                want = kg.gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = K1_TOL[dtype]
                rec = {"phase": "k1", "case": name, "B": B, "N": N, "E": E, "D": D,
                       "dtype": str(dtype).replace("torch.", ""), "bias": with_bias,
                       **launch, "max_abs_err": err, "tol": tol,
                       "two_launches_identical": torch.equal(got, again)}
                errors = [err]
                timed = dtype == torch.float32 and with_bias and flagship
                if want_variant == "tiled":
                    # the planned tiled kernel's device time beside its bound
                    fn = lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)  # noqa: E731
                    nbytes = (2 * B * N * E + E + 2 * B * N * D) * 4 + N * N * 4
                    bound_ms, bound_by = bound(B * N * N * (4 * E + 2 * D), nbytes)
                    rec["timing"] = {"graph_ms": graph_ms(fn), "bound_ms": bound_ms,
                                     "bound_by": bound_by}
                if timed:
                    # the tiled kernel forced once at each flagship layer
                    tiled = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2, variant="tiled")
                    torch.cuda.synchronize()
                    rec["tiled_max_abs_err"] = (tiled.float() - want.float()).abs().max().item()
                    errors.append(rec["tiled_max_abs_err"])
                    rec["timing"] = t = time_k1(kg, p, q, a, bias, v, want)
                    path_ms[name] = t
                emit(rec)
                if not max(errors) <= tol or not rec["two_launches_identical"]:
                    raise AssertionError(f"K1 {name} {dtype} bias={with_bias}: max abs error "
                                         f"{errors} > {tol}, or bits differ: {rec}")
                if (launch["variant"], launch["row_blocks"]) != (want_variant, want_blocks):
                    raise AssertionError(f"K1 {name}: ran {launch}, expected the "
                                         f"{want_variant} variant on {want_blocks} row blocks")
                errs.append((dtype, max(errors)))
                if name == "many_key_tiles":
                    check_no_score_matrix(kg.gatv2_attention_fwd, p, q, a, bias, v)
    path_ms["merge"] = check_merge(kg, gen)
    return {dt: max(e for d, e in errs if d == dt) for dt in K1_TOL}, path_ms


# the merge against its plain version: slices' m within a few units of each
# other, as the slices of one row give them; float32 sums of S terms in the
# same order, exp on the card against exp on the card, so a few 1e-7: out, u
# and m absolute, l (a sum of S row sums, up to a few hundred) relative
MERGE_TOL = 2e-6


def check_merge(kg, gen) -> dict:
    """The tiled forward's merge (``gatv2_fwd_merge``) alone at the route's
    partials (16 slices, batch 1, N 8,587, D 38) against its plain version,
    twice for identical bits, with and without residuals; its device time
    by CUDA graph beside its bound (the partials read once, out, u, m and l
    written once) and the plain merge's time."""
    dev = torch.device("cuda")
    plan = kg.gat_tiled_fwd_plan(1, 8587, 76, 38, torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)
    S, N, D = plan.slices, 8587, 38
    acc = torch.randn(S, 1, N, D, generator=gen).to(dev)
    m = (3.0 * torch.randn(S, 1, N, generator=gen)).to(dev)
    l = (1.0 + 10.0 * torch.rand(S, 1, N, generator=gen)).to(dev)
    got = kg.gatv2_fwd_merge(acc, m, l)
    again = kg.gatv2_fwd_merge(acc, m, l)
    k1 = kg.gatv2_fwd_merge(acc, m, l, residuals=False)
    want = kg.gatv2_fwd_merge_plain(acc, m, l)
    torch.cuda.synchronize()
    errs = {k: (x - y).abs().max().item() for k, x, y in zip(("out", "u", "m"), got, want)}
    errs["l_rel"] = ((got[3] - want[3]).abs() / want[3]).max().item()
    errs["out_k1"] = (k1[0] - want[0]).abs().max().item()
    same = all(torch.equal(x, y) for x, y in zip(got, again)) and torch.equal(k1[0], got[0])
    nbytes = 4 * (S * N * (D + 2) + 2 * N * D + 2 * N)
    bound_ms, bound_by = bound(S * N * D * 4, nbytes)
    rec = {"phase": "k1", "case": "the tiled forward's merge at the route's partials",
           "slices": S, "N": N, "D": D, "max_abs_err": errs, "tol": MERGE_TOL,
           "two_launches_identical": same,
           "graph_ms": graph_ms(lambda: kg.gatv2_fwd_merge(acc, m, l)),
           "plain_ms": time_ms(lambda: kg.gatv2_fwd_merge_plain(acc, m, l), 5),
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    if not (max(errs.values()) <= MERGE_TOL and same):
        raise AssertionError(f"the merge differs from its plain version: {rec}")
    return rec


def time_k1(kg, p, q, a, bias, v, want) -> dict:
    """K1 at one flagship layer: a wrapper call by CUDA events (``ms``) and
    its device time from a CUDA graph of 20 calls (``graph_ms``), the same
    for the tiled kernel forced, the plain version, and the bound. Operations
    per (i, j) pair: the score 4E and the aggregate 2D; bytes: p, q, a, v and
    the bias read once, out written once. At the temporal layer also the
    whole-graph kernel with the graph's rows over two blocks (``row_blocks``
    2, two blocks a multiprocessor), beside the one block that runs."""
    B, N, E = p.shape
    D = v.shape[-1]
    size = p.dtype.itemsize
    nbytes = (2 * B * N * E + E + 2 * B * N * D) * size + (N * N * 4 if bias is not None else 0)
    bound_ms, bound_by = bound(B * N * N * (4 * E + 2 * D), nbytes)
    planned = lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)  # noqa: E731
    tiled = lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2, variant="tiled")  # noqa: E731
    out = {"ms": time_ms(planned, 20), "graph_ms": graph_ms(planned),
           "row_blocks": kg.gatv2_attention_fwd.last_launch["row_blocks"],
           "tiled_ms": time_ms(tiled, 20), "tiled_graph_ms": graph_ms(tiled),
           "plain_ms": time_ms(lambda: kg.gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2), 3),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if out["row_blocks"] == 1 and N > 64:
        lib = kg._fwd_lib()
        halves = torch.full_like(v, float("nan"))     # a row left unwritten fails the check
        fn = lib.gatv2_fwd_f32 if p.dtype == torch.float32 else lib.gatv2_fwd_bf16

        def two_blocks():
            err = fn(p.data_ptr(), q.data_ptr(), a.data_ptr(), bias.data_ptr(), v.data_ptr(),
                     halves.data_ptr(), B, N, E, D, 2, B, 0.2,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"gatv2_fwd with two row blocks: CUDA error {err}")

        two_blocks()
        torch.cuda.synchronize()
        err = (halves.float() - want.float()).abs().max().item()
        if not err <= K1_TOL[p.dtype]:
            raise AssertionError(f"K1 with two row blocks: max abs error {err}")
        out["two_row_blocks_graph_ms"] = graph_ms(two_blocks)
        out["two_row_blocks_max_abs_err"] = err
    return out


def check_no_score_matrix(kernel, p, q, a, bias, v) -> None:
    """The kernel allocates its output and nothing of (N, N) size: the
    point of the fused attention is that the score matrix never exists in
    device memory."""
    N = p.shape[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernel(p, q, a, bias, v, 0.2)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    emit({"phase": "k1", "case": "device memory of one call", "N": N,
          "peak_extra_bytes": extra, "score_matrix_bytes": N * N * 4})
    if extra >= N * N * 4:
        raise AssertionError(f"K1 allocated {extra} bytes at N={N}")


def gru_case(gen, dev, B, T, H, dtype):
    """A seeded torch.nn.GRU (cuDNN's layout is the port's), its input x and
    the scan's arguments gi, w_hh (H, 3H), b_hh."""
    gru = torch.nn.GRU(H, H, batch_first=True)
    with torch.no_grad():
        for prm in gru.parameters():
            prm.uniform_(-H ** -0.5, H ** -0.5, generator=gen)
    gru = gru.to(dev)
    x = torch.randn(B, T, H, generator=gen).to(dev)
    with torch.no_grad():
        gi = (x @ gru.weight_ih_l0.t() + gru.bias_ih_l0).to(dtype)
    return gru, x, gi, gru.weight_hh_l0.detach().t(), gru.bias_hh_l0.detach()


# (case, B, T, H, gi's type, variant the planner must pick); the first is timed
K3_CASES = (
    ("flagship", 256, 100, 150, torch.float32, "cluster"),
    ("flagship", 256, 100, 150, torch.bfloat16, "cluster"),
    ("long", 256, 1024, 150, torch.float32, "cluster"),
    ("one step", 256, 1, 150, torch.float32, "cluster"),
    ("batch 1", 1, 100, 150, torch.float32, "cluster"),
    ("ragged batch", 43, 100, 150, torch.float32, "cluster"),
    ("even slices", 64, 100, 64, torch.float32, "cluster"),
    ("larger cluster", 64, 100, 200, torch.float32, "cluster"),
    ("wide", 64, 100, 512, torch.float32, "streaming"),
)


def check_k3(gen, dev):
    from mtad_gat_tpu_torch.kernels.gru import gru_scan_fwd, gru_scan_fwd_plain

    result = batch1 = None
    errs = []
    for name, B, T, H, dtype, variant in K3_CASES:
        gru, x, gi, w_hh, b_hh = gru_case(gen, dev, B, T, H, dtype)
        w_hh = w_hh.contiguous()
        with torch.no_grad():
            got, _ = gru_scan_fwd(gi, w_hh, b_hh, H)
            want, _ = gru_scan_fwd_plain(gi, w_hh, b_hh, H)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ms = time_ms(lambda: gru_scan_fwd(gi, w_hh, b_hh, H), 10)
        nbytes = B * T * 3 * H * dtype.itemsize + (H * 3 * H + 3 * H) * 4 + B * T * H * 4
        bound_ms, bound_by = bound(2 * B * T * H * 3 * H, nbytes)
        rec = {"phase": "k3", "case": name, "B": B, "T": T, "H": H,
               "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": K3_TOL,
               "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
               **gru_scan_fwd.last_launch}
        if result is None:
            with torch.no_grad():
                rec["plain_ms"] = time_ms(lambda: gru_scan_fwd_plain(gi, w_hh, b_hh, H), 2,
                                          warmup=1)
                rec["library_ms"] = time_ms(lambda: gru(x), 10)
                rec["projection_ms"] = time_ms(
                    lambda: x @ gru.weight_ih_l0.t() + gru.bias_ih_l0, 10)
            rec["library"] = ("torch.nn.GRU (cuDNN), input projection included; "
                              "projection_ms is x @ W_ih^T + b_ih alone")
            result = dict(rec)
        emit(rec)
        if not err <= K3_TOL:
            raise AssertionError(f"K3 {name} {dtype}: max abs error {err} > {K3_TOL}")
        if rec["variant"] != variant:
            raise AssertionError(f"K3 {name}: ran the {rec['variant']} variant, "
                                 f"expected {variant}")
        errs.append(err)
        if name == "batch 1":
            batch1 = rec          # the serving path's chain at chunk 1
    return max(errs), result, batch1


def write_smd(root: str, n: int = 2000, anomaly: float = 0.4, group: str = "1-1",
              seed: int = 0) -> None:
    """The synthetic SMD entity of the repo's verify recipe (n rows of train
    and of test, the anomaly at rows ``anomaly`` n to that plus n / 40 of
    the test split), as machine ``group`` from ``seed``."""
    rng = np.random.default_rng(seed)
    k = 38
    base = np.sin(np.linspace(0, 60, n))[:, None] * rng.uniform(.5, 1.5, k) \
        + rng.standard_normal((n, k)) * .1
    test = base.copy()
    a0 = int(anomaly * n)
    a1 = a0 + n // 40
    test[a0:a1] += 3.0
    label = np.zeros(n, np.float32)
    label[a0:a1] = 1
    d = os.path.join(root, "ServerMachineDataset", "processed")
    os.makedirs(d, exist_ok=True)
    for nm, arr in [(f"machine-{group}_train", base.astype(np.float32)),
                    (f"machine-{group}_test", test.astype(np.float32)),
                    (f"machine-{group}_test_label", label)]:
        with open(os.path.join(d, f"{nm}.pkl"), "wb") as f:
            pickle.dump(arr, f)


def score_run(work, data_root, name, state_dict, **cfg_kw):
    """Write a run directory and score it through predict_cli on the card;
    returns (summary, {split: frame}, K1 launches, K3 launches)."""
    import pandas as pd

    from mtad_gat_tpu_torch.cli import predict_cli
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.kernels.gat import gatv2_attention_fwd
    from mtad_gat_tpu_torch.kernels.gru import gru_scan_fwd

    out_root = os.path.join(work, name)
    run = os.path.join(out_root, "SMD", "1-1", "01012026_000000")
    os.makedirs(run)
    RunConfig(dataset="SMD", group="1-1", **cfg_kw).save(os.path.join(run, "config.txt"))
    torch.save(state_dict, os.path.join(run, "model.pt"))
    argv = ["--dataset", "SMD", "--group", "1-1", "--model_id", "-1",
            "--data_root", data_root, "--output_root", out_root, "--device", "cuda"]
    gatv2_attention_fwd.launches = 0
    gatv2_attention_fwd.launches_by_variant = {"graph": 0, "tiled": 0}
    gru_scan_fwd.launches = 0
    predict_cli.main(argv)
    k1, k3 = gatv2_attention_fwd.launches, gru_scan_fwd.launches
    if gatv2_attention_fwd.launches_by_variant["graph"] != k1:
        raise AssertionError(f"{name}: K1 ran {gatv2_attention_fwd.launches_by_variant}, "
                             "expected the whole-graph kernel at both layers")
    with open(os.path.join(run, "summary.txt")) as f:
        summary = json.load(f)
    for key in ("epsilon_result", "pot_result", "bf_result"):
        if key not in summary:
            raise AssertionError(f"{name}: summary.txt lacks {key}")
        for k, val in summary[key].items():
            if not np.all(np.isfinite(val)):
                raise AssertionError(f"{name}: {key}.{k} = {val}")
    frames = {s: pd.read_pickle(os.path.join(run, f"{s}_output.pkl")) for s in ("train", "test")}
    return summary, frames, k1, k3


def score_errors(got: dict, ref: dict) -> dict:
    """Max abs difference of two runs' output frames over both splits, by
    column family (Forecast_, Recon_, A_Score_)."""
    errs = {}
    for fam in ("Forecast_", "Recon_", "A_Score_"):
        errs[fam] = max(
            float(np.max(np.abs(got[s][c].to_numpy() - ref[s][c].to_numpy())))
            for s in ("train", "test") for c in ref[s].columns if c.startswith(fam))
    return errs


def check_main_path(gen, dev, work):
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.inference import Predictor
    from mtad_gat_tpu_torch.models import MTADGAT

    data_root = os.path.join(work, "data")
    write_smd(data_root)
    flagship = RunConfig()          # the reference's SMD defaults: lookback 100, bs 256
    model = MTADGAT(flagship.model_config(38, 38), generator=gen)
    state_dict = model.state_dict()
    (x_train, _), (x_test, _) = get_data("machine-1-1", data_root=data_root, normalize=True)
    w, bs = flagship.lookback, flagship.bs
    n_batches = sum(-(-(len(s) - w + 1) // bs) for s in (x_train, x_test))

    runs = {}
    launches = {}
    for name, kw in (("kernels_f32", dict(attention_impl="pallas", gru_impl="pallas")),
                     ("kernels_bf16", dict(attention_impl="pallas", gru_impl="pallas",
                                           compute_dtype="bfloat16")),
                     ("plain_f32", dict(attention_impl="dense", gru_impl="xla"))):
        t0 = time.perf_counter()
        summary, frames, k1, k3 = score_run(work, data_root, name, state_dict, **kw)
        seconds = time.perf_counter() - t0
        runs[name] = frames
        want = (2 * n_batches, 2 * n_batches) if name.startswith("kernels") else (0, 0)
        emit({"phase": "main_path", "run": name, "seconds": seconds,
              "scoring_batches": n_batches, "k1_launches": k1, "k3_launches": k3,
              "expected_launches": list(want),
              "bf_f1": summary["bf_result"]["f1"], "epsilon_f1": summary["epsilon_result"]["f1"],
              "pot_f1": summary["pot_result"]["f1"]})
        if (k1, k3) != want:
            raise AssertionError(f"{name}: launches K1={k1} K3={k3}, expected {want}")
        if name.startswith("kernels"):
            launches = launches or {"k1": k1, "k3": k3}

    for run, tol in (("kernels_f32", SCORE_ATOL), ("kernels_bf16", BF16_SCORE_ATOL)):
        errs = score_errors(runs[run], runs["plain_f32"])
        worst = max(errs.values())
        emit({"phase": "main_path", "check": f"{run} vs plain_f32 scores",
              "max_abs_err": worst, "by_column_family": errs, "tol": tol})
        if not worst <= tol:
            raise AssertionError(f"{run} scores differ from plain_f32 by {worst} > {tol}")

    rates = {}
    for dtype in ("float32", "bfloat16"):
        cfg = RunConfig(attention_impl="pallas", gru_impl="pallas", compute_dtype=dtype)
        m = MTADGAT(cfg.model_config(38, 38))
        m.load_state_dict(state_dict)
        pred = Predictor(m.to(dev), w, 38, {
            "dataset": "SMD", "target_dims": None, "scale_scores": False, "q": 1e-3,
            "level": 0.99, "dynamic_pot": False, "use_mov_av": False, "gamma": 1.0,
            "reg_level": 1, "save_path": work}, batch_size=bs)
        best = 0.0
        for _ in range(3):
            pred.get_score(x_test)
            best = max(best, pred.last_windows_per_s)
        rates[dtype] = best
        if dtype == "float32":
            pred_f32 = pred
    emit({"phase": "main_path", "scoring_windows_per_s": rates,
          "windows": len(x_test) - w + 1, "batch": bs})
    emit(profile_scoring(pred_f32, x_test))
    return launches


def profile_scoring(pred, series) -> dict:
    """Device time by kernel over one float32 scoring pass."""
    return profile_device(lambda: pred.get_score(series),
                          "get_score, test split, float32, kernels on")


def profile_device(fn, what: str, top: int = 12) -> dict:
    """Device time by kernel over one call of ``fn``, from torch.profiler;
    busy share = summed kernel and copy time over the call's wall time (the
    profiler's own cost is in the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an operator's own row also reports the time
    # of the kernels it launched, which would count them twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"phase": "profile", "pass": what,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms if rows else None,
            "busy_share": busy_ms / wall_ms if rows else None,
            "top": [{"kernel": k[:120], "ms": ms, "calls": n} for k, ms, n in rows[:top]]}


# ---------------------------------------------------------------------------
# Training: K1-res and K2a-c, then the training path through train_cli
# ---------------------------------------------------------------------------


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference over the reference's max abs value."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(want.float().abs().max().item(), 1e-30)


def grad_errors(outs, ref, dbias=None):
    """({name: error over the plain gradient's max abs value}, {name: max
    abs error}) of (dp, dq, da, dv) and dbias against the plain backward."""
    grads = {"dp": (outs[0], ref[0]), "dq": (outs[1], ref[1]), "da": (outs[2], ref[2]),
             "dv": (outs[3], ref[4])}
    if dbias is not None:
        grads["dbias"] = (dbias, ref[3])
    return ({k: rel_err(x, y) for k, (x, y) in grads.items()},
            {k: (x.float() - y.float()).abs().max().item() for k, (x, y) in grads.items()})


def tiled_bwd(kg, args, dbias: bool = False) -> tuple:
    """(dp, dq, da, dv, dbias) through the tiled K2a then K2b, whatever the
    plan, K2b summing dbias with ``dbias`` (else None)."""
    dp, da = kg.gatv2_bwd_dp_da(*args)
    dq, dv, db = kg.gatv2_bwd_dq_dv(*args, dbias=dbias)
    return dp, dq, da, dv, db


def same_bits(xs, ys) -> bool:
    """Equal bits, element for element, of two launches' outputs (None
    where neither has one)."""
    return all((x is None and y is None) or (x is not None and y is not None
                                               and torch.equal(x, y)) for x, y in zip(xs, ys))


def tiled_plans(kg) -> dict:
    """The launches of the last tiled K2a and K2b (``gat_tiled_bwd_plan``):
    tile, running sums in shared memory, slices, blocks, shared
    memory and partial bytes."""
    return {name: fn.last_plan._asdict()
            for name, fn in (("k2a", kg.gatv2_bwd_dp_da), ("k2b", kg.gatv2_bwd_dq_dv))
            if fn.last_plan is not None}


# the kernel each gradient of the backward comes from, by variant (and K2c
# forced on its own, on no path since dbias comes from K2ab, K2b and the
# streamed backward)
GRAD_KERNELS = {"graph": {"dp": "k2ab", "dq": "k2ab", "da": "k2ab", "dv": "k2ab",
                          "dbias": "k2ab"},
                "tiled": {"dp": "k2a", "da": "k2a", "dq": "k2b", "dv": "k2b", "dbias": "k2b"},
                "streamed": dict.fromkeys(("dp", "dq", "da", "dv", "dbias"), "streamed"),
                "k2c": {"dbias": "k2c"}}


def streamed_layout(kg, B: int, N: int, E: int, D: int, sms: int) -> dict:
    """The streamed backward's plan (``gat_streamed_bwd_plan``, with dbias)
    and the built library's layout at its row tile and rows a thread
    (threads, shared memory, key registers, columns, chunk, NMAX, buffers),
    which must agree, and each pass's blocks a multiprocessor by CUDA's
    occupancy calculator: the most, and the score pass's as launched
    (ceil(blocks / sms)), with their warps."""
    import ctypes

    pl = kg.gat_streamed_bwd_plan(B, N, E, D, sms, dbias=True)
    lib = kg._streamed_lib()
    out = (ctypes.c_long * 8)()
    lib.gatv2_streamed_layout(N, pl.rows, pl.rows_per_thread, out)
    # (pass, bfloat16 outputs, dropout): the score pass reads float32 and
    # instantiates by dropout, the contraction pass by its output type
    kinds = {"score": (0, 0, 0), "score_dropout": (0, 0, 1), "contract": (1, 0, 0),
             "contract_bf16": (1, 1, 0)}
    occ = {name: lib.gatv2_streamed_occupancy(which, N, pl.rows, pl.rows_per_thread, bf16, drop,
                                              0)
           for name, (which, bf16, drop) in kinds.items()}
    launched = -(-pl.score_blocks // sms)
    return {"plan": pl._asdict(),
            "library": dict(zip(("score_threads", "score_smem_bytes", "key_regs", "cols",
                                 "contract_smem_bytes", "chunk", "nmax", "ring"), out)),
            "planned": (pl.score_threads, pl.score_smem_bytes, pl.key_regs, pl.cols,
                        pl.contract_smem_bytes, pl.chunk, kg.STREAMED_NMAX, kg.STREAMED_RING),
            "occupancy_blocks": occ,
            "score_blocks_a_multiprocessor": launched,
            "score_warps_a_multiprocessor": launched * pl.score_threads // 32,
            "score_warps_most": occ["score_dropout"] * pl.score_threads // 32,
            "contract_warps_most": occ["contract"] * pl.cols // 32}


def k2b_group(kg, lib, B: int, N: int, E: int, D: int, sms: int) -> dict:
    """The tiled K2b's batch group with dbias and its partials' bytes, as
    the plan gives them and as the built library's own rule does, and its
    blocks a multiprocessor (float32, dropout) with and without dbias: the
    fold must not cost it a block."""
    pl = kg.gat_tiled_bwd_plan(B, N, E, D, sms, dbias=True)["k2b"]
    built = lib.gatv2_bwd_tiled_dbias_group(B, N, pl.tile, sms, B)
    return {"planned": pl.group, "library": built, "tile": kg.TILED_TILE_NAMES[pl.tile],
            "dbias_bytes": pl.dbias_bytes, "library_dbias_bytes": -(-B // built) * N * N * 4,
            "occupancy": {"dbias" if db else "no_dbias": lib.gatv2_bwd_tiled_occupancy(
                1, pl.tile, E, D, int(pl.acc_smem), 1, db, 0) for db in (0, 1)}}


def k2b_group_cost(kg, args, ref, outs, sms: int, tol: float) -> dict:
    """The tiled K2b with dbias at its planned batch group G and at 2G,
    each forced through the launcher with the slices the plan sets for that
    many groups: its dq, dv and dbias (the groups' partials summed in order)
    against the plain backward ``ref`` within ``tol`` of the largest value,
    two launches' bits, the planned one's bits against the wrapper's
    ``outs`` (dp, dq, da, dv, dbias), its blocks and partials' bytes, and
    its device time by CUDA graph, the partials' sum included. Forced
    launches add nothing to the launch counts. Raises where one is off."""
    p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate = args
    B, N, E = p.shape
    D = v.shape[-1]
    planned = kg._tiled_plan(B, N, E, D, sms, True)["k2b"]
    f32 = dict(dtype=torch.float32, device=p.device)
    pairs = B * N * N
    in_bytes = (2 * B * N * E + E + B * N * D) * 4 + N * N * 4
    stats_bytes = 3 * B * N * 4 + B * N * D * 4
    out = {"B": B, "N": N, "E": E, "D": D, "planned_group": planned.group}
    for G in (planned.group, 2 * planned.group):
        groups = -(-B // G)
        slices = kg.tiled_slices(groups * planned.own_tiles, planned.stream_tiles, sms)
        plan = planned._replace(group=G, slices=slices,
                                blocks=slices * groups * planned.own_tiles,
                                partial_bytes=4 * slices * B * N * (E + D),
                                dbias_bytes=4 * groups * N * N)

        def call(plan=plan, groups=groups):
            dq, dv = torch.empty_like(q), torch.empty_like(v)
            dpart = torch.empty((groups, N, N), **f32)
            part = torch.empty((plan.slices, B, N, E + D), **f32)
            kg._tiled_launch(plan, p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate,
                             (dq, dv, dpart, part))
            return dq, dv, dpart.sum(dim=0) if groups > 1 else dpart[0]

        got, again = call(), call()
        torch.cuda.synchronize()
        errs = {"dq": rel_err(got[0], ref[1]), "dv": rel_err(got[1], ref[4]),
                "dbias": rel_err(got[2], ref[3])}
        # the partials' write and read beyond dbias's own bound
        bound_ms, bound_by = bound(pairs * (5 * E + 4 * D + 5),
                                   in_bytes + stats_bytes + B * N * (E + D) * 4 + N * N * 4
                                   + (2 * plan.dbias_bytes if groups > 1 else 0))
        rec = {"group": G, "groups": groups, "slices": slices, "blocks": plan.blocks,
               "blocks_a_multiprocessor": plan.blocks / sms,
               "dbias_partial_bytes": plan.dbias_bytes, "grad_rel_err": errs,
               "two_launches_identical": same_bits(got, again),
               "graph_ms": graph_ms(call, calls=5, replays=3),
               "bound_with_partials_ms": bound_ms, "bound_by": bound_by}
        if G == planned.group:
            rec["identical_to_the_wrapper"] = same_bits(got, (outs[1], outs[3], outs[4]))
        out[f"g{G}"] = rec
        if not (max(errs.values()) <= tol and rec["two_launches_identical"]
                and rec.get("identical_to_the_wrapper", True)):
            raise AssertionError(f"the tiled K2b with dbias at group {G}: {rec}")
    emit({"phase": "training_kernels", "case": "the tiled K2b with dbias at its planned batch "
          "group and at twice it, forced", **out})
    return out


def graph_occupancy(lib, N: int, E: int, D: int, grouped: int = 0) -> dict:
    """Blocks of each K2ab instantiation (type, dropout, dbias; the grouped
    one with ``grouped``) that one multiprocessor holds at once, by CUDA's
    occupancy calculator."""
    return {f"{dt}{'_dropout' if drop else ''}{'_dbias' if db else ''}":
            lib.gatv2_bwd_graph_occupancy(N, E, D, dt == "bf16", drop, db, grouped)
            for dt in ("f32", "bf16") for drop in (0, 1) for db in (0, 1)}


def check_training_kernels(gen, dev):
    """K1-res and the attention backward against their plain versions at the
    training shapes, dbias from K2ab where the plan says "graph" and from K2b
    where it says "tiled" (and from the tiled K2b forced at the flagship
    layers), and K2c forced wherever there is a bias; returns
    ({kernel: worst f32 error}, {kernel: worst relative error}, {kernel:
    {layer: times}})."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    # (case, B, N, E, D, the forward and backward gat_fwd_plan and
    # gat_bwd_plan must pick, and the backward gat_bwd_route must run)
    cases = [("feature", 256, 38, 200, 100, "graph", "graph", "graph"),
             ("temporal", 256, 100, 76, 38, "graph", "graph", "graph"),
             ("many_key_tiles", 1, 2048, 32, 16, "tiled", "tiled", "tiled"),
             ("many_key_tiles", 1, 4096, 32, 16, "tiled", "tiled", "tiled"),
             ("widest", 1, 300, 470, 235, "tiled", "tiled", "tiled"),
             ("batch groups", 17, 2048, 32, 16, "tiled", "tiled", "tiled"),
             ("window 300", 64, 38, 600, 300, "graph", "tiled", "streamed"),
             ("window 1200", 8, 38, 2400, 1200, "tiled", "tiled", "streamed"),
             ("lookback 1024", 64, 1024, 76, 38, "tiled", "tiled", "tiled"),
             ("window 1024", 64, 38, 2048, 1024, "tiled", "tiled", "streamed")]
    # the tiled cases: planned (not forced), float32 at dropout 0.3 with bias;
    # "widest" is the feature layer at window 235, the widest whole rows of
    # the tiled backward's WIDE tile take; "batch groups" a batch at which
    # K2b with dbias takes two batch elements a block (nine groups, the last
    # of one: tiled_dbias_groups on 132 multiprocessors); windows 300 and
    # 1200 the feature layer beyond, where the tiled plan names the CHUNKED
    # tile and the streamed backward runs instead (the CHUNKED K2a and K2b,
    # the tiled forward and K2c's chunked staging forced there; window 300
    # plans the whole-graph forward, and runs dropout 0 without bias and
    # bfloat16 too); "lookback 1024" and "window 1024" the two layers of
    # long_complete's batch-64 run at its shapes (the FAST K2b with dbias in
    # 64 groups of one; the streamed backward)
    tiled_cases = ("many_key_tiles", "widest", "batch groups", "window 300", "window 1200",
                   "lookback 1024", "window 1024")
    variants = [(torch.float32, r, b) for r in (0.0, 0.3) for b in (True, False)]
    variants.append((torch.bfloat16, 0.3, True))
    more = {"window 300": ((torch.float32, 0.0, False), (torch.bfloat16, 0.3, True))}
    worst = {k: 0.0 for k in ("k1res", "k2ab", "k2a", "k2b", "k2c", "streamed")}
    worst_rel = dict(worst)
    times = {k: {} for k in worst}
    times["wide"], times["k2b_dbias"] = {}, {}
    lib = kg._bwd_lib()
    for name, B, N, E, D, want_fwd, want_plan, want_route in cases:
        plan = kg.gat_bwd_plan(N, E, D)
        route = kg.gat_bwd_route(N, E, D)
        wide = name.startswith("window")
        smem = {"planned": kg.gat_bwd_smem_bytes(N, E, D),
                "library": lib.gatv2_bwd_smem_bytes(3, N, E, D)}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        group = {"planned": kg.dbias_groups(B, sms),
                 "library": lib.gatv2_bwd_graph_dbias_group(B, sms)}
        rec = {"phase": "training_kernels", "case": f"{name} backward plan", "N": N, "E": E,
               "D": D, "B": B, "plan": plan, "expected": want_plan, "route": route,
               "expected_route": want_route, "k2ab_smem_bytes": smem,
               "dbias_group": group, "sms": sms}
        if route == "streamed":
            rec["streamed"] = layout = streamed_layout(kg, B, N, E, D, sms)
            if tuple(layout["library"].values()) != layout["planned"]:
                raise AssertionError(f"{name}: the streamed backward's plan and the built "
                                     f"library's layout differ: {layout}")
        if plan == "graph":
            rec["k2ab_occupancy"] = graph_occupancy(lib, N, E, D)
            rec["dbias_partial_bytes"] = -(-B // group["planned"]) * N * N * 4
        # the tiled K2b with dbias: planned where the plan says "tiled",
        # forced at the flagship layers
        rec["k2b_dbias_group"] = k2b = k2b_group(kg, lib, B, N, E, D, sms)
        emit(rec)
        occ = k2b["occupancy"]
        if (plan != want_plan or route != want_route or smem["planned"] != smem["library"]
                or group["planned"] != group["library"]
                or k2b["planned"] != k2b["library"]
                or k2b["dbias_bytes"] != k2b["library_dbias_bytes"]
                or not 0 < occ["dbias"] == occ["no_dbias"]):
            raise AssertionError(f"{name}: plan {plan}, expected {want_plan}; K2ab shared "
                                 f"memory {smem}, dbias group {group}; the tiled K2b's group, "
                                 f"partials and blocks a multiprocessor {k2b}")
        for dtype, rate, with_bias in variants:
            if name in tiled_cases and (dtype, rate, with_bias) not in (
                    ((torch.float32, 0.3, True),) + more.get(name, ())):
                continue
            p, q, a, bias, v = gat_case(gen, dev, B, N, E, D, dtype, with_bias)
            seed = torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64).to(dev)
            got = kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate)
            fwd_variant = kg.gatv2_attention_res.last_launch["variant"]
            fwd_again = kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate)
            want = kg.gatv2_attention_res_plain(p, q, a, bias, v, 0.2, seed, rate)
            out, u = got[0], got[1]
            sig = torch.sigmoid(u)
            du = torch.randn(B, N, D, generator=gen).to(dev) * sig * (1 - sig)
            dvec = (du * u).sum(-1)
            args = (p, q, a, bias, v, got[2], got[3], du, dvec, 0.2, seed, rate)
            outs = kg.gatv2_bwd(*args, dbias=with_bias)
            launch = dict(kg.gatv2_bwd.last_launch)
            variant = launch["variant"]
            again = kg.gatv2_bwd(*args, dbias=with_bias)
            ref = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2, seed, rate)
            timed = name not in tiled_cases and dtype == torch.float32 and rate > 0 and with_bias
            # the tiled kernels once at each flagship layer and each streamed
            # shape (twice, for identical bits), K2b with dbias where there is a
            # bias, so each tile stays covered, and K2c on its own wherever
            # there is a bias
            forced = timed or (wide and route == "streamed")
            tiled = tiled_bwd(kg, args, dbias=with_bias) if forced else None
            tiled_again = tiled_bwd(kg, args, dbias=with_bias) if forced else None
            k2c = (kg.gatv2_bwd_dbias(*args, variant="chunked") if wide and with_bias
                   else kg.gatv2_bwd_dbias(*args) if with_bias else None)
            k2c_again = (kg.gatv2_bwd_dbias(*args, variant="chunked") if wide and with_bias
                         else None)
            tiled_fwd = (kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate,
                                                variant="tiled") if timed or wide else None)
            tiled_fwd_again = (kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate,
                                                      variant="tiled") if wide else None)
            torch.cuda.synchronize()
            errs = forward_errors(got, want)
            gerr, gabs = grad_errors(outs, ref, outs[4])
            tol = WIDE_TRAIN_TOL if name in WIDE_TRAIN_CASES else TRAIN_TOL[dtype]
            rec = {"phase": "training_kernels", "case": name, "B": B, "N": N, "E": E, "D": D,
                   "dtype": str(dtype).replace("torch.", ""), "bias": with_bias,
                   "dropout": rate, "forward": fwd_variant, "backward": variant,
                   "dbias_from": launch["dbias"],
                   "forward_err": errs, "grad_rel_err": gerr, "grad_abs_err": gabs, "tol": tol,
                   "forward_two_launches_identical": all(
                       torch.equal(x, y) for x, y in zip(got, fwd_again))}
            runs = [(variant, gerr, gabs)]
            bad = [k for k, e in errs.items() if not e <= tol["forward"][k]]
            if tiled_fwd is not None:
                rec["tiled_forward_err"] = terr_fwd = forward_errors(tiled_fwd, want)
                bad += [f"tiled {k}" for k, e in terr_fwd.items() if not e <= tol["forward"][k]]
            if wide:
                rec["tiled_forward_two_launches_identical"] = all(
                    torch.equal(x, y) for x, y in zip(tiled_fwd, tiled_fwd_again))
                rec["k2c_chunked_two_launches_identical"] = (
                    k2c is None or torch.equal(k2c, k2c_again))
                rec["k2c_dbias_from"] = "chunked, forced"
                if not (rec["tiled_forward_two_launches_identical"]
                        and rec["k2c_chunked_two_launches_identical"]):
                    bad.append("bits of the forced tiled forward or chunked K2c")
            rec["two_launches_identical"] = same_bits(outs, again)
            if variant == "tiled" or tiled is not None:
                rec["tiled_plan"] = tiled_plans(kg)
            if variant == "streamed":
                rec["streamed_plan"] = kg.gatv2_bwd_streamed.last_plan._asdict()
            if tiled is not None:
                terr, tabs = grad_errors(tiled, ref, tiled[4])
                rec["tiled_grad_rel_err"], rec["tiled_grad_abs_err"] = terr, tabs
                rec["tiled_two_launches_identical"] = same_bits(tiled, tiled_again)
                runs.append(("tiled", terr, tabs))
            if k2c is not None:
                rec["k2c_dbias_rel_err"] = rel_err(k2c, ref[3])
                rec["k2c_dbias_abs_err"] = (k2c - ref[3]).abs().max().item()
                runs.append(("k2c", {"dbias": rec["k2c_dbias_rel_err"]},
                             {"dbias": rec["k2c_dbias_abs_err"]}))
            want_dbias = None if not with_bias else kg.dbias_kernel(N, E, D)
            if timed:
                rec["timing"] = t = time_training_kernels(kg, p, q, a, bias, v, du, dvec,
                                                          got[2], got[3], seed, rate)
                for k in t:
                    if k in times:
                        times[k][name] = t[k]
            if wide and (dtype, rate, with_bias) == (torch.float32, 0.3, True):
                rec["timing"] = t = time_wide_kernels(kg, args, du)
                t.update(grad_abs_err=gabs, grad_rel_err=gerr,
                         k2c_chunked_abs_err=rec["k2c_dbias_abs_err"],
                         k1res_tiled_err=rec["tiled_forward_err"], B=B, N=N, E=E, D=D)
                if tiled is not None:
                    t.update(chunked_grad_abs_err=tabs, chunked_grad_rel_err=terr)
                times["wide"][name] = t
            emit(rec)
            bad += [f"{run} {k}" for run, rel, _ in runs for k, e in rel.items()
                    if not e <= tol["grad"]]
            if (bad or variant != want_route or fwd_variant != want_fwd
                    or launch["dbias"] != want_dbias
                    or not rec["two_launches_identical"]
                    or rec.get("tiled_two_launches_identical") is False
                    or not rec["forward_two_launches_identical"]):
                raise AssertionError(f"training kernels {name} {dtype} dropout={rate} "
                                     f"bias={with_bias}: {bad} beyond tolerance, or the "
                                     f"{fwd_variant} forward or {variant} backward ran, or "
                                     f"dbias came from {launch['dbias']}, not {want_dbias}, "
                                     f"or bits differ: {rec}")
            if dtype == torch.float32:
                worst["k1res"] = max(worst["k1res"], errs["out"], errs["u"],
                                     *([] if tiled_fwd is None else
                                       [terr_fwd["out"], terr_fwd["u"]]))
                for run, rel, absolute in runs:
                    for k in rel:
                        key = GRAD_KERNELS[run][k]
                        worst[key] = max(worst[key], absolute[k])
                        worst_rel[key] = max(worst_rel[key], rel[k])
            if name in ("many_key_tiles", "batch groups", "lookback 1024", "window 1024"):
                check_training_memory(kg, p, q, a, bias, v, du, dvec, seed, rate)
            if name == "lookback 1024":
                times["k2b_groups"] = k2b_group_cost(kg, args, ref, outs, sms, tol["grad"])
    check_w_bits(kg, torch.device("cuda"), gen)
    return worst, worst_rel, times


def time_wide_kernels(kg, args, du) -> dict:
    """At a width beyond the first design's (where the tiled plan names the
    CHUNKED tile): the streamed backward (planned there, with and without
    dbias), the tiled K1-res (forced), the CHUNKED K2a and K2b (K2b with and
    without dbias) and the two together with dbias (``chunked_pair``: the
    yardstick the streamed backward replaces), K2c (and its chunked staging
    forced), each its device time by CUDA graph beside its bound as
    ``time_training_kernels`` counts it, their plans, and the plain
    backward's time."""
    p, q, a, bias, v, m, l, _, dvec, alpha, seed, rate = args
    B, N, E = p.shape
    D = v.shape[-1]
    in_bytes = (2 * B * N * E + E + B * N * D) * 4 + N * N * 4
    stats_bytes = 3 * B * N * 4 + B * N * D * 4
    pairs = B * N * N
    spec = {
        "k1res": (lambda: kg.gatv2_attention_res(p, q, a, bias, v, alpha, seed, rate,
                                                 variant="tiled"),
                  pairs * (4 * E + 2 * D), in_bytes + B * N * D * 8 + 2 * B * N * 4),
        "k2a": (lambda: kg.gatv2_bwd_dp_da(*args), pairs * (7 * E + 2 * D + 4),
                in_bytes + stats_bytes + B * N * E * 4 + E * 4),
        "k2b": (lambda: kg.gatv2_bwd_dq_dv(*args), pairs * (5 * E + 4 * D + 4),
                in_bytes + stats_bytes + B * N * (E + D) * 4),
        "k2b_dbias": (lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True),
                      pairs * (5 * E + 4 * D + 5),
                      in_bytes + stats_bytes + B * N * (E + D) * 4 + N * N * 4),
        "k2c": (lambda: kg.gatv2_bwd_dbias(*args), pairs * (4 * E + 2 * D + 4),
                in_bytes + stats_bytes + N * N * 4),
        "k2c_chunked": (lambda: kg.gatv2_bwd_dbias(*args, variant="chunked"),
                        pairs * (4 * E + 2 * D + 4), in_bytes + stats_bytes + N * N * 4),
        # K2ab's count: both contractions and dbias from one score a pair
        "streamed": (lambda: kg.gatv2_bwd_streamed(*args, dbias=True),
                     pairs * (8 * E + 4 * D + 5),
                     in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4),
        "streamed_no_dbias": (lambda: kg.gatv2_bwd_streamed(*args),
                              pairs * (8 * E + 4 * D + 4),
                              in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4),
        "chunked_pair": (lambda: tiled_bwd(kg, args, dbias=True), pairs * (8 * E + 4 * D + 5),
                         in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4),
    }
    out = {}
    for k, (fn, ops, nbytes) in spec.items():
        bound_ms, bound_by = bound(ops, nbytes)
        out[k] = {"graph_ms": graph_ms(fn, calls=5, replays=3), "bound_ms": bound_ms,
                  "bound_by": bound_by}
        out[k]["over_bound"] = out[k]["graph_ms"] / bound_ms
    out["k1res"]["plan"] = kg.gatv2_attention_res.last_launch["plan"]
    out["plain_bwd_ms"] = time_ms(lambda: kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du,
                                                                       alpha, seed, rate),
                                  1, warmup=1)
    out["plans"] = tiled_plans(kg)
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    out["streamed"]["layout"] = streamed_layout(kg, B, N, E, D, sms)
    out["streamed"]["chunked_pair_over_streamed"] = (out["chunked_pair"]["graph_ms"]
                                                     / out["streamed"]["graph_ms"])
    return out


def check_w_bits(kg, dev, gen) -> None:
    """The tiled K2b recomputes the tiled K1-res's weights bit for bit at
    each tile (FAST, WIDE, CHUNKED), and so does the streamed backward where
    ``gat_bwd_route`` names it (E 2400): with v the identity (D = N, one key
    tile, one slice) the forward's u is w exactly, and with du the identity
    and dvec 0 K2b's dv, and the streamed backward's (``gatv2_bwd``), is w
    transposed exactly (every other term of their sums is an exact zero), so
    equal bits mean equal scores from the one shared score routine."""
    for N, E in ((64, 76), (32, 470), (32, 2400)):
        p, q, a, bias, _ = gat_case(gen, dev, 1, N, E, N, torch.float32, True)
        eye = torch.eye(N, device=dev)[None].contiguous()
        _, u, m, l = kg.gatv2_attention_res(p, q, a, bias, eye, 0.2, 0, 0.0, variant="tiled")
        bwd = (p, q, a, bias, eye, m, l, eye, torch.zeros(1, N, device=dev), 0.2, 0, 0.0)
        _, dv, _ = kg.gatv2_bwd_dq_dv(*bwd)
        _, dv_db, _ = kg.gatv2_bwd_dq_dv(*bwd, dbias=True)
        route = kg.gat_bwd_route(N, E, N)
        routed = kg.gatv2_bwd(*bwd, dbias=True) if route == "streamed" else None
        torch.cuda.synchronize()
        tile = kg.TILED_TILE_NAMES[kg.gatv2_bwd_dq_dv.last_plan.tile]
        rec = {"phase": "training_kernels", "case": "w of the tiled K1-res against K2b's, bit "
               "for bit, K2b without and with dbias, and the routed backward's", "N": N, "E": E,
               "k2b_tile": tile, "identical": torch.equal(u[0], dv[0].t()),
               "identical_with_dbias": torch.equal(u[0], dv_db[0].t()),
               "max_abs_diff": (u[0] - dv[0].t()).abs().max().item(),
               "route": route}
        if routed is not None:
            rec["identical_streamed"] = torch.equal(u[0], routed[3][0].t())
        emit(rec)
        if not (rec["identical"] and rec["identical_with_dbias"]
                and (E < 2400 or rec.get("identical_streamed"))):
            raise AssertionError(f"the tiled K2b's or the routed backward's weights differ "
                                 f"from the tiled K1-res's: {rec}")


def forward_errors(got, want) -> dict:
    """K1-res's errors against its plain version: out, u, m absolute, l
    relative."""
    return {"out": (got[0].float() - want[0].float()).abs().max().item(),
            "u": (got[1] - want[1]).abs().max().item(),
            "m": (got[2] - want[2]).abs().max().item(),
            "l_rel": ((got[3] - want[3]).abs() / want[3]).max().item()}


def time_training_kernels(kg, p, q, a, bias, v, du, dvec, m, l, seed, rate) -> dict:
    """ms of each kernel, its plain version and its bound at one shape.

    Operations per (i, j) pair, the least each function needs, with the
    score's z and leaky_relu(z) computed once and kept (a kernel that
    recomputes them does more): the score 4E (add, leaky relu, a
    multiply-add of 2). K1-res: score + aggregate 2D. The backward's sums
    over keys or rows: leaky_relu'(z) is 1 or alpha, so alpha ds is formed
    once per pair (inside the 4) and dp_ie and dq_je each take one add per
    e; da_e takes ds lr(z), a multiply-add (2) per e; dv 2 per d; du_i . v_j
    2D + 4 (weight, dropout, ds). K2ab (K2a, K2b and K2c's work once, as the
    main path calls it, dbias included): score + 2D + 4 + dp 1E + dq 1E + da
    2E + dv 2D + the add of ds into dbias, 8E + 4D + 5, and dbias (N, N)
    float32 written. K2a: score + 2D + 4 + dp + da, 7E + 2D + 4. K2b: score
    + 2D + 4 + dq + dv, 5E + 4D + 4; with dbias (K2c's work in its pass)
    5E + 4D + 5 and dbias (N, N) float32 written. K2c: score + 2D + 4 (+ its
    add, inside the 4). The select of leaky_relu'(z) is not counted, so these are lower
    bounds. The bound counts each input read once and each output written
    once, so not K2ab's partial sums of dbias (``partial_bytes``, written
    once and read once by their sum); ``bound_with_partials_ms`` adds them.

    ``ms`` is one wrapper call by CUDA events around back-to-back calls, host
    overhead included where a call's Python outlasts its kernels;
    ``graph_ms`` the same call's device time, from a CUDA graph
    (``graph_ms``). K2ab's entry also times K2ab without dbias
    (``no_dbias_*``: K2a and K2b's work alone, today's kernel before dbias
    moved into it), the sum of its partials alone (``partial_sum_*``), K2ab
    without dbias followed by K2c (``with_k2c_*``: the route dbias took
    before), and the tiled K2a then K2b that it replaces, both ways. The
    tiled K2b's entry ``k2b_dbias`` is K2b summing dbias in its own pass
    (forced here), beside K2b followed by K2c (``k2b_k2c_*``: the tiled
    path's dbias before the fold)."""
    B, N, E = p.shape
    D = v.shape[-1]
    size = p.dtype.itemsize
    args = (p, q, a, bias, v, m, l, du, dvec, 0.2, seed, rate)
    in_bytes = (2 * B * N * E + E + B * N * D) * size + N * N * 4
    stats_bytes = 3 * B * N * 4 + B * N * D * 4      # m, l, dvec, du
    pairs = B * N * N
    plain_bwd = time_ms(lambda: kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2,
                                                             seed, rate), 3, warmup=1)
    spec = {
        "k1res": (lambda: kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate),
                  time_ms(lambda: kg.gatv2_attention_res_plain(p, q, a, bias, v, 0.2, seed,
                                                               rate), 3, warmup=1),
                  pairs * (4 * E + 2 * D),
                  in_bytes + B * N * D * (size + 4) + 2 * B * N * 4),
        "k2ab": (lambda: kg.gatv2_bwd_graph(*args, dbias=True), plain_bwd,
                 pairs * (8 * E + 4 * D + 5),
                 in_bytes + stats_bytes + B * N * (2 * E + D) * size + E * 4 + N * N * 4),
        "k2a": (lambda: kg.gatv2_bwd_dp_da(*args), plain_bwd,
                pairs * (7 * E + 2 * D + 4),
                in_bytes + stats_bytes + B * N * E * size + E * 4),
        "k2b": (lambda: kg.gatv2_bwd_dq_dv(*args), plain_bwd,
                pairs * (5 * E + 4 * D + 4),
                in_bytes + stats_bytes + B * N * (E + D) * size),
        "k2b_dbias": (lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True), plain_bwd,
                      pairs * (5 * E + 4 * D + 5),
                      in_bytes + stats_bytes + B * N * (E + D) * size + N * N * 4),
        "k2c": (lambda: kg.gatv2_bwd_dbias(*args), plain_bwd,
                pairs * (4 * E + 2 * D + 4),
                in_bytes + stats_bytes + N * N * 4),
    }
    out = {}
    for k, (fn, plain_ms, ops, nbytes) in spec.items():
        bound_ms, bound_by = bound(ops, nbytes)
        out[k] = {"ms": time_ms(fn, 20), "graph_ms": graph_ms(fn), "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}
    k2ab = out["k2ab"]
    group = kg.dbias_groups(B, torch.cuda.get_device_properties(p.device).multi_processor_count)
    part = torch.randn((-(-B // group), N, N), device=p.device)
    k2ab["occupancy"] = graph_occupancy(kg._bwd_lib(), N, E, D)
    k2ab["dbias_group"], k2ab["partials"] = group, part.shape[0]
    k2ab["partial_bytes"] = part.numel() * 4
    k2ab["bound_with_partials_ms"] = bound(pairs * (8 * E + 4 * D + 5),
                                           in_bytes + stats_bytes + B * N * (2 * E + D) * size
                                           + E * 4 + N * N * 4 + 2 * part.numel() * 4)[0]
    for key, fn in (("no_dbias", lambda: kg.gatv2_bwd_graph(*args)),
                    ("partial_sum", lambda: part.sum(dim=0)),
                    ("with_k2c", lambda: (kg.gatv2_bwd_graph(*args), kg.gatv2_bwd_dbias(*args))),
                    ("tiled_k2a_k2b", lambda: tiled_bwd(kg, args))):
        k2ab[f"{key}_ms"], k2ab[f"{key}_graph_ms"] = time_ms(fn, 20), graph_ms(fn)
    k2b = out["k2b_dbias"]
    k2b["plan"] = kg.gatv2_bwd_dq_dv.last_plan._asdict()
    fold_before = lambda: (kg.gatv2_bwd_dq_dv(*args), kg.gatv2_bwd_dbias(*args))  # noqa: E731
    k2b["k2b_k2c_ms"], k2b["k2b_k2c_graph_ms"] = time_ms(fold_before, 20), graph_ms(fold_before)
    tiled_fwd = lambda: kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate,  # noqa: E731
                                               variant="tiled")
    out["k1res"]["tiled_ms"] = time_ms(tiled_fwd, 20)
    out["k1res"]["tiled_graph_ms"] = graph_ms(tiled_fwd)
    return out


def check_training_memory(kg, p, q, a, bias, v, du, dvec, seed, rate) -> None:
    """K1-res, then the backward with dbias that ``gatv2_bwd`` runs on the
    shape's route: the tiled K2a and K2b ("tiled") or the streamed backward
    ("streamed"), the peak of each launch above what was allocated before it
    measured on its own: each allocates its outputs, the scratch its plan
    names and at most 1 MiB more, and 1 MiB more for each of those tensors
    of 1 MiB or more (the caching allocator hands such a request a cached
    block without splitting it where less than 1 MiB would be left over, and
    counts the whole block). The scratch: the tiled forward's partials
    (``gat_tiled_fwd_plan``), K2a's partials and da rows, K2b's partials
    and, beyond the (N, N) output, its dbias partials, ceil(B / G) of (N, N)
    (``gat_tiled_bwd_plan``'s ``partial_bytes``, ``da_rows`` and
    ``dbias_bytes``; G checked against the built library at launch); the
    streamed backward's ds, wa (B, N, N) and da rows (B, E), float32
    (``gat_streamed_bwd_plan``'s ``scratch_bytes``). On the tiled route no
    (B, N, N) tensor exists in device memory but the dbias partials the plan
    names: each launch's allowance beyond them is checked to stay below one
    (B, N, N) float32 tensor, so that one more would still fail. On the
    streamed route (a feature layer) the plan's own scratch holds two, and
    one is smaller than the 1 MiB slack (370 KB at lookback 1024): there
    the check bounds each launch's bytes only."""
    B, N, E = p.shape
    D = v.shape[-1]
    route = kg.gat_bwd_route(N, E, D)
    if route not in ("tiled", "streamed"):
        raise AssertionError(f"check_training_memory: N {N}, E {E}, D {D} routes to {route}")
    size = p.dtype.itemsize

    def held(*ns):
        """Bytes of tensors of ``ns`` bytes as the caching allocator holds
        them (rounded up to 512), and how many are of 1 MiB or more."""
        return sum(-(-n // 512) * 512 for n in ns), sum(n >= 2**20 for n in ns)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = fn()
        torch.cuda.synchronize()
        return result, torch.cuda.max_memory_allocated() - base

    (_, u, m, l), fwd_extra = peak(
        lambda: kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate))
    fwd_plan = kg.gatv2_attention_res.last_launch["plan"]
    args = (p, q, a, bias, v, m, l, du, dvec, 0.2, seed, rate)
    # (peak, outputs, scratch, dbias partials beyond the (N, N) output), each
    # a list of its tensors' bytes
    launches = {"k1res": (fwd_extra, [B * N * D * size, B * N * D * 4, B * N * 4, B * N * 4],
                          [0 if fwd_plan is None else fwd_plan["partial_bytes"]], [])}
    if route == "tiled":
        _, k2a_extra = peak(lambda: kg.gatv2_bwd_dp_da(*args))
        k2a = kg.gatv2_bwd_dp_da.last_plan
        _, k2b_extra = peak(lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True))
        k2b = kg.gatv2_bwd_dq_dv.last_plan
        launches["k2a"] = (k2a_extra, [B * N * E * size, E * 4],
                           [k2a.partial_bytes, k2a.da_rows * E * 4], [])
        launches["k2b"] = (k2b_extra, [B * N * E * size, B * N * D * size, N * N * 4],
                           [k2b.partial_bytes],
                           [k2b.dbias_bytes] if k2b.dbias_bytes > N * N * 4 else [])
        group = k2b.group
    else:
        _, st_extra = peak(lambda: kg.gatv2_bwd_streamed(*args, dbias=True))
        st = kg.gatv2_bwd_streamed.last_plan
        launches["streamed"] = (st_extra, [2 * B * N * E * size, B * N * D * size, E * 4,
                                           N * N * 4],
                                [B * N * N * 4, B * N * N * 4, B * E * 4], [])
        if sum(launches["streamed"][2]) != st.scratch_bytes:
            raise AssertionError(f"the streamed backward's scratch {launches['streamed'][2]} "
                                 f"is not its plan's {st.scratch_bytes} bytes")
        group = None
    recs = {}
    for k, (x, outs, scratch, dpart) in launches.items():
        (o, no), (sc, ns), (dp, nd) = held(*outs), held(*scratch), held(*dpart)
        slack = 2**20 * (1 + no + ns + nd)
        recs[k] = {"peak_extra_bytes": x, "output_bytes": o, "scratch_bytes": sc,
                   "dbias_partial_bytes": dp, "slack_bytes": slack,
                   "allowed_bytes": o + sc + dp + slack}
    emit({"phase": "training_kernels", "case": "device memory of each launch of one forward "
          "and backward", "B": B, "N": N, "E": E, "D": D, "route": route, "k2b_group": group,
          "launches": recs, "score_matrix_bytes": B * N * N * 4})
    for k, r in recs.items():
        if route == "tiled" and r["scratch_bytes"] + r["slack_bytes"] >= B * N * N * 4:
            raise AssertionError(f"{k}'s scratch and slack ({r}) at N={N} leave no room to "
                                 "tell a (B, N, N) tensor")
        if r["peak_extra_bytes"] > r["allowed_bytes"]:
            raise AssertionError(f"{k} allocated {r['peak_extra_bytes']} bytes at B={B}, "
                                 f"N={N}: {r}")


# ---------------------------------------------------------------------------
# K4, the GRU backward through time, and the window at which the GRU kernels
# overtake the plain loop
# ---------------------------------------------------------------------------


# (case, B, T, H, gi's type, dense cotangent, variant the planner must pick)
K4_CASES = (
    ("flagship", 256, 100, 150, torch.float32, True, "cluster"),
    ("flagship", 256, 100, 150, torch.bfloat16, True, "cluster"),
    ("flagship, cotangent on h_last only", 256, 100, 150, torch.float32, False, "cluster"),
    ("long", 256, 1024, 150, torch.float32, True, "cluster"),
    ("one step", 256, 1, 150, torch.float32, True, "cluster"),
    ("batch 1", 1, 100, 150, torch.float32, True, "cluster"),
    ("ragged batch", 43, 100, 150, torch.float32, True, "cluster"),
    ("even slices", 64, 100, 64, torch.float32, True, "cluster"),
    ("larger cluster", 64, 100, 176, torch.float32, True, "cluster"),
    ("wide", 64, 100, 384, torch.float32, True, "streaming"),
)


def check_k4(gen, dev):
    """K4 against gru_scan_bwd_plain and against autograd of the plain
    forward; returns (worst float32 abs error, worst relative error, times
    at the flagship shape)."""
    from mtad_gat_tpu_torch.kernels.gru import (
        gru_scan_bwd, gru_scan_bwd_plain, gru_scan_fwd, gru_scan_fwd_plain)

    names = ("dgi", "dw_hh", "db_hh")
    worst_abs, worst_rel, times = 0.0, 0.0, None
    for name, B, T, H, dtype, dense, variant in K4_CASES:
        gru, x, gi, w_hh, b_hh = gru_case(gen, dev, B, T, H, dtype)
        dhseq = torch.randn(B, T, H, generator=gen).to(dev)
        if not dense:
            dhseq[:, :-1] = 0.0
        with torch.no_grad():
            hseq, _ = gru_scan_fwd(gi, w_hh, b_hh, H)
        got = gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H)
        again = gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H)
        want = gru_scan_bwd_plain(gi, w_hh, b_hh, hseq, dhseq, H)
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
        err = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
        err_abs = {n: (a - b).abs().max().item() for n, a, b in zip(names, got, want)}
        rec = {"phase": "k4", "case": name, "B": B, "T": T, "H": H,
               "dtype": str(dtype).replace("torch.", ""), "rel_err": err, "abs_err": err_abs,
               "tol": K4_TOL, "two_launches_identical": same_bits,
               **gru_scan_bwd.last_launch}
        if T <= 100:
            # the other oracle: autograd of the plain forward from the same inputs
            leaves = [t.detach().float().clone().requires_grad_() for t in (gi, w_hh, b_hh)]
            ref_seq, _ = gru_scan_fwd_plain(*leaves, H)
            ref = torch.autograd.grad(ref_seq, leaves, dhseq)
            rec["rel_err_vs_autograd"] = {n: rel_err(a, b) for n, a, b in zip(names, got, ref)}
        if name == "flagship" and dtype == torch.float32:
            rec["timing"] = times = time_k4(gru, x, gi, w_hh, b_hh, hseq, dhseq, H)
            rec["weights"] = times["weights"] = check_k4_weights(gi, w_hh, b_hh, hseq,
                                                                  got[0], H)
        emit(rec)
        bad = [n for n, e in err.items() if not e <= K4_TOL]
        bad += [n for n, e in rec.get("rel_err_vs_autograd", {}).items() if not e <= K4_TOL]
        if bad or not same_bits:
            raise AssertionError(f"K4 {name} {dtype}: {bad} beyond tolerance or bits "
                                 f"differ: {rec}")
        if rec["variant"] != variant:
            raise AssertionError(f"K4 {name}: ran the {rec['variant']} variant, "
                                 f"expected {variant}")
        worst_abs = max(worst_abs, *err_abs.values())
        worst_rel = max(worst_rel, *err.values())
    return worst_abs, worst_rel, times


def time_k4(gru, x, gi, w_hh, b_hh, hseq, dhseq, H) -> dict:
    """ms of K4 (whole, and its serial scan alone) by CUDA events per wrapper
    call and by a CUDA graph of 20 calls, of its plain version and of cuDNN's
    GRU backward on the same data, and the bounds of K4 and of its scan.
    Operations per (b, t): three products of 2 H 3H (the gate recompute,
    dg . W_hh^T, the dW_hh term; the scan does the first two) and about 30 H
    for the gates and their gradients. Bytes: gi, hseq, dhseq and the weights
    read once; dgi, dW_hh, db_hh written once (the scan: dgi and dghn)."""
    from mtad_gat_tpu_torch.kernels.gru import gru_scan_bwd, gru_scan_bwd_plain

    B, T, _ = gi.shape
    full = lambda: gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H)  # noqa: E731
    scan = lambda: gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H,  # noqa: E731
                                need_weights=False)
    plain_ms = time_ms(lambda: gru_scan_bwd_plain(gi, w_hh, b_hh, hseq, dhseq, H), 2,
                       warmup=1)
    xg = x.clone().requires_grad_()
    out, _ = gru(xg)
    leaves = [xg, *gru.parameters()]
    library_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dhseq, retain_graph=True),
                         10)
    read = B * T * 3 * H * gi.dtype.itemsize + 2 * B * T * H * 4 + (H * 3 * H + 3 * H) * 4
    bound_ms, bound_by = bound(B * T * (3 * 2 * H * 3 * H + 30 * H),
                               read + B * T * 3 * H * 4 + (H * 3 * H + 3 * H) * 4)
    scan_bound_ms, scan_bound_by = bound(B * T * (2 * 2 * H * 3 * H + 30 * H),
                                         read + B * T * 4 * H * 4)
    return {"ms": time_ms(full, 10), "graph_ms": graph_ms(full),
            "scan_ms": time_ms(scan, 10), "scan_graph_ms": graph_ms(scan),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "scan_bound_ms": scan_bound_ms, "scan_bound_by": scan_bound_by,
            **gru_scan_bwd.last_launch,
            "library": "backward of torch.nn.GRU (cuDNN) on the same data, the input "
                       "projection's gradients included"}


def check_k4_weights(gi, w_hh, b_hh, hseq, dgi, H) -> dict:
    """K4's weights product alone (``gru_weight_grads``) on the flagship
    chain's saved states, the scan's dgi and its dghn = dn_pre r: against
    its plain version (twice, for identical bits), by CUDA events and by a
    CUDA graph of 20 calls, beside its bound and beside one library call on
    the same operands prepared outside the timed region, ``torch.mm(hprev.T,
    dgh)`` with the db column sum (TF32 off). Operations: 2 M H 3H for
    dW_hh and M 3H adds for db_hh over the M = B T rows; bytes: hseq, dgi's
    first 2H columns and dghn read once, dW_hh and db_hh written once."""
    from mtad_gat_tpu_torch.kernels.gru import gru_weight_grads, gru_weight_grads_plain

    B, T, _ = gi.shape
    M = B * T
    with torch.no_grad():
        hprev = torch.cat([torch.zeros_like(hseq[:, :1]), hseq[:, :-1]], dim=1)
        r = torch.sigmoid(gi[..., :H].float() + (hprev @ w_hh + b_hh)[..., :H])
        dghn = (dgi[..., 2 * H:] * r).contiguous()
        hprev_rows = hprev.reshape(M, H).contiguous()
        dgh = torch.cat([dgi[..., :2 * H], dghn], dim=-1).reshape(M, 3 * H).contiguous()
    run = lambda: gru_weight_grads(hseq, dgi, dghn, H)  # noqa: E731
    got, again = run(), run()
    want = gru_weight_grads_plain(hseq, dgi, dghn, H)
    library = lambda: (torch.mm(hprev_rows.t(), dgh), dgh.sum(dim=0))  # noqa: E731
    lib_w, lib_b = library()
    torch.cuda.synchronize()
    bound_ms, bound_by = bound(2 * M * H * 3 * H + M * 3 * H,
                               M * 4 * H * 4 + (H * 3 * H + 3 * H) * 4)
    rec = {"B": B, "T": T, "H": H,
           "rel_err": {"dw_hh": rel_err(got[0], want[0]), "db_hh": rel_err(got[1], want[1])},
           "abs_err": {"dw_hh": (got[0] - want[0]).abs().max().item(),
                       "db_hh": (got[1] - want[1]).abs().max().item()},
           "library_rel_err": {"dw_hh": rel_err(lib_w, want[0]), "db_hh": rel_err(lib_b, want[1])},
           "tol": K4_TOL, "two_launches_identical": all(
               torch.equal(x, y) for x, y in zip(got, again)),
           "ms": time_ms(run, 20), "graph_ms": graph_ms(run),
           "plain_ms": time_ms(lambda: gru_weight_grads_plain(hseq, dgi, dghn, H), 3),
           "library_ms": time_ms(library, 20), "library_graph_ms": graph_ms(library),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library": "torch.mm(hprev.T, dgh) and dgh.sum(0) on prepared operands, TF32 off"}
    if not (max(rec["rel_err"].values()) <= K4_TOL and rec["two_launches_identical"]):
        raise AssertionError(f"K4 weights product: {rec}")
    return rec


CROSSOVER_WINDOWS = (1, 2, 4, 8, 16, 100, 1024)


def gru_crossover(gen, dev) -> dict:
    """ms of the port's GRU layer (encoder widths: 114 in, 150 hidden, batch
    256, float32) through the kernels and through the plain loop, by window:
    a forward without gradient (scoring) and a forward and backward
    (training). Returns the least measured window from which the kernels win
    both at every larger measured window."""
    from mtad_gat_tpu_torch.nn import GRU

    layers = {impl: GRU(114, 150, impl=impl, generator=gen).to(dev)
              for impl in ("pallas", "xla")}
    layers["xla"].load_state_dict(layers["pallas"].state_dict())
    rows, wins = [], []
    for T in CROSSOVER_WINDOWS:
        x = torch.randn(256, T, 114, generator=gen).to(dev)
        row = {"window": T}
        for impl, layer in layers.items():
            # the small windows are a few host launches: more calls to settle
            iters = 3 if (impl == "xla" and T >= 100) else 10 if T >= 100 else 30

            def score(layer=layer):
                with torch.no_grad():
                    layer(x)

            def train(layer=layer):
                out, last = layer(x)
                torch.autograd.grad(out.sum() + last.sum(), list(layer.parameters()))

            row[f"{impl}_scoring_ms"] = time_ms(score, iters, warmup=2)
            row[f"{impl}_training_ms"] = time_ms(train, iters, warmup=2)
        rows.append(row)
        wins.append(row["pallas_scoring_ms"] < row["xla_scoring_ms"]
                    and row["pallas_training_ms"] < row["xla_training_ms"])
    crossover = None
    for T, win in zip(reversed(CROSSOVER_WINDOWS), reversed(wins)):
        if not win:
            break
        crossover = T
    rec = {"phase": "gru_crossover", "B": 256, "in": 114, "H": 150, "dtype": "float32",
           "impl": {"pallas": "K3 (+K4 in training)", "xla": "plain per-step loop"},
           "rows": rows, "kernels_win_from_window": crossover}
    emit(rec)
    return rec


KERNEL_COUNTERS = ("gatv2_attention_fwd", "gatv2_attention_res", "gatv2_fwd_merge",
                   "gatv2_bwd_graph", "gatv2_bwd_dp_da", "gatv2_bwd_dq_dv", "gatv2_bwd_dbias",
                   "gatv2_bwd_streamed", "gru_scan_fwd", "gru_scan_bwd", "gru_weight_grads")


def counters() -> dict:
    from mtad_gat_tpu_torch.kernels import gat, gru

    return {name: getattr(gat if name.startswith("gat") else gru, name)
            for name in KERNEL_COUNTERS}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_variant"):
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)


def read_counts() -> dict:
    """Launches by wrapper, and by variant ("name:variant") for the
    forward's two kernels (graph, tiled), K2ab and the streamed backward
    (dbias, no_dbias), the tiled K2a and K2b (their tile: fast, wide,
    chunked) and K2c (full, chunked)."""
    counts = {}
    for name, fn in counters().items():
        counts[name] = fn.launches
        for variant, n in getattr(fn, "launches_by_variant", {}).items():
            counts[f"{name}:{variant}"] = n
    return counts


def expected_training_launches(n_train_rows: int, n_test_rows: int, w: int, bs: int,
                               epochs: int, val_split: float, gru_impl: str,
                               n_features: int = 38, remat: bool = False) -> tuple:
    """Launch counts of one train_cli run (``step_launches`` of its
    training steps and of its batches evaluated or scored without gradient:
    init train and val losses, one val pass per epoch, the test loss, and
    the train and test scoring passes), and its steps."""
    batches = lambda n: max(1, -(-n // bs))  # noqa: E731
    n_win = n_train_rows - w
    n_val = int(np.floor(val_split * n_win))
    steps = epochs * batches(n_win - n_val)
    no_grad = (batches(n_win - n_val) + batches(n_val) * (1 + epochs)
               + batches(n_test_rows - w) + batches(n_train_rows - w + 1)
               + batches(n_test_rows - w + 1))
    return step_launches(steps, no_grad, w, bs, gru_impl, n_features, remat), steps


def step_launches(steps: int, no_grad: int, w: int, bs: int, gru_impl: str,
                  n_features: int = 38, remat: bool = False) -> dict:
    """Launch counts of ``steps`` training steps and ``no_grad`` batches
    without gradient through the attention kernels: each training step runs
    K1-res (twice with ``remat``: the forward and the backward's recompute,
    ``nn/remat.py``) and the backward's variant that ``gat_bwd_route`` names
    for the layer (K2ab, K2a and K2b, or the streamed backward, each summing
    dbias too; K2c never) in both attention layers (feature: N features, E
    2w, D w; temporal: N w, E 2 features, D features; both with a learned
    score bias) and, with the GRU kernels, K3 and K4 (scan and weights
    product) in the encoder and the decoder; each batch without gradient
    runs K1 twice and, with the GRU kernels, K3 twice. K1 and K1-res also
    count by the variant ``gat_fwd_plan`` names, each tiled one with a
    merge; the tiled K2a and K2b by the tile ``gat_tiled_bwd_plan`` names,
    K2b's also as summing dbias."""
    from mtad_gat_tpu_torch.kernels.gat import (TILED_TILE_NAMES, gat_bwd_route, gat_fwd_plan,
                                                gat_tiled_bwd_plan)

    res = steps * (2 if remat else 1)
    gru = gru_impl == "pallas"
    want = {name: 2 * steps for name in KERNEL_COUNTERS}
    layers = ((n_features, 2 * w, w), (w, 2 * n_features, n_features))
    routes = [gat_bwd_route(*layer) for layer in layers]
    graph, tiled, streamed = (routes.count(r) for r in ("graph", "tiled", "streamed"))
    want.update(gatv2_attention_res=2 * res, gatv2_bwd_graph=graph * steps,
                gatv2_bwd_dp_da=tiled * steps, gatv2_bwd_dq_dv=tiled * steps,
                gatv2_bwd_dbias=0, gatv2_bwd_streamed=streamed * steps)
    want["gatv2_bwd_dq_dv:dbias"], want["gatv2_bwd_dq_dv:no_dbias"] = tiled * steps, 0
    want["gatv2_bwd_graph:dbias"], want["gatv2_bwd_graph:no_dbias"] = graph * steps, 0
    want["gatv2_bwd_streamed:dbias"] = streamed * steps
    want["gatv2_bwd_streamed:no_dbias"] = 0
    want.update(gatv2_attention_fwd=2 * no_grad,
                gru_scan_fwd=2 * (steps + no_grad) if gru else 0,
                gru_scan_bwd=2 * steps if gru else 0, gru_weight_grads=2 * steps if gru else 0)
    fwd_graph = sum(gat_fwd_plan(*layer) == "graph" for layer in layers)
    for name, calls in (("gatv2_attention_fwd", no_grad), ("gatv2_attention_res", res)):
        want[f"{name}:graph"] = fwd_graph * calls
        want[f"{name}:tiled"] = (2 - fwd_graph) * calls
    want["gatv2_fwd_merge"] = (2 - fwd_graph) * (no_grad + res)
    for name in ("gatv2_bwd_dp_da", "gatv2_bwd_dq_dv"):
        want.update({f"{name}:{tile}": 0 for tile in TILED_TILE_NAMES})
    want.update({"gatv2_bwd_dbias:full": 0, "gatv2_bwd_dbias:chunked": 0})
    for layer, route in zip(layers, routes):
        if route == "tiled":
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            for kernel, pl in gat_tiled_bwd_plan(bs, *layer, sms, dbias=True).items():
                name = "gatv2_bwd_dp_da" if kernel == "k2a" else "gatv2_bwd_dq_dv"
                want[f"{name}:{TILED_TILE_NAMES[pl.tile]}"] += steps
    return want


def finite_summary(path: str) -> dict:
    with open(path) as f:
        summary = json.load(f)
    for key in ("epsilon_result", "pot_result", "bf_result"):
        for k, val in summary[key].items():
            if not np.all(np.isfinite(val)):
                raise AssertionError(f"{path}: {key}.{k} = {val}")
    return summary


# the kernels of a traced training epoch at the flagship widths, each with
# the counters whose launches it is (phase 8's trace, phase 20's per rank)
TRACED_KERNELS = {
    "gatv2_fwd_graph_kernel": ("gatv2_attention_fwd:graph", "gatv2_attention_res:graph"),
    "gatv2_bwd_graph_kernel": ("gatv2_bwd_graph",),
    "gru_fwd_cluster_kernel": ("gru_scan_fwd",),
    "gru_bwd_cluster_kernel": ("gru_scan_bwd",),
    "gru_bwd_weights_kernel": ("gru_weight_grads",),
}


@contextlib.contextmanager
def counted_traces(module=None):
    """Each trace that ``module`` (default ``training/trainer.py``: each
    ``Trainer.fit`` trace) opens through its ``trace``
    (``utils/profiling.trace``) inside the block: the launch counters'
    change over the traced block, and its seconds, one dict a trace."""
    if module is None:
        import mtad_gat_tpu_torch.training.trainer as module

    real, traces = module.trace, []

    @contextlib.contextmanager
    def counted(*args, **kw):
        before, t0 = read_counts(), time.perf_counter()
        with real(*args, **kw) as prof:
            yield prof
        after = read_counts()
        traces.append({"seconds": time.perf_counter() - t0,
                       "launches": {k: n - before[k] for k, n in after.items() if n != before[k]}})

    module.trace = counted
    try:
        yield traces
    finally:
        module.trace = real


def trace_record(path: str, launches: dict) -> dict:
    """A trace file's size, its kernel events by ``TRACED_KERNELS`` name
    beside the launches its counters made over the traced block, the
    device's busy share over the span of its device events, and the host's
    time in collectives (the backends' ``gloo:`` and ``nccl:`` annotations,
    which hold a collective's whole time where the ``c10d::`` operator only
    enqueues it: on a mesh, what a rank's steps spend summing gradients
    with the other ranks)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if e["cat"] == "kernel"]
    span_us = (max(e["ts"] + e["dur"] for e in device) - min(e["ts"] for e in device)
               if device else 0.0)
    busy_us = sum(e["dur"] for e in device)
    collective_us = sum(e.get("dur", 0) for e in events if e.get("cat") == "user_annotation"
                        and re.match(r"(gloo|nccl):", e.get("name", "")))
    return {"file": os.path.basename(path), "bytes": os.path.getsize(path),
            "kernel_events": {name: sum(1 for e in kernels if re.search(rf"\b{name}\b", e["name"]))
                              for name in TRACED_KERNELS},
            "launches": {name: sum(launches.get(c, 0) for c in counters)
                         for name, counters in TRACED_KERNELS.items()},
            "all_kernel_events": len(kernels), "device_span_ms": span_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / span_us if span_us else None,
            "host_collective_ms": collective_us / 1e3,
            "host_collective_share": collective_us / span_us if span_us else None}


def trace_problem(trace: dict) -> str:
    """Why a ``trace_record`` fails its check, or "" where each traced
    kernel shows as many events as it had launches, and at least one."""
    if "launches" not in trace:
        return "no trace file read"
    if trace["kernel_events"] != trace["launches"] or not all(trace["launches"].values()):
        return f"kernel events {trace.get('kernel_events')}, launches {trace.get('launches')}"
    return ""


def loss_plots(run: str) -> str:
    """train_cli's loss plots in the run directory: both written where
    matplotlib is installed, else none (``plot_losses`` prints that it
    skipped them)."""
    import importlib.util

    pngs = [n for n in ("train_losses.png", "validation_losses.png")
            if os.path.exists(os.path.join(run, n))]
    if importlib.util.find_spec("matplotlib") is None:
        if pngs:
            raise AssertionError(f"{run}: {pngs} written without matplotlib")
        return "skipped: matplotlib is not installed on this machine"
    if len(pngs) != 2:
        raise AssertionError(f"{run}: loss plots {pngs}, expected train and validation")
    return "written: " + ", ".join(pngs)


def check_train_cli(work, data_root, gru_impl: str, epochs: int):
    """train_cli.main on the card with the attention kernels and the given
    GRU path, float32 then bfloat16; returns the f32 run's launch counts.
    With every kernel on, the float32 run also takes ``--profile_dir``: one
    trace file, of the second epoch, whose kernel events match the launch
    counters over that epoch; and its loss plots are checked."""
    from mtad_gat_tpu_torch.cli import predict_cli, train_cli
    from mtad_gat_tpu_torch.config import RunConfig

    flagship = RunConfig()
    launches = None
    for dtype in ("float32", "bfloat16"):
        out_root = os.path.join(work, f"train_{gru_impl}_{dtype}")
        common = ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root,
                  "--output_root", out_root, "--device", "cuda"]
        argv = common + ["--attention_impl", "pallas", "--gru_impl", gru_impl,
                         "--epochs", str(epochs), "--compute_dtype", dtype,
                         "--log_tensorboard", "False", "--run_id", "run", "--seed", "0"]
        prof = (os.path.join(work, f"prof_{gru_impl}_{dtype}")
                if gru_impl == "pallas" and dtype == "float32" else None)
        if prof:
            argv += ["--profile_dir", prof]
        reset_counts()
        t0 = time.perf_counter()
        with counted_traces() as traces:
            run = train_cli.main(argv)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        want, steps = expected_training_launches(2000, 2000, flagship.lookback, flagship.bs,
                                                 epochs, flagship.val_split, gru_impl)
        with open(os.path.join(out_root, "SMD", "1-1", "logs", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r[k] for r in records for k in r if k.endswith("total")]
        summary = finite_summary(os.path.join(run, "summary.txt"))
        rec = {"phase": "training", "run": f"train_cli {dtype}, attention kernels, "
               f"gru_impl {gru_impl}", "epochs": epochs, "seconds": seconds,
               "steps": steps, "launches": counts, "expected_launches": want,
               "epoch_losses": records, "bf_f1": summary["bf_result"]["f1"]}
        if prof:
            files = sorted(os.listdir(prof))
            rec["trace"] = {"files": files, "traces_opened": len(traces),
                            "traced_epoch": epochs - 1, "steps": steps // epochs}
            if len(files) == 1 and len(traces) == 1:
                rec["trace"].update(trace_record(os.path.join(prof, files[0]),
                                                 traces[0]["launches"]),
                                    seconds=traces[0]["seconds"])
            rec["loss_plots"] = loss_plots(run)
        if dtype == "float32":
            predict_cli.main(common + ["--model_id", "run"])
            rec["predict_cli_reproduces_summary"] = (
                finite_summary(os.path.join(run, "summary_1.txt")) == summary)
            launches = counts
        emit(rec)
        if counts != want:
            raise AssertionError(f"train_cli {dtype} gru_impl {gru_impl}: launches "
                                 f"{counts}, expected {want}")
        if prof and (len(rec["trace"]["files"]) != 1 or trace_problem(rec["trace"])):
            raise AssertionError(f"train_cli --profile_dir: {rec['trace']['files']}, "
                                 f"{trace_problem(rec['trace'])}")
        if not (len(losses) == 2 * epochs and np.all(np.isfinite(losses))):
            raise AssertionError(f"train_cli {dtype} gru_impl {gru_impl}: losses {losses}")
        if rec.get("predict_cli_reproduces_summary") is False:
            raise AssertionError("predict_cli did not reproduce the trained run's summary")
    return launches


# what the root visualize.py writes into a run directory, at feature 0
VISUALIZE_PNGS = ("feature_0.png", "all_features.png", "global_predictions.png",
                  "anomaly_segments.png")
VISUALIZE_HTML = ("feature_0.html", "global_predictions.html")
THRESHOLD_REPEATS = 3


def check_reporting(work, data_root) -> dict:
    """``visualize_cli.main`` on phase 5's float32 kernel run: its summary
    and the files the root ``visualize.py`` writes (the .png plots only
    where matplotlib is installed; the interactive .html figures need no
    plotting library). Then the thresholds' host work on that run's scores,
    each method under ``utils/profiling.timed`` ``THRESHOLD_REPEATS``
    times: epsilon, POT and the best-F1 search, with the predictor's
    parameters, each result equal to the run's summary."""
    import importlib.util

    import pandas as pd

    from mtad_gat_tpu_torch.cli import visualize_cli
    from mtad_gat_tpu_torch.config import RunConfig, lookup_pot_params
    from mtad_gat_tpu_torch.inference.eval_methods import bf_search, epsilon_eval, pot_eval
    from mtad_gat_tpu_torch.utils.profiling import timed

    out_root = os.path.join(work, "kernels_f32")
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    before = set(os.listdir(os.path.join(out_root, "SMD", "1-1", SERVE_RUN)))
    t0 = time.perf_counter()
    run = visualize_cli.main(["--dataset", "SMD", "--group", "1-1", "--model_id", "-1",
                              "--output_root", out_root])
    vis_seconds = time.perf_counter() - t0
    want = VISUALIZE_HTML + (VISUALIZE_PNGS if has_mpl else ())
    written = sorted(set(os.listdir(run)) - before)
    vis = {"phase": "reporting", "run": "visualize_cli on phase 5's kernels_f32 run",
           "seconds": vis_seconds, "written": written,
           "files": {n: os.path.getsize(os.path.join(run, n)) for n in written},
           "png_plots": "written" if has_mpl else
           "skipped: matplotlib is not installed on this machine"}
    emit(vis)
    if written != sorted(want):
        raise AssertionError(f"visualize_cli wrote {written}, expected {sorted(want)}")

    cfg = RunConfig()
    level, q, reg_level = lookup_pot_params("SMD", "1-1", cfg.level, cfg.q)
    with open(os.path.join(data_root, "ServerMachineDataset", "processed",
                           "machine-1-1_test_label.pkl"), "rb") as f:
        label = np.asarray(pickle.load(f))[cfg.lookback:]
    train = pd.read_pickle(os.path.join(run, "train_output.pkl"))["A_Score_Global"].to_numpy()
    test = pd.read_pickle(os.path.join(run, "test_output.pkl"))["A_Score_Global"].to_numpy()
    with open(os.path.join(run, "summary.txt")) as f:
        summary = json.load(f)
    methods = {
        "epsilon_result": lambda: epsilon_eval(train, test, label, reg_level=reg_level),
        "pot_result": lambda: pot_eval(train, test, label, q=q, level=level,
                                       dynamic=cfg.dynamic_pot),
        "bf_result": lambda: bf_search(test, label, start=0.01, end=2, step_num=100,
                                       verbose=False)}
    seconds, results = {k: [] for k in methods}, {}
    for _ in range(THRESHOLD_REPEATS):
        for name, fn in methods.items():
            held = {}
            with timed(name, held):
                results[name] = fn()
            seconds[name].append(held[name])
    agree = {k: all(float(results[k][m]) == float(summary[k][m])
                    for m in ("f1", "threshold")) for k in results}
    rec = {"phase": "reporting", "check": "threshold host time (utils/profiling.timed)",
           "seconds_by_method": seconds, "train_points": len(train), "test_points": len(test),
           "pot": {"q": q, "level": level, "dynamic": cfg.dynamic_pot},
           "bf_thresholds": 100, "f1_and_threshold_equal_summary": agree}
    emit(rec)
    if not all(agree.values()):
        raise AssertionError(f"thresholds on the run's scores differ from its summary: {agree}")
    return {"visualize": vis, "thresholds": rec}


def train_trainer(work, dtype: str, impl: str, gru_impl: str, dropout: float):
    """A flagship-width Trainer on the card, at train seed 0."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.training import Trainer

    cfg = RunConfig(attention_impl=impl, gru_impl=gru_impl, compute_dtype=dtype,
                    dropout=dropout, epochs=1, log_tensorboard=False)
    trainer = Trainer(cfg.model_config(38, 38), cfg.train_config(),
                      log_dir=os.path.join(work, f"logs_{impl}_{gru_impl}_{dtype}"),
                      device="cuda")
    trainer.init_state()
    return trainer


def check_kernel_vs_plain_training(work, x_train) -> None:
    """One epoch at dropout 0 from one seed through the plain paths, with
    the attention through its kernels, and with attention and GRU through
    theirs: per-step losses and final params of each against the plain run."""
    runs = {}
    for impl, gru_impl in (("dense", "xla"), ("pallas", "xla"), ("pallas", "pallas")):
        tr = train_trainer(work, "float32", impl, gru_impl, 0.0)
        tr.fit(x_train)
        runs[impl, gru_impl] = tr
    d = runs["dense", "xla"]
    sd = d.model.state_dict()
    for key, what, tol in ((("pallas", "xla"), "attention kernels vs plain paths", TRAIN_PATH_TOL),
                           (("pallas", "pallas"), "all kernels vs plain paths",
                            TRAIN_PATH_TOL)):
        k = runs[key]
        loss_err = float(max(np.abs(k.last_batch_losses[i] - d.last_batch_losses[i]).max()
                             for i in (0, 1)))
        sk = k.model.state_dict()
        param_err = max((sk[n] - sd[n]).abs().max().item() for n in sk)
        rec = {"phase": "training", "check": f"{what}, dropout 0, 1 epoch",
               "steps": k.step, "step_loss_max_abs_err": loss_err,
               "param_max_abs_err": param_err, "tol": tol}
        emit(rec)
        if not (loss_err <= tol["loss"] and param_err <= tol["param"]):
            raise AssertionError(f"kernel and plain training disagree: {rec}")


THROUGHPUT_EPOCHS = {"xla": 3, "pallas": 6}


def training_throughput(work, x_train, gru_impl: str) -> dict:
    """Train windows/s, float32 and bfloat16, attention kernels on at
    dropout 0.3, the GRU on the given path: all the steps of
    THROUGHPUT_EPOCHS epochs after a warm-up epoch, as total windows over
    total time, with every epoch's own rate; then device time by kernel over
    one profiled float32 epoch."""
    from mtad_gat_tpu_torch.data.windows import batched_starts

    rates, epoch_rates, prof_trainer = {}, {}, None
    epochs = THROUGHPUT_EPOCHS[gru_impl]
    for dtype in ("float32", "bfloat16"):
        tr = train_trainer(work, dtype, "pallas", gru_impl, 0.3)
        series = tr._series(x_train)
        n_win = len(x_train) - tr.window
        starts, mask, _ = batched_starts(0, tr.train_config.bs,
                                         indices=np.arange(n_win - n_win // 10))
        tr.train_epoch(series, starts, mask)                # warm-up
        torch.cuda.synchronize()
        seconds = []
        for _ in range(epochs):
            t0 = time.perf_counter()
            tr.train_epoch(series, starts, mask)            # ends in a device sync
            seconds.append(time.perf_counter() - t0)
        n = int(mask.sum())
        rates[dtype] = n * len(seconds) / sum(seconds)
        epoch_rates[dtype] = [n / s for s in seconds]
        if dtype == "float32":
            prof_trainer, prof_args = tr, (series, starts, mask)
    emit({"phase": "training", "gru_impl": gru_impl, "train_windows_per_s": rates,
          "epoch_windows_per_s": epoch_rates, "epochs": epochs,
          "steps_per_epoch": int(prof_args[1].shape[0]),
          "windows_per_epoch": int(prof_args[2].sum()), "batch": 256, "dropout": 0.3})
    emit(profile_training(prof_trainer, gru_impl, *prof_args))
    return rates


def profile_training(trainer, gru_impl, series, starts, mask) -> dict:
    """Device time by kernel over one float32 training epoch, as
    profile_scoring does for scoring."""
    rec = profile_device(lambda: trainer.train_epoch(series, starts, mask),
                         "one training epoch, float32, attention kernels on, "
                         f"gru_impl {gru_impl}, dropout 0.3", top=16)
    rec["steps"] = int(starts.shape[0])
    return rec


# ---------------------------------------------------------------------------
# The paths of the eighth slice: the dense route to the kernels, the long
# window on a band, and the graph variants through the CLIs
# ---------------------------------------------------------------------------

ATTENTION_COUNTERS = ("gatv2_attention_fwd", "gatv2_attention_res", "gatv2_bwd_graph",
                      "gatv2_bwd_dp_da", "gatv2_bwd_dq_dv", "gatv2_bwd_dbias")
# the routed layer against the dense one on the same weights and inputs,
# float32, TF32 off, dropout 0: the same function summed in other orders (a
# few 1e-7 apart at the flagship widths), 1e-4 as the issue of this path asks
ROUTE_TOL = 1e-4
# the block scan against the COO path on the same inputs, float32, TF32 off
SCAN_TOL = 1e-5


def expect_counts(name: str, counts: dict, want: dict) -> None:
    """Every counter not named in ``want`` must read 0."""
    full = {k: 0 for k in counts}
    full.update(want)
    if counts != full:
        raise AssertionError(f"{name}: launches {counts}, expected {full}")


def layer_grads(layer, x, gen, cot):
    """Output and the gradients of (out * cot).sum() by input and parameter."""
    xg = x.detach().requires_grad_()
    out = layer(xg, gen)
    grads = torch.autograd.grad((out.float() * cot).sum(), [xg, *layer.parameters()])
    return out.detach(), grads


# rows of queries a chunk of the plain attention at the route's N holds:
# (1, 512, N, E) float32 temporaries, 1.3 GB at N 8,587, E 76
ROUTE_PLAIN_ROWS = 512


def chunked_plain_attention(p, q, a, bias, v, alpha, seed, rate, cot=None,
                            rows=ROUTE_PLAIN_ROWS):
    """The plain GATv2 attention, out = sigmoid(softmax(a . leakyrelu(p_i +
    q_j) + bias_ij) v), over chunks of query rows, float32: the softmax is
    per row, so each chunk's weights are exact, and the hash mask takes the
    chunk's global rows. ``bias`` may be None; p (and bias) may hold some of
    the query rows (the first of them the graph's row 0 for the hash mask)
    against all of q's and v's keys, and out has p's rows. With a cotangent
    ``cot`` of out, also the gradients {dp, dq, da, dbias, dv} by autograd a
    chunk at a time, summed over the chunks. Holds no (N, N, E) tensor, so
    it runs at N where the whole plain version does not fit."""
    from mtad_gat_tpu_torch.graph.dropout import hash_keep_mask
    from mtad_gat_tpu_torch.graph.ops import gatv2_scores_dense

    B, N, _ = p.shape
    keys = v.shape[1]
    names = ("dp", "dq", "da", "dbias", "dv")
    leaves = [None if t is None else t.detach().float().requires_grad_(cot is not None)
              for t in (p, q, a, bias, v)]
    pl, ql, al, bl, vl = leaves
    given = [(k, t) for k, t in zip(names, leaves) if t is not None]
    out = torch.empty((B, N, v.shape[-1]), dtype=torch.float32, device=v.device)
    grads = {k: torch.zeros_like(t) for k, t in given}
    with torch.set_grad_enabled(cot is not None):
        for i0 in range(0, N, rows):
            i1 = min(N, i0 + rows)
            s = gatv2_scores_dense(pl[:, i0:i1], ql, al, alpha)
            w = torch.softmax(s if bl is None else s + bl[i0:i1], dim=2)
            del s
            if rate > 0.0:
                keep = hash_keep_mask(seed, B, i1 - i0, keys, rate, device=v.device,
                                      row_offset=i0)
                w = torch.where(keep, w / (1.0 - rate), 0.0)
            o = torch.sigmoid(torch.matmul(w, vl))
            out[:, i0:i1] = o.detach()
            if cot is not None:
                for (k, _), g in zip(given, torch.autograd.grad((o * cot[:, i0:i1]).sum(),
                                                                [t for _, t in given])):
                    grads[k] += g
    return out, grads


def capture_attention(ngat, store: dict):
    """A stand-in for ``nn/gat.gatv2_attention`` that calls it unchanged and
    records the call's inputs and, by hooks, the gradients the backward
    gives p, q, a, bias and v (no launch and no copy of its own)."""
    real = ngat.gatv2_attention

    def spy(p, q, a, bias, v, alpha, seed, rate, train=False):
        ins = [t.view_as(t) for t in (p, q, a, bias, v)]
        for k, t in zip(("dp", "dq", "da", "dbias", "dv"), ins):
            if t.requires_grad:
                t.register_hook(lambda g, k=k: store.__setitem__(k, g.detach()))
        store.update(inputs=[t.detach() for t in ins], alpha=alpha, seed=seed, rate=rate)
        return real(*ins, alpha, seed, rate, train=train)

    return spy


def check_dense_route(gen, dev) -> dict:
    """attention_impl="dense" on a complete GATv2 graph: at the flagship it
    stays dense (no kernel launches); with the route's threshold pinned to 1
    byte it runs the fused kernels and matches the dense layer; at the first
    N the byte model routes on this card (b 1, e 76, d 38), it runs tiled
    K1 in eval and K1-res, K2a and K2b (summing dbias) in training, whose output and
    gradients (dp, dq, da, dbias, dv) are held against the plain attention
    computed by chunks of query rows; and dense at the
    largest N below that, beside the kernels at the same N. Returns the
    launch counts of the route's run and the tiled kernels' times there."""
    import mtad_gat_tpu_torch.nn.gat as ngat
    from mtad_gat_tpu_torch.kernels import gat as kg
    from mtad_gat_tpu_torch.nn import FeatureAttention, TemporalAttention

    seeded = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    layers = {"feature": FeatureAttention(38, 100, 0.3, 0.2, generator=seeded()),
              "temporal": TemporalAttention(38, 100, 0.3, 0.2, generator=seeded())}
    x = torch.randn(256, 100, 38, generator=gen).to(dev)
    cot = torch.randn(256, 100, 38, generator=gen).to(dev)
    dgen = lambda: torch.Generator(device=dev).manual_seed(5)  # noqa: E731
    ngat.DENSE_AUTO_SCORE_BYTES = None
    for name, layer in layers.items():
        with torch.no_grad():
            layer.bias.normal_(0.0, 0.1, generator=seeded())
        layer.to(dev)
        reset_counts()
        with torch.no_grad():
            layer.eval()(x)
        layer_grads(layer.train(), x, dgen(), cot)
        torch.cuda.synchronize()
        counts = read_counts()
        emit({"phase": "dense_route", "case": f"flagship {name} layer, b 256, eval and "
              "training at dropout 0.3", "routes": layer.dense_route(x),
              "threshold_bytes": ngat.dense_route_threshold(dev),
              "dense_bytes": ngat.dense_gatv2_bytes(256, layer.n_nodes,
                                                    layer.lin.weight.shape[0], 4, True),
              "launches": counts})
        expect_counts(f"dense_route flagship {name}", counts, {})

    for name, layer in layers.items():
        layer.dropout = 0.0
        res = {}
        for pin in (1 << 62, 1):
            ngat.DENSE_AUTO_SCORE_BYTES = pin
            reset_counts()
            with torch.no_grad():
                ev = layer.eval()(x)
            eval_counts = read_counts()
            reset_counts()
            out, grads = layer_grads(layer.train(), x, None, cot)
            torch.cuda.synchronize()
            res[pin] = (ev, out, grads, eval_counts, read_counts())
        (ev_d, out_d, g_d, *_), (ev_r, out_r, g_r, c_eval, c_train) = res[1 << 62], res[1]
        errs = {"eval": (ev_r - ev_d).abs().max().item(),
                "train": (out_r - out_d).abs().max().item(),
                "grads": max((a - b).abs().max().item() for a, b in zip(g_r, g_d))}
        emit({"phase": "dense_route", "case": f"threshold pinned to 1 byte, flagship {name} "
              "layer, float32, dropout 0, against the dense layer", "max_abs_err": errs,
              "tol": ROUTE_TOL, "launches_eval": c_eval, "launches_train": c_train})
        if not max(errs.values()) <= ROUTE_TOL:
            raise AssertionError(f"routed {name} layer differs from dense: {errs}")
        expect_counts(f"routed {name} eval", c_eval,
                      {"gatv2_attention_fwd": 1, "gatv2_attention_fwd:graph": 1})
        expect_counts(f"routed {name} training", c_train,
                      {"gatv2_attention_res": 1, "gatv2_attention_res:graph": 1,
                       "gatv2_bwd_graph": 1, "gatv2_bwd_graph:dbias": 1})
        layer.cpu()
    del layers, x, cot
    ngat.DENSE_AUTO_SCORE_BYTES = None
    torch.cuda.empty_cache()

    # the first N the byte model routes on this card, at b 1, e 76, d 38
    limit = ngat.dense_route_threshold(dev)
    n_route = ngat.dense_route_nodes(1, 76, 4, False, limit)
    layer = TemporalAttention(38, n_route, 0.3, 0.2, generator=seeded())
    with torch.no_grad():
        layer.bias.normal_(0.0, 0.1, generator=seeded())
    layer.to(dev)
    xr = torch.randn(1, n_route, 38, generator=gen).to(dev)
    route = {"N": n_route, "threshold_bytes": limit,
             "dense_bytes_eval": ngat.dense_gatv2_bytes(1, n_route, 76, 4, False),
             "dense_bytes_below": ngat.dense_gatv2_bytes(1, n_route - 1, 76, 4, False),
             "dense_bytes_training": ngat.dense_gatv2_bytes(1, n_route, 76, 4, True)}
    cot = torch.randn(1, n_route, 38, generator=gen).to(dev)
    calls = {"eval": {}, "train": {}}
    real = ngat.gatv2_attention
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        ngat.gatv2_attention = capture_attention(ngat, calls["eval"])
        t0 = time.perf_counter()
        with torch.no_grad():
            out = layer.eval()(xr)
        torch.cuda.synchronize()
        route["eval_seconds"] = time.perf_counter() - t0
        route["eval_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
        route["launches_eval"] = c_eval = read_counts()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        ngat.gatv2_attention = capture_attention(ngat, calls["train"])
        t0 = time.perf_counter()
        layer.train()
        out_t, grads = layer_grads(layer, xr, dgen(), cot)
        torch.cuda.synchronize()
        route["train_seconds"] = time.perf_counter() - t0
        route["train_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
        route["launches_train"] = c_train = read_counts()
    finally:
        ngat.gatv2_attention = real
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(out_t).all()) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    route["finite"] = finite
    # the routed calls against the plain attention on the same inputs, by
    # chunks of query rows (the plain version whole would hold (N, N, E))
    ev, tr = calls["eval"], calls["train"]
    want_ev, _ = chunked_plain_attention(*ev["inputs"], ev["alpha"], 0, 0.0)
    want_tr, want_g = chunked_plain_attention(*tr["inputs"], tr["alpha"], tr["seed"],
                                              tr["rate"], cot)
    tol = TRAIN_TOL[torch.float32]
    errs = {"eval_out": (out.float() - want_ev).abs().max().item(),
            "train_out": (out_t.float() - want_tr).abs().max().item()}
    rel = {k: rel_err(tr[k], want_g[k]) if k in tr else float("inf") for k in want_g}
    route.update(plain_rows_a_chunk=ROUTE_PLAIN_ROWS, max_abs_err=errs, max_rel_err=rel,
                 tol={"out": K1_TOL[torch.float32], "grad_rel": tol["grad"]},
                 rate=tr["rate"])
    emit({"phase": "dense_route", "case": "the first routed N, b 1, e 76, d 38, float32, "
          "eval, then training at dropout 0.3 (hash mask), each against the plain "
          "attention by chunks of query rows on the call's inputs", **route})
    if not finite:
        raise AssertionError("the routed layer's output or gradients are not finite")
    if not (max(errs.values()) <= K1_TOL[torch.float32] and max(rel.values()) <= tol["grad"]):
        raise AssertionError(f"the routed layer at N {n_route} differs from the plain "
                             f"attention: {errs}, {rel}")
    expect_counts("route eval", c_eval, {"gatv2_attention_fwd": 1,
                                         "gatv2_attention_fwd:tiled": 1, "gatv2_fwd_merge": 1})
    expect_counts("route training", c_train, {
        "gatv2_attention_res": 1, "gatv2_attention_res:tiled": 1, "gatv2_fwd_merge": 1,
        "gatv2_bwd_dp_da": 1, "gatv2_bwd_dp_da:fast": 1, "gatv2_bwd_dq_dv": 1,
        "gatv2_bwd_dq_dv:fast": 1, "gatv2_bwd_dq_dv:dbias": 1})
    del out, out_t, grads, calls, ev, tr, want_ev, want_tr, want_g
    torch.cuda.empty_cache()
    times = time_route_kernels(kg, layer, xr, gen)
    torch.cuda.empty_cache()

    # dense at the largest N below the route, in eval, beside the tiled K1
    n_dense = n_route - 1
    layer = TemporalAttention(38, n_dense, 0.0, 0.2, generator=seeded()).to(dev).eval()
    xd = torch.randn(1, n_dense, 38, generator=gen).to(dev)
    with torch.no_grad():
        if layer.dense_route(xd):
            raise AssertionError(f"N {n_dense} routes, the model says it stays dense")
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = layer(xd)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        counts = read_counts()
        dense_ms = time_ms(lambda: layer(xd), 2, warmup=0)
        ngat.DENSE_AUTO_SCORE_BYTES = 1
        got = layer(xd)
        kernel_ms = time_ms(lambda: layer(xd), 5)
        ngat.DENSE_AUTO_SCORE_BYTES = None
    err = (got - want).abs().max().item()
    dense = {"N": n_dense, "peak_extra_bytes": peak,
             "model_bytes": ngat.dense_gatv2_bytes(1, n_dense, 76, 4, False),
             "threshold_bytes": limit, "dense_ms": dense_ms, "kernel_ms": kernel_ms,
             "kernel_max_abs_err": err, "launches_dense": counts}
    emit({"phase": "dense_route", "case": "dense at the largest N below the route, b 1, "
          "e 76, d 38, float32, eval, beside the tiled K1 (the layer routed by pinning)",
          **dense})
    expect_counts("dense below the route", counts, {})
    if not (err <= ROUTE_TOL and peak <= dense["model_bytes"]):
        raise AssertionError(f"dense below the route: {dense}")
    del layer, xd, want, got
    torch.cuda.empty_cache()
    return {"launches_eval": c_eval, "launches_train": c_train, "N": n_route,
            "times": times, "dense": dense, "route": route}


def time_route_kernels(kg, layer, x, gen) -> dict:
    """The tiled kernels at the route's shape (b 1, the layer's N, E 76, D
    38, float32, dropout 0.3, bias): device time from a CUDA graph of 3
    calls, and the bound as ``time_training_kernels`` counts it; K2b with
    dbias (the fold, on the path) beside K2b followed by K2c (before it),
    and the whole tiled backward both ways: K2a + K2b with dbias (``bwd``,
    what a training call runs) and K2a + K2b + K2c (``bwd_k2c``)."""
    B, N, D = x.shape
    E = layer.lin.weight.shape[0]
    with torch.no_grad():
        w, b = layer.lin.weight, layer.lin.bias
        p = (x @ w[:, :D].t()).contiguous()
        q = (x @ w[:, D:].t() + b).contiguous()
        a, bias = layer.a.detach()[:, 0].contiguous(), layer.bias.detach()
        seed = torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64).to(x.device)
        out, u, m, l = kg.gatv2_attention_res(p, q, a, bias, x, 0.2, seed, 0.3)
        sig = torch.sigmoid(u)
        du = sig * (1 - sig)
        dvec = (du * u).sum(-1)
    args = (p, q, a, bias, x, m, l, du, dvec, 0.2, seed, 0.3)
    in_bytes = (2 * B * N * E + E + B * N * D) * 4 + N * N * 4
    stats_bytes = 3 * B * N * 4 + B * N * D * 4
    pairs = B * N * N
    spec = {
        "k1": (lambda: kg.gatv2_attention_fwd(p, q, a, bias, x, 0.2), pairs * (4 * E + 2 * D),
               in_bytes + B * N * D * 4),
        "k1res": (lambda: kg.gatv2_attention_res(p, q, a, bias, x, 0.2, seed, 0.3),
                  pairs * (4 * E + 2 * D), in_bytes + B * N * D * 8 + 2 * B * N * 4),
        "k2a": (lambda: kg.gatv2_bwd_dp_da(*args), pairs * (7 * E + 2 * D + 4),
                in_bytes + stats_bytes + B * N * E * 4 + E * 4),
        "k2b": (lambda: kg.gatv2_bwd_dq_dv(*args), pairs * (5 * E + 4 * D + 4),
                in_bytes + stats_bytes + B * N * (E + D) * 4),
        "k2c": (lambda: kg.gatv2_bwd_dbias(*args), pairs * (4 * E + 2 * D + 4),
                in_bytes + stats_bytes + N * N * 4),
        "k2b_dbias": (lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True),
                      pairs * (5 * E + 4 * D + 5),
                      in_bytes + stats_bytes + B * N * (E + D) * 4 + N * N * 4),
        "k2b_k2c": (lambda: (kg.gatv2_bwd_dq_dv(*args), kg.gatv2_bwd_dbias(*args)),
                    pairs * (5 * E + 4 * D + 5),
                    in_bytes + stats_bytes + B * N * (E + D) * 4 + N * N * 4),
        "bwd": (lambda: kg.gatv2_bwd(*args, dbias=True), pairs * (8 * E + 4 * D + 5),
                in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4),
        "bwd_k2c": (lambda: (tiled_bwd(kg, args), kg.gatv2_bwd_dbias(*args)),
                    pairs * (8 * E + 4 * D + 5),
                    in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4),
    }
    times = {}
    for k, (fn, ops, nbytes) in spec.items():
        bound_ms, bound_by = bound(ops, nbytes)
        times[k] = {"graph_ms": graph_ms(fn, calls=3, replays=2), "bound_ms": bound_ms,
                    "bound_by": bound_by}
        times[k]["over_bound"] = times[k]["graph_ms"] / bound_ms
        times[k]["variant"] = "tiled"
        if k in ("k2a", "k2b", "k2b_dbias"):
            times[k]["plan"] = tiled_plans(kg)[k[:3]]
        if k in ("k1", "k1res"):
            times[k]["plan"] = kg.gatv2_attention_fwd.last_launch["plan"]
            times[k]["blocks_per_multiprocessor"] = kg._fwd_lib().gatv2_fwd_tiled_occupancy(
                E, D, int(k == "k1res"))
    emit({"phase": "dense_route", "case": f"tiled kernels at the route's N, b 1, N {N}, E {E}, "
          f"D {D}, float32, dropout 0.3, bias; graph_ms from a CUDA graph of 3 calls",
          "times": times})
    return times


LONG_WINDOW = dict(lookback=1024, temporal_graph="band:128", bias_storage="band", bs=64,
                   attention_impl="dense", gru_impl="auto", compute_dtype="float32")


def check_block_scan_vs_coo(gen, dev) -> None:
    """At a small size on the card: the block scan and the unrolled banded
    path against the COO path on the banded graph, forward and gradients,
    float32, TF32 off."""
    from mtad_gat_tpu_torch.graph import banded_graph, ops

    b, n, e, d = 4, 300, 16, 8

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    for w, block in ((40, 32), (8, 0)):
        leaves = [r(b, n, e, scale=0.5), r(b, n, e, scale=0.5), r(e, scale=0.3),
                  r(n, 2 * w + 1, scale=0.3), r(b, n, d)]
        cot = r(b, n, d)
        graph = banded_graph(n, w)
        graph = type(graph)(graph.src.to(dev), graph.dst.to(dev), n)

        def coo(p, q, a, bias, v):
            s = ops.gatv2_scores_coo(graph, p, q, a, 0.2)
            return ops.gat_aggregate_coo(graph, s, v, ops.banded_bias_to_full(bias, n, w))

        if block:
            def banded(p, q, a, bias, v):
                return ops.banded_attention_scan(p, q, a, bias, v, 0.2, w, block_size=block,
                                                 bias_storage="band")
        else:
            def banded(p, q, a, bias, v):
                return ops.gatv2_banded_attention(p, q, a, bias, v, 0.2, w, bias_storage="band")

        res = []
        for fn in (banded, coo):
            xs = [t.detach().requires_grad_() for t in leaves]
            out = fn(*xs)
            res.append((out.detach(), torch.autograd.grad((out * cot).sum(), xs)))
        (out_b, g_b), (out_c, g_c) = res
        errs = {"out": (out_b - out_c).abs().max().item(),
                "grads": max((x - y).abs().max().item() for x, y in zip(g_b, g_c))}
        # the COO forward sums segments in a fixed order: the same bits twice
        with torch.no_grad():
            same = torch.equal(coo(*leaves), out_c)
        what = f"block scan B {block}" if block else "unrolled"
        emit({"phase": "long_window", "case": f"{what} against COO, b {b}, N {n}, W {w}, "
              f"E {e}, D {d}, float32, band-stored bias", "max_abs_err": errs, "tol": SCAN_TOL,
              "coo_two_calls_identical": same})
        if not (max(errs.values()) <= SCAN_TOL and same):
            raise AssertionError(f"{what} and COO differ on the card, or COO's bits "
                                 f"differ between calls: {errs}, {same}")


def check_long_window(gen, dev, work) -> dict:
    """The port's Trainer at lookback 1024 on band:128 with the band-stored
    bias (the block scan), batch 64, float32, gru_impl auto (K3, K4): 2
    epochs of 4 steps at dropout 0.3, finite losses, exact launch counts,
    windows/s and peak memory; then the block scan against COO."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import synthetic_series
    from mtad_gat_tpu_torch.data.windows import batched_starts
    from mtad_gat_tpu_torch.graph.ops import BAND_UNROLL_CUTOFF
    from mtad_gat_tpu_torch.training import Trainer

    cfg = RunConfig(**LONG_WINDOW, epochs=2, log_tensorboard=False)
    steps, epochs = 4, 2
    n_win = steps * cfg.bs
    series, _, _ = synthetic_series(n_train=cfg.lookback + n_win, n_test=16, n_features=38)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg.model_config(38, 38), cfg.train_config(),
                      log_dir=os.path.join(work, "logs_long_window"), device="cuda")
    trainer.init_state()
    gat = trainer.model.temporal_gat
    dev_series = trainer._series(series)
    starts, mask, _ = batched_starts(0, cfg.bs, indices=np.arange(n_win))
    reset_counts()
    seconds, losses = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch(dev_series, starts, mask))  # ends in a device sync
        seconds.append(time.perf_counter() - t0)
    counts = read_counts()
    want = {"gru_scan_fwd": 2 * steps * epochs, "gru_scan_bwd": 2 * steps * epochs,
            "gru_weight_grads": 2 * steps * epochs}
    flat = [float(v) for epoch in losses for v in np.ravel(epoch)]
    rec = {"phase": "long_window", "config": LONG_WINDOW, "dropout": cfg.dropout,
           "steps_per_epoch": steps, "epochs": epochs, "temporal_bias_shape": list(gat.bias.shape),
           "path": "block scan" if gat.band > BAND_UNROLL_CUTOFF else "unrolled",
           "epoch_seconds": seconds, "epoch_windows_per_s": [n_win / s for s in seconds],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "losses": flat, "launches": counts, "expected_launches": want}
    emit(rec)
    if not np.all(np.isfinite(flat)):
        raise AssertionError(f"long window: losses {flat}")
    if list(gat.bias.shape) != [1024, 257]:
        raise AssertionError(f"long window: bias of shape {list(gat.bias.shape)}")
    expect_counts("long window", counts, want)
    del trainer, dev_series
    torch.cuda.empty_cache()
    check_block_scan_vs_coo(gen, dev)
    return {"launches": counts, "windows_per_s": n_win / seconds[-1],
            "max_memory_allocated": rec["max_memory_allocated"]}


def check_graph_cli(work, data_root) -> dict:
    """train_cli with the README's graph variants (--feature_graph knn:5
    --temporal_graph band:10) on the synthetic entity for 1 epoch, then
    predict_cli on the run: the same summary; K3 and K4 launch as on the
    main path, the attention kernels never (the variants run plain ops)."""
    from mtad_gat_tpu_torch.cli import predict_cli, train_cli
    from mtad_gat_tpu_torch.config import RunConfig

    out_root = os.path.join(work, "graph_cli")
    common = ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root,
              "--output_root", out_root, "--device", "cuda"]
    argv = common + ["--feature_graph", "knn:5", "--temporal_graph", "band:10", "--epochs", "1",
                     "--log_tensorboard", "False", "--run_id", "graphs", "--seed", "0"]
    reset_counts()
    t0 = time.perf_counter()
    run = train_cli.main(argv)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    flagship = RunConfig()
    want, steps = expected_training_launches(2000, 2000, flagship.lookback, flagship.bs, 1,
                                             flagship.val_split, "pallas")
    want = {k: 0 if k.startswith("gatv2") else n for k, n in want.items()}
    with open(os.path.join(run, "config.txt")) as f:
        edges = json.load(f)["feature_edges"]
    summary = finite_summary(os.path.join(run, "summary.txt"))
    predict_cli.main(common + ["--model_id", "graphs"])
    same = finite_summary(os.path.join(run, "summary_1.txt")) == summary
    emit({"phase": "graph_cli", "run": "train_cli --feature_graph knn:5 --temporal_graph "
          "band:10, 1 epoch, then predict_cli", "seconds": seconds, "steps": steps,
          "feature_edges": len(edges[0]), "launches": counts, "expected_launches": want,
          "bf_f1": summary["bf_result"]["f1"], "predict_cli_reproduces_summary": same})
    if counts != want:
        raise AssertionError(f"graph_cli: launches {counts}, expected {want}")
    if len(edges[0]) != 38 * 6 or not same:
        raise AssertionError(f"graph_cli: {len(edges[0])} edges, summary reproduced: {same}")
    return counts


# train_cli at lookback 300: a short entity (700 rows of train and of test:
# 400 windows, 12 steps of 32 an epoch), 2 epochs, dropout 0
WIDE_LOOKBACK, WIDE_ROWS, WIDE_BS, WIDE_EPOCHS = 300, 700, 32, 2
# per-epoch losses, kernels against the dense run from one seed, float32,
# dropout 0: the feature layer's scores sum 600 terms in the whole-graph
# forward's order and its backward's chain where dense sums them pairwise,
# carried through 24 Adam steps (whose updates divide by each gradient's
# running RMS). 1e-4 of each loss.
WIDE_LOSS_TOL = 1e-4


def timed_train_cli(argv, out_root, entry=None) -> dict:
    """``train_cli.main(argv)`` (or ``entry(argv)``) on the card with
    ``Trainer.train_epoch`` timed by epoch (a device sync on each side):
    seconds of the call, launch counts, peak memory above the baseline,
    training windows/s by epoch, per-epoch losses, each step's (forecast,
    recon) loss, the summary, and the trainer and arguments of its last
    epoch (``last_epoch``, for a profiled epoch after)."""
    from mtad_gat_tpu_torch.cli import train_cli
    from mtad_gat_tpu_torch.training import Trainer

    real_epoch = Trainer.train_epoch
    epochs, step_losses, last = [], [], {}

    def timed_epoch(self, series, starts, mask):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_epoch(self, series, starts, mask)
        torch.cuda.synchronize()
        epochs.append((int(mask.sum()), time.perf_counter() - t0))
        step_losses.extend(zip(*(np.ravel(x).tolist() for x in out)))
        last.update(trainer=self, args=(series, starts, mask))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    Trainer.train_epoch = timed_epoch
    try:
        t0 = time.perf_counter()
        run = (entry or train_cli.main)(argv)
        seconds = time.perf_counter() - t0
    finally:
        Trainer.train_epoch = real_epoch
    with open(os.path.join(out_root, "SMD", "1-1", "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return {"seconds": seconds, "launches": read_counts(),
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - base,
            "train_windows_per_s_by_epoch": [w / s for w, s in epochs],
            "epoch_losses": records, "step_losses": step_losses,
            "summary": finite_summary(os.path.join(run, "summary.txt")), "last_epoch": last}


def loss_errors(got: list, want: list) -> tuple:
    """(every (key, got, want) of two runs' per-epoch forecast, recon and
    total losses, the largest difference relative to want's)."""
    losses = [(k, r[k], d[k]) for r, d in zip(got, want)
              for k in r if k.endswith(("forecast", "recon", "total"))]
    return losses, max(abs(x - y) / abs(y) for _, x, y in losses)


def check_wide_window(work, gen, dev) -> dict:
    """The widths beyond the first tiled design on their entry points.
    ``train_cli --lookback 300 --attention_impl pallas --gru_impl pallas`` at
    dropout 0 on a short synthetic entity: the feature layer (N 38, E 600, D
    300) runs the whole-graph K1 and K1-res on two row blocks and the
    streamed backward (where the tiled plan names the CHUNKED tile), the
    temporal layer (N 300, E 76, D 38) the tiled K1 and K1-res with their
    merge, FAST K2a and K2b; dbias comes from the streamed backward and K2b,
    K2c runs at neither. Launch counts
    exact by kernel and variant, finite losses and summary, training
    windows/s (``Trainer.train_epoch`` timed by epoch) and peak memory; the
    same run with ``--attention_impl dense`` gives the same per-epoch losses
    within ``WIDE_LOSS_TOL``. Then the feature layer at window 1200 (N 38, E
    2400, D 1200) in training through ``FeatureAttention(impl="pallas")``:
    the tiled K1-res and its merge, the streamed backward (with dbias),
    exact counts, output and gradients against the dense layer at dropout 0.
    Returns the launch counts of both."""
    from mtad_gat_tpu_torch.nn import FeatureAttention

    data_root = os.path.join(work, "wide_data")
    write_smd(data_root, WIDE_ROWS, anomaly=0.6)   # past the first scored row, 300
    runs = {}
    for impl in ("pallas", "dense"):
        out_root = os.path.join(work, f"wide_{impl}")
        argv = ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root,
                "--output_root", out_root, "--device", "cuda", "--lookback",
                str(WIDE_LOOKBACK), "--bs", str(WIDE_BS), "--epochs", str(WIDE_EPOCHS),
                "--dropout", "0", "--attention_impl", impl, "--gru_impl", "pallas",
                "--log_tensorboard", "False", "--run_id", "run", "--seed", "0"]
        runs[impl] = timed_train_cli(argv, out_root)
        runs[impl].pop("last_epoch")
    kern, dense = runs["pallas"], runs["dense"]
    want, steps = expected_training_launches(WIDE_ROWS, WIDE_ROWS, WIDE_LOOKBACK, WIDE_BS,
                                             WIDE_EPOCHS, 0.1, "pallas")
    losses, loss_err = loss_errors(kern["epoch_losses"], dense["epoch_losses"])
    rec = {"phase": "wide_window", "run": f"train_cli --lookback {WIDE_LOOKBACK} "
           "--attention_impl pallas --gru_impl pallas, dropout 0, against --attention_impl "
           "dense", "rows": WIDE_ROWS, "bs": WIDE_BS, "epochs": WIDE_EPOCHS, "steps": steps,
           "kernels": {k: v for k, v in kern.items() if k not in ("summary",)},
           "dense": {k: dense[k] for k in ("seconds", "peak_extra_bytes",
                                           "train_windows_per_s_by_epoch")},
           "expected_launches": want, "loss_rel_err": loss_err, "tol": WIDE_LOSS_TOL,
           "bf_f1": kern["summary"]["bf_result"]["f1"]}
    emit(rec)
    if kern["launches"] != want:
        raise AssertionError(f"wide_window train_cli: launches {kern['launches']}, "
                             f"expected {want}")
    if not (len(losses) >= 6 * WIDE_EPOCHS and loss_err <= WIDE_LOSS_TOL
            and all(np.isfinite(x) for _, x, _ in losses)):
        raise AssertionError(f"wide_window: losses {losses} beyond {WIDE_LOSS_TOL}")

    # the feature layer at window 1200, one training call through the layer
    seeded = lambda: torch.Generator().manual_seed(13)  # noqa: E731
    layer = FeatureAttention(38, 1200, 0.0, 0.2, impl="pallas", generator=seeded())
    with torch.no_grad():
        layer.bias.normal_(0.0, 0.1, generator=seeded())
    layer.to(dev).train()
    x = torch.randn(2, 1200, 38, generator=gen).to(dev)
    cot = torch.randn(2, 1200, 38, generator=gen).to(dev)
    reset_counts()
    out, grads = layer_grads(layer, x, None, cot)
    torch.cuda.synchronize()
    counts = read_counts()
    layer.impl = "dense"
    out_d, grads_d = layer_grads(layer, x, None, cot)
    torch.cuda.synchronize()
    errs = {"out": (out - out_d).abs().max().item(),
            "grads": max(rel_err(g, h) for g, h in zip(grads, grads_d))}
    emit({"phase": "wide_window", "case": "feature layer at window 1200 (N 38, E 2400, D "
          "1200), b 2, float32, dropout 0, one training call, against the dense layer",
          "max_err": errs, "tol": {"out": ROUTE_TOL, "grads_rel": TRAIN_TOL[torch.float32]["grad"]},
          "launches": counts})
    expect_counts("window 1200 feature layer", counts, {
        "gatv2_attention_res": 1, "gatv2_attention_res:tiled": 1, "gatv2_fwd_merge": 1,
        "gatv2_bwd_streamed": 1, "gatv2_bwd_streamed:dbias": 1})
    if not (errs["out"] <= ROUTE_TOL and errs["grads"] <= TRAIN_TOL[torch.float32]["grad"]):
        raise AssertionError(f"the window 1200 feature layer differs from dense: {errs}")
    del layer, x, cot, out, grads, out_d, grads_d
    torch.cuda.empty_cache()
    return {"train_cli": kern["launches"], "layer": counts, "rec": rec}


def wide_counts(wide: dict, key: str) -> int:
    """Launches under ``key`` ("name:variant") on the wide_window path."""
    return wide["train_cli"][key] + wide["layer"][key]


# train_cli at lookback 1024 on complete graphs through the attention kernels:
# 1,700 rows of train and of test (676 windows: 609 to train, 10 steps of 64
# an epoch), 2 epochs at the reference's dropout 0.3; the anomaly past the
# first scored row, 1024
LONG_LOOKBACK, LONG_ROWS, LONG_BS, LONG_EPOCHS, LONG_ANOMALY = 1024, 1700, 64, 2, 0.7
# the parity runs against --attention_impl dense: batch 8 (dense at batch 64
# would hold the temporal layer alone near 68 GB, by its byte model), 1
# epoch, dropout 0, one seed. On an entity of 1,120 rows (11 steps, as few
# as wide_window's epochs hold) per-epoch losses within WIDE_LOSS_TOL and
# every step's within TRAIN_PATH_TOL's; on the 1,700-row entity (77 steps)
# the first LONG_PARITY_STEPS steps' losses within TRAIN_PATH_TOL's, as
# phase 9 holds its 7 steps, and the per-epoch losses reported: over 77 Adam
# steps the two paths' last-bit differences in near-zero gradients of the
# (1024, 1024) score bias move those entries by up to lr a step each (the
# reason TRAIN_PATH_TOL gives), so the runs drift apart step by step
LONG_PARITY_BS, LONG_PARITY_ROWS, LONG_PARITY_STEPS = 8, 1120, 7


def check_long_complete(work, dev, smi: str) -> dict:
    """``train_cli --lookback 1024 --attention_impl pallas --gru_impl pallas
    --bs 64 --dropout 0.3`` on complete feature and temporal graphs (the
    defaults), float32, 2 epochs: the temporal layer (N 1024, E 76, D 38)
    runs the tiled K1 and K1-res with their merge and the FAST K2a and K2b,
    the feature layer (N 38, E 2048, D 1024) the tiled forward with E and D
    in chunks and the streamed backward; dbias from K2b and the streamed
    backward, K2c and the CHUNKED tile at neither; K3, K4's scan and its
    weights product run twice a step at T 1024. Launch counts exact by
    kernel and variant, finite losses and
    summary, training windows/s by epoch, peak memory above the baseline,
    device time by kernel over one profiled epoch. Then the same entry point
    at batch 8, dropout 0, 1 epoch, ``--attention_impl pallas`` and
    ``dense`` from one seed, on a 1,120-row entity (per-epoch losses within
    ``WIDE_LOSS_TOL``, every step's within ``TRAIN_PATH_TOL``'s) and on the
    phase's own (the first ``LONG_PARITY_STEPS`` steps' losses within
    ``TRAIN_PATH_TOL``'s, the rest and the per-epoch losses reported).
    Returns the launch counts of the batch-64 run and its records."""
    import mtad_gat_tpu_torch.nn.gat as ngat

    data_root = os.path.join(work, "long_data")
    write_smd(data_root, LONG_ROWS, anomaly=LONG_ANOMALY)
    common = ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root, "--device",
              "cuda", "--lookback", str(LONG_LOOKBACK), "--gru_impl", "pallas",
              "--log_tensorboard", "False", "--run_id", "run", "--seed", "0"]
    out_root = os.path.join(work, "long_complete")
    run = timed_train_cli(common + ["--output_root", out_root, "--attention_impl", "pallas",
                                    "--bs", str(LONG_BS), "--dropout", "0.3",
                                    "--epochs", str(LONG_EPOCHS)], out_root)
    last = run.pop("last_epoch")
    want, steps = expected_training_launches(LONG_ROWS, LONG_ROWS, LONG_LOOKBACK, LONG_BS,
                                             LONG_EPOCHS, 0.1, "pallas")
    losses = [r[k] for r in run["epoch_losses"] for k in r if k.endswith("total")]
    threshold = ngat.dense_route_threshold(dev)
    dense_bytes = ngat.dense_gatv2_bytes(LONG_BS, LONG_LOOKBACK, 76, 4, True)
    # each layer's tiled forward and backward kernels: their bounds at the
    # run's shapes, counted as time_training_kernels counts them
    bounds = {}
    for layer, (N, E, D) in (("temporal", (LONG_LOOKBACK, 76, 38)),
                             ("feature", (38, 2 * LONG_LOOKBACK, LONG_LOOKBACK))):
        B, pairs = LONG_BS, LONG_BS * N * N
        in_bytes = (2 * B * N * E + E + B * N * D) * 4 + N * N * 4
        stats = 3 * B * N * 4 + B * N * D * 4
        bounds[layer] = {k: bound(ops, nbytes) for k, (ops, nbytes) in {
            "k1res": (pairs * (4 * E + 2 * D), in_bytes + B * N * D * 8 + 2 * B * N * 4),
            "k2a": (pairs * (7 * E + 2 * D + 4), in_bytes + stats + B * N * E * 4 + E * 4),
            "k2b_dbias": (pairs * (5 * E + 4 * D + 5),
                          in_bytes + stats + B * N * (E + D) * 4 + N * N * 4),
            "streamed": (pairs * (8 * E + 4 * D + 5),
                         in_bytes + stats + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4)
        }.items()}
    prof = profile_device(lambda: last["trainer"].train_epoch(*last["args"]),
                          f"one training epoch, train_cli --lookback {LONG_LOOKBACK} "
                          f"--attention_impl pallas --gru_impl pallas, batch {LONG_BS}, "
                          "float32, dropout 0.3", top=20)
    prof.update(phase="long_complete", steps=int(last["args"][1].shape[0]))
    del last
    torch.cuda.empty_cache()
    rec = {"phase": "long_complete", "card": smi,
           "run": f"train_cli --lookback {LONG_LOOKBACK} --attention_impl pallas --gru_impl "
                  f"pallas --bs {LONG_BS} --dropout 0.3, complete graphs, float32",
           "rows": LONG_ROWS, "epochs": LONG_EPOCHS, "steps": steps,
           **{k: v for k, v in run.items() if k != "summary"},
           "expected_launches": want, "bf_f1": run["summary"]["bf_result"]["f1"],
           "temporal_dense_bytes_at_batch": dense_bytes, "dense_route_threshold_bytes": threshold,
           "temporal_dense_routes": dense_bytes > threshold, "bounds_ms": bounds}
    emit(rec)
    emit(prof)
    if run["launches"] != want:
        raise AssertionError(f"long_complete train_cli: launches {run['launches']}, "
                             f"expected {want}")
    if not (len(losses) == 2 * LONG_EPOCHS and np.all(np.isfinite(losses))):
        raise AssertionError(f"long_complete: losses {losses}")

    # parity at batch 8, dropout 0: the kernels against dense from one seed,
    # on a short entity and on the phase's own
    parity, bad = [], []
    for rows in (LONG_PARITY_ROWS, LONG_ROWS):
        root = os.path.join(work, f"long_parity_{rows}")
        data = data_root if rows == LONG_ROWS else os.path.join(root, "data")
        if rows != LONG_ROWS:
            write_smd(data, rows, anomaly=0.93)      # past the first scored row, 1024
        runs = {}
        for impl in ("pallas", "dense"):
            out_root = os.path.join(root, impl)
            argv = [data if x == data_root else x for x in common]
            runs[impl] = timed_train_cli(argv + ["--output_root", out_root, "--attention_impl",
                                                 impl, "--bs", str(LONG_PARITY_BS), "--dropout",
                                                 "0", "--epochs", "1"], out_root)
            runs[impl].pop("last_epoch")
        pwant, psteps = expected_training_launches(rows, rows, LONG_LOOKBACK, LONG_PARITY_BS,
                                                   1, 0.1, "pallas")
        plosses, perr = loss_errors(runs["pallas"]["epoch_losses"],
                                    runs["dense"]["epoch_losses"])
        step_err = [max(abs(x - y) for x, y in zip(k, d))
                    for k, d in zip(runs["pallas"]["step_losses"], runs["dense"]["step_losses"])]
        gated = len(step_err) if rows == LONG_PARITY_ROWS else LONG_PARITY_STEPS
        prec = {"phase": "long_complete", "case": f"batch {LONG_PARITY_BS}, dropout 0, 1 epoch, "
                f"--attention_impl pallas against dense, one seed, {rows} rows",
                "rows": rows, "steps": psteps, "epoch_loss_rel_err": perr,
                "epoch_loss_tol": WIDE_LOSS_TOL if rows == LONG_PARITY_ROWS else "reported",
                "losses": plosses, "step_loss_max_abs_err": step_err,
                "steps_held": gated, "step_loss_tol": TRAIN_PATH_TOL["loss"],
                "launches": runs["pallas"]["launches"], "expected_launches": pwant,
                **{f"{impl}_{k}": runs[impl][k] for impl in runs
                   for k in ("seconds", "peak_extra_bytes", "train_windows_per_s_by_epoch")}}
        emit(prec)
        parity.append(prec)
        if runs["pallas"]["launches"] != pwant:
            bad.append(f"{rows} rows: launches {runs['pallas']['launches']}, expected {pwant}")
        if not (len(step_err) == psteps and max(step_err[:gated]) <= TRAIN_PATH_TOL["loss"]
                and all(np.isfinite(x) for _, x, _ in plosses)
                and (rows != LONG_PARITY_ROWS or perr <= WIDE_LOSS_TOL)):
            bad.append(f"{rows} rows: epoch losses {plosses} (relative {perr}), step losses "
                       f"{step_err[:gated]} beyond {WIDE_LOSS_TOL} and "
                       f"{TRAIN_PATH_TOL['loss']}")
    if bad:
        raise AssertionError(f"long_complete parity: {bad}")
    torch.cuda.empty_cache()
    return {"launches": run["launches"], "rec": rec, "profile": prof, "parity": parity}


# ---------------------------------------------------------------------------
# Serving: serve_cli point by point and by chunks on phase 5's run
# ---------------------------------------------------------------------------

SERVE_RUN = "01012026_000000"
SERVING_CHUNKS = (1, 8, 32, 128, 512)
PROFILE_POINTS = 512


def check_k1_batch1(gen, dev) -> dict:
    """K1 at batch 1, the serving path's shape at chunk 1, at both flagship
    layers (float32, bias) against its plain version, twice for identical
    bits; its device time by CUDA graph beside its bound and the plain
    version's time."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    out = {}
    for name, N, E, D in (("feature", 38, 200, 100), ("temporal", 100, 76, 38)):
        p, q, a, bias, v = gat_case(gen, dev, 1, N, E, D, torch.float32, True)
        got = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)
        launch = dict(kg.gatv2_attention_fwd.last_launch)
        again = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)
        want = kg.gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        nbytes = (2 * N * E + E + 2 * N * D) * 4 + N * N * 4
        bound_ms, bound_by = bound(N * N * (4 * E + 2 * D), nbytes)
        rec = {"phase": "serving", "case": f"K1 at batch 1, {name} layer", "B": 1, "N": N,
               "E": E, "D": D, "dtype": "float32", "bias": True, **launch,
               "max_abs_err": err, "tol": K1_TOL[torch.float32],
               "two_launches_identical": torch.equal(got, again),
               "graph_ms": graph_ms(lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)),
               "plain_ms": time_ms(lambda: kg.gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2),
                                   20),
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(rec)
        if not (err <= K1_TOL[torch.float32] and rec["two_launches_identical"]):
            raise AssertionError(f"K1 at batch 1 ({name}) differs from its plain version: {rec}")
        if launch["variant"] != "graph":
            raise AssertionError(f"K1 at batch 1 ({name}) ran {launch}, expected the "
                                 "whole-graph kernel")
        out[name] = rec
    return out


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of the plain attention (dense scores and aggregate,
    K1's, K1-res's and the backward's plain versions) and the plain GRU (its
    per-step loop, K3's plain version) while the block runs."""
    import mtad_gat_tpu_torch.kernels.gat as kg
    import mtad_gat_tpu_torch.kernels.gru as kgru
    import mtad_gat_tpu_torch.nn.gat as ngat
    import mtad_gat_tpu_torch.nn.gru as ngru

    targets = [(kg, "gatv2_attention_fwd_plain"), (kg, "gatv2_attention_res_plain"),
               (ngat, "gatv2_scores_dense"), (ngat, "gat_aggregate_dense"),
               (kgru, "gru_scan_fwd_plain"), (ngru, "gru_step"),
               (kg, "gatv2_attention_bwd_plain")]
    counts = dict.fromkeys((name for _, name in targets), 0)
    real = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    for mod, name, fn in real:
        setattr(mod, name, counted(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)


def serve(data_root, out_root, stream, output, chunk, method="epsilon", state_file=None):
    """``serve_cli.main --device cuda`` on the run under ``out_root``;
    returns its records, the kernels' launches, the plain calls and the
    seconds of the call."""
    from mtad_gat_tpu_torch.cli import serve_cli

    argv = ["--dataset", "SMD", "--group", "1-1", "--model_id", SERVE_RUN,
            "--data_root", data_root, "--output_root", out_root, "--input", stream,
            "--output", output, "--chunk", str(chunk), "--flush_ms", "0",
            "--threshold_method", method, "--device", "cuda"]
    if state_file:
        argv += ["--state_file", state_file]
    reset_counts()
    with plain_calls() as plain:
        t0 = time.perf_counter()
        summary = serve_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    with open(output) as f:
        records = [json.loads(line) for line in f]
    return records, summary, read_counts(), dict(plain), seconds


def expect_serving_launches(name: str, counts: dict, plain: dict, forwards: int) -> None:
    """Each forward: K1 twice (the whole-graph kernel) and K3 twice; no other
    kernel and no plain attention or GRU call."""
    want = {"gatv2_attention_fwd": 2 * forwards, "gatv2_attention_fwd:graph": 2 * forwards,
            "gru_scan_fwd": 2 * forwards}
    wrong = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    if wrong or any(plain.values()):
        raise AssertionError(f"serving {name}: launches {counts}, plain calls {plain}; "
                             f"expected {want} ({forwards} forwards) and no plain call")


def chunks_of(n: int, chunk: int) -> int:
    return -(-n // chunk)


def serving_records_errors(got, want) -> float:
    return float(np.max(np.abs(np.array([r["score"] for r in got])
                               - np.array([r["score"] for r in want]))))


def replay_threshold(name, records, spot, train_scores, **init_kw) -> int:
    """The served alarms and thresholds of a streaming POT run against the
    offline ``run`` of the same class over the served scores (``step``
    replays ``run`` point for point); returns the alarms."""
    spot.fit(train_scores, np.array([r["score"] for r in records]))
    spot.initialize(**init_kw)
    res = spot.run(with_alarm=True)
    alarms = [i for i, r in enumerate(records) if r["is_anomaly"]]
    if alarms != list(res["alarms"]) or [r["threshold"] for r in records] != list(
            res["thresholds"]):
        raise AssertionError(f"serving {name}: alarms or thresholds differ from the offline "
                             "run over the served scores")
    return len(alarms)


class TimedSink:
    """A record sink that keeps nothing and notes the time of each flush:
    ``_serve_loop`` flushes once a chunk, after the chunk's records."""

    def __init__(self):
        self.flushes = []

    def write(self, text):
        pass

    def flush(self):
        self.flushes.append(time.perf_counter())

    def close(self):
        pass


def serving_numbers(run, data_root, stream, short_stream, smi, dev) -> dict:
    """Points/s by chunk (a warm-up pass, then the best of 3, each pass the
    whole stream from its CSV: parse, scale, score, write), the time per
    chunk from its yield to its written records (p50, p99) at chunks 1 and
    128, and one profiled pass at each of those over the first
    ``PROFILE_POINTS`` rows: serve_cli's own stream, scoring and serving
    loop around a scorer set up as its ``main`` sets it up."""
    from mtad_gat_tpu_torch.cli import serve_cli
    from mtad_gat_tpu_torch.cli.predict_cli import load_run_model
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data, normalize_data
    from mtad_gat_tpu_torch.inference import OnlineScorer

    cfg = RunConfig.load(os.path.join(run, "config.txt"))
    (x_train, _), _ = get_data("machine-1-1", data_root=data_root, normalize=True)
    (raw_train, _), _ = get_data("machine-1-1", data_root=data_root, normalize=False)
    _, scaler = normalize_data(raw_train)
    import pandas as pd

    train_scores = pd.read_pickle(os.path.join(run, "train_output.pkl"))["A_Score_Global"]
    scorer = OnlineScorer(load_run_model(run, cfg, 38, 38, dev),
                          cfg.lookback, 38, gamma=cfg.gamma)
    scorer.fit_threshold(train_scores.to_numpy(), method="epsilon")
    scorer.update_many(x_train[-cfg.lookback:])

    def score_chunk(batch):
        batch = scaler.transform(np.nan_to_num(np.asarray(batch, np.float32)))
        for rec in scorer.update_many(batch):
            yield serve_cli._record_json(rec, 0)

    def one_pass(chunk, source=stream):
        sink, yields = TimedSink(), []

        def chunks():
            for batch in serve_cli._stream_chunks(source, 38, chunk, flush_ms=0):
                yields.append(time.perf_counter())
                yield batch

        t0 = time.perf_counter()
        n_pts, _ = serve_cli._serve_loop(chunks(), score_chunk, sink, None)
        seconds = time.perf_counter() - t0
        return n_pts, seconds, [(f - y) * 1e3 for y, f in zip(yields, sink.flushes)]

    rates, latency = {}, {}
    for chunk in SERVING_CHUNKS:
        one_pass(chunk)
        passes = [one_pass(chunk) for _ in range(3)]
        rates[chunk] = max(n / s for n, s, _ in passes)
        if chunk in (1, 128):
            ms = np.concatenate([lat for _, _, lat in passes])
            latency[chunk] = {"p50_ms": float(np.percentile(ms, 50)),
                              "p99_ms": float(np.percentile(ms, 99)),
                              "chunks": int(ms.size)}
    rec = {"phase": "serving", "case": "numbers", "card": smi, "points": passes[0][0],
           "points_per_s_by_chunk": rates, "chunk_ms_from_yield_to_write": latency,
           "what": "points/s: the best of 3 passes over the CSV after a warm-up one; chunk "
                   "ms: every chunk of the 3 passes"}
    emit(rec)
    profiles = {}
    for chunk in (1, 128):
        prof = profile_device(lambda: one_pass(chunk, short_stream),
                              f"serving, chunk {chunk}, the first {PROFILE_POINTS} points, "
                              "float32, kernels on")
        prof["phase"] = "serving"
        emit(prof)
        profiles[chunk] = prof
    return {**rec, "profiles": profiles}


def check_serving(gen, dev, work, k3_batch1, smi) -> dict:
    """``serve_cli`` on phase 5's run directory: K1 at batch 1; the test
    split streamed from a CSV at chunks 1 and 128 (epsilon), at 128 with spot
    and, on a copy of the run without cached train scores, with dspot; the
    plain paths' run at 128; exact launch counts and no plain call; scores
    against get_score and between chunk sizes; kill and resume; the
    numbers."""
    import pandas as pd

    from mtad_gat_tpu_torch.cli.predict_cli import load_run_model
    from mtad_gat_tpu_torch.config import RunConfig, lookup_pot_params
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.inference import SPOT, Predictor, dSPOT

    k1 = check_k1_batch1(gen, dev)
    emit({"phase": "serving", "case": "K3 at batch 1 (phase 4's 'batch 1' record)",
          **{k: k3_batch1[k] for k in ("B", "T", "H", "max_abs_err", "ms", "bound_ms",
                                       "bound_by", "variant", "cluster")}})
    data_root = os.path.join(work, "data")
    kern_root, plain_root = os.path.join(work, "kernels_f32"), os.path.join(work, "plain_f32")
    run = os.path.join(kern_root, "SMD", "1-1", SERVE_RUN)
    cfg = RunConfig.load(os.path.join(run, "config.txt"))
    w = cfg.lookback
    (x_train, _), (x_test, _) = get_data("machine-1-1", data_root=data_root, normalize=True)
    _, (raw_test, _) = get_data("machine-1-1", data_root=data_root, normalize=False)
    n = len(raw_test)
    d = os.path.join(work, "serve")
    os.makedirs(d)
    stream, short = os.path.join(d, "stream.csv"), os.path.join(d, "short.csv")
    np.savetxt(stream, raw_test, delimiter=",")
    np.savetxt(short, raw_test[:PROFILE_POINTS], delimiter=",")
    # a copy of the run without its scored outputs: serve_cli scores the
    # training split to calibrate
    uncached_root = os.path.join(work, "serve_uncached")
    shutil.copytree(run, os.path.join(uncached_root, "SMD", "1-1", SERVE_RUN),
                    ignore=shutil.ignore_patterns("*_output.pkl", "summary*"))
    calib_batches = chunks_of(len(x_train) - w + 1, cfg.bs)

    model = load_run_model(run, cfg, 38, 38, dev)
    offline = Predictor(model, w, 38, {
        "dataset": "SMD", "target_dims": None, "scale_scores": False, "q": 1e-3,
        "level": 0.99, "dynamic_pot": False, "use_mov_av": False, "gamma": cfg.gamma,
        "reg_level": 1, "save_path": work}, batch_size=cfg.bs).get_score(
            np.concatenate([x_train[-w:], x_test]))["A_Score_Global"].to_numpy()
    level, q, _ = lookup_pot_params("SMD", "1-1", cfg.level, cfg.q)
    train_scores = pd.read_pickle(os.path.join(run, "train_output.pkl"))[
        "A_Score_Global"].to_numpy()

    runs, launches = {}, dict.fromkeys(KERNEL_COUNTERS, 0)
    cases = (("chunk 1, epsilon", kern_root, 1, "epsilon", 0),
             ("chunk 128, epsilon", kern_root, 128, "epsilon", 0),
             ("chunk 128, spot", kern_root, 128, "spot", 0),
             ("chunk 128, dspot, calibrated by scoring", uncached_root, 128, "dspot",
              calib_batches),
             ("chunk 128, epsilon, plain paths", plain_root, 128, "epsilon", None))
    for name, root, chunk, method, calib in cases:
        out = os.path.join(d, f"{len(runs)}.jsonl")
        records, summary, counts, plain, seconds = serve(data_root, root, stream, out, chunk,
                                                         method)
        forwards = None if calib is None else chunks_of(w, chunk) + chunks_of(n, chunk) + calib
        err = float(np.max(np.abs(np.array([r["score"] for r in records]) - offline)))
        rec = {"phase": "serving", "run": f"serve_cli {name}", "seconds": seconds,
               "points": summary["points"], "alarms": summary["alarms"], "forwards": forwards,
               "k1_launches": counts["gatv2_attention_fwd"], "k3_launches": counts["gru_scan_fwd"],
               "plain_calls": plain, "max_abs_err_vs_get_score": err, "tol": SCORE_ATOL}
        if [r["t"] for r in records] != list(range(w, w + n)):
            raise AssertionError(f"serving {name}: record i does not score test point i")
        if not err <= SCORE_ATOL:
            raise AssertionError(f"serving {name}: scores {err} from get_score")
        if calib is None:
            if counts["gatv2_attention_fwd"] or counts["gru_scan_fwd"] or not all(
                    plain[k] for k in ("gatv2_scores_dense", "gru_step")):
                raise AssertionError(f"serving {name}: launches {counts}, plain calls {plain}")
            rec["max_abs_err_vs_kernels"] = serving_records_errors(records,
                                                                  runs["chunk 128, epsilon"])
            if not rec["max_abs_err_vs_kernels"] <= SCORE_ATOL:
                raise AssertionError(f"serving {name}: {rec} from the kernels' scores")
        else:
            expect_serving_launches(name, counts, plain, forwards)
            for k in launches:
                launches[k] += counts[k]
        if method == "epsilon":
            if any(r["is_anomaly"] != (r["score"] > r["threshold"]) for r in records):
                raise AssertionError(f"serving {name}: an alarm is not score > threshold")
        elif method == "spot":
            rec["alarms_replayed"] = replay_threshold(name, records, SPOT(q), train_scores,
                                                      level=level)
            rec["spot"] = {"q": q, "level": level}
        else:
            calib_scores = np.load(os.path.join(uncached_root, "SMD", "1-1", SERVE_RUN,
                                                "train_scores_raw.npy"))
            rec["calibration_max_abs_err_vs_cached"] = float(np.max(np.abs(
                calib_scores - train_scores)))
            rec["alarms_replayed"] = replay_threshold(name, records, dSPOT(q, 450),
                                                      calib_scores)
        emit(rec)
        runs[name] = records
    c1 = serving_records_errors(runs["chunk 1, epsilon"], runs["chunk 128, epsilon"])
    emit({"phase": "serving", "check": "chunk 1 against chunk 128 scores", "max_abs_err": c1,
          "tol": SCORE_ATOL})
    if not c1 <= SCORE_ATOL:
        raise AssertionError(f"serving: chunk 1 and chunk 128 scores {c1} apart")

    for chunk in (1, 128):
        rd = os.path.join(d, f"resume_{chunk}")
        os.makedirs(rd)
        grow, state, out = (os.path.join(rd, f) for f in ("grow.csv", "serve.state", "out.jsonl"))
        half = n // 2
        np.savetxt(grow, raw_test[:half], delimiter=",")
        _, first, c_first, p_first, _ = serve(data_root, kern_root, grow, out, chunk,
                                             state_file=state)
        expect_serving_launches(f"resume, chunk {chunk}, first half", c_first, p_first,
                                chunks_of(w, chunk) + chunks_of(half, chunk))
        np.savetxt(grow, raw_test, delimiter=",")          # the file grows
        other = os.path.join(rd, "..", os.path.basename(rd), ".", "grow.csv")
        records, second, c_second, p_second, _ = serve(data_root, kern_root, other, out, chunk,
                                                       state_file=state)
        expect_serving_launches(f"resume, chunk {chunk}, second half", c_second, p_second,
                                chunks_of(n - half, chunk))
        for counts in (c_first, c_second):
            for k in launches:
                launches[k] += counts[k]
        want = runs[f"chunk {chunk}, epsilon"]
        err = serving_records_errors(records, want) if len(records) == n else None
        rec = {"phase": "serving", "case": f"kill and resume, chunk {chunk}",
               "points": [first["points"], second["points"]],
               "second_run_input": other, "max_abs_err_vs_uninterrupted": err,
               "identical": records == want}
        emit(rec)
        if (first["points"], second["points"]) != (half, n - half) or err is None:
            raise AssertionError(f"serving: the resumed run served {rec['points']} points")
        if chunk == 1 and records != want:
            raise AssertionError("serving: kill and resume at chunk 1 differs from the "
                                 "uninterrupted run")
        if not err <= SCORE_ATOL or any(
                r["is_anomaly"] != (r["score"] > r["threshold"]) for r in records):
            raise AssertionError(f"serving: kill and resume at chunk {chunk}: {rec}")

    numbers = serving_numbers(run, data_root, stream, short, smi, dev)
    return {"k1": k1, "k3": k3_batch1, "launches": launches, "numbers": numbers}


# ---------------------------------------------------------------------------
# Fleet serving: K1 and K3 with an entity axis, and serve_cli over 28 machines
# ---------------------------------------------------------------------------

# rows a served machine's train and test splits hold (2,000 before phase
# fleet_wide_features needed the time)
FLEET_SERVE_ROWS = 500
FLEET_GROUPS = tuple([f"1-{i}" for i in range(1, 9)] + [f"2-{i}" for i in range(1, 10)]
                     + [f"3-{i}" for i in range(1, 12)])      # SMD's 28 machines
FLEET_ROWS = (1, 128)            # rows a group: chunk 1 and chunk 128
FLEET_ATOL = 1e-5


def grouped_record(name, kernel, G, rows, got, per, want, tol, grouped_fn, per_fn, nbytes, ops,
                   plans=None) -> dict:
    """A grouped launch against G ungrouped launches (bits) and the grouped
    plain version (tolerance), both timed by CUDA graph; raises on a
    failure. ``plans``: (grouped, ungrouped) tiled plans, where they differ
    in slices the bits may too (the merge sums the slices in order)."""
    torch.cuda.synchronize()
    identical = torch.equal(got, per)
    err = (got.float() - want.float()).abs().max().item()
    calls = 3 if G * rows > 512 else 20
    bound_ms, bound_by = bound(ops, nbytes)
    rec = {"phase": "fleet_serving", "case": f"grouped {kernel}, {name}", "G": G,
           "rows_per_group": rows, "identical_to_G_launches": identical,
           "max_abs_err_vs_G_launches": (got.float() - per.float()).abs().max().item(),
           "max_abs_err": err, "tol": tol,
           "graph_ms": graph_ms(grouped_fn, calls=calls, replays=3),
           "G_launches_graph_ms": graph_ms(per_fn, calls=max(1, calls // 3), replays=3),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if plans is not None:
        rec["slices"] = [plans[0]["slices"], plans[1]["slices"]]
    emit(rec)
    sliced = plans is not None and plans[0]["slices"] != plans[1]["slices"]
    if not err <= tol or not (identical or (sliced and rec["max_abs_err_vs_G_launches"] <= tol)):
        raise AssertionError(f"grouped {kernel} ({name}): {rec}")
    return rec


def check_grouped_k1(gen, dev) -> dict:
    """K1 with an entity axis at the flagship's two layers, G 28 at 1 and 128
    batch elements a group, float32, bias: the whole-graph kernel as planned
    and the tiled kernel forced, each against G ungrouped launches (bit for
    bit, but where the tiled plans' slices differ) and the grouped plain
    version (``K1_TOL``), timed by CUDA graph beside the G launches."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    G = len(FLEET_GROUPS)
    out = {}
    for layer, N, E, D in (("feature", 38, 200, 100), ("temporal", 100, 76, 38)):
        for rows in FLEET_ROWS:
            B = G * rows
            p, q, _, _, v = gat_case(gen, dev, B, N, E, D, torch.float32, False)
            a = (torch.randn(G, E, generator=gen) * (6.0 / (E + 1)) ** 0.5).to(dev)
            bias = (0.1 * torch.randn(G, N, N, generator=gen)).to(dev)
            want = kg.gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2)
            for variant in ("graph", "tiled"):
                grouped = lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2,  # noqa: E731
                                                         variant=variant)

                def per_group():
                    return torch.cat([kg.gatv2_attention_fwd(
                        p[g * rows:(g + 1) * rows], q[g * rows:(g + 1) * rows], a[g], bias[g],
                        v[g * rows:(g + 1) * rows], 0.2, variant=variant) for g in range(G)])

                got = grouped()
                launch = dict(kg.gatv2_attention_fwd.last_launch)
                per = per_group()
                single = kg.gatv2_attention_fwd.last_launch
                if launch["variant"] != variant or launch["groups"] != G:
                    raise AssertionError(f"grouped K1 ran {launch}")
                nbytes = (2 * B * N * E + G * E + 2 * B * N * D + G * N * N) * 4
                plans = ((launch["plan"], single["plan"]) if variant == "tiled" else None)
                out[(layer, rows, variant)] = grouped_record(
                    f"{layer} layer ({B}, {N}, {E}, {D}), {variant}", "K1", G, rows, got, per,
                    want, K1_TOL[torch.float32], grouped, per_group, nbytes,
                    B * N * N * (4 * E + 2 * D), plans)
            del p, q, v, want
    return out


def check_grouped_k3(gen, dev) -> dict:
    """K3 with an entity axis, G 28 at 1 and 128 rows a group, T 100,
    float32: the cluster variant at hidden 150 and the streaming one at 384,
    each against G ungrouped launches (bit for bit) and the grouped plain
    version (``K3_TOL``), timed by CUDA graph beside the G launches."""
    from mtad_gat_tpu_torch.kernels import gru as kgru

    G, T = len(FLEET_GROUPS), 100
    out = {}
    for H, variant in ((150, "cluster"), (384, "streaming")):
        for rows in FLEET_ROWS:
            B = G * rows
            gi = torch.randn(B, T, 3 * H, generator=gen).to(dev)
            w_hh = (torch.rand(G, H, 3 * H, generator=gen) * 2 - 1).mul_(H ** -0.5).to(dev)
            b_hh = (torch.rand(G, 3 * H, generator=gen) * 2 - 1).mul_(H ** -0.5).to(dev)
            with torch.no_grad():
                want, _ = kgru.gru_scan_fwd_plain(gi, w_hh, b_hh, H)
                grouped = lambda: kgru.gru_scan_fwd(gi, w_hh, b_hh, H)[0]  # noqa: E731

                def per_group():
                    return torch.cat([kgru.gru_scan_fwd(gi[g * rows:(g + 1) * rows], w_hh[g],
                                                        b_hh[g], H)[0] for g in range(G)])

                got = grouped()
                launch = dict(kgru.gru_scan_fwd.last_launch)
                per = per_group()
                if launch["variant"] != variant or launch["groups"] != G:
                    raise AssertionError(f"grouped K3 ran {launch}, expected {variant}")
                tile = kgru.K3_BATCH_TILE if variant == "cluster" else kgru.STREAM_BATCH_TILE
                tiles = len(kgru.group_tiles(rows, G, tile))
                if kgru._lib().gru_fwd_tiles(B, rows, launch["cluster"]) != tiles:
                    raise AssertionError(f"grouped K3: the built kernel's tiles differ from "
                                         f"group_tiles' {tiles}")
                nbytes = (B * T * 3 * H + G * (H * 3 * H + 3 * H) + B * T * H) * 4
                rec = grouped_record(f"hidden {H} ({B}, {T}), {variant}", "K3", G, rows, got,
                                     per, want, K3_TOL, grouped, per_group, nbytes,
                                     2 * B * T * H * 3 * H)
                rec["tiles"] = tiles
                out[(H, rows)] = rec
            del gi, want
            torch.cuda.empty_cache()
    return out


def op_cost_per_forward(gen, dev) -> dict:
    """What the custom ops would cost the solo path a forward: host time of
    a batch-1 K1 call (both flagship layers) and K3 call (hidden 150)
    through ``gatv2_attention_fwd_op`` / ``gru_scan_fwd_op`` against the
    same call direct, 400 calls each queued without a sync (the card's work
    runs behind them), two K1 and two K3 calls a forward. Only batched calls
    enter the ops, so the solo path does not pay this."""
    from mtad_gat_tpu_torch.kernels import gat as kg
    from mtad_gat_tpu_torch.kernels import gru as kgru

    def host_us(fn, calls=400):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    out = {}
    with torch.no_grad():
        for name, N, E, D in (("k1_feature", 38, 200, 100), ("k1_temporal", 100, 76, 38)):
            p, q, a, bias, v = gat_case(gen, dev, 1, N, E, D, torch.float32, True)
            out[name] = (host_us(lambda: kg.gatv2_attention_fwd_op(p, q, a, bias, v, 0.2)),
                         host_us(lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)))
        _, _, gi, w_hh, b_hh = gru_case(gen, dev, 1, 100, 150, torch.float32)
        w_hh = w_hh.contiguous()
        out["k3"] = (host_us(lambda: kgru.gru_scan_fwd_op(gi, w_hh, b_hh, 150)),
                     host_us(lambda: kgru.gru_scan_fwd(gi, w_hh, b_hh, 150)))
    extra = {name: op - direct for name, (op, direct) in out.items()}
    rec = {"phase": "fleet_serving", "case": "the custom ops' host cost on the solo path",
           "host_us_op_and_direct": out,
           "op_cost_us_per_forward": extra["k1_feature"] + extra["k1_temporal"]
           + 2 * extra["k3"],
           "what": "two K1 calls (one a layer) and two K3 calls a forward; the solo path "
                   "calls the wrappers direct (kernels/_vmap.is_batched)"}
    emit(rec)
    return rec


def write_fleet(root: str) -> tuple:
    """The fleet's 28 synthetic SMD machines (``write_smd`` from seeds 1-28,
    ``FLEET_SERVE_ROWS`` rows of train and of test each) and their run
    directories, as phase ``serving`` reads them: the
    flagship's config with both kernels on and a seeded random model each,
    no cached train scores (``serve_cli`` calibrates by scoring the training
    split). Returns (data root, output root, CSV streams of the raw test
    splits)."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.models import MTADGAT

    data_root, out_root = os.path.join(root, "data"), os.path.join(root, "output")
    streams = []
    for e, group in enumerate(FLEET_GROUPS):
        write_smd(data_root, n=FLEET_SERVE_ROWS, group=group, seed=1 + e)
        cfg = RunConfig(group=group, attention_impl="pallas", gru_impl="pallas")
        run = os.path.join(out_root, "SMD", group, SERVE_RUN)
        os.makedirs(run)
        cfg.save(os.path.join(run, "config.txt"))
        model = MTADGAT(cfg.model_config(38, 38),
                        generator=torch.Generator().manual_seed(100 + e))
        torch.save(model.state_dict(), os.path.join(run, "model.pt"))
        _, (raw_test, _) = get_data(f"machine-{group}", data_root=data_root, normalize=False)
        stream = os.path.join(root, f"stream_{group}.csv")
        np.savetxt(stream, raw_test, delimiter=",")
        streams.append(stream)
    return data_root, out_root, streams


def serve_groups(data_root, out_root, groups, inputs, output, chunk):
    """``serve_cli.main --device cuda`` over ``groups`` (a fleet where more
    than one) with epsilon; returns its records, summary, the kernels'
    launches, the vmap rules' calls, the plain calls and the seconds."""
    from mtad_gat_tpu_torch.cli import serve_cli
    from mtad_gat_tpu_torch.kernels import gat as kg
    from mtad_gat_tpu_torch.kernels import gru as kgru

    argv = ["--dataset", "SMD", "--group", ",".join(groups), "--model_id", SERVE_RUN,
            "--data_root", data_root, "--output_root", out_root, "--input", ",".join(inputs),
            "--output", output, "--chunk", str(chunk), "--flush_ms", "0",
            "--threshold_method", "epsilon", "--device", "cuda"]
    rules = (kg._gatv2_attention_fwd_vmap.calls, kgru._gru_scan_fwd_vmap.calls)
    reset_counts()
    with plain_calls() as plain:
        t0 = time.perf_counter()
        summary = serve_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = read_counts()
    rule_calls = (kg._gatv2_attention_fwd_vmap.calls - rules[0],
                  kgru._gru_scan_fwd_vmap.calls - rules[1])
    with open(output) as f:
        records = [json.loads(line) for line in f]
    return records, summary, counts, rule_calls, dict(plain), seconds


def fleet_scorers(data_root, out_root, dev):
    """The fleet as ``serve_cli``'s fleet path sets it up (the runs' models,
    scalers, epsilon from the calibration sidecars the first run wrote,
    windows primed with the train tails), and 28 solo ``OnlineScorer``s set
    up alike, for the numbers."""
    from mtad_gat_tpu_torch.cli.predict_cli import load_run_model
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data, normalize_data
    from mtad_gat_tpu_torch.inference import OnlineFleetScorer, OnlineScorer

    models, scalers, scores, tails = [], [], [], []
    for group in FLEET_GROUPS:
        run = os.path.join(out_root, "SMD", group, SERVE_RUN)
        cfg = RunConfig.load(os.path.join(run, "config.txt"))
        (x_train, _), _ = get_data(f"machine-{group}", data_root=data_root, normalize=True)
        (raw_train, _), _ = get_data(f"machine-{group}", data_root=data_root, normalize=False)
        scalers.append(normalize_data(raw_train)[1])
        models.append(load_run_model(run, cfg, 38, 38, dev))
        scores.append(np.load(os.path.join(run, "train_scores_raw.npy")))
        tails.append(x_train[-cfg.lookback:])

    def fleet():
        f = OnlineFleetScorer.from_models(models, 100, 38)
        for e, sc in enumerate(scores):
            f.fit_threshold(e, sc, method="epsilon")
        f.update_many(np.stack(tails))
        return f

    def solos():
        out = []
        for m, sc, tail in zip(models, scores, tails):
            s = OnlineScorer(m, 100, 38)
            s.fit_threshold(sc, method="epsilon")
            s.update_many(tail)
            out.append(s)
        return out

    return fleet, solos, scalers


def fleet_numbers(data_root, out_root, streams, short_streams, warm_streams, smi,
                  dev) -> dict:
    """All-entity points/s of the fleet at chunks 1 and 128 (a pass over the
    28 CSV files through ``serve_cli``'s multiplexed stream, scoring and
    serving loop: at 128 the best of 3 after a warm-up, at 1 one pass after
    a warm-up), each dispatch's time from its yield to
    its written records (p50, p99), peak memory above the baseline, one
    profiled pass at each (at 1 over the short files); then 28 solo
    ``OnlineScorer``s in this process fed the same chunks, one after
    another, at 128 over the whole files and at 1 over the short ones,
    beside the fleet over the short ones."""
    from mtad_gat_tpu_torch.cli import serve_cli

    make_fleet, make_solos, scalers = fleet_scorers(data_root, out_root, dev)

    def fleet_chunk(fleet):
        def score_chunk(batches):
            prepared = [scalers[e].transform(np.nan_to_num(b)) if b.shape[0] else b
                        for e, b in enumerate(batches)]
            for recs in fleet.update_ragged(prepared):
                for rec in recs:
                    yield serve_cli._record_json(rec, 0)
        return score_chunk

    def solo_chunk(solos):
        def score_chunk(batches):
            for e, b in enumerate(batches):
                if b.shape[0]:
                    for rec in solos[e].update_many(scalers[e].transform(np.nan_to_num(b))):
                        yield serve_cli._record_json(rec, 0)
        return score_chunk

    def one_pass(score_chunk, chunk, sources):
        sink, yields = TimedSink(), []

        def chunks():
            for batch in serve_cli._stream_chunks_multi(sources, 38, chunk, flush_ms=0):
                yields.append(time.perf_counter())
                yield batch

        t0 = time.perf_counter()
        n_pts, _ = serve_cli._serve_loop(chunks(), score_chunk, sink, None)
        seconds = time.perf_counter() - t0
        return n_pts, seconds, [(f - y) * 1e3 for y, f in zip(yields, sink.flushes)]

    rec = {"phase": "fleet_serving", "case": "numbers", "card": smi,
           "entities": len(FLEET_GROUPS)}
    for chunk, sources, passes in ((128, streams, 3), (1, streams, 1)):
        one_pass(fleet_chunk(make_fleet()), chunk, warm_streams)      # warm-up
        fleet = make_fleet()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runs = [one_pass(fleet_chunk(fleet), chunk, sources) for _ in range(passes)]
        ms = np.concatenate([lat for _, _, lat in runs])
        rec[f"chunk_{chunk}"] = {
            "points": runs[0][0], "points_per_s": max(n / t for n, t, _ in runs),
            "dispatch_ms_p50": float(np.percentile(ms, 50)),
            "dispatch_ms_p99": float(np.percentile(ms, 99)), "dispatches": int(ms.size),
            "peak_mb_above_baseline": (torch.cuda.max_memory_allocated() - base) / 2**20}
        prof = profile_device(lambda: one_pass(fleet_chunk(make_fleet()), chunk,
                                               short_streams if chunk == 1 else streams),
                              f"fleet serving, {len(FLEET_GROUPS)} entities, chunk {chunk}"
                              + (", the short files" if chunk == 1 else "")
                              + ", float32, kernels on")
        prof["phase"] = "fleet_serving"
        emit(prof)
        rec[f"chunk_{chunk}"]["busy_share"] = prof["busy_share"]
    short = {}
    for name, make, score in (("fleet", make_fleet, fleet_chunk),
                              ("28 solo scorers", make_solos, solo_chunk)):
        for chunk, sources in ((128, streams), (1, short_streams)):
            one_pass(score(make()), chunk, warm_streams)                 # warm-up
            n, t, _ = one_pass(score(make()), chunk, sources)
            short[f"{name}, chunk {chunk}"] = {"points": n, "points_per_s": n / t}
    rec["same_process_comparison"] = short
    rec["what"] = ("points/s: all entities' points over the pass's seconds (CSV, scaling, "
                   "forward, threshold, JSON); dispatch ms: a fleet dispatch from its "
                   "yield to its written records; the solo scorers take the same chunks "
                   "one entity after another; chunk 1 comparisons over the short files")
    emit(rec)
    return rec


def check_fleet_serving(gen, dev, work, smi) -> dict:
    """Phase ``fleet_serving``: grouped K1 and K3 against G launches and
    their plain versions; the custom ops' cost to the solo path; 28 synthetic
    SMD machines served through ``serve_cli`` in fleet mode at chunks 128
    (calibrating by scoring) and 1, exact launches (two K1 and two K3 a fleet
    forward, one vmap rule call each a layer, no plain call), three groups'
    records against their solo ``serve_cli`` runs at both chunks (atol
    ``FLEET_ATOL``); then the numbers."""
    k1 = check_grouped_k1(gen, dev)
    k3 = check_grouped_k3(gen, dev)
    op_cost = op_cost_per_forward(gen, dev)
    root = os.path.join(work, "fleet")
    data_root, out_root, streams = write_fleet(root)
    # the first 256 rows of each file (chunk 1's profile and comparison), and
    # the first 16 (warm-ups)
    short_streams, warm_streams = [], []
    for src in streams:
        for rows, acc in ((PROFILE_POINTS // 2, short_streams), (16, warm_streams)):
            head = src.replace(".csv", f"_{rows}.csv")
            with open(src) as f, open(head, "w") as g:
                g.writelines(line for _, line in zip(range(rows), f))
            acc.append(head)
    with open(streams[0]) as f:
        n = sum(1 for _ in f)                # points a stream
    w, bs = 100, 256
    calib = len(FLEET_GROUPS) * chunks_of(n - w + 1, bs)
    launches, forwards, runs = dict.fromkeys(KERNEL_COUNTERS, 0), 0, {}
    for chunk, calibrating in ((128, True), (1, False)):
        out = os.path.join(root, f"fleet_{chunk}.jsonl")
        records, summary, counts, rules, plain, seconds = serve_groups(
            data_root, out_root, FLEET_GROUPS, streams, out, chunk)
        fleet_fwd = summary["forwards"]
        want = 2 * (fleet_fwd + (calib if calibrating else 0))
        rec = {"phase": "fleet_serving", "run": f"serve_cli fleet, chunk {chunk}",
               "seconds": seconds, "points": summary["points"], "alarms": summary["alarms"],
               "entities": summary["entities"], "fleet_forwards": fleet_fwd,
               "calibration_forwards": calib if calibrating else 0,
               "k1_launches": counts["gatv2_attention_fwd"],
               "k3_launches": counts["gru_scan_fwd"], "vmap_rule_calls": list(rules),
               "plain_calls": plain}
        emit(rec)
        wrong = {k: v for k, v in counts.items()
                 if v != {"gatv2_attention_fwd": want, "gatv2_attention_fwd:graph": want,
                          "gru_scan_fwd": want}.get(k, 0)}
        if wrong or rules != (2 * fleet_fwd, 2 * fleet_fwd) or any(plain.values()):
            raise AssertionError(f"fleet serving, chunk {chunk}: {rec}; expected {want} K1 and "
                                 f"K3 launches, {2 * fleet_fwd} rule calls and no plain call")
        if summary["points"] != n * len(FLEET_GROUPS) or len(records) != summary["points"]:
            raise AssertionError(f"fleet serving, chunk {chunk}: served {summary['points']}")
        for k in launches:
            launches[k] += counts[k] - (2 * calib if calibrating and k in (
                "gatv2_attention_fwd", "gru_scan_fwd") else 0)
        forwards += fleet_fwd
        runs[chunk] = (records, rec)
    compared = []
    for group in (FLEET_GROUPS[0], FLEET_GROUPS[len(FLEET_GROUPS) // 2], FLEET_GROUPS[-1]):
        src = streams[FLEET_GROUPS.index(group)]
        for chunk in (1, 128):
            out = os.path.join(root, f"solo_{group}_{chunk}.jsonl")
            want_recs = serve_groups(data_root, out_root, [group], [src], out, chunk)[0]
            got = [{k: v for k, v in r.items() if k != "group"} for r in runs[chunk][0]
                   if r["group"] == group]
            score = np.array([r["score"] for r in want_recs])
            thr = np.array([r["threshold"] for r in want_recs])
            err = (float(np.max(np.abs(np.array([r["score"] for r in got]) - score)))
                   if len(got) == len(want_recs) else None)
            near = np.abs(score - thr) <= FLEET_ATOL
            rec = {"phase": "fleet_serving", "check": f"group {group}, chunk {chunk}: fleet "
                   "records against its solo serve_cli run", "points": len(got),
                   "max_abs_err": err, "tol": FLEET_ATOL,
                   "thresholds_equal": [r["threshold"] for r in got] == list(thr),
                   "points_within_tol_of_threshold": int(near.sum()),
                   "identical": got == want_recs}
            emit(rec)
            if (err is None or not err <= FLEET_ATOL or not rec["thresholds_equal"]
                    or [r["t"] for r in got] != [r["t"] for r in want_recs]
                    or [r["is_anomaly"] for r, c in zip(got, near) if not c]
                    != [r["is_anomaly"] for r, c in zip(want_recs, near) if not c]):
                raise AssertionError(f"fleet serving: {rec}")
            compared.append(rec)
    numbers = fleet_numbers(data_root, out_root, streams, short_streams, warm_streams, smi,
                            dev)
    return {"k1": k1, "k3": k3, "op_cost": op_cost, "launches": launches,
            "forwards": forwards, "numbers": numbers, "compared": compared}


def fleet_row(fleet: dict, kernel: str) -> dict:
    """K1's or K3's fleet entry of the kernels line: launches on the fleet
    path (two a fleet forward), the grouped launches' times at G 28 beside
    the G ungrouped launches they replace, and their bounds."""
    name = "gatv2_attention_fwd" if kernel == "k1" else "gru_scan_fwd"
    cases = {" ".join(map(str, k)): {f: r[f] for f in (
        "graph_ms", "G_launches_graph_ms", "bound_ms", "bound_by", "max_abs_err",
        "identical_to_G_launches")} for k, r in fleet[kernel].items()}
    return {"launches": fleet["launches"][name], "forwards": fleet["forwards"],
            "launches_per_forward": 2, "groups": len(FLEET_GROUPS), "grouped": cases}


# ---------------------------------------------------------------------------
# Fleet training: K3 under gradients and K4 with an entity axis, and
# sweep_cli --batched over 28 machines
# ---------------------------------------------------------------------------

FLEET_TRAIN_ROWS = (64, 256)      # rows a group: the fleet's batch and the reference's
FLEET_TRAIN_BS = 64
# the fleet against its solo trainers on the card, float32, TF32 off: the
# same arithmetic, batched (cuBLAS picks other kernels for E entities'
# products than for one), a few Adam steps; see check_fleet_parity
FLEET_PARITY_TOL = 2e-4
FLEET_PARITY_ROWS = (700, 620, 780)


def fleet_k4_inputs(gen, dev, G, rows, T, H):
    """A grouped GRU chain: gi, W_hh (G, H, 3H), b_hh (G, 3H), the
    cotangent, the forward's states, and the scan's dgi and dghn = dn_pre r
    (as ``check_k4_weights`` forms it, group by group)."""
    from mtad_gat_tpu_torch.kernels import gru as kgru

    B = G * rows
    gi = torch.randn(B, T, 3 * H, generator=gen).to(dev)
    w = (H ** -0.5 * (torch.rand(G, H, 3 * H, generator=gen) * 2 - 1)).to(dev)
    b = (H ** -0.5 * (torch.rand(G, 3 * H, generator=gen) * 2 - 1)).to(dev)
    dh = torch.randn(B, T, H, generator=gen).to(dev)
    with torch.no_grad():
        hseq = kgru.gru_scan_fwd(gi, w, b, H)[0]
        dgi = kgru.gru_scan_bwd(gi, w, b, hseq, dh, H, need_weights=False)[0]
        hprev = torch.cat([torch.zeros_like(hseq[:, :1]), hseq[:, :-1]], dim=1)
        gh = torch.bmm(hprev.reshape(G, rows * T, H), w).reshape(B, T, 3 * H)
        r = torch.sigmoid(gi[..., :H] + gh[..., :H] + b.repeat_interleave(rows, 0)[:, None, :H])
        dghn = (dgi[..., 2 * H:] * r).contiguous()
    return gi, w, b, dh, hseq, dgi, dghn


def fleet_k4_record(case, G, rows, got, per, want, grouped_fn, per_fn, ops, nbytes, extra):
    """A grouped K4 launch against G ungrouped launches (bits) and the
    grouped plain version (``K4_TOL``, relative to the plain output's
    largest value), both timed by CUDA graph; raises on a failure."""
    torch.cuda.synchronize()
    identical = all(torch.equal(x, y) for x, y in zip(got, per))
    err = max(rel_err(x, y) for x, y in zip(got, want))
    calls = 3 if G * rows > 512 else 10
    bound_ms, bound_by = bound(ops, nbytes)
    rec = {"phase": "fleet_training", "case": case, "G": G, "rows_per_group": rows,
           "identical_to_G_launches": identical, "max_rel_err": err, "tol": K4_TOL,
           "graph_ms": graph_ms(grouped_fn, calls=calls, replays=3),
           "G_launches_graph_ms": graph_ms(per_fn, calls=1, replays=3),
           "bound_ms": bound_ms, "bound_by": bound_by, **extra}
    emit(rec)
    if not (err <= K4_TOL and identical):
        raise AssertionError(f"{case}: {rec}")
    return rec


def check_grouped_k4(gen, dev) -> dict:
    """K4 with an entity axis, G 28 at 64 and 256 rows a group, T 100,
    float32: the scan's cluster variant at hidden 150 and its streaming one
    at 384, and the weights product at 150, each against its G ungrouped
    launches bit for bit (the weights product's at the grouped launch's
    chunks a group, ``gru_weight_grads(chunks=)``) and the grouped plain
    version, timed by CUDA graph beside the G launches (theirs at their own
    chunks, as a loop over the entities would run them)."""
    from mtad_gat_tpu_torch.kernels import gru as kgru

    G, T = 28, 100
    out = {}
    for H, variant in ((150, "cluster"), (384, "streaming")):
        for rows in FLEET_TRAIN_ROWS:
            B = G * rows
            gi, w, b, dh, hseq, dgi, dghn = fleet_k4_inputs(gen, dev, G, rows, T, H)
            sl = [slice(g * rows, (g + 1) * rows) for g in range(G)]
            scan = lambda: kgru.gru_scan_bwd(gi, w, b, hseq, dh, H,  # noqa: E731
                                             need_weights=False)[0]
            got = scan()
            launch = dict(kgru.gru_scan_bwd.last_launch)
            if launch["variant"] != variant or launch["groups"] != G:
                raise AssertionError(f"grouped K4 scan ran {launch}, expected {variant}")
            tiles = len(kgru.group_tiles(rows, G, kgru.K4_BATCH_TILE if variant == "cluster"
                                         else kgru.STREAM_BATCH_TILE))
            if kgru._bwd_lib().gru_bwd_tiles(B, rows, launch["cluster"]) != tiles:
                raise AssertionError("grouped K4 scan: the built kernel's tiles differ from "
                                     f"group_tiles' {tiles}")

            def per_scan():
                return torch.cat([kgru.gru_scan_bwd(gi[s], w[g], b[g], hseq[s], dh[s], H,
                                                    need_weights=False)[0]
                                  for g, s in enumerate(sl)])

            want = kgru.gru_scan_bwd_plain(gi, w, b, hseq, dh, H)
            read = B * T * 3 * H * 4 + 2 * B * T * H * 4 + G * (H * 3 * H + 3 * H) * 4 * 2
            out[("scan", H, rows)] = fleet_k4_record(
                f"grouped K4 scan, hidden {H} ({B}, {T}), {variant}", G, rows, [got],
                [per_scan()], [want[0]], scan, per_scan,
                B * T * (2 * 2 * H * 3 * H + 30 * H), read + B * T * 4 * H * 4,
                {"tiles": tiles, **launch})
            if H == 150:
                weights = lambda: kgru.gru_weight_grads(hseq, dgi, dghn, H, G)  # noqa: E731
                gw = weights()
                S = kgru.gru_weight_grads.last_launch["chunks"]
                per = [kgru.gru_weight_grads(hseq[s].contiguous(), dgi[s].contiguous(),
                                             dghn[s].contiguous(), H, chunks=S) for s in sl]
                parts = [(hseq[s].contiguous(), dgi[s].contiguous(), dghn[s].contiguous())
                         for s in sl]

                def per_weights():
                    return [kgru.gru_weight_grads(*p, H) for p in parts]

                pw = kgru.gru_weight_grads_plain(hseq, dgi, dghn, H, groups=G)
                M = B * T
                out[("weights", H, rows)] = fleet_k4_record(
                    f"grouped K4 weights product, hidden {H} ({B}, {T})", G, rows, list(gw),
                    [torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])],
                    list(pw), weights, per_weights, 2 * M * H * 3 * H + M * 3 * H,
                    M * 4 * H * 4 + G * (H * 3 * H + 3 * H) * 4,
                    {"chunks_a_group": S, "G_launches_chunks": kgru.weight_grad_chunks(
                        rows * T, H, _sms(dev))})
            del gi, hseq, dgi, dghn, want
            torch.cuda.empty_cache()
    return out


def _sms(dev) -> int:
    from mtad_gat_tpu_torch.kernels import _build

    return _build.sm_count(dev)


def check_k3_under_grad(gen, dev) -> dict:
    """K3 under gradients: ``vmap(grad(...))`` of a loss of the GRU scan
    over G 28 entities' stacked weights (the form a fleet step takes), at 64
    and 256 rows an entity, hidden 150, T 100: exactly one grouped K3, K4
    scan and K4 weights launch; the states and dgi equal the G solo
    ``grad`` calls bit for bit, dW_hh and db_hh within ``K4_TOL`` of them
    (the grouped weights product sums its own chunks; phase ``fleet_training``
    holds it bit for bit at equal chunks above) and of the plain backward;
    timed by CUDA graph beside the G solo calls."""
    from torch.func import grad, vmap

    from mtad_gat_tpu_torch.kernels import gru as kgru

    G, T, H = 28, 100, 150
    out = {}
    for rows in FLEET_TRAIN_ROWS:
        gi = torch.randn(G, rows, T, 3 * H, generator=gen).to(dev)
        w = (H ** -0.5 * (torch.rand(G, 3 * H, H, generator=gen) * 2 - 1)).to(dev)
        b = (H ** -0.5 * (torch.rand(G, 3 * H, generator=gen) * 2 - 1)).to(dev)
        cot = torch.randn(G, rows, T, H, generator=gen).to(dev)

        def loss(w_e, b_e, gi_e, cot_e):
            hseq, _ = kgru.gru_scan(gi_e, w_e.t(), b_e, H)
            return (hseq * cot_e).sum(), hseq

        fleet = lambda: vmap(grad(loss, argnums=(0, 1, 2), has_aux=True))(  # noqa: E731
            w, b, gi, cot)

        def solo():
            return [grad(loss, argnums=(0, 1, 2), has_aux=True)(w[g], b[g], gi[g], cot[g])
                    for g in range(G)]

        reset_counts()
        rules = (kgru._gru_scan_fwd_vmap.calls, kgru._gru_scan_bwd_vmap.calls)
        (gw, gb, ggi), hseq = fleet()
        torch.cuda.synchronize()
        counts = read_counts()
        rule_calls = (kgru._gru_scan_fwd_vmap.calls - rules[0],
                      kgru._gru_scan_bwd_vmap.calls - rules[1])
        groups = (kgru.gru_scan_fwd.last_launch["groups"],
                  kgru.gru_scan_bwd.last_launch["groups"],
                  kgru.gru_weight_grads.last_launch["groups"])
        per = solo()
        with torch.no_grad():
            flat = lambda t: t.reshape(G * rows, *t.shape[2:])  # noqa: E731
            w_g = w.transpose(1, 2)
            want_h = kgru.gru_scan_fwd_plain(flat(gi), w_g, b, H)[0]
            want = kgru.gru_scan_bwd_plain(flat(gi), w_g, b, want_h, flat(cot), H)
        torch.cuda.synchronize()
        same = {"hseq": all(torch.equal(hseq[g], per[g][1]) for g in range(G)),
                "dgi": all(torch.equal(ggi[g], per[g][0][2]) for g in range(G))}
        err_solo = {"dw_hh": max(rel_err(gw[g], per[g][0][0]) for g in range(G)),
                    "db_hh": max(rel_err(gb[g], per[g][0][1]) for g in range(G))}
        err_plain = {"hseq": (flat(hseq) - want_h).abs().max().item(),
                     "dgi": rel_err(flat(ggi), want[0]),
                     "dw_hh": rel_err(gw.transpose(1, 2), want[1]),
                     "db_hh": rel_err(gb, want[2])}
        B = G * rows
        read = B * T * 3 * H * 4 + B * T * H * 4 + G * (H * 3 * H + 3 * H) * 4
        bound_ms, bound_by = bound(B * T * (4 * 2 * H * 3 * H + 40 * H),
                                   read + B * T * (H + 3 * H) * 4 + G * (H * 3 * H + 3 * H) * 4)
        rec = {"phase": "fleet_training", "case": f"K3 under gradients, vmap(grad) over {G} "
               f"entities ({B}, {T}), hidden {H}", "G": G, "rows_per_group": rows,
               "launches": {k: counts[k] for k in ("gru_scan_fwd", "gru_scan_bwd",
                                                   "gru_weight_grads")},
               "groups": groups, "vmap_rule_calls": rule_calls,
               "identical_to_G_solo_calls": same, "rel_err_vs_G_solo_calls": err_solo,
               "err_vs_plain": err_plain, "tol": {"hseq": K3_TOL, "grads": K4_TOL},
               "graph_ms": graph_ms(fleet, calls=2, replays=3),
               "G_solo_calls_graph_ms": graph_ms(solo, calls=1, replays=2),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "what": "forward K3, backward K4's scan and weights product, and the "
                       "autograd glue between them; bound: K3's and K4's operations"}
        emit(rec)
        other = {k: v for k, v in counts.items()
                 if v and k not in ("gru_scan_fwd", "gru_scan_bwd", "gru_weight_grads")}
        if (set(rec["launches"].values()) != {1} or other or groups != (G, G, G)
                or rule_calls != (1, 1) or not all(same.values())
                or not max(err_solo.values()) <= K4_TOL or not err_plain["hseq"] <= K3_TOL
                or not max(err_plain[k] for k in ("dgi", "dw_hh", "db_hh")) <= K4_TOL):
            raise AssertionError(f"K3 under gradients: {rec}")
        out[rows] = rec
        del gi, cot, hseq, ggi, per, want
        torch.cuda.empty_cache()
    return out


# the attention's training kernels in a fleet step: both SMD layers (N, E,
# D), dropout 0.3
FLEET_ATTENTION_LAYERS = (("feature", 38, 200, 100), ("temporal", 100, 76, 38))
FLEET_RATE = 0.3


def fleet_attention_bounds(B, G, N, E, D, size) -> dict:
    """K1-res's and K2ab's (with dbias) bounds at batch B in G groups, as
    ``time_training_kernels`` reckons them (PERF.md section 6), with a
    (G, E) and bias, da and dbias (G, N, N)."""
    pairs = B * N * N
    in_bytes = (2 * B * N * E + G * E + B * N * D) * size + G * N * N * 4
    stats = 3 * B * N * 4 + B * N * D * 4
    return {"k1res": bound(pairs * (4 * E + 2 * D), in_bytes + B * N * D * (size + 4)
                           + 2 * B * N * 4),
            "k2ab": bound(pairs * (8 * E + 4 * D + 5), in_bytes + stats
                          + B * N * (2 * E + D) * size + G * E * 4 + G * N * N * 4)}


def check_grouped_attention(gen, dev) -> dict:
    """K1-res and K2ab with an entity axis at the flagship's two layers, G 28
    at 64 and 256 rows a group, dropout 0.3 with one seed an entity, bias,
    float32, and one bfloat16 case (the feature layer at 64 rows): each
    grouped launch against its 28 ungrouped launches bit for bit (each
    entity's a, bias, seed and batch index within the entity; K2ab with
    dbias, da (G, E) and dbias (G, N, N) each summed over the entity's own
    rows in its launch's order) and the grouped plain version
    (``TRAIN_TOL``), timed by CUDA graph beside the 28 launches, with its
    bound."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    G = len(FLEET_GROUPS)
    cases = [(layer, N, E, D, rows, torch.float32) for layer, N, E, D in FLEET_ATTENTION_LAYERS
             for rows in FLEET_TRAIN_ROWS] + [("feature", 38, 200, 100, 64, torch.bfloat16)]
    out = {}
    for layer, N, E, D, rows, dtype in cases:
        B = G * rows
        p, q, _, _, v = gat_case(gen, dev, B, N, E, D, dtype, False)
        a = (torch.randn(G, E, generator=gen) * (6.0 / (E + 1)) ** 0.5).to(dev).to(dtype)
        bias = (0.1 * torch.randn(G, N, N, generator=gen)).to(dev)
        seeds = torch.randint(0, 2**32, (G,), generator=gen, dtype=torch.int64).to(dev)
        sl = lambda t, g: t[g * rows:(g + 1) * rows]  # noqa: E731
        res = lambda: kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seeds, FLEET_RATE)  # noqa

        def res_per():
            return [kg.gatv2_attention_res(sl(p, g), sl(q, g), a[g], bias[g], sl(v, g), 0.2,
                                           seeds[g:g + 1], FLEET_RATE) for g in range(G)]

        got = res()
        fwd_launch = dict(kg.gatv2_attention_res.last_launch)
        per = res_per()
        want = kg.gatv2_attention_res_plain(p, q, a, bias, v, 0.2, seeds, FLEET_RATE)
        _, u, m, l = got
        sig = torch.sigmoid(u)
        du = torch.randn(B, N, D, generator=gen).to(dev) * sig * (1 - sig)
        dvec = (du * u).sum(-1)
        args = (p, q, a, bias, v, m, l, du, dvec, 0.2, seeds, FLEET_RATE)
        bwd = lambda: kg.gatv2_bwd_graph(*args, dbias=True)  # noqa: E731

        def bwd_per():
            return [kg.gatv2_bwd_graph(*(sl(t, g) for t in (p, q)), a[g], bias[g], sl(v, g),
                                       *(sl(t, g) for t in (m, l, du, dvec)), 0.2,
                                       seeds[g:g + 1], FLEET_RATE, dbias=True)
                    for g in range(G)]

        grads = bwd()
        bwd_launch = dict(kg.gatv2_bwd_graph.last_launch)
        grads_per = bwd_per()
        ref = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2, seeds, FLEET_RATE)
        torch.cuda.synchronize()
        fwd_same = all(torch.equal(x, torch.cat([y[k] for y in per])) for k, x in enumerate(got))
        bwd_same = {name: torch.equal(grads[k], (torch.stack if name in ("da", "dbias")
                                                 else torch.cat)([y[k] for y in grads_per]))
                    for k, name in enumerate(("dp", "dq", "da", "dv", "dbias"))}
        ferr = forward_errors(got, want)
        gerr, gabs = grad_errors(grads, ref, grads[4])
        tol = TRAIN_TOL[dtype]
        bounds = fleet_attention_bounds(B, G, N, E, D, p.dtype.itemsize)
        calls = 3 if B > 2048 else 10
        times = {}
        for key, fn, per_fn in (("k1res", res, res_per), ("k2ab", bwd, bwd_per)):
            times[key] = {"graph_ms": graph_ms(fn, calls=calls, replays=3),
                          "G_launches_graph_ms": graph_ms(per_fn, calls=1, replays=3),
                          "bound_ms": bounds[key][0], "bound_by": bounds[key][1]}
        rec = {"phase": "fleet_training", "case": f"grouped K1-res and K2ab with dbias, {layer} "
               f"layer ({B}, {N}, {E}, {D}), {str(dtype).replace('torch.', '')}, dropout "
               f"{FLEET_RATE}, one seed an entity", "G": G, "rows_per_group": rows,
               "k1res_launch": fwd_launch, "k2ab_launch": bwd_launch,
               "k1res_identical_to_G_launches": fwd_same,
               "k2ab_identical_to_G_launches": bwd_same,
               "forward_err": ferr, "grad_rel_err": gerr, "grad_abs_err": gabs, "tol": tol,
               "dbias_group": bwd_launch["group"],
               "occupancy_grouped": graph_occupancy(kg._bwd_lib(), N, E, D, 1),
               "occupancy_ungrouped": graph_occupancy(kg._bwd_lib(), N, E, D, 0), **times,
               "what": "graph_ms: the grouped launch's device time from a CUDA graph; "
                       "G_launches_graph_ms: its 28 ungrouped launches'; K2ab's include the "
                       "sums of da and dbias, entity by entity"}
        emit(rec)
        if (not fwd_same or not all(bwd_same.values()) or fwd_launch["groups"] != G
                or fwd_launch["variant"] != "graph" or bwd_launch["groups"] != G
                or any(not e <= tol["forward"][k] for k, e in ferr.items())
                or not max(gerr.values()) <= tol["grad"]
                or rec["occupancy_grouped"] != rec["occupancy_ungrouped"]):
            raise AssertionError(f"grouped K1-res and K2ab ({layer}, {rows} rows): {rec}")
        out[(layer, rows, str(dtype).replace("torch.", ""))] = rec
        del p, q, v, got, per, want, grads, grads_per, ref, du, dvec, u, m, l, sig
        torch.cuda.empty_cache()
    return out


def check_attention_under_grad(gen, dev) -> dict:
    """The attention with gradients and dropout in a fleet step:
    ``vmap(grad(...))`` of a loss of ``gatv2_attention`` over 28 entities'
    stacked a and bias and their seeds, 64 rows an entity, at both layers,
    float32: exactly one grouped K1-res and one K2ab launch (dbias summed),
    each vmap rule once; every gradient within ``TRAIN_TOL`` of the 28 solo
    ``grad`` calls' (and whether their bits are equal); timed by CUDA graph
    beside the solo calls."""
    from torch.func import grad, vmap

    from mtad_gat_tpu_torch.kernels import gat as kg

    G, rows = len(FLEET_GROUPS), FLEET_TRAIN_BS
    out = {}
    for layer, N, E, D in FLEET_ATTENTION_LAYERS:
        r = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=gen)).to(dev)  # noqa
        p, q, v = r(G, rows, N, E, scale=0.5), r(G, rows, N, E, scale=0.5), r(G, rows, N, D)
        a, bias = r(G, E, scale=(6.0 / (E + 1)) ** 0.5), r(G, N, N, scale=0.1)
        cot = r(G, rows, N, D)
        seeds = torch.randint(0, 2**32, (G, 1), generator=gen, dtype=torch.int64).to(dev)

        def loss(p_e, q_e, a_e, bias_e, v_e, s_e, c_e):
            return (kg.gatv2_attention(p_e, q_e, a_e, bias_e, v_e, 0.2, s_e, FLEET_RATE)
                    * c_e).sum()

        fleet = lambda: vmap(grad(loss, argnums=(0, 1, 2, 3, 4)))(  # noqa: E731
            p, q, a, bias, v, seeds, cot)

        def solo():
            return [grad(loss, argnums=(0, 1, 2, 3, 4))(p[g], q[g], a[g], bias[g], v[g],
                                                         seeds[g], cot[g]) for g in range(G)]

        reset_counts()
        rules = (kg._gatv2_attention_res_vmap.calls, kg._gatv2_attention_bwd_vmap.calls)
        got = fleet()
        torch.cuda.synchronize()
        counts = read_counts()
        rule_calls = (kg._gatv2_attention_res_vmap.calls - rules[0],
                      kg._gatv2_attention_bwd_vmap.calls - rules[1])
        groups = (kg.gatv2_attention_res.last_launch["groups"],
                  kg.gatv2_bwd_graph.last_launch["groups"])
        per = solo()
        torch.cuda.synchronize()
        names = ("dp", "dq", "da", "dbias", "dv")
        err = {n: max(rel_err(got[k][g], per[g][k]) for g in range(G))
               for k, n in enumerate(names)}
        same = {n: all(torch.equal(got[k][g], per[g][k]) for g in range(G))
                for k, n in enumerate(names)}
        B = G * rows
        bounds = fleet_attention_bounds(B, G, N, E, D, 4)
        rec = {"phase": "fleet_training", "case": f"the attention under gradients, vmap(grad) "
               f"over {G} entities, {layer} layer ({B}, {N}, {E}, {D}), dropout {FLEET_RATE}",
               "G": G, "rows_per_group": rows,
               "launches": {k: v for k, v in counts.items() if v}, "groups": groups,
               "vmap_rule_calls": rule_calls, "rel_err_vs_G_solo_calls": err,
               "identical_to_G_solo_calls": same, "tol": TRAIN_TOL[torch.float32]["grad"],
               "graph_ms": graph_ms(fleet, calls=2, replays=3),
               "G_solo_calls_graph_ms": graph_ms(solo, calls=1, replays=2),
               "bound_ms": bounds["k1res"][0] + bounds["k2ab"][0],
               "what": "forward K1-res, backward K2ab with dbias and the entity sums, and the "
                       "autograd glue (du, dvec); bound: K1-res's and K2ab's"}
        emit(rec)
        want = {"gatv2_attention_res": 1, "gatv2_attention_res:graph": 1, "gatv2_bwd_graph": 1,
                "gatv2_bwd_graph:dbias": 1}
        if (rec["launches"] != want or groups != (G, G) or rule_calls != (1, 1)
                or not max(err.values()) <= TRAIN_TOL[torch.float32]["grad"]):
            raise AssertionError(f"the attention under gradients ({layer}): {rec}")
        out[layer] = rec
        del p, q, v, cot, got, per
        torch.cuda.empty_cache()
    return out


def parity_machines(root: str) -> str:
    """The data root of the parity checks' three machines: the fleet's
    first three at their lengths before the cut to 400-600 rows (800, 814
    and 829, whose first ``FLEET_PARITY_ROWS`` rows the checks train),
    written under ``root`` once. Their parameters' agreement at dropout 0
    depends on the data (Adam turns a near-0 gradient's last bits into
    updates of up to lr), so the checks keep the data they were set on."""
    data_root = os.path.join(root, "parity_data")
    if not os.path.isdir(data_root):
        n = len(FLEET_GROUPS)
        for e, group in enumerate(FLEET_GROUPS[:len(FLEET_PARITY_ROWS)]):
            write_smd(data_root, n=800 + (400 * e) // (n - 1), group=group, seed=1 + e)
    return data_root


def fleet_lengths() -> list:
    """Ragged train lengths of the fleet's 28 machines, 400 to 600 rows
    (1,600 to 2,400 before phase ``fleet_wide_features`` needed the time,
    800 to 1,200 before phase ``multi_device``'s fleet over ranks did)."""
    n = len(FLEET_GROUPS)
    return [400 + (200 * e) // (n - 1) for e in range(n)]


class FleetProbe:
    """Wraps ``MultiEntityTrainer.train_epoch`` and ``Trainer.train_epoch``
    for the length of a ``with``: each epoch's seconds (synchronised on
    both sides), its real windows, its launches by kernel and the vmap
    rules' calls (K3's, K4's, the keep mask's, K1-res's, the attention
    backward's, the hash seed's), and CUDA events at the start of each fleet step (from
    ``_generators``, which a step calls first) for the step times."""

    def __init__(self):
        from mtad_gat_tpu_torch.training import MultiEntityTrainer, Trainer

        self.fleet_cls, self.solo_cls = MultiEntityTrainer, Trainer
        self.epochs = []
        self.step_events = []

    def __enter__(self):
        from mtad_gat_tpu_torch.graph import dropout as gdrop
        from mtad_gat_tpu_torch.kernels import gat as kg
        from mtad_gat_tpu_torch.kernels import gru as kgru

        rule_fns = (kgru._gru_scan_fwd_vmap, kgru._gru_scan_bwd_vmap,
                    gdrop._entity_keep_mask_vmap, kg._gatv2_attention_res_vmap,
                    kg._gatv2_attention_bwd_vmap, gdrop._entity_seed_vmap)
        probe = self
        fleet_epoch, solo_epoch = self.fleet_cls.train_epoch, self.solo_cls.train_epoch
        fleet_gens = self.fleet_cls._generators
        self._saved = (fleet_epoch, solo_epoch, fleet_gens)

        def timed(fn, kind):
            def run(trainer, series, starts, mask, *rest):
                torch.cuda.synchronize()
                before = read_counts()
                rules = [f.calls for f in rule_fns]
                steps0 = trainer.fleet_steps if kind == "fleet" else trainer.step
                t0 = time.perf_counter()
                res = fn(trainer, series, starts, mask, *rest)
                torch.cuda.synchronize()
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                probe.step_events.append(end)
                probe.epochs.append({
                    "kind": kind, "seconds": time.perf_counter() - t0,
                    "windows": int(mask.sum().item()),
                    "steps": (trainer.fleet_steps if kind == "fleet" else trainer.step) - steps0,
                    "launches": {k: v - before[k] for k, v in read_counts().items()},
                    "rule_calls": tuple(f.calls - r for f, r in zip(rule_fns, rules))})
                return res
            return run

        def gens(trainer):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            probe.step_events.append(ev)
            return fleet_gens(trainer)

        self.fleet_cls.train_epoch = timed(fleet_epoch, "fleet")
        self.solo_cls.train_epoch = timed(solo_epoch, "solo")
        self.fleet_cls._generators = gens
        return self

    def __exit__(self, *exc):
        (self.fleet_cls.train_epoch, self.solo_cls.train_epoch,
         self.fleet_cls._generators) = self._saved
        return False

    def step_ms(self) -> list:
        """Each fleet step's time on the device's clock: from its start to
        the next step's (the last step to its epoch's end)."""
        torch.cuda.synchronize()
        ev = self.step_events
        return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def expect_fleet_epoch(name: str, epoch: dict, dropout: float, kernels: bool = False,
                       wide: bool = False, band: bool = False) -> None:
    """Exactly two K3, K4 scan and K4 weights launches a fleet step (the
    encoder's and the decoder's GRU) and each GRU rule once a GRU a step;
    with the attention dense no attention kernel, at dropout the keep-mask
    rule once at each of 5 dropout sites a step; with ``kernels`` (the
    attention through them) also two K1-res (whole graph) and two K2ab
    launches with dbias a step and their rules twice, nothing else of the
    attention's, and at dropout the keep-mask rule at 3 sites and the seed
    rule at 2 (the layers' hash masks) a step. ``wide`` (lookback 300,
    with ``kernels``): a step's attention launches are the feature layer's
    whole-graph K1-res and streamed backward with dbias, the temporal
    layer's tiled K1-res and its merge, and FAST K2a and K2b with dbias,
    one each. ``band`` (the attention dense, the temporal layer the block
    scan): the keep-mask rule at 4 sites and the seed rule at 1 (the block
    scan's hash mask) a step."""
    steps = epoch["steps"]
    want = {"gru_scan_fwd": 2 * steps, "gru_scan_bwd": 2 * steps,
            "gru_weight_grads": 2 * steps}
    if kernels and wide:
        want.update({"gatv2_attention_res": 2 * steps,
                     **{k: steps for k in FLEET_WIDE_STEP_LAUNCHES}})
    elif kernels:
        want.update({k: 2 * steps for k in ("gatv2_attention_res", "gatv2_attention_res:graph",
                                             "gatv2_bwd_graph", "gatv2_bwd_graph:dbias")})
    wrong = {k: v for k, v in epoch["launches"].items() if v != want.get(k, 0)}
    masks, seeds = (3, 2) if kernels else (4, 1) if band else (5, 0)
    attn = 2 * steps if kernels else 0
    rules = (2 * steps, 2 * steps, masks * steps if dropout else 0, attn, attn,
             seeds * steps if dropout else 0)
    if wrong or tuple(epoch["rule_calls"]) != rules:
        raise AssertionError(f"{name}: launches {epoch['launches']}, rule calls "
                             f"{epoch['rule_calls']}; expected {want} and {rules}")


@contextlib.contextmanager
def recorded_draws():
    """Every ``torch.bernoulli`` output while the block runs, in order: the
    solo path's keep masks and the fleet's, which its vmap rule draws an
    entity at a time."""
    real, draws = torch.bernoulli, []

    def record(*args, **kw):
        out = real(*args, **kw)
        draws.append(out.bool())
        return out

    torch.bernoulli = record
    try:
        yield draws
    finally:
        torch.bernoulli = real


@contextlib.contextmanager
def recorded_seeds():
    """Every int64 ``torch.randint`` output while the block runs, in order:
    the solo layers' hash seeds and the fleet's, which the seed rule draws
    an entity at a time."""
    real, draws = torch.randint, []

    def record(*args, **kw):
        out = real(*args, **kw)
        if kw.get("dtype") == torch.int64:
            draws.append(out.reshape(-1))
        return out

    torch.randint = record
    try:
        yield draws
    finally:
        torch.randint = real


def check_fleet_parity(data_root, dev, impl: str = "dense", lookback: int = 100,
                       dropouts: tuple = (0.0, 0.3), band: bool = False) -> dict:
    """Three of the fleet's machines (their first 700, 620 and 780 train
    rows, so that padded batches occur), flagship widths, batch 64, 1
    epoch, float32, TF32 off: ``MultiEntityTrainer`` against a solo
    ``Trainer`` each, same seed, at dropout 0 and 0.3, the attention
    ``impl`` ("dense", or "pallas": the grouped K1-res and K2ab against the
    solo kernels). At both, each
    entity's six loss series (training and validation) and every step's
    training losses within ``FLEET_PARITY_TOL``; at 0.3 each entity's keep
    masks, and with the kernels its layers' hash seeds, those of its solo
    trainer bit for bit, at every site of every
    step (``EntityGenerators``). Parameters within ``FLEET_PARITY_TOL`` at
    dropout 0; at 0.3 their largest difference is reported, not held: the
    fleet's batched products round otherwise than one entity's, and where a
    ReLU's input lies within that rounding of 0 the two runs take its two
    sides, a gradient entry a few tenths of a percent apart, which Adam's
    first steps turn into updates of up to lr each (measured on the card:
    a fleet of one equals its solo trainer to 2.2e-7 in the gradients of
    the step where a fleet of two or three differs by 0.41%). ``lookback``
    and ``dropouts``: the window and the dropout rates run (phase
    ``fleet_wide_window``: 300, dropout 0, through the grouped tiled and
    streamed kernels against the solo ones); ``band``: the temporal graph
    ``FLEET_BAND`` (phase ``fleet_wide_features``: the block scan)."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.training import MultiEntityTrainer, Trainer

    series = [get_data(f"machine-{g}", data_root=data_root, normalize=True)[0][0][:n]
              for g, n in zip(FLEET_GROUPS, FLEET_PARITY_ROWS)]
    kernels = impl == "pallas"
    E = len(series)
    sites, seed_sites = (3, 2) if kernels else (4, 1) if band else (5, 0)
    out = {}
    wide = lookback != 100
    graph = dict(temporal_graph=FLEET_BAND[1], bias_storage=FLEET_BAND[3]) if band else {}
    for dropout in dropouts:
        cfg = RunConfig(bs=FLEET_TRAIN_BS, epochs=1, dropout=dropout, log_tensorboard=False,
                        attention_impl=impl, gru_impl="pallas", lookback=lookback, **graph)
        mc, tc = cfg.model_config(38, 38), cfg.train_config()
        with FleetProbe() as probe, recorded_draws() as fleet_draws, \
                recorded_seeds() as fleet_seeds:
            fleet = MultiEntityTrainer(mc, tc, device=str(dev))
            fleet.fit(series, verbose=False)
        expect_fleet_epoch(f"fleet parity ({impl}, lookback {lookback}), dropout {dropout}",
                           probe.epochs[0], dropout, kernels, wide, band)
        loss_err, step_err, param_err, worst, masks_equal = 0.0, 0.0, 0.0, [], True
        for e, s in enumerate(series):
            solo = Trainer(mc, tc, log_dir=os.path.join(data_root, f"parity_logs_{e}"),
                           device=str(dev))
            solo.init_state()
            with recorded_draws() as solo_draws, recorded_seeds() as solo_seeds:
                solo.fit(s)
            for key, vals in solo.losses.items():
                loss_err = max(loss_err, float(np.max(np.abs(
                    np.array(fleet.losses[e][key]) - np.array(vals)), initial=0.0)))
            n = len(solo.last_batch_losses[0])
            for i in (0, 1):
                step_err = max(step_err, float(np.max(np.abs(
                    fleet.last_batch_losses[i][:n, e] - solo.last_batch_losses[i]))))
            # the fleet draws site by site, entity by entity, a step; an
            # entity's real steps come first, its padded ones (gated) after
            if dropout > 0.0:
                masks_equal &= len(solo_draws) == n * sites and all(
                    torch.equal(solo_draws[k * sites + i],
                                fleet_draws[(k * sites + i) * E + e])
                    for k in range(n) for i in range(sites))
                masks_equal &= len(solo_seeds) == n * seed_sites and all(
                    torch.equal(solo_seeds[k * seed_sites + i],
                                fleet_seeds[(k * seed_sites + i) * E + e])
                    for k in range(n) for i in range(seed_sites))
            else:
                masks_equal &= not (solo_draws or fleet_draws or solo_seeds or fleet_seeds)
            got = fleet.entity_params(e)
            errs = {k: (got[k] - v.cpu()).abs().max().item()
                    for k, v in solo.model.state_dict().items()}
            param_err = max(param_err, max(errs.values()))
            worst.append(max(errs, key=errs.get))
        rec = {"phase": fleet_phase(wide, band),
               "check": f"3 entities against their solo trainers, attention {impl}, lookback "
               f"{lookback}{', ' + FLEET_BAND[1] if band else ''}, dropout {dropout}, 1 epoch",
               "train_rows": list(FLEET_PARITY_ROWS),
               "hash_seeds_compared": seed_sites * int(fleet.steps.sum()) if dropout else 0,
               "steps": [int(s) for s in fleet.steps], "fleet_steps": fleet.fleet_steps,
               "keep_masks_identical": masks_equal, "loss_max_abs_err": loss_err,
               "step_loss_max_abs_err": step_err, "param_max_abs_err": param_err,
               "worst_param_by_entity": worst, "tol": FLEET_PARITY_TOL,
               "params_held": dropout == 0.0}
        emit(rec)
        if not (masks_equal and loss_err <= FLEET_PARITY_TOL and step_err <= FLEET_PARITY_TOL
                and (dropout > 0.0 or param_err <= FLEET_PARITY_TOL)):
            raise AssertionError(f"the fleet and its solo trainers disagree: {rec}")
        out[dropout] = rec
    return out


def fleet_phase(wide: bool, band: bool = False) -> str:
    """The phase a fleet record belongs to."""
    return "fleet_wide_features" if band else "fleet_wide_window" if wide else "fleet_training"


def fleet_training_numbers(data_root, smi, dev, impl: str = "dense",
                           bs: int = FLEET_TRAIN_BS, lookback: int = 100,
                           band: bool = False) -> dict:
    """The fleet on all 28 machines outside the CLI, flagship widths, batch
    ``bs``, dropout 0.3, the attention ``impl`` (the GRU's kernels on), a
    fresh ``MultiEntityTrainer`` an epoch: a warm-up
    epoch, then one timed (all-entity windows/s, each step's time on the
    device's clock, p50 and p99, peak memory above the baseline, the fleet's
    weights and Adam state included) and one profiled (busy share, device
    time by kernel). ``lookback``: the window (300 in phase
    ``fleet_wide_window``); ``band``: the temporal graph ``FLEET_BAND``."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.training import MultiEntityTrainer

    series = [get_data(f"machine-{g}", data_root=data_root, normalize=True)[0][0]
              for g in FLEET_GROUPS]
    graph = dict(temporal_graph=FLEET_BAND[1], bias_storage=FLEET_BAND[3]) if band else {}
    cfg = RunConfig(bs=bs, epochs=1, log_tensorboard=False, attention_impl=impl,
                    gru_impl="pallas", lookback=lookback, **graph)
    wide = lookback != 100
    phase = fleet_phase(wide, band)

    def train_one_epoch():
        # a fresh fleet each time: a fit on a trained one would resume past
        # its epoch
        fleet = MultiEntityTrainer(cfg.model_config(38, 38), cfg.train_config(),
                                   device=str(dev))
        fleet.fit(series, verbose=False)

    train_one_epoch()                                                    # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FleetProbe() as probe:
        train_one_epoch()
    epoch = probe.epochs[0]
    expect_fleet_epoch(f"fleet numbers ({impl}, batch {bs}, lookback {lookback})", epoch,
                       cfg.dropout, impl == "pallas", wide, band)
    steps = probe.step_ms()
    rec = {"phase": phase, "case": "numbers", "attention_impl": impl, "card": smi,
           "entities": len(FLEET_GROUPS), "batch": bs, "lookback": lookback,
           "temporal_graph": cfg.temporal_graph,
           "launches_in_epoch": {k: v for k, v in epoch["launches"].items() if v},
           "train_windows": epoch["windows"], "fleet_steps": epoch["steps"],
           "epoch_seconds": epoch["seconds"],
           "windows_per_s": epoch["windows"] / epoch["seconds"],
           "step_ms_p50": float(np.percentile(steps, 50)),
           "step_ms_p99": float(np.percentile(steps, 99)),
           "peak_mb_above_baseline": (torch.cuda.max_memory_allocated() - base) / 2**20}
    prof = profile_device(train_one_epoch,
                          f"fleet training, {len(FLEET_GROUPS)} entities, attention {impl}, "
                          f"batch {bs}, lookback {lookback}"
                          f"{', ' + FLEET_BAND[1] if band else ''}, one epoch with its "
                          "validation, float32")
    prof["phase"] = phase
    emit(prof)
    rec["busy_share"] = prof["busy_share"]
    rec["what"] = ("windows/s: all entities' real training windows over the epoch's "
                   "train_epoch seconds; step ms: on the device's clock, from one step's "
                   "start to the next's; the profile covers the epoch's validation too")
    emit(rec)
    return rec


def batched_sweep(common, out_root, run_id, impl, bs, lookback: int = 100,
                  band: bool = False) -> dict:
    """``sweep_cli.main --batched`` on the fleet's machines at batch ``bs``,
    the attention ``impl`` ("dense", or "pallas" with ``--gru_impl
    pallas``), the counts set to 0 just before and read just after: the
    launches of its training epoch as ``expect_fleet_epoch`` says (with
    "pallas" two K1-res and two K2ab with dbias a step besides the GRU's),
    no plain attention or GRU call in the whole run (scoring included) and
    no attention kernel with "dense", every entity's summary finite, and
    ``predict_cli`` reproducing the first entity's. ``lookback`` 300 (phase
    ``fleet_wide_window``): the launches ``expect_fleet_epoch`` names for
    that window's plans; ``band`` (``FLEET_BAND`` in ``common``, phase
    ``fleet_wide_features``): the block scan's rule calls."""
    from mtad_gat_tpu_torch.cli import predict_cli, sweep_cli

    kernels = impl == "pallas"
    wide = lookback != 100
    extra = ["--attention_impl", "pallas", "--gru_impl", "pallas"] if kernels else []
    argv = [*common, "--bs", str(bs), "--output_root", out_root, "--batched", "--run_id",
            run_id, "--lookback", str(lookback), *extra]
    reset_counts()
    with FleetProbe() as probe, plain_calls() as plain:
        t0 = time.perf_counter()
        results = sweep_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = read_counts()
    plain_counts = dict(plain)
    epoch = probe.epochs[0]
    name = (f"sweep_cli --batched, attention {impl}, batch {bs}, lookback {lookback}"
            f"{', ' + FLEET_BAND[1] if band else ''}")
    expect_fleet_epoch(name, epoch, 0.3, kernels, wide, band)
    steps = epoch["steps"]
    run0 = os.path.join(out_root, "SMD", FLEET_GROUPS[0], run_id)
    summary0 = finite_summary(os.path.join(run0, "summary.txt"))
    for group in FLEET_GROUPS:
        finite_summary(os.path.join(out_root, "SMD", group, run_id, "summary.txt"))
    predict_cli.main(["--dataset", "SMD", "--group", FLEET_GROUPS[0], "--model_id", run_id,
                      "--data_root", common[common.index("--data_root") + 1],
                      "--output_root", out_root, "--device", "cuda"])
    rec = {"phase": fleet_phase(wide, band),
           "run": f"{name}, {len(FLEET_GROUPS)} machines, 1 epoch",
           "seconds": seconds, "train_epoch_seconds": epoch["seconds"],
           "train_windows": epoch["windows"], "fleet_steps": steps,
           "windows_per_s": epoch["windows"] / epoch["seconds"],
           "launches_in_train_epoch": epoch["launches"],
           "vmap_rule_calls_in_train_epoch": epoch["rule_calls"],
           "launches": counts, "plain_calls": plain_counts,
           "entities_scored": len(results), "bf_f1_first": summary0["bf_result"]["f1"],
           "predict_cli_reproduces_summary": finite_summary(
               os.path.join(run0, "summary_1.txt")) == summary0}
    emit(rec)
    attention = {k: v for k, v in counts.items() if k.startswith("gatv2") and v}
    if ((attention and not kernels) or counts["gru_scan_bwd"] != 2 * steps
            or counts["gru_weight_grads"] != 2 * steps
            or any(plain_counts[k] for k in ("gru_scan_fwd_plain", "gru_step"))
            or (kernels and any(plain_counts.values()))
            or len(results) != len(FLEET_GROUPS) or not rec["predict_cli_reproduces_summary"]):
        raise AssertionError(f"{name}: {rec}")
    return rec


def check_fleet_training(gen, dev, work, smi) -> dict:
    """Phase ``fleet_training``: grouped K4 and K3 under gradients against G
    launches and their plain versions; grouped K1-res and K2ab against G
    launches and theirs, and the attention under gradients; 28 synthetic SMD
    machines (ragged, 400-600 train rows) trained by ``sweep_cli
    --batched`` (1 epoch, dropout 0.3, float32): with dense attention at
    batch 64, and through the attention kernels at batch 64 and 256, each
    entity's run written and scored, ``predict_cli`` reproducing one; three
    machines against their solo trainers at dropout 0 and 0.3, dense and
    through the kernels; then the numbers of each, and ``sweep_cli`` without
    ``--batched`` on the same data (28 solo trainers one after another) for
    its windows/s."""
    from mtad_gat_tpu_torch.cli import sweep_cli
    from mtad_gat_tpu_torch.nn.gat import dense_gatv2_bytes

    k4 = check_grouped_k4(gen, dev)
    k3 = check_k3_under_grad(gen, dev)
    attention = check_grouped_attention(gen, dev)
    attention_grad = check_attention_under_grad(gen, dev)
    root = os.path.join(work, "fleet_training")
    data_root, out_root = os.path.join(root, "data"), os.path.join(root, "output")
    for e, (group, n) in enumerate(zip(FLEET_GROUPS, fleet_lengths())):
        write_smd(data_root, n=n, group=group, seed=1 + e)
    E = len(FLEET_GROUPS)
    byte_model = {f"batch {bs}": {
        "temporal_gb": dense_gatv2_bytes(E * bs, 100, 76, 4, True) / 1e9,
        "feature_gb": dense_gatv2_bytes(E * bs, 38, 200, 4, True) / 1e9}
        for bs in (FLEET_TRAIN_BS, 256)}
    for v in byte_model.values():
        v["sum_gb"] = v["temporal_gb"] + v["feature_gb"]
    emit({"phase": "fleet_training", "case": "the dense layers' byte model for the fleet "
          "(nn/gat.DENSE_BYTES, float32 with gradients)", "entities": E, **byte_model,
          "card_gb": torch.cuda.get_device_properties(0).total_memory / 1e9})

    common = ["--dataset", "SMD", "--epochs", "1", "--dropout", "0.3", "--data_root",
              data_root, "--device", "cuda", "--log_tensorboard", "False"]
    rec = batched_sweep(common, out_root, "fleet", "dense", FLEET_TRAIN_BS)
    epoch_windows, steps = rec["train_windows"], rec["fleet_steps"]
    sweeps = {bs: batched_sweep(common, out_root, f"kfleet{bs}", "pallas", bs)
              for bs in FLEET_TRAIN_ROWS}
    # the phase's launches: its three sweeps, each counted from 0
    counts = {k: rec["launches"][k] + sum(r["launches"][k] for r in sweeps.values())
              for k in rec["launches"]}
    parity_root = parity_machines(root)
    parity = check_fleet_parity(parity_root, dev)
    kparity = check_fleet_parity(parity_root, dev, "pallas")
    numbers = fleet_training_numbers(data_root, smi, dev)
    knumbers = {bs: fleet_training_numbers(data_root, smi, dev, "pallas", bs)
                for bs in FLEET_TRAIN_ROWS}
    emit({"phase": "fleet_training", "case": "the kernel fleet against the dense fleet",
          "card": smi, "windows_per_s": {"dense batch 64": numbers["windows_per_s"],
                                         **{f"kernels batch {bs}": r["windows_per_s"]
                                            for bs, r in knumbers.items()}},
          "kernels_over_dense_at_64": knumbers[FLEET_TRAIN_BS]["windows_per_s"]
          / numbers["windows_per_s"]})

    solo_root = os.path.join(root, "solo_output")
    with FleetProbe() as probe:
        t0 = time.perf_counter()
        sweep_cli.main(common + ["--bs", str(FLEET_TRAIN_BS), "--output_root", solo_root,
                                 "--run_id", "solo"])
        torch.cuda.synchronize()
        solo_seconds = time.perf_counter() - t0
    solo_windows = sum(ep["windows"] for ep in probe.epochs)
    solo_train_s = sum(ep["seconds"] for ep in probe.epochs)
    solo = {"phase": "fleet_training", "run": f"sweep_cli (sequential), {E} solo trainers, "
            "1 epoch each, the same data", "seconds": solo_seconds,
            "train_epoch_seconds": solo_train_s, "train_windows": solo_windows,
            "windows_per_s": solo_windows / solo_train_s,
            "fleet_windows_per_s_same_process": rec["windows_per_s"],
            "fleet_over_solo": rec["windows_per_s"] / (solo_windows / solo_train_s)}
    emit(solo)
    if solo_windows != epoch_windows:
        raise AssertionError(f"the solo sweep trained {solo_windows} windows, the fleet "
                             f"{epoch_windows}")
    return {"k4": k4, "k3": k3, "attention": attention, "attention_grad": attention_grad,
            "sweep": rec, "kernel_sweeps": sweeps, "parity": parity,
            "kernel_parity": kparity, "numbers": numbers, "kernel_numbers": knumbers,
            "solo": solo, "launches": counts, "steps": steps, "byte_model": byte_model}


def fleet_training_row(ft: dict, kernel: str) -> dict:
    """K3's or K4's fleet-training entry of the kernels line: launches in the
    batched sweep (two a fleet step), the grouped launches' times at G 28
    beside the G ungrouped launches they replace, and their bounds."""
    fields = ("graph_ms", "bound_ms", "bound_by", "max_rel_err", "identical_to_G_launches",
              "G_launches_graph_ms")
    if kernel == "gru_scan_fwd":
        grouped = {f"under gradients, {rows} rows": {
            f: r[f] for f in ("graph_ms", "G_solo_calls_graph_ms", "bound_ms", "bound_by",
                              "identical_to_G_solo_calls", "rel_err_vs_G_solo_calls")}
            for rows, r in ft["k3"].items()}
    else:
        part = "scan" if kernel == "gru_scan_bwd" else "weights"
        grouped = {f"hidden {H}, {rows} rows": {f: r[f] for f in fields}
                   for (p, H, rows), r in ft["k4"].items() if p == part}
    return {"launches": ft["launches"][kernel], "fleet_steps": ft["steps"],
            "launches_per_fleet_step": 2, "groups": len(FLEET_GROUPS), "grouped": grouped}


def fleet_attention_row(ft: dict, key: str) -> dict:
    """K1-res's ("k1res") or K2ab's ("k2ab") fleet-training entry of the
    kernels line: launches in the phase's kernel sweeps (two a fleet step),
    the grouped launches' times at G 28 beside the 28 ungrouped launches
    they replace, and their bounds."""
    name = "gatv2_attention_res" if key == "k1res" else "gatv2_bwd_graph"
    same = "k1res_identical_to_G_launches" if key == "k1res" else "k2ab_identical_to_G_launches"
    grouped = {f"{layer}, {rows} rows, {dt}": {
        **r[key], "identical_to_G_launches": r[same],
        "max_err": r["forward_err"] if key == "k1res" else r["grad_rel_err"]}
        for (layer, rows, dt), r in ft["attention"].items()}
    return {"launches": ft["launches"][name],
            "launches_by_sweep": {f"batch {bs}": r["launches"][name]
                                  for bs, r in ft["kernel_sweeps"].items()},
            "fleet_steps_by_sweep": {f"batch {bs}": r["fleet_steps"]
                                     for bs, r in ft["kernel_sweeps"].items()},
            "launches_per_fleet_step": 2, "groups": len(FLEET_GROUPS), "grouped": grouped,
            "under_gradients": {layer: {k: r[k] for k in (
                "graph_ms", "G_solo_calls_graph_ms", "bound_ms", "rel_err_vs_G_solo_calls",
                "identical_to_G_solo_calls")} for layer, r in ft["attention_grad"].items()}}


# ---------------------------------------------------------------------------
# Fleet training at long windows: the tiled K1-res, the tiled K2a and K2b and
# the streamed backward with an entity axis, and sweep_cli --batched
# --lookback 300 over the 28 machines
# ---------------------------------------------------------------------------

FLEET_WIDE_LOOKBACK = 300
FLEET_WIDE_ROWS = 64              # rows a group: the fleet's batch
# (layer, N, E, D) at lookback 300 and SMD's 38 features: the temporal layer
# takes the tiled K1-res and the FAST K2a and K2b, the feature layer the
# whole-graph K1-res on two row blocks and the streamed backward
FLEET_WIDE_LAYERS = (("temporal", 300, 76, 38), ("feature", 38, 600, 300))
# a fleet step's attention launches besides K1-res's two, one each
FLEET_WIDE_STEP_LAUNCHES = (
    "gatv2_attention_res:graph", "gatv2_attention_res:tiled", "gatv2_fwd_merge",
    "gatv2_bwd_dp_da", "gatv2_bwd_dp_da:fast", "gatv2_bwd_dq_dv", "gatv2_bwd_dq_dv:fast",
    "gatv2_bwd_dq_dv:dbias", "gatv2_bwd_streamed", "gatv2_bwd_streamed:dbias")


def wide_bounds(B, G, N, E, D) -> dict:
    """The bounds of K1-res, K2a, K2b with dbias and the whole backward with
    dbias (the streamed backward's function) at batch B in G entities,
    float32, as ``time_training_kernels`` reckons them, with a (G, E), bias,
    da and dbias an entity's."""
    pairs = B * N * N
    in_bytes = (2 * B * N * E + G * E + B * N * D) * 4 + G * N * N * 4
    stats = 3 * B * N * 4 + B * N * D * 4
    return {"k1res": bound(pairs * (4 * E + 2 * D), in_bytes + B * N * D * 8 + 2 * B * N * 4),
            "k2a": bound(pairs * (7 * E + 2 * D + 4), in_bytes + stats + B * N * E * 4 + G * E * 4),
            "k2b": bound(pairs * (5 * E + 4 * D + 5),
                         in_bytes + stats + B * N * (E + D) * 4 + G * N * N * 4),
            "streamed": bound(pairs * (8 * E + 4 * D + 5),
                              in_bytes + stats + B * N * (2 * E + D) * 4 + G * E * 4
                              + G * N * N * 4)}


def wide_occupancy(kg, route, plans, N, E, D) -> dict:
    """Blocks a multiprocessor of each new grouped instantiation beside its
    ungrouped one, [ungrouped, grouped] (float32, dropout): the tiled K2a
    and K2b with dbias at their plans' tile, or the streamed score and
    contraction passes at the plan's row tile."""
    if route == "tiled":
        lib, pa, pb = kg._bwd_lib(), plans["k2a"], plans["k2b"]
        return {"k2a": [lib.gatv2_bwd_tiled_occupancy(0, pa["tile"], E, D, int(pa["acc_smem"]),
                                                      1, 0, gr) for gr in (0, 1)],
                "k2b_dbias": [lib.gatv2_bwd_tiled_occupancy(1, pb["tile"], E, D,
                                                            int(pb["acc_smem"]), 1, 1, gr)
                              for gr in (0, 1)]}
    lib, pl = kg._streamed_lib(), plans["streamed"]
    return {f"streamed_{name}": [lib.gatv2_streamed_occupancy(which, N, pl["rows"],
                                                              pl["rows_per_thread"], 0, 1, gr)
                                 for gr in (0, 1)]
            for which, name in ((0, "score"), (1, "contract"))}


def check_grouped_wide_kernels(gen, dev) -> dict:
    """The lookback-300 layers at G 28 and 64 rows an entity, float32, bias,
    dropout 0.3 with a seed an entity: K1-res (the temporal layer's tiled
    kernel, the feature layer's whole-graph kernel on two row blocks) and
    the backward with dbias (the temporal layer's FAST K2a and K2b, the
    feature layer's streamed backward), each grouped launch against its 28
    ungrouped launches bit for bit, those at the grouped plan (K2a's and
    K2b's slices and K2b's batch group forced to the grouped launch's; the
    forward's and the streamed backward's plans equal at both batches,
    asserted) and within ``TRAIN_TOL`` of the grouped plain version (da
    and dbias each entity's); each timed by CUDA graph beside the 28
    launches and its bound, with its plan and each grouped instantiation's
    blocks a multiprocessor beside the ungrouped one's."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    G, rows = len(FLEET_GROUPS), FLEET_WIDE_ROWS
    B = G * rows
    sms = _sms(dev)
    out = {}
    for layer, N, E, D in FLEET_WIDE_LAYERS:
        p, q, _, _, v = gat_case(gen, dev, B, N, E, D, torch.float32, False)
        a = (torch.randn(G, E, generator=gen) * (6.0 / (E + 1)) ** 0.5).to(dev)
        bias = (0.1 * torch.randn(G, N, N, generator=gen)).to(dev)
        seeds = torch.randint(0, 2**32, (G,), generator=gen, dtype=torch.int64).to(dev)
        sl = lambda t, g: t[g * rows:(g + 1) * rows]  # noqa: E731
        res = lambda: kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seeds, FLEET_RATE)  # noqa

        def res_per():
            return [kg.gatv2_attention_res(sl(p, g), sl(q, g), a[g], bias[g], sl(v, g), 0.2,
                                           seeds[g:g + 1], FLEET_RATE) for g in range(G)]

        torch.cuda.reset_peak_memory_stats()
        got = res()
        fwd_launch = dict(kg.gatv2_attention_res.last_launch)
        per = res_per()
        solo_launch = dict(kg.gatv2_attention_res.last_launch)
        want = kg.gatv2_attention_res_plain(p, q, a, bias, v, 0.2, seeds, FLEET_RATE)
        _, u, m, l = got
        sig = torch.sigmoid(u)
        du = torch.randn(B, N, D, generator=gen).to(dev) * sig * (1 - sig)
        dvec = (du * u).sum(-1)
        args = (p, q, a, bias, v, m, l, du, dvec, 0.2, seeds, FLEET_RATE)

        def one(g):
            return (sl(p, g), sl(q, g), a[g], bias[g], sl(v, g),
                    *(sl(t, g) for t in (m, l, du, dvec)), 0.2, seeds[g:g + 1], FLEET_RATE)

        route = kg.gat_bwd_route(N, E, D)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if route == "tiled":
            dp, da = kg.gatv2_bwd_dp_da(*args)
            pa = kg.gatv2_bwd_dp_da.last_plan
            dq, dv, db = kg.gatv2_bwd_dq_dv(*args, dbias=True)
            pb = kg.gatv2_bwd_dq_dv.last_plan
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            grads = (dp, dq, da, dv, db)
            solo = kg.gat_tiled_bwd_plan(rows, N, E, D, sms, dbias=True)
            plans = {"k2a": pa._asdict(), "k2b": pb._asdict(),
                     "solo_slices": [solo["k2a"].slices, solo["k2b"].slices],
                     "solo_k2b_group": solo["k2b"].group}
            k2a_per = lambda: [kg.gatv2_bwd_dp_da(*one(g), plan=pa) for g in range(G)]  # noqa
            k2b_per = lambda: [kg.gatv2_bwd_dq_dv(*one(g), dbias=True, plan=pb)  # noqa: E731
                               for g in range(G)]
            grads_per = [(x[0], y[0], x[1], y[1], y[2]) for x, y in zip(k2a_per(), k2b_per())]
            timed = {"k2a": (lambda: kg.gatv2_bwd_dp_da(*args), k2a_per),
                     "k2b": (lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True), k2b_per)}
            same_plans = plans["solo_slices"] == [pa.slices, pb.slices]
        else:
            grads = kg.gatv2_bwd_streamed(*args, dbias=True)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            plan = kg.gatv2_bwd_streamed.last_plan
            solo = kg.gat_streamed_bwd_plan(rows, N, E, D, sms, dbias=True)
            plans = {"streamed": plan._asdict(), "solo_rows": [solo.rows, solo.rows_per_thread]}
            bwd_per = lambda: [kg.gatv2_bwd_streamed(*one(g), dbias=True)  # noqa: E731
                               for g in range(G)]
            grads_per = bwd_per()
            timed = {"streamed": (lambda: kg.gatv2_bwd_streamed(*args, dbias=True), bwd_per)}
            # the row tile touches no sum: the bits hold whatever it is
            same_plans = True
        ref = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2, seeds, FLEET_RATE)
        torch.cuda.synchronize()
        fwd_same = all(torch.equal(x, torch.cat([y[k] for y in per])) for k, x in enumerate(got))
        bwd_same = {name: torch.equal(grads[k], (torch.stack if name in ("da", "dbias")
                                                 else torch.cat)([y[k] for y in grads_per]))
                    for k, name in enumerate(("dp", "dq", "da", "dv", "dbias"))}
        ferr = forward_errors(got, want)
        gerr, gabs = grad_errors(grads, ref, grads[4])
        tol = TRAIN_TOL[torch.float32]
        bounds = wide_bounds(B, G, N, E, D)
        times = {"k1res": {"graph_ms": graph_ms(res, calls=3, replays=3),
                           "G_launches_graph_ms": graph_ms(res_per, calls=1, replays=2),
                           "bound_ms": bounds["k1res"][0], "bound_by": bounds["k1res"][1]}}
        for key, (fn, per_fn) in timed.items():
            times[key] = {"graph_ms": graph_ms(fn, calls=3, replays=3),
                          "G_launches_graph_ms": graph_ms(per_fn, calls=1, replays=2),
                          "bound_ms": bounds[key][0], "bound_by": bounds[key][1]}
        fwd_plan = fwd_launch["plan"]
        rec = {"phase": "fleet_wide_window", "case": f"grouped K1-res and backward with dbias, "
               f"{layer} layer ({B}, {N}, {E}, {D}), float32, dropout {FLEET_RATE}, one seed "
               "an entity", "G": G, "rows_per_group": rows, "route": route,
               "k1res_launch": fwd_launch,
               "k1res_solo_launch": {k: solo_launch[k] for k in ("variant", "row_blocks")},
               "k1res_slices": [None if fwd_plan is None else fwd_plan["slices"],
                                None if solo_launch["plan"] is None
                                else solo_launch["plan"]["slices"]],
               "bwd_plans": plans, "bwd_peak_mb_above_inputs": peak,
               "k1res_identical_to_G_launches": fwd_same, "bwd_identical_to_G_launches": bwd_same,
               "forward_err": ferr, "grad_rel_err": gerr, "grad_abs_err": gabs, "tol": tol,
               "occupancy": wide_occupancy(kg, route, plans, N, E, D),
               **times,
               "what": "graph_ms: the grouped launch's device time from a CUDA graph; "
                       "G_launches_graph_ms: its 28 ungrouped launches' (the backward's at the "
                       "grouped plan); the backward's include the sums of da and dbias, entity "
                       "by entity; k1res_slices and bwd_plans: the grouped launch's beside a "
                       "solo call's at 64 rows"}
        emit(rec)
        if (not fwd_same or not all(bwd_same.values()) or fwd_launch["groups"] != G
                or fwd_launch["variant"] != kg.gat_fwd_plan(N, E, D)
                or rec["k1res_slices"][0] != rec["k1res_slices"][1] or not same_plans
                or (layer == "feature" and fwd_launch["row_blocks"] != 2)
                or any(not e <= tol["forward"][k] for k, e in ferr.items())
                or not max(gerr.values()) <= tol["grad"]):
            raise AssertionError(f"grouped wide kernels ({layer}): {rec}")
        out[layer] = rec
        del p, q, v, got, per, want, grads, grads_per, ref, du, dvec, u, m, l, sig
        torch.cuda.empty_cache()
    return out


def check_fleet_wide_window(gen, dev, data_root, out_root, smi) -> dict:
    """Phase ``fleet_wide_window``: the grouped tiled and streamed kernels
    (``check_grouped_wide_kernels``); then the 28 machines of phase
    ``fleet_training`` trained by ``sweep_cli.main --batched
    --attention_impl pallas --gru_impl pallas --lookback 300 --bs 64`` (1
    epoch, dropout 0.3, float32): a fleet step's launches exactly two K1-res
    (the feature layer's whole graph on two row blocks, the temporal
    layer's tiled with its merge), one FAST K2a, one FAST K2b with dbias and
    one streamed backward with dbias, the GRU's as at the flagship, no plain
    attention or GRU call, every entity's summary finite, ``predict_cli``
    reproducing one; three machines against their solo trainers at lookback
    300 through the kernels, dropout 0, within ``FLEET_PARITY_TOL``; then
    the fleet's numbers at lookback 300 (windows/s, step p50 and p99 on the
    device's clock, peak memory, a profiled epoch's busy share)."""
    kernels = check_grouped_wide_kernels(gen, dev)
    common = ["--dataset", "SMD", "--epochs", "1", "--dropout", "0.3", "--data_root",
              data_root, "--device", "cuda", "--log_tensorboard", "False"]
    sweep = batched_sweep(common, out_root, "wide", "pallas", FLEET_TRAIN_BS,
                          FLEET_WIDE_LOOKBACK)
    parity = check_fleet_parity(parity_machines(os.path.dirname(data_root)), dev, "pallas",
                                FLEET_WIDE_LOOKBACK, (0.0,))
    numbers = fleet_training_numbers(data_root, smi, dev, "pallas", FLEET_TRAIN_BS,
                                     FLEET_WIDE_LOOKBACK)
    return {"kernels": kernels, "sweep": sweep, "parity": parity, "numbers": numbers,
            "launches": sweep["launches"], "steps": sweep["fleet_steps"]}


def fleet_wide_row(fw: dict, key: str) -> dict:
    """A kernel's ``fleet_wide_window`` entry of the kernels line: its
    launches in the phase's sweep and a fleet step's, and its grouped
    launch at G 28 beside the 28 ungrouped launches, their bits, errors and
    bound, at the layer that runs it."""
    layer = "feature" if key == "streamed" else "temporal"
    rec = fw["kernels"][layer]
    same = (rec["k1res_identical_to_G_launches"] if key == "k1res"
            else all(rec["bwd_identical_to_G_launches"].values()))
    name = {"k1res": "gatv2_attention_res", "k2a": "gatv2_bwd_dp_da", "k2b": "gatv2_bwd_dq_dv",
            "streamed": "gatv2_bwd_streamed"}[key]
    row = {"launches": fw["launches"][name], "fleet_steps": fw["steps"],
           "launches_per_fleet_step": 2 if key == "k1res" else 1,
           "groups": rec["G"], "rows_per_group": rec["rows_per_group"],
           "grouped": {f"{layer}, {rec['rows_per_group']} rows": {
               **rec[key], "identical_to_G_launches": same,
               "max_err": rec["forward_err"] if key == "k1res" else rec["grad_rel_err"]}}}
    if key == "k1res":
        f = fw["kernels"]["feature"]
        row["grouped"][f"feature, {f['rows_per_group']} rows, two row blocks"] = {
            **f["k1res"], "identical_to_G_launches": f["k1res_identical_to_G_launches"],
            "max_err": f["forward_err"]}
    return row


# ---------------------------------------------------------------------------
# The last of fleet training: the CHUNKED tiled K2a and K2b with an entity
# axis (a fleet of more than 64 features beyond window 235), and the block
# scan under vmap(grad) (sweep_cli --batched --temporal_graph band:W, W > 32)
# ---------------------------------------------------------------------------

# (name, N, E, D): the feature layer of 65 features at window 300, and a
# graph of 128 nodes at its widths, where K2b's slices are 2
FLEET_FEATURES_LAYERS = (("N 65", 65, 600, 300), ("N 128", 128, 600, 300))
FLEET_FEATURES = 65
FLEET_FEATURES_WINDOWS = 290      # an entity's windows in path (a): 5 steps of 64, val included
FLEET_BAND = ["--temporal_graph", "band:64", "--bias_storage", "band"]
FLEET_BAND_ROWS = 800             # train and test rows a machine in path (b): 8 steps of 64
FLEET_FEATURES_STEP_LAUNCHES = {
    # path (a)'s attention launches a fleet step: both layers' tiled K1-res
    # and merge, the feature layer's CHUNKED pair, the temporal layer's FAST
    # pair, each K2b with dbias
    "gatv2_attention_res": 2, "gatv2_attention_res:tiled": 2, "gatv2_fwd_merge": 2,
    "gatv2_bwd_dp_da": 2, "gatv2_bwd_dp_da:chunked": 1, "gatv2_bwd_dp_da:fast": 1,
    "gatv2_bwd_dq_dv": 2, "gatv2_bwd_dq_dv:chunked": 1, "gatv2_bwd_dq_dv:fast": 1,
    "gatv2_bwd_dq_dv:dbias": 2}


def check_grouped_chunked_kernels(gen, dev) -> dict:
    """The CHUNKED tiled K2a and K2b with dbias at G 28 and 64 rows an
    entity, N 65 and 128, E 600, D 300, float32, bias, dropout 0.3 with a
    seed an entity: each grouped launch against its 28 ungrouped launches
    at the grouped plan (slices and K2b's batch group forced to the grouped
    launch's) bit for bit, and within ``TRAIN_TOL`` of the grouped plain
    version (da and dbias each entity's); each timed by CUDA graph beside
    the 28 launches and its bound, with the plans beside a solo call's at
    64 rows and each new instantiation's blocks a multiprocessor beside the
    ungrouped one's."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    G, rows = len(FLEET_GROUPS), FLEET_WIDE_ROWS
    B = G * rows
    sms = _sms(dev)
    out = {}
    for name, N, E, D in FLEET_FEATURES_LAYERS:
        p, q, _, _, v = gat_case(gen, dev, B, N, E, D, torch.float32, False)
        a = (torch.randn(G, E, generator=gen) * (6.0 / (E + 1)) ** 0.5).to(dev)
        bias = (0.1 * torch.randn(G, N, N, generator=gen)).to(dev)
        seeds = torch.randint(0, 2**32, (G,), generator=gen, dtype=torch.int64).to(dev)
        sl = lambda t, g: t[g * rows:(g + 1) * rows]  # noqa: E731
        _, u, m, l = kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seeds, FLEET_RATE)
        sig = torch.sigmoid(u)
        du = torch.randn(B, N, D, generator=gen).to(dev) * sig * (1 - sig)
        dvec = (du * u).sum(-1)
        args = (p, q, a, bias, v, m, l, du, dvec, 0.2, seeds, FLEET_RATE)

        def one(g):
            return (sl(p, g), sl(q, g), a[g], bias[g], sl(v, g),
                    *(sl(t, g) for t in (m, l, du, dvec)), 0.2, seeds[g:g + 1], FLEET_RATE)

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dp, da = kg.gatv2_bwd_dp_da(*args)
        pa = kg.gatv2_bwd_dp_da.last_plan
        dq, dv, db = kg.gatv2_bwd_dq_dv(*args, dbias=True)
        pb = kg.gatv2_bwd_dq_dv.last_plan
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        grads = (dp, dq, da, dv, db)
        solo = kg.gat_tiled_bwd_plan(rows, N, E, D, sms, dbias=True)
        plans = {"k2a": pa._asdict(), "k2b": pb._asdict(),
                 "solo_slices": [solo["k2a"].slices, solo["k2b"].slices],
                 "solo_k2b_group": solo["k2b"].group}
        k2a_per = lambda: [kg.gatv2_bwd_dp_da(*one(g), plan=pa) for g in range(G)]  # noqa
        k2b_per = lambda: [kg.gatv2_bwd_dq_dv(*one(g), dbias=True, plan=pb)  # noqa: E731
                           for g in range(G)]
        grads_per = [(x[0], y[0], x[1], y[1], y[2]) for x, y in zip(k2a_per(), k2b_per())]
        ref = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2, seeds, FLEET_RATE)
        torch.cuda.synchronize()
        same = {k: torch.equal(grads[i], (torch.stack if k in ("da", "dbias") else torch.cat)(
                    [y[i] for y in grads_per]))
                for i, k in enumerate(("dp", "dq", "da", "dv", "dbias"))}
        gerr, gabs = grad_errors(grads, ref, grads[4])
        tol = TRAIN_TOL[torch.float32]
        bounds = wide_bounds(B, G, N, E, D)
        times = {}
        for key, fn, per_fn in (("k2a", lambda: kg.gatv2_bwd_dp_da(*args), k2a_per),
                                ("k2b", lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True),
                                 k2b_per)):
            times[key] = {"graph_ms": graph_ms(fn, calls=3, replays=3),
                          "G_launches_graph_ms": graph_ms(per_fn, calls=1, replays=2),
                          "bound_ms": bounds[key][0], "bound_by": bounds[key][1]}
        rec = {"phase": "fleet_wide_features", "case": f"grouped CHUNKED K2a and K2b with "
               f"dbias, {name} ({B}, {N}, {E}, {D}), float32, dropout {FLEET_RATE}, one seed "
               "an entity", "G": G, "rows_per_group": rows, "route": kg.gat_bwd_route(N, E, D),
               "bwd_plans": plans, "bwd_peak_mb_above_inputs": peak,
               "bwd_identical_to_G_launches": same, "grad_rel_err": gerr,
               "grad_abs_err": gabs, "tol": tol,
               "occupancy": wide_occupancy(kg, "tiled", plans, N, E, D), **times,
               "what": "graph_ms: the grouped launch's device time from a CUDA graph, the "
                       "sums of da and dbias entity by entity included; G_launches_graph_ms: "
                       "its 28 ungrouped launches' at the grouped plan; bwd_plans: the grouped "
                       "launch's beside a solo call's at 64 rows"}
        emit(rec)
        if (not all(same.values()) or pa.tile != kg.CHUNKED or pb.tile != kg.CHUNKED
                or pa.entities != G or pb.entities != G
                or plans["solo_slices"] != [pa.slices, pb.slices]
                or not max(gerr.values()) <= tol["grad"]):
            raise AssertionError(f"grouped CHUNKED kernels ({name}): {rec}")
        out[name] = rec
        del p, q, v, grads, grads_per, ref, du, dvec, u, m, l, sig
        torch.cuda.empty_cache()
    return out


def fleet_features_numbers(dev, smi) -> dict:
    """Path (a): ``MultiEntityTrainer.fit`` over 28 synthetic machines of 65
    features (``synthetic_series``, seeds 1-28, depth cut to
    ``FLEET_FEATURES_WINDOWS`` windows each), window 300, batch 64, dropout
    0.3, flagship widths, the attention and the GRU through the kernels: a
    fresh fleet an epoch, a warm-up, one timed (launches exact by kernel and
    variant, no plain attention or GRU call, windows/s, step p50 and p99 on
    the device's clock, peak memory above the baseline) and one profiled
    (busy share, device time by kernel); every loss finite."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import synthetic_series
    from mtad_gat_tpu_torch.kernels import gat as kg
    from mtad_gat_tpu_torch.training import MultiEntityTrainer

    k, w = FLEET_FEATURES, FLEET_WIDE_LOOKBACK
    series = [synthetic_series(n_train=w + FLEET_FEATURES_WINDOWS, n_test=16, n_features=k,
                               seed=1 + e)[0] for e in range(len(FLEET_GROUPS))]
    cfg = RunConfig(bs=FLEET_TRAIN_BS, epochs=1, log_tensorboard=False, dropout=0.3,
                    attention_impl="pallas", gru_impl="pallas", lookback=w)
    mc = cfg.model_config(k, k)
    feature = (k, 2 * w, w)
    if not (kg.chunked_tile(*feature) and kg.gat_fwd_plan(*feature) == "tiled"):
        raise AssertionError(f"fleet_wide_features: the feature layer {feature} does not take "
                             "the tiled K1-res and the CHUNKED backward")
    losses = []

    def train_one_epoch():
        fleet = MultiEntityTrainer(mc, cfg.train_config(), device=str(dev))
        fleet.fit(series, verbose=False)
        losses.extend(v for ent in fleet.losses for vals in ent.values() for v in vals)

    train_one_epoch()                                                    # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FleetProbe() as probe, plain_calls() as plain:
        train_one_epoch()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    epoch = probe.epochs[0]
    steps = epoch["steps"]
    want = {"gru_scan_fwd": 2 * steps, "gru_scan_bwd": 2 * steps, "gru_weight_grads": 2 * steps,
            **{key: n * steps for key, n in FLEET_FEATURES_STEP_LAUNCHES.items()}}
    wrong = {key: n for key, n in epoch["launches"].items() if n != want.get(key, 0)}
    step_ms = probe.step_ms()
    prof = profile_device(train_one_epoch, f"path (a): fleet training, {len(FLEET_GROUPS)} "
                          f"entities of {k} features, attention and GRU kernels, batch "
                          f"{FLEET_TRAIN_BS}, window {w}, one epoch with its validation, float32")
    prof["phase"] = "fleet_wide_features"
    emit(prof)
    rec = {"phase": "fleet_wide_features", "case": "path (a) numbers", "card": smi,
           "entities": len(FLEET_GROUPS), "features": k, "batch": FLEET_TRAIN_BS,
           "lookback": w, "dropout": cfg.dropout,
           "launches_in_epoch": {key: n for key, n in epoch["launches"].items() if n},
           "expected_launches": want, "plain_calls": dict(plain),
           "vmap_rule_calls": epoch["rule_calls"],
           "train_windows": epoch["windows"], "fleet_steps": steps,
           "epoch_seconds": epoch["seconds"],
           "windows_per_s": epoch["windows"] / epoch["seconds"],
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "peak_mb_above_baseline": peak, "busy_share": prof["busy_share"],
           "losses_finite": bool(np.all(np.isfinite(losses))),
           "what": "windows/s: all entities' real training windows over the epoch's "
                   "train_epoch seconds; step ms: on the device's clock, from one step's start "
                   "to the next's; the profile covers the epoch's validation too"}
    emit(rec)
    if wrong or any(plain.values()) or not rec["losses_finite"] or steps < 1:
        raise AssertionError(f"fleet_wide_features path (a): launches off {wrong}, {rec}")
    return rec


def check_fleet_wide_features(gen, dev, work, smi) -> dict:
    """Phase ``fleet_wide_features``: the grouped CHUNKED kernels
    (``check_grouped_chunked_kernels``); path (a), a fleet of 65 features
    at window 300 through them (``fleet_features_numbers``); path (b), the
    28 machines of ``write_fleet`` (seeds 1-28, depth cut to
    ``FLEET_BAND_ROWS`` rows) trained by ``sweep_cli.main --batched
    --lookback 300 --temporal_graph band:64 --bias_storage band
    --attention_impl dense --gru_impl pallas --bs 64`` (1 epoch, dropout
    0.3): the temporal layer is the block scan under vmap, a fleet step's
    launches exact (the GRU's), no plain GRU call, every summary finite,
    ``predict_cli`` reproducing one; three machines against their solo
    trainers at dropout 0 within ``FLEET_PARITY_TOL``; then its windows/s,
    step p50 and p99, peak memory and busy share. The peak must stay within
    half the card's memory: a recompute recorded under ``torch.func.grad``
    kept every step's score tile (65.8 GB, out of memory once the allocator
    fragmented)."""
    kernels = check_grouped_chunked_kernels(gen, dev)
    features = fleet_features_numbers(dev, smi)
    root = os.path.join(work, "fleet_band")
    data_root, out_root = os.path.join(root, "data"), os.path.join(root, "output")
    for e, group in enumerate(FLEET_GROUPS):
        write_smd(data_root, n=FLEET_BAND_ROWS, group=group, seed=1 + e)
    common = ["--dataset", "SMD", "--epochs", "1", "--dropout", "0.3", "--data_root",
              data_root, "--device", "cuda", "--log_tensorboard", "False", *FLEET_BAND]
    sweep = batched_sweep(common, out_root, "band", "dense", FLEET_TRAIN_BS,
                          FLEET_WIDE_LOOKBACK, band=True)
    parity = check_fleet_parity(data_root, dev, "dense", FLEET_WIDE_LOOKBACK, (0.0,),
                                band=True)
    numbers = fleet_training_numbers(data_root, smi, dev, "dense", FLEET_TRAIN_BS,
                                     FLEET_WIDE_LOOKBACK, band=True)
    half = torch.cuda.get_device_properties(dev).total_memory / 2**21
    if not numbers["peak_mb_above_baseline"] <= half:
        raise AssertionError(f"fleet_wide_features path (b): peak "
                             f"{numbers['peak_mb_above_baseline']:.1f} MB above the baseline, "
                             f"over half the card's {half:.1f} MB")
    return {"kernels": kernels, "features": features, "sweep": sweep, "parity": parity,
            "numbers": numbers,
            "launches": {key: features["launches_in_epoch"].get(key, 0) + sweep["launches"][key]
                         for key in sweep["launches"]}}


def fleet_features_row(ff: dict, key: str) -> dict:
    """The CHUNKED K2a's ("k2a") or K2b's ("k2b") ``fleet_wide_features``
    entry of the kernels line: its launches in path (a) (one a fleet step,
    at the feature layer), and its grouped launch at G 28 beside the 28
    ungrouped launches, their bits, errors and bound, at N 65 and 128."""
    name = {"k2a": "gatv2_bwd_dp_da", "k2b": "gatv2_bwd_dq_dv"}[key]
    feats = ff["features"]
    return {"launches": feats["launches_in_epoch"].get(f"{name}:chunked", 0),
            "fleet_steps": feats["fleet_steps"], "launches_per_fleet_step": 1,
            "groups": len(FLEET_GROUPS), "rows_per_group": FLEET_WIDE_ROWS,
            "grouped": {layer: {**rec[key],
                                "identical_to_G_launches": all(
                                    rec["bwd_identical_to_G_launches"].values()),
                                "max_err": rec["grad_rel_err"],
                                "plan": {f: rec["bwd_plans"][key][f]
                                         for f in ("slices", "group", "blocks")}}
                        for layer, rec in ff["kernels"].items()}}


# ---------------------------------------------------------------------------
# Multi-device (phase 20): the mesh's ranks as processes sharing the card
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_DEADLINE = 600.0
# One step's gradients on a rank of the (data 2) mesh against the single
# device's on the same batch, per parameter: max abs difference over the
# single device's max abs value. TRAIN_TOL's 1e-5 holds one kernel against
# its plain version; here the whole model's backward sums each half batch
# apart (K2ab's dbias groups and K4's split-K chunks follow the batch) and
# the two halves across ranks, so ten times that.
MESH_GRAD_TOL = 1e-4
MESH_RING_ROWS = 700              # the ring path's entity: 6 steps of 64 at window 300
# the halo path's entity: phase long_window's configuration, 306 windows at
# lookback 1024 (5 steps of 64 and a validation batch an epoch)
HALO_ROWS = 1330
HALO_FLAGS = ["--lookback", "1024", "--temporal_graph", "band:128", "--bias_storage", "band",
              "--bs", "64"]
FLEET_MESH_RANKS = 3


def mesh_argv(data_root: str, out_root: str, *flags: str) -> list:
    return ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root,
            "--output_root", out_root, "--device", "cuda", "--log_tensorboard", "False",
            "--seed", "0", *flags]


def param_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def flagship_trainer(log_dir: str, dropout: float, mesh=None):
    """The flagship Trainer through every kernel, from train seed 0."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.training import Trainer

    cfg = RunConfig(attention_impl="pallas", gru_impl="pallas", dropout=dropout, epochs=1,
                    log_tensorboard=False)
    trainer = Trainer(cfg.model_config(38, 38), cfg.train_config(), log_dir=log_dir,
                      device="cuda", mesh=mesh)
    trainer.init_state()
    return trainer


def first_batch_grads(trainer, x_train) -> dict:
    """One step's gradients on windows 0..255 (this rank's columns of them
    on a mesh, summed over it), as float32 numpy by parameter."""
    from mtad_gat_tpu_torch.data.windows import batched_starts
    from mtad_gat_tpu_torch.parallel import multihost

    starts, mask, _ = batched_starts(0, 256, indices=np.arange(256))
    starts, mask = multihost.epoch_arrays(trainer.mesh, starts, mask)
    trainer.step_gradients(trainer._series(x_train), starts[0].cuda(), mask[0].cuda(),
                           trainer.step_generator())
    grads = {k: p.grad.detach().cpu().numpy().copy()
             for k, p in trainer.model.named_parameters()}
    trainer.optimizer.zero_grad(set_to_none=True)
    return grads


def timed_epoch(trainer, x_train) -> dict:
    """A warm-up epoch, then one timed epoch (device synced) over the
    training windows at batch 256: windows, seconds, windows/s and the peak
    memory above the baseline."""
    from mtad_gat_tpu_torch.data.windows import batched_starts

    series = trainer._series(x_train)
    n_win = len(x_train) - trainer.window
    starts, mask, _ = batched_starts(0, 256, indices=np.arange(n_win - n_win // 10))
    trainer.train_epoch(series, starts, mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer.train_epoch(series, starts, mask)          # ends in a device sync
    seconds = time.perf_counter() - t0
    windows = int(mask.sum())
    return {"windows": windows, "steps": int(starts.shape[0]), "seconds": seconds,
            "windows_per_s": windows / seconds,
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - base}


def multi_device_rank(data_root: str, ring_root: str, halo_root: str, out_root: str) -> list:
    """One rank of phase 20 (every rank runs it; rank 0 returns every
    rank's record). (a) ``train_cli.train_rank``, the function each rank
    of ``train_cli --mesh_devices 2 --model_parallel 1`` runs, at the
    flagship through every kernel, dropout 0.3, 1 epoch: launches, plain
    calls, the trained parameters' digest; then on a (data 2) mesh one
    step's gradients at dropout 0 and a timed epoch at dropout 0.3. (b)
    ``train_rank`` of ``--mesh_devices 2 --model_parallel 2 --attention_impl
    ring --lookback 300 --bs 64`` at dropout 0: launches, ring calls,
    losses, digest, peak memory. (c) ``train_rank`` of the same mesh at
    ``HALO_FLAGS`` (lookback 1024, band:128) at dropout 0: launches, halo
    and ring calls, plain calls, losses, digest, peak memory; then a
    ``Trainer`` epoch at dropout 0.3 on a (model 2) mesh."""
    import torch.distributed as dist

    import mtad_gat_tpu_torch.nn.gat as ngat
    from mtad_gat_tpu_torch.cli import train_cli
    from mtad_gat_tpu_torch.cli.args import get_parser, to_run_config
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.parallel import make_mesh

    def entry(run_id):
        return lambda argv: train_cli.train_rank(to_run_config(get_parser().parse_args(argv)),
                                                 run_id, None, None, "cuda")

    rec = {"rank": dist.get_rank(), "device": str(torch.device("cuda", 0)),
           "backend": dist.get_backend()}
    out_a = os.path.join(out_root, "data_axis")
    prof_a = os.path.join(out_a, "prof")
    with plain_calls() as plain, counted_traces() as traces:
        run = timed_train_cli(mesh_argv(data_root, out_a, "--attention_impl", "pallas",
                                        "--gru_impl", "pallas", "--epochs", "1", "--run_id",
                                        "mesh", "--mesh_devices", "2", "--model_parallel", "1",
                                        "--profile_dir", prof_a),
                              out_a, entry("mesh"))
    rec["cli"] = {k: run[k] for k in ("seconds", "launches", "peak_extra_bytes",
                                      "train_windows_per_s_by_epoch", "epoch_losses",
                                      "summary")}
    rec["cli"].update(plain=dict(plain), digest=param_digest(run["last_epoch"]["trainer"].model))
    # each rank's own trace of the epoch: its worker name carries the rank
    dist.barrier()
    mine = sorted(f for f in os.listdir(prof_a) if f"_rank{rec['rank']}." in f)
    rec["cli"]["trace"] = {"files": mine, "traces_opened": len(traces)}
    if len(mine) == 1 and len(traces) == 1:
        rec["cli"]["trace"].update(trace_record(os.path.join(prof_a, mine[0]),
                                                traces[0]["launches"]),
                                   seconds=traces[0]["seconds"])
    del run
    # path (a)'s run kept PyTorch's TF32 defaults, as predict_cli's ranks
    # do; what follows is held against this process's float32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    (x_train, _), _ = get_data("machine-1-1", data_root=data_root, normalize=True)
    mesh = make_mesh(model_parallel=1, device=torch.device("cuda", 0))
    rec["mesh"] = mesh.describe()
    rec["grads"] = first_batch_grads(flagship_trainer(os.path.join(out_root, "logs"), 0.0, mesh),
                                     x_train)
    trainer = flagship_trainer(os.path.join(out_root, "logs"), 0.3, mesh)
    rec["epoch"] = timed_epoch(trainer, x_train)
    rec["epoch"]["digest"] = param_digest(trainer.model)
    del trainer

    out_b = os.path.join(out_root, "model_axis")
    real_ring, ring_calls = ngat.ring_gatv2_attention, [0]

    def counted_ring(*args, **kw):
        ring_calls[0] += 1
        return real_ring(*args, **kw)

    ngat.ring_gatv2_attention = counted_ring
    try:
        run = timed_train_cli(mesh_argv(ring_root, out_b, "--lookback", "300", "--bs", "64",
                                        "--attention_impl", "ring", "--gru_impl", "pallas",
                                        "--epochs", "1", "--dropout", "0", "--run_id", "ring",
                                        "--mesh_devices", "2", "--model_parallel", "2"),
                              out_b, entry("ring"))
    finally:
        ngat.ring_gatv2_attention = real_ring
    rec["ring"] = {k: run[k] for k in ("seconds", "launches", "peak_extra_bytes",
                                       "train_windows_per_s_by_epoch", "epoch_losses",
                                       "step_losses")}
    rec["ring"].update(ring_calls=ring_calls[0],
                       digest=param_digest(run["last_epoch"]["trainer"].model))
    del run
    rec["halo"] = halo_rank_path(halo_root, os.path.join(out_root, "halo"), entry("halo"))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, rec)
    return every


def halo_rank_path(halo_root: str, out_c: str, entry) -> dict:
    """Path (c) on one rank: ``entry`` (``train_rank``) of ``HALO_FLAGS`` on
    (model 2) at dropout 0 with the halo and the ring counted and the plain
    calls, then one ``Trainer`` epoch at dropout 0.3 on a (model 2) mesh."""
    import mtad_gat_tpu_torch.nn.gat as ngat
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.data.windows import batched_starts
    from mtad_gat_tpu_torch.parallel import make_mesh
    from mtad_gat_tpu_torch.training import Trainer

    calls = {"banded_halo_attention": 0, "ring_gatv2_attention": 0}
    real = {name: getattr(ngat, name) for name in calls}

    def counted(name):
        def call(*args, **kw):
            calls[name] += 1
            return real[name](*args, **kw)
        return call

    for name in calls:
        setattr(ngat, name, counted(name))
    t0 = time.perf_counter()
    try:
        with plain_calls() as plain:
            run = timed_train_cli(mesh_argv(halo_root, out_c, *HALO_FLAGS, "--attention_impl",
                                            "ring", "--gru_impl", "pallas", "--epochs", "1",
                                            "--dropout", "0", "--run_id", "halo",
                                            "--mesh_devices", "2", "--model_parallel", "2"),
                                  out_c, entry)
    finally:
        for name, fn in real.items():
            setattr(ngat, name, fn)
    trainer = run["last_epoch"]["trainer"]
    rec = {k: run[k] for k in ("seconds", "launches", "peak_extra_bytes",
                               "train_windows_per_s_by_epoch", "epoch_losses", "step_losses")}
    rec.update(calls=dict(calls), plain=dict(plain), digest=param_digest(trainer.model),
               temporal_halos=trainer.model.temporal_gat.halos(trainer.mesh),
               feature_rings=trainer.model.feature_gat.rings(trainer.mesh))
    del run, trainer

    mesh = make_mesh(model_parallel=2, device=torch.device("cuda", 0))
    cfg = RunConfig(lookback=1024, temporal_graph="band:128", bias_storage="band", bs=64,
                    attention_impl="ring", gru_impl="pallas", dropout=0.3, epochs=1,
                    log_tensorboard=False)
    trainer = Trainer(cfg.model_config(38, 38), cfg.train_config(),
                      log_dir=os.path.join(out_c, "logs_dropout"), device="cuda", mesh=mesh)
    trainer.init_state()
    (x_train, _), _ = get_data("machine-1-1", data_root=halo_root, normalize=True)
    starts, mask, _ = batched_starts(0, 64, indices=np.arange(len(x_train) - 1024))
    f, r = trainer.train_epoch(trainer._series(x_train), starts, mask)
    rec.update(dropout_losses=[f.tolist(), r.tolist()], dropout_digest=param_digest(trainer.model),
               path_seconds=time.perf_counter() - t0)
    return rec


def fleet_mesh_parity(fleet_data: str, ref_path: str, mesh=None) -> dict:
    """Phase ``fleet_training``'s 28 machines at dropout 0 through every
    kernel, batch 64, 1 epoch, on cuDNN's deterministic algorithms (its
    default weight gradient of the grouped conv sums with atomics, and two
    runs of one fleet then disagree) and with TF32 off. Without ``mesh``, on this device: one
    ``MultiEntityTrainer`` of all 28 (G 28) and one of each block that
    ``FLEET_MESH_RANKS`` data ranks train (``entity_blocks``: G 10, 9, 9),
    written to ``ref_path``. Over ``mesh`` (every rank calls this): the
    fleet's parameters and losses against both, bit for bit against the
    blocks' and by their largest differences against G 28's."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.training import MultiEntityTrainer
    from mtad_gat_tpu_torch.training.multi_entity import entity_blocks

    cfg = RunConfig(bs=FLEET_TRAIN_BS, epochs=1, dropout=0.0, log_tensorboard=False,
                    attention_impl="pallas", gru_impl="pallas")
    series = [get_data(f"machine-{g}", data_root=fleet_data, normalize=True)[0][0]
              for g in FLEET_GROUPS]

    def fit(entities, over=None):
        fleet = MultiEntityTrainer(cfg.model_config(38, 38), cfg.train_config(), device="cuda",
                                   mesh=over)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fleet.fit(entities, verbose=False)
        torch.cuda.synchronize()
        return {"seconds": time.perf_counter() - t0, "fleet_steps": fleet.fleet_steps,
                "losses": [e["train_total"] for e in fleet.losses],
                "params": {k: v.detach().cpu() for k, v in fleet.params.items()}}

    # and with TF32 off on both sides: spawned ranks start with PyTorch's
    # defaults, whose cuDNN convolutions take TF32
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if mesh is None:
            whole = fit(series)
            parts = [fit(series[first:end]) for first, end in
                     entity_blocks(len(series), FLEET_MESH_RANKS)]
            blocks = {"losses": [x for p in parts for x in p["losses"]],
                      "params": {k: torch.cat([p["params"][k] for p in parts])
                                 for k in whole["params"]}}
            torch.save({"whole": whole, "blocks": blocks}, ref_path)
            return {"seconds": whole["seconds"], "fleet_steps": whole["fleet_steps"],
                    "blocks_seconds": [p["seconds"] for p in parts]}
        mine = fit(series, mesh)
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    ref = torch.load(ref_path)
    params, whole = mine["params"], ref["whole"]["params"]
    return {"seconds": mine["seconds"], "fleet_steps": mine["fleet_steps"],
            "bits_equal_to_blocks_by_param": {k: torch.equal(v, ref["blocks"]["params"][k])
                                              for k, v in params.items()},
            "losses_equal_to_blocks": mine["losses"] == ref["blocks"]["losses"],
            "g28_param_max_abs_err_by_entity": [
                max((params[k][e] - whole[k][e]).abs().max().item() for k in params)
                for e in range(len(series))],
            "g28_param_max_abs_err_by_name": {k: (v - whole[k]).abs().max().item()
                                              for k, v in params.items()},
            "g28_bits_equal_by_param": {k: torch.equal(v, whole[k]) for k, v in params.items()},
            "g28_loss_max_abs_err": float(np.max(np.abs(
                np.array(mine["losses"]) - np.array(ref["whole"]["losses"]))))}


def batched_product_probe(gen) -> dict:
    """Whether the fleet's vmapped ops give an entity's bits whatever the
    number of entities: products of the model that run no kernel of the
    port (a linear layer at the GRU input projection's and the heads'
    shapes, the conv, a batched matmul at the attention's projection) and
    two reductions (the RMSE's mean, a bias gradient's sum), each op's
    output and its gradients of both operands, at G 28 against the same
    entities' slices at G 10 and 9 (the blocks of 3 data ranks), with
    cuDNN's default and its deterministic algorithms."""
    import torch.nn.functional as F

    def r(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    cases = {
        "linear (6400, 38) x (450, 38) [GRU input projection]":
            (lambda x, w: F.linear(x, w), (6400, 38), (450, 38)),
        "linear (64, 150) x (150, 150) [forecast head]":
            (lambda x, w: F.linear(x, w), (64, 150), (150, 150)),
        "conv1d (64, 38, 106) x (38, 38, 7) [conv]":
            (lambda x, w: F.conv1d(x, w), (64, 38, 106), (38, 38, 7)),
        "matmul (64, 38, 100) x (100, 200) [feature attention's projection]":
            (lambda x, w: torch.matmul(x, w), (64, 38, 100), (100, 200)),
        "matmul (64, 38, 100) x lin.weight[:, :100].T (200, 200) [as nn/gat.py computes p]":
            (lambda x, w: x @ w[:, :100].t(), (64, 38, 100), (200, 200)),
        "matmul (64, 100, 38) x lin.weight[:, :38].T (76, 76) [the temporal layer's p]":
            (lambda x, w: x @ w[:, :38].t(), (64, 100, 38), (76, 76)),
        "mean over a window's (100, 38) [the RMSE's per-window mean]":
            (lambda x, w: ((x - w) ** 2).reshape(64, -1).mean(dim=1), (64, 100, 38),
             (64, 100, 38)),
        "sum over the batch (64, 450) [a bias gradient]":
            (lambda x, w: (x * w).sum(dim=0), (64, 450), (64, 450)),
    }
    def run(fn, x, w, cot):
        """The vmapped product and its gradients of x and w for ``cot``."""
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = torch.func.vmap(fn)(xs, ws)
        out.backward(cot)
        return out.detach(), xs.grad, ws.grad

    out = {}
    deterministic = torch.backends.cudnn.deterministic
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            for name, (fn, xs, ws) in cases.items():
                x, w = r(28, *xs), r(28, *ws)
                cot = r(*torch.func.vmap(fn)(x, w).shape)
                whole = run(fn, x, w, cot)
                out[f"{name}, cudnn.deterministic {det}"] = {
                    f"G {end - first} (entities {first}-{end - 1})": [
                        torch.equal(part, full[first:end]) for part, full in zip(
                            run(fn, x[first:end], w[first:end], cot[first:end]), whole)]
                    for first, end in ((0, 10), (10, 19))}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def fleet_mesh_rank(argv: list, fleet_data: str, ref_path: str) -> list:
    """One rank of phase 20's path (d) (every rank runs it; rank 0 returns
    every rank's record): ``sweep_cli.main(argv)`` as this rank of the
    group (``--num_processes``), with its fleet epoch probed (launches,
    vmap rules, each grouped kernel's G), the plain calls counted and the
    peak memory; then ``fleet_mesh_parity`` over a (data 3) mesh."""
    import torch.distributed as dist

    from mtad_gat_tpu_torch.cli import sweep_cli
    from mtad_gat_tpu_torch.kernels import gat as kg
    from mtad_gat_tpu_torch.kernels import gru as kgru
    from mtad_gat_tpu_torch.parallel import make_mesh
    from mtad_gat_tpu_torch.training import MultiEntityTrainer

    rank, world = dist.get_rank(), dist.get_world_size()
    grouped = {"gatv2_attention_res": kg.gatv2_attention_res, "gatv2_bwd_graph": kg.gatv2_bwd_graph,
               "gru_scan_fwd": kgru.gru_scan_fwd, "gru_scan_bwd": kgru.gru_scan_bwd,
               "gru_weight_grads": kgru.gru_weight_grads}
    groups = {}
    real_epoch = MultiEntityTrainer.train_epoch

    def epoch(trainer, *args):
        out = real_epoch(trainer, *args)
        # the epoch's last launches: its last step's, all grouped
        groups.update(entities=trainer.n_entities,
                      **{k: fn.last_launch["groups"] for k, fn in grouped.items()})
        return out

    MultiEntityTrainer.train_epoch = epoch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    try:
        with FleetProbe() as probe, plain_calls() as plain:
            t0 = time.perf_counter()
            sweep_cli.main(argv + ["--num_processes", str(world), "--process_id", str(rank)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        MultiEntityTrainer.train_epoch = real_epoch
    rec = {"rank": rank, "seconds": seconds, "launches": read_counts(), "plain": dict(plain),
           "epoch": probe.epochs[0], "groups": groups,
           "peak_extra_bytes": torch.cuda.max_memory_allocated() - base}
    mesh = make_mesh(model_parallel=1, device=torch.device("cuda", 0))
    rec["parity"] = fleet_mesh_parity(fleet_data, ref_path, mesh)
    every = [None] * world
    dist.all_gather_object(every, rec)
    return every


def check_fleet_mesh(gen, work, fleet_data: str, one_device: dict, smi: str) -> dict:
    """Path (d) of phase 20: the one-device fleet at dropout 0 here, then
    ``FLEET_MESH_RANKS`` ranks sharing the card, each running
    ``fleet_mesh_rank``; the ``fleet_state.pt`` they wrote resumed here.
    ``one_device`` is phase ``fleet_training``'s one-device sweep at the
    same settings. Fails on any check; returns rank 0's launches and the
    record."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.parallel import multihost
    from mtad_gat_tpu_torch.training import MultiEntityTrainer
    from mtad_gat_tpu_torch.training.multi_entity import entity_blocks

    t0 = time.perf_counter()
    root = os.path.join(work, "multi_device_fleet")
    os.makedirs(root)
    ref_path = os.path.join(root, "one_device_params.pt")
    one_parity = fleet_mesh_parity(fleet_data, ref_path)
    probe = batched_product_probe(gen)
    out_d = os.path.join(root, "output")
    argv = ["--dataset", "SMD", "--epochs", "1", "--dropout", "0.3", "--data_root", fleet_data,
            "--device", "cuda", "--log_tensorboard", "False", "--bs", str(FLEET_TRAIN_BS),
            "--output_root", out_d, "--batched", "--run_id", "mesh", "--attention_impl",
            "pallas", "--gru_impl", "pallas", "--mesh_devices", str(FLEET_MESH_RANKS),
            "--groups", ",".join(FLEET_GROUPS)]
    t1 = time.perf_counter()
    every = multihost.spawn(FLEET_MESH_RANKS, fleet_mesh_rank, (argv, fleet_data, ref_path),
                            device_type="cuda", deadline=MESH_DEADLINE)
    spawn_seconds = time.perf_counter() - t1

    E = len(FLEET_GROUPS)
    blocks = [end - first for first, end in entity_blocks(E, FLEET_MESH_RANKS)]
    problems = []
    for r, block in zip(every, blocks):
        name = f"rank {r['rank']} of the fleet mesh"
        try:
            expect_fleet_epoch(name, r["epoch"], 0.3, kernels=True)
        except AssertionError as err:
            problems.append(str(err))
        want_groups = {"entities": block, **{k: block for k in r["groups"] if k != "entities"}}
        if r["groups"] != want_groups:
            problems.append(f"{name}: grouped launches {r['groups']}, expected {want_groups}")
        if any(r["plain"].values()):
            problems.append(f"{name}: plain calls {r['plain']}")
    summaries = {}
    for group in FLEET_GROUPS:
        run = os.path.join(out_d, "SMD", group, "mesh")
        written = sorted(f for f in os.listdir(run) if f.startswith("summary"))
        if written != ["summary.txt"]:
            problems.append(f"{group}: summaries {written}")
        summaries[group] = finite_summary(os.path.join(run, "summary.txt"))
    if not os.path.exists(os.path.join(out_d, "SMD", "sweep_summary.json")):
        problems.append("no sweep_summary.json")

    # the fleet state the ranks wrote, resumed on this device
    cfg = RunConfig(bs=FLEET_TRAIN_BS, epochs=1, dropout=0.3, log_tensorboard=False,
                    attention_impl="pallas", gru_impl="pallas")
    resumed = MultiEntityTrainer(cfg.model_config(38, 38), cfg.train_config(), device="cuda")
    resumed.load_fleet(os.path.join(out_d, "SMD", "fleet", "mesh", "fleet_state.pt"), E)
    resumed.fit([get_data(f"machine-{g}", data_root=fleet_data, normalize=True)[0][0]
                 for g in FLEET_GROUPS], verbose=False)
    written = [torch.load(os.path.join(out_d, "SMD", g, "mesh", "model.pt")) for g in FLEET_GROUPS]
    resume_equal = resumed.fleet_steps == 0 and all(
        torch.equal(v, written[e][k])
        for e in range(E) for k, v in resumed.entity_params(e).items())
    if not resume_equal:
        problems.append("fleet_state.pt resumed on one device differs from the sweep's models")
    parity = every[0]["parity"]
    if not (all(parity["bits_equal_to_blocks_by_param"].values())
            and parity["losses_equal_to_blocks"]):
        problems.append("dropout 0: the mesh fleet differs from one device's fleets of its "
                        f"blocks: {parity['bits_equal_to_blocks_by_param']}")
    if parity["g28_loss_max_abs_err"] > FLEET_PARITY_TOL:
        problems.append("dropout 0: losses against one device's fleet of 28: "
                        f"{parity['g28_loss_max_abs_err']}")
    if any(r["parity"]["g28_param_max_abs_err_by_entity"]
           != parity["g28_param_max_abs_err_by_entity"] for r in every):
        problems.append("the ranks' gathered parameters differ")

    epochs = [r["epoch"] for r in every]
    windows, slowest = sum(ep["windows"] for ep in epochs), max(ep["seconds"] for ep in epochs)
    rec = {"phase": "multi_device", "path": "(d) the fleet over data ranks", "nvidia_smi": smi,
           "run": f"sweep_cli --batched --mesh_devices {FLEET_MESH_RANKS} --attention_impl "
                  f"pallas --gru_impl pallas --bs {FLEET_TRAIN_BS}, {E} machines, dropout 0.3, "
                  "1 epoch, each rank a process of one group (--num_processes)",
           "entity_blocks": blocks, "spawn_seconds": spawn_seconds,
           "seconds_by_rank": [r["seconds"] for r in every],
           "launches_by_rank": [r["launches"] for r in every],
           "grouped_G_by_rank": [r["groups"] for r in every],
           "fleet_steps_by_rank": [ep["steps"] for ep in epochs],
           "epoch_seconds_by_rank": [ep["seconds"] for ep in epochs],
           "windows_by_rank": [ep["windows"] for ep in epochs],
           "all_rank_windows_per_s": windows / slowest,
           "one_device_windows_per_s": one_device["windows_per_s"],
           "one_device_source": "phase fleet_training, sweep_cli --batched, attention pallas, "
                                f"batch {FLEET_TRAIN_BS}, dropout 0.3, this call",
           "peak_extra_bytes_by_rank": [r["peak_extra_bytes"] for r in every],
           "bf_f1_by_machine": {g: v["bf_result"]["f1"] for g, v in summaries.items()},
           "dropout0_bits_equal_to_one_device_blocks": all(
               parity["bits_equal_to_blocks_by_param"].values())
           and parity["losses_equal_to_blocks"],
           "dropout0_g28_param_max_abs_err_by_entity": parity["g28_param_max_abs_err_by_entity"],
           "dropout0_g28_param_max_abs_err_by_name": parity["g28_param_max_abs_err_by_name"],
           "dropout0_g28_loss_max_abs_err": parity["g28_loss_max_abs_err"],
           "dropout0_g28_all_bits_equal": all(parity["g28_bits_equal_by_param"].values()),
           "dropout0_fleet_steps": {"one_device_g28": one_parity["fleet_steps"],
                                    "by_rank": [r["parity"]["fleet_steps"] for r in every]},
           "dropout0_seconds": {"one_device_g28": one_parity["seconds"],
                                "one_device_blocks": one_parity["blocks_seconds"],
                                "by_rank": [r["parity"]["seconds"] for r in every]},
           "fleet_parity_tol": FLEET_PARITY_TOL,
           "g28_entities_params_within_tol": sum(
               e <= FLEET_PARITY_TOL for e in parity["g28_param_max_abs_err_by_entity"]),
           "held": "bits equal to one device's fleets of the same blocks (G 10, 9, 9); the "
                   "losses within fleet_parity_tol of one device's fleet of 28; its "
                   "parameters reported, not held: ops round by the entity count "
                   "(ops_bits_equal_by_G) and Adam turns a near-0 gradient's last bits "
                   "into updates of up to lr",
           "ops_bits_equal_by_G": probe,
           "fleet_state_resumed_on_one_device_equal": resume_equal,
           "path_seconds": time.perf_counter() - t0}
    emit(rec)
    if problems:
        raise AssertionError("multi_device (fleet): " + "; ".join(problems))
    return {"launches": every[0]["launches"], "record": rec}


def check_multi_device(gen, work, data_root: str, fleet_data: str, one_device_fleet: dict,
                       smi: str) -> dict:
    """Phase 20: ``MESH_RANKS`` ranks sharing the card over gloo (NCCL
    refuses two ranks on one device), spawned by ``parallel.multihost.spawn``
    as ``train_cli --mesh_devices`` spawns them, each running
    ``multi_device_rank`` (paths (a) to (c)); the single-device references
    in this process before, and ``predict_cli.main --mesh_devices 2`` after;
    then path (d), ``check_fleet_mesh``, on phase ``fleet_training``'s
    machines (``fleet_data``) beside its one-device sweep
    (``one_device_fleet``). Fails on any check; returns rank 0's launches
    on paths (a), (c) and (d) and the numbers."""
    from mtad_gat_tpu_torch.cli import predict_cli
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.parallel import multihost

    root = os.path.join(work, "multi_device")
    ring_root = os.path.join(root, "ring_data")
    write_smd(ring_root, n=MESH_RING_ROWS)
    halo_root = os.path.join(root, "halo_data")
    write_smd(halo_root, n=HALO_ROWS)
    (x_train, _), _ = get_data("machine-1-1", data_root=data_root, normalize=True)
    ref_grads = first_batch_grads(flagship_trainer(os.path.join(root, "logs"), 0.0), x_train)
    one = timed_epoch(flagship_trainer(os.path.join(root, "logs"), 0.3), x_train)
    out_dense = os.path.join(root, "dense")
    dense = timed_train_cli(mesh_argv(ring_root, out_dense, "--lookback", "300", "--bs", "64",
                                      "--attention_impl", "dense", "--gru_impl", "pallas",
                                      "--epochs", "1", "--dropout", "0", "--run_id", "dense"),
                            out_dense)
    del dense["last_epoch"]
    out_halo = os.path.join(root, "halo_dense")
    halo_dense = timed_train_cli(mesh_argv(halo_root, out_halo, *HALO_FLAGS, "--attention_impl",
                                           "dense", "--gru_impl", "pallas", "--epochs", "1",
                                           "--dropout", "0", "--run_id", "dense"), out_halo)
    del halo_dense["last_epoch"]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    every = multihost.spawn(MESH_RANKS, multi_device_rank,
                            (data_root, ring_root, halo_root, root),
                            device_type="cuda", deadline=MESH_DEADLINE)
    spawn_seconds = time.perf_counter() - t0
    out_a = os.path.join(root, "data_axis")
    run_a = os.path.join(out_a, "SMD", "1-1", "mesh")
    t0 = time.perf_counter()
    predict_cli.main(mesh_argv(data_root, out_a, "--model_id", "mesh", "--mesh_devices", "2",
                               "--model_parallel", "1"))
    predict_seconds = time.perf_counter() - t0

    want_a, steps_a = expected_training_launches(2000, 2000, 100, 256, 1, 0.1, "pallas")
    want_b, _ = expected_training_launches(MESH_RING_ROWS, MESH_RING_ROWS, 300, 64, 1, 0.1,
                                           "pallas")
    ring_want = {name: (want_b[name] if name.startswith("gru") else 0)
                 for name in KERNEL_COUNTERS}
    grad_err = [{k: float(np.abs(r["grads"][k] - g).max() / max(np.abs(g).max(), 1e-30))
                 for k, g in ref_grads.items()} for r in every]
    _, ring_loss_err = loss_errors(every[0]["ring"]["epoch_losses"], dense["epoch_losses"])
    ring_step_err = max(abs(x - y) / abs(y) for r, d in zip(every[0]["ring"]["step_losses"],
                                                            dense["step_losses"])
                        for x, y in zip(r, d))
    summary = finite_summary(os.path.join(run_a, "summary.txt"))
    reproduced = finite_summary(os.path.join(run_a, "summary_1.txt")) == summary
    want_c, steps_c = expected_training_launches(HALO_ROWS, HALO_ROWS, 1024, 64, 1, 0.1, "pallas")
    halo_want = {name: (want_c[name] if name.startswith("gru") else 0)
                 for name in KERNEL_COUNTERS}
    forwards_c = want_c["gru_scan_fwd"] // 2       # K3 twice a forward
    _, halo_loss_err = loss_errors(every[0]["halo"]["epoch_losses"], halo_dense["epoch_losses"])
    halo_step_err = max(abs(x - y) / abs(y) for r, d in zip(every[0]["halo"]["step_losses"],
                                                            halo_dense["step_losses"])
                        for x, y in zip(r, d))
    rec = {
        "phase": "multi_device", "nvidia_smi": smi, "ranks": MESH_RANKS,
        "backend": [r["backend"] for r in every], "mesh": every[0]["mesh"],
        "spawn_seconds": spawn_seconds, "predict_cli_seconds": predict_seconds,
        "data_axis": {
            "train_cli": [{k: r["cli"][k] for k in ("seconds", "launches", "plain",
                                                     "peak_extra_bytes",
                                                     "train_windows_per_s_by_epoch",
                                                     "digest")} for r in every],
            "expected_launches": want_a, "steps": steps_a,
            "epoch_losses": every[0]["cli"]["epoch_losses"],
            "bf_f1": summary["bf_result"]["f1"],
            "predict_cli_reproduces_summary": reproduced,
            "grad_max_rel_err_by_rank": [max(e.values()) for e in grad_err],
            "grad_tol": MESH_GRAD_TOL,
            "all_rank_windows_per_s": every[0]["epoch"]["windows_per_s"],
            "single_device_windows_per_s": one["windows_per_s"],
            "epoch_by_rank": [r["epoch"] for r in every], "single_device_epoch": one,
            "trace_files": sorted(os.listdir(os.path.join(out_a, "prof"))),
            "trace_by_rank": [r["cli"]["trace"] for r in every]},
        "model_axis": {
            "ring_launches_by_rank": [r["ring"]["launches"] for r in every],
            "ring_calls_by_rank": [r["ring"]["ring_calls"] for r in every],
            "expected_ring_calls": want_b["gru_scan_fwd"],
            "epoch_loss_max_rel_err": ring_loss_err, "step_loss_max_rel_err": ring_step_err,
            "tol": WIDE_LOSS_TOL,
            "peak_extra_bytes_by_rank": [r["ring"]["peak_extra_bytes"] for r in every],
            "dense_peak_extra_bytes": dense["peak_extra_bytes"],
            "ring_train_windows_per_s_by_epoch": every[0]["ring"]["train_windows_per_s_by_epoch"],
            "dense_train_windows_per_s_by_epoch": dense["train_windows_per_s_by_epoch"],
            "ring_epoch_losses": every[0]["ring"]["epoch_losses"],
            "dense_epoch_losses": dense["epoch_losses"],
            "digests": [r["ring"]["digest"] for r in every]},
        "halo": {
            "config": "train_rank of --mesh_devices 2 --model_parallel 2 --attention_impl ring "
                      "--gru_impl pallas " + " ".join(HALO_FLAGS) + f", {HALO_ROWS} rows, "
                      "dropout 0, 1 epoch; temporal N 1024 (512 a rank, W 128: the halo), "
                      "feature N 38 (19 a rank: the ring)",
            "steps": steps_c, "forwards": forwards_c,
            "temporal_halos_by_rank": [r["halo"]["temporal_halos"] for r in every],
            "feature_rings_by_rank": [r["halo"]["feature_rings"] for r in every],
            "calls_by_rank": [r["halo"]["calls"] for r in every],
            "launches_by_rank": [r["halo"]["launches"] for r in every],
            "plain_by_rank": [r["halo"]["plain"] for r in every],
            "epoch_loss_max_rel_err": halo_loss_err, "step_loss_max_rel_err": halo_step_err,
            "tol": WIDE_LOSS_TOL,
            "halo_epoch_losses": every[0]["halo"]["epoch_losses"],
            "one_device_epoch_losses": halo_dense["epoch_losses"],
            "dropout_0_3_losses": every[0]["halo"]["dropout_losses"],
            "peak_extra_bytes_by_rank": [r["halo"]["peak_extra_bytes"] for r in every],
            "one_device_peak_extra_bytes": halo_dense["peak_extra_bytes"],
            "halo_train_windows_per_s_by_epoch":
                every[0]["halo"]["train_windows_per_s_by_epoch"],
            "one_device_train_windows_per_s_by_epoch": halo_dense["train_windows_per_s_by_epoch"],
            "seconds_by_rank": [r["halo"]["path_seconds"] for r in every],
            "one_device_seconds": halo_dense["seconds"],
            "digests": [r["halo"]["digest"] for r in every],
            "dropout_digests": [r["halo"]["dropout_digest"] for r in every]},
    }
    emit(rec)
    problems = []
    for r in every:
        got = {k: v for k, v in r["cli"]["launches"].items() if k in want_a}
        if got != want_a:
            problems.append(f"rank {r['rank']}: train_cli launches {got}, expected {want_a}")
        if any(r["cli"]["plain"].values()):
            problems.append(f"rank {r['rank']}: plain calls {r['cli']['plain']}")
        if r["cli"]["summary"] != summary:
            problems.append(f"rank {r['rank']}: summary differs from the run's")
        tr = r["cli"]["trace"]
        if len(tr["files"]) != 1 or tr["traces_opened"] != 1 or trace_problem(tr):
            problems.append(f"rank {r['rank']}: trace {tr['files']}, opened "
                            f"{tr['traces_opened']}, {trace_problem(tr)}")
        if {k: r["ring"]["launches"][k] for k in KERNEL_COUNTERS} != ring_want:
            problems.append(f"rank {r['rank']}: ring launches {r['ring']['launches']}, "
                            f"expected {ring_want}")
        if r["ring"]["ring_calls"] != want_b["gru_scan_fwd"]:
            problems.append(f"rank {r['rank']}: {r['ring']['ring_calls']} ring calls")
        h = r["halo"]
        if {k: h["launches"][k] for k in KERNEL_COUNTERS} != halo_want:
            problems.append(f"rank {r['rank']}: halo launches {h['launches']}, expected "
                            f"{halo_want}")
        if h["calls"] != {"banded_halo_attention": forwards_c,
                          "ring_gatv2_attention": forwards_c}:
            problems.append(f"rank {r['rank']}: halo and ring calls {h['calls']}, expected "
                            f"{forwards_c} each")
        if any(h["plain"].values()) or not (h["temporal_halos"] and h["feature_rings"]):
            problems.append(f"rank {r['rank']}: halo path plain calls {h['plain']}, routes "
                            f"{h['temporal_halos']}, {h['feature_rings']}")
        if not np.all(np.isfinite(h["dropout_losses"])):
            problems.append(f"rank {r['rank']}: halo losses at dropout 0.3 "
                            f"{h['dropout_losses']}")
    if len(rec["data_axis"]["trace_files"]) != MESH_RANKS:
        problems.append(f"trace files {rec['data_axis']['trace_files']}, one a rank expected")
    if len(every[0]["cli"]["epoch_losses"]) != 1:
        problems.append(f"metrics written {len(every[0]['cli']['epoch_losses'])} times")
    for what in (lambda r: r["cli"]["digest"], lambda r: r["epoch"]["digest"],
                 lambda r: r["ring"]["digest"], lambda r: r["halo"]["digest"],
                 lambda r: r["halo"]["dropout_digest"]):
        if len({what(r) for r in every}) != 1:
            problems.append("the ranks' parameters differ")
    if max(max(e.values()) for e in grad_err) > MESH_GRAD_TOL:
        problems.append(f"gradients against one device's: {grad_err}")
    if not reproduced:
        problems.append("predict_cli --mesh_devices 2 did not reproduce the summary")
    if not (ring_loss_err <= WIDE_LOSS_TOL and ring_step_err <= WIDE_LOSS_TOL):
        problems.append(f"ring losses against dense: {ring_loss_err}, {ring_step_err}")
    if not (halo_loss_err <= WIDE_LOSS_TOL and halo_step_err <= WIDE_LOSS_TOL):
        problems.append(f"halo losses against one device's: {halo_loss_err}, {halo_step_err}")
    if problems:
        raise AssertionError("multi_device: " + "; ".join(problems))
    fleet = check_fleet_mesh(gen, work, fleet_data, one_device_fleet, smi)
    return {"launches": every[0]["cli"]["launches"], "halo_launches": every[0]["halo"]["launches"],
            "fleet_launches": fleet["launches"], "record": rec, "fleet": fleet["record"]}


# Phase bench_scripts: the root bench scripts' H100 counterparts, in-process
BENCH_EDGES_ITERS = 3
BENCH_CROSSOVER_NODES = (8192, 65536)
# K1 against its plain version at the table's cases (gatv2_attention_fwd_plain)
BENCH_K1_PLAIN_CASES = ((8, 128), (8, 512), (4, 2048))
# and against chunked_plain_attention beyond: (B, N, bias, query-row blocks
# checked (None: every row), rows a chunk); at N 65,536 the first, middle
# and last 128 rows, each chunk's (1, 32, 65536, 256) float32 scores 2.1 GB
BENCH_K1_CHUNKED_CASES = ((1, 8192, True, None, 512), (1, 8192, False, None, 512),
                          (1, 65536, False, ((0, 128), (32704, 32832), (65408, 65536)), 32))
# bfloat16 in, compared in float32: the kernel and the plain version round
# the same float32 sigmoid (a few 1e-7 apart) to bfloat16, one step apart
# at most, 2**-8 below 1.0 (K1_TOL's bfloat16 case); against the chunked
# plain version, whose output stays float32, half a step plus the same
# float32 differences
BENCH_K1_TOL = K1_TOL[torch.bfloat16]
BENCH_LONG = (8192, 256, 8, 4)       # bench_long_torch.CONFIGS' longest
BENCH_LONG_EPOCHS = 1
BENCH_FLEET = dict(E=4, batches_per_epoch=2, epochs=1)
BENCH_ATTRIB_STEPS = 10
BENCH_SECONDS_LIMIT = 90.0
# K3's and K4's kernels in a trace, by the counter whose launches they are
BENCH_GRU_KERNELS = {"gru_scan_fwd": r"\bgru_fwd_(cluster_)?kernel\b",
                     "gru_scan_bwd": r"\bgru_bwd_(cluster|scan)_kernel\b",
                     "gru_weight_grads": r"\bgru_bwd_weights_kernel\b"}
# the modules a captured flagship trace must attribute device time to
BENCH_ATTRIB_MODULES = ("feature GAT", "temporal GAT", "gru input proj / grads", "gru scan body",
                        "window gather", "adam update")


def k1_e256_bound(B: int, N: int, bias: bool) -> tuple:
    """K1's bound at bench_edges' widths (E 256, D 128, bfloat16 inputs and
    output): 4E + 2D operations a pair; p, q, v, a (and bias) read once,
    the output written once."""
    import bench_edges_torch as be

    nbytes = 2 * (2 * B * N * be.E + be.E + 2 * B * N * be.D + (N * N if bias else 0))
    return bound(B * N * N * (4 * be.E + 2 * be.D), nbytes)


def check_bench_edges(dev) -> dict:
    """(a) ``bench_edges_torch``: the table at ``BENCH_EDGES_ITERS`` and the
    crossover at ``BENCH_CROSSOVER_NODES`` (1 iteration), K1's and the
    merge's launches equal to the calls the script makes, every dense row
    that ran out of memory marked so, every kernel row finite; then K1 on
    the same inputs against its plain version at ``BENCH_K1_PLAIN_CASES``
    and against ``chunked_plain_attention`` at ``BENCH_K1_CHUNKED_CASES``
    (launches outside the counted run)."""
    import bench_edges_torch as be
    from mtad_gat_tpu_torch.kernels.gat import (gat_fwd_plan, gatv2_attention_fwd,
                                                gatv2_attention_fwd_plain)
    from mtad_gat_tpu_torch.nn.gat import dense_route_nodes

    reset_counts()
    t0 = time.perf_counter()
    table = be.bench_tpu_table(be.TABLE_CASES, iters=BENCH_EDGES_ITERS, device=dev)
    cross = be.bench_crossover(iters=1, nodes=BENCH_CROSSOVER_NODES, device=dev)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    calls = lambda iters: be.WARMUP + be.PASSES * iters  # noqa: E731
    shapes = [(B, N, BENCH_EDGES_ITERS) for B, N in be.TABLE_CASES] + [
        (1, N, 1) for N in BENCH_CROSSOVER_NODES]
    want = {"gatv2_attention_fwd": sum(calls(i) for *_, i in shapes),
            "gatv2_attention_fwd:graph": 0, "gatv2_attention_fwd:tiled": 0}
    for B, N, i in shapes:
        want[f"gatv2_attention_fwd:{gat_fwd_plan(N, be.E, be.D)}"] += calls(i)
    want["gatv2_fwd_merge"] = want["gatv2_attention_fwd:tiled"]
    expect_counts("bench_scripts bench_edges", counts, want)
    for row in table + cross:
        if row["path"] == "pallas" and not (row["value"] and np.isfinite(row["value"])):
            raise AssertionError(f"bench_edges: a kernel row without a rate: {row}")
        if row["path"] == "dense" and row["value"] is None and row.get("oom") is not True:
            raise AssertionError(f"bench_edges: a dense row failed without oom: {row}")

    total = torch.cuda.get_device_properties(0).total_memory
    dense_rows = [r for r in table + cross if r["path"] == "dense"]
    first_oom = next(((r["batch"], r["n_nodes"]) for r in dense_rows if r.get("oom")), None)
    predicted = {f"B {B}": dense_route_nodes(B, be.E, 2, False, total)
                 for B in sorted({B for B, _ in be.TABLE_CASES})}
    by_case = {}
    for rows, with_bias in ((table, True), (cross, False)):
        for row in rows:
            B, N = row["batch"], row["n_nodes"]
            key = f"{'table' if with_bias else 'crossover'} B {B}, N {N}"
            rec = by_case.setdefault(key, {"B": B, "N": N, "bias": with_bias})
            if row["path"] == "pallas":
                ms = B * N * N / (row["value"] * 1e9) * 1e3
                bound_ms, bound_by = k1_e256_bound(B, N, with_bias)
                rec.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                           plan=gat_fwd_plan(N, be.E, be.D), peak_gib=row.get("peak_hbm_gib"))
            else:
                rec.update(dense_ms=None if row["value"] is None
                           else B * N * N / (row["value"] * 1e9) * 1e3,
                           dense_oom=bool(row.get("oom")), dense_peak_gib=row.get("peak_hbm_gib"))

    errs = {}
    with torch.no_grad():
        for B, N in BENCH_K1_PLAIN_CASES:
            args = be._inputs(B, N, be.E, be.D, torch.bfloat16, dev)
            got = gatv2_attention_fwd(*args, be.ALPHA).float()
            want_out = gatv2_attention_fwd_plain(*args, be.ALPHA).float()
            errs[f"B {B}, N {N}, bias, against the plain version"] = (
                got - want_out).abs().max().item()
            del args, got, want_out
            torch.cuda.empty_cache()
        for B, N, with_bias, blocks, rows in BENCH_K1_CHUNKED_CASES:
            p, q, a, bias, v = be._inputs(B, N, be.E, be.D, torch.bfloat16, dev, bias=with_bias)
            got = gatv2_attention_fwd(p, q, a, bias, v, be.ALPHA).float()
            err = 0.0
            for r0, r1 in blocks or ((0, N),):
                want_out, _ = chunked_plain_attention(
                    p[:, r0:r1], q, a, None if bias is None else bias[r0:r1], v, be.ALPHA, 0,
                    0.0, rows=rows)
                err = max(err, (got[:, r0:r1] - want_out).abs().max().item())
                del want_out
            what = "every row" if blocks is None else f"rows {list(blocks)}"
            errs[f"B {B}, N {N}, {'bias' if with_bias else 'no bias'}, {what}, against "
                 "chunked_plain_attention"] = err
            del p, q, a, bias, v, got
            torch.cuda.empty_cache()
    rec = {"phase": "bench_scripts", "script": "bench_edges_torch", "rows": table + cross,
           "seconds": seconds, "launches": counts, "expected_launches": want,
           "k1_by_case": by_case, "max_abs_err": errs, "tol": BENCH_K1_TOL,
           "dense_first_oom": first_oom,
           "dense_bytes_model_first_unfit_nodes": predicted,
           "card_total_memory": total}
    emit(rec)
    bad = {k: e for k, e in errs.items() if not e <= BENCH_K1_TOL}
    if bad:
        raise AssertionError(f"bench_edges: K1 off its plain version: {bad}")
    return rec


def check_bench_long(gen, dev) -> dict:
    """(b) ``bench_long_torch.bench_config`` at ``BENCH_LONG`` for
    ``BENCH_LONG_EPOCHS`` epoch: K3, K4's scan and its weights product
    twice a step each and nothing else launched; then, at (8, 8192, 150)
    with bfloat16 gi as the path gives it and with float32: K3 against its
    plain version, K4 (the scan and the weights product) on K3's states and
    a random cotangent against ``gru_scan_bwd_plain``, and the weights
    product alone (its operands float32 whatever gi's type, so once) against
    ``gru_weight_grads_plain`` (``check_k4_weights``)."""
    import bench_long_torch as bl
    from mtad_gat_tpu_torch.kernels.gru import (gru_scan_bwd, gru_scan_bwd_plain,
                                                gru_scan_fwd, gru_scan_fwd_plain)

    lookback, band, bs, batches = BENCH_LONG
    H = 150
    reset_counts()
    t0 = time.perf_counter()
    row = bl.bench_config(lookback, band, bs, batches, epochs=BENCH_LONG_EPOCHS, device=dev)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    steps = batches * (1 + BENCH_LONG_EPOCHS)
    want = {k: 2 * steps for k in ("gru_scan_fwd", "gru_scan_bwd", "gru_weight_grads")}
    expect_counts("bench_scripts bench_long", counts, want)
    if not (np.isfinite(row["value"]) and row["value"] > 0):
        raise AssertionError(f"bench_long: {row}")
    k3, k4, names = {}, {}, ("dgi", "dw_hh", "db_hh")
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).replace("torch.", "")
        _, _, gi, w_hh, b_hh = gru_case(gen, dev, bs, lookback, H, dtype)
        w_hh = w_hh.contiguous()
        with torch.no_grad():
            hseq, _ = gru_scan_fwd(gi, w_hh, b_hh, H)
            ms = time_ms(lambda: gru_scan_fwd(gi, w_hh, b_hh, H), 3, warmup=1)
            want_h, _ = gru_scan_fwd_plain(gi, w_hh, b_hh, H)
        read = bs * lookback * 3 * H * dtype.itemsize + (H * 3 * H + 3 * H) * 4
        bound_ms, bound_by = bound(2 * bs * lookback * H * 3 * H, read + bs * lookback * H * 4)
        k3[key] = {"max_abs_err": (hseq - want_h).abs().max().item(), "ms": ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, **gru_scan_fwd.last_launch}
        del want_h
        dhseq = torch.randn(bs, lookback, H, generator=gen).to(dev)
        got = gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H)
        plain = gru_scan_bwd_plain(gi, w_hh, b_hh, hseq, dhseq, H)
        torch.cuda.synchronize()
        scan_ms = time_ms(lambda: gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H,
                                               need_weights=False), 3, warmup=1)
        scan_bound_ms, scan_bound_by = bound(
            bs * lookback * (2 * 2 * H * 3 * H + 30 * H),
            read + 2 * bs * lookback * H * 4 + bs * lookback * 4 * H * 4)
        k4[key] = {"rel_err": {n: rel_err(a, b) for n, a, b in zip(names, got, plain)},
                   "abs_err": {n: (a - b).abs().max().item()
                               for n, a, b in zip(names, got, plain)},
                   "scan_ms": scan_ms, "scan_bound_ms": scan_bound_ms,
                   "scan_bound_by": scan_bound_by, **gru_scan_bwd.last_launch}
        del plain
        if dtype == torch.float32:
            # the product's operands are float32 whatever gi's type; raises
            # beyond K4_TOL
            weights = check_k4_weights(gi, w_hh, b_hh, hseq, got[0], H)
        del gi, hseq, dhseq, got
    rec = {"phase": "bench_scripts", "script": "bench_long_torch", "rows": [row],
           "seconds": seconds, "launches": counts, "expected_launches": want,
           "k3": {"B": bs, "T": lookback, "H": H, "by_dtype": k3, "tol": K3_TOL},
           "k4": {"B": bs, "T": lookback, "H": H, "by_dtype": k4, "tol": K4_TOL,
                  "weights": weights}}
    emit(rec)
    bad = {k: v["max_abs_err"] for k, v in k3.items() if not v["max_abs_err"] <= K3_TOL}
    bad.update({f"K4 {k} {n}": e for k, v in k4.items() for n, e in v["rel_err"].items()
                if not e <= K4_TOL})
    if bad:
        raise AssertionError(f"bench_long: K3 or K4 at ({bs}, {lookback}, {H}) off its plain "
                             f"version: {bad}")
    return rec


def check_bench_entities(dev) -> dict:
    """(c) ``bench_entities_torch.bench`` at ``BENCH_FLEET``: each solo epoch
    K3, K4's scan and weights twice a step and nothing else; each fleet
    epoch the same grouped, two a fleet step whatever E (``FleetProbe``,
    ``expect_fleet_epoch``: dense attention, dropout 0.3)."""
    import bench_entities_torch as ben

    reset_counts()
    t0 = time.perf_counter()
    with FleetProbe() as probe:
        rows = ben.bench(BENCH_FLEET["E"], batches_per_epoch=BENCH_FLEET["batches_per_epoch"],
                         epochs=BENCH_FLEET["epochs"], device=dev)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    for i, epoch in enumerate(probe.epochs):
        if epoch["kind"] == "fleet":
            expect_fleet_epoch(f"bench_entities fleet epoch {i}", epoch, dropout=0.3)
        else:
            steps = epoch["steps"]
            expect_counts(f"bench_entities solo epoch {i}", epoch["launches"],
                          {k: 2 * steps for k in ("gru_scan_fwd", "gru_scan_bwd",
                                                  "gru_weight_grads")})
    kinds = [e["kind"] for e in probe.epochs]
    want_kinds = (["solo"] * (1 + BENCH_FLEET["epochs"] * BENCH_FLEET["E"])
                  + ["fleet"] * (1 + BENCH_FLEET["epochs"]))
    if kinds != want_kinds or not all(np.isfinite(r["value"]) for r in rows):
        raise AssertionError(f"bench_entities: epochs {kinds}, rows {rows}")
    rec = {"phase": "bench_scripts", "script": "bench_entities_torch", "rows": rows,
           "seconds": seconds, "launches": counts,
           "fleet_steps": sum(e["steps"] for e in probe.epochs if e["kind"] == "fleet"),
           "solo_steps": sum(e["steps"] for e in probe.epochs if e["kind"] == "solo")}
    emit(rec)
    return rec


def trace_kernel_union(path: str) -> tuple:
    """The kernel events of a Chrome trace on their own: the microseconds in
    which at least one runs (sorted and merged intervals), and how many
    distinct correlation ids they carry."""
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel" and "dur" in e]
    union, end = 0.0, float("-inf")
    for ts, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        union += max(0.0, stop - max(ts, end))
        end = max(end, stop)
    return union, len({(e.get("args") or {}).get("correlation") for e in kernels})


def check_bench_attrib(dev, work) -> dict:
    """(d) ``bench_attrib_torch`` at ``BENCH_ATTRIB_STEPS`` steps: capture
    (its traced block's launches counted), then ``parse``: each of K3's and
    K4's kernels with as many events as its counter shows over the traced
    block, every one of them in ``gru scan body``; the modules' times
    summing within 1% to the device's busy time as ``trace_kernel_union``
    measures it apart from the parser; as many kernel events parsed as
    distinct correlation ids in the trace (none counted twice); and every
    module of ``BENCH_ATTRIB_MODULES`` given device time."""
    import bench_attrib_torch as ba
    from mtad_gat_tpu_torch.utils import profiling

    trace_dir = os.path.join(work, "bench_attrib")
    reset_counts()
    t0 = time.perf_counter()
    with counted_traces(profiling) as traces:
        steady = ba.capture(trace_dir, device=dev, nsteps=BENCH_ATTRIB_STEPS)
    (traced,) = traces
    counts = read_counts()
    parsed = ba.parse(trace_dir, BENCH_ATTRIB_STEPS)
    seconds = time.perf_counter() - t0
    union_us, correlations = trace_kernel_union(parsed["file"])
    by_kernel = parsed["module_events_by_kernel"]
    events = {c: sum(n for name, n in parsed["events_by_kernel"].items() if re.search(rx, name))
              for c, rx in BENCH_GRU_KERNELS.items()}
    gru_elsewhere = {name: mods for name, mods in by_kernel.items()
                     if any(re.search(rx, name) for rx in BENCH_GRU_KERNELS.values())
                     and set(mods) != {ba.GRU_SCAN}}
    launches = {c: traced["launches"].get(c, 0) for c in BENCH_GRU_KERNELS}
    module_us = sum(m["us"] for m in parsed["modules"].values())
    missing = [m for m in BENCH_ATTRIB_MODULES
               if not parsed["modules"].get(m, {}).get("us", 0) > 0]
    rec = {"phase": "bench_scripts", "script": "bench_attrib_torch", "steady": steady,
           "steps": BENCH_ATTRIB_STEPS, "seconds": seconds,
           "trace_seconds": traced["seconds"], "launches": counts,
           "kernel_events_by_counter": events, "launches_traced": launches,
           "gru_kernels_outside_gru_scan_body": gru_elsewhere,
           "modules_us": module_us, "busy_us": parsed["busy_us"],
           "kernel_union_us": union_us, "kernel_events": parsed["kernel_events"],
           "kernel_correlations": correlations,
           "parsed": {k: v for k, v in parsed.items()
                      if k not in ("events_by_kernel", "module_events_by_kernel", "lines")}}
    emit(rec)
    want = {k: 2 * BENCH_ATTRIB_STEPS for k in BENCH_GRU_KERNELS}
    if events != launches or launches != want or gru_elsewhere:
        raise AssertionError(f"bench_attrib: kernel events {events}, launches {launches}, "
                             f"expected {want}; GRU kernels outside the GRU scan body: "
                             f"{gru_elsewhere}")
    if not abs(module_us - union_us) <= 0.01 * union_us:
        raise AssertionError(f"bench_attrib: modules {module_us} us against busy "
                             f"{union_us} us")
    if parsed["kernel_events"] != correlations or missing or not parsed["module_ranges"]:
        raise AssertionError(f"bench_attrib: {parsed['kernel_events']} kernel events parsed "
                             f"of {correlations} correlation ids; no device time for {missing}")
    return rec


def check_bench_scripts(gen, dev, work) -> dict:
    """Phase bench_scripts: the four root bench scripts' H100 counterparts
    at the flagship widths and reduced depth, each its own counted run
    (``check_bench_edges``, ``check_bench_long``, ``check_bench_entities``,
    ``check_bench_attrib``); fails when the phase takes more than
    ``BENCH_SECONDS_LIMIT`` seconds. Returns the launches of the four runs and
    the records."""
    t0 = time.perf_counter()
    recs = {"edges": check_bench_edges(dev), "long": check_bench_long(gen, dev),
            "entities": check_bench_entities(dev), "attrib": check_bench_attrib(dev, work)}
    seconds = time.perf_counter() - t0
    launches = {k: sum(r["launches"].get(k, 0) for r in recs.values())
                for k in recs["edges"]["launches"]}
    emit({"phase": "bench_scripts", "seconds": seconds, "seconds_limit": BENCH_SECONDS_LIMIT,
          "within_limit": seconds <= BENCH_SECONDS_LIMIT,
          "seconds_by_script": {k: r["seconds"] for k, r in recs.items()}, "launches": launches})
    if not seconds <= BENCH_SECONDS_LIMIT:
        raise AssertionError(f"bench_scripts took {seconds} s, over {BENCH_SECONDS_LIMIT} s")
    return {"launches": launches, "seconds": seconds, **recs}


# ---------------------------------------------------------------------------
# Phase remat: both attention layers recomputed in the backward pass
# (remat_attention, nn/remat.py) on the solo and the fleet training paths
# ---------------------------------------------------------------------------

REMAT_STEPS = 4                  # a case's steps: one to warm up, then the timed ones
REMAT_RATE = 0.3
# (case, attention_impl, lookback, batch) of the solo cases
REMAT_SOLO = (("flagship, pallas", "pallas", 100, 256), ("flagship, dense", "dense", 100, 256),
              ("lookback 300, dense", "dense", 300, 64))
REMAT_FLEET_BS = FLEET_TRAIN_BS
# The dense fleet's batch 256 (ROADMAP item 2) with remat: the temporal
# layer's recompute alone holds 72.5 GB by the byte model, and the peak at
# batch 64 gave 0.298 GB a batch row, 77.3 GB at 256 on an 85.0 GB card
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6). The phase runs
# the largest multiple of 32 under REMAT_WITNESS_SHARE of the card by that
# slope, 224, for two steps, and fails rather than run a batch predicted
# over it.
REMAT_WITNESS_BS = 224
REMAT_WITNESS_SHARE = 0.85
REMAT_SECONDS_LIMIT = 60.0


def remat_digest(state: dict) -> dict:
    """A state's tensors on the host, by name."""
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def remat_solo(work, x_train, impl: str, lookback: int, bs: int, remat: bool) -> dict:
    """``REMAT_STEPS`` training steps of the flagship ``Trainer`` (train seed
    0, dropout 0.3, the GRU's kernels) at ``lookback`` and batch ``bs``, the
    attention ``impl``, with or without ``remat_attention``, from the first
    windows in order: each step's losses, the final parameters, each step's
    dropout generator's state after the step, the launches of all the
    steps (counted from 0), and over the steps after the first, windows/s and
    the peak memory (absolute and above the baseline before them)."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data.windows import batched_starts
    from mtad_gat_tpu_torch.training import Trainer

    cfg = RunConfig(attention_impl=impl, gru_impl="pallas", dropout=REMAT_RATE, epochs=1,
                    lookback=lookback, bs=bs, log_tensorboard=False)
    mc = dataclasses.replace(cfg.model_config(38, 38), remat_attention=remat)
    trainer = Trainer(mc, cfg.train_config(), device="cuda",
                      log_dir=os.path.join(work, f"logs_remat_{impl}_{lookback}_{int(remat)}"))
    trainer.init_state()
    series = trainer._series(x_train)
    starts, mask, _ = batched_starts(0, bs, indices=np.arange(REMAT_STEPS * bs))
    gens, step_generator = [], trainer.step_generator
    trainer.step_generator = lambda: gens.append(step_generator()) or gens[-1]
    reset_counts()
    first = trainer.train_epoch(series, starts[:1], mask[:1])      # ends in a device sync
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rest = trainer.train_epoch(series, starts[1:], mask[1:])
    seconds = time.perf_counter() - t0
    out = {"losses": np.concatenate([np.stack(first), np.stack(rest)], axis=1),
           "params": remat_digest(trainer.model.state_dict()),
           "generator_states": [g.get_state() for g in gens], "launches": read_counts(),
           "windows_per_s": float(mask[1:].sum()) / seconds,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_extra_bytes": torch.cuda.max_memory_allocated() - base}
    del trainer, series
    torch.cuda.empty_cache()
    return out


def remat_fleet_series(fleet_data: str):
    """Phase ``fleet_training``'s 28 machines (400-600 train rows,
    normalised) as ``MultiEntityTrainer.fit`` stacks them, and each one's
    windows in order."""
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.data.windows import num_windows

    series = [get_data(f"machine-{g}", data_root=fleet_data, normalize=True)[0][0]
              for g in FLEET_GROUPS]
    stacked = np.zeros((len(series), max(len(s) for s in series), 38), np.float32)
    for e, s in enumerate(series):
        stacked[e, :len(s)] = s
    return stacked, [np.arange(num_windows(len(s), 100)) for s in series]


def remat_fleet(fleet_data: str, remat: bool, bs: int, steps: int) -> dict:
    """The 28 machines' ``MultiEntityTrainer`` (seed 0, dropout 0.3, dense
    attention, the GRU's kernels, window 100) at batch ``bs``, with or
    without ``remat_attention``: ``steps`` fleet steps (one
    ``vmap(grad_and_value)`` step for all) over each machine's first windows
    in order; the stacked parameters, each step's losses, the launches and
    the keep-mask rule's calls of all the steps, and over the steps after
    the first, all-entity windows/s and the peak memory."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.graph import dropout as gdrop
    from mtad_gat_tpu_torch.training import MultiEntityTrainer

    cfg = RunConfig(attention_impl="dense", gru_impl="pallas", dropout=REMAT_RATE, epochs=1,
                    bs=bs, log_tensorboard=False)
    mc = dataclasses.replace(cfg.model_config(38, 38), remat_attention=remat)
    stacked, orders = remat_fleet_series(fleet_data)
    fleet = MultiEntityTrainer(mc, cfg.train_config(), device="cuda")
    fleet.init_states(len(orders))
    series = torch.from_numpy(stacked).cuda()
    starts, mask, real = fleet._schedule(orders)
    draws = gdrop._entity_keep_mask_vmap.calls
    reset_counts()
    first = fleet.train_epoch(series, starts[:1], mask[:1], real[:1])   # ends in a sync
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rest = fleet.train_epoch(series, starts[1:steps], mask[1:steps], real[1:steps])
    seconds = time.perf_counter() - t0
    out = {"params": remat_digest(fleet.params),
           "losses": np.concatenate([np.stack(first), np.stack(rest)], axis=1),
           "launches": read_counts(), "keep_mask_draws": gdrop._entity_keep_mask_vmap.calls - draws,
           "windows_per_s": float(mask[1:steps].sum()) / seconds,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_extra_bytes": torch.cuda.max_memory_allocated() - base}
    del fleet, series
    torch.cuda.empty_cache()
    return out


def remat_pair(name: str, off: dict, on: dict, want_off: dict, want_on: dict) -> dict:
    """One case's record: the runs without and with remat hold the same
    losses, parameters (and generator states, where given) bit for bit and
    their exact launches; their windows/s and peak memory side by side."""
    same = {"losses": np.array_equal(off["losses"], on["losses"], equal_nan=True),
            "params": all(torch.equal(v, on["params"][k]) for k, v in off["params"].items())}
    if "generator_states" in off:
        same["generator_states"] = all(torch.equal(a, b) for a, b in
                                       zip(off["generator_states"], on["generator_states"]))
    if "keep_mask_draws" in off:
        same["keep_mask_draws"] = off["keep_mask_draws"] == on["keep_mask_draws"]
    rec = {"phase": "remat", "case": name, "identical": same,
           **{f"{k}_{tag}": run[k] for tag, run in (("off", off), ("on", on))
              for k in ("windows_per_s", "peak_bytes", "peak_extra_bytes")},
           "launches_on": {k: v for k, v in on["launches"].items() if v},
           "launches_off": {k: v for k, v in off["launches"].items() if v}}
    rec["peak_on_over_off"] = rec["peak_bytes_on"] / rec["peak_bytes_off"]
    rec["windows_per_s_on_over_off"] = rec["windows_per_s_on"] / rec["windows_per_s_off"]
    emit(rec)
    if not all(same.values()):
        raise AssertionError(f"remat: {name}: the runs with and without remat differ: {same}")
    expect_counts(f"remat: {name}, without", off["launches"], want_off)
    expect_counts(f"remat: {name}, with", on["launches"], want_on)
    return rec


def remat_witness(fleet_data: str, at_64: dict, smi: str) -> dict:
    """The 28 machines' dense fleet with remat at ``REMAT_WITNESS_BS``, two
    steps: its peak memory against the slope of the batch-64 run
    (``at_64``: peak bytes above what the process held before it, a batch
    row), and that slope's peak at batch 256; it runs only where the slope
    puts the batch under ``REMAT_WITNESS_SHARE`` of the card."""
    total = torch.cuda.get_device_properties(0).total_memory
    base = torch.cuda.memory_allocated()
    per_row = (at_64["peak_bytes"] - base) / REMAT_FLEET_BS
    predicted = {bs: base + per_row * bs for bs in (REMAT_WITNESS_BS, 256)}
    if not predicted[REMAT_WITNESS_BS] <= REMAT_WITNESS_SHARE * total:
        raise AssertionError(f"remat witness: batch {REMAT_WITNESS_BS} predicted at "
                             f"{predicted[REMAT_WITNESS_BS]} bytes of {total}")
    run = remat_fleet(fleet_data, True, REMAT_WITNESS_BS, 2)
    rec = {"phase": "remat", "case": f"{len(FLEET_GROUPS)} machines, dense, batch "
           f"{REMAT_WITNESS_BS}, remat, 2 steps", "card": smi, "card_bytes": total,
           "peak_bytes": run["peak_bytes"], "predicted_peak_bytes": predicted[REMAT_WITNESS_BS],
           "predicted_peak_bytes_at_256": predicted[256], "bytes_a_batch_row": per_row,
           "windows_per_s": run["windows_per_s"],
           "launches": {k: v for k, v in run["launches"].items() if v},
           "losses_finite": bool(np.isfinite(run["losses"]).all())}
    emit(rec)
    if not rec["losses_finite"]:
        raise AssertionError(f"remat witness: losses {run['losses']}")
    expect_counts("remat witness", run["launches"],
                  {k: 4 for k in ("gru_scan_fwd", "gru_scan_bwd", "gru_weight_grads")})
    return {**rec, "launches": run["launches"]}


def check_remat(work, x_train, fleet_data: str, smi: str) -> dict:
    """Phase ``remat``: ``remat_attention`` against the same run without it,
    on the card, float32, dropout 0.3, cuDNN deterministic (as
    ``Trainer(mesh=)`` holds it), TF32 off: (a) the flagship through every
    kernel and with dense attention, ``REMAT_STEPS`` steps each from one
    seed: each step's losses, the final parameters and every step's
    generator state identical in bits, the launches exact (K1-res twice a
    layer a step with remat: the forward and the recompute, ``step_launches``);
    (b) windows/s and peak memory of each, and of lookback 300 with dense
    attention at batch 64 and the 28 machines' dense fleet at batch 64
    (``REMAT_STEPS`` fleet steps; parameters, losses and keep-mask draws
    identical in bits with and without remat); (c) that fleet with remat at
    ``REMAT_WITNESS_BS`` (``remat_witness``). The counts set to 0 before
    each run; the phase fails past ``REMAT_SECONDS_LIMIT`` seconds."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gru = lambda steps: {k: 2 * steps for k in ("gru_scan_fwd", "gru_scan_bwd",  # noqa: E731
                                                "gru_weight_grads")}
    recs, launches = {}, {}
    try:
        for name, impl, lookback, bs in REMAT_SOLO:
            runs = [remat_solo(work, x_train, impl, lookback, bs, r) for r in (False, True)]
            wants = [step_launches(REMAT_STEPS, 0, lookback, bs, "pallas", remat=r)
                     if impl == "pallas" else gru(REMAT_STEPS) for r in (False, True)]
            recs[name] = remat_pair(name, *runs, *wants)
            for run in runs:
                for k, v in run["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        runs = [remat_fleet(fleet_data, r, REMAT_FLEET_BS, REMAT_STEPS) for r in (False, True)]
        name = f"{len(FLEET_GROUPS)} machines, dense, batch {REMAT_FLEET_BS}"
        recs[name] = remat_pair(name, *runs, gru(REMAT_STEPS), gru(REMAT_STEPS))
        witness = remat_witness(fleet_data, runs[1], smi)
        for run in (*runs, witness):
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
        recs["witness"] = witness
    finally:
        torch.backends.cudnn.deterministic = deterministic
    seconds = time.perf_counter() - t0
    emit({"phase": "remat", "card": smi, "seconds": seconds,
          "seconds_limit": REMAT_SECONDS_LIMIT, "launches": launches,
          "card_bytes": torch.cuda.get_device_properties(0).total_memory})
    if not seconds <= REMAT_SECONDS_LIMIT:
        raise AssertionError(f"remat took {seconds} s, over {REMAT_SECONDS_LIMIT} s")
    return {"launches": launches, "seconds": seconds, "cases": recs}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    # one card: the first visible one, set before CUDA starts
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = "0" if visible is None else visible.split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures the GPU port on the card")
    if torch.cuda.device_count() != 1:
        sys.exit(f"chip_smoke: {torch.cuda.device_count()} devices visible, expected 1")
    from mtad_gat_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)

    smi = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    marks = [("start", time.perf_counter())]
    mark = lambda name: marks.append((name, time.perf_counter()))  # noqa: E731
    _build.build_all()
    mark("build")
    emit({"phase": "build", "seconds": marks[-1][1] - marks[-2][1],
          "ptxas": {n: ptxas_summary(_build.build_log(n)) for n in _build.SOURCES}})

    k1_err, k1_ms = check_k1(gen, dev)
    mark("k1")
    k3_err, k3, k3_batch1 = check_k3(gen, dev)
    mark("k3")
    train_err, train_rel, train_ms = check_training_kernels(gen, dev)
    mark("training_kernels")
    k4_err, k4_rel, k4 = check_k4(gen, dev)
    gru_crossover(gen, dev)
    mark("k4")
    with tempfile.TemporaryDirectory() as work:
        launches = check_main_path(gen, dev, work)
        data_root = os.path.join(work, "data")
        check_train_cli(work, data_root, "xla", epochs=1)
        train_launches = check_train_cli(work, data_root, "pallas", epochs=2)
        from mtad_gat_tpu_torch.data import get_data

        (x_train, _), _ = get_data("machine-1-1", data_root=data_root, normalize=True)
        check_kernel_vs_plain_training(work, x_train)
        training_throughput(work, x_train, "xla")
        training_throughput(work, x_train, "pallas")
        mark("main_path")
        check_reporting(work, data_root)
        mark("reporting")
        long_window = check_long_window(gen, dev, work)
        mark("long_window")
        graph_cli = check_graph_cli(work, data_root)
        mark("graph_cli")
        wide = check_wide_window(work, gen, dev)
        mark("wide_window")
        route = check_dense_route(gen, dev)
        mark("dense_route")
        long_complete = check_long_complete(work, dev, smi)
        mark("long_complete")
        serving = check_serving(gen, dev, work, k3_batch1, smi)
        mark("serving")
        fleet = check_fleet_serving(gen, dev, work, smi)
        mark("fleet_serving")
        fleet_train = check_fleet_training(gen, dev, work, smi)
        mark("fleet_training")
        fleet_root = os.path.join(work, "fleet_training")
        fleet_wide = check_fleet_wide_window(gen, dev, os.path.join(fleet_root, "data"),
                                             os.path.join(fleet_root, "output"), smi)
        mark("fleet_wide_window")
        fleet_features = check_fleet_wide_features(gen, dev, work, smi)
        mark("fleet_wide_features")
        multi = check_multi_device(gen, work, data_root, os.path.join(fleet_root, "data"),
                                   fleet_train["kernel_sweeps"][FLEET_TRAIN_BS], smi)
        mark("multi_device")
        bench = check_bench_scripts(gen, dev, work)
        mark("bench_scripts")
        remat = check_remat(work, x_train, os.path.join(fleet_root, "data"), smi)
        mark("remat")
    emit({"phase": "seconds", "by_phase": {name: t - marks[i][1]
                                           for i, (name, t) in enumerate(marks[1:])},
          "total_after_start": marks[-1][1] - marks[0][1]})
    by_path = {name: {"main": train_launches.get(name, 0),
                      "dense_route": route["launches_eval"][name] + route["launches_train"][name],
                      "long_window": long_window["launches"][name],
                      "graph_cli": graph_cli[name],
                      "wide_window": wide["train_cli"][name] + wide["layer"][name],
                      "long_complete": long_complete["launches"][name],
                      "serving": serving["launches"][name],
                      "fleet_serving": fleet["launches"][name],
                      "fleet_training": fleet_train["launches"][name],
                      "fleet_wide_window": fleet_wide["launches"][name],
                      "fleet_wide_features": fleet_features["launches"][name],
                      "multi_device": multi["launches"].get(name, 0),
                      "multi_device_halo": multi["halo_launches"].get(name, 0),
                      "multi_device_fleet": multi["fleet_launches"].get(name, 0),
                      "bench_scripts": bench["launches"].get(name, 0),
                      "remat": remat["launches"].get(name, 0)}
               for name in KERNEL_COUNTERS}
    by_path["gatv2_attention_fwd"]["main"] = launches["k1"]
    by_path["gru_scan_fwd"]["main"] = launches["k3"]

    f, t = k1_ms["feature"], k1_ms["temporal"]
    w = k4["weights"]
    kernels = [
        {"name": "gatv2_attention_fwd", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gat_fwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gat_pallas.py:150",
         "launches": launches["k1"], "max_abs_err": k1_err[torch.float32],
         "max_abs_err_bf16": k1_err[torch.bfloat16],
         "ms": f["ms"] + t["ms"], "ms_by_layer": [f["ms"], t["ms"]],
         "graph_ms": f["graph_ms"] + t["graph_ms"],
         "graph_ms_by_layer": [f["graph_ms"], t["graph_ms"]],
         "plain_ms": f["plain_ms"] + t["plain_ms"], "bound_ms": f["bound_ms"] + t["bound_ms"],
         "bound_by": f["bound_by"] if f["bound_ms"] >= t["bound_ms"] else t["bound_by"],
         "library_ms": None, "variant": "graph (kernels/gat.gat_fwd_plan), one block a "
                                       "graph at both layers",
         "tiled_ms_by_layer": [f["tiled_ms"], t["tiled_ms"]],
         "tiled_graph_ms_by_layer": [f["tiled_graph_ms"], t["tiled_graph_ms"]],
         "temporal_two_row_blocks_graph_ms": t.get("two_row_blocks_graph_ms"),
         "launches_training": train_launches["gatv2_attention_fwd"],
         "serving": {
             "launches": serving["launches"]["gatv2_attention_fwd"],
             "launches_per_forward": 2, "forwards": "one a point at chunk 1, one a chunk",
             "batch1_max_abs_err": max(r["max_abs_err"] for r in serving["k1"].values()),
             **{f"batch1_{k}_by_layer": [serving["k1"][la][k] for la in ("feature", "temporal")]
                for k in ("graph_ms", "plain_ms", "bound_ms", "bound_by")}},
         "fleet_serving": fleet_row(fleet, "k1"),
         "bench_edges": {k: bench["edges"][k] for k in (
             "k1_by_case", "max_abs_err", "tol", "dense_first_oom")},
         "shapes": "one scoring batch: feature (256,38,200/100) + temporal "
                   "(256,100,76/38) layer, float32, bias; ms is a wrapper call by CUDA "
                   "events, graph_ms its device time from a CUDA graph of 20 calls; tiled_* "
                   "the tiled kernel forced on the same inputs"},
        {"name": "gru_scan_fwd", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gru_fwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gru_pallas.py:52",
         "launches": launches["k3"], "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "projection_ms": k3["projection_ms"], "variant": k3["variant"],
         "cluster": k3["cluster"], "smem_bytes": k3["smem_bytes"],
         "launches_training": train_launches["gru_scan_fwd"],
         "serving": {
             "launches": serving["launches"]["gru_scan_fwd"],
             "launches_per_forward": 2, "forwards": "one a point at chunk 1, one a chunk",
             **{f"batch1_{k}": serving["k3"][k] for k in ("ms", "bound_ms", "bound_by",
                                                          "max_abs_err")}},
         "fleet_serving": fleet_row(fleet, "k3"),
         "fleet_training": fleet_training_row(fleet_train, "gru_scan_fwd"),
         "bench_long": bench["long"]["k3"],
         "shapes": "one chain: gi (256,100,450) float32, hidden 150; library_ms "
                   "is torch.nn.GRU (cuDNN) with its input projection, projection_ms "
                   "that projection alone as one matrix product"},
        {"name": "gru_scan_bwd", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gru_bwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gru_pallas.py:74",
         "launches": train_launches["gru_scan_bwd"], "max_abs_err": k4_err,
         "max_rel_err": k4_rel,
         "ms": k4["scan_ms"], "graph_ms": k4["scan_graph_ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["scan_bound_ms"],
         "bound_by": k4["scan_bound_by"], "library_ms": None,
         "k4_ms": k4["ms"], "k4_graph_ms": k4["graph_ms"], "k4_bound_ms": k4["bound_ms"],
         "cudnn_gru_backward_ms": k4["library_ms"],
         "variant": k4["variant"], "cluster": k4["cluster"], "smem_bytes": k4["smem_bytes"],
         "fleet_training": fleet_training_row(fleet_train, "gru_scan_bwd"),
         "bench_long": {k: v for k, v in bench["long"]["k4"].items() if k != "weights"},
         "shapes": "one chain: gi (256,100,450), hseq and dhseq (256,100,150) float32; "
                   "ms and graph_ms are the serial scan alone (need_weights off), k4_* the "
                   "whole call with the weights product; plain_ms is the whole plain "
                   "backward; cudnn_gru_backward_ms the backward of torch.nn.GRU with its "
                   "input projection's gradients"},
        {"name": "gru_weight_grads", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gru_bwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gru_pallas.py:127",
         "launches": train_launches["gru_weight_grads"],
         "max_abs_err": max(w["abs_err"].values()), "max_rel_err": max(w["rel_err"].values()),
         "ms": w["ms"], "graph_ms": w["graph_ms"], "plain_ms": w["plain_ms"],
         "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
         "library_ms": w["library_ms"], "library_graph_ms": w["library_graph_ms"],
         "fleet_training": fleet_training_row(fleet_train, "gru_weight_grads"),
         "bench_long": {f: bench["long"]["k4"]["weights"][f] for f in (
             "B", "T", "rel_err", "abs_err", "tol", "ms", "graph_ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by")},
         "shapes": "dW_hh (150,450) and db_hh over the 25,600 rows of one chain, float32; "
                   "library_ms is torch.mm(hprev.T, dgh) with dgh.sum(0) on prepared "
                   "operands, TF32 off"},
    ]
    for key, name, source, line in (
        ("k1res", "gatv2_attention_res", "gat_fwd.cu", 220),
        ("k2a", "gatv2_bwd_dp_da", "gat_bwd.cu", 454),
        ("k2b", "gatv2_bwd_dq_dv", "gat_bwd.cu", 497),
        ("k2ab", "gatv2_bwd_graph", "gat_bwd.cu", 454),
        ("k2c", "gatv2_bwd_dbias", "gat_bwd.cu", 540),
    ):
        f, t = train_ms[key]["feature"], train_ms[key]["temporal"]
        row = {
            "name": name, "route": "cuda", "source": f"mtad_gat_tpu_torch/csrc/{source}",
            "replaces": f"mtad_gat_tpu/kernels/gat_pallas.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": train_err[key],
            "max_rel_err": None if key == "k1res" else train_rel[key],
            "ms": f["ms"] + t["ms"], "ms_by_layer": [f["ms"], t["ms"]],
            "graph_ms": f["graph_ms"] + t["graph_ms"],
            "graph_ms_by_layer": [f["graph_ms"], t["graph_ms"]],
            "plain_ms": f["plain_ms"] + t["plain_ms"],
            "bound_ms": f["bound_ms"] + t["bound_ms"],
            "bound_by": f["bound_by"] if f["bound_ms"] >= t["bound_ms"] else t["bound_by"],
            "library_ms": None,
            "shapes": "one training step's two layers: feature (256,38,200/100) + "
                      "temporal (256,100,76/38), float32, dropout 0.3, bias; ms is a wrapper "
                      "call by CUDA events, graph_ms its device time from a CUDA graph "
                      "of 20 calls; plain_ms "
                      + ("is the plain forward" if key == "k1res" else
                         "is one autograd call for the whole attention backward"),
        }
        if key in ("k1res", "k2ab"):
            row["fleet_training"] = fleet_attention_row(fleet_train, key)
        if key in ("k1res", "k2a", "k2b"):
            row["fleet_wide_window"] = fleet_wide_row(fleet_wide, key)
        if key == "k2c":
            row["fleet_wide_window"] = ("dbias an entity's from the grouped tiled K2b and the "
                                        "grouped streamed backward, in their own passes; "
                                        "their rows hold the times")
        if key == "k1res":
            row.update(variant="graph (kernels/gat.gat_fwd_plan), one block a graph at both "
                               "layers",
                       tiled_ms_by_layer=[f["tiled_ms"], t["tiled_ms"]],
                       tiled_graph_ms_by_layer=[f["tiled_graph_ms"], t["tiled_graph_ms"]])
        elif key == "k2ab":
            by_layer = lambda k: [f[k], t[k]]  # noqa: E731
            row.update(also_replaces=["mtad_gat_tpu/kernels/gat_pallas.py:497",
                                      "mtad_gat_tpu/kernels/gat_pallas.py:540"],
                       launches_with_dbias=train_launches["gatv2_bwd_graph:dbias"],
                       bound_with_partials_ms_by_layer=by_layer("bound_with_partials_ms"),
                       dbias_group_by_layer=by_layer("dbias_group"),
                       partial_bytes_by_layer=by_layer("partial_bytes"),
                       occupancy_by_layer=by_layer("occupancy"),
                       **{f"{k}_by_layer": by_layer(k)
                          for k in ("no_dbias_ms", "no_dbias_graph_ms", "partial_sum_ms",
                                    "partial_sum_graph_ms", "with_k2c_ms", "with_k2c_graph_ms",
                                    "tiled_k2a_k2b_ms", "tiled_k2a_k2b_graph_ms")},
                       variant="whole graph per block at both flagship layers "
                               "(kernels/gat.gat_bwd_plan), dbias summed in the same launch "
                               "over groups of dbias_groups batch elements; ms and graph_ms "
                               "include the sum of its partials")
        elif key == "k2c":
            row["variant"] = ("the standalone tiled K2c, on no path: dbias comes from K2ab "
                              "(gatv2_bwd_graph with dbias) where the graph fits a block and "
                              "from the tiled K2b (gatv2_bwd_dq_dv with dbias) above; forced "
                              "at each flagship layer and phase 6's tiled cases, where its "
                              "errors and times come from, as the yardstick of the fold")
            row["dbias_from"] = {"graph": "k2ab", "tiled": "k2b"}
        elif key in ("k2a", "k2b"):
            row["variant"] = ("tiled, for graphs K2ab cannot hold (phase 6: N = 2048 and "
                              "4096, and once forced at each flagship layer; the dense "
                              "route's N; long_complete's temporal layer): 64 x 64 score "
                              "tiles of 4 x 4 register micro-tiles, the streamed loop cut "
                              "into slices of their own blocks "
                              "(kernels/gat.gat_tiled_bwd_plan), float32 partials summed in "
                              "slice order by a reduce kernel; not on the main path at "
                              "flagship widths")
            if key == "k2b":
                db = train_ms["k2b_dbias"]
                fd, td = db["feature"], db["temporal"]
                row["variant"] += ("; with dbias it sums K2c's dbias in the same pass, each "
                                   "block over tiled_dbias_groups batch elements")
                row.update(
                    launches_with_dbias=route["launches_train"]["gatv2_bwd_dq_dv:dbias"],
                    dbias_ms_by_layer=[fd["ms"], td["ms"]],
                    dbias_graph_ms_by_layer=[fd["graph_ms"], td["graph_ms"]],
                    dbias_bound_ms_by_layer=[fd["bound_ms"], td["bound_ms"]],
                    k2b_then_k2c_graph_ms_by_layer=[fd["k2b_k2c_graph_ms"],
                                                    td["k2b_k2c_graph_ms"]],
                    dbias_plan_by_layer=[fd["plan"], td["plan"]],
                    lookback_1024_by_group=train_ms["k2b_groups"])
        kernels.append(row)
    route_rows = {"gatv2_attention_fwd": "k1", "gatv2_attention_res": "k1res",
                  "gatv2_bwd_dp_da": "k2a", "gatv2_bwd_dq_dv": "k2b", "gatv2_bwd_dbias": "k2c"}
    for row in kernels:
        row["launches_by_path"] = by_path[row["name"]]
        if row["name"] in ("gatv2_bwd_dp_da", "gatv2_bwd_dq_dv"):
            # not on the main path at flagship widths: their path is the route
            row["launches"] = by_path[row["name"]]["dense_route"]
            row["launches_path"] = "dense_route"
        if row["name"] == "gatv2_bwd_dbias":
            row["launches"] = sum(by_path[row["name"]].values())
            row["launches_path"] = "none: K2ab and K2b give dbias in their own pass"
        if row["name"] in route_rows:
            t = route["times"][route_rows[row["name"]]]
            row.update(route_N=route["N"], route_graph_ms=t["graph_ms"],
                       route_bound_ms=t["bound_ms"], route_bound_by=t["bound_by"])
            if "plan" in t:
                row["route_plan"] = t["plan"]
        if row["name"] == "gatv2_bwd_dq_dv":
            rt = route["times"]
            row.update({f"route_{k}_{f}": rt[k][f] for k in ("k2b_dbias", "k2b_k2c", "bwd",
                                                              "bwd_k2c")
                        for f in ("graph_ms", "bound_ms")},
                       route_training_call_seconds=route["route"]["train_seconds"])
    merge = k1_ms["merge"]
    kernels.append({
        "name": "gatv2_fwd_merge", "route": "cuda", "source": "mtad_gat_tpu_torch/csrc/gat_fwd.cu",
        "replaces": "mtad_gat_tpu/kernels/gat_pallas.py:215",
        "launches": by_path["gatv2_fwd_merge"]["dense_route"], "launches_path": "dense_route",
        "launches_by_path": by_path["gatv2_fwd_merge"],
        "max_abs_err": max(merge["max_abs_err"].values()), "ms": merge["graph_ms"],
        "graph_ms": merge["graph_ms"], "plain_ms": merge["plain_ms"],
        "bound_ms": merge["bound_ms"], "bound_by": merge["bound_by"], "library_ms": None,
        "variant": "the tiled K1 and K1-res's merge of their slices' (m, l, aggregate) "
                   "partials, slices in order; one launch a tiled forward call",
        "shapes": f"the route's partials: {merge['slices']} slices, batch 1, N {merge['N']}, "
                  f"D {merge['D']}, float32; ms is its device time from a CUDA graph"})
    for key, name, line in (("k2a", "gatv2_bwd_dp_da", 454), ("k2b", "gatv2_bwd_dq_dv", 497),
                            ("k2c_chunked", "gatv2_bwd_dbias", 540)):
        w3, w12 = train_ms["wide"]["window 300"], train_ms["wide"]["window 1200"]
        w10 = train_ms["wide"]["window 1024"]
        variant = f"{name}:chunked"
        err = (lambda t: t["k2c_chunked_abs_err"]) if key == "k2c_chunked" else (
            lambda t: max(t["grad_abs_err"][g] for g in (("dp", "da") if key == "k2a"
                                                         else ("dq", "dv", "dbias"))))
        extra = {"launches_long_complete": long_complete["launches"][variant],
                 "long_complete_feature_layer": {
                     "B": w10["B"], "N": w10["N"], "E": w10["E"], "D": w10["D"],
                     "max_abs_err": err(w10), "graph_ms": w10[key]["graph_ms"],
                     "bound_ms": w10[key]["bound_ms"], "bound_by": w10[key]["bound_by"],
                     **({"dbias_graph_ms": w10["k2b_dbias"]["graph_ms"],
                         "dbias_bound_ms": w10["k2b_dbias"]["bound_ms"]}
                        if key == "k2b" else {})}}
        if key == "k2b":
            extra["dbias_graph_ms_by_window"] = [w3["k2b_dbias"]["graph_ms"],
                                                 w12["k2b_dbias"]["graph_ms"]]
            extra["dbias_bound_ms_by_window"] = [w3["k2b_dbias"]["bound_ms"],
                                                 w12["k2b_dbias"]["bound_ms"]]
        if key != "k2c_chunked":
            extra["fleet_wide_features"] = fleet_features_row(fleet_features, key)
            extra["launches_wide_window"] = wide_counts(wide, variant)
        kernels.append({**extra,
            "name": f"{name}_chunked", "route": "cuda",
            "source": "mtad_gat_tpu_torch/csrc/gat_bwd.cu",
            "replaces": f"mtad_gat_tpu/kernels/gat_pallas.py:{line}",
            "launches": (wide_counts(wide, variant) if key == "k2c_chunked"
                         else extra["fleet_wide_features"]["launches"]),
            "launches_path": ("wide_window; none since the streamed backward replaced the "
                              "CHUNKED tile at N <= NMAX (kernels/gat.gat_bwd_route), forced in "
                              "phase 6 as its yardstick" if key == "k2c_chunked" else
                              "fleet_wide_features path (a): the grouped CHUNKED tile at the "
                              "feature layer of 65 features, one a fleet step; also forced in "
                              "phase 6 and wide_window as the streamed backward's yardstick"),
            "max_abs_err": max(err(w3), err(w10), err(w12)),
            "ms": w3[key]["graph_ms"], "graph_ms_by_window": [w3[key]["graph_ms"],
                                                              w12[key]["graph_ms"]],
            "plain_ms": w3["plain_bwd_ms"], "bound_ms": w3[key]["bound_ms"],
            "bound_by": w3[key]["bound_by"],
            "bound_ms_by_window": [w3[key]["bound_ms"], w12[key]["bound_ms"]],
            "library_ms": None,
            "variant": ("K2c's chunked staging, E and D 64 floats at a time, where its whole "
                        "rows do not fit a block (kernels/gat.dbias_chunk)" if key == "k2c_chunked"
                        else "the CHUNKED tile (16 x 32, one warp, E and D streamed in chunks "
                             "of 64), beyond the widths the FAST and WIDE tiles take "
                             "(kernels/gat.gat_tiled_bwd_plan); gatv2_bwd runs it only above "
                             "the streamed backward's NMAX nodes, so here it is forced through "
                             "its wrapper"),
            "shapes": f"the feature layer at window 300 (b {w3['B']}, N 38, E 600, D 300) and "
                      f"1200 (b {w12['B']}, N 38, E 2400, D 1200), float32, dropout 0.3, bias; "
                      "ms and graph_ms from a CUDA graph; plain_ms one autograd call for the "
                      "whole attention backward at window 300"})
    wide_ms = [train_ms["wide"][k] for k in ("window 300", "window 1024", "window 1200")]
    by_window = lambda key, field: [t[key][field] for t in wide_ms]  # noqa: E731
    w10 = wide_ms[1]
    kernels.append({
        "name": "gatv2_bwd_streamed", "route": "cuda",
        "source": "mtad_gat_tpu_torch/csrc/gat_streamed.cu",
        "replaces": "mtad_gat_tpu/kernels/gat_pallas.py:454",
        "also_replaces": ["mtad_gat_tpu/kernels/gat_pallas.py:497",
                          "mtad_gat_tpu/kernels/gat_pallas.py:540"],
        "launches": long_complete["launches"]["gatv2_bwd_streamed"],
        "launches_path": "long_complete", "launches_by_path": by_path["gatv2_bwd_streamed"],
        "launches_with_dbias": long_complete["launches"]["gatv2_bwd_streamed:dbias"],
        "max_abs_err": train_err["streamed"], "max_rel_err": train_rel["streamed"],
        "ms": w10["streamed"]["graph_ms"], "plain_ms": w10["plain_bwd_ms"],
        "bound_ms": w10["streamed"]["bound_ms"], "bound_by": w10["streamed"]["bound_by"],
        "library_ms": None,
        "graph_ms_by_window": by_window("streamed", "graph_ms"),
        "bound_ms_by_window": by_window("streamed", "bound_ms"),
        "no_dbias_graph_ms_by_window": by_window("streamed_no_dbias", "graph_ms"),
        "chunked_pair_graph_ms_by_window": by_window("chunked_pair", "graph_ms"),
        "plain_ms_by_window": [t["plain_bwd_ms"] for t in wide_ms],
        "layout_by_window": [t["streamed"]["layout"] for t in wide_ms],
        "variant": "the streamed backward (kernels/gat.gat_bwd_route \"streamed\": where the tiled "
                   "plan names the CHUNKED tile and N <= NMAX): a score pass over (batch element, "
                   "row tile) blocks writing ds and wa, then a contraction pass over (batch "
                   "element, 128 columns of E or D) blocks writing dp, dq, dv and da rows, and "
                   "dbias summed over the batch in order; K2a, K2b and K2c's functions in one "
                   "call",
        "fleet_wide_window": fleet_wide_row(fleet_wide, "streamed"),
        "shapes": "the feature layer at windows 300 (b 64, N 38, E 600, D 300), 1024 (b 64, E "
                  "2048, D 1024: long_complete's, ms and plain_ms) and 1200 (b 8, E 2400, D "
                  "1200), float32, dropout 0.3, bias; times from a CUDA graph of 5 calls; "
                  "chunked_pair is the CHUNKED K2a then K2b with dbias on the same inputs"})
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
