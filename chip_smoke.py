"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line):

1. card and build: the card's name and power limit, the torch/CUDA
   versions, the build of the native data plane (`g++`; without it the
   run fails), and the build of every CUDA kernel from csrc/ (sixteen)
   with `-Xptxas -v`: registers, spills and added wgmma waits of the
   tensor-core entry functions of K1, K2, K5a, K6 (with pass 1 of K1's
   and K6's cut) and the tensor-core pass 1 of the 256-lane body (and of
   K2 and K5a at f = 256), registers and spills of pass 2 of K1's and
   K6's cut, of the other 256-lane entry functions and of the batched
   CGs K3, K4 and K5b (the ring body and the f = 256 body), and of the
   two kernels of f >= 384 (`tile_gram`: no spill and no added wgmma
   wait on its two tensor-core bodies, the cluster body of f = 384 and
   512 and the one-block-a-tile body above; `global_cg`);
2. each kernel against its plain PyTorch version on the card, on real
   chunks of the Netflix-shaped plans, with kernel, plain, yardstick and
   bound times: the widest, the most populous (also on a float32 table,
   the FMA body) and the fewest-row theta-phase chunk for K1 and K6
   (device time, `queued_ms`), and,
   among the chunks their cut takes (`cs.theta_spans`: fewer rows than
   the blocks that fit the card, 264, each row's slots cut into spans
   across blocks, then pass 2, `frag_span_solve`), the fewest-row one
   and the one with the most slots, three ways (as routed against the
   plain version, twice with the same bits, and against spans=1 with
   both times), pass 2 alone on the fewest-row one's records against
   its plain version, small chunks whose rows stop at the edges of the
   64-slot tile, and their time over the whole theta phase, as routed
   and uncut, split by chunks under and over 264 rows; for K2 and K5a
   the most populous, the widest and, among the
   chunks their cut takes (`cs.gram_spans`: fewer rows than the blocks
   that fit the card, each row's slots cut into spans across blocks,
   then pass 2, `gram_span_sum`), the fewest-row X-phase panel chunk and
   one of about 40 rows (the most populous with a bf16 and an f32 A; the
   two of few rows three ways: as routed against the plain version,
   twice with the same bits, and against spans=1 with both times); the
   most populous, the widest and the fewest-row one (three ways) also on
   a float32 table, which takes the split-bf16 body (`cs.panel_body`
   "split"), with an f32 and a bf16 A, on a float32 copy of the bf16
   panel and on the panel of the float32 initial factors (full
   mantissas); pass 2 alone on the fewest-row chunk's
   partials (bit for bit against its plain version), small chunks at
   the edges of their 64-slot tile (integer
   tables: bit for bit, the proof of the tile layout), and their time
   over the whole X phase, as routed and uncut, split by chunks under
   and over the blocks that fit the card (264 at f = 128); one
   full solve slice of the X-phase accumulators for K3 (split, bf16, at
   cg_iters 0 and 6, and the same slice widened to float32), K5b
   (augmented, f32) and K4 (the same slice unpacked and regularized
   beforehand, through `ops.solve.solve` without a diagonal);
3. small Netflix-shaped runs (scale 0.01, lowered panel_size so both
   routes engage) on the card against the same runs on the CPU: bf16
   accumulators, f32 with aug_gram="auto", f32 with aug_gram="force";
4. two paths at full width, `ALS.run` for 3 iterations each on the
   Netflix workload at scale 1.0 (~99M ratings, F=100, bf16 factors,
   backend "pallas", CG), X phase on the panel route and theta on the
   direct route, every kernel's launch count read around each run alone,
   train RMSE after the third iteration held to the recorded trajectory
   (within 1e-3) and test RMSE falling:
   a. bf16 Gram accumulators: split buffers, kernels K1, K2, K3;
   b. f32 accumulators with aug_gram="force": the augmented-lane forms,
      kernels K5a, K5b, K6;
   c. the `ALSConfig` default, float32 factors and f32 accumulators with
      aug_gram="auto", on (b)'s plans, 2 iterations: the panel-aug X
      route on the float32 table, K5a on the split body (and
      `gram_span_sum` on the chunks its cut takes, as many as the plans
      say), K5b, and K1 on the float32 table of direct theta (the uncut
      FMA body); no K2, K6, wide or tiled kernel; train RMSE within 2e-3
      of (b)'s at each iteration, test RMSE falling; K5a's device time
      over the X phase's chunks on the float32 initial factors, as routed
      and uncut (spans=1);
   and K4's path, the public dispatcher `ops.solve.solve` without a
   diagonal, over every solve slice of the X-phase accumulators, held
   against the augmented solve of the same systems;
5. the factor widths above 128, on the same data at F=200 (f_pad 256,
   f2 = 96), X phase on the split route (4 table parts of 131,072 rows)
   and theta on the direct route. K7 and K1 at f=256 on a bf16 table
   run as two passes on every chunk, pass 1 on the tensor cores
   (`wide_span_gram_mma`) and pass 2 (`wide_span_solve`), one span a
   row on a chunk of as many rows as the card has SMs and the row cut
   below that; a float32 table keeps the FMA body (the uncut kernels,
   or the cut with `wide_span_gram`):
   a. K7 and K1 at f=256 as routed against their plain versions on the
      widest and the most populous theta chunk and the most populous
      split X chunk, and their uncut FMA kernels on a float32 copy of
      the table; K8 against its plain version, on a bf16 G (the two
      passes) equal to K1 at f=256 as routed on the bf16 table and on a
      float32 G (the FMA kernel) against K1's uncut kernel on a float32
      copy of the table; the tensor-core pass 1 bit for bit on integer
      tables; the cut on the split X chunk with the fewest
      rows, one of about 32 rows and the widest theta chunk, against the
      plain cut route and one span a row; each pass alone (pass 1
      through the record layout) on the chunk of about 32 rows (bf16
      and float32 tables) and the most populous theta chunk; the
      span-edge grid; both kernels' time over both phases, as routed
      and with one span a row, split by chunks under and over the SM
      count; the FMA body's earlier times printed beside;
   b. small runs (scale 0.01, F=130, forced split X route with 3 parts)
      on the card against the CPU: bf16 wide_kernel on (the two passes
      alone), float32 wide_kernel on and off (the FMA kernels);
   c. `ALS.run` for 3 iterations with wide_kernel="on", then 2
      iterations with wide_kernel="off": every chunk runs the two
      passes (pass 1 on the tensor cores) and no other 256-lane kernel;
   d. K8's path: `fused_gram_cg_cat` over every theta chunk on a G
      gathered with torch from the bf16 table (the two passes, pass 1 on
      the tensor cores reading the two slabs), each equal bit for bit to
      K1 at f=256 as routed on that table, and one chunk on a float32 G
      (the FMA kernel) against K1's uncut kernel on a float32 copy;
   e. K6 at f=256 (aug_gram="force", wide_kernel "off", on the same
      plans: X split, theta direct): K6 against its plain version on the
      most populous theta chunk (the two passes, pass 1 on the tensor
      cores with the values over lane 255), on the split X chunk with the
      fewest rows (the cut, S > 1) with the bf16 table and a float32 copy
      (the cut on the FMA body), and on the most populous theta chunk of
      a float32 table (K6's uncut kernel), x within 2e-3, se within 1e-3
      relative, lane 255 of x exactly 0, a repeat equal bit for bit; each
      pass alone on the populous chunk (tensor cores), the float32 split
      chunk (FMA body) and the populous chunk of the float32 table (the
      cut at S = 1 on the FMA body, timed beside the uncut kernel), pass
      1's A' through the record layout within `gram_limit`, pass 2 on
      those records; then
      `ALS.run` for 2 iterations, its two passes launched at least once
      a chunk and no other fused kernel, train RMSE within 1e-3 of (c)'s
      wide-off run at every iteration and test RMSE falling. Its numbers
      go into the `kernels` line as K6's `f256`, and the passes' launches
      in that run as its `f256_launches` (K6 at 256 lanes counts no
      launch of its own, as K1 there);
6. the batched-panel route at full width on the same data, F=100, bf16
   factors, backend "pallas", Cholesky, `panel_budget_bytes` 2^29 and
   `batch_rows` 4096: the X accumulators (1.16 GB) pass the budget, so X
   runs in 5 row batches through K2 (theta stays direct, in plain torch:
   Cholesky reaches no fused kernel); with f32 and then bf16
   accumulators, each against the panel route on the same settings with
   the default budget: one X phase on iteration 0's theta row by row
   (every batch's Gram accumulators entry by entry within their rounding
   bound, every rated row written, f32 x per row within 1e-5), then 3
   iterations (train RMSE within 1e-3, test RMSE within 2e-3 at every
   iteration; with bf16, or within the distance between the panel
   route's bf16 and f32 runs where that is larger), K2 launched every
   iteration and no K1, K3, K5a;
7. the port's bench, `python -m cumf_als_tpu_torch.bench`, in a
   subprocess on the cached data set: `--workload netflix --iters 3
   --repeat 3` (the root bench's keys, the card's name, the main path's
   train RMSE within 1e-3);
8. the bench's accuracy contracts: `--workload netflix_cal --scale 0.25
   --accuracy-check` and `--workload ml10m_cal --accuracy-check` must
   both pass;
9. out-of-core training: `hugewiki_mini` at scale 1.0 (2,000,000 x 39,780, 124M
   ratings, the native generator's data, counts and CRC-32s pinned to
   the JAX package's); `OutOfCoreALS` (X in pinned host memory, K1 on
   the streamed X chunks, K2 on the streamed X panels, K3 on the theta
   slices) and the in-core `ALS` (X and theta direct, K1) for 3
   iterations each at F=100, lambda 0.048, bf16 factors, CG, "pallas":
   train and test RMSE within 2e-3 at every iteration, x and theta
   within rtol/atol 2e-2, K1, K2 and K3 launched exactly as the plans
   say (chunks and slices times iterations, read around the out-of-core
   run alone), the out-of-core peak device memory below the in-core
   one, the X store pinned and no device tensor of X's rows live after
   the run; then `python -m cumf_als_tpu_torch.bench --workload
   hugewiki_mini --out-of-core --iters 3` once (the root bench's keys,
   its train RMSE within 2e-3 of the phase's run). The plans and the
   CSC go through the bench's plan cache;
10. sharded training, `ShardedALS` on the same Netflix data, F=100, bf16,
   CG, "pallas" (the main configuration), plans and CSC through the
   bench's plan cache:
   a. one rank on an NCCL group of one, 3 iterations: X on the panel
      steps (K2, K3), theta's reduce blocks solved by K1; train and test
      RMSE within 2e-3 of phase 4a's run at every iteration; K1 on the
      most populous reduce block against its plain version at phase 2a's
      limits (initial factors); one more iteration traced by
      torch.profiler for the device-busy share (`[profile]`, traced);
   b. two ranks spawned on the one card (both on cuda:0, gloo: NCCL
      refuses two ranks on one card; the partials go through host
      memory, so its s/iter is a gloo-over-one-card time, not a
      multi-GPU one), 1 iteration (`SHARDED_TWO_RANK_ITERS`): RMSE
      within 2e-3 of (a), theta's SHA-256 equal on both ranks after it,
      the gathered X equal to each rank's rows; K2 on rank 0's
      partial of the most populous reduce block (bf16 A) and K3 on that
      block summed over both ranks as the all-reduce sums it, against
      their plain versions.
   K1, K2 and K3 launch exactly as the plans say in each run (read
   around the run alone); the counts go into the `kernels` line as
   `sharded_launches`;
11. sharded out-of-core training, `ShardedOutOfCoreALS` on the
   hugewiki_mini data of phase 9, F=100, bf16, CG, "pallas", plans and
   CSC through the bench's plan cache:
   a. one rank on an NCCL group of one, X in pinned host memory (bf16),
      3 iterations: K1 on the X chunks, K2 on the theta steps, K3 once
      an iteration over all of theta; train and test RMSE within 2e-3 of
      phase 9's run at every iteration, x and theta within rtol/atol
      2e-2; K3 on that reduce solve of all theta systems (f32 A) against
      its plain version;
   b. X on the card, theta on the direct route, 3 iterations, RMSE
      within 2e-3 of (a): K1 on the widest direct theta chunk against
      the device X (R = 8, P = 196,608, one real row: the cut, three
      ways as phase 2's few-row chunks; its se held to the exact se of
      its x, in float64, within the rounding of the cut's steps, a
      limit that must reject a K1 dropping the last 1/64 of the row),
      and K2 on a hot-segment chunk of the 16 most rated columns (R =
      16, P = 2^18, f32 A), against their plain versions (K2 three ways,
      as phase 2's few-row chunks);
      with no column above THETA_SEG_W ratings, one more iteration with
      it lowered until 8 columns are hot (K2 on their segments, K3 on
      their solve), RMSE within 2e-3 of (b)'s first;
   c. (b) on lazy plans in a fresh plan cache: iteration 0 builds the X
      and theta stream stores, iterations 1 and 2 read them; RMSE within
      1e-6 of (b);
   d. two ranks spawned on the one card (gloo, as 10b), X on the host,
      2 iterations: RMSE within 2e-3 of (a), theta's SHA-256 equal on
      both ranks after each iteration, X equal on both and holding each
      rank's rows; the bytes each rank all-reduced an iteration (the
      mesh's count);
   then `python -m cumf_als_tpu_torch.bench --workload hugewiki_mini
   --out-of-core --mesh 1 --iters 3` in a subprocess (the root bench's
   keys, train RMSE within 2e-3 of (a)). K1, K2 and K3 launch exactly as
   the plans say in each run; the counts go into the `kernels` line as
   `sharded_ooc_launches`;
12. the integrations and entry points:
   a. the full-hugewiki driver (`cumf_als_tpu_torch.hugewiki_full`) at
      full width, F=100, on `hugewiki` at scale 0.04 (2,003,304 x 1,591,
      ~124M ratings: the native generator, lazy plans not yet), plans
      through the bench's plan cache: `main` in this process for 2
      iterations with X on the card and cold CG starts, K1, K2 and K3
      launched exactly as its plans say (read around the run alone; K2
      and K3 on the columns above THETA_SEG_W ratings, which this shape
      has); the same 2 iterations through
      scripts/torch_hugewiki_full_driver.sh, one process an iteration
      under `--state-dir`, train and test RMSE within 2e-4 of the one
      process's; a third invocation a no-op that prints the state; then
      X on the host, 2 iterations in one process against iteration 0
      here and iteration 1 in a process of its own, which resumes from
      the bf16 `x_host.npy` ('<V2', the JAX script's file), within 2e-4;
      the kernel libraries built in each process (0);
   b. `entry()`: its function on the card, K4 launched once (through
      `ops.solve.solve` without a diagonal), the predictions within
      atol 5e-3 of the CPU's; K4 at entry()'s shapes (256 systems, f32 A)
      against its plain version, with times;
   c. `dryrun_multichip(1)` (an NCCL group of one) and
      `dryrun_multichip(2)` (two ranks on the one card, gloo), each
      against the same on the CPU: RMSEs within 2e-3, the squared-error
      sum within 2e-3 relative, the same panel count;
   d. `integrations.torch_op.do_als` on a 300 x 220 problem on the card
      against the CPU (RMSE within 1e-4), `TorchMF.predict`'s RMSE within
      1e-3 relative of the op's (the TF op is held to the JAX package's
      in the CPU tests; a line says whether TensorFlow is installed).
   The K1/K2/K3 counts of (a) go into the `kernels` line as
   `hugewiki_launches`, K4's check of (b) as `entry_check`;
13. the panel and solve kernels at 256 lanes (K2, K5a, K3, K4, K5b at
   f = 256; factor widths 128 < F <= 256), and the paths they open:
   a. each against its plain version at f = 256, with times and bounds:
      the edge grid of K2 and K5a on a float32 table at f = 256 (the
      split body of csrc/wide_split_mma.cuh: integer tables bit for bit,
      random ones within `gram_limit` "split", a chunk of more rows than
      the card's blocks from an odd slot twice); K2 and K5a on a
      synthetic chunk of the Netflix X phase's most populous shape
      (R = 2304, P = 576, a 65,537-row bf16 panel), bf16 and f32 A, and
      on a float32 table of the same shape (full mantissas, 0.2 U(0, 1):
      the split body, its bound `panel_gram_ops` "split"), bf16 and f32
      A; K2 on a hot-segment chunk (R = 16, P = 2^18, f32 A) of (c)'s X
      (three ways, as phase 2's few-row chunks), bf16 and float32 tables,
      on a synthetic chunk of the out-of-core theta shape (R = 6656,
      P = 72) on a float32 table, and on
      (c)'s most rated theta chunk; K3, K4 and K5b on 16,384 systems of
      one synthetic chunk (K2's and K5a's A, one row in 64 without
      ratings, which must solve to exactly 0), bf16 and f32 A, K3 and
      K5b also at CG-20 with a tolerance that stops systems early, K5b
      on an A' whose column 255 differs from its row 255 (b: at f = 256
      only the second block of a cluster holds that row), and K3 on
      (c)'s first theta slice;
   b. K3, K4 and K5b at f = 128 on the same kind of systems, on their
      one body (csrc/bulk_cg.cuh) (K4's and K5b's former one-block CG
      times are printed beside their checks on the main path's X slice,
      the systems they were read on);
   c. `OutOfCoreALS` on hugewiki_mini at F=200 (phase 9's configuration,
      3 iterations: K1 at 256 lanes on the X chunks, K2 and K3 at 256
      on theta), launches read around the run alone, against the
      in-core `ALS` of the same data and configuration (direct routes,
      K1 at 256 lanes): train and test RMSE within 2e-3 at every
      iteration;
   d. Netflix F=200 with the X phase on the panel route
      (`panel_budget_bytes` 6 GiB), 2 iterations with gram_dtype "bf16"
      (K2, K3) and 2 with "f32" (K5a, K5b; aug "auto"), theta direct,
      each within 2e-3 of phase 5's wide-off run at every iteration;
   e. (d)'s plans with the `ALSConfig` default dtypes (factor_dtype and
      gram_dtype "f32", aug_gram "auto"), 2 iterations, as 4c at
      F=100: the panel-aug X route on the float32 table, K5a at 256 on
      the split body (and `gram_span_sum` on the chunks its cut takes),
      K5b at 256, and K1 at 256 lanes on the float32 table of direct
      theta (the uncut FMA kernel, or the row cut's two FMA passes on a
      chunk of fewer rows than SMs), every launch as the plans say and
      no other kernel; train RMSE within 2e-3 of (d)'s f32 run at each
      iteration, test RMSE falling; K5a's device time over the X
      phase's chunks on the float32 initial factors, as routed and uncut
      (spans=1), and K2 and K5a on its fewest-row chunk three ways.
   The f = 256 numbers go into the `kernels` line as `f256`, those of
   (b) as `f128_one_body`, (e)'s as `f256_default`, the launches of (c),
   (d) and (e) as `f256_launches`;
14. factor widths F > 256 (f_pad = 128 T, T >= 3), on the same Netflix
   data at F=300 (f_pad 384), bf16 factors, where every route runs the
   two kernels of f >= 384 and no other: `tile_gram` (the Gram in
   128 x 128 tiles: K2, K5a, pass 1 of K1 and K6) and `global_cg` (the
   CG on A in device memory: K3, K4, K5b, pass 2 of K1 and K6):
   k. each against its plain version at f = 384 and 512, with times,
      launches and bounds: K1 and K6 (the two passes, in row batches of
      `cs.tiled_batch_rows`) on the most populous and the widest theta
      chunk of (a)'s plan (at 512 the first 4096 rows of the populous
      one), bf16 and float32 tables, and on the populous one pass 1
      alone (``tile_gram`` on each row batch) with its bound and
      torch.bmm on the pre-gathered G of its live slots; K2 and K5a on
      a synthetic chunk of the X panel shape (R = 2304, P = 576), bf16
      and f32 A, bf16 and float32 tables, and on one of few long rows
      (R = 16, P = 16384: at f = 384 the cut, one launch of
      ``gram_span_sum`` beside ``tile_gram``), with torch.bmm on the
      pre-gathered G and the plain version timed after a warm-up; K3, K4 and
      K5b on 16,384 systems at 384 (past 2^31 elements of A) and 4,096
      at 512, f32 and bf16 A, and K3 at CG-20 with cg_tol 1 (a system
      where one exit test goes the other way, at a step whose plain
      rsnew lies within a factor `EXIT_BAND` of cg_tol, is held to the
      plain iterate where that CG stops, at most `EXIT_CAP` a launch;
      the rule must reject a CG that stops a step early and one that
      ignores cg_tol);
   a. `ALS.run` for 2 iterations with the defaults: X on the split
      route, theta direct, K1 at f = 384 on both;
   b. `panel_budget_bytes` 12 GiB: X on the panel route (K2 and K3 at
      384, bf16 accumulators), theta direct;
   c. (b) with gram_dtype "f32" and aug_gram "force": K5a and K5b on X,
      K6 on theta;
   each run's s/iter, phase seconds and peak memory printed, the two
   kernels launched and no other but, in (b) and (c), the cut's pass 2
   (`gram_span_sum`) exactly as often as the X plan's chunks of few
   rows say, train RMSE falling, (b) and (c)
   within 2e-3 of (a) at every iteration. The numbers go into the
   `kernels` line under `tile_gram` and `global_cg`, (a)'s launches as
   theirs.

The data sets come through the bench's loader (`bench.load_workload`),
which generates each once into .bench_cache/torch/ and memory-maps it;
their counts and CRC-32s are held to those of the JAX package's
`workload_ratings(name, 1.0, 0)` (both pass 2^26 ratings, so both come
from the native generator).

Wherever K2 or K5a run, their cut's pass 2 (`gram_span_sum`) must
launch once for each call on a chunk the cut takes, as the plans'
shapes and `cs.gram_spans` say (at two ranks in 11d: the same count on
both ranks); its entry in the `kernels` line holds phase 2's check of
pass 2 alone and the main path's launches. Wherever K1 or K6 run at
f = 128, their cut's pass 2 (`frag_span_solve`) must launch once for
each call on a chunk the cut takes, as the plans' shapes and
`cs.theta_spans` say (4a, 4b, 9, 10a, 11a-c, 12a exactly; at two ranks
in 11d at most once a K1 launch), and pass 1 counts under the kernel's
own name, once a chunk as uncut; the 12a line prints both counts and
the theta seconds beside those of the uncut kernel (PERF.md §5).

It prints a `kernels` JSON line, the card line, and last
{"ok": true, "device": {...}}. It imports nothing of JAX.

    python3 chip_smoke.py --gram

is the short call after a change to K2, K5a or csrc/gram_mma.cuh: it
builds those two kernels and their cut's pass 2 alone (with the ptxas
report), runs the edge cases (at f = 128, and at f = 256 on a float32
table, the split body of csrc/wide_split_mma.cuh) and three synthetic
chunk shapes against the plain versions with their times, then the cut
at f = 128 and 256
three ways on synthetic chunks of the fewest-row X panel shape (16 x
4096), of about 40 rows (40 x 3840) and of the hot segments (16 x
2^18), and prints no result line.

    python3 chip_smoke.py --theta

is the short call after a change to K1, K6 or csrc/frag_cg.cuh (or to
gram_mma.cuh, which they share): it builds those two kernels and their
cut's pass 2 alone (with the ptxas report), runs the edge grid (rows
that stop at different nnz inside one chunk), times three synthetic
chunk shapes and the most populous, the widest and the fewest-row chunk
of the real Netflix theta plan against the plain versions, the two
few-row chunks of that plan the cut takes three ways and pass 2 alone,
and prints no result line.

    python3 chip_smoke.py --ooc

is the short call for the out-of-core path: it builds K1, K2 and K3
alone, runs phase 9 and prints no result line.

    python3 chip_smoke.py --sharded

is the short call for sharded training: it builds K1, K2 and K3 alone,
runs phase 4a's main path (its RMSE is (a)'s reference), then phase 10,
and prints no result line.

    python3 chip_smoke.py --sharded-ooc

is the short call for sharded out-of-core training: it builds K1, K2
and K3 alone, runs the out-of-core reference of phase 9 (OutOfCoreALS
on hugewiki_mini, 3 iterations), then phase 11, and prints no result
line.

    python3 chip_smoke.py --integrations

is the short call for the integrations and entry points: it builds K1,
K2, K3 and K4 alone, runs phase 12 and prints no result line.

    python3 chip_smoke.py --panel-256

is the short call for the panel and solve kernels at 256 lanes and for
K6 at 256 lanes: it builds K1 and K6 (and the three pass kernels), K2,
K3, K4, K5a and K5b (with the ptxas report), runs phase 5's wide-off
F=200 run (2 iterations, the reference of 5e and 13d), phase 5e on its
plans, then phase 13 (13a-13e), and prints no result line.

    python3 chip_smoke.py --wide-f

is the short call for factor widths F > 256: it builds `tile_gram` and
`global_cg` alone (with the ptxas report), runs phase 14 on the Netflix
data and prints no result line.

    python3 chip_smoke.py --wide

is the short call after a change to csrc/wide.cuh or the passes: it
builds K1, K7 and the three pass kernels alone (with the ptxas report),
runs the tensor-core pass 1 on integer tables, the span-edge grid and
synthetic few-row chunks (cut against one span a row, with times), then
the few-row chunks of the real Netflix F=200 plans and each pass alone
(phase 5a's cut checks), and prints no result line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ITERS = 3
REPLACES = {
    "gather_gram_cg": "cumf_als_tpu/ops/pallas_solve.py:299",
    "gather_gram_out": "cumf_als_tpu/ops/pallas_solve.py:534",
    "solve_cg_reg": "cumf_als_tpu/ops/pallas_solve.py:1105",
    "solve_cg": "cumf_als_tpu/ops/pallas_solve.py:1097",
    "gather_gram_aug_out": "cumf_als_tpu/ops/pallas_solve.py:610",
    "solve_cg_aug": "cumf_als_tpu/ops/pallas_solve.py:1122",
    "gather_gram_cg_aug": "cumf_als_tpu/ops/pallas_solve.py:345",
    "gather_gram_cg_wide": "cumf_als_tpu/ops/pallas_solve.py:804",
    "fused_gram_cg_cat": "cumf_als_tpu/ops/pallas_solve.py:956",
    # the two passes of the row cut of K7 and of K1 at 256 lanes (pass 1
    # on the FMA body or on the tensor cores)
    "wide_span_gram": "cumf_als_tpu/ops/pallas_solve.py:804",
    "wide_span_gram_mma": "cumf_als_tpu/ops/pallas_solve.py:804",
    "wide_span_solve": "cumf_als_tpu/ops/pallas_solve.py:804",
    # pass 2 of the cut of K2 and K5a on a chunk of few rows (pass 1 is
    # the panel kernel itself): `_gram_kernel` (534) and
    # `_gram_kernel_aug` (610)
    "gram_span_sum": "cumf_als_tpu/ops/pallas_solve.py:534",
    # pass 2 of the cut of K1 and K6 at f = 128 on a chunk of few rows
    # (pass 1 is their own entry point): `_kernel` (299) and
    # `_kernel_aug` (345)
    "frag_span_solve": "cumf_als_tpu/ops/pallas_solve.py:299",
    # factor widths f >= 384: the tiled Gram of K2 (`_gram_kernel`, 534),
    # K5a (610) and pass 1 of K1 (299) and K6 (345); the CG on A in device
    # memory of K3 (`_cg_solve_reg_kernel`, 1105), K4 (1097), K5b (1122)
    # and pass 2 of K1 and K6
    "tile_gram": "cumf_als_tpu/ops/pallas_solve.py:534",
    "global_cg": "cumf_als_tpu/ops/pallas_solve.py:1105",
}
# the Gram body each kernel's measured launches ran ("cg": a solve alone)
# ("bulk-cg": the persistent blocks on bulk-async copies of K3, K4 and
# K5b, csrc/bulk_cg.cuh;
# K8's own kernel is the FMA body a float32 G takes: a bf16 G launches the
# two passes, pass 1 on the tensor cores, which count under their names)
BODY = {"gather_gram_cg": "wgmma", "gather_gram_out": "wgmma",
        "solve_cg_reg": "bulk-cg", "solve_cg": "bulk-cg",
        "gather_gram_aug_out": "wgmma", "solve_cg_aug": "bulk-cg",
        "gather_gram_cg_aug": "wgmma", "gather_gram_cg_wide": "fma",
        "fused_gram_cg_cat": "fma", "wide_span_gram": "fma",
        "wide_span_gram_mma": "wgmma", "wide_span_solve": "cg",
        "gram_span_sum": "sum", "frag_span_solve": "cg",
        "tile_gram": "wgmma", "global_cg": "global-cg"}
SPLIT_KERNELS = ("gather_gram_cg", "gather_gram_out", "solve_cg_reg")
AUG_KERNELS = ("gather_gram_cg_aug", "gather_gram_aug_out", "solve_cg_aug")
WIDE_KERNELS = ("gather_gram_cg_wide", "fused_gram_cg_cat")
GRAM_KERNELS = ("gather_gram_out", "gather_gram_aug_out")
# pass 2 of K2's and K5a's cut on a chunk of few rows (`cs.gram_spans`)
SPAN_SUM = "gram_span_sum"
THETA_KERNELS = ("gather_gram_cg", "gather_gram_cg_aug")
# pass 2 of K1's and K6's cut on a chunk of few rows at f = 128
# (`cs.theta_spans`; pass 1 counts under the kernel's own name)
SPAN_SOLVE = "frag_span_solve"
THETA_SHORT = THETA_KERNELS + (SPAN_SOLVE,)
SPAN_KERNELS = ("wide_span_gram", "wide_span_gram_mma", "wide_span_solve")
# the route of K7 and K1 at f=256 on a bf16 table: the two passes, pass 1
# on the tensor cores
MMA_PASSES = ("wide_span_gram_mma", "wide_span_solve")
WIDE_SHORT = ("gather_gram_cg", "gather_gram_cg_wide") + SPAN_KERNELS
# the short call of phases 5e and 13: K1 and K6 (at 256 lanes their two
# passes; K6's uncut kernel and the FMA pass 1 on a float32 table), K2,
# K3, K4, K5a, K5b
PANEL_256_SHORT = SPLIT_KERNELS + AUG_KERNELS + ("solve_cg",) + \
    SPAN_KERNELS + (SPAN_SUM, SPAN_SOLVE)
# the device times (ms) of the 256-lane kernels on the same chunks on the
# FMA body, before the tensor-core pass 1 (the bracketed times of PERF.md
# §6; NVIDIA H100 80GB HBM3, 700.00 W):
# (kernel, chunk) -> as routed then (the cut on a chunk under 132 rows),
# and uncut
FMA_MS = {
    ("K7", "theta most populous"): (11.499, 11.499),
    ("K7", "theta widest"): (0.121, 2.413),
    ("K7", "split X most populous"): (10.892, 10.892),
    ("K7", "split X fewest rows"): (4.803, 91.325),
    ("K7", "split X about 32 rows"): (1.774, 6.638),
    ("K1", "theta most populous"): (13.049, 13.049),
    ("K1", "theta widest"): (0.153, 2.769),
    ("K1", "split X most populous"): (11.936, 11.936),
    ("K1", "split X fewest rows"): (5.028, 99.214),
    ("K1", "split X about 32 rows"): (1.866, 7.216),
    ("pass 1", "split X about 32 rows"): (1.723, 1.723),
    ("pass 2", "split X about 32 rows"): (0.050, 0.050),
    # phase totals as routed: (theta, split X)
    ("K7", "phase totals"): (292.0, 348.6),
    ("K1", "phase totals"): (336.6, 379.9),
}
# K3's and K8's times before their redesign, by CUDA events around one
# launch (the bracketed times of PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W): K3 on the first X solve slice (16,384 bf16 systems), K8 on
# theta most populous with a bf16 G
BEFORE_MS = {"K3": 0.541, "K8": 16.209}
# train RMSE after the last iteration of the full-width Netflix paths
# (3 iterations at F=100, main and aug; at F=200 3 with wide_kernel "on"
# and 2 with "off"), read on the card from the native generator's data
# (99,077,413 ratings; PERF.md §2 has the values read on the earlier
# numpy-path data beside them)
RECORDED_TRAIN_RMSE = {"main": 0.428543, "aug": 0.428718,
                       "wide on": 0.425283, "wide off": 0.514406}
# phase 6 with f32 accumulators: the largest relative difference of a
# row's x between the batched-panel and panel routes after one X phase
# (3.0e-6 read on the card, and 2.9e-6 between two runs of the panel
# route: scripts/torch_batched_readings.py)
F32_X_ROW_LIMIT = 1e-5
DEV = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
# the root bench's output keys in its order (bench.py:339-382), and those
# it adds with --repeat > 1 and with --accuracy-check
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline",
              "baseline_sec_per_iter", "ns_per_nnz", "test_rmse_final",
              "train_rmse_final", "total_seconds", "gram_gflops", "solver",
              "backend", "device"]
REPEAT_KEYS = ["repeats", "spread_min", "spread_max"]
ACCURACY_KEYS = ["accuracy_check", "accuracy_contract"]
# the JAX package's workload_ratings(name, 1.0, 0): counts and each
# member's CRC-32 (bench.dataset_crc32), computed from cumf_als_tpu with
# its native generator (both workloads pass 2^26 ratings), which the
# port's data must equal bit for bit
RECORDED_NETFLIX = {"nnz": 99_077_413, "nnz_test": 1_408_586, "crc32": {
    "indptr": 3106220693, "indices": 2907137272, "data": 1322421219,
    "trow": 3812812321, "tcol": 2404904807, "tdata": 330818980}}
RECORDED_HUGEWIKI_MINI = {
    "nnz": 124_000_582, "nnz_test": 1_999_293, "crc32": {
        "indptr": 1898438497, "indices": 2973046940, "data": 3688028508,
        "trow": 2441910573, "tcol": 2051445344, "tdata": 241349327}}
# iterations of each run of the out-of-core phase
OOC_ITERS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def keep_busy(n: int) -> None:
    """Queue n large matrix products (~1.5 ms each) on the current stream,
    so that what the host launches next waits on the device and the
    events between those launches read device time alone."""
    busy = torch.ones((8192, 8192), dtype=torch.bfloat16, device=DEV)
    for _ in range(n):
        torch.mm(busy, busy)


def queued_ms(fn, reps: int = 5) -> float:
    """Median device time of fn over `reps` launches queued behind other
    work, after one warm-up: for a kernel that can be shorter than the
    host's work to launch it."""
    fn()
    torch.cuda.synchronize()
    keep_busy(8)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    marks[0].record()
    for i in range(reps):
        fn()
        marks[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(marks[i].elapsed_time(marks[i + 1])
                             for i in range(reps))


def gram_limit(a: torch.Tensor, a_plain: torch.Tensor, p: int, body: str):
    """What a card's K2 or K5a is held to against the plain version: the
    elementwise limit on |A - A_plain| and its name, for rows of p slots
    run in `body`. Both bodies add in another order than the plain
    version (the tensor cores also truncate where they align the terms
    of a 16-slot step), so the error follows the size of the sum, not of
    the value: an entry whose terms cancel keeps the error of its large
    partial sums. The terms of A_ij sum in magnitude to at most
    sqrt(A_ii A_jj) (Cauchy-Schwarz), so the limit is steps x 2^-23 x
    sqrt(A_ii A_jj) + 1e-5: one f32 ulp of the sum's size for each
    accumulation step (a slot in the FMA body, 16 slots on the tensor
    cores; the split body of a float32 table, "split", six wgmma a
    16-slot step and two for the three products it drops, mid.lo, lo.mid
    and lo.lo, at most 2^-23 |g_i| |g_j| a slot) and 4 for the plain
    version's own rounding. A bf16 A adds one bf16 ulp of the larger
    value: both sides round an f32 sum to nearest."""
    af, pf = a.float(), a_plain.float()
    k_steps = -(-p // 16)
    steps = {"fma": p, "split": 6 * k_steps + 2}.get(body, k_steps) + 4
    d = pf.diagonal(dim1=-2, dim2=-1).clamp_min(0).sqrt()
    lim = steps * 2.0 ** -23 * d[..., :, None] * d[..., None, :] + 1e-5
    name = f"{steps} x 2^-23 sqrt(A_ii A_jj) + 1e-5"
    if a.dtype != torch.bfloat16:
        return lim, name
    big = torch.maximum(af.abs(), pf.abs())
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30))) - 7)
    return lim + ulp, name + " + one bf16 ulp"


def bound_ms(nbytes: float, flops, dtype=None) -> tuple:
    """The least time of a function that moves `nbytes` and does `flops`
    operations at `dtype`'s peak, or `flops` = {dtype: operations} done
    at several peaks, one after the other: (ms, "bytes" or
    "operations"), whichever takes longer."""
    ops = flops if isinstance(flops, dict) else {dtype: flops}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[t] for t, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def gram_ops(ch, f, b: bool = True) -> float:
    """The operations of a Gram on chunk `ch` at f lanes, as the function
    needs them: the symmetric A's upper triangle and diagonal, nnz f
    (f + 1), and b, 2 nnz f."""
    slots = float(ch.nnz.sum().item())
    return slots * f * (f + 1) + (2.0 * slots * f if b else 0.0)


def panel_gram_ops(ch, f, b: bool, body: str, dtype) -> dict:
    """The operations of K2 (with `b`) or K5a on chunk `ch` by the peak
    that does them, for `bound_ms`: the split body computes a float32
    table's Gram to f32 accuracy as six bf16 products of the triangle on
    the tensor cores (the card's fastest way to that function), b on
    the CUDA cores at the float32 peak; any other body the Gram
    (`gram_ops`) at the table's dtype."""
    if body != "split":
        return {dtype: gram_ops(ch, f, b)}
    slots = float(ch.nnz.sum().item())
    ops = {torch.bfloat16: 6.0 * slots * f * (f + 1)}
    if b:
        ops[torch.float32] = 2.0 * slots * f
    return ops


def wide_work(table_ext, ch, fl):
    """What one launch of the 256-lane body (csrc/wide.cuh: K1 at f=256,
    K7, pass 1 of the row cut) must do on chunk `ch` at fl live lanes:
    the bytes it reads (each distinct table row its live slots name, once,
    at fl lanes; the live slots' ids and values; nnz) and its operations
    (the Gram's upper triangle of 8x8 tiles, nnz fl (fl + 8), and b, 2
    nnz fl). The warm start and the outputs are the caller's to add."""
    r, p = ch.cols.shape
    live = torch.arange(p, device=ch.cols.device)[None, :] < \
        ch.nnz.long()[:, None]
    rows = torch.unique(ch.cols[live]).numel()
    slots = float(ch.nnz.sum().item())
    read = rows * fl * table_ext.element_size() + \
        slots * (4 + ch.vals.element_size()) + nbytes(ch.nnz)
    return read, slots * fl * (fl + 8) + 2.0 * slots * fl


def card_line() -> str:
    """The card's name and power limit (the bench's reading of
    nvidia-smi)."""
    from cumf_als_tpu_torch.bench import card_line as read
    return read()


# ------------------------------------------------------------ phase 1 --
# the (value, A) types of an instantiation of the split body at f = 256,
# by its mangled template arguments
SPLIT_TYPES = {"ff": "f32 values, f32 A", "f13__nv_bfloat16": "f32 values, "
               "bf16 A", "13__nv_bfloat16f": "bf16 values, f32 A",
               "13__nv_bfloat16S3_": "bf16 values, bf16 A"}


def ptxas_lines(build_log):
    """What ptxas reports for the tensor-core entry functions of K1, K2,
    K5a, K6 (with pass 1 of K1's and K6's cut, in their libraries) and
    the tensor-core pass 1 of the 256-lane body (registers and spill
    stores of each instantiation, static shared memory where it names
    any; the tiles are dynamic shared memory), the registers and spills
    of pass 2 of K1's and K6's cut, of the 256-lane entry functions and
    of K3, K4 and K5b, and every warning of the build. Returns False if
    one of the tensor-core entry functions, pass 2 or the f = 256 body of
    K3, K4 or K5b spills, or ptxas added a wgmma wait."""
    import re
    ok = True
    for name in GRAM_KERNELS + THETA_KERNELS + ("wide_span_gram_mma",):
        if name not in build_log:
            continue
        lines = build_log[name].splitlines()
        regs, spills, smem = [], [], []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and (
                    "mma_kernel" in line or "panel_stream_kernel" in line
                    or "span_gram_kernel" in line):
                info = " ".join(lines[i + 1:i + 5])
                regs += [int(x) for x in re.findall(r"Used (\d+) registers",
                                                    info)]
                spills += [int(x) for x in re.findall(
                    r"(\d+) bytes spill stores", info)]
                smem += [int(x) for x in re.findall(r"(\d+) bytes smem",
                                                    info)]
        # C7517: ptxas makes every turn of the tile loop wait for all of
        # its wgmma where plain code touches the sums inside the loop;
        # only these entry functions issue wgmma, so every such note of
        # the build counts
        waits = sum("C7517" in line for line in lines)
        # C7519: a warpgroup.arrive ptxas placed itself (no wait)
        arrives = sum("C7519" in line for line in lines)
        ok &= bool(regs) and max(spills, default=0) == 0 and waits == 0
        if name in GRAM_KERNELS:
            # the split body at f = 256 (csrc/wide_split_mma.cuh), one
            # instantiation a (values, A) dtype pair
            split = []
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and \
                        "panel_split_mma_kernel" in line:
                    info = " ".join(lines[i + 1:i + 5])
                    types = re.findall(r"kernelILb[01]E(\w+?)EEvPKf", line)
                    split.append((
                        SPLIT_TYPES.get(types[0] if types else "", "?"),
                        int(re.findall(r"Used (\d+) registers", info)[0]),
                        int(re.findall(r"(\d+) bytes spill stores",
                                       info)[0])))
            ok &= len(split) == 4 and all(sp == 0 for _, _, sp in split)
            log(f"[ptxas] {name}, the split body at f = 256 "
                f"(panel_split_mma_kernel), each instantiation (value and "
                f"A types, registers, spill stores in bytes): {split}")
        log(f"[ptxas] {name}, the {len(regs)} tensor-core entry functions: "
            f"registers {regs}, spill stores {spills} bytes, static shared "
            f"memory {max(smem, default=0)} bytes (dynamic: the ring of "
            f"tiles), wgmma waits added by ptxas (C7517): {waits}, "
            f"warpgroup arrives added by ptxas (C7519): {arrives}")
    if SPAN_SOLVE in build_log:
        lines = build_log[SPAN_SOLVE].splitlines()
        regs, spills = [], []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and \
                    "span_solve_kernel" in line:
                info = " ".join(lines[i + 1:i + 5])
                regs += [int(x) for x in re.findall(r"Used (\d+) registers",
                                                    info)]
                spills += [int(x) for x in re.findall(
                    r"(\d+) bytes spill stores", info)]
        ok &= bool(regs) and max(spills, default=0) == 0
        log(f"[ptxas] {SPAN_SOLVE}, pass 2 of K1's and K6's cut (the CG "
            f"of csrc/frag_cg.cuh): registers {regs}, spill stores "
            f"{spills} bytes")
    for name in WIDE_SHORT:
        if name not in build_log or name == "wide_span_gram_mma":
            continue
        lines = build_log[name].splitlines()
        regs, spills = [], []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(
                    k in line for k in ("_256_kernel", "wide_kernel",
                                        "span_gram_kernel",
                                        "span_solve_kernel")):
                info = " ".join(lines[i + 1:i + 5])
                regs += [int(x) for x in re.findall(r"Used (\d+) registers",
                                                    info)]
                spills += [int(x) for x in re.findall(
                    r"(\d+) bytes spill stores", info)]
        log(f"[ptxas] {name}, the {len(regs)} 256-lane entry functions "
            f"(csrc/wide.cuh): registers {sorted(set(regs))}, spill stores "
            f"up to {max(spills, default=0)} bytes")
    for name in ("solve_cg_reg", "solve_cg", "solve_cg_aug"):
        if name not in build_log:
            continue
        lines = build_log[name].splitlines()
        regs, spills = {}, {}
        for i, line in enumerate(lines):
            for kind in ("solve_kernel", "solve_cluster_kernel"):
                if "Compiling entry function" in line and kind in line:
                    info = " ".join(lines[i + 1:i + 5])
                    regs.setdefault(kind, []).extend(
                        int(x) for x in re.findall(r"Used (\d+) registers",
                                                   info))
                    spills.setdefault(kind, []).extend(
                        int(x) for x in re.findall(
                            r"(\d+) bytes spill stores", info))
        wide = spills.get("solve_cluster_kernel", [])
        # the f = 256 body holds 128 floats of A a thread: a spill would
        # put A in local memory
        ok &= len(wide) == 2 and max(wide) == 0
        log(f"[ptxas] {name}, its entry functions on csrc/bulk_cg.cuh: the "
            f"ring body (f = 16..128, bf16 and f32 A) registers "
            f"{regs.get('solve_kernel')}, spill stores "
            f"{spills.get('solve_kernel')} bytes; the f = 256 cluster body "
            f"(f32 and bf16 A) registers "
            f"{regs.get('solve_cluster_kernel')}, spill stores {wide} bytes")
    for name, kinds in (("tile_gram", ("tile_gram_cluster", "tile_gram_mma",
                                       "tile_gram_fma")),
                        ("global_cg", ("global_cg_kernel",))):
        if name not in build_log:
            continue
        lines = build_log[name].splitlines()
        regs, spills = {}, {}
        for i, line in enumerate(lines):
            for kind in kinds:
                if "Compiling entry function" in line and kind in line:
                    info = " ".join(lines[i + 1:i + 5])
                    regs.setdefault(kind, []).extend(
                        int(x) for x in re.findall(r"Used (\d+) registers",
                                                   info))
                    spills.setdefault(kind, []).extend(
                        int(x) for x in re.findall(
                            r"(\d+) bytes spill stores", info))
        waits = sum("C7517" in line for line in lines)
        arrives = sum("C7519" in line for line in lines)
        if name == "tile_gram":
            # the tensor-core bodies (the cluster body at f = 384 and 512,
            # the one-block-a-tile body above): no spill, no wgmma wait
            # added by ptxas
            for kind in ("tile_gram_cluster", "tile_gram_mma"):
                ok &= bool(regs.get(kind)) and \
                    max(spills.get(kind, [1])) == 0
            ok &= waits == 0
        log(f"[ptxas] {name} (f >= 384), its entry functions: registers "
            f"{regs}, spill stores {spills} bytes; wgmma waits added by "
            f"ptxas (C7517): {waits}, warpgroup arrives added by ptxas "
            f"(C7519): {arrives}")
    for name, out in build_log.items():
        for line in out.splitlines():
            if "warning" in line.lower() or "Potential" in line:
                log(f"[ptxas] {name}: {line.strip()[:300]}")
    return ok


def gram_synthetic(cs):
    """K2 and K5a at the shapes of the most populous X panel chunk
    (R=2304, P=576, a 65,537-row bf16 panel) and of two chunks of few
    long rows, on data made from a seed, without the plans: kernel vs
    plain and the times."""
    from types import SimpleNamespace
    gen = torch.Generator(device=DEV).manual_seed(3)
    r, p, n = 2304, 4096, 65536
    tp = (0.3 * torch.randn((n + 1, 128), generator=gen, device=DEV)
          ).to(torch.bfloat16)
    tp[n] = 0
    tp[:, 127] = 0
    nnz = torch.randint(p // 2, p + 1, (r,), generator=gen, device=DEV,
                        dtype=torch.int32)
    nnz[5] = 0
    mask = torch.arange(p, device=DEV)[None, :] < nnz[:, None]
    cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                           device=DEV), n).to(torch.int32)
    vals = (torch.randint(2, 11, (r, p), generator=gen, device=DEV) / 2.0
            * mask).float()
    ok = True
    for rows, slots in ((2304, 576), (32, 3840), (8, 4096)):
        ch = SimpleNamespace(cols=cols[:rows, :slots].contiguous(),
                             vals=vals[:rows, :slots].contiguous(),
                             nnz=nnz[:rows].clamp(max=slots), panel=0)
        for aug in (False, True):
            for a_dtype in (torch.bfloat16, torch.float32):
                ok &= check_gram(cs, tp, ch, a_dtype, aug, "synthetic",
                                 cut=rows < 264)[0]
    return ok


def synthetic_chunk(gen, r, p, n, fill=0.5):
    """A panel chunk of r rows of p slots over a table of n rows (pad id
    n), made from `gen`: each row's first nnz slots live (nnz from
    fill p to p, one row of pad slots only), values halves in 1..5."""
    from types import SimpleNamespace
    nnz = torch.randint(int(fill * p), p + 1, (r,), generator=gen,
                        device=DEV, dtype=torch.int32)
    nnz[min(3, r - 1)] = 0
    mask = torch.arange(p, device=DEV)[None, :] < nnz[:, None]
    cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                           device=DEV), n).to(torch.int32)
    vals = (torch.randint(2, 11, (r, p), generator=gen, device=DEV) / 2.0
            * mask).float()
    return SimpleNamespace(cols=cols, vals=vals, nnz=nnz, panel=0)


def synthetic_table(gen, n, f, signed=True):
    """A bf16 gather table of n rows and one zero row (the pad id n), its
    lane f - 1 zero (the aug form's free lane): 0.3 N(0, 1), or with
    `signed` False 0.2 U(0, 1), as init_factors makes theta (the X
    phase's table at iteration 0, and phase 2's stand-in X)."""
    if signed:
        t = 0.3 * torch.randn((n + 1, f), generator=gen, device=DEV)
    else:
        t = 0.2 * torch.rand((n + 1, f), generator=gen, device=DEV)
    t = t.to(torch.bfloat16)
    t[n] = 0
    t[:, f - 1] = 0
    return t


def float32_table(gen, n, f):
    """A float32 gather table of n rows and one zero row (the pad id n),
    0.2 U(0, 1) with full 24-bit mantissas, as init_factors makes a factor
    in float32 (the X phase's table at iteration 0 of the `ALSConfig`
    default), its lane f - 1 zero (the aug form's free lane)."""
    t = 0.2 * torch.rand((n + 1, f), generator=gen, device=DEV)
    t[n] = 0
    t[:, f - 1] = 0
    return t


def gram_cut_synthetic(cs):
    """The cut of K2 and K5a (`cs.gram_spans`) at f = 128 and 256 on
    chunks of few rows made from a seed: the shapes of the Netflix X
    panel plan's fewest-row chunk (16 x 4096) and of one of about 40 rows
    (40 x 3840) over a 65,537-row panel, and the hot-segment shape (16 x
    2^18) over a 2,000,001-row table; each three ways (`check_gram` with
    cut): the cut against the plain version, the same bits twice, and
    against spans=1 with both times. The tables are factors as the paths
    gather them at iteration 0 (`synthetic_table` unsigned): with signed
    entries b sums with cancellation, and its limit, 1e-5 relative to
    |b|, no longer measures the f32 rounding (PERF.md, the cut's
    findings)."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    ok = True
    for f in (128, 256):
        panel = synthetic_table(gen, 65536, f, signed=False)
        big = synthetic_table(gen, 2_000_000, f, signed=False)
        for tab, r, p, label in (
                (panel, 16, 4096, "the fewest-row X panel shape"),
                (panel, 40, 3840, "an X panel shape of about 40 rows"),
                (big, 16, 1 << 18, "the hot-segment shape")):
            ch = synthetic_chunk(gen, r, p, tab.shape[0] - 1)
            hot = p == 1 << 18
            for aug in (False, True):
                if hot and aug:
                    continue   # the hot segments run K2 alone
                a_dtype = torch.float32 if hot or aug else torch.bfloat16
                ok &= check_gram(cs, tab, ch, a_dtype, aug,
                                 f"synthetic, {label}, f={f}",
                                 table_rows=tab.shape[0] if not hot else
                                 live_rows(ch), cut=True)[0]
            del ch
        del panel, big
        torch.cuda.empty_cache()
    return ok


# ------------------------------------------------------------ phase 2 --
def se_witness(table_ext, ch, x, se, steps):
    """The exact se of the x a K1 returned, Sum (v - g.x)^2 over each
    real row's slots, taken in float64 from the same table (a bf16 or f32
    table is exact in float64), against the se it returned. Returns the
    largest |se - exact| relative to the exact se, and relative to the
    size of the terms se is taken from (r2 + 2|x.b| + x^T A x), and
    whether every row is within the rounding of those terms: steps x
    2^-23 x terms + 1e-5."""
    rel = of_terms = 0.0
    ok = True
    for i in torch.nonzero(ch.nnz > 0)[:, 0].tolist():
        k = int(ch.nnz[i])
        g = table_ext.index_select(0, ch.cols[i, :k].long()).double()
        v = ch.vals[i, :k].double()
        gx = g @ x[i].double()
        exact = float(((v - gx) ** 2).sum())
        terms = float((v * v).sum() + 2 * (v * gx).sum().abs() +
                      (gx * gx).sum())
        d = abs(float(se[i, 0]) - exact)
        rel = max(rel, d / max(exact, 1e-30))
        of_terms = max(of_terms, d / max(terms, 1e-30))
        ok &= d <= steps * 2.0 ** -23 * terms + 1e-5
        del g, gx
    return rel, of_terms, ok


def se_steps(cs, table_ext, r, p):
    """The accumulation steps of a K1 or K6 row of P slots as routed on a
    card, counted as `gram_limit` counts them: a slot each on the FMA
    body, 16 slots each on the tensor cores; on a chunk the cut takes
    (`cs.theta_spans`, S > 1) the steps of one span of P / S slots and
    the S adds of pass 2; then 4 for the reference's own rounding.
    Returns (steps, S)."""
    if cs.gram_body(table_ext) == "fma":
        return p + 4, 1
    s = cs.theta_spans(r, p, table_ext.shape[1], sm_count(), table_ext.dtype)
    return -(-(p // s) // 16) + (s if s > 1 else 0) + 4, s


def check_k1(cs, table_ext, ch, theta, cfg, label, aug=False,
             table_rows=None, se_exact=False, cut=False):
    """K1 (or, with aug, K6) on one theta-phase chunk: kernel vs plain,
    x within 2e-3 and se within 1e-3 relative; rows without ratings
    exactly 0 in x and se, and with aug lane f-1 of x exactly 0; the
    launches of the call counted (one of the kernel, and one of pass 2,
    `frag_span_solve`, on a chunk the cut takes). Kernel and plain are
    timed by one clock, device time behind queued work (`queued_ms`): a
    few-row chunk's kernel is not much longer than the host's work to
    launch it. `table_rows`, when given, is the number of table rows the
    bound counts (a large table's rows the chunk names), else the whole
    table. With `cut` the chunk must be one that `cs.theta_spans` cuts
    (S > 1), and it runs three ways, as K2's few-row chunks do: as
    routed, again (the same bits both times), and with spans=1 (the
    uncut kernel, x held to the same 2e-3), both timed here.

    `se_exact` holds se instead to the exact se of the kernel's own x
    (`se_witness`, float64), within the rounding of the terms se is taken
    from: se = r2 - 2 x.b + x^T A x (less the ridge) cancels, so its f32
    error follows r2 + 2|x.b| + x^T A x, not se; steps counts the
    accumulation steps of the route as `gram_limit` does (`se_steps`:
    on a cut chunk a span's steps and the S adds of pass 2). For rows of
    many ratings, where that rounding outgrows 1e-3 of se. The plain
    version's error against its own exact se is printed beside the
    kernel's (with `cut`, the uncut kernel's too), and so is the reading
    of a deliberately wrong kernel: the kernel run as routed with the
    last 1/64 and 1/8 of each real row's slots made pad slots (a K1 that
    stops its rows early), against the exact se of the whole row."""
    x0 = chunk_x0(ch, theta)
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    plain_fn = cs.gather_gram_cg_aug_plain if aug else \
        cs.gather_gram_cg_plain
    kernel = "gather_gram_cg_aug" if aug else "gather_gram_cg"
    r, p = ch.cols.shape
    steps, spans = se_steps(cs, table_ext, r, p)
    if cut and spans == 1:
        raise AssertionError(f"{label}: R={r} P={p} is not a chunk the cut "
                             f"takes")
    before = (cs.LAUNCHES[kernel], cs.LAUNCHES[SPAN_SOLVE])
    x, se = cs.gather_gram_cg(*args, aug=aug, **kw)
    counted = (cs.LAUNCHES[kernel] - before[0],
               cs.LAUNCHES[SPAN_SOLVE] - before[1]) == (1, int(spans > 1))
    px, pse = plain_fn(*args, **kw)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    se_ok, se_limit = se_rel <= 1e-3, "1e-3 relative"
    extra, cut_txt = {}, ""
    if cut:
        x2, se2 = cs.gather_gram_cg(*args, aug=aug, **kw)
        repeat = same_bits(x, x2) and same_bits(se, se2)
        x1, se1 = cs.gather_gram_cg(*args, aug=aug, spans=1, **kw)
        err1 = (x1 - px).abs().max().item()
        extra = dict(spans=spans, repeat_bits=repeat,
                     uncut_max_abs_err=err1, counted=counted)
        del x2, se2
    if se_exact:
        k_rel, k_terms, se_ok = se_witness(table_ext, ch, x, se, steps)
        p_rel, p_terms, p_ok = se_witness(table_ext, ch, px, pse, steps)
        uncut_txt = ""
        if cut:
            u_rel, u_terms, _ = se_witness(table_ext, ch, x1, se1, steps)
            extra.update(se_of_exact=k_rel, plain_se_of_exact=p_rel,
                         uncut_se_of_exact=u_rel)
            uncut_txt = (f"; the uncut kernel (spans=1) {u_rel:.3e} of se, "
                         f"{u_terms:.3e} of the terms")
        se_limit = (f"none; held instead: |se - the exact se of its x "
                    f"(float64)| <= {steps} x 2^-23 (r2 + 2|x.b| + x^T A "
                    f"x) + 1e-5 ({steps} steps: S={spans}): kernel {se_ok}, "
                    f"{k_rel:.3e} of se, {k_terms:.3e} of the terms; plain "
                    f"{p_ok}, {p_rel:.3e} of se, {p_terms:.3e} of the "
                    f"terms{uncut_txt}")
        pad = int(ch.cols[int(ch.nnz.argmin()), -1])
        for frac in (64, 8):
            cols_w, vals_w = ch.cols.clone(), ch.vals.clone()
            for i in torch.nonzero(ch.nnz > 0)[:, 0].tolist():
                k = int(ch.nnz[i])
                cols_w[i, k - k // frac:k] = pad
                vals_w[i, k - k // frac:k] = 0
            xw, sew = cs.gather_gram_cg(table_ext, cols_w, vals_w, ch.nnz,
                                        x0, cfg.lam, aug=aug, **kw)
            w_rel, w_terms, w_ok = se_witness(table_ext, ch, xw, sew,
                                              steps)
            w_dx = (xw - px).abs().max().item()
            verdict = "passes" if w_ok and w_dx <= 2e-3 else "rejects"
            extra[f"wrong_1_{frac}"] = verdict
            log(f"[K1 se witness] a deliberately wrong K1 that drops the "
                f"last 1/{frac} of each real row's slots: |se - exact se "
                f"of its x over the whole row| {w_rel:.3e} of se, "
                f"{w_terms:.3e} of the terms, within the se limit ({steps} "
                f"x 2^-23 of the terms): {w_ok}; max|dx| vs plain "
                f"{w_dx:.3e} (limit 2e-3); the check {verdict} it")
            del cols_w, vals_w, xw, sew
    if cut:
        del x1, se1
    empty = ch.nnz == 0
    zero_ok = bool((x[empty] == 0).all()) and bool((se[empty] == 0).all())
    if aug:
        zero_ok &= bool((x[:, -1] == 0).all())
    del px, pse
    ms = queued_ms(lambda: cs.gather_gram_cg(*args, aug=aug, **kw))
    if cut:
        ms1 = queued_ms(lambda: cs.gather_gram_cg(*args, aug=aug, spans=1,
                                                  **kw))
        extra["uncut_ms"] = ms1
        cut_txt = (f"; the cut, S={spans} spans of {p // spans} slots: "
                   f"{ms:.3f} ms against {ms1:.3f} uncut (spans=1, "
                   f"max|dx|={extra['uncut_max_abs_err']:.3e}), this call; "
                   f"the same bits twice: {extra['repeat_bits']}")
    plain = queued_ms(lambda: plain_fn(*args, **kw), reps=3)
    f = table_ext.shape[1]
    flops = gram_ops(ch, f, b=not aug)
    table_b = nbytes(table_ext) if table_rows is None else \
        table_rows * f * table_ext.element_size()
    bms, by = bound_ms(table_b + nbytes(ch.cols, ch.vals, ch.nnz, x0, x,
                                        se), flops, table_ext.dtype)
    ok = err <= 2e-3 and se_ok and zero_ok and counted
    if cut:
        ok &= extra["repeat_bits"] and extra["uncut_max_abs_err"] <= 2e-3
    name = "K6 gather_gram_cg_aug" if aug else "K1 gather_gram_cg"
    log(f"[{name}] {label} chunk R={r} P={p}, table {table_ext.dtype}, "
        f"body {cs.gram_body(table_ext)}, spans {spans} (launches counted: "
        f"{counted}): max|dx|={err:.3e} (limit 2e-3), "
        f"max rel dse={se_rel:.3e} (limit {se_limit}), "
        f"{int(empty.sum())} rows without ratings"
        f"{' and lane f-1' if aug else ''} exactly 0: "
        f"{zero_ok}; device time: kernel {ms:.3f} ms, plain {plain:.3f} "
        f"ms, bound {bms:.4f} ms ({by}){cut_txt}; {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None, **extra)


def check_span_solve(cs, table_ext, ch, theta, cfg, label, aug=False):
    """Pass 2 of K1's (with aug, K6's) cut alone (`frag_span_solve`), on
    the records pass 1 (`theta_span_grams`) writes for a chunk the cut
    takes, against its plain version on the same records: x within 2e-3,
    se within 1e-3 relative (the CG adds in another order), rows without
    ratings exactly 0, one launch. Device times; no single PyTorch call
    computes it (library null); the bound the bytes of the live records
    read once, x0 and nnz read, x and se written."""
    x0 = chunk_x0(ch, theta)
    r, p = ch.cols.shape
    s = cs.theta_spans(r, p, table_ext.shape[1], sm_count(), table_ext.dtype)
    part = cs.theta_span_grams(table_ext, ch.cols, ch.vals, ch.nnz, s,
                               aug=aug)
    args = (part, ch.nnz, x0, cfg.lam, p, s)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol, aug=aug)
    count = cs.LAUNCHES[SPAN_SOLVE]
    x, se = cs.frag_span_solve(*args, **kw)
    launched = cs.LAUNCHES[SPAN_SOLVE] == count + 1
    px, pse = cs.frag_span_solve_plain(*args, **kw)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    empty = ch.nnz == 0
    zero_ok = bool((x[empty] == 0).all()) and bool((se[empty] == 0).all())
    ms = queued_ms(lambda: cs.frag_span_solve(*args, **kw))
    plain = queued_ms(lambda: cs.frag_span_solve_plain(*args, **kw), reps=3)
    live = int(cs._span_live(ch.nnz, p, s, p // s).sum())
    read = live * cs.THETA_RECORD_FLOATS * 4 + nbytes(x0, ch.nnz, x, se)
    steps = cfg.cg_iters + 2
    bms, by = bound_ms(read, float(r * steps * 2 * 128 * 128),
                       torch.float32)
    ok = err <= 2e-3 and se_rel <= 1e-3 and zero_ok and launched
    log(f"[pass 2 {SPAN_SOLVE}] {label}: R={r} P={p}, S={s} spans, "
        f"{live} live records, aug {aug}: max|dx|={err:.3e} (limit 2e-3), "
        f"max rel dse={se_rel:.3e} (limit 1e-3), rows without ratings "
        f"exactly 0: {zero_ok}, one launch: {launched}; device time: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms "
        f"({by}); {'OK' if ok else 'FAIL'}")
    del part
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None, spans=s, shape=[r, p],
                    live_records=live)


def theta_chunk(p, seed, aug, vals_dtype, n=60, f=128):
    """A theta chunk of P = p slots whose rows stop at the edges of the
    64-slot tile, made from a seed: one row for each nnz in (0, 1, 15,
    16, 17, 63, 64, 65, 128, 129, p) up to p, pad slots at each row's
    tail (the zero row n, value 0), and a dummy tail row without ratings
    whose warm start is zero, as a plan's chunk ends. The table is bf16
    (the tensor-core body); with aug its lane f-1 is free and one value
    (3.3) is not exact in bf16."""
    rng = np.random.RandomState(seed + 17 * p)
    nnz = np.array([k for k in (0, 1, 15, 16, 17, 63, 64, 65, 128, 129)
                    if k < p] + [p, 0], dtype=np.int32)
    r = len(nnz)
    table = (rng.standard_normal((n + 1, f)) * 0.3).astype(np.float32)
    table[n] = 0.0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    vals[-2, 0] = 3.3
    x0 = (rng.standard_normal((r, f)) * 0.1).astype(np.float32)
    x0[-1] = 0.0
    if aug:
        table[:, f - 1] = 0.0
        x0[:, f - 1] = 0.0
    return (torch.from_numpy(table).to(DEV).to(torch.bfloat16),
            torch.from_numpy(cols).to(DEV),
            torch.from_numpy(vals * mask).to(DEV).to(vals_dtype),
            torch.from_numpy(nnz).to(DEV), torch.from_numpy(x0).to(DEV))


def theta_edges(cs, lam=0.048):
    """K1 and K6 against their plain versions on `theta_chunk`s: P = 64,
    256 and 520 (1, 4 and 9 tiles; rows of 0 to P slots in one chunk), f32
    and bf16 values: x within 2e-3, se within 1e-3 relative, rows without
    ratings exactly 0 in x and se, K6's lane 127 of x exactly 0."""
    ok_all = True
    worst = {}
    for p in (64, 256, 520):
        for aug in (False, True):
            for v_dtype in (torch.float32, torch.bfloat16):
                args = theta_chunk(p, 5, aug, v_dtype)
                x, se = cs.gather_gram_cg(*args, lam, aug=aug)
                plain = cs.gather_gram_cg_aug_plain if aug else \
                    cs.gather_gram_cg_plain
                px, pse = plain(*args, lam)
                err = (x - px).abs().max().item()
                se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)
                          ).max().item()
                empty = args[3] == 0
                ok = err <= 2e-3 and se_rel <= 1e-3 and \
                    bool((x[empty] == 0).all()) and \
                    bool((se[empty] == 0).all())
                if aug:
                    ok &= bool((x[:, -1] == 0).all())
                key = "K6" if aug else "K1"
                w = worst.setdefault(key, [0.0, 0.0])
                w[0], w[1] = max(w[0], err), max(w[1], se_rel)
                if not ok:
                    log(f"[theta edges] FAIL {key} P={p} vals {v_dtype}: "
                        f"max|dx|={err:.3e} max rel dse={se_rel:.3e}")
                ok_all &= ok
    log(f"[theta edges] K1 and K6, P in (64, 256, 520) x vals (f32, bf16), "
        f"bf16 table, f=128, rows of nnz (0, 1, 15, 16, 17, 63, 64, 65, "
        f"128, 129, P) and a dummy tail row: worst (max|dx|, max rel dse) "
        f"{ {k: [float(f'{e:.3e}') for e in v] for k, v in worst.items()} } "
        f"(limits 2e-3, 1e-3); rows without ratings exactly 0, K6 lane 127 "
        f"exactly 0; {'OK' if ok_all else 'FAIL'}")
    return ok_all


def theta_synthetic(cs, lam=0.048):
    """K1 and K6 at the shapes of the most populous (R=16384, P=256) and
    the widest (R=8, P=8192) theta chunk and of a few-row one (R=4,
    P=1024), on data made from a seed without the plans, each row of
    between P/2 and P ratings: kernel vs plain and the times."""
    from types import SimpleNamespace
    gen = torch.Generator(device=DEV).manual_seed(4)
    n = 17770
    tab = (0.3 * torch.randn((n + 1, 128), generator=gen, device=DEV)
           ).to(torch.bfloat16)
    tab[n] = 0
    tab[:, 127] = 0
    cfg = SimpleNamespace(lam=lam, cg_iters=6, cg_tol=1e-4)
    ok = True
    for r, p in ((16384, 256), (8, 8192), (4, 1024)):
        nnz = torch.randint(p // 2 + 1, p + 1, (r,), generator=gen,
                            device=DEV, dtype=torch.int32)
        mask = torch.arange(p, device=DEV)[None, :] < nnz[:, None]
        cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                               device=DEV), n)
        vals = torch.randint(2, 11, (r, p), generator=gen, device=DEV) / 2.0
        ch = SimpleNamespace(
            cols=cols.to(torch.int32), vals=(vals * mask).float(), nnz=nnz,
            n_real=r, rows=torch.arange(r, device=DEV),
            rows_real=torch.arange(r, device=DEV))
        theta = 0.1 * torch.randn((r, 128), generator=gen, device=DEV)
        theta[:, 127] = 0
        for aug in (False, True):
            ok &= check_k1(cs, tab, ch, theta, cfg, "synthetic", aug=aug)[0]
    return ok


def check_span_sum(cs, tp, ch, a_dtype, label):
    """Pass 2 of K2's cut (`gram_span_sum`) alone, on the f32 partials of
    a chunk the cut takes (pass 1: K2 uncut over the (R S, P / S) view),
    against its plain version: the same adds in the same order, so equal
    bit for bit (the limit is 0). Device times; the yardstick is one
    torch.sum over the spans of A (another order; b left out); the bound
    the bytes of the partials read once and of A and b written once."""
    r, p = ch.cols.shape
    f = tp.shape[1]
    s = cs.gram_spans(r, p, f, sm_count(), tp.dtype)
    view = (ch.cols.view(r * s, p // s), ch.vals.view(r * s, p // s))
    a_part, b_part = cs.gather_gram_out(tp, *view, out_dtype=torch.float32,
                                        spans=1)
    count = cs.LAUNCHES[SPAN_SUM]
    a, b = cs.gram_span_sum(a_part, b_part, s, a_dtype)
    launched = cs.LAUNCHES[SPAN_SUM] == count + 1
    pa, pb = cs.gram_span_sum_plain(a_part, b_part, s, a_dtype)
    exact = same_bits(a, pa) and same_bits(b, pb)
    err = max((a.float() - pa.float()).abs().max().item(),
              (b - pb).abs().max().item())
    ms = queued_ms(lambda: cs.gram_span_sum(a_part, b_part, s, a_dtype))
    plain = queued_ms(lambda: cs.gram_span_sum_plain(a_part, b_part, s,
                                                     a_dtype), reps=3)
    parts = a_part.view(r, s, f * f)
    lib = queued_ms(lambda: torch.sum(parts, 1))
    bms, by = bound_ms(nbytes(a_part, b_part, a, b),
                       float((s - 1) * r * (f * f + f)), torch.float32)
    ok = exact and launched
    log(f"[pass 2 gram_span_sum] {label}: R={r} P={p}, S={s} spans, f={f}, "
        f"A {a_dtype}: max|d|={err:.3e} (limit 0: the same adds in the "
        f"same order; equal bit for bit {exact}), one launch: {launched}; "
        f"device time: kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.sum "
        f"over the spans of A {lib:.4f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib, spans=s, shape=[r, p])


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """x and y hold the same bits (f32 or bf16)."""
    as_int = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    return x.dtype == y.dtype and torch.equal(x.view(as_int), y.view(as_int))


def check_gram(cs, tp, ch, a_dtype, aug, label, table_rows=None,
               cut=False):
    """K2 (or, with aug, K5a) on one X-phase panel chunk: kernel vs plain,
    and torch.bmm on a pre-gathered (and, with aug, pre-augmented) G as
    the yardstick: it leaves out the gather, the value splice and b, and
    writes A in G's dtype. All three times are device time (`queued_ms`:
    on a few-row chunk the kernel is shorter than the host's work to
    launch it). A is held to `gram_limit`, b to 1e-5 relative;
    the line prints the measured error relative to the size of the sum,
    max |dA_ij| / sqrt(A_ii A_jj), in units of 2^-23. `table_rows`, when
    given, is the number of table rows the bound counts (a large table's
    rows the chunk names), else the whole table. With `cut` the chunk
    must be one that `cs.gram_spans` cuts (S > 1), and it runs three
    ways: as routed (one launch of the kernel and one of its pass 2,
    `gram_span_sum`, counted), again (the same bits both times), and
    with spans=1 (the uncut body, also within `gram_limit`), both timed
    here."""
    args = (tp, ch.cols, ch.vals)
    r, p = ch.cols.shape
    f = tp.shape[1]
    if aug:
        name, fn, plain_fn = ("K5a gather_gram_aug_out",
                              cs.gather_gram_aug_out,
                              cs.gather_gram_aug_out_plain)
    else:
        name, fn, plain_fn = ("K2 gather_gram_out", cs.gather_gram_out,
                              cs.gather_gram_out_plain)
    kernel = name.split()[1]
    spans = cs.gram_spans(r, p, f, sm_count(), tp.dtype)
    if cut and spans == 1:
        raise AssertionError(f"{label}: R={r} P={p} is not a chunk the "
                             f"cut takes")

    def run(**kw):
        out = fn(*args, out_dtype=a_dtype, **kw)
        return (out, None) if aug else out

    before = (cs.LAUNCHES[kernel], cs.LAUNCHES[SPAN_SUM])
    a, b = run()
    counted = (cs.LAUNCHES[kernel] - before[0],
               cs.LAUNCHES[SPAN_SUM] - before[1]) == (1, int(spans > 1))
    pa, pb = (plain_fn(*args, out_dtype=a_dtype), None) if aug else \
        plain_fn(*args, out_dtype=a_dtype)
    body = cs.panel_body(tp)
    lim, limit = gram_limit(a, pa, p, body)

    def a_error(got):
        diff = (got.float() - pa.float()).abs()
        return diff.max().item(), bool((diff <= lim).all()), diff

    err, a_ok, diff = a_error(a)
    paf = pa.float()
    d = paf.diagonal(dim1=1, dim2=2).clamp_min(0).sqrt()
    of_sum = (diff / (d[:, :, None] * d[:, None, :]).clamp_min(1e-30)
              )[diff > 0]
    of_sum = of_sum.max().item() / 2.0 ** -23 if of_sum.numel() else 0.0
    del diff, d, paf
    pad_rows = ch.nnz == 0
    zero_ok = bool((a[pad_rows] == 0).all())
    b_rel = 0.0
    if b is not None:
        b_rel = ((b - pb).abs() / pb.abs().clamp_min(1.0)).max().item()
        zero_ok &= bool((b[pad_rows] == 0).all())
    extra, cut_txt = {}, ""
    if cut:
        a2, b2 = run()
        repeat = same_bits(a, a2) and (b is None or same_bits(b, b2))
        del a2, b2
        # the uncut body, reported beside the route (its own limit; the
        # route is what the check holds)
        a1, b1 = run(spans=1)
        lim1 = gram_limit(a1, pa, p, body)[0]
        d1 = (a1.float() - pa.float()).abs()
        err1, ok1 = d1.max().item(), bool((d1 <= lim1).all())
        if b is not None:
            ok1 &= bool(((b1 - pb).abs() <= 1e-5 * pb.abs().clamp_min(1.0)
                         ).all())
        del a1, b1, lim1, d1
        ms1 = queued_ms(lambda: run(spans=1))
        extra = dict(spans=spans, repeat_bits=repeat, uncut_ms=ms1,
                     uncut_max_abs_err=err1, uncut_within_limits=ok1,
                     counted=counted)
        a_ok &= repeat
    del lim, a, pa
    ms = queued_ms(lambda: run())
    if cut:
        cut_txt = (f"; the cut, S={spans} spans of {p // spans} slots: "
                   f"{ms:.3f} ms against {extra['uncut_ms']:.3f} uncut "
                   f"(spans=1, max|dA|={extra['uncut_max_abs_err']:.3e}, "
                   f"{'within' if ok1 else 'OFF'} its limits), this call; "
                   f"the same bits twice: {repeat}")
    plain = queued_ms(lambda: plain_fn(*args, out_dtype=a_dtype), reps=3)
    g = tp.index_select(0, ch.cols.reshape(-1).long()).reshape(r, p, f)
    if aug:
        g = cs.augment_g(g, ch.vals)
    gt = g.transpose(1, 2)
    lib = queued_ms(lambda: torch.bmm(gt, g))
    del g, gt
    flops = panel_gram_ops(ch, f, not aug, body, tp.dtype)
    out_bytes = r * f * f * torch.tensor([], dtype=a_dtype).element_size()
    if not aug:
        out_bytes += r * f * 4
    table_b = nbytes(tp) if table_rows is None else \
        table_rows * f * tp.element_size()
    bms, by = bound_ms(table_b + nbytes(ch.cols, ch.vals) + out_bytes,
                       flops)
    gathered = r * p * f * tp.element_size()
    rate = gathered / (ms * 1e-3) / 1e12
    ok = a_ok and b_rel <= 1e-5 and zero_ok and counted
    log(f"[{name}] {label}: panel {ch.panel} chunk R={r} P={p}, table "
        f"{tp.dtype}, A {a_dtype}, body {body}, spans {spans} (launches "
        f"counted: {counted}): max|dA|={err:.3e} (limit "
        f"{limit}: {a_ok}), max |dA_ij|/sqrt(A_ii A_jj)={of_sum:.2f} x 2^-23, "
        f"max rel db={b_rel:.3e} (limit 1e-5), rows of pad slots only "
        f"exactly 0: {zero_ok}; device time: kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, torch.bmm on pre-gathered G (no gather, no "
        f"{'splice' if aug else 'b'}, A in G's dtype) {lib:.3f} ms, bound "
        f"{bms:.4f} ms ({by}); gathered from the L2 {gathered / 1e6:.1f} "
        f"MB, {rate:.3f} TB/s{cut_txt}; {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib, body=body,
                    gathered_bytes=gathered, gathered_tb_per_s=rate, **extra)


# the times (events, ms) of K4 and K5b on their one-block-a-system CG,
# before they moved onto K3's body: the first X solve slice of the f32
# aug configuration (16,384 f32 systems at f = 128; PR 12 call 3; NVIDIA
# H100 80GB HBM3, 700.00 W). Printed beside the same slice's checks only.
ONE_BLOCK_MS = {"solve_cg": 0.592, "solve_cg_aug": 0.661}
SOLVE_NAMES = {"solve_cg_reg": "K3", "solve_cg": "K4", "solve_cg_aug": "K5b"}


def check_solve(cs, kernel, args, label, cg_iters=6, cg_tol=1e-4,
                empty=None, before=None, fn=None):
    """K3, K4 or K5b (`kernel`) against its plain version on `args` (its
    wrapper's), x within 2e-3; one call of `fn` (the wrapper, or a caller
    of it such as the public dispatcher) must launch the kernel once; the
    systems `empty` (no ratings: A = 0) solve to exactly 0, and K5b's
    lane f - 1 of x is exactly 0. Times by CUDA events, at cg_iters and
    at 0 (the kernel still loads A and forms b - A x0, so the difference
    is the CG); the bound is the bytes of A, diag, b, x0 and x against
    one matvec of each system. `before`: an earlier design's time on the
    same systems, printed in the log line alone."""
    fn = fn or getattr(cs, kernel)
    plain_fn = getattr(cs, f"{kernel}_plain")
    kw = dict(cg_iters=cg_iters, cg_tol=cg_tol)
    count = cs.LAUNCHES[kernel]
    x = fn(*args, **kw)
    launched = cs.LAUNCHES[kernel] == count + 1
    px = plain_fn(*args, **kw)
    err = (x - px).abs().max().item()
    del px
    a = args[0]
    r, f, _ = a.shape
    ok = err <= 2e-3 and bool(torch.isfinite(x).all()) and launched
    exact = True
    if empty is not None:
        exact &= bool((x[empty] == 0).all())
    if kernel == "solve_cg_aug":
        exact &= bool((x[:, f - 1] == 0).all())
    ms = time_ms(lambda: fn(*args, **kw))
    ms0 = time_ms(lambda: fn(*args, cg_iters=0, cg_tol=cg_tol))
    plain = time_ms(lambda: plain_fn(*args, **kw), reps=3)
    bms, by = bound_ms(nbytes(*(t for t in args if torch.is_tensor(t)), x),
                       2.0 * r * f * f, a.dtype)
    per_sm = cs.cg_blocks_per_sm(a.device, f, a.dtype, kernel)
    grid_txt = f"{per_sm} clusters of two blocks on the card" if f == 256 \
        else f"{per_sm} blocks an SM"
    before_txt = f"before: {before:.3f} ms; " if before else ""
    ok &= exact
    log(f"[{SOLVE_NAMES[kernel]} {kernel}] {label}: {r} systems at f={f}, "
        f"A {a.dtype}, cg_iters {cg_iters}, cg_tol {cg_tol:g}: max|dx|="
        f"{err:.3e} (limit 2e-3), one launch a call: {launched}, empty "
        f"systems and aug lane exactly 0: {exact}; kernel {ms:.3f} ms "
        f"({before_txt}at cg_iters 0 {ms0:.3f} ms, the CG: {ms - ms0:.3f} "
        f"ms), plain {plain:.3f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.0%} of the bound; {grid_txt} (the kernel's occupancy "
        f"query; events); {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, ms_cg0=ms0, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    **{"clusters" if f == 256 else "blocks_per_sm": per_sm},
                    f=f, systems=r, a_dtype=str(a.dtype))


def dispatch_k4(solve):
    """K4 as a user reaches it: the public dispatcher without a diagonal,
    in `check_solve`'s calling form."""
    return lambda a, b, x0, cg_iters, cg_tol: solve(
        a, b, x0, solver="cg", cg_iters=cg_iters, cg_tol=cg_tol,
        backend="pallas")


def check_k3(cs, a_buf, b_buf, x0_full, row_nnz, lo, batch, cfg,
             what="slice"):
    """K3 on one solve slice of the X-phase accumulators (`check_solve`),
    with the slice's A as stored and widened to float32 (what a
    gram_dtype="f32" run without aug feeds K3); the stored dtype's
    numbers fill the entry, the float32 ones go under f32_* (a float32 A
    is checked once). `what` names the systems in the log line; the time
    before K3's redesign, on the main path's X slice, is printed beside a
    "slice" alone."""
    b = b_buf[lo:lo + batch]
    x0 = x0_full[lo:lo + batch]
    nnzf = row_nnz[lo:lo + batch].float()
    diag = nnzf * cfg.lam + (nnzf == 0).float()
    ok_all, out = True, {}
    a_s = a_buf[lo:lo + batch]
    for a in (a_s,) if a_s.dtype == torch.float32 else (a_s, a_s.float()):
        before = BEFORE_MS["K3"] if a.dtype == torch.bfloat16 and \
            what == "slice" else None
        ok, res = check_solve(cs, "solve_cg_reg", (a, diag, b, x0), what,
                              cfg.cg_iters, cfg.cg_tol, before=before)
        ok_all &= ok
        if out:
            out.update({f"f32_{k}": v for k, v in res.items()})
        else:
            out = res
        del a
    return ok_all, out


def gram_edges(cs):
    """K2 and K5a at the edges of the 64-slot tile, on small chunks made
    from a seed: P = 8, 24, 72, 136 (one k-step, a ragged last tile, one
    slot group past a tile, two tiles and a half k-step), P = 520 and
    1288 (long rows: 9 and 21 tiles through the ring of 4), R = 1 and a
    chunk with a row of pad slots only. The table holds small integers
    and the values halves, so every sum is exact in f32 whatever its
    order: the kernels must equal their plain versions bit for bit, which
    proves the tile layout (a misplaced piece changes a sum). Then the
    same shapes on a random table within `gram_limit`, for a bf16 and a
    float32 table."""
    rng = np.random.RandomState(7)
    n, f = 300, 128
    worst = {}
    ok_all = True
    for p in (8, 24, 72, 136, 520, 1288):
        for r in (1, 5):
            nnz = rng.randint(1, p + 1, (r,))
            if r > 1:
                nnz[2] = 0          # a row of pad slots only
                nnz[0] = p          # a full row
            mask = np.arange(p)[None, :] < nnz[:, None]
            cols = torch.from_numpy(np.where(
                mask, rng.randint(0, n, (r, p)), n).astype(np.int32)).to(DEV)
            vals = torch.from_numpy((np.round(rng.uniform(1, 5, (r, p)) * 2)
                                     / 2 * mask).astype(np.float32)).to(DEV)
            for kind in ("integers", "random"):
                if kind == "integers":
                    tab = rng.randint(-4, 5, (n + 1, f)).astype(np.float32)
                else:
                    tab = (rng.standard_normal((n + 1, f)) * 0.3
                           ).astype(np.float32)
                tab[n] = 0.0
                tab[:, f - 1] = 0.0     # the free lane of the aug form
                for t_dtype, v_dtype, a_dtype in (
                        (torch.bfloat16, torch.float32, torch.float32),
                        (torch.bfloat16, torch.bfloat16, torch.bfloat16),
                        (torch.float32, torch.float32, torch.float32),
                        (torch.float32, torch.bfloat16, torch.bfloat16)):
                    table = torch.from_numpy(tab).to(DEV).to(t_dtype)
                    args = (table, cols, vals.to(v_dtype))
                    a, b = cs.gather_gram_out(*args, out_dtype=a_dtype)
                    pa, pb = cs.gather_gram_out_plain(*args,
                                                      out_dtype=a_dtype)
                    a5 = cs.gather_gram_aug_out(*args, out_dtype=a_dtype)
                    pa5 = cs.gather_gram_aug_out_plain(*args,
                                                       out_dtype=a_dtype)
                    pairs = (("K2 A", a, pa), ("K2 b", b, pb),
                             ("K5a A'", a5, pa5))
                    for what, got, want in pairs:
                        got, want = got.float(), want.float()
                        diff = (got - want).abs()
                        big = torch.maximum(got.abs(), want.abs())
                        if kind == "integers":
                            ok = bool((diff == 0).all())
                        elif what == "K2 b":
                            ok = bool((diff <= 1e-5 * big + 1e-5).all())
                        else:
                            ok = bool((diff <= gram_limit(
                                a if what == "K2 A" else a5, want, p,
                                cs.panel_body(table))[0]).all())
                        ok &= bool((got[nnz == 0] == 0).all())
                        key = (what, kind)
                        worst[key] = max(worst.get(key, 0.0),
                                         diff.max().item())
                        if not ok:
                            log(f"[gram edges] FAIL {what} P={p} R={r} "
                                f"{kind} table {t_dtype} vals {v_dtype} A "
                                f"{a_dtype}: max|d|={diff.max().item():.3e}")
                        ok_all &= ok
    bodies = {str(t): cs.panel_body(torch.zeros((1, f), dtype=t))
              for t in (torch.bfloat16, torch.float32)}
    log(f"[gram edges] P in (8, 24, 72, 136, 520, 1288) x R in (1, 5, one "
        f"row of pad slots only) x (bf16 table f32 A, bf16 table bf16 vals "
        f"bf16 A, f32 table f32 A, f32 table bf16 vals bf16 A), f=128, "
        f"body by table {bodies}: integer tables equal the plain "
        f"version bit for bit (the layout proof), random tables (full f32 "
        f"mantissas) within gram_limit "
        f"(b: rtol 1e-5 + 1e-5); worst |d| "
        f"{ {' '.join(k): round(v, 9) for k, v in worst.items()} }; "
        f"{'OK' if ok_all else 'FAIL'}")
    return ok_all


def panel_split_edges(cs):
    """K2 and K5a at f = 256 on a float32 table (the split body of
    csrc/wide_split_mma.cuh, 32-slot tiles) at the edges of its tile and
    k-step, on small chunks made from a seed: P = 8, 24, 40, 72, 136, 520
    and 1288, R = 1 and 5 (a full row and a row of pad slots only), with
    f32 and bf16 values and A. On a table of small integers (values in
    halves) every piece below hi is zero and every sum exact: the kernels
    equal their plain versions bit for bit, the proof of the piece
    layout, the strips, the transposed blocks of the epilogue and K5a's
    value in lane 255; on a random one (full f32 mantissas, all three
    pieces live) A within `gram_limit` "split" and b within rtol 1e-5.
    Then a chunk of more rows than the card's blocks (2 SMs + 3 rows of
    P = 199, the ids and values a view from an odd slot, bf16 values):
    two launches give the same bits, A is exactly symmetric, both within
    the limits. b is held to 1e-5 of the size of its sum, Sum |v g|
    (at least 1): the random tables are signed, and a lane whose terms
    cancel keeps the rounding of its large partial sums. Returns ok."""
    rng = np.random.RandomState(17)
    n, f = 300, 256
    worst = {}
    ok_all = True

    def check(what, got, want, kind, p, table, nnz, label, size=None):
        lim = 1e-5 * size.clamp_min(1.0) if what == "K2 b" else \
            gram_limit(got, want, p, cs.panel_body(table))[0]
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        ok = bool((diff == 0).all() if kind == "integers" else
                  (diff <= lim).all())
        ok &= bool((got[nnz == 0] == 0).all())
        if got.dim() == 3:
            ok &= bool(torch.equal(got, got.transpose(1, 2)))
        key = (what, kind)
        worst[key] = max(worst.get(key, 0.0), diff.max().item())
        if not ok:
            log(f"[split 256 edges] FAIL {what} {label}: max|d|="
                f"{diff.max().item():.3e}")
        return ok

    def kernels(table, cols, vals, a_dtype):
        a, b = cs.gather_gram_out(table, cols, vals, out_dtype=a_dtype)
        pa, pb = cs.gather_gram_out_plain(table, cols, vals,
                                          out_dtype=a_dtype)
        a5 = cs.gather_gram_aug_out(table, cols, vals, out_dtype=a_dtype)
        pa5 = cs.gather_gram_aug_out_plain(table, cols, vals,
                                           out_dtype=a_dtype)
        size = cs.gather_gram_out_plain(table.abs(), cols, vals.abs())[1]
        return (("K2 A", a, pa), ("K2 b", b, pb), ("K5a A'", a5, pa5)), size

    def table_of(kind, rows):
        if kind == "integers":
            tab = rng.randint(-4, 5, (rows + 1, f)).astype(np.float32)
        else:
            tab = (rng.standard_normal((rows + 1, f)) * 0.3
                   ).astype(np.float32)
        tab[rows] = 0.0
        tab[:, f - 1] = 0.0     # the free lane of the aug form
        return torch.from_numpy(tab).to(DEV)

    for p in (8, 24, 40, 72, 136, 520, 1288):
        for r in (1, 5):
            nnz = rng.randint(1, p + 1, (r,))
            if r > 1:
                nnz[2] = 0          # a row of pad slots only
                nnz[0] = p          # a full row
            mask = np.arange(p)[None, :] < nnz[:, None]
            cols = torch.from_numpy(np.where(
                mask, rng.randint(0, n, (r, p)), n).astype(np.int32)).to(DEV)
            vals = torch.from_numpy((np.round(rng.uniform(1, 5, (r, p)) * 2)
                                     / 2 * mask).astype(np.float32)).to(DEV)
            nnz_t = torch.from_numpy(nnz).to(DEV)
            for kind in ("integers", "random"):
                table = table_of(kind, n)
                if cs.panel_body(table) != "split":
                    raise AssertionError("a float32 table at f = 256 does "
                                         "not take the split body")
                for v_dtype, a_dtype in (
                        (torch.float32, torch.float32),
                        (torch.bfloat16, torch.bfloat16),
                        (torch.float32, torch.bfloat16),
                        (torch.bfloat16, torch.float32)):
                    label = (f"P={p} R={r} {kind} vals {v_dtype} A "
                             f"{a_dtype}")
                    pairs, size = kernels(table, cols, vals.to(v_dtype),
                                          a_dtype)
                    for what, got, want in pairs:
                        ok_all &= check(what, got, want, kind, p, table,
                                        nnz_t, label, size)
    # more rows than blocks, from an odd slot: the stream across rows
    r, p = 2 * sm_count() + 3, 199
    nnz = rng.randint(1, p + 1, (r + 1,))
    nnz[3] = 0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = torch.from_numpy(np.where(mask, rng.randint(0, n, (r + 1, p)), n)
                            .astype(np.int32)).to(DEV)
    vals = torch.from_numpy((rng.uniform(1, 5, (r + 1, p)) * mask)
                            .astype(np.float32)).to(DEV)
    args = (table_of("random", n), cols[1:], vals.to(torch.bfloat16)[1:])
    nnz_t = torch.from_numpy(nnz[1:]).to(DEV)
    for a_dtype in (torch.float32, torch.bfloat16):
        label = f"P={p} R={r} from an odd slot, A {a_dtype}"
        pairs, size = kernels(*args, a_dtype)
        again, _ = kernels(*args, a_dtype)
        for (what, got, want), (_, got2, _) in zip(pairs, again):
            ok_all &= check(what, got, want, "random", p, args[0], nnz_t,
                            label, size)
            if not same_bits(got, got2):
                log(f"[split 256 edges] FAIL {what} {label}: two launches "
                    f"differ")
                ok_all = False
    log(f"[split 256 edges] P in (8, 24, 40, 72, 136, 520, 1288) x R in "
        f"(1, 5, one row of pad slots only) x (f32, bf16 vals) x (f32, "
        f"bf16 A), a float32 table at f=256 (body split), then R={r} "
        f"P={p} from an odd slot twice: integer tables equal the plain "
        f"version bit for bit, random ones within gram_limit split (b: "
        f"1e-5 of Sum |v g|), A symmetric, rows of pad slots only 0; worst |d| "
        f"{ {' '.join(k): round(v, 9) for k, v in worst.items()} }; "
        f"{'OK' if ok_all else 'FAIL'}")
    return ok_all


def chunk_x0(ch, current):
    """The warm start of one chunk: the rows' current factors, zeros for
    the dummy tail rows."""
    return torch.nn.functional.pad(
        current.index_select(0, ch.rows_real),
        (0, 0, 0, ch.rows.shape[0] - ch.n_real))


def route_of(cs, table_ext, r, p, spans=None):
    """How the wrappers of K7, K1 and K6 at f=256 run a chunk of R rows of
    P slots on this table: (text, S, L)."""
    n_spans, span = cs._chunk_spans(torch.device(DEV, 0), r, p, spans,
                                    **cs.span_plan(table_ext))
    if cs.gram_body(table_ext) == "wgmma":
        return (f"two passes, S={n_spans} span(s) of {span} slots, pass 1 "
                f"on the tensor cores", n_spans, span)
    if n_spans > 1:
        return (f"two passes, S={n_spans} spans of {span} slots, pass 1 on "
                f"the FMA body", n_spans, span)
    return "uncut kernel, FMA body", n_spans, span


def fma_note(kernel, label, which=0):
    """The FMA body's earlier time of this kernel on this chunk (FMA_MS),
    as text."""
    old = FMA_MS.get((kernel, label))
    return f"FMA body before: {old[which]:.3f} ms" if old else \
        "FMA body before: not measured"


def check_fused_256(cs, table_ext, ch, current, cfg, label, f2=None,
                    chunk=None):
    """K7 (with f2) or K1 at f=256 on one chunk of a 256-lane table, as
    the wrapper routes it (a bf16 table: the two passes, pass 1 on the
    tensor cores; a float32 table: the uncut kernel, or the cut on a
    chunk with fewer rows than the card has SMs): kernel vs the uncut
    plain version, limits as K1's; K7's dead lanes and empty rows must be
    exactly 0. The bound counts the live lanes (`wide_work`): 128 + f2
    for K7, 256 for K1, whatever body runs it. `chunk` names the chunk in
    FMA_MS, whose time is printed beside."""
    x0 = chunk_x0(ch, current)
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    if f2 is None:
        name, live, key = "K1 gather_gram_cg f=256", 256, "K1"
        fn, plain_fn = cs.gather_gram_cg, cs.gather_gram_cg_plain
    else:
        name, live, key = f"K7 gather_gram_cg_wide f2={f2}", 128 + f2, "K7"
        args = args + (f2,)
        fn, plain_fn = cs.gather_gram_cg_wide, cs.gather_gram_cg_wide_plain
    x, se = fn(*args, **kw)
    px, pse = plain_fn(*args, **kw)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    zero_ok = bool((x[:, live:] == 0).all()) and \
        bool((x[ch.nnz == 0] == 0).all())
    del px, pse
    ms = queued_ms(lambda: fn(*args, **kw))
    plain = queued_ms(lambda: plain_fn(*args, **kw), reps=3)
    r, p = ch.cols.shape
    read, flops = wide_work(table_ext, ch, live)
    bms, by = bound_ms(read + r * live * 4 + nbytes(x, se), flops,
                       table_ext.dtype)
    ok = err <= 2e-3 and se_rel <= 1e-3 and zero_ok
    route = route_of(cs, table_ext, r, p)[0]
    log(f"[{name}] {label} chunk R={r} P={p}, table {table_ext.dtype} "
        f"({route}): max|dx|={err:.3e} (limit 2e-3), max rel dse="
        f"{se_rel:.3e} (limit 1e-3), dead lanes and empty rows exactly 0: "
        f"{zero_ok}; device time {ms:.3f} ms ({fma_note(key, chunk)}), "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None, shape=[r, p],
                    body=cs.gram_body(table_ext))


def gathered_slabs(table_ext, ch, f2):
    """G of one chunk, gathered with torch into the two lane slabs K8
    takes: g1 (R, P, 128) and the packed g2 (R, P, f2)."""
    r, p = ch.cols.shape
    idx = ch.cols.reshape(-1).long()
    g1 = table_ext[:, :128].index_select(0, idx).reshape(r, p, 128)
    g2 = table_ext[:, 128:128 + f2].index_select(0, idx).reshape(r, p, f2)
    return g1, g2


def check_k8(cs, table_ext, ch, current, cfg, f2, label):
    """K8 on the gathered G of one theta chunk, G gathered from the bf16
    table and from a float32 copy of it: each against its plain version
    (x 2e-3, se 1e-3 relative); the bf16 G (the two passes) equal bit
    for bit to K1 at f=256 as routed on the bf16 table (-0 equals +0),
    the float32 G (the FMA kernel) against K1's uncut kernel at f=256 on
    the float32 copy (rtol 1e-5 + 1e-6: the same FMA body). The float32
    numbers fill the entry (the kernel of csrc/fused_gram_cg_cat.cu,
    whose launches it counts), the bf16 ones (the two passes) go under
    bf16_*."""
    x0 = chunk_x0(ch, current)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    r, p = ch.cols.shape
    ok_all, out = True, {}
    for table in (table_ext, table_ext.float()):
        g1, g2 = gathered_slabs(table, ch, f2)
        args = (g1, g2, ch.vals, ch.nnz, x0, cfg.lam)
        x, se = cs.fused_gram_cg_cat(*args, **kw)
        px, pse = cs.fused_gram_cg_cat_plain(*args, **kw)
        err = (x - px).abs().max().item()
        se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
        del px, pse
        if cs.cat_body(g1.dtype, f2) == "wgmma":
            mx, mse = cs.gather_gram_cg(table, ch.cols, ch.vals, ch.nnz, x0,
                                        cfg.lam, **kw)
            same_ok = torch.equal(x, mx) and torch.equal(se, mse)
            same = f"equal to K1 at f=256 routed on the bf16 table: {same_ok}"
            route = "two passes, pass 1 on the tensor cores"
        else:
            mx, mse = cs.gather_gram_cg(table, ch.cols, ch.vals, ch.nnz, x0,
                                        cfg.lam, spans=1, **kw)
            same_ok = bool(((x - mx).abs() <= 1e-5 * mx.abs() + 1e-6).all()) \
                and bool(((se - mse).abs() <= 1e-5 * mse.abs() + 1e-6).all())
            same = (f"against K1's uncut kernel at f=256 max|dx|="
                    f"{(x - mx).abs().max().item():.3e} (limit rtol 1e-5 + "
                    f"1e-6: {same_ok})")
            route = "uncut FMA kernel"
        del mx, mse
        ms = time_ms(lambda: cs.fused_gram_cg_cat(*args, **kw))
        plain = time_ms(lambda: cs.fused_gram_cg_cat_plain(*args, **kw),
                        reps=3)
        slots = float(r * p)   # the Gram's upper triangle over every slot
        bms, by = bound_ms(nbytes(g1, g2, ch.vals, ch.nnz, x0, x, se),
                           slots * 256 * (256 + 8) + 2.0 * slots * 256,
                           g1.dtype)
        ok = err <= 2e-3 and se_rel <= 1e-3 and same_ok
        before = f"before: {BEFORE_MS['K8']:.3f} ms" if \
            g1.dtype == torch.bfloat16 and label == "theta most populous" \
            else "before: not measured"
        log(f"[K8 fused_gram_cg_cat f2={f2}] {label} chunk R={r} P={p}, G "
            f"{g1.dtype} ({route}): max|dx|={err:.3e} (limit 2e-3), max "
            f"rel dse={se_rel:.3e} (limit 1e-3), {same}; kernel {ms:.3f} ms "
            f"({before}), plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
            f"{'OK' if ok else 'FAIL'}")
        ok_all &= ok
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                   bound_by=by, library_ms=None)
        prefix = "" if g1.dtype == torch.float32 else "bf16_"
        out.update({f"{prefix}{k}": v for k, v in res.items()})
        del g1, g2, args, x, se, table
    return ok_all, out


def queued_each(calls):
    """Device time of each of `calls`, launched in turn behind a run of
    large matrix products so that the events between them read device
    time (a chunk's kernel can be shorter than the host's work to launch
    it); each runs once before as a warm-up (the first launch of a kernel
    loads it, and a new size of scratch would reach cudaMalloc, which can
    wait for the device)."""
    for call in calls:   # loads the kernels, fills the allocator's cache
        call()
    torch.cuda.synchronize()
    keep_busy(80)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(calls) + 1)]
    marks[0].record()
    for i, call in enumerate(calls):
        call()
        marks[i + 1].record()
    queued = not marks[0].query()   # the device had not reached them yet
    torch.cuda.synchronize()
    if not queued:
        raise AssertionError("the launches did not queue behind the matrix "
                             "products: the events between them would "
                             "read the host's time")
    return [marks[i].elapsed_time(marks[i + 1]) for i in range(len(calls))]


def split_by_rows(times, chunks, sms):
    """Sum of per-chunk times, and of those of the chunks with fewer rows
    than `sms` (the card's SMs, or the blocks of a body that fit it: one
    block takes one row at a time, so those leave SMs idle unless cut),
    with the longest four of them, ms and (R, P)."""
    split = dict(total=sum(times), few=0.0, n_few=0, sms=sms,
                 widest=max(c.cols.shape[1] for c in chunks))
    few = []
    for ms, ch in zip(times, chunks):
        if ch.cols.shape[0] < sms:
            split["few"] += ms
            split["n_few"] += 1
            few.append((ms, tuple(ch.cols.shape)))
    split["longest_few"] = sorted(few, reverse=True)[:4]
    return split


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def gram_shape(c):
    """(R, P) of the K2 or K5a call on chunk or step `c`: a device
    chunk's cols, else its rows (an aligned step's per rank, a lazy
    one's count) and width."""
    cols = getattr(c, "cols", None)
    if torch.is_tensor(cols):
        return tuple(cols.shape)
    r = getattr(c, "_r", None)
    return (int(r) if r is not None else int(c.rows.shape[-1]),
            int(c.width))


def span_sums(cs, shapes, f, iters=1, dtype=torch.bfloat16):
    """Launches of K2's and K5a's pass 2 (`gram_span_sum`) over `iters`
    iterations of calls on chunks of these (R, P) shapes with a table of
    `dtype` at width f: one a call on a chunk `cs.gram_spans` cuts."""
    sms = sm_count()
    return iters * sum(cs.gram_spans(r, p, f, sms, dtype) > 1
                       for r, p in shapes)


def cut_runner(cs, table_ext, ch, x0, cfg, f2):
    """fn(spans=None) solving one chunk through K7 (with f2) or K1 at
    f=256, and the kernel's name and live lanes."""
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    if f2 is None:
        return (lambda spans=None: cs.gather_gram_cg(*args, spans=spans, **kw),
                "gather_gram_cg", 256)
    return (lambda spans=None: cs.gather_gram_cg_wide(*args, f2, spans=spans,
                                                      **kw),
            "gather_gram_cg_wide", 128 + f2)


def check_cut(cs, table_ext, ch, current, cfg, label, f2=None):
    """The row cut of K7 (with f2) or of K1 at f=256 on one chunk with
    fewer rows than the card has SMs, as the wrapper chooses it
    (`row_spans` in the pass-1 body's tiles): the launch counts show the
    two passes (pass 1 on the tensor cores for a bf16 table) and not the
    uncut kernel; x within 2e-3 and se within 1e-3 relative of the plain
    cut route and of the uncut kernel (on a bf16 table: on a float32
    copy of it, the FMA body); rows without ratings and K7's dead lanes
    exactly 0. The cut, one span a row (spans=1; on a bf16 table the two
    passes at S = 1) and the plain route timed as device time
    (`queued_ms`), the FMA body's earlier times beside."""
    x0 = chunk_x0(ch, current)
    r, p = ch.cols.shape
    route, n_spans, span = route_of(cs, table_ext, r, p)
    fn, name, fl = cut_runner(cs, table_ext, ch, x0, cfg, f2)
    pass1 = "wide_span_gram_mma" if cs.gram_body(table_ext) == "wgmma" \
        else "wide_span_gram"
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    cs.reset_launch_counts()
    x, se = fn()
    torch.cuda.synchronize()
    took = n_spans > 1 and cs.LAUNCHES[pass1] == 1 and \
        cs.LAUNCHES["wide_span_solve"] == 1 and cs.LAUNCHES[name] == 0
    px, pse = cs.row_cut_plain(table_ext, ch.cols, ch.vals, ch.nnz, x0,
                               cfg.lam, fl, n_spans, span, **kw)
    ux, use = cut_runner(cs, table_ext.float(), ch, x0, cfg, f2)[0](spans=1)

    def errs(x2, se2):
        return ((x - x2).abs().max().item(),
                ((se - se2).abs() / se2.abs().clamp_min(1.0)).max().item())

    err, se_rel = errs(px, pse)
    uerr, use_rel = errs(ux, use)
    empty = ch.nnz == 0
    zero_ok = bool((x[:, fl:] == 0).all()) and bool((x[empty] == 0).all()) \
        and bool((se[empty] == 0).all())
    del px, pse, ux, use
    ms = queued_ms(fn)
    uncut = queued_ms(lambda: fn(spans=1))
    plain = queued_ms(lambda: cs.row_cut_plain(
        table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam, fl, n_spans,
        span, **kw), reps=3)
    read, flops = wide_work(table_ext, ch, fl)
    bms, by = bound_ms(read + r * fl * 4 + nbytes(x, se), flops,
                       table_ext.dtype)
    ok = took and zero_ok and max(err, uerr) <= 2e-3 and \
        max(se_rel, use_rel) <= 1e-3
    tag = "K1 gather_gram_cg f=256" if f2 is None else \
        f"K7 gather_gram_cg_wide f2={f2}"
    key = "K1" if f2 is None else "K7"
    one = route_of(cs, table_ext, r, p, spans=1)[0]
    log(f"[cut {tag}] {label} chunk R={r} P={p}: {route}, the two passes "
        f"launched and not the uncut kernel: {took}; against the plain cut "
        f"route max|dx|={err:.3e}, max rel dse={se_rel:.3e}; against the "
        f"uncut FMA kernel (float32 table) max|dx|={uerr:.3e}, max rel dse="
        f"{use_rel:.3e} (limits 2e-3, 1e-3); dead lanes and empty rows "
        f"exactly 0: {zero_ok}; device time: cut {ms:.3f} ms "
        f"({fma_note(key, label)}), one span a row ({one}) {uncut:.3f} ms "
        f"({fma_note(key, label, 1)} uncut), "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(ms=ms, uncut_ms=uncut, plain_ms=plain, bound_ms=bms,
                    bound_by=by, max_abs_err=err, spans=n_spans,
                    span_len=span, shape=[r, p])


def check_span_passes(cs, table_ext, ch, current, cfg, f2, label):
    """Each pass of the row cut alone on one chunk (K7's lanes), with the
    spans `row_spans` gives it in the tiles of the body that takes the
    table. Pass 1 (`span_grams`: on the tensor cores for a bf16 table, on
    the FMA body for a float32 one) against `span_gram_plain`, read
    through the record layout of csrc/wide.cuh (`span_record_unpack`):
    every live span's A within `gram_limit`'s steps for a span's slots in
    that body, b and r2 within rtol 1e-5 + 1e-5. Pass 2 (`span_solve`) on
    pass 1's own records against `span_solve_plain` on the same records
    unpacked: x within 2e-3, se within 1e-3 relative. Returns the
    kernels-line entries of the two passes, keyed by kernel name."""
    fl = 128 + f2
    x0 = chunk_x0(ch, current)
    r, p = ch.cols.shape
    _, n_spans, span = route_of(cs, table_ext, r, p)
    body = cs.gram_body(table_ext)
    pass1 = "wide_span_gram_mma" if body == "wgmma" else "wide_span_gram"
    gargs = (table_ext, ch.cols, ch.vals, ch.nnz, fl, n_spans, span)
    part = cs.span_grams(*gargs)
    live = cs._span_live(ch.nnz, p, n_spans, span)
    plain_parts = [cs.span_gram_plain(table_ext, ch.cols, ch.vals, ch.nnz,
                                      k * span, (k + 1) * span, fl)
                   for k in range(n_spans)]
    pa = torch.stack([q[0] for q in plain_parts], dim=1)[live]
    pb = torch.stack([q[1] for q in plain_parts], dim=1)[live]
    pr2 = torch.stack([q[2] for q in plain_parts], dim=1)[live]
    del plain_parts
    a, b, r2 = cs.span_record_unpack(part[live], fl)
    lim, limit = gram_limit(a, pa, span, body)
    diff = (a - pa).abs()
    a_err = diff.max().item()
    a_ok = bool((diff <= lim).all())
    b_ok = bool(((b - pb).abs() <= 1e-5 * pb.abs() + 1e-5).all()) and \
        bool(((r2 - pr2).abs() <= 1e-5 * pr2.abs() + 1e-5).all())
    n_live = int(live.sum().item())
    del lim, diff, a, b, r2, pa, pb, pr2
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    x, se = cs.span_solve(part, ch.nnz, x0, cfg.lam, p, span, **kw)
    ua, ub, ur2 = cs.span_record_unpack(
        torch.where(live[:, :, None], part, torch.zeros_like(part)), fl)
    card_parts = [(ua[:, k], ub[:, k], ur2[:, k]) for k in range(n_spans)]
    px, pse = cs.span_solve_plain(card_parts, ch.nnz, x0, cfg.lam, **kw)
    x_err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    del px, pse
    ms1 = queued_ms(lambda: cs.span_grams(*gargs))
    plain1 = queued_ms(lambda: [cs.span_gram_plain(
        table_ext, ch.cols, ch.vals, ch.nnz, k * span, (k + 1) * span, fl)
        for k in range(n_spans)], reps=3)
    ms2 = queued_ms(lambda: cs.span_solve(part, ch.nnz, x0, cfg.lam, p,
                                          span, **kw))
    plain2 = queued_ms(lambda: cs.span_solve_plain(
        card_parts, ch.nnz, x0, cfg.lam, **kw), reps=3)
    del ua, ub, ur2, card_parts, part
    rec_bytes = n_live * cs.span_record_floats(fl) * 4
    read, flops = wide_work(table_ext, ch, fl)
    b1, by1 = bound_ms(read + rec_bytes, flops, table_ext.dtype)
    # pass 2: the records once, and the CG's cg_iters + 2 matvecs a row
    b2, by2 = bound_ms(rec_bytes + nbytes(ch.nnz, x, se) + r * fl * 4,
                       r * (cfg.cg_iters + 2) * 2.0 * fl * fl, torch.float32)
    ok1 = a_ok and b_ok
    ok2 = x_err <= 2e-3 and se_rel <= 1e-3
    log(f"[span passes f2={f2}] {label} chunk R={r} P={p}, table "
        f"{table_ext.dtype}, S={n_spans} spans of {span} slots, {n_live} "
        f"live: pass 1 ({pass1}, body {body}) max|dA|={a_err:.3e} (limit "
        f"{limit}: {a_ok}), b and r2 within rtol 1e-5 + 1e-5: {b_ok}; pass "
        f"2 on the same records max|dx|={x_err:.3e}, max rel dse="
        f"{se_rel:.3e} (limits 2e-3, 1e-3); device time: pass 1 {ms1:.3f} "
        f"ms ({fma_note('pass 1', label)}; plain {plain1:.3f}, bound "
        f"{b1:.4f} ms, {by1}), pass 2 {ms2:.3f} ms "
        f"({fma_note('pass 2', label)}; plain {plain2:.3f}, bound {b2:.4f} "
        f"ms, {by2}); {'OK' if ok1 and ok2 else 'FAIL'}")
    return ok1 and ok2, {
        pass1: dict(max_abs_err=a_err, ms=ms1, plain_ms=plain1,
                    bound_ms=b1, bound_by=by1, library_ms=None,
                    shape=[r, p], spans=n_spans, span_len=span),
        "wide_span_solve": dict(max_abs_err=x_err, ms=ms2, plain_ms=plain2,
                                bound_ms=b2, bound_by=by2, library_ms=None,
                                shape=[r, p], spans=n_spans, span_len=span)}


def span_gram_edges(cs):
    """The tensor-core pass 1 against `span_gram_plain` on the card
    tests' integer tables (`span_int_chunk` of tests/test_torch_cuda.py:
    small integers in lanes < FL, NaN above, rows that stop at nnz 0, 1,
    63, 64, 65 and P): bit for bit (every sum is exact), at FL = 160, 192,
    224, 256, P = 63, 64, 65, 127, 129 (`SPAN_P`), one span a row and a
    forced cut of two; the proof of its tiling, record layout and
    zero-fill."""
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import SPAN_P, span_int_chunk
    ok_all, n = True, 0
    for p in SPAN_P:
        for fl in (160, 192, 224, 256):
            table, cols, vals, nnz = (t.to(DEV) for t in
                                      span_int_chunk(fl, p))
            for spans in (1, 2):
                n_spans, span = cs._cut(-(-p // 64), spans, 64)
                part = cs.span_grams(table, cols, vals, nnz, fl, n_spans,
                                     span)
                live = cs._span_live(nnz, p, n_spans, span)
                a, b, r2 = cs.span_record_unpack(part[live], fl)
                want = [cs.span_gram_plain(table, cols, vals, nnz, k * span,
                                           (k + 1) * span, fl)
                        for k in range(n_spans)]
                pa, pb, pr2 = (torch.stack([w[i] for w in want], dim=1)[live]
                               for i in range(3))
                ok = torch.equal(a, pa) and torch.equal(b, pb) and \
                    torch.equal(r2, pr2)
                if not ok:
                    log(f"[span gram edges] FAIL FL={fl} P={p} S={n_spans}: "
                        f"max|dA|={(a - pa).abs().max().item():.3e}")
                ok_all &= ok
                n += 1
    log(f"[span gram edges] the tensor-core pass 1 on integer tables, "
        f"{n} cases (FL = 160, 192, 224, 256; P = {SPAN_P}; S = 1 and 2; "
        f"NaN in lanes >= FL): equal to span_gram_plain bit for bit: "
        f"{ok_all}; {'OK' if ok_all else 'FAIL'}")
    return ok_all


def span_edges(cs, lam=0.048):
    """The row cut forced at the S and P of the card tests (`CUTS` of
    tests/test_torch_cuda.py: S = 2, 3, 7) on their chunks (`cut_chunk`:
    rows that stop at nnz 0, 1, 31, 32, 33, on the span edge, one past it
    and at P, and a dummy tail row), for T = 20, 24, 28, 32 (K7 at f2 =
    32, 64, 96, 128) and K1 at f=256, f32 and bf16 tables (spans of whole
    tiles of the pass-1 body: 32 slots on the FMA body, 64 on the tensor
    cores): against the plain cut route and one span a row (spans=1),
    x within 2e-3, se within 1e-3 relative; empty rows and dead lanes
    exactly 0; a second run bit for bit."""
    from pathlib import Path
    from types import SimpleNamespace
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import CUTS, cut_chunk
    cfg = SimpleNamespace(lam=lam, cg_iters=6, cg_tol=1e-4)
    kw = dict(cg_iters=6, cg_tol=1e-4)
    worst = [0.0, 0.0, 0.0, 0.0]
    ok_all = True
    for p, spans in CUTS:
        for f_true, f2 in ((130, 32), (161, 64), (200, 96), (256, 128),
                           (200, None)):
            for dtype in (torch.float32, torch.bfloat16):
                tile = 64 if dtype == torch.bfloat16 else 32
                n_spans, span = cs._cut(-(-p // tile), spans, tile)
                table, cols, vals, nnz, x0 = (t.to(DEV) for t in cut_chunk(
                    f_true, dtype, p, span, seed=f_true))
                ch = SimpleNamespace(cols=cols, vals=vals, nnz=nnz)
                fn, _, fl = cut_runner(cs, table, ch, x0, cfg, f2)
                x, se = fn(spans=n_spans)
                px, pse = cs.row_cut_plain(table, cols, vals, nnz, x0, lam,
                                           fl, n_spans, span, **kw)
                ux, use = fn(spans=1)
                x2, se2 = fn(spans=n_spans)
                e = [(x - px).abs().max().item(),
                     ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item(),
                     (x - ux).abs().max().item(),
                     ((se - use).abs() / use.abs().clamp_min(1.0)).max().item()]
                worst = [max(w, v) for w, v in zip(worst, e)]
                ok = max(e[0], e[2]) <= 2e-3 and max(e[1], e[3]) <= 1e-3 \
                    and torch.equal(x, x2) and torch.equal(se, se2) and \
                    bool((x[:, fl:] == 0).all()) and \
                    bool((x[nnz == 0] == 0).all()) and \
                    bool((se[nnz == 0] == 0).all())
                if not ok:
                    log(f"[span edges] FAIL P={p} S={n_spans} f_true="
                        f"{f_true} f2={f2} {dtype}: {e}")
                ok_all &= ok
    log(f"[span edges] the cut forced at S = 2, 3, 7 (P = 300, 300, 448), "
        f"rows of nnz (0, 1, 31, 32, 33, L, L + 1, P) and a dummy tail row, "
        f"K7 at f2 = 32, 64, 96, 128 and K1 at f=256, f32 and bf16 tables: "
        f"worst against the plain cut route max|dx|={worst[0]:.3e}, max rel "
        f"dse={worst[1]:.3e}, against one span a row {worst[2]:.3e}, "
        f"{worst[3]:.3e} (limits 2e-3, 1e-3); repeats bit for bit, empty "
        f"rows and dead lanes exactly 0; {'OK' if ok_all else 'FAIL'}")
    return ok_all


def wide_synthetic(cs, lam=0.048):
    """K7 (f2 = 96) and K1 at f=256 on seeded few-row chunks at the
    shapes of the Netflix F=200 plans' few-row chunks (the widest theta
    chunk R=8 P=8192, split X chunks of about 32 rows, one long row),
    each row of between P/2 and P ratings over a bf16 table: the cut the
    wrapper chooses (pass 1 on the tensor cores) against the uncut FMA
    kernel on a float32 copy of the table (x within 2e-3, se within 1e-3
    relative; one span a row on the tensor cores is no reference for a
    long row, PERF.md), and the cut and one span a row (spans=1)
    as device time."""
    from types import SimpleNamespace
    gen = torch.Generator(device=DEV).manual_seed(5)
    n = 131072
    tab = (0.2 * torch.rand((n + 1, 256), generator=gen, device=DEV)
           ).to(torch.bfloat16)
    tab[n] = 0
    tab[:, 200:] = 0
    cfg = SimpleNamespace(lam=lam, cg_iters=6, cg_tol=1e-4)
    ok_all = True
    for r, p in ((8, 8192), (32, 16384), (100, 4096), (1, 241664)):
        nnz = torch.randint(p // 2 + 1, p + 1, (r,), generator=gen,
                            device=DEV, dtype=torch.int32)
        mask = torch.arange(p, device=DEV)[None, :] < nnz[:, None]
        cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                               device=DEV), n)
        vals = torch.randint(2, 11, (r, p), generator=gen, device=DEV) / 2.0
        ch = SimpleNamespace(cols=cols.to(torch.int32),
                             vals=(vals * mask).float(), nnz=nnz)
        x0 = 0.1 * torch.rand((r, 256), generator=gen, device=DEV)
        x0[:, 200:] = 0
        route = route_of(cs, tab, r, p)[0]
        for f2 in (96, None):
            fn, _, _ = cut_runner(cs, tab, ch, x0, cfg, f2)
            x, se = fn()
            ux, use = cut_runner(cs, tab.float(), ch, x0, cfg, f2)[0](spans=1)
            err = (x - ux).abs().max().item()
            se_rel = ((se - use).abs() / use.abs().clamp_min(1.0)).max().item()
            ok = err <= 2e-3 and se_rel <= 1e-3
            ok_all &= ok
            ms = queued_ms(fn)
            uncut = queued_ms(lambda: fn(spans=1))
            log(f"[wide synthetic] {'K7 f2=96' if f2 else 'K1 f=256'} R={r} "
                f"P={p}: {route}; against the uncut FMA kernel (float32 "
                f"table) max|dx|={err:.3e}, max rel dse={se_rel:.3e}; device "
                f"time cut "
                f"{ms:.3f} ms, one span a row {uncut:.3f} ms; "
                f"{'OK' if ok else 'FAIL'}")
    return ok_all


def cut_totals(cs, label, chunks, table, current, cfg, f2):
    """Device time of K7 (with f2) or of K1 at f=256 over one phase's
    chunks (`queued_each`), as the wrappers choose (the cut on chunks
    with fewer rows than the card has SMs) and with one span a row
    (spans=1; on a float32 table the uncut kernel), each split by chunks
    under and over the SM count, with the spans chosen for each chunk
    under it; the FMA body's earlier times as routed beside."""
    sms = sm_count()
    x0s = [chunk_x0(ch, current) for ch in chunks]
    runs = [cut_runner(cs, table, ch, x0, cfg, f2)[0]
            for ch, x0 in zip(chunks, x0s)]
    cut = queued_each(runs)
    uncut = queued_each([lambda fn=fn: fn(spans=1) for fn in runs])
    del x0s, runs
    few = [i for i, ch in enumerate(chunks) if ch.cols.shape[0] < sms]
    spans = [route_of(cs, table, *chunks[i].cols.shape)[1] for i in few]
    tot = dict(cut=sum(cut), uncut=sum(uncut), n=len(chunks), n_few=len(few),
               cut_few=sum(cut[i] for i in few),
               uncut_few=sum(uncut[i] for i in few),
               spans=sorted(set(spans)))
    longest = sorted(((uncut[i], cut[i], tuple(chunks[i].cols.shape), sp)
                      for i, sp in zip(few, spans)), reverse=True)[:4]
    kern = "K1 f=256" if f2 is None else f"K7 f2={f2}"
    old = FMA_MS[("K1" if f2 is None else "K7", "phase totals")][
        0 if label == "theta" else 1]
    log(f"[wide phase totals] {kern} over the {len(chunks)} {label} chunks, "
        f"table {table.dtype} (body {cs.gram_body(table)}): as routed "
        f"{tot['cut']:.1f} ms (FMA body before: {old} ms), of which "
        f"{tot['cut_few']:.1f} ms in the {len(few)} chunks with fewer than "
        f"{sms} rows (cut) and {tot['cut'] - tot['cut_few']:.1f} ms in the "
        f"others; one span a row {tot['uncut']:.1f} ms, of which "
        f"{tot['uncut_few']:.1f} ms in those {len(few)} chunks; spans chosen "
        f"under {sms} rows: {tot['spans']}; the longest of them with one "
        f"span a row (ms one span, ms cut, (R, P), S): "
        f"{[(round(u, 3), round(c, 3), rp, sp) for u, c, rp, sp in longest]}"
        f" (device time between events, launches queued behind other work)")
    return tot


def phase_totals(cs, al, theta_t, x_t):
    """Device time of one phase's kernel chunk by chunk (`queued_each`),
    split by chunks with fewer rows than the blocks of its body that fit
    the card (264 at f = 128 on an H100): the fused kernel (K1, or K6
    when the config takes the augmented form) over the theta phase, from
    the warm starts of theta_t's shape, as routed and uncut (spans=1,
    under "uncut"); the Gram kernel alone (K2 or K5a) over the X phase
    (the panels' tables made outside the timing), as routed and uncut,
    with the bytes gathered and written; and the X phase's whole Gram
    step (that kernel + the index_add_ scatter into the accumulators)."""
    cfg = al.cfg
    f = cfg.f_pad
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = cs.gram_blocks_per_sm(f) * sms

    table_ext = torch.cat([x_t.to(torch.bfloat16),
                           x_t.new_zeros((1, f), dtype=torch.bfloat16)])
    aug_direct = cs.aug_enabled(cfg)
    chunks_t = al.plan_theta[1]
    x0s = [torch.zeros((ch.rows.shape[0], f), device="cuda")
           for ch in chunks_t]

    def theta_times(spans):
        return split_by_rows(queued_each([
            lambda ch=ch, x0=x0: cs.gather_gram_cg(
                table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam,
                cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol, aug=aug_direct,
                spans=spans)
            for ch, x0 in zip(chunks_t, x0s)]), chunks_t, resident)
    theta = theta_times(None)
    theta["uncut"] = theta_times(1)
    theta["n_cut"] = sum(cs.theta_spans(*ch.cols.shape, f, sms) > 1
                         for ch in chunks_t)
    del x0s, table_ext

    plan, chunks, _ = al.plan_x
    s = plan.panel_size
    th16 = torch.nn.functional.pad(theta_t.to(torch.bfloat16),
                                   (0, 0, 0, plan.n_panels * s -
                                    theta_t.shape[0]))
    zero = th16.new_zeros((1, f))
    a_dtype = al._accum_dtype(sum(c.rows.shape[0] for c in chunks),
                              plan.num_rows)
    gram = cs.gather_gram_aug_out if al._use_panel_aug() else \
        cs.gather_gram_out
    tables = {p: torch.cat([th16[p * s:(p + 1) * s], zero])
              for p in sorted({ch.panel for ch in chunks})}

    def x_times(spans):
        return split_by_rows(queued_each([
            lambda ch=ch: gram(tables[ch.panel], ch.cols, ch.vals,
                               out_dtype=a_dtype, spans=spans)
            for ch in chunks]), chunks, resident)
    split, uncut = x_times(None), x_times(1)
    split["uncut"] = uncut
    split["n_cut"] = sum(cs.gram_spans(*ch.cols.shape, f, sms) > 1
                         for ch in chunks)
    del tables
    a_item = torch.tensor([], dtype=a_dtype).element_size()
    split["gathered"] = sum(ch.cols.numel() * f * 2 for ch in chunks)
    split["written"] = sum(ch.cols.shape[0] * f * f * a_item
                           for ch in chunks)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    al.accumulate_panels(theta_t, al.plan_x)
    end.record()
    end.synchronize()
    return theta, split, start.elapsed_time(end)


def full_width(cs, model, label, expect, absent, x0, th0, iters=ITERS,
               exact=None):
    """One full-width path: ALS.run with every launch count read around
    it alone (each kernel of `expect` at least once an iteration, each of
    `absent` never, each of `exact` as often as it says); a path of
    RECORDED_TRAIN_RMSE must reach that train RMSE after its last
    iteration (within 1e-3) and lower its test RMSE."""
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launch_counts()
    res = model.run(x0, th0)
    torch.cuda.synchronize()
    launches = dict(cs.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_iter = [h.x_seconds + h.theta_seconds for h in res.history]
    for h in res.history:
        log(f"[{label}] iter {h.iteration}: x {h.x_seconds:.4f} s, "
            f"theta {h.theta_seconds:.4f} s, rmse {h.rmse_seconds:.4f} "
            f"s, train {h.train_rmse:.6f}, test {h.test_rmse:.6f}")
    log(f"[{label}] seconds per iteration (x + theta): "
        f"{[round(t, 4) for t in per_iter]}, median "
        f"{statistics.median(per_iter):.4f}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    tr = [h.train_rmse for h in res.history]
    if len(tr) != iters or \
            not np.all(np.isfinite(tr + [h.test_rmse for h in res.history])):
        raise AssertionError(f"{label}: non-finite RMSE")
    if not tr[-1] < tr[0]:
        raise AssertionError(f"{label}: train RMSE did not fall")
    if label in RECORDED_TRAIN_RMSE:
        want = RECORDED_TRAIN_RMSE[label]
        te = [h.test_rmse for h in res.history]
        log(f"[{label}] train RMSE after iteration {iters} {tr[-1]:.6f}, "
            f"recorded {want} (limit 1e-3); test RMSE "
            f"{[round(t, 6) for t in te]}")
        if abs(tr[-1] - want) > 1e-3 or not te[-1] < te[0]:
            raise AssertionError(f"{label}: the RMSE trajectory moved")
    for name in expect:
        if launches[name] < iters:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times in "
                f"{iters} iterations")
    for name in absent:
        if launches[name]:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times on a "
                f"path that does not run it")
    for name, want in (exact or {}).items():
        if launches[name] != want:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times, the "
                f"plans say {want}")
    return res.history, launches


# iterations of phases 4c and 13e (the float32 default configuration)
F32_ITERS = 2


def k1_launches(cs, chunks, f, iters=1, dtype=torch.float32):
    """Launches of K1 over `iters` iterations of calls on these chunks with
    a table of `dtype` at width f (f = 128: the uncut kernel on a float32
    table, `cs.theta_spans`; f = 256: the uncut kernel, or on a chunk the
    row cut takes, `cs._chunk_spans`, its two passes once a row batch of
    `cs.row_batches`): {kernel: launches}."""
    plan = cs.span_plan(torch.zeros((1, f), dtype=dtype))
    out = dict.fromkeys(("gather_gram_cg", "wide_span_gram",
                         "wide_span_solve"), 0)
    for ch in chunks:
        r, p = ch.cols.shape
        if f == 256:
            spans, _ = cs._chunk_spans(torch.device(DEV, 0), r, p, None,
                                       **plan)
            if spans > 1:
                batches = -(-r // cs.row_batches(spans, f))
                out["wide_span_gram"] += batches
                out["wide_span_solve"] += batches
                continue
        out["gather_gram_cg"] += 1
    return {k: v * iters for k, v in out.items()}


def f32_default(cs, model, hist_ref, x0, th0, results, phase="4c",
                ref_label="aug", key="f32_default"):
    """Phase 4c (or, at F=200, 13e): the `ALSConfig` default (factor_dtype
    and gram_dtype "f32", aug_gram "auto") on the plans of `model` (4b's,
    or 13d's; no plan depends on those fields; the routes are asserted):
    the panel-aug X route, K5a on the float32 table (the split body,
    csrc/split_gram_mma.cuh at f = 128, csrc/wide_split_mma.cuh at 256)
    and K5b; K1 on the float32 table of direct theta (at f = 128 the
    uncut FMA body; at 256 the uncut kernel, or the row cut's two FMA
    passes on a chunk of fewer rows than SMs). First K5a's device time
    over every X chunk on the float32 initial factors' panels, as routed
    and uncut (spans=1, this call), and at 256 K2 and K5a on the
    fewest-row X chunk the cut takes, three ways (`check_gram`); then
    ALS.run for F32_ITERS iterations: K5a once a chunk an iteration,
    `gram_span_sum` once a cut chunk, K1 (or its passes) as
    `k1_launches` says, K5b at least once, no other kernel; train RMSE
    within 2e-3 of `hist_ref` (`ref_label`'s run, bf16 factors on the
    same routes) at each iteration, test RMSE falling. Fills
    results["gather_gram_aug_out"][key]."""
    import copy
    t_start = time.monotonic()
    cfg = model.cfg.replace(factor_dtype="f32", gram_dtype="f32",
                            aug_gram="auto", iters=F32_ITERS)
    al = copy.copy(model)      # the same plans: the dtypes steer no plan
    al.cfg = cfg
    if not (al._phase_strategy(al.train_csr) == "panel" and
            al._phase_strategy(al.train_csc) == "direct" and
            al._use_panel_aug() and not cs.aug_enabled(cfg)):
        raise AssertionError(f"{phase}: expected the panel-aug X route and "
                             f"K1 on direct theta")
    plan, chunks_x, _ = al.plan_x
    chunks_t = al.plan_theta[1]
    f, s = cfg.f_pad, plan.panel_size
    sms = sm_count()
    # the X phase's table at iteration 0: the float32 initial factors
    theta_t = al._pad_f(th0)
    th32 = torch.nn.functional.pad(
        theta_t, (0, 0, 0, plan.n_panels * s - theta_t.shape[0]))
    zero = th32.new_zeros((1, f))
    tables = {p: torch.cat([th32[p * s:(p + 1) * s], zero])
              for p in sorted({ch.panel for ch in chunks_x})}
    a_dtype = al._accum_dtype(sum(c.rows.shape[0] for c in chunks_x),
                              plan.num_rows)
    if cs.panel_body(tables[chunks_x[0].panel]) != "split":
        raise AssertionError(f"{phase}: the X phase's table does not take "
                             f"the split body")

    def x_times(spans):
        return split_by_rows(queued_each([
            lambda ch=ch: cs.gather_gram_aug_out(
                tables[ch.panel], ch.cols, ch.vals, out_dtype=a_dtype,
                spans=spans)
            for ch in chunks_x]), chunks_x, sms)
    routed, uncut = x_times(None), x_times(1)
    cut = [ch for ch in chunks_x
           if cs.gram_spans(*ch.cols.shape, f, sms, torch.float32) > 1]
    n_cut = len(cut)
    gathered = sum(ch.cols.numel() * f * 4 for ch in chunks_x)
    out = dict(x_total_ms=routed["total"], x_few_ms=routed["few"],
               x_uncut_total_ms=uncut["total"], x_uncut_few_ms=uncut["few"],
               n_cut=n_cut, gathered_bytes=gathered,
               x_tb_per_s=gathered / routed["total"] / 1e9)
    ok = True
    if f == 256 and cut:
        # the fewest-row chunk the cut takes, on its float32 panel
        ch = min(cut, key=lambda c: (c.cols.shape[0], -c.cols.shape[1]))
        for aug in (False, True):
            good, res = check_gram(
                cs, tables[ch.panel], ch, a_dtype, aug,
                f"{phase} fewest-row X chunk the cut takes, float32 table "
                f"(the initial factors)", cut=True)
            ok &= good
            out[f"fewest_{'k5a' if aug else 'k2'}"] = {
                k: v for k, v in res.items() if k != "gathered_bytes"}
    del tables, th32, theta_t
    torch.cuda.empty_cache()
    log(f"[phase totals f32 {phase}] K5a (split body) over the "
        f"{len(chunks_x)} X chunks at f={f} on the float32 initial "
        f"factors, A {a_dtype}: "
        f"{routed['total']:.1f} ms, of which {routed['few']:.1f} ms in the "
        f"{routed['n_few']} chunks with fewer than {sms} rows (the longest "
        f"of them, ms and (R, P): "
        f"{[(round(m, 3), rp) for m, rp in routed['longest_few']]}), "
        f"{n_cut} chunks cut; the same uncut (spans=1, this call): "
        f"{uncut['total']:.1f} ms, {uncut['few']:.1f} ms in those chunks; "
        f"gathered {gathered / 1e9:.2f} GB from the L2, "
        f"{gathered / routed['total'] / 1e9:.3f} TB/s over the phase "
        f"(device time between events, launches queued behind other "
        f"work)")
    if not ok:
        raise AssertionError(f"{phase}: K2 or K5a disagrees with its plain "
                             f"version")

    k1 = k1_launches(cs, chunks_t, f, F32_ITERS)
    expect = ("gather_gram_aug_out", "solve_cg_aug")
    absent = ("gather_gram_out", "solve_cg_reg", "solve_cg",
              "gather_gram_cg_aug", SPAN_SOLVE, "wide_span_gram_mma") + \
        WIDE_KERNELS + TILED_KERNELS
    exact = {"gather_gram_aug_out": len(chunks_x) * F32_ITERS,
             SPAN_SUM: span_sums(cs, map(gram_shape, chunks_x), f,
                                 F32_ITERS, torch.float32), **k1}
    label = "f32 default" if phase == "4c" else f"f32 default {phase}"
    hist, launches = full_width(cs, al, label, expect, absent, x0, th0,
                                iters=F32_ITERS, exact=exact)
    worst = 0.0
    for h, r in zip(hist, hist_ref):
        d = abs(h.train_rmse - r.train_rmse)
        worst = max(worst, d)
        log(f"[{label} | {ref_label}] iter {h.iteration}: train "
            f"{h.train_rmse:.6f} | {r.train_rmse:.6f} (limit 2e-3), test "
            f"{h.test_rmse:.6f} | {r.test_rmse:.6f}")
    te = [h.test_rmse for h in hist]
    per_iter = [h.x_seconds + h.theta_seconds for h in hist]
    counted = {k: launches[k] for k in expect + (SPAN_SUM,) + tuple(k1)}
    log(f"[{label}] {F32_ITERS} iterations, X {len(chunks_x)} panel "
        f"chunks ({n_cut} cut), theta {len(chunks_t)} direct chunks; "
        f"s/iter {[round(t, 4) for t in per_iter]}, x "
        f"{[round(h.x_seconds, 4) for h in hist]} s, theta "
        f"{[round(h.theta_seconds, 4) for h in hist]} s; launches "
        f"{counted}; worst train RMSE gap to {ref_label} {worst:.3e}; phase "
        f"{phase} {time.monotonic() - t_start:.1f} s")
    if worst > 2e-3 or not te[-1] < te[0]:
        raise AssertionError(f"{phase}: off {ref_label}'s RMSE")
    results.setdefault("gather_gram_aug_out", {})[key] = dict(
        launches=counted, s_per_iter=per_iter,
        x_seconds=[h.x_seconds for h in hist],
        theta_seconds=[h.theta_seconds for h in hist],
        train_rmse=[h.train_rmse for h in hist], test_rmse=te, **out)
    return hist, launches


def theta_cuts(cs, shapes, f, iters=1):
    """Launches of K1's and K6's pass 2 (`frag_span_solve`) over `iters`
    iterations of calls on chunks of these (R, P) shapes with a bf16
    table at width f: one a call on a chunk `cs.theta_spans` cuts."""
    sms = sm_count()
    return iters * sum(cs.theta_spans(r, p, f, sms) > 1 for r, p in shapes)


def theta_pass_2(cs, model, iters=ITERS):
    """{SPAN_SOLVE: its launches} over `iters` iterations of an ALS whose
    theta phase runs K1 or K6 on the direct route's chunks."""
    return {SPAN_SOLVE: theta_cuts(cs, map(gram_shape, model.plan_theta[1]),
                                   model.cfg.f_pad, iters)}


def ext16(t):
    """A bf16 gather table: t and one zero row."""
    return torch.cat([t.to(torch.bfloat16),
                      t.new_zeros((1, t.shape[1]), dtype=torch.bfloat16)])


def wide_setup(cs, ALS, cfg, train, csc, test):
    """The F=200 model on the Netflix data (f_pad 256, f2 = 96; X on the
    split route, theta direct), its initial factors, and the stand-in
    tables of the kernel checks: returns al, cfg_w, f2, x0_np, th0_np,
    theta_t, x_t, x_ext."""
    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.models import als as als_mod
    from cumf_als_tpu_torch.ops.tiling import SplitPlan, UpdatePlan

    cfg_w = cfg.replace(f=200, wide_kernel="on")
    f2 = cs.wide_f2(cfg_w.f)
    split_s = []
    build_split_plan = als_mod.build_split_plan

    def timed_split_plan(*a, **k):
        t0 = time.monotonic()
        plan = build_split_plan(*a, **k)
        split_s.append(time.monotonic() - t0)
        return plan

    als_mod.build_split_plan = timed_split_plan
    try:
        al = ALS(cfg_w, train, csc, test, device=DEV)
    finally:
        als_mod.build_split_plan = build_split_plan
    plan_x, chunks_x, aux_x = al.plan_x
    sms = sm_count()
    log(f"[wide] F={cfg_w.f} f_pad={cfg_w.f_pad} f2={f2}: plans "
        f"{al.plan_seconds:.1f} s, of which the numpy build_split_plan "
        f"{sum(split_s):.1f} s; X phase: {type(plan_x).__name__} "
        f"({len(chunks_x)} chunks, {plan_x.n_parts} parts of "
        f"{plan_x.part_size} rows, expansion {plan_x.expansion:.3f}; "
        f"{sum(c.cols.shape[0] < sms for c in chunks_x)} chunks under {sms} "
        f"rows), theta phase: {type(al.plan_theta[0]).__name__} "
        f"({len(al.plan_theta[1])} chunks; "
        f"{sum(c.cols.shape[0] < sms for c in al.plan_theta[1])} under "
        f"{sms} rows)")
    if not (isinstance(plan_x, SplitPlan) and plan_x.n_parts == 4 and
            plan_x.part_size == 131072 and
            isinstance(al.plan_theta[0], UpdatePlan) and
            cs.wide_enabled(cfg_w) and cfg_w.f_pad == 256):
        raise AssertionError("expected the split X route with 4 parts of "
                             "131072 rows and the direct theta route")
    x0_np, th0_np = init_factors(cfg_w.m, cfg_w.n, cfg_w.f, seed=0)
    gen = torch.Generator(device=DEV).manual_seed(2)
    theta_t = al._pad_f(th0_np)
    # a stand-in X for the theta-phase table: the real X starts at zero
    x_t = al._pad_f(0.2 * torch.rand((cfg_w.m, cfg_w.f), generator=gen,
                                     device=DEV).cpu().numpy())
    return al, cfg_w, f2, x0_np, th0_np, theta_t, x_t, ext16(x_t)


def cut_checks(cs, al, cfg_w, f2, theta_t, x_t, x_ext):
    """The row cut on the few-row chunks of the F=200 plans: the split X
    chunk with the fewest rows, the split X chunk under the SM count
    nearest 32 rows, and the widest theta chunk, each for K7 and K1 at
    f=256 (`check_cut`); each pass alone (`check_span_passes`) on the
    chunk of about 32 rows with the bf16 table (pass 1 on the tensor
    cores) and a float32 copy of it (pass 1 on the FMA body), and on the
    most populous theta chunk (one span a row, the tensor cores). Returns
    (ok, the passes' kernels-line entries, the cut results by chunk)."""
    sms = sm_count()
    chunks_x = al.plan_x[1]
    few_x = [c for c in chunks_x if c.cols.shape[0] < sms]
    picks = (("split X fewest rows", "x",
              min(chunks_x, key=lambda c: (c.cols.shape[0], -c.width))),
             ("split X about 32 rows", "x",
              min(few_x, key=lambda c: (abs(c.cols.shape[0] - 32),
                                        -c.width))),
             ("theta widest", "theta",
              max(al.plan_theta[1], key=lambda c: c.width)))
    th_perm_ext = ext16(theta_t.index_select(0, al.plan_x[2]["perm"]))
    tables = {"x": (th_perm_ext, x_t), "theta": (x_ext, theta_t)}
    ok_all = True
    cuts = {}
    for label, phase, ch in picks:
        table, current = tables[phase]
        for kf2 in (f2, None):
            ok, res = check_cut(cs, table, ch, current, cfg_w, label, f2=kf2)
            ok_all &= ok
            cuts[f"{'K7' if kf2 else 'K1_f256'} {label}"] = res
    ok, cut32 = check_span_passes(cs, th_perm_ext, picks[1][2], x_t, cfg_w,
                                  f2, picks[1][0])
    ok_all &= ok
    ok, fma32 = check_span_passes(cs, th_perm_ext.float(), picks[1][2], x_t,
                                  cfg_w, f2, picks[1][0])
    ok_all &= ok
    del th_perm_ext
    torch.cuda.empty_cache()
    populous = max(al.plan_theta[1], key=lambda c: c.rows.shape[0] * c.width)
    ok, passes = check_span_passes(cs, x_ext, populous, theta_t, cfg_w, f2,
                                   "theta most populous")
    ok_all &= ok
    for k, v in cut32.items():
        passes[k]["cut_chunk"] = v
    passes["wide_span_gram"] = fma32["wide_span_gram"]
    torch.cuda.empty_cache()
    return ok_all, passes, cuts


def wide_paths(cs, ALS, cfg, train, csc, test, small_train, small_test,
               results):
    """Phase 5: the F > 128 path. Fills results[...] for K7, K8 and the
    three pass kernels, adds K1's numbers at f=256 to its entry, and
    returns the launch counts of the two tensor-core route passes (the
    wide_kernel="on" run), of the FMA-only kernels (the small float32
    run) and of K8 (its own path), and the wide-off run's history (phase
    13d's reference)."""
    import copy

    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.ops.tiling import SplitPlan, UpdatePlan

    al, cfg_w, f2, x0_np, th0_np, theta_t, x_t, x_ext = wide_setup(
        cs, ALS, cfg, train, csc, test)
    plan_x, chunks_x, aux_x = al.plan_x

    # ---- 5a. the kernels against their plain versions: as the wrappers
    # route a bf16 table (the two passes, pass 1 on the tensor cores), and
    # the uncut FMA kernels on a float32 copy of the table
    chunks_t = al.plan_theta[1]
    widest = max(chunks_t, key=lambda c: c.width)
    populous = max(chunks_t, key=lambda c: c.rows.shape[0] * c.width)
    ch_x = max(chunks_x, key=lambda c: c.rows.shape[0] * c.width)
    parts = plan_x.chunks[chunks_x.index(ch_x)].parts
    th_perm_ext = ext16(theta_t.index_select(0, aux_x["perm"]))
    ok_all = True
    routed = {}
    for kf2, key in ((f2, "K7"), (None, "K1")):
        for label, table, current, ch, text in (
                ("theta widest", x_ext, theta_t, widest, "theta widest"),
                ("theta most populous", x_ext, theta_t, populous,
                 "theta most populous"),
                ("split X most populous", th_perm_ext, x_t, ch_x,
                 f"split X (parts {parts}) most populous")):
            ok, routed[(key, label)] = check_fused_256(
                cs, table, ch, current, cfg_w, text, f2=kf2, chunk=label)
            ok_all &= ok
    del th_perm_ext
    x_ext32 = x_ext.float()
    ok, results["gather_gram_cg_wide"] = check_fused_256(
        cs, x_ext32, populous, theta_t, cfg_w,
        "theta most populous, float32 table", f2=f2,
        chunk="theta most populous")
    ok_all &= ok
    ok, k1_256 = check_fused_256(
        cs, x_ext32, populous, theta_t, cfg_w,
        "theta most populous, float32 table", chunk="theta most populous")
    ok_all &= ok
    del x_ext32
    ok, _ = check_k8(cs, x_ext, widest, theta_t, cfg_w, f2, "theta widest")
    ok_all &= ok
    ok, results["fused_gram_cg_cat"] = check_k8(
        cs, x_ext, populous, theta_t, cfg_w, f2, "theta most populous")
    ok_all &= ok
    ok_all &= span_edges(cs)
    ok_all &= span_gram_edges(cs)
    ok, passes, cuts = cut_checks(cs, al, cfg_w, f2, theta_t, x_t, x_ext)
    ok_all &= ok
    results.update(passes)
    results["gather_gram_cg_wide"].update(
        routed={label: v for (key, label), v in routed.items()
                if key == "K7"},
        cut={k: v for k, v in cuts.items() if k.startswith("K7")})
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # where the two phases spend their time: K7 and K1 at f=256 chunk by
    # chunk, as routed (the cut under the SM count) and uncut
    th_perm_ext = ext16(theta_t.index_select(0, aux_x["perm"]))
    totals = {}
    for kf2 in (f2, None):
        for label, chunks, table, current in (
                ("theta", chunks_t, x_ext, theta_t),
                ("split X", chunks_x, th_perm_ext, x_t)):
            totals[(kf2, label)] = cut_totals(cs, label, chunks, table,
                                              current, cfg_w, kf2)
    del th_perm_ext
    torch.cuda.empty_cache()

    # ---- 5b. small runs with both new routes: card against CPU, the two
    # passes taken in each card run (pass 1 on the tensor cores with bf16
    # factors, on the FMA body with float32 ones, which also run the
    # uncut FMA kernels on chunks of 132 rows or more)
    scfg = cfg.replace(m=small_train.num_rows, n=small_train.num_cols,
                       nnz=small_train.nnz, nnz_test=small_test.nnz, f=130,
                       panel_size=2048, split_gather="force", verbose=False,
                       debug_timing=False)
    sx0, sth0 = init_factors(scfg.m, scfg.n, scfg.f, seed=0)
    small_launches = {}
    for label, extra, lim_tr, lim_te, want in (
            ("bf16 wide on", dict(wide_kernel="on"), 5e-3, 1e-2, MMA_PASSES),
            ("f32 wide on", dict(wide_kernel="on", factor_dtype="f32",
                                 gram_dtype="f32"), 1e-3, 1e-3,
             ("wide_span_gram", "wide_span_solve", "gather_gram_cg_wide")),
            ("f32 wide off", dict(wide_kernel="off", factor_dtype="f32",
                                  gram_dtype="f32"), 1e-3, 1e-3,
             ("wide_span_gram", "wide_span_solve", "gather_gram_cg"))):
        item = 2 if extra.get("factor_dtype", "bf16") == "bf16" else 4
        part_rows = -(-scfg.n // 3 // 8) * 8
        c = scfg.replace(gather_part_bytes=part_rows * 256 * item, **extra)
        small = {}
        for dev in (DEV, "cpu"):
            model = ALS(c, small_train, None, small_test, device=dev)
            assert isinstance(model.plan_x[0], SplitPlan)
            assert model.plan_x[0].n_parts == 3
            assert isinstance(model.plan_theta[0], UpdatePlan)
            assert cs.wide_enabled(c) == (extra["wide_kernel"] == "on")
            cs.reset_launch_counts()
            small[dev] = model.run(sx0, sth0).history
            if dev == DEV:
                counts = {k: v for k, v in cs.LAUNCHES.items() if v}
        small_launches[label] = counts
        for hg, hc in zip(small[DEV], small["cpu"]):
            dtr = abs(hg.train_rmse - hc.train_rmse)
            dte = abs(hg.test_rmse - hc.test_rmse)
            log(f"[small F=130 split, {label}] iter {hg.iteration}: card "
                f"train {hg.train_rmse:.6f} test {hg.test_rmse:.6f} | cpu "
                f"train {hc.train_rmse:.6f} test {hc.test_rmse:.6f} (limits "
                f"{lim_tr:g}, {lim_te:g})")
            if not (dtr <= lim_tr and dte <= lim_te):
                raise AssertionError("card and CPU runs disagree")
        log(f"[small F=130 split, {label}] launches in the card run: "
            f"{counts} (expected among them: {list(want)})")
        if min(counts.get(k, 0) for k in want) == 0:
            raise AssertionError(f"the card run did not launch {want}")
        if label.startswith("bf16") and set(counts) - set(MMA_PASSES):
            raise AssertionError("a bf16 run launched another 256-lane "
                                 "kernel than the two passes")

    # ---- 5c. the F = 200 path at full width: with a bf16 table every
    # 256-lane chunk runs the two passes, pass 1 on the tensor cores, and
    # no uncut kernel and no FMA pass 1
    others = SPLIT_KERNELS + AUG_KERNELS + ("solve_cg", SPAN_SUM, SPAN_SOLVE)
    fma_256 = WIDE_KERNELS + ("wide_span_gram",)
    _, launches_on = full_width(
        cs, al, "wide on", MMA_PASSES, others + fma_256, x0_np, th0_np)
    al_off = copy.copy(al)     # the same plans; wide_kernel steers no plan
    al_off.cfg = cfg_w.replace(wide_kernel="off", iters=2)
    hist_off, launches_off = full_width(
        cs, al_off, "wide off", MMA_PASSES, others + fma_256, x0_np, th0_np,
        iters=2)
    n_chunks = len(chunks_x) + len(chunks_t)
    log(f"[wide passes] launches of the two passes (pass 1 on the tensor "
        f"cores, pass 2): wide on (3 iterations) "
        f"{[launches_on[k] for k in MMA_PASSES]}, wide off (2 iterations) "
        f"{[launches_off[k] for k in MMA_PASSES]}, over {n_chunks} chunks an "
        f"iteration ({len(chunks_x)} split X, {len(chunks_t)} theta)")
    for launches, iters in ((launches_on, ITERS), (launches_off, 2)):
        if launches["wide_span_gram_mma"] != launches["wide_span_solve"] or \
                launches["wide_span_gram_mma"] < n_chunks * iters:
            raise AssertionError("a 256-lane chunk did not run the tensor-"
                                 "core pass 1")

    # ---- 5e. K6 at 256 lanes: aug_gram="force" on the same plans
    aug_256(cs, al_off, hist_off, results)

    # ---- 5d. K8's path: no route of ALS calls it (as in the JAX
    # package), so its public wrapper runs over every theta chunk on a G
    # gathered with torch from the bf16 table (the two passes, pass 1 on
    # the tensor cores reading the slabs, counted under their own names;
    # the FMA kernel never), each chunk equal bit for bit to K1 at f=256
    # as routed on that table; then the populous chunk once on a float32
    # G (the FMA kernel, once) against K1's uncut kernel on a float32 copy
    # of the table (the FMA body both keep)
    kw = dict(cg_iters=cfg_w.cg_iters, cg_tol=cfg_w.cg_tol)
    k8_ok = True
    k8_launches = dict.fromkeys(("fused_gram_cg_cat",) + MMA_PASSES, 0)
    for ch in chunks_t:
        x0 = chunk_x0(ch, theta_t)
        g1, g2 = gathered_slabs(x_ext, ch, f2)
        cs.reset_launch_counts()
        x8, se8 = cs.fused_gram_cg_cat(g1, g2, ch.vals, ch.nnz, x0,
                                       cfg_w.lam, **kw)
        torch.cuda.synchronize()
        for k in k8_launches:
            k8_launches[k] += cs.LAUNCHES[k]
        del g1, g2
        x1, se1 = cs.gather_gram_cg(x_ext, ch.cols, ch.vals, ch.nnz, x0,
                                    cfg_w.lam, **kw)
        k8_ok &= torch.equal(x8, x1) and torch.equal(se8, se1)
        k8_ok &= bool(torch.isfinite(x8).all())
    log(f"[K8 path] fused_gram_cg_cat over the {len(chunks_t)} theta "
        f"chunks, bf16 G: launches {k8_launches}, every chunk equal bit for "
        f"bit to K1 at f=256 routed on the bf16 table: {k8_ok}")
    if k8_launches["fused_gram_cg_cat"] or \
            min(k8_launches[k] for k in MMA_PASSES) < len(chunks_t) or \
            not k8_ok:
        raise AssertionError("K8 path failed")
    x_ext32 = x_ext.float()
    x0 = chunk_x0(populous, theta_t)
    g1, g2 = gathered_slabs(x_ext32, populous, f2)
    cs.reset_launch_counts()
    x8, se8 = cs.fused_gram_cg_cat(g1, g2, populous.vals, populous.nnz, x0,
                                   cfg_w.lam, **kw)
    fma_ok = {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "fused_gram_cg_cat": 1}
    k8_launches["fused_gram_cg_cat"] += cs.LAUNCHES["fused_gram_cg_cat"]
    del g1, g2
    x1, se1 = cs.gather_gram_cg(x_ext32, populous.cols, populous.vals,
                                populous.nnz, x0, cfg_w.lam, spans=1, **kw)
    worst = (x8 - x1).abs().max().item()
    fma_ok &= bool(((x8 - x1).abs() <= 1e-5 * x1.abs() + 1e-6).all())
    fma_ok &= bool(((se8 - se1).abs() <= 1e-5 * se1.abs() + 1e-6).all())
    del x_ext32, x8, se8, x1, se1
    log(f"[K8 path] theta most populous on a float32 G (the FMA kernel): "
        f"max|x - x_K1|={worst:.3e} against K1's uncut kernel at f=256 on "
        f"the float32 table (limit rtol 1e-5 + 1e-6: {fma_ok})")
    if not fma_ok:
        raise AssertionError("K8 path failed on a float32 G")

    results["gather_gram_cg"].update(
        {f"f256_{k}": v for k, v in k1_256.items()},
        f256_routed={label: v for (key, label), v in routed.items()
                     if key == "K1"},
        f256_launches=launches_off["wide_span_gram_mma"],
        f256_launches_path="ALS.run F=200 wide off (bf16): the two passes",
        f256_cut={k: v for k, v in cuts.items() if k.startswith("K1")})
    for k in MMA_PASSES:
        results[k]["launches_wide_off"] = launches_off[k]
        results[k]["launches_path"] = "ALS.run F=200 wide on (bf16)"
    # the FMA-only kernels run on float32 tables: their launches are those
    # of the small float32 card run of 5b
    results["gather_gram_cg_wide"]["launches_path"] = \
        "ALS.run F=130 f32 wide on, scale 0.01 (5b)"
    results["wide_span_gram"]["launches_path"] = \
        "ALS.run F=130 f32 wide on, scale 0.01 (5b)"
    results["fused_gram_cg_cat"].update(
        launches_path="K8's path (5d): the float32-G chunk; its "
        f"{len(chunks_t)} bf16-G chunks launch the two passes "
        "(launches_k8_path of wide_span_gram_mma and wide_span_solve)",
        bf16_route="wide_span_gram_mma + wide_span_solve")
    for k in MMA_PASSES:
        results[k]["launches_k8_path"] = k8_launches[k]
    results["gather_gram_cg_wide"]["phase_totals"] = {
        label: v for (kf2, label), v in totals.items() if kf2}
    results["gather_gram_cg"]["f256_phase_totals"] = {
        label: v for (kf2, label), v in totals.items() if kf2 is None}
    f32_on = small_launches["f32 wide on"]
    return {"gather_gram_cg_wide": f32_on["gather_gram_cg_wide"],
            "wide_span_gram": f32_on["wide_span_gram"],
            "fused_gram_cg_cat": k8_launches["fused_gram_cg_cat"],
            **{k: launches_on[k] for k in MMA_PASSES}}, hist_off


# ------------------------------------------------------------ phase 5e --
AUG_256_ITERS = 2


def check_k6_256(cs, table_ext, ch, current, cfg, label):
    """K6 (gather_gram_cg(aug=True)) at f = 256 on one chunk of a 256-lane
    table whose lane 255 is free, as the wrapper routes it (a bf16 table:
    the two passes, pass 1 on the tensor cores with the values over lane
    255; a float32 one: the uncut kernel, or the cut on the FMA body
    under the SM count): against the uncut plain version with K1's
    limits at f = 256 (x 2e-3, se 1e-3 relative), lane 255 of x, empty
    rows and the dummy rows exactly 0, a second call equal bit for bit.
    Prints the route, its launches, the device time, the plain version's
    and the bound (the live work of `wide_work` at 256 lanes)."""
    x0 = chunk_x0(ch, current)
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol, aug=True)
    cs.reset_launch_counts()
    x, se = cs.gather_gram_cg(*args, **kw)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cs.LAUNCHES.items() if v}
    x2, se2 = cs.gather_gram_cg(*args, **kw)
    same = torch.equal(x, x2) and torch.equal(se, se2)
    del x2, se2
    px, pse = cs.gather_gram_cg_aug_plain(*args, cfg.cg_iters, cfg.cg_tol)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    del px, pse
    zero_ok = bool((x[:, 255] == 0).all()) and \
        bool((x[ch.nnz == 0] == 0).all()) and \
        bool((se[ch.nnz == 0] == 0).all())
    ms = queued_ms(lambda: cs.gather_gram_cg(*args, **kw))
    plain = queued_ms(lambda: cs.gather_gram_cg_aug_plain(
        *args, cfg.cg_iters, cfg.cg_tol), reps=3)
    r, p = ch.cols.shape
    read, flops = wide_work(table_ext, ch, 256)
    bms, by = bound_ms(read + r * 256 * 4 + nbytes(x, se), flops,
                       table_ext.dtype)
    ok = err <= 2e-3 and se_rel <= 1e-3 and zero_ok and same
    route = route_of(cs, table_ext, r, p)[0]
    log(f"[K6 gather_gram_cg_aug f=256] {label} chunk R={r} P={p}, table "
        f"{table_ext.dtype} ({route}; launches of one call {launches}): "
        f"max|dx|={err:.3e} (limit 2e-3), max rel dse={se_rel:.3e} (limit "
        f"1e-3), lane 255 of x and empty rows exactly 0: {zero_ok}, a "
        f"second call equal bit for bit: {same}; device time {ms:.3f} ms, "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None, shape=[r, p],
                    launches_one_call=launches, route=route)


def check_k6_passes(cs, table_ext, ch, current, cfg, label):
    """Each pass of K6 at f = 256 alone on one chunk, in the spans the
    wrapper cuts it into (`route_of`): pass 1 (`span_grams` with aug: on
    the tensor cores for a bf16 table, on the FMA body for a float32
    one) against `span_gram_plain` with aug, every live record's A' read
    through the record layout (`span_record_unpack`) within
    `gram_limit`; pass 2 (`span_solve` with aug) on pass 1's own records
    against `span_solve_plain` with aug on the same records unpacked: x
    within 2e-3, se within 1e-3 relative. Returns the numbers of the two
    passes."""
    x0 = chunk_x0(ch, current)
    r, p = ch.cols.shape
    _, n_spans, span = route_of(cs, table_ext, r, p)
    body = cs.gram_body(table_ext)
    gargs = (table_ext, ch.cols, ch.vals, ch.nnz, 256, n_spans, span)
    part = cs.span_grams(*gargs, aug=True)
    live = cs._span_live(ch.nnz, p, n_spans, span)
    pa = torch.stack([cs.span_gram_plain(
        table_ext, ch.cols, ch.vals, ch.nnz, k * span, (k + 1) * span, 256,
        aug=True)[0] for k in range(n_spans)], dim=1)[live]
    a = cs.span_record_unpack(part[live], 256)[0]
    lim, limit = gram_limit(a, pa, span, body)
    diff = (a - pa).abs()
    a_err = diff.max().item()
    a_ok = bool((diff <= lim).all())
    n_live = int(live.sum().item())
    del lim, diff, a, pa
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    x, se = cs.span_solve(part, ch.nnz, x0, cfg.lam, p, span, aug=True,
                          **kw)
    ua, ub, ur2 = cs.span_record_unpack(
        torch.where(live[:, :, None], part, torch.zeros_like(part)), 256)
    card_parts = [(ua[:, k], ub[:, k], ur2[:, k]) for k in range(n_spans)]
    px, pse = cs.span_solve_plain(card_parts, ch.nnz, x0, cfg.lam, aug=True,
                                  **kw)
    x_err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    del px, pse
    ms1 = queued_ms(lambda: cs.span_grams(*gargs, aug=True))
    plain1 = queued_ms(lambda: [cs.span_gram_plain(
        table_ext, ch.cols, ch.vals, ch.nnz, k * span, (k + 1) * span, 256,
        aug=True) for k in range(n_spans)], reps=3)
    ms2 = queued_ms(lambda: cs.span_solve(part, ch.nnz, x0, cfg.lam, p,
                                          span, aug=True, **kw))
    plain2 = queued_ms(lambda: cs.span_solve_plain(
        card_parts, ch.nnz, x0, cfg.lam, aug=True, **kw), reps=3)
    del ua, ub, ur2, card_parts, part
    rec_bytes = n_live * cs.span_record_floats(256) * 4
    read, flops = wide_work(table_ext, ch, 256)
    b1, by1 = bound_ms(read + rec_bytes, flops, table_ext.dtype)
    # pass 2: the records once, and the CG's cg_iters + 2 matvecs a row
    b2, by2 = bound_ms(rec_bytes + nbytes(ch.nnz, x, se) + r * 256 * 4,
                       r * (cfg.cg_iters + 2) * 2.0 * 256 * 256,
                       torch.float32)
    ok = a_ok and x_err <= 2e-3 and se_rel <= 1e-3
    log(f"[K6 passes f=256] {label} chunk R={r} P={p}, table "
        f"{table_ext.dtype}, S={n_spans} spans of {span} slots, {n_live} "
        f"live: pass 1 (aug, body {body}) max|dA'|={a_err:.3e} (limit "
        f"{limit}: {a_ok}); pass 2 (aug) on the same records max|dx|="
        f"{x_err:.3e}, max rel dse={se_rel:.3e} (limits 2e-3, 1e-3); "
        f"device time: pass 1 {ms1:.3f} ms (plain {plain1:.3f}, bound "
        f"{b1:.4f} ms, {by1}), pass 2 {ms2:.3f} ms (plain {plain2:.3f}, "
        f"bound {b2:.4f} ms, {by2}); {'OK' if ok else 'FAIL'}")
    return ok, {"pass_1": dict(max_abs_err=a_err, ms=ms1, plain_ms=plain1,
                               bound_ms=b1, bound_by=by1, library_ms=None,
                               spans=n_spans, span_len=span),
                "pass_2": dict(max_abs_err=x_err, ms=ms2, plain_ms=plain2,
                               bound_ms=b2, bound_by=by2, library_ms=None,
                               spans=n_spans, span_len=span)}


def aug_256(cs, model, hist_ref, results):
    """Phase 5e: K6 at f = 256 on the Netflix F=200 plans of `model` (X on
    the split route, theta direct), with aug_gram="force" and wide_kernel
    off, so both phases' fused chunks run K6 at 256 lanes. First K6
    against its plain version (`check_k6_256`) on the most populous
    theta chunk, on the split X chunk with the fewest rows (the cut,
    S > 1) with the bf16 table and with a float32 copy of it (the cut on
    the FMA body), and on the most populous theta chunk of a float32
    table (the uncut kernel of gather_gram_cg_aug.cu); then ALS.run for
    AUG_256_ITERS iterations, train RMSE within 1e-3 of phase 5's
    wide-off run (`hist_ref`, the split kernel K1 at 256 on the same
    plans) at every iteration and test RMSE falling, K6's two passes
    launched at least once a chunk, no other fused kernel. Fills
    results["gather_gram_cg_aug"] with the f = 256 numbers."""
    import copy

    from cumf_als_tpu_torch.data.synthetic import init_factors
    t_start = time.monotonic()
    cfg_a = model.cfg.replace(wide_kernel="off", aug_gram="force",
                              iters=AUG_256_ITERS)
    if not (cs.aug_enabled(cfg_a) and not cs.wide_enabled(cfg_a) and
            cfg_a.f_pad == 256):
        raise AssertionError("aug F=200: the gate does not send the fused "
                             "routes to K6")
    plan_x, chunks_x, aux_x = model.plan_x
    chunks_t = model.plan_theta[1]
    x0_np, th0_np = init_factors(cfg_a.m, cfg_a.n, cfg_a.f, seed=0)
    gen = torch.Generator(device=DEV).manual_seed(5)
    theta_t = model._pad_f(th0_np)
    # a stand-in X for the theta-phase table (lanes >= 200 zero, so lane
    # 255 is free): the real X starts at zero
    x_t = model._pad_f(0.2 * torch.rand((cfg_a.m, cfg_a.f), generator=gen,
                                        device=DEV).cpu().numpy())
    x_ext = ext16(x_t)
    th_perm_ext = ext16(theta_t.index_select(0, aux_x["perm"]))
    populous = max(chunks_t, key=lambda c: c.rows.shape[0] * c.width)
    fewest = min(chunks_x, key=lambda c: (c.cols.shape[0], -c.width))
    out, ok_all = {}, True
    for key, table, current, ch, label in (
            ("theta_populous", x_ext, theta_t, populous,
             "theta most populous"),
            ("split_x_fewest", th_perm_ext, x_t, fewest,
             "split X fewest rows"),
            ("split_x_fewest_f32_table", th_perm_ext.float(), x_t, fewest,
             "split X fewest rows, float32 table"),
            ("theta_populous_f32_table", x_ext.float(), theta_t, populous,
             "theta most populous, float32 table")):
        ok, out[key] = check_k6_256(cs, table, ch, current, cfg_a, label)
        ok_all &= ok
        if key != "split_x_fewest":
            # each pass alone: on the tensor cores and on the FMA body;
            # on the float32 populous chunk the cut at S = 1, which the
            # uncut kernel's time above is held against
            ok, out[key]["passes"] = check_k6_passes(cs, table, ch,
                                                     current, cfg_a, label)
            ok_all &= ok
        del table
        torch.cuda.empty_cache()
    if out["split_x_fewest"]["launches_one_call"].get(
            "wide_span_gram_mma", 0) != 1 or \
            route_of(cs, th_perm_ext, *fewest.cols.shape)[1] < 2:
        ok_all = False
        log("[aug 256] the split X chunk with the fewest rows did not cut")
    del x_ext, th_perm_ext, theta_t, x_t
    torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("K6 at f = 256 disagrees with its plain "
                             "version")
    al = copy.copy(model)      # the same plans: aug steers no plan
    al.cfg = cfg_a
    others = SPLIT_KERNELS + AUG_KERNELS + WIDE_KERNELS + (
        "solve_cg", "wide_span_gram", SPAN_SUM, SPAN_SOLVE)
    hist, launches = full_width(cs, al, "aug 256", MMA_PASSES, others,
                                x0_np, th0_np, iters=AUG_256_ITERS)
    n_chunks = len(chunks_x) + len(chunks_t)
    worst = 0.0
    for h, r in zip(hist, hist_ref):
        d = abs(h.train_rmse - r.train_rmse)
        worst = max(worst, d)
        log(f"[aug 256 | wide off] iter {h.iteration}: train "
            f"{h.train_rmse:.6f} | {r.train_rmse:.6f} (limit 1e-3), test "
            f"{h.test_rmse:.6f} | {r.test_rmse:.6f}")
    te = [h.test_rmse for h in hist]
    log(f"[aug 256] {AUG_256_ITERS} iterations of {n_chunks} chunks "
        f"({len(chunks_x)} split X, {len(chunks_t)} theta); K6's passes "
        f"{dict((k, launches[k]) for k in MMA_PASSES)}; worst train RMSE "
        f"gap to wide off {worst:.3e}; phase 5e "
        f"{time.monotonic() - t_start:.1f} s")
    if len(hist) > len(hist_ref) or worst > 1e-3 or not te[-1] < te[0]:
        raise AssertionError("aug F=200: off phase 5's wide-off run")
    if launches["wide_span_gram_mma"] != launches["wide_span_solve"] or \
            launches["wide_span_gram_mma"] < n_chunks * AUG_256_ITERS:
        raise AssertionError("aug F=200: a fused chunk did not run K6's "
                             "two passes at 256 lanes")
    results.setdefault("gather_gram_cg_aug", {}).update(
        f256=out, f256_launches=launches["wide_span_gram_mma"],
        f256_launches_path=f"ALS.run F=200 aug force (bf16, "
                           f"{AUG_256_ITERS} iterations): the two passes")
    del al
    torch.cuda.empty_cache()


def run_bench(args, label):
    """`python -m cumf_als_tpu_torch.bench ARGS` in a subprocess from this
    checkout; its stderr is logged, its JSON line returned."""
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "cumf_als_tpu_torch.bench", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    for line in out.stderr.splitlines():
        log(f"[{label}] {line}")
    if out.returncode != 0:
        raise AssertionError(f"{label}: the bench exited {out.returncode}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"[{label}] {json.dumps(line)} ({time.monotonic() - t0:.1f} s)")
    return line


def bench_main():
    """The bench's main path on the cached Netflix data: the root bench's
    keys, this card, the main path's train RMSE."""
    line = run_bench(["--workload", "netflix", "--iters", str(ITERS),
                      "--repeat", "3"], "bench main")
    want = RECORDED_TRAIN_RMSE["main"]
    if list(line) != BENCH_KEYS + REPEAT_KEYS:
        raise AssertionError(f"bench main: keys {list(line)}")
    if line["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench main: device {line['device']!r}")
    if abs(line["train_rmse_final"] - want) > 1e-3:
        raise AssertionError(f"bench main: train RMSE "
                             f"{line['train_rmse_final']}, recorded {want}")
    if not (math.isfinite(line["value"]) and line["value"] > 0):
        raise AssertionError(f"bench main: value {line['value']}")


def bench_accuracy():
    """Both calibrated contracts under 2^26 ratings, at 10 iterations."""
    for args in (["--workload", "netflix_cal", "--scale", "0.25"],
                 ["--workload", "ml10m_cal"]):
        line = run_bench(args + ["--accuracy-check"], "bench accuracy")
        if list(line) != BENCH_KEYS + ACCURACY_KEYS or \
                line["accuracy_check"] != "pass":
            raise AssertionError(f"bench accuracy: {args[1]} "
                                 f"{line.get('accuracy_check')}")


def workload_data(bench, name, want):
    """A workload at scale 1.0 through the bench's loader, held to its
    recorded counts and CRC-32s (and to those its cache recorded when it
    was written). Returns the data and the loader's seconds."""
    t0 = time.monotonic()
    train, test = bench.load_workload(name, 1.0)
    load_s = time.monotonic() - t0
    crc = bench.dataset_crc32(train, test)
    with open(os.path.join(bench.dataset_dir(name, 1.0), "meta.json")) as fh:
        meta = json.load(fh)
    log(f"[data] {name}: the bench's cache ({meta['entry']['generator']} "
        f"generator): nnz {train.nnz}, nnz_test {test.nnz}, CRC-32 {crc}; "
        f"{load_s:.1f} s to load (generating it on first use)")
    if (train.nnz, test.nnz) != (want["nnz"], want["nnz_test"]) or \
            crc != meta["crc32"] or crc != want["crc32"]:
        raise AssertionError(f"the cached {name} data is not the recorded "
                             f"workload_ratings({name!r}, 1.0, 0)")
    return train, test, load_s


def ooc_run(cs, model, label, expect, at_least=()):
    """model.run for its iterations with the launch counts and the peak
    device memory read around it alone; `expect`: the launches each
    kernel must make, `at_least`: kernels that must launch (the two
    passes of K1 at 256 lanes, whose count the row batches set); every
    other kernel none."""
    x0, th0 = init_factors_np(model)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launch_counts()
    res = model.run(x0, th0)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cs.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    per_iter = [h.x_seconds + h.theta_seconds for h in res.history]
    for h in res.history:
        log(f"[{label}] iter {h.iteration}: x {h.x_seconds:.4f} s, theta "
            f"{h.theta_seconds:.4f} s, rmse {h.rmse_seconds:.4f} s, train "
            f"{h.train_rmse:.6f}, test {h.test_rmse:.6f}")
    log(f"[{label}] seconds per iteration (x + theta): "
        f"{[round(t, 4) for t in per_iter]}, median "
        f"{statistics.median(per_iter):.4f}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB allocated before "
        f"the run); launches {launches}")
    exact = {k: v for k, v in launches.items() if k not in at_least}
    if exact != {k: v for k, v in expect.items() if v} or \
            min((launches.get(k, 0) for k in at_least), default=1) == 0:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect} and some of {list(at_least)}")
    if not all(np.isfinite([h.train_rmse for h in res.history] +
                           [h.test_rmse for h in res.history])):
        raise AssertionError(f"{label}: non-finite RMSE")
    return res, launches, peak


def init_factors_np(model):
    from cumf_als_tpu_torch.data.synthetic import init_factors
    cfg = model.cfg
    return init_factors(cfg.m, cfg.n, cfg.f, seed=0)


def cuda_tensors_of_rows(rows: int):
    """Shapes of the live CUDA tensors with `rows` rows (by their type
    alone: some objects warn when their attributes are read)."""
    import gc
    gc.collect()
    return [tuple(t.shape) for t in gc.get_objects()
            if issubclass(type(t), torch.Tensor) and t.is_cuda and t.dim()
            and t.shape[0] == rows]


def ooc_kernel_checks(cs, ooc, theta_np):
    """K1, K2 and K3 against their plain versions at the shapes the
    out-of-core path gives them. K1 on the X chunk with the most ratings
    at iteration 0's state (table: the initial theta; warm start: the
    initial X), as the Netflix checks hold K1 at the initial factors;
    K2 and K3 on the state the run left: the theta panel chunk with the
    most ratings (table: its X panel from the host store, A in the run's
    accumulator dtype), and the first solve slice of the theta
    accumulators that X gives (warm start: the run's theta). Returns ok
    and each kernel's numbers."""
    from types import SimpleNamespace
    from cumf_als_tpu_torch.ops.gram import extend_table
    cfg, dev = ooc.cfg, torch.device(DEV)
    n, f_pad = ooc.plan_theta.num_rows, cfg.f_pad

    def padded(arr):
        out = torch.zeros((arr.shape[0], f_pad), dtype=torch.float32)
        out[:, :cfg.f] = torch.from_numpy(np.asarray(arr, np.float32))
        return out.to(dev)

    def most_rated(plan):
        return max(range(len(plan.chunks)),
                   key=lambda i: int(plan.chunks[i].nnz.sum()))

    x0, th0 = init_factors_np(ooc)
    theta0 = padded(th0) * torch.from_numpy(
        ooc.plan_theta.row_nnz > 0).to(dev)[:, None]
    i = most_rated(ooc.plan_x)
    (c,), _ = ooc._host_x.upload(i, i + 1, dev)
    k = c.n_real
    ch = SimpleNamespace(cols=c.cols, vals=c.vals, nnz=c.nnz, rows=c.rows,
                         n_real=k, rows_real=torch.arange(k, device=dev))
    current = padded(x0[c.rows[:k].cpu().numpy()])   # all rated rows
    ok1, k1 = check_k1(cs, extend_table(theta0.to(torch.bfloat16)), ch,
                       current, cfg, f"out-of-core X chunk {i} of "
                       f"{len(ooc.plan_x.chunks)}, iteration 0")
    del current, ch, c, theta0
    theta = padded(theta_np)

    j = most_rated(ooc.plan_theta)
    (c,), _ = ooc._host_th.upload(j, j + 1, dev)
    s = ooc.plan_theta.panel_size
    lo, hi = c.panel * s, min(c.panel * s + s, ooc.plan_theta.num_cols)
    tp = torch.zeros((s + 1, f_pad), dtype=torch.bfloat16, device=dev)
    tp[:hi - lo] = ooc.x_store[lo:hi].to(dev)
    ok2, k2 = check_gram(cs, tp, c, ooc.accum_dtype, False,
                         f"out-of-core theta chunk {j} of "
                         f"{len(ooc.plan_theta.chunks)}")
    del tp, c

    a_buf, b_buf = ooc.theta_accumulators()
    theta_pad = torch.nn.functional.pad(theta, (0, 0, 0, ooc.n_pad - n))
    ok3, k3 = check_k3(cs, a_buf, b_buf, theta_pad, ooc._theta_nnz_pad, 0,
                       ooc.solve_batch, cfg)
    del a_buf, b_buf, theta_pad, theta
    torch.cuda.empty_cache()
    return ok1 and ok2 and ok3, {"gather_gram_cg": k1,
                                 "gather_gram_out": k2, "solve_cg_reg": k3}


def out_of_core(cs, bench):
    """Phase 9: OutOfCoreALS at full width on hugewiki_mini (scale 1.0,
    the native generator's data, CRC-32s pinned), against the in-core ALS
    with the same settings (X and theta direct), then once through the
    bench. Returns the out-of-core run's launches, the numbers of K1, K2
    and K3 held against their plain versions at its shapes, and the
    run's result (phase 11's reference)."""
    from cumf_als_tpu_torch import native
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
    from cumf_als_tpu_torch.utils.plan_cache import cached_transpose
    if not native.available():
        raise AssertionError("the native data plane is not built")
    train, test, load_s = workload_data(bench, "hugewiki_mini",
                                        RECORDED_HUGEWIKI_MINI)
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=100,
                    nnz=train.nnz, nnz_test=test.nnz, lam=0.048,
                    iters=OOC_ITERS, solver="cg", backend="pallas",
                    factor_dtype="bf16", gram_dtype="bf16",
                    plan_cache_dir=bench.plan_cache_dir(), verbose=False,
                    debug_timing=False)
    t0 = time.monotonic()
    csc = cached_transpose(cfg.plan_cache_dir, train)
    csc_s = time.monotonic() - t0
    t0 = time.monotonic()
    ooc = OutOfCoreALS(cfg.replace(host_offload_x=True), train, csc, test,
                       device="cuda")
    log(f"[ooc] set-up with the native library: data {load_s:.1f} s, CSC "
        f"{csc_s:.1f} s, out-of-core plans and pinned buffers "
        f"{time.monotonic() - t0:.1f} s (cached in {cfg.plan_cache_dir}); "
        f"X phase {len(ooc.plan_x.chunks)} chunks, theta phase "
        f"{len(ooc.plan_theta.chunks)} chunks over "
        f"{ooc.plan_theta.n_panels} X panels of "
        f"{ooc.plan_theta.panel_size} rows, {ooc.n_slices} solve slices of "
        f"{ooc.solve_batch}; theta accumulators {ooc.accum_dtype}")
    if not ooc.x_store.is_pinned():
        raise AssertionError("the X store is not pinned host memory")
    n = OOC_ITERS
    expect = {"gather_gram_cg": len(ooc.plan_x.chunks) * n,
              "gather_gram_out": len(ooc.plan_theta.chunks) * n,
              "solve_cg_reg": ooc.n_slices * n,
              SPAN_SUM: span_sums(cs, map(gram_shape, ooc.plan_theta.chunks),
                                  cfg.f_pad, n),
              SPAN_SOLVE: theta_cuts(cs, map(gram_shape, ooc.plan_x.chunks),
                                     cfg.f_pad, n)}
    res_o, launches, peak_o = ooc_run(cs, ooc, "ooc", expect)
    full_x = cuda_tensors_of_rows(train.num_rows)
    log(f"[ooc] live CUDA tensors of X's {train.num_rows} rows after the "
        f"run: {full_x}")
    if full_x:
        raise AssertionError("a device tensor of X's full shape is live")
    checks_ok, checks = ooc_kernel_checks(cs, ooc, res_o.theta)
    if not checks_ok:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the out-of-core path's shapes")
    acc = ooc.accum_dtype
    del ooc
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    inc = ALS(cfg.replace(use_panels="never", train_rmse_method="direct"),
              train, csc, test, device="cuda")
    log(f"[in-core] plans {time.monotonic() - t0:.1f} s; X phase "
        f"{len(inc.plan_x[1])} chunks, theta phase {len(inc.plan_theta[1])} "
        f"chunks (both direct)")
    res_i, _, peak_i = ooc_run(cs, inc, "in-core", {
        "gather_gram_cg": (len(inc.plan_x[1]) + len(inc.plan_theta[1])) * n,
        SPAN_SOLVE: theta_cuts(cs, map(gram_shape, inc.plan_x[1] +
                                       inc.plan_theta[1]), cfg.f_pad, n)})
    del inc
    torch.cuda.empty_cache()
    worst = 0.0
    for ho, hi in zip(res_o.history, res_i.history):
        d = max(abs(ho.train_rmse - hi.train_rmse),
                abs(ho.test_rmse - hi.test_rmse))
        worst = max(worst, d)
        log(f"[ooc | in-core] iter {ho.iteration}: train {ho.train_rmse:.6f}"
            f" | {hi.train_rmse:.6f}, test {ho.test_rmse:.6f} | "
            f"{hi.test_rmse:.6f} (limit 2e-3)")
    x_ok = np.allclose(res_o.x, res_i.x, rtol=2e-2, atol=2e-2)
    th_ok = np.allclose(res_o.theta, res_i.theta, rtol=2e-2, atol=2e-2)
    log(f"[ooc | in-core] max|x diff| {np.abs(res_o.x - res_i.x).max():.3e},"
        f" max|theta diff| {np.abs(res_o.theta - res_i.theta).max():.3e} "
        f"(rtol, atol 2e-2); peak device memory {peak_o / 2**30:.2f} | "
        f"{peak_i / 2**30:.2f} GiB; accumulators {acc} | none (direct)")
    if worst > 2e-3 or not (x_ok and th_ok):
        raise AssertionError("out-of-core and in-core runs disagree")
    if not peak_o < peak_i:
        raise AssertionError("the out-of-core run's peak device memory is "
                             "not below the in-core run's")
    line = run_bench(["--workload", "hugewiki_mini", "--out-of-core",
                      "--iters", str(OOC_ITERS)], "bench ooc")
    if list(line) != BENCH_KEYS or \
            line["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench ooc: {line}")
    if abs(line["train_rmse_final"] - res_o.history[-1].train_rmse) > 2e-3:
        raise AssertionError("bench ooc: train RMSE off the phase's run")
    return launches, checks, res_o


def sharded_log(label, history, peak, launches, what):
    """The per-iteration lines and the summary line of a sharded run."""
    for h in history:
        log(f"[{label}] iter {h.iteration}: x {h.x_seconds:.4f} s, theta "
            f"{h.theta_seconds:.4f} s, rmse {h.rmse_seconds:.4f} s, train "
            f"{h.train_rmse:.6f}, test {h.test_rmse:.6f}")
    per_iter = [h.x_seconds + h.theta_seconds for h in history]
    log(f"[{label}] {what} seconds per iteration (x + theta): "
        f"{[round(t, 4) for t in per_iter]}, median "
        f"{statistics.median(per_iter):.4f}; peak device memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}; "
        f"launches { {k: v for k, v in launches.items() if v} }")


def rmse_gaps(label, hist, ref, ref_label, limit=2e-3):
    """Train and test RMSE of `hist` against `ref`, iteration by
    iteration (as far as both go); raises past `limit`."""
    worst = 0.0
    for h, r in zip(hist, ref):
        worst = max(worst, abs(h.train_rmse - r.train_rmse),
                    abs(h.test_rmse - r.test_rmse))
        log(f"[{label} | {ref_label}] iter {h.iteration}: train "
            f"{h.train_rmse:.6f} | {r.train_rmse:.6f}, test "
            f"{h.test_rmse:.6f} | {r.test_rmse:.6f} (limit {limit:g})")
    if worst > limit:
        raise AssertionError(f"{label}: RMSE off {ref_label} by {worst:.3e}")
    return worst


def sharded_profile(model, x0, th0):
    """The device-busy share of one traced iteration of `model` (its X
    and theta phases from the initial factors, set up outside the trace):
    the union of the CUDA activities' intervals over the window's wall
    time, from torch.profiler (None when the trace holds no device
    activity). Traced: the profiler's own cost is in the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = model.shard_x(x0 * (np.diff(model.train_csr.indptr) > 0)[:, None])
    theta = model.replicate_theta(
        th0 * (np.diff(model.train_csc.indptr) > 0)[:, None])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        x = model.x_phase(theta, x)
        theta, se = model.theta_phase(x, theta)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:   # the union of the intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        log("[profile] the trace holds no device activity: device-busy "
            "share not measured")
        return None
    share = busy * 1e-6 / wall
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    log(f"[profile] one traced iteration (X and theta phases) of the "
        f"sharded run at one rank: wall {wall:.4f} s, device busy "
        f"{busy / 1e3:.1f} ms (the union of {len(spans)} CUDA activities), "
        f"device-busy share {share:.3f} (traced); most self device time: "
        f"{[(e.key[:48], round(e.self_device_time_total / 1e3, 2)) for e in top[:6]]}")
    return share


# iterations of phase 10b (two ranks on one card over gloo): one, as the
# partials of an iteration cross host memory in ~26 s (PERF.md §5); no
# recorded RMSE reads that count
SHARDED_TWO_RANK_ITERS = 1


def sharded(cs, bench, cfg, train, test, hist_main):
    """Phase 10: ShardedALS on the Netflix data at full width (F=100,
    bf16, CG, "pallas"), (a) at one rank on an NCCL group of one, 3
    iterations, against phase 4a's ALS run; (b) at two ranks on the one
    card, both on cuda:0 over gloo (NCCL refuses two ranks on one card),
    spawned, SHARDED_TWO_RANK_ITERS iterations, against (a). Launch
    counts equal the plans'
    counts; K1 (a), K2 and K3 (b) are held to their plain versions at the
    sharded shapes. Returns the launches and the checks' numbers."""
    import functools

    import torch.distributed as dist

    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.parallel.mesh import (Mesh, free_port,
                                                  init_distributed, spawn)
    from cumf_als_tpu_torch.parallel.sharded_als import (ShardedALS,
                                                         run_rank)
    from cumf_als_tpu_torch.utils.plan_cache import cached_transpose
    scfg = cfg.replace(plan_cache_dir=bench.plan_cache_dir(), verbose=False,
                       debug_timing=True, iters=ITERS)
    t0 = time.monotonic()
    csc = cached_transpose(scfg.plan_cache_dir, train)   # the ranks' too
    log(f"[sharded] CSC through the plan cache {time.monotonic() - t0:.1f} "
        f"s ({scfg.plan_cache_dir})")
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    dev = torch.device(DEV, 0)
    launches, checks = {}, {}

    # (a) one rank on an NCCL group of one
    mesh = init_distributed("nccl", f"tcp://localhost:{free_port()}", 1, 0,
                            device=dev)
    try:
        t0 = time.monotonic()
        one = ShardedALS(scfg, train, csc, test, mesh=mesh)
        if one.x_steps is None or not one.single_fused():
            raise AssertionError("expected the panel X route and K1 on theta")
        slices = one._x_m_pad // one._x_solve_batch
        blocks = one._blocks
        log(f"[sharded one rank] plans {time.monotonic() - t0:.1f} s "
            f"(built once into the plan cache); backend "
            f"{mesh.backend}, world {mesh.world_size}; X {len(one.x_steps)} "
            f"panel steps over {one.x_n_panels} panels, {slices} solve "
            f"slices of {one._x_solve_batch}; theta {len(blocks)} reduce "
            f"blocks, K1 on each")
        expect = {"gather_gram_cg": ITERS * len(blocks),
                  "gather_gram_out": ITERS * len(one.x_steps),
                  "solve_cg_reg": ITERS * slices,
                  SPAN_SUM: span_sums(cs, map(gram_shape, one.x_steps),
                                      cfg.f_pad, ITERS),
                  SPAN_SOLVE: theta_cuts(cs, map(gram_shape, blocks),
                                         cfg.f_pad, ITERS)}
        expect = {k: v for k, v in expect.items() if v}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs.reset_launch_counts()
        res = one.run(x0, th0)
        torch.cuda.synchronize()
        got = {k: v for k, v in cs.LAUNCHES.items() if v}
        sharded_log("sharded one rank", res.history,
                    torch.cuda.max_memory_allocated(), got, "NCCL, one card:")
        if got != expect:
            raise AssertionError(f"sharded one rank: launches {got}, the "
                                 f"plans say {expect}")
        launches["one_rank"] = expect
        rmse_gaps("sharded one rank", res.history, hist_main, "main")
        # K1 on the most populous reduce block at the initial factors (a
        # stand-in X: the real one starts at zero), as phase 2a holds it
        gen = torch.Generator(device=DEV).manual_seed(1)
        x_t = one.shard_x((0.2 * torch.rand((cfg.m, cfg.f), generator=gen,
                                            device=DEV)).cpu().numpy())
        theta_t = one.replicate_theta(
            th0 * (np.diff(csc.indptr) > 0)[:, None])
        i = max(range(len(blocks)),
                key=lambda k: blocks[k].rows.shape[0] * blocks[k].width)
        ok, checks["gather_gram_cg"] = check_k1(
            cs, ext16(x_t), blocks[i], theta_t, scfg,
            f"sharded one rank: reduce block {i} of {len(blocks)}")
        if not ok:
            raise AssertionError("K1 disagrees at the sharded shapes")
        del x_t, theta_t
        share = sharded_profile(one, x0, th0)
        checks["gather_gram_cg"]["device_busy_share_traced"] = share
        del one
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two ranks on the one card over gloo, spawned
    its = SHARDED_TWO_RANK_ITERS
    t0 = time.monotonic()
    ranks = spawn(2, run_rank, scfg.replace(iters=its),
                  functools.partial(bench.load_workload, "netflix", 1.0),
                  x0, th0, backend="gloo", device=DEV + ":0", timeout=900)
    log(f"[sharded two ranks] spawned, built and ran in "
        f"{time.monotonic() - t0:.1f} s")
    # each rank's view of the plans, rebuilt here from the plan cache (a
    # Mesh of that rank with no group): the shapes of its K2 calls, and
    # the checks below
    views = [ShardedALS(scfg, train, csc, None,
                        mesh=Mesh(rank=r, world_size=2, device=dev))
             for r in range(2)]
    for r, out in enumerate(ranks):
        sharded_log(f"sharded two ranks, rank {r}", out["history"],
                    out["peak_bytes"], out["launches"],
                    "gloo over one card (two processes on cuda:0, the "
                    "partials through host memory; not a multi-GPU time):")
        shapes = [gram_shape(c) for c in (views[r].x_steps or [])] + \
            [gram_shape(c) for c in views[r]._blocks]
        want = {"gather_gram_out": its * (out["x_steps"] + out["n_blocks"]),
                "solve_cg_reg": its * (out["x_slices"] + out["n_blocks"]),
                SPAN_SUM: span_sums(cs, shapes, cfg.f_pad, its)}
        want = {k: v for k, v in want.items() if v}
        got = {k: v for k, v in out["launches"].items() if v}
        if got != want:
            raise AssertionError(f"rank {r}: launches {got}, the plans say "
                                 f"{want}")
        if not np.array_equal(out["x"][out["own_ids"]], out["own_x"]):
            raise AssertionError(f"rank {r}: gathered X is not its rows")
        rmse_gaps(f"sharded two ranks, rank {r}", out["history"],
                  res.history, "one rank")
    launches["two_ranks_each"] = want
    same = ranks[0]["theta_sha256"] == ranks[1]["theta_sha256"] and \
        np.array_equal(ranks[0]["x"], ranks[1]["x"])
    log(f"[sharded two ranks] theta SHA-256 after each iteration, rank 0 "
        f"{[d[:12] for d in ranks[0]['theta_sha256']]}, rank 1 "
        f"{[d[:12] for d in ranks[1]['theta_sha256']]}: equal bit for bit "
        f"{same}")
    if not same:
        raise AssertionError("the two ranks' theta (or X) differ")

    # K2 on rank 0's most populous theta partial (bf16 A) and K3 on that
    # block summed over both ranks as the all-reduce sums it (bf16 A: one
    # rounded add), at the final factors, on each rank's view
    tables = [ext16(v.shard_x(ranks[0]["x"])) for v in views]
    blocks = views[0]._blocks
    i = max(range(len(blocks)),
            key=lambda k: blocks[k].rows.shape[0] * blocks[k].width)
    ok2, checks["gather_gram_out"] = check_gram(
        cs, tables[0], blocks[i], torch.bfloat16, False,
        f"sharded two ranks: rank 0's partial of reduce block {i} of "
        f"{len(blocks)}")
    parts = [cs.gather_gram_out(t, v._blocks[i].cols, v._blocks[i].vals,
                                out_dtype=torch.bfloat16)
             for t, v in zip(tables, views)]
    a = (parts[0][0].float() + parts[1][0].float()).to(torch.bfloat16)
    b = parts[0][1] + parts[1][1]
    theta = views[0].replicate_theta(ranks[0]["theta"])
    ok3, checks["solve_cg_reg"] = check_k3(
        cs, a, b, chunk_x0(blocks[i], theta), blocks[i].nnz, 0,
        a.shape[0], scfg, what=f"reduce block {i} summed over the two ranks")
    del views, tables, parts, a, b, theta
    torch.cuda.empty_cache()
    if not (ok2 and ok3):
        raise AssertionError("K2 or K3 disagrees at the sharded shapes")
    return launches, checks


def sooc_run(cs, model, label, expect, x0, th0):
    """model.run (ShardedOutOfCoreALS), the launch counts and the peak
    device memory read around it alone; `expect`: the launches each
    kernel must make (every other kernel none). Logs each iteration's X
    and theta seconds."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launch_counts()
    res = model.run(x0, th0)
    torch.cuda.synchronize()
    got = {k: v for k, v in cs.LAUNCHES.items() if v}
    sharded_log(label, res.history, torch.cuda.max_memory_allocated(), got,
                "one card:")
    want = {k: v for k, v in expect.items() if v}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the plans say "
                             f"{want}")
    if not all(np.isfinite([h.train_rmse for h in res.history] +
                           [h.test_rmse for h in res.history])):
        raise AssertionError(f"{label}: non-finite RMSE")
    return res, got, torch.cuda.max_memory_allocated()


def sooc_expect(cs, model, iters):
    """The launches a ShardedOutOfCoreALS run of `iters` iterations
    makes on "pallas" with CG: K1 on each X chunk (and, on the direct
    theta route, on each theta chunk), with its pass 2 on each the cut
    takes, K2 on each theta step (each hot segment chunk), with its pass
    2 on each the cut takes, K3 once (once more with hot columns)."""
    n_x = len(model.row_plan.chunks)
    f = model.cfg.f_pad
    k1 = list(model.row_plan.chunks)
    if model._theta_direct:
        k1 += list(model.th_plan.chunks)
    pass_2 = theta_cuts(cs, map(gram_shape, k1), f, iters)
    if model._theta_direct:
        hot = len(model._hot_chunks)
        return {"gather_gram_cg": iters * (n_x + len(model.th_plan.chunks)),
                "gather_gram_out": iters * hot,
                "solve_cg_reg": iters * int(hot > 0),
                SPAN_SUM: span_sums(cs, [(len(c[0]), model.THETA_SEG_W)
                                         for c in model._hot_chunks], f,
                                    iters),
                SPAN_SOLVE: pass_2}
    return {"gather_gram_cg": iters * n_x,
            "gather_gram_out": iters * len(model.theta_steps),
            "solve_cg_reg": iters,
            SPAN_SUM: span_sums(cs, map(gram_shape, model.theta_steps), f,
                                iters),
            SPAN_SOLVE: pass_2}


def hot_k2_chunk(csc, pad, dev, p=1 << 18, r=16):
    """A hot-segment chunk of the direct theta route at P = p: the first
    p ratings of each of the r most rated theta columns of `csc`, one
    segment a row, pad slots naming X's zero row `pad` (the device X's
    m_loc: what _materialize_hot gives a column of more than p
    ratings)."""
    from types import SimpleNamespace
    indptr = np.asarray(csc.indptr, np.int64)
    lens = np.diff(indptr)
    top = np.argsort(-lens, kind="stable")[:r]
    cols = np.full((r, p), pad, np.int32)
    vals = np.zeros((r, p), np.float32)
    nnz = np.zeros(r, np.int32)
    for j, c in enumerate(top):
        k = int(min(lens[c], p))
        o = int(indptr[c])
        cols[j, :k] = csc.indices[o:o + k]
        vals[j, :k] = csc.data[o:o + k]
        nnz[j] = k
    return SimpleNamespace(
        cols=torch.from_numpy(cols).to(dev),
        vals=torch.from_numpy(vals).to(dev),
        nnz=torch.from_numpy(nnz).to(dev), panel=-1), lens[top]


def live_rows(ch) -> int:
    """The distinct table rows the live slots of a chunk name."""
    p = ch.cols.shape[1]
    live = torch.arange(p, device=ch.cols.device)[None, :] < \
        ch.nnz.long()[:, None]
    return int(torch.unique(ch.cols[live]).numel())


def sharded_ooc(cs, bench, ref_ooc=None):
    """Phase 11: ShardedOutOfCoreALS on hugewiki_mini at full width
    (F=100, bf16, CG, "pallas"; the data of phase 9, plans and CSC
    through the bench's plan cache): (a) one rank on an NCCL group of
    one, X on the host, 3 iterations, against phase 9's OutOfCoreALS run
    (`ref_ooc`; run here when None); (b) X on the card, theta on the
    direct route, 3 iterations, against (a), and, when no column passes
    THETA_SEG_W, one iteration with it lowered until 8 columns are hot,
    against (b)'s first; (c) (b) on lazy plans with a fresh plan cache
    (the stream stores built in iteration 0, read after), against (b)
    within 1e-6; (d) two ranks on the one card over gloo, spawned, X on
    the host, 2 iterations, against (a); then the port's bench with
    --mesh 1 --out-of-core. K1 (the widest direct theta chunk against
    the device X), K2 (a hot-segment chunk, R = 16, P = 2^18, f32 A) and
    K3 (the reduce solve of all of (a)'s theta systems, f32 A) are held
    to their plain versions. Returns each run's launches and the
    checks' numbers."""
    import functools
    import shutil
    from types import SimpleNamespace

    import torch.distributed as dist

    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.parallel import sharded_ooc as so
    from cumf_als_tpu_torch.parallel.mesh import (free_port,
                                                  init_distributed, spawn)
    from cumf_als_tpu_torch.utils.plan_cache import cached_transpose
    t_phase = time.monotonic()
    train, test, load_s = workload_data(bench, "hugewiki_mini",
                                        RECORDED_HUGEWIKI_MINI)
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=100,
                    nnz=train.nnz, nnz_test=test.nnz, lam=0.048,
                    iters=OOC_ITERS, solver="cg", backend="pallas",
                    factor_dtype="bf16", gram_dtype="bf16",
                    plan_cache_dir=bench.plan_cache_dir(), verbose=False,
                    debug_timing=True, host_offload_x=True, mesh_shape=(1,))
    csc = cached_transpose(cfg.plan_cache_dir, train)
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    dev = torch.device(DEV, 0)
    if ref_ooc is None:
        from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
        ooc = OutOfCoreALS(cfg, train, csc, test, device=dev)
        ref_ooc = ooc.run(x0, th0)
        del ooc
        torch.cuda.empty_cache()
    launches, checks, runs = {}, {}, {}
    mesh = init_distributed("nccl", f"tcp://localhost:{free_port()}", 1, 0,
                            device=dev)
    try:
        # (a) X on the host
        t0 = time.monotonic()
        a = so.ShardedOutOfCoreALS(cfg, train, csc, test, mesh=mesh)
        log(f"[sooc a] plans {time.monotonic() - t0:.1f} s (built once into "
            f"the plan cache); backend {mesh.backend}, world "
            f"{mesh.world_size}; X {len(a.row_plan.chunks)} chunks, "
            f"{a.row_plan.m_loc} rows in the host shard ({a.x_store.dtype}, "
            f"pinned {a.x_store.is_pinned()}); theta {len(a.theta_steps)} "
            f"steps over {a.n_panels} X panels of {a.panel_size} rows, "
            f"accumulators {a.accum_dtype} (n_pad {a.n_pad}), one K3 call "
            f"an iteration")
        if not (a.x_store.is_pinned() and a.x_store.dtype ==
                torch.bfloat16):
            raise AssertionError("the X store is not pinned bf16 memory")
        res_a, launches["a"], peak_a = sooc_run(
            cs, a, "sooc a (host)", sooc_expect(cs, a, OOC_ITERS), x0, th0)
        runs["a"] = res_a.history
        rmse_gaps("sooc a", res_a.history, ref_ooc.history, "out-of-core")
        dx = np.abs(res_a.x - ref_ooc.x).max()
        dth = np.abs(res_a.theta - ref_ooc.theta).max()
        log(f"[sooc a | out-of-core] max|x diff| {dx:.3e}, max|theta diff| "
            f"{dth:.3e} (rtol, atol 2e-2); peak device memory "
            f"{peak_a / 2**30:.2f} GiB")
        if not (np.allclose(res_a.x, ref_ooc.x, rtol=2e-2, atol=2e-2) and
                np.allclose(res_a.theta, ref_ooc.theta, rtol=2e-2,
                            atol=2e-2)):
            raise AssertionError("sooc a: factors off the out-of-core run")
        # K3 on the reduce solve of all theta systems, at (a)'s end state
        acc_a, acc_b = a.theta_accumulators()
        a_f = acc_a.float()
        del acc_a
        theta_a = torch.zeros((cfg.n, cfg.f_pad), device=dev)
        theta_a[:, :cfg.f] = torch.from_numpy(res_a.theta).to(dev)
        ok3, checks["solve_cg_reg"] = check_k3(
            cs, a_f, acc_b, torch.nn.functional.pad(
                theta_a, (0, 0, 0, a.n_pad - cfg.n)), a._theta_nnz_pad, 0,
            a.n_pad, cfg, what="the reduce solve of theta, all")
        del a_f, acc_b, theta_a, a
        torch.cuda.empty_cache()

        # (b) X on the card, theta direct
        cfg_d = cfg.replace(x_placement="device")
        t0 = time.monotonic()
        b = so.ShardedOutOfCoreALS(cfg_d, train, csc, test, mesh=mesh)
        widest = max(range(len(b.th_plan.chunks)),
                     key=lambda i: b.th_plan.chunks[i].width)
        log(f"[sooc b] plans {time.monotonic() - t0:.1f} s; X on the card "
            f"({b.m_loc_pad} rows, {b.store_dtype}); theta direct: "
            f"{len(b.th_plan.chunks)} chunks, the widest P="
            f"{b.th_plan.chunks[widest].width}; "
            f"{b._hot_rows.size} columns above THETA_SEG_W = "
            f"{b.THETA_SEG_W} ratings ({len(b._hot_chunks)} segment "
            f"chunks)")
        res_b, launches["b"], peak_b = sooc_run(
            cs, b, "sooc b (device)", sooc_expect(cs, b, OOC_ITERS), x0, th0)
        runs["b"] = res_b.history
        rmse_gaps("sooc b", res_b.history, res_a.history, "sooc a")
        log(f"[sooc b] peak device memory {peak_b / 2**30:.2f} GiB")
        # K1 on the widest direct theta chunk against a device X of (b)'s
        # shape, at the initial factors as phases 2a and 10a hold K1 (a
        # stand-in X: the real one starts at zero; K1's se limit holds at
        # the initial factors, not at a converged state)
        (u,), _ = b._th.upload(widest, widest + 1, dev)
        c = SimpleNamespace(cols=u.cols, vals=u.vals, nnz=u.nnz, rows=u.rows,
                            n_real=u.n_real, rows_real=u.rows[:u.n_real])
        gen = torch.Generator(device=DEV).manual_seed(1)
        x_t = torch.zeros_like(b._x_dev)
        x_t[:b.row_plan.m_loc, :cfg.f] = 0.2 * torch.rand(
            (b.row_plan.m_loc, cfg.f), generator=gen, device=dev)
        theta_t = torch.zeros((cfg.n, cfg.f_pad), device=dev)
        theta_t[:, :cfg.f] = torch.from_numpy(th0 * (
            b.theta_nnz > 0)[:, None]).to(dev)
        ok1, checks["gather_gram_cg"] = check_k1(
            cs, x_t, c, theta_t, cfg,
            f"sooc b: the widest direct theta chunk ({widest} of "
            f"{len(b.th_plan.chunks)}, {c.n_real} real rows) against a "
            f"device X of {x_t.shape[0]} rows, initial factors",
            table_rows=live_rows(c), se_exact=True, cut=True)
        # the se limit of the cut's steps must see a K1 that drops the
        # last 1/64 of the row
        sees = checks["gather_gram_cg"]["wrong_1_64"] == "rejects"
        log(f"[sooc b] the se check rejects the K1 that drops 1/64 of the "
            f"row: {sees}")
        ok1 &= sees
        del x_t
        # K2 on a hot-segment chunk at P = 2^18 (f32 A)
        hot, hot_lens = hot_k2_chunk(b.train_csc, b.row_plan.m_loc, dev)
        ok2, checks["gather_gram_out"] = check_gram(
            cs, b._x_dev, hot, torch.float32, False,
            f"sooc b: a hot-segment chunk of the 16 most rated columns "
            f"({hot_lens.min()}..{hot_lens.max()} ratings, the first 2^18 "
            f"of each)", table_rows=live_rows(hot), cut=True)
        del c, u, theta_t, hot
        if not (ok1 and ok2 and ok3):
            raise AssertionError("K1, K2 or K3 disagrees at the sharded "
                                 "out-of-core shapes")
        if not b._hot_rows.size:   # lower THETA_SEG_W until 8 are hot
            lens = np.sort(np.diff(np.asarray(csc.indptr)))[::-1]
            seg = int(lens[7]) - 1
            cls = so.ShardedOutOfCoreALS
            saved = cls.THETA_SEG_W
            cls.THETA_SEG_W = seg
            try:
                bh = so.ShardedOutOfCoreALS(cfg_d.replace(iters=1), train,
                                            csc, test, mesh=mesh)
            finally:
                cls.THETA_SEG_W = saved
            log(f"[sooc b hot] THETA_SEG_W lowered to {seg}: "
                f"{bh._hot_rows.size} hot columns "
                f"({bh._hot_nnz.min()}..{bh._hot_nnz.max()} ratings) in "
                f"{len(bh._hot_chunks)} segment chunks of "
                f"{len(bh._hot_chunks[0][0])} rows")
            res_h, launches["b_hot"], _ = sooc_run(
                cs, bh, "sooc b hot", sooc_expect(cs, bh, 1), x0, th0)
            runs["b_hot"] = res_h.history
            rmse_gaps("sooc b hot", res_h.history, res_b.history, "sooc b")
            del bh
        del b
        torch.cuda.empty_cache()

        # (c) (b) on lazy plans, a fresh plan cache: the stream stores
        lazy_dir = os.path.join(bench.CACHE_DIR, "plans_lazy_smoke")
        shutil.rmtree(lazy_dir, ignore_errors=True)
        try:
            t0 = time.monotonic()
            lz = so.ShardedOutOfCoreALS(
                cfg_d.replace(plan_cache_dir=lazy_dir), train, csc, test,
                mesh=mesh, lazy_nnz_threshold=1)
            log(f"[sooc c] lazy plans built in {time.monotonic() - t0:.1f} "
                f"s into a fresh plan cache; stream stores ready: X "
                f"{lz._x_stream.ready}, theta {lz._theta_stream.ready}")
            res_c, launches["c"], _ = sooc_run(
                cs, lz, "sooc c (lazy)", sooc_expect(cs, lz, OOC_ITERS), x0,
                th0)
            runs["c"] = res_c.history
            sizes = {k: os.path.getsize(os.path.join(lazy_dir, "streams", k))
                     for k in os.listdir(os.path.join(lazy_dir, "streams"))}
            log(f"[sooc c] stream stores {sizes}; ready: X "
                f"{lz._x_stream.ready}, theta {lz._theta_stream.ready} "
                f"(iteration 0 built them, 1 and 2 read them)")
            if not (lz.lazy and lz._x_stream.ready and
                    lz._theta_stream.ready):
                raise AssertionError("sooc c: plans not lazy or the stream "
                                     "stores not built")
            rmse_gaps("sooc c", res_c.history, res_b.history, "sooc b",
                      limit=1e-6)
            del lz
        finally:
            shutil.rmtree(lazy_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (d) two ranks on the one card over gloo, spawned
    its = 2
    t0 = time.monotonic()
    ranks = spawn(2, so.run_rank, cfg.replace(iters=its, mesh_shape=(2,)),
                  functools.partial(bench.load_workload, "hugewiki_mini",
                                    1.0),
                  None, th0, backend="gloo", device=DEV + ":0", timeout=900)
    log(f"[sooc d] two ranks spawned, loaded the cached data, built and ran "
        f"in {time.monotonic() - t0:.1f} s")
    for r, out in enumerate(ranks):
        sharded_log(f"sooc d, rank {r}", out["history"], out["peak_bytes"],
                    out["launches"], "gloo over one card (two processes on "
                    "cuda:0, the partials through host memory; not a "
                    "multi-GPU time):")
        want = {"gather_gram_cg": its * out["x_chunks"],
                "gather_gram_out": its * out["theta_steps"],
                "solve_cg_reg": its}
        got = {k: v for k, v in out["launches"].items() if v}
        # pass 2 of K2's cut: the ranks run the same steps in lockstep,
        # so the same number of them, at most one a K2 launch; pass 2 of
        # K1's cut at most one a K1 launch on the rank's own X chunks
        sums = [o["launches"].get(SPAN_SUM, 0) for o in ranks]
        if got.pop(SPAN_SUM, 0) != sums[0] or sums[0] != sums[1] or \
                sums[0] > want["gather_gram_out"]:
            raise AssertionError(f"sooc d rank {r}: pass 2 of K2's cut "
                                 f"launched {sums} times")
        if got.pop(SPAN_SOLVE, 0) > want["gather_gram_cg"]:
            raise AssertionError(f"sooc d rank {r}: pass 2 of K1's cut "
                                 f"launched more often than K1")
        if got != want:
            raise AssertionError(f"sooc d rank {r}: launches {got}, the "
                                 f"plans say {want}")
        if not out["own_rows_match"]:
            raise AssertionError(f"sooc d rank {r}: gathered X is not its "
                                 f"rows")
        log(f"[sooc d] rank {r} all-reduces {out['allreduce_bytes']} bytes "
            f"an iteration (theta's A and b in f32, and the test error)")
        rmse_gaps(f"sooc d, rank {r}", out["history"], res_a.history,
                  "sooc a")
    launches["d_each"] = want
    same = ranks[0]["theta_sha256"] == ranks[1]["theta_sha256"] and \
        ranks[0]["x_sha256"] == ranks[1]["x_sha256"]
    log(f"[sooc d] theta SHA-256 after each iteration, rank 0 "
        f"{[d[:12] for d in ranks[0]['theta_sha256']]}, rank 1 "
        f"{[d[:12] for d in ranks[1]['theta_sha256']]}; X equal: "
        f"{ranks[0]['x_sha256'] == ranks[1]['x_sha256']}")
    if not same:
        raise AssertionError("the two ranks' theta (or X) differ")
    del ranks

    line = run_bench(["--workload", "hugewiki_mini", "--out-of-core",
                      "--mesh", "1", "--iters", str(OOC_ITERS)],
                     "bench sharded ooc")
    if list(line) != BENCH_KEYS or \
            line["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench sharded ooc: {line}")
    if abs(line["train_rmse_final"] - res_a.history[-1].train_rmse) > 2e-3:
        raise AssertionError("bench sharded ooc: train RMSE off (a)'s")
    log(f"[sooc] phase 11 took {time.monotonic() - t_phase:.1f} s")
    return launches, checks


HUGEWIKI_SCALE = 0.04
HW_ITERS = 2
# the theta seconds of 12a's two iterations before K1's cut (every theta
# chunk on the uncut kernel; PERF.md §5, a run of chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700.00 W): printed beside this run's only
UNCUT_HW_THETA_S = (0.2129, 0.2009)


def hw_main(argv, label):
    """cumf_als_tpu_torch.hugewiki_full.main(argv) in this process: its
    stdout is logged, its last line (JSON) returned, with the unrounded
    seconds of each theta update its log printed (the JSON's are
    rounded to 0.1 s) under "theta_run_seconds"."""
    import contextlib
    import io
    import re

    from cumf_als_tpu_torch import hugewiki_full as hw
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = hw.main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        log(f"[{label}] {line}")
    log(f"[{label}] {lines[-1]}")
    if rc != 0:
        raise AssertionError(f"{label}: exit {rc}")
    out = json.loads(lines[-1])
    out["theta_run_seconds"] = [float(x) for line in lines[:-1] for x in
                                re.findall(r"update theta run (\S+) seconds",
                                           line)]
    return out


def hw_process(cmd, label, timeout=600):
    """A command of the hugewiki driver in a subprocess from this
    checkout (its output logged); returns its last stdout line."""
    t0 = time.monotonic()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    for line in (out.stderr + out.stdout).splitlines():
        log(f"[{label}] {line}")
    if out.returncode != 0:
        raise AssertionError(f"{label}: exit {out.returncode}")
    log(f"[{label}] {time.monotonic() - t0:.1f} s")
    return out.stdout.strip().splitlines()[-1]


def hw_gaps(label, history, single, limit=2e-4):
    """A state dir's per-iteration RMSEs against the single-process
    run's."""
    worst = 0.0
    for h in history:
        i = h["iter"]
        worst = max(worst, abs(h["train_rmse"] - single["train_rmse"][i]),
                    abs(h["test_rmse"] - single["test_rmse"][i]))
        log(f"[{label}] iter {i}: train {h['train_rmse']} | "
            f"{single['train_rmse'][i]}, test {h['test_rmse']} | "
            f"{single['test_rmse'][i]} (state dir | one process; limit "
            f"{limit:g}); n_compiles {h['n_compiles']}")
    if worst > limit or [h["iter"] for h in history] != \
            list(range(len(single["train_rmse"]))):
        raise AssertionError(f"{label}: off the single-process run by "
                             f"{worst:.3e}")


def hugewiki_driver(cs, bench):
    """Phase 12a: the full-hugewiki driver on hugewiki at HUGEWIKI_SCALE,
    F=100 (see the module docstring). Returns the launches of the
    in-process run with X on the card and the numbers of the phase."""
    import shutil

    from cumf_als_tpu_torch import hugewiki_full as hw
    from cumf_als_tpu_torch.parallel import sharded_ooc as so
    t0 = time.monotonic()
    train, test = bench.load_workload("hugewiki", HUGEWIKI_SCALE)
    log(f"[hugewiki] scale {HUGEWIKI_SCALE}: m={train.num_rows} "
        f"n={train.num_cols} nnz={train.nnz} nnz_test={test.nnz}, CRC-32 "
        f"{bench.dataset_crc32(train, test)}; "
        f"{time.monotonic() - t0:.1f} s to load (generating it on first "
        f"use)")
    base = ["--scale", str(HUGEWIKI_SCALE), "--iters", str(HW_ITERS)]
    out = {}
    # 1. X on the card, one process, cold CG starts (the state dir's)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launch_counts()
    single = hw_main(base + ["--x-warm-start", "off"], "hugewiki device")
    torch.cuda.synchronize()
    got = {k: v for k, v in cs.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    # the plans the run took, read back from the plan cache
    args = hw.build_parser().parse_args(base + ["--x-warm-start", "off"])
    model = so.ShardedOutOfCoreALS(hw.make_config(args, train, test),
                                   train, None, test, n_devices=1,
                                   device=DEV)
    lens = np.diff(np.asarray(model.train_csc.indptr))
    want = sooc_expect(cs, model, HW_ITERS)
    log(f"[hugewiki device] {len(model.row_plan.chunks)} X chunks, "
        f"{len(model.th_plan.chunks)} direct theta chunks; "
        f"{model._hot_rows.size} columns above THETA_SEG_W = "
        f"{model.THETA_SEG_W} ratings (the most rated: {lens.max()}) in "
        f"{len(model._hot_chunks)} hot-segment chunks; launches {got}, the "
        f"plans say { {k: v for k, v in want.items() if v} }; peak device "
        f"memory {peak / 2**30:.2f} GiB; s/iter {single['value']} "
        f"(x {single['x_seconds']}, theta {single['theta_seconds']})")
    sms = sm_count()
    cut_t = sum(cs.theta_spans(*gram_shape(c), model.cfg.f_pad, sms) > 1
                for c in model.th_plan.chunks)
    cut_x = sum(cs.theta_spans(*gram_shape(c), model.cfg.f_pad, sms) > 1
                for c in model.row_plan.chunks)
    log(f"[hugewiki device] K1's cut: {cut_t} of the "
        f"{len(model.th_plan.chunks)} direct theta chunks and {cut_x} of "
        f"the {len(model.row_plan.chunks)} X chunks under 264 rows cut; "
        f"in {HW_ITERS} iterations K1 (pass 1 on the cut chunks, the uncut "
        f"kernel on the others) launched {got.get('gather_gram_cg', 0)} "
        f"times, pass 2 ({SPAN_SOLVE}) {got.get(SPAN_SOLVE, 0)} times; "
        f"theta seconds {single['theta_run_seconds']} against "
        f"{list(UNCUT_HW_THETA_S)} uncut (PERF.md §5)")
    out.update(hot_columns=int(model._hot_rows.size),
               hot_chunks=len(model._hot_chunks), most_rated=int(lens.max()),
               peak_bytes=peak, single=single, theta_cut_chunks=cut_t,
               x_cut_chunks=cut_x)
    del model
    torch.cuda.empty_cache()
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError("hugewiki device: launches off the plans")
    if single["n_compiles"] != 0 or not np.isfinite(
            single["train_rmse"] + single["test_rmse"]).all():
        raise AssertionError(f"hugewiki device: {single}")

    state = os.path.join(bench.CACHE_DIR, "hugewiki_state_smoke")
    shutil.rmtree(state, ignore_errors=True)
    try:
        # 2. the same iterations, one process each, through the loop
        driver = ["bash", os.path.join(ROOT, "scripts",
                                       "torch_hugewiki_full_driver.sh"),
                  str(HW_ITERS), str(HUGEWIKI_SCALE)]
        hw_process(driver + [os.path.join(state, "device")],
                   "hugewiki driver")
        with open(os.path.join(state, "device", "state.json")) as fh:
            st = json.load(fh)
        hw_gaps("hugewiki driver", st["history"], single)
        # 3. once more: a no-op that prints the state
        last = hw_process([sys.executable, "-m",
                           "cumf_als_tpu_torch.hugewiki_full", *base,
                           "--state-dir", os.path.join(state, "device")],
                          "hugewiki no-op", timeout=120)
        if json.loads(last) != st:
            raise AssertionError("hugewiki no-op: not the final state")
        # 4. X on the host: one process, then iteration 0 here and
        # iteration 1 in a process of its own, through x_host.npy
        host = base + ["--x-placement", "host"]
        single_h = hw_main(host, "hugewiki host")
        hd = os.path.join(state, "host")
        hw_main(host + ["--state-dir", hd], "hugewiki host, iteration 0")
        x_path = os.path.join(hd, "x_host.npy")
        x_host = np.load(x_path, mmap_mode="r")
        log(f"[hugewiki host] x_host.npy: dtype {x_host.dtype}, shape "
            f"{x_host.shape}, {os.path.getsize(x_path)} bytes")
        if x_host.dtype != np.dtype("V2") or x_host.shape[0] != 1:
            raise AssertionError("hugewiki host: x_host.npy is not the "
                                 "bf16 '<V2' store")
        del x_host
        hw_process(driver + [hd, "--x-placement", "host"],
                   "hugewiki host driver")
        with open(os.path.join(hd, "state.json")) as fh:
            st_h = json.load(fh)
        hw_gaps("hugewiki host", st_h["history"], single_h)
        out.update(single_host=single_h, state=st, state_host=st_h)
    finally:
        shutil.rmtree(state, ignore_errors=True)
    return got, out


def integrations(cs, bench):
    """Phase 12: the hugewiki driver (a), entry() (b),
    dryrun_multichip() (c) and the torch op (d) on the card (see the
    module docstring). Returns the K1/K2/K3 launches of (a)'s run with X
    on the card, K4's check at entry()'s shapes and the numbers of the
    phase."""
    import importlib.util

    from cumf_als_tpu_torch.data.synthetic import synthetic_ratings
    from cumf_als_tpu_torch.entry import dryrun_multichip, entry
    from cumf_als_tpu_torch.integrations.torch_op import TorchMF, do_als
    from cumf_als_tpu_torch.ops.gram import extend_table, gram_rhs
    from cumf_als_tpu_torch.ops.solve import solve
    t_phase = time.monotonic()
    hw_launches, out = hugewiki_driver(cs, bench)
    log(f"[integrations] 12a took {time.monotonic() - t_phase:.1f} s")

    # (b) entry(): its CG through K4 once, against the CPU
    fn, args = entry()
    cs.reset_launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    launched = {k: v for k, v in cs.LAUNCHES.items() if v}
    cfn, cargs = entry(device="cpu")
    err = (got.cpu() - cfn(*cargs)).abs().max().item()
    log(f"[entry] fn on the card: launches {launched}; max|pred - cpu| "
        f"{err:.3e} (limit 5e-3: a CG row near the exit threshold may "
        f"stop one step apart); predictions up to "
        f"{got.abs().max().item():.3f}")
    if launched != {"solve_cg": 1} or err > 5e-3:
        raise AssertionError("entry(): K4 not launched once, or off the CPU")
    theta, cols, vals, nnz, x0 = args[:5]
    a, b = gram_rhs(extend_table(theta), cols, vals, nnz, 0.048)
    ok, k4 = check_solve(cs, "solve_cg", (a, b, x0),
                         "ops.solve.solve without diag, entry()'s systems",
                         fn=dispatch_k4(solve))
    if not ok:
        raise AssertionError("K4 disagrees at entry()'s shapes")
    k4["entry_launches"] = launched["solve_cg"]

    # (c) the multi-rank dry run: one rank (NCCL), two on one card (gloo)
    dry = {}
    for n in (1, 2):
        t0 = time.monotonic()
        card_n = dryrun_multichip(n)
        cpu_n = dryrun_multichip(n, device="cpu")
        gaps = {k: abs(card_n[k] - cpu_n[k]) / (abs(cpu_n[k])
                                               if k == "train_se" else 1.0)
                for k in card_n if k != "n_panels"}
        log(f"[dryrun {n}] card {card_n} | cpu {cpu_n}; gaps {gaps} "
            f"(limit 2e-3; train_se relative); {time.monotonic() - t0:.1f} "
            f"s for both")
        if card_n["n_panels"] != cpu_n["n_panels"] or not all(
                np.isfinite(card_n[k]) and g <= 2e-3
                for k, g in gaps.items()):
            raise AssertionError(f"dryrun_multichip({n}) off the CPU")
        dry[n] = card_n

    # (d) the torch op on the card against the CPU
    train, test = synthetic_ratings(m=300, n=220, nnz=12000, nnz_test=1500,
                                    rank=6, noise=0.1, seed=7)
    host = [torch.from_numpy(x) for x in (
        train.indptr.astype(np.int64), train.indices, train.data, test.row,
        test.col, test.data)]
    op = {}
    for dev in (DEV, "cpu"):
        op[dev] = do_als(*[t.to(dev) for t in host], 300, 220, 16, 0.05,
                         iters=3, device=dev)
    thetat, xt, rmse = op[DEV]
    pred = TorchMF(xt, thetat).predict(host[3].to(DEV), host[4].to(DEV))
    e = pred.cpu().numpy() - test.data
    mf_rmse = float(np.sqrt(np.mean(e * e)))
    d_rmse = abs(float(rmse) - float(op["cpu"][2]))
    log(f"[torch op] card rmse {float(rmse):.6f}, cpu "
        f"{float(op['cpu'][2]):.6f} (limit 1e-4); TorchMF.predict's RMSE "
        f"{mf_rmse:.6f} (within 1e-3 relative of the op's); outputs on "
        f"{thetat.device}")
    if not (thetat.device.type == DEV and d_rmse <= 1e-4 and
            abs(mf_rmse - float(rmse)) <= 1e-3 * float(rmse)):
        raise AssertionError("integrations.torch_op off the CPU")
    log("[tf op] not run: TensorFlow is " + (
        "not installed on this machine" if importlib.util.find_spec(
            "tensorflow") is None else "installed, but the TF op is held "
        "to the JAX package's on the CPU alone") +
        " (tests/test_torch_integrations.py)")
    log(f"[integrations] phase 12 took {time.monotonic() - t_phase:.1f} s")
    return hw_launches, k4, dict(out, dryrun=dry, op_rmse=float(rmse))


def batched_models(ALS, cfg, train, csc, test, gram_dtype):
    """The batched-panel model (X in 5 row batches of 4096) and the panel
    model it is held against, both built from a config with this
    gram_dtype."""
    from cumf_als_tpu_torch.ops.tiling import (BatchedPanelPlan, PanelPlan,
                                               UpdatePlan)
    base = cfg.replace(solver="cholesky", gram_dtype=gram_dtype,
                       verbose=False)
    t0 = time.monotonic()
    batched = ALS(base.replace(panel_budget_bytes=1 << 29, batch_rows=4096),
                  train, csc, test, device="cuda")
    panel = ALS(base, train, csc, test, device="cuda")
    plan = batched.plan_x[0]
    if not (isinstance(plan, BatchedPanelPlan) and len(plan.batches) == 5
            and isinstance(batched.plan_theta[0], UpdatePlan)
            and isinstance(panel.plan_x[0], PanelPlan)):
        raise AssertionError(f"{gram_dtype}: expected 5 row batches of X "
                             "and direct theta")
    log(f"[batched panel] {gram_dtype} plans {time.monotonic() - t0:.1f} "
        f"s; X phase: {len(plan.batches)} batches of {plan.batch_rows} "
        f"rows, {sum(len(b.plan.chunks) for b in plan.batches)} chunks "
        f"(the panel route: {len(panel.plan_x[1])}); theta: "
        f"{len(batched.plan_theta[1])} direct chunks")
    return batched, panel


def x_row_terms(batched_plan, panel_plan, m):
    """Per X row, the larger of the two routes' count of partials added
    into its accumulator (its subrows, d) and its longest subrow (w): the
    terms of `x_phase_rows`' bound."""
    depth = np.zeros((2, m), np.int64)
    width = np.zeros((2, m), np.int64)

    def add(k, rows, nnz):
        np.add.at(depth[k], rows, 1)
        np.maximum.at(width[k], rows, nnz)

    for c in panel_plan.chunks:
        live = c.nnz > 0
        add(0, c.rows[live], c.nnz[live])
    for b in batched_plan.batches:
        for c in b.plan.chunks:
            live = c.nnz > 0
            add(1, b.global_ids[c.rows[live]], c.nnz[live])
    return depth.max(axis=0), width.max(axis=0)


def iteration0_theta(model, th0):
    """The table the first X phase of `model.run(x0, th0)` reads."""
    theta = model._pad_f(th0)
    theta *= torch.from_numpy(
        np.diff(model.train_csc.indptr) > 0).to(DEV)[:, None]
    return theta


def x_phase_rows(batched, panel, theta):
    """One X phase of each route on the same theta, row by row.

    Grams: every batch's accumulators (A, b) against the panel route's at
    the batch's global ids, entry by entry. With theta >= 0 and ratings
    > 0 every partial is >= 0 entry by entry, so the partials of a row
    sum in absolute value to A and b themselves, and a route's sums lie
    within (w 2^-22 + d u + u_p) of them: the kernel's f32 sum over a
    subrow's w live slots (2^-22 a slot leaves room for tensor cores that
    truncate), one rounding to the accumulator's unit u (2^-9 bf16, 2^-24
    f32) per partial added, and u_p = 2^-9 for a bf16 partial (b is f32:
    its u is 2^-24, u_p 0). The two routes may differ by twice that;
    another 10% covers taking the panel route's A for the exact one.
    Returns the largest |difference| / bound of A and of b, which must be
    at most 1.

    Solutions: both routes start from a sentinel; every row with ratings
    must be written, and the per-row relative difference of x is
    returned (its limit is the caller's)."""
    from cumf_als_tpu_torch.models.als import accumulate_into
    plan, _, aux = batched.plan_x
    m = plan.num_rows
    if not bool((theta >= 0).all()):
        raise AssertionError("the bound needs theta >= 0")
    depth, width = x_row_terms(plan, panel.plan_x[0], m)
    depth = torch.from_numpy(depth).to(DEV, torch.float32)
    width = torch.from_numpy(width).to(DEV, torch.float32)
    a_p, b_p = panel.accumulate_panels(theta, panel.plan_x)
    bf16 = a_p.dtype == torch.bfloat16
    u_a = 2.0 ** -9 if bf16 else 2.0 ** -24
    term_a = 2.2 * (width * 2.0 ** -22 + depth * u_a
                    + (2.0 ** -9 if bf16 else 0.0))
    term_b = 2.2 * (width * 2.0 ** -22 + depth * 2.0 ** -24)
    table_pad = batched._panel_table(
        theta, -(-plan.num_cols // plan.panel_size), plan.panel_size)
    a_full, b_full = batched._accumulators(plan.batch_rows + 1, a_p.dtype)
    worst_a = worst_b = 0.0
    for gids, _, chunks in aux["batches"]:
        a_full.zero_()
        b_full.zero_()
        accumulate_into(a_full, b_full, table_pad, chunks, plan.panel_size,
                        batched.cfg.backend == "pallas")
        k = gids.shape[0]
        want = a_p.index_select(0, gids).float()
        bound = term_a[gids][:, None, None] * want.abs()
        diff = (a_full[:k].float() - want).abs()
        worst_a = max(worst_a, (diff / bound.clamp_min(1e-30)).max().item())
        del want, bound, diff
        want = b_p.index_select(0, gids)
        bound = term_b[gids][:, None] * want.abs()
        diff = (b_full[:k] - want).abs()
        worst_b = max(worst_b, (diff / bound.clamp_min(1e-30)).max().item())
    del a_p, b_p, a_full, b_full
    live = torch.from_numpy(np.diff(batched.train_csr.indptr) > 0).to(DEV)
    sentinel = torch.full((m, theta.shape[1]), 7.0, device=DEV)
    gx, _ = batched._update_phase(theta, sentinel.clone(), batched.plan_x,
                                  False)
    px, _ = panel._update_phase(theta, sentinel.clone(), panel.plan_x,
                                False)
    written = bool((~(gx[live] == 7.0).all(dim=1)).all()) and \
        bool((~(px[live] == 7.0).all(dim=1)).all())
    rel = ((gx - px)[live].norm(dim=1)
           / px[live].norm(dim=1).clamp_min(1e-30))
    torch.cuda.synchronize()
    return {"gram_a_of_bound": worst_a, "gram_b_of_bound": worst_b,
            "rows_written": written, "x_rel_max": rel.max().item(),
            "x_rel_p999": rel.quantile(0.999).item(),
            "x_rel_median": rel.median().item(),
            "max_depth": int(depth.max().item()),
            "max_width": int(width.max().item())}


def batched_panel(cs, ALS, cfg, train, csc, test, x0, th0):
    """The batched-panel X route (K2 into 4096-row accumulators, Cholesky)
    against the panel route on the same settings, with f32 and with bf16
    accumulators: one X phase row by row (`x_phase_rows`), then the
    trajectory, each iteration within 1e-3 (train) and 2e-3 (test) of
    the panel route's. With bf16 accumulators a limit widens to the
    distance that bf16 rounding itself puts between the panel route's
    bf16 and f32 runs at that iteration, where that is larger: the order
    of the bf16 adds differs between the routes, and at iteration 1 that
    alone moved the gap from 5.8e-4 to 1.1e-3 over five runs
    (scripts/torch_batched_readings.py). Returns K2's launches on the
    route (bf16, f32)."""
    if not float(train.data.min()) > 0:
        raise AssertionError("the Gram bound needs ratings > 0")
    others = tuple(k for k in REPLACES
                   if k not in ("gather_gram_out", SPAN_SUM))
    k2, runs = {}, {}
    for gram_dtype in ("f32", "bf16"):
        batched, panel = batched_models(ALS, cfg, train, csc, test,
                                        gram_dtype)
        rows = x_phase_rows(batched, panel, iteration0_theta(panel, th0))
        limit = F32_X_ROW_LIMIT if gram_dtype == "f32" else None
        log(f"[batched panel] {gram_dtype} one X phase against the panel "
            f"route, row by row: {rows} (Gram entries within their "
            f"rounding bound at <= 1; x per row {limit or 'logged'})")
        if not (rows["rows_written"] and rows["gram_a_of_bound"] <= 1.0
                and rows["gram_b_of_bound"] <= 1.0
                and (limit is None or rows["x_rel_max"] <= limit)):
            raise AssertionError(f"{gram_dtype}: the batched-panel X phase "
                                 "differs from the panel route's")
        got, launches = full_width(cs, batched, f"batched {gram_dtype}",
                                   ("gather_gram_out",), others, x0, th0)
        want, _ = full_width(cs, panel, f"panel {gram_dtype}",
                             ("gather_gram_out",), others, x0, th0)
        k2[gram_dtype] = launches["gather_gram_out"]
        runs[gram_dtype] = (got, want)
        del batched, panel
        torch.cuda.empty_cache()
    ok = True
    for gram_dtype in ("f32", "bf16"):
        got, want = runs[gram_dtype]
        for g, w, w32 in zip(got, want, runs["f32"][1]):
            lim_tr, lim_te = 1e-3, 2e-3
            if gram_dtype == "bf16":
                lim_tr = max(lim_tr, abs(w.train_rmse - w32.train_rmse))
                lim_te = max(lim_te, abs(w.test_rmse - w32.test_rmse))
            dtr = abs(g.train_rmse - w.train_rmse)
            dte = abs(g.test_rmse - w.test_rmse)
            log(f"[batched panel] {gram_dtype} iter {g.iteration}: train "
                f"{g.train_rmse:.6f} | panel {w.train_rmse:.6f} (gap "
                f"{dtr:.2e}, limit {lim_tr:.2e}), test {g.test_rmse:.6f} | "
                f"{w.test_rmse:.6f} (gap {dte:.2e}, limit {lim_te:.2e})")
            ok &= dtr <= lim_tr and dte <= lim_te
    if not ok:
        raise AssertionError("the batched-panel route left the panel "
                             "route's trajectory")
    return [k2["bf16"], k2["f32"]]


# ----------------------------------------------------------- phase 13 --
# iterations of the runs of phase 13: (c) out of core and its in-core
# reference, (d) each panel run (phase 5's wide-off run is its reference)
P256_OOC_ITERS = 3
P256_PANEL_ITERS = 2
def panel_chunk(f, r, p, seed, n=65536, signed=True):
    """A synthetic panel chunk at width f: a bf16 panel table of n rows
    (0.3 N(0, 1), or with `signed` False 0.2 U(0, 1) as
    `synthetic_table`) and its zero row (lane f - 1 free for the aug
    form), R rows of P slots with nnz from 0 to P (one row in 64 without
    ratings), pad slots at each row's tail naming the zero row, values
    in halves."""
    from types import SimpleNamespace
    gen = torch.Generator(device=DEV).manual_seed(seed)
    tp = (0.3 * torch.randn((n + 1, f), generator=gen, device=DEV)
          if signed else
          0.2 * torch.rand((n + 1, f), generator=gen, device=DEV)
          ).to(torch.bfloat16)
    tp[n] = 0
    tp[:, f - 1] = 0
    nnz = torch.randint(1, p + 1, (r,), generator=gen, device=DEV,
                        dtype=torch.int32)
    nnz[::64] = 0
    mask = torch.arange(p, device=DEV)[None, :] < nnz[:, None]
    cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                           device=DEV), n).to(torch.int32)
    vals = (torch.randint(2, 11, (r, p), generator=gen, device=DEV) / 2.0
            * mask).float()
    return tp, SimpleNamespace(cols=cols, vals=vals, nnz=nnz, panel=0)


def solve_systems(cs, f, lam=0.048, r=16384, p=64, seed=11):
    """The systems of the solve checks at width f: K2's (A, b) and K5a's
    A' of one synthetic panel chunk of R rows (A f32), the diagonal
    nnz lam + [nnz = 0], a warm start with lane f - 1 and the empty
    rows zero, and the mask of the empty rows."""
    tp, ch = panel_chunk(f, r, p, seed)
    r = ch.cols.shape[0]
    a, b = cs.gather_gram_out(tp, ch.cols, ch.vals)
    a_aug = cs.gather_gram_aug_out(tp, ch.cols, ch.vals)
    nnzf = ch.nnz.float()
    diag = nnzf * lam + (nnzf == 0).float()
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    x0 = 0.1 * torch.randn((r, f), generator=gen, device=DEV)
    empty = ch.nnz == 0
    x0[empty] = 0
    x0[:, f - 1] = 0
    return a, b, a_aug, diag, x0, empty


def solve_checks(cs, f, label):
    """K3, K4 and K5b at width f on `solve_systems`, each with an f32 and
    a bf16 A, at CG-6; K3 and K5b at CG-20 with a tolerance that stops
    systems early; K5b on an A' whose column f - 1 differs from its row
    f - 1 (b comes from the row, which at f = 256 only the second block
    of a cluster holds). Returns ok and each kernel's numbers (f32 A;
    bf16 under bf16_*)."""
    a, b, a_aug, diag, x0, empty = solve_systems(cs, f)
    out, ok_all = {}, True
    eye = torch.eye(f, device=DEV)

    def run(kernel, make):
        nonlocal ok_all
        for dtype in (torch.float32, torch.bfloat16):
            args = make(dtype)
            ok, res = check_solve(cs, kernel, args, label, empty=empty)
            ok_all &= ok
            if dtype == torch.float32:
                out[kernel] = res
            else:
                out[kernel].update({f"bf16_{k}": v for k, v in res.items()})
            del args
            torch.cuda.empty_cache()

    run("solve_cg_reg", lambda dt: (a.to(dt), diag, b, x0))
    ok, res = check_solve(cs, "solve_cg_reg", (a, diag, b, x0),
                          label + ", a tolerance that stops early",
                          cg_iters=20, cg_tol=1.0, empty=empty)
    ok_all &= ok
    out["solve_cg_reg"]["early_stop_check"] = res
    run("solve_cg", lambda dt: ((a + diag[:, None, None] * eye).to(dt), b,
                                x0))
    del a, b
    torch.cuda.empty_cache()
    run("solve_cg_aug", lambda dt: (a_aug.to(dt), diag, x0))
    ok, res = check_solve(cs, "solve_cg_aug", (a_aug, diag, x0),
                          label + ", a tolerance that stops early",
                          cg_iters=20, cg_tol=1.0, empty=empty)
    ok_all &= ok
    out["solve_cg_aug"]["early_stop_check"] = res
    a_aug[:, :f - 1, f - 1] = -0.5 * a_aug[:, :f - 1, f - 1] + 0.25
    ok, res = check_solve(cs, "solve_cg_aug", (a_aug, diag, x0),
                          label + ", column f - 1 unlike row f - 1 (b)",
                          empty=empty)
    ok_all &= ok
    out["solve_cg_aug"]["asymmetric_check"] = res
    del a_aug
    torch.cuda.empty_cache()
    return ok_all, out


def panel_256_grams(cs, x_table, hot):
    """13a's Gram checks at f = 256: K2 and K5a on the shape of the
    Netflix X phase's most populous panel chunk (R = 2304, P = 576, a
    65,537-row panel) with a bf16 and an f32 A, on a bf16 table (the
    panel body) and on a float32 one with full mantissas (the split body
    of csrc/wide_split_mma.cuh), and on a float32 table the out-of-core
    theta chunk's shape (R = 6656, P = 72); K2 on a hot-segment chunk
    (R = 16, P = 2^18, f32 A, cut) of the out-of-core run's X, its bf16
    table and a float32 one of the same rows. Returns ok and the numbers
    by check."""
    tp, ch = panel_chunk(256, 2304, 576, seed=12)
    gen = torch.Generator(device=DEV).manual_seed(24)
    t32 = float32_table(gen, tp.shape[0] - 1, 256)
    ooc = synthetic_chunk(gen, 6656, 72, tp.shape[0] - 1)
    out, ok_all = {}, True
    for aug in (False, True):
        name = "gather_gram_aug_out" if aug else "gather_gram_out"
        for key, table, chunk, a_dtype in (
                ("bf16_a", tp, ch, torch.bfloat16),
                ("f32_a", tp, ch, torch.float32),
                ("f32_table", t32, ch, torch.float32),
                ("f32_table_bf16_a", t32, ch, torch.bfloat16),
                ("f32_table_ooc_shape", t32, ooc, torch.float32)):
            label = ("f=256 synthetic X panel chunk" if chunk is ch else
                     "f=256 synthetic chunk of the out-of-core theta "
                     "shape") + (", float32 table (full mantissas)"
                                 if table is t32 else "")
            ok, res = check_gram(cs, table, chunk, a_dtype, aug, label)
            ok_all &= ok
            out.setdefault(name, {})[key] = res
    del tp, ch, t32, ooc
    torch.cuda.empty_cache()
    label = ("f=256 a hot-segment chunk of the out-of-core run's X (the 16 "
             "most rated theta columns, their first 2^18 ratings)")
    ok, out["gather_gram_out"]["hot_segment"] = check_gram(
        cs, x_table, hot, torch.float32, False, label,
        table_rows=live_rows(hot), cut=True)
    ok_all &= ok
    x32 = float32_table(gen, x_table.shape[0] - 1, 256)
    ok, out["gather_gram_out"]["hot_segment_f32_table"] = check_gram(
        cs, x32, hot, torch.float32, False,
        label + ", float32 table (full mantissas)",
        table_rows=live_rows(hot), cut=True)
    ok_all &= ok
    del x32
    torch.cuda.empty_cache()
    return ok_all, out


def panel_256_ooc(cs, bench, results):
    """13c: OutOfCoreALS on hugewiki_mini at F=200 (f_pad 256), X on the
    host: K1 at 256 lanes on the X chunks (the two passes), K2 at 256 on
    the theta steps (f32 accumulators, promoted by depth as at F=100), K3
    at 256 on the theta slices; against the in-core ALS of the same data
    and configuration (direct routes, K1 at 256 lanes), RMSE within 2e-3
    at every iteration. Then K2 on the out-of-core run's most rated theta
    chunk and on a hot-segment chunk, and K3 on its first theta slice,
    against their plain versions. Returns ok, the launches of both runs
    and the X table the Gram checks of 13a use, with the hot chunk."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
    from cumf_als_tpu_torch.ops.gram import extend_table
    from cumf_als_tpu_torch.utils.plan_cache import cached_transpose
    train, test, _ = workload_data(bench, "hugewiki_mini",
                                   RECORDED_HUGEWIKI_MINI)
    n_it = P256_OOC_ITERS
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=200,
                    nnz=train.nnz, nnz_test=test.nnz, lam=0.048,
                    iters=n_it, solver="cg", backend="pallas",
                    factor_dtype="bf16", gram_dtype="bf16",
                    plan_cache_dir=bench.plan_cache_dir(), verbose=False,
                    debug_timing=False)
    csc = cached_transpose(cfg.plan_cache_dir, train)
    t0 = time.monotonic()
    ooc = OutOfCoreALS(cfg.replace(host_offload_x=True), train, csc, test,
                       device=DEV)
    log(f"[ooc 256] F=200 f_pad {cfg.f_pad}: plans {time.monotonic() - t0:.1f}"
        f" s; X phase {len(ooc.plan_x.chunks)} chunks, theta phase "
        f"{len(ooc.plan_theta.chunks)} chunks over "
        f"{ooc.plan_theta.n_panels} X panels, {ooc.n_slices} solve slices "
        f"of {ooc.solve_batch}; theta accumulators {ooc.accum_dtype}")
    expect = {"gather_gram_out": len(ooc.plan_theta.chunks) * n_it,
              "solve_cg_reg": ooc.n_slices * n_it,
              SPAN_SUM: span_sums(cs, map(gram_shape, ooc.plan_theta.chunks),
                                  cfg.f_pad, n_it)}
    res_o, launches_o, peak_o = ooc_run(cs, ooc, "ooc 256", expect,
                                        at_least=MMA_PASSES)

    # K2 and K3 at the out-of-core path's shapes, on the state it left
    j = max(range(len(ooc.plan_theta.chunks)),
            key=lambda i: int(ooc.plan_theta.chunks[i].nnz.sum()))
    (c,), _ = ooc._host_th.upload(j, j + 1, torch.device(DEV))
    s = ooc.plan_theta.panel_size
    lo, hi = c.panel * s, min(c.panel * s + s, ooc.plan_theta.num_cols)
    tp = torch.zeros((s + 1, cfg.f_pad), dtype=torch.bfloat16, device=DEV)
    tp[:hi - lo] = ooc.x_store[lo:hi].to(DEV)
    ok_all, k2 = check_gram(cs, tp, c, ooc.accum_dtype, False,
                            f"f=256 out-of-core theta chunk {j} of "
                            f"{len(ooc.plan_theta.chunks)}")
    del tp, c
    a_buf, b_buf = ooc.theta_accumulators()
    theta = torch.nn.functional.pad(
        torch.from_numpy(np.asarray(res_o.theta, np.float32)).to(DEV),
        (0, cfg.f_pad - cfg.f, 0, ooc.n_pad - cfg.n))
    ok, k3 = check_solve(
        cs, "solve_cg_reg",
        (a_buf[:ooc.solve_batch],
         ooc._theta_nnz_pad[:ooc.solve_batch].float() * cfg.lam +
         (ooc._theta_nnz_pad[:ooc.solve_batch] == 0).float(),
         b_buf[:ooc.solve_batch], theta[:ooc.solve_batch].contiguous()),
        "the first theta slice of the out-of-core run")
    ok_all &= ok
    del a_buf, b_buf, theta
    # the bf16 gather table of the hot segments (m + 1, 256)
    x_table = extend_table(ooc.x_store.to(DEV, torch.bfloat16))
    del ooc
    torch.cuda.empty_cache()
    hot, hot_lens = hot_k2_chunk(csc, train.num_rows, DEV)
    log(f"[ooc 256] hot-segment chunk: the 16 most rated theta columns "
        f"({int(hot_lens.min())}..{int(hot_lens.max())} ratings)")

    t0 = time.monotonic()
    inc = ALS(cfg.replace(use_panels="never", train_rmse_method="direct"),
              train, csc, test, device=DEV)
    log(f"[in-core 256] plans {time.monotonic() - t0:.1f} s; X phase "
        f"{len(inc.plan_x[1])} chunks, theta phase "
        f"{len(inc.plan_theta[1])} chunks (both direct, K1 at 256 lanes)")
    res_i, launches_i, peak_i = ooc_run(cs, inc, "in-core 256", {},
                                        at_least=MMA_PASSES)
    del inc
    torch.cuda.empty_cache()
    worst = 0.0
    for ho, hi_ in zip(res_o.history, res_i.history):
        d = max(abs(ho.train_rmse - hi_.train_rmse),
                abs(ho.test_rmse - hi_.test_rmse))
        worst = max(worst, d)
        log(f"[ooc 256 | in-core 256] iter {ho.iteration}: train "
            f"{ho.train_rmse:.6f} | {hi_.train_rmse:.6f}, test "
            f"{ho.test_rmse:.6f} | {hi_.test_rmse:.6f} (limit 2e-3)")
    log(f"[ooc 256 | in-core 256] worst RMSE gap {worst:.3e}; peak device "
        f"memory {peak_o / 2**30:.2f} | {peak_i / 2**30:.2f} GiB")
    if worst > 2e-3:
        raise AssertionError("out-of-core and in-core runs at F=200 "
                             "disagree")
    results["gather_gram_out"]["f256_ooc_chunk"] = k2
    results["solve_cg_reg"]["f256_ooc_slice"] = k3
    return ok_all, {"ooc": launches_o, "in-core": launches_i}, x_table, hot


def panel_256_netflix(cs, ALS, cfg, train, csc, test, hist_ref, results):
    """13d: Netflix F=200 with the X phase on the panel route
    (panel_budget_bytes 6 GiB takes the 17,771 x 256^2 accumulators),
    theta direct (K1 at 256 lanes): with gram_dtype "bf16" (split
    buffers: K2 and K3 at 256) and "f32" (aug "auto": K5a and K5b at 256),
    each for P256_PANEL_ITERS iterations, RMSE within 2e-3 of phase 5's
    wide-off run (`hist_ref`) at every iteration. Then 13e on the same
    plans: `f32_default` with the `ALSConfig` default dtypes (float32
    factors: K5a on the split body of csrc/wide_split_mma.cuh, K1 on the
    float32 table), held to 13d's f32 run. Returns the launches of each
    run."""
    import copy

    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.ops.tiling import PanelPlan, UpdatePlan
    n_it = P256_PANEL_ITERS
    cfg_p = cfg.replace(f=200, panel_budget_bytes=6 << 30, iters=n_it)
    t0 = time.monotonic()
    al = ALS(cfg_p, train, csc, test, device=DEV)
    plan_x, chunks_x, aux_x = al.plan_x
    log(f"[panel 256] F=200 f_pad {cfg_p.f_pad}, panel_budget_bytes 6 GiB: "
        f"plans {time.monotonic() - t0:.1f} s; X phase "
        f"{type(plan_x).__name__} ({len(chunks_x)} chunks over "
        f"{plan_x.n_panels} panels, {aux_x['m_pad'] // aux_x['solve_batch']}"
        f" solve slices of {aux_x['solve_batch']}), theta phase "
        f"{type(al.plan_theta[0]).__name__} ({len(al.plan_theta[1])} "
        f"chunks)")
    if not (isinstance(plan_x, PanelPlan) and
            isinstance(al.plan_theta[0], UpdatePlan)):
        raise AssertionError("expected the panel X route and direct theta "
                             "at F=200")
    x0, th0 = init_factors(cfg_p.m, cfg_p.n, cfg_p.f, seed=0)
    launches = {}
    for label, gram_dtype, kernels in (
            ("panel 256 bf16", "bf16", ("gather_gram_out", "solve_cg_reg")),
            ("panel 256 f32", "f32", ("gather_gram_aug_out",
                                      "solve_cg_aug"))):
        model = copy.copy(al)    # the same plans: gram_dtype steers none
        model.cfg = cfg_p.replace(gram_dtype=gram_dtype)
        if model._use_panel_aug() != (gram_dtype == "f32"):
            raise AssertionError(f"{label}: the aug gate")
        others = tuple(k for k in SPLIT_KERNELS + AUG_KERNELS + WIDE_KERNELS
                       + ("solve_cg", "wide_span_gram", SPAN_SOLVE)
                       if k not in kernels)
        hist, launches[label] = full_width(
            cs, model, label, kernels + MMA_PASSES + (SPAN_SUM,), others, x0,
            th0, iters=n_it)
        worst = 0.0
        for h, r in zip(hist, hist_ref):
            d = max(abs(h.train_rmse - r.train_rmse),
                    abs(h.test_rmse - r.test_rmse))
            worst = max(worst, d)
            log(f"[{label} | wide off] iter {h.iteration}: train "
                f"{h.train_rmse:.6f} | {r.train_rmse:.6f}, test "
                f"{h.test_rmse:.6f} | {r.test_rmse:.6f} (limit 2e-3)")
        if len(hist) != len(hist_ref) or worst > 2e-3:
            raise AssertionError(f"{label}: off phase 5's wide-off run")
        del model
        torch.cuda.empty_cache()
    # 13e: the float32 default on 13d's plans, against its f32 run
    _, launches["f32 default"] = f32_default(
        cs, al, hist, x0, th0, results, phase="13e",
        ref_label="panel 256 f32", key="f256_default")
    del al
    torch.cuda.empty_cache()
    return launches


def panel_256(cs, bench, ALS, cfg, train, csc, test, hist_ref, results):
    """Phase 13: the panel and solve kernels at 256 lanes (K2, K5a, K3,
    K4, K5b at f = 256), and the paths they open: (a) the kernels against
    their plain versions at f = 256, with times and bounds; (b) K3, K4
    and K5b at f = 128 on their one body; (c) OutOfCoreALS at F=200 on
    hugewiki_mini; (d) Netflix F=200 on the panel route; (e) (d)'s plans
    with the float32 default dtypes. Fills results[...] with the f = 256
    numbers and each kernel's launches in (c), (d) and (e)."""
    t_start = time.monotonic()
    ok_all, launches_c, x_table, hot = panel_256_ooc(cs, bench, results)
    ok, grams = panel_256_grams(cs, x_table, hot)
    ok_all &= ok
    del x_table, hot
    torch.cuda.empty_cache()
    ok, solves_256 = solve_checks(cs, 256, "f=256 synthetic panel systems")
    ok_all &= ok
    ok, solves_128 = solve_checks(cs, 128, "f=128 synthetic panel systems")
    ok_all &= ok
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "f = 256 or on the one batched-CG body")
    launches_d = panel_256_netflix(cs, ALS, cfg, train, csc, test, hist_ref,
                                   results)
    for name in ("gather_gram_out", "gather_gram_aug_out"):
        results[name]["f256"] = grams[name]
    for name in SOLVE_NAMES:
        results[name]["f256"] = solves_256[name]
        results[name]["f128_one_body"] = solves_128[name]
    for name in ("gather_gram_out", "gather_gram_aug_out") + \
            tuple(SOLVE_NAMES) + MMA_PASSES:
        results[name]["f256_launches"] = {
            "ooc F=200 (13c, 3 iterations)": launches_c["ooc"].get(name, 0),
            **{(f"{k} (13e, {F32_ITERS} iterations)" if k == "f32 default"
                else f"{k} (13d, {P256_PANEL_ITERS} iterations)"):
               v.get(name, 0) for k, v in launches_d.items()}}
    log(f"[phase 13] {time.monotonic() - t_start:.1f} s")


# ----------------------------------------------------------- phase 14 --
# the factor width of phase 14 (f_pad 384) and the iterations of its runs
WIDE_F = 300
WIDE_F_ITERS = 2
# the kernels of the widths f >= 384 (F > 256): every route there runs
# these two and no other
TILED_KERNELS = ("tile_gram", "global_cg")


def time_once(fn):
    """CUDA-event time (ms) of one call of fn, and what it returned: for
    a plain version too long and too large to repeat."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def launched_since(cs, before):
    """{kernel: launches} since the snapshot `before` of cs.LAUNCHES."""
    return {k: v - before[k] for k, v in cs.LAUNCHES.items()
            if v != before[k]}


def widen(t, f):
    """t (R, f0) zero-padded to f lanes."""
    return torch.nn.functional.pad(t, (0, f - t.shape[1])).contiguous()


def tiled_pass1(cs, table_ext, ch, aug, table_rows):
    """Pass 1 of K1 (K6 with aug) at f >= 384 alone on a chunk, as the
    route runs it: ``tile_gram`` on each row batch of
    `cs.tiled_batch_rows` rows (A f32, and without aug b and r2), behind
    queued work; beside it its bound (each live table row, the chunk, A,
    b and r2 once, or the Gram's operations) and torch.bmm on the
    pre-gathered G of the chunk's live slots (pad slots name the zero
    row; with aug the values over lane f - 1). Returns (ms, bound_ms,
    bound_by, library_ms)."""
    r, p = ch.cols.shape
    f = table_ext.shape[1]
    step = cs.tiled_batch_rows(f)

    def pass1():
        for lo in range(0, r, step):
            hi = min(lo + step, r)
            cs.tile_gram(table_ext, ch.cols[lo:hi], ch.vals[lo:hi],
                         ch.nnz[lo:hi], aug=aug, with_b=not aug,
                         with_r2=not aug)

    ms = queued_ms(pass1, reps=3)
    out = r * f * f * 4 + (0 if aug else r * (f + 1) * 4)
    bms, by = bound_ms(table_rows * f * table_ext.element_size() +
                       nbytes(ch.cols, ch.vals, ch.nnz) + out,
                       gram_ops(ch, f, b=not aug), table_ext.dtype)
    g = table_ext.index_select(0, ch.cols.reshape(-1).long()).reshape(r, p, f)
    if aug:
        g = cs.augment_g(g, ch.vals)
    gt = g.transpose(1, 2)
    lib = queued_ms(lambda: torch.bmm(gt, g), reps=3)
    del g, gt
    torch.cuda.empty_cache()
    return ms, bms, by, lib


def tiled_k1(cs, table_ext, ch, x0, lam, label, aug, table_rows=None,
             pass1=False):
    """K1 (K6 with aug) at f >= 384 as routed (the two passes, one launch
    of ``tile_gram`` and one of ``global_cg`` a row batch, and no other)
    against its plain version (`gather_gram_cg_plain`, with aug
    `gather_gram_cg_aug_plain`): x within 2e-3, se within 1e-3
    relative, the rows without ratings and the lanes >= WIDE_F of x
    exactly 0, a repeat equal bit for bit. Kernel time behind queued work
    (`queued_ms`), the plain version's one call by events; the bound
    counts the function's work: each table row once (`table_rows` of a
    large table, else the whole table), the chunk, x0, x and se, and the
    Gram's operations (`gram_ops`). With `pass1`, pass 1 alone too
    (`tiled_pass1`)."""
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, lam)
    r, p = ch.cols.shape
    f = table_ext.shape[1]
    batches = -(-r // cs.tiled_batch_rows(f))
    before = dict(cs.LAUNCHES)
    x, se = cs.gather_gram_cg(*args, aug=aug)
    got = launched_since(cs, before)
    counted = got == {"tile_gram": batches, "global_cg": batches}
    x2, se2 = cs.gather_gram_cg(*args, aug=aug)
    repeat = same_bits(x, x2) and same_bits(se, se2)
    del x2, se2
    plain_fn = cs.gather_gram_cg_aug_plain if aug else \
        cs.gather_gram_cg_plain
    plain_ms, (px, pse) = time_once(lambda: plain_fn(*args))
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    del px, pse
    empty = ch.nnz == 0
    zero_ok = bool((x[empty] == 0).all()) and bool((se[empty] == 0).all()) \
        and bool((x[:, WIDE_F:] == 0).all())
    ms = queued_ms(lambda: cs.gather_gram_cg(*args, aug=aug), reps=3)
    flops = gram_ops(ch, f, b=not aug)
    table_b = nbytes(table_ext) if table_rows is None else \
        table_rows * f * table_ext.element_size()
    bms, by = bound_ms(table_b + nbytes(ch.cols, ch.vals, ch.nnz, x0, x,
                                        se), flops, table_ext.dtype)
    ok = err <= 2e-3 and se_rel <= 1e-3 and zero_ok and counted and repeat
    name = "K6" if aug else "K1"
    extra, res = "", {}
    if pass1:
        del x, se
        p_ms, p_bound, p_by, p_lib = tiled_pass1(cs, table_ext, ch, aug,
                                                 table_rows or
                                                 table_ext.shape[0])
        extra = (f"; pass 1 ({cs.tile_gram_body(table_ext)} body) alone "
                 f"{p_ms:.3f} ms, bound {p_bound:.4f} ms ({p_by}), "
                 f"torch.bmm on the pre-gathered G {p_lib:.3f} ms")
        res = dict(pass1_ms=p_ms, pass1_bound_ms=p_bound,
                   pass1_bound_by=p_by, pass1_library_ms=p_lib)
    log(f"[{name} at f={f}] {label}: chunk R={r} P={p}, table "
        f"{table_ext.dtype}, body {cs.gram_body(table_ext)}, {batches} row "
        f"batches (launches {got}: {counted}): max|dx|={err:.3e} (limit "
        f"2e-3), max rel dse={se_rel:.3e} (limit 1e-3), {int(empty.sum())} "
        f"rows without ratings and lanes >= {WIDE_F} exactly 0: {zero_ok}, "
        f"the same bits twice: {repeat}; device time: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (one call, events), bound {bms:.4f} ms "
        f"({by}){extra}; {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, se_rel=se_rel, ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None, shape=[r, p], f=f,
                    table=str(table_ext.dtype), launches=got, **res)


def tiled_gram(cs, tp, ch, a_dtype, aug, label):
    """K2 (K5a with aug) at f >= 384: one launch of ``tile_gram`` (and one
    of ``gram_span_sum`` where `cs.gram_spans` cuts the chunk), A within
    `gram_limit` of the plain version for the body that ran (the whole
    square, symmetric bit for bit), b within 1e-5 relative, rows of pad
    slots exactly 0; torch.bmm on the pre-gathered G as the yardstick
    (`check_gram`'s). Times as `tiled_k1`, the plain version's after a
    first call that warms it up."""
    args = (tp, ch.cols, ch.vals)
    r, p = ch.cols.shape
    f = tp.shape[1]
    fn = cs.gather_gram_aug_out if aug else cs.gather_gram_out
    plain_fn = cs.gather_gram_aug_out_plain if aug else \
        cs.gather_gram_out_plain

    def run(g=fn):
        out = g(*args, out_dtype=a_dtype)
        return (out, None) if aug else out

    spans = cs.gram_spans(r, p, f, sm_count(), tp.dtype)
    before = dict(cs.LAUNCHES)
    a, b = run()
    got = launched_since(cs, before)
    counted = got == {"tile_gram": 1, **({SPAN_SUM: 1} if spans > 1 else {})}
    run(plain_fn)  # the first call: the einsum's warm-up
    plain_ms, (pa, pb) = time_once(lambda: run(plain_fn))
    body = cs.gram_body(tp)
    lim, limit = gram_limit(a, pa, p, body)
    diff = (a.float() - pa.float()).abs()
    err, a_ok = diff.max().item(), bool((diff <= lim).all())
    del diff, lim, pa
    a_ok &= torch.equal(a, a.transpose(1, 2))
    pad_rows = ch.nnz == 0
    zero_ok = bool((a[pad_rows] == 0).all())
    b_rel = 0.0
    if b is not None:
        b_rel = ((b - pb).abs() / pb.abs().clamp_min(1.0)).max().item()
        zero_ok &= bool((b[pad_rows] == 0).all())
    del a, b, pb
    ms = queued_ms(run, reps=3)
    g = tp.index_select(0, ch.cols.reshape(-1).long()).reshape(r, p, f)
    if aug:
        g = cs.augment_g(g, ch.vals)
    gt = g.transpose(1, 2)
    lib = queued_ms(lambda: torch.bmm(gt, g), reps=3)
    del g, gt
    flops = gram_ops(ch, f, b=not aug)
    out_bytes = r * f * f * torch.tensor([], dtype=a_dtype).element_size()
    if not aug:
        out_bytes += r * f * 4
    bms, by = bound_ms(nbytes(tp, ch.cols, ch.vals) + out_bytes, flops,
                       tp.dtype)
    ok = a_ok and b_rel <= 1e-5 and zero_ok and counted
    name = "K5a" if aug else "K2"
    log(f"[{name} at f={f}] {label}: chunk R={r} P={p}, table {tp.dtype}, "
        f"A {a_dtype}, body {body} ({cs.tile_gram_body(tp)}), {spans} "
        f"span(s) a row (launches "
        f"{got}: {counted}): "
        f"max|dA|={err:.3e} (limit {limit}, and symmetric: {a_ok}), max "
        f"rel db={b_rel:.3e} (limit 1e-5), rows of pad slots exactly 0: "
        f"{zero_ok}; device time: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms (one call, events), torch.bmm on pre-gathered G {lib:.3f} ms, "
        f"bound {bms:.4f} ms ({by}); {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib, body=body,
                    tile_body=cs.tile_gram_body(tp), spans=spans,
                    shape=[r, p], f=f, table=str(tp.dtype),
                    a_dtype=str(a_dtype))


# 14k's solves: a system whose CG exit differs from the plain version's
# is excused only where one exit test went the other way, at a step
# whose plain rsnew lies within a factor EXIT_BAND of cg_tol (once a
# system has converged its rsnew is rounding noise, which two f32 orders
# of the same sums can put several times apart), only against the plain
# iterate where the CG so changed stops, and at most EXIT_CAP systems a
# launch
EXIT_BAND = 10.0
EXIT_CAP = 4


def plain_cg_trace(cs, kernel, args, cg_iters):
    """The plain version of `kernel` (K3, K4 or K5b) on `args` without its
    exit test: the iterates (n, R, f) and rsnew (n, R) of steps 1..n,
    each sum as `cs.cg_loop_plain` takes it."""
    from cumf_als_tpu_torch.ops.precision import full_f32
    if kernel == "solve_cg_aug":
        a_aug, diag, x = args
        a, b, _ = cs.unpack_aug(a_aug)
    elif kernel == "solve_cg_reg":
        a, diag, b, x = args
        a = a.float()
    else:
        (a, b, x), diag = args, None
        a = a.float()
    if diag is not None:
        a = a + diag.float()[:, None, None] * torch.eye(
            a.shape[-1], device=a.device)
    b, x = b.float(), x.float()
    xs, rss = [], []
    with full_f32():
        def matvec(v):
            return torch.einsum("rfg,rg->rf", a, v)
        r = b - matvec(x)
        p = r
        rsold = (r * r).sum(-1, keepdim=True)
        for _ in range(cg_iters):
            ap = matvec(p)
            pap = (p * ap).sum(-1, keepdim=True)
            nonzero = (pap.abs() > 0).float()
            alpha = nonzero * rsold / (pap + (1.0 - nonzero))
            x = x + alpha * p
            r = r - alpha * ap
            rsnew = (r * r).sum(-1, keepdim=True)
            p = r + rsnew / (rsold + (rsold <= 0).float()) * p
            rsold = rsnew
            xs.append(x)
            rss.append(rsnew[:, 0])
    return torch.stack(xs), torch.stack(rss)


def plain_exit(trace, cg_iters, cg_tol):
    """The plain exit step of each system from `plain_cg_trace`'s
    (xs, rs): the first step whose rsnew < cg_tol, else cg_iters."""
    below = trace[1] < cg_tol
    return torch.where(below.any(0), below.float().argmax(0) + 1, cg_iters)


def exit_rule_ok(x, px, trace, cg_iters, cg_tol):
    """Whether x (R, f) passes 14k's solve check against the plain x px:
    each system within 2e-3 of px, or else of the plain iterate (`trace`,
    the plain version's iterates and rsnew, `plain_cg_trace`) where one
    exit test of the plain CG goes the other way at a step whose plain
    rsnew lies within a factor EXIT_BAND of cg_tol: an earlier step k
    with rsnew in [cg_tol, EXIT_BAND cg_tol] stopping there, or the plain
    exit e with rsnew in [cg_tol / EXIT_BAND, cg_tol) not stopping, the
    CG then running on to the next step whose plain rsnew < cg_tol (or
    to cg_iters); whichever is nearer x; at most EXIT_CAP systems so
    excused. Returns ok, each system's max |dx| so held and the excused
    systems (system, plain exit step, the step x matches, plain rsnew /
    cg_tol at the test that went the other way)."""
    xs, rs = trace
    each = (x - px).abs().amax(1)
    off = torch.nonzero(each > 2e-3)[:, 0]
    excused = []
    if off.numel():
        e = plain_exit(trace, cg_iters, cg_tol)[off]
        r = rs[:, off] / cg_tol                     # (steps, systems)
        r_e = r.gather(0, (e - 1)[None])[0]
        steps = torch.arange(1, cg_iters + 1, device=x.device)[:, None]
        # not stopped at e: the CG runs on to the next step below cg_tol
        below_after = (steps > e) & (r < 1.0)
        resume = torch.where(below_after.any(0),
                             below_after.float().argmax(0) + 1, cg_iters)
        late_ok = (e < cg_iters) & (r_e < 1.0) & (r_e >= 1.0 / EXIT_BAND)
        x_off = x[off]
        best = torch.full((off.numel(),), math.inf, device=x.device)
        step = e.clone()
        flip = torch.zeros_like(best)
        for k in range(1, cg_iters + 1):
            err_k = (x_off - xs[k - 1, off]).abs().amax(1)
            # stopped at k < e: the test of step k went the other way
            early = (k < e) & (r[k - 1] >= 1.0) & (r[k - 1] <= EXIT_BAND)
            late = late_ok & (resume == k)
            better = (early | late) & (err_k < best)
            best = torch.where(better, err_k, best)
            step = torch.where(better, k, step)
            flip = torch.where(better, torch.where(early, r[k - 1], r_e),
                               flip)
        apart = best <= 2e-3
        each[off] = torch.where(apart, best, each[off])
        excused = list(zip(off[apart].tolist(), e[apart].tolist(),
                           step[apart].tolist(), flip[apart].tolist()))
    err = each.max().item()
    return err <= 2e-3 and len(excused) <= EXIT_CAP, each, excused


def unheld(x, trace, each_ok, cg_iters, cg_tol, most=6):
    """What a failed solve check prints of the systems still off: each
    one's plain exit, the plain step whose iterate is nearest x (of all
    cg_iters) with its max |dx|, and the plain rsnew / cg_tol of every
    step."""
    xs, rs = trace
    off = torch.nonzero(~each_ok)[:, 0][:most]
    e = plain_exit(trace, cg_iters, cg_tol)
    lines = []
    for i in off.tolist():
        errs = (xs[:, i] - x[i]).abs().amax(1)
        j = int(errs.argmin())
        lines.append(f"system {i}: plain exit {int(e[i])}, nearest plain "
                     f"step {j + 1} ({errs[j].item():.3e}), plain rsnew / "
                     f"cg_tol " + ", ".join(f"{v:.4g}" for v in
                                           (rs[:, i] / cg_tol).tolist()))
    return "; ".join(lines)


def tiled_solve(cs, kernel, args, label, empty, cg_iters=6, cg_tol=1e-4):
    """K3, K4 or K5b (`kernel`) at f >= 384: one launch of ``global_cg``
    and no other, x within 2e-3 of the plain version under
    `exit_rule_ok` (a system where one exit test at the threshold went
    the other way, at most EXIT_CAP), the systems without ratings
    exactly 0 and K5b's lane f - 1 of x exactly 0. The plain trace must
    give the plain x at each plain exit bit for bit, and the rule must
    reject two wrong CGs on these systems wherever their x is more than
    2e-3 from the plain x: the plain version stopping one step early
    (cg_iters - 1) and the plain version ignoring cg_tol (`tiled_solves`
    requires each rejected once at each width). Events at cg_iters and
    at 0 (A still read twice: b - A x0 and the exit); the bound is the
    bytes of the arguments and x against one matvec of each system, as
    `check_solve`'s."""
    fn = getattr(cs, kernel)
    plain_fn = getattr(cs, f"{kernel}_plain")
    kw = dict(cg_iters=cg_iters, cg_tol=cg_tol)
    before = dict(cs.LAUNCHES)
    x = fn(*args, **kw)
    got = launched_since(cs, before)
    counted = got == {"global_cg": 1}
    plain_ms, px = time_once(lambda: plain_fn(*args, **kw))
    # the trace is the plain version's CG step by step: at each system's
    # plain exit it must give px bit for bit
    trace = plain_cg_trace(cs, kernel, args, cg_iters)
    e = plain_exit(trace, cg_iters, cg_tol)
    same = torch.equal(trace[0][e - 1, torch.arange(len(e), device=DEV)],
                       px)
    rule_ok, each, excused = exit_rule_ok(x, px, trace, cg_iters, cg_tol)
    err = each.max().item()
    if err > 2e-3:
        log(f"[{SOLVE_NAMES[kernel]} at f={x.shape[1]}] off and not held: "
            f"{unheld(x, trace, each <= 2e-3, cg_iters, cg_tol)}")
    rule_ok &= same
    rejects, wrongs = [], {}
    for what, wrong in (
            ("a step early", dict(cg_iters=cg_iters - 1, cg_tol=cg_tol)),
            ("cg_tol ignored", dict(cg_iters=cg_iters, cg_tol=0.0))):
        xw = plain_fn(*args, **wrong)
        passes, bad_each, bad_excused = exit_rule_ok(xw, px, trace,
                                                     cg_iters, cg_tol)
        bad_err = bad_each.max().item()
        # a wrong CG whose x is within 2e-3 of the plain x everywhere is
        # not wrong on these systems, and no check of x can reject it
        wrongs[what] = "NOT REJECTED" if passes and (
            xw - px).abs().max().item() > 2e-3 else \
            "no different here" if passes else "rejected"
        rejects.append(f"{what}: {wrongs[what]} (max|dx| {bad_err:.3e}, "
                       f"{len(bad_excused)} excused)")
        rule_ok &= wrongs[what] != "NOT REJECTED"
        del xw
    del px, trace, e
    a = args[0]
    r, f, _ = a.shape
    exact = bool((x[empty] == 0).all())
    if kernel == "solve_cg_aug":
        exact &= bool((x[:, f - 1] == 0).all())
    ms = time_ms(lambda: fn(*args, **kw), reps=3)
    ms0 = time_ms(lambda: fn(*args, cg_iters=0, cg_tol=cg_tol), reps=3)
    bms, by = bound_ms(nbytes(*(t for t in args if torch.is_tensor(t)), x),
                       2.0 * r * f * f, a.dtype)
    ok = rule_ok and bool(torch.isfinite(x).all()) and counted and exact
    held = ", ".join(f"system {i}: plain exit {e}, the kernel's {j}, plain "
                     f"rsnew at the test {q:.4f} cg_tol"
                     for i, e, j, q in excused)
    log(f"[{SOLVE_NAMES[kernel]} at f={f}] {label}: {r} systems, A "
        f"{a.dtype} ({a.numel() / 2**31:.2f} x 2^31 elements), cg_iters "
        f"{cg_iters}: max|dx|={err:.3e} (limit 2e-3; {len(excused)} "
        f"systems (limit {EXIT_CAP}) held to the plain iterate where one "
        f"exit test at rsnew within a factor {EXIT_BAND:g} of cg_tol goes "
        f"the other way{': ' + held if held else ''}; the plain trace gives "
        f"the plain x bit for bit: {same}; the rule on wrong CGs: "
        f"{'; '.join(rejects)}), launches {got}: "
        f"{counted}, empty systems and aug lane exactly 0: {exact}; kernel "
        f"{ms:.3f} ms (events; at cg_iters 0 {ms0:.3f} ms), plain "
        f"{plain_ms:.3f} ms (one call), bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.0%} of the bound; {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, ms_cg0=ms0, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None, f=f,
                    systems=r, a_dtype=str(a.dtype),
                    at_exit=[list(t) for t in excused], wrong_cgs=wrongs)


def tiled_solves(cs, f, r):
    """14k's solves at width f: K3, K4 and K5b on `solve_systems` (R
    systems of one synthetic panel chunk, K2's (A, b) and K5a's A' from
    ``tile_gram``), each with an f32 and a bf16 A, at CG-6; K3 at CG-20
    with cg_tol 1 (most systems stop early, as in `solve_checks`). Each
    wrong CG of `tiled_solve` must be rejected in one run at least.
    Returns ok and each kernel's numbers (f32 A; bf16 under bf16_*)."""
    a, b, a_aug, diag, x0, empty = solve_systems(cs, f, r=r)
    eye = torch.eye(f, device=DEV)
    out, ok_all = {}, True
    label = f"synthetic panel systems, one in 64 without ratings"
    for kernel, make in (
            ("solve_cg_reg", lambda dt: (a.to(dt), diag, b, x0)),
            ("solve_cg", lambda dt: ((a + diag[:, None, None] * eye).to(dt),
                                     b, x0)),
            ("solve_cg_aug", lambda dt: (a_aug.to(dt), diag, x0))):
        for dtype in (torch.float32, torch.bfloat16):
            ok, res = tiled_solve(cs, kernel, make(dtype), label, empty)
            ok_all &= ok
            out.setdefault(kernel, {})[
                "f32" if dtype == torch.float32 else "bf16"] = res
            torch.cuda.empty_cache()
    ok, res = tiled_solve(cs, "solve_cg_reg", (a, diag, b, x0),
                          label + ", a tolerance that stops early", empty,
                          cg_iters=20, cg_tol=1.0)
    ok_all &= ok
    out["solve_cg_reg"]["early_stop_check"] = res
    runs = [v for k in out.values() for v in k.values()]
    for what in runs[0]["wrong_cgs"]:
        caught = any(v["wrong_cgs"][what] == "rejected" for v in runs)
        if not caught:
            log(f"[solves at f={f}] the wrong CG '{what}' was rejected in "
                f"no run: FAIL")
        ok_all &= caught
    del a, b, a_aug
    torch.cuda.empty_cache()
    return ok_all, out


def wide_f_kernels(cs, model, x_t, theta_t):
    """14k: the two kernels of f >= 384 against their plain versions, at
    f = 384 and 512. K1 and K6 on the most populous and the widest theta
    chunk of the F=300 plan (at 512 the first 4096 rows of the populous
    one, as far as the plain version's memory goes), on a bf16 table of
    the stand-in X and a float32 copy; K2 and K5a on a synthetic chunk of
    the Netflix X panel shape (R = 2304, P = 576, a 65,537-row panel),
    bf16 and f32 A, bf16 and float32 tables; K3, K4 and K5b on 16,384
    systems at 384 (past 2^31 elements of A) and 4,096 at 512, f32 and
    bf16 A. Returns ok and the numbers by kernel."""
    cfg = model.cfg
    chunks = model.plan_theta[1]
    populous = max(chunks, key=lambda c: c.rows.shape[0] * c.width)
    widest = max(chunks, key=lambda c: c.width)
    out = {"tile_gram": {}, "global_cg": {}}
    ok_all = True
    for f in (384, 512):
        x_f = widen(x_t, f)
        table = torch.cat([x_f, x_f.new_zeros((1, f))])
        for tag, ch in (("populous", populous), ("widest", widest)):
            if f == 512 and tag == "populous":
                from types import SimpleNamespace
                ch = SimpleNamespace(
                    cols=ch.cols[:4096].contiguous(),
                    vals=ch.vals[:4096].contiguous(),
                    nnz=ch.nnz[:4096].contiguous(),
                    rows=ch.rows[:4096], rows_real=ch.rows_real[
                        :min(4096, ch.n_real)],
                    n_real=min(4096, ch.n_real))
            x0 = widen(chunk_x0(ch, theta_t), f)
            for dtype in (torch.bfloat16, torch.float32):
                t = table.to(dtype)
                for aug in (False, True):
                    ok, res = tiled_k1(cs, t, ch, x0, cfg.lam,
                                       f"theta {tag}", aug,
                                       table_rows=live_rows(ch),
                                       pass1=tag == "populous")
                    ok_all &= ok
                    key = (f"{'K6' if aug else 'K1'}_f{f}_{tag}_"
                           f"{'bf16' if dtype == torch.bfloat16 else 'f32'}"
                           f"_table")
                    out["tile_gram"][key] = out["global_cg"][key] = res
                del t
            torch.cuda.empty_cache()
        del table, x_f
        tp, ch = panel_chunk(f, 2304, 576, seed=14)
        for aug in (False, True):
            for a_dtype, t in ((torch.bfloat16, tp), (torch.float32, tp),
                               (torch.float32, tp.float())):
                ok, res = tiled_gram(cs, t, ch, a_dtype, aug,
                                     "synthetic X panel chunk")
                ok_all &= ok
                key = f"{'K5a' if aug else 'K2'}_f{f}_" + (
                    "f32_table" if t.dtype == torch.float32 else
                    "bf16_a" if a_dtype == torch.bfloat16 else "f32_a")
                out["tile_gram"][key] = res
        del tp, ch
        # a chunk of few long rows (fewer than the clusters that fit the
        # card: at f = 384 the cut), on factors as the paths gather them
        # at iteration 0, as gram_cut_synthetic's: with signed entries b
        # of a long row sums with cancellation, and its limit, 1e-5
        # relative to |b|, no longer measures the f32 rounding
        tp, ch = panel_chunk(f, 16, 16384, seed=16, signed=False)
        for aug, a_dtype in ((False, torch.bfloat16), (True, torch.float32)):
            ok, res = tiled_gram(cs, tp, ch, a_dtype, aug,
                                 "synthetic chunk of few long rows")
            ok_all &= ok
            out["tile_gram"][f"{'K5a' if aug else 'K2'}_f{f}_few_rows_"
                             f"{'f32' if aug else 'bf16'}_a"] = res
        del tp, ch
        torch.cuda.empty_cache()
        ok, solves = tiled_solves(cs, f, 16384 if f == 384 else 4096)
        ok_all &= ok
        for kernel, res in solves.items():
            for dt, r in res.items():
                out["global_cg"][f"{SOLVE_NAMES[kernel]}_f{f}_{dt}_a"] = r
    return ok_all, out


def wide_f(cs, ALS, cfg, train, csc, test, results):
    """Phase 14: factor widths F > 256 on the card, Netflix at F=300
    (f_pad 384), bf16 factors. First 14k (`wide_f_kernels`) on the
    plans of (a); then three runs of WIDE_F_ITERS iterations, launch
    counts read around each run alone: (a) the defaults, X on the split
    route and theta direct, K1 at f = 384 on both; (b) panel_budget_bytes
    12 GiB, X on the panel route (K2 and K3 at 384, bf16 accumulators),
    theta direct (K1); (c) (b) with gram_dtype "f32" and aug_gram "force"
    (K5a and K5b on X, K6 on theta). Every run launches ``tile_gram`` and
    ``global_cg`` and no other kernel, its train RMSE falls, (b) and (c)
    stay within 2e-3 of (a) at every iteration. Fills results["tile_gram"]
    and results["global_cg"] and returns (a)'s launches."""
    import copy

    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.ops.tiling import PanelPlan, SplitPlan, \
        UpdatePlan
    t_start = time.monotonic()
    others = tuple(k for k in REPLACES if k not in TILED_KERNELS)
    cfg_a = cfg.replace(f=WIDE_F, iters=WIDE_F_ITERS)
    t0 = time.monotonic()
    al = ALS(cfg_a, train, csc, test, device=DEV)
    log(f"[F=300 a] f_pad {cfg_a.f_pad}: plans {time.monotonic() - t0:.1f} "
        f"s; X phase {type(al.plan_x[0]).__name__} ({len(al.plan_x[1])} "
        f"chunks), theta phase {type(al.plan_theta[0]).__name__} "
        f"({len(al.plan_theta[1])} chunks)")
    if not (cfg_a.f_pad == 384 and isinstance(al.plan_x[0], SplitPlan) and
            isinstance(al.plan_theta[0], UpdatePlan)):
        raise AssertionError("F=300: expected f_pad 384, the split X route "
                             "and direct theta")
    x0, th0 = init_factors(cfg_a.m, cfg_a.n, WIDE_F, seed=0)
    gen = torch.Generator(device=DEV).manual_seed(1)
    theta_t = al._pad_f(th0)
    x_t = al._pad_f(0.2 * torch.rand((cfg_a.m, WIDE_F), generator=gen,
                                     device=DEV).cpu().numpy())
    t0 = time.monotonic()
    ok, kernels = wide_f_kernels(cs, al, x_t.to(torch.bfloat16), theta_t)
    log(f"[14k] {time.monotonic() - t0:.1f} s")
    del x_t, theta_t
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("a kernel of f >= 384 disagrees with its plain "
                             "version")
    hist_a, launches_a = full_width(cs, al, "F=300 a", TILED_KERNELS, others,
                                    x0, th0, iters=WIDE_F_ITERS)
    del al
    torch.cuda.empty_cache()
    cfg_b = cfg_a.replace(panel_budget_bytes=12 << 30)
    t0 = time.monotonic()
    al = ALS(cfg_b, train, csc, test, device=DEV)
    log(f"[F=300 b] panel_budget_bytes 12 GiB: plans "
        f"{time.monotonic() - t0:.1f} s; X phase "
        f"{type(al.plan_x[0]).__name__} ({len(al.plan_x[1])} chunks), "
        f"theta phase {type(al.plan_theta[0]).__name__} "
        f"({len(al.plan_theta[1])} chunks)")
    if not (isinstance(al.plan_x[0], PanelPlan) and
            isinstance(al.plan_theta[0], UpdatePlan)):
        raise AssertionError("F=300 b: expected the panel X route and "
                             "direct theta")
    runs = {"F=300 a": {k: v for k, v in launches_a.items() if v}}
    # the X panel chunks of fewer rows than the clusters that fit the
    # card take K2's (K5a's) cut: its pass 2 once a call on each
    cut = span_sums(cs, [gram_shape(c) for c in al.plan_x[1]], cfg_b.f_pad,
                    WIDE_F_ITERS)
    for label, extra in (("F=300 b", {}),
                         ("F=300 c", dict(gram_dtype="f32",
                                          aug_gram="force"))):
        model = copy.copy(al)    # the same plans: neither field steers one
        model.cfg = cfg_b.replace(**extra)
        aug = bool(extra)
        if model._use_panel_aug() != aug or cs.aug_enabled(model.cfg) != aug:
            raise AssertionError(f"{label}: the aug gates")
        hist, launches = full_width(
            cs, model, label, TILED_KERNELS,
            tuple(k for k in others if k != SPAN_SUM), x0, th0,
            iters=WIDE_F_ITERS, exact={SPAN_SUM: cut})
        runs[label] = {k: v for k, v in launches.items() if v}
        rmse_gaps(label, hist, hist_a, "F=300 a")
        del model
        torch.cuda.empty_cache()
    del al
    torch.cuda.empty_cache()
    gram, cg = kernels["tile_gram"], kernels["global_cg"]
    results["tile_gram"] = dict(gram["K2_f384_bf16_a"], checks=gram,
                                launches_by_run=runs)
    results["global_cg"] = dict(cg["K3_f384_bf16_a"], checks=cg,
                                launches_by_run=runs)
    log(f"[phase 14] {time.monotonic() - t_start:.1f} s")
    return launches_a


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cumf_als_tpu_torch import bench, native
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   workload_ratings)
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.ops import _build
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    from cumf_als_tpu_torch.ops.solve import solve
    from cumf_als_tpu_torch.ops.tiling import PanelPlan, UpdatePlan
    from cumf_als_tpu_torch.utils.io import transpose_csr

    # ---- 1. card and build
    card = card_line()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    short = {(): None, ("--gram",): GRAM_KERNELS + (SPAN_SUM,),
             ("--theta",): THETA_SHORT, ("--wide",): WIDE_SHORT,
             ("--ooc",): SPLIT_KERNELS, ("--sharded",): SPLIT_KERNELS,
             ("--sharded-ooc",): SPLIT_KERNELS,
             ("--integrations",): SPLIT_KERNELS + ("solve_cg",),
             ("--panel-256",): PANEL_256_SHORT,
             ("--wide-f",): TILED_KERNELS}
    if tuple(sys.argv[1:]) not in short:
        print("usage: chip_smoke.py [--gram | --theta | --wide | --ooc | "
              "--sharded | --sharded-ooc | --integrations | --panel-256 | "
              "--wide-f]", file=sys.stderr)
        return 2
    only = short[tuple(sys.argv[1:])]
    sharded_only = tuple(sys.argv[1:]) == ("--sharded",)
    sooc_only = tuple(sys.argv[1:]) == ("--sharded-ooc",)
    t0 = time.monotonic()
    _build.build(only, force=True, ptxas_info=True)
    if set(_build.KERNELS) != set(REPLACES):
        raise AssertionError("the kernel table and this script disagree")
    log(f"[build] {len(_build.BUILD_LOG)} kernels built in "
        f"{time.monotonic() - t0:.1f} s")
    # the native data plane: the data sets are the JAX package's only
    # through it, and the out-of-core plans build through it
    t0 = time.monotonic()
    if not native.available():
        raise AssertionError("the native data plane did not build")
    log(f"[build] native data plane {native.LIB_PATH} in "
        f"{time.monotonic() - t0:.1f} s")
    ptxas_ok = ptxas_lines(_build.BUILD_LOG)
    if only == GRAM_KERNELS + (SPAN_SUM,):
        ok = ptxas_ok and gram_edges(cs) and panel_split_edges(cs) and \
            gram_synthetic(cs) and gram_cut_synthetic(cs)
        log(f"[gram] {'OK' if ok else 'FAIL'} (the short call: no result "
            f"line)")
        return 0 if ok else 1
    if only == THETA_SHORT:
        ok = theta_edges(cs) and theta_synthetic(cs)
        if not ok:
            log("[theta] FAIL (the short call: no result line)")
            return 1
    elif only == WIDE_SHORT:
        ok = ptxas_ok and span_gram_edges(cs) and span_edges(cs) and \
            wide_synthetic(cs)
        if not ok:
            log("[wide] FAIL (the short call: no result line)")
            return 1
    elif tuple(sys.argv[1:]) == ("--integrations",):
        integrations(cs, bench)
        log("[integrations] OK (the short call: no result line)")
        return 0
    elif only == SPLIT_KERNELS and sooc_only:
        sharded_ooc(cs, bench)
        log("[sooc] OK (the short call: no result line)")
        return 0
    elif only == SPLIT_KERNELS and not sharded_only:
        out_of_core(cs, bench)
        log("[ooc] OK (the short call: no result line)")
        return 0
    elif not ptxas_ok:
        raise AssertionError("a tensor-core kernel or the f = 256 solve "
                             "body spills, or ptxas waits for every wgmma")

    # ---- data and plans of the full Netflix shape (shared by 2 and 4),
    # through the bench's loader: generated into its cache on first use
    t0 = time.monotonic()
    train, test, _ = workload_data(bench, "netflix", RECORDED_NETFLIX)
    csc = transpose_csr(train)
    gen_s = time.monotonic() - t0
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, iters=ITERS, backend="pallas",
                          solver="cg", factor_dtype="bf16",
                          gram_dtype="bf16", verbose=True,
                          debug_timing=True)
    if sharded_only:
        x0_np, th0_np = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
        al = ALS(cfg, train, csc, test, device="cuda")
        hist_main, _ = full_width(
            cs, al, "main", SPLIT_KERNELS + (SPAN_SUM, SPAN_SOLVE),
            AUG_KERNELS + WIDE_KERNELS + SPAN_KERNELS + ("solve_cg",),
            x0_np, th0_np, exact=theta_pass_2(cs, al))
        del al
        torch.cuda.empty_cache()
        sharded(cs, bench, cfg, train, test, hist_main)
        log("[sharded] OK (the short call: no result line)")
        return 0
    if only == PANEL_256_SHORT:
        # phase 13 with its reference: phase 5's wide-off run of 2
        # iterations (the split X route, K1 at 256 lanes)
        ref = ALS(cfg.replace(f=200, iters=2), train, csc, test,
                  device=DEV)
        x0_w, th0_w = init_factors(cfg.m, cfg.n, 200, seed=0)
        hist_off, _ = full_width(
            cs, ref, "wide off", MMA_PASSES,
            SPLIT_KERNELS + AUG_KERNELS + WIDE_KERNELS + ("solve_cg",
                                                          SPAN_SOLVE),
            x0_w, th0_w, iters=2)
        results = {name: {} for name in REPLACES}
        # phase 5e on the same plans: K6 at 256 lanes
        aug_256(cs, ref, hist_off, results)
        del ref
        torch.cuda.empty_cache()
        panel_256(cs, bench, ALS, cfg, train, csc, test, hist_off, results)
        log("[panel 256] OK (the short call: no result line)")
        return 0
    if only == TILED_KERNELS:
        wide_f(cs, ALS, cfg, train, csc, test, {})
        log("[wide f] OK (the short call: no result line)")
        return 0
    if only == WIDE_SHORT:
        al, cfg_w, f2, _, _, theta_t, x_t, x_ext = wide_setup(
            cs, ALS, cfg, train, csc, test)
        ok = cut_checks(cs, al, cfg_w, f2, theta_t, x_t, x_ext)[0]
        log(f"[wide] {'OK' if ok else 'FAIL'} (the short call: no result "
            f"line)")
        return 0 if ok else 1
    t0 = time.monotonic()
    al = ALS(cfg, train, csc, test, device="cuda")
    plan_s = time.monotonic() - t0
    log(f"[data] netflix scale 1.0: m={train.num_rows} n={train.num_cols} "
        f"nnz={train.nnz} nnz_test={test.nnz}; generation+transpose "
        f"{gen_s:.1f} s, plans (built and moved to the card) {plan_s:.1f} s")
    x_route = type(al.plan_x[0]).__name__
    t_route = type(al.plan_theta[0]).__name__
    log(f"[routes] X phase: {x_route} ({len(al.plan_x[1])} chunks), theta "
        f"phase: {t_route} ({len(al.plan_theta[1])} chunks)")
    if not (isinstance(al.plan_x[0], PanelPlan) and
            isinstance(al.plan_theta[0], UpdatePlan)):
        raise AssertionError("expected the panel X route and direct theta")

    # ---- 2a. the split kernels against their plain versions, at
    # main-path shapes
    x0_np, th0_np = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    theta_t = al._pad_f(th0_np)
    # a stand-in X for the theta-phase table: the real X starts at zero
    x_t = al._pad_f(0.2 * torch.rand((cfg.m, cfg.f), generator=gen,
                                     device="cuda").cpu().numpy())
    table_ext = torch.cat([x_t.to(torch.bfloat16),
                           torch.zeros((1, cfg.f_pad), dtype=torch.bfloat16,
                                       device="cuda")])

    def theta_cut_chunks(model):
        """The fewest-row theta chunk among those K1's cut takes
        (`cs.theta_spans`: fewer rows than the blocks that fit the card;
        the most slots among equals), and the one with the most slots
        among the others."""
        sms = sm_count()
        cut = [c for c in model.plan_theta[1]
               if cs.theta_spans(*c.cols.shape, cfg.f_pad, sms) > 1]
        if len(cut) < 2:
            raise AssertionError("fewer than two theta chunks take K1's "
                                 "cut")
        fewest = min(cut, key=lambda c: (c.rows.shape[0], -c.width))
        most = max((c for c in cut if c is not fewest),
                   key=lambda c: c.rows.shape[0] * c.width)
        return (("cut_fewest", "fewest-row cut", fewest),
                ("cut_most", "most slots cut", most))

    def check_theta(model, c, aug, key):
        """K1 (or, with aug, K6) on the widest, the most populous (fills
        results[key]) and the fewest-row theta chunk of the model's
        plan; on the two chunks of few rows `theta_cut_chunks` picks
        three ways (`check_k1` with cut); pass 2 of the cut alone on the
        fewest-row one (fills results[SPAN_SOLVE], with aug under
        "aug_")."""
        chunks = model.plan_theta[1]
        ok_all = True
        cuts = theta_cut_chunks(model)
        for tag, label, ch in cuts:
            ok, res = check_k1(cs, table_ext, ch, theta_t, c, label,
                               aug=aug, cut=True)
            ok_all &= ok
            results.setdefault(key, {}).update(
                {f"{tag}_{k}": v for k, v in res.items()},
                **{f"{tag}_shape": list(ch.cols.shape)})
        ok, res = check_span_solve(cs, table_ext, cuts[0][2], theta_t, c,
                                   "the fewest-row theta chunk the cut "
                                   "takes", aug=aug)
        ok_all &= ok
        if aug:
            results.setdefault(SPAN_SOLVE, {}).update(
                {f"aug_{k}": v for k, v in res.items()})
        else:
            results[SPAN_SOLVE] = dict(res, **results.get(SPAN_SOLVE, {}))
        for label, ch in (
                ("widest", max(chunks, key=lambda c: c.width)),
                ("most populous",
                 max(chunks, key=lambda c: c.rows.shape[0] * c.width)),
                ("fewest rows", min(chunks, key=lambda c: c.rows.shape[0]))):
            ok, res = check_k1(cs, table_ext, ch, theta_t, c, label, aug=aug)
            ok_all &= ok
            if label == "most populous":
                results[key] = dict(res, **results.get(key, {}))
                # the FMA body of csrc/common.cuh: a float32 table
                ok, res = check_k1(cs, table_ext.float(), ch, theta_t, c,
                                   label + ", float32 table (FMA body)",
                                   aug=aug)
                ok_all &= ok
                results[key]["f32_table"] = {
                    k: res[k] for k in ("ms", "plain_ms", "max_abs_err",
                                        "bound_ms", "bound_by")}
            else:
                tag = label.split()[0]
                results.setdefault(key, {}).update(
                    {f"{tag}_{k}": res[k] for k in ("ms", "max_abs_err",
                                                    "bound_ms")},
                    **{f"{tag}_shape": list(ch.cols.shape)})
        return ok_all

    def totals(model, names):
        th, x, gram_tot = phase_totals(cs, model, theta_t, x_t)
        n_x = len(model.plan_x[1])
        results[names[2]]["phase_totals"] = dict(
            theta_ms=th["total"], theta_few_ms=th["few"],
            theta_uncut_ms=th["uncut"]["total"],
            theta_uncut_few_ms=th["uncut"]["few"], theta_cut=th["n_cut"],
            theta_few=th["n_few"])
        log(f"[phase totals] {names[0]} over the {len(model.plan_theta[1])} "
            f"theta chunks {th['total']:.1f} ms, of which {th['few']:.1f} ms "
            f"in the {th['n_few']} chunks with fewer than {th['sms']} rows "
            f"(the longest of them, ms and (R, P): "
            f"{[(round(m, 3), rp) for m, rp in th['longest_few']]}); the "
            f"same uncut (spans=1, this call): {th['uncut']['total']:.1f} "
            f"ms, {th['uncut']['few']:.1f} ms in those chunks (the longest: "
            f"{[(round(m, 3), rp) for m, rp in th['uncut']['longest_few']]})"
            f", {th['n_cut']} chunks cut; "
            f"{names[1]} over the {n_x} X "
            f"chunks {x['total']:.1f} ms, of which {x['few']:.1f} ms in the "
            f"{x['n_few']} chunks with fewer than {x['sms']} rows (the "
            f"longest of them, ms and (R, P): "
            f"{[(round(m, 3), rp) for m, rp in x['longest_few']]}; device "
            f"time between events, launches queued behind other work); "
            f"the same uncut (spans=1, this call): "
            f"{x['uncut']['total']:.1f} ms, {x['uncut']['few']:.1f} ms in "
            f"those chunks (the longest: "
            f"{[(round(m, 3), rp) for m, rp in x['uncut']['longest_few']]})"
            f", {x['n_cut']} chunks cut; "
            f"the widest chunk: {x['widest']} slots; it "
            f"gathered "
            f"{x['gathered'] / 1e9:.2f} GB from the L2 and wrote "
            f"{x['written'] / 1e9:.2f} GB, "
            f"{x['gathered'] / x['total'] / 1e9:.3f} TB/s gathered over the "
            f"phase; X-phase Gram step ({names[1]} + index_add_) "
            f"{gram_tot:.1f} ms")

    def x_chunks_and_panels(model):
        """The most populous and the widest chunk of the X phase, and the
        fewest-row one and one of about 40 rows among those K2's cut
        takes (`cs.gram_spans`; the most slots among equals), each with
        its panel's zero-extended bf16 table and the same panel of the
        float32 initial factors (full 24-bit mantissas)."""
        plan, chunks, _ = model.plan_x
        s = plan.panel_size
        th32 = torch.nn.functional.pad(
            theta_t, (0, 0, 0, plan.n_panels * s - theta_t.shape[0]))
        th16 = th32.to(torch.bfloat16)
        sms = sm_count()
        cut = [c for c in chunks
               if cs.gram_spans(*c.cols.shape, cfg.f_pad, sms) > 1]
        if not cut:
            raise AssertionError("no X panel chunk takes K2's cut")
        picks = (("most populous",
                  max(chunks, key=lambda c: c.rows.shape[0] * c.width)),
                 ("widest", max(chunks, key=lambda c: c.width)),
                 ("fewest rows",
                  min(cut, key=lambda c: (c.rows.shape[0], -c.width))),
                 ("about 40 rows",
                  min(cut, key=lambda c: (abs(c.rows.shape[0] - 40),
                                          -c.width))))
        return [(label, ch, *(torch.cat(
            [t[ch.panel * s:(ch.panel + 1) * s],
             t.new_zeros((1, cfg.f_pad))]) for t in (th16, th32)))
            for label, ch in picks]

    def check_grams(model, aug, a_dtype, key):
        """K2 (or, with aug, K5a) on the four chunks (the most populous
        fills results[key], the others add their numbers to it), on the
        most populous also with the other A dtype, on the two chunks of
        few rows three ways (`check_gram` with cut), and on the most
        populous, the widest and the fewest-row chunk (three ways: it
        takes the cut) on a float32 table, which takes the split body
        (`cs.panel_body`), with an f32 and a bf16 A: a float32 copy of
        the bf16 panel (every entry exact in bf16, so the split's two
        lower pieces are zero) and the panel of the float32 initial
        factors (full mantissas: all three pieces live). Fills
        results[key]["split"]; the most populous on the full-mantissa
        table with an f32 A also results[key]["f32_table"]."""
        ok_all = True
        split = results.setdefault(key, {}).setdefault("split", {})
        for label, ch, tp, tp32 in x_chunks_and_panels(model):
            few = label in ("fewest rows", "about 40 rows")
            ok, res = check_gram(cs, tp, ch, a_dtype, aug, label, cut=few)
            ok_all &= ok
            if label == "most populous":
                results[key].update(res)
                other = torch.float32 if a_dtype == torch.bfloat16 else \
                    torch.bfloat16
                ok, res = check_gram(cs, tp, ch, other, aug, label)
                ok_all &= ok
                tag = "f32_out" if other == torch.float32 else "bf16_out"
                results[key].update({f"{tag}_{k}": res[k]
                                     for k in ("ms", "max_abs_err")})
            else:
                tag = label.split()[0]
                results[key].update(
                    {f"{tag}_{k}": v for k, v in res.items()},
                    **{f"{tag}_shape": list(ch.cols.shape)})
            if label == "about 40 rows":
                continue
            # the split body of csrc/split_gram_mma.cuh: a float32 table
            for table_tag, t, what in (
                    ("copy", tp.float(), "a copy of the bf16 one"),
                    ("full", tp32, "full mantissas")):
                for out in (torch.float32, torch.bfloat16):
                    ok, res = check_gram(
                        cs, t, ch, out, aug,
                        f"{label}, float32 table ({what})",
                        cut=label == "fewest rows")
                    ok_all &= ok
                    out_tag = "f32" if out == torch.float32 else "bf16"
                    split[f"{label.split()[0]}_{table_tag}_{out_tag}_A"] = \
                        {k: v for k, v in res.items()
                         if k not in ("gathered_bytes",)}
                    if label == "most populous" and table_tag == "full" \
                            and out == torch.float32:
                        results[key]["f32_table"] = {
                            k: res[k] for k in ("ms", "plain_ms",
                                                "max_abs_err", "bound_ms",
                                                "bound_by", "library_ms",
                                                "body")}
        return ok_all

    results, ok_all = {}, True
    ok_all &= check_theta(al, cfg, False, "gather_gram_cg")
    if only == THETA_SHORT:
        # K6 on the same chunks: lane 127 of the table is free at F=100
        ok_all &= check_theta(al, cfg, True, "gather_gram_cg_aug")
        ok_all &= ptxas_ok
        log(f"[theta] {'OK' if ok_all else 'FAIL'} (the short call: no "
            f"result line)")
        return 0 if ok_all else 1
    ok_all &= theta_edges(cs)

    plan_x, chunks_x, aux_x = al.plan_x
    a_dtype = al._accum_dtype(sum(c.rows.shape[0] for c in chunks_x),
                              plan_x.num_rows)
    ok_all &= gram_edges(cs)
    ok_all &= check_grams(al, False, a_dtype, "gather_gram_out")
    for label, ch, tp, _ in x_chunks_and_panels(al):
        if label == "fewest rows":
            ok, results[SPAN_SUM] = check_span_sum(
                cs, tp, ch, a_dtype, "the fewest-row X panel chunk K2's "
                "cut takes")
            ok_all &= ok

    a_buf, b_buf = al.accumulate_panels(theta_t, al.plan_x)
    x0_full = torch.zeros((aux_x["m_pad"], cfg.f_pad), device="cuda")
    ok, results["solve_cg_reg"] = check_k3(
        cs, a_buf, b_buf, x0_full, aux_x["row_nnz_pad"], 0,
        aux_x["solve_batch"], cfg)
    ok_all &= ok
    del a_buf, b_buf, x0_full
    totals(al, ("K1", "K2", "gather_gram_cg"))
    torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # ---- 3. small Netflix-shaped runs: card against CPU. The f32 limits
    # are those of the CPU tests: the card's f32 index_add_ adds with
    # atomics in an order that changes from run to run, which moves the
    # accumulators by rounding only.
    str_, ste = workload_ratings("netflix", scale=0.01, seed=1)
    scfg = cfg.replace(m=str_.num_rows, n=str_.num_cols, nnz=str_.nnz,
                       nnz_test=ste.nnz, panel_size=2048, verbose=False,
                       debug_timing=False)
    sx0, sth0 = init_factors(scfg.m, scfg.n, scfg.f, seed=0)
    for label, extra, aug_panel, lim_tr, lim_te in (
            ("bf16", {}, False, 5e-3, 1e-2),
            ("f32 aug auto", dict(gram_dtype="f32"), True, 1e-3, 1e-3),
            ("f32 aug force", dict(gram_dtype="f32", aug_gram="force"),
             True, 1e-3, 1e-3)):
        small = {}
        for dev in ("cuda", "cpu"):
            model = ALS(scfg.replace(**extra), str_, None, ste, device=dev)
            assert isinstance(model.plan_x[0], PanelPlan)
            assert isinstance(model.plan_theta[0], UpdatePlan)
            assert model._use_panel_aug() == aug_panel
            small[dev] = model.run(sx0, sth0).history
        for hg, hc in zip(small["cuda"], small["cpu"]):
            dtr = abs(hg.train_rmse - hc.train_rmse)
            dte = abs(hg.test_rmse - hc.test_rmse)
            log(f"[small {label}] iter {hg.iteration}: card train "
                f"{hg.train_rmse:.6f} test {hg.test_rmse:.6f} | cpu train "
                f"{hc.train_rmse:.6f} test {hc.test_rmse:.6f} (limits "
                f"{lim_tr:g}, {lim_te:g})")
            if not (dtr <= lim_tr and dte <= lim_te):
                raise AssertionError("card and CPU runs disagree")

    # ---- 4a. the bf16 path at full width (split buffers: K1, K2, K3)
    log(f"[main] data {gen_s:.1f} s, plans {plan_s:.1f} s")
    hist_main, launches = full_width(
        cs, al, "main", SPLIT_KERNELS + (SPAN_SUM, SPAN_SOLVE),
        AUG_KERNELS + WIDE_KERNELS + SPAN_KERNELS + TILED_KERNELS +
        ("solve_cg",), x0_np, th0_np, exact=theta_pass_2(cs, al))
    del al, plan_x, chunks_x, aux_x   # frees the plans on the card
    torch.cuda.empty_cache()

    # ---- 2b. the augmented kernels and K4 against their plain versions,
    # on the plans of this slice's configuration
    cfg_aug = cfg.replace(gram_dtype="f32", aug_gram="force")
    t0 = time.monotonic()
    al_aug = ALS(cfg_aug, train, csc, test, device="cuda")
    log(f"[aug] plans of the f32 aug_gram=force configuration "
        f"{time.monotonic() - t0:.1f} s")
    if not (isinstance(al_aug.plan_x[0], PanelPlan) and
            isinstance(al_aug.plan_theta[0], UpdatePlan) and
            al_aug._use_panel_aug() and cs.aug_enabled(cfg_aug)):
        raise AssertionError("expected the aug panel X route and the aug "
                             "direct theta route")
    ok_all &= check_theta(al_aug, cfg_aug, True, "gather_gram_cg_aug")
    ok_all &= check_grams(al_aug, True, torch.float32,
                          "gather_gram_aug_out")

    aux_x = al_aug.plan_x[2]
    batch, m_pad = aux_x["solve_batch"], aux_x["m_pad"]
    a_aug, none = al_aug.accumulate_panels(theta_t, al_aug.plan_x)
    if none is not None or a_aug.dtype != torch.float32:
        raise AssertionError("expected one f32 augmented accumulator")
    x0_full = torch.zeros((m_pad, cfg.f_pad), device="cuda")
    nnzf = aux_x["row_nnz_pad"].float()
    diag_full = nnzf * cfg.lam + (nnzf == 0).float()
    ok, results["solve_cg_aug"] = check_solve(
        cs, "solve_cg_aug", (a_aug[:batch], diag_full[:batch],
                             x0_full[:batch]), "slice", cfg_aug.cg_iters,
        cfg_aug.cg_tol, before=ONE_BLOCK_MS["solve_cg_aug"])
    ok_all &= ok

    def regularized(lo):
        """Systems [lo, lo + batch) unpacked, diagonal already added."""
        ua, ub, _ = cs.unpack_aug(a_aug[lo:lo + batch])
        ua.diagonal(dim1=1, dim2=2).add_(diag_full[lo:lo + batch, None])
        return ua, ub

    a_reg, b_reg = regularized(0)
    ok, results["solve_cg"] = check_solve(
        cs, "solve_cg", (a_reg, b_reg, x0_full[:batch]),
        "ops.solve.solve without diag, slice", cfg_aug.cg_iters,
        cfg_aug.cg_tol, before=ONE_BLOCK_MS["solve_cg"],
        fn=dispatch_k4(solve))
    ok_all &= ok
    del a_reg, b_reg
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # K4's path: the dispatcher without a diagonal over every solve slice,
    # held against the augmented solve of the same systems (K5b adds the
    # same diagonal to the same f32 entries, so the two agree closely)
    kw = dict(solver="cg", cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
              backend="pallas")
    cs.reset_launch_counts()
    k4_err = 0.0
    for lo in range(0, m_pad, batch):
        a_reg, b_reg = regularized(lo)
        x4 = solve(a_reg, b_reg, x0_full[lo:lo + batch], **kw)
        del a_reg, b_reg
        x5 = solve(a_aug[lo:lo + batch], None, x0_full[lo:lo + batch],
                   diag=diag_full[lo:lo + batch], aug=True, **kw)
        k4_err = max(k4_err, (x4 - x5).abs().max().item())
        if not bool(torch.isfinite(x4).all()):
            raise AssertionError("K4 path: non-finite solution")
    torch.cuda.synchronize()
    k4_launches = cs.LAUNCHES["solve_cg"]
    log(f"[K4 path] ops.solve.solve(cg, pallas, no diag) over "
        f"{m_pad // batch} slices of {batch} systems: {k4_launches} "
        f"launches, max|x - x_aug|={k4_err:.3e} (limit 1e-5)")
    if k4_launches < m_pad // batch or k4_err > 1e-5:
        raise AssertionError("K4 path failed")
    del a_aug, x0_full, diag_full, nnzf
    totals(al_aug, ("K6", "K5a", "gather_gram_cg_aug"))
    del theta_t, x_t, table_ext
    torch.cuda.empty_cache()

    # ---- 4b. this slice's path at full width (f32 accumulators,
    # aug_gram="force": K5a, K5b, K6)
    hist_aug, launches_aug = full_width(
        cs, al_aug, "aug", AUG_KERNELS + (SPAN_SUM, SPAN_SOLVE),
        SPLIT_KERNELS + WIDE_KERNELS + SPAN_KERNELS + TILED_KERNELS +
        ("solve_cg",), x0_np, th0_np, exact=theta_pass_2(cs, al_aug))
    for hm, ha in zip(hist_main, hist_aug):
        log(f"[main | aug] iter {hm.iteration}: train {hm.train_rmse:.6f} | "
            f"{ha.train_rmse:.6f}, test {hm.test_rmse:.6f} | "
            f"{ha.test_rmse:.6f} (no limit: bf16 and f32 accumulators "
            f"round differently by design)")

    # ---- 4c. the default float32 configuration at full width, on 4b's
    # plans: K5a on the split body, K5b, K1 on a float32 table
    f32_default(cs, al_aug, hist_aug, x0_np, th0_np, results)

    del al_aug, aux_x   # frees the plans on the card
    torch.cuda.empty_cache()

    # ---- 5. the factor widths above 128
    wide_launches, hist_wide_off = wide_paths(
        cs, ALS, cfg, train, csc, test, str_, ste, results)

    # ---- 6. the batched-panel route
    results["gather_gram_out"]["batched_panel_launches"] = batched_panel(
        cs, ALS, cfg, train, csc, test, x0_np, th0_np)

    # ---- 7, 8. the port's bench on the cached data, and its accuracy
    # contracts
    bench_main()
    bench_accuracy()

    # ---- 9. out-of-core training on hugewiki_mini
    ooc_launches, ooc_checks, res_ooc = out_of_core(cs, bench)
    for name in SPLIT_KERNELS:
        results[name]["ooc_launches"] = ooc_launches[name]
        results[name]["ooc_check"] = ooc_checks[name]
    results[SPAN_SOLVE]["ooc_launches"] = ooc_launches.get(SPAN_SOLVE, 0)

    # ---- 10. sharded training on the Netflix data: one rank (NCCL), two
    # ranks on the one card (gloo)
    sh_launches, sh_checks = sharded(cs, bench, cfg, train, test, hist_main)
    for name in SPLIT_KERNELS:
        results[name]["sharded_launches"] = {
            k: v.get(name, 0) for k, v in sh_launches.items()}
        results[name]["sharded_check"] = sh_checks[name]
    results[SPAN_SOLVE]["sharded_launches"] = {
        k: v.get(SPAN_SOLVE, 0) for k, v in sh_launches.items()}

    # ---- 11. sharded out-of-core training on hugewiki_mini: one rank
    # (NCCL) with X on the host, on the card, on lazy plans; two ranks on
    # the one card (gloo)
    so_launches, so_checks = sharded_ooc(cs, bench, res_ooc)
    del res_ooc
    for name in SPLIT_KERNELS:
        results[name]["sharded_ooc_launches"] = {
            k: v.get(name, 0) for k, v in so_launches.items()}
        results[name]["sharded_ooc_check"] = so_checks[name]
    results[SPAN_SOLVE]["sharded_ooc_launches"] = {
        k: v.get(SPAN_SOLVE, 0) for k, v in so_launches.items()}

    # ---- 12. the integrations and entry points: the hugewiki driver,
    # entry() (K4), dryrun_multichip(), the torch op
    hw_launches, k4_entry, _ = integrations(cs, bench)
    for name in SPLIT_KERNELS + (SPAN_SOLVE,):
        results[name]["hugewiki_launches"] = hw_launches.get(name, 0)
    results["solve_cg"]["entry_check"] = k4_entry

    # ---- 13. the panel and solve kernels at 256 lanes, and the paths
    # they open: out-of-core at F=200, Netflix F=200 on the panel route
    panel_256(cs, bench, ALS, cfg, train, csc, test, hist_wide_off, results)

    # ---- 14. factor widths F > 256: Netflix at F=300 (f_pad 384), the
    # kernels of f >= 384 and three routes
    launches_wide_f = wide_f(cs, ALS, cfg, train, csc, test, results)
    launches.update({k: launches_wide_f[k] for k in TILED_KERNELS})

    launches.update({k: launches_aug[k] for k in AUG_KERNELS})
    results[SPAN_SUM]["aug_launches"] = launches_aug[SPAN_SUM]
    results[SPAN_SOLVE]["aug_launches"] = launches_aug[SPAN_SOLVE]
    launches["solve_cg"] = k4_launches
    launches.update(wide_launches)
    kernels = [{"name": name, "route": "cuda",
                "source": f"cumf_als_tpu_torch/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                "body": BODY[name], **results[name]} for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
