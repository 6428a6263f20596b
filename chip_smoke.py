#!/usr/bin/env python3
"""Smoke run of fluidgym_tpu_torch on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds:

1. the card's name and power limit (``nvidia-smi``);
2. build of the CUDA kernels (K1/K3/K3-coarse/K3-agg ``csrc/cg.cu``, K2
   ``csrc/bicgstab_mb.cu``, K4 ``csrc/stencil.cu``): one ``nvcc -c`` per
   source, all started together, and one link into ``build/kernels/``;
3. K1 against its plain PyTorch version on the card: the pressure system of
   the bundled RBC2D-easy snapshot at the main-path shape (1, 61, 96), then a
   4-lane run whose lanes converge at different speeds (one zero RHS) and
   that passes iteration 100; then the main-path solve in both arms, in
   turns (the chunk grid, the resident arm, the resident arm, the chunk
   grid): ms per raw launch on preallocated buffers, us per iteration, ms
   per wrapper call with the arm pinned;
4. K2 against its plain version: the snapshot's temperature (1 lane) and
   velocity (2 lanes) advection systems, then both arms in turns as in 3;
5. the main path: ``make("RBC2D-easy-v0")`` at its registered full width,
   ``reset(seed=0)``, 3 steps with fixed numpy actions; the kernels' launch
   counters are zeroed just before and read just after: every substep must
   launch K1 once per pressure corrector and K2 once per advection solve,
   every one of them on the resident arm (``.resident_launches`` equal to
   ``.launches``), and neither the plain versions nor ``linsolve``'s loops
   may run;
6. the card against the host (the kernels against the plain versions, end
   to end): a small config for 3 steps and the full width from the bundled
   snapshot for 1 step; observations and rewards must agree to 1e-4;
7. K3 (``csrc/cg.cu`` ``fg_cg_mb_solve``) against its plain version on the
   pressure system of the bundled CylinderJet2D-easy snapshot at full width
   (5 blocks -> 2 super-blocks, 14,232 cells): cold, warm-started from the
   deflated guess, and a 3-lane run whose lanes converge at different
   speeds (one zero RHS) and that passes iteration 100;
8. K2 in merged form ("K2-mb", ``fg_bicgstab_mb_solve``) against its plain
   version on the snapshot's velocity advection system (2 lanes);
9. the cylinder main path: ``make("CylinderJet2D-easy-v0")`` at its
   registered defaults, ``reset(seed=0)``, 3 steps with fixed numpy actions;
   the counters are zeroed just before and read just after: in every step
   K3 launches twice per substep and K2-mb once, no plain version and no
   ``linsolve`` loop runs; drag, lift, obs and reward finite;
10. the card against the host for the cylinder: 1 env step from the bundled
   snapshot, no randomization; obs and reward must agree to 1e-4;
11. K3 and K2-mb in their flip-seam form ("K3-flip", "K2-mb-flip": the
   Airfoil2D C-grid, 6 blocks -> 3 super-blocks whose wake cut is a
   reflected seam, 73,456 cells) against their plain versions on the
   pressure and velocity advection systems of the bundled Airfoil2D-easy
   ``train_00`` snapshot at full width: K3 cold and warm from the deflated
   guess, K2-mb with 2 lanes; the same iteration counts;
12. the airfoil main path: ``make("Airfoil2D-easy-v0")`` at its registered
   defaults (no randomization), ``reset(seed=0)``, 1 step with a fixed numpy
   action; in every step K3-flip launches twice per substep and K2-mb-flip
   once, no other kernel form, no plain version and no ``linsolve`` loop;
   obs, reward, drag and lift finite;
13. the card against the host for the airfoil: 1 sim step (``step_length =
   dt``) from the bundled snapshot; the velocity obs and the reward must
   agree to 1e-4, the pressure obs to 1e-3 (float32 decides it only to
   ~1e-4 here; see ``MERGED_CASES``);
14. K4 (``csrc/stencil.cu``, the fused 2D stencil apply) against its plain
   version on every block of the two snapshots' pressure operators, scalar
   and in the deflation setup's column form (15 / 18 columns): max|dy|
   (bar 1e-6 relative; it is bit-equal when the rounding matches), us per
   launch, the bound;
15. K3-coarse (``csrc/cg.cu`` ``fg_cg_mb_coarse_solve``, the strip-coarse
   two-level preconditioner of ``solver/coarse_strips.py``, K = 34 strips)
   against its plain version on the cylinder's full-width pressure system:
   cold, warm from the deflated guess and a 3-lane run past iteration 100;
   the same converged flags, iterations within 2; each run also at the
   cluster rule's C (one lane over C SMs, ``csrc/krylov.cuh``; the 1-lane
   runs through the wrapper at it) bit-equal to C = 1 (x, iterations,
   residual); the warm solve's raw launch at C = 1 and at the rule's C in
   turns (ms, us per iteration), the coarse inverse's ms, the bound and
   the streamed bound; the Jacobi-only K3 iterations on the same systems
   beside them;
16. K3-coarse-flip likewise on the airfoil's system (K = 59);
17. the slice's main path: ``make`` of each merged id at its registered
   defaults, ``reset(seed=0)``, then ``SimConfig.pressure_coarse_strips``
   and the K4 switch on; 3 cylinder steps and 1 airfoil step with phases
   9 and 12's actions; in every step K3-coarse(-flip) launches twice per
   substep, each on the cluster arm (``.cluster_launches``), K2-mb(-flip)
   once, K4 once per block per ``domain_apply`` (15
   per cylinder substep, 18 per airfoil substep), and no other kernel form,
   plain version or ``linsolve`` loop; ms and pressure iterations per env
   step beside phases 9 and 12's;
18. the card against the host for the cylinder with the strips and K4 on:
   1 env step at full width from the bundled snapshot; obs and reward to
   1e-3, the card's solves as the cluster rule picks them (with the strips
   a float32 step is rounding-decided; see ``_strips_card_vs_host``);
19. the chunk grid: K1, K2, K3, K2-mb, K3-flip and K3-coarse at 130 lanes
   with one operator per lane, in chunks of 33 (4 blocks in one launch)
   against their plain versions in the same chunks (the same converged
   flags, iterations and x within each form's bar, a zero lane exactly 0,
   the CG forms past iteration 100); the vmapped wrapper equal to its raw
   launch, and no launch of the batch on the cluster arm; ms per solve at
   1, 64 and 130 lanes and the bound of the batch;
   K1 and K2 also in both arms at 1, 64 and 130 lanes, one lane per block,
   in turns (ms per raw launch);
20. the batched main path: ``BatchedFluidEnv("RBC2D-easy-v0", 64)`` at its
   registered defaults, ``reset(seed=0)``, 3 steps with seeded numpy
   actions; counters zeroed just before and read just after: in every step
   K1 launches exactly 2 and K2 2 per lockstep round, whatever the batch,
   every one on the resident arm, and no other kernel form, plain
   version, ``linsolve`` loop or vmap
   per-lane fallback runs; lanes 0 and 63 against single envs reset from
   the same seeds (see ``BATCH_CASES`` for the bars);
21. the same for ``CylinderJet2D-easy-v0``, 2 steps, its resets from the
   bundled snapshot without randomization: K3 2 and K2-mb 1 per round;
22. batched env-steps/s beside the single env's, measured in the same run;
23. the cluster arm of K3 and K2-mb (one lane over a thread-block cluster,
   ``csrc/krylov.cuh``): K3, K3-flip, K2-mb and K2-mb-flip at their
   main-path shapes (phases 7, 8 and 11's systems) for C = 1 and every
   cluster size the card holds for their lanes, in turns on one card:
   against the plain version (the same converged flags, iterations within
   3, x within phases 7, 8 and 11's bars), two runs bit-equal, C = 1
   through the wrapper bit-equal to the chunk grid's raw launch; ms per
   wrapper call and per raw launch (preallocated buffers), us per
   iteration, the C that ``default_cluster`` picks and
   ``cudaOccupancyMaxActiveClusters`` per C;
24. the resident arm of K1 and K2 (one lane per block, the lane's operator
   rows and four vectors in shared memory, ``csrc/krylov.cuh``): on the
   main path's solves of phases 3-4 and phase 19's 64 and 130 lanes it
   must return the chunk grid's x, iterations and residual bit for bit,
   twice, and per raw launch (phases 3, 4 and 19) be no slower than the
   chunk grid at 1 and 64 lanes;
25. K1-3D and K2-3D (the 3D roll forms) against their plain versions on
   the solves of a first substep of RBC3D-easy (64, 41, 64) and
   RBC3D-wide-easy (128, 41, 128) from their bundled snapshots, captured at
   the wrappers: K1 on 1 and 2 lanes, K2 on the temperature (1 lane) and
   velocity (3 lanes) solves, with phases 3 and 4's bars; on each, the
   spread arm (one lane over G co-resident blocks, ``csrc/krylov.cuh``) at
   every G the card holds for the lanes, in both layouts, must return the
   chunk grid's x, iterations and residual bit for bit, and is timed
   against it per raw launch in turns; at (128, 41, 128) the rule's arm
   must be faster than the chunk grid for K1 and K2's velocity solve; ms
   per wrapper call and per raw launch, us per iteration, the plain
   version's ms, the bound;
26. the RBC3D main path: ``make("RBC3D-easy-v0")`` at its registered
   defaults (MARL, 64 agents), ``reset(seed=0)`` (randomized: noise and a
   1-2 time-unit burn-in), 3 steps; then ``use_marl=False``, 1 step; the
   counters zeroed just before each ``make`` and read after every step: in
   every step K1 launches once per pressure corrector per substep and K2
   once per advection solve, every one of them a 3D launch (K1-3D, K2-3D)
   on the spread arm, and no other kernel form, plain version or
   ``linsolve`` loop runs; ms and pressure iterations per env step;
27. the card against the host for RBC3D-easy: 1 sim step (``step_length =
   dt``) at full width from the bundled snapshot; obs and rewards to 1e-4;
28. ``RBC3D-wide-easy-v0`` (256 agents, (128, 41, 128)): reset and 1 step
   with phase 26's checks;
29. the five other RBC2D ids (medium, hard, wide-easy, wide-medium,
   wide-hard) at their registered defaults: reset and 2 steps each with
   phase 26's checks, the (61, 96) blocks on the resident arm and the (61,
   192) blocks on the spread arm (G = 32);
30. the other four RBC3D ids: ``make`` at the registered defaults on the
   card, then (this run does not read their datasets) 1 step from a
   conduction state at full width with phase 26's checks;
31. the spread arm against the chunk grid end to end: RBC3D-easy (2
   steps), RBC3D-wide-easy (1) and RBC2D-wide-easy (1, the spread arm
   pinned to G = 32) at their registered defaults, four arms in turns
   (chunk grid, spread, spread, chunk grid) from one reset state, obs
   bit-equal across the arms: ms per env step of each; and RBC2D-wide's
   (61, 192) K1 lane per raw launch at every G against the chunk grid;
32. K3-3D and K2-mb-3D (the 3D merged forms: identity seams, periodic z)
   against their plain versions on the solves of a first substep of
   CylinderJet3D-easy from its bundled ``train_00`` snapshot at full width
   (341,568 cells, 2 super-blocks), captured at the wrappers: the pressure
   solve cold and warm from the deflated guess, a 3-lane pressure run (one
   zero RHS) past iteration 100, the velocity advection solve (3 lanes);
   the same converged flags, iterations within 3 (K3) / 2 (K2), x within
   phases 7-8's bars; ``default_cluster`` gives 1, the launcher refuses
   C = 2 and ``merged_arm`` picks the spread arm (G = 128 for K3, 32 for
   K2-mb's 3 lanes); on each system the spread arm at every G the card
   holds for the lanes, in both layouts, must return the chunk grid's x,
   iterations and residual bit for bit, twice, timed against it per raw
   launch in turns; then CylinderJet3D-medium's first pressure solve
   (749,568 cells) alike; the rule's arm must be faster per raw launch than
   the chunk grid for K3-3D at both widths and for K2-mb-3D; ms per wrapper
   call and per raw launch, us per iteration, the plain version's ms, the
   bound;
33. the CylinderJet3D-easy main path: ``make("CylinderJet3D-easy-v0")`` at
   its registered defaults (SARL, 8 jets), ``reset(seed=0)``
   (randomized), 1 step with a fixed numpy action; then ``use_marl=True``
   (8 agents): reset and 1 step; the counters zeroed just before each
   ``make`` and read after every step: in every step K3 launches twice per
   substep and K2-mb once, every one a 3D merged launch
   (``.launches_3d`` / ``.merged_launches_3d``) on the spread arm
   (``fused_cg_mb.spread_launches`` / ``fused_bicgstab_mb.
   merged_spread_launches`` equal to them, no cluster launch), and no
   other kernel form, plain version or ``linsolve`` loop runs; drag, lift,
   obs and rewards finite; ms and pressure iterations per env step;
34. the card against the host for CylinderJet3D-easy: 1 sim step
   (``step_length = dt``) at full width from the bundled snapshot, no
   randomization; obs and reward to 1e-4 (see ``CYL3D_HOST_BARS``);
35. ``CylinderJet3D-medium-v0`` (749,568 cells) at its registered
   defaults: reset from its bundled ``train_00`` (randomized) and 1 step
   with phase 33's checks;
36. the merged forms' spread arm against the chunk grid end to end:
   CylinderJet3D-easy (1 SARL step; four arms in turns: chunk grid,
   spread, spread, chunk grid) and -medium (1 step; chunk grid, spread)
   at their registered defaults, every arm from the state phases 33
   (SARL) and 35 left, the chunk grid pinned with
   ``cg_cuda.pinned_spread(0)``; obs bit-equal across the arms; ms per
   env step of each arm and, for easy, device ms of the first step per
   arm (``torch.profiler``, CUDA activity only);
37. the 2D cylinder ids of the upwind blend (``CylinderJet2D-medium/-hard``,
   ``CylinderRot2D-easy/-medium/-hard``; 23,424 cells, Rot2D-easy
   14,232) at their registered defaults: ``reset(seed=0)`` (randomized),
   1 step with a fixed non-zero action; the counters zeroed before and
   read after every step: K3 twice per substep and K2-mb once, every one
   on the cluster arm, no other form, plain version or ``linsolve`` loop;
   drag, lift, obs and reward finite; the C that ``default_cluster``
   picks, ms per env step, substeps and pressure iterations; then K3 and
   K2-mb on the captured first-substep solves of CylinderJet2D-hard
   (``train_00``) against their plain versions with phases 7-8's bars, the
   rule's C bit-equal to C = 1 twice, both per raw launch in turns, the
   bound;
38. the card against the host for ``CylinderRot2D-easy-v0`` and
   ``CylinderJet2D-hard-v0`` (the blend): 1 env step at full width from the
   bundled ``test_00``, no randomization; obs and reward to 1e-4;
39. K3-3D and K2-mb-3D on the captured first-substep solves of
   CylinderJet3D-hard (``test_00``, 2,481,408 cells): the card's
   co-residency at this width (one 155,136 B block per SM at G = 128, and
   G = 64 / 32 do not fit), ``merged_arm`` K3 at G = 128 and K2-mb's 3
   lanes one per launch at G = 128; against the plain versions with phase
   32's bars (a converged lane's true residual within 2 tol or twice the
   plain version's own); the rule's arm bit-equal to the chunk grid twice,
   both per raw launch in turns; ms per wrapper call, us per iteration,
   the bound;
40. ``CylinderJet3D-hard-v0`` at its registered defaults (SARL) from its
   bundled ``test_00`` (``load_initial_domain``), 1 step with phase 33's
   checks: every K3-3D and K2-mb-3D launch (3 K2-mb per substep, one per
   lane) on the spread arm, no chunk-grid launch; ms per env step,
   substeps and pressure iterations;
41. K3-agg-flip (``csrc/cg.cu`` ``fg_cg_mb_agg_solve``: K3 with the
   aggregation coarse space of 8 x 8 tiles, k = 1,194, its Einv fixed per
   env) on the first substep's two pressure solves of one
   Airfoil2D-medium sim step from its bundled ``train_00``, captured at
   the wrapper: against its plain version with phase 7's bars and the same
   converged flags; the rule's C (16) bit-equal to C = 1 twice, both per
   raw launch in turns; ms, us per iteration, the bound and the streamed
   bound; the K3-agg instances' registers and spill bytes (``ptxas -v`` of
   the build, or of ``cg.cu`` compiled again where the library was cached),
   the cluster instance's spill stores at most ``AGG_SPILL_LIMIT``;
42. ``Airfoil2D-medium-v0`` and ``-hard-v0`` at their registered defaults
   from the bundled ``train_00`` (no randomization): reset and 1 step
   each, shortened to one sim step (``step_length`` = dt); counters zeroed
   before ``make`` and read after every step: per
   substep 2 K3-agg-flip and 1 K2-mb-flip launches, every one on the
   cluster arm, no other kernel form, plain version or ``linsolve`` loop;
   obs, reward, drag and lift finite, every pressure solve converged; ms,
   substeps and pressure iterations per env step;
43. the card against the host for ``Airfoil2D-medium-v0``: 1 sim step of
   0.01 from ``train_00``; velocity obs and reward to 1e-4, pressure obs
   to 1e-3 (phase 13's bars);
44. K1-3D and K2-3D on the first substep's solves of
   ``TCFSmall3D-bottom-easy-v0`` from its bundled ``train_01`` and
   ``TCFLarge3D-bottom-easy-v0`` from its generated state (Reichardt
   profile plus curl noise), captured at the wrappers: K1 on the pressure
   system and on a random right-hand side of its operator, K2 on the
   velocity system warm (as the solver starts it) and cold, against their
   plain versions with phase 25's bars; the rule's arm bit-equal to the
   chunk grid twice, both per raw launch in turns; at TCFLarge's width
   K2-3D's 3 lanes one per launch at G = 128 (no G holds them at once:
   the card's co-residency per G is printed); ms, us per iteration, the
   bound and the streamed bound;
45. ``TCFSmall3D-bottom-easy-v0`` and ``TCFSmall3D-both-easy-v0`` at their
   registered defaults (MARL, a randomized reset from the bundled
   snapshot): reset and 2 steps each; counters zeroed before ``make`` and
   read after every step: per substep 2 K1-3D and 1 K2-3D launches, every
   one on the spread arm, no chunk grid, other kernel form, plain version
   or ``linsolve`` loop; obs, rewards and wall stresses finite, every
   pressure solve converged; ms, substeps and pressure iterations per env
   step;
46. ``TCFLarge3D-bottom-easy-v0`` and ``TCFSmall3D-bottom-hard-v0`` from
   their generated states, 1 step each with phase 45's checks (TCFLarge:
   3 K2-3D spread launches per substep, one per velocity lane);
47. the card against the host for ``TCFSmall3D-bottom-easy-v0`` (SARL):
   1 env step (10 sim steps: the channel's dt is a tenth of its step)
   from ``train_01``, no randomization; velocity obs and wall stresses to
   1e-4, pressure obs to 1e-3 (phase 34 found that the host alone moves a
   3D float32 pressure obs by ~5e-5);
48. K3-3D-flip and K2-mb-3D-flip (K3 and K2-mb over the 3D merge plan of
   the Airfoil3D C-grid, whose wake cut reverses x) on the first substep's
   solves of phase 49 at full width (7,051,776 cells): the spread arm with
   its chain terms through a ring of tiles in shared memory (no G's terms
   fit shared memory whole there; the 3 velocity lanes one per launch)
   against the plain versions with phase 32's bars, bit-equal to the chunk
   grid twice, both timed per raw launch in turns at 100 iterations (ms, us
   per iteration, the bound, the streamed bound, the shared memory per
   block); the same forms on phase 50's card solves at ``_res_z`` 8
   (587,648 cells) on the shared-memory spread arm, bit-equal to the chunk
   grid; CylinderJet3D-easy's captured 341,568-cell solves with the ring
   pinned, bit-equal to the shared-memory arm and timed beside it;
49. ``Airfoil3D-easy-v0`` at its registered defaults but
   ``load_initial_domain=False`` (no 3D set is bundled: the 2D warm start
   from ``airfoil_2D_Re1000/train_00``, drawn by seed 23), no
   randomization and ``step_length`` = dt: ``reset(seed=23)`` and one sim
   step; per substep 2 K3-3D-flip and 3 K2-mb-3D-flip launches, every one
   on the spread arm with its chain terms through the ring, no chunk grid,
   plain version or ``linsolve`` loop; the warm start applied to every
   block; obs, reward and per-slice drag and lift finite, every pressure
   solve converged; ms, substeps and iterations;
50. the card against the host for ``Airfoil3D-easy-v0`` at ``_res_z`` 8:
   one sim step of 0.01 from ``reset(seed=23)``; velocity obs and reward
   to 1e-4, pressure obs to 1e-3 (phase 43's bars).
51. the differentiable path: ``make("RBC2D-easy-v0", differentiable=True)``
   at its registered defaults, ``reset(seed=0)``, one env step with an
   action that requires grad, ``reward.sum().backward()``; counters zeroed
   before the step and before the backward: per substep 2 K1 and 2 K2
   launches forward, and as many backward (the transposed solves: K1 on
   the cotangent, K2 on ``stencil.transpose_ops``), every one on the
   resident arm, no plain version, no ``linsolve`` loop, no substep in the
   backward; the action's gradient finite and non-zero; ms forward and
   backward, peak device memory; then the same step and backward from the
   same state and action through the plain versions on the card (no
   launch): the two gradients within ``DIFF_PLAIN_BARS`` of max|g|;
52. the same for ``CylinderJet2D-easy-v0`` (2 K3 and 1 K2-mb per substep
   each way, every one on the cluster arm, the deflation guess taken once
   per forward and once per transposed K3 solve); then
   ``piso_fixed_steps`` over 2 substeps from the state it left, the state
   gradient (``diff_tools.state_vjp``) with ``use_remat=True`` bit-equal to
   the one without, K3 / K2-mb launches 8 / 4 without and 12 / 6 with;
53. phase 51's gradient at a small RBC2D config: the card in float32
   through the kernels against the plain versions on the card (within
   ``DIFF_PLAIN_BARS[53]`` of max|g|) and against the host in float64
   (within ``DIFF_HOST_BAR``);
54. the SB3 recipe: ``VecFluidEnv(FlattenObservation(make("RBC2D-easy-v0",
   use_marl=True, load_initial_domain=False, load_domain_statistics=False,
   episode_length=2)))`` at (61, 96) for 3 steps (one auto-reset) in turns
   with the bare env on the same actions: obs and rewards bit for bit, the
   K1 / K2 launches of each step equal and all on the resident arm, no
   plain version, no ``linsolve`` loop; ms per env step of both; then each
   layer's own host ms per step over a replay of the last step;
55. ``GymFluidEnv(ActionNoise(SensorNoise(ObsExtraction(make(
   "CylinderJet2D-easy-v0"), ["pressure"]))))`` (the adapter's ``object``
   base where gymnasium is absent), reset and 2 steps in turns with a bare
   env into which the same noise draws are replayed: obs and reward bit
   for bit, tensors on the card below the adapter and numpy above it, K3 /
   K2-mb launches of each step equal and all on the cluster arm; ms per
   env step; each layer's own host ms per step;
56. the render fields (RBC2D-easy's scaled temperature, CylinderJet2D-easy's
   vorticity, on their render grids) of phases 54-55's envs on the card
   against a CPU env on the same state (``get_state`` ->
   ``env_state_to_numpy`` -> ``env_state_from_numpy``), within
   ``RENDER_BAR`` of each field's max; the colormap step is not run.
Phases 48-50 run in the order 49, 50, 48: phase 48 holds the solves the
other two capture.

Phases 9 and 12 also hold every K3 and K2-mb launch of the single env's
main path to the cluster arm (``.cluster_launches`` equal to the form
counts).  Then a ``{"kernels": [...]}`` line, and last ``{"ok": true,
"device": ...}``.
Any failed check exits non-zero; there is no CPU fallback.  Imports nothing
of JAX or of the JAX package.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

H100_BYTES_PER_S = 3.35e12    # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores, SXM data sheet

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def arm_times(torch, cg_cuda, launcher, wrapper, reps: int = 10) -> dict:
    """K1 / K2 (roll form) in its two arms, in turns (the chunk grid, the
    resident arm, the resident arm, the chunk grid) on one card:
    ``launcher(resident)`` gives a raw launch on preallocated buffers,
    ``wrapper()`` one wrapper call (the arm pinned with
    ``cg_cuda.pinned_resident``).  Returns the mean ms per raw launch and
    per wrapper call of each arm, the iterations and us per iteration."""
    launches = {arm: launcher(arm) for arm in (False, True)}
    raw = {False: 0.0, True: 0.0}
    wrap = {False: 0.0, True: 0.0}
    for arm in (False, True, True, False):
        raw[arm] += cuda_ms(torch, launches[arm], reps) / 2
        with cg_cuda.pinned_resident(arm):
            wrap[arm] += cuda_ms(torch, wrapper, reps) / 2
    its = int(launches[True]()[1].max())
    return dict(iterations=its, raw_ms=raw[True], raw_ms_global=raw[False],
                ms=wrap[True], ms_global=wrap[False],
                us_per_it=raw[True] * 1e3 / max(its, 1),
                us_per_it_global=raw[False] * 1e3 / max(its, 1))


def bound_ms(n_cells: int, lanes: int, ndims: int, iters: int, algo: str,
             warm: bool, op_shared: bool, seam_cells: int = 0,
             coarse_K: int = 0) -> tuple[float, str, float]:
    """Least time for the same work on an H100 (the larger of: bytes read
    once / written once over HBM rate, and this run's fp32 operations over
    the fp32 rate), and the time if every field went through HBM once per
    pass instead (``stream``: the working set NOT kept on chip).
    ``n_cells``: cells of a lane, summed over the super-blocks of a merged
    plan; ``seam_cells``: cells of its seam-fixup slabs (each read once more
    and corrected once more per matvec); ``coarse_K``: strips of K3-coarse
    (its K x K inverse and per-strip cell lists read once; per iteration a
    restriction add and a prolongation add per cell and a K x K product)."""
    nf = 2 * ndims
    op_words = (1 + nf) * n_cells * (1 if op_shared else lanes)
    if coarse_K:
        op_words += coarse_K * coarse_K + 2 * n_cells + coarse_K + 1
    io_words = (op_words + lanes * (n_cells * (2 + (1 if warm else 0))
                                    + seam_cells) + 2 * lanes)
    t_bytes = 4 * io_words / H100_BYTES_PER_S * 1e3
    if algo == "cg":
        flops_cell = 4 * ndims + 14       # matvec, 2 axpy, precond, 3 dots, p
        mv_per_it = 1
        stream_words = n_cells * (nf + 1 + 10)
    else:
        flops_cell = 8 * ndims + 26       # 2 matvecs, 2 precond, 5 dots, updates
        mv_per_it = 2
        stream_words = n_cells * (2 * (nf + 1) + 22)
    if coarse_K:
        flops_cell += 2
    flops = float(iters) * lanes * (n_cells * flops_cell
                                    + 3 * mv_per_it * seam_cells
                                    + 2 * coarse_K * coarse_K)
    t_ops = flops / H100_FP32_FLOPS * 1e3
    stream = float(iters) * lanes * 4 * stream_words / H100_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", stream
    return t_bytes, "bytes", stream


def count_calls(piso, linsolve):
    """Count substeps and ``linsolve``'s plain Krylov loops by wrapping the
    module functions the solver looks up at call time.  Returns ``(calls,
    restore)``."""
    calls = {"piso_substep_info": 0, "cg": 0, "bicgstab": 0}
    originals = [(mod, name, getattr(mod, name)) for mod, name in (
        (piso, "piso_substep_info"), (linsolve, "cg"), (linsolve, "bicgstab"))]
    for mod, name, fn in originals:
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)

    def restore():
        for mod, name, fn in originals:
            setattr(mod, name, fn)

    return calls, restore


def compare(name, wrapper_call, plain_call, b, tol, rel_tol, it_tol,
            matvec, plain_bar: bool = False):
    """Kernel vs plain on the same inputs: iterations within ``it_tol``,
    max|dx| <= rel_tol * max|x_plain|, converged lanes' true residual
    RMSE <= 2 tol, zero-RHS lanes exactly zero.  ``plain_bar``: a converged
    lane's true residual may also reach twice the plain version's own on
    the same lane (a float32 solution of a system with a large diagonal
    has a float64 residual floor of ~eps * |A x|, and BiCGStab stops on its
    recursive residual, so the plain version lands above 2 tol there too)."""
    import torch

    xk, ik, rk = wrapper_call()
    xp, ip, rp = plain_call()
    torch.cuda.synchronize()
    err = float((xk - xp).abs().max())
    scale = float(xp.abs().max())
    L = b.shape[0]
    # the true residual in float64: in float32, b - A x has a rounding
    # floor of ~eps * |A x| per cell, above tol for these systems
    true_rmse = lambda x: torch.sqrt(
        ((b.double() - matvec(x.double())).reshape(L, -1) ** 2).mean(dim=1))
    rmse = true_rmse(xk)
    bars = [2 * tol] * L
    if plain_bar:
        bars = [max(2 * tol, 2 * v) for v in true_rmse(xp).tolist()]
    conv = rp <= tol * tol * b[0].numel()
    zero = (b.reshape(L, -1) == 0).all(dim=1)
    log(f"  {name}: iters kernel {ik.tolist()} plain {ip.tolist()} | "
        f"max|dx| {err:.3e} (max|x| {scale:.3e}, bar {rel_tol:g} rel) | "
        f"true-residual rmse {[f'{v:.2e}' for v in rmse.tolist()]} "
        f"(bar 2*tol = {2 * tol:.1e}"
        + (f"; or twice the plain version's: {[f'{v:.2e}' for v in bars]}"
           if plain_bar else "") + f") | zero lanes {zero.tolist()}")
    check(all(abs(a - c) <= it_tol for a, c in zip(ik.tolist(), ip.tolist())),
          f"{name}: iteration counts differ by more than {it_tol}")
    check(err <= rel_tol * max(scale, 1e-30), f"{name}: solutions differ")
    check(bool(torch.isfinite(xk).all()), f"{name}: non-finite solution")
    for l in range(L):
        if bool(zero[l]):
            check(bool((xk[l] == 0).all()), f"{name}: zero-RHS lane {l} not zero")
        elif bool(conv[l]):
            check(float(rmse[l]) <= bars[l],
                  f"{name}: lane {l} residual {float(rmse[l])} > {bars[l]}")
    return err, int(ik.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    return _run(torch.device("cuda"))


def _run(dev) -> int:
    """All phases on ``dev`` (the card; a CPU device only rehearses the
    control flow with the plain versions and fails the launch checks)."""
    import numpy as np
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import fluidgym_tpu_torch
        from fluidgym_tpu_torch.core.domain_io import load_domain
        from fluidgym_tpu_torch.ops import _build, cg_cuda, cg_cuda_mb
        from fluidgym_tpu_torch.solver import block_merge, linsolve, piso
        from fluidgym_tpu_torch.solver import stencil as st
        from fluidgym_tpu_torch.utils import data_utils
    except ImportError as err:
        print(f"chip_smoke: cannot import the port ({err}); run from the "
              "repository root", file=sys.stderr)
        return 2
    for mod in ("jax", "fluidgym_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---- 1: the card -----------------------------------------------------
    smi = nvidia_smi_line()
    log(f"phase 1 card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    # ---- 2: build ----------------------------------------------------------
    t = time.perf_counter()
    _build.library()
    info = _build.build_info()
    build_s = time.perf_counter() - t
    log(f"phase 2 build: {build_s:.2f}s (nvcc {info['build_seconds']}) -> "
        f"{info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # systems of the main path, from the bundled snapshot at full width
    cfg_env = fluidgym_tpu_torch.registry._entries["RBC2D-easy-v0"][1]
    dom_id = (f"rbc_2d_Ra{float(cfg_env['rayleigh_number'])}_Pr"
              f"{float(cfg_env['prandtl_number'])}_NH{cfg_env['n_heaters']}"
              f"_HW{cfg_env['resolution']}")
    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir(dom_id) / "train_00", device=dev)
    nd = topo.ndims
    dt = torch.tensor(float(cfg_env["dt"]) / 2, device=dev)
    adv_ops = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv_ops), geoms, topo)
    hbyA = st.pressure_rhs_vec(state, geoms, topo, adv_ops,
                               tuple(b.velocity for b in state.blocks),
                               state.viscosity, dt)
    div = st.divergence_of(hbyA, state, geoms, topo)
    p_rhs = -div[0]
    p_rhs = (p_rhs - p_rhs.mean()).unsqueeze(0).contiguous()
    shape = tuple(p_rhs.shape[1:])
    n = math.prod(shape)
    log(f"main-path block shape {shape} ({n} cells)")
    kernels = {}

    # ---- 3: K1 vs plain ------------------------------------------------------
    po = p_ops[0]
    mv_p = lambda v: cg_cuda.roll_matvec(po.diag[None], po.off[None], v, nd)
    kw1 = dict(ndims=nd, maxiter=5000, stall_iters=250, precondition=True,
               return_best=True)
    tol_p = 1e-5
    tol2 = cg_cuda.tol2_sum_f32(tol_p, n)

    def k1_call(b=p_rhs):
        x, inf = cg_cuda.fused_cg(po.diag, po.off, b, tol=tol_p, **kw1)
        return x, inf.iterations, inf.residual ** 2 * n

    def k1_plain(b=p_rhs):
        return cg_cuda.fused_cg_plain(po.diag[None], po.off[None], b, None,
                                      tol2_sum=tol2, **kw1)

    err1, it1 = compare("K1 pressure (1,61,96)", k1_call, k1_plain, p_rhs,
                        tol_p, 1e-3, 3, mv_p)
    # 4 lanes: different RHS scales and content, one zero RHS, tight tol so
    # the lockstep loop passes iteration 100 (true-residual refresh)
    g = torch.Generator().manual_seed(0)
    b4 = torch.randn((4,) + shape, generator=g).to(dev)
    b4[1] = b4[1] * 1e-3
    b4[2] = 0
    b4[3] = p_rhs[0]
    b4 = b4 - b4.reshape(4, -1).mean(dim=1).reshape(4, 1, 1)
    tol4 = 1e-7
    tol24 = cg_cuda.tol2_sum_f32(tol4, n)
    err4, it4 = compare(
        "K1 4 lanes (4,61,96)",
        lambda: (lambda x, inf: (x, inf.iterations, inf.residual ** 2 * n))(
            *cg_cuda.fused_cg(po.diag, po.off, b4, tol=tol4, chunk=4, **kw1)),
        lambda: cg_cuda.fused_cg_plain(po.diag[None], po.off[None], b4, None,
                                       tol2_sum=tol24, **kw1),
        b4, tol4, 1e-3, 3, mv_p)
    check(it4 > 100, f"4-lane K1 run stopped at iteration {it4} (<= 100)")
    k1_arm = "resident" if cg_cuda.default_resident(1, n, nd, 1, dev) else "global"
    k1 = arm_times(torch, cg_cuda, lambda arm: cg_cuda.launcher(
        po.diag[None], po.off[None], p_rhs, None, chunk=1, resident=arm,
        tol2_sum=tol2, **kw1), k1_call)
    k1_ms = cuda_ms(torch, lambda: k1_call(), 10)
    k1_plain_ms = cuda_ms(torch, lambda: k1_plain(), 3)
    b1, by1, s1 = bound_ms(n, 1, nd, it1, "cg", False, True)
    log(f"phase 3 K1 ok: {k1_ms:.3f} ms/solve (plain {k1_plain_ms:.3f} ms, "
        f"bound {b1 * 1e3:.3f} us by {by1}, streaming {s1 * 1e3:.3f} us) at "
        f"{it1} iterations; the rule's arm {k1_arm}; in turns, raw launch "
        f"resident {k1['raw_ms']:.3f} ms = {k1['us_per_it']:.2f} us/iteration, "
        f"chunk grid {k1['raw_ms_global']:.3f} ms = "
        f"{k1['us_per_it_global']:.2f} us/iteration "
        f"({k1['raw_ms_global'] / k1['raw_ms']:.2f}x); per wrapper call "
        f"{k1['ms']:.3f} / {k1['ms_global']:.3f} ms")
    kernels["K1"] = dict(
        name="K1 fused_cg (Jacobi-PCG, whole solve)", route="cuda",
        source="fluidgym_tpu_torch/csrc/cg.cu",
        replaces="fluidgym_tpu/ops/cg_pallas.py:143", max_abs_err=max(err1, err4),
        ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=b1, bound_by=by1,
        library_ms=None, iterations=it1, arm=k1_arm, raw_ms=k1["raw_ms"],
        us_per_it=k1["us_per_it"], raw_ms_global=k1["raw_ms_global"],
        ms_global=k1["ms_global"], in_turns=k1)

    # ---- 4: K2 vs plain ------------------------------------------------------
    plan = block_merge.trivial_plan(topo)
    kappa = state.scalar_diffusivity[0]
    sc_ops = st.build_advection_ops(state, geoms, topo, kappa, dt,
                                    for_scalar=True, scalar_channel=0)
    sc_rhs = st.advection_rhs_scalar(state, geoms, topo, kappa, dt, 0)[0][None]
    vel_rhs = st.advection_rhs_velocity(state, geoms, topo, state.viscosity, dt)[0]
    kw2 = dict(maxiter=5000, stall_iters=250, precondition=True,
               return_best=False)
    tol_a = 1e-5
    tol2a = cg_cuda.tol2_sum_f32(tol_a, n)
    k2_err, k2_ms, k2_plain_ms, k2_it, k2_arms = 0.0, {}, {}, {}, {}
    for name, ops, b, x0 in (
            ("temperature", sc_ops[0], sc_rhs, state.blocks[0].scalar),
            ("velocity", adv_ops[0], vel_rhs, state.blocks[0].velocity)):
        mv_a = lambda v, o=ops: cg_cuda.roll_matvec(o.diag[None], o.off[None], v, nd)

        def k2_call(o=ops, b=b, x0=x0):
            xs, inf = cg_cuda_mb.fused_bicgstab_mb(
                plan, (o.diag,), (o.off,), (b,), (x0,), tol=tol_a, **kw2)
            # the wrapper aggregates its info over lanes (components)
            return xs[0], inf.iterations.repeat(b.shape[0]), None

        def k2_plain(o=ops, b=b, x0=x0):
            return cg_cuda_mb.fused_bicgstab_plain(
                o.diag[None], o.off[None], b, x0, ndims=nd, tol2_sum=tol2a, **kw2)

        e, it = compare(f"K2 {name} {tuple(b.shape)}", k2_call, k2_plain, b,
                        tol_a, 1e-4, 2, mv_a)
        k2_err = max(k2_err, e)
        k2_it[name] = it
        k2_ms[name] = cuda_ms(torch, k2_call, 10)
        k2_plain_ms[name] = cuda_ms(torch, k2_plain, 3)
        k2_arms[name] = a = arm_times(
            torch, cg_cuda, lambda arm, o=ops, b=b, x0=x0: cg_cuda_mb.launcher(
                o.diag[None], o.off[None], b, x0, ndims=nd, chunk=1,
                resident=arm, tol2_sum=tol2a, **kw2), k2_call)
        log(f"  K2 {name}: {k2_ms[name]:.3f} ms/solve (plain "
            f"{k2_plain_ms[name]:.3f} ms) at {it} iterations; in turns, raw "
            f"launch resident {a['raw_ms']:.3f} ms = {a['us_per_it']:.2f} "
            f"us/iteration, chunk grid {a['raw_ms_global']:.3f} ms = "
            f"{a['us_per_it_global']:.2f} us/iteration "
            f"({a['raw_ms_global'] / a['raw_ms']:.2f}x); per wrapper call "
            f"{a['ms']:.3f} / {a['ms_global']:.3f} ms")
    b2, by2, s2 = bound_ms(n, 2, nd, k2_it["velocity"], "bicgstab", True, True)
    log(f"phase 4 K2 ok: velocity bound {b2 * 1e3:.3f} us by {by2}, "
        f"streaming {s2 * 1e3:.3f} us")
    kernels["K2"] = dict(
        name="K2 fused_bicgstab_mb (right-Jacobi BiCGStab, trivial plan)",
        route="cuda", source="fluidgym_tpu_torch/csrc/bicgstab_mb.cu",
        replaces="fluidgym_tpu/ops/cg_pallas_mb.py:458", max_abs_err=k2_err,
        ms=k2_ms["velocity"], plain_ms=k2_plain_ms["velocity"], bound_ms=b2,
        bound_by=by2, library_ms=None, iterations=k2_it["velocity"],
        shape="(2, 61, 96) velocity",
        scalar_ms=k2_ms["temperature"],
        scalar_plain_ms=k2_plain_ms["temperature"],
        arm="resident" if cg_cuda.default_resident(2, n, nd, 1, dev) else "global",
        raw_ms=k2_arms["velocity"]["raw_ms"],
        us_per_it=k2_arms["velocity"]["us_per_it"],
        raw_ms_global=k2_arms["velocity"]["raw_ms_global"],
        ms_global=k2_arms["velocity"]["ms_global"],
        in_turns=k2_arms["velocity"], scalar_in_turns=k2_arms["temperature"])

    # phase 24's main-path systems, each as launcher(arm) at one lane per block
    res_systems = [
        ("K1 pressure (1, 61, 96)", lambda arm: cg_cuda.launcher(
            po.diag[None], po.off[None], p_rhs, None, chunk=1, resident=arm,
            tol2_sum=tol2, **kw1)),
        ("K1 4 lanes past the refresh", lambda arm: cg_cuda.launcher(
            po.diag[None], po.off[None], b4, None, chunk=1, resident=arm,
            tol2_sum=tol24, **kw1))]
    for name, ops, b, x0 in (
            ("temperature", sc_ops[0], sc_rhs, state.blocks[0].scalar),
            ("velocity", adv_ops[0], vel_rhs, state.blocks[0].velocity)):
        res_systems.append((
            f"K2 {name} {tuple(b.shape)} warm",
            lambda arm, o=ops, b=b, x0=x0: cg_cuda_mb.launcher(
                o.diag[None], o.off[None], b, x0, ndims=nd, chunk=1,
                resident=arm, tol2_sum=tol2a, **kw2)))

    # ---- 5: the main path ------------------------------------------------------
    calls, restore = count_calls(piso, linsolve)
    cg_cuda.fused_cg.launches = 0
    cg_cuda_mb.fused_bicgstab_mb.launches = 0
    cg_cuda.fused_cg.resident_launches = 0
    cg_cuda_mb.fused_bicgstab_mb.resident_launches = 0
    cg_cuda.fused_cg_plain.calls = 0
    cg_cuda_mb.fused_bicgstab_plain.calls = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    env = fluidgym_tpu_torch.make("RBC2D-easy-v0")
    obs, _ = env.reset(seed=0)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t
    reset_launches = {"K1": cg_cuda.fused_cg.launches,
                      "K2": cg_cuda_mb.fused_bicgstab_mb.launches}
    reset_substeps = calls["piso_substep_info"]
    rng = np.random.default_rng(0)
    actions = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
               for _ in range(3)]
    step_s = []
    nus = []
    for a in actions:
        t = time.perf_counter()
        obs, reward, term, trunc, info = env.step(a)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        nu = float(info["nusselt"])
        nus.append(nu)
        for k, v in obs.items():
            check(tuple(v.shape) == env.observation_space[k].shape,
                  f"obs {k} shape {tuple(v.shape)}")
            check(bool(torch.isfinite(v).all()), f"obs {k} not finite")
        check(bool(torch.isfinite(reward).all()), "reward not finite")
        check(math.isfinite(nu) and nu > 0, f"Nusselt {nu} not finite/positive")
        check(bool(info["pressure_converged"]), "a pressure solve did not converge")
    launches = {"K1": cg_cuda.fused_cg.launches,
                "K2": cg_cuda_mb.fused_bicgstab_mb.launches}
    resident = {"K1": cg_cuda.fused_cg.resident_launches,
                "K2": cg_cuda_mb.fused_bicgstab_mb.resident_launches}
    plain_calls = (cg_cuda.fused_cg_plain.calls
                   + cg_cuda_mb.fused_bicgstab_plain.calls)
    restore()
    check(resident == launches,
          f"not every K1 / K2 launch took the resident arm: {resident} of "
          f"{launches}")
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"a kernel of the main path was not launched: {launches}")
    check(plain_calls == 0, f"plain versions ran {plain_calls} times on the main path")
    check(calls["cg"] + calls["bicgstab"] == 0,
          f"linsolve's plain loops ran on the main path: {calls}")
    # every step substep: one K1 launch per pressure corrector, one K2 launch
    # per scalar channel and one for the velocity prediction
    n_sub = calls["piso_substep_info"] - reset_substeps
    expect = {"K1": env._cfg.corrector_steps * n_sub,
              "K2": (env._topo.scalar_channels + 1) * n_sub}
    step_launches = {k: launches[k] - reset_launches[k] for k in launches}
    check(n_sub > 0 and step_launches == expect,
          f"launches over the steps {step_launches} != {expect} for {n_sub} "
          "substeps")
    per_step = {k: step_launches[k] / len(actions) for k in launches}
    substeps = n_sub / len(actions)
    ms_step = 1e3 * sum(step_s) / len(step_s)
    log(f"phase 5 main path ok: RBC2D-easy-v0 {env._topo.blocks[0].shape} "
        f"reset {reset_s:.2f}s, steps {[round(s, 3) for s in step_s]} s, "
        f"{ms_step:.1f} ms/env step, {substeps:.1f} substeps/step "
        f"({env.n_sim_steps} sim steps of dt {env.dt}), Nusselt "
        f"{[round(v, 5) for v in nus]}, launches {launches} (reset "
        f"{reset_launches}; on the resident arm {resident}), plain calls "
        f"{plain_calls}, linsolve calls "
        f"{calls['cg'] + calls['bicgstab']}; per solve K1 {k1_ms:.3f} ms vs plain "
        f"{k1_plain_ms:.3f} ms, K2 {k2_ms['velocity']:.3f} ms vs plain "
        f"{k2_plain_ms['velocity']:.3f} ms")
    for k in ("K1", "K2"):
        kernels[k]["launches"] = launches[k]
        kernels[k]["launches_per_env_step"] = per_step[k]

    # ---- 6: card against host (kernels against plain versions, end to end)
    small = dict(n_heaters=4, resolution=4, load_initial_domain=False,
                 load_domain_statistics=False, randomize_initial_state=False,
                 episode_length=5, step_length=0.1, dt=0.05, local_obs_window=3)
    full = dict(randomize_initial_state=False, episode_length=2)
    for label, kw, n_steps, seed in (("small (10, 16)", small, 3, 1),
                                     ("full width (61, 96)", full, 1, 0)):
        t = time.perf_counter()
        outs = {}
        for where in (dev, torch.device("cpu")):
            e = fluidgym_tpu_torch.make("RBC2D-easy-v0", device=where, **kw)
            e.reset(seed=seed)
            seq = []
            for i in range(n_steps):
                a = np.full(e.action_space.shape, 0.3 * (i - 1), np.float32)
                a[0] = 0.5
                o, r, *_ = e.step(a)
                seq.append((o, r))
            outs[where.type] = seq
        worst = 0.0
        for (og, rg), (oc, rc) in zip(outs[dev.type], outs["cpu"]):
            pairs = [(og[k].cpu(), oc[k]) for k in og] + [(rg.cpu(), rc)]
            for g_, c_ in pairs:
                worst = max(worst, float((g_ - c_).abs().max()
                                         / c_.abs().max().clamp(min=1e-30)))
        log(f"phase 6 {label}, {n_steps} step(s), card vs host: worst "
            f"relative obs/reward diff {worst:.2e} (bar 1e-4) in "
            f"{time.perf_counter() - t:.2f}s")
        check(worst <= 1e-4, f"card and host disagree on the {label} config")

    for case in MERGED_CASES:
        _merged_phases(dev, kernels, compare, piso, linsolve, case)

    _k4_phase(dev, kernels, piso)
    for case in MERGED_CASES:
        _coarse_phase(dev, kernels, compare, piso, case)
    _strips_main_path(dev, kernels, piso, linsolve)
    _strips_card_vs_host(dev, piso)

    with warnings.catch_warnings():
        # vmap's per-lane fallback must not hide anywhere in the batch phases
        warnings.filterwarnings("error", message=".*performance drop.*")
        roll = _chunk_phase(dev, kernels, piso,
                            dict(po=po, adv=adv_ops[0], topo=topo))
        results = [_batched_phase(dev, kernels, piso, linsolve, case)
                   for case in BATCH_CASES]
    _throughput_phase(kernels, results)
    log(f"phase 22 summary {json.dumps(kernels.pop('batched'))}")
    for case in MERGED_CASES:
        _cluster_phase(dev, kernels, piso, case)
    for name, f in roll.items():
        res_systems += [(f"{name} {Ln} lanes", lambda arm, f=f, Ln=Ln:
                         f["roll_launcher"](Ln, arm)) for Ln in (64, CHUNK_LANES)]
    _resident_phase(kernels, res_systems)
    _rbc_phases(dev, kernels, compare, piso, linsolve)
    _cyl3d_phases(dev, kernels, compare, piso, linsolve)
    _blend_phases(dev, kernels, piso, linsolve)
    _agg_phases(dev, kernels, piso, linsolve)
    _tcf_phases(dev, kernels, compare, piso, linsolve)
    _airfoil3d_phases(dev, kernels, piso, linsolve)
    _diff_phases(dev, kernels, piso, linsolve)
    _rl_surface_phases(dev, kernels, piso, linsolve)

    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernels[k] for k in (
        "K1", "K2", "K2-mb", "K3", "K3-flip", "K2-mb-flip", "K4", "K3-coarse",
        "K3-coarse-flip", "K1 lanes", "K2 lanes", "K3 lanes", "K2-mb lanes",
        "K1-3D", "K2-3D", "K3-3D", "K2-mb-3D", "K3-agg-flip", "K3-3D-flip",
        "K2-mb-3D-flip")]}),
        flush=True)
    log(f"total {time.perf_counter() - T0:.1f}s (build {build_s:.1f}s)")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


#: the merged-frame main paths: phases 7-10 (the cylinder's identity seams)
#: and 11-13 (the airfoil's C-grid, whose wake cut is a reflected seam)
MERGED_CASES = (
    dict(env_id="CylinderJet2D-easy-v0", snapshot=("cylinder_2D_Re100_Res24",
                                                   "test_00"),
         phases=(7, 8, 9, 10), plan=(2, 2, 0), cells=(5, 14232),
         k3="K3", k3_count="launches", k2="K2-mb", k2_count="merged_launches",
         k3c="K3-coarse", k3c_count="coarse_launches", coarse_phase=15,
         k3c_lanes_tol=3e-7, k3c_steps=3, main_steps=3,
         k3_form="", k2_form="", dt=0.01, tol_p=1e-5, k3_it_tol=3,
         k2_it_tol=2, lanes3=True, plain_reps=3, make_kw={},
         host_kw=dict(randomize_initial_state=False), host_pressure_bar=1e-4),
    dict(env_id="Airfoil2D-easy-v0", snapshot=("airfoil_2D_Re1000", "train_00"),
         phases=(11, 11, 12, 13), plan=(3, 6, 2), cells=(6, 73456),
         k3="K3-flip", k3_count="flip_launches", k2="K2-mb-flip",
         k3c="K3-coarse-flip", k3c_count="coarse_flip_launches",
         coarse_phase=16, k3c_lanes_tol=None, k3c_steps=1, main_steps=1,
         k2_count="merged_flip_launches", k3_form=" with reflected seams",
         k2_form=" with reflected seams", dt=0.05, tol_p=1e-7, k3_it_tol=0,
         k2_it_tol=0, lanes3=False, plain_reps=1,
         make_kw=dict(randomize_initial_state=False),
         # one sim step; reward = cl/cd without the statistics' cl_cd_ref,
         # whose difference of near-equal numbers would amplify rounding
         host_kw=dict(randomize_initial_state=False,
                      load_domain_statistics=False, step_length=0.05,
                      dt=0.05),
         # a float32 airfoil pressure obs is decided by rounding at ~1e-4
         # (substeps of ~0.003 put O(u/dt) terms into the divergence that
         # cancel): on the host alone, 1 vs 8 threads moves it 2e-5 (7e-5
         # at tol 1e-8) and float32 vs float64 8.9e-5..1.1e-4, and the JAX
         # package's own float32 runs are 6.6e-5..3.8e-3 off its float64
         # run; 1e-3 still catches a wrong seam, which moves it O(1)
         host_pressure_bar=1e-3),
)


def _snapshot_system(dev, piso, case) -> dict:
    """The bundled snapshot of a merged case and the pressure system of one
    main-path substep (the sim step cut to CFL 0.8): operators, the
    mean-free RHS and the deflated warm start from the snapshot's
    pressure."""
    import torch

    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.solver import block_merge
    from fluidgym_tpu_torch.solver import stencil as st
    from fluidgym_tpu_torch.utils import data_utils

    data_id, split = case["snapshot"]
    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir(data_id) / split, device=dev)
    plan = block_merge.merge_plan(topo)
    n_flip = sum(any(fx.flip) for fx in plan.fixups)
    check((len(plan.superblocks), len(plan.fixups), n_flip) == case["plan"],
          f"the {case['env_id']} merge plan is not (super-blocks, fixups, "
          f"flips) = {case['plan']}")
    n = sum(math.prod(sb.shape) for sb in plan.superblocks)
    seam = sum(math.prod(hi - lo for K, (lo, hi) in enumerate(fx.window)
                         if K != fx.face // 2) for fx in plan.fixups)
    cfg = piso.SimConfig(dt=case["dt"], adaptive_cfl=0.8, differentiable=False)
    dt = piso._cfl_ts(state, geoms, topo, cfg,
                      torch.tensor(case["dt"], device=dev))
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    hbyA = st.pressure_rhs_vec(state, geoms, topo, adv,
                               tuple(b.velocity for b in state.blocks),
                               state.viscosity, dt)
    rhs = tuple(-d for d in st.divergence_of(hbyA, state, geoms, topo))
    mean = sum(r.sum() for r in rhs) / n
    rhs = tuple(r - mean for r in rhs)
    guess = piso._make_deflation_x0(p_ops, topo, torch.float32)(
        rhs, base=tuple(b.pressure for b in state.blocks))
    return dict(topo=topo, geoms=geoms, state=state, plan=plan, n=n, seam=seam,
                dt=dt, adv=adv, p_ops=p_ops, rhs=rhs, guess=guess)


def _merged_phases(dev, kernels, compare, piso, linsolve, case) -> None:
    """K3 and K2-mb of one merged plan against their plain versions on the
    systems of a bundled snapshot at full width, the main path of its id
    with launch counts per form, and the card against the host."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge
    from fluidgym_tpu_torch.solver import stencil as st

    env_id, k3n, k2n = case["env_id"], case["k3"], case["k2"]
    ph3, ph2, ph_main, ph_host = case["phases"]
    sy = _snapshot_system(dev, piso, case)
    topo, geoms, state, plan, n, seam = (
        sy[k] for k in ("topo", "geoms", "state", "plan", "n", "seam"))
    dt, adv, p_ops, rhs, guess = (sy[k] for k in ("dt", "adv", "p_ops", "rhs",
                                                  "guess"))
    n_flip = sum(any(fx.flip) for fx in plan.fixups)
    nd = topo.ndims
    S = len(plan.superblocks)
    log(f"{env_id} snapshot: blocks {[b.shape for b in topo.blocks]} -> "
        f"super-blocks {[sb.shape for sb in plan.superblocks]}, {n} cells, "
        f"{len(plan.fixups)} fixups ({n_flip} flips, {seam} seam cells)")

    # ---- K3 vs plain on the snapshot's pressure system --------------------
    mops = block_merge.pack_ops(plan, p_ops)
    diags, offs = tuple(m[0] for m in mops), tuple(m[1] for m in mops)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    mv3 = cg_cuda_mb._merged_mv(plan, diag, off)
    tol_p = case["tol_p"]  # the env's pressure tolerance
    kw3 = dict(maxiter=5000, stall_iters=250, precondition=True,
               return_best=True)

    def k3_pair(bs, x0s, tol):
        def kern():
            xs, inf = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s,
                                             tol=tol, chunk=bs[0].shape[0],
                                             **kw3)
            return (cg_cuda_mb.flatten_fields(plan, xs), inf.iterations,
                    inf.residual ** 2 * n)

        def plain():
            return cg_cuda_mb.fused_cg_mb_plain(
                plan, diag, off, cg_cuda_mb.flatten_fields(plan, bs),
                None if x0s is None else cg_cuda_mb.flatten_fields(plan, x0s),
                tol2_sum=cg_cuda.tol2_sum_f32(tol, n), **kw3)
        return kern, plain

    b1 = tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, rhs))
    g1 = tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, guess))
    flat1 = cg_cuda_mb.flatten_fields(plan, b1)
    errs, its = [], {}
    for label, x0s in (("cold", None), ("warm (deflated guess)", g1)):
        kern, plain = k3_pair(b1, x0s, tol_p)
        e, it = compare(f"{k3n} pressure {label} (1, {n})", kern, plain, flat1,
                        tol_p, 1e-3, case["k3_it_tol"], mv3)
        errs.append(e)
        its[label] = it
    if case["lanes3"]:
        # 3 lanes: different RHS scales and content, one zero RHS, tight tol
        # so the lockstep loop passes iteration 100 (true-residual refresh)
        g = torch.Generator().manual_seed(3)
        lanes3 = [torch.randn(n, generator=g).to(dev), 1e-3 * flat1[0],
                  torch.zeros(n, device=dev)]
        lanes3[0] = lanes3[0] - lanes3[0].mean()
        flat3 = torch.stack(lanes3)
        kern, plain = k3_pair(cg_cuda_mb.unflatten_fields(plan, flat3), None,
                              1e-7)
        e3, it3 = compare(f"{k3n} 3 lanes (3, {n})", kern, plain, flat3, 1e-7,
                          1e-3, case["k3_it_tol"], mv3)
        check(it3 > 100, f"3-lane {k3n} run stopped at iteration {it3} (<= 100)")
        errs.append(e3)
    kern, plain = k3_pair(b1, g1, tol_p)
    k3_ms = cuda_ms(torch, kern, 10)
    k3_plain_ms = cuda_ms(torch, plain, case["plain_reps"])
    warm_it = its["warm (deflated guess)"]
    b_3, by3, s3 = bound_ms(n, 1, nd, warm_it, "cg", True, True, seam)
    log(f"phase {ph3} {k3n} ok: {k3_ms:.3f} ms/solve warm (plain "
        f"{k3_plain_ms:.3f} ms, bound {b_3 * 1e3:.3f} us by {by3}, streaming "
        f"{s3 * 1e3:.3f} us) at {warm_it} iterations (cold: {its['cold']}), "
        f"{k3_ms * 1e3 / max(warm_it, 1):.1f} us/iteration, substep dt "
        f"{float(dt):.5f}")
    kernels[k3n] = dict(
        name=f"{k3n} fused_cg_mb (Jacobi-PCG, merged frame{case['k3_form']}, "
             "whole solve)",
        route="cuda", source="fluidgym_tpu_torch/csrc/cg.cu",
        replaces="fluidgym_tpu/ops/cg_pallas_mb.py:284", max_abs_err=max(errs),
        ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=b_3, bound_by=by3,
        library_ms=None, iterations=warm_it, cold_iterations=its["cold"],
        shape=f"(1, {n}) pressure, {S} super-blocks, {n_flip} flip seams")

    # ---- K2-mb vs plain on the snapshot's velocity advection system -------
    amops = block_merge.pack_ops(plan, adv)
    adiags, aoffs = tuple(m[0] for m in amops), tuple(m[1] for m in amops)
    adiag, aoff = cg_cuda_mb.flatten_ops(plan, adiags, aoffs)
    vel_rhs = st.advection_rhs_velocity(state, geoms, topo, state.viscosity, dt)

    def pack2(fields):
        per_c = [block_merge.pack_fields(plan, tuple(f[c] for f in fields))
                 for c in range(2)]
        return tuple(torch.stack([per_c[c][s_] for c in range(2)])
                     for s_ in range(S))

    bv = pack2(vel_rhs)
    xv = pack2(tuple(b.velocity for b in state.blocks))
    flatv = cg_cuda_mb.flatten_fields(plan, bv)
    # the float64 true residual of a float32 solution has a floor of
    # ~eps * |A x| (diag ~ 1/dt): 1.4e-5 on the airfoil, next to 2 * tol
    tol_a = 1e-5
    kw2 = dict(maxiter=5000, stall_iters=250, precondition=True,
               return_best=False)

    def k2_call():
        xs, inf = cg_cuda_mb.fused_bicgstab_mb(plan, adiags, aoffs, bv, xv,
                                               tol=tol_a, **kw2)
        return cg_cuda_mb.flatten_fields(plan, xs), inf.iterations.repeat(2), None

    def k2_plain():
        return cg_cuda_mb.fused_bicgstab_plain(
            adiag, aoff, flatv, cg_cuda_mb.flatten_fields(plan, xv), ndims=nd,
            plan=plan, tol2_sum=cg_cuda.tol2_sum_f32(tol_a, n), **kw2)

    e2, it2 = compare(f"{k2n} velocity (2, {n})", k2_call, k2_plain, flatv,
                      tol_a, 1e-4, case["k2_it_tol"],
                      cg_cuda_mb._merged_mv(plan, adiag, aoff))
    k2_ms = cuda_ms(torch, k2_call, 10)
    k2_plain_ms = cuda_ms(torch, k2_plain, case["plain_reps"])
    b_2, by2, s2 = bound_ms(n, 2, nd, it2, "bicgstab", True, True, seam)
    log(f"phase {ph2} {k2n} ok: {k2_ms:.3f} ms/solve (plain {k2_plain_ms:.3f} "
        f"ms, bound {b_2 * 1e3:.3f} us by {by2}, streaming {s2 * 1e3:.3f} us) "
        f"at {it2} iterations")
    kernels[k2n] = dict(
        name=f"{k2n} fused_bicgstab_mb (right-Jacobi BiCGStab, merged "
             f"plan{case['k2_form']})",
        route="cuda", source="fluidgym_tpu_torch/csrc/bicgstab_mb.cu",
        replaces="fluidgym_tpu/ops/cg_pallas_mb.py:458", max_abs_err=e2,
        ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=b_2, bound_by=by2,
        library_ms=None, iterations=it2,
        shape=f"(2, {n}) velocity, {S} super-blocks, {n_flip} flip seams")

    # ---- the main path -------------------------------------------------------
    calls, restore = count_calls(piso, linsolve)
    k3w, k2w = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    forms = ((k3w, "launches"), (k3w, "flip_launches"), (k2w, "launches"),
             (k2w, "merged_launches"), (k2w, "merged_flip_launches"),
             (cg_cuda.fused_cg, "launches"))
    plains = (cg_cuda.fused_cg_plain, cg_cuda_mb.fused_cg_mb_plain,
              cg_cuda_mb.fused_bicgstab_plain)

    def counts():
        out = {k3n: getattr(k3w, case["k3_count"]),
               k2n: getattr(k2w, case["k2_count"])}
        out["other"] = sum(getattr(w, a) for w, a in forms) - out[k3n] - out[k2n]
        out["cluster"] = k3w.cluster_launches + k2w.cluster_launches
        out["plain"] = sum(f.calls for f in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        return out

    for w, a in forms + ((k3w, "cluster_launches"), (k2w, "cluster_launches")):
        setattr(w, a, 0)
    for f in plains:
        f.calls = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        env = fluidgym_tpu_torch.make(env_id, **case["make_kw"])
        obs, _ = env.reset(seed=0)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        reset_counts = counts()
        nb = [b.shape for b in env._topo.blocks]
        check((len(nb), sum(math.prod(s_) for s_ in nb)) == case["cells"],
              f"the {env_id} main path is not the registered width: {nb}")
        rng = np.random.default_rng(0)
        actions = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
                   for _ in range(case["main_steps"])]
        step_s, per_step, drags, lifts, p_its = [], [], [], [], []
        for a in actions:
            c0 = counts()
            t = time.perf_counter()
            obs, reward, term, trunc, info = env.step(a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            c1 = counts()
            d = {k: c1[k] - c0[k] for k in c1}
            per_step.append(d)
            check(d["substeps"] > 0 and d[k3n] == 2 * d["substeps"]
                  and d[k2n] == d["substeps"] and d["other"] == 0,
                  f"{env_id} step launches {d}: expected {k3n} = 2 x "
                  f"substeps, {k2n} = substeps, no other kernel form")
            check(d["plain"] == 0, f"plain versions ran on the main path: {d}")
            check(d["linsolve"] == 0, f"linsolve's loops ran on the main path: {d}")
            # the single env's solves take the cluster arm, every one
            check(d["cluster"] == d[k3n] + d[k2n],
                  f"{env_id} step launches {d}: not every {k3n} / {k2n} "
                  "launch took the cluster arm")
            for k, v in obs.items():
                check(tuple(v.shape) == env.observation_space[k].shape,
                      f"obs {k} shape {tuple(v.shape)}")
                check(bool(torch.isfinite(v).all()), f"obs {k} not finite")
            check(bool(torch.isfinite(reward).all()), "reward not finite")
            drags.append(float(info["drag"]))
            lifts.append(float(info["lift"]))
            p_its.append(int(info["pressure_iterations"]))
            check(math.isfinite(drags[-1]) and math.isfinite(lifts[-1]),
                  "drag/lift not finite")
    finally:
        restore()
    total = counts()
    check(total[k3n] > 0 and total[k2n] > 0,
          f"a kernel of the {env_id} path was not launched: {total}")
    check(total["plain"] == 0 and total["linsolve"] == 0 and total["other"] == 0,
          f"another solver ran on the {env_id} path: {total}")
    check(total["cluster"] == total[k3n] + total[k2n],
          f"not every {env_id} solve took the cluster arm: {total}")
    n_steps = len(actions)
    sub = sum(d["substeps"] for d in per_step)
    ms_step = 1e3 * sum(step_s) / n_steps
    log(f"phase {ph_main} main path ok: {env_id} blocks {nb} reset "
        f"{reset_s:.2f}s ({reset_counts}), steps {[round(x, 3) for x in step_s]} s, "
        f"{ms_step:.1f} ms/env step, {sub / n_steps:.1f} substeps/step "
        f"({env.n_sim_steps} sim steps of dt {env.dt}), pressure iterations "
        f"per step {p_its}, drag {[round(x, 5) for x in drags]}, lift "
        f"{[round(x, 5) for x in lifts]}, per-step launches {per_step}, "
        f"totals {total}")
    for k in (k3n, k2n):
        kernels[k]["launches"] = total[k]
        kernels[k]["cluster_launches"] = total[k]
        kernels[k]["launches_per_env_step"] = sum(d[k] for d in per_step) / n_steps
        kernels[k]["ms_per_env_step"] = ms_step
    kernels[k3n]["step_ms"] = [1e3 * x for x in step_s]
    kernels[k3n]["pressure_iterations_per_step"] = p_its
    kernels[k3n]["substeps_per_step"] = [d["substeps"] for d in per_step]

    # ---- the card against the host ---------------------------------------
    t = time.perf_counter()
    outs = {}
    for where in (dev, torch.device("cpu")):
        e = fluidgym_tpu_torch.make(env_id, device=where, **case["host_kw"])
        e.reset(seed=0)
        a = np.linspace(0.4, -0.4, e.action_space.shape[0]).astype(np.float32)
        o, r, *_ = e.step(a)
        outs[where.type] = dict(o, reward=r)
    og, oc = outs[dev.type], outs["cpu"]
    diffs = {k: float((og[k].cpu() - oc[k]).abs().max()
                      / oc[k].abs().max().clamp(min=1e-30)) for k in og}
    p_bar = case["host_pressure_bar"]
    log(f"phase {ph_host} {env_id} full width, 1 step from the bundled "
        f"snapshot ({e.n_sim_steps} sim steps), card vs host: relative diffs "
        f"{diffs} (bar 1e-4; pressure obs {p_bar:g}) in "
        f"{time.perf_counter() - t:.2f}s")
    check(all(v <= (p_bar if k == "pressure" else 1e-4) for k, v in diffs.items()),
          f"card and host disagree on {env_id}")


def k4_bound_ms(ny: int, nx: int, cols: int) -> tuple[float, str]:
    """Least time of one K4 launch on an H100: diag and 4 off read once,
    x and the 4 halo layers read and y written once per column; 9 fp32
    operations per output cell."""
    n = ny * nx
    t_bytes = 4 * (5 * n + cols * (2 * n + 2 * (ny + nx))) / H100_BYTES_PER_S * 1e3
    t_ops = 9.0 * cols * n / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _k4_phase(dev, kernels, piso) -> None:
    """Phase 14: K4 against its plain version on every block of the two
    snapshots' pressure operators, as the main path calls it: scalar
    fields (the warm-start gate, twice per substep) and the deflation
    basis in column form (the coarse setup, once per substep)."""
    import torch

    from fluidgym_tpu_torch.ops import stencil_cuda
    from fluidgym_tpu_torch.solver import stencil as st

    rows, worst, worst_abs, exact = {}, 0.0, 0.0, True
    for case in MERGED_CASES:
        sy = _snapshot_system(dev, piso, case)
        topo, p_ops = sy["topo"], sy["p_ops"]
        g = torch.Generator().manual_seed(14)
        scalar = tuple(torch.randn(tuple(o.diag.shape), generator=g).to(dev)
                       for o in p_ops)
        columns = tuple(piso._deflation_basis(topo, torch.float32, dev))
        for form, xs in (("scalar", scalar), ("columns", columns)):
            halos = [tuple(st._halo_layer(xs, b, f, topo).contiguous()
                           for f in range(4)) for b in range(len(xs))]

            def run(fn, xs=xs, halos=halos):
                return [fn(o.diag, o.off, x, h)
                        for o, x, h in zip(p_ops, xs, halos)]

            yk = run(stencil_cuda.stencil_apply)
            yp = run(stencil_cuda.stencil_apply_plain)
            torch.cuda.synchronize()
            for a, b in zip(yk, yp):
                d = float((a - b).abs().max())
                worst_abs = max(worst_abs, d)
                worst = max(worst, d / max(float(b.abs().max()), 1e-30))
                exact = exact and bool(torch.equal(a, b))
            nb = len(xs)
            cols = 1 if form == "scalar" else xs[0].shape[0]
            bounds = [k4_bound_ms(*o.diag.shape, cols) for o in p_ops]
            rows[(case["env_id"], form)] = dict(
                ms=cuda_ms(torch, lambda: run(stencil_cuda.stencil_apply), 50) / nb,
                plain_ms=cuda_ms(torch, lambda: run(stencil_cuda.stencil_apply_plain),
                                 20) / nb,
                bound_ms=sum(b for b, _ in bounds) / nb, bound_by=bounds[0][1],
                cols=cols)
            r = rows[(case["env_id"], form)]
            log(f"  K4 {case['env_id']} {form} ({nb} blocks, {cols} column(s)): "
                f"{r['ms'] * 1e3:.2f} us/launch (plain {r['plain_ms'] * 1e3:.2f} "
                f"us, bound {r['bound_ms'] * 1e3:.4f} us by {r['bound_by']})")
    log(f"phase 14 K4 ok: max|dy| {worst_abs:.3e} ({worst:.2e} of max|y|, bar "
        f"1e-6 relative), bit-equal to the plain version: {exact}")
    check(worst <= 1e-6, f"K4 differs from its plain version by {worst:.3e}")
    # one cylinder substep: per block 1 column-form and 2 scalar launches
    cyl = MERGED_CASES[0]["env_id"]
    mix = lambda key: (rows[(cyl, "columns")][key]
                       + 2 * rows[(cyl, "scalar")][key]) / 3
    kernels["K4"] = dict(
        name="K4 stencil_apply (fused 2D stencil apply of one block)",
        route="cuda", source="fluidgym_tpu_torch/csrc/stencil.cu",
        replaces="fluidgym_tpu/ops/stencil_pallas.py:77", max_abs_err=worst_abs,
        bit_equal=exact, ms=mix("ms"), plain_ms=mix("plain_ms"),
        bound_ms=mix("bound_ms"), bound_by=rows[(cyl, "scalar")]["bound_by"],
        library_ms=None,
        shape="per launch, mean over one cylinder substep's mix",
        forms={f"{k[0]} {k[1]}": v for k, v in rows.items()})


def _coarse_phase(dev, kernels, compare, piso, case) -> None:
    """Phases 15-16: K3-coarse (identity seams, the cylinder) and
    K3-coarse-flip (the airfoil) against their plain versions on the
    snapshot's full-width pressure system: cold, warm from the deflated
    guess and (cylinder) a 3-lane run past iteration 100; the same
    converged flags and iterations within 2.  Each run also at the cluster
    rule's C (one lane per cluster; the 1-lane runs go through the wrapper
    at it) against C = 1, bit for bit (x, iterations, residual).  Also the
    Jacobi-only K3 iterations on the same systems, and the warm solve's raw
    launch at C = 1 and at the rule's C in turns."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge, coarse_strips

    name, ph = case["k3c"], case["coarse_phase"]
    sy = _snapshot_system(dev, piso, case)
    plan, n, seam, rhs, guess = (sy[k] for k in ("plan", "n", "seam", "rhs",
                                                  "guess"))
    sp = coarse_strips.strip_plan(plan)
    mops = block_merge.pack_ops(plan, sy["p_ops"])
    diags, offs = tuple(m[0] for m in mops), tuple(m[1] for m in mops)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    einv = coarse_strips.coarse_inverse(plan, sp, mops)[None]
    mv = cg_cuda_mb._merged_mv(plan, diag, off)
    kw = dict(maxiter=5000, stall_iters=250, precondition=True, return_best=True)
    flat = lambda xs: None if xs is None else cg_cuda_mb.flatten_fields(plan, xs)

    def pair(bs, x0s, tol, flags):
        def kern():
            xs, inf = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s, tol=tol,
                                             coarse_strips=True,
                                             chunk=bs[0].shape[0], **kw)
            flags["kernel"] = inf.converged.reshape(-1).cpu()
            return flat(xs), inf.iterations, inf.residual ** 2 * n

        def plain():
            x, it, rs = cg_cuda_mb.fused_cg_mb_plain(
                plan, diag, off, flat(bs), flat(x0s),
                tol2_sum=cg_cuda.tol2_sum_f32(tol, n), coarse=(sp, einv), **kw)
            zero = (flat(bs) == 0).all(dim=1)
            flags["plain"] = ((rs <= cg_cuda.tol2_sum_f32(tol, n)) | zero).cpu()
            return x, it, rs

        def jacobi():
            _, inf = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s, tol=tol,
                                            chunk=bs[0].shape[0], **kw)
            return int(inf.iterations.max())
        return kern, plain, jacobi

    b1 = tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, rhs))
    g1 = tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, guess))
    runs = [("cold", b1, None, case["tol_p"]),
            ("warm (deflated guess)", b1, g1, case["tol_p"])]
    if case["k3c_lanes_tol"]:
        # 3 lanes: different RHS scales and content, one zero RHS, tolerance
        # tight enough to pass the iteration-100 true-residual refresh; the
        # first lane is A x for a random x (a mean-free random RHS sits at
        # float32's floor for 3e-7: there the strips stall where Jacobi
        # alone needs 361 iterations)
        g = torch.Generator().manual_seed(3)
        flat1 = flat(b1)
        lane0 = mv(torch.randn((1, n), generator=g).to(dev))[0]
        flat3 = torch.stack([lane0, 1e-3 * flat1[0], torch.zeros(n, device=dev)])
        runs.append(("3 lanes", cg_cuda_mb.unflatten_fields(plan, flat3), None,
                     case["k3c_lanes_tol"]))
    def raw(bs, x0s, tol, C, coarse=(sp, einv)):
        """A raw launch on preallocated buffers at C (one lane per block or
        per cluster)."""
        return cg_cuda_mb.merged_launcher(
            "cg", plan, diag, off, flat(bs), flat(x0s),
            tol2_sum=cg_cuda.tol2_sum_f32(tol, n), coarse=coarse, chunk=1,
            cluster=C, **kw)

    rule = cg_cuda_mb.merged_arm(1, n, 2, 1, dev, "cg_coarse")[0]
    errs, its, jac, bits = [], {}, {}, {}
    for label, bs, x0s, tol in runs:
        flags = {}
        kern, plain, jacobi = pair(bs, x0s, tol, flags)
        lanes = bs[0].shape[0]
        cl0 = cg_cuda_mb.fused_cg_mb.cluster_launches
        e, it = compare(f"{name} {label} ({lanes}, {n})", kern, plain,
                        flat(bs), tol, 1e-3, 2, mv)
        check(torch.equal(flags["kernel"], flags["plain"]),
              f"{name} {label}: converged flags {flags}")
        if lanes == 1:
            check(cg_cuda_mb.fused_cg_mb.cluster_launches == cl0 + int(rule > 1),
                  f"{name} {label}: the wrapper did not take the cluster arm")
        errs.append(e)
        its[label] = it
        jac[label] = jacobi()
        if label == "3 lanes":
            check(it > 100, f"3-lane {name} run stopped at iteration {it} (<= 100)")
        # the cluster arm against the chunk grid, one lane per cluster
        rule_l = cg_cuda_mb.merged_arm(lanes, n, 2, 1, dev, "cg_coarse")[0]
        outs = {C: tuple(t.clone() for t in raw(bs, x0s, tol, C)())
                for C in (1, rule_l)}
        torch.cuda.synchronize()
        bits[label] = dict(cluster=rule_l, iterations=outs[1][1].tolist(),
                           bit_equal=all(torch.equal(u, v) for u, v in
                                         zip(outs[1], outs[rule_l])))
        check(bits[label]["bit_equal"], f"{name} {label}: C={rule_l} is not "
              f"bit-equal to C=1 (iterations {outs[rule_l][1].tolist()} vs "
              f"{outs[1][1].tolist()})")
    kern, plain, _ = pair(b1, g1, case["tol_p"], {})
    ms = cuda_ms(torch, kern, 10)
    plain_ms = cuda_ms(torch, plain, case["plain_reps"])
    # the wrapper's two parts: the coarse inverse from the operator (every
    # call, as in the JAX package) and the kernel launch itself, at C = 1
    # and at the rule's C in turns
    einv_ms = cuda_ms(torch, lambda: coarse_strips.coarse_inverse(plan, sp, mops), 10)
    launches = {C: raw(b1, g1, case["tol_p"], C) for C in (1, rule)}
    t = dict.fromkeys(launches, 0.0)
    for C in (1, rule, rule, 1):
        t[C] += cuda_ms(torch, launches[C], 10) / 2
    launch_ms, launch_ms_1 = t[rule], t[1]
    k3_rule = cg_cuda_mb.default_cluster(1, n, 2, 1, dev)
    jacobi_launch_ms = cuda_ms(torch, raw(b1, g1, case["tol_p"], k3_rule,
                                          coarse=None), 10)
    warm_it = its["warm (deflated guess)"]
    us = lambda v, it: v * 1e3 / max(it, 1)
    b, by, stream = bound_ms(n, 1, 2, warm_it, "cg", True, True, seam, sp.K)
    log(f"phase {ph} {name} ok: {ms:.3f} ms/solve warm (plain {plain_ms:.3f} ms, "
        f"bound {b * 1e3:.3f} us by {by}, streamed {stream * 1e3:.3f} us) at "
        f"{warm_it} iterations: coarse inverse {einv_ms:.3f} ms + launch at "
        f"C={rule} {launch_ms:.3f} ms = {us(launch_ms, warm_it):.2f} us/iteration "
        f"(C=1 {launch_ms_1:.3f} ms = {us(launch_ms_1, warm_it):.2f} us/iteration, "
        f"{launch_ms_1 / launch_ms:.2f}x; in turns); the rule's C bit-equal to "
        f"C=1 on every run {bits}; Jacobi-only K3 launch on the same warm "
        f"system at C={k3_rule} {jacobi_launch_ms:.3f} ms = "
        f"{us(jacobi_launch_ms, jac['warm (deflated guess)']):.2f} "
        f"us/iteration; K = {sp.K} strips; iterations with strips {its}, "
        f"Jacobi-only K3 on the same systems {jac}")
    kernels[name] = dict(
        name=f"{name} fused_cg_mb(coarse_strips=True) (strip-coarse two-level "
             f"PCG, merged frame{case['k3_form']}, whole solve; cluster arm, "
             f"one lane over C = {rule} SMs)",
        route="cuda", source="fluidgym_tpu_torch/csrc/cg.cu",
        replaces="fluidgym_tpu/ops/cg_pallas_mb.py:284", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
        streamed_ms=stream, coarse_inverse_ms=einv_ms, cluster=rule,
        launch_ms=launch_ms, us_per_it=us(launch_ms, warm_it),
        launch_ms_cluster_1=launch_ms_1,
        us_per_it_cluster_1=us(launch_ms_1, warm_it), cluster_bits=bits,
        jacobi_launch_ms=jacobi_launch_ms,
        iterations=warm_it, iterations_by_run=its, jacobi_iterations=jac,
        K=sp.K, shape=f"(1, {n}) pressure, K = {sp.K}")


def _counters():
    """Every launch counter and plain-version call counter of the port, as
    ``(object, attribute)`` pairs."""
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb, stencil_cuda

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    launches = [(k3, "launches"), (k3, "flip_launches"), (k3, "coarse_launches"),
                (k3, "coarse_flip_launches"), (k3, "agg_launches"),
                (k3, "agg_flip_launches"), (k2, "launches"),
                (k2, "merged_launches"), (k2, "merged_flip_launches"),
                (cg_cuda.fused_cg, "launches"),
                (stencil_cuda.stencil_apply, "launches")]
    plains = [(f, "calls") for f in (
        cg_cuda.fused_cg_plain, cg_cuda_mb.fused_cg_mb_plain,
        cg_cuda_mb.fused_bicgstab_plain, stencil_cuda.stencil_apply_plain)]
    return launches, plains


def _strips_main_path(dev, kernels, piso, linsolve) -> None:
    """Phase 17: the slice's main path: ``make`` at the registered defaults,
    ``reset(seed=0)``, then the strips (``SimConfig.pressure_coarse_strips``)
    and K4 switched on; 3 steps of the cylinder and 1 of the airfoil with
    phases 9 and 12's actions.  In every step K3-coarse(-flip) launches
    exactly twice per substep, every launch on the cluster arm
    (``fused_cg_mb.cluster_launches``), K2-mb(-flip) once, K4 once per
    block per ``domain_apply`` (the deflation setup and the two warm-start
    gates), and no other kernel form, plain version or ``linsolve`` loop
    runs."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb, stencil_cuda

    launches, plains = _counters()
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    k4 = stencil_cuda.stencil_apply
    k4_total = 0
    for case in MERGED_CASES:
        env_id, name = case["env_id"], case["k3c"]
        watched = {name: (k3, case["k3c_count"]), case["k2"]: (k2, case["k2_count"]),
                   "K4": (k4, "launches")}
        calls, restore = count_calls(piso, linsolve)

        def counts():
            out = {k: getattr(*v) for k, v in watched.items()}
            out["other"] = sum(getattr(*c) for c in launches) - sum(out.values())
            out[f"{name} cluster"] = k3.cluster_launches
            out["plain"] = sum(getattr(*c) for c in plains)
            out["linsolve"] = calls["cg"] + calls["bicgstab"]
            out["substeps"] = calls["piso_substep_info"]
            return out

        for c in launches + plains + [(k3, "cluster_launches")]:
            setattr(*c, 0)
        torch.cuda.synchronize()
        try:
            env = fluidgym_tpu_torch.make(env_id, **case["make_kw"])
            env.reset(seed=0)
            env._cfg = dataclasses.replace(env._cfg, pressure_coarse_strips=True)
            stencil_cuda.set_stencil_kernel(True)
            cfg = env._cfg
            check(cfg.pressure_deflation and cfg.pressure_warm_start,
                  f"{env_id}: K4's count assumes deflation and warm start")
            k4_per_sub = len(env._topo.blocks) * (1 + cfg.corrector_steps)
            rng = np.random.default_rng(0)
            actions = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
                       for _ in range(3)][:case["k3c_steps"]]
            step_s, per_step, p_its, drags = [], [], [], []
            for a in actions:
                c0 = counts()
                t = time.perf_counter()
                obs, reward, term, trunc, info = env.step(a)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                d = {k: v - c0[k] for k, v in counts().items()}
                per_step.append(d)
                sub = d["substeps"]
                expect = {name: cfg.corrector_steps * sub,
                          f"{name} cluster": cfg.corrector_steps * sub,
                          case["k2"]: sub, "K4": k4_per_sub * sub, "other": 0,
                          "plain": 0, "linsolve": 0}
                check(sub > 0 and all(d[k] == v for k, v in expect.items()),
                      f"{env_id} step with strips + K4: launches {d}, expected "
                      f"{expect}")
                for k, v in obs.items():
                    check(tuple(v.shape) == env.observation_space[k].shape,
                          f"obs {k} shape {tuple(v.shape)}")
                    check(bool(torch.isfinite(v).all()), f"obs {k} not finite")
                check(bool(torch.isfinite(reward).all()), "reward not finite")
                drags.append(float(info["drag"]))
                p_its.append(int(info["pressure_iterations"]))
                check(math.isfinite(drags[-1]) and math.isfinite(float(info["lift"])),
                      "drag/lift not finite")
        finally:
            stencil_cuda.set_stencil_kernel(False)
            restore()
        total = counts()
        ms_step = 1e3 * sum(step_s) / len(step_s)
        ref = kernels[case["k3"]]
        n = len(actions)
        ref_ms = sum(ref["step_ms"][:n]) / n
        ref_its = ref["pressure_iterations_per_step"][:n]
        subs = [d["substeps"] for d in per_step]
        log(f"phase 17 main path with strips + K4 ok: {env_id} steps "
            f"{[round(x, 3) for x in step_s]} s, {ms_step:.1f} ms/env step (phase "
            f"{case['phases'][2]}, Jacobi-only, same actions: {ref_ms:.1f}), "
            f"substeps {subs} (phase {case['phases'][2]}: "
            f"{ref['substeps_per_step'][:n]}), pressure iterations per step "
            f"{p_its} (phase {case['phases'][2]}: {ref_its}), drag "
            f"{[round(x, 5) for x in drags]}, per-step launches {per_step}, "
            f"totals {total}, K4 {k4_per_sub} per substep")
        kernels[name].update(
            launches=total[name],
            cluster_launches=sum(d[f"{name} cluster"] for d in per_step),
            launches_per_env_step=total[name] / n,
            ms_per_env_step=ms_step, jacobi_ms_per_env_step=ref_ms,
            pressure_iterations_per_step=p_its,
            jacobi_pressure_iterations_per_step=ref_its, substeps_per_step=subs)
        k4_total += total["K4"]
        kernels["K4"][f"launches_per_env_step {env_id}"] = total["K4"] / n
    kernels["K4"]["launches"] = k4_total


def _strips_card_vs_host(dev, piso) -> None:
    """Phase 18: the card against the host for the cylinder with the strips
    and K4 on: 1 env step (25 sim steps) at full width from the bundled
    snapshot, the card's solves as the rule picks them (K3-coarse and K2-mb
    on the cluster arm); obs and reward to 1e-3.

    With the strips on, this float32 step is decided by rounding: on the
    host alone, 1 against 8 threads moves the pressure obs 1.5e-4, the
    velocity obs 1.2e-4 and the reward 4.8e-4 and the step's pressure
    iterations from 820 to 811 (4.8e-6, 2.2e-7, 6.1e-7 and no change with
    Jacobi alone), and 1 against 4 threads moves the pressure obs 1.98e-3
    (``scripts/port_strips_rounding.py``; ROADMAP Queue 3).  The cluster
    arm's sums are the one-block form's, bit for bit, so the card's step
    is the chunk grid's whatever C the rule picks.  Phases 15-16 hold the
    kernel itself to its plain version."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb, stencil_cuda

    case = MERGED_CASES[0]
    t = time.perf_counter()
    outs = {}
    k3 = cg_cuda_mb.fused_cg_mb
    # every K3 launch of the card run (the reset's Jacobi-only ones, then
    # K3-coarse) and its count on the cluster arm
    k3_all = lambda: (k3.launches + k3.flip_launches + k3.coarse_launches
                      + k3.coarse_flip_launches)
    before = (k3.coarse_launches, k3_all(), k3.cluster_launches,
              cg_cuda_mb.fused_bicgstab_mb.cluster_launches)
    stencil_cuda.set_stencil_kernel(True)
    try:
        for where in (dev, torch.device("cpu")):
            e = fluidgym_tpu_torch.make(case["env_id"], device=where,
                                        **case["host_kw"])
            e.reset(seed=0)
            e._cfg = dataclasses.replace(e._cfg, pressure_coarse_strips=True)
            a = np.linspace(0.4, -0.4, e.action_space.shape[0]).astype(np.float32)
            o, r, *_ = e.step(a)
            outs[where.type] = dict(o, reward=r)
    finally:
        stencil_cuda.set_stencil_kernel(False)
    check(k3.coarse_launches > before[0],
          "phase 18's card run did not launch K3-coarse")
    check(k3.cluster_launches - before[2] == k3_all() - before[1]
          and cg_cuda_mb.fused_bicgstab_mb.cluster_launches > before[3],
          "phase 18's card run did not take the cluster arm for every K3 "
          "and K3-coarse launch and for K2-mb")
    og, oc = outs[dev.type], outs["cpu"]
    diffs = {k: float((og[k].cpu() - oc[k]).abs().max()
                      / oc[k].abs().max().clamp(min=1e-30)) for k in og}
    log(f"phase 18 {case['env_id']} with strips + K4, full width, 1 step from "
        f"the bundled snapshot ({e.n_sim_steps} sim steps), card (cluster "
        f"rule) vs host: relative diffs {diffs} (bar 1e-3) in "
        f"{time.perf_counter() - t:.2f}s")
    check(all(v <= 1e-3 for v in diffs.values()),
          f"card and host disagree with strips + K4 on {case['env_id']}")


# ---------------------------------------------------------------------------
# phases 19-22: the chunk grid and the batched env
# ---------------------------------------------------------------------------

#: lanes and forced chunk of phase 19: 4 blocks of 33, 33, 33 and 31 lanes
CHUNK_LANES, CHUNK_FORCED = 130, 33


def _lane_forms(dev, piso, rbc) -> list:
    """Phase 19's systems, one per kernel form, at CHUNK_LANES lanes with
    one operator per lane (the main-path operator scaled by 0.5..2, as a
    batch of envs brings): ``A_l x_l`` for random ``x_l`` scaled 1e-3..1,
    lane 2 zero.  Each form: ``launch(L, chunk)`` / ``plain(L, chunk)`` on
    the first L lanes -> ``(x, iterations, residual_sum)``, and
    ``vmapped(chunk)``: the wrapper under ``torch.func.vmap`` over the
    lanes' systems (envs of C lanes each) -> x of every lane."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge, coarse_strips

    L = CHUNK_LANES
    g = torch.Generator().manual_seed(19)
    scale = torch.logspace(-3, 0, L, device=dev)
    scale[2] = 0.0
    lane = lambda v, t: v.reshape((-1,) + (1,) * (t.dim() - 1))
    forms = []

    def add(name, algo, C, diag0, off0, plan, tol, coarse=False):
        """``diag0``/``off0``: one env's operator, spatial (single block) or
        flat ``(n,)`` / ``(nf, n)`` (merged ``plan``)."""
        E = L // C
        s_env = torch.linspace(0.5, 2.0, E, device=dev)
        s = s_env.repeat_interleave(C)
        diag = diag0.unsqueeze(0) * lane(s, diag0.unsqueeze(0))
        off = off0.unsqueeze(0) * lane(s, off0.unsqueeze(0))
        nd = 2
        x = torch.randn(tuple(diag.shape), generator=g).to(dev)
        if plan is None:
            ax = cg_cuda.roll_matvec(diag, off, x, nd)
            n = math.prod(diag0.shape)
        else:
            ax = cg_cuda_mb._merged_mv(plan, diag, off)(x)
            n = diag0.shape[0]
        # the checks' lanes span scales 1e-3..1 (different speeds, lane 2
        # zero); the timings' lanes are all A x (equal difficulty, so that
        # 1, 64 and 130 lanes do the same work per lane)
        b, b_time = ax * lane(scale, x), ax
        tol2 = cg_cuda.tol2_sum_f32(tol, n)
        kw = dict(tol2_sum=tol2, maxiter=5000, stall_iters=250,
                  precondition=True, return_best=algo == "cg")
        sp = coarse_strips.strip_plan(plan) if coarse else None
        nf = off0.shape[0]

        def per_sb(t):  # flat (L, [nf,] n) -> per-super-block (L, [nf,] *s)
            if t.dim() == 2:
                return cg_cuda_mb.unflatten_fields(plan, t)
            return tuple(u.reshape((t.shape[0], nf) + tuple(u.shape[1:]))
                         for u in cg_cuda_mb.unflatten_fields(
                             plan, t.reshape(t.shape[0] * nf, -1)))

        einv = None
        if coarse:
            einv = torch.func.vmap(lambda d, o: coarse_strips.coarse_inverse(
                plan, sp, tuple(zip(d, o))))(per_sb(diag), per_sb(off))

        def chunk_of(Ln, chunk):
            return cg_cuda.default_chunk(Ln, dev) if chunk is None else chunk

        def roll_launcher(Ln, resident, rhs=b, chunk=1):
            """K1 / K2: one launch on preallocated buffers, in either arm."""
            mod = cg_cuda if algo == "cg" else cg_cuda_mb
            return mod.launcher(diag[:Ln], off[:Ln], rhs[:Ln], None, ndims=nd,
                                chunk=chunk, resident=resident, **kw)

        def launch(Ln, chunk=None, rhs=b):
            """One launch at the card's default chunk (and, for K1 / K2,
            the resident rule's arm), or at a forced chunk."""
            c = chunk_of(Ln, chunk)
            if plan is None:
                res = cg_cuda.default_resident(Ln, n, nd, c, dev)
                return roll_launcher(Ln, res, rhs, c)()
            a = (diag[:Ln], off[:Ln], rhs[:Ln], None)
            cz = None if einv is None else (sp, einv[:Ln])
            return cg_cuda_mb._launch_merged(algo, plan, *a, chunk=c,
                                             coarse=cz, **kw)

        def plain(Ln, chunk=None, rhs=b):
            c = chunk_of(Ln, chunk)
            a = (diag[:Ln], off[:Ln], rhs[:Ln], None)
            if plan is None and algo == "cg":
                return cg_cuda.fused_cg_plain(*a, ndims=nd, chunk=c, **kw)
            if plan is None or algo == "bicgstab":
                return cg_cuda_mb.fused_bicgstab_plain(*a, ndims=nd, plan=plan,
                                                       chunk=c, **kw)
            cz = None if einv is None else (sp, einv[:Ln])
            return cg_cuda_mb.fused_cg_mb_plain(plan, *a, coarse=cz, chunk=c,
                                                **kw)

        wkw = dict(tol=tol, maxiter=5000, stall_iters=250, precondition=True,
                   return_best=algo == "cg")

        def vmapped(chunk=None):
            de, oe = diag[::C], off[::C]
            be = b.reshape((E, C) + tuple(b.shape[1:]))
            if plan is None and algo == "cg":
                f = lambda d, o, bb: cg_cuda.fused_cg(d, o, bb, ndims=nd,
                                                      chunk=chunk, **wkw)[0]
                return torch.func.vmap(f)(de, oe, be).reshape(b.shape)
            if plan is None:
                tp = block_merge.trivial_plan(rbc["topo"])
                f = lambda d, o, bb: cg_cuda_mb.fused_bicgstab_mb(
                    tp, (d,), (o,), (bb,), chunk=chunk, **wkw)[0][0]
                return torch.func.vmap(f)(de, oe, be).reshape(b.shape)
            if algo == "cg":
                f = lambda d, o, bb: cg_cuda_mb.fused_cg_mb(
                    plan, d, o, tuple(t[0] for t in bb), chunk=chunk,
                    coarse_strips=coarse, **wkw)[0]
            else:
                f = lambda d, o, bb: cg_cuda_mb.fused_bicgstab_mb(
                    plan, d, o, bb, chunk=chunk, **wkw)[0]
            xs = torch.func.vmap(f)(per_sb(de), per_sb(oe),
                                    tuple(t.reshape((E, C) + tuple(t.shape[1:]))
                                          for t in per_sb(b)))
            # (E, [C,] *s) per super-block -> (L, n)
            return cg_cuda_mb.flatten_fields(
                plan, tuple(t.reshape((L,) + tuple(t.shape[1 + (C > 1):]))
                            for t in xs))

        forms.append(dict(name=name, algo=algo, C=C, n=n, tol2=tol2, b=b,
                          b_time=b_time, roll_launcher=roll_launcher,
                          launch=launch, plain=plain, vmapped=vmapped,
                          seam=0 if plan is None else _seam_cells(plan),
                          coarse_K=sp.K if coarse else 0))

    po, adv = rbc["po"], rbc["adv"]
    add("K1", "cg", 1, po.diag, po.off, None, 1e-7)
    add("K2", "bicgstab", 2, adv.diag, adv.off, None, 1e-6)
    for case, name, algo, C, tol, coarse in (
            (MERGED_CASES[0], "K3", "cg", 1, 1e-6, False),
            (MERGED_CASES[0], "K2-mb", "bicgstab", 2, 1e-6, False),
            (MERGED_CASES[1], "K3-flip", "cg", 1, 1e-6, False),
            (MERGED_CASES[0], "K3-coarse", "cg", 1, 1e-6, True)):
        sy = _snapshot_system(dev, piso, case)
        plan = sy["plan"]
        ops = sy["p_ops"] if algo == "cg" else sy["adv"]
        mops = block_merge.pack_ops(plan, ops)
        d1, o1 = cg_cuda_mb.flatten_ops(plan, tuple(m[0] for m in mops),
                                        tuple(m[1] for m in mops))
        add(name, algo, C, d1[0], o1[0], plan, tol, coarse)
    return forms


def _seam_cells(plan) -> int:
    return sum(math.prod(hi - lo for K, (lo, hi) in enumerate(fx.window)
                         if K != fx.face // 2) for fx in plan.fixups)


def _chunk_phase(dev, kernels, piso, rbc) -> dict:
    """Phase 19: the chunk grid.  Every kernel form at 130 lanes with one
    operator per lane, in chunks of 33 (4 blocks, the last ragged), against
    its plain version in the same chunks: the same converged flags,
    iterations per lane within the form's bar (CG 3, BiCGStab 2; K3-coarse
    10, see ``tests/test_torch_kernels_cuda.py``), x within the form's bar
    (1e-3 relative, BiCGStab 1e-4), the zero lane exactly 0, the CG forms
    past iteration 100.  The wrapper under ``torch.func.vmap`` equals the
    raw launch bit for bit (one launch for the batch).  ms per solve at 1,
    64 and 130 lanes of equal difficulty at the card's default chunk, the
    plain version on the 64 lanes in one lockstep loop, and the bound of
    the 64-lane batch (this run's per-lane iterations).  K1 and K2 also in
    both arms at 1, 64 and 130 lanes (one lane per block), in turns: ms per
    raw launch on preallocated buffers of the resident arm and of the chunk
    grid.  Returns the K1 and K2 forms (phase 24 holds their arms bit for
    bit)."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    L = CHUNK_LANES
    roll = {}
    for f in _lane_forms(dev, piso, rbc):
        name, cg = f["name"], f["algo"] == "cg"
        xk, ik, rk = f["launch"](L, CHUNK_FORCED)
        xp, ip, rp = f["plain"](L, CHUNK_FORCED)
        torch.cuda.synchronize()
        zero = (f["b"].reshape(L, -1) == 0).all(dim=1)
        ck, cp = (rk <= f["tol2"]) | zero, (rp <= f["tol2"]) | zero
        it_bar = (10 if f["coarse_K"] else 3) if cg else 2
        rel_bar = 1e-3 if cg else 1e-4
        err = float((xk - xp).abs().max())
        scale = float(xp.abs().max())
        dit = int((ik - ip).abs().max())
        log(f"  {name} x{L} in chunks of {CHUNK_FORCED}: iterations per chunk "
            f"{ik[::CHUNK_FORCED].tolist()} (plain {ip[::CHUNK_FORCED].tolist()}), "
            f"converged {int(ck.sum())}/{L} (plain {int(cp.sum())}), max|dx| "
            f"{err:.3e} ({err / max(scale, 1e-30):.2e} of max|x|, bar {rel_bar:g})")
        check(torch.equal(ck, cp), f"{name} x{L}: converged flags differ")
        check(dit <= it_bar, f"{name} x{L}: iterations differ by {dit} > {it_bar}")
        check(err <= rel_bar * max(scale, 1e-30), f"{name} x{L}: solutions differ")
        check(bool(torch.isfinite(xk).all()), f"{name} x{L}: non-finite")
        check(bool((xk[2] == 0).all()), f"{name} x{L}: the zero lane is not 0")
        if cg:
            check(int(ik.max()) > 100, f"{name} x{L}: no lane passed iteration 100")
        x_def = f["launch"](L)[0]
        cl0 = cg_cuda_mb.fused_cg_mb.cluster_launches
        check(torch.equal(f["vmapped"](), x_def),
              f"{name}: the vmapped wrapper differs from its launch")
        # a batch the card cannot hold as clusters keeps the chunk grid
        check(cg_cuda_mb.fused_cg_mb.cluster_launches == cl0,
              f"{name} x{L}: the batch took the cluster arm")
        bt = f["b_time"]
        ms = {Ln: cuda_ms(torch, lambda Ln=Ln: f["launch"](Ln, rhs=bt), 5)
              for Ln in (1, 64, L)}
        arms = {}
        if name in ("K1", "K2"):
            roll[name] = f
            for Ln in (1, 64, L):
                ls = {arm: f["roll_launcher"](Ln, arm, bt) for arm in (False, True)}
                t = {False: 0.0, True: 0.0}
                for arm in (False, True, True, False):
                    t[arm] += cuda_ms(torch, ls[arm], 5) / 2
                arms[Ln] = dict(resident=t[True], chunk_grid=t[False])
            log(f"  {name}: ms per raw launch (one lane per block, in turns), "
                "resident / chunk grid: " + ", ".join(
                    f"{Ln} lanes {a['resident']:.3f} / {a['chunk_grid']:.3f}"
                    for Ln, a in arms.items())
                + f"; 64 lanes cost {arms[64]['resident'] / arms[1]['resident']:.2f}"
                f"x one lane resident, {arms[64]['chunk_grid'] / arms[1]['chunk_grid']:.2f}"
                "x on the chunk grid")
        plain_ms = cuda_ms(torch, lambda: f["plain"](64, 64, rhs=bt), 1)
        it64 = f["launch"](64, rhs=bt)[1].float()
        bnd, by, _ = bound_ms(f["n"], 64, 2, float(it64.mean()), f["algo"],
                              False, False, f["seam"], f["coarse_K"])
        log(f"  {name}: ms per solve at default chunk {cg_cuda.default_chunk(L, dev)} "
            f"(130 lanes) / {cg_cuda.default_chunk(64, dev)} (64): 1 lane "
            f"{ms[1]:.3f}, 64 lanes {ms[64]:.3f}, 130 lanes {ms[L]:.3f} "
            f"(64 lanes: plain in one lockstep loop {plain_ms:.1f} ms, bound "
            f"{bnd * 1e3:.1f} us by {by} at {float(it64.mean()):.1f} mean "
            f"iterations per lane, max {int(it64.max())})")
        chunk_numbers = dict(ms_1_lane=ms[1], ms_64_lanes=ms[64],
                             ms_130_lanes=ms[L], plain_64_lanes_ms=plain_ms,
                             bound_64_lanes_ms=bnd, max_abs_err_130_lanes=err)
        if name in ("K3-flip", "K3-coarse"):
            # not on a batched path yet: the numbers join the form's entry
            kernels[name].update(chunk_numbers)
            continue
        by_arm = {} if not arms else dict(
            raw_ms_1_lane=arms[1]["resident"], raw_ms_64_lanes=arms[64]["resident"],
            raw_ms_130_lanes=arms[L]["resident"],
            raw_ms_global_1_lane=arms[1]["chunk_grid"],
            raw_ms_global_64_lanes=arms[64]["chunk_grid"],
            raw_ms_global_130_lanes=arms[L]["chunk_grid"],
            arm="resident" if cg_cuda.default_resident(64, f["n"], 2, 1, dev)
            else "global")
        kernels[f"{name} lanes"] = dict(
            name=f"{name} lane folding and chunking (LaneFold vmap rule, "
                 "chunk grid of lockstep blocks)",
            route="cuda", source="fluidgym_tpu_torch/csrc/"
            + ("cg.cu" if cg else "bicgstab_mb.cu"),
            replaces=("fluidgym_tpu/ops/cg_pallas.py:232" if name == "K1"
                      else "fluidgym_tpu/ops/cg_pallas_mb.py:602"),
            launches=0, max_abs_err=err, ms=ms[64], plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by, library_ms=None, ms_1_lane=ms[1],
            ms_130_lanes=ms[L], lanes=64, mean_iterations=float(it64.mean()),
            **by_arm)
    log(f"phase 19 chunk grid ok: 6 forms x {L} lanes in "
        f"{time.perf_counter() - t0:.1f}s")
    return roll


#: the batched main paths: phase 20 (RBC) and 21 (the cylinder)
BATCH_CASES = (
    # RBC from a randomized reset (noise, then 1-2 time units of burn-in):
    # its float32 step is decided by rounding at ~1e-4..3e-4 in the obs
    # (117 pressure iterations per solve, past the refresh), as the single
    # env's own card-vs-host difference from the same state shows in the
    # same run; the batch's reductions round differently from the single
    # env's, so lanes are held to 1e-3 in the obs.  The reward nu_ref - Nu
    # is a difference of near-equal numbers: its error is held against Nu.
    dict(env_id="RBC2D-easy-v0", phase=20, steps=3, metric="nusselt",
         obs_bar=1e-3, reward_bar=1e-4,
         per_round={"K1": ("fused_cg", "launches", 2),
                    "K2": ("fused_bicgstab_mb", "launches", 2)},
         # every launch on the resident arm (one lane per block)
         resident=("K1", "K2")),
    # the cylinder from the bundled snapshot without randomization: 64
    # randomized resets (noise, then uncontrolled sim steps) took 154 s of
    # a run that must stay under its time limit; the lanes part with their
    # seeded per-lane actions from the first step on
    dict(env_id="CylinderJet2D-easy-v0", phase=21, steps=2, metric="drag",
         obs_bar=1e-4, reward_bar=1e-4, randomize=False,
         per_round={"K3": ("fused_cg_mb", "launches", 2),
                    "K2-mb": ("fused_bicgstab_mb", "merged_launches", 1)}),
)
BATCH = 64


def _batched_phase(dev, kernels, piso, linsolve, case) -> dict:
    """Phases 20-21: ``BatchedFluidEnv(env_id, 64)`` at its registered full
    width, ``reset(seed=0)``, a few steps with seeded numpy actions.  The
    counters are zeroed just before and read just after; in every step each
    kernel of the path launches exactly its count per lockstep round (a
    vmapped substep), whatever B is; no other kernel form, no plain
    version, no ``linsolve`` loop and no vmap per-lane fallback (an error
    inside ``piso.strict_vmap``).  Lanes 0 and 63 against single envs
    reset from the same seeds and stepped with the same actions: obs and
    reward to 1e-4."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.parallel import BatchedFluidEnv

    env_id, ph = case["env_id"], case["phase"]
    mods = {"fused_cg": cg_cuda.fused_cg, "fused_cg_mb": cg_cuda_mb.fused_cg_mb,
            "fused_bicgstab_mb": cg_cuda_mb.fused_bicgstab_mb}
    watched = {k: (mods[w], a) for k, (w, a, _) in case["per_round"].items()}
    launches, plains = _counters()
    calls, restore = count_calls(piso, linsolve)

    def counts():
        out = {k: getattr(*v) for k, v in watched.items()}
        out["other"] = sum(getattr(*c) for c in launches) - sum(out.values())
        out["plain"] = sum(getattr(*c) for c in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["rounds"] = calls["piso_substep_info"]
        for k in case.get("resident", ()):
            out[f"{k} resident"] = watched[k][0].resident_launches
        return out

    for c in launches + plains:
        setattr(*c, 0)
    for k in case.get("resident", ()):
        watched[k][0].resident_launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        benv = BatchedFluidEnv(env_id, BATCH)
        obs, _ = benv.reset(seed=0, randomize=case.get("randomize"))
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        rng = np.random.default_rng(case["phase"])
        acts = [rng.uniform(-1, 1, (BATCH,) + tuple(benv.action_space.shape))
                .astype(np.float32) for _ in range(case["steps"])]
        step_s, per_step, outs, p_its, unconverged = [], [], [], [], []
        for a in acts:
            c0 = counts()
            t = time.perf_counter()
            obs, rew, term, trunc, info = benv.step(a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            d = {k: v - c0[k] for k, v in counts().items()}
            per_step.append(d)
            expect = {k: n * d["rounds"] for k, (_, _, n) in case["per_round"].items()}
            check(d["rounds"] > 0 and all(d[k] == v for k, v in expect.items())
                  and d["other"] == 0 and d["plain"] == 0 and d["linsolve"] == 0,
                  f"{env_id} x{BATCH} step launches {d}, expected {expect} and "
                  "no other kernel form, plain version or linsolve loop")
            check(all(d[f"{k} resident"] == d[k] for k in case.get("resident", ())),
                  f"{env_id} x{BATCH}: not every launch took the resident arm: {d}")
            for k, v in obs.items():
                check(tuple(v.shape) == (BATCH,) + benv.observation_space[k].shape,
                      f"obs {k} shape {tuple(v.shape)}")
                check(bool(torch.isfinite(v).all()), f"obs {k} not finite")
            check(tuple(rew.shape) == (BATCH,) and bool(torch.isfinite(rew).all()),
                  "rewards not finite")
            check(not bool(term.any()), f"{env_id}: a lane diverged")
            unconverged.append(int((~info["pressure_converged"]).sum()))
            outs.append((obs, rew, info[case["metric"]]))
            p_its.append(info["pressure_iterations"].tolist())
    finally:
        restore()
    total = counts()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    def diffs(o, r, m, ob, rb, mb, out):
        """Per-key worst relative obs diffs; the reward's against its
        metric's scale (the quantity it is made of)."""
        for k in o:
            out[k] = max(out.get(k, 0.0), rel(ob[k].to(o[k].device), o[k]))
        scale = max(float(r.abs().max()), float(m.abs().max()))
        out["reward"] = max(out.get("reward", 0.0),
                            float((rb.to(r.device) - r).abs().max()) / scale)

    # lanes 0 and 63 against single envs from the same seeds, and (the
    # scale of this state's rounding) lane 0's single env on the card
    # against the host from the same state
    t = time.perf_counter()
    worst, host, single_s, its = {}, {}, [], []
    for l in (0, BATCH - 1):
        env = fluidgym_tpu_torch.make(env_id)
        env.reset(seed=l, randomize=case.get("randomize"))
        if l == 0:
            twin = fluidgym_tpu_torch.make(env_id, device="cpu")
            twin.reset(seed=0, randomize=False)
            twin.set_state(env.get_state())
        for i, a in enumerate(acts):
            ts = time.perf_counter()
            o, r, _, _, inf = env.step(a[l])
            torch.cuda.synchronize()
            single_s.append(time.perf_counter() - ts)
            ob, rb, mb = outs[i]
            diffs(o, r.reshape(()), inf[case["metric"]],
                  {k: v[l] for k, v in ob.items()}, rb[l], mb[l], worst)
            its.append((int(inf["pressure_iterations"]), p_its[i][l]))
            if l == 0:
                oh, rh, _, _, ih = twin.step(a[0])
                diffs(oh, rh.reshape(()), ih[case["metric"]], o,
                      r.reshape(()), inf[case["metric"]], host)
    bars = {k: case["reward_bar" if k == "reward" else "obs_bar"] for k in worst}
    check(all(worst[k] <= bars[k] for k in worst),
          f"{env_id}: batched lanes and single envs differ by {worst} "
          f"(bars {bars})")
    rounds = [d["rounds"] for d in per_step]
    ms_step = 1e3 * sum(step_s) / len(step_s)
    single_ms = 1e3 * sum(single_s) / len(single_s)
    log(f"phase {ph} batched main path ok: BatchedFluidEnv({env_id!r}, {BATCH}) "
        f"blocks {[b.shape for b in benv.env._topo.blocks]}, reset {reset_s:.1f}s, "
        f"steps {[round(x, 3) for x in step_s]} s ({ms_step:.1f} ms/step), "
        f"lockstep rounds per step {rounds}, per-step launches {per_step}, "
        f"per round { {k: n for k, (_, _, n) in case['per_round'].items()} }, "
        f"totals "
        f"{total}; lanes with an unconverged pressure solve per step "
        f"{unconverged}; lanes 0 and {BATCH - 1} vs single envs from the same "
        f"seeds: worst relative diffs {worst} (bars {bars}), pressure "
        f"iterations (single, batched lane) {its}; lane 0's single env, card "
        f"vs host from the same state: {host}; single env {single_ms:.1f} "
        f"ms/step in {time.perf_counter() - t:.1f}s")
    for k in case["per_round"]:
        entry = kernels[f"{k} lanes"]
        entry["launches"] = total[k]
        entry["launches_per_env_step"] = (sum(d[k] for d in per_step)
                                          / len(per_step) / BATCH)
        entry["launches_per_round"] = case["per_round"][k][2]
        entry["batched_env"] = env_id
        if k in case.get("resident", ()):
            entry["resident_launches"] = total[f"{k} resident"]
    return dict(env_id=env_id, ms_step=ms_step, single_ms=single_ms,
                rounds=rounds, pressure_iterations=p_its)


def _throughput_phase(kernels, results) -> None:
    """Phase 22: batched env-steps/s beside B x the single env's ms per step
    (the same run, the same card, the same actions)."""
    for r in results:
        batched = BATCH / (r["ms_step"] / 1e3)
        single = 1e3 / r["single_ms"]
        log(f"phase 22 {r['env_id']}: batch {BATCH}: {batched:.1f} env-steps/s "
            f"({r['ms_step']:.1f} ms per batched step); single env "
            f"{single:.2f} env-steps/s ({r['single_ms']:.1f} ms/step, x{BATCH} = "
            f"{BATCH * r['single_ms']:.0f} ms); ratio {batched / single:.1f}")
        kernels.setdefault("batched", {})[r["env_id"]] = dict(
            env_steps_per_s=batched, ms_per_batched_step=r["ms_step"],
            single_env_ms_per_step=r["single_ms"], rounds_per_step=r["rounds"])


# ---------------------------------------------------------------------------
# phase 23: the cluster arm of K3 and K2-mb
# ---------------------------------------------------------------------------

def _cluster_phase(dev, kernels, piso, case) -> None:
    """Phase 23, for one merged case: K3 (warm from the deflated guess, as
    the main path solves it) and K2-mb (the 2-lane velocity system) at the
    main-path shapes, for C = 1 and every cluster size whose clusters the
    card holds for the lanes, in turns.  Each C against the plain version
    (the same converged flags, iterations within 3, x within the phase's
    bar), run twice bit for bit; C = 1 through the wrapper bit-equal to the
    chunk grid's raw launch; every C bit-equal to C = 1 (x, iterations,
    residual).  ms per wrapper call and per raw launch on preallocated
    buffers, us per iteration, the rule's C and the card's occupancy per C;
    the rule's C no slower per raw launch than C = 1."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge
    from fluidgym_tpu_torch.solver import stencil as st

    t0 = time.perf_counter()
    sy = _snapshot_system(dev, piso, case)
    plan, n = sy["plan"], sy["n"]
    nd = plan.ndims
    nf = 2 * nd
    flat = lambda xs: cg_cuda_mb.flatten_fields(plan, xs)
    per_sb = lambda t: cg_cuda_mb.unflatten_fields(plan, t)

    def ops_of(ops):
        m = block_merge.pack_ops(plan, ops)
        return cg_cuda_mb.flatten_ops(plan, tuple(a[0] for a in m),
                                      tuple(a[1] for a in m))

    pd, po = ops_of(sy["p_ops"])
    ad, ao = ops_of(sy["adv"])
    pb = flat(tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, sy["rhs"])))
    px = flat(tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, sy["guess"])))
    state = sy["state"]
    vel_rhs = st.advection_rhs_velocity(state, sy["geoms"], sy["topo"],
                                        state.viscosity, sy["dt"])

    def pack2(fields):
        per_c = [flat(tuple(p.unsqueeze(0) for p in block_merge.pack_fields(
            plan, tuple(f[c] for f in fields)))) for c in range(2)]
        return torch.cat(per_c)

    vb = pack2(vel_rhs)
    vx = pack2(tuple(b.velocity for b in state.blocks))
    forms = ((case["k3"], "cg", pd, po, pb, px, case["tol_p"], 1e-3),
             (case["k2"], "bicgstab", ad, ao, vb, vx, 1e-5, 1e-4))
    for name, algo, diag, off, b, x0, tol, rel_bar in forms:
        cg = algo == "cg"
        L = b.shape[0]
        tol2 = cg_cuda.tol2_sum_f32(tol, n)
        kw = dict(tol2_sum=tol2, maxiter=5000, stall_iters=250,
                  precondition=True, return_best=cg)
        occ = {C: cg_cuda_mb.max_active_clusters(algo, nd, C, n, dev)
               for C in cg_cuda_mb.CLUSTER_SIZES if cg_cuda_mb.rows_fit(n, C, nd)}
        rule = cg_cuda_mb.default_cluster(L, n, nd, 1, dev, algo)
        sizes = [1] + [C for C in sorted(occ) if occ[C] >= L]
        if cg:
            xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(plan, diag, off, b, x0, **kw)
        else:
            xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(diag, off, b, x0,
                                                         ndims=nd, plan=plan, **kw)
        flags_p = (rp <= tol2).cpu()
        scale = float(xp.abs().max())
        wdiags = per_sb(diag)
        woffs = tuple(t.reshape((nf,) + tuple(t.shape[1:]))
                      for t in per_sb(off.reshape(nf, n)))
        wdiags = tuple(t[0] for t in wdiags)

        def wrapper(C):
            fn = cg_cuda_mb.fused_cg_mb if cg else cg_cuda_mb.fused_bicgstab_mb
            xs, _ = fn(plan, wdiags, woffs, per_sb(b), per_sb(x0), tol=tol,
                       maxiter=5000, stall_iters=250, precondition=True,
                       return_best=cg, cluster=C)
            return xs

        rows = {}
        for C in sizes:
            launch = cg_cuda_mb.merged_launcher(algo, plan, diag, off, b, x0,
                                                chunk=1, cluster=C, **kw)
            x1, i1, r1 = (t.clone() for t in launch())
            x2, i2, r2 = (t.clone() for t in launch())
            torch.cuda.synchronize()
            same = torch.equal(x1, x2) and torch.equal(i1, i2) and torch.equal(r1, r2)
            check(same, f"{name} C={C}: two runs differ")
            err = float((x1 - xp).abs().max())
            dit = int((i1.long() - ip.long()).abs().max())
            flags = (r1 <= tol2).cpu()
            check(torch.equal(flags, flags_p),
                  f"{name} C={C}: converged {flags.tolist()} vs plain {flags_p.tolist()}")
            check(dit <= 3, f"{name} C={C}: iterations {i1.tolist()} vs plain "
                            f"{ip.tolist()}")
            check(err <= rel_bar * max(scale, 1e-30),
                  f"{name} C={C}: max|dx| {err:.3e} > {rel_bar:g} of {scale:.3e}")
            check(bool(torch.isfinite(x1).all()), f"{name} C={C}: non-finite")
            if C == 1:
                check(torch.equal(flat(wrapper(1)), x1),
                      f"{name}: cluster=1 through the wrapper differs from the "
                      "chunk grid's raw launch")
                ref1 = (x1, i1, r1)
            else:
                check(all(torch.equal(u, v) for u, v in zip((x1, i1, r1), ref1)),
                      f"{name} C={C}: not bit-equal to C=1")
            its = int(i1.max())
            raw_ms = cuda_ms(torch, launch, 10)
            ms = cuda_ms(torch, lambda C=C: wrapper(C), 10)
            rows[C] = dict(iterations=its, raw_ms=raw_ms, ms=ms,
                           us_per_it=raw_ms * 1e3 / max(its, 1),
                           max_abs_err=err)
            log(f"  {name} ({L}, {n}) C={C}: {ms:.3f} ms/call, raw launch "
                f"{raw_ms:.3f} ms = {rows[C]['us_per_it']:.2f} us/iteration at "
                f"{its} iterations (plain {int(ip.max())}), max|dx| {err:.3e} "
                f"({err / max(scale, 1e-30):.2e} of max|x|), two runs "
                f"bit-equal{'' if C == 1 else ', bit-equal to C=1'}")
        log(f"phase 23 {name}: rule picks C={rule} (occupancy per C "
            f"{occ}, sizes run {sizes}); at C={rule} {rows[rule]['raw_ms']:.3f} "
            f"ms per raw launch against {rows[1]['raw_ms']:.3f} at C=1 "
            f"({rows[1]['raw_ms'] / rows[rule]['raw_ms']:.2f}x)")
        check(rows[rule]["raw_ms"] <= rows[1]["raw_ms"],
              f"{name}: the rule's C={rule} is slower per raw launch than C=1")
        kernels[name].update(
            cluster=rule, us_per_it=rows[rule]["us_per_it"],
            raw_ms=rows[rule]["raw_ms"], raw_ms_cluster_1=rows[1]["raw_ms"],
            ms_cluster_1=rows[1]["ms"], us_per_it_cluster_1=rows[1]["us_per_it"],
            occupancy={str(C): v for C, v in occ.items()},
            by_cluster={str(C): r for C, r in rows.items()})
    log(f"phase 23 {case['env_id']} done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 24: the resident arm of K1 and K2
# ---------------------------------------------------------------------------

def _resident_phase(kernels, systems) -> None:
    """Phase 24: the resident arm of K1 and K2 (one lane per block, its rows
    and four vectors in shared memory) against the chunk grid.  On every
    system (``(name, launcher(arm))``: the main path's solves of phases 3
    and 4, and phase 19's 64 and 130 lanes) the arm returns the chunk
    grid's x, iterations and residual bit for bit, twice.  Per raw launch
    (phases 3, 4 and 19, in turns on this card) it is no slower than the
    chunk grid at 1 and 64 lanes."""
    import torch

    t0 = time.perf_counter()
    for name, launcher in systems:
        runs = [tuple(t.clone() for t in launcher(arm)())
                for arm in (False, True, True)]
        torch.cuda.synchronize()
        same = lambda u, v: all(torch.equal(a, c) for a, c in zip(u, v))
        check(same(runs[1], runs[2]), f"{name}: two runs of the resident arm differ")
        check(same(runs[1], runs[0]),
              f"{name}: the resident arm differs from the chunk grid")
        log(f"  {name}: resident arm bit-equal to the chunk grid, iterations "
            f"{sorted(set(runs[1][1].tolist()))}")
    k1, k2, l1, l2 = (kernels[k] for k in ("K1", "K2", "K1 lanes", "K2 lanes"))
    pairs = {
        "K1 pressure, 1 lane (phase 3)": (k1["raw_ms"], k1["raw_ms_global"]),
        "K2 velocity, 2 lanes (phase 4)": (k2["raw_ms"], k2["raw_ms_global"]),
        "K2 temperature, 1 lane (phase 4)": (k2["scalar_in_turns"]["raw_ms"],
                                             k2["scalar_in_turns"]["raw_ms_global"]),
        "K1, 1 lane (phase 19)": (l1["raw_ms_1_lane"], l1["raw_ms_global_1_lane"]),
        "K1, 64 lanes (phase 19)": (l1["raw_ms_64_lanes"],
                                    l1["raw_ms_global_64_lanes"]),
        "K2, 1 lane (phase 19)": (l2["raw_ms_1_lane"], l2["raw_ms_global_1_lane"]),
        "K2, 64 lanes (phase 19)": (l2["raw_ms_64_lanes"],
                                    l2["raw_ms_global_64_lanes"])}
    for what, (res, grid) in pairs.items():
        log(f"  {what}: resident {res:.4f} ms per raw launch, chunk grid "
            f"{grid:.4f} ({grid / res:.2f}x)")
        check(res <= grid, f"{what}: the resident arm is slower per raw launch "
                           f"than the chunk grid ({res:.4f} > {grid:.4f} ms)")
    for e in (k1, k2, l1, l2):
        e["resident_bit_equal"] = True
    log(f"phase 24 resident arm ok: {len(systems)} systems bit-equal to the "
        f"chunk grid, no slower per raw launch at 1 and 64 lanes, in "
        f"{time.perf_counter() - t0:.1f}s")



# ---------------------------------------------------------------------------
# phases 25-30: RBC3D (K1-3D, K2-3D on the spread arm) and the other RBC2D ids
# ---------------------------------------------------------------------------

#: RBC3D's two widths: (64, 41, 64) and (128, 41, 128) cells, (Z, Y, X)
RBC3D_IDS = ("RBC3D-easy-v0", "RBC3D-wide-easy-v0")
#: the RBC2D ids beside RBC2D-easy-v0: (61, 96) blocks (the resident arm)
#: and (61, 192) blocks (the chunk grid)
RBC2D_IDS = ("RBC2D-medium-v0", "RBC2D-hard-v0", "RBC2D-wide-easy-v0",
             "RBC2D-wide-medium-v0", "RBC2D-wide-hard-v0")
#: the RBC3D ids whose bundled datasets this run does not read (the copy of
#: the repository it runs in may leave them out: they are 9-72 MB each)
RBC3D_OTHER_IDS = ("RBC3D-medium-v0", "RBC3D-hard-v0", "RBC3D-wide-medium-v0",
                   "RBC3D-wide-hard-v0")


def _capture_solves(dev, env_id, step_length, wrappers,
                    split: str = "train") -> dict:
    """The solves of one sim step of ``env_id`` at full width from its
    bundled ``<split>_00`` snapshot (no randomization, zero action), captured
    at the wrappers as the solver hands them over: ``wrappers`` maps a name
    to ``(module, attribute)``; returns every call of each as ``(args,
    kwargs)`` with the tensors cloned, in order."""
    import numpy as np

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.types import EnvMode

    env = fluidgym_tpu_torch.make(env_id, device=dev, randomize_initial_state=False,
                                  step_length=step_length, episode_length=2)
    env.mode = EnvMode(split)
    env.reset(seed=0)
    a_shape = ((env.n_agents, 1) if env.use_marl
               else tuple(env.action_space.shape))
    return capture_calls(lambda: env.step(np.zeros(a_shape, np.float32)),
                         wrappers)


def capture_calls(run, wrappers, first: bool = False) -> dict:
    """Every call of the wrappers ``wrappers`` (name -> ``(module,
    attribute)``) while ``run()`` runs, as ``(args, kwargs)`` with the
    tensors cloned, in order; with ``first``, only the first call of each
    (later calls pass through uncopied: a full-width Airfoil3D sim step
    makes ~90 calls of ~250 MB of operands each)."""
    seen = {k: [] for k in wrappers}
    def keep(v):
        if isinstance(v, tuple):  # a named tuple keeps its type
            vals = tuple(keep(t) for t in v)
            return type(v)(*vals) if hasattr(v, "_fields") else vals
        return v.clone() if hasattr(v, "clone") else v
    fns = {k: getattr(mod, attr) for k, (mod, attr) in wrappers.items()}
    for k, (mod, attr) in wrappers.items():
        def capture(*a, _fn=fns[k], _k=k, **kw):
            if not (first and seen[_k]):
                seen[_k].append((keep(a), {n: keep(v) for n, v in kw.items()}))
            return _fn(*a, **kw)

        # the wrapper counts its launches on the object its module's name
        # holds: share the counters with it
        capture.__dict__ = fns[k].__dict__
        setattr(mod, attr, capture)
    try:
        run()
    finally:
        for k, (mod, attr) in wrappers.items():
            setattr(mod, attr, fns[k])
    return seen


def _captured_systems(dev, env_id) -> dict:
    """The solves of the first substep of one sim step of ``env_id``
    (``_capture_solves``): ``"K1"`` the first pressure solve, ``"K2"`` the
    temperature and the velocity solves."""
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    seen = _capture_solves(dev, env_id, 0.05, {
        "K1": (cg_cuda, "fused_cg"),
        "K2": (cg_cuda_mb, "fused_bicgstab_mb")})
    return {"K1": seen["K1"][0], "K2": seen["K2"][:2]}


def spread_arms(torch, cg_cuda, launcher, lanes: int, n: int, ndims: int,
                algo: str, reps: int = 3, extra=None, merged: bool = False,
                runs: int = 1) -> dict:
    """The chunk grid and the spread arm of one system, in turns:
    ``launcher(G, chains)`` gives a raw launch on preallocated buffers (G =
    0: the chunk grid).  The spread arm runs at every G in
    ``cg_cuda.SPREAD_SIZES`` whose grid the card holds for ``lanes`` lanes,
    in both layouts (``chains``: each block the cells of its sum chains;
    else a contiguous range, 3D only); each must return the chunk grid's x,
    iterations and residual bit for bit, ``runs`` times back to back.  Then
    ms per raw launch of every arm, in turns (forward, then backward).
    ``merged``: a 3D merged lane (K3 / K2-mb: the merged instances'
    co-residency and layout rule).  Returns the rule's G and layout, the
    iterations, ms and us per iteration per arm.  ``extra``: more raw
    launches by name (another revision's chunk grid), held and timed
    alike."""
    dev = torch.device("cuda")
    kind = algo + "_mb" if merged else algo
    arms = {"grid": launcher(0, None), **(extra or {})}
    for G in cg_cuda.SPREAD_SIZES:
        if lanes * G > cg_cuda.spread_capacity(kind, ndims, G, True, n, dev):
            continue
        for chains in (True, False) if ndims == 3 else (True,):
            arms[f"G={G} {'chains' if chains else 'range'}"] = launcher(G, chains)
    turns = arms_in_turns(torch, arms, reps, runs)
    ms, its = turns["raw_ms"], turns["iterations"]
    G = cg_cuda.default_spread(lanes, n, ndims, 1, dev, kind)
    layout = "chains" if cg_cuda.spread_chains(n, G, ndims, merged) else "range"
    rule = f"G={G} {layout}" if G else "grid"
    return dict(iterations=its, rule=rule, raw_ms=ms,
                us_per_it={k: v * 1e3 / max(its, 1) for k, v in ms.items()})


def _k3d_phase(dev, kernels, compare) -> None:
    """Phase 25: K1-3D and K2-3D against their plain versions on the solves
    of a first substep of RBC3D-easy and RBC3D-wide-easy at full width from
    their bundled snapshots (``_captured_systems``), with phases 3 and 4's
    bars: K1 on the pressure system (1 lane) and with a second, random
    right-hand side beside it (2 lanes); K2 on the temperature (1 lane) and
    velocity (3 lanes) systems as the solver starts them.  On each, the
    spread arm at every G the card holds, in both layouts, bit-equal to the
    chunk grid and timed against it in turns (``spread_arms``).  ms per
    wrapper call (the rule's arm: the spread arm), per raw launch of each
    arm, us per iteration, the plain version's ms and the bound."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    rows = {"K1-3D": {}, "K2-3D": {}}
    errs = {"K1-3D": 0.0, "K2-3D": 0.0}

    def timed(name, key, call, plain, launcher, n, lanes, its, algo, warm):
        arms = spread_arms(torch, cg_cuda, launcher, lanes, n, 3, algo)
        b_ms, by, stream = bound_ms(n, lanes, 3, its, algo, warm, True)
        raw, grid = arms["raw_ms"][arms["rule"]], arms["raw_ms"]["grid"]
        row = dict(iterations=its, ms=cuda_ms(torch, call, 3), raw_ms=raw,
                   us_per_it=raw * 1e3 / max(its, 1), raw_ms_grid=grid,
                   us_per_it_grid=grid * 1e3 / max(its, 1),
                   plain_ms=cuda_ms(torch, plain, 1), bound_ms=b_ms,
                   bound_by=by, stream_ms=stream, arms=arms)
        rows[name][key] = row
        log(f"  {name} {key}: {row['ms']:.3f} ms per wrapper call; raw launch "
            f"{arms['rule']} {raw:.3f} ms = {row['us_per_it']:.2f} us/iteration"
            f", chunk grid {grid:.3f} ms = {row['us_per_it_grid']:.2f} "
            f"({grid / raw:.2f}x) at {its} iterations; every arm bit-equal, "
            f"raw ms {json.dumps({k: round(v, 4) for k, v in arms['raw_ms'].items()})}"
            f" (plain {row['plain_ms']:.3f} ms; bound {b_ms * 1e3:.3f} us by "
            f"{by}, streaming {stream * 1e3:.3f} us)")

    for env_id in RBC3D_IDS:
        sy = _captured_systems(dev, env_id)
        (diag, off, p_rhs, x0), kw1 = sy["K1"]
        tol = kw1.pop("tol")
        shape = tuple(p_rhs.shape[1:])
        n = math.prod(shape)
        tol2 = cg_cuda.tol2_sum_f32(tol, n)
        check(kw1["ndims"] == 3 and x0 is None, f"{env_id}: the pressure solve "
              f"is not a cold 3D solve ({kw1})")
        mv_p = lambda v: cg_cuda.roll_matvec(diag[None], off[None], v, 3)
        g = torch.Generator().manual_seed(25)
        other = torch.randn(shape, generator=g).to(dev) * p_rhs.abs().max()
        for b in (p_rhs, torch.stack([p_rhs[0], other - other.mean()])):
            L = b.shape[0]

            def call(b=b):
                x, inf = cg_cuda.fused_cg(diag, off, b, tol=tol, **kw1)
                return x, inf.iterations, inf.residual ** 2 * n

            def plain(b=b):
                return cg_cuda.fused_cg_plain(diag[None], off[None], b, None,
                                              tol2_sum=tol2, chunk=1, **kw1)

            key = f"{shape} {L} lane(s)"
            e, it = compare(f"K1-3D {key}", call, plain, b, tol, 1e-3, 3, mv_p)
            errs["K1-3D"] = max(errs["K1-3D"], e)
            timed("K1-3D", key, call, plain,
                  lambda G, chains, b=b: cg_cuda.launcher(
                      diag[None], off[None], b, None, chunk=1, spread=G,
                      chains=chains, tol2_sum=tol2, **kw1), n, L, it, "cg",
                  False)
        for what, ((plan, diags, offs, bs), kw2) in zip(
                ("temperature", "velocity"), sy["K2"]):
            tol, x0s = kw2.pop("tol"), kw2.pop("x0s", None)
            d, o, b = diags[0], offs[0], bs[0]
            x0 = None if x0s is None else x0s[0]
            mv_a = lambda v, d=d, o=o: cg_cuda.roll_matvec(d[None], o[None], v, 3)

            def call(b=b, x0=x0, d=d, o=o, kw2=kw2, tol=tol):
                xs, inf = cg_cuda_mb.fused_bicgstab_mb(
                    plan, (d,), (o,), (b,), None if x0 is None else (x0,),
                    tol=tol, **kw2)
                return xs[0], inf.iterations.repeat(b.shape[0]), None

            def plain(b=b, x0=x0, d=d, o=o, kw2=kw2, tol=tol):
                return cg_cuda_mb.fused_bicgstab_plain(
                    d[None], o[None], b, x0, ndims=3,
                    tol2_sum=cg_cuda.tol2_sum_f32(tol, n), **kw2)

            key = f"{shape} {what} {b.shape[0]} lane(s)"
            e, it = compare(f"K2-3D {key}", call, plain, b, tol, 1e-4, 2, mv_a)
            errs["K2-3D"] = max(errs["K2-3D"], e)
            timed("K2-3D", key, call, plain,
                  lambda G, chains, b=b, x0=x0, d=d, o=o, kw2=kw2, tol=tol:
                  cg_cuda_mb.launcher(
                      d[None], o[None], b, x0, ndims=3, chunk=1, spread=G,
                      chains=chains, tol2_sum=cg_cuda.tol2_sum_f32(tol, n),
                      **kw2), n, b.shape[0], it, "bicgstab", x0 is not None)
    for name, main, what in (
            ("K1-3D", "(64, 41, 64) 1 lane(s)", "Jacobi-PCG, 7-point roll stencil"),
            ("K2-3D", "(64, 41, 64) velocity 3 lane(s)",
             "right-Jacobi BiCGStab, trivial plan")):
        r = rows[name][main]
        common = dict(
            route="cuda",
            source=("fluidgym_tpu_torch/csrc/cg.cu" if name == "K1-3D"
                    else "fluidgym_tpu_torch/csrc/bicgstab_mb.cu"),
            replaces=("fluidgym_tpu/ops/cg_pallas.py:143" if name == "K1-3D"
                      else "fluidgym_tpu/ops/cg_pallas_mb.py:458"),
            max_abs_err=errs[name], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            iterations=r["iterations"], shape=main)
        # one entry per TPU kernel, of the arm the main path runs (the
        # spread arm); the chunk grid's raw launch, timed beside it in
        # turns, only as raw_ms_grid / us_per_it_grid
        kernels[name] = dict(
            common, name=f"{name} ({what}, the spread arm, "
                         f"{r['arms']['rule']})",
            source=common["source"] + " + fluidgym_tpu_torch/csrc/krylov.cuh",
            ms=r["ms"], raw_ms=r["raw_ms"], us_per_it=r["us_per_it"],
            arm=f"spread {r['arms']['rule']}",
            raw_ms_grid=r["raw_ms_grid"], us_per_it_grid=r["us_per_it_grid"],
            speedup_over_grid=r["raw_ms_grid"] / r["raw_ms"],
            wide={k: {x: v[x] for x in ("raw_ms", "raw_ms_grid", "us_per_it",
                                        "us_per_it_grid", "ms", "plain_ms",
                                        "bound_ms")}
                  for k, v in rows[name].items() if "(128" in k},
            systems=rows[name])
    for name in ("K1-3D", "K2-3D"):
        wide = [v for k, v in rows[name].items()
                if "(128" in k and (name == "K1-3D" or "velocity" in k)][0]
        check(wide["raw_ms"] < wide["raw_ms_grid"],
              f"{name} at (128, 41, 128): the spread arm ({wide['raw_ms']:.3f} "
              f"ms per raw launch) is not faster than the chunk grid "
              f"({wide['raw_ms_grid']:.3f} ms)")
    log(f"phase 25 K1-3D and K2-3D ok on {len(rows['K1-3D'])} + "
        f"{len(rows['K2-3D'])} systems: the spread arm bit-equal to the "
        f"chunk grid at every G and layout, faster at (128, 41, 128), in "
        f"{time.perf_counter() - t0:.1f}s")


def _rbc_main_path(dev, piso, linsolve, env_id, steps, ph, **make_kw) -> dict:
    """``make(env_id, **make_kw)`` on the card at the registered full width,
    ``reset(seed=0)`` (randomized: noise and a 1-2 time-unit burn-in), then
    ``steps`` steps with seeded numpy actions.  Every counter is zeroed just
    before ``make`` and read after each step: in every step K1 launches
    once per pressure corrector per substep and K2 once per advection solve
    (temperature, velocity), in 3D every one of them a 3D launch; the
    resident arm takes them exactly where ``default_resident`` admits the
    block (never in 3D), the spread arm exactly where ``default_spread``
    gives G (every RBC3D solve); no other kernel form, plain version or
    ``linsolve`` loop runs; obs of the space's shapes, obs, reward and
    Nusselt finite."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    k1, k2 = cg_cuda.fused_cg, cg_cuda_mb.fused_bicgstab_mb
    launches, plains = _counters()
    extra = [(k, a) for k in (k1, k2)
             for a in ("launches_3d", "resident_launches", "spread_launches")]
    calls, restore = count_calls(piso, linsolve)

    def counts():
        out = {"K1": k1.launches, "K2": k2.launches, "K1 3d": k1.launches_3d,
               "K2 3d": k2.launches_3d, "K1 resident": k1.resident_launches,
               "K2 resident": k2.resident_launches,
               "K1 spread": k1.spread_launches, "K2 spread": k2.spread_launches}
        out["other"] = sum(getattr(*c) for c in launches) - out["K1"] - out["K2"]
        out["plain"] = sum(getattr(*c) for c in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        return out

    for c in launches + plains + extra:
        setattr(*c, 0)
    torch.cuda.synchronize()
    rows = []
    try:
        t = time.perf_counter()
        env = fluidgym_tpu_torch.make(env_id, **make_kw)
        env.reset(seed=0)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        reset = counts()
        nd, shape = env.ndims, env._topo.blocks[0].shape
        n = math.prod(shape)
        resident = cg_cuda.default_resident(1, n, nd, 1, dev)
        # the arm of each solve: K1 (1 lane), K2's scalars (1 lane) and its
        # velocity (nd lanes)
        spread = {"K1": cg_cuda.roll_arm(1, n, nd, 1, dev)[1],
                  "K2 scalar": cg_cuda.roll_arm(1, n, nd, 1, dev, "bicgstab")[1],
                  "K2 velocity": cg_cuda.roll_arm(nd, n, nd, 1, dev,
                                                  "bicgstab")[1]}
        rng = np.random.default_rng(ph)
        a_shape = ((env.n_agents, 1) if env.use_marl
                   else tuple(env.action_space.shape))
        for i in range(steps):
            a = rng.uniform(-1, 1, a_shape).astype(np.float32)
            c0 = counts()
            t = time.perf_counter()
            obs, reward, _, _, info = env.step(a)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            d = {k: v - c0[k] for k, v in counts().items()}
            sub = d["substeps"]
            expect = {"K1": env._cfg.corrector_steps * sub,
                      "K2": (env._topo.scalar_channels + 1) * sub}
            for k in ("K1", "K2"):
                expect[f"{k} 3d"] = expect[k] if nd == 3 else 0
                expect[f"{k} resident"] = expect[k] if resident else 0
            expect["K1 spread"] = expect["K1"] if spread["K1"] else 0
            expect["K2 spread"] = sub * (
                env._topo.scalar_channels * bool(spread["K2 scalar"])
                + bool(spread["K2 velocity"]))
            expect.update(other=0, plain=0, linsolve=0)
            check(sub > 0 and all(d[k] == v for k, v in expect.items()),
                  f"{env_id} step {i}: launches {d}, expected {expect}")
            for k, v in obs.items():
                want = env.observation_space[k].shape
                if env.use_marl:
                    want = (env.n_agents,) + tuple(want)
                check(tuple(v.shape) == tuple(want), f"{env_id} obs {k} shape "
                      f"{tuple(v.shape)} != {want}")
                check(bool(torch.isfinite(v).all()), f"{env_id} obs {k} not finite")
            nu = float(info["nusselt"])
            check(bool(torch.isfinite(reward).all()) and math.isfinite(nu)
                  and nu > 0, f"{env_id}: reward or Nusselt {nu} not finite")
            rows.append(dict(s=step_s, substeps=sub, K1=d["K1"], K2=d["K2"],
                             pressure_iterations=int(info["pressure_iterations"]),
                             pressure_converged=bool(info["pressure_converged"]),
                             nusselt=nu))
    finally:
        restore()
    total = counts()
    arm = ("resident" if resident else
           f"spread G={spread['K1']}/{spread['K2 scalar']}/"
           f"{spread['K2 velocity']}" if spread["K1"] else "global")
    out = dict(env_id=env_id, shape=tuple(shape), marl=env.use_marl,
               n_agents=env.n_agents, arm=arm,
               reset_s=reset_s, reset_launches={k: reset[k] for k in ("K1", "K2")},
               ms_step=1e3 * sum(r["s"] for r in rows) / len(rows),
               substeps=[r["substeps"] for r in rows],
               pressure_iterations=[r["pressure_iterations"] for r in rows],
               pressure_converged=[r["pressure_converged"] for r in rows],
               nusselt=[round(r["nusselt"], 5) for r in rows],
               launches={k: total[k] for k in (
                   "K1", "K2", "K1 3d", "K2 3d", "K1 resident", "K2 resident",
                   "K1 spread", "K2 spread")},
               step_launches=[{k: r[k] for k in ("K1", "K2")} for r in rows])
    log(f"phase {ph} {env_id} {out['shape']} "
        f"({'MARL, ' + str(env.n_agents) + ' agents' if env.use_marl else 'SARL'}): "
        f"reset {reset_s:.2f}s (launches {out['reset_launches']}), steps "
        f"{[round(r['s'], 3) for r in rows]} s = {out['ms_step']:.1f} ms/env "
        f"step, substeps {out['substeps']}, pressure iterations "
        f"{out['pressure_iterations']} (converged {out['pressure_converged']}), "
        f"Nusselt {out['nusselt']}, per-step launches {out['step_launches']}, "
        f"totals {out['launches']}, arm {out['arm']}; no other form, plain "
        f"version or linsolve loop")
    return out


def _rbc3d_card_vs_host(dev) -> float:
    """Phase 27: one full-width RBC3D-easy-v0 sim step (``step_length`` =
    dt, the bundled ``train_00``, MARL at the registered defaults) on the
    card and on the host: obs and rewards within 1e-4 of each quantity's
    scale (the rollout bar)."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch

    t0 = time.perf_counter()
    kw = dict(randomize_initial_state=False, step_length=0.05, episode_length=2)
    a = np.linspace(-1, 1, 64, dtype=np.float32).reshape(64, 1)
    outs = {}
    for where in (dev, torch.device("cpu")):
        e = fluidgym_tpu_torch.make("RBC3D-easy-v0", device=where, **kw)
        e.reset(seed=0)
        o, r, _, _, info = e.step(a)
        outs[where.type] = dict(o, reward=r, nusselt=info["nusselt"].reshape(1))
    worst = {}
    for k, c in outs["cpu"].items():
        g = outs[dev.type][k].cpu()
        worst[k] = float((g - c).abs().max() / c.abs().max().clamp(min=1e-30))
    log(f"phase 27 RBC3D-easy-v0 full width, 1 sim step from the bundled "
        f"snapshot, card vs host: relative diffs {worst} (bar 1e-4) in "
        f"{time.perf_counter() - t0:.1f}s")
    check(all(v <= 1e-4 for v in worst.values()),
          f"RBC3D card and host disagree: {worst}")
    return max(worst.values())


def _rbc_phases(dev, kernels, compare, piso, linsolve) -> None:
    """Phases 25-31: K1-3D and K2-3D against their plain versions and the
    spread arm against the chunk grid (25); the RBC3D-easy-v0 main path, 3
    MARL steps (its default) and 1 SARL step (26); RBC3D card against host
    (27); RBC3D-wide-easy-v0, 1 step (28), every RBC3D solve on the spread
    arm; the five other RBC2D ids, 2 steps each (29); the other four RBC3D
    ids (30): ``make`` at the registered defaults on the card, then, as
    their datasets need not be present, 1 step from a conduction state at
    full width with phase 26's checks; the spread arm's end-to-end A/B
    (31)."""
    _k3d_phase(dev, kernels, compare)
    runs = [_rbc_main_path(dev, piso, linsolve, "RBC3D-easy-v0", 3, 26),
            _rbc_main_path(dev, piso, linsolve, "RBC3D-easy-v0", 1, 26,
                           use_marl=False)]
    host = _rbc3d_card_vs_host(dev)
    wide = _rbc_main_path(dev, piso, linsolve, "RBC3D-wide-easy-v0", 1, 28)
    for r in runs + [wide]:
        check(r["arm"].startswith("spread") and r["launches"]["K1 spread"]
              == r["launches"]["K1 3d"] > 0 and r["launches"]["K2 spread"]
              == r["launches"]["K2 3d"] > 0,
              f"{r['env_id']}: not every K1-3D / K2-3D launch took the spread "
              f"arm: {r['arm']}, {r['launches']}")
    for name, k in (("K1-3D", "K1"), ("K2-3D", "K2")):
        e = kernels[name]
        # the spread arm's launches in the runs (resets included; every 3D
        # launch, as checked above); per env step without the resets
        e["launches"] = sum(r["launches"][f"{k} spread"] for r in runs)
        steps = [d[k] for r in runs for d in r["step_launches"]]
        e["launches_per_env_step"] = sum(steps) / len(steps)
        e["main_path"] = {
            f"{r['env_id']} {'MARL' if r['marl'] else 'SARL'}":
            {x: r[x] for x in ("ms_step", "reset_s", "substeps",
                               "pressure_iterations", "arm")}
            for r in runs + [wide]}
        e["wide_launches"] = wide["launches"][f"{k} spread"]
        e["card_vs_host"] = host
    t0 = time.perf_counter()
    ids = [_rbc_main_path(dev, piso, linsolve, env_id, 2, 29)
           for env_id in RBC2D_IDS]
    log(f"phase 29 RBC2D ids ok in {time.perf_counter() - t0:.1f}s: "
        + json.dumps({r["env_id"]: {x: r[x] for x in (
            "shape", "arm", "ms_step", "reset_s", "substeps",
            "pressure_iterations", "launches")} for r in ids}))
    t0 = time.perf_counter()
    import fluidgym_tpu_torch

    for env_id in RBC3D_OTHER_IDS:
        env = fluidgym_tpu_torch.make(env_id)
        check(env.device.type == dev.type and env.ndims == 3,
              f"{env_id}: make put it on {env.device}")
        _rbc_main_path(dev, piso, linsolve, env_id, 1, 30,
                       load_initial_domain=False, load_domain_statistics=False,
                       randomize_initial_state=False)
    log(f"phase 30 the other RBC3D ids ok in {time.perf_counter() - t0:.1f}s")
    _spread_ab_phase(dev, kernels)

# ---------------------------------------------------------------------------
# phase 31: the spread arm against the chunk grid, end to end
# ---------------------------------------------------------------------------

#: phase 31's ids and env steps per arm; RBC2D-wide-easy-v0's (61, 192)
#: lanes run the spread arm pinned to G = 32, the rule's G for them (11,712
#: cells: 366 per block, at least SPREAD_MIN_CELLS; too few for G = 64)
SPREAD_AB = (("RBC3D-easy-v0", 2, None), ("RBC3D-wide-easy-v0", 1, None),
             ("RBC2D-wide-easy-v0", 1, 32))


def spread_env_ab(dev, env_id: str, steps: int, pin=None) -> dict:
    """``env_id`` at its registered defaults on the card, ``reset(seed=0)``,
    then four arms in turns from that one state (``set_state``): the chunk
    grid (``cg_cuda.pinned_spread(0)``), the spread arm, the spread arm, the
    chunk grid, each taking the same seeded actions.  ``pin``: the spread
    arm's G (None: the rule's).  Every arm's obs must be bit-equal to the
    first's (the spread arm computes the chunk grid's bits), the chunk
    grid's arms launch no spread arm and the spread arms nothing else.
    Returns ms per env step per arm (host clock around ``step``, ending in
    a device synchronise), the pressure iterations and launches."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    k1, k2 = cg_cuda.fused_cg, cg_cuda_mb.fused_bicgstab_mb
    count = lambda: (k1.launches, k2.launches, k1.spread_launches,
                     k2.spread_launches)
    env = fluidgym_tpu_torch.make(env_id)
    env.reset(seed=0)
    start = env.get_state()
    rng = np.random.default_rng(31)
    a_shape = ((env.n_agents, 1) if env.use_marl
               else tuple(env.action_space.shape))
    actions = [rng.uniform(-1, 1, a_shape).astype(np.float32)
               for _ in range(steps)]
    rows, first = [], None
    for arm in ("grid", "spread", "spread", "grid"):
        with cg_cuda.pinned_spread(0 if arm == "grid" else pin):
            env.set_state(start)
            c0 = count()
            step_ms, its = [], []
            for a in actions:
                torch.cuda.synchronize()
                t = time.perf_counter()
                obs, _, _, _, info = env.step(a)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t))
                its.append(int(info["pressure_iterations"]))
        d = [b - a for a, b in zip(c0, count())]
        first = obs if first is None else first
        check(all(torch.equal(obs[k], first[k]) for k in obs),
              f"{env_id} {arm} arm: obs differ from the first arm's")
        spread_all = d[2] == d[0] > 0 and d[3] == d[1] > 0
        check(spread_all if arm == "spread" else d[2] == d[3] == 0,
              f"{env_id} {arm} arm: launches K1, K2, K1 spread, K2 spread {d}")
        rows.append(dict(arm=arm, ms_per_step=step_ms,
                         mean_ms=sum(step_ms) / len(step_ms),
                         pressure_iterations=its, launches=d))
    mean = lambda a: sum(r["mean_ms"] for r in rows if r["arm"] == a) / 2
    return dict(env_id=env_id, steps=steps, pin=pin, arms=rows,
                grid_ms=mean("grid"), spread_ms=mean("spread"),
                speedup=mean("grid") / mean("spread"))


def _spread_ab_phase(dev, kernels) -> None:
    """Phase 31: ms per env step under the spread arm and the chunk grid,
    in turns from one state (``spread_env_ab``), for RBC3D-easy-v0,
    RBC3D-wide-easy-v0 and RBC2D-wide-easy-v0 (its (61, 192) lanes pinned
    to G = 32); and RBC2D-wide's K1 lane (its first substep's pressure
    solve) per raw launch at every G against the chunk grid
    (``spread_arms``)."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda

    t0 = time.perf_counter()
    ab = {}
    for env_id, steps, pin in SPREAD_AB:
        r = ab[env_id] = spread_env_ab(dev, env_id, steps, pin)
        log(f"  {env_id}: chunk grid {r['grid_ms']:.1f} ms/env step, spread "
            f"arm{'' if pin is None else f' (pinned G = {pin})'} "
            f"{r['spread_ms']:.1f} ({r['speedup']:.2f}x); per arm "
            + ", ".join(f"{x['arm']} {[round(v, 1) for v in x['ms_per_step']]}"
                        for x in r["arms"])
            + f"; pressure iterations {r['arms'][0]['pressure_iterations']}, "
              f"obs bit-equal across the arms")
    (diag, off, b, x0), kw1 = _captured_systems(dev, "RBC2D-wide-easy-v0")["K1"]
    tol = kw1.pop("tol")
    n = math.prod(b.shape[1:])
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    lane = spread_arms(torch, cg_cuda, lambda G, chains: cg_cuda.launcher(
        diag[None], off[None], b, x0, chunk=1, spread=G, chains=chains,
        tol2_sum=tol2, **kw1), 1, n, 2, "cg", reps=10)
    log(f"  RBC2D-wide-easy-v0 K1 lane {tuple(b.shape[1:])} at "
        f"{lane['iterations']} iterations, ms per raw launch "
        + json.dumps({k: round(v, 4) for k, v in lane["raw_ms"].items()})
        + f" (the rule: {lane['rule']})")
    kernels["K1-3D"]["main_path_ab"] = ab
    kernels["K1-3D"]["rbc2d_wide_k1_lane"] = lane
    log(f"phase 31 spread arm A/B ok in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phases 32-35: CylinderJet3D (the 3D merged forms K3-3D and K2-mb-3D)
# ---------------------------------------------------------------------------

CYL3D_EASY, CYL3D_MEDIUM = "CylinderJet3D-easy-v0", "CylinderJet3D-medium-v0"

#: phase 34's bars, relative to each quantity's scale: the rollout bar,
#: except the pressure obs.  A float32 step decides it only to ~1e-4: on
#: the host alone the summation order (1 thread against all of them, which
#: phase 34 measures beside the card) moves it ~6e-5, against ~2e-7 for the
#: velocity; a wrong seam or z wrap moves it O(1), which 1e-3 still catches
CYL3D_HOST_BARS = dict(velocity=1e-4, pressure=1e-3, reward=1e-4)


def _captured_merged(dev, env_id, split: str = "train") -> dict:
    """The solves of the first substep of one sim step of ``env_id``
    (``_capture_solves``): ``"K3"`` the first pressure solve (warm from the
    deflated guess), ``"K2"`` the velocity advection solve."""
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    seen = _capture_solves(dev, env_id, 0.01, {
        "K3": (cg_cuda_mb, "fused_cg_mb"),
        "K2": (cg_cuda_mb, "fused_bicgstab_mb")}, split)
    return {"K3": seen["K3"][0], "K2": seen["K2"][0]}


def _cyl3d_kernel_phase(dev, kernels, compare) -> None:
    """Phase 32: K3-3D and K2-mb-3D against their plain versions on the
    captured solves of CylinderJet3D-easy (``_captured_merged``): the
    pressure solve cold and warm, a 3-lane pressure run past iteration 100,
    the velocity solve (3 lanes).  On each, the spread arm at every G the
    card holds for the lanes, in both layouts, bit-equal to the chunk grid
    twice and timed against it per raw launch in turns (``spread_arms``);
    ms per wrapper call (the rule's arm), the plain version's ms, the
    bound.  Then the medium width's first pressure solve (749,568 cells):
    against the plain version and on every arm alike."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    sy = _captured_merged(dev, CYL3D_EASY)
    (plan, diags, offs, bs), kw3 = sy["K3"]
    x0s, tol = kw3.pop("x0s"), kw3.pop("tol")
    kw3.pop("coarse_strips", None)
    n = sum(math.prod(sb.shape) for sb in plan.superblocks)
    check(plan.ndims == 3 and plan.identity_seams and len(plan.superblocks) == 2
          and n == 341568 and x0s is not None,
          f"the captured pressure solve is not the 3D merged warm solve: "
          f"{plan.ndims}D, {len(plan.superblocks)} super-blocks, {n} cells")
    C = {algo: cg_cuda_mb.default_cluster(L, n, 3, 1, dev, algo)
         for algo, L in (("cg", 1), ("bicgstab", 3))}
    check(C == {"cg": 1, "bicgstab": 1}, f"default_cluster picks {C}, not 1")
    arm = {algo: cg_cuda_mb.merged_arm(L, n, 3, 1, dev, algo)
           for algo, L in (("cg", 1), ("bicgstab", 3))}
    check(arm == {"cg": (1, 128, False), "bicgstab": (1, 32, False)},
          f"merged_arm picks {arm}, not G = 128 for K3 and 32 for K2-mb")
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    b1 = cg_cuda_mb.flatten_fields(plan, tuple(b.unsqueeze(0) for b in bs))
    g1 = cg_cuda_mb.flatten_fields(plan, tuple(x.unsqueeze(0) for x in x0s))
    try:
        cg_cuda_mb.merged_launcher("cg", plan, diag, off, b1, g1, tol2_sum=tol2,
                                   chunk=1, cluster=2, **kw3)
        refused = False
    except ValueError:
        refused = True
    check(refused, "the K3-3D launcher took cluster 2, whose rows do not fit")
    mv3 = cg_cuda_mb._merged_mv(plan, diag, off)
    errs, rows = {"K3-3D": 0.0, "K2-mb-3D": 0.0}, {}

    def run(name, key, algo, plan, b, x0, tol, kw, ops, rel, it_tol, mv, reps):
        """One system on flat ``(lanes, n)`` tensors: the wrapper call
        against the plain version (``compare``, and the same converged
        flags), then every arm bit for bit and per raw launch in turns
        (``spread_arms``), ms per wrapper call and the bound."""
        d, o, dg, of = ops
        nc = b.shape[1]
        last = {}
        wrap = (cg_cuda_mb.fused_cg_mb if algo == "cg"
                else cg_cuda_mb.fused_bicgstab_mb)
        t2 = cg_cuda.tol2_sum_f32(tol, nc)

        def call():
            xs, inf = wrap(plan, dg, of, cg_cuda_mb.unflatten_fields(plan, b),
                           None if x0 is None
                           else cg_cuda_mb.unflatten_fields(plan, x0),
                           tol=tol, chunk=1, **kw)
            x = cg_cuda_mb.flatten_fields(plan, xs)
            if algo == "cg":
                out = (x, inf.iterations, inf.residual ** 2 * nc)
                last["kern"] = inf.converged
            else:
                out = (x, inf.iterations.repeat(b.shape[0]), None)
                last["kern"] = inf.converged.repeat(b.shape[0])
            return out

        def plain():
            if algo == "cg":
                out = cg_cuda_mb.fused_cg_mb_plain(plan, d, o, b, x0,
                                                   tol2_sum=t2, chunk=1, **kw)
            else:
                out = cg_cuda_mb.fused_bicgstab_plain(d, o, b, x0, ndims=3,
                                                      plan=plan, tol2_sum=t2,
                                                      chunk=1, **kw)
            zero = (b == 0).all(dim=1)
            last["plain"] = (out[2] <= t2) | zero
            if algo != "cg":  # the wrapper reports over every component
                last["plain"] = last["plain"].all().repeat(b.shape[0])
                out = (out[0], out[1].max().repeat(b.shape[0]), out[2])
            return out

        e, it = compare(f"{name} {key}", call, plain, b, tol, rel, it_tol, mv)
        check(torch.equal(last["kern"].cpu(), last["plain"].cpu()),
              f"{name} {key}: converged flags {last['kern'].tolist()} (kernel) "
              f"!= {last['plain'].tolist()} (plain)")
        errs[name] = max(errs[name], e)
        L = b.shape[0]
        arms = spread_arms(
            torch, cg_cuda, lambda G, chains: cg_cuda_mb.merged_launcher(
                algo, plan, d, o, b, x0, tol2_sum=t2, chunk=1, spread=G,
                chains=chains, **kw), L, nc, 3, algo, reps=reps, merged=True,
            runs=2)
        raw, grid = arms["raw_ms"][arms["rule"]], arms["raw_ms"]["grid"]
        b_ms, by, stream = bound_ms(nc, L, 3, it, algo, x0 is not None, True,
                                    _seam_cells(plan))
        row = dict(iterations=it, converged=last["kern"].tolist(),
                   ms=cuda_ms(torch, call, reps), raw_ms=raw,
                   us_per_it=raw * 1e3 / max(it, 1), raw_ms_grid=grid,
                   us_per_it_grid=grid * 1e3 / max(it, 1),
                   plain_ms=cuda_ms(torch, plain, 1), bound_ms=b_ms,
                   bound_by=by, stream_ms=stream, arms=arms)
        log(f"  {name} {key}: {row['ms']:.3f} ms per wrapper call; raw launch "
            f"{arms['rule']} {raw:.3f} ms = {row['us_per_it']:.2f} us/iteration"
            f", chunk grid {grid:.3f} ms = {row['us_per_it_grid']:.2f} "
            f"({grid / raw:.2f}x) at {it} iterations; every arm bit-equal "
            f"twice, raw ms "
            f"{json.dumps({k: round(v, 4) for k, v in arms['raw_ms'].items()})}"
            f" (plain {row['plain_ms']:.3f} ms; bound {b_ms * 1e3:.3f} us by "
            f"{by}, streaming {stream * 1e3:.3f} us)")
        rows.setdefault(name, {})[key] = row
        return it

    ops3 = (diag, off, diags, offs)
    run("K3-3D", "cold (1, 341568)", "cg", plan, b1, None, tol, kw3, ops3,
        1e-3, 3, mv3, 3)
    run("K3-3D", "warm (1, 341568)", "cg", plan, b1, g1, tol, kw3, ops3, 1e-3,
        3, mv3, 3)
    g = torch.Generator().manual_seed(32)
    rand = torch.randn(n, generator=g).to(dev) * b1.abs().max()
    b3 = torch.stack([rand - rand.mean(), 1e-3 * b1[0], torch.zeros_like(b1[0])])
    it3 = run("K3-3D", "3 lanes (3, 341568)", "cg", plan, b3, None, tol, kw3,
              ops3, 1e-3, 3, mv3, 1)
    check(it3 > 100, f"the 3-lane K3-3D run stopped at iteration {it3} (<= 100)")
    (plan2, adiags, aoffs, bvs), kw2 = sy["K2"]
    check(plan2 == plan and bvs[0].shape[0] == 3,
          "the captured advection solve is not the 3-lane 3D merged solve")
    xvs, tol_a = kw2.pop("x0s"), kw2.pop("tol")
    adiag, aoff = cg_cuda_mb.flatten_ops(plan, adiags, aoffs)
    bv = cg_cuda_mb.flatten_fields(plan, bvs)
    xv = None if xvs is None else cg_cuda_mb.flatten_fields(plan, xvs)
    run("K2-mb-3D", "velocity (3, 341568)", "bicgstab", plan, bv, xv, tol_a,
        kw2, (adiag, aoff, adiags, aoffs), 1e-4, 2,
        cg_cuda_mb._merged_mv(plan, adiag, aoff), 3)
    # the medium width's first pressure solve (warm from the deflated guess)
    (mplan, mdiags, moffs, mbs), kwm = _captured_merged(dev, CYL3D_MEDIUM)["K3"]
    mx0s, mtol = kwm.pop("x0s"), kwm.pop("tol")
    kwm.pop("coarse_strips", None)
    nm = sum(math.prod(sb.shape) for sb in mplan.superblocks)
    check(nm == 749568 and mplan.ndims == 3 and mx0s is not None,
          f"the medium pressure solve is not the 3D merged warm solve ({nm})")
    check(cg_cuda_mb.merged_arm(1, nm, 3, 1, dev, "cg") == (1, 128, False),
          "merged_arm does not pick G = 128 for the medium K3 lane")
    mdiag, moff = cg_cuda_mb.flatten_ops(mplan, mdiags, moffs)
    mb = cg_cuda_mb.flatten_fields(mplan, tuple(b.unsqueeze(0) for b in mbs))
    mg = cg_cuda_mb.flatten_fields(mplan, tuple(x.unsqueeze(0) for x in mx0s))
    run("K3-3D", "medium warm (1, 749568)", "cg", mplan, mb, mg, mtol, kwm,
        (mdiag, moff, mdiags, moffs), 1e-3, 3,
        cg_cuda_mb._merged_mv(mplan, mdiag, moff), 3)
    for name, key in (("K3-3D", "warm (1, 341568)"),
                      ("K3-3D", "medium warm (1, 749568)"),
                      ("K2-mb-3D", "velocity (3, 341568)")):
        r = rows[name][key]
        check(r["raw_ms"] < r["raw_ms_grid"],
              f"{name} {key}: the rule's arm {r['arms']['rule']} "
              f"({r['raw_ms']:.3f} ms per raw launch) is not faster than the "
              f"chunk grid ({r['raw_ms_grid']:.3f} ms)")
    for name, key, what, src, rep in (
            ("K3-3D", "warm (1, 341568)", "Jacobi-PCG", "cg.cu", 284),
            ("K2-mb-3D", "velocity (3, 341568)", "right-Jacobi BiCGStab",
             "bicgstab_mb.cu", 458)):
        r = rows[name][key]
        rule = r["arms"]["rule"]
        # one entry per TPU kernel, of the arm the main path runs (the
        # spread arm); the chunk grid's raw launch, timed beside it in
        # turns, only as raw_ms_grid / us_per_it_grid
        kernels[name] = dict(
            name=f"{name} ({what}, 3D merged frame: identity seams, periodic "
                 f"z; the spread arm, {rule})",
            route="cuda",
            source=f"fluidgym_tpu_torch/csrc/{src} + "
                   "fluidgym_tpu_torch/csrc/merged.cuh + "
                   "fluidgym_tpu_torch/csrc/krylov.cuh",
            replaces=f"fluidgym_tpu/ops/cg_pallas_mb.py:{rep}",
            max_abs_err=errs[name], ms=r["ms"], raw_ms=r["raw_ms"],
            us_per_it=r["us_per_it"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            stream_ms=r["stream_ms"], library_ms=None,
            iterations=r["iterations"], arm=f"spread {rule}",
            G=int(rule.split()[0][2:]), layout=rule.split()[1],
            raw_ms_grid=r["raw_ms_grid"], us_per_it_grid=r["us_per_it_grid"],
            speedup_over_grid=r["raw_ms_grid"] / r["raw_ms"], shape=key,
            systems=rows[name])
    m = rows["K3-3D"]["medium warm (1, 749568)"]
    kernels["K3-3D"]["medium"] = {x: m[x] for x in (
        "iterations", "raw_ms", "us_per_it", "raw_ms_grid", "us_per_it_grid",
        "ms", "plain_ms", "bound_ms", "bound_by", "stream_ms")}
    kernels["K3-3D"]["medium"]["rule"] = m["arms"]["rule"]
    log(f"phase 32 K3-3D and K2-mb-3D ok: the spread arm bit-equal to the "
        f"chunk grid at every G and layout on {len(rows['K3-3D'])} + "
        f"{len(rows['K2-mb-3D'])} systems, faster at both widths (C = 1 from "
        f"default_cluster, C = 2 refused; {_seam_cells(plan)} seam cells) "
        f"in {time.perf_counter() - t0:.1f}s")


def _cyl3d_main_path(dev, piso, linsolve, env_id, steps, ph, snapshot=None,
                     k2_per_substep=1, **make_kw) -> dict:
    """``make(env_id, **make_kw)`` on the card at the registered full width,
    ``reset(seed=0)`` (or, with ``snapshot = (split, index)``, ``seed(0)``
    and ``load_initial_domain`` of that bundled file), then ``steps`` steps
    with seeded numpy actions.
    Every counter is zeroed just before ``make`` and read after each step:
    in every step K3 launches twice per substep and K2-mb ``k2_per_substep``
    times (3 where its lanes go one per launch), every one a
    3D merged launch on the spread arm (no cluster launch), and no other
    kernel form, plain version or ``linsolve`` loop runs; obs of the
    space's shapes, obs, rewards, drag and lift finite.  The result holds
    the env as the steps left it (phase 36 starts there)."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb
    from fluidgym_tpu_torch.types import EnvMode

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    launches, plains = _counters()
    extra = [(k3, "launches_3d"), (k2, "merged_launches_3d"),
             (k3, "cluster_launches"), (k2, "cluster_launches"),
             (k3, "spread_launches"), (k2, "merged_spread_launches")]
    calls, restore = count_calls(piso, linsolve)

    def counts():
        out = {"K3": k3.launches, "K2-mb": k2.merged_launches,
               "K3 3d": k3.launches_3d, "K2-mb 3d": k2.merged_launches_3d,
               "K3 spread": k3.spread_launches,
               "K2-mb spread": k2.merged_spread_launches,
               "cluster": k3.cluster_launches + k2.cluster_launches}
        out["other"] = (sum(getattr(*c) for c in launches) - out["K3"]
                        - out["K2-mb"])
        out["plain"] = sum(getattr(*c) for c in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        return out

    for c in launches + plains + extra:
        setattr(*c, 0)
    torch.cuda.synchronize()
    rows = []
    try:
        t = time.perf_counter()
        env = fluidgym_tpu_torch.make(env_id, **make_kw)
        if snapshot is None:
            env.reset(seed=0)
        else:
            env.seed(0)
            env.load_initial_domain(EnvMode(snapshot[0]), snapshot[1])
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        reset = counts()
        nb = [b.shape for b in env._topo.blocks]
        cells = sum(math.prod(s_) for s_ in nb)
        rng = np.random.default_rng(ph)
        a_shape = ((env.n_agents, 1) if env.use_marl
                   else tuple(env.action_space.shape))
        for i in range(steps):
            a = rng.uniform(-1, 1, a_shape).astype(np.float32)
            c0 = counts()
            t = time.perf_counter()
            obs, reward, _, _, info = env.step(a)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            d = {k: v - c0[k] for k, v in counts().items()}
            sub = d["substeps"]
            k2_n = k2_per_substep * sub
            expect = {"K3": 2 * sub, "K3 3d": 2 * sub, "K3 spread": 2 * sub,
                      "K2-mb": k2_n, "K2-mb 3d": k2_n, "K2-mb spread": k2_n,
                      "cluster": 0, "other": 0, "plain": 0, "linsolve": 0}
            check(sub > 0 and all(d[k] == v for k, v in expect.items()),
                  f"{env_id} step {i}: launches {d}, expected {expect}")
            for k, v in obs.items():
                want = env.observation_space[k].shape
                if env.use_marl:
                    want = (env.n_agents,) + tuple(want)
                check(tuple(v.shape) == tuple(want), f"{env_id} obs {k} shape "
                      f"{tuple(v.shape)} != {want}")
                check(bool(torch.isfinite(v).all()), f"{env_id} obs {k} not finite")
            drag, lift = float(info["drag"]), float(info["lift"])
            check(bool(torch.isfinite(reward).all()) and math.isfinite(drag)
                  and math.isfinite(lift), f"{env_id}: reward, drag {drag} or "
                  f"lift {lift} not finite")
            rows.append(dict(s=step_s, substeps=sub, K3=d["K3"], K2=d["K2-mb"],
                             pressure_iterations=int(info["pressure_iterations"]),
                             pressure_converged=bool(info["pressure_converged"]),
                             drag=drag, lift=lift))
    finally:
        restore()
    total = counts()
    out = dict(env_id=env_id, cells=cells, marl=env.use_marl,
               n_agents=env.n_agents, reset_s=reset_s,
               reset_launches={k: reset[k] for k in ("K3", "K2-mb")},
               ms_step=1e3 * sum(r["s"] for r in rows) / len(rows),
               step_ms=[1e3 * r["s"] for r in rows],
               substeps=[r["substeps"] for r in rows],
               pressure_iterations=[r["pressure_iterations"] for r in rows],
               pressure_converged=[r["pressure_converged"] for r in rows],
               drag=[round(r["drag"], 5) for r in rows],
               lift=[round(r["lift"], 5) for r in rows],
               launches={k: total[k] for k in ("K3", "K2-mb", "K3 3d",
                                               "K2-mb 3d", "K3 spread",
                                               "K2-mb spread", "cluster")},
               step_launches=[{k: r[k] for k in ("K3", "K2")} for r in rows],
               env=env)
    log(f"phase {ph} {env_id} {nb} = {cells} cells "
        f"({'MARL, ' + str(env.n_agents) + ' agents' if env.use_marl else 'SARL'}): "
        f"reset {reset_s:.2f}s (launches {out['reset_launches']}), steps "
        f"{[round(r['s'], 3) for r in rows]} s = {out['ms_step']:.1f} ms/env "
        f"step, substeps {out['substeps']}, pressure iterations "
        f"{out['pressure_iterations']} (converged {out['pressure_converged']}), "
        f"drag {out['drag']}, lift {out['lift']}, per-step launches "
        f"{out['step_launches']}, totals {out['launches']}; all 3D merged on "
        f"the spread arm, no other form, plain version or linsolve loop")
    return out


def _cyl3d_card_vs_host(dev) -> dict:
    """Phase 34: one full-width CylinderJet3D-easy-v0 sim step
    (``step_length`` = dt, the bundled ``train_00``, SARL at the registered
    defaults) on the card and on the host: obs and reward within
    ``CYL3D_HOST_BARS`` of each quantity's scale.  Beside it, the host
    against itself on one thread: how far summation order alone moves the
    same step."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch

    t0 = time.perf_counter()
    kw = dict(randomize_initial_state=False, step_length=0.01, episode_length=2)
    a = np.linspace(0.4, -0.4, 8, dtype=np.float32).reshape(8, 1)
    outs = {}
    threads = torch.get_num_threads()
    for label, where, nt in (("card", dev, threads), ("host", torch.device("cpu"),
                                                      threads),
                             ("host 1 thread", torch.device("cpu"), 1)):
        torch.set_num_threads(nt)
        try:
            e = fluidgym_tpu_torch.make(CYL3D_EASY, device=where, **kw)
            e.reset(seed=0)
            o, r, _, _, info = e.step(a)
        finally:
            torch.set_num_threads(threads)
        outs[label] = {k: v.cpu() for k, v in dict(o, reward=r).items()}

    def diffs(x, y):
        return {k: float((x[k] - c).abs().max() / c.abs().max().clamp(min=1e-30))
                for k, c in y.items()}

    worst = diffs(outs["card"], outs["host"])
    order = diffs(outs["host 1 thread"], outs["host"])
    log(f"phase 34 {CYL3D_EASY} full width, 1 sim step from the bundled "
        f"snapshot, card vs host: relative diffs {worst} (bars "
        f"{CYL3D_HOST_BARS}); host on 1 thread vs {threads}: {order}; in "
        f"{time.perf_counter() - t0:.1f}s")
    check(all(v <= CYL3D_HOST_BARS[k] for k, v in worst.items()),
          f"CylinderJet3D card and host disagree: {worst}")
    return dict(card_vs_host=worst, host_threads=order)


# ---------------------------------------------------------------------------
# phase 36: the merged forms' spread arm against the chunk grid, end to end
# ---------------------------------------------------------------------------

#: phase 36's ids, env steps per arm, the arms in turns, and whether the
#: first step runs once more per arm under the profiler (a profiled medium
#: step costs ~30-40 s of host time, so medium's device time comes from
#: ``scripts/port_step_profile.py``)
CYL3D_AB = ((CYL3D_EASY, 1, ("grid", "spread", "spread", "grid"), True),
            (CYL3D_MEDIUM, 1, ("grid", "spread"), False))


def device_ms(torch, fn) -> float:
    """Device time of ``fn()`` in ms: the summed durations of the CUDA
    activities (kernels, copies, sets) that ``torch.profiler`` records with
    the CUDA activity alone (no host operators, so no event tree to
    build)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = sum(ev.duration_ns() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == DeviceType.CUDA)
    check(ns > 0, "the profiler recorded no device time")
    return ns / 1e6


def cyl3d_env_ab(dev, env_id: str, env, steps: int, arms,
                 profiled: bool) -> dict:
    """``env`` (a CylinderJet3D env made on the card at its registered
    defaults and stepped, phases 33 and 35), then ``arms`` in turns from its
    current state (``set_state``): "grid" pins
    the spread rule to the chunk grid (``cg_cuda.pinned_spread(0)``),
    "spread" leaves the rule free; each takes the same seeded actions.
    Every arm's obs must be bit-equal to the first's (the spread arm
    computes the chunk grid's bits); in the grid arms no merged launch
    takes the spread arm, in the spread arms every one; no plain version
    runs.  Then, if ``profiled``, from the same state the first step once
    more per arm under ``torch.profiler`` (``device_ms``).  Returns ms per
    env step per arm (host clock around ``step``, ending in a device
    synchronise), device ms per step, pressure iterations and launches."""
    import numpy as np
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    _, plains = _counters()
    count = lambda: (k3.launches_3d, k2.merged_launches_3d, k3.spread_launches,
                     k2.merged_spread_launches,
                     k3.cluster_launches + k2.cluster_launches,
                     sum(getattr(*c) for c in plains))
    start = env.get_state()
    rng = np.random.default_rng(36)
    a_shape = ((env.n_agents, 1) if env.use_marl
               else tuple(env.action_space.shape))
    actions = [rng.uniform(-1, 1, a_shape).astype(np.float32)
               for _ in range(steps)]
    rows, first = [], None
    for arm in arms:
        with cg_cuda.pinned_spread(0 if arm == "grid" else None):
            env.set_state(start)
            c0 = count()
            step_ms, its = [], []
            for a in actions:
                torch.cuda.synchronize()
                t = time.perf_counter()
                obs, _, _, _, info = env.step(a)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t))
                its.append(int(info["pressure_iterations"]))
        d = [b - a for a, b in zip(c0, count())]
        first = obs if first is None else first
        check(all(torch.equal(obs[k], first[k]) for k in obs),
              f"{env_id} {arm} arm: obs differ from the first arm's")
        spread = d[2] == d[0] > 0 and d[3] == d[1] > 0
        check((spread if arm == "spread" else d[2] == d[3] == 0)
              and d[4] == d[5] == 0,
              f"{env_id} {arm} arm: launches K3 3d, K2-mb 3d, K3 spread, "
              f"K2-mb spread, cluster, plain {d}")
        rows.append(dict(arm=arm, ms_per_step=step_ms,
                         mean_ms=sum(step_ms) / len(step_ms),
                         pressure_iterations=its, launches=d))
    dev_ms = {}
    for arm in ("grid", "spread") if profiled else ():
        with cg_cuda.pinned_spread(0 if arm == "grid" else None):
            env.set_state(start)
            dev_ms[arm] = device_ms(torch, lambda: env.step(actions[0]))
    mean = lambda a: (sum(r["mean_ms"] for r in rows if r["arm"] == a)
                      / sum(r["arm"] == a for r in rows))
    return dict(env_id=env_id, steps=steps, arms=rows, grid_ms=mean("grid"),
                spread_ms=mean("spread"),
                speedup=mean("grid") / mean("spread"),
                device_ms_first_step=dev_ms)


def _cyl3d_ab_phase(dev, kernels, envs) -> None:
    """Phase 36: ms per env step of CylinderJet3D-easy (1 SARL step, four
    arms in turns; and device ms per step) and -medium (1 step, two arms)
    under the merged forms' spread arm and the chunk grid
    (``cyl3d_env_ab``), from the states where phases 33 (SARL) and 35 left
    ``envs`` (by id)."""
    t0 = time.perf_counter()
    ab = {}
    for env_id, steps, arms, profiled in CYL3D_AB:
        r = ab[env_id] = cyl3d_env_ab(dev, env_id, envs[env_id], steps, arms,
                                      profiled)
        log(f"  {env_id}: chunk grid {r['grid_ms']:.1f} ms/env step, spread "
            f"arm {r['spread_ms']:.1f} ({r['speedup']:.2f}x); per arm "
            + ", ".join(f"{x['arm']} {[round(v, 1) for v in x['ms_per_step']]}"
                        for x in r["arms"])
            + f"; device ms of the first step "
              f"{json.dumps({k: round(v, 1) for k, v in r['device_ms_first_step'].items()})}"
              f"; pressure iterations {r['arms'][0]['pressure_iterations']}, "
              f"obs bit-equal across the arms")
    kernels["K3-3D"]["main_path_ab"] = ab
    log(f"phase 36 merged spread arm A/B ok in {time.perf_counter() - t0:.1f}s")


def _cyl3d_phases(dev, kernels, compare, piso, linsolve) -> None:
    """Phases 32-36: K3-3D and K2-mb-3D against their plain versions and the
    spread arm against the chunk grid (32); the CylinderJet3D-easy-v0 main
    path, 1 SARL step (its default) and 1 MARL step (33); card against host
    (34); CylinderJet3D-medium-v0, 1 step (35); the two arms end to end
    (36)."""
    _cyl3d_kernel_phase(dev, kernels, compare)
    runs = [_cyl3d_main_path(dev, piso, linsolve, CYL3D_EASY, 1, 33),
            _cyl3d_main_path(dev, piso, linsolve, CYL3D_EASY, 1, 33,
                             use_marl=True)]
    host = _cyl3d_card_vs_host(dev)
    medium = _cyl3d_main_path(dev, piso, linsolve, CYL3D_MEDIUM, 1, 35)
    check(runs[0]["cells"] == 341568 and medium["cells"] == 749568,
          f"not the registered widths: {runs[0]['cells']}, {medium['cells']}")
    for name, k in (("K3-3D", "K3"), ("K2-mb-3D", "K2-mb")):
        e = kernels[name]
        # the main path's launches in the easy runs (resets included)
        e["launches"] = sum(r["launches"][f"{k} 3d"] for r in runs)
        steps = [d["K3" if k == "K3" else "K2"] for r in runs
                 for d in r["step_launches"]]
        e["launches_per_env_step"] = sum(steps) / len(steps)
        e["main_path"] = {
            f"{r['env_id']} {'MARL' if r['marl'] else 'SARL'}":
            {x: r[x] for x in ("ms_step", "step_ms", "reset_s", "substeps",
                               "pressure_iterations", "pressure_converged")}
            for r in runs + [medium]}
        e["medium_launches"] = medium["launches"][f"{k} 3d"]
        e["card_vs_host"] = host
    _cyl3d_ab_phase(dev, kernels, {CYL3D_EASY: runs[0]["env"],
                                   CYL3D_MEDIUM: medium["env"]})


# ---------------------------------------------------------------------------
# phases 37-40: the cylinder ids of the upwind blend
# ---------------------------------------------------------------------------

#: phase 37's ids: the 2D cylinder ids of this slice
CYL2D_NEW = ("CylinderJet2D-medium-v0", "CylinderJet2D-hard-v0",
             "CylinderRot2D-easy-v0", "CylinderRot2D-medium-v0",
             "CylinderRot2D-hard-v0")
#: phase 37's env steps per id (3 until phases 41-43 took their time)
CYL2D_STEPS = 1
#: phase 37's captured solves (the slice's width, with the blend)
CYL2D_SYSTEMS = "CylinderJet2D-hard-v0"
#: phase 38's ids; its bars are phase 10's
CYL2D_HOST = ("CylinderRot2D-easy-v0", "CylinderJet2D-hard-v0")
CYL3D_HARD = "CylinderJet3D-hard-v0"


def arms_in_turns(torch, arms: dict, reps: int, runs: int = 2) -> dict:
    """``arms`` maps a name to a raw launch returning ``(x, iterations,
    residual_sum)``; the first is the reference (the chunk grid).  Every
    arm must return its bits, ``runs`` times back to back; then ms per raw
    launch of each, in turns (forward, then backward)."""
    names = list(arms)
    ref = tuple(t.clone() for t in arms[names[0]]())
    torch.cuda.synchronize()
    for name in names:
        for i in range(runs):
            out = arms[name]()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                  f"{name} (run {i}) differs from {names[0]}: max|dx| "
                  f"{float((out[0] - ref[0]).abs().max()):.3e}, iterations "
                  f"{out[1].tolist()} / {ref[1].tolist()}, residual "
                  f"{out[2].tolist()} / {ref[2].tolist()}")
    ms = {k: 0.0 for k in names}
    for k in names + names[::-1]:
        ms[k] += cuda_ms(torch, arms[k], reps) / 2
    return dict(iterations=int(ref[1].max()), raw_ms=ms)


def merged_system(name, algo, plan, diags, offs, bs, x0s, tol, kw, arms,
                  rel, it_tol, reps) -> dict:
    """One captured merged solve (``bs`` / ``x0s`` per super-block with a
    leading lane axis): the wrapper call (the rule's arm) against the plain
    version (``compare``, and the same converged flags), then ``arms(diag,
    off, b, x0, tol2)`` (name -> raw launch, the chunk grid first) bit for
    bit and per raw launch in turns (``arms_in_turns``); ms per wrapper
    call, the plain version's ms, the bound."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    b = cg_cuda_mb.flatten_fields(plan, bs)
    x0 = None if x0s is None else cg_cuda_mb.flatten_fields(plan, x0s)
    L, nc = b.shape
    t2 = cg_cuda.tol2_sum_f32(tol, nc)
    wrap = (cg_cuda_mb.fused_cg_mb if algo == "cg"
            else cg_cuda_mb.fused_bicgstab_mb)
    last = {}

    def call():
        xs, inf = wrap(plan, diags, offs, bs, x0s, tol=tol, **kw)
        x = cg_cuda_mb.flatten_fields(plan, xs)
        if algo == "cg":
            last["kern"] = inf.converged
            return x, inf.iterations, inf.residual ** 2 * nc
        last["kern"] = inf.converged.repeat(L)
        return x, inf.iterations.repeat(L), None

    def plain():
        if algo == "cg":
            out = cg_cuda_mb.fused_cg_mb_plain(plan, diag, off, b, x0,
                                               tol2_sum=t2, chunk=1, **kw)
        else:
            out = cg_cuda_mb.fused_bicgstab_plain(diag, off, b, x0,
                                                  ndims=plan.ndims, plan=plan,
                                                  tol2_sum=t2, chunk=1, **kw)
        last["plain"] = (out[2] <= t2) | (b == 0).all(dim=1)
        if algo != "cg":  # the wrapper reports over every component
            last["plain"] = last["plain"].all().repeat(L)
            out = (out[0], out[1].max().repeat(L), out[2])
        return out

    e, it = compare(name, call, plain, b, tol, rel, it_tol,
                    cg_cuda_mb._merged_mv(plan, diag, off), plain_bar=True)
    check(torch.equal(last["kern"].cpu(), last["plain"].cpu()),
          f"{name}: converged flags {last['kern'].tolist()} (kernel) != "
          f"{last['plain'].tolist()} (plain)")
    turns = arms_in_turns(torch, arms(diag, off, b, x0, t2), reps)
    b_ms, by, stream = bound_ms(nc, L, plan.ndims, it, algo, x0 is not None,
                                True, _seam_cells(plan))
    return dict(max_abs_err=e, iterations=it, ms=cuda_ms(torch, call, reps),
                plain_ms=cuda_ms(torch, plain, 1), bound_ms=b_ms, bound_by=by,
                stream_ms=stream, raw_ms=turns["raw_ms"], lanes=L, cells=nc)


def _captured_lanes(sy, key):
    """``(plan, diags, offs, bs, x0s, tol, kw)`` of a captured solve, the
    right-hand sides and start with a leading lane axis (K3's one lane)."""
    (plan, diags, offs, bs), kw = sy[key]
    kw = dict(kw)
    x0s, tol = kw.pop("x0s"), kw.pop("tol")
    kw.pop("coarse_strips", None)
    if key == "K3":
        bs = tuple(b_.unsqueeze(0) for b_ in bs)
        x0s = None if x0s is None else tuple(x.unsqueeze(0) for x in x0s)
    return plan, diags, offs, bs, x0s, tol, kw


def _cyl2d_systems(dev) -> dict:
    """Phase 37, second part: K3 and K2-mb on the first-substep solves of
    ``CYL2D_SYSTEMS`` from its bundled ``train_00`` at full width (23,424
    cells; the blended velocity matrix), captured at the wrappers: against
    the plain versions with phases 7-8's bars, the rule's cluster size
    bit-equal to C = 1 twice, both per raw launch in turns."""
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    sy = _captured_merged(dev, CYL2D_SYSTEMS)
    out = {}
    for key, algo, name, rel, it_tol in (("K3", "cg", "K3", 1e-3, 3),
                                         ("K2", "bicgstab", "K2-mb", 1e-4, 2)):
        plan, diags, offs, bs, x0s, tol, kw = _captured_lanes(sy, key)
        L = bs[0].shape[0]
        n = sum(math.prod(sb.shape) for sb in plan.superblocks)
        check(plan.ndims == 2 and n == 23424,
              f"the captured {name} solve is not the 23,424-cell merged lane")
        rule = cg_cuda_mb.merged_arm(L, n, 2, 1, dev, algo)
        check(rule.cluster > 1 and not rule.spread and not rule.per_lane,
              f"{name}: merged_arm picks {rule}, not the cluster arm")

        def arms(diag, off, b, x0, t2, algo=algo, plan=plan, kw=kw,
                 C=rule.cluster):
            return {f"C={c}": cg_cuda_mb.merged_launcher(
                algo, plan, diag, off, b, x0, tol2_sum=t2, chunk=1,
                cluster=c, **kw) for c in (1, C)}

        r = merged_system(f"{name} {CYL2D_SYSTEMS} ({L}, {n})", algo, plan,
                          diags, offs, bs, x0s, tol, kw, arms, rel, it_tol, 10)
        raw, c1 = r["raw_ms"][f"C={rule.cluster}"], r["raw_ms"]["C=1"]
        r.update(C=rule.cluster, raw_ms_rule=raw, raw_ms_c1=c1,
                 us_per_it=raw * 1e3 / max(r["iterations"], 1),
                 us_per_it_c1=c1 * 1e3 / max(r["iterations"], 1))
        log(f"  {name} ({L}, {n}) at C = {rule.cluster}: {r['ms']:.3f} ms per "
            f"wrapper call; raw launch {raw:.3f} ms = {r['us_per_it']:.2f} "
            f"us/iteration, C = 1 {c1:.3f} ms ({c1 / raw:.2f}x) at "
            f"{r['iterations']} iterations, bit-equal twice (plain "
            f"{r['plain_ms']:.3f} ms; bound {r['bound_ms'] * 1e3:.3f} us by "
            f"{r['bound_by']})")
        out[name] = r
    return out


def _cyl2d_new_main_path(dev, kernels, piso, linsolve) -> None:
    """Phase 37: the five 2D cylinder ids of this slice at their registered
    defaults: ``make``, ``reset(seed=0)`` (randomized: noise on the bundled
    ``train_00``, then 13-25 uncontrolled sim steps), 1 step with a fixed
    non-zero action.  Counters zeroed just before
    ``make`` and read after each step: in every step K3 launches twice per
    substep and K2-mb once, every one on the cluster arm, and no other
    kernel form, plain version or ``linsolve`` loop runs; drag, lift, obs
    and reward finite.  Then the captured solves (``_cyl2d_systems``)."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    t0 = time.perf_counter()
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    launches, plains = _counters()
    rows = {}
    for env_id in CYL2D_NEW:
        calls, restore = count_calls(piso, linsolve)

        def counts():
            out = {"K3": k3.launches, "K2-mb": k2.merged_launches,
                   "cluster": k3.cluster_launches + k2.cluster_launches}
            out["other"] = (sum(getattr(*c) for c in launches) - out["K3"]
                            - out["K2-mb"])
            out["plain"] = sum(getattr(*c) for c in plains)
            out["linsolve"] = calls["cg"] + calls["bicgstab"]
            out["substeps"] = calls["piso_substep_info"]
            return out

        for c in launches + plains + [(k3, "cluster_launches"),
                                      (k2, "cluster_launches")]:
            setattr(*c, 0)
        torch.cuda.synchronize()
        per_step, step_s, p_its, drags, lifts = [], [], [], [], []
        try:
            t = time.perf_counter()
            env = fluidgym_tpu_torch.make(env_id)
            env.reset(seed=0)
            torch.cuda.synchronize()
            reset_s = time.perf_counter() - t
            reset = counts()
            cells = sum(math.prod(b.shape) for b in env._topo.blocks)
            a = np.full(env.action_space.shape, 0.5, np.float32)
            for i in range(CYL2D_STEPS):
                c0 = counts()
                t = time.perf_counter()
                obs, reward, _, _, info = env.step(a)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                d = {k: v - c0[k] for k, v in counts().items()}
                sub = d["substeps"]
                expect = {"K3": 2 * sub, "K2-mb": sub, "cluster": 3 * sub,
                          "other": 0, "plain": 0, "linsolve": 0}
                check(sub > 0 and all(d[k] == v for k, v in expect.items()),
                      f"{env_id} step {i}: launches {d}, expected {expect}")
                for k, v in obs.items():
                    check(tuple(v.shape) == env.observation_space[k].shape,
                          f"{env_id} obs {k} shape {tuple(v.shape)}")
                    check(bool(torch.isfinite(v).all()),
                          f"{env_id} obs {k} not finite")
                drags.append(float(info["drag"]))
                lifts.append(float(info["lift"]))
                check(bool(torch.isfinite(reward).all())
                      and math.isfinite(drags[-1]) and math.isfinite(lifts[-1]),
                      f"{env_id}: reward, drag or lift not finite")
                p_its.append(int(info["pressure_iterations"]))
                per_step.append(d)
        finally:
            restore()
        C = {name: cg_cuda_mb.default_cluster(L, cells, 2, 1, dev, algo)
             for name, L, algo in (("K3", 1, "cg"), ("K2-mb", 2, "bicgstab"))}
        check(min(C.values()) > 1, f"{env_id}: default_cluster gives {C}")
        blend = env._cfg.advection_upwind_blend
        check(blend == (0.3 if env._reynolds_number >= 500 else 0.0),
              f"{env_id}: upwind blend {blend}")
        r = rows[env_id] = dict(
            cells=cells, C=C, reset_s=reset_s,
            reset_launches={k: reset[k] for k in ("K3", "K2-mb")},
            ms_step=1e3 * sum(step_s) / len(step_s),
            step_ms=[1e3 * x for x in step_s],
            substeps=[d["substeps"] for d in per_step],
            pressure_iterations=p_its, drag=drags, lift=lifts, blend=blend,
            launches_per_env_step={k: sum(d[k] for d in per_step) / len(per_step)
                                   for k in ("K3", "K2-mb")})
        log(f"phase 37 {env_id}: {cells} cells, blend {blend}, "
            f"default_cluster {C}, reset {reset_s:.2f}s (launches "
            f"{r['reset_launches']}), steps {[round(x, 3) for x in step_s]} s "
            f"= {r['ms_step']:.1f} ms/env step, substeps {r['substeps']}, "
            f"pressure iterations {p_its}, drag {[round(x, 5) for x in drags]}"
            f", lift {[round(x, 5) for x in lifts]}, launches per step "
            f"{r['launches_per_env_step']}; every K3 / K2-mb launch on the "
            f"cluster arm")
    systems = _cyl2d_systems(dev)
    for k in ("K3", "K2-mb"):
        s_ = systems[k]
        kernels[k]["cylinder_23424"] = dict(
            {x: s_[x] for x in ("lanes", "cells", "iterations", "ms",
                                "plain_ms", "bound_ms", "bound_by",
                                "stream_ms", "max_abs_err", "C",
                                "raw_ms_rule", "raw_ms_c1", "us_per_it",
                                "us_per_it_c1")},
            launches=sum(CYL2D_STEPS * rows[i]["launches_per_env_step"][k]
                         for i in CYL2D_NEW),
            launches_per_env_step={i: rows[i]["launches_per_env_step"][k]
                                   for i in CYL2D_NEW},
            main_path={i: {x: rows[i][x] for x in (
                "cells", "C", "ms_step", "step_ms", "substeps",
                "pressure_iterations", "reset_s")}
                for i in CYL2D_NEW})
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"],
                                        s_["max_abs_err"])
    log(f"phase 37 the 2D cylinder ids of the upwind blend ok in "
        f"{time.perf_counter() - t0:.1f}s")


def _cyl2d_new_card_vs_host(dev) -> None:
    """Phase 38: one full-width env step of each of ``CYL2D_HOST`` from the
    bundled ``test_00`` (no randomization) on the card and on the host,
    the same action: obs and reward within 1e-4 relative (phase 10's bars;
    the Re 500 id through the blended velocity matrix)."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch

    for env_id in CYL2D_HOST:
        t = time.perf_counter()
        outs, its = {}, {}
        for where in (dev, torch.device("cpu")):
            e = fluidgym_tpu_torch.make(env_id, device=where,
                                        randomize_initial_state=False)
            e.test()
            e.reset(seed=0)
            o, r, _, _, info = e.step(np.array([0.6], np.float32))
            outs[where.type] = {k: v.cpu() for k, v in dict(o, reward=r).items()}
            its[where.type] = int(info["pressure_iterations"])
        og, oc = outs[dev.type], outs["cpu"]
        diffs = {k: float((og[k] - oc[k]).abs().max()
                          / oc[k].abs().max().clamp(min=1e-30)) for k in og}
        log(f"phase 38 {env_id} full width, 1 step from the bundled test_00 "
            f"({e.n_sim_steps} sim steps, blend "
            f"{e._cfg.advection_upwind_blend}, pressure iterations {its}), "
            f"card vs host: relative diffs {diffs} (bar 1e-4) in "
            f"{time.perf_counter() - t:.2f}s")
        check(all(v <= 1e-4 for v in diffs.values()),
              f"card and host disagree on {env_id}: {diffs}")


def _hard_kernel_phase(dev, kernels) -> None:
    """Phase 39: K3-3D and K2-mb-3D on the first-substep solves of
    CylinderJet3D-hard from its bundled ``test_00`` at full width (2,481,408
    cells), captured at the wrappers: the warm pressure solve (1 lane) and
    the velocity solve (3 lanes), against their plain versions with phase
    32's bars.  A spread block's chain terms fill one SM at this width, so
    the card's co-residency (``spread_capacity``) holds one lane at G = 128
    and not three: ``merged_arm`` gives K3 G = 128 and K2-mb's lanes one
    per launch at G = 128.  On each system the rule's arm must return the
    chunk grid's x, iterations and residual bit for bit, twice, and is
    timed against it per raw launch in turns."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    sy = _captured_merged(dev, CYL3D_HARD, split="test")
    n = sum(math.prod(sb.shape) for sb in sy["K3"][0][0].superblocks)
    check(n == 2481408, f"the hard pressure solve has {n} cells, not 2,481,408")
    # the card answers only for a G whose chain terms fit a block
    cap = {algo: {G: cg_cuda.spread_capacity(algo + "_mb", 3, G, True, n, dev)
                  for G in cg_cuda.SPREAD_SIZES if cg_cuda.spread_fits(n, G)}
           for algo in ("cg", "bicgstab")}
    check(all(128 <= c[128] < 3 * 128 and len(c) == 1 for c in cap.values()),
          f"the card's co-residency at the hard width is not one lane at "
          f"G = 128 and fewer than three: {cap}")
    arm = {algo: cg_cuda_mb.merged_arm(L, n, 3, 1, dev, algo)
           for algo, L in (("cg", 1), ("bicgstab", 3))}
    log(f"  {CYL3D_HARD}: spread blocks co-resident per G {cap}, "
        f"{cg_cuda.spread_bytes(n, 128)} B of chain terms per block at G = "
        f"128; merged_arm {arm}")
    check(arm == {"cg": (1, 128, False), "bicgstab": (1, 128, True)},
          f"merged_arm picks {arm}, not G = 128 for K3 and the K2-mb lanes "
          "one per launch at G = 128")
    rows = {}
    for key, algo, name, rel, it_tol in (("K3", "cg", "K3-3D", 1e-3, 3),
                                         ("K2", "bicgstab", "K2-mb-3D", 1e-4, 2)):
        plan, diags, offs, bs, x0s, tol, kw = _captured_lanes(sy, key)
        L = bs[0].shape[0]
        check(plan.ndims == 3 and L == (1 if algo == "cg" else 3)
              and (algo != "cg" or x0s is not None),
              f"the captured {name} solve is not the {L}-lane 3D merged solve")

        def arms(diag, off, b, x0, t2, algo=algo, plan=plan, kw=kw, L=L):
            def mk(sl, G):
                one = lambda t: t if t is None or t.shape[0] == 1 else t[sl]
                return cg_cuda_mb.merged_launcher(
                    algo, plan, one(diag), one(off), b[sl], one(x0),
                    tol2_sum=t2, chunk=1, spread=G, **kw)
            grid = mk(slice(None), 0)
            if L == 1:
                return {"grid": grid, "G=128": mk(slice(None), 128)}
            lanes = [mk(slice(l, l + 1), 128) for l in range(L)]
            return {"grid": grid, "G=128 one lane per launch": lambda: tuple(
                torch.cat(t) for t in zip(*[f() for f in lanes]))}

        r = merged_system(f"{name} hard ({L}, {n})", algo, plan, diags, offs,
                          bs, x0s, tol, kw, arms, rel, it_tol, 3)
        rule = [k for k in r["raw_ms"] if k != "grid"][0]
        raw, grid = r["raw_ms"][rule], r["raw_ms"]["grid"]
        r.update(rule=rule, raw_ms_rule=raw, raw_ms_grid=grid,
                 us_per_it=raw * 1e3 / max(r["iterations"], 1),
                 us_per_it_grid=grid * 1e3 / max(r["iterations"], 1),
                 spread_capacity=cap[algo])
        log(f"  {name} hard ({L}, {n}): {r['ms']:.3f} ms per wrapper call; raw "
            f"launch {rule} {raw:.3f} ms = {r['us_per_it']:.2f} us/iteration, "
            f"chunk grid {grid:.3f} ms = {r['us_per_it_grid']:.2f} "
            f"({grid / raw:.2f}x) at {r['iterations']} iterations; bit-equal "
            f"twice (plain {r['plain_ms']:.3f} ms; bound "
            f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, streaming "
            f"{r['stream_ms'] * 1e3:.3f} us)")
        rows[name] = r
    for name, r in rows.items():
        kernels[name]["hard"] = {x: r[x] for x in (
            "lanes", "cells", "iterations", "ms", "plain_ms", "bound_ms",
            "bound_by", "stream_ms", "max_abs_err", "rule", "raw_ms_rule",
            "us_per_it", "raw_ms_grid", "us_per_it_grid", "spread_capacity")}
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                           r["max_abs_err"])
    log(f"phase 39 K3-3D and K2-mb-3D at the hard width ok in "
        f"{time.perf_counter() - t0:.1f}s")


def _hard_main_path(dev, kernels, piso, linsolve) -> None:
    """Phase 40: ``CylinderJet3D-hard-v0`` at its registered defaults
    (SARL), from its bundled ``test_00`` (``load_initial_domain``; the one
    file of the set the chip copy holds), 1 step with
    ``_cyl3d_main_path``'s checks: every K3 launch and every K2-mb launch
    (3 per substep: one per velocity lane) a 3D merged launch on the
    spread arm, no chunk-grid launch."""
    r = _cyl3d_main_path(dev, piso, linsolve, CYL3D_HARD, 1, 40,
                         snapshot=("test", 0), k2_per_substep=3)
    check(r["cells"] == 2481408, f"{CYL3D_HARD} has {r['cells']} cells")
    check(r["launches"]["K3 spread"] == r["launches"]["K3 3d"] > 0
          and r["launches"]["K2-mb spread"] == r["launches"]["K2-mb 3d"] > 0,
          f"{CYL3D_HARD}: a launch took the chunk grid: {r['launches']}")
    for name, k in (("K3-3D", "K3"), ("K2-mb-3D", "K2")):
        kernels[name]["hard"]["main_path"] = {x: r[x] for x in (
            "ms_step", "step_ms", "reset_s", "substeps", "pressure_iterations",
            "pressure_converged", "drag", "lift")}
        kernels[name]["hard"]["launches"] = r["launches"][
            "K3 3d" if k == "K3" else "K2-mb 3d"]
        kernels[name]["hard"]["launches_per_env_step"] = r["step_launches"][0][k]
    r.pop("env")


def _blend_phases(dev, kernels, piso, linsolve) -> None:
    """Phases 37-40: the 2D ids of the blend on the cluster arm (37), card
    against host (38), the hard width's K3-3D and K2-mb-3D (39), the
    CylinderJet3D-hard main path (40)."""
    _cyl2d_new_main_path(dev, kernels, piso, linsolve)
    _cyl2d_new_card_vs_host(dev)
    _hard_kernel_phase(dev, kernels)
    _hard_main_path(dev, kernels, piso, linsolve)


# ---------------------------------------------------------------------------
# phases 41-43: Airfoil2D-medium and -hard, K3-agg-flip
# ---------------------------------------------------------------------------

#: the aggregation-coarse airfoil ids (Re 3000 and 5000: the blend 0.3 and
#: 8 x 8 tiles, k = 1,194)
AGG_IDS = ("Airfoil2D-medium-v0", "Airfoil2D-hard-v0")
#: phase 42's env steps per id (2 until phases 44-47 took their time: a
#: medium step is ~60-80 s of host-bound substeps), each shortened to one
#: sim step (``step_length`` = dt = 0.05, a fifth of the registered step)
#: since phases 48-50 took theirs
AGG_STEPS = 1
AGG_STEP_LENGTH = 0.05


def agg_ptxas(log: str) -> list:
    """Registers and spill bytes of the K3-agg instances
    (``fg_cg_kernel<2, true, true, C, false, 0, true>``: the cluster arm
    and the chunk grid) in an ``nvcc -Xptxas -v`` build log."""
    import re

    out = []
    for m in re.finditer(r"Compiling entry function '(_Z12fg_cg_kernelILi2ELb1E"
                         r"Lb1ELb(\d)ELb0ELi0ELb1E\S*)'.*?Function properties "
                         r"for \S+\s*\n\s*(\d+) bytes stack frame, (\d+) bytes "
                         r"spill stores, (\d+) bytes spill loads.*?Used (\d+) "
                         r"registers", log, re.S):
        out.append(dict(instance="cluster" if m.group(2) == "1" else
                        "chunk grid", stack=int(m.group(3)),
                        spill_stores=int(m.group(4)),
                        spill_loads=int(m.group(5)),
                        registers=int(m.group(6))))
    return out


#: the most bytes of spill stores phase 41 lets the K3-agg cluster instance
#: have
AGG_SPILL_LIMIT = 64


def agg_build_ptxas() -> list:
    """``agg_ptxas`` of the kernel library's build log; where the library
    came from the build cache (no log), of ``csrc/cg.cu`` compiled again
    with the library's flags into a scratch directory."""
    import tempfile

    from fluidgym_tpu_torch.ops import _build

    log = _build.build_info()["log"]
    if not log:
        with tempfile.TemporaryDirectory() as tmp:
            log = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                 os.path.join(tmp, "cg.o"), str(_build.CSRC / "cg.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                check=True).stdout
    return agg_ptxas(log)


def _agg_kernel_phase(dev, kernels) -> None:
    """Phase 41: K3-agg-flip on the first substep's two pressure solves of
    one Airfoil2D-medium sim step from its bundled ``train_00`` at full
    width, captured at the wrapper (warm from the deflated guess, the
    env's aggregation space): the wrapper (the rule's C) against the plain
    version (``compare``: iterations within 3, x within 1e-3 of max|x|, a
    converged solve's true residual within 2 tol, and the same converged
    flags); the rule's C bit-equal to C = 1, twice, both per raw launch in
    turns; ms per wrapper call, us per iteration, the bound and the
    streamed bound."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    seen = _capture_solves(dev, AGG_IDS[0], 0.05, {
        "K3": (cg_cuda_mb, "fused_cg_mb")})["K3"]
    check(len(seen) >= 2 and all(kw.get("agg") is not None for _, kw in seen),
          f"Airfoil2D-medium's pressure solves ({len(seen)}) did not all take "
          "the aggregation space")
    rows = []
    for i, ((plan, diags, offs, bs), kw) in enumerate(seen[:2]):
        kw = dict(kw)
        x0s, tol, space = kw.pop("x0s"), kw.pop("tol"), kw.pop("agg")
        kw.pop("coarse_strips", None)
        bs = tuple(b_.unsqueeze(0) for b_ in bs)
        x0s = None if x0s is None else tuple(x.unsqueeze(0) for x in x0s)
        diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
        b = cg_cuda_mb.flatten_fields(plan, bs)
        x0 = None if x0s is None else cg_cuda_mb.flatten_fields(plan, x0s)
        n, K = b.shape[1], space.K
        check(n == 73456 and K == 1194 and not plan.identity_seams,
              f"the captured solve is not the airfoil's flip-seam lane with "
              f"1,194 tiles (n {n}, K {K})")
        t2 = cg_cuda.tol2_sum_f32(tol, n)
        rule = cg_cuda_mb.merged_arm(1, n, 2, 1, dev, "cg_coarse", K)
        check(rule.cluster > 1 and not rule.spread,
              f"merged_arm picks {rule} for K3-agg-flip, not the cluster arm")
        last = {}

        def call():
            xs, inf = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s,
                                             tol=tol, agg=space, **kw)
            last["kern"] = inf.converged
            return (cg_cuda_mb.flatten_fields(plan, xs), inf.iterations,
                    inf.residual ** 2 * n)

        def plain():
            out = cg_cuda_mb.fused_cg_mb_plain(
                plan, diag, off, b, x0, tol2_sum=t2, chunk=1,
                coarse=(space, space.einv[None]), **kw)
            last["plain"] = out[2] <= t2
            return out

        before = (cg_cuda_mb.fused_cg_mb.agg_flip_launches,
                  cg_cuda_mb.fused_cg_mb.cluster_launches)
        err, its = compare(f"K3-agg-flip solve {i} (1, {n}), K = {K}", call,
                           plain, b, tol, 1e-3, 3,
                           cg_cuda_mb._merged_mv(plan, diag, off))
        check((cg_cuda_mb.fused_cg_mb.agg_flip_launches,
               cg_cuda_mb.fused_cg_mb.cluster_launches)
              == (before[0] + 1, before[1] + 1),
              "the wrapper's K3-agg-flip launch was not counted as one "
              "cluster launch of its form")
        check(torch.equal(last["kern"].reshape(-1).cpu(),
                          last["plain"].reshape(-1).cpu()),
              f"converged flags differ: {last}")
        arms = {f"C={c}": cg_cuda_mb.merged_launcher(
            "cg", plan, diag, off, b, x0, tol2_sum=t2, chunk=1, cluster=c,
            coarse=(space, space.einv[None]), **kw) for c in (1, rule.cluster)}
        turns = arms_in_turns(torch, arms, 10)
        raw, c1 = turns["raw_ms"][f"C={rule.cluster}"], turns["raw_ms"]["C=1"]
        b_ms, by, stream = bound_ms(n, 1, 2, its, "cg", x0 is not None, True,
                                    _seam_cells(plan), coarse_K=K)
        r = dict(solve=i, iterations=its, max_abs_err=err, C=rule.cluster,
                 ms=cuda_ms(torch, call, 10), plain_ms=cuda_ms(torch, plain, 1),
                 raw_ms_rule=raw, raw_ms_c1=c1,
                 us_per_it=raw * 1e3 / max(its, 1),
                 us_per_it_c1=c1 * 1e3 / max(its, 1), bound_ms=b_ms,
                 bound_by=by, stream_ms=stream, cells=n, K=K)
        log(f"  K3-agg-flip solve {i}: {r['ms']:.3f} ms per wrapper call; "
            f"raw launch C = {rule.cluster} {raw:.3f} ms = "
            f"{r['us_per_it']:.2f} us/iteration, C = 1 {c1:.3f} ms = "
            f"{r['us_per_it_c1']:.2f} ({c1 / raw:.2f}x) at {its} iterations, "
            f"bit-equal twice (plain {r['plain_ms']:.3f} ms; bound "
            f"{b_ms * 1e3:.3f} us by {by}, streaming {stream * 1e3:.3f} us)")
        rows.append(r)
    first = rows[0]
    kernels["K3-agg-flip"] = dict(
        name="K3-agg-flip fused_cg_mb(agg=) (Jacobi + aggregation-coarse PCG, "
             "flip seams, whole solve)",
        route="cuda", source="fluidgym_tpu_torch/csrc/cg.cu",
        replaces="fluidgym_tpu/solver/piso.py:652",
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], library_ms=None,
        iterations=first["iterations"], shape="(1, 73456), K = 1194",
        C=first["C"], raw_ms=first["raw_ms_rule"],
        us_per_it=first["us_per_it"], raw_ms_cluster_1=first["raw_ms_c1"],
        us_per_it_cluster_1=first["us_per_it_c1"],
        streamed_ms=first["stream_ms"], solves=rows)
    sass = {r["instance"]: r for r in agg_build_ptxas()}
    log(f"  K3-agg-flip instances (ptxas): {list(sass.values())}")
    cl = sass.get("cluster")
    if cl is None:
        raise RuntimeError("no K3-agg cluster instance in the ptxas log")
    if cl["spill_stores"] > AGG_SPILL_LIMIT:
        raise RuntimeError(f"the K3-agg cluster instance spills "
                           f"{cl['spill_stores']} B (at most "
                           f"{AGG_SPILL_LIMIT})")
    kernels["K3-agg-flip"].update(
        registers=cl["registers"], spill_bytes=cl["spill_stores"],
        ptxas=list(sass.values()))
    log(f"phase 41 K3-agg-flip on Airfoil2D-medium's captured solves ok in "
        f"{time.perf_counter() - t0:.1f}s")


def _agg_main_path(dev, kernels, piso, linsolve) -> None:
    """Phase 42: Airfoil2D-medium-v0 and -hard-v0 at their registered
    defaults from the bundled ``train_00`` (no randomization), each step
    shortened to one sim step (``AGG_STEP_LENGTH``): ``reset(seed=0)`` and
    ``AGG_STEPS`` steps with a fixed action.
    Counters zeroed just before ``make`` and read after each step: in every
    step each substep launches K3-agg-flip twice (its two pressure
    correctors) and K2-mb-flip once, every one on the cluster arm, and no
    other kernel form, plain version or ``linsolve`` loop runs; obs,
    reward, drag and lift finite, every pressure solve converged; ms,
    substeps and pressure iterations per env step."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    t0 = time.perf_counter()
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    launches, plains = _counters()
    rows = {}
    for env_id in AGG_IDS:
        calls, restore = count_calls(piso, linsolve)

        def counts():
            out = {"K3-agg-flip": k3.agg_flip_launches,
                   "K2-mb-flip": k2.merged_flip_launches,
                   "cluster": k3.cluster_launches + k2.cluster_launches}
            out["other"] = (sum(getattr(*c) for c in launches)
                            - out["K3-agg-flip"] - out["K2-mb-flip"])
            out["plain"] = sum(getattr(*c) for c in plains)
            out["linsolve"] = calls["cg"] + calls["bicgstab"]
            out["substeps"] = calls["piso_substep_info"]
            return out

        for c in launches + plains + [(k3, "cluster_launches"),
                                      (k2, "cluster_launches")]:
            setattr(*c, 0)
        torch.cuda.synchronize()
        per_step, step_s, p_its, drags, lifts = [], [], [], [], []
        try:
            t = time.perf_counter()
            env = fluidgym_tpu_torch.make(env_id, randomize_initial_state=False,
                                          step_length=AGG_STEP_LENGTH)
            env.reset(seed=0)
            torch.cuda.synchronize()
            reset_s = time.perf_counter() - t
            reset = counts()
            agg = env._cfg.pressure_agg
            check(agg is not None and agg.space.K == 1194 and agg.tile == 8
                  and env._cfg.advection_upwind_blend == 0.3,
                  f"{env_id}: not the blend and the 1,194-tile space")
            a = np.array([0.5, -0.2, -0.3], np.float32)
            for i in range(AGG_STEPS):
                c0 = counts()
                t = time.perf_counter()
                obs, reward, _, _, info = env.step(a)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                d = {k: v - c0[k] for k, v in counts().items()}
                sub = d["substeps"]
                expect = {"K3-agg-flip": 2 * sub, "K2-mb-flip": sub,
                          "cluster": 3 * sub, "other": 0, "plain": 0,
                          "linsolve": 0}
                check(sub > 0 and all(d[k] == v for k, v in expect.items()),
                      f"{env_id} step {i}: launches {d}, expected {expect}")
                for k, v in obs.items():
                    check(tuple(v.shape) == env.observation_space[k].shape,
                          f"{env_id} obs {k} shape {tuple(v.shape)}")
                    check(bool(torch.isfinite(v).all()),
                          f"{env_id} obs {k} not finite")
                drags.append(float(info["drag"]))
                lifts.append(float(info["lift"]))
                check(bool(torch.isfinite(reward).all())
                      and math.isfinite(drags[-1]) and math.isfinite(lifts[-1]),
                      f"{env_id}: reward, drag or lift not finite")
                check(bool(info["pressure_converged"]),
                      f"{env_id} step {i}: a pressure solve did not converge")
                p_its.append(int(info["pressure_iterations"]))
                per_step.append(d)
        finally:
            restore()
        r = rows[env_id] = dict(
            reset_s=reset_s,
            reset_launches={k: reset[k] for k in ("K3-agg-flip", "other")},
            ms_step=1e3 * sum(step_s) / len(step_s),
            step_ms=[1e3 * x for x in step_s],
            substeps=[d["substeps"] for d in per_step],
            pressure_iterations=p_its, drag=drags, lift=lifts,
            launches_per_env_step={k: sum(d[k] for d in per_step) / len(per_step)
                                   for k in ("K3-agg-flip", "K2-mb-flip")},
            launches=sum(d["K3-agg-flip"] for d in per_step))
        log(f"phase 42 {env_id}: reset {reset_s:.2f}s (launches "
            f"{r['reset_launches']}), steps {[round(x, 3) for x in step_s]} s "
            f"= {r['ms_step']:.1f} ms/env step, substeps {r['substeps']}, "
            f"pressure iterations {p_its}, drag {[round(x, 5) for x in drags]}"
            f", lift {[round(x, 5) for x in lifts]}, launches per step "
            f"{r['launches_per_env_step']}; every K3-agg-flip / K2-mb-flip "
            f"launch on the cluster arm")
    kernels["K3-agg-flip"]["launches"] = sum(r["launches"] for r in rows.values())
    kernels["K3-agg-flip"]["launches_per_env_step"] = {
        i: r["launches_per_env_step"]["K3-agg-flip"] for i, r in rows.items()}
    kernels["K3-agg-flip"]["main_path"] = {i: {x: r[x] for x in (
        "ms_step", "step_ms", "substeps", "pressure_iterations", "reset_s",
        "drag", "lift")} for i, r in rows.items()}
    log(f"phase 42 the aggregation-coarse airfoil ids ok in "
        f"{time.perf_counter() - t0:.1f}s")


def _agg_card_vs_host(dev) -> None:
    """Phase 43: one shortened Airfoil2D-medium step (``step_length`` = dt
    = 0.01: one sim step; the aggregation space built at that dt on both
    sides) from the bundled ``train_00`` at full width, on the card and on
    the host: the velocity obs and the reward within 1e-4, the pressure obs
    within 1e-3 (phase 13's bars: a float32 airfoil pressure obs is decided
    by rounding at ~1e-4)."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch

    t = time.perf_counter()
    outs, its = {}, {}
    for where in (dev, torch.device("cpu")):
        e = fluidgym_tpu_torch.make(AGG_IDS[0], device=where,
                                    randomize_initial_state=False,
                                    load_domain_statistics=False,
                                    step_length=0.01, dt=0.01)
        e.reset(seed=0)
        o, r, _, _, info = e.step(np.array([0.5, -0.2, -0.3], np.float32))
        outs[where.type] = {k: v.cpu() for k, v in dict(o, reward=r).items()}
        its[where.type] = int(info["pressure_iterations"])
    og, oc = outs[dev.type], outs["cpu"]
    diffs = {k: float((og[k] - oc[k]).abs().max()
                      / oc[k].abs().max().clamp(min=1e-30)) for k in og}
    bars = {"velocity": 1e-4, "reward": 1e-4, "pressure": 1e-3}
    log(f"phase 43 {AGG_IDS[0]} full width, 1 sim step of 0.01 from the "
        f"bundled train_00 (pressure iterations {its}), card vs host: "
        f"relative diffs {diffs} (bars {bars}) in "
        f"{time.perf_counter() - t:.2f}s")
    check(all(v <= bars[k] for k, v in diffs.items()),
          f"card and host disagree on {AGG_IDS[0]}: {diffs}")


def _agg_phases(dev, kernels, piso, linsolve) -> None:
    """Phases 41-43: K3-agg-flip on the captured solves (41), the medium and
    hard main paths (42), card against host (43)."""
    _agg_kernel_phase(dev, kernels)
    _agg_main_path(dev, kernels, piso, linsolve)
    _agg_card_vs_host(dev)


# ---------------------------------------------------------------------------
# phases 44-47: the turbulent channel flow, K1-3D and K2-3D
# ---------------------------------------------------------------------------

TCF_SMALL, TCF_LARGE = "TCFSmall3D-bottom-easy-v0", "TCFLarge3D-bottom-easy-v0"
#: the bundled snapshot of phases 44, 45 and 47 (the ``*_00`` snapshots of
#: the Re_tau 180 box relaminarized; ``train_01`` is turbulent)
TCF_SNAPSHOT = ("train", 1)


def _tcf_env(dev, env_id, **kw):
    """``make(env_id)`` on ``dev`` with no randomization: the small box
    loaded from ``TCF_SNAPSHOT``, any other from its generated state."""
    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.types import EnvMode

    if env_id.startswith("TCFSmall") and "easy" in env_id:
        env = fluidgym_tpu_torch.make(env_id, device=dev,
                                      randomize_initial_state=False, **kw)
        env.seed(0)
        env.load_initial_domain(EnvMode(TCF_SNAPSHOT[0]), TCF_SNAPSHOT[1])
        return env
    env = fluidgym_tpu_torch.make(env_id, device=dev, load_initial_domain=False,
                                  randomize_initial_state=False, **kw)
    env.reset(seed=0)
    return env


def _tcf_kernel_phase(dev, kernels, compare) -> dict:
    """Phase 44: K1-3D and K2-3D on the solves of the first substep of one
    sim step of ``TCF_SMALL`` (from ``TCF_SNAPSHOT``) and ``TCF_LARGE``
    (from its generated state), captured at the wrappers: K1 on the
    pressure system and on a random right-hand side of its operator, K2 on
    the velocity system warm (as the solver starts it) and cold, against
    their plain versions with phase 25's bars.  On each the rule's arm
    (``cg_cuda.roll_arm`` / ``cg_cuda_mb.roll_form_arm``) must return the
    chunk grid's x, iterations and residual bit for bit, twice, and is
    timed against it per raw launch in turns; at TCFLarge's width K2's 3
    lanes go one per launch at G = 128.  Returns the rows by width."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    out = {}
    for width, env_id in (("tcf_small", TCF_SMALL), ("tcf_large", TCF_LARGE)):
        env = _tcf_env(dev, env_id)
        seen = capture_calls(env._run_single_step, {
            "K1": (cg_cuda, "fused_cg"), "K2": (cg_cuda_mb, "fused_bicgstab_mb")})
        (diag, off, p_rhs, _), kw1 = seen["K1"][0]
        kw1 = dict(kw1)
        tol1 = kw1.pop("tol")
        (plan, diags, offs, bs), kw2 = seen["K2"][0]
        kw2 = dict(kw2)
        tol2, x0s = kw2.pop("tol"), kw2.pop("x0s")
        shape = tuple(p_rhs.shape[1:])
        n = math.prod(shape)
        check(kw1["ndims"] == 3 and bs[0].shape[0] == 3 and x0s is not None,
              f"{env_id}: the captured solves are not a 3D pressure solve and "
              f"a warm 3-lane velocity solve")
        cap = {G: cg_cuda.spread_capacity(a, 3, G,
                                          cg_cuda.spread_chains(n, G, 3), n, dev)
               for a in ("cg", "bicgstab") for G in cg_cuda.SPREAD_SIZES
               if cg_cuda.spread_fits(n, G)}
        arm1 = cg_cuda.roll_arm(1, n, 3, 1, dev)
        arm2 = cg_cuda_mb.roll_form_arm(3, n, 3, 1, dev)
        log(f"  {env_id} {shape} = {n} cells: spread blocks co-resident per "
            f"G {cap}; chain terms per block {dict((G, cg_cuda.spread_bytes(n, G)) for G in cg_cuda.SPREAD_SIZES)} B; "
            f"K1 arm {arm1}, K2 velocity arm {arm2}")
        want2 = (False, 128, True) if n > 262144 else (False, 32, False)
        check(arm1 == (False, 128) and arm2 == want2,
              f"{env_id}: the rule picks K1 {arm1}, K2 {arm2}, not G = 128 "
              f"and K2 {want2}")
        g = torch.Generator().manual_seed(44)
        other = torch.randn(shape, generator=g).to(dev) * 1e-3
        mv_p = lambda v: cg_cuda.roll_matvec(diag[None], off[None], v, 3)
        d, o, b2, x0 = diags[0], offs[0], bs[0], x0s[0]
        mv_a = lambda v: cg_cuda.roll_matvec(d[None], o[None], v, 3)
        t1, t2 = cg_cuda.tol2_sum_f32(tol1, n), cg_cuda.tol2_sum_f32(tol2, n)
        rows = {}
        for key, b in (("pressure", p_rhs), ("random rhs", (other - other.mean())[None])):
            def call(b=b):
                x, inf = cg_cuda.fused_cg(diag, off, b, tol=tol1, **kw1)
                return x, inf.iterations, inf.residual ** 2 * n

            def plain(b=b):
                return cg_cuda.fused_cg_plain(diag[None], off[None], b, None,
                                              tol2_sum=t1, chunk=1, **kw1)

            err, its = compare(f"K1-3D {width} {key} {tuple(b.shape)}", call,
                               plain, b, tol1, 1e-3, 3, mv_p)
            mk = lambda G, b=b: cg_cuda.launcher(
                diag[None], off[None], b, None, chunk=1, spread=G, tol2_sum=t1,
                **kw1)
            arms = {"grid": mk(0), f"G={arm1[1]}": mk(arm1[1])}
            rows[f"K1-3D {key}"] = _tcf_row(torch, call, plain, arms, err, its,
                                            n, 1, "cg", False)
        for key, x0_ in (("velocity warm", x0), ("velocity cold", None)):
            def call(x0_=x0_):
                xs, inf = cg_cuda_mb.fused_bicgstab_mb(
                    plan, (d,), (o,), (b2,), None if x0_ is None else (x0_,),
                    tol=tol2, **kw2)
                return xs[0], inf.iterations.repeat(3), None

            def plain(x0_=x0_):
                return cg_cuda_mb.fused_bicgstab_plain(
                    d[None], o[None], b2, x0_, ndims=3, tol2_sum=t2, **kw2)

            f = cg_cuda_mb.fused_bicgstab_mb
            before = (f.launches_3d, f.spread_launches)
            err, its = compare(f"K2-3D {width} {key} {tuple(b2.shape)}", call,
                               plain, b2, tol2, 1e-4, 2, mv_a, plain_bar=True)
            k = 3 if arm2[2] else 1
            check((f.launches_3d - before[0], f.spread_launches - before[1])
                  == (k, k), f"{env_id} K2 {key}: the wrapper did not count "
                  f"{k} spread launch(es)")

            def mk(sl, G, x0_=x0_):
                return cg_cuda_mb.launcher(
                    d[None], o[None], b2[sl], None if x0_ is None else x0_[sl],
                    ndims=3, chunk=1, spread=G, tol2_sum=t2, **kw2)
            if arm2[2]:
                lanes = [mk(slice(l, l + 1), arm2[1]) for l in range(3)]
                rule = {f"G={arm2[1]} one lane per launch": lambda lanes=lanes:
                        tuple(torch.cat(t) for t in zip(*[f_() for f_ in lanes]))}
            else:
                rule = {f"G={arm2[1]}": mk(slice(None), arm2[1])}
            rows[f"K2-3D {key}"] = _tcf_row(torch, call, plain,
                                            {"grid": mk(slice(None), 0), **rule},
                                            err, its, n, 3, "bicgstab",
                                            x0_ is not None)
        for k, r in rows.items():
            log(f"  {width} {k}: {r['ms']:.3f} ms per wrapper call; raw launch "
                f"{r['rule']} {r['raw_ms']:.3f} ms = {r['us_per_it']:.2f} "
                f"us/iteration, chunk grid {r['raw_ms_grid']:.3f} ms = "
                f"{r['us_per_it_grid']:.2f} ({r['raw_ms_grid'] / r['raw_ms']:.2f}x)"
                f" at {r['iterations']} iterations; bit-equal twice (plain "
                f"{r['plain_ms']:.3f} ms; bound {r['bound_ms'] * 1e3:.3f} us by "
                f"{r['bound_by']}, streaming {r['stream_ms'] * 1e3:.3f} us)")
        out[width] = dict(env_id=env_id, shape=shape, cells=n,
                          spread_capacity={str(G): c for G, c in cap.items()},
                          k1_arm=list(arm1), k2_arm=list(arm2), systems=rows)
        del env, seen
    log(f"phase 44 K1-3D and K2-3D on the channel's captured solves ok in "
        f"{time.perf_counter() - t0:.1f}s")
    return out


def _tcf_row(torch, call, plain, arms, err, its, n, lanes, algo, warm) -> dict:
    """One phase 44 system: the arms bit for bit and timed in turns, ms per
    wrapper call, the plain version's ms, the bound."""
    turns = arms_in_turns(torch, arms, 2)
    rule = [k for k in arms if k != "grid"][0]
    raw, grid = turns["raw_ms"][rule], turns["raw_ms"]["grid"]
    b_ms, by, stream = bound_ms(n, lanes, 3, its, algo, warm, True)
    return dict(lanes=lanes, iterations=its, max_abs_err=err, rule=rule,
                ms=cuda_ms(torch, call, 2), plain_ms=cuda_ms(torch, plain, 1),
                raw_ms=raw, raw_ms_grid=grid,
                us_per_it=raw * 1e3 / max(its, 1),
                us_per_it_grid=grid * 1e3 / max(its, 1),
                bound_ms=b_ms, bound_by=by, stream_ms=stream)


def _tcf_main_path(dev, piso, linsolve, env_id, steps, ph, make_env) -> dict:
    """``make_env()`` on the card (the counters zeroed just before), then
    ``steps`` steps with seeded numpy actions; the counters read after each
    step.  In every step each substep launches K1-3D twice (its two
    pressure correctors) and K2-3D once, or once per velocity lane where
    ``roll_form_arm`` sends the lanes one per launch; every launch on the
    spread arm; no other kernel form, plain version or ``linsolve`` loop;
    obs of the space's shapes, obs, rewards and wall stresses finite, every
    pressure solve converged."""
    import numpy as np
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    k1, k2 = cg_cuda.fused_cg, cg_cuda_mb.fused_bicgstab_mb
    launches, plains = _counters()
    extra = [(k, a) for k in (k1, k2)
             for a in ("launches_3d", "resident_launches", "spread_launches")]
    calls, restore = count_calls(piso, linsolve)

    def counts():
        out = {"K1": k1.launches, "K2": k2.launches, "K1 3d": k1.launches_3d,
               "K2 3d": k2.launches_3d, "K1 spread": k1.spread_launches,
               "K2 spread": k2.spread_launches,
               "resident": k1.resident_launches + k2.resident_launches}
        out["other"] = sum(getattr(*c) for c in launches) - out["K1"] - out["K2"]
        out["plain"] = sum(getattr(*c) for c in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        return out

    for c in launches + plains + extra:
        setattr(*c, 0)
    torch.cuda.synchronize()
    rows = []
    try:
        t = time.perf_counter()
        env = make_env()
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        reset = counts()
        shape = env._topo.blocks[0].shape
        n = math.prod(shape)
        per_lane = cg_cuda_mb.roll_form_arm(3, n, 3, 1, dev)[2]
        k2_sub = 3 if per_lane else 1
        rng = np.random.default_rng(ph)
        a_shape = tuple(env._zero_action.shape)
        for i in range(steps):
            a = rng.uniform(-1, 1, a_shape).astype(np.float32)
            c0 = counts()
            t = time.perf_counter()
            obs, reward, _, _, info = env.step(a)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            d = {k: v - c0[k] for k, v in counts().items()}
            sub = d["substeps"]
            expect = {"K1": 2 * sub, "K2": k2_sub * sub}
            expect.update({"K1 3d": expect["K1"], "K1 spread": expect["K1"],
                           "K2 3d": expect["K2"], "K2 spread": expect["K2"],
                           "resident": 0, "other": 0, "plain": 0,
                           "linsolve": 0})
            check(sub > 0 and all(d[k] == v for k, v in expect.items()),
                  f"{env_id} step {i}: launches {d}, expected {expect}")
            for k, v in obs.items():
                want = env.observation_space[k].shape
                if env.use_marl:
                    want = (env.n_agents,) + tuple(want)
                check(tuple(v.shape) == tuple(want), f"{env_id} obs {k} shape "
                      f"{tuple(v.shape)} != {want}")
                check(bool(torch.isfinite(v).all()), f"{env_id} obs {k} not finite")
            taus = {k: float(info[k]) for k in env.metrics}
            check(bool(torch.isfinite(reward).all())
                  and all(math.isfinite(v) and v > 0 for v in taus.values()),
                  f"{env_id}: reward or wall stresses {taus} not finite")
            check(bool(info["pressure_converged"]),
                  f"{env_id} step {i}: a pressure solve did not converge")
            rows.append(dict(s=step_s, substeps=sub, K1=d["K1"], K2=d["K2"],
                             pressure_iterations=int(info["pressure_iterations"]),
                             wall_stress_bottom=taus["wall_stress_bottom"]))
    finally:
        restore()
    total = counts()
    out = dict(env_id=env_id, shape=tuple(shape), cells=n, marl=env.use_marl,
               n_agents=env.n_agents, k2_per_substep=k2_sub, reset_s=reset_s,
               reset_launches={k: reset[k] for k in ("K1", "K2")},
               ms_step=1e3 * sum(r["s"] for r in rows) / len(rows),
               step_ms=[1e3 * r["s"] for r in rows],
               substeps=[r["substeps"] for r in rows],
               pressure_iterations=[r["pressure_iterations"] for r in rows],
               wall_stress_bottom=[r["wall_stress_bottom"] for r in rows],
               launches={k: total[k] for k in ("K1", "K2", "K1 3d", "K2 3d",
                                               "K1 spread", "K2 spread")},
               step_launches=[{k: r[k] for k in ("K1", "K2")} for r in rows])
    log(f"phase {ph} {env_id} {out['shape']} "
        f"({'MARL, ' + str(env.n_agents) + ' agents' if env.use_marl else 'SARL'}): "
        f"reset {reset_s:.2f}s (launches {out['reset_launches']}), steps "
        f"{[round(r['s'], 3) for r in rows]} s = {out['ms_step']:.1f} ms/env "
        f"step, substeps {out['substeps']}, pressure iterations "
        f"{out['pressure_iterations']}, wall stress bottom "
        f"{[f'{v:.6e}' for v in out['wall_stress_bottom']]}, per-step launches "
        f"{out['step_launches']}, totals {out['launches']}; every K1-3D / "
        f"K2-3D launch on the spread arm ({k2_sub} K2 per substep), no other "
        f"form, plain version or linsolve loop")
    return out


def _tcf_card_vs_host(dev) -> dict:
    """Phase 47: ``TCF_SMALL`` (SARL) from ``TCF_SNAPSHOT``, 1 env step (10
    sim steps) with a fixed action on the card and on the host: velocity
    obs and wall stresses within 1e-4 of each quantity's scale, pressure
    obs within 1e-3."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    outs, its = {}, {}
    for where in (dev, torch.device("cpu")):
        e = _tcf_env(where, TCF_SMALL, use_marl=False, episode_length=2)
        a = np.linspace(-1, 1, e.n_agents, dtype=np.float32).reshape(-1, 1)
        o, _, _, _, info = e.step(a)
        outs[where.type] = {k: v.cpu().reshape(-1) for k, v in dict(
            o, **{k: info[k] for k in e.metrics}).items()}
        its[where.type] = int(info["pressure_iterations"])
    og, oc = outs[dev.type], outs["cpu"]
    diffs = {k: float((og[k] - oc[k]).abs().max()
                      / oc[k].abs().max().clamp(min=1e-30)) for k in og}
    bars = {k: 1e-3 if k == "pressure" else 1e-4 for k in og}
    log(f"phase 47 {TCF_SMALL} (SARL) full width, 1 env step from "
        f"{TCF_SNAPSHOT[0]}_{TCF_SNAPSHOT[1]:02d} (pressure iterations {its}), "
        f"card vs host: relative diffs {diffs} (bars {bars}) in "
        f"{time.perf_counter() - t0:.2f}s")
    check(all(v <= bars[k] for k, v in diffs.items()),
          f"card and host disagree on {TCF_SMALL}: {diffs}")
    return dict(diffs=diffs, pressure_iterations=its)


def _tcf_phases(dev, kernels, compare, piso, linsolve) -> None:
    """Phases 44-47: K1-3D and K2-3D on the channel's captured solves (44),
    the small box's main paths at their registered defaults (45), TCFLarge
    and the Re_tau 550 small box from their generated states (46), card
    against host (47).  K1-3D and K2-3D gain ``tcf_small`` and
    ``tcf_large`` entries: the phase 44 rows of the main solve, and the
    launches of phases 45 and 46 at each width."""
    rows = _tcf_kernel_phase(dev, kernels, compare)
    t0 = time.perf_counter()
    small = [_tcf_main_path(dev, piso, linsolve, env_id, 2, 45,
                            lambda env_id=env_id: _tcf_default_reset(env_id))
             for env_id in (TCF_SMALL, "TCFSmall3D-both-easy-v0")]
    log(f"phase 45 the small channel at its registered defaults ok in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    gen = [_tcf_main_path(dev, piso, linsolve, env_id, 1, 46,
                          lambda env_id=env_id: _tcf_env(dev, env_id))
           for env_id in (TCF_LARGE, "TCFSmall3D-bottom-hard-v0")]
    check(gen[0]["k2_per_substep"] == 3 and gen[0]["cells"] == 1048576,
          f"{TCF_LARGE}: the velocity lanes did not go one per launch")
    log(f"phase 46 the channel from generated states ok in "
        f"{time.perf_counter() - t0:.1f}s")
    host = _tcf_card_vs_host(dev)
    main = {"K1-3D": "K1-3D random rhs", "K2-3D": "K2-3D velocity warm"}
    for name, k in (("K1-3D", "K1"), ("K2-3D", "K2")):
        for width, runs in (("tcf_small", small + gen[1:]),
                            ("tcf_large", gen[:1])):
            r = rows[width]["systems"][main[name]]
            steps = [d[k] for run in runs for d in run["step_launches"]]
            kernels[name][width] = dict(
                {x: r[x] for x in ("lanes", "iterations", "max_abs_err", "rule",
                                   "ms", "plain_ms", "raw_ms", "raw_ms_grid",
                                   "us_per_it", "us_per_it_grid", "bound_ms",
                                   "bound_by", "stream_ms")},
                env_id=rows[width]["env_id"], shape=rows[width]["shape"],
                system=main[name], systems=rows[width]["systems"],
                spread_capacity=rows[width]["spread_capacity"],
                launches=sum(run["launches"][f"{k} spread"] for run in runs),
                launches_per_env_step=sum(steps) / len(steps),
                main_path={run["env_id"]: {x: run[x] for x in (
                    "ms_step", "step_ms", "reset_s", "substeps",
                    "pressure_iterations", "k2_per_substep")} for run in runs},
                card_vs_host=host["diffs"] if width == "tcf_small" else None)
            kernels[name]["max_abs_err"] = max(
                [kernels[name]["max_abs_err"]]
                + [v["max_abs_err"] for s_, v in rows[width]["systems"].items()
                   if s_.startswith(name)])


def _tcf_default_reset(env_id):
    """``make(env_id)`` at its registered defaults on the card and
    ``reset(seed=0)`` (randomized: noise and a few uncontrolled sim steps
    from a bundled snapshot)."""
    import fluidgym_tpu_torch

    env = fluidgym_tpu_torch.make(env_id)
    env.reset(seed=0)
    return env



# ---------------------------------------------------------------------------
# phases 48-50: Airfoil3D-easy, the 3D flip forms K3-3D-flip and K2-mb-3D-flip
# ---------------------------------------------------------------------------

AIRFOIL3D = "Airfoil3D-easy-v0"
#: the registered config but for two settings: no ``airfoil_3D_*`` set is
#: bundled (``load_initial_domain=True`` raises), so the reset builds the
#: flow and warm-starts it from the 2D ``airfoil_2D_Re1000/train_{idx}``
#: (seed 23 draws idx 0, the one train file the chip copy holds); and no
#: randomization, whose 6-10 uncontrolled sim steps would take minutes at
#: 7,051,776 cells
AIRFOIL3D_KW = dict(load_initial_domain=False, randomize_initial_state=False)
AIRFOIL3D_SEED = 23
#: phase 50's span: 8 cells (587,648 in all), whose chain terms fit shared
#: memory, small enough for the host's plain versions
AIRFOIL3D_HOST_RES_Z = 8
#: iterations of phase 48's raw launches at full width (the chunk grid
#: takes ~20 ms per iteration there): enough for the bit-for-bit check and
#: the time per iteration
AIRFOIL3D_RAW_ITERS = 100


def _first_solves(run):
    """``(run(), seen)``: the first call of ``fused_cg_mb`` (``"K3"``) and of
    ``fused_bicgstab_mb`` (``"K2"``) while ``run()`` runs (the first
    substep's pressure and velocity solves), captured by
    ``capture_calls``."""
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    out = []
    seen = capture_calls(lambda: out.append(run()), {
        "K3": (cg_cuda_mb, "fused_cg_mb"),
        "K2": (cg_cuda_mb, "fused_bicgstab_mb")}, first=True)
    return out[0], {k: v[0] for k, v in seen.items() if v}


def _airfoil3d_main_path(dev, piso, linsolve) -> dict:
    """Phase 49: ``Airfoil3D-easy-v0`` at its registered defaults but
    ``AIRFOIL3D_KW`` and ``step_length`` = dt (one sim step),
    ``reset(seed=23)`` and one env step with a seeded action.  Counters
    zeroed just before ``make`` and read after the reset and the step: per
    substep 2 K3-3D-flip and 3 K2-mb-3D-flip launches (the velocity lanes
    one per launch), every one on the spread arm with its chain terms
    through the ring, no chunk grid, cluster, other kernel form, plain version
    or ``linsolve`` loop.  The 2D warm start applied to all six blocks (no
    uniform fallback); obs, reward and per-slice drag and lift finite, every
    pressure solve converged.  The first substep's solves are captured for
    phase 48."""
    import logging

    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    launches, plains = _counters()
    extra = [(k3, "flip_launches_3d"), (k2, "merged_flip_launches_3d"),
             (k3, "spread_launches"), (k2, "merged_spread_launches"),
             (k3, "ring_launches"), (k2, "merged_ring_launches"),
             (k3, "cluster_launches"), (k2, "cluster_launches")]
    calls, restore = count_calls(piso, linsolve)

    def counts():
        out = {"K3-3D-flip": k3.flip_launches_3d,
               "K2-mb-3D-flip": k2.merged_flip_launches_3d,
               "K3 ring": k3.ring_launches,
               "K2-mb ring": k2.merged_ring_launches,
               "K3 spread": k3.spread_launches,
               "K2-mb spread": k2.merged_spread_launches,
               "cluster": k3.cluster_launches + k2.cluster_launches}
        out["other"] = (sum(getattr(*c) for c in launches)
                        - k3.flip_launches - k2.merged_flip_launches)
        out["plain"] = sum(getattr(*c) for c in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        return out

    warned = []

    class Seen(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    handler = Seen(level=logging.WARNING)
    logging.getLogger("AirfoilEnv3D").addHandler(handler)
    for c in launches + plains + extra:
        setattr(*c, 0)
    torch.cuda.synchronize()
    warm = {}
    try:
        t = time.perf_counter()
        env = fluidgym_tpu_torch.make(AIRFOIL3D, step_length=0.05, **AIRFOIL3D_KW)
        apply_2d = env._apply_2d_initial_state

        def recorded(state):
            out = apply_2d(state)
            warm["blocks"] = [not torch.equal(a.velocity, b.velocity)
                              for a, b in zip(out.blocks, state.blocks)]
            return out

        env._apply_2d_initial_state = recorded
        obs, _ = env.reset(seed=AIRFOIL3D_SEED)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        reset = counts()
        cells = sum(math.prod(b.shape) for b in env._topo.blocks)
        check(cells == 7051776, f"{AIRFOIL3D} has {cells} cells, not 7,051,776")
        check(warm.get("blocks") == [True] * 6 and not any(
            "2D" in w for w in warned),
              f"{AIRFOIL3D}: the 2D warm start did not apply to every block "
              f"({warm}, warnings {warned})")
        a = np.random.default_rng(49).uniform(
            -1, 1, tuple(env.action_space.shape)).astype(np.float32)
        c0 = counts()
        t = time.perf_counter()
        (obs, reward, _, _, info), seen = _first_solves(lambda: env.step(a))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        d = {k: v - c0[k] for k, v in counts().items()}
    finally:
        restore()
        logging.getLogger("AirfoilEnv3D").removeHandler(handler)
    sub = d["substeps"]
    expect = {"K3-3D-flip": 2 * sub, "K3 ring": 2 * sub, "K3 spread": 2 * sub,
              "K2-mb-3D-flip": 3 * sub, "K2-mb ring": 3 * sub,
              "K2-mb spread": 3 * sub, "cluster": 0, "other": 0, "plain": 0,
              "linsolve": 0}
    check(sub > 0 and all(d[k] == v for k, v in expect.items()),
          f"{AIRFOIL3D} step: launches {d}, expected {expect}")
    check(reset["plain"] == 0 and reset["linsolve"] == 0
          and reset["K3-3D-flip"] == reset["K3 ring"] > 0,
          f"{AIRFOIL3D} reset: launches {reset}")
    for k, v in obs.items():
        check(tuple(v.shape) == tuple(env.observation_space[k].shape),
              f"{AIRFOIL3D} obs {k} shape {tuple(v.shape)}")
        check(bool(torch.isfinite(v).all()), f"{AIRFOIL3D} obs {k} not finite")
    cds, cls = info["all_cds"], info["all_cls"]
    check(tuple(cds.shape) == (96,) and bool(torch.isfinite(cds).all())
          and bool(torch.isfinite(cls).all())
          and bool(torch.isfinite(reward).all()),
          f"{AIRFOIL3D}: reward or per-slice drag / lift not finite")
    check(bool(info["pressure_converged"].all()),
          f"{AIRFOIL3D}: a pressure solve did not converge "
          f"(residual {float(info['pressure_residual'].max()):.3e})")
    check(set(seen) == {"K3", "K2"}, f"{AIRFOIL3D}: solves captured {set(seen)}")
    r = dict(cells=cells, reset_s=reset_s, ms_step=1e3 * step_s, substeps=sub,
             pressure_iterations=int(info["pressure_iterations"]),
             pressure_converged=bool(info["pressure_converged"].all()),
             drag=float(info["drag"]), lift=float(info["lift"]),
             reset_launches={k: reset[k] for k in ("K3-3D-flip", "K2-mb-3D-flip")},
             step_launches={k: d[k] for k in ("K3-3D-flip", "K2-mb-3D-flip")},
             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"phase 49 {AIRFOIL3D} {[b.shape for b in env._topo.blocks]} = {cells} "
        f"cells (SARL, {env.n_agents} segments; 2D warm start from train_00): "
        f"reset {reset_s:.2f}s (launches {r['reset_launches']}), 1 sim step "
        f"{step_s:.3f} s, substeps {sub}, pressure iterations "
        f"{r['pressure_iterations']} (converged), drag {r['drag']:.5f}, lift "
        f"{r['lift']:.5f}, launches {d}; every K3-3D-flip / K2-mb-3D-flip "
        f"launch on the spread arm with its chain terms through the ring; peak "
        f"device memory {r['peak_gb']:.2f} GB")
    return dict(r, seen=seen)


def _airfoil3d_card_vs_host(dev) -> dict:
    """Phase 50: ``Airfoil3D-easy-v0`` with ``_res_z`` = 8 (587,648 cells),
    ``AIRFOIL3D_KW``, one sim step of 0.01 (``step_length`` = dt = 0.01)
    from ``reset(seed=23)`` on the card and on the host: velocity obs and
    reward within 1e-4, pressure obs within 1e-3 (phase 43's bars).  The
    card's first substep solves are captured for phase 48."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.envs.airfoil.airfoil_env_3d import AirfoilEnv3D

    t = time.perf_counter()
    outs, its, seen = {}, {}, {}
    span = AirfoilEnv3D._res_z
    AirfoilEnv3D._res_z = AIRFOIL3D_HOST_RES_Z
    try:
        for where, side in ((dev, "card"), (torch.device("cpu"), "host")):
            e = fluidgym_tpu_torch.make(AIRFOIL3D, device=where,
                                        load_domain_statistics=False,
                                        step_length=0.01, dt=0.01,
                                        **AIRFOIL3D_KW)
            e.reset(seed=AIRFOIL3D_SEED)
            cells = sum(math.prod(b.shape) for b in e._topo.blocks)
            a = np.linspace(-0.8, 0.8, 12, dtype=np.float32).reshape(4, 3)
            if side == "card":
                (o, r, _, _, info), seen = _first_solves(lambda: e.step(a))
            else:
                o, r, _, _, info = e.step(a)
            outs[side] = {k: v.cpu() for k, v in dict(o, reward=r).items()}
            its[side] = int(info["pressure_iterations"])
    finally:
        AirfoilEnv3D._res_z = span
    og, oc = outs["card"], outs["host"]
    diffs = {k: float((og[k] - oc[k]).abs().max()
                      / oc[k].abs().max().clamp(min=1e-30)) for k in og}
    bars = {"velocity": 1e-4, "reward": 1e-4, "pressure": 1e-3}
    log(f"phase 50 {AIRFOIL3D} at _res_z {AIRFOIL3D_HOST_RES_Z} ({cells} cells), "
        f"1 sim step of 0.01 from reset(seed={AIRFOIL3D_SEED}) (pressure "
        f"iterations {its}), card vs host: relative diffs {diffs} (bars "
        f"{bars}) in {time.perf_counter() - t:.2f}s")
    check(all(v <= bars[k] for k, v in diffs.items()),
          f"card and host disagree on {AIRFOIL3D}: {diffs}")
    check(set(seen) == {"K3", "K2"}, f"res_z 8: solves captured {set(seen)}")
    return dict(diffs=diffs, pressure_iterations=its, seen=seen)


def _flip3d_system(name, algo, sy, key, ring, raw_iters=None) -> dict:
    """One captured 3D flip solve (``merged_system``): the wrapper (the
    rule's arm) against the plain version, then the chunk grid and the
    spread arm at the rule's G (one launch per lane where the rule sends
    the lanes one per launch), its chain terms through the ring or all in
    shared memory, bit for bit twice and per raw launch in turns;
    ``raw_iters`` caps the raw launches' iterations (the chunk grid's time
    at full width)."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    dev = torch.device("cuda")
    plan, diags, offs, bs, x0s, tol, kw = _captured_lanes(sy, key)
    L = bs[0].shape[0]
    n = sum(math.prod(sb.shape) for sb in plan.superblocks)
    check(plan.ndims == 3 and not plan.identity_seams
          and L == (1 if algo == "cg" else 3),
          f"the captured {name} solve is not the {L}-lane 3D flip solve")
    arm = cg_cuda_mb.merged_arm(L, n, 3, 1, dev, algo)
    G = arm.spread
    check(G > 0 and arm.cluster == 1, f"{name}: merged_arm {arm} takes no "
          "spread arm")
    one = 1 if arm.per_lane else L
    check(cg_cuda.spread_ring(one, n, 3) == ring,
          f"{name}: the rule "
          f"{'keeps all the chain terms in shared memory' if ring else 'takes the ring'}")
    rkw = dict(kw, maxiter=raw_iters) if raw_iters else kw
    where = "ring" if ring else "shared"

    def arms(diag, off, b, x0, t2):
        def mk(sl, G):
            one_ = lambda t: t if t is None or t.shape[0] == 1 else t[sl]
            return cg_cuda_mb.merged_launcher(
                algo, plan, one_(diag), one_(off), b[sl], one_(x0),
                tol2_sum=t2, chunk=1, spread=G, **rkw)
        if not arm.per_lane:
            return {"grid": mk(slice(None), 0),
                    f"G={G} {where}": mk(slice(None), G)}
        lanes = [mk(slice(l, l + 1), G) for l in range(L)]
        return {"grid": mk(slice(None), 0),
                f"G={G} {where} one lane per launch": lambda: tuple(
                    torch.cat(t) for t in zip(*[f() for f in lanes]))}

    rel, it_tol = (1e-3, 3) if algo == "cg" else (1e-4, 2)
    r = merged_system(f"{name} ({L}, {n})", algo, plan, diags, offs, bs, x0s,
                      tol, kw, arms, rel, it_tol, 1 if raw_iters else 3)
    rule = [k for k in r["raw_ms"] if k != "grid"][0]
    raw, grid = r["raw_ms"][rule], r["raw_ms"]["grid"]
    raw_its = min(r["iterations"], raw_iters) if raw_iters else r["iterations"]
    smem = cg_cuda.spread_smem(n, G, cg_cuda.CHAINS_RING if ring else 1)
    b_raw, by_raw, stream_raw = bound_ms(n, L, 3, raw_its, algo,
                                         x0s is not None, True,
                                         _seam_cells(plan))
    r.update(rule=rule, G=G, per_lane=arm.per_lane, raw_ms_rule=raw,
             raw_ms_grid=grid, raw_iterations=raw_its,
             us_per_it=raw * 1e3 / max(raw_its, 1),
             us_per_it_grid=grid * 1e3 / max(raw_its, 1),
             raw_bound_ms=b_raw, raw_stream_ms=stream_raw,
             smem_bytes=smem, ring=ring)
    log(f"  {name} ({L}, {n}): {r['ms']:.3f} ms per wrapper call at "
        f"{r['iterations']} iterations (plain {r['plain_ms']:.3f} ms; bound "
        f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, streaming "
        f"{r['stream_ms'] * 1e3:.3f} us); raw launch {rule} {raw:.3f} ms = "
        f"{r['us_per_it']:.2f} us/iteration, chunk grid {grid:.3f} ms = "
        f"{r['us_per_it_grid']:.2f} ({grid / raw:.2f}x) at {raw_its} "
        f"iterations, bit-equal twice; {smem} B of shared memory per block, "
        f"no chain term in global memory")
    return r


def _airfoil3d_kernel_phase(dev, kernels, full, small) -> None:
    """Phase 48: K3-3D-flip and K2-mb-3D-flip on the first substep's solves
    of phase 49 (full width, 7,051,776 cells): the wrapper (the spread arm,
    chain terms through the ring) against the plain version with phase
    32's bars and the same converged flags; the arm bit-equal to the chunk
    grid twice, both timed per raw launch in turns at ``AIRFOIL3D_RAW_ITERS``
    iterations: ms, us per iteration, the bound, the streamed bound and the
    shared memory per block.  The same forms on phase 50's card solves at
    ``_res_z`` 8 (587,648 cells), whose terms fit: the shared-memory spread
    arm bit-equal to the chunk grid.  And CylinderJet3D-easy's captured
    341,568-cell solves with the ring pinned (``cg_cuda.pinned_ring``):
    bit-equal to the shared-memory spread arm twice, both timed in
    turns."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    rows = {}
    for key, algo, name in (("K3", "cg", "K3-3D-flip"),
                            ("K2", "bicgstab", "K2-mb-3D-flip")):
        sy = {k: v for k, v in full["seen"].items()}
        rows[name] = {"full": _flip3d_system(name, algo, sy, key, True,
                                             AIRFOIL3D_RAW_ITERS)}
        rows[name]["res_z 8"] = _flip3d_system(name, algo, small["seen"], key,
                                               False)
    # the pin on CylinderJet3D-easy: the ring against shared memory
    sy = _captured_merged(dev, CYL3D_EASY)
    pinned = {}
    for key, algo, name in (("K3", "cg", "K3-3D"), ("K2", "bicgstab", "K2-mb-3D")):
        plan, diags, offs, bs, x0s, tol, kw = _captured_lanes(sy, key)
        diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
        b = cg_cuda_mb.flatten_fields(plan, bs)
        x0 = None if x0s is None else cg_cuda_mb.flatten_fields(plan, x0s)
        L, n = b.shape
        G = cg_cuda_mb.merged_arm(L, n, 3, 1, torch.device("cuda"), algo).spread
        with cg_cuda.pinned_ring(True):
            check(cg_cuda.spread_ring(L, n, 3),
                  "the pin does not send the chain terms through the ring")
        t2 = cg_cuda.tol2_sum_f32(tol, n)
        mk = lambda ring: cg_cuda_mb.merged_launcher(
            algo, plan, diag, off, b, x0, tol2_sum=t2, chunk=1, spread=G,
            ring=ring, **kw)
        turns = arms_in_turns(torch, {f"G={G} shared": mk(False),
                                      f"G={G} ring (pinned)": mk(True)}, 5)
        ms = turns["raw_ms"]
        pinned[name] = dict(cells=n, lanes=L, G=G,
                            iterations=turns["iterations"], raw_ms=ms)
        log(f"  {name} on {CYL3D_EASY}'s captured solve ({L}, {n}) at G = {G}: "
            f"the ring (pinned) bit-equal to all terms in shared memory "
            f"twice; per raw launch {ms} ms at {turns['iterations']} "
            f"iterations")
    for name, algo_src, rep in (("K3-3D-flip", "cg.cu", 284),
                                ("K2-mb-3D-flip", "bicgstab_mb.cu", 458)):
        r = rows[name]["full"]
        what = "Jacobi-PCG" if name.startswith("K3") else "right-Jacobi BiCGStab"
        kernels[name] = dict(
            name=f"{name} ({what}, 3D merged frame with the reflected wake "
                 f"cut, periodic z; the spread arm {r['rule']}, chain terms "
                 "through a ring of tiles in shared memory)",
            route="cuda",
            source=f"fluidgym_tpu_torch/csrc/{algo_src} + "
                   "fluidgym_tpu_torch/csrc/merged.cuh + "
                   "fluidgym_tpu_torch/csrc/krylov.cuh",
            replaces=f"fluidgym_tpu/ops/cg_pallas_mb.py:{rep}",
            max_abs_err=max(v["max_abs_err"] for v in rows[name].values()),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, stream_ms=r["stream_ms"],
            iterations=r["iterations"], shape=f"({r['lanes']}, {r['cells']})",
            arm=r["rule"], raw_ms=r["raw_ms_rule"],
            raw_iterations=r["raw_iterations"], us_per_it=r["us_per_it"],
            raw_ms_grid=r["raw_ms_grid"], us_per_it_grid=r["us_per_it_grid"],
            raw_bound_ms=r["raw_bound_ms"], raw_stream_ms=r["raw_stream_ms"],
            smem_bytes=r["smem_bytes"],
            res_z_8={x: rows[name]["res_z 8"][x] for x in (
                "cells", "iterations", "ms", "plain_ms", "rule", "raw_ms_rule",
                "raw_ms_grid", "us_per_it", "us_per_it_grid", "bound_ms",
                "bound_by", "stream_ms", "max_abs_err")},
            pinned_on_cylinder3d_easy=pinned[name[:-5]])
    log(f"phase 48 K3-3D-flip and K2-mb-3D-flip ok: the spread arm with its "
        f"chain terms through the ring bit-equal to the chunk grid at "
        f"7,051,776 cells and to the shared-memory spread arm at 341,568; the "
        f"shared-memory arm bit-equal to the chunk grid at 587,648, in "
        f"{time.perf_counter() - t0:.1f}s")


def _airfoil3d_phases(dev, kernels, piso, linsolve) -> None:
    """Phases 48-50, run as 49, 50, 48: the full-width main path (49) and
    the card against the host at ``_res_z`` 8 (50) capture the first
    substep's solves that phase 48 holds against the plain versions and
    the chunk grid, so their launches stay out of phase 49's counts."""
    full = _airfoil3d_main_path(dev, piso, linsolve)
    small = _airfoil3d_card_vs_host(dev)
    _airfoil3d_kernel_phase(dev, kernels, full, small)
    for name in ("K3-3D-flip", "K2-mb-3D-flip"):
        kernels[name].update(
            launches=full["step_launches"][name],
            launches_per_env_step=full["step_launches"][name],
            main_path={x: full[x] for x in (
                "cells", "reset_s", "ms_step", "substeps",
                "pressure_iterations", "pressure_converged", "drag", "lift",
                "reset_launches", "peak_gb")},
            card_vs_host=small["diffs"])


#: the differentiable path's ids (phases 51-52) and the kernel forms their
#: solves take: (wrapper attribute, counter) per form
DIFF_CASES = (
    dict(env_id="RBC2D-easy-v0", ph=51, arm="resident_launches",
         forms={"K1": ("cg", "launches"), "K2": ("bicg", "launches")}),
    dict(env_id="CylinderJet2D-easy-v0", ph=52, arm="cluster_launches",
         forms={"K3": ("cg_mb", "launches"),
                "K2-mb": ("bicg", "merged_launches")}),
)


#: phases 51-53: the largest gap of the action's gradient through the
#: kernels from the one through their plain versions on the card, relative
#: to the plain one's max|g|, set from readings on an H100 (PERF.md §6,
#: scripts/port_diff_fault_check.py): sound 3.8e-7 / 1.9e-7 / 9.0e-6; the
#: smallest planted fault in the kernel run alone (K1 / K3's adjoint off
#: by 1%) 2.7e-3 / 3.4e-4 / 1.3e-2, and K2 / K2-mb on A for A^T 2.0 /
#: 6.0e-3 / 0.13
DIFF_PLAIN_BARS = {51: 1e-5, 52: 1e-5, 53: 1e-4}
#: phase 53: the same gap against the host in float64 (sound 2.9e-5; the
#: faults above 1.3e-2 and 0.13)
DIFF_HOST_BAR = 1e-3


def _plain_on_card(cg_cuda, cg_cuda_mb):
    """Within: the kernels' wrappers run their plain versions on card
    tensors (their device test answering "cpu")."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        kind = cg_cuda.device_kind
        cg_cuda.device_kind = cg_cuda_mb.device_kind = lambda b, what: "cpu"
        try:
            yield
        finally:
            cg_cuda.device_kind = cg_cuda_mb.device_kind = kind
    return ctx()


def _diff_main_path(dev, kernels, piso, linsolve, case, fault=None) -> dict:
    """Phase 51 / 52: ``make(id, differentiable=True)`` at the registered
    defaults, ``reset(seed=0)``, one env step with an action that requires
    grad, then ``reward.sum().backward()``.  The counters are zeroed before
    the step and read after it (the forward), zeroed again and read after
    the backward: per substep the forward launches its forms as the RL
    path does, and the backward launches each form once per forward solve
    (the transposed solves: K1 / K3 on A, K2 / K2-mb on ``A^T``), every
    launch on the single env's arm (resident / cluster); no plain version,
    no ``linsolve`` loop.  The pressure's deflation guess (the cylinder) is
    taken once per forward and once per transposed K3 solve (recomputed
    from the cotangent).  The action's gradient is finite and non-zero;
    forward and backward ms and the peak device memory above what was
    allocated before the step are printed.  Then the same step and
    backward from the same state and action run through the plain
    versions on the card, with no launch: ``gap_plain`` is the largest gap
    of the two gradients over the plain one's max|g| (the caller holds it
    to its bar).  ``fault``: a context manager entered around the kernels'
    step and backward alone (a planted fault, for the bar's readings)."""
    import contextlib

    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.core.domain import DomainState, map_state
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    env_id, ph = case["env_id"], case["ph"]
    wrappers = {"cg": cg_cuda.fused_cg, "cg_mb": cg_cuda_mb.fused_cg_mb,
                "bicg": cg_cuda_mb.fused_bicgstab_mb}
    plains = (cg_cuda.fused_cg_plain, cg_cuda_mb.fused_cg_mb_plain,
              cg_cuda_mb.fused_bicgstab_plain)
    counted = [(w, a) for w in wrappers.values() for a in (
        "launches", "merged_launches", "merged_flip_launches", "flip_launches",
        "resident_launches", "cluster_launches", "coarse_launches",
        "coarse_flip_launches", "agg_launches", "agg_flip_launches")
        if hasattr(w, a)]
    calls, restore = count_calls(piso, linsolve)
    guesses = {"n": 0}
    make_x0 = piso._make_deflation_x0

    def counted_x0(*a, **k):
        fn = make_x0(*a, **k)

        def x0_fn(*aa, **kk):
            guesses["n"] += 1
            return fn(*aa, **kk)
        return x0_fn

    def zero():
        for w, a in counted:
            setattr(w, a, 0)
        for f in plains:
            f.calls = 0
        calls.update({k: 0 for k in calls})
        guesses["n"] = 0

    def read():
        out = {k: getattr(wrappers[w], a) for k, (w, a) in case["forms"].items()}
        out["all"] = sum(getattr(w, a) for w, a in counted
                         if a not in ("resident_launches", "cluster_launches"))
        out["arm"] = sum(getattr(wrappers[w], case["arm"])
                         for w in {w for w, _ in case["forms"].values()})
        out["plain"] = sum(f.calls for f in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        out["deflation_guesses"] = guesses["n"]
        return out

    piso._make_deflation_x0 = counted_x0
    try:
        t = time.perf_counter()
        env = fluidgym_tpu_torch.make(env_id, differentiable=True)
        env.reset(seed=0)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        check(env._cfg.differentiable, f"{env_id}: the config is not differentiable")
        rng = np.random.default_rng(0)
        a = torch.tensor(rng.uniform(-1, 1, env.action_space.shape),
                         dtype=torch.float32, device=dev, requires_grad=True)
        carry0 = tuple(map_state(c, torch.Tensor.clone)
                       if isinstance(c, DomainState) else c.clone()
                       for c in env._pure_carry())
        n_steps0 = env._n_steps
        zero()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with fault() if fault is not None else contextlib.nullcontext():
            t = time.perf_counter()
            obs, reward, _, _, info = env.step(a)
            torch.cuda.synchronize()
            fwd_ms = 1e3 * (time.perf_counter() - t)
            fwd = read()
            zero()
            t = time.perf_counter()
            reward.sum().backward()
            torch.cuda.synchronize()
            bwd_ms = 1e3 * (time.perf_counter() - t)
            bwd = read()
        # the step's graph and the backward above what earlier phases hold
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        # the same step and backward through the plain versions on the card
        env._set_pure_carry(carry0)
        env._n_steps = n_steps0
        a_plain = a.detach().clone().requires_grad_(True)
        zero()
        t = time.perf_counter()
        with _plain_on_card(cg_cuda, cg_cuda_mb):
            _, r_plain, *_ = env.step(a_plain)
            r_plain.sum().backward()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        plain = read()
    finally:
        piso._make_deflation_x0 = make_x0
        restore()
    g = a.grad
    check(g is not None and bool(torch.isfinite(g).all())
          and float(g.abs().max()) > 0,
          f"{env_id}: the action's gradient is not finite and non-zero: {g}")
    check(bool(torch.isfinite(reward).all()) and reward.requires_grad,
          f"{env_id}: the reward is not finite or carries no graph")
    for k, v in obs.items():
        check(bool(torch.isfinite(v).all()), f"{env_id}: obs {k} not finite")
    check(bool(info["pressure_converged"]) and int(info["pressure_iterations"]) == 0,
          f"{env_id}: diff-mode info {info['pressure_converged']}, "
          f"{info['pressure_iterations']} (expected converged, 0 iterations)")
    n_sub = fwd["substeps"]
    per_sub = {"K1": 2, "K2": 2, "K3": 2, "K2-mb": 1}
    for k in case["forms"]:
        check(fwd[k] == per_sub[k] * n_sub,
              f"{env_id}: forward {k} launches {fwd[k]} != {per_sub[k]} x "
              f"{n_sub} substeps")
        check(bwd[k] == fwd[k],
              f"{env_id}: backward {k} launches {bwd[k]} != forward {fwd[k]}")
    for name, c in (("forward", fwd), ("backward", bwd)):
        forms = sum(c[k] for k in case["forms"])
        check(c["all"] == forms and c["arm"] == forms,
              f"{env_id}: {name} launches {c}: another kernel form, or a "
              f"launch off the {case['arm']} arm")
        check(c["plain"] == 0 and c["linsolve"] == 0,
              f"{env_id}: a plain version or a linsolve loop ran in the {name}: {c}")
    check(bwd["substeps"] == 0, f"{env_id}: the backward ran a substep: {bwd}")
    check(plain["all"] == 0 and plain["plain"] == sum(
        fwd[k] + bwd[k] for k in case["forms"]) and plain["linsolve"] == 0,
        f"{env_id}: the plain run launched a kernel or ran another number of "
        f"solves: {plain}")
    g_plain = a_plain.grad
    check(g_plain is not None and bool(torch.isfinite(g_plain).all()),
          f"{env_id}: the plain run's gradient is not finite: {g_plain}")
    gap_plain = float((g - g_plain).abs().max() / g_plain.abs().max())
    if "K3" in case["forms"]:
        check(fwd["deflation_guesses"] == fwd["K3"]
              and bwd["deflation_guesses"] == bwd["K3"],
              f"{env_id}: deflation guesses forward {fwd['deflation_guesses']}"
              f" / backward {bwd['deflation_guesses']} against K3 "
              f"{fwd['K3']} / {bwd['K3']}")
    log(f"phase {ph} {env_id} differentiable=True: reset {reset_s:.2f}s, "
        f"one env step forward {fwd_ms:.1f} ms ({n_sub} substeps, "
        f"{env.n_sim_steps} sim steps), backward {bwd_ms:.1f} ms, peak "
        f"device memory {peak_gb:.3f} GB above the {base / 1e9:.3f} GB held "
        f"before the step; launches forward {fwd}, backward "
        f"{bwd}; d(reward)/d(action) max {float(g.abs().max()):.4e}, "
        f"against the plain versions on the card (step and backward "
        f"{plain_s:.2f}s) {gap_plain:.3e} of max|g| (bar "
        f"{DIFF_PLAIN_BARS[ph]:.0e})")
    for k in case["forms"]:
        kernels[k]["diff_launches_per_env_step"] = {"forward": fwd[k],
                                                    "backward": bwd[k]}
    return dict(env=env, fwd_ms=fwd_ms, bwd_ms=bwd_ms, peak_gb=peak_gb,
                fwd=fwd, bwd=bwd, gap_plain=gap_plain, plain_s=plain_s)


def _diff_remat_phase(kernels, piso, env) -> None:
    """Phase 52's remat check: ``piso_fixed_steps`` over 2 substeps from the
    cylinder's state after phase 52's step, d(sum u^2)/d(state) through
    ``diff_tools.state_vjp`` with and without ``use_remat``: bit-equal, the
    remat run launching every forward solve once more in the backward."""
    import torch

    from fluidgym_tpu_torch.envs.util import diff_tools
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    env.detach()
    grads, launches, ms = {}, {}, {}
    for remat in (False, True):
        def step(s, remat=remat):
            s = piso.piso_fixed_steps(s, env._geoms, env._topo, env._cfg,
                                      env.dt, 2, env._hooks, use_remat=remat)
            return tuple(torch.sum(b.velocity ** 2) for b in s.blocks)

        k3.launches = k2.merged_launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, grads[remat] = diff_tools.state_vjp(step, env._state)
        torch.cuda.synchronize()
        ms[remat] = 1e3 * (time.perf_counter() - t)
        launches[remat] = {"K3": k3.launches, "K2-mb": k2.merged_launches}
    same = all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))
    check(same, "phase 52: the gradient with remat differs from the one without")
    check(all(bool(torch.isfinite(gg).all()) for gg in grads[True]),
          "phase 52: the remat gradient is not finite")
    check(launches[False] == {"K3": 8, "K2-mb": 4}
          and launches[True] == {"K3": 12, "K2-mb": 6},
          f"phase 52: remat launches {launches} (expected K3 8 / 12, K2-mb "
          "4 / 6: forward + backward, and with remat the forward again)")
    log(f"phase 52 piso_fixed_steps(use_remat=True) over 2 substeps: gradient "
        f"bit-equal to the one without remat; launches {launches}; forward + "
        f"backward {ms[False]:.1f} / {ms[True]:.1f} ms without / with remat")
    kernels["K3"]["diff_remat"] = dict(launches=launches, ms=ms)


def _diff_card_vs_host(dev, cg_cuda, cg_cuda_mb, fault=None) -> dict:
    """Phase 53: phase 51's gradient d(reward)/d(action) at a small RBC2D
    config (16 x 10 cells, one step of 2 sim steps after one step with a
    fixed action), three ways: the card in float32 through the kernels,
    the card in float32 through the plain versions (the wrappers' device
    test answering "cpu"), the host in float64.  Returns the gaps of the
    first from the other two over their max|g| (the caller holds them to
    ``DIFF_PLAIN_BARS[53]`` and ``DIFF_HOST_BAR``).  ``fault``: as in
    ``_diff_main_path``, around the kernels' run alone."""
    import contextlib

    import numpy as np
    import torch

    import fluidgym_tpu_torch

    small = dict(n_heaters=4, resolution=4, load_initial_domain=False,
                 load_domain_statistics=False, randomize_initial_state=False,
                 episode_length=5, step_length=0.1, dt=0.05, local_obs_window=3,
                 differentiable=True)

    def grad(where, dtype, ctx=contextlib.nullcontext):
        with ctx():
            e = fluidgym_tpu_torch.make("RBC2D-easy-v0", device=where,
                                        dtype=dtype, **small)
            e.reset(seed=1)
            e.step(np.full(e.action_space.shape, 0.4, np.float32))
            e.detach()
            a = torch.tensor(np.linspace(-0.5, 0.5, 4).reshape(
                e.action_space.shape), dtype=dtype, device=where,
                requires_grad=True)
            _, r, *_ = e.step(a)
            r.sum().backward()
            return a.grad.double().cpu()

    t = time.perf_counter()
    launches0 = cg_cuda.fused_cg.launches
    g_card = grad(dev, torch.float32, fault or contextlib.nullcontext)
    check(cg_cuda.fused_cg.launches > launches0,
          "phase 53: the card's run launched no K1")
    launches1 = cg_cuda.fused_cg.launches
    plain_calls = cg_cuda.fused_cg_plain.calls
    g_plain = grad(dev, torch.float32,
                   lambda: _plain_on_card(cg_cuda, cg_cuda_mb))
    check(cg_cuda.fused_cg.launches == launches1
          and cg_cuda.fused_cg_plain.calls > plain_calls,
          "phase 53: the plain run launched a kernel")
    g_host = grad(torch.device("cpu"), torch.float64)
    gap_plain = float((g_card - g_plain).abs().max() / g_plain.abs().max())
    gap_host = float((g_card - g_host).abs().max() / g_host.abs().max())
    log(f"phase 53 RBC2D-easy-v0 small (10, 16) d(reward)/d(action), card "
        f"float32 (kernels) {g_card.flatten().tolist()}: against the plain "
        f"versions on the card {gap_plain:.3e} of max|g| (bar "
        f"{DIFF_PLAIN_BARS[53]:.0e}), against the host in float64 "
        f"{gap_host:.3e} (bar {DIFF_HOST_BAR:.0e}), in "
        f"{time.perf_counter() - t:.2f}s")
    return dict(gap_plain=gap_plain, gap_host=gap_host)


def _diff_phases(dev, kernels, piso, linsolve) -> None:
    """Phases 51-53: the differentiable path on the card."""
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t = time.perf_counter()
    out = {}
    for case in DIFF_CASES:
        out[case["env_id"]] = r = _diff_main_path(dev, kernels, piso, linsolve,
                                                  case)
        ph = case["ph"]
        check(r["gap_plain"] <= DIFF_PLAIN_BARS[ph],
              f"phase {ph}: the gradient through the kernels is "
              f"{r['gap_plain']:.3e} of max|g| from the plain versions' "
              f"(bar {DIFF_PLAIN_BARS[ph]:.0e})")
        for k in case["forms"]:
            kernels[k]["diff_ms_per_env_step"] = {"forward": r["fwd_ms"],
                                                  "backward": r["bwd_ms"]}
            kernels[k]["diff_gap_plain"] = r["gap_plain"]
    _diff_remat_phase(kernels, piso, out["CylinderJet2D-easy-v0"]["env"])
    gaps = _diff_card_vs_host(dev, cg_cuda, cg_cuda_mb)
    check(gaps["gap_plain"] <= DIFF_PLAIN_BARS[53],
          f"phase 53: card kernels vs plain {gaps['gap_plain']}")
    check(gaps["gap_host"] <= DIFF_HOST_BAR,
          f"phase 53: card vs host float64 {gaps['gap_host']}")
    for k in ("K1", "K2"):
        kernels[k]["diff_card_vs"] = gaps
    log(f"phases 51-53 the differentiable path ok in "
        f"{time.perf_counter() - t:.1f}s")


#: phase 54's episode: ``episode_length`` + 1 steps cross one auto-reset
RL_EPISODE = 2
#: phase 55's noise: (sigma, seed) of the sensor and the action noise
RL_SENSOR_NOISE, RL_ACTION_NOISE = (0.01, 5), (0.1, 6)
#: phase 56's bar: render fields on the card against the host, relative to
#: each field's max
RENDER_BAR = 1e-5


def _rl_counts(piso, linsolve, forms):
    """``(zero, read, restore)`` over the launch counters of ``forms``
    (name -> (wrapper, attribute)), every plain version and ``linsolve``'s
    loops; ``restore`` unwraps the counted ``linsolve`` functions."""
    launches, plains = _counters()
    calls, restore = count_calls(piso, linsolve)
    extra = [c for c in forms.values() if c not in launches]

    def zero():
        for w, a in launches + plains + extra:
            setattr(w, a, 0)
        calls.update({k: 0 for k in calls})

    def read():
        out = {k: getattr(w, a) for k, (w, a) in forms.items()}
        out["all"] = sum(getattr(w, a) for w, a in launches)
        out["plain"] = sum(getattr(w, a) for w, a in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        return out

    return zero, read, restore


def _in_turns(torch, arms, i, zero, read):
    """Run ``arms`` (name -> call) once each, the order alternating with
    ``i``; each run's host ms (ending in a synchronise), its counts and
    what it returned."""
    out = {}
    names = list(arms) if i % 2 == 0 else list(arms)[::-1]
    for name in names:
        zero()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = arms[name]()
        torch.cuda.synchronize()
        out[name] = dict(ms=1e3 * (time.perf_counter() - t), counts=read(),
                         result=res)
    return out


class _ReplayEnv:
    """Hands back one recorded step's outputs (tensors on the card) at no
    cost, so that a wrapper stack over it times only its own layers."""

    def __init__(self, env, out):
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.use_marl, self.n_agents = env.use_marl, env.n_agents
        self.device, self._dtype = env.device, env._dtype
        self._out = out

    def step(self, action):
        obs, reward, _, _, info = self._out
        return dict(obs), reward, False, False, dict(info)

    def reset(self, seed=None, randomize=None):
        return dict(self._out[0]), {}


#: calls per stack in the layer timings of phases 54-55
LAYER_REPS = 200


def layer_ms(torch, stacks, action) -> dict:
    """Host ms per ``step`` of each wrapper stack over a ``_ReplayEnv`` (name
    -> stack, the bare replay first), ``LAYER_REPS`` calls each ending in a
    synchronise, every stack twice in turns (forward, then backward)."""
    out = {k: 0.0 for k in stacks}
    for names in (list(stacks), list(stacks)[::-1]):
        for k in names:
            stacks[k].step(action)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(LAYER_REPS):
                stacks[k].step(action)
            torch.cuda.synchronize()
            out[k] += 1e3 * (time.perf_counter() - t) / LAYER_REPS / 2
    return out


def _vec_env_phase(dev, kernels, piso, linsolve) -> dict:
    """Phase 54: the SB3 recipe of ``examples/interfaces/sb3_vec_env.py``,
    ``VecFluidEnv(FlattenObservation(make("RBC2D-easy-v0", use_marl=True,
    load_initial_domain=False, load_domain_statistics=False)))`` at (61,
    96), ``episode_length`` = ``RL_EPISODE``, for ``RL_EPISODE`` + 1 steps
    (one auto-reset, randomized as registered), and the bare env on the
    same actions beside it, the two in turns: obs and rewards bit for bit,
    ``terminated_observation`` the bare env's last obs, K1 / K2 launches per
    env step equal and all on the resident arm, no plain version and no
    ``linsolve`` loop."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.integration.sb3 import VecFluidEnv
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.wrappers import FlattenObservation

    k1, k2 = cg_cuda.fused_cg, cg_cuda_mb.fused_bicgstab_mb
    forms = {"K1": (k1, "launches"), "K2": (k2, "launches"),
             "K1 resident": (k1, "resident_launches"),
             "K2 resident": (k2, "resident_launches")}
    zero, read, restore = _rl_counts(piso, linsolve, forms)
    kw = dict(use_marl=True, load_initial_domain=False,
              load_domain_statistics=False, episode_length=RL_EPISODE)
    t0 = time.perf_counter()
    venv = VecFluidEnv(FlattenObservation(fluidgym_tpu_torch.make("RBC2D-easy-v0", **kw)))
    bare = fluidgym_tpu_torch.make("RBC2D-easy-v0", **kw)
    keys = ("temperature", "velocity")

    def flat(o):
        return torch.cat([o[k].reshape(bare.n_agents, -1) for k in keys],
                         dim=1).cpu().numpy()

    try:
        o = venv.reset(seed=0)
        ob, _ = bare.reset(seed=0)
        check(bare._topo.blocks[0].shape == (61, 96),
              f"phase 54: block {bare._topo.blocks[0].shape}")
        check(np.array_equal(o, flat(ob)), "phase 54: reset obs differ")
        rng = np.random.default_rng(54)
        rows, resets = [], []
        for i in range(RL_EPISODE + 1):
            a = rng.uniform(-1, 1, (venv.num_envs, 1)).astype(np.float32)

            def bare_step(a=a):
                r = bare.step(a)
                done = bool(r[2] or r[3])
                return r, (bare.reset() if done else None)

            turn = _in_turns(torch, {"wrapped": lambda a=a: venv.step(a),
                                     "bare": bare_step}, i, zero, read)
            (o, r, dones, infos) = turn["wrapped"]["result"]
            (ob, rb, te, tr, _), reset = turn["bare"]["result"]
            check(isinstance(o, np.ndarray) and isinstance(r, np.ndarray),
                  "phase 54: the adapter did not return numpy")
            check(np.array_equal(r, rb.cpu().numpy()),
                  f"phase 54 step {i}: rewards differ")
            check(dones.tolist() == [bool(te or tr)] * bare.n_agents,
                  f"phase 54 step {i}: dones {dones.tolist()}")
            if reset is not None:
                resets.append(i)
                check(np.array_equal(np.stack([f["terminated_observation"]
                                               for f in infos]), flat(ob)),
                      "phase 54: terminated_observation differs")
                ob = reset[0]
            check(np.array_equal(o, flat(ob)), f"phase 54 step {i}: obs differ")
            cw, cb = turn["wrapped"]["counts"], turn["bare"]["counts"]
            for c in (cw, cb):
                check(c["K1"] > 0 and c["K2"] > 0
                      and c["K1 resident"] == c["K1"]
                      and c["K2 resident"] == c["K2"],
                      f"phase 54 step {i}: K1 / K2 not all on the resident "
                      f"arm: {c}")
                check(c["plain"] == 0 and c["linsolve"] == 0,
                      f"phase 54 step {i}: plain versions or linsolve ran: {c}")
            check(cw == cb, f"phase 54 step {i}: launches wrapped {cw} != "
                  f"bare {cb}")
            rows.append(dict(step=i, auto_reset=reset is not None,
                             ms=turn["wrapped"]["ms"], bare_ms=turn["bare"]["ms"],
                             K1=cw["K1"], K2=cw["K2"]))
        check(resets == [RL_EPISODE - 1], f"phase 54: auto-resets at {resets}")
    finally:
        restore()
    replay = _ReplayEnv(bare, turn["bare"]["result"][0])
    flat_replay = FlattenObservation(replay)
    layers = layer_ms(torch, {"replay": replay, "FlattenObservation": flat_replay,
                              "VecFluidEnv(FlattenObservation)":
                              VecFluidEnv(flat_replay)}, a)
    steps = [r for r in rows if not r["auto_reset"]]
    out = dict(per_step=rows, layers_ms=layers, launches_per_env_step={
        "K1": steps[0]["K1"], "K2": steps[0]["K2"]},
        ms=[r["ms"] for r in steps], bare_ms=[r["bare_ms"] for r in steps])
    for k in ("K1", "K2"):
        kernels[k]["wrapped_launches_per_env_step"] = {
            "VecFluidEnv(FlattenObservation(RBC2D-easy MARL))":
            [r[k] for r in steps]}
    log(f"phase 54 VecFluidEnv(FlattenObservation(RBC2D-easy-v0 MARL)) ok: "
        f"{RL_EPISODE + 1} steps in turns with the bare env, obs / rewards "
        f"bit-equal, auto-reset at step {resets[0]}; ms per env step wrapped "
        f"{[round(r['ms'], 1) for r in rows]} vs bare "
        f"{[round(r['bare_ms'], 1) for r in rows]} (the auto-reset's step "
        f"includes the reset); K1 / K2 launches per step "
        f"{[(r['K1'], r['K2']) for r in rows]}, equal and all resident, no "
        f"plain version or linsolve loop; each stack's own host ms per step "
        f"over a replay of the last step (card tensors, {LAYER_REPS} calls x "
        f"2 in turns) {json.dumps({k: round(v, 4) for k, v in layers.items()})}; "
        f"{time.perf_counter() - t0:.1f}s")
    out["env"] = bare
    return out


def _gym_noise_phase(dev, kernels, piso, linsolve) -> dict:
    """Phase 55: ``GymFluidEnv(ActionNoise(SensorNoise(ObsExtraction(
    make("CylinderJet2D-easy-v0", randomize_initial_state=False),
    ["pressure"]))))`` (the adapter on its ``object`` base where gymnasium
    is absent, as on the card), reset and 2 steps, in turns with a bare env
    into which the same noise draws (generators on the card, seeded as the
    wrappers') are replayed: obs and reward bit for bit; every layer below
    the adapter hands back tensors on the card, the adapter numpy; K3 /
    K2-mb launches per env step equal and all on the cluster arm."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.integration.gymnasium import GymFluidEnv
    from fluidgym_tpu_torch.ops import cg_cuda_mb
    from fluidgym_tpu_torch.wrappers import ActionNoise, ObsExtraction, SensorNoise

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    forms = {"K3": (k3, "launches"), "K2-mb": (k2, "merged_launches"),
             "K3 cluster": (k3, "cluster_launches"),
             "K2-mb cluster": (k2, "cluster_launches")}
    zero, read, restore = _rl_counts(piso, linsolve, forms)
    kw = dict(randomize_initial_state=False)
    (ss, seed_s), (sa, seed_a) = RL_SENSOR_NOISE, RL_ACTION_NOISE
    t0 = time.perf_counter()
    inner = ActionNoise(SensorNoise(ObsExtraction(
        fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", **kw), ["pressure"]),
        ss, seed_s), sa, seed_a)
    g = GymFluidEnv(inner)
    bare = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", **kw)
    gs = torch.Generator(device=dev).manual_seed(seed_s)
    ga = torch.Generator(device=dev).manual_seed(seed_a)
    below = []
    step_inner = inner.step

    def spy(action):
        res = step_inner(action)
        below.append((res[0]["pressure"], res[1]))
        return res

    inner.step = spy

    def sensed(o):
        p = o["pressure"]
        return (p + torch.randn(p.shape, generator=gs, device=p.device,
                                dtype=p.dtype) * ss).cpu().numpy()

    try:
        o, _ = g.reset(seed=0)
        ob, _ = bare.reset(seed=0)
        check(np.array_equal(o["pressure"], sensed(ob)),
              "phase 55: reset obs differ")
        rows = []
        for i, a in enumerate((np.array([0.5], np.float32),
                               np.array([-0.3], np.float32))):
            def bare_step(a=a):
                at = torch.as_tensor(a, device=dev)
                return bare.step(at + torch.randn(at.shape, generator=ga,
                                                  device=dev, dtype=at.dtype) * sa)

            turn = _in_turns(torch, {"wrapped": lambda a=a: g.step(a),
                                     "bare": bare_step}, i, zero, read)
            o, r, te, tr, info = turn["wrapped"]["result"]
            ob, rb, *_ = turn["bare"]["result"]
            check(isinstance(o["pressure"], np.ndarray) and isinstance(r, float)
                  and all(isinstance(v, np.ndarray) for v in info.values()),
                  "phase 55: the adapter did not return numpy")
            p_below, r_below = below[-1]
            check(torch.is_tensor(p_below) and p_below.device.type == dev.type
                  and torch.is_tensor(r_below) and r_below.device.type == dev.type,
                  "phase 55: a layer below the adapter left the card")
            check(np.array_equal(o["pressure"], sensed(ob)),
                  f"phase 55 step {i}: obs differ")
            check(r == float(rb.reshape(-1)[0]), f"phase 55 step {i}: reward differs")
            cw, cb = turn["wrapped"]["counts"], turn["bare"]["counts"]
            for c in (cw, cb):
                check(c["K3"] > 0 and c["K2-mb"] > 0
                      and c["K3 cluster"] == c["K3"]
                      and c["K2-mb cluster"] == c["K2-mb"],
                      f"phase 55 step {i}: K3 / K2-mb not all on the cluster "
                      f"arm: {c}")
                check(c["plain"] == 0 and c["linsolve"] == 0,
                      f"phase 55 step {i}: plain versions or linsolve ran: {c}")
            check(cw == cb, f"phase 55 step {i}: launches wrapped {cw} != bare {cb}")
            rows.append(dict(step=i, ms=turn["wrapped"]["ms"],
                             bare_ms=turn["bare"]["ms"], K3=cw["K3"],
                             K2_mb=cw["K2-mb"]))
    finally:
        inner.step = step_inner
        restore()
    replay = _ReplayEnv(bare, turn["bare"]["result"])
    ext = ObsExtraction(replay, ["pressure"])
    sensor = SensorNoise(ext, ss, seed_s)
    action = ActionNoise(sensor, sa, seed_a)
    layers = layer_ms(torch, {"replay": replay, "ObsExtraction": ext,
                              "SensorNoise(ObsExtraction)": sensor,
                              "ActionNoise(SensorNoise(ObsExtraction))": action,
                              "GymFluidEnv(ActionNoise(SensorNoise(ObsExtraction)))":
                              GymFluidEnv(action)}, a)
    for k, c in (("K3", "K3"), ("K2-mb", "K2_mb")):
        kernels[k]["wrapped_launches_per_env_step"] = {
            "GymFluidEnv(ActionNoise(SensorNoise(ObsExtraction("
            "CylinderJet2D-easy))))": [r[c] for r in rows]}
    log(f"phase 55 GymFluidEnv (base {type(g).__mro__[1].__name__}) over "
        f"ActionNoise(SensorNoise(ObsExtraction(CylinderJet2D-easy-v0))) ok: "
        f"obs / reward bit-equal to the bare env on the replayed draws, "
        f"numpy only at the adapter; ms per env step wrapped "
        f"{[round(r['ms'], 1) for r in rows]} vs bare "
        f"{[round(r['bare_ms'], 1) for r in rows]} in turns; K3 / K2-mb "
        f"launches per step {[(r['K3'], r['K2_mb']) for r in rows]}, equal "
        f"and all on the cluster arm, no plain version or linsolve loop; "
        f"each stack's own host ms per step over a replay of the last step "
        f"(card tensors, {LAYER_REPS} calls x 2 in turns) "
        f"{json.dumps({k: round(v, 4) for k, v in layers.items()})}; "
        f"{time.perf_counter() - t0:.1f}s")
    return dict(per_step=rows, layers_ms=layers, env=bare)


def _render_card_vs_host(dev, envs) -> dict:
    """Phase 56: the render fields (``render_fields``: RBC2D-easy's scaled
    temperature and CylinderJet2D-easy's vorticity on their render grids)
    of phases 54 and 55's bare envs on the card against a CPU env on the
    same state (``get_state`` -> ``env_state_to_numpy`` ->
    ``env_state_from_numpy``), within ``RENDER_BAR`` of each field's max.
    The colormap step (matplotlib) is not run."""
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.envs.fluid_env import (env_state_from_numpy,
                                                   env_state_to_numpy)

    out = {}
    for env_id, env, kw in envs:
        t = time.perf_counter()
        host = fluidgym_tpu_torch.make(env_id, device="cpu", **kw)
        host.set_state(env_state_from_numpy(env_state_to_numpy(env.get_state())))
        ms = []
        for where in (env, env, host, host):  # the first call builds the plan
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fields = where.render_fields()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
            card, ref = (fields, None) if where is env else (card, fields)
        card_ms, host_ms = ms[1], ms[3]
        for k, v in card.items():
            check(v.device.type == dev.type, f"phase 56: {k} is not on the card")
            err = float((v.cpu() - ref[k]).abs().max()
                        / ref[k].abs().max().clamp(min=1e-30))
            check(tuple(v.shape) == tuple(ref[k].shape) and err <= RENDER_BAR,
                  f"phase 56 {env_id} {k}: card vs host {err:.3e} "
                  f"(bar {RENDER_BAR:g})")
            out[f"{env_id} {k}"] = dict(shape=tuple(v.shape), rel_err=err,
                                        card_ms=card_ms, host_ms=host_ms)
            log(f"phase 56 {env_id} {k} {tuple(v.shape)} on the render grid: "
                f"card vs host {err:.3e} of max (bar {RENDER_BAR:g}); "
                f"render_fields {card_ms:.2f} ms on the card, {host_ms:.2f} ms "
                f"on the host (first calls, building the plan: {ms[0]:.1f} / "
                f"{ms[2]:.1f} ms); "
                f"{time.perf_counter() - t:.1f}s")
    return out


def _rl_surface_phases(dev, kernels, piso, linsolve) -> None:
    """Phases 54-56: the RL-framework surface on the card."""
    t = time.perf_counter()
    vec = _vec_env_phase(dev, kernels, piso, linsolve)
    gym = _gym_noise_phase(dev, kernels, piso, linsolve)
    _render_card_vs_host(dev, [
        ("RBC2D-easy-v0", vec["env"],
         dict(use_marl=True, load_initial_domain=False,
              load_domain_statistics=False, episode_length=RL_EPISODE)),
        ("CylinderJet2D-easy-v0", gym["env"],
         dict(randomize_initial_state=False))])
    log(f"phases 54-56 the RL-framework surface ok in "
        f"{time.perf_counter() - t:.1f}s")

if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
