#!/usr/bin/env python3
"""A quick card check of K3-coarse's cluster arm, for a first run of changed
kernel code.

    python3 scripts/port_coarse_cluster_probe.py

Builds the kernels (``ops/_build.py``), prints the ``ptxas`` lines of the
coarse instances (registers, spills, static shared memory), then, for the
cylinder (K3-coarse, K = 34) and the airfoil (K3-coarse-flip, K = 59), the
pressure system of one substep of the bundled snapshot warm from the
deflated guess (``tests/test_torch_kernels_cuda.py`` ``_strips_system``):
one raw launch at C = 1 and at every cluster size whose rows fit,
each bit for bit against C = 1, and the mean ms per raw launch over 10
launches (CUDA events) with us per iteration.  Prints the card's name and
power limit.  Needs a card; imports nothing of JAX or of the JAX package.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_coarse_cluster_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from fluidgym_tpu_torch.ops import _build, cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import coarse_strips
    from test_torch_kernels_cuda import _strips_system

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    log = _build.build_info()["log"].splitlines()
    for i, ln in enumerate(log):
        # fg_cg_kernel<2, true, true, ...>: the COARSE instances
        if "Compiling entry" in ln and "fg_cg_kernelILi2ELb1ELb1E" in ln:
            print("\n".join(log[i:i + 4]), flush=True)
    dev = torch.device("cuda")
    for system in ("cylinder", "airfoil"):
        plan, diags, offs, b, guess = _strips_system(system, dev)
        n = b.shape[1]
        diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
        sp = coarse_strips.strip_plan(plan)
        einv = coarse_strips.coarse_inverse(plan, sp, tuple(zip(diags, offs)))[None]
        tol = 1e-7 if system == "airfoil" else 1e-6
        kw = dict(tol2_sum=cg_cuda.tol2_sum_f32(tol, n), maxiter=5000,
                  stall_iters=250, precondition=True, return_best=True,
                  coarse=(sp, einv), chunk=1)
        sizes = [C for C in cg_cuda_mb.CLUSTER_SIZES
                 if cg_cuda_mb.rows_fit(n, C, 2)]
        occ = {C: cg_cuda_mb.max_active_clusters("cg_coarse", 2, C, n, dev)
               for C in sizes}
        rule = cg_cuda_mb.merged_arm(1, n, 2, 1, dev, coarse=True)[0]
        print(f"{system}: K = {sp.K}, occupancy {occ}, rule C = {rule}",
              flush=True)
        ref = None
        for C in [1] + sorted(sizes):
            launch = cg_cuda_mb.merged_launcher("cg", plan, diag, off, b, guess,
                                                cluster=C, **kw)
            out = tuple(v.clone() for v in launch())
            torch.cuda.synchronize()
            ref = out if ref is None else ref
            same = all(torch.equal(u, v) for u, v in zip(out, ref))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(10):
                launch()
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / 10
            its = int(out[1].max())
            print(f"{system} C={C}: {its} iterations, residual "
                  f"{out[2].tolist()}, {ms:.3f} ms = {ms * 1e3 / max(its, 1):.1f}"
                  f" us/iteration, bit-equal to C=1: {same}", flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
