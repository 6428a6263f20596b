#!/usr/bin/env python3
"""A quick card check of K3-agg / K3-agg-flip (the aggregation coarse space
inside K3), for a first run of changed kernel code.

    python3 scripts/port_agg_probe.py

Builds the kernels (``ops/_build.py``), prints the ``ptxas`` lines of the
K3-agg instances (registers, spills, static shared memory), then, for the
airfoil (K3-agg-flip, Airfoil2D-medium's ``train_00``, k = 1,194 tiles)
and the cylinder (K3-agg, identity seams), the pressure system cold and
warm from the deflated guess (``tests/test_torch_kernels_cuda.py``
``_agg_system``): one raw launch at C = 1 and at every cluster size whose
rows and tiles fit, each bit for bit against C = 1, the mean ms per raw
launch over 5 launches (CUDA events) with us per iteration, and the plain
version's iterations and max|dx|.  Prints the card's name and power limit.
Needs a card; imports nothing of JAX or of the JAX package.
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
        print("port_agg_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from fluidgym_tpu_torch.ops import _build, cg_cuda, cg_cuda_mb
    from test_torch_kernels_cuda import _agg_system

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    log = _build.build_info()["log"].splitlines()
    for i, ln in enumerate(log):
        # fg_cg_kernel<2, true, true, C, false, 0, true>: the AGG instances
        if "Compiling entry" in ln and "fg_cg_kernelILi2ELb1ELb1E" in ln:
            print("\n".join(log[i:i + 4]), flush=True)
    dev = torch.device("cuda")
    for system in ("airfoil", "cylinder"):
        t = time.perf_counter()
        plan, diags, offs, b, guess, space = _agg_system(system, dev)
        n = b.shape[1]
        print(f"{system}: system and space built in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
        tol = 1e-7 if system == "airfoil" else 1e-6
        einv = space.einv[None]
        kw = dict(tol2_sum=cg_cuda.tol2_sum_f32(tol, n), maxiter=5000,
                  stall_iters=250, precondition=True, return_best=True,
                  coarse=(space, einv), chunk=1)
        sizes = [C for C in cg_cuda_mb.CLUSTER_SIZES
                 if cg_cuda_mb.rows_fit(n, C, 2, space.K)]
        occ = {C: cg_cuda_mb.max_active_clusters("cg_coarse", 2, C, n, dev,
                                                  space.K)
               for C in sizes}
        rule = cg_cuda_mb.merged_arm(1, n, 2, 1, dev, "cg_coarse",
                                      space.K)[0]
        print(f"{system}: n = {n}, K = {space.K}, occupancy {occ}, rule "
              f"C = {rule}", flush=True)
        for start, x0 in (("cold", None), ("warm", guess)):
            ref = None
            for C in [1] + sorted(C for C in sizes if occ[C] >= 1):
                launch = cg_cuda_mb.merged_launcher("cg", plan, diag, off, b,
                                                    x0, cluster=C, **kw)
                out = tuple(v.clone() for v in launch())
                torch.cuda.synchronize()
                ref = out if ref is None else ref
                same = all(torch.equal(u, v) for u, v in zip(out, ref))
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(5):
                    launch()
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1) / 5
                its = int(out[1].max())
                print(f"{system} {start} C={C}: {its} iterations, residual "
                      f"{out[2].tolist()}, {ms:.3f} ms = "
                      f"{ms * 1e3 / max(its, 1):.1f} us/iteration, bit-equal "
                      f"to C=1: {same}", flush=True)
                if not same:
                    return 1
            xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(
                plan, diag, off, b, x0, **kw)
            torch.cuda.synchronize()
            err = float((xp - ref[0]).abs().max() / xp.abs().max())
            print(f"{system} {start} plain: {ip.tolist()} iterations, residual "
                  f"{rp.tolist()}, max|dx| / max|x| {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
