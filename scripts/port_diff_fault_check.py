#!/usr/bin/env python3
"""The gradient bars of ``chip_smoke.py``'s phases 51-53 against planted
faults, on one CUDA card.

    python3 scripts/port_diff_fault_check.py [--out FILE]

Phases 51-53 hold d(reward)/d(action) through the kernels to the same
gradient through their plain versions on the card (phase 51 RBC2D-easy and
phase 52 CylinderJet2D-easy at their registered defaults, phase 53 a
16 x 10 RBC2D), each within ``chip_smoke.DIFF_PLAIN_BARS`` of the plain
one's max|g|.  This script runs the three comparisons sound, then with each
fault below planted in the kernels' run alone (the plain run stays sound),
and reports every gap, so that a bar can be set between the sound gap and
the faults':

* ``transpose``: the transposed advection solve (K2 / K2-mb) runs on A in
  place of ``A^T`` (``stencil.transpose_ops`` returning its input);
* ``pressure_adjoint``: the transposed pressure solve's solution (K1 / K3)
  scaled by 0.99, a 1% error in the adjoint.

Both keep every launch of the sound run, so the phases' other checks hold.
Prints the card's name and power limit and one JSON object (also to
``--out``).  Needs a card; imports nothing of JAX or of the JAX package.
"""

import argparse
import collections
import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def faults(piso, st):
    """The planted faults by name: context managers that patch the solver
    while they are entered."""

    @contextlib.contextmanager
    def transpose():
        orig = st.transpose_ops
        st.transpose_ops = lambda ops, topo: ops
        try:
            yield
        finally:
            st.transpose_ops = orig

    @contextlib.contextmanager
    def pressure_adjoint():
        orig = piso._Adjoint

        def adjoint(solve, solve_t, topo, nblocks):
            # _solve's solve_t closes over its system's `symmetric`
            free = dict(zip(solve_t.__code__.co_freevars,
                            (c.cell_contents for c in solve_t.__closure__)))
            if free["symmetric"]:
                sound = solve_t

                def solve_t(ops, ct):
                    return tuple(0.99 * lam for lam in sound(ops, ct))
            return orig(solve, solve_t, topo, nblocks)

        piso._Adjoint = adjoint
        try:
            yield
        finally:
            piso._Adjoint = orig

    return {"transpose": transpose, "pressure_adjoint": pressure_adjoint}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_diff_fault_check: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import chip_smoke as cs
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import linsolve, piso
    from fluidgym_tpu_torch.solver import stencil as st

    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    out = {"card": smi, "bars": {str(k): v
                                 for k, v in cs.DIFF_PLAIN_BARS.items()}}
    for name, fault in [("sound", None)] + list(faults(piso, st).items()):
        row = {}
        for case in cs.DIFF_CASES:
            r = cs._diff_main_path(dev, collections.defaultdict(dict), piso,
                                   linsolve, case, fault=fault)
            row[str(case["ph"])] = r["gap_plain"]
        row["53"] = cs._diff_card_vs_host(dev, cg_cuda, cg_cuda_mb,
                                          fault=fault)["gap_plain"]
        out[name] = row
        print(f"{name}: gap over max|g| by phase {row}", flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
