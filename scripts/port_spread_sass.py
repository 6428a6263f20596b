#!/usr/bin/env python3
"""What the compiler made of the Krylov kernels' arms: loads by kind.

    python3 scripts/port_spread_sass.py [--out FILE]

Builds the kernel library (``fluidgym_tpu_torch/ops/_build.py``), compiles
each source once more with the library's flags for ``ptxas -v``'s
registers and spills per kernel instance (a cached library has no build
log), and walks ``cuobjdump -sass`` of the library: for every instance of
``fg_cg_kernel`` / ``fg_bicg_kernel`` it counts the global loads by
opcode (``LDG.E``, ``LDG.E.CONSTANT`` = the read-only path,
``LDG.E.STRONG.GPU`` / ``.EF`` / ... = ``__ldcg`` and its kin), and names
the instance's form and arm from its template arguments (K1 / K3 /
K3-coarse, K2 / K2-mb; chunk grid, cluster, resident, spread range or
chains).  The spread arm (K1-3D, K2-3D, and K3-3D, K2-mb-3D over a 3D
merged plan) reads what other blocks wrote during the launch (the gathered
vector of a matvec, the chain terms, the chains): a read-only load of
those could return a stale value, so its instances should hold constant
loads only of the operator rows (and the merged forms' neighbour table).
Prints one JSON object (also to ``--out``).  Needs the CUDA toolkit
(``nvcc``, ``cuobjdump``); no card.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cuobjdump() -> str:
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def ptxas_log() -> str:
    """``ptxas -v`` of every kernel source, compiled with the library's
    flags into a scratch directory (all at once)."""
    import tempfile

    from fluidgym_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
             os.path.join(tmp, f"{src}.o"), str(_build.CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in _build.SOURCES]
        return "".join(proc.communicate()[0] for proc in procs)


#: the spread arm's layouts by template value (FG_ARM_* in csrc/krylov.cuh)
_SPREAD = {"0": None, "2": "spread range", "3": "spread chains",
           "4": "spread ring"}


def form_and_arm(pretty: str) -> str:
    """"K3 spread chains", "K2 resident", ... for a demangled instance
    ``fg_cg_kernel<ND, TABLE, COARSE, CLUSTER, RESIDENT, SPREAD>`` or
    ``fg_bicg_kernel<ND, TABLE, CLUSTER, RESIDENT, SPREAD>``."""
    head = pretty.split("(")[0]
    args = head[head.find("<") + 1:head.rfind(">")].replace(" ", "").split(",")
    if len(args) < 5:
        return "?"
    cg = "fg_cg_kernel" in head
    nd, table = args[0], args[1] == "true"
    if cg:
        coarse, cluster, resident, spread = (args[2] == "true",
                                             args[3] == "true",
                                             args[4] == "true", args[5])
        form = "K3-coarse" if coarse else "K3" if table else "K1"
    else:
        cluster, resident, spread = (args[2] == "true", args[3] == "true",
                                     args[4])
        form = "K2-mb" if table else "K2"
    arm = (_SPREAD.get(spread) or ("cluster" if cluster else "resident"
                                   if resident else "chunk grid"))
    return f"{form} {nd}D {arm}"


def _demangle(names):
    out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from fluidgym_tpu_torch.ops import _build

    _build.library()
    info = _build.build_info()
    log = ptxas_log()
    sass = subprocess.run([_cuobjdump(), "-sass", info["path"]], text=True,
                          capture_output=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = collections.Counter()
            continue
        m = re.search(r"\b(LDG\.[A-Z0-9.]+|LDG)\b", line)
        if cur and m:
            funcs[cur][m.group(1)] += 1
    names = list(funcs)
    pretty = dict(zip(names, _demangle(names)))
    regs = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                         r"registers", log, re.S):
        regs[m.group(1)] = int(m.group(2))
    spills = {m.group(1): m.group(2) for m in re.finditer(
        r"Function properties for (\S+)\s*\n\s*(\d+ bytes stack frame, \d+ "
        r"bytes spill stores, \d+ bytes spill loads)", log)}
    rows = []
    for name, loads in funcs.items():
        if "fg_cg_kernel" not in name and "fg_bicg_kernel" not in name:
            continue
        rows.append(dict(kernel=pretty[name], form=form_and_arm(pretty[name]),
                         registers=regs.get(name), spills=spills.get(name),
                         loads=dict(loads)))
    for r in rows:
        print(f"{r['form']}: {r['kernel'][:90]}: registers {r['registers']} "
              f"({r['spills']}), loads "
              f"{r['loads']}", flush=True)
    text = json.dumps(dict(library=info["path"], kernels=rows))
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
