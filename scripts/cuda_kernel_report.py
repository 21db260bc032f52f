"""What the compiler made of the port's kernels: registers, spills and shared
memory from ``ptxas -v``, and the loops of each kernel's SASS.

    python scripts/cuda_kernel_report.py [OUT_DIR]

Compiles every source in ``ops/_build.SOURCES`` with the library's own flags
to a cubin under OUT_DIR (default: a temporary directory), then prints one
JSON line per kernel instance: ``ptxas`` (its resource line), and ``loops``,
each backward branch of the SASS with the instructions between its target and
itself, the longest run of them with no branch or barrier (``straight``: a
straight-line path such as an unrolled group of steps), and the float
arithmetic among them (FFMA, FADD, FMUL, FSEL).  Needs
``nvcc`` and ``cuobjdump`` (CUDA toolkit), no card.

    python scripts/cuda_kernel_report.py OUT_DIR --chain SUBSTRING [...]

adds, for each kernel instance whose mangled name holds a SUBSTRING (e.g.
``hw_filter_kernelILi7ELb0ELb0ELi0E`` for ``hw_filter_kernel<7, false,
false, 0>``, ``arima_predict_kernelILi2E``), one ``chain`` line for its step loop (the
innermost loop with the most float arithmetic): its instructions, its
shared-memory stores (which say the steps a trip: hw_filter's m 7 loop is a
28-step block with 7 vector stores of 4 preds, arima_predict's chain warp
a 4-step trip with one vector store of 4 P_00), the compiler's scheduled
stall cycles, and the longest dependent path that a register carries
around the loop, in cycles per loop iteration
(the max-plus cycle mean over the loop-carried registers, each instruction's
result ready :data:`FIXED_LATENCY` cycles after it issues, or its
:data:`VARIABLE_LATENCY`), with the opcodes along it.  The loop's SASS goes
to ``OUT_DIR/<kernel>.sass``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributed_forecasting_tpu_torch.ops._build import CSRC, CUDA_FLAGS, SOURCES  # noqa: E402

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
_FLOAT_OPS = ("FFMA", "FADD", "FMUL", "FSEL")
_BRANCHES = ("BRA", "BSSY", "BSYNC", "BAR", "EXIT", "RET", "CALL", "WARPSYNC")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)


def ptxas_lines(stderr: str) -> dict:
    """Kernel (mangled name) -> its ``ptxas info`` resource lines."""
    out, name = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(" : ", 1)[-1].strip())
    return out


def sass_loops(sass: str) -> dict:
    """Kernel (mangled name) -> its backward branches: instructions in each
    loop body and the float arithmetic among them."""
    out, name, insns = {}, None, []

    def close():
        if name is None:
            return
        addr = [a for a, _, _ in insns]
        loops = []
        for i, (a, op, args) in enumerate(insns):
            t = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and t and int(t.group(1), 16) < a:
                lo = addr.index(int(t.group(1), 16)) if int(t.group(1), 16) in addr else 0
                body = [o for _, o, _ in insns[lo:i + 1]]
                run = longest = 0
                for o in body:
                    run = 0 if o.startswith(_BRANCHES) else run + 1
                    longest = max(longest, run)
                loops.append({"instructions": len(body), "straight": longest,
                              **{k: sum(o.startswith(k) for o in body) for k in _FLOAT_OPS}})
        out[name] = {"instructions": len(insns), "loops": loops}

    for line in sass.splitlines():
        f = _FUNC.search(line)
        if f:
            close()
            name, insns = f.group(1), []
            continue
        m = _INSN.search(line)
        if m and name:
            insns.append((int(m.group(1), 16), m.group(3), m.group(4)))
    close()
    return out


# cycles from an instruction's issue to its result for a dependent
# instruction: the fixed-latency pipes (FADD, FMUL, FFMA, FSEL, FSETP, IMAD,
# MOV, ...: 4 cycles on Volta through Hopper by published microbenchmarks),
# and the variable-latency ones at a typical unloaded figure
FIXED_LATENCY = 4
VARIABLE_LATENCY = {"LDS": 30, "LDG": 500, "LDL": 30, "LD": 500, "LDC": 20,
                    "MUFU": 14, "S2R": 20, "CS2R": 20, "SHFL": 24}
_REG = re.compile(r"(?<![\w.])(U?R\d+|U?P\d)(\.64|\.128)?(?!\w)")
# opcodes whose first operand is not a register they write
_NO_DEST = ("ST", "RED", "BAR", "BRA", "EXIT", "RET", "CALL", "WARPSYNC",
            "BSSY", "BSYNC", "NOP", "YIELD", "DEPBAR", "LDGDEPBAR", "MEMBAR",
            "ERRBAR", "CCTL", "LDGSTS", "SYNCS", "ARRIVES", "UTMA", "FENCE")


def _regs(operand: str) -> list:
    """The registers an operand names, register pairs and quads expanded."""
    out = []
    for name, width, in _REG.findall(operand):
        n = {"": 1, ".64": 2, ".128": 4}[width]
        kind, num = re.match(r"(U?[RP])(\d+)", name).groups()
        out += [f"{kind}{int(num) + k}" for k in range(n)]
    return out


def _latency(op: str) -> int:
    for prefix, cycles in VARIABLE_LATENCY.items():
        if op == prefix or op.startswith(prefix + "."):
            return cycles
    return FIXED_LATENCY


def def_use(op: str, guard: str, args: str) -> tuple:
    """(registers written, registers read) of one SASS instruction."""
    operands = [a.strip() for a in args.split(",") if a.strip()]
    n_dest = 0 if op.startswith(_NO_DEST) else (
        2 if "SETP" in op or op.startswith(("PLOP3", "FCHK")) else 1)
    defs = []
    for a in operands[:n_dest]:
        regs = _regs(a)
        if regs and op.split(".")[0] not in ("FCHK",) and (
                ".64" in op or ".WIDE" in op or ".128" in op) and len(regs) == 1:
            width = 4 if ".128" in op else 2
            k, num = re.match(r"(U?[RP])(\d+)", regs[0]).groups()
            regs = [f"{k}{int(num) + j}" for j in range(width)]
        defs += regs
    uses = [r for a in operands[n_dest:] for r in _regs(a)]
    if guard:
        uses += _regs(guard)
    return defs, uses


def loop_chain(body: list) -> dict:
    """The longest dependent path a register carries around a loop body
    (``(op, guard, args)`` in order): cycles per iteration and its opcodes."""
    du = [def_use(op, g, a) for op, g, a in body]
    seen, carried = set(), []
    for defs, uses in du:
        carried += [u for u in uses if u not in seen and u not in carried]
        seen.update(defs)
    carried = [c for c in carried if c in seen]
    D, paths = {}, {}
    for c in carried:
        dist = {c: (0, None)}  # register -> (cycles, index of its writer)
        prev = {}
        for i, ((op, guard, _), (defs, uses)) in enumerate(zip(body, du)):
            reach = [dist[u] for u in uses if u in dist]
            for d in defs:
                if reach:
                    best = max(reach, key=lambda x: x[0])
                    new = (best[0] + _latency(op), i)
                    prev[i] = best[1]
                    if guard and d in dist:
                        new = max(new, dist[d], key=lambda x: x[0])
                    dist[d] = new
                elif not guard:
                    dist.pop(d, None)
        for c2 in carried:
            if c2 in dist and dist[c2][1] is not None:
                D[c, c2] = dist[c2][0]
                if c2 == c:
                    path, i = [], dist[c][1]
                    while i is not None:
                        path.append(body[i][0])
                        i = prev.get(i)
                    paths[c] = path[::-1]
    # max-plus cycle mean: the growth per iteration of the longest path
    x = {c: 0.0 for c in carried}
    rounds, hist = 64, []
    for _ in range(rounds):
        x = {c2: max([x[c] + D[c, c2] for c in carried if (c, c2) in D],
                     default=float("-inf")) for c2 in carried}
        hist.append(max(x.values(), default=float("-inf")))
    half = rounds // 2
    per_iter = ((hist[-1] - hist[half - 1]) / (rounds - half)
                if hist and hist[-1] > float("-inf") else 0.0)
    top = max(paths, key=lambda c: D[c, c], default=None)
    return {"chain_cycles_per_iteration": per_iter,
            "critical_register": top,
            "critical_self_path_cycles": D.get((top, top)),
            "critical_path": paths.get(top, []),
            "carried_registers": len(carried)}


def sass_bodies(sass: str) -> dict:
    """Kernel (mangled name) -> its innermost loops' bodies, each a list of
    ``(op, guard, args, line)``."""
    out, name, insns = {}, None, []

    def close():
        if name is None:
            return
        addr = [a for a, *_ in insns]
        spans = []
        for i, (a, op, guard, args, line) in enumerate(insns):
            t = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and t and int(t.group(1), 16) in addr \
                    and int(t.group(1), 16) < a:
                spans.append((addr.index(int(t.group(1), 16)), i))
        inner = [(lo, hi) for lo, hi in spans
                 if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                            for l2, h2 in spans)]
        out[name] = [[(op, guard, args, line) for _, op, guard, args, line
                      in insns[lo:hi + 1]] for lo, hi in inner]

    for line in sass.splitlines():
        f = _FUNC.search(line)
        if f:
            close()
            name, insns = f.group(1), []
            continue
        m = _INSN.search(line)
        if m and name:
            insns.append((int(m.group(1), 16), m.group(3),
                          (m.group(2) or "").strip(), m.group(4), line.strip()))
        elif name and insns and _CONTROL.match(line):
            *head, last = insns[-1]
            insns[-1] = (*head, last + " " + line.strip())
    close()
    return out


# the line after an instruction holds its upper 64 bits; bits 41-44 are the
# stall count the compiler scheduled before the next instruction may issue
_CONTROL = re.compile(r"\s*/\* (0x[0-9a-f]{16}) \*/\s*$")


def stall_cycles(body: list) -> int:
    """The stall counts the compiler scheduled over a loop body: its issue
    time in cycles when no operand is late (scoreboard waits on loads come
    on top)."""
    total = 0
    for *_, line in body:
        words = re.findall(r"/\* (0x[0-9a-f]{16}) \*/", line)
        if len(words) >= 2:
            total += (int(words[1], 16) >> 41) & 0xF
    return total


def chain_report(kernel: str, loops: list, out_dir: str) -> dict:
    """The step loop of ``kernel`` (its innermost loop with the most float
    arithmetic) and the chain it carries; writes the loop's SASS."""
    def flops(body):
        return sum(op.startswith(_FLOAT_OPS) for op, *_ in body)
    body = max(loops, key=flops)
    with open(os.path.join(out_dir, f"{kernel[:120]}.sass"), "w") as f:
        f.write("\n".join(line for *_, line in body) + "\n")
    ops = [op for op, *_ in body]
    return {"kernel": kernel, "instructions": len(body),
            "sts": sum(op.startswith("STS") for op in ops),
            "lds": sum(op.startswith("LDS") for op in ops),
            **{k: sum(o.startswith(k) for o in ops) for k in _FLOAT_OPS},
            "fixed_latency": FIXED_LATENCY,
            "scheduled_stall_cycles": stall_cycles(body),
            **loop_chain([(op, g, a) for op, g, a, _ in body])}


def main(out_dir: str, chains=()) -> int:
    for src in SOURCES:
        cubin = os.path.join(out_dir, src.replace(".cu", ".cubin"))
        cmd = [_tool("nvcc"), "-cubin", *CUDA_FLAGS, "-Xptxas", "-v", "-o", cubin,
               os.path.join(CSRC, src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            res.check_returncode()
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True).stdout
        ptxas = ptxas_lines(res.stderr)
        for kernel, info in sass_loops(sass).items():
            print(json.dumps({"source": src, "kernel": kernel,
                              "ptxas": ptxas.get(kernel, []), **info}), flush=True)
        for kernel, loops in sass_bodies(sass).items():
            if loops and any(c in kernel for c in chains):
                print(json.dumps({"chain": chain_report(kernel, loops, out_dir),
                                  "source": src}), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--chain", action="append", default=[])
    ns = ap.parse_args()
    if ns.out_dir:
        os.makedirs(ns.out_dir, exist_ok=True)
        sys.exit(main(ns.out_dir, ns.chain))
    with tempfile.TemporaryDirectory() as tmp:
        sys.exit(main(tmp, ns.chain))
