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
"""

from __future__ import annotations

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


def main(out_dir: str) -> int:
    for src in SOURCES:
        cubin = os.path.join(out_dir, src.replace(".cu", ".cubin"))
        cmd = [_tool("nvcc"), "-cubin", *CUDA_FLAGS, "-Xptxas", "-v", "-o", cubin,
               os.path.join(CSRC, src)]
        res = subprocess.run(cmd, capture_output=True, text=True, check=True)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True).stdout
        ptxas = ptxas_lines(res.stderr)
        for kernel, info in sass_loops(sass).items():
            print(json.dumps({"source": src, "kernel": kernel,
                              "ptxas": ptxas.get(kernel, []), **info}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        os.makedirs(sys.argv[1], exist_ok=True)
        sys.exit(main(sys.argv[1]))
    with tempfile.TemporaryDirectory() as tmp:
        sys.exit(main(tmp))
