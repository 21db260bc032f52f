"""Seconds a run of chip_smoke.py spends on each of its phases.

    python scripts/smoke_phase_seconds.py run OUT.jsonl [--cwd DIR] [-- CMD ...]
    python scripts/smoke_phase_seconds.py compare A.jsonl B.jsonl

``run`` starts CMD (default ``python3 chip_smoke.py``) in DIR (default the
current directory), writes each line of its standard output to OUT as
``{"t": seconds since the start, "line": ...}`` and its standard error to
OUT.stderr, and prints one JSON line: the exit code, the wall seconds, and
for each ``phase`` of the JSON lines the seconds since the line before it,
summed (the time that produced the line; a line that is not JSON counts
under "text").  It exits with CMD's code.  ``compare`` prints both runs'
seconds by phase and the second's minus the first's.

Run two commits in one call to compare them on one card and host, e.g.
``run out/parent.jsonl --cwd parent`` then ``run out/change.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def by_phase(stamped: list) -> dict:
    """Seconds since the previous line, summed by the line's phase, in the
    order the phases first appear."""
    out, last = {}, 0.0
    for rec in stamped:
        try:
            phase = json.loads(rec["line"]).get("phase", "text")
        except (ValueError, AttributeError):
            phase = "text"
        out[phase] = out.get(phase, 0.0) + rec["t"] - last
        last = rec["t"]
    return out


def run(out_path: str, cwd: str, cmd: list) -> int:
    t0 = time.perf_counter()
    stamped = []
    with open(out_path, "w") as out, open(out_path + ".stderr", "w") as err:
        proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        for line in proc.stdout:
            rec = {"t": time.perf_counter() - t0, "line": line.rstrip("\n")}
            stamped.append(rec)
            out.write(json.dumps(rec) + "\n")
            out.flush()
        rc = proc.wait()
    print(json.dumps({"out": out_path, "rc": rc,
                      "seconds": time.perf_counter() - t0,
                      "phase_seconds": by_phase(stamped)}), flush=True)
    return rc


def load(path: str) -> tuple:
    with open(path) as f:
        stamped = [json.loads(line) for line in f if line.strip()]
    return (stamped[-1]["t"] if stamped else 0.0), by_phase(stamped)


def compare(a_path: str, b_path: str) -> int:
    (ta, a), (tb, b) = load(a_path), load(b_path)
    phases = list(dict.fromkeys([*a, *b]))
    print(json.dumps({"a": a_path, "b": b_path, "a_seconds": ta,
                      "b_seconds": tb, "b_minus_a": tb - ta,
                      "phases": {p: [a.get(p, 0.0), b.get(p, 0.0),
                                     b.get(p, 0.0) - a.get(p, 0.0)]
                                 for p in phases}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    r = sub.add_parser("run")
    r.add_argument("out")
    r.add_argument("--cwd", default=".")
    r.add_argument("cmd", nargs="*")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    ns = ap.parse_args(argv)
    if ns.what == "run":
        return run(ns.out, ns.cwd, ns.cmd or ["python3", "chip_smoke.py"])
    return compare(ns.a, ns.b)


if __name__ == "__main__":
    sys.exit(main())
