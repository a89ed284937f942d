"""The check's two readings, on the card, for many seeds in one process.

    python3 slambench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 [--out FILE]
        [--fault NAME]

For each seed: one run of the cell (its set-up, a window of --seconds, the
comparison with the reference), then the same samples judged with the
control in the program's place: the plain reference computed with TF32 on,
the precision a later change would be tempted to drop to from the float32
the configurations state. Prints one JSON line a seed with both tables
(each number beside its limit) and, at the end, each number's largest
program reading and smallest control reading over the seeds: the two
readings a limit is set between. With --fault, the named fault of
faults.py is planted in the program for every run, and the program's
tables are the fault's readings. The benchmark's own runs do not run the
control. Needs a CUDA card.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slambench.faults import FAULTS  # noqa: E402
from slambench.harness import core  # noqa: E402


def readings(tables):
    """{number: [largest program reading, smallest control reading]}."""
    out = {}
    for prog, ctrl in tables:
        for k, row in prog.items():
            lo, hi = out.get(k, [None, None])
            v, c = row["value"], ctrl[k]["value"]
            out[k] = [v if lo is None or (v is not None and v > lo) else lo,
                      c if hi is None or (c is not None and c < hi) else hi]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    a = ap.parse_args()
    undo = []
    if a.fault:
        def patch(obj, attr, value):
            undo.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, value)

        FAULTS[a.fault][0](patch)
    tables = []
    for seed in (int(s) for s in a.seeds.split(",")):
        box = {}
        result, table = core.run(a.workload, seed, a.seconds, False, control=True, run_out=box,
                                 log=lambda *x: print(*x, file=sys.stderr))
        tables.append((table, box["control"]))
        line = {"seed": seed, "fault": a.fault, "correct": result["correct"], "program": table,
                "control": box["control"], "frames": result["attempted"],
                "detail": box["run"].detail}
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del box
    for obj, attr, old in reversed(undo):
        setattr(obj, attr, old)
    print(json.dumps({"readings": readings(tables)}))


if __name__ == "__main__":
    core.setup_env()
    main()
