#!/usr/bin/env python3
"""Seconds by phase of a ``chip_smoke.py`` run, from its output.

    python3 chip_smoke.py > smoke.log
    python3 scripts/smoke_phases.py smoke.log [--over 10]

Every JSON line of the script carries ``at_s``, its seconds since the
script started. A line's seconds are the gap since the line before it (the
work it reports came first); a numbered phase starts with the first line
of its kind (``PHASE_FIRST``) and its seconds are the gaps of its lines.
Prints one JSON object: each phase's seconds, every line whose gap is over
``--over`` seconds (labelled by phase, kind and run), and the total; where
the log has the script's own ``phase_seconds`` line, that too.
"""
import argparse
import json

#: the kind (and run, for the main path) of each numbered phase's first line
PHASE_FIRST = (
    (1, "device", None), (2, "build", None), (3, "kernel", None),
    (4, "design", None), (5, "main_path", "Fig. 2 ProposedOTA"),
    (6, "scenario", None), (7, "layer_streams_vs_cpu", None),
    (8, "fast", None), (9, "serve_kernel_vs_plain", None),
    (10, "psum_kernel_vs_plain", None), (11, "remat", None),
    (12, "cost_report", None), (13, "mesh_ranks", None),
    (14, "phase_seconds", None))


def label(line):
    what = next((line[k] for k in ("run", "kernel", "arch") if k in line), "")
    return " ".join(str(x) for x in (line["phase"], what, line.get("family"))
                    if x)


def tabulate(lines, over):
    phases, parts, stamps = {}, [], {}
    phase, prev = 0, 0.0
    for line in lines:
        for n, kind, run in PHASE_FIRST:
            if (n > phase and line.get("phase") == kind
                    and (run is None or line.get("run") == run)):
                phase = n
                break
        gap = line["at_s"] - prev
        prev = line["at_s"]
        phases[phase] = phases.get(phase, 0.0) + gap
        if gap > over:
            parts.append(dict(phase=phase, line=label(line), seconds=gap))
        if line.get("phase") == "phase_seconds":
            stamps = line["seconds"]
    return dict(phase_seconds={str(k): v for k, v in sorted(phases.items())},
                over=over, parts=parts, total_s=prev,
                script_phase_seconds=stamps or None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log")
    ap.add_argument("--over", type=float, default=10.0)
    args = ap.parse_args(argv)
    lines = []
    with open(args.log) as f:
        for text in f:
            text = text.strip()
            if not text.startswith("{"):
                continue
            try:
                line = json.loads(text)
            except ValueError:
                continue
            if "at_s" in line:
                lines.append(line)
    print(json.dumps(tabulate(lines, args.over), indent=1))


if __name__ == "__main__":
    main()
