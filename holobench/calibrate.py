"""The readings that the limits of ``correct`` are set from, for one cell at
its own size, in one process:

- the program against the plain reference, on ``--seeds`` seeds (one
  request each, after a warm-up request);
- the control, the reference computed in the precision below the
  configuration's (its ``control``: ``bfloat16`` or ``tf32``), against the
  reference, on ``--controls`` seeds.

    python holobench/calibrate.py --workload <cell> [--seeds 12] [--controls 3] [--first-seed N]

Prints each seed's numbers, the largest of the program's (the lower
reading) and the smallest of the control's (the upper reading) of each
number, and writes them to ``holobench/out/calibrate-<cell>.json``. The
benchmark's runs do not run this. ``--rehearse`` runs it on the CPU at the
rehearsal shapes.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def readings(workload, seeds, controls, rehearse=False, first_seed=7_000_000_001, root=None):
    """``{"program": [numbers, ...], "control": [numbers, ...]}`` of a cell
    (of the ``BENCHMARK.json`` in ``root``, the checkout's by default)."""
    import importlib

    import torch

    from holobench import harness, judge

    cell, config, traffic, _, _ = harness.load_cell(workload, rehearse, root or harness.ROOT)
    device = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    kind = config["driver"]
    driver = importlib.import_module(f"holobench.drivers.{kind}")
    reference = importlib.import_module(f"holobench.reference.{kind}")
    client = driver.Client(config, traffic, device, first_seed)
    window = harness.Window(client, torch, device, False, ())
    window.serve(-1)

    out = {"program": [], "control": []}
    for k in range(seeds):
        client.seed = first_seed + 7919 * k
        req, phase = window.serve(0)
        numbers = judge.compare(phase, client.outputs(req),
                                reference.run(client.reference_inputs(req)))
        out["program"].append({"seed": client.seed, **numbers})
        print(json.dumps(out["program"][-1]), flush=True)
    for k in range(controls):
        client.seed = first_seed + 104729 * (k + 1)
        req = client.draw(0)
        inputs = client.reference_inputs(req)
        ref = reference.run(inputs)
        low = reference.run(inputs, precision=config["control"])
        numbers = judge.compare(low["phase"].cpu().numpy(), low, ref)
        out["control"].append({"seed": client.seed, **numbers})
        print(json.dumps({"control": config["control"], **out["control"][-1]}), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=7_000_000_001)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)

    from holobench import judge

    start = time.perf_counter()
    out = readings(args.workload, args.seeds, args.controls, args.rehearse, args.first_seed)
    summary = {}
    for name in judge.NUMBERS:
        lower = max(r[name] for r in out["program"]) if out["program"] else None
        upper = min(r[name] for r in out["control"]) if out["control"] else None
        summary[name] = {"lower": lower, "upper": upper}
        print(f"{name}: lower {lower} upper {upper}", flush=True)
    out["summary"] = summary
    out["seconds"] = time.perf_counter() - start
    os.makedirs(os.path.join(BENCH, "out"), exist_ok=True)
    with open(os.path.join(BENCH, "out", f"calibrate-{args.workload}.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    # The checkout's root, not this folder, is where the packages are found.
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != BENCH]
    main()
