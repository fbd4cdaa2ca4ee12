"""Merge standalone scipy-baseline race results into a north-star artifact.

The north-star run (scripts/northstar.py) and the scipy baselines
(scripts/northstar_scipy.py) run as separate processes so a host OOM in one
cannot lose the other's result.  This script stitches the JSON artifacts
together afterwards:

  python scripts/merge_race.py northstar.json \
      --same-size /tmp/ns108.json /tmp/scipy108.json \
      --big-scipy /tmp/scipy216.json

- ``--same-size SOLVER SCIPY``: a pair of runs of the SAME problem size;
  adds ``same_size_race`` with both wall-clocks and the measured speedup
  (both endpoints finished, same matrix).
- ``--big-scipy``: a larger scipy run (finished or still a lower bound)
  recorded alongside, without claiming a same-size comparison.
"""

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("artifact")
    ap.add_argument("--same-size", nargs=2,
                    metavar=("SOLVER_JSON", "SCIPY_JSON"))
    ap.add_argument("--big-scipy")
    args = ap.parse_args()

    with open(args.artifact) as f:
        info = json.load(f)

    if args.same_size:
        with open(args.same_size[0]) as f:
            ours = json.load(f)
        with open(args.same_size[1]) as f:
            sc = json.load(f)
        if ours["num_points"] != sc["num_points"]:
            raise SystemExit(f"not the same problem: {ours['num_points']} "
                             f"vs {sc['num_points']}")
        if sc.get("status") not in (None, "done"):
            raise SystemExit(f"scipy run not complete: {sc.get('status')}")
        info["same_size_race"] = {
            "num_points": ours["num_points"],
            "k": sc["k"],
            "solver_total_s": ours["t_solve_s"],
            "solver_true_residual_max": ours.get("true_residual_max"),
            "solver_pairs_below_1e-8": ours.get("pairs_below_1e-8"),
            "scipy_eigsh_s": sc["scipy_eigsh_s"],
            "scipy_status": sc.get("status"),
            "speedup_vs_scipy": sc["scipy_eigsh_s"] / ours["t_solve_s"],
            "note": "same graph Laplacian, k=100, both runs completed",
        }

    if args.big_scipy:
        with open(args.big_scipy) as f:
            sc = json.load(f)
        entry = dict(sc)
        if sc.get("status") == "running" and sc.get("started_unix"):
            entry["elapsed_lower_bound_s"] = time.time() - sc["started_unix"]
        info["scipy_baseline_large"] = entry

    with open(args.artifact, "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps({k: info[k] for k in info if "race" in k or "scipy" in k},
                     indent=1))


if __name__ == "__main__":
    main()
