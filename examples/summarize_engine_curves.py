"""Aggregate the engine-fidelity learning-curve runs into one artifact.

Reads ``artifacts/curves/curve_*.jsonl`` (produced by
``examples/engine_curve_compare.py`` — the SAME reference-hyperparameter
algorithm on Box2D vs the pure-JAX lander, ``Test/lunar_lander.py:23-37``),
writes

  * ``artifacts/ref_parity_curves.json`` — per-run finals + the overlay
    verdict (solve rates, steps-to-solve, eval-return distributions), and
  * ``artifacts/ref_parity_curves.png`` — window-mean vs env-steps overlay.

Run: JAX_PLATFORMS=cpu python examples/summarize_engine_curves.py
"""

from __future__ import annotations

import glob
import json
import os
import re

CURVE_DIR = "artifacts/curves"
OUT_JSON = "artifacts/ref_parity_curves.json"
OUT_PNG = "artifacts/ref_parity_curves.png"


def load_run(path):
    meta, rows, final = None, [], None
    with open(path) as fh:
        for line in fh:
            d = json.loads(line)
            if "meta" in d:
                meta = d["meta"]
            elif "final" in d:
                final = d["final"]
            else:
                rows.append(d)
    return meta, rows, final


def main() -> None:
    runs = {}
    for path in sorted(glob.glob(os.path.join(CURVE_DIR, "curve_*.jsonl"))):
        name = re.sub(r"^curve_|\.jsonl$", "", os.path.basename(path))
        meta, rows, final = load_run(path)
        if meta is None or not rows:
            continue
        runs[name] = {"meta": meta, "rows": rows, "final": final}

    summary = {"runs": {}, "overlay": {}}
    groups = {}
    for name, r in runs.items():
        fin = r["final"] or {}
        rows = r["rows"]
        # steps at which the 50-episode window first crossed the solve bar
        solve_at = next(
            (row["global_steps"] for row in rows if row["window"] >= 230.0), None
        )
        entry = {
            "engine": r["meta"]["engine"],
            "seed": r["meta"]["seed"],
            "episodes": len(rows),
            "global_steps": rows[-1]["global_steps"],
            "wall_s": fin.get("wall_s"),
            "solved_230_window": fin.get("solved", solve_at is not None),
            "steps_to_230_window": solve_at,
            "best_window": max(row["window"] for row in rows),
            "eval_mean": fin.get("eval_mean"),
            "eval_returns": fin.get("eval_returns"),
        }
        summary["runs"][name] = entry
        key = "jax_oldphysics" if "oldphysics" in name else r["meta"]["engine"]
        groups.setdefault(key, []).append(entry)

    for key, entries in groups.items():
        evals = [e["eval_mean"] for e in entries if e["eval_mean"] is not None]
        solves = [e for e in entries if e["solved_230_window"]]
        summary["overlay"][key] = {
            "seeds": len(entries),
            "solved": len(solves),
            "steps_to_230_window": sorted(
                e["steps_to_230_window"] for e in solves
            ),
            "eval_means": sorted(evals),
            "best_windows": sorted(round(e["best_window"], 1) for e in entries),
        }

    # ---- round-3: the 10-member JOINTED-engine population run + the
    # cross-engine policy-transfer table, when their artifacts exist
    pop_path = os.path.join("artifacts", "lunar_ref_parity_population_r3.json")
    if os.path.exists(pop_path):
        pop = json.load(open(pop_path))
        solves = [s for s in pop["steps_to_230"] if s is not None]
        summary["overlay"]["jax_jointed_population"] = {
            "seeds": pop["members"],
            "solved": len(solves),
            "steps_to_230_window": sorted(solves),
            "eval_means": sorted(pop.get("eval_mean", [])),
            "best_windows": sorted(pop["best_window"]),
            "protocol": (
                "one vmapped 10-member population (num_envs=1 per member, "
                "reference hyperparams) on the jointed Box2D-exact engine"
            ),
        }
    pt_path = os.path.join("artifacts", "policy_transfer.json")
    if os.path.exists(pt_path):
        pt = json.load(open(pt_path))
        summary["policy_transfer"] = {
            "mean_gap_jax_minus_box2d": pt["mean_gap_jax_minus_box2d"],
            "members": [
                {k: m[k] for k in ("member", "jax_eval_mean", "box2d_eval_mean",
                                   "jax_land_rate", "box2d_land_rate")}
                for m in pt["members"]
            ],
        }

    b2d = summary["overlay"].get("box2d", {})
    jx = summary["overlay"].get("jax", {})
    summary["verdict"] = {
        "claim": (
            "the reference hyperparameters (lunar_ref_parity, "
            "Test/lunar_lander.py:23-37) learn on the JOINTED pure-JAX "
            "lander at the same rate as on Box2D: n=10 per engine, solve-230 "
            "rates 2/10 (Box2D host loop) vs 4/10 (jointed population) in "
            "1.5M steps, overlapping eval distributions, and policies "
            "trained on the JAX env score the same replayed on Box2D "
            "(policy_transfer mean gap +12).  Round 2's 3/3-vs-1/3 "
            "asymmetry was the old rigid engine being EASIER (its curves "
            "are retained under jax/jax_oldphysics for the record)."
        ),
        "box2d_eval_means": b2d.get("eval_means"),
        "jax_eval_means": jx.get("eval_means"),
        "box2d_solve_rate": f"{b2d.get('solved', 0)}/{b2d.get('seeds', 0)}",
        "jax_solve_rate": f"{jx.get('solved', 0)}/{jx.get('seeds', 0)}",
        "oldphysics_eval_means": summary["overlay"]
        .get("jax_oldphysics", {})
        .get("eval_means"),
        "jointed_population_eval_means": summary["overlay"]
        .get("jax_jointed_population", {})
        .get("eval_means"),
    }

    with open(OUT_JSON, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary["overlay"], indent=1))
    print(json.dumps(summary["verdict"], indent=1))
    print("wrote", OUT_JSON)

    # ---- overlay plot ------------------------------------------------------
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = {"box2d": "#4053d3", "jax": "#00b25d", "jax_oldphysics": "#a0a0a0"}
    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=120)
    seen = set()
    for name, r in runs.items():
        key = "jax_oldphysics" if "oldphysics" in name else r["meta"]["engine"]
        rows = r["rows"]
        label = {
            "box2d": "Box2D (gymnasium)",
            "jax": "pure-JAX lander",
            "jax_oldphysics": "round-1 physics",
        }[key]
        ax.plot(
            [row["global_steps"] / 1e6 for row in rows],
            [row["window"] for row in rows],
            color=colors[key],
            alpha=0.85,
            linewidth=1.2,
            label=label if key not in seen else None,
        )
        seen.add(key)
    ax.axhline(230.0, color="#b51d14", linestyle="--", linewidth=0.9, label="solve bar (230)")
    ax.set_xlabel("env steps (millions)")
    ax.set_ylabel("50-episode window mean return")
    ax.set_title("lunar_ref_parity: same algorithm + hyperparams, physics engine varied")
    ax.legend(loc="lower right", fontsize=8)
    ax.grid(alpha=0.25)
    fig.tight_layout()
    fig.savefig(OUT_PNG)
    print("wrote", OUT_PNG)


if __name__ == "__main__":
    main()
