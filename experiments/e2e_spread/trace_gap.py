"""Gaps between per-step training traces (``jax_fits --trace``,
``port_fits train --trace``; one JSON line a step, ``steps.py``).

Usage, from the repository root:
  python3 -m experiments.e2e_spread.trace_gap A B
  python3 -m experiments.e2e_spread.trace_gap I II III IV

Two files: gap(A, B)(t) = |term_A - term_B| / |term_B| for the total and
each of the six terms, at a few steps and as the step where it first
reaches 1e-2. Four files, in the order (i) the JAX package, (ii) the port
from the same start, (iii) the port from the start x (1 + eps), (iv) the
JAX package from it: the verdict rule. Per term, T is the first step at
which the perturbed gap max(gap(iii, ii), gap(iv, i)) reaches 1e-2; the
port is consistent if gap(ii, i)(t) <= 10 x that perturbed gap at every
step t < T of every term, a gap(ii, i) below ``FLOOR`` counting as no
break, and departs at the first (step, term) where it does not. Every
file must have seen the same batches (equal batch sums at every
step)."""
import argparse
import sys

import numpy as np

from experiments.e2e_spread.steps import read_trace

TERMS = ("loss", "df_h", "df_o", "parts", "pca", "smpl_center", "obj_center")
SHOW = (1, 2, 3, 5, 10, 20, 50, 100, 200, 500, 750, 900, 1000)
MILESTONES = (750, 900)
# float32 rounding of a step's sums (~100 ulps, the first step's
# tolerance): below it two runs part by rounding alone, while twins can
# agree to the last bit
FLOOR = 1e-5


def series(trace):
    """{term: float64 array over steps}."""
    return {k: np.array([s[k] for s in trace], np.float64) for k in TERMS}


def gap(a, b):
    """{term: |a - b| / |b| per step}."""
    return {k: np.abs(a[k] - b[k]) / np.maximum(np.abs(b[k]), 1e-30)
            for k in TERMS}


def same_batches(traces, names):
    """Raise unless every trace saw the first one's batches."""
    n = min(len(t) for t in traces)
    for t, name in zip(traces[1:], names[1:]):
        for key in ("points_sum", "images_sum"):
            a = np.array([s[key] for s in traces[0][:n]])
            b = np.array([s[key] for s in t[:n]])
            if not np.array_equal(a, b):
                bad = int(np.flatnonzero(a != b)[0]) + 1
                raise SystemExit(f"{name}: other batches than {names[0]} "
                                 f"from step {bad} ({key})")
    return n


def first_at_least(x, level):
    """1-based index of the first element >= level, else None."""
    hit = np.flatnonzero(x >= level)
    return int(hit[0]) + 1 if hit.size else None


def print_table(gaps, labels, n):
    steps = [s for s in SHOW if s <= n]
    for k in TERMS:
        print(f"{k}:")
        for g, label in zip(gaps, labels):
            row = " ".join(f"{g[k][s - 1]:8.1e}" for s in steps)
            print(f"  {label:12s} {row}   reaches 1e-2 at step "
                  f"{first_at_least(g[k], 1e-2)}")
    print("  steps        " + " ".join(f"{s:8d}" for s in steps))


def verdict(cross, pert):
    """(None, T per term) if consistent, else ((step, term, cross gap,
    perturbed gap), T per term) at the first break in step order."""
    first, ends = None, {}
    for k in TERMS:
        p = pert[k]
        end = first_at_least(p, 1e-2) or len(p) + 1
        ends[k] = end
        bad = np.flatnonzero((cross[k][:end - 1] > 10 * p[:end - 1])
                             & (cross[k][:end - 1] > FLOOR))
        if bad.size and (first is None or bad[0] + 1 < first[0]):
            first = (int(bad[0]) + 1, k, float(cross[k][bad[0]]),
                     float(p[bad[0]]))
    return first, ends


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("traces", nargs="+")
    args = ap.parse_args(argv)
    if len(args.traces) not in (2, 4):
        raise SystemExit("give two trace files, or four: (i) (ii) (iii) (iv)")
    traces = [read_trace(p) for p in args.traces]
    n = same_batches(traces, args.traces)
    s = [{k: v[:n] for k, v in series(t).items()} for t in traces]
    print(f"{n} steps, the same batches in every file")
    if len(s) == 2:
        print_table([gap(s[0], s[1])], ["gap(A, B)"], n)
        return 0
    cross = gap(s[1], s[0])
    pp, pj = gap(s[2], s[1]), gap(s[3], s[0])
    pert = {k: np.maximum(pp[k], pj[k]) for k in TERMS}
    print_table([cross, pp, pj], ["(ii)-(i)", "(iii)-(ii)", "(iv)-(i)"], n)
    first, ends = verdict(cross, pert)
    print("perturbed gaps reach 1e-2 at "
          + ", ".join(f"{k} {v}" for k, v in ends.items()))
    if first is None:
        print("consistent")
        return 0
    step, term, c, p = first
    at = "".join(f" (at the LR milestone, step {m})"
                 for m in MILESTONES if abs(step - m) <= 2)
    print(f"departs at step {step}{at}, {term}: gap(ii, i) {c:.3g} > "
          f"10 x perturbed {p:.3g}")
    return 1

if __name__ == "__main__":
    sys.exit(main())
