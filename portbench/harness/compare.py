"""The comparison that decides ``correct``: the numbers a run reads against
the plain reference, each beside its limit (``limits/<workload>.json``).

Training (each a share, 0 where the two sides agree):
  ``loss1``   the relative gap of the first step's loss;
  ``loss``    the widest relative gap of the first three steps' losses;
  ``grad1``   the first step's gradient as AdamW received it (read back from
              its first moment after one step), by the worst leaf: the gap
              between the two sides' norms of a leaf over the larger of the
              reference's norm of that leaf and of the median leaf;
  ``grad1_diff`` the same gradient element by element: the worst leaf's norm
              of the difference over the reference's norm of that leaf
              (norms of whole leaves average rounding away, so ``grad1``
              barely tells float8 from bf16; this does);
  ``change3`` the parameters' change over the first three steps, by the
              worst leaf in the same way, leaving out the leaves whose
              first gradient in the reference is under a thousandth of the
              median leaf's (they move by round-off alone under Adam);
  ``table3``  the token rows and their Adagrad accumulators after three
              steps, committed to the PS and read back: the worse of the gap
              between the norms of the rows' change and between the norms of
              the accumulators, each over the reference's;
  ``ps_rows`` of a sample of token ids drawn from the seed, the pulls (every
              step's, the window's included) and the read-back after the
              window whose row or accumulator differs from what was last
              committed for that id (exact).
Serving:
  ``rows``    requests whose rows on the card differ from the table's (exact);
  ``gap``     the widest gap by which a served first token's logit lies below
              the reference's best logit of that position;
  ``logits``  the widest gap between the two sides' last-position logits
              over the reference's largest magnitude, by request.
"""

from __future__ import annotations

import statistics


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |prog - ref| / max(ref, median ref)} over leaves in ``keep``."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def moving(grad1_ref: dict) -> set:
    """Leaves whose first gradient in the reference is at least a thousandth
    of the median leaf's."""
    med = statistics.median(grad1_ref.values())
    return {k for k, v in grad1_ref.items() if v >= 1e-3 * med}


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """-> ({number: value}, {number: the worst leaf or step})."""
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    g = leaf_gaps(prog["grad1"], ref["grad1"])
    c = leaf_gaps(prog["change3"], ref["change3"], moving(ref["grad1"]))
    rows = abs(prog["rows_change"] - ref["rows_change"]) / ref["rows_change"]
    accs = abs(prog["accs_norm"] - ref["accs_norm"]) / ref["accs_norm"]
    worst = lambda d: max(d, key=d.get)
    numbers = {"loss1": loss[0], "loss": max(loss), "grad1": max(g.values()),
               "change3": max(c.values()), "table3": max(rows, accs)}
    where = {"loss": f"step {loss.index(max(loss)) + 1}", "grad1": worst(g),
             "change3": worst(c), "table3": "rows" if rows >= accs else "accumulators"}
    if "ps_rows" in prog:
        numbers["ps_rows"] = prog["ps_rows"]
    if "grad1_diff" in prog:
        numbers["grad1_diff"] = max(prog["grad1_diff"].values())
        where["grad1_diff"] = worst(prog["grad1_diff"])
    return numbers, where


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """Every number that has a limit at or under it -> (correct, [[name,
    value, limit]]). A number with no limit in the cell's file is read but
    not compared (``PERF.md`` says why)."""
    rows = [[k, float(v), float(limits[k])] for k, v in numbers.items() if k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)  # a NaN fails
    return ok, rows
