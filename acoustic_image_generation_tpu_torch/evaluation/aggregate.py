"""Multi-seed aggregation: drop the min and the max, mean +- std of the
rest.

Counterpart of ``acoustic_image_generation_tpu/evaluation/aggregate.py``
(the reference's ``meanstd.py`` 5-seed protocol). Output is JSON or, as the
reference writes it, an ``.xlsx`` workbook (``utils/xlsx.py``)."""

from __future__ import annotations

import json
import numpy as np


def trimmed_mean_std(values) -> tuple[float, float]:
    """Drop one min and one max, return (mean, std) of the rest
    (population std, like np.std default used by the reference)."""
    v = sorted(float(x) for x in values)
    if len(v) > 2:
        v = v[1:-1]
    arr = np.asarray(v)
    return float(arr.mean()), float(arr.std())


def aggregate_runs(metric_values: dict[str, list[float]], out_path: str | None = None) -> dict:
    """{metric: [seed values]} -> {metric: {mean, std, n}}. ``out_path``
    ending in .xlsx writes the reference-style workbook
    (meanstd.py:150-163: one row per metric, mean/std/n columns);
    anything else writes json."""
    out = {}
    for name, vals in metric_values.items():
        mean, std = trimmed_mean_std(vals)
        out[name] = {"mean": mean, "std": std, "n": len(vals)}
    if out_path and out_path.endswith(".xlsx"):
        from acoustic_image_generation_tpu_torch.utils.xlsx import write_xlsx

        rows = [["metric", "mean", "std", "n"]] + [
            [name, v["mean"], v["std"], v["n"]] for name, v in sorted(out.items())
        ]
        write_xlsx(out_path, rows, sheet_name="meanstd")
    elif out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
    return out
