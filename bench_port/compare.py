"""The comparison that decides ``correct``.

Every answer due in the window is held to the configuration's
guarantee (``sound``).  An unfaulted request, on a clean matrix,
reports no error, no correction and a finite r.r.  A request preceded
by a one-bit flip reports no error, exactly one correction, made at the
exec slot and the bit where the flip was made, and a finite r.r: secded
corrects every single-bit flip.  A sample of the answers, drawn from
the seed, is held to the plain float64 CG of ``reference.py`` run on
the same matrix and the same b.  Three numbers are compared, each the
worst over the sample:

- ``iterations_gap``: |iterations - the reference's| (limit 0: both
  stop on the same test of r.r against the threshold, or at the limit);
- ``x_max_err``: max |x - x_ref| / max |x_ref|, so that one wrong
  element counts as much as a wrong vector;
- ``rr_rel_gap``: |r.r - r.r_ref| / r.r_ref.

plus ``bad_status``, the answers that break the guarantee (limit 0),
and under fault traffic ``unrepaired_planes``, the resident planes that
are not bit-identical at the window's close to a copy taken before the
first fault (limit 0).  The sample then holds faulted answers too: the
corrected matrix must give the clean matrix's solution.  Each limit
sits in the configuration's file, set from the readings of sound runs
and of the bfloat16 control (PERF.md).
"""

from __future__ import annotations

import math

import torch

NAMES = ("iterations_gap", "x_max_err", "rr_rel_gap")


def sound(ans, expect=None) -> bool:
    """Whether an answer keeps the guarantee.  ``expect``: None for an
    unfaulted request (no correction), else the (exec slot, bit) of the
    one flip made before it (exactly that correction)."""
    if ans.errcode != 0 or not math.isfinite(ans.rr):
        return False
    if expect is None:
        return ans.corrected == 0
    return (ans.corrected == 1
            and (ans.first_cor_slot, ans.first_cor_bit) == tuple(expect))


def reading(ans, ref) -> dict:
    """The compared numbers of one answer against the reference's."""
    x = ans.x.to(torch.float64)
    xr = ref.x.to(torch.float64)
    den = float(xr.abs().max())
    rr_den = abs(ref.rr)
    return {
        "iterations_gap": float(abs(ans.iterations - ref.iterations)),
        "x_max_err": (float((x - xr).abs().max()) / den if den > 0
                      else math.inf),
        "rr_rel_gap": (abs(ans.rr - ref.rr) / rr_den if rr_den > 0
                       else (0.0 if ans.rr == ref.rr else math.inf)),
    }


def within(r: dict, limits: dict) -> bool:
    return all(r[k] <= limits[k] for k in NAMES)


def judge(readings: list, bad_status: int, limits: dict, unrepaired=None):
    """(correct, checks): ``checks`` maps each compared number to its
    worst value and its limit, in a fixed order; ``unrepaired`` (None
    without fault traffic) is the count of unrepaired planes."""
    checks = {}
    for k in NAMES:
        vals = [r[k] for r in readings]
        # NaN compares false: a NaN reading fails its limit.
        worst = max(vals, key=lambda v: math.inf if math.isnan(v) else v,
                    default=math.inf)
        checks[k] = {"value": worst, "limit": limits[k]}
    checks["bad_status"] = {"value": bad_status, "limit": 0}
    if unrepaired is not None:
        checks["unrepaired_planes"] = {"value": unrepaired, "limit": 0}
    correct = bool(readings) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
