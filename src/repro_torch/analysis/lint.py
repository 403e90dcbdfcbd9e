"""Program-contract lint runner + CLI.

Usage::

  PYTHONPATH=src python -m repro_torch.analysis.lint --all --device cpu --ranks 2
  PYTHONPATH=src python -m repro_torch.analysis.lint --check donation --check kernels
  PYTHONPATH=src python -m repro_torch.analysis.lint --list

``--all`` builds every registered contract at its miniature
configuration on ``--device`` (the card by default; ``cuda`` raises
without one), runs the checks each contract declares, writes
``results/lint_torch.json`` and exits nonzero on any ``error`` finding
or, when every contract ran, on a wall time over twice the device
type's committed baseline (``lint_budget.json`` beside this module).
A multi-rank contract runs in every rank of a gloo group of ``--ranks``
processes spawned for it (time-sliced on the one card); with fewer
ranks it reports itself skipped, as the reference's do on one device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import List, Optional, Sequence

from . import CHECKS, CONTRACTS, load_builtin_checks
from .findings import Finding, Report
from .registry import ContractSkip


def _load_all() -> None:
    from . import contracts

    load_builtin_checks()
    contracts.load_contracts()


def run_lint(
    checks: Optional[Sequence[str]] = None,
    contracts: Optional[Sequence[str]] = None,
    device="cuda",
    ranks: int = 1,
) -> Report:
    """Build the selected contracts on ``device`` and run their selected
    checks.  Multi-rank contracts run here when this process is a rank
    of a large enough group, else in ``ranks`` spawned gloo ranks when
    ``ranks`` is large enough, else they skip (``info``)."""
    import torch.distributed as dist

    from ..device import resolve

    dev = resolve(device)
    _load_all()
    want_checks = set(checks) if checks else set(CHECKS)
    want_contracts = set(contracts) if contracts else set(CONTRACTS)
    unknown = (want_checks - set(CHECKS)) | (want_contracts - set(CONTRACTS))
    if unknown:
        raise ValueError(
            f"unknown checks/contracts: {sorted(unknown)}; "
            f"known checks {sorted(CHECKS)}, contracts {sorted(CONTRACTS)}"
        )

    world = dist.get_world_size() if dist.is_initialized() else 1
    report = Report(backend=dev.type)
    spawned: List[str] = []
    for name in sorted(want_contracts):
        contract = CONTRACTS[name]
        selected = [c for c in contract.checks if c in want_checks]
        if not selected:
            continue
        if contract.ranks > world and ranks >= contract.ranks:
            spawned.append(name)
            continue
        t_build = time.perf_counter()
        try:
            built = contract.build(dev)
        except ContractSkip as e:
            report.findings.append(Finding(
                "contract", name, "info", f"skipped: {e}"))
            continue
        except Exception as e:
            # A contract that cannot even build is a lint failure: the
            # miniature program it describes no longer constructs.
            report.findings.append(Finding(
                "contract", name, "error",
                f"contract build failed: {type(e).__name__}: {e}"[:2000]))
            continue
        finally:
            report.timings[f"{name}:build"] = time.perf_counter() - t_build
        report.contracts_executed.append(name)
        for check in selected:
            t_check = time.perf_counter()
            try:
                found = CHECKS[check](name, built)
            except Exception as e:
                found = [Finding(
                    check, name, "error",
                    f"check crashed: {type(e).__name__}: {e}"[:2000])]
            report.timings[f"{name}:{check}"] = time.perf_counter() - t_check
            report.checks_executed.append(check)
            report.extend(found)
    if spawned:
        from .contracts import run_in_ranks

        t0 = time.perf_counter()
        merge_rank_reports(report, run_in_ranks(spawned, sorted(want_checks), dev, ranks))
        report.timings["ranks:spawn"] = time.perf_counter() - t0
    return report


def merge_rank_reports(report: Report, ranks: List[dict]) -> None:
    """Fold each rank's ``Report.to_json()`` into ``report``: findings
    tagged with their rank, executed names united, each timing the
    slowest rank's."""
    for r, rec in enumerate(ranks):
        for f in rec["findings"]:
            report.findings.append(Finding(f["check"], f["contract"], f["severity"],
                                           f"[rank {r}] {f['message']}",
                                           {**f["data"], "rank": r}))
        report.contracts_executed.extend(rec["contracts_executed"])
        report.checks_executed.extend(rec["checks_executed"])
        for k, v in rec["timings"].items():
            report.timings[k] = max(report.timings.get(k, 0.0), float(v))


# Committed beside this module, one baseline per device type: {"cpu": {...}, "cuda": {...}}.
BENCH_PATH = str(pathlib.Path(__file__).with_name("lint_budget.json"))
BUDGET_FACTOR = 2.0


def check_runtime_budget(
    report: Report, wall_s: float, bench_path: str = BENCH_PATH,
    record: bool = True, device: Optional[str] = None,
) -> Optional[str]:
    """Compare a full run's wall time to the recorded baseline.

    First full run records ``bench_path``; later runs fail (return an
    error string) when total wall time exceeds ``BUDGET_FACTOR`` x the
    baseline — a regression guard on the lint suite itself, so a new
    check or contract cannot silently double its time.  Returns None
    when within budget.

    With ``device`` (a device type, "cpu" or "cuda") the file holds one
    baseline per device type and this run's is ``device``'s entry,
    recorded beside the others when absent; without it the file is one
    baseline, the reference's layout.
    """
    bench = pathlib.Path(bench_path)
    book = json.loads(bench.read_text()) if bench.exists() else None
    entry = book if device is None else (book or {}).get(device)
    if entry is None:
        if record:
            new = {
                "total_wall_s": round(wall_s, 2),
                "timings": {k: round(v, 3)
                            for k, v in sorted(report.timings.items())},
            }
            bench.parent.mkdir(parents=True, exist_ok=True)
            bench.write_text(json.dumps(new if device is None else {**(book or {}), device: new},
                                        indent=2, sort_keys=True) + "\n")
        return None
    baseline = float(entry["total_wall_s"])
    budget = BUDGET_FACTOR * baseline
    if wall_s > budget:
        return (
            f"lint runtime {wall_s:.1f}s exceeds budget {budget:.1f}s "
            f"({BUDGET_FACTOR}x recorded baseline {baseline:.1f}s in "
            f"{bench_path}); speed the suite up or re-record the baseline"
        )
    return None


def contract_seconds(report: Report) -> dict:
    """Seconds per contract (its build and its checks)."""
    per: dict = {}
    for key, secs in report.timings.items():
        contract, _, _phase = key.partition(":")
        per[contract] = per.get(contract, 0.0) + secs
    return per


def _print_timings(report: Report, wall_s: float) -> None:
    print("runtime per contract (build + checks):")
    for contract, secs in sorted(contract_seconds(report).items(), key=lambda kv: -kv[1]):
        print(f"  {secs:7.2f}s  {contract}")
    print(f"  {wall_s:7.2f}s  total wall")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="program-contract lint over recorded op traces",
    )
    ap.add_argument("--all", action="store_true",
                    help="run every check on every contract")
    ap.add_argument("--check", action="append", default=[],
                    help="run only this check (repeatable)")
    ap.add_argument("--contract", action="append", default=[],
                    help="run only this contract (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list registered checks and contracts, then exit")
    ap.add_argument("--device", default="cuda",
                    help="device to build the contracts on (cuda raises without a card)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo ranks to spawn for the multi-rank contracts (>= 2 runs them)")
    ap.add_argument("--out", default="results/lint_torch.json",
                    help="where to write the JSON report")
    args = ap.parse_args(argv)

    if args.list:
        _load_all()
        print("checks:")
        for name in sorted(CHECKS):
            print(f"  {name}")
        print("contracts:")
        for name, c in sorted(CONTRACTS.items()):
            ranks = f" ({c.ranks} ranks)" if c.ranks > 1 else ""
            print(f"  {name} [{', '.join(c.checks)}]{ranks} — {c.description}")
        return 0
    if not (args.all or args.check or args.contract):
        ap.print_help()
        return 2

    t0 = time.time()
    report = run_lint(checks=args.check or None, contracts=args.contract or None,
                      device=args.device, ranks=args.ranks)
    wall_s = time.time() - t0
    payload = report.to_json()
    payload["wall_s"] = round(wall_s, 2)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")

    for f in report.findings:
        print(f"[{f.severity:7s}] {f.check}/{f.contract}: {f.message}")
    _print_timings(report, wall_s)

    # The runtime budget is only meaningful for the full suite — partial
    # runs, and ``--all`` runs without the ranks for every contract,
    # neither record nor enforce the baseline.
    over_budget = None
    if args.all and set(report.contracts_executed) >= set(CONTRACTS):
        over_budget = check_runtime_budget(report, wall_s, device=args.device.split(":")[0])
        if over_budget:
            print(f"[error  ] runtime/budget: {over_budget}")

    summary = report.summary()
    print(
        f"lint: {len(report.findings)} finding(s) "
        f"({summary['error']} error, {summary['warning']} warning, "
        f"{summary['info']} info) over "
        f"{len(set(report.contracts_executed))} contract(s), "
        f"{len(set(report.checks_executed))} distinct check(s); "
        f"report -> {out}"
    )
    return 0 if (report.ok and over_budget is None) else 1


if __name__ == "__main__":
    raise SystemExit(main())
