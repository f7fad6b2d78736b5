"""Command line of the port's kernel calibration tier.

    python -m repro_torch.service profile [--kernels A,B] [--repeats N]
    python -m repro_torch.service calibrate -o calibration.json [--json]

Both run on the CUDA card unless ``--device cpu`` asks for the kernels'
plain versions on the CPU.  ``calibrate`` writes an artifact that
``CIM_TUNER_CALIBRATION`` pins (the reference's schema, so either package
reads it).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_profile(args) -> int:
    os.environ["CIM_TUNER_PROFILE"] = "1"
    from repro_torch import obs

    kernels = [k for k in (args.kernels or "").split(",") if k] or None
    try:
        records = obs.profile.run_microbench(kernels=kernels,
                                             repeats=args.repeats,
                                             device=args.device)
    except (ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    rows = obs.profile.summary(records)
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        print(f"{'kernel':<16} {'bucket':<18} {'calls':>6} "
              f"{'us/call':>12} {'flops':>12} {'bytes':>12} {'roofline':>9}")
        for r in rows:
            print(f"{r['kernel']:<16} {r['bucket']:<18} "
                  f"{r['calls']:>6} {r['us_per_call']:>12.1f} "
                  f"{r['flops']:>12.3g} {r['bytes']:>12.3g} "
                  f"{r['roofline_utilization']:>9.2e}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(obs.registry().render())
        print(f"# wrote metrics exposition to {args.metrics_out}",
              file=sys.stderr)
    return 0


def _cmd_calibrate(args) -> int:
    """Measure -> fit -> (optionally) pin: the calibration tier's CLI.

    Runs the kernel microbench sweep (or reads measurements from a prior
    artifact via ``--input``), fits correction factors with a held-out
    split, prints the fit report, and writes a calibration artifact that
    ``CIM_TUNER_CALIBRATION`` can pin."""
    from repro_torch.core import calibration as cal

    if args.input:
        try:
            _cf, payload = cal.load_calibration(args.input)
            records = payload.get("measurements") or []
            if not records:
                raise ValueError("artifact carries no measurements")
        except (OSError, ValueError) as exc:
            print(f"error: cannot reuse {args.input!r}: {exc}",
                  file=sys.stderr)
            return 2
    else:
        from repro_torch import obs
        kernels = [k for k in (args.kernels or "").split(",") if k] or None
        try:
            records = obs.run_microbench(kernels=kernels,
                                         repeats=args.repeats,
                                         seed=args.seed, device=args.device)
        except (ValueError, RuntimeError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
    try:
        report = cal.fit_report(records, holdout_fraction=args.holdout,
                                seed=args.seed)
        corrections = cal.fit_corrections(records)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    payload = None
    if args.output:
        payload = cal.save_calibration(args.output, corrections,
                                       records=records, report=report)
    if args.json:
        out = {"records": len(records), "report": report,
               "corrections": corrections.as_dict(),
               "version": cal.calibration_version(corrections)}
        if args.output:
            out["artifact"] = args.output
        print(json.dumps(out, indent=2))
        return 0
    print(f"measurements : {len(records)} records")
    print(f"corrections  : compute={corrections.compute:.4g} "
          f"memory={corrections.memory:.4g} "
          f"update={corrections.update:.4g}")
    print(f"version      : {cal.calibration_version(corrections)}")
    print(f"holdout RMS  : uncalibrated "
          f"{report['uncalibrated_rms_us']:.2f}us -> calibrated "
          f"{report['calibrated_rms_us']:.2f}us "
          f"(improvement {report['improvement']:.2f}x)")
    if payload is not None:
        print(f"artifact     : {args.output}  "
              f"(pin with {cal.CALIBRATION_ENV}={args.output})")
    return 0


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card's kernels) or cpu (the "
                        "kernels' plain versions)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="Kernel profiling and calibration of the PyTorch port")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser(
        "profile", help="run the kernel micro-profile pass "
                        "(cim_kernel_us / roofline utilization)")
    pr.add_argument("--kernels", default=None, metavar="A,B",
                    help="comma-separated kernel subset (default: all of "
                         "cim_matmul, flash_attention, selective_scan, "
                         "strategy_eval)")
    pr.add_argument("--repeats", type=int, default=3,
                    help="profiled calls per kernel (default 3)")
    pr.add_argument("--json", action="store_true",
                    help="machine-readable summary rows")
    pr.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="also dump the Prometheus exposition here")
    _add_device(pr)
    pr.set_defaults(fn=_cmd_profile)

    ca = sub.add_parser(
        "calibrate", help="fit measured-kernel correction factors and "
                          "write a calibration artifact")
    ca.add_argument("--kernels", default=None, metavar="A,B",
                    help="comma-separated kernel subset to microbench "
                         "(default: all)")
    ca.add_argument("--repeats", type=int, default=3,
                    help="timed calls per kernel/tiling case (default 3)")
    ca.add_argument("--seed", type=int, default=0,
                    help="seed for microbench inputs and the held-out "
                         "split (default 0)")
    ca.add_argument("--input", default=None, metavar="PATH",
                    help="refit from the measurements stored in an "
                         "existing artifact instead of re-running the "
                         "microbench")
    ca.add_argument("--holdout", type=float, default=0.25,
                    help="held-out fraction for the fit report "
                         "(default 0.25)")
    ca.add_argument("-o", "--output", default=None, metavar="PATH",
                    help="write the calibration artifact here (pin it "
                         "via CIM_TUNER_CALIBRATION)")
    ca.add_argument("--json", action="store_true",
                    help="machine-readable report")
    _add_device(ca)
    ca.set_defaults(fn=_cmd_calibrate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
